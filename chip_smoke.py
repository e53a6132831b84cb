#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each announced on its own line; any failure raises and the
script exits non-zero:

1. device   the card's name and power limit (nvidia-smi), torch/CUDA,
            triton and scipy
2. build    the CUDA C++ kernels (one nvcc per source) and the Triton
            kernel, all started together; each CUDA kernel's registers
            and spills (ptxas) and grouped_matmul's dynamic shared memory
3. kernels  the kernels these paths run
4. check    each kernel against its plain PyTorch version on the card,
            at its paths' shapes and on ragged ones (TF32 off), with
            device times (CUDA-graph replay) of the kernel, the plain
            version and one library call (where one exists), beside the
            bound (grouped_matmul also at the LM's no-grad unembedding,
            M = 4096 rows, at the dense decode's shapes: a decoupled
            FFN's gate/up (8, 256, 1024) and down (8, 1024, 256)
            products, timed at M = 4 and 128, and the llama
            unembedding, and its refusal under autograd);
            feature_stats also as feature_stats_many on segment
            tables (auto-depth's, ragged and misaligned ones, one over a
            launch's capacity, vgg16's 100 x 15), and Eq. 9's reduction
            timed as one batched launch, as 80 single-pair calls and as
            8 torch.linalg.vecdot calls; and presence-weighted fusion
            of leaves whose group axis does not lead (a (2, 4, 5) leaf
            at axis 1, a stacked (4, 8, 256, 256) leaf), one launch per
            (pre index, group) block; paired_fusion and local_step at
            every tier layout of the capacity-tier paths A and B (whose
            parameter counts must be the reference's) on (2, M_t) rows
            and (3, M_t) rows with a weight-0 pad row, and paired_fusion
            on a (2, 521,616) async event buffer under staleness-
            discounted weights
5. main     the CLI's main path at full width (VGG9, 10 clients, 8 steps
            of batch 32): fed2 on the default routes, fed2 with
            --use-local-kernel, fedavg on the baseline VGG9; then fed2
            on --arch vgg16 (100 classes) and on --arch mobilenet
            --dirichlet 0.5; 3 rounds each. Every launch counter is set
            to 0 just before each run and read just after: every run
            fuses once per round through paired_fusion, only the
            --use-local-kernel run launches local_step (once per local
            step), and none launches feature_stats
6. methods  fedavgm, fedadam, fednova, scaffold and fedma through the
            CLI's defaults (vgg9.baseline), 3 rounds each, with and
            without --use-local-kernel, counted: paired_fusion once a
            round (fedma: never, it fuses on the host), local_step once
            a local step with the flag (scaffold: never); s/round, and
            FedMA's matching time per round. fedadam runs the CLI's
            inputs at server_lr 1e-3 (at the CLI's 1.0 it overflows)
7. fednova parity  one fednova and one fedavg round from one init (TF32
            off, deterministic convolutions): equal within 1e-5
8. samplers the CLI's fed2 under --sampler uniform, weighted and
            round_robin at --cohort-size 5, and the full sampler over
            --nodes 20 at --cohort-size 10 (2 tiles, 2 launches a
            round); the ids of each round
9. auto_depth  Fed2's structure adaptation at full width
            (launch/auto_depth.py): warm-up of the baseline VGG9, Eq. 9
            through feature_stats (one feature_stats_many launch for
            all 10 classes x 8 tapped layers), TV profile -> decouple
            depth, 6 rounds of Fed2 (one paired_fusion each); it must
            learn. Then Eq. 9 on the warm model with the kernel on and
            off (TF32 off): preference vectors, TV profile and depth
            agree; and each route's wall time, median of 5; and Eq. 9
            on the warm model cast to bf16, kernel route (one launch)
            against plain
10. profile the main path again under torch.profiler: device busy
            share and device time by kernel category
11. parity  one fed2 round from one init and one batch stream with the
            kernels on and off (TF32 off, deterministic convolutions):
            the fusion kernel alone agrees to round-off, both kernels
            within what a one-ulp change of the init does to the round
12. scenario nxc2_fed2, nxc2_fedma, dir05_fed2, qskew_fed2 and
            iid_fedavg for their 10 rounds, counted like the main path;
            each must learn; the JAX package's committed final
            accuracies beside them, and whether every FedMA permutation
            was the identity
13. axes    the sync round's feature axes through the CLI at full
            width, 3 rounds each, counted: fed2 --compute-dtype bfloat16
            (with and without --use-local-kernel: local_step on the bf16
            shadow buffer), --codec int8 and topk(0.05), sign_flip(4) on
            20 % of the clients under trimmed_mean(0.25) (no
            paired_fusion: a reducing rule has no kernel) and under
            norm_clip(10), fedavg under label_flip and --alignment pan,
            and --fed-mode one_shot (one fusion); the robust reductions'
            time on the (10, M) cohort. local_step on bf16 (10, M) is
            timed in the check phase against its bound and
            torch._fused_sgd_
14. axes parity  one fed2 round (TF32 off, deterministic convolutions):
            the identity codec, trimmed_mean(0), norm_clip(inf) and
            --local-unroll 4 give the plain round to the bit; bf16 with
            and without --use-local-kernel within BF16_ROUTES_TOL
15. axes scenarios  the 12 feature-axis scenarios and nxc2_fedavg, 10
            rounds each (deterministic convolutions), counted, beside the
            JAX package's records: one row per one-shot run,
            nxc2_fedavg_none equal to nxc2_fedavg to the bit, label-flip
            best accuracy >= 0.2, finite params under trimmed_mean; the
            paper-claims orderings printed, not asserted
16. tiers   capacity tiers through the CLI at full width, 3 rounds each,
            with and without --use-local-kernel, counted: path A
            (fedavg, vgg9.baseline, --tiers 1.0x2,0.5x2,0.25x2) and B
            (fed2, --fed2-groups 5, --tiers 1.0x2,0.6x2,0.2x2):
            paired_fusion once per tier tile a round (3), local_step
            3 x 8 a round with the flag; s/round and the tier combine's
            CUDA-event time per round
17. tiers parity  at path A's width (TF32 off, deterministic convs):
            the tiered engine forced onto one width-1.0 tier within
            2e-6 of the homogeneous round; a round in which only the
            0.25 tier trains keeps every other coordinate of the global
            to the bit
18. async   path C through the CLI (fed2 and fedavg, 10 nodes, 4 in
            flight, --buffer-k 2, polynomial(0.5), pareto(1.5)), 6
            fusion events each, with and without --use-local-kernel,
            counted: paired_fusion once per event, local_step 8 per
            dispatch-group tile with the flag; s/event, local tiles,
            staleness lists
19. async parity  buffer_k = cohort, zero latency, constant discount
            (TF32 off, deterministic convs): the async run equals the
            sync run bit for bit, with and without --use-local-kernel
20. tier and async scenarios  the 5 tier and 2 async specs at their
            registered settings, counted, beside the JAX package's
            records; the async specs' sim_time equal to the records'
21. tier and async profile  paths A and C under torch.profiler
22. store   the client-state stores and checkpoints (TF32 off,
            deterministic convs), counted: (a) the CLI's main path with
            --store mmap --chunk-size 4, with and without
            --use-local-kernel (paired_fusion 3, local_step 0 or 24),
            each equal to its --store memory run to the bit; (b)
            scaffold on vgg9.baseline over 100 clients at a uniform
            cohort of 10, 8 rows a shard (13 shards, 1.40 GB on disk):
            4 rounds through each store (equal to the bit; s/round of
            both), then 2 rounds saving every round and a resume to 4
            (paired_fusion 2, local_step 0) equal to the straight run to
            the bit; shards flushed, bytes and wall time of each save;
            (c) the reference's bench_cohort rung, fedavg at a weighted
            cohort of 8 over 10^4 and 10^6 striped clients through the
            mmap store: s/round and RSS (paired_fusion once a round)
23. serve   Mamba-2 1.3B at full width through the serving CLI
            (launch/serve.py --arch mamba2-1.3b, the reference's other
            defaults: batch 4, 32 prompt + 16 decoded tokens): --full
            (ssd_update in every
            layer of every step: 48 x 48 launches) and --full
            --fed2-groups 8 (also grouped_matmul, once a step, on its
            stream route), then --batch 128 with Fed2 (decode_32k's
            batch: a 12.9 GB SSM state; grouped_matmul's wgmma route);
            counted, grouped_matmul by route too, with prefill/decode
            time, tok/s, peak device memory and the parameter count,
            which must equal the reference's
24. serve profile  a short Fed2 serve under torch.profiler: device
            busy share and device time by kernel category
25. decode parity  the full config in fp32 (TF32 off), 8 tokens, with
            the kernels and with the plain versions: logits and the
            final cache within the stated limits
26. lm train  Mamba-2 1.3B training at full width and depth through the
            CLI (--mode lm --fed2 --fed2-groups 8, batch 8 x 1024
            tokens, bf16, AdamW with fp32 state, 6 steps), with and
            without --microbatches 2, counted: no kernel launches (the
            training routes take the einsum unembedding); losses finite
            and falling, step time, tokens/s, peak device memory. Then
            make_eval_step and make_prefill_loss_step on the trained
            params: grouped_matmul once per loss chunk (2, wgmma), the
            eval loss against the einsum route's
27. lm federation  run_federated(lm_task) at full width, depth cut to 12
            layers, fp32, Fed2 over 4 vocab clusters: 4 clients (one
            token domain each), 4 local steps of batch 8 at seq 64, 2
            rounds, fedavg and fed2, with and without
            --use-local-kernel, counted: paired_fusion once a round,
            local_step once a local step with the flag, grouped_matmul
            once a round (the eval's unembedding, simt); s/round and
            next-token accuracy per round; every leaf moved, and the
            held-out loss (make_eval_step, same-language held-out set)
            below the init's, falling round by round for fed2. TF32
            off: one fed2 round in which every local_step and
            paired_fusion call is held, element by element, against
            its plain version on that call's own inputs within an fp32
            round-off bound; the same check must fail on two planted
            faults (local_step without momentum, one fusion weight 0.1
            % high). The whole round with the kernels against the plain
            routes, within what a one-ulp change of the init or a
            second plain run does, per leaf; the loss's sharpest
            direction (Hessian power iteration: its curvature and its
            leaves), and the one-ulp readings again with the embedding
            table at unit RMS
28. lm cross-check  the full config with Fed2 (groups 8) in fp32 (TF32
            off): the chunked forward over 300 tokens against 300
            decode steps through ssd_update: logits at every position
            and every layer's final SSM state within the stated limits
29. lm profile  one --mode lm step, with and without --microbatches
            2, and one fed2 LM round under torch.profiler
30. dense serve  Llama-3.2-1B at full width through the serving CLI's
            default arch (batch 4, 32 + 16 tokens): --full and --full
            --fed2-groups 8 (grouped_matmul 13 a step: the unembedding
            and the 4 decoupled FFNs' three products, stream route),
            then Fed2 at batch 128 over a 2048-slot KV cache (8.6 GB in
            bf16; wgmma route); counted, with tok/s, peak memory and
            the parameter counts, which must equal the reference's
31. dense decode parity  the full llama with Fed2 in fp32 (TF32 off):
            16 decode steps with the kernels against the plain versions
            (logits and KV caches), and the chunked forward (q chunks of
            128, kv chunks of 256) over 300 tokens against 300 decode
            steps, logits within the stated limit
32. dense lm train  the chunked attention at the training shape beside
            F.scaled_dot_product_attention (time, bound, agreement);
            --mode lm --arch llama3.2-1b --fed2 --fed2-groups 8 at full
            width and depth as in 26 (no launch in training; the eval
            and prefill steps 2 wgmma launches each)
33. dense lm federation  lm_task on the llama in fp32 under
            with_fed2(groups=4), cut to 6 of 16 layers (its 4 decoupled
            blocks kept), as in 27: fedavg and fed2 with and without
            --use-local-kernel, counted, every leaf moved and the
            held-out loss below the init's; then one fed2 round with
            every local_step and paired_fusion call held against its
            plain version (LmKernelTaps), and the held-out loss per
            round
34. dense lm profile  one llama --mode lm step (the attention's
            elementwise and softmax passes split out) and one fed2 dense
            LM round under torch.profiler

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``. Nothing here imports jax or ``repro``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32, outside the tensor cores
L2_BYTES = 50 * 2 ** 20
MAIN_ROUNDS = 3
FUSION_PARITY_TOL = 1e-5       # see phase_parity
# Eq. 9 with the feature_stats kernel vs without, on one warm model:
# tests/test_fed2_core.py's bound between the JAX package's two routes
PVEC_ATOL = PVEC_RTOL = 1e-3
# the JAX package's committed final accuracies
# (benchmarks/artifacts_perf/scenario_<name>.json): shown beside the
# port's, not matched (the inits differ)
SCENARIO_REFERENCE = {"nxc2_fed2": 0.5075, "nxc2_fedma": 0.4125,
                      "dir05_fed2": 0.96, "qskew_fed2": 0.9925,
                      "iid_fedavg": 0.9925}
# one fednova round vs one fedavg round from the same init (TF32 off,
# deterministic convs): under uniform tau the two are one function, and
# differ by fp32 round-off of the normalize/rescale (the reference pins
# 1e-5 between them, tests/test_methods.py)
FEDNOVA_PARITY_TOL = 1e-5
# fedadam's server step size on the card. Its Adam step moves every
# weight by about server_lr a round whatever the round delta, and the
# full VGG9 (no normalization) overflows at the CLI's default 1.0 (round
# 2) and at the reference's own test value 0.05 (tests/test_methods.py,
# round 1), and stalls at 0.01 (the port's CPU runs; ROADMAP Queue 3).
# 1e-3 learns, and is the value tests/test_torch_methods.py holds
# fedadam at against the reference.
FEDADAM_SERVER_LR = 1e-3
BF16_FLOPS = 989e12            # H100 SXM bf16, dense tensor cores
# one round of the CLI's fed2 at --compute-dtype bfloat16 with and
# without --use-local-kernel (TF32 off, deterministic convs): the two
# routes round the momentum step differently (the kernel keeps v' in
# fp32 before p' = p - lr*v', the plain route rounds v' to bf16), so a
# client's coordinate moves by bf16 ulps (2^-8 below 1.0) and the fp32
# fusion averages them. tests/test_torch_axes.py holds the port's bf16
# round to the JAX package's within the same 2^-7; the full-width CPU
# run of one round differs by 6.9e-4 between the two routes.
BF16_ROUTES_TOL = 2.0 ** -7
# the JAX package's committed final accuracies of the sync round's
# feature-axis scenarios and of nxc2_fedavg
# (benchmarks/artifacts_perf/scenario_<name>.json): shown beside the
# port's, not matched (the inits differ)
AXES_SCENARIO_REFERENCE = {
    "nxc2_fedavg_flip20": 0.325, "nxc2_fed2_flip20": 0.255,
    "nxc2_fedavg_signflip20": 0.085, "nxc2_fed2_signflip20": 0.085,
    "nxc2_fedavg_signflip20_trim": 0.405,
    "nxc2_fed2_signflip20_trim": 0.3375, "nxc2_fedavg_pan": 0.44,
    "nxc2_fedavg_none": 0.42, "dir05_fedavg_pan": 0.91,
    "dir05_fedavg_none": 0.775, "nxc2_fed2_oneshot": 0.305,
    "nxc2_fedavg_oneshot": 0.2225, "nxc2_fedavg": 0.4125}
# tests/test_paper_claims.py's margin for the robust orderings
CLAIMS_MARGIN = 0.10
# parameters of the full mamba2-1.3b and llama3.2-1b, and of
# with_fed2(groups=8) of each: the reference's
# param_count(jax.eval_shape(init_params, ...)) on its configs/<arch>.full()
SERVE_PARAMS = {("mamba2-1.3b", 0): 1_446_812_672,
                ("mamba2-1.3b", 8): 1_356_667_904,
                ("llama3.2-1b", 0): 1_498_482_688,
                ("llama3.2-1b", 8): 1_092_487_168}
SERVE_LAYERS = 48
# decode parity, kernels vs plain versions at full width in fp32: fp32
# round-off (~1e-7 relative per operation) carried through 48 layers
# and 8 tokens stays orders of magnitude below these; a wrong index or a
# lost term moves logits (O(1)) and the state by O(1)
PARITY_LOGIT_ATOL = 1e-3
PARITY_STATE_RTOL = 1e-4   # of the cache leaf's max |value|
# the capacity-tier paths at full width: A plain tiers on vgg9.baseline,
# B Fed2 tiers on vgg9.full(fed2_groups=5) (the CLI's default G = 8
# refuses every tier on 10 classes); per tier, the parameter count of
# the JAX package's cnn_tier_model (its CPU run)
TIER_PATHS = {
    "A": (("--method", "fedavg", "--nodes", "6", "--tiers",
           "1.0x2,0.5x2,0.25x2"), (3_491_530, 874_858, 219_706)),
    "B": (("--method", "fed2", "--fed2-groups", "5", "--nodes", "6",
           "--tiers", "1.0x2,0.6x2,0.2x2"), (796_645, 454_821, 143_885)),
}
# the forced one-tier engine vs the homogeneous round: the reference's
# tests/test_capacity.py bound (the combine's w*mean/w differs from the
# mean by round-off)
FORCED_TIER_TOL = 2e-6
# path C: buffered async at the CLI's 10 nodes, 4 in flight, a fusion
# every 2 arrivals (the async scenarios' settings)
ASYNC_PATH = ("--cohort-size", "4", "--sampler", "uniform", "--fed-mode",
              "async", "--buffer-k", "2", "--staleness", "polynomial(0.5)",
              "--latency", "pareto(1.5)")
ASYNC_EVENTS = 6
TIER_ASYNC_SCENARIOS = ("nxc2_fedavg_tiers", "nxc2_fed2_tiers",
                        "nxc2_fed2_tiers_cal", "dir05_fed2_tiers",
                        "dir05_fedavg_tiers", "nxc2_fedavg_async",
                        "nxc2_fed2_async")
# the store phase: (a) the CLI's main path through --store mmap at 4
# rows a shard; (b) scaffold on vgg9.baseline over 100 clients at cohort
# 10, 8 rows a shard (13 shards, 1.40 GB of control variates on disk),
# 4 rounds, resumed after 2; (c) the reference's bench_cohort rung
# (benchmarks/flbench.py): fedavg on vgg9.baseline, weighted cohort of
# 8, 4 steps of batch 16, striped parts, 4096 rows a shard, one warm and
# 4 timed rounds at each population
STORE_CLI_CHUNK = 4
STORE_RESUME = ("--method", "scaffold", "--nodes", "100", "--cohort-size",
                "10", "--sampler", "uniform", "--store", "mmap",
                "--chunk-size", "8")
STORE_RESUME_ROUNDS = 4
STORE_POPULATIONS = (10_000, 1_000_000)
STORE_RUNG = dict(cohort_size=8, sampler="weighted", local_epochs=1,
                  steps_per_epoch=4, batch_size=16, lr=0.008, momentum=0.9,
                  method="fedavg", seed=0, store="mmap", chunk_size=4096)
STORE_RUNG_ROUNDS = 4
# --mode lm at full width and depth: mamba2_1_3b.full() in bf16, Fed2
# over 8 vocab clusters, batch 8 of 1024 tokens (four SSD chunks of 256,
# two loss chunks of 512), with and without --microbatches 2. AdamW at
# lr 1e-3 (the CLI's 0.01 is the fl mode's SGD rate)
LM_TRAIN = ("--mode", "lm", "--arch", "mamba2-1.3b", "--fed2",
            "--fed2-groups", "8", "--batch", "8", "--seq", "1024", "--lr",
            "1e-3")
LM_TRAIN_STEPS = 6
# the eval step's loss through grouped_matmul vs through the einsum, one
# bf16 batch: both round the logits to bf16 (2^-8 relative) from fp32
# sums in other orders; the mean CE over 8,192 tokens averages that.
# Measured on an H100: equal to every printed digit (11.52316, |d| 0)
LM_EVAL_ROUTES_TOL = 1e-3
# LM federation at full width, depth cut from 48 to 12 layers (in fp32 a
# flat row of the full depth is 5.4 GB; four rows, the velocity and the
# vmapped grads would take about 65 GB before activations): 4 clients, one
# token domain each (examples/llm_federated_finetune.py's split), 4 local
# steps of batch 8 at seq 64, 2 rounds; the eval is 64 held-out
# sequences of 64 drawn with the training set (the example draws them
# from another seed, whose bigram tables differ: nothing learned shows
# there)
LM_FL_LAYERS = 12
LM_FL_SEQ = 64
# power iterations for the LM loss's sharpest direction (the Rayleigh
# quotient settles to 3 digits in about 10 at 4 layers of the full width)
LM_SHARPNESS_ITERS = 12
LM_FL = dict(population=4, rounds=2, local_epochs=1, steps_per_epoch=4,
             batch_size=8, lr=0.01, momentum=0.9, seed=0, eval_batch=64)
# the chunked forward (ssd_chunked) vs L decode steps through ssd_update,
# full width and depth in fp32 (TF32 off), L = 300 (a second, padded
# chunk of 256): two algorithms for one recurrence, with sums in other
# orders through 48 layers. An fp32 CPU run of 2 and 8 layers of the full
# width put logits 3.6e-4 and 8.5e-4 apart (max |logit| 5.5) and the
# states 7e-6 and 2.2e-5 of their largest value; a lost or misplaced
# term moves both by O(1)
CROSSCHECK_LEN = 300
CROSSCHECK_LOGIT_ATOL = 2e-2
CROSSCHECK_STATE_RTOL = 1e-3
# the dense family at llama3.2-1b: 16 layers, with_fed2(groups=8)
# decouples the last 4, so a Fed2 decode step launches grouped_matmul
# 1 + 3 x 4 times (the unembedding and each decoupled FFN's gate, up
# and down products); the batch-128 serve holds a 2048-slot bf16 KV
# cache (2 x 16 x 128 x 2048 x 8 x 64 x 2 bytes = 8.6 GB)
DENSE_LAYERS = 16
DENSE_GBLOCKS = 4
DENSE_GMM_PER_STEP = 1 + 3 * DENSE_GBLOCKS
DENSE_SERVE_BATCH128 = ("--max-len", "2048", "--batch", "128",
                        "--prompt-len", "2", "--gen", "8")
DENSE_KV_BYTES = 2 * DENSE_LAYERS * 128 * 2048 * 8 * 64 * 2
DENSE_LM_TRAIN = ("--mode", "lm", "--arch", "llama3.2-1b", "--fed2",
                  "--fed2-groups", "8", "--batch", "8", "--seq", "1024",
                  "--lr", "1e-3")
# the dense decode parity's 16 tokens, and the cross-check: the chunked
# forward at q chunks of 128 and kv chunks of 256 (300 tokens: three q
# chunks and two kv chunks, each padded) against 300 decode steps, full
# width and depth, fp32 (TF32 off). The limit was set before the first
# run on the card: both paths compute one function, rounding fp32 sums
# in other orders (the CPU parity tests hold them within 1e-5 of max
# |logit| at reduced width); a wrong rotation, mask or cache slot moves
# logits by O(1)
DENSE_PARITY_STEPS = 16
DENSE_CROSSCHECK = dict(attn_q_chunk=128, attn_kv_chunk=256)
DENSE_CROSSCHECK_LOGIT_ATOL = 5e-3
# LM federation of the dense family: llama3_2_1b.full(float32) with
# with_fed2(groups=4) (4 decoupled blocks, a (4, 512, 32064) unembedding)
# at depth 6 of 16: at full depth a flat fp32 row is 4.60 GB (1,150,486,528
# params), and the global, 4 rows, 4 velocities and 4 gradients come to
# ~60 GB before activations and the per-call kernel taps' copies of the
# rows; at 8 layers (2.66 GB a row) the taps' round would peak near 80 GB
DENSE_FL_LAYERS = 6
# the chunked attention at the training shape (batch 8 x 1024, 32 heads,
# 8 KV heads, head_dim 64, bf16, causal) against
# F.scaled_dot_product_attention on the same q, k, v: both keep fp32
# accumulators and round p and the output to bf16
ATTN_SDPA_ATOL = 2e-2


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] ...", flush=True)
    t0 = time.time()
    yield
    torch.cuda.synchronize()
    print(f"[{name}] ok ({time.time() - t0:.1f} s)", flush=True)


@contextlib.contextmanager
def tf32_off():
    """Full fp32 convolutions and matmuls (cuDNN runs fp32 convs in TF32
    by default) for the comparisons; the previous flags come back after."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN convolutions that give the same bits on every call (its
    default algorithms may accumulate the weight gradient with atomics,
    in any order); the previous flags come back after."""
    old = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fns, reps: int) -> float:
    """Mean device time of one call: ``reps`` calls cycling over ``fns``
    (closures on distinct buffers, so each call finds its inputs out of
    L2 as the round does) are captured in one CUDA graph, and CUDA
    events time its replay. The graph keeps the Python wrappers' host
    time out of the number: launched eagerly one by one, these
    microsecond kernels wait on the host, not on the card."""
    for f in fns:                    # compile, allocate, pick algorithms
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def copies_for(nbytes: int) -> int:
    """Buffers to cycle over so that their sum exceeds L2 three times."""
    return max(2, math.ceil(3 * L2_BYTES / nbytes))


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple:
    """The least time (ms) for ``nbytes`` of device memory traffic and
    ``flops`` operations at ``peak`` (the rate of their type), and which
    of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def layout_of(cfg):
    """The flat layout of one client's parameters of model ``cfg``."""
    from repro_torch.models.cnn import init_cnn
    from repro_torch.models.module import FlatLayout
    return FlatLayout(init_cnn(torch.Generator().manual_seed(0), cfg))


def main_layout():
    """The flat layout of the main path's model, vgg9.full(fed2_groups=8)."""
    from repro_torch.configs import vgg9
    return layout_of(vgg9.full(fed2_groups=8))


def cohort(layout, n, dtype, gen, scale=1.0):
    """An (n, M) cohort buffer as the engine allocates it (row stride
    rounded up), filled with seeded normals."""
    buf = layout.alloc((n,), device="cuda", dtype=dtype)
    buf.copy_(scale * torch.randn(buf.shape, generator=gen, device="cuda"))
    return buf


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


CUDA_SOURCES = ("paired_fusion", "feature_stats", "grouped_matmul",
                "ssd_update")


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels import local_step as ls
    t0 = time.time()
    times, errors = {}, []

    def nvcc(name):
        try:
            build.load(name)
            times[f"{name} (nvcc)"] = time.time() - t0
        except BaseException as e:          # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=nvcc, args=(n,))
               for n in CUDA_SOURCES]
    for th in threads:
        th.start()
    # the Triton kernel compiles at its first launch: take the main
    # path's specialization (strided fp32 (10, M) rows)
    layout = main_layout()
    p = layout.alloc((10,), device="cuda")
    ls.local_step(p, torch.zeros_like(p), torch.zeros_like(p), lr=0.01,
                  mu=0.9)
    torch.cuda.synchronize()
    times["local_step (triton)"] = time.time() - t0
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    for k, v in times.items():
        print(f"  built {k} in {v:.1f} s")
    for name in CUDA_SOURCES:
        log = build.library_path(name).with_suffix(".log")
        entry = "?"
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas ({name}, {demangled(entry)}):", line.strip())
    from repro_torch.kernels import grouped_matmul as gm
    for r, dt in (("stream", torch.bfloat16), ("stream", torch.float32),
                  ("wgmma", torch.bfloat16)):
        print(f"  grouped_matmul {r} route, {str(dt)[6:]}: "
              f"{gm.dynamic_smem(r, dt)} bytes of dynamic shared memory "
              f"per block")


def demangled(symbol: str) -> str:
    """A kernel's name and template arguments, as c++filt gives them (the
    symbol itself where c++filt is missing)."""
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    name = (out or symbol).replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0]


def check(name, got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    ok = err <= tol
    print(f"  {name}: max_abs_err {err:.3g} (tol {tol:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol})")
    return err


def phase_check_paired_fusion(layout) -> dict:
    from repro_torch.configs import vgg9
    from repro_torch.fl import scenarios
    from repro_torch.kernels.paired_fusion import (paired_fusion,
                                                   paired_fusion_ref)
    gen = torch.Generator(device="cuda").manual_seed(1)
    m = layout.size
    # the cohort buffers of the other two paths that fuse through it:
    # fedavg on vgg9.baseline() (10 clients) and nxc2_fed2 (6 clients)
    base = layout_of(vgg9.baseline())
    spec = scenarios.get("nxc2_fed2")
    scen = layout_of(spec.model_config())

    def weights(n):
        w = torch.rand(n, generator=gen, device="cuda") + 0.1
        return w / w.sum()

    # tolerances: fp32 1e-5 (tests/test_kernels.py's); bf16 1e-2, about
    # one bf16 ulp at the O(1) result, since the two fp32 sums may round
    # to neighbouring bf16 values
    cases = [("fp32 N=10 M=%d (main path)" % m,
              cohort(layout, 10, torch.float32, gen), 1e-5),
             ("bf16 N=10 M=%d" % m,
              cohort(layout, 10, torch.bfloat16, gen), 1e-2),
             ("fp32 N=1 M=%d" % m,
              cohort(layout, 1, torch.float32, gen), 1e-5),
             ("fp32 N=10 M=%d (fedavg path, vgg9.baseline)" % base.size,
              cohort(base, 10, torch.float32, gen), 1e-5),
             ("fp32 N=%d M=%d (nxc2_fed2 path)" % (spec.population,
                                                   scen.size),
              cohort(scen, spec.population, torch.float32, gen), 1e-5),
             ("fp32 N=10 odd M=100003, row stride 100003",
              torch.randn(10, 100003, generator=gen, device="cuda"), 1e-5),
             ("fp32 N=10 M=1001 at column 3 (unaligned group block)",
              cohort(layout, 10, torch.float32, gen)[:, 3:1004], 1e-5)]
    err_main = None
    for name, x, tol in cases:
        w = weights(x.shape[0])
        err = check(f"paired_fusion {name}", paired_fusion(x, w),
                    paired_fusion_ref(x, w), tol)
        err_main = err if err_main is None else err_main
    # timing at the main path's shape
    n, esz = 10, 4
    xs = [cohort(layout, n, torch.float32, gen)
          for _ in range(copies_for(n * m * esz))]
    w = weights(n)
    reps = 200
    ms = time_ms([lambda x=x: paired_fusion(x, w) for x in xs], reps)
    plain = time_ms([lambda x=x: paired_fusion_ref(x, w) for x in xs], reps)
    lib = time_ms([lambda x=x: torch.mv(x.t(), w) for x in xs], reps)
    b, by = bound(n * m * esz + m * esz + n * 4, 2 * n * m)
    return {"name": "paired_fusion", "route": "cuda",
            "source": "src/repro_torch/csrc/paired_fusion.cu",
            "replaces": "src/repro/kernels/paired_fusion.py:43",
            "max_abs_err": err_main, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib}


def phase_check_group_axis():
    """Presence-weighted fusion of leaves whose group axis does not lead
    (pre > 1): the kernel route launches paired_fusion once per (pre
    index, group) block and once per shared leaf; held against the plain
    version within 1e-5 (the kernel check's). A (2, 4, 5) leaf with
    GroupAxis(1, 2), and a stacked (L, G, i, o) leaf of lm_group_axes'
    shape at L = 4, G = 8, i = o = 256."""
    from repro_torch.core import fusion
    from repro_torch.kernels.paired_fusion import paired_fusion
    from repro_torch.models.module import FlatLayout
    gen = torch.Generator(device="cuda").manual_seed(6)
    n = 10
    for shape, axis, g in (((2, 4, 5), 1, 2), ((4, 8, 256, 256), 1, 8)):
        tree = {"g": torch.zeros(shape), "s": torch.zeros(4099)}
        layout = FlatLayout(tree)
        x = cohort(layout, n, torch.float32, gen)
        axes = {"g": fusion.GroupAxis(axis, g), "s": None}
        gw = torch.rand(n, g, generator=gen, device="cuda")
        gw[:, 0] = 0.0                       # a column no client holds
        w = torch.rand(n, generator=gen, device="cuda") + 0.1
        before = paired_fusion.launches
        got = fusion.paired_average(x, layout, axes, weights=w,
                                    group_weights=gw, use_kernel=True)
        launches = paired_fusion.launches - before
        want = fusion.paired_average(x, layout, axes, weights=w,
                                     group_weights=gw, use_kernel=False)
        pre = math.prod(shape[:axis])
        check(f"paired_fusion, group axis {axis} of {shape} ({pre} x {g} "
              f"blocks + 1 shared leaf, {launches} launches)", got, want,
              1e-5)
        assert launches == pre * g + 1, launches


def phase_check_local_step(layout) -> dict:
    from repro_torch.kernels.local_step import local_step, local_step_ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    lr, mu = 0.01, 0.9
    m = layout.size
    # tolerances: fp32 1e-6 and bf16 2e-2, tests/test_kernels.py's
    cases = [("fp32 (10, %d) cohort rows (main path)" % m, torch.float32,
              lambda: cohort(layout, 10, torch.float32, gen), 1e-6),
             ("bf16 (10, %d) cohort rows" % m, torch.bfloat16,
              lambda: cohort(layout, 10, torch.bfloat16, gen), 2e-2),
             ("fp32 odd M=100003", torch.float32,
              lambda: torch.randn(100003, generator=gen, device="cuda"),
              1e-6),
             ("bf16 ragged (3, 100003)", torch.bfloat16,
              lambda: torch.randn(3, 100003, generator=gen, device="cuda")
              .to(torch.bfloat16), 2e-2)]
    err_main = None
    for name, dt, make, tol in cases:
        p, v, g = make(), 0.1 * make(), make()
        wp, wv = local_step_ref(p, v, g, lr, mu)
        local_step(p, v, g, lr=lr, mu=mu)           # in place
        err = max(check(f"local_step {name} p", p, wp, tol),
                  check(f"local_step {name} v", v, wv, tol))
        err_main = err if err_main is None else err_main
    r, esz = 10, 4
    sets = [tuple(cohort(layout, r, torch.float32, gen, s)
                  for s in (1.0, 0.1, 1.0))
            for _ in range(copies_for(3 * r * m * esz))]
    reps = 100
    ms = time_ms([lambda s=s: local_step(*s, lr=lr, mu=mu) for s in sets],
                 reps)
    plain = time_ms([lambda s=s: local_step_ref(*s, lr, mu) for s in sets],
                    reps)
    # library yardstick: the fused SGD op behind torch.optim.SGD(
    # fused=True), on contiguous copies (it takes dense tensors only)
    dense = [tuple(t.contiguous() for t in s) for s in sets]
    lib = time_ms([lambda s=s: torch._fused_sgd_(
        [s[0]], [s[2]], [s[1]], weight_decay=0.0, momentum=mu, lr=lr,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False)
        for s in dense], reps)
    b, by = bound(5 * r * m * esz, 4 * r * m)
    return {"name": "local_step", "route": "triton",
            "source": "src/repro_torch/kernels/local_step.py",
            "replaces": "src/repro/kernels/local_step.py:47",
            "max_abs_err": err_main, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "bf16": local_step_bf16_times(layout, lr, mu, gen)}


def local_step_bf16_times(layout, lr, mu, gen) -> dict:
    """local_step on the bf16 (10, M) shadow of the cohort buffer (the
    --compute-dtype bfloat16 path), against its plain version and
    torch._fused_sgd_ on the same bf16 buffers: device times by graph
    replay and the bound (10 bytes an element: p, v, g read, p, v
    written, 2 bytes each)."""
    from repro_torch.kernels.local_step import local_step, local_step_ref
    r, m, esz = 10, layout.size, 2
    sets = [tuple(cohort(layout, r, torch.bfloat16, gen, s)
                  for s in (1.0, 0.1, 1.0))
            for _ in range(copies_for(3 * r * m * esz))]
    reps = 100
    ms = time_ms([lambda s=s: local_step(*s, lr=lr, mu=mu) for s in sets],
                 reps)
    plain = time_ms([lambda s=s: local_step_ref(*s, lr, mu) for s in sets],
                    reps)
    dense = [tuple(t.contiguous() for t in s) for s in sets]
    lib = time_ms([lambda s=s: torch._fused_sgd_(
        [s[0]], [s[2]], [s[1]], weight_decay=0.0, momentum=mu, lr=lr,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False)
        for s in dense], reps)
    b, by = bound(5 * r * m * esz, 4 * r * m)
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b,
            "bound_by": by}


def tapped_widths(cfg):
    """The neuron counts of the layers Eq. 9 taps on model ``cfg`` (every
    conv and hidden FC)."""
    from repro_torch.models.cnn import layer_meta
    return [m.c_out for m in layer_meta(cfg) if m.kind in ("c", "dw", "fc")]


def auto_depth_widths():
    """The tapped widths of the auto-depth path's warm-up model."""
    from repro_torch.launch import auto_depth
    return tapped_widths(auto_depth.model_configs(reduced=False)[0])


def fs_within(got, want, a, g, dt) -> tuple:
    """feature_stats' agreement rule: fp32 within 1e-5 of the column's
    sum of |a*g| (fp32 sums of B terms taken in another order), bf16 at
    the JAX test's bounds (tests/test_kernels.py). ``a``, ``g`` reduce
    over dim -2 into ``got``'s columns. Returns (max error, ok, rule)."""
    err = (got - want).abs()
    if dt == torch.float32:
        scale = (a.float() * g.float()).abs().sum(-2)
        return (err.max().item(), bool((err <= 1e-5 * scale).all()),
                "1e-5 x sum|a*g| per column")
    return (err.max().item(), bool((err <= 0.2 + 1e-2 * want.abs()).all()),
            "atol 0.2 + rtol 1e-2")


def fs_table(shapes, dt, gen, misalign=False):
    """One feature_stats_many table on the card: (a, g, outs) lists for
    (S, B, I) segments; ``misalign`` starts every a and g one element
    past a 16-byte boundary. The outs alternate between contiguous (I, S)
    tensors, as Eq. 9's (I_l, C) preference tensors are, and (I, S) views
    of (S, I) rows."""
    a_list, g_list, outs = [], [], []
    for k, (s, b, i) in enumerate(shapes):
        for lst in (a_list, g_list):
            n = s * b * i
            flat = torch.randn(n + 1, generator=gen, device="cuda").to(dt)
            lst.append(flat[1:] if misalign else flat[:n])
            lst[-1] = lst[-1].view(s, b, i)
        outs.append(torch.empty((i, s), device="cuda") if k % 2 == 0
                    else torch.empty((s, i), device="cuda").t())
    return a_list, g_list, outs


def fs_table_bytes(shapes, esize=4) -> tuple:
    """(bytes, flops) of a table: each input read once, each output
    written once."""
    nbytes = sum(2 * s * b * i * esize + 4 * s * i for s, b, i in shapes)
    return nbytes, sum(2 * s * b * i for s, b, i in shapes)


def phase_check_feature_stats() -> dict:
    from repro_torch.configs import vgg16
    from repro_torch.kernels.feature_stats import (
        feature_stats, feature_stats_many, feature_stats_many_ref,
        feature_stats_ref, feature_stats_table_capacity)
    from repro_torch.launch import auto_depth
    gen = torch.Generator(device="cuda").manual_seed(3)

    def pair(b, i, dt):
        return tuple(torch.randn(b, i, generator=gen, device="cuda").to(dt)
                     for _ in range(2))

    def check_fs(name, b, i, dt):
        a, g = pair(b, i, dt)
        got, want = feature_stats(a, g), feature_stats_ref(a, g)
        e, ok, lim = fs_within(got, want, a, g, dt)
        print(f"  feature_stats {name} ({b}, {i}) {str(dt)[6:]}: "
              f"max_abs_err {e:.3g} ({lim}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"feature_stats {name} ({b}, {i}) {dt}: "
                                 "kernel disagrees with its plain version")
        return e

    cap = feature_stats_table_capacity()

    def check_many(name, shapes, dt, misalign=False):
        a_l, g_l, outs = fs_table(shapes, dt, gen, misalign)
        before = feature_stats.launches
        got = feature_stats_many(a_l, g_l, outs)
        launches = feature_stats.launches - before
        want = feature_stats_many_ref(a_l, g_l)
        errs = [fs_within(p.t(), w.t(), a, g, dt)
                for p, w, a, g in zip(got, want, a_l, g_l)]
        e, ok = max(x[0] for x in errs), all(x[1] for x in errs)
        expect = -(-len(shapes) // cap)
        print(f"  feature_stats_many {name}: {len(shapes)} segments, "
              f"{sum(s for s, _, _ in shapes)} instances, "
              f"{str(dt)[6:]}{', misaligned' if misalign else ''}: "
              f"max_abs_err {e:.3g} ({errs[0][2]}), {launches} launches "
              f"(expected {expect}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"feature_stats_many {name} {dt}: kernel "
                                 "disagrees with its plain version")
        assert launches == expect, f"feature_stats_many {name}: launches"
        return e

    for b, i in ((32, 100), (256, 512), (100, 1000), (7, 3)):
        for dt in (torch.float32, torch.bfloat16):
            check_fs("JAX test shape", b, i, dt)
    path_b = auto_depth.PROBE_IMAGES
    n_cls = 10
    for i in sorted(set(auto_depth_widths())):
        check_fs("auto-depth pair", path_b, i, torch.float32)
    check_fs("large", 8192, 4096, torch.float32)
    check_fs("large", 8192, 4096, torch.bfloat16)
    check_fs("large, rows not a multiple of the split", 8191, 4095,
             torch.float32)

    # the batched call: Eq. 9's table on the auto-depth path (one segment
    # of n_cls instances per tapped layer), ragged and misaligned tables,
    # more segments than one launch takes, and vgg16's 100 x 15 table
    table = [(n_cls, path_b, i) for i in auto_depth_widths()]
    err_path = check_many("auto-depth table", table, torch.float32)
    check_many("auto-depth table", table, torch.bfloat16)
    ragged = [(3, 7, 3), (1, 100, 1000), (5, 64, 70), (2, 1, 33),
              (4, 33, 130), (1, 1, 1), (2, 300, 129), (6, 64, 520)]
    for dt in (torch.float32, torch.bfloat16):
        check_many("ragged", ragged, dt)
        check_many("ragged", ragged, dt, misalign=True)
    check_many("over capacity", [(2, 16 + k, 8 + 4 * k)
                                 for k in range(cap + 8)], torch.float32)
    check_many("vgg16 table", [(100, path_b, i) for i in
                               tapped_widths(vgg16.baseline())],
               torch.float32)

    # Eq. 9's reduction on the auto-depth path, four ways: one batched
    # launch, the single-pair kernel once per (class, layer), the nearest
    # library route (one vecdot per layer) and the plain version
    nbytes, flops = fs_table_bytes(table)
    tables = [fs_table(table, torch.float32, gen)
              for _ in range(copies_for(nbytes))]
    reps = max(20, len(tables))
    t = {"ms": time_ms([lambda t=t: feature_stats_many(*t)
                        for t in tables], max(200, reps)),
         "old_ms": time_ms([lambda t=t: [feature_stats(a[c], g[c])
                                         for a, g in zip(t[0], t[1])
                                         for c in range(n_cls)]
                            for t in tables], reps),
         "library_ms": time_ms([lambda t=t: [torch.linalg.vecdot(a, g, dim=1)
                                             for a, g in zip(t[0], t[1])]
                                for t in tables], reps),
         "plain_ms": time_ms([lambda t=t: feature_stats_many_ref(t[0], t[1])
                              for t in tables], reps)}
    t["bound_ms"], t["bound_by"] = bound(nbytes, flops)
    # the floor under any launch: a table of one (1, 1, 1) segment
    tiny = [fs_table([(1, 1, 1)], torch.float32, gen) for _ in range(4)]
    floor_ms = time_ms([lambda t=t: feature_stats_many(*t) for t in tiny],
                       200)
    print(f"  Eq. 9 reduction, auto-depth table ({len(table)} segments of "
          f"{n_cls} x ({path_b}, I), {nbytes / 1e6:.3f} MB) fp32: one "
          f"feature_stats_many launch {t['ms'] * 1e3:.2f} us; "
          f"{n_cls * len(table)} feature_stats calls "
          f"{t['old_ms'] * 1e3:.2f} us; {len(table)} torch.linalg.vecdot "
          f"calls {t['library_ms'] * 1e3:.2f} us; plain "
          f"{t['plain_ms'] * 1e3:.2f} us; bound {t['bound_ms'] * 1e3:.3f} "
          f"us ({t['bound_by']}); {t['bound_ms'] / t['ms'] * 100:.1f} % of "
          f"the bound; one launch of a (1, 1, 1) table "
          f"{floor_ms * 1e3:.2f} us")

    for b, i in ((path_b, max(auto_depth_widths())), (8192, 4096)):
        nb = 2 * b * i * 4
        pairs = [pair(b, i, torch.float32) for _ in range(copies_for(nb))]
        r = max(20 if b * i > 1e6 else 200, len(pairs))
        tp = {"ms": time_ms([lambda p=p: feature_stats(*p) for p in pairs],
                            r),
              "plain_ms": time_ms([lambda p=p: feature_stats_ref(*p)
                                   for p in pairs], r),
              "library_ms": time_ms([lambda p=p: torch.linalg.vecdot(
                  p[0], p[1], dim=0) for p in pairs], r)}
        tp["bound_ms"], tp["bound_by"] = bound(nb + 4 * i, 2 * b * i)
        print(f"  feature_stats ({b}, {i}) fp32: {tp['ms'] * 1e3:.2f} us, "
              f"plain {tp['plain_ms'] * 1e3:.2f} us, torch.linalg.vecdot "
              f"{tp['library_ms'] * 1e3:.2f} us, bound "
              f"{tp['bound_ms'] * 1e3:.2f} us ({tp['bound_by']})")
    return {"name": "feature_stats", "route": "cuda",
            "source": "src/repro_torch/csrc/feature_stats.cu",
            "replaces": "src/repro/kernels/feature_stats.py:43",
            "max_abs_err": err_path, **t}


def ssd_inputs(b, h, p, n, dt_x, gen, state=None):
    """Inputs of one ssd_update call as the decode makes them: x, b and c
    views into one (B, H*P + 2N) row of dtype ``dt_x``, dt > 0 after a
    softplus, a_log as the model inits it."""
    row = torch.randn(b, h * p + 2 * n, generator=gen, device="cuda")
    row = row.to(dt_x)
    x = row[:, :h * p].reshape(b, h, p)
    bm, cm = row[:, h * p:h * p + n], row[:, h * p + n:]
    if state is None:
        state = torch.randn(b, h, p, n, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn(b, h, generator=gen, device="cuda"))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    d = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    return state, x, dt, a_log, bm, cm, d


def phase_check_ssd_update() -> dict:
    """ssd_update against ssd_update_ref at the serve path's shapes
    (batch 4 and decode_32k's 128, H = P = 64, N = 128; x in bf16 as at
    full width, and fp32) and on ragged shapes; in place (out = h) as
    the decode calls it, and into a fresh buffer.

    Limits: h' within 1e-5 (fp32; both compute decay*h + dt*x*b with
    one rounding more or less); y within 1e-5 of sum_n |h'_n c_n| +
    |d x| per output (fp32 sums of N terms in another order), plus one
    bf16 step of |y| when y is bf16."""
    from repro_torch.kernels.ssd_update import ssd_update, ssd_update_ref
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32

    def check_one(name, b, h, p, n, dt_x, in_place=True, misalign=False):
        args = ssd_inputs(b, h, p, n, dt_x, gen)
        if misalign:     # a state that is not 16-byte aligned: scalar path
            buf = torch.empty(args[0].numel() + 1, device="cuda")
            st = buf[1:].view(args[0].shape)
            st.copy_(args[0])
            args = (st,) + args[1:]
        want_h, want_y = ssd_update_ref(*args)
        scale = torch.einsum("bhpn,bn->bhp", want_h.abs(),
                             args[5].float().abs()) + \
            (args[6][None, :, None] * args[1].float()).abs()
        # in place on a copy (the unaligned state is its own copy)
        state = args[0].clone() if in_place and not misalign else args[0]
        got_h, got_y = ssd_update(state, *args[1:],
                                  out=state if in_place else None)
        assert (got_h is state) == in_place
        eh = (got_h - want_h).abs().max().item()
        dy = (got_y.float() - want_y.float()).abs()
        lim = 1e-5 * scale
        if dt_x == bf16:
            lim = lim + 2.0 ** -7 * want_y.float().abs()
        ey = dy.max().item()
        ok = eh <= 1e-5 and bool((dy <= lim).all())
        print(f"  ssd_update {name} ({b}, {h}, {p}, {n}) x "
              f"{str(dt_x)[6:]}{' in place' if in_place else ''}: "
              f"max_abs_err h' {eh:.3g} (tol 1e-5), y {ey:.3g} (tol "
              f"{'1e-5 x sum|h c| + |d x|' + (' + 2^-7|y|' if dt_x == bf16 else '')}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"ssd_update {name}: kernel disagrees with "
                                 "its plain version")
        return max(eh, ey)

    err_path = max(check_one("serve path", 4, 64, 64, 128, bf16),
                   check_one("serve path", 4, 64, 64, 128, f32))
    check_one("decode_32k batch", 128, 64, 64, 128, bf16)
    check_one("decode_32k batch", 128, 64, 64, 128, f32, in_place=False)
    for shape in ((3, 5, 7, 9), (2, 6, 33, 130), (2, 3, 40, 36),
                  (1, 1, 1, 1), (2, 9, 100, 260)):
        check_one("ragged", *shape, f32)
        check_one("ragged", *shape, bf16, in_place=False)
    check_one("unaligned state", 2, 4, 16, 128, f32, misalign=True)

    timings = {}
    for b in (4, 128):
        h, p, n = 64, 64, 128
        # the state read and written (fp32); x, b, c read and y written
        # (bf16); dt, a_log, d_skip read (fp32)
        nbytes = 8 * b * h * p * n + 2 * (2 * b * h * p + 2 * b * n) \
            + 4 * (b * h + 2 * h)
        sets = [ssd_inputs(b, h, p, n, bf16, gen)
                for _ in range(copies_for(nbytes))]
        reps = max(200 if b == 4 else 40, len(sets))
        t = {"ms": time_ms([lambda a=a: ssd_update(*a, out=a[0])
                            for a in sets], reps),
             "plain_ms": time_ms([lambda a=a: ssd_update_ref(*a)
                                  for a in sets], reps),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = bound(nbytes, 6 * b * h * p * n)
        timings[b] = t
        print(f"  ssd_update ({b}, {h}, {p}, {n}) x bf16: "
              f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
              f"library none, bound {t['bound_ms'] * 1e3:.2f} us "
              f"({t['bound_by']})", flush=True)
        del sets
    return {"name": "ssd_update", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_update.cu",
            "replaces": "src/repro/kernels/ssd_update.py:50",
            "max_abs_err": err_path, **timings[4]}


def gmm_inputs(lead, g, k, n, dt, gen, bias=False):
    """x (lead, G*K) ~ N(0, 1) and w (G, K, N) at the model's fan-in
    scale 1/sqrt(K), so y is O(1) as in the unembedding."""
    x = torch.randn(tuple(lead) + (g * k,), generator=gen, device="cuda")
    w = torch.randn(g, k, n, generator=gen, device="cuda") / math.sqrt(k)
    b = torch.randn(g, n, generator=gen, device="cuda") if bias else None
    return x.to(dt), w.to(dt), None if b is None else b.to(dt)


def phase_check_grouped_matmul() -> dict:
    """grouped_matmul against grouped_matmul_ref at the Fed2 unembedding's
    shapes (x (M, 8*256), w (8, 256, 6288), M = 4 and 128, bf16 as at
    full width, and fp32), at each route's edges (M = 1, 8 | 9 ... 256)
    and on ragged ones (M, K and N off the tiles and stages, K longer
    than the ring, K or N off 16 bytes, an unaligned w, G = 1, a leading
    batch dimension, a bias); each case must launch through the route it
    names. Limits: 1e-4 sqrt(K) fp32 and 0.3 bf16, the reference's
    (tests/test_kernels.py). The stream and wgmma routes must repeat to
    the bit. Times at M = 4 (stream) and 128 (wgmma)."""
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_ref)
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    g0, k0, n0 = 8, 256, 6288

    def check_one(name, route, lead, g, k, n, dt, bias=False,
                  misalign=False):
        """One case, which must launch through ``route``."""
        x, w, b = gmm_inputs(lead, g, k, n, dt, gen, bias)
        if misalign:
            buf = torch.empty(w.numel() + 1, dtype=dt, device="cuda")
            w2 = buf[1:].view(w.shape)
            w2.copy_(w)
            w = w2
        tol = 1e-4 * math.sqrt(k) if dt == f32 else 0.3
        before = dict(grouped_matmul.route_launches)
        got = grouped_matmul(x, w, b)
        ran = [r for r, c in grouped_matmul.route_launches.items()
               if c != before[r]]
        assert ran == [route], f"grouped_matmul {name}: ran {ran}, " \
            f"expected the {route} route"
        return check(f"grouped_matmul {name} [{route}] x {tuple(x.shape)} "
                     f"w {tuple(w.shape)}{' + bias' if bias else ''} "
                     f"{str(dt)[6:]}", got, grouped_matmul_ref(x, w, b), tol)

    err_path = max(check_one("serve path", "stream", (4,), g0, k0, n0, bf16),
                   check_one("serve path", "stream", (4,), g0, k0, n0, f32))
    check_one("decode_32k batch", "wgmma", (128,), g0, k0, n0, bf16)
    check_one("decode_32k batch", "simt", (128,), g0, k0, n0, f32)
    # each route's edges at the serve shape: M = 1 and 8 (stream), 9 to
    # 256 (wgmma: one ragged row tile, two, three)
    for m in (1, 8, 9, 64, 65, 129, 256):
        check_one("route edge", "stream" if m <= 8 else "wgmma", (m,), g0,
                  k0, n0, bf16)
    check_one("route edge", "stream", (8,), g0, k0, n0, f32)
    # the stream route: M <= 8, K and N multiples of 16 bytes, aligned;
    # K off a stage (64 bf16 / 32 fp32 rows: zero-filled past the group),
    # longer than the ring (4 stages), and N off the 96-column unit
    check_one("ragged", "stream", (3,), 3, 100, 68, f32, bias=True)
    check_one("K off a stage", "stream", (4,), 2, 104, 264, bf16)
    check_one("K past the ring", "stream", (4,), 2, 600, 264, bf16)
    check_one("long K", "stream", (6,), 2, 600, 132, f32)
    check_one("G = 1", "stream", (4,), 1, k0, n0, bf16)
    check_one("leading batch dim", "stream", (2, 3), 4, 64, 136, f32,
              bias=True)
    check_one("leading batch dim", "stream", (2, 1), g0, k0, n0, bf16,
              bias=True)
    # the wgmma route: M > 8 bf16, K and N multiples of 16 bytes; K past
    # the group zero-filled (104 = 64 + 40), K past the ring (600), N off
    # the 192-column tile
    check_one("ragged", "wgmma", (9,), 2, 64, 256, bf16)
    check_one("K off a stage", "wgmma", (64,), 3, 104, 200, bf16)
    check_one("K past the ring", "wgmma", (64,), 2, 600, 264, bf16)
    check_one("G = 1", "wgmma", (128,), 1, k0, n0, bf16)
    check_one("leading batch dim", "wgmma", (2, 64), g0, k0, n0, bf16,
              bias=True)
    # the simt route: what TMA does not take, and fp32 at M > 8
    check_one("ragged", "simt", (8,), 2, 33, 260, bf16)
    check_one("long K", "simt", (4,), 2, 600, 132, bf16)
    check_one("ragged", "simt", (5,), 3, 100, 70, f32, bias=True)
    check_one("ragged", "simt", (17,), 5, 13, 130, bf16, bias=True)
    check_one("ragged", "simt", (130,), 13, 13, 13, f32)
    check_one("ragged", "simt", (200,), 5, 100, 70, bf16)
    check_one("K off 16 bytes", "simt", (4,), 2, 100, 264, bf16)
    check_one("K off 16 bytes", "simt", (64,), 2, 100, 264, bf16)
    check_one("N off the vector width", "simt", (4,), 2, 64, 6289, bf16)
    check_one("unaligned w", "simt", (4,), 2, 64, 512, f32, misalign=True)
    check_one("unaligned w", "simt", (4,), 2, 64, 512, bf16, misalign=True)
    # the stream and wgmma routes repeat to the bit
    for m in (4, 128):
        x, w, _ = gmm_inputs((m,), g0, k0, n0, bf16, gen)
        assert torch.equal(grouped_matmul(x, w), grouped_matmul(x, w)), \
            f"grouped_matmul M={m}: two calls on the same inputs differ"

    # the LM's no-grad unembedding (M = B * min(S, loss_chunk) rows):
    # make_eval_step / make_prefill_loss_step at --batch 8 --seq 1024
    # (two chunks of 512: M = 4096, bf16, G = 8) and lm_task's eval (64
    # sequences of 64 tokens: M = 4096, fp32, G = 4, K = 512, N = 12576)
    check_one("lm eval chunk", "wgmma", (8, 512), g0, k0, n0, bf16)
    check_one("lm_task eval", "simt", (64, 64), 4, 512, 12576, f32)
    # the dense family's decode (llama3.2-1b, 8 groups): the decoupled
    # FFN's gate/up (8, 256, 1024) and down (8, 1024, 256) products and
    # the unembedding (8, 256, 16032), on x (B, 1, G*K); bf16 serve at
    # batch 4 (stream) and 128 (wgmma), fp32 at batch 4 (the decode
    # parity); and the dense lm_task eval, (4, 512, 32064) fp32
    for k, n in ((256, 1024), (1024, 256), (256, 16032)):
        check_one("dense decode", "stream", (4, 1), g0, k, n, bf16)
        check_one("dense decode", "wgmma", (128, 1), g0, k, n, bf16)
        check_one("dense decode", "stream", (4, 1), g0, k, n, f32)
    check_one("dense lm_task eval", "simt", (64, 64), 4, 512, 32064, f32)
    # autograd: the kernel has no backward, so the wrapper refuses
    x, w, _ = gmm_inputs((4,), g0, k0, n0, bf16, gen)
    before = grouped_matmul.launches
    try:
        grouped_matmul(x.requires_grad_(), w)
    except RuntimeError as e:
        assert "no backward" in str(e), e
        print("  grouped_matmul under autograd: raises (no backward) ok")
    else:
        raise AssertionError("grouped_matmul returned a detached result "
                             "under autograd")
    assert grouped_matmul.launches == before

    timings = {}
    for label, m, g, k, n, dt in (
            ("serve M=4", 4, g0, k0, n0, bf16),
            ("serve M=128", 128, g0, k0, n0, bf16),
            ("lm eval chunk M=4096", 4096, g0, k0, n0, bf16),
            ("lm_task eval M=4096", 4096, 4, 512, 12576, f32),
            ("gffn gate/up M=4", 4, g0, 256, 1024, bf16),
            ("gffn down M=4", 4, g0, 1024, 256, bf16),
            ("gffn gate/up M=128", 128, g0, 256, 1024, bf16),
            ("gffn down M=128", 128, g0, 1024, 256, bf16)):
        esz = dt.itemsize
        w_bytes = g * k * n * esz
        nbytes = w_bytes + esz * m * g * (k + n)
        sets = [gmm_inputs((m,), g, k, n, dt, gen)[:2]
                for _ in range(copies_for(w_bytes))]
        # each replayed call writes its own (M, G*N) output: at M = 4096
        # that is 0.4-0.8 GB, so fewer calls a graph
        reps = max(200 if m <= 128 else 10, len(sets))
        t = {"ms": time_ms([lambda a=a: grouped_matmul(*a) for a in sets],
                           reps),
             "plain_ms": time_ms([lambda a=a: grouped_matmul_ref(*a)
                                  for a in sets], reps),
             "library_ms": time_ms([lambda a=a, m=m, g=g, k=k: torch.bmm(
                 a[0].view(m, g, k).transpose(0, 1), a[1])
                 for a in sets], reps)}
        t["bound_ms"], t["bound_by"] = bound(
            nbytes, 2 * m * g * k * n, BF16_FLOPS if dt == bf16 else
            FP32_FLOPS)
        timings[label] = t
        print(f"  grouped_matmul {label} ({g}, {k}, {n}) {str(dt)[6:]} "
              f"[{gm.route(m, g, k, n, dt, 0, 0)}]: "
              f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
              f"torch.bmm {t['library_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})", flush=True)
        del sets
        free_device_memory()
    return {"name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:48",
            "max_abs_err": err_path, **timings["serve M=4"]}


def finite_params(h):
    from repro_torch.models.module import tree_leaves
    leaves = tree_leaves(h["final_params"])
    assert leaves and all(bool(torch.isfinite(t).all()) for t in leaves), \
        "non-finite final parameters"
    assert all(t.is_cuda for t in leaves), "final parameters left the card"


def cli(*extra):
    from repro_torch.launch import train
    argv = ["--mode", "fl", "--rounds", str(MAIN_ROUNDS), *extra]
    print("  python -m repro_torch.launch.train", " ".join(argv), flush=True)
    h = train.main(argv)
    finite_params(h)
    rounds_line(h)
    return h


def rounds_line(h):
    w = h["wall"]
    later = (f"later rounds {(w[-1] - w[0]) / (len(w) - 1):.3f} s each"
             if len(w) > 1 else "one round (one-shot)")
    print(f"  -> {len(w) / h['wall_total']:.3f} rounds/s over the run "
          f"({h['wall_total']:.3f} s; first round {w[0]:.3f} s, {later}), "
          f"final acc {h['acc'][-1]:.4f}", flush=True)


def wrappers() -> dict:
    """Every kernel's wrapper, by name: each carries its launch count."""
    from repro_torch.kernels.feature_stats import feature_stats
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.local_step import local_step
    from repro_torch.kernels.paired_fusion import paired_fusion
    from repro_torch.kernels.ssd_update import ssd_update
    return {"paired_fusion": paired_fusion, "local_step": local_step,
            "feature_stats": feature_stats, "grouped_matmul": grouped_matmul,
            "ssd_update": ssd_update}


def counted(label: str, run, expect, gmm_routes: dict | None = None):
    """``run()`` with every launch counter set to 0 just before it and
    read just after; the counts must equal ``expect`` (a dict, or a
    function of run's output giving one: a kernel it does not name must
    not launch), and grouped_matmul's launches by route ``gmm_routes``
    (a route it does not name must not launch)."""
    fns = wrappers()
    gmm = fns["grouped_matmul"]
    expect_routes = {**{r: 0 for r in gmm.route_launches},
                     **(gmm_routes or {})}
    for f in fns.values():
        f.launches = 0
    for r in gmm.route_launches:
        gmm.route_launches[r] = 0
    out = run()
    counts = {k: f.launches for k, f in fns.items()}
    routes = dict(gmm.route_launches)
    expect = {**{k: 0 for k in fns},
              **(expect(out) if callable(expect) else expect)}
    print(f"  launches, {label}: {counts} (expected {expect}); "
          f"grouped_matmul by route {routes} (expected {expect_routes})",
          flush=True)
    assert counts == expect, f"{label}: launches {counts} != {expect}"
    assert routes == expect_routes, \
        f"{label}: grouped_matmul routes {routes} != {expect_routes}"
    return out, counts


def phase_main() -> dict:
    """Returns the launch counts of the run that takes both kernels."""
    from repro_torch.launch import train
    d = train.parse_args([])                    # the CLI's defaults
    steps = d.local_epochs * d.steps_per_epoch
    fuse_only = {"paired_fusion": MAIN_ROUNDS, "local_step": 0,
                 "feature_stats": 0}
    counted("fed2, default routes",
            lambda: cli("--method", "fed2"), fuse_only)
    _, counts = counted(
        "fed2 --use-local-kernel",
        lambda: cli("--method", "fed2", "--use-local-kernel"),
        {"paired_fusion": MAIN_ROUNDS, "local_step": steps * MAIN_ROUNDS,
         "feature_stats": 0})
    counted("fedavg", lambda: cli("--method", "fedavg"), fuse_only)
    # the paper's other testbeds: vgg16.full(fed2_groups=8) on 100
    # classes (104 logits), MobileNetV1 on a Dir(0.5) split
    counted("fed2 --arch vgg16",
            lambda: cli("--method", "fed2", "--arch", "vgg16"), fuse_only)
    counted("fed2 --arch mobilenet --dirichlet 0.5",
            lambda: cli("--method", "fed2", "--arch", "mobilenet",
                        "--dirichlet", "0.5"), fuse_only)
    return counts


@contextlib.contextmanager
def fedma_probe():
    """Times each matched average (one per FedMA round) and records
    whether each permutation it found was the identity."""
    from repro_torch.core import matching
    stats = {"ms": [], "perms": 0, "identity": 0}
    orig_avg, orig_match = matching.matched_average, matching.match_permutation

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig_avg(*a, **k)
        torch.cuda.synchronize()
        stats["ms"].append((time.perf_counter() - t0) * 1e3)
        return res

    def recorded(*a, **k):
        perm = orig_match(*a, **k)
        stats["perms"] += 1
        stats["identity"] += int(np.array_equal(perm,
                                                np.arange(len(perm))))
        return perm

    matching.matched_average, matching.match_permutation = timed, recorded
    try:
        yield stats
    finally:
        matching.matched_average = orig_avg
        matching.match_permutation = orig_match


def fedma_line(stats) -> str:
    return (f"FedMA matched averaging {[round(t, 1) for t in stats['ms']]} "
            f"ms per round; {stats['identity']} of {stats['perms']} "
            f"permutations were the identity"
            f"{' (all)' if stats['identity'] == stats['perms'] else ''}")


def fedadam_run(*extra):
    """The CLI's fedadam run (its inputs, ``run_federated`` as the CLI
    calls it) at server_lr FEDADAM_SERVER_LR: at the CLI's default 1.0
    the Adam step moves every weight by about 1.0 a round, and the full
    VGG9 overflows (ROADMAP Queue 3)."""
    import dataclasses

    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    args = train.parse_args(["--method", "fedadam", "--rounds",
                             str(MAIN_ROUNDS), *extra])
    task, fl, parts, get_batch, test = train.fl_inputs(args)
    fl = dataclasses.replace(fl, server_lr=FEDADAM_SERVER_LR)
    print(f"  the CLI's inputs for --method fedadam {' '.join(extra)}, "
          f"server_lr {fl.server_lr}", flush=True)
    h = run_federated(task, fl, parts, get_batch, test,
                      use_local_kernel=args.use_local_kernel,
                      device="cuda")
    finite_params(h)
    rounds_line(h)
    return h


def phase_methods():
    """The five other methods through the CLI's defaults (vgg9.baseline,
    10 clients, 8 steps of batch 32), 3 rounds each, with and without
    --use-local-kernel: fedavgm, fedadam and fednova fuse through
    paired_fusion once a round (fednova over the normalized deltas);
    scaffold too, and never takes local_step (its own momentum-free
    client update); fedma fuses on the host (no paired_fusion). fedadam
    runs at server_lr FEDADAM_SERVER_LR (``fedadam_run``)."""
    from repro_torch.launch import train
    d = train.parse_args([])
    steps = d.local_epochs * d.steps_per_epoch
    for method in ("fedavgm", "fedadam", "fednova", "scaffold", "fedma"):
        fuse = 0 if method == "fedma" else MAIN_ROUNDS
        local = 0 if method == "scaffold" else steps * MAIN_ROUNDS
        for flag, n_local in (((), 0), (("--use-local-kernel",), local)):
            label = " ".join((method,) + flag)
            run = ((lambda: fedadam_run(*flag)) if method == "fedadam"
                   else (lambda: cli("--method", method, *flag)))
            with fedma_probe() as stats:
                counted(label, run,
                        {"paired_fusion": fuse, "local_step": n_local})
            if method == "fedma":
                assert len(stats["ms"]) == MAIN_ROUNDS
                print(f"  {fedma_line(stats)}", flush=True)


def phase_fednova_parity():
    """One fednova round and one fedavg round from one init and one batch
    stream (TF32 off, deterministic convolutions): under uniform tau the
    two are one function."""
    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    from repro_torch.models.module import tree_leaves
    finals = {}
    init = None
    for method in ("fedavg", "fednova"):
        task, fl, parts, get_batch, test = train.fl_inputs(
            train.parse_args(["--rounds", "1", "--method", method]))
        if init is None:
            init = task.init_fn(torch.Generator().manual_seed(0))
        h = run_federated(task, fl, parts, get_batch, test, device="cuda",
                          init_params=init)
        finite_params(h)
        finals[method] = h["final_params"]
    d = max((a - b).abs().max().item() for a, b in zip(
        tree_leaves(finals["fednova"]), tree_leaves(finals["fedavg"])))
    print(f"  max |dparam| after one round, fednova vs fedavg: {d:.3g} "
          f"(tol {FEDNOVA_PARITY_TOL:g})")
    assert d <= FEDNOVA_PARITY_TOL, f"fednova drifts from fedavg: {d}"


def phase_samplers():
    """The CLI's default method (fed2 on vgg9.full(fed2_groups=8)) under
    each cohort sampler at cohort 5 of 10 (one paired_fusion a round),
    and the full sampler over 20 clients at cohort 10 (2 tiles a round,
    so 2 launches a round)."""
    for extra, fuse in (
            (("--sampler", "uniform", "--cohort-size", "5"), MAIN_ROUNDS),
            (("--sampler", "weighted", "--cohort-size", "5"), MAIN_ROUNDS),
            (("--sampler", "round_robin", "--cohort-size", "5"),
             MAIN_ROUNDS),
            (("--nodes", "20", "--cohort-size", "10"), 2 * MAIN_ROUNDS)):
        h, _ = counted(" ".join(extra), lambda: cli(*extra),
                       {"paired_fusion": fuse, "local_step": 0})
        print(f"  ids per round: "
              f"{[[int(i) for i in p] for p in h['participants']]}",
              flush=True)


def phase_auto_depth() -> int:
    """The full-width structure-adaptation path; returns its
    feature_stats launches."""
    from repro_torch.core.feature_stats import (class_preference_vectors,
                                                total_variance)
    from repro_torch.core.grouping import choose_decouple_depth
    from repro_torch.launch import auto_depth
    out, counts = counted(
        "auto_depth (full width)",
        lambda: auto_depth.run_auto_depth(device="cuda", log=print),
        {"paired_fusion": auto_depth.ROUNDS, "local_step": 0,
         "feature_stats": 1})
    h = out["history"]
    finite_params(h)
    w = h["wall"]
    print(f"  TV profile {[round(t, 4) for t in out['tvs']]} -> decouple "
          f"{out['depth']} ({out['cfg'].n_weight_layers} weight layers); "
          f"fed2 {auto_depth.ROUNDS} rounds in {h['wall_total']:.3f} s "
          f"(later rounds {(w[-1] - w[0]) / (len(w) - 1):.3f} s each); "
          f"accs {[round(a, 4) for a in h['acc']]}")
    assert h["acc"][-1] > 0.1 and h["acc"][-1] > h["acc"][0], \
        "auto-depth fed2 did not learn (final <= chance or first round)"

    def eq9(use_kernel):
        return class_preference_vectors(out["warm_params"], out["warm_cfg"],
                                        *out["probe"], use_kernel=use_kernel)

    with tf32_off(), deterministic_convs():
        on, off = eq9(True), eq9(False)
        tv_on = [float(total_variance(p)) for p in on]
        tv_off = [float(total_variance(p)) for p in off]
    err = max((a - b).abs().max().item() for a, b in zip(on, off))
    ok = all(torch.allclose(a, b, atol=PVEC_ATOL, rtol=PVEC_RTOL)
             for a, b in zip(on, off))
    print(f"  Eq. 9 on the warm model, feature_stats kernel vs plain "
          f"(TF32 off): max_abs_err {err:.3g} (atol {PVEC_ATOL:g}, rtol "
          f"{PVEC_RTOL:g}) {'ok' if ok else 'FAIL'}")
    assert ok, "Eq. 9 through the kernel disagrees with the plain route"
    depth = {k: max(choose_decouple_depth(tv, threshold_frac=0.5,
                                          min_shared=2), 1)
             for k, tv in (("kernel", tv_on), ("plain", tv_off))}
    print(f"  TV profile, kernel route {[round(t, 4) for t in tv_on]}, "
          f"plain route {[round(t, 4) for t in tv_off]}; decouple depth "
          f"{depth['kernel']} and {depth['plain']}")
    assert depth["kernel"] == depth["plain"], \
        "the kernel route chooses another decouple depth"
    # wall time of one Eq. 9 evaluation on the warm model (its C backward
    # passes included), the two routes in turns, as the path runs it
    walls = {True: [], False: []}
    for _ in range(5):
        for use_kernel in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eq9(use_kernel)
            torch.cuda.synchronize()
            walls[use_kernel].append(time.perf_counter() - t0)
    med = {k: sorted(v)[2] * 1e3 for k, v in walls.items()}
    print(f"  Eq. 9 wall time on the warm model, median of 5: kernel "
          f"route {med[True]:.2f} ms, plain route {med[False]:.2f} ms")
    phase_eq9_bf16(out)
    return counts["feature_stats"]


def phase_eq9_bf16(out):
    """Eq. 9 of the warm model cast to bf16 (CNNConfig(dtype=bf16)),
    kernel route (one counted feature_stats launch) against the plain
    route, TF32 off. Both sum the same exact products of bf16 values in
    fp32, so the fp32 Eq. 9 check's tolerances hold."""
    import dataclasses

    from repro_torch.core.feature_stats import class_preference_vectors
    from repro_torch.models.module import tree_map
    cfg = dataclasses.replace(out["warm_cfg"], dtype=torch.bfloat16)
    params = tree_map(lambda t: t.to(torch.bfloat16), out["warm_params"])
    images, labels = out["probe"]
    images = images.to(torch.bfloat16)

    def eq9(use_kernel):
        return class_preference_vectors(params, cfg, images, labels,
                                        use_kernel=use_kernel)

    with tf32_off(), deterministic_convs():
        on, _ = counted("Eq. 9, bf16 warm model, kernel route",
                        lambda: eq9(True), {"feature_stats": 1})
        off = eq9(False)
    err = max((a - b).abs().max().item() for a, b in zip(on, off))
    ok = all(a.dtype == torch.float32 and torch.allclose(
        a, b, atol=PVEC_ATOL, rtol=PVEC_RTOL) for a, b in zip(on, off))
    print(f"  Eq. 9 on the bf16 warm model, feature_stats kernel vs plain "
          f"(TF32 off): max_abs_err {err:.3g} (atol {PVEC_ATOL:g}, rtol "
          f"{PVEC_RTOL:g}) {'ok' if ok else 'FAIL'}")
    assert ok, "bf16 Eq. 9 through the kernel disagrees with the plain route"


def _category(name: str) -> str:
    n = name.lower()
    for cat, keys in (("paired_fusion", ("paired_fusion",)),
                      ("local_step", ("local_step",)),
                      ("ssd_update", ("ssd_update",)),
                      ("grouped_matmul", ("grouped_matmul",)),
                      ("memcpy/memset", ("memcpy", "memset")),
                      ("index_select/index_add (tier extract, combine)",
                       ("indexselect", "indexfunc")),
                      # cuBLAS's own GEMMs (the LM's projections, the
                      # SSD chunks' fp32 products); cuDNN's convs are
                      # xmma_fprop/dgrad/wgrad, caught below
                      ("gemm", ("xmma_gemm",)),
                      ("conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit",
                                        "wgrad", "dgrad", "winograd")),
                      ("gemm", ("gemm", "gemv", "cutlass", "cublas",
                                "nvjet"))):
        if any(k in n for k in keys):
            return cat
    return "other (elementwise, reductions, norms, pooling)"


GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
            "aten::mv", "aten::addmv", "aten::matmul", "aten::einsum")


def attention_us(prof, tile: tuple) -> float:
    """Device time (us) of the operators, GEMMs aside, that read or write
    an attention score tile: an input of 4 or more dims whose last two
    are ``tile`` = (q chunk, kv chunk) rows. Those are the chunked
    attention's elementwise and softmax passes (scale, mask, max, exp,
    sum, casts), forward, rematerialized and backward."""
    from torch.autograd import DeviceType
    total = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != DeviceType.CPU or e.key in GEMM_OPS:
            continue
        if any(isinstance(sh, (list, tuple)) and len(sh) >= 4
               and tuple(sh[-2:]) == tile for sh in e.input_shapes):
            total += e.self_device_time_total
    return total


def profiled(label: str, run, attention_tile: tuple | None = None):
    """``run()`` under torch.profiler: device time by kernel category,
    and the share of the run's wall time in which the card ran a kernel
    or a copy. With ``attention_tile`` (records shapes) the chunked
    attention's elementwise and softmax passes are split out of the
    non-GEMM time (``attention_us``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=attention_tile is not None) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    total_us = sum(e.self_device_time_total for e in dev)
    print(f"  {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{total_us / 1e3:.1f} ms ({100 * total_us / 1e3 / wall / 1e3:.1f}"
          f" %), {sum(e.count for e in dev)} device ops")
    if not dev:
        print("  device time: not measured (the profiler saw no device "
              "events)")
        return
    by_cat = {}
    for e in dev:
        c = _category(e.key)
        by_cat[c] = by_cat.get(c, 0.0) + e.self_device_time_total
    if attention_tile is not None:
        att = attention_us(prof, attention_tile)
        other = "other (elementwise, reductions, norms, pooling)"
        by_cat[other] = by_cat.get(other, 0.0) - att
        by_cat["attention's elementwise and softmax passes "
               f"({attention_tile[0]} x {attention_tile[1]} tiles)"] = att
    for c, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {c:<48s} {us / 1e3:8.2f} ms  {100 * us / total_us:5.1f} %")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} "
              f"{e.key[:90]}")


def phase_profile():
    """The main path (fed2, --use-local-kernel, 3 rounds) under
    torch.profiler."""
    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    inputs = train.fl_inputs(train.parse_args(["--rounds", "3"]))
    profiled("3 rounds", lambda: run_federated(
        *inputs, use_local_kernel=True, device="cuda"))


def phase_parity():
    """One fed2 round from one init and one batch stream, with TF32 off
    and deterministic convolutions, so that runs of one route agree bit
    for bit and routes differ only by the kernels:

    - fusion kernel only vs plain: the local phases are identical, so
      the fused globals differ by the fusion's fp32 summation order
      alone; tolerance 1e-5, the kernel check's;
    - both kernels vs plain: ``local_step`` rounds the momentum step
      differently (fused multiply-adds), and 8 local steps carry that
      through the net. The limit is what the same round makes of a
      one-ulp change of the initial parameters on the plain route: the
      kernels may move the result no further than round-off in the
      inputs does."""
    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    from repro_torch.models.module import tree_leaves, tree_map
    task, fl, parts, get_batch, test = train.fl_inputs(
        train.parse_args(["--rounds", "1"]))
    init = task.init_fn(torch.Generator().manual_seed(0))
    ulp = tree_map(lambda t: torch.nextafter(t, torch.full_like(
        t, math.inf)), init)
    out = {}
    for label, fuse_k, local_k, start in (
            ("plain", False, False, init), ("plain again", False, False, init),
            ("fusion kernel", True, False, init),
            ("both kernels", True, True, init),
            ("plain, init + 1 ulp", False, False, ulp)):
        out[label] = run_federated(task, fl, parts, get_batch, test,
                                   use_kernel=fuse_k,
                                   use_local_kernel=local_k, device="cuda",
                                   init_params=start)
        finite_params(out[label])

    def max_diff(a):
        return max((x - y).abs().max().item()
                   for x, y in zip(tree_leaves(out[a]["final_params"]),
                                   tree_leaves(out["plain"]["final_params"])))

    d = {k: max_diff(k) for k in out if k != "plain"}
    for k, v in d.items():
        print(f"  max |dparam| after one round, {k} vs plain: {v:.3g}")
    print(f"  acc: both kernels {out['both kernels']['acc'][-1]:.4f}, "
          f"plain {out['plain']['acc'][-1]:.4f}")
    assert d["fusion kernel"] <= FUSION_PARITY_TOL, \
        f"fusion kernel route drifts from plain: {d['fusion kernel']}"
    assert d["both kernels"] <= d["plain, init + 1 ulp"], (
        f"kernel routes drift from plain ({d['both kernels']}) beyond a "
        f"one-ulp change of the init ({d['plain, init + 1 ulp']})")


def phase_scenario() -> dict:
    """nxc2_fed2 and the added scenarios, each for its 10 rounds,
    counted like the main path; each must learn (final > twice
    chance). The JAX package's committed final accuracies are shown
    beside them, not matched: the inits differ. Returns the records by
    name."""
    from repro_torch.fl import scenarios
    recs = {}
    for name in ("nxc2_fed2", "nxc2_fedma", "dir05_fed2", "qskew_fed2",
                 "iid_fedavg"):
        spec = scenarios.get(name)
        fuse = 0 if spec.method == "fedma" else spec.rounds
        with fedma_probe() as stats:
            rec, _ = counted(
                name, lambda: scenarios.run_scenario(spec, device="cuda"),
                {"paired_fusion": fuse, "local_step": 0})
        print(f"  {name} ({spec.protocol_label()}, {spec.rounds} rounds, "
              f"{rec.wall_total:.2f} s): final acc {rec.final_acc:.4f} "
              f"(the JAX package's committed record: "
              f"{SCENARIO_REFERENCE[name]}; inits differ), accs "
              f"{[round(a, 4) for a in rec.acc]}", flush=True)
        if spec.method == "fedma":
            print(f"  {fedma_line(stats)}", flush=True)
        assert rec.final_acc > 0.2, f"{name} did not learn (<= 2x chance)"
        recs[name] = rec
    return recs


def phase_axes():
    """The sync round's feature axes through the CLI at its full-width
    defaults (vgg9.full(fed2_groups=8) for fed2, vgg9.baseline for
    fedavg; 10 clients, 8 steps of batch 32), 3 rounds each, counted:
    the fusion kernel runs once a round after the bf16 local phase, the
    codecs, norm_clip, the attacks and PAN, never under
    trimmed_mean(0.25) (a reducing rule has no kernel), and once in the
    whole one-shot run; local_step once a local step with
    --use-local-kernel (on the bf16 shadow buffer under bfloat16). Then
    the robust reductions' device time on the (10, M) cohort."""
    from repro_torch.launch import train
    d = train.parse_args([])
    steps = d.local_epochs * d.steps_per_epoch
    r = MAIN_ROUNDS
    atk = ("--attack", "sign_flip(4)", "--attack-fraction", "0.2")
    for extra, fuse, local in (
            (("--compute-dtype", "bfloat16"), r, 0),
            (("--compute-dtype", "bfloat16", "--use-local-kernel"), r,
             steps * r),
            (("--codec", "int8"), r, 0),
            (("--codec", "topk(0.05)"), r, 0),
            (atk + ("--robust", "trimmed_mean(0.25)"), 0, 0),
            (atk + ("--robust", "norm_clip(10)"), r, 0),
            (("--method", "fedavg", "--attack", "label_flip",
              "--attack-fraction", "0.2"), r, 0),
            (("--method", "fedavg", "--alignment", "pan"), r, 0),
            (("--fed-mode", "one_shot", "--use-local-kernel"), 1,
             steps * r)):
        h, _ = counted(" ".join(extra), lambda: cli(*extra),
                       {"paired_fusion": fuse, "local_step": local})
        if "one_shot" in extra:
            assert len(h["acc"]) == 1, "one-shot ran more than one fusion"
    robust_sort_times()


def event_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` between two CUDA events over ``reps`` eager
    calls (after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def robust_sort_times():
    """trimmed_mean(0.25) and coordinate_median over the main path's
    (10, M) fp32 cohort (a stable sort of the client axis, then
    cumulative weights), against the weighted mean of paired_fusion on
    the same buffer; device time between CUDA events."""
    from repro_torch.fl.robust import parse_robust
    from repro_torch.kernels.paired_fusion import paired_fusion
    layout = main_layout()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = cohort(layout, 10, torch.float32, gen)
    w = torch.full((10,), 0.1, device="cuda")
    times = {name: event_ms(lambda rule=parse_robust(name):
                            rule.reduce(x, w), 20)
             for name in ("trimmed_mean(0.25)", "coordinate_median")}
    fuse = event_ms(lambda: paired_fusion(x, w), 20)
    print(f"  robust reductions of the (10, {layout.size}) cohort: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f"; paired_fusion (weighted mean) {fuse:.3f} ms", flush=True)


def phase_axes_parity():
    """One round of the CLI's fed2 from one init and one batch stream
    (TF32 off, deterministic convolutions): the identity codec,
    trimmed_mean(0), norm_clip(inf) and local_unroll 4 give the plain
    round to the bit; bf16 with and without --use-local-kernel agree
    within BF16_ROUTES_TOL."""
    import dataclasses

    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    from repro_torch.models.module import FlatLayout
    task, fl, parts, get_batch, test = train.fl_inputs(
        train.parse_args(["--rounds", "1"]))
    init = task.init_fn(torch.Generator().manual_seed(0))
    layout = FlatLayout(init)

    def run(use_local_kernel=False, **over):
        h = run_federated(task, dataclasses.replace(fl, **over), parts,
                          get_batch, test, device="cuda", init_params=init,
                          use_local_kernel=use_local_kernel)
        finite_params(h)
        return layout.flatten(h["final_params"])

    plain = run()
    for label, over in (("plain again", {}),
                        ("--codec identity", {"codec": "identity"}),
                        ("--robust trimmed_mean(0)",
                         {"robust": "trimmed_mean(0)"}),
                        ("--robust norm_clip(inf)",
                         {"robust": "norm_clip(inf)"}),
                        ("--local-unroll 4", {"local_unroll": 4})):
        same = torch.equal(run(**over), plain)
        print(f"  {label} vs plain: "
              f"{'bit-identical' if same else 'DIFFERS'}", flush=True)
        assert same, f"{label} is not the plain round bit for bit"
    a = run(compute_dtype="bfloat16")
    b = run(True, compute_dtype="bfloat16")
    dev = (a - b).abs().max().item()
    print(f"  --compute-dtype bfloat16, local_step vs plain route: max "
          f"|dparam| {dev:.3g} (tol {BF16_ROUTES_TOL:g}); vs the fp32 "
          f"round: {(a - plain).abs().max().item():.3g}", flush=True)
    assert dev <= BF16_ROUTES_TOL, f"bf16 routes drift apart: {dev}"


@contextlib.contextmanager
def history_probe():
    """Keeps the history of every run_federated call (run_scenario
    returns a record without the final parameters)."""
    from repro_torch.fl import runtime
    hist, orig = [], runtime.run_federated

    def kept(*a, **k):
        hist.append(orig(*a, **k))
        return hist[-1]

    runtime.run_federated = kept
    try:
        yield hist
    finally:
        runtime.run_federated = orig


def phase_axes_scenarios(recs: dict):
    """The 12 feature-axis scenarios and nxc2_fedavg for their 10 rounds
    (deterministic convolutions), counted: paired_fusion once a round,
    never under trimmed_mean, once in a one-shot run. Each final
    accuracy beside the JAX package's record. Asserted: one history row
    per one-shot run, nxc2_fedavg_none equal to nxc2_fedavg to the bit,
    label-flip best accuracy >= 0.2, finite parameters on the trimmed
    rows. The orderings of tests/test_paper_claims.py are printed, not
    asserted (the inits differ from the JAX package's)."""
    from repro_torch.fl import scenarios
    from repro_torch.models.module import tree_leaves
    finals = {}
    for name in AXES_SCENARIO_REFERENCE:
        spec = scenarios.get(name)
        fuse = (1 if spec.mode == "one_shot" else
                0 if spec.robust.startswith("trimmed") else spec.rounds)
        with history_probe() as hist:
            rec, _ = counted(
                name, lambda: scenarios.run_scenario(spec, device="cuda"),
                {"paired_fusion": fuse, "local_step": 0})
        recs[name], finals[name] = rec, hist[-1]["final_params"]
        print(f"  {name} ({spec.protocol_label()}, {len(rec.acc)} rows, "
              f"{rec.wall_total:.2f} s): final acc {rec.final_acc:.4f}, "
              f"best {rec.best_acc:.4f} (the JAX package's committed "
              f"record: {AXES_SCENARIO_REFERENCE[name]}; inits differ), "
              f"accs {[round(a, 4) for a in rec.acc]}", flush=True)
        if spec.mode == "one_shot":
            assert len(rec.acc) == 1, f"{name}: {len(rec.acc)} rows"
        if "flip20" in name and "signflip" not in name:
            assert rec.best_acc >= 0.2, f"{name} did not survive label flip"
        if name.endswith("_trim"):
            finite_params(hist[-1])
    same = recs["nxc2_fedavg_none"].acc == recs["nxc2_fedavg"].acc and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(finals[
            "nxc2_fedavg_none"]), tree_leaves(finals["nxc2_fedavg"])))
    print(f"  nxc2_fedavg_none vs nxc2_fedavg: "
          f"{'bit-identical' if same else 'DIFFERS'}", flush=True)
    assert same, "nxc2_fedavg_none is not nxc2_fedavg bit for bit"
    f = {k: v.final_acc for k, v in recs.items()}
    for claim, held in (
            ("fed2 + trim >= plain fedavg + 0.10 under sign flip",
             f["nxc2_fed2_signflip20_trim"]
             >= f["nxc2_fedavg_signflip20"] + CLAIMS_MARGIN),
            ("fedavg + trim >= fedavg + 0.10 under sign flip",
             f["nxc2_fedavg_signflip20_trim"]
             >= f["nxc2_fedavg_signflip20"] + CLAIMS_MARGIN),
            ("fed2 + trim >= fed2 + 0.10 under sign flip",
             f["nxc2_fed2_signflip20_trim"]
             >= f["nxc2_fed2_signflip20"] + CLAIMS_MARGIN),
            ("nxc: grouped >= pan >= none",
             f["nxc2_fed2"] >= f["nxc2_fedavg_pan"]
             >= f["nxc2_fedavg_none"]),
            ("dirichlet: grouped >= pan >= none",
             f["dir05_fed2"] >= f["dir05_fedavg_pan"]
             >= f["dir05_fedavg_none"]),
            ("one-shot fed2 >= one-shot fedavg",
             f["nxc2_fed2_oneshot"] >= f["nxc2_fedavg_oneshot"]),
            ("multi-round fedavg >= one-shot fedavg",
             f["nxc2_fedavg"] >= f["nxc2_fedavg_oneshot"])):
        print(f"  claim ({'holds' if held else 'does not hold'} here): "
              f"{claim}", flush=True)


@contextlib.contextmanager
def combine_probe():
    """CUDA events around each tier combine (``TieredEngine.combine``):
    the stream time from its first to its last op, one per round."""
    from repro_torch.fl import capacity
    events, orig = [], capacity.TieredEngine.combine

    def timed(self, *a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(self, *a, **k)
        end.record()
        events.append((start, end))
        return out

    capacity.TieredEngine.combine = timed
    try:
        yield events
    finally:
        capacity.TieredEngine.combine = orig


def steps_per_round() -> int:
    from repro_torch.launch import train
    d = train.parse_args([])                    # the CLI's defaults
    return d.local_epochs * d.steps_per_epoch


def phase_check_tier_layouts():
    """paired_fusion and local_step at every tier layout of paths A and
    B, whose parameter counts must be the reference's: a (2, M_t)
    cohort, and a (3, M_t) one whose third row (a padded slot) has
    weight 0. Tolerances: the kernel checks' (fp32 1e-5 and 1e-6)."""
    from repro_torch.configs import vgg9
    from repro_torch.fl.capacity import cnn_tier_model, parse_tiers
    from repro_torch.kernels.local_step import local_step, local_step_ref
    from repro_torch.kernels.paired_fusion import (paired_fusion,
                                                   paired_fusion_ref)
    gen = torch.Generator(device="cuda").manual_seed(7)
    models = {"A": vgg9.baseline(), "B": vgg9.full(fed2_groups=5)}
    for path, (extra, counts) in TIER_PATHS.items():
        widths = [w for w, _ in parse_tiers(extra[-1])]
        for width, want in zip(widths, counts):
            layout = layout_of(cnn_tier_model(models[path], width).model_cfg)
            assert layout.size == want, (path, width, layout.size, want)
            x = cohort(layout, 3, torch.float32, gen)
            w = torch.rand(2, generator=gen, device="cuda") + 0.1
            w = w / w.sum()
            w0 = torch.cat([w, torch.zeros(1, device="cuda")])
            name = f"path {path}, width {width} (M_t={layout.size})"
            check(f"paired_fusion (2, M_t), {name}",
                  paired_fusion(x[:2], w), paired_fusion_ref(x[:2], w), 1e-5)
            check(f"paired_fusion (3, M_t) with a weight-0 pad row, {name}",
                  paired_fusion(x, w0), paired_fusion_ref(x, w0), 1e-5)
            p, v, g = (cohort(layout, 2, torch.float32, gen, sc)
                       for sc in (1.0, 0.1, 1.0))
            wp, wv = local_step_ref(p, v, g, 0.01, 0.9)
            local_step(p, v, g, lr=0.01, mu=0.9)
            check(f"local_step (2, M_t) p, {name}", p, wp, 1e-6)
            check(f"local_step (2, M_t) v, {name}", v, wv, 1e-6)


def phase_check_event_fusion():
    """paired_fusion on a (2, 521,616) async event buffer (the main
    model's layout and row stride) under the raw effective weights of
    staleness [0, 3] at polynomial(0.5), which the fuse normalizes; and
    the whole fedavg fuse on it, kernel route vs plain (1e-5)."""
    from repro_torch.core import fusion
    from repro_torch.fl.async_engine import effective_weights, \
        parse_staleness
    from repro_torch.kernels.paired_fusion import (paired_fusion,
                                                   paired_fusion_ref)
    gen = torch.Generator(device="cuda").manual_seed(8)
    layout = main_layout()
    buf = cohort(layout, 2, torch.float32, gen)
    w_eff = effective_weights([412.0, 389.0], [0, 3],
                              parse_staleness("polynomial(0.5)"))
    wn = torch.as_tensor(w_eff / w_eff.sum(), dtype=torch.float32,
                         device="cuda")
    name = f"(2, {layout.size}) event buffer, staleness [0, 3]"
    check(f"paired_fusion {name}", paired_fusion(buf, wn),
          paired_fusion_ref(buf, wn), 1e-5)
    check(f"fedavg fuse, kernel vs plain, {name}",
          fusion.fedavg(buf, w_eff, use_kernel=True),
          fusion.fedavg(buf, w_eff, use_kernel=False), 1e-5)


def phase_tiers():
    """Paths A and B through the CLI at full width, 3 rounds each, with
    and without --use-local-kernel, counted: paired_fusion once per tier
    tile a round (3), local_step once per local step per tile with the
    flag (3 x 8 a round); s/round and the combine's time per round."""
    r, steps = MAIN_ROUNDS, steps_per_round()
    for path, (extra, _) in TIER_PATHS.items():
        for flag, local in (((), 0), (("--use-local-kernel",),
                                      3 * steps * r)):
            with combine_probe() as events:
                counted(f"path {path}: {' '.join(extra + flag)}",
                        lambda: cli(*extra, *flag),
                        {"paired_fusion": 3 * r, "local_step": local})
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in events]
            assert len(ms) == r, ms
            print(f"  tier combine, CUDA-event ms per round: "
                  f"{[round(t, 3) for t in ms]}", flush=True)


def phase_tiers_parity():
    """At path A's full width (TF32 off, deterministic convs): the
    tiered engine forced onto one width-1.0 tier vs the homogeneous
    round (within FORCED_TIER_TOL), and a round in which only the 0.25
    tier trains: every coordinate it does not hold keeps the previous
    global to the bit."""
    from repro_torch.fl import capacity, methods
    from repro_torch.fl.engine import make_round_engine
    from repro_torch.fl.population import Population
    from repro_torch.fl.runtime import _pack_client_batches, \
        device_batches, initial_params
    from repro_torch.launch import train
    args = train.parse_args(["--method", "fedavg", "--nodes", "6",
                             "--rounds", "1"])
    task, fl, parts, get_batch, _ = train.fl_inputs(args)
    params = initial_params(task, fl, None, "cuda")
    meth = methods.get("fedavg")
    steps = fl.local_epochs * fl.steps_per_epoch

    def tiered_round(mix, ids):
        plan = capacity.TierPlan.from_mix(mix, 6, seed=fl.seed)
        tiered = capacity.make_tiered_engine(task, fl, params, plan,
                                             device="cuda", method=meth)
        pop = Population.from_parts(parts)
        pop.tiers = plan.assignment
        gp = tiered.full.layout.flatten(params)
        _, out = capacity.run_tiered_round(
            tiered, pop, meth, tiered.full.init_server_state(gp), gp,
            ids(plan), get_batch, steps, fl, np.random.default_rng(0))
        return tiered, gp, out

    _, gp, g_t = tiered_round(((1.0, 6),), lambda plan: np.arange(6))
    engine = make_round_engine(task, fl, params, device="cuda", method=meth)
    batches = _pack_client_batches(parts, get_batch, steps, fl.batch_size,
                                   np.random.default_rng(0))
    _, g_h = engine.run_round(
        {"server": engine.init_server_state(gp), "clients": ()}, gp,
        device_batches(batches, "cuda"),
        weights=Population.from_parts(parts).weights)
    d = (g_t - g_h).abs().max().item()
    print(f"  forced one-tier engine vs homogeneous round: max |dparam| "
          f"{d:.3g} (tol {FORCED_TIER_TOL:g})", flush=True)
    assert d <= FORCED_TIER_TOL, f"forced tier round drifts: {d}"
    mix = ((1.0, 2), (0.5, 2), (0.25, 2))
    tiered, gp, g_q = tiered_round(mix, lambda plan: plan.ids_of(2))
    covered = torch.zeros_like(gp, dtype=torch.bool)
    covered[tiered.tiles[2].index] = True
    kept = torch.equal(g_q[~covered], gp[~covered])
    moved = (g_q[covered] - gp[covered]).abs().max().item()
    print(f"  only the 0.25 tier trains: {int((~covered).sum())} "
          f"uncovered coordinates "
          f"{'keep the previous global bit for bit' if kept else 'MOVED'};"
          f" covered ones move by up to {moved:.3g}", flush=True)
    assert kept and moved > 0, "the uncovered region left the global"


def phase_async():
    """Path C (fed2 on vgg9.full(fed2_groups=8), fedavg on
    vgg9.baseline) through the CLI, 6 fusion events each, with and
    without --use-local-kernel, counted: paired_fusion once per event,
    local_step once per local step of every dispatch-group tile with
    the flag; s/event, local tiles and the staleness lists."""
    steps = steps_per_round()
    for method in ("fed2", "fedavg"):
        for flag in ((), ("--use-local-kernel",)):
            extra = (("--method", method) + ASYNC_PATH
                     + ("--rounds", str(ASYNC_EVENTS)) + flag)
            h, _ = counted(
                " ".join(extra), lambda: cli(*extra),
                lambda h: {"paired_fusion": ASYNC_EVENTS,
                           "local_step": h["local_tiles"] * steps
                           if flag else 0})
            w = h["wall"]
            assert len(h["acc"]) == ASYNC_EVENTS
            print(f"  {ASYNC_EVENTS} events, {h['local_tiles']} local "
                  f"tiles, later events {(w[-1] - w[0]) / (len(w) - 1):.3f}"
                  f" s each; staleness {h['staleness']}; sim_time "
                  f"{[round(t, 4) for t in h['sim_time']]}", flush=True)


def phase_async_parity():
    """The CLI's fed2 at --cohort-size 4 --sampler uniform (TF32 off,
    deterministic convs), 3 rounds sync and 3 events async with
    buffer_k = cohort, zero latency and the constant discount, with and
    without --use-local-kernel: final params and every accuracy equal
    bit for bit."""
    import dataclasses

    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    from repro_torch.models.module import tree_leaves
    task, fl, parts, get_batch, test = train.fl_inputs(train.parse_args(
        ["--cohort-size", "4", "--sampler", "uniform", "--rounds", "3"]))
    init = task.init_fn(torch.Generator().manual_seed(0))
    for local in (False, True):
        runs = [run_federated(task, dataclasses.replace(fl, mode=mode),
                              parts, get_batch, test, device="cuda",
                              init_params=init, use_local_kernel=local)
                for mode in ("sync", "async")]
        for h in runs:
            finite_params(h)
        sync, asyn = runs
        same = sync["acc"] == asyn["acc"] and all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves(sync["final_params"]),
                tree_leaves(asyn["final_params"])))
        print(f"  async (buffer_k = cohort, zero latency, constant) vs "
              f"sync{' --use-local-kernel' if local else ''}: "
              f"{'bit-identical' if same else 'DIFFERS'}; staleness "
              f"{asyn['staleness']}, accs {asyn['acc']}", flush=True)
        assert same, "the degenerate async run is not the sync run"
        assert all(s == [0] * 4 for s in asyn["staleness"])


def phase_tier_async_scenarios():
    """The 5 tier and 2 async scenarios at their registered settings (10
    rounds; 15 events), counted: paired_fusion once per tier tile a
    round (3) or once per event. Finite params, one history row per
    round or event; each final accuracy beside the JAX package's
    committed record (read as JSON; inits differ, so not matched); the
    async schedule is numpy's alone, so sim_time must equal the
    record's to 4 decimals."""
    from repro_torch.fl import scenarios
    for name in TIER_ASYNC_SCENARIOS:
        spec = scenarios.get(name)
        ref = json.loads((ROOT / "benchmarks" / "artifacts_perf"
                          / f"scenario_{name}.json").read_text())
        fuse = spec.rounds * (len(spec.tiers) or 1)
        with history_probe() as hist:
            rec, _ = counted(
                name, lambda: scenarios.run_scenario(spec, device="cuda"),
                {"paired_fusion": fuse, "local_step": 0})
        finite_params(hist[-1])
        assert len(rec.acc) == spec.rounds, (name, len(rec.acc))
        print(f"  {name} ({spec.protocol_label()}, {len(rec.acc)} "
              f"{'events' if spec.mode == 'async' else 'rounds'}, "
              f"{rec.wall_total:.2f} s): final acc {rec.final_acc:.4f}, "
              f"best {rec.best_acc:.4f} (the JAX package's committed "
              f"record: {ref['final_acc']:.4f}; inits differ), accs "
              f"{[round(a, 4) for a in rec.acc]}", flush=True)
        if ref.get("sim_time"):
            same = rec.sim_time == ref["sim_time"]
            print(f"  {name} sim_time {rec.sim_time} "
                  f"{'equals' if same else 'DIFFERS FROM'} the record's",
                  flush=True)
            assert same, f"{name}: sim_time differs from the record"


def phase_tier_async_profile():
    """Path A (--use-local-kernel, 3 rounds) and path C (fed2,
    --use-local-kernel, 6 events) under torch.profiler."""
    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    a = train.parse_args(list(TIER_PATHS["A"][0]) + ["--rounds", "3"])
    inputs = train.fl_inputs(a)
    profiled("path A, 3 rounds", lambda: run_federated(
        *inputs, use_local_kernel=True, device="cuda"))
    c = train.parse_args(["--method", "fed2", *ASYNC_PATH, "--rounds",
                          str(ASYNC_EVENTS)])
    inputs = train.fl_inputs(c)
    profiled(f"path C (fed2), {ASYNC_EVENTS} events", lambda: run_federated(
        *inputs, latency=c.latency, use_local_kernel=True, device="cuda"))


def same_run(a, b) -> bool:
    """Two histories with the same rounds, accuracies, per-class rows,
    confusion counts and sampled ids, and the same final params, bit
    for bit."""
    from repro_torch.models.module import tree_leaves
    keys = ("round", "acc", "per_class_acc", "confusion", "participants")
    return all(len(a[k]) == len(b[k]) and all(
        np.array_equal(x, y) for x, y in zip(a[k], b[k])) for k in keys) \
        and all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a["final_params"]), tree_leaves(b["final_params"])))


@contextlib.contextmanager
def save_probe():
    """Records each FL checkpoint save: its round, the mmap store's
    shards flushed (of all), the client-shard bytes it wrote and the
    save's wall time."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.fl.statestore import MmapShardStore
    saves = []
    orig_save, orig_shards = (ckpt_io.save_fl_checkpoint,
                              MmapShardStore.checkpoint_shards)

    def shards(self, clients_dir, step):
        before = dict(self._ckpt_files)
        files = orig_shards(self, clients_dir, step)
        fresh = {k: v for k, v in files.items() if before.get(k) != v}
        saves[-1].update(
            flushed=len({k.split(":")[1] for k in fresh}),
            shards=self.n_shards,
            bytes=sum(os.path.getsize(os.path.join(clients_dir, v))
                      for v in fresh.values()))
        return files

    def save(path, **kw):
        saves.append({"round": kw["round_idx"]})
        t0 = time.perf_counter()
        orig_save(path, **kw)
        saves[-1]["s"] = time.perf_counter() - t0

    ckpt_io.save_fl_checkpoint, MmapShardStore.checkpoint_shards = (
        save, shards)
    try:
        yield saves
    finally:
        ckpt_io.save_fl_checkpoint = orig_save
        MmapShardStore.checkpoint_shards = orig_shards


def save_lines(saves):
    for sv in saves:
        print(f"  save after round {sv['round']}: {sv['flushed']} of "
              f"{sv['shards']} shards flushed, "
              f"{sv['bytes'] / 1e6:.1f} MB of client shards written, "
              f"{sv['s']:.3f} s", flush=True)


def phase_store_cli():
    """(a) The CLI's main path (fed2 on vgg9.full(fed2_groups=8), 10
    clients, 3 rounds) with --store mmap --chunk-size 4, with and
    without --use-local-kernel, counted like the main phase; each run
    equal to the --store memory run of the same flags to the bit."""
    steps = steps_per_round()
    for flag, local in (((), 0), (("--use-local-kernel",),
                                  steps * MAIN_ROUNDS)):
        runs = {}
        for store in ("memory", "mmap"):
            extra = (("--method", "fed2", "--store", store) + flag
                     + (("--chunk-size", str(STORE_CLI_CHUNK))
                        if store == "mmap" else ()))
            runs[store], _ = counted(
                " ".join(extra), lambda: cli(*extra),
                {"paired_fusion": MAIN_ROUNDS, "local_step": local})
        same = same_run(runs["memory"], runs["mmap"])
        print(f"  --store mmap vs --store memory{' ' if flag else ''}"
              f"{' '.join(flag)}: {'bit-identical' if same else 'DIFFER'}",
              flush=True)
        assert same, "the mmap store changed the CLI's run"


def phase_store_resume():
    """(b) scaffold (client control variates) on vgg9.baseline over 100
    clients, uniform cohort of 10, mmap store at 8 rows a shard: 4
    rounds straight through each store (s/round of both; the two runs
    equal to the bit), then 2 rounds saving every round and a resume to
    4, counted (paired_fusion 2, local_step 0): rounds [2, 3], accuracies
    and final params equal to the straight run's to the bit. Each save:
    shards flushed (every shard the first time, at most the cohort's
    after), bytes written, wall time."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    from repro_torch.models.module import param_count, tree_leaves
    args = train.parse_args(list(STORE_RESUME) + [
        "--rounds", str(STORE_RESUME_ROUNDS)])
    task, fl, parts, get_batch, test = train.fl_inputs(args)
    init = task.init_fn(torch.Generator().manual_seed(0))
    n_par = param_count(init)
    shards = -(-fl.population // fl.chunk_size)
    print(f"  scaffold, {n_par:,} params ({4 * n_par / 1e6:.2f} MB a "
          f"client row), population {fl.population}, cohort "
          f"{fl.cohort_size}, {fl.chunk_size} rows a shard: {shards} "
          f"shards, {4 * n_par * fl.population / 1e9:.2f} GB of client "
          f"state", flush=True)

    def run(cfg, **kw):
        h = run_federated(task, cfg, parts, get_batch, test, device="cuda",
                          init_params=init, **kw)
        finite_params(h)
        rounds_line(h)
        return h

    straight = {}
    for store in ("memory", "mmap"):
        print(f"  straight, --store {store}:", flush=True)
        straight[store] = run(dataclasses.replace(fl, store=store))
    same = same_run(straight["memory"], straight["mmap"])
    print(f"  straight runs, mmap vs memory store: "
          f"{'bit-identical' if same else 'DIFFER'}", flush=True)
    assert same, "the mmap store changed scaffold's run"
    tmp = tempfile.mkdtemp(prefix="chip-smoke-store-")
    try:
        ck = os.path.join(tmp, "ck")
        with save_probe() as saves:
            print("  2 rounds, saving every round:", flush=True)
            run(dataclasses.replace(fl, rounds=2), checkpoint_dir=ck)
            print("  resumed to 4 rounds:", flush=True)
            resumed, _ = counted(
                "scaffold resume, rounds 2-3",
                lambda: run(fl, checkpoint_dir=ck, resume=True),
                {"paired_fusion": 2, "local_step": 0})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    save_lines(saves)
    assert [sv["round"] for sv in saves] == [1, 2, 3, 4], saves
    assert saves[0]["flushed"] == shards
    assert all(sv["flushed"] <= fl.cohort_size for sv in saves[1:]), saves
    ref = straight["mmap"]
    same = (resumed["round"] == [2, 3] and resumed["acc"] == ref["acc"][2:]
            and all(torch.equal(a, b) for a, b in zip(
                tree_leaves(resumed["final_params"]),
                tree_leaves(ref["final_params"]))))
    print(f"  resumed rounds {resumed['round']}, accs {resumed['acc']} vs "
          f"straight {ref['acc'][2:]}: "
          f"{'bit-identical' if same else 'DIFFER'}", flush=True)
    assert same, "the resumed run differs from the straight run"


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    return float("nan")


@contextlib.contextmanager
def rss_peak():
    """The process's resident set, sampled every 5 ms on a thread while
    the block runs: {"start", "end", "peak"} in MB."""
    rec = {"start": _rss_mb()}
    rec["peak"] = rec["start"]
    stop = threading.Event()

    def sample():
        while not stop.wait(0.005):
            rec["peak"] = max(rec["peak"], _rss_mb())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield rec
    finally:
        stop.set()
        t.join(timeout=5)
        rec["end"] = _rss_mb()
        rec["peak"] = max(rec["peak"], rec["end"])


def phase_store_population():
    """(c) The reference's bench_cohort rung: fedavg on vgg9.baseline,
    one engine of cohort width 8 for every population, parts striped
    over the CLI's 4000 images (ShardIndices.striped), the weighted
    sampler's alias table, the mmap store (4096 rows a shard) holding
    parts and weights on disk; one warm round, then 4 timed rounds
    through run_sampled_round, counted (paired_fusion once a round).
    s/round and the process's RSS over each rung; no timing is
    asserted."""
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.fl import methods, population, statestore
    from repro_torch.fl.engine import make_round_engine
    from repro_torch.fl.population import Population
    from repro_torch.fl.runtime import (FLConfig, cnn_task, initial_params,
                                        run_sampled_round)
    from repro_torch.launch import train
    args = train.parse_args(["--method", "fedavg"])
    meth, smp = methods.get("fedavg"), population.get(STORE_RUNG["sampler"])
    task = cnn_task(train.build_model_config(args, meth))
    ds = make_image_dataset(args.train_size, n_classes=10, seed=args.seed,
                            noise=args.noise)

    def get_batch(sel):
        return {"images": ds.images[sel], "labels": ds.labels[sel]}

    cfg0 = FLConfig(population=STORE_POPULATIONS[0],
                    rounds=STORE_RUNG_ROUNDS, **STORE_RUNG)
    params = initial_params(task, cfg0, None, "cuda")
    engine = make_round_engine(task, cfg0, params, device="cuda",
                               method=meth)
    steps = cfg0.local_epochs * cfg0.steps_per_epoch

    def rung(n_pop):
        """Set-up and warm round, then the timed rounds: (set-up s,
        timed s)."""
        t_set = time.perf_counter()
        fl = FLConfig(population=n_pop, rounds=STORE_RUNG_ROUNDS,
                      **STORE_RUNG)
        pop = Population.from_parts(statestore.ShardIndices.striped(
            len(ds.labels), n_pop))
        pop.use_store(statestore.get("mmap", chunk_size=fl.chunk_size))
        try:
            gp = engine.layout.flatten(params)
            state = [engine.init_server_state(gp), gp]
            pop.initialize(engine.init_client_row(gp), engine.layout)
            rng = np.random.default_rng(0)

            def one_round(r):
                ids = smp.sample(r, n_pop, fl.cohort_size, rng,
                                 weights=pop.weights)
                state[:] = run_sampled_round(
                    engine, pop, meth, state[0], state[1], ids, get_batch,
                    steps, fl, rng, uniform_weights=True, round_idx=r)

            one_round(0)
            torch.cuda.synchronize()
            set_up = time.perf_counter() - t_set

            def timed():
                t0 = time.perf_counter()
                for r in range(1, STORE_RUNG_ROUNDS + 1):
                    one_round(r)
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            dt, _ = counted(f"population {n_pop:,}", timed,
                            {"paired_fusion": STORE_RUNG_ROUNDS})
            assert bool(torch.isfinite(state[1]).all()), "non-finite global"
        finally:
            pop.store.close()
        return set_up, dt

    for n_pop in STORE_POPULATIONS:
        with rss_peak() as rss:
            set_up, dt = rung(n_pop)
        print(f"  population {n_pop:,}: {dt / STORE_RUNG_ROUNDS:.4f} "
              f"s/round over {STORE_RUNG_ROUNDS} rounds (set-up and warm "
              f"round {set_up:.2f} s); RSS {rss['start']:.0f} -> "
              f"{rss['end']:.0f} MB, peak {rss['peak']:.0f} MB "
              f"(+{rss['peak'] - rss['start']:.0f} MB over the rung, "
              f"sampled every 5 ms)", flush=True)


def phase_store():
    phase_store_cli()
    phase_store_resume()
    phase_store_population()


def free_device_memory():
    gc.collect()
    torch.cuda.empty_cache()


def serve_cli(*extra):
    """The serving CLI (``python -m repro_torch.launch.serve``) with the
    reference's defaults plus ``extra``; checks its output and prints
    its times, peak device memory and parameter count."""
    from repro_torch.launch import serve
    argv = list(extra)
    print("  python -m repro_torch.launch.serve", " ".join(argv), flush=True)
    args = serve.parse_args(argv)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(argv)
    peak = torch.cuda.max_memory_allocated()
    toks, logits = out["tokens"], out["logits"]
    cfg = serve.config_of(args)
    assert toks.shape == (args.batch, args.gen), toks.shape
    assert ((toks >= 0) & (toks < cfg.vocab)).all(), "token out of range"
    assert logits.shape == (args.batch, 1, cfg.vocab) and logits.is_cuda
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    want = SERVE_PARAMS[args.arch, args.fed2_groups]
    print(f"  -> prefill {args.prompt_len} tok x {args.batch} in "
          f"{out['prefill_s']:.3f} s ({args.prompt_len * args.batch / out['prefill_s']:.1f} tok/s), "
          f"decode {args.gen} tok x {args.batch} in {out['decode_s']:.3f} s "
          f"({out['tok_s']:.1f} tok/s); peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; {out['param_count']:,} parameters "
          f"(reference: {want:,})", flush=True)
    assert out["param_count"] == want, "parameter count differs from the " \
        "reference's"
    del out
    free_device_memory()
    return peak


def phase_serve() -> dict:
    """Returns the launch counts of the run that takes both kernels."""
    from repro_torch.launch import serve
    d = serve.parse_args([])
    steps = d.prompt_len + d.gen
    ssd = SERVE_LAYERS * steps
    arch = ("--arch", "mamba2-1.3b")
    counted("serve --arch mamba2-1.3b --full",
            lambda: serve_cli(*arch, "--full"), {"ssd_update": ssd})
    _, counts = counted(
        "serve --arch mamba2-1.3b --full --fed2-groups 8",
        lambda: serve_cli(*arch, "--full", "--fed2-groups", "8"),
        {"ssd_update": ssd, "grouped_matmul": steps}, {"stream": steps})
    peak, _ = counted(
        "serve --arch mamba2-1.3b --full --fed2-groups 8 --batch 128 "
        "(decode_32k's batch)",
        lambda: serve_cli(*arch, "--full", "--fed2-groups", "8", "--batch",
                          "128", "--prompt-len", "2", "--gen", "2"),
        {"ssd_update": SERVE_LAYERS * 4, "grouped_matmul": 4}, {"wgmma": 4})
    state = SERVE_LAYERS * 128 * 64 * 64 * 128 * 4
    print(f"  SSM state at batch 128: {state / 1e9:.1f} GB; peak "
          f"{peak / 1e9:.1f} GB", flush=True)
    assert peak > state, "the batch-128 run did not hold its SSM state"
    return counts


def phase_serve_profile():
    """A Fed2 serve at full width (batch 4, 8 prompt + 8 decoded tokens)
    under torch.profiler: device busy share of the wall time and device
    time by kernel category."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import transformer as tfm
    cfg = with_fed2(get_config("mamba2-1.3b"), groups=8)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    kw = dict(batch=4, prompt_len=8, gen=8, device="cuda",
              init_params=params)
    run_serve(cfg, **kw)                                    # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = run_serve(cfg, **kw)
        wall = time.time() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    total_us = sum(e.self_device_time_total for e in dev)
    steps = kw["prompt_len"] + kw["gen"]
    print(f"  {steps} serve steps: wall {wall * 1e3:.1f} ms "
          f"({wall * 1e3 / steps:.2f} ms/step; decode {out['tok_s']:.1f} "
          f"tok/s), device busy {total_us / 1e3:.1f} ms "
          f"({100 * total_us / 1e3 / wall / 1e3:.1f} %), "
          f"{sum(e.count for e in dev)} device ops")
    if not dev:
        print("  device time: not measured (the profiler saw no device "
              "events)")
        return
    by_cat = {}
    for e in dev:
        c = _category(e.key)
        by_cat[c] = by_cat.get(c, 0.0) + e.self_device_time_total
    for c, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {c:<48s} {us / 1e3:8.2f} ms  {100 * us / total_us:5.1f} %")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} "
              f"{e.key[:90]}")


def phase_decode_parity():
    """The full mamba2-1.3b with Fed2 (groups 8) in fp32, TF32 off: 8
    tokens through decode_step with the kernels and with the plain
    versions, from one init and two zeroed caches. The plain route must
    launch no kernel; logits (every step) and the final cache must agree
    within PARITY_LOGIT_ATOL and PARITY_STATE_RTOL (of each cache
    leaf's largest value)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import decode_step, init_cache
    cfg = with_fed2(get_config("mamba2-1.3b", dtype=torch.float32), groups=8)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(1),
                             cfg)
    bs, steps = 4, 8
    toks = torch.randint(0, cfg.vocab, (bs, steps), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2))

    def run(use_kernel):
        cache = init_cache(cfg, bs, 128, device="cuda")
        logits = [decode_step(params, cfg, cache, toks[:, t:t + 1], t,
                              use_kernel=use_kernel)[0]
                  for t in range(steps)]
        return logits, cache

    (on, c_on), _ = counted(
        "decode parity, kernels", lambda: run(True),
        {"ssd_update": SERVE_LAYERS * steps, "grouped_matmul": steps},
        {"stream": steps})
    (off, c_off), _ = counted("decode parity, plain versions",
                              lambda: run(False), {})
    err_logits = max((a - b).abs().max().item() for a, b in zip(on, off))
    mag = max(b.abs().max().item() for b in off)
    errs = {k: (c_on["blocks"][k] - c_off["blocks"][k]).abs().max().item()
            for k in ("ssm", "conv")}
    lims = {k: PARITY_STATE_RTOL * c_off["blocks"][k].abs().max().item()
            for k in ("ssm", "conv")}
    ok = err_logits <= PARITY_LOGIT_ATOL and all(errs[k] <= lims[k]
                                                 for k in errs)
    print(f"  {steps} tokens, batch {bs}, fp32: max |dlogits| "
          f"{err_logits:.3g} (limit {PARITY_LOGIT_ATOL:g}; max |logit| "
          f"{mag:.3g}); final cache max |dh| {errs['ssm']:.3g} (limit "
          f"{lims['ssm']:.3g}), max |dconv| {errs['conv']:.3g} (limit "
          f"{lims['conv']:.3g}) {'ok' if ok else 'FAIL'}", flush=True)
    assert ok, "decode with the kernels drifts from the plain versions"


def lm_cli(flags, *extra):
    """``python -m repro_torch.launch.train`` with ``flags`` (LM_TRAIN or
    DENSE_LM_TRAIN: --mode lm at full width) plus ``extra``: losses
    finite and falling; prints the step times, tokens/s and peak device
    memory."""
    from repro_torch.launch import train
    argv = [*flags, "--steps", str(LM_TRAIN_STEPS), *extra]
    print("  python -m repro_torch.launch.train", " ".join(argv), flush=True)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    out = train.main(argv)
    peak = torch.cuda.max_memory_allocated()
    loss, w = out["loss"], out["wall"]
    assert all(math.isfinite(x) for x in loss), f"non-finite loss {loss}"
    assert loss[-1] < loss[0], f"the loss did not fall: {loss}"
    later = (w[-1] - w[0]) / (len(w) - 1)
    print(f"  -> losses {[round(x, 4) for x in loss]}; first step "
          f"{w[0]:.3f} s, later steps {later:.3f} s each "
          f"({out['tokens_per_step'] / later:.0f} tokens/s); peak device "
          f"memory {peak / 2 ** 30:.2f} GiB", flush=True)
    finite_params({"final_params": out["final_params"]})
    return out


def phase_lm_train(flags=LM_TRAIN):
    """--mode lm at full width and depth (``flags``: LM_TRAIN, Mamba-2,
    or DENSE_LM_TRAIN, Llama-3.2-1B), with and without --microbatches 2,
    counted: no kernel launches (every training route takes the einsum
    unembedding and, for the dense LM, the einsum decoupled FFNs). Then
    the eval and prefill steps on the trained params, counted:
    grouped_matmul once per loss chunk (2, the wgmma route), and the
    eval loss against the einsum route."""
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.data.synthetic import (lm_batch_from_tokens,
                                            make_token_dataset)
    from repro_torch.launch.steps import (make_eval_step,
                                          make_prefill_loss_step)
    from repro_torch.models.forward import lm_loss
    arch = flags[flags.index("--arch") + 1]
    out, _ = counted(f"--mode lm --arch {arch}", lambda: lm_cli(flags), {})
    del out
    out, _ = counted(f"--mode lm --arch {arch} --microbatches 2",
                     lambda: lm_cli(flags, "--microbatches", "2"), {})
    params = out.pop("final_params")
    cfg = with_fed2(get_config(arch), groups=8)
    toks, _ = make_token_dataset(8, 1025, cfg.vocab, seed=1)
    batch = lm_batch_from_tokens(toks, device="cuda")
    losses = {}
    for name, make in (("eval step", make_eval_step),
                       ("prefill step", make_prefill_loss_step)):
        step = make(cfg)
        t0 = time.time()
        loss, _ = counted(f"{name}, batch 8 x 1024",
                          lambda: step(params, batch).item(),
                          {"grouped_matmul": 2}, {"wgmma": 2})
        losses[name] = loss
        print(f"  -> {name} loss {loss:.4f} in {time.time() - t0:.3f} s")
    with torch.no_grad():
        plain = lm_loss(params, cfg, batch).item()
    err = abs(losses["eval step"] - plain)
    print(f"  eval loss, grouped_matmul vs einsum route: "
          f"{losses['eval step']:.5f} vs {plain:.5f}, |d| {err:.3g} (tol "
          f"{LM_EVAL_ROUTES_TOL:g}) "
          f"{'ok' if err <= LM_EVAL_ROUTES_TOL else 'FAIL'}", flush=True)
    assert err <= LM_EVAL_ROUTES_TOL, "the eval step's kernel route drifts"
    assert abs(losses["prefill step"] - losses["eval step"]) <= 1e-6
    del params, out
    free_device_memory()


def mamba_fl_config():
    """The full-width Mamba-2 cut to LM_FL_LAYERS layers in fp32, Fed2
    over 4 vocab clusters."""
    import dataclasses

    from repro_torch.configs import mamba2_1_3b
    from repro_torch.configs.common import with_fed2
    return with_fed2(dataclasses.replace(
        mamba2_1_3b.full(dtype=torch.float32), n_layers=LM_FL_LAYERS),
        groups=4)


def dense_fl_config():
    """The full-width Llama-3.2-1B in fp32 under with_fed2(groups=4),
    cut to DENSE_FL_LAYERS layers keeping its 4 decoupled blocks."""
    import dataclasses

    from repro_torch.configs import llama3_2_1b
    from repro_torch.configs.common import with_fed2
    return with_fed2(dataclasses.replace(
        llama3_2_1b.full(dtype=torch.float32), n_layers=DENSE_FL_LAYERS),
        groups=4, decouple=DENSE_GBLOCKS)


def lm_fl_inputs(cfg):
    """The LM federation's data and init (LM_FL) for model ``cfg``: 4
    clients, one token domain each; 64 held-out sequences of the same
    bigram tables; the weights drawn on the card. Returns (cfg, parts,
    get_batch, test_batches, init)."""
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.models import transformer as tfm
    n_dom, n_train, n_test = LM_FL["population"], 800, 64
    toks, domains = make_token_dataset(n_train + n_test, LM_FL_SEQ + 1,
                                       cfg.vocab, n_domains=n_dom, seed=0)
    test = toks[n_train:]
    parts = [np.flatnonzero(domains[:n_train] == j) for j in range(n_dom)]

    def get_batch(sel):
        sl = toks[sel]
        return {"tokens": sl[:, :-1], "labels": sl[:, 1:],
                "mask": np.ones((len(sel), LM_FL_SEQ), np.float32)}

    test_batches = [{"tokens": test[:, :-1], "labels": test[:, 1:],
                     "mask": np.ones((n_test, LM_FL_SEQ), np.float32)}]
    init = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    return cfg, parts, get_batch, test_batches, init


def lm_held_out_loss(cfg, test_batches):
    """params -> make_eval_step's loss on the held-out batch (no grad;
    the Fed2 unembedding through grouped_matmul)."""
    from repro_torch.launch.steps import make_eval_step
    b = test_batches[0]
    batch = {"tokens": torch.as_tensor(b["tokens"], dtype=torch.long,
                                       device="cuda"),
             "labels": torch.as_tensor(b["labels"], dtype=torch.long,
                                       device="cuda"),
             "mask": torch.as_tensor(b["mask"], device="cuda")}
    step = make_eval_step(cfg)
    return lambda params: step(params, batch).item()


def lm_cohort_kernels(init):
    """paired_fusion and local_step on the LM federation's (4, M) fp32
    cohort buffer (LM_FL's model: 7 GB a buffer, the engine's row
    stride), each against its plain version (1e-5 and 1e-6, the check
    phase's), with device times beside the bound and the library call.
    One call moves gigabytes, so the times are CUDA events around eager
    calls: a wrapper's ~30 us of host time is under 1 % of one."""
    from repro_torch.kernels.local_step import local_step, local_step_ref
    from repro_torch.kernels.paired_fusion import (paired_fusion,
                                                   paired_fusion_ref)
    from repro_torch.models.module import FlatLayout
    layout = FlatLayout(init)
    gen = torch.Generator(device="cuda").manual_seed(7)
    n, m, esz, lr, mu = LM_FL["population"], layout.size, 4, 0.01, 0.9
    x = cohort(layout, n, torch.float32, gen)
    w = torch.rand(n, generator=gen, device="cuda") + 0.1
    w = w / w.sum()
    err = check(f"paired_fusion LM cohort ({n}, {m})", paired_fusion(x, w),
                paired_fusion_ref(x, w), 1e-5)
    t = {"ms": event_ms(lambda: paired_fusion(x, w), 5),
         "plain_ms": event_ms(lambda: paired_fusion_ref(x, w), 3),
         "library_ms": event_ms(lambda: torch.mv(x.t(), w), 5)}
    t["bound_ms"], t["bound_by"] = bound(n * m * esz + m * esz + n * 4,
                                         2 * n * m)
    out = {"paired_fusion": {**t, "max_abs_err": err}}
    del x
    free_device_memory()
    p, v, g = (cohort(layout, n, torch.float32, gen, sc)
               for sc in (1.0, 0.1, 1.0))
    wp, wv = local_step_ref(p, v, g, lr, mu)
    local_step(p, v, g, lr=lr, mu=mu)
    err = max(check(f"local_step LM cohort ({n}, {m}) p", p, wp, 1e-6),
              check(f"local_step LM cohort ({n}, {m}) v", v, wv, 1e-6))
    del wp, wv
    free_device_memory()
    t = {"ms": event_ms(lambda: local_step(p, v, g, lr=lr, mu=mu), 5),
         "plain_ms": event_ms(lambda: local_step_ref(p, v, g, lr, mu), 3)}
    dense = [a.contiguous() for a in (p, v, g)]
    del p, v, g
    t["library_ms"] = event_ms(lambda: torch._fused_sgd_(
        [dense[0]], [dense[2]], [dense[1]], weight_decay=0.0, momentum=mu,
        lr=lr, dampening=0.0, nesterov=False, maximize=False,
        is_first_step=False), 5)
    t["bound_ms"], t["bound_by"] = bound(5 * n * m * esz, 4 * n * m)
    out["local_step"] = {**t, "max_abs_err": err}
    del dense
    free_device_memory()
    for name, r in out.items():
        print(f"  {name} LM cohort ({n}, {m}) fp32: {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms, library "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']})", flush=True)
    return out


def phase_lm_fl():
    """run_federated(lm_task) on the Mamba-2 at full width (LM_FL): the
    kernels on its (4, M) cohort buffer, the counted runs
    (``lm_fl_runs``) and the round's parity checks
    (``phase_lm_fl_parity``)."""
    from repro_torch.fl.runtime import lm_task
    cfg, parts, get_batch, test, init = lm_fl_inputs(mamba_fl_config())
    lm_fl_header(cfg, init, SERVE_LAYERS)
    with tf32_off():
        lm_cohort_kernels(init)
    task = lm_task(cfg)
    loss_of = lm_held_out_loss(cfg, test)
    losses = lm_fl_runs(task, parts, get_batch, test, init, loss_of)
    with tf32_off():
        phase_lm_fl_parity(cfg, task, parts, get_batch, test, init,
                           (losses["init"], losses["lm_task fed2"]), loss_of)


def lm_fl_header(cfg, init, depth):
    from repro_torch.models.module import param_count
    n = param_count(init)
    print(f"  {cfg.arch_id}, {cfg.n_layers} of {depth} layers "
          f"({cfg.fed2_decouple} decoupled), fp32, Fed2 over "
          f"{cfg.fed2_groups} groups: {n:,} parameters, a flat row "
          f"{4 * n / 1e9:.2f} GB", flush=True)


def lm_fl_runs(task, parts, get_batch, test, init, loss_of) -> dict:
    """run_federated(lm_task) for LM_FL's 2 rounds, fedavg and fed2,
    with and without --use-local-kernel, counted: paired_fusion once a
    round, local_step once a local step with the flag, grouped_matmul
    once a round (the eval's Fed2 unembedding, simt: fp32 at M = 64 x
    64). Each run must move every leaf and bring the held-out loss below
    the init's. Returns the held-out losses by run ("init" too)."""
    from repro_torch.fl.runtime import FLConfig, run_federated
    from repro_torch.models.module import tree_leaves
    losses = {"init": loss_of(init)}
    print(f"  held-out loss at the init {losses['init']:.5f}", flush=True)
    rounds, steps = LM_FL["rounds"], LM_FL["steps_per_epoch"]
    for method in ("fedavg", "fed2"):
        for flag in (False, True):
            fl = FLConfig(method=method, **LM_FL)
            label = f"lm_task {method}{' --use-local-kernel' if flag else ''}"
            h, _ = counted(
                label,
                lambda: run_federated(task, fl, parts, get_batch, test,
                                      use_local_kernel=flag, device="cuda",
                                      init_params=init),
                {"paired_fusion": rounds, "grouped_matmul": rounds,
                 "local_step": rounds * steps if flag else 0},
                {"simt": rounds})
            finite_params(h)
            w = h["wall"]
            per = [w[0]] + [b - a for a, b in zip(w, w[1:])]
            moved = min((a - b).abs().max().item() for a, b in zip(
                tree_leaves(h["final_params"]), tree_leaves(init)))
            loss = losses[label] = loss_of(h["final_params"])
            print(f"  -> s/round {[round(x, 3) for x in per]}; next-token "
                  f"acc per round {[round(a, 4) for a in h['acc']]}; "
                  f"held-out loss {losses['init']:.5f} -> {loss:.5f}; the "
                  f"least-moved leaf moved {moved:.3g}", flush=True)
            assert moved > 0, f"{label}: a leaf did not move"
            assert loss < losses["init"], \
                f"{label}: the held-out loss did not fall"
            del h
            free_device_memory()
    return losses


class LmKernelTaps:
    """Every local_step and paired_fusion call of a run held against the
    plain version on that call's own inputs, leaf by leaf of the flat
    layout and element by element, within an fp32 round-off bound
    (eps = 2^-23; each route rounds every operation once, the kernel's
    perhaps fused): for local_step |dv'| <= 2 eps (|mu v| + |g|) and
    |dp'| <= 2 eps (|p| + 2 lr (|mu v| + |g|)); for an N-row fusion
    |d| <= N eps sum_n w_n |x_n|. The run calls the kernels as it would
    untapped (the plain versions work on copies), so no round-off
    carries from one call into the next comparison. ``fault`` plants a
    defect in the kernel route, to show that the bound catches it.
    ``worst[(kernel, leaf)]``: the largest |kernel - plain| / bound."""

    FAULTS = ("local_step without momentum",
              "paired_fusion with weight 0 0.1 % high")

    def __init__(self, layout, paths, fault=None):
        self.slots = [(path, s.offset, s.offset + s.size)
                      for path, s in zip(paths, layout.slots)]
        self.m, self.fault, self.worst = layout.size, fault, {}
        self.calls = {"local_step": 0, "paired_fusion": 0}

    def __enter__(self):
        from repro_torch.core import fusion
        from repro_torch.fl import methods
        self._saved = (methods.local_step, fusion.paired_fusion)
        methods.local_step = self.local_step
        fusion.paired_fusion = self.paired_fusion
        return self

    def __exit__(self, *exc):
        from repro_torch.core import fusion
        from repro_torch.fl import methods
        methods.local_step, fusion.paired_fusion = self._saved

    def _note(self, kernel, path, err, tol):
        r = torch.where(err == 0, 0.0, err / tol).max().item()
        self.worst[kernel, path] = max(self.worst.get((kernel, path), 0.0),
                                       r)

    def local_step(self, p, v, g, *, lr, mu):
        from repro_torch.kernels.local_step import local_step, local_step_ref
        p0, v0 = p.clone(), v.clone()
        local_step(p, v, g, lr=lr,
                   mu=0.0 if self.fault == self.FAULTS[0] else mu)
        eps = torch.finfo(torch.float32).eps
        for path, lo, hi in self.slots:
            c = slice(lo, hi)
            wp, wv = local_step_ref(p0[:, c], v0[:, c], g[:, c], lr, mu)
            mag = mu * v0[:, c].abs() + g[:, c].abs()
            self._note("local_step", path, (v[:, c] - wv).abs(),
                       2 * eps * mag)
            self._note("local_step", path, (p[:, c] - wp).abs(),
                       2 * eps * (p0[:, c].abs() + 2 * lr * mag))
            del wp, wv, mag
        self.calls["local_step"] += 1
        return p, v

    def paired_fusion(self, x, w, out=None):
        from repro_torch.kernels.paired_fusion import (paired_fusion,
                                                       paired_fusion_ref)
        assert x.shape[1] == self.m, "the LM round fuses in one call"
        wk = w
        if self.fault == self.FAULTS[1]:
            wk = w.clone()
            wk[0] *= 1.001
        res = paired_fusion(x, wk, out=out)
        eps = torch.finfo(torch.float32).eps
        for path, lo, hi in self.slots:
            c = slice(lo, hi)
            self._note("paired_fusion", path,
                       (res[c] - paired_fusion_ref(x[:, c], w)).abs(),
                       x.shape[0] * eps * (x[:, c].abs() * w[:, None]).sum(0))
        self.calls["paired_fusion"] += 1
        return res

    def report(self, label, kernels=("local_step", "paired_fusion")):
        """Prints, per kernel, its calls and its worst leaf; returns the
        worst ratio of each kernel."""
        out = {}
        for k in kernels:
            (r, path) = max((r, p) for (kk, p), r in self.worst.items()
                            if kk == k)
            out[k] = r
            print(f"  {label}: {k} x {self.calls[k]}, worst |kernel - "
                  f"plain| {r:.3g} of its round-off bound (at {path})",
                  flush=True)
        return out


def lm_sharpness(loss_fn, init, batch, iters: int):
    """``loss_fn``'s sharpest direction at ``init`` on one batch:
    power iteration on Hessian-vector products (double backward,
    plain autograd). Returns (Rayleigh quotient, [(leaf, share of the
    vector's squared norm)] largest first)."""
    from repro_torch.models.module import (tree_leaves,
                                           tree_leaves_with_path,
                                           tree_unflatten)
    paths = [p for p, _ in tree_leaves_with_path(init)]
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(init)]
    grads = torch.autograd.grad(
        loss_fn(tree_unflatten(init, leaves), batch), leaves,
        create_graph=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    v = [torch.randn(t.shape, generator=gen, device="cuda") for t in leaves]
    lam = 0.0
    for _ in range(iters):
        norm = math.sqrt(sum((x * x).sum().item() for x in v))
        v = [x / norm for x in v]
        hv = torch.autograd.grad(grads, leaves, grad_outputs=v,
                                 retain_graph=True)
        lam = sum((a * b).sum().item() for a, b in zip(hv, v))
        v = list(hv)
    norm2 = sum((x * x).sum().item() for x in v)
    shares = sorted(((p, (x * x).sum().item() / norm2)
                     for p, x in zip(paths, v)), key=lambda t: -t[1])
    return lam, shares


def phase_lm_fl_parity(cfg, task, parts, get_batch, test, init, losses,
                       loss_of):
    """One fed2 LM round (TF32 off) from one init:

    - the kernels on the round's own inputs (``LmKernelTaps``): every
      call within its round-off bound; the same check must fail on each
      planted fault;
    - the whole round, kernels vs plain, against what round-off in its
      inputs does: a second plain run, and the plain route from the
      init moved by one ulp. The round is chaotic (the sharpness below:
      momentum SGD at lr 0.01 is unstable along the embedding table and
      w_xbc), so this coarse limit is only a guard; the taps are the
      check. Readings per leaf, and the one-ulp readings again with the
      embedding table scaled to unit RMS (the first block's norm then
      sees the same input, its curvature along the table is d times
      smaller);
    - the held-out loss falls round by round: init, this round, the
      2-round fed2 run (``losses``)."""
    import dataclasses

    from repro_torch.fl.runtime import FLConfig, run_federated
    from repro_torch.models.forward import lm_loss
    from repro_torch.models.module import (FlatLayout, tree_leaves,
                                           tree_leaves_with_path, tree_map,
                                           tree_unflatten)
    fl = FLConfig(method="fed2", **{**LM_FL, "rounds": 1})
    layout = FlatLayout(init)
    paths = [p for p, _ in tree_leaves_with_path(init)]

    def one_round(start, kernels):
        h = run_federated(task, fl, parts, get_batch, test,
                          use_kernel=kernels, use_local_kernel=kernels,
                          device="cuda", init_params=start)
        return [t.clone() for t in tree_leaves(h["final_params"])]

    def plus_ulp(tree):
        return tree_map(lambda t: torch.nextafter(
            t, torch.full_like(t, math.inf)), tree)

    out = {}
    with LmKernelTaps(layout, paths) as taps:
        out["kernels"] = one_round(init, True)
    worst = taps.report("kernels on the round's own inputs")
    assert taps.calls == {"local_step": LM_FL["steps_per_epoch"],
                          "paired_fusion": 1}, taps.calls
    assert max(worst.values()) <= 1.0, \
        "a kernel call of the LM round exceeds its round-off bound"
    for fault, kernel in zip(LmKernelTaps.FAULTS,
                             ("local_step", "paired_fusion")):
        with LmKernelTaps(layout, paths, fault) as taps:
            one_round(init, True)
        r = taps.report(f"planted fault, {fault}", (kernel,))[kernel]
        print(f"  planted fault: {fault}: "
              f"{'caught' if r > 1.0 else 'MISSED'}", flush=True)
        assert r > 1.0, f"the taps miss a planted fault: {fault}"
    free_device_memory()
    out["plain"] = one_round(init, False)
    out["plain again"] = one_round(init, False)
    out["plain, init + 1 ulp"] = one_round(plus_ulp(init), False)
    upd = [(a - b).abs().max().item()
           for a, b in zip(out["plain"], tree_leaves(init))]
    d = {label: [(a - b).abs().max().item()
                 for a, b in zip(out[label], out["plain"])]
         for label in ("kernels", "plain again", "plain, init + 1 ulp")}
    print("  one fed2 LM round, max |dparam| against the plain route, per "
          "leaf (its update beside it):")
    print(f"    {'leaf':<40s} {'update':>9s} {'kernels':>9s} {'again':>9s} "
          f"{'1 ulp':>9s}")
    for i, path in enumerate(paths):
        print(f"    {path:<40s} {upd[i]:9.3g} {d['kernels'][i]:9.3g} "
              f"{d['plain again'][i]:9.3g} "
              f"{d['plain, init + 1 ulp'][i]:9.3g}")
    lim = max(max(d["plain again"]), max(d["plain, init + 1 ulp"]))
    ok = max(d["kernels"]) <= lim
    print(f"  the round's largest update {max(upd):.3g}; kernels "
          f"{max(d['kernels']):.3g} (limit {lim:.3g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    assert ok, "the LM round's kernel routes drift from the plain routes " \
        "beyond round-off in its inputs"
    l0, l2 = losses
    l1 = loss_of(tree_unflatten(init, out["plain"]))
    print(f"  held-out loss, fed2: init {l0:.5f}, round 1 {l1:.5f}, round 2 "
          f"{l2:.5f}", flush=True)
    assert l0 > l1 > l2, "the held-out loss does not fall round by round"
    del out
    free_device_memory()
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in get_batch(parts[0][:LM_FL["batch_size"]]).items()}
    batch["tokens"], batch["labels"] = (batch["tokens"].long(),
                                        batch["labels"].long())
    no_remat = dataclasses.replace(cfg, remat_blocks=False)
    lam, shares = lm_sharpness(lambda p, b: lm_loss(p, no_remat, b), init,
                               batch, LM_SHARPNESS_ITERS)
    lr, mu = LM_FL["lr"], LM_FL["momentum"]
    print(f"  sharpest direction at the init (client 0's first batch, "
          f"{LM_SHARPNESS_ITERS} power iterations): curvature {lam:.4g}, "
          f"lr x |curvature| {lr * abs(lam):.3g} against momentum SGD's "
          f"stability limit 2 (1 + mu) = {2 * (1 + mu):.3g}; its leaves "
          + ", ".join(f"{p} {s:.3f}" for p, s in shares[:3]), flush=True)
    free_device_memory()
    scale = math.sqrt(cfg.d_model)
    unit = tree_map(lambda t: t, init)
    unit["embed"] = {"table": init["embed"]["table"] * scale}
    base = one_round(unit, False)
    moved = one_round(plus_ulp(unit), False)
    du = [(a - b).abs().max().item() for a, b in zip(moved, base)]
    upd = [(a - b).abs().max().item()
           for a, b in zip(base, tree_leaves(unit))]
    i = max(range(len(du)), key=du.__getitem__)
    j = paths.index("['embed']/['table']")
    print(f"  the embedding table x {scale:.4g} (unit RMS): one fed2 LM "
          f"round, init + 1 ulp vs plain: max |dparam| {du[i]:.3g} (at "
          f"{paths[i]}), at the table {du[j]:.3g} of its update "
          f"{upd[j]:.3g}", flush=True)
    del base, moved, unit
    free_device_memory()


def phase_lm_crosscheck():
    """The full mamba2-1.3b with Fed2 (groups 8) in fp32, TF32 off: the
    chunked forward over L = CROSSCHECK_LEN tokens (ssd_chunked in every
    layer, no kernel) against L steps of decode_step (ssd_update in every
    layer, grouped_matmul's stream route), from one init: logits at
    every position within CROSSCHECK_LOGIT_ATOL, and each layer's SSM
    state after the last token within CROSSCHECK_STATE_RTOL of its
    largest value."""
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import decode_step, forward, init_cache
    from repro_torch.models.layers import embed_apply
    from repro_torch.models.module import tree_map
    cfg = with_fed2(get_config("mamba2-1.3b", dtype=torch.float32), groups=8)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(1),
                             cfg)
    bs, n = 2, CROSSCHECK_LEN
    toks = torch.randint(0, cfg.vocab, (bs, n), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(3))

    @torch.no_grad()
    def chunked():
        h = forward(params, cfg, toks)
        logits = tfm.unembed_apply(params["unembed"], h, cfg,
                                   use_kernel=False)
        # forward's blocks again, one by one, keeping each SSM state
        x, states = embed_apply(params["embed"], toks), []
        for i in range(cfg.n_layers):
            lp = tree_map(lambda t: t[i], params["blocks"])
            y, st = ssm.mamba2_apply(
                lp["mixer"], tfm._norm_apply(cfg, lp["ln1"], x), cfg.ssm,
                with_state=True)
            x = x + y
            states.append(st)
        d = (tfm._norm_apply(cfg, params["final_norm"], x) - h).abs().max()
        assert d.item() <= 1e-5 * h.abs().max().item(), d
        return logits, torch.stack(states)

    @torch.no_grad()
    def decoded():
        cache = init_cache(cfg, bs, n, device="cuda")
        logits = [decode_step(params, cfg, cache, toks[:, t:t + 1], t)[0]
                  for t in range(n)]
        return torch.cat(logits, 1), cache

    t0 = time.time()
    (logits, states), _ = counted("chunked forward", chunked, {})
    t1 = time.time()
    (dlogits, cache), _ = counted(
        f"{n} decode steps", decoded,
        {"ssd_update": SERVE_LAYERS * n, "grouped_matmul": n}, {"stream": n})
    t2 = time.time()
    err_l = (dlogits - logits).abs().max().item()
    mag = logits.abs().max().item()
    rel = max(((cache["blocks"]["ssm"][i] - states[i]).abs().max()
               / states[i].abs().max()).item()
              for i in range(cfg.n_layers))
    ok = err_l <= CROSSCHECK_LOGIT_ATOL and rel <= CROSSCHECK_STATE_RTOL
    print(f"  batch {bs}, {n} tokens, fp32: chunked forward {t1 - t0:.2f} "
          f"s, decode {t2 - t1:.2f} s; max |dlogits| {err_l:.3g} (limit "
          f"{CROSSCHECK_LOGIT_ATOL:g}; max |logit| {mag:.3g}); SSM states, "
          f"worst layer {rel:.3g} of its largest value (limit "
          f"{CROSSCHECK_STATE_RTOL:g}) {'ok' if ok else 'FAIL'}", flush=True)
    assert ok, "the chunked forward and the ssd_update decode disagree"
    del params, cache, states
    free_device_memory()


def phase_lm_profile():
    """One --mode lm step at full width (LM_TRAIN's shapes, after a
    warm-up step), the same with --microbatches 2, and one fed2 LM round (LM_FL, with --use-local-kernel,
    after a warm-up run) under torch.profiler."""
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.data.synthetic import (lm_batch_from_tokens,
                                            make_token_dataset)
    from repro_torch.fl.runtime import FLConfig, lm_task, run_federated
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    cfg = with_fed2(get_config("mamba2-1.3b"), groups=8)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    step_fn, opt = make_train_step(cfg, lr=1e-3)
    state = opt.init(params)
    toks, _ = make_token_dataset(16, 1025, cfg.vocab, seed=0)
    b0, b1 = (lm_batch_from_tokens(toks[i:i + 8], device="cuda")
              for i in (0, 8))
    params, state, _ = step_fn(params, state, 0, b0)
    profiled("one --mode lm step, batch 8 x 1024",
             lambda: step_fn(params, state, 1, b1))
    step_mb2, _ = make_train_step(cfg, lr=1e-3, microbatches=2)
    params, state, _ = step_mb2(params, state, 1, b1)
    profiled("one --mode lm --microbatches 2 step, batch 8 x 1024",
             lambda: step_mb2(params, state, 2, b0))
    del params, state
    free_device_memory()
    cfg, parts, get_batch, test, init = lm_fl_inputs(mamba_fl_config())
    fl = FLConfig(method="fed2", **{**LM_FL, "rounds": 1})

    def one_round():
        run_federated(lm_task(cfg), fl, parts, get_batch, test,
                      use_local_kernel=True, device="cuda",
                      init_params=init)

    one_round()
    profiled("one fed2 LM round (4 clients x 4 steps, eval)", one_round)
    del init
    free_device_memory()


# ---------------------------------------------------------------------------
# the dense family (Llama-3.2-1B)
# ---------------------------------------------------------------------------


def phase_dense_serve():
    """Llama-3.2-1B at full width through the serving CLI's default arch
    (batch 4, 32 prompt + 16 decoded tokens), without and with
    --fed2-groups 8, then Fed2 at batch 128 over a 2048-slot KV cache
    (8.6 GB in bf16); counted, grouped_matmul by route: none without
    Fed2, DENSE_GMM_PER_STEP a step with it (stream at batch 4, wgmma at
    128), ssd_update never."""
    from repro_torch.launch import serve
    d = serve.parse_args([])
    assert d.arch == "llama3.2-1b", d.arch
    steps = d.prompt_len + d.gen
    gmm = DENSE_GMM_PER_STEP * steps
    counted("serve --full (llama3.2-1b)", lambda: serve_cli("--full"), {})
    counted("serve --full --fed2-groups 8 (llama3.2-1b)",
            lambda: serve_cli("--full", "--fed2-groups", "8"),
            {"grouped_matmul": gmm}, {"stream": gmm})
    b128 = serve.parse_args(list(DENSE_SERVE_BATCH128))
    gmm = DENSE_GMM_PER_STEP * (b128.prompt_len + b128.gen)
    peak, _ = counted(
        "serve --full --fed2-groups 8 " + " ".join(DENSE_SERVE_BATCH128),
        lambda: serve_cli("--full", "--fed2-groups", "8",
                          *DENSE_SERVE_BATCH128),
        {"grouped_matmul": gmm}, {"wgmma": gmm})
    print(f"  KV cache at batch 128 x 2048 slots: "
          f"{DENSE_KV_BYTES / 1e9:.2f} GB; peak {peak / 1e9:.2f} GB",
          flush=True)
    assert peak > DENSE_KV_BYTES, "the batch-128 run did not hold its cache"


def phase_dense_decode_parity():
    """The full llama3.2-1b with Fed2 in fp32 (TF32 off), from one init:

    - DENSE_PARITY_STEPS tokens through decode_step with the kernels
      (grouped_matmul's stream route in the unembedding and the 4
      decoupled FFNs) and with the plain versions (no launch): logits
      within PARITY_LOGIT_ATOL, the final KV caches within
      PARITY_STATE_RTOL of each leaf's largest value;
    - the chunked forward (DENSE_CROSSCHECK: q chunks of 128, kv chunks
      of 256) over CROSSCHECK_LEN tokens against that many decode steps:
      logits at every position within DENSE_CROSSCHECK_LOGIT_ATOL."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import decode_step, forward, init_cache
    cfg = with_fed2(get_config("llama3.2-1b", dtype=torch.float32), groups=8)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(1),
                             cfg)
    bs, steps = 4, DENSE_PARITY_STEPS
    toks = torch.randint(0, cfg.vocab, (bs, CROSSCHECK_LEN), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2))

    @torch.no_grad()
    def decoded(n, use_kernel, batch=bs):
        cache = init_cache(cfg, batch, n, device="cuda")
        logits = [decode_step(params, cfg, cache, toks[:batch, t:t + 1], t,
                              use_kernel=use_kernel)[0] for t in range(n)]
        return torch.cat(logits, 1), cache

    gmm = DENSE_GMM_PER_STEP * steps
    (on, c_on), _ = counted("dense decode parity, kernels",
                            lambda: decoded(steps, True),
                            {"grouped_matmul": gmm}, {"stream": gmm})
    (off, c_off), _ = counted("dense decode parity, plain versions",
                              lambda: decoded(steps, False), {})
    err = (on - off).abs().max().item()
    mag = off.abs().max().item()
    cache_err = max(
        ((c_on[st][k] - c_off[st][k]).abs().max()
         / c_off[st][k].abs().max()).item()
        for st in ("blocks", "gblocks") for k in ("k", "v"))
    ok = err <= PARITY_LOGIT_ATOL and cache_err <= PARITY_STATE_RTOL
    print(f"  {steps} tokens, batch {bs}, fp32: max |dlogits| {err:.3g} "
          f"(limit {PARITY_LOGIT_ATOL:g}; max |logit| {mag:.3g}); KV "
          f"caches, worst leaf {cache_err:.3g} of its largest value (limit "
          f"{PARITY_STATE_RTOL:g}) {'ok' if ok else 'FAIL'}", flush=True)
    assert ok, "dense decode with the kernels drifts from the plain versions"
    del on, off, c_on, c_off
    free_device_memory()

    n, bc = CROSSCHECK_LEN, 2
    ccfg = dataclasses.replace(cfg, **DENSE_CROSSCHECK)

    @torch.no_grad()
    def chunked():
        h = forward(params, ccfg, toks[:bc])
        return tfm.unembed_apply(params["unembed"], h, ccfg,
                                 use_kernel=False)

    t0 = time.time()
    want, _ = counted("dense chunked forward", chunked, {})
    t1 = time.time()
    gmm = DENSE_GMM_PER_STEP * n
    (got, _), _ = counted(f"dense: {n} decode steps",
                          lambda: decoded(n, True, bc),
                          {"grouped_matmul": gmm}, {"stream": gmm})
    t2 = time.time()
    err = (got - want).abs().max().item()
    mag = want.abs().max().item()
    ok = err <= DENSE_CROSSCHECK_LOGIT_ATOL
    print(f"  batch {bc}, {n} tokens, fp32, q/kv chunks "
          f"{ccfg.attn_q_chunk}/{ccfg.attn_kv_chunk}: chunked forward "
          f"{t1 - t0:.2f} s, decode {t2 - t1:.2f} s; max |dlogits| "
          f"{err:.3g} (limit {DENSE_CROSSCHECK_LOGIT_ATOL:g}; max |logit| "
          f"{mag:.3g}) {'ok' if ok else 'FAIL'}", flush=True)
    assert ok, "the dense chunked forward and the decode disagree"
    del params, got, want
    free_device_memory()


def attention_yardstick():
    """The port's chunked attention (forward, no grad) at the training
    shape against F.scaled_dot_product_attention on the same q, k, v
    (the library yardstick; not a route of the port): each one's device
    time (CUDA events around eager calls) beside the bound, and their
    outputs within ATTN_SDPA_ATOL."""
    import torch.nn.functional as F

    from repro_torch.models.attention import chunked_attention
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, s, hq, hkv, d = 8, 1024, 32, 8, 64
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    pos = torch.arange(s, device="cuda")

    def ours():
        return chunked_attention(q, k, v, q_positions=pos, kv_positions=pos,
                                 causal=True, q_chunk=512, kv_chunk=1024)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        err = (ours().float() - sdpa().transpose(1, 2).float()).abs().max()
        err = err.item()
        t = {"ms": event_ms(ours, 5), "library_ms": event_ms(sdpa, 20)}
    t["bound_ms"], t["bound_by"] = bound(
        2 * b * s * d * (2 * hq + 2 * hkv), 2 * b * hq * s * s * d,
        BF16_FLOPS)
    print(f"  chunked attention, batch {b} x {s}, {hq} heads / {hkv} KV, "
          f"head_dim {d}, bf16, causal: {t['ms'] * 1e3:.1f} us, "
          f"F.scaled_dot_product_attention {t['library_ms'] * 1e3:.1f} us, "
          f"bound {t['bound_ms'] * 1e3:.1f} us ({t['bound_by']}); max "
          f"|d| {err:.3g} (tol {ATTN_SDPA_ATOL:g}) "
          f"{'ok' if err <= ATTN_SDPA_ATOL else 'FAIL'}", flush=True)
    assert err <= ATTN_SDPA_ATOL, "the chunked attention and SDPA disagree"
    del q, k, v, qt, kt, vt
    free_device_memory()


def phase_dense_lm_fl():
    """run_federated(lm_task) on the dense LM (dense_fl_config: fp32,
    Fed2 over 4 groups, 6 of 16 layers, 4 decoupled): the counted runs
    (``lm_fl_runs``: fedavg and fed2, with and without
    --use-local-kernel); then one fed2 round with the flag (TF32 off) in
    which every local_step and paired_fusion call is held against its
    plain version on that call's own inputs (``LmKernelTaps``), and the
    held-out loss after each fed2 round."""
    from repro_torch.fl.runtime import FLConfig, lm_task, run_federated
    from repro_torch.models.module import FlatLayout, tree_leaves_with_path
    cfg, parts, get_batch, test, init = lm_fl_inputs(dense_fl_config())
    lm_fl_header(cfg, init, DENSE_LAYERS)
    task = lm_task(cfg)
    loss_of = lm_held_out_loss(cfg, test)
    losses = lm_fl_runs(task, parts, get_batch, test, init, loss_of)
    layout = FlatLayout(init)
    paths = [p for p, _ in tree_leaves_with_path(init)]
    fl = FLConfig(method="fed2", **{**LM_FL, "rounds": 1})
    with tf32_off(), LmKernelTaps(layout, paths) as taps:
        h = run_federated(task, fl, parts, get_batch, test,
                          use_local_kernel=True, device="cuda",
                          init_params=init)
    worst = taps.report("dense LM round, kernels on the round's own inputs")
    assert taps.calls == {"local_step": LM_FL["steps_per_epoch"],
                          "paired_fusion": 1}, taps.calls
    assert max(worst.values()) <= 1.0, \
        "a kernel call of the dense LM round exceeds its round-off bound"
    l1 = loss_of(h["final_params"])
    print(f"  held-out loss, fed2 with the flag: init {losses['init']:.5f}, "
          f"round 1 {l1:.5f}, round 2 "
          f"{losses['lm_task fed2 --use-local-kernel']:.5f}", flush=True)
    del h, init
    free_device_memory()


def phase_dense_lm_profile():
    """One --mode lm step of the dense LM (DENSE_LM_TRAIN's shapes, after
    a warm-up step; the attention passes split out) and one fed2 round
    of its federation (LM_FL on dense_fl_config, with
    --use-local-kernel, after a warm-up run) under torch.profiler."""
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.data.synthetic import (lm_batch_from_tokens,
                                            make_token_dataset)
    from repro_torch.fl.runtime import FLConfig, lm_task, run_federated
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    cfg = with_fed2(get_config("llama3.2-1b"), groups=8)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    step_fn, opt = make_train_step(cfg, lr=1e-3)
    state = opt.init(params)
    toks, _ = make_token_dataset(16, 1025, cfg.vocab, seed=0)
    b0, b1 = (lm_batch_from_tokens(toks[i:i + 8], device="cuda")
              for i in (0, 8))
    params, state, _ = step_fn(params, state, 0, b0)
    profiled("one --mode lm --arch llama3.2-1b step, batch 8 x 1024",
             lambda: step_fn(params, state, 1, b1),
             (cfg.attn_q_chunk, cfg.attn_kv_chunk))
    del params, state
    free_device_memory()
    cfg, parts, get_batch, test, init = lm_fl_inputs(dense_fl_config())
    fl = FLConfig(method="fed2", **{**LM_FL, "rounds": 1})

    def one_round():
        run_federated(lm_task(cfg), fl, parts, get_batch, test,
                      use_local_kernel=True, device="cuda",
                      init_params=init)

    one_round()
    # the warm-up run's engine holds reference cycles (its buffers,
    # ~20 GB at this width) until a collection
    free_device_memory()
    # no attention split here: with record_shapes the profiled vmapped
    # round kept its memory until it ran out of the card's 80 GB (from
    # 2.1 GiB allocated at its start); its score tiles are 64 x 64
    profiled("one fed2 dense LM round (4 clients x 4 steps, eval)",
             one_round)
    del init
    free_device_memory()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    with phase("device"):
        smi = nvidia_smi()
        print(f"  {smi}")
        import triton
        import scipy
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"triton {triton.__version__}, scipy {scipy.__version__}, "
              f"{torch.cuda.get_device_name(0)} x "
              f"{torch.cuda.device_count()}")
    with phase("build"):
        phase_build()
    print("[kernels] paired_fusion (cuda: src/repro_torch/csrc/"
          "paired_fusion.cu), local_step (triton: src/repro_torch/kernels/"
          "local_step.py), feature_stats (cuda: src/repro_torch/csrc/"
          "feature_stats.cu), grouped_matmul (cuda: src/repro_torch/csrc/"
          "grouped_matmul.cu), ssd_update (cuda: src/repro_torch/csrc/"
          "ssd_update.cu)", flush=True)
    layout = main_layout()
    with phase("check (TF32 off)"), tf32_off():
        records = [phase_check_paired_fusion(layout),
                   phase_check_local_step(layout),
                   phase_check_feature_stats(),
                   phase_check_grouped_matmul(),
                   phase_check_ssd_update()]
        phase_check_group_axis()
        phase_check_tier_layouts()
        phase_check_event_fusion()
        for r in records + [{**records[1]["bf16"],
                             "name": "local_step bf16 (10, M)"}]:
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms'] * 1e3:.2f} us")
            print(f"  {r['name']}: {r['ms'] * 1e3:.2f} us, plain "
                  f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
                  f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    free_device_memory()
    with phase("main"):
        counts = phase_main()
    with phase("methods"):
        phase_methods()
    with phase("fednova parity (TF32 off, deterministic convs)"), \
            tf32_off(), deterministic_convs():
        phase_fednova_parity()
    with phase("samplers"):
        phase_samplers()
    with phase("auto_depth"):
        counts["feature_stats"] = phase_auto_depth()
    with phase("profile"):
        phase_profile()
    with phase("parity (TF32 off, deterministic convs)"), tf32_off(), \
            deterministic_convs():
        phase_parity()
    with phase("scenario"):
        recs = phase_scenario()
    with phase("axes"):
        phase_axes()
    with phase("axes parity (TF32 off, deterministic convs)"), \
            tf32_off(), deterministic_convs():
        phase_axes_parity()
    with phase("axes scenarios (deterministic convs)"), \
            deterministic_convs():
        phase_axes_scenarios(recs)
    with phase("tiers"):
        phase_tiers()
    with phase("tiers parity (TF32 off, deterministic convs)"), \
            tf32_off(), deterministic_convs():
        phase_tiers_parity()
    with phase("async"):
        phase_async()
    with phase("async parity (TF32 off, deterministic convs)"), \
            tf32_off(), deterministic_convs():
        phase_async_parity()
    with phase("tier and async scenarios"):
        phase_tier_async_scenarios()
    with phase("tier and async profile"):
        phase_tier_async_profile()
    free_device_memory()
    with phase("store (TF32 off, deterministic convs)"), tf32_off(), \
            deterministic_convs():
        phase_store()
    free_device_memory()
    with phase("serve"):
        serve_counts = phase_serve()
    counts["grouped_matmul"] = serve_counts["grouped_matmul"]
    counts["ssd_update"] = serve_counts["ssd_update"]
    with phase("serve profile"):
        phase_serve_profile()
    free_device_memory()
    with phase("decode parity (TF32 off)"), tf32_off():
        phase_decode_parity()
    free_device_memory()
    with phase("lm train"):
        phase_lm_train()
    with phase("lm federation"):
        phase_lm_fl()
    with phase("lm cross-check (TF32 off)"), tf32_off():
        phase_lm_crosscheck()
    with phase("lm profile"):
        phase_lm_profile()
    free_device_memory()
    with phase("dense serve"):
        phase_dense_serve()
    free_device_memory()
    with phase("dense decode parity (TF32 off)"), tf32_off():
        phase_dense_decode_parity()
    with phase("dense lm train"):
        attention_yardstick()
        phase_lm_train(DENSE_LM_TRAIN)
    free_device_memory()
    with phase("dense lm federation"):
        phase_dense_lm_fl()
    with phase("dense lm profile"):
        phase_dense_lm_profile()
    for r in records:
        r["launches"] = counts[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
