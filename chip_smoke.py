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
            unembedding, the other dense configs' and zamba2's
            unembeddings and decoupled FFN products at M = 4 and 128
            (stablelm 64), the MoE configs' Fed2 unembeddings (8, 768,
            4096) and (8, 640, 12800) at M = 4 and 128, Whisper's
            decoupled GELU FFN up (8, 64, 256) and down (8, 256, 64)
            with biases and InternVL's unembedding (8, 256, 11584) at M
            = 4 and 128 (bf16) and 4 (fp32), InternVL's eval chunks,
            the fp32 LM rounds' evals (M = 4096: Mamba-2, Llama,
            danube/zamba2, mixtral, deepseek; InternVL's M = 1024 chunk)
            on the sgemm route, every sgemm case held to the simt
            route's bits and those six timed beside it, and its refusal
            under autograd; ssd_update
            also at zamba2's (4 | 128, 80, 64, 64), on both of its
            routes (tma, scalar), each shape launched twice more for
            bit-equal repeats, with the timed shapes' plans);
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
10. (moved to tools/profile_phases.py: main)
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
21. (moved to tools/profile_phases.py: tiers_async)
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
24. (moved to tools/profile_phases.py: serve)
25. decode parity  the full config in fp32 (TF32 off), 8 tokens, with
            the kernels and with the plain versions: logits and the
            final cache within the stated limits
26. lm train  Mamba-2 1.3B training at full width and depth through the
            CLI (--mode lm --fed2 --fed2-groups 8, batch 8 x 1024
            tokens, bf16, AdamW with fp32 state, 3 steps), with and
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
            once a round (the eval's unembedding, sgemm); s/round and
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
            table at unit RMS. Then the bf16 Mamba-2 with its fp32
            a_log, dt_bias and d_skip (``phase_lm_fl_mixed``), and the
            round's axes on that tree at 12 layers
            (``phase_lm_fl_mixed_axes``): two rounds each of model
            poisoning, the robust rules, the int8 codec, the bf16 local
            phase on both routes, async and the mmap store, counted;
            the kernels at those shapes; a tapped bf16-shadow round and
            a planted fault; a 48-layer coordinate_median round and its
            peak memory
28. lm cross-check  the full config with Fed2 (groups 8) in fp32 (TF32
            off): the chunked forward over 300 tokens against 300
            decode steps through ssd_update: logits at every position
            and every layer's final SSM state within the stated limits
29. (moved to tools/profile_phases.py: lm)
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
34. (moved to tools/profile_phases.py: dense_lm)
35. other dense and hybrid serve  qwen2-7b, h2o-danube-1.8b,
            stablelm-12b and zamba2-2.7b at full width through the
            serving CLI (batch 4, 32 + 16 tokens), without and with
            --fed2-groups 8 (grouped_matmul 19 a dense step: the
            unembedding and 6 decoupled FFNs' three products; 1 a
            zamba2 step; stream route), then Fed2 at batch 128 over 2048
            slots (stablelm: 64; wgmma route); ssd_update 54 a zamba2
            step; counted, with tok/s, peak memory, the decode cache's
            bytes and the parameter counts, which must equal the
            reference's
36. other dense and hybrid decode parity  fp32, TF32 off: qwen2-7b and
            zamba2-2.7b with Fed2, 16 decode steps with the kernels
            against the plain versions (logits, every cache leaf);
            zamba2's chunked forward against 300 decode steps (logits
            and SSM states, the Mamba-2 limits); h2o-danube-1.8b at 2
            layers, its 4096 window kept, 4,400 tokens decoded into its
            ring buffer against the chunked forward
37. other dense and hybrid lm train  --mode lm --fed2 --fed2-groups 8
            (bf16, batch 8 x 1024, 3 steps) for danube and zamba2 at
            full depth through the CLI, and stablelm cut to 8 layers
            (its 6 decoupled blocks kept) through the CLI's step; no
            launch
38. other dense and hybrid lm federation  lm_task as in 27 (fedavg and
            fed2, with and without --use-local-kernel, counted) on
            zamba2 cut to 6 layers and danube cut to 8 (its 6 decoupled
            blocks kept)
39. (moved to tools/profile_phases.py: hybrid)
40. moe serve  mixtral-8x22b and deepseek-v2-236b: the full configs'
            parameter counts ± Fed2 8 (initialized on meta)
            equal to the reference's; then each cut to
            8 layers at full width (neither model fits one card; the
            cut's count is the reference's) through the serving
            function, batch 4 (32 + 16 tokens) ± Fed2 8 and Fed2 at
            batch 128 over 2048 slots, counted: grouped_matmul once a
            Fed2 step (stream at 4, wgmma at 128), nothing else; tok/s,
            the decode cache's bytes and peak memory
41. moe decode parity  fp32, TF32 off, each arch with Fed2 8 at 2
            layers: 16 decode steps with the kernels against the plain
            versions (logits, every cache leaf), and the chunked
            forward against 64 decode steps at capacity factor 16
42. moe lm train  the --mode lm step (bf16, batch 8 x 1024, Fed2 8):
            mixtral at 1 layer, deepseek at 3 layers with 16 of its 160
            routed experts, every other width kept; no launch; losses
            falling, the aux loss finite and non-zero
43. moe lm federation  lm_task as in 27 (fedavg and fed2, with and
            without --use-local-kernel, counted) on each arch with
            every routing parameter and MLA's dims kept, d_model, d_ff,
            vocab and depth cut to a 1.6-1.8 GB fp32 row
44. (moved to tools/profile_phases.py: moe)
45. encdec and vlm serve  whisper-base and internvl2-2b at full width
            and depth through the serving CLI (batch 4, 32 + 16 tokens),
            without and with --fed2-groups 8, then Fed2 at batch 128
            over 2048 slots, counted: grouped_matmul 2 (Whisper: its
            one decoupled block's GELU FFN) or 19 (InternVL: the
            unembedding and 6 decoupled FFNs) a Fed2 step, stream at 4
            and wgmma at 128, none without Fed2; Whisper against the
            zeroed cross cache and InternVL text only, as the
            reference's serve; tok/s, peak memory, the decode cache's
            bytes and the parameter counts, which must equal the
            reference's
46. encdec and vlm decode parity  fp32, TF32 off, Fed2 8: 16 decode
            steps of each with the kernels against the plain versions;
            Whisper's real serving path (frames (4, 1500, 512) from a
            seed, encdec_prefill_cache, 16 decode steps) against
            forward(embeds=frames)'s tied logits within 5e-3 of max
            |logit|, and apart from the zeroed-cache decode; InternVL's
            eval loss over 256 patches + 768 tokens through
            grouped_matmul (sgemm) and through the einsum
47. encdec and vlm lm train  make_train_step at full width and depth
            (bf16, Fed2 8, AdamW, 3 steps; the CLI refuses these
            families): Whisper 8 x 448 tokens over 8 x 1500 frames,
            InternVL 8 x (256 patches + 768 tokens); no launch; losses
            falling; then the eval step on the trained params
            (InternVL: grouped_matmul 2, wgmma) against the einsum
            route
48. (moved to tools/profile_phases.py: frontend)
49. surfaces  the four examples (python -m repro_torch.examples.*) at
            the reference's defaults (fed2_cifar_fl at --rounds 3
            --methods all), counted against the launches the code
            gives: quickstart none, fed2_cifar_fl paired_fusion once a
            round for every method but fedma, llm_federated_finetune
            paired_fusion and grouped_matmul (sgemm) once a round each
            over 4 rounds of fedavg and fed2, serve_decode ssd_update 2
            a step (the reduced Mamba-2) over 25 steps; then the
            dry-run's byte accounting for all 10 archs x 4 shapes x both
            production meshes x +- Fed2 (every applicable cell builds)
            and the meta pass of every arch at decode_32k; then
            mamba2-1.3b at decode_32k on real memory (batch 128 over
            32,768 positions): the allocated bytes equal the record's
            argument_bytes, one step launches ssd_update 48 times with
            finite logits, and a plain-route step's FlopCounterMode
            count on the card equals the meta pass's; one line per part
50. fl_dryrun  the federated dry-run (launch/fl_dryrun.py): every case
            of the reference's matrix on both meshes built without the
            meta pass (60 ok, 2 skipped), each record's argument and
            output bytes equal to the committed record's
            (benchmarks/artifacts_perf/dryrun_fl_*.json); then the 16x16
            fed2 case (full VGG9, 10 groups, 16 clients, 4 local steps
            of batch 32) on the card's (1, 1) mesh: its record built on
            meta, the same arguments allocated on the card (27,023,720
            B = the record's argument_bytes), one run_round with both
            kernels (local_step 4; paired_fusion 192 under its presence
            rows, one a shared leaf and a (pre, group) block, and 1
            with shared weights; the outputs' bytes equal to
            output_bytes), within a one-ulp change of the init
            of the plain routes (TF32 off, deterministic convs), and the
            plain round's FlopCounterMode count equal to the meta
            pass's; one fed2 async event at K = 8 (read arguments
            14,792,032 B, paired_fusion 1)
51. ranks   multi-rank execution over torch.distributed, the ranks
            sharing card 0 over gloo (launch/mesh.spawn; budget 90 s;
            alone: python3 -c 'import chip_smoke as c; c.phase_build();
            c.phase_ranks()'): (a) the CLI's main path (fed2, fed2
            --use-local-kernel, fedavg; 10 clients, 8 steps of batch 32,
            2 rounds) on 2 "data" ranks of 5 clients each against the
            same run in one process (TF32 off, deterministic convs):
            the largest |d| of each leaf over its largest magnitude, and
            of the whole global over its largest, within 1e-5 or within
            what a one-ulp change of the init does, whichever is larger;
            local_step 16 on each rank with the flag; one fusion and one
            eval all-reduce a round; the collectives' bytes and staged
            bytes, s/round beside one process's; (b) one full-width MoE
            layer of mixtral-8x22b and of deepseek-v2-236b (bf16, tokens
            (4, 512, d), each rank drawing only its experts) on a (2, 4)
            mesh of 8 ranks, each rank's output equal to
            moe_apply_ep_plain's on the card to the bit; the all-to-all
            bytes and the wall time; (c) fed2_cifar_fl --mesh host
            --rounds 1, counted (paired_fusion 2: fedavg and fed2). A
            rank that fails fails the run
52. ranks matrix  the whole federation on 2 "data" ranks sharing card 0
            over gloo, in one spawn (budget 210 s; alone: python3 -c
            'import chip_smoke as c; c.phase_build();
            c.phase_ranks_matrix()'):
            fedprox, fednova and fedma with --use-local-kernel, scaffold,
            fed2 + sign_flip(4) + trimmed_mean(0.25), fedavg +
            label_flip, fed2 + int8 and fed2 + bfloat16 at the CLI's
            full widths (10 clients, 8 steps of batch 32, 2 rounds), and
            run_scenario(nxc2_fed2_signflip20_trim, mesh=) at 2 rounds,
            each against one process taking its gradients 5 clients a
            call (TF32 off, deterministic convs): the ranks equal to
            each other to the bit, within 1e-5 or twice what one ulp of
            the init does, the runs that sort or match the gathered rows
            equal to one process to the bit; local_step 16 a rank with
            the flag; the collectives a round by kind, their bytes and
            staged bytes, s/round beside one process's; trimmed_mean and
            coordinate_median of one (10, 521,616) cohort through fedavg
            and paired averaging, sharded, equal to one process to the
            bit; then the rest of the federation on the same ranks:
            buffered async (fed2 --use-local-kernel, cohort 4, buffer_k
            2, polynomial(0.5), pareto(1.5), 4 events) against one
            process taking its gradients 2 clients a call, its dispatch
            schedule and staleness lists equal; async at buffer_k =
            cohort and zero latency equal to the sync rounds on the same
            ranks to the bit; capacity tiers (fed2 --fed2-groups 5
            --tiers 1.0x2,0.6x2,0.2x2, fedavg --tiers 1.0x2,0.5x2,0.25x2,
            fedavg --tiers 1.0x2,0.5x2,0.25x1 whose 1-client tile runs
            whole on both ranks; --use-local-kernel, 2 rounds) against
            one process taking its gradients a client a call; scaffold
            --store mmap equal to the memory-store run above to the bit;
            fed2 --use-local-kernel saved after round 1 (rank 0 writes,
            every rank waits at a barrier) and resumed to round 2, equal
            to the uninterrupted run to the bit; each with its
            collectives by kind, local_step launches a rank (8 a tile a
            rank with the flag, the replicated tile's too) and s/round
            or s/event beside one process's
53. ranks serve  the sharded prefill and decode on model ranks sharing
            card 0 over gloo (budget 120 s; alone: python3 -c 'import
            chip_smoke as c; c.phase_build(); c.phase_ranks_serve()'):
            the full-width, full-depth bf16 llama3.2-1b and mamba2-1.3b,
            each with and without Fed2 8, on a (1, 2) mesh, and the
            Fed2 llama on a (2, 2) mesh (a spawn each; the four (1, 2)
            spawns at once beside the one-process runs, then the (2, 2)
            one beside the dry mesh's predictions): each rank
            draws the tree from the serving seed and keeps its shares
            (exactly its per_device_bytes); run_serve(mesh=) at the
            serve CLI's defaults (batch 4, prompt 32, gen 16), counted:
            on every rank grouped_matmul 13 a Fed2 llama step and 1 a
            Fed2 mamba2 step, ssd_update 48 a mamba2 step, and the
            collectives a step (calls, bytes, result and staged bytes)
            equal to rank 0's program on a dry mesh of the same shape;
            an 8-token prompt alone (teacher-forced) and one prefill-loss step
            of (2, 2048) (grouped_matmul 4 with Fed2; collectives = the
            dry mesh's) held against one process: the gathered logits,
            the cache joined from the ranks' shares and the loss within
            max(2^-7, 2 r) of each one's largest magnitude, r the
            one-process bf16 run's distance from the same run in fp32;
            mamba2 with and without Fed2 on (1, 2) ranks again in fp32
            (weights upcast, TF32 off, both kernels in fp32; spawns
            beside the (2, 2) one), the 8-token prompt's logits and
            cache within 1e-4 of one fp32 process's largest magnitude;
            then every new shard shape of the two kernels (the
            unembeddings at (G, 256, V/(G·|model|)), the decoupled FFN
            products at f/(G·|model|), ssd_update at H/|model| heads, on
            this phase's path and the 16x16 dry-run's) against its
            plain version, timed beside its bound and torch.bmm, with
            its launches measured on the ranks by shape (every shape a
            rank launches must be among them)

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``. Nothing here imports jax or ``repro``.
"""
from __future__ import annotations

import collections
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

# the card's peaks (H100 SXM at 700 W, dense): device memory, fp32
# outside the tensor cores, bf16 on them
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_FLOPS,
    PEAK_FLOPS_FP32 as FP32_FLOPS)

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
# parameters of the full mamba2-1.3b, llama3.2-1b, qwen2-7b,
# h2o-danube-1.8b, stablelm-12b, zamba2-2.7b, mixtral-8x22b,
# deepseek-v2-236b, whisper-base and internvl2-2b, and of
# with_fed2(groups=8) of each: the reference's
# param_count(jax.eval_shape(init_params, ...)) on its configs/<arch>.full()
# (tests/test_torch_*.py pin them)
SERVE_PARAMS = {("mamba2-1.3b", 0): 1_446_812_672,
                ("mamba2-1.3b", 8): 1_356_667_904,
                ("llama3.2-1b", 0): 1_498_482_688,
                ("llama3.2-1b", 8): 1_092_487_168,
                ("qwen2-7b", 0): 7_615_616_512,
                ("qwen2-7b", 8): 6_069_392_896,
                ("h2o-danube-1.8b", 0): 1_831_201_280,
                ("h2o-danube-1.8b", 8): 1_480_829_440,
                ("stablelm-12b", 0): 12_142_937_600,
                ("stablelm-12b", 8): 10_578_593_280,
                ("zamba2-2.7b", 0): 2_422_670_240,
                ("zamba2-2.7b", 8): 2_350_990_240,
                ("mixtral-8x22b", 0): 140_630_071_296,
                ("mixtral-8x22b", 8): 140_453_910_528,
                ("deepseek-v2-236b", 0): 235_741_434_880,
                ("deepseek-v2-236b", 8): 235_282_682_880,
                ("whisper-base", 0): 88_256_512,
                ("whisper-base", 8): 86_421_504,
                ("internvl2-2b", 0): 1_889_634_304,
                ("internvl2-2b", 8): 1_459_324_928}
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
LM_TRAIN_STEPS = 3
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
# the other dense configs (qwen2-7b: QKV biases; h2o-danube-1.8b: a 4096
# sliding window; stablelm-12b: QK-norm and partial rotary) and the
# hybrid zamba2-2.7b (54 Mamba-2 layers, one shared attention block
# applied after every 6). with_fed2(groups=8) decouples the last 6 blocks
# of each dense config (19 grouped_matmul launches a decode step: the
# unembedding and 6 x 3 FFN products) and none of the hybrid (1: the
# unembedding); every zamba2 step launches ssd_update in its 54 layers
OTHER_ARCHS = ("qwen2-7b", "h2o-danube-1.8b", "stablelm-12b", "zamba2-2.7b")
OTHER_GMM_PER_STEP = {"qwen2-7b": 19, "h2o-danube-1.8b": 19,
                      "stablelm-12b": 19, "zamba2-2.7b": 1}
OTHER_SSD_PER_STEP = {"qwen2-7b": 0, "h2o-danube-1.8b": 0,
                      "stablelm-12b": 0, "zamba2-2.7b": 54}
# the large-batch Fed2 serve over 2048 slots: batch 128, but 64 for
# stablelm, whose 40-layer bf16 KV cache (8 KV heads of 160) is 54 GB at
# 128 beside its 21 GB of weights
OTHER_BIG_BATCH = {"qwen2-7b": 128, "h2o-danube-1.8b": 128,
                   "stablelm-12b": 64, "zamba2-2.7b": 128}
OTHER_SERVE_BIG = ("--max-len", "2048", "--prompt-len", "2", "--gen", "8")
# --mode lm, bf16, --fed2-groups 8, batch 8 x 1024 (as LM_TRAIN): danube
# and zamba2 at full depth through the CLI; stablelm cut from 40 to 8
# layers keeping its 6 decoupled blocks (at full depth its 10.6 B
# parameters take ~230 GB at the ~22 bytes a parameter that llama's step
# took on an H100 80GB HBM3 at 700 W; 8 layers are 1.69 B)
OTHER_LM_TRAIN = {arch: ("--mode", "lm", "--arch", arch, "--fed2",
                         "--fed2-groups", "8", "--batch", "8", "--seq",
                         "1024", "--lr", "1e-3")
                  for arch in ("h2o-danube-1.8b", "zamba2-2.7b")}
STABLELM_TRAIN_LAYERS = 8
# danube past its window: 2 of its 24 layers at full width (every width
# and the 4096 window kept), fp32, TF32 off; 4,400 tokens decoded one by
# one into a ring buffer of 4096 slots (positions 4096-4399 overwrite
# slots 0-303) against the chunked forward over the same tokens, which
# masks keys older than the window. Both compute one function; the
# dense limit DENSE_CROSSCHECK_LOGIT_ATOL (a wrong slot or a lost mask
# moves logits by O(1))
DANUBE_WRAP_LAYERS = 2
DANUBE_WRAP_LEN = 4400
# zamba2's chunked forward vs decode, 300 tokens (inside max_len, where
# the reference's decode window min(max_len, 4096) is the whole
# context): its 54 SSM layers are Mamba-2's chunked-SSD vs recurrence
# pair, which measured 6.67e-3 at Mamba-2's 48 layers on an H100 80GB
# HBM3 at 700 W (PERF.md), above the dense 5e-3; so the Mamba-2 limits
# hold it
HYBRID_CROSSCHECK = dict(attn_q_chunk=128, attn_kv_chunk=256)
# LM federation (LM_FL, fp32): zamba2 under with_fed2(groups=4) cut from
# 54 to 6 layers (one super-block: 6 SSM layers and the shared block, a
# 1.8 GB row; at 12 layers, a 2.74 GB row, the round ran out of an
# H100 80GB HBM3's memory (700 W) in the vmapped backward, 72.8 GiB
# allocated: the rounds run without remat under torch.func); danube under
# with_fed2(groups=4) cut from 24 to 8 layers keeping its 6 decoupled
# blocks (a 1.7 GB row)
HYBRID_FL_LAYERS = 6
DANUBE_FL_LAYERS = 8
# grouped_matmul's weights (K, N) a group, 8 groups, on these configs'
# Fed2 decode: the unembeddings (d/8, V/8) and the decoupled FFNs'
# gate/up (d/8, d_ff/8) and down (d_ff/8, d/8); danube and zamba2 share
# their unembedding's shape
OTHER_GMM_SHAPES = (
    ("qwen2-7b", 448, 19008), ("qwen2-7b", 448, 2368),
    ("qwen2-7b", 2368, 448), ("stablelm-12b", 640, 12544),
    ("stablelm-12b", 640, 1728), ("stablelm-12b", 1728, 640),
    ("zamba2-2.7b", 320, 4000), ("h2o-danube-1.8b", 320, 864),
    ("h2o-danube-1.8b", 864, 320))
# the MoE family. Neither full model fits on one card (281 and 471 GB of
# bf16 weights), so each phase cuts the depth, every width kept:
# serving at MOE_SERVE_LAYERS of 56 (mixtral) and of 60 (deepseek: its
# dense first layer and 7 MoE layers), ~41 and ~58 GB of bf16 weights,
# with Fed2 also at batch 128 over 2048 slots; fp32 decode parity and
# the chunked forward vs decode at MOE_PARITY_LAYERS (deepseek: the dense
# layer and one MoE layer; ~21.5 GB each). The parameter counts of the
# cuts are the reference's (tests/test_torch_moe_lm.py pins them).
# with_fed2(groups=8) decouples no MoE block: a Fed2 decode step launches
# grouped_matmul once (the unembedding)
MOE_ARCHS = ("mixtral-8x22b", "deepseek-v2-236b")
MOE_SERVE_LAYERS = 8
MOE_PARITY_LAYERS = 2
MOE_CUT_PARAMS = {("mixtral-8x22b", 0, 8): 20_435_146_752,
                  ("mixtral-8x22b", 8, 8): 20_258_985_984,
                  ("deepseek-v2-236b", 0, 8): 29_191_377_920,
                  ("deepseek-v2-236b", 8, 8): 28_732_625_920,
                  ("mixtral-8x22b", 8, 2): 5_234_620_416,
                  ("deepseek-v2-236b", 8, 2): 4_899_927_040,
                  ("mixtral-8x22b", 8, 1): 2_730_559_488,
                  ("deepseek-v2-236b", 8, 3): 2_075_796_480}
# the chunked forward vs MOE_CROSSCHECK_LEN decode steps at batch 2, at
# capacity factor 16 (nothing drops; the reference's
# test_prefill_decode_agreement) and attention chunks of 32: MLA's
# expanded prefill and absorbed decode, the ring buffer's window, and
# routing that a round-off near a top-k tie could flip (a flipped
# expert moves logits by O(1)), so few tokens: the dense limit
MOE_CROSSCHECK_LEN = 64
MOE_CROSSCHECK = dict(attn_q_chunk=32, attn_kv_chunk=32)
# --mode lm, bf16, --fed2-groups 8, batch 8 x 1024 (as LM_TRAIN), through
# the CLI's step: mixtral at 1 layer (2.73 B), deepseek at 3 layers (the
# dense one and 2 MoE) with 16 of its 160 routed experts (2.08 B; one
# full MoE layer alone would take ~87 GB at the ~22 bytes a parameter a
# step takes), every other width kept
MOE_TRAIN = {"mixtral-8x22b": dict(n_layers=1),
             "deepseek-v2-236b": dict(n_layers=3, n_experts=16)}
# LM federation (LM_FL, fp32, groups 4): every routing parameter kept (E,
# top-k, the shared experts, router_norm_topk, the capacity factor; MLA's
# heads and latent dims), d_model, d_ff, vocab and depth cut until a flat
# fp32 row is <= 1.8 GB (danube's 1.68, zamba2's 1.79): mixtral d 1536,
# d_ff 4096 (its 8/3 ratio), its vocab, 2 layers (1.64 GB); deepseek d
# 1280, expert d_ff 384, shared 768, dense 3072 (its ratios), vocab 25600,
# 2 layers: the dense one and one MoE layer (1.79 GB)
MOE_FL = {"mixtral-8x22b": dict(d_model=1536, d_ff=4096, vocab=32768,
                                n_layers=2),
          "deepseek-v2-236b": dict(d_model=1280, d_ff=384, vocab=25600,
                                   n_layers=2, moe_dense_ff=3072,
                                   d_ff_shared=768)}
# grouped_matmul at the MoE configs' Fed2 unembeddings, (d/8, V/8)
MOE_GMM_SHAPES = (("mixtral-8x22b", 768, 4096),
                  ("deepseek-v2-236b", 640, 12800))
# the encdec and vlm families, at full width and depth (both fit on one
# card: 0.18 and 3.8 GB of bf16 weights). with_fed2(groups=8) decouples
# one Whisper decoder block (decouple = max(1, min(6, 6 // 4))): its
# GELU FFN's up (8, 64, 256) and down (8, 256, 64) products, with
# biases, are the grouped_matmul launches of a Fed2 Whisper decode step
# (the unembedding stays the tied table: the reference tests
# tie_embeddings first); InternVL decouples 6 blocks (Llama's FFN
# shapes) and unembeds through (8, 256, 11584): 19 a step
FRONTEND_ARCHS = ("whisper-base", "internvl2-2b")
FRONTEND_GMM_PER_STEP = {"whisper-base": 2, "internvl2-2b": 19}
# grouped_matmul's (K, N) a group on their Fed2 decode, with a bias?
FRONTEND_GMM_SHAPES = (("whisper-base", 64, 256, True),
                       ("whisper-base", 256, 64, True),
                       ("internvl2-2b", 256, 11584, False))
# the decoupled FFN products (K, N) whose 192-column units and tiles fill
# 8-104 of the card's 132 SMs, with the large-batch serve's M: the plan
# gives them narrower units and tiles, and qwen2's down product at M = 128
# a split of K over a thread-block cluster
GMM_FFN_PRODUCTS = (("llama3.2-1b down", 1024, 256, 128),
                    ("qwen2-7b down", 2368, 448, 128),
                    ("h2o-danube-1.8b down", 864, 320, 128),
                    ("whisper-base down", 256, 64, 128),
                    ("stablelm-12b down", 1728, 640, 64),
                    ("whisper-base up", 64, 256, 128),
                    ("llama3.2-1b gate/up", 256, 1024, 128),
                    ("h2o-danube-1.8b gate/up", 320, 864, 128),
                    ("stablelm-12b gate/up", 640, 1728, 64),
                    ("qwen2-7b gate/up", 448, 2368, 128))
# the bf16 eval/prefill loss chunks of every LM's --mode lm step
# (make_eval_step, make_prefill_loss_step: batch 8 x a 512-token loss
# chunk, M = 4096 rows, twice a step) through its Fed2 unembedding, (d/8,
# V/8) a group of 8; and the bf16 lm_task eval (64 x 64 tokens through
# Mamba-2's unembedding in 4 groups), (G, K, N)
GMM_EVAL_CHUNKS = (("mamba2-1.3b", 256, 6288), ("llama3.2-1b", 256, 16032),
                   ("qwen2-7b", 448, 19008), ("stablelm-12b", 640, 12544),
                   ("h2o-danube-1.8b/zamba2-2.7b", 320, 4000),
                   ("mixtral-8x22b", 768, 4096),
                   ("deepseek-v2-236b", 640, 12800),
                   ("internvl2-2b", 256, 11584))
GMM_EVAL_M = 4096
GMM_LM_TASK_BF16 = (4, 512, 12576)
# Whisper's serving path at full width in fp32 (TF32 off): frames (B,
# 1500, 512) from a numpy seed, encdec_prefill_cache, then
# WHISPER_DECODE_LEN decode steps (the Fed2 block's FFN on the kernel)
# against forward(embeds=frames)'s tied logits. Both run the same fp32
# function: the forward pads the encoder's 1500 frames to 1536 queries
# and 2048 keys and sums its online softmax over chunks, the decode
# takes one softmax over 1500 cached keys; fp32 round-off through 6 + 6
# layers stays near 1e-5 of the logits, a wrong mask, position or cache
# row moves them O(1). The limit is set before the run
WHISPER_DECODE_LEN = 16
WHISPER_PREFILL_LOGIT_RTOL = 5e-3       # of max |logit|
# InternVL's eval loss in fp32 through grouped_matmul (sgemm) and through
# the einsum, on a batch of 2 x (256 patches + 768 tokens): fp32 logits
# differ by ~1e-6 relative (256-term sums in other orders); the mean CE
# over ~1,200 masked tokens a few 1e-6
FRONTEND_EVAL_FP32_TOL = 1e-4
FRONTEND_EVAL_TEXT = 768
# the --mode lm step (make_train_step: bf16, AdamW at lr 1e-3, Fed2 8)
# at full width and depth on batches that carry the frontends' embeds:
# Whisper 8 x 448 text tokens (its decoder's context) over 8 x 1500
# frames; InternVL 8 x 1024 positions, 256 patches and 768 tokens (the
# split of the reference's launch/sharding.py)
FRONTEND_TRAIN = {"whisper-base": dict(batch=8, seq=448, embeds=1500),
                  "internvl2-2b": dict(batch=8, seq=768, embeds=256)}


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
    for r, dt, plans in (("stream", torch.bfloat16,
                          [(1, c) for c in gm._PLAN_COLS]),
                         ("stream", torch.float32, [gm.DEFAULT_PLAN]),
                         ("wgmma", torch.bfloat16,
                          [(1, c) for c in gm._WGMMA_COLS]
                          + [(2, c) for c in gm._SPLIT_COLS]),
                         ("sgemm", torch.float32, [gm.DEFAULT_PLAN])):
        for p in plans:
            kind = (f", {'split' if p[0] > 1 else 'unsplit'}, {p[1]} "
                    f"columns" if dt == torch.bfloat16 else "")
            print(f"  grouped_matmul {r} route, {str(dt)[6:]}{kind}: "
                  f"{gm.dynamic_smem(r, dt, p)} bytes of dynamic shared "
                  f"memory per block")
    print("  grouped_matmul wgmma route, unsplit, row-tile pairs the card "
          "holds at once: " + ", ".join(
              f"{gm.wgmma_pairs(c)} at {c} columns" for c in gm._WGMMA_COLS))


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


def ssd_inputs(b, h, p, n, dt_x, gen, state=None, row_heads=None,
               head0=0):
    """Inputs of one ssd_update call as the decode makes them: x, b and c
    views into one (B, H*P + 2N) row of dtype ``dt_x``, dt > 0 after a
    softplus, a_log as the model inits it. ``row_heads``: a row of that
    many heads, x the ``h`` heads from ``head0`` (a model rank's heads
    in its all-gathered conv channels)."""
    hr = h if row_heads is None else row_heads
    row = torch.randn(b, hr * p + 2 * n, generator=gen, device="cuda")
    row = row.to(dt_x)
    x = row[:, head0 * p:(head0 + h) * p].reshape(b, h, p)
    bm, cm = row[:, hr * p:hr * p + n], row[:, hr * p + n:]
    if state is None:
        state = torch.randn(b, h, p, n, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn(b, h, generator=gen, device="cuda"))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    d = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    return state, x, dt, a_log, bm, cm, d


# ssd_update's timed shapes: Mamba-2 1.3B and Zamba2-2.7B's layers at
# batch 4 and 128
SSD_TIMED = ((4, 64, 64, 128), (128, 64, 64, 128), (4, 80, 64, 64),
             (128, 80, 64, 64))


def phase_check_ssd_update() -> dict:
    """ssd_update against ssd_update_ref at the serve path's shapes
    (batch 4 and decode_32k's 128, H = P = 64, N = 128; x in bf16 as at
    full width, and fp32) and on ragged shapes; in place (out = h) as
    the decode calls it, and into a fresh buffer. Each line names the
    route the launch took (both must run); two launches on the same
    inputs must give the same bits of h' and y. The four timed shapes'
    plans are printed.

    Limits: h' within 1e-5 (fp32; both compute decay*h + dt*x*b with
    one rounding more or less); y within 1e-5 of sum_n |h'_n c_n| +
    |d x| per output (fp32 sums of N terms in another order), plus one
    bf16 step of |y| when y is bf16."""
    from repro_torch.kernels import ssd_update as su
    from repro_torch.kernels.ssd_update import ssd_update, ssd_update_ref
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    routes_seen = set()

    def launched_route(fn):
        before = dict(ssd_update.route_launches)
        out = fn()
        took = [r for r in su.ROUTES
                if ssd_update.route_launches[r] != before[r]]
        assert len(took) == 1, took
        return out, took[0]

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
        # the same bits on every run: two launches into fresh buffers
        (h1, y1), r1 = launched_route(lambda: ssd_update(*args))
        (h2, y2), r2 = launched_route(lambda: ssd_update(*args))
        same = r1 == r2 and torch.equal(h1, h2) and torch.equal(y1, y2)
        del h1, h2
        # in place on a copy (the unaligned state is its own copy)
        state = args[0].clone() if in_place and not misalign else args[0]
        (got_h, got_y), took = launched_route(
            lambda: ssd_update(state, *args[1:],
                               out=state if in_place else None))
        assert (got_h is state) == in_place
        routes_seen.add(took)
        eh = (got_h - want_h).abs().max().item()
        dy = (got_y.float() - want_y.float()).abs()
        lim = 1e-5 * scale
        if dt_x == bf16:
            lim = lim + 2.0 ** -7 * want_y.float().abs()
        ey = dy.max().item()
        ok = eh <= 1e-5 and bool((dy <= lim).all()) and same and \
            torch.equal(got_y, y1)
        print(f"  ssd_update {name} ({b}, {h}, {p}, {n}) x "
              f"{str(dt_x)[6:]}{' in place' if in_place else ''}, {took} "
              f"route: max_abs_err h' {eh:.3g} (tol 1e-5), y {ey:.3g} (tol "
              f"{'1e-5 x sum|h c| + |d x|' + (' + 2^-7|y|' if dt_x == bf16 else '')}); "
              f"repeat bit-equal {same} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"ssd_update {name}: kernel disagrees with "
                                 "its plain version or with itself")
        return max(eh, ey)

    err_path = max(check_one("serve path", 4, 64, 64, 128, bf16),
                   check_one("serve path", 4, 64, 64, 128, f32))
    check_one("decode_32k batch", 128, 64, 64, 128, bf16)
    check_one("decode_32k batch", 128, 64, 64, 128, f32, in_place=False)
    # ragged: N % 4 != 0 or N > 256 (scalar), and N = 36, 256, 8, 132
    # with P off the unit's rows (tma: 9 chunks on 16 lanes, 2 chunks a
    # lane, 2 lanes a row, 33 chunks on 32 lanes; P = 7 in bf16 is
    # scalar: x's rows in 4-byte copies)
    for shape in ((3, 5, 7, 9), (2, 6, 33, 130), (2, 3, 40, 36),
                  (1, 1, 1, 1), (2, 9, 100, 260), (2, 4, 24, 256),
                  (3, 5, 7, 8), (2, 3, 50, 132)):
        check_one("ragged", *shape, f32)
        check_one("ragged", *shape, bf16, in_place=False)
    check_one("unaligned state", 2, 4, 16, 128, f32, misalign=True)
    # zamba2's layers: 80 heads of 64, a state of 64 (bf16 x at full
    # width, fp32 in the decode parity)
    for b in (4, 128):
        check_one("zamba2", b, 80, 64, 64, bf16)
        check_one("zamba2", b, 80, 64, 64, f32)
    assert routes_seen == set(su.ROUTES), routes_seen

    timings = {}
    sms = su.sm_count(torch.cuda.current_device())
    for b, h, p, n in SSD_TIMED:
        # the state read and written (fp32); x, b, c read and y written
        # (bf16); dt, a_log, d_skip read (fp32)
        nbytes = 8 * b * h * p * n + 2 * (2 * b * h * p + 2 * b * n) \
            + 4 * (b * h + 2 * h)
        sets = [ssd_inputs(b, h, p, n, bf16, gen)
                for _ in range(copies_for(nbytes))]
        a = sets[0]
        plan = su.route(b, h, p, n, su.pointers(a[0], a[0], a[1], a[4], a[5]),
                        (a[1].stride(0), a[4].stride(0), a[5].stride(0)), 2,
                        sms)
        reps = max(200 if b == 4 else 40, len(sets))
        t = {"ms": time_ms([lambda a=a: ssd_update(*a, out=a[0])
                            for a in sets], reps),
             "plain_ms": time_ms([lambda a=a: ssd_update_ref(*a)
                                  for a in sets], reps),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = bound(nbytes, 6 * b * h * p * n)
        timings[b, h, p, n] = t
        print(f"  ssd_update ({b}, {h}, {p}, {n}) x bf16: "
              f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
              f"library none, bound {t['bound_ms'] * 1e3:.2f} us "
              f"({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.0f} % of "
              f"it); plan {plan.route}, {plan.unit_rows} rows a unit, "
              f"{b * h * -(-p // plan.unit_rows)} blocks", flush=True)
        del sets
    return {"name": "ssd_update", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_update.cu",
            "replaces": "src/repro/kernels/ssd_update.py:50",
            "max_abs_err": err_path, **timings[4, 64, 64, 128]}


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
    than the ring, K or N off 16 bytes, an unaligned x or w, G = 1, a
    leading batch dimension, a bias); each case must launch through the
    route it names; on the bf16 stream and wgmma routes the plan the
    wrapper takes is printed, a split one (S > 1, wgmma: long K, and
    forced plans at the split kernel's edges) must repeat to the bit, an
    unsplit one give DEFAULT_PLAN's bits (so must every unsplit width,
    256 columns and the row-tile pairs among them, forced at the wgmma
    kernel's edges), and a plan the kernel was not built for (a split on
    the stream route among them) must raise. Limits: 1e-4 sqrt(K) fp32
    and 0.3 bf16, the reference's (tests/test_kernels.py). The stream,
    wgmma and sgemm routes must repeat to the bit, and every sgemm case
    must give the simt route's bits on the same inputs. Times at M = 4
    (stream) and 128 (wgmma) with each shape's plan, the decoupled FFN
    products also under DEFAULT_PLAN and a split plan also unsplit at
    its width, at every LM's bf16 eval chunk (M = 4096) and the bf16
    lm_task eval, and at the fp32 LM rounds' evals (sgemm, beside the
    simt route on the same inputs)."""
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_ref)
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    g0, k0, n0 = 8, 256, 6288

    def off_by_one(t):
        """A copy of ``t`` one element past an aligned allocation."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def check_one(name, route, lead, g, k, n, dt, bias=False,
                  misalign=None, splits=None, cols=None):
        """One case, which must launch through ``route``; ``misalign``
        ("x" or "w") puts that input one element off its alignment;
        ``splits`` and ``cols``, where given, are the S and the width its
        plan must take. An sgemm
        case must repeat to the bit and give the simt route's bits on
        the same inputs; a split case (S > 1) must repeat to the bit,
        and an unsplit case of a planned route must give the bits of
        the forced ``DEFAULT_PLAN`` on the same inputs."""
        x, w, b = gmm_inputs(lead, g, k, n, dt, gen, bias)
        if misalign == "w":
            w = off_by_one(w)
        elif misalign == "x":
            x = off_by_one(x)
        tol = 1e-4 * math.sqrt(k) if dt == f32 else 0.3
        before = dict(grouped_matmul.route_launches)
        got = grouped_matmul(x, w, b)
        ran = [r for r, c in grouped_matmul.route_launches.items()
               if c != before[r]]
        assert ran == [route], f"grouped_matmul {name}: ran {ran}, " \
            f"expected the {route} route"
        xm = x.reshape(-1, g * k)
        p = gm.plan(route, xm.shape[0], g, k, n, sms, dt)
        assert splits is None or p[0] == splits, \
            f"grouped_matmul {name}: plan {p}, expected {splits} splits"
        assert cols is None or p[1] == cols, \
            f"grouped_matmul {name}: plan {p}, expected {cols} columns"
        label = (f"grouped_matmul {name} [{route}, plan {p}] x "
                 f"{tuple(x.shape)} w {tuple(w.shape)}"
                 f"{' + bias' if bias else ''} {str(dt)[6:]}")
        same = ""
        if route == "sgemm":
            plain = gm.launch(xm, w, "sgemm")
            assert torch.equal(plain, gm.launch(xm, w, "sgemm")), \
                f"{label}: two launches on the same inputs differ"
            assert torch.equal(plain, gm.launch(xm, w, "simt")), \
                f"{label}: not the simt route's bits"
            same = ", = simt's bits"
        elif p[0] > 1:
            assert torch.equal(gm.launch(xm, w, route),
                               gm.launch(xm, w, route)), \
                f"{label}: two launches on the same inputs differ"
            same = ", repeats to the bit"
        elif p != gm.DEFAULT_PLAN:
            assert torch.equal(gm.launch(xm, w, route),
                               gm.launch(xm, w, route, gm.DEFAULT_PLAN)), \
                f"{label}: not the bits of plan {gm.DEFAULT_PLAN}"
            same = f", = plan {gm.DEFAULT_PLAN}'s bits"
        return check(label + same, got, grouped_matmul_ref(x, w, b), tol)

    err_path = max(check_one("serve path", "stream", (4,), g0, k0, n0, bf16),
                   check_one("serve path", "stream", (4,), g0, k0, n0, f32))
    check_one("decode_32k batch", "wgmma", (128,), g0, k0, n0, bf16)
    check_one("decode_32k batch", "sgemm", (128,), g0, k0, n0, f32)
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
    # the unsplit kernel's 256-column tiles and its cluster pairs (M past
    # one row tile: two row tiles share w's boxes) through the plan: M off
    # the row tile (4097: an odd count of row tiles, the last pair's second
    # tile past M), N off the 256 columns, K off a stage and past the
    # 4-stage ring, G = 1, a leading batch dimension with a bias
    check_one("M off the row tile", "wgmma", (4097,), g0, k0, n0, bf16,
              cols=256)
    check_one("N off the columns, K past the ring", "wgmma", (4096,), g0,
              600, 1000, bf16, cols=256)
    check_one("K off a stage", "wgmma", (4096,), g0, 104, n0, bf16, cols=256)
    check_one("G = 1", "wgmma", (4096,), 1, k0, 16032, bf16, cols=256)
    check_one("leading batch dim", "wgmma", (8, 512), g0, k0, n0, bf16,
              bias=True, cols=256)

    def check_widths(name, lead, g, k, n):
        """Every unsplit width forced on one case: within 0.3 of the plain
        version, equal to itself on a relaunch and to DEFAULT_PLAN's
        bits."""
        x, w, _ = gmm_inputs(lead, g, k, n, bf16, gen)
        want = grouped_matmul_ref(x, w)
        base = gm.launch(x, w, "wgmma", gm.DEFAULT_PLAN)
        for c in gm._WGMMA_COLS:
            got = gm.launch(x, w, "wgmma", (1, c))
            assert torch.equal(got, gm.launch(x, w, "wgmma", (1, c))), \
                f"grouped_matmul {name} [wgmma, plan (1, {c})]: relaunch"
            assert torch.equal(got, base), \
                f"grouped_matmul {name} [wgmma, plan (1, {c})]: not the " \
                f"bits of plan {gm.DEFAULT_PLAN}"
            check(f"grouped_matmul {name} [wgmma, forced plan (1, {c})] x "
                  f"{tuple(x.shape)} w {tuple(w.shape)}, repeats to the bit, "
                  f"= plan {gm.DEFAULT_PLAN}'s bits", got, want, 0.3)

    # each width alone and in pairs of row tiles: M = 100 (one row tile),
    # 129 and 200 (two, the second ragged), 600 (five: the last pair's
    # second tile past M); N off every width, K off a stage and past every
    # width's ring (4-8 stages), G = 1
    check_widths("widths, one row tile", (100,), 2, 600, 520)
    check_widths("widths, a pair", (129,), 3, 104, 264)
    check_widths("widths, a pair", (200,), 1, 600, 1000)
    check_widths("widths, pairs", (600,), 2, 576, 600)
    # the sgemm route: M > 8 fp32, K and N multiples of 16 bytes; M, K
    # and N off the 128 x 128 tile and the 16-deep stage, K past the
    # 4-stage ring, K = 4, G = 1
    check_one("ragged", "sgemm", (9,), 3, 100, 68, f32, bias=True)
    check_one("ragged", "sgemm", (200,), 5, 36, 260, f32)
    check_one("K past the ring", "sgemm", (130,), 2, 600, 132, f32)
    check_one("K = 4", "sgemm", (129,), 2, 4, 4, f32)
    check_one("G = 1", "sgemm", (300,), 1, k0, n0, f32)
    check_one("leading batch dim", "sgemm", (3, 77), 4, 64, 136, f32,
              bias=True)
    # the simt route: what TMA does not take
    check_one("ragged", "simt", (8,), 2, 33, 260, bf16)
    check_one("long K", "simt", (4,), 2, 600, 132, bf16)
    check_one("ragged", "simt", (5,), 3, 100, 70, f32, bias=True)
    check_one("ragged", "simt", (17,), 5, 13, 130, bf16, bias=True)
    check_one("ragged", "simt", (130,), 13, 13, 13, f32)
    check_one("ragged", "simt", (200,), 5, 100, 70, bf16)
    check_one("K off 16 bytes", "simt", (4,), 2, 100, 264, bf16)
    check_one("K off 16 bytes", "simt", (64,), 2, 100, 264, bf16)
    check_one("N off the vector width", "simt", (4,), 2, 64, 6289, bf16)
    check_one("N off the vector width", "simt", (64,), 2, 64, 6289, f32)
    check_one("K off 16 bytes", "simt", (64,), 2, 102, 264, f32)
    check_one("unaligned w", "simt", (4,), 2, 64, 512, f32, misalign="w")
    check_one("unaligned w", "simt", (4,), 2, 64, 512, bf16, misalign="w")
    check_one("unaligned w", "simt", (64,), 2, 64, 512, f32, misalign="w")
    check_one("unaligned x", "simt", (64,), 2, 64, 512, f32, misalign="x")
    # the plans through the wrapper at long K (a wgmma split keeps 16
    # stages at least; the stream route takes 64-column units unsplit):
    # K off the stages, N off the columns, G = 1, ragged and several row
    # tiles, a leading batch dimension and a bias; and K of one stage
    # (S = 1, 64 columns)
    for route, m in (("stream", 4), ("wgmma", 128)):
        s = 2 if route == "wgmma" else 1
        check_one("long K, K off the stages", route, (m,), g0, 5000, 256,
                  bf16, splits=s)
        for n in (40, 104, 184):
            check_one("long K, N off the columns", route,
                      (m if route == "stream" else 100,), g0, 5000, n, bf16,
                      splits=s)
        check_one("long K, G = 1", route, (m,), 1, 4096, 256, bf16,
                  splits=s)
        check_one("long K, leading batch dim", route,
                  (2, 3) if route == "stream" else (2, 64), g0, 4096, 256,
                  bf16, bias=True, splits=s)
        check_one("one stage of K", route, (m,), g0, 64, 256, bf16,
                  splits=1)
    check_one("long K, row tiles", "wgmma", (200,), g0, 4096, 256, bf16,
              splits=2)

    def check_plan(name, route, lead, g, k, n, p):
        """A split plan ``p`` forced on one case: within 0.3 of the plain
        version and equal to itself on a relaunch."""
        x, w, _ = gmm_inputs(lead, g, k, n, bf16, gen)
        got = gm.launch(x, w, route, p)
        assert torch.equal(got, gm.launch(x, w, route, p)), \
            f"grouped_matmul {name} [{route}, plan {p}]: two launches differ"
        check(f"grouped_matmul {name} [{route}, forced plan {p}] x "
              f"{tuple(x.shape)} w {tuple(w.shape)}, repeats to the bit", got,
              grouped_matmul_ref(x, w), 0.3)

    # the split kernel's edges under forced plans: K of exactly S stages,
    # one stage a split with K off a stage, N off each column width, G =
    # 1, ragged and several row tiles, stablelm's M = 64, more clusters
    # than the card holds at once
    check_plan("K of S stages", "wgmma", (100,), g0, 128, 64, (2, 64))
    check_plan("a stage a split, K off a stage", "wgmma", (100,), g0, 1000,
               256, (8, 128))
    for n, cols in ((40, 64), (104, 128), (184, 128)):
        check_plan("N off the columns", "wgmma", (100,), g0, 1024, n,
                   (2, cols))
    check_plan("G = 1", "wgmma", (100,), 1, 1024, 256, (8, 128))
    check_plan("row tiles", "wgmma", (200,), g0, 1024, 256, (4, 128))
    check_plan("stablelm down, M = 64", "wgmma", (64,), g0, 1728, 640,
               (2, 128))
    check_plan("more clusters than the card holds", "wgmma", (128,), g0,
               k0, n0, (2, 64))
    # plans the kernel was not built for raise, counted nowhere
    x, w, _ = gmm_inputs((4,), g0, 1024, 256, bf16, gen)
    for route, p in (("stream", (2, 64)), ("wgmma", (2, 192)),
                     ("wgmma", (3, 64)), ("stream", (16, 64)),
                     ("stream", (1, 96)), ("wgmma", (16, 64)),
                     ("stream", (1, 256)), ("wgmma", (2, 256)),
                     ("wgmma", (1, 320))):
        xr = x if route == "stream" else x.repeat(32, 1)
        before = (grouped_matmul.launches,
                  dict(grouped_matmul.route_launches))
        try:
            gm.launch(xr, w, route, p)
        except RuntimeError as e:
            assert "CUDA error 1" in str(e), e
        else:
            raise AssertionError(f"grouped_matmul {route} plan {p} ran")
        assert (grouped_matmul.launches,
                grouped_matmul.route_launches) == before
    print("  grouped_matmul plans stream (2, 64), (16, 64), (1, 96), "
          "(1, 256), wgmma (2, 192), (3, 64), (16, 64), (2, 256), (1, 320): "
          "refused by the kernel (cudaErrorInvalidValue), no launch counted "
          "ok")
    # the stream and wgmma routes repeat to the bit (sgemm: check_one)
    for m in (4, 128):
        x, w, _ = gmm_inputs((m,), g0, k0, n0, bf16, gen)
        assert torch.equal(grouped_matmul(x, w), grouped_matmul(x, w)), \
            f"grouped_matmul M={m}: two calls on the same inputs differ"

    # the LM's no-grad unembedding (M = B * min(S, loss_chunk) rows):
    # make_eval_step / make_prefill_loss_step at --batch 8 --seq 1024
    # (two chunks of 512: M = 4096, bf16, G = 8) and lm_task's eval (64
    # sequences of 64 tokens: M = 4096, fp32, G = 4, K = 512, N = 12576)
    check_one("lm eval chunk", "wgmma", (8, 512), g0, k0, n0, bf16)
    check_one("lm_task eval", "sgemm", (64, 64), 4, 512, 12576, f32)
    # the dense family's decode (llama3.2-1b, 8 groups): the decoupled
    # FFN's gate/up (8, 256, 1024) and down (8, 1024, 256) products and
    # the unembedding (8, 256, 16032), on x (B, 1, G*K); bf16 serve at
    # batch 4 (stream) and 128 (wgmma), fp32 at batch 4 (the decode
    # parity); and the dense lm_task eval, (4, 512, 32064) fp32
    for k, n in ((256, 1024), (1024, 256), (256, 16032)):
        check_one("dense decode", "stream", (4, 1), g0, k, n, bf16)
        check_one("dense decode", "wgmma", (128, 1), g0, k, n, bf16)
        check_one("dense decode", "stream", (4, 1), g0, k, n, f32)
    check_one("dense lm_task eval", "sgemm", (64, 64), 4, 512, 32064, f32)
    # the other dense configs' and zamba2's Fed2 decode (8 groups, bf16):
    # each unembedding and decoupled FFN product at batch 4 (stream) and
    # at the large-batch serve's batch (wgmma), fp32 at batch 4 where the
    # decode parity runs (qwen2, zamba2); and their lm_task eval's
    # unembedding, (4, 640, 8000) fp32 (danube and zamba2 at 4 groups)
    for arch, k, n in OTHER_GMM_SHAPES:
        check_one(f"{arch} decode", "stream", (4, 1), g0, k, n, bf16)
        check_one(f"{arch} decode", "wgmma", (OTHER_BIG_BATCH[arch], 1), g0,
                  k, n, bf16)
        if arch in ("qwen2-7b", "zamba2-2.7b"):
            check_one(f"{arch} decode", "stream", (4, 1), g0, k, n, f32)
    check_one("danube/zamba2 lm_task eval", "sgemm", (64, 64), 4, 640,
              8000, f32)
    # the MoE configs' Fed2 unembedding: decode at batch 4 (stream, bf16
    # and the fp32 parity's) and 128 (wgmma), an eval chunk (M = 4096,
    # wgmma); their lm_task eval (fp32, 4 groups, MOE_FL's widths)
    for arch, k, n in MOE_GMM_SHAPES:
        check_one(f"{arch} decode", "stream", (4, 1), g0, k, n, bf16)
        check_one(f"{arch} decode", "wgmma", (128, 1), g0, k, n, bf16)
        check_one(f"{arch} decode", "stream", (4, 1), g0, k, n, f32)
        check_one(f"{arch} eval chunk", "wgmma", (8, 512), g0, k, n, bf16)
    for arch, w in MOE_FL.items():
        check_one(f"{arch} lm_task eval", "sgemm", (64, 64), 4,
                  w["d_model"] // 4, w["vocab"] // 4, f32)
    # the encdec and vlm families' Fed2 decode (8 groups): Whisper's
    # decoupled GELU FFN, up (8, 64, 256) and down (8, 256, 64) with
    # biases (K under one stage of the stream and wgmma routes, N under
    # one column unit and one tile: the smallest shapes yet), and
    # InternVL's unembedding (8, 256, 11584); bf16 at batch 4 (stream)
    # and 128 (wgmma), fp32 at batch 4 (the decode parity and Whisper's
    # prefilled decode); InternVL's eval chunks, bf16 (wgmma, after
    # training) and fp32 (sgemm, the parity phase's 2 x 768 tokens)
    for arch, k, n, bias in FRONTEND_GMM_SHAPES:
        for route, m, dt in (("stream", 4, bf16), ("wgmma", 128, bf16),
                             ("stream", 4, f32)):
            check_one(f"{arch} decode", route, (m, 1), g0, k, n, dt,
                      bias=bias)
    check_one("internvl2-2b eval chunk", "wgmma", (8, 512), g0, 256, 11584,
              bf16)
    check_one("internvl2-2b eval chunk", "sgemm", (2, 512), g0, 256,
              11584, f32)
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
    ffn = {(k, n) for _, k, n, _ in GMM_FFN_PRODUCTS}
    for label, m, g, k, n, dt in (
            ("serve M=4", 4, g0, k0, n0, bf16),
            ("serve M=128", 128, g0, k0, n0, bf16),
            *((f"{arch} eval chunk M={GMM_EVAL_M}", GMM_EVAL_M, g0, k, n,
               bf16) for arch, k, n in GMM_EVAL_CHUNKS),
            (f"bf16 lm_task eval M={GMM_EVAL_M}", GMM_EVAL_M,
             *GMM_LM_TASK_BF16, bf16),
            ("lm_task eval M=4096", 4096, 4, 512, 12576, f32),
            ("gffn gate/up M=4", 4, g0, 256, 1024, bf16),
            ("gffn down M=4", 4, g0, 1024, 256, bf16),
            ("gffn gate/up M=128", 128, g0, 256, 1024, bf16),
            ("gffn down M=128", 128, g0, 1024, 256, bf16),
            ("dense lm_task eval M=4096", 4096, 4, 512, 32064, f32),
            ("danube/zamba2 lm_task eval M=4096", 4096, 4, 640, 8000, f32),
            *((f"{arch} lm_task eval M=4096", 4096, 4, w["d_model"] // 4,
               w["vocab"] // 4, f32) for arch, w in MOE_FL.items()),
            ("internvl2-2b eval chunk M=1024", 1024, g0, 256, 11584, f32),
            *((f"{arch} ({k}, {n}) M={m}", m, g0, k, n, bf16)
              for arch, k, n in OTHER_GMM_SHAPES
              for m in (4, OTHER_BIG_BATCH[arch])),
            *((f"{arch} ({k}, {n}) M={m}", m, g0, k, n, bf16)
              for arch, k, n in MOE_GMM_SHAPES for m in (4, 128)),
            *((f"{arch} ({k}, {n}) M={m}", m, g0, k, n, bf16)
              for arch, k, n, _ in FRONTEND_GMM_SHAPES for m in (4, 128))):
        esz = dt.itemsize
        w_bytes = g * k * n * esz
        nbytes = w_bytes + esz * m * g * (k + n)
        sets = [gmm_inputs((m,), g, k, n, dt, gen)[:2]
                for _ in range(copies_for(w_bytes))]
        # each replayed call writes its own (M, G*N) output: at M = 4096
        # that is 0.1-2.1 GB, so fewer calls a graph
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
        r = gm.route(m, g, k, n, dt, 0, 0)
        p = gm.plan(r, m, g, k, n, sms, dt)
        simt = ""
        if r == "sgemm":       # the route it replaced, on the same inputs
            t["simt_ms"] = time_ms([lambda a=a: gm.launch(*a, "simt")
                                    for a in sets], reps)
            simt = f", simt {t['simt_ms'] * 1e3:.2f} us"
        elif (k, n) in ffn and dt == bf16:   # the parent design, the same
            t["default_ms"] = time_ms(
                [lambda a=a: gm.launch(*a, r, gm.DEFAULT_PLAN)
                 for a in sets], reps)
            simt = (f", plan {gm.DEFAULT_PLAN} "
                    f"{t['default_ms'] * 1e3:.2f} us")
            if p[0] > 1:                     # and the split's width unsplit
                t["unsplit_ms"] = time_ms(
                    [lambda a=a: gm.launch(*a, r, (1, p[1])) for a in sets],
                    reps)
                simt += f", plan {(1, p[1])} {t['unsplit_ms'] * 1e3:.2f} us"
        timings[label] = t
        print(f"  grouped_matmul {label} ({g}, {k}, {n}) {str(dt)[6:]} "
              f"[{r}, plan {p}]: {t['ms'] * 1e3:.2f} us{simt}, plain "
              f"{t['plain_ms'] * 1e3:.2f} us, torch.bmm "
              f"{t['library_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}, "
              f"{100 * t['bound_ms'] / t['ms']:.1f} % of it)", flush=True)
        del sets
        free_device_memory()
    return {"name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:48",
            "max_abs_err": err_path, **timings["serve M=4"]}


def max_leaf_diff(a, b) -> float:
    """max |a - b| over two params trees' leaves (either device)."""
    from repro_torch.models.module import tree_leaves
    return max((x.cpu() - y.cpu()).abs().max().item()
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


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


def profiled(label: str, run, attention_tile: tuple | None = None,
             top_ops: int = 0, kernel: str | None = None):
    """``run()`` under torch.profiler: device time by kernel category,
    and the share of the run's wall time in which the card ran a kernel
    or a copy. With ``attention_tile`` (records shapes) the chunked
    attention's elementwise and softmax passes are split out of the
    non-GEMM time (``attention_us``). With ``top_ops`` (records shapes)
    the ``top_ops`` operators, by their input shapes, that took the most
    device time are listed. With ``kernel``, the device time and count
    of the kernels whose name holds it are printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=attention_tile is not None or top_ops > 0
                 ) as prof:
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
    if kernel is not None:
        mine = [e for e in dev if kernel in e.key]
        print(f"  {kernel} kernels: "
              f"{sum(e.self_device_time_total for e in mine) / 1e3:.2f} ms "
              f"over {sum(e.count for e in mine)} launches")
    if not top_ops:
        return
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and e.self_device_time_total]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top_ops]:
        print(f"    op {e.self_device_time_total / 1e3:8.2f} ms "
              f"x{e.count:<4d} {e.key} {e.input_shapes}")


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
    once a round (the eval's Fed2 unembedding, sgemm: fp32 at M = 64 x
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
                {"sgemm": rounds})
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
    |d| <= N eps sum_n w_n |x_n|; each plus one ulp of the result when
    it is written in a narrower dtype than fp32 (bf16: 2^-7 |result|;
    the two fp32 results may round to neighbouring values). local_step
    is held over the layout's raveled buffer (one buffer of the whole
    tree: the cohort itself for a tree of one dtype, the fp32 copy of a
    tree that mixes dtypes, or the bf16 local phase's shadow), each
    paired_fusion call over the segment it fuses (one call per dtype
    segment). Each leaf is compared in pieces of at most
    ``CHUNK`` columns, so the check's temporaries stay small beside a
    full-width round. The run calls the kernels as it would untapped
    (the plain versions work on copies), so no round-off carries from
    one call into the next comparison. ``fault`` plants a defect in the
    kernel route, to show that the bound catches it.
    ``worst[(kernel, leaf)]``: the largest |kernel - plain| / bound."""

    FAULTS = ("local_step without momentum",
              "paired_fusion with weight 0 0.1 % high")
    CHUNK = 1 << 24

    def __init__(self, layout, paths, fault=None):
        name = {s.path: p for s, p in zip(layout.slots, paths)}

        def pieces(slots):
            return [(name[s.path], lo, min(lo + self.CHUNK,
                                           s.offset + s.size))
                    for s in slots
                    for lo in range(s.offset, s.offset + s.size,
                                    self.CHUNK)]
        self.raveled = pieces(layout.raveled.slots)
        self.segments = {(seg.size, seg.dtype): pieces(seg.slots)
                         for seg in layout.segments}
        self.fault, self.worst = fault, {}
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
        ulp = 0.0 if p.dtype == torch.float32 else torch.finfo(p.dtype).eps
        for path, lo, hi in self.raveled:
            c = slice(lo, hi)
            wp, wv = local_step_ref(p0[:, c], v0[:, c], g[:, c], lr, mu)
            mag = mu * v0[:, c].float().abs() + g[:, c].float().abs()
            self._note("local_step", path, (v[:, c] - wv).float().abs(),
                       2 * eps * mag + ulp * wv.float().abs())
            self._note("local_step", path, (p[:, c] - wp).float().abs(),
                       2 * eps * (p0[:, c].float().abs() + 2 * lr * mag)
                       + ulp * wp.float().abs())
            del wp, wv, mag
        del p0, v0
        # the clones' blocks back to the card: at a full-width round they
        # are gigabytes, and left cached they strand the next step's
        # gradient buffers in fragments
        torch.cuda.empty_cache()
        self.calls["local_step"] += 1
        return p, v

    def paired_fusion(self, x, w, out=None):
        from repro_torch.kernels.paired_fusion import (paired_fusion,
                                                       paired_fusion_ref)
        pieces = self.segments.get((x.shape[1], x.dtype))
        assert pieces is not None, \
            "the LM round fuses each dtype segment in one call"
        wk = w
        if self.fault == self.FAULTS[1]:
            wk = w.clone()
            wk[0] *= 1.001
        res = paired_fusion(x, wk, out=out)
        eps = torch.finfo(torch.float32).eps
        for path, lo, hi in pieces:
            c = slice(lo, hi)
            ref = paired_fusion_ref(x[:, c], w).float()
            tol = x.shape[0] * eps * (x[:, c].float().abs()
                                      * w[:, None]).sum(0)
            if res.dtype != torch.float32:
                tol += torch.finfo(res.dtype).eps * ref.abs()
            self._note("paired_fusion", path, (res[c].float() - ref).abs(),
                       tol)
            del ref, tol
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


# The mixed-dtype LM federation: the full bf16 Mamba-2 1.3B under
# with_fed2(groups=4), whose a_log, dt_bias and d_skip stay fp32, under
# LM_FL (4 clients, 2 rounds of 4 steps of batch 8 at seq 64), one cohort
# buffer per dtype. Without remat under torch.func a client's
# activations stay alive through its backward: on an H100 80GB one
# vmapped call over the 4 clients ran out of memory in the 48-layer
# backward (69-77 GiB allocated), so the gradients are taken one client
# at a time (run_federated's grad_chunk: 64.6 GB at 48 layers, the four
# bf16 rows, their velocity and gradients 11 GB each). The
# local_step route ravels the tree into one fp32 (C, M) buffer as the
# reference's ravel_pytree does: that buffer, its velocity and its
# gradients are 12.0 GB each at 24 layers (21.9 GB at 48, over the card
# with the bf16 cohort), so it runs at 24 of 48. Zamba2 at
# HYBRID_FL_LAYERS, its fp32 cell's depth, in bf16: one fed2 round.
LM_MIXED_LAYERS = 48
LM_MIXED_KERNEL_LAYERS = 24
LM_MIXED_PARAMS = {48: (1_369_536_512, 9_216), 24: (749_158_400, 4_608),
                   12: (438_969_344, 2_304)}
LM_MIXED_CHUNK = 1
LM_MIXED_BUDGET_S = 120
# the round's axes on the mixed tree: the bf16 Mamba-2 at 12 of its 48
# layers (a cohort buffer of 3.5 GB, gradients of the whole cohort in
# one call), two rounds of each axis (label, method, FLConfig knobs,
# run_federated keywords), then one coordinate_median round at all 48
LM_AXES_LAYERS = 12
LM_AXES = (
    ("sign_flip(4)", "fedavg",
     dict(attack="sign_flip(4)", attack_fraction=0.25), {}),
    ("gauss_noise(0.01)", "fedavg",
     dict(attack="gauss_noise(0.01)", attack_fraction=0.25), {}),
    ("coordinate_median", "fed2", dict(robust="coordinate_median"), {}),
    ("trimmed_mean(0.25)", "fed2", dict(robust="trimmed_mean(0.25)"), {}),
    ("norm_clip(1.0)", "fed2", dict(robust="norm_clip(1.0)"), {}),
    ("codec int8", "fedavg", dict(codec="int8"), {}),
    ("bf16 local phase", "fed2", dict(compute_dtype="bfloat16"), {}),
    ("bf16 local phase --use-local-kernel", "fed2",
     dict(compute_dtype="bfloat16"), dict(use_local_kernel=True)),
    ("async buffer_k 2", "fedavg", dict(mode="async", buffer_k=2), {}),
    ("store mmap", "fedavg", dict(store="mmap", chunk_size=2), {}),
)
LM_AXES_BUDGET_S = 120


def mamba_mixed_config(layers):
    """The full-width Mamba-2 in its own bf16 (fp32 a_log, dt_bias and
    d_skip) under with_fed2(groups=4), cut to ``layers``."""
    import dataclasses

    from repro_torch.configs import mamba2_1_3b
    from repro_torch.configs.common import with_fed2
    return with_fed2(dataclasses.replace(mamba2_1_3b.full(),
                                         n_layers=layers), groups=4)


def mixed_header(cfg, init, depth) -> dict:
    """Prints the tree's parameters by dtype; returns {dtype: count}."""
    from repro_torch.models.module import tree_leaves
    counts = {}
    for t in tree_leaves(init):
        counts[t.dtype] = counts.get(t.dtype, 0) + t.numel()
    row = sum(n * d.itemsize for d, n in counts.items())
    print(f"  {cfg.arch_id}, {cfg.n_layers} of {depth} layers, Fed2 over "
          f"{cfg.fed2_groups} groups: " + ", ".join(
              f"{n:,} {str(d)[6:]}" for d, n in counts.items())
          + f" parameters, a row {row / 1e9:.2f} GB", flush=True)
    return counts


def mixed_leaf_checks(label, h, init, loss_of=None, l0=None,
                      through_bf16=False):
    """Every final leaf finite, on the card and in its init's dtype;
    every fp32 leaf moved, and the fp32 a_log off the bf16 grid (a bf16
    buffer would put it there). A bf16 leaf keeps its init where every
    element's update stays under half its ulp (a norm scale of 1 moves
    only by 2^-8 or more), as in the reference: those are printed, with
    their largest |value|. ``through_bf16``: the local phase ran in bf16
    (``compute_dtype``), which casts every leaf to bf16 as the reference
    does, so an fp32 leaf whose init is a bf16 value (d_skip's ones) may
    keep it like a bf16 leaf, and a_log is rounded to the bf16 grid in
    every client's row (their fp32 mean need not lie on it); a_log must
    still move. Prints s/round and the held-out loss."""
    from repro_torch.models.module import tree_leaves_with_path
    finite_params(h)
    leaves = tree_leaves_with_path(h["final_params"])
    starts = [t for _, t in tree_leaves_with_path(init)]
    assert [t.dtype for _, t in leaves] == [t.dtype for t in starts], \
        f"{label}: a leaf changed its dtype"
    moved = {p: (a.float() - b.float()).abs().max().item()
             for (p, a), b in zip(leaves, starts)}
    still = [(p, t.float().abs().max().item()) for p, t in leaves
             if moved[p] == 0]
    least = min((m, p) for (p, t), m in zip(leaves, moved.values())
                if t.dtype == torch.float32)
    a_log = h["final_params"]["blocks"]["mixer"]["a_log"]
    off = (a_log - a_log.bfloat16().float()).abs().max().item()
    w = h["wall"]
    per = [w[0]] + [b - a for a, b in zip(w, w[1:])]
    loss = "" if loss_of is None else (
        f"; held-out loss {l0:.5f} -> {loss_of(h['final_params']):.5f}")
    n_moved = len(leaves) - len(still)
    print(f"  -> s/round {[round(x, 3) for x in per]}; {n_moved} of "
          f"{len(leaves)} leaves moved (the least-moved fp32 leaf "
          f"{least[0]:.3g}, {least[1]}); a_log {a_log.dtype}, {off:.3g} "
          f"off the bf16 grid{loss}", flush=True)
    if still:
        print("     unmoved leaves (max |value|): " + ", ".join(
            f"{p} {v:.3g}" for p, v in still), flush=True)
    assert n_moved > 0, f"{label}: no leaf moved"
    assert a_log.dtype == torch.float32 and \
        moved["['blocks']/['mixer']/['a_log']"] > 0, \
        f"{label}: a_log did not move"
    if through_bf16:
        return
    assert all(t.dtype == torch.bfloat16 for p, t in leaves
               if moved[p] == 0), f"{label}: an fp32 leaf did not move"
    assert off > 1e-3, f"{label}: a_log went through bf16"


@contextlib.contextmanager
def shadow_buffers():
    """Records (shape, dtype) of the shadow each bf16 local phase copies
    back into the cohort's buffers (``RoundEngine._from_shadow``)."""
    from repro_torch.fl.engine import RoundEngine
    seen, real = [], RoundEngine._from_shadow

    def tap(self, work):
        seen.append((tuple(work.shape), work.dtype))
        return real(self, work)
    RoundEngine._from_shadow = tap
    try:
        yield seen
    finally:
        RoundEngine._from_shadow = real


@contextlib.contextmanager
def local_step_buffers():
    """Records (shape, dtypes of p, v and g) of every local_step call."""
    from repro_torch.fl import methods
    seen, real = [], methods.local_step

    def tap(p, v, g, *, lr, mu):
        seen.append((tuple(p.shape), (p.dtype, v.dtype, g.dtype)))
        return real(p, v, g, lr=lr, mu=mu)
    methods.local_step = tap
    try:
        yield seen
    finally:
        methods.local_step = real


def plus_ulp_any(tree):
    """Every element moved one ulp away from zero (bf16 through its bit
    pattern, fp32 by nextafter toward +inf as ``phase_lm_fl_parity``)."""
    from repro_torch.models.module import tree_map

    def one(t):
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16) + 1).view(torch.bfloat16)
        return torch.nextafter(t, torch.full_like(t, math.inf))
    return tree_map(one, tree)


def mixed_cohort_kernels(layout48, layout24):
    """The kernels at this path's new shapes, each against its plain
    version, with device times beside the bound and the library call:
    paired_fusion on the full-depth cohort's two segments (bf16 (4,
    1,369,536,512), 1e-2 as the check phase's bf16; fp32 (4, 9,216),
    1e-5), local_step on the 24-layer raveled fp32 buffer (4,
    749,163,008; 1e-6), grouped_matmul's wgmma route at the bf16 eval's
    unembedding, M = 64 x 64 (0.3). The gigabyte calls are timed by CUDA
    events around eager calls, the small ones by graph replay."""
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_ref)
    from repro_torch.kernels.local_step import local_step, local_step_ref
    from repro_torch.models.module import flat_parts
    gen = torch.Generator(device="cuda").manual_seed(11)
    n, lr, mu = LM_FL["population"], 0.01, 0.9
    segment_fusion_times(layout48, gen)

    m = layout24.size
    p, v, g = (flat_parts(layout24.raveled.alloc((n,), device="cuda"))[0]
               .normal_(0.0, sc, generator=gen) for sc in (1.0, 0.1, 1.0))
    assert p.is_contiguous(), "M is a multiple of 64: no row padding"
    name = f"local_step fp32 ({n}, {m:,})"
    p0, v0 = p.clone(), v.clone()
    local_step(p, v, g, lr=lr, mu=mu)
    err, chunk = 0.0, 1 << 26
    for lo in range(0, m, chunk):
        c = slice(lo, lo + chunk)
        wp, wv = local_step_ref(p0[:, c], v0[:, c], g[:, c], lr, mu)
        err = max(err, (p[:, c] - wp).abs().max().item(),
                  (v[:, c] - wv).abs().max().item())
    print(f"  {name}: max_abs_err {err:.3g} (tol 1e-06) "
          f"{'ok' if err <= 1e-6 else 'FAIL'}", flush=True)
    assert err <= 1e-6, f"{name}: kernel disagrees with its plain version"
    del p0, v0, wp, wv
    free_device_memory()
    t = {"ms": event_ms(lambda: local_step(p, v, g, lr=lr, mu=mu), 5),
         "plain_ms": event_ms(lambda: local_step_ref(p, v, g, lr, mu), 3),
         "library_ms": event_ms(lambda: torch._fused_sgd_(
             [p], [g], [v], weight_decay=0.0, momentum=mu, lr=lr,
             dampening=0.0, nesterov=False, maximize=False,
             is_first_step=False), 5)}
    t["bound_ms"], t["bound_by"] = bound(5 * n * m * 4, 4 * n * m)
    kernel_line(name, t)
    del p, v, g
    free_device_memory()

    bf16 = torch.bfloat16
    mm, gg, k = 64 * 64, 4, 2048 // 4
    nn = next(s.shape[2] for s in layout48.slots if s.path == ("unembed", "w"))
    assert gm.route(mm, gg, k, nn, bf16, 0, 0) == "wgmma"
    x, wt, _ = gmm_inputs((64, 64), gg, k, nn, bf16, gen)
    before = dict(grouped_matmul.route_launches)
    got = grouped_matmul(x, wt)
    assert grouped_matmul.route_launches["wgmma"] == before["wgmma"] + 1
    name = f"grouped_matmul wgmma bf16 ({gg}, {k}, {nn}) M = {mm}"
    check(name, got, grouped_matmul_ref(x, wt), 0.3)
    del x, wt, got
    w_bytes = gg * k * nn * 2
    sets = [gmm_inputs((mm,), gg, k, nn, bf16, gen)[:2]
            for _ in range(copies_for(w_bytes))]
    reps = max(10, len(sets))
    t = {"ms": time_ms([lambda a=a: grouped_matmul(*a) for a in sets], reps),
         "plain_ms": time_ms([lambda a=a: grouped_matmul_ref(*a)
                              for a in sets], reps),
         "library_ms": time_ms([lambda a=a: torch.bmm(
             a[0].view(mm, gg, k).transpose(0, 1), a[1]) for a in sets],
             reps)}
    t["bound_ms"], t["bound_by"] = bound(
        w_bytes + 2 * mm * gg * (k + nn), 2 * mm * gg * k * nn, BF16_FLOPS)
    kernel_line(name, t)
    del sets
    free_device_memory()


def kernel_line(name, t):
    """Prints a kernel's device time beside its plain version's, the
    library call's and its bound."""
    print(f"  {name}: {t['ms'] * 1e3:.2f} us, plain "
          f"{t['plain_ms'] * 1e3:.2f} us, library "
          f"{t['library_ms'] * 1e3:.2f} us, bound "
          f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})", flush=True)


def segment_fusion_times(layout, gen):
    """paired_fusion on a 4-client cohort's buffer of each dtype segment
    of ``layout`` (the engine's row stride), each against its plain
    version (fp32 1e-5; bf16 within one ulp of the result,
    ``fusion_within``), timed beside the plain version, ``torch.mv`` and
    the bound: by CUDA events around eager calls past L2, else by graph
    replay."""
    from repro_torch.kernels.paired_fusion import (paired_fusion,
                                                   paired_fusion_ref)
    from repro_torch.models.module import flat_parts
    n = LM_FL["population"]
    for seg, x in zip(layout.segments,
                      flat_parts(layout.alloc((n,), device="cuda"))):
        x.normal_(generator=gen)
        m, esz = seg.size, seg.dtype.itemsize
        w = torch.rand(n, generator=gen, device="cuda") + 0.1
        w = w / w.sum()
        name = f"paired_fusion {str(seg.dtype)[6:]} ({n}, {m:,})"
        got = paired_fusion(x, w)
        if seg.dtype == torch.float32:
            check(name, got, paired_fusion_ref(x, w), 1e-5)
        else:
            fusion_within(name, x, w, got)
        del got
        if m * n * esz > L2_BYTES:
            t = {"ms": event_ms(lambda: paired_fusion(x, w), 5),
                 "plain_ms": event_ms(lambda: paired_fusion_ref(x, w), 3),
                 "library_ms": event_ms(
                     lambda: torch.mv(x.t(), w.to(x.dtype)), 5)}
        else:
            xs = [x] + [x.clone().normal_(generator=gen)
                        for _ in range(copies_for(n * m * esz) - 1)]
            reps = max(200, len(xs))
            t = {"ms": time_ms([lambda a=a: paired_fusion(a, w)
                                for a in xs], reps),
                 "plain_ms": time_ms([lambda a=a: paired_fusion_ref(a, w)
                                      for a in xs], reps),
                 "library_ms": time_ms([lambda a=a: torch.mv(a.t(), w)
                                        for a in xs], reps)}
            del xs
        t["bound_ms"], t["bound_by"] = bound(n * m * esz + m * esz + n * 4,
                                             2 * n * m)
        kernel_line(name, t)
        del x
    free_device_memory()


def fusion_within(name, x, w, got, chunk: int = 1 << 26):
    """A bf16 fusion ``got`` against paired_fusion_ref element by
    element, within one ulp of the result (2^-7 |ref|: the two fp32 sums
    may round to neighbouring bf16 values, and at |result| >= 2 one ulp
    passes the check phase's absolute 1e-2) plus the fp32 sums' own
    round-off (N eps sum_n w_n |x_n|), in column chunks so the
    comparison's temporaries stay small beside a 11 GB cohort."""
    from repro_torch.kernels.paired_fusion import paired_fusion_ref
    eps, n = torch.finfo(torch.float32).eps, x.shape[0]
    err = worst = 0.0
    for lo in range(0, x.shape[1], chunk):
        c = slice(lo, lo + chunk)
        ref = paired_fusion_ref(x[:, c], w).float()
        d = (got[c].float() - ref).abs()
        tol = (torch.finfo(x.dtype).eps * ref.abs()
               + n * eps * (x[:, c].float().abs() * w[:, None]).sum(0))
        err = max(err, d.max().item())
        worst = max(worst, torch.where(d == 0, 0.0, d / tol).max().item())
    print(f"  {name}: max_abs_err {err:.3g}, worst {worst:.3g} of one ulp "
          f"of the result {'ok' if worst <= 1.0 else 'FAIL'}", flush=True)
    assert worst <= 1.0, f"{name}: kernel disagrees with its plain version"


def phase_lm_fl_mixed():
    """run_federated(lm_task) on the full bf16 Mamba-2 (fp32 a_log,
    dt_bias, d_skip), one cohort buffer per dtype:

    - the plain local route at all 48 layers, fedavg and fed2, one
      round of LM_FL's each, counted: paired_fusion 2 a round (one a
      dtype segment),
      grouped_matmul 1 a round on the wgmma route (the eval's bf16
      unembedding at M = 64 x 64), local_step 0; peak memory and s/round;
      every leaf kept its dtype, every fp32 leaf moved (bf16 leaves move
      where an update passes half their ulp), a_log off the bf16 grid;
    - the kernels at this path's new shapes (``mixed_cohort_kernels``);
    - the local_step route at 24 layers, one round of fedavg and one of
      fed2, counted: local_step once a step, each on one fp32 (4, M)
      buffer of the whole tree; in the fed2 round every kernel call held
      against its plain version (``LmKernelTaps``, per segment and on
      the raveled buffer), both planted faults caught (two-step rounds),
      and the round held against the plain route within the spread of a
      second plain run and of a one-ulp change of the init (as
      ``phase_lm_fl_parity``);
    - zamba2-2.7b in bf16 at HYBRID_FL_LAYERS: one fed2 round, counted.
    """
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.fl.runtime import FLConfig, lm_task, run_federated
    from repro_torch.models.module import (FlatLayout, tree_leaves,
                                           tree_leaves_with_path)
    t0 = time.time()
    bf16, f32 = torch.bfloat16, torch.float32
    steps = LM_FL["steps_per_epoch"]

    cfg, parts, get_batch, test, init = lm_fl_inputs(
        mamba_mixed_config(LM_MIXED_LAYERS))
    counts = mixed_header(cfg, init, SERVE_LAYERS)
    assert (counts[bf16], counts[f32]) == LM_MIXED_PARAMS[LM_MIXED_LAYERS]
    layout48 = FlatLayout(init)
    task, loss_of = lm_task(cfg), lm_held_out_loss(cfg, test)
    l0 = loss_of(init)
    for method in ("fedavg", "fed2"):
        fl = FLConfig(method=method, **{**LM_FL, "rounds": 1})
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        label = f"lm_task {method}, bf16, {LM_MIXED_LAYERS} layers"
        h, _ = counted(
            label,
            lambda: run_federated(task, fl, parts, get_batch, test,
                                  device="cuda", init_params=init,
                                  grad_chunk=LM_MIXED_CHUNK),
            {"paired_fusion": 2, "grouped_matmul": 1}, {"wgmma": 1})
        print(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
              " GB", flush=True)
        mixed_leaf_checks(label, h, init, loss_of, l0)
        del h
    del init, task, loss_of
    free_device_memory()

    cfg, parts, get_batch, test, init = lm_fl_inputs(
        mamba_mixed_config(LM_MIXED_KERNEL_LAYERS))
    counts = mixed_header(cfg, init, SERVE_LAYERS)
    assert (counts[bf16], counts[f32]) == \
        LM_MIXED_PARAMS[LM_MIXED_KERNEL_LAYERS]
    layout = FlatLayout(init)
    with tf32_off():
        mixed_cohort_kernels(layout48, layout)
    task, loss_of = lm_task(cfg), lm_held_out_loss(cfg, test)
    l0 = loss_of(init)
    one_buffer = [((LM_FL["population"], layout.size), (f32,) * 3)]
    paths = [p for p, _ in tree_leaves_with_path(init)]
    fl1 = {**LM_FL, "rounds": 1}

    def one_round(start, kernels, **over):
        h = run_federated(task, FLConfig(method="fed2", **{**fl1, **over}),
                          parts, get_batch, test, use_kernel=kernels,
                          use_local_kernel=kernels, device="cuda",
                          init_params=start, grad_chunk=LM_MIXED_CHUNK)
        return [t.clone() for t in tree_leaves(h["final_params"])]

    out = {}
    with tf32_off():
        for method in ("fedavg", "fed2"):
            # fed2's round runs under the taps: every kernel call held
            # against its plain version on the call's own inputs
            fl = FLConfig(method=method, **fl1)
            free_device_memory()
            torch.cuda.reset_peak_memory_stats()
            label = (f"lm_task {method} --use-local-kernel, bf16, "
                     f"{LM_MIXED_KERNEL_LAYERS} layers, 1 round")
            tapped = LmKernelTaps(layout, paths) if method == "fed2" else None
            with tapped or contextlib.nullcontext(), \
                    local_step_buffers() as seen:
                h, _ = counted(
                    label,
                    lambda: run_federated(task, fl, parts, get_batch, test,
                                          use_local_kernel=True,
                                          device="cuda", init_params=init,
                                          grad_chunk=LM_MIXED_CHUNK),
                    {"paired_fusion": 2, "grouped_matmul": 1,
                     "local_step": steps}, {"wgmma": 1})
            assert seen == one_buffer * steps, seen[:2]
            print(f"  local_step on one {seen[0][0]} fp32 buffer of the "
                  f"whole tree, {len(seen)} calls; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
                  flush=True)
            mixed_leaf_checks(label, h, init, loss_of, l0)
            if method == "fed2":
                out["kernels"] = [t.clone()
                                  for t in tree_leaves(h["final_params"])]
            del h
        worst = tapped.report("mixed LM round, kernels on the round's own "
                              "inputs")
        assert tapped.calls == {"local_step": steps, "paired_fusion": 2}, \
            tapped.calls
        assert max(worst.values()) <= 1.0, \
            "a kernel call of the mixed LM round exceeds its round-off bound"
        # each planted fault in a two-step round (the second step is the
        # first with a velocity for the momentum fault to drop)
        for fault, kernel in zip(LmKernelTaps.FAULTS,
                                 ("local_step", "paired_fusion")):
            with LmKernelTaps(layout, paths, fault) as taps:
                one_round(init, True, steps_per_epoch=2)
            r = taps.report(f"planted fault, {fault}", (kernel,))[kernel]
            print(f"  planted fault: {fault}: "
                  f"{'caught' if r > 1.0 else 'MISSED'}", flush=True)
            assert r > 1.0, f"the taps miss a planted fault: {fault}"
        free_device_memory()
        out["plain"] = one_round(init, False)
        out["plain again"] = one_round(init, False)
        out["plain, init + 1 ulp"] = one_round(plus_ulp_any(init), False)
    upd = [(a.float() - b.float()).abs().max().item()
           for a, b in zip(out["plain"], tree_leaves(init))]
    d = {label: [(a.float() - b.float()).abs().max().item()
                 for a, b in zip(out[label], out["plain"])]
         for label in ("kernels", "plain again", "plain, init + 1 ulp")}
    print("  one fed2 round of the mixed LM, max |dparam| against the "
          "plain route, per leaf (its update beside it):")
    print(f"    {'leaf':<40s} {'dtype':>8s} {'update':>9s} {'kernels':>9s} "
          f"{'again':>9s} {'1 ulp':>9s}")
    for i, (path, t) in enumerate(zip(paths, out["plain"])):
        print(f"    {path:<40s} {str(t.dtype)[6:]:>8s} {upd[i]:9.3g} "
              f"{d['kernels'][i]:9.3g} {d['plain again'][i]:9.3g} "
              f"{d['plain, init + 1 ulp'][i]:9.3g}")
    lim = max(max(d["plain again"]), max(d["plain, init + 1 ulp"]))
    ok = max(d["kernels"]) <= lim
    print(f"  kernels {max(d['kernels']):.3g} (limit {lim:.3g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    assert ok, "the mixed LM round's kernel routes drift from the plain " \
        "routes beyond round-off in its inputs"
    del out, init, task, loss_of
    free_device_memory()

    zcfg = dataclasses.replace(with_fed2(get_config("zamba2-2.7b"), groups=4),
                               n_layers=HYBRID_FL_LAYERS)
    zcfg, parts, get_batch, test, init = lm_fl_inputs(zcfg)
    mixed_header(zcfg, init, 54)
    fl = FLConfig(method="fed2", **{**LM_FL, "rounds": 1})
    label = f"zamba2 lm_task fed2, bf16, {HYBRID_FL_LAYERS} layers"
    h, _ = counted(label, lambda: run_federated(
        lm_task(zcfg), fl, parts, get_batch, test, device="cuda",
        init_params=init), {"paired_fusion": 2, "grouped_matmul": 1},
        {"wgmma": 1})
    mixed_leaf_checks(label, h, init)
    del h, init
    free_device_memory()
    took = time.time() - t0
    print(f"  the phase took {took:.1f} s (budget {LM_MIXED_BUDGET_S} s)",
          flush=True)


def axes_cohort_kernels(layout):
    """The kernels at the axes' new shapes (the 12-layer mixed tree),
    each against its plain version, with device times beside the bound
    and the library call: paired_fusion on each dtype segment's (4, M_d)
    cohort buffer (``segment_fusion_times``), and local_step on the bf16
    local phase's shadow, ONE bf16 (4, M) buffer of the whole tree,
    against local_step_ref within one bf16 ulp of its result plus the
    fp32 bound of ``LmKernelTaps`` (timed by CUDA events around eager
    calls; the library call ``torch._fused_sgd_`` on the same bf16
    buffers)."""
    from repro_torch.kernels.local_step import local_step, local_step_ref
    gen = torch.Generator(device="cuda").manual_seed(13)
    n, lr, mu, bf16 = LM_FL["population"], 0.01, 0.9, torch.bfloat16
    segment_fusion_times(layout, gen)
    m = layout.size
    p, v, g = (layout.raveled.alloc((n,), device="cuda", dtype=bf16)
               .normal_(0.0, sc, generator=gen) for sc in (1.0, 0.1, 1.0))
    name = f"local_step bf16 ({n}, {m:,})"
    p0, v0 = p.clone(), v.clone()
    local_step(p, v, g, lr=lr, mu=mu)
    eps, ulp, worst = (torch.finfo(torch.float32).eps,
                       torch.finfo(bf16).eps, 0.0)
    err, chunk = 0.0, 1 << 26
    for lo in range(0, m, chunk):
        c = slice(lo, lo + chunk)
        wp, wv = local_step_ref(p0[:, c], v0[:, c], g[:, c], lr, mu)
        mag = mu * v0[:, c].float().abs() + g[:, c].float().abs()
        for got, want, tol in (
                (v[:, c], wv, 2 * eps * mag + ulp * wv.float().abs()),
                (p[:, c], wp, 2 * eps * (p0[:, c].float().abs()
                                         + 2 * lr * mag)
                 + ulp * wp.float().abs())):
            d = (got.float() - want.float()).abs()
            err = max(err, d.max().item())
            worst = max(worst,
                        torch.where(d == 0, 0.0, d / tol).max().item())
        del wp, wv, mag
    print(f"  {name}: max_abs_err {err:.3g}, worst {worst:.3g} of one bf16 "
          f"ulp of the result {'ok' if worst <= 1.0 else 'FAIL'}",
          flush=True)
    assert worst <= 1.0, f"{name}: kernel disagrees with its plain version"
    del p0, v0
    free_device_memory()
    t = {"ms": event_ms(lambda: local_step(p, v, g, lr=lr, mu=mu), 5),
         "plain_ms": event_ms(lambda: local_step_ref(p, v, g, lr, mu), 3),
         "library_ms": event_ms(lambda: torch._fused_sgd_(
             [p], [g], [v], weight_decay=0.0, momentum=mu, lr=lr,
             dampening=0.0, nesterov=False, maximize=False,
             is_first_step=False), 5)}
    t["bound_ms"], t["bound_by"] = bound(5 * n * m * 2, 4 * n * m)
    kernel_line(name, t)
    del p, v, g
    free_device_memory()


def phase_lm_fl_mixed_axes():
    """run_federated(lm_task) on the bf16 Mamba-2 (fp32 a_log, dt_bias,
    d_skip) at full width and LM_AXES_LAYERS of its 48 layers, 4 clients,
    LM_FL's 2 rounds under each of the round's axes (``LM_AXES``), each
    counted: paired_fusion 2 a round or event (one a dtype segment; none
    under a reducing rule, which has no kernel), grouped_matmul 1 a round
    or event on wgmma (the eval), local_step once a step on ONE bf16 (4,
    M) buffer under the bf16 local phase with the flag; every leaf kept
    its dtype, every fp32 leaf finite and moved (``mixed_leaf_checks``).
    Then: the kernels at these shapes (``axes_cohort_kernels``); one
    bf16-shadow local_step round under ``LmKernelTaps``, every call held
    against its plain version, and a planted fault (local_step without
    momentum) caught; one coordinate_median round at all 48 layers
    (gradients one client a call), its peak memory printed beside the
    whole-buffer sort it replaces."""
    from repro_torch.fl.robust import SORT_CHUNK
    from repro_torch.fl.runtime import FLConfig, lm_task, run_federated
    from repro_torch.models.module import FlatLayout, tree_leaves_with_path
    t0 = time.time()
    bf16, f32 = torch.bfloat16, torch.float32
    rounds, steps = LM_FL["rounds"], LM_FL["steps_per_epoch"]
    cfg, parts, get_batch, test, init = lm_fl_inputs(
        mamba_mixed_config(LM_AXES_LAYERS))
    counts = mixed_header(cfg, init, SERVE_LAYERS)
    assert (counts[bf16], counts[f32]) == LM_MIXED_PARAMS[LM_AXES_LAYERS]
    layout = FlatLayout(init)
    task, loss_of = lm_task(cfg), lm_held_out_loss(cfg, test)
    l0 = loss_of(init)
    shadow = [((LM_FL["population"], layout.size), (bf16,) * 3)]
    for label, method, knobs, kw in LM_AXES:
        fl = FLConfig(method=method, **LM_FL, **knobs)
        reduces = "robust" in knobs and "norm_clip" not in knobs["robust"]
        expect = {"paired_fusion": 0 if reduces else 2 * rounds,
                  "grouped_matmul": rounds,
                  "local_step": steps * rounds if kw else 0}
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        label = f"lm_task {method} {label}, {LM_AXES_LAYERS} layers"
        with local_step_buffers() as seen, shadow_buffers() as shadows:
            h, _ = counted(
                label,
                lambda: run_federated(task, fl, parts, get_batch, test,
                                      device="cuda", init_params=init,
                                      **kw),
                expect, {"wgmma": rounds})
        if kw:
            assert seen == shadow * steps * rounds, seen[:2]
            print(f"  local_step on one {seen[0][0]} bf16 buffer of the "
                  f"whole tree, {len(seen)} calls", flush=True)
        if "compute_dtype" in knobs:
            assert shadows == [(shadow[0][0], bf16)] * rounds, shadows
            print(f"  the local phase in one {shadows[0][0]} bf16 shadow "
                  f"of the whole tree, {len(shadows)} rounds", flush=True)
        else:
            assert not shadows, shadows
        print(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
              " GB", flush=True)
        mixed_leaf_checks(label, h, init, loss_of, l0,
                          through_bf16="compute_dtype" in knobs)
        del h
    free_device_memory()
    with tf32_off():
        axes_cohort_kernels(layout)
        paths = [p for p, _ in tree_leaves_with_path(init)]
        fl = FLConfig(method="fed2", compute_dtype="bfloat16",
                      **{**LM_FL, "rounds": 1})

        def tapped_round(fault=None):
            with LmKernelTaps(layout, paths, fault) as taps:
                run_federated(task, fl, parts, get_batch, test,
                              device="cuda", init_params=init,
                              use_local_kernel=True)
            return taps
        taps = tapped_round()
        worst = taps.report("bf16 local phase round, kernels on the "
                            "round's own inputs")
        assert taps.calls == {"local_step": steps, "paired_fusion": 2}, \
            taps.calls
        assert max(worst.values()) <= 1.0, \
            "a kernel call of the bf16 local phase exceeds its bound"
        fault = LmKernelTaps.FAULTS[0]
        r = tapped_round(fault).report(f"planted fault, {fault}",
                                       ("local_step",))["local_step"]
        print(f"  planted fault: {fault}: "
              f"{'caught' if r > 1.0 else 'MISSED'}", flush=True)
        assert r > 1.0, f"the taps miss a planted fault: {fault}"
    del init, task, loss_of
    free_device_memory()

    cfg, parts, get_batch, test, init = lm_fl_inputs(
        mamba_mixed_config(LM_MIXED_LAYERS))
    counts = mixed_header(cfg, init, SERVE_LAYERS)
    n, m = LM_FL["population"], counts[bf16]
    fl = FLConfig(method="fed2", robust="coordinate_median",
                  **{**LM_FL, "rounds": 1})
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    label = f"lm_task fed2 coordinate_median, {LM_MIXED_LAYERS} layers"
    h, _ = counted(label, lambda: run_federated(
        lm_task(cfg), fl, parts, get_batch, test, device="cuda",
        init_params=init, grad_chunk=LM_MIXED_CHUNK),
        {"grouped_matmul": 1}, {"wgmma": 1})
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(the sort in chunks of {SORT_CHUNK:,} columns; one "
          f"whole-buffer sort of the ({n}, {m:,}) bf16 segment would hold "
          f"{n * m * 4 / 1e9:.2f} GB of fp32 values and "
          f"{n * m * 8 / 1e9:.2f} GB of int64 order besides)", flush=True)
    mixed_leaf_checks(label, h, init)
    del h, init
    free_device_memory()
    took = time.time() - t0
    print(f"  the phase took {took:.1f} s (budget {LM_AXES_BUDGET_S} s)",
          flush=True)


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
        h, _ = forward(params, cfg, toks)
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
        h, _ = forward(params, ccfg, toks[:bc])
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
    Fed2 over 4 groups, 6 of 16 layers, 4 decoupled): the kernels on its
    (4, M) cohort buffer (``lm_cohort_kernels``), the counted runs
    (``lm_fl_runs``: fedavg and fed2, with and without
    --use-local-kernel), then one tapped fed2 round
    (``lm_tapped_round``)."""
    from repro_torch.fl.runtime import lm_task
    cfg, parts, get_batch, test, init = lm_fl_inputs(dense_fl_config())
    lm_fl_header(cfg, init, DENSE_LAYERS)
    with tf32_off():
        lm_cohort_kernels(init)
    task = lm_task(cfg)
    loss_of = lm_held_out_loss(cfg, test)
    losses = lm_fl_runs(task, parts, get_batch, test, init, loss_of)
    lm_tapped_round("dense LM round", task, parts, get_batch, test, init,
                    loss_of, losses)
    del init
    free_device_memory()


def lm_tapped_round(label, task, parts, get_batch, test, init, loss_of,
                    losses):
    """One fed2 round with --use-local-kernel (TF32 off) in which every
    local_step and paired_fusion call is held against its plain version
    on that call's own inputs (``LmKernelTaps``: each within its
    round-off bound, 4 and 1 calls), and the held-out loss after each
    fed2 round (``losses``: ``lm_fl_runs``') falls."""
    from repro_torch.fl.runtime import FLConfig, run_federated
    from repro_torch.models.module import FlatLayout, tree_leaves_with_path
    layout = FlatLayout(init)
    paths = [p for p, _ in tree_leaves_with_path(init)]
    fl = FLConfig(method="fed2", **{**LM_FL, "rounds": 1})
    with tf32_off(), LmKernelTaps(layout, paths) as taps:
        h = run_federated(task, fl, parts, get_batch, test,
                          use_local_kernel=True, device="cuda",
                          init_params=init)
    worst = taps.report(f"{label}, kernels on the round's own inputs")
    assert taps.calls == {"local_step": LM_FL["steps_per_epoch"],
                          "paired_fusion": 1}, taps.calls
    assert max(worst.values()) <= 1.0, \
        f"a kernel call of the {label} exceeds its round-off bound"
    l0, l1 = losses["init"], loss_of(h["final_params"])
    l2 = losses["lm_task fed2 --use-local-kernel"]
    print(f"  held-out loss, fed2 with the flag: init {l0:.5f}, round 1 "
          f"{l1:.5f}, round 2 {l2:.5f}", flush=True)
    assert l0 > l1 > l2, "the held-out loss does not fall round by round"
    del h
    free_device_memory()


# ---------------------------------------------------------------------------
# the other dense configs (Qwen2-7B, H2O-Danube-1.8B, StableLM-2-12B) and
# the hybrid (Zamba2-2.7B)
# ---------------------------------------------------------------------------


def kv_bytes(cfg, batch: int, max_len: int) -> int:
    """Bytes of a dense LM's or a hybrid's decode cache at ``batch`` x
    ``max_len`` (the cache's own slots: a window caps them; a hybrid's
    fp32 SSM states too)."""
    esz = cfg.dtype.itemsize
    if cfg.family == "hybrid":
        slots = min(max_len, 4096)
        n_kv = cfg.n_layers // cfg.hybrid_attn_every
        ssm = cfg.n_layers * batch * cfg.ssm.n_heads * cfg.ssm.headdim \
            * cfg.ssm.d_state * 4
    else:
        slots = min(max_len, cfg.window) if cfg.window else max_len
        n_kv, ssm = cfg.n_layers, 0
    return 2 * n_kv * batch * slots * cfg.n_kv_heads * cfg.head_dim * esz \
        + ssm


def phase_other_serve():
    """Each of OTHER_ARCHS at full width through the serving CLI (batch
    4, 32 + 16 tokens), without and with --fed2-groups 8, then Fed2 at
    OTHER_BIG_BATCH over a 2048-slot cache; counted: grouped_matmul
    OTHER_GMM_PER_STEP a Fed2 step (stream at batch 4, wgmma above) and
    never without Fed2; ssd_update OTHER_SSD_PER_STEP a step. serve_cli
    checks each parameter count against the reference's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    d = serve.parse_args([])
    steps = d.prompt_len + d.gen
    for arch in OTHER_ARCHS:
        gmm, ssd = OTHER_GMM_PER_STEP[arch], OTHER_SSD_PER_STEP[arch]
        a = ("--arch", arch, "--full")
        counted(f"serve --arch {arch} --full",
                lambda: serve_cli(*a), {"ssd_update": ssd * steps})
        counted(f"serve --arch {arch} --full --fed2-groups 8",
                lambda: serve_cli(*a, "--fed2-groups", "8"),
                {"ssd_update": ssd * steps, "grouped_matmul": gmm * steps},
                {"stream": gmm * steps})
        big = ("--batch", str(OTHER_BIG_BATCH[arch]), *OTHER_SERVE_BIG)
        b = serve.parse_args(list(big))
        n = b.prompt_len + b.gen
        peak, _ = counted(
            f"serve --arch {arch} --full --fed2-groups 8 " + " ".join(big),
            lambda: serve_cli(*a, "--fed2-groups", "8", *big),
            {"ssd_update": ssd * n, "grouped_matmul": gmm * n},
            {"wgmma": gmm * n})
        cache = kv_bytes(get_config(arch), b.batch, b.max_len)
        print(f"  decode cache at batch {b.batch} x {b.max_len} positions: "
              f"{cache / 1e9:.2f} GB; peak {peak / 1e9:.2f} GB", flush=True)
        assert peak > cache, f"{arch}: the large-batch run did not hold " \
            "its cache"


def decode_kernels_vs_plain(label, cfg, expect, routes, steps=16, bs=4):
    """``steps`` tokens through decode_step with the kernels and with the
    plain versions (no launch), from one init (seed 1) and two empty
    caches: logits within PARITY_LOGIT_ATOL, every float cache leaf
    within PARITY_STATE_RTOL of its largest value, slot positions equal.
    ``expect``/``routes``: the kernel route's launches per step."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import decode_step, init_cache
    from repro_torch.models.module import tree_leaves_with_path
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(1),
                             cfg)
    toks = torch.randint(0, cfg.vocab, (bs, steps), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2))

    @torch.no_grad()
    def decoded(use_kernel):
        cache = init_cache(cfg, bs, steps, device="cuda")
        logits = [decode_step(params, cfg, cache, toks[:, t:t + 1], t,
                              use_kernel=use_kernel)[0]
                  for t in range(steps)]
        return torch.cat(logits, 1), cache

    (on, c_on), _ = counted(f"{label} decode parity, kernels",
                            lambda: decoded(True),
                            {k: v * steps for k, v in expect.items()},
                            {k: v * steps for k, v in routes.items()})
    (off, c_off), _ = counted(f"{label} decode parity, plain versions",
                              lambda: decoded(False), {})
    err = (on - off).abs().max().item()
    mag = off.abs().max().item()
    worst, where = 0.0, ""
    for (path, a), (_, b) in zip(tree_leaves_with_path(c_on),
                                 tree_leaves_with_path(c_off)):
        if not a.is_floating_point():
            assert torch.equal(a, b), f"{label}: {path} differs"
            continue
        rel = ((a - b).abs().max() / b.abs().max()).item()
        if rel > worst:
            worst, where = rel, path
    ok = err <= PARITY_LOGIT_ATOL and worst <= PARITY_STATE_RTOL
    print(f"  {label}: {steps} tokens, batch {bs}, fp32: max |dlogits| "
          f"{err:.3g} (limit {PARITY_LOGIT_ATOL:g}; max |logit| {mag:.3g});"
          f" caches, worst leaf {worst:.3g} of its largest value at "
          f"{where} (limit {PARITY_STATE_RTOL:g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    assert ok, f"{label}: decode with the kernels drifts from the plain " \
        "versions"
    del params, on, off, c_on, c_off
    free_device_memory()


def chunked_vs_decode(label, cfg, n, bs, limit, expect, routes,
                      state_rtol=None):
    """The chunked forward over ``n`` tokens against ``n`` decode steps
    (kernels on, ``expect``/``routes`` launches a step), from one init
    (seed 1), fp32: logits at every position within ``limit``; with
    ``state_rtol`` (a hybrid) each SSM layer's state after the last
    token (from the forward's blocks again, one by one) within that
    share of its largest value."""
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import decode_step, forward, init_cache
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(1),
                             cfg)
    toks = torch.randint(0, cfg.vocab, (bs, n), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(3))

    @torch.no_grad()
    def chunked():
        h, _ = forward(params, cfg, toks)
        return tfm.unembed_apply(params["unembed"], h, cfg,
                                 use_kernel=False)

    @torch.no_grad()
    def decoded():
        cache = init_cache(cfg, bs, n, device="cuda")
        logits = [decode_step(params, cfg, cache, toks[:, t:t + 1], t)[0]
                  for t in range(n)]
        return torch.cat(logits, 1), cache

    t0 = time.time()
    want, _ = counted(f"{label} chunked forward", chunked, {})
    t1 = time.time()
    (got, cache), _ = counted(f"{label}: {n} decode steps", decoded,
                              {k: v * n for k, v in expect.items()},
                              {k: v * n for k, v in routes.items()})
    t2 = time.time()
    err = (got - want).abs().max().item()
    mag = want.abs().max().item()
    ok = err <= limit
    line = (f"  {label}: batch {bs}, {n} tokens, fp32: chunked forward "
            f"{t1 - t0:.2f} s, decode {t2 - t1:.2f} s; max |dlogits| "
            f"{err:.3g} (limit {limit:g}; max |logit| {mag:.3g})")
    if state_rtol is not None:
        from repro_torch.models.layers import embed_apply
        from repro_torch.models.module import tree_map
        with torch.no_grad():
            x, rel = embed_apply(params["embed"], toks), 0.0
            k = cfg.hybrid_attn_every
            for i in range(cfg.n_layers):
                lp = tree_map(lambda t: t[i], params["blocks"])
                y, st = ssm.mamba2_apply(
                    lp["mixer"], tfm._norm_apply(cfg, lp["ln1"], x),
                    cfg.ssm, with_state=True)
                x = x + y
                if (i + 1) % k == 0:
                    x, _ = tfm.block_apply(params["shared_attn"], x, cfg,
                                           kind="attn_ffn",
                                           positions=torch.arange(
                                               n, device="cuda"))
                rel = max(rel, ((cache["blocks"]["ssm"][i] - st).abs().max()
                                / st.abs().max()).item())
        line += (f"; SSM states, worst layer {rel:.3g} of its largest "
                 f"value (limit {state_rtol:g})")
        ok = ok and rel <= state_rtol
    print(line + (" ok" if ok else " FAIL"), flush=True)
    assert ok, f"{label}: the chunked forward and the decode disagree"
    del params, got, want, cache
    free_device_memory()


def phase_other_decode_parity():
    """fp32, TF32 off: qwen2-7b and zamba2-2.7b with Fed2 (groups 8) at
    full width and depth, 16 decode steps with the kernels against the
    plain versions; zamba2's chunked forward (q 128 / kv 256 attention
    chunks, SSD chunks of 256) against 300 decode steps within the
    Mamba-2 limits; danube cut to DANUBE_WRAP_LAYERS layers, its window
    of 4096 kept, decoded DANUBE_WRAP_LEN tokens past the window against
    its chunked forward."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    f32 = torch.float32
    qwen = with_fed2(get_config("qwen2-7b", dtype=f32), groups=8)
    g = OTHER_GMM_PER_STEP["qwen2-7b"]
    decode_kernels_vs_plain("qwen2-7b", qwen, {"grouped_matmul": g},
                            {"stream": g})
    zamba = with_fed2(get_config("zamba2-2.7b", dtype=f32), groups=8)
    ssd = {"ssd_update": OTHER_SSD_PER_STEP["zamba2-2.7b"],
           "grouped_matmul": 1}
    decode_kernels_vs_plain("zamba2-2.7b", zamba, ssd, {"stream": 1})
    chunked_vs_decode("zamba2-2.7b", dataclasses.replace(
        zamba, **HYBRID_CROSSCHECK), CROSSCHECK_LEN, 2,
        CROSSCHECK_LOGIT_ATOL, ssd, {"stream": 1},
        state_rtol=CROSSCHECK_STATE_RTOL)
    danube = dataclasses.replace(get_config("h2o-danube-1.8b", dtype=f32),
                                 n_layers=DANUBE_WRAP_LAYERS)
    assert danube.window == 4096 < DANUBE_WRAP_LEN
    chunked_vs_decode(f"h2o-danube-1.8b ({DANUBE_WRAP_LAYERS} layers, "
                      "window 4096)", danube, DANUBE_WRAP_LEN, 1,
                      DENSE_CROSSCHECK_LOGIT_ATOL, {}, {})


def lm_steps(cfg, n_steps, batch=8, seq=1024, check=None, embeds=0):
    """``n_steps`` of make_train_step (the --mode lm step: AdamW at lr
    1e-3, bf16 grads) on the synthetic corpus, the weights drawn on the
    card: losses finite and falling; prints the step times, tokens/s
    (of text) and peak device memory. ``embeds`` > 0 adds to each batch
    that many N(0, 1) frontend positions (B, embeds, d) in the model's
    dtype, drawn on the card (an encdec's frames, a vlm's patches).
    ``check(params, last batch)`` runs after the last step."""
    from repro_torch.data.synthetic import (lm_batch_from_tokens,
                                            make_token_dataset)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.module import param_count
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    step_fn, opt = make_train_step(cfg, lr=1e-3)
    state = opt.init(params)
    toks, _ = make_token_dataset(batch * n_steps, seq + 1, cfg.vocab,
                                 seed=0)
    gen = torch.Generator(device="cuda").manual_seed(4)
    loss, wall = [], []
    t0 = time.time()
    for i in range(n_steps):
        b = lm_batch_from_tokens(toks[i * batch:(i + 1) * batch],
                                 device="cuda")
        if embeds:
            b["embeds"] = torch.randn((batch, embeds, cfg.d_model),
                                      generator=gen, device="cuda",
                                      dtype=cfg.dtype)
        params, state, l_ = step_fn(params, state, i, b)
        loss.append(float(l_))
        wall.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(x) for x in loss), f"non-finite loss {loss}"
    assert loss[-1] < loss[0], f"the loss did not fall: {loss}"
    later = (wall[-1] - wall[0]) / (n_steps - 1)
    front = f" over {embeds} frontend positions" if embeds else ""
    print(f"  {cfg.arch_id}, {cfg.n_layers} layers ({cfg.fed2_decouple} "
          f"decoupled), batch {batch} x {seq} tokens{front}, "
          f"{param_count(params):,} parameters: losses "
          f"{[round(x, 4) for x in loss]}; first step {wall[0]:.3f} s, "
          f"later steps {later:.3f} s each ({batch * seq / later:.0f} "
          f"tokens/s); peak device memory {peak / 2 ** 30:.2f} GiB",
          flush=True)
    finite_params({"final_params": params})
    if check is not None:
        check(params, b)
    del params, state
    free_device_memory()


def phase_other_lm_train():
    """--mode lm --fed2 --fed2-groups 8 (bf16, batch 8 x 1024, AdamW)
    counted, no kernel launch: danube and zamba2 at full depth through
    the CLI; stablelm cut to STABLELM_TRAIN_LAYERS layers (its 6
    decoupled blocks kept) through the CLI's step (the CLI has no depth
    flag, as the reference's has none)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    for arch, flags in OTHER_LM_TRAIN.items():
        counted(f"--mode lm --arch {arch}", lambda: lm_cli(flags), {})
        free_device_memory()
    cfg = dataclasses.replace(with_fed2(get_config("stablelm-12b"),
                                        groups=8),
                              n_layers=STABLELM_TRAIN_LAYERS)
    assert cfg.fed2_decouple == 6
    counted(f"--mode lm step, stablelm-12b at {STABLELM_TRAIN_LAYERS} "
            "layers", lambda: lm_steps(cfg, LM_TRAIN_STEPS), {})


def other_fl_config(arch, layers):
    """``arch``'s full width in fp32 under with_fed2(groups=4), cut to
    ``layers`` (a dense config keeps its decoupled blocks)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    cfg = with_fed2(get_config(arch, dtype=torch.float32), groups=4)
    return dataclasses.replace(cfg, n_layers=layers)


def phase_other_lm_fl():
    """run_federated(lm_task), fp32, LM_FL's 2 rounds (``lm_fl_runs``:
    fedavg and fed2, with and without --use-local-kernel, counted:
    paired_fusion 1, grouped_matmul 1 (sgemm) and with the flag
    local_step 4 a round), on zamba2 cut to HYBRID_FL_LAYERS layers and
    danube cut to DANUBE_FL_LAYERS (its 6 decoupled blocks kept)."""
    from repro_torch.fl.runtime import lm_task
    for arch, layers, depth in (("zamba2-2.7b", HYBRID_FL_LAYERS, 54),
                                ("h2o-danube-1.8b", DANUBE_FL_LAYERS, 24)):
        cfg, parts, get_batch, test, init = lm_fl_inputs(
            other_fl_config(arch, layers))
        lm_fl_header(cfg, init, depth)
        lm_fl_runs(lm_task(cfg), parts, get_batch, test, init,
                   lm_held_out_loss(cfg, test))
        del init
        free_device_memory()


def decode_cache_bytes(cfg, batch: int, max_len: int) -> int:
    """Bytes of ``init_cache(cfg, batch, max_len)`` (built on the meta
    device: no memory)."""
    from repro_torch.models.forward import init_cache
    from repro_torch.models.module import tree_leaves
    with torch.device("meta"):
        cache = init_cache(cfg, batch, max_len)
    return sum(t.numel() * t.element_size() for t in tree_leaves(cache))


def moe_config(arch, groups=8, dtype=None, **cut):
    """``arch``'s full config (in ``dtype``), under
    with_fed2(``groups``) when ``groups``, with ``cut``'s fields
    replaced (``n_experts``, ``d_ff_shared`` and ``capacity_factor`` on
    its MoEConfig; ``d_model`` and ``d_ff`` on both)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    cfg = get_config(arch, **({"dtype": dtype} if dtype else {}))
    if groups:
        cfg = with_fed2(cfg, groups=groups)
    moe_keys = ("n_experts", "d_ff_shared", "capacity_factor")
    moe_cut = {k: cut.pop(k) for k in moe_keys if k in cut}
    if "d_model" in cut:
        moe_cut["d_model"] = cut["d_model"]
    if "d_ff" in cut:
        moe_cut["d_ff_expert"] = cut["d_ff"]
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **moe_cut),
                               **cut)


def moe_serve(cfg, groups, *, batch=4, prompt_len=32, gen=16,
              max_len=128):
    """launch/serve.py's serving function (``run_serve``) on ``cfg`` (a
    depth-cut full config): tokens in range, finite logits, the cut's
    parameter count the reference's; prints prefill and decode tok/s,
    the decode cache's bytes and the peak device memory. Returns the
    peak."""
    from repro_torch.launch.serve import run_serve
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    out = run_serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                    max_len=max_len, device="cuda")
    peak = torch.cuda.max_memory_allocated()
    toks, logits = out["tokens"], out["logits"]
    assert toks.shape == (batch, gen) and ((toks >= 0)
                                           & (toks < cfg.vocab)).all()
    assert logits.shape == (batch, 1, cfg.vocab) and logits.is_cuda
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    cache_bytes = decode_cache_bytes(cfg, batch, max_len)
    want = MOE_CUT_PARAMS[cfg.arch_id, groups, cfg.n_layers]
    print(f"  {cfg.arch_id} at {cfg.n_layers} layers, batch {batch}, "
          f"{prompt_len} + {gen} tokens over {max_len} slots: prefill "
          f"{prompt_len * batch / out['prefill_s']:.1f} tok/s, decode "
          f"{out['tok_s']:.1f} tok/s "
          f"({out['decode_s'] / gen * 1e3:.2f} ms a step); decode cache {cache_bytes / 1e9:.3g} GB; peak device "
          f"memory {peak / 2 ** 30:.2f} GiB; {out['param_count']:,} "
          f"parameters (reference: {want:,})", flush=True)
    assert out["param_count"] == want, "parameter count differs from the " \
        "reference's"
    assert peak > cache_bytes
    del out
    free_device_memory()
    return peak


def phase_moe_serve():
    """Each MoE arch's full config: its parameter count ± Fed2 8 (init
    on meta) against the reference's, then serving at
    MOE_SERVE_LAYERS layers, full width, through run_serve: batch 4 (32
    + 16 tokens) without and with Fed2 8, and Fed2 at batch 128 over
    2048 slots (2 + 8 tokens); counted: grouped_matmul once a Fed2 step
    (stream at batch 4, wgmma at 128), nothing else."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    from repro_torch.models.module import param_count
    for arch in MOE_ARCHS:
        for g in (0, 8):
            n = param_count(tfm.init_params(
                torch.Generator(), moe_config(arch, g), device="meta"))
            print(f"  {arch} full, Fed2 {g}: {n:,} parameters (reference "
                  f"{SERVE_PARAMS[arch, g]:,})", flush=True)
            assert n == SERVE_PARAMS[arch, g]
        plain, fed2 = (dataclasses.replace(moe_config(arch, g),
                                           n_layers=MOE_SERVE_LAYERS)
                       for g in (0, 8))
        label = f"serve {arch} ({MOE_SERVE_LAYERS} layers)"
        steps = 32 + 16
        counted(label, lambda: moe_serve(plain, 0), {})
        counted(f"{label}, Fed2 8", lambda: moe_serve(fed2, 8),
                {"grouped_matmul": steps}, {"stream": steps})
        n = 2 + 8
        counted(f"{label}, Fed2 8, batch 128 over 2048 slots",
                lambda: moe_serve(fed2, 8, batch=128, prompt_len=2, gen=8,
                                  max_len=2048),
                {"grouped_matmul": n}, {"wgmma": n})


def phase_moe_decode_parity():
    """fp32, TF32 off, each MoE arch with Fed2 8 cut to
    MOE_PARITY_LAYERS layers at full width: 16 decode steps with the
    kernels against the plain versions (logits, every cache leaf), and
    the chunked forward against MOE_CROSSCHECK_LEN decode steps at
    capacity factor 16 (nothing drops), logits within the dense
    limit."""
    import dataclasses
    for arch in MOE_ARCHS:
        cfg = moe_config(arch, 8, torch.float32,
                         n_layers=MOE_PARITY_LAYERS)
        decode_kernels_vs_plain(f"{arch} ({MOE_PARITY_LAYERS} layers)", cfg,
                                {"grouped_matmul": 1}, {"stream": 1})
        chunked_vs_decode(
            f"{arch} ({MOE_PARITY_LAYERS} layers, capacity factor 16)",
            dataclasses.replace(moe_config(
                arch, 8, torch.float32, n_layers=MOE_PARITY_LAYERS,
                capacity_factor=16.0), **MOE_CROSSCHECK),
            MOE_CROSSCHECK_LEN, 2, DENSE_CROSSCHECK_LOGIT_ATOL,
            {"grouped_matmul": 1}, {"stream": 1})


def phase_moe_lm_train():
    """--mode lm's step (make_train_step: bf16, AdamW, batch 8 x 1024,
    Fed2 8) on each MoE arch at MOE_TRAIN's cut, counted (no launch):
    losses finite and falling, and the forward's aux loss after
    training finite and non-zero."""
    from repro_torch.models.forward import forward
    from repro_torch.models.module import param_count

    def aux_check(params, cfg, batch):
        assert param_count(params) == MOE_CUT_PARAMS[arch, 8, cfg.n_layers]
        with torch.no_grad():
            _, aux = forward(params, cfg, batch["tokens"])
        print(f"  aux loss after training {aux.item():.5f}", flush=True)
        assert math.isfinite(aux.item()) and aux.item() > 0

    for arch, cut in MOE_TRAIN.items():
        cfg = moe_config(arch, 8, **cut)
        counted(f"--mode lm step, {arch} at {cut}",
                lambda: lm_steps(cfg, LM_TRAIN_STEPS,
                                 check=lambda p, b: aux_check(p, cfg, b)),
                {})


def phase_moe_lm_fl():
    """run_federated(lm_task), fp32, on each MoE arch at MOE_FL's widths,
    every routing parameter kept: the kernels on its (4, M) cohort buffer
    (``lm_cohort_kernels``), LM_FL's 2 rounds (``lm_fl_runs``: fedavg and
    fed2, with and without --use-local-kernel, counted: paired_fusion 1,
    grouped_matmul 1 (sgemm) and with the flag local_step 4 a round), and
    one tapped fed2 round (``lm_tapped_round``)."""
    from repro_torch.fl.runtime import lm_task
    for arch, cut in MOE_FL.items():
        cfg, parts, get_batch, test, init = lm_fl_inputs(
            moe_config(arch, 4, torch.float32, **cut))
        lm_fl_header(cfg, init, moe_config(arch, 0).n_layers)
        print(f"  routing kept: {cfg.moe}", flush=True)
        with tf32_off():
            lm_cohort_kernels(init)
        task = lm_task(cfg)
        loss_of = lm_held_out_loss(cfg, test)
        losses = lm_fl_runs(task, parts, get_batch, test, init, loss_of)
        lm_tapped_round(f"{arch} LM round", task, parts, get_batch, test,
                        init, loss_of, losses)
        del init
        free_device_memory()


def frontend_config(arch, groups=8, dtype=None):
    """``arch``'s full config (in ``dtype``), under with_fed2(``groups``)
    when ``groups``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    cfg = get_config(arch, **({"dtype": dtype} if dtype else {}))
    return with_fed2(cfg, groups=groups) if groups else cfg


def phase_frontend_serve():
    """Whisper-base and InternVL2-2B at full width and depth through the
    serving CLI (batch 4, 32 + 16 tokens), without and with
    --fed2-groups 8, then Fed2 at batch 128 over 2048 slots; counted:
    grouped_matmul FRONTEND_GMM_PER_STEP a Fed2 step (stream at batch 4,
    wgmma at 128), never without Fed2. As the reference's serve does,
    Whisper decodes against its zeroed cross cache and InternVL text
    only. serve_cli checks each parameter count against the
    reference's."""
    from repro_torch.launch import serve
    d = serve.parse_args([])
    steps = d.prompt_len + d.gen
    big = ("--batch", "128", *OTHER_SERVE_BIG)
    b = serve.parse_args(list(big))
    n = b.prompt_len + b.gen
    for arch in FRONTEND_ARCHS:
        gmm = FRONTEND_GMM_PER_STEP[arch]
        a = ("--arch", arch, "--full")
        counted(f"serve --arch {arch} --full", lambda: serve_cli(*a), {})
        counted(f"serve --arch {arch} --full --fed2-groups 8",
                lambda: serve_cli(*a, "--fed2-groups", "8"),
                {"grouped_matmul": gmm * steps}, {"stream": gmm * steps})
        peak, counts = counted(
            f"serve --arch {arch} --full --fed2-groups 8 " + " ".join(big),
            lambda: serve_cli(*a, "--fed2-groups", "8", *big),
            {"grouped_matmul": gmm * n}, {"wgmma": gmm * n})
        cache = decode_cache_bytes(frontend_config(arch), b.batch, b.max_len)
        print(f"  {arch} Fed2: grouped_matmul {gmm} a decode step (stream "
              f"at batch 4, {counts['grouped_matmul'] // n} wgmma at batch "
              f"128); decode cache at batch {b.batch} x {b.max_len} "
              f"positions {cache / 1e9:.3g} GB, peak {peak / 1e9:.2f} GB",
              flush=True)
        assert peak > cache, f"{arch}: the batch-128 run did not hold its " \
            "cache"


def whisper_prefilled_decode():
    """Whisper's real serving path in fp32 with Fed2 8: frames (4, 1500,
    512) from a numpy seed, encdec_prefill_cache (no launch), then
    WHISPER_DECODE_LEN decode steps (the decoupled FFN on the kernel,
    stream), against forward(embeds=frames)'s tied logits: within
    WHISPER_PREFILL_LOGIT_RTOL of max |logit|; and the same decode
    against the zeroed cross cache (the serve CLI's) must differ by
    more than that limit (the encoder's K and V reached the logits)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import (decode_step,
                                            encdec_prefill_cache, forward,
                                            init_cache)
    cfg = frontend_config("whisper-base", dtype=torch.float32)
    bs, n = 4, WHISPER_DECODE_LEN
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(1),
                             cfg)
    rng = np.random.default_rng(6)
    frames = torch.as_tensor(rng.standard_normal(
        (bs, cfg.enc_frames, cfg.d_model), dtype=np.float32), device="cuda")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (bs, n)),
                           device="cuda")

    @torch.no_grad()
    def chunked():
        h, _ = forward(params, cfg, toks, embeds=frames)
        return tfm.unembed_apply(None, h, cfg, params["embed"]["table"])

    @torch.no_grad()
    def decoded(prefill):
        cache = init_cache(cfg, bs, n, device="cuda")
        if prefill:
            cache = encdec_prefill_cache(params, cfg, cache, frames)
        return torch.cat([decode_step(params, cfg, cache, toks[:, t:t + 1],
                                      t)[0] for t in range(n)], 1)

    gmm = FRONTEND_GMM_PER_STEP["whisper-base"] * n
    t0 = time.time()
    want, _ = counted("whisper-base forward(embeds=frames)", chunked, {})
    t1 = time.time()
    got, _ = counted(f"whisper-base encdec_prefill_cache + {n} decode "
                     "steps", lambda: decoded(True), {"grouped_matmul": gmm},
                     {"stream": gmm})
    t2 = time.time()
    zero, _ = counted(f"whisper-base {n} decode steps, zeroed cross cache",
                      lambda: decoded(False), {"grouped_matmul": gmm},
                      {"stream": gmm})
    mag = want.abs().max().item()
    err = (got - want).abs().max().item()
    off = (zero - want).abs().max().item()
    limit = WHISPER_PREFILL_LOGIT_RTOL * mag
    ok = err <= limit < off
    print(f"  whisper-base, batch {bs}, {n} tokens over {cfg.enc_frames} "
          f"frames, fp32, Fed2 8: forward {t1 - t0:.2f} s, prefill + "
          f"decode {t2 - t1:.2f} s; max |dlogits| {err:.3g} (limit "
          f"{limit:.3g} = {WHISPER_PREFILL_LOGIT_RTOL:g} of max |logit| "
          f"{mag:.3g}); against the zeroed cross cache {off:.3g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    assert ok, "whisper-base: the prefilled decode and the forward disagree"
    del params, want, got, zero
    free_device_memory()


def internvl_eval_routes():
    """InternVL (Fed2 8, fp32) eval loss on 2 x (256 patches + 768 text
    tokens): make_eval_step (grouped_matmul once a loss chunk, sgemm)
    against lm_loss's einsum route, within FRONTEND_EVAL_FP32_TOL."""
    from repro_torch.data.synthetic import (lm_batch_from_tokens,
                                            make_token_dataset)
    from repro_torch.launch.steps import make_eval_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import lm_loss
    cfg = frontend_config("internvl2-2b", dtype=torch.float32)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(1),
                             cfg)
    toks, _ = make_token_dataset(2, FRONTEND_EVAL_TEXT + 1, cfg.vocab,
                                 seed=2)
    batch = lm_batch_from_tokens(toks, device="cuda")
    batch["embeds"] = torch.randn(
        (2, cfg.n_patches, cfg.d_model), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(3))
    chunks = -(-FRONTEND_EVAL_TEXT // cfg.loss_chunk)
    kern, _ = counted("internvl2-2b eval step, fp32",
                      lambda: make_eval_step(cfg)(params, batch).item(),
                      {"grouped_matmul": chunks}, {"sgemm": chunks})
    with torch.no_grad():
        plain, _ = counted("internvl2-2b lm_loss, einsum route",
                           lambda: lm_loss(params, cfg, batch).item(), {})
    err = abs(kern - plain)
    print(f"  internvl2-2b eval loss over {cfg.n_patches} patches + "
          f"{FRONTEND_EVAL_TEXT} tokens, fp32: grouped_matmul {kern:.6f}, "
          f"einsum {plain:.6f}, |d| {err:.3g} (tol "
          f"{FRONTEND_EVAL_FP32_TOL:g}) "
          f"{'ok' if err <= FRONTEND_EVAL_FP32_TOL else 'FAIL'}", flush=True)
    assert err <= FRONTEND_EVAL_FP32_TOL, "the eval's kernel route drifts"
    del params
    free_device_memory()


def phase_frontend_decode_parity():
    """fp32, TF32 off, full width and depth with Fed2 8: each arch's 16
    decode steps with the kernels against the plain versions (logits,
    every cache leaf); Whisper's prefilled decode against its forward;
    InternVL's eval loss through both routes."""
    f32 = torch.float32
    for arch in FRONTEND_ARCHS:
        g = FRONTEND_GMM_PER_STEP[arch]
        decode_kernels_vs_plain(arch, frontend_config(arch, dtype=f32),
                                {"grouped_matmul": g}, {"stream": g})
    whisper_prefilled_decode()
    internvl_eval_routes()


def phase_frontend_lm_train():
    """make_train_step (the --mode lm step, which the CLI refuses for
    these families: its token batch has no embeds) at full width and
    depth, bf16, Fed2 8, LM_TRAIN_STEPS AdamW steps on batches
    carrying the frontends' embeds, counted: no launch; losses finite and
    falling. Then the eval step on the trained params, counted
    (grouped_matmul once a loss chunk for InternVL, wgmma; none for
    Whisper's tied unembedding), against the einsum route."""
    from repro_torch.launch.steps import make_eval_step
    from repro_torch.models.forward import lm_loss
    for arch, kw in FRONTEND_TRAIN.items():
        cfg = frontend_config(arch)
        kept = {}
        counted(f"--mode lm step, {arch}, batch {kw['batch']} x "
                f"{kw['seq']} tokens over {kw['embeds']} frontend "
                "positions",
                lambda: lm_steps(cfg, LM_TRAIN_STEPS,
                                 check=lambda p, b: kept.update(p=p, b=b),
                                 **kw), {})
        chunks = 0 if cfg.tie_embeddings else -(-kw["seq"] // cfg.loss_chunk)
        loss, _ = counted(f"{arch} eval step on the trained params",
                          lambda: make_eval_step(cfg)(kept["p"],
                                                      kept["b"]).item(),
                          {"grouped_matmul": chunks}, {"wgmma": chunks})
        with torch.no_grad():
            plain = lm_loss(kept["p"], cfg, kept["b"]).item()
        err = abs(loss - plain)
        print(f"  {arch} eval loss, kernel vs einsum route: {loss:.5f} vs "
              f"{plain:.5f}, |d| {err:.3g} (tol {LM_EVAL_ROUTES_TOL:g}) "
              f"{'ok' if err <= LM_EVAL_ROUTES_TOL else 'FAIL'}", flush=True)
        assert err <= LM_EVAL_ROUTES_TOL, f"{arch}: the eval step drifts"
        del kept
        free_device_memory()


# ---------------------------------------------------------------------------
# surfaces: the examples and the dry-run
# ---------------------------------------------------------------------------

# fed2_cifar_fl's flags here: every registered method, 3 rounds each
CIFAR_EXAMPLE = ("--rounds", "3", "--methods", "all")
# methods whose example run ends in non-finite params, in the reference
# too: fedadam at the example's server_lr 1.0 (FLConfig's default)
CIFAR_DIVERGES = ("fedadam",)
# the example runs held against the same runs on the CPU, with the CPU
# tests' tolerances (tests/test_torch_examples.py): a CIFAR accuracy
# within one eval example (of 600; a group's within one of its
# support), LM final params within rtol = atol = 1e-5 and its accuracy
# within one eval position (of 64 x 64)
CROSS_METHODS = ("fedavg", "fed2")
CIFAR_ACC_TOL = 1.0 / 600 + 1e-9
# the round-off of the init that bounds the CIFAR round's card-vs-CPU
# distance: one ulp up and down, and 1e-7 relative noise (6 seeds)
CIFAR_NOISE_SEEDS = tuple(range(100, 106))
LM_PARAM_TOL = 1e-5
LM_ACC_TOL = 1.0 / (64 * 64)
# the phase's budget (printed beside its time)
SURFACES_BUDGET_S = 120
# the full-width dry-run cell held on real memory: mamba2-1.3b at
# decode_32k on the one-card mesh, batch 128 over 32,768 positions
SURFACE_CELL = ("mamba2-1.3b", "decode_32k")
DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun"


def surfaces_examples(smi) -> list:
    """The four examples at the reference's defaults (fed2_cifar_fl
    with CIFAR_EXAMPLE), counted against the launches the code gives:
    quickstart none (Eq. 9 and the fusion on their plain routes, the
    reference's use_kernel=False); fed2_cifar_fl one paired_fusion a
    round for every method but fedma (host fusion); the LM example one
    paired_fusion and one grouped_matmul (sgemm: the eval's 64 x 64 fp32
    rows through the block-diagonal unembedding) a round, 4 rounds of
    fedavg and fed2; serve_decode one ssd_update per reduced Mamba-2
    layer per step (1 + 24 steps), nothing for the other four archs.

    The CIFAR and LM runs take TF32 off (and deterministic convs). The
    LM example's CROSS_METHODS run again on the CPU from the same init
    and are held to the card's at the CPU tests' tolerances, and its
    fed2 held-out loss must fall round by round (the card's runs of 1,
    2, ... rounds); the CIFAR runs are held to the CPU by
    ``cifar_cross_check``."""
    from repro_torch.examples import (fed2_cifar_fl, llm_federated_finetune,
                                      quickstart, serve_decode)
    from repro_torch.fl import methods as methods_lib
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.models.transformer import init_params
    lines = []

    t0 = time.time()
    q, _ = counted("examples.quickstart", lambda: quickstart.main([]), {})
    assert len(q["tvs"]) == 4 and all(map(math.isfinite, q["tvs"])), q
    assert math.isfinite(q["loss"]), q["loss"]
    lines.append(f"quickstart {time.time() - t0:.1f} s, launches none, "
                 f"fused loss {q['loss']:.4f}")

    t0 = time.time()
    rounds = int(CIFAR_EXAMPLE[1])
    fused = [m for m in methods_lib.available()
             if not methods_lib.get(m).host_fusion]
    with tf32_off(), deterministic_convs():
        res, counts = counted(
            "examples.fed2_cifar_fl " + " ".join(CIFAR_EXAMPLE),
            lambda: fed2_cifar_fl.main(list(CIFAR_EXAMPLE)),
            {"paired_fusion": rounds * len(fused)})
    assert list(res) == list(methods_lib.available()), list(res)
    for m, h in res.items():
        assert len(h["acc"]) == rounds, (m, h["acc"])
        if m not in CIFAR_DIVERGES:
            finite_params(h)
    lines.append(f"fed2_cifar_fl {' '.join(CIFAR_EXAMPLE)} "
                 f"{time.time() - t0:.1f} s, paired_fusion "
                 f"{counts['paired_fusion']}, final acc "
                 + ", ".join(f"{m} {h['acc'][-1]:.3f}"
                             for m, h in res.items()))
    lines.append(cifar_cross_check(res))

    t0 = time.time()
    d = llm_federated_finetune
    cfg = d.model_config("llama3.2-1b")
    init = init_params(torch.Generator().manual_seed(0), cfg)
    lm_rounds, lm_methods = 4, ("fedavg", "fed2")
    assert lm_methods == CROSS_METHODS

    def lm_run(**kw):
        return d.run_llm_federated_finetune(init_params=lambda c: init,
                                            **kw)

    with tf32_off():
        res, counts = counted(
            "examples.llm_federated_finetune", lambda: lm_run(log=print),
            {"paired_fusion": lm_rounds * len(lm_methods),
             "grouped_matmul": lm_rounds * len(lm_methods)},
            {"sgemm": lm_rounds * len(lm_methods)})
        assert tuple(res) == lm_methods, list(res)
        for m, h in res.items():
            finite_params(h)
            moved = [bool((a.cpu() != b).any()) for a, b in
                     zip(tree_leaves(h["final_params"]), tree_leaves(init))]
            assert all(moved), f"{m}: {moved.count(False)} leaves unmoved"
        t_card = time.time() - t0
        # the held-out loss after 0, 1, ..., lm_rounds rounds of fed2
        held_out = lm_held_out_loss(cfg, d.held_out_batches(cfg, 64))
        losses = [held_out(tree_map(lambda t: t.cuda(), init))] + [
            held_out(lm_run(rounds=r, methods="fed2", log=None)["fed2"]
                     ["final_params"]) for r in range(1, lm_rounds)] + [
            held_out(res["fed2"]["final_params"])]
    assert all(a > b for a, b in zip(losses, losses[1:])), \
        f"the held-out loss does not fall round by round: {losses}"
    t0 = time.time()
    cpu = lm_run(device="cpu", log=None)
    t_cpu = time.time() - t0
    for m in CROSS_METHODS:
        np.testing.assert_allclose(res[m]["acc"], cpu[m]["acc"],
                                   atol=LM_ACC_TOL, rtol=0, err_msg=m)
        for a, b in zip(tree_leaves(res[m]["final_params"]),
                        tree_leaves(cpu[m]["final_params"]), strict=True):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=LM_PARAM_TOL, atol=LM_PARAM_TOL,
                                       err_msg=m)
    dparam = {m: max_leaf_diff(res[m]["final_params"],
                               cpu[m]["final_params"])
              for m in CROSS_METHODS}
    lines.append(f"llm_federated_finetune {t_card:.1f} s, "
                 f"paired_fusion {counts['paired_fusion']}, grouped_matmul "
                 f"{counts['grouped_matmul']} (sgemm), every leaf moved; "
                 "fed2 held-out loss by round " + ", ".join(
                     f"{x:.5f}" for x in losses))
    lines.append(f"llm_federated_finetune on the CPU, same init "
                 f"({t_cpu:.1f} s): final params within {LM_PARAM_TOL:g}, "
                 "accuracies within one eval position; max |dparam| card "
                 "vs CPU " + ", ".join(f"{m} {v:.3g}"
                                        for m, v in dparam.items()))

    t0 = time.time()
    from repro_torch.configs import get_config
    archs = serve_decode.ARCHS.split(",")
    steps = 1 + serve_decode.parse_args([]).gen
    mamba = get_config("mamba2-1.3b", reduced=True).n_layers
    res, counts = counted("examples.serve_decode",
                          lambda: serve_decode.main([]),
                          {"ssd_update": mamba * steps})
    for arch, r in res.items():
        assert r["tokens"].shape == (4, steps - 1), (arch, r["tokens"].shape)
        assert np.isfinite(r["logits"]).all(), arch
    lines.append(f"serve_decode {time.time() - t0:.1f} s, ssd_update "
                 f"{counts['ssd_update']}, tok/s " + ", ".join(
                     f"{a} {res[a]['tok_s']:.1f}" for a in archs))
    return [f"{x} ({smi})" for x in lines]


def _perturbed_init(method, how):
    """The CIFAR example's init for ``method`` (the CPU generator at the
    run's seed), moved by ``how``: None, "up" or "down" (one ulp), or a
    seed of 1e-7 relative noise."""
    from repro_torch.examples import fed2_cifar_fl as ex
    from repro_torch.fl.runtime import cnn_task
    from repro_torch.models.module import tree_map
    p = cnn_task(ex.model_config(method)).init_fn(
        torch.Generator().manual_seed(0))
    if how in ("up", "down"):
        end = math.inf if how == "up" else -math.inf
        return tree_map(lambda t: torch.nextafter(t, torch.full_like(t, end)),
                        p)
    if how is not None:
        g = torch.Generator().manual_seed(how)
        return tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
            t.shape, generator=g)), p)
    return p


def cifar_cross_check(res) -> str:
    """The card's CIFAR example runs of CROSS_METHODS against the CPU:

    - its eval: each card run's final params, evaluated on the CPU, give
      the run's final confusion counts within one eval example;
    - one round from one init on either device (TF32 off, deterministic
      convs on the card): accuracy and per-group accuracies within one
      eval example (the CPU tests' tolerance); params no further from
      the CPU's than the CPU's own round moves when its init moves by
      round-off (CIFAR_NOISE_SEEDS, one ulp either way), the parity
      phase's rule. Longer trajectories are not compared: a unit of the
      un-normalized net crosses its ReLU kink at round-off, and a 1e-7
      change of the init moves one round's convs/2/w by 5.4e-5 on the
      CPU alone; the runs part from there."""
    from repro_torch.core.grouping import GroupSpec
    from repro_torch.examples import fed2_cifar_fl as ex
    from repro_torch.fl import evaluation as ev
    from repro_torch.fl.runtime import cnn_task
    from repro_torch.models.module import tree_map
    evals = ev.stage(ex.held_out_batches(), tile=600, device="cpu")
    for m in CROSS_METHODS:
        task = cnn_task(ex.model_config(m))
        conf = ev.make_eval_engine(task.predict_fn, ex.N_CLASSES).run(
            tree_map(lambda t: t.cpu(), res[m]["final_params"]), evals)
        card = np.asarray(res[m]["confusion"][-1])
        assert np.abs(conf.numpy() - card).sum() <= 2, (m, conf, card)
    t0 = time.time()

    def one_round(device, how=None):
        return {m: ex.run_fed2_cifar_fl(
            rounds=1, methods=m, device=device, log=None,
            init_params=lambda cfg: _perturbed_init(m, how))[m]
            for m in CROSS_METHODS}

    with tf32_off(), deterministic_convs():
        card = one_round("cuda")
    cpu = one_round("cpu")
    spread = {m: 0.0 for m in CROSS_METHODS}
    for how in ("up", "down") + CIFAR_NOISE_SEEDS:
        moved = one_round("cpu", how)
        for m in CROSS_METHODS:
            spread[m] = max(spread[m], max_leaf_diff(
                moved[m]["final_params"], cpu[m]["final_params"]))
    card_groups = ex.group_accuracies(card)
    cpu_groups = ex.group_accuracies(cpu)
    dparam = {}
    for m in CROSS_METHODS:
        np.testing.assert_allclose(card[m]["acc"], cpu[m]["acc"],
                                   atol=CIFAR_ACC_TOL, rtol=0, err_msg=m)
        conf = np.asarray(cpu[m]["confusion"][-1], np.float64)
        support = np.array([conf[sorted(c)].sum() for c in
                            GroupSpec.contiguous(ex.GROUPS, ex.N_CLASSES)
                            .classes_per_group])
        assert np.all(np.abs(card_groups[m] - cpu_groups[m]) * support
                      <= 1 + 1e-6), (m, card_groups[m], cpu_groups[m])
        dparam[m] = max_leaf_diff(card[m]["final_params"],
                                  cpu[m]["final_params"])
        assert dparam[m] <= spread[m], (
            f"{m}: one round on the card is {dparam[m]:.3g} from the CPU's,"
            f" beyond the CPU's own {spread[m]:.3g} under round-off of the "
            "init")
    return ("fed2_cifar_fl on the CPU: the card runs' evals equal; one "
            f"round from one init ({time.time() - t0:.1f} s, "
            f"{2 + len(CIFAR_NOISE_SEEDS)} moved inits): acc " + ", ".join(
                f"{m} {card[m]['acc'][0]:.4f} / {cpu[m]['acc'][0]:.4f}"
                for m in CROSS_METHODS) + "; max |dparam| card vs CPU "
            + ", ".join(f"{m} {dparam[m]:.3g} (CPU's own spread "
                        f"{spread[m]:.3g})" for m in CROSS_METHODS))


def surfaces_dryrun(smi) -> list:
    """The dry-run's byte accounting for every ASSIGNED_ARCHS x
    INPUT_SHAPES x both production meshes x +- Fed2 (no meta pass):
    every applicable cell builds; then the meta pass of every arch at
    decode_32k on the 16x16 mesh, each record ``ok``."""
    import itertools

    from repro_torch.configs import ASSIGNED_ARCHS
    from repro_torch.configs.shapes import INPUT_SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    t0 = time.time()
    built, skipped, most = 0, 0, (0, "")
    for arch, shape, mp, fed2 in itertools.product(
            ASSIGNED_ARCHS, INPUT_SHAPES, (False, True), (False, True)):
        if not dryrun.applicable(arch, shape)[0]:
            skipped += 1
            continue
        mesh = make_production_mesh(multi_pod=mp)
        step, _ = dryrun.build_lowered(arch, shape, mesh=mesh, fed2=fed2)
        nbytes = dryrun.argument_bytes(step, mesh)
        assert nbytes > 0, (arch, shape, mp, fed2)
        built += 1
        most = max(most, (nbytes, f"{arch} {shape} "
                          f"{dryrun.mesh_name(mesh)}{' fed2' * fed2}"))
    n_cells = len(ASSIGNED_ARCHS) * len(INPUT_SHAPES) * 4
    assert built + skipped == n_cells and built == n_cells - 24, \
        (built, skipped)
    t_bytes = time.time() - t0
    t0 = time.time()
    flops = {}
    for arch in ASSIGNED_ARCHS:
        rec = dryrun.run_one(arch, "decode_32k", mesh=make_production_mesh(),
                             fed2=False, outdir=str(DRYRUN_OUT),
                             verbose=False)
        assert rec["status"] == "ok", rec
        flops[arch] = rec["flops"]
    return [f"dry-run bytes: {built} cells built, {skipped} skipped "
            f"(long_500k on full attention) in {t_bytes:.1f} s; most per "
            f"device {most[0] / 2**30:.2f} GiB ({most[1]}) ({smi})",
            f"dry-run meta pass, decode_32k 16x16, all 10 archs ok in "
            f"{time.time() - t0:.1f} s; FLOPs " + ", ".join(
                f"{a} {f:.4g}" for a, f in flops.items()) + f" ({smi})"]


def surfaces_card_cell(smi) -> list:
    """SURFACE_CELL at full width on real memory: the host-mesh record
    (meta pass), then its params, cache, tokens and position allocated
    on the card, whose bytes must equal the record's argument_bytes;
    one make_serve_step step through ssd_update (one launch a layer),
    finite logits; a warm step under torch.profiler (device busy share,
    the costliest operators); then one plain-route step under FlopCounterMode,
    whose count must equal the meta pass's."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.shapes import INPUT_SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import tree_bytes
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.forward import init_cache
    from repro_torch.models.transformer import init_params
    arch, name = SURFACE_CELL
    shape = INPUT_SHAPES[name]
    t0 = time.time()
    rec = dryrun.run_one(arch, name, mesh=make_host_mesh(), fed2=False,
                         outdir=str(DRYRUN_OUT), verbose=False)
    assert rec["status"] == "ok", rec
    t_meta = time.time() - t0
    cfg = dryrun.config_of(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = shape.global_batch
    params = init_params(gen, cfg)
    cache = init_cache(cfg, b, shape.seq_len, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                           dtype=torch.int32, device="cuda")
    pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32, device="cuda")
    held = sum(tree_bytes(t) for t in (params, cache, tokens, pos))
    want = rec["memory"]["argument_bytes"]
    assert held == want, f"allocated {held} B != the record's {want} B"
    serve = make_serve_step(cfg)
    torch.cuda.synchronize()
    t0 = time.time()
    (logits, _), counts = counted(
        f"{arch} {name} serve step (batch {b})",
        lambda: serve(params, cache, tokens, int(pos)),
        {"ssd_update": cfg.n_layers})
    torch.cuda.synchronize()
    t_step = time.time() - t0
    assert logits.shape == (b, 1, cfg.vocab), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    t0 = time.time()                 # a second step, warm
    serve(params, cache, tokens, int(pos))
    torch.cuda.synchronize()
    t_warm = time.time() - t0
    profiled(f"{arch} {name} serve step (batch {b}), warm",
             lambda: serve(params, cache, tokens, int(pos)), top_ops=6,
             kernel="ssd_update")
    plain = make_serve_step(cfg, use_kernel=False)
    with FlopCounterMode(display=False) as counter:
        plain(params, cache, tokens, int(pos))
    assert counter.get_total_flops() == rec["flops"], \
        (counter.get_total_flops(), rec["flops"])
    state = tree_bytes(cache)
    del params, cache, logits
    free_device_memory()
    return [f"{arch} {name} on (1, 1): record built and meta pass in "
            f"{t_meta:.1f} s; allocated {held:,} B = the record's "
            f"argument_bytes (cache {state / 1e9:.2f} GB); first step "
            f"{t_step * 1e3:.1f} ms wall, a second {t_warm * 1e3:.1f} ms; "
            f"ssd_update {counts['ssd_update']}, finite logits; "
            f"plain-route FLOPs on the card {rec['flops']:.6g} = the meta "
            f"pass's ({smi})"]


def phase_surfaces():
    """The examples, the dry-run's byte accounting and meta passes, and
    one full-width dry-run cell on real memory; one line per part."""
    smi = nvidia_smi()
    t0 = time.time()
    lines = (surfaces_examples(smi) + surfaces_dryrun(smi)
             + surfaces_card_cell(smi))
    for line in lines:
        print(f"  {line}", flush=True)
    print(f"  surfaces phase {time.time() - t0:.1f} s (budget "
          f"{SURFACES_BUDGET_S} s)", flush=True)


# the federated dry-run: both meshes' records against the committed
# ones, and the 16x16 fed2 case's round on the card's (1, 1) mesh:
# vgg9.full(fed2_groups=10, decouple=6, norm="gn"), 16 clients, 4 local
# steps of batch 32, both kernels; its allocated arguments (the
# reference's global count at mesh=None) and the K = 8 async event's
# read arguments (8 rows and w; the event never reads the global); then
# rank 0's program of the same case on a dry (16, 16) mesh on real
# memory, its counts against the record's collectives
FL_DRYRUN_BUDGET_S = 70
FL_DRYRUN_OUT = ROOT / "chiprun_out" / "fl_dryrun"
FL_DRYRUN_COMMITTED = ROOT / "benchmarks" / "artifacts_perf"
FL_CARD_CASE = dict(clients=16, local_steps=4, batch=32)
FL_CARD_ARGUMENT_BYTES = 27_023_720
FL_CARD_EVENT_K = 8
FL_CARD_EVENT_BYTES = 14_792_032


def fl_dryrun_accounting(smi) -> list:
    """The byte accounting of every case of the reference's matrix on
    both meshes (16x16 at its defaults, 1x1 at make smoke's knobs), no
    meta pass: 60 ok and 2 skipped, each ok record's argument and output
    bytes equal to the committed record's."""
    from repro_torch.launch import fl_dryrun
    t0 = time.time()
    recs = (fl_dryrun.run_matrix(mesh_kind="pod", verbose=False, meta=False,
                                 outdir=str(FL_DRYRUN_OUT / "pod"))
            + fl_dryrun.run_matrix(mesh_kind="host", clients=4,
                                   local_steps=2, batch=8, seq=32,
                                   verbose=False, meta=False,
                                   outdir=str(FL_DRYRUN_OUT / "host")))
    statuses = [r["status"] for r in recs]
    assert statuses.count("ok") == 60 and statuses.count("skipped") == 2, \
        [(r["kind"], r["method"], r.get("error")) for r in recs
         if r["status"] == "error"]
    held = 0
    for out in (FL_DRYRUN_OUT / "pod", FL_DRYRUN_OUT / "host"):
        for f in sorted(out.glob("dryrun_fl_*.json")):
            rec = json.loads(f.read_text())
            ref = json.loads((FL_DRYRUN_COMMITTED / f.name).read_text())
            assert rec["status"] == ref["status"], f.name
            if rec["status"] != "ok":
                continue
            for k in ("argument_bytes", "output_bytes"):
                assert rec["memory"][k] == ref["memory"][k], \
                    (f.name, k, rec["memory"][k], ref["memory"][k])
            held += 1
    assert held == 60, held
    return [f"fl dry-run bytes: {len(recs)} records (16x16 and 1x1), 60 ok "
            f"and 2 skipped, built in {time.time() - t0:.1f} s; argument "
            f"and output bytes of all 60 equal to the committed records' "
            f"({smi})"]


def presence_fusion_launches(engine) -> int:
    """paired_fusion launches of one presence-weighted fuse
    (core/fusion._kernel_fuse with group weights): one per shared leaf
    and one per (pre index, group) block of each grouped leaf."""
    layout = engine.layout
    return sum(1 if ga is None else math.prod(slot.shape[:ga.axis])
               * ga.n_groups for slot, ga
               in zip(layout.slots, layout.leaves(engine.ctx.group_axes)))


def fl_dryrun_card(smi) -> list:
    """The 16x16 fed2 case (FL_CARD_CASE) on the card's (1, 1) mesh: the
    record built on meta (meta pass included); the same arguments
    allocated on the card, their bytes equal to its argument_bytes; one
    run_round with both kernels (local_step 4; paired_fusion once per
    shared leaf and per (pre, group) block, the presence rows gw being
    an argument: ``presence_fusion_launches``), its outputs' bytes equal
    to output_bytes, and once more with shared weights (gw None, the
    CLI's main path: paired_fusion 1); the plain routes from the same
    inputs (TF32 off, deterministic convs), the kernel round within what
    a one-ulp change of the init does to the plain one; the plain round
    under FlopCounterMode, its count equal to the meta pass's; then one
    fed2 async event at K = 8 over the trained rows: its read arguments'
    bytes equal to the record's, paired_fusion 1, within 1e-5 of the
    plain fuse."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.fl.async_engine import (lower_async_event,
                                             make_async_engine)
    from repro_torch.fl.engine import lower_round, make_round_engine
    from repro_torch.fl.runtime import FLConfig
    from repro_torch.launch import fl_dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import tree_bytes
    from repro_torch.models.module import tree_map
    mesh = make_host_mesh()
    c, steps, b = (FL_CARD_CASE[k] for k in ("clients", "local_steps",
                                             "batch"))
    task, _ = fl_dryrun._cnn_case("fed2", "pod")
    t0 = time.time()
    step = lower_round(task, FLConfig(population=c, method="fed2"), mesh,
                       fl_dryrun._batch_elems("cnn", b, 0),
                       local_steps=steps, use_kernel=True)
    flops, t_pass = fl_dryrun.meta_pass(step)
    mem = fl_dryrun.memory(step, mesh)
    t_meta = time.time() - t0
    assert mem["argument_bytes"] == FL_CARD_ARGUMENT_BYTES, mem

    init = task.init_fn(torch.Generator().manual_seed(0))
    cuda = lambda t: t.to("cuda")                       # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, _, mbatch, mw, mgw, _, _ = step.args
    batches = {"images": torch.randn(mbatch["images"].shape, generator=gen,
                                     device="cuda"),
               "labels": torch.randint(0, 10, mbatch["labels"].shape,
                                       generator=gen, device="cuda",
                                       dtype=mbatch["labels"].dtype)}
    w = torch.rand(mw.shape, generator=gen, device="cuda") + 0.5
    gw = torch.rand(mgw.shape, generator=gen, device="cuda") + 0.5
    state = {"server": (), "clients": ()}

    def engine(kernels, start=init):
        eng = make_round_engine(task, step.cfg, start, device="cuda",
                                use_kernel=kernels,
                                use_local_kernel=kernels)
        return eng, eng.layout.flatten(tree_map(cuda, start))

    eng_k, gp = engine(True)
    args = (state, gp, batches, w, gw)
    held = sum(tree_bytes(a) for a, r in zip(args, step.reads) if r)
    assert held == mem["argument_bytes"], \
        f"allocated {held} B != the record's {mem['argument_bytes']} B"
    torch.cuda.synchronize()
    t0 = time.time()
    (new_state, out), counts = counted(
        "fl dry-run 16x16 fed2 case, run_round on (1, 1)",
        lambda: eng_k.run_round(*args),
        {"paired_fusion": presence_fusion_launches(eng_k),
         "local_step": steps})
    torch.cuda.synchronize()
    t_round = time.time() - t0
    _, shared = counted(
        "the same round with shared weights (gw None)",
        lambda: eng_k.run_round(*args[:4]),
        {"paired_fusion": 1, "local_step": steps})
    out_bytes = tree_bytes((new_state, out)) + mem["output_table_bytes"]
    assert out_bytes == mem["output_bytes"], (out_bytes, mem)
    assert bool(torch.isfinite(out).all()), "non-finite global params"
    ulp = tree_map(lambda t: torch.nextafter(t, torch.full_like(
        t, math.inf)), init)
    with tf32_off(), deterministic_convs():
        kernel = eng_k.run_round(*args)[1].clone()
        plain = {}
        for label, start in (("plain", init), ("plain again", init),
                             ("plain, init + 1 ulp", ulp)):
            eng_p, gp_p = engine(False, start)
            plain[label] = eng_p.run_round(state, gp_p, batches, w,
                                           gw)[1].clone()
    d_kernel = (kernel - plain["plain"]).abs().max().item()
    d_again = (plain["plain again"] - plain["plain"]).abs().max().item()
    d_ulp = (plain["plain, init + 1 ulp"] - plain["plain"]).abs().max().item()
    assert d_kernel <= d_ulp, (
        f"kernel round drifts from plain ({d_kernel}) beyond a one-ulp "
        f"change of the init ({d_ulp})")
    eng_p, gp_p = engine(False)
    with FlopCounterMode(display=False) as counter:
        eng_p.run_round(state, gp_p, batches, w, gw)
    assert counter.get_total_flops() == flops, \
        (counter.get_total_flops(), flops)

    cfg = FLConfig(population=c, method="fed2", mode="async",
                   buffer_k=FL_CARD_EVENT_K)
    ev = lower_async_event(task, cfg, mesh, use_kernel=True)
    ev_mem = fl_dryrun.memory(ev, mesh)
    assert ev_mem["argument_bytes"] == FL_CARD_EVENT_BYTES, ev_mem
    fused = {}
    for kernels in (True, False):
        eng_a = make_async_engine(task, cfg, init, device="cuda",
                                  use_kernel=kernels)
        rows = eng_a.buffer
        rows.copy_(eng_k.cohort[:FL_CARD_EVENT_K])
        w_ev = w[:FL_CARD_EVENT_K].clone()
        ev_args = (eng_a.init_server_state(gp), gp, rows, w_ev)
        if kernels:
            ev_held = sum(tree_bytes(a) for a, r in zip(ev_args, ev.reads)
                          if r)
            assert ev_held == ev_mem["argument_bytes"], (ev_held, ev_mem)
            (_, fused[kernels]), ev_counts = counted(
                f"fl dry-run fed2 async event, K = {FL_CARD_EVENT_K}",
                lambda: eng_a.event_fn(*ev_args), {"paired_fusion": 1})
        else:
            fused[kernels] = eng_a.event_fn(*ev_args)[1]
    d_event = (fused[True] - fused[False]).abs().max().item()
    assert d_event <= FUSION_PARITY_TOL, d_event
    del eng_k, eng_p, eng_a, kernel, plain
    free_device_memory()
    rank_line = fl_dryrun_rank0(task, step.cfg, init, batches, w, gw, smi)
    del batches
    free_device_memory()
    return [f"fl dry-run 16x16 fed2 case on (1, 1): record built and meta "
            f"pass in {t_meta:.1f} s (pass {t_pass:.1f} s); allocated "
            f"{held:,} B = the record's argument_bytes; run_round "
            f"{t_round * 1e3:.1f} ms wall (first), paired_fusion "
            f"{counts['paired_fusion']} (presence-weighted: one a shared "
            f"leaf and a (pre, group) block; {shared['paired_fusion']} "
            f"with shared weights), local_step {counts['local_step']}; "
            f"outputs {out_bytes:,} B = output_bytes ({smi})",
            f"kernel round vs plain max |d| {d_kernel:.3g} (plain again "
            f"{d_again:.3g}, plain at init + 1 ulp {d_ulp:.3g}); plain-route "
            f"FLOPs on the card {flops:.6g} = the meta pass's ({smi})",
            f"fl dry-run fed2 async event K = {FL_CARD_EVENT_K} on (1, 1): "
            f"read arguments {ev_held:,} B = the record's (the global "
            f"params unread), paired_fusion {ev_counts['paired_fusion']}, "
            f"kernel vs plain fuse max |d| {d_event:.3g} ({smi})",
            rank_line]


def fl_dryrun_rank0(task, cfg, init, batches, w, gw, smi) -> str:
    """Rank 0's program of the 16x16 fed2 round on real memory at full
    width: the engine on rank 0 of a dry (16, 16) mesh (its 1 of the 16
    cohort rows; nothing moves) with the local_step kernel, from the
    (1, 1) round's init, rank 0's rows of its batches and the whole
    cohort's weights and presence rows. local_step launches the round's
    steps, paired_fusion none (off on ranks); the mesh's counts equal
    the meta record's collectives; the global is finite."""
    from repro_torch.fl.engine import make_round_engine
    from repro_torch.launch import fl_dryrun
    from repro_torch.launch.mesh import make_dry_rank_mesh
    from repro_torch.models.module import tree_map
    rec = json.loads((FL_DRYRUN_OUT / "pod" /
                      "dryrun_fl_round_fed2_cnn_16x16.json").read_text())
    mesh = make_dry_rank_mesh((16, 16), 0, device="cuda")
    steps = FL_CARD_CASE["local_steps"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = make_round_engine(task, cfg, init, device="cuda",
                            use_local_kernel=True, mesh=mesh)
    gp = eng.layout.flatten(tree_map(lambda t: t.to("cuda"), init))
    mine = {k: b[eng.rows] for k, b in batches.items()}
    mesh.counts.reset()
    (_, out), counts = counted(
        "fl dry-run 16x16 fed2, rank 0 of a dry (16, 16) mesh",
        lambda: eng.run_round({"server": (), "clients": ()}, gp, mine, w,
                              gw),
        {"local_step": steps, "paired_fusion": 0})
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    got, _ = fl_dryrun.collectives(mesh.counts)
    assert got == rec["collectives"], (got, rec["collectives"])
    assert bool(torch.isfinite(out).all()), "non-finite global params"
    rows = eng.rows.stop - eng.rows.start
    del eng, gp, out
    return (f"fl dry-run 16x16 fed2, rank 0 of a dry (16, 16) mesh on the "
            f"card: {rows} of {cfg.cohort_size} cohort rows, local_step "
            f"{counts['local_step']}, paired_fusion "
            f"{counts['paired_fusion']}; collectives "
            f"{ {k: v for k, v in got.items() if v['count']} } = the "
            f"record's; global finite; {wall:.2f} s wall with the build "
            f"(first run), peak {peak / 1e9:.3f} GB ({smi})")


def phase_fl_dryrun():
    """The federated dry-run's byte accounting on both meshes and the
    16x16 fed2 case on the card; one line per part."""
    smi = nvidia_smi()
    t0 = time.time()
    lines = fl_dryrun_accounting(smi) + fl_dryrun_card(smi)
    for line in lines:
        print(f"  {line}", flush=True)
    print(f"  fl_dryrun phase {time.time() - t0:.1f} s (budget "
          f"{FL_DRYRUN_BUDGET_S} s)", flush=True)


# ---------------------------------------------------------------------------
# ranks: multi-rank execution over torch.distributed, ranks sharing card 0
# ---------------------------------------------------------------------------

# the phase's budget (printed beside its time)
RANKS_BUDGET_S = 100
# (a) the CLI's main path on 2 "data" ranks (5 of the 10 clients each), 2
# rounds, against the same run in one process on the card
RANKS_FL_RUNS = (("fed2", ("--method", "fed2")),
                 ("fed2 --use-local-kernel",
                  ("--method", "fed2", "--use-local-kernel")),
                 ("fedavg", ("--method", "fedavg")))
RANKS_FL_ROUNDS = 2
# the ranks' global against the one-process run's: the largest |d| of
# each leaf over that leaf's largest magnitude, and of the whole global
# over its largest, each within RANKS_FL_RTOL or within what a one-ulp
# change of the init does to the one-process run, whichever is larger
# (TF32 off, deterministic convs in every process): the ranks sum the
# fusion's rows in another order and take each gradient over 5 clients,
# not 10, and 16 steps of the full VGG9 carry that round-off as they
# carry the init's ulp. tests/test_torch_ranks_round.py holds 1e-5 a
# leaf on the CPU (measured there: 1.2e-7 to 3.6e-7 after 2 rounds)
RANKS_FL_RTOL = 1e-5
# (b) one full-width MoE layer of each arch on a (2, 4) mesh of 8 ranks,
# bf16, tokens (4, 512, d): each rank draws only its experts (expert e
# from EP_SEED + 1 + 3e, its three matrices apart); the ranks' outputs
# must equal moe_apply_ep_plain's on the card to the bit
# the main path's eval all-reduce a round: the (10, 10) float32
# confusion counts (no part of a round record, taken off the measured
# counts before they are held against the dry-run's prediction)
RANKS_EVAL_BYTES = 10 * 10 * 4
EP_ARCHS = ("mixtral-8x22b", "deepseek-v2-236b")
EP_MESH = (2, 4)
EP_TOKENS = (4, 512)
EP_SEED = 7


def ranks_run(mesh, argv, **kw):
    """The CLI run of ``argv`` on this rank (``kw`` passed on to
    ``run_federated``: a checkpoint directory, ``resume``): its final
    params (on the host), accuracies, round or event walls, an async
    run's events and local tiles, the local_step launches of its rows
    and its collectives."""
    from repro_torch.fl.runtime import run_federated
    from repro_torch.kernels.local_step import local_step
    from repro_torch.launch import train
    from repro_torch.models.module import tree_map
    args = train.parse_args(argv)
    mesh.counts.reset()
    local_step.launches = 0
    h = run_federated(*train.fl_inputs(args), mesh=mesh,
                      latency=args.latency,
                      use_local_kernel=args.use_local_kernel, **kw)
    finite_params(h)
    return {"final": tree_map(lambda t: t.cpu(), h["final_params"]),
            "acc": h["acc"], "wall": h["wall"],
            "events": {k: h[k] for k in ("participants", "staleness",
                                         "sim_time", "local_tiles")
                       if k in h},
            "local_step": local_step.launches,
            "collectives": mesh.counts.as_dict()}


def ranks_fl(mesh, runs):
    """Each CLI argv of ``runs`` on this rank (``ranks_run``), TF32 off,
    deterministic convs."""
    with tf32_off(), deterministic_convs():
        return [ranks_run(mesh, argv) for argv in runs]


def leaf_rel_diff(a, b) -> tuple:
    """Two params trees' distance: (max over leaves of max |a - b| / max
    |b|, max |a - b| / max |b| over the whole tree)."""
    from repro_torch.models.module import tree_leaves
    pairs = [(x.cpu(), y.cpu())
             for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True)]
    d = [(x - y).abs().max().item() for x, y in pairs]
    m = [y.abs().max().item() for _, y in pairs]
    return (max(di / max(mi, 1e-30) for di, mi in zip(d, m)),
            max(d) / max(m))


def ranks_dry_prediction(task, fl, steps) -> tuple:
    """The dry-run's prediction of one round on each rank of a (2, 1)
    mesh: rank 0's program of the round on meta (``lower_round``'s
    ``rank``), as a record's ``collectives`` and
    ``collectives_staged``."""
    from repro_torch.fl.engine import lower_round
    from repro_torch.launch import fl_dryrun
    from repro_torch.launch.mesh import AXES, Mesh
    step = lower_round(task, fl, Mesh(AXES, (2, 1)),
                       fl_dryrun._batch_elems("cnn", fl.batch_size, 0),
                       local_steps=steps)
    return fl_dryrun.collectives(fl_dryrun.rank_counts(step))


def ranks_measured_round(c) -> tuple:
    """A rank's measured counts (``Counts.as_dict()``) of
    RANKS_FL_ROUNDS rounds as one round's, the eval's all-reduce taken
    off, by the record's kinds: (collectives, the staged bytes it
    measured)."""
    from repro_torch.launch import fl_dryrun
    from repro_torch.launch.collectives import Counts
    assert all(n % RANKS_FL_ROUNDS == 0 for d in c.values()
               for n in d.values()), c
    counts = Counts(**{k: {kind: n // RANKS_FL_ROUNDS
                           for kind, n in d.items()}
                       for k, d in c.items()})
    counts.calls["all_reduce"] -= 1
    for d, n in ((counts.bytes, RANKS_EVAL_BYTES),
                 (counts.result, RANKS_EVAL_BYTES),
                 (counts.staged, 2 * RANKS_EVAL_BYTES)):
        d["all_reduce"] -= n
    coll, _ = fl_dryrun.collectives(counts)
    return coll, {x: counts.staged[k] if k else 0
                  for x, k in fl_dryrun.XLA_KINDS}


def later_round_s(wall) -> float:
    return (wall[-1] - wall[0]) / max(len(wall) - 1, 1)


def ranks_main_path(smi):
    """(a): RANKS_FL_RUNS on 2 ranks over gloo, against one process;
    each rank's counts a round (the eval's all-reduce off) equal to the
    dry-run's (2, 1) prediction of the same round."""
    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.module import tree_map
    argvs = [["--mode", "fl", "--rounds", str(RANKS_FL_ROUNDS), *extra]
             for _, extra in RANKS_FL_RUNS]
    t0 = time.time()
    per_rank = spawn(ranks_fl, (2, 1), backend="gloo", device="cuda",
                     args=(argvs,))
    print(f"  2 ranks (gloo, both on cuda:0), {len(argvs)} runs of "
          f"{RANKS_FL_ROUNDS} rounds: {time.time() - t0:.1f} s with start-up",
          flush=True)
    steps = train.parse_args([]).steps_per_epoch
    for (label, _), argv, ranks in zip(RANKS_FL_RUNS, argvs,
                                       zip(*per_rank)):
        args = train.parse_args(argv)
        task, fl, parts, get_batch, test = train.fl_inputs(args)
        init = task.init_fn(torch.Generator().manual_seed(args.seed))
        one = {}
        with tf32_off(), deterministic_convs():
            for key, start in (("one", init), ("ulp", tree_map(
                    lambda t: torch.nextafter(t, torch.full_like(
                        t, math.inf)), init))):
                one[key] = run_federated(
                    task, fl, parts, get_batch, test, device="cuda",
                    use_local_kernel=args.use_local_kernel,
                    init_params=start)
        d = [leaf_rel_diff(r["final"], one["one"]["final_params"])
             for r in ranks]
        d_ulp = leaf_rel_diff(one["ulp"]["final_params"],
                              one["one"]["final_params"])
        c = ranks[0]["collectives"]
        limit = [max(RANKS_FL_RTOL, u) for u in d_ulp]
        print(f"  {label}: ranks vs one process, max |d| / max |leaf| "
              f"over leaves and over the global: {d[0][0]:.3g}, "
              f"{d[0][1]:.3g} (rank 1: {d[1][0]:.3g}, {d[1][1]:.3g}; the "
              f"one-process run from init + 1 ulp: {d_ulp[0]:.3g}, "
              f"{d_ulp[1]:.3g}; limits {limit[0]:.3g}, {limit[1]:.3g}); "
              f"acc ranks "
              f"{ranks[0]['acc'][-1]:.4f}, one process "
              f"{one['one']['acc'][-1]:.4f}; local_step launches per rank "
              f"{[r['local_step'] for r in ranks]}; collectives per rank: "
              f"calls {c['calls']}, bytes {c['bytes']}, staged "
              f"{c['staged']}; s/round (round 2) ranks "
              f"{later_round_s(ranks[0]['wall']):.3f}, one process "
              f"{later_round_s(one['one']['wall']):.3f} ({smi})",
              flush=True)
        assert all(x <= lim for di in d for x, lim in zip(di, limit)), \
            (label, d, d_ulp)
        assert leaf_rel_diff(ranks[0]["final"], ranks[1]["final"]) == (0, 0)
        expect = steps * RANKS_FL_ROUNDS if args.use_local_kernel else 0
        assert [r["local_step"] for r in ranks] == [expect] * 2, label
        # a fusion and an eval all-reduce a round, one dtype segment
        assert c["calls"] == {"all_reduce": 2 * RANKS_FL_ROUNDS,
                              "all_to_all": 0, "all_gather": 0}, c
        t1 = time.time()
        pred = ranks_dry_prediction(task, fl, steps)
        t_pred = time.time() - t1
        measured = [ranks_measured_round(r["collectives"]) for r in ranks]
        shown = [{k: v for k, v in coll.items() if v["count"]}
                 for coll, _ in [pred] + measured]
        print(f"  {label}: a round per rank, the eval's all-reduce off: "
              f"dry-run (2, 1) prediction {shown[0]}, staged "
              f"{ {k: v for k, v in pred[1].items() if v} } (rank 0 on "
              f"meta, {t_pred:.1f} s); measured rank 0 {shown[1]}, rank 1 "
              f"{shown[2]}, staged "
              f"{[{k: v for k, v in m[1].items() if v} for m in measured]}"
              f" ({smi})", flush=True)
        assert all(m == pred for m in measured), (label, pred, measured)


def ep_weights(cfg, experts, dtype=torch.bfloat16):
    """A full-width MoE FFN's weights for ``experts`` (a range of expert
    ids) drawn on the card, expert by expert from its own seed: a rank
    draws only the experts it owns, equal to the same experts drawn with
    all of them. The router and the shared expert are replicated."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    gen = torch.Generator(device="cuda")

    def draw(shape, fan_in, seed, out=None):
        gen.manual_seed(seed)
        w = torch.randn(shape, generator=gen, device="cuda") * fan_in ** -.5
        return w.to(dtype) if out is None else out.copy_(w)

    p = {"router": {"w": draw((d, e), d, EP_SEED)}}
    for i, (name, shape, fan) in enumerate((("w_gate", (d, f), d),
                                            ("w_up", (d, f), d),
                                            ("w_down", (f, d), f))):
        p[name] = torch.empty((len(experts),) + shape, dtype=dtype,
                              device="cuda")
        for j, x in enumerate(experts):
            draw(shape, fan, EP_SEED + 1 + 3 * x + i, out=p[name][j])
    if cfg.n_shared:
        fs = cfg.d_ff_shared or cfg.n_shared * f
        p["shared"] = {"w_gate": {"w": draw((d, fs), d, EP_SEED - 1)},
                       "w_up": {"w": draw((d, fs), d, EP_SEED - 2)},
                       "w_down": {"w": draw((fs, d), fs, EP_SEED - 3)}}
    return p


def ep_tokens(cfg):
    gen = torch.Generator(device="cuda").manual_seed(EP_SEED)
    return torch.randn(EP_TOKENS + (cfg.d_model,), generator=gen,
                       device="cuda").to(torch.bfloat16)


def ranks_moe(mesh):
    """(b) on this rank: each EP_ARCHS layer over its data shard of the
    tokens and its experts, once to warm up and once timed (after a
    barrier): its output and aux on the host, the timed call's seconds,
    all-to-alls and peak memory."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models.moe_ep import moe_apply_ep
    out = {}
    nsh, j = mesh.shape["model"], mesh.coord("model")
    for arch in EP_ARCHS:
        cfg = get_config(arch).moe
        e_loc = cfg.n_experts // nsh
        p = ep_weights(cfg, range(j * e_loc, (j + 1) * e_loc))
        x = ep_tokens(cfg)
        bl = x.shape[0] // mesh.shape["data"]
        x = x[mesh.coord("data") * bl:(mesh.coord("data") + 1) * bl]
        torch.cuda.reset_peak_memory_stats()
        moe_apply_ep(p, x, cfg, mesh=mesh)
        mesh.counts.reset()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.time()
        y, aux = moe_apply_ep(p, x, cfg, mesh=mesh)
        torch.cuda.synchronize()
        out[arch] = {"y": y.cpu(), "aux": float(aux),
                     "s": time.time() - t0,
                     "collectives": mesh.counts.as_dict(),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del p, x, y
        free_device_memory()
    return out


def ranks_moe_layers(smi):
    """(b): EP_ARCHS on an EP_MESH of 8 ranks over gloo, against
    moe_apply_ep_plain on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.moe_ep import moe_apply_ep_plain
    t0 = time.time()
    per_rank = spawn(ranks_moe, EP_MESH, backend="gloo", device="cuda")
    print(f"  {EP_MESH} mesh of {len(per_rank)} ranks (gloo, all on "
          f"cuda:0): {time.time() - t0:.1f} s with start-up", flush=True)
    data, model = EP_MESH
    for arch in EP_ARCHS:
        cfg = get_config(arch).moe
        p, x = ep_weights(cfg, range(cfg.n_experts)), ep_tokens(cfg)
        torch.cuda.synchronize()
        t1 = time.time()
        y, aux = moe_apply_ep_plain(p, x, cfg, data=data, model=model)
        torch.cuda.synchronize()
        plain_s = time.time() - t1
        bl = x.shape[0] // data
        diffs = []
        for r, res in enumerate(per_rank):
            mine = res[arch]
            di = r // model
            want = y[di * bl:(di + 1) * bl].cpu()
            assert torch.isfinite(mine["y"].float()).all(), (arch, r)
            diffs.append((mine["y"].float() - want.float()).abs().max()
                         .item())
        c = per_rank[0][arch]["collectives"]
        print(f"  {arch} (E {cfg.n_experts}, top-{cfg.top_k}, d "
              f"{cfg.d_model}, d_ff {cfg.d_ff_expert}), tokens "
              f"{EP_TOKENS + (cfg.d_model,)} bf16: per rank max |y - "
              f"plain| {diffs}; aux rank 0 {per_rank[0][arch]['aux']:.6g}, "
              f"plain {float(aux):.6g}; all-to-alls per rank "
              f"{c['calls']['all_to_all']}, {c['bytes']['all_to_all']:,} B "
              f"({c['staged']['all_to_all']:,} B staged through the host); "
              f"wall of the timed call, slowest rank "
              f"{max(r[arch]['s'] for r in per_rank):.3f} s, plain in one "
              f"process {plain_s:.3f} s; peak per rank "
              f"{max(r[arch]['peak_gb'] for r in per_rank):.2f} GB ({smi})",
              flush=True)
        assert max(diffs) == 0, (arch, diffs)
        assert per_rank[0][arch]["aux"] == float(aux)
        del p, x, y
        free_device_memory()


def phase_ranks():
    """(a) the main path on 2 data ranks, (b) the MoE layers on 8 ranks,
    (c) fed2_cifar_fl --mesh host; the kernels were built by phase_build
    (ranks load them)."""
    smi = nvidia_smi()
    t0 = time.time()
    free_device_memory()
    ranks_main_path(smi)
    ranks_moe_layers(smi)
    from repro_torch.examples import fed2_cifar_fl
    counted("fed2_cifar_fl --mesh host --rounds 1",
            lambda: fed2_cifar_fl.main(["--mesh", "host", "--rounds", "1"]),
            {"paired_fusion": 2})
    print(f"  ranks phase {time.time() - t0:.1f} s (budget "
          f"{RANKS_BUDGET_S} s)", flush=True)


# ---------------------------------------------------------------------------
# ranks matrix: the whole sync round on data ranks, ranks sharing card 0
# ---------------------------------------------------------------------------

# the phase's budget (printed beside its time)
RANKS_MATRIX_BUDGET_S = 210
# the CLI's full-width runs (vgg9.full(fed2_groups=8) for fed2,
# vgg9.baseline() for the rest; 10 clients, 8 steps of batch 32) on 2
# "data" ranks, 2 rounds, against one process: (label, flags, all-reduces
# and all-gathers a round). A round's eval all-reduces once; the fusion
# all-reduces once, or a reducing rule gathers the rows instead;
# scaffold gathers its new c_i rows, fedma its trained rows
RANKS_MATRIX_RUNS = (
    ("fedprox --use-local-kernel",
     ("--method", "fedprox", "--use-local-kernel"), (2, 0)),
    ("fednova --use-local-kernel",
     ("--method", "fednova", "--use-local-kernel"), (2, 0)),
    ("fedma --use-local-kernel",
     ("--method", "fedma", "--use-local-kernel"), (1, 1)),
    ("scaffold", ("--method", "scaffold"), (2, 1)),
    ("fed2 sign_flip(4) trimmed_mean(0.25)",
     ("--method", "fed2", "--attack", "sign_flip(4)", "--attack-fraction",
      "0.2", "--robust", "trimmed_mean(0.25)"), (1, 1)),
    ("fedavg label_flip", ("--method", "fedavg", "--attack", "label_flip",
                           "--attack-fraction", "0.2"), (2, 0)),
    ("fed2 int8", ("--method", "fed2", "--codec", "int8"), (2, 0)),
    ("fed2 bfloat16", ("--method", "fed2", "--compute-dtype", "bfloat16"),
     (2, 0)),
)
RANKS_MATRIX_ROUNDS = 2
# the one-process runs take each vmapped gradient over RANKS_MATRIX_CHUNK
# clients (run_federated's grad_chunk), the rows a rank holds: cuDNN
# picks its convolution algorithms by batch size, so a gradient over 10
# clients and one over 5 differ in round-off, which a trimmed mean turns
# into another choice of trimmed clients
RANKS_MATRIX_CHUNK = 5
# the ranks' global against one process's: each of leaf_rel_diff's two
# distances within RANKS_FL_RTOL or within RANKS_MATRIX_SPREAD times what
# a one-ulp change of the init does to the one-process run, whichever is
# larger. The ranks sum the fused rows in another order, a perturbation
# of the round-1 global of the ulp's size that 16 local steps carry as
# far; the CPU tests hold twice the spread too
# (tests/ranks_parity.within_spread)
RANKS_MATRIX_SPREAD = 2
# runs whose fusion sorts or matches the gathered rows instead of
# summing them: on the same rows every rank runs the one-process
# reduction, so they must equal the one-process run to the bit
RANKS_MATRIX_EXACT = ("fedma --use-local-kernel",
                      "fed2 sign_flip(4) trimmed_mean(0.25)")
# run_scenario(mesh=) of this registered spec (its reduced VGG9 and 10
# clients, 2 attackers), cut to 2 rounds
RANKS_MATRIX_SCENARIO = "nxc2_fed2_signflip20_trim"
# the sharded reducing rules against one process on one (10, M) cohort
# of the main path's model, through fedavg and through paired averaging
# under presence rows
RANKS_MATRIX_RULES = ("trimmed_mean(0.25)", "coordinate_median")
RANKS_MATRIX_SEED = 11
# the rest of the federation on the same 2 ranks, in the same spawn:
# (label, flags, the clients a gradient call of the one-process run it is
# held against (the rows a rank holds of a tile: cuDNN picks its
# algorithms by batch size); None where it is held against other runs on
# the ranks instead, all-reduces a round or event: one a tile that
# splits over the ranks or an event's fusion, one an eval). fed2's tiers
# run at --fed2-groups 5: the 0.6 and 0.2 tiers keep whole groups only
# where w * G is an integer, so the CLI's G = 8 refuses them
RANKS_REST_COHORT = ("--cohort-size", "4", "--sampler", "uniform")
RANKS_REST_ASYNC = (*RANKS_REST_COHORT, "--fed-mode", "async")
RANKS_REST_EVENTS = 4
RANKS_REST_RUNS = (
    ("async fed2 --use-local-kernel, buffer_k 2",
     ("--method", "fed2", "--use-local-kernel", *RANKS_REST_ASYNC,
      "--buffer-k", "2", "--staleness", "polynomial(0.5)", "--latency",
      "pareto(1.5)", "--rounds", str(RANKS_REST_EVENTS)), 2, 2),
    ("async fed2 --use-local-kernel, buffer_k = cohort, zero latency",
     ("--method", "fed2", "--use-local-kernel", *RANKS_REST_ASYNC), None,
     2),
    ("sync fed2 --use-local-kernel, cohort 4",
     ("--method", "fed2", "--use-local-kernel", *RANKS_REST_COHORT), None,
     2),
    ("tiers fed2 --fed2-groups 5 1.0x2,0.6x2,0.2x2 --use-local-kernel",
     ("--method", "fed2", "--fed2-groups", "5", "--nodes", "6", "--tiers",
      "1.0x2,0.6x2,0.2x2", "--use-local-kernel"), 1, 4),
    ("tiers fedavg 1.0x2,0.5x2,0.25x2 --use-local-kernel",
     ("--method", "fedavg", "--nodes", "6", "--tiers",
      "1.0x2,0.5x2,0.25x2", "--use-local-kernel"), 1, 4),
    ("tiers fedavg 1.0x2,0.5x2,0.25x1 --use-local-kernel (a 1-client "
     "tier, replicated)",
     ("--method", "fedavg", "--nodes", "5", "--tiers",
      "1.0x2,0.5x2,0.25x1", "--use-local-kernel"), 1, 3),
    ("scaffold --store mmap", ("--method", "scaffold", "--store", "mmap",
                               "--chunk-size", "4"), None, 2),
)
# held against the matrix's memory-store run of this label to the bit
RANKS_REST_MMAP_OF = "scaffold"
# checkpoints: this run saved after round 1, then resumed to round 2,
# against the same run straight through 2 rounds (its own checkpoint)
RANKS_REST_CKPT = ("--method", "fed2", "--use-local-kernel")


@contextlib.contextmanager
def gradients_in_chunks(n: int):
    """Within the block, ``run_federated`` takes its vmapped gradients
    ``n`` clients at a time (``grad_chunk``), whoever calls it
    (``run_scenario`` among them)."""
    from repro_torch.fl import runtime
    run = runtime.run_federated

    def chunked(*args, **kw):
        return run(*args, **{**kw, "grad_chunk": n})
    runtime.run_federated = chunked
    try:
        yield
    finally:
        runtime.run_federated = run


@contextlib.contextmanager
def last_global():
    """Within the block, each sync round of ``run_federated`` leaves its
    new global (a params tree on the host) in the yielded dict."""
    from repro_torch.fl import runtime
    seen = {}
    run_round = runtime.run_sampled_round

    def spy(engine, *args, **kw):
        server, glob = run_round(engine, *args, **kw)
        seen["global"] = engine.layout.unflatten(glob)
        return server, glob
    runtime.run_sampled_round = spy
    try:
        yield seen
    finally:
        runtime.run_sampled_round = run_round


def matrix_fuse(rule, grouped, shard=None):
    """One reducing-rule fusion of the (10, M) cohort of the main path's
    model drawn on the card from RANKS_MATRIX_SEED (and (10, 8) presence
    rows): through ``paired_average`` under the presence rows
    (``grouped``) or ``fedavg``; the whole cohort, or ``shard``'s block."""
    from repro_torch.configs import vgg9
    from repro_torch.core import fusion
    from repro_torch.fl import robust
    from repro_torch.models.cnn import init_cnn
    cfg = vgg9.full(fed2_groups=8)
    layout = main_layout()
    gen = torch.Generator(device="cuda").manual_seed(RANKS_MATRIX_SEED)
    x = cohort(layout, 10, torch.float32, gen, 0.05)
    w = torch.rand(10, generator=gen, device="cuda") + 0.5
    gw = torch.rand(10, 8, generator=gen, device="cuda")
    if shard is not None:
        x = x[shard.lo:shard.hi]
    r = robust.parse_robust(rule)
    if not grouped:
        return fusion.fedavg(x, w, robust=r, shard=shard)
    axes = fusion.cnn_group_axes(
        init_cnn(torch.Generator().manual_seed(0), cfg), cfg)
    return fusion.paired_average(x, layout, axes, weights=w,
                                 group_weights=gw, robust=r, shard=shard)


def rest_argv(flags, rounds=RANKS_MATRIX_ROUNDS):
    return ["--mode", "fl", "--rounds", str(rounds), *flags]


def ranks_rest_rank(mesh, ckdir):
    """This rank's part of the rest of the federation: RANKS_REST_RUNS,
    then the checkpointed runs (RANKS_REST_CKPT; checkpoints under
    ``ckdir``, written by rank 0), TF32 off and deterministic convs."""
    out = {}
    ck = os.path.join(ckdir, "resumable")
    with tf32_off(), deterministic_convs():
        out["runs"] = [ranks_run(mesh, rest_argv(flags))
                       for _, flags, _, _ in RANKS_REST_RUNS]
        out["first"] = ranks_run(mesh, rest_argv(RANKS_REST_CKPT, 1),
                                 checkpoint_dir=ck)
        out["listing"] = sorted(os.listdir(ck))
        out["resumed"] = ranks_run(mesh, rest_argv(RANKS_REST_CKPT),
                                   checkpoint_dir=ck, resume=True)
        out["straight"] = ranks_run(mesh, rest_argv(RANKS_REST_CKPT),
                                    checkpoint_dir=os.path.join(
                                        ckdir, "straight"))
    return out


def ranks_matrix_rank(mesh, argvs, spec, ckdir):
    """This rank's part of the phase: ``ranks_fl``'s runs, then
    ``run_scenario(spec, mesh=)`` and the sharded reducing rules, TF32
    off and deterministic convs, then ``ranks_rest_rank``'s."""
    import types

    from repro_torch.fl import engine as engine_lib
    from repro_torch.fl.scenarios import run_scenario
    out = {"runs": ranks_fl(mesh, argvs)}
    with tf32_off(), deterministic_convs(), last_global() as seen:
        mesh.counts.reset()
        t0 = time.time()
        rec = run_scenario(spec, mesh=mesh)
        out["scenario"] = {"acc": rec.acc, "s": time.time() - t0,
                           "global": _host(seen["global"]),
                           "collectives": mesh.counts.as_dict()}
    fused = []
    for rule in RANKS_MATRIX_RULES:
        for grouped in (False, True):
            mesh.counts.reset()
            shard = engine_lib._row_shard(
                types.SimpleNamespace(cohort_size=10), mesh)
            fused.append((matrix_fuse(rule, grouped, shard).cpu(),
                          mesh.counts.as_dict()))
    out["fused"] = fused
    out["rest"] = ranks_rest_rank(mesh, ckdir)
    return out


def _host(tree):
    from repro_torch.models.module import tree_map
    return tree_map(lambda t: t.detach().cpu(), tree)


def ulp_up(tree, bf16: bool):
    """``tree`` moved up by one ulp of each weight: of fp32, or for a
    bf16 local phase about one bf16 ulp (2^-8 of each weight's
    magnitude), which the round's cast down keeps."""
    from repro_torch.models.module import tree_map
    if bf16:
        return tree_map(lambda t: t + t.abs() * 2.0 ** -8, tree)
    return tree_map(lambda t: torch.nextafter(
        t, torch.full_like(t, math.inf)), tree)


def one_process_pair(run):
    """``run(up)`` from the init and from ``ulp_up`` of it, in one
    process on the card, TF32 off, deterministic convs, gradients over
    RANKS_MATRIX_CHUNK clients at a time."""
    with tf32_off(), deterministic_convs(), \
            gradients_in_chunks(RANKS_MATRIX_CHUNK):
        return run(False), run(True)


def one_process_run(argv, chunk, up=False, **kw):
    """The CLI run of ``argv`` in one process on the card, from the
    seeded init (``up``: ``ulp_up`` of it), TF32 off, deterministic
    convs, gradients over ``chunk`` clients a call; ``kw`` passed on to
    ``run_federated``."""
    from repro_torch.fl import runtime
    from repro_torch.launch import train
    args = train.parse_args(argv)
    task, fl, parts, get_batch, test = train.fl_inputs(args)
    init = task.init_fn(torch.Generator().manual_seed(args.seed))
    with tf32_off(), deterministic_convs(), gradients_in_chunks(chunk):
        h = runtime.run_federated(
            task, fl, parts, get_batch, test, device="cuda",
            latency=args.latency, use_local_kernel=args.use_local_kernel,
            init_params=ulp_up(init, False) if up else init, **kw)
    finite_params(h)
    return h


def rest_line(label, ranks, one, d, d_ulp, smi):
    """One printed line of a run of the rest of the federation: the
    distances, the collectives over its rounds or events, local_step a
    rank and s/round beside one process's."""
    c, n = ranks[0]["collectives"], len(ranks[0]["wall"])
    unit = "event" if "staleness" in ranks[0]["events"] else "round"
    dist = ("" if d is None else
            f"ranks vs one process {d[0]:.3g}, {d[1]:.3g}"
            + ("" if d_ulp is None else
               f" (init + 1 ulp {d_ulp[0]:.3g}, {d_ulp[1]:.3g})") + "; ")
    print(f"  {label}: {dist}acc ranks {ranks[0]['acc'][-1]:.4f}"
          + ("" if one is None else f", one process {one['acc'][-1]:.4f}")
          + f"; collectives per rank over {n} {unit}s: calls "
          f"{c['calls']}, bytes {c['bytes']}, staged {c['staged']}; "
          f"local_step launches per rank "
          f"{[r['local_step'] for r in ranks]}; s/{unit} ranks "
          + (f"{later_round_s(ranks[0]['wall']):.3f}" if n > 1 else
             f"{ranks[0]['wall'][0]:.3f} (its only {unit}, the first)")
          + ("" if one is None else
             f", one process {later_round_s(one['wall']):.3f}")
          + f" ({smi})", flush=True)


def schedule(history) -> dict:
    """An async run's dispatch schedule as its history records it (all
    None for a sync run): staleness lists, simulated times, tiles."""
    return {k: history.get(k) for k in ("staleness", "sim_time",
                                        "local_tiles")}


def ranks_rest(per_rank, memory_ranks, smi):
    """RANKS_REST_RUNS and the checkpoints on the ranks against one
    process (twice the one-ulp spread), against each other and against
    the matrix's memory-store run (``memory_ranks``) to the bit."""
    from repro_torch.launch import train
    steps = train.parse_args([]).steps_per_epoch
    rest = [r["rest"] for r in per_rank]
    got = {}
    for i, (label, flags, chunk, reduces) in enumerate(RANKS_REST_RUNS):
        ranks = got[label] = [r["runs"][i] for r in rest]
        assert leaf_rel_diff(ranks[0]["final"], ranks[1]["final"]) == \
            (0, 0), label
        assert ranks[0]["acc"] == ranks[1]["acc"], label
        argv = rest_argv(flags)
        one = d = d_ulp = None
        if chunk is not None:
            one = one_process_run(argv, chunk)
            ulp = one_process_run(argv, chunk, up=True)
            d = [leaf_rel_diff(r["final"], one["final_params"])
                 for r in ranks]
            d_ulp = leaf_rel_diff(ulp["final_params"], one["final_params"])
            limit = [max(RANKS_FL_RTOL, RANKS_MATRIX_SPREAD * u)
                     for u in d_ulp]
            assert all(x <= lim for di in d for x, lim in zip(di, limit)), \
                (label, d, d_ulp)
            d = d[0]
        elif "mmap" in flags:
            one = one_process_run(argv, RANKS_MATRIX_CHUNK)
            d = leaf_rel_diff(ranks[0]["final"], one["final_params"])
        rest_line(label, ranks, one, d, d_ulp, smi)
        n = len(ranks[0]["wall"])
        ev = ranks[0]["events"]
        assert schedule(ranks[1]["events"]) == schedule(ev), label
        if one is not None:       # an async run's: the one-process one
            assert schedule(one) == schedule(ev), label
        stateful = "scaffold" in flags
        assert ranks[0]["collectives"]["calls"] == {
            "all_reduce": reduces * n, "all_to_all": 0,
            "all_gather": n if stateful else 0}, (label, ranks[0])
        tiles = (ev["local_tiles"] if "local_tiles" in ev else
                 n * (3 if "--tiers" in flags else 1))
        expect = tiles * steps if "--use-local-kernel" in flags else 0
        assert [r["local_step"] for r in ranks] == [expect] * 2, label
    kc, sync = (got[label] for label, *_ in RANKS_REST_RUNS[1:3])
    for a, b in zip(kc, sync):
        assert leaf_rel_diff(a["final"], b["final"]) == (0, 0)
        assert a["acc"] == b["acc"]
        assert a["collectives"] == b["collectives"]
    print("  async at buffer_k = cohort, zero latency: equal to the sync "
          "rounds on the same ranks to the bit", flush=True)
    mmap = got[RANKS_REST_RUNS[-1][0]]
    for a, b in zip(mmap, memory_ranks):
        assert leaf_rel_diff(a["final"], b["final"]) == (0, 0)
        assert a["acc"] == b["acc"]
    print(f"  scaffold --store mmap on the ranks: equal to the memory "
          f"store's run ({RANKS_REST_MMAP_OF!r}) to the bit", flush=True)
    # checkpoints: round 1 saved, resumed to round 2 = straight 2 rounds
    argv = rest_argv(RANKS_REST_CKPT)
    one = one_process_run(argv, RANKS_MATRIX_CHUNK)
    ulp = one_process_run(argv, RANKS_MATRIX_CHUNK, up=True)
    parts = {k: [r[k] for r in rest] for k in ("first", "resumed",
                                               "straight")}
    for k, ranks in parts.items():
        assert leaf_rel_diff(ranks[0]["final"], ranks[1]["final"]) == \
            (0, 0), k
    straight, resumed = parts["straight"][0], parts["resumed"][0]
    assert leaf_rel_diff(resumed["final"], straight["final"]) == (0, 0)
    assert resumed["acc"] == straight["acc"][1:]
    d = leaf_rel_diff(straight["final"], one["final_params"])
    d_ulp = leaf_rel_diff(ulp["final_params"], one["final_params"])
    assert all(x <= max(RANKS_FL_RTOL, RANKS_MATRIX_SPREAD * u)
               for x, u in zip(d, d_ulp)), (d, d_ulp)
    assert rest[0]["listing"] == rest[1]["listing"] == [
        "manifest.json", "params-1.npz"], rest[0]["listing"]
    for k, saves, rounds in (("first", 1, 1), ("resumed", 1, 1),
                             ("straight", 2, 2)):
        for r in parts[k]:
            c = r["collectives"]["calls"]
            assert c["barrier"] == 1 + saves, (k, c)
            assert c["all_reduce"] == 2 * rounds, (k, c)
            assert r["local_step"] == steps * rounds, k
        rest_line(f"fed2 --use-local-kernel, checkpoints: {k}",
                  parts[k], one if k == "straight" else None,
                  d if k == "straight" else None,
                  d_ulp if k == "straight" else None, smi)
    print("  the run resumed after round 1 equals the uninterrupted run to "
          "the bit; rank 0 wrote the checkpoint "
          f"({rest[0]['listing']}), both ranks read it", flush=True)


def phase_ranks_matrix():
    """Every method and axis of the sync round on 2 data ranks against one
    process on the card (RANKS_MATRIX_RUNS, RANKS_MATRIX_SCENARIO), the
    sharded reducing rules against one process to the bit, and the rest
    of the federation on the same ranks (``ranks_rest``)."""
    import tempfile

    from repro_torch.fl import runtime, scenarios
    from repro_torch.launch import train
    from repro_torch.launch.mesh import spawn
    smi = nvidia_smi()
    t0 = time.time()
    free_device_memory()
    argvs = [["--mode", "fl", "--rounds", str(RANKS_MATRIX_ROUNDS), *flags]
             for _, flags, _ in RANKS_MATRIX_RUNS]
    spec = scenarios.get(RANKS_MATRIX_SCENARIO).override(
        rounds=RANKS_MATRIX_ROUNDS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as ckdir:
        per_rank = spawn(ranks_matrix_rank, (2, 1), backend="gloo",
                         device="cuda", args=(argvs, spec, ckdir))
    print(f"  2 ranks (gloo, both on cuda:0), {len(argvs)} runs of "
          f"{RANKS_MATRIX_ROUNDS} rounds, a scenario, "
          f"{2 * len(RANKS_MATRIX_RULES)} fusions, "
          f"{len(RANKS_REST_RUNS)} async, tier and store runs and 3 "
          f"checkpointed runs: {time.time() - t0:.1f} s with start-up",
          flush=True)
    steps = train.parse_args([]).steps_per_epoch
    by_label = {}
    for (label, _, (reduces, gathers)), argv, ranks in zip(
            RANKS_MATRIX_RUNS, argvs, zip(*[r["runs"] for r in per_rank])):
        by_label[label] = ranks
        args = train.parse_args(argv)
        task, fl, parts, get_batch, test = train.fl_inputs(args)
        init = task.init_fn(torch.Generator().manual_seed(args.seed))
        bf16 = args.compute_dtype == "bfloat16"
        one, ulp = one_process_pair(lambda up: runtime.run_federated(
            task, fl, parts, get_batch, test, device="cuda",
            use_local_kernel=args.use_local_kernel,
            init_params=ulp_up(init, bf16) if up else init))
        for h in (one, ulp):
            finite_params(h)
        d = [leaf_rel_diff(r["final"], one["final_params"]) for r in ranks]
        d_ulp = leaf_rel_diff(ulp["final_params"], one["final_params"])
        limit = [max(RANKS_FL_RTOL, RANKS_MATRIX_SPREAD * u) for u in d_ulp]
        c = ranks[0]["collectives"]
        print(f"  {label}: ranks vs one process (gradients over "
              f"{RANKS_MATRIX_CHUNK} clients a call), max |d| / max |leaf| "
              f"over leaves and over the global: {d[0][0]:.3g}, "
              f"{d[0][1]:.3g} "
              f"(rank 1: {d[1][0]:.3g}, {d[1][1]:.3g}; one process from "
              f"{'init + 2^-8 |init|' if bf16 else 'init + 1 ulp'}: "
              f"{d_ulp[0]:.3g}, {d_ulp[1]:.3g}; limits {limit[0]:.3g}, "
              f"{limit[1]:.3g}); acc ranks "
              f"{ranks[0]['acc'][-1]:.4f}, one process "
              f"{one['acc'][-1]:.4f}; local_step launches per rank "
              f"{[r['local_step'] for r in ranks]}; collectives per rank: "
              f"calls {c['calls']}, bytes {c['bytes']}, staged "
              f"{c['staged']}; s/round (round 2) ranks "
              f"{later_round_s(ranks[0]['wall']):.3f}, one process "
              f"{later_round_s(one['wall']):.3f} ({smi})", flush=True)
        assert all(x <= lim for di in d for x, lim in zip(di, limit)), \
            (label, d, d_ulp)
        assert leaf_rel_diff(ranks[0]["final"], ranks[1]["final"]) == (0, 0)
        if label in RANKS_MATRIX_EXACT:
            assert d[0] == (0, 0), (label, d)
        expect = steps * RANKS_MATRIX_ROUNDS if args.use_local_kernel else 0
        assert [r["local_step"] for r in ranks] == [expect] * 2, label
        assert c["calls"] == {"all_reduce": reduces * RANKS_MATRIX_ROUNDS,
                              "all_to_all": 0,
                              "all_gather": gathers * RANKS_MATRIX_ROUNDS}, c
    # run_scenario(mesh=) against mesh=None: a trimmed mean, so the bits
    task = runtime.cnn_task(spec.model_config())
    init = task.init_fn(torch.Generator().manual_seed(spec.seed))
    got = [r["scenario"] for r in per_rank]

    def scenario(up):
        with last_global() as seen:
            t1 = time.time()
            rec = scenarios.run_scenario(
                spec, device="cuda",
                init_params=ulp_up(init, False) if up else init)
            return {"acc": rec.acc, "s": time.time() - t1,
                    "global": _host(seen["global"])}
    one, ulp = one_process_pair(scenario)
    d = leaf_rel_diff(got[0]["global"], one["global"])
    d_ulp = leaf_rel_diff(ulp["global"], one["global"])
    c = got[0]["collectives"]
    print(f"  run_scenario({RANKS_MATRIX_SCENARIO}, mesh=), "
          f"{RANKS_MATRIX_ROUNDS} rounds: ranks vs mesh=None {d[0]:.3g}, "
          f"{d[1]:.3g} (init + 1 ulp {d_ulp[0]:.3g}, {d_ulp[1]:.3g}); acc "
          f"ranks {got[0]['acc']}, one process {one['acc']}; collectives "
          f"per rank: calls {c['calls']}, bytes {c['bytes']}, staged "
          f"{c['staged']}; wall ranks {got[0]['s']:.2f} s, one process "
          f"{one['s']:.2f} s ({smi})", flush=True)
    assert leaf_rel_diff(got[0]["global"], got[1]["global"]) == (0, 0)
    assert got[0]["acc"] == got[1]["acc"] == one["acc"]
    assert d == (0, 0), (d, d_ulp)
    # the sharded reducing rules: one all-gather, the one-process bits
    i = 0
    for rule in RANKS_MATRIX_RULES:
        for grouped in (False, True):
            want = matrix_fuse(rule, grouped).cpu()
            for r in per_rank:
                fused, counts = r["fused"][i]
                assert torch.equal(fused, want), (rule, grouped)
                assert counts["calls"]["all_gather"] == 1, counts
                assert counts["calls"]["all_reduce"] == 0, counts
            how = "paired_average, presence rows" if grouped else "fedavg"
            print(f"  {rule} {how} on a (10, {want.numel():,}) cohort "
                  f"split 5 + 5: both "
                  f"ranks equal to one process to the bit; all-gather "
                  f"{counts['bytes']['all_gather']:,} B a rank "
                  f"({counts['staged']['all_gather']:,} B staged)",
                  flush=True)
            i += 1
    ranks_rest(per_rank, by_label[RANKS_REST_MMAP_OF], smi)
    took = time.time() - t0
    print(f"  ranks matrix phase {took:.1f} s (budget "
          f"{RANKS_MATRIX_BUDGET_S} s)", flush=True)


# ---------------------------------------------------------------------------
# ranks serve: the sharded prefill and decode on model ranks sharing card 0
# ---------------------------------------------------------------------------

# the phase's budget (printed beside its time)
RANKS_SERVE_BUDGET_S = 120
# the full-width, full-depth bf16 models served on ranks: (arch, Fed2
# groups); every one on a (1, 2) mesh, the Fed2 llama also on (2, 2)
# (its GQA exchanges, 13 grouped_matmul a step, 82 collectives a step
# against Mamba-2's 146)
RANKS_SERVE_MODELS = (("llama3.2-1b", 0), ("llama3.2-1b", 8),
                      ("mamba2-1.3b", 0), ("mamba2-1.3b", 8))
# the models also run on their ranks in fp32 (the bf16 weights upcast,
# TF32 off, both kernels in fp32), on the check's prompt, held to one
# process's fp32 run within RANKS_SERVE_FP32_TOL of each quantity's
# largest magnitude: Mamba-2's, where the bf16 rule below is loose (its
# bf16 run drifts 0.32-0.35 of the logits' scale from fp32 in 8 steps)
RANKS_SERVE_FP32 = (("mamba2-1.3b", 0), ("mamba2-1.3b", 8))
# The ranks' fp32 round-off (2^-24: the row-parallel sums, the split
# norm and GEMMs of other widths, in another order) grows through 48
# random-init layers and 8 steps, as bf16's does to 0.3: on an H100 the
# ranks came 3.1e-5 (logits) and 7.1e-5 (worst cache leaf) of the scale
# from one process, more than the ~5e-6 that a growth of r / 2^-8 ~ 80
# predicts (bf16's distance saturates, so it understates the growth). A
# wrong head, channel, state slot or stride is O(1) of the scale
RANKS_SERVE_FP32_TOL = 1e-4
# the spawns, in waves: each (mesh shape, model, rank body) its own
# spawn, a wave's spawns all at once. A rank's decode step waits on gloo
# far more than it computes (tools/rank_serve_costs.py: a Fed2 llama
# step 204 ms on 2 ranks, 49-54 ms on a dry mesh, 34.6 ms in one
# process; a gloo exchange 0.5-1.1 ms), so meshes on one card overlap.
# The one-process references run beside the first wave; the second
# wave's 8 ranks come after it (device memory), with the dry mesh's
# predictions beside them. Bodies: "serve" (ranks_serve_rank) and
# "fp32" (ranks_fp32_rank)
RANKS_SERVE_WAVES = (
    tuple(((1, 2), m, "serve") for m in RANKS_SERVE_MODELS),
    (((2, 2), ("llama3.2-1b", 8), "serve"),)
    + tuple(((1, 2), m, "fp32") for m in RANKS_SERVE_FP32))
# run_serve at the serve CLI's defaults (the path, counted)
RANKS_SERVE = dict(batch=4, prompt_len=32, gen=16, max_len=128, seed=0)
# the check held against one process: run_serve of a prompt of this many
# tokens and no decoded one (every step teacher-forced: the same tokens
# on the ranks and in one process, whatever a near-tie would decode)
RANKS_SERVE_CHECK = 8
# one prefill-loss step of (batch, seq) on seeded tokens
RANKS_PREFILL = (2, 2048)
# the kernels' launches a decode step on every rank (grouped_matmul,
# ssd_update): a Fed2 Llama's unembedding and 4 decoupled blocks x 3
# products, a Fed2 Mamba-2's unembedding (decouple 0), 48 SSM layers;
# a prefill step: one grouped_matmul a loss chunk (Fed2)
RANKS_SERVE_LAUNCHES = {("llama3.2-1b", 0): (0, 0),
                        ("llama3.2-1b", 8): (1 + 4 * 3, 0),
                        ("mamba2-1.3b", 0): (0, 48),
                        ("mamba2-1.3b", 8): (1, 48)}
# the ranks against one process in bf16, on the check's prompt: the
# logits, each cache leaf and the prefill loss within max(2^-7, 2 r) of
# the quantity's largest magnitude, r the distance of the one-process
# bf16 run from the same run in fp32 (weights upcast, TF32 off) over the
# same magnitude. The ranks add a few bf16 roundings to a computation
# that rounds every op to bf16: each row-parallel partial, and its sum,
# round once more (partials travel in bf16); the fp32 partial scores
# are rounded to bf16 after their sum, as one process rounds its
# product. The floor, one bf16 ulp (2^-7 of the largest magnitude),
# covers a leaf whose one-process rounding is exact where the ranks
# flip an ulp (a layer-0 projection through a GEMM of another width).
# For Mamba-2, 2 r is ~0.7 of the scale: there the fp32 check above is
# the one that can fail
RANKS_SERVE_ULP = 2.0 ** -7


def ranks_serve_config(arch, groups, dtype=torch.bfloat16):
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    cfg = get_config(arch, reduced=False, dtype=dtype)
    return with_fed2(cfg, groups=groups) if groups else cfg


def ranks_prefill_batch(vocab):
    b, s = RANKS_PREFILL
    rng = np.random.default_rng(RANKS_SERVE["seed"])
    toks = rng.integers(0, vocab, size=(b, s + 1))
    return {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32),
            "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32),
            "mask": torch.ones((b, s))}


def ranks_serve_rank(mesh, models):
    """Each model of ``models`` on this rank: the full tree drawn from
    the serving seed on the card (as one process draws it), then
    run_serve(mesh=) at the CLI's defaults (counted: collectives and
    both kernels' launches), the check's prompt alone (its logits and
    cache share back on the host) and one prefill-loss step of
    RANKS_PREFILL (counted); each kernel's launches of each shape over
    those three runs (``shapes``)."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.ssd_update import ssd_update
    from repro_torch.launch import serve, sharding, steps
    from repro_torch.models import transformer as tfm
    from repro_torch.models.module import tree_map
    out = {}
    for arch, groups in models:
        cfg = ranks_serve_config(arch, groups)
        full = tfm.init_params(torch.Generator(device="cuda").manual_seed(
            RANKS_SERVE["seed"]), cfg)
        tallies = (grouped_matmul.shape_launches.copy(),
                   ssd_update.shape_launches.copy())

        def counted_run(fn):
            gm, su = grouped_matmul.launches, ssd_update.launches
            mesh.counts.reset()
            torch.cuda.synchronize()
            t0 = time.time()
            res = fn()
            torch.cuda.synchronize()
            return res, {"s": time.time() - t0,
                         "collectives": mesh.counts.as_dict(),
                         "grouped_matmul": grouped_matmul.launches - gm,
                         "ssd_update": ssd_update.launches - su}

        torch.cuda.reset_peak_memory_stats()
        path, path_c = counted_run(lambda: serve.run_serve(
            cfg, device="cuda", init_params=full, mesh=mesh, **RANKS_SERVE))
        assert torch.isfinite(path["logits"].float()).all(), (arch, groups)
        prompt = serve.run_serve(cfg, device="cuda", init_params=full,
                                 mesh=mesh, **ranks_serve_check())
        specs = sharding.param_shardings(full, cfg, mesh)
        shares = sharding.cut(full, specs, mesh)
        per_device = sharding.per_device_bytes(full, specs, mesh)
        del full
        batch = ranks_prefill_batch(cfg.vocab)
        lo, hi = sharding.batch_rows(mesh, RANKS_PREFILL[0])
        step = steps.make_prefill_loss_step(cfg, mesh=mesh)
        loss, pre_c = counted_run(lambda: step(shares, {
            k: v[lo:hi].cuda() for k, v in batch.items()}))
        held = sharding.tree_bytes(shares)
        shapes = {(name, *key): n
                  for name, now, before in (
                      ("grouped_matmul", grouped_matmul.shape_launches,
                       tallies[0]),
                      ("ssd_update", ssd_update.shape_launches, tallies[1]))
                  for key, n in (now - before).items()}
        del shares
        free_device_memory()
        out[arch, groups] = {
            "tokens": path["tokens"], "rows": path["rows"],
            "decode_s": path["decode_s"], "prefill_s": path["prefill_s"],
            "path": path_c, "prefill": pre_c, "loss": float(loss),
            "logits": prompt["logits"].cpu(),
            "cache": tree_map(lambda t: t.cpu(), prompt["cache"]),
            "held": held, "per_device": per_device, "shapes": shapes,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del path, prompt
        free_device_memory()
    return out


def ranks_fp32_rank(mesh, models):
    """``ranks_serve_fp32`` of each model of ``models`` on this rank."""
    return {label: ranks_serve_fp32(mesh, *label) for label in models}


def ranks_fp32_tree(arch, groups):
    """The serving seed's bf16 tree on the card, its bf16 leaves upcast
    to fp32 (the fp32 runs' weights, on ranks and in one process)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.module import tree_map
    full = tfm.init_params(torch.Generator(device="cuda").manual_seed(
        RANKS_SERVE["seed"]), ranks_serve_config(arch, groups))
    return tree_map(lambda t: t.float() if t.dtype == torch.bfloat16
                    else t, full)


def ranks_serve_fp32(mesh, arch, groups):
    """The check's prompt on this rank in fp32, TF32 off (both kernels
    on fp32 inputs): its logits and cache share on the host, and the
    kernels' launches (not part of the path's counts)."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.ssd_update import ssd_update
    from repro_torch.launch import serve
    from repro_torch.models.module import tree_map
    gm, su = grouped_matmul.launches, ssd_update.launches
    with tf32_off():
        prompt = serve.run_serve(
            ranks_serve_config(arch, groups, torch.float32), device="cuda",
            init_params=ranks_fp32_tree(arch, groups), mesh=mesh,
            **ranks_serve_check())
    res = {"logits": prompt["logits"].cpu(), "rows": prompt["rows"],
           "cache": tree_map(lambda t: t.cpu(), prompt["cache"]),
           "grouped_matmul": grouped_matmul.launches - gm,
           "ssd_update": ssd_update.launches - su}
    del prompt
    free_device_memory()
    return res


def ranks_serve_check() -> dict:
    return {**RANKS_SERVE, "prompt_len": RANKS_SERVE_CHECK, "gen": 0}


def ranks_serve_one(arch, groups):
    """One process on the card: the check's prompt alone and the
    prefill loss in bf16, and the same in fp32 (the bf16 weights upcast,
    TF32 off): the logits, cache and loss of each."""
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer as tfm
    from repro_torch.models.module import tree_map
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = ranks_serve_config(arch, groups, dtype)
        full = tfm.init_params(torch.Generator(device="cuda").manual_seed(
            RANKS_SERVE["seed"]), cfg) if dtype == torch.bfloat16 \
            else ranks_fp32_tree(arch, groups)
        with tf32_off():
            prompt = serve.run_serve(cfg, device="cuda", init_params=full,
                                     **ranks_serve_check())
            batch = ranks_prefill_batch(cfg.vocab)
            loss = steps.make_prefill_loss_step(cfg)(
                full, {k: v.cuda() for k, v in batch.items()})
        out[dtype] = {"logits": prompt["logits"].cpu(),
                      "cache": tree_map(lambda t: t.cpu(), prompt["cache"]),
                      "loss": float(loss)}
        del full, prompt
        free_device_memory()
    return out


def ranks_serve_prediction(cfg, shape, mesh_shape, mode) -> dict:
    """The dry mesh's prediction of one step on rank 0 of a
    ``mesh_shape`` mesh (launch/dryrun.rank_program on meta), each
    exchange staged through the host as gloo stages a CUDA tensor:
    ``Counts.as_dict()``'s keys."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.collectives import staged_bytes
    from repro_torch.launch.mesh import AXES, Mesh
    rmesh, _ = dryrun.rank_program(cfg, InputShape(mode, shape[1], shape[0],
                                                   mode),
                                   Mesh(AXES, mesh_shape))
    c = rmesh.counts.as_dict()
    c["staged"] = {k: staged_bytes(c["bytes"][k], c["result"][k])
                   for k in c["bytes"]}
    return c


def per_step(c: dict, n: int) -> dict:
    assert all(v % n == 0 for d in c.values() for v in d.values()), (c, n)
    return {k: {kind: v // n for kind, v in d.items()} for k, d in c.items()}


def within_bf16(label, got, one_bf16, one_fp32) -> tuple:
    """``got`` against the one-process bf16 value within RANKS_SERVE_ULP's
    rule (max(2^-7, 2 r) of its largest magnitude): (the distance, the
    tolerance, r), each over that magnitude; raises outside."""
    got, want, ref = (torch.as_tensor(t).double() for t in
                      (got, one_bf16, one_fp32))
    scale = max(want.abs().max().item(), 1e-30)
    r = (want - ref).abs().max().item() / scale
    d = (got - want).abs().max().item() / scale
    tol = max(RANKS_SERVE_ULP, 2 * r)
    assert d <= tol, f"{label}: ranks {d:.3g} of the scale from one " \
        f"process, tolerance {tol:.3g} (bf16 vs fp32 {r:.3g})"
    return d, tol, r


def held_line(t) -> str:
    return f"{t[0]:.2e} (tol {t[1]:.2e}; bf16 vs fp32 {t[2]:.2e})"


def within_fp32(label, got, want) -> float:
    """``got`` against ``want`` within RANKS_SERVE_FP32_TOL of ``want``'s
    largest magnitude: the distance over that magnitude; raises
    outside."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    scale = max(want.abs().max().item(), 1e-30)
    d = (got - want).abs().max().item() / scale
    assert d <= RANKS_SERVE_FP32_TOL, f"{label}: fp32 ranks {d:.3g} of " \
        f"the scale from one process (tolerance {RANKS_SERVE_FP32_TOL:g})"
    return d


def joined_cache(per_rank, mesh_shape, cfg):
    """The caches of ``per_rank`` (each rank's share) joined whole."""
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_dry_rank_mesh
    from repro_torch.models.forward import init_cache
    meshes = [make_dry_rank_mesh(mesh_shape, r, device="cpu")
              for r in range(len(per_rank))]
    like = init_cache(cfg, RANKS_SERVE["batch"], RANKS_SERVE["max_len"],
                      device="meta")
    return sharding.join(per_rank, meshes, sharding.cache_shardings(
        like, RANKS_SERVE["batch"], meshes[0]), like)


def ranks_fp32_hold(label, mesh_shape, per_rank, one_fp32) -> None:
    """The ranks' fp32 run of the check's prompt (``ranks_serve_fp32``)
    against one process's fp32 run (``within_fp32``): logits and every
    cache leaf."""
    from repro_torch.models.module import tree_leaves, tree_paths
    logit = max(within_fp32(f"{label} fp32 logits rows {r['rows']}",
                            r["logits"],
                            one_fp32["logits"][r["rows"][0]:r["rows"][1]])
                for r in per_rank)
    joined = joined_cache([r["cache"] for r in per_rank], mesh_shape,
                          ranks_serve_config(*label, torch.float32))
    worst = 0.0
    for path, got, want in zip(tree_paths(joined), tree_leaves(joined),
                               tree_leaves(one_fp32["cache"]), strict=True):
        if want.dtype == torch.int32:
            assert torch.equal(got, want), (label, "fp32", path)
            continue
        worst = max(worst, within_fp32(f"{label} fp32 cache {path}", got,
                                       want))
    launches = {(r["grouped_matmul"], r["ssd_update"]) for r in per_rank}
    print(f"  {label[0]}{' fed2 ' + str(label[1]) if label[1] else ''} on "
          f"{mesh_shape} in fp32, the check's prompt, against one process "
          f"in fp32 (tol {RANKS_SERVE_FP32_TOL:g} of the scale): logits "
          f"{logit:.2e}, worst cache leaf {worst:.2e}; launches a rank "
          f"(grouped_matmul, ssd_update) {sorted(launches)}", flush=True)


def ranks_serve_predictions(jobs) -> dict:
    """``ranks_serve_prediction`` of a decode and a prefill step for
    each (mesh shape, model) of ``jobs``."""
    out = {}
    for mesh_shape, label in jobs:
        cfg = ranks_serve_config(*label)
        out[mesh_shape, label] = (
            ranks_serve_prediction(cfg, (RANKS_SERVE["batch"],
                                         RANKS_SERVE["max_len"]),
                                   mesh_shape, "decode"),
            ranks_serve_prediction(cfg, RANKS_PREFILL, mesh_shape,
                                   "prefill"))
    return out


def ranks_serve_hold(label, mesh_shape, per_rank, one, cfg, preds):
    """The ranks' gathered logits, joined cache and prefill loss against
    one process (``within_bf16``); their launches and collectives a step
    against RANKS_SERVE_LAUNCHES and the dry mesh's prediction
    ``preds`` (decode, prefill). Returns the kernels' launches of each
    shape on a rank (every rank's the same)."""
    from repro_torch.models.module import tree_leaves, tree_paths
    bf, fp = one[torch.bfloat16], one[torch.float32]
    steps_n = RANKS_SERVE["prompt_len"] + RANKS_SERVE["gen"]
    logit = max(within_bf16(f"{label} logits rows {r['rows']}",
                            r["logits"].float(),
                            bf["logits"][r["rows"][0]:r["rows"][1]].float(),
                            fp["logits"][r["rows"][0]:r["rows"][1]])
                for r in per_rank)
    joined = joined_cache([r["cache"] for r in per_rank], mesh_shape, cfg)
    worst = (0.0, 0.0, 0.0)
    for path, got, want, ref in zip(tree_paths(joined), tree_leaves(joined),
                                    tree_leaves(bf["cache"]),
                                    tree_leaves(fp["cache"]), strict=True):
        if want.dtype == torch.int32:
            assert torch.equal(got, want), (label, path)
            continue
        worst = max(worst, within_bf16(f"{label} cache {path}", got.float(),
                                       want.float(), ref))
    loss = within_bf16(f"{label} prefill loss",
                       torch.tensor([r["loss"] for r in per_rank]),
                       torch.full((len(per_rank),), bf["loss"]),
                       torch.full((len(per_rank),), fp["loss"]))
    gm_step, su_step = RANKS_SERVE_LAUNCHES[label]
    chunks = -(-RANKS_PREFILL[1] // cfg.loss_chunk)
    decode_pred, prefill_pred = preds
    for rank, r in enumerate(per_rank):
        assert r["held"] == r["per_device"], (label, rank, r["held"],
                                              r["per_device"])
        assert r["shapes"] == per_rank[0]["shapes"], \
            f"{label}: rank {rank} launched {r['shapes']}, rank 0 " \
            f"{per_rank[0]['shapes']}"
        got = (r["path"]["grouped_matmul"], r["path"]["ssd_update"],
               r["prefill"]["grouped_matmul"], r["prefill"]["ssd_update"])
        want = (gm_step * steps_n, su_step * steps_n,
                chunks if cfg.fed2_groups else 0, 0)
        assert got == want, f"{label} rank {rank}: launches {got}, " \
            f"expected {want}"
        assert per_step(r["path"]["collectives"], steps_n) == decode_pred, \
            (label, rank, per_step(r["path"]["collectives"], steps_n),
             decode_pred)
        assert r["prefill"]["collectives"] == prefill_pred, \
            (label, rank, r["prefill"]["collectives"], prefill_pred)
    c = decode_pred
    kinds = ", ".join(f"{k} {c['calls'][k]} x {c['result'][k]:,} B"
                      for k in c["calls"] if c["calls"][k])
    pk = ", ".join(f"{k} {prefill_pred['calls'][k]} x "
                   f"{prefill_pred['result'][k]:,} B"
                   for k in prefill_pred["calls"] if prefill_pred["calls"][k])
    slow = max(per_rank, key=lambda r: r["decode_s"])
    print(f"  {label[0]}{' fed2 ' + str(label[1]) if label[1] else ''}"
          f" on {mesh_shape}: launches a decode step on every rank "
          f"grouped_matmul {gm_step}, ssd_update {su_step}; a prefill step "
          f"grouped_matmul {want[2]}; collectives a decode step (= the dry "
          f"mesh's, staged included) {kinds}; a prefill step (= the dry "
          f"mesh's) {pk}; logits {held_line(logit)}; worst cache leaf "
          f"{held_line(worst)}; prefill loss {per_rank[0]['loss']:.6f} vs "
          f"{bf['loss']:.6f} {held_line(loss)}; with the wave's "
          f"other meshes on the card (not a step's cost), slowest rank "
          f"prefill {slow['prefill_s']:.3f} s, decode "
          f"{slow['decode_s']:.3f} s ({RANKS_SERVE['gen']} x "
          f"{RANKS_SERVE['batch']} tokens), prefill-loss step "
          f"{max(r['prefill']['s'] for r in per_rank):.3f} s; held "
          f"{per_rank[0]['held']:,} B of parameters a rank (= per_device_bytes); peak "
          f"{max(r['peak_gb'] for r in per_rank):.2f} GB a rank",
          flush=True)
    return per_rank[0]["shapes"]


# the new shard shapes of the two kernels on this phase's path and on the
# 16x16 dry-run's: (label, lead rows M, G, K, N) for grouped_matmul;
# (label, B, H, P, N) for ssd_update, its x a rank's heads in a row of
# Mamba-2's 64 (the last rank's); bf16. Their launches are measured on
# the phase's ranks (0: the dry-run's shapes, not on the card's path),
# and every shape the ranks launch must be here
RANK_GMM_SHAPES = (
    ("llama unembedding (1, 2) decode", 4, 8, 256, 8016),
    ("llama unembedding (2, 2) decode", 2, 8, 256, 8016),
    ("llama unembedding (1, 2) prefill chunk", 1024, 8, 256, 8016),
    ("llama unembedding (2, 2) prefill chunk", 512, 8, 256, 8016),
    ("llama unembedding 16x16 decode_32k", 8, 8, 256, 1002),
    ("llama FFN gate/up (1, 2) decode", 4, 8, 256, 512),
    ("llama FFN down (1, 2) decode", 4, 8, 512, 256),
    ("llama FFN gate/up (2, 2) decode", 2, 8, 256, 512),
    ("llama FFN down (2, 2) decode", 2, 8, 512, 256),
    ("mamba2 unembedding (1, 2) decode", 4, 8, 256, 3144),
    ("mamba2 unembedding (1, 2) prefill chunk", 1024, 8, 256, 3144),
    ("mamba2 unembedding 16x16 decode_32k", 8, 8, 256, 393))
RANK_SSD_SHAPES = (("(1, 2) decode", 4, 32, 64, 128),
                   ("16x16 decode_32k", 8, 4, 64, 128))
SSD_ROW_HEADS = 64


def ranks_serve_kernels(measured) -> list:
    """Each new shard shape against the kernel's plain version on the
    card (grouped_matmul within 0.3 in bf16, the check phase's limit;
    ssd_update within the check phase's bound), timed beside its bound
    and torch.bmm (ssd_update: no library call): records of the kernels
    line. ``measured``: each (kernel, *shape, dtype)'s launches on a
    rank, summed over the phase's spawns (``phase_ranks_serve``)."""
    bf16_name = str(torch.bfloat16)
    listed = {("grouped_matmul", m, g, k, n, bf16_name)
              for _, m, g, k, n in RANK_GMM_SHAPES} | \
        {("ssd_update", b, h, p, n, bf16_name)
         for _, b, h, p, n in RANK_SSD_SHAPES}
    unlisted = set(measured) - listed
    assert not unlisted, f"shapes launched on the ranks and not checked " \
        f"here: {sorted(unlisted)}"
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import ssd_update as su
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_ref)
    from repro_torch.kernels.ssd_update import ssd_update, ssd_update_ref
    gen = torch.Generator(device="cuda").manual_seed(37)
    bf16 = torch.bfloat16
    records = []
    for label, m, g, k, n in RANK_GMM_SHAPES:
        launches = measured.get(("grouped_matmul", m, g, k, n, bf16_name),
                                0)
        x, w, _ = gmm_inputs((m,), g, k, n, bf16, gen)
        err = check(f"grouped_matmul rank shard {label}", grouped_matmul(x, w),
                    grouped_matmul_ref(x, w), 0.3)
        w_bytes = g * k * n * 2
        nbytes = w_bytes + 2 * m * g * (k + n)
        sets = [gmm_inputs((m,), g, k, n, bf16, gen)[:2]
                for _ in range(copies_for(w_bytes))]
        reps = max(200 if m <= 128 else 20, len(sets))
        t = {"ms": time_ms([lambda a=a: grouped_matmul(*a) for a in sets],
                           reps),
             "plain_ms": time_ms([lambda a=a: grouped_matmul_ref(*a)
                                  for a in sets], reps),
             "library_ms": time_ms([lambda a=a, m=m, g=g, k=k: torch.bmm(
                 a[0].view(m, g, k).transpose(0, 1), a[1])
                 for a in sets], reps)}
        t["bound_ms"], t["bound_by"] = bound(nbytes, 2 * m * g * k * n,
                                             BF16_FLOPS)
        r = gm.route(m, g, k, n, bf16, 0, 0)
        print(f"  grouped_matmul rank shard {label} M={m} ({g}, {k}, {n}) "
              f"bf16 [{r}]: {t['ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.2f} us, torch.bmm "
              f"{t['library_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}, "
              f"{100 * t['bound_ms'] / t['ms']:.1f} % of it); launches on "
              f"a rank {launches} (measured, summed over the spawns)",
              flush=True)
        records.append({"name": f"grouped_matmul rank shard {label} M={m} "
                                f"({g}, {k}, {n}) [{r}]",
                        "route": "cuda",
                        "source": "src/repro_torch/csrc/grouped_matmul.cu",
                        "replaces": "src/repro/kernels/grouped_matmul.py:48",
                        "launches": launches, "max_abs_err": err, **t})
        del sets
    for label, b, h, p, n in RANK_SSD_SHAPES:
        launches = measured.get(("ssd_update", b, h, p, n, bf16_name), 0)
        row = {"row_heads": SSD_ROW_HEADS, "head0": SSD_ROW_HEADS - h}
        args = ssd_inputs(b, h, p, n, bf16, gen, **row)
        want_h, want_y = ssd_update_ref(*args)
        got_h, got_y = ssd_update(*args)
        scale = torch.einsum("bhpn,bn->bhp", want_h.abs(),
                             args[5].float().abs()) + \
            (args[6][None, :, None] * args[1].float()).abs()
        eh = (got_h - want_h).abs().max().item()
        dy = (got_y.float() - want_y.float()).abs()
        ok = eh <= 1e-5 and bool((dy <= 1e-5 * scale + 2.0 ** -7
                                  * want_y.float().abs()).all())
        assert ok, f"ssd_update rank shard {label}: disagrees with its " \
            f"plain version (h' {eh:.3g})"
        nbytes = 8 * b * h * p * n + 2 * (2 * b * h * p + 2 * b * n) \
            + 4 * (b * h + 2 * h)
        sets = [ssd_inputs(b, h, p, n, bf16, gen, **row)
                for _ in range(copies_for(nbytes))]
        reps = max(200, len(sets))
        t = {"ms": time_ms([lambda a=a: ssd_update(*a, out=a[0])
                            for a in sets], reps),
             "plain_ms": time_ms([lambda a=a: ssd_update_ref(*a)
                                  for a in sets], reps),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = bound(nbytes, 6 * b * h * p * n)
        print(f"  ssd_update rank shard {label} ({b}, {h}, {p}, {n}) x "
              f"bf16 (heads {SSD_ROW_HEADS - h}.. of a {SSD_ROW_HEADS}-head "
              f"row): max_abs_err h' {eh:.3g}, y {dy.max().item():.3g}; "
              f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
              f"library none, bound {t['bound_ms'] * 1e3:.2f} us "
              f"({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.0f} % of "
              f"it); launches on a rank {launches} (measured, summed over "
              f"the spawns)", flush=True)
        records.append({"name": f"ssd_update rank shard {label} "
                                f"({b}, {h}, {p}, {n})",
                        "route": "cuda",
                        "source": "src/repro_torch/csrc/ssd_update.cu",
                        "replaces": "src/repro/kernels/ssd_update.py:50",
                        "launches": launches,
                        "max_abs_err": max(eh, dy.max().item()), **t})
        del sets
    return records


def spawned_at_once(wave, beside=None) -> dict:
    """Each (mesh shape, model, body) of ``wave`` on its own spawn of
    gloo ranks on cuda:0 (body "serve": ``ranks_serve_rank``, "fp32":
    ``ranks_fp32_rank``), all at once (a thread each), while this thread
    runs ``beside()`` (if given): {(mesh shape, model, body): per-rank
    results}, and ``beside``'s result under None. Raises the first
    failure once every thread has ended."""
    from repro_torch.launch.mesh import spawn
    out, errors = {}, []
    bodies = {"serve": ranks_serve_rank, "fp32": ranks_fp32_rank}

    def one(shape, model, body):
        try:
            out[shape, model, body] = [
                r[model] for r in spawn(bodies[body], shape, backend="gloo",
                                        device="cuda", args=((model,),),
                                        timeout=600)]
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=job) for job in wave]
    for t in threads:
        t.start()
    try:
        if beside is not None:
            out[None] = beside()
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return out


def phase_ranks_serve() -> list:
    """The sharded serving of RANKS_SERVE_MODELS in RANKS_SERVE_WAVES
    (gloo ranks sharing cuda:0) against one process, in bf16 and (for
    RANKS_SERVE_FP32) fp32; then the new shard shapes' kernel checks.
    Returns their records for the kernels line."""
    smi = nvidia_smi()
    t0 = time.time()
    free_device_memory()
    serves = [(sh, m) for wave in RANKS_SERVE_WAVES
              for sh, m, body in wave if body == "serve"]
    runs = {}
    for n, wave in enumerate(RANKS_SERVE_WAVES):
        t1 = time.time()
        beside = (lambda: {label: ranks_serve_one(*label)
                           for label in RANKS_SERVE_MODELS}) if n == 0 \
            else (lambda: ranks_serve_predictions(serves))
        runs.update(spawned_at_once(wave, beside))
        runs["one" if n == 0 else "preds"] = runs.pop(None)
        jobs = ", ".join(f"{m[0]} fed2 {m[1]} on {sh} ({body})"
                         for sh, m, body in wave)
        what = "the one-process runs" if n == 0 else \
            "the dry mesh's predictions"
        print(f"  {len(wave)} spawns at once ({jobs}; gloo, all on "
              f"cuda:0), {what} beside: {time.time() - t1:.1f} s with "
              f"start-up", flush=True)
        free_device_memory()
    one, preds, measured = runs.pop("one"), runs.pop("preds"), \
        collections.Counter()
    for (mesh_shape, label, body), per_rank in runs.items():
        if body == "fp32":
            ranks_fp32_hold(label, mesh_shape, per_rank,
                            one[label][torch.float32])
        else:
            measured.update(ranks_serve_hold(
                label, mesh_shape, per_rank, one[label],
                ranks_serve_config(*label), preds[mesh_shape, label]))
    del one, runs
    records = ranks_serve_kernels(measured)
    print(f"  ranks serve phase {time.time() - t0:.1f} s (budget "
          f"{RANKS_SERVE_BUDGET_S} s; {smi})", flush=True)
    return records


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
    free_device_memory()
    with phase("store (TF32 off, deterministic convs)"), tf32_off(), \
            deterministic_convs():
        phase_store()
    free_device_memory()
    with phase("serve"):
        serve_counts = phase_serve()
    counts["grouped_matmul"] = serve_counts["grouped_matmul"]
    counts["ssd_update"] = serve_counts["ssd_update"]
    free_device_memory()
    with phase("decode parity (TF32 off)"), tf32_off():
        phase_decode_parity()
    free_device_memory()
    with phase("lm train"):
        phase_lm_train()
    with phase("lm federation"):
        phase_lm_fl()
    free_device_memory()
    with phase("lm federation, mixed dtypes"):
        phase_lm_fl_mixed()
    free_device_memory()
    with phase("lm federation, mixed dtypes, axes"):
        phase_lm_fl_mixed_axes()
    with phase("lm cross-check (TF32 off)"), tf32_off():
        phase_lm_crosscheck()
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
    free_device_memory()
    with phase("other dense and hybrid serve"):
        phase_other_serve()
    free_device_memory()
    with phase("other dense and hybrid decode parity (TF32 off)"), \
            tf32_off():
        phase_other_decode_parity()
    with phase("other dense and hybrid lm train"):
        phase_other_lm_train()
    with phase("other dense and hybrid lm federation"):
        phase_other_lm_fl()
    free_device_memory()
    with phase("moe serve"):
        phase_moe_serve()
    with phase("moe decode parity (TF32 off)"), tf32_off():
        phase_moe_decode_parity()
    with phase("moe lm train"):
        phase_moe_lm_train()
    with phase("moe lm federation"):
        phase_moe_lm_fl()
    free_device_memory()
    with phase("encdec and vlm serve"):
        phase_frontend_serve()
    with phase("encdec and vlm decode parity (TF32 off)"), tf32_off():
        phase_frontend_decode_parity()
    with phase("encdec and vlm lm train"):
        phase_frontend_lm_train()
    free_device_memory()
    with phase("surfaces"):
        phase_surfaces()
    free_device_memory()
    with phase("fl_dryrun"):
        phase_fl_dryrun()
    free_device_memory()
    with phase("ranks"):
        phase_ranks()
    free_device_memory()
    with phase("ranks matrix (TF32 off, deterministic convs)"):
        phase_ranks_matrix()
    free_device_memory()
    with phase("ranks serve (sharded prefill and decode)"):
        shard_records = phase_ranks_serve()
    for r in records:
        r["launches"] = counts[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records + shard_records]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
