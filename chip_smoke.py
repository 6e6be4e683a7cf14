#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit's `nvcc`; imports nothing of JAX or of the JAX package. Each
phase prints one JSON line; any failure raises, so the exit code is
non-zero and the last line is not printed. The phases:

  env       card, power limit, torch/CUDA versions; float32 matmuls must
            run at "highest" precision (the dense P @ z stays full fp32)
  build     builds every kernel of the main path from src/repro_torch/
            kernels/csrc (one nvcc per source, all at once) and prints the
            compiler's report for each kernel instantiation (registers,
            shared memory, stack and spills), its warnings and its
            performance remarks (wgmma serialized, fences injected)
  kernel    K1 (gossip mix) against its plain PyTorch version on the card
            over a grid of shapes, k in {1, 4, 8, 9}, weights, messages
            (none, its own tensor, a view not 16-byte aligned) and dtypes
            (fp32: rtol 1e-5, atol 1e-6; bf16: rtol 2e-2, atol 1e-5), each
            case on the kernel the library must pick (the slab kernel for
            16-byte packets, k <= 8 and n (k + 1) >= slab_min_reads(),
            else the register kernel), as it reports it
            (gossip_mix.FORM_LAUNCHES); then at
            the sweep's call (n=256, M=5 x 4096, k=4, fp32, the five
            lanes' carry as
            one state), on the slab kernel, each lane's columns equal to
            a one-lane call's bit for bit; then at the main path's
            call (n=256, M=4096, k=4, fp32, z seeded from numpy), which
            must launch the slab kernel, the sha256 of its output's bits
            (k1_digest) and its time beside the plain version,
            torch.matmul with the n x n mixing matrix (a yardstick the port
            never calls) and the bound; k1_digest must equal K1_DIGEST
  kernel K2 K2 (compress-mix) the same way over the same grid with mask
            densities 0, 1/8 and 1 (an all-ones mask must give K1's result
            bit for bit), then at the sweep's call (n=256, M=5 x 4096,
            k=4, fp32, a top-k mask at keep 1/4 drawn per node and lane),
            each lane's columns equal to a one-lane call's bit for bit;
            then its time at the main path's shape with a
            top-k mask at keep 1/4, beside the plain version and the
            reference's dense compressed branch P_diag z + P_off (msg*mask)
  manifests the dense backend of the seven manifests that declare one
            (benchmarks/manifests/: expander_periodic, expander_sparse,
            compressed_expander mix through K1 or K2; complete_every,
            fig1_complete, fig1_reduced, fig2_sparse through cuBLAS's
            P @ z) through repro_torch.run on the card and on the CPU; the
            two results must agree under convert.assert_results_match, the
            run's kernel must launch once per communication round (no hand
            kernel for the complete graphs), and the run must take the
            loop its problem declares ("graph", captured; "eager" for
            metric learning, whose eigh reads the card back). For the
            nonsmooth and metric-learning manifests, the card and CPU runs
            side by side count the discrete choices that differ (argmax
            picks, clamped eigenvalue signs: card_cpu_flips)
  main_path the full-size dense cell of benchmarks/bench_dense.py (n=256,
            d=4096, expander k=4, periodic h=2, T=300) through
            repro_torch.run with every launch count set to 0 just before:
            it must run captured as CUDA graphs (loop "graph"), take the
            sparse mix, launch K1's slab kernel exactly once per
            communication round (149, counted from the graphs' replays
            through repro_torch.kernels.counters), and agree with its
            mix="dense" twin; torch.profiler watches that run, and the K1
            kernels it names must be those 149 slab kernels, the
            capture's warm-up's 2 and its first replay's 1; the sha256 of
            its fvals and disagreement as float32 must equal
            MAIN_PATH_DIGEST, and so
            must an unprofiled captured run's and the eager
            loop="segment" run's; prints the wall per iteration of the
            unprofiled captured run, of the eager run (eager_ratio) and of
            its twin (twin_ratio: the host's noise falls on both alike)
  main_path_compressed
            the same cell under top-k and rand-k (keep 1/4, the compression
            axis of benchmarks/bench_compress.py) and deterministic int8,
            each with every launch count set to 0 just before, captured: the
            sparse mix must launch K2 (top-k, rand-k) or K1's slab kernel
            (int8) exactly 149 times and the other kernel never, the residual
            norms must be
            finite and nonzero, and the run must agree with its
            mix="dense" twin within the tolerance stated for its
            compressor (TWIN_TOL), the flipped message entries between the
            two runs counted in lockstep; one rand-k mask at this shape
            must be bitwise equal on the card and on the CPU
  sweep     the full-size cell swept over h in (1, 2, 4, 8, 16), the axis
            of the paper's Fig. 2, uncompressed (K1) and under top-k at
            keep 1/4 (K2): repro_torch.run_sweep(parallel="vmap") as one
            captured program of five lanes, with every launch count set to
            0 just before (one launch for each iteration at which any lane
            communicates: 299), then the five runs serially; each lane must
            equal its serial run, host fields exactly and device floats
            within SWEEP_RTOL (the bitwise equal entries are counted);
            prints the batched wall beside the serial walls' sum; then two
            cells with parallel="process" on the card, equal to serial bit
            for bit
  adaptive  the full-size cell under the paper's adaptive schedule
            (h0 = 1) and the "dense_adaptive" controller, uncompressed (K1)
            and under top-k at keep 1/4 (K2). First under an injected clock
            that charges each chunk eq. 9's cost at ADAPTIVE_R_TRUE (the
            closed loop's seam DDASimulator.run_chunk), on the card and
            on the CPU: the retunes, h_final and r_hat must be equal
            exactly (h must rise), the traces within FP32_TOL (top-k:
            TWIN_TOL), and the card's kernel must launch once a round.
            Then under the real clock on the card through repro_torch.run,
            every launch count set to 0 just before: captured (loop
            "graph"), K1 on its slab kernel (or K2) launched once for each
            round the loop chose; the controller's one plain sample (its
            first timed chunk, one idle iteration; the median of
            PLAIN_SAMPLE_RUNS runs) within PLAIN_SAMPLE_CAP of
            one-iteration idle chunks on a loaded program, and r_hat
            above 0 under top-k; prints r_hat, the plain samples, the
            captured run of the cell at h = 1 (periodic, no controller),
            the retunes, compile_s, the median iteration wall and the wall per
            iteration (a chunk is a run of iterations of one kind in a
            segment and ends in a device synchronize: at h = 1 one plain
            and one comm chunk in the first segment, one comm chunk in
            each other, and a statistics readback at each segment's end)
  netsim    every netsim backend of the six manifests that declare one
            through repro_torch.run (event loops in host numpy; the
            problem built on the card): finite traces, messages sent,
            drops where the scenario loses messages, retunes under the
            adaptive controller (adaptive_adversarial), a faults block
            under the churn plan (churn_adversarial), and the object and
            vectorized engines' traces equal bit for bit; prints each
            run's host wall and its trace's sha256 (not asserted: the CPU
            tests hold the bits against the reference). Then a straggler
            spec at slow_factor 5.35, whose scale is not the factor
            (5.3500000000000005), on both engines: each trace equal to the
            port's CPU run of the spec; prints sim_time[-1] and the
            trace's sha256. Then expander_periodic's cell on the
            vectorized engine with its
            gradients through netsim.torch_batch_grad on the card, beside
            the numpy gradients' run: the largest fvals difference
            (float32 against float64; relative 1e-4 at most)
  serve     the full-size cell served through repro_torch.serve, each
            served result held to a solo repro_torch.run of its spec
            exactly (comparable_result_dict), each request with every
            launch count set to 0 just before and read just after. In
            process (ExperimentServer, two threads): cold, then warm (a
            cache hit that captures nothing, compile_s under 1 ms); a
            packed lane of three requests (h 2, 4, 8; r 0.01, 0.02,
            0.04; seeds 0, 1, 2) at lane_width 3, K1 launched once for
            each iteration at which any lane communicates; the cell under
            top-k at keep 1/4 (K2); a netsim manifest run solo with its
            reason; a new signature captured beside a replay of the warm
            cell; one request over TCP through Client, its trace the solo
            run's. The in-process runs' launches must be their rounds
            (serve_launches). Then two worker processes, a ChaosPlan
            killing the first job's worker mid-run: every result exact,
            the job re-enqueued, no request executed twice. Prints cold
            and warm walls with compile_s, the packed wall beside the
            solo walls' sum, and the pool's first-job and warm-job walls
  lm        the launch backend (consensus LM training). First K1 at the
            LM launcher's call: the embed leaf of two full-width pods
            (bf16, n=2, k=1, M = 128256 x 4096) against its plain version
            bit for bit, timed beside it and torch.matmul with the 2 x 2
            mixing matrix, its bound from bytes read once and written
            once. Then `_sdpa_causal` at the cell's attention shapes (bf16,
            S = 4096: the streamed form) against the whole score-matrix
            form, output and gradients within ATTN_STREAM_RTOL. Then
            llama3-8b at full width (d_model 4096, 32 heads, 8 kv, d_ff
            14336, vocab 128256, bf16) with its 32 superblocks cut to
            LM_N_SUPER = 4, two pods stacked, S = 4096, T = 6, complete
            graph, periodic h=2, adamw, through repro_torch.run with every
            launch count set to 0 just before and read just after: losses
            finite, the pods bitwise equal after each mix, K1 launched 12
            times a comm step (24), the host fields' closed form,
            param_bytes 3,846,324,224, peak memory under LM_PEAK_CAP_GIB;
            prints K1's bound over a comm step's leaves (from the run's
            param_bytes), the step walls, the second fused step's device time by
            kind under torch.profiler, AdamW's by CUDA events, and
            attention and the loss timed alone at the cell's shapes. Then
            the smoke width at mesh (4, 1, 1), expander k=2, on the card
            and the CPU (host fields exact, losses within LM_TRACE_RTOL,
            the loss decreasing, K1 12 times a round) and the dry-run
            manifest, card against CPU; keeps the full-width run's losses
            and each pod's final parameters' sha256
  lm_ranks  the same full-width llama3-8b spec with its pods on two
            spawned ranks, one pod a rank, through repro_torch.run under a
            default process group of two: on two cards, one rank a card
            over NCCL; on one card both ranks on cuda:0 over a gloo group
            the phase creates (NCCL refuses two ranks on one device; gloo
            takes CUDA tensors in an all-reduce), the backend and the
            reason printed. The fused step's mix is an all-reduce in
            float32 (launch/steps.py `_rank_mix`), so each rank's losses
            and its pod's final parameters' sha256 must equal the stacked
            run's (lm) bit for bit, and the host fields their closed form;
            prints each rank's walls per local and fused step, the fused
            step's collective seconds and float32 bytes, its peak memory,
            and the card's name and power limit; no kernel of the port
            launches on a rank (the mix is the collective, not K1)
  lm_sharded each pod's replica sharded as DTensors: llama3-8b at full
            width (4 of 32 layers), two pods, B = 2 and S = 4096 a pod,
            T = 6, AdamW through train_consensus_lm, first stacked and
            unsharded on the card, then on the layouts (2, 2, 1) (FSDP)
            and (2, 1, 2) (tensor and sequence parallelism) with the pods
            stacked on every rank and K1 mixing each rank's local shards
            (launched 12 times a comm step on each rank): with two or more
            cards one rank a card over NCCL, losses within LM_SHARDED_RTOL
            of the stacked run's; with one card two ranks over gloo if a
            probe finds gloo runs DTensor's all-gather on CUDA tensors,
            else the one-card mesh (2, 1, 1) on one rank through the same
            DTensor path (every placement Replicate), bit for bit the
            stacked run's (losses and final parameters). The pods must be
            equal after every mix; prints "sharded_on_card", the probe's
            finding, each rank's walls per local and fused step, peak
            memory and the collectives' output bytes by kind in one local
            and one fused step, the first step's wall, and K1 timed on the
            embed leaf's data shard. Then the first layout again with gradient
            accumulation (LM_SHARDED_MICROBATCHES = 2, one local step),
            held to the stacked run at the same microbatches the same way,
            its peak beside the one-microbatch run's. `python3
            chip_smoke.py lm_sharded` runs env, build and this phase alone
  lm_sharded_plan
            host-side, on the meta device: one pod's step at the
            production layout (data 16, model 16) as DTensors over a
            placeholder process group of 256 ranks (launch/dryrun.py
            `count_step`), the depth cut to two superblocks (the
            second takes the sequence-parallel residual stream, which
            the first, fed by the embedding, does not), on this
            machine's torch, for one cell of each family whose sharded
            step an older DTensor refused (LM_PLAN_CELLS: llama3-8b,
            musicgen-medium and vision-90b train_4k, musicgen-medium and
            llama4-maverick decode_32k, deepseek-v2 prefill_32k, zamba2
            train_4k). Each cell must build, and count no op on DTensors
            that torch 2.11 refuses (`dryrun.refused_sharding`: a view
            merging sharded dims, a `_StridedShard`, a pad of a DTensor);
            prints the torch version, each cell's seconds, that count and
            rank 0's collective bytes by kind. It shows that the sharding
            plan builds on this torch, not that the step runs on cards.
            The default run starts it in a child process that sees no
            card right after the build, beside the card's phases, and
            reads it at the end;
            `python3 chip_smoke.py lm_sharded_plan` runs env and this
            phase alone (no build)
  lm_init_sharded
            the shard-wise init at a model no card holds whole:
            qwen1.5-110b at its published widths and depth (a 222.4 GB
            pod) drawn for the ranks (0, 0) and (15, 15) of the
            production layout (data 16, model 16) by their coordinates
            alone (launch/train.py `draw_shards`, no process group); each
            rank's draw timed, its peak below twice its shard bytes plus
            one chunk's workspace (measured first), every leaf of layers
            0 and 79 of its shards equal to that layer drawn whole and cut
            to the rank's block, bit for bit. `python3 chip_smoke.py
            lm_init_sharded` runs env, build and this phase alone (any of
            the phases that run alone may be named together)
  lm_k1_expert_leaf
            K1 at deepseek-v2's routed-expert leaf of two full-width pods
            (bf16, n=2, k=1, M = 160 x 5120 x 1536 = 1,258,291,200) on
            the empty card, against its plain version bit for bit, on the
            register kernel alone; timed beside the plain version (eager:
            its float32 temporaries are about 50 GB a call) and
            torch.matmul with the 2 x 2 mixing matrix, its bound 3.005 ms
            from bytes read once and written once
  lm_moe_full
            deepseek-v2 at its published widths (d_model 5120, vocab
            102400, 128 heads of 128, MLA kv_lora 512, q_lora 1536, rope
            64, v 128; a dense prologue FFN of 12288; 160 routed experts
            at top-6 with 2 shared, expert d_ff 1536, capacity factor
            1.25; bf16) cut to its prologue layer and LM_MOE_N_SUPER = 1
            of its 59 MLA + MoE superblocks, two pods stacked, S = 4096,
            T = 6, complete graph, periodic h=2, SGD without momentum
            (AdamW's moments do not fit), through
            launch.train.train_consensus_lm with every launch count set
            to 0 just before and read just after: losses finite, the pods
            bitwise equal after each mix, K1 launched once a leaf (33) a
            comm step (66), all on its register kernel, param_bytes
            10,719,055,872, peak memory under LM_PEAK_CAP_GIB; prints the
            step walls, the peak, K1's time a comm step against its bound
            (12.80 ms, from the run's param_bytes), each MoE call's
            dropped assignments (in the overflow slot) out of 4096 x 6,
            and the second fused step's device time by kind (K1, SGD,
            matmuls, the MoE gathers, attention, the rest)
  lm_moe_smoke
            deepseek-v2 and llama4-maverick at smoke width through
            repro_torch.run at mesh (4, 1, 1), expander k=2, adamw, on
            the card and the CPU: host fields exact, losses within
            LM_MOE_TRACE_RTOL, K1 once a leaf a comm round; prints the
            router's top-K choices that differ between card and CPU
  lm_sharded_moe
            the MoE and MLA family and the VLM's cross-attention as
            DTensors: lm_moe_full's deepseek-v2 cell (2 of 60 layers, two
            pods, B = 1, S = 4096, T = 6, SGD) stacked on the card, then
            through the DTensor path, both under torch's deterministic
            algorithms (the MoE gathers' backward then adds in a fixed
            order): with one card the one-rank mesh (2, 1, 1), bit for
            bit the stacked run (losses and both pods' bit checksums), K1
            launched 66 times on local shards; with two or more cards
            (2, 2, 1) and (2, 1, 2) over NCCL, each within
            LM_MOE_TRACE_RTOL of a stacked run at its dispatch groups,
            the first step's router choices that differ counted. Then
            lm_vlm's vision-90b cell (4 of 20 superblocks, 6400 encoder
            tokens), one pod's loss_fn at B = 1, S = 2048 forward and
            backward, plain and as DTensors on the one-rank mesh: the
            loss and every gradient's bit checksum equal. Prints each
            run's first step (DTensor's planning), local and fused step
            walls, peak memory, the collectives' bytes by kind and K1's
            launches. `python3 chip_smoke.py lm_sharded_moe` runs env,
            build and this phase alone
  lm_ssm_full
            falcon-mamba-7b at its published widths (d_model 4096,
            d_inner 8192, dt_rank 256, N 16, conv 4, vocab 65024, bf16),
            its 64 Mamba-1 layers cut to LM_SSM_N_SUPER = 4 (the mixer's
            per-token loop sets the wall), two pods stacked, B = 1 and
            S = 4096 a pod, T = 6, complete graph, periodic h=2, adamw,
            through repro_torch.run with every launch count set to 0 just
            before and read just after: losses finite, the pods bitwise
            equal after each mix, K1 launched once a leaf (13) a comm step
            (26), the host fields' closed form, param_bytes 1,909,080,064,
            peak memory under LM_PEAK_CAP_GIB; prints the step walls, the
            peak, AdamW's time a step (CUDA events), the second fused
            step's kernels by name (K1 against its bound, 2.280 ms from
            the run's param_bytes; matmuls; AdamW by its events; the
            rest; the busy share of its window) under torch.profiler with
            device activity alone (a host-op profile of the token loop's
            launches takes minutes to parse), the scans' share from one
            mixer's chunked scan profiled alone at the cell's shapes,
            counted for each mixer and pod
  lm_hybrid_full
            zamba2-2.7b the same way at its published widths and full
            depth (54 blocks: 9 superblocks of five Mamba-2 blocks and the
            weight-shared attention block; d_model 2560, 80 SSD heads of
            64, N 64, 32 attention heads of 80, d_ff 10240 GELU, LoRA rank
            128, vocab 32000): K1 60 launches a comm step (120),
            param_bytes 4,099,244,480, K1's bound 4.895 ms a comm step
  lm_ssm_smoke
            falcon-mamba-7b and zamba2-2.7b at smoke width through
            repro_torch.run at mesh (4, 1, 1), expander k=2, adamw, on
            the card and the CPU: host fields exact, losses within
            LM_TRACE_RTOL, K1 once a leaf a comm round
  lm_decode LM inference (reaches no kernel of the port: the launch
            counts, set to 0 before, must read 0 after). llama3-8b at
            full width and depth (32 layers, 8,030,261,248 parameters,
            bf16, the port's init): launch.steps.make_prefill_step at
            B = 1, S = 4096 (prefill_32k's 32,768 left out), timed against
            its bound; make_serve_step over transformer.init_cache at
            B = 8 and max_seq 32,768 (decode_32k's cache; its batch of
            128 cut to 8), LM_DECODE_STEPS teacher-forced steps from
            position 0, held to the forward's logits over the same tokens
            (LM_DECODE_TOL, the reference's own decode gate; argmax
            agreements counted); prints the median step wall and device
            time against the step's byte bound (the weights and the whole
            cache read once), one step's kernels and busy share under
            torch.profiler, the peak (under LM_PEAK_CAP_GIB), and the
            card's decode scores (cuBLAS, bf16 in, float32 out), GQA's
            at the cell and MLA's at deepseek-v2's latent width, held to
            the operands-upcast form (LM_DECODE_SCORES_TOL). Then the
            same prefill and decode steps through the DTensor path
            (launch.mesh.make_serve_mesh at (data 1, model 1) over a
            one-rank NCCL group; the parameters and the same cache,
            zeroed, placed by launch.specs.serve_placements, each a
            DTensor over its own storage, no copy; the steps given the
            mesh): logits and the cache's bit checksums equal to the
            plain run's; the DTensor prefill ms, first and median step
            wall, a step's kernels and busy share and the peak printed
            beside the plain run's. `python3 chip_smoke.py lm_decode`
            runs env, build and this phase alone
  lm_vlm    llama-3.2-vision-90b at its published widths (d_model 8192,
            64 heads (8 kv) of 128, d_ff 28672, vocab 128256, 6400
            encoder tokens of 7680), 4 of its 20 superblocks, the
            cross-attention gates set to LM_VLM_GATE: prefill at B = 1,
            S = 4096 with seeded encoder states (the streamed 4 x 1600
            form), then LM_VLM_STEPS decode steps over a cache whose
            cross-attention K and V are filled from them, held to
            forward(enc=) as lm_decode's; times, kernels, peak
  lm_decode_smoke
            the ten archs at smoke width in float32 (every block kind;
            the gates and LoRA factors perturbed off zero): 8 decode
            steps on the card against the CPU, logits and caches within
            LM_DECODE_SMOKE_TOL of their largest magnitude; and on the
            card through the DTensor path on the one-rank serving mesh,
            logits and caches equal to the plain card run's bit for bit.
            `python3 chip_smoke.py lm_decode_smoke` runs it alone
  dryrun_memory
            the production dry-run's memory reckoning held to the card's
            allocator: for each DRYRUN_MEMORY_CELLS cell of llama3-8b at
            its published widths (one pod's AdamW train step at 4 of 32
            layers, B = 1, S = 4096, lm's cell; prefill at B = 1, S =
            4096, full depth; one decode step at B = 8 over a 32,768
            cache, lm_decode's), launch/dryrun.py `reckon` on a (data 1,
            model 1) layout (meta DTensors over a one-rank placeholder
            group, as `dryrun_cell` reckons the production mesh) gives
            temp + max(output - alias, 0); the step (`dryrun.cell_args`,
            the plain path) then runs on seeded arguments on the card
            once to warm up, and once more after the peak statistics are
            reset: its peak less the bytes resident before it
            (`torch.cuda.max_memory_allocated()` less
            `memory_allocated()`) must lie within DRYRUN_MEMORY_TOL of
            the reckoning, and its outputs must be finite; prints both,
            their ratio and the seconds taken. Host and card, no kernel
            of the port; `python3 chip_smoke.py dryrun_memory` runs env
            and this phase alone (no build)
  kernel_k3 K3 (the flat per-node mix, `kernels.ops.gossip_mix`) against
            its plain version over M in {1, 3, 130, 4099, 8192, 65537,
            2^20} (and a misaligned view), k in {1, 4, 8}, fp32 and bf16
            (fp32: rtol 1e-5, atol 1e-6; bf16: rtol 2e-2, atol 1e-5); then
            the front door once at full width (one llama3-8b decoder
            layer's parameters flattened, M = 218,112,000, k = 4, fp32,
            sw = ew = 0.2) with every launch count set to 0 just before: it
            must launch K3 once and agree with the plain version; then its
            time beside the plain version, torch.addmv (a yardstick the
            port never calls) and the bound
  kernel_k4 K4 (`kernels.ops.flash_attention`) the same way, over
            tests/test_kernels.py's shapes, Sq != Sk (causal and not), MHA,
            GQA, MQA, ragged S, D in {16, 48, 80, 96, 160, 192, 256} and
            D in {1, 12, 100}, each case on the route
            `flash_attention.route` names and launched once there (bf16
            with D % 8 == 0 on "sm90", flash_attention_sm90.cu; fp32 and
            the other bf16 cases on "tf32x3", flash_attention.cu; fp32:
            atol 2e-5, rtol 2e-4, as tests/test_kernels.py; bf16: atol
            1e-5, rtol 1.6e-2, two bf16 ulps); at full width llama3-8b's
            attention at train_4k (B=1, H=32, KH=8, S=4096, D=128, bf16,
            causal) on the sm90 route, with the launch counts by route
            read around it; then on exact fp32 copies of the same q, k, v,
            all held to the fp32 tolerance: the sm90 kernel's bf16-in,
            fp32-out entry (which fails a kernel that rounds P to bf16) and
            the fp32 route (tf32x3), and torch's scaled_dot_product_attention
            on the copies, whose error is reported. Times the bf16 route
            beside the plain version and scaled_dot_product_attention (K
            and V repeated outside the timed window), and the fp32-out
            entry, the fp32 route, the plain version and
            scaled_dot_product_attention on the copies
            (fp32_route_library_ms); bounds for the reference's work
            (4 D flops a kept pair) and the split's (6 D), the fp32 route's
            for the reference's work at 495 TFLOP/s TF32, on the CUDA cores
            at 67 TFLOP/s and its 3xTF32 floor (3 x 4 D flops a pair at
            495 TFLOP/s TF32), and the two sources' build seconds
  kernel_k5 K5 (`kernels.ops.ssd_scan`, three kernels a call) over
            tests/test_kernels.py's shapes, ragged S and P, odd P (P = 37,
            N = 5), N in {6, 128, 136, 220 = MAX_N} and S = 4096 at a
            narrow width (atol 5e-4, rtol 2e-3, as tests/test_kernels.py);
            at full width zamba2-2.7b's Mamba-2 mixer (Bt=1, S=4096, H=80,
            P=64, N=64, fp32), where its error must also be within
            SCAN_CAP (1e-4: the 3xTF32 decision; an `error_cap` line).
            Its plain version is a loop over tokens, thousands of
            launches, so it is timed eagerly over 3 windows of one call; no
            single PyTorch call computes the scan. Its bound counts the
            fewest operations of the chunked form, at the chunk length that
            needs least; its bytes' time stands beside it. Its entry adds
            the kernels the full-width call launched (as the library counts
            them), the chunk length, the heads a block and the workspace
            bytes the call allocated
  kernel_k6 K6 (`kernels.ops.selective_scan`) the same way, ragged and odd
            d, S, N in {1, 3, 32, 64}, and S = 4096 at d = 64, where the
            sequence is split into pieces (atol 5e-4, rtol 2e-3); at full
            width falcon-mamba-7b's mixer (Bt=1, S=4096, d=8192, N=16,
            fp32), one piece, its error within SCAN_CAP (2e-5: exp on the
            SFU); its entry adds the kernels the call launched, the pieces,
            the lanes a channel and the workspace bytes
  ssm_scans K5 and K6 held to the models' own scans (models/ssm.py), as
            tests/test_kernels.py:78-98 holds the Pallas SSD kernel to the
            model's: K5 at zamba2-2.7b's mixer shapes (1, 4096, 80, 64,
            64) against `_ssd_chunk` over the model's 256-token chunks
            with its carry, K6 at falcon-mamba-7b's (1, 4096, 8192, 16)
            against `_m1_scan_chunk` over the same chunks with the D skip,
            each within SCAN_CAP; prints both times (the models' scans
            eagerly). This only measures: the models call neither kernel

Then one JSON line with every kernel's numbers, the card's name and power
limit as nvidia-smi prints them, and the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
#: outside the tensor cores, dense bf16 and TF32 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12

FP32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=1e-5)
#: K4 against its plain version, by dtype: fp32 as tests/test_kernels.py:31;
#: bf16 tighter than that file's atol 2e-2 / rtol 2e-1, since both sides
#: compute in fp32 and round once to bf16, so they may differ by one bf16
#: ulp (at most 2^-7 of the value): rtol 1.6e-2 is two ulps, atol 1e-5
#: covers the fp32 summation order near 0
ATTN_TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
            "bfloat16": dict(atol=1e-5, rtol=1.6e-2)}
#: K5 and K6 against their plain versions, as tests/test_kernels.py:62,77
SCAN_TOL = dict(atol=5e-4, rtol=2e-3)
#: the largest absolute error K5 and K6 may show at full width, far inside
#: SCAN_TOL: they hold the precision decisions. K5's products run in
#: 3xTF32 on the tensor cores (a single TF32 pass is about 1e-3 off there,
#: tests/test_torch_scan_forms.py shows it on the CPU) and K6's exps on the
#: SFU; about 4x and 10x the errors of the fp32 CUDA-core kernels they
#: replaced (2.67e-5 and 1.9e-6)
SCAN_CAP = {"ssd_scan": 1e-4, "selective_scan": 2e-5}
#: the rtol a compressed full-size run is held to against its mix="dense"
#: twin, by compressor (atol 1e-6 throughout): "fvals" for fvals and
#: fvals_consensus, "state" for disagreement and the residual norms. Top-k
#: and int8 are discontinuous: a rounding difference between K2/K1 and
#: cuBLAS near a top-k threshold or an int8 rounding boundary flips a
#: transmitted entry, and the runs drift apart from there; the objective
#: stays close, the state statistics less so. Rand-k's support is a
#: function of (seed, t) alone and does not flip. The measured errors and
#: flip counts are in PERF.md.
TWIN_TOL = {"topk": {"fvals": 5e-5, "state": 5e-2},
            "randk": {"fvals": 1e-5, "state": 1e-5},
            "int8": {"fvals": 1e-5, "state": 1e-2}}
#: the bits of K1's output at the main path's call and of the full-size
#: cell's fvals and disagreement (`_digest`), as the eager loop gave them:
#: the captured run launches the same kernels in the same order, so it
#: must give them too
K1_DIGEST = "268a95744011ca0ff7df2cce4d3ffd801ae69a0ad4069e5aa15e0faf75cb974a"
MAIN_PATH_DIGEST = ("5f506e54118168c58972cac6e3be08280cfc1bf33a76ab994d99009f"
                    "03e75c49")
#: the relative error a sweep lane's device floats may show against its
#: serial run, as tests/test_sweeps.py holds the reference's lanes; the
#: lanes' states are the solo runs' bit for bit (the mix sees them as
#: columns), and so are their statistics, which the batch reduces lane by
#: lane on contiguous copies (the sweep phase counts the equal entries)
SWEEP_RTOL = 1e-6


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _median_window_ms(run_window, reps: int, inner: int) -> float:
    import torch

    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_window()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def time_ms(fn, reps: int = 25, inner: int = 20, graph: bool = True,
            warmup: int = 3) -> dict:
    """Per-call time of `fn` in ms, the median over `reps` CUDA-event
    windows of `inner` calls each, after `warmup` calls, two ways:

      device: the `inner` calls captured once in a CUDA graph and the graph
              replayed, so the window holds the device work back to back
              without the host's launch overhead between calls;
      eager:  the calls issued from Python, as the main path issues them
              (host-bound when the wrapper costs more than the kernel).

    `graph=False` leaves out the graph (a plain loop of thousands of
    launches) and returns the eager time under both keys.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def eager_window():
        for _ in range(inner):
            fn()

    eager = _median_window_ms(eager_window, reps, inner)
    if not graph:
        return {"device": eager, "eager": eager}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = _median_window_ms(graph.replay, reps, inner)
    del graph
    return {"device": device, "eager": eager}


def phase_env() -> dict:
    import torch

    smi = nvidia_smi_line()
    precision = torch.get_float32_matmul_precision()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), matmul_precision=precision,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    if precision != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("float32 matmuls are not at full precision; the "
                           "dense P @ z must not run in TF32")
    return {"nvidia_smi": smi}


def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    seconds = build.build(build.SOURCES)
    for name in build.SOURCES:
        build.load(name)
    wall = time.perf_counter() - t0
    ptxas = {name: _ptxas_report(
        build.library_path(name).with_suffix(".log").read_text())
        for name in build.SOURCES}
    emit("build", seconds=seconds, wall_s=wall, ptxas=ptxas)
    return seconds


def _ptxas_report(log: str) -> list:
    """The compiler's `-Xptxas -v` report, one line for each kernel
    instantiation (its name demangled where `c++filt` is on the path):
    registers, shared memory, stack and spills; then every warning and
    performance remark."""
    import shutil

    names, lines, spills = [], [], ""
    for ln in log.splitlines():
        ln = ln.strip()
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            names.append(entry.group(1))
            spills = ""
        elif "spill" in ln:  # ptxas prints it before the registers
            spills = "; " + ln
        elif "Used" in ln and "registers" in ln and names:
            lines.append(f"{names[-1]}: {ln.split(':', 1)[1].strip()}"
                         f"{spills}")
        elif "warning" in ln.lower() or "Performance Loss" in ln:
            lines.append(ln)
    filt = shutil.which("c++filt")
    if filt and names:
        plain = subprocess.run([filt], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(plain) == len(names):
            for mangled, readable in zip(names, plain):
                lines = [ln.replace(mangled + ":", readable + ":")
                         for ln in lines]
    return lines


def _dense_cell_spec(compression=None):
    """The full-size dense cell of benchmarks/bench_dense.py (:154-157)."""
    import repro_torch

    return repro_torch.ExperimentSpec(
        name="dense_full", T=300, eval_every=25, r=0.01,
        problem={"kind": "quadratic_consensus",
                 "params": {"n": 256, "d": 4096, "seed": 0}},
        topology={"kind": "expander", "params": {"k": 4, "seed": 0}},
        schedule={"kind": "periodic", "params": {"h": 2}},
        stepsize={"kind": "sqrt", "params": {"A": 0.5}},
        compression=compression,
        backends=[{"kind": "dense", "params": {}}])


#: each kernel's launch count in repro_torch.kernels.counters, by kernel
_COUNTS = {"gossip_mix": ("gossip_mix", "LAUNCHES"),
           "compress_mix": ("compress_mix", "LAUNCHES"),
           "gossip_mix_flat": ("gossip_mix", "FLAT_LAUNCHES"),
           "flash_attention": ("flash_attention", "LAUNCHES"),
           "ssd_scan": ("ssd_scan", "LAUNCHES"),
           "selective_scan": ("selective_scan", "LAUNCHES")}


#: K4's launches by route (flash_attention.route), beside its total above
_ROUTE_COUNTS = {"sm90": "SM90_LAUNCHES", "tf32x3": "TF32X3_LAUNCHES"}


def _launch_counts() -> dict:
    from repro_torch.kernels import counters

    snap = counters.snapshot()
    return {kernel: snap[key] for kernel, key in _COUNTS.items()}


def _route_counts() -> dict:
    from repro_torch.kernels import counters

    snap = counters.snapshot()
    return {route: snap[("flash_attention", attr)]
            for route, attr in _ROUTE_COUNTS.items()}


def _zero_launch_counts() -> None:
    """Every counter of repro_torch.kernels.counters to 0 (the ones the run
    program adds on replay among them)."""
    from repro_torch.kernels import counters

    counters.zero()


def _front_door_once(kernel: str, call):
    """`call()` (one front-door call) with every launch count set to 0 just
    before and read just after: it must have launched `kernel` exactly once
    and no other kernel. Returns its output and the launches."""
    import torch

    _zero_launch_counts()
    out = call()
    torch.cuda.synchronize()
    counts = _launch_counts()
    if counts[kernel] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"one front-door call of {kernel} launched "
                             f"{counts}")
    return out, counts[kernel]


def _bound(nbytes: float, flops: float, peak_flops: float = FP32_FLOPS
           ) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the HBM rate, or the operations at `peak_flops`,
    whichever is longer."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / peak_flops * 1e3
    return {"bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def _max_err(out, expect) -> float:
    return float((out.float() - expect.float()).abs().max())


def _mix_inputs(gen, n, M, k, dtype, vector_weights, with_msg):
    import torch

    dev = "cuda"
    z = torch.randn((n, M), generator=gen, device=dev).to(dtype)
    msg = (torch.randn((n, M), generator=gen, device=dev).to(dtype)
           if with_msg else None)
    S_in = torch.randint(0, n, (n, k), generator=gen, device=dev)
    if vector_weights:
        w_self = torch.rand((n,), generator=gen, device=dev) * 0.5 + 0.2
        w_edge = torch.rand((n, k), generator=gen, device=dev) * 0.3
    else:
        w_self, w_edge = 0.2, 0.8 / k
    return z, S_in, w_self, w_edge, msg


def _digest(*arrays) -> str:
    """sha256 of the arrays' float32 bytes, one after the other."""
    import numpy as np
    import torch

    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        h.update(np.ascontiguousarray(a, dtype=np.float32).tobytes())
    return h.hexdigest()


def _form_launched(before: dict) -> str:
    """The kernel (slab or regs) of the one K1 call made since
    gossip_mix.FORM_LAUNCHES read `before`."""
    from repro_torch.kernels import gossip_mix

    grown = [form for form, count in gossip_mix.FORM_LAUNCHES.items()
             if count != before[form]]
    if len(grown) != 1 or sum(gossip_mix.FORM_LAUNCHES.values()) != sum(
            before.values()) + 1:
        raise AssertionError(f"one K1 call counted {before} -> "
                             f"{gossip_mix.FORM_LAUNCHES}")
    return grown[0]


def _sweep_call(kernel: str) -> dict:
    """K1 ("gossip_mix") or K2 ("compress_mix") at the sweep phase's call:
    the five lanes' (n, B, d) carry of the full-size cell (n=256, B=5,
    d=4096, k=4, fp32, its expander) handed to the front door as the run
    program hands it, one (n, B*d) state to the kernel. Each case must
    launch its kernel once (K1 its slab kernel), agree with the plain
    version on the same inputs within FP32_TOL, and give each lane's
    columns the bits of a one-lane call on them (every column mixes on its
    own). K1 mixes z and a message stack of its own; K2's mask is top-k at
    keep 1/4, drawn per node and lane. Both weight forms: the scalars the
    run program passes and per-node vectors."""
    import numpy as np
    import torch

    from repro_torch.compress import topk_mask_torch
    from repro_torch.core.graphs import kregular_expander
    from repro_torch.kernels import gossip_mix, ops, ref

    n, B, d, k = 256, len(SWEEP_VALUES), 4096, 4
    g = kregular_expander(n, k=k, seed=0)
    S_in = torch.as_tensor([list(p) for p in g.perms], device="cuda").T \
        .contiguous()
    ws, we = float(np.float32(g.self_weight)), float(np.float32(
        g.edge_weight))
    rng = np.random.default_rng(2)

    def draw():
        return torch.from_numpy(rng.standard_normal(
            (n, B, d), dtype=np.float32)).cuda()

    def door(w_self, w_edge, z, msg, mask):
        if kernel == "gossip_mix":
            return ops.gossip_gather_mix_impl(z, S_in, w_self, w_edge,
                                              msg=msg)
        return ops.compress_mix_impl(z, msg, mask, S_in, w_self, w_edge)

    def plain(w_self, w_edge, z, msg, mask):
        if kernel == "gossip_mix":
            return ref.gossip_gather_mix_ref(z, S_in, w_self, w_edge,
                                             msg=msg)
        return ref.compress_mix_ref(z, msg, mask, S_in, w_self, w_edge)

    worst, cases, lanes_equal = 0.0, 0, 0
    for weights in ((ws, we), (torch.full((n,), ws, device="cuda"),
                               torch.full((n, k), we, device="cuda"))):
        for with_msg in ((False, True) if kernel == "gossip_mix"
                         else (True,)):
            z = draw()
            msg = z + 0.1 * draw() if with_msg else None
            mask = None
            if kernel == "compress_mix":
                mask = topk_mask_torch(msg, d // 4)
                kept = mask.sum(dim=-1)
                if mask.shape != z.shape or not bool(
                        (kept == d // 4).all()):
                    raise AssertionError("the sweep call's top-k mask does "
                                         "not keep d/4 a node and lane")
            where = (f"{kernel} at the sweep's call (n={n}, M={B}x{d}, "
                     f"k={k}, vector weights="
                     f"{isinstance(weights[0], torch.Tensor)}, "
                     f"msg={with_msg})")
            forms = dict(gossip_mix.FORM_LAUNCHES)
            before = _launch_counts()
            out = door(*weights, z, msg, mask)
            grown = {kern: c - before[kern]
                     for kern, c in _launch_counts().items()
                     if c != before[kern]}
            if grown != {kernel: 1}:
                raise AssertionError(f"{where} launched {grown}")
            if kernel == "gossip_mix" and _form_launched(forms) != "slab":
                raise AssertionError(f"{where} did not take the slab "
                                     f"kernel")
            expect = plain(*weights, z, msg, mask)
            torch.cuda.synchronize()
            if out.dtype != torch.float32 or out.shape != z.shape:
                raise AssertionError(f"{where} returned {out.dtype} "
                                     f"{tuple(out.shape)}")
            torch.testing.assert_close(out, expect, **FP32_TOL,
                                       msg=lambda m: f"{where}: {m}")
            worst = max(worst, _max_err(out, expect))
            cases += 1
            for lane in range(B):
                def one(a):
                    return None if a is None else a[:, lane].contiguous()

                solo = door(*weights, one(z), one(msg), one(mask))
                if not torch.equal(out[:, lane], solo):
                    raise AssertionError(f"{where}: lane {lane} differs "
                                         f"from a one-lane call")
                lanes_equal += 1
    return {"name": kernel, "shape": {"n": n, "M": B * d, "lanes": B,
                                      "k": k, "dtype": "float32"},
            "cases": cases, "lanes_bitwise_equal": lanes_equal,
            "max_abs_err": worst, "fp32_tol": FP32_TOL}


def phase_kernel() -> dict:
    """K1 against its plain version on the card, then its times."""
    import numpy as np
    import torch

    from repro_torch.kernels import gossip_mix, ops, ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    checked = 0
    forms = {"regs": 0, "slab": 0}
    min_reads = gossip_mix.slab_min_reads()
    for n in (7, 12, 256, 1024):
        for M in (1, 130, 257, 4096, 65536):
            # k <= 8 takes a kernel built for its k, k = 9 the generic one
            for k in (1, 4, 8, 9):
                for dtype, tol in ((torch.float32, FP32_TOL),
                                   (torch.bfloat16, BF16_TOL)):
                    for vector_weights in (False, True):
                        # msg: none (z itself), its own tensor, or a view
                        # one element in, not 16-byte aligned (the
                        # one-element path)
                        for with_msg in ("none", "own", "offset"):
                            args = _mix_inputs(gen, n, M, k, dtype,
                                               vector_weights,
                                               with_msg == "own")
                            z, S_in, w_self, w_edge, msg = args
                            if with_msg == "offset":
                                msg = _randn(gen, (n * M + 1,), dtype)[1:] \
                                    .view(n, M)
                            before = dict(gossip_mix.FORM_LAUNCHES)
                            out = ops.gossip_gather_mix_impl(
                                z, S_in, w_self, w_edge, msg=msg)
                            form = _form_launched(before)
                            expect = ref.gossip_gather_mix_ref(
                                z, S_in, w_self, w_edge, msg=msg)
                            torch.cuda.synchronize()
                            err = (out.float() - expect.float()).abs()
                            worst[str(dtype).split(".")[1]] = max(
                                worst[str(dtype).split(".")[1]],
                                float(err.max()))
                            if out.dtype != dtype or out.shape != z.shape:
                                raise AssertionError(
                                    f"K1 returned {out.dtype} {out.shape} "
                                    f"for {dtype} {tuple(z.shape)}")
                            where = (f"n={n} M={M} k={k} {dtype} "
                                     f"vector={vector_weights} "
                                     f"msg={with_msg}")
                            torch.testing.assert_close(
                                out.float(), expect.float(), **tol,
                                msg=lambda m: f"K1 disagrees at {where}: {m}")
                            # the slab kernel takes 16-byte packets (M a
                            # multiple of 16 bytes, every operand aligned),
                            # k <= 8 and n (k + 1) row reads a column from
                            # slab_min_reads(); its shared memory holds
                            # n = 1024
                            packets = M * out.element_size() % 16 == 0 \
                                and with_msg != "offset"
                            expect_form = ("slab" if packets and k <= 8
                                           and n * (k + 1) >= min_reads
                                           else "regs")
                            if form != expect_form:
                                raise AssertionError(
                                    f"K1 launched its {form} kernel at "
                                    f"{where}, not {expect_form}")
                            forms[form] += 1
                            checked += 1
    emit("kernel_check", name="gossip_mix", cases=checked,
         forms_launched=forms, max_abs_err=worst, fp32_tol=FP32_TOL,
         bf16_tol=BF16_TOL)
    emit("kernel_check_sweep_call", **_sweep_call("gossip_mix"))

    # the main path's call: n=256, M=4096, k=4, fp32, uniform weights
    n, M, k = 256, 4096, 4
    from repro_torch.core.graphs import kregular_expander

    g = kregular_expander(n, k=k, seed=0)
    S_in = torch.as_tensor([list(p) for p in g.perms], device="cuda").T \
        .contiguous()
    # z from numpy, seeded, so that its bits depend on nothing else here
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, M), dtype=np.float32)).cuda()
    ws, we = float(g.self_weight), float(g.edge_weight)
    w_self = torch.full((n,), ws, device="cuda")
    w_edge = torch.full((n, k), we, device="cuda")
    P = torch.as_tensor(g.mixing_matrix(), dtype=torch.float32,
                        device="cuda")
    before = dict(gossip_mix.FORM_LAUNCHES)
    out = gossip_mix.gossip_mix_weighted(z, S_in, w_self, w_edge)
    # the kernel timed below, and the one the main path launches 149 times
    form = _form_launched(before)
    if form != "slab":
        raise AssertionError(f"K1 launched its {form} kernel at the main "
                             f"path's call, not the slab kernel")
    expect = ref.gossip_gather_mix_ref(z, S_in, ws, we)
    torch.cuda.synchronize()
    max_abs_err = float((out - expect).abs().max())
    # the output's bits: a redesign of K1 keeps its arithmetic order, so
    # this digest does not change
    k1_digest = _digest(out)
    if k1_digest != K1_DIGEST:
        raise AssertionError(f"K1's output bits changed: k1_digest "
                             f"{k1_digest}, not {K1_DIGEST}")
    torch.testing.assert_close(out, expect, **FP32_TOL)
    torch.testing.assert_close(out, P @ z, **FP32_TOL)
    kernel_t = time_ms(
        lambda: gossip_mix.gossip_mix_weighted(z, S_in, w_self, w_edge))
    plain_t = time_ms(lambda: ref.gossip_gather_mix_ref(z, S_in, ws, we))
    library_t = time_ms(lambda: torch.matmul(P, z))
    # each input read once, the output written once: z, S_in, the weight
    # vectors the kernel reads, out
    nbytes = (2 * n * M * 4 + S_in.numel() * 8 + w_self.numel() * 4
              + w_edge.numel() * 4)
    flops = (2 * k + 1) * n * M
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS * 1e3
    numbers = dict(name="gossip_mix", route="cuda",
                   source="src/repro_torch/kernels/csrc/gossip_mix.cu",
                   replaces="src/repro/kernels/gossip_mix.py:88",
                   max_abs_err=max_abs_err, ms=kernel_t["device"],
                   plain_ms=plain_t["device"],
                   bound_ms=max(bytes_ms, flops_ms),
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                   library_ms=library_t["device"])
    emit("kernel_time", shape={"n": n, "M": M, "k": k, "dtype": "float32"},
         k1_digest=k1_digest, form=form,
         bytes=nbytes, flops=flops, kernel_ms=kernel_t["device"],
         eager_ms=kernel_t["eager"],
         plain_eager_ms=plain_t["eager"], library_eager_ms=library_t["eager"],
         **numbers)
    return numbers


def phase_kernel_k2() -> dict:
    """K2 against its plain version on the card, then its times."""
    import torch

    from repro_torch.compress import topk_mask_torch
    from repro_torch.kernels import compress_mix, gossip_mix, ops, ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    checked = 0
    ones_checked = 0
    for n in (7, 12, 256, 1024):
        for M in (1, 130, 257, 4096, 65536):
            for k in (1, 4, 8):
                for dtype, tol in ((torch.float32, FP32_TOL),
                                   (torch.bfloat16, BF16_TOL)):
                    for vector_weights in (False, True):
                        z, S_in, w_self, w_edge, msg = _mix_inputs(
                            gen, n, M, k, dtype, vector_weights, True)
                        for density in (0.0, 0.125, 1.0):
                            mask = (torch.rand((n, M), generator=gen,
                                               device="cuda")
                                    < density).to(dtype)
                            out = ops.compress_mix_impl(
                                z, msg, mask, S_in, w_self, w_edge)
                            expect = ref.compress_mix_ref(
                                z, msg, mask, S_in, w_self, w_edge)
                            torch.cuda.synchronize()
                            key = str(dtype).split(".")[1]
                            worst[key] = max(worst[key], float(
                                (out.float() - expect.float()).abs().max()))
                            if out.dtype != dtype or out.shape != z.shape:
                                raise AssertionError(
                                    f"K2 returned {out.dtype} {out.shape} "
                                    f"for {dtype} {tuple(z.shape)}")
                            torch.testing.assert_close(
                                out.float(), expect.float(), **tol,
                                msg=lambda m: (f"K2 disagrees at n={n} "
                                               f"M={M} k={k} {dtype} "
                                               f"vector={vector_weights} "
                                               f"density={density}: {m}"))
                            checked += 1
                            if density == 1.0:
                                k1 = ops.gossip_gather_mix_impl(
                                    z, S_in, w_self, w_edge, msg=msg)
                                if not torch.equal(out, k1):
                                    raise AssertionError(
                                        f"K2 with an all-ones mask differs "
                                        f"from K1 with msg at n={n} M={M} "
                                        f"k={k} {dtype}")
                                ones_checked += 1
    emit("kernel_check", name="compress_mix", cases=checked,
         all_ones_equal_k1=ones_checked, max_abs_err=worst,
         fp32_tol=FP32_TOL, bf16_tol=BF16_TOL)
    emit("kernel_check_sweep_call", **_sweep_call("compress_mix"))

    # the main path's call: n=256, M=4096, k=4, fp32, uniform weights, a
    # top-k support at keep 1/4 of the corrected messages
    n, M, k = 256, 4096, 4
    from repro_torch.core.graphs import kregular_expander

    g = kregular_expander(n, k=k, seed=0)
    S_in = torch.as_tensor([list(p) for p in g.perms], device="cuda").T \
        .contiguous()
    z = torch.randn((n, M), generator=gen, device="cuda")
    msg = z + 0.1 * torch.randn((n, M), generator=gen, device="cuda")
    mask = topk_mask_torch(msg, M // 4)
    ws, we = float(g.self_weight), float(g.edge_weight)
    w_self = torch.full((n,), ws, device="cuda")
    w_edge = torch.full((n, k), we, device="cuda")
    P = torch.as_tensor(g.mixing_matrix(), dtype=torch.float32,
                        device="cuda")
    P_diag = torch.diagonal(P).clone()
    P_off = P - torch.diag(P_diag)
    out = compress_mix.compress_mix_weighted(z, msg, mask, S_in, w_self,
                                             w_edge)
    expect = ref.compress_mix_ref(z, msg, mask, S_in, ws, we)
    torch.cuda.synchronize()
    max_abs_err = float((out - expect).abs().max())
    torch.testing.assert_close(out, expect, **FP32_TOL)
    torch.testing.assert_close(out, P_diag[:, None] * z + P_off @ (msg * mask),
                               **FP32_TOL)
    kernel_t = time_ms(lambda: compress_mix.compress_mix_weighted(
        z, msg, mask, S_in, w_self, w_edge))
    plain_t = time_ms(lambda: ref.compress_mix_ref(z, msg, mask, S_in, ws,
                                                   we))
    library_t = time_ms(lambda: P_diag[:, None] * z + P_off @ (msg * mask))
    # each input read once, the output written once: z, msg, mask, out,
    # S_in and the weight vectors the kernel reads
    nbytes = (4 * n * M * 4 + S_in.numel() * 8 + w_self.numel() * 4
              + w_edge.numel() * 4)
    flops = (3 * k + 1) * n * M
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS * 1e3
    numbers = dict(name="compress_mix", route="cuda",
                   source="src/repro_torch/kernels/csrc/compress_mix.cu",
                   replaces="src/repro/kernels/compress_mix.py:47",
                   max_abs_err=max_abs_err, ms=kernel_t["device"],
                   plain_ms=plain_t["device"],
                   bound_ms=max(bytes_ms, flops_ms),
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                   library_ms=library_t["device"])
    emit("kernel_time", shape={"n": n, "M": M, "k": k, "dtype": "float32",
                               "mask": "top-k, keep 1/4"},
         bytes=nbytes, flops=flops, kernel_ms=kernel_t["device"],
         eager_ms=kernel_t["eager"],
         plain_eager_ms=plain_t["eager"], library_eager_ms=library_t["eager"],
         library_call="P_diag[:, None] * z + P_off @ (msg * mask): three "
                      "calls (two products and a sum around one matmul); no "
                      "single PyTorch call computes K2's function",
         **numbers)
    return numbers


#: the seven manifests with a dense backend: the first three mix through
#: the hand kernels (expanders), the other four through cuBLAS's P @ z
#: (complete graphs), which launches no hand kernel
SPARSE_MANIFESTS = ("expander_periodic", "expander_sparse",
                    "compressed_expander")
DENSE_MIX_MANIFESTS = ("complete_every", "fig1_complete", "fig1_reduced",
                       "fig2_sparse")


def phase_manifests() -> None:
    import repro_torch
    from repro_torch.convert import assert_results_match
    from repro_torch.experiments import components as C

    for name in SPARSE_MANIFESTS + DENSE_MIX_MANIFESTS:
        spec = repro_torch.ExperimentSpec.from_file(
            ROOT / "benchmarks" / "manifests" / f"{name}.json")
        kernel = ("none" if name in DENSE_MIX_MANIFESTS
                  else "gossip_mix" if spec.compression is None
                  else "compress_mix")
        # a problem whose closures read the card back cannot be captured
        loop = ("graph" if C.build_component(
            C.problems, spec.problem.kind, spec.problem.params,
            device="cpu").capturable else "eager")
        before = _launch_counts()
        on_card = repro_torch.run(spec, "dense", device="cuda")
        after = _launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        on_cpu = repro_torch.run(spec, "dense", device="cpu")
        card, cpu = on_card.to_dict(), on_cpu.to_dict()
        flips = (_manifest_flips(spec) if name in DENSE_MIX_MANIFESTS
                 and spec.problem.kind != "quadratic_consensus" else None)
        emit("manifest", name=name, mix_mode=card["extras"]["mix_mode"],
             kernel=kernel, launches=launches.get(kernel, 0),
             loop=on_card.metrics.notes["loop"],
             final_f_card=card["trace"]["fvals"][-1],
             final_f_cpu=cpu["trace"]["fvals"][-1],
             time_to_target=card["time_to_target"],
             max_rel_err={f: _max_rel_err(card["trace"][f], cpu["trace"][f])
                          for f in ("fvals", "fvals_consensus",
                                    "disagreement")},
             card_cpu_flips=flips)
        assert_results_match(card, cpu)
        if on_card.metrics.notes["loop"] != loop:
            raise AssertionError(f"{name}: ran {on_card.metrics.notes} on "
                                 f"the card, its problem declares {loop}")
        rounds = card["trace"]["comms"][-1]
        expect = 0 if kernel == "none" else rounds
        if launches.get(kernel, 0) != expect or sum(
                launches.values()) != expect:
            raise AssertionError(f"{name}: launches {launches} for "
                                 f"{rounds} rounds of {kernel}")


def _manifest_flips(spec) -> dict:
    """A complete-graph manifest on the card and on the CPU side by side,
    one iteration at a time, as `_flipped_entries` runs its twins: after
    every iteration, the discrete choices of each side's state that
    differ. For the nonsmooth problem the subgradient's picks (which of
    each center pair `argmax` takes at x), for metric learning the signs
    of the eigenvalues the PSD projection clamps (of -a(t) z's symmetric
    part). Returns the first iteration that differs, the entries there,
    and the totals over the run."""
    import numpy as np
    import torch

    from repro_torch.core.dda import DDASimulator
    from repro_torch.experiments import components as C

    sims, states, problems = [], [], []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        problem = C.build_component(C.problems, spec.problem.kind,
                                    spec.problem.params, device=dev)
        graph = C.build_component(C.topologies, spec.topology.kind,
                                  spec.topology.params, n=problem.n)
        sims.append(DDASimulator(
            problem.subgrad_stack, problem.objective, graph,
            C.build_component(C.schedules, spec.schedule.kind,
                              spec.schedule.params),
            a_fn=C.build_component(C.stepsizes, spec.stepsize.kind,
                                   spec.stepsize.params),
            r=spec.r, projection=problem.projection, device=dev))
        zeros = torch.zeros((problem.n, problem.d), device=dev)
        states.append((zeros, zeros, zeros, zeros,
                       torch.zeros((), device=dev)))
        problems.append(problem)

    def codes(problem, sim, state):
        z, x, _, _, t = state
        if spec.problem.kind == "nonsmooth":
            diff = x[:, None, None, :] - problem.arrays["centers_j"]
            return torch.argmax(torch.sum(diff * diff, dim=-1), dim=-1)
        f = int(round((problem.d - 1) ** 0.5))
        A = (-sim.a_fn(t) * z)[:, :f * f].reshape(-1, f, f)
        return torch.linalg.eigvalsh(0.5 * (A + A.transpose(-1, -2))) > 0

    mask = np.asarray(sims[0].schedule.comm_mask(0, spec.T), dtype=bool)
    first, total, iters_with = None, 0, 0
    for i in range(spec.T):
        states = [sim._segment(*s, mask[i:i + 1])
                  for sim, s in zip(sims, states)]
        a, b = (codes(p, sim, s).cpu()
                for p, sim, s in zip(problems, sims, states))
        flips = int((a != b).sum())
        total += flips
        iters_with += flips > 0
        if flips and first is None:
            first = {"iteration": i + 1, "entries": flips}
    return {"first_flip": first, "flipped_entries": total,
            "iterations_with_flips": iters_with}


def _profiled_kernels(prof, name: str) -> int:
    """How many kernels whose name holds `name` the profiler saw run."""
    return sum(ev.count for ev in prof.key_averages() if name in ev.key)


def phase_main_path() -> int:
    """The full-size dense cell, with the launch counts read around it and
    the profiler watching it; then again unprofiled, for its wall."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.convert import assert_results_match
    from repro_torch.core.dda import _LaneProgram
    from repro_torch.core.schedules import Periodic

    from repro_torch.kernels import gossip_mix

    spec = _dense_cell_spec()
    _zero_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = repro_torch.run(spec, device="cuda")
        torch.cuda.synchronize()
    counts = _launch_counts()
    forms = dict(gossip_mix.FORM_LAUNCHES)
    launches = counts["gossip_mix"]
    if sum(counts.values()) != launches:
        raise AssertionError(f"the uncompressed cell launched another "
                             f"kernel than K1: {counts}")
    if forms != {"regs": 0, "slab": launches}:
        raise AssertionError(f"the uncompressed cell's K1 launches took "
                             f"the kernels {forms}, not the slab kernel")
    # the counts are derived from the graphs' replays: hold them to the
    # kernels the card ran, which are those, the capture's warm-up (one
    # comm body, so one K1 launch, a pass) and the comm graph's first
    # replay at the capture (one K1 launch)
    profiled = {form: _profiled_kernels(prof, f"gossip_mix_{form}")
                for form in ("regs", "slab")}
    if profiled != {"regs": 0,
                    "slab": launches + _LaneProgram.WARMUP + 1}:
        raise AssertionError(f"the profiler saw the K1 kernels {profiled}, "
                             f"not {launches} replayed, "
                             f"{_LaneProgram.WARMUP} warming up and 1 "
                             f"first replay at the capture")
    d = result.to_dict()
    trace = d["trace"]
    rounds = trace["comms"][-1]
    if d["extras"]["mix_mode"] != "sparse":
        raise AssertionError(f"main path mixed {d['extras']['mix_mode']}")
    # eq. 19: H_T = floor((T - 1) / h) rounds, 149 at T=300, h=2
    expected = Periodic(h=2).H(spec.T)
    if launches != rounds or rounds != expected:
        raise AssertionError(f"{launches} K1 launches for {rounds} rounds "
                             f"(expected {expected})")
    if len(trace["fvals"]) != spec.T // spec.eval_every or not all(
            v is not None and math.isfinite(v) for v in trace["fvals"]):
        raise AssertionError(f"main path trace malformed: {trace['fvals']}")
    if result.metrics.notes["loop"] != "graph":
        raise AssertionError(f"the main path ran {result.metrics.notes}, "
                             f"not captured")
    digest = _digest(trace["fvals"], trace["disagreement"])
    if digest != MAIN_PATH_DIGEST:
        raise AssertionError(f"the main path's bits changed: "
                             f"main_path_digest {digest}, not "
                             f"{MAIN_PATH_DIGEST}")
    # unprofiled, for the captured wall, and the same bits
    timed = repro_torch.run(spec, device="cuda")
    if timed.metrics.notes["loop"] != "graph" or _digest(
            timed.trace.fvals, timed.trace.disagreement) != digest:
        raise AssertionError("the unprofiled captured run differs from "
                             "the profiled one")
    # the eager host loop over the same kernels, for its wall beside the
    # captured run's, and its bits
    eager = repro_torch.run(
        spec, repro_torch.ComponentSpec("dense", {"loop": "segment"}),
        device="cuda")
    if eager.metrics.notes["loop"] != "eager" or _digest(
            eager.trace.fvals, eager.trace.disagreement) != digest:
        raise AssertionError("the eager loop='segment' run differs from "
                             "the captured one")
    twin = repro_torch.run(
        spec, repro_torch.ComponentSpec("dense", {"mix": "dense"}),
        device="cuda")
    twin_d = twin.to_dict()
    if twin_d["extras"]["mix_mode"] != "dense" or \
            twin.metrics.notes["loop"] != "graph":
        raise AssertionError(f"the mix='dense' twin mixed "
                             f"{twin_d['extras']['mix_mode']}, ran "
                             f"{twin.metrics.notes}")
    # the twin differs by construction only in its backend params and the
    # mix mode it reports; everything the run computed must agree
    twin_d["backend"], twin_d["extras"] = d["backend"], d["extras"]
    assert_results_match(d, twin_d)
    m = timed.metrics
    emit("main_path", launches=launches, rounds=rounds,
         k1_forms_launched=forms, k1_kernels_profiled=profiled,
         main_path_digest=digest,
         loop=m.notes["loop"],
         mix_mode=d["extras"]["mix_mode"], compile_s=m.compile_s,
         execute_s=m.execute_s, wall_s=timed.wall_s,
         us_per_iter=m.execute_s / spec.T * 1e6,
         eager_us_per_iter=eager.metrics.execute_s / spec.T * 1e6,
         eager_ratio=m.execute_s / eager.metrics.execute_s,
         twin_execute_s=twin.metrics.execute_s,
         twin_us_per_iter=twin.metrics.execute_s / spec.T * 1e6,
         twin_ratio=m.execute_s / twin.metrics.execute_s,
         final_f=trace["fvals"][-1], twin_final_f=twin_d["trace"]["fvals"][-1])
    return launches


def _flipped_entries(spec) -> dict:
    """The full-size compressed cell and its mix="dense" twin run side by
    side, one iteration at a time: at every communication round, the
    entries whose transmitted code differs between the two runs (a support
    entry of a sparsifier, an int8 code). Returns the first round that
    differs, how many entries flipped there, and the totals over the run:
    after the first flip the runs drift apart and later flips follow from
    it."""
    import numpy as np
    import torch

    from repro_torch.compress import build_compressor
    from repro_torch.core.dda import DDASimulator
    from repro_torch.experiments import components as C

    dev = torch.device("cuda")
    problem = C.build_component(C.problems, spec.problem.kind,
                                spec.problem.params, device=dev)
    graph = C.build_component(C.topologies, spec.topology.kind,
                              spec.topology.params, n=problem.n)
    comp = build_compressor(spec.compression.kind,
                            dict(spec.compression.params))
    sims = [DDASimulator(
        problem.subgrad_stack, problem.objective, graph,
        C.build_component(C.schedules, spec.schedule.kind,
                          spec.schedule.params),
        a_fn=C.build_component(C.stepsizes, spec.stepsize.kind,
                               spec.stepsize.params),
        r=spec.r, compression=comp, mix=mix,
        projection=problem.projection, device=dev)
        for mix in ("sparse", "dense")]
    mask = np.asarray(sims[0].schedule.comm_mask(0, spec.T), dtype=bool)
    zeros = torch.zeros((problem.n, problem.d), device=dev)
    states = [(zeros, zeros, zeros, zeros,
               torch.zeros((), device=dev)) for _ in sims]
    codes = (comp.support_mask_torch if comp.is_sparsifier
             else lambda c, t: comp.codes_torch(c, t)[0])
    first, total, rounds_with = None, 0, 0
    for i in range(spec.T):
        if mask[i]:
            a, b = (codes(s[0] + s[3], s[4]) for s in states)
            flips = int((a != b).sum())
            total += flips
            rounds_with += flips > 0
            if flips and first is None:
                first = {"iteration": i + 1, "entries": flips}
        states = [sim._segment(*s, mask[i:i + 1])
                  for sim, s in zip(sims, states)]
    return {"first_flip": first, "flipped_entries": total,
            "rounds_with_flips": rounds_with}


def _allclose(ours, theirs, rtol: float) -> bool:
    import numpy as np

    return len(ours) == len(theirs) and bool(np.allclose(
        np.array(ours, np.float64), np.array(theirs, np.float64), rtol=rtol,
        atol=FP32_TOL["atol"]))


def _max_rel_err(ours, theirs) -> float:
    import numpy as np

    a = np.array([np.nan if v is None else v for v in ours], np.float64)
    b = np.array([np.nan if v is None else v for v in theirs], np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def phase_main_path_compressed() -> int:
    """The full-size cell under top-k, rand-k and int8, each with the
    launch counts read around it and held against its dense twin.
    Returns K2's launches in the top-k run."""
    import math

    import torch

    import repro_torch
    from repro_torch.compress import RandK
    from repro_torch.convert import assert_results_match
    from repro_torch.kernels import gossip_mix

    k2_launches = None
    for kind, params, kernel in (
            ("topk", {"keep": 0.25}, "compress_mix"),
            ("randk", {"keep": 0.25}, "compress_mix"),
            ("int8", {}, "gossip_mix")):
        spec = _dense_cell_spec({"kind": kind, "params": params})
        _zero_launch_counts()
        result = repro_torch.run(spec, device="cuda")
        counts = _launch_counts()
        d = result.to_dict()
        rounds = d["trace"]["comms"][-1]
        others = sum(v for k, v in counts.items() if k != kernel)
        if d["extras"]["mix_mode"] != "sparse":
            raise AssertionError(f"{kind}: mixed {d['extras']['mix_mode']}")
        if result.metrics.notes["loop"] != "graph":
            raise AssertionError(f"{kind}: ran {result.metrics.notes}, not "
                                 f"captured")
        if counts[kernel] != 149 or rounds != 149 or others != 0:
            raise AssertionError(f"{kind}: launches {counts} for {rounds} "
                                 f"rounds (expected 149 of {kernel})")
        forms = dict(gossip_mix.FORM_LAUNCHES)
        if forms != {"regs": 0, "slab": counts["gossip_mix"]}:
            raise AssertionError(f"{kind}: K1's launches took the kernels "
                                 f"{forms}, not the slab kernel")
        block = d["extras"]["compression"]
        norms = block["residual_norms"]
        if len(norms) != spec.T // spec.eval_every or not all(
                v is not None and math.isfinite(v) and v > 0
                for v in norms):
            raise AssertionError(f"{kind}: residual norms {norms}")
        if not all(v is not None and math.isfinite(v)
                   for v in d["trace"]["fvals"]):
            raise AssertionError(f"{kind}: trace {d['trace']['fvals']}")
        twin = repro_torch.run(
            spec, repro_torch.ComponentSpec("dense", {"mix": "dense"}),
            device="cuda")
        twin_d = twin.to_dict()
        if twin_d["extras"]["mix_mode"] != "dense" or \
                twin.metrics.notes["loop"] != "graph":
            raise AssertionError(f"{kind}: the mix='dense' twin mixed "
                                 f"{twin_d['extras']['mix_mode']}, ran "
                                 f"{twin.metrics.notes}")
        errors = {f: _max_rel_err(d["trace"][f], twin_d["trace"][f])
                  for f in ("fvals", "fvals_consensus", "disagreement")}
        errors["residual_norms"] = _max_rel_err(
            norms, twin_d["extras"]["compression"]["residual_norms"])
        flips = _flipped_entries(spec)
        m = result.metrics
        emit("main_path_compressed", compression=kind, params=params,
             kernel=kernel, launches=counts[kernel], rounds=rounds,
             mix_mode=d["extras"]["mix_mode"], loop=m.notes["loop"],
             wire_ratio=block["wire_ratio"], compile_s=m.compile_s,
             execute_s=m.execute_s,
             us_per_iter=m.execute_s / spec.T * 1e6,
             twin_us_per_iter=twin.metrics.execute_s / spec.T * 1e6,
             twin_ratio=m.execute_s / twin.metrics.execute_s,
             final_f=d["trace"]["fvals"][-1],
             twin_final_f=twin_d["trace"]["fvals"][-1],
             final_residual_norm=norms[-1], twin_max_rel_err=errors,
             twin_tol=TWIN_TOL[kind], **flips)
        # the twin differs by construction only in its backend params and
        # the mix mode it reports
        twin_d["backend"] = d["backend"]
        twin_d["extras"]["mix_mode"] = d["extras"]["mix_mode"]
        tol = TWIN_TOL[kind]
        assert_results_match(d, twin_d, rtol=tol["state"],
                             atol=FP32_TOL["atol"])
        for f in ("fvals", "fvals_consensus"):
            if not _allclose(d["trace"][f], twin_d["trace"][f],
                             tol["fvals"]):
                raise AssertionError(
                    f"{kind}: trace.{f} outside rtol={tol['fvals']} of the "
                    f"dense twin (max rel err {errors[f]})")
        if kind == "topk":
            k2_launches = counts[kernel]

    # one rand-k support at the full shape, on the card and on the CPU
    comp = RandK(keep=0.25, seed=0)
    t = torch.tensor(299.0)
    x = torch.randn((256, 4096))
    on_card = comp.support_mask_torch(x.cuda(), t.cuda()).cpu()
    on_cpu = comp.support_mask_torch(x, t)
    if not torch.equal(on_card, on_cpu):
        raise AssertionError("a rand-k mask differs between the card and "
                             "the CPU")
    emit("randk_mask", shape=[256, 4096], t=299, bitwise_equal=True,
         kept_per_row=int(on_cpu.sum(dim=-1)[0]))
    return k2_launches


#: the sweep phase's axis: the comm period h of Fig. 2
SWEEP_AXIS, SWEEP_VALUES = "schedule.params.h", (1, 2, 4, 8, 16)
def _lane_against_serial(lane: dict, serial: dict) -> tuple[int, int]:
    """Hold a batched sweep lane's result to its serial run's under
    convert.assert_results_match at rtol SWEEP_RTOL, atol 0 (host fields
    exactly, the trace's device floats and the residual norms relatively),
    the lane's `vmap_lanes` aside. Returns (bitwise equal trace floats,
    trace floats)."""
    from repro_torch.convert import assert_results_match

    lane = dict(lane, extras={k: v for k, v in lane["extras"].items()
                              if k != "vmap_lanes"})
    assert_results_match(lane, serial, rtol=SWEEP_RTOL, atol=0.0)
    pairs = [(lane["trace"][f], serial["trace"][f])
             for f in ("fvals", "fvals_consensus", "disagreement")]
    return (sum(a == b for ours, theirs in pairs
                for a, b in zip(ours, theirs)),
            sum(len(theirs) for _, theirs in pairs))


def phase_sweep() -> dict:
    """The full-size cell swept over h in SWEEP_VALUES (Fig. 2's axis),
    uncompressed (K1) and under top-k at keep 1/4 (K2): one batched
    program of five lanes (`run_sweep(parallel="vmap")`) with the launch
    counts set to 0 just before and read just after, then the five runs
    serially; each lane held to its serial run. Then two cells across two
    processes on the card, held to serial bit for bit. Returns the
    batched runs' launches by kernel."""
    import numpy as np

    import repro_torch
    from repro_torch.core.schedules import Periodic
    from repro_torch.kernels import gossip_mix

    launched = {}
    serial_results = None
    for compression, kernel in (
            (None, "gossip_mix"),
            ({"kind": "topk", "params": {"keep": 0.25}}, "compress_mix")):
        spec = _dense_cell_spec(compression)
        masks = np.stack([Periodic(h=h).comm_mask(0, spec.T)
                          for h in SWEEP_VALUES])
        # the batch runs its comm body wherever any lane communicates
        expect = int(masks.any(axis=0).sum())
        _zero_launch_counts()
        batched = repro_torch.run_sweep(spec, SWEEP_AXIS, SWEEP_VALUES,
                                        parallel="vmap", device="cuda")
        counts = _launch_counts()
        forms = dict(gossip_mix.FORM_LAUNCHES)
        if counts[kernel] != expect or sum(counts.values()) != expect:
            raise AssertionError(f"the {kernel} sweep launched {counts}, "
                                 f"expected {expect} of {kernel}")
        if kernel == "gossip_mix" and forms != {"regs": 0, "slab": expect}:
            raise AssertionError(f"the sweep's K1 launches took the "
                                 f"kernels {forms}, not the slab kernel")
        for r in batched:
            if r.extras.get("vmap_lanes") != len(SWEEP_VALUES) or \
                    r.metrics.notes != {"loop": "graph"}:
                raise AssertionError(f"a sweep lane ran {r.extras} "
                                     f"{r.metrics.notes}, not as one "
                                     f"captured batch")
        serial = repro_torch.run_sweep(spec, SWEEP_AXIS, SWEEP_VALUES,
                                       device="cuda")
        if any(r.metrics.notes != {"loop": "graph"} for r in serial):
            raise AssertionError("a serial sweep run was not captured")
        equal = entries = 0
        for lane, solo in zip(batched, serial):
            e, n = _lane_against_serial(lane.to_dict(), solo.to_dict())
            equal += e
            entries += n
        batched_wall = sum(r.wall_s for r in batched)
        serial_wall = sum(r.wall_s for r in serial)
        emit("sweep", axis=SWEEP_AXIS, values=list(SWEEP_VALUES),
             compression=compression, kernel=kernel,
             launches=counts[kernel], comm_iterations=expect,
             serial_rounds=[r.trace.comms[-1] for r in serial],
             rtol=SWEEP_RTOL, bitwise_equal_entries=equal,
             float_entries=entries, batched_wall_s=batched_wall,
             batched_compile_s=sum(r.metrics.compile_s for r in batched),
             serial_wall_s=serial_wall,
             serial_compile_s=sum(r.metrics.compile_s for r in serial),
             serial_over_batched=serial_wall / batched_wall,
             final_f=[r.trace.fvals[-1] for r in batched])
        launched[kernel] = counts[kernel]
        if compression is None:
            serial_results = serial

    # two cells across two spawned processes on the card, bit for bit
    procs = repro_torch.run_sweep(_dense_cell_spec(), SWEEP_AXIS,
                                  SWEEP_VALUES[:2], parallel="process",
                                  processes=2, device="cuda")
    for proc, solo in zip(procs, serial_results):
        a, b = proc.to_dict(), solo.to_dict()
        if a["trace"] != b["trace"] or a["spec"] != b["spec"] or \
                a["extras"] != b["extras"] or proc.metrics.notes != {
                    "loop": "graph"}:
            raise AssertionError("a process sweep cell differs from its "
                                 "serial run")
    emit("sweep_process", cells=len(procs), bitwise_equal=True,
         loops=[r.metrics.notes["loop"] for r in procs])
    return launched


#: the stated tradeoff the injected clock charges in the adaptive phase:
#: a comm iteration costs 1/n + k * ADAPTIVE_R_TRUE, a plain one 1/n. At
#: n=256, k=4 on the expander (lambda2 0.967) eq. 21 then asks for h about
#: 3.7 (2.6 under top-k's wire ratio 1/2): the schedule must splice h up
ADAPTIVE_R_TRUE = 10.0
#: the most the closed loop's plain sample (its first timed chunk, one
#: idle iteration) may cost, as a multiple of the p50 of one-iteration
#: idle chunks timed the same way on a loaded program. On an H100
#: (scripts/profile_torch_closed_loop.py, two runs) a first chunk that
#: follows the load's kernels with no replay between costs 1.33 to 2.28
#: times that p50; one after the chunk driver's priming replay 1.07 to 1.46
PLAIN_SAMPLE_CAP = 1.5
#: closed-loop runs whose plain samples' median is held to the cap
PLAIN_SAMPLE_RUNS = 5


def _adaptive_cell_spec(compression=None):
    """The full-size cell under the paper's adaptive schedule, closed loop
    ("dense_adaptive" controller, h0 = 1)."""
    import repro_torch

    d = _dense_cell_spec(compression).to_dict()
    d.update(name="dense_adaptive_full",
             schedule={"kind": "adaptive", "params": {"h0": 1}},
             controller={"kind": "dense_adaptive",
                         "params": {"warmup_comm": 2, "warmup_plain": 1}})
    return repro_torch.ExperimentSpec.from_dict(d)


def _charged_closed_loop(spec, device: str):
    """The closed loop (`runner._dense_adaptive_run`) on `device` under an
    injected clock that charges each chunk eq. 9's cost at
    ADAPTIVE_R_TRUE, through the loop's seam `DDASimulator.run_chunk`.
    Returns (trace, schedule, controller, simulator, clock reading)."""
    import torch

    from repro_torch.adaptive import DenseController
    from repro_torch.experiments import runner

    dev = torch.device(device)
    parts = runner._dense_parts(spec, spec.backends[0], dev)
    sim = runner._dense_sim(spec, parts, dev)
    problem, graph = parts["problem"], parts["graph"]
    n, k = graph.n, graph.degree
    clock = {"t": 0.0}
    real = sim.run_chunk

    def charged(comm, chunk):
        clock["t"] += (1.0 / n + (k * ADAPTIVE_R_TRUE if comm else 0.0)) \
            * chunk
        return real(comm, chunk)

    sim.run_chunk = charged
    params = dict(spec.controller.params)
    if sim.compression is not None:
        params.setdefault("wire_ratio", sim.wire_ratio(problem.d))
    ctrl = DenseController(parts["schedule"], **params)
    x0 = torch.zeros((problem.n, problem.d), device=dev)
    trace = runner._dense_adaptive_run(sim, ctrl, x0, spec.T,
                                       spec.eval_every, spec.seed,
                                       timer=lambda: clock["t"])
    return trace, parts["schedule"], ctrl, sim, clock["t"]


def _spied_run(spec):
    """`repro_torch.run(spec)` on the card, each chunk of its closed loop
    also timed by a spy around the loop's seam. Returns the result and the
    chunks as (comm, iterations, wall in s)."""
    import repro_torch
    from repro_torch.core.dda import DDASimulator

    chunks = []
    run_chunk = DDASimulator.run_chunk

    def spied(self, comm, chunk):
        t0 = time.perf_counter()
        run_chunk(self, comm, chunk)
        chunks.append((comm, chunk, time.perf_counter() - t0))

    DDASimulator.run_chunk = spied
    try:
        result = repro_torch.run(spec, device="cuda")
    finally:
        DDASimulator.run_chunk = run_chunk
    return result, chunks


def _one_iteration_chunks(spec, reps: int = 100) -> dict:
    """The p50 walls (us) of one-iteration chunks of the idle and the comm
    body, alternating, each timed as the closed loop times a chunk, on a
    loaded program of `spec` on the card (its launches not counted)."""
    import torch

    from repro_torch.experiments import runner
    from repro_torch.kernels import counters

    dev = torch.device("cuda")
    parts = runner._dense_parts(spec, spec.backends[0], dev)
    sim = runner._dense_sim(spec, parts, dev)
    problem = parts["problem"]
    before = counters.snapshot()
    sim.start_closed_loop(torch.zeros((problem.n, problem.d), device=dev),
                          spec.T)
    walls = {"idle": [], "comm": []}
    for _ in range(reps):
        for body in walls:
            t0 = time.perf_counter()
            sim.run_chunk(body == "comm", 1)
            walls[body].append((time.perf_counter() - t0) * 1e6)
    sim.end_closed_loop()
    counters.restore(before)
    return {body: statistics.median(us) for body, us in walls.items()}


def phase_adaptive() -> dict:
    """The full-size cell under `dense_adaptive`, uncompressed (K1) and
    under top-k at keep 1/4 (K2): first under the injected clock on the
    card and on the CPU (the same retunes, h_final and r_hat exactly; the
    traces within the default tolerances, top-k within TWIN_TOL), then
    under the real clock on the card through repro_torch.run, with every
    launch count set to 0 just before: the run is captured, and its
    kernel launches once for each communication round the closed loop
    chose. Returns those launches by kernel."""
    import numpy as np

    import repro_torch
    from repro_torch.kernels import gossip_mix

    launched = {}
    for compression, kernel in (
            (None, "gossip_mix"),
            ({"kind": "topk", "params": {"keep": 0.25}}, "compress_mix")):
        spec = _adaptive_cell_spec(compression)
        _zero_launch_counts()
        card, sched, ctrl, sim, charged = _charged_closed_loop(spec, "cuda")
        counts = _launch_counts()
        cpu, cpu_sched, cpu_ctrl, cpu_sim, _ = _charged_closed_loop(spec,
                                                                    "cpu")
        retunes = [dataclasses.astuple(rt) for rt in sched.retunes]
        if retunes != [dataclasses.astuple(rt) for rt in cpu_sched.retunes] \
                or sched.h_current != cpu_sched.h_current \
                or ctrl.tracker.r_hat != cpu_ctrl.tracker.r_hat:
            raise AssertionError(f"{kernel}: the charged closed loop retuned "
                                 f"{retunes} on the card, "
                                 f"{cpu_sched.retunes} on the CPU")
        if not retunes or sched.h_current <= 1:
            raise AssertionError(f"{kernel}: r_true {ADAPTIVE_R_TRUE} must "
                                 f"raise h, got {sched.h_current}")
        if sim.last_loop != "graph":
            raise AssertionError(f"{kernel}: the closed loop ran "
                                 f"{sim.last_loop} on the card")
        rounds = card.comms[-1]
        if counts[kernel] != rounds or sum(counts.values()) != rounds:
            raise AssertionError(f"{kernel}: the charged loop launched "
                                 f"{counts} for {rounds} rounds")
        for f in ("iters", "sim_time", "comms"):
            if getattr(card, f) != getattr(cpu, f):
                raise AssertionError(f"{kernel}: trace.{f} differs card "
                                     f"against CPU")
        tol = (FP32_TOL["rtol"], FP32_TOL["rtol"]) if compression is None \
            else (TWIN_TOL["topk"]["fvals"], TWIN_TOL["topk"]["state"])
        errors = {}
        for f, rtol in (("fvals", tol[0]), ("fvals_consensus", tol[0]),
                        ("disagreement", tol[1])):
            errors[f] = _max_rel_err(getattr(card, f), getattr(cpu, f))
            if not _allclose(getattr(card, f), getattr(cpu, f), rtol):
                raise AssertionError(f"{kernel}: trace.{f} card against CPU "
                                     f"outside rtol={rtol} (max rel err "
                                     f"{errors[f]})")
        if compression is not None:
            errors["residual_norms"] = _max_rel_err(sim.last_res_norms,
                                                    cpu_sim.last_res_norms)
            if not _allclose(sim.last_res_norms, cpu_sim.last_res_norms,
                             tol[1]):
                raise AssertionError(f"{kernel}: residual norms card "
                                     f"against CPU {errors}")
        emit("adaptive_charged", kernel=kernel, compression=compression,
             r_true=ADAPTIVE_R_TRUE, r_hat=ctrl.tracker.r_hat,
             retunes=[(rt.from_t, rt.h) for rt in sched.retunes],
             h_final=sched.h_current, rounds=rounds, launches=counts[kernel],
             charged_clock=charged, card_cpu_max_rel_err=errors,
             rtol={"fvals": tol[0], "state": tol[1]})

        # the real clock, on the card, through the entry point
        _zero_launch_counts()
        result, chunks = _spied_run(spec)
        counts = _launch_counts()
        forms = dict(gossip_mix.FORM_LAUNCHES)
        trace = result.trace
        rounds = trace.comms[-1]
        m = result.metrics
        if m.notes != {"loop": "graph"}:
            raise AssertionError(f"{kernel}: the closed loop ran {m.notes}")
        if counts[kernel] != rounds or sum(counts.values()) != rounds:
            raise AssertionError(f"{kernel}: the closed loop launched "
                                 f"{counts} for {rounds} rounds")
        if kernel == "gossip_mix" and forms != {"regs": 0, "slab": rounds}:
            raise AssertionError(f"the closed loop's K1 launches took the "
                                 f"kernels {forms}, not the slab kernel")
        if len(trace.fvals) != spec.T // spec.eval_every or not all(
                np.isfinite(trace.fvals)):
            raise AssertionError(f"{kernel}: closed loop trace "
                                 f"{trace.fvals}")
        if any(t >= spec.T for t, _ in result.extras["retunes"]):
            raise AssertionError(f"{kernel}: a retune at the frontier T")
        # at h0 = 1 the controller's one plain sample is the first timed
        # chunk (t = 1, one idle iteration): it must cost what such a
        # chunk costs once the program runs, not the run's set-up. One
        # sample is noisy: the median of PLAIN_SAMPLE_RUNS runs' is held
        plains = []
        for i in range(PLAIN_SAMPLE_RUNS):
            if i:
                chunks = _spied_run(spec)[1]
            if chunks[0][:2] != (False, 1):
                raise AssertionError(f"{kernel}: the first chunk was "
                                     f"{chunks[0]}, not one plain "
                                     f"iteration")
            plains.append(chunks[0][2] * 1e6)
        steady = _one_iteration_chunks(spec)
        # the captured run of the same cell communicating at every
        # iteration, the work of the closed loop at h = 1 without its
        # chunks' syncs and controller
        every = _dense_cell_spec(compression).to_dict()
        every.update(name="dense_h1_full",
                     schedule={"kind": "periodic", "params": {"h": 1}})
        captured = repro_torch.run(
            repro_torch.ExperimentSpec.from_dict(every), device="cuda")
        if statistics.median(plains) > PLAIN_SAMPLE_CAP * steady["idle"]:
            raise AssertionError(f"{kernel}: the plain samples took "
                                 f"{plains} us, their median more than "
                                 f"{PLAIN_SAMPLE_CAP} x a one-iteration "
                                 f"idle chunk's {steady['idle']} us")
        # under top-k a comm iteration costs more than twice a plain one,
        # so an uncharged plain sample leaves r_hat above 0 (uncompressed
        # a one-iteration chunk's launch and sync, which a comm chunk of
        # 24 iterations spreads, can outweigh the mix: r_hat may read 0)
        if compression is not None and not result.extras["r_hat"] > 0.0:
            raise AssertionError(f"{kernel}: r_hat {result.extras['r_hat']}"
                                 f" with a plain sample of {plains[0]} us")
        emit("adaptive", kernel=kernel, compression=compression,
             launches=counts[kernel], rounds=rounds, loop=m.notes["loop"],
             r_hat=result.extras["r_hat"],
             plain_samples_us=plains,
             one_iteration_chunk_us=steady,
             captured_h1_us_per_iter=(captured.metrics.execute_s / spec.T
                                      * 1e6),
             chunks=len(chunks),
             retunes=result.extras["retunes"],
             h_final=result.extras["h_final"],
             compile_s=m.compile_s, execute_s=m.execute_s,
             wall_s=result.wall_s,
             us_per_iter=m.execute_s / spec.T * 1e6,
             median_iter_wall_us=m.step_time_quantiles["p50"] * 1e6,
             step_time_quantiles=m.step_time_quantiles,
             final_f=trace.fvals[-1])
        launched[kernel] = counts[kernel]
    return launched


#: the six manifests that declare a netsim backend
NETSIM_MANIFESTS = ("adaptive_adversarial", "churn_adversarial",
                    "complete_every", "compressed_expander",
                    "expander_periodic", "expander_sparse")


def _trace_digest(trace) -> str:
    """sha256 of a netsim trace's JSON (every field, host float64)."""
    return hashlib.sha256(json.dumps(dataclasses.asdict(trace),
                                     sort_keys=True).encode()).hexdigest()


#: a straggler whose scale, 197e12 / (197e12 / 5.35), is 5.3500000000000005
#: and not its factor (tests/test_torch_netsim.py SMALL)
STRAGGLER_SPEC = {
    "name": "netsim_straggler_5_35",
    "problem": {"kind": "quadratic_consensus",
                "params": {"n": 8, "d": 4, "seed": 0}},
    "topology": {"kind": "expander", "params": {"k": 4, "seed": 0}},
    "schedule": {"kind": "periodic", "params": {"h": 2}},
    "backends": [{"kind": "netsim",
                  "params": {"scenario": "straggler", "slow_factor": 5.35,
                             "n_slow": 3}}],
    "T": 80, "eval_every": 10, "seed": 3, "r": 0.05, "eps_frac": 0.2,
}


def phase_netsim() -> None:
    """Every netsim backend of the six manifests that declare one, through
    repro_torch.run on the card's device (the event loops are host numpy):
    finite traces, messages sent, drops where the scenario loses messages,
    retunes under the adaptive controller, a faults block under the churn
    plan; the object and vectorized engines of a manifest give equal traces
    bit for bit. Prints each run's host wall and its trace's sha256 (not
    asserted: the bits against the reference are the CPU tests' to hold).
    Then `STRAGGLER_SPEC` on both engines, each trace and its extras equal
    to the port's CPU run of the spec. Then one quadratic-consensus cell
    with its gradient through `torch_batch_grad` on the card, beside the
    numpy gradient's run."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.experiments import components as C
    from repro_torch.experiments import runner
    from repro_torch.netsim import NetSimulator, torch_batch_grad

    for name in NETSIM_MANIFESTS:
        spec = repro_torch.ExperimentSpec.from_file(
            ROOT / "benchmarks" / "manifests" / f"{name}.json")
        traces = {}
        for i, b in enumerate(spec.backends):
            if b.kind != "netsim":
                continue
            result = repro_torch.run(spec, i, device="cuda")
            ex, trace = result.extras, result.trace
            lossy = b.params.get("loss", 0.0) > 0.0
            if not trace.fvals or not all(np.isfinite(trace.fvals)):
                raise AssertionError(f"{name}: trace {trace.fvals}")
            if ex["sent"] <= 0 or (lossy and ex["drops"] <= 0):
                raise AssertionError(f"{name}: sent {ex['sent']}, drops "
                                     f"{ex['drops']}")
            if spec.controller is not None and not ex["retunes"]:
                raise AssertionError(f"{name}: the controller never retuned")
            if spec.faults is not None and not ex["faults"]["crashes"]:
                raise AssertionError(f"{name}: no faults block {ex}")
            traces[ex["engine"]] = trace
            emit("netsim", manifest=name, backend=i, engine=ex["engine"],
                 scenario=ex["scenario"], host_wall_s=result.wall_s,
                 T=spec.T, sent=ex["sent"], drops=ex["drops"],
                 retunes=ex.get("retunes"), h_final=ex.get("h_final"),
                 faults=ex.get("faults"), final_f=trace.fvals[-1],
                 time_to_target=result.time_to_target,
                 trace_sha256=_trace_digest(trace))
        if len(traces) == 2 and traces["object"] != traces["vectorized"]:
            raise AssertionError(f"{name}: the engines' traces differ")

    for engine in ("object", "vectorized"):
        d = json.loads(json.dumps(STRAGGLER_SPEC))
        d["backends"][0]["params"]["engine"] = engine
        spec = repro_torch.ExperimentSpec.from_dict(d)
        card = repro_torch.run(spec, device="cuda")
        cpu = repro_torch.run(spec, device="cpu")
        if card.trace != cpu.trace or card.extras != cpu.extras:
            raise AssertionError(f"straggler 5.35 ({engine}): the card's run "
                                 f"differs from the CPU's")
        emit("netsim_straggler", slow_factor=5.35, engine=engine,
             host_wall_s=card.wall_s, sim_time_final=card.trace.sim_time[-1],
             final_f=card.trace.fvals[-1],
             trace_sha256=_trace_digest(card.trace))

    # one cell's gradients through torch.func.vmap on the card
    spec = repro_torch.ExperimentSpec.from_file(
        ROOT / "benchmarks" / "manifests" / "expander_periodic.json")
    problem = C.build_component(C.problems, spec.problem.kind,
                                spec.problem.params, device="cuda")
    centers = problem.arrays["centers_j"]
    graph = runner._build_topology(spec, problem.n)
    from repro_torch.netsim.scenarios import DEFAULT_MESSAGE_BYTES
    batch_grad = torch_batch_grad(lambda i, x, t: 2.0 * (x - centers[i]),
                                  device="cuda")
    runs = {}
    for label, batch in (("numpy", None), ("torch_batch_grad", batch_grad)):
        scenario = runner._build_scenario("homogeneous", problem.n, spec.r,
                                          graph, DEFAULT_MESSAGE_BYTES, {})
        sim = NetSimulator(scenario, problem.grad_fn, problem.eval_fn,
                           a_fn=runner._build_stepsize(spec),
                           schedule=runner._build_schedule(spec),
                           seed=spec.seed, engine="vectorized",
                           batch_grad_fn=batch)
        t0 = time.perf_counter()
        runs[label] = sim.run(np.zeros((problem.n, problem.d)), spec.T,
                              eval_every=spec.eval_every)
        runs[label + "_wall_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    a, b = runs["numpy"], runs["torch_batch_grad"]
    if a.iters != b.iters or not all(np.isfinite(b.fvals)):
        raise AssertionError(f"torch_batch_grad run: {b}")
    diff = float(np.max(np.abs(np.subtract(a.fvals, b.fvals))))
    rel = float(np.max(np.abs(np.subtract(a.fvals, b.fvals))
                       / np.abs(a.fvals)))
    # float32 gradients against float64 ones: the traces stay close
    if rel > 1e-4:
        raise AssertionError(f"torch_batch_grad run drifted: rel {rel}")
    emit("netsim_batch_grad", manifest="expander_periodic",
         engine="vectorized", device="cuda", max_abs_fvals_diff=diff,
         max_rel_fvals_diff=rel, numpy_wall_s=runs["numpy_wall_s"],
         torch_batch_grad_wall_s=runs["torch_batch_grad_wall_s"])


#: the packed lane of the serve phase: (h, r, seed) for each request
SERVE_LANE = ((2, 0.01, 0), (4, 0.02, 1), (8, 0.04, 2))


def _served(counts: dict, call):
    """`call()` with every launch count set to 0 just before and read just
    after, added into `counts` by kernel. Returns what it returned."""
    _zero_launch_counts()
    out = call()
    for kernel, n in _launch_counts().items():
        counts[kernel] = counts.get(kernel, 0) + n
    return out


def _exact(label: str, served, solo) -> None:
    from repro_torch.serve import comparable_result_dict

    if comparable_result_dict(served) != comparable_result_dict(solo):
        raise AssertionError(f"serve: {label} differs from its solo run")


def phase_serve() -> dict:
    """The full-size cell served through `repro_torch.serve`: in process
    (two threads), through two spawned worker processes one of which a
    ChaosPlan kills mid-run, and over TCP. Every served result must equal
    a solo `repro_torch.run` of its spec exactly (`comparable_result_dict`).
    Returns the in-process runs' launches by kernel, each request's counts
    set to 0 just before it and read just after."""
    import numpy as np

    import repro_torch
    from repro_torch.core.dda import _LaneProgram
    from repro_torch.core.schedules import Periodic
    from repro_torch.serve import ChaosPlan, Client, ExperimentServer

    cell = _dense_cell_spec()
    lane = [cell.with_value("schedule.params.h", h).with_value(
        "r", r).with_value("seed", seed).with_value("name", f"lane_h{h}")
        for h, r, seed in SERVE_LANE]
    topk = _dense_cell_spec({"kind": "topk", "params": {"keep": 0.25}}
                            ).with_value("name", "dense_full_topk")
    other = cell.with_value("T", 250).with_value("name", "dense_T250")
    net = repro_torch.ExperimentSpec.from_file(
        ROOT / "benchmarks" / "manifests" / "expander_periodic.json")
    pool_specs = [cell.with_value("seed", seed).with_value(
        "name", f"pool_s{seed}") for seed in range(3)]
    solo = {s.name: repro_torch.run(s, device="cuda")
            for s in [cell, *lane, topk, other, *pool_specs]}
    solo["net"] = repro_torch.run(net, "netsim", device="cuda")

    captures = []
    real_capture = _LaneProgram.capture

    def counted_capture(self):
        captures.append(self.B)
        return real_capture(self)

    counts: dict = {}
    _LaneProgram.capture = counted_capture
    try:
        with ExperimentServer(workers=2, max_width=len(SERVE_LANE),
                              max_wait_s=0.2) as srv:
            cold = _served(counts, lambda: srv.submit(cell).result(600))
            n_captured = len(captures)
            warm = _served(counts, lambda: srv.submit(cell).result(600))
            new_captures = len(captures) - n_captured
            if new_captures or \
                    warm.metrics.counters.get("cache_hit") != 1.0 or \
                    warm.metrics.compile_s >= 1e-3:
                raise AssertionError(
                    f"serve: the warm run captured {new_captures} "
                    f"programs, counters {warm.metrics.counters}, "
                    f"compile_s {warm.metrics.compile_s}")
            _exact("the cold run", cold, solo[cell.name])
            _exact("the warm run", warm, solo[cell.name])

            before = dict(counts)
            packed = _served(counts, lambda: [
                f.result(600) for f in [srv.submit(s) for s in lane]])
            masks = np.stack([Periodic(h=h).comm_mask(0, cell.T)
                              for h, _, _ in SERVE_LANE])
            lane_k1 = counts["gossip_mix"] - before.get("gossip_mix", 0)
            if lane_k1 != int(masks.any(axis=0).sum()):
                raise AssertionError(f"serve: the packed lane launched K1 "
                                     f"{lane_k1} times, not once for each "
                                     f"of its {int(masks.any(axis=0).sum())}"
                                     f" communicating iterations")
            for spec, result in zip(lane, packed):
                if result.extras.get("lane_width") != len(SERVE_LANE):
                    raise AssertionError(f"serve: {spec.name} ran at "
                                         f"{result.extras}, not packed")
                _exact(f"packed lane {spec.name}", result, solo[spec.name])

            served_topk = _served(counts,
                                  lambda: srv.submit(topk).result(600))
            _exact("the top-k run", served_topk, solo[topk.name])
            served_net = _served(counts, lambda: srv.submit(
                net, backend="netsim").result(600))
            _exact("the netsim run", served_net, solo["net"])
            if "not dense" not in served_net.metrics.notes["solo_reason"]:
                raise AssertionError(f"serve: netsim solo_reason "
                                     f"{served_net.metrics.notes}")

            # one thread captures a new signature while the other replays
            # the warm cell
            n_captured = len(captures)
            side = _served(counts, lambda: [
                f.result(600) for f in [srv.submit(other),
                                        srv.submit(cell)]])
            if len(captures) != n_captured + 1:
                raise AssertionError(f"serve: side by side captured "
                                     f"{len(captures) - n_captured} "
                                     f"programs, not 1")
            _exact("the new signature beside a replay", side[0],
                   solo[other.name])
            _exact("the replay beside a capture", side[1], solo[cell.name])

            host, port = srv.start()
            with Client(host, port, timeout=600.0) as client:
                over_tcp = _served(counts, lambda: client.run(cell))
            if over_tcp.to_dict()["trace"] != \
                    solo[cell.name].to_dict()["trace"]:
                raise AssertionError("serve: the TCP result's trace "
                                     "differs from the solo run's")
            _exact("the TCP run", over_tcp, solo[cell.name])
            stats = srv.stats()
    finally:
        _LaneProgram.capture = real_capture

    k1_runs = [cold, warm, side[0], side[1], over_tcp]
    expect = {"gossip_mix": sum(r.trace.comms[-1] for r in k1_runs)
              + int(masks.any(axis=0).sum()),
              "compress_mix": served_topk.trace.comms[-1]}
    if {k: n for k, n in counts.items() if n} != expect:
        raise AssertionError(f"serve: the in-process runs launched {counts}"
                             f", expected {expect}")
    emit("serve", kernels_launched=expect, captures=len(captures),
         cold_wall_s=cold.wall_s, cold_compile_s=cold.metrics.compile_s,
         warm_wall_s=warm.wall_s, warm_compile_s=warm.metrics.compile_s,
         warm_us_per_iter=warm.metrics.execute_s / cell.T * 1e6,
         packed_lane_width=len(SERVE_LANE),
         packed_wall_s=sum(r.wall_s for r in packed),
         packed_compile_s=sum(r.metrics.compile_s for r in packed),
         solo_walls_s=sum(solo[s.name].wall_s for s in lane),
         solo_compile_s=sum(solo[s.name].metrics.compile_s for s in lane),
         topk_wall_s=served_topk.wall_s, netsim_wall_s=served_net.wall_s,
         side_by_side_wall_s=[r.wall_s for r in side],
         tcp_wall_s=over_tcp.wall_s, cache=stats["cache"],
         packer=stats["packer"])

    # two worker processes, the first job's worker killed mid-run
    plan = ChaosPlan(seed=7, kill_at_dispatch=(1,), kill_delay_s=(0.05, 0.2))
    jobs = {"first": [], "warm": []}
    with ExperimentServer(processes=2, packing=False, chaos=plan,
                          pool_kwargs={"backoff_base_s": 0.05}) as pool:
        for phase in ("first", "warm"):
            for spec in pool_specs:
                t0 = time.perf_counter()
                result = pool.submit(
                    spec, idempotency_key=f"{phase}-{spec.name}").result(600)
                c = result.metrics.counters
                # round trip; waiting for a ready worker (its spawn); the
                # run's own wall and its capture, in the worker
                jobs[phase].append({
                    "round_trip_s": time.perf_counter() - t0,
                    "queue_wait_s": c["queue_wait_s"],
                    "cache_hit": c.get("cache_hit", 0.0) == 1.0,
                    "wall_s": result.wall_s,
                    "compile_s": result.metrics.compile_s,
                    "reenqueues": c.get("reenqueues", 0.0)})
                _exact(f"the pooled {phase} run {spec.name}", result,
                       solo[spec.name])
        stats = pool.stats()
    if stats["dedup"]["max_executions_per_key"] > 1 or \
            stats["robustness"]["reenqueues"] < 1 or \
            stats["robustness"]["worker_restarts"] < 1 or \
            stats["chaos"]["kills_delivered"] < 1:
        raise AssertionError(f"serve: the pool's chaos run {stats}")
    emit("serve_pool", processes=2, first_jobs=jobs["first"],
         warm_jobs=jobs["warm"],
         reenqueues=stats["robustness"]["reenqueues"],
         worker_restarts=stats["robustness"]["worker_restarts"],
         kills_delivered=stats["chaos"]["kills_delivered"],
         max_executions_per_key=stats["dedup"]["max_executions_per_key"])
    return counts


def _hold(label: str, out, expect, tol: dict) -> float:
    """A front door's `out` against its plain version's `expect` on the same
    inputs: the same dtype and shape, finite, within `tol`. Returns the
    largest absolute difference."""
    import torch

    torch.cuda.synchronize()
    if out.dtype != expect.dtype or out.shape != expect.shape:
        raise AssertionError(f"{label}: returned {out.dtype} "
                             f"{tuple(out.shape)}, the plain version "
                             f"{expect.dtype} {tuple(expect.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: non-finite values")
    torch.testing.assert_close(out.float(), expect.float(), **tol,
                               msg=lambda m: f"{label} disagrees: {m}")
    return _max_err(out, expect)


def _check_grid(name: str, label: str, cases, door, plain, tols: dict
                ) -> None:
    """`door` against `plain` on each of `cases`, (where, args, tolerance
    key) triples, held to `tols[key]`; emits the largest error by key."""
    worst = {}
    checked = 0
    for where, args, key in cases:
        err = _hold(f"{label} at {where}", door(*args), plain(*args),
                    tols[key])
        worst[key] = max(worst.get(key, 0.0), err)
        checked += 1
    emit("kernel_check", name=name, cases=checked, max_abs_err=worst,
         tol=tols)


def _full_width(name: str, label: str, door, plain, args, tol: dict):
    """One front-door call at full width, with the launch counts read around
    it, held to `tol` against the plain version. Returns the launches and
    the largest error."""
    out, launches = _front_door_once(name, lambda: door(*args))
    err = _hold(f"{label} at full width", out, plain(*args), tol)
    del out
    return launches, err


def _report(name: str, source: str, replaces: str, launches: int,
            err: float, kernel_t: dict, plain_t: dict, library_t, nbytes,
            flops, peak: float = FP32_FLOPS, entry: dict | None = None,
            **emitted) -> dict:
    """The kernel's entry of the `kernels` line (with `entry` added to it),
    emitted with its eager times and `emitted` as a `kernel_time` line."""
    numbers = dict(name=name, route="cuda",
                   source=f"src/repro_torch/kernels/csrc/{source}",
                   replaces=replaces, launches=launches, max_abs_err=err,
                   ms=kernel_t["device"], plain_ms=plain_t["device"],
                   **_bound(nbytes, flops, peak),
                   library_ms=library_t and library_t["device"],
                   **(entry or {}))
    emit("kernel_time", bytes=nbytes, flops=flops,
         kernel_ms=kernel_t["device"], eager_ms=kernel_t["eager"],
         plain_eager_ms=plain_t["eager"],
         library_eager_ms=library_t and library_t["eager"], **emitted,
         **numbers)
    return numbers


def _randn(gen, shape, dtype=None, scale: float = 1.0):
    import torch

    x = torch.randn(shape, generator=gen, device="cuda") * scale
    return x if dtype is None else x.to(dtype)


#: the full-width LM cell's depth: llama3-8b's 32 superblocks cut to 4 so
#: that two pods' parameters, gradients and AdamW moments fit the card
LM_N_SUPER = 4
#: the peak the full-width LM cell may allocate before its depth is cut to
#: 2 (PERF.md states the cut if it happens)
LM_PEAK_CAP_GIB = 72
#: the relative error a smoke-width LM run's losses may show on the card
#: against the CPU (bf16 matmuls accumulate in another order on each)
LM_TRACE_RTOL = 1e-3
#: leaves of a llama3 ("attn") parameter tree, each mixed by one K1 launch
LM_LEAVES = 12
#: the streamed attention against the whole score-matrix form at the cell's
#: bf16 shapes, relative to the largest magnitude of each of the output and
#: the three gradients: about two bf16 roundings of a softmax weight
#: (observed below; a dropped rescale or a mask one key off is 0.08-1.1)
ATTN_STREAM_RTOL = 1.2e-2


def _lm_spec(name: str, variant: str, mesh, topology: dict, T: int,
             batch_per_node: int, seq_len: int, arch: str = "llama3-8b"):
    import repro_torch

    return repro_torch.ExperimentSpec(
        name=name, T=T, eval_every=1, r=0.05, seed=0,
        problem={"kind": "lm", "params": {
            "arch": arch, "variant": variant,
            "batch_per_node": batch_per_node, "seq_len": seq_len}},
        topology=topology,
        schedule={"kind": "periodic", "params": {"h": 2}},
        backends=[{"kind": "launch", "params": {"mesh": list(mesh)}}])


def _lm_host_fields(result, n: int, k: int, r: float) -> None:
    """The closed form of a launch run's host fields (eq. 9/19)."""
    import math

    from repro_torch.core.schedules import Periodic

    d = result.to_dict()
    T = d["spec"]["T"]
    sched = Periodic(h=2)
    comm = [sched.is_comm_step(t) for t in range(1, T + 1)]
    rounds = sum(comm)
    want = {
        "iters": list(range(1, T + 1)),
        "comms": [sched.H(t) for t in range(1, T + 1)],
        "sim_time": [t * (1.0 / n) + sched.H(t) * k * r
                     for t in range(1, T + 1)],
    }
    for key, value in want.items():
        if d["trace"][key] != value:
            raise AssertionError(f"lm trace.{key} {d['trace'][key]} is not "
                                 f"the closed form {value}")
    ex, m = d["extras"], d["metrics"]
    units = sum(1.0 / n + (k * r if c else 0.0) for c in comm)
    if (ex["comm_rounds"], ex["step_comm"]) != (rounds, comm) or \
            not math.isclose(ex["sim_time_units"], units, rel_tol=1e-12):
        raise AssertionError(f"lm extras {ex} against {rounds} rounds, "
                             f"{comm}, {units} units")
    msgs = rounds * n * k
    if (m["msgs"], m["gossip_rounds"], m["bytes_on_wire"]) != (
            msgs, rounds, float(msgs * ex["param_bytes"])):
        raise AssertionError(f"lm metrics {m} against {msgs} messages")
    if not all(math.isfinite(v) for v in d["trace"]["fvals"]):
        raise AssertionError(f"lm losses not finite: {d['trace']['fvals']}")


def _lm_k1_call(M: int = 128256 * 4096, seed: int = 20,
                plain_graph: bool = True) -> dict:
    """K1 at an LM call: one leaf of two full-width pods (bf16, n = 2,
    k = 1, M columns; by default llama3-8b's embed leaf, 128256 x 4096),
    against its plain version bit for bit, timed beside it and
    torch.matmul with the 2 x 2 mixing matrix. `plain_graph=False` times
    the plain version eagerly (CUDA events around single calls): its
    float32 temporaries at deepseek-v2's expert leaf are about 50 GB a
    call, too many for a graph's pool beside the eager windows' cache."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.empty((2, M), dtype=torch.bfloat16, device="cuda")
    for i in range(2):
        z[i] = torch.randn((M,), generator=gen, device="cuda")
    S_in = torch.tensor([[1], [0]], dtype=torch.int64, device="cuda")
    out = ops.gossip_gather_mix_impl(z, S_in, 0.5, 0.5)
    expect = ref.gossip_gather_mix_ref(z, S_in, 0.5, 0.5)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int16), expect.view(torch.int16)):
        raise AssertionError("K1 at the LM call differs from its plain "
                             "version")
    err = _max_err(out, expect)
    del out, expect
    torch.cuda.empty_cache()
    P = torch.full((2, 2), 0.5, dtype=torch.bfloat16, device="cuda")
    kernel_t = time_ms(lambda: ops.gossip_gather_mix_impl(z, S_in, 0.5, 0.5),
                       reps=7, inner=3)
    def plain():
        return ref.gossip_gather_mix_ref(z, S_in, 0.5, 0.5)
    plain_t = (time_ms(plain, reps=5, inner=2) if plain_graph else
               time_ms(plain, reps=5, inner=1, graph=False, warmup=1))
    torch.cuda.empty_cache()
    library_t = time_ms(lambda: torch.matmul(P, z), reps=7, inner=3)
    nbytes = 2 * z.numel() * z.element_size()  # z read once, out written
    del z
    torch.cuda.empty_cache()
    return {"ms": kernel_t["device"], "eager_ms": kernel_t["eager"],
            "plain_ms": plain_t["device"], "library_ms": library_t["device"],
            "max_abs_err": err, "bytes": nbytes, **_bound(nbytes, 0.0)}


def _lm_attention_check() -> dict:
    """`_sdpa_causal` at the full-width cell's shapes (B=1, S=4096, H=32,
    KH=8, D=128, bf16), where it takes the streamed form (online softmax
    over 1024-key chunks), against the whole score-matrix form on the same
    inputs: the output and the gradients of q, k and v, each within
    `ATTN_STREAM_RTOL` of the whole form's largest magnitude."""
    import torch

    from repro_torch.models import attention

    gen = torch.Generator(device="cuda").manual_seed(11)
    q = _randn(gen, (1, 4096, 32, 128), torch.bfloat16).requires_grad_()
    k = _randn(gen, (1, 4096, 8, 128), torch.bfloat16).requires_grad_()
    v = _randn(gen, (1, 4096, 8, 128), torch.bfloat16).requires_grad_()
    g = _randn(gen, (1, 4096, 32, 128), torch.bfloat16)
    if not 4096 > attention._KV_CHUNK:
        raise AssertionError("the cell's attention is not streamed")
    errs = {}
    for form in (attention._sdpa_causal, attention._sdpa_causal_whole):
        out = form(q, k, v)
        errs[form.__name__] = [out.detach()] + list(
            torch.autograd.grad(out, (q, k, v), g))
        del out
    got = errs.pop("_sdpa_causal")
    want = errs.pop("_sdpa_causal_whole")
    rel = {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        rel[name] = float((a.float() - b.float()).abs().max()
                          / b.float().abs().max())
    del q, k, v, g, got, want
    torch.cuda.empty_cache()
    if not max(rel.values()) <= ATTN_STREAM_RTOL:
        raise AssertionError(f"the streamed attention is {rel} off the whole "
                             f"score-matrix form (rtol {ATTN_STREAM_RTOL})")
    return {"rel_err": rel, "rtol": ATTN_STREAM_RTOL}


def _lm_isolated_ms() -> dict:
    """Attention and the loss at the full-width cell's shapes, each timed
    alone (CUDA events, eager): `_sdpa_causal` forward, and forward with
    backward, at one layer's (B=1, S=4096, H=32, KH=8, D=128, bf16); the
    loss forward with backward at the logits' (1, 4096, 128256) bf16. A
    step runs attention's forward twice a layer (the checkpoint's
    recompute) and its backward once, for each pod and layer."""
    import torch

    from repro_torch.models import attention, common

    gen = torch.Generator(device="cuda").manual_seed(7)
    q = _randn(gen, (1, 4096, 32, 128), torch.bfloat16).requires_grad_()
    k = _randn(gen, (1, 4096, 8, 128), torch.bfloat16).requires_grad_()
    v = _randn(gen, (1, 4096, 8, 128), torch.bfloat16).requires_grad_()
    g = _randn(gen, (1, 4096, 32, 128), torch.bfloat16)

    def attn_fwd():
        with torch.no_grad():
            attention._sdpa_causal(q, k, v)

    def attn_fwd_bwd():
        torch.autograd.grad(attention._sdpa_causal(q, k, v), (q, k, v), g)

    fwd = time_ms(attn_fwd, reps=5, inner=2, graph=False)["device"]
    fwd_bwd = time_ms(attn_fwd_bwd, reps=5, inner=2, graph=False)["device"]
    del q, k, v, g
    logits = _randn(gen, (1, 4096, 128256), torch.bfloat16).requires_grad_()
    labels = torch.randint(0, 128256, (1, 4096), generator=gen,
                           device="cuda")
    loss = time_ms(lambda: torch.autograd.grad(
        common.cross_entropy_loss(logits, labels), logits),
        reps=5, inner=2, graph=False)["device"]
    del logits
    torch.cuda.empty_cache()
    return {"attention_fwd_ms": fwd, "attention_fwd_bwd_ms": fwd_bwd,
            "attention_step_ms": 2 * LM_N_SUPER * (fwd + fwd_bwd),
            "loss_fwd_bwd_ms": loss, "loss_step_ms": 2 * loss}


def phase_lm() -> dict:
    """The launch backend on the card: llama3-8b at full width, two pods
    stacked, through repro_torch.run (every launch count set to 0 just
    before and read just after); K1 at its LM call; a smoke-width run on
    the card against the CPU; the dry-run manifest. Returns K1's launches
    in the full-width run and its numbers at the LM call."""
    import dataclasses
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import repro_torch
    from repro_torch.convert import assert_results_match
    from repro_torch.kernels import gossip_mix
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry
    import repro_torch.optim as optim_mod

    torch.cuda.empty_cache()
    k1_call = _lm_k1_call()
    emit("lm_k1_call", **k1_call)
    emit("lm_attention", **_lm_attention_check())

    full = dataclasses.replace(registry.get_config("llama3-8b", "full"),
                               n_super=LM_N_SUPER)
    real_get_config = registry.get_config
    real_steps = train_mod.make_consensus_steps
    real_adamw = optim_mod.adamw
    seen = {"mixes": 0, "profile": None}

    def cut_config(arch, variant="full"):
        if (arch, variant) == ("llama3-8b", "full"):
            return full
        return real_get_config(arch, variant)

    adamw_events = []

    def labelled_adamw(*a, **kw):
        opt = real_adamw(*a, **kw)

        def update_(grads, state, params):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with record_function("lm:adamw"):
                out = opt.update_(grads, state, params)
            end.record()
            adamw_events.append((start, end))
            return out
        return dataclasses.replace(opt, update_=update_)

    def watched_steps(*a, **kw):
        local, mix, fused = real_steps(*a, **kw)

        def kept_local(params, opt_state, batch):
            out = local(params, opt_state, batch)
            seen["params"] = out[0]
            return out

        def checked_fused(params, opt_state, batch):
            seen["mixes"] += 1
            if seen["mixes"] == 2:  # the second comm step, profiled
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             record_shapes=True) as prof:
                    out = fused(params, opt_state, batch)
                    torch.cuda.synchronize()
                seen["profile"] = _lm_profile_split(prof, "adamw")
            else:
                out = fused(params, opt_state, batch)
            for leaf in torch.utils._pytree.tree_leaves(out[0]):
                if not torch.equal(leaf[0], leaf[1]):
                    raise AssertionError("the two pods differ after the "
                                         "mix (complete graph, n = 2)")
            seen["params"] = out[0]
            return out
        return kept_local, mix, checked_fused

    spec = _lm_spec("lm_full", "full", (2, 1, 1),
                    {"kind": "complete", "params": {}}, T=6,
                    batch_per_node=1, seq_len=4096)
    registry.get_config = cut_config
    train_mod.make_consensus_steps = watched_steps
    optim_mod.adamw = labelled_adamw
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()
        result = repro_torch.run(spec, device="cuda")
        torch.cuda.synchronize()
        counts = _launch_counts()
        forms = dict(gossip_mix.FORM_LAUNCHES)
    finally:
        registry.get_config = real_get_config
        train_mod.make_consensus_steps = real_steps
        optim_mod.adamw = real_adamw
    peak = torch.cuda.max_memory_allocated()
    pod_digests = [_pod_digest(seen["params"], i) for i in range(2)]
    seen["params"] = None
    torch.cuda.empty_cache()
    rounds = result.extras["comm_rounds"]
    if counts["gossip_mix"] != LM_LEAVES * rounds or rounds != 2 or \
            sum(counts.values()) != counts["gossip_mix"]:
        raise AssertionError(f"the full-width LM run launched {counts} for "
                             f"{rounds} comm steps of {LM_LEAVES} leaves")
    if seen["mixes"] != rounds:
        raise AssertionError(f"{seen['mixes']} fused steps for {rounds} "
                             f"rounds")
    _lm_host_fields(result, n=2, k=1, r=0.05)
    if result.extras["param_bytes"] != 3846324224.0:
        raise AssertionError(f"param_bytes {result.extras['param_bytes']}")
    if peak > LM_PEAK_CAP_GIB * 2 ** 30:
        raise AssertionError(f"peak {peak} bytes above {LM_PEAK_CAP_GIB} "
                             f"GiB at n_super={LM_N_SUPER}")
    walls = result.extras["step_walls"]
    comm = result.extras["step_comm"]
    # AdamW's device time a step (two pods, one update each), by events
    adamw_ms = [sum(s.elapsed_time(e) for s, e in adamw_events[i:i + 2])
                for i in range(0, len(adamw_events), 2)]
    isolated = _lm_isolated_ms()
    # K1 over a comm step's leaves: each pod's parameters read once and
    # written once, from the run's own parameter bytes
    step_bytes = 2 * 2 * result.extras["param_bytes"]
    emit("lm_full", n_super=LM_N_SUPER, seq_len=4096, n_pods=2,
         losses=result.trace.fvals, k1_launches=counts["gossip_mix"],
         k1_forms_launched=forms, param_bytes=result.extras["param_bytes"],
         k1_comm_step_bound_ms=_bound(step_bytes, 0.0)["bound_ms"],
         peak_allocated_gib=peak / 2 ** 30, wall_s=result.wall_s,
         step_walls_s=walls, step_comm=comm,
         local_step_s=[w for w, c in zip(walls[1:], comm[1:]) if not c],
         fused_step_s_unprofiled=walls[2],
         fused_step_profiled_split_ms=seen["profile"],
         adamw_step_ms=adamw_ms, isolated_ms=isolated,
         pod_param_sha256=pod_digests)

    # card against CPU at the smoke width: mesh (4, 1, 1), expander k = 2
    small = _lm_spec("lm_smoke", "smoke", (4, 1, 1),
                     {"kind": "expander", "params": {"k": 2, "seed": 0}},
                     T=6, batch_per_node=2, seq_len=64)
    _zero_launch_counts()
    card = repro_torch.run(small, device="cuda")
    torch.cuda.synchronize()
    small_k1 = _launch_counts()["gossip_mix"]
    cpu = repro_torch.run(small, device="cpu")
    ours, theirs = card.to_dict(), cpu.to_dict()
    rel = max(abs(a - b) / abs(b) for a, b in zip(ours["trace"]["fvals"],
                                                  theirs["trace"]["fvals"]))
    if not rel <= LM_TRACE_RTOL:
        raise AssertionError(f"the smoke LM run's losses on the card are "
                             f"{rel} off the CPU's (rtol {LM_TRACE_RTOL})")
    for side in (ours, theirs):
        side["trace"]["fvals"] = theirs["trace"]["fvals"]
        side["trace"]["fvals_consensus"] = theirs["trace"]["fvals_consensus"]
    assert_results_match(ours, theirs)
    _lm_host_fields(card, n=4, k=2, r=0.05)
    if not card.trace.fvals[-1] < card.trace.fvals[0]:
        raise AssertionError(f"the smoke LM run's loss did not decrease: "
                             f"{card.trace.fvals}")
    if small_k1 != LM_LEAVES * card.extras["comm_rounds"]:
        raise AssertionError(f"the smoke LM run launched K1 {small_k1} "
                             f"times")

    dry = repro_torch.ExperimentSpec.from_file(
        ROOT / "benchmarks" / "manifests" / "launch_dryrun.json")
    dry_card = repro_torch.run(dry, device="cuda").to_dict()
    assert_results_match(dry_card, repro_torch.run(dry, device="cpu")
                         .to_dict())
    emit("lm_smoke", card_cpu_max_rel=rel, rtol=LM_TRACE_RTOL,
         losses=card.trace.fvals, k1_launches=small_k1,
         dryrun_extras=dry_card["extras"])
    if not all(math.isfinite(v) for v in card.trace.fvals):
        raise AssertionError("smoke LM losses not finite")
    return {"launches": counts["gossip_mix"], "call": k1_call,
            "losses": list(result.trace.fvals), "digests": pod_digests,
            "step_comm": comm}


def _pod_digest(params, pod: int) -> str:
    """sha256 of pod `pod`'s slice of every leaf of a pod-stacked tree, in
    leaf order, as raw bytes."""
    import torch

    h = hashlib.sha256()
    for leaf in torch.utils._pytree.tree_leaves(params):
        h.update(leaf[pod].detach().reshape(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


#: the ranks of the lm_ranks phase, one pod each, and the seconds the
#: phase waits for them
LM_RANKS = 2
LM_RANKS_TIMEOUT_S = 420


def _lm_rank_main(rank: int, backend: str, store_path: str, results) -> None:
    """A spawned rank of lm_ranks: its card, the process group, then
    `_lm_rank_run`; the result (or the traceback) goes to the parent."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(rank if backend == "nccl" else 0)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, LM_RANKS), rank=rank,
            world_size=LM_RANKS, timeout=datetime.timedelta(seconds=300))
        try:
            results.put((rank, None, _lm_rank_run(rank)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- sent to the parent, which fails
        results.put((rank, traceback.format_exc(), None))


def _lm_rank_run(rank: int) -> dict:
    """phase_lm's full-width spec through repro_torch.run with this rank's
    pod: losses, the pod's final parameters' sha256, step walls, the
    fused step's collective seconds and bytes, peak memory."""
    import torch
    import torch.utils._pytree as pytree

    import repro_torch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry

    full = dataclasses.replace(registry.get_config("llama3-8b", "full"),
                               n_super=LM_N_SUPER)
    real_get_config = registry.get_config
    real_steps = train_mod.make_consensus_steps
    real_mix = steps_mod._rank_mix
    seen = {"params": None, "mix_s": [], "mix_bytes": []}

    def cut_config(arch, variant="full"):
        if (arch, variant) == ("llama3-8b", "full"):
            return full
        return real_get_config(arch, variant)

    def timed_mix(tree, graph, mesh, float32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_mix(tree, graph, mesh, float32)
        torch.cuda.synchronize()
        seen["mix_s"].append(time.perf_counter() - t0)
        seen["mix_bytes"].append(sum(
            leaf[0].numel() * (4 if float32 else leaf.element_size())
            for leaf in pytree.tree_leaves(tree)))
        return out

    def watched_steps(*a, **kw):
        local, mix, fused = real_steps(*a, **kw)

        def keep(step):
            def run(*args):
                out = step(*args)
                seen["params"] = out[0]
                return out
            return run
        return keep(local), mix, keep(fused)

    spec = _lm_spec("lm_full", "full", (LM_RANKS, 1, 1),
                    {"kind": "complete", "params": {}}, T=6,
                    batch_per_node=1, seq_len=4096)
    registry.get_config = cut_config
    train_mod.make_consensus_steps = watched_steps
    steps_mod._rank_mix = timed_mix
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()
        result = repro_torch.run(spec)
        torch.cuda.synchronize()
        counts = _launch_counts()
    finally:
        registry.get_config = real_get_config
        train_mod.make_consensus_steps = real_steps
        steps_mod._rank_mix = real_mix
    _lm_host_fields(result, n=LM_RANKS, k=1, r=0.05)
    if any(counts.values()):
        raise AssertionError(f"rank {rank} launched {counts}: a pod a rank "
                             f"mixes by collectives, not K1")
    walls, comm = result.extras["step_walls"], result.extras["step_comm"]
    return {"device": str(torch.cuda.current_device()),
            "losses": list(result.trace.fvals),
            "pod_param_sha256": _pod_digest(seen["params"], 0),
            "param_bytes": result.extras["param_bytes"],
            "step_comm": comm, "step_walls_s": walls,
            "local_step_s": [w for w, c in zip(walls, comm) if not c],
            "fused_step_s": [w for w, c in zip(walls, comm) if c],
            "collective_s": seen["mix_s"],
            "collective_f32_bytes": seen["mix_bytes"],
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_lm_ranks(stacked: dict) -> None:
    """The lm phase's full-width spec with one pod a rank, held to the
    stacked run (`stacked`: phase_lm's losses and pod digests) bit for
    bit."""
    import multiprocessing as mp
    import queue
    import shutil
    import tempfile

    import torch

    cards = torch.cuda.device_count()
    if cards >= LM_RANKS:
        backend = "nccl"
        reason = f"{cards} cards: one rank a card over NCCL"
    else:
        backend = "gloo"
        reason = (f"{cards} card: NCCL refuses two ranks on one device, so "
                  f"both ranks share cuda:0 over a gloo group (gloo takes "
                  f"CUDA tensors in all-reduce and broadcast)")
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="lm_ranks_")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_lm_rank_main, daemon=True,
                         args=(r, backend, f"{tmp}/store", results))
             for r in range(LM_RANKS)]
    t0 = time.perf_counter()
    ranks: dict[int, dict] = {}
    try:
        for p in procs:
            p.start()
        while len(ranks) < LM_RANKS:
            try:
                rank, err, value = results.get(timeout=LM_RANKS_TIMEOUT_S)
            except queue.Empty:
                raise AssertionError(f"lm_ranks: no result from ranks "
                                     f"{sorted(set(range(LM_RANKS)) - set(ranks))} "
                                     f"in {LM_RANKS_TIMEOUT_S} s") from None
            if err is not None:
                raise AssertionError(f"lm_ranks: rank {rank} failed:\n{err}")
            ranks[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    for r, out in sorted(ranks.items()):
        if out["losses"] != stacked["losses"]:
            raise AssertionError(f"lm_ranks: rank {r}'s losses "
                                 f"{out['losses']} are not the stacked "
                                 f"run's {stacked['losses']}")
        if out["pod_param_sha256"] != stacked["digests"][r]:
            raise AssertionError(f"lm_ranks: rank {r}'s final parameters "
                                 f"differ from the stacked run's pod {r}")
        if out["step_comm"] != stacked["step_comm"]:
            raise AssertionError(f"lm_ranks: rank {r}'s comm steps "
                                 f"{out['step_comm']}")
    emit("lm_ranks", backend=backend, reason=reason, ranks=LM_RANKS,
         n_super=LM_N_SUPER, seq_len=4096, phase_wall_s=wall,
         losses_equal_stacked=True, params_equal_stacked=True,
         per_rank={r: {k: v for k, v in out.items() if k != "losses"}
                   for r, out in sorted(ranks.items())},
         nvidia_smi=nvidia_smi_line())


#: the lm_sharded phase's layouts with two or more ranks: FSDP over data,
#: then tensor and sequence parallelism over model, the pods stacked on
#: every rank (a group of data x model ranks); with one rank, the one-card
#: mesh (2, 1, 1) through the same DTensor path, every placement
#: Replicate
LM_SHARDED_LAYOUTS = ((2, 2, 1), (2, 1, 2))
LM_SHARDED_ONE_CARD = ((2, 1, 1),)
#: the phase's batch and sequence a pod, and the seconds it waits for its
#: ranks
LM_SHARDED_BATCH = 2
LM_SHARDED_SEQ = 4096
LM_SHARDED_TIMEOUT_S = 600
#: the dense family's trace rtol, the sharded runs' losses against the
#: stacked unsharded run's
LM_SHARDED_RTOL = 5e-4


def _gloo_probe_main(rank: int, store_path: str) -> None:
    """A spawned rank of the gloo probe: a DTensor all-gather (Shard(0) to
    Replicate, FSDP's gather) on cuda:0 over a two-rank gloo group."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    mesh = DeviceMesh("cuda", [0, 1], mesh_dim_names=("data",))
    x = torch.full((4, 8), float(rank), device="cuda")
    whole = DTensor.from_local(x, mesh, [Shard(0)]).redistribute(
        mesh, [Replicate()]).to_local()
    torch.cuda.synchronize()
    assert whole.shape == (8, 8) and float(whole[4:].mean()) == 1.0
    dist.destroy_process_group()


def _gloo_dtensor_probe() -> str:
    """Whether gloo runs DTensor's all-gather on CUDA tensors with two
    ranks on cuda:0: "ok", or how the ranks ended. The torch.distributed
    calls on their own (all_gather_into_tensor, reduce_scatter_tensor,
    all_to_all_single) take CUDA tensors there; DTensor issues them as
    functional collectives (scripts/probe_gloo_cuda.py probes each)."""
    import multiprocessing as mp
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="gloo_probe_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_probe_main, args=(r, f"{tmp}/store"))
             for r in range(2)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if codes == [0, 0]:
        return "ok"
    return ("a DTensor all-gather (Shard to Replicate) over gloo on cuda:0 "
            f"ended its ranks with exit codes {codes} (a negative code is "
            f"the signal: -11 is SIGSEGV)")


def _sharded_cell(arch: str) -> tuple:
    """The sharded phases' cells, each two pods, S = 4096 a pod, T = 6,
    periodic h = 2: (layers kept, batch a pod, leaves mixed a comm step,
    optimizer) of llama3-8b (lm_sharded) and of deepseek-v2 (lm_sharded_moe,
    lm_moe_full's cell)."""
    if arch == "llama3-8b":
        return LM_N_SUPER, LM_SHARDED_BATCH, LM_LEAVES, "adamw"
    return LM_MOE_N_SUPER, 1, LM_MOE_LEAVES, "sgd"


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms (warnings where an op has none):
    the MoE gathers' backward on the card then adds a token's gradients
    in a fixed order, so two runs can be held bit for bit."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _lm_sharded_run(shape, stacked_run: bool = False,
                    arch: str = "llama3-8b", moe_groups: int | None = None,
                    microbatches: int = 1, steps: int = 6) -> dict:
    """`arch`'s sharded cell at full width (LM_SHARDED_CELLS), through
    train_consensus_lm on `shape`: the stacked run on this card
    (`stacked_run`), or this rank's part of the run over the default
    process group; `moe_groups` overrides the MoE dispatch groups (a
    stacked run at a sharded run's groups), `microbatches` the steps'
    gradient accumulation, `steps` the run's. Each fused step is checked to
    leave the pods equal bit for bit (complete graph, n = 2); the first
    local and fused steps run under a count of the collectives' output
    bytes by kind (`launch.dryrun.CollectiveBytes`); a MoE cell's router
    choices of the first step are kept."""
    import math

    import torch
    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch.core.schedules import Periodic
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.dryrun import CollectiveBytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.models import registry
    from repro_torch.runtime.sharding import is_dtensor

    n_super, batch, leaves, opt_name = _sharded_cell(arch)
    cfg = dataclasses.replace(registry.get_config(arch, "full"),
                              n_super=n_super)
    optimizer = (optim.adamw if opt_name == "adamw" else optim.sgd)(
        optim.cosine_lr(3e-4, 6))
    mesh = make_mesh(shape, ("pod", "data", "model"), device="cuda",
                     group=None if stacked_run else dist.group.WORLD)
    real_steps = train_mod.make_consensus_steps
    real_top = mlp_mod._top_indices
    seen = {"params": None, "mixes": 0, "bytes": {}}
    choices = []

    def local_of(t):
        return t.to_local() if is_dtensor(t) else t

    def top(probs, k):  # the first step's choices (both pods, recompute)
        ids = real_top(probs, k)
        if len(choices) < 4 * n_super:
            choices.append(ids.cpu())
        return ids

    def watched_steps(*a, **kw):
        if moe_groups is not None:
            kw["moe_groups"] = moe_groups
        kw["microbatches"] = microbatches
        local, mix, fused = real_steps(*a, **kw)

        def counted(step, name):
            def run(*args):
                if name not in seen["bytes"]:
                    coll = CollectiveBytes()
                    with coll:
                        out = step(*args)
                    seen["bytes"][name] = coll.bytes
                else:
                    out = step(*args)
                seen["params"] = out[0]
                return out
            return run

        def checked(*args):
            out = counted(fused, "fused")(*args)
            seen["mixes"] += 1
            for leaf in torch.utils._pytree.tree_leaves(out[0]):
                leaf = local_of(leaf)
                if not torch.equal(leaf[0], leaf[1]):
                    raise AssertionError("lm_sharded: the pods differ after "
                                         "the mix (complete graph, n = 2)")
            return out
        return counted(local, "local"), mix, checked

    train_mod.make_consensus_steps = watched_steps
    mlp_mod._top_indices = top
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()
        rep = train_mod.train_consensus_lm(
            cfg, optimizer, mesh, steps=steps, schedule=Periodic(h=2),
            topology="complete", batch_per_node=batch,
            seq_len=LM_SHARDED_SEQ, seed=0, log_every=0)
        torch.cuda.synchronize()
        counts = _launch_counts()
    finally:
        train_mod.make_consensus_steps = real_steps
        mlp_mod._top_indices = real_top
    local_params = torch.utils._pytree.tree_map(local_of, seen["params"])
    if arch == "llama3-8b":
        digests = [_pod_digest(local_params, i) for i in range(2)]
    else:  # ten GB a pod: checksums on the card
        digests = [_pod_checksum(local_params, i) for i in range(2)]
    seen["params"] = local_params = None
    walls, comm = rep.extras["step_walls"], rep.extras["step_comm"]
    rounds = sum(comm)
    if counts["gossip_mix"] != leaves * rounds or seen["mixes"] != rounds:
        raise AssertionError(f"lm_sharded {arch} {shape}: K1 launched "
                             f"{counts['gossip_mix']} times, {seen['mixes']} "
                             f"checked mixes, for {rounds} comm steps of "
                             f"{leaves} leaves")
    if not all(math.isfinite(v) for v in rep.losses):
        raise AssertionError(f"lm_sharded {arch} {shape}: losses "
                             f"{rep.losses}")
    return {"arch": arch, "mesh": list(shape), "losses": list(rep.losses),
            "moe_groups": moe_groups, "microbatches": microbatches,
            "pod_param_digests_local": digests,
            "k1_launches": counts["gossip_mix"], "step_comm": comm,
            # the first local and fused steps ran under the byte count
            "first_step_s": walls[0],
            "local_step_s": [w for w, c in zip(walls, comm) if not c][1:],
            "fused_step_s": [w for w, c in zip(walls, comm) if c][1:],
            "collective_bytes": seen["bytes"],
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "choices": [c.tolist() for c in choices]}


#: the int64 weights of `_bits_checksum`: odd, by position
_CHECKSUM_MUL, _CHECKSUM_ADD = 6364136223846793005, 1442695040888963407
_CHECKSUM_CHUNK = 1 << 24


def _bits_checksum(t) -> int:
    """A checksum of a tensor's bits on its device: the sum, wrapping in
    int64, of each element's bits times an odd weight of its position, so
    that any one element that differs changes it."""
    import torch

    flat = t.detach().contiguous().reshape(-1)
    bits = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for c0 in range(0, bits.numel(), _CHECKSUM_CHUNK):
        part = bits[c0:c0 + _CHECKSUM_CHUNK].to(torch.int64)
        pos = torch.arange(c0, c0 + part.numel(), dtype=torch.int64,
                           device=t.device)
        total += (part * ((pos * _CHECKSUM_MUL + _CHECKSUM_ADD) | 1)).sum()
    return int(total)


def _pod_checksum(params, pod: int) -> list:
    """`_bits_checksum` of pod `pod`'s slice of every leaf, in leaf
    order."""
    import torch

    return [_bits_checksum(leaf[pod])
            for leaf in torch.utils._pytree.tree_leaves(params)]


def _fingerprinted_backward(params, batch: dict, cfg) -> dict:
    """One pod's `transformer.loss_fn` forward and backward (its layers as
    leaves of their own, as `launch.steps.grad_fn` lays them out), each
    gradient reduced to `_bits_checksum` and freed as it is accumulated,
    so only the parameters are held whole: the loss, the checksums in
    leaf order, the walls of the forward and the backward, the peak."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.runtime.sharding import is_dtensor

    train = steps._trainable(params)
    flat = torch.utils._pytree.tree_leaves(train)
    sums: list = [None] * len(flat)

    def hook(i):
        def done(p):
            g = p.grad
            sums[i] = _bits_checksum(g.to_local() if is_dtensor(g) else g)
            p.grad = None
        return done
    for i, t in enumerate(flat):
        t.register_post_accumulate_grad_hook(hook(i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.enable_grad(), steps._replicated(flat):
        loss = transformer.loss_fn(train, batch, cfg)
        value = float((loss.full_tensor() if is_dtensor(loss)
                       else loss).detach())
        t1 = time.perf_counter()
        loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if any(s is None for s in sums):
        raise AssertionError("a leaf of the VLM got no gradient")
    return {"loss": value, "checksums": sums, "forward_s": t1 - t0,
            "backward_s": t2 - t1,
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


#: the sequence of the VLM's loss check: at lm_vlm's 4096 the backward's
#: recomputation of one five-block superblock holds its attention score
#: chunks (above 37 GiB) beside the 35.8 GiB of parameters, past the card
LM_VLM_TRAIN_SEQ = 2048


def _lm_vlm_dtensor_check(mesh) -> dict:
    """vision-90b's lm_vlm cell (4 of 20 superblocks, 6400 encoder tokens;
    the port's init from seed 1, the gates at LM_VLM_GATE), one pod's loss
    on a batch of B = 1, S = LM_VLM_TRAIN_SEQ with `enc` (the streamed
    self-attention and cross-attention both): forward and backward plain,
    then as DTensors on `mesh` (one rank: every placement Replicate, the
    same storage) under the sharding rules; the loss and every gradient's
    checksum must be equal."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.compress import prng
    from repro_torch.models import registry, transformer
    from repro_torch.runtime import sharding as shrules

    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated() / 2 ** 30
    cfg = dataclasses.replace(
        registry.get_config("llama-3.2-vision-90b", "full"),
        n_super=LM_VLM_N_SUPER)
    params, _ = transformer.init(prng.key(1, "cuda"), cfg)
    for i, kind in enumerate(cfg.superblock):
        if kind == "cross_attn":
            params["stack"][f"slot{i}"]["attn"]["gate"].fill_(LM_VLM_GATE)
    gen = torch.Generator(device="cuda").manual_seed(31)
    V, S = cfg.vocab_size, LM_VLM_TRAIN_SEQ
    batch = {"tokens": torch.randint(0, V, (1, S), generator=gen,
                                     device="cuda"),
             "labels": torch.randint(0, V, (1, S), generator=gen,
                                     device="cuda"),
             "enc": torch.randn((1, cfg.num_encoder_tokens, cfg.encoder_dim),
                                generator=gen, device="cuda").to(cfg.dtype)}
    with _deterministic():
        plain = _fingerprinted_backward(params, batch, cfg)
        dm = mesh.shard_mesh
        rep = [Replicate()] * dm.ndim

        def placed(t):
            return DTensor.from_local(t, dm, rep, run_check=False)
        dparams = torch.utils._pytree.tree_map(placed, params)
        with shrules.use_rules(shrules.DEFAULT_RULES, mesh):
            dtensor = _fingerprinted_backward(
                dparams, {k: placed(v) for k, v in batch.items()}, cfg)
    if (dtensor["loss"] != plain["loss"]
            or dtensor["checksums"] != plain["checksums"]):
        raise AssertionError(
            f"lm_sharded_moe: the VLM's DTensor loss {dtensor['loss']} or "
            f"gradients differ from the plain ones ({plain['loss']}, "
            f"{sum(a != b for a, b in zip(plain['checksums'], dtensor['checksums']))}"
            f" of {len(plain['checksums'])} leaves)")
    del params, dparams, batch
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_super": cfg.n_super,
            "enc_tokens": cfg.num_encoder_tokens, "seq_len": S,
            "allocated_before_gib": held_before,
            "loss": plain["loss"], "leaves": len(plain["checksums"]),
            "equal_bit_for_bit": True,
            **{f"{side}_{k}": run[k] for side, run in (("plain", plain),
                                                       ("dtensor", dtensor))
               for k in ("forward_s", "backward_s", "peak_allocated_gib")}}


def _lm_sharded_main(rank: int, world: int, backend: str, jobs,
                     store_path: str, results) -> None:
    """A spawned rank of the sharded phases: its card, the process group,
    then each job: ("run", arch, shape[, microbatches]) is
    `_lm_sharded_run` on that layout (one step when it accumulates
    gradients), ("vlm",) the VLM's DTensor check on the one-rank mesh;
    the results (or the traceback) go to the parent."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(rank if backend == "nccl" else 0)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=300))
        try:
            out = []
            for job in jobs:
                if job[0] == "vlm":
                    from repro_torch.launch.mesh import make_mesh

                    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"),
                                     device="cuda", group=dist.group.WORLD)
                    out.append(_lm_vlm_dtensor_check(mesh))
                    continue
                _, arch, shape, *mb = job
                if arch == "llama3-8b":
                    out.append(_lm_sharded_run(
                        tuple(shape), **_accumulating(*mb)))
                else:
                    with _deterministic():
                        out.append(_lm_sharded_run(tuple(shape), arch=arch))
                torch.cuda.empty_cache()
            results.put((rank, None, out))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- sent to the parent, which fails
        results.put((rank, traceback.format_exc(), None))


#: lm_sharded's run with gradient accumulation: microbatches a step, and
#: its one local step
LM_SHARDED_MICROBATCHES = 2


def _accumulating(microbatches: int = 1) -> dict:
    """`_lm_sharded_run`'s arguments for a run at `microbatches` (one
    local step when it accumulates gradients)."""
    return ({} if microbatches == 1 else
            {"microbatches": microbatches, "steps": 1})


def _spawn_sharded(world: int, backend: str, jobs, label: str) -> tuple:
    """`_lm_sharded_main` on `world` spawned ranks; (each rank's results
    by rank, the phase's wall). Raises with a rank's traceback, or when a
    rank gives nothing within LM_SHARDED_TIMEOUT_S; every rank is stopped
    before this returns."""
    import multiprocessing as mp
    import queue
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="lm_sharded_")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_lm_sharded_main, daemon=True,
                         args=(r, world, backend, jobs, f"{tmp}/store",
                               results))
             for r in range(world)]
    t0 = time.perf_counter()
    ranks: dict[int, list] = {}
    try:
        for p in procs:
            p.start()
        while len(ranks) < world:
            try:
                rank, err, value = results.get(timeout=LM_SHARDED_TIMEOUT_S)
            except queue.Empty:
                raise AssertionError(f"{label}: no result from ranks "
                                     f"{sorted(set(range(world)) - set(ranks))}"
                                     f" in {LM_SHARDED_TIMEOUT_S} s") from None
            if err is not None:
                raise AssertionError(f"{label}: rank {rank} failed:\n{err}")
            ranks[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    return ranks, time.perf_counter() - t0


def phase_lm_sharded() -> dict:
    """Each pod's replica sharded over data and model as DTensors: the
    full-width llama3-8b cell (B = 2, S = 4096, 4 of 32 layers) on the
    layouts (2, 2, 1) (FSDP) and (2, 1, 2) (tensor and sequence
    parallelism) with the pods stacked on every rank, K1 mixing each
    rank's local shards; held to the stacked unsharded run at the same
    B, S and depth. Two or more cards: one rank a card over NCCL. One
    card: two ranks over gloo when gloo runs DTensor's collectives on
    CUDA tensors (probed first), else the one-card mesh (2, 1, 1) through
    the same DTensor path on one rank, every placement Replicate, held to
    the stacked run bit for bit. Then the first layout again with
    gradient accumulation (LM_SHARDED_MICROBATCHES, one local step),
    held to the stacked run at the same microbatches the same way, its
    peak beside the one-microbatch run's. Returns K1's launches and its
    time on a local shard."""
    import torch

    torch.cuda.empty_cache()
    stacked = _lm_sharded_run((2, 1, 1), stacked_run=True)
    torch.cuda.empty_cache()
    stacked_mb = _lm_sharded_run(
        (2, 1, 1), stacked_run=True,
        **_accumulating(LM_SHARDED_MICROBATCHES))
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    probe = _gloo_dtensor_probe() if cards < 2 else None
    if cards >= 2:
        backend, world, layouts = "nccl", 2, LM_SHARDED_LAYOUTS
    elif probe == "ok":
        backend, world, layouts = "gloo", 2, LM_SHARDED_LAYOUTS
    else:
        backend, world, layouts = "gloo", 1, LM_SHARDED_ONE_CARD
    sharded_on_card = world > 1
    ranks, wall = _spawn_sharded(
        world, backend, [("run", "llama3-8b", s) for s in layouts]
        + [("run", "llama3-8b", layouts[0], LM_SHARDED_MICROBATCHES)],
        "lm_sharded")
    accumulated = {r: runs.pop() for r, runs in ranks.items()}
    mb_rel = {}
    for r, run in sorted(accumulated.items()):
        mb_rel[r] = max(abs(a - b) / abs(b) for a, b in
                        zip(run["losses"], stacked_mb["losses"]))
        if sharded_on_card:
            if not mb_rel[r] <= LM_SHARDED_RTOL:
                raise AssertionError(
                    f"lm_sharded microbatches {LM_SHARDED_MICROBATCHES}: "
                    f"rank {r}'s losses {mb_rel[r]} off the stacked run's")
        elif (run["losses"] != stacked_mb["losses"] or
              run["pod_param_digests_local"] !=
              stacked_mb["pod_param_digests_local"]):
            raise AssertionError(
                f"lm_sharded microbatches {LM_SHARDED_MICROBATCHES}: the "
                f"one-card DTensor run is not the stacked run bit for bit")
    max_rel = {}
    for r, runs in sorted(ranks.items()):
        for run in runs:
            key = "x".join(map(str, run["mesh"]))
            if run["losses"] != ranks[0][layouts.index(
                    tuple(run["mesh"]))]["losses"]:
                raise AssertionError(f"lm_sharded {key}: rank {r}'s losses "
                                     f"differ from rank 0's")
            if run["step_comm"] != stacked["step_comm"]:
                raise AssertionError(f"lm_sharded {key}: comm steps "
                                     f"{run['step_comm']}")
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(run["losses"], stacked["losses"]))
            max_rel[key] = rel
            if sharded_on_card:
                if not rel <= LM_SHARDED_RTOL:
                    raise AssertionError(
                        f"lm_sharded {key}: losses {rel} off the stacked "
                        f"run's (rtol {LM_SHARDED_RTOL})")
            elif (run["losses"] != stacked["losses"] or
                  run["pod_param_digests_local"] !=
                  stacked["pod_param_digests_local"]):
                raise AssertionError(
                    f"lm_sharded {key}: the one-card DTensor run is not the "
                    f"stacked run bit for bit")
    k1_shard = _lm_k1_call(M=128256 * 2048)  # the embed leaf's data shard
    emit("lm_sharded", sharded_on_card=sharded_on_card, backend=backend,
         ranks=world, gloo_dtensor_probe=probe, cards=cards,
         layouts=[list(x) for x in layouts], n_super=LM_N_SUPER,
         seq_len=LM_SHARDED_SEQ, batch_per_pod=LM_SHARDED_BATCH,
         phase_wall_s=wall,
         rtol=LM_SHARDED_RTOL, losses_max_rel_to_stacked=max_rel,
         equal_to_stacked_bit_for_bit=not sharded_on_card,
         stacked={k: v for k, v in stacked.items()
                  if k not in ("pod_param_digests_local", "choices")},
         per_rank={r: [{k: v for k, v in run.items() if k != "choices"}
                       for run in runs] for r, runs in sorted(ranks.items())},
         k1_local_shard_call=k1_shard,
         microbatches={
             "microbatches": LM_SHARDED_MICROBATCHES, "steps": 1,
             "layout": list(layouts[0]),
             "losses_stacked": stacked_mb["losses"],
             "losses_per_rank": {r: run["losses"] for r, run in
                                 sorted(accumulated.items())},
             "losses_max_rel_to_stacked": mb_rel,
             "equal_to_stacked_bit_for_bit": not sharded_on_card,
             "peak_allocated_gib": {
                 "stacked": stacked_mb["peak_allocated_gib"],
                 "per_rank": {r: run["peak_allocated_gib"] for r, run in
                              sorted(accumulated.items())}},
             "peak_allocated_gib_one_microbatch": {
                 "stacked": stacked["peak_allocated_gib"],
                 "per_rank": {r: runs[0]["peak_allocated_gib"]
                              for r, runs in sorted(ranks.items())}},
             "first_step_s": {"stacked": stacked_mb["first_step_s"],
                              "per_rank": {r: run["first_step_s"] for r, run
                                           in sorted(accumulated.items())}},
             "collective_bytes": {r: run["collective_bytes"] for r, run in
                                  sorted(accumulated.items())}},
         nvidia_smi=nvidia_smi_line())
    return {"launches": {"stacked": stacked["k1_launches"],
                         "per_rank": [run["k1_launches"] for r in sorted(ranks)
                                      for run in ranks[r]]},
            "local_shard_call": k1_shard}


#: lm_init_sharded: qwen1.5-110b at its published widths and depth, one
#: pod on the production layout (data 16, model 16); the ranks drawn, by
#: their (data, model) coordinates, and the layers held to whole draws
LM_INIT_ARCH = "qwen1.5-110b"
LM_INIT_MESH = {"pod": 1, "data": 16, "model": 16}
LM_INIT_RANKS = ((0, 0), (15, 15))
LM_INIT_LAYERS = (0, 79)


def _named(tree, is_leaf=None) -> dict:
    """{path: leaf} of a tree, by torch's pytree key paths."""
    import torch.utils._pytree as pytree

    return {pytree.keystr(k): v for k, v in pytree.tree_flatten_with_path(
        tree, is_leaf=is_leaf)[0]}


def _same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def _chunk_workspace(device) -> int:
    """Bytes a shard draw holds beside its output while it draws one
    chunk: the peak of a block draw of `prng._CHUNK` elements above its
    output's bytes."""
    import torch

    from repro_torch.compress import prng

    n = prng._CHUNK
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = prng.truncated_normal(prng.key(0, device), -2.0, 2.0, (2, n),
                                out_dtype=torch.bfloat16,
                                block=((1, 1), (0, n)))
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base
            - out.numel() * out.element_size())


#: lm_sharded_plan's cells, (arch, shape): one for each family whose
#: sharded step torch 2.11's DTensor refused at (data 16, model 16)
LM_PLAN_CELLS = (("llama3-8b", "train_4k"),
                 ("musicgen-medium", "train_4k"),
                 ("musicgen-medium", "decode_32k"),
                 ("deepseek-v2-236b", "prefill_32k"),
                 ("llama-3.2-vision-90b", "train_4k"),
                 ("llama4-maverick-400b-a17b", "decode_32k"),
                 ("zamba2-2.7b", "train_4k"))
#: their depth: two superblocks, so that the second's attention meets the
#: sequence-parallel residual stream (at one, qwen1.5-110b's step holds no
#: op 2.11 refuses, though 2.11 refuses its two-superblock step)
LM_PLAN_N_SUPER = 2


def phase_lm_sharded_plan() -> dict:
    """One pod's step of each LM_PLAN_CELLS cell at (data 16, model 16) on
    meta DTensors over a placeholder group, LM_PLAN_N_SUPER superblocks
    deep: it must build and count 0 ops that torch 2.11 refuses.
    Host-side only."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import registry
    from repro_torch.optim import adamw, cosine_lr

    cells, t_all = [], time.perf_counter()
    for arch, shape in LM_PLAN_CELLS:
        cfg = dataclasses.replace(registry.get_config(arch, "full"),
                                  n_super=LM_PLAN_N_SUPER)
        optimizer = adamw(cosine_lr(3e-4, 10000),
                          moment_dtype=(torch.bfloat16 if cfg.opt_moments_bf16
                                        else torch.float32))
        t0 = time.perf_counter()
        with dryrun.placeholder_group(256) as group:
            mesh = make_production_mesh(multi_pod=False, group=group)
            counted = dryrun.count_step(cfg, registry.get_shapes(arch)[shape],
                                        mesh, optimizer)
        cell = {"arch": arch, "shape": shape, "layout": [16, 16],
                "n_super": LM_PLAN_N_SUPER,
                "seconds": time.perf_counter() - t0,
                "refused": len(counted.refused),
                "refused_first": counted.refused[:3],
                "collective_bytes": counted.bytes}
        emit("lm_sharded_plan_cell", torch=torch.__version__, **cell)
        cells.append(cell)
    refused = {f"{c['arch']} {c['shape']}": c["refused"] for c in cells
               if c["refused"]}
    out = {"torch": torch.__version__, "cells": len(cells),
           "wall_s": time.perf_counter() - t_all,
           "seconds": {f"{c['arch']} {c['shape']}": c["seconds"]
                       for c in cells}}
    emit("lm_sharded_plan", refused=refused, **out)
    if refused:
        raise RuntimeError(f"torch {torch.__version__} would refuse ops on "
                           f"DTensors in {refused}")
    return out


def _start_plan_child():
    """`phase_lm_sharded_plan` in a child process that sees no card (it
    needs none), so that its host-side minute runs beside the card's
    phases."""
    import os

    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.phase_lm_sharded_plan()"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)


def _finish_plan_child(child) -> None:
    """Waits for the child, prints its phase lines and raises unless it
    passed."""
    out, err = child.communicate(timeout=600)
    for line in out.splitlines():
        if line.startswith('{"phase": "lm_sharded_plan'):
            print(line, flush=True)
    if child.returncode != 0:
        raise RuntimeError(f"lm_sharded_plan failed (rc {child.returncode})"
                           f": {err[-3000:]}")


def phase_lm_init_sharded() -> None:
    """The shard-wise init at a model no card holds whole: qwen1.5-110b's
    pod drawn for ranks LM_INIT_RANKS of the production layout by their
    coordinates alone (`launch.train.draw_shards`, no process group),
    each rank's draw timed and its peak held below twice its shard bytes
    plus one chunk's workspace; every leaf of layers LM_INIT_LAYERS of
    each rank's shards equal to that layer drawn whole
    (`transformer.layer_init`) and cut to the rank's block, bit for
    bit."""
    import torch

    from repro_torch.compress import prng
    from repro_torch.launch import specs as sp
    from repro_torch.launch.train import draw_shards
    from repro_torch.models import registry, transformer
    from repro_torch.runtime import sharding as shrules

    t0 = time.perf_counter()
    cfg = registry.get_config(LM_INIT_ARCH, "full")
    dev = torch.device("cuda")
    pod_bytes = sum(t.numel() * t.element_size() for t in
                    torch.utils._pytree.tree_leaves(
                        sp.params_and_axes(cfg)[0]))
    workspace = _chunk_workspace(dev)
    ranks, shards = [], []
    for coords in LM_INIT_RANKS:
        at = dict(zip(("data", "model"), coords))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        drawn = draw_shards(cfg, 1, 0, dev, LM_INIT_MESH, at)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base
        shard_bytes = sum(x.numel() * x.element_size() for x in
                          torch.utils._pytree.tree_leaves(drawn))
        bound = 2 * shard_bytes + workspace
        if not peak < bound:
            raise AssertionError(f"lm_init_sharded rank {coords}: peak "
                                 f"{peak} B, not below {bound} B")
        shards.append(drawn)
        ranks.append({"coords": list(coords), "draw_s": seconds,
                      "shard_bytes": shard_bytes, "peak_bytes": peak,
                      "peak_bound_bytes": bound})
    stack_key = prng.split(prng.split(prng.key(0, dev), 1)[0], 8)[4]
    checked = [0] * len(ranks)
    for j in LM_INIT_LAYERS:
        layer, axes = transformer.layer_init(stack_key, cfg, 0, j)
        axes = _named(axes, is_leaf=shrules.is_axes_leaf)
        for name, whole in _named(layer).items():
            for r, coords in enumerate(LM_INIT_RANKS):
                rule = shrules.block_rule(
                    shrules.DEFAULT_RULES, LM_INIT_MESH, ("data", "model"),
                    dict(zip(("data", "model"), coords)))
                block = rule(tuple(whole.shape), axes[name])
                want = whole[tuple(slice(o, o + n) for o, n in block)]
                got = _named(shards[r]["stack"]["slot0"])[name][0, j]
                if not _same_bits(got, want):
                    raise AssertionError(
                        f"lm_init_sharded rank {coords} layer {j} {name}: "
                        f"the shard is not the whole layer's cut")
                checked[r] += 1
        del layer, whole, want
    for r, n in enumerate(checked):
        ranks[r]["leaves_equal_bit_for_bit"] = n
    del shards
    torch.cuda.empty_cache()
    emit("lm_init_sharded", arch=LM_INIT_ARCH, mesh=LM_INIT_MESH,
         layers=list(LM_INIT_LAYERS), pod_bytes=pod_bytes,
         chunk_workspace_bytes=workspace, ranks=ranks,
         phase_wall_s=time.perf_counter() - t0,
         nvidia_smi=nvidia_smi_line())


def _flips(a: list, b: list) -> int:
    """Router choices that differ between two runs' recorded calls."""
    import torch

    return sum(int((torch.as_tensor(x) != torch.as_tensor(y)).sum())
               for x, y in zip(a, b))


def phase_lm_sharded_moe() -> dict:
    """The MoE and MLA family sharded as DTensors, and the VLM's
    cross-attention: deepseek-v2's full-width cell (lm_moe_full's: the MLA
    prologue and one MLA + MoE superblock, two pods, B = 1, S = 4096,
    T = 6, periodic h = 2, SGD) stacked on the card, then through the
    DTensor path, both under torch's deterministic algorithms. One card:
    the one-rank mesh (2, 1, 1), held to the stacked run bit for bit
    (losses and both pods' checksums), K1 launched on local shards. Two or
    more cards: (2, 2, 1) and (2, 1, 2) over NCCL, each held to a stacked
    run at its dispatch groups (the data size) within LM_MOE_TRACE_RTOL,
    the first step's router choices that differ counted. Then the VLM's
    DTensor loss and gradients on the one-rank mesh against the plain
    ones (`_lm_vlm_dtensor_check`). Returns K1's launches."""
    import torch

    torch.cuda.empty_cache()
    arch = "deepseek-v2-236b"
    with _deterministic():
        stacked = {1: _lm_sharded_run((2, 1, 1), stacked_run=True,
                                      arch=arch)}
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    if cards >= 2:
        backend, world, layouts = "nccl", 2, LM_SHARDED_LAYOUTS
        with _deterministic():
            stacked[2] = _lm_sharded_run((2, 1, 1), stacked_run=True,
                                         arch=arch, moe_groups=2)
        torch.cuda.empty_cache()
    else:
        backend, world, layouts = "gloo", 1, LM_SHARDED_ONE_CARD
    ranks, wall = _spawn_sharded(
        world, backend, [("run", arch, s) for s in layouts]
        + ([("vlm",)] if world == 1 else []), "lm_sharded_moe")
    if world > 1:  # the VLM check on a one-rank mesh of its own
        vlm = _spawn_sharded(1, "gloo", [("vlm",)], "lm_sharded_moe")[0][0][0]
    else:
        vlm = ranks[0].pop()
    checks = {}
    for r, runs in sorted(ranks.items()):
        for run in runs:
            key = "x".join(map(str, run["mesh"]))
            ref = stacked[run["mesh"][1]]  # the same dispatch groups
            if run["losses"] != ranks[0][layouts.index(
                    tuple(run["mesh"]))]["losses"]:
                raise AssertionError(f"lm_sharded_moe {key}: rank {r}'s "
                                     f"losses differ from rank 0's")
            if run["step_comm"] != ref["step_comm"]:
                raise AssertionError(f"lm_sharded_moe {key}: comm steps "
                                     f"{run['step_comm']}")
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(run["losses"], ref["losses"]))
            checks[key] = {"losses_max_rel_to_stacked": rel}
            if world > 1:
                # each data rank routes its own groups: the layout's
                # choices are the model-rank-0 ranks' in data order
                i, m = layouts.index(tuple(run["mesh"])), run["mesh"][2]
                mine = [torch.cat([torch.as_tensor(ranks[q][i]["choices"][c])
                                   for q in sorted(ranks) if q % m == 0])
                        for c in range(len(ref["choices"]))]
                checks[key]["first_step_choices_flipped"] = _flips(
                    mine, ref["choices"])
                if not rel <= LM_MOE_TRACE_RTOL:
                    raise AssertionError(
                        f"lm_sharded_moe {key}: losses {rel} off the "
                        f"stacked run's (rtol {LM_MOE_TRACE_RTOL})")
            elif (run["losses"] != ref["losses"] or
                  run["pod_param_digests_local"] !=
                  ref["pod_param_digests_local"]):
                raise AssertionError(
                    f"lm_sharded_moe {key}: the one-card DTensor run is not "
                    f"the stacked run bit for bit")
    emit("lm_sharded_moe", arch=arch, sharded_on_card=world > 1,
         backend=backend, ranks=world, cards=cards,
         layouts=[list(x) for x in layouts], n_super=1,
         seq_len=LM_SHARDED_SEQ, batch_per_pod=1, optimizer="sgd",
         deterministic_algorithms=True, phase_wall_s=wall,
         rtol=LM_MOE_TRACE_RTOL, checks=checks,
         equal_to_stacked_bit_for_bit=world == 1,
         stacked={g: {k: v for k, v in run.items()
                      if k not in ("pod_param_digests_local", "choices")}
                  for g, run in stacked.items()},
         per_rank={r: [{k: v for k, v in run.items()
                        if k not in ("pod_param_digests_local", "choices")}
                       for run in runs] for r, runs in sorted(ranks.items())},
         vlm=vlm, nvidia_smi=nvidia_smi_line())
    return {"stacked": stacked[1]["k1_launches"],
            "per_rank": [run["k1_launches"] for r in sorted(ranks)
                         for run in ranks[r]]}


#: deepseek-v2's full-width cell: the dense MLA prologue layer and one of
#: its 59 MLA + MoE superblocks (2 of 60 layers), two pods, B = 1 and
#: S = 4096 a pod (train_4k's sequence), T = 6, SGD without momentum
LM_MOE_N_SUPER = 1
LM_MOE_SEQ = 4096
#: leaves of the cut deepseek-v2 tree, each mixed by one K1 launch: embed,
#: final_norm, lm_head; the prologue's 9 MLA and 4 FFN leaves; the
#: superblock's 9 MLA, 5 MoE and 3 shared-expert leaves
LM_MOE_LEAVES = 33
#: a pod's parameter bytes in that tree: 5,357,830,144 bf16 elements and
#: 848,896 float32 ones (the norms and the router)
LM_MOE_PARAM_BYTES = 5357830144 * 2 + 848896 * 4
#: the routed-expert leaf's columns a pod (160 experts x 5120 x 1536)
LM_EXPERT_LEAF = 160 * 5120 * 1536
#: the smoke-width MoE and MLA archs, card against CPU
LM_MOE_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
#: the relative error those runs' losses may show on the card against the
#: CPU: bf16 matmuls accumulate in another order on each, and a router
#: choice near a tie then flips (observed 1.09e-3 for deepseek-v2, with 404
#: of 24,576 choices flipped, above LM_TRACE_RTOL); the standard the CPU
#: tests hold the port's MoE runs to against the reference's
#: (tests/test_torch_launch_moe.py, observed 2.5e-3 there)
LM_MOE_TRACE_RTOL = 5e-3


def phase_lm_k1_expert_leaf() -> dict:
    """K1 at deepseek-v2's routed-expert leaf of two full-width pods (bf16,
    n = 2, k = 1, M = 1,258,291,200), on the empty card before the cell,
    against its plain version bit for bit; timed beside it and
    torch.matmul(P, z), its bound from bytes read once and written once."""
    import torch

    from repro_torch.kernels import gossip_mix

    torch.cuda.empty_cache()
    before = dict(gossip_mix.FORM_LAUNCHES)
    call = _lm_k1_call(M=LM_EXPERT_LEAF, seed=21, plain_graph=False)
    forms = {form: gossip_mix.FORM_LAUNCHES[form] - before[form]
             for form in before}
    emit("lm_k1_expert_leaf", n=2, k=1, M=LM_EXPERT_LEAF,
         forms_launched=forms, **call)
    if forms["slab"] or not forms["regs"]:
        raise AssertionError(f"K1 at the expert leaf ran {forms}, not the "
                             f"register kernel alone (n (k + 1) = 4)")
    return call


def _lm_profile_split(prof, optimizer: str) -> dict:
    """Device time (ms) of one profiled fused step by kind, from the
    profiler's kernel events: K1; the optimizer (kernels inside the GPU
    side of the "lm:<optimizer>" ranges); the matmuls (cuBLAS/CUTLASS
    kernels: the projections, the MoE's expert einsums, attention's
    einsums, the head, forward and backward); the MoE dispatch and combine
    (gather and scatter kernels: the gathers forward, their scatter-adds
    backward, and the loss's small gather); attention (the rest of the
    kernels launched by an op with a 5-D input, as the profiler ties each
    kernel to the op that launched it: the streamed attention's score
    chunks and carries, the only 5-D tensors of the models); the rest
    (norms, rope, the FFNs' and router's elementwise work, the loss, the
    embedding, gradient sums, copies). Needs a profile taken with
    record_shapes=True."""
    from torch.autograd import DeviceType

    def kind_of(name: str) -> str:
        if "gossip_mix" in name:
            return "k1"
        if any(s in name for s in ("gemm", "xmma", "cutlass", "nvjet",
                                   "cublas")):
            return "matmul"
        if "gather" in name or "scatter" in name:
            return "moe_gather"
        return "other"

    kernels, windows, attention = [], [], 0.0
    for evt in prof.events():
        if evt.device_type == DeviceType.CPU:
            shapes = getattr(evt, "input_shapes", None) or ()
            if any(isinstance(sh, (list, tuple)) and len(sh) == 5
                   for sh in shapes):
                attention += sum(k.duration for k in evt.kernels
                                 if kind_of(k.name.lower()) == "other")
            continue
        if evt.device_type != DeviceType.CUDA:
            continue
        span = (evt.time_range.start, evt.time_range.end)
        if evt.name.startswith("lm:"):
            windows.append(span)
        else:
            kernels.append((evt.name.lower(), span))
    split = {"k1": 0.0, optimizer: 0.0, "matmul": 0.0, "moe_gather": 0.0,
             "attention": attention / 1e3, "other": -attention / 1e3}
    for name, (t0, t1) in kernels:
        kind = kind_of(name)
        if kind != "k1" and any(w0 <= t0 < w1 for w0, w1 in windows):
            kind = optimizer
        split[kind] += (t1 - t0) / 1e3
    split["total"] = sum(split.values())
    split["kernels"] = len(kernels)
    split[f"{optimizer}_windows"] = len(windows)
    return split


def phase_lm_moe_full() -> dict:
    """deepseek-v2 at its published widths (MLA, 160 routed experts at
    top-6 with 2 shared, bf16) cut to 2 of its 60 layers, two pods stacked
    on the card, B = 1 and S = 4096 a pod, complete graph, periodic h = 2,
    T = 6, seed 0, through `launch.train.train_consensus_lm` with SGD
    without momentum (AdamW's float32 moments for two pods, 85.7 GB, do
    not fit the card), every launch count set to 0 just before and read
    just after: losses finite, the pods bitwise equal after each mix, K1
    once a leaf a comm step (33 leaves) and all on its register kernel,
    param_bytes the tree's, peak memory under LM_PEAK_CAP_GIB. Prints the
    step walls, the peak, K1's time a comm step against its bound, the
    dropped assignments of each MoE call (those in the overflow slot E*C)
    and the second fused step's device time by kind."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import optim
    from repro_torch.core.schedules import Periodic
    from repro_torch.kernels import gossip_mix
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.models import registry

    cfg = dataclasses.replace(registry.get_config("deepseek-v2-236b",
                                                  "full"),
                              n_super=LM_MOE_N_SUPER)
    seen = {"mixes": 0, "profile": None, "leaves": set()}
    drops = []
    real_steps = train_mod.make_consensus_steps
    real_dispatch = mlp_mod._dispatch_indices

    def counting_dispatch(ids, num_experts, capacity):
        dest = real_dispatch(ids, num_experts, capacity)
        drops.append((dest == num_experts * capacity).sum())  # no sync
        return dest

    def watched_steps(*a, **kw):
        local, mix, fused = real_steps(*a, **kw)

        def kept_local(params, opt_state, batch):
            out = local(params, opt_state, batch)
            seen["params"] = out[0]
            return out

        def checked_fused(params, opt_state, batch):
            seen["mixes"] += 1
            if seen["mixes"] == 2:  # the second comm step, profiled
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             record_shapes=True) as prof:
                    out = fused(params, opt_state, batch)
                    torch.cuda.synchronize()
                seen["profile"] = _lm_profile_split(prof, "sgd")
            else:
                out = fused(params, opt_state, batch)
            leaves = torch.utils._pytree.tree_leaves(out[0])
            seen["leaves"].add(len(leaves))
            for leaf in leaves:
                if not torch.equal(leaf[0], leaf[1]):
                    raise AssertionError("the two pods differ after the "
                                         "mix (complete graph, n = 2)")
            return out
        return local, mix, checked_fused

    sgd = optim.sgd(optim.cosine_lr(3e-4, 6))

    def labelled_update_(grads, state, params):
        with record_function("lm:sgd"):
            sgd.update_(grads, state, params)
    opt = dataclasses.replace(sgd, update_=labelled_update_)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), device="cuda")
    train_mod.make_consensus_steps = watched_steps
    mlp_mod._dispatch_indices = counting_dispatch
    try:
        _zero_launch_counts()
        t0 = time.perf_counter()
        report = train_mod.train_consensus_lm(
            cfg, opt, mesh, steps=6, schedule=Periodic(h=2),
            topology="complete", batch_per_node=1, seq_len=LM_MOE_SEQ,
            seed=0, log_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        forms = dict(gossip_mix.FORM_LAUNCHES)
    finally:
        train_mod.make_consensus_steps = real_steps
        mlp_mod._dispatch_indices = real_dispatch
    peak = torch.cuda.max_memory_allocated()
    drops = [int(d) for d in drops]
    torch.cuda.empty_cache()
    rounds = report.comm_rounds
    launches = counts["gossip_mix"]
    if launches != LM_MOE_LEAVES * rounds or rounds != 2 or \
            sum(counts.values()) != launches:
        raise AssertionError(f"the MoE cell launched {counts} for {rounds} "
                             f"comm steps of {LM_MOE_LEAVES} leaves")
    if forms != {"regs": launches, "slab": 0}:
        raise AssertionError(f"K1 ran {forms} in the MoE cell, not the "
                             f"register kernel alone")
    if seen["mixes"] != rounds or seen["leaves"] != {LM_MOE_LEAVES}:
        raise AssertionError(f"{seen['mixes']} fused steps with "
                             f"{seen['leaves']} leaves for {rounds} rounds")
    if report.extras["param_bytes"] != LM_MOE_PARAM_BYTES:
        raise AssertionError(f"param_bytes {report.extras['param_bytes']}")
    if not all(math.isfinite(v) for v in report.losses):
        raise AssertionError(f"MoE cell losses not finite: {report.losses}")
    if peak > LM_PEAK_CAP_GIB * 2 ** 30:
        raise AssertionError(f"peak {peak} bytes above {LM_PEAK_CAP_GIB} "
                             f"GiB at S={LM_MOE_SEQ}")
    calls = 2 * 6 * 2 * LM_MOE_N_SUPER  # pods, steps, forward + recompute
    if len(drops) != calls:
        raise AssertionError(f"{len(drops)} MoE calls, not {calls}")
    walls, comm = report.extras["step_walls"], report.extras["step_comm"]
    step_bytes = 2 * 2 * report.extras["param_bytes"]
    split = seen["profile"]
    emit("lm_moe_full", arch=cfg.name, n_super=LM_MOE_N_SUPER,
         seq_len=LM_MOE_SEQ, n_pods=2, optimizer="sgd",
         losses=report.losses, k1_launches=launches,
         k1_forms_launched=forms, leaves=LM_MOE_LEAVES,
         param_bytes=report.extras["param_bytes"],
         k1_comm_step_ms=split["k1"],
         k1_comm_step_bound_ms=_bound(step_bytes, 0.0)["bound_ms"],
         peak_allocated_gib=peak / 2 ** 30, wall_s=wall,
         step_walls_s=walls, step_comm=comm,
         local_step_s=[w for w, c in zip(walls[1:], comm[1:]) if not c],
         fused_step_s_unprofiled=walls[2],
         capacity=mlp_mod.moe_capacity(cfg, LM_MOE_SEQ),
         assignments_per_call=LM_MOE_SEQ * cfg.moe_top_k,
         dropped_per_call=drops, fused_step_profiled_split_ms=split)
    return {"launches": launches, "k1_comm_step_ms": split["k1"]}


def phase_lm_moe_smoke() -> dict:
    """deepseek-v2 and llama4-maverick at smoke width through
    repro_torch.run at mesh (4, 1, 1), expander k = 2, with the runner's
    AdamW, on the card (every launch count set to 0 just before and read
    just after) and on the CPU: host fields exact, losses within
    LM_MOE_TRACE_RTOL, K1 once a leaf a comm round. Prints, per arch, the
    router's top-K choices that differ between card and CPU. Returns K1's
    launches by arch."""
    import torch

    import repro_torch
    from repro_torch.compress import prng
    from repro_torch.convert import assert_results_match
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.models import registry, transformer

    torch.cuda.empty_cache()
    real_top = mlp_mod._top_indices
    launches = {}
    for arch in LM_MOE_ARCHS:
        spec = _lm_spec("lm_moe_smoke", "smoke", (4, 1, 1),
                        {"kind": "expander", "params": {"k": 2, "seed": 0}},
                        T=6, batch_per_node=2, seq_len=64, arch=arch)
        choices = {"cuda": [], "cpu": []}
        results = {}
        for device in ("cuda", "cpu"):
            def recording_top(probs, k, side=choices[device]):
                ids = real_top(probs, k)
                side.append(ids.cpu())
                return ids
            mlp_mod._top_indices = recording_top
            try:
                _zero_launch_counts()
                results[device] = repro_torch.run(spec, device=device)
                if device == "cuda":
                    torch.cuda.synchronize()
                    counts = _launch_counts()
            finally:
                mlp_mod._top_indices = real_top
        card, cpu = results["cuda"], results["cpu"]
        ours, theirs = card.to_dict(), cpu.to_dict()
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            ours["trace"]["fvals"], theirs["trace"]["fvals"]))
        flips = sum(int((a != b).sum()) for a, b in zip(choices["cuda"],
                                                        choices["cpu"]))
        total = sum(a.numel() for a in choices["cpu"])
        leaves = len(torch.utils._pytree.tree_leaves(transformer.init(
            prng.key(0, "cpu"), registry.get_config(arch, "smoke"))[0]))
        emit("lm_moe_smoke", arch=arch, card_cpu_max_rel=rel,
             rtol=LM_MOE_TRACE_RTOL, losses=card.trace.fvals,
             cpu_losses=cpu.trace.fvals, k1_launches=counts["gossip_mix"],
             leaves=leaves, router_choices=total,
             router_choices_card_cpu_differ=flips,
             moe_calls=len(choices["cuda"]))
        if len(choices["cuda"]) != len(choices["cpu"]) or not total:
            raise AssertionError(f"{arch}: the card made "
                                 f"{len(choices['cuda'])} MoE calls, the "
                                 f"CPU {len(choices['cpu'])}")
        if not rel <= LM_MOE_TRACE_RTOL:
            raise AssertionError(f"{arch}: the smoke run's losses on the card "
                                 f"are {rel} off the CPU's (rtol "
                                 f"{LM_MOE_TRACE_RTOL})")
        for side in (ours, theirs):
            side["trace"]["fvals"] = theirs["trace"]["fvals"]
            side["trace"]["fvals_consensus"] = theirs["trace"][
                "fvals_consensus"]
        assert_results_match(ours, theirs)
        _lm_host_fields(card, n=4, k=2, r=0.05)
        if counts["gossip_mix"] != leaves * card.extras["comm_rounds"] or \
                sum(counts.values()) != counts["gossip_mix"]:
            raise AssertionError(f"{arch}: the smoke run launched {counts} "
                                 f"for {card.extras['comm_rounds']} rounds "
                                 f"of {leaves} leaves")
        launches[arch] = counts["gossip_mix"]
    return launches


#: falcon-mamba-7b's full-width cell: its 64 Mamba-1 layers cut to 4, since
#: the mixer's per-token loop (a few launches a token, forward, recompute
#: and backward) sets the step's wall; two pods, B = 1 and S = 4096 a pod
LM_SSM_N_SUPER = 4
#: leaves of the cut falcon-mamba tree, each mixed by one K1 launch: the
#: 10 stacked Mamba-1 leaves, embed, lm_head and final_norm
LM_SSM_LEAVES = 13
#: a pod's parameter bytes there: 953,319,424 bf16 elements and 610,304
#: float32 ones (norms, dt_b, A_log, D_skip), from the reference's init
#: shapes
LM_SSM_PARAM_BYTES = 953319424 * 2 + 610304 * 4
#: zamba2-2.7b's full-width cell at full depth (9 superblocks of five
#: Mamba-2 blocks and the shared attention block: 54 blocks)
LM_HYBRID_N_SUPER = 9
#: its leaves: five Mamba-2 slots of 9, the 4 LoRA leaves, the shared
#: attention's 5 and the shared FFN's 3, embed, lm_head and final_norm
LM_HYBRID_LEAVES = 60
#: 2,048,894,080 bf16 elements and 364,080 float32 ones a pod
LM_HYBRID_PARAM_BYTES = 2048894080 * 2 + 364080 * 4
LM_SSM_SEQ = 4096
#: the smoke-width state-space archs, card against CPU
LM_SSM_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")


def _lm_ssm_cell(phase: str, arch: str, n_super: int, leaves: int,
                 param_bytes: int) -> dict:
    """One state-space arch at its published widths with `n_super`
    superblocks, two pods stacked, B = 1 and S = 4096 a pod, complete
    graph, periodic h = 2, T = 6, seed 0, through repro_torch.run (AdamW),
    every launch count set to 0 just before and read just after: losses
    finite, the pods bitwise equal after each mix, K1 once a leaf a comm
    step, the host fields' closed form, param_bytes, peak under
    LM_PEAK_CAP_GIB. The second fused step is profiled by kernel
    (`_kernel_split`), AdamW timed by CUDA events, and the scans' share
    taken from one mixer's scan profiled alone (`_scan_split`)."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry
    import repro_torch.optim as optim_mod

    cfg = dataclasses.replace(registry.get_config(arch, "full"),
                              n_super=n_super)
    real_get_config = registry.get_config
    real_steps = train_mod.make_consensus_steps
    real_adamw = optim_mod.adamw
    seen = {"mixes": 0, "profile": None, "leaves": set()}
    adamw_events = []

    def cut_config(name, variant="full"):
        if (name, variant) == (arch, "full"):
            return cfg
        return real_get_config(name, variant)

    def timed_adamw(*a, **kw):
        opt = real_adamw(*a, **kw)

        def update_(grads, state, params):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = opt.update_(grads, state, params)
            end.record()
            adamw_events.append((start, end))
            return out
        return dataclasses.replace(opt, update_=update_)

    def watched_steps(*a, **kw):
        local, mix, fused = real_steps(*a, **kw)

        def kept_local(params, opt_state, batch):
            out = local(params, opt_state, batch)
            seen["params"] = out[0]
            return out

        def checked_fused(params, opt_state, batch):
            seen["mixes"] += 1
            if seen["mixes"] == 2:  # the second comm step, profiled
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = fused(params, opt_state, batch)
                    torch.cuda.synchronize()
                seen["profile"] = _kernel_split(prof)
                seen["profile"]["profiled_step_s"] = time.perf_counter() - t0
                seen["adamw_at"] = len(adamw_events) - 2
                del prof
            else:
                out = fused(params, opt_state, batch)
            flat = torch.utils._pytree.tree_leaves(out[0])
            seen["leaves"].add(len(flat))
            for leaf in flat:
                if not torch.equal(leaf[0], leaf[1]):
                    raise AssertionError("the two pods differ after the "
                                         "mix (complete graph, n = 2)")
            return out
        return local, mix, checked_fused

    spec = _lm_spec(f"lm_{arch}", "full", (2, 1, 1),
                    {"kind": "complete", "params": {}}, T=6,
                    batch_per_node=1, seq_len=LM_SSM_SEQ, arch=arch)
    torch.cuda.empty_cache()
    registry.get_config = cut_config
    train_mod.make_consensus_steps = watched_steps
    optim_mod.adamw = timed_adamw
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()
        result = repro_torch.run(spec, device="cuda")
        torch.cuda.synchronize()
        counts = _launch_counts()
    finally:
        registry.get_config = real_get_config
        train_mod.make_consensus_steps = real_steps
        optim_mod.adamw = real_adamw
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    rounds = result.extras["comm_rounds"]
    launches = counts["gossip_mix"]
    if launches != leaves * rounds or rounds != 2 or \
            sum(counts.values()) != launches:
        raise AssertionError(f"{arch}: the cell launched {counts} for "
                             f"{rounds} comm steps of {leaves} leaves")
    if seen["mixes"] != rounds or seen["leaves"] != {leaves}:
        raise AssertionError(f"{arch}: {seen['mixes']} fused steps with "
                             f"{seen['leaves']} leaves for {rounds} rounds")
    _lm_host_fields(result, n=2, k=1, r=0.05)
    if result.extras["param_bytes"] != param_bytes:
        raise AssertionError(f"{arch}: param_bytes "
                             f"{result.extras['param_bytes']}")
    if not all(math.isfinite(v) for v in result.trace.fvals):
        raise AssertionError(f"{arch}: losses not finite: "
                             f"{result.trace.fvals}")
    if peak > LM_PEAK_CAP_GIB * 2 ** 30:
        raise AssertionError(f"{arch}: peak {peak} bytes above "
                             f"{LM_PEAK_CAP_GIB} GiB at n_super={n_super}")
    walls, comm = result.extras["step_walls"], result.extras["step_comm"]
    adamw_ms = [sum(s.elapsed_time(e) for s, e in adamw_events[i:i + 2])
                for i in range(0, len(adamw_events), 2)]
    # the profiled step's split: AdamW's kernels (by its CUDA events) and
    # the scans' (one mixer's scan profiled alone, `_scan_split`, for each
    # mixer of each pod) taken out of the rest
    split = seen["profile"]
    split["adamw"] = adamw_ms[seen["adamw_at"] // 2]
    block = _scan_split(cfg)
    mixers = 2 * n_super * sum(kind.startswith("mamba")
                               for kind in cfg.superblock)
    split["scan"] = block["total"] * mixers
    split["matmul"] -= block["matmul"] * mixers
    split["other"] -= split["adamw"] + block["other"] * mixers
    step_bytes = 2 * 2 * result.extras["param_bytes"]
    numbers = {"launches": launches, "k1_comm_step_ms": split["k1"],
               "k1_comm_step_bound_ms": _bound(step_bytes, 0.0)["bound_ms"]}
    emit(phase, arch=arch, n_super=n_super, seq_len=LM_SSM_SEQ, n_pods=2,
         optimizer="adamw", losses=result.trace.fvals, k1_launches=launches,
         leaves=leaves, param_bytes=result.extras["param_bytes"],
         peak_allocated_gib=peak / 2 ** 30, wall_s=result.wall_s,
         step_walls_s=walls, step_comm=comm,
         local_step_s=[w for w, c in zip(walls[1:], comm[1:]) if not c],
         fused_step_s_unprofiled=walls[2], adamw_step_ms=adamw_ms,
         fused_step_profiled_split_ms=split, scan_alone_split_ms=block,
         mixers_a_step=mixers, **numbers)
    return numbers


def _kernel_split(prof) -> dict:
    """Device time (ms) of a profile taken with CUDA activity alone (no
    host ops), by kernel name: K1, the matmuls, the rest; the busy share
    of the window from the first kernel's start to the last's end. Read
    from the profiler's raw events: a step of hundreds of thousands of
    launches is then cheap to take apart."""
    from torch.autograd import DeviceType

    split = {"k1": 0.0, "matmul": 0.0, "other": 0.0}
    first, last, n = None, None, 0
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != DeviceType.CUDA:
            continue
        name = evt.name().lower()
        t0, dur = evt.start_ns(), evt.duration_ns()
        first = t0 if first is None else min(first, t0)
        last = t0 + dur if last is None else max(last, t0 + dur)
        n += 1
        kind = "k1" if "gossip_mix" in name else "matmul" if any(
            s in name for s in ("gemm", "xmma", "cutlass", "nvjet",
                                "cublas")) else "other"
        split[kind] += dur / 1e6
    split["total"] = sum(split.values())
    split["kernels"] = n
    split["window_ms"] = (last - first) / 1e6 if n else 0.0
    split["busy_share"] = split["total"] / split["window_ms"] if n else 0.0
    return split


def _scan_split(cfg) -> dict:
    """One mixer's chunked scan (models/ssm.py `_run_chunks` with the
    mixer's chunk body: Mamba-1's token loop or Mamba-2's `_ssd_chunk`)
    alone at the cell's shapes (B = 1, S = 4096; x, B and C bf16 as the
    mixer hands them over, dt and A float32; random, seed 13), under the
    layer's checkpoint with each chunk's inside it as in the model, its
    forward and backward profiled with CUDA activity alone
    (`_kernel_split`): the scan's device time in one mixer of one pod."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda").manual_seed(13)
    S, N = LM_SSM_SEQ, cfg.ssm_state
    if "mamba1" in cfg.superblock:
        d, _ = ssm._m1_dims(cfg)
        x_shape, dt_shape, A_shape, h_shape = (1, S, d), (1, S, d), (d, N), \
            (1, d, N)
        body = ssm._m1_chunk_body
    else:
        _, H = ssm._m2_dims(cfg)
        P = cfg.ssm_head_dim
        x_shape, dt_shape, A_shape, h_shape = (1, S, H, P), (1, S, H), \
            (H,), (1, H, P, N)
        body = ssm._m2_chunk_body
    x = _randn(gen, x_shape, torch.bfloat16, 0.5).requires_grad_()
    dt = torch.nn.functional.softplus(_randn(gen, dt_shape) - 4.6)
    dt.requires_grad_()
    A = (-torch.exp(_randn(gen, A_shape, scale=0.3))).requires_grad_()
    Bm = _randn(gen, (1, S, N), torch.bfloat16, 0.5).requires_grad_()
    Cm = _randn(gen, (1, S, N), torch.bfloat16, 0.5).requires_grad_()
    h0 = torch.zeros(h_shape, device="cuda")
    n_chunks, Q = ssm._chunking(S, ssm._CHUNK)
    g = _randn(gen, x_shape)

    def scan(x, dt, A, Bm, Cm):
        return ssm._run_chunks(body(A), h0, (x, dt, Bm.float(), Cm), Q,
                               n_chunks, remat=True)

    def fwd_bwd():
        y = checkpoint(scan, x, dt, A, Bm, Cm, use_reentrant=False,
                       preserve_rng_state=False)
        torch.autograd.grad(y, (x, dt, A, Bm, Cm), g)

    fwd_bwd()   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    split = _kernel_split(prof)
    split["wall_s"] = time.perf_counter() - t0
    del prof, x, dt, A, Bm, Cm, g
    torch.cuda.empty_cache()
    return split


def phase_lm_ssm_full() -> dict:
    """falcon-mamba-7b at its published widths (d_model 4096, d_inner 8192,
    dt_rank 256, N 16, conv 4, vocab 65024, bf16), 4 of its 64 layers,
    through `_lm_ssm_cell`."""
    return _lm_ssm_cell("lm_ssm_full", "falcon-mamba-7b", LM_SSM_N_SUPER,
                        LM_SSM_LEAVES, LM_SSM_PARAM_BYTES)


def phase_lm_hybrid_full() -> dict:
    """zamba2-2.7b at its published widths and full depth (54 blocks:
    d_model 2560, 80 SSD heads of 64, N 64, 32 attention heads of 80, d_ff
    10240 GELU, LoRA rank 128, vocab 32000, bf16) through
    `_lm_ssm_cell`."""
    return _lm_ssm_cell("lm_hybrid_full", "zamba2-2.7b", LM_HYBRID_N_SUPER,
                        LM_HYBRID_LEAVES, LM_HYBRID_PARAM_BYTES)


def phase_lm_ssm_smoke() -> dict:
    """falcon-mamba-7b and zamba2-2.7b at smoke width through
    repro_torch.run at mesh (4, 1, 1), expander k = 2, with the runner's
    AdamW, on the card (every launch count set to 0 just before and read
    just after) and on the CPU: host fields exact, losses within
    LM_TRACE_RTOL, K1 once a leaf a comm round. Returns K1's launches by
    arch."""
    import torch

    import repro_torch
    from repro_torch.compress import prng
    from repro_torch.convert import assert_results_match
    from repro_torch.models import registry, transformer

    torch.cuda.empty_cache()
    launches = {}
    for arch in LM_SSM_ARCHS:
        spec = _lm_spec("lm_ssm_smoke", "smoke", (4, 1, 1),
                        {"kind": "expander", "params": {"k": 2, "seed": 0}},
                        T=6, batch_per_node=2, seq_len=64, arch=arch)
        _zero_launch_counts()
        card = repro_torch.run(spec, device="cuda")
        torch.cuda.synchronize()
        counts = _launch_counts()
        cpu = repro_torch.run(spec, device="cpu")
        ours, theirs = card.to_dict(), cpu.to_dict()
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            ours["trace"]["fvals"], theirs["trace"]["fvals"]))
        leaves = len(torch.utils._pytree.tree_leaves(transformer.init(
            prng.key(0, "cpu"), registry.get_config(arch, "smoke"))[0]))
        emit("lm_ssm_smoke", arch=arch, card_cpu_max_rel=rel,
             rtol=LM_TRACE_RTOL, losses=card.trace.fvals,
             cpu_losses=cpu.trace.fvals, k1_launches=counts["gossip_mix"],
             leaves=leaves)
        if not rel <= LM_TRACE_RTOL:
            raise AssertionError(f"{arch}: the smoke run's losses on the card "
                                 f"are {rel} off the CPU's (rtol "
                                 f"{LM_TRACE_RTOL})")
        for side in (ours, theirs):
            side["trace"]["fvals"] = theirs["trace"]["fvals"]
            side["trace"]["fvals_consensus"] = theirs["trace"][
                "fvals_consensus"]
        assert_results_match(ours, theirs)
        _lm_host_fields(card, n=4, k=2, r=0.05)
        if counts["gossip_mix"] != leaves * card.extras["comm_rounds"] or \
                sum(counts.values()) != counts["gossip_mix"]:
            raise AssertionError(f"{arch}: the smoke run launched {counts} "
                                 f"for {card.extras['comm_rounds']} rounds "
                                 f"of {leaves} leaves")
        launches[arch] = counts["gossip_mix"]
    return launches


#: the decode cells' caches and batches (configs/shapes.py): prefill at
#: train_4k's length (prefill_32k's 32,768 would cost about 64x the
#: attention time a layer: left out), decode over decode_32k's cache length
#: at a batch of 8 (its global batch is 128)
LM_DECODE_PREFILL_SEQ = 4096
LM_DECODE_CACHE = 32768
LM_DECODE_BATCH = 8
#: teacher-forced decode steps held against the forward
LM_DECODE_STEPS = 32
#: decode's logits against the teacher-forced forward's: the reference's
#: own gate (tests/test_models.py test_decode_matches_forward), whose
#: bf16 decode rounds otherwise than the forward (fp32 scores)
LM_DECODE_TOL = dict(atol=0.13, rtol=0.1)
#: decode's float32 scores from bf16 operands on the card (cuBLAS) against
#: the operands taken to float32 first (the CPU's form), relative to the
#: largest score: the repo's float32 tolerance (the two sum in another
#: order)
LM_DECODE_SCORES_TOL = 1e-5
#: llama-3.2-vision-90b's 20 superblocks (four self-attention blocks and
#: one cross-attention block each) cut to 4: 19.2e9 parameters, 38.4 GB
LM_VLM_N_SUPER = 4
LM_VLM_STEPS = 16
#: the cross-attention gate set before the VLM runs (0 at init, where the
#: blocks add exactly nothing)
LM_VLM_GATE = 0.5
#: the smoke archs' float32 decode on the card against the CPU, relative to
#: each tensor's largest magnitude (float32 sums in another order)
LM_DECODE_SMOKE_TOL = 1e-4
LM_DECODE_SMOKE_STEPS = 8


def _decode_teacher_forced(serve, params, cache, tokens) -> dict:
    """`serve` fed tokens (B, T) one at a time from position 0, each step
    between two CUDA events and synchronised: the logits (B, T, V) in
    float32, each step's host wall (s) and device time (ms, the events:
    the stream's time from the step's first launch to its last)."""
    import torch

    outs, walls, device_ms = [], [], []
    for pos in range(tokens.shape[1]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        logits, cache = serve(params, cache, tokens[:, pos:pos + 1], pos)
        end.record()
        end.synchronize()
        walls.append(time.perf_counter() - t0)
        device_ms.append(start.elapsed_time(end))
        outs.append(logits[:, 0].float())
    return {"logits": torch.stack(outs, dim=1), "walls": walls,
            "device_ms": device_ms}


def _hold_to_forward(label: str, dec, full) -> dict:
    """Decode's logits against the forward's over the same tokens, to
    LM_DECODE_TOL: the largest error, relative to the largest logit, and
    the argmax agreements."""
    import torch

    full = full.float()
    err = (dec - full).abs()
    held = {"max_abs_err": float(err.max()),
            "max_rel_err": float(err.max() / full.abs().max()),
            "argmax_agree": int((dec.argmax(-1) == full.argmax(-1)).sum()),
            "positions": int(full.shape[0] * full.shape[1]),
            "tol": LM_DECODE_TOL}
    if not bool(torch.isfinite(dec).all()) or not torch.allclose(
            dec, full, **LM_DECODE_TOL):
        raise AssertionError(f"{label}: decode's logits are off the "
                             f"forward's: {held}")
    return held


def _prefill_ms(prefill, params, batch, reps: int = 3) -> list:
    """Each of `reps` prefill calls timed alone by CUDA events (ms)."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        prefill(params, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _fill_cross_cache(cache, params, cfg, enc) -> None:
    """Each cross-attention block's encoder K and V from `enc` into the
    cache, in place: what the reference's decode test fills before decode
    (tests/test_models.py `_prefill_cross_cache`), which is no API of
    either package."""
    import torch

    for i, kind in enumerate(cfg.superblock):
        if kind == "cross_attn":
            prm = params["stack"][f"slot{i}"]["attn"]
            c = cache["stack"][f"slot{i}"]
            for j in range(cfg.n_super):
                c["ek"][j].copy_(torch.einsum("bne,ehk->bnhk", enc,
                                              prm["wk"][j]))
                c["ev"][j].copy_(torch.einsum("bne,ehk->bnhk", enc,
                                              prm["wv"][j]))


def _decode_scores_check(gen, cfg, B: int) -> dict:
    """Decode's float32 scores as the card computes them from bf16
    operands (`attention._bmm_f32`: cuBLAS, bf16 in, float32 out) against
    the CPU's form, the operands taken to float32 first, seeded values:
    GQA's block-diagonal contraction at the cell's shapes (B, 32768
    positions, the config's heads; `attention._gqa_scores`) and MLA's
    latent one at deepseek-v2's (128 heads over a 512-wide latent cache of
    the same length). The largest difference over the largest score, by
    form."""
    import torch

    from repro_torch.models import attention

    bf16 = torch.bfloat16
    K, G, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.hd
    qg = torch.randn((B, K, G, hd), generator=gen, device="cuda").to(bf16)
    ck = torch.randn((B, LM_DECODE_CACHE, K, hd), generator=gen,
                     device="cuda").to(bf16)
    gqa = attention._gqa_scores(qg, ck)
    gqa_up = torch.bmm(attention._block_diagonal(qg).float(), ck.reshape(
        B, LM_DECODE_CACHE, K * hd).transpose(1, 2).float()).view_as(gqa)
    del ck
    q_abs = torch.randn((B, 128, 512), generator=gen, device="cuda").to(bf16)
    ckv = torch.randn((B, LM_DECODE_CACHE, 512), generator=gen,
                      device="cuda").to(bf16)
    mla = attention._bmm_f32(q_abs, ckv.transpose(1, 2))
    mla_up = torch.bmm(q_abs.float(), ckv.transpose(1, 2).float())
    return {name: float((card - up).abs().max() / up.abs().max())
            for name, card, up in (("gqa", gqa, gqa_up),
                                   ("mla", mla, mla_up))}


def _tree_bytes(tree) -> int:
    import torch

    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree))


def _no_kernel_launched(label: str) -> dict:
    """The launch counts read after an inference phase: the path reaches
    no kernel of the port (the reference's models call no Pallas kernel)."""
    counts = _launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{label} launched {counts}")
    return counts


@contextlib.contextmanager
def _one_rank_group():
    """A process group of this process alone (NCCL on cuda:0) for the
    DTensor path on one card: its collectives span one rank."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _serve_mesh_one_card(group):
    from repro_torch.launch.mesh import make_serve_mesh

    return make_serve_mesh((1, 1), ("data", "model"), group=group,
                           device="cuda")


def _placed_in_place(tree, placements, mesh) -> object:
    """`tree` placed by `runtime.sharding.place` on the one-rank mesh,
    each DTensor's local tensor checked to be the leaf itself (no copy)."""
    import torch.utils._pytree as pytree

    from repro_torch.runtime import sharding as sh

    placed = sh.place(tree, placements, mesh.device_mesh)
    for d, t in zip(pytree.tree_leaves(placed), pytree.tree_leaves(tree)):
        if d.to_local().data_ptr() != t.data_ptr():
            raise AssertionError("placing a leaf on the one-rank mesh "
                                 "copied it")
    return placed


def _local_logits(serve):
    """`serve` with its logits taken to their local tensor (the whole on
    one rank)."""
    def step(params, cache, tokens, pos):
        logits, cache = serve(params, cache, tokens, pos)
        return logits.to_local(), cache
    return step


def _cache_checksums(cache) -> list:
    import torch.utils._pytree as pytree

    return [_bits_checksum(t.to_local() if hasattr(t, "to_local") else t)
            for t in pytree.tree_leaves(cache)]


def _lm_decode_dtensor(cfg, params, cache, batch, tokens, plain) -> dict:
    """lm_decode's prefill and decode again through the DTensor path: the
    one-rank serving mesh (data 1, model 1), the parameters and the same
    cache (zeroed first) placed by `serve_placements`, no copy; the steps
    given the mesh, so they run under its rules with every tensor a
    DTensor. The prefill's logits, each decode step's and the cache's bit
    checksums must equal the plain run's (`plain`); returns the times,
    the first step's wall (DTensor's planning), a step's kernels and
    busy share, and the peak."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import specs as sp
    from repro_torch.launch import steps
    from repro_torch.runtime import sharding as sh

    for t in torch.utils._pytree.tree_leaves(cache):
        t.zero_()
    torch.cuda.reset_peak_memory_stats()
    B, T = tokens.shape
    S = batch["tokens"].shape[1]
    with _one_rank_group() as group:
        mesh = _serve_mesh_one_card(group)
        dm = mesh.device_mesh
        pre_pl = sp.serve_placements(cfg, mesh, 1, S, S)
        dec_pl = sp.serve_placements(cfg, mesh, B, S, LM_DECODE_CACHE)
        d_params = _placed_in_place(params, pre_pl["params"], mesh)
        d_cache = _placed_in_place(cache, dec_pl["cache"], mesh)
        d_batch = {"tokens": sh.cut(batch["tokens"], dm,
                                    pre_pl["batch"]["tokens"])}
        d_tokens = sh.cut(tokens, dm, dec_pl["tokens"])
        _zero_launch_counts()
        prefill = steps.make_prefill_step(cfg, mesh=mesh)
        t0 = time.perf_counter()
        last = prefill(d_params, d_batch).to_local()
        torch.cuda.synchronize()
        first_prefill_s = time.perf_counter() - t0
        prefill_ms = _prefill_ms(prefill, d_params, d_batch)
        serve = _local_logits(steps.make_serve_step(cfg, mesh=mesh))
        run = _decode_teacher_forced(serve, d_params, d_cache, d_tokens)
        counts = _no_kernel_launched("lm_decode (DTensor)")
        peak = torch.cuda.max_memory_allocated() / 2**30
        checksums = _cache_checksums(d_cache)
        equal = {"prefill": bool(torch.equal(last, plain["last"])),
                 "logits": bool(torch.equal(run["logits"], plain["logits"])),
                 "cache": checksums == plain["cache_checksums"]}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            serve(d_params, d_cache, d_tokens[:, :1], T)
            torch.cuda.synchronize()
        split = _kernel_split(prof)
    if not all(equal.values()):
        raise AssertionError(f"lm_decode: the DTensor path is not the plain "
                             f"path bit for bit: {equal}")
    wall_ms = statistics.median(run["walls"]) * 1e3
    return {"mesh": [1, 1], "equal_bit_for_bit": equal,
            "first_prefill_s": first_prefill_s, "prefill_ms": prefill_ms,
            "step_wall_ms_first": run["walls"][0] * 1e3,
            "step_wall_ms_median": wall_ms,
            "step_walls_ms": [w * 1e3 for w in run["walls"]],
            "step_device_ms_median": statistics.median(run["device_ms"]),
            "step_kernels": split["kernels"],
            "step_kernel_ms": split["total"],
            "step_busy_share": split["total"] / wall_ms,
            "peak_allocated_gib": peak, "launches": counts}


def phase_lm_decode() -> None:
    """llama3-8b at full width and depth (32 layers, bf16, the port's init
    from seed 0): `make_prefill_step` at B = 1, S = 4096, timed; then
    `make_serve_step` over an `init_cache` of B = 8 and max_seq 32768,
    LM_DECODE_STEPS teacher-forced steps from position 0, every launch
    count set to 0 just before the prefill and read after the decode
    (no kernel of the port: inference runs torch ops, as the reference's
    XLA); the decode's logits held to the forward's over the same tokens
    (LM_DECODE_TOL). Prints the prefill's time against its bound, the
    decode step's median wall and device time against its byte bound
    (the parameters and the whole cache read once: `gqa_decode` reads all
    max_seq positions whatever the position), one step's kernels and
    busy share under torch.profiler, and the peak."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.compress import prng
    from repro_torch.launch import steps
    from repro_torch.models import registry, transformer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get_config("llama3-8b", "full")
    t0 = time.perf_counter()
    params, _ = transformer.init(prng.key(0, "cuda"), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        params))
    if n_params != 8030261248:
        raise AssertionError(f"llama3-8b has {n_params} parameters")
    param_bytes = _tree_bytes(params)
    gen = torch.Generator(device="cuda").manual_seed(23)
    V, S = cfg.vocab_size, LM_DECODE_PREFILL_SEQ

    _zero_launch_counts()
    prefill = steps.make_prefill_step(cfg)
    batch = {"tokens": torch.randint(0, V, (1, S), generator=gen,
                                     device="cuda")}
    last = prefill(params, batch)
    if tuple(last.shape) != (1, V) or not bool(torch.isfinite(
            last.float()).all()):
        raise AssertionError(f"prefill gave {tuple(last.shape)} logits, "
                             f"finite: {bool(torch.isfinite(last).all())}")
    prefill_ms = _prefill_ms(prefill, params, batch)
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.hd
    # the matmuls' 2 flops a weight a token (the embedding is a gather),
    # and causal attention's QK and PV over the kept half of the scores
    matmul_params = n_params - cfg.vocab_size * cfg.d_model
    prefill_flops = (2 * matmul_params * S
                     + 2 * 2 * L * H * hd * S * (S + 1) / 2)
    prefill_bound = _bound(param_bytes, prefill_flops, BF16_FLOPS)

    B, T = LM_DECODE_BATCH, LM_DECODE_STEPS
    cache = transformer.init_cache(cfg, B, LM_DECODE_CACHE, device="cuda")
    cache_bytes = _tree_bytes(cache)
    serve = steps.make_serve_step(cfg)
    tokens = torch.randint(0, V, (B, T), generator=gen, device="cuda")
    run = _decode_teacher_forced(serve, params, cache, tokens)
    counts = _no_kernel_launched("lm_decode")
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        full = transformer.forward(params, tokens, cfg)
    held = _hold_to_forward("lm_decode", run["logits"], full)
    del full
    plain = {"last": last, "logits": run["logits"],
             "cache_checksums": _cache_checksums(cache)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(params, cache, tokens[:, :1], T)
        torch.cuda.synchronize()
    split = _kernel_split(prof)
    dtensor = _lm_decode_dtensor(cfg, params, cache, batch, tokens, plain)
    del params, cache, run["logits"], plain, batch, last
    torch.cuda.empty_cache()
    scores_err = _decode_scores_check(gen, cfg, B)
    wall_ms = statistics.median(run["walls"]) * 1e3
    emit("lm_decode", arch="llama3-8b", n_params=n_params,
         param_bytes=param_bytes, init_s=init_s, prefill_batch=1,
         prefill_seq=S, prefill_ms=prefill_ms,
         prefill_bound_ms=prefill_bound["bound_ms"],
         prefill_bound_by=prefill_bound["bound_by"],
         prefill_tokens_per_s=S / (statistics.median(prefill_ms) / 1e3),
         decode_batch=B, cache_seq=LM_DECODE_CACHE, cache_bytes=cache_bytes,
         steps=T, step_wall_ms_median=wall_ms,
         step_device_ms_median=statistics.median(run["device_ms"]),
         step_walls_ms=[w * 1e3 for w in run["walls"]],
         step_bound_ms=(param_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3,
         step_bound_by="bytes", step_kernels=split["kernels"],
         step_kernel_ms=split["total"],
         step_busy_share=split["total"] / wall_ms,
         step_split_ms={k: split[k] for k in ("matmul", "other")},
         tokens_per_s=B / (wall_ms / 1e3), peak_allocated_gib=peak,
         scores_vs_upcast_max_rel=scores_err,
         scores_tol=LM_DECODE_SCORES_TOL, launches=counts,
         step_wall_ms_first=run["walls"][0] * 1e3, dtensor=dtensor,
         nvidia_smi=nvidia_smi_line(), **held)
    for label, gib in (("plain", peak), ("DTensor",
                                         dtensor["peak_allocated_gib"])):
        if gib > LM_PEAK_CAP_GIB:
            raise AssertionError(f"lm_decode ({label}) peaked at "
                                 f"{gib:.2f} GiB")
    if not max(scores_err.values()) <= LM_DECODE_SCORES_TOL:
        raise AssertionError(f"decode's scores on the card are off the "
                             f"upcast form's: {scores_err}")


def phase_lm_vlm() -> None:
    """llama-3.2-vision-90b at its published widths (d_model 8192, 64
    heads (8 kv) of 128, d_ff 28672, 6400 encoder tokens of 7680, vocab
    128256, bf16), its 20 superblocks cut to LM_VLM_N_SUPER = 4 (16
    self-attention and 4 cross-attention blocks), the port's init from
    seed 1 with the cross-attention gates set to LM_VLM_GATE, seeded
    encoder states (1, 6400, 7680) in bf16 (the streamed 4 x 1600 form):
    `make_prefill_step` at B = 1, S = 4096 with `enc`, timed; then
    LM_VLM_STEPS teacher-forced decode steps over an `init_cache` whose
    cross-attention K and V are filled from `enc`, held to `forward(enc=)`
    over the same tokens (LM_DECODE_TOL), every launch count set to 0
    just before the prefill and read after the decode. Prints the times,
    a decode step's against its byte bound (the weights and the cache
    read once), its kernels and busy share, and the peak."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.compress import prng
    from repro_torch.launch import steps
    from repro_torch.models import registry, transformer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(
        registry.get_config("llama-3.2-vision-90b", "full"),
        n_super=LM_VLM_N_SUPER)
    t0 = time.perf_counter()
    params, _ = transformer.init(prng.key(1, "cuda"), cfg)
    for i, kind in enumerate(cfg.superblock):
        if kind == "cross_attn":
            params["stack"][f"slot{i}"]["attn"]["gate"].fill_(LM_VLM_GATE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        params))
    gen = torch.Generator(device="cuda").manual_seed(29)
    V, S = cfg.vocab_size, LM_DECODE_PREFILL_SEQ
    enc = torch.randn((1, cfg.num_encoder_tokens, cfg.encoder_dim),
                      generator=gen, device="cuda").to(cfg.dtype)

    _zero_launch_counts()
    prefill = steps.make_prefill_step(cfg)
    batch = {"tokens": torch.randint(0, V, (1, S), generator=gen,
                                     device="cuda"), "enc": enc}
    last = prefill(params, batch)
    if tuple(last.shape) != (1, V) or not bool(torch.isfinite(
            last.float()).all()):
        raise AssertionError(f"VLM prefill gave {tuple(last.shape)}")
    prefill_ms = _prefill_ms(prefill, params, batch)
    del batch, last

    T = LM_VLM_STEPS
    cache = transformer.init_cache(cfg, 1, T, device="cuda")
    _fill_cross_cache(cache, params, cfg, enc)
    serve = steps.make_serve_step(cfg)
    tokens = torch.randint(0, V, (1, T), generator=gen, device="cuda")
    run = _decode_teacher_forced(serve, params, cache, tokens)
    counts = _no_kernel_launched("lm_vlm")
    with torch.no_grad():
        full = transformer.forward(params, tokens, cfg, enc=enc)
    held = _hold_to_forward("lm_vlm", run["logits"], full)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(params, cache, tokens[:, :1], T - 1)
        torch.cuda.synchronize()
    split = _kernel_split(prof)
    param_bytes = _tree_bytes(params)
    wall_ms = statistics.median(run["walls"]) * 1e3
    emit("lm_vlm", arch="llama-3.2-vision-90b", n_super=cfg.n_super,
         n_params=n_params, param_bytes=param_bytes, init_s=init_s,
         enc_shape=list(enc.shape), gate=LM_VLM_GATE, prefill_batch=1,
         prefill_seq=S, prefill_ms=prefill_ms,
         prefill_tokens_per_s=S / (statistics.median(prefill_ms) / 1e3),
         steps=T, step_wall_ms_median=wall_ms,
         step_device_ms_median=statistics.median(run["device_ms"]),
         step_bound_ms=(param_bytes + _tree_bytes(cache))
         / HBM_BYTES_PER_S * 1e3, step_bound_by="bytes",
         step_kernels=split["kernels"], step_kernel_ms=split["total"],
         step_busy_share=split["total"] / wall_ms,
         step_split_ms={k: split[k] for k in ("matmul", "other")},
         peak_allocated_gib=peak, launches=counts, **held)
    if peak > LM_PEAK_CAP_GIB:
        raise AssertionError(f"lm_vlm peaked at {peak:.2f} GiB")
    del params, cache, run, full, enc
    torch.cuda.empty_cache()


#: dryrun_memory's cells of llama3-8b: (name, S, B, kind, superblocks of
#: its 32), one microbatch
DRYRUN_MEMORY_CELLS = (("lm", 4096, 1, "train", 4),
                       ("prefill", 4096, 1, "prefill", 32),
                       ("lm_decode", 32768, 8, "decode", 32))
#: how far the card's peak above its resident bytes may lie from the
#: dry-run's reckoning, as a share of the reckoning
DRYRUN_MEMORY_TOL = 0.05


def _cell_on_card(kind: str, args: tuple, vocab: int, seq: int) -> tuple:
    """A dry-run cell's meta arguments (`dryrun.cell_args`) on the card:
    the parameters drawn N(0, 0.02) from a seeded generator, tokens and
    labels uniform over the vocabulary, the optimizer's state and the
    cache zero, the decode position the cache's last."""
    import torch
    import torch.utils._pytree as pytree

    gen = torch.Generator(device="cuda").manual_seed(30)

    def on_card(tree, fill):
        return pytree.tree_map(
            lambda t: None if t is None else fill(torch.empty(
                t.shape, dtype=t.dtype, device="cuda")), tree)

    def draw(t):
        return t.normal_(0.0, 0.02, generator=gen)

    def tokens(t):
        return t.random_(0, vocab, generator=gen)

    def zero(t):
        return t.zero_()

    fills = {"train": (draw, zero, tokens), "prefill": (draw, tokens),
             "decode": (draw, zero, tokens, lambda t: t.fill_(seq - 1))}
    return tuple(on_card(a, f) for a, f in zip(args, fills[kind]))


def phase_dryrun_memory() -> None:
    """The dry-run's reckoned temporaries and unaliased outputs of each
    DRYRUN_MEMORY_CELLS cell against the card's allocator: the step's peak
    above its resident bytes after a warm-up step, within
    DRYRUN_MEMORY_TOL of the reckoning."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import registry
    from repro_torch.optim import adamw, cosine_lr

    cells, t_all = [], time.perf_counter()
    for name, seq, batch, kind, n_super in DRYRUN_MEMORY_CELLS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(registry.get_config("llama3-8b", "full"),
                                  n_super=n_super, train_microbatches=1)
        cell = ShapeCell(name, seq, batch, kind)
        optimizer = adamw(cosine_lr(3e-4, 10000),
                          moment_dtype=(torch.bfloat16 if cfg.opt_moments_bf16
                                        else torch.float32))
        layout = Mesh(("data", "model"), (1, 1), torch.device("meta"))
        rec = dryrun.reckon(cfg, cell, layout, False, optimizer)
        mem = rec["memory"]
        reckoned = mem["temp_size_in_bytes"] + max(
            mem["output_size_in_bytes"] - mem["alias_size_in_bytes"], 0)
        reckon_s = time.perf_counter() - t0
        built = dryrun.cell_args(cfg, cell, layout, False, optimizer)
        step = built["step"]
        args = _cell_on_card(kind, built["args"], cfg.vocab_size, seq)
        del built
        out = step(*args)  # warm-up: cuBLAS's workspaces, cached blocks
        torch.cuda.synchronize()
        del out
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
        measured = torch.cuda.max_memory_allocated() - resident
        # the metrics, the last position's logits, the next token's
        result = {"train": lambda: out[2], "prefill": lambda: out,
                  "decode": lambda: out[0]}[kind]()
        finite = all(bool(torch.isfinite(t).all())
                     for t in pytree.tree_leaves(result))
        del out, result, args
        torch.cuda.empty_cache()
        c = {"cell": name, "kind": kind, "seq_len": seq, "batch": batch,
             "n_super": n_super, "arguments_reckoned": mem[
                 "argument_size_in_bytes"], "resident": resident,
             "temp_reckoned": mem["temp_size_in_bytes"],
             "reckoned": reckoned, "measured": measured,
             "ratio": measured / reckoned, "finite": finite,
             "reckon_s": reckon_s, "step_s": step_s,
             "seconds": time.perf_counter() - t0}
        emit("dryrun_memory_cell", **c)
        cells.append(c)
    emit("dryrun_memory", tol=DRYRUN_MEMORY_TOL, torch=torch.__version__,
         seconds=time.perf_counter() - t_all,
         ratios={c["cell"]: c["ratio"] for c in cells})
    missed = {c["cell"]: c["ratio"] for c in cells
              if abs(c["ratio"] - 1) > DRYRUN_MEMORY_TOL or not c["finite"]}
    if missed:
        raise AssertionError(f"the card's peak above its resident bytes "
                             f"misses the dry-run's reckoning by more than "
                             f"{DRYRUN_MEMORY_TOL} (or its outputs are not "
                             f"finite): {missed}")


def phase_lm_decode_smoke() -> None:
    """All ten archs at smoke width in float32 (their parameters the port's
    init plus seeded noise, so the cross-attention gates and zamba2's LoRA
    factors are not zero), LM_DECODE_SMOKE_STEPS decode steps at B = 2 on
    the card and the same on the CPU, every launch count set to 0 just
    before the card's and read just after: each step's logits and the
    whole cache after the last within LM_DECODE_SMOKE_TOL of their largest
    magnitude; every block kind exercised. The card's run again through
    the DTensor path on the one-rank serving mesh (parameters and cache
    placed by `serve_placements`, no copy), equal to the plain card run
    bit for bit."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch.compress import prng
    from repro_torch.launch import specs as sp
    from repro_torch.launch import steps
    from repro_torch.models import registry, transformer
    from repro_torch.runtime import sharding as sh

    kinds = set()
    with _one_rank_group() as group:
        mesh = _serve_mesh_one_card(group)
        for arch in registry.ARCH_IDS:
            cfg = dataclasses.replace(registry.get_config(arch, "smoke"),
                                      dtype=torch.float32)
            kinds.update(cfg.blocks)
            gen = torch.Generator().manual_seed(31)
            params = transformer.init(prng.key(0, "cpu"), cfg)[0]
            params = pytree.tree_map(lambda t: t + 0.2 * (
                t.std() if t.numel() > 1 and bool(t.std() > 0) else 1.0)
                * torch.randn(t.shape, generator=gen), params)
            tokens = torch.randint(0, cfg.vocab_size,
                                   (2, LM_DECODE_SMOKE_STEPS), generator=gen)
            enc = (torch.randn((2, cfg.num_encoder_tokens, cfg.encoder_dim),
                               generator=gen) if cfg.family == "vlm" else None)
            serve = steps.make_serve_step(cfg)
            runs = {}
            for dev in ("cuda", "dtensor", "cpu"):
                on = "cpu" if dev == "cpu" else "cuda"
                p_dev = pytree.tree_map(lambda t: t.to(on), params)
                cache = transformer.init_cache(cfg, 2, LM_DECODE_SMOKE_STEPS,
                                               torch.float32, device=on)
                if enc is not None:
                    _fill_cross_cache(cache, p_dev, cfg, enc.to(on))
                step, toks = serve, tokens.to(on)
                if dev == "dtensor":  # the same on the one-rank mesh
                    n = LM_DECODE_SMOKE_STEPS
                    pl = sp.serve_placements(cfg, mesh, 2, n, n)
                    p_dev = _placed_in_place(p_dev, pl["params"], mesh)
                    cache = _placed_in_place(cache, pl["cache"], mesh)
                    toks = sh.cut(toks, mesh.device_mesh, pl["tokens"])
                    step = _local_logits(steps.make_serve_step(cfg, mesh=mesh))
                if dev != "cpu":
                    _zero_launch_counts()
                outs = [step(p_dev, cache, toks[:, t:t + 1], t)[0]
                        for t in range(LM_DECODE_SMOKE_STEPS)]
                if dev != "cpu":
                    torch.cuda.synchronize()
                    counts = _no_kernel_launched(f"lm_decode_smoke {arch} "
                                                 f"({dev})")
                runs[dev] = (torch.cat(outs, dim=1).cpu(),
                             [(t.to_local() if dev == "dtensor" else t).cpu()
                              for t in pytree.tree_leaves(cache)])
            (card, card_cache), (cpu, cpu_cache) = runs["cuda"], runs["cpu"]
            dt_logits, dt_cache = runs["dtensor"]
            dtensor_equal = bool(torch.equal(dt_logits, card)) and all(
                torch.equal(a, b) for a, b in zip(dt_cache, card_cache))
            errs = [float((card - cpu).abs().max() / cpu.abs().max())]
            errs += [float((a - b).abs().max() / max(float(b.abs().max()),
                                                     1e-30))
                     for a, b in zip(card_cache, cpu_cache)]
            emit("lm_decode_smoke", arch=arch, blocks=sorted(set(cfg.blocks)),
                 steps=LM_DECODE_SMOKE_STEPS, logits_max_rel=errs[0],
                 cache_max_rel=max(errs[1:]), tol=LM_DECODE_SMOKE_TOL,
                 dtensor_equal_bit_for_bit=dtensor_equal, launches=counts)
            if not max(errs) <= LM_DECODE_SMOKE_TOL:
                raise AssertionError(f"{arch}: decode on the card is "
                                     f"{max(errs)} off the CPU's")
            if not dtensor_equal:
                raise AssertionError(f"{arch}: the DTensor decode on the "
                                     f"card is not the plain one bit for "
                                     f"bit")
    every = {"attn", "attn_moe", "mla", "mla_moe", "cross_attn", "mamba1",
             "mamba2", "shared_attn"}
    if kinds != every:
        raise AssertionError(f"the smoke archs exercise {sorted(kinds)}")


def phase_kernel_k3() -> dict:
    """K3 (the flat per-node mix) against its plain version on the card,
    then its front door at full width, then its times."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def cases():
        for M in (1, 3, 130, 4099, 8192, 65537, 1 << 20):
            for k in (1, 4, 8):
                for dtype in (torch.float32, torch.bfloat16):
                    for off in (0, 1):
                        # a view one element in is not 16-byte aligned: the
                        # kernel takes its scalar path
                        sb = _randn(gen, (M + off,), dtype)[off:]
                        nb = _randn(gen, (k * M + off,), dtype)[off:] \
                            .view(k, M)
                        yield (f"M={M} k={k} {dtype} offset={off}",
                               (sb, nb, 0.2, 0.8 / k),
                               str(dtype).split(".")[1])

    _check_grid("gossip_mix_flat", "K3", cases(), ops.gossip_mix,
                ref.gossip_mix_ref,
                {"float32": FP32_TOL, "bfloat16": BF16_TOL})

    # full width: one llama3-8b decoder layer's parameters, flattened
    # (configs/llama3_8b.py: q, k, v, o 41,943,040 + SwiGLU 176,160,768 +
    # two norms 8,192), k = 4 received buffers, fp32
    M, k, sw, ew = 218_112_000, 4, 0.2, 0.2
    args = (_randn(gen, (M,)), _randn(gen, (k, M)), sw, ew)
    sb, nb = args[:2]
    launches, err = _full_width("gossip_mix_flat", "K3", ops.gossip_mix,
                                ref.gossip_mix_ref, args, FP32_TOL)
    ew_vec = torch.full((k,), ew, device="cuda")
    _hold("torch.addmv", torch.addmv(sb, nb.T, ew_vec, beta=sw),
          ref.gossip_mix_ref(*args), FP32_TOL)
    kernel_t = time_ms(lambda: ops.gossip_mix(*args), reps=10, inner=5)
    plain_t = time_ms(lambda: ref.gossip_mix_ref(*args), reps=5, inner=2)
    library_t = time_ms(lambda: torch.addmv(sb, nb.T, ew_vec, beta=sw),
                        reps=5, inner=2)
    # self and the k buffers read once, out written once; k + 2 flops an
    # element (k - 1 adds, two products, one add)
    numbers = _report(
        "gossip_mix_flat", "gossip_mix.cu",
        "src/repro/kernels/gossip_mix.py:46", launches, err, kernel_t,
        plain_t, library_t, nbytes=(k + 2) * M * 4, flops=(k + 2) * M,
        shape={"M": M, "k": k, "dtype": "float32"},
        library_call="torch.addmv(self, nbrs.T, full(k, ew), beta=sw)")
    del args, sb, nb
    torch.cuda.empty_cache()
    return numbers


def _attention_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(row, column) pairs the mask keeps: all of them, or under the
    top-left causal mask min(r + 1, Sk) for row r."""
    if not causal:
        return Sq * Sk
    full = max(Sq - Sk, 0) * Sk
    tri = min(Sq, Sk)
    return tri * (tri + 1) // 2 + full


def phase_kernel_k4(build_s: dict) -> dict:
    """K4 (flash attention) against its plain version on the card, each case
    on the route `flash_attention.route` names, then its front door at full
    width in bf16 (the sm90 route), the sm90 kernel's fp32-out entry and the
    fp32 route on fp32 copies, then its times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    shapes = []
    for S, D, H, KH in ((128, 64, 4, 4), (256, 64, 8, 2), (256, 128, 4, 1),
                        (512, 32, 2, 2)):   # tests/test_kernels.py:17-22
        for causal in (True, False):
            shapes.append((2, H, KH, S, S, D, causal))
    for Sq, Sk in ((128, 256), (256, 128), (128, 512), (100, 100)):
        for causal in (True, False):
            shapes.append((1, 4, 2, Sq, Sk, 64, causal))
    for D in (16, 48, 80, 96, 160, 192, 256):
        shapes.append((1, 2, 1, 128, 128, D, True))
    # D not a multiple of 8: bf16 too takes the tf32x3 route, staged with
    # a conversion; D = 1 and 12 rows go 4 bytes a copy in fp32
    for D in (1, 12, 100):
        shapes.append((1, 4, 2, 128, 128, D, True))
    shapes.append((1, 32, 32, 256, 256, 80, True))   # zamba2-2.7b's heads

    def cases():
        for B, H, KH, Sq, Sk, D, causal in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                yield (f"B={B} H={H} KH={KH} Sq={Sq} Sk={Sk} D={D} "
                       f"causal={causal} {dtype}",
                       (_randn(gen, (B, H, Sq, D), dtype),
                        _randn(gen, (B, KH, Sk, D), dtype),
                        _randn(gen, (B, KH, Sk, D), dtype), causal),
                       str(dtype).split(".")[1])

    grid_routes = {"sm90": 0, "tf32x3": 0}

    def door(q, k, v, causal=True):
        """The front door, which must launch once on the route's kernel."""
        want = fa.route(q.dtype, q.shape[-1])
        before = _route_counts()
        out = ops.flash_attention(q, k, v, causal=causal)
        moved = {r: n - before[r] for r, n in _route_counts().items()}
        if moved != {r: int(r == want) for r in moved}:
            raise AssertionError(f"K4 on {q.dtype} D={q.shape[-1]} should "
                                 f"launch once on {want}, launched {moved}")
        grid_routes[want] += 1
        return out

    def plain(q, k, v, causal=True):
        return ref.flash_attention_ref(q, k, v, causal=causal)

    _check_grid("flash_attention", "K4", cases(), door, plain, ATTN_TOL)
    grid_taken = dict(grid_routes)  # the grid's; calls below add more
    sm90_cases = sum(shape[5] % 8 == 0 for shape in shapes)
    if grid_taken != {"sm90": sm90_cases,
                      "tf32x3": 2 * len(shapes) - sm90_cases}:
        raise AssertionError(f"K4's grid took the routes {grid_taken}: "
                             f"every bf16 case with D % 8 == 0 on sm90, "
                             f"every other case on tf32x3")

    # full width: llama3-8b's attention (configs/llama3_8b.py: 32 heads, 8
    # kv heads, head dim 128) at train_4k (configs/shapes.py), bf16, causal
    B, H, KH, S, D = 1, 32, 8, 4096, 128
    q, k, v = (_randn(gen, (B, h, S, D), torch.bfloat16)
               for h in (H, KH, KH))
    launches, err = _full_width("flash_attention", "K4", door, plain,
                                (q, k, v), ATTN_TOL["bfloat16"])
    routes = _route_counts()
    if routes != {"sm90": 1, "tf32x3": 0}:
        raise AssertionError(f"K4 at full width took the routes {routes}")
    # the same inputs as exact fp32 copies, held to the fp32 tolerance: the
    # sm90 kernel with an fp32 output (a kernel that rounded P to bf16 would
    # be about 1e-3 off, against rtol 2e-4), and the fp32 route's kernel
    copies = (q.float(), k.float(), v.float())
    expect32 = plain(*copies)
    err_fp32_out = _hold("K4 sm90 fp32-out at full width on fp32 copies",
                         fa._flash_attention_fp32_out(q, k, v), expect32,
                         ATTN_TOL["float32"])
    err_fp32 = _hold("K4 fp32 route at full width on fp32 copies",
                     door(*copies), expect32, ATTN_TOL["float32"])
    kr = k.repeat_interleave(H // KH, dim=1)
    vr = v.repeat_interleave(H // KH, dim=1)
    kr32, vr32 = kr.float(), vr.float()
    err_fp32_library = _max_err(F.scaled_dot_product_attention(
        copies[0], kr32, vr32, is_causal=True), expect32)
    del expect32
    kernel_t = time_ms(lambda: ops.flash_attention(q, k, v), reps=10,
                       inner=3)
    plain_t = time_ms(lambda: plain(q, k, v), reps=5, inner=2)
    library_t = time_ms(lambda: F.scaled_dot_product_attention(
        q, kr, vr, is_causal=True), reps=10, inner=5)
    fp32_out_t = time_ms(lambda: fa._flash_attention_fp32_out(q, k, v),
                         reps=10, inner=3)
    fp32_route_t = time_ms(lambda: ops.flash_attention(*copies), reps=5,
                           inner=2)
    fp32_plain_t = time_ms(lambda: plain(*copies), reps=5, inner=2)
    # the library call on the fp32 copies: the fp32 route's yardstick
    fp32_library_t = time_ms(lambda: F.scaled_dot_product_attention(
        copies[0], kr32, vr32, is_causal=True), reps=10, inner=3)
    del kr32, vr32
    del copies
    torch.cuda.empty_cache()
    # q, k, v read once, out written once; 4 D flops (q.k and p v) for
    # each (row, column) pair the causal mask keeps: the reference's work;
    # the sm90 kernel's split does P V twice, 6 D flops a pair
    pairs = B * H * _attention_pairs(S, S, True)
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KH * S * D)
    flops = 4 * D * pairs
    numbers = _report(
        "flash_attention", "flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention.py:79", launches, err, kernel_t,
        plain_t, library_t, nbytes, flops, BF16_FLOPS,
        shape={"B": B, "H": H, "KH": KH, "Sq": S, "Sk": S, "D": D,
               "dtype": "bfloat16", "causal": True},
        route_launches=routes, grid_routes=grid_taken,
        max_abs_err_fp32_out=err_fp32_out,
        max_abs_err_fp32_route=err_fp32,
        bound_basis="the reference's work, 4 D flops a kept pair, on the "
                    "bf16 tensor cores at 989 TFLOP/s",
        split_flops=6 * D * pairs,
        split_bound_ms=_bound(nbytes, 6 * D * pairs, BF16_FLOPS)["bound_ms"],
        fp32_out_ms=fp32_out_t["device"],
        fp32_route_ms=fp32_route_t["device"],
        fp32_route_plain_ms=fp32_plain_t["device"],
        fp32_route_bound_ms=_bound(2 * nbytes, flops, FP32_FLOPS)["bound_ms"],
        fp32_route_tf32_bound_ms=_bound(2 * nbytes, flops,
                                        TF32_FLOPS)["bound_ms"],
        fp32_route_library_ms=fp32_library_t["device"],
        fp32_route_library_max_abs_err=err_fp32_library,
        fp32_route_tf32x3_floor_ms=_bound(0, 3 * flops,
                                          TF32_FLOPS)["bound_ms"],
        build_s={name: build_s[name] for name in
                 ("flash_attention_sm90", "flash_attention")},
        library_call="F.scaled_dot_product_attention(q, k, v, "
                     "is_causal=True), K and V repeated per group outside "
                     "the timed window")
    del q, k, v, kr, vr
    return numbers


def _scan_inputs(gen, x_shape, dt_shape, A_shape, B_shape):
    """tests/test_kernels.py's distributions: x ~ 0.5 N, dt = softplus(N -
    1), A = -exp(0.3 N) < 0, B and C ~ 0.5 N."""
    import torch
    import torch.nn.functional as F

    x = _randn(gen, x_shape, scale=0.5)
    dt = F.softplus(_randn(gen, dt_shape) - 1.0)
    A = -torch.exp(_randn(gen, A_shape, scale=0.3))
    return x, dt, A, _randn(gen, B_shape, scale=0.5), \
        _randn(gen, B_shape, scale=0.5)


#: the plain scans issue a few launches per token; their timing windows
PLAIN_SCAN_TIMING = dict(reps=3, inner=1, graph=False, warmup=1)
PLAIN_SCAN_NOTE = ("eager, median of 3 windows of one call after one "
                   "warm-up: the plain loop issues several launches per "
                   "token, too many to capture in a graph")


def _ssd_flops(Bt: int, S: int, H: int, P: int, N: int) -> float:
    """The fewest operations of the SSD scan: its chunked form (ssd_scan.cu)
    at the chunk length Q that needs least. Per token and head: 2NP for
    C h0, 2NP + NP/Q for the state update (the decay once a chunk), (Q+1)P
    for the in-chunk product's lower triangle; per token (Q+1)N for C B^T,
    which the heads share. Q = 1 is the recurrence, 5NP; the least is near
    Q = sqrt(N)."""
    return min(Bt * S * (H * (4 * N * P + N * P / Q + (Q + 1) * P)
                         + (Q + 1) * N)
               for Q in range(1, S + 1))


def _capped(name: str, err: float) -> None:
    """Raise unless the full-width error `err` of `name` is within its
    SCAN_CAP; emit the check."""
    if not err <= SCAN_CAP[name]:
        raise AssertionError(f"{name} at full width is {err} off the plain "
                             f"version, over its cap {SCAN_CAP[name]}")
    emit("error_cap", name=name, max_abs_err=err, cap=SCAN_CAP[name])


def phase_kernel_k5() -> dict:
    """K5 (the SSD scan) against its plain version on the card, then its
    front door at full width, then its times."""
    import torch

    from repro_torch.kernels import ops, ref, ssd_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def cases():
        for Bt, S, H, P, N in ((2, 256, 4, 32, 16), (2, 512, 2, 64, 64),
                               (2, 128, 8, 64, 32),  # tests/test_kernels.py:65
                               (1, 100, 3, 40, 6), (1, 128, 2, 80, 128),
                               (1, 1024, 2, 64, 64),
                               # long S at a narrow width (64 chunks), the
                               # 32-token chunks of N > 128, MAX_N, each
                               # with a ragged last chunk
                               (1, 4096, 2, 32, 16), (1, 100, 3, 72, 136),
                               (1, 120, 2, 64, ssd_scan.MAX_N),
                               # odd P, P N % 4 != 0: x staged and y
                               # stored a float at a time, the state pass
                               # one element a thread
                               (1, 128, 2, 37, 5)):
            yield ((Bt, S, H, P, N),
                   _scan_inputs(gen, (Bt, S, H, P), (Bt, S, H), (H,),
                                (Bt, S, N)), "float32")

    _check_grid("ssd_scan", "K5", cases(), ops.ssd_scan, ref.ssd_scan_ref,
                {"float32": SCAN_TOL})

    # full width: zamba2-2.7b's Mamba-2 mixer (configs/zamba2_2_7b.py:
    # d_inner 5120 = 80 heads of 64, state 64) over 4096 tokens, fp32
    Bt, S, H, P, N = 1, 4096, 80, 64, 64
    args = _scan_inputs(gen, (Bt, S, H, P), (Bt, S, H), (H,), (Bt, S, N))
    launches, err = _full_width("ssd_scan", "K5", ops.ssd_scan,
                                ref.ssd_scan_ref, args, SCAN_TOL)
    kernels = ssd_scan.KERNELS  # counted by the library in that one call
    _capped("ssd_scan", err)
    how = ssd_scan.LAST_PLAN
    kernel_t = time_ms(lambda: ops.ssd_scan(*args), reps=10, inner=5)
    plain_t = time_ms(lambda: ref.ssd_scan_ref(*args), **PLAIN_SCAN_TIMING)
    # x, dt, A, B, C read once, y written once
    nbytes = 4 * (2 * Bt * S * H * P + Bt * S * H + H + 2 * Bt * S * N)
    return _report(
        "ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:69",
        launches, err, kernel_t, plain_t, None, nbytes=nbytes,
        flops=_ssd_flops(Bt, S, H, P, N),
        entry={"kernels_per_call": kernels / launches, "chunk": how["chunk"],
               "heads_per_block": how["heads_per_block"],
               "workspace_bytes": how["workspace_bytes"],
               "bytes_bound_ms": _bound(nbytes, 0)["bound_ms"]},
        shape={"Bt": Bt, "S": S, "H": H, "P": P, "N": N,
               "dtype": "float32"},
        plain_timing=PLAIN_SCAN_NOTE, library_call=None)


def phase_kernel_k6() -> dict:
    """K6 (the selective scan) against its plain version on the card, then
    its front door at full width, then its times."""
    import torch

    from repro_torch.kernels import ops, ref, selective_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)

    def cases():
        for Bt, S, d, N in ((2, 256, 128, 8), (2, 512, 256, 16),
                            (2, 256, 512, 16),  # tests/test_kernels.py:48-49
                            (1, 200, 100, 3), (1, 256, 1024, 1),
                            (1, 512, 64, 32), (1, 256, 96, 64),
                            # long S at a narrow width: 64 pieces and a carry
                            (1, 4096, 64, 16),
                            # odd d: x and dt staged 4 bytes a copy
                            (1, 256, 37, 3)):
            yield ((Bt, S, d, N),
                   _scan_inputs(gen, (Bt, S, d), (Bt, S, d), (d, N),
                                (Bt, S, N)) + (_randn(gen, (d,)),),
                   "float32")

    _check_grid("selective_scan", "K6", cases(), ops.selective_scan,
                ref.selective_scan_ref, {"float32": SCAN_TOL})

    # full width: falcon-mamba-7b's mixer (configs/falcon_mamba_7b.py:
    # d_inner = 2 x 4096, state 16) over 4096 tokens, fp32
    Bt, S, d, N = 1, 4096, 8192, 16
    args = _scan_inputs(gen, (Bt, S, d), (Bt, S, d), (d, N), (Bt, S, N)) \
        + (torch.ones((d,), device="cuda"),)
    launches, err = _full_width("selective_scan", "K6", ops.selective_scan,
                                ref.selective_scan_ref, args, SCAN_TOL)
    kernels = selective_scan.KERNELS  # counted by the library in that call
    _capped("selective_scan", err)
    how = selective_scan.LAST_PLAN
    kernel_t = time_ms(lambda: ops.selective_scan(*args), reps=10, inner=5)
    plain_t = time_ms(lambda: ref.selective_scan_ref(*args),
                      **PLAIN_SCAN_TIMING)
    # x, dt, A, B, C, D read once, y written once; 7 operations for each
    # (token, channel, n): dt * A, its exp, two products and an add for the
    # state, a product and an add for y
    return _report(
        "selective_scan", "selective_scan.cu",
        "src/repro/kernels/selective_scan.py:54", launches, err, kernel_t,
        plain_t, None,
        nbytes=4 * (3 * Bt * S * d + d * N + 2 * Bt * S * N + d),
        flops=7 * Bt * S * d * N,
        entry={"kernels_per_call": kernels / launches,
               "nsplit": how["nsplit"], "lanes": how["lanes"],
               "workspace_bytes": how["workspace_bytes"]},
        shape={"Bt": Bt, "S": S, "d": d, "N": N, "dtype": "float32"},
        plain_timing=PLAIN_SCAN_NOTE, library_call=None)


def _ssd_model_scan(x, dt, A, B, C):
    """The port's zamba2 mixer scan (models/ssm.py): `_ssd_chunk` over the
    model's 256-token chunks, the state carried from one to the next (no
    D skip, as K5 has none)."""
    import torch

    from repro_torch.models import ssm

    Bt, S, H, P = x.shape
    n_chunks, Q = ssm._chunking(S, ssm._CHUNK)
    h = torch.zeros((Bt, H, P, B.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(n_chunks):
        sl = slice(c * Q, (c + 1) * Q)
        h, y = ssm._ssd_chunk(h, x[:, sl], dt[:, sl], B[:, sl], C[:, sl], A)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _m1_model_scan(x, dt, A, B, C, D):
    """The port's falcon-mamba mixer scan (models/ssm.py `mamba1_mix`
    between its conv and its gate): `_m1_scan_chunk` over the model's
    256-token chunks with the chunk body's dA and dBx, the state carried,
    then the D skip."""
    import torch

    from repro_torch.models import ssm

    Bt, S, d = x.shape
    n_chunks, Q = ssm._chunking(S, ssm._CHUNK)
    h = torch.zeros((Bt, d, A.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(n_chunks):
        sl = slice(c * Q, (c + 1) * Q)
        dA = torch.exp(dt[:, sl, :, None] * A)
        dBx = (dt[:, sl] * x[:, sl])[..., None] * B[:, sl, None, :]
        h, y = ssm._m1_scan_chunk(h, dA, dBx, C[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1) + x * D


def phase_ssm_scans(k5: dict, k6: dict) -> None:
    """K5 and K6 held to the models' own scans on the card, as
    tests/test_kernels.py:78-98 holds the Pallas SSD kernel to the
    model's: K5 at zamba2-2.7b's full-width mixer (Bt=1, S=4096, H=80,
    P=64, N=64, fp32) against `_ssd_chunk` over 256-token chunks; K6 at
    falcon-mamba-7b's (Bt=1, S=4096, d=8192, N=16, fp32) against the
    Mamba-1 chunk scan with its D skip. Each error within SCAN_CAP; both
    times printed (the models' scans eagerly: thousands of launches).
    This only measures: the models call neither kernel. Adds the numbers
    to the K5 and K6 entries."""
    import torch

    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    cases = (
        ("ssd_scan", k5, ops.ssd_scan, _ssd_model_scan,
         _scan_inputs(gen, (1, 4096, 80, 64), (1, 4096, 80), (80,),
                      (1, 4096, 64))),
        ("selective_scan", k6, ops.selective_scan, _m1_model_scan,
         _scan_inputs(gen, (1, 4096, 8192), (1, 4096, 8192), (8192, 16),
                      (1, 4096, 16)) + (_randn(gen, (8192,)),)))
    for name, entry, door, model, args in cases:
        with torch.no_grad():
            out = door(*args)
            expect = model(*args)
        torch.cuda.synchronize()
        err = _max_err(out, expect)
        del out, expect
        if not err <= SCAN_CAP[name]:
            raise AssertionError(f"{name} is {err} off the model's scan, "
                                 f"over its cap {SCAN_CAP[name]}")
        with torch.no_grad():
            kernel_t = time_ms(lambda: door(*args), reps=10, inner=5)
            model_t = time_ms(lambda: model(*args), **PLAIN_SCAN_TIMING)
        numbers = {"model_scan_max_abs_err": err,
                   "model_scan_ms": model_t["device"],
                   "model_scan_kernel_ms": kernel_t["device"]}
        emit("ssm_scans", name=name, cap=SCAN_CAP[name],
             shape=[list(a.shape) for a in args],
             model_timing=PLAIN_SCAN_NOTE, **numbers)
        entry.update(numbers)
        del args
    torch.cuda.empty_cache()


def main() -> int:
    import repro_torch  # noqa: F401  (fails outside a checkout)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    env = phase_env()
    alone = {"lm_sharded": phase_lm_sharded,
             "lm_init_sharded": phase_lm_init_sharded,
             "lm_sharded_moe": phase_lm_sharded_moe,
             "lm_decode": phase_lm_decode,
             "lm_decode_smoke": phase_lm_decode_smoke,
             "lm_sharded_plan": phase_lm_sharded_plan,
             "dryrun_memory": phase_dryrun_memory}
    if len(sys.argv) >= 2 and all(a in alone for a in sys.argv[1:]):
        # these phases launch no kernel of the port: no build
        if not set(sys.argv[1:]) <= {"lm_sharded_plan", "dryrun_memory"}:
            phase_build()
        for name in sys.argv[1:]:  # those phases alone (no result line)
            alone[name]()
        print(env["nvidia_smi"], flush=True)
        return 0
    build_s = phase_build()
    plan = _start_plan_child()
    try:
        result = _default_run(build_s)
        _finish_plan_child(plan)
    finally:
        if plan.poll() is None:
            plan.kill()
            plan.wait()
    print(json.dumps({"kernels": result}), flush=True)
    print(env["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _default_run(build_s) -> list:
    """Every phase of the default run after the build, in order; returns
    the kernels' entries of the last JSON line."""
    k1 = phase_kernel()
    k2 = phase_kernel_k2()
    phase_manifests()
    k1["launches"] = phase_main_path()
    k2["launches"] = phase_main_path_compressed()
    sweep = phase_sweep()
    k1["sweep_launches"] = sweep["gossip_mix"]
    k2["sweep_launches"] = sweep["compress_mix"]
    adaptive = phase_adaptive()
    k1["adaptive_launches"] = adaptive["gossip_mix"]
    k2["adaptive_launches"] = adaptive["compress_mix"]
    phase_netsim()
    serve = phase_serve()
    k1["serve_launches"] = serve["gossip_mix"]
    k2["serve_launches"] = serve["compress_mix"]
    lm = phase_lm()
    k1["lm_launches"] = lm["launches"]
    k1["lm_call"] = lm["call"]
    phase_lm_ranks(lm)
    sharded = phase_lm_sharded()
    k1["lm_sharded_launches"] = sharded["launches"]
    k1["lm_sharded_local_shard_call"] = sharded["local_shard_call"]
    phase_lm_init_sharded()
    k1["lm_expert_leaf_call"] = phase_lm_k1_expert_leaf()
    lm_moe = phase_lm_moe_full()
    k1["lm_moe_launches"] = lm_moe["launches"]
    k1["lm_moe_comm_step_ms"] = lm_moe["k1_comm_step_ms"]
    k1["lm_moe_smoke_launches"] = phase_lm_moe_smoke()
    k1["lm_sharded_moe_launches"] = phase_lm_sharded_moe()
    lm_ssm = phase_lm_ssm_full()
    k1["lm_ssm_launches"] = lm_ssm["launches"]
    k1["lm_ssm_comm_step_ms"] = lm_ssm["k1_comm_step_ms"]
    lm_hybrid = phase_lm_hybrid_full()
    k1["lm_hybrid_launches"] = lm_hybrid["launches"]
    k1["lm_hybrid_comm_step_ms"] = lm_hybrid["k1_comm_step_ms"]
    k1["lm_ssm_smoke_launches"] = phase_lm_ssm_smoke()
    phase_lm_decode()
    phase_lm_vlm()
    phase_lm_decode_smoke()
    phase_dryrun_memory()
    k3 = phase_kernel_k3()
    k4 = phase_kernel_k4(build_s)
    k5 = phase_kernel_k5()
    k6 = phase_kernel_k6()
    phase_ssm_scans(k5, k6)
    return [k1, k2, k3, k4, k5, k6]


if __name__ == "__main__":
    sys.exit(main())
