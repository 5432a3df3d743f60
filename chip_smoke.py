#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA card and check every kernel it uses.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card; the kernels
are built from the checkout's sources at first use. Phases, one JSON line
each:

1. environment: the card (nvidia-smi's name and power limit), torch and
   CUDA versions, then the kernel build time and ptxas's report (registers
   and spills of every LM-loss backward instance by name; a spill in a
   tensor-core one fails), and on the same ``build`` line the g++ build of
   the FasterTokenizer's native library (core/native/tokenizer.cc).
2. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and a few edge cases, with kernel, plain, bound and
   library (yardstick only) times: the flash forward (bf16 on the bf16
   tensor cores, f32 on the TF32 tensor cores in 3xTF32, each with its FMA
   predecessor checked and timed beside it), then the FA2 backward's dK/dV
   and dQ kernels (the same routes, each with the FMA pair checked and
   timed beside it), with SDPA's FA2 (flash backend) forward and backward
   pinned as the bf16 yardstick and SDPA's default dispatch as the f32 one;
   the bf16 kernels also at gpt_1p3b's [4, 2048, 16, 128], timed, and at
   ERNIE-3.0-base's [16, 512, 12, 64] non-causal (bf16 forward and pair,
   f32 forward), timed.
3. scoring forward of GPT-2 124M (random weights from a seed), ids [8, 1024]:
   the flash kernel (the 3xTF32 one: scoring is f32) must launch exactly
   once per layer, the logits must be
   finite and the last position of one sequence must match the same
   weights run on the CPU.
4. serving: ServingEngine answers 8 greedy requests of 17-500 prompt tokens;
   requests re-run solo give the same tokens, and the bucketed prefill's
   logits (dense masked attention) match the scoring forward's (kernel).
4a. serve_paged: the same model served under bf16 auto_cast (O1) from the
   contiguous cache, from bf16 pages and from int8 pages, and in f32 from
   the contiguous cache and from pages (8 slots, 64-token pages, 258 pages),
   32 requests of 64 new tokens submitted at once: 8 cold greedy prompts
   (A), 12 greedy prompts behind one 256-token system prefix (B: a miss,
   then partial prefix hits), 4 copies of one 192-token prompt (C: a miss,
   then full hits that skip the prefill) and 8 sampled prompts (D). Hard:
   the cache dtypes and kv_cache_bytes; paged tokens equal contiguous ones
   for A and D at both dtypes, and for B and C at f32 but at a near-tie of
   the scoring forward's logits (LOGITS_TOL); the partial hits' tail
   prefill logits against the whole prompt's (LOGITS_TOL at f32, BF16_TOL x
   max|ref| at bf16); 29 prefills, 3 skips and 14 prefix hits a paged run;
   no page in use after it, none evicted, the zero page still zero; int8
   pages within absmax/127 x 0.5 of the bf16 pages at layer 0 (later layers
   read int8 K/V, their error is printed) and at most 0.55x their bytes.
   Printed: TTFT and admission-to-first-token by class (miss, partial and
   full hit), decode tokens/s, kv_cache_bytes, the most pages in use, the
   prefix hit rate, int8 against bf16 tokens, wall seconds.
4b. serve_spec: speculative decoding on the same model (f32 and bf16 O1, 8
   slots, spec_ladder (4,)), 16 requests of 64 new tokens at once: 12 greedy
   prompts of 17-400 tokens, every other one speculating (one given an eos
   that fires inside a window), and 4 sampled ones (T 0.8, top_k 50, top_p
   0.95), two speculating. Six engines: no draft (the baseline); the
   target as its own draft (self) and a 2-layer draft of the same width
   from seed 1 (reject), contiguous and paged (64-token pages; the paged
   runs submit the 128-token speculating prompt once more, a full-hit
   replay seat); the self draft under bf16 O1. Hard: greedy tokens equal
   the baseline's but at a near-tie of the scoring forward's logits
   (LOGITS_TOL; bf16 BF16_TOL x max|logit|), the non-spec sampled ones
   exactly (f32); the self draft's f32 greedy acceptance >= 0.9, the reject
   draft's proposals >= 100; the spec counters equal the requests' counts,
   proposals equal the windows' n_draft and accepted + bonus <= emitted;
   paged: no page in use after the run, the replay seat speculated, the
   zero page still zero, and the reject draft's rollbacks freed pages;
   the draft cache in the target's cache dtype. Printed: decode tokens/s
   against the baseline's, verify dispatches and target forwards per
   emitted token, acceptance, verify dispatch and decode chunk ms (p50,
   max), pages freed by rollback, wall seconds.
4c. serve_fleet: the serving fleet on the same model (f32, paged, 64-token
   pages, ladder (64, 128, 256), max_seq_len 512): a loadgen Scenario (seed
   7, 48 Poisson arrivals over 3.27 s from 4 Zipf tenants, each with its
   own 192-token prefix, tails of 16-64 tokens, 32 new tokens, greedy).
   Reference: one 16-slot engine serves all 48 at once. Fleet: a
   ReplicaRouter over two 8-slot replicas r0 and r1 (stepped one after the
   other on the card's one stream), driven by LoadGenerator.run on the wall
   clock, tracer and metrics registry on; r0 begins draining at the first
   submission from the 24th on that lands on it. Hard: every request's
   tokens equal the reference's but at a near-tie of the scoring forward's
   logits (LOGITS_TOL); prefix_routed > 0; r0 admits nothing after its
   drain and every re-placed request completes on r1; route.requests and
   serve.requests 48, route.replaced the number re-placed, both in the
   registry's Prometheus text; from the written chrome trace, every
   request's serve.queue_wait, serve.prefill and serve.decode carry its
   request id and its route.place span id as parent; r0 drained, removed,
   and the card's allocated bytes fall by at least its pages and weights.
   Then SIGTERM in mid-decode on a third engine (admission closes, drain()
   completes the 8 requests, one preemption counted, no page in use), a
   drain(timeout_s=0) on a fourth (8 requests "drained", pages released),
   and a CapacityController (injected clock) that scales out on a page
   alert through a spawn on the card (r1 shed: the spawned r2 serves 8
   requests, the reference's tokens) and back in, reaping r2. Printed with
   the card's name and power limit: both decode tokens/s, p50 route.place
   host us, elastic.drain_ms, r0's drain, the phase's seconds.
4d. quant: int8 quantization (incubate/quantization.py) on the same model:
   bench_decode's run (8 rows, 128-token prompt, 64 new tokens, bf16 O1,
   the second of two calls) of the model, of its weight-only int8 copy and
   of a dynamic int8 copy in turns (plain, int8, dynamic, dynamic, int8,
   plain), with the CUDA kernels a decode token launches; each model's card
   bytes against those reckoned from GPTConfig (243431424 against
   497903616). Hard: the weight-only model's int8 weights and scales equal
   the CPU's, its f32 scoring logits of ids[:1] within LOGITS_TOL of the
   CPU's with 12 launches of the 3xTF32 flash forward; the int8
   activations and int32 accumulators of a dynamic and a static projection
   (qkv and fc2 at 8 and 1024 rows) bit-equal to the CPU's; the weight-only
   model served (f32, 8 slots, contiguous and 64-token pages) gives each of
   8 greedy requests the tokens of its own greedy generate but at a
   near-tie (LOGITS_TOL); QAT (ImperativeQuantAware on a fresh 124M, one
   eager calibrating forward, then 1 + 3 TrainStepEngine steps, AdamW
   1e-4, bf16 O1): finite falling losses, 12 tensor-core launches of each
   flash kernel a step, every activation scale unmoved inside the engine,
   then convert to weight_only_int8 and a greedy bf16 generate; PTQ: 48
   scales from two calibration batches, static_int8 and a greedy f32
   generate. Printed with the card's name and power limit: decode tokens/s
   of the three, kernels a token, card bytes, the int8 and bf16 GEMM ms at
   [1024, 768] x [768, 2304], the QAT step ms, the phase's seconds.
5. profile: torch.profiler's CUDA kernel time in one scoring forward and in
   one decode chunk (contiguous, then paged), over their untraced wall time
   (the device's busy share), with the kernels that take the most time.
6. train: TrainStepEngine steps of GPT-2 124M on ids [8, 1024] with
   labels = roll(ids, -1), AdamW(1e-4, weight_decay 0.01), under the port's
   bf16 auto_cast (bench.py's step): 3 warm-up and 10 timed steps on one
   batch. Every step launches each of the three kernels once per layer
   (all three on the tensor cores);
   the loss is finite and falls; every gradient is finite and not all zero.
   Step time, tokens/s, peak memory, and one profiled step's busy share;
   then 1 + 3 steps of the same step in f32 (train_f32: 12 launches a step
   of each 3xTF32 kernel, the forward and the backward pair), its step time
   and one profiled f32 step.
6a. train_rules: the optimizer surface on the same step (GPT-2 124M, ids
   [8, 1024], bf16 O1), every case from the same seed-0 weights. Eight
   engines, 1 + 3 steps each, each rule with a scheduler: Adamax +
   OneCycleLR + ClipGradByGlobalNorm(group_name, auto_skip_clip), Adagrad +
   PiecewiseDecay, Adadelta + ExponentialDecay, centered RMSProp with
   momentum + CosineAnnealingWarmRestarts, Lamb (LayerNorm weights and
   biases excluded from its decay) + NoamDecay, Lars + MultiStepDecay,
   AdamW with weight_decay=L2Decay(0.01) + CyclicLR, Adam +
   ReduceOnPlateau fed the loss. Then the eager path, 3 steps each:
   GradScaler around LookAhead(AdamW, k=2), ModelAverage (apply() then
   restore() gives the parameters back bit for bit), Momentum with
   L1Decay after clip_grad_norm_, and amp.decorate(level="O2") with AdamW
   (parameters bf16, state f32). Hard: 12 tensor-core launches of each
   flash kernel a step, finite falling losses, the JAX package's state
   slots (count, f32, the parameter's shape), the learning rates the
   steps read equal to the schedulers' host twins. Printed: step ms and
   peak memory of each case.
6b. train_obs: the train step's observability and its last entry points
   on the same step (GPT-2 124M, [8, 1024], AdamW 1e-4, bf16 O1). Hard:
   3 steps from one saved state with everything off and with telemetry
   (the bench's flop model), the health monitor at interval 1, the flight
   recorder, the metrics registry and the tracer on give the same losses
   and parameters bit for bit; one more step's health record holds every
   parameter's grad norm, weight norm and update ratio within 1e-4 of a
   plain recomputation from its gradient and weights (OBS_HEALTH_RTOL),
   no non-finite entry; an inf gradient hooked onto OBS_POISON is named by
   the record (and no other parameter) and dumped (health_nonfinite);
   every telemetry record has 8192 tokens, mfu = tokens/s x flops a token
   / 989 TFLOP/s and a peak within the card's memory; run_steps(steps=4)
   equals 4 steps bit for bit and saves at step 4 for an interval of 3;
   prefetch at depth 2 over 4 host batches gives step()'s losses bit for
   bit, with 8 pinned side-stream copies and depths 2, 2, 2, 1 in the
   records; train.step_ms and ckpt.save_ms have counts; every step
   launches each flash kernel 12 times on the tensor cores (50 steps in
   the phase). Printed: the step ms (median and mean of 6, in two turns)
   with everything off, with telemetry, with health at interval 1 and at
   interval 10, the telemetry's MFU beside the bench's for the same step,
   the h2d issue ms, and one traced step off and at health interval 1
   (kernel ms, top kernels).
7. train_vs_cpu: one f32 step at full width and 2 layers, ids [1, 1024], on
   the card (the 3xTF32 forward and backward pair) and on the CPU (plain
   path): loss and every gradient. Then the same step with each of the six
   new rules on the card: loss and gradients at the same bars; the new
   parameters and state against the rule run on the CPU on the card's own
   gradient (RULE_STEP_TOL) and against the CPU's whole step
   (RULE_FLIP_LRS x lr).
7a. dp: data parallelism (phase_dp) at one rank a card, in processes of
   the port's spawn with a deadline of their own: GPT-2 124M, global ids
   [8, 1024], through fleet.init -> fleet.distributed_engine: the
   replicated f32 reduce (at world 1 the single-GPU engine's steps bit for
   bit), ZeRO (bit for bit up to 2 ranks), the bf16 and int8 payloads with
   and without error feedback and ZeRO's bf16 and int8 (losses within 2e-2
   of the f32 trajectory; the first step's reduced gradient within the
   payload's rounding of the f32 run's, element by element), FSDP at
   prefetch depths 0 and 2, f32 and bf16 and int8 with error feedback
   (f32 bit for bit against the replicated run up to 2 ranks; every depth
   the same bits; its int8 bound on its own chunk grid, the padded
   buckets), 12 tensor-core launches of each flash kernel a step a rank,
   the byte counters against the payload functions, ZeRO's peak memory
   and FSDP's allocated bytes after the steps past one rank; step ms,
   tokens/s per chip, peaks and bytes held after the steps, payload
   bytes, the f32 payload's all_reduce time and bus bandwidth.
7d. dp_eager: the eager data-parallel entry points (_dp_eager_checks) at
   one rank a card, in the dp phase's processes (ranks_worker runs a rank
   of dp, then of dp_eager; one deadline for both): GPT-2 124M on each
   rank's rows of the global ids [8, 1024], 1 + 3 steps a run of
   fleet.init -> fleet.distributed_model (DataParallel past one rank) ->
   fleet.distributed_optimizer (the meta chain in HybridParallelOptimizer)
   -> loss.backward(); opt.step(); opt.clear_grad():
   f32, bf16 through strategy.amp, strategy.lamb, gradient merge (k 2, avg),
   dgc (sparsity 0.999), fp16_allreduce, group_sharded_parallel os_g without
   and with offload; the engine's step (f32, bf16 through strategy.amp, 2
   microbatches) as the yardstick. Hard: f32 eager and gradient merge are
   the engine's step (bit for bit at world 1, within 1e-5 x max(1, max|p|)
   past it); offload is the run without it bit for bit, with its state in
   pinned host memory and 0.8 x 8n fewer bytes on the card; Lamb swapped in;
   DGC kept >= k entries of every gradient; every loss finite and falling;
   12 launches a step of each flash kernel on its dtype's route; past one
   rank one collective a Reducer bucket a step and the same weights on
   every rank. Printed: step ms and tokens/s per card of eager and engine,
   peaks and after-step bytes, buckets and collectives a step.
7c. ckpt: checkpoints (distributed/elastic.py) at GPT-2 124M, bf16
   auto_cast: 4 steps with async saves every 2; a fresh engine restores
   step 2 and takes steps 3 and 4 bit for bit (losses, parameters,
   optimizer slots); a flipped byte in the newest checkpoint fails fsck
   and restore_latest falls back; the capture's ms, the writer's ms and
   the bytes. On two cards or more also ckpt_ranks: an FSDP checkpoint
   saved at N ranks restores at N / 2 (FSDP) and at 1 (replicated) with
   every parameter bit for bit; the save's peak above the bytes held
   before it within two of the largest bucket.
7b. bench: the port's bench.py counterpart (paddle_tpu_torch.bench.run) in
   this process, bf16 auto_cast: medium (gpt_345m, [8, 1024], 2 + 10 steps in
   3 windows: tokens/s a window, spread, MFU against 989 TFLOP/s, peak
   memory, 24 tensor-core launches a step of each flash kernel, one
   profiled step); base with 4 in-program microbatches against 1 (peak
   memory lower at 4); medium under full and selective recompute (48
   forwards a step with the replay, 24 of each backward kernel; peak memory
   under full below the run without recompute); gpt_1p3b ([4, 2048], head
   dim 128) under full recompute; greedy decode at base (decode tokens/s,
   slot independence). Every loss finite and, but for gpt_1p3b's 3 steps,
   falling.
8. library_ops, the direct-call LayerNorm and LM-loss ops (the JAX
   package's examples/pallas_library_ops.py at full width): each of their
   six kernels against its plain version at GPT-2 124M's shapes (LayerNorm
   [8192, h] f32 and bf16 at h = 768, 1024 and 2048, after the events'
   floor, each with its share of the bytes bound; LM loss h [8192, 768],
   W [50304, 768], bf16 h
   with an f32 W and f32, plus vocab 50257, a bf16 W and labels of -100,
   at both dtypes of h; f32 at gpt_345m's hidden 1024 and at 2048, and bf16
   h at gpt_1p3b's 2048), with kernel, plain, bound and library times. The
   LM-loss routes: bf16 h takes the bf16 tensor-core forward and backward
   (their times include the bf16 copy of the f32 W, timed beside them); f32
   h the 3xTF32 tensor-core forward and backward (f32 accuracy; the
   gradients held also in relative Frobenius norm); past the one-CTA tiles
   (f32 H > 768, bf16 H > 1536) the backwards split the hidden dim across a
   thread-block cluster; the FMA kernels are checked and timed beside every
   tensor-core one as the redesign's predecessors. Then the
   composition they exist for: the 124M model's hidden state before ln_f
   through the kernel LayerNorm and the kernel LM loss with the tied
   embedding, in f32 (loss and the gradients of wte and ln_f against the
   model's own route; the 3xTF32 forward and backward) and with the hidden
   state cast to bf16 before the bf16 LayerNorm (its output, loss, dh, dwte
   and ln_f's gradients against the plain versions; the bf16 tensor-core
   backward). Each kernel of a pass launches once in it.
9. lmloss_compile_probe: the LM-loss forward's stripped variants at the
   probe's defaults, checked and timed, with ptxas's registers and spills.
7e. tp_sp: tensor and sequence parallelism (phase_tp_sp). On one card:
   each flash kernel on both routes (bf16 tensor cores, f32 3xTF32) at
   the ring's block shape [8, 256, 12, 64], causal (the diagonal block)
   and not (a past block), against its plain version (the kernel phases'
   limits); ring_attention_virtual (distributed/meta_parallel/
   sequence_parallel.py: P ranks of the ring run on one card) at P = 2
   and 4 over [8, 1024, 12, 64] causal, bf16 and f32, forward and the
   backward of sum(o * dO), against flash_attention over the whole
   sequence: o, dq, dk, dv within BF16_TOL / F32_TOL (GRAD_F32_TOL for an
   f32 gradient) of max|ref| and within RING_BF16_FROB_TOL /
   RING_F32_FROB_TOL in each (b, h) head's relative Frobenius norm, and
   exactly P (P + 1) / 2 launches of the forward and of each backward
   kernel on the dtype's route (10 at P = 4) and none on another; the
   ring's and the whole kernel's forward + backward ms. Then, in a spawned
   rank (which goes on to run phase 7f's one-card rank), GPT-2 124M's bf16
   step (ids [8, 1024], AdamW 1e-4) built on the mp layers through
   fleet.init -> fleet.distributed_engine at mp_degree = 1 equals
   phase_train's engine from the same weights bit for bit over 3 steps,
   losses and every parameter, with 12 tensor-core launches of each flash
   kernel a step. On two cards or more also, one rank a card through
   fleet.init -> fleet.distributed_engine, GPT-2 124M on the global ids
   [8, 1024], 3 steps at f32 and 3 at bf16 a run: at four cards dp 2 x mp
   2, mp 4, dp 2 x sp 2 ring, sp 4 Ulysses and mp 2 x sp 2 ring (at two,
   mp 2 and sp 2 ring). Hard: every loss finite and falling; f32 losses
   within TP_SP_F32_RTOL of the one-card f32 engine's on the same batch
   and weights, bf16 within TP_SP_BF16_RTOL of the run's f32; every rank
   launches 12 x (its causal ring blocks: sp rank + 1; else 1) of each
   flash kernel a step, on the dtype's route. Printed: step ms, tokens/s
   per card, peak bytes per rank and flash forwards a step per rank.
7f. pp: pipeline and expert parallelism (phase_pp). On one card: each
   flash kernel on both routes, causal, at the pipe's micro-batch shapes
   [4, 1024, 12, 64] and [2, 1024, 12, 64], against its plain version (the
   kernel phases' limits); GPT-2 124M's GPTForPretrainingPipe (weights
   converted from GPTForPretraining(seed=0)'s, ids [8, 1024]) through
   distributed/pipeline_schedule.py over a VirtualRing (all stages on
   this card) at S = 2 and 4 (V = 1) and S = 2, V = 2, M = S micro-batches,
   f32 and bf16: the loss and every parameter's gradient against the same
   Pipe at pp = 1 in relative Frobenius norm (PP_RING_F32_FROB_TOL /
   PP_RING_BF16_FROB_TOL), and exactly 12 S launches of each flash kernel
   on the dtype's route; then, in phase 7e's spawned rank, the Pipe through
   fleet.init -> fleet.distributed_model -> fleet.distributed_engine at
   pp_degree = 1, 3 f32 and 3 bf16 steps (AdamW 1e-4): f32 losses within
   TP_SP_F32_RTOL of phase_train's model's f32 engine on the same batch and
   weights, bf16 within TP_SP_BF16_RTOL of the f32 ones, 12 launches a step
   of each flash kernel on the dtype's route. MoELayer at d_model 768,
   d_hidden 3072, 8 experts, top_k 2, capacity 1.25 over 8192 tokens: f32
   output and every gradient within MOE_F32_FROB_TOL (relative Frobenius)
   of the same layer on the CPU; bf16 under auto_cast finite. On two cards
   or more also, one rank a card: at four cards pp 4, pp 2 x dp 2, pp 2 x
   mp 2 and pp 2 x dp 2 at V = 2 (at two, pp 2), 4 micro-batches, f32 and
   bf16, 3 steps each, against the one-card f32 engine (TP_SP_F32_RTOL) and
   the run's f32 (TP_SP_BF16_RTOL); every rank launches its stage's layers
   x V x 4 of each flash kernel a step (bubble ticks run no body), on the
   dtype's route. Printed: losses, step ms, tokens/s per card, peak bytes
   and flash forwards a step per rank, the schedule's ticks and bubble
   share; the MoE's forward + backward ms and peak bytes.
11. vision: BASELINE config 2 (phase_vision). ResNet-50 (seed 0) at
   [128, 3, 224, 224], 1000 classes, through TrainStepEngine(model,
   Momentum(0.1, 0.9), loss_fn=CrossEntropyLoss()) (what
   fleet.distributed_engine builds at one card), 3 warm-up and 10 timed
   steps on one batch: bf16 O1 (one profiled step), f32 with cuDNN's TF32
   off (the script's policy: f32 is f32) and f32 with it on (PyTorch's
   default for convolutions). Hard: every loss finite, falling over the
   warm-up steps (later steps of Momentum 0.1 on one batch of random
   labels swing), finite running statistics. Then ResNet-18 (10 classes) at [8, 3, 64, 64], one
   f32 engine step on the card and on the CPU from the same weights: the
   loss (TRAIN_LOSS_RTOL), each parameter's update (VISION_GRAD_TOL) and
   each running statistic (VISION_STATS_TOL). On two cards or more also
   ResNet-50 at dp = cards through fleet.init -> fleet.distributed_engine
   (batch norm's statistics over the ranks' global batch), f32,
   MULTI_CARD_STEPS steps: the first loss within MULTI_CARD_FIRST_RTOL and
   the later ones within VISION_MULTI_RTOL of the one-card engine's on the
   same global batch, the same running statistics on every rank. Printed: images/s, step ms and peak memory of each run,
   with the card's name and power limit.
12. ernie: BASELINE config 3's model (phase_ernie). ERNIE-3.0-base (seed 0)
   at [16, 512] with 15% MLM labels, token types and NSP labels, bf16 O1,
   AdamW(1e-4), 2 warm-up and 5 timed steps of each: at the published
   dropout (0.1, 0.1) with a padding mask (the dense attention path: no
   flash launch) and at attention_dropout = 0 with no mask (12 tensor-core
   launches a step of the flash forward and of each backward kernel,
   non-causal). Then the eval forward in f32 with no mask (12 launches of
   the 3xTF32 flash forward; hidden states within LOGITS_TOL of the same
   forward through the dense path) and one f32 step of ernie_tiny at [4,
   128] on the card (the 3xTF32 forward and pair) and on the CPU: the loss
   and every gradient (ERNIE_VS_CPU_TOL). On two cards or more also
   ERNIE-3.0-base (no dropout, no mask) at sharding_degree = cards (ZeRO)
   through fleet, f32, MULTI_CARD_STEPS steps: the first loss within
   MULTI_CARD_FIRST_RTOL and the later ones within MULTI_CARD_RTOL of the
   one-card engine's, each rank holding 1/cards of the optimizer state. Printed: tokens/s, step ms and peak memory of each
   step kind, with the card's name and power limit.
13. mnist: BASELINE config 1 (phase_mnist): the MNIST LeNet dygraph
   example (paddle_tpu_torch/examples/train_mnist_dygraph.py) at its size:
   LeNet (seed 0), Adam(1e-3), CrossEntropyLoss, the synthetic MNIST of 512
   samples in batches of 64 from a DistributedBatchSampler seeded by the
   epoch, DataLoader(num_workers=2), 3 epochs (after one untimed epoch),
   on the card and on the CPU with the same weights and batches: each epoch's mean loss within
   MNIST_CPU_RTOL of the CPU's and the last below MNIST_FALL x the
   first's. hapi's Model.fit with Accuracy() on the same batches from the
   same weights gives the loop's losses bit for bit (cuDNN deterministic
   for the phase), evaluate on mode="test" reads accuracy above
   MNIST_MIN_ACC, and fit(accumulate_grad_batches=2) without metrics takes
   the engine route with a falling loss. The trained LeNet saved and loaded
   into a fresh one gives its logits bit for bit. Then the checkpoints'
   buffers: ResNet-18 (10 classes) at [16, 3, 32, 32] takes 3 engine
   steps, saves, and 2 more; a fresh engine restored from the checkpoint
   takes the same 2: its losses, batch norm's running statistics and eval
   logits are the uninterrupted run's bit for bit. Printed with the card's
   name and power limit: images/s of the loop and of fit, reader_cost's
   share of fit, the device's busy share over one epoch (torch.profiler),
   the phase's seconds. No kernel of ops/kernels/ runs on this path.
14. rec: BASELINE config 5 (phase_rec): Wide&Deep through
   paddle_tpu_torch/tools/northstar_bench.py's widedeep leg at full width
   (vocab 1,000,000, 26 sparse fields, 13 dense features, embedding dim 8,
   the tower (128, 64, 32), batch 512, Adam(1e-3) on the tower; both tables,
   wide dim 1 and deep dim 8, on a live PSServer in host RAM with
   server-side SGD at lr 0.05; 2 untimed and 30 timed steps; ids, features
   and labels from RandomState(0)), then the same leg on the CPU for
   REC_CHECK_STEPS steps on a fresh server: each of those steps' losses
   within REC_CPU_RTOL and the rows of REC_SAMPLE pulled ids in both tables
   after them within REC_ROWS_ATOL; the CPU run's pushes must have moved
   those rows (each row's largest entry, against a fresh server's pull of
   the same ids) by at least REC_ROWS_MIN_MOVE and past REC_ROWS_ATOL for a
   share REC_ROWS_MOVED_SHARE of them, so that a push the card missed
   shows. DeepFM with trainer-side tables ([1e6,
   8] and [1e6, 1] on the card) at the same widths, DEEPFM_STEPS steps,
   losses within DEEPFM_CPU_RTOL of the CPU's. Then the launcher's PS mode
   (python -m paddle_tpu_torch.distributed.launch --run_mode ps --server_num
   2 --trainer_num 2) over the port's Wide&Deep example, both trainers on
   this card: exit 0, finite losses of both trainers, and each server's
   saved tables hold exactly the ids of the batches with id % 2 equal to
   its index. Printed with the card's name and power limit: Wide&Deep
   examples/s over the 30 timed steps, the step's shares in pull_sparse and
   push_sparse, the device's busy share over REC_PROFILE_STEPS steps,
   DeepFM examples/s, the pod's wall seconds and the phase's. No kernel of
   ops/kernels/ runs on this path.
15. tensor_api: the tensor API (paddle_tpu_torch's top-level namespace;
   phase_tensor_api). Every function of the namespace, from the table of
   tensor_api_cases (which fails when a name of ops.__all__ has no case),
   on the card against the CPU on inputs seeded with numpy: values equal
   for integer, bool and index results and within TENSOR_API_TOL by result
   dtype for floats, decompositions by reconstruction
   (TENSOR_API_REC_TOL) and their unique parts, random ops by dtype,
   shape, device, range and moments over TENSOR_API_DRAWS draws and the
   same draws after seed on the card's generator. Then GPT-2 124M's block
   0 (seed-0 GPTForPretraining) on x = wte(ids) + wpe at [8, 1024, 768],
   written only in the namespace (tensor_api_block: matmul, reshape,
   transpose, split, softmax, a triu / where mask, LayerNorm from mean,
   var and rsqrt, the tanh GELU, add), against GPTBlock.forward at f32
   and under bf16 auto_cast O1: the output and the gradients (by
   paddle_tpu_torch.grad against torch autograd) of x and every parameter
   within BLOCK_F32_TOL / BLOCK_BF16_TOL relative Frobenius, one launch of
   each flash kernel on the dtype's route in GPTBlock's checked call.
   Printed: both forward + backward ms, the errors, the phase's seconds
   (at most TENSOR_API_MAX_S). No kernel of ops/kernels/ runs in the
   namespace's ops. The table also holds the nn API's second half
   (nn_api_cases, which fail when a name of NN_FUNCTIONAL_NEW,
   NN_LAYERS_NEW, nn.initializer or nn.utils has no case): each new
   nn.functional op on the card against the CPU as above; each new layer
   built on the CPU and a copy on the card, in eval, on the same inputs;
   each initializer through create_parameter on the card (deterministic
   ones equal to the CPU's, random ones by moments, bounds and the same
   draws after seed, Orthogonal by |q^T q - I| < NN_ORTHO_TOL); nn.utils on
   a Linear and its copy; the dropouts of this slice by their generator and
   keep share, class_center_sample by its set.
16. nn_transformer: paddle_tpu_torch.nn.TransformerEncoder at
   ERNIE-3.0-base width (phase_nn_transformer): d_model 768, 12 heads
   (head dim 64), dim_feedforward 3072, 12 layers, gelu, post-norm, no
   dropout, no mask, weights from nn.initializer after seed(0). f32 at [2,
   512]: the card (the 3xTF32 flash forward and pair, 12 launches each)
   against the same module on the CPU and against it in f64 on the card,
   the output and every gradient of sum(out * w) within NN_TF_F32_TOL +
   NN_TF_F32_COND x the CPU's own error against f64, relative Frobenius,
   leaf by leaf (python -m paddle_tpu_torch.tools.nn_transformer_control
   reads the same check with the flash kernels' 3xTF32 product cut to two
   or one TF32 pass). bf16 auto_cast O1
   at [16, 512]: one forward + backward with 12 tensor-core launches of the
   flash forward and of each backward kernel, non-causal (the main path's
   count on the kernels line, rows 1e-3e), its output within
   NN_TF_BF16_TOL of the card's f32 output, then timed. A MultiHeadAttention
   with a boolean key-padding mask (the dense route, no launch) and an
   nn.Transformer of 2 + 2 layers with generate_square_subsequent_mask
   (its encoder through the 3xTF32 kernels), each against the CPU within
   NN_TF_SMALL_TOL. Printed with the card's name and power limit: forward
   + backward ms and tokens/s of the bf16 step, the f32 forward ms, the
   errors, the phase's seconds (at most NN_TF_MAX_S).
17. text: the RNN layers, beam search, Viterbi and the tokenizer
   (phase_text). (a) PaddleNLP's seq2seq with attention at its IWSLT'15
   en-vi widths (source vocab 17191, target 7709, embedding and hidden
   512, a 2-layer nn.LSTM encoder, an nn.RNN decoder over a user cell of
   two LSTMCells with input feeding and dot attention masked by the source
   lengths, Linear(512, 7709); Uniform(-0.1, 0.1) through ParamAttr,
   dropout 0.2), batch 128, lengths 10-50 from RandomState(0), padded
   target tokens out of the loss: first the card against the CPU at batch
   4, lengths up to 12, dropout off (loss TEXT_LOSS_RTOL, each gradient
   TEXT_GRAD_TOL x max|g|, beam-10 ids equal but at a near-tie,
   text_beams_agree); then 2 + 5 f32 steps (Adam 1e-3,
   ClipGradByGlobalNorm(5.0)), one bf16 O1 step whose loss is within
   TEXT_BF16_RTOL of f32's on the same masks and whose encoder outputs are
   f32, BeamSearchDecoder(beam_size=10) + dynamic_decode(max_step_num=50)
   over the 128 sources (``finished`` read on the host each step), and
   the loop LSTM's forward + backward beside torch.nn.LSTM's (cuDNN) at
   [128, 50, 512], 2 layers. (b) the synthetic Conll05st (batch 256 through
   the DataLoader), Embedding 128 -> 2-layer bidirect GRU 128 ->
   Linear(256, 69) with lengths 1-32, ViterbiDecoder with BOS / EOS: the
   emissions against the CPU (TEXT_TAGGER_TOL), the paths equal to the
   CPU's on the same emissions, scores within TEXT_VITERBI_TOL. (c) 1024
   sentences through the FasterTokenizer over a 40000-entry synthetic
   vocab, ids equal to the Python oracle; 16 rows truncated to 512 (none
   padded) through ERNIE-3.0-base in eval, f32 (12 3xTF32 flash forwards)
   and bf16 O1 (12 tensor-core forwards, the main path's count on the
   kernels line, rows 1e and 1fe), bf16 within TEXT_ERNIE_BF16_TOL of f32.
   Printed with the card's name and power limit: step ms, target
   tokens/s, peak memory, decode ms and steps, the yardstick, the tagger's
   and Viterbi's ms, tokenize ms, ERNIE's bf16 forward ms, the phase's
   seconds (at most TEXT_MAX_S).
10. the ``kernels`` line: every ported kernel with the path that launched
   it (the training main path's timed steps, the train_obs steps, the
   train_rules runs, the dp and dp_eager phases' runs on rank 0, the
   ckpt phase's steps, the tp_sp phase's bf16 step at mp 1 and its
   virtual rings, the pp phase's virtual rings and its pp = 1 steps, the
   ernie phase's flash steps (the "_ernie" rows at its [16, 512, 12, 64]
   non-causal shape, with the nn_transformer phase's bf16 step and the
   text phase's bf16 ERNIE forward; the "_f32_ernie" row for ERNIE's f32
   eval forward, the text phase's f32 one and the forwards of
   nn_transformer's f32 check at [2, 512]; that check's f32 backward pair
   on the causal f32 rows, which have no non-causal twin), the
   tensor_api phase's GPTBlock calls (rows 1-3 and 1f-3f, one each), the
   f32 steps, scoring, the bench's gpt_1p3b run for the d = 128 rows, or a
   library_ops pass; the flash backward and the
   LM-loss backward once for each dtype, the route in ``kernel_route``),
   its launches there and its numbers from the kernel_vs_plain phases at
   that path's shape and dtype.

Before the ``kernels`` line, a ``seconds`` line: each phase's wall seconds
and the script's (model builds included).

Any failure raises (exit code 1). Without a CUDA card, or without the
package beside it, the script exits non-zero before printing a result. The
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,        # dense tensor-core rate
              torch.float32: 67e12,          # FP32 units (no TF32)
              "tf32": 495e12}                # dense TF32 tensor-core rate

F32_TOL = 1e-4          # kernel vs plain, f32: summation order only; also an f32
                        # result of bf16 inputs (flash lse, LM-loss loss and lse),
                        # times max(1, max|ref|): the products are exact in f32
BF16_TOL = 2e-2         # kernel vs plain, bf16: times max|o| (p rounds to bf16
                        # against a running, not final, max)
LOGITS_TOL = 2e-3       # card vs CPU, or kernel vs dense masked path, f32
                        # logits of ~0.5 scale after 12 layers
GRAD_F32_TOL = 1e-4     # backward kernels vs plain, f32: times max(1, max|ref|)
GRAD_F32_FROB_TOL = 5e-6  # ... the f32 gradients of the 3xTF32 kernels and of
                        # their FMA predecessors, besides GRAD_F32_TOL: LM-loss dh
                        # and dW of f32 h, ||got - ref||_F / ||ref||_F; the flash
                        # backward's dq, dk, dv in each (b, h) head (head_rel_frob);
                        # and, besides F32_TOL, the f32 flash forward's o in each
                        # (b, h) head. f32 sums in another order read ~4e-7; a
                        # TF32 product without its error compensation ~2e-4 (LM
                        # loss) or ~4e-4 (flash), and the LM loss's dh passes
                        # GRAD_F32_TOL then
GRAD_BF16_FROB_TOL = 1e-2  # ... bf16, besides BF16_TOL x max|ref|: each (b, h)
                        # head's ||got - ref||_F / ||ref||_F (causal P[0, 0] = 1
                        # makes dV[0] = dO[0], so max|ref| is ~50x a typical
                        # entry, and the max limit alone passes a q or kv tile
                        # dropped far from the diagonal)
DW_F32_TOL = 1e-3       # LM-loss f32 dW from bf16 h vs plain: times max|ref| (dl
                        # rounds to bf16 at the same point in both; at BF16_TOL
                        # the labels' -h spikes set max|ref| and hide the
                        # softmax term of the rows without a label)
TRAIN_LOSS_RTOL = 1e-5  # card vs CPU f32 train step: the loss
TRAIN_GRAD_TOL = 1e-3   # ... and each gradient, times max|grad| of that tensor
                        # (f32 sums in other orders through 2 layers and the
                        # 50304-row LM head; a wrong gradient is off by O(1))


def emit(**rec):
    print(json.dumps(rec), flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20):
    """Device time of one call of fn with a cold L2: the median over
    ``iters`` calls of CUDA events recorded around the call, each call after
    a 512 MB device-to-device copy. The copy evicts the 50 MB L2, and at
    ~0.3 ms it outlasts the host's Python time for a call, so the host runs
    ahead of the card and the events see the call's kernels back to back.
    For calls of tens of microseconds, where events around a loop of calls
    would count the host's time between launches and a warm L2."""
    src = torch.empty(128 << 20, device="cuda")
    dst = torch.empty_like(src)
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        dst.copy_(src)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def _bound(flops, nbytes, dtype):
    """Least time of the card for ``flops`` operations at the dtype's peak
    and ``nbytes`` moved at the HBM rate: (ms, what bounds it)."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, h, sq, sk, d, causal, dtype, products=2, seq_tensors=None,
                    peak=None):
    """Least time of the card for attention work: each input read once, each
    output written once, and ``products`` matrix products over the (q, k)
    pairs these inputs need (the causal half only), at the peak of ``peak``
    (a PEAK_FLOPS key; dtype's by default). ``seq_tensors`` = (tensors of
    length sq, of length sk, f32 rows of length sq) moved; the forward's (q
    and o, k and v, lse) by default."""
    if causal:
        pairs = (sq * (sq + 1) // 2 if sq <= sk
                 else sk * (sk + 1) // 2 + (sq - sk) * sk)
    else:
        pairs = sq * sk
    flops = 2 * products * d * b * h * pairs
    n_q, n_k, n_rows = seq_tensors or (2, 2, 1)
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * d * b * h * (n_q * sq + n_k * sk) + 4 * b * h * sq * n_rows
    return _bound(flops, nbytes, dtype if peak is None else peak)


def phase_env():
    from paddle_tpu_torch.bench import card_name_and_power_limit
    from paddle_tpu_torch.ops.kernels import _build

    card = card_name_and_power_limit()
    print(card, flush=True)
    emit(phase="env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    per_source = _build.build()
    report = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                     if "registers" in ln or "spill" in ln]
              for name in per_source}
    grads = {_instance_name(k): r for k, r in _build.ptxas_report("lm_loss").items()
             if "lm_grad_" in k}
    # the FasterTokenizer's native library (phase text): g++ at its first use
    from paddle_tpu_torch.core import native

    t1 = time.perf_counter()
    native.load_library("tokenizer")
    emit(phase="build", seconds=time.perf_counter() - t0, per_source=per_source,
         ptxas=report, lm_grad_ptxas=grads,
         native={"tokenizer.cc": {"compiler": "g++", "seconds": time.perf_counter() - t1,
                                  "library": native.library_path("tokenizer").name}})
    spilled = [k for k, r in grads.items() if "lm_grad_kernel" not in k
               and (r.get("spill_stores") or r.get("spill_loads"))]
    if spilled:
        raise AssertionError(f"tensor-core LM-loss backward instances spill: {spilled}")
    return per_source


def _instance_name(mangled):
    """A kernel template instance's mangled name made readable enough to
    tell the LM-loss backward's instances apart: lm_grad_tf32_kernel<DW,
    TO, HC, CLUSTER> and lm_grad_mma_kernel<DW, TO, HC, ST, CLUSTER>."""
    import re

    m = re.search(r"\d+(lm_grad_\w+?_kernel|lm_grad_kernel)I(.*)EEv", mangled)
    if not m:
        return mangled
    args = re.findall(r"Lb([01])E|Li(\d+)E|(f)|13__nv_bfloat16", m.group(2))
    names = [("true" if b == "1" else "false") if b else i or ("float" if f else "bf16")
             for b, i, f in args]
    return f"{m.group(1)}<{', '.join(names)}>"


def _f32_tol(ref):
    """Limit of an f32 result of bf16 inputs: F32_TOL x max(1, max|ref|)."""
    return F32_TOL * max(1.0, ref.abs().max().item())


def rel_frob(got, want):
    """||got - want||_F / ||want||_F over the whole tensor."""
    g, w = got.float(), want.float()
    return ((g - w).norm() / w.norm().clamp_min(1e-30)).item()


def _frob_or_raise(what, got, want):
    """rel_frob of an f32 LM-loss gradient of f32 h; raises past
    GRAD_F32_FROB_TOL."""
    err = rel_frob(got, want)
    if not err <= GRAD_F32_FROB_TOL:
        raise AssertionError(f"{what}: kernel vs plain relative Frobenius error {err} "
                             f"(tol {GRAD_F32_FROB_TOL})")
    return err


def head_rel_frob(got, want):
    """The largest over the (b, h) heads of [b, s, h, d] tensors of
    ||got - want||_F / ||want||_F over the head's [s, d] slice."""
    g, w = got.float(), want.float()
    err = (g - w).square().sum(dim=(1, 3)).sqrt()
    ref = w.square().sum(dim=(1, 3)).sqrt()
    return (err / ref.clamp_min(1e-30)).max().item()


def phase_kernels_fwd():
    """Flash forward vs its plain version; returns the records by case.

    Each case takes the kernel of its dtype's route (checked for it: bf16
    the bf16 tensor-core kernel, f32 the 3xTF32 one), and the FMA
    predecessor (the private route="fma") is held to the same limits on the
    same inputs. bf16: o at BF16_TOL x max|o|, lse at F32_TOL x max(1,
    max|lse|) (exact bf16 products summed in f32: one dropped kv tile moves
    a row's lse by far more). f32: o and lse at F32_TOL, and o at
    GRAD_F32_FROB_TOL in each (b, h) head's relative Frobenius norm
    (``head_rel_frob``: a TF32 product without its error compensation errs
    by ~4e-4 there). The slice cases are timed: kernel, FMA predecessor and
    SDPA (default dispatch, with the name of its kernel) by ``device_ms``
    (tens of microseconds), the plain version by ``cuda_ms``; the f32
    bound counts three TF32 products each (f32 accuracy), the FP32 units'
    bound beside it."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, b, sq, sk, h, d, causal, dtype, timed)
        ("slice_f32_causal", 8, 1024, 1024, 12, 64, True, f32, True),
        ("slice_bf16_causal", 8, 1024, 1024, 12, 64, True, bf16, True),
        ("1p3b_bf16_causal", 4, 2048, 2048, 16, 128, True, bf16, True),
        ("ernie_bf16_noncausal", 16, 512, 512, 12, 64, False, bf16, True),
        ("ernie_f32_noncausal", 16, 512, 512, 12, 64, False, f32, True),
        ("slice_f32_noncausal", 8, 1024, 1024, 12, 64, False, f32, False),
        ("sq128_sk1024_f32_causal", 8, 128, 1024, 12, 64, True, f32, False),
        ("d32_f32_causal", 8, 1024, 1024, 24, 32, True, f32, False),
        ("d128_f32_causal", 8, 1024, 1024, 6, 128, True, f32, False),
        ("ragged1000_f32_causal", 8, 1000, 1000, 12, 64, True, f32, False),
        ("fused_qkv_view_f32_causal", 8, 1024, 1024, 12, 64, True, f32, False),
        ("slice_bf16_noncausal", 8, 1024, 1024, 12, 64, False, bf16, False),
        ("d32_bf16_causal", 8, 1024, 1024, 24, 32, True, bf16, False),
        ("d32_bf16_noncausal", 8, 1024, 1024, 24, 32, False, bf16, False),
        ("d128_bf16_causal", 8, 1024, 1024, 6, 128, True, bf16, False),
        ("d128_bf16_noncausal", 8, 1024, 1024, 6, 128, False, bf16, False),
        ("sq128_sk1024_bf16_causal", 8, 128, 1024, 12, 64, True, bf16, False),
        ("sq128_sk1024_d128_bf16_noncausal", 8, 128, 1024, 6, 128, False, bf16, False),
        ("ragged1000_bf16_causal", 8, 1000, 1000, 12, 64, True, bf16, False),
        ("ragged1000_d32_bf16_noncausal", 8, 1000, 1000, 24, 32, False, bf16, False),
        ("fused_qkv_view_bf16_causal", 8, 1024, 1024, 12, 64, True, bf16, False),
    ]
    recs = {}
    for name, b, sq, sk, h, d, causal, dtype, timed in cases:
        if name.startswith("fused_qkv_view"):
            # the model's strided views of one fused [b, s, 3, h, d] projection
            qkv = torch.randn(b, sq, 3, h, d, device="cuda", generator=gen).to(dtype)
            q, k, v = qkv.unbind(dim=2)
        else:
            q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
            k = torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
            v = torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
        scale = 1.0 / math.sqrt(d)
        route = fa.forward_route(dtype, d)
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
        if dtype == f32:
            tol_o = tol_lse = F32_TOL
        else:
            tol_o = BF16_TOL * po.float().abs().max().item()
            tol_lse = _f32_tol(plse)
        errs, frob = {}, {}
        for r in (route, "fma"):   # the kernel, then its FMA predecessor
            before = dict(fa.launches_by_route)
            ro, rlse = (fa.flash_attention_with_lse(q, k, v, causal=causal) if r == route
                        else fa._launch(q, k, v, causal, scale, route="fma"))
            torch.cuda.synchronize()
            moved = {x: n - before[x] for x, n in fa.launches_by_route.items()}
            if moved != {x: int(x == r) for x in moved}:
                raise AssertionError(f"flash forward {name} ({r}) took the routes {moved}")
            errs[r] = ((ro.float() - po.float()).abs().max().item(),
                       (rlse - plse).abs().max().item())
            frob[r] = head_rel_frob(ro, po) if dtype == f32 else None
            if not (errs[r][0] <= tol_o and errs[r][1] <= tol_lse
                    and (frob[r] is None or frob[r] <= GRAD_F32_FROB_TOL)):
                raise AssertionError(f"flash kernel ({r}) disagrees with its plain version "
                                     f"on {name}: |do| {errs[r][0]} (tol {tol_o}), "
                                     f"|dlse| {errs[r][1]} (tol {tol_lse}), head relative "
                                     f"Frobenius {frob[r]} (tol {GRAD_F32_FROB_TOL})")
            del ro, rlse
        rec = dict(case=name, shape=[b, sq, sk, h, d], causal=causal,
                   dtype=str(dtype).replace("torch.", ""), kernel_route=route,
                   max_abs_err_o=errs[route][0], max_abs_err_lse=errs[route][1],
                   tol_o=tol_o, tol_lse=tol_lse, fma_max_abs_err_o=errs["fma"][0],
                   fma_max_abs_err_lse=errs["fma"][1])
        if dtype == f32:
            rec.update(rel_frob_o=frob[route], fma_rel_frob_o=frob["fma"],
                       frob_tol=GRAD_F32_FROB_TOL)
        if timed:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            bound_ms, bound_by = attention_bound(b, h, sq, sk, d, causal, dtype)
            if route == "tf32x3":
                # f32 accuracy on the tensor cores: three TF32 products each
                rec["fp32_bound_ms"] = bound_ms
                bound_ms, bound_by = attention_bound(b, h, sq, sk, d, causal, dtype, 6,
                                                     peak="tf32")

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                        is_causal=causal)

            rec.update(
                kernel_ms=device_ms(lambda: fa.flash_attention_with_lse(q, k, v, causal=causal)),
                fma_kernel_ms=device_ms(lambda: fa._launch(q, k, v, causal, scale,
                                                           route="fma")),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                                 iters=3),
                library_ms=device_ms(sdpa), library_kernels=device_profile(sdpa, top=2)[2],
                bound_ms=bound_ms, bound_by=bound_by, timing="device_ms")
            del qt, kt, vt
        emit(phase="kernel_vs_plain", kernel="flash_attention_fwd", **rec)
        recs[name] = rec
        del q, k, v, po, plse
    torch.cuda.empty_cache()
    return recs


def sdpa_yardstick(q, k, v, do, causal):
    """SDPA's forward and backward (dq, dk, dv) on [b, s, h, d] inputs, timed
    by ``device_ms``: under the default dispatch and, for bf16, pinned to the
    flash backend (FA2, the algorithm of the port's backward pair), with the
    name of the backward kernel each one ran (the profiler's largest)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backends = {"default": None}
    if q.dtype == torch.bfloat16:
        backends["flash"] = SDPBackend.FLASH_ATTENTION
    out = {}
    for key, backend in backends.items():
        with sdpa_kernel(backend) if backend is not None else contextlib.nullcontext():
            with torch.no_grad():
                out[f"{key}_fwd_ms"] = device_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
            with torch.enable_grad():
                ot = sdpa(qt, kt, vt, is_causal=causal)

                def bwd():
                    return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

                out[f"{key}_bwd_ms"] = device_ms(bwd)
                out[f"{key}_bwd_kernels"] = device_profile(bwd, top=2)[2]
            del ot
    return out


def phase_kernels_bwd():
    """The FA2 backward's dK/dV and dQ kernels vs their plain version, with
    SDPA's backward (all three gradients at once) as the library yardstick:
    pinned to its flash backend (FA2) for bf16, the default dispatch for f32,
    both by ``device_ms`` (``sdpa_yardstick``, with the name of the kernel
    it ran). bf16 takes the bf16 tensor-core pair, f32 the 3xTF32 pair (each
    checked for its route), and the FMA predecessor (the private
    route="fma") is held to the same limits on the same inputs: bf16
    gradients at BF16_TOL x max|ref| and GRAD_BF16_FROB_TOL, f32 ones at
    GRAD_F32_TOL x max(1, max|ref|) and GRAD_F32_FROB_TOL, the Frobenius
    limits in each (b, h) head (``head_rel_frob``). The f32 rows' bound
    counts three TF32 products each (f32 accuracy), the FP32 units' bound
    beside it. The timed cases time the kernels by ``device_ms``
    (``kernel_ms``, like the yardstick; the FMA predecessor's beside it) and
    by ``cuda_ms`` (a warm loop, ``cuda_ms``). Returns {case: {"dkdv": rec,
    "dq": rec}} for the timed cases."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, b, sq, sk, h, d, causal, dtype, timed)
        ("train_bf16_causal", 8, 1024, 1024, 12, 64, True, bf16, True),
        ("train_f32_causal", 8, 1024, 1024, 12, 64, True, f32, True),
        ("sq512_sk1024_f32_noncausal", 8, 512, 1024, 12, 64, False, f32, True),
        ("d128_bf16_causal", 8, 1024, 1024, 6, 128, True, bf16, True),
        ("1p3b_bf16_causal", 4, 2048, 2048, 16, 128, True, bf16, True),
        ("ernie_bf16_noncausal", 16, 512, 512, 12, 64, False, bf16, True),
        ("d32_bf16_causal", 8, 1024, 1024, 24, 32, True, bf16, False),
        ("train_bf16_noncausal", 8, 1024, 1024, 12, 64, False, bf16, False),
        ("ragged200_d32_bf16_causal", 8, 200, 200, 12, 32, True, bf16, False),
        ("sq77_sk300_d128_bf16_noncausal", 8, 77, 300, 6, 128, False, bf16, False),
        ("sq128_sk320_bf16_causal", 8, 128, 320, 12, 64, True, bf16, False),
        ("sq300_sk100_d128_bf16_causal", 8, 300, 100, 6, 128, True, bf16, False),
        ("train_f32_noncausal", 8, 1024, 1024, 12, 64, False, f32, False),
        ("d32_f32_causal", 8, 1024, 1024, 24, 32, True, f32, False),
        ("d128_f32_causal", 8, 1024, 1024, 6, 128, True, f32, False),
        ("ragged200_f32_causal", 8, 200, 200, 12, 64, True, f32, False),
        ("sq128_sk320_f32_causal", 8, 128, 320, 12, 64, True, f32, False),
    ]
    out = {}
    for name, b, sq, sk, h, d, causal, dtype, timed in cases:
        q, do = (torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        o, lse = fa.flash_attention_plain(q, k, v, causal=causal)
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, causal)
        route = fa.backward_route(dtype, d)
        want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(*args)))
        tol = {g: (GRAD_F32_TOL * max(1.0, w.float().abs().max().item()) if dtype == f32
                   else BF16_TOL * w.float().abs().max().item()) for g, w in want.items()}
        routes = [route] + (["fma"] if route != "fma" else [])
        frob_tol = GRAD_BF16_FROB_TOL if dtype == bf16 else GRAD_F32_FROB_TOL
        err, frob = {}, {}
        for r in routes:
            forced = None if r == route else r
            before = {x: dict(c) for x, c in fa.launches_bwd_by_route.items()}
            dk, dv = fa.flash_attention_bwd_dkdv(*args, route=forced)
            dq = fa.flash_attention_bwd_dq(*args, route=forced)
            torch.cuda.synchronize()
            moved = {x: {n: c[n] - before[x][n] for n in c}
                     for x, c in fa.launches_bwd_by_route.items()}
            if moved[r] != {"dkdv": 1, "dq": 1} or any(
                    n for x, c in moved.items() if x != r for n in c.values()):
                raise AssertionError(f"flash backward {name} ({r}) took the routes {moved}")
            got = {"dq": dq, "dk": dk, "dv": dv}
            err[r] = {g: (got[g].float() - want[g].float()).abs().max().item() for g in got}
            frob[r] = {g: head_rel_frob(got[g], want[g]) for g in got}
            if not all(err[r][g] <= tol[g] and frob[r][g] <= frob_tol for g in got):
                raise AssertionError(f"flash backward kernel ({r}) disagrees with its plain "
                                     f"version on {name}: errors {err[r]} (tol {tol}), "
                                     f"head relative Frobenius {frob[r]} (tol {frob_tol})")
            del dk, dv, dq, got
        if not timed:
            emit(phase="kernel_vs_plain", kernel="flash_attention_bwd (dkdv, dq)", case=name,
                 shape=[b, sq, sk, h, d], causal=causal,
                 dtype=str(dtype).replace("torch.", ""), kernel_route=route,
                 max_abs_err=err[route], tol=tol, rel_frob=frob[route], frob_tol=frob_tol,
                 **({"fma_max_abs_err": err["fma"], "fma_rel_frob": frob["fma"]}
                    if route != "fma" else {}))
            del q, k, v, do, o, lse, delta, want
            continue
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(*args), iters=3)
        yard = sdpa_yardstick(q, k, v, do, causal)
        if name in ("train_bf16_causal", "train_f32_causal"):
            emit(phase="fa2_yardstick" if dtype == bf16 else "sdpa_yardstick", case=name,
                 shape=[b, sq, sk, h, d], causal=causal,
                 dtype=str(dtype).replace("torch.", ""), timing="device_ms", **yard)
        library_ms = yard.get("flash_bwd_ms", yard["default_bwd_ms"])
        library_kernels = yard.get("flash_bwd_kernels", yard["default_bwd_kernels"])
        rows = {}
        for kernel, fn, grads, products, moved in (
                ("dkdv", fa.flash_attention_bwd_dkdv, ("dk", "dv"),
                 4, (2, 4, 2)),    # q, dO in; k, v in, dk, dv out; lse, delta
                ("dq", fa.flash_attention_bwd_dq, ("dq",),
                 3, (3, 2, 2))):   # q, dO in, dq out; k, v in; lse, delta
            bound_ms, bound_by = attention_bound(b, h, sq, sk, d, causal, dtype,
                                                 products, moved)
            extra = {}
            if route == "tf32x3":
                # f32 accuracy on the tensor cores: three TF32 products each
                extra["fp32_bound_ms"] = bound_ms
                bound_ms, bound_by = attention_bound(b, h, sq, sk, d, causal, dtype,
                                                     3 * products, moved, peak="tf32")
            rows[kernel] = dict(
                case=name, shape=[b, sq, sk, h, d], causal=causal,
                dtype=str(dtype).replace("torch.", ""), kernel_route=route,
                max_abs_err=max(err[route][g] for g in grads),
                tol=min(tol[g] for g in grads),
                rel_frob=max(frob[route][g] for g in grads), frob_tol=frob_tol,
                kernel_ms=device_ms(lambda: fn(*args)),
                cuda_ms=cuda_ms(lambda: fn(*args)), plain_ms=plain_ms,
                library_ms=library_ms, library_default_ms=yard["default_bwd_ms"],
                library_kernels=library_kernels, bound_ms=bound_ms, bound_by=bound_by,
                timing="device_ms", **extra)
            if route != "fma":
                rows[kernel].update(
                    fma_max_abs_err=max(err["fma"][g] for g in grads),
                    fma_rel_frob=max(frob["fma"][g] for g in grads),
                    fma_kernel_ms=device_ms(lambda: fn(*args, route="fma")))
            emit(phase="kernel_vs_plain", kernel=f"flash_attention_bwd_{kernel}",
                 **rows[kernel], plain="flash_attention_bwd_plain (dq, dk, dv)",
                 library="scaled_dot_product_attention backward (dq, dk, dv), "
                 + ("flash backend" if "flash_bwd_ms" in yard else "default dispatch")
                 + ", device_ms")
        out[name] = rows
        del q, k, v, do, o, lse, delta, want
    torch.cuda.empty_cache()
    return out


def phase_score(model, cpu_model, ids):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    cfg = model.config
    _reset_launch_counts()
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize()
    launches, routes = fa.launches, dict(fa.launches_by_route)
    if launches != cfg.num_layers or routes != {"mma": 0, "tf32x3": cfg.num_layers,
                                                 "fma": 0}:
        raise AssertionError(f"scoring forward launched the flash kernel "
                             f"{launches} times ({routes}), expected {cfg.num_layers} "
                             f"on the 3xTF32 kernel (f32)")
    if tuple(logits.shape) != (*ids.shape, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("scoring forward produced non-finite logits")

    with torch.no_grad():
        ref = cpu_model(ids[:1].cpu())[0, -1]
    err = (logits[0, -1].cpu() - ref).abs().max().item()
    if not err <= LOGITS_TOL:
        raise AssertionError(f"card vs CPU last-position logits differ by {err}")

    iters = 3
    with torch.no_grad():
        ms = cuda_ms(lambda: model(ids), iters=iters, warmup=1)
    tokens = ids.numel()
    emit(phase="score", model="gpt2-124m", batch=list(ids.shape), launches=launches,
         launches_by_route=routes, logits_max_abs_err_vs_cpu=err, tol=LOGITS_TOL,
         forward_ms=ms, tokens_per_s=tokens / (ms / 1e3))
    return logits, launches, ms


def device_profile(fn, top=5):
    """Run fn under torch.profiler; returns (traced wall ms, summed CUDA
    kernel ms, the ``top`` kernels with the most time). One stream, so
    kernel times do not overlap. A trace without a single kernel record
    (seen on the H100 in calls of SDPA's backward and of its bf16 forward,
    twice in a row in one run) is taken again, with another call of fn, up
    to four traces in all; a fourth such trace raises."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        per_kernel = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.device_time / 1e3
        total = sum(per_kernel.values())
        if total > 0:
            break
    else:
        raise AssertionError("the profiler recorded no device time in four traces")
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    return wall, total, [[name[:80], ms] for name, ms in ranked]


def phase_profile(model, ids, forward_ms):
    from paddle_tpu_torch.serving import ServingEngine

    with torch.no_grad():
        wall, kernel_ms, top = device_profile(lambda: model(ids))
    emit(phase="profile", what="score_forward", batch=list(ids.shape),
         wall_ms_untraced=forward_ms, wall_ms_traced=wall, kernel_ms=kernel_ms,
         device_busy_share=kernel_ms / forward_ms, top_kernels=top)

    for layout in ("contiguous", "paged"):
        eng = ServingEngine(model, slot_count=4, ladder=(64, 128, 256, 512),
                            max_new_cap=32, steps_per_dispatch=8, kv_layout=layout)
        for n in (17, 60, 100, 150):
            eng.submit(ids[0, :n].cpu().numpy(), max_new_tokens=32, temperature=0.0)
        eng.step()                       # admits all four, runs the first chunk
        t0 = time.perf_counter()
        eng.step()                       # a decode chunk alone (ends in a device read)
        chunk_ms = (time.perf_counter() - t0) * 1e3
        wall, kernel_ms, top = device_profile(eng.step)
        eng.run()
        emit(phase="profile", what="decode_chunk", kv_layout=layout, slots=4,
             steps=eng.steps_per_dispatch, wall_ms_untraced=chunk_ms,
             wall_ms_traced=wall, kernel_ms=kernel_ms,
             device_busy_share=kernel_ms / chunk_ms, top_kernels=top)


def phase_serve(model, ids, logits):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, slot_count=4, ladder=(64, 128, 256, 512),
                        max_new_cap=32, steps_per_dispatch=8)
    lengths = [17, 60, 100, 150, 220, 300, 400, 500]
    prompts = [ids[i % ids.shape[0], :n].cpu().numpy() for i, n in enumerate(lengths)]
    fa.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32, temperature=0.0) for p in prompts]
    eng.run()
    wall = time.perf_counter() - t0
    serve_launches = fa.launches
    decode_tokens, decode_s = eng.decode_tokens, eng.decode_seconds
    if not all(r.done and r.outcome == "length" and len(r.tokens) == 32
               for r in reqs):
        raise AssertionError(f"not every request completed: {reqs}")
    vocab = model.config.vocab_size
    if not all(0 <= t < vocab for r in reqs for t in r.tokens):
        raise AssertionError("a token id is out of the vocabulary")

    # slot independence: the same request alone on the engine
    for i in (1, 6):
        solo = eng.submit(prompts[i], max_new_tokens=32, temperature=0.0)
        eng.run()
        if solo.tokens != reqs[i].tokens:
            raise AssertionError(f"request {i} solo gave other tokens")

    # dense masked prefill vs the kernel's scoring forward at the same position
    prefill_err = 0.0
    for i in (0, 7):
        got = eng.score_prompt(prompts[i])
        want = logits[i % ids.shape[0], lengths[i] - 1]
        prefill_err = max(prefill_err, (got - want).abs().max().item())
    if not prefill_err <= LOGITS_TOL:
        raise AssertionError(f"prefill logits differ from the scoring forward "
                             f"by {prefill_err}")
    ttft = [r.ttft_s * 1e3 for r in reqs]
    emit(phase="serve", requests=len(reqs), completed=sum(r.done for r in reqs),
         prompt_lengths=lengths, new_tokens=[len(r.tokens) for r in reqs],
         ttft_ms_p50=statistics.median(ttft), ttft_ms_max=max(ttft),
         decode_tokens_per_s=decode_tokens / decode_s,
         decode_tokens=decode_tokens, decode_s=decode_s, wall_s=wall,
         prefill_logits_max_abs_err_vs_score=prefill_err, tol=LOGITS_TOL,
         flash_launches=serve_launches)


SERVE_PAGED_BYTES = {   # GPT-2 124M, 8 slots, max_seq_len 1024, 64-token pages
    "contiguous_bf16": 2 * 12 * 8 * 1024 * 768 * 2,                 # K and V rows
    "paged_bf16": 2 * 12 * 258 * 64 * 768 * 2 + 8 * 16 * 4,         # + the page table
    "paged_int8": 2 * 12 * 258 * 64 * (768 + 12 * 4) + 8 * 16 * 4,  # + f32 scales
}
INT8_BOUND_SLACK = 1e-4  # int8 page error, past absmax/127 x 0.5: f32 rounding of
                         # x / s and q x s, |x| <= 127 s, a few ulps of s


def _serve_traffic(vocab):
    """serve_paged's 32 requests: (class, prompt, sampling kwargs)."""
    rng = np.random.RandomState(0)

    def fresh(n):
        return rng.randint(0, vocab, (n,)).astype(np.int64)

    greedy = {"temperature": 0.0}
    work = [("A", fresh(n), greedy) for n in (17, 60, 100, 150, 220, 300, 400, 500)]
    system = fresh(256)                                          # 4 whole pages
    tails = np.linspace(8, 160, 12).astype(int)
    work += [("B", np.concatenate([system, fresh(int(t))]), greedy) for t in tails]
    repeat = fresh(192)                                          # 3 whole pages
    work += [("C", repeat.copy(), greedy) for _ in range(4)]
    work += [("D", fresh(n), {"temperature": 0.8, "top_k": 50, "top_p": 0.95,
                              "seed": 100 + i})
             for i, n in enumerate((32, 96, 160, 224, 288, 352, 416, 480))]
    return work


def _prompt_pages(eng, prompt):
    """The pool pages a paged engine's trie holds for prompt's whole pages."""
    pages, children = [], eng._prefix._root
    for chunk in eng._prefix._chunks(prompt):
        node = children[chunk]
        pages.append(node.page)
        children = node.children
    return pages


def _first_divergence(model, prompt, want, got):
    """Where two greedy token lists first part: (index, the two tokens'
    logit gap, max |logit|) in the f32 scoring forward of the prompt and
    their common prefix; None where they agree."""
    j = next((n for n, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if j is None:
        if len(want) != len(got):
            raise AssertionError(f"token lists of {len(want)} and {len(got)} agree "
                                 "up to the shorter one's end")
        return None
    prefix = np.concatenate([prompt, np.asarray(want[:j], np.int64)])
    with torch.no_grad():
        lg = model(torch.from_numpy(prefix)[None].cuda())[0, -1].float()
    return j, abs(lg[want[j]].item() - lg[got[j]].item()), lg.abs().max().item()


def phase_serve_paged(model):
    """GPT-2 124M served from the contiguous cache and from pages (bf16 and
    int8 pages under bf16 auto_cast, f32 pages without it), on one traffic
    of 32 requests: misses, partial prefix hits, full hits and sampled ones."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.serving import ServingEngine

    counters = ("serving.prefill_dispatches", "serving.prefill_skips",
                "serving.prefix_hits")
    work = _serve_traffic(model.config.vocab_size)
    engines = {   # name -> (autocast dtype, kv_layout, kv_cache_dtype)
        "contiguous_bf16": ("bfloat16", "contiguous", None),
        "paged_bf16": ("bfloat16", "paged", "auto"),
        "paged_int8": ("bfloat16", "paged", "int8"),
        "contiguous_f32": (None, "contiguous", None),
        "paged_f32": (None, "paged", "auto"),
    }
    repeat = next(p for c, p, _ in work if c == "C")
    out, kv_pages_of = {}, {}
    for name, (amp, layout, kv_dtype) in engines.items():
        paged = layout == "paged"
        with auto_cast(enable=amp is not None, dtype=amp or "bfloat16"):
            eng = ServingEngine(model, slot_count=8, ladder=(64, 128, 256, 512),
                                max_new_cap=64, steps_per_dispatch=8,
                                kv_layout=layout, kv_page_tokens=64,
                                kv_num_pages=258 if paged else None,
                                kv_cache_dtype=kv_dtype)
        partial_logits = {}

        def hook(req, logits, keep=partial_logits):
            if req.prefix_hit:
                keep[req.id] = logits[0].float().cpu()

        eng._prefill_hook = hook
        c0 = {c: monitor.stat(c).get() for c in counters}
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=64, **kw) for _, p, kw in work]
        peak_pages = 0
        while eng.queue_depth() or eng.occupancy():    # run(), reading the pool
            eng.step()
            peak_pages = max(peak_pages, eng._pool.in_use if paged else 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not all(r.done and r.outcome == "length" and len(r.tokens) == 64
                   for r in reqs):
            raise AssertionError(f"serve_paged {name}: not every request completed")
        counts = {c: monitor.stat(c).get() - c0[c] for c in counters}
        rec = {"engine": name, "tokens": [r.tokens for r in reqs],
               "kv_cache_bytes": eng.kv_cache_bytes(), "counts": counts,
               "decode_tokens_per_s": eng.decode_tokens / eng.decode_seconds,
               "wall_s": wall}
        cache = eng._pool_state["k"][0] if paged else eng._kcs[0]
        want_dtype = torch.float32 if amp is None else (
            torch.int8 if kv_dtype == "int8" else torch.bfloat16)
        if cache.dtype != want_dtype or eng._cache_dtype != (
                torch.float32 if amp is None else torch.bfloat16):
            raise AssertionError(f"serve_paged {name}: cache {cache.dtype}, "
                                 f"compute {eng._cache_dtype}")
        if name in SERVE_PAGED_BYTES and rec["kv_cache_bytes"] != SERVE_PAGED_BYTES[name]:
            raise AssertionError(f"serve_paged {name}: kv_cache_bytes "
                                 f"{rec['kv_cache_bytes']} != {SERVE_PAGED_BYTES[name]}")

        # TTFT (submit to first token, queueing included) and admission to
        # first token, by what the trie did for the request
        rec["ttft_ms"], rec["admit_to_first_ms"] = {}, {}
        for cls, sel in (("miss", lambda r: not r.prefix_hit),
                         ("partial_hit", lambda r: r.prefix_hit and r.tail_bucket),
                         ("full_hit", lambda r: r.prefix_hit and not r.tail_bucket)):
            for key, start in (("ttft_ms", "submit_ts"), ("admit_to_first_ms", "admit_ts")):
                ms = [(r.first_token_ts - getattr(r, start)) * 1e3 for r in reqs if sel(r)]
                if ms:
                    rec[key][cls] = {"p50": statistics.median(ms), "max": max(ms),
                                     "n": len(ms)}
        if paged:
            st = eng.stats()
            rec.update(peak_pages_in_use=peak_pages, pages_in_use=st["pages_in_use"],
                       pages_cached=st["pages_cached"], prefix=st["prefix"])
            if counts != {"serving.prefill_dispatches": 29, "serving.prefill_skips": 3,
                          "serving.prefix_hits": 14}:
                raise AssertionError(f"serve_paged {name}: counters {counts}")
            if (st["pages_in_use"] != 0 or st["pages_cached"] < 7
                    or st["prefix"]["evicted_pages"] != 0):
                raise AssertionError(f"serve_paged {name}: pool after the run {st}")
            state = eng._pool_state
            for pool in (*state["k"], *state["v"], *state["ks"], *state["vs"]):
                if pool[0].any():
                    raise AssertionError(f"serve_paged {name}: the zero page was written")
            # the partial hits' tail prefill against the whole prompt's prefill
            worst = 0.0
            for r in reqs:
                if r.id in partial_logits:
                    ref = eng.score_prompt(r.prompt_ids).float().cpu()
                    err = (partial_logits[r.id] - ref).abs().max().item()
                    tol = LOGITS_TOL if amp is None else BF16_TOL * ref.abs().max().item()
                    if not err <= tol:
                        raise AssertionError(f"serve_paged {name}: partial-hit prefill "
                                             f"logits differ by {err} (tol {tol})")
                    worst = max(worst, err / tol)
            rec["partial_hit_logits_err_over_tol"] = worst
            if amp is not None:     # the C prompt's pages, every layer
                pages = torch.tensor(_prompt_pages(eng, repeat), device=cache.device)
                kv_pages_of[kv_dtype] = [
                    [pool[pages] for pool in pools]
                    for pools in zip(*(state[n] for n in ("k", "v", "ks", "vs") if state[n]))]
        else:
            if counts["serving.prefill_dispatches"] != len(work):
                raise AssertionError(f"serve_paged {name}: counters {counts}")
        out[name] = rec
        del eng
        torch.cuda.empty_cache()

    # int8 pages against the bf16 pages of the C prompt (3 whole pages):
    # layer 0's K/V come from the same embeddings in both engines, so they
    # meet the quantization bound; later layers read int8 K/V before them,
    # so their error is printed, not held
    rel = []
    for layer, ((kb, vb), (kq, vq, ks, vs)) in enumerate(zip(
            kv_pages_of["auto"], kv_pages_of["int8"])):
        for ref, q, s in ((kb, kq, ks), (vb, vq, vs)):
            ref = ref.float()
            deq = q.float() * s[..., None]
            err = (deq - ref).abs()
            bound = ref.abs().amax(-1, keepdim=True) / 127 * (0.5 + INT8_BOUND_SLACK)
            if layer == 0 and not bool((err <= bound).all()):
                raise AssertionError("serve_paged: int8 layer-0 K/V past absmax/127 x 0.5 "
                                     f"(worst {(err / bound).max().item()} of the bound)")
            rel.append((err.max() / ref.abs().max()).item())

    # exact tokens where the arithmetic is the same; B and C at f32 differ
    # only at a near-tie of the scoring forward's logits
    classes = [c for c, _, _ in work]
    mismatched, ties = {}, []
    for amp in ("bf16", "f32"):
        want, got = out[f"contiguous_{amp}"]["tokens"], out[f"paged_{amp}"]["tokens"]
        diff = [i for i in range(len(work)) if want[i] != got[i]]
        mismatched[amp] = [(classes[i], i) for i in diff]
        if [i for i in diff if classes[i] in "AD"]:
            raise AssertionError(f"serve_paged {amp}: paged tokens differ from "
                                 f"contiguous for misses {mismatched[amp]}")
        if amp != "f32":
            continue
        for i in diff:
            j, gap, _ = _first_divergence(model, work[i][1], want[i], got[i])
            ties.append({"request": i, "class": classes[i], "position": j,
                         "tokens": [want[i][j], got[i][j]], "logit_gap": gap})
            if not gap <= LOGITS_TOL:
                raise AssertionError(f"serve_paged f32: request {i} ({classes[i]}) "
                                     f"differs at token {j} where the logits are "
                                     f"{gap} apart (tol {LOGITS_TOL})")
    agree = [a == b for a, b in zip(out["paged_int8"]["tokens"],
                                    out["paged_bf16"]["tokens"])]
    for rec in out.values():
        emit(phase="serve_paged", **{k: v for k, v in rec.items() if k != "tokens"})
    emit(phase="serve_paged", summary=True, requests=len(work),
         classes={c: classes.count(c) for c in "ABCD"},
         paged_vs_contiguous_mismatches=mismatched, f32_near_ties=ties,
         int8_vs_bf16_requests_equal=sum(agree),
         int8_kv_max_rel_err_by_layer=[max(rel[2 * i:2 * i + 2])
                                       for i in range(len(rel) // 2)],
         int8_bytes_over_bf16=out["paged_int8"]["kv_cache_bytes"]
         / out["paged_bf16"]["kv_cache_bytes"])
    if out["paged_int8"]["kv_cache_bytes"] > 0.55 * out["paged_bf16"]["kv_cache_bytes"]:
        raise AssertionError("serve_paged: int8 pool above 0.55x the bf16 pool")


SPEC_EOS_REQUEST = 4     # serve_spec: a speculating greedy request given an eos from its
                         # baseline stream, in the middle of a whole accepted window
SPEC_REPEAT_REQUEST = 2  # ... the 128-token (two whole pages) speculating prompt the
                         # paged engines submit once more: a full-hit replay seat
SPEC_SELF_MIN_ACCEPT = 0.9   # self draft, f32 greedy: accepted / proposed (1.0 but
                             # for ties of the window's and the draft's logits)
SPEC_REJECT_MIN_PROPOSED = 100


def _spec_traffic(vocab):
    """serve_spec's 16 requests, (prompt, submit kwargs): 12 greedy prompts
    of 17-400 tokens, every other one speculating, and 4 sampled ones, two
    speculating."""
    rng = np.random.RandomState(1)
    work = [(rng.randint(0, vocab, (n,)).astype(np.int64),
             {"temperature": 0.0, "speculate_k": 4 if i % 2 == 0 else 0})
            for i, n in enumerate((17, 50, 128, 90, 160, 200, 230, 260, 300, 330, 370, 400))]
    work += [(rng.randint(0, vocab, (n,)).astype(np.int64),
              {"temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 200 + i,
               "speculate_k": 4 if i < 2 else 0})
             for i, n in enumerate((40, 120, 240, 360))]
    return work


def _spec_eos(tokens):
    """An eos for the baseline stream ``tokens``: the first token from index
    6 on that sits in the middle of a window of 5 (k = 4 accepted + bonus,
    after the prefill's token) and does not occur before; the stream cut
    there."""
    i = next(i for i in range(6, len(tokens))
             if (i - 1) % 5 == 2 and tokens.index(tokens[i]) == i)
    return tokens[i], tokens[:i + 1]


def phase_serve_spec(model):
    """Speculative decoding on GPT-2 124M: the engine without a draft (the
    baseline), with the target itself as its draft (self: accepts all but
    ties) and with a 2-layer draft of the same width (reject: rejects almost
    all), contiguous and paged at f32, and the self draft under bf16 O1."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.serving import ServingEngine

    counters = ("serving.verify_dispatches", "serving.spec.proposed",
                "serving.spec.accepted", "serving.spec.bonus", "serving.steps",
                "serving.tokens", "serving.draft_prefill_dispatches")
    drafts = {None: None, "self": model,
              "reject": GPTForPretraining(GPTConfig(num_layers=2), seed=1)}
    engines = {   # name -> (autocast dtype, kv_layout, draft)
        "baseline_f32": (None, "contiguous", None),
        "self_f32": (None, "contiguous", "self"),
        "reject_f32": (None, "contiguous", "reject"),
        "paged_self_f32": (None, "paged", "self"),
        "paged_reject_f32": (None, "paged", "reject"),
        "self_bf16": ("bfloat16", "contiguous", "self"),
    }
    work = _spec_traffic(model.config.vocab_size)
    greedy = [i for i, (_, kw) in enumerate(work) if kw["temperature"] == 0.0]
    out, eos, ties = {}, None, []
    for name, (amp, layout, dkey) in engines.items():
        paged = layout == "paged"
        with auto_cast(enable=amp is not None, dtype=amp or "bfloat16"):
            eng = ServingEngine(model, slot_count=8, ladder=(64, 128, 256, 512),
                                max_new_cap=64, steps_per_dispatch=8, kv_layout=layout,
                                kv_page_tokens=64, draft_model=drafts[dkey],
                                spec_ladder=(4,))
        # each dispatch's wall time (both end in a device read) and the
        # windows' n_draft, read where the engine passes them
        times = {"verify": [], "decode": []}
        drafted = [0]

        def timed(fn, key):
            def call(*args):
                t = time.perf_counter()
                res = fn(*args)
                times[key].append((time.perf_counter() - t) * 1e3)
                if key == "verify":
                    drafted[0] += int(args[1].sum())
                return res
            return call

        eng._verify = timed(eng._verify, "verify")
        eng._decode_chunk = timed(eng._decode_chunk, "decode")
        jobs = [(p, {k: v for k, v in kw.items() if dkey or k != "speculate_k"})
                for p, kw in work]
        if eos is not None:
            jobs[SPEC_EOS_REQUEST][1]["eos_token_id"] = eos
        if paged:
            jobs.append(jobs[SPEC_REPEAT_REQUEST])
        c0 = {c: monitor.stat(c).get() for c in counters}
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=64, **kw) for p, kw in jobs]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c: monitor.stat(c).get() - c0[c] for c in counters}
        tokens = [[int(t) for t in r.tokens] for r in reqs]
        if name == "baseline_f32":
            eos, tokens[SPEC_EOS_REQUEST] = _spec_eos(tokens[SPEC_EOS_REQUEST])
        ok = [r.done and (r.outcome == "length" and len(r.tokens) == 64
                          or r.outcome == "eos" and r.eos_token_id is not None)
              for r in reqs]
        if not all(ok):
            raise AssertionError(f"serve_spec {name}: not every request completed: {ok}")

        want_dtype = torch.float32 if amp is None else torch.bfloat16
        if eng._cache_dtype != want_dtype or (
                dkey and eng._dkcs[0].dtype != eng._cache_dtype):
            raise AssertionError(f"serve_spec {name}: cache {eng._cache_dtype}, draft cache "
                                 f"{eng._dkcs[0].dtype if dkey else None}")
        spec = [(r.spec_proposed, r.spec_accepted, r.spec_bonus) for r in reqs]
        proposed, accepted, bonus = (sum(x) for x in zip(*spec))
        if (counts["serving.spec.proposed"], counts["serving.spec.accepted"],
                counts["serving.spec.bonus"]) != (proposed, accepted, bonus) \
                or proposed != drafted[0] or accepted + bonus > eng.decode_tokens \
                or any(a + b > len(r.tokens) for (_, a, b), r in zip(spec, reqs)) \
                or any(p and not r.speculate_k for (p, _, _), r in zip(spec, reqs)):
            raise AssertionError(f"serve_spec {name}: spec counts {counts}, requests' "
                                 f"{(proposed, accepted, bonus)}, windows' n_draft "
                                 f"{drafted[0]}, decode tokens {eng.decode_tokens}")
        greedy_spec = [spec[i] for i in greedy if work[i][1]["speculate_k"]]
        greedy_accept = (sum(a for _, a, _ in greedy_spec)
                         / max(1, sum(p for p, _, _ in greedy_spec)))
        if dkey == "self" and amp is None and not greedy_accept >= SPEC_SELF_MIN_ACCEPT:
            raise AssertionError(f"serve_spec {name}: greedy acceptance {greedy_accept}")
        if dkey == "reject" and not proposed >= SPEC_REJECT_MIN_PROPOSED:
            raise AssertionError(f"serve_spec {name}: {proposed} proposals")
        rec = {"engine": name, "requests": len(reqs),
               "decode_tokens_per_s": eng.decode_tokens / eng.decode_seconds,
               "decode_tokens": eng.decode_tokens, "decode_s": eng.decode_seconds,
               "verify_dispatches": counts["serving.verify_dispatches"],
               "decode_chunks": len(times["decode"]),
               "target_forwards": counts["serving.steps"],
               "verify_dispatches_per_token":
                   counts["serving.verify_dispatches"] / eng.decode_tokens,
               "target_forwards_per_token": counts["serving.steps"] / eng.decode_tokens,
               "draft_prefills": counts["serving.draft_prefill_dispatches"],
               "proposed": proposed, "accepted": accepted, "bonus": bonus,
               "acceptance": accepted / proposed if proposed else None,
               "greedy_acceptance": greedy_accept if greedy_spec and proposed else None,
               "rollback_pages": eng.rollback_pages, "wall_s": wall}
        for key, ms in times.items():
            if ms:
                rec[f"{key}_ms"] = {"p50": statistics.median(ms), "max": max(ms),
                                    "n": len(ms)}
        if paged:
            st = eng.stats()
            copy = reqs[-1]
            if (st["pages_in_use"] != 0 or st["prefix"]["full_hits"] < 1
                    or not (copy.prefix_hit and copy.tail_bucket == 0
                            and copy.spec_proposed > 0)):
                raise AssertionError(f"serve_spec {name}: pool after the run {st}, "
                                     f"the repeated prompt {copy!r}")
            if dkey == "reject" and not eng.rollback_pages > 0:
                raise AssertionError(f"serve_spec {name}: truncate_row freed no page")
            for pool in (*eng._pool_state["k"], *eng._pool_state["v"]):
                if pool[0].any():
                    raise AssertionError(f"serve_spec {name}: the zero page was written")
            rec.update(pages_cached=st["pages_cached"], prefix=st["prefix"])
        out[name] = (rec, tokens)
        del eng, reqs
        gc.collect()        # the timing wrappers hold the engine in a cycle
        torch.cuda.empty_cache()

    # greedy tokens against the baseline's but at a near-tie of the f32
    # scoring forward (LOGITS_TOL; bf16: BF16_TOL x max|logit|); the
    # non-spec sampled rows exactly (f32)
    base = out["baseline_f32"][1]
    for name, (rec, tokens) in out.items():
        if name == "baseline_f32":
            continue
        bf16 = name.endswith("bf16")
        pairs = [(i, i) for i in greedy]
        if name.startswith("paged"):
            pairs.append((len(tokens) - 1, SPEC_REPEAT_REQUEST))
        for i, b in pairs:
            div = _first_divergence(model, work[b][0], base[b], tokens[i])
            if div is None:
                continue
            j, gap, top = div
            tol = BF16_TOL * top if bf16 else LOGITS_TOL
            ties.append({"engine": name, "request": i, "position": j,
                         "tokens": [base[b][j], tokens[i][j]], "logit_gap": gap, "tol": tol})
            if not gap <= tol:
                raise AssertionError(f"serve_spec {name}: request {i} differs from the "
                                     f"baseline at token {j} where the logits are {gap} "
                                     f"apart (tol {tol})")
        for i, (_, kw) in enumerate(work):
            if kw["temperature"] and not kw["speculate_k"] and not bf16 \
                    and tokens[i] != base[i]:
                raise AssertionError(f"serve_spec {name}: non-spec sampled request {i} "
                                     "differs from the baseline")
    base_tps = out["baseline_f32"][0]["decode_tokens_per_s"]
    for rec, _ in out.values():
        emit(phase="serve_spec", **rec, tokens_per_s_over_baseline=rec["decode_tokens_per_s"]
             / base_tps)
    emit(phase="serve_spec", summary=True, eos_request=SPEC_EOS_REQUEST, eos_token=eos,
         eos_after_tokens=len(base[SPEC_EOS_REQUEST]), near_ties=ties)


FLEET_PREFIX_TOKENS = 192   # serve_fleet: each tenant's shared prompt prefix, 3 pages of 64
FLEET_SCENARIO_S = 3.27     # ... the scenario's span: 48 Poisson arrivals at seed 7
FLEET_REQUESTS = 48
FLEET_DRAIN_AFTER = 24      # ... submissions before r0 begins draining
FLEET_ENGINE = dict(ladder=(64, 128, 256), max_seq_len=512, max_new_cap=32,
                    steps_per_dispatch=8, kv_layout="paged", kv_page_tokens=64)


def _fleet_scenario():
    """serve_fleet's traffic: 48 Poisson arrivals (16/s, seed 7) from 4
    Zipf-skewed tenants, tails of 16-64 tokens, 32 new tokens each."""
    from paddle_tpu_torch.serving import loadgen

    return loadgen.Scenario(
        "serve_fleet", seed=7, duration_s=FLEET_SCENARIO_S,
        arrival={"process": "poisson", "rate_rps": 16.0},
        prompt_len={"dist": "lognormal", "median": 32, "sigma": 0.5, "min": 16, "max": 64},
        max_new={"dist": "fixed", "value": 32}, tenants=loadgen.zipf_tenants(4))


class _DrainAfter:
    """The LoadGenerator's target: the router, with ``begin_drain(name)``
    at the first submission from the n-th on that lands on ``name`` (so
    its queue holds work to re-place), and the time the drain takes."""

    def __init__(self, router, name, n):
        self.router, self.name, self.n = router, name, n
        self.submitted, self.replaced = 0, None
        self.admitted_at_drain = self.drained_at_submission = None
        self.t_drain = self.drain_s = None

    def submit(self, prompt_ids, **kw):
        req = self.router.submit(prompt_ids, **kw)
        self.submitted += 1
        if (self.replaced is None and self.submitted >= self.n
                and self.router.recent_placements()[-1]["replica"] == self.name):
            self.drained_at_submission = self.submitted
            eng = self.router.replicas[self.name]
            self.t_drain = time.perf_counter()
            self.replaced = self.router.begin_drain(self.name)
            self.admitted_at_drain = len(eng._completed) + int(eng._active.sum())
        return req

    def step(self):
        live = self.router.step()
        if (self.t_drain is not None and self.drain_s is None
                and self.router.drained(self.name)):
            self.drain_s = time.perf_counter() - self.t_drain
        return live

    def pending(self):
        return self.router.pending()


def _tokens_or_tie(model, what, prompt, want, got):
    """got equals want, or they first part where the scoring forward's two
    logits are at most LOGITS_TOL apart (a near-tie: other GEMM shapes);
    returns the tie or None."""
    d = _first_divergence(model, prompt, want, got)
    if d is None:
        return None
    j, gap, _ = d
    if not gap <= LOGITS_TOL:
        raise AssertionError(f"serve_fleet {what}: tokens differ at {j} where the logits "
                             f"are {gap} apart (tol {LOGITS_TOL})")
    return {"what": what, "position": j, "logit_gap": gap}


def phase_serve_fleet(model):
    """The serving fleet on GPT-2 124M (f32, paged, 64-token pages): one
    16-slot engine serves the 48 requests as the reference; then a
    ReplicaRouter over two 8-slot replicas, driven by the LoadGenerator on
    the wall clock, drains r0 after 24 submissions and removes it; SIGTERM
    and a timed-out drain on engines of their own; a CapacityController
    (injected clock) scales out through a spawn on the card and back in.
    The replicas step one after the other on the card's one stream."""
    import signal

    from paddle_tpu_torch.bench import card_name_and_power_limit
    from paddle_tpu_torch.distributed import membership
    from paddle_tpu_torch.observability import (CapacityController, CapacityPolicy,
                                                metrics, slo, tracer)
    from paddle_tpu_torch.serving import LoadGenerator, ReplicaRouter, ServingEngine

    card = card_name_and_power_limit()
    t_phase = time.perf_counter()
    vocab = model.config.vocab_size
    sc = _fleet_scenario()
    rows = sc.schedule()
    if len(rows) != FLEET_REQUESTS:
        raise AssertionError(f"serve_fleet: the scenario has {len(rows)} arrivals")
    rng = np.random.RandomState(7)
    prefixes = {t["name"]: rng.randint(0, vocab, (FLEET_PREFIX_TOKENS,)).astype(np.int64)
                for t in sc.tenants}

    def prompt_of(row):
        tail = sc.prompt_tokens(row["i"], row["prompt_len"], vocab)
        return np.concatenate([prefixes[row["tenant"]], np.asarray(tail, np.int64)])

    prompts = [prompt_of(r) for r in rows]

    # the reference: one engine of 16 slots, all 48 requests at once
    ref = ServingEngine(model, slot_count=16, **FLEET_ENGINE)
    t0 = time.perf_counter()
    ref_reqs = [ref.submit(p, max_new_tokens=32) for p in prompts]
    ref.run()
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    if not all(r.done and r.outcome == "length" and len(r.tokens) == 32 for r in ref_reqs):
        raise AssertionError("serve_fleet: the reference engine left a request unfinished")
    want = [r.tokens for r in ref_reqs]
    ref_tps = ref.decode_tokens / ref.decode_seconds
    ref_occ = ref.decode_tokens / (ref._steps * ref.slot_count)
    del ref, ref_reqs
    torch.cuda.empty_cache()

    # the fleet: registry and tracer on, the LoadGenerator on the wall clock
    metrics.reset()
    reg = metrics.enable()
    tr = tracer.get_tracer()
    tr.clear()
    tr.enable()
    engines = {n: ServingEngine(model, slot_count=8, **FLEET_ENGINE) for n in ("r0", "r1")}
    router = ReplicaRouter(engines)
    target = _DrainAfter(router, "r0", FLEET_DRAIN_AFTER)
    lg = LoadGenerator(sc, target, prompt_fn=prompt_of, time_scale=1.0)
    t0 = time.perf_counter()
    handles = lg.run()
    torch.cuda.synchronize()
    fleet_wall = time.perf_counter() - t0
    tr.disable()
    r0, r1 = engines["r0"], engines["r1"]
    replaced = {tuple(r.prompt_ids): r for r in target.replaced}
    final = [req if req.done else replaced[tuple(req.prompt_ids)] for _, req in handles]
    ties = [t for i, req in enumerate(final)
            if (t := _tokens_or_tie(model, f"fleet request {i}", prompts[i], want[i],
                                    req.tokens)) is not None]
    if not all(r.done and r.outcome == "length" and len(r.tokens) == 32 for r in final):
        raise AssertionError("serve_fleet: a fleet request did not complete")
    if not router.prefix_routed > 0:
        raise AssertionError("serve_fleet: no placement followed a cached prefix")
    r1_done = {id(r) for r in r1._completed}
    if target.replaced is None or not (
            target.replaced and all(id(r) in r1_done for r in target.replaced)):
        raise AssertionError("serve_fleet: a re-placed request did not complete on r1")
    if len(r0._completed) != target.admitted_at_drain:
        raise AssertionError(f"serve_fleet: r0 admitted {len(r0._completed)} requests, "
                             f"{target.admitted_at_drain} before its drain")
    counters = reg.snapshot(include_monitor=False)["counters"]
    if (counters.get("route.requests") != FLEET_REQUESTS
            or counters.get("route.replaced") != len(target.replaced)
            or counters.get("serve.requests") != FLEET_REQUESTS):
        raise AssertionError(f"serve_fleet: counters {counters}")
    prom = reg.to_prometheus().splitlines()
    for line in (f"paddle_tpu_serve_requests_total {FLEET_REQUESTS}",
                 f"paddle_tpu_route_requests_total {FLEET_REQUESTS}"):
        if line not in prom:
            raise AssertionError(f"serve_fleet: the Prometheus text lacks {line!r}")
    fleet_tps = ((r0.decode_tokens + r1.decode_tokens)
                 / (r0.decode_seconds + r1.decode_seconds))
    # mean active share of the slots over the decode steps
    fleet_occ = ((r0.decode_tokens + r1.decode_tokens)
                 / (r0._steps * r0.slot_count + r1._steps * r1.slot_count))

    # the trace, from its file: every request's queue wait, prefill (a
    # partial prefix hit's tail) and decode carry its request id and its
    # placement's span id as their parent
    with tempfile.TemporaryDirectory() as out_dir:
        path = tr.export_chrome_trace(os.path.join(out_dir, "serve_fleet_trace.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = collections.defaultdict(list)
    for e in events:
        a = e.get("args") or {}
        if "request" in a and e["name"].startswith("serve."):
            spans[a["request"]].append(e)
    places = [e for e in events if e["name"] == "route.place"]
    for req in final:
        ctx = req.trace_ctx
        place = [e for e in places if e["args"]["span_id"] == ctx.parent_span]
        if len(place) != 1 or place[0]["args"]["request_id"] != ctx.request_id:
            raise AssertionError(f"serve_fleet trace: request {req.id} has no placement span")
        mine = spans[req.id]
        for name in ("serve.queue_wait", "serve.prefill", "serve.decode"):
            got = [e for e in mine if e["name"] == name]
            if len(got) != 1 or got[0]["args"].get("request_id") != ctx.request_id \
                    or got[0]["args"].get("parent_span") != ctx.parent_span:
                raise AssertionError(f"serve_fleet trace: request {req.id}'s {name} "
                                     f"spans {got}")
    place_us = statistics.median(e["dur"] for e in places)

    # r0 drained: removed, its weights and pages freed
    if not router.drained("r0"):
        raise AssertionError("serve_fleet: r0 is not drained")
    r0_bytes = r0.kv_cache_bytes() + sum(p.numel() * p.element_size()
                                         for p in r0._net.parameters())
    before = torch.cuda.memory_allocated()
    router.remove_replica("r0")
    del r0, engines["r0"]
    gc.collect()
    torch.cuda.empty_cache()
    freed = before - torch.cuda.memory_allocated()
    if freed < r0_bytes:
        raise AssertionError(f"serve_fleet: removing r0 freed {freed} B, "
                             f"below its {r0_bytes} B of pages and weights")

    # SIGTERM in mid-decode: admission closes, drain() completes the slots
    sig = ServingEngine(model, slot_count=8, **FLEET_ENGINE)
    sig_reqs = [sig.submit(p, max_new_tokens=32) for p in prompts[:8]]
    sig.step()
    sig.step()
    prev = signal.getsignal(signal.SIGTERM)
    pre0 = membership.PREEMPTIONS.get()
    try:
        sig.install_sigterm_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        if not sig._draining:
            raise AssertionError("serve_fleet: SIGTERM did not close admission")
        try:
            sig.submit(prompts[8], max_new_tokens=32)
        except RuntimeError:
            pass
        else:
            raise AssertionError("serve_fleet: a draining engine took a request")
        t0 = time.perf_counter()
        sig.drain()
        sig_drain_s = time.perf_counter() - t0
    finally:
        signal.signal(signal.SIGTERM, prev)
    drain_ms = reg.histogram("elastic.drain_ms").snapshot()["max"]
    if not (all(r.outcome == "length" and len(r.tokens) == 32 for r in sig_reqs)
            and sig.stats()["pages_in_use"] == 0 and sig.stats()["draining"]
            and membership.PREEMPTIONS.get() == pre0 + 1):
        raise AssertionError("serve_fleet: the SIGTERM drain left work or pages")
    ties += [t for i, r in enumerate(sig_reqs)
             if (t := _tokens_or_tie(model, f"sigterm request {i}", prompts[i], want[i],
                                     r.tokens)) is not None]
    del sig

    # drain(timeout_s=0): the active requests finish "drained", pages freed
    cut = ServingEngine(model, slot_count=8, **FLEET_ENGINE)
    cut_reqs = [cut.submit(p, max_new_tokens=32) for p in prompts[:8]]
    cut.step()
    in_use = cut.stats()["pages_in_use"]
    cut.drain(timeout_s=0)
    st = cut.stats()
    if not (in_use > 0 and st["pages_in_use"] == 0 and not cut._completed
            and all(r.outcome == "drained" for r in cut_reqs)):
        raise AssertionError(f"serve_fleet: drain(timeout_s=0) left {st['pages_in_use']} "
                             f"pages in use of {in_use}, outcomes "
                             f"{[r.outcome for r in cut_reqs]}")
    del cut

    # capacity: a page alert scales out through a spawn on the card, the
    # spawned replica serves (r1 shed), then idle with budget scales back in
    clock = [10.0]
    spawned = []

    def spawn(name):
        spawned.append(name)
        return ServingEngine(model, slot_count=8, **FLEET_ENGINE)

    spec = slo.ratio_slo("serve.availability", "serve.errors", "serve.requests", 0.99,
                         windows=[slo.BurnWindow(40.0, 10.0, 2.0, "page")])
    judge = slo.SloEngine(specs=[spec])
    judge.tick(now=0.0, snapshot={"counters": {"serve.requests": 100.0}})
    judge.tick(now=10.0, snapshot={"counters": {"serve.requests": 200.0,
                                                "serve.errors": 50.0}})
    ctl = CapacityController(router, spawn, slo_engine=judge, clock=lambda: clock[0],
                             policy=CapacityPolicy(min_replicas=1, max_replicas=2,
                                                   cooldown_s=5.0, idle_sustain_s=1.0))
    decisions = [ctl.poll()]
    router.shed("r1")
    cap_reqs = [router.submit(p, max_new_tokens=32) for p in prompts[:8]]
    router.run()
    on_r2 = {id(r) for r in router.replicas["r2"]._completed}
    router.unshed("r1")
    for t in (100.0, 101.0):     # idle since the first poll: in, then reaped
        clock[0] = t
        judge.tick(now=t, snapshot={"counters": {"serve.requests": 200.0,
                                                 "serve.errors": 50.0}})
        decisions.append(ctl.poll())
    r2_done = all(r.done and id(r) in on_r2 for r in cap_reqs)
    if not ([d["action"] for d in decisions] == ["scale_out", "scale_in", "hold"]
            and spawned == ["r2"] and sorted(router.replicas) == ["r1"]
            and ctl.scale_outs == 1 and ctl.scale_ins == 1 and r2_done):
        raise AssertionError(f"serve_fleet capacity: {[_d(d) for d in decisions]}, "
                             f"replicas {sorted(router.replicas)}")
    ties += [t for i, r in enumerate(cap_reqs)
             if (t := _tokens_or_tie(model, f"spawned replica request {i}", prompts[i],
                                     want[i], r.tokens)) is not None]
    metrics.reset()
    tr.clear()
    torch.cuda.empty_cache()

    wall = time.perf_counter() - t_phase
    emit(phase="serve_fleet", card=card, requests=FLEET_REQUESTS,
         reference_decode_tokens_per_s=ref_tps, fleet_decode_tokens_per_s=fleet_tps,
         fleet_over_reference=fleet_tps / ref_tps, reference_occupancy=ref_occ,
         fleet_occupancy=fleet_occ, reference_wall_s=ref_wall,
         fleet_wall_s=fleet_wall, route_place_p50_us=place_us,
         elastic_drain_ms=drain_ms, sigterm_drain_s=sig_drain_s,
         r0_drain_s=target.drain_s, r0_drained_at_submission=target.drained_at_submission,
         replaced=len(target.replaced),
         prefix_routed=router.prefix_routed, routed=dict(router.routed),
         r0_freed_bytes=freed, r0_pages_and_weights_bytes=r0_bytes,
         capacity=[_d(d) for d in decisions], near_ties=ties, phase_s=wall)
    for what, v in (("fleet decode tokens/s", fleet_tps),
                    ("single-engine decode tokens/s", ref_tps),
                    ("p50 route.place us", place_us),
                    ("elastic.drain_ms", drain_ms), ("serve_fleet seconds", wall)):
        print(f"serve_fleet: {what} {v:.3f} ({card})", flush=True)


def quant_model_bytes(cfg, quantized):
    """Bytes of GPT's parameters and buffers reckoned from ``cfg``: f32, or
    with every projection weight-only int8 (a QuantizedLinear's int8 weight,
    its f32 per-row scale and bias); embeddings and LayerNorms f32."""
    h, f = cfg.hidden_size, cfg.ffn_hidden_size
    proj = ((3 * h, h), (h, h), (f, h), (h, f))          # (out, in) of qkv, out, fc1, fc2
    weights, rows = sum(o * i for o, i in proj), sum(o for o, _ in proj)
    block = (weights + 8 * rows if quantized else 4 * (weights + rows)) + 4 * 4 * h
    return 4 * (cfg.vocab_size * h + cfg.max_seq_len * h + 2 * h) + cfg.num_layers * block


def _kernels_per_decode_token(model, prompt):
    """CUDA kernels one greedy decode token launches (torch.profiler: a
    3-token ``generate`` less a 2-token one, under the active autocast)."""
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for n in (2, 3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.generate(prompt, max_new_tokens=n, temperature=0)
            torch.cuda.synchronize()
        counts.append(sum(e.device_type == torch.autograd.DeviceType.CUDA
                          for e in prof.events()))
    return counts[1] - counts[0]


def _card_bytes(model):
    return sum(t.numel() * t.element_size() for t in (*model.parameters(), *model.buffers()))


def phase_quant(model, ids):
    """incubate.quantization on GPT-2 124M (``model``, f32, seed-0 weights):

    - decode: bench_decode's run (8 rows, a 128-token prompt, 64 new tokens,
      bf16 O1, the second of two calls) of the plain model, of its
      weight-only int8 copy (``quantize_model``) and of a dynamic int8 copy,
      in the order plain, int8, dynamic, dynamic, int8, plain: decode
      tokens/s of each, and each model's card bytes against
      ``quant_model_bytes``;
    - the weight-only model's f32 scoring logits of ids[:1] against the
      same quantization run on the CPU (LOGITS_TOL), its int8 weights and
      scales bit-equal to the CPU's, and 12 launches of the 3xTF32 flash
      forward;
    - a dynamic and a static projection at the model's widths (qkv
      [rows, 768] x [768, 2304], fc2 [rows, 3072] x [3072, 768]; rows 8,
      a decode step, padded for torch._int_mm, and 1024): int8
      activations and the int32 accumulator bit-equal to the CPU's; the
      int8 GEMM's and the bf16 GEMM's ms at 1024 rows;
    - the weight-only model served (f32, 8 slots) from the contiguous cache
      and from 64-token pages: 8 greedy requests of 32 new tokens, each
      equal to the model's own greedy ``generate`` but at a near-tie of
      the scoring forward's logits (LOGITS_TOL);
    - QAT: ``ImperativeQuantAware().quantize`` on a fresh seed-0 124M, one
      eager calibrating forward, then TrainStepEngine (AdamW 1e-4, bf16
      O1) 1 + 3 steps on ids [8, 1024]: losses finite and falling, 12
      tensor-core launches of each flash kernel a step, the activation
      scales frozen inside the engine; ``convert`` to weight_only_int8 and
      a greedy bf16 ``generate``;
    - PTQ: calibrate on two batches, ``convert`` to static_int8 and a greedy
      f32 ``generate``.

    Every number is printed with the card's name and power limit."""
    import copy

    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.bench import card_name_and_power_limit
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.incubate import quantization as Q
    from paddle_tpu_torch.models import GPTForPretraining
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.serving import ServingEngine

    card = card_name_and_power_limit()
    t_phase = time.perf_counter()
    cfg = model.config
    vocab, nl = cfg.vocab_size, cfg.num_layers
    qm = Q.quantize_model(copy.deepcopy(model)).eval()
    dm = Q.quantize_model(copy.deepcopy(model), "dynamic_int8")
    n_q = sum(isinstance(m, Q.QuantizedLinear) for m in qm.modules())
    if n_q != 4 * nl or any(isinstance(m, torch.nn.Linear) for m in qm.modules()):
        raise AssertionError(f"quant: {n_q} QuantizedLinear layers, expected {4 * nl} "
                             "and no Linear left")
    card_bytes = {"f32": _card_bytes(model), "weight_only_int8": _card_bytes(qm)}
    want_bytes = {"f32": quant_model_bytes(cfg, False),
                  "weight_only_int8": quant_model_bytes(cfg, True)}
    if card_bytes != want_bytes:
        raise AssertionError(f"quant: card bytes {card_bytes}, reckoned {want_bytes}")

    # decode: bench_decode's run, the second of two calls, in turns
    prompt = torch.from_numpy(np.random.RandomState(1).randint(
        0, vocab, (8, 128)).astype(np.int64)).cuda()
    models = {"bf16": model, "weight_only_int8": qm, "dynamic_int8": dm}
    decode_tps = {k: [] for k in models}
    outs = {}
    with auto_cast(dtype="bfloat16"):
        for name in ("bf16", "weight_only_int8", "dynamic_int8",
                     "dynamic_int8", "weight_only_int8", "bf16"):
            m = models[name]
            m.generate(prompt, max_new_tokens=64, temperature=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = m.generate(prompt, max_new_tokens=64, temperature=0)
            int(out[0, -1])
            decode_tps[name].append(8 * 64 / (time.perf_counter() - t0))
            outs[name] = out
    for name, out in outs.items():
        if tuple(out.shape) != (8, 192) or not bool(((out >= 0) & (out < vocab)).all()):
            raise AssertionError(f"quant: {name} generate gave {tuple(out.shape)} or ids "
                                 "out of the vocabulary")
    agree = {k: float((outs[k][:, 128:] == outs["bf16"][:, 128:]).float().mean())
             for k in ("weight_only_int8", "dynamic_int8")}
    with auto_cast(dtype="bfloat16"):
        kernels_per_token = {k: _kernels_per_decode_token(m, prompt) for k, m in models.items()}
    del dm

    # f32 scoring on the card against the CPU, through the 3xTF32 forward
    cpu_q = Q.quantize_model(GPTForPretraining(cfg, device="cpu", seed=0).eval())
    cpu_state = cpu_q.state_dict()
    for name, t in qm.state_dict().items():
        if name.endswith(("_w_int8", "_scale")) and not torch.equal(t.cpu(), cpu_state[name]):
            raise AssertionError(f"quant: {name} differs between the card and the CPU")
    _reset_launch_counts()
    with torch.no_grad():
        logits = qm(ids[:1])
    torch.cuda.synchronize()
    routes = dict(fa.launches_by_route)
    if routes != {"mma": 0, "tf32x3": nl, "fma": 0}:
        raise AssertionError(f"quant: the f32 scoring forward's flash launches {routes}, "
                             f"expected {nl} 3xTF32")
    with torch.no_grad():
        ref = cpu_q(ids[:1].cpu())
    score_err = (logits.cpu() - ref).abs().max().item()
    if not (bool(torch.isfinite(logits).all()) and score_err <= LOGITS_TOL):
        raise AssertionError(f"quant: card vs CPU logits differ by {score_err}")
    del logits, ref, cpu_q, cpu_state

    # int8 activations and int32 accumulators at the model's widths
    blk = qm.gpt.blocks[0]
    gen = torch.Generator().manual_seed(5)
    acc_cases = []
    for lname, layer in (("qkv_proj", blk.attn.qkv_proj), ("fc2", blk.mlp.fc2)):
        w_card = layer._w_int8
        k = w_card.shape[1]
        for rows in (8, 1024):
            x = torch.randn(rows, k, generator=gen)
            for how, quant in (("dynamic", Q._quantize_rows),
                               ("static", lambda a: Q._quantize_static(a, torch.tensor(0.02)))):
                x_q, _ = quant(x)
                x_qc, _ = quant(x.cuda())
                acc = Q._int8_mm(x_qc, w_card)
                if not (torch.equal(x_qc.cpu(), x_q)
                        and torch.equal(acc.cpu(), Q._int8_mm(x_q, w_card.cpu()))):
                    raise AssertionError(f"quant: {how} {lname} at {rows} rows: the card's "
                                         "int8 activations or int32 accumulator differ")
                acc_cases.append(f"{how} {lname} [{rows}, {k}] x [{k}, {w_card.shape[0]}]")
    w8 = blk.attn.qkv_proj._w_int8
    x8 = torch.randint(-127, 128, (1024, w8.shape[1]), dtype=torch.int8, device=w8.device)
    xb, wb = x8.to(torch.bfloat16), w8.to(torch.bfloat16)
    int8_gemm_ms = cuda_ms(lambda: Q._int8_mm(x8, w8), iters=50)
    bf16_gemm_ms = cuda_ms(lambda: torch.matmul(xb, wb.t()), iters=50)

    # the quantized model served: each request's tokens = generate's
    serve_prompts = [ids[i, :n].cpu().numpy() for i, n in
                     enumerate((17, 40, 64, 90, 128, 150, 200, 33))]
    ties, engine_tps = [], {}
    want = [qm.generate(torch.from_numpy(p)[None].cuda(), max_new_tokens=32,
                        temperature=0)[0, len(p):].tolist() for p in serve_prompts]
    for layout in ("contiguous", "paged"):
        kw = dict(kv_layout="paged", kv_page_tokens=64) if layout == "paged" else {}
        eng = ServingEngine(qm, slot_count=8, ladder=(64, 128, 256), max_new_cap=32,
                            steps_per_dispatch=8, **kw)
        if eng._net.gpt.blocks[0].mlp.fc1._w_int8.dtype != torch.int8:
            raise AssertionError(f"quant: the {layout} engine does not serve int8 weights")
        reqs = [eng.submit(p, max_new_tokens=32, temperature=0.0) for p in serve_prompts]
        eng.run()
        engine_tps[layout] = eng.decode_tokens / eng.decode_seconds
        for p, r, w in zip(serve_prompts, reqs, want):
            d = _first_divergence(qm, p, w, r.tokens)
            if d is not None:
                if not d[1] <= LOGITS_TOL:
                    raise AssertionError(f"quant: {layout} engine tokens differ from "
                                         f"generate's at {d[0]}, logits {d[1]} apart")
                ties.append({"layout": layout, "prompt": len(p), "position": d[0],
                             "logit_gap": d[1]})
        del eng
    del qm
    gc.collect()
    torch.cuda.empty_cache()

    # QAT through the engine (bf16 O1), then convert
    qat_model = GPTForPretraining(cfg, seed=0)
    qat = Q.ImperativeQuantAware()
    qat.quantize(qat_model)
    qats = [m for m in qat_model.modules() if isinstance(m, Q.QATLinear)]
    if len(qats) != 4 * nl:
        raise AssertionError(f"quant: {len(qats)} QATLinear layers")
    labels = torch.roll(ids, -1, 1)
    opt = AdamW(learning_rate=1e-4, parameters=qat_model.named_parameters(),
                weight_decay=0.01)
    engine = TrainStepEngine(qat_model, opt)
    with auto_cast(dtype="bfloat16"):
        with torch.no_grad():
            qat_model(ids, labels)            # eager: calibrates the moving averages
        scales0 = [float(m._act_scale) for m in qats]
        if min(scales0) <= 0:
            raise AssertionError("quant: the eager forward left an activation scale at 0")
        losses, _ = _steps(engine, ids, labels, 1)
        _reset_launch_counts()
        timed, qat_ms = _steps(engine, ids, labels, 3)
        qat_launches, fwd_routes, bwd_routes = (_launch_counts(), dict(fa.launches_by_route),
                                                _bwd_routes())
    losses += timed
    n = 3 * nl
    if (set(qat_launches.values()) != {n} or fwd_routes["mma"] != n
            or bwd_routes["mma"] != {"dkdv": n, "dq": n}):
        raise AssertionError(f"quant: 3 QAT steps launched {qat_launches} ({fwd_routes}, "
                             f"{bwd_routes}), expected {n} of each on the tensor cores")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"quant: QAT losses {losses} not finite or not falling")
    if [float(m._act_scale) for m in qats] != scales0:
        raise AssertionError("quant: an activation scale moved inside the engine")
    del engine, opt
    qat.convert(qat_model.eval())
    if sum(isinstance(m, Q.QuantizedLinear) for m in qat_model.modules()) != 4 * nl:
        raise AssertionError("quant: convert left a QATLinear")
    with auto_cast(dtype="bfloat16"):
        qat_out = qat_model.generate(prompt, max_new_tokens=32, temperature=0)
    if not bool(((qat_out >= 0) & (qat_out < vocab)).all()):
        raise AssertionError("quant: the converted QAT model's ids leave the vocabulary")
    del qat_model, qat_out
    gc.collect()
    torch.cuda.empty_cache()

    # PTQ: two calibration batches, static int8, greedy f32 generate
    pm = copy.deepcopy(model)
    ptq = Q.PostTrainingQuantization(pm)
    for rows in (slice(0, 2), slice(2, 4)):
        ptq.collect(ids[rows, :512])
    if len(ptq.scales) != 4 * nl or min(ptq.scales.values()) <= 0:
        raise AssertionError(f"quant: PTQ recorded {len(ptq.scales)} scales")
    ptq.convert("static_int8")
    if any(m._forward_pre_hooks for m in pm.modules()):
        raise AssertionError("quant: PTQ left a calibration hook")
    static_out = pm.generate(prompt, max_new_tokens=32, temperature=0)
    plain_out = model.generate(prompt, max_new_tokens=32, temperature=0)
    if not bool(((static_out >= 0) & (static_out < vocab)).all()):
        raise AssertionError("quant: the static int8 model's ids leave the vocabulary")
    static_agree = float((static_out[:, 128:] == plain_out[:, 128:]).float().mean())
    del pm, static_out, plain_out
    gc.collect()
    torch.cuda.empty_cache()

    wall = time.perf_counter() - t_phase
    emit(phase="quant", model="gpt2-124m", card=card,
         decode={"amp": "bfloat16 O1", "batch": 8, "prompt": 128, "new_tokens": 64,
                 "tokens_per_s": decode_tps,
                 "ratio_to_bf16": {k: statistics.mean(v) / statistics.mean(decode_tps["bf16"])
                                   for k, v in decode_tps.items()},
                 "greedy_tokens_equal_bf16_share": agree,
                 "cuda_kernels_per_token": kernels_per_token},
         card_bytes=card_bytes, card_bytes_ratio=card_bytes["weight_only_int8"] / card_bytes["f32"],
         score_logits_max_abs_err_vs_cpu=score_err, score_tol=LOGITS_TOL,
         score_launches_by_route=routes, accumulator_bit_equal=acc_cases,
         int8_gemm_ms=int8_gemm_ms, bf16_gemm_ms=bf16_gemm_ms,
         gemm=f"[1024, {w8.shape[1]}] x [{w8.shape[1]}, {w8.shape[0]}]",
         engine_decode_tokens_per_s=engine_tps,
         engine_near_ties=ties, qat={"losses": losses, "step_ms": qat_ms,
                                     "launches": qat_launches, "act_scales_frozen": True},
         ptq={"scales": len(ptq.scales), "static_greedy_tokens_equal_f32_share": static_agree},
         seconds=wall)
    for what, v in (*((f"{k} decode tokens/s", statistics.mean(t)) for k, t in decode_tps.items()),
                    ("weight_only_int8 card bytes", card_bytes["weight_only_int8"]),
                    ("f32 card bytes", card_bytes["f32"]), ("int8 GEMM ms", int8_gemm_ms),
                    ("bf16 GEMM ms", bf16_gemm_ms), ("QAT step ms", statistics.median(qat_ms)),
                    ("quant seconds", wall)):
        print(f"quant: {what} {v:.4f} ({card})", flush=True)


def _d(decision):
    """A capacity decision without its wall clock and signals."""
    return {k: v for k, v in decision.items() if k not in ("ts", "signals")}


def _launch_counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dkdv": fa.launches_bwd("dkdv"),
            "flash_attention_bwd_dq": fa.launches_bwd("dq")}


def _reset_launch_counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    fa.launches = 0
    for r in fa.launches_by_route:
        fa.launches_by_route[r] = 0
    for counts in fa.launches_bwd_by_route.values():
        counts["dkdv"] = counts["dq"] = 0


def _bwd_routes():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return {r: dict(c) for r, c in fa.launches_bwd_by_route.items()}


def _train_engine(cfg, device, seed=0):
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.models import GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForPretraining(cfg, device=device, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                weight_decay=0.01)
    return model, TrainStepEngine(model, opt)


def _steps(engine, ids, labels, n):
    """n engine steps; returns (losses, host ms of each, ending in a device
    read)."""
    losses, step_ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(engine.step(ids, labels).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms


def phase_train(ids):
    """bench.py's step on the port: GPT-2 124M, bf16 auto_cast, AdamW; then
    the same step in f32 (the 3xTF32 forward and backward pair).
    Returns the launch counts of the timed bf16 steps (the main path's run)
    and of the four f32 steps, each {kernel: n}."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    cfg = GPTConfig()
    model, engine = _train_engine(cfg, "cuda")
    labels = torch.roll(ids, -1, 1)
    warmup, steps = 3, 10
    torch.cuda.reset_peak_memory_stats()
    with auto_cast(dtype="bfloat16"):
        losses, _ = _steps(engine, ids, labels, warmup)
        _reset_launch_counts()
        timed, step_ms = _steps(engine, ids, labels, steps)
        launches = _launch_counts()
        fwd_routes = dict(fa.launches_by_route)
        bwd_routes = _bwd_routes()
        peak = torch.cuda.max_memory_allocated()
        losses += timed
        for name, n in launches.items():
            if n != steps * cfg.num_layers:
                raise AssertionError(f"{steps} train steps launched {name} {n} "
                                     f"times, expected {steps * cfg.num_layers}")
        if fwd_routes != {"mma": steps * cfg.num_layers, "tf32x3": 0, "fma": 0}:
            raise AssertionError(f"the bf16 train steps' flash forwards took {fwd_routes}, "
                                 f"expected all {steps * cfg.num_layers} on the tensor cores")
        n = steps * cfg.num_layers
        if bwd_routes != {"mma": {"dkdv": n, "dq": n}, "tf32x3": {"dkdv": 0, "dq": 0},
                          "fma": {"dkdv": 0, "dq": 0}}:
            raise AssertionError(f"the bf16 train steps' flash backwards took {bwd_routes}, "
                                 f"expected all {n} of each on the tensor cores")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite training loss: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses}")
        for name, p in model.named_parameters():
            g = p.grad
            if g is None or not bool(torch.isfinite(g).all()) or not bool(g.any()):
                raise AssertionError(f"the gradient of {name} is missing, "
                                     f"non-finite or all zero")
        median_ms = statistics.median(step_ms)
        wall, kernel_ms, top = device_profile(lambda: engine.step(ids, labels),
                                              top=10)
    emit(phase="train", model="gpt2-124m", batch=list(ids.shape), amp="bfloat16 O1",
         optimizer="AdamW(lr=1e-4, weight_decay=0.01)", warmup_steps=warmup,
         timed_steps=steps, losses=losses, step_ms=step_ms, step_ms_median=median_ms,
         tokens_per_s=ids.numel() / (median_ms / 1e3),
         launches=launches, launches_per_step={k: v // steps for k, v in launches.items()},
         flash_fwd_launches_by_route=fwd_routes, flash_bwd_launches_by_route=bwd_routes,
         max_memory_allocated_bytes=peak)
    emit(phase="profile", what="train_step", batch=list(ids.shape),
         wall_ms_untraced=median_ms, wall_ms_traced=wall, kernel_ms=kernel_ms,
         device_busy_share=kernel_ms / median_ms, top_kernels=top)

    # the same step without autocast: every product at f32 accuracy (no
    # TF32 in PyTorch's own; the flash forward and backward pair in 3xTF32)
    _reset_launch_counts()
    f32_losses, f32_ms = _steps(engine, ids, labels, 4)
    f32_launches = _launch_counts()
    f32_fwd_routes, f32_bwd_routes = dict(fa.launches_by_route), _bwd_routes()
    n = 4 * cfg.num_layers
    if f32_fwd_routes != {"mma": 0, "tf32x3": n, "fma": 0} or f32_bwd_routes != {
            "mma": {"dkdv": 0, "dq": 0}, "tf32x3": {"dkdv": n, "dq": n},
            "fma": {"dkdv": 0, "dq": 0}}:
        raise AssertionError(f"the 4 f32 train steps' flash kernels took {f32_fwd_routes} "
                             f"and {f32_bwd_routes}, expected {n} 3xTF32 launches of the "
                             f"forward and of each backward kernel")
    if not all(math.isfinite(x) for x in f32_losses):
        raise AssertionError(f"non-finite f32 training loss: {f32_losses}")
    f32_median = statistics.median(f32_ms[1:])
    wall, kernel_ms, top = device_profile(lambda: engine.step(ids, labels), top=10)
    emit(phase="train_f32", model="gpt2-124m", batch=list(ids.shape),
         warmup_steps=1, timed_steps=3, losses=f32_losses, step_ms=f32_ms[1:],
         step_ms_median=f32_median, tokens_per_s=ids.numel() / (f32_median / 1e3),
         launches=f32_launches, flash_fwd_launches_by_route=f32_fwd_routes,
         flash_bwd_launches_by_route=f32_bwd_routes)
    emit(phase="profile", what="train_step_f32", batch=list(ids.shape),
         wall_ms_untraced=f32_median, wall_ms_traced=wall, kernel_ms=kernel_ms,
         device_busy_share=kernel_ms / f32_median, top_kernels=top)
    return launches, f32_launches


def phase_train_vs_cpu():
    """One f32 step at full width, 2 layers, [1, 1024]: card (the 3xTF32
    forward and backward pair) vs CPU; then the same step with each new
    optimizer rule (``_rules_vs_cpu``)."""
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    cfg = GPTConfig(num_layers=2)
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen)
    labels = torch.roll(ids, -1, 1)
    out = {}
    for device in ("cuda", "cpu"):
        model, engine = _train_engine(cfg, device, seed=1)
        _reset_launch_counts()
        loss = engine.step(ids, labels).item()
        out[device] = (loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
                       _launch_counts(), (dict(fa.launches_by_route), _bwd_routes()))
        del model, engine
    (l_gpu, g_gpu, n_gpu, r_gpu), (l_cpu, g_cpu, n_cpu, _) = out["cuda"], out["cpu"]
    if set(n_gpu.values()) != {cfg.num_layers} or set(n_cpu.values()) != {0}:
        raise AssertionError(f"launches: card {n_gpu}, CPU {n_cpu}")
    n = cfg.num_layers
    if r_gpu != ({"mma": 0, "tf32x3": n, "fma": 0},
                 {"mma": {"dkdv": 0, "dq": 0}, "tf32x3": {"dkdv": n, "dq": n},
                  "fma": {"dkdv": 0, "dq": 0}}):
        raise AssertionError(f"the f32 step's flash kernels took {r_gpu}, expected the "
                             f"3xTF32 forward and pair")
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"card vs CPU loss {l_gpu} vs {l_cpu}")
    worst = {}
    for name, g in g_cpu.items():
        scale = g.abs().max().item()
        err = (g_gpu[name] - g).abs().max().item()
        worst[name] = err / scale if scale else err
        if not err <= TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"card vs CPU gradient of {name}: {err} "
                                 f"(max|g| {scale})")
    name = max(worst, key=worst.get)
    emit(phase="train_vs_cpu", model="gpt2-124m width, 2 layers", batch=[1, 1024],
         dtype="float32", loss_card=l_gpu, loss_cpu=l_cpu, loss_rel_err=loss_err,
         loss_rtol=TRAIN_LOSS_RTOL, params=len(g_cpu),
         grad_worst_rel_err=worst[name], grad_worst_param=name,
         grad_tol=TRAIN_GRAD_TOL)
    _rules_vs_cpu(cfg, ids, labels, l_cpu, g_cpu)


# the JAX package's optimizer slots (paddle_tpu/optimizer/functional.py:18-39):
# count per rule, each f32 and of its parameter's shape
OBS_HEALTH_RTOL = 1e-4   # train_obs: the health record's norms against a plain recomputation
OBS_POISON = "gpt.blocks.5.mlp.fc1.bias"   # ... the parameter whose gradient is made inf
OBS_TIMED_STEPS = 3      # ... steps of each observability setting a turn (two turns)


def _clone_state(engine):
    """A copy of the engine's parameters and optimizer slots."""
    return ({n: p.detach().clone() for n, p in engine.params.items()},
            {n: tuple(s.clone() for s in slots)
             for n, slots in engine.optimizer._states.items()})


def _load_state(engine, state, step=0):
    params, opt = state
    engine._load_state(params, opt, step, step)


def _same_params(a, b):
    return all(torch.equal(p, b.params[n]) for n, p in a.params.items())


def _obs_on(engine, flight_dir, interval=1):
    """Telemetry (the bench's flop model), health at ``interval``, the flight
    recorder, the metrics registry and the tracer, all on."""
    from paddle_tpu_torch.observability import (flight_recorder, metrics, tracer,
                                                transformer_flops_per_token)

    cfg = engine.model.config
    tele = engine.enable_telemetry(flops_per_token=transformer_flops_per_token(
        engine._n_params(), cfg.num_layers, cfg.hidden_size, cfg.max_seq_len))
    health = engine.enable_health(interval=interval)
    flight_recorder.enable(flight_dir)
    metrics.enable()
    tracer.get_tracer().enable()
    return tele, health


def _obs_off(engine):
    from paddle_tpu_torch.observability import flight_recorder, health, metrics, tracer

    engine.disable_telemetry()
    engine.disable_health()
    flight_recorder.disable()
    metrics.disable()
    tracer.get_tracer().disable()
    tracer.get_tracer().clear()
    health.reset()


def phase_train_obs(ids):
    """The train step's observability and its last entry points on the
    training main path (GPT-2 124M, [8, 1024], AdamW, bf16 O1; module
    docstring, item 6b). Returns the flash launches {kernel: n}."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.bench import card_name_and_power_limit
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.observability import (flight_recorder, metrics,
                                                peak_flops_per_sec,
                                                transformer_flops_per_token)

    card = card_name_and_power_limit()
    t_phase = time.perf_counter()
    cfg = GPTConfig()
    labels = torch.roll(ids, -1, 1)
    gc.collect()
    torch.cuda.empty_cache()
    _reset_launch_counts()
    n_steps = 0
    with tempfile.TemporaryDirectory() as d, auto_cast(dtype="bfloat16"):
        # 1. the same 3 steps from one saved state, everything off, then on
        _, a = _train_engine(cfg, "cuda")
        _, b = _train_engine(cfg, "cuda", seed=1)
        state = _clone_state(a)
        _load_state(b, state)
        off_losses, _ = _steps(a, ids, labels, 3)
        tele, health = _obs_on(b, os.path.join(d, "flight"))
        on_losses, _ = _steps(b, ids, labels, 3)
        n_steps += 6
        if off_losses != on_losses or not _same_params(a, b):
            raise AssertionError(f"train_obs: observability changed the step: losses "
                                 f"{off_losses} (off) against {on_losses} (on)")
        # 2. one more step's health record against its gradients, recomputed
        prev = {n: p.detach().clone() for n, p in b.params.items()}
        _steps(b, ids, labels, 1)
        n_steps += 1
        rec = health.recent()[-1]
        worst = 0.0
        for n, p in b.params.items():
            g = p.grad.double()
            want = {"grad_norm": g.norm().item(),
                    "weight_norm": prev[n].double().norm().item()}
            want["update_ratio"] = ((p.detach().double() - prev[n].double()).norm().item()
                                    / want["weight_norm"]) if want["weight_norm"] else 0.0
            for key, w in want.items():
                got = rec["per_param"][n][key]
                err = abs(got - w) / max(abs(w), 1e-30)
                worst = max(worst, err)
                if err > OBS_HEALTH_RTOL:
                    raise AssertionError(f"train_obs: health {key} of {n} {got} against "
                                         f"{w} recomputed")
        g_all = math.sqrt(sum(p.grad.double().pow(2).sum().item()
                              for p in b.params.values()))
        if abs(rec["grad_norm"] - g_all) > OBS_HEALTH_RTOL * g_all or rec["nonfinite_count"]:
            raise AssertionError(f"train_obs: health grad_norm {rec['grad_norm']} against "
                                 f"{g_all}, nonfinite {rec['nonfinite_count']}")
        del prev
        # 4. the telemetry records
        peak = peak_flops_per_sec("h100")
        fpt = transformer_flops_per_token(b._n_params(), cfg.num_layers, cfg.hidden_size,
                                          cfg.max_seq_len)
        for r in tele.sink.records:
            want_mfu = r["tokens_per_sec"] * fpt / peak
            mem = r["device_memory"]
            if (r["tokens"] != ids.numel() or abs(r["mfu"] - want_mfu) > 1e-4
                    or not 0 < mem["peak_bytes_in_use"] <= mem["bytes_limit"]):
                raise AssertionError(f"train_obs: telemetry record {r}")
        tele_mfu = statistics.median(r["mfu"] for r in tele.sink.records)
        # 3. a non-finite gradient named by the health record and dumped
        poison = b.params[OBS_POISON].register_hook(lambda g: g * float("inf"))
        _steps(b, ids, labels, 1)
        n_steps += 1
        poison.remove()
        bad = health.recent()[-1]
        fr = flight_recorder.get()
        dumps = [os.path.basename(p) for p in fr.dumps]
        if (bad["first_nonfinite_param"] != OBS_POISON
                or {n for n, pp in bad["per_param"].items() if pp["nonfinite"]} != {OBS_POISON}
                or not any("health_nonfinite" in x for x in dumps)):
            raise AssertionError(f"train_obs: the poisoned {OBS_POISON}: record names "
                                 f"{bad['first_nonfinite_param']}, dumps {dumps}")
        reg = metrics.active_registry()
        step_ms_count = reg.histogram("train.step_ms").snapshot()["count"]
        _obs_off(b)
        del a, b

        # 5. run_steps against step(), a checkpoint interval inside its window
        _, a = _train_engine(cfg, "cuda")
        _, b = _train_engine(cfg, "cuda", seed=1)
        state = _clone_state(a)
        _load_state(b, state)
        loop, _ = _steps(a, ids, labels, 4)
        metrics.enable()
        mgr = b.enable_checkpointing(os.path.join(d, "ckpt"), interval=3, keep=2,
                                     async_save=True)
        fused = b.run_steps(ids, labels, steps=4).tolist()
        mgr.wait()
        saved = [s for s, _ in mgr.checkpoints()]
        save_count = metrics.active_registry().histogram("ckpt.save_ms").snapshot()["count"]
        metrics.disable()
        b.disable_checkpointing()
        n_steps += 8
        if fused != loop or not _same_params(a, b) or saved != [4]:
            raise AssertionError(f"train_obs: run_steps {fused} against 4 steps {loop}; "
                                 f"checkpoints {saved}, expected [4]")
        if not step_ms_count or not save_count:
            raise AssertionError(f"train_obs: histogram counts train.step_ms "
                                 f"{step_ms_count}, ckpt.save_ms {save_count}")
        # 6. prefetch against step() on 4 distinct batches from the host
        gen = torch.Generator().manual_seed(7)
        host = [torch.randint(0, cfg.vocab_size, tuple(ids.shape), generator=gen)
                for _ in range(4)]
        batches = [(x, torch.roll(x, -1, 1)) for x in host]
        _load_state(a, state)
        _load_state(b, state)
        plain = [a.step(x.cuda(), y.cuda()).item() for x, y in batches]
        ptele = b.enable_telemetry()
        pre = [b.step(*pb).item() for pb in b.prefetch(batches, depth=2)]
        n_steps += 8
        pf = b.prefetcher
        precs = ptele.sink.records
        b.disable_telemetry()
        if (pre != plain or pf.puts != 8 or pf.batches != 4
                or [r.get("prefetch_depth") for r in precs] != [2, 2, 2, 1]
                or not all("h2d_ms" in r for r in precs)):
            raise AssertionError(f"train_obs: prefetch {pre} against step() {plain}; "
                                 f"puts {pf.puts}, depths "
                                 f"{[r.get('prefetch_depth') for r in precs]}")
        h2d_ms = [r["h2d_ms"] for r in precs]
        del state

        # 9. step time of each setting in one call, in turns, after a
        # warm-up step of each (the stats' buffers allocated once)
        settings = ("off", "telemetry", "health_1", "health_10")
        times = {s: [] for s in settings}
        b.enable_telemetry()
        b.enable_health(interval=1)
        _steps(b, ids, labels, 2)
        b.disable_telemetry()
        b.disable_health()
        n_steps += 2
        for s in settings + settings[::-1]:
            if s == "telemetry":
                b.enable_telemetry()
            elif s != "off":
                b.enable_health(interval=int(s.split("_")[1]))
            _, ms = _steps(b, ids, labels, OBS_TIMED_STEPS)
            n_steps += OBS_TIMED_STEPS
            times[s] += ms
            b.disable_telemetry()
            b.disable_health()
        launches = _launch_counts()
        _check_mma_launches("train_obs", dict(fa.launches_by_route), _bwd_routes(),
                            n_steps * cfg.num_layers, n_steps * cfg.num_layers)
        # where a health step's time goes: one traced step off, one at interval 1
        profiles = {}
        for s in ("off", "health_1"):
            if s != "off":
                b.enable_health(interval=1)
            wall, kernel_ms, top = device_profile(lambda: b.step(ids, labels).item(), top=8)
            profiles[s] = {"wall_ms_traced": wall, "kernel_ms": kernel_ms, "top_kernels": top}
            b.disable_health()
        del a, b
    med = {s: statistics.median(v) for s, v in times.items()}
    mean = {s: statistics.fmean(v) for s, v in times.items()}
    bench_mfu = fpt * ids.numel() / (med["off"] / 1e3) / peak
    emit(phase="train_obs", model="gpt2-124m", batch=list(ids.shape), amp="bfloat16 O1",
         card=card, bit_equal_on_off=True, health_worst_rel_err=worst,
         poisoned=OBS_POISON, run_steps_losses=fused, checkpoints=saved,
         prefetch_losses=pre, prefetch_h2d_ms=h2d_ms, steps=n_steps, launches=launches,
         step_ms={s: v for s, v in times.items()}, step_ms_median=med, step_ms_mean=mean,
         cost_vs_off_median={s: med[s] / med["off"] - 1 for s in settings[1:]},
         cost_vs_off_mean={s: mean[s] / mean["off"] - 1 for s in settings[1:]},
         telemetry_mfu_median=tele_mfu, bench_mfu_of_off_median=bench_mfu,
         flops_per_token=fpt, health_fetches=monitor.stat("health.fetches").get(),
         profiles=profiles, seconds=time.perf_counter() - t_phase)
    for s in settings:
        print(f"train_obs: {s} step ms median {med[s]:.3f} mean {mean[s]:.3f} ({card})",
              flush=True)
    return launches


JAX_SLOTS = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2, "adamax": 2, "adagrad": 1,
             "adadelta": 2, "rmsprop": 3, "lamb": 2, "lars": 1}


def _is_layer_norm(name):
    return ".ln" in name


def _train_rule_cases():
    """train_rules' engine cases: (case, optimizer class name, its kwargs,
    the scheduler's factory (called twice: the optimizer's and its host
    twin), what the case shows). Learning rates by each rule's step size
    on a first step: the Adam-like rules move an entry by ~lr (and centered
    RMSProp by up to ~4.6 lr), Adadelta by ~lr x 4.5e-3 at most, Lamb each
    tensor by ~lr of its norm, Lars by ~lr x lars_coeff of its norm."""
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm, L2Decay
    from paddle_tpu_torch.optimizer import lr

    return [
        ("adamax_onecycle_clip", "Adamax",
         {"grad_clip": ClipGradByGlobalNorm(1.0, group_name="train_rules",
                                            auto_skip_clip=True)},
         lambda: lr.OneCycleLR(max_learning_rate=3e-4, total_steps=4)),
        ("adagrad_piecewise", "Adagrad", {},
         lambda: lr.PiecewiseDecay(boundaries=[2], values=[3e-4, 1e-4])),
        ("adadelta_exponential", "Adadelta", {},
         lambda: lr.ExponentialDecay(learning_rate=0.5, gamma=0.9)),
        ("rmsprop_centered_cosine_restarts", "RMSProp", {"centered": True, "momentum": 0.9},
         lambda: lr.CosineAnnealingWarmRestarts(learning_rate=5e-5, T_0=2)),
        ("lamb_noam", "Lamb", {"exclude_from_weight_decay_fn": _is_layer_norm},
         lambda: lr.NoamDecay(d_model=768, warmup_steps=4, learning_rate=1.0)),
        ("lars_multistep", "Lars", {"exclude_from_weight_decay": ["bias"]},
         lambda: lr.MultiStepDecay(learning_rate=2.0, milestones=[2], gamma=0.5)),
        ("adamw_l2decay_cyclic", "AdamW", {"weight_decay": L2Decay(0.01)},
         lambda: lr.CyclicLR(base_learning_rate=1e-5, max_learning_rate=1e-4,
                             step_size_up=2)),
        ("adam_reduce_on_plateau", "Adam", {},
         lambda: lr.ReduceOnPlateau(learning_rate=1e-4, factor=0.5, patience=1)),
    ]


def _check_slots(what, opt, params):
    """Every parameter's optimizer state: JAX_SLOTS[rule] f32 tensors of its
    shape."""
    want = JAX_SLOTS[opt._rule]
    for n, p in params.items():
        st = opt._states.get(n, ())
        if len(st) != want or any(s.dtype != torch.float32 or s.shape != p.shape
                                  for s in st):
            raise AssertionError(f"{what}: {n}'s optimizer state is "
                                 f"{[(s.dtype, tuple(s.shape)) for s in st]}, expected "
                                 f"{want} f32 slots of {tuple(p.shape)}")
    return want


def _falls(what, losses):
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")


def phase_train_rules(ids, cfg=None):
    """The optimizer surface on the training path at GPT-2 124M (``cfg``),
    ids [8, 1024], labels roll(ids, -1), bf16 auto_cast O1, random weights
    from seed 0 (the same start for every case).

    (a) one TrainStepEngine per case of ``_train_rule_cases``, 1 warm-up and
    3 timed steps, the scheduler stepped after each (ReduceOnPlateau fed the
    step's loss as a 0-d card tensor): 12 tensor-core launches of each flash
    kernel a step, none on another route; finite losses, the last below the
    first; every parameter's state JAX_SLOTS[rule] f32 slots of its shape;
    the learning rate each step read equal to the scheduler's host twin
    stepped beside it (fed the losses as floats); step ms (median of the 3)
    and peak memory.
    (b) the eager path, 3 steps each, the loss's backward and the
    optimizer's step outside any engine: GradScaler (2^15) around
    LookAhead(AdamW(MultiplicativeDecay 1e-4 x 0.95^t), k=2), with unscale_
    on the inner optimizer (no inf may be found, the scale stays);
    ModelAverage over AdamW(LambdaDecay 1e-4 / (1 + t)) stepped by
    ``minimize`` (its apply() then restore() gives every parameter back bit
    for bit); Momentum (InverseTimeDecay 0.05, gamma 0.5) with
    weight_decay=L1Decay(1e-6) after clip_grad_norm_(1.0) (each global norm
    after it at most 1); last, as it leaves the model bf16,
    amp.decorate(level="O2") with AdamW(NaturalExpDecay 1e-4, gamma 0.1)
    under auto_cast O2 (parameters bf16, state f32).
    Each: 12 tensor-core launches of each flash
    kernel a step, finite falling losses.
    Returns the flash launches of every run, {kernel: n}."""
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.amp import GradScaler, auto_cast, decorate
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.incubate import LookAhead, ModelAverage
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.nn import clip_grad_norm_
    from paddle_tpu_torch.optimizer import lr as lrs
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    cfg = cfg or GPTConfig()
    per_step = cfg.num_layers
    labels = torch.roll(ids, -1, 1)
    model = GPTForPretraining(cfg, device=ids.device, seed=0)
    init = {n: t.detach().cpu().clone() for n, t in model.state_dict().items()}
    total = dict.fromkeys(_launch_counts(), 0)

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        model.load_state_dict(init)
        model.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()

    def read_launches(what, steps):
        torch.cuda.synchronize()
        _check_mma_launches(what, dict(fa.launches_by_route), _bwd_routes(),
                            steps * per_step, steps * per_step)
        for k, v in _launch_counts().items():
            total[k] += v

    for case, rule, kw, make_sched in _train_rule_cases():
        fresh()
        sched, twin = make_sched(), make_sched()
        opt = getattr(optim, rule)(learning_rate=sched, parameters=model.named_parameters(),
                                   **kw)
        engine = TrainStepEngine(model, opt)
        plateau = isinstance(sched, lrs.ReduceOnPlateau)
        losses, step_ms, lr_read, lr_twin = [], [], [], []
        with auto_cast(dtype="bfloat16"):
            for _ in range(4):
                lr_read.append(opt.get_lr())
                lr_twin.append(twin())
                t0 = time.perf_counter()
                loss = engine.step(ids, labels)
                losses.append(loss.item())
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if plateau:
                    sched.step(loss)
                    twin.step(losses[-1])
                else:
                    sched.step()
                    twin.step()
        read_launches(f"train_rules {case}", 4)
        peak = torch.cuda.max_memory_allocated()
        _falls(f"train_rules {case}", losses)
        slots = _check_slots(f"train_rules {case}", opt, engine.params)
        if lr_read != lr_twin or sched.state_dict() != twin.state_dict():
            raise AssertionError(f"train_rules {case}: the step read learning rates "
                                 f"{lr_read}, its scheduler's host twin {lr_twin}")
        emit(phase="train_rules", case=case, model="gpt2-124m", batch=list(ids.shape),
             amp="bfloat16 O1", optimizer=rule, scheduler=type(sched).__name__,
             clip=type(opt._grad_clip).__name__ if opt._grad_clip else None,
             weight_decay=opt._weight_decay, warmup_steps=1, timed_steps=3,
             losses=losses, learning_rates=lr_read, step_ms=step_ms[1:],
             step_ms_median=statistics.median(step_ms[1:]), state_slots=slots,
             max_memory_allocated_bytes=peak,
             launches_per_step={k: per_step for k in total})
        del engine, opt

    def eager(case, opt, step, steps=3, level="O1"):
        losses, step_ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            with auto_cast(dtype="bfloat16", level=level):
                loss = model(ids, labels)
            step(loss)
            losses.append(loss.item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            opt._learning_rate.step()
        read_launches(f"train_rules {case}", steps)
        _falls(f"train_rules {case}", losses)
        return {"losses": losses, "step_ms": step_ms,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}

    # GradScaler around LookAhead: the scaler reads _parameter_list, so it
    # unscales the inner optimizer, then steps the LookAhead
    fresh()
    inner = optim.AdamW(lrs.MultiplicativeDecay(1e-4, lr_lambda=lambda t: 0.95),
                        parameters=model.named_parameters())
    look, scaler = LookAhead(inner, alpha=0.5, k=2), GradScaler(init_loss_scaling=2.0 ** 15)
    found = []

    def scaled_step(loss):
        scaler.scale(loss).backward()
        scaler.unscale_(inner)
        found.append(scaler._found_inf)
        scaler.step(look)
        scaler.update()
        look.clear_grad()

    res = eager("grad_scaler_lookahead", inner, scaled_step)
    if any(found) or scaler._scale != 2.0 ** 15 or look._steps != 3:
        raise AssertionError(f"train_rules grad_scaler_lookahead: found_inf {found}, scale "
                             f"{scaler._scale}, lookahead steps {look._steps}")
    _check_slots("train_rules grad_scaler_lookahead", inner, dict(model.named_parameters()))
    emit(phase="train_rules", case="grad_scaler_lookahead", optimizer="LookAhead(AdamW, "
         "alpha=0.5, k=2)", scheduler="MultiplicativeDecay", loss_scaling=scaler._scale,
         **res)
    del look, inner, scaler

    fresh()
    opt = optim.AdamW(lrs.LambdaDecay(1e-4, lr_lambda=lambda t: 1.0 / (1 + t)),
                      parameters=model.named_parameters())
    avg = ModelAverage(parameters=model.named_parameters())

    def averaged_step(loss):
        opt.minimize(loss)
        opt.clear_gradients()
        avg.step()

    res = eager("model_average", opt, averaged_step)
    with torch.no_grad():
        before = [p.detach().clone() for p in model.parameters()]
        avg.apply(need_restore=False)
        moved = sum(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
        avg.restore()
        back = all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    if not back or moved == 0:
        raise AssertionError(f"train_rules model_average: apply() moved {moved} "
                             f"parameters, restore() gave them back: {back}")
    emit(phase="train_rules", case="model_average", optimizer="AdamW + ModelAverage",
         scheduler="LambdaDecay", params_moved_by_apply=moved, restored_bit_for_bit=back,
         **res)
    del opt, avg, before

    fresh()
    opt = optim.Momentum(lrs.InverseTimeDecay(0.05, gamma=0.5), momentum=0.9,
                         parameters=model.named_parameters(),
                         weight_decay=optim.L1Decay(1e-6))
    norms = []

    def clipped_step(loss):
        loss.backward()
        norms.append(clip_grad_norm_(model.parameters(), max_norm=1.0).item())
        opt.step()
        opt.clear_grad()

    res = eager("momentum_l1_clip_grad_norm", opt, clipped_step)
    if not all(n <= 1.0 + 1e-4 for n in norms):
        raise AssertionError(f"train_rules momentum_l1_clip_grad_norm: norms {norms}")
    emit(phase="train_rules", case="momentum_l1_clip_grad_norm", optimizer="Momentum",
         scheduler="InverseTimeDecay", weight_decay="L1Decay(1e-6)",
         global_norms_after_clip=norms, **res)
    del opt

    fresh()
    opt = optim.AdamW(lrs.NaturalExpDecay(1e-4, gamma=0.1),
                      parameters=model.named_parameters())
    decorate(model, opt, level="O2")

    def o2_step(loss):
        loss.backward()
        opt.step()
        opt.clear_grad()

    res = eager("decorate_o2", opt, o2_step, level="O2")
    dtypes = {str(p.dtype) for p in model.parameters()}
    if dtypes != {"torch.bfloat16"}:
        raise AssertionError(f"train_rules decorate_o2: parameters {dtypes}")
    _check_slots("train_rules decorate_o2", opt, dict(model.named_parameters()))
    emit(phase="train_rules", case="decorate_o2", optimizer="AdamW", amp="bfloat16 O2",
         scheduler="NaturalExpDecay", param_dtypes=sorted(dtypes), **res)
    del opt, model
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="train_rules", case="all", launches=total,
         wall_s=time.perf_counter() - t_phase)
    return total


RULE_STEP_TOL = 1e-6    # card vs CPU, one rule's update of the same f32 weights and
                        # gradient: times max(1, max|p|) (the same elementwise f32
                        # arithmetic; Lamb's and Lars's norms sum in another order)
RULE_FLIP_LRS = 10      # card vs the CPU's whole step, each parameter: times lr (a
                        # gradient within rounding of 0 may take the other sign, and
                        # no first step moves an entry by more than ~4.6 lr)


def _rules_vs_cpu(cfg, ids, labels, l_cpu, g_cpu):
    """train_vs_cpu for each new rule: one f32 engine step on the card (the
    3xTF32 forward and backward pair) from the CPU run's weights (seed 1),
    held to the CPU: the loss (TRAIN_LOSS_RTOL) and every gradient
    (TRAIN_GRAD_TOL x max|g|) against the CPU step's; the new parameters
    and state against the rule run on the CPU on the card's gradient
    (RULE_STEP_TOL x max(1, max|p|)); the new parameters against the CPU's
    whole step, the rule on the CPU's gradient (RULE_FLIP_LRS x lr)."""
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.models import GPTForPretraining
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    cases = [("Adamax", {"learning_rate": 1e-3}), ("Adagrad", {"learning_rate": 1e-3}),
             ("Adadelta", {"learning_rate": 0.5}),
             ("RMSProp", {"learning_rate": 1e-4, "centered": True, "momentum": 0.9}),
             ("Lamb", {"learning_rate": 1e-2, "exclude_from_weight_decay_fn": _is_layer_norm}),
             ("Lars", {"learning_rate": 2.0, "exclude_from_weight_decay": ["bias"]})]
    t_phase = time.perf_counter()
    p0 = {n: p.detach().clone()
          for n, p in GPTForPretraining(cfg, device="cpu", seed=1).named_parameters()}
    model = GPTForPretraining(cfg, device="cuda", seed=1)
    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    n = cfg.num_layers
    f32_routes = ({"mma": 0, "tf32x3": n, "fma": 0},
                  {"mma": {"dkdv": 0, "dq": 0}, "tf32x3": {"dkdv": n, "dq": n},
                   "fma": {"dkdv": 0, "dq": 0}})

    def cpu_rule(rule, kw, grads):
        params = {nm: t.clone() for nm, t in p0.items()}
        opt = getattr(optim, rule)(parameters=list(params.items()), **kw)
        opt._apply(params, grads, opt.get_lr(), 1)
        return params, opt._states

    for rule, kw in cases:
        model.load_state_dict(init)
        model.zero_grad(set_to_none=True)
        opt = getattr(optim, rule)(parameters=model.named_parameters(), **kw)
        _reset_launch_counts()
        loss = TrainStepEngine(model, opt).step(ids, labels).item()
        torch.cuda.synchronize()
        routes = (dict(fa.launches_by_route), _bwd_routes())
        if routes != f32_routes:
            raise AssertionError(f"train_vs_cpu {rule}: the flash kernels took {routes}")
        grads = {nm: p.grad.cpu() for nm, p in model.named_parameters()}
        card = {nm: p.detach().cpu() for nm, p in model.named_parameters()}
        states = {nm: [s.cpu() for s in st] for nm, st in opt._states.items()}
        ref, ref_states = cpu_rule(rule, kw, grads)
        run, _ = cpu_rule(rule, kw, g_cpu)
        lr_ = opt.get_lr()
        loss_err = abs(loss - l_cpu) / abs(l_cpu)
        if not loss_err <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"train_vs_cpu {rule}: loss {loss} vs {l_cpu}")
        worst = {"grad": 0.0, "rule": 0.0, "state": 0.0, "step_over_lr": 0.0}
        apart = total = 0
        for nm, g in g_cpu.items():
            scale = g.abs().max().item()
            err = (grads[nm] - g).abs().max().item()
            worst["grad"] = max(worst["grad"], err / scale if scale else err)
            if not err <= TRAIN_GRAD_TOL * scale:
                raise AssertionError(f"train_vs_cpu {rule}: gradient of {nm}: {err} "
                                     f"(max|g| {scale})")
            bar = max(1.0, ref[nm].abs().max().item())
            err = (card[nm] - ref[nm]).abs().max().item()
            worst["rule"] = max(worst["rule"], err / bar)
            if not err <= RULE_STEP_TOL * bar:
                raise AssertionError(f"train_vs_cpu {rule}: the card's update of {nm} is "
                                     f"{err} from the CPU rule's on the same gradient")
            for a, b in zip(states[nm], ref_states[nm], strict=True):
                err = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
                worst["state"] = max(worst["state"], err)
                if a.dtype != torch.float32 or not err <= RULE_STEP_TOL:
                    raise AssertionError(f"train_vs_cpu {rule}: state of {nm}: {err}")
            diff = (card[nm] - run[nm]).abs()
            worst["step_over_lr"] = max(worst["step_over_lr"], diff.max().item() / lr_)
            if not diff.max().item() <= RULE_FLIP_LRS * lr_:
                raise AssertionError(f"train_vs_cpu {rule}: {nm} is {diff.max().item()} "
                                     f"from the CPU's whole step (lr {lr_})")
            apart += int((diff > 1e-5).sum())
            total += diff.numel()
        if len(states) != len(g_cpu) or any(len(st) != JAX_SLOTS[opt._rule]
                                            for st in states.values()):
            raise AssertionError(f"train_vs_cpu {rule}: the state is not JAX's slots")
        emit(phase="train_vs_cpu_rules", rule=rule, lr=lr_, dtype="float32",
             model="gpt2-124m width, 2 layers", batch=list(ids.shape), loss_card=loss,
             loss_cpu=l_cpu, loss_rel_err=loss_err, grad_worst_rel_err=worst["grad"],
             update_worst_err=worst["rule"], state_worst_err=worst["state"],
             rule_step_tol=RULE_STEP_TOL, vs_cpu_step_worst_over_lr=worst["step_over_lr"],
             vs_cpu_step_bound_over_lr=RULE_FLIP_LRS, entries_apart_1e5=apart,
             entries=total, state_slots=JAX_SLOTS[opt._rule])
        del opt
    del model
    emit(phase="train_vs_cpu_rules", rule="all", rules=len(cases),
         wall_s=time.perf_counter() - t_phase)


DP_STEPS = 3            # steps of each dp run
DP_TIMEOUT_S = 300      # the dp phase's ranks, all runs (~30 s on one card)
DP_LOWP_RTOL = 2e-2     # bf16 / int8 payload losses vs the f32 trajectory: the JAX
                        # package's bar (tests/test_grad_comm.py)
DP_ZERO_RTOL = 1e-5     # ZeRO vs replicated losses past 2 ranks: NCCL may sum the
                        # all_reduce (ring, tree or NVLS) in another order than the
                        # reduce_scatter, so the f32 means differ in the last bits
                        # (~1e-7 relative), and each step's update of ~lr moves the
                        # loss by far less than 1e-5 of it
DP_ZERO_MEM_SHARE = 0.8  # ZeRO's peak below replicated's by this share of the
                         # AdamW state it shards, (1 - 1/N) x 8 x n bytes
DP_FSDP_MEM_SHARE = 0.8  # FSDP's allocated bytes after the steps below ZeRO's by this
                         # share of the f32 parameters it shards, (1 - 1/N) x 4 x n bytes
DP_GRAD_CHUNK = 1024     # FLAGS_grad_comm_chunk of the dp runs
CKPT_ALLOC_SLACK = 8 << 20  # the caching allocator's rounding of the save's two
                            # allocations (up to 2 MiB each), with room to spare


def _flat_grad(params):
    """The gradients of {name: parameter} as one f32 host vector in sorted
    name order (grad_comm's flat layout)."""
    return torch.cat([params[nm].grad.detach().reshape(-1).float().cpu()
                      for nm in sorted(params)])


def _payload_bounds(g_local, world, buckets=None):
    """Per element, the most a payload's rounding can move the first step's
    reduced mean gradient from the f32 run's, given every rank's own mean
    gradient g_r (this rank's is ``g_local``, [n] f32 on the host): {dtype:
    [n] f32 on the host}, each twice the rounding bound. ``buckets`` (FSDP's,
    grad_comm.fsdp_buckets): the int8 chunks tile each padded bucket instead
    of the flat vector.

    bf16: each g_r rounds to bf16 (8 significant bits: relative error <=
    2^-8) and the backend sums in bf16 (at most N - 1 more roundings of
    partial sums, each <= 2^-8 of sum_r |g_r|), so the mean is off by <=
    2^-8 sum_r |g_r|; the bound is 2^-7 sum_r |g_r|. int8: rank r's element of chunk c is off by
    <= scale_rc / 2 = absmax_rc / 254, the f32 sum adds nothing of that
    order, so the mean is off by <= sum_r absmax_rc / (254 N); the bound is
    sum_r absmax_rc / (127 N). A dropped rank's share or a scale off by a
    factor leaves the bound on most elements."""
    from paddle_tpu_torch.distributed import collective

    n = g_local.numel()
    a = g_local.abs()
    if buckets is not None:
        # flat index -> its place on the padded buckets' chunk grid
        place = torch.arange(n)
        pad_off = 0
        for b in buckets:
            place[b["off"]:b["off"] + b["n"]] += pad_off - b["off"]
            pad_off += b["pad"]
        padded = torch.zeros(pad_off)
        padded[place] = a
    else:   # the flat vector's own grid: no index vectors of n entries
        padded = torch.zeros(-(-n // DP_GRAD_CHUNK) * DP_GRAD_CHUNK)
        padded[:n] = a
    absmax = padded.view(-1, DP_GRAD_CHUNK).amax(1)
    sums = []
    for t in (a, absmax):
        t = t.cuda()
        collective.all_reduce(t)
        sums.append(t.cpu())
        del t
    scale = sums[1] / (127.0 * world)
    return {"bf16": sums[0] * 2.0 ** -7,
            "int8": (scale[place // DP_GRAD_CHUNK] if buckets is not None
                     else scale.repeat_interleave(DP_GRAD_CHUNK)[:n])}


def dp_worker(out_dir):
    """One rank of the dp phase (started by the port's spawn): bench.py's step
    at GPT-2 124M through fleet.init -> fleet.distributed_engine on the
    global ids [8, 1024], each run of phase_dp's list; writes its results
    to ``out_dir/rank<r>.json``."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import grad_comm as gcm
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.models.gpt import GPTModel
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    torch.cuda.set_device(int(os.environ["FLAGS_selected_gpus"]))
    cfg = GPTConfig()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 1024)).astype(np.int64)).cuda()
    labels = torch.roll(ids, -1, 1)
    with torch.device("meta"):
        meta = torch.nn.Module()
        meta.gpt = GPTModel(cfg)   # GPTForPretraining's names, tied head
        shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    counters = (gcm.BYTES_MOVED, gcm.RS_BYTES, gcm.AG_BYTES)
    out, kept = {"world": world, "rank": rank}, {}
    first = {}  # the first step's reduced mean gradient of a run (host f32)
    zero_scatter, fsdp_scatter = gcm.zero_scatter, gcm.fsdp_scatter

    def zero_scatter_spy(*a, **kw):  # ZeRO's reduced slice, before clip and update
        g, part = zero_scatter(*a, **kw)
        if first.get("armed"):
            first["zero_shard"], first["armed"] = g.cpu(), False
        return g, part

    def fsdp_scatter_spy(payload, rows, *a, **kw):  # FSDP's reduced shards, ditto
        g, loss = fsdp_scatter(payload, rows, *a, **kw)
        if first.get("armed"):
            # the rank's shards in bucket order, back at their flat offsets
            segs = [(lo, hi, c) for lo, hi, row, c in rows.segments if row == rank]
            first["fsdp"] = (torch.cat([g[c:c + hi - lo] for lo, hi, c in segs]).cpu(),
                             torch.cat([torch.arange(lo, hi) for lo, hi, _ in segs]))
            first["armed"] = False
        return g, loss

    gcm.zero_scatter, gcm.fsdp_scatter = zero_scatter_spy, fsdp_scatter_spy

    def check_grad(name, dtype):
        """The first step's reduced gradient of a low-precision run against
        the f32 run's, element by element, within _payload_bounds."""
        # idx: the flat offsets compared, a slice where they are contiguous
        # (no gathered copies of the 124M-entry vectors)
        if "zero_shard" in first:
            got = first.pop("zero_shard")
            lo = rank * got.numel()
            hi = max(lo, min(bounds["n"], lo + got.numel()))
            idx = slice(lo, hi)
            got = got[:hi - lo]
        elif "fsdp" in first:
            got, idx = first.pop("fsdp")
            dtype = "int8_fsdp" if dtype == "int8" else dtype
        else:
            got = first.pop("replicated")
            idx = slice(0, bounds["n"])
        # the passes over the 124M entries on the card, the host being the slow side
        dev = ids.device
        at = idx if isinstance(idx, slice) else idx.to(dev)
        bnd = bounds[dtype].to(dev)[at]
        err = (got.to(dev) - kept["f32_grad"].to(dev)[at]).abs()
        ratio = err / bnd
        out[name].update(
            grad_elems=got.numel(), grad_max_abs_err=float(err.max()),
            grad_err_over_bound=float(ratio[bnd > 0].max()) if bool((bnd > 0).any()) else 0.0,
            grad_violations=int((err > bnd).sum()))

    def run(name, engine_of, dtype="f32", ef=False, prefetch=2):
        set_flags({"grad_comm_dtype": dtype, "grad_comm_error_feedback": ef,
                   "grad_comm_chunk": DP_GRAD_CHUNK, "zero_update": False,
                   "fsdp": False, "fsdp_prefetch": prefetch})
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = GPTForPretraining(cfg, seed=0)
        opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                    weight_decay=0.01)
        engine = engine_of(model, opt)
        c0 = [c.get() for c in counters]
        _reset_launch_counts()
        losses, step_ms = [], []
        first["armed"] = dtype != "f32"
        with auto_cast(dtype="bfloat16"):
            for i in range(DP_STEPS):
                t0 = time.perf_counter()
                losses.append(engine.step(ids, labels).item())
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if (i == 0 and name != "plain" and getattr(engine, "_zero_opt", None) is None
                        and getattr(engine, "_fsdp_params", None) is None):
                    first["replicated"] = _flat_grad(engine.params)
        first["armed"] = False
        launches = {"counts": _launch_counts(), "fwd": dict(fa.launches_by_route),
                    "bwd": _bwd_routes()}
        fsdp_on = getattr(engine, "_fsdp_params", None) is not None
        out[name] = {
            "losses": losses, "step_ms": step_ms,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "allocated_after_bytes": torch.cuda.memory_allocated(),
            "bytes_per_step": [(c.get() - v) // DP_STEPS for c, v in zip(counters, c0)],
            "launches": launches, "dtype": dtype,
            "zero": getattr(engine, "_zero_opt", None) is not None,
            "fsdp": fsdp_on, "n": sum(math.prod(s) for s in shapes.values())}
        if name in ("plain", "f32", "zero") or name.startswith("fsdp"):
            # on the host: no run's peak counts another's (FSDP's gathered: a
            # collective, every rank)
            kept[name] = {n: p.cpu() for n, p in engine._full_params().items()}
        if name == "f32":
            kept["f32_grad"] = first.pop("replicated")
        elif dtype != "f32":
            check_grad(name, dtype)
        first.clear()
        del model, opt, engine

    if world == 1:  # the single-GPU engine, before any process group exists
        from paddle_tpu_torch.distributed import TrainStepEngine
        run("plain", TrainStepEngine)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": world, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    # this rank's own mean gradient at the first step's weights, on its rows
    # (the gradient each run's first step hands to its reduce)
    model = GPTForPretraining(cfg, seed=0)
    with auto_cast(dtype="bfloat16"):
        model(ids.chunk(world)[rank], labels.chunk(world)[rank]).backward()
    g_local = _flat_grad(dict(model.named_parameters()))
    del model
    bounds = _payload_bounds(g_local, world)
    bounds["n"] = g_local.numel()
    # FSDP's int8 chunks tile the padded buckets, not the flat vector
    bounds["int8_fsdp"] = _payload_bounds(g_local, world, gcm.fsdp_buckets(
        shapes, world, DP_GRAD_CHUNK, layer_key=GPTForPretraining.fsdp_layer_key))["int8"]

    def zero_engine(m, o):
        return fleet.distributed_engine(m, o, zero_update=True)

    def fsdp_engine(m, o):
        return fleet.distributed_engine(m, o, fsdp=True)

    run("f32", fleet.distributed_engine)
    if world == 1 and not torch.equal(kept["f32_grad"], g_local):
        raise AssertionError("dp world 1: the f32 run's first reduced gradient is not "
                             "the rank's own gradient bit for bit")
    del g_local
    run("zero", zero_engine)
    for dtype in ("bf16", "int8"):
        for ef in (False, True):
            run(f"{dtype}{'_ef' if ef else ''}", fleet.distributed_engine, dtype, ef)
    run("zero_bf16", zero_engine, "bf16")
    run("zero_int8_ef", zero_engine, "int8", True)
    for prefetch in (0, 2):
        for dtype, ef in (("f32", False), ("bf16", True), ("int8", True)):
            name = "fsdp" + ("" if dtype == "f32" else f"_{dtype}_ef") + f"_pf{prefetch}"
            run(name, fsdp_engine, dtype, ef, prefetch)
    gcm.zero_scatter, gcm.fsdp_scatter = zero_scatter, fsdp_scatter
    for a, b in (("plain", "f32"), ("zero", "f32"), ("fsdp_pf0", "f32"), ("fsdp_pf2", "f32"),
                 ("fsdp_pf2", "fsdp_pf0"), ("fsdp_bf16_ef_pf2", "fsdp_bf16_ef_pf0"),
                 ("fsdp_int8_ef_pf2", "fsdp_int8_ef_pf0")):
        if a in kept:
            out[f"{a}_vs_{b}_params_equal"] = all(
                torch.equal(kept[a][n], kept[b][n]) for n in kept[b])
            out[f"{a}_vs_{b}_max_abs_param_diff"] = max(
                (kept[a][n] - kept[b][n]).abs().max().item() for n in kept[b])
    # the f32 payload's all_reduce alone, 2 + 5 calls (CUDA events): its bus
    # bandwidth, 2 (N - 1) / N x bytes / time, says which links carry it
    from paddle_tpu_torch.distributed import collective

    payload = torch.ones(out["f32"]["n"] + 1, device=ids.device)
    for _ in range(2):
        collective.all_reduce(payload)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        collective.all_reduce(payload)
    end.record()
    torch.cuda.synchronize()
    ar_ms = start.elapsed_time(end) / 5
    out["all_reduce_f32_payload_ms"] = ar_ms
    out["all_reduce_busbw_gb_s"] = 2 * (world - 1) / world * payload.numel() * 4 / ar_ms / 1e6
    del payload
    out["payload_bytes"] = {d: gcm.payload_bytes(out["f32"]["n"], d, DP_GRAD_CHUNK)
                            for d in ("f32", "bf16", "int8")}
    out["zero_payload_bytes"] = {d: list(gcm.zero_payload_bytes(out["f32"]["n"], world, d,
                                                                DP_GRAD_CHUNK))
                                 for d in ("f32", "bf16", "int8")}
    shards = [b["shard"] for b in gcm.fsdp_buckets(
        shapes, world, DP_GRAD_CHUNK, layer_key=GPTForPretraining.fsdp_layer_key)]
    out["fsdp_payload_bytes"] = {d: list(gcm.fsdp_payload_bytes(shards, world, d,
                                                                DP_GRAD_CHUNK)[:2])
                                 for d in ("f32", "bf16", "int8")}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def ranks_worker(jobs):
    """One rank of several phases, in one process (one start-up for all):
    ``jobs`` [(worker name, out_dir)] run in turn, the flags a worker sets
    put back after it."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.core.flags import get_flags

    for name, out_dir in jobs:
        before = get_flags(["grad_comm_dtype", "grad_comm_error_feedback", "grad_comm_chunk",
                            "zero_update", "fsdp", "fsdp_prefetch"])
        globals()[name](out_dir)
        set_flags(before)


def phase_dp(world=None):
    """Data parallelism on the port, at ``world`` ranks (default: one per
    card), in processes started by the port's ``spawn`` that then run the
    dp_eager phase (ranks_worker; deadline DP_TIMEOUT_S +
    DP_EAGER_TIMEOUT_S). Each rank runs GPT-2 124M at full width on the
    global ids [8, 1024] (its 8/N rows), AdamW(1e-4, weight decay 0.01),
    bf16 auto_cast, DP_STEPS steps a run, through fleet.init ->
    fleet.distributed_engine: the replicated f32 reduce, ZeRO, the bf16
    and int8 payloads with and without error feedback, ZeRO at bf16 and
    at int8 with error feedback (the all_to_all reduce), and FSDP at
    prefetch depths 0 and 2, f32 and bf16 and int8 with error feedback
    (and, at world 1, the single-GPU engine first). Checks on every rank:
    at world 1 the f32 run is the single-GPU engine's bit for bit (losses
    and every parameter); ZeRO and f32 FSDP are the replicated run's bit for
    bit up to 2 ranks and within DP_ZERO_RTOL past them; each FSDP payload
    gives the same bits at both depths; the low-precision losses are finite, fall, and
    stay within DP_LOWP_RTOL of the f32 trajectory, and their first step's
    reduced mean gradient (ZeRO: the rank's slice of it) is the f32 run's
    within the payload's rounding, element by element (_payload_bounds:
    twice the bound for bf16 and for int8's chunk scales, from every rank's
    own gradient); every run launches 12
    tensor-core launches of each flash kernel a step; the byte counters
    equal payload_bytes / zero_payload_bytes / fsdp_payload_bytes for the
    model's n; past one rank ZeRO's peak memory is below the replicated
    run's by at least DP_ZERO_MEM_SHARE x (1 - 1/N) x 8 x n bytes, and
    FSDP's allocated bytes after the steps below ZeRO's by at least
    DP_FSDP_MEM_SHARE x (1 - 1/N) x 4 x n. Emits one line with step
    ms, tokens/s per chip, peaks, payload bytes and the f32 payload's
    all_reduce alone (ms, bus bandwidth) before the checks, and one
    (dp_checks) after them; then _dp_eager_checks. Returns rank 0's flash
    launches over the runs {kernel: n}, and _dp_eager_checks's."""
    import tempfile

    from paddle_tpu_torch.distributed import spawn

    world = world or torch.cuda.device_count()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        dirs = [os.path.join(d, k) for k in ("dp", "dp_eager")]
        for k in dirs:
            os.mkdir(k)
        spawn(ranks_worker, args=(list(zip(("dp_worker", "dp_eager_worker"), dirs)),),
              nprocs=world, timeout=DP_TIMEOUT_S + DP_EAGER_TIMEOUT_S)
        ranks, eager_ranks = [], []
        for k, into in zip(dirs, (ranks, eager_ranks)):
            for r in range(world):
                with open(os.path.join(k, f"rank{r}.json")) as f:
                    into.append(json.load(f))
    wall = time.perf_counter() - t0
    fsdp_runs = [f"fsdp{x}_pf{d}" for d in (0, 2) for x in ("", "_bf16_ef", "_int8_ef")]
    lowp = ["bf16", "bf16_ef", "int8", "int8_ef", "zero_bf16", "zero_int8_ef"] + [
        name for name in fsdp_runs if "_ef" in name]
    runs = ["f32", "zero"] + [name for name in lowp if not name.startswith("fsdp")] + fsdp_runs
    nl = 12
    r0 = ranks[0]
    ms = {name: statistics.median(r0[name]["step_ms"][1:]) for name in runs}
    emit(phase="dp", model="gpt2-124m", world=world, global_batch=[8, 1024],
         rows_per_rank=8 // world, steps=DP_STEPS, wall_s=wall,
         losses={name: r0[name]["losses"] for name in runs + (["plain"] if world == 1
                                                               else [])},
         step_ms_median=ms,
         tokens_per_s_per_chip={name: 8 * 1024 / world / (v / 1e3)
                                for name, v in ms.items()},
         peak_bytes_per_rank={name: [res[name]["peak_bytes"] for res in ranks]
                              for name in runs},
         allocated_after_bytes_per_rank={name: [res[name]["allocated_after_bytes"]
                                                for res in ranks] for name in runs},
         n_params=r0["f32"]["n"], payload_bytes=r0["payload_bytes"],
         zero_payload_bytes_rs_ag=r0["zero_payload_bytes"],
         fsdp_payload_bytes_rs_ag=r0["fsdp_payload_bytes"],
         first_grad_max_abs_err_vs_f32={name: [res[name]["grad_max_abs_err"] for res in ranks]
                                        for name in lowp},
         first_grad_err_over_bound={name: [res[name]["grad_err_over_bound"] for res in ranks]
                                    for name in lowp},
         all_reduce_f32_payload_ms=[res["all_reduce_f32_payload_ms"] for res in ranks],
         all_reduce_busbw_gb_s=[res["all_reduce_busbw_gb_s"] for res in ranks],
         zero_vs_replicated_max_abs_param_diff=[res["zero_vs_f32_max_abs_param_diff"]
                                                for res in ranks],
         fsdp_vs_replicated_max_abs_param_diff=[res["fsdp_pf0_vs_f32_max_abs_param_diff"]
                                                for res in ranks],
         lowp_rtol=DP_LOWP_RTOL, zero_rtol=DP_ZERO_RTOL)
    launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dkdv": 0,
                "flash_attention_bwd_dq": 0}
    for res in ranks:
        r, n = res["rank"], res["f32"]["n"]
        f32 = res["f32"]["losses"]
        if world == 1 and not (res["plain"]["losses"] == f32
                               and res["plain_vs_f32_params_equal"]):
            raise AssertionError(f"dp world 1: the replicated f32 steps {f32} are not the "
                                 f"single-GPU engine's {res['plain']['losses']} bit for bit")
        for name in runs:
            if res[name]["zero"] != name.startswith("zero"):
                raise AssertionError(f"dp rank {r} {name}: ZeRO engaged: {res[name]['zero']}")
            if res[name]["fsdp"] != name.startswith("fsdp"):
                raise AssertionError(f"dp rank {r} {name}: FSDP engaged: {res[name]['fsdp']}")
        # every prefetch depth gives the same bits
        for name in ("fsdp", "fsdp_bf16_ef", "fsdp_int8_ef"):
            a, b = res[f"{name}_pf2"], res[f"{name}_pf0"]
            if not (a["losses"] == b["losses"]
                    and res[f"{name}_pf2_vs_{name}_pf0_params_equal"]):
                raise AssertionError(f"dp rank {r}: {name} at prefetch 2 {a['losses']} is not "
                                     f"prefetch 0's {b['losses']} bit for bit")
        for name in ("zero", "fsdp_pf0", "fsdp_pf2"):
            got = res[name]["losses"]
            if world <= 2:
                if not (got == f32 and res[f"{name}_vs_f32_params_equal"]):
                    raise AssertionError(f"dp rank {r}: {name} {got} is not the replicated "
                                         f"step {f32} bit for bit")
            elif not np.allclose(got, f32, rtol=DP_ZERO_RTOL, atol=0):
                raise AssertionError(f"dp rank {r}: {name} {got} vs replicated {f32}")
        for name in runs:
            got = res[name]
            ls = got["losses"]
            if not all(math.isfinite(x) for x in ls) or not ls[-1] < ls[0]:
                raise AssertionError(f"dp rank {r} {name}: losses {ls}")
            if name in lowp:
                if not np.allclose(ls, f32, rtol=DP_LOWP_RTOL):
                    raise AssertionError(f"dp rank {r} {name}: {ls} vs f32 {f32}")
                if got["grad_violations"] or got["grad_elems"] <= 0:
                    raise AssertionError(
                        f"dp rank {r} {name}: {got['grad_violations']} of "
                        f"{got['grad_elems']} elements of the first reduced gradient "
                        f"outside the payload's rounding of the f32 run's (worst "
                        f"{got['grad_err_over_bound']} x the bound)")
            _check_mma_launches(f"dp rank {r} {name}", got["launches"]["fwd"],
                                got["launches"]["bwd"], DP_STEPS * nl, DP_STEPS * nl)
            if r == 0:
                for k in launches:
                    launches[k] += got["launches"]["counts"][k]
            dtype = got["dtype"]
            if got["fsdp"]:
                rs_ag = res["fsdp_payload_bytes"][dtype]
            elif got["zero"]:
                rs_ag = res["zero_payload_bytes"][dtype]
            else:
                rs_ag = None
            want = [sum(rs_ag)] + rs_ag if rs_ag else [res["payload_bytes"][dtype], 0, 0]
            if got["bytes_per_step"] != want:
                raise AssertionError(f"dp rank {r} {name}: bytes a step "
                                     f"{got['bytes_per_step']} (moved, rs, ag), "
                                     f"expected {want} for n = {n}")
        if world > 1:
            saved = res["f32"]["peak_bytes"] - res["zero"]["peak_bytes"]
            need = DP_ZERO_MEM_SHARE * (1 - 1 / world) * 8 * n
            if not saved >= need:
                raise AssertionError(f"dp rank {r}: ZeRO saved {saved} bytes of peak "
                                     f"memory, less than {need}")
            for name in ("fsdp_pf0", "fsdp_pf2"):
                held = res["zero"]["allocated_after_bytes"] - res[name]["allocated_after_bytes"]
                need = DP_FSDP_MEM_SHARE * (1 - 1 / world) * 4 * n
                if not held >= need:
                    raise AssertionError(f"dp rank {r} {name}: FSDP holds {held} bytes fewer "
                                         f"than ZeRO after the steps, less than {need}")
    emit(phase="dp_checks", world=world, passed=True, launches_rank0=launches)
    return launches, _dp_eager_checks(eager_ranks, world, wall)


DP_EAGER_STEPS = 3          # timed steps of each dp_eager run, after 1 warm-up
DP_EAGER_TIMEOUT_S = 480    # the dp_eager phase's ranks, all runs
DP_EAGER_TOL = 1e-5         # eager vs the engine (f32): losses rtol, and past one rank
                            # each parameter within this x max(1, max|p|) (the Reducer's
                            # per-bucket all_reduce sums in another order than the
                            # engine's one flat reduce; at world 1 bit for bit)
DP_EAGER_OFFLOAD_SHARE = 0.8  # offload: card bytes after the steps below the run without
                              # offload by this share of AdamW's 8 x n bytes of state
DP_EAGER_DGC_SPARSITY = 0.999
DP_EAGER_BF16_RUNS = ("bf16_amp", "fp16_allreduce", "os_g", "os_g_offload", "engine_bf16")


def _chain(opt):
    """The optimizers of a fleet.distributed_optimizer chain, outermost first."""
    out = [opt]
    while hasattr(out[-1], "_inner_opt") or hasattr(out[-1], "_optim"):
        o = out[-1]
        out.append(o._inner_opt if hasattr(o, "_inner_opt") else o._optim)
    return out


def dp_eager_worker(out_dir):
    """One rank of the dp_eager phase (started by the port's spawn): GPT-2
    124M through the eager entry points, fleet.init -> fleet.distributed_model
    -> fleet.distributed_optimizer -> loss.backward(); opt.step();
    opt.clear_grad(), on this rank's rows of the global ids [8, 1024]; each
    run of _dp_eager_checks's list. Writes its results to
    ``out_dir/rank<r>.json``."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import collective, fleet, group_sharded_parallel
    from paddle_tpu_torch.distributed.fleet import meta_optimizers as meta
    from paddle_tpu_torch.distributed.fleet import utils as futils
    from paddle_tpu_torch.distributed.meta_parallel import Reducer
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    torch.cuda.set_device(int(os.environ["FLAGS_selected_gpus"]))
    cfg = GPTConfig()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 1024)).astype(np.int64)).cuda()
    labels = torch.roll(ids, -1, 1)
    ids_r, labels_r = ids.chunk(world)[rank], labels.chunk(world)[rank]
    half = ids_r.shape[0] // 2
    out, kept = {"world": world, "rank": rank}, {}

    def strategy(**kw):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": world, "mp_degree": 1}
        for k, v in kw.items():
            setattr(s, k, v)
        fleet.init(is_collective=True, strategy=s)
        return s

    def fresh():
        futils._reducer_cache.clear()   # its Reducers hold the last run's parameters
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = GPTForPretraining(cfg, seed=0)
        return model, AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                            weight_decay=0.01)

    def reducer_of(model):
        mine = {id(p) for p in model.parameters()}
        return next((r for slots in futils._reducer_cache.values() for r in slots.values()
                     if r.params and id(r.params[0]) in mine), None)

    def drive(name, model, step, ctx_of=contextlib.nullcontext, extra=None):
        """1 warm-up and DP_EAGER_STEPS timed calls of ``step``; the flash
        launches of the timed calls."""
        losses, step_ms, calls = [], [], []
        for i in range(1 + DP_EAGER_STEPS):
            if i == 1:
                red = reducer_of(model)
                calls.append(red.n_collectives if red is not None else 0)
                _reset_launch_counts()
            t0 = time.perf_counter()
            with ctx_of():
                losses.append(step())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {"counts": _launch_counts(), "fwd": dict(fa.launches_by_route),
                    "bwd": _bwd_routes()}
        red = reducer_of(model)
        calls.append(red.n_collectives if red is not None else 0)
        # the losses' mean over the ranks (the engine's loss), one collective
        mean = torch.tensor(losses, dtype=torch.float64, device=ids.device)
        collective.all_reduce(mean)
        keep = name in ("f32", "engine_f32", "gm", "engine_k2", "os_g", "os_g_offload")
        # the weights on the host where a check reads them (the digest: past one rank)
        params = ({n: p.detach().float().cpu() for n, p in model.named_parameters()}
                  if keep or world > 1 else None)
        out[name] = {
            "losses": losses, "mean_losses": (mean / world).tolist(), "step_ms": step_ms,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "allocated_after_bytes": torch.cuda.memory_allocated(),
            "launches": launches,
            "collectives_per_step": (calls[1] - calls[0]) / DP_EAGER_STEPS,
            "buckets": len((red or Reducer(list(model.parameters())))._buckets),
            "digest": _digest(params) if world > 1 else None,
            "n": sum(p.numel() for p in model.parameters()),
            **(extra or {})}
        if keep:
            kept[name] = params

    def eager(name, flags=None, halves=False, amp=False):
        s = strategy(**(flags or {}))
        model, opt = fresh()
        dp_model = fleet.distributed_model(model)
        opt_d = fleet.distributed_optimizer(opt, s)

        def micro(sl):
            loss = dp_model(ids_r[sl], labels_r[sl])
            loss.backward()
            opt_d.step()
            opt_d.clear_grad()
            return loss.item()

        def step():
            if halves:   # gradient merge: two micro-steps, one update
                return (micro(slice(0, half)) + micro(slice(half, None))) / 2
            return micro(slice(None))

        drive(name, model, step, opt_d.amp_context if amp else contextlib.nullcontext,
              {"wrapper": type(dp_model).__name__, "applied": fleet.fleet._applied_meta_list,
               "chain": [type(o).__name__ for o in _chain(opt_d)]})
        return opt_d

    def engine(name, k=1, amp=False):
        strategy(amp=amp)
        model, opt = fresh()
        eng = fleet.distributed_engine(model, fleet.distributed_optimizer(opt), microbatches=k)
        drive(name, model, lambda: eng.step(ids, labels).item())

    def sharded(name, offload):
        strategy()
        model, opt = fresh()
        model_s, opt_s = group_sharded_parallel(model, opt, "os_g", offload=offload)

        def step():
            with auto_cast(dtype="bfloat16"):
                loss = model_s(ids_r, labels_r)
            loss.backward()
            opt_s.step()
            opt_s.clear_grad()
            return loss.item()

        states = opt._states
        drive(name, model, step)
        out[name]["state_on_pinned_host"] = bool(states) and all(
            t.device.type == "cpu" and t.is_pinned() for st in states.values() for t in st)
        out[name]["state_on_card"] = bool(states) and all(
            t.is_cuda for st in states.values() for t in st)

    eager("f32")
    engine("engine_f32")
    eager("bf16_amp", {"amp": True}, amp=True)
    engine("engine_bf16", amp=True)
    eager("gm", {"gradient_merge": True,
                 "gradient_merge_configs": {"k_steps": 2, "avg": True}}, halves=True)
    engine("engine_k2", k=2)
    opt_d = eager("lamb", {"lamb": True})
    out["lamb"]["inner"] = type(_chain(opt_d)[-1]).__name__
    del opt_d
    opt_d = eager("dgc", {"dgc": True,
                          "dgc_configs": {"sparsity": [DP_EAGER_DGC_SPARSITY]}})
    dgc = next(o for o in _chain(opt_d) if isinstance(o, meta.DGCOptimizer))
    kept_over_k = []
    for p in dgc._inner_opt._parameter_list:
        k = max(1, round(p.numel() * (1 - DP_EAGER_DGC_SPARSITY)))
        kept_over_k.append((p.numel() - int((dgc._residual[id(p)] != 0).sum())) / k)
    out["dgc"].update(min_kept_over_k=min(kept_over_k), n_residuals=len(dgc._residual))
    del opt_d, dgc
    eager("fp16_allreduce", {"fp16_allreduce": True, "amp": True}, amp=True)
    sharded("os_g", False)
    sharded("os_g_offload", True)
    futils._reducer_cache.clear()
    for a, b in (("f32", "engine_f32"), ("gm", "engine_k2"), ("os_g_offload", "os_g")):
        out[f"{a}_vs_{b}_params_equal"] = all(torch.equal(kept[a][n], kept[b][n])
                                              for n in kept[b])
        out[f"{a}_vs_{b}_param_err_over_scale"] = max(
            (kept[a][n] - kept[b][n]).abs().max().item()
            / max(1.0, kept[b][n].abs().max().item()) for n in kept[b])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _digest(params):
    import hashlib

    h = hashlib.sha256()
    for n in sorted(params):
        h.update(params[n].numpy().tobytes())
    return h.hexdigest()


def _dp_eager_checks(ranks, world, wall):
    """The dp_eager phase's checks on ``ranks``, each rank's
    dp_eager_worker results at ``world`` ranks, one a card, in the
    processes phase_dp starts for both phases (``wall``: their seconds):
    the eager data-parallel entry points on the port. Each rank runs GPT-2
    124M at full width on its rows of the global ids [8, 1024],
    AdamW(1e-4, weight decay
    0.01), 1 warm-up and DP_EAGER_STEPS timed steps a run, through fleet.init
    -> fleet.distributed_model -> fleet.distributed_optimizer ->
    loss.backward(); opt.step(); opt.clear_grad(): f32; bf16 through
    strategy.amp (the AMP meta's amp_context); strategy.lamb (AdamW swapped
    for Lamb; f32, where its steps of ~lr x 0.02 move the loss, which they
    do not through bf16 products); strategy.gradient_merge (k_steps 2, avg;
    f32, the rows' two halves a step); strategy.dgc (sparsity 0.999; f32,
    likewise); strategy.fp16_allreduce (bf16); group_sharded_parallel at os_g without
    and with offload (bf16 auto_cast); and the engine's replicated step
    (fleet.distributed_engine) on the global batch, f32, bf16 (strategy.amp)
    and at 2 microbatches, as the yardstick.

    Checks on every rank: f32 eager is the engine's step (losses and every
    parameter; bit for bit at world 1, within DP_EAGER_TOL past it), and
    gradient merge the engine's at 2 microbatches likewise; offload gives
    the run without it bit for bit, its state sits in pinned host memory
    after the steps (the other run's on the card), and the card holds at
    least DP_EAGER_OFFLOAD_SHARE x 8n fewer bytes after the steps; the Lamb
    run's optimizer is a Lamb; DGC kept at least round(numel x 0.001)
    entries of every gradient at the last step; every loss is finite and
    falls; every bf16 run launches each tensor-core flash kernel 12 times a
    step; past one rank the Reducer runs one collective a bucket a step (its
    own bucket count) and every rank holds the same weights. Emits one line
    with step ms, tokens/s per card, peak and after-step bytes, buckets and
    collectives a step, for eager and for the engine, before the checks;
    returns rank 0's flash launches of the timed steps, {"bf16": {kernel:
    n}, "f32": {kernel: n}}."""
    r0 = ranks[0]
    runs = ["f32", "engine_f32", "bf16_amp", "engine_bf16", "gm", "engine_k2", "lamb",
            "dgc", "fp16_allreduce", "os_g", "os_g_offload"]
    ms = {name: statistics.median(r0[name]["step_ms"][1:]) for name in runs}
    tps = {name: 8 * 1024 / world / (v / 1e3) for name, v in ms.items()}
    n = r0["f32"]["n"]
    emit(phase="dp_eager", model="gpt2-124m", world=world, global_batch=[8, 1024],
         rows_per_rank=8 // world, steps=DP_EAGER_STEPS, wall_s=wall,
         step_ms_median=ms, tokens_per_s_per_card=tps,
         eager_over_engine={"f32": tps["f32"] / tps["engine_f32"],
                            "bf16": tps["bf16_amp"] / tps["engine_bf16"],
                            "gradient_merge": tps["gm"] / tps["engine_k2"]},
         losses={name: r0[name]["mean_losses"] for name in runs},
         peak_bytes_per_rank={name: [res[name]["peak_bytes"] for res in ranks]
                              for name in runs},
         allocated_after_bytes_per_rank={name: [res[name]["allocated_after_bytes"]
                                                for res in ranks] for name in runs},
         buckets=r0["f32"]["buckets"],
         collectives_per_step={name: r0[name]["collectives_per_step"] for name in runs},
         offload_bytes_saved_per_rank=[res["os_g"]["allocated_after_bytes"]
                                       - res["os_g_offload"]["allocated_after_bytes"]
                                       for res in ranks],
         n_params=n, chain={name: r0[name].get("chain") for name in runs},
         eager_vs_engine_param_err_over_scale=[res["f32_vs_engine_f32_param_err_over_scale"]
                                               for res in ranks],
         gm_vs_engine_k2_param_err_over_scale=[res["gm_vs_engine_k2_param_err_over_scale"]
                                               for res in ranks],
         dgc_min_kept_over_k=[res["dgc"]["min_kept_over_k"] for res in ranks])
    launches = {"bf16": dict.fromkeys(_launch_counts_keys(), 0),
                "f32": dict.fromkeys(_launch_counts_keys(), 0)}
    for res in ranks:
        r = res["rank"]
        for a, b, what in (("f32", "engine_f32", "f32 eager vs the engine"),
                           ("gm", "engine_k2", "gradient merge vs the engine at 2 "
                                               "microbatches")):
            la, lb = res[a]["mean_losses"], res[b]["mean_losses"]
            if not np.allclose(la, lb, rtol=DP_EAGER_TOL, atol=0):
                raise AssertionError(f"dp_eager rank {r}: {what}: losses {la} vs {lb}")
            if world == 1:
                if not res[f"{a}_vs_{b}_params_equal"]:
                    raise AssertionError(f"dp_eager rank {r}: {what}: parameters not bit "
                                         "for bit")
            elif not res[f"{a}_vs_{b}_param_err_over_scale"] <= DP_EAGER_TOL:
                raise AssertionError(f"dp_eager rank {r}: {what}: {la} vs {lb}, parameter "
                                     f"error {res[f'{a}_vs_{b}_param_err_over_scale']} "
                                     "x max(1, max|p|)")
        if not (res["os_g_offload_vs_os_g_params_equal"]
                and res["os_g_offload"]["losses"] == res["os_g"]["losses"]):
            raise AssertionError(f"dp_eager rank {r}: offload is not the run without it "
                                 "bit for bit")
        if not (res["os_g_offload"]["state_on_pinned_host"] and res["os_g"]["state_on_card"]):
            raise AssertionError(f"dp_eager rank {r}: the offloaded state is not in pinned "
                                 "host memory (or the other run's not on the card)")
        saved = (res["os_g"]["allocated_after_bytes"]
                 - res["os_g_offload"]["allocated_after_bytes"])
        if not saved >= DP_EAGER_OFFLOAD_SHARE * 8 * n:
            raise AssertionError(f"dp_eager rank {r}: offload saved {saved} bytes of the "
                                 f"card, less than {DP_EAGER_OFFLOAD_SHARE} x 8 x {n}")
        if res["lamb"]["inner"] != "Lamb":
            raise AssertionError(f"dp_eager rank {r}: strategy.lamb ran {res['lamb']['inner']}")
        if not res["dgc"]["min_kept_over_k"] >= 1:
            raise AssertionError(f"dp_eager rank {r}: DGC kept fewer than k entries of a "
                                 f"gradient ({res['dgc']['min_kept_over_k']} x k)")
        for name in runs:
            got = res[name]
            ls = got["mean_losses"]
            if not all(math.isfinite(x) for x in ls) or not ls[-1] < ls[0]:
                raise AssertionError(f"dp_eager rank {r} {name}: losses {ls}")
            if name in DP_EAGER_BF16_RUNS:
                _check_mma_launches(f"dp_eager rank {r} {name}", got["launches"]["fwd"],
                                    got["launches"]["bwd"], DP_EAGER_STEPS * 12,
                                    DP_EAGER_STEPS * 12)
            else:   # f32: the 3xTF32 kernels, two forwards a step at 2 microbatches
                nf = DP_EAGER_STEPS * 12 * (2 if name in ("gm", "engine_k2") else 1)
                fwd, bwd = got["launches"]["fwd"], got["launches"]["bwd"]
                if (fwd["tf32x3"], bwd["tf32x3"]["dkdv"], bwd["tf32x3"]["dq"]) != (nf,) * 3:
                    raise AssertionError(f"dp_eager rank {r} {name}: the flash kernels took "
                                         f"{fwd} and {bwd}, expected {nf} 3xTF32 each")
            if r == 0:
                key = "bf16" if name in DP_EAGER_BF16_RUNS else "f32"
                for k in launches[key]:
                    launches[key][k] += got["launches"]["counts"][k]
            if world > 1:
                if name.startswith("engine"):
                    continue
                if got["collectives_per_step"] != got["buckets"]:
                    raise AssertionError(
                        f"dp_eager rank {r} {name}: {got['collectives_per_step']} "
                        f"collectives a step, the Reducer has {got['buckets']} buckets")
                if got["digest"] != r0[name]["digest"]:
                    raise AssertionError(f"dp_eager rank {r} {name}: weights differ from "
                                         "rank 0's")
    emit(phase="dp_eager_checks", world=world, passed=True, launches_rank0=launches)
    return launches


def _launch_counts_keys():
    return ("flash_attention_fwd", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")


def _same_state(a, b):
    """Whether two engines hold the same parameters and optimizer slots, bit
    for bit (gathered under ZeRO and FSDP: every rank calls it)."""
    pa, oa, pb, ob = a._full_params(), a._full_opt(), b._full_params(), b._full_opt()
    return pa.keys() == pb.keys() and all(
        torch.equal(pa[n], pb[n]) and all(torch.equal(x, y) for x, y in zip(oa[n], ob[n]))
        for n in pa)


def _param_digests(engine):
    """{name: sha256 of its f32 bytes} of the engine's full parameters."""
    import hashlib

    return {n: hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()
            for n, t in engine._full_params().items()}


def phase_ckpt(ids):
    """Checkpoints on one card (distributed/elastic.py): bench.py's step at
    GPT-2 124M, bf16 auto_cast, ids [8, 1024]. Engine A takes 4 steps with
    checkpoints every 2 steps, written by the background writer (async);
    engine B, fresh from another seed, restores step 2's checkpoint and
    takes steps 3 and 4: its losses and every parameter and optimizer slot
    must be A's bit for bit. Then one payload byte of the newest checkpoint
    is flipped: fsck reports it, and restore_latest falls back to step 2.
    Emits the capture's ms (on the step's thread), the writer's wall ms and
    the bytes a checkpoint writes; 12 tensor-core launches of each flash
    kernel a step. Returns the flash launches {kernel: n}."""
    import io
    import tempfile
    import warnings

    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import elastic
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.tools import ckpt_fsck

    cfg = GPTConfig()
    labels = torch.roll(ids, -1, 1)
    gc.collect()
    torch.cuda.empty_cache()
    _reset_launch_counts()
    with tempfile.TemporaryDirectory() as d, auto_cast(dtype="bfloat16"):
        _, a = _train_engine(cfg, "cuda")
        mgr = a.enable_checkpointing(d, interval=2, keep=5, async_save=True)
        losses, step_ms = _steps(a, ids, labels, 4)
        t0 = time.perf_counter()
        mgr.wait()
        drain_ms = (time.perf_counter() - t0) * 1e3
        saved = [s for s, _ in mgr.checkpoints()]
        if saved != [2, 4]:
            raise AssertionError(f"ckpt: committed {saved}, expected [2, 4]")
        _, b = _train_engine(cfg, "cuda", seed=1)
        if elastic.restore_checkpoint(b, elastic.checkpoint_path(d, 2)) != 2:
            raise AssertionError("ckpt: restored another step than 2")
        resumed, _ = _steps(b, ids, labels, 2)
        if resumed != losses[2:] or not _same_state(a, b):
            raise AssertionError(f"ckpt: the resumed steps {resumed} (or the state after "
                                 f"them) are not the uninterrupted run's {losses[2:]}")
        launches = _launch_counts()
        _check_mma_launches("ckpt", dict(fa.launches_by_route), _bwd_routes(), 6 * 12, 6 * 12)
        del b
        newest = elastic.checkpoint_path(d, 4)
        payload = sorted(f for f in os.listdir(newest) if f.endswith(".npy"))[0]
        with open(os.path.join(newest, payload), "r+b") as f:
            f.seek(128)
            byte = f.read(1)
            f.seek(128)
            f.write(bytes([byte[0] ^ 0xFF]))
        with contextlib.redirect_stdout(io.StringIO()):
            fsck_rc = ckpt_fsck.main([d])
        _, c = _train_engine(cfg, "cuda", seed=2)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fell_back = elastic.restore_latest(c, d)
        if fsck_rc != 1 or fell_back != 2 or not any("corrupt" in str(w.message)
                                                     for w in caught):
            raise AssertionError(f"ckpt: a flipped byte in step 4's {payload}: fsck "
                                 f"exit {fsck_rc}, restore_latest gave step {fell_back}")
        stats = {"capture_ms": mgr.last_capture_ms, "save_ms": mgr.last_save_ms,
                 "bytes_written": mgr.last_bytes}
        a.disable_checkpointing()
        del a, c
    emit(phase="ckpt", model="gpt2-124m", batch=[8, 1024], amp="bf16", losses=losses,
         resumed_losses=resumed, step_ms=step_ms, drain_ms=drain_ms, committed=saved,
         fsck_exit_after_flip=fsck_rc, fell_back_to=fell_back, passed=True, **stats)
    return launches


def ckpt_rank_worker(out_dir, mode):
    """One rank of phase_ckpt_ranks: GPT-2 124M through fleet, bf16
    auto_cast, FSDP. ``save``: 2 steps, then a blocking save (its capture
    gathers the shards: every rank calls it); the save's peak above the
    bytes held before it must stay within two of the largest bucket (the
    capture gathers one bucket at a time). ``restore``: the newest
    checkpoint restored, then one step. Rank 0 writes its parameters'
    digests (and the save's numbers: the second step's peak, the bytes held
    after it, the save's peak) to ``out_dir/<mode>.json``."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import elastic, fleet
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.set_device(int(os.environ["FLAGS_selected_gpus"]))
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    set_flags({"grad_comm_dtype": "f32", "grad_comm_error_feedback": False,
               "zero_update": False, "fsdp": False, "fsdp_prefetch": 2})
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": world, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    cfg = GPTConfig()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 1024)).astype(np.int64)).cuda()
    labels = torch.roll(ids, -1, 1)
    model = GPTForPretraining(cfg, seed=0 if mode == "save" else 5)
    engine = fleet.distributed_engine(
        model, AdamW(1e-4, parameters=model.named_parameters(), weight_decay=0.01), fsdp=True)
    mgr = elastic.CheckpointManager(os.path.join(out_dir, "ckpt"), async_save=False)
    out = {"world": world}
    with auto_cast(dtype="bfloat16"):
        if mode == "save":
            out["losses"] = [engine.step(ids, labels).item()]
            torch.cuda.reset_peak_memory_stats()
            out["losses"].append(engine.step(ids, labels).item())
            step_peak, held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            mgr.save(engine, block=True)
            torch.cuda.synchronize()
            out.update(save_wall_ms=(time.perf_counter() - t0) * 1e3,
                       capture_ms=mgr.last_capture_ms, bytes_written=mgr.last_bytes,
                       step_peak_bytes=step_peak, held_bytes=held,
                       save_peak_bytes=torch.cuda.max_memory_allocated())
            # the capture holds one gathered bucket (and, on rank 0, one
            # Linear weight's transposed copy) beyond the shards
            bound = 2 * 4 * max(b["pad"] for b in engine._fsdp_layout()[0]) + CKPT_ALLOC_SLACK
            out["save_extra_bound_bytes"] = bound
            if out["save_peak_bytes"] - held > bound:
                raise AssertionError(
                    f"ckpt_ranks rank {fleet.worker_index()}: the save held "
                    f"{out['save_peak_bytes'] - held} bytes beyond the shards, more than "
                    f"{bound} (two of the largest bucket)")
        else:
            out["restored_step"] = mgr.restore(engine)
    out["digests"] = _param_digests(engine)   # a collective under FSDP
    if mode == "restore":
        with auto_cast(dtype="bfloat16"):
            out["next_loss"] = engine.step(ids, labels).item()
        out["fsdp"] = engine._fsdp_params is not None
    mgr.close()
    if fleet.worker_index() == 0:
        with open(os.path.join(out_dir, f"{mode}.json"), "w") as f:
            json.dump(out, f)


def phase_ckpt_ranks(world=4):
    """A checkpoint across rank counts on ``world`` cards: an FSDP engine at
    ``world`` ranks saves at step 2 (ranks of the port's spawn, one a card);
    it is restored at world / 2 ranks under FSDP and in this process on one
    card into the replicated engine; every parameter must be the saved one
    bit for bit (sha256 of each)."""
    import tempfile

    from paddle_tpu_torch.distributed import TrainStepEngine, elastic, spawn
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        res = {}
        for mode, n in (("save", world), ("restore", max(1, world // 2))):
            spawn(ckpt_rank_worker, args=(d, mode), nprocs=n, timeout=DP_TIMEOUT_S)
            with open(os.path.join(d, f"{mode}.json")) as f:
                res[mode] = json.load(f)
        model = GPTForPretraining(GPTConfig(), seed=9)
        engine = TrainStepEngine(model, AdamW(1e-4, parameters=model.named_parameters(),
                                              weight_decay=0.01))
        step1 = elastic.restore_latest(engine, os.path.join(d, "ckpt"))
        one = _param_digests(engine)
        del model, engine
    want = res["save"]["digests"]
    if not (res["restore"]["digests"] == want and one == want and step1 == 2
            and res["restore"]["restored_step"] == 2 and res["restore"]["fsdp"]
            and math.isfinite(res["restore"]["next_loss"])):
        raise AssertionError(f"ckpt_ranks: the world-{world} FSDP checkpoint does not "
                             f"restore bit for bit at world {world // 2} (FSDP) and 1")
    saved = res["save"]
    emit(phase="ckpt_ranks", model="gpt2-124m", save_world=world,
         restore_worlds=[max(1, world // 2), 1], losses=saved["losses"],
         save_wall_ms=saved["save_wall_ms"], capture_ms=saved["capture_ms"],
         bytes_written=saved["bytes_written"], held_bytes_rank0=saved["held_bytes"],
         step_peak_bytes_rank0=saved["step_peak_bytes"],
         save_peak_bytes_rank0=saved["save_peak_bytes"],
         save_extra_bound_bytes=saved["save_extra_bound_bytes"],
         next_loss_at_half_world=res["restore"]["next_loss"], params=len(want), passed=True)


TP_SP_STEPS = 3           # steps of each tp_sp run, at f32 and at bf16
TP_SP_TIMEOUT_S = 600     # the tp_sp phase's ranks, all runs
TP_SP_F32_RTOL = 1e-4     # tp_sp past one card: each f32 loss against the one-card
                          # engine's on the same global batch and weights (f32 sums
                          # in other orders over the mp all-reduces, the sp
                          # blocks and the replica reduce; a wrong shard is off by
                          # O(1e-2) or more)
TP_SP_BF16_RTOL = 2e-2    # ... each bf16 loss against the same run's f32 loss (the
                          # dp phase's bar for a bf16 trajectory against f32)
RING_F32_FROB_TOL = 1e-5  # virtual ring against flash_attention over the whole
                          # sequence, f32: o, dq, dk, dv in each (b, h) head's
                          # relative Frobenius norm (both f32-accurate; the ring
                          # sums its blocks in another order), and F32_TOL /
                          # GRAD_F32_TOL x max(1, max|ref|) on the largest entry
RING_BF16_FROB_TOL = GRAD_BF16_FROB_TOL  # ... bf16: each block's o and gradients
                          # round to bf16 before the f32 merge, where the whole
                          # kernel rounds once; and BF16_TOL x max|ref|
TP_SP_RUNS = {  # run: (hybrid_configs, sep_impl); a world runs those whose degrees fill it
    "dp2_mp2": ({"dp_degree": 2, "mp_degree": 2}, "ulysses"),
    "mp4": ({"dp_degree": 1, "mp_degree": 4}, "ulysses"),
    "dp2_sp2_ring": ({"dp_degree": 2, "sep_degree": 2}, "ring"),
    "sp4_ulysses": ({"dp_degree": 1, "sep_degree": 4}, "ulysses"),
    "mp2_sp2_ring": ({"dp_degree": 1, "mp_degree": 2, "sep_degree": 2}, "ring"),
    "mp2": ({"dp_degree": 1, "mp_degree": 2}, "ulysses"),
    "sp2_ring": ({"dp_degree": 1, "sep_degree": 2}, "ring"),
}


def _tp_sp_runs(world):
    return [name for name, (deg, _) in TP_SP_RUNS.items()
            if math.prod(deg.values()) == world]


def _ring_blocks(sp_rank, sp, impl):
    """Flash launches a layer takes on an sp rank: the causal ring's blocks
    up to its own, one otherwise."""
    return sp_rank + 1 if impl == "ring" and sp > 1 else 1


def tp_sp_worker(out_dir):
    """One rank of the tp_sp phase (started by the port's spawn): GPT-2 124M
    on the global ids [8, 1024] through fleet.init -> fleet.distributed_engine.
    At world 1: phase_train's step (TrainStepEngine, no process group) and
    then the step built on the mp layers through fleet at mp_degree = 1, 3
    bf16 steps each, from the same weights. Past one rank: each run of
    _tp_sp_runs(world) at f32 and at bf16, TP_SP_STEPS steps each. Writes
    ``out_dir/rank<r>.json``."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import TrainStepEngine, fleet
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    torch.cuda.set_device(int(os.environ["FLAGS_selected_gpus"]))
    cfg = GPTConfig()
    gen = torch.Generator().manual_seed(0)   # main()'s ids
    ids = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen).cuda()
    labels = torch.roll(ids, -1, 1)
    out = {"world": world, "rank": rank}

    def run(name, engine_of, dtype):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = GPTForPretraining(cfg, seed=0)
        engine = engine_of(model, AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                                        weight_decay=0.01))
        _reset_launch_counts()
        ctx = auto_cast(dtype="bfloat16") if dtype == "bf16" else contextlib.nullcontext()
        with ctx:
            losses, step_ms = _steps(engine, ids, labels, TP_SP_STEPS)
        rec = {"losses": losses, "step_ms": step_ms,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "fwd": dict(fa.launches_by_route), "bwd": _bwd_routes()}
        if world == 1:
            rec["digests"] = _param_digests(engine)
        out[f"{name}_{dtype}"] = rec
        del model, engine

    if world == 1:   # before any process group: phase_train's engine
        run("plain", TrainStepEngine, "bf16")
    for name in (["mp1"] if world == 1 else _tp_sp_runs(world)):
        degrees, impl = TP_SP_RUNS.get(name, ({"dp_degree": 1, "mp_degree": 1}, "ulysses"))
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = degrees
        strategy.sep_impl = impl
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        out[name] = {"sp_rank": hcg.get_sep_parallel_rank(),
                     "mp_rank": hcg.get_model_parallel_rank(), "impl": impl,
                     "sp": hcg.get_sep_parallel_world_size(),
                     "mp": hcg.get_model_parallel_world_size()}
        for dtype in (("bf16",) if world == 1 else ("f32", "bf16")):
            run(name, fleet.distributed_engine, dtype)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _ring_case(P, dtype, b=8, s=1024, h=12, d=64):
    """ring_attention_virtual at P ranks against flash_attention over the
    whole sequence, causal, forward and backward of sum(o * do); returns the
    record (errors, launches by route, ms)."""
    from paddle_tpu_torch.distributed.meta_parallel import sequence_parallel as sp
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(P)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g).to(dtype).cuda() for _ in range(4))

    def grads(fn):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*x)
        o.backward(do)
        return [o.detach()] + [t.grad for t in x]

    want = grads(lambda q_, k_, v_: fa.flash_attention(q_, k_, v_, causal=True))
    _reset_launch_counts()
    got = grads(lambda q_, k_, v_: sp.ring_attention_virtual(q_, k_, v_, P, causal=True))
    route = "mma" if dtype == torch.bfloat16 else "tf32x3"
    n = P * (P + 1) // 2
    _check_route_launches(f"tp_sp ring P={P} {dtype}", *_route_counts(), n, n, route)
    rec = {"P": P, "dtype": str(dtype).split(".")[-1], "shape": [b, s, h, d],
           "block_shape": [b, s // P, h, d], "causal": True,
           "launches": {"flash_attention_fwd": n, "flash_attention_bwd_dkdv": n,
                        "flash_attention_bwd_dq": n}, "route": route}
    frob_tol = RING_F32_FROB_TOL if dtype == torch.float32 else RING_BF16_FROB_TOL
    for name, a, w, grad in zip(("o", "dq", "dk", "dv"), got, want, (False, True, True, True)):
        err, tol = _close_or_raise(f"tp_sp ring P={P} {name}", a, w, dtype, grad=grad)
        frob = head_rel_frob(a, w)
        if not frob <= frob_tol:
            raise AssertionError(f"tp_sp ring P={P} {dtype} {name}: head relative "
                                 f"Frobenius error {frob} (tol {frob_tol})")
        rec[f"max_abs_err_{name}"], rec[f"tol_{name}"], rec[f"head_frob_{name}"] = err, tol, frob
    rec["ring_fwd_bwd_ms"] = cuda_ms(lambda: grads(
        lambda q_, k_, v_: sp.ring_attention_virtual(q_, k_, v_, P, causal=True)), iters=5)
    rec["whole_fwd_bwd_ms"] = cuda_ms(lambda: grads(
        lambda q_, k_, v_: fa.flash_attention(q_, k_, v_, causal=True)), iters=5)
    return rec


def _block_kernels_vs_plain(P=4, b=8, s=1024, h=12, d=64):
    """Each flash kernel, both routes, at the ring's block shape [b, s/P, h,
    d], causal (the diagonal block) and not (a past block), against its
    plain version."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    out = {}
    g = torch.Generator().manual_seed(11)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn(b, s // P, h, d, generator=g).to(dtype).cuda()
                       for _ in range(4))
        for causal in (True, False):
            key = f"{str(dtype).split('.')[-1]}_{'causal' if causal else 'plain'}"
            o, lse = fa._launch(q, k, v, causal, 1 / math.sqrt(d))
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal)
            delta = fa.attention_delta(o_ref, do)
            dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse_ref, delta, causal)
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse_ref, delta, causal)
            refs = fa.flash_attention_bwd_plain(q, k, v, do, lse_ref, delta, causal)
            errs = {"o": _close_or_raise(f"tp_sp block {key} o", o, o_ref, dtype)[0],
                    "lse": _close_or_raise(f"tp_sp block {key} lse", lse, lse_ref, dtype,
                                           tol=_f32_tol(lse_ref))[0]}
            for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
                errs[name] = _close_or_raise(f"tp_sp block {key} {name}", a, w, dtype,
                                             grad=True)[0]
                frob = head_rel_frob(a, w)
                tol = GRAD_F32_FROB_TOL if dtype == torch.float32 else GRAD_BF16_FROB_TOL
                if not frob <= tol:
                    raise AssertionError(f"tp_sp block {key} {name}: head relative "
                                         f"Frobenius error {frob} (tol {tol})")
            out[key] = errs
    return out


def phase_tp_sp(ids):
    """Tensor and sequence parallelism (phase docstring item 7e). Its
    one-card process then runs the pp phase's one-card rank (ranks_worker).
    Returns the flash launches of its path on this process and rank 0,
    {"bf16": {kernel: n}, "f32": {kernel: n}}, and that pp rank's results
    (phase_pp's ``one_card_ranks``)."""
    import tempfile

    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.models import GPTConfig

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    blocks = _block_kernels_vs_plain()
    rings = [_ring_case(P, dtype) for dtype in (torch.bfloat16, torch.float32)
             for P in (2, 4)]
    for rec in rings:
        emit(phase="tp_sp_ring", **rec)
    counts = {"bf16": collections.Counter(), "f32": collections.Counter()}
    for rec in rings:
        counts["bf16" if rec["route"] == "mma" else "f32"].update(rec["launches"])
    ref_f32 = None
    if world >= 2:   # the one-card f32 engine on the same global batch and weights
        _, engine = _train_engine(GPTConfig(), "cuda")
        ref_f32, _ = _steps(engine, ids, torch.roll(ids, -1, 1), TP_SP_STEPS)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        worlds = [1] + ([world] if world >= 2 else [])
        ranks = {}
        pp_dir = os.path.join(d, "pp")
        os.mkdir(pp_dir)
        for w in worlds:
            if w == 1:   # the same process then runs the pp phase's one-card rank
                spawn(ranks_worker, args=([("tp_sp_worker", d), ("pp_worker", pp_dir)],),
                      nprocs=1, timeout=TP_SP_TIMEOUT_S + PP_TIMEOUT_S)
                with open(os.path.join(pp_dir, "rank0.json")) as f:
                    pp_one = [json.load(f)]
            else:
                spawn(tp_sp_worker, args=(d,), nprocs=w, timeout=TP_SP_TIMEOUT_S)
            ranks[w] = []
            for r in range(w):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    ranks[w].append(json.load(f))
    one = ranks[1][0]
    nl = GPTConfig().num_layers
    plain, mp1 = one["plain_bf16"], one["mp1_bf16"]
    if not (plain["losses"] == mp1["losses"] and plain["digests"] == mp1["digests"]):
        raise AssertionError("tp_sp: the step on the mp layers through fleet at mp_degree=1 "
                             "is not phase_train's step bit for bit")
    _check_mma_launches("tp_sp mp1", mp1["fwd"], mp1["bwd"], TP_SP_STEPS * nl,
                        TP_SP_STEPS * nl)
    counts["bf16"].update({k: TP_SP_STEPS * nl for k in _launch_counts_keys()})
    emit(phase="tp_sp", what="mp1_vs_train", losses=mp1["losses"], step_ms=mp1["step_ms"],
         plain_step_ms=plain["step_ms"], peak_bytes=mp1["peak_bytes"], bit_for_bit=True,
         params=len(mp1["digests"]))
    if world >= 2:
        rs = ranks[world]
        r0 = rs[0]
        for name in _tp_sp_runs(world):
            rec = {"phase": "tp_sp", "run": name, "world": world,
                   "hybrid_configs": TP_SP_RUNS[name][0], "sep_impl": TP_SP_RUNS[name][1],
                   "global_batch": list(ids.shape), "one_card_f32_losses": ref_f32}
            for dtype, route in (("f32", "tf32x3"), ("bf16", "mma")):
                runs = [r[f"{name}_{dtype}"] for r in rs]
                losses = runs[0]["losses"]
                if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
                    raise AssertionError(f"tp_sp {name} {dtype}: losses {losses}")
                want = ref_f32 if dtype == "f32" else r0[f"{name}_f32"]["losses"]
                rtol = TP_SP_F32_RTOL if dtype == "f32" else TP_SP_BF16_RTOL
                rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
                if not rel <= rtol:
                    raise AssertionError(f"tp_sp {name} {dtype}: losses {losses} against "
                                         f"{want}: relative {rel} (rtol {rtol})")
                for r, run in zip(rs, runs):   # every rank's launches, on its route
                    n = TP_SP_STEPS * nl * _ring_blocks(r[name]["sp_rank"], r[name]["sp"],
                                                        r[name]["impl"])
                    _check_route_launches(f"tp_sp {name} {dtype} rank {r['rank']}",
                                          run["fwd"], run["bwd"], n, n, route)
                med = statistics.median(runs[0]["step_ms"][1:])
                rec[dtype] = {"losses": losses, "rel_err": rel, "rtol": rtol,
                              "step_ms": runs[0]["step_ms"], "step_ms_median": med,
                              "tokens_per_s_per_card": ids.numel() / (med / 1e3) / world,
                              "peak_bytes_per_rank": [r["peak_bytes"] for r in runs],
                              "flash_fwd_per_step_per_rank": [
                                  sum(r["fwd"].values()) // TP_SP_STEPS for r in runs]}
            emit(**rec)
    emit(phase="tp_sp", what="checks", passed=True, world=world, block_kernels=blocks,
         seconds=time.perf_counter() - t0)
    return {k: dict(v) for k, v in counts.items()}, pp_one


PP_STEPS = 3              # steps of each pp run, at f32 and at bf16
PP_TIMEOUT_S = 600        # the pp phase's ranks, all runs
PP_MICRO = 4              # pipeline micro-batches of the pp > 1 runs
PP_RING_F32_FROB_TOL = 1e-5   # virtual ring vs the same Pipe at pp = 1, f32: the loss
                          # (relative) and each parameter's gradient in relative
                          # Frobenius norm (the micro-batches sum the gradients in
                          # another order; a dropped or doubled micro-batch, or a
                          # cotangent summed over the ring, is off by O(1e-1))
PP_RING_BF16_FROB_TOL = 3e-2  # ... bf16 (each micro-batch's products round to bf16
                          # on their own rows)
MOE_F32_FROB_TOL = 1e-5   # MoELayer on the card vs the same layer on the CPU, f32:
                          # output and every gradient, relative Frobenius
PP_RUNS = {  # run: (hybrid_configs, num_virtual_stages); a world runs those that fill it
    "pp4": ({"dp_degree": 1, "pp_degree": 4}, 1),
    "pp2_dp2": ({"dp_degree": 2, "pp_degree": 2}, 1),
    "pp2_mp2": ({"dp_degree": 1, "pp_degree": 2, "mp_degree": 2}, 1),
    "pp2_v2_dp2": ({"dp_degree": 2, "pp_degree": 2}, 2),
    "pp2": ({"dp_degree": 1, "pp_degree": 2}, 1),
}


def _pp_runs(world):
    return [name for name, (deg, _) in PP_RUNS.items() if math.prod(deg.values()) == world]


def _pp_flash_per_step(deg, virtual, micro, layers):
    """Flash launches a step of each kernel on one rank: its stage's layers
    on every micro-batch (bubble ticks run no body); at pp 1 one pass over
    the layers on the whole batch."""
    pp = deg.get("pp_degree", 1)
    if pp == 1:
        return layers
    return layers // (pp * virtual) * virtual * micro


def _bubble(pp, virtual, micro):
    """Ticks of the schedule and the share of a rank's ticks that are idle."""
    ticks = micro * virtual + pp - 1
    return ticks, 1 - micro * virtual / ticks


def _pipe_from_gpt(gpt_state, cfg, virtual=1, micro=PP_MICRO, stages=None):
    """GPTForPretrainingPipe of ``stages`` stages (default: the pp degree of
    the topology fleet.init set last, or 1) on the card, with
    GPTForPretraining's weights (``gpt_state``, logical, on the CPU): the
    rank's stage and mp shards."""
    from paddle_tpu_torch.distributed.mesh import get_hybrid_communicate_group
    from paddle_tpu_torch.models import (GPTForPretrainingPipe, load_jax_state,
                                         pipe_state_from_gpt)

    hcg = get_hybrid_communicate_group()
    stages = stages or (hcg.get_pipe_parallel_world_size() if hcg is not None else 1)
    model = GPTForPretrainingPipe(cfg, num_stages=stages, num_microbatches=micro,
                                  num_virtual_stages=virtual, device="cpu")
    state = pipe_state_from_gpt(gpt_state, stages, virtual)
    load_jax_state(model, {n: t.numpy() for n, t in state.items()})
    return model.cuda()


def pp_worker(out_dir):
    """One rank of the pp phase (started by the port's spawn): GPT-2 124M's
    Pipe on the global ids [8, 1024] through fleet.init ->
    fleet.distributed_model -> fleet.distributed_engine, from
    GPTForPretraining(seed=0)'s weights. At world 1 pp_degree = 1 (one pass
    over the stages); past one rank each run of _pp_runs(world). f32 and
    bf16, PP_STEPS steps each. Writes ``out_dir/rank<r>.json``."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    torch.cuda.set_device(int(os.environ["FLAGS_selected_gpus"]))
    cfg = GPTConfig()
    gpt_state = {n: t.detach() for n, t in
                 GPTForPretraining(cfg, device="cpu", seed=0).state_dict().items()}
    gen = torch.Generator().manual_seed(0)   # main()'s ids
    ids = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen).cuda()
    labels = torch.roll(ids, -1, 1)
    out = {"world": world, "rank": rank}
    names = _pp_runs(world) if world > 1 else ["pp1"]
    for name in names:
        degrees, virtual = PP_RUNS.get(name, ({"dp_degree": 1, "pp_degree": 1}, 1))
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = degrees
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        out[name] = {"stage": hcg.get_stage_id(), "pp": hcg.get_pipe_parallel_world_size(),
                     "mp_rank": hcg.get_model_parallel_rank()}
        for dtype in ("f32", "bf16"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = fleet.distributed_model(_pipe_from_gpt(gpt_state, cfg, virtual))
            engine = fleet.distributed_engine(model, AdamW(
                learning_rate=1e-4, parameters=model.named_parameters(), weight_decay=0.01))
            _reset_launch_counts()
            ctx = auto_cast(dtype="bfloat16") if dtype == "bf16" else contextlib.nullcontext()
            with ctx:
                losses, step_ms = _steps(engine, ids, labels, PP_STEPS)
            out[f"{name}_{dtype}"] = {
                "losses": losses, "step_ms": step_ms,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "fwd": dict(fa.launches_by_route), "bwd": _bwd_routes()}
            del model, engine
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _pp_virtual_ring(gpt_state, cfg, ids, S, V, dtype):
    """The Pipe's S stages (V chunks each) through the schedule over a
    VirtualRing(S) on this card against the same Pipe at pp = 1 (one pass
    over the stages), M = S micro-batches: the loss and every parameter's
    gradient. Returns the record (errors, launches, ms)."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed.meta_parallel.sequence_parallel import VirtualRing
    model = _pipe_from_gpt(gpt_state, cfg, V, micro=S, stages=S)   # all S stages here
    labels = torch.roll(ids, -1, 1)
    ctx = (lambda: auto_cast(dtype="bfloat16")) if dtype == torch.bfloat16 else (
        contextlib.nullcontext)

    def run(ring):
        model.pipeline_ring = ring
        model.zero_grad(set_to_none=True)
        with ctx():
            loss = model(ids, labels)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

    want_loss, want = run(None)
    _reset_launch_counts()
    got_loss, got = run(VirtualRing(S))
    route = "mma" if dtype == torch.bfloat16 else "tf32x3"
    n = cfg.num_layers * S       # every layer on each of the S micro-batches
    _check_route_launches(f"pp ring S={S} V={V} {dtype}", *_route_counts(), n, n, route)
    tol = PP_RING_F32_FROB_TOL if dtype == torch.float32 else PP_RING_BF16_FROB_TOL
    rel_loss = abs(got_loss - want_loss) / abs(want_loss)
    errs = {name: rel_frob(got[name], w) for name, w in want.items()}
    worst = max(errs, key=errs.get)
    if not (rel_loss <= tol and errs[worst] <= tol and math.isfinite(got_loss)):
        raise AssertionError(f"pp ring S={S} V={V} {dtype}: loss {got_loss} against "
                             f"{want_loss} (relative {rel_loss}), {worst}'s gradient "
                             f"relative Frobenius {errs[worst]} (tol {tol})")
    ring_ms = cuda_ms(lambda: run(VirtualRing(S)), iters=2, warmup=0)
    plain_ms = cuda_ms(lambda: run(None), iters=2, warmup=0)
    del model
    return {"S": S, "V": V, "dtype": str(dtype).split(".")[-1], "micro_batches": S,
            "ticks": _bubble(S, V, S)[0],
            "loss": got_loss, "pp1_loss": want_loss, "rel_loss": rel_loss,
            "max_grad_rel_frob": errs[worst], "worst_param": worst, "tol": tol,
            "launches": {"flash_attention_fwd": n, "flash_attention_bwd_dkdv": n,
                         "flash_attention_bwd_dq": n}, "route": route,
            "ring_fwd_bwd_ms": ring_ms, "pp1_fwd_bwd_ms": plain_ms}


def _pp_micro_kernels_vs_plain(mbs=(4, 2), s=1024, h=12, d=64):
    """Each flash kernel, both routes, causal, at the pipe's micro-batch
    shapes [8 / M, s, h, d], against its plain version."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    out = {}
    g = torch.Generator().manual_seed(13)
    for b in mbs:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn(b, s, h, d, generator=g).to(dtype).cuda()
                           for _ in range(4))
            key = f"b{b}_{str(dtype).split('.')[-1]}"
            o, lse = fa._launch(q, k, v, True, 1 / math.sqrt(d))
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, True)
            delta = fa.attention_delta(o_ref, do)
            dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse_ref, delta, True)
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse_ref, delta, True)
            refs = fa.flash_attention_bwd_plain(q, k, v, do, lse_ref, delta, True)
            errs = {"o": _close_or_raise(f"pp micro {key} o", o, o_ref, dtype)[0],
                    "lse": _close_or_raise(f"pp micro {key} lse", lse, lse_ref, dtype,
                                           tol=_f32_tol(lse_ref))[0]}
            for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
                errs[name] = _close_or_raise(f"pp micro {key} {name}", a, w, dtype,
                                             grad=True)[0]
                frob = head_rel_frob(a, w)
                tol = GRAD_F32_FROB_TOL if dtype == torch.float32 else GRAD_BF16_FROB_TOL
                if not frob <= tol:
                    raise AssertionError(f"pp micro {key} {name}: head relative "
                                         f"Frobenius error {frob} (tol {tol})")
            out[key] = errs
    return out


def _moe_case(dtype, tokens=8192, d_model=768, d_hidden=3072, experts=8, top_k=2,
              capacity_factor=1.25):
    """MoELayer at GPT-2 124M's width on the card: its forward and backward
    of sum(y * dy); f32 against the same layer on the CPU (output and
    every gradient); bf16 under auto_cast, against the card's f32. Returns
    the record (errors, ms, peak bytes)."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed.meta_parallel import MoELayer

    torch.manual_seed(0)
    cpu = MoELayer(d_model, d_hidden, experts, top_k=top_k, capacity_factor=capacity_factor)
    card = MoELayer(d_model, d_hidden, experts, top_k=top_k,
                    capacity_factor=capacity_factor).cuda()
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(17)
    x = torch.randn(tokens, d_model, generator=g)
    dy = torch.randn(tokens, d_model, generator=g)

    def grads(layer, xin, dyin, cast=False):
        layer.zero_grad(set_to_none=True)
        xin = xin.clone().requires_grad_()
        ctx = auto_cast(dtype="bfloat16") if cast else contextlib.nullcontext()
        with ctx:
            y = layer(xin)
        y.backward(dyin.to(y.dtype))
        return {"y": y.detach().float(), "x": xin.grad.float(),
                **{n: p.grad.float() for n, p in layer.named_parameters()}}

    xc, dyc = x.cuda(), dy.cuda()
    cast = dtype == torch.bfloat16
    xin = xc.to(dtype)
    grads(card, xin, dyc, cast)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = grads(card, xin, dyc, cast)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    ms = cuda_ms(lambda: grads(card, xin, dyc, cast), iters=3, warmup=1)
    cap = card.capacity(tokens)
    rec = {"dtype": str(dtype).split(".")[-1], "tokens": tokens, "d_model": d_model,
           "d_hidden": d_hidden, "experts": experts, "top_k": top_k,
           "capacity_factor": capacity_factor, "capacity": cap,
           "dispatch_bytes_f32": tokens * experts * cap * 4, "fwd_bwd_ms": ms,
           "peak_bytes_above_inputs": peak}
    if not all(torch.isfinite(t).all() for t in got.values()):
        raise AssertionError(f"moe {dtype}: non-finite output or gradient")
    if dtype == torch.float32:
        want = grads(cpu, x, dy)
        errs = {n: rel_frob(got[n].cpu(), w) for n, w in want.items()}
        worst = max(errs, key=errs.get)
        if not errs[worst] <= MOE_F32_FROB_TOL:
            raise AssertionError(f"moe f32 card vs CPU: {worst} relative Frobenius "
                                 f"{errs[worst]} (tol {MOE_F32_FROB_TOL})")
        rec.update(max_rel_frob_vs_cpu=errs[worst], worst=worst, tol=MOE_F32_FROB_TOL)
    else:
        want = grads(card, xc, dyc)
        rec["y_rel_frob_vs_card_f32"] = rel_frob(got["y"], want["y"])
    del card, cpu
    return rec


def phase_pp(ids, one_card=True, one_card_ranks=None):
    """Pipeline and expert parallelism (phase docstring item 7f). Returns the
    flash launches of its path on this process and rank 0: {"bf16": {kernel:
    n}, "f32": {kernel: n}}. ``one_card`` false leaves out the micro-batch
    kernel checks, the virtual rings and the MoE (a multi-card call's).
    ``one_card_ranks``: pp_worker's results at one rank where phase_tp_sp's
    process ran it, else that rank is spawned here."""
    import tempfile

    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    cfg = GPTConfig()
    nl = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    micro = _pp_micro_kernels_vs_plain() if one_card else None
    counts = {"bf16": collections.Counter(), "f32": collections.Counter()}
    # the one-card f32 engine of phase_train's model on the same batch and weights
    _, engine = _train_engine(cfg, "cuda")
    ref_f32, _ = _steps(engine, ids, torch.roll(ids, -1, 1), PP_STEPS)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    gpt_state = {n: t.detach() for n, t in
                 GPTForPretraining(cfg, device="cpu", seed=0).state_dict().items()}
    for S, V in ((2, 1), (4, 1), (2, 2)) if one_card else ():
        for dtype in (torch.float32, torch.bfloat16):
            rec = _pp_virtual_ring(gpt_state, cfg, ids, S, V, dtype)
            counts["bf16" if rec["route"] == "mma" else "f32"].update(rec["launches"])
            emit(phase="pp_ring", **rec)
            gc.collect()
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        ranks = {}
        for w in [1] + ([world] if world >= 2 else []):
            if w == 1 and one_card_ranks is not None:
                ranks[w] = one_card_ranks
                continue
            spawn(pp_worker, args=(d,), nprocs=w, timeout=PP_TIMEOUT_S)
            ranks[w] = []
            for r in range(w):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    ranks[w].append(json.load(f))
    for w, names in [(1, ["pp1"])] + ([(world, _pp_runs(world))] if world >= 2 else []):
        rs = ranks.get(w, [])
        for name in names:
            degrees, virtual = PP_RUNS.get(name, ({"dp_degree": 1, "pp_degree": 1}, 1))
            pp = degrees["pp_degree"]
            ticks, idle = _bubble(pp, virtual, PP_MICRO)
            rec = {"phase": "pp", "run": name, "world": w, "hybrid_configs": degrees,
                   "num_virtual_stages": virtual, "global_batch": list(ids.shape),
                   "micro_batches": PP_MICRO if pp > 1 else 1,
                   "schedule_ticks": ticks if pp > 1 else 1,
                   "bubble_share": idle if pp > 1 else 0.0,
                   "one_card_f32_losses": ref_f32}
            per_step = _pp_flash_per_step(degrees, virtual, PP_MICRO, nl)
            for dtype, route in (("f32", "tf32x3"), ("bf16", "mma")):
                runs_ = [r[f"{name}_{dtype}"] for r in rs]
                losses = runs_[0]["losses"]
                if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
                    raise AssertionError(f"pp {name} {dtype}: losses {losses}")
                want = ref_f32 if dtype == "f32" else rs[0][f"{name}_f32"]["losses"]
                rtol = TP_SP_F32_RTOL if dtype == "f32" else TP_SP_BF16_RTOL
                rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
                if not rel <= rtol:
                    raise AssertionError(f"pp {name} {dtype}: losses {losses} against "
                                         f"{want}: relative {rel} (rtol {rtol})")
                for r, run in zip(rs, runs_):   # every rank's launches, on its route
                    n = PP_STEPS * per_step
                    _check_route_launches(f"pp {name} {dtype} rank {r['rank']}",
                                          run["fwd"], run["bwd"], n, n, route)
                if w == 1:
                    counts[dtype].update({k: PP_STEPS * per_step
                                          for k in _launch_counts_keys()})
                med = statistics.median(runs_[0]["step_ms"][1:])
                rec[dtype] = {"losses": losses, "rel_err": rel, "rtol": rtol,
                              "step_ms": runs_[0]["step_ms"], "step_ms_median": med,
                              "tokens_per_s_per_card": ids.numel() / (med / 1e3) / w,
                              "peak_bytes_per_rank": [r["peak_bytes"] for r in runs_],
                              "flash_fwd_per_step_per_rank": [
                                  sum(r["fwd"].values()) // PP_STEPS for r in runs_]}
            emit(**rec)
    moe = [_moe_case(dtype) for dtype in (torch.float32, torch.bfloat16)] if one_card else []
    for rec in moe:
        emit(phase="pp_moe", **rec)
    emit(phase="pp", what="checks", passed=True, world=world, micro_kernels=micro,
         seconds=time.perf_counter() - t0)
    return {k: dict(v) for k, v in counts.items()}


VISION_BATCH = 128        # vision: ResNet-50's global batch, [128, 3, 224, 224]
VISION_WARMUP, VISION_STEPS = 3, 10   # ... warm-up and timed steps of each run
VISION_LR = 0.1           # ... Momentum(0.1, 0.9), the reference's ResNet recipe
VISION_GRAD_TOL = 1e-3    # vision_vs_cpu: each parameter's update (lr x its
                          # gradient) on the card against the CPU's, times the
                          # largest entry of the CPU's (f32 sums in other orders;
                          # TRAIN_GRAD_TOL's bar; a wrong convolution or batch norm
                          # is off by O(1))
VISION_STATS_TOL = 1e-4   # ... each running statistic, times its largest entry (a
                          # forward's batch mean and variance: no backward in them)
ERNIE_BATCH = (16, 512)   # ernie: ERNIE-3.0-base's [batch, seq]
ERNIE_WARMUP, ERNIE_STEPS = 2, 5      # ... warm-up and timed steps of each step kind
ERNIE_LR = 1e-4           # ... AdamW(1e-4, weight decay 0.01)
ERNIE_VS_CPU_TOL = 1e-3   # ernie_vs_cpu: each gradient of ernie_tiny's f32 step on the
                          # card (the 3xTF32 flash forward and pair) against the CPU's
                          # dense path, times its largest entry (TRAIN_GRAD_TOL's bar)
MULTI_CARD_STEPS = 3      # vision and ernie past one card: steps of each run
MULTI_CARD_FIRST_RTOL = 1e-5  # ... the first f32 loss (a forward from the same weights:
                          # batch norm's statistics and the valid-label mean over
                          # the ranks, sums in other orders) against the one-card
                          # engine's on the same global batch; per-rank statistics
                          # or denominators move it by 1e-3 or more
MULTI_CARD_RTOL = 1e-3    # ... each later f32 loss (ERNIE; GPT's phases hold 1e-4)
VISION_MULTI_RTOL = 2e-2  # ... each later ResNet loss: Momentum 0.1 on one batch
                          # amplifies the first gradient's rounding step by step
                          # (its f32 update differs from its own f64 one by 1e-3 to
                          # 3e-1 of an entry, tests/test_torch_vision.py): 3.5e-3 to
                          # 4.9e-3 at step 3 on four H100s; an unreduced gradient
                          # is off by O(1e-1)
MULTI_CARD_TIMEOUT_S = 600


def _image_batch(b, hw, classes, seed, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 3, hw, hw, generator=g)
    y = torch.randint(0, classes, (b,), generator=g)
    return x.to(device), y.to(device)


def _vision_engine(model, engine_of=None):
    """``model``'s engine with Momentum(VISION_LR, 0.9) and loss_fn=CrossEntropyLoss()
    (``engine_of``: fleet.distributed_engine in a rank; TrainStepEngine by
    default)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.optimizer import Momentum

    opt = Momentum(learning_rate=VISION_LR, momentum=0.9, parameters=model.named_parameters())
    return (engine_of or TrainStepEngine)(model, opt, loss_fn=nn.CrossEntropyLoss())


def _vision_run(what, x, y, amp, cudnn_tf32=False, profile=False):
    """ResNet-50 (seed 0) through the engine with loss_fn, VISION_WARMUP +
    VISION_STEPS steps on one batch; the record."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.vision.models import resnet50

    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    try:
        model = resnet50(seed=0)
        engine = _vision_engine(model)
        torch.cuda.reset_peak_memory_stats()
        ctx = auto_cast(dtype="bfloat16") if amp else contextlib.nullcontext()
        with ctx:
            losses, step_ms = _steps(engine, x, y, VISION_WARMUP + VISION_STEPS)
            # Momentum(0.1, 0.9) on one batch of random labels falls over the
            # warm-up steps, then swings (7.7 -> 5.4 -> 9.5 -> 7.1 at bf16 on
            # an H100): every loss finite, the fall held where it is not yet
            # chaotic
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"vision {what}: non-finite loss {losses}")
            _falls(f"vision {what}", losses[:VISION_WARMUP])
            med = statistics.median(step_ms[VISION_WARMUP:])
            rec = dict(phase="vision", run=what, model="resnet50", batch=list(x.shape),
                       classes=1000, optimizer=f"Momentum({VISION_LR}, 0.9)",
                       loss_fn="CrossEntropyLoss", amp="bfloat16 O1" if amp else None,
                       cudnn_allow_tf32=cudnn_tf32, warmup_steps=VISION_WARMUP,
                       timed_steps=VISION_STEPS, losses=losses,
                       step_ms=step_ms[VISION_WARMUP:], step_ms_median=med,
                       images_per_s=x.shape[0] / (med / 1e3),
                       max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
            if profile:
                wall, kernel_ms, top = device_profile(lambda: engine.step(x, y), top=8)
                rec.update(profiled_wall_ms=wall, kernel_ms=kernel_ms,
                           device_busy_share=kernel_ms / med, top_kernels=top)
        buffers = {n: b.float().cpu() for n, b in model.named_buffers()}
        if not all(bool(torch.isfinite(b).all()) for b in buffers.values()):
            raise AssertionError(f"vision {what}: non-finite running statistics")
        emit(**rec)
        return rec
    finally:
        torch.backends.cudnn.allow_tf32 = False


def _vision_vs_cpu():
    """One f32 engine step of ResNet-18 at [8, 3, 64, 64] (10 classes) on the
    card and on the CPU from the same weights: the loss, each parameter's
    update and each running statistic."""
    from paddle_tpu_torch.vision.models import resnet18

    x, y = _image_batch(8, 64, 10, seed=1, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        model = resnet18(num_classes=10, seed=0, device=device)
        p0 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        engine = _vision_engine(model)
        loss = engine.step(x, y).item()
        out[device] = (loss, {n: p.detach().cpu() - p0[n] for n, p in model.named_parameters()},
                       {n: b.cpu() for n, b in model.named_buffers()})
        del model, engine
    (l_gpu, d_gpu, s_gpu), (l_cpu, d_cpu, s_cpu) = out["cuda"], out["cpu"]
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"vision_vs_cpu: card loss {l_gpu} vs CPU {l_cpu}")
    worst = {}
    for kind, got, want, tol in (("update", d_gpu, d_cpu, VISION_GRAD_TOL),
                                 ("stat", s_gpu, s_cpu, VISION_STATS_TOL)):
        for name, w in want.items():
            scale = w.abs().max().item()
            err = (got[name] - w).abs().max().item()
            worst[f"{kind} {name}"] = err / scale if scale else err
            if not err <= tol * scale:
                raise AssertionError(f"vision_vs_cpu: {kind} of {name}: {err} "
                                     f"(max|ref| {scale}, tol {tol})")
    name = max(worst, key=worst.get)
    rec = dict(phase="vision_vs_cpu", model="resnet18", batch=[8, 3, 64, 64],
               dtype="float32", cudnn_allow_tf32=False, loss_card=l_gpu, loss_cpu=l_cpu,
               loss_rel_err=loss_err, worst_rel_err=worst[name], worst=name,
               update_tol=VISION_GRAD_TOL, stats_tol=VISION_STATS_TOL,
               params=len(d_cpu), stats=len(s_cpu))
    emit(**rec)
    return rec


def vision_worker(out_dir):
    """One rank of the vision phase past one card: ResNet-50 (seed 0) through
    fleet.init (dp_degree = world) -> fleet.distributed_engine(model,
    Momentum, loss_fn=CrossEntropyLoss()) on the global batch [128, 3, 224,
    224], f32, MULTI_CARD_STEPS steps. Writes ``out_dir/rank<r>.json``."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.vision.models import resnet50

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    torch.cuda.set_device(int(os.environ["FLAGS_selected_gpus"]))
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": world}
    fleet.init(is_collective=True, strategy=strategy)
    x, y = _image_batch(VISION_BATCH, 224, 1000, seed=0)
    model = resnet50(seed=0)
    engine = _vision_engine(model, engine_of=fleet.distributed_engine)
    losses, step_ms = _steps(engine, x, y, MULTI_CARD_STEPS)
    import hashlib

    stats = hashlib.sha256(b"".join(b.float().cpu().numpy().tobytes()
                                    for _, b in model.named_buffers())).hexdigest()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "losses": losses, "step_ms": step_ms, "stats": stats,
                   "peak_bytes": torch.cuda.max_memory_allocated()}, f)


def phase_vision():
    """BASELINE config 2 on the port (phase docstring item 11)."""
    import tempfile

    from paddle_tpu_torch.bench import card_name_and_power_limit
    from paddle_tpu_torch.distributed import spawn

    t0 = time.perf_counter()
    card = card_name_and_power_limit()
    x, y = _image_batch(VISION_BATCH, 224, 1000, seed=0)
    runs = [_vision_run("bf16", x, y, amp=True, profile=True),
            _vision_run("f32", x, y, amp=False),
            _vision_run("f32_cudnn_tf32", x, y, amp=False, cudnn_tf32=True)]
    vs_cpu = _vision_vs_cpu()
    world = torch.cuda.device_count()
    if world >= 2:
        ref = _vision_run("f32_reference_3_steps", x, y, amp=False)["losses"][
            :MULTI_CARD_STEPS]
        with tempfile.TemporaryDirectory() as d:
            spawn(vision_worker, args=(d,), nprocs=world, timeout=MULTI_CARD_TIMEOUT_S)
            ranks = [json.load(open(os.path.join(d, f"rank{r}.json"))) for r in range(world)]
        losses = ranks[0]["losses"]
        first = abs(losses[0] - ref[0]) / abs(ref[0])
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        if not (first <= MULTI_CARD_FIRST_RTOL and rel <= VISION_MULTI_RTOL
                and len({r["stats"] for r in ranks}) == 1):
            raise AssertionError(f"vision dp{world}: losses {losses} against one card's "
                                 f"{ref} (relative {first} at the first, {rel} at most), "
                                 f"running statistics alike on every rank: "
                                 f"{len({r['stats'] for r in ranks}) == 1}")
        med = statistics.median(ranks[0]["step_ms"][1:])
        emit(phase="vision", run=f"dp{world}_f32", world=world, losses=losses,
             one_card_losses=ref, first_rel_err=first, rel_err=rel,
             rtol=[MULTI_CARD_FIRST_RTOL, VISION_MULTI_RTOL],
             step_ms=ranks[0]["step_ms"], step_ms_median=med,
             images_per_s=VISION_BATCH / (med / 1e3),
             peak_bytes_per_rank=[r["peak_bytes"] for r in ranks], same_stats=True)
    for rec in runs:
        print(f"vision: resnet50 {rec['run']} {rec['images_per_s']:.1f} images/s, "
              f"{rec['step_ms_median']:.2f} ms a step, peak "
              f"{rec['max_memory_allocated_bytes'] / 2**30:.2f} GiB ({card})", flush=True)
    emit(phase="vision", what="checks", passed=True, vs_cpu_worst=vs_cpu["worst_rel_err"],
         seconds=time.perf_counter() - t0)


def _ernie_batch(cfg, b, s, seed, device="cuda"):
    """ids, MLM labels (15%, -100 elsewhere), token types, a padding mask
    (each row valid to a random length of at least s / 2) and NSP labels."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    labels = torch.where(torch.rand(b, s, generator=g) < 0.15, ids, -100)
    types = (torch.arange(s)[None, :] >= torch.randint(8, s - 8, (b, 1), generator=g)).long()
    lengths = torch.randint(s // 2, s + 1, (b, 1), generator=g)
    mask = (torch.arange(s)[None, :] < lengths).long()
    nsp = torch.randint(0, 2, (b,), generator=g)
    return [t.to(device) for t in (ids, labels, types, mask, nsp)]


def _ernie_engine(model, engine_of=None):
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=ERNIE_LR, parameters=model.named_parameters(),
                weight_decay=0.01)
    return (engine_of or TrainStepEngine)(model, opt)


def _ernie_step_run(what, cfg, batch, steps=(ERNIE_WARMUP, ERNIE_STEPS)):
    """ErnieForPretraining(cfg, seed 0) through the engine, bf16 O1: the
    record and the flash launches of the timed steps."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import ErnieForPretraining
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    model = ErnieForPretraining(cfg, seed=0)
    engine = _ernie_engine(model)
    torch.cuda.reset_peak_memory_stats()
    with auto_cast(dtype="bfloat16"):
        losses, _ = _ernie_steps(engine, batch, steps[0])
        _reset_launch_counts()
        timed, step_ms = _ernie_steps(engine, batch, steps[1])
        launches = _launch_counts()
        routes = _route_counts()
    losses += timed
    _falls(f"ernie {what}", losses)
    med = statistics.median(step_ms)
    ids = batch[0]
    rec = dict(phase="ernie", run=what, model="ernie-3.0-base", batch=list(ids.shape),
               amp="bfloat16 O1", optimizer=f"AdamW({ERNIE_LR}, weight_decay=0.01)",
               dropout=cfg.dropout, attention_dropout=cfg.attention_dropout,
               padding_mask=len(batch) > 3 and batch[3] is not None,
               warmup_steps=steps[0], timed_steps=steps[1], losses=losses,
               step_ms=step_ms, step_ms_median=med,
               tokens_per_s=ids.numel() / (med / 1e3),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               launches=launches, flash_fwd_launches_by_route=routes[0],
               flash_bwd_launches_by_route=routes[1])
    emit(**rec)
    del model, engine
    return rec, launches, routes


def _ernie_steps(engine, batch, n):
    losses, step_ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(engine.step(*batch).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms


def _ernie_vs_cpu():
    """One f32 step of ernie_tiny at [4, 128], no mask (the card's 3xTF32 flash
    forward and pair; the CPU's dense path): the loss and every gradient."""
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_tiny

    cfg = ernie_tiny()
    ids, labels, types, _, nsp = _ernie_batch(cfg, 4, 128, seed=2, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        model = ErnieForPretraining(cfg, seed=1, device=device)
        engine = _ernie_engine(model)
        _reset_launch_counts()
        loss = engine.step(ids, labels, types, None, nsp).item()
        out[device] = (loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
                       _route_counts())
        del model, engine
    (l_gpu, g_gpu, r_gpu), (l_cpu, g_cpu, _) = out["cuda"], out["cpu"]
    _check_route_launches("ernie_vs_cpu", *r_gpu, cfg.num_layers, cfg.num_layers, "tf32x3")
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"ernie_vs_cpu: card loss {l_gpu} vs CPU {l_cpu}")
    worst = {}
    for name, g in g_cpu.items():
        scale = g.abs().max().item()
        err = (g_gpu[name] - g).abs().max().item()
        worst[name] = err / scale if scale else err
        if not err <= ERNIE_VS_CPU_TOL * scale:
            raise AssertionError(f"ernie_vs_cpu: gradient of {name}: {err} (max|g| {scale})")
    name = max(worst, key=worst.get)
    rec = dict(phase="ernie_vs_cpu", model="ernie_tiny", batch=[4, 128], dtype="float32",
               loss_card=l_gpu, loss_cpu=l_cpu, loss_rel_err=loss_err,
               grad_worst_rel_err=worst[name], grad_worst_param=name,
               grad_tol=ERNIE_VS_CPU_TOL)
    emit(**rec)
    return rec


def ernie_worker(out_dir):
    """One rank of the ernie phase past one card: ErnieForPretraining(ernie_base(
    attention_dropout=0, dropout=0), seed 0) through fleet.init
    (sharding_degree = world, ZeRO) -> fleet.distributed_engine on the global
    batch [16, 512] without a mask, f32, MULTI_CARD_STEPS steps. Writes
    ``out_dir/rank<r>.json``."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_base

    torch.backends.cuda.matmul.allow_tf32 = False
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    torch.cuda.set_device(int(os.environ["FLAGS_selected_gpus"]))
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"sharding_degree": world}
    strategy.sharding = True
    fleet.init(is_collective=True, strategy=strategy)
    cfg = ernie_base(dropout=0.0, attention_dropout=0.0)
    ids, labels, types, _, nsp = _ernie_batch(cfg, *ERNIE_BATCH, seed=0)
    model = ErnieForPretraining(cfg, seed=0)
    engine = _ernie_engine(model, engine_of=fleet.distributed_engine)
    losses, step_ms = _ernie_steps(engine, (ids, labels, types, None, nsp), MULTI_CARD_STEPS)
    held = sum(t.numel() for t in engine._zero_opt) if engine._zero_opt is not None else 0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "losses": losses, "step_ms": step_ms,
                   "opt_elems_held": held,
                   "opt_elems_replicated": 2 * sum(p.numel() for p in model.parameters()),
                   "peak_bytes": torch.cuda.max_memory_allocated()}, f)


def phase_ernie():
    """BASELINE config 3's model on the port (phase docstring item 12).
    Returns the flash launches of its bf16 and f32 runs: {"bf16": {kernel:
    n}, "f32": {kernel: n}}."""
    import tempfile

    from paddle_tpu_torch.bench import card_name_and_power_limit
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_base

    t0 = time.perf_counter()
    card = card_name_and_power_limit()
    cfg = ernie_base()
    batch = _ernie_batch(cfg, *ERNIE_BATCH, seed=0)
    n = cfg.num_layers
    dense, dense_launches, dense_routes = _ernie_step_run("published_dropout_masked", cfg,
                                                         batch)
    _check_route_launches("ernie dense step", *dense_routes, 0, 0, "mma")
    flash_cfg = ernie_base(attention_dropout=0.0)
    ids, labels, types, _, nsp = batch
    flash, flash_launches, flash_routes = _ernie_step_run(
        "attention_dropout_0_no_mask", flash_cfg, [ids, labels, types, None, nsp])
    _check_route_launches("ernie flash step", *flash_routes, n * ERNIE_STEPS,
                          n * ERNIE_STEPS, "mma")
    # the eval forward, f32, no mask: the 3xTF32 flash forward, against the
    # same forward through the dense path (a mask of ones)
    gc.collect()
    torch.cuda.empty_cache()
    model = ErnieForPretraining(flash_cfg, seed=0).eval()
    with torch.no_grad():
        _reset_launch_counts()
        h_flash, pooled = model.ernie(ids, types)
        torch.cuda.synchronize()
        eval_routes = _route_counts()
        eval_launches = _launch_counts()
        h_dense, _ = model.ernie(ids, types, torch.ones_like(ids))
    _check_route_launches("ernie eval forward", *eval_routes, n, 0, "tf32x3")
    if not (bool(torch.isfinite(h_flash).all()) and bool(torch.isfinite(pooled).all())):
        raise AssertionError("ernie eval forward: non-finite hidden states")
    eval_err = (h_flash - h_dense).abs().max().item()
    if not eval_err <= LOGITS_TOL * max(1.0, h_dense.abs().max().item()):
        raise AssertionError(f"ernie eval forward: flash vs dense hidden states {eval_err}")
    del model, h_flash, h_dense, pooled
    emit(phase="ernie", run="eval_f32_no_mask", batch=list(ids.shape),
         flash_fwd_launches_by_route=eval_routes[0], flash_vs_dense_max_abs_err=eval_err,
         tol=LOGITS_TOL)
    vs_cpu = _ernie_vs_cpu()
    world = torch.cuda.device_count()
    if world >= 2:
        gc.collect()
        torch.cuda.empty_cache()
        ref_model = ErnieForPretraining(ernie_base(dropout=0.0, attention_dropout=0.0), seed=0)
        ref, _ = _ernie_steps(_ernie_engine(ref_model), (ids, labels, types, None, nsp),
                              MULTI_CARD_STEPS)
        del ref_model
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as d:
            spawn(ernie_worker, args=(d,), nprocs=world, timeout=MULTI_CARD_TIMEOUT_S)
            ranks = [json.load(open(os.path.join(d, f"rank{r}.json"))) for r in range(world)]
        losses = ranks[0]["losses"]
        first = abs(losses[0] - ref[0]) / abs(ref[0])
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        share = max(r["opt_elems_held"] for r in ranks) / ranks[0]["opt_elems_replicated"]
        if not (first <= MULTI_CARD_FIRST_RTOL and rel <= MULTI_CARD_RTOL
                and share <= 1.0 / world + 0.01):
            raise AssertionError(f"ernie sharding {world}: losses {losses} against one "
                                 f"card's {ref} (relative {rel}); optimizer state share "
                                 f"{share}")
        med = statistics.median(ranks[0]["step_ms"][1:])
        emit(phase="ernie", run=f"sharding{world}_f32", world=world, losses=losses,
             one_card_losses=ref, first_rel_err=first, rel_err=rel,
             rtol=[MULTI_CARD_FIRST_RTOL, MULTI_CARD_RTOL], opt_state_share=share,
             step_ms=ranks[0]["step_ms"], step_ms_median=med,
             tokens_per_s=ids.numel() / (med / 1e3),
             peak_bytes_per_rank=[r["peak_bytes"] for r in ranks])
    for rec in (dense, flash):
        print(f"ernie: ernie-3.0-base {rec['run']} {rec['tokens_per_s']:.0f} tokens/s, "
              f"{rec['step_ms_median']:.2f} ms a step, peak "
              f"{rec['max_memory_allocated_bytes'] / 2**30:.2f} GiB ({card})", flush=True)
    emit(phase="ernie", what="checks", passed=True, vs_cpu_worst=vs_cpu["grad_worst_rel_err"],
         seconds=time.perf_counter() - t0)
    return {"bf16": {k: flash_launches[k] + dense_launches[k] for k in flash_launches},
            "f32": eval_launches}


MNIST_SIZE = 512          # mnist: the example's training samples, batch 64, 3 epochs
MNIST_EPOCHS = 3
MNIST_WORKERS = 2         # ... the DataLoader's worker threads
MNIST_CPU_RTOL = 1e-4     # ... each epoch's mean loss on the card against the CPU's
MNIST_FALL = 0.7          # ... the last epoch's mean loss below this share of the first's
                          # (tests/test_mnist_e2e.py's bar)
MNIST_MIN_ACC = 0.2       # ... evaluate's accuracy on mode="test" (the same test's bar)
RESUME_BATCH = (16, 3, 32, 32)   # the resume check's ResNet-18 batch, 10 classes
RESUME_STEPS = (3, 2)     # ... steps before the save, and after it in both runs


def _mnist_loader(device, workers=MNIST_WORKERS):
    """The example's loader on ``device``: MNIST (train, MNIST_SIZE) in
    batches of 64 from a DistributedBatchSampler (1 rank, shuffled, seeded
    by the epoch), MNIST_WORKERS worker threads."""
    from paddle_tpu_torch.examples import train_mnist_dygraph as ex
    from paddle_tpu_torch.io import DistributedBatchSampler
    from paddle_tpu_torch.vision.datasets import MNIST

    ds = MNIST(mode="train", size=MNIST_SIZE)
    sampler = DistributedBatchSampler(ds, ex.BATCH, num_replicas=1, rank=0, shuffle=True)
    return ex.make_loader(ds, device, sampler, num_workers=workers)


def _fit_callbacks(sampler):
    """(a callback that seeds ``sampler`` by the epoch, as the example's loop
    does (fit does not call set_epoch, in either package), and one that
    keeps every train batch's (loss, reader_cost))."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class SetEpoch(Callback):
        def on_epoch_begin(self, epoch, logs=None):
            sampler.set_epoch(epoch)

    class Logs(Callback):
        def __init__(self):
            super().__init__()
            self.rows = []

        def on_train_batch_end(self, step, logs=None):
            self.rows.append((logs["loss"], logs["reader_cost"]))

    return SetEpoch(), Logs()


def _mnist_resume():
    """ResNet-18 (10 classes, seed 0) through TrainStepEngine(Momentum(0.01),
    loss_fn=CrossEntropyLoss()) on the card: RESUME_STEPS[0] steps, a
    blocking save, RESUME_STEPS[1] more; a fresh engine (seed 1) restores
    and takes the same steps. Its losses, buffers and eval logits must be
    the uninterrupted run's bit for bit."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.distributed.elastic import CheckpointManager
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18

    x, y = _image_batch(RESUME_BATCH[0], RESUME_BATCH[2], 10, seed=3)

    def engine(seed):
        m = resnet18(num_classes=10, seed=seed)
        return TrainStepEngine(m, Momentum(0.01, parameters=m.named_parameters()),
                               loss_fn=nn.CrossEntropyLoss())

    def outcome(eng):
        losses = [eng.step(x, y).item() for _ in range(RESUME_STEPS[1])]
        eng.model.eval()
        with torch.no_grad():
            logits = eng.model(x)
        eng.model.train()
        return losses, {n: t.clone() for n, t in eng.model.named_buffers()}, logits

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_save=False)
        eng = engine(0)
        for _ in range(RESUME_STEPS[0]):
            eng.step(x, y)
        mgr.save(eng, block=True)
        want = outcome(eng)
        fresh = engine(1)
        mgr.restore(fresh)
        got = outcome(fresh)
        mgr.close()
    same_bufs = got[1].keys() == want[1].keys() and all(
        torch.equal(got[1][n], t) for n, t in want[1].items())
    if not (got[0] == want[0] and same_bufs and torch.equal(got[2], want[2])):
        raise AssertionError(f"mnist resume: resumed losses {got[0]} vs {want[0]}, buffers "
                             f"equal {same_bufs}, eval logits equal "
                             f"{torch.equal(got[2], want[2])}")
    if not any(n.endswith("._mean") and bool(t.abs().max() > 0) for n, t in want[1].items()):
        raise AssertionError("mnist resume: no running mean moved from its start")
    return dict(losses=want[0], buffers=len(want[1]), batch=list(RESUME_BATCH),
                steps=list(RESUME_STEPS), bit_equal=True)


def phase_mnist():
    """BASELINE config 1 on the port (phase docstring item 13)."""
    from paddle_tpu_torch import load, nn, save
    from paddle_tpu_torch.bench import card_name_and_power_limit
    from paddle_tpu_torch.examples import train_mnist_dygraph as ex
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    t0 = time.perf_counter()
    card = card_name_and_power_limit()
    images = MNIST_SIZE * MNIST_EPOCHS
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # cuDNN's backward the same bits each run
    try:
        # one untimed epoch first: CUDA's and cuDNN's set-up stay out of the
        # timed loop
        ex.train(LeNet(seed=0), _mnist_loader("cuda"), 1)
        # 1. the example's loop on the card and on the CPU: the same weights
        #    and batches
        runs = {}
        for device in ("cuda", "cpu"):
            model = LeNet(seed=0, device=device)
            loader = _mnist_loader(device)
            batch_losses = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            means = ex.train(model, loader, MNIST_EPOCHS, batch_losses)
            torch.cuda.synchronize()
            runs[device] = dict(model=model, means=means, batch_losses=batch_losses,
                                s=time.perf_counter() - t)
        gpu, cpu = runs["cuda"], runs["cpu"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(gpu["means"], cpu["means"]))
        if not rel <= MNIST_CPU_RTOL:
            raise AssertionError(f"mnist loop: card epochs {gpu['means']} vs CPU "
                                 f"{cpu['means']} (relative {rel})")
        if not gpu["means"][-1] < MNIST_FALL * gpu["means"][0]:
            raise AssertionError(f"mnist loop: the loss did not fall to {MNIST_FALL}x: "
                                 f"{gpu['means']}")
        loop_ips = images / gpu["s"]
        emit(phase="mnist", run="loop", model="lenet", size=MNIST_SIZE, batch=ex.BATCH,
             epochs=MNIST_EPOCHS, num_workers=MNIST_WORKERS, epoch_losses=gpu["means"],
             cpu_epoch_losses=cpu["means"], rel_err=rel, rtol=MNIST_CPU_RTOL,
             seconds=gpu["s"], cpu_seconds=cpu["s"], images_per_s=loop_ips, card=card)

        # 2. Model.fit with Accuracy() on the same batches from the same
        #    weights: the loop's losses, bit for bit
        model = LeNet(seed=0)
        loader = _mnist_loader("cuda")
        fit = Model(model).prepare(Adam(learning_rate=ex.LR, parameters=model.named_parameters()),
                                   nn.CrossEntropyLoss(), Accuracy())
        set_epoch, logs = _fit_callbacks(loader.batch_sampler)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fit.fit(loader, epochs=MNIST_EPOCHS, verbose=0, callbacks=[set_epoch, logs])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        fit_losses = [r[0] for r in logs.rows]
        if fit_losses != gpu["batch_losses"]:
            worst = max(abs(a - b) / abs(b) for a, b in zip(fit_losses, gpu["batch_losses"]))
            raise AssertionError(f"mnist fit: {len(fit_losses)} losses against the loop's "
                                 f"{len(gpu['batch_losses'])}, relative {worst} at most")
        ev = fit.evaluate(MNIST(mode="test", size=MNIST_SIZE), batch_size=ex.BATCH, verbose=0)
        if not ev["acc"] > MNIST_MIN_ACC:
            raise AssertionError(f"mnist evaluate: accuracy {ev['acc']}")
        reader_s = sum(r[1] for r in logs.rows)
        emit(phase="mnist", run="fit", metrics=["acc"], losses_equal_loop=True,
             eval_loss=ev["loss"], eval_acc=ev["acc"], seconds=fit_s,
             images_per_s=images / fit_s, reader_cost_s=reader_s,
             reader_cost_share=reader_s / fit_s, card=card)

        # fit(accumulate_grad_batches=2) without metrics: the engine route
        model = LeNet(seed=0)
        loader = _mnist_loader("cuda")
        acc = Model(model).prepare(Adam(learning_rate=ex.LR, parameters=model.named_parameters()),
                                   nn.CrossEntropyLoss())
        set_epoch, logs = _fit_callbacks(loader.batch_sampler)
        acc.fit(loader, epochs=MNIST_EPOCHS, verbose=0, accumulate_grad_batches=2,
                callbacks=[set_epoch, logs])
        if acc._engine is None:
            raise AssertionError("mnist fit(accumulate_grad_batches=2) took the eager route")
        acc_losses = [r[0] for r in logs.rows]
        per_epoch = len(acc_losses) // MNIST_EPOCHS
        _falls("mnist fit accumulate 2", [float(np.mean(acc_losses[:per_epoch])),
                                         float(np.mean(acc_losses[-per_epoch:]))])
        emit(phase="mnist", run="fit_accumulate_2", route="engine", losses=acc_losses)

        # 3. save / load: the reloaded LeNet's logits bit-equal to the trained one's
        test = MNIST(mode="test", size=MNIST_SIZE)
        batch = torch.from_numpy(np.stack([test[i][0] for i in range(ex.BATCH)])).cuda()
        trained = gpu["model"].eval()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "lenet.pdparams")
            save(trained.state_dict(), path)
            reloaded = LeNet(seed=1)
            reloaded.load_state_dict(load(path))
        with torch.no_grad():
            if not torch.equal(reloaded.eval()(batch), trained(batch)):
                raise AssertionError("mnist save/load: the reloaded logits differ")
        emit(phase="mnist", run="save_load", logits_bit_equal=True)

        # the device's busy share over one epoch of the loop
        model, loader = LeNet(seed=0), _mnist_loader("cuda")
        wall, kernel_ms, top = device_profile(lambda: ex.train(model, loader, 1), top=5)
        emit(phase="mnist", run="profile", epoch_wall_ms=wall, kernel_ms=kernel_ms,
             device_busy_share=kernel_ms / wall, top_kernels=top, card=card)

        # 4. the repaired resume: a ResNet-18's buffers survive a checkpoint
        emit(phase="mnist", run="resume", model="resnet18", **_mnist_resume())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    seconds = time.perf_counter() - t0
    print(f"mnist: lenet loop {loop_ips:.0f} images/s, fit {images / fit_s:.0f} images/s, "
          f"reader_cost {reader_s / fit_s:.4f} of fit, device busy {kernel_ms / wall:.4f} "
          f"of an epoch, {seconds:.1f} s ({card})", flush=True)
    emit(phase="mnist", what="checks", passed=True, seconds=seconds, card=card)


REC_CHECK_STEPS = 10      # rec: Wide&Deep's first steps held against the CPU's
REC_CPU_RTOL = 1e-4       # ... each of their losses on the card against the CPU's
REC_SAMPLE = 4096         # ... pulled ids whose rows of both tables are compared after them
REC_ROWS_ATOL = 1e-7      # ... each row entry, absolute
REC_ROWS_MIN_MOVE = 1e-6  # ... the CPU run's largest move of a sampled row over the steps, each
REC_ROWS_MOVED_SHARE = 0.99  # table, and its share of rows moved past REC_ROWS_ATOL, at least
REC_PROFILE_STEPS = 5     # ... steps in the profiled window (the device's busy share)
DEEPFM_STEPS = 5          # DeepFM with the [1e6, 8] table on the card, each step's
DEEPFM_CPU_RTOL = 1e-4    # ... loss against the CPU's
REC_POD_TIMEOUT_S = 240   # the launcher's 2-server, 2-trainer pod


def _rec_deepfm(device):
    """DeepFM at the widedeep leg's widths with trainer-side tables (a [1e6,
    8] and a [1e6, 1] Embedding on ``device``), Adam(1e-3), DEEPFM_STEPS
    steps of the leg's batches: (losses, seconds of the steps after the
    first)."""
    from paddle_tpu_torch.models import DeepFM, ctr_loss
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.tools.northstar_bench import WIDEDEEP as W

    net = DeepFM(sparse_feature_dim=W["vocab"], embedding_dim=W["embedding_dim"],
                 num_fields=W["fields"], dense_dim=W["dense_dim"], device=device, seed=0)
    opt = Adam(learning_rate=W["lr"], parameters=net.named_parameters())
    rs = np.random.RandomState(0)
    losses = []
    for step in range(DEEPFM_STEPS):
        if step == 1:
            torch.cuda.synchronize()
            t = time.perf_counter()
        ids = rs.randint(0, W["vocab"], (W["batch"], W["fields"])).astype(np.int64)
        dense = rs.rand(W["batch"], W["dense_dim"]).astype(np.float32)
        lab = rs.randint(0, 2, (W["batch"], 1)).astype(np.int64)
        loss = ctr_loss(net(torch.from_numpy(ids).to(device),
                            torch.from_numpy(dense).to(device)),
                        torch.from_numpy(lab).to(device))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses, time.perf_counter() - t


def _rec_pod():
    """The launcher's PS mode: 2 servers and 2 trainers of the port's
    Wide&Deep example, both trainers on card 0, trainer 0 saving the tables,
    in a temporary directory, within REC_POD_TIMEOUT_S; every process it
    started is ended and the directory removed after. Checks exit 0, finite
    losses of both trainers, and that each server's saved tables hold
    exactly the ids of the trainers' batches with id % 2 equal to its index.
    Returns (seconds, {trainer: losses}, {server: {table: ids held}})."""
    import shutil

    from paddle_tpu_torch.examples import train_widedeep_ps as ex

    root = os.path.dirname(os.path.abspath(__file__))
    d = tempfile.mkdtemp(prefix="rec_pod_")
    log_dir, save = os.path.join(d, "log"), os.path.join(d, "tables", "wd")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", "--run_mode", "ps",
           "--server_num", "2", "--trainer_num", "2", "--devices", "0", "--log_dir", log_dir,
           os.path.join(root, "paddle_tpu_torch", "examples", "train_widedeep_ps.py"),
           "--save", save]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, start_new_session=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=REC_POD_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"rec pod: the launcher exited {proc.returncode}:\n"
                                 f"{out[-4000:]}")
        losses = {}
        for r in range(2):
            with open(os.path.join(log_dir, f"trainer.{r}")) as f:
                last = [ln for ln in f.read().splitlines() if ln.startswith("LOSSES ")]
            losses[r] = json.loads(last[-1][len("LOSSES "):]) if last else []
            if len(losses[r]) != ex.STEPS or not all(math.isfinite(x) for x in losses[r]):
                raise AssertionError(f"rec pod: trainer {r} losses {losses[r]}")
        used = np.unique(np.concatenate([ex.batch(r)[0].reshape(-1) for r in range(2)]))
        held = {}
        for s in range(2):
            held[s] = {}
            for t_cfg in ex.TABLES:
                rec = np.dtype([("id", "<u8"), ("row", "<f4", (t_cfg.dim,))])
                ids = np.fromfile(f"{save}.part{s}.sparse.{t_cfg.table_id}", dtype=rec)["id"]
                want = used[used % 2 == s].astype(np.uint64)
                if not np.array_equal(np.sort(ids), want):
                    raise AssertionError(f"rec pod: server {s} table {t_cfg.table_id} holds "
                                         f"{ids.size} ids, {int((ids % 2 != s).sum())} not "
                                         f"its own; {want.size} expected")
                held[s][t_cfg.table_id] = int(ids.size)
        return seconds, losses, held
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(d, ignore_errors=True)


def _rec_initial_rows(ids, dims):
    """The rows ``ids`` hold before any push: a fresh server's pull (the
    table draws each id's first row from the id alone). ``dims``: {table id:
    row width}. Returns {table id: [len(ids), width] numpy}."""
    from paddle_tpu_torch.distributed.ps import PSClient, PSServer, SparseTableConfig

    server = PSServer(0, [SparseTableConfig(table_id=t, dim=d) for t, d in dims.items()], [])
    client = PSClient([f"127.0.0.1:{server.port}"])
    try:
        for t, d in dims.items():
            client.register_table_dim(t, d)
        return {t: client.pull_sparse(t, ids) for t in dims}
    finally:
        client.close()
        server.stop()


def phase_rec():
    """BASELINE config 5 on the port (phase docstring item 14)."""
    from paddle_tpu_torch.bench import card_name_and_power_limit
    from paddle_tpu_torch.tools.northstar_bench import bench_widedeep

    t0 = time.perf_counter()
    card = card_name_and_power_limit()

    # 1. Wide&Deep at full width, both tables on a live PSServer: the card's
    #    run against the CPU's (each on a fresh server, from the same rows)
    def profile(step):
        wall, kernel_ms, top = device_profile(
            lambda: [step() for _ in range(REC_PROFILE_STEPS)], top=5)
        return dict(steps=REC_PROFILE_STEPS, wall_ms=wall, kernel_ms=kernel_ms,
                    device_busy_share=kernel_ms / wall, top_kernels=top)

    gpu = bench_widedeep(False, "cuda", check_steps=REC_CHECK_STEPS, sample=REC_SAMPLE,
                         profile=profile)
    cpu = bench_widedeep(False, "cpu", steps=REC_CHECK_STEPS - gpu["warmup"],
                         check_steps=REC_CHECK_STEPS, sample=REC_SAMPLE)
    rel = max(abs(a - b) / abs(b) for a, b in zip(gpu["losses"][:REC_CHECK_STEPS],
                                                 cpu["losses"][:REC_CHECK_STEPS]))
    if not rel <= REC_CPU_RTOL:
        raise AssertionError(f"rec widedeep: card losses {gpu['losses'][:REC_CHECK_STEPS]} "
                             f"vs CPU {cpu['losses']} (relative {rel})")
    if not np.array_equal(gpu["sample_ids"], cpu["sample_ids"]):
        raise AssertionError("rec widedeep: the card's and the CPU's runs pulled other ids")
    row_err = {t: float(np.abs(gpu["sample_rows"][t] - cpu["sample_rows"][t]).max())
               for t in gpu["sample_rows"]}
    if not max(row_err.values()) <= REC_ROWS_ATOL:
        raise AssertionError(f"rec widedeep: table rows off the CPU's by {row_err}")
    # how far the CPU run's pushes moved the sampled rows (each row: its
    # largest entry's move): a push the card missed would show past the limit
    first = _rec_initial_rows(cpu["sample_ids"], {t: r.shape[1]
                                                  for t, r in cpu["sample_rows"].items()})
    moved = {t: np.abs(cpu["sample_rows"][t] - first[t]).max(1) for t in first}
    move = {t: {"max": float(m.max()), "median": float(np.median(m)),
                "share_past_atol": float((m > REC_ROWS_ATOL).mean())} for t, m in moved.items()}
    for t, m in move.items():
        if not (m["max"] >= REC_ROWS_MIN_MOVE and m["share_past_atol"] >= REC_ROWS_MOVED_SHARE):
            raise AssertionError(f"rec widedeep: table {t}'s sampled rows moved {m} over "
                                 f"{REC_CHECK_STEPS} steps: too little for REC_ROWS_ATOL "
                                 f"{REC_ROWS_ATOL} to show a missed push")
    prof = gpu["profile"]
    emit(phase="rec", run="widedeep", **{k: v for k, v in gpu.items()
                                          if k not in ("sample_ids", "sample_rows", "profile")},
         cpu_losses=cpu["losses"], cpu_step_ms=cpu["step_ms"],
         cpu_pull_sparse_share=cpu["pull_sparse_share"],
         cpu_push_sparse_share=cpu["push_sparse_share"], loss_rel_err=rel, rtol=REC_CPU_RTOL,
         rows_max_abs_err=row_err, rows_atol=REC_ROWS_ATOL, rows_moved=move,
         sample_ids=REC_SAMPLE, profile=prof)

    # 2. DeepFM with trainer-side tables on the card, against the CPU
    fm_gpu, fm_s = _rec_deepfm(torch.device("cuda"))
    fm_cpu, _ = _rec_deepfm(torch.device("cpu"))
    fm_rel = max(abs(a - b) / abs(b) for a, b in zip(fm_gpu, fm_cpu))
    if not fm_rel <= DEEPFM_CPU_RTOL:
        raise AssertionError(f"rec deepfm: card losses {fm_gpu} vs CPU {fm_cpu} "
                             f"(relative {fm_rel})")
    fm_eps = (DEEPFM_STEPS - 1) * gpu["batch"] / fm_s
    emit(phase="rec", run="deepfm", use_ps=False, steps=DEEPFM_STEPS, losses=fm_gpu,
         cpu_losses=fm_cpu, loss_rel_err=fm_rel, rtol=DEEPFM_CPU_RTOL,
         examples_per_s=fm_eps, timed_steps=DEEPFM_STEPS - 1, card=card)
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the launcher's PS mode: 2 servers, 2 trainers on this card
    pod_s, pod_losses, held = _rec_pod()
    emit(phase="rec", run="pod", servers=2, trainers=2, seconds=pod_s, losses=pod_losses,
         ids_held=held, own_ids_only=True, card=card)
    seconds = time.perf_counter() - t0
    print(f"rec: widedeep {gpu['value']:.0f} examples/s (pull {gpu['pull_sparse_share']:.3f}, "
          f"push {gpu['push_sparse_share']:.3f} of a step, device busy "
          f"{prof['device_busy_share']:.4f}), deepfm {fm_eps:.0f} examples/s, pod "
          f"{pod_s:.1f} s, {seconds:.1f} s ({card})", flush=True)
    emit(phase="rec", what="checks", passed=True, seconds=seconds, card=card)


def _route_counts():
    """The flash kernels' launches by route: (forward, backward pair)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return dict(fa.launches_by_route), _bwd_routes()


def _check_mma_launches(what, fwd, bwd, n_fwd, n_bwd):
    """Every launch on the bf16 tensor cores: n_fwd forwards and n_bwd of
    each backward kernel, none on another route."""
    _check_route_launches(what, fwd, bwd, n_fwd, n_bwd, "mma")


def _check_route_launches(what, fwd, bwd, n_fwd, n_bwd, route):
    """Every launch on ``route``: n_fwd forwards and n_bwd of each backward
    kernel, none on another route."""
    routes = ("mma", "tf32x3", "fma")
    want = ({r: n_fwd if r == route else 0 for r in routes},
            {r: {"dkdv": n_bwd if r == route else 0, "dq": n_bwd if r == route else 0}
             for r in routes})
    if (fwd, bwd) != want:
        raise AssertionError(f"{what}: the flash kernels took {fwd} and {bwd}, "
                             f"expected {want}")


def _bench_run(what, cfg, batch, seq, steps, warmup, per_step_fwd, per_step_bwd,
               falls=True, **kw):
    """One run of the port's bench (paddle_tpu_torch.bench.run) on the card,
    with the flash kernels' counts set to 0 just before it and read just
    after: every step (warm-up included) launches per_step_fwd forwards and
    per_step_bwd of each backward kernel on the bf16 tensor cores. The loss
    is finite and, where ``falls``, lower after the run than at its first
    step. Emits the bench line with the launches; returns (payload,
    forward launches, backward launches of each kernel)."""
    from paddle_tpu_torch import bench

    gc.collect()
    torch.cuda.empty_cache()
    _reset_launch_counts()
    row = bench.run(cfg, batch, seq, steps, warmup, device="cuda", **kw)
    torch.cuda.synchronize()
    fwd, bwd = _route_counts()
    n = steps + warmup
    _check_mma_launches(what, fwd, bwd, n * per_step_fwd, n * per_step_bwd)
    ex = row["extra"]
    first, final = ex["first_loss"], ex["final_loss"]
    if not (math.isfinite(first) and math.isfinite(final)):
        raise AssertionError(f"{what}: non-finite loss {first}, {final}")
    if falls and not final < first:
        raise AssertionError(f"{what}: the loss did not fall ({first} -> {final})")
    emit(phase="bench", case=what, tokens_per_s=row["value"], **ex,
         launches_per_step={"flash_attention_fwd": per_step_fwd,
                            "flash_attention_bwd_dkdv": per_step_bwd,
                            "flash_attention_bwd_dq": per_step_bwd})
    return row, fwd["mma"], bwd["mma"]["dkdv"]


def phase_bench():
    """The port's bench.py counterpart (``paddle_tpu_torch.bench.run``) in this
    process, on the paths of bench.py's knobs, all under bf16 auto_cast:

    - medium (gpt_345m, [8, 1024]): bench.py's 2 warm-up and 10 timed steps
      in 3 windows; tokens/s a window, spread, MFU, peak memory; 24 launches
      a step of the flash forward and of each backward kernel; then one
      profiled step of the same model after 6 (profile train_step_medium);
    - base ([8, 1024], 1 + 4 steps) with 4 in-program microbatches against
      1: 4 x 12 launches of each kernel a step; the peak memory must be
      lower at K = 4;
    - medium (1 + 3 steps) with full and with selective recompute: 48
      forwards a step (24 and their replay) and 24 of each backward kernel;
      the peak memory under full must be lower than the medium run's
      without recompute (selective's is reported);
    - gpt_1p3b ([4, 2048], head dim 128), full recompute, 1 + 2 steps: 48
      forwards and 24 of each backward kernel a step at d = 128, a finite
      loss, peak memory;
    - decode at base: greedy ``generate`` of 64 tokens after a 128-token
      prompt for 8 rows (a warm-up call, then a timed one: decode tokens/s).
      Slot independence: the rows in reversed slots give the same bf16
      tokens, and rows 0 and 5 alone give the batch's tokens at f32 (at
      bf16 a batch of one takes other GEMM kernels, whose rounding can
      break a tie of the bf16 logits: how many tokens agree is reported).

    Every loss is finite, and falls except in the 3 steps of gpt_1p3b.
    Returns the gpt_1p3b run's launches {kernel: n}."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import GPTForPretraining
    from paddle_tpu_torch.tools import bench_gpt_1p3b

    med_cfg, batch, seq, steps, warmup = bench.bench_config("medium")
    nl = med_cfg.num_layers
    medium, _, _ = _bench_run("medium", med_cfg, batch, seq, steps, warmup, nl, nl)
    peak_none = medium["extra"]["max_memory_allocated_bytes"]

    # one profiled medium step (where the time goes)
    gc.collect()
    torch.cuda.empty_cache()
    model, engine = _train_engine(med_cfg, "cuda")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, med_cfg.vocab_size, (batch, seq)).astype(np.int64)).cuda()
    labels = torch.roll(ids, -1, 1)
    with auto_cast(dtype="bfloat16"):
        _, step_ms = _steps(engine, ids, labels, 6)
        wall, kernel_ms, top = device_profile(lambda: engine.step(ids, labels), top=12)
    untraced = statistics.median(step_ms[3:])
    emit(phase="profile", what="train_step_medium", batch=[batch, seq],
         wall_ms_untraced=untraced, wall_ms_traced=wall, kernel_ms=kernel_ms,
         device_busy_share=kernel_ms / untraced, top_kernels=top)
    del model, engine, ids, labels

    base_cfg = bench.bench_config("base")[0]
    peaks = {}
    for k in (1, 4):
        row, _, _ = _bench_run(f"base_accum{k}", base_cfg, 8, 1024, 4, 1,
                               k * base_cfg.num_layers, k * base_cfg.num_layers,
                               accum=k)
        peaks[k] = row["extra"]["max_memory_allocated_bytes"]
    if not peaks[4] < peaks[1]:
        raise AssertionError(f"peak memory at 4 microbatches {peaks[4]} is not below "
                             f"the plain step's {peaks[1]}")

    for rc in ("full", "selective"):
        row, _, _ = _bench_run(f"medium_recompute_{rc}", med_cfg, batch, seq, 3, 1,
                               2 * nl, nl, recompute=rc)
        peaks[rc] = row["extra"]["max_memory_allocated_bytes"]
    if not peaks["full"] < peak_none:
        raise AssertionError(f"peak memory under full recompute {peaks['full']} is not "
                             f"below the step's without it {peak_none}")

    big, b, seq, steps, warmup, kw = bench_gpt_1p3b.case(4)
    if big.hidden_size // big.num_heads != 128:
        raise AssertionError("gpt_1p3b's head dim is not 128")
    _, n_fwd, n_bwd = _bench_run("gpt_1p3b_recompute_full", big, b, seq, steps, warmup,
                                 2 * big.num_layers, big.num_layers, falls=False, **kw)
    emit(phase="bench_memory", model_medium_none=peak_none,
         medium_recompute_full=peaks["full"], medium_recompute_selective=peaks["selective"],
         base_microbatches_1=peaks[1], base_microbatches_4=peaks[4],
         unit="bytes, torch.cuda.max_memory_allocated")

    # decode: bench.py's greedy generate at base, 8 rows
    gc.collect()
    torch.cuda.empty_cache()
    dm = GPTForPretraining(base_cfg, seed=0).eval()
    prompt = torch.from_numpy(np.random.RandomState(1).randint(
        0, base_cfg.vocab_size, (8, 128)).astype(np.int64)).cuda()

    def greedy(ids):
        return dm.generate(ids, max_new_tokens=64, temperature=0)

    with auto_cast(dtype="bfloat16"):
        greedy(prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = greedy(prompt)
        int(out[0, -1])
        decode_s = time.perf_counter() - t0
        flipped = greedy(prompt.flip(0)).flip(0)
        alone = {i: greedy(prompt[i:i + 1])[0] for i in (0, 5)}
    if tuple(out.shape) != (8, 192) or not bool(((out >= 0) & (out < base_cfg.vocab_size)).all()):
        raise AssertionError(f"generate gave {tuple(out.shape)} or ids out of the vocabulary")
    # slot independence: in the same batch shape every row gives the same
    # tokens in another slot beside other neighbours (bf16, exactly) ...
    if not torch.equal(flipped, out):
        raise AssertionError("bf16 greedy tokens changed with the rows' slots")
    # ... and a row alone gives the batch's tokens at f32; at bf16 a batch of
    # one takes other GEMM kernels, whose rounding can break a tie of the
    # bf16 logits (one ulp is 2^-6 at their ~2.3), so it is reported
    f32_out = greedy(prompt)
    for i in (0, 5):
        if not torch.equal(greedy(prompt[i:i + 1])[0], f32_out[i]):
            raise AssertionError(f"f32: row {i} alone gave other greedy tokens than in "
                                 f"the batch of 8")
    same_prefix = {i: int((a != out[i]).nonzero()[0]) - 128 if bool((a != out[i]).any())
                   else 64 for i, a in alone.items()}
    emit(phase="bench_decode", model="gpt2-124m", amp="bfloat16 O1", batch=8,
         prompt=128, new_tokens=64, seconds=decode_s,
         decode_tokens_per_s=8 * 64 / decode_s, slots_flipped_equal=True,
         f32_rows_alone_equal=[0, 5], bf16_alone_tokens_equal_before_divergence=same_prefix)
    del dm
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_fwd_d128": n_fwd, "flash_attention_bwd_dkdv_d128": n_bwd,
            "flash_attention_bwd_dq_d128": n_bwd}


def _close_or_raise(what, got, want, dtype, grad=False, tol=None):
    """max |got - want| and its tolerance: ``tol`` where given, else f32
    F32_TOL (times max(1, max|ref|) for gradients), bf16 BF16_TOL x max|ref|,
    an f32 gradient of bf16 inputs DW_F32_TOL x max|ref|; raises past it."""
    scale = want.float().abs().max().item()
    if tol is None and dtype == torch.float32:
        tol = (GRAD_F32_TOL * max(1.0, scale)) if grad else F32_TOL
    elif tol is None:
        tol = (DW_F32_TOL if grad and got.dtype == torch.float32 else BF16_TOL) * scale
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: kernel vs plain error {err} (tol {tol})")
    return err, tol


def events_floor_ms():
    """``device_ms`` of one trivial launch (a one-element fill): the time
    the events' window adds to any call it measures."""
    t = torch.empty(1, device="cuda")
    return device_ms(t.zero_)


def phase_layer_norm_kernels(n=8192, widths=(768, 1024, 2048)):
    """The three LayerNorm kernels against their plain versions at [n, h]
    for the hidden widths of GPT-2 124M (its final LayerNorm, [8, 1024, 768]
    as [8192, 768]), gpt_345m and gpt_1p3b, f32 and bf16; torch's layer_norm
    (and its autograd backward) is the library yardstick. Kernel, plain and
    library times are device times with a cold L2 (``device_ms``), printed
    after the events' floor (``events_floor_ms``); ``bound_share`` is the
    bound over the kernel's time; ``wall_ms`` is the CUDA-event time of the
    wrapper's call in a loop, host time and a warm L2 included. Returns
    {(dtype, h): {kernel: record}}."""
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    emit(phase="events_floor", ms=events_floor_ms(),
         what="device_ms of a one-element fill")
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for h, dtype in ((h, d) for h in widths for d in (torch.float32, torch.bfloat16)):
        x = (torch.randn(n, h, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
        dy = torch.randn(n, h, device="cuda", generator=gen).to(dtype)
        g = 1 + 0.1 * torch.randn(h, device="cuda", generator=gen)
        b = 0.1 * torch.randn(h, device="cuda", generator=gen)
        oi = ln.layer_norm_fwd(x, g, b, stats=False)
        o, mu, rstd = ln.layer_norm_fwd(x, g, b, stats=True)
        dx, dg, db = ln.layer_norm_bwd(x, g, dy, mu, rstd)
        torch.cuda.synchronize()
        po, pmu, prstd = ln.layer_norm_fwd_plain(x, g, b)
        pdx, pdg, pdb = ln.layer_norm_bwd_plain(x, g, dy, pmu, prstd)
        name = f"layer_norm [{n}, {h}] {str(dtype)[6:]}"
        err_i, tol_o = _close_or_raise(f"{name} inference forward", oi, po, dtype)
        err_o, _ = _close_or_raise(f"{name} training forward", o, po, dtype)
        err_s = max(_close_or_raise(f"{name} mu", mu, pmu, torch.float32)[0],
                    _close_or_raise(f"{name} rstd", rstd, prstd, torch.float32, True)[0])
        err_dx, tol_dx = _close_or_raise(f"{name} dx", dx, pdx, dtype, grad=True)
        err_dgb = max(_close_or_raise(f"{name} {k}", got, ref, torch.float32, True)[0]
                      for k, got, ref in (("dg", dg, pdg), ("db", db, pdb)))
        again = ln.layer_norm_bwd(x, g, dy, mu, rstd)
        if not all(torch.equal(a, b) for a, b in zip((dx, dg, db), again)):
            raise AssertionError(f"{name}: two backward calls give other bits")
        del again

        gx, bx = g.to(dtype), b.to(dtype)       # torch's op takes one dtype
        xl = x.detach().clone().requires_grad_()
        gl, bl = gx.clone().requires_grad_(), bx.clone().requires_grad_()
        ol = torch.nn.functional.layer_norm(xl, (h,), gl, bl, 1e-5)
        with torch.no_grad():
            lib_fwd = device_ms(lambda: torch.nn.functional.layer_norm(x, (h,), gx, bx,
                                                                       1e-5))
        lib_bwd = device_ms(lambda: torch.autograd.grad(ol, (xl, gl, bl), dy,
                                                        retain_graph=True))
        esize = x.element_size()
        io = esize * n * h                          # one [n, h] tensor in x's dtype
        elems = n * h
        rows = {
            "layer_norm_infer": dict(
                fn=lambda: ln.layer_norm_fwd(x, g, b, stats=False), err=err_i, tol=tol_o,
                plain=lambda: ln.layer_norm_fwd_plain(x, g, b), library_ms=lib_fwd,
                flops=7 * elems, nbytes=2 * io + 8 * h),
            "layer_norm_fwd": dict(
                fn=lambda: ln.layer_norm_fwd(x, g, b, stats=True), err=max(err_o, err_s),
                tol=tol_o, plain=lambda: ln.layer_norm_fwd_plain(x, g, b),
                library_ms=lib_fwd, flops=7 * elems, nbytes=2 * io + 8 * h + 8 * n),
            "layer_norm_bwd": dict(
                fn=lambda: ln.layer_norm_bwd(x, g, dy, mu, rstd), err=max(err_dx, err_dgb),
                tol=tol_dx, plain=lambda: ln.layer_norm_bwd_plain(x, g, dy, mu, rstd),
                library_ms=lib_bwd, flops=13 * elems, nbytes=3 * io + 12 * h + 8 * n),
        }
        recs = {}
        for kernel, r in rows.items():
            bound_ms, bound_by = _bound(r["flops"], r["nbytes"], torch.float32)
            kernel_ms = device_ms(r["fn"])
            recs[kernel] = dict(
                case=f"ln_{h}_{str(dtype)[6:]}", shape=[n, h], dtype=str(dtype)[6:],
                max_abs_err=r["err"], tol=r["tol"], kernel_ms=kernel_ms,
                plain_ms=device_ms(r["plain"]), library_ms=r["library_ms"],
                bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / kernel_ms,
                wall_ms=cuda_ms(r["fn"], iters=50))
            emit(phase="kernel_vs_plain", kernel=kernel, **recs[kernel],
                 library="torch.nn.functional.layer_norm" + (
                     " autograd backward (dx, dg, db)" if kernel == "layer_norm_bwd" else ""))
        out[(dtype, h)] = recs
        del x, dy, oi, o, mu, rstd, dx, dg, db, po, pmu, prstd, pdx, pdg, pdb, xl, ol
    torch.cuda.empty_cache()
    return out


def phase_lm_loss_kernels(ids, vocab=50304, h=768):
    """The three LM-loss kernels against their plain versions at GPT-2 124M's
    LM head: h [8192, 768], W [vocab, 768], labels roll(ids, -1). Timed: bf16
    h with an f32 master W (the on-chip amp configuration; the tensor-core
    forward and backward, their time including W's bf16 copy, with the FMA
    kernels at the same inputs and the copy alone timed beside them) and f32
    (the 3xTF32 forward and backward, with the FMA kernels at the same
    inputs timed beside them), and f32 at gpt_345m's hidden 1024, h [8192,
    1024], W [50304, 1024] (the 3xTF32 forward, which streams the hidden dim
    and takes any H; the FMA backward, the route past H = 768); checked
    only: GPT-2's own vocabulary 50257 (a ragged last vocab tile) in f32 and
    at bf16 h with an f32 and a bf16 W, labels of -100 (their rows' loss is
    the logsumexp), and every label -100 (dh and dW the softmax term alone,
    so that max|ref| scales with it), each at bf16 h and at f32. Past the
    one-CTA tiles the backward splits the hidden dim across a thread-block
    cluster: timed at gpt_345m's f32 head (h1024_f32) and gpt_1p3b's bf16
    one, h [8192, 2048] bf16 with W [50304, 2048] f32
    (h2048_bf16_h_f32_w), checked at f32 H = 2048 (h2048_f32). Each timed
    record carries the launches of its checked call (``check_launches``)
    and the backward's plan (its cluster) and kernel instance; a cluster
    route slower than its FMA predecessor fails.
    The forward takes the bf16 tensor cores at bf16
    h, the 3xTF32 kernel at f32; its loss and lse are held at F32_TOL x
    max(1, max|ref|) at bf16 h (exact products summed in f32) and F32_TOL at
    f32. The f32 dh and dW are also held to GRAD_F32_FROB_TOL in relative
    Frobenius norm. Wherever a function takes a tensor-core route, its FMA
    kernel (the predecessor) is checked at the same inputs and limits. The
    library yardstick is cross_entropy(linear(h, W).float()) and its
    autograd backward (dh and dW together), timed like the plain version in
    true f32 (no TF32). The f32 rows' bounds count three TF32 products each
    (f32 accuracy), the FP32 units' bound beside them. Returns {case:
    {kernel: record}}."""
    from paddle_tpu_torch.ops.kernels import lm_loss as lm

    gen = torch.Generator(device="cuda").manual_seed(5)
    labels = torch.roll(ids, -1, 1).reshape(-1).to(torch.int32)
    n = labels.numel()
    w32 = torch.randn(vocab, h, device="cuda", generator=gen) * 0.02
    h32 = torch.randn(n, h, device="cuda", generator=gen)
    g = torch.ones(n, device="cuda")
    minus100 = labels.clone()
    minus100[::97] = -100
    all_minus100 = torch.full_like(labels, -100)
    w50257 = w32[:50257].contiguous()
    w1024 = torch.randn(vocab, 1024, device="cuda", generator=gen) * 0.02
    h1024 = torch.randn(n, 1024, device="cuda", generator=gen)
    w2048 = torch.randn(vocab, 2048, device="cuda", generator=gen) * 0.02
    h2048 = torch.randn(n, 2048, device="cuda", generator=gen)
    cases = [  # (name, h, W, labels, timed)
        ("bf16_h_f32_w", h32.bfloat16(), w32, labels, True),
        ("f32", h32, w32, labels, True),
        ("vocab50257_f32", h32, w50257, labels % 50257, False),
        ("label_minus100_f32", h32, w32, minus100, False),
        ("all_minus100_f32", h32, w32, all_minus100, False),
        ("vocab50257_bf16_h_f32_w", h32.bfloat16(), w50257, labels % 50257, False),
        ("label_minus100_bf16_h_f32_w", h32.bfloat16(), w32, minus100, False),
        ("all_minus100_bf16_h_f32_w", h32.bfloat16(), w32, all_minus100, False),
        ("vocab50257_bf16_h_bf16_w", h32.bfloat16(), w50257.bfloat16(), labels % 50257,
         False),
        ("h1024_f32", h1024, w1024, labels, True),
        ("h2048_bf16_h_f32_w", h2048.bfloat16(), w2048, labels, True),
        ("h2048_f32", h2048, w2048, labels, False),
    ]
    out = {}
    for name, hh, w, lab, timed in cases:
        dt = hh.dtype
        f32 = dt == torch.float32
        hid = hh.shape[1]
        plan = lm.backward_plan(dt, hid)
        route = plan.route
        fwd_route = lm.forward_route(dt)
        before = {k: dict(c) for k, c in lm.launches_by_route.items()}
        loss, lse = lm.lm_loss_fwd(hh, w, lab)
        dh = lm.lm_loss_dh(hh, w, lab, lse, g)
        dw = lm.lm_loss_dw(hh, w, lab, lse, g)
        torch.cuda.synchronize()
        moved = {r: {k: c[k] - before[r][k] for k in c}
                 for r, c in lm.launches_by_route.items()}
        want_moved = {r: {"fwd": int(r == fwd_route), "dh": int(r == route),
                          "dw": int(r == route)} for r in moved}
        if moved != want_moved:
            raise AssertionError(f"lm_loss {name}: took the routes {moved}, expected the "
                                 f"forward on {fwd_route} and the backward on {route}")
        ploss, plse = lm.lm_loss_fwd_plain(hh, w, lab)
        pdh, pdw = lm.lm_loss_bwd_plain(hh, w, lab, plse, g)
        if dw.shape != w.shape or dw.dtype != w.dtype or dh.dtype != dt:
            raise AssertionError(f"lm_loss {name}: dh {dh.dtype}, dw {tuple(dw.shape)} "
                                 f"{dw.dtype}")
        # loss and lse: f32 results of exact products (bf16 h) or f32 ones
        tol_f = _f32_tol(plse) if dt == torch.bfloat16 else F32_TOL

        def fwd_err(what, got):
            return max(_close_or_raise(f"lm_loss {name} {what} loss", got[0], ploss, dt,
                                       tol=tol_f)[0],
                       _close_or_raise(f"lm_loss {name} {what} lse", got[1], plse, dt,
                                       tol=tol_f)[0])

        def grad_err(what, got, ref):
            """max error and its limit, and at f32 the relative Frobenius
            error (GRAD_F32_FROB_TOL), of one gradient"""
            err, tol = _close_or_raise(f"lm_loss {name} {what}", got, ref, dt, grad=True)
            frob = _frob_or_raise(f"lm_loss {name} {what}", got, ref) if f32 else None
            return err, tol, frob

        err_f = fwd_err(fwd_route, (loss, lse))
        err_dh, tol_dh, frob_dh = grad_err("dh", dh, pdh)
        err_dw, tol_dw, frob_dw = grad_err("dw", dw, pdw)
        fma, fma_err, fma_frob = {}, {}, {}
        # the FMA kernels at the same inputs: the tensor-core kernels'
        # predecessors, held to the same limits
        if fwd_route != "fma":
            fma["lm_loss_fwd"] = lambda: lm.lm_loss_fwd(hh, w, lab, route="fma")
            fma_err["lm_loss_fwd"] = fwd_err("fma", fma["lm_loss_fwd"]())
        if route != "fma":
            fma["lm_loss_dh"] = lambda: lm._bwd_launch(hh, w, lab, lse, g, False, route="fma")
            fma["lm_loss_dw"] = lambda: lm._bwd_launch(hh, w, lab, lse, g, True, route="fma")
            for k, ref in (("lm_loss_dh", pdh), ("lm_loss_dw", pdw)):
                fma_err[k], _, fma_frob[k] = grad_err(f"{k} fma", fma[k](), ref)
        if "minus100" in name:
            ignored = lab == -100
            if not torch.equal(loss[ignored], lse[ignored]):
                raise AssertionError("a -100 label picked a logit")
        recs = {}
        if timed:
            # the plain version and the yardstick are true f32 products
            if (torch.backends.cuda.matmul.allow_tf32
                    or torch.get_float32_matmul_precision() != "highest"):
                raise AssertionError("f32 matmuls may take TF32: the plain version and the "
                                     "library yardstick must run in true f32")
            v, h = w.shape
            hl = hh.detach().clone().requires_grad_()
            wl = w.detach().clone().requires_grad_()
            labl = lab.long()

            def library_fwd():
                return torch.nn.functional.cross_entropy(
                    torch.nn.functional.linear(hl, wl.to(dt)).float(), labl,
                    reduction="none")

            lib_loss = library_fwd()
            with torch.no_grad():
                lib_fwd_ms = cuda_ms(library_fwd, iters=5)
            lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_loss, (hl, wl), g,
                                                             retain_graph=True), iters=5)
            plain_bwd_ms = cuda_ms(lambda: lm.lm_loss_bwd_plain(hh, w, lab, plse, g),
                                   iters=3)
            hb, wb = hh.element_size() * n * h, w.element_size() * v * h
            rows = {
                "lm_loss_fwd": (lambda: lm.lm_loss_fwd(hh, w, lab), err_f, tol_f, None,
                                cuda_ms(lambda: lm.lm_loss_fwd_plain(hh, w, lab), iters=3),
                                lib_fwd_ms, 2, hb + wb + 12 * n),
                "lm_loss_dh": (lambda: lm.lm_loss_dh(hh, w, lab, lse, g), err_dh, tol_dh,
                               frob_dh, plain_bwd_ms, lib_bwd_ms, 4, 2 * hb + wb + 12 * n),
                "lm_loss_dw": (lambda: lm.lm_loss_dw(hh, w, lab, lse, g), err_dw, tol_dw,
                               frob_dw, plain_bwd_ms, lib_bwd_ms, 4,
                               hb + wb + 4 * v * h + 12 * n),
            }
            bwd = {"kernel_route": route, "plan": plan._asdict(),
                   "instance": _lm_grad_instance(plan)}
            extra = {"lm_loss_fwd": {"kernel_route": fwd_route},
                     "lm_loss_dh": dict(bwd), "lm_loss_dw": dict(bwd)}
            if fma:
                # the FMA kernels timed beside the tensor-core ones, and the W
                # cast that the bf16 tensor-core calls include
                cast_ms = (cuda_ms(lambda: w.to(torch.bfloat16), iters=20)
                           if fwd_route == "mma" and w.dtype != torch.bfloat16 else 0.0)
                for kernel, fn in fma.items():
                    extra[kernel].update(
                        w_cast_ms=cast_ms, fma_max_abs_err=fma_err[kernel],
                        fma_kernel_ms=cuda_ms(fn, iters=3, warmup=1),
                        **({"fma_rel_frob": fma_frob[kernel]} if kernel in fma_frob
                           else {}))
            for kernel, (fn, err, tol, frob, plain_ms, lib_ms, products,
                         nbytes) in rows.items():
                flops = products * n * v * h
                bound_ms, bound_by = _bound(flops, nbytes, dt)
                if extra[kernel]["kernel_route"] == "tf32x3":
                    # f32 accuracy on the tensor cores: three TF32 products
                    extra[kernel]["fp32_bound_ms"] = bound_ms
                    bound_ms, bound_by = _bound(3 * flops, nbytes, "tf32")
                if frob is not None:
                    extra[kernel].update(rel_frob=frob, frob_tol=GRAD_F32_FROB_TOL)
                kernel_ms = cuda_ms(fn, iters=5, warmup=1)
                if (kernel != "lm_loss_fwd" and plan.cluster > 1
                        and not kernel_ms < extra[kernel]["fma_kernel_ms"]):
                    raise AssertionError(f"lm_loss {name} {kernel}: the cluster route took "
                                         f"{kernel_ms} ms, its FMA predecessor "
                                         f"{extra[kernel]['fma_kernel_ms']} ms")
                recs[kernel] = dict(
                    case=name, shape=[n, v, h], dtype=f"h {str(dt)[6:]}, W {str(w.dtype)[6:]}",
                    max_abs_err=err, tol=tol, kernel_ms=kernel_ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                    bound_by=bound_by, tflops=flops / kernel_ms / 1e9,
                    check_launches=sum(moved[r][kernel[len("lm_loss_"):]] for r in moved),
                    **extra[kernel])
                emit(phase="kernel_vs_plain", kernel=kernel, **recs[kernel],
                     plain="lm_loss_bwd_plain (dh, dw)" if kernel != "lm_loss_fwd"
                     else "lm_loss_fwd_plain",
                     library="cross_entropy(linear(h, W).float())" + (
                         " autograd backward (dh, dW)" if kernel != "lm_loss_fwd" else ""))
            del hl, wl, lib_loss
        else:
            emit(phase="kernel_vs_plain", kernel="lm_loss (fwd, dh, dw)", case=name,
                 shape=[n, w.shape[0], hid], routes=[fwd_route, route],
                 instance=_lm_grad_instance(plan),
                 max_abs_err=[err_f, err_dh, err_dw], tol=[tol_f, tol_dh, tol_dw],
                 rel_frob=[frob_dh, frob_dw] if f32 else None,
                 fma_max_abs_err={k: fma_err[k] for k in fma} if fma else None,
                 fma_rel_frob={k: fma_frob[k] for k in fma_frob} if f32 and fma_frob
                 else None)
        out[name] = recs
        del loss, lse, dh, dw, ploss, plse, pdh, pdw
        torch.cuda.empty_cache()
    return out


def _lm_grad_instance(plan):
    """The LM-loss backward's kernel instance that ``plan`` launches."""
    if plan.route == "fma":
        return "lm_grad_kernel"
    name = "lm_grad_tf32_kernel" if plan.route == "tf32x3" else "lm_grad_mma_kernel"
    return (f"{name}, HC {plan.hc}, {plan.stages} other buffers, "
            + (f"a cluster of {plan.cluster} CTAs, slices of {plan.chunk} columns"
               if plan.cluster > 1 else f"chunks of {plan.chunk} columns"))


def _library_counts():
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import lm_loss as lm

    by_route = lm.launches_by_route
    return {"layer_norm_fwd": ln.launches_fwd, "layer_norm_infer": ln.launches_infer,
            "layer_norm_bwd": ln.launches_bwd, "lm_loss_fwd": lm.launches_fwd,
            "lm_loss_dh": lm.launches_dh, "lm_loss_dw": lm.launches_dw,
            **{f"lm_loss_{k}_{r}": by_route[r][k] for r in ("mma", "tf32x3", "fma")
               for k in ("fwd", "dh", "dw")}}


def _reset_library_counts():
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import lm_loss as lm

    ln.launches_fwd = ln.launches_infer = ln.launches_bwd = 0
    lm.launches_fwd = lm.launches_dh = lm.launches_dw = 0
    for counts in lm.launches_by_route.values():
        counts["fwd"] = counts["dh"] = counts["dw"] = 0


def phase_library_ops(ids):
    """The composition the library ops exist for, at GPT-2 124M width and
    depth, twice. In f32: the hidden state before ln_f through the kernel
    LayerNorm (no_grad: the inference forward, held against the model's
    ln_f; then with grad), the tied LM head and loss through the kernel LM
    loss, mean over rows; loss and the gradients of wte, ln_f.weight and
    ln_f.bias against the model's own route (plain LayerNorm, chunked fused
    loss); the LM loss's forward and backward on the 3xTF32 tensor-core
    kernels, none on the FMA ones. Then the hidden state cast to bf16
    through the bf16 LayerNorm kernels (inference and training forward,
    backward) and the LM loss against the f32 tied wte (the bf16
    tensor-core forward and backward): the LayerNorm's output, loss, dh,
    dwte and ln_f's gradients against the plain versions on the card at the
    same dtypes. Returns the launch counts of each pass ({"f32": ...,
    "bf16": ...})."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import lm_loss as lm

    model = GPTForPretraining(GPTConfig(), seed=0)
    labels = torch.roll(ids, -1, 1)
    gpt = model.gpt
    params = {"gpt.wte.weight": gpt.wte.weight, "gpt.ln_f.weight": gpt.ln_f.weight,
              "gpt.ln_f.bias": gpt.ln_f.bias}

    def hidden_before_ln_f():
        x = gpt.wte(ids) + gpt.wpe(torch.arange(ids.shape[1], device=ids.device))
        for blk in gpt.blocks:
            x = blk(x)
        return x

    t0 = time.perf_counter()
    _reset_library_counts()
    x = hidden_before_ln_f()
    with torch.no_grad():
        h_inf = ln.layer_norm(x, gpt.ln_f.weight, gpt.ln_f.bias, gpt.ln_f.epsilon)
        h_ref = gpt.ln_f(x)
    hidden = ln.layer_norm(x, gpt.ln_f.weight, gpt.ln_f.bias, gpt.ln_f.epsilon)
    loss = lm.lm_head_cross_entropy(hidden.reshape(-1, hidden.shape[-1]),
                                    gpt.wte.weight, labels.reshape(-1)).mean()
    loss.backward()
    torch.cuda.synchronize()
    launches = _library_counts()
    pass_s = time.perf_counter() - t0
    want = {k: 0 if k.endswith(("_mma", "_fma")) else 1 for k in launches}
    if launches != want:
        raise AssertionError(f"the f32 library_ops pass launched {launches}, expected {want}")
    ln_err = (h_inf - h_ref).abs().max().item()
    if not ln_err <= F32_TOL * max(1.0, h_ref.abs().max().item()):
        raise AssertionError(f"kernel LayerNorm vs ln_f: {ln_err}")
    grads = {k: p.grad.clone() for k, p in params.items()}
    kernel_loss = loss.item()
    del x, h_inf, h_ref, hidden, loss

    model.zero_grad(set_to_none=True)
    ref = model(ids, labels)
    ref.backward()
    ref_loss = ref.item()
    loss_err = abs(kernel_loss - ref_loss) / abs(ref_loss)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"library ops loss {kernel_loss} vs the model's {ref_loss}")
    worst = {}
    for k, p in params.items():
        scale = p.grad.abs().max().item()
        err = (grads[k] - p.grad).abs().max().item()
        worst[k] = err / scale
        if not err <= TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"library ops gradient of {k}: {err} (max|g| {scale})")
    emit(phase="library_ops", model="gpt2-124m", batch=list(ids.shape), dtype="float32",
         loss_kernels=kernel_loss, loss_model=ref_loss, loss_rel_err=loss_err,
         loss_rtol=TRAIN_LOSS_RTOL, grad_rel_err=worst, grad_tol=TRAIN_GRAD_TOL,
         ln_inference_vs_ln_f_max_abs_err=ln_err, launches=launches, pass_s=pass_s)
    del grads, ref

    # the hidden state in bf16 through the bf16 LayerNorm (inference, then
    # training forward and backward), h against the f32 master wte: the
    # tensor-core route
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        xb = hidden_before_ln_f().to(torch.bfloat16)
    lab = labels.reshape(-1)
    w_ln, b_ln, eps = gpt.ln_f.weight, gpt.ln_f.bias, gpt.ln_f.epsilon
    t0 = time.perf_counter()
    _reset_library_counts()
    with torch.no_grad():
        h_inf = ln.layer_norm(xb, w_ln, b_ln, eps)
    hidden = ln.layer_norm(xb, w_ln, b_ln, eps)
    hb = hidden.reshape(-1, hidden.shape[-1])
    hb.retain_grad()
    rows = lm.lm_head_cross_entropy(hb, gpt.wte.weight, lab)
    loss = rows.mean()
    loss.backward()
    torch.cuda.synchronize()
    bf16_launches = _library_counts()
    bf16_pass_s = time.perf_counter() - t0
    want = {k: 0 if k.endswith(("_fma", "_tf32x3")) else 1 for k in bf16_launches}
    if bf16_launches != want:
        raise AssertionError(f"the bf16 library_ops pass launched {bf16_launches}, "
                             f"expected {want}")
    wte = gpt.wte.weight.detach()
    hbd = hb.detach()
    ploss, plse = lm.lm_loss_fwd_plain(hbd, wte, lab)
    g = torch.full_like(plse, 1.0 / plse.numel())
    pdh, pdw = lm.lm_loss_bwd_plain(hbd, wte, lab, plse, g)
    x2 = xb.reshape(hb.shape)
    pho, pmu, prstd = ln.layer_norm_fwd_plain(x2, w_ln.detach(), b_ln.detach(), eps)
    _, pdg, pdb = ln.layer_norm_bwd_plain(x2, w_ln.detach(), hb.grad, pmu, prstd)
    bf16 = torch.bfloat16
    if not torch.equal(h_inf.reshape(hb.shape), hbd):
        raise AssertionError("bf16 LayerNorm: the inference and training forwards differ")
    errs = {"ln_out": _close_or_raise("bf16 library_ops LayerNorm", hbd, pho, bf16),
            "loss": _close_or_raise("bf16 library_ops loss", rows, ploss, bf16,
                                    tol=_f32_tol(ploss)),
            "dh": _close_or_raise("bf16 library_ops dh", hb.grad, pdh, bf16, grad=True),
            "dwte": _close_or_raise("bf16 library_ops dwte", gpt.wte.weight.grad, pdw, bf16,
                                    grad=True),
            "dln_w": _close_or_raise("bf16 library_ops dln_f.weight", w_ln.grad, pdg,
                                     torch.float32, grad=True),
            "dln_b": _close_or_raise("bf16 library_ops dln_f.bias", b_ln.grad, pdb,
                                     torch.float32, grad=True)}
    if hb.grad.dtype != bf16 or gpt.wte.weight.grad.dtype != torch.float32:
        raise AssertionError(f"dh {hb.grad.dtype}, dwte {gpt.wte.weight.grad.dtype}")
    emit(phase="library_ops", model="gpt2-124m", batch=list(ids.shape),
         dtype="x bfloat16 (the hidden state before ln_f cast), wte float32",
         loss_kernels=loss.item(), loss_plain=ploss.mean().item(),
         max_abs_err={k: e for k, (e, _) in errs.items()},
         tol={k: t for k, (_, t) in errs.items()}, launches=bf16_launches,
         pass_s=bf16_pass_s)
    del model, xb, x2, h_inf, hidden, hb, rows, loss, ploss, plse, pdh, pdw, pho, pmu, prstd
    torch.cuda.empty_cache()
    return {"f32": launches, "bf16": bf16_launches}


def phase_probe(build_seconds):
    """The LM-loss compile probe's port at its defaults (rows 4096, vocab
    8192, hidden 768, bf16): each forward variant checked and timed, then
    the library call of the same loss on the probe's inputs (row P's
    library time)."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.kernels import lm_loss as lm
    from paddle_tpu_torch.tools import lmloss_compile_probe as probe

    recs = probe.run(build_seconds=build_seconds,
                     emit=lambda rec: emit(phase="lmloss_compile_probe", **rec))
    rows, vocab, hidden = 4096, 8192, 768        # the probe's defaults and inputs
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(rows, hidden, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(vocab, hidden, device="cuda", generator=gen) * 0.05).bfloat16()
    labels = torch.randint(0, vocab - 64, (rows,), device="cuda", generator=gen,
                           dtype=torch.int32).long()
    with torch.no_grad():
        def library():
            return tF.cross_entropy(tF.linear(h, w).float(), labels, reduction="none")

        err = (library() - lm.lm_head_cross_entropy(h, w, labels.int())).abs().max().item()
        emit(phase="lmloss_compile_probe", variant="library",
             call="F.cross_entropy(F.linear(h, W).float(), labels, reduction='none')",
             rows=rows, vocab=vocab, hidden=hidden, dtype="bfloat16",
             library_ms=cuda_ms(library), max_abs_diff_vs_full=err)
    return recs


# ---- phase tensor_api: the tensor API (paddle_tpu_torch's namespace) on the card ----

TENSOR_API_TOL = {      # card vs CPU, (rtol, atol) by result dtype: elementwise
    "float32": (2e-5, 2e-6),    # approximations and sum orders differ by a few
    "float64": (1e-9, 1e-11),   # ulps (TF32 off); bf16 / f16 one ulp or two
    "bfloat16": (2e-2, 2e-2), "float16": (2e-3, 2e-3),
    "complex64": (2e-5, 2e-6), "complex128": (1e-9, 1e-11)}
TENSOR_API_REC_TOL = 1e-9   # an f64 decomposition's reconstruction of its input
TENSOR_API_DRAWS = 100_000  # draws of each random op for its moments (5 std errors)
BLOCK_F32_TOL = 1e-4    # the namespace's decoder block vs GPTBlock, f32: forward
                        # and each gradient in relative Frobenius norm (the
                        # block's f32 products against the flash 3xTF32 kernels;
                        # a dropped mask, scale or term is off by O(1))
BLOCK_BF16_TOL = 3e-2   # ... under bf16 auto_cast O1: bf16 products in both,
                        # P rounded to bf16 before P V in both, sums in other orders
TENSOR_API_MAX_S = 30   # the phase's wall seconds


def tensor_api_block(P, x, p, heads, eps=1e-5):
    """One GPT-2 decoder block (pre-LN, causal, tanh-approximate GELU) written
    only in the tensor API of ``P``: ``paddle_tpu_torch``, or ``paddle_tpu``
    (the CPU tests run it in both). ``p`` holds GPTBlock's parameters under
    its names, Linear weights ``[out, in]``."""
    b, s, h = x.shape
    d = h // heads

    def layer_norm(v, g, beta):
        mu = P.mean(v, axis=-1, keepdim=True)
        var = P.var(v, axis=-1, unbiased=False, keepdim=True)
        return P.add(P.multiply(P.multiply(P.subtract(v, mu), P.rsqrt(P.add(var, eps))), g),
                     beta)

    def linear(v, name):
        return P.add(P.matmul(v, p[name + ".weight"], transpose_y=True), p[name + ".bias"])

    def heads_of(t):
        return P.transpose(P.reshape(t, [b, s, heads, d]), [0, 2, 1, 3])

    qkv = linear(layer_norm(x, p["ln1.weight"], p["ln1.bias"]), "attn.qkv_proj")
    q, k, v = [heads_of(t) for t in P.split(qkv, 3, axis=-1)]
    scores = P.multiply(P.matmul(q, k, transpose_y=True), 1.0 / math.sqrt(d))
    future = P.cast(P.triu(P.ones([s, s]), 1), "bool")
    att = P.matmul(P.softmax(P.where(future, -1e9, scores), axis=-1), v)
    att = P.reshape(P.transpose(att, [0, 2, 1, 3]), [b, s, h])
    h1 = P.add(x, linear(att, "attn.out_proj"))
    ff = linear(P.gelu(linear(layer_norm(h1, p["ln2.weight"], p["ln2.bias"]), "mlp.fc1"),
                       approximate=True), "mlp.fc2")
    return P.add(h1, ff)


class _L(list):
    """A case argument that is a list of tensors."""


def _arr(rng, shape, kind="f32"):
    if kind == "i64":
        return rng.randint(-5, 6, shape).astype(np.int64)
    if kind == "nat":
        return rng.randint(1, 10, shape).astype(np.int64)
    if kind == "bool":
        return rng.rand(*shape) > 0.5
    if kind == "c64":
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    lo_hi = {"pos": (0.5, 2.5), "unit": (-0.9, 0.9), "gt1": (1.2, 3.0), "prob": (0.05, 0.95)}
    a = rng.uniform(*lo_hi[kind], shape) if kind in lo_hi else rng.standard_normal(shape)
    return a.astype(np.float64 if kind == "f64" else np.float32)


def _spd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def _one(kind="f32", shape=(3, 4)):
    return lambda r: [_arr(r, shape, kind)]


def _two(k1="f32", k2="f32", s1=(3, 4), s2=(3, 4)):
    return lambda r: [_arr(r, s1, k1), _arr(r, s2, k2)]


_UNARY_DOMAIN = {
    "log": "pos", "log2": "pos", "log10": "pos", "log1p": "pos", "sqrt": "pos", "rsqrt": "pos",
    "reciprocal": "pos", "tan": "unit", "asin": "unit", "acos": "unit", "atanh": "unit",
    "erfinv": "unit", "acosh": "gt1", "digamma": "pos", "lgamma": "pos", "logit": "prob"}
_ONE_ARG = (     # ops of one [3, 4] tensor (their domain above), at their defaults
    "abs acos acosh angle asin asinh atan atanh ceil celu conj cos cosh deg2rad digamma elu erf "
    "erfinv exp expm1 exponent floor frac gelu hardshrink hardsigmoid hardswish hardtanh i0 i1 "
    "imag isfinite isinf isnan leaky_relu lgamma log log10 log1p log2 log_sigmoid log_softmax "
    "logit mish neg rad2deg real reciprocal relu relu6 round rrelu rsqrt selu sgn sigmoid sign "
    "silu sin sinh softmax softplus softshrink softsign sqrt square swiglu swish tan tanh "
    "tanhshrink thresholded_relu trunc glu clone assign clone_detached logcumsumexp "
    "cumsum cumprod cummax cummin t flatten squeeze sort logsumexp std var mean sum prod max "
    "min amax amin median nanmedian nansum nanmean argmax argmin count_nonzero diff "
    "is_complex is_floating_point is_integer is_empty is_tensor numel rank shape all any "
    "atleast_1d atleast_2d atleast_3d unbind unstack nonzero triu tril diag diagonal trace "
    "zeros_like ones_like empty_like tolist stanh nan_to_num").split()
_TWO_ARG = (     # ops of two [3, 4] tensors
    "add subtract multiply divide remainder mod floor_mod floor_divide pow maximum minimum fmax "
    "fmin atan2 hypot copysign nextafter logaddexp heaviside equal not_equal less_than "
    "less_equal greater_than greater_equal isclose allclose equal_all kron inner outer "
    "complex dist").split()
_INT_BINARY = "gcd lcm bitwise_and bitwise_or bitwise_xor bitwise_left_shift bitwise_right_shift"
_BOOL_UNARY_BINARY = {"logical_not": 1, "bitwise_not": 1, "logical_and": 2, "logical_or": 2,
                      "logical_xor": 2}
I64 = np.int64


def _explicit_cases():
    """(name, build, kwargs) of the ops that take other inputs than one or
    two [3, 4] tensors."""
    sq = lambda r: [_spd(r, 4)]     # noqa: E731
    return [
        ("to_tensor", lambda r: [[1.5, 2.0]], {}), ("to_tensor", lambda r: [[1, 2]], {}),
        ("zeros", lambda r: [[2, 3]], {}), ("ones", lambda r: [[2, 3]], {"dtype": "int32"}),
        ("full", lambda r: [[2, 2], 1.5], {}), ("empty", lambda r: [[2, 3]], {}),
        ("full_like", _one(), {"fill_value": 2}), ("arange", lambda r: [1, 10, 2], {}),
        ("linspace", lambda r: [0.0, 1.0, 7], {}), ("logspace", lambda r: [0.0, 2.0, 5], {}),
        ("eye", lambda r: [3, 4], {}), ("diagflat", _one("f32", (2, 2)), {}),
        ("diag_embed", _one("f32", (2, 3)), {}),
        ("fill_diagonal_tensor", lambda r: [_arr(r, (3, 4)), _arr(r, (3,))], {}),
        ("meshgrid", lambda r: [_arr(r, (3,)), _arr(r, (4,))], {}),
        ("tril_indices", lambda r: [4, 3], {}), ("triu_indices", lambda r: [4, 4, 1], {}),
        ("scale", _one(), {"scale": 2.0, "bias": 1.0}),
        ("clip", _one(), {"min": -0.5, "max": 0.5}),
        ("lerp", lambda r: [_arr(r, (3, 4)), _arr(r, (3, 4)), _arr(r, (3, 4), "prob")], {}),
        ("increment", _one(), {"value": 2.0}), ("rsqrt_", _one("pos"), {}),
        ("multiplex", lambda r: [_L([_arr(r, (3, 4)), _arr(r, (3, 4))]),
                                 np.array([[0], [1], [1]], I64)], {}),
        ("addmm", lambda r: [_arr(r, (3, 5)), _arr(r, (3, 4)), _arr(r, (4, 5))], {"beta": 0.5}),
        ("add_n", lambda r: [_L([_arr(r, (3, 4)), _arr(r, (3, 4))])], {}),
        ("renorm", _one("f32", (3, 4, 2)), {"p": 2, "axis": 1, "max_norm": 1.0}),
        ("ldexp", lambda r: [_arr(r, (3, 4)), _arr(r, (3, 4), "nat")], {}),
        ("quantile", _one("f32", (3, 4, 5)), {"q": [0.2, 0.5], "axis": 1}),
        ("nanquantile", lambda r: [np.array([[1, np.nan, 3, 4], [2, 1, 5, np.nan]], np.float32)],
         {"q": 0.5, "axis": 1}),
        ("kthvalue", _one("f32", (3, 5)), {"k": 2}),
        ("mode", lambda r: [np.array([[3, 1, 1, 2, 2], [0, 0, 4, 4, 1]], np.float32)], {}),
        ("cast", _one(), {"dtype": "bfloat16"}), ("astype", _one(), {"dtype": "int32"}),
        ("reshape", _one(), {"shape": [2, 6]}), ("reshape_", _one(), {"shape": [6, 2]}),
        ("transpose", _one("f32", (2, 3, 4)), {"perm": [2, 0, 1]}),
        ("moveaxis", _one("f32", (2, 3, 4)), {"source": 0, "destination": -1}),
        ("swapaxes", _one("f32", (2, 3, 4)), {"axis0": 0, "axis1": 2}),
        ("concat", lambda r: [_L([_arr(r, (2, 3)), _arr(r, (1, 3))])], {}),
        ("stack", lambda r: [_L([_arr(r, (2, 3)), _arr(r, (2, 3))])], {"axis": 1}),
        ("vstack", lambda r: [_L([_arr(r, (3,)), _arr(r, (3,))])], {}),
        ("hstack", lambda r: [_L([_arr(r, (2, 3)), _arr(r, (2, 1))])], {}),
        ("dstack", lambda r: [_L([_arr(r, (2, 3)), _arr(r, (2, 3))])], {}),
        ("split", _one("f32", (6, 2)), {"num_or_sections": [2, -1, 1]}),
        ("chunk", _one("f32", (4, 2)), {"chunks": 2}),
        ("squeeze_", _one("f32", (3, 1, 4)), {"axis": 1}),
        ("unsqueeze", _one(), {"axis": [0, 2]}), ("unsqueeze_", _one(), {"axis": 1}),
        ("expand", _one("f32", (3, 1)), {"shape": [2, -1, 4]}),
        ("broadcast_to", _one("f32", (1, 4)), {"shape": [3, 4]}),
        ("expand_as", lambda r: [_arr(r, (1, 4)), _arr(r, (3, 4))], {}),
        ("broadcast_tensors", lambda r: [_L([_arr(r, (3, 1)), _arr(r, (1, 4))])], {}),
        ("broadcast_shape", lambda r: [[3, 1], [1, 4]], {}),
        ("tile", _one(), {"repeat_times": [2, 1]}),
        ("repeat_interleave", _one(), {"repeats": 2, "axis": 1}),
        ("flip", _one(), {"axis": [0, 1]}), ("reverse", _one(), {"axis": 0}),
        ("rot90", _one("f32", (2, 3, 4)), {"k": -1, "axes": (1, 2)}),
        ("roll", _one(), {"shifts": (1, -2), "axis": (0, 1)}),
        ("where", lambda r: [_arr(r, (3, 4), "bool"), _arr(r, (3, 4), "i64"), 2.5], {}),
        ("masked_select", lambda r: [_arr(r, (3, 4)), _arr(r, (3, 4), "bool")], {}),
        ("masked_fill", lambda r: [_arr(r, (3, 4)), _arr(r, (3, 4), "bool"), 2.0], {}),
        ("gather", lambda r: [_arr(r, (4, 3)), np.array([3, 0, 0], I64)], {}),
        ("gather_nd", lambda r: [_arr(r, (3, 4, 2)), np.array([[0, 1], [2, 3]], I64)], {}),
        ("take_along_axis", lambda r: [_arr(r, (3, 4)), np.array([[0, 3], [1, 1], [2, 0]], I64),
                                       1], {}),
        ("put_along_axis", lambda r: [_arr(r, (3, 4)), np.array([[0, 0], [3, 3], [1, 2]], I64),
                                      _arr(r, (3, 2)), 1], {"reduce": "add"}),
        ("scatter", lambda r: [_arr(r, (4, 3)), np.array([2, 0, 2], I64), _arr(r, (3, 3))],
         {"overwrite": False}),
        ("scatter_", lambda r: [_arr(r, (4, 3)), np.array([2, 0], I64), _arr(r, (2, 3))], {}),
        ("scatter_nd_add", lambda r: [_arr(r, (3, 4)), np.array([[0, 1], [2, 2], [0, 1]], I64),
                                      _arr(r, (3,))], {}),
        ("scatter_nd", lambda r: [np.array([[1], [0], [1]], I64), _arr(r, (3, 4)), [2, 4]], {}),
        ("index_select", lambda r: [_arr(r, (3, 4)), np.array([3, 1], I64), 1], {}),
        ("index_sample", lambda r: [_arr(r, (3, 4)), np.array([[0, 3], [1, 1], [2, 0]], I64)],
         {}),
        ("index_add", lambda r: [_arr(r, (3, 4)), np.array([0, 2, 0], I64), 0, _arr(r, (3, 4))],
         {}),
        ("index_put", lambda r: [_arr(r, (3, 4)), _L([np.array([0, 0], I64),
                                                      np.array([1, 1], I64)]), _arr(r, (2,))],
         {"accumulate": True}),
        ("argsort", lambda r: [np.array([[1, 2, 2, 3, 2], [5, 5, 1, 1, 0]], np.float32)],
         {"descending": True}),
        ("topk", lambda r: [np.array([[1, 2, 2, 3, 2], [5, 5, 1, 1, 0]], np.float32), 3], {}),
        ("unique", lambda r: [np.array([3, 1, 2, 1, 3, 3], I64)],
         {"return_index": True, "return_inverse": True, "return_counts": True}),
        ("unique_consecutive", lambda r: [np.array([1, 1, 2, 2, 3, 1, 1], I64)],
         {"return_inverse": True, "return_counts": True}),
        ("searchsorted", lambda r: [np.array([1.0, 2.0, 2.0, 4.0], np.float32),
                                    np.array([[0.5, 2.0], [2.5, 9.0]], np.float32)],
         {"right": True}),
        ("bucketize", lambda r: [np.array([0.5, 2.0, 3.0], np.float32),
                                 np.array([1.0, 2.0, 4.0], np.float32)], {}),
        ("pad", _one("f32", (2, 3, 4, 5)), {"pad": [2, 1, 1, 3], "mode": "reflect"}),
        ("strided_slice", _one("f32", (5, 6)), {"axes": [1], "starts": [5], "ends": [0],
                                                "strides": [-2]}),
        ("slice", _one("f32", (5, 6)), {"axes": [0, 1], "starts": [1, -3], "ends": [3, 100]}),
        ("crop", _one("f32", (5, 6)), {"shape": [2, 3], "offsets": [1, 2]}),
        ("shard_index", lambda r: [np.array([[1], [6], [12], [19]], I64), 20, 2, 1], {}),
        ("tensordot", lambda r: [_arr(r, (3, 4, 5)), _arr(r, (4, 5, 2))], {}),
        ("as_real", _one("c64"), {}), ("as_complex", _one("f32", (3, 2)), {}),
        ("view", _one(), {"shape_or_dtype": [4, 3]}),
        ("getitem", lambda r: [_arr(r, (3, 4)), (slice(None, None, 2), slice(3, 0, -1))], {}),
        ("setitem", lambda r: [_arr(r, (3, 4)), (slice(None), 2), 5.0], {}),
        ("tanh_", _one(), {}), ("maxout", _one("f32", (4, 4, 2)), {"groups": 2}),
        ("prelu", lambda r: [_arr(r, (2, 3, 4)), _arr(r, (3,), "pos")], {}),
        ("matmul", lambda r: [_arr(r, (2, 3, 4)), _arr(r, (5, 4))], {"transpose_y": True}),
        ("mm", lambda r: [_arr(r, (3, 4)), _arr(r, (4, 2))], {}),
        ("bmm", lambda r: [_arr(r, (2, 3, 4)), _arr(r, (2, 4, 5))], {}),
        ("mv", lambda r: [_arr(r, (3, 4)), _arr(r, (4,))], {}),
        ("dot", _two(), {}), ("einsum", lambda r: ["bij,bkj->bik", _arr(r, (2, 3, 4)),
                                                    _arr(r, (2, 5, 4))], {}),
        ("norm", _one(), {"p": 1, "axis": 1}), ("vector_norm", _one(), {"p": 3.0}),
        ("cross", _two("f32", "f32", (4, 3), (4, 3)), {}),
        ("cholesky", sq, {}), ("inverse", sq, {}), ("inv", sq, {}),
        ("pinv", _one("f64", (4, 3)), {}),
        ("solve", lambda r: [_spd(r, 4), _arr(r, (4, 2), "f64")], {}),
        ("triangular_solve", lambda r: [np.triu(_spd(r, 4)), _arr(r, (4, 2), "f64")], {}),
        ("cholesky_solve", lambda r: [_arr(r, (4, 2), "f64"), np.linalg.cholesky(_spd(r, 4))],
         {}),
        ("det", sq, {}), ("slogdet", _one("f64", (3, 3)), {}),
        ("matrix_power", sq, {"n": -2}), ("matrix_rank", _one("f64", (4, 3)), {}),
        ("multi_dot", lambda r: [_L([_arr(r, (3, 4)), _arr(r, (4, 5)), _arr(r, (5, 2))])], {}),
        ("cond", _one("f64", (4, 4)), {}), ("eigvalsh", sq, {}),
        ("lstsq", lambda r: [_arr(r, (6, 3), "f64"), _arr(r, (6, 2), "f64")], {}),
        ("cov", _one("f64", (3, 6)), {}), ("corrcoef", _one("f64", (3, 6)), {}),
        ("histogram", _one("f32", (50,)), {"bins": 7}),
        ("bincount", lambda r: [_arr(r, (20,), "nat"), _arr(r, (20,))], {"minlength": 12}),
        ("check_shape", lambda r: [[2, 3]], {}),
    ]


def tensor_api_cases():
    """Every function of the namespace with at least one case: (name, build,
    kwargs, check), check "value" (the same on both devices, by result
    dtype: TENSOR_API_TOL), "decomposition" or "random"."""
    cases = []
    for name in _ONE_ARG:
        cases.append((name, _one(_UNARY_DOMAIN.get(name, "f32"),
                                 (4, 4) if name in ("glu", "swiglu") else (3, 4)), {}, "value"))
    for name in ("exp", "sqrt", "sum", "mean", "cumsum", "floor", "abs", "sign"):
        cases.append((name, _one("nat" if name == "sqrt" else "i64"), {}, "value"))
    for name in ("add", "multiply", "relu", "gelu", "softmax", "mean", "matmul"):
        build = (lambda r: [_arr(r, (3, 4)).astype(np.float32), _arr(r, (4, 3))]) \
            if name == "matmul" else _two() if name in ("add", "multiply") else _one()
        cases.append((name, build, {"bf16": True}, "value"))
    for name in _TWO_ARG:
        cases.append((name, _two("f32", "pos" if name in ("divide", "remainder", "mod",
                                                          "floor_mod", "floor_divide")
                                 else "f32", (3, 4), (4,) if name == "inner" else (3, 4)),
                      {}, "value"))
    cases.append(("multiply", lambda r: [_arr(r, (3, 4), "i64"), 2.5], {}, "value"))
    cases.append(("divide", _two("i64", "nat"), {}, "value"))
    for name in _INT_BINARY.split():
        cases.append((name, _two("nat", "nat"), {}, "value"))
    for name, n in _BOOL_UNARY_BINARY.items():
        cases.append((name, _one("bool") if n == 1 else _two("bool", "bool"), {}, "value"))
    cases += [(n, b, kw, "value") for n, b, kw in _explicit_cases()]
    sq = lambda r: [_spd(r, 5)]     # noqa: E731
    for name, build in (("svd", _one("f64", (5, 3))), ("qr", _one("f64", (5, 3))),
                        ("eigh", sq), ("eig", _one("f64", (4, 4))),
                        ("eigvals", _one("f64", (4, 4))), ("lu", _one("f64", (4, 4))),
                        ("lu_unpack", _one("f64", (4, 4)))):
        cases.append((name, build, {}, "decomposition"))
    for name in ("rand", "randn", "standard_normal", "normal", "uniform", "randint",
                 "randint_like", "randperm", "bernoulli", "multinomial", "poisson",
                 "gumbel_softmax"):
        cases.append((name, None, {}, "random"))
    return cases


def _on(a, dev, bf16=False):
    if isinstance(a, _L):
        return [_on(x, dev, bf16) for x in a]
    if isinstance(a, np.ndarray):
        t = torch.from_numpy(a.copy()).to(dev)
        return t.to(torch.bfloat16) if bf16 and t.is_floating_point() else t
    return a


def _tensor_api_call(P, name, build, kwargs, dev, seed):
    """Op ``name`` of ``P`` on ``dev`` (the current place set to it), on the
    inputs of ``build`` from RandomState(seed); the result on the CPU."""
    kwargs = dict(kwargs)
    bf16 = kwargs.pop("bf16", False)
    P.set_device("cpu" if dev == "cpu" else "gpu")
    args = [_on(a, dev, bf16) for a in build(np.random.RandomState(seed))]
    fn = P
    for part in name.split("."):     # "nn.functional.<name>" and the like
        fn = getattr(fn, part)
    with torch.no_grad():
        out = fn(*args, **kwargs)
    return _to_cpu(out)


def _to_cpu(out):
    if isinstance(out, (list, tuple)):
        return type(out)(_to_cpu(o) for o in out)
    return out.cpu() if torch.is_tensor(out) else out


def _tensor_api_close(what, got, want):
    """``got`` (card) against ``want`` (CPU): structure, dtype, shape; integer,
    bool and index values equal, floats within TENSOR_API_TOL. Returns the
    largest absolute difference."""
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise AssertionError(f"tensor_api {what}: {got!r} against {want!r}")
        return max([_tensor_api_close(f"{what}[{i}]", g, w)
                    for i, (g, w) in enumerate(zip(got, want))] or [0.0])
    if not torch.is_tensor(want):
        if got != want:
            raise AssertionError(f"tensor_api {what}: {got!r} against {want!r}")
        return 0.0
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"tensor_api {what}: {got.dtype} {tuple(got.shape)} against "
                             f"{want.dtype} {tuple(want.shape)}")
    if not (want.is_floating_point() or want.is_complex()):
        if not torch.equal(got, want):
            raise AssertionError(f"tensor_api {what}: {got} against {want}")
        return 0.0
    rtol, atol = TENSOR_API_TOL[str(want.dtype).replace("torch.", "")]
    g, w = got.to(torch.complex128 if want.is_complex() else torch.float64), \
        want.to(torch.complex128 if want.is_complex() else torch.float64)
    if not torch.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True):
        raise AssertionError(f"tensor_api {what}: max |card - cpu| "
                             f"{(g - w).abs().nan_to_num().max().item():.3e} past "
                             f"rtol {rtol} atol {atol}")
    return (g - w).abs().nan_to_num().max().item() if w.numel() else 0.0


def _decomposition_check(P, name, build, seed):
    """The card's factors by what is unique: values against the CPU's, the
    input rebuilt within TENSOR_API_REC_TOL, orthogonality."""
    a = build(np.random.RandomState(seed))[0]
    A = torch.from_numpy(a).cuda()
    rec = lambda got: _tensor_api_close(name + " reconstruction", got.cpu(),  # noqa: E731
                                        torch.from_numpy(a).to(got.dtype))
    P.set_device("gpu")
    if name == "svd":
        u, s, v = P.linalg.svd(A)
        _tensor_api_close("svd s", s.cpu(), P.linalg.svd(A.cpu())[1])
        rec(u @ torch.diag(s) @ v.T)
        _tensor_api_close("svd v^T v", (v.T @ v).cpu(), torch.eye(v.shape[1], dtype=v.dtype))
    elif name == "qr":
        q, r = P.linalg.qr(A)
        _tensor_api_close("qr |r|", r.abs().cpu(), P.linalg.qr(A.cpu())[1].abs())
        rec(q @ r)
        _tensor_api_close("qr q^T q", (q.T @ q).cpu(), torch.eye(q.shape[1], dtype=q.dtype))
    elif name == "eigh":
        w, v = P.linalg.eigh(A)
        _tensor_api_close("eigh w", w.cpu(), P.linalg.eigh(A.cpu())[0])
        rec(v @ torch.diag(w) @ v.T)
    elif name in ("eig", "eigvals"):
        w = P.linalg.eig(A)[0] if name == "eig" else P.linalg.eigvals(A)
        ref = P.linalg.eigvals(A.cpu())
        key = lambda z: (round(z.real, 9), round(z.imag, 9))  # noqa: E731
        _tensor_api_close(name + " sorted w", torch.tensor(sorted(w.cpu().tolist(), key=key)),
                          torch.tensor(sorted(ref.tolist(), key=key)))
        if name == "eig":
            v = P.linalg.eig(A)[1]
            _tensor_api_close("eig A v = v w", (A.to(v.dtype) @ v).cpu(),
                              (v @ torch.diag(w)).cpu())
    else:   # lu, lu_unpack
        lu_, piv = P.linalg.lu(A)
        p_, l_, u_ = P.linalg.lu_unpack(lu_, piv)
        rec(p_ @ l_ @ u_)


def _random_check(P, name):
    """A random op on the card's generator: dtype and shape as on the CPU,
    the card's device, the range, the first two moments within 5 standard
    errors, and the same draws again after ``seed``."""
    n = TENSOR_API_DRAWS
    draws = {
        "rand": (lambda: P.rand([n]), (0, 1), 0.5, 1 / 12),
        "randn": (lambda: P.randn([n]), None, 0.0, 1.0),
        "standard_normal": (lambda: P.standard_normal([n], dtype="float64"), None, 0.0, 1.0),
        "normal": (lambda: P.normal(2.0, 0.5, [n]), None, 2.0, 0.25),
        "uniform": (lambda: P.uniform([n], min=-2.0, max=2.0), (-2, 2), 0.0, 16 / 12),
        "randint": (lambda: P.randint(0, 10, [n]), (0, 9), 4.5, 99 / 12),
        "randint_like": (lambda: P.randint_like(P.zeros([n], dtype="int32"), 0, 5), (0, 4),
                         2.0, 2.0),
        "randperm": (lambda: P.randperm(1000), (0, 999), None, None),
        "bernoulli": (lambda: P.bernoulli(P.full([n], 0.3)), (0, 1), 0.3, 0.21),
        "multinomial": (lambda: P.multinomial(P.to_tensor([0.2, 0.3, 0.5]), n,
                                              replacement=True), (0, 2), 1.3, 0.61),
        "poisson": (lambda: P.poisson(P.full([n], 3.0)), None, 3.0, 3.0),
        "gumbel_softmax": (lambda: P.gumbel_softmax(P.zeros([n, 2]))[:, 0], (0, 1), 0.5, None),
    }
    fn, rng, mean, var = draws[name]
    P.set_device("cpu")
    cpu = fn()
    P.set_device("gpu")
    P.seed(2024)
    a = fn()
    P.seed(2024)
    b = fn()
    if a.device.type != "cuda" or a.dtype != cpu.dtype or a.shape != cpu.shape:
        raise AssertionError(f"tensor_api {name}: {a.device} {a.dtype} {tuple(a.shape)} against "
                             f"the CPU's {cpu.dtype} {tuple(cpu.shape)}")
    if not torch.equal(a, b):
        raise AssertionError(f"tensor_api {name}: the card's draws differ after the same seed")
    x = a.double()
    if rng is not None and (x.min() < rng[0] or x.max() > rng[1]):
        raise AssertionError(f"tensor_api {name}: draws outside {rng}")
    if name == "randperm":
        if not torch.equal(x.sort().values.cpu(), torch.arange(1000, dtype=torch.float64)):
            raise AssertionError("tensor_api randperm: not a permutation")
        return
    if abs(x.mean().item() - mean) > 5 * ((var or 0.25) / x.numel()) ** 0.5:
        raise AssertionError(f"tensor_api {name}: mean {x.mean().item()} against {mean}")
    if var is not None and abs(x.var().item() - var) > 5 * var * (2 / x.numel()) ** 0.5 * 1.5:
        raise AssertionError(f"tensor_api {name}: var {x.var().item()} against {var}")


# ---- the nn API's second half (paddle_tpu_torch.nn) in the tensor_api table ----

NN_FUNCTIONAL_NEW = (     # the nn.functional names of ROADMAP Queue 1 item 16
    "affine_grid alpha_dropout bilinear class_center_sample conv1d_transpose "
    "conv2d_transpose conv3d_transpose cosine_embedding_loss cosine_similarity ctc_loss "
    "diag_embed dice_loss dropout2d dropout3d fold gather_tree grid_sample group_norm "
    "hinge_embedding_loss hsigmoid_loss instance_norm interpolate local_response_norm "
    "log_loss margin_cross_entropy margin_ranking_loss max_unpool1d max_unpool2d "
    "max_unpool3d normalize npair_loss pixel_shuffle rms_norm sequence_mask "
    "sigmoid_focal_loss sparse_attention square_error_cost temporal_shift unfold upsample "
    "zeropad2d").split()
NN_LAYERS_NEW = (         # and its layers
    "AlphaDropout Bilinear CosineSimilarity Dropout2D Dropout3D Fold Pad1D Pad2D Pad3D "
    "PairwiseDistance PixelShuffle SpectralNorm Unfold Upsample UpsamplingBilinear2D "
    "UpsamplingNearest2D ZeroPad2D GroupNorm InstanceNorm1D InstanceNorm2D InstanceNorm3D "
    "LocalResponseNorm RMSNorm CTCLoss CosineEmbeddingLoss HSigmoidLoss HingeEmbeddingLoss "
    "MarginRankingLoss Conv1DTranspose Conv2DTranspose Conv3DTranspose MaxUnPool1D "
    "MaxUnPool2D MaxUnPool3D MultiHeadAttention TransformerEncoderLayer TransformerEncoder "
    "TransformerDecoderLayer TransformerDecoder Transformer").split()


def _nn_functional_cases():
    f = "nn.functional."
    lab = lambda r, shape, hi: r.randint(0, hi, shape).astype(I64)  # noqa: E731
    ties = lambda r, shape: r.randint(0, 4, shape).astype(np.float32)  # noqa: E731
    pooled = lambda nd: (lambda r: list(_unpool_inputs(r, nd)))  # noqa: E731
    return [
        (f + "conv1d_transpose", lambda r: [_arr(r, (2, 4, 7)), _arr(r, (4, 3, 3))],
         {"stride": 2, "padding": 1, "output_padding": 1}),
        (f + "conv2d_transpose", lambda r: [_arr(r, (2, 4, 9, 9)), _arr(r, (4, 3, 3, 3)),
                                            _arr(r, (3,))],
         {"stride": 2, "padding": 1, "output_size": [18, 18]}),
        (f + "conv2d_transpose", lambda r: [_arr(r, (2, 4, 5, 5)), _arr(r, (4, 2, 3, 3))],
         {"padding": [1, 0, 2, 1], "groups": 2, "dilation": 2}),
        (f + "conv3d_transpose", lambda r: [_arr(r, (1, 2, 3, 4, 4)), _arr(r, (2, 2, 2, 2, 2))],
         {"stride": 2}),
        (f + "max_pool2d", lambda r: [ties(r, (2, 3, 7, 6))],
         {"kernel_size": 3, "stride": 1, "return_mask": True}),
        (f + "max_unpool1d", pooled(1), {"kernel_size": 2}),
        (f + "max_unpool2d", pooled(2), {"kernel_size": 2}),
        (f + "max_unpool3d", pooled(3), {"kernel_size": 2}),
        (f + "group_norm", lambda r: [_arr(r, (2, 6, 4, 3)), 3, _arr(r, (6,)), _arr(r, (6,))],
         {}),
        (f + "instance_norm", lambda r: [_arr(r, (2, 3, 5, 4))], {}),
        (f + "local_response_norm", lambda r: [_arr(r, (2, 7, 3, 3)), 4], {"k": 2.0}),
        (f + "rms_norm", lambda r: [_arr(r, (3, 5, 8)), _arr(r, (8,))], {}),
        (f + "normalize", lambda r: [_arr(r, (3, 5))], {"p": 1, "axis": -1}),
        (f + "interpolate", lambda r: [_arr(r, (2, 3, 8, 5))],
         {"size": [5, 12], "mode": "bicubic"}),
        (f + "interpolate", lambda r: [_arr(r, (2, 8, 5, 3))],
         {"size": [3, 7], "mode": "bilinear", "data_format": "NHWC"}),
        (f + "interpolate", lambda r: [_arr(r, (1, 2, 8, 5))], {"size": [12, 3]}),
        (f + "upsample", lambda r: [_arr(r, (1, 2, 4, 3, 5))],
         {"scale_factor": 2, "mode": "trilinear", "data_format": "NCDHW"}),
        (f + "pixel_shuffle", lambda r: [_arr(r, (2, 8, 3, 3)), 2], {}),
        (f + "unfold", lambda r: [_arr(r, (2, 3, 6, 7)), 3], {"strides": 2, "paddings": 1}),
        (f + "fold", lambda r: [_arr(r, (2, 27, 12)), [6, 7], 3],
         {"strides": 2, "paddings": 1}),
        (f + "affine_grid", lambda r: [_arr(r, (2, 2, 3)), [2, 1, 4, 5]],
         {"align_corners": False}),
        (f + "grid_sample", lambda r: [_arr(r, (2, 3, 5, 4)), _arr(r, (2, 3, 6, 2), "unit")],
         {"padding_mode": "zeros", "align_corners": False}),
        (f + "grid_sample", lambda r: [_arr(r, (2, 3, 5, 4)), _arr(r, (2, 3, 6, 2), "unit")],
         {"mode": "nearest", "padding_mode": "border"}),
        (f + "temporal_shift", lambda r: [_arr(r, (6, 8, 2, 2)), 3], {}),
        (f + "zeropad2d", lambda r: [_arr(r, (2, 3, 4, 4)), [1, 2, 0, 3]], {}),
        (f + "diag_embed", lambda r: [_arr(r, (2, 3, 4))], {"offset": 1, "dim1": 0, "dim2": 2}),
        (f + "sequence_mask", lambda r: [np.array([[3, 0], [5, 2]], I64)], {}),
        (f + "sigmoid_focal_loss", lambda r: [_arr(r, (4, 3)), _arr(r, (4, 3), "bool")
                                              .astype(np.float32)], {}),
        (f + "margin_ranking_loss", lambda r: [_arr(r, (5,)), _arr(r, (5,)),
                                               np.sign(_arr(r, (5,)))], {"margin": 0.2}),
        (f + "cosine_similarity", lambda r: [_arr(r, (4, 6)), _arr(r, (4, 6))], {}),
        (f + "cosine_embedding_loss", lambda r: [_arr(r, (4, 6)), _arr(r, (4, 6)),
                                                 np.array([1, -1, 1, -1], I64)], {}),
        (f + "square_error_cost", _two(), {}),
        (f + "dice_loss", lambda r: [_arr(r, (3, 4, 5), "prob"), lab(r, (3, 4, 1), 5)], {}),
        (f + "log_loss", lambda r: [_arr(r, (6, 1), "prob"), _arr(r, (6, 1), "bool")
                                    .astype(np.float32)], {}),
        (f + "npair_loss", lambda r: [_arr(r, (5, 4)), _arr(r, (5, 4)),
                                      np.array([0, 1, 0, 2, 1], I64)], {}),
        (f + "hinge_embedding_loss", lambda r: [_arr(r, (3, 4)), np.where(
            _arr(r, (3, 4), "bool"), 1, -1).astype(I64)], {}),
        (f + "hsigmoid_loss", lambda r: [_arr(r, (4, 6)), lab(r, (4,), 7), 7, _arr(r, (6, 6)),
                                         _arr(r, (6, 1))], {}),
        (f + "hsigmoid_loss", lambda r: [_arr(r, (3, 6)), lab(r, (3,), 5), 5, _arr(r, (5, 6)),
                                         None, np.array([[0, 2, -1], [1, 3, 4], [0, -1, -1]],
                                                        I64),
                                         np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0]], I64)],
         {}),
        (f + "margin_cross_entropy", lambda r: [_arr(r, (4, 6), "unit"), lab(r, (4,), 6)],
         {"return_softmax": True, "reduction": "none"}),
        (f + "ctc_loss", lambda r: [_arr(r, (12, 2, 5)), np.array([[1, 2, 2], [3, 4, 0]], I64),
                                    np.array([12, 9], I64), np.array([3, 2], I64)], {}),
        (f + "bilinear", lambda r: [_arr(r, (4, 3)), _arr(r, (4, 5)), _arr(r, (2, 3, 5)),
                                    _arr(r, (2,))], {}),
        (f + "sparse_attention", lambda r: [_arr(r, (2, 2, 5, 8)), _arr(r, (2, 2, 5, 8)),
                                            _arr(r, (2, 2, 5, 8)),
                                            np.tile(np.array([0, 1, 3, 4, 6, 8], np.int32),
                                                    (2, 2, 1)),
                                            np.tile(np.array([0, 0, 1, 2, 1, 3, 0, 4],
                                                             np.int32), (2, 2, 1))], {}),
        (f + "gather_tree", lambda r: [r.randint(0, 10, (5, 2, 3)).astype(I64),
                                       r.randint(0, 3, (5, 2, 3)).astype(I64)], {}),
        ("nn.initializer.calculate_gain", lambda r: ["leaky_relu", 0.3], {}),
    ]


def _unpool_inputs(r, nd):
    """A max pool's values and mask (kernel 2) on the CPU, as numpy."""
    import paddle_tpu_torch.nn.functional as TNF

    shape = {1: (2, 3, 8), 2: (2, 2, 6, 4), 3: (1, 2, 4, 4, 2)}[nd]
    v, i = getattr(TNF, f"max_pool{nd}d")(torch.from_numpy(_arr(r, shape)), 2,
                                           return_mask=True)
    return v.numpy(), i.numpy()


def _nn_layer_cases():
    """(name, build(rng) -> (constructor, inputs)): each new layer on the
    CPU and a copy of it on the card, in eval, on the same inputs."""
    def layer(name, args=(), kw=None, *shapes):
        return (f"nn.{name}", lambda r: (
            lambda: getattr(_nn(), name)(*args, **(kw or {})),
            [s(r) if callable(s) else _arr(r, s) for s in shapes]))

    ids = lambda shape, hi: (lambda r: r.randint(0, hi, shape).astype(I64))  # noqa: E731
    sign = lambda shape: (lambda r: np.where(r.rand(*shape) > 0.5, 1, -1).astype(I64))  # noqa
    d, h, ff = 32, 4, 64
    return [
        layer("AlphaDropout", (0.4,), None, (4, 5)),
        layer("Bilinear", (3, 4, 2), None, (5, 3), (5, 4)),
        layer("CosineSimilarity", (), {"axis": -1}, (4, 6), (4, 6)),
        layer("Dropout2D", (0.4,), None, (2, 3, 4, 4)),
        layer("Dropout3D", (0.4,), None, (2, 3, 2, 2, 2)),
        layer("Fold", ([5, 6], 3), {"paddings": 1}, (2, 18, 30)),
        layer("Pad1D", ([1, 2],), {"mode": "reflect"}, (2, 3, 5)),
        layer("Pad2D", ([1, 0, 2, 1],), {"value": 0.5}, (1, 2, 3, 4)),
        layer("Pad3D", ([1, 1, 0, 1, 1, 0],), {"mode": "replicate"}, (1, 2, 2, 3, 3)),
        layer("PairwiseDistance", (), None, (4, 5), (4, 5)),
        layer("PixelShuffle", (2,), None, (1, 8, 2, 3)),
        layer("SpectralNorm", ((4, 3, 2),), {"dim": 1, "power_iters": 3}, (4, 3, 2)),
        layer("Unfold", (3,), {"strides": 2}, (2, 2, 7, 6)),
        layer("Upsample", (), {"size": [7, 5], "mode": "bilinear"}, (1, 2, 4, 6)),
        layer("UpsamplingBilinear2D", (), {"size": [3, 9]}, (1, 2, 6, 4)),
        layer("UpsamplingNearest2D", (), {"scale_factor": 3}, (1, 2, 2, 2)),
        layer("ZeroPad2D", ([2, 1, 0, 1],), None, (1, 2, 3, 3)),
        layer("GroupNorm", (2, 6), None, (2, 6, 3, 3)),
        layer("InstanceNorm1D", (3,), None, (2, 3, 7)),
        layer("InstanceNorm2D", (3,), None, (2, 3, 4, 4)),
        layer("InstanceNorm3D", (2,), None, (1, 2, 3, 3, 3)),
        layer("LocalResponseNorm", (3,), None, (2, 5, 3, 3)),
        layer("RMSNorm", (6,), None, (2, 3, 6)),
        layer("CTCLoss", (), None, (9, 2, 4), lambda r: np.array([[1, 2], [3, 3]], I64),
              lambda r: np.array([9, 7], I64), lambda r: np.array([2, 2], I64)),
        layer("CosineEmbeddingLoss", (), {"margin": 0.2}, (4, 5), (4, 5), sign((4,))),
        layer("HSigmoidLoss", (4, 6), None, (3, 4), ids((3,), 6)),
        layer("HingeEmbeddingLoss", (), None, (3, 4), sign((3, 4))),
        layer("MarginRankingLoss", (), None, (6,), (6,), lambda r: np.sign(_arr(r, (6,)))),
        layer("Conv1DTranspose", (3, 2, 3), {"stride": 2, "padding": 1}, (2, 3, 5)),
        layer("Conv2DTranspose", (4, 6, 3), {"stride": 2, "groups": 2, "output_padding": 1},
              (1, 4, 3, 3)),
        layer("Conv3DTranspose", (2, 3, 2), {"stride": 2}, (1, 2, 2, 3, 2)),
        ("nn.MaxUnPool1D", lambda r: (lambda: _nn().MaxUnPool1D(2),
                                      list(_unpool_inputs(r, 1)))),
        ("nn.MaxUnPool2D", lambda r: (lambda: _nn().MaxUnPool2D(2),
                                      list(_unpool_inputs(r, 2)))),
        ("nn.MaxUnPool3D", lambda r: (lambda: _nn().MaxUnPool3D(2),
                                      list(_unpool_inputs(r, 3)))),
        layer("MultiHeadAttention", (d, h), {"kdim": 16}, (2, 6, d), (2, 9, 16), (2, 9, d)),
        layer("TransformerEncoderLayer", (d, h, ff), {"normalize_before": True}, (2, 6, d)),
        ("nn.TransformerEncoder", lambda r: (
            lambda: _nn().TransformerEncoder(_nn().TransformerEncoderLayer(
                d, h, ff, activation="gelu"), 2), [_arr(r, (2, 6, d))])),
        layer("TransformerDecoderLayer", (d, h, ff), None, (2, 5, d), (2, 7, d)),
        ("nn.TransformerDecoder", lambda r: (
            lambda: _nn().TransformerDecoder(_nn().TransformerDecoderLayer(d, h, ff), 2),
            [_arr(r, (2, 5, d)), _arr(r, (2, 7, d))])),
        ("nn.Transformer", lambda r: (
            lambda: _nn().Transformer(d, h, 1, 1, ff),
            [_arr(r, (2, 7, d)), _arr(r, (2, 5, d)), None,
             _nn().Transformer.generate_square_subsequent_mask(5, "cpu").numpy()])),
    ]


def _nn():
    import paddle_tpu_torch.nn as nn

    return nn


def _nn_layer_check(P, name, build, seed):
    """A layer built on the CPU (torch seeded), its copy on the card, both in
    eval on the same inputs: the card's output against the CPU's."""
    import copy

    make, inputs = build(np.random.RandomState(seed))
    P.set_device("cpu")
    torch.manual_seed(seed)
    cpu = make().eval()
    card = copy.deepcopy(cpu).cuda()
    with torch.no_grad():
        want = cpu(*[_on(a, "cpu") for a in inputs])
        got = card(*[_on(a, "cuda") for a in inputs])
    return _tensor_api_close(name, _to_cpu(got), _to_cpu(want))


NN_INIT_MOMENTS = {   # initializer -> (make, JAX-layout shape, mean, std, bound)
    "Normal": (lambda I: I.Normal(0.5, 2.0), (300, 200), 0.5, 2.0, None),
    "normal": (lambda I: I.normal(0.0, 0.1), (300, 200), 0.0, 0.1, None),
    "TruncatedNormal": (lambda I: I.TruncatedNormal(0.0, 1.0), (300, 200), 0.0, 0.8796, 2.0),
    "Uniform": (lambda I: I.Uniform(-1.0, 1.0), (300, 200), 0.0, 1 / 3 ** 0.5, 1.0),
    "uniform": (lambda I: I.uniform(0.0, 2.0), (300, 200), 1.0, 1 / 3 ** 0.5, None),
    "XavierNormal": (lambda I: I.XavierNormal(), (300, 100), 0.0, (2 / 400) ** 0.5, None),
    "XavierUniform": (lambda I: I.XavierUniform(), (300, 100), 0.0, (2 / 400) ** 0.5,
                      (6 / 400) ** 0.5),
    "KaimingNormal": (lambda I: I.KaimingNormal(), (256, 64), 0.0, (2 / 256) ** 0.5, None),
    "KaimingUniform": (lambda I: I.KaimingUniform(), (256, 64), 0.0, (2 / 256) ** 0.5,
                       (6 / 256) ** 0.5),
}
NN_ORTHO_TOL = 1e-5    # an f32 orthogonal matrix's |q^T q - I| (f32 rounding of q)
NN_INIT_VALUES = {    # deterministic initializers: the card's parameter equals the CPU's
    "Constant": lambda I: I.Constant(0.25), "constant": lambda I: I.constant(-1.0),
    "Assign": lambda I: I.Assign(np.arange(24, dtype=np.float32).reshape(4, 6)),
    "Dirac": lambda I: I.Dirac(groups=2), "Bilinear": lambda I: I.Bilinear(),
}


def _nn_init_check(P, name):
    """An initializer through create_parameter on the card: device, dtype,
    shape; values equal to the CPU's (deterministic ones), or moments within
    5 standard errors, bounds and the same draws after ``seed`` (random
    ones); Orthogonal by orthonormality; set_global_initializer by the bias
    it gives."""
    I = P.nn.initializer

    def param(make, shape, dev):
        P.set_device(dev)
        return P.create_parameter(shape, attr=P.ParamAttr(initializer=make(I))).detach()

    if name in NN_INIT_VALUES:
        shape = (4, 6, 3, 3) if name in ("Dirac", "Bilinear") else (4, 6)
        got = param(NN_INIT_VALUES[name], shape, "gpu")
        want = param(NN_INIT_VALUES[name], shape, "cpu")
        if got.device.type != "cuda":
            raise AssertionError(f"tensor_api nn.initializer.{name}: on {got.device}")
        return _tensor_api_close(f"nn.initializer.{name}", got.cpu(), want)
    if name == "set_global_initializer":
        I.set_global_initializer(I.Constant(0.5), I.Constant(0.3))
        try:
            P.set_device("gpu")
            b = P.create_parameter([7], is_bias=True)
            w = P.create_parameter([2, 3])
        finally:
            I.set_global_initializer(None)
        if not (bool((b == 0.3).all()) and bool((w == 0.5).all()) and b.is_cuda):
            raise AssertionError(f"tensor_api set_global_initializer: {b} {w}")
        return 0.0
    if name == "Orthogonal":
        for shape in ((64, 256), (256, 64)):
            q = param(lambda I: I.Orthogonal(), shape, "gpu").double()
            gram = q.T @ q if shape[0] >= shape[1] else q @ q.T
            err = (gram.cpu() - torch.eye(min(shape), dtype=torch.float64)).abs().max().item()
            if not (q.is_cuda and err < NN_ORTHO_TOL):
                raise AssertionError(f"tensor_api Orthogonal {shape}: |q^T q - I| {err}")
        return 0.0
    if name == "Initializer":
        return 0.0 if issubclass(I.Normal, I.Initializer) else 1.0
    make, shape, mean, std, bound = NN_INIT_MOMENTS[name]
    P.seed(2024)
    a = param(make, shape, "gpu")
    P.seed(2024)
    b = param(make, shape, "gpu")
    if a.device.type != "cuda" or a.dtype != torch.float32 or tuple(a.shape) != shape:
        raise AssertionError(f"tensor_api nn.initializer.{name}: {a.device} {a.dtype} "
                             f"{tuple(a.shape)}")
    if not torch.equal(a, b):
        raise AssertionError(f"tensor_api nn.initializer.{name}: draws differ after seed")
    x, n = a.double(), a.numel()
    if abs(x.mean().item() - mean) > 5 * std / n ** 0.5 or \
            abs(x.std().item() / std - 1) > 5 * (0.5 / n) ** 0.5 * 2 or \
            (bound is not None and x.abs().max().item() > bound + 1e-6):
        raise AssertionError(f"tensor_api nn.initializer.{name}: mean {x.mean().item()} std "
                             f"{x.std().item()} against {mean}, {std}")
    return 0.0


def _nn_utils_check(P, name):
    """nn.utils on a Linear (5 -> 3) built on the CPU and its copy on the
    card: outputs, the normalized weights and vectors against the CPU's."""
    import copy

    U = P.nn.utils
    P.set_device("cpu")
    torch.manual_seed(0)
    cpu = P.nn.Linear(5, 3)
    x = torch.from_numpy(_arr(np.random.RandomState(0), (4, 5)))
    if name in ("weight_norm", "remove_weight_norm"):
        U.weight_norm(cpu, dim=0)
    elif name == "spectral_norm":
        U.spectral_norm(cpu, n_power_iterations=2)
    card = copy.deepcopy(cpu).cuda()
    if name == "remove_weight_norm":
        U.remove_weight_norm(cpu)
        U.remove_weight_norm(card)
    if name in ("parameters_to_vector", "vector_to_parameters"):
        vec = torch.arange(18, dtype=torch.float32)
        if name == "vector_to_parameters":
            U.vector_to_parameters(vec, cpu.parameters())
            U.vector_to_parameters(vec.cuda(), card.parameters())
        return _tensor_api_close(name, U.parameters_to_vector(card.parameters()).detach().cpu(),
                                 U.parameters_to_vector(cpu.parameters()).detach())
    with torch.no_grad():
        return max(_tensor_api_close(f"nn.utils.{name}", card(x.cuda()).cpu(), cpu(x)),
                   _tensor_api_close(f"nn.utils.{name} weight", card.weight.cpu(), cpu.weight))


def _nn_random_check(P, name):
    """A dropout of this slice (functional or layer, in training) on the card:
    the same mask from the same generator seed, the keep share within 5
    standard errors (whole channels for the 2-D and 3-D forms); and
    class_center_sample's set: every positive, its size, the remap."""
    if name == "nn.functional.class_center_sample":
        P.set_device("gpu")
        P.seed(5)
        label = torch.tensor([7, 2, 7, 19, 2, 0], device="cuda")
        remap, sampled = P.nn.functional.class_center_sample(label, 20, 8)
        s = sampled.tolist()
        if not (remap.is_cuda and len(s) == 8 and s == sorted(set(s))
                and {0, 2, 7, 19} <= set(s) and [s[i] for i in remap.tolist()] == label.tolist()):
            raise AssertionError(f"tensor_api class_center_sample: {s} {remap.tolist()}")
        return
    p, n, c = 0.3, 400, 50
    x = torch.ones(n, c, 2, 2, device="cuda")
    if name.startswith("nn.functional."):
        fn = getattr(P.nn.functional, name.rsplit(".", 1)[1])
        run = lambda s: fn(x if "3d" not in name else x[..., None],  # noqa: E731
                           p, generator=torch.Generator("cuda").manual_seed(s))
    else:
        layer = getattr(P.nn, name.rsplit(".", 1)[1])(p).train()

        def run(s):
            layer.generator = torch.Generator("cuda").manual_seed(s)
            return layer(x if "3D" not in name else x[..., None])
    a, b = run(1), run(1)
    if not (a.is_cuda and torch.equal(a, b)) or torch.equal(a, run(2)):
        raise AssertionError(f"tensor_api {name}: the masks do not follow the generator")
    if "alpha" in name.lower():
        kept = (a == a.max()).double().mean().item()
        units = a.numel()
    else:
        per = (a != 0).reshape(n, c, -1)
        if not bool((per.all(-1) == per.any(-1)).all()):
            raise AssertionError(f"tensor_api {name}: a channel partly dropped")
        kept, units = per.all(-1).double().mean().item(), n * c
    if abs(kept - (1 - p)) > 5 * (p * (1 - p) / units) ** 0.5:
        raise AssertionError(f"tensor_api {name}: kept {kept} against {1 - p}")


def nn_api_cases():
    """The nn API's cases (name, build, kwargs, check): "value",
    "layer", "init", "utils" or "random"."""
    cases = [(n, b, kw, "value") for n, b, kw in _nn_functional_cases()]
    cases += [(n, b, {}, "layer") for n, b in _nn_layer_cases()]
    I = _nn().initializer
    cases += [(f"nn.initializer.{n}", None, {}, "init") for n in I.__all__
              if n != "calculate_gain"]
    cases += [(f"nn.utils.{n}", None, {}, "utils") for n in _nn().utils.__all__]
    cases += [(f"nn.functional.{n}", None, {}, "random")
              for n in ("dropout2d", "dropout3d", "alpha_dropout", "class_center_sample")]
    cases += [(f"nn.{n}", None, {}, "random") for n in ("Dropout2D", "Dropout3D", "AlphaDropout")]
    return cases


def nn_api_names():
    """The nn names the table must cover."""
    nn = _nn()
    return ({f"nn.functional.{n}" for n in NN_FUNCTIONAL_NEW}
            | {f"nn.initializer.{n}" for n in nn.initializer.__all__}
            | {f"nn.utils.{n}" for n in nn.utils.__all__}
            | {f"nn.{n}" for n in NN_LAYERS_NEW})


def tensor_api_namespace_names():
    """The functions the table must cover: the op namespace and the top
    level's in-place helpers."""
    from paddle_tpu_torch import ops

    return set(ops.__all__) | {"tanh_", "squeeze_", "unsqueeze_", "scatter_", "tolist"}


def run_tensor_api_table(P=None):
    """Every case of ``tensor_api_cases`` and ``nn_api_cases`` on the card
    against the CPU; returns {"cases": n, "max_abs_err": largest value
    difference}. Raises when a function of the namespace has no case, or a
    case disagrees."""
    if P is None:
        import paddle_tpu_torch as P
    cases = tensor_api_cases() + nn_api_cases()
    names = tensor_api_namespace_names() | nn_api_names()
    missing = names - {c[0] for c in cases}
    if missing:
        raise AssertionError(f"tensor_api: no case for {sorted(missing)}")
    place = P.get_place()
    worst = 0.0
    case_s = {}
    try:
        for i, (name, build, kwargs, check) in enumerate(cases):
            t = time.perf_counter()
            if check == "value":
                got = _tensor_api_call(P, name, build, kwargs, "cuda", i)
                want = _tensor_api_call(P, name, build, kwargs, "cpu", i)
                worst = max(worst, _tensor_api_close(name, got, want))
            elif check == "decomposition":
                _decomposition_check(P, name, build, i)
            elif check == "layer":
                worst = max(worst, _nn_layer_check(P, name, build, i))
            elif check == "init":
                worst = max(worst, _nn_init_check(P, name.rsplit(".", 1)[1]))
            elif check == "utils":
                worst = max(worst, _nn_utils_check(P, name.rsplit(".", 1)[1]))
            elif name.startswith("nn."):
                _nn_random_check(P, name)
            else:
                _random_check(P, name)
            case_s[f"{name}-{i}"] = time.perf_counter() - t
    finally:
        P.set_device(place)
    slowest = dict(sorted(case_s.items(), key=lambda kv: -kv[1])[:8])
    return {"cases": len(cases), "max_abs_err": worst, "slowest_s": slowest}


def _block_run(P, block, params, x, w, heads, ctx, namespace):
    """Forward and the gradients of sum(out * w) w.r.t. x and every
    parameter: the namespace's block (gradients by ``P.grad``), or
    GPTBlock.forward (by torch.autograd)."""
    with ctx():
        out = tensor_api_block(P, x, params, heads) if namespace else block(x)
    loss = (out.float() * w).sum()
    grad = P.grad if namespace else torch.autograd.grad
    return out, grad(loss, [x, *params.values()])


def phase_tensor_api():
    """The ported tensor API on the card: the namespace table against the
    CPU, then GPT-2 124M's block 0 written in the namespace against
    GPTBlock.forward at f32 and under bf16 auto_cast O1."""
    import contextlib as _ctx

    import paddle_tpu_torch as P
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.bench import card_name_and_power_limit
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    t0 = time.perf_counter()
    table = run_tensor_api_table(P)
    table_s = time.perf_counter() - t0

    t_model = time.perf_counter()
    cfg = GPTConfig()
    model = GPTForPretraining(cfg, seed=0)
    block = model.gpt.blocks[0].eval()
    params = dict(block.named_parameters())
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen).cuda()
    with torch.no_grad():
        x0 = model.gpt.wte(ids) + model.gpt.wpe(torch.arange(1024, device="cuda"))
    del model
    model_s = time.perf_counter() - t_model
    w = torch.from_numpy(np.random.RandomState(1).standard_normal((8, 1024, 768))
                         .astype(np.float32)).cuda()
    recs, launches = {}, {}
    for dtype, ctx, tol in (("float32", _ctx.nullcontext, BLOCK_F32_TOL),
                            ("bfloat16_O1", lambda: auto_cast(dtype="bfloat16"), BLOCK_BF16_TOL)):
        x = x0.clone().requires_grad_(True)
        ns_out, ns_grads = _block_run(P, block, params, x, w, cfg.num_heads, ctx, True)
        _reset_launch_counts()
        ref_out, ref_grads = _block_run(P, block, params, x, w, cfg.num_heads, ctx, False)
        torch.cuda.synchronize()
        launches[dtype] = _launch_counts()
        route = "tf32x3" if dtype == "float32" else "mma"
        if launches[dtype] != {"flash_attention_fwd": 1, "flash_attention_bwd_dkdv": 1,
                               "flash_attention_bwd_dq": 1} or \
                fa.launches_by_route[route] != 1 or fa.launches_bwd_by_route[route]["dq"] != 1:
            raise AssertionError(f"tensor_api {dtype}: GPTBlock launched {launches[dtype]}, "
                                 f"{dict(fa.launches_by_route)}, expected one {route} each")
        if ns_out.dtype != ref_out.dtype or not torch.isfinite(ns_out).all():
            raise AssertionError(f"tensor_api {dtype}: block out {ns_out.dtype} against "
                                 f"GPTBlock's {ref_out.dtype}")
        errs = {"out": rel_frob(ns_out, ref_out)}
        for name, g, r in zip(["x", *params], ns_grads, ref_grads):
            errs["d" + name] = rel_frob(g, r)
        bad = {k: e for k, e in errs.items() if not e <= tol}
        if bad:
            raise AssertionError(f"tensor_api {dtype}: relative Frobenius errors past {tol}: "
                                 f"{bad}")
        ns_ms = cuda_ms(lambda: _block_run(P, block, params, x, w, cfg.num_heads, ctx, True),
                        iters=5)
        ref_ms = cuda_ms(lambda: _block_run(P, block, params, x, w, cfg.num_heads, ctx, False),
                         iters=5)
        recs[dtype] = {"namespace_fwd_bwd_ms": ns_ms, "gptblock_fwd_bwd_ms": ref_ms,
                       "max_rel_frob": max(errs.values()), "rel_frob": errs, "tol": tol,
                       "out_dtype": str(ns_out.dtype)}
    seconds = time.perf_counter() - t0
    emit(phase="tensor_api", card=card_name_and_power_limit(), table=table, table_s=table_s,
         model_s=model_s,
         block={"model": "gpt2-124m block 0", "x": [8, 1024, 768], "heads": cfg.num_heads,
                **recs}, launches=launches, seconds=seconds)
    if seconds > TENSOR_API_MAX_S:
        raise AssertionError(f"tensor_api took {seconds:.1f} s, past {TENSOR_API_MAX_S} s")
    del block, params, x0, w
    torch.cuda.empty_cache()
    return {"float32": launches["float32"], "bf16": launches["bfloat16_O1"]}


# ---- phase nn_transformer: nn.TransformerEncoder at ERNIE-3.0-base width ----

NN_TF_WIDTH = (768, 12, 3072, 12)   # d_model, heads (head dim 64), dim_feedforward, layers
NN_TF_BATCH = (16, 512)             # the bf16 step's [batch, seq]
NN_TF_CPU_BATCH = (2, 512)          # the f32 card-vs-CPU check's
NN_TF_F32_TOL = 1e-4    # card (the 3xTF32 flash pair, f32 products, TF32 off) vs the CPU
                        # (the dense path) and vs the module in f64 on the card, f32,
                        # 12 post-norm layers: the output and each gradient of
                        # sum(out * w) in relative Frobenius norm, leaf by leaf (sums
                        # in other orders read ~1e-6; a dropped term or scale is off
                        # by O(1)), plus NN_TF_F32_COND times the CPU's own error
                        # against f64 at that leaf
NN_TF_F32_COND = 10     # ... the top layers' q and k gradients pass the softmax's
                        # Jacobian 3-4 decades below the value projection's: the
                        # CPU's f32 reads ~3e-4 from f64 there (the phase's
                        # cpu_vs_f64_max), 3xTF32 rounds a few times coarser than FP32.
                        # Set between the least factor that passes 3xTF32 and those
                        # that pass the kernels cut to two terms or one TF32 pass
                        # (python -m paddle_tpu_torch.tools.nn_transformer_control;
                        # both readings in PERF.md, PR 29)
NN_TF_ZERO_TOL = 1e-2   # the k projection's bias, whose exact gradient is 0 (softmax
                        # ignores a constant a query row): its norm on the card
                        # against the q bias's
NN_TF_BF16_TOL = 3e-2   # the bf16 O1 output against the card's f32 output, relative
                        # Frobenius (bf16 products and P rounded to bf16, 12 layers)
NN_TF_SMALL_TOL = 1e-4  # the masked MultiHeadAttention and the 2 + 2 layer Transformer,
                        # card vs CPU, f32, relative Frobenius
NN_TF_MAX_S = 40        # the phase's wall seconds


def _nn_transformer_model(P, layers=NN_TF_WIDTH[3]):
    """The phase's encoder on the CPU: gelu, post-norm, no dropout; every
    layer a copy of the first (as nn.TransformerEncoder makes them), its
    Linear weights XavierNormal and biases Normal(0, 0.02) from
    nn.initializer after seed(0)."""
    d, heads, ff, _ = NN_TF_WIDTH
    P.set_device("cpu")
    P.seed(0)
    I = P.nn.initializer
    layer = P.nn.TransformerEncoderLayer(
        d, heads, ff, dropout=0.0, activation="gelu", normalize_before=False,
        weight_attr=P.ParamAttr(initializer=I.XavierNormal()),
        bias_attr=P.ParamAttr(initializer=I.Normal(0.0, 0.02)))
    return P.nn.TransformerEncoder(layer, layers)


def _nn_fwd_bwd(model, x, w):
    out = model(x)
    loss = (out.float() * w).sum()
    return out, torch.autograd.grad(loss, [x, *model.parameters()])


def nn_transformer_f32_runs(cpu_model, model):
    """The phase's f32 runs at NN_TF_CPU_BATCH, on inputs from seed 0: the
    output and every gradient of sum(out * w) of ``cpu_model`` (the dense
    path), of its copy in f64 on the card (the dense path) and of ``model``,
    its copy on the card (the 3xTF32 flash forward and pair). Returns
    {"names", "card", "cpu", "f64": the tensors by name, "launches" and
    "routes": the flash launches of the card's run, "cpu_s"}."""
    import copy

    rng = np.random.RandomState(0)
    b, s = NN_TF_CPU_BATCH
    x_np = rng.standard_normal((b, s, NN_TF_WIDTH[0])).astype(np.float32)
    w_np = rng.standard_normal((b, s, NN_TF_WIDTH[0])).astype(np.float32)
    t = time.perf_counter()
    ref = _nn_fwd_bwd(cpu_model, torch.from_numpy(x_np).requires_grad_(True),
                      torch.from_numpy(w_np))
    cpu_s = time.perf_counter() - t
    model64 = copy.deepcopy(cpu_model).double().cuda()
    ref64 = _nn_fwd_bwd(model64, torch.from_numpy(x_np).double().cuda().requires_grad_(True),
                        torch.from_numpy(w_np).double().cuda())
    del model64
    _reset_launch_counts()
    got = _nn_fwd_bwd(model, torch.from_numpy(x_np).cuda().requires_grad_(True),
                      torch.from_numpy(w_np).cuda())
    torch.cuda.synchronize()
    return {"names": ["out", "dx"] + [f"d{k}" for k, _ in model.named_parameters()],
            "card": [got[0], *got[1]], "cpu": [ref[0], *ref[1]], "f64": [ref64[0], *ref64[1]],
            "launches": _launch_counts(), "routes": _route_counts(), "cpu_s": cpu_s}


def nn_tf_f32_readings(runs):
    """{leaf: (card vs CPU, CPU vs f64, card vs f64)} in relative Frobenius
    norm, for the output and each gradient of ``nn_transformer_f32_runs``
    but the k projections' biases (exactly 0: nn_grad_errors holds them by
    their size)."""
    return {k: (rel_frob(g, c.to(g.device)), rel_frob(c.to(r.device), r), rel_frob(g, r))
            for k, g, c, r in zip(runs["names"], runs["card"], runs["cpu"], runs["f64"])
            if not k.endswith("k_proj.bias")}


def nn_tf_f32_past(readings):
    """The leaves whose card error, against the CPU or against f64, is past
    NN_TF_F32_TOL + NN_TF_F32_COND x the CPU's own error against f64."""
    return {k: r for k, r in readings.items()
            if not max(r[0], r[2]) <= NN_TF_F32_TOL + NN_TF_F32_COND * r[1]}


def nn_tf_f32_summary(readings):
    """The worst leaf of each reading, and the least headroom: the largest
    card error over its limit."""
    def ratio(r):
        return max(r[0], r[2]) / (NN_TF_F32_TOL + NN_TF_F32_COND * r[1])

    worst = max(readings, key=lambda k: readings[k][0])
    tight = max(readings, key=lambda k: ratio(readings[k]))
    return {"max_rel_frob": readings[worst][0], "worst": worst,
            "out_rel_frob": readings["out"][0],
            "cpu_vs_f64_max": max(r[1] for r in readings.values()),
            "card_vs_f64_max": max(r[2] for r in readings.values()),
            "tightest": tight, "tightest_of_limit": ratio(readings[tight]),
            "tol": [NN_TF_F32_TOL, NN_TF_F32_COND]}


def phase_nn_transformer():
    """nn.TransformerEncoder at ERNIE-3.0-base width through the flash
    kernels (phase docstring item 16). Returns the flash launches of its
    bf16 step and of its f32 runs: {"bf16": {kernel: n}, "f32": {kernel: n}}."""
    import copy

    import paddle_tpu_torch as P
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.bench import card_name_and_power_limit

    t0 = time.perf_counter()
    card = card_name_and_power_limit()
    place = P.get_place()
    n = NN_TF_WIDTH[3]
    try:
        cpu_model = _nn_transformer_model(P)
        model = copy.deepcopy(cpu_model).cuda()
        build_s = time.perf_counter() - t0
        # f32, [2, 512]: the card (3xTF32 flash forward and pair) against the CPU
        runs = nn_transformer_f32_runs(cpu_model, model)
        del cpu_model
        f32_launches = runs["launches"]
        _check_route_launches("nn_transformer f32 vs cpu", *runs["routes"], n, n, "tf32x3")
        nn_grad_errors(runs["names"], runs["card"], runs["cpu"])    # the k biases' size
        readings, cpu_s = nn_tf_f32_readings(runs), runs["cpu_s"]
        bad = nn_tf_f32_past(readings)
        if bad or not bool(torch.isfinite(runs["card"][0]).all()):
            raise AssertionError(f"nn_transformer f32 card vs CPU or f64 past {NN_TF_F32_TOL} "
                                 f"+ {NN_TF_F32_COND} x the CPU's own error: {bad}")
        del runs
        # bf16 O1 at [16, 512]: the main path's step, 12 launches of each flash kernel
        b, s = NN_TF_BATCH
        g = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(b, s, NN_TF_WIDTH[0], device="cuda", generator=g)
        w = torch.randn(b, s, NN_TF_WIDTH[0], device="cuda", generator=g)
        with torch.no_grad():
            out_f32 = model(x)
        xg = x.clone().requires_grad_(True)

        def step():
            with auto_cast(dtype="bfloat16"):
                return _nn_fwd_bwd(model, xg, w)

        _reset_launch_counts()
        out_bf16, grads = step()
        torch.cuda.synchronize()
        bf16_launches, bf16_routes = _launch_counts(), _route_counts()
        _check_route_launches("nn_transformer bf16 step", *bf16_routes, n, n, "mma")
        # post-norm: the last op is LayerNorm, black-listed under O1, so the
        # output is f32 (as in the JAX package)
        bf16_err, out_dtype = rel_frob(out_bf16, out_f32), str(out_bf16.dtype)
        if not bf16_err <= NN_TF_BF16_TOL or not all(bool(torch.isfinite(q).all())
                                                     for q in grads):
            raise AssertionError(f"nn_transformer bf16: out {out_dtype}, {bf16_err} "
                                 f"against the f32 output (tol {NN_TF_BF16_TOL})")
        del out_bf16, grads
        bf16_ms = cuda_ms(step, iters=5)
        with torch.no_grad():
            f32_fwd_ms = cuda_ms(lambda: model(x), iters=3)
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del model, x, w, xg, out_f32
        gc.collect()
        torch.cuda.empty_cache()
        small = _nn_transformer_small(P)
    finally:
        P.set_device(place)
    tokens = b * s
    seconds = time.perf_counter() - t0
    emit(phase="nn_transformer", card=card, model="TransformerEncoder d768 h12 ff3072 L12 "
         "gelu post-norm", batch=[b, s], f32_vs_cpu={
             "batch": list(NN_TF_CPU_BATCH), **nn_tf_f32_summary(readings),
             "cpu_s": cpu_s},
         bf16={"fwd_bwd_ms": bf16_ms, "tokens_per_s": tokens / (bf16_ms / 1e3),
               "out_rel_frob_vs_f32": bf16_err, "tol": NN_TF_BF16_TOL,
               "out_dtype": out_dtype, "peak_bytes": peak},
         f32_fwd_ms=f32_fwd_ms, launches={"bf16": bf16_launches, "f32": f32_launches},
         small=small, build_s=build_s, seconds=seconds)
    print(f"nn_transformer: TransformerEncoder at ERNIE-3.0-base width [{b}, {s}] bf16 O1 "
          f"{bf16_ms:.2f} ms forward + backward ({tokens / (bf16_ms / 1e3):.0f} tokens/s), "
          f"f32 forward {f32_fwd_ms:.2f} ms ({card})", flush=True)
    if seconds > NN_TF_MAX_S:
        raise AssertionError(f"nn_transformer took {seconds:.1f} s, past {NN_TF_MAX_S} s")
    return {"bf16": bf16_launches, "f32": f32_launches}


def _nn_transformer_small(P):
    """One MultiHeadAttention with a boolean key-padding mask (the dense
    route: no flash launch) and one nn.Transformer of 2 + 2 layers with
    generate_square_subsequent_mask (its encoder through the 3xTF32 flash
    kernels, seq 256), f32, card against the CPU: outputs and gradients in
    relative Frobenius norm (NN_TF_SMALL_TOL). Returns the errors."""
    import copy

    rng = np.random.RandomState(3)
    d, heads = 256, 4
    P.set_device("cpu")
    torch.manual_seed(0)
    mha = P.nn.MultiHeadAttention(d, heads)
    tfm = P.nn.Transformer(d, heads, 2, 2, 512, dropout=0.0)
    q = torch.from_numpy(rng.standard_normal((2, 200, d)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 256, d)).astype(np.float32))
    keep = torch.ones(2, 1, 1, 256, dtype=torch.bool)
    keep[1, ..., 180:] = False
    src = torch.from_numpy(rng.standard_normal((2, 256, d)).astype(np.float32))
    tgt = torch.from_numpy(rng.standard_normal((2, 64, d)).astype(np.float32))
    errs = {}
    for what, model, args in (("mha_bool_mask", mha, (q, kv, kv, keep)),
                              ("transformer_2_2", tfm, (src, tgt))):
        names, ref = _nn_small_run(model, args, None)
        _reset_launch_counts()
        _, got = _nn_small_run(copy.deepcopy(model).cuda(), [a.cuda() for a in args],
                               P.nn.Transformer.generate_square_subsequent_mask(64, "cuda"))
        torch.cuda.synchronize()
        launches = _launch_counts()
        want_fwd = 0 if what == "mha_bool_mask" else 2      # the encoder's two layers
        if launches != {"flash_attention_fwd": want_fwd, "flash_attention_bwd_dkdv": want_fwd,
                        "flash_attention_bwd_dq": want_fwd}:
            raise AssertionError(f"nn_transformer {what}: launches {launches}")
        errs[what] = max(nn_grad_errors(names, got, ref).values())
        if not errs[what] <= NN_TF_SMALL_TOL:
            raise AssertionError(f"nn_transformer {what}: card vs CPU {errs[what]} past "
                                 f"{NN_TF_SMALL_TOL}")
    return errs


def nn_grad_errors(names, got, ref):
    """Relative Frobenius errors of ``got`` against ``ref`` by name; a k
    projection's bias, whose exact gradient is 0, is held instead by its
    norm, at most NN_TF_ZERO_TOL of the q projection's bias gradient."""
    errs = {}
    for k, g, r in zip(names, got, ref):
        if k.endswith("k_proj.bias"):
            dq = got[names.index(k.replace("k_proj", "q_proj"))]
            if not g.norm().item() <= NN_TF_ZERO_TOL * dq.norm().item():
                raise AssertionError(f"nn_transformer {k}: |grad| {g.norm().item()} against "
                                     f"the q bias's {dq.norm().item()}")
            continue
        errs[k] = rel_frob(g, r.to(g.device))
    return errs


def _nn_small_run(model, args, tgt_mask):
    """(names, [output and gradients of sum(out * sin)]) over the inputs and
    the parameters; the Transformer gets its square subsequent mask (on the
    CPU when None)."""
    import paddle_tpu_torch as P

    args = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    if isinstance(model, P.nn.Transformer):
        mask = tgt_mask if tgt_mask is not None else \
            P.nn.Transformer.generate_square_subsequent_mask(args[1].shape[1], "cpu")
        out = model(args[0], args[1], None, mask)
    else:
        out = model(*args)
    w = torch.sin(torch.arange(out.numel(), device=out.device, dtype=out.dtype)).reshape(
        out.shape)
    leaves = [a for a in args if a.requires_grad] + list(model.parameters())
    names = ["out"] + [f"d{i}" for i, a in enumerate(args) if a.requires_grad] + [
        f"d{k}" for k, _ in model.named_parameters()]
    return names, [out.detach(), *torch.autograd.grad((out * w).sum(), leaves)]


# ---- phase text: RNNs, beam search, Viterbi and the tokenizer at published widths ----

TEXT_S2S = dict(src_vocab=17191, trg_vocab=7709, hidden=512, layers=2, dropout=0.2,
                init=0.1)   # PaddleNLP examples/machine_translation/seq2seq (IWSLT'15 en-vi)
TEXT_S2S_BATCH = 128
TEXT_S2S_LENS = (10, 50)    # source and target lengths, drawn from RandomState(0)
TEXT_S2S_STEPS = (2, 5)     # warm-up and timed f32 steps
TEXT_BEAM = (10, 50)        # beam_size, max_step_num
TEXT_S2S_CPU = (4, 12)      # the card-vs-CPU check: batch, longest length (dropout off)
TEXT_LOSS_RTOL = 1e-5       # card vs CPU: the loss (TRAIN_LOSS_RTOL)
TEXT_GRAD_TOL = 1e-3        # ... each gradient, times max|g| of that tensor (TRAIN_GRAD_TOL:
                            # f32 sums in other orders through 12 steps of two LSTMs and
                            # the attention; a wrong gradient is off by O(1))
TEXT_SCORE_TOL = 1e-4       # ... each beam's score before the first parting, times
                            # max(1, |score|)
TEXT_NEAR_TIE = 2e-3        # ... where the beam ids part, the parting beams' scores lie this
                            # close to another beam's (serve_spec's near-tie)
TEXT_BF16_RTOL = 2e-2       # the bf16 O1 loss against f32's, same weights, batch and masks
TEXT_TAGGER = dict(vocab=5000, emb=128, hidden=128, layers=2, tags=69, batch=256)
TEXT_TAGGER_TOL = 1e-5      # card vs CPU: the tagger's emissions, times max(1, max|ref|)
TEXT_VITERBI_TOL = 1e-5     # card vs CPU Viterbi scores on the same emissions, times
                            # max(1, max|ref|); the paths equal
TEXT_YARDSTICK = (128, 50, 512)   # the loop LSTM against cuDNN's: [batch, steps, hidden]
TEXT_TOK = dict(vocab=40000, sentences=1024, rows=16, max_seq_len=512)
TEXT_ERNIE_BF16_TOL = 3e-2  # ERNIE-3.0-base's bf16 O1 hidden states against f32's, relative
                            # Frobenius (NN_TF_BF16_TOL)
TEXT_MAX_S = 40             # the phase's wall seconds


def text_seq2seq(P, cfg=None):
    """PaddleNLP's seq2seq with attention (Seq2SeqAttnModel) on the port, on
    the CPU: source and target embeddings, a ``layers``-deep nn.LSTM
    encoder, an nn.RNN decoder over a user cell (input feeding, stacked
    LSTMCells, dot attention over the encoder outputs masked by the source
    lengths), Linear(hidden, trg_vocab); every weight Uniform(-init, init)
    through a ParamAttr, drawn after seed(0). ``encode(src, src_len)`` ->
    (encoder outputs, decoder states, mask); ``forward(src, src_len, trg)``
    -> logits."""
    cfg = cfg or TEXT_S2S
    nn, F = P.nn, P.nn.functional
    H, L, drop = cfg["hidden"], cfg["layers"], cfg["dropout"]

    def attr():
        return P.ParamAttr(initializer=nn.initializer.Uniform(-cfg["init"], cfg["init"]))

    def rnn_attrs():
        return dict(weight_ih_attr=attr(), weight_hh_attr=attr(), bias_ih_attr=attr(),
                    bias_hh_attr=attr())

    class AttentionCell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.dropout = nn.Dropout(drop)
            self.lstm_cells = nn.LayerList([nn.LSTMCell(2 * H if i == 0 else H, H,
                                                        **rnn_attrs()) for i in range(L)])
            self.input_proj = nn.Linear(H, H, attr(), bias_attr=False)
            self.output_proj = nn.Linear(2 * H, H, attr(), bias_attr=False)

        def forward(self, step_input, states, encoder_output, encoder_padding_mask):
            lstm_states, input_feed = states
            x, new_states = torch.cat([step_input, input_feed], 1), []
            for cell, st in zip(self.lstm_cells, lstm_states):
                out, new = cell(x, st)
                x = self.dropout(out)
                new_states.append(new)
            keys = self.input_proj(encoder_output)
            scores = P.matmul(x.unsqueeze(1), keys, transpose_y=True) + encoder_padding_mask
            ctx = P.matmul(F.softmax(scores), keys).squeeze(1)
            out = self.output_proj(torch.cat([ctx, x], 1))
            return out, [new_states, out]

    class Seq2SeqAttn(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(cfg["src_vocab"], H, weight_attr=attr())
            self.encoder = nn.LSTM(H, H, L, dropout=drop, **rnn_attrs())
            self.trg_emb = nn.Embedding(cfg["trg_vocab"], H, weight_attr=attr())
            self.decoder = nn.RNN(AttentionCell())
            self.output_layer = nn.Linear(H, cfg["trg_vocab"], attr(), bias_attr=False)

        def encode(self, src, src_len):
            enc, (h, c) = self.encoder(self.src_emb(src), sequence_length=src_len)
            states = [[(h[i], c[i]) for i in range(L)],
                      self.decoder.cell.get_initial_states(enc, shape=[H])]
            keep = F.sequence_mask(src_len, src.shape[1], dtype="float32")
            return enc, states, ((keep - 1.0) * 1e9).unsqueeze(1)

        def forward(self, src, src_len, trg):
            enc, states, mask = self.encode(src, src_len)
            out, _ = self.decoder(self.trg_emb(trg), states, encoder_output=enc,
                                  encoder_padding_mask=mask)
            return self.output_layer(out)

    place = P.get_place()
    try:
        P.set_device("cpu")
        P.seed(0)
        return Seq2SeqAttn()
    finally:
        P.set_device(place)


def text_s2s_batch(rng, batch, lens, cfg=None, device="cpu"):
    """(src, src_len, trg_in, label, trg_len): lengths drawn in [lens[0],
    lens[1]], tokens from 3 up (0 is <s>, 1 </s>), each target ending in
    </s>, padding 0."""
    cfg = cfg or TEXT_S2S
    lo, hi = lens
    src_len = rng.randint(lo, hi + 1, batch)
    trg_len = rng.randint(lo, hi + 1, batch)
    src = rng.randint(3, cfg["src_vocab"], (batch, src_len.max()))
    label = rng.randint(3, cfg["trg_vocab"], (batch, trg_len.max()))
    for i in range(batch):
        src[i, src_len[i]:] = 0
        label[i, trg_len[i] - 1] = 1
        label[i, trg_len[i]:] = 0
    trg_in = np.concatenate([np.zeros((batch, 1), np.int64), label[:, :-1]], 1)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)
                 for a in (src, src_len, trg_in, label, trg_len))


def text_s2s_loss(P, model, batch):
    """PaddleNLP's CrossEntropyCriterion: per-token cross entropy, padded
    tokens masked out, the batch mean summed over time."""
    src, src_len, trg_in, label, trg_len = batch
    logits = model(src, src_len, trg_in)
    ce = P.nn.functional.cross_entropy(logits, label, reduction="none").squeeze(-1)
    mask = P.nn.functional.sequence_mask(trg_len, label.shape[1], dtype="float32")
    return (ce * mask).mean(0).sum()


def text_beam_decode(P, model, src, src_len, beam, max_steps):
    """Beam search over ``model``'s decoder cell (BeamSearchDecoder with the
    target embedding and the output layer, dynamic_decode): (ids [N, T,
    beam], the raw per-step (scores, tokens, parents) [T, N, beam], steps,
    the ms of finalize: gather_tree's walk on the host)."""
    with torch.no_grad():
        enc, states, mask = model.encode(src, src_len)
        dec = P.nn.BeamSearchDecoder(model.decoder.cell, start_token=0, end_token=1,
                                     beam_size=beam, embedding_fn=model.trg_emb,
                                     output_fn=model.output_layer)
        raw = {}
        finalize = dec.finalize

        def keep(outputs, final_states, lengths):
            raw["out"] = outputs
            t = time.perf_counter()
            try:
                return finalize(outputs, final_states, lengths)
            finally:
                raw["finalize_ms"] = (time.perf_counter() - t) * 1e3

        dec.finalize = keep
        ids, _ = P.nn.dynamic_decode(dec, inits=states, max_step_num=max_steps,
                                     encoder_output=enc.repeat_interleave(beam, 0),
                                     encoder_padding_mask=mask.repeat_interleave(beam, 0))
    return ids, raw["out"], ids.shape[1], raw["finalize_ms"]


def text_beams_agree(card, cpu):
    """The raw beam outputs of the card and the CPU ([T, N, beam] scores,
    tokens, parents): per batch row, tokens and parents equal up to the
    first step where they part, the scores before it within TEXT_SCORE_TOL;
    at that step the parting beams' CPU scores within TEXT_NEAR_TIE of
    another beam's. Returns {"parted_rows", "first_parting_steps",
    "max_score_err"}; raises past a limit."""
    steps = min(len(card.scores), len(cpu.scores))
    s_card, s_cpu = card.scores[:steps].cpu().numpy(), cpu.scores[:steps].cpu().numpy()
    same = ((card.predicted_ids[:steps].cpu() == cpu.predicted_ids[:steps].cpu())
            & (card.parent_ids[:steps].cpu() == cpu.parent_ids[:steps].cpu())).numpy()
    parted, first, err = [], [], 0.0
    for n in range(s_cpu.shape[1]):
        bad = np.argwhere(~same[:, n])
        t = int(bad[0][0]) if len(bad) else steps
        if t:
            e = np.abs(s_card[:t, n] - s_cpu[:t, n]) / np.maximum(1.0, np.abs(s_cpu[:t, n]))
            err = max(err, float(e.max()))
        if len(bad):
            beams = sorted({int(b) for tt, b in bad if tt == t})
            s = s_cpu[t, n]
            gap = min(abs(s[b] - s[c]) for b in beams for c in range(len(s)) if c != b)
            if not gap <= TEXT_NEAR_TIE:
                raise AssertionError(f"text beams: row {n} parts at step {t} (beams {beams}) "
                                     f"with a score gap {gap} past {TEXT_NEAR_TIE}")
            parted.append(n)
            first.append(t)
    if not err <= TEXT_SCORE_TOL:
        raise AssertionError(f"text beams: scores card vs CPU {err} past {TEXT_SCORE_TOL}")
    return {"parted_rows": parted, "first_parting_steps": first, "max_score_err": err,
            "steps": [len(card.scores), len(cpu.scores)]}


def text_s2s_vs_cpu(P, cpu_model, model):
    """The card copy against the CPU model, eval (no dropout), f32, at
    TEXT_S2S_CPU: the loss (TEXT_LOSS_RTOL), every gradient (TEXT_GRAD_TOL
    x max|g|) and the beams (text_beams_agree). Returns the readings."""
    b, longest = TEXT_S2S_CPU
    batch = text_s2s_batch(np.random.RandomState(1), b, (3, longest))
    cpu_model.eval()
    model.eval()
    try:
        l_cpu = text_s2s_loss(P, cpu_model, batch)
        g_cpu = torch.autograd.grad(l_cpu, list(cpu_model.parameters()))
        dev_batch = tuple(t.to(next(model.parameters()).device) for t in batch)
        l_card = text_s2s_loss(P, model, dev_batch)
        g_card = torch.autograd.grad(l_card, list(model.parameters()))
        loss_err = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
        grad_err = {}
        for (name, _), gc, gd in zip(cpu_model.named_parameters(), g_cpu, g_card):
            grad_err[name] = (gd.cpu() - gc).abs().max().item() / gc.abs().max().item()
        worst = max(grad_err, key=grad_err.get)
        if not loss_err <= TEXT_LOSS_RTOL or not grad_err[worst] <= TEXT_GRAD_TOL:
            raise AssertionError(f"text seq2seq card vs CPU: loss {loss_err} (tol "
                                 f"{TEXT_LOSS_RTOL}), gradient {worst} {grad_err[worst]} "
                                 f"(tol {TEXT_GRAD_TOL} x max|g|)")
        beam = TEXT_BEAM[0]
        raw_cpu = text_beam_decode(P, cpu_model, batch[0], batch[1], beam, longest)[1]
        raw_card = text_beam_decode(P, model, dev_batch[0], dev_batch[1], beam, longest)[1]
        beams = text_beams_agree(raw_card, raw_cpu)
    finally:
        cpu_model.train()
        model.train()
    return {"batch": b, "longest": longest, "loss_rel_err": loss_err,
            "max_grad_err_of_max": grad_err[worst], "worst": worst, "beams": beams}


def text_seq2seq_run(P, cpu_model, model, dev):
    """Phase text (a): the card-vs-CPU check, then at TEXT_S2S_BATCH the beam
    search from the initial weights (after training on random targets,
    whose every sentence ends in </s>, the beams end at once), the f32
    training steps (Adam 1e-3, ClipGradByGlobalNorm(5.0), published dropout
    from a seeded generator), the bf16 O1 step and the loop LSTM against
    cuDNN's. Returns the readings."""
    from paddle_tpu_torch.amp import auto_cast

    vs_cpu = text_s2s_vs_cpu(P, cpu_model, model)
    gen = torch.Generator(device=dev)
    model.encoder.generator = model.decoder.cell.dropout.generator = gen
    opt = P.optimizer.Adam(1e-3, parameters=model.parameters(),
                           grad_clip=P.nn.ClipGradByGlobalNorm(5.0))
    batch = text_s2s_batch(np.random.RandomState(0), TEXT_S2S_BATCH, TEXT_S2S_LENS,
                           device=dev)
    tokens = int(batch[4].sum())

    def step():
        loss = text_s2s_loss(P, model, batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    # beam search over the batch's sources from the initial weights, eval
    model.eval()
    beam, max_steps = TEXT_BEAM
    torch.cuda.synchronize()
    t = time.perf_counter()
    ids, raw, steps, finalize_ms = text_beam_decode(P, model, batch[0], batch[1], beam,
                                                    max_steps)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3
    model.train()
    if tuple(ids.shape) != (TEXT_S2S_BATCH, steps, beam) or not bool(
            torch.isfinite(raw.scores).all()) or not bool(((ids >= 0)
                                                           & (ids < TEXT_S2S["trg_vocab"])).all()):
        raise AssertionError(f"text beam search: ids {tuple(ids.shape)}, scores finite "
                             f"{bool(torch.isfinite(raw.scores).all())}")
    del ids, raw
    warm, timed = TEXT_S2S_STEPS
    losses = [step().item() for _ in range(warm)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses += [step() for _ in range(timed)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / timed
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    # bf16 O1 against f32 on the same weights, batch and dropout masks
    gen.manual_seed(7)
    with torch.no_grad():
        l_f32 = text_s2s_loss(P, model, batch).item()
    gen.manual_seed(7)
    with auto_cast(dtype="bfloat16"):
        l_bf16 = step().item()
        with torch.no_grad():
            enc_dtype = model.encode(batch[0], batch[1])[0].dtype
    bf16_err = abs(l_bf16 - l_f32) / abs(l_f32)
    if not (all(math.isfinite(x) for x in losses) and bf16_err <= TEXT_BF16_RTOL
            and enc_dtype == torch.float32):
        raise AssertionError(f"text seq2seq: losses {losses}, bf16 O1 loss {l_bf16} against "
                             f"f32 {l_f32} (tol {TEXT_BF16_RTOL}), encoder outputs {enc_dtype}")
    return {"vs_cpu": vs_cpu, "losses": losses, "step_ms": step_ms,
            "target_tokens_per_s": tokens / (step_ms / 1e3), "target_tokens": tokens,
            "peak_bytes": peak, "bf16_o1_loss": l_bf16, "f32_loss": l_f32,
            "bf16_rel_err": bf16_err, "encoder_out_dtype_o1": "float32",
            "decode": {"beam": beam, "max_step_num": max_steps, "steps": steps,
                       "ms": decode_ms, "ms_per_step": decode_ms / steps,
                       "gather_tree_ms": finalize_ms,
                       "tokens_per_s": TEXT_S2S_BATCH * steps / (decode_ms / 1e3),
                       "select_ms": text_beam_select_ms(dev, beam)},
            "yardstick": text_lstm_yardstick(P, dev)}


def text_beam_select_ms(dev, beam):
    """One step's top-beam selection over [batch, beam * trg_vocab] f32: the
    decoder's stable descending sort against torch.topk."""
    flat = torch.randn(TEXT_S2S_BATCH, beam * TEXT_S2S["trg_vocab"], device=dev,
                       generator=torch.Generator(device=dev).manual_seed(5))
    return {"sort_stable_ms": cuda_ms(lambda: torch.sort(flat, dim=-1, descending=True,
                                                       stable=True), 5, 1),
            "topk_ms": cuda_ms(lambda: torch.topk(flat, beam), 5, 1)}


def text_lstm_yardstick(P, dev, shape=None):
    """The port's loop LSTM (2 layers) forward + backward against
    torch.nn.LSTM (cuDNN on the card) with the same weights, at ``shape``
    [batch, steps, hidden]: ms of each and the outputs' largest difference."""
    n, t, h = shape = shape or TEXT_YARDSTICK
    place = P.get_place()
    try:
        P.set_device("cpu")
        P.seed(2)
        loop = P.nn.LSTM(h, h, 2).to(dev)
    finally:
        P.set_device(place)
    lib = torch.nn.LSTM(h, h, 2, batch_first=True).to(dev)
    with torch.no_grad():
        for k in range(2):
            cell = loop._all_layers[k].cell
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(lib, f"{name}_l{k}").copy_(getattr(cell, name))
    x = torch.randn(n, t, h, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    x.requires_grad_(True)

    def run(m):
        out = m(x)[0]
        out.sum().backward()
        return out

    diff = (run(loop) - run(lib)).abs().max().item()
    return {"shape": list(shape), "layers": 2, "loop_fwd_bwd_ms": cuda_ms(lambda: run(loop), 3, 1),
            "cudnn_fwd_bwd_ms": cuda_ms(lambda: run(lib), 3, 1), "max_abs_diff": diff}


def text_tagger_run(P, dev):
    """Phase text (b): the synthetic Conll05st at its defaults through the
    DataLoader, Embedding -> 2-layer bidirect GRU -> Linear(2 hidden, 69)
    emissions with the sentences' lengths, ViterbiDecoder with BOS / EOS;
    the card against the CPU. Returns the readings."""
    import copy

    cfg = TEXT_TAGGER
    nn = P.nn
    place = P.get_place()
    try:
        P.set_device("cpu")
        P.seed(1)
        cpu_model = nn.Sequential(nn.Embedding(cfg["vocab"], cfg["emb"]),
                                  nn.GRU(cfg["emb"], cfg["hidden"], cfg["layers"],
                                         direction="bidirect"),
                                  nn.Linear(2 * cfg["hidden"], cfg["tags"]))
    finally:
        P.set_device(place)
    model = copy.deepcopy(cpu_model).to(dev).eval()
    cpu_model.eval()
    loader = P.io.DataLoader(P.text.Conll05st(), batch_size=cfg["batch"], device=dev)
    words = next(iter(loader))[0]
    rng = np.random.RandomState(2)
    lengths = torch.from_numpy(rng.randint(1, words.shape[1] + 1, words.shape[0]))
    trans = torch.from_numpy(rng.standard_normal((cfg["tags"], cfg["tags"])).astype(np.float32))

    def emissions(m, w, lens):
        with torch.no_grad():
            return m[2](m[1](m[0](w), sequence_length=lens)[0])

    pot = emissions(model, words, lengths.to(dev))
    ref = emissions(cpu_model, words.cpu(), lengths)
    tag_err = (pot.cpu() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    decoder = P.text.ViterbiDecoder(trans.to(dev), include_bos_eos_tag=True)
    scores, paths = decoder(pot, lengths.to(dev))
    want_s, want_p = P.text.ViterbiDecoder(trans)(pot.cpu(), lengths)
    score_err = (scores.cpu() - want_s).abs().max().item() / max(1.0, want_s.abs().max().item())
    if not (tag_err <= TEXT_TAGGER_TOL and torch.equal(paths.cpu(), want_p)
            and score_err <= TEXT_VITERBI_TOL):
        raise AssertionError(f"text tagger: emissions card vs CPU {tag_err} (tol "
                             f"{TEXT_TAGGER_TOL}), paths equal {torch.equal(paths.cpu(), want_p)}"
                             f", scores {score_err} (tol {TEXT_VITERBI_TOL})")
    lens_dev = lengths.to(dev)
    return {"batch": list(words.shape), "emissions_rel_err": tag_err,
            "viterbi_score_err": score_err, "paths_equal": True,
            "fwd_ms": cuda_ms(lambda: emissions(model, words, lens_dev), 3, 1),
            "viterbi_ms": cuda_ms(lambda: decoder(pot, lens_dev), 3, 1)}



def text_vocab(n, rng):
    """A synthetic WordPiece vocabulary of ``n`` entries: the specials, 3000
    CJK ideographs, punctuation, whole words of 2-9 letters and "##"
    continuations of 1-4 letters (about 3:1), all distinct."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
             *[chr(0x4E00 + i) for i in range(3000)], *"!,.?;:'\"()-"]
    seen = set(vocab)
    while len(vocab) < n:
        piece = rng.rand() < 0.25
        w = "".join(letters[rng.randint(0, 26, rng.randint(1, 5) if piece
                                        else rng.randint(2, 10))])
        w = "##" + w if piece else w
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    return vocab


def text_sentences(vocab, count, words, rng):
    """``count`` sentences of ``words`` words each: vocab words, words with a
    continuation glued on, CJK runs, punctuation, capitalised and accented
    words, unknown strings."""
    whole = [w for w in vocab if w.isalpha() and w.isascii()]
    pieces = [w[2:] for w in vocab if w.startswith("##")]
    out = []
    for _ in range(count):
        parts = []
        for k in rng.randint(0, 100, words):
            w = whole[rng.randint(len(whole))]
            if k < 15:
                w += pieces[rng.randint(len(pieces))]
            elif k < 25:
                w = "".join(chr(0x4E00 + c) for c in rng.randint(0, 3000, rng.randint(1, 4)))
            elif k < 30:
                w = w + "!,.?;:"[rng.randint(6)]
            elif k < 35:
                w = w.capitalize()
            elif k < 38:
                w = w[:1] + "\xe9" + w[1:]
            elif k < 40:
                w = "".join(rng.choice(list("xyzq"), 12))
            parts.append(w)
        out.append(" ".join(parts))
    return out


def text_tokenizer_run(P, dev):
    """Phase text (c): 1024 sentences through the FasterTokenizer over a
    40000-entry synthetic vocab, the ids against the Python oracle
    (basic_tokenize + wordpiece_tokenize); 16 long rows truncated to 512
    (none padded) through ERNIE-3.0-base's forward in eval, f32 then bf16
    O1. Returns (readings, {"bf16": launches, "f32": launches})."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import ErnieModel, ernie_base
    from paddle_tpu_torch.text import faster_tokenizer as ft

    cfg = TEXT_TOK
    rng = np.random.RandomState(4)
    vocab = text_vocab(cfg["vocab"], rng)
    tok = P.text.FasterTokenizer(vocab)
    texts = text_sentences(vocab, cfg["sentences"], 40, rng)
    t = time.perf_counter()
    ids, _ = tok(texts, device=dev)
    torch.cuda.synchronize()
    tok_ms = (time.perf_counter() - t) * 1e3
    index = {w: i for i, w in enumerate(vocab)}
    rows = ids.cpu().numpy()
    for r, text in enumerate(texts):
        want = [tok.cls_id] + [i for w in ft.basic_tokenize(text, True)
                               for i in ft.wordpiece_tokenize(w, index, tok.unk_id)]
        want.append(tok.sep_id)
        if rows[r, :len(want)].tolist() != want or (rows[r, len(want):] != tok.pad_id).any():
            raise AssertionError(f"text tokenizer: row {r} differs from the Python oracle")
    n_tokens = int((ids != tok.pad_id).sum())
    long_texts = text_sentences(vocab, cfg["rows"], 700, rng)
    ids, tt = tok(long_texts, max_seq_len=cfg["max_seq_len"], device=dev)
    if tuple(ids.shape) != (cfg["rows"], cfg["max_seq_len"]) or bool((ids == tok.pad_id).any()):
        raise AssertionError(f"text tokenizer: the long rows {tuple(ids.shape)} are padded")
    model = ErnieModel(ernie_base(), device=dev, seed=0).eval()
    n = model.config.num_layers
    _reset_launch_counts()
    with torch.no_grad():
        h32 = model(ids, token_type_ids=tt)[0]
    torch.cuda.synchronize()
    f32_launches, f32_routes = _launch_counts(), _route_counts()
    _reset_launch_counts()
    with torch.no_grad(), auto_cast(dtype="bfloat16"):
        h16 = model(ids, token_type_ids=tt)[0]
    torch.cuda.synchronize()
    bf16_launches, bf16_routes = _launch_counts(), _route_counts()
    _check_route_launches("text ernie f32", *f32_routes, n, 0, "tf32x3")
    _check_route_launches("text ernie bf16", *bf16_routes, n, 0, "mma")
    err = rel_frob(h16, h32)
    if not (err <= TEXT_ERNIE_BF16_TOL and bool(torch.isfinite(h16).all())
            and tuple(h16.shape) == (cfg["rows"], cfg["max_seq_len"], model.config.hidden_size)):
        raise AssertionError(f"text ernie: bf16 O1 hidden {tuple(h16.shape)} {err} from f32 "
                             f"(tol {TEXT_ERNIE_BF16_TOL})")

    def fwd():
        with torch.no_grad(), auto_cast(dtype="bfloat16"):
            return model(ids, token_type_ids=tt)

    fwd_ms = cuda_ms(fwd, 3, 1)
    return ({"sentences": len(texts), "tokens": n_tokens, "tokenize_ms": tok_ms,
             "tokens_per_s": n_tokens / (tok_ms / 1e3), "oracle_equal": True,
             "ernie": {"batch": list(ids.shape), "bf16_fwd_ms": fwd_ms,
                       "bf16_rel_frob_vs_f32": err, "tol": TEXT_ERNIE_BF16_TOL}},
            {"bf16": bf16_launches, "f32": f32_launches})


def phase_text():
    """The RNN layers, beam search, Viterbi and the tokenizer at published
    widths (phase docstring item 17). Returns the flash launches of its
    ERNIE forwards: {"bf16": {kernel: n}, "f32": {kernel: n}}."""
    import copy

    import paddle_tpu_torch as P
    from paddle_tpu_torch.bench import card_name_and_power_limit

    t0 = time.perf_counter()
    card = card_name_and_power_limit()
    dev = torch.device("cuda")
    cpu_model = text_seq2seq(P)
    model = copy.deepcopy(cpu_model).to(dev)
    build_s = time.perf_counter() - t0
    s2s = text_seq2seq_run(P, cpu_model, model, dev)
    del cpu_model, model
    gc.collect()
    torch.cuda.empty_cache()
    tagger = text_tagger_run(P, dev)
    tok, launches = text_tokenizer_run(P, dev)
    seconds = time.perf_counter() - t0
    emit(phase="text", card=card, seq2seq={"model": "seq2seq attention, IWSLT'15 en-vi widths "
                                           "(PaddleNLP machine_translation/seq2seq)",
                                           **TEXT_S2S, "batch": TEXT_S2S_BATCH, **s2s},
         tagger=tagger, tokenizer=tok, launches=launches, build_s=build_s, seconds=seconds)
    y, d = s2s["yardstick"], s2s["decode"]
    print(f"text: seq2seq step {s2s['step_ms']:.1f} ms ({s2s['target_tokens_per_s']:.0f} target "
          f"tokens/s), beam {d['beam']} decode {d['ms']:.1f} ms over {d['steps']} steps, loop "
          f"LSTM {y['loop_fwd_bwd_ms']:.2f} ms vs cuDNN {y['cudnn_fwd_bwd_ms']:.2f} ms; tagger "
          f"{tagger['fwd_ms']:.2f} ms + Viterbi {tagger['viterbi_ms']:.2f} ms; tokenizer "
          f"{tok['tokenize_ms']:.1f} ms, ERNIE bf16 {tok['ernie']['bf16_fwd_ms']:.2f} ms "
          f"({card})", flush=True)
    if seconds > TEXT_MAX_S:
        raise AssertionError(f"text took {seconds:.1f} s, past {TEXT_MAX_S} s")
    return launches


PHASE_SECONDS = {}


def _timed(name, fn, *args):
    """fn(*args), its wall seconds kept under ``name`` (the ``seconds`` line)."""
    t = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    # f32 parity on the card: no TF32 in PyTorch's own products (the plain
    # versions and the library yardsticks are true f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_script = time.perf_counter()
    per_source = _timed("env", phase_env)
    fwd = _timed("kernels_fwd", phase_kernels_fwd)
    bwd = _timed("kernels_bwd", phase_kernels_bwd)

    cfg = GPTConfig()      # GPT-2 124M at full width and depth
    model = GPTForPretraining(cfg, seed=0)
    cpu_model = GPTForPretraining(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen).cuda()
    logits, score_launches, forward_ms = _timed("score", phase_score, model, cpu_model, ids)
    del cpu_model
    _timed("serve", phase_serve, model, ids, logits)
    del logits
    _timed("serve_paged", phase_serve_paged, model)
    _timed("serve_spec", phase_serve_spec, model)
    _timed("serve_fleet", phase_serve_fleet, model)
    _timed("quant", phase_quant, model, ids)
    _timed("profile", phase_profile, model, ids, forward_ms)
    del model
    torch.cuda.empty_cache()

    launches, f32_launches = _timed("train", phase_train, ids)
    torch.cuda.empty_cache()
    obs_launches = _timed("train_obs", phase_train_obs, ids)
    torch.cuda.empty_cache()
    rules_launches = _timed("train_rules", phase_train_rules, ids)
    _timed("train_vs_cpu", phase_train_vs_cpu)
    torch.cuda.empty_cache()
    dp_launches, dp_eager_launches = _timed("dp", phase_dp)   # and dp_eager
    ckpt_launches = _timed("ckpt", phase_ckpt, ids)
    if torch.cuda.device_count() >= 2:
        _timed("ckpt_ranks", phase_ckpt_ranks, torch.cuda.device_count())
    tp_sp_launches, pp_one_card = _timed("tp_sp", phase_tp_sp, ids)   # and pp's rank
    torch.cuda.empty_cache()
    pp_launches = _timed("pp", phase_pp, ids, True, pp_one_card)
    torch.cuda.empty_cache()
    _timed("vision", phase_vision)
    torch.cuda.empty_cache()
    _timed("mnist", phase_mnist)
    torch.cuda.empty_cache()
    _timed("rec", phase_rec)
    torch.cuda.empty_cache()
    ernie_launches = _timed("ernie", phase_ernie)
    torch.cuda.empty_cache()
    bench_launches = _timed("bench", phase_bench)

    ln_recs = _timed("layer_norm_kernels", phase_layer_norm_kernels)
    lm_recs = _timed("lm_loss_kernels", phase_lm_loss_kernels, ids)
    library_launches = _timed("library_ops", phase_library_ops, ids)
    _timed("probe", phase_probe, per_source["lm_loss"] or None)
    tensor_api_launches = _timed("tensor_api", phase_tensor_api)
    nn_launches = _timed("nn_transformer", phase_nn_transformer)
    torch.cuda.empty_cache()
    text_launches = _timed("text", phase_text)

    # the training main path runs attention in bf16 at [8, 1024, 12, 64] (the
    # tensor-core forward and backward pair; the bench's gpt_1p3b run at [4,
    # 2048, 16, 128], its rows "_d128"), the f32 steps and scoring in
    # f32 (the 3xTF32 forward, and in the steps the 3xTF32 backward pair);
    # the library ops are reported at the composition's shapes:
    # LayerNorm in f32 (black-listed under O1) and in bf16 (GPT-2 124M's
    # [8192, 768]), the LM loss with bf16 h and
    # an f32 master W (the bf16 tensor-core kernels) and in f32 (the 3xTF32
    # tensor-core forward and backward)
    pallas = "paddle_tpu/ops/pallas/"
    rows = [  # (name, path, record, source, replaces)
        ("flash_attention_fwd",
         "train, train_obs, train_rules, dp, dp_eager, ckpt, tp_sp, pp, ernie, tensor_api",
         fwd["slice_bf16_causal"],
         "flash_attention_fwd.cu", pallas + "flash_attention.py:114"),
        ("flash_attention_fwd_f32", "score, train_f32, dp_eager, tp_sp, pp, tensor_api",
         fwd["slice_f32_causal"],
         "flash_attention_fwd.cu", pallas + "flash_attention.py:114"),
        ("flash_attention_bwd_dkdv",
         "train, train_obs, train_rules, dp, dp_eager, ckpt, tp_sp, pp, ernie, tensor_api",
         bwd["train_bf16_causal"]["dkdv"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:242"),
        ("flash_attention_bwd_dq",
         "train, train_obs, train_rules, dp, dp_eager, ckpt, tp_sp, pp, ernie, tensor_api",
         bwd["train_bf16_causal"]["dq"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:268"),
        ("flash_attention_bwd_dkdv_f32",
         "train_f32, dp_eager, tp_sp, pp, tensor_api, nn_transformer",
         bwd["train_f32_causal"]["dkdv"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:242"),
        ("flash_attention_bwd_dq_f32", "train_f32, dp_eager, tp_sp, pp, tensor_api, "
         "nn_transformer",
         bwd["train_f32_causal"]["dq"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:268"),
        ("flash_attention_fwd_ernie", "ernie, nn_transformer, text", fwd["ernie_bf16_noncausal"],
         "flash_attention_fwd.cu", pallas + "flash_attention.py:114"),
        ("flash_attention_bwd_dkdv_ernie", "ernie, nn_transformer",
         bwd["ernie_bf16_noncausal"]["dkdv"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:242"),
        ("flash_attention_bwd_dq_ernie", "ernie, nn_transformer",
         bwd["ernie_bf16_noncausal"]["dq"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:268"),
        ("flash_attention_fwd_f32_ernie", "ernie, nn_transformer, text",
         fwd["ernie_f32_noncausal"],
         "flash_attention_fwd.cu", pallas + "flash_attention.py:114"),
        ("flash_attention_fwd_d128", "bench gpt_1p3b", fwd["1p3b_bf16_causal"],
         "flash_attention_fwd.cu", pallas + "flash_attention.py:114"),
        ("flash_attention_bwd_dkdv_d128", "bench gpt_1p3b", bwd["1p3b_bf16_causal"]["dkdv"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:242"),
        ("flash_attention_bwd_dq_d128", "bench gpt_1p3b", bwd["1p3b_bf16_causal"]["dq"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:268"),
        *((f"layer_norm_{k}{suffix}", f"library_ops {pass_}",
           ln_recs[(dtype, 768)][f"layer_norm_{k}"], "layer_norm.cu",
           pallas + f"layer_norm.py:{line}")
          for suffix, pass_, dtype in (("", "f32", torch.float32),
                                       ("_bf16", "bf16", torch.bfloat16))
          for k, line in (("fwd", 92), ("infer", 119), ("bwd", 137))),
        ("lm_loss_fwd", "library_ops", lm_recs["bf16_h_f32_w"]["lm_loss_fwd"],
         "lm_loss.cu", pallas + "lm_loss.py:162"),
        ("lm_loss_dh", "library_ops", lm_recs["bf16_h_f32_w"]["lm_loss_dh"],
         "lm_loss.cu", pallas + "lm_loss.py:261"),
        ("lm_loss_dw", "library_ops", lm_recs["bf16_h_f32_w"]["lm_loss_dw"],
         "lm_loss.cu", pallas + "lm_loss.py:279"),
        ("lm_loss_fwd_f32", "library_ops", lm_recs["f32"]["lm_loss_fwd"],
         "lm_loss.cu", pallas + "lm_loss.py:162"),
        ("lm_loss_dh_f32", "library_ops", lm_recs["f32"]["lm_loss_dh"],
         "lm_loss.cu", pallas + "lm_loss.py:261"),
        ("lm_loss_dw_f32", "library_ops", lm_recs["f32"]["lm_loss_dw"],
         "lm_loss.cu", pallas + "lm_loss.py:279"),
        ("lm_loss_dh_f32_h1024", "lm_loss_kernels h1024_f32", lm_recs["h1024_f32"]["lm_loss_dh"],
         "lm_loss.cu", pallas + "lm_loss.py:261"),
        ("lm_loss_dw_f32_h1024", "lm_loss_kernels h1024_f32", lm_recs["h1024_f32"]["lm_loss_dw"],
         "lm_loss.cu", pallas + "lm_loss.py:279"),
        ("lm_loss_dh_bf16_h2048", "lm_loss_kernels h2048_bf16_h_f32_w",
         lm_recs["h2048_bf16_h_f32_w"]["lm_loss_dh"], "lm_loss.cu", pallas + "lm_loss.py:261"),
        ("lm_loss_dw_bf16_h2048", "lm_loss_kernels h2048_bf16_h_f32_w",
         lm_recs["h2048_bf16_h_f32_w"]["lm_loss_dw"], "lm_loss.cu", pallas + "lm_loss.py:279"),
    ]
    # LayerNorm at f32 from the f32 pass and at bf16 from the bf16 pass;
    # the LM loss's bf16 tensor-core forward and backward from the bf16
    # pass, its f32-h forward and backward (3xTF32) from the f32 pass
    lib_f32, lib_bf16 = library_launches["f32"], library_launches["bf16"]
    counts = {**{k: launches[k] + obs_launches[k] + rules_launches[k] + dp_launches[k]
                 + ckpt_launches[k] + dp_eager_launches["bf16"][k]
                 + tp_sp_launches["bf16"][k] + pp_launches["bf16"][k]
                 + ernie_launches["bf16"][k] + tensor_api_launches["bf16"][k]
                 for k in launches},
              **bench_launches,
              # the non-causal f32 forwards of ernie and nn_transformer on the
              # "_f32_ernie" row; their backward pair on the f32 rows
              **{f"{k}_f32": f32_launches[k] + dp_eager_launches["f32"][k]
                 + tp_sp_launches["f32"][k] + pp_launches["f32"][k]
                 + tensor_api_launches["float32"][k]
                 + (score_launches if k == "flash_attention_fwd" else
                    ernie_launches["f32"][k] + nn_launches["f32"][k])
                 for k in _launch_counts_keys()},
              **{f"{k}_ernie": ernie_launches["bf16"][k] + nn_launches["bf16"][k]
                 + text_launches["bf16"][k] for k in _launch_counts_keys()},
              "flash_attention_fwd_f32_ernie": ernie_launches["f32"]["flash_attention_fwd"]
              + nn_launches["f32"]["flash_attention_fwd"]
              + text_launches["f32"]["flash_attention_fwd"],
              **{k: lib_f32[k] for k in ("layer_norm_fwd", "layer_norm_infer",
                                         "layer_norm_bwd")},
              **{f"{k}_bf16": lib_bf16[k] for k in ("layer_norm_fwd", "layer_norm_infer",
                                                   "layer_norm_bwd")},
              "lm_loss_fwd": lib_bf16["lm_loss_fwd_mma"],
              "lm_loss_fwd_f32": lib_f32["lm_loss_fwd_tf32x3"],
              "lm_loss_dh": lib_bf16["lm_loss_dh_mma"],
              "lm_loss_dw": lib_bf16["lm_loss_dw_mma"],
              "lm_loss_dh_f32": lib_f32["lm_loss_dh_tf32x3"],
              "lm_loss_dw_f32": lib_f32["lm_loss_dw_tf32x3"],
              **{f"{k}_f32_h1024": lm_recs["h1024_f32"][k]["check_launches"]
                 for k in ("lm_loss_dh", "lm_loss_dw")},
              **{f"{k}_bf16_h2048": lm_recs["h2048_bf16_h_f32_w"][k]["check_launches"]
                 for k in ("lm_loss_dh", "lm_loss_dw")}}
    kernels = []
    for name, path, rec, src, replaces in rows:
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{src}",
            "replaces": replaces,
            "path": path,
            "launches": counts[name],
            "max_abs_err": rec.get("max_abs_err", rec.get("max_abs_err_o")),
            "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            **{k: rec[k] for k in ("kernel_route", "instance") if k in rec},
        })
    emit(phase="seconds", total=time.perf_counter() - t_script, **PHASE_SECONDS)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
