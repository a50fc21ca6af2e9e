#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. the card's name and power limit; build every CUDA kernel from
   paddle_tpu_torch/csrc (one nvcc per source, all started together):
   the ragged paged attention and the paged decode attention of the
   serving paths, the flash-attention forward, dq and dk/dv kernels (packed
   and flat layouts) and the qkv-folded flash forward of training (one
   source, and one more for their bfloat16 and float16 entries), and the
   fused matmul epilogue and the FFN chain of the fusion pass (the same,
   two sources);
2. each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it and at edge cases, with its time, the plain
   version's time, a PyTorch library call's time and the least time the
   card could take (its bound) — the two serving kernels also at a
   serving-scale "long" case (64 sequences of up to 2048 keys, K/V far
   past the L2) and each with its launch floor (the same launch with
   every length 0); the qkv-folded forward's gradients
   through the dq and dk/dv kernels, and the fused matmul's and FFN
   chain's through their autograd functions, against the plain ones;
3. the generation engine at BertConfig.base() (random weights from a
   seed, initializer_range 0.6), each path driven with the launch
   counts set to 0 just before it and read just after:
   a. chunked scheduling: warmup, then 8 prompts x 96 greedy tokens
      through the ragged kernel — every request must finish, the kernel
      must launch once per layer per step, and nothing may compile after
      warmup; the same prompts through the plain attention and one
      seeded-sampling batch report their matched-prefix fraction;
   b. legacy scheduling: 8 prompts of 8..32 tokens (two prefill
      buckets) x 96 greedy tokens — the paged decode kernel must launch
      once per layer per decode step and the ragged kernel never; again
      with the dense cache (plain attention);
   c. the prefix cache: 8 prompts sharing a 64-token (4-page) prefix —
      hits, pages reused, and the allocator audit after the run;
   d. speculation: ngram drafting on prompts that repeat n-grams, and a
      2-layer cut of the same weights as the draft model — acceptance
      ratios;
   At full depth this model is numerically chaotic, so agreement between
   paths is reported, not gated.  The same weights cut to 2 layers then
   hold the tokens to references: every greedy token of the chunked
   kernel engine and of the plain-attention engine must be the plain
   full recompute's argmax, and the legacy (paged and dense), prefix
   cache, ngram and draft engines must give the chunked engine's tokens
   and reach the recompute's argmax.  Last, one chunked and one legacy
   generate under torch.profiler: device kernel time by name and the
   device's busy share;
4. the server: GenerationBackend behind InferenceServer, 4 concurrent
   clients, answers equal to a direct engine.generate, for a chunked and
   a legacy engine;
5. training: BERT-base pretraining (BertConfig.base(), dropout 0.1,
   batch 32 x 128 tokens, ~15% of positions labelled, random weights from
   a seed) through the port's front end — build_bert_pretrain ->
   Adam(1e-4).minimize -> Executor.run, whose GEMM-epilogue fusion pass
   is on by default — for 2 warm-up and 10 timed steps: the plan must
   hold 12 attention, 13 fused-matmul and 12 FFN-chain groups (the MLM
   head's N = 30522 replays), every loss must be finite, the qkv-folded
   forward, the fused matmul, the FFN chain and the flash dq and dk/dv
   kernels must launch once per layer per step and the packed flash
   forward never, no plain version of a kernel may run and no kernel
   library may load after the first step; one step under
   torch.profiler; then the parity gate at dropout 0 from the same
   weights: 5 Adam steps each of the fused program, the unfused lowering
   (BuildStrategy.fuse_epilogues = False: the packed flash kernels) and
   the plain matmul/softmax program (fused_attention=False, unfused:
   none of the port's kernels), each launching only its own kernels
   once per layer per step; every step's loss of the first two within
   2e-3 of the plain program's and every first-step gradient within a
   relative norm error of 1e-3;
6. the 4-D fused_attention op through the Executor at BERT-base
   attention width: x, y [8, 12, 512, 64], q = fc(x) over the head dim,
   attention of q over x with a key-padding bias and dropout 0.1, the
   mean squared error, Adam(1e-3), 2 warm-up and 10 timed steps — finite
   losses, the flat forward, dq and dk/dv kernels once per step each, no
   packed kernel, no plain version, no library load after the first
   step; then at dropout 0 from the same weights 5 steps against the
   matmul/softmax program: losses within 2e-3, first-step gradients
   within a relative norm error of 1e-3;
7. the sequence-parallel train step of _dryrun_seq (__graft_entry__.py)
   on a one-rank NCCL group and a data 1 x seq 1 mesh: q = x w, causal
   ring attention over the seq group, the MSE, the gradient all-reduced
   over data and seq, SGD(0.1), 10 steps at [2, 12, 4096, 64] — the flat
   kernels once per step each, no plain version, every loss within 2e-3
   of the plain composite's step and w within a relative norm error of
   1e-4; peak memory of both steps;
8. the traced path (phases 1-7 run with the profiler off and the flight
   recorder disarmed; here both are on): a fresh chunked and a fresh
   legacy engine at phase 3a's configuration behind InferenceServer +
   GenerationBackend, 4 client threads each sending 2 of phase 3a's
   prompts as one request inside its own span("client_request"), under
   profiler.start_profiler("All", tracer_path=...) — the answers must
   equal the same engine's untraced generate, the attention kernel must
   launch once per layer per step with no plain version and nothing
   loaded after warmup, every batch span and queue wait must join the
   trace of the client whose request is first in the batch and every
   step span must have a batch span as an ancestor, the registry must
   agree with the stats (generation_tokens_total, serving_requests_total)
   and the ledger counters with the snapshot, the Prometheus text must
   parse, the flight recorder's ring must hold the step spans and one
   seq_finish per sequence, and in the Kineto trace every attention
   kernel must run inside a step range; then one step of phase 5's fused
   program inside span("train:step") under the profiler, whose Kineto
   trace must place every fused-matmul, FFN-chain and qkv-folded flash
   kernel inside a program op's "type:first_output" scope.  Phase 5
   also holds the registry: one fused_epilogue_hits_total per planned
   group, fused_block_hits_total 12 attention and 12 FFN-chain blocks,
   executor_compiles_total one per lowering, optimizer_state_bytes equal
   to Adam's state, and a TrainingMonitor's JSONL one record per timed
   step with that step's wall time;
9. disaggregated serving of phase 3a's 8 prompts (prefill on one engine,
   the K/V handed to another that decodes), at full depth and cut to 2
   layers:
   a. in this process: a chunked prefill engine's prefill_detached
      handoffs decode on a chunked and on a legacy decode engine, each
      run with the launch counts set to 0 just before it and read just
      after — the ragged kernel once per layer per step on the prefill
      and the chunked decode engine, the paged decode kernel once per
      layer per decode step (and the ragged kernel never) on the legacy
      one, no plain attention, nothing loaded after warmup, every
      request finished; the detached prefill's handoff equals the
      concatenated chunks of prefill_stream bit for bit, and import_seq
      then export_seq through a paged and a dense cache gives the same
      bytes back; at depth 2 every token reaches the plain recompute's
      argmax and the chunked decode's tokens equal a single chunked
      engine's (the legacy decode's equality is reported); export,
      import and wire (one RPC round trip of a handoff) ms a request;
   b. over processes: a WorkerPool of one prefill and one decode worker
      (python -m paddle_tpu_torch.cluster.worker, on this card) per
      depth behind a GenerationRouter that streams pages, 4 client
      threads — every request ok, both workers alive, chunks streamed
      and no fallback, nothing loaded after warmup in a worker, at
      depth 2 every token the recompute's argmax; time to first token,
      decode tokens/s, against the same prompts through one engine and
      through the monolithic handoff; the pools close in a finally and
      no worker process may outlive them (their logs: workerlog.0 under
      chiprun_out/phase9/<depth>_<role>/);
10. BERT-base pretraining with the published recipe (Devlin et al. 2018,
   appendix A.2; the global-norm clip of Paddle's BERT optimization.py)
   through the default fused program: linear warmup over 4 steps, then
   linear decay to step 12 (warmup 10,000 and 1,000,000 steps in the
   recipe, cut so that one run crosses both), AdamW(weight_decay 0.01),
   GradientClipByGlobalNorm(1.0), dropout 0.1, 32 x 128, in a
   resilience.ResilientLoop with a CheckpointManager(keep=2) in a
   temporary directory (removed in a finally):
   a. 12 steps, a checkpoint every 4: every step's LR within 2 ulp of the
      schedule's float32 closed form, the clip's scale in (0, 1], finite
      losses, the five fused-step kernels 12 x 12 times each, the packed
      flash forward and every plain kernel version never, no library
      loaded after the first step; the save's time on the step path, the
      background write's, a version's bytes and the disk peak;
   b. the same weights again, preempted before step 6: a new executor,
      scope and rebuilt program restore step 4 and run to 12 — every loss
      bit-equal to (a)'s and the last version's checksums equal (a)'s,
      array for array; the restore's time;
   c. a NaN loss injected at step 2: that step skipped, every persistable
      after it bit-equal to before it, finite losses after it, one
      nan_skip flight-recorder trigger;
   d. the eval clone (taken before minimize) on a held-out batch: two
      runs bit-equal, the qkv-folded flash, fused matmul and FFN-chain
      kernels 12 times each and nothing else, within 2e-3 of the unfused
      clone, and save_inference_model then load_inference_model into a
      fresh scope giving the same bits;
   e. 10 steps without checkpoints: the recipe's step ms beside phase 5's.
11. control flow and the causal LM's graph forms at BertConfig.base()
   width (phase 3's initializer_range 0.6, dropout 0, the graph's own
   startup from a seed):
   a. build_lm_greedy_infer(cfg, 8, 32, 96) — one StaticRNN whose every
      step re-runs the 12-layer LM over the [8, 128] buffer — through
      Executor.run: one warm run, then timed runs, each giving the first
      run's tokens, the packed flash forward (causal, in the sub-block's
      unfused attention op) 12 x 96 times a run and no other kernel, no
      plain version, no library loaded after the first run; the same
      weights (lm_params_from_scope) through the chunked engine at phase
      3a's configuration: tokens/s of both, the matched-prefix fraction
      (reported); the graph at depth 2 on the same scope: every token
      the depth-2 chunked engine's and the plain recompute's argmax; one
      profiled decode at the same width (host time by op scope, device
      busy share);
   b. the decoder frozen (io.save_inference_model, its tokens transposed
      batch-major) into a temporary directory (removed in a finally) and
      run by inference.create_predictor: the tokens of (a) bit for bit;
      behind InferenceServer(PredictorBackend(pred)) with batch bucket 8,
      4 client threads of 2 prompts each: every answer the Predictor's
      rows, no lowering after warmup, the round trips;
   c. build_lm_logits at [8, 128] on the same weights through a
      Predictor (the fusion pass on): 12 attention, 12 fused-matmul and
      12 FFN-chain groups (the JAX planner's plan), the qkv-folded
      forward (causal), the fused matmul and the FFN chain 12 times each
      and nothing else, no plain version; the unfused lowering's packed
      forward 12 times; fused, unfused and the plain recompute pairwise
      per position, every position within 1e-3 relative at depths 1 and
      2, reported at 4, 8 and 12 (chaotic there); one profiled run;
   d. backward through loops: tests/test_torch_control_flow.py's
      StaticRNN-trains and bounded-While programs on the card from the
      CPU path's weights — first-step gradients within 1e-5 relative of
      the CPU path's, finite and falling losses, no port kernel launched.
12. training from files (phase 3's seed; files in a temporary directory,
   removed in a finally):
   a. the ops repaired against the JAX package (top_k's ties, gather
      and lookup_table past their table, sign of NaN and -0.0, the mean
      of integers, saturating casts, gelu at infinity, the gradients at
      the kinks of clip, relu6, abs, leaky_relu, hard_sigmoid and
      hard_swish) on the card against the CPU, over the inputs of their
      CPU tests: equal (floats within 1e-6), out-of-range indices giving
      their fill rows;
   b. 4 MultiSlot parts of 256 instances written from a seed (src_ids,
      input_mask, masked_labels; 128 values each, ~15% labelled): the
      native slot parser and the plain Python parser give equal arrays,
      ms per part;
   c. BertConfig.base() (dropout 0.1) from 2-D feeds (build_dataset_bert)
      with Adam(1e-4), batch 32, 8 steps a chunk: one QueueDataset epoch
      and one InMemoryDataset epoch after local_shuffle(seed), both
      train_from_dataset(thread=2) — 12 attention, 13 fused-matmul and
      12 FFN-chain groups, the five fused-step kernels once per layer per
      step and the packed flash forward never, no plain version, no
      library loaded after the first chunk, finite chunk losses, the
      batches pulled by the "paddle_tpu-feed" thread; step ms and
      tokens/s beside phase 5's step and beside Executor.run steps of
      the same program timed before and after the second epoch, the
      feed's wait (dataio_prefetch_wait_ms), one profiled chunk's busy
      share;
   d. at dropout 0, one chunk through train_from_dataset against 8
      Executor.run steps on the same weights and batches: last loss and
      chunk mean within 2e-3 (the largest persistable difference
      reported); at dropout 0.1, thread=0 and thread=2 from the same
      weights and seeds give bit-equal losses and persistables;
   e. FLAGS_check_nan_inf: train_from_dataset refuses it (ValueError);
      Executor.run of the log of a negative feed raises RuntimeError
      naming log and nan; a clean feed passes.
13. the rest of training (phase 3's seed):
   a. build_bert_pretrain(BertConfig.base(), 128, max_masked=20) —
      the masked-position head, as bench.py builds its feeds (20
      distinct positions a row as pos + b·L, labels the ids there) —
      dropout 0.1, Adam(1e-4), 32 x 128, 2 warm-up and 10 timed steps
      through the default fused program: 12 attention, 13 fused-matmul
      and 12 FFN-chain groups (the JAX planner's plan, which the CPU
      tests hold group for group), the five fused-step kernels once per
      layer per step, the packed forward and every plain version never,
      no library loaded after the first step, finite losses; step ms
      and tokens/s beside phase 5's dense head in turns in this call,
      one profiled step of each (the difference of their device ms is
      the heads'); the three-way parity gate of phase 5 on the masked
      programs; the masked loss within 1e-4 relative of the dense
      head's whose labels mark the same positions;
   b. RecomputeOptimizer(Adam(1e-4)) with the 13 boundaries (the
      embedding's and each layer's output) as checkpoints, against the
      same program unfused without Recompute: no fusion plan, the packed
      forward at most twice per layer per step and the dq and dk/dv
      kernels once, no plain version, a lower peak memory (both
      reported, and both step ms), at dropout 0.1 the first loss equal,
      at dropout 0 five steps within 2e-3 and the first step's gradients
      within a relative norm error of 1e-3;
   c. tests/test_sparse_grad.py's extra-fc program at a 1,000,000 x 128
      table (512 MB) with 4096 Zipf-drawn ids a batch (1% written as
      their negative alias), SGD(0.5), Adam(0.01) and Adam(0.01,
      lazy_mode=True) with GradientClipByGlobalNorm(1.0), 5 steps each,
      beside the dense program: SGD and Adam within 1e-5 relative of
      dense (losses and the table's norm), lazy Adam's untouched rows
      and their moments bit-unchanged, table@GRAD [4096, 128], each run
      bit-equal to a rerun, and one step whose ids hold some past the
      table changing only the rows of valid ids (no device-side
      assert); step ms sparse against dense;
   d. GradientMerge(k=4) on (a)'s program at dropout 0 over 4 batches
      of 8: the parameters' bits unchanged on steps 1-3, after step 4
      within a relative norm error of 1e-4 of one Adam step on the
      32-row batch; EMA(0.999) on (a)'s program: inside apply the
      script's bias-corrected average within 1e-6, after restore the
      same bits; ModelAverage, Lookahead and DGC momentum on their CPU
      test programs, 6 steps on the card within 1e-5 of the CPU run;
   e. the loss and metric ops (cross_entropy, sigmoid cross entropy,
      smooth L1, Huber, accuracy, AUC) on the card against the CPU over
      their tests' inputs, outputs and gradients within 1e-5.
16. the parameter-server tier (phases 14 and 15 are described at their
   functions; their lines come before the kernels line too):
   a. build_bert_pretrain(BertConfig.base() cut to PS_DEPTH = 2 layers,
      128) at dropout 0 through the PS fleet (sync, server sgd,
      SGD(0.01), dense blocks of 64: a table a parameter; 150 tables of
      2,068,149 blocks at 12 layers) with one pserver process on the host,
      each trainer a process of its own on the card (chip_smoke.py
      --child bert_ps) that only loads the kernels built here: one
      trainer, 3 steps on the 32 x 128 batch — losses within 1e-5
      relative of plain SGD steps of the same program on the card from
      the same weights, the PS's parameters after the last step within
      1e-5 relative norm of theirs; two trainers of 16 rows each, 3
      steps — the parameters both pull after the last barrier bit-equal
      (a digest), within 1e-5 relative norm of θ − lr·(g₀ + g₁) from each
      half at the same θ; the step split into pull, step and push ms,
      the bytes each way, the server's RSS; each trainer's launches of
      the qkv-folded forward, the fused matmul, the FFN chain and the
      flash dq and dk/dv kernels (one a layer a step each) join the
      kernels line,
      and no plain version may run;
   b. tests/dist_fleet_ps.py's program in the sync, async and GEO modes
      at once, 2 pservers x 2 trainers each (the trainers on the card,
      their startup run on the host), 12 steps: every trainer's losses
      learn (tests/test_fleet_ps.py's criterion), the two trainers' fc_w
      after a barrier within 1e-5, sync's save_persistables writes the
      servers' snapshots;
   c. DeviceCachedEmbedding of 262,144 x 128 on the card over a PS table
      of 1,000,000 x 128, phase 13c's Zipf ids (4096 a batch), the
      program gathering cache[slots]: after each push the cached rows
      within 1e-6 relative norm of the PS's own pull; hit rate, pulls and
      ms a step;
   d. the collective fleet (CollectiveOptimizer(Adam(1e-4))) on phase
      5's program at dropout 0 over a one-rank NCCL group started by
      ensure_distributed_initialized, against plain steps from the same
      weights: 5 steps, losses and all parameters bit-equal, the
      fused kernels once a layer a step each; allreduce_bandwidth over that
      group (min_s, no GB/s at world 1); LocalSGD (k 2) at
      tests/dist_local_sgd.py's program on two gloo ranks on the card
      started by python -m paddle_tpu_torch.distributed.launch: after
      each sync both ranks hold the mean of their pre-sync weights
      within 1e-6.
   Its numbers go on a {"ps": {...}} line before the kernels line; its
   children's logs under chiprun_out/phase16/.
17. the JAX bench's other two training models (bench.py:215, :257),
   float32, random weights and data from a seed:
   a. resnet(img, label, depth=50) + Momentum(0.1, 0.9) at [256, 3,
      224, 224] (halved until a step fits the card; each batch tried and
      its peak reported): the first step on the first 4 images against
      the port's CPU run of the same program from the same startup
      weights — the loss within 2e-3, the first batch norm's moving mean
      and variance and the classifier's weight within a relative norm
      error of 1e-3, conv1's filter update within 0.15 (its gradient is
      ill-conditioned at random initialization), the statistics also
      against momentum·old + (1 − momentum)·conv1's batch statistics;
      then 2 warm-up and 10 timed steps —
      finite losses, the classifier's fused matmul once a step and no
      other kernel of the port (the convolutions, pooling and batch
      norms are cuDNN and PyTorch: the JAX package has no Pallas kernel
      for them); step ms, images/s, peak memory, one profiled step
      (busy share, the convolutions' share), bench.py's conv+matmul
      FLOPs over the step time;
   b. build_nmt_train(NMTConfig.big(), 256, 256) + Adam(1e-4) at batch
      32, dropout 0.3: the plan the JAX planner makes (12 attention
      entries, 12 relu FFNs, 18 residual norms, 12 projections), 2
      warm-up and 10 timed steps — finite losses; a step launches the
      qkv-folded forward 12 times, the packed forward 6 (the
      cross-attentions), the dq and dk/dv kernels 18 each, the fused
      matmul 54 and the FFN chain never (N 1024 is past its rule); step
      ms, target tokens/s, peak memory, one profiled step; at dropout 0
      3 fused steps within 2e-3 of 3 steps of the unfused lowering from
      the same weights; then 3 steps at NMTConfig.base(), where the FFN
      chain runs once an FFN (12 a step);
   c. build_nmt_beam_infer(NMTConfig.big(), 64, 8, 32, beam_size=4) on
      (b)'s trained weights: ms a decode step, sentences/s, launches a
      run (the packed forward 2 x 6 x 32 in the StaticRNN sub-block, the
      qkv-folded forward 6 and the fused matmul 18 in the encoder: the
      fusion pass plans the top level only); with both stacks cut to 2
      layers, the card's sentence ids equal the port's CPU run of the
      same program and weights and the scores within 1e-3, beside the
      smallest gap between adjacent final beam scores.
   Its numbers go on a {"bench_models": {...}} line before the kernels
   line.
18. bf16 and fp16 AMP training (contrib.mixed_precision.decorate; the
   lowering's dtype policy; the fused groups in the kernels' bfloat16
   and float16 variants):
   a. build_bert_pretrain(BertConfig.large(), 512, max_masked=80) under
      decorate(Adam(1e-4), "bfloat16"), batch 16, dropout 0.1, fusion
      on (bench.py:3121): 2 warm-up and 10 timed steps — the lowered
      plan equal to the port's planner's, finite losses, per step the
      bf16 #9, #5 and #6 once an attention group and #10 once a GEMM
      group and twice an FFN group (N 1024 is past #11's rule), #11
      never, no plain version, no library load after the first step;
      step ms, tokens/s, peak memory, one profiled step (busy share, the
      port's kernels' share); then the same program without AMP, 3
      steps: the f32 step beside it;
   b. the same at BertConfig.base(), 64 x 128, max_masked=20
      (bench.py:3124), #11 in bf16 once an FFN;
   c. BERT-base cut to 2 layers at 8 x 128 under decorate(SGD(0.1),
      "float16") with dynamic loss scaling from 2^24 (its scaled
      gradients overflow float16: the first steps shrink the scale, the
      later grow it every 2 good steps): loss_scaling, good_steps and
      bad_steps after every step equal to the port's CPU run of the same
      program and weights, the float16 variants launched;
   d. phase 17's ResNet-50 (Momentum(0.1, 0.9), batch 256 halved until
      it fits; cuDNN's bf16 convolutions, batch norm on the gray path
      with its Mean/Variance kept float32, #10 bf16 for the classifier)
      and NMT-big at 32 x 256/256 (#9, #3, #5, #6, #10 in bf16 at phase
      17b's counts) under bf16 AMP: 2 warm-up and 5 timed steps each —
      finite losses, the launches, no plain version; step ms, images/s,
      target tokens/s, peak memory;
   e. BERT-large cut to 2 layers (4 x 128), ResNet-18 (16 images of 112,
      Momentum(0.001, 0.9)) and NMT-big cut to 2 + 2 layers (4 x
      64/64), dropout 0: the card's first bf16 loss within 5e-3
      relative of the port's CPU run of the same program and weights,
      and the 5-step bf16 trajectory within 5e-2 relative of the f32 one
      from the same weights (tests/test_amp.py:87's bound).
   Its numbers go on an {"amp": {...}} line before the kernels line.
19. the Megatron split and sync-BN, on two gloo ranks sharing the card
   (one spawn, torch.multiprocessing), each job against the one-rank run
   of the same program on the card from the same startup seed:
   a. BERT-base at full width (12 layers, 12 heads, F 3072), 32 x 128,
      dropout 0, at {model: 2} under tp_sharding_rules: 5 Adam steps
      fused and 5 unfused — losses within 2e-3, every whole parameter
      after the steps within 1e-3 of the one rank's, and each
      parameter's distance from the one rank's within 0.1 of the one
      rank's update of it (relative norms; TP_PARAM_REL_TOL says why);
      per rank and step
      the qkv-folded forward and the flash dq and dk/dv kernels 12 times
      on 6 heads (the unfused program: the packed forward), the fused
      matmul 12 times with its epilogue off and the FFN chain 12 times
      at F 1536 with its epilogue off (none unfused); no weight gathered
      whole; the collectives over model as planned (25 forward sums, 26
      backward sums, the logits' gather); peak memory a rank beside one
      rank's;
   b. NMT-big (dropout 0) at {model: 2} under nmt_tp_sharding_rules, 16
      x 128/128, 3 steps: losses within 2e-3, the parameters held as in
      a; #9 12, #3 6, #5 and #6 18 a step, #10 launched;
   c. ResNet-50 at {data: 2}, 32 images a rank, Momentum(0.001, 0.9),
      against one rank at 64: 2 steps, losses within 2e-3, the running
      statistics after the first within 1e-4 (the world-1 mesh's run
      beside them: how far two f32 runs part without a second rank);
      its control at Momentum(0.01, 0.9), the two ranks and the world-1
      mesh each against one rank, recorded (its losses not gated), the
      statistics held as in c.
   Phase 2 holds every kernel at the split's shapes against its plain
   version, gradients too (TP_SPLIT_CASES, the tp cases of QKV_CASES
   and FLASH_CASES).
   Its numbers go on a {"tensor_parallel": {...}} line before the
   kernels line; the split runs' launches (rank 0's) join the kernels
   line.
20. dygraph (imperative mode), the model dygraph_bert: BertConfig.base()
   widths from paddle_tpu_torch.dygraph.nn (word, position and type
   Embeddings, LayerNorm; per layer a qkv Linear, three slices,
   fused_multihead_attention with the key-padding bias and dropout 0.1,
   an output Linear, residual + LayerNorm, a gelu Linear, a Linear,
   residual + LayerNorm; logits tied to the word embedding), random
   weights from dygraph.seed:
   a. 32 x 128, Adam(1e-4), eager: 2 warm-up and 10 timed steps — finite
      losses, the packed flash forward, dq and dk/dv kernels once a layer
      a step each and no other port kernel, no plain version, no library
      loaded after warm-up; step ms, peak memory, host us per eager op,
      one profiled step's busy share; at 2 layers and dropout 0, 2 steps
      of 8 rows on the card against the same steps on the CPU: losses
      within 2e-3, parameters within 1e-3;
   b. save_dygraph of the model and Adam's state, load_dygraph into a
      fresh model and optimizer: the next step (the same seed) bit-equal
      to the uninterrupted one — loss, parameters and Adam's state;
   c. TracedLayer.trace in eval mode, run through the Executor (the
      fusion pass on): the qkv-folded forward, the fused matmul and the
      FFN chain once a layer each and nothing else, no plain version,
      logits within 1e-4 of the eager forward; save_inference_model,
      then a Predictor on it within 1e-5;
   d. a @declarative function whose while has a tensor trip count (a
      While op) at [4096, 768] x [768, 768] through the Executor, against
      its eager call: within 1e-5;
   e. DataParallel at world 1 over a one-rank NCCL group: scale_loss,
      apply_collective_grads, one step bit-equal to a plain eager step
      from the same state and seed.
   Its numbers go on a {"dygraph": {...}} line before the kernels line.
Phase 2 also holds the bfloat16 and float16 variants of the packed
flash kernels (#3, #5, #6), the qkv-folded forward (#9), the fused
matmul (#10) and the FFN chain (#11) against their plain versions in the
same element type, at BERT-large's attention (16 x 512, 16 heads of 64,
key padding, dropout 0.1) and GEMMs (M 8192: K 1024 -> N 1024, 3072,
4096; K 4096 -> N 1024), BERT-base's FFN and attention output (M 8192),
a key-padding bias with one fully padded row and T 100 (off the 32-row
tiles), with the stated tolerances (AMP_TOL), and times each beside its
plain version, the library call in the same dtype and its bound at the
bf16 tensor-core rate (and the 1xTF32 rate its design runs at).
Phase 2 also holds the packed and the qkv-folded flash forwards at the
decoder's causal shape (8 x 128, 12 heads of 64, no key bias) against
their plain versions and times them beside SDPA's causal forward, and
phase 17's shapes: the qkv-folded forward and its gradients at NMT-big's
self-attention (32 x 256, 16 heads of 64, causal and with key padding),
the packed kernels at its cross-attention and the beam decoder's (32
rows of 32 queries against 64 keys), the fused matmul at its GEMMs (K
1024 -> N 4096, 3072, 2048; K 4096 -> N 1024) and ResNet-50's classifier
— each with its time, the plain version's, a library call's and its
bound.

Before the card's line come {"observability": {...}} (phase 8's
numbers), {"cluster": {...}} (phase 9's), {"recipe": {...}} (phase 10's),
{"control_flow": {...}} (phase 11's), {"dataset": {...}} (phase 12's),
{"sparse_recompute": {...}} (phase 13's), {"fleet_tuning_artifact":
{...}} (phase 14's), {"parallel": {...}} (phase 15's), {"ps": {...}}
(phase 16's), {"bench_models": {...}} (phase 17's), {"amp": {...}}
(phase 18's), {"tensor_parallel": {...}} (phase 19's), {"dygraph":
{...}} (phase 20's) and {"kernels": [...]}, one entry per kernel (each
bfloat16 and float16 variant beside its float32 entry) with its own
launches, error and times; the last line is
{"ok": true, "device": {...}}.  A kernel's launches are those of its own
path's run: the unfused lowering's for the packed flash forward, the
fused training steps' for the other training kernels, phase 6's timed
steps for the flat kernels; the packed flash forward adds one phase-11
greedy generate's, and the qkv-folded forward, the fused matmul and the
FFN chain one phase-11 logits run's, and the five fused-step kernels
phase 12c's QueueDataset epoch's, 13a's timed steps' and (the packed
forward, dq and dk/dv) 13b's Recompute steps', and the five
fused-step kernels phase 16a's trainer processes' and 16d's collective
steps', and phase 17's runs theirs (17a's and 17b's timed steps, 17b's
base steps, 17c's timed beam runs); a variant's are phase 18's (18a's
and 18b's timed steps, 18c's card steps, 18d's timed steps), and the
float32 training kernels phase 19's split runs' (rank 0's), and phase
20's: the packed flash forward, dq and dk/dv kernels its timed eager
steps', the qkv-folded forward, the fused matmul and the FFN chain its
timed traced run's.  Details go to
chiprun_out/chip_smoke.json, phase 8's traces (gzipped Kineto and host
Chrome traces) and metrics under chiprun_out/phase8/.
The script imports nothing of JAX and nothing of paddle_tpu.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import traceback
import types
from pathlib import Path

import numpy as np

SEED = 0
PAGE_SIZE, MAX_SEQS, MAX_SEQ_LEN = 16, 8, 128
PROMPT_LEN, MAX_NEW = 32, 96
N_PROMPTS = 8
#: float32 kernel vs plain version: both sum up to 128 keys in float32,
#: in different orders, over unit-scale inputs
KERNEL_ATOL = 1e-5
#: a greedy token must reach the plain recompute's max logit within this
#: (logits are O(10); engine and recompute differ only in f32 rounding)
GREEDY_LOGIT_TOL = 1e-2
#: depth of the token-level reference check (see reference_phase)
REFERENCE_LAYERS = 2
#: H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
#: dense TF32 tensor-core FLOP/s (same datasheet), and the TF32 products
#: a float32-accurate 3xTF32 product takes (big.small, small.big, big.big)
TF32_FLOPS = 495e12
TF32_PASSES = 3

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
#: phase 8's traces (Kineto and host, gzipped) and the monitor's JSONL
TRACE_DIR = OUT_DIR / "phase8"

KERNELS = [
    dict(name="ragged_paged_attention", route="cuda",
         source="paddle_tpu_torch/csrc/ragged_attention.cu",
         replaces="paddle_tpu/generation/ragged_attention.py:101",
         build="ragged_attention"),
    dict(name="paged_decode_attention", route="cuda",
         source="paddle_tpu_torch/csrc/paged_decode.cu",
         replaces="paddle_tpu/generation/attention.py:101",
         build="paged_decode"),
    dict(name="flash_fwd_packed", route="cuda",
         source="paddle_tpu_torch/csrc/flash_attention.cuh",
         replaces="paddle_tpu/ops/pallas_ops.py:148",
         build="flash_attention"),
    dict(name="flash_bwd_dq_packed", route="cuda",
         source="paddle_tpu_torch/csrc/flash_attention.cuh",
         replaces="paddle_tpu/ops/pallas_ops.py:445",
         build="flash_attention"),
    dict(name="flash_bwd_dkv_packed", route="cuda",
         source="paddle_tpu_torch/csrc/flash_attention.cuh",
         replaces="paddle_tpu/ops/pallas_ops.py:502",
         build="flash_attention"),
    dict(name="flash_fwd_qkv", route="cuda",
         source="paddle_tpu_torch/csrc/flash_attention.cuh",
         replaces="paddle_tpu/ops/attention_epilogue.py:119",
         build="flash_attention"),
    dict(name="gemm_epilogue", route="cuda",
         source="paddle_tpu_torch/csrc/gemm_epilogue.cuh",
         replaces="paddle_tpu/ops/pallas_matmul.py:161",
         build="gemm_epilogue"),
    dict(name="ffn_chain", route="cuda",
         source="paddle_tpu_torch/csrc/gemm_epilogue.cuh",
         replaces="paddle_tpu/ops/pallas_ffn_chain.py:163",
         build="gemm_epilogue"),
    dict(name="flash_fwd_flat", route="cuda",
         source="paddle_tpu_torch/csrc/flash_attention.cuh",
         replaces="paddle_tpu/ops/pallas_ops.py:88",
         build="flash_attention"),
    dict(name="flash_bwd_dq_flat", route="cuda",
         source="paddle_tpu_torch/csrc/flash_attention.cuh",
         replaces="paddle_tpu/ops/pallas_ops.py:335",
         build="flash_attention"),
    dict(name="flash_bwd_dkv_flat", route="cuda",
         source="paddle_tpu_torch/csrc/flash_attention.cuh",
         replaces="paddle_tpu/ops/pallas_ops.py:381",
         build="flash_attention"),
]


def _with_variants(kernels):
    """Each kernel that AMP runs followed by its bfloat16 and float16
    entries (built from ``<source>_amp.cu``), so the kernels line lists
    every variant beside its float32 entry."""
    out = []
    for k in kernels:
        out.append(k)
        if k["name"] in ("flash_fwd_packed", "flash_bwd_dq_packed",
                         "flash_bwd_dkv_packed", "flash_fwd_qkv",
                         "gemm_epilogue", "ffn_chain"):
            out += [dict(k, name=f"{k['name']}_{sfx}",
                         build=f"{k['build']}_amp") for sfx in ("bf16",
                                                                "f16")]
    return out


KERNELS = _with_variants(KERNELS)
#: legacy prompts: two prefill seq buckets (16 and 32) at page_size 16
LEGACY_LENGTHS = (8, 12, 16, 20, 24, 28, 32, 32)
#: shared prefix of the prefix-cache prompts: 4 full pages
PREFIX_LEN = 64
#: depth of the draft model: a cut of the target's own weights
DRAFT_LAYERS = 2

#: training: batch x tokens, Adam's learning rate, warm-up / timed /
#: parity steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 32, 128, 1e-4
TRAIN_WARMUP, TRAIN_STEPS, PARITY_STEPS = 2, 10, 5
#: timed steps of the unfused lowering beside the fused program
COMPARE_STEPS = 5
#: fused (kernel) vs unfused program at dropout 0: |loss difference| at
#: every step (the JAX package's _PARITY_TOL, __graft_entry__.py:26), and
#: the relative norm error of every first-step gradient
PARITY_LOSS_TOL, PARITY_GRAD_RTOL = 2e-3, 1e-3
#: flash kernels vs their plain versions: forward atol (o, lse: float32
#: online softmax over unit-scale keys, summed in another order);
#: gradients atol + rtol (dq, dk, dv, dbias sum a few hundred such
#: products per element, dbias over 12 heads too).  The flat cases hold
#: them unchanged up to 4096 keys: the scores are unit-scale, so a longer
#: sum adds rounding only as its square root and the online softmax's
#: rescaling keeps every partial sum below the row's total
FLASH_FWD_ATOL = 1e-5
FLASH_GRAD_ATOL = FLASH_GRAD_RTOL = 1e-4
#: kernel-phase cases: (B, Tq, Tk, nh, D, causal, strided qkv views,
#: dropout rate); "step" is one layer of the training step
FLASH_CASES = {
    "step": (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 12, 64, False, True, 0.0),
    "causal": (4, 128, 128, 12, 64, True, False, 0.0),
    "causal_tq_lt_tk": (4, 80, 128, 12, 64, True, False, 0.0),
    "t100": (4, 100, 100, 12, 64, False, True, 0.0),
    "d32": (4, 128, 128, 8, 32, False, False, 0.0),
    "d128": (4, 128, 128, 4, 128, False, False, 0.0),
    "dropout": (8, 128, 128, 12, 64, False, True, 0.1),
    # phase 11's StaticRNN decoder: its unfused attention op's shape
    "decoder": (N_PROMPTS, MAX_SEQ_LEN, MAX_SEQ_LEN, 12, 64, True, True,
                0.0),
    # phase 17: the NMT-big cross-attention of a training step (q of the
    # decoder, k/v of the encoder, a key-padding bias, attn_dropout 0.1)
    # and the beam decoder's (B·K rows of 32 tokens against 64 source
    # keys)
    "nmt_cross": (32, 256, 256, 16, 64, False, True, 0.1),
    "beam_cross": (32, 32, 64, 16, 64, False, True, 0.0),
    # phase 19: one of two model ranks' heads: BERT-base's unfused
    # attention (6 of 12, strided slices of the rank's qkv) and NMT-big's
    # cross-attention (8 of 16, q and kv from their own products)
    "tp_heads": (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 6, 64, False, True, 0.0),
    "tp_nmt_cross": (16, 128, 128, 8, 64, False, False, 0.0),
}
#: phase 11's causal LM attention (B, T, heads, d_head): #3 in the
#: StaticRNN decoder's unfused op, #9 in the fused build_lm_logits; no
#: key bias, dropout 0
DECODER_ATTN = (N_PROMPTS, MAX_SEQ_LEN, 12, 64)


#: (phase tag, host clock) of every phase's first line: the script's time
#: by phase (phases start with a "[n]" line)
PHASE_STARTS = []


def log(msg):
    if re.match(r"\[\d+\] ", msg):
        PHASE_STARTS.append((msg.split("]")[0] + "]", time.perf_counter()))
    print(msg, flush=True)


def phase_seconds():
    """Seconds from each phase's first line to the next's (the last to
    now)."""
    marks = PHASE_STARTS + [("end", time.perf_counter())]
    return {tag: round(b - a, 1)
            for (tag, a), (_, b) in zip(marks, marks[1:])}


def ptxas_entries(build_log):
    """[(entry function, registers, spill store bytes)] from ptxas -v
    output, one per kernel instantiation in the order ptxas compiled
    them."""
    entries, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name is not None:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            entries.append((name, int(m.group(1)), spill))
            name = None
    return entries


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.cache
def _spin_cycles_per_ms():
    """Clock cycles of torch.cuda._sleep per millisecond on this card."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_ms(fn, device, iters=200, warm=10):
    """Mean milliseconds of DEVICE time per call on the card: the calls
    are queued behind a spin kernel that outlasts the host's enqueueing
    of them (three times its measured length), so the CUDA events around
    them time the device's back-to-back execution, not the host's
    dispatch of a Python wrapper.  Host clock on the CPU, for
    rehearsals."""
    import torch

    for _ in range(warm):
        fn()
    sync(device)
    if device.type == "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        sync(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(3 * host_ms * _spin_cycles_per_ms()))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


# -- phase 2: kernel against its plain version ------------------------------

#: the serving-scale "long" cases of phase 2: a decode batch of
#: LONG_SLOTS sequences of up to LONG_PPS pages (2048 keys) at BERT-base
#: width, the ragged step's last slot prefilling a LONG_CHUNK-row chunk at
#: positions LONG_CHUNK_START.. (causal).  Their K/V (~0.8 GB of pool,
#: about half of it live) is far past the card's 50 MB L2, so the kernels
#: read it from HBM, where their byte bound is the real limit
LONG_SLOTS, LONG_PPS, LONG_CHUNK, LONG_CHUNK_START = 64, 128, 64, 1024


def _randn_pages(num_pages, hidden, device, seed):
    """k_pages, v_pages [num_pages, PAGE_SIZE, hidden] drawn on the
    device itself (a long case's pool is ~0.8 GB)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(num_pages, PAGE_SIZE, hidden, generator=g,
                        device=device) for _ in range(2)]


def ragged_case(rng, kind, num_heads, hidden, block_rows, device):
    """One step's ragged-attention inputs as the engine builds them:
    slots of PAGE_SIZE-token pages (pool = every slot at full length +
    scratch page 0), a decode block per slot, then the prefill chunk
    blocks bound to the last slot, which is still prefilling (its decode
    row is inactive).  ``kind``:

    * "step" — MAX_SEQS slots, decode lengths at random in [1,
      MAX_SEQ_LEN] (mostly not page multiples), the chunk = prompt
      positions 16..31 (causal);
    * "full" — every decode row at MAX_SEQ_LEN, the chunk at 0..15;
    * "long" — LONG_SLOTS slots of LONG_PPS pages, decode lengths at
      random in [1, LONG_PPS * PAGE_SIZE], the chunk = LONG_CHUNK rows at
      LONG_CHUNK_START.. (K/V drawn on the device).
    """
    import torch

    long = kind == "long"
    slots = LONG_SLOTS if long else MAX_SEQS
    pps = LONG_PPS if long else MAX_SEQ_LEN // PAGE_SIZE
    cap = pps * PAGE_SIZE
    num_pages = slots * pps + 1
    chunk_rows = LONG_CHUNK if long else 16
    nb = slots + -(-chunk_rows // block_rows)
    R = nb * block_rows
    pages = rng.permutation(np.arange(1, num_pages)).reshape(slots, pps)
    tables = np.zeros((nb, pps), np.int32)
    lens = np.zeros(R, np.int32)
    for s in range(slots - 1):
        tables[s] = pages[s]
        lens[s * block_rows] = (cap if kind == "full"
                                else rng.randint(1, cap + 1))
    prefill = slots - 1
    start = {"full": 0, "step": 16, "long": LONG_CHUNK_START}[kind]
    for j in range(chunk_rows):
        blk = slots + j // block_rows
        tables[blk] = pages[prefill]
        lens[blk * block_rows + j % block_rows] = start + j + 1
    seed = int(rng.randint(2 ** 31))
    if long:
        kp, vp = _randn_pages(num_pages, hidden, device, seed)
        g = torch.Generator(device=device).manual_seed(seed + 1)
        q = torch.randn(R, hidden, generator=g, device=device)
    else:
        g = torch.Generator().manual_seed(seed)
        kp = torch.randn(num_pages, PAGE_SIZE, hidden, generator=g)
        vp = torch.randn(num_pages, PAGE_SIZE, hidden, generator=g)
        q = torch.randn(R, hidden, generator=g)
    return dict(q=q.to(device), k_pages=kp.to(device), v_pages=vp.to(device),
                block_tables=torch.from_numpy(tables).to(device),
                row_lens=torch.from_numpy(lens).to(device),
                num_heads=num_heads, block_rows=block_rows)


def ragged_bound_ms(case):
    """Least time for the rows' work: bytes = q + out + tables + lengths
    + the distinct K/V positions the rows need (each read once); ops =
    2 flops per element of q.k and of p.v over every visible key."""
    tables = case["block_tables"].cpu().numpy()
    lens = case["row_lens"].cpu().numpy()
    R, H = case["q"].shape
    bm = case["block_rows"]
    needed = np.zeros((case["k_pages"].shape[0], PAGE_SIZE), bool)
    flops = 0
    for r in range(R):
        n = int(min(lens[r], tables.shape[1] * PAGE_SIZE))
        full, rem = divmod(n, PAGE_SIZE)
        row = tables[r // bm]
        needed[row[:full]] = True
        if rem:
            needed[row[full], :rem] = True
        flops += 4 * n * H
    nbytes = (2 * R * H * 4 + tables.size * 4 + lens.size * 4
              + int(needed.sum()) * H * 4 * 2)
    return _bound(flops, nbytes)


def paged_timing(fn, plain, case, tables, lens_key, bound, device):
    """Device times of one case: the kernel, its launch floor (the same
    kernel on the same shapes with every length 0), the plain version,
    PyTorch's fused attention over the rows' context gathered beforehand
    (a yardstick the port never calls), and the bound."""
    import torch
    import torch.nn.functional as F

    ms = time_ms(lambda: fn(**case), device)
    empty = dict(case, **{lens_key: torch.zeros_like(case[lens_key])})
    floor_ms = time_ms(lambda: fn(**empty), device)
    plain_ms = time_ms(lambda: plain(**case), device)
    R, H = case["q"].shape
    nh = case["num_heads"]
    D = H // nh
    L = tables.shape[1] * PAGE_SIZE
    idx = tables.long()
    kctx = case["k_pages"][idx].reshape(R, L, nh, D).transpose(1, 2)
    vctx = case["v_pages"][idx].reshape(R, L, nh, D).transpose(1, 2)
    qh = case["q"].reshape(R, nh, 1, D)
    mask = (torch.arange(L, device=device)[None, None, None, :]
            < case[lens_key].long()[:, None, None, None])
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kctx, vctx, attn_mask=mask), device)
    del kctx, vctx
    bound_ms, bound_by, nbytes, flops = bound(case)
    return dict(ms=ms, floor_ms=floor_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops)


def log_timing(what, case_name, t):
    log(f"  {what} timing ({case_name} case): ms={t['ms']:.5f} "
        f"floor_ms(every length 0)={t['floor_ms']:.5f} plain_ms="
        f"{t['plain_ms']:.5f} library_ms(sdpa, context pre-gathered)="
        f"{t['library_ms']:.5f} bound_ms={t['bound_ms']:.6f} "
        f"({t['bound_by']}: {t['bytes']} bytes, {t['flops']} flops)")


def ragged_cases(device, model_cfg):
    """Phase 2's ragged-attention cases, from the phase's seed."""
    rng = np.random.RandomState(SEED + 100)
    nh, H = model_cfg.num_heads, model_cfg.hidden_size
    return {"step": ragged_case(rng, "step", nh, H, 1, device),
            "step_block_rows_2": ragged_case(rng, "step", nh, H, 2, device),
            "full": ragged_case(rng, "full", nh, H, 1, device),
            "long": ragged_case(rng, "long", nh, H, 1, device)}


def kernel_phase(device, model_cfg):
    from paddle_tpu_torch.generation.ragged_attention import (
        ragged_paged_attention, ragged_ref_attention)

    nh, H = model_cfg.num_heads, model_cfg.hidden_size
    cases = ragged_cases(device, model_cfg)
    worst = 0.0
    report = {}
    for name, c in cases.items():
        out = ragged_paged_attention(**c)
        ref = ragged_ref_attention(**c)
        sync(device)
        err = float((out - ref).abs().max())
        inactive = (c["row_lens"] == 0).nonzero().flatten()
        zeros = bool((out[inactive] == 0).all())
        rows = c["q"].shape[0]
        log(f"  kernel {name}: R={rows} H={H} heads={nh} block_rows="
            f"{c['block_rows']} pages_per_seq={c['block_tables'].shape[1]} "
            f"inactive_rows={len(inactive)} max_abs_err={err:.3e} (atol "
            f"{KERNEL_ATOL:g}) inactive_exact_zero={zeros}")
        if not np.isfinite(err) or err > KERNEL_ATOL or not zeros:
            raise AssertionError(f"kernel disagrees with plain on {name}")
        worst = max(worst, err)
        report[name] = dict(rows=rows, block_rows=c["block_rows"],
                            max_abs_err=err)
        del out, ref

    for name, key in (("step", "timing"), ("long", "timing_long")):
        c = cases[name]
        tables = c["block_tables"].repeat_interleave(c["block_rows"], 0)
        report[key] = paged_timing(
            ragged_paged_attention, ragged_ref_attention, c, tables,
            "row_lens", ragged_bound_ms, device)
        log_timing("kernel", name, report[key])
    report["max_abs_err"] = worst
    return report


def decode_case(rng, head_dim, device, tight=False, long=False):
    """One legacy decode step's paged-decode inputs: MAX_SEQS slots (or,
    ``long``, LONG_SLOTS slots of up to LONG_PPS pages, K/V drawn on the
    device), hidden 768 split into heads of ``head_dim``, PAGE_SIZE-token
    pages, lengths drawn from 0..capacity with 0, 1, one page, one page
    + 1 and the full capacity among them.  The pool holds every slot's
    full table (65 pages at the slice's shapes) or, ``tight``, only the
    live pages, with the tables' tails on scratch page 0 as the cache
    leaves them."""
    import torch

    H = 768
    slots = LONG_SLOTS if long else MAX_SEQS
    pps = LONG_PPS if long else MAX_SEQ_LEN // PAGE_SIZE
    cap = pps * PAGE_SIZE
    lens = rng.randint(0, cap + 1, slots)
    lens[:5] = (0, 1, PAGE_SIZE, PAGE_SIZE + 1, cap)
    live = [-(-int(n) // PAGE_SIZE) for n in lens]
    num_pages = 1 + (sum(live) if tight else slots * pps)
    pages = rng.permutation(np.arange(1, num_pages))
    tables = np.zeros((slots, pps), np.int32)
    at = 0
    for s in range(slots):
        n = live[s] if tight else pps
        tables[s, :n] = pages[at:at + n]
        at += n
    seed = int(rng.randint(2 ** 31))
    if long:
        kp, vp = _randn_pages(num_pages, H, device, seed)
        g = torch.Generator(device=device).manual_seed(seed + 1)
        q = torch.randn(slots, H, generator=g, device=device)
    else:
        g = torch.Generator().manual_seed(seed)
        kp = torch.randn(num_pages, PAGE_SIZE, H, generator=g)
        vp = torch.randn(num_pages, PAGE_SIZE, H, generator=g)
        q = torch.randn(slots, H, generator=g)
    return dict(q=q.to(device), k_pages=kp.to(device), v_pages=vp.to(device),
                page_table=torch.from_numpy(tables).to(device),
                eff_lens=torch.from_numpy(lens.astype(np.int32)).to(device),
                num_heads=H // head_dim)


def decode_bound_ms(case):
    """Least time for the slots' work: bytes = q + out + the table + the
    lengths + K and V of every key < eff_len (each read once); ops = 2
    flops per element of q.k and of p.v over every live key."""
    cap = case["page_table"].shape[1] * PAGE_SIZE
    lens = np.minimum(case["eff_lens"].cpu().numpy(), cap)
    S, H = case["q"].shape
    keys = int(lens.sum())
    nbytes = (2 * S * H * 4 + case["page_table"].numel() * 4 + S * 4
              + keys * H * 4 * 2)
    flops = 4 * keys * H
    return _bound(flops, nbytes)


def decode_cases(device):
    """Phase 2's paged-decode cases, from the phase's seed."""
    rng = np.random.RandomState(SEED + 200)
    return {"step": decode_case(rng, 64, device),
            "head_dim_32": decode_case(rng, 32, device),
            "head_dim_128": decode_case(rng, 128, device),
            "tight_pool": decode_case(rng, 64, device, tight=True),
            "long": decode_case(rng, 64, device, long=True)}


def decode_kernel_phase(device):
    """The paged decode kernel against paged_ref_decode_attention: live
    slots within KERNEL_ATOL, empty slots exactly zero."""
    from paddle_tpu_torch.generation.attention import (
        paged_decode_attention, paged_plain_decode_attention,
        paged_ref_decode_attention)

    cases = decode_cases(device)
    worst = 0.0
    report = {}
    for name, c in cases.items():
        out = paged_decode_attention(**c)
        ref = paged_ref_decode_attention(**c)
        sync(device)
        live = c["eff_lens"] > 0
        err = float((out[live] - ref[live]).abs().max())
        zeros = bool((out[~live] == 0).all())
        lens = c["eff_lens"].tolist()
        log(f"  paged decode {name}: S={len(lens)} heads={c['num_heads']} "
            f"pages={c['k_pages'].shape[0]} lens="
            f"{lens if len(lens) <= MAX_SEQS else lens[:8] + ['...']} "
            f"max_abs_err={err:.3e} (atol {KERNEL_ATOL:g}) "
            f"empty_slots_exact_zero={zeros}")
        if not np.isfinite(err) or err > KERNEL_ATOL or not zeros:
            raise AssertionError(f"paged decode kernel disagrees on {name}")
        worst = max(worst, err)
        report[name] = dict(heads=c["num_heads"],
                            num_pages=int(c["k_pages"].shape[0]),
                            lens=lens, max_abs_err=err)
        del out, ref

    for name, key in (("step", "timing"), ("long", "timing_long")):
        c = cases[name]
        report[key] = paged_timing(
            paged_decode_attention, paged_plain_decode_attention, c,
            c["page_table"], "eff_lens", decode_bound_ms, device)
        log_timing("paged decode", name, report[key])
    report["max_abs_err"] = worst
    return report


def flash_case(device, B, Tq, Tk, nh, D, causal, strided, rate, seed=0):
    """One flash-attention call's inputs: q, k, v (column slices of one
    [B, T, 3H] tensor when ``strided``, as the BERT layer passes them),
    the key-padding bias that masks the last quarter of the keys of half
    the batch (0 / -1e4, as BERT's input mask makes it), an output
    cotangent."""
    import torch

    g = torch.Generator().manual_seed(SEED + 300 + seed)
    H = nh * D
    if strided:
        qkv = torch.randn(B, max(Tq, Tk), 3 * H, generator=g).to(device)
        q, k, v = qkv[:, :Tq, :H], qkv[:, :Tk, H:2 * H], qkv[:, :Tk, 2 * H:]
    else:
        q = torch.randn(B, Tq, H, generator=g).to(device)
        k, v = (torch.randn(B, Tk, H, generator=g).to(device)
                for _ in range(2))
    bias = torch.zeros(B, Tk)
    bias[: B // 2, Tk - Tk // 4:] = -1e4
    do = torch.randn(B, Tq, H, generator=g).to(device)
    return dict(q=q, k=k, v=v, bias=bias.to(device), num_heads=nh,
                causal=causal, dropout_rate=rate, seed=SEED + 1234 + seed), do


def flash_bounds(c):
    """Least time of each kernel's work at this call: flops = 2 per
    multiply-add of its products over every (query, key, dim) — forward
    q.k and p.v (4), dq adds do.v and ds.k (6), dk/dv adds p.do and ds.q
    (8) — over the 3xTF32 tensor-core rate (``_tc_bound``), where all
    three run; bytes = each input read once and each output written once
    over HBM's rate.  Returns {kernel: (ms, bound_by, bytes, flops, float32
    FMA ms)}."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, Tq, H = c["q"].shape
    Tk, nh = c["k"].shape[1], c["num_heads"]
    unit = B * nh * Tq * Tk * (H // nh)
    q_b, kv_b = B * Tq * H * 4, B * Tk * H * 4
    rows, bias_b = B * nh * Tq * 4, B * Tk * 4
    work = {
        fa.FWD: (4 * unit, q_b + 2 * kv_b + bias_b + q_b + rows),
        fa.DQ: (6 * unit, q_b + 2 * kv_b + bias_b + q_b + 2 * rows + q_b),
        fa.DKV: (8 * unit, q_b + 2 * kv_b + bias_b + q_b + 2 * rows
                 + 2 * kv_b + B * nh * Tk * 4),
    }
    return {name: _tc_bound(*w) for name, w in work.items()}


def _tol_excess(got, want, atol, rtol):
    """max(|got - want| - rtol * |want|): <= atol is torch's allclose."""
    return float(((got - want).abs() - rtol * want.abs()).max())


def flash_kernel_phase(device):
    """The three flash kernels against flash_ref_forward / _backward in
    every FLASH_CASES case (dropout through the kernels' own mask, whose
    keep fraction must lie within 4 sigma of 1 - rate), then their times
    at the training step's shape and dropout."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.models import BertConfig
    from paddle_tpu_torch.ops import flash_attention as fa

    errs = {fa.FWD: 0.0, fa.DQ: 0.0, fa.DKV: 0.0}
    cases = {}
    for name, spec in FLASH_CASES.items():
        c, do = flash_case(device, *spec)
        B, Tq, _ = c["q"].shape
        Tk, nh, rate = c["k"].shape[1], c["num_heads"], c["dropout_rate"]
        kw = dict(bias=c["bias"], causal=c["causal"], dropout_rate=rate)
        mask, keep = None, None
        if rate > 0:
            mask = fa.flash_kernel_dropout_mask(B, nh, Tq, Tk, rate,
                                                c["seed"], device)
            keep = float(mask.float().mean())
            sigma = (rate * (1 - rate) / mask.numel()) ** 0.5
            if abs(keep - (1 - rate)) > 4 * sigma:
                raise AssertionError(
                    f"flash dropout keeps {keep}, not within 4 sigma "
                    f"({sigma:.2e}) of {1 - rate}")
        o, lse = fa.flash_kernel_forward(c["q"], c["k"], c["v"], nh,
                                         seed=c["seed"], **kw)
        o_ref, lse_ref = fa.flash_ref_forward(c["q"], c["k"], c["v"], nh,
                                              keep_mask=mask, **kw)
        delta = fa.flash_delta(o, do, nh)
        bw = dict(causal=c["causal"], dropout_rate=rate, seed=c["seed"])
        dq = fa.flash_kernel_dq(c["q"], c["k"], c["v"], c["bias"], do, lse,
                                delta, nh, **bw)
        dk, dv, dbias_h = fa.flash_kernel_dkv(c["q"], c["k"], c["v"],
                                              c["bias"], do, lse, delta, nh,
                                              **bw)
        refs = fa.flash_ref_backward(c["q"], c["k"], c["v"], c["bias"],
                                     o_ref, lse_ref, do, nh,
                                     causal=c["causal"], dropout_rate=rate,
                                     keep_mask=mask)
        sync(device)
        got = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv, dbias=dbias_h.sum(1))
        want = dict(zip(("o", "lse"), (o_ref, lse_ref)))
        want.update(zip(("dq", "dk", "dv", "dbias"), refs))
        err = {n: float((got[n] - want[n]).abs().max()) for n in got}
        fwd_ok = max(err["o"], err["lse"]) <= FLASH_FWD_ATOL
        grad_ok = all(_tol_excess(got[n], want[n], FLASH_GRAD_ATOL,
                                  FLASH_GRAD_RTOL) <= FLASH_GRAD_ATOL
                      for n in ("dq", "dk", "dv", "dbias"))
        finite = all(bool(torch.isfinite(t).all()) for t in got.values())
        log(f"  flash {name}: B={B} Tq={Tq} Tk={Tk} nh={nh} D="
            f"{c['q'].shape[2] // nh} causal={c['causal']} strided="
            f"{not c['q'].is_contiguous()} dropout={rate}"
            + (f" keep={keep:.5f}" if keep is not None else "")
            + " max_abs_err " + " ".join(f"{n}={e:.3e}" for n, e in
                                          err.items())
            + f" (fwd atol {FLASH_FWD_ATOL:g}; grads atol {FLASH_GRAD_ATOL:g}"
            f" rtol {FLASH_GRAD_RTOL:g})")
        if not (fwd_ok and grad_ok and finite):
            raise AssertionError(f"flash kernels disagree with plain on "
                                 f"{name}")
        errs[fa.FWD] = max(errs[fa.FWD], err["o"], err["lse"])
        errs[fa.DQ] = max(errs[fa.DQ], err["dq"])
        errs[fa.DKV] = max(errs[fa.DKV], err["dk"], err["dv"], err["dbias"])
        cases[name] = dict(err, keep_fraction=keep)

    # times at one layer of the training step, with its dropout rate
    spec = FLASH_CASES["step"][:-1] + (BertConfig.base().attn_dropout,)
    c, do = flash_case(device, *spec)
    nh, rate = c["num_heads"], c["dropout_rate"]
    B, Tq, H = c["q"].shape
    D = H // nh
    qkv = (c["q"], c["k"], c["v"])
    mask = fa.flash_kernel_dropout_mask(B, nh, Tq, c["k"].shape[1], rate,
                                        c["seed"], device)
    o, lse = fa.flash_kernel_forward(*qkv, nh, bias=c["bias"],
                                     dropout_rate=rate, seed=c["seed"])
    delta = fa.flash_delta(o, do, nh)
    bw = dict(dropout_rate=rate, seed=c["seed"])
    times = {
        fa.FWD: time_ms(lambda: fa.flash_kernel_forward(
            *qkv, nh, bias=c["bias"], dropout_rate=rate, seed=c["seed"]),
            device),
        fa.DQ: time_ms(lambda: fa.flash_kernel_dq(
            *qkv, c["bias"], do, lse, delta, nh, **bw), device),
        fa.DKV: time_ms(lambda: fa.flash_kernel_dkv(
            *qkv, c["bias"], do, lse, delta, nh, **bw), device),
    }
    no_dropout_ms = {
        fa.FWD: time_ms(lambda: fa.flash_kernel_forward(
            *qkv, nh, bias=c["bias"]), device),
        fa.DQ: time_ms(lambda: fa.flash_kernel_dq(
            *qkv, c["bias"], do, lse, delta, nh), device),
        fa.DKV: time_ms(lambda: fa.flash_kernel_dkv(
            *qkv, c["bias"], do, lse, delta, nh), device)}
    plain_fwd = time_ms(lambda: fa.flash_ref_forward(
        *qkv, nh, bias=c["bias"], dropout_rate=rate, keep_mask=mask), device)
    plain_bwd = time_ms(lambda: fa.flash_ref_backward(
        *qkv, c["bias"], o, lse, do, nh, dropout_rate=rate, keep_mask=mask),
        device)
    # yardstick: PyTorch's fused attention on the same heads and bias
    # (forward for the forward kernel; its autograd backward, dq, dk and
    # dv together, for the two backward kernels); the port never calls it
    heads = [x.reshape(B, -1, nh, D).transpose(1, 2).contiguous()
             .requires_grad_() for x in qkv]
    attn_mask = c["bias"][:, None, None, :]
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        *heads, attn_mask=attn_mask, dropout_p=rate), device)
    lib_out = F.scaled_dot_product_attention(*heads, attn_mask=attn_mask,
                                             dropout_p=rate)
    do_h = do.reshape(B, Tq, nh, D).transpose(1, 2).contiguous()
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, heads, do_h, retain_graph=True), device)
    bounds = flash_bounds(c)
    report = {}
    for name in (fa.FWD, fa.DQ, fa.DKV):
        bound_ms, bound_by, nbytes, flops, fma_ms = bounds[name]
        fwd = name == fa.FWD
        report[name] = dict(max_abs_err=errs[name], cases=cases, timing=dict(
            ms=times[name], ms_without_dropout=no_dropout_ms[name],
            plain_ms=plain_fwd if fwd else plain_bwd,
            library_ms=lib_fwd if fwd else lib_bwd, bound_ms=bound_ms,
            bound_by=bound_by, bytes=nbytes, flops=flops,
            fma_bound_ms=fma_ms,
            bound_rate="3xTF32 on the tensor cores, 495 TFLOP/s TF32",
            shape=dict(B=B, T=Tq, nh=nh, D=D, dropout=rate)))
        log(f"  {name} timing (B={B} T={Tq} nh={nh} D={D} dropout={rate}): "
            f"ms={times[name]:.5f} (no dropout {no_dropout_ms[name]:.5f}) "
            f"plain_ms={report[name]['timing']['plain_ms']:.5f} library_ms"
            f"(sdpa {'forward' if fwd else 'backward, dq+dk+dv'})="
            f"{report[name]['timing']['library_ms']:.5f} bound_ms="
            f"{bound_ms:.6f} ({bound_by}: {nbytes} bytes, {flops} flops; "
            f"3xTF32) fma_bound_ms={fma_ms:.5f}")
    return report


def _epi_case(M, K, N, seed, bias=True, residual=False, gamma=False,
              beta=False, **spec):
    """Inputs of one fused matmul-epilogue call: x [M, K] and a residual
    of unit scale, w scaled by 1 / sqrt(K) (so z is of unit scale too),
    bias, gamma and beta near their BERT values."""
    import torch

    from paddle_tpu_torch.ops.fused_matmul import EpilogueSpec

    g = torch.Generator().manual_seed(SEED + 400 + seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    return dict(x=rnd(M, K), w=rnd(K, N, scale=K ** -0.5),
                bias=rnd(N, scale=0.1) if bias else None,
                residual=rnd(M, N) if residual else None,
                gamma=rnd(N, scale=0.1, shift=1.0) if gamma else None,
                beta=rnd(N, scale=0.1) if beta else None,
                seed=SEED + 4321 + seed, spec=EpilogueSpec(**spec))


#: fused matmul-epilogue cases: (M, K, N, options); "step" is the attention
#: output projection of the training step (bias, dropout, residual, layer
#: norm), "relu" the FFN's up-projection shape, "ragged" an M and N that
#: fill no tile (its rows wider than one chunk of 768 columns)
GEMM_CASES = {
    "step": (TRAIN_BATCH * TRAIN_SEQ, 768, 768, dict(
        residual=True, gamma=True, beta=True, dropout_rate=0.1,
        norm="layer_norm")),
    "no_bias": (TRAIN_BATCH * TRAIN_SEQ, 768, 768, dict(bias=False)),
    "relu": (TRAIN_BATCH * TRAIN_SEQ, 768, 3072, dict(act="relu")),
    "gelu_tanh": (512, 768, 3072, dict(act="gelu", act_approximate=True)),
    "no_norm": (TRAIN_BATCH * TRAIN_SEQ, 768, 768, dict(
        residual=True, dropout_rate=0.1)),
    "rms_norm": (TRAIN_BATCH * TRAIN_SEQ, 768, 768, dict(
        residual=True, gamma=True, norm="rms_norm")),
    "affine_only": (TRAIN_BATCH * TRAIN_SEQ, 768, 768, dict(residual=True)),
    "ragged": (1000, 512, 1000, dict(
        act="gelu", residual=True, gamma=True, beta=True, dropout_rate=0.1,
        norm="layer_norm")),
    "n128": (96, 64, 128, dict(act="gelu", gamma=True, beta=True,
                               norm="layer_norm")),
    # the widest rows the rule takes (the chunk walk, the norm from y) and
    # a K that is a tail of one 32-deep stage
    "n8192": (512, 768, 8192, dict(residual=True, gamma=True, beta=True,
                                   norm="layer_norm")),
    "k24": (1000, 24, 768, dict(residual=True, gamma=True, beta=True,
                                dropout_rate=0.1, norm="layer_norm")),
    # phase 17: NMT-big's FFN as two calls (N 1024 is past the chain's
    # 768: K 1024 -> N 4096 relu, K 4096 -> N 1024 with the tail), its
    # projections (K 1024 -> N 3072 and N 2048), ResNet-50's classifier
    "nmt_ffn_up": (8192, 1024, 4096, dict(act="relu")),
    "nmt_ffn_down": (8192, 4096, 1024, dict(
        residual=True, gamma=True, beta=True, dropout_rate=0.3,
        norm="layer_norm")),
    "nmt_n3072": (8192, 1024, 3072, dict()),
    "nmt_kv": (8192, 1024, 2048, dict()),
    "resnet_fc": (256, 2048, 1000, dict()),
    # phase 19: the Megatron split's GEMMs on one of two model ranks
    # (TP_SPLIT_CASES): BERT-base's row-parallel attention output (K
    # 384, epilogue off) at 19a's rows; NMT-big's at 19b's, its
    # row-parallel self/cross outputs (K 512) and FFN down half (K 2048)
    # with the epilogue off, the FFN's column half (relu), the cross q
    # and kv at their local columns
    "tp_attn_out": (TRAIN_BATCH * TRAIN_SEQ, 384, 768, dict(bias=False)),
    "tp_nmt_out": (2048, 512, 1024, dict(bias=False)),
    "tp_nmt_ffn_up": (2048, 1024, 2048, dict(act="relu")),
    "tp_nmt_ffn_down": (2048, 2048, 1024, dict(bias=False)),
    "tp_nmt_cross_q": (2048, 1024, 512, dict()),
    "tp_nmt_cross_kv": (2048, 1024, 1024, dict()),
}
#: FFN-chain cases: (M, K, F, N, options); "step" is one layer's FFN
FFN_CASES = {
    "step": (TRAIN_BATCH * TRAIN_SEQ, 768, 3072, 768, dict(
        act="gelu", residual=True, gamma=True, beta=True, dropout_rate=0.1,
        norm="layer_norm")),
    "relu": (TRAIN_BATCH * TRAIN_SEQ, 768, 3072, 768, dict(
        act="relu", residual=True, gamma=True, beta=True,
        norm="layer_norm")),
    "no_b2": (TRAIN_BATCH * TRAIN_SEQ, 768, 3072, 768, dict(
        act="gelu", bias=False)),
    "ragged": (1000, 256, 1024, 512, dict(
        act="gelu", residual=True, gamma=True, dropout_rate=0.1,
        norm="rms_norm")),
    "n128": (96, 64, 128, 128, dict(act="gelu", residual=True, gamma=True,
                                    beta=True, norm="layer_norm")),
    # the edges of the cluster-pair tiles (64 rows, panels of 512, half of
    # N a CTA): fewer rows than a cluster, a partial last panel and the
    # second half of N past N; 1000 rows with N 500 (a ragged second
    # half); a K whose x rows the one-CTA kernel could not hold
    "m40_n384": (40, 256, 640, 384, dict(
        act="gelu", residual=True, gamma=True, beta=True, dropout_rate=0.1,
        norm="layer_norm")),
    "n500": (1000, 128, 640, 500, dict(act="relu", residual=True, gamma=True,
                                       beta=True, norm="layer_norm")),
    "k2048": (256, 2048, 1024, 768, dict(act="gelu", residual=True,
                                         dropout_rate=0.1)),
    # phase 19: BERT-base's FFN on one of two model ranks (F 1536, gelu,
    # no b2, no tail: the sum over model and the epilogue follow)
    "tp_split": (TRAIN_BATCH * TRAIN_SEQ, 768, 1536, 768, dict(
        act="gelu", bias=False)),
}
#: qkv-folded flash forward cases: (B, T, nh, D, causal, key-padding bias,
#: dropout rate); "step" is one layer of the training step
QKV_CASES = {
    "step": (TRAIN_BATCH, TRAIN_SEQ, 12, 64, False, True, 0.1),
    "causal": (4, 128, 12, 64, True, True, 0.0),
    "no_bias": (4, 128, 12, 64, False, False, 0.0),
    "t100_d32": (4, 100, 8, 32, False, True, 0.0),
    "decoder": (N_PROMPTS, MAX_SEQ_LEN, 12, 64, True, False, 0.0),
    # phase 17: NMT-big's encoder self-attention (key padding, dropout
    # 0.1) and its decoder's causal one
    "nmt": (32, 256, 16, 64, False, True, 0.1),
    "nmt_causal": (32, 256, 16, 64, True, False, 0.1),
    # phase 19: one of two model ranks' heads (QKV_HIDDEN: x keeps the
    # layer's whole width) in BERT-base (6 of 12) and NMT-big's encoder
    # and decoder (8 of 16) at 19a's and 19b's batches
    "tp": (TRAIN_BATCH, TRAIN_SEQ, 6, 64, False, True, 0.1),
    "tp_nmt": (16, 128, 8, 64, False, True, 0.0),
    "tp_nmt_causal": (16, 128, 8, 64, True, False, 0.0),
}
#: the input width K of the qkv cases whose heads are a model rank's part
#: of the layer (x [B, T, K], w [K, 3 nh D]); the others read nh D
QKV_HIDDEN = {"tp": 768, "tp_nmt": 1024, "tp_nmt_causal": 1024}
#: the phase-2 cases at the split's shapes (phase 19): their gradients
#: are held against the plain versions' too
TP_SPLIT_CASES = ("tp_attn_out", "tp_nmt_out", "tp_nmt_ffn_up",
                  "tp_nmt_ffn_down", "tp_nmt_cross_q", "tp_nmt_cross_kv",
                  "tp_split")
#: fused matmul / FFN chain against their plain versions: atol + rtol
#: (float32 sums over K = 768 or F = 3072 unit-scale products in another
#: order than cuBLAS's; the norm divides by a row's spread)
EPI_ATOL = EPI_RTOL = 1e-4
#: the qkv cases whose weight gradient sums more rows than the step's
#: 4096 (NMT-big's 8192): float32 rounding of that sum alone passes the
#: elementwise atol at its near-zero elements, so their gradients are
#: held by the relative norm error of each gradient tensor instead (the
#: elementwise excess is reported beside)
QKV_LONG_ROWS = ("nmt", "nmt_causal")
QKV_GRAD_REL_TOL = 1e-5


def _gemm_bound(M, K, N, c, z0, dropout):
    """#10's work at one call: 2 flops per multiply-add of x w, run as
    3xTF32 on the tensor cores (``_tc_bound``); bytes: x, w, y, z0, the
    mask, the residual, bias, gamma, beta, each once."""
    flops = 2 * M * K * N
    nbytes = 4 * (M * K + K * N + M * N) + (M * N if dropout else 0)
    nbytes += 4 * M * N * (bool(z0) + (c["residual"] is not None))
    nbytes += 4 * N * sum(c[k] is not None for k in ("bias", "gamma", "beta"))
    return _tc_bound(flops, nbytes)


def _bound(flops, nbytes):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def _tc_bound(flops, nbytes):
    """The bound of a kernel whose products run as 3xTF32 on the tensor
    cores (three TF32 flops per flop over the TF32 peak), and its float32
    FMA bound beside, as earlier runs reported it: (ms, bound_by, bytes,
    flops, fma_ms)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = TF32_PASSES * flops / TF32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops, _bound(flops, nbytes)[0])


def _keep_ok(mask, rate):
    keep = float(mask.float().mean())
    sigma = (rate * (1 - rate) / mask.numel()) ** 0.5
    if abs(keep - (1 - rate)) > 4 * sigma:
        raise AssertionError(f"dropout keeps {keep}, not within 4 sigma "
                             f"({sigma:.2e}) of {1 - rate}")
    return keep


def _grad_check(fn_kernel, fn_plain, inputs, dy, rel=False):
    """Gradients of a kernel-backed autograd function against those of
    its plain version: the worst atol excess at EPI_RTOL, or with
    ``rel`` (excess, the worst relative norm error of a gradient).  A
    None input stays None and has no gradient."""
    import torch

    live = [i for i, t in enumerate(inputs) if t is not None]

    def grads(fn):
        args = list(inputs)
        for i in live:
            args[i] = inputs[i].detach().clone().requires_grad_()
        return torch.autograd.grad(fn(*args), [args[i] for i in live], dy)

    got, want = grads(fn_kernel), grads(fn_plain)
    excess = max(_tol_excess(a, b, EPI_ATOL, EPI_RTOL)
                 for a, b in zip(got, want))
    if not rel:
        return excess
    return excess, max(_rel_norm(a, b) for a, b in zip(got, want))


def _relu_tied_plain(fm, spec, mask, z0, z0_ref):
    """The plain version whose gradients a case's kernel is held to, and
    for a relu epilogue the count of products on the other side of 0
    from the plain ones.  Under relu the plain version is handed the
    kernel's activation mask (z0 > 0), as it is handed the kernel's
    dropout mask: a product within rounding of 0 may fall on either
    side, and its element of dy then counts in one gradient and not in
    the other."""
    if spec.act != "relu":
        return (lambda *t: fm.reference_matmul_epilogue(
            *t, spec=spec, mask=mask)[0]), None
    if spec.norm is not None or spec.dropout_rate > 0.0:
        raise ValueError("a relu case's gradients are checked without a "
                         "dropout or norm after it")
    active = z0 > 0
    ties = int((active != (z0_ref > 0)).sum())
    affine = spec._replace(act=None)

    def plain(x, w, bias, residual, gamma, beta):
        z = fm.reference_matmul_epilogue(x, w, bias, spec=affine)[0]
        z = z * active.to(z.dtype)
        return z if residual is None else z + residual
    return plain, ties


def epilogue_kernel_phase(device):
    """The fused matmul-epilogue (#10) and FFN-chain (#11) kernels against
    their plain versions (handed the kernels' own dropout masks) in every
    GEMM_CASES / FFN_CASES case, each chain mask against #10's at the same
    seed (bit for bit), gradients of the step cases through the autograd
    functions, then the times of the step cases."""
    import torch

    from paddle_tpu_torch.ops import ffn_chain as fc
    from paddle_tpu_torch.ops import fused_matmul as fm

    report = {fm.LAUNCH: dict(max_abs_err=0.0, cases={}),
              fc.LAUNCH: dict(max_abs_err=0.0, cases={})}
    made = {}
    for name, (M, K, N, opts) in GEMM_CASES.items():
        c = _epi_case(M, K, N, len(made), **opts)
        c = {k: (v.to(device) if torch.is_tensor(v) else v)
             for k, v in c.items()}
        made["gemm", name] = c
        args = [c[k] for k in ("x", "w", "bias", "residual", "gamma", "beta")]
        y, z0, mask = fm.fused_matmul_kernel(*args, seed=c["seed"],
                                             spec=c["spec"])
        y_ref, z0_ref = fm.reference_matmul_epilogue(
            *args, spec=c["spec"], mask=mask)
        sync(device)
        keep = _keep_ok(mask, c["spec"].dropout_rate) if mask is not None \
            else None
        err = float((y - y_ref).abs().max())
        excess = _tol_excess(y, y_ref, EPI_ATOL, EPI_RTOL)
        if z0 is not None:
            excess = max(excess, _tol_excess(z0, z0_ref, EPI_ATOL, EPI_RTOL))
            err = max(err, float((z0 - z0_ref).abs().max()))
        grads = name == "step" or name in TP_SPLIT_CASES
        grad_note = ""
        if grads:
            dy = torch.randn(M, N, generator=torch.Generator().manual_seed(
                SEED + 5)).to(device)
            plain, ties = _relu_tied_plain(fm, c["spec"], mask, z0, z0_ref)
            g_excess = _grad_check(
                lambda *t: fm.fused_matmul(*t, seed=c["seed"],
                                           spec=c["spec"]),
                plain, args, dy)
            excess = max(excess, g_excess)
            grad_note = f"; gradients: worst excess {g_excess:.3e}" + (
                f", the kernel's relu mask handed over ({ties} products "
                f"on the other side of 0 from the plain ones)"
                if ties is not None else "")
        z0_note = "z0 checked" if z0 is not None else "no z0 (affine)"
        log(f"  gemm_epilogue {name}: M={M} K={K} N={N} {c['spec']} "
            + (f"keep={keep:.5f} " if keep is not None else "")
            + f"max_abs_err={err:.3e} ({z0_note}; atol {EPI_ATOL:g} rtol "
            f"{EPI_RTOL:g}{grad_note})")
        if not (excess <= EPI_ATOL and bool(torch.isfinite(y).all())):
            raise AssertionError(f"gemm_epilogue disagrees with plain on "
                                 f"{name}")
        report[fm.LAUNCH]["max_abs_err"] = max(
            report[fm.LAUNCH]["max_abs_err"], err)
        report[fm.LAUNCH]["cases"][name] = dict(max_abs_err=err,
                                                keep_fraction=keep)

    for name, (M, K, F, N, opts) in FFN_CASES.items():
        opts = dict(opts)
        has_b2 = opts.pop("bias", True)
        c = _epi_case(M, K, F, len(made), **opts)       # x, w1, b1
        c2 = _epi_case(M, F, N, len(made) + 50, bias=has_b2,
                       residual=opts.get("residual", False),
                       gamma=opts.get("gamma", False),
                       beta=opts.get("beta", False))   # w2, b2, tail
        args = [c["x"], c["w"], c["bias"], c2["w"], c2["bias"],
                c2["residual"], c2["gamma"], c2["beta"]]
        args = [None if t is None else t.to(device) for t in args]
        made["ffn", name] = (args, c)
        y, mask = fc.ffn_chain_kernel(*args, seed=c["seed"], spec=c["spec"])
        y_ref = fc.reference_ffn_chain(*args, spec=c["spec"], mask=mask)
        sync(device)
        keep = _keep_ok(mask, c["spec"].dropout_rate) if mask is not None \
            else None
        if mask is not None:
            # both kernels key dropout by Philox of (column, row) under the
            # seed: the chain's tiles must leave the mask bit for bit
            _, _, want = fm.fused_matmul_kernel(
                args[0], torch.zeros(K, N, device=device), seed=c["seed"],
                spec=fm.EpilogueSpec(dropout_rate=c["spec"].dropout_rate))
            if not torch.equal(mask, want):
                raise AssertionError(f"ffn_chain's keep mask on {name} is not "
                                     f"gemm_epilogue's at the same seed")
        err = float((y - y_ref).abs().max())
        excess = _tol_excess(y, y_ref, EPI_ATOL, EPI_RTOL)
        grads = name == "step" or name in TP_SPLIT_CASES
        if grads:
            dy = torch.randn(M, N, generator=torch.Generator().manual_seed(
                SEED + 6)).to(device)
            excess = max(excess, _grad_check(
                lambda *t: fc.fused_ffn_chain(*t, seed=c["seed"],
                                              spec=c["spec"]),
                lambda *t: fc.reference_ffn_chain(*t, spec=c["spec"],
                                                  mask=mask),
                args, dy))
        log(f"  ffn_chain {name}: M={M} K={K} F={F} N={N} {c['spec']} b2="
            f"{has_b2} " + (f"keep={keep:.5f} (== gemm_epilogue's mask) "
                            if keep is not None else "")
            + f"max_abs_err={err:.3e} (atol {EPI_ATOL:g} rtol {EPI_RTOL:g}"
            f"{', gradients too' if grads else ''})")
        if not (excess <= EPI_ATOL and bool(torch.isfinite(y).all())):
            raise AssertionError(f"ffn_chain disagrees with plain on {name}")
        report[fc.LAUNCH]["max_abs_err"] = max(
            report[fc.LAUNCH]["max_abs_err"], err)
        report[fc.LAUNCH]["cases"][name] = dict(max_abs_err=err,
                                                keep_fraction=keep)

    # times at the training step's shapes (dropout 0.1)
    c = made["gemm", "step"]
    args = [c[k] for k in ("x", "w", "bias", "residual", "gamma", "beta")]
    M, K = c["x"].shape
    N = c["w"].shape[1]
    _, _, mask = fm.fused_matmul_kernel(*args, seed=c["seed"], spec=c["spec"])
    ms = time_ms(lambda: fm.fused_matmul_kernel(*args, seed=c["seed"],
                                                spec=c["spec"]), device)
    plain_ms = time_ms(lambda: fm.reference_matmul_epilogue(
        *args, spec=c["spec"], mask=mask), device)
    library_ms = time_ms(lambda: torch.addmm(c["bias"], c["x"], c["w"]),
                         device)
    bound_ms, bound_by, nbytes, flops, fma_ms = _gemm_bound(M, K, N, c, True,
                                                           True)
    report[fm.LAUNCH]["timing"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, bytes=nbytes, flops=flops, fma_bound_ms=fma_ms,
        bound_rate="3xTF32 on the tensor cores, 495 TFLOP/s TF32",
        library="torch.addmm (cuBLAS): the GEMM and bias alone",
        shape=dict(M=M, K=K, N=N, spec=str(c["spec"])))
    log(f"  gemm_epilogue timing (M={M} K={K} N={N}, bias dropout 0.1 "
        f"residual layer_norm): ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms(addmm, the GEMM alone)={library_ms:.5f} bound_ms="
        f"{bound_ms:.6f} ({bound_by}: {nbytes} bytes, {flops} flops; "
        f"3xTF32) fma_bound_ms={fma_ms:.5f}; "
        f"{flops / ms / 1e9:.2f} TFLOP/s)")

    args, c = made["ffn", "step"]
    x, w1, b1, w2, b2 = args[:5]
    M, K = x.shape
    F, N = w2.shape
    _, mask = fc.ffn_chain_kernel(*args, seed=c["seed"], spec=c["spec"])
    ms = time_ms(lambda: fc.ffn_chain_kernel(*args, seed=c["seed"],
                                             spec=c["spec"]), device, iters=50)
    plain_ms = time_ms(lambda: fc.reference_ffn_chain(
        *args, spec=c["spec"], mask=mask), device, iters=50)
    library_ms = time_ms(lambda: torch.addmm(
        b2, torch.addmm(b1, x, w1), w2), device, iters=50)
    flops = 2 * M * (K * F + F * N)
    nbytes = 4 * (M * K + K * F + F + F * N + 3 * N + 2 * M * N) + M * N
    bound_ms, bound_by, nbytes, flops = _bound(flops, nbytes)
    report[fc.LAUNCH]["timing"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, bytes=nbytes, flops=flops,
        library="two torch.addmm (cuBLAS): the GEMMs and biases alone",
        shape=dict(M=M, K=K, F=F, N=N, spec=str(c["spec"])))
    log(f"  ffn_chain timing (M={M} K={K} F={F} N={N}, gelu dropout 0.1 "
        f"residual layer_norm): ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms(two addmm, the GEMMs alone)={library_ms:.5f} bound_ms="
        f"{bound_ms:.6f} ({bound_by}: {nbytes} bytes, {flops} flops; "
        f"{flops / ms / 1e9:.2f} TFLOP/s)")
    return report


def qkv_kernel_phase(device):
    """The qkv-folded flash forward (#9) against its plain version in
    every QKV_CASES case (dropout through the kernel's own mask), and
    the gradients of fused_qkv_attention — #9, then the packed dq and
    dk/dv kernels on the re-biased qkv — against the plain composite's,
    then its time at the training step's shape."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import attention_epilogue as ae
    from paddle_tpu_torch.ops import flash_attention as fa

    worst, cases, made = 0.0, {}, {}
    for name, (B, T, nh, D, causal, with_bias, rate) in QKV_CASES.items():
        H = nh * D
        K = QKV_HIDDEN.get(name, H)
        g = torch.Generator().manual_seed(SEED + 500 + len(cases))
        x = torch.randn(B, T, K, generator=g).to(device)
        w = (torch.randn(K, 3 * H, generator=g) * K ** -0.5).to(device)
        b = (torch.randn(3 * H, generator=g) * 0.1).to(device)
        mask4 = None
        if with_bias:
            pad = torch.zeros(B, 1, 1, T)
            pad[: B // 2, ..., T - T // 4:] = -1e4
            mask4 = pad.to(device)
        kp = None if mask4 is None else mask4.reshape(B, T).contiguous()
        seed = SEED + 999 + len(cases)
        keep = fa.flash_kernel_dropout_mask(B, nh, T, T, rate, seed, device) \
            if rate > 0 else None
        qkv = torch.matmul(x, w)
        o, lse = fa.flash_kernel_forward_qkv(qkv, b, nh, kp, causal,
                                             dropout_rate=rate, seed=seed)
        o_ref, lse_ref = ae.qkv_ref_forward(qkv, b, nh, kp, causal,
                                            dropout_rate=rate,
                                            keep_mask=keep)
        do = torch.randn(B, T, H, generator=g).to(device)
        grad_excess, grad_rel = _grad_check(
            lambda x_, w_, b_: ae.fused_qkv_attention(
                x_, w_, b_, nh, mask4, causal, dropout_rate=rate, seed=seed),
            lambda x_, w_, b_: ae.plain_qkv_attention(
                x_, w_, b_, nh, mask4, causal, dropout_rate=rate,
                keep_mask=keep),
            [x, w, b], do, rel=True)
        sync(device)
        err = max(float((o - o_ref).abs().max()),
                  float((lse - lse_ref).abs().max()))
        long_rows = name in QKV_LONG_ROWS
        grad_ok = (grad_rel <= QKV_GRAD_REL_TOL if long_rows
                   else grad_excess <= EPI_ATOL)
        log(f"  flash_fwd_qkv {name}: B={B} T={T} K={K} nh={nh} D={D} causal="
            f"{causal} bias={with_bias} dropout={rate} max_abs_err={err:.3e} "
            f"(atol {FLASH_FWD_ATOL:g}); gradients through dq/dk-dv: worst "
            f"excess {grad_excess:.3e} (atol {EPI_ATOL:g} rtol {EPI_RTOL:g}"
            + (", not gated: long rows" if long_rows else "")
            + f"), worst relative norm error {grad_rel:.3e}"
            + (f" (tol {QKV_GRAD_REL_TOL:g})" if long_rows else "") + ")")
        if not (err <= FLASH_FWD_ATOL and grad_ok
                and bool(torch.isfinite(o).all())):
            raise AssertionError(f"flash_fwd_qkv disagrees with plain on "
                                 f"{name}")
        worst = max(worst, err)
        cases[name] = dict(max_abs_err=err, grad_excess=grad_excess,
                           grad_rel_err=grad_rel)
        made[name] = (qkv, b, kp, keep, x, w, mask4)

    qkv, b, kp, keep, x, w, mask4 = made["step"]
    B, T, nh, D, causal, _, rate = QKV_CASES["step"]
    seed = SEED + 999
    ms = time_ms(lambda: fa.flash_kernel_forward_qkv(
        qkv, b, nh, kp, dropout_rate=rate, seed=seed), device)
    plain_ms = time_ms(lambda: ae.qkv_ref_forward(
        qkv, b, nh, kp, dropout_rate=rate, keep_mask=keep), device)
    H = nh * D
    heads = [t.reshape(B, T, nh, D).transpose(1, 2)
             for t in (qkv + b).split(H, dim=-1)]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *heads, attn_mask=mask4, dropout_p=rate), device)
    flops = 4 * B * nh * T * T * D
    nbytes = 4 * (3 * B * T * H + 3 * H + B * T + B * T * H + B * nh * T)
    bound_ms, bound_by, nbytes, flops, fma_ms = _tc_bound(flops, nbytes)
    log(f"  flash_fwd_qkv timing (B={B} T={T} nh={nh} D={D} dropout={rate}): "
        f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms(sdpa forward over "
        f"bias-added q/k/v)={library_ms:.5f} bound_ms={bound_ms:.6f} "
        f"({bound_by}: {nbytes} bytes, {flops} flops; 3xTF32) fma_bound_ms="
        f"{fma_ms:.6f}")
    return {fa.QKV: dict(max_abs_err=worst, cases=cases, timing=dict(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, bytes=nbytes, flops=flops, fma_bound_ms=fma_ms,
        bound_rate="3xTF32 on the tensor cores, 495 TFLOP/s TF32",
        library="scaled_dot_product_attention forward over q/k/v with the "
                "bias added",
        shape=dict(B=B, T=T, nh=nh, D=D, dropout=rate)))}


def decoder_attention_phase(device):
    """#3 and #9 at phase 11's causal LM shape (DECODER_ATTN: no key
    bias, dropout 0): #3 on the strided q/k/v column slices of one
    [B, T, 3H] projection (what the decoder's unfused attention op
    passes), #9 on the pre-bias projection and its bias (what the fused
    build_lm_logits passes).  Each: its error against its plain version
    (FLASH_FWD_ATOL), its time, the plain version's, SDPA's causal
    forward (``is_causal=True``) and its bound over the visible (causal)
    pairs.  Returns {kernel: timing dict}."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import attention_epilogue as ae
    from paddle_tpu_torch.ops import flash_attention as fa

    B, T, nh, D = DECODER_ATTN
    H = nh * D
    g = torch.Generator().manual_seed(SEED + 700)
    qkv = torch.randn(B, T, 3 * H, generator=g).to(device)
    b = (torch.randn(3 * H, generator=g) * 0.1).to(device)
    q, k, v = qkv[..., :H], qkv[..., H:2 * H], qkv[..., 2 * H:]
    biased = qkv + b
    calls = {
        fa.FWD: (lambda: fa.flash_kernel_forward(q, k, v, nh, causal=True),
                 lambda: fa.flash_ref_forward(q, k, v, nh, causal=True),
                 qkv),
        fa.QKV: (lambda: fa.flash_kernel_forward_qkv(qkv, b, nh, None, True),
                 lambda: ae.qkv_ref_forward(qkv, b, nh, None, True),
                 biased),
    }
    # 4 flops per visible (query, key, dim): q.k and p.v; bytes: q, k, v
    # (or the projection and its bias) read, o and lse written
    flops = 4 * B * nh * visible_pairs(T, T, True) * D
    out = {}
    for name, (kernel, plain, src) in calls.items():
        (o, lse), (o_ref, lse_ref) = kernel(), plain()
        sync(device)
        err = max(float((o - o_ref).abs().max()),
                  float((lse - lse_ref).abs().max()))
        if not (err <= FLASH_FWD_ATOL and bool(torch.isfinite(o).all())):
            raise AssertionError(f"{name} disagrees with plain at the "
                                 f"decoder's causal shape: {err:.3e}")
        heads = [t.reshape(B, T, nh, D).transpose(1, 2)
                 for t in src.split(H, dim=-1)]
        nbytes = 4 * (3 * B * T * H + B * T * H + B * nh * T
                      + (3 * H if name == fa.QKV else 0))
        bound_ms, bound_by, nbytes, flops_, fma_ms = _tc_bound(flops, nbytes)
        t = dict(ms=time_ms(kernel, device), plain_ms=time_ms(plain, device),
                 library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                     *heads, is_causal=True), device),
                 bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                 flops=flops_, fma_bound_ms=fma_ms, max_abs_err=err,
                 library="scaled_dot_product_attention forward, "
                         "is_causal=True" + (" over the bias-added q/k/v"
                                             if name == fa.QKV else ""),
                 shape=dict(B=B, T=T, nh=nh, D=D, causal=True, bias=None,
                            dropout=0.0))
        log(f"  {name} at the decoder's causal shape (B={B} T={T} nh={nh} "
            f"D={D}): max_abs_err={err:.3e} ms={t['ms']:.5f} plain_ms="
            f"{t['plain_ms']:.5f} library_ms(sdpa causal)="
            f"{t['library_ms']:.5f} bound_ms={bound_ms:.6f} ({bound_by}: "
            f"{nbytes} bytes, {flops_} flops; 3xTF32)")
        out[name] = t
    return out


#: the phase-17 shapes timed beside phase 2's step shapes: the qkv-folded
#: forward and its backward pair at NMT-big's self-attention (QKV_CASES),
#: the packed forward and backward at its cross-attention and the beam
#: decoder's (FLASH_CASES), the fused matmul at its GEMMs (GEMM_CASES)
P17_QKV_TIMED = ("nmt", "nmt_causal")
P17_FLASH_TIMED = ("nmt_cross", "beam_cross")
P17_GEMM_TIMED = ("nmt_ffn_up", "nmt_ffn_down", "nmt_n3072", "nmt_kv",
                  "resnet_fc")


def p17_kernel_timing(device):
    """Times of #9, #3, #5/#6 and #10 at phase 17's shapes (their
    correctness is held in the case tables above): each with the plain
    version's time, a library call's (SDPA forward / backward, or
    ``addmm``: the GEMM and bias alone) and its bound.  Returns
    {kernel: {case: timing dict}}."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import attention_epilogue as ae
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_matmul as fm

    out = {fa.QKV: {}, fa.FWD: {}, fa.DQ: {}, fa.DKV: {}, fm.LAUNCH: {}}

    def record(kernel, case, t, shape, library):
        t.update(shape=shape, library=library,
                 bound_rate="3xTF32 on the tensor cores, 495 TFLOP/s TF32")
        out[kernel][case] = t
        log(f"  {kernel} at phase 17's {case} {shape}: ms={t['ms']:.5f} "
            f"plain_ms={t['plain_ms']:.5f} library_ms={t['library_ms']:.5f}"
            f" bound_ms={t['bound_ms']:.6f} ({t['bound_by']})")

    for case in P17_QKV_TIMED:
        B, T, nh, D, causal, with_bias, rate = QKV_CASES[case]
        H = nh * D
        g = torch.Generator().manual_seed(SEED + 1700)
        qkv = torch.randn(B, T, 3 * H, generator=g).to(device)
        b = (torch.randn(3 * H, generator=g) * 0.1).to(device)
        kp = None
        if with_bias:
            pad = torch.zeros(B, T)
            pad[: B // 2, T - T // 4:] = -1e4
            kp = pad.to(device)
        seed = SEED + 1717
        keep = fa.flash_kernel_dropout_mask(B, nh, T, T, rate, seed, device)
        heads = [t.reshape(B, T, nh, D).transpose(1, 2)
                 for t in (qkv + b).split(H, dim=-1)]
        mask4 = None if kp is None else kp[:, None, None, :]
        flops = 4 * B * nh * visible_pairs(T, T, causal) * D
        nbytes = 4 * (3 * B * T * H + 3 * H + B * T + B * T * H + B * nh * T)
        bound_ms, bound_by, nbytes, flops, fma_ms = _tc_bound(flops, nbytes)
        record(fa.QKV, case, dict(
            ms=time_ms(lambda: fa.flash_kernel_forward_qkv(
                qkv, b, nh, kp, causal, dropout_rate=rate, seed=seed),
                device),
            plain_ms=time_ms(lambda: ae.qkv_ref_forward(
                qkv, b, nh, kp, causal, dropout_rate=rate, keep_mask=keep),
                device, iters=50),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                *heads, attn_mask=mask4, dropout_p=rate,
                is_causal=causal and mask4 is None), device),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
            fma_bound_ms=fma_ms),
            dict(B=B, T=T, nh=nh, D=D, causal=causal, bias=with_bias,
                 dropout=rate),
            "scaled_dot_product_attention forward over the bias-added "
            "q/k/v")

    for case in P17_FLASH_TIMED:
        c, do = flash_case(device, *FLASH_CASES[case])
        nh, rate = c["num_heads"], c["dropout_rate"]
        B, Tq, H = c["q"].shape
        Tk, D = c["k"].shape[1], H // nh
        qkv = (c["q"], c["k"], c["v"])
        mask = fa.flash_kernel_dropout_mask(B, nh, Tq, Tk, rate, c["seed"],
                                            device)
        o, lse = fa.flash_kernel_forward(*qkv, nh, bias=c["bias"],
                                         dropout_rate=rate, seed=c["seed"])
        delta = fa.flash_delta(o, do, nh)
        bw = dict(dropout_rate=rate, seed=c["seed"])
        heads = [x.reshape(B, -1, nh, D).transpose(1, 2).contiguous()
                 .requires_grad_() for x in qkv]
        attn_mask = c["bias"][:, None, None, :]
        lib_out = F.scaled_dot_product_attention(
            *heads, attn_mask=attn_mask, dropout_p=rate)
        do_h = do.reshape(B, Tq, nh, D).transpose(1, 2).contiguous()
        bounds = flash_bounds(c)
        shape = dict(B=B, Tq=Tq, Tk=Tk, nh=nh, D=D, bias="key padding",
                     dropout=rate)
        plain_bwd = None
        kernels = ((fa.FWD, lambda: fa.flash_kernel_forward(
            *qkv, nh, bias=c["bias"], dropout_rate=rate, seed=c["seed"])),
            (fa.DQ, lambda: fa.flash_kernel_dq(
                *qkv, c["bias"], do, lse, delta, nh, **bw)),
            (fa.DKV, lambda: fa.flash_kernel_dkv(
                *qkv, c["bias"], do, lse, delta, nh, **bw)))
        for name, fn in kernels:
            if case == "beam_cross" and name != fa.FWD:
                continue        # the beam decoder runs forward only
            fwd = name == fa.FWD
            if fwd:
                plain = time_ms(lambda: fa.flash_ref_forward(
                    *qkv, nh, bias=c["bias"], dropout_rate=rate,
                    keep_mask=mask), device, iters=50)
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    *heads, attn_mask=attn_mask, dropout_p=rate), device)
            else:
                if plain_bwd is None:
                    plain_bwd = time_ms(lambda: fa.flash_ref_backward(
                        *qkv, c["bias"], o, lse, do, nh, dropout_rate=rate,
                        keep_mask=mask), device, iters=50)
                    lib_bwd = time_ms(lambda: torch.autograd.grad(
                        lib_out, heads, do_h, retain_graph=True), device)
                plain, lib = plain_bwd, lib_bwd
            bound_ms, bound_by, nbytes, flops, fma_ms = bounds[name]
            record(name, case, dict(
                ms=time_ms(fn, device), plain_ms=plain, library_ms=lib,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops, fma_bound_ms=fma_ms), shape,
                "scaled_dot_product_attention " + (
                    "forward" if fwd else "backward, dq+dk+dv"))

    for case in P17_GEMM_TIMED:
        M, K, N, opts = GEMM_CASES[case]
        c = _epi_case(M, K, N, 170 + P17_GEMM_TIMED.index(case), **opts)
        c = {k: (v.to(device) if torch.is_tensor(v) else v)
             for k, v in c.items()}
        args = [c[k] for k in ("x", "w", "bias", "residual", "gamma", "beta")]
        _, _, mask = fm.fused_matmul_kernel(*args, seed=c["seed"],
                                            spec=c["spec"])
        dropout = c["spec"].dropout_rate > 0
        z0 = c["spec"].norm is not None or c["spec"].act is not None
        bound_ms, bound_by, nbytes, flops, fma_ms = _gemm_bound(
            M, K, N, c, z0, dropout)
        record(fm.LAUNCH, case, dict(
            ms=time_ms(lambda: fm.fused_matmul_kernel(
                *args, seed=c["seed"], spec=c["spec"]), device, iters=50),
            plain_ms=time_ms(lambda: fm.reference_matmul_epilogue(
                *args, spec=c["spec"], mask=mask), device, iters=50),
            library_ms=time_ms(lambda: torch.addmm(c["bias"], c["x"],
                                                   c["w"]), device,
                               iters=50),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
            fma_bound_ms=fma_ms),
            dict(M=M, K=K, N=N, spec=str(c["spec"])),
            "torch.addmm (cuBLAS): the GEMM and bias alone")
    return out


#: flat-layout flash cases: (B, H, Tq, Tk, D, causal, bias: None |
#: "padding" (a [B, 1, 1, Tk] 0 / -1e4 mask of the last quarter of the
#: keys) | "kbias" (a random [B, 1, 1, Tk] key bias, as ring attention
#: rotates) | "per_head" (a random [B, H, 1, Tk]), dropout rate, a random
#: nonzero lse cotangent).  "op_step" is one step of phase 6's 4-D op,
#: "ring_p1" the causal chunk of phase 7's one-rank ring, "ring_chunk" a
#: non-causal ring chunk of a four-rank ring at the same length
FLAT_CASES = {
    "op_step": (8, 12, 512, 512, 64, False, "padding", 0.1, False),
    "ring_p1": (2, 12, 4096, 4096, 64, True, None, 0.0, False),
    "ring_chunk": (2, 12, 1024, 1024, 64, False, "kbias", 0.0, True),
    "per_head_bias": (4, 12, 256, 256, 64, False, "per_head", 0.0, False),
    "tq128_tk256": (2, 2, 128, 256, 32, False, "padding", 0.0, False),
    "causal_tq80_tk128": (4, 12, 80, 128, 64, True, "padding", 0.0, False),
    "t100": (4, 12, 100, 100, 64, False, "padding", 0.0, False),
    "t100_d32": (4, 8, 100, 100, 32, False, "padding", 0.0, False),
    "t100_d128": (4, 4, 100, 100, 128, False, "padding", 0.0, False),
}


# -- phase 2: the bfloat16 and float16 variants (AMP) -------------------------

#: AMP's element types, and the kernels that run in them (the packed flash
#: entries, the qkv-folded forward, the fused matmul and the FFN chain)
AMP_DTYPES = ("bfloat16", "float16")
AMP_KERNEL_NAMES = ("flash_fwd_packed", "flash_bwd_dq_packed",
                    "flash_bwd_dkv_packed", "flash_fwd_qkv", "gemm_epilogue",
                    "ffn_chain")
#: dense bf16/fp16 tensor-core FLOP/s (the H100 SXM datasheet): the peak
#: rate for the variants' input type; beside it the 1xTF32 rate
#: (TF32_FLOPS) that their one TF32 product a step runs at
BF16_FLOPS = 989e12
#: a bfloat16/float16 kernel against its plain version at the same
#: rounding points, summed in float32 in other orders: an output in the
#: element type may round to the neighbouring value, and a rounded input
#: of a product (p, ds) may too, so the worst element is held to a few
#: units of the type's last place at the output's scale, and (bfloat16)
#: the mean to a fraction of one: (max, mean) errors as fractions of
#: max|ref|; float32 outputs (lse, dbias) as the float32 cases' atol
AMP_TOL = {"bfloat16": (2.0 ** -6, 2.0 ** -9),
           "float16": (2.0 ** -9, None)}
AMP_F32_ATOL = 1e-4
#: dbias (float32) as a fraction of max|ref|: a fully padded row's scores
#: sit near -1e4, where float32's spacing is 2^-10, so the kernel's and
#: the plain version's p, both recomputed from scores summed in other
#: orders, part by up to ~1e-3 relative there, and ds and dbias with them
AMP_DBIAS_RTOL = 1e-3
#: BERT-large's attention and GEMMs (bench.py:3121: 16 x 512, 16 heads of
#: 64, hidden 1024, FFN 4096) and BERT-base's FFN at 64 x 128 (bench.py:
#: 3124); the edge cases: a key-padding bias with one fully padded row,
#: and T off the kernels' 32-row tiles
AMP_FLASH_CASES = {
    "large": (16, 512, 512, 16, 64, False, True, 0.1),
    "pad_row": (2, 128, 128, 4, 64, False, True, 0.0),
    "t100": (4, 100, 100, 8, 64, True, False, 0.0),
}
AMP_QKV_CASES = {
    "large": (16, 512, 16, 64, False, True, 0.1),
    "t100": (4, 100, 8, 64, False, True, 0.0),
}
AMP_GEMM_CASES = {
    "large_attn_out": (8192, 1024, 1024, dict(
        residual=True, gamma=True, beta=True, dropout_rate=0.1,
        norm="layer_norm")),
    "large_ffn_up": (8192, 1024, 4096, dict(act="gelu")),
    "large_n3072": (8192, 1024, 3072, dict()),
    "large_ffn_down": (8192, 4096, 1024, dict(
        residual=True, gamma=True, beta=True, dropout_rate=0.1,
        norm="layer_norm")),
    "base_attn_out": (8192, 768, 768, dict(
        residual=True, gamma=True, beta=True, dropout_rate=0.1,
        norm="layer_norm")),
    "ragged": (1000, 512, 1000, dict(
        act="gelu", residual=True, gamma=True, beta=True, dropout_rate=0.1,
        norm="layer_norm")),
}
AMP_FFN_CASES = {
    "base": (8192, 768, 3072, 768, dict(
        act="gelu", residual=True, gamma=True, beta=True, dropout_rate=0.1,
        norm="layer_norm")),
    "ragged": (1000, 256, 1024, 512, dict(
        act="gelu", residual=True, gamma=True, dropout_rate=0.1,
        norm="rms_norm")),
}
#: the case each kernel's variant is timed at
AMP_TIMED = {"flash_fwd_packed": "large", "flash_bwd_dq_packed": "large",
             "flash_bwd_dkv_packed": "large", "flash_fwd_qkv": "large",
             "gemm_epilogue": "large_ffn_down", "ffn_chain": "base"}


#: each AMP case's float32 inputs, made once for both element types
_AMP_DATA = {}


def _amp_data(key, make):
    if key not in _AMP_DATA:
        _AMP_DATA[key] = make()
    return _AMP_DATA[key]


def amp_name(kernel, dtype):
    """The kernels-line name (and LAUNCHES key) of a variant."""
    from paddle_tpu_torch import _cuda

    return _cuda.launch_key(kernel, dtype)


def _amp_err(got, want, dtype, what):
    """(max, mean) |got - want| over max|want|; raises past AMP_TOL."""
    import torch

    got, want = got.float(), want.float()
    scale = float(want.abs().max()) or 1.0
    diff = (got - want).abs()
    mx, mean = float(diff.max()) / scale, float(diff.mean()) / scale
    tmax, tmean = AMP_TOL[dtype]
    if not (mx <= tmax and (tmean is None or mean <= tmean)
            and bool(torch.isfinite(got).all())):
        raise AssertionError(
            f"{what} ({dtype}): max error {mx:.3e} (tolerance {tmax:.3e}) "
            f"mean {mean:.3e} (tolerance {tmean}) of max|ref| {scale:.4g}")
    return float(diff.max()), mx, mean


def _amp_bound(flops, nbytes):
    """(ms, bound_by, bytes, flops, tf32_ms): the larger of the bytes over
    HBM's rate and the flops over the bf16/fp16 tensor-core peak; beside
    it the same with the flops at the 1xTF32 rate this design runs."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops,
            max(t_bytes, flops / TF32_FLOPS * 1e3))


def _amp_flash(device, dt, name, spec, report, timed):
    """One flash case in element type ``dt``: the packed forward and the
    backward pair against flash_ref_forward / _backward (the kernels' own
    dropout mask handed to the plain versions)."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dt)
    c, do = _amp_data(("flash", spec), lambda: flash_case(device, *spec))
    B, Tq, H = c["q"].shape
    Tk, nh, rate = c["k"].shape[1], c["num_heads"], c["dropout_rate"]
    bias = c["bias"]
    if name == "pad_row":
        bias = bias.clone()
        bias[-1] = -1e4                      # one row with every key padded
    if not c["q"].is_contiguous():           # strided views of one qkv
        qkv = torch.cat([c["q"], c["k"], c["v"]], -1).to(dtype)
        q, k, v = qkv[..., :H], qkv[..., H:2 * H], qkv[..., 2 * H:]
    else:
        q, k, v = (c[n].to(dtype) for n in ("q", "k", "v"))
    do = do.to(dtype)
    mask = (fa.flash_kernel_dropout_mask(B, nh, Tq, Tk, rate, c["seed"],
                                         device) if rate else None)
    kw = dict(causal=c["causal"], dropout_rate=rate)
    o, lse = fa.flash_kernel_forward(q, k, v, nh, bias=bias, seed=c["seed"],
                                     **kw)
    o_ref, lse_ref = fa.flash_ref_forward(q, k, v, nh, bias=bias,
                                          keep_mask=mask, **kw)
    delta = fa.flash_delta(o, do, nh)
    dq = fa.flash_kernel_dq(q, k, v, bias, do, lse, delta, nh,
                            seed=c["seed"], **kw)
    dk, dv, dbias_h = fa.flash_kernel_dkv(q, k, v, bias, do, lse, delta, nh,
                                          seed=c["seed"], **kw)
    rq, rk, rv, rb = fa.flash_ref_backward(q, k, v, bias, o, lse, do, nh,
                                           keep_mask=mask, **kw)
    sync(device)
    if not (o.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
            and lse.dtype == dbias_h.dtype == torch.float32):
        raise AssertionError(f"flash {dt} {name}: output dtypes "
                             f"{o.dtype} {dq.dtype} {lse.dtype}")
    errs = {"o": _amp_err(o, o_ref, dt, f"flash {name} o"),
            "dq": _amp_err(dq, rq, dt, f"flash {name} dq"),
            "dk": _amp_err(dk, rk, dt, f"flash {name} dk"),
            "dv": _amp_err(dv, rv, dt, f"flash {name} dv")}
    dbias = dbias_h.sum(1)
    f32 = {"lse": float((lse - lse_ref).abs().max()),
           "dbias": float((dbias - rb).abs().max())}
    dbias_rel = f32["dbias"] / (float(rb.abs().max()) or 1.0)
    if f32["lse"] > AMP_F32_ATOL or dbias_rel > AMP_DBIAS_RTOL:
        raise AssertionError(f"flash {dt} {name}: float32 outputs {f32} "
                             f"(dbias {dbias_rel:.2e} of max|ref|) past "
                             f"{AMP_F32_ATOL} / {AMP_DBIAS_RTOL}")
    log(f"  flash {dt} {name}: B={B} Tq={Tq} Tk={Tk} nh={nh} D={H // nh} "
        f"causal={c['causal']} dropout={rate} max/mean error of max|ref| "
        + " ".join(f"{n}={e[1]:.2e}/{e[2]:.2e}" for n, e in errs.items())
        + " " + " ".join(f"{n}={e:.2e}" for n, e in f32.items())
        + f" (dbias {dbias_rel:.2e} of max|ref|; tol {AMP_TOL[dt]}, lse "
        f"{AMP_F32_ATOL:g}, dbias {AMP_DBIAS_RTOL:g} of max|ref|)")
    for kern, outs in ((fa.FWD, ("o",)), (fa.DQ, ("dq",)),
                       (fa.DKV, ("dk", "dv"))):
        r = report[amp_name(kern, dtype)]
        err = max([errs[n][0] for n in outs]
                  + ([f32["lse"]] if kern == fa.FWD else [])
                  + ([f32["dbias"]] if kern == fa.DKV else []))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["cases"][name] = {n: errs[n][1] for n in outs}
    if name != timed:
        return
    import torch.nn.functional as F

    D = H // nh
    args = (q, k, v)
    t = {fa.FWD: time_ms(lambda: fa.flash_kernel_forward(
            *args, nh, bias=bias, seed=c["seed"], **kw), device, iters=50),
         fa.DQ: time_ms(lambda: fa.flash_kernel_dq(
            *args, bias, do, lse, delta, nh, seed=c["seed"], **kw), device,
            iters=50),
         fa.DKV: time_ms(lambda: fa.flash_kernel_dkv(
            *args, bias, do, lse, delta, nh, seed=c["seed"], **kw), device,
            iters=50)}
    plain = {fa.FWD: time_ms(lambda: fa.flash_ref_forward(
        *args, nh, bias=bias, keep_mask=mask, **kw), device, iters=5)}
    plain[fa.DQ] = plain[fa.DKV] = time_ms(lambda: fa.flash_ref_backward(
        *args, bias, o, lse, do, nh, keep_mask=mask, **kw), device, iters=5)
    heads = [x.reshape(B, -1, nh, D).transpose(1, 2).contiguous()
             .requires_grad_() for x in args]
    am = bias.to(dtype)[:, None, None, :]
    lib = {fa.FWD: time_ms(lambda: F.scaled_dot_product_attention(
        *heads, attn_mask=am, dropout_p=rate), device, iters=50)}
    out = F.scaled_dot_product_attention(*heads, attn_mask=am,
                                         dropout_p=rate)
    do_h = do.reshape(B, Tq, nh, D).transpose(1, 2).contiguous()
    lib[fa.DQ] = lib[fa.DKV] = time_ms(lambda: torch.autograd.grad(
        out, heads, do_h, retain_graph=True), device, iters=50)
    unit = B * nh * Tq * Tk * D
    qb, kvb, rows = 2 * B * Tq * H, 2 * B * Tk * H, 4 * B * nh * Tq
    work = {fa.FWD: (4 * unit, 2 * qb + 2 * kvb + 4 * B * Tk + rows),
            fa.DQ: (6 * unit, 3 * qb + 2 * kvb + 4 * B * Tk + 2 * rows),
            fa.DKV: (8 * unit, 2 * qb + 4 * kvb + 4 * B * Tk + 2 * rows
                     + 4 * B * nh * Tk)}
    for kern in (fa.FWD, fa.DQ, fa.DKV):
        bms, by, nb, fl, tf32 = _amp_bound(*work[kern])
        report[amp_name(kern, dtype)]["timing"] = dict(
            ms=t[kern], plain_ms=plain[kern], library_ms=lib[kern],
            bound_ms=bms, bound_by=by, bytes=nb, flops=fl, tf32_bound_ms=tf32,
            bound_rate="bf16/fp16 tensor cores 989 TFLOP/s (tf32_bound_ms: "
            "the 1xTF32 rate, 495 TFLOP/s, that the design runs at)",
            library="SDPA " + ("forward" if kern == fa.FWD else
                               "backward (dq, dk, dv together)")
            + f" in {dt}, the bias as attn_mask",
            shape=dict(B=B, T=Tq, nh=nh, D=D, dropout=rate))
        log(f"  {amp_name(kern, dtype)} timing ({name}): ms={t[kern]:.5f} "
            f"plain_ms={plain[kern]:.5f} library_ms={lib[kern]:.5f} "
            f"bound_ms={bms:.6f} ({by}; 1xTF32 {tf32:.6f})")


def _amp_qkv(device, dt, name, spec, report, timed):
    """One qkv-folded forward case in ``dt``: o and lse against
    qkv_ref_forward on the same pre-bias qkv (the dropout mask the
    kernels draw)."""
    import torch

    from paddle_tpu_torch.ops import attention_epilogue as ae
    from paddle_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dt)
    B, T, nh, D, causal, has_bias, rate = spec
    H = nh * D
    g = torch.Generator().manual_seed(SEED + 2200 + len(name))
    qkv = torch.randn(B, T, 3 * H, generator=g).to(device, dtype)
    b_qkv = (0.1 * torch.randn(3 * H, generator=g)).to(device)
    bias = padding_bias(B, T).reshape(B, T).to(device) if has_bias else None
    seed = SEED + 2300
    mask = (fa.flash_kernel_dropout_mask(B, nh, T, T, rate, seed, device)
            if rate else None)
    o, lse = fa.flash_kernel_forward_qkv(qkv, b_qkv, nh, bias, causal,
                                         dropout_rate=rate, seed=seed)
    o_ref, lse_ref = ae.qkv_ref_forward(qkv, b_qkv, nh, bias, causal,
                                        dropout_rate=rate, keep_mask=mask)
    sync(device)
    err = _amp_err(o, o_ref, dt, f"flash_fwd_qkv {name} o")
    lse_err = float((lse - lse_ref).abs().max())
    if o.dtype != dtype or lse_err > AMP_F32_ATOL:
        raise AssertionError(f"flash_fwd_qkv {dt} {name}: {o.dtype}, lse "
                             f"error {lse_err}")
    log(f"  flash_fwd_qkv {dt} {name}: B={B} T={T} nh={nh} D={D} causal="
        f"{causal} bias={has_bias} dropout={rate} o max/mean error of "
        f"max|ref| {err[1]:.2e}/{err[2]:.2e} lse {lse_err:.2e}")
    r = report[amp_name(fa.QKV, dtype)]
    r["max_abs_err"] = max(r["max_abs_err"], err[0], lse_err)
    r["cases"][name] = dict(o=err[1], lse=lse_err)
    if name != timed:
        return
    import torch.nn.functional as F

    ms = time_ms(lambda: fa.flash_kernel_forward_qkv(
        qkv, b_qkv, nh, bias, causal, dropout_rate=rate, seed=seed), device,
        iters=50)
    plain_ms = time_ms(lambda: ae.qkv_ref_forward(
        qkv, b_qkv, nh, bias, causal, dropout_rate=rate, keep_mask=mask),
        device, iters=5)
    q, k, v = ((qkv[..., i * H:(i + 1) * H] + b_qkv[i * H:(i + 1) * H]
                .to(dtype)).reshape(B, T, nh, D).transpose(1, 2)
               for i in range(3))
    am = None if bias is None else bias.to(dtype)[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=am, dropout_p=rate, is_causal=causal), device,
        iters=50)
    unit = B * nh * T * T * D
    bms, by, nb, fl, tf32 = _amp_bound(
        4 * unit, 2 * 3 * B * T * H + 4 * 3 * H + 4 * B * T
        + 2 * B * T * H + 4 * B * nh * T)
    r["timing"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
        bound_by=by, bytes=nb, flops=fl, tf32_bound_ms=tf32,
        bound_rate="bf16/fp16 tensor cores 989 TFLOP/s (tf32_bound_ms: the "
        "1xTF32 rate)",
        library=f"SDPA forward in {dt} on the biased heads (the bias add "
        "and the head split not timed)",
        shape=dict(B=B, T=T, nh=nh, D=D, dropout=rate))
    log(f"  {amp_name(fa.QKV, dtype)} timing ({name}): ms={ms:.5f} plain_ms="
        f"{plain_ms:.5f} library_ms={lib_ms:.5f} bound_ms={bms:.6f} ({by}; "
        f"1xTF32 {tf32:.6f})")


def _amp_gemm(device, dt, name, M, K, N, opts, report, timed, made):
    """One fused matmul-epilogue case in ``dt``: y and z0 against
    reference_matmul_epilogue (the kernel's keep mask handed over); x, w
    and the residual in ``dt``, bias, gamma and beta float32."""
    import torch

    from paddle_tpu_torch.ops import fused_matmul as fm

    dtype = getattr(torch, dt)
    c = dict(_amp_data(("gemm", name), lambda: {
        k: (v.to(device) if torch.is_tensor(v) else v)
        for k, v in _epi_case(M, K, N, 60 + len(made), **opts).items()}))
    for k in ("x", "w", "residual"):
        if c[k] is not None:
            c[k] = c[k].to(dtype)
    made[name] = c
    args = [c[k] for k in ("x", "w", "bias", "residual", "gamma", "beta")]
    y, z0, mask = fm.fused_matmul_kernel(*args, seed=c["seed"],
                                         spec=c["spec"])
    y_ref, z0_ref = fm.reference_matmul_epilogue(*args, spec=c["spec"],
                                                 mask=mask)
    sync(device)
    if mask is not None:
        _keep_ok(mask, c["spec"].dropout_rate)
    errs = [_amp_err(y, y_ref, dt, f"gemm_epilogue {name} y")]
    if z0 is not None:
        errs.append(_amp_err(z0, z0_ref, dt, f"gemm_epilogue {name} z0"))
    if y.dtype != dtype:
        raise AssertionError(f"gemm_epilogue {dt} {name}: y is {y.dtype}")
    log(f"  gemm_epilogue {dt} {name}: M={M} K={K} N={N} {c['spec']} "
        f"max/mean error of max|ref| "
        + " ".join(f"{n}={e[1]:.2e}/{e[2]:.2e}"
                   for n, e in zip(("y", "z0"), errs)))
    r = report[amp_name(fm.LAUNCH, dtype)]
    r["max_abs_err"] = max([r["max_abs_err"]] + [e[0] for e in errs])
    r["cases"][name] = errs[0][1]
    if name != timed:
        return
    ms = time_ms(lambda: fm.fused_matmul_kernel(*args, seed=c["seed"],
                                                spec=c["spec"]), device,
                 iters=50)
    plain_ms = time_ms(lambda: fm.reference_matmul_epilogue(
        *args, spec=c["spec"], mask=mask), device, iters=10)
    bias_t = c["bias"].to(dtype)
    lib_ms = time_ms(lambda: torch.addmm(bias_t, c["x"], c["w"]), device,
                     iters=50)
    z0b = 2 * M * N if z0 is not None else 0
    nbytes = (2 * (M * K + K * N + M * N) + z0b
              + (M * N if mask is not None else 0)
              + (2 * M * N if c["residual"] is not None else 0) + 4 * 3 * N
              + (4 * M * N if c["spec"].norm and N > 768 else 0))
    bms, by, nb, fl, tf32 = _amp_bound(2 * M * K * N, nbytes)
    r["timing"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
        bound_by=by, bytes=nb, flops=fl, tf32_bound_ms=tf32,
        bound_rate="bf16/fp16 tensor cores 989 TFLOP/s (tf32_bound_ms: the "
        "1xTF32 rate)",
        library=f"torch.addmm in {dt} (cuBLAS): the GEMM and bias alone",
        shape=dict(M=M, K=K, N=N, spec=str(c["spec"])))
    log(f"  {amp_name(fm.LAUNCH, dtype)} timing ({name}): ms={ms:.5f} "
        f"plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} bound_ms="
        f"{bms:.6f} ({by}; 1xTF32 {tf32:.6f}; {fl / ms / 1e9:.1f} TFLOP/s)")


def _amp_ffn(device, dt, name, M, K, F, N, opts, report, timed):
    """One FFN-chain case in ``dt`` against reference_ffn_chain (the
    kernel's keep mask handed over)."""
    import torch

    from paddle_tpu_torch.ops import ffn_chain as fc

    dtype = getattr(torch, dt)
    opts = dict(opts)
    c = _epi_case(M, K, F, 80, **opts)

    def make():
        c2 = _epi_case(M, F, N, 81, residual=opts.get("residual", False),
                       gamma=opts.get("gamma", False),
                       beta=opts.get("beta", False))
        return [None if t is None else t.to(device) for t in (
            c["x"], c["w"], c["bias"], c2["w"], c2["bias"], c2["residual"],
            c2["gamma"], c2["beta"])]

    args = list(_amp_data(("ffn", name), make))
    for i in (0, 1, 3, 5):
        if args[i] is not None:
            args[i] = args[i].to(dtype)
    y, mask = fc.ffn_chain_kernel(*args, seed=c["seed"], spec=c["spec"])
    y_ref = fc.reference_ffn_chain(*args, spec=c["spec"], mask=mask)
    sync(device)
    if mask is not None:
        _keep_ok(mask, c["spec"].dropout_rate)
    err = _amp_err(y, y_ref, dt, f"ffn_chain {name} y")
    if y.dtype != dtype:
        raise AssertionError(f"ffn_chain {dt} {name}: y is {y.dtype}")
    log(f"  ffn_chain {dt} {name}: M={M} K={K} F={F} N={N} {c['spec']} "
        f"y max/mean error of max|ref| {err[1]:.2e}/{err[2]:.2e}")
    r = report[amp_name(fc.LAUNCH, dtype)]
    r["max_abs_err"] = max(r["max_abs_err"], err[0])
    r["cases"][name] = err[1]
    if name != timed:
        return
    x, w1, b1, w2, b2 = args[:5]
    ms = time_ms(lambda: fc.ffn_chain_kernel(*args, seed=c["seed"],
                                             spec=c["spec"]), device,
                 iters=20)
    plain_ms = time_ms(lambda: fc.reference_ffn_chain(
        *args, spec=c["spec"], mask=mask), device, iters=5)
    b1t, b2t = b1.to(dtype), b2.to(dtype)
    lib_ms = time_ms(lambda: torch.addmm(b2t, torch.addmm(b1t, x, w1), w2),
                     device, iters=20)
    nbytes = (2 * (M * K + K * F + F * N + 2 * M * N) + 4 * (F + 3 * N)
              + M * N)
    bms, by, nb, fl, tf32 = _amp_bound(2 * M * (K * F + F * N), nbytes)
    r["timing"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
        bound_by=by, bytes=nb, flops=fl,
        fma_bound_ms=max(nb / HBM_BYTES_PER_S, fl / FP32_FLOPS) * 1e3,
        tf32_bound_ms=tf32,
        bound_rate="bf16/fp16 tensor cores 989 TFLOP/s (fma_bound_ms: the "
        "float32 FMA rate, 67 TFLOP/s, that this kernel runs at)",
        library=f"two torch.addmm in {dt} (cuBLAS): the GEMMs and biases "
        "alone",
        shape=dict(M=M, K=K, F=F, N=N, spec=str(c["spec"])))
    log(f"  {amp_name(fc.LAUNCH, dtype)} timing ({name}): ms={ms:.5f} "
        f"plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} bound_ms="
        f"{bms:.6f} ({by}; {fl / ms / 1e9:.1f} TFLOP/s)")


def amp_kernel_phase(device):
    """The bfloat16 and float16 variants of the six kernels AMP runs,
    each against its plain version in its own element type at
    BERT-large's attention and GEMM shapes, BERT-base's FFN and the edge
    cases, then timed at the main path's shape beside the plain version,
    the library call in the same dtype and the bound.  -> {variant name:
    {"max_abs_err", "cases", "timing"}}."""
    report = {amp_name(k, dt): dict(max_abs_err=0.0, cases={})
              for k in AMP_KERNEL_NAMES for dt in AMP_DTYPES}
    for dt in AMP_DTYPES:
        for name, spec in AMP_FLASH_CASES.items():
            _amp_flash(device, dt, name, spec, report,
                       AMP_TIMED["flash_fwd_packed"])
        for name, spec in AMP_QKV_CASES.items():
            _amp_qkv(device, dt, name, spec, report,
                     AMP_TIMED["flash_fwd_qkv"])
        made = {}
        for name, (M, K, N, opts) in AMP_GEMM_CASES.items():
            _amp_gemm(device, dt, name, M, K, N, opts, report,
                      AMP_TIMED["gemm_epilogue"], made)
        for name, (M, K, F, N, opts) in AMP_FFN_CASES.items():
            _amp_ffn(device, dt, name, M, K, F, N, opts, report,
                     AMP_TIMED["ffn_chain"])
    _AMP_DATA.clear()
    return report


def padding_bias(B, Tk):
    """The 0 / -1e4 key-padding bias [B, 1, 1, Tk] that masks the last
    quarter of every row's keys, as an input mask makes it."""
    import torch

    bias = torch.zeros(B, 1, 1, Tk)
    bias[..., Tk - Tk // 4:] = -1e4
    return bias


def flat_case(device, B, H, Tq, Tk, D, causal, bias, rate, dlse, seed):
    """One flat flash call's inputs on the card: unit-scale q, k, v, an
    output cotangent, the bias as the kernels' [B, H, 1, Tk] view (or
    None), an lse cotangent when ``dlse``."""
    import torch

    g = torch.Generator().manual_seed(SEED + 600 + seed)
    q = torch.randn(B, H, Tq, D, generator=g)
    k, v = (torch.randn(B, H, Tk, D, generator=g) for _ in range(2))
    do = torch.randn(B, H, Tq, D, generator=g)
    b = {None: None, "padding": padding_bias(B, Tk),
         "kbias": torch.randn(B, 1, 1, Tk, generator=g),
         "per_head": torch.randn(B, H, 1, Tk, generator=g)}[bias]
    u = torch.randn(B, H, Tq, generator=g) if dlse else None
    move = (lambda t: None if t is None else t.to(device))
    return dict(q=move(q), k=move(k), v=move(v), do=move(do), dlse=move(u),
                bias=None if b is None else move(b).expand(B, H, 1, Tk),
                bias_src=move(b), causal=causal, dropout_rate=rate,
                seed=SEED + 2345 + seed)


def visible_pairs(Tq, Tk, causal):
    """(query, key) pairs a row sees: all of them, or under the
    end-aligned causal mask those with key <= query + Tk - Tq."""
    if not causal:
        return Tq * Tk
    return sum(min(Tk, max(0, i + Tk - Tq + 1)) for i in range(Tq))


def flat_bounds(c):
    """Least time of each flat kernel's work at this call: 4 (forward), 6
    (dq) and 8 (dk/dv) flops per visible (query, key, dim); each input
    read once and each output written once over HBM's rate.  All three
    run their products as 3xTF32 on the tensor cores (``_tc_bound``), and
    each float32 FMA bound stays beside, as earlier runs reported it.
    Returns {kernel: (ms, bound_by, bytes, flops, fma_ms)}."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, H, Tq, D = c["q"].shape
    Tk = c["k"].shape[2]
    unit = B * H * visible_pairs(Tq, Tk, c["causal"]) * D
    q_b, kv_b, rows = 4 * B * H * Tq * D, 4 * B * H * Tk * D, 4 * B * H * Tq
    bias_b = 0 if c["bias_src"] is None else 4 * c["bias_src"].numel()
    ins = q_b + 2 * kv_b + bias_b
    return {name: _tc_bound(flops, nbytes) for name, flops, nbytes in (
        (fa.FWD_FLAT, 4 * unit, ins + q_b + rows),
        (fa.DQ_FLAT, 6 * unit, ins + q_b + 2 * rows + q_b),
        (fa.DKV_FLAT, 8 * unit,
         ins + q_b + 2 * rows + 2 * kv_b + 4 * B * H * Tk))}


def flat_kernel_phase(device):
    """The flat flash kernels (#4, #7, #8) against flash_ref_forward_flat
    / _backward_flat in every FLAT_CASES case (dropout through the
    kernels' own mask, a nonzero lse cotangent folded into delta where
    the case has one), each case timed beside its plain versions, a
    library call and its bounds.  The kernels line takes the op step's
    times (phase 6's main path) and the worst error over the cases."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.attention import _NEG_INF

    names = (fa.FWD_FLAT, fa.DQ_FLAT, fa.DKV_FLAT)
    errs = dict.fromkeys(names, 0.0)
    cases = {}
    for i, (name, spec) in enumerate(FLAT_CASES.items()):
        c = flat_case(device, *spec, seed=i)
        q, k, v, bias, do, dlse = (c[n] for n in ("q", "k", "v", "bias", "do",
                                                  "dlse"))
        B, H, Tq, D = q.shape
        Tk, rate, causal, seed = k.shape[2], c["dropout_rate"], c["causal"], \
            c["seed"]
        kw = dict(causal=causal, dropout_rate=rate)
        mask = keep = None
        if rate > 0:
            mask = fa.flash_kernel_dropout_mask(B, H, Tq, Tk, rate, seed,
                                                device)
            keep = _keep_ok(mask, rate)
        o, lse = fa.flash_kernel_forward_flat(q, k, v, bias, seed=seed, **kw)
        o_ref, lse_ref = fa.flash_ref_forward_flat(q, k, v, bias,
                                                   keep_mask=mask, **kw)
        delta = fa.flash_delta_flat(o, do, dlse)
        dq = fa.flash_kernel_dq_flat(q, k, v, bias, do, lse, delta, seed=seed,
                                     **kw)
        dk, dv, dbias = fa.flash_kernel_dkv_flat(q, k, v, bias, do, lse, delta,
                                                 seed=seed, **kw)
        refs = fa.flash_ref_backward_flat(q, k, v, bias, o_ref, lse_ref, do,
                                          keep_mask=mask, dlse=dlse, **kw)
        sync(device)
        got = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv, dbias=dbias)
        want = dict(o=o_ref, lse=lse_ref)
        want.update(zip(("dq", "dk", "dv", "dbias"), refs))
        err = {n: float((got[n] - want[n]).abs().max()) for n in got}
        excess = {n: _tol_excess(got[n], want[n], FLASH_GRAD_ATOL,
                                 FLASH_GRAD_RTOL)
                  for n in ("dq", "dk", "dv", "dbias")}
        fwd_ok = max(err["o"], err["lse"]) <= FLASH_FWD_ATOL
        grad_ok = max(excess.values()) <= FLASH_GRAD_ATOL
        finite = all(bool(torch.isfinite(t).all()) for t in got.values())
        del refs, o_ref, lse_ref, got, want

        # times: the kernels, their plain versions, and PyTorch's fused
        # attention on the same q, k, v and bias (forward; its autograd
        # backward, dq + dk + dv, for the two backward kernels)
        iters = 200 if Tq * Tk <= 512 * 512 else 20
        times = {
            fa.FWD_FLAT: time_ms(lambda: fa.flash_kernel_forward_flat(
                q, k, v, bias, seed=seed, **kw), device, iters),
            fa.DQ_FLAT: time_ms(lambda: fa.flash_kernel_dq_flat(
                q, k, v, bias, do, lse, delta, seed=seed, **kw), device,
                iters),
            fa.DKV_FLAT: time_ms(lambda: fa.flash_kernel_dkv_flat(
                q, k, v, bias, do, lse, delta, seed=seed, **kw), device,
                iters)}
        plain_fwd = time_ms(lambda: fa.flash_ref_forward_flat(
            q, k, v, bias, keep_mask=mask, **kw), device, iters)
        plain_bwd = time_ms(lambda: fa.flash_ref_backward_flat(
            q, k, v, bias, o, lse, do, keep_mask=mask, dlse=dlse, **kw),
            device, iters)
        attn_mask = c["bias_src"]
        if causal:
            vis = torch.ones(Tq, Tk, dtype=torch.bool, device=device).tril(
                Tk - Tq)
            cmask = torch.zeros(Tq, Tk, device=device).masked_fill(~vis,
                                                                   _NEG_INF)
            attn_mask = cmask if attn_mask is None else attn_mask + cmask
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=attn_mask, dropout_p=rate), device, iters)
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask,
                                                 dropout_p=rate)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True), device, iters)
        del lib_out, leaves
        bounds = flat_bounds(c)
        case = dict(err=err, grad_excess=excess, keep_fraction=keep,
                    shape=dict(B=B, H=H, Tq=Tq, Tk=Tk, D=D, causal=causal,
                               bias=spec[6], dropout=rate, dlse=spec[8]),
                    timing={})
        for n in names:
            fwd = n == fa.FWD_FLAT
            b_ms, b_by, nbytes, flops, fma_ms = bounds[n]
            case["timing"][n] = dict(
                ms=times[n], plain_ms=plain_fwd if fwd else plain_bwd,
                library_ms=lib_fwd if fwd else lib_bwd, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes, flops=flops, fma_bound_ms=fma_ms,
                bound_rate="3xTF32 on the tensor cores, 495 TFLOP/s TF32")
        cases[name] = case
        log(f"  flat flash {name}: B={B} H={H} Tq={Tq} Tk={Tk} D={D} causal="
            f"{causal} bias={spec[6]} dropout={rate} dlse={spec[8]}"
            + (f" keep={keep:.5f}" if keep is not None else "")
            + " max_abs_err " + " ".join(f"{n}={e:.3e}" for n, e in err.items())
            + f" (fwd atol {FLASH_FWD_ATOL:g}; grads atol {FLASH_GRAD_ATOL:g}"
            f" rtol {FLASH_GRAD_RTOL:g})")
        log("    " + "; ".join(
            f"{n} ms={t['ms']:.5f} bound={t['bound_ms']:.5f} ({t['bound_by']})"
            f" x{t['ms'] / t['bound_ms']:.2f} fma_bound={t['fma_bound_ms']:.5f}"
            for n, t in case["timing"].items())
            + f"; plain fwd {plain_fwd:.5f} bwd {plain_bwd:.5f}; sdpa fwd "
            f"{lib_fwd:.5f} bwd {lib_bwd:.5f}")
        if not (fwd_ok and grad_ok and finite):
            raise AssertionError(f"flat flash kernels disagree with plain on "
                                 f"{name}")
        errs[fa.FWD_FLAT] = max(errs[fa.FWD_FLAT], err["o"], err["lse"])
        errs[fa.DQ_FLAT] = max(errs[fa.DQ_FLAT], err["dq"])
        errs[fa.DKV_FLAT] = max(errs[fa.DKV_FLAT], err["dk"], err["dv"],
                                err["dbias"])
        del c, q, k, v, bias, do, dlse, o, lse, delta, dq, dk, dv, dbias, mask

    return {n: dict(max_abs_err=errs[n], cases=cases,
                    timing=dict(cases["op_step"]["timing"][n],
                                library="scaled_dot_product_attention on "
                                        "[B, H, T, D] with the bias as "
                                        "attn_mask" + ("" if n == fa.FWD_FLAT
                                                       else ", its autograd "
                                                       "backward (dq+dk+dv)"),
                                shape=cases["op_step"]["shape"]))
            for n in names}

# -- phase 3: the engine ----------------------------------------------------

def make_prompts(rng, n, length, vocab):
    return [rng.randint(1, vocab, (length,)).tolist() for _ in range(n)]


def drive(engine, prompts, sampling, device):
    from paddle_tpu_torch import _cuda

    _cuda.reset_launches()
    t0 = time.perf_counter()
    results = engine.generate(prompts, sampling=sampling)
    sync(device)
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    return results, launches, wall


def matched_prefix(a_results, b_results):
    fracs = []
    for a, b in zip(a_results, b_results):
        n = 0
        for x, y in zip(a.tokens, b.tokens):
            if x != y:
                break
            n += 1
        fracs.append(n / max(len(a.tokens), 1))
    return float(np.mean(fracs))


def recompute_gaps(params, model_cfg, prompts, results, device):
    """Teacher-forced comparison with lm_forward (the plain full
    recompute): for every generated position, how far the greedy token's
    logit falls below that position's max logit.  Returns
    (worst gap, fraction of positions within GREEDY_LOGIT_TOL).
    Sequences of equal length are recomputed as one batch."""
    import torch

    from paddle_tpu_torch.models import lm_forward

    seqs = [p + r.tokens[:-1] for p, r in zip(prompts, results)]
    logits = [None] * len(seqs)
    with torch.no_grad():
        for n in sorted({len(q) for q in seqs}):
            idx = [i for i, q in enumerate(seqs) if len(q) == n]
            out = lm_forward(params, model_cfg, torch.tensor(
                [seqs[i] for i in idx], device=device))
            for j, i in enumerate(idx):
                logits[i] = out[j]
    gaps = []
    for b, (p, r) in enumerate(zip(prompts, results)):
        pos = torch.arange(len(p) - 1, len(p) - 1 + len(r.tokens),
                           device=device)
        row = logits[b][pos]
        chosen = row.gather(1, torch.tensor(r.tokens, device=device)[:, None])
        gaps.append((row.max(dim=1).values - chosen[:, 0]).cpu().numpy())
    gaps = np.concatenate(gaps)
    return float(gaps.max()), float(np.mean(gaps <= GREEDY_LOGIT_TOL))


def engine_phase(device, model_cfg, gen_cfg, n_prompts, prompt_len,
                 max_new, params_np):
    from paddle_tpu_torch.generation import GenerationEngine, SamplingParams
    from paddle_tpu_torch.models import lm_params_from_numpy

    params = lm_params_from_numpy(params_np, device)
    prompts = make_prompts(np.random.RandomState(SEED + 1), n_prompts,
                           prompt_len, model_cfg.vocab_size)
    greedy = SamplingParams(max_new_tokens=max_new)
    engine = GenerationEngine(model_cfg, params, gen_cfg, device=device)
    t0 = time.perf_counter()
    engine.warmup()
    sync(device)
    warm_s = time.perf_counter() - t0
    results, launches, wall = drive(engine, prompts, greedy, device)
    snap = engine.stats.snapshot()
    steps = snap["steps"]
    n_launch = launches.get("ragged_paged_attention", 0)
    log(f"  engine greedy: {n_prompts}x{prompt_len} prompts, {max_new} "
        f"new tokens each, {steps} steps in {wall:.3f} s (warmup "
        f"{warm_s:.3f} s); prefill {snap['prefill_tokens_per_sec']} tok/s,"
        f" decode {snap['decode_tokens_per_sec']} tok/s; kernel launches "
        f"{n_launch} (= {model_cfg.num_layers} x {steps}? "
        f"{n_launch == model_cfg.num_layers * steps}); "
        f"compiles_after_warmup={snap['compiles_after_warmup']}")
    if any(r is None or len(r.tokens) != max_new
           or r.finish_reason != "length" for r in results):
        raise AssertionError("a greedy request did not finish its tokens")
    if not all(0 <= t < model_cfg.vocab_size
               for r in results for t in r.tokens):
        raise AssertionError("token id out of the vocabulary")
    if device.type == "cuda" and n_launch != model_cfg.num_layers * steps:
        raise AssertionError(
            f"kernel launched {n_launch} times, expected "
            f"{model_cfg.num_layers} x {steps} steps")
    if snap["compiles_after_warmup"] != 0:
        raise AssertionError("a kernel was built or loaded after warmup")

    # At full depth this high-gain random init is numerically chaotic:
    # float32 rounding flips near-tied hard attention maxima, so token
    # agreement with another computation order is reported, not gated
    # (reference_phase gates it at a depth where it is stable).
    plain = GenerationEngine(
        model_cfg, params, dataclasses.replace(
            gen_cfg, reference_attention=True), device=device)
    plain_results, _, plain_wall = drive(plain, prompts, greedy, device)
    greedy_match = matched_prefix(results, plain_results)
    gap, agree = recompute_gaps(params, model_cfg, prompts, results, device)
    p_gap, p_agree = recompute_gaps(params, model_cfg, prompts,
                                    plain_results, device)
    log(f"  greedy, plain attention engine: {plain_wall:.3f} s; matched-"
        f"prefix fraction vs kernel engine {greedy_match:.4f}; positions "
        f"whose token is the plain full recompute's argmax (within "
        f"{GREEDY_LOGIT_TOL:g}): kernel engine {agree:.4f}, plain-"
        f"attention engine {p_agree:.4f}")

    sampled = SamplingParams(max_new_tokens=max_new, temperature=0.8,
                             top_k=40, top_p=0.95)
    s_results, s_launches, s_wall = drive(engine, prompts, sampled, device)
    p_results, _, _ = drive(plain, prompts, sampled, device)
    if any(r is None or len(r.tokens) != max_new for r in s_results):
        raise AssertionError("a sampled request did not finish its tokens")
    sample_match = matched_prefix(s_results, p_results)
    log(f"  seeded sampling (T=0.8, top_k=40, top_p=0.95): {s_wall:.3f} s,"
        f" kernel launches {s_launches.get('ragged_paged_attention', 0)};"
        f" matched-prefix fraction vs plain attention {sample_match:.4f}")
    if sample_match == 1.0 and all(
            a.tokens == b.tokens for a, b in zip(s_results, results)):
        raise AssertionError("seeded sampling reproduced greedy decoding")
    report = dict(
        steps=steps, launches=n_launch, wall_s=wall, warmup_s=warm_s,
        snapshot=snap, greedy_matched_prefix_vs_plain=greedy_match,
        recompute_agreement=dict(kernel=agree, plain=p_agree,
                                 kernel_worst_gap=gap, plain_worst_gap=p_gap),
        plain_wall_s=plain_wall, sampled_wall_s=s_wall,
        sampled_matched_prefix_vs_plain=sample_match)
    return engine, params, report


def reference_phase(device, model_cfg, gen_cfg, params, layers, n_prompts,
                    prompt_len, max_new):
    """The same weights cut to ``layers`` layers, where the computation
    is not chaotic: every greedy token of the kernel engine and of the
    plain-attention engine must be the plain full recompute's argmax
    (within GREEDY_LOGIT_TOL) at every position."""
    from paddle_tpu_torch.generation import GenerationEngine, SamplingParams

    cut, cut_params = cut_model(model_cfg, params, layers)
    prompts = make_prompts(np.random.RandomState(SEED + 3), n_prompts,
                           prompt_len, cut.vocab_size)
    greedy = SamplingParams(max_new_tokens=max_new)
    out = {}
    for name, ref in (("kernel", False), ("plain", True)):
        eng = GenerationEngine(cut, cut_params, dataclasses.replace(
            gen_cfg, reference_attention=ref), device=device)
        results, _, _ = drive(eng, prompts, greedy, device)
        gap, agree = recompute_gaps(cut_params, cut, prompts, results,
                                    device)
        out[name] = dict(results=results, worst_gap=gap, agree=agree)
    match = matched_prefix(out["kernel"]["results"], out["plain"]["results"])
    log(f"  depth {layers}: worst logit gap to the plain recompute's "
        f"argmax: kernel engine {out['kernel']['worst_gap']:.3e}, plain-"
        f"attention engine {out['plain']['worst_gap']:.3e} (tol "
        f"{GREEDY_LOGIT_TOL:g}); matched-prefix kernel vs plain {match:.4f}")
    for name in out:
        if not out[name]["worst_gap"] <= GREEDY_LOGIT_TOL:
            raise AssertionError(
                f"{name} engine: a greedy token is not the recompute argmax")
    report = dict(layers=layers, matched_prefix=match,
                  **{f"{n}_worst_gap": v["worst_gap"] for n, v in out.items()})
    report["features"] = feature_gates(device, cut, gen_cfg, cut_params)
    return report


def cut_model(model_cfg, params, layers):
    """The same weights cut to ``layers`` layers."""
    from paddle_tpu_torch.models import lm_param_names

    cut = dataclasses.replace(model_cfg, num_layers=layers)
    return cut, {n: params[n] for n in lm_param_names(cut)}


def legacy_prompts(vocab):
    rng = np.random.RandomState(SEED + 5)
    return [rng.randint(1, vocab, (n,)).tolist() for n in LEGACY_LENGTHS]


def prefix_prompts(vocab):
    """A 64-token system prompt alone (the request that publishes it),
    then 8 prompts that share it, with tails of 1..8 tokens."""
    rng = np.random.RandomState(SEED + 6)
    system = rng.randint(1, vocab, (PREFIX_LEN,)).tolist()
    tails = [rng.randint(1, vocab, (n,)).tolist()
             for n in (1, 5, 2, 8, 3, 7, 4, 6)]
    return [system], [system + t for t in tails]


def spec_prompts(vocab):
    """8 prompts that repeat short patterns, so suffix n-grams recur."""
    rng = np.random.RandomState(SEED + 7)
    return [np.tile(rng.randint(1, vocab, (n,)), reps).tolist()
            for n, reps in ((3, 8), (4, 6), (5, 5), (2, 12), (6, 4),
                            (8, 3), (4, 8), (7, 4))]


def run_feature(device, model_cfg, gen_cfg, params, feature, prompts,
                max_new):
    """One engine with ``feature`` on: warmup, then ``prompts`` (a list
    of prompt lists, generated one call after another) with greedy
    sampling.  Returns (engine, results of the last call, launches of
    all calls, wall seconds).  A draft model is the first DRAFT_LAYERS
    layers of the same weights."""
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.generation import GenerationEngine, SamplingParams

    kw = dict(FEATURES[feature])
    draft = None
    if kw.get("speculation") == "draft":
        draft = cut_model(model_cfg, params, DRAFT_LAYERS)
    eng = GenerationEngine(model_cfg, params,
                           dataclasses.replace(gen_cfg, **kw),
                           device=device, draft_model=draft)
    eng.warmup()
    sync(device)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for batch in prompts:
        results = eng.generate(batch, SamplingParams(max_new_tokens=max_new))
    sync(device)
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    return eng, results, launches, wall


#: engine configurations of the phase-3 paths beyond chunked scheduling
FEATURES = {
    "chunked": {},
    "legacy_paged": dict(scheduling="legacy"),
    "legacy_dense": dict(scheduling="legacy", use_paged=False),
    "prefix_cache": dict(prefix_cache=True),
    "ngram": dict(speculation="ngram", spec_k=4),
    "draft": dict(speculation="draft", spec_k=4),
}


def feature_gates(device, cut, gen_cfg, cut_params):
    """At the reference depth: every feature engine's greedy tokens must
    equal the chunked engine's on the same prompts (the same engine with
    the feature off) and reach the plain recompute's argmax within
    GREEDY_LOGIT_TOL."""
    workloads = {
        "legacy_paged": ([legacy_prompts(cut.vocab_size)], MAX_NEW),
        "legacy_dense": ([legacy_prompts(cut.vocab_size)], MAX_NEW),
        "prefix_cache": (list(prefix_prompts(cut.vocab_size)), 32),
        "ngram": ([spec_prompts(cut.vocab_size)], MAX_NEW),
        "draft": ([spec_prompts(cut.vocab_size)], MAX_NEW),
    }
    out = {}
    base_cache = {}
    for feature, (prompts, max_new) in workloads.items():
        key = (str(prompts), max_new)
        if key not in base_cache:
            base_cache[key] = run_feature(device, cut, gen_cfg, cut_params,
                                          "chunked", prompts, max_new)[1]
        base = base_cache[key]
        eng, results, _, _ = run_feature(
            device, cut, gen_cfg, cut_params, feature, prompts, max_new)
        same = all(a.tokens == b.tokens for a, b in zip(results, base))
        gap, agree = recompute_gaps(cut_params, cut, prompts[-1], results,
                                    device)
        snap = eng.stats.snapshot()
        log(f"  depth {cut.num_layers} {feature}: tokens equal to the "
            f"chunked engine's: {same}; worst logit gap to the recompute's "
            f"argmax {gap:.3e} (tol {GREEDY_LOGIT_TOL:g})"
            + (f"; accept ratio {snap['spec_accept_ratio']}"
               if feature in ("ngram", "draft") else "")
            + (f"; prefix hits {snap['prefix_hits']}"
               if feature == "prefix_cache" else ""))
        if not same:
            raise AssertionError(
                f"depth {cut.num_layers} {feature}: tokens differ from the "
                f"chunked engine's")
        if not gap <= GREEDY_LOGIT_TOL:
            raise AssertionError(
                f"depth {cut.num_layers} {feature}: a greedy token is not "
                f"the recompute argmax")
        out[feature] = dict(equal_to_chunked=same, worst_gap=gap,
                            recompute_agreement=agree,
                            spec_accept_ratio=snap["spec_accept_ratio"],
                            prefix_hits=snap["prefix_hits"])
    return out


def check_finished(results, max_new, vocab, what):
    if any(r is None or len(r.tokens) != max_new
           or r.finish_reason != "length" for r in results):
        raise AssertionError(f"{what}: a greedy request did not finish")
    if not all(0 <= t < vocab for r in results for t in r.tokens):
        raise AssertionError(f"{what}: token id out of the vocabulary")


def feature_phase(device, model_cfg, gen_cfg, params):
    """Phase 3b-d at full depth: legacy scheduling (paged and dense), the
    prefix cache and speculation (ngram and draft).  Each path's launch
    counts are set to 0 just before it runs and read just after.
    Returns (report, {feature: engine})."""
    L, V = model_cfg.num_layers, model_cfg.vocab_size
    # launches expected of a kernel path: one per layer per step on the
    # card, none on the CPU (a rehearsal there runs the plain versions)
    per_step = L if device.type == "cuda" else 0
    report, engines, results = {}, {}, {}

    def run(feature, prompts, max_new, name=None):
        name = name or feature
        eng, res, launches, wall = run_feature(
            device, model_cfg, gen_cfg, params, feature, prompts, max_new)
        snap = eng.stats.snapshot()
        check_finished(res, max_new, V, name)
        if snap["compiles_after_warmup"] != 0:
            raise AssertionError(f"{name}: compiled after warmup")
        engines[name], results[name] = eng, res
        n_steps = (snap["decode_steps"] if feature.startswith("legacy")
                   else snap["steps"])
        report[name] = dict(
            steps=n_steps, prefill_batches=snap["prefill_batches"],
            launches=launches, wall_s=wall,
            prefill_tokens=snap["prefill_tokens"],
            prefill_tokens_per_sec=snap["prefill_tokens_per_sec"],
            decode_tokens_per_sec=snap["decode_tokens_per_sec"],
            inter_token=snap["inter_token"])
        return eng, res, launches, snap, n_steps

    # b. legacy scheduling: the paged decode kernel, once per layer per
    # decode step; the ragged kernel never
    for feature in ("legacy_paged", "legacy_dense"):
        _, _, launches, snap, steps = run(feature, [legacy_prompts(V)],
                                          MAX_NEW)
        n_dec = launches.get("paged_decode_attention", 0)
        n_rag = launches.get("ragged_paged_attention", 0)
        want = per_step * steps if feature == "legacy_paged" else 0
        log(f"  {feature}: prompts {LEGACY_LENGTHS} x {MAX_NEW} greedy, "
            f"{snap['prefill_batches']} prefills + {steps} decode steps in "
            f"{report[feature]['wall_s']:.3f} s; prefill "
            f"{snap['prefill_tokens_per_sec']} tok/s, decode "
            f"{snap['decode_tokens_per_sec']} tok/s; paged decode launches "
            f"{n_dec} (= {want}? {n_dec == want}), ragged launches {n_rag}; "
            f"compiles_after_warmup={snap['compiles_after_warmup']}")
        if n_dec != want or n_rag != 0:
            raise AssertionError(
                f"{feature}: paged decode launched {n_dec} times (expected "
                f"{want}), ragged {n_rag} times (expected 0)")
    run("chunked", [legacy_prompts(V)], MAX_NEW, "chunked_legacy_prompts")
    report["legacy_matched_prefix"] = dict(
        paged_vs_dense=matched_prefix(results["legacy_paged"],
                                      results["legacy_dense"]),
        paged_vs_chunked=matched_prefix(results["legacy_paged"],
                                        results["chunked_legacy_prompts"]))
    log(f"  legacy matched-prefix fractions (reported, not gated): "
        f"{report['legacy_matched_prefix']}")

    # c. the prefix cache: a system prompt published, then 8 prompts
    # sharing it
    eng, _, launches, snap, steps = run("prefix_cache",
                                        list(prefix_prompts(V)), 32)
    eng.cache.check_invariants()
    n_rag = launches.get("ragged_paged_attention", 0)
    run("chunked", list(prefix_prompts(V)), 32, "chunked_prefix_prompts")
    off = report["chunked_prefix_prompts"]
    report["prefix_cache"].update(
        hits=snap["prefix_hits"], lookups=snap["prefix_lookups"],
        pages_reused=snap["prefix_pages_reused"],
        cow_copies=snap["prefix_cow_copies"],
        retained_pages=eng.cache.retained_pages(),
        matched_prefix_vs_cache_off=matched_prefix(
            results["prefix_cache"], results["chunked_prefix_prompts"]))
    log(f"  prefix_cache: {snap['prefix_hits']}/{snap['prefix_lookups']} "
        f"admissions hit, {snap['prefix_pages_reused']} pages reused, "
        f"prefill tokens {snap['prefill_tokens']} (cache off "
        f"{off['prefill_tokens']}), invariants hold; ragged "
        f"launches {n_rag} (= {per_step} x {steps}? "
        f"{n_rag == per_step * steps}); matched prefix vs cache off "
        f"{report['prefix_cache']['matched_prefix_vs_cache_off']:.4f}")
    if not (snap["prefix_hits"] > 0 and snap["prefix_pages_reused"] > 0):
        raise AssertionError("prefix cache: no hits")
    if n_rag != per_step * steps:
        raise AssertionError("prefix cache: ragged launches != L x steps")

    # d. speculation: ngram drafting and a 2-layer draft model
    run("chunked", [spec_prompts(V)], MAX_NEW, "chunked_spec_prompts")
    base_steps = report["chunked_spec_prompts"]["steps"]
    for feature in ("ngram", "draft"):
        eng, _, launches, snap, steps = run(feature, [spec_prompts(V)],
                                            MAX_NEW)
        n_rag = launches.get("ragged_paged_attention", 0)
        report[feature].update(
            drafted=snap["spec_drafted"], accepted=snap["spec_accepted"],
            accept_ratio=snap["spec_accept_ratio"],
            steps_without_speculation=base_steps,
            matched_prefix_vs_off=matched_prefix(
                results[feature], results["chunked_spec_prompts"]))
        eng.cache.check_invariants()
        log(f"  {feature}: accepted {snap['spec_accepted']} of "
            f"{snap['spec_drafted']} drafted (ratio "
            f"{snap['spec_accept_ratio']}); {steps} steps (without "
            f"speculation {base_steps}) in {report[feature]['wall_s']:.3f} "
            f"s; ragged launches {n_rag} (= {per_step} x {steps}? "
            f"{n_rag == per_step * steps}); matched prefix vs speculation off "
            f"{report[feature]['matched_prefix_vs_off']:.4f}")
        if n_rag != per_step * steps:
            raise AssertionError(f"{feature}: ragged launches != L x steps")
    return report, engines


def _span_summary(prof, wall_us, steps, kernel_names):
    """Device kernel time by name, busy share of the wall (kernel
    intervals merged) and the named kernels' time, from a profile;
    None when the profiler recorded no device activity."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    by_name, busy, cur_end = {}, 0.0, None
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if cur_end is None or start > cur_end:
            busy += end - start
            cur_end = end
        elif end > cur_end:
            busy += end - cur_end
            cur_end = end
    kernel_us = sum(by_name.values())
    named_us = sum(us for name, us in by_name.items()
                   if any(k in name for k in kernel_names))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    counts = collections.Counter(name[:60] for _, _, name in spans)
    return dict(most_launched=[(name, n / steps) for name, n in
                               counts.most_common(8)],
                device_busy_share=busy / wall_us,
                device_ms_per_step=kernel_us / 1e3 / steps,
                kernels_per_step=len(spans) / steps,
                named_kernels_ms_per_step=named_us / 1e3 / steps,
                top_kernels_ms=[(name[:80], us / 1e3 / steps)
                                for name, us in top])


def profile_phase(engine, model_cfg, device, max_new=32, steps_key="steps",
                  kernel="ragged_attention"):
    """Where a generate call's time goes: torch.profiler over one greedy
    generate (8 prompts), device kernel time by name, and the device's
    busy share of the profiled wall time (kernel intervals merged).  The
    profiler's own host overhead lengthens the wall, so the busy share
    is a lower bound.  Per-step numbers divide by the snapshot's
    ``steps_key`` (unified steps, or legacy decode steps); ``kernel``
    names the attention kernel whose time is reported apart.  Device
    times are absent when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.generation import SamplingParams

    prompts = make_prompts(np.random.RandomState(SEED + 4), N_PROMPTS,
                           PROMPT_LEN, model_cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=max_new)
    engine.generate(prompts, sp)
    sync(device)
    steps0 = engine.stats.snapshot()[steps_key]
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        engine.generate(prompts, sp)
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = engine.stats.snapshot()[steps_key] - steps0
    out = dict(steps=steps, wall_ms_per_step=wall_us / 1e3 / steps)
    summary = _span_summary(prof, wall_us, steps, (kernel,))
    if summary is not None:
        out.update(summary, attention_kernel=kernel)
        log(f"  profiled generate (8 x {max_new} greedy): {steps} "
            f"{steps_key}, {out['wall_ms_per_step']:.3f} ms/step wall under "
            f"the profiler, device kernels {out['device_ms_per_step']:.3f} "
            f"ms/step ({out['kernels_per_step']:.1f} kernels/step), busy "
            f"share {out['device_busy_share']:.4f}, {kernel} "
            f"{out['named_kernels_ms_per_step']:.4f} ms/step")
        for name, ms in out["top_kernels_ms"]:
            log(f"    {ms:9.4f} ms/step  {name}")
    else:
        log(f"  profiled generate: {steps} steps, "
            f"{out['wall_ms_per_step']:.3f} ms/step wall; device time not "
            f"measured (the profiler recorded no device activity)")
    return out


# -- phase 4: the server ----------------------------------------------------

def server_phase(engine, model_cfg):
    from paddle_tpu_torch.generation import GenerationBackend, SamplingParams
    from paddle_tpu_torch.serving import InferenceServer, ServingConfig

    rng = np.random.RandomState(SEED + 2)
    prompts = [rng.randint(1, model_cfg.vocab_size, (n,)).tolist()
               for n in (9, 16, 23, 32)]
    backend = GenerationBackend(engine, max_new_tokens=16)
    server = InferenceServer(backend, ServingConfig(
        batch_buckets=(1, 2, 4), seq_buckets=(16, 32),
        pad_values={"prompt_lens": 1}, max_batch_wait_ms=20)).start()
    answers, errors = [None] * len(prompts), []
    try:
        server.warmup()

        def client(i):
            p = np.asarray(prompts[i], np.int32)
            try:
                out, n = server.infer(
                    {"token_ids": p[None], "prompt_lens": np.asarray(
                        [p.size], np.int32)}, timeout_ms=120_000)
                answers[i] = out[0, :int(n[0])].tolist()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"server clients failed: {errors}")
        stats = server.stats()
    finally:
        server.close()
    direct = engine.generate(prompts, SamplingParams(max_new_tokens=16))
    same = [a == d.tokens for a, d in zip(answers, direct)]
    log(f"  server: {len(prompts)} concurrent clients, {stats['batches']} "
        f"batches, answers equal to engine.generate: {same}; "
        f"compiles_after_warmup={stats['compiles_after_warmup']}")
    if not all(same):
        raise AssertionError("served answers differ from engine.generate")
    if stats["compiles_after_warmup"] != 0:
        raise AssertionError("the server compiled after warmup")
    return dict(batches=stats["batches"], answers_equal=same,
                latency=stats["latency"])


# -- phase 5: training ------------------------------------------------------

def build_train(cfg, max_masked=None, wrap=None, seq_len=None):
    """build_bert_pretrain(cfg, seq_len or TRAIN_SEQ, max_masked=...) +
    Adam(TRAIN_LR).minimize in fresh programs -> (main, startup, loss,
    grad names, param names).  ``wrap(adam, boundaries)`` returns the
    optimizer to minimize with (phase 13's wrappers, phase 18's AMP;
    ``boundaries`` are the embedding's and every layer's outputs)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import build_bert_pretrain

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED + 11
    main.random_seed = SEED + 12
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _, bounds = build_bert_pretrain(
            cfg, seq_len=seq_len or TRAIN_SEQ, max_masked=max_masked,
            want_boundaries=True)
        opt = pt.optimizer.Adam(TRAIN_LR)
        if wrap is not None:
            opt = wrap(opt, bounds)
        _, params_grads = opt.minimize(loss)
    return (main, startup, loss, [g.name for _, g in params_grads],
            [p.name for p, _ in params_grads])


def train_batch(vocab, device):
    """One pretraining batch from a numpy seed, on the card: token ids,
    an input mask that pads the tail of a quarter of the rows, and labels
    at ~15% of the real positions (-1 elsewhere)."""
    import torch

    rng = np.random.RandomState(SEED + 8)
    B, T = TRAIN_BATCH, TRAIN_SEQ
    src = rng.randint(0, vocab, (B, T)).astype(np.int64)
    mask = np.ones((B, T), np.float32)
    for b in range(B // 4):
        mask[b, rng.randint(T // 2, T):] = 0.0
    labels = np.full((B, T, 1), -1, np.int64)
    pick = (rng.rand(B, T) < 0.15) & (mask > 0)
    labels[pick] = src[pick][:, None]
    return {n: torch.from_numpy(a).to(device) for n, a in
            (("src_ids", src), ("input_mask", mask), ("masked_labels",
                                                      labels))}


class _PlainCalls:
    """Counts calls of the port's plain kernel versions while active: the
    flash plain versions (packed and flat; the ring attention module
    reads the flat ones from the flash module) and the composite
    attention, the qkv-folded forward's, the fused matmul epilogue's and
    the FFN chain's, under every module-level name the ops look them up
    by.  (The fused matmul
    and FFN-chain backward passes are plain PyTorch by design, as the
    JAX package's custom VJPs are XLA; they call none of these.)"""

    NAMES = {
        "ops.flash_attention": ("flash_ref_forward", "flash_ref_backward",
                                "flash_ref_forward_flat",
                                "flash_ref_backward_flat", "attention",
                                "attention_packed"),
        "ops.attention_epilogue": ("qkv_ref_forward", "plain_qkv_attention",
                                   "flash_ref_forward", "flash_ref_backward"),
        "ops.fused_matmul": ("reference_matmul_epilogue",),
        "ops.ffn_chain": ("reference_ffn_chain",),
    }

    def __init__(self, names=None):
        import importlib

        self.names = names or self.NAMES
        self.calls, self.saved = 0, []
        self.modules = {m: importlib.import_module(f"paddle_tpu_torch.{m}")
                        for m in self.names}

    def __enter__(self):
        for m, names in self.names.items():
            module = self.modules[m]
            for n in names:
                fn = getattr(module, n)
                self.saved.append((module, n, fn))

                def counted(*a, _fn=fn, **kw):
                    self.calls += 1
                    return _fn(*a, **kw)

                setattr(module, n, counted)
        return self

    def __exit__(self, *exc):
        for module, n, fn in reversed(self.saved):
            setattr(module, n, fn)
        self.saved.clear()
        return False


#: the kernels of the fused training step (the fusion pass's default
#: program): each launched once per layer per step
FUSED_STEP_KERNELS = ("flash_fwd_qkv", "gemm_epilogue", "ffn_chain",
                      "flash_bwd_dq_packed", "flash_bwd_dkv_packed")


def _plan_kinds(main):
    """Group kinds of every fusion plan the Executor lowered for
    ``main`` (one per feed/fetch signature)."""
    kinds = []
    for lowered in main._exec_cache.values():
        plan = lowered.fusion_plan
        kinds.append(None if plan is None else collections.Counter(
            g.kind for g in plan.groups))
    return kinds


def launch_cost_us(device, n=2000):
    """Host microseconds per small eager PyTorch op (an in-place add on a
    one-element tensor, ``n`` times, then a sync): the dispatch cost an
    eager, host-bound step pays per kernel.  Read at the start of the run
    and around the profiled steps: a profiler session may leave its
    tracing on and slow every later launch."""
    import torch

    t = torch.zeros(1, device=device)
    for _ in range(50):
        t.add_(1.0)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        t.add_(1.0)
    sync(device)
    return (time.perf_counter() - t0) / n * 1e6


def _profile_step(exe, program, feed, loss, scope, device, what,
                  names=("flash_", "gemm_epilogue", "ffn_chain"),
                  label="the port's kernels"):
    """One Executor training step under torch.profiler
    (_profile_call)."""
    return _profile_call(
        lambda: exe.run(program, feed=feed, fetch_list=[loss], scope=scope),
        device, what, names, label)


def _profile_call(step, device, what,
                  names=("flash_", "gemm_epilogue", "ffn_chain"),
                  label="the port's kernels"):
    """One call of ``step`` (a training step) under torch.profiler: its
    wall time and the device summary of _span_summary, whose named
    kernels (``label``) are those whose names hold one of ``names``,
    with their share of the device time."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step()
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    out = _span_summary(prof, wall_us, 1, names)
    if out is None:
        log(f"  profiled {what} step: {wall_us / 1e3:.3f} ms wall; device "
            f"time not measured (the profiler recorded no device activity)")
        return dict(wall_ms=wall_us / 1e3)
    out["named_share"] = out["named_kernels_ms_per_step"] / max(
        out["device_ms_per_step"], 1e-12)
    log(f"  profiled {what} step: {wall_us / 1e3:.3f} ms wall under the "
        f"profiler, device kernels {out['device_ms_per_step']:.3f} ms "
        f"({out['kernels_per_step']:.0f} kernels), busy share "
        f"{out['device_busy_share']:.4f}, {label} "
        f"{out['named_kernels_ms_per_step']:.3f} ms "
        f"({out['named_share']:.3f})")
    for name, ms in out["top_kernels_ms"]:
        log(f"    {ms:9.3f} ms  {name}")
    log("    most launched: " + "; ".join(
        f"{n} x {name}" for name, n in out["most_launched"]))
    return dict(wall_ms=wall_us / 1e3, **out)


def _series_total(metric, **labels):
    """Sum of a registry counter's series whose labels include
    ``labels``."""
    from paddle_tpu_torch.observability import get_registry

    return sum(s.value() for lb, s in get_registry().counter(metric).series()
               if all(dict(lb).get(k) == v for k, v in labels.items()))


def _train_series():
    """The registry totals phase 5 reads; fusion block hits by pattern."""
    out = {m: _series_total(m) for m in ("executor_compiles_total",
                                         "fused_epilogue_hits_total")}
    for pattern in ("attention_epilogue", "ffn_chain"):
        out[f"fused_block_hits_total:{pattern}"] = _series_total(
            "fused_block_hits_total", pattern=pattern)
    return out


def registry_gates(cfg, reg0, kinds):
    """After the fused program's first lowering and its steps: one
    fused_epilogue_hits_total per planned group (37 at BERT-base: 12
    attention, 13 fused-matmul, 12 FFN-chain), a
    fused_block_hits_total{pattern} per attention and FFN-chain group,
    and one executor lowering each for the startup and the main
    program."""
    got = {k: v - reg0[k] for k, v in _train_series().items()}
    L = cfg.num_layers
    want = {"fused_epilogue_hits_total": float(sum(kinds.values())),
            "fused_block_hits_total:attention_epilogue": float(L),
            "fused_block_hits_total:ffn_chain": float(L),
            "executor_compiles_total": 2.0}
    log(f"  registry after the fused steps: " + ", ".join(
        f"{k} +{got[k]:g} (want {v:g})" for k, v in want.items()))
    bad = {k: got[k] for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"registry series {bad}, expected {want}")
    return got


def monitor_gate(losses, step_walls):
    """A TrainingMonitor fed the timed steps (after they ran: the monitor
    costs the timed loop nothing): its JSONL must hold one record per
    step whose step_ms is that step's wall time."""
    from paddle_tpu_torch.observability import TrainingMonitor

    path = TRACE_DIR / "train_monitor.jsonl"
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    if path.exists():
        path.unlink()
    mon = TrainingMonitor(jsonl_path=str(path), run="chip_smoke")
    for step, (loss, wall_s) in enumerate(zip(losses, step_walls)):
        mon.on_step(step, loss=loss, wall_s=wall_s, examples=TRAIN_BATCH)
    mon.close()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    want = [round(w * 1e3, 3) for w in step_walls]
    got = [r["step_ms"] for r in recs]
    log(f"  TrainingMonitor: {len(recs)} records, step_ms {got}")
    if len(recs) != len(step_walls) or got != want:
        raise AssertionError(f"monitor records {got}, expected {want}")
    if [r["step"] for r in recs] != list(range(len(step_walls))):
        raise AssertionError("monitor records out of step order")
    return dict(records=len(recs), step_ms=got,
                summary=mon.summary())


def optimizer_state_gate(scope, params):
    """After the first lowering of a CompiledProgram: the
    optimizer_state_bytes gauge holds Adam's state — two float32 moments
    per parameter element and two one-element beta powers per
    parameter — globally and per device (equal without a mesh)."""
    from paddle_tpu_torch.observability import get_registry

    n = sum(scope.find_var(p).numel() for p in params)
    want = float(2 * 4 * n + 2 * 4 * len(params))
    gauge = get_registry().gauge("optimizer_state_bytes")
    got = {pl: gauge.value(placement=pl) for pl in ("global", "per_device")}
    log(f"  optimizer_state_bytes {got} (want {want:.0f}: 2 x {n} x 4 "
        f"moments + 2 x {len(params)} x 4 beta powers)")
    if got != {"global": want, "per_device": want}:
        raise AssertionError(f"optimizer_state_bytes {got}, expected "
                             f"{want}")
    return dict(optimizer_state_bytes=got)


def training_phase(device, cfg):
    """``cfg`` pretraining through the default (fused) program for
    TRAIN_WARMUP + TRAIN_STEPS steps with the plan, launch, plain-call
    and no-load gates, one profiled step, then the three-way parity
    gate.  On the CPU (a rehearsal) the plain versions run and the
    launch gates expect none.  Also holds the registry series of the
    fused steps, the optimizer-state gauge and a TrainingMonitor's
    records."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.ops import flash_attention as fa

    on_card = device.type == "cuda"
    before_us = launch_cost_us(device)
    main, startup, loss, _, params = build_train(cfg)
    exe = pt.Executor(pt.CUDAPlace(0) if on_card else pt.CPUPlace())
    scope = pt.Scope()
    reg0 = _train_series()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    sync(device)
    startup_s = time.perf_counter() - t0
    n_params = sum(scope.find_var(p).numel() for p in params)
    feed = train_batch(cfg.vocab_size, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    warm = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
            for _ in range(TRAIN_WARMUP)]
    sync(device)
    warm_s = time.perf_counter() - t0

    with _PlainCalls() as plain:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        losses, stamps = [], [t0]
        for _ in range(TRAIN_STEPS):
            losses.append(exe.run(main, feed=feed, fetch_list=[loss],
                                  scope=scope, return_numpy=False)[0])
            stamps.append(time.perf_counter())
        sync(device)
        stamps[-1] = time.perf_counter()
        wall = stamps[-1] - t0
        launches = dict(_cuda.LAUNCHES)
    step_walls = [b - a for a, b in zip(stamps, stamps[1:])]
    timed_losses = [float(x) for x in losses]
    losses = [float(x) for x in warm] + timed_losses
    step_ms = wall / TRAIN_STEPS * 1e3
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / wall
    L = cfg.num_layers
    want = L * TRAIN_STEPS if on_card else 0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    got = {k: launches.get(k, 0) for k in FUSED_STEP_KERNELS + (fa.FWD,)}
    kinds = _plan_kinds(main)
    want_kinds = collections.Counter(attn=L, gemm=L + 1, ffn_chain=L)
    log(f"  BERT ({n_params} parameters) pretraining, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, Adam({TRAIN_LR:g}), dropout "
        f"{cfg.hidden_dropout}, the fusion pass's default program "
        f"(groups {dict(kinds[0])}): startup {startup_s:.2f} s, "
        f"{TRAIN_WARMUP} warm-up steps {warm_s:.2f} s; {TRAIN_STEPS} steps: "
        f"{step_ms:.3f} ms/step, {tokens_per_s:.1f} tokens/s; losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; launches {got} (= {L} x {TRAIN_STEPS} = {want} each, "
        f"{fa.FWD} 0?); plain kernel versions called {plain.calls}; "
        f"libraries loaded after the first step "
        f"{exe.compiles_after_first_step}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a training loss is not finite: {losses}")
    if kinds != [want_kinds]:
        raise AssertionError(f"fusion plan groups {kinds}, expected "
                             f"{dict(want_kinds)}")
    if any(got[k] != want for k in FUSED_STEP_KERNELS) or got[fa.FWD]:
        raise AssertionError(f"kernel launches {got}, expected {want} each "
                             f"and no {fa.FWD}")
    if on_card and plain.calls:
        raise AssertionError("a plain kernel version ran on the card")
    if exe.compiles_after_first_step:
        raise AssertionError("a kernel library was loaded after the first "
                             "step")
    registry = registry_gates(cfg, reg0, kinds[0])
    registry["monitor"] = monitor_gate(timed_losses, step_walls)

    # the unfused lowering of the same program, continuing from the same
    # scope: where the fusion pass moves the step.  Timed in turns with
    # the fused program (fused, unfused, unfused, fused: COMPARE_STEPS
    # each), and before either is profiled (see launch_cost_us)
    bs = pt.BuildStrategy()
    bs.fuse_epilogues = False
    unfused = pt.CompiledProgram(main, build_strategy=bs)
    exe.run(unfused, feed=feed, fetch_list=[loss], scope=scope)
    sync(device)
    registry.update(optimizer_state_gate(scope, params))
    turns = {"fused": [], "unfused": []}
    for name in ("fused", "unfused", "unfused", "fused"):
        program = main if name == "fused" else unfused
        t0 = time.perf_counter()
        for _ in range(COMPARE_STEPS):
            exe.run(program, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
        sync(device)
        turns[name].append((time.perf_counter() - t0) / COMPARE_STEPS * 1e3)
    log(f"  fused and unfused lowering in turns, {COMPARE_STEPS} steps each: "
        f"fused {turns['fused'][0]:.3f}, unfused {turns['unfused'][0]:.3f}, "
        f"unfused {turns['unfused'][1]:.3f}, fused {turns['fused'][1]:.3f} "
        f"ms/step")

    prof_out = _profile_step(exe, main, feed, loss, scope, device, "fused")
    after_prof = dict(launch_cost_us=launch_cost_us(device))
    t0 = time.perf_counter()
    for _ in range(COMPARE_STEPS):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                return_numpy=False)
    sync(device)
    after_prof["fused_step_ms"] = (time.perf_counter() - t0) \
        / COMPARE_STEPS * 1e3
    log(f"  after the profiled step: {after_prof['launch_cost_us']:.2f} us "
        f"per small eager op (before it {before_us:.2f}), fused "
        f"{after_prof['fused_step_ms']:.3f} ms/step")
    unfused_prof = _profile_step(exe, unfused, feed, loss, scope, device,
                                 "unfused lowering")
    report = dict(
        config=dataclasses.asdict(cfg), parameters=n_params, batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, steps=TRAIN_STEPS, losses=losses,
        step_ms=step_ms, tokens_per_s=tokens_per_s, launches=got,
        plan_groups=dict(kinds[0]), startup_s=startup_s, warmup_s=warm_s,
        peak_memory_bytes=peak, profile=prof_out, turns_ms=turns,
        launch_cost_us=before_us, after_profile=after_prof,
        unfused_lowering=dict(profile=unfused_prof), registry=registry)
    del scope
    report["parity"] = parity_gate(device, exe, cfg)
    # one executor_compiles_total per lowering phase 5 made: a program's
    # cache holds one per feed/fetch signature and build strategy
    lowerings = _series_total("executor_compiles_total") \
        - reg0["executor_compiles_total"]
    made = (len(startup._exec_cache) + len(main._exec_cache)
            + report["parity"]["lowerings"])
    log(f"  executor_compiles_total +{lowerings:g}, lowerings made {made}")
    if lowerings != made:
        raise AssertionError(f"executor_compiles_total rose by {lowerings}, "
                             f"phase 5 made {made} lowerings")
    registry["executor_compiles_total"] = lowerings
    return report


#: the parity gate's programs: (cfg.fused_attention, fuse_epilogues) and
#: the kernels each launches once per layer per step on the card
PARITY_RUNS = {
    "blocks": (True, True, FUSED_STEP_KERNELS),
    "unfused_lowering": (True, False, ("flash_fwd_packed",
                                       "flash_bwd_dq_packed",
                                       "flash_bwd_dkv_packed")),
    "plain": (False, False, ()),
}


def parity_gate(device, exe, cfg, max_masked=None):
    """At dropout 0 from the same weights, PARITY_STEPS Adam steps of
    three programs: the fusion pass's default (the qkv-folded flash,
    fused matmul and FFN-chain kernels), the unfused lowering
    (``fuse_epilogues=False``: the packed flash kernels) and the plain
    matmul/softmax program (``fused_attention=False``, unfused: none of
    the port's kernels).  Each is held to the plain one, and each
    launches its own kernels once per layer per step and no other.
    With ``max_masked``, the masked-position head's programs (phase
    13a)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda

    cfg = dataclasses.replace(cfg, hidden_dropout=0.0, attn_dropout=0.0)
    on_card = device.type == "cuda"
    runs, launches = {}, {}
    weights, lowerings = None, 0
    for name, (fused_attn, fuse, kernels) in PARITY_RUNS.items():
        main, startup, loss, grads, _ = build_train(
            dataclasses.replace(cfg, fused_attention=fused_attn),
            max_masked=max_masked)
        bs = pt.BuildStrategy()
        bs.fuse_epilogues = fuse
        program = pt.CompiledProgram(main, build_strategy=bs)
        scope = pt.Scope()
        if weights is None:
            exe.run(startup, scope=scope)
            weights = {n: scope.find_var(n).clone()
                       for n in pt.io.persistable_names(main)}
        else:
            if set(weights) != set(pt.io.persistable_names(main)):
                raise AssertionError(f"the {name} program differs from the "
                                     f"first in its persistables")
            for n, t in weights.items():
                scope.set_var(n, t.clone())
        feed = (train_batch(cfg.vocab_size, device) if max_masked is None
                else masked_batch(cfg.vocab_size, device)[0])
        losses, first = [], None
        _cuda.reset_launches()
        for step in range(PARITY_STEPS):
            out = exe.run(program, feed=feed, scope=scope, return_numpy=False,
                          fetch_list=[loss] + (grads if step == 0 else []))
            losses.append(float(out[0]))
            if step == 0:
                first = dict(zip(grads, out[1:]))
        sync(device)
        launches[name] = {k: n for k, n in _cuda.LAUNCHES.items() if n}
        want = {k: cfg.num_layers * PARITY_STEPS for k in kernels} \
            if on_card else {}
        if launches[name] != want:
            raise AssertionError(f"the {name} program launched "
                                 f"{launches[name]}, expected {want}")
        runs[name] = (losses, first)
        lowerings += len(main._exec_cache) + len(startup._exec_cache)
        del scope
    lp, gp = runs["plain"]
    out = dict(plain_losses=lp, launches=launches, lowerings=lowerings)
    for name in ("blocks", "unfused_lowering"):
        lf, gf = runs[name]
        dloss = [abs(a - b) for a, b in zip(lf, lp)]
        rel = {n: float(torch.linalg.vector_norm(gf[n] - gp[n])
                        / torch.linalg.vector_norm(gp[n]).clamp_min(1e-30))
               for n in gp}
        worst = max(rel, key=rel.get)
        log(f"  parity at dropout 0, same weights, {PARITY_STEPS} Adam "
            f"steps, {name} against plain: losses "
            + " ".join(f"{x:.6f}" for x in lf) + "; plain "
            + " ".join(f"{x:.6f}" for x in lp) + f"; max |dloss| "
            f"{max(dloss):.3e} (tol {PARITY_LOSS_TOL:g}); first-step "
            f"gradient relative norm error max {rel[worst]:.3e} ({worst}; "
            f"tol {PARITY_GRAD_RTOL:g}); launches {launches[name]}")
        if not max(dloss) < PARITY_LOSS_TOL:
            raise AssertionError(f"{name} and plain losses diverge")
        if not rel[worst] < PARITY_GRAD_RTOL:
            raise AssertionError(f"{name} and plain gradients disagree")
        out[name] = dict(losses=lf, max_dloss=max(dloss),
                         max_grad_rel_err=rel[worst], worst_grad=worst)
    return out


# -- phase 6: the 4-D fused_attention op ---------------------------------------

#: phase 6: [B, H, T, D] at BERT-base attention width (12 heads of 64,
#: max_position 512), Adam's rate, warm-up / timed / parity steps
OP4D_SHAPE, OP4D_LR, OP4D_DROPOUT = (8, 12, 512, 64), 1e-3, 0.1
OP4D_WARMUP, OP4D_STEPS, OP4D_PARITY_STEPS = 2, 10, 5
FLAT_KERNELS = ("flash_fwd_flat", "flash_bwd_dq_flat", "flash_bwd_dkv_flat")


def build_op4d(fused, dropout_rate):
    """The program of tests/test_pallas_attention.py:95 at OP4D_SHAPE:
    q = fc(x) over the head dim, attention of q over x with a key-padding
    bias, the mean squared error against y, Adam.  ``fused``: one
    fused_multihead_attention op (4-D, no num_heads); else the same
    attention from matmul, elementwise_add and softmax layers.  ->
    (main, startup, loss, grad names)."""
    import paddle_tpu_torch as pt

    B, H, T, D = OP4D_SHAPE
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED + 21
    main.random_seed = SEED + 22
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.data("x", shape=[B, H, T, D], dtype="float32")
        y = pt.data("y", shape=[B, H, T, D], dtype="float32")
        bias = pt.data("bias", shape=[B, 1, 1, T], dtype="float32")
        q = pt.layers.fc(x, size=D, num_flatten_dims=3, bias_attr=False)
        if fused:
            o = pt.layers.fused_multihead_attention(
                q, x, x, attn_bias=bias, dropout_rate=dropout_rate)
        else:
            s = pt.layers.matmul(q, x, transpose_y=True, alpha=D ** -0.5)
            p = pt.layers.softmax(pt.layers.elementwise_add(s, bias))
            o = pt.layers.matmul(p, x)
        loss = pt.layers.reduce_mean(pt.layers.square_error_cost(o, y))
        _, params_grads = pt.optimizer.Adam(OP4D_LR).minimize(loss)
    return main, startup, loss, [g.name for _, g in params_grads]


def op4d_feed(device):
    import torch

    B, H, T, D = OP4D_SHAPE
    rng = np.random.RandomState(SEED + 23)
    x, y = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(2))
    feed = {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
            "bias": padding_bias(B, T)}
    return {n: t.to(device) for n, t in feed.items()}


def op4d_phase(device):
    """The 4-D fused_attention op through the Executor: OP4D_WARMUP +
    OP4D_STEPS Adam steps with dropout, gated on finite losses, one
    launch per step of each flat kernel, no packed kernel and no plain
    version, and no library load after the first step; then the parity
    gate at dropout 0 against the matmul/softmax program from the same
    weights."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda

    on_card = device.type == "cuda"
    exe = pt.Executor(pt.CUDAPlace(0) if on_card else pt.CPUPlace())
    main, startup, loss, _ = build_op4d(True, OP4D_DROPOUT)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = op4d_feed(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    warm = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
            for _ in range(OP4D_WARMUP)]
    sync(device)
    with _PlainCalls() as plain:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        losses = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                          return_numpy=False)[0] for _ in range(OP4D_STEPS)]
        sync(device)
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in _cuda.LAUNCHES.items() if n}
    losses = [float(x) for x in warm] + [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    want = {k: OP4D_STEPS for k in FLAT_KERNELS} if on_card else {}
    step_ms = wall / OP4D_STEPS * 1e3
    log(f"  4-D op program {list(OP4D_SHAPE)}, key padding, dropout "
        f"{OP4D_DROPOUT}, Adam({OP4D_LR:g}): {OP4D_STEPS} steps "
        f"{step_ms:.3f} ms/step; losses " + " ".join(f"{x:.5f}" for x in losses)
        + f"; launches {launches} (want {want}); plain kernel versions "
        f"called {plain.calls}; libraries loaded after the first step "
        f"{exe.compiles_after_first_step}; peak memory {peak / 2**30:.2f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a 4-D op loss is not finite: {losses}")
    if launches != want:
        raise AssertionError(f"4-D op launches {launches}, expected {want} "
                             f"(each flat kernel once per step, nothing else)")
    if on_card and plain.calls:
        raise AssertionError("a plain kernel version ran on the card")
    if exe.compiles_after_first_step:
        raise AssertionError("a kernel library was loaded after the first "
                             "step")
    del scope
    return dict(shape=list(OP4D_SHAPE), losses=losses, step_ms=step_ms,
                launches=launches, peak_memory_bytes=peak,
                parity=op4d_parity(device, exe))


def op4d_parity(device, exe):
    """At dropout 0 from the same weights: OP4D_PARITY_STEPS Adam steps
    of the 4-D op program (the flat kernels, each once per step) and of
    the matmul/softmax program (no kernel of the port); every loss within
    PARITY_LOSS_TOL and every first-step gradient within a relative norm
    error of PARITY_GRAD_RTOL."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda

    on_card = device.type == "cuda"
    feed = op4d_feed(device)
    runs, weights = {}, None
    for fused in (True, False):
        main, startup, loss, grads = build_op4d(fused, 0.0)
        scope = pt.Scope()
        if weights is None:
            exe.run(startup, scope=scope)
            weights = {n: scope.find_var(n).clone()
                       for n in pt.io.persistable_names(main)}
        else:
            for n, t in weights.items():
                scope.set_var(n, t.clone())
        losses, first = [], None
        _cuda.reset_launches()
        for step in range(OP4D_PARITY_STEPS):
            out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                          fetch_list=[loss] + (grads if step == 0 else []))
            losses.append(float(out[0]))
            if step == 0:
                first = dict(zip(grads, out[1:]))
        sync(device)
        launches = {k: n for k, n in _cuda.LAUNCHES.items() if n}
        want = {k: OP4D_PARITY_STEPS for k in FLAT_KERNELS} \
            if fused and on_card else {}
        if launches != want:
            raise AssertionError(f"the {'fused' if fused else 'plain'} 4-D "
                                 f"program launched {launches}, expected "
                                 f"{want}")
        runs[fused] = (losses, first)
        del scope
    (lf, gf), (lp, gp) = runs[True], runs[False]
    dloss = max(abs(a - b) for a, b in zip(lf, lp))
    rel = {n: float(torch.linalg.vector_norm(gf[n] - gp[n])
                    / torch.linalg.vector_norm(gp[n]).clamp_min(1e-30))
           for n in gp}
    log(f"  4-D op parity at dropout 0, same weights, {OP4D_PARITY_STEPS} "
        f"Adam steps: fused " + " ".join(f"{x:.6f}" for x in lf) + "; plain "
        + " ".join(f"{x:.6f}" for x in lp) + f"; max |dloss| {dloss:.3e} "
        f"(tol {PARITY_LOSS_TOL:g}); first-step gradient relative norm "
        f"error {rel} (tol {PARITY_GRAD_RTOL:g})")
    if not dloss < PARITY_LOSS_TOL:
        raise AssertionError("4-D op and plain program losses diverge")
    if not max(rel.values()) < PARITY_GRAD_RTOL:
        raise AssertionError("4-D op and plain program gradients disagree")
    return dict(fused_losses=lf, plain_losses=lp, max_dloss=dloss,
                grad_rel_err=rel)


# -- phase 7: the sequence-parallel train step -------------------------------

#: phase 7: _dryrun_seq's step (__graft_entry__.py:321) at [B, H, T, D]
#: on a one-rank data x seq mesh: steps, SGD rate
SEQ_SHAPE, SEQ_STEPS, SEQ_LR = (2, 12, 4096, 64), 10, 0.1
#: the ring's w after SEQ_STEPS steps against the plain step's: relative
#: norm error
SEQ_W_RTOL = 1e-4


def seq_parallel_phase(device):
    """_dryrun_seq's data x seq train step on a one-rank NCCL group (a
    file store in a temporary directory) and build_mesh({"data": 1,
    "seq": 1}): q = x w, causal ring_attention(q, x, x) over the seq
    group, the squared error against y over the element count, the loss
    and gradient all-reduced over data and seq, SGD; one untimed warm-up
    step, then SEQ_STEPS timed ones from the same w.  Gated: the flat
    kernels launch once per step each and no plain version runs; every
    loss within PARITY_LOSS_TOL of the same step over the plain
    attention composite, and w after SEQ_STEPS steps within SEQ_W_RTOL.
    Peak memory of both steps is reported: the ring never holds the
    [B, H, T, T] scores."""
    import tempfile

    import torch
    import torch.distributed as dist

    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.ops.attention import attention
    from paddle_tpu_torch.parallel import build_mesh, ring_attention

    on_card = device.type == "cuda"
    B, H, T, D = SEQ_SHAPE
    rng = np.random.RandomState(SEED + 5)
    x, y = (torch.from_numpy(rng.randn(B, H, T, D).astype(np.float32))
            .to(device) for _ in range(2))
    w0 = torch.from_numpy((rng.randn(D, D) * 0.1).astype(np.float32)).to(
        device)
    total = float(y.numel())
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if on_card else "gloo",
                                store=dist.FileStore(f"{tmp}/store", 1),
                                rank=0, world_size=1)
        try:
            mesh = build_mesh({"data": 1, "seq": 1},
                              device_type=device.type)
            for name in ("ring", "plain"):
                def step(w):
                    leaf = w.clone().requires_grad_()
                    q = torch.einsum("bhtd,de->bhte", x, leaf)
                    if name == "ring":
                        o = ring_attention(q, x, x, mesh=mesh, axis="seq",
                                           causal=True)
                    else:
                        o = attention(q, x, x, causal=True)
                    loss = ((o - y) ** 2).sum() / total
                    (g,) = torch.autograd.grad(loss, [leaf])
                    loss = loss.detach()
                    for axis in ("data", "seq"):
                        dist.all_reduce(loss, group=mesh.get_group(axis))
                        dist.all_reduce(g, group=mesh.get_group(axis))
                    return loss, w - SEQ_LR * g

                step(w0)    # warm-up: the groups' communicators, caches
                sync(device)
                w, losses = w0.clone(), []
                if on_card:
                    torch.cuda.reset_peak_memory_stats(device)
                with _PlainCalls() as plain:
                    _cuda.reset_launches()
                    t0 = time.perf_counter()
                    for _ in range(SEQ_STEPS):
                        loss, w = step(w)
                        losses.append(loss)
                    sync(device)
                    wall = time.perf_counter() - t0
                    launches = {k: n for k, n in _cuda.LAUNCHES.items() if n}
                results[name] = dict(
                    losses=[float(v) for v in losses], w=w,
                    step_ms=wall / SEQ_STEPS * 1e3, launches=launches,
                    plain_calls=plain.calls,
                    peak_memory_bytes=torch.cuda.max_memory_allocated(device)
                    if on_card else 0)
        finally:
            dist.destroy_process_group()
    ring, ref = results["ring"], results["plain"]
    want = {k: SEQ_STEPS for k in FLAT_KERNELS} if on_card else {}
    dloss = max(abs(a - b) for a, b in zip(ring["losses"], ref["losses"]))
    w_err = float(torch.linalg.vector_norm(ring["w"] - ref["w"])
                  / torch.linalg.vector_norm(ref["w"]))
    scores = B * H * T * T * 4
    log(f"  sequence-parallel step {list(SEQ_SHAPE)}, mesh data 1 x seq 1 "
        f"({'NCCL' if on_card else 'gloo'}), causal ring attention, SGD({SEQ_LR:g}), {SEQ_STEPS} steps: "
        f"ring {ring['step_ms']:.3f} ms/step, plain {ref['step_ms']:.3f} "
        f"ms/step; losses ring " + " ".join(f"{v:.6f}" for v in ring["losses"])
        + "; plain " + " ".join(f"{v:.6f}" for v in ref["losses"])
        + f"; max |dloss| {dloss:.3e} (tol {PARITY_LOSS_TOL:g}); w relative "
        f"norm error {w_err:.3e} (tol {SEQ_W_RTOL:g}); launches "
        f"{ring['launches']} (want {want}); plain versions called "
        f"{ring['plain_calls']}; peak memory ring "
        f"{ring['peak_memory_bytes'] / 2**30:.3f} GiB, plain "
        f"{ref['peak_memory_bytes'] / 2**30:.3f} GiB (one [B, H, T, T] f32 "
        f"score tensor is {scores / 2**30:.3f} GiB)")
    if ring["launches"] != want:
        raise AssertionError(f"ring launches {ring['launches']}, expected "
                             f"{want}")
    if on_card and ring["plain_calls"]:
        raise AssertionError("a plain kernel version ran in the ring step")
    if not dloss < PARITY_LOSS_TOL:
        raise AssertionError("ring and plain step losses diverge")
    if not w_err < SEQ_W_RTOL:
        raise AssertionError("ring and plain step weights diverge")
    if on_card and not ring["peak_memory_bytes"] < scores:
        raise AssertionError("the ring step held a [B, H, T, T] tensor")
    for r in results.values():
        del r["w"]
    return dict(shape=list(SEQ_SHAPE), max_dloss=dloss, w_rel_err=w_err,
                score_tensor_bytes=scores, **results)

# -- phase 8: the traced path -----------------------------------------------

#: phase 8a: client threads, each sending N_PROMPTS // SERVE_CLIENTS
#: prompts as one request; the batcher waits up to SERVE_WAIT_MS for
#: them, so the engine sees the batch phase 3 gave it
SERVE_CLIENTS = 4
SERVE_WAIT_MS = 2000.0
#: the serving paths' plain attention versions, by module
SERVING_PLAIN = {
    "generation.kv_cache": ("ragged_ref_attention",
                            "paged_plain_decode_attention",
                            "gathered_decode_attention"),
    "generation.ragged_attention": ("ragged_ref_attention",),
    "generation.attention": ("paged_ref_decode_attention",
                             "paged_plain_decode_attention"),
}
#: phase 8b: the kernels whose launches the Kineto trace must attribute
#: to a program op's scope (name counted by _cuda, kernel entry)
TRAIN_TRACED = (("gemm_epilogue", "gemm_tc_kernel"),
                ("ffn_chain", "ffn_chain_kernel"),
                ("flash_fwd_qkv", "flash_fwd_tc_kernel"))
_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*",?)*\})? (\S+)$')


def _host_spans(events):
    """{span_id: (name, trace_id, parent_span_id, t0, t1)} of the
    profiler's host events that carry span ids."""
    return {a["span_id"]: (n, a["trace_id"], a["parent_span_id"], t0, t1)
            for n, t0, t1, _, a in events if a and "span_id" in a}


def _has_ancestor(spans, sid, prefix):
    seen = set()
    while sid is not None and sid not in seen:
        seen.add(sid)
        name, _, parent, _, _ = spans.get(sid, (None, None, None, 0, 0))
        if name is not None and name.startswith(prefix):
            return True
        sid = parent
    return False


def _prometheus_gate(path):
    """Every line of a Prometheus text file parses: HELP/TYPE comments
    or ``name{labels} value`` with a float value."""
    from paddle_tpu_torch.observability import write_prometheus

    write_prometheus(str(path))
    lines = path.read_text().splitlines()
    for line in lines:
        if line.startswith(("# HELP ", "# TYPE ")):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            raise AssertionError(f"unparsable Prometheus line {line!r}")
        float(m.group(4))
    return len(lines)


def _gzip(path):
    """Gzip a trace in place (chiprun_out is bounded) -> the new path."""
    import gzip
    import shutil

    path = Path(path)
    out = path.with_name(path.name + ".gz")
    with open(path, "rb") as f, gzip.open(out, "wb") as g:
        shutil.copyfileobj(f, g)
    path.unlink()
    return str(out.relative_to(OUT_DIR.parent))


def _device_in_ranges(doc, range_name):
    """(host us of the ``range_name`` ranges, device us of the kernels
    that ran inside their device side, number of ranges)."""
    from paddle_tpu_torch import profiler

    host = profiler.trace_ranges(doc, range_name)
    ranges = profiler.trace_ranges(doc, range_name, device=True)
    dev = sum(t1 - t0 for _, t0, t1 in profiler.trace_kernels(doc)
              if any(r0 <= t0 and t1 <= r1 for _, r0, r1 in ranges))
    return sum(t1 - t0 for _, t0, t1 in host), dev, len(host)


def traced_serving_phase(device, model_cfg, gen_cfg, params, mode):
    """Phase 8a: a fresh engine (``mode`` chunked or legacy; ``params``
    phase 3's weights, as numpy arrays or tensors) behind
    InferenceServer + GenerationBackend, served to SERVE_CLIENTS client
    threads, each inside its own span, with the profiler's device trace
    on and the flight recorder armed.  Gates: the answers equal the same
    engine's untraced generate; the attention kernel launches once per
    layer per step, no plain version runs, nothing loads after warmup;
    every batch span and queue wait joins the trace of the client that
    submitted the batch's first request, and every step span has a batch
    span as an ancestor; the registry agrees with the stats; the ledger
    counters move with the snapshot; the Prometheus text parses; the
    ring holds the step spans and one seq_finish per sequence; in the
    Kineto trace every attention kernel runs inside a step range's
    device side (``profiler.kernels_inside``).  Reports decode tokens/s traced and untraced and where a
    step's host time goes."""
    from paddle_tpu_torch import _cuda, profiler
    from paddle_tpu_torch.generation import (GenerationBackend,
                                             GenerationEngine, SamplingParams)
    from paddle_tpu_torch.observability import flightrec, tracing
    from paddle_tpu_torch.serving import InferenceServer, ServingConfig

    on_card = device.type == "cuda"
    legacy = mode == "legacy"
    kernel = "paged_decode_attention" if legacy else "ragged_paged_attention"
    other = "ragged_paged_attention" if legacy else "paged_decode_attention"
    entry = "paged_decode_kernel" if legacy else "ragged_attention_kernel"
    step_span = "generation:decode_step" if legacy else \
        "generation:chunk_step"
    steps_key = "decode_steps" if legacy else "steps"
    cfg = dataclasses.replace(gen_cfg, scheduling="legacy") if legacy \
        else gen_cfg
    L = model_cfg.num_layers
    prompts = make_prompts(np.random.RandomState(SEED + 1), N_PROMPTS,
                           PROMPT_LEN, model_cfg.vocab_size)
    greedy = SamplingParams(max_new_tokens=MAX_NEW)
    engine = GenerationEngine(model_cfg, params, cfg, device=device)
    engine.warmup()
    eid = engine.stats.engine_id

    def decode_s():
        return _series_total("generation_seconds_total", engine=eid,
                             phase="decode")

    s0, d0 = engine.stats.snapshot()["decode_tokens"], decode_s()
    ref, _, ref_wall = drive(engine, prompts, greedy, device)
    untraced_tps = (engine.stats.snapshot()["decode_tokens"] - s0) \
        / (decode_s() - d0)
    backend = GenerationBackend(engine, max_new_tokens=MAX_NEW)
    per = N_PROMPTS // SERVE_CLIENTS
    server = InferenceServer(backend, ServingConfig(
        batch_buckets=(N_PROMPTS,), seq_buckets=(PROMPT_LEN,),
        pad_values={"prompt_lens": 1},
        max_batch_wait_ms=SERVE_WAIT_MS)).start()
    answers, errors = [None] * SERVE_CLIENTS, []
    trace_dir = TRACE_DIR / f"serving_{mode}"
    try:
        server.warmup()
        sync(device)
        snap0, ledger0 = engine.stats.snapshot(), engine.ledger_counters()
        d0, loads0 = decode_s(), _cuda.library_loads()

        def client(c):
            rows = np.asarray(prompts[c * per:(c + 1) * per], np.int32)
            try:
                with tracing.span("client_request", client=c):
                    out, n = server.infer(
                        {"token_ids": rows, "prompt_lens": np.full(
                            per, PROMPT_LEN, np.int32)}, timeout_ms=600_000)
                answers[c] = [out[i, :int(n[i])].tolist()
                              for i in range(per)]
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        profiler.reset_profiler()
        flightrec.arm()
        flightrec.get_recorder().clear()
        profiler.start_profiler("All" if on_card else "CPU",
                                tracer_path=str(trace_dir))
        try:
            with _PlainCalls(SERVING_PLAIN) as plain:
                _cuda.reset_launches()
                t0 = time.perf_counter()
                threads = [threading.Thread(target=client, args=(c,))
                           for c in range(SERVE_CLIENTS)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                sync(device)
                wall = time.perf_counter() - t0
                launches = dict(_cuda.LAUNCHES)
        finally:
            profiler.stop_profiler(quiet=True)
            ring = flightrec.get_recorder().dump()
            flightrec.disarm(clear=True)
        stats = server.stats()
        sid = server._stats.server_id
    finally:
        server.close()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"traced clients failed: {errors}")
    snap1, ledger1 = engine.stats.snapshot(), engine.ledger_counters()
    events = list(profiler._events)
    host_path = profiler.export_chrome_tracing(str(trace_dir / "host.json"))
    doc = profiler.load_device_trace()
    kineto_path = profiler.last_device_trace()

    # tracing changes nothing; the kernel path is unchanged
    served = [a for c in answers for a in c]
    same = [a == r.tokens for a, r in zip(served, ref)]
    steps = snap1[steps_key] - snap0[steps_key]
    plain_calls = plain.calls
    if not all(same):
        raise AssertionError(f"traced answers differ from the untraced "
                             f"generate: {same}")
    want = L * steps if on_card else 0
    if launches.get(kernel, 0) != want or launches.get(other, 0):
        raise AssertionError(f"launches {launches}, expected {kernel} "
                             f"{want} and no {other}")
    if on_card and plain_calls:
        raise AssertionError("a plain attention version ran")
    if (_cuda.library_loads() != loads0 or snap1["compiles_after_warmup"]
            or stats["compiles_after_warmup"]):
        raise AssertionError("something compiled or loaded after warmup")

    # span structure: batches and queue waits join their clients' traces
    spans = _host_spans(events)
    clients = {tid: sid_ for sid_, (n, tid, _, _, _) in spans.items()
               if n == "client_request"}
    pending, n_batches, n_waits = [], 0, 0
    for name, _, _, _, a in events:
        if name == "serving:queue_wait":
            if a["trace_id"] not in clients \
                    or a["parent_span_id"] != clients[a["trace_id"]]:
                raise AssertionError(f"a queue wait outside its client's "
                                     f"trace: {a}")
            pending.append(a)
            n_waits += 1
        elif name.startswith("serving:batch_b"):
            if not pending or a["trace_id"] != pending[0]["trace_id"] \
                    or a["parent_span_id"] != clients[a["trace_id"]]:
                raise AssertionError(f"batch span {a} does not join the "
                                     f"trace of its first request")
            pending, n_batches = [], n_batches + 1
    step_ids = [sid_ for sid_, v in spans.items() if v[0] == step_span]
    orphans = [s for s in step_ids
               if not _has_ancestor(spans, s, "serving:batch_b")]
    if n_waits != SERVE_CLIENTS or not n_batches or len(step_ids) != steps \
            or orphans:
        raise AssertionError(
            f"{n_waits} queue waits, {n_batches} batches, {len(step_ids)} "
            f"of {steps} step spans, {len(orphans)} without a batch "
            f"ancestor")

    # the registry agrees with the stats; the ledger moves with them
    tokens = _series_total("generation_tokens_total", engine=eid)
    requests = _series_total("serving_requests_total", server=sid)
    ok = _series_total("serving_requests_total", server=sid, outcome="ok")
    if tokens != snap1["prefill_tokens"] + snap1["decode_tokens"]:
        raise AssertionError(f"generation_tokens_total {tokens} != the "
                             f"snapshot's prefill + decode tokens")
    if requests != SERVE_CLIENTS or ok != SERVE_CLIENTS:
        raise AssertionError(f"serving_requests_total {requests} (ok "
                             f"{ok}), expected {SERVE_CLIENTS}")
    for k in ("decode_tokens", "prefill_chunks", "spec_drafted",
              "spec_accepted"):
        if ledger1[k] - ledger0[k] != snap1[k] - snap0[k]:
            raise AssertionError(f"ledger {k} moved {ledger1[k] - ledger0[k]}"
                                 f", the snapshot {snap1[k] - snap0[k]}")
    prom_lines = _prometheus_gate(trace_dir / "metrics.prom")

    # the flight recorder's ring
    ring_steps = sum(e["kind"] == "span" and e["name"] == step_span
                     for e in ring["events"])
    finished = sum(e["kind"] == "note" and e["note"] == "seq_finish"
                   and e["fields"]["engine"] == eid for e in ring["events"])
    if ring_steps != steps or finished != N_PROMPTS:
        raise AssertionError(f"ring: {ring_steps} step spans of {steps}, "
                             f"{finished} seq_finish of {N_PROMPTS}")

    # the Kineto trace: every attention kernel launched inside a step
    n_kernel, inside = profiler.kernels_inside(doc, entry, step_span)
    if n_kernel != want or inside != n_kernel:
        raise AssertionError(
            f"Kineto: {n_kernel} {entry} kernels, {inside} inside "
            f"{step_span}; expected {want}; kernels "
            f"{[k for k in profiler.trace_kernels(doc) if entry in k[0]][:3]}"
            f", device ranges "
            f"{profiler.trace_ranges(doc, step_span, device=True)[:3]}")
    with open(host_path) as f:
        host_doc = json.load(f)
    if "perf_origin_unix_us" not in host_doc["metadata"]:
        raise AssertionError("the host trace lacks perf_origin_unix_us")

    # where the host's time goes, by span
    def span_ms(prefix):
        return [(t1 - t0) * 1e3 for n, t0, t1, _, _ in events
                if n.startswith(prefix)]

    batch_ms, step_ms = span_ms("serving:batch_b"), span_ms(step_span)
    host_us, dev_us, n_ranges = _device_in_ranges(doc, step_span)
    traced_tps = (snap1["decode_tokens"] - snap0["decode_tokens"]) \
        / (decode_s() - d0)
    out = dict(
        steps=steps, batches=n_batches, wall_s=wall, launches=launches,
        answers_equal=True, untraced_wall_s=ref_wall,
        decode_tokens_per_s=dict(traced=traced_tps, untraced=untraced_tps,
                                 ratio=traced_tps / untraced_tps),
        spans_ms=dict(
            batch=sum(batch_ms), steps=sum(step_ms),
            batch_outside_steps=sum(batch_ms) - sum(step_ms),
            step_mean=float(np.mean(step_ms)),
            step_device_busy_mean=dev_us / 1e3 / n_ranges,
            step_device_busy_share=dev_us / host_us),
        prometheus_lines=prom_lines, ring_events=len(ring["events"]),
        kineto_trace=_gzip(kineto_path), host_trace=_gzip(host_path))
    log(f"  traced {mode} serving: {SERVE_CLIENTS} clients x {per} prompts, "
        f"{n_batches} batch(es), {steps} {steps_key}, answers equal to the "
        f"untraced generate; {kernel} {launches.get(kernel, 0)} launches "
        f"(= {L} x {steps}), all inside {step_span} in the Kineto trace; "
        f"decode {traced_tps:.1f} tok/s traced vs {untraced_tps:.1f} "
        f"untraced ({traced_tps / untraced_tps:.3f}); batch span "
        f"{sum(batch_ms):.1f} ms = steps {sum(step_ms):.1f} ms + between "
        f"steps {sum(batch_ms) - sum(step_ms):.1f} ms; a step "
        f"{np.mean(step_ms):.3f} ms host, device busy "
        f"{dev_us / 1e3 / n_ranges:.3f} ms of it "
        f"({dev_us / host_us:.3f}); Prometheus {prom_lines} lines parse")
    return out


def _op_scope_of(ranges, kernel):
    """The innermost program-op scope (the device side of a
    ``type:first_output`` range) a kernel ran inside, or None."""
    _, t0, t1 = kernel
    inside = [(r1 - r0, name) for name, r0, r1 in ranges
              if r0 <= t0 and t1 <= r1]
    return min(inside)[1] if inside else None


def traced_training_phase(device, cfg):
    """Phase 8b: phase 5's fused program (``cfg`` pretraining, 32 x 128)
    set up anew, TRAIN_WARMUP steps, COMPARE_STEPS untraced steps, then
    one step inside ``span("train:step")`` under the profiler's device
    trace.  Gates: the kernels launch as in phase 5; every gemm_epilogue,
    ffn_chain and flash_fwd_qkv kernel runs inside a program op's
    ``type:first_output`` scope.  Reports the traced and untraced step
    times and where the traced step's host time goes."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda, profiler
    from paddle_tpu_torch.core.lowering import _op_scope_name
    from paddle_tpu_torch.observability import flightrec, tracing

    main, startup, loss, _, _ = build_train(cfg)
    exe = pt.Executor(pt.CUDAPlace(0) if device.type == "cuda"
                      else pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = train_batch(cfg.vocab_size, device)
    L = cfg.num_layers
    for _ in range(TRAIN_WARMUP):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    t0 = time.perf_counter()
    for _ in range(COMPARE_STEPS):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                return_numpy=False)
    sync(device)
    untraced_ms = (time.perf_counter() - t0) / COMPARE_STEPS * 1e3
    profiler.reset_profiler()
    flightrec.arm()
    _cuda.reset_launches()
    profiler.start_profiler("All" if device.type == "cuda" else "CPU",
                            tracer_path=str(TRACE_DIR / "training"))
    try:
        t0 = time.perf_counter()
        with tracing.span("train:step", step=0):
            out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        sync(device)
        traced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        profiler.stop_profiler(quiet=True)
        flightrec.disarm(clear=True)
    launches = dict(_cuda.LAUNCHES)
    events = list(profiler._events)
    doc = profiler.load_device_trace()
    if not np.isfinite(out[0]).all():
        raise AssertionError("the traced step's loss is not finite")
    want = {k: L for k in FUSED_STEP_KERNELS} if device.type == "cuda" \
        else {}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"traced step launches {got}, expected {want}")
    scope_names = {_op_scope_name(op) for op in main.global_block().ops}
    op_ranges = [(e["name"], e["ts"], e["ts"] + e.get("dur", 0))
                 for e in doc["traceEvents"]
                 if e.get("cat") == "gpu_user_annotation"
                 and e.get("name") in scope_names]
    attributed = {}
    kernels = profiler.trace_kernels(doc)
    for name, entry_ in TRAIN_TRACED:
        found = [k for k in kernels if entry_ in k[0]]
        scopes = [_op_scope_of(op_ranges, k) for k in found]
        attributed[name] = collections.Counter(
            s.split(":")[0] if s else None for s in scopes)
        if len(found) != want.get(name, 0) or None in attributed[name]:
            raise AssertionError(
                f"{name}: {len(found)} {entry_} kernels in the trace "
                f"(want {want.get(name, 0)}), op scopes {attributed[name]}")
    # host time by scope: the step, run:, and the program ops by type
    run_ms = sum((t1 - t0) * 1e3 for n, t0, t1, _, _ in events
                 if n.startswith("run:"))
    by_type = collections.Counter()
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("name") in \
                scope_names:
            by_type[e["name"].split(":")[0]] += e.get("dur", 0) / 1e3
    # the session holds the one step: its kernels are the step's (a
    # range's device twin covers the kernels of the innermost range
    # only, so train:step's own twin holds almost none)
    host_us = sum(t1 - t0 for _, t0, t1 in profiler.trace_ranges(
        doc, "train:step"))
    dev_us = sum(t1 - t0 for _, t0, t1 in kernels)
    out = dict(untraced_step_ms=untraced_ms, traced_step_ms=traced_ms,
               ratio=traced_ms / untraced_ms, run_span_ms=run_ms,
               op_scopes_ms=sum(by_type.values()),
               op_scopes_by_type_ms=dict(by_type.most_common(10)),
               device_busy_ms=dev_us / 1e3,
               device_busy_share=dev_us / host_us if host_us else None,
               launches=got, attributed={k: dict(v) for k, v in
                                         attributed.items()},
               kineto_trace=_gzip(profiler.last_device_trace()))
    log(f"  traced training step: {traced_ms:.3f} ms (untraced "
        f"{untraced_ms:.3f} ms/step, ratio {traced_ms / untraced_ms:.3f}); "
        f"run: {run_ms:.3f} ms, op scopes {sum(by_type.values()):.3f} ms "
        f"(" + ", ".join(f"{k} {v:.2f}" for k, v in by_type.most_common(6))
        + f"), device busy {dev_us / 1e3:.3f} ms; kernels by op scope "
        + "; ".join(f"{k}: {dict(v)}" for k, v in attributed.items()))
    return out


# -- phase 9: disaggregated serving -------------------------------------------

#: phase 9b: client threads, each submitting N_PROMPTS // CLUSTER_CLIENTS
#: of phase 3a's prompts to the router
CLUSTER_CLIENTS = 4
#: phase 9b: seconds a worker process has to start, make its weights and
#: warm its engine up
CLUSTER_READY_S = 300.0
#: phase 9b: each pool's worker log (workerlog.0) goes to a directory here
CLUSTER_LOG_DIR = OUT_DIR / "phase9"


def cluster_engine(model="base", layers=None, scheduling="chunked",
                   device=None, seed=SEED, tune_dir=None):
    """The worker factory of phases 9b and 14c (``chip_smoke:
    cluster_engine`` in a WorkerSpec; a worker process imports this file
    as a module): phase 3a's engine — ``BertConfig.<model>()`` with
    initializer_range 0.6, its weights made from ``seed``, cut to
    ``layers`` layers when given — on the card unless ``device`` says
    otherwise.  ``tune_dir``: the process's tuning store is its own file
    there (``PADDLE_TPU_AUTOTUNE_CACHE``)."""
    from paddle_tpu_torch.generation import GenerationConfig, GenerationEngine
    from paddle_tpu_torch.models import BertConfig, lm_random_params

    if tune_dir is not None:
        os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = os.path.join(
            tune_dir, f"worker-{os.getpid()}.json")
    model_cfg = dataclasses.replace(getattr(BertConfig, model)(),
                                    initializer_range=0.6)
    params = lm_random_params(model_cfg, np.random.RandomState(seed))
    if layers:
        model_cfg, params = cut_model(model_cfg, params, layers)
    return GenerationEngine(model_cfg, params, GenerationConfig(
        page_size=PAGE_SIZE, max_seqs=MAX_SEQS, max_seq_len=MAX_SEQ_LEN,
        seed=SEED, scheduling=scheduling), device=device)


def _bits_equal(a, b):
    return (a is not None and b is not None and a.shape == b.shape
            and a.dtype == b.dtype == np.float32
            and np.array_equal(a.view(np.uint32), b.view(np.uint32)))


def _max_diff(a, b):
    if a is None or b is None or a.shape != b.shape:
        return float("inf")
    return float(np.abs(a.astype(np.float64) - b).max())


def _ttft_summary(ms):
    return dict(p50=float(np.percentile(ms, 50)),
                p99=float(np.percentile(ms, 99)), max=float(max(ms)))


def single_engine_run(engine, prompts, sampling, device):
    """The prompts through one engine's ``stream``: tokens, each
    request's time to its first token, the wall time."""
    toks = [[] for _ in prompts]
    ttft = [None] * len(prompts)
    t0 = time.perf_counter()
    for ev in engine.stream(prompts, sampling=sampling):
        if ttft[ev.index] is None:
            ttft[ev.index] = (time.perf_counter() - t0) * 1e3
        toks[ev.index].append(ev.token)
    sync(device)
    return toks, ttft, time.perf_counter() - t0


def handoff_round_trips(device, model_cfg, engine, handoffs):
    """Each handoff imported into ``engine``'s paged cache and into a
    dense cache of the same geometry, then exported again: the bytes
    must come back unchanged.  Returns the per-request import and export
    milliseconds of the paged cache (host clock; each ends in a
    synchronisation)."""
    from paddle_tpu_torch.generation import DenseKVCache

    dense = DenseKVCache(num_layers=model_cfg.num_layers,
                         hidden=model_cfg.hidden_size, max_seqs=1,
                         max_len=MAX_SEQ_LEN, device=device)
    import_ms, export_ms = [], []
    for i, h in enumerate(handoffs):
        for cache in (engine.cache, dense):
            slot = cache.free_slots()[0]
            cache.admit(slot, h.prompt_len)
            sync(device)
            t0 = time.perf_counter()
            cache.import_seq(slot, h.kv_k, h.kv_v)
            sync(device)
            t1 = time.perf_counter()
            k, v = cache.export_seq(slot, h.prompt_len)
            t2 = time.perf_counter()
            cache.release(slot)
            if not (_bits_equal(k, h.kv_k) and _bits_equal(v, h.kv_v)):
                diff = max(_max_diff(k, h.kv_k), _max_diff(v, h.kv_v))
                raise AssertionError(
                    f"request {i}: import_seq then export_seq on the "
                    f"{cache.kind} cache changed the K/V (largest "
                    f"difference {diff:.3e})")
            if cache is engine.cache:
                import_ms.append((t1 - t0) * 1e3)
                export_ms.append((t2 - t1) * 1e3)
    return import_ms, export_ms


def disaggregated_run(device, model_cfg, gen_cfg, params, prompts, greedy):
    """Phase 9a at one depth: a chunked prefill engine P hands each
    prompt to a chunked decode engine D and to a legacy decode engine,
    beside one chunked engine S that runs the prompts itself.  Gates:
    P's detached prefill and the concatenation of its streamed chunks
    agree bit for bit (last token, finish, K/V); the handoffs survive an
    import/export round trip through a paged and a dense cache bit for
    bit; on the card P and D launch the ragged kernel once per layer per
    step and the legacy engine the paged decode kernel once per layer per
    decode step (and the ragged kernel never), no plain attention runs
    and nothing is built or loaded after warmup; every request
    finishes."""
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.generation import GenerationEngine

    on_card = device.type == "cuda"
    L, vocab = model_cfg.num_layers, model_cfg.vocab_size

    def make(**kw):
        eng = GenerationEngine(model_cfg, params, dataclasses.replace(
            gen_cfg, **kw), device=device)
        eng.warmup()
        return eng

    P, D, DL, S = make(), make(), make(scheduling="legacy"), make()
    sync(device)
    loads0 = _cuda.library_loads()
    runs = {}

    def counted(name, eng, steps_key, fn):
        """One path's run with the launch counts set to 0 just before it
        and read just after."""
        s0 = eng.stats.snapshot()[steps_key]
        _cuda.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        runs[name] = dict(out=out, wall_s=time.perf_counter() - t0,
                          launches=dict(_cuda.LAUNCHES),
                          steps=eng.stats.snapshot()[steps_key] - s0)
        return out

    with _PlainCalls(SERVING_PLAIN) as plain:
        detached = counted("prefill", P, "steps", lambda: [
            P.prefill_detached(p, greedy) for p in prompts])
        if any(done for _, done, _ in detached):
            raise AssertionError("a request finished at prefill")
        handoffs = [h for h, _, _ in detached]
        counted("decode", D, "steps", lambda: D.decode_prefilled(handoffs))
        counted("legacy_decode", DL, "decode_steps",
                lambda: DL.decode_prefilled(handoffs))
        plain_calls = plain.calls
    for name, kernel, other in (
            ("prefill", "ragged_paged_attention", "paged_decode_attention"),
            ("decode", "ragged_paged_attention", "paged_decode_attention"),
            ("legacy_decode", "paged_decode_attention",
             "ragged_paged_attention")):
        r = runs[name]
        n = r["launches"].get(kernel, 0)
        log(f"  depth {L} {name}: {r['steps']} steps in "
            f"{r['wall_s']:.3f} s, {kernel} launches {n} (= {L} x "
            f"{r['steps']}? {n == L * r['steps']}), {other} "
            f"{r['launches'].get(other, 0)}")
        if on_card and (n != L * r["steps"] or r["launches"].get(other)):
            raise AssertionError(
                f"{name}: {kernel} launched {n} times (want {L} x "
                f"{r['steps']}), {other} {r['launches'].get(other, 0)}")
    if on_card and plain_calls:
        raise AssertionError(f"{plain_calls} plain attention calls")
    # library loads are process-wide (an engine's compiles_after_warmup
    # also counts the loads of engines warmed up after it): none may
    # happen once all four engines are warm
    loads = _cuda.library_loads() - loads0
    if loads:
        raise AssertionError(f"{loads} libraries loaded after warmup")
    check_finished(runs["decode"]["out"], MAX_NEW, vocab, "decode")
    check_finished(runs["legacy_decode"]["out"], MAX_NEW, vocab,
                   "legacy decode")

    # the detached prefill against the streamed one, bit for bit
    worst = 0.0
    for i, (p, h) in enumerate(zip(prompts, handoffs)):
        items = list(P.prefill_stream(p, greedy))
        final = items[-1]
        ks = np.concatenate([it["k"] for it in items[:-1]], axis=1)
        vs = np.concatenate([it["v"] for it in items[:-1]], axis=1)
        same = (final["last_token"] == h.last_token and not final["done"]
                and final["finish_reason"] is None
                and _bits_equal(ks, h.kv_k) and _bits_equal(vs, h.kv_v))
        worst = max(worst, _max_diff(ks, h.kv_k), _max_diff(vs, h.kv_v))
        if not same:
            raise AssertionError(
                f"request {i}: prefill_detached and prefill_stream differ "
                f"(tokens {h.last_token}, {final['last_token']}; largest "
                f"K/V difference {worst:.3e})")
    import_ms, export_ms = handoff_round_trips(device, model_cfg, D,
                                               handoffs)
    single, s_ttft, s_wall = single_engine_run(S, prompts, greedy, device)
    s_snap = S.stats.snapshot()
    d_snap = D.stats.snapshot()
    nbytes = [h.kv_k.nbytes + h.kv_v.nbytes for h in handoffs]
    tokens = {n: [r.tokens for r in runs[k]["out"]]
              for n, k in (("chunked", "decode"),
                           ("legacy", "legacy_decode"))}
    match = {n: matched_prefix(_results(t), _results(single))
             for n, t in tokens.items()}
    log(f"  depth {L}: detached == streamed prefill, bit for bit (largest "
        f"difference {worst:g}); import/export round trips bit-exact "
        f"(paged, dense); handoff {nbytes[0]} bytes a request; import "
        f"{np.mean(import_ms):.3f} ms, export {np.mean(export_ms):.3f} ms "
        f"a request; matched prefix against the single engine: chunked "
        f"{match['chunked']:.4f}, legacy {match['legacy']:.4f}")
    return dict(
        tokens=tokens, single_tokens=single, handoff_bytes=nbytes,
        handoffs=handoffs, import_ms=import_ms, export_ms=export_ms,
        prefill_step_ms=runs["prefill"]["wall_s"] * 1e3
        / max(runs["prefill"]["steps"], 1),
        decode_step_ms=runs["decode"]["wall_s"] * 1e3
        / max(runs["decode"]["steps"], 1),
        legacy_decode_step_ms=runs["legacy_decode"]["wall_s"] * 1e3
        / max(runs["legacy_decode"]["steps"], 1),
        launches={n: r["launches"] for n, r in runs.items()},
        steps={n: r["steps"] for n, r in runs.items()},
        decode_tokens_per_s=d_snap["decode_tokens_per_sec"],
        single=dict(ttft_ms=s_ttft, wall_s=s_wall,
                    decode_tokens_per_s=s_snap["decode_tokens_per_sec"]),
        matched_prefix=match)


_Tokens = collections.namedtuple("_Tokens", "tokens")


def _results(tokens):
    """Token lists as objects with ``.tokens`` (matched_prefix's and
    recompute_gaps's input)."""
    return [_Tokens(t) for t in tokens]


def reference_gates(device, cut, cut_params, prompts, run, what):
    """Depth-2 token gates: every token of ``run`` reaches the plain
    recompute's argmax within GREEDY_LOGIT_TOL, and the chunked decode
    engine's tokens equal the single chunked engine's (the same kernel
    and the same K/V, bit for bit).  The legacy decode engine's equality
    is reported: its decode kernel sums the keys in another order, and
    on these prompts that flips a near tie (a token within 4e-3 of the
    max logit) — both choices are the recompute's argmax within the
    tolerance."""
    out = {}
    for name, toks in run["tokens"].items():
        same = toks == run["single_tokens"]
        gap, _ = recompute_gaps(cut_params, cut, prompts, _results(toks),
                                device)
        log(f"  depth {cut.num_layers} {what} {name}: tokens equal to the "
            f"single engine's: {same} (matched prefix "
            f"{run['matched_prefix'][name]:.4f}); "
            f"worst logit gap to the recompute's argmax {gap:.3e} (tol "
            f"{GREEDY_LOGIT_TOL:g})")
        if not gap <= GREEDY_LOGIT_TOL or (name == "chunked" and not same):
            raise AssertionError(
                f"depth {cut.num_layers} {what} {name}: a token misses the "
                f"recompute's argmax, or the chunked tokens differ from the "
                f"single engine's")
        out[name] = dict(equal_to_single=same, worst_gap=gap)
    return out


def wire_ms(handoffs):
    """Per handoff: one RpcClient round trip carrying it (pickled) to an
    RpcServer in this process over localhost, which unpickles it and
    answers — the control plane's cost for the bytes a request ships."""
    import pickle

    from paddle_tpu_torch.cluster import RpcClient, RpcServer

    srv = RpcServer("127.0.0.1", 0, lambda msg: {
        "ok": True, "n": msg["handoff"].kv_k.nbytes}).start()
    cli = RpcClient("127.0.0.1", srv.port, connect_timeout_s=10.0)
    try:
        cli.call("handoff", handoff=handoffs[0])      # connect and warm
        out = []
        for h in handoffs:
            t0 = time.perf_counter()
            cli.call("handoff", handoff=h)
            out.append((time.perf_counter() - t0) * 1e3)
        return out, len(pickle.dumps(handoffs[0],
                                     protocol=pickle.HIGHEST_PROTOCOL))
    finally:
        cli.close()
        srv.close()


def _log_tails(pools):
    for tag, pool in pools.items():
        for h in pool.handles():
            try:
                tail = Path(h.log_path).read_text()[-3000:]
            except OSError as e:
                tail = f"(unreadable: {e})"
            print(f"--- {tag} worker {h.rank} log ({h.log_path}) ---\n"
                  f"{tail}", file=sys.stderr, flush=True)


def routed_run(gr, prompts, sampling):
    """CLUSTER_CLIENTS client threads, each submitting its share of the
    prompts to the router and waiting for them: results in prompt order,
    each request's time to its first token (the router's stamps: submit
    to the prefill worker's answer), the wall time."""
    futs = [None] * len(prompts)
    errors = []
    per = len(prompts) // CLUSTER_CLIENTS

    def client(c):
        try:
            mine = range(c * per, (c + 1) * per)
            for i in mine:
                futs[i] = gr.submit(prompts[i], sampling=sampling)
            for i in mine:
                futs[i].result(timeout=600)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLUSTER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"client errors: {errors[:2]}")
    results = [f.result(timeout=0) for f in futs]
    ttft = [(f.t_first_token - f.t_submit) * 1e3 for f in futs]
    return results, ttft, wall


def _settled(gr, n, timeout_s=30.0):
    """The router's snapshot once all ``n`` requests are counted (a
    future wakes its waiter before the router's callback counts it)."""
    deadline = time.monotonic() + timeout_s
    snap = gr.stats()
    while (snap["requests_ok"] + snap["requests_failed"] < n
           and time.monotonic() < deadline):
        time.sleep(0.01)
        snap = gr.stats()
    return snap


def cluster_process_phase(device, model_cfg, model, prompts, inproc,
                          cut_params):
    """Phase 9b: one prefill and one decode worker process (``python -m
    paddle_tpu_torch.cluster.worker``, the engine of ``cluster_engine``)
    behind a GenerationRouter, at full depth and at REFERENCE_LAYERS;
    CLUSTER_CLIENTS client threads send the prompts.  The router streams
    pages (``stream_pages=True``); at full depth the same pools then
    serve the prompts once more with the monolithic handoff, for
    comparison.  Gates: every request ok, both workers alive, K/V chunks
    streamed (none with the monolithic handoff) and no fallback, nothing
    built or loaded after warmup in either worker; at REFERENCE_LAYERS
    every token reaches the plain recompute's argmax (``cut_params``:
    the weights cut to that depth, on ``device``).  The pools close in
    ``finally``, and no worker process may outlive them."""
    from paddle_tpu_torch.cluster import (ClusterConfig, GenerationRouter,
                                          WorkerPool, WorkerSpec)
    from paddle_tpu_torch.generation import SamplingParams

    greedy = SamplingParams(max_new_tokens=MAX_NEW)
    kw = dict(model=model, device=None if device.type == "cuda" else "cpu")
    depths = {"full": None, f"depth{REFERENCE_LAYERS}": REFERENCE_LAYERS}
    runs = (("full", "full", True), ("full_monolithic", "full", False),
            (f"depth{REFERENCE_LAYERS}", f"depth{REFERENCE_LAYERS}", True))
    pools, out = {}, {}
    try:
        t0 = time.perf_counter()
        for tag, layers in depths.items():
            for role in ("prefill", "decode"):
                pools[f"{tag}_{role}"] = WorkerPool(
                    WorkerSpec("chip_smoke:cluster_engine",
                               dict(kw, layers=layers), role=role), 1,
                    log_dir=str(CLUSTER_LOG_DIR / f"{tag}_{role}"),
                    ready_timeout_s=CLUSTER_READY_S)
        for pool in pools.values():
            pool.wait_ready()
        ready_s = time.perf_counter() - t0
        log(f"  4 worker processes ready in {ready_s:.1f} s (logs under "
            f"{CLUSTER_LOG_DIR})")
        for name, tag, stream in runs:
            gr = GenerationRouter(pools[f"{tag}_prefill"],
                                  pools[f"{tag}_decode"],
                                  ClusterConfig(stream_pages=stream,
                                                decode_batch=MAX_SEQS))
            try:
                before = gr.engine_stats()["workers"]["decode:0"]
                results, ttft, wall = routed_run(gr, prompts, greedy)
                snap = _settled(gr, len(prompts))
                workers = gr.engine_stats()["workers"]
            finally:
                gr.close()
            check_finished(results, MAX_NEW, model_cfg.vocab_size, name)
            toks = [r.tokens for r in results]
            compiles = {w: s["compiles_after_warmup"]
                        for w, s in workers.items()}
            dec = workers["decode:0"]
            d_tok = dec["decode_tokens"] - before["decode_tokens"]
            d_s = (dec["decode_tokens"] / dec["decode_tokens_per_sec"]
                   - (before["decode_tokens"]
                      / before["decode_tokens_per_sec"]
                      if before["decode_tokens"] else 0.0))
            d_steps = dec["steps"] - before["steps"]
            n_tok = sum(len(t) for t in toks)
            log(f"  {name}: {len(prompts)} requests in {wall:.3f} s "
                f"({n_tok / wall:.1f} tokens/s end to end); time to first "
                f"token p50 {np.percentile(ttft, 50):.1f} ms, p99 "
                f"{np.percentile(ttft, 99):.1f} ms; decode worker "
                f"{d_tok / d_s:.1f} tokens/s over {d_steps} steps; stream "
                f"chunks {snap['stream_chunks_total']}, fallbacks "
                f"{snap['stream_fallbacks_total']}, workers alive "
                f"{snap['workers_alive']}; compiles after warmup "
                f"{compiles}")
            if (snap["requests_ok"] != len(prompts)
                    or snap["workers_alive"] != 2
                    or (snap["stream_chunks_total"] > 0) != stream
                    or snap["stream_fallbacks_total"] != 0
                    or any(compiles.values()) or len(workers) != 2):
                raise AssertionError(f"{name}: router stats {snap}, "
                                     f"worker compiles {compiles}")
            r = dict(wall_s=wall, ttft_ms=ttft, ttft=_ttft_summary(ttft),
                     e2e_tokens_per_s=n_tok / wall,
                     decode_tokens_per_s=d_tok / d_s, decode_steps=d_steps,
                     stream_chunks=snap["stream_chunks_total"],
                     stream_fallbacks=snap["stream_fallbacks_total"],
                     router_latency_ms=snap["latency_ms"],
                     matched_prefix_vs_single=matched_prefix(
                         results, _results(inproc[tag]["single_tokens"])))
            if depths[tag]:
                cut = dataclasses.replace(model_cfg, num_layers=depths[tag])
                gap, _ = recompute_gaps(cut_params, cut, prompts, results,
                                        device)
                same = toks == inproc[tag]["single_tokens"]
                log(f"  {name}: worst logit gap to the recompute's argmax "
                    f"{gap:.3e} (tol {GREEDY_LOGIT_TOL:g}); tokens equal to "
                    f"the in-process single engine's: {same}")
                if not gap <= GREEDY_LOGIT_TOL:
                    raise AssertionError(
                        f"{name}: a routed token misses the recompute's "
                        f"argmax")
                r.update(worst_gap=gap, equal_to_single=same)
            out[name] = r
    except Exception:
        _log_tails(pools)
        raise
    finally:
        for pool in pools.values():
            pool.close()
    left = [h.proc.pid for pool in pools.values() for h in pool.handles()
            if h.proc is not None and h.proc.poll() is None]
    if left:
        raise AssertionError(f"worker processes left running: {left}")
    out["ready_s"] = ready_s
    return out


def cluster_phase(device, model_cfg, gen_cfg, params_np, model="base"):
    """Phase 9: disaggregated serving of phase 3a's prompts — 9a in this
    process (the launch counts are readable here), 9b over worker
    processes behind the router — at full depth and at REFERENCE_LAYERS
    (the same weights cut), where the token gates hold.  ``model`` names
    ``model_cfg``'s BertConfig constructor for the worker processes."""
    from paddle_tpu_torch.generation import SamplingParams
    from paddle_tpu_torch.models import lm_params_from_numpy

    greedy = SamplingParams(max_new_tokens=MAX_NEW)
    prompts = make_prompts(np.random.RandomState(SEED + 1), N_PROMPTS,
                           PROMPT_LEN, model_cfg.vocab_size)
    params = lm_params_from_numpy(params_np, device)
    inproc = {"full": disaggregated_run(device, model_cfg, gen_cfg, params,
                                        prompts, greedy)}
    cut, cut_params = cut_model(model_cfg, params, REFERENCE_LAYERS)
    tag = f"depth{REFERENCE_LAYERS}"
    inproc[tag] = disaggregated_run(device, cut, gen_cfg, cut_params,
                                    prompts, greedy)
    gates = reference_gates(device, cut, cut_params, prompts, inproc[tag],
                            "in process")
    full = inproc["full"]
    wire, pickled = wire_ms(full["handoffs"])
    log(f"  wire: {np.mean(wire):.3f} ms a request ({pickled} pickled "
        f"bytes, one RPC round trip over localhost)")
    procs = cluster_process_phase(device, model_cfg, model, prompts, inproc,
                                  cut_params)
    report = dict(
        in_process={t: {k: v for k, v in r.items()
                        if k not in ("handoffs", "tokens", "single_tokens")}
                    for t, r in inproc.items()},
        reference=gates, processes=procs, wire_ms=wire,
        pickled_bytes=pickled)
    single = full["single"]
    report["line"] = dict(
        ttft_ms=procs["full"]["ttft"],
        decode_tokens_per_s=procs["full"]["decode_tokens_per_s"],
        e2e_tokens_per_s=procs["full"]["e2e_tokens_per_s"],
        handoff_bytes_per_request=int(np.mean(full["handoff_bytes"])),
        export_ms=float(np.mean(full["export_ms"])),
        wire_ms=float(np.mean(wire)),
        import_ms=float(np.mean(full["import_ms"])),
        prefill_step_ms=full["prefill_step_ms"],
        decode_step_ms=full["decode_step_ms"],
        stream_chunks=procs["full"]["stream_chunks"],
        stream_fallbacks=procs["full"]["stream_fallbacks"],
        matched_prefix_vs_single=dict(
            in_process=full["matched_prefix"],
            processes=procs["full"]["matched_prefix_vs_single"]),
        monolithic=dict(
            ttft_ms=procs["full_monolithic"]["ttft"],
            decode_tokens_per_s=procs["full_monolithic"][
                "decode_tokens_per_s"],
            e2e_tokens_per_s=procs["full_monolithic"]["e2e_tokens_per_s"]),
        single_engine=dict(
            ttft_ms=_ttft_summary(single["ttft_ms"]),
            decode_tokens_per_s=single["decode_tokens_per_s"],
            e2e_tokens_per_s=sum(len(t) for t in full["single_tokens"])
            / single["wall_s"]))
    return report


# -- phase 10: BERT pretraining with the published recipe ---------------------

#: the recipe (Devlin et al. 2018, appendix A.2; the clip of Paddle's BERT
#: optimization.py), its schedule cut to the run: warmup 10,000 and decay
#: to step 1,000,000 become RECIPE_WARMUP and RECIPE_DECAY, so that one run
#: crosses both branches
RECIPE_PEAK_LR, RECIPE_WARMUP, RECIPE_DECAY = 1e-4, 4, 12
RECIPE_WEIGHT_DECAY, RECIPE_CLIP_NORM = 0.01, 1.0
RECIPE_STEPS, RECIPE_CKPT_EVERY, RECIPE_KEEP = 12, 4, 2
RECIPE_PREEMPT, RECIPE_NAN = 6, 2
#: the recipe's fetched LR against its closed form: units in the last place
RECIPE_LR_ULPS = 2
#: the eval clone (fusion pass) against the unfused clone: the JAX
#: package's _PARITY_TOL
RECIPE_EVAL_TOL = 2e-3
#: timed recipe steps (no checkpoint in them), beside phase 5's
RECIPE_TIMED = 10


def build_recipe(cfg):
    """build_bert_pretrain(cfg, TRAIN_SEQ), its eval clone taken before
    minimize, the warmup-then-decay LR and AdamW with a global-norm clip,
    in fresh programs under unique_name.guard (a rebuild gives the same
    names) -> (main, startup, test, loss, lr, scale name)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import build_bert_pretrain

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED + 21
    main.random_seed = SEED + 22
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = build_bert_pretrain(cfg, seq_len=TRAIN_SEQ)
        test = main.clone(for_test=True)
        lr = pt.layers.linear_lr_warmup(
            pt.layers.polynomial_decay(RECIPE_PEAK_LR,
                                       decay_steps=RECIPE_DECAY,
                                       end_learning_rate=0.0),
            warmup_steps=RECIPE_WARMUP, start_lr=0.0, end_lr=RECIPE_PEAK_LR)
        pt.optimizer.AdamW(
            lr, weight_decay=RECIPE_WEIGHT_DECAY,
            grad_clip=pt.clip.GradientClipByGlobalNorm(RECIPE_CLIP_NORM)
        ).minimize(loss)
    # the global-norm clip's scale multiplies every gradient
    scales = {op.inputs["Y"][0] for op in main.global_block().ops
              if op.type == "elementwise_mul"
              and op.inputs["X"][0].endswith("@GRAD")}
    if len(scales) != 1:
        raise AssertionError(f"clip scale variables {scales}")
    return main, startup, test, loss, lr, scales.pop()


def recipe_lr(step):
    """The schedule's closed form in numpy float32, operation by
    operation as the program computes it (each result rounded)."""
    f = np.float32
    s = f(step)
    # linear_lr_warmup: start + (end - start) * (step / warmup), each a
    # scale op (x * a + b)
    ramp = f(f(s * f(1.0 / RECIPE_WARMUP)) * f(RECIPE_PEAK_LR)) + f(0.0)
    # polynomial_decay: (1 - min(step, decay) / decay) ** 1 (a division
    # of two variables), times the peak rate, plus the end rate 0
    frac = f(f(f(min(s, f(RECIPE_DECAY)) / f(RECIPE_DECAY)) * f(-1.0))
             + f(1.0))
    decay = f(f(frac * f(RECIPE_PEAK_LR)) + f(0.0))
    return ramp if s < f(RECIPE_WARMUP) else decay


def recipe_feed(vocab, seed=SEED + 100):
    """feed_fn(step): a pretraining batch per step from a numpy seed (the
    resumability contract: a function of the step index), host arrays —
    the fault plan's NaN poisoning works on them."""
    def feed(step):
        rng = np.random.RandomState(seed + step)
        B, T = TRAIN_BATCH, TRAIN_SEQ
        src = rng.randint(0, vocab, (B, T)).astype(np.int64)
        mask = np.ones((B, T), np.float32)
        for b in range(B // 4):
            mask[b, rng.randint(T // 2, T):] = 0.0
        labels = np.full((B, T, 1), -1, np.int64)
        pick = (rng.rand(B, T) < 0.15) & (mask > 0)
        labels[pick] = src[pick][:, None]
        return {"src_ids": src, "input_mask": mask, "masked_labels": labels}
    return feed


class _Fetching:
    """An executor that also fetches ``extra`` on every run and keeps
    them (the train loop fetches the loss only)."""

    def __init__(self, exe, extra):
        self.exe, self.extra, self.rows = exe, list(extra), []

    def run(self, program, feed=None, fetch_list=None, scope=None):
        fetch_list = list(fetch_list or [])
        out = self.exe.run(program, feed=feed, scope=scope,
                           fetch_list=fetch_list + self.extra)
        self.rows.append([np.asarray(v) for v in out[len(fetch_list):]])
        return out[:len(fetch_list)]


class _Monitor:
    """The loop's monitor hooks, recorded: the save's time on the step
    path, NaN skips, each step's wall time."""

    def __init__(self):
        self.save_s, self.skips, self.step_s = [], [], {}

    def on_checkpoint(self, step, seconds):
        self.save_s.append(seconds)

    def on_nan_skip(self, step):
        self.skips.append(step)

    def on_step(self, step, loss=None, wall_s=None, examples=None):
        self.step_s[step] = wall_s


def _timed_manager(root):
    """A CheckpointManager (keep RECIPE_KEEP) that times each version's
    write: the background writer's work."""
    from paddle_tpu_torch.resilience import CheckpointManager

    class TimedCheckpoints(CheckpointManager):
        def __init__(self, root):
            super().__init__(root, keep=RECIPE_KEEP)
            self.write_s = []

        def _write_version(self, *a, **kw):
            t0 = time.perf_counter()
            final = super()._write_version(*a, **kw)
            self.write_s.append(time.perf_counter() - t0)
            return final

    return TimedCheckpoints(root)


def _disk_bytes(root):
    total = 0
    for dirpath, _, files in os.walk(root):
        for f in files:
            try:
                total += Path(dirpath, f).stat().st_size
            except OSError:       # a temp file renamed or removed meanwhile
                pass
    return total


class _DiskPeak:
    """Samples a directory's bytes every 20 ms on a thread, keeps the
    most."""

    def __init__(self, root):
        self.root, self.peak = root, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, _disk_bytes(self.root))
            self._stop.wait(0.02)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _disk_bytes(self.root))
        return False


def _manifest_crcs(root, step):
    doc = json.loads((Path(root) / f"ckpt-{step:08d}" /
                      "manifest.json").read_text())
    return {n: a["crc32"] for n, a in doc["arrays"].items()}


def _bits(t):
    """A tensor's bytes as an integer tensor (NaN-safe bit equality)."""
    import torch

    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def recipe_phase(device, cfg, phase5_step_ms=float("nan")):
    """Phase 10: build_recipe at cfg, batch TRAIN_BATCH x TRAIN_SEQ,
    through the default (fused) program and resilience.ResilientLoop:
    (a) RECIPE_STEPS uninterrupted steps with checkpoints, (b) preempted at
    RECIPE_PREEMPT and resumed by a new executor, scope and program from
    the last checkpoint, (c) a NaN step rolled back, (d) the eval clone
    and its inference model; then (e) RECIPE_TIMED timed steps, beside
    ``phase5_step_ms``.  The checkpoint directories live in a temporary
    directory removed in a finally.  On the CPU (a rehearsal) the launch
    gates expect none."""
    import shutil
    import tempfile

    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.observability import flightrec
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.resilience import (CheckpointManager, FaultPlan,
                                             Preempted, ResilientLoop)

    on_card = device.type == "cuda"
    place = pt.CUDAPlace(0) if on_card else pt.CPUPlace()
    L = cfg.num_layers
    feed_fn = recipe_feed(cfg.vocab_size)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_recipe_"))
    report = {}
    try:
        exe = pt.Executor(place)
        main, startup, test, loss, lr, scale = build_recipe(cfg)
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        persist = pt.io.persistable_names(main)
        # the initial weights, by reference: no op writes a scope tensor
        # in place, so later scopes can start from the same tensors
        init = {n: scope.find_var(n) for n in persist}
        n_bytes = sum(t.numel() * t.element_size() for t in init.values())

        # (a) uninterrupted
        root_a = str(work / "a")
        mgr_a = _timed_manager(root_a)
        mon = _Monitor()
        fetching = _Fetching(exe, [lr, scale])
        loop = ResilientLoop(fetching, main, loss=loss, manager=mgr_a,
                             checkpoint_every=RECIPE_CKPT_EVERY,
                             nan_guard=True, scope=scope, monitor=mon)
        with _PlainCalls() as plain, _DiskPeak(root_a) as disk_a:
            _cuda.reset_launches()
            t0 = time.perf_counter()
            losses_a = loop.run(feed_fn, RECIPE_STEPS)
            sync(device)
            wall_a = time.perf_counter() - t0
            launches = {k: n for k, n in _cuda.LAUNCHES.items() if n}
        lrs = [float(r[0]) for r in fetching.rows]
        scales = [float(r[1]) for r in fetching.rows]
        want_lr = [recipe_lr(s) for s in range(RECIPE_STEPS)]
        lr_ulps = [float(abs(np.float32(g) - w)
                         / np.spacing(np.abs(w)))
                   for g, w in zip(lrs, want_lr)]
        want = {k: L * RECIPE_STEPS for k in FUSED_STEP_KERNELS} \
            if on_card else {}
        crcs_a = _manifest_crcs(root_a, RECIPE_STEPS)
        version_bytes = _disk_bytes(str(Path(root_a) /
                                        f"ckpt-{RECIPE_STEPS:08d}"))
        step_walls = [mon.step_s[s] for s in range(RECIPE_STEPS)
                      if (s + 1) % RECIPE_CKPT_EVERY]
        log(f"  (a) {RECIPE_STEPS} steps in a ResilientLoop (checkpoint "
            f"every {RECIPE_CKPT_EVERY}, keep {RECIPE_KEEP}, NaN guard): "
            f"{wall_a:.2f} s; losses " + " ".join(f"{x:.4f}" for x in
                                                   losses_a)
            + "; LR " + " ".join(f"{x:.4e}" for x in lrs)
            + f" (ulps from the closed form {max(lr_ulps):g}); clip scale "
            + " ".join(f"{x:.4f}" for x in scales)
            + f"; launches {launches} (want {want}); plain kernel versions "
            f"called {plain.calls}; libraries loaded after the first step "
            f"{exe.compiles_after_first_step}; saves on the step path "
            + " ".join(f"{s * 1e3:.1f}" for s in mon.save_s)
            + " ms, writes " + " ".join(f"{s * 1e3:.1f}"
                                        for s in mgr_a.write_s)
            + f" ms, {version_bytes} bytes a version ({n_bytes} in the "
            f"scope), disk peak {disk_a.peak} bytes")
        if len(losses_a) != RECIPE_STEPS or not np.all(np.isfinite(
                losses_a)):
            raise AssertionError(f"recipe losses {losses_a}")
        if max(lr_ulps) > RECIPE_LR_ULPS:
            raise AssertionError(f"LR {lrs} against the closed form "
                                 f"{want_lr}: {lr_ulps} ulps")
        if not all(0.0 < s <= 1.0 for s in scales):
            raise AssertionError(f"global-norm clip scales {scales}")
        if launches != want or launches.get(fa.FWD):
            raise AssertionError(f"recipe launches {launches}, expected "
                                 f"{want}")
        if on_card and plain.calls:
            raise AssertionError("a plain kernel version ran on the card")
        if exe.compiles_after_first_step:
            raise AssertionError("a kernel library was loaded after the "
                                 "first step")
        report.update(
            losses=losses_a, lr=lrs, lr_closed_form=[float(w) for w in
                                                     want_lr],
            lr_max_ulps=max(lr_ulps), clip_scale=scales, launches=launches,
            wall_s=wall_a, parameters_and_state_bytes=n_bytes,
            save_ms=[s * 1e3 for s in mon.save_s],
            write_ms=[s * 1e3 for s in mgr_a.write_s],
            version_bytes=version_bytes,
            loop_step_ms_without_save=[w * 1e3 for w in step_walls])
        trained = {n: scope.find_var(n) for n in persist}
        del loop, fetching, scope
        shutil.rmtree(root_a)

        # (b) preempted at RECIPE_PREEMPT, resumed by a new executor,
        # scope and program
        root_b = str(work / "b")
        scope_b = pt.Scope()
        for n, t in init.items():
            scope_b.set_var(n, t)
        main._rng_counter = 0          # the same seeds as run (a)
        mgr_b = _timed_manager(root_b)
        loop = ResilientLoop(exe, main, loss=loss, manager=mgr_b,
                             checkpoint_every=RECIPE_CKPT_EVERY,
                             scope=scope_b)
        with _DiskPeak(root_b) as disk_b:
            with FaultPlan(preempt_steps={RECIPE_PREEMPT}).armed():
                try:
                    loop.run(feed_fn, RECIPE_STEPS)
                except Preempted:
                    pass
                else:
                    raise AssertionError("the preemption did not fire")
            latest = mgr_b.latest_step()
            del loop, scope_b
            exe2 = pt.Executor(place)
            main2, _, _, loss2, _, _ = build_recipe(cfg)
            scope2 = pt.Scope()
            mgr2 = _timed_manager(root_b)
            t0 = time.perf_counter()
            manifest = mgr2.restore(program=main2, scope=scope2)
            restore_s = time.perf_counter() - t0
            loop2 = ResilientLoop(exe2, main2, loss=loss2, manager=mgr2,
                                  checkpoint_every=RECIPE_CKPT_EVERY,
                                  scope=scope2)
            losses_b = loop2.run(feed_fn, RECIPE_STEPS)
        crcs_b = _manifest_crcs(root_b, RECIPE_STEPS)
        resumed = losses_a[int(manifest["step"]):]
        same_losses = [np.float32(a).tobytes() == np.float32(b).tobytes()
                       for a, b in zip(resumed, losses_b)]
        diff_crcs = sorted(n for n in crcs_a if crcs_a[n] != crcs_b.get(n))
        log(f"  (b) preempted before step {RECIPE_PREEMPT} (latest "
            f"checkpoint {latest}); a new executor, scope and program "
            f"restored step {manifest['step']} in {restore_s * 1e3:.1f} ms "
            f"and ran on (start {loop2.start_step}): losses "
            + " ".join(f"{x:.4f}" for x in losses_b)
            + f"; bit-equal to (a): {sum(same_losses)}/{len(same_losses)}; "
            f"final manifest checksums differing from (a): {diff_crcs}; "
            f"disk peak {disk_b.peak} bytes")
        want_latest = RECIPE_PREEMPT // RECIPE_CKPT_EVERY * RECIPE_CKPT_EVERY
        if latest != want_latest or loop2.start_step != latest:
            raise AssertionError(f"resume: latest {latest}, start "
                                 f"{loop2.start_step}")
        if len(losses_b) != len(resumed) or not all(same_losses):
            raise AssertionError(f"resumed losses {losses_b} differ from "
                                 f"(a)'s {resumed}")
        if set(crcs_a) != set(crcs_b) or diff_crcs:
            raise AssertionError(f"final checkpoints differ: {diff_crcs}")
        report.update(restore_ms=restore_s * 1e3, resumed_from=latest,
                      resumed_losses=losses_b,
                      disk_peak_bytes=max(disk_a.peak, disk_b.peak))
        del loop2, scope2, exe2, main2
        shutil.rmtree(root_b)

        # (c) a NaN step rolled back: the state step RECIPE_NAN + 1
        # starts from must be, bit for bit, the one step RECIPE_NAN did
        scope_c = pt.Scope()
        for n, t in init.items():
            scope_c.set_var(n, t)
        main._rng_counter = 0
        mon_c = _Monitor()
        loop = ResilientLoop(exe, main, loss=loss, scope=scope_c,
                             monitor=mon_c)
        before, kept = {}, {}

        def feed_c(step):
            if step == RECIPE_NAN:
                before.update({n: _bits(scope_c.find_var(n)).clone()
                               for n in persist})
            elif step == RECIPE_NAN + 1:
                kept.update({n: torch.equal(_bits(scope_c.find_var(n)),
                                            before[n]) for n in persist})
            return feed_fn(step)

        triggers = []

        def listener(reason, detail, fields):
            triggers.append(reason)

        was_armed = flightrec.armed()
        flightrec.arm()
        flightrec.add_trigger_listener(listener)
        try:
            with FaultPlan(nan_loss_steps={RECIPE_NAN}).armed():
                losses_c = loop.run(feed_c, RECIPE_NAN + 2)
        finally:
            flightrec.remove_trigger_listener(listener)
            if not was_armed:
                flightrec.disarm()
        changed = sorted(n for n, same in kept.items() if not same)
        log(f"  (c) NaN loss injected at step {RECIPE_NAN}: skipped "
            f"{loop.skipped_steps}, losses " + " ".join(
                f"{x:.4f}" for x in losses_c)
            + f"; persistables after the step bit-equal to before it: "
            f"{len(kept) - len(changed)}/{len(persist)}; flight-recorder "
            f"triggers {triggers}")
        if loop.skipped_steps != [RECIPE_NAN] or mon_c.skips != [RECIPE_NAN]:
            raise AssertionError(f"NaN skips {loop.skipped_steps}")
        if len(kept) != len(persist) or changed:
            raise AssertionError(f"persistables changed by the rolled-back "
                                 f"step: {changed[:5]}")
        if len(losses_c) != RECIPE_NAN + 1 or not np.all(np.isfinite(
                losses_c)):
            raise AssertionError(f"losses around the NaN step {losses_c}")
        if triggers != ["nan_skip"]:
            raise AssertionError(f"flight-recorder triggers {triggers}")
        report.update(nan_skipped=loop.skipped_steps, nan_losses=losses_c,
                      nan_triggers=triggers)
        del loop, scope_c, before

        # (d) the eval clone and its inference model, on (a)'s weights
        scope_d = pt.Scope()
        for n, t in trained.items():
            scope_d.set_var(n, t)
        held_out = recipe_feed(cfg.vocab_size, seed=SEED + 999)(0)
        with _PlainCalls() as plain:
            _cuda.reset_launches()
            (e1,) = exe.run(test, feed=held_out, fetch_list=[loss],
                            scope=scope_d)
            launches_eval = {k: n for k, n in _cuda.LAUNCHES.items() if n}
        (e2,) = exe.run(test, feed=held_out, fetch_list=[loss], scope=scope_d)
        bs = pt.BuildStrategy()
        bs.fuse_epilogues = False
        (eu,) = exe.run(pt.CompiledProgram(test, build_strategy=bs),
                        feed=held_out, fetch_list=[loss], scope=scope_d)
        infer_dir = str(work / "inference")
        with pt.scope_guard(scope_d):
            pt.io.save_inference_model(infer_dir, list(held_out), [loss],
                                       exe, main_program=test)
        with pt.scope_guard(pt.Scope()):
            prog, _, fetch = pt.io.load_inference_model(infer_dir, exe)
            (ei,) = exe.run(prog, feed=held_out, fetch_list=fetch)
        want_eval = {k: L for k in ("flash_fwd_qkv", "gemm_epilogue",
                                    "ffn_chain")} if on_card else {}
        log(f"  (d) eval clone on a held-out batch: {float(e1):.6f}, again "
            f"{float(e2):.6f}; unfused clone {float(eu):.6f} (|d| "
            f"{abs(float(e1) - float(eu)):.3e}, tol {RECIPE_EVAL_TOL:g}); "
            f"the inference model loaded into a fresh scope "
            f"{float(ei):.6f}; launches {launches_eval} (want {want_eval}); "
            f"plain kernel versions called {plain.calls}")
        if e1.tobytes() != e2.tobytes():
            raise AssertionError("the eval clone is not deterministic")
        if launches_eval != want_eval:
            raise AssertionError(f"eval launches {launches_eval}, expected "
                                 f"{want_eval}")
        if on_card and plain.calls:
            raise AssertionError("a plain kernel version ran on the card")
        if not abs(float(e1) - float(eu)) < RECIPE_EVAL_TOL:
            raise AssertionError("the eval clone and the unfused clone "
                                 "disagree")
        if ei.tobytes() != e1.tobytes():
            raise AssertionError("the inference model's loss differs from "
                                 "the eval clone's")
        report.update(eval_loss=float(e1), eval_unfused_loss=float(eu),
                      inference_model_loss=float(ei),
                      eval_launches=launches_eval)
        del scope_d

        # (e) RECIPE_TIMED steps without checkpoints, as phase 5 times its
        # steps
        scope_t = pt.Scope()
        for n, t in trained.items():
            scope_t.set_var(n, t)
        feed = {k: torch.from_numpy(v).to(device)
                for k, v in feed_fn(0).items()}
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope_t)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(RECIPE_TIMED):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope_t,
                    return_numpy=False)
        sync(device)
        step_ms = (time.perf_counter() - t0) / RECIPE_TIMED * 1e3
        log(f"  (e) {RECIPE_TIMED} recipe steps: {step_ms:.3f} ms/step "
            f"(phase 5's Adam step {phase5_step_ms:.3f} ms/step)")
        report.update(step_ms=step_ms, phase5_step_ms=phase5_step_ms)
        del scope_t, trained, init
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return report


# -- phase 11: control flow, the LM's graph forms and the Predictor ----------

#: phase 11a: timed runs of the greedy decoder after its warm run
GREEDY_RUNS = 3
#: phase 11a: steps of the profiled decoder: a prompt of MAX_SEQ_LEN -
#: GREEDY_PROFILE_NEW tokens, so each step runs the LM over the full
#: [N_PROMPTS, MAX_SEQ_LEN] buffer, as the timed decoder's steps do
GREEDY_PROFILE_NEW = 8
#: phase 11c: the fused build_lm_logits, the unfused lowering and the
#: plain recompute (lm_forward), pairwise, per position: the relative
#: error of a position's logit row (norm of the difference over the norm
#: of the reference).  Every position within LOGITS_ROW_RTOL at depths
#: up to REFERENCE_LAYERS.  Deeper, this init is chaotic (float32
#: rounding grows about tenfold a layer: on an H100 the median was
#: 5.7e-2 at depth 12 and 1.9e-6 at depth 2), so depths
#: LOGITS_DEPTHS and the full depth are reported, not gated, as phase 3
#: reports full-depth token agreement
LOGITS_ROW_RTOL = 1e-3
LOGITS_DEPTHS = (1, 2, 4, 8)
#: phase 11d: the loops' first-step gradients, card against the port's
#: CPU path (relative norm error)
LOOP_GRAD_RTOL = 1e-5
#: phase 11d: SGD steps of the StaticRNN program on the card
LOOP_STEPS = 8


def lm_graph_program(graph_fn, *args):
    """(main, startup, out) of a models graph function under fresh
    programs and names: the "lm.*" parameters keep their names, so
    programs of any depth read one scope's weights."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED + 11
    main.random_seed = SEED + 12
    with pt.program_guard(main, startup), pt.unique_name.guard():
        out = graph_fn(*args)
    return main, startup, out


def _executor(device):
    import paddle_tpu_torch as pt

    return pt.Executor(pt.CUDAPlace(device.index or 0)
                       if device.type == "cuda" else pt.CPUPlace())


def _rows_rel(got, want):
    """Per-position relative error of logit rows [..., V]."""
    got = np.asarray(got, np.float64).reshape(-1, got.shape[-1])
    want = np.asarray(want, np.float64).reshape(-1, want.shape[-1])
    return (np.linalg.norm(got - want, axis=1)
            / np.maximum(np.linalg.norm(want, axis=1), 1e-30))


def _op_scope_profile(device, fn, programs, tag):
    """Run ``fn`` once under the profiler's device trace (written under
    OUT_DIR/phase11/<tag>) and say where its time went: host ms by
    program-op type (the lowering's ``type:first_output`` scopes; a
    block op's scope, which holds its sub-block's, is reported apart),
    device kernel ms merged over the wall (busy share), and the kernels
    that took the most."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.core.lowering import BLOCK_OPS, _op_scope_name

    names = {_op_scope_name(op): op.type for p in programs
             for blk in p.blocks for op in blk.ops}
    profiler.reset_profiler()
    profiler.start_profiler("All" if device.type == "cuda" else "CPU",
                            tracer_path=str(OUT_DIR / "phase11" / tag))
    try:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        profiler.stop_profiler(quiet=True)
    doc = profiler.load_device_trace()
    by_type, block_ms = collections.Counter(), 0.0
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("name") in names:
            kind = names[e["name"]]
            if kind in BLOCK_OPS:
                block_ms += e.get("dur", 0) / 1e3
            else:
                by_type[kind] += e.get("dur", 0) / 1e3
    kernels = sorted(profiler.trace_kernels(doc), key=lambda k: k[1])
    busy, end, by_kernel = 0.0, None, collections.Counter()
    for name, k0, k1 in kernels:
        by_kernel[name[:70]] += (k1 - k0) / 1e3
        if end is None or k0 > end:
            busy += k1 - k0
            end = k1
        elif k1 > end:
            busy += k1 - end
            end = k1
    out = dict(wall_ms=wall_ms, op_scopes_ms=sum(by_type.values()),
               block_op_scope_ms=block_ms,
               op_scopes_by_type_ms=dict(by_type.most_common(10)),
               kernels=len(kernels), device_busy_ms=busy / 1e3,
               device_busy_share=busy / 1e3 / wall_ms,
               top_kernels_ms=by_kernel.most_common(8),
               kineto_trace=_gzip(profiler.last_device_trace()))
    log(f"  profiled {tag}: {wall_ms:.3f} ms wall under the profiler; op "
        f"scopes {out['op_scopes_ms']:.3f} ms (" + ", ".join(
            f"{k} {v:.2f}" for k, v in by_type.most_common(6))
        + f"), block op scopes {block_ms:.3f} ms; {len(kernels)} kernels, "
        f"device busy {busy / 1e3:.3f} ms (share "
        f"{out['device_busy_share']:.4f}); top kernels: " + "; ".join(
            f"{n} {ms:.2f}" for n, ms in by_kernel.most_common(4)))
    return out


def _launch_gate(launches, want, what, on_card):
    """Every port kernel (the KERNELS line's and the dropout mask's)
    launched exactly ``want`` times (0 when not named); nothing on the
    CPU."""
    names = {k["name"] for k in KERNELS} | set(launches)
    got = {n: launches.get(n, 0) for n in names}
    expect = {n: (want.get(n, 0) if on_card else 0) for n in names}
    if got != expect:
        raise AssertionError(f"{what}: launches {dict(sorted(got.items()))}"
                             f", expected {dict(sorted(expect.items()))}")
    return {n: v for n, v in got.items() if v}


def greedy_decoder_phase(device, cfg, gen_cfg):
    """Phase 11a: the StaticRNN greedy decoder at full width and depth
    through Executor.run, then the same weights through the chunked
    engine, then depth 2.  Returns (report, state for 11b-c)."""
    import torch

    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.generation import GenerationEngine, SamplingParams
    from paddle_tpu_torch.models import (build_lm_greedy_infer,
                                         lm_params_from_numpy,
                                         lm_params_from_scope)
    import paddle_tpu_torch as pt

    on_card = device.type == "cuda"
    L = cfg.num_layers
    main, startup, out = lm_graph_program(
        build_lm_greedy_infer, cfg, N_PROMPTS, PROMPT_LEN, MAX_NEW)
    exe, scope = _executor(device), pt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    sync(device)
    startup_s = time.perf_counter() - t0
    prompt_list = make_prompts(np.random.RandomState(SEED + 1), N_PROMPTS,
                               PROMPT_LEN, cfg.vocab_size)
    prompts = np.asarray(prompt_list, np.int64)
    feed = {"prompt_ids": prompts}
    t0 = time.perf_counter()
    warm, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    warm_s = time.perf_counter() - t0
    loads = _cuda.library_loads()
    _cuda.reset_launches()
    walls, runs = [], []
    with _PlainCalls() as plain:
        for _ in range(GREEDY_RUNS):
            sync(device)
            t0 = time.perf_counter()
            ids, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
            walls.append(time.perf_counter() - t0)
            runs.append(ids)
    launches = dict(_cuda.LAUNCHES)
    loaded = _cuda.library_loads() - loads
    per_run = L * MAX_NEW
    got = _launch_gate(launches, {"flash_fwd_packed": per_run * GREEDY_RUNS},
                       "the greedy decoder", on_card)
    if on_card and plain.calls:
        raise AssertionError(f"the greedy decoder called plain kernel "
                             f"versions {plain.calls} times")
    if loaded:
        raise AssertionError(f"{loaded} kernel libraries loaded after the "
                             f"decoder's first run")
    tokens = warm.T                                   # [B, N]
    if tokens.shape != (N_PROMPTS, MAX_NEW) or not all(
            np.array_equal(r, warm) for r in runs):
        raise AssertionError("the decoder's runs differ from its first")
    if not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError("a decoder token is out of the vocabulary")
    graph_tps = N_PROMPTS * MAX_NEW / min(walls)

    # the same weights through the KV-cached chunked engine
    params = lm_params_from_numpy(lm_params_from_scope(cfg, scope), device)
    engine = GenerationEngine(cfg, params, gen_cfg, device=device)
    engine.warmup()
    greedy = SamplingParams(max_new_tokens=MAX_NEW)
    results, _, eng_wall = drive(engine, prompt_list, greedy, device)
    snap = engine.stats.snapshot()
    graph_results = [types.SimpleNamespace(tokens=t.tolist())
                     for t in tokens]
    match = matched_prefix(graph_results, results)
    engine_tps = N_PROMPTS * MAX_NEW / eng_wall
    log(f"  greedy decoder (StaticRNN, {L} layers, {N_PROMPTS}x{PROMPT_LEN}"
        f" prompts, {MAX_NEW} new): startup {startup_s:.2f} s, first run "
        f"{warm_s:.3f} s, timed {', '.join(f'{w:.3f}' for w in walls)} s "
        f"-> {graph_tps:.1f} tokens/s; launches per run "
        f"{ {k: v // GREEDY_RUNS for k, v in got.items()} } (want "
        f"flash_fwd_packed {per_run}); chunked engine on the same weights "
        f"{eng_wall:.3f} s -> {engine_tps:.1f} tokens/s (decode "
        f"{snap['decode_tokens_per_sec']} tokens/s), speedup over the "
        f"decoder {engine_tps / graph_tps:.2f}x; matched-prefix fraction "
        f"decoder vs engine {match:.4f} (full depth: reported, not gated)")
    del engine, params

    # depth 2: the same scope's layers 0 and 1, no startup
    cut_cfg = dataclasses.replace(cfg, num_layers=REFERENCE_LAYERS)
    main2, _, out2 = lm_graph_program(
        build_lm_greedy_infer, cut_cfg, N_PROMPTS, PROMPT_LEN, MAX_NEW)
    _cuda.reset_launches()
    ids2, = exe.run(main2, feed=feed, fetch_list=[out2], scope=scope)
    launches2 = _launch_gate(
        dict(_cuda.LAUNCHES),
        {"flash_fwd_packed": REFERENCE_LAYERS * MAX_NEW},
        "the depth-2 decoder", on_card)
    cut_params = lm_params_from_numpy(lm_params_from_scope(cut_cfg, scope),
                                      device)
    eng2 = GenerationEngine(cut_cfg, cut_params, gen_cfg, device=device)
    eng2.warmup()
    res2, _, _ = drive(eng2, prompt_list, greedy, device)
    graph2 = [types.SimpleNamespace(tokens=t.tolist()) for t in ids2.T]
    equal2 = [g.tokens == r.tokens for g, r in zip(graph2, res2)]
    gap, agree = recompute_gaps(cut_params, cut_cfg, prompt_list, graph2,
                                device)
    log(f"  depth {REFERENCE_LAYERS}: decoder tokens equal the chunked "
        f"engine's: {equal2}; worst logit gap to the plain recompute's "
        f"argmax {gap:.3e} (tol {GREEDY_LOGIT_TOL:g}), agreement {agree:.4f};"
        f" launches {launches2}")
    if not all(equal2):
        raise AssertionError("depth-2 decoder tokens differ from the "
                             "chunked engine's")
    if not gap <= GREEDY_LOGIT_TOL:
        raise AssertionError("a depth-2 decoder token is not the plain "
                             "recompute's argmax")
    del eng2, cut_params
    if on_card:
        torch.cuda.empty_cache()

    # where the decoder's time goes: fewer steps of the same width (each
    # step runs the LM over [N_PROMPTS, MAX_SEQ_LEN], as above)
    prompt_p = MAX_SEQ_LEN - GREEDY_PROFILE_NEW
    mainp, _, outp = lm_graph_program(
        build_lm_greedy_infer, cfg, N_PROMPTS, prompt_p, GREEDY_PROFILE_NEW)
    feed_p = {"prompt_ids": np.asarray(make_prompts(
        np.random.RandomState(SEED + 14), N_PROMPTS, prompt_p,
        cfg.vocab_size), np.int64)}
    exe.run(mainp, feed=feed_p, fetch_list=[outp], scope=scope)
    profile = _op_scope_profile(
        device, lambda: exe.run(mainp, feed=feed_p, fetch_list=[outp],
                                scope=scope),
        [mainp], f"greedy_{GREEDY_PROFILE_NEW}")
    profile["steps"] = GREEDY_PROFILE_NEW
    report = dict(
        layers=L, startup_s=startup_s, first_run_s=warm_s, run_s=walls,
        tokens_per_s=graph_tps, launches_per_run={
            k: v // GREEDY_RUNS for k, v in got.items()},
        library_loads_after_first=loaded,
        engine_wall_s=eng_wall, engine_tokens_per_s=engine_tps,
        engine_decode_tokens_per_s=snap["decode_tokens_per_sec"],
        speedup_engine_over_decoder=engine_tps / graph_tps,
        speedup_vs_while_op=(snap["decode_tokens_per_sec"] or 0.0)
        / graph_tps,
        matched_prefix_vs_engine=match,
        depth2=dict(tokens_equal_engine=equal2, worst_gap=gap,
                    agreement=agree, launches=launches2),
        profile=profile)
    state = dict(main=main, out=out, exe=exe, scope=scope, feed=feed,
                 prompts=prompts, tokens=tokens)
    return report, state


def predictor_phase(device, cfg, st, root):
    """Phase 11b: the decoder frozen with a batch-major output
    (transpose of its [N, B] tokens) by io.save_inference_model, served
    by inference.create_predictor (the card), then behind
    InferenceServer(PredictorBackend(pred)) to SERVE_CLIENTS threads."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import (InferenceServer, PredictorBackend,
                                          ServingConfig)

    main = st["main"]
    with pt.program_guard(main, pt.Program()), \
            pt.unique_name.guard("frozen_"):
        ids_bt = pt.layers.transpose(st["out"], [1, 0])     # [B, N]
    path = os.path.join(root, "greedy")
    t0 = time.perf_counter()
    with pt.scope_guard(st["scope"]):
        pt.io.save_inference_model(path, ["prompt_ids"], [ids_bt],
                                   st["exe"], main_program=main)
    save_s = time.perf_counter() - t0
    config = inference.Config(path)
    if device.type != "cuda":
        config.disable_gpu()
    t0 = time.perf_counter()
    pred = inference.create_predictor(config)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    first, = pred.run([st["prompts"]])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    direct, = pred.run([st["prompts"]])
    direct_s = time.perf_counter() - t0
    if not (np.array_equal(first, st["tokens"])
            and np.array_equal(direct, st["tokens"])):
        raise AssertionError("the Predictor's tokens differ from the "
                             "decoder's Executor run")
    backend = PredictorBackend(pred)
    server = InferenceServer(backend, ServingConfig(
        batch_buckets=(N_PROMPTS,), max_batch_wait_ms=SERVE_WAIT_MS,
        max_queue_size=64)).start()
    per = N_PROMPTS // SERVE_CLIENTS
    answers, errors, lat = [None] * SERVE_CLIENTS, [], [None] * SERVE_CLIENTS
    try:
        warm = server.warmup()

        def client(i):
            try:
                t = time.perf_counter()
                answers[i], = server.infer(
                    {"prompt_ids": st["prompts"][i * per:(i + 1) * per]},
                    timeout_ms=600_000)
                lat[i] = (time.perf_counter() - t) * 1e3
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"server clients failed: {errors}")
        stats = server.stats()
    finally:
        server.close()
    same = [np.array_equal(a, direct[i * per:(i + 1) * per])
            for i, a in enumerate(answers)]
    log(f"  Predictor: saved in {save_s:.2f} s, loaded in {load_s:.2f} s, "
        f"first run {first_s:.3f} s, next {direct_s:.3f} s, tokens bit-"
        f"equal to the decoder's; server ({SERVE_CLIENTS} clients x {per} "
        f"prompts, bucket {N_PROMPTS}): {stats['batches']} batches, "
        f"answers equal to the Predictor's rows {same}, round trips "
        + ", ".join(f"{x:.1f}" for x in lat) + f" ms; compile_count "
        f"{backend.compile_count()} (warmup {warm}), "
        f"compiles_after_warmup {stats['compiles_after_warmup']}")
    if not all(same):
        raise AssertionError("served answers differ from the Predictor's")
    if stats["compiles_after_warmup"] != 0 or backend.compile_count() != warm:
        raise AssertionError("the Predictor's program lowered after warmup")
    return dict(save_s=save_s, load_s=load_s, first_run_s=first_s,
                run_s=direct_s, tokens_equal=True, served_equal=same,
                batches=stats["batches"], round_trip_ms=lat,
                latency=stats["latency"], compile_count=warm,
                compiles_after_warmup=stats["compiles_after_warmup"])


def logits_phase(device, cfg, st, root):
    """Phase 11c: build_lm_logits at [N_PROMPTS, MAX_SEQ_LEN] on the
    decoder's weights, frozen and run by a Predictor (the fusion pass on
    by default) on the decoder's final buffers (prompt + tokens): the
    plan's groups, #9/#10/#11 once per layer and nothing else; the
    unfused lowering's #3 once per layer; then fused, unfused and plain
    recompute (lm_forward) pairwise, per position, at the full depth and
    at LOGITS_DEPTHS (the same weights' first layers): gated up to
    REFERENCE_LAYERS, reported deeper (LOGITS_ROW_RTOL)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda, inference
    from paddle_tpu_torch.models import (build_lm_logits, lm_forward,
                                         lm_params_from_numpy,
                                         lm_params_from_scope)

    on_card = device.type == "cuda"
    L = cfg.num_layers
    T = MAX_SEQ_LEN
    buf = np.concatenate([st["prompts"], st["tokens"]], axis=1)   # [B, T]

    def logits_graph(c):
        src = pt.data("src_ids", [N_PROMPTS, T], "int64")
        return build_lm_logits(src, c)

    main, _, out = lm_graph_program(logits_graph, cfg)
    path = os.path.join(root, "logits")
    with pt.scope_guard(st["scope"]):
        pt.io.save_inference_model(path, ["src_ids"], [out], st["exe"],
                                   main_program=main)
    config = inference.Config(path)
    if not on_card:
        config.disable_gpu()
    pred = inference.create_predictor(config)
    pred.run([buf])
    loads = _cuda.library_loads()
    _cuda.reset_launches()
    with _PlainCalls() as plain:
        fused, = pred.run([buf])
    launches = _launch_gate(
        dict(_cuda.LAUNCHES), {"flash_fwd_qkv": L, "gemm_epilogue": L,
                               "ffn_chain": L}, "the fused logits", on_card)
    if on_card and plain.calls:
        raise AssertionError("the fused logits called plain kernel versions")
    if _cuda.library_loads() != loads:
        raise AssertionError("a kernel library loaded after the first run")
    plans = [lw.fusion_plan for lw in pred._program._exec_cache.values()]
    kinds = collections.Counter(g.kind for g in plans[0].groups)
    want_kinds = {"attn": L, "gemm": L, "ffn_chain": L}
    if len(plans) != 1 or dict(kinds) != want_kinds:
        raise AssertionError(f"plan groups {dict(kinds)}, the JAX planner's "
                             f"{want_kinds}")
    profile = _op_scope_profile(device, lambda: pred.run([buf]),
                                [pred._program], "predictor_logits")

    bs = pt.BuildStrategy()
    bs.fuse_epilogues = False
    _cuda.reset_launches()
    unfused, = pred._exe.run(
        pt.CompiledProgram(pred._program, build_strategy=bs),
        feed={"src_ids": buf}, fetch_list=pred.get_output_names(),
        scope=pred._scope)
    unfused_launches = _launch_gate(
        dict(_cuda.LAUNCHES), {"flash_fwd_packed": L},
        "the unfused logits", on_card)
    if not (np.isfinite(fused).all() and fused.shape == (
            N_PROMPTS, T, cfg.vocab_size)):
        raise AssertionError("the fused logits are not finite [B, T, V]")
    tokens = torch.from_numpy(buf).to(device)

    def plain_logits(c):
        params = lm_params_from_numpy(lm_params_from_scope(c, st["scope"]),
                                      device)
        with torch.no_grad():
            return lm_forward(params, c, tokens).cpu().numpy()

    def errors(f, u, p):
        out = {}
        for pair, (a, b) in (("fused_vs_unfused", (f, u)),
                             ("fused_vs_plain", (f, p)),
                             ("unfused_vs_plain", (u, p))):
            rel = _rows_rel(a, b)
            out[pair] = dict(median=float(np.median(rel)),
                             max=float(rel.max()),
                             share_within=float(np.mean(
                                 rel <= LOGITS_ROW_RTOL)))
        return out

    by_depth = {L: errors(fused, unfused, plain_logits(cfg))}
    for depth in LOGITS_DEPTHS:
        if depth >= L:
            continue
        cut_cfg = dataclasses.replace(cfg, num_layers=depth)
        cut, _, cut_out = lm_graph_program(logits_graph, cut_cfg)
        cut = cut.clone(for_test=True)
        f, = st["exe"].run(cut, feed={"src_ids": buf},
                           fetch_list=[cut_out.name], scope=st["scope"])
        u, = st["exe"].run(pt.CompiledProgram(cut, build_strategy=bs),
                           feed={"src_ids": buf}, fetch_list=[cut_out.name],
                           scope=st["scope"])
        by_depth[depth] = errors(f, u, plain_logits(cut_cfg))
    for depth in sorted(by_depth):
        e = by_depth[depth]
        log(f"  logits at depth {depth}: per-position relative error, "
            "median / max: " + "; ".join(
                f"{k} {v['median']:.3e} / {v['max']:.3e}"
                for k, v in e.items())
            + (f" (gate: every position within {LOGITS_ROW_RTOL:g})"
               if depth <= REFERENCE_LAYERS else " (reported)"))
    log(f"  build_lm_logits through the Predictor ([{N_PROMPTS}, {T}], "
        f"fusion on): plan {dict(kinds)}; launches {launches}; unfused "
        f"lowering {unfused_launches}")
    bad = [(d, k) for d, e in by_depth.items() if d <= REFERENCE_LAYERS
           for k, v in e.items() if v["max"] > LOGITS_ROW_RTOL]
    if bad:
        raise AssertionError(f"the fused, unfused and plain logits "
                             f"disagree at {bad}")
    return dict(plan_groups=dict(kinds), launches=launches,
                unfused_launches=unfused_launches,
                rel_err_by_depth={str(d): e for d, e in
                                  sorted(by_depth.items())},
                profile=profile)


def _loop_programs():
    """Phase 11d's programs, tests/test_torch_control_flow.py's: an fc in
    a StaticRNN trained by SGD, and a bounded While's doubling with its
    gradient.  {name: (main, startup, fetch names, feed)}."""
    import paddle_tpu_torch as pt

    L = pt.layers
    progs = {}
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED + 13
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.data("x", shape=[4, 2, 3], dtype="float32")
        h0 = L.fill_constant([2, 6], "float32", 0.0)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(init=h0)
            nh = L.fc(L.concat([x_t, h], axis=1), size=6, act="tanh")
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        loss = L.mean(rnn())
        _, pg = pt.optimizer.SGD(learning_rate=0.5).minimize(loss)
    progs["static_rnn_trains"] = (main, startup, [loss.name] + [
        g.name for _, g in pg], {"x": np.random.RandomState(1).rand(
            4, 2, 3).astype(np.float32)})
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.data("x", shape=[2], dtype="float32", stop_gradient=False)
        nv = pt.data("n", shape=[1], dtype="int64")
        s = L.assign(x)
        i = L.fill_constant([1], "int64", 0)
        c = L.less_than(i, nv)
        loop = L.While(c, max_iters=5)
        with loop.block():
            L.assign(s * 2.0, s)
            L.increment(i)
            L.less_than(i, nv, cond=c)
        (gx,) = pt.gradients(L.reduce_sum(s), [x])
    progs["while_max_iters"] = (main, startup, [s.name, gx.name], {
        "x": np.array([1.0, 2.0], np.float32), "n": np.array([3], np.int64)})
    return progs


def loop_backward_phase(device):
    """Phase 11d: the loops' backward on the card against the port's CPU
    path from the same weights: every first-step gradient within
    LOOP_GRAD_RTOL, finite and falling losses over LOOP_STEPS SGD steps,
    no port kernel launched."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda

    out = {}
    for name, (main, startup, fetch, feed) in _loop_programs().items():
        cpu_exe, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        cpu_exe.run(startup, scope=cpu_scope)
        weights = {v.name: cpu_scope.find_var(v.name).numpy().copy()
                   for v in main.list_vars() if v.persistable}
        exe, scope = _executor(device), pt.Scope()
        pt.io.load_params(scope, weights, device, program=main)
        want = cpu_exe.run(main, feed=feed, fetch_list=fetch,
                           scope=cpu_scope)
        _cuda.reset_launches()
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses = [float(np.asarray(got[0]).ravel()[0])]
        if name == "static_rnn_trains":
            for _ in range(LOOP_STEPS - 1):
                losses.append(float(exe.run(main, feed=feed,
                                            fetch_list=fetch[:1],
                                            scope=scope)[0]))
        launched = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        grads = {n: float(np.linalg.norm(g - w) / max(np.linalg.norm(w),
                                                      1e-30))
                 for n, g, w in zip(fetch, got, want) if n.endswith("@GRAD")}
        log(f"  {name} on the card: first output(s) "
            + ", ".join(f"{v:.6f}" for v in losses)
            + "; first-step gradients vs the CPU path (relative norm): "
            + ", ".join(f"{n} {e:.2e}" for n, e in grads.items())
            + f" (tol {LOOP_GRAD_RTOL:g}); launches {launched}")
        if not np.isfinite(losses).all() or not grads:
            raise AssertionError(f"{name}: non-finite loss or no gradient")
        if max(grads.values()) > LOOP_GRAD_RTOL:
            raise AssertionError(f"{name}: card gradients differ from the "
                                 f"CPU path's")
        if len(losses) > 1 and not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: the loss did not fall")
        if launched:
            raise AssertionError(f"{name} launched port kernels {launched}")
        out[name] = dict(losses=losses, grad_rel_err=grads)
    return out


def control_flow_phase(device, gen_cfg, cfg=None):
    """Phase 11: control flow and the LM's graph forms at
    BertConfig.base() width as a causal LM (``cfg``: by default phase
    3's initializer_range 0.6 and dropout 0; smaller for a rehearsal):
    11a the StaticRNN greedy decoder, 11b the Predictor and the server
    over it, 11c build_lm_logits through a Predictor, 11d backward
    through loops.  The frozen programs live in a temporary directory,
    removed in a finally."""
    import tempfile

    from paddle_tpu_torch.models import BertConfig

    cfg = cfg or dataclasses.replace(BertConfig.base(), initializer_range=0.6,
                                     hidden_dropout=0.0, attn_dropout=0.0)
    report, state = greedy_decoder_phase(device, cfg, gen_cfg)
    root = tempfile.mkdtemp(prefix="chip_smoke_p11_")
    try:
        report["predictor"] = predictor_phase(device, cfg, state, root)
        report["logits"] = logits_phase(device, cfg, state, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del state
    report["loops"] = loop_backward_phase(device)
    report["kernel_launches"] = dict(
        flash_fwd_packed=report["launches_per_run"].get(
            "flash_fwd_packed", 0),
        **{k: report["logits"]["launches"].get(k, 0)
           for k in ("flash_fwd_qkv", "gemm_epilogue", "ffn_chain")})
    return report


# -- phase 12: training from files -------------------------------------------

#: MultiSlot parts of phase 12: parts x instances, three slots of TRAIN_SEQ
DATASET_PARTS, DATASET_INSTANCES = 4, 256
#: steps per chunk of the dataset trainer (set_steps_per_dispatch)
DATASET_K = 8
#: parser threads of the threaded feed (train_from_dataset(thread=...))
DATASET_THREADS = 2
#: the three slots, in file order: (feed name, MultiSlot type)
DATASET_SLOTS = (("src_ids", "u"), ("input_mask", "f"),
                 ("masked_labels", "u"))
#: card against CPU for the repaired ops: float outputs within this
#: relative error (the same PyTorch op in two builds), the rest exact
QUEUE3_RTOL = 1e-6


def build_dataset_bert(P, models, cfg, seq_len, lr=TRAIN_LR, seed=SEED):
    """BERT pretraining over 2-D feeds a Dataset can fill: src_ids and
    masked_labels [None, seq_len] int64, input_mask [None, seq_len]
    float32; the labels are reshaped in the graph to [B, seq_len, 1]
    (build_bert_pretrain's 3-D labels feed cannot come from a Dataset,
    which pads a slot to its variable's trailing dim).  ``P`` is the
    package (paddle_tpu_torch, or the JAX package in the tests) and
    ``models`` its models module; both build the same program from
    public layers.  Returns (main, startup, loss, feed vars)."""
    main, startup = P.Program(), P.Program()
    startup.random_seed = seed + 21
    main.random_seed = seed + 22
    with P.program_guard(main, startup), P.unique_name.guard():
        src = P.data("src_ids", [None, seq_len], "int64")
        mask = P.data("input_mask", [None, seq_len], "float32")
        labels = P.data("masked_labels", [None, seq_len], "int64")
        seq_out = models.bert_encoder(src, mask, cfg)
        loss = models.bert_pretrain_loss(
            seq_out, P.layers.reshape(labels, [-1, seq_len, 1]), cfg)
        P.optimizer.Adam(lr).minimize(loss)
    return main, startup, loss, [src, mask, labels]


def write_bert_parts(root, parts, instances, seq_len, vocab, seed=SEED):
    """MultiSlot text parts for build_dataset_bert from a numpy seed: per
    line src_ids (u), input_mask (f; a quarter of the rows pad a tail)
    and masked_labels (u; the token at ~15% of the real positions, -1
    elsewhere), seq_len values each.  Returns the paths."""
    rng = np.random.RandomState(seed + 31)
    paths = []
    for p in range(parts):
        src = rng.randint(0, vocab, (instances, seq_len))
        mask = np.ones((instances, seq_len), np.float32)
        for b in range(0, instances, 4):
            mask[b, rng.randint(seq_len // 2, seq_len):] = 0.0
        labels = np.full((instances, seq_len), -1, np.int64)
        pick = (rng.rand(instances, seq_len) < 0.15) & (mask > 0)
        labels[pick] = src[pick]
        path = os.path.join(str(root), f"part-{p:05d}")
        with open(path, "w") as f:
            for i in range(instances):
                f.write(" ".join(
                    [str(seq_len), " ".join(map(str, src[i])),
                     str(seq_len), " ".join(f"{v:g}" for v in mask[i]),
                     str(seq_len), " ".join(map(str, labels[i]))]) + "\n")
        paths.append(path)
    return paths


def make_dataset(kind, feed_vars, files):
    """A ``kind`` dataset over ``files``: batch TRAIN_BATCH, DATASET_K
    steps a chunk."""
    import paddle_tpu_torch as pt

    ds = pt.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(TRAIN_BATCH)
    ds.set_use_var(feed_vars)
    ds.set_filelist(files)
    ds.set_steps_per_dispatch(DATASET_K)
    return ds


_NAN, _INF = float("nan"), float("inf")

#: Queue 3's repaired ops over the inputs of their CPU tests: (name, op,
#: inputs, attrs)
QUEUE3_CASES = (
    ("top_k_ties", "top_k", {"X": np.array([[0, 0, 0, 0], [1, 1, 2, 2]],
                                           np.float32)}, {"k": 2}),
    ("top_k_ties_int32", "top_k", {"X": np.array([[5, 5, 5, 1]], np.int32)},
     {"k": 3}),
    ("gather_wraps_and_fills", "gather", {
        "X": np.arange(8, dtype=np.float32).reshape(4, 2),
        "Index": np.array([-1, 5, -5, 0, -4], np.int32)}, {"axis": 0}),
    ("gather_fills_int32", "gather", {
        "X": np.arange(8, dtype=np.int32).reshape(4, 2),
        "Index": np.array([-1, 5, -5, 0], np.int32)}, {"axis": 0}),
    ("gather_fills_uint8", "gather", {
        "X": np.arange(8, dtype=np.uint8).reshape(4, 2),
        "Index": np.array([5, 1], np.int32)}, {"axis": 0}),
    ("lookup_table_wraps_and_fills", "lookup_table", {
        "W": np.arange(12, dtype=np.float32).reshape(4, 3),
        "Ids": np.array([[-1], [4], [0], [-5], [2]], np.int64)}, {}),
    ("sign_nan_and_signed_zero", "sign", {"X": np.array(
        [_NAN, -0.0, 0.0, -2.5, 3.0, -_INF], np.float32)}, {}),
    ("reduce_mean_int32", "reduce_mean", {"X": np.array([[1, 2]],
                                                        np.int32)},
     {"dim": [1], "keep_dim": False}),
    ("mean_bool", "mean", {"X": np.array([True, False, True])}, {}),
    ("cast_to_int32_saturates", "cast", {"X": np.array(
        [_NAN, _INF, -_INF, 1e10, -1e10, -1.0, 300.0, 2.7, -2.7],
        np.float32)}, {"out_dtype": "int32"}),
    ("cast_to_uint8_saturates", "cast", {"X": np.array(
        [_NAN, _INF, -_INF, 1e10, -1.0, 300.0, 255.5, 2.7], np.float32)},
     {"out_dtype": "uint8"}),
    ("cast_to_int32_at_its_ends", "cast", {"X": np.array(
        [2147483520.0, 2147483648.0, -2147483648.0, -2147483904.0],
        np.float32)}, {"out_dtype": "int32"}),
    ("cast_half_to_int32_saturates", "cast", {"X": np.array(
        [_NAN, _INF, -_INF, 65504.0, -65504.0, 2.5, -2.5], np.float16)},
     {"out_dtype": "int32"}),
    ("gelu_infinities", "gelu", {"X": np.array([_INF, -_INF, _NAN, 1.0,
                                                -1.0], np.float32)}, {}),
    ("gelu_tanh_infinities", "gelu", {"X": np.array([_INF, 1.0, -1.0],
                                                    np.float32)},
     {"approximate": True}),
)

#: (name, op, attrs, points): gradients at the kinks the repairs fixed,
#: and the floordiv whose gradient is zero
QUEUE3_KINKS = (
    ("clip", "clip", {"min": -1.5, "max": 2.0}, [-1.5, 2.0, 0.3, -3.0]),
    ("relu6", "relu6", {}, [0.0, 6.0, 3.0, 7.0, -1.0]),
    ("abs", "abs", {}, [0.0, -0.0, 1.5, -2.0]),
    ("leaky_relu", "leaky_relu", {}, [0.0, -1.0, 2.0]),
    ("hard_sigmoid", "hard_sigmoid", {}, [-2.5, 2.5, 0.0, 3.0]),
    ("hard_swish", "hard_swish", {}, [-3.0, 3.0, 0.0, -4.0, 4.0]),
)


def _queue3_compute(op, ins, attrs, device, grad=False):
    import torch

    from paddle_tpu_torch.core.registry import REGISTRY, OpContext

    ctx = OpContext(rng=None, is_test=False, attrs=attrs, device=device)
    tins = {s: [torch.from_numpy(np.array(v)).to(device)]
            for s, v in ins.items()}
    if not grad:
        with torch.no_grad():
            outs = REGISTRY.get(op).compute(ctx, tins, attrs)
        return [t.cpu() for slot in sorted(outs) for t in outs[slot]]
    x = tins["X"][0].requires_grad_()
    y = REGISTRY.get(op).compute(ctx, {"X": [x]}, attrs)["Out"][0]
    (g,) = torch.autograd.grad(y.sum(), x)
    return [g.cpu()]


def _same_result(got, want):
    """Card against CPU: the same dtype and shape, NaN where NaN, zeros'
    signs equal, floats within QUEUE3_RTOL, the rest exact.  Returns the
    largest relative error of the floats."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{got.dtype} {tuple(got.shape)} against "
                             f"{want.dtype} {tuple(want.shape)}")
    if not got.is_floating_point():
        if not torch.equal(got, want):
            raise AssertionError(f"{got.tolist()} != {want.tolist()}")
        return 0.0
    g, w = got.numpy(), want.numpy()
    if not (np.array_equal(np.isnan(g), np.isnan(w))
            and np.array_equal(np.isposinf(g), np.isposinf(w))
            and np.array_equal(np.isneginf(g), np.isneginf(w))
            and np.array_equal(np.signbit(g[w == 0]),
                               np.signbit(w[w == 0]))):
        raise AssertionError(f"{g.tolist()} != {w.tolist()}")
    fin = np.isfinite(w)
    err = np.abs(g[fin] - w[fin]) / np.maximum(np.abs(w[fin]), 1e-30)
    worst = float(err.max()) if err.size else 0.0
    if worst > QUEUE3_RTOL:
        raise AssertionError(f"relative error {worst:.3e}: {g.tolist()} "
                             f"against {w.tolist()}")
    return worst


def queue3_phase(device):
    """12a: each repaired op on ``device`` against the CPU, forward and
    at its kinks; out-of-range gather and lookup_table give their fill
    rows (a device-side assert would fail every later call)."""
    cpu = __import__("torch").device("cpu")
    out = {}
    for name, op, ins, attrs in QUEUE3_CASES:
        worst = 0.0
        for g, w in zip(_queue3_compute(op, ins, attrs, device),
                        _queue3_compute(op, ins, attrs, cpu)):
            try:
                worst = max(worst, _same_result(g, w))
            except AssertionError as e:
                raise AssertionError(f"12a {name}: {e}") from None
        out[name] = worst
    for name, op, attrs, points in QUEUE3_KINKS:
        x = {"X": np.array(points, np.float32)}
        (g,) = _queue3_compute(op, x, attrs, device, grad=True)
        (w,) = _queue3_compute(op, x, attrs, cpu, grad=True)
        try:
            out[f"grad_{name}"] = _same_result(g, w)
        except AssertionError as e:
            raise AssertionError(f"12a gradient of {name}: {e}") from None
    # whether the gelu op needs its +inf guard here: F.gelu itself at +inf
    import torch
    import torch.nn.functional as F

    raw = {form: bool(torch.isnan(F.gelu(torch.full(
        (64,), float("inf"), device=device), approximate=form)).any())
        for form in ("none", "tanh")}
    log(f"  12a: {len(QUEUE3_CASES)} repaired-op cases and "
        f"{len(QUEUE3_KINKS)} kink gradients equal on {device} and the CPU "
        f"(largest float relative error {max(out.values()):.3e}); F.gelu "
        f"of +inf is NaN on {device}: {raw}")
    return out, raw


def parser_phase(root, cfg):
    """12b: DATASET_PARTS parts of DATASET_INSTANCES instances; the native
    and the plain Python parser give equal arrays; ms per part each."""
    from paddle_tpu_torch import native

    files = write_bert_parts(root, DATASET_PARTS, DATASET_INSTANCES,
                             TRAIN_SEQ, cfg.vocab_size)
    types = [t for _, t in DATASET_SLOTS]
    t0 = time.perf_counter()
    native.get_slot_parser()
    build_s = time.perf_counter() - t0
    native_ms, plain_ms = [], []
    for path in files:
        t0 = time.perf_counter()
        n, slots = native.parse_multislot_file(path, types)
        native_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        n2, slots2 = native.parse_multislot_file_python(path, types)
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        if n != DATASET_INSTANCES or n2 != n:
            raise AssertionError(f"{path}: {n} and {n2} instances, "
                                 f"expected {DATASET_INSTANCES}")
        for (v, o), (v2, o2) in zip(slots, slots2):
            if not (np.array_equal(v, v2) and np.array_equal(o, o2)
                    and v.dtype == v2.dtype):
                raise AssertionError(f"{path}: native and plain parsers "
                                     f"differ")
    nbytes = sum(os.path.getsize(p) for p in files)
    log(f"  12b: {DATASET_PARTS} parts x {DATASET_INSTANCES} instances "
        f"({nbytes} bytes); slot parser built/loaded in {build_s:.2f} s; "
        f"native {np.mean(native_ms):.2f} ms a part, plain Python "
        f"{np.mean(plain_ms):.2f} ms; equal arrays")
    return files, dict(bytes=nbytes, build_s=build_s, native_ms=native_ms,
                       plain_ms=plain_ms)


def _chunk_losses(fn):
    """Run ``fn`` (a train_from_dataset call with debug=True) and return
    its result and the chunk means it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn()
    means = [float(line.rsplit("=", 1)[1]) for line in
             buf.getvalue().splitlines() if "] step " in line]
    return res, means


def _feed_threads(ds):
    """Record the names of the threads that pull ``ds``'s batches."""
    names = set()
    orig = ds.batches

    def spy():
        for b in orig():
            names.add(threading.current_thread().name)
            yield b

    ds.batches = spy
    return names


def _snapshot(scope, program):
    """Device clones of every persistable in ``scope``."""
    return {v.name: scope.find_var(v.name).clone()
            for v in program.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def _fill_scope(weights):
    import paddle_tpu_torch as pt

    scope = pt.Scope()
    for n, t in weights.items():
        scope.set_var(n, t.clone())
    return scope


def _max_param_diff(a, b, names):
    import torch

    return max(float((a.find_var(n).double() - b.find_var(n).double())
                     .abs().max()) for n in names
               if torch.is_tensor(a.find_var(n)))


def dataset_train_phase(device, cfg, files, phase5_step_ms):
    """12c: build_dataset_bert(cfg) from the parts: one QueueDataset
    epoch with thread=DATASET_THREADS, then one InMemoryDataset epoch
    after local_shuffle(SEED) (timed); the plan, launch, plain-call,
    no-load, finite-loss and feed-thread gates; one profiled chunk."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch import models as M
    from paddle_tpu_torch.observability import get_registry
    from paddle_tpu_torch.ops import flash_attention as fa

    on_card = device.type == "cuda"
    exe = _executor(device)
    main, startup, loss, feeds = build_dataset_bert(pt, M, cfg, TRAIN_SEQ)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    weights = _snapshot(scope, main)
    L = cfg.num_layers
    wait = get_registry().histogram(
        "dataio_prefetch_wait_ms").labels(name="paddle_tpu-feed")
    run_batches = list(make_dataset("QueueDataset", feeds,
                                    files[:2]).batches())

    def run_steps():
        """Executor.run over two parts' batches: the same lowered step,
        fed batch by batch, beside the epochs (launch costs drift with
        the profiler sessions of earlier phases)."""
        sync(device)
        t0 = time.perf_counter()
        for b in run_batches:
            exe.run(main, feed=b, fetch_list=[loss], scope=scope,
                    return_numpy=False)
        sync(device)
        return (time.perf_counter() - t0) / len(run_batches) * 1e3

    epochs, run_ms = {}, []
    eager_us = launch_cost_us(device)
    with _PlainCalls() as plain:
        for kind in ("QueueDataset", "InMemoryDataset"):
            if kind == "InMemoryDataset":
                run_ms.append(run_steps())
            ds = make_dataset(kind, feeds, files)
            if kind == "InMemoryDataset":
                ds.load_into_memory()
                ds.local_shuffle(SEED)
            threads = _feed_threads(ds)
            waits0 = (wait.count, wait.sum)
            _cuda.reset_launches()
            sync(device)
            t0 = time.perf_counter()
            last, means = _chunk_losses(lambda: exe.train_from_dataset(
                main, ds, scope=scope, thread=DATASET_THREADS,
                fetch_list=[loss], debug=True))
            sync(device)
            wall = time.perf_counter() - t0
            steps = DATASET_PARTS * DATASET_INSTANCES // TRAIN_BATCH
            epochs[kind] = dict(
                steps=steps, wall_s=wall, step_ms=wall / steps * 1e3,
                tokens_per_s=steps * TRAIN_BATCH * TRAIN_SEQ / wall,
                chunk_means=means, last_loss=float(last[0]),
                launches={k: _cuda.LAUNCHES.get(k, 0)
                          for k in FUSED_STEP_KERNELS + (fa.FWD,)},
                feed_threads=sorted(threads),
                feed_waits=wait.count - waits0[0],
                feed_wait_ms=wait.sum - waits0[1])
            e = epochs[kind]
            log(f"  12c {kind}: {steps} steps in {len(means)} chunks of "
                f"{DATASET_K}, {e['step_ms']:.3f} ms/step, "
                f"{e['tokens_per_s']:.1f} tokens/s (phase 5: "
                f"{phase5_step_ms:.3f} ms/step); chunk mean losses "
                + " ".join(f"{x:.4f}" for x in means)
                + f"; launches {e['launches']}; feed threads "
                f"{e['feed_threads']}; feed waited {e['feed_wait_ms']:.3f} "
                f"ms in {e['feed_waits']} waits")
            want = L * steps if on_card else 0
            if any(e["launches"][k] != want for k in FUSED_STEP_KERNELS) \
                    or e["launches"][fa.FWD]:
                raise AssertionError(f"12c {kind}: launches "
                                     f"{e['launches']}, expected {want} "
                                     f"each and no {fa.FWD}")
            if len(means) != steps // DATASET_K \
                    or not np.all(np.isfinite(means + [e["last_loss"]])):
                raise AssertionError(f"12c {kind}: chunk losses {means}")
            if e["feed_threads"] != ["paddle_tpu-feed"]:
                raise AssertionError(f"12c {kind}: batches came off "
                                     f"{e['feed_threads']}")
        run_ms.append(run_steps())
    log(f"  12c Executor.run of the same program on {len(run_batches)} "
        f"batches, before and after the InMemoryDataset epoch: "
        f"{run_ms[0]:.3f}, {run_ms[1]:.3f} ms/step ({eager_us:.2f} us per "
        f"small eager op at the start of the phase)")
    kinds = _plan_kinds(main)
    want_kinds = collections.Counter(attn=L, gemm=L + 1, ffn_chain=L)
    if kinds != [want_kinds] * 2:      # the loop's and Executor.run's
        raise AssertionError(f"12c: fusion plan groups {kinds}, expected "
                             f"{dict(want_kinds)}")
    if on_card and plain.calls:
        raise AssertionError("12c: a plain kernel version ran on the card")
    if exe.compiles_after_first_step:
        raise AssertionError("12c: a kernel library was loaded after the "
                             "first chunk")

    # one chunk under torch.profiler
    from torch.profiler import ProfilerActivity, profile

    ds = make_dataset("InMemoryDataset", feeds, files[:1])
    ds.load_into_memory()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        exe.train_from_dataset(main, ds, scope=scope, fetch_list=[loss],
                               print_period=0)
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    prof_out = _span_summary(prof, wall_us, DATASET_K,
                             ("flash_", "gemm_epilogue", "ffn_chain"))
    if prof_out is None:
        prof_out = {"device_busy_share": None}
        log(f"  12c profiled chunk: {wall_us / 1e3:.3f} ms wall; device "
            f"time not measured (no device activity recorded)")
    else:
        log(f"  12c profiled chunk of {DATASET_K} steps: "
            f"{wall_us / 1e3:.3f} ms wall, device kernels "
            f"{prof_out['device_ms_per_step']:.3f} ms a step, busy share "
            f"{prof_out['device_busy_share']:.4f}")
    prof_out["wall_ms"] = wall_us / 1e3
    return dict(epochs=epochs, plan_groups=dict(kinds[0]),
                run_step_ms=run_ms, launch_cost_us=eager_us,
                profile=prof_out, weights=weights, main=main, loss=loss,
                feeds=feeds, launches=epochs["QueueDataset"]["launches"])


def dataset_parity_phase(device, cfg, files, trained):
    """12d: at dropout 0, one chunk of DATASET_K through
    train_from_dataset against DATASET_K Executor.run steps on the same
    weights and batches (last loss, chunk mean and every persistable
    after the chunk); then phase 12c's program (dropout 0.1) from its
    startup weights with thread=0 and thread=DATASET_THREADS: bit-equal
    losses and persistables."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import models as M

    exe = _executor(device)
    cfg0 = dataclasses.replace(cfg, hidden_dropout=0.0, attn_dropout=0.0)
    main, startup, loss, feeds = build_dataset_bert(pt, M, cfg0, TRAIN_SEQ)
    scope0 = pt.Scope()
    exe.run(startup, scope=scope0)
    weights = _snapshot(scope0, main)
    del scope0
    persist = sorted(weights)

    ds = make_dataset("InMemoryDataset", feeds, files[:1])
    ds.load_into_memory()
    batches = list(ds.batches())[:DATASET_K]
    scope_run = _fill_scope(weights)
    run_losses = [float(exe.run(main, feed=b, fetch_list=[loss],
                                scope=scope_run)[0]) for b in batches]
    ds = make_dataset("InMemoryDataset", feeds, files[:1])  # one chunk
    ds.load_into_memory()
    scope_tfd = _fill_scope(weights)
    last, means = _chunk_losses(lambda: exe.train_from_dataset(
        main, ds, scope=scope_tfd, fetch_list=[loss], debug=True))
    sync(device)
    tfd_last, tfd_mean = float(last[0]), means[0]
    dlast = abs(tfd_last - run_losses[-1])
    dmean = abs(means[0] - float(np.mean(run_losses)))
    dparam = _max_param_diff(scope_run, scope_tfd, persist)
    log(f"  12d dropout 0: Executor.run losses "
        + " ".join(f"{x:.6f}" for x in run_losses)
        + f"; train_from_dataset last {tfd_last:.6f}, chunk mean "
        f"{tfd_mean:.6f} (printed to 6 places): |dlast| {dlast:.3e}, "
        f"|dmean| {dmean:.3e} (tol {PARITY_LOSS_TOL:g}), largest "
        f"persistable difference {dparam:.3e}")
    if not (dlast < PARITY_LOSS_TOL and dmean < PARITY_LOSS_TOL):
        raise AssertionError("12d: train_from_dataset and Executor.run "
                             "disagree")
    del scope_run, scope_tfd

    # thread=0 against thread=DATASET_THREADS at dropout 0.1: the same
    # program, weights and seeds (the RNG counter rewound)
    main, loss, feeds = trained["main"], trained["loss"], trained["feeds"]
    runs = {}
    for thread in (0, DATASET_THREADS):
        main._rng_counter = 0
        scope = _fill_scope(trained["weights"])
        ds = make_dataset("QueueDataset", feeds, files[:2])
        last, means = _chunk_losses(lambda: exe.train_from_dataset(
            main, ds, scope=scope, thread=thread, fetch_list=[loss],
            debug=True))
        runs[thread] = (float(last[0]), means, scope)
    (l0, m0, s0), (l2, m2, s2) = runs[0], runs[DATASET_THREADS]
    persist = sorted(trained["weights"])
    dthread = _max_param_diff(s0, s2, persist)
    log(f"  12d dropout {cfg.hidden_dropout}: thread=0 chunk means "
        + " ".join(f"{x!r}" for x in m0) + f", last {l0!r}; thread="
        f"{DATASET_THREADS} " + " ".join(f"{x!r}" for x in m2)
        + f", last {l2!r}; largest persistable difference {dthread:.3e}")
    if l0 != l2 or m0 != m2 or dthread != 0.0:
        raise AssertionError("12d: thread=0 and thread="
                             f"{DATASET_THREADS} differ")
    return dict(run_losses=run_losses, tfd_last=tfd_last,
                tfd_mean=tfd_mean, dlast=dlast, dmean=dmean,
                param_max_diff=dparam,
                bit_equal=dlast == 0.0 and dparam == 0.0,
                thread_bit_equal=True, thread_losses=[l0, m0])


def flags_phase(device, trained, files):
    """12e: under FLAGS_check_nan_inf train_from_dataset raises
    ValueError, Executor.run of log(negative feed) raises RuntimeError
    naming log and nan, a clean feed passes; the flag is reset after."""
    import paddle_tpu_torch as pt

    exe = _executor(device)
    pt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        ds = make_dataset("QueueDataset", trained["feeds"], files[:1])
        try:
            exe.train_from_dataset(trained["main"], ds, scope=pt.Scope(),
                                   fetch_list=[trained["loss"]])
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("12e: train_from_dataset ran under "
                                 "FLAGS_check_nan_inf")
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), pt.unique_name.guard():
            x = pt.data("x", [4, 8])
            y = pt.layers.mean(pt.layers.log(x))
        scope = pt.Scope()
        clean = exe.run(main, feed={"x": np.full((4, 8), 2.0, np.float32)},
                        fetch_list=[y], scope=scope)[0]
        bad = np.ones((4, 8), np.float32)
        bad[1, 3] = -1.0
        try:
            exe.run(main, feed={"x": bad}, fetch_list=[y], scope=scope)
        except RuntimeError as e:
            message = str(e)
        else:
            raise AssertionError("12e: log of a negative feed passed the "
                                 "NaN check")
    finally:
        pt.set_flags({"FLAGS_check_nan_inf": False})
    if "'log'" not in message or " nan " not in message:
        raise AssertionError(f"12e: the message {message!r}")
    if not np.isclose(float(clean), np.log(2.0)):
        raise AssertionError(f"12e: a clean run gave {clean}")
    log(f"  12e: train_from_dataset refused ({refused[:60]}...); "
        f"{message}")
    return dict(refused=refused, message=message)


def dataset_phase(device, cfg, phase5_step_ms=float("nan")):
    """Phase 12: training from files (12a-12e) in a temporary directory
    (removed in a finally)."""
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_dataset_")
    try:
        queue3, raw_gelu = queue3_phase(device)
        out = dict(queue3=queue3, f_gelu_inf_is_nan=raw_gelu)
        files, out["parser"] = parser_phase(root, cfg)
        trained = dataset_train_phase(device, cfg, files, phase5_step_ms)
        out["parity"] = dataset_parity_phase(device, cfg, files, trained)
        out["flags"] = flags_phase(device, trained, files)
        for k in ("epochs", "plan_groups", "profile", "launches",
                  "run_step_ms", "launch_cost_us"):
            out[k] = trained[k]
        out["phase5_step_ms"] = phase5_step_ms
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- phase 13: the rest of training -------------------------------------------

#: 13a: masked positions a row (bench.py's BERT-base: 20 at 128 tokens)
MASKED = 20
#: 13a: the masked head's loss against the dense head's on the same
#: positions (relative)
MASKED_LOSS_RTOL = 1e-4
#: 13b: Recompute's timed steps
RECOMPUTE_STEPS = 5
#: 13c: tests/test_sparse_grad.py's extra-fc program at a realistic table:
#: 1M rows of 128 float32 (512 MB), 4096 Zipf-drawn ids a batch
SPARSE_VOCAB, SPARSE_DIM, SPARSE_IDS, SPARSE_STEPS = 1_000_000, 128, 4096, 5
SPARSE_ZIPF_A, SPARSE_NEGATIVE = 1.2, 0.01
SPARSE_RTOL = 1e-5
#: 13d: GradientMerge's k and micro-batch rows, EMA's decay and steps,
#: the CPU test programs' steps and tolerances
MERGE_K, MERGE_RTOL = 4, 1e-4
EMA_DECAY, EMA_STEPS, EMA_RTOL = 0.999, 3, 1e-6
WRAPPER_STEPS, WRAPPER_RTOL = 6, 1e-5
#: 13e: the loss and metric ops, card against CPU (relative, with an
#: absolute floor for entries near zero)
LOSS_OPS_RTOL, LOSS_OPS_ATOL = 1e-5, 1e-6


def masked_arrays(vocab, batch, seed=SEED + 8, seq=None, masked=None):
    """bench.py's masked-head feeds as numpy arrays: ids from a seed, no
    padding, ``masked`` (MASKED) distinct positions a row of ``seq``
    (TRAIN_SEQ) as the flat index pos + b·seq, labels the ids there;
    also the [batch, masked] positions."""
    seq, masked = seq or TRAIN_SEQ, masked or MASKED
    rng = np.random.RandomState(seed)
    src = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
    pos = np.stack([rng.choice(seq, masked, replace=False)
                    for _ in range(batch)])
    flat = (pos + np.arange(batch)[:, None] * seq).reshape(-1)
    labels = np.take_along_axis(src, pos, 1).reshape(-1, 1)
    return {"src_ids": src,
            "input_mask": np.ones((batch, seq), np.float32),
            "mask_pos": flat.astype(np.int64),
            "masked_labels": labels.astype(np.int64)}, pos


def _on(device, arrays):
    import torch

    return {n: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for n, a in arrays.items()}


def masked_batch(vocab, device, batch=None, seed=SEED + 8):
    """masked_arrays on ``device`` (TRAIN_BATCH rows by default)."""
    arrays, pos = masked_arrays(vocab, batch or TRAIN_BATCH, seed)
    return _on(device, arrays), pos


def _load(scope, weights, program):
    """``weights`` (clones) into ``scope`` for every persistable of
    ``program`` they hold; the rest must already be there."""
    import paddle_tpu_torch as pt

    for n in pt.io.persistable_names(program):
        if n in weights:
            scope.set_var(n, weights[n].clone())


def _rel_norm(a, b):
    """||a - b|| / ||b|| over tensors or lists of tensors (float64)."""
    import torch

    a = a if isinstance(a, (list, tuple)) else [a]
    b = b if isinstance(b, (list, tuple)) else [b]
    num = sum(float(torch.linalg.vector_norm((x.double() - y.double())))
              ** 2 for x, y in zip(a, b))
    den = sum(float(torch.linalg.vector_norm(y.double())) ** 2 for y in b)
    return (num / max(den, 1e-300)) ** 0.5


def masked_head_phase(device, cfg, phase5_step_ms):
    """13a: the masked-position head through the default fused program:
    2 warm-up and 10 timed steps with the plan, launch, plain-call and
    no-load gates; in turns with phase 5's dense head; one profiled step
    each; the three-way parity gate; the masked loss against the dense
    head's on the same positions."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.ops import flash_attention as fa

    on_card = device.type == "cuda"
    L = cfg.num_layers
    main, startup, loss, _, params = build_train(cfg, max_masked=MASKED)
    exe, scope = _executor(device), pt.Scope()
    exe.run(startup, scope=scope)
    feed, _ = masked_batch(cfg.vocab_size, device)
    warm = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
            for _ in range(TRAIN_WARMUP)]
    with _PlainCalls() as plain:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        timed = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                         return_numpy=False)[0] for _ in range(TRAIN_STEPS)]
        sync(device)
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
    losses = [float(x) for x in warm] + [float(x) for x in timed]
    step_ms = wall / TRAIN_STEPS * 1e3
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / wall
    want = L * TRAIN_STEPS if on_card else 0
    got = {k: launches.get(k, 0) for k in FUSED_STEP_KERNELS + (fa.FWD,)}
    kinds = _plan_kinds(main)
    want_kinds = collections.Counter(attn=L, gemm=L + 1, ffn_chain=L)
    log(f"  13a masked head ({MASKED} positions a row), batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, dropout {cfg.hidden_dropout}: "
        f"groups {dict(kinds[0]) if kinds[0] else None}; {TRAIN_STEPS} "
        f"steps {step_ms:.3f} ms/step, {tokens_per_s:.1f} tokens/s (phase "
        f"5's dense head {phase5_step_ms:.3f} ms/step); losses "
        + " ".join(f"{x:.4f}" for x in losses) + f"; launches {got}; plain "
        f"versions {plain.calls}; loads after the first step "
        f"{exe.compiles_after_first_step}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"13a: a loss is not finite: {losses}")
    if kinds != [want_kinds]:
        raise AssertionError(f"13a: plan {kinds}, expected "
                             f"{dict(want_kinds)}")
    if any(got[k] != want for k in FUSED_STEP_KERNELS) or got[fa.FWD]:
        raise AssertionError(f"13a: launches {got}, expected {want} each "
                             f"and no {fa.FWD}")
    if on_card and plain.calls:
        raise AssertionError("13a: a plain kernel version ran on the card")
    if exe.compiles_after_first_step:
        raise AssertionError("13a: a library was loaded after the first "
                             "step")

    # phase 5's dense head in turns with the masked one, in this call
    dmain, dstartup, dloss, _, _ = build_train(cfg)
    dscope = pt.Scope()
    exe.run(dstartup, scope=dscope)
    dfeed = train_batch(cfg.vocab_size, device)
    for _ in range(TRAIN_WARMUP):
        exe.run(dmain, feed=dfeed, fetch_list=[dloss], scope=dscope)
    turns = {"masked": [], "dense": []}
    for name in ("masked", "dense", "dense", "masked"):
        prog, f, lv, sc = ((main, feed, loss, scope) if name == "masked"
                           else (dmain, dfeed, dloss, dscope))
        t0 = time.perf_counter()
        for _ in range(COMPARE_STEPS):
            exe.run(prog, feed=f, fetch_list=[lv], scope=sc,
                    return_numpy=False)
        sync(device)
        turns[name].append((time.perf_counter() - t0) / COMPARE_STEPS * 1e3)
    log(f"  13a in turns, {COMPARE_STEPS} steps each: masked "
        f"{turns['masked'][0]:.3f}, dense {turns['dense'][0]:.3f}, dense "
        f"{turns['dense'][1]:.3f}, masked {turns['masked'][1]:.3f} ms/step")
    prof = {"masked": _profile_step(exe, main, feed, loss, scope, device,
                                    "13a masked-head"),
            "dense": _profile_step(exe, dmain, dfeed, dloss, dscope, device,
                                   "13a dense-head")}
    head = None
    if "device_ms_per_step" in prof["masked"] \
            and "device_ms_per_step" in prof["dense"]:
        # the encoders are the same: the difference is the heads'
        head = prof["dense"]["device_ms_per_step"] \
            - prof["masked"]["device_ms_per_step"]
        log(f"  13a device ms a step: dense head "
            f"{prof['dense']['device_ms_per_step']:.3f}, masked head "
            f"{prof['masked']['device_ms_per_step']:.3f}: the masked head "
            f"saves {head:.3f} ms of kernels")
    del dscope, scope
    parity = parity_gate(device, exe, cfg, max_masked=MASKED)
    return dict(losses=losses, step_ms=step_ms, tokens_per_s=tokens_per_s,
                phase5_step_ms=phase5_step_ms, launches=got,
                plan_groups=dict(kinds[0]), turns_ms=turns, profile=prof,
                head_device_ms_saved=head, parity=parity,
                dense_head=masked_loss_gate(device, exe, cfg))


def masked_loss_gate(device, exe, cfg):
    """The masked head's loss against the dense head's whose labels mark
    the same positions: forward-only programs (is_test, dropout 0) on
    the same weights."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import build_bert_pretrain

    cfg = dataclasses.replace(cfg, hidden_dropout=0.0, attn_dropout=0.0)
    arrays, pos = masked_arrays(cfg.vocab_size, TRAIN_BATCH)
    dense = np.full((TRAIN_BATCH, TRAIN_SEQ, 1), -1, np.int64)
    np.put_along_axis(dense[..., 0], pos,
                      arrays["masked_labels"].reshape(TRAIN_BATCH, MASKED), 1)
    feeds = {True: arrays, False: {"src_ids": arrays["src_ids"],
                                   "input_mask": arrays["input_mask"],
                                   "masked_labels": dense}}
    losses, weights = {}, None
    for masked in (True, False):
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = SEED + 13
        with pt.program_guard(main, startup), pt.unique_name.guard():
            loss, _ = build_bert_pretrain(cfg, TRAIN_SEQ, is_test=True,
                                          max_masked=MASKED if masked
                                          else None)
        scope = pt.Scope()
        if weights is None:
            exe.run(startup, scope=scope)
            weights = _snapshot(scope, main)
        else:
            _load(scope, weights, main)
        losses[masked] = float(exe.run(main, feed=_on(device, feeds[masked]),
                                       fetch_list=[loss], scope=scope)[0])
        del scope
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    log(f"  13a masked head loss {losses[True]:.7f}, dense head on the same "
        f"positions {losses[False]:.7f}: relative {rel:.3e} (tol "
        f"{MASKED_LOSS_RTOL:g})")
    if not rel <= MASKED_LOSS_RTOL:
        raise AssertionError("13a: the masked and the dense head disagree")
    return dict(masked_loss=losses[True], dense_loss=losses[False],
                rel_err=rel)


def _recompute_wrap(opt, bounds):
    import paddle_tpu_torch as pt

    rc = pt.optimizer.RecomputeOptimizer(opt)
    rc._set_checkpoints(bounds)
    return rc


def recompute_phase(device, cfg):
    """13b: RecomputeOptimizer(Adam) with the embedding's and every
    layer's outputs as checkpoints, on 13a's program, against the same
    program run unfused without Recompute: peak memory and step ms at
    dropout 0.1 (the first step's loss equal), then at dropout 0
    PARITY_STEPS steps and the first step's gradients."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.ops import flash_attention as fa

    on_card = device.type == "cuda"
    L = cfg.num_layers
    exe = _executor(device)
    feed, _ = masked_batch(cfg.vocab_size, device)
    runs = {"recompute": _recompute_wrap, "unfused": None}
    bs = pt.BuildStrategy()
    bs.fuse_epilogues = False
    out, weights = {}, None
    for drop in (cfg.hidden_dropout, 0.0):
        c = dataclasses.replace(cfg, hidden_dropout=drop, attn_dropout=drop)
        for name, wrap in runs.items():
            main, startup, loss, grads, _ = build_train(c, MASKED, wrap)
            program = pt.CompiledProgram(main, build_strategy=bs)
            scope = pt.Scope()
            if weights is None:
                exe.run(startup, scope=scope)
                weights = _snapshot(scope, main)
            else:
                _load(scope, weights, main)
            sync(device)
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            if drop:
                grads = []     # kept gradients would count in the peaks
            first = exe.run(program, feed=feed, scope=scope,
                            return_numpy=False, fetch_list=[loss] + grads)
            steps = RECOMPUTE_STEPS if drop else PARITY_STEPS - 1
            with _PlainCalls() as plain:
                _cuda.reset_launches()
                t0 = time.perf_counter()
                rest = [exe.run(program, feed=feed, fetch_list=[loss],
                                scope=scope, return_numpy=False)[0]
                        for _ in range(steps)]
                sync(device)
                wall = time.perf_counter() - t0
                launches = {k: n for k, n in _cuda.LAUNCHES.items() if n}
            r = dict(losses=[float(first[0])] + [float(x) for x in rest],
                     grads=dict(zip(grads, first[1:])),
                     step_ms=wall / steps * 1e3, launches=launches,
                     plain_calls=plain.calls, plans=_plan_kinds(main),
                     peak=(torch.cuda.max_memory_allocated(device)
                           if on_card else 0))
            out[(name, drop)] = r
            del scope, first
            if any(plan is not None for plan in r["plans"]):
                raise AssertionError(f"13b {name}: fusion plan {r['plans']}")
            want = {fa.FWD: L * steps, fa.DQ: L * steps,
                    fa.DKV: L * steps} if on_card else {}
            if name == "recompute" and on_card:
                # the forward once, and again inside the backward
                want[fa.FWD] = launches.get(fa.FWD, 0)
                if not L * steps <= want[fa.FWD] <= 2 * L * steps:
                    raise AssertionError(f"13b: {fa.FWD} launched "
                                         f"{want[fa.FWD]} times")
            if launches != want:
                raise AssertionError(f"13b {name} (dropout {drop}): "
                                     f"launches {launches}, expected {want}")
            if on_card and plain.calls:
                raise AssertionError(f"13b {name}: a plain kernel version "
                                     f"ran on the card")
            log(f"  13b {name}, dropout {drop}: {steps} steps "
                f"{r['step_ms']:.3f} ms/step, peak memory "
                f"{r['peak'] / 2**30:.3f} GiB; losses " + " ".join(
                    f"{x:.6f}" for x in r["losses"]) + f"; launches "
                f"{launches}")
    rc, un = out[("recompute", cfg.hidden_dropout)], \
        out[("unfused", cfg.hidden_dropout)]
    if on_card and not rc["peak"] < un["peak"]:
        raise AssertionError(f"13b: Recompute's peak {rc['peak']} is not "
                             f"below the unfused program's {un['peak']}")
    if rc["losses"][0] != un["losses"][0]:
        raise AssertionError(f"13b: at dropout {cfg.hidden_dropout} the "
                             f"first losses differ: {rc['losses'][0]} and "
                             f"{un['losses'][0]}")
    rc0, un0 = out[("recompute", 0.0)], out[("unfused", 0.0)]
    dloss = max(abs(a - b) for a, b in zip(rc0["losses"], un0["losses"]))
    rel = {n: _rel_norm(rc0["grads"][n], un0["grads"][n])
           for n in un0["grads"]}
    worst = max(rel, key=rel.get)
    log(f"  13b at dropout 0: max |dloss| {dloss:.3e} (tol "
        f"{PARITY_LOSS_TOL:g}), first-step gradient relative norm error "
        f"max {rel[worst]:.3e} ({worst}; tol {PARITY_GRAD_RTOL:g}); peak "
        f"memory at dropout {cfg.hidden_dropout}: Recompute "
        f"{rc['peak'] / 2**30:.3f} GiB, unfused {un['peak'] / 2**30:.3f} "
        f"GiB; step {rc['step_ms']:.3f} against {un['step_ms']:.3f} ms")
    if not dloss < PARITY_LOSS_TOL:
        raise AssertionError("13b: Recompute's losses diverge")
    if not rel[worst] < PARITY_GRAD_RTOL:
        raise AssertionError("13b: Recompute's gradients disagree")
    return dict(step_ms=rc["step_ms"], unfused_step_ms=un["step_ms"],
                peak_bytes=rc["peak"], unfused_peak_bytes=un["peak"],
                launches=rc["launches"], losses=rc["losses"],
                unfused_losses=un["losses"], max_dloss=dloss,
                max_grad_rel_err=rel[worst])


def build_sparse(is_sparse, optimizer, extra_fc=True):
    """tests/test_sparse_grad.py's program at SPARSE_VOCAB x SPARSE_DIM
    and SPARSE_IDS ids: ``optimizer()`` minimizes it."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 13
    with pt.program_guard(main, startup), pt.unique_name.guard():
        ids = pt.data("ids", [SPARSE_IDS, 1], "int64")
        target = pt.data("target", [SPARSE_IDS, SPARSE_DIM])
        emb = pt.layers.embedding(ids, (SPARSE_VOCAB, SPARSE_DIM),
                                  is_sparse=is_sparse,
                                  param_attr=pt.ParamAttr(name="table"))
        if extra_fc:
            emb = pt.layers.fc(emb, SPARSE_DIM,
                               param_attr=pt.ParamAttr(name="fc_w"))
        loss = pt.layers.mean(pt.layers.square_error_cost(emb, target))
        optimizer().minimize(loss)
    return main, startup, loss


def sparse_feeds(steps=SPARSE_STEPS, seed=SEED + 30):
    """Zipf-drawn ids (rows repeat), a share of them written as their
    negative alias id - SPARSE_VOCAB (which wraps to the same row), and
    a target, one batch a step."""
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(steps):
        ids = (rng.zipf(SPARSE_ZIPF_A, SPARSE_IDS) - 1) % SPARSE_VOCAB
        neg = rng.rand(SPARSE_IDS) < SPARSE_NEGATIVE
        ids = np.where(neg, ids - SPARSE_VOCAB, ids).astype(np.int64)
        feeds.append({"ids": ids[:, None], "target": rng.randn(
            SPARSE_IDS, SPARSE_DIM).astype(np.float32)})
    return feeds


SPARSE_RUNS = {
    "sgd": lambda pt: pt.optimizer.SGD(
        0.5, grad_clip=pt.clip.GradientClipByGlobalNorm(1.0)),
    "adam": lambda pt: pt.optimizer.Adam(
        0.01, grad_clip=pt.clip.GradientClipByGlobalNorm(1.0)),
    "lazy_adam": lambda pt: pt.optimizer.Adam(
        0.01, lazy_mode=True, grad_clip=pt.clip.GradientClipByGlobalNorm(
            1.0)),
}


def _sparse_run(device, exe, is_sparse, name, weights, feeds, fetch_grad):
    import paddle_tpu_torch as pt

    main, startup, loss = build_sparse(
        is_sparse, lambda: SPARSE_RUNS[name](pt))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    if weights is None:
        weights = {p.name: scope.find_var(p.name).clone()
                   for p in main.global_block().all_parameters()}
    _load(scope, weights, main)
    losses, walls, grad = [], [], None
    for step, f in enumerate(feeds):
        t0 = time.perf_counter()
        fetch = [loss] + (["table@GRAD", "table@GRAD@ROWS"]
                          if fetch_grad and step == 0 else [])
        got = exe.run(main, feed=_on(device, f), fetch_list=fetch,
                      scope=scope, return_numpy=False)
        losses.append(float(got[0]))
        sync(device)
        walls.append(time.perf_counter() - t0)
        if len(got) > 1:
            grad = (tuple(got[1].shape), tuple(got[2].shape))
    state = {n: scope.find_var(n) for n in pt.io.persistable_names(main)}
    # the first step lowers the program: time the others
    return dict(losses=losses, step_ms=float(np.mean(walls[1:])) * 1e3,
                state=state, grad_shapes=grad), weights


def sparse_phase(device):
    """13c: SGD, Adam and lazy Adam with GradientClipByGlobalNorm(1.0)
    on the sparse table, beside the dense program (SGD, Adam); lazy
    Adam's untouched rows and moments; the fetched gradient's shape;
    two runs bit-equal; ids past the table touch no row."""
    import torch

    import paddle_tpu_torch as pt

    exe = _executor(device)
    feeds = sparse_feeds()
    runs, weights = {}, None
    for name in SPARSE_RUNS:
        for is_sparse in (True, False) if name != "lazy_adam" else (True,):
            runs[(name, is_sparse)], weights = _sparse_run(
                device, exe, is_sparse, name, weights, feeds, is_sparse)
    out = {}
    for name in ("sgd", "adam"):
        s, d = runs[(name, True)], runs[(name, False)]
        dl = max(abs(a - b) / abs(b) for a, b in zip(s["losses"],
                                                     d["losses"]))
        dt = _rel_norm(s["state"]["table"], d["state"]["table"])
        out[name] = dict(max_loss_rel_err=dl, table_rel_err=dt,
                         sparse_step_ms=s["step_ms"],
                         dense_step_ms=d["step_ms"], losses=s["losses"])
        log(f"  13c {name}: losses " + " ".join(
            f"{x:.6f}" for x in s["losses"]) + f"; against dense: loss "
            f"relative {dl:.3e}, table relative norm {dt:.3e} (tol "
            f"{SPARSE_RTOL:g}); step {s['step_ms']:.3f} ms sparse, "
            f"{d['step_ms']:.3f} ms dense")
        if not (dl <= SPARSE_RTOL and dt <= SPARSE_RTOL):
            raise AssertionError(f"13c: sparse {name} departs from dense")
    lazy = runs[("lazy_adam", True)]
    n = SPARSE_VOCAB
    touched = np.unique(np.concatenate([f["ids"].ravel() for f in feeds])
                        % n)
    keep = torch.ones(n, dtype=torch.bool)
    keep[torch.from_numpy(touched)] = False
    keep = keep.to(device)
    table0 = weights["table"]
    moments = [v for k, v in lazy["state"].items()
               if k.startswith("table_moment")]
    same = bool(torch.equal(lazy["state"]["table"][keep], table0[keep])) \
        and all(bool((m[keep] == 0).all()) for m in moments) \
        and not torch.equal(lazy["state"]["table"], table0)
    log(f"  13c lazy Adam: {len(touched)} rows touched of {n}; the others "
        f"and their moments bit-unchanged: {same}; step "
        f"{lazy['step_ms']:.3f} ms; losses " + " ".join(
            f"{x:.6f}" for x in lazy["losses"]))
    if not same:
        raise AssertionError("13c: lazy Adam touched a row it was not given")
    out["lazy_adam"] = dict(rows_touched=int(len(touched)),
                            step_ms=lazy["step_ms"], losses=lazy["losses"])
    shapes = runs[("sgd", True)]["grad_shapes"]
    if shapes != ((SPARSE_IDS, SPARSE_DIM), (SPARSE_IDS,)):
        raise AssertionError(f"13c: table@GRAD, @ROWS shapes {shapes}")
    # again from the same weights: the same bits
    for name in SPARSE_RUNS:
        again, _ = _sparse_run(device, exe, True, name, weights, feeds, False)
        first = runs[(name, True)]
        bits = again["losses"] == first["losses"] and all(
            torch.equal(again["state"][k], v)
            for k, v in first["state"].items())
        out[name]["bit_equal_rerun"] = bits
        if not bits:
            raise AssertionError(f"13c: two {name} runs differ")
    out["oob"] = sparse_oob_probe(device, exe, weights)
    out["grad_shapes"] = shapes
    log(f"  13c: table@GRAD {shapes[0]}, @ROWS {shapes[1]}; each sparse "
        f"run bit-equal to its rerun")
    return out


def sparse_oob_probe(device, exe, weights):
    """One sparse SGD step (no clip, no fc) whose ids hold some past the
    table and some below -SPARSE_VOCAB: no device-side assert, the rows
    of the valid ids change, every other row keeps its bits."""
    import torch

    import paddle_tpu_torch as pt

    main, startup, loss = build_sparse(True, lambda: pt.optimizer.SGD(0.5),
                                       extra_fc=False)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    scope.set_var("table", weights["table"].clone())
    f = sparse_feeds(1, seed=SEED + 31)[0]
    n = SPARSE_VOCAB
    f["ids"][:8, 0] = [n, n + 7, 2 * n, -n - 1, -3 * n, n + 1, -n - 2,
                       10 * n]
    exe.run(main, feed=_on(device, f), fetch_list=[loss], scope=scope)
    sync(device)
    table = scope.find_var("table")
    ids = f["ids"].ravel()
    valid = np.unique(ids[(ids >= -n) & (ids < n)] % n)
    changed = torch.nonzero((table != weights["table"]).any(1)).ravel()
    ok = (bool(torch.isfinite(table).all())
          and set(changed.cpu().tolist()) <= set(valid.tolist()))
    log(f"  13c ids past the table: 8 of {SPARSE_IDS}, no device-side "
        f"assert; {len(changed)} rows changed, all of them rows of valid "
        f"ids: {ok}")
    if not ok:
        raise AssertionError("13c: an id past the table reached a row")
    return dict(rows_changed=int(len(changed)), valid_rows=int(len(valid)))


def _merge_wrap(opt, bounds):
    import paddle_tpu_torch as pt

    return pt.optimizer.GradientMergeOptimizer(opt, k_steps=MERGE_K)


def gradient_merge_gate(device, exe, cfg):
    """13d: GradientMerge(k=MERGE_K) on 13a's program at dropout 0 over
    MERGE_K micro-batches of TRAIN_BATCH / MERGE_K rows: the parameters
    keep their bits on the first k - 1 steps, and after the k-th equal
    one Adam step on the whole batch (every micro-batch holds the same
    number of labels, so the mean of the means is the batch's mean)."""
    import torch

    import paddle_tpu_torch as pt

    cfg = dataclasses.replace(cfg, hidden_dropout=0.0, attn_dropout=0.0)
    arrays, pos = masked_arrays(cfg.vocab_size, TRAIN_BATCH)
    rows = TRAIN_BATCH // MERGE_K
    micro = []
    for j in range(MERGE_K):
        sl = slice(j * rows, (j + 1) * rows)
        flat = (pos[sl] + np.arange(rows)[:, None] * TRAIN_SEQ).reshape(-1)
        micro.append({"src_ids": arrays["src_ids"][sl],
                      "input_mask": arrays["input_mask"][sl],
                      "mask_pos": flat.astype(np.int64),
                      "masked_labels": arrays["masked_labels"].reshape(
                          TRAIN_BATCH, MASKED, 1)[sl].reshape(-1, 1)})
    gm, gstartup, gloss, _, params = build_train(cfg, MASKED, _merge_wrap)
    scope = pt.Scope()
    exe.run(gstartup, scope=scope)
    weights = _snapshot(scope, gm)
    before = [scope.find_var(p).clone() for p in params]
    kept, losses = [], []
    for j, f in enumerate(micro):
        losses.append(float(exe.run(gm, feed=_on(device, f),
                                    fetch_list=[gloss], scope=scope)[0]))
        now = [scope.find_var(p) for p in params]
        if j < MERGE_K - 1:
            kept.append(all(torch.equal(a.view(torch.int32),
                                        b.view(torch.int32))
                            for a, b in zip(now, before)))
    merged = [scope.find_var(p).clone() for p in params]
    del scope
    big, bstartup, bloss, _, _ = build_train(cfg, MASKED)
    bscope = pt.Scope()
    exe.run(bstartup, scope=bscope)
    _load(bscope, weights, big)
    exe.run(big, feed=_on(device, arrays), fetch_list=[bloss], scope=bscope)
    one = [bscope.find_var(p) for p in params]
    rel = _rel_norm(merged, one)
    moved = _rel_norm(merged, before)
    log(f"  13d GradientMerge(k={MERGE_K}) over {MERGE_K} batches of "
        f"{rows}: parameters bit-unchanged on steps 1-{MERGE_K - 1}: "
        f"{kept}; after step {MERGE_K}, relative norm error {rel:.3e} "
        f"against one Adam step on the {TRAIN_BATCH}-row batch (tol "
        f"{MERGE_RTOL:g}; the step moved them {moved:.3e}); losses "
        + " ".join(f"{x:.5f}" for x in losses))
    del bscope
    if not all(kept):
        raise AssertionError("13d: GradientMerge moved a parameter before "
                             "its merge step")
    if not rel <= MERGE_RTOL:
        raise AssertionError("13d: the merged step is not the big batch's")
    return dict(kept_bits=kept, rel_err=rel, moved=moved, losses=losses)


def ema_gate(device, exe, cfg):
    """13d: ExponentialMovingAverage(EMA_DECAY).update() on 13a's program
    for EMA_STEPS steps; inside apply the weights equal the script's own
    bias-corrected average of the weights it read after each step (the
    program's float32 formulas, outside the program) within EMA_RTOL;
    after restore they keep their bits."""
    import math

    import torch

    import paddle_tpu_torch as pt

    ema = {}

    def wrap(opt, bounds):
        class _WithEMA:
            def minimize(self, loss):
                out = opt.minimize(loss)
                ema["ema"] = pt.optimizer.ExponentialMovingAverage(EMA_DECAY)
                ema["ema"].update()
                return out
        return _WithEMA()

    main, startup, loss, _, params = build_train(cfg, MASKED, wrap)
    scope = pt.Scope()
    feed, _ = masked_batch(cfg.vocab_size, device)
    with pt.scope_guard(scope):
        exe.run(startup)
        avg = {p: torch.zeros_like(scope.find_var(p)) for p in params}
        for _ in range(EMA_STEPS):
            exe.run(main, feed=feed, fetch_list=[loss])
            for p in params:
                avg[p] = avg[p] * EMA_DECAY \
                    + scope.find_var(p) * (1.0 - EMA_DECAY)
        before = [scope.find_var(p).clone() for p in params]
        step = torch.full((), float(EMA_STEPS), device=device)
        debias = 1.0 - torch.exp(step * math.log(EMA_DECAY)) + 1e-12
        want = [avg[p] / debias for p in params]
        with ema["ema"].apply(exe):
            inside = [scope.find_var(p).clone() for p in params]
        after = [scope.find_var(p) for p in params]
    rel = _rel_norm(inside, want)
    restored = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(after, before))
    log(f"  13d EMA({EMA_DECAY}) after {EMA_STEPS} steps: inside apply "
        f"relative norm error {rel:.3e} against the script's "
        f"bias-corrected average (tol {EMA_RTOL:g}); restore bit-equal: "
        f"{restored}")
    if not rel <= EMA_RTOL:
        raise AssertionError("13d: EMA's applied weights are not the "
                             "average")
    if not restored:
        raise AssertionError("13d: EMA's restore changed a weight")
    return dict(rel_err=rel, restored_bits=restored)


def _tiny_program(kind):
    """tests/test_torch_optimizer_wrappers.py's programs for ModelAverage,
    Lookahead and DGC momentum -> (main, startup, loss, wrapper)."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    out = None
    with pt.program_guard(main, startup), pt.unique_name.guard():
        if kind.startswith("dgc"):
            x = pt.data("x", [None, 10])
        else:
            x = pt.data("x", [4, 2], "float32")
        y = pt.layers.fc(x, size=1, param_attr=pt.ParamAttr(name="w"),
                         bias_attr=False)
        loss = pt.layers.mean(y)
        if kind == "model_average":
            pt.optimizer.SGD(0.1).minimize(loss)
            out = pt.optimizer.ModelAverage(average_window_rate=1.0,
                                            min_average_window=1,
                                            max_average_window=100)
        elif kind == "lookahead":
            pt.optimizer.LookaheadOptimizer(pt.optimizer.SGD(0.1),
                                            alpha=0.5, k=2).minimize(loss)
        elif kind == "dgc":
            pt.optimizer.DGCMomentumOptimizer(
                0.1, momentum=0.9, rampup_begin_step=0,
                sparsity=[0.6]).minimize(loss)
        else:
            pt.optimizer.DGCMomentumOptimizer(
                0.1, momentum=0.9, rampup_begin_step=2, rampup_step=3,
                sparsity=[0.5, 0.75, 0.9]).minimize(loss)
    return main, startup, loss, out


def _tiny_feeds(kind):
    rng = np.random.RandomState(3)
    if kind.startswith("dgc"):
        x = rng.randn(4, 10).astype(np.float32) * np.arange(1, 11)
        return [{"x": x}] * WRAPPER_STEPS
    return [{"x": rng.randn(4, 2).astype(np.float32)}
            for _ in range(WRAPPER_STEPS)]


def wrapper_programs_gate(device):
    """13d: ModelAverage (with its apply), Lookahead and DGC momentum on
    their CPU test programs, WRAPPER_STEPS steps on ``device`` against
    the port's CPU run from the same weights: every loss and persistable
    within WRAPPER_RTOL."""
    import torch

    import paddle_tpu_torch as pt

    cpu = torch.device("cpu")
    out = {}
    for kind in ("model_average", "lookahead", "dgc", "dgc_rampup"):
        res, weights = {}, None
        for dev in (cpu, device):
            main, startup, loss, wrapper = _tiny_program(kind)
            exe, scope = _executor(dev), pt.Scope()
            with pt.scope_guard(scope):
                exe.run(startup)
                if weights is None:
                    weights = {n: v.cpu() for n, v in _snapshot(
                        scope, main).items()}
                else:
                    for n, v in weights.items():
                        scope.set_var(n, v.to(dev))
                losses = [float(exe.run(main, feed=f, fetch_list=[loss])[0])
                          for f in _tiny_feeds(kind)]
                applied = None
                if wrapper is not None:
                    with wrapper.apply(exe):
                        applied = scope.find_var("w").cpu().clone()
                state = {n: v.cpu() for n, v in _snapshot(scope,
                                                          main).items()}
            res[dev.type] = (losses, state, applied)
        (lc, sc, ac), (lg, sg, ag) = res["cpu"], res[device.type]
        worst = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lg, lc))
        for n, v in sc.items():
            if v.is_floating_point():
                worst = max(worst, _rel_norm(sg[n], v))
            elif not torch.equal(sg[n], v):
                raise AssertionError(f"13d {kind}: {n} {sg[n]} != {v}")
        if ac is not None:
            worst = max(worst, _rel_norm(ag, ac))
        out[kind] = worst
        if not worst <= WRAPPER_RTOL:
            raise AssertionError(f"13d {kind}: relative error {worst:.3e} "
                                 f"against the CPU run")
    log(f"  13d ModelAverage, Lookahead, DGC momentum ({WRAPPER_STEPS} "
        f"steps) against the CPU: relative errors {out} (tol "
        f"{WRAPPER_RTOL:g})")
    return out


def _probs(r, n, c):
    e = np.exp(r.randn(n, c).astype(np.float32))
    return e / e.sum(-1, keepdims=True)


#: 13e: the loss and metric ops over their CPU tests' inputs: (name, op,
#: inputs from a RandomState, attrs, the slot differentiated or None)
LOSS_OP_CASES = (
    ("ce_hard", "cross_entropy", lambda r: {
        "X": _probs(r, 6, 5), "Label": r.randint(0, 5, (6, 1))}, {}, "X"),
    ("ce_ignore", "cross_entropy", lambda r: {
        "X": _probs(r, 6, 5),
        "Label": np.array([[0], [-100], [4], [2], [-100], [1]])},
     {"ignore_index": -100}, "X"),
    ("ce_soft", "cross_entropy", lambda r: {
        "X": _probs(r, 6, 5), "Label": _probs(r, 6, 5)},
     {"soft_label": True}, "X"),
    ("sigmoid_ce", "sigmoid_cross_entropy_with_logits", lambda r: {
        "X": r.randn(4, 3).astype(np.float32) * 4,
        "Label": (r.rand(4, 3) > 0.5).astype(np.float32)}, {}, "X"),
    ("sigmoid_ce_ignore_norm", "sigmoid_cross_entropy_with_logits",
     lambda r: {"X": r.randn(4, 3).astype(np.float32) * 4,
                "Label": np.where(r.rand(4, 3) > 0.7, 2.0,
                                  (r.rand(4, 3) > 0.5)).astype(np.float32)},
     {"ignore_index": 2, "normalize": True}, "X"),
    ("smooth_l1", "smooth_l1_loss", lambda r: {
        "X": r.randn(5, 3).astype(np.float32),
        "Y": r.randn(5, 3).astype(np.float32)}, {"sigma": 1.0}, "X"),
    ("smooth_l1_sigma3", "smooth_l1_loss", lambda r: {
        "X": r.randn(5, 2, 3).astype(np.float32),
        "Y": r.randn(5, 2, 3).astype(np.float32)}, {"sigma": 3.0}, "X"),
    ("huber", "huber_loss", lambda r: {
        "X": r.randn(6, 2).astype(np.float32),
        "Y": r.randn(6, 2).astype(np.float32)}, {"delta": 0.3}, "X"),
    ("accuracy_ties", "accuracy", lambda r: {
        "Out": r.randint(0, 3, (8, 4)).astype(np.float32),
        "Label": r.randint(0, 4, (8, 1))}, {"k": 1}, None),
    ("auc_ties", "auc", lambda r: {
        "Predict": np.round(r.rand(40, 2), 1).astype(np.float32),
        "Label": r.randint(0, 2, (40, 1))}, {}, None),
)


def _loss_op(op, ins, attrs, device, slot):
    """The op's outputs (sorted by slot) on ``device``, and with ``slot``
    the gradient of the sum of its first output with respect to it."""
    import torch

    from paddle_tpu_torch.core.registry import REGISTRY, OpContext

    ctx = OpContext(rng=None, is_test=False, attrs=attrs, device=device)
    tins = {s: [torch.from_numpy(np.array(v)).to(device)]
            for s, v in ins.items()}
    if slot is not None:
        tins[slot][0].requires_grad_()
    outs = REGISTRY.get(op).compute(ctx, tins, attrs)
    got = [outs[s][0].detach().cpu() for s in sorted(outs)]
    if slot is not None:
        y = outs["Out" if "Out" in outs else sorted(outs)[0]][0]
        (g,) = torch.autograd.grad(y.sum(), tins[slot][0])
        got.append(g.cpu())
    return got


def loss_ops_phase(device):
    """13e: each loss and metric op on ``device`` against the CPU, forward
    and gradient."""
    cpu = __import__("torch").device("cpu")
    out = {}
    for i, (name, op, make, attrs, slot) in enumerate(LOSS_OP_CASES):
        ins = make(np.random.RandomState(40 + i))
        worst = 0.0
        for g, w in zip(_loss_op(op, ins, attrs, device, slot),
                        _loss_op(op, ins, attrs, cpu, slot)):
            g, w = g.double().numpy(), w.double().numpy()
            if g.shape != w.shape:
                raise AssertionError(f"13e {name}: shape {g.shape} against "
                                     f"{w.shape}")
            err = np.abs(g - w) / np.maximum(np.abs(w), LOSS_OPS_ATOL
                                             / LOSS_OPS_RTOL)
            worst = max(worst, float(err.max()) if err.size else 0.0)
        out[name] = worst
        if not worst <= LOSS_OPS_RTOL:
            raise AssertionError(f"13e {name}: relative error {worst:.3e}")
    log(f"  13e: {len(LOSS_OP_CASES)} loss and metric op cases equal on "
        f"{device} and the CPU (largest relative error "
        f"{max(out.values()):.3e}, tol {LOSS_OPS_RTOL:g})")
    return out


def sparse_recompute_phase(device, cfg, phase5_step_ms=float("nan")):
    """Phase 13: the masked head (13a), Recompute (13b), sparse gradients
    at a realistic table (13c), the wrappers (13d), the loss and metric
    ops (13e)."""
    out = dict(masked=masked_head_phase(device, cfg, phase5_step_ms))
    out["recompute"] = recompute_phase(device, cfg)
    out["sparse"] = sparse_phase(device)
    exe = _executor(device)
    out["wrappers"] = dict(
        gradient_merge=gradient_merge_gate(device, exe, cfg),
        ema=ema_gate(device, exe, cfg),
        programs=wrapper_programs_gate(device))
    out["loss_ops"] = loss_ops_phase(device)
    return out


# -- phase 14: the serving artifact, the tuning plane, the fleet --------------

#: 14a: the artifact's logits against the Predictor's (max abs; the same
#: kernels in the same order, so bit-equal is expected)
ARTIFACT_ATOL = 1e-6
#: 14a: timed runs of each artifact in the loading process, and of the
#: Predictor
ARTIFACT_RUNS = 3
#: 14b: calls a tuning candidate is timed over
TUNE_REPS = 200
#: 14b: the FFN geometry of the plan search (BERT-base's training FFN:
#: M = 32 x 128 rows)
PLAN_GEOMETRY = (4096, 768, 3072, 768)
#: 14b/14c: greedy tokens a request (the depth-2 token gates): a request
#: lasts long enough to be in flight when its worker is killed
FLEET_NEW = MAX_SEQ_LEN - PROMPT_LEN
#: 14c: requests of the autoscaler's burst, and of each other scenario
FLEET_BURST, FLEET_REQUESTS = 24, 8
#: 14c: each worker's log directory
FLEET_LOG_DIR = OUT_DIR / "phase14"

#: the loading process of 14a: it imports the loader alone (no program
#: IR), loads each artifact, runs it and reports launches, plain calls,
#: times and the modules it imported
ARTIFACT_CHILD = r'''
import json, sys, time
import numpy as np
import torch
from paddle_tpu_torch import _cuda
from paddle_tpu_torch.inference.predictor import load_exported

args = json.loads(sys.argv[1])
buf, want = np.load(args["inputs"]), np.load(args["want"])
on_card = args["device"].startswith("cuda")
plain = {"n": 0}
names = {"ops.flash_attention": ("flash_ref_forward", "flash_ref_forward_flat",
                                 "attention", "attention_packed"),
         "ops.attention_epilogue": ("qkv_ref_forward", "flash_ref_forward"),
         "ops.fused_matmul": ("reference_matmul_epilogue",),
         "ops.ffn_chain": ("reference_ffn_chain",)}
import importlib
for m, fns in names.items():
    mod = importlib.import_module("paddle_tpu_torch." + m)
    for n in fns:
        def counted(*a, _fn=getattr(mod, n), **kw):
            plain["n"] += 1
            return _fn(*a, **kw)
        setattr(mod, n, counted)

def sync():
    if on_card:
        torch.cuda.synchronize()

out = {}
for tag in ("baked", "unbaked"):
    t0 = time.perf_counter()
    call = load_exported(args[tag])
    load_s = time.perf_counter() - t0
    got = call({"src_ids": buf})[0].cpu().numpy()        # first run
    _cuda.reset_launches()
    plain["n"] = 0
    runs = []
    for _ in range(args["runs"]):
        sync()
        t0 = time.perf_counter()
        got = call({"src_ids": buf})[0].cpu().numpy()
        runs.append(time.perf_counter() - t0)
    out[tag] = dict(load_s=load_s, run_s=runs,
                    launches={k: v / args["runs"]
                              for k, v in _cuda.LAUNCHES.items() if v},
                    plain_calls=plain["n"],
                    max_abs_err=float(np.abs(got.astype(np.float64)
                                             - want).max()),
                    shape=list(got.shape),
                    finite=bool(np.isfinite(got).all()))
try:
    load_exported(args["foreign"])({"src_ids": buf})
    out["foreign"] = "accepted"
except ValueError as e:
    out["foreign"] = str(e)
out["modules"] = sorted(m for m in sys.modules
                        if m.startswith("paddle_tpu_torch"))
print("ARTIFACT_CHILD " + json.dumps(out))
'''


def _logits_program(cfg):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import build_lm_logits

    def logits_graph(c):
        src = pt.data("src_ids", [N_PROMPTS, MAX_SEQ_LEN], "int64")
        return build_lm_logits(src, c)

    return lm_graph_program(logits_graph, cfg)


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def artifact_phase(device, cfg, root):
    """Phase 14a: build_lm_logits at [N_PROMPTS, MAX_SEQ_LEN] (the
    serving LM, dropout 0, weights from the startup program's seed)
    frozen into a Predictor, exported baked and unbaked
    (``export_stablehlo``: a torch.export program whose fused groups are
    the kernels' torch.library operators), then loaded and run in a
    fresh process that imports the loader alone.  Gates: the logits
    within ARTIFACT_ATOL of the Predictor's, #9/#10/#11 once per layer a
    run there, no plain version, no program IR, layers or models
    imported there, a foreign sidecar refused at load and at a
    write_sidecar=False export.  Returns (report, state for 14b)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.inference.sidecar import write_weight_sidecar

    on_card = device.type == "cuda"
    L = cfg.num_layers
    main, startup, out = _logits_program(cfg)
    exe, scope = _executor(device), pt.Scope()
    exe.run(startup, scope=scope)
    path = os.path.join(root, "logits")
    with pt.scope_guard(scope):
        pt.io.save_inference_model(path, ["src_ids"], [out], exe,
                                   main_program=main)
    config = inference.Config(path)
    if not on_card:
        config.disable_gpu()
    pred = inference.create_predictor(config)
    buf = np.asarray(make_prompts(np.random.RandomState(SEED + 14),
                                  N_PROMPTS, MAX_SEQ_LEN, cfg.vocab_size),
                     np.int64)
    want, = pred.run([buf])
    pred_s = []
    for _ in range(ARTIFACT_RUNS):
        sync(device)
        t0 = time.perf_counter()
        want, = pred.run([buf])
        pred_s.append(time.perf_counter() - t0)

    arts, export_s, text = {}, {}, {}
    for tag, bake in (("baked", True), ("unbaked", False)):
        arts[tag] = os.path.join(root, f"logits_{tag}.pt2")
        t0 = time.perf_counter()
        text[tag] = pred.export_stablehlo(arts[tag],
                                          example_inputs={"src_ids": buf},
                                          bake_weights=bake)
        export_s[tag] = time.perf_counter() - t0
    graph = open(text["baked"]).read()
    ops = {k: graph.count(f"paddle_tpu_torch.{k}.default")
           for k in ("flash_kernel_forward_qkv", "fused_matmul_kernel",
                     "ffn_chain_kernel", "flash_kernel_forward")}
    if ops != {"flash_kernel_forward_qkv": L, "fused_matmul_kernel": L,
               "ffn_chain_kernel": L, "flash_kernel_forward": 0}:
        raise AssertionError(f"the artifact's graph holds the kernels' "
                             f"operators {ops}, one of #9/#10/#11 per layer "
                             f"expected")
    # a sidecar of another model: refused by a write_sidecar=False export
    # (before anything is written) and at load (the argument count)
    arts["foreign"] = os.path.join(root, "logits_foreign.pt2")
    shutil.copyfile(arts["baked"], arts["foreign"])
    write_weight_sidecar(arts["foreign"] + ".weights",
                         {"w_other": np.zeros((3, 3), np.float32)})
    try:
        pred.export_stablehlo(arts["foreign"],
                              example_inputs={"src_ids": buf},
                              bake_weights=False, write_sidecar=False)
        raise AssertionError("a foreign sidecar passed the export's check")
    except ValueError as e:
        if "does not match" not in str(e):
            raise
        export_refusal = str(e)
    np.save(os.path.join(root, "inputs.npy"), buf)
    np.save(os.path.join(root, "want.npy"), want)
    args = dict(arts, inputs=os.path.join(root, "inputs.npy"),
                want=os.path.join(root, "want.npy"), runs=ARTIFACT_RUNS,
                device=str(device))
    repo = str(Path(__file__).resolve().parent)
    proc = subprocess.run(
        [sys.executable, "-c", ARTIFACT_CHILD, json.dumps(args)], cwd=repo,
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=repo))
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("ARTIFACT_CHILD ")]
    if proc.returncode != 0 or not line:
        raise AssertionError(f"the loading process failed (rc "
                             f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    child = json.loads(line[0][len("ARTIFACT_CHILD "):])
    want_launch = {"flash_fwd_qkv": L, "gemm_epilogue": L, "ffn_chain": L} \
        if on_card else {}
    heavy = [m for m in child["modules"] for p in (
        "paddle_tpu_torch.core", "paddle_tpu_torch.layers",
        "paddle_tpu_torch.models") if m == p or m.startswith(p + ".")]
    sizes = dict(baked=os.path.getsize(arts["baked"]),
                 unbaked=os.path.getsize(arts["unbaked"]),
                 sidecar=_dir_bytes(arts["unbaked"] + ".weights"))
    for tag in ("baked", "unbaked"):
        c = child[tag]
        log(f"  14a {tag}: artifact {sizes[tag]} bytes"
            + (f" + sidecar {sizes['sidecar']} bytes" if tag == "unbaked"
               else "") + f"; export {export_s[tag]:.2f} s, load "
            f"{c['load_s']:.2f} s (a fresh process), runs "
            + ", ".join(f"{s * 1e3:.1f}" for s in c["run_s"])
            + " ms (the Predictor's "
            + ", ".join(f"{s * 1e3:.1f}" for s in pred_s) + " ms); max abs "
            f"err {c['max_abs_err']:.3e}; launches a run {c['launches']}; "
            f"plain calls {c['plain_calls']}")
        if not (c["finite"] and c["shape"] == list(want.shape)
                and c["max_abs_err"] <= ARTIFACT_ATOL
                and c["launches"] == want_launch
                and (c["plain_calls"] == 0 or not on_card)):
            raise AssertionError(f"14a {tag}: {c}")
    if heavy or "belongs to a different export" not in child["foreign"]:
        raise AssertionError(f"14a loading process: imported {heavy}; "
                             f"foreign sidecar: {child['foreign']}")
    log(f"  14a the loading process imported {len(child['modules'])} "
        f"modules of the port, none of core/layers/models; a foreign "
        f"sidecar refused at load and at export")
    report = dict(bytes=sizes, export_s=export_s, predictor_run_s=pred_s,
                  graph_ops=ops, child=child, export_refusal=export_refusal,
                  launches={k: int(v) for k, v in
                            child["baked"]["launches"].items()})
    return report, dict(pred=pred, buf=buf, want=want, exe=exe, scope=scope,
                        path=path)


def tuning_phase(device, cfg, params_np, art, root):
    """Phase 14b: the tuning plane on the card, its store a file in
    ``root``.  The ragged search (``search_geometry("ragged", ...)``) at
    the chunked engine's geometry: each block_rows candidate's time and
    its attestation against ``ragged_ref_attention``; a chunked engine
    with ``ragged_block_rows=None`` resolving the searched value from
    the store (harvest source "cache"), its greedy tokens at depth
    REFERENCE_LAYERS equal to a block_rows=1 engine's; the fusion-plan
    search at PLAN_GEOMETRY (the chain, #11, against two #10 launches);
    then a per_gemm override in force for the logits' FFN geometry: a
    new Predictor launches #11 0 and #10 3 x L times a run (the FFN's
    two GEMMs beside each layer's attention-output group), within
    LOGITS_ROW_RTOL of the chain's logits at depths 1..REFERENCE_LAYERS
    (phase 11c's gate)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda, inference
    from paddle_tpu_torch.generation import (GenerationConfig,
                                             GenerationEngine,
                                             SamplingParams)
    from paddle_tpu_torch.models import lm_params_from_numpy
    from paddle_tpu_torch.ops import autotune as at
    from paddle_tpu_torch.tuning import (TuningStore, autotune_fusion_plan,
                                         make_key, search_geometry)
    from paddle_tpu_torch.tuning.plans import plan_key

    on_card = device.type == "cuda"
    L = cfg.num_layers
    nh, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    gen = GenerationConfig(page_size=PAGE_SIZE, max_seqs=MAX_SEQS,
                           max_seq_len=MAX_SEQ_LEN, seed=SEED)
    rows = MAX_SEQS + gen.prefill_chunk
    geometry = f"r{rows}h{nh}d{dh}p{PAGE_SIZE}"
    store = TuningStore(os.environ["PADDLE_TPU_AUTOTUNE_CACHE"])
    kind = at.device_kind(device)
    out = {"device_kind": kind, "geometry": geometry}

    rep = search_geometry("ragged", geometry, reps=TUNE_REPS, device=device,
                          store=store)
    for c in rep["candidates"]:
        log(f"  14b ragged {geometry} block_rows {c['block_rows']}: "
            + (f"{c['ms']:.5f} ms, " if "ms" in c else "")
            + (f"parity {c.get('parity')}, max abs err "
               f"{c.get('max_abs_err', float('nan')):.3e}"
               if "error" not in c else f"refused: {c['error']}"))
    entry = store.get(make_key("ragged", kind, geometry, "float32"))
    bm = rep["config"]["block_rows"]
    if on_card and not (entry and entry["attestation"]["parity"] is True
                        and entry["device_kind"]
                        == torch.cuda.get_device_name(device)
                        and entry["config"]["block_rows"] == bm):
        raise AssertionError(f"14b: no attested ragged entry under the "
                             f"card's kind: {entry}")
    if not on_card:
        # nothing is timed or written on the CPU: put the winner by hand
        store.put(make_key("ragged", kind, geometry, "float32"),
                  {"block_rows": bm},
                  attestation={"parity": True, "ref": "rehearsal"})
    out["ragged"] = {k: rep[k] for k in ("config", "ms", "heuristic_ms",
                                         "speedup", "candidates")}

    cut, cut_params = cut_model(cfg, params_np, REFERENCE_LAYERS)
    prompts = make_prompts(np.random.RandomState(SEED + 1), N_PROMPTS,
                           PROMPT_LEN, cfg.vocab_size)
    greedy = SamplingParams(max_new_tokens=FLEET_NEW)
    hits0 = _series_total("autotune_cache_hits_total", kernel="ragged",
                           source="cache")
    params = lm_params_from_numpy(cut_params, device)
    tokens = {}
    ragged_launches = 0
    for tag, rows_cfg in (("resolved", None), ("block_rows_1", 1)):
        eng = GenerationEngine(cut, params, dataclasses.replace(
            gen, ragged_block_rows=rows_cfg), device=device)
        if tag == "resolved":
            hits = _series_total("autotune_cache_hits_total",
                                  kernel="ragged", source="cache") - hits0
            resolved = eng._bm
        eng.warmup()
        _cuda.reset_launches()
        res = eng.generate(prompts, sampling=greedy)
        steps = eng.stats.snapshot()["steps"]
        tokens[tag] = [list(r.tokens) for r in res]
        got = _cuda.LAUNCHES["ragged_paged_attention"]
        if tag == "resolved":
            ragged_launches = got
        if on_card and got != REFERENCE_LAYERS * steps:
            raise AssertionError(f"14b {tag}: #1 launched {got} times in "
                                 f"{steps} steps")
        del eng
    parity = float(np.mean([a == b for a, b in zip(tokens["resolved"],
                                                   tokens["block_rows_1"])]))
    log(f"  14b engine (ragged_block_rows=None): resolved block_rows "
        f"{resolved} from the store (harvest source=cache +{hits}); "
        f"greedy tokens at depth {REFERENCE_LAYERS} equal to a "
        f"block_rows=1 engine's: parity {parity}")
    if resolved != bm or hits != 1 or parity != 1.0:
        raise AssertionError(f"14b engine: resolved {resolved} (store "
                             f"{bm}), cache hits {hits}, parity {parity}")
    out["engine"] = dict(resolved=resolved, parity=parity,
                         launches=ragged_launches)

    M, K, F, N = PLAN_GEOMETRY
    plan = autotune_fusion_plan(M, K, F, N, reps=TUNE_REPS, device=device,
                                store=store)
    log(f"  14b fusion plan at M {M} K {K} F {F} N {N}: chain "
        f"{plan['chain_ms']} ms, per_gemm {plan['per_gemm_ms']} ms, "
        f"winner {plan['plan']} (max abs err vs reference_ffn_chain "
        f"{plan['max_abs_err']})")
    if set(plan["max_abs_err"]) != {"chain", "per_gemm"} or (
            on_card and plan["plan"] not in ("chain", "per_gemm")):
        raise AssertionError(f"14b plan search: {plan}")
    out["plan"] = {k: plan[k] for k in ("plan", "chain_ms", "per_gemm_ms",
                                        "speedup", "max_abs_err")}

    # the chain's logits at depths 1..REFERENCE_LAYERS, before the override
    bs_cuts = {}
    for depth in range(1, REFERENCE_LAYERS + 1):
        cmain, _, cout = _logits_program(dataclasses.replace(
            cfg, num_layers=depth))
        f, = art["exe"].run(cmain.clone(for_test=True),
                            feed={"src_ids": art["buf"]},
                            fetch_list=[cout.name], scope=art["scope"])
        bs_cuts[depth] = f
    Mr = N_PROMPTS * MAX_SEQ_LEN
    store.put(plan_key(kind, Mr, cfg.hidden_size, cfg.ffn_size,
                       cfg.hidden_size, "float32"), {"plan": "per_gemm"},
              kernel="fusion_plan", attestation={"parity": True,
                                                 "ref": "override"})
    config = inference.Config(art["path"])
    if not on_card:
        config.disable_gpu()
    pred = inference.create_predictor(config)
    pred.run([art["buf"]])
    _cuda.reset_launches()
    with _PlainCalls() as plain:
        over, = pred.run([art["buf"]])
    launches = _launch_gate(dict(_cuda.LAUNCHES), {
        "flash_fwd_qkv": L, "gemm_epilogue": 3 * L}, "the per_gemm logits",
        on_card)
    if on_card and plain.calls:
        raise AssertionError("the per_gemm logits called plain versions")
    rel = {}
    for depth, chain in bs_cuts.items():
        cmain, _, cout = _logits_program(dataclasses.replace(
            cfg, num_layers=depth))
        g, = art["exe"].run(cmain.clone(for_test=True),
                            feed={"src_ids": art["buf"]},
                            fetch_list=[cout.name], scope=art["scope"])
        rel[depth] = float(_rows_rel(g, chain).max())
    rel_full = float(_rows_rel(over, art["want"]).max())
    log(f"  14b per_gemm override in force: launches a logits run "
        f"{launches}; per-position relative error against the chain's "
        f"logits, max: " + ", ".join(f"depth {d} {v:.3e}"
                                    for d, v in rel.items())
        + f" (gate {LOGITS_ROW_RTOL:g}); full depth {rel_full:.3e} "
        f"(reported)")
    if any(v > LOGITS_ROW_RTOL for v in rel.values()):
        raise AssertionError(f"14b: per_gemm logits off the chain's: {rel}")
    out["override"] = dict(launches=launches, rel_err_by_depth=rel,
                           rel_err_full=rel_full)
    return out


def _fleet_results(futs, timeout=600):
    return [list(f.result(timeout=timeout).tokens) for f in futs]


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _kill_in_flight(gr, victim):
    """SIGKILL ``victim``'s process once the router has a request in
    flight on it; returns the kill's time."""
    import signal

    model = gr.cfg.default_model
    _wait(lambda: gr.fleet_signals()[model]["inflight"] > 0, 60.0,
          "a request in flight")
    t0 = time.perf_counter()
    os.kill(victim.proc.pid, signal.SIGKILL)
    return t0


def fleet_phase(device, cfg, root, model="base"):
    """Phase 14c: the fleet over worker processes on the one card: a
    GenerationRouter over a WorkerPool of chunked engines
    (``cluster_engine`` at depth REFERENCE_LAYERS, phase 9's spawn
    path), requests of FLEET_NEW greedy tokens held to one in-process
    engine's tokens.  In order: the Autoscaler scales 1 -> 2 under a
    burst; the tuning verbs (harvest, a search on the idle rank, a push,
    every worker's pull); the Autoscaler drains 2 -> 1 when idle; a
    RollingSwap onto the same weights under traffic, then onto another
    seed's (canary abort, ``fleet.rollout`` degraded, the old version
    serving); the Supervisor respawns a SIGKILLed worker with requests
    in flight, then, its budget spent, degrades
    ``fleet.supervisor:<model>``, fires one incident bundle and the
    router fails the parked request with the model named.  One card runs
    every worker: the phase measures the control plane (spawn to
    attached, drain, respawn, a swap), not capacity."""
    from paddle_tpu_torch.cluster import (ClusterConfig, GenerationRouter,
                                          WorkerPool, WorkerSpec)
    from paddle_tpu_torch.fleet import (ROLLOUT_DEGRADE_KEY, Autoscaler,
                                        HysteresisPolicy, RollingSwap,
                                        Supervisor)
    from paddle_tpu_torch.generation import SamplingParams
    from paddle_tpu_torch.observability import flightrec
    from paddle_tpu_torch.resilience.retry import degradations
    from paddle_tpu_torch.tuning import TuningService, TuningStore

    kw = dict(model=model, layers=REFERENCE_LAYERS,
              device=None if device.type == "cuda" else "cpu",
              tune_dir=str(root))
    spec = WorkerSpec("chip_smoke:cluster_engine", kw, role="generate")
    greedy = SamplingParams(max_new_tokens=FLEET_NEW)
    prompts = make_prompts(np.random.RandomState(SEED + 1), FLEET_BURST,
                           PROMPT_LEN, cfg.vocab_size)
    ref_engine = cluster_engine(**dict(kw, device=str(device), tune_dir=None))
    ref = [list(r.tokens) for r in ref_engine.generate(prompts,
                                                       sampling=greedy)]
    del ref_engine
    out = {}
    pool = gr = scaler = sup = None
    flightrec.arm()
    try:
        t0 = time.perf_counter()
        pool = WorkerPool(spec, 1, log_dir=str(FLEET_LOG_DIR),
                          ready_timeout_s=CLUSTER_READY_S)
        pool.wait_ready()
        out["first_ready_s"] = time.perf_counter() - t0
        gr = GenerationRouter(pool, config=ClusterConfig(
            reroute_wait_for_respawn=True, respawn_wait_timeout_s=600.0))
        scaler = Autoscaler(gr, pool, policy=HysteresisPolicy(
            min_workers=1, max_workers=2, high_queue_depth=4,
            up_ticks=1, down_ticks=2, cooldown_s=0.0))

        # the burst: 1 -> 2
        futs = [gr.submit(p, sampling=greedy) for p in prompts]
        t0 = time.perf_counter()
        up = scaler.tick()
        out["spawn_to_attached_s"] = time.perf_counter() - t0
        got = _fleet_results(futs)
        n_workers = len(gr.workers_for())
        log(f"  14c autoscaler: burst of {len(prompts)} -> {up}; spawn to "
            f"attached {out['spawn_to_attached_s']:.2f} s; workers "
            f"{n_workers}; tokens equal to one engine's: {got == ref}")
        if not (up and up[0]["action"] == "up" and up[0]["ok"]
                and n_workers == 2 and got == ref):
            raise AssertionError(f"14c scale-up: {up}, workers {n_workers}"
                                 f", parity {got == ref}")

        # the tuning verbs over the two workers
        handles = gr.workers_for()
        svc = TuningService(gr.workers_for, store=TuningStore(
            os.path.join(root, "router_tune.json")), reps=TUNE_REPS,
            device=device)
        observed = svc.harvest(include_local=False)
        # the workers' engines: MAX_SEQS slots + a 16-row chunk
        geometry = (f"r{MAX_SEQS + min(16, MAX_SEQ_LEN)}h{cfg.num_heads}"
                    f"d{cfg.hidden_size // cfg.num_heads}p{PAGE_SIZE}")
        ragged = [r for r in observed if r["kernel"] == "ragged"
                  and r["geometry"] == geometry]
        idle = handles[-1]
        search = idle.call("tuning_search", kernel="ragged",
                           geometry=ragged[0]["geometry"], reps=TUNE_REPS,
                           plan_search=False,
                           device=None if device.type == "cuda" else "cpu")
        pulled = idle.call("tuning_pull")["entries"]
        if device.type != "cuda":
            # the CPU times nothing and persists nothing: attest by hand
            from paddle_tpu_torch.tuning import make_key

            key = make_key("ragged", "cpu", ragged[0]["geometry"], "float32")
            pulled = {key: {"config": {"block_rows": 1}, "version": 1,
                            "attestation": {"parity": True,
                                            "ref": "rehearsal"}}}
        svc.store.merge(pulled)
        pushed = svc.push()
        pulls = [h.call("tuning_pull")["entries"] for h in handles]
        keys = sorted(pulled)
        seen = [all(k in p and p[k]["attestation"]["parity"] is True
                    for k in keys) for p in pulls]
        seen_geoms = [(r["kernel"], r["geometry"], r["count"])
                      for r in observed]
        log(f"  14c tuning: harvested {seen_geoms}; "
            f"searched on rank {idle.rank}: {search['report']['config']} "
            f"({search['report']['ms']} ms); pushed to "
            f"{sorted(pushed)}; every worker's pull holds {keys}: {seen}")
        if not (ragged and keys and all(seen)
                and all(r.get("ok") for r in pushed.values())):
            raise AssertionError(f"14c tuning verbs: {pushed}, {seen}")
        out["tuning"] = dict(observed=observed, search=search["report"],
                             keys=keys, pushed={k: {
                                 "applied": v.get("applied"),
                                 "rejected": v.get("rejected")}
                                 for k, v in pushed.items()})

        # idle: 2 -> 1
        scaler.tick()
        t0 = time.perf_counter()
        down = scaler.tick()
        out["drain_s"] = time.perf_counter() - t0
        n_workers = len(gr.workers_for())
        log(f"  14c autoscaler idle: {down}; drain {out['drain_s']:.3f} s; "
            f"workers {n_workers}")
        if not (down and down[0]["action"] == "down" and down[0]["ok"]
                and n_workers == 1):
            raise AssertionError(f"14c scale-down: {down}")

        # the rolling swap onto the same weights, under traffic
        futs = [gr.submit(p, sampling=greedy)
                for p in prompts[:FLEET_REQUESTS]]
        t0 = time.perf_counter()
        roll = RollingSwap(gr, pool, spawn_kwargs={"spec": spec}).run()
        out["swap_s_per_worker"] = (time.perf_counter() - t0) / max(
            1, roll.replaced)
        got = _fleet_results(futs)
        log(f"  14c rolling swap, same weights: replaced {roll.replaced}, "
            f"aborted {roll.aborted}; {out['swap_s_per_worker']:.2f} s a "
            f"worker; tokens under the swap equal: "
            f"{got == ref[:FLEET_REQUESTS]}")
        if roll.aborted or roll.replaced != 1 \
                or got != ref[:FLEET_REQUESTS]:
            raise AssertionError(f"14c same-weights swap: {roll}")
        # onto another seed's weights: the canary aborts
        other = WorkerSpec(spec.factory, dict(kw, seed=SEED + 1),
                           role="generate")
        bad = RollingSwap(gr, pool, spawn_kwargs={"spec": other}).run()
        after = [list(r.tokens) for r in gr.generate(
            prompts[:2], sampling=greedy)]
        log(f"  14c rolling swap, another seed: aborted {bad.aborted} "
            f"({bad.reason}); fleet.rollout degraded "
            f"{degradations.is_degraded(ROLLOUT_DEGRADE_KEY)}; the old "
            f"version serves: {after == ref[:2]}")
        if not (bad.aborted and bad.reason == "parity canary mismatch"
                and degradations.is_degraded(ROLLOUT_DEGRADE_KEY)
                and after == ref[:2]):
            raise AssertionError(f"14c mismatched swap: {bad}")
        out["rollout_abort"] = bad.reason

        # the supervisor: a SIGKILL with requests in flight
        sup = Supervisor(gr, pool, max_respawns=1, base_delay=0.0,
                         stability_window_s=3600.0).start()
        victim = gr.workers_for()[0]
        futs = [gr.submit(p, sampling=greedy)
                for p in prompts[:FLEET_REQUESTS]]
        t0 = _kill_in_flight(gr, victim)
        _wait(lambda: any(h.rank != victim.rank and h.alive
                          for h in gr.workers_for()), CLUSTER_READY_S,
              "the respawn")
        out["respawn_s"] = time.perf_counter() - t0
        got = _fleet_results(futs)
        log(f"  14c supervisor: worker {victim.rank} killed, respawned in "
            f"{out['respawn_s']:.2f} s; in-flight requests completed with "
            f"the reference tokens: {got == ref[:FLEET_REQUESTS]}")
        if got != ref[:FLEET_REQUESTS]:
            raise AssertionError("14c: requests in flight at the kill "
                                 "lost their tokens")
        # the budget spent: the next crash degrades the model
        victim = gr.workers_for()[0]
        triggers = []
        listener = lambda *t: triggers.append(t)   # noqa: E731
        flightrec.add_trigger_listener(listener)
        fut = gr.submit(prompts[0], sampling=greedy)
        _kill_in_flight(gr, victim)
        key = f"fleet.supervisor:{gr.cfg.default_model}"
        _wait(lambda: degradations.is_degraded(key), 120.0,
              "the supervisor's verdict")
        try:
            fut.result(timeout=60)
            parked = "served"
        except Exception as e:  # noqa: BLE001 — the expected failure
            parked = f"{type(e).__name__}: {e}"
        flightrec.remove_trigger_listener(listener)
        fired = [t for t in triggers if t[0] == "degrade"
                 and t[2].get("model") == str(gr.cfg.default_model)]
        log(f"  14c supervisor budget spent: {key} degraded; flight "
            f"triggers {[t[0] for t in triggers]} (the supervisor's "
            f"degrade incidents: {len(fired)}); the parked request: "
            f"{parked}")
        if not (len(fired) == 1 and "degraded permanently" in parked
                and repr(gr.cfg.default_model) in parked):
            raise AssertionError(f"14c exhausted supervisor: triggers "
                                 f"{triggers}, parked {parked}")
        out["triggers"] = [t[0] for t in triggers]
        out["parked_failure"] = parked
        snap = gr.stats()
        out["router"] = {k: snap[k] for k in (
            "requests_ok", "requests_failed", "reroutes")}
        out["degradations"] = [e["key"] for e in snap["kernel_degradations"]]
    except Exception:
        if pool is not None:
            _log_tails({"fleet": pool})
        raise
    finally:
        for part in (sup, scaler):
            if part is not None:
                part.stop()
        if gr is not None:
            gr.close()
        if pool is not None:
            pool.close()
        flightrec.disarm(clear=True)
        degradations.reset()
    left = [h.proc.pid for h in (pool.handles() if pool else [])
            if h.proc is not None and h.proc.poll() is None]
    if left:
        raise AssertionError(f"worker processes left running: {left}")
    return out


def fleet_tuning_artifact_phase(device, gen_cfg, params_np, cfg=None,
                                model="base"):
    """Phase 14: the serving artifact (14a), the tuning plane (14b) and
    the fleet (14c) at BertConfig.base() width (``cfg``: phase 3's serving
    LM at dropout 0 unless given), every file in a temporary directory
    removed in a finally; the tuning store is a file there."""
    import tempfile

    from paddle_tpu_torch.models import BertConfig

    cfg = cfg or dataclasses.replace(BertConfig.base(), initializer_range=0.6,
                                     hidden_dropout=0.0, attn_dropout=0.0)
    root = tempfile.mkdtemp(prefix="chip_smoke_p14_")
    saved = os.environ.get("PADDLE_TPU_AUTOTUNE_CACHE")
    os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = os.path.join(root,
                                                           "autotune.json")
    try:
        report, art = artifact_phase(device, cfg, root)
        report["tuning"] = tuning_phase(device, cfg, params_np, art, root)
        del art
        report["fleet"] = fleet_phase(device, cfg, root, model=model)
    finally:
        if saved is None:
            os.environ.pop("PADDLE_TPU_AUTOTUNE_CACHE", None)
        else:
            os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = saved
        shutil.rmtree(root, ignore_errors=True)
    # each kernel's launches on its main runs: an artifact run (14a), the
    # resolved engine's generate and the per_gemm logits run (14b)
    launches = collections.Counter(report["launches"])
    launches.update(report["tuning"]["override"]["launches"])
    launches["ragged_paged_attention"] += \
        report["tuning"]["engine"]["launches"]
    report["launches"] = {k: v for k, v in launches.items() if v}
    return report



# -- phase 15: parallelism in the Program front end ----------------------------

#: 15a/15c steps, 15b ranks' depth and steps, 15d's MoE shape
PAR_STEPS = 5
PAR_DEPTH, PAR_RANK_STEPS = 2, 3
PIPE_STAGES, PIPE_MICROBATCHES = 4, 4
MOE_TOKENS, MOE_EXPERTS, MOE_TOP_K, MOE_STEPS, MOE_CPU_STEPS = 4096, 8, 2, 5, 2
PAR_RANK_TIMEOUT_S = 600.0
#: 15b's mesh cases: (name, mesh axes, ZeRO-1, Megatron rules)
PAR_CASES = (("data2", {"data": 2}, False, False),
             ("zero1", {"data": 2}, True, False),
             ("model2", {"model": 2}, False, True))
#: the kernels of 15a's step, each once per layer per step
DP_KERNELS = FUSED_STEP_KERNELS


def _zero_dropout(cfg, layers=None):
    return dataclasses.replace(cfg, hidden_dropout=0.0, attn_dropout=0.0,
                               **({} if layers is None else
                                  {"num_layers": layers}))


def _all_labels_batch(vocab, device):
    """train_batch's token ids with a label at every position (no mask),
    so every pipeline microbatch holds the same count
    (``_bert_pipe_case``'s feed)."""
    feed = train_batch(vocab, device)
    feed["input_mask"] = feed["input_mask"].new_ones(
        feed["input_mask"].shape)
    feed["masked_labels"] = feed["src_ids"][..., None].clone()
    return feed


def dp_world1_phase(device, cfg):
    """15a: phase 5's program at dropout 0 through
    ``CompiledProgram(main).with_data_parallel()`` over a one-rank NCCL
    group (a file store in a temporary directory), against plain
    ``Executor.run`` steps from the same weights: PAR_STEPS steps each,
    losses and parameters bit-equal, the fused kernels once per layer per
    step; then both timed in turns and one profiled data-parallel step
    (the NCCL kernels' device ms)."""
    import tempfile

    import torch
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda

    on_card = device.type == "cuda"
    cfg = _zero_dropout(cfg)
    L = cfg.num_layers
    main, startup, loss, _, params = build_train(cfg)
    exe = _executor(device)
    feed = train_batch(cfg.vocab_size, device)
    scopes = {"plain": pt.Scope(), "dp": pt.Scope()}
    exe.run(startup, scope=scopes["plain"])
    _load(scopes["dp"], _snapshot(scopes["plain"], main), main)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if on_card else "gloo",
                                store=dist.FileStore(f"{tmp}/store", 1),
                                rank=0, world_size=1)
        try:
            dp = pt.CompiledProgram(main).with_data_parallel(
                places=[exe.place])
            targets = {"plain": main, "dp": dp}
            for name in ("plain", "dp"):
                with _PlainCalls() as plain:
                    _cuda.reset_launches()
                    out[name] = [exe.run(targets[name], feed=feed,
                                         fetch_list=[loss],
                                         scope=scopes[name],
                                         return_numpy=False)[0]
                                 for _ in range(PAR_STEPS)]
                    sync(device)
                    out[name + "_launches"] = {
                        k: _cuda.LAUNCHES.get(k, 0) for k in DP_KERNELS}
                    out[name + "_plain_calls"] = plain.calls
            unequal = [p for p in params if not torch.equal(
                scopes["plain"].find_var(p), scopes["dp"].find_var(p))]
            turns = {"plain": [], "dp": []}
            for name in ("dp", "plain", "plain", "dp"):
                t0 = time.perf_counter()
                for _ in range(COMPARE_STEPS):
                    exe.run(targets[name], feed=feed, fetch_list=[loss],
                            scope=scopes[name], return_numpy=False)
                sync(device)
                turns[name].append((time.perf_counter() - t0)
                                   / COMPARE_STEPS * 1e3)
            prof = _profile_nccl(exe, dp, feed, loss, scopes["dp"], device)
            degree = dp.data_parallel_degree
        finally:
            dist.destroy_process_group()
    losses = {k: [float(x) for x in out[k]] for k in ("plain", "dp")}
    same_losses = all(torch.equal(a, b) for a, b in zip(out["plain"],
                                                          out["dp"]))
    want = L * PAR_STEPS if on_card else 0
    log(f"  15a data parallel at world 1 (one-rank "
        f"{'NCCL' if on_card else 'gloo'} group, data_parallel_degree "
        f"{degree}), {TRAIN_BATCH} x {TRAIN_SEQ}, dropout 0: losses "
        + " ".join(f"{x:.6f}" for x in losses["dp"]) + f"; bit-equal to "
        f"the plain steps: losses {same_losses}, parameters "
        f"{len(params) - len(unequal)}/{len(params)}; launches "
        f"{out['dp_launches']} (= {L} x {PAR_STEPS} = {want} each); step "
        f"in turns dp {turns['dp'][0]:.3f}/{turns['dp'][1]:.3f}, plain "
        f"{turns['plain'][0]:.3f}/{turns['plain'][1]:.3f} ms; profiled dp "
        f"step: device kernels {prof.get('device_ms_per_step', 'not measured')}"
        f" ms, {prof.get('nccl_kernels_per_step', 'not measured')} NCCL "
        f"kernels taking {prof.get('nccl_ms_per_step', 'not measured')} ms")
    if not same_losses or unequal:
        raise AssertionError(f"15a: the data-parallel step is not the plain "
                             f"one: losses {losses}, unequal {unequal[:5]}")
    if any(n != want for n in out["dp_launches"].values()):
        raise AssertionError(f"15a: launches {out['dp_launches']}, expected "
                             f"{want} each")
    if on_card and out["dp_plain_calls"]:
        raise AssertionError("15a: a plain kernel version ran on the card")
    return dict(losses=losses["dp"], launches=out["dp_launches"],
                degree=degree, step_ms=sum(turns["dp"]) / 2,
                plain_step_ms=sum(turns["plain"]) / 2, turns_ms=turns,
                profile=prof)


def _profile_nccl(exe, program, feed, loss, scope, device):
    """One step under torch.profiler: its device time and the NCCL
    kernels' share."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        exe.run(program, feed=feed, fetch_list=[loss], scope=scope)
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    out = _span_summary(prof, wall_us, 1, ("nccl", "Nccl"))
    if out is None:
        return dict(wall_ms=wall_us / 1e3)
    from torch.autograd import DeviceType

    nccl = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and "nccl" in e.name.lower())
    return dict(wall_ms=wall_us / 1e3,
                device_ms_per_step=out["device_ms_per_step"],
                nccl_kernels_per_step=nccl,
                nccl_ms_per_step=out["named_kernels_ms_per_step"],
                device_busy_share=out["device_busy_share"])


def build_moe(pkg_ops=None):
    """``_dryrun_expert``'s program at BERT-base FFN width: x [N, 768],
    MOE_EXPERTS experts of hidden 3072, top MOE_TOP_K, the squared error
    against y plus 0.01 x the aux loss, Adam(1e-3)."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED + 15
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.data("x", [None, 768])
        y = pt.data("y", [None, 768])
        out, aux = pt.layers.moe(x, num_experts=MOE_EXPERTS,
                                 hidden_size=3072, top_k=MOE_TOP_K)
        loss = pt.layers.elementwise_add(
            pt.layers.mean(pt.layers.square_error_cost(out, y)),
            pt.layers.scale(aux, 0.01))
        pt.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def moe_feed(device):
    rng = np.random.RandomState(SEED + 16)
    x = rng.randn(MOE_TOKENS, 768).astype(np.float32)
    return _on(device, {"x": x, "y": np.tanh(x[:, ::-1]).astype(np.float32)})


def _run_steps(exe, program, feed, loss, scope, steps):
    return [float(exe.run(program, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(steps)]


def _par_rank(rank, store, out_dir, cfg_dict, weights_path):
    """One of 15b/15d's two gloo ranks on the card (or the CPU in a
    rehearsal): PAR_CASES on the depth-PAR_DEPTH program from its
    startup's seed, then the MoE program at {expert: 2} from the
    parent's weights."""
    import torch
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import set_strict_fp32
    from paddle_tpu_torch.compiler import BuildStrategy, CompiledProgram
    from paddle_tpu_torch.models import BertConfig, tp_sharding_rules
    from paddle_tpu_torch.observability import get_registry
    from paddle_tpu_torch.parallel import build_mesh, moe_sharding_rules
    from paddle_tpu_torch.tools.mem_report import optimizer_state_report

    set_strict_fp32()
    device = torch.device(cfg_dict.pop("device"))
    globals().update(cfg_dict.pop("globals"))
    cfg = BertConfig(**cfg_dict)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    res = {}
    try:
        exe = _executor(device)
        feed = train_batch(cfg.vocab_size, device)
        for name, axes, reduce, rules in PAR_CASES:
            main, startup, loss, _, _ = build_train(cfg)
            scope = pt.Scope()
            exe.run(startup, scope=scope)
            bs = BuildStrategy()
            if reduce:
                bs.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
            target = CompiledProgram(main, build_strategy=bs).with_sharding(
                build_mesh(axes, device_type=device.type),
                param_rules=tp_sharding_rules() if rules else None)
            t0 = time.perf_counter()
            losses = _run_steps(exe, target, feed, loss, scope,
                                PAR_RANK_STEPS)
            sync(device)
            r = dict(losses=losses, wall_s=time.perf_counter() - t0)
            if reduce:
                r["report"] = optimizer_state_report(
                    get_registry().snapshot())
            if rules:
                r["qkv_shard"] = tuple(scope.find_var(
                    "encoder.layer0.attn.qkv.w").shape)
            res[name] = r
            del scope
        main, _, loss = build_moe()
        scope = pt.Scope()
        w = np.load(weights_path)
        pt.io.load_params(scope, {n: w[n] for n in w.files}, device,
                          program=main)
        target = CompiledProgram(main).with_sharding(
            build_mesh({"expert": 2}, device_type=device.type),
            param_rules=moe_sharding_rules())
        t0 = time.perf_counter()
        losses = _run_steps(exe, target, moe_feed(device), loss, scope,
                            MOE_CPU_STEPS)
        res["expert2"] = dict(losses=losses,
                              wall_s=time.perf_counter() - t0,
                              w1_shard=tuple(scope.find_var(next(
                                  p.name for p in main.all_parameters()
                                  if "expert_w1" in p.name)).shape))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def par_ranks_phase(device, cfg, moe_weights_path):
    """15b and 15d's expert axis: two gloo ranks sharing the card
    (torch.multiprocessing, spawn), each building the depth-PAR_DEPTH
    program from the startup's seed and the MoE program from the parent's
    weights.  Returns their results."""
    import tempfile

    import torch.multiprocessing as mp

    cfg_dict = dict(dataclasses.asdict(cfg), device=str(device),
                    globals=dict(TRAIN_BATCH=TRAIN_BATCH,
                                 TRAIN_SEQ=TRAIN_SEQ,
                                 MOE_TOKENS=MOE_TOKENS,
                                 MOE_EXPERTS=MOE_EXPERTS,
                                 MOE_CPU_STEPS=MOE_CPU_STEPS,
                                 PAR_RANK_STEPS=PAR_RANK_STEPS))
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _par_rank, args=(f"{tmp}/store", tmp, cfg_dict,
                             moe_weights_path),
            nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + PAR_RANK_TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise AssertionError(f"15b: the gloo ranks still run after "
                                     f"{PAR_RANK_TIMEOUT_S} s")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return ranks


def pipeline_full_phase(device, cfg):
    """15c: build_bert_pretrain(cfg, TRAIN_SEQ, num_pipeline_stages=
    PIPE_STAGES) under PipelineOptimizer(Adam, num_microbatches=
    PIPE_MICROBATCHES), its stages in sequence under
    torch.utils.checkpoint, against the unfused plain program from the
    same weights, at dropout 0 with a label at every position: PAR_STEPS
    steps each, losses within PARITY_LOSS_TOL, the unfused kernels'
    launches a step as the recomputed schedule implies, step ms and peak
    memory of both."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.models import build_bert_pretrain
    from paddle_tpu_torch.ops import flash_attention as fa

    on_card = device.type == "cuda"
    cfg = _zero_dropout(cfg)
    L, M = cfg.num_layers, PIPE_MICROBATCHES
    exe = _executor(device)
    feed = _all_labels_batch(cfg.vocab_size, device)
    bs = pt.BuildStrategy()
    bs.fuse_epilogues = False
    pmain, pstart = pt.Program(), pt.Program()
    pstart.random_seed = SEED + 11
    with pt.program_guard(pmain, pstart), pt.unique_name.guard():
        ploss, _, cuts = build_bert_pretrain(
            cfg, seq_len=TRAIN_SEQ, num_pipeline_stages=PIPE_STAGES)
        pt.optimizer.PipelineOptimizer(
            pt.optimizer.Adam(TRAIN_LR), cut_list=cuts,
            num_microbatches=M).minimize(ploss)
    main, _, loss, _, _ = build_train(cfg)
    scope = pt.Scope()
    exe.run(pstart, scope=scope)
    weights = _snapshot(scope, pmain)
    runs = {}
    for name, program, lv in (("pipeline", pmain, ploss),
                              ("unfused", pt.CompiledProgram(
                                  main, build_strategy=bs), loss)):
        scope = pt.Scope()
        _load(scope, weights, pmain if name == "pipeline" else main)
        sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        first = float(exe.run(program, feed=feed, fetch_list=[lv],
                              scope=scope)[0])
        with _PlainCalls() as plain:
            _cuda.reset_launches()
            t0 = time.perf_counter()
            rest = [exe.run(program, feed=feed, fetch_list=[lv],
                            scope=scope, return_numpy=False)[0]
                    for _ in range(PAR_STEPS - 1)]
            sync(device)
            wall = time.perf_counter() - t0
            launches = {k: n for k, n in _cuda.LAUNCHES.items() if n}
        runs[name] = dict(
            losses=[first] + [float(x) for x in rest],
            step_ms=wall / (PAR_STEPS - 1) * 1e3, launches=launches,
            plain_calls=plain.calls, plans=_plan_kinds(
                pmain if name == "pipeline" else main),
            peak=torch.cuda.max_memory_allocated(device) if on_card else 0)
        del scope
    p, u = runs["pipeline"], runs["unfused"]
    steps = PAR_STEPS - 1
    want = ({fa.FWD: 2 * L * M * steps, fa.DQ: L * M * steps,
             fa.DKV: L * M * steps} if on_card else {})
    dloss = max(abs(a - b) for a, b in zip(p["losses"], u["losses"]))
    log(f"  15c pipeline, {PIPE_STAGES} stages in sequence x {M} "
        f"microbatches, {TRAIN_BATCH} x {TRAIN_SEQ}, dropout 0: losses "
        + " ".join(f"{x:.6f}" for x in p["losses"]) + f"; unfused plain "
        + " ".join(f"{x:.6f}" for x in u["losses"]) + f"; max |dloss| "
        f"{dloss:.3e}; {p['step_ms']:.3f} ms/step against "
        f"{u['step_ms']:.3f}; peak {p['peak'] / 2**30:.3f} GiB against "
        f"{u['peak'] / 2**30:.3f}; launches {p['launches']} over {steps} "
        f"steps (want {want})")
    if any(plan is not None for plan in p["plans"]):
        raise AssertionError(f"15c: fusion plan {p['plans']}")
    if p["launches"] != want:
        raise AssertionError(f"15c: launches {p['launches']}, expected "
                             f"{want}")
    if on_card and p["plain_calls"]:
        raise AssertionError("15c: a plain kernel version ran on the card")
    if not dloss < PARITY_LOSS_TOL:
        raise AssertionError("15c: the pipelined losses diverge")
    per_step = {k: n // steps for k, n in p["launches"].items()}
    return dict(losses=p["losses"], unfused_losses=u["losses"],
                max_dloss=dloss, step_ms=p["step_ms"],
                unfused_step_ms=u["step_ms"], peak_bytes=p["peak"],
                unfused_peak_bytes=u["peak"], launches_per_step=per_step,
                launches=p["launches"])


def moe_phase(device, root):
    """15d: the MoE program at x [MOE_TOKENS, 768] on one rank for
    MOE_STEPS steps (step ms, the dispatch tensor's bytes, peak memory);
    its first MOE_CPU_STEPS losses against the same program on this
    machine's CPU from the same weights.  Writes the weights to
    ``root`` for the expert-axis ranks; returns (report, weights path)."""
    import torch

    import paddle_tpu_torch as pt

    on_card = device.type == "cuda"
    main, startup, loss = build_moe()
    exe = _executor(device)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    weights = {n: t.detach().cpu().numpy()
               for n, t in _snapshot(scope, main).items()}
    path = os.path.join(root, "moe_weights.npz")
    np.savez(path, **weights)
    feed = moe_feed(device)
    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    first = _run_steps(exe, main, feed, loss, scope, MOE_CPU_STEPS)
    sync(device)
    t0 = time.perf_counter()
    rest = _run_steps(exe, main, feed, loss, scope,
                      MOE_STEPS - MOE_CPU_STEPS)
    sync(device)
    step_ms = (time.perf_counter() - t0) / (MOE_STEPS - MOE_CPU_STEPS) * 1e3
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del scope
    cpu = pt.Executor(pt.CPUPlace())
    cscope = pt.Scope()
    pt.io.load_params(cscope, weights, "cpu", program=main)
    cfeed = {n: t.cpu() for n, t in feed.items()}
    t0 = time.perf_counter()
    cpu_losses = _run_steps(cpu, main, cfeed, loss, cscope, MOE_CPU_STEPS)
    cpu_s = time.perf_counter() - t0
    capacity = max(1, int(MOE_TOP_K * MOE_TOKENS / MOE_EXPERTS * 2.0))
    dispatch_bytes = MOE_TOKENS * MOE_EXPERTS * capacity * 4
    dloss = max(abs(a - b) for a, b in zip(first, cpu_losses))
    log(f"  15d MoE x [{MOE_TOKENS}, 768], {MOE_EXPERTS} experts of 3072, "
        f"top {MOE_TOP_K}, capacity {capacity}: losses "
        + " ".join(f"{x:.6f}" for x in first + rest) + f"; CPU "
        + " ".join(f"{x:.6f}" for x in cpu_losses) + f" ({cpu_s:.1f} s); "
        f"max |dloss| {dloss:.3e}; {step_ms:.3f} ms/step; dispatch "
        f"{dispatch_bytes} bytes; peak {peak / 2**30:.3f} GiB")
    if not all(np.isfinite(first + rest)):
        raise AssertionError("15d: a MoE loss is not finite")
    if not dloss < PARITY_LOSS_TOL:
        raise AssertionError("15d: the card's MoE losses leave the CPU's")
    return dict(losses=first + rest, cpu_losses=cpu_losses, max_dloss=dloss,
                step_ms=step_ms, dispatch_bytes=dispatch_bytes,
                capacity=capacity, peak_bytes=peak), path


def parallel_phase(device, cfg, phase5_step_ms=float("nan")):
    """Phase 15: data parallel at world 1 (15a), two gloo ranks on the
    card (15b: data 2, ZeRO-1, model 2 at depth PAR_DEPTH; 15d's expert
    axis), the pipeline at full width (15c), MoE at BERT-base FFN width
    (15d)."""
    import tempfile

    import paddle_tpu_torch as pt

    out = {"phase5_step_ms": phase5_step_ms}
    out["dp"] = dp_world1_phase(device, cfg)
    out["pipeline"] = pipeline_full_phase(device, cfg)
    with tempfile.TemporaryDirectory() as root:
        out["moe"], path = moe_phase(device, root)
        cut = _zero_dropout(cfg, PAR_DEPTH)
        # the one-rank references of 15b: the same programs, plain
        exe = _executor(device)
        feed = train_batch(cut.vocab_size, device)
        main, startup, loss, _, _ = build_train(cut)
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        t0 = time.perf_counter()
        ref = _run_steps(exe, main, feed, loss, scope, PAR_RANK_STEPS)
        sync(device)
        ref_ms = (time.perf_counter() - t0) / PAR_RANK_STEPS * 1e3
        del scope
        t0 = time.perf_counter()
        ranks = par_ranks_phase(device, cut, path)
        spawn_s = time.perf_counter() - t0
    moe_ref = out["moe"]["losses"][:MOE_CPU_STEPS]
    cases = {}
    for name, _, reduce, rules in PAR_CASES + (("expert2", None, False,
                                                False),):
        want = moe_ref if name == "expert2" else ref
        got = [r[name] for r in ranks]
        d = max(abs(a - b) for r in got for a, b in zip(r["losses"], want))
        cases[name] = dict(losses=got[0]["losses"], max_dloss=d,
                           step_ms=got[0]["wall_s"] / len(want) * 1e3)
        if not d < PARITY_LOSS_TOL:
            raise AssertionError(f"15b {name}: losses {[r['losses'] for r in got]}"
                                 f" against the one-rank {want}")
        if reduce:
            rep = got[0]["report"]
            cases[name]["report"] = rep
            if not (rep and rep["dp_degree"] == 2
                    and rep["ratio_vs_ideal"] < 1.5):
                raise AssertionError(f"15b zero1: optimizer_state_report "
                                     f"{rep}")
        if rules:
            shards = [tuple(r["qkv_shard"]) for r in got]
            cases[name]["qkv_shard"] = shards[0]
            if any(s != (cut.hidden_size, 3 * cut.hidden_size // 2)
                   for s in shards):
                raise AssertionError(f"15b model2: qkv shards {shards}")
        if name == "expert2":
            cases[name]["w1_shard"] = tuple(got[0]["w1_shard"])
    log(f"  15b two gloo ranks on the card, depth {PAR_DEPTH}, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} split {TRAIN_BATCH // 2}/"
        f"{TRAIN_BATCH // 2} (gloo goes through the "
        f"host: no NCCL number): one-rank step {ref_ms:.3f} ms; "
        + "; ".join(f"{k} max |dloss| {v['max_dloss']:.3e} step "
                    f"{v['step_ms']:.1f} ms" for k, v in cases.items())
        + f"; ZeRO-1 per-device ratio "
        f"{cases['zero1']['report']['ratio_vs_ideal']}; qkv shard "
        f"{cases['model2']['qkv_shard']}; MoE w1 shard "
        f"{cases['expert2']['w1_shard']}; spawn {spawn_s:.1f} s")
    out["ranks"] = dict(cases=cases, one_rank_step_ms=ref_ms,
                        one_rank_losses=ref, spawn_s=spawn_s)
    return out


# -- phase 16: the parameter-server tier --------------------------------------

PS_STEPS, PS_LR, PS_BLOCK_DIM = 3, 0.01, 64
#: phase 16's BERT-base depth: cut from 12 to 6 layers when phase 19
#: joined and to 2 when phase 20 did, to keep the script inside its time
#: limit (a PS step moves every parameter each way through the host; the
#: launch gates scale with the depth)
PS_DEPTH = 2
PS_RTOL = 1e-5
#: the PS parameters' distance from the reference over the reference's own
#: 3-step update (PS_RTOL of ‖θ‖ alone passes a table whose pushes never
#: landed); the card measured 1.9–2.7e-4 of it
PS_UPDATE_RTOL = 1e-3
PS_CHILD_TIMEOUT_S = 600.0
PS_MODES_STEPS, PS_GEO_PUSH_NUMS = 12, 4
CACHE_CAPACITY, CACHE_LR, CACHE_RTOL = 262_144, 0.5, 1e-6
LSGD_STEPS, LSGD_TOL = 4, 1e-6
BENCH_SIZES_MB = (4, 16, 64)
PS_LOG_DIR = OUT_DIR / "phase16"


def _child(name, **kwargs):
    """The command line of a phase-16 child process: this script with
    ``--child <name> <json kwargs>`` (``child_main`` runs it)."""
    return [sys.executable, "-u", str(Path(__file__).resolve()), "--child",
            name, json.dumps(kwargs)]


def _child_env(extra):
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _ps_role_env(role, idx, server_ports, n_trainers):
    """The fleet's role contract (PaddleCloudRoleMaker's variables); a
    pserver sees no card."""
    env = {"TRAINING_ROLE": role,
           "PADDLE_PSERVERS_IP_PORT_LIST": ",".join(
               f"127.0.0.1:{p}" for p in server_ports),
           "PADDLE_TRAINER_ENDPOINTS": ",".join(
               f"127.0.0.1:{20000 + i}" for i in range(n_trainers))}
    if role == "PSERVER":
        env.update(PADDLE_PSERVER_ID=str(idx), CUDA_VISIBLE_DEVICES="")
    else:
        env["PADDLE_TRAINER_ID"] = str(idx)
    return env


class _Children:
    """Processes started by a phase-16 part, each logging to its own file
    under ``log_dir``: ``wait`` for some, a failure raises with the logs'
    tails, and leaving the block stops every one still running."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.procs = {}

    def start(self, tag, cmd, env):
        out = open(self.log_dir / f"{tag}.log", "w")
        self.procs[tag] = (subprocess.Popen(
            cmd, env=_child_env(env), stdout=out,
            stderr=subprocess.STDOUT), out)
        return self.procs[tag][0]

    def tail(self, tag, n=3000):
        return (self.log_dir / f"{tag}.log").read_text()[-n:]

    def wait(self, tags, timeout=PS_CHILD_TIMEOUT_S, what="16"):
        deadline = time.monotonic() + timeout
        for tag in tags:
            p = self.procs[tag][0]
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                raise AssertionError(
                    f"{what}: {tag} " + ("still runs" if rc is None else
                                         f"exited with {rc}")
                    + f"; its log ends:\n{self.tail(tag)}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.distributed.launch import terminate_procs

        terminate_procs([p for p, _ in self.procs.values()], timeout=10.0)
        for _, out in self.procs.values():
            out.close()
        return False


def _reserve(n):
    from paddle_tpu_torch.distributed.launch import reserve_ports

    return reserve_ports(n)


def _rss_bytes(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def build_ps_bert(cfg, mode):
    """build_bert_pretrain(cfg, TRAIN_SEQ) in fresh programs under the
    names phase 16's trainers build: ``mode`` "plain" minimizes
    SGD(PS_LR), "grads" appends the backward only (the PS program's ops),
    "fleet" goes through the PS fleet's distributed_optimizer (sync,
    server sgd, blocks of PS_BLOCK_DIM) and needs the role variables.
    Returns (main, startup, loss, [(param, grad) names])."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import build_bert_pretrain

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED + 11
    main.random_seed = SEED + 12
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = build_bert_pretrain(cfg, seq_len=TRAIN_SEQ)
        opt = pt.optimizer.SGD(PS_LR)
        if mode == "plain":
            _, pg = opt.minimize(loss)
        elif mode == "grads":
            pg = opt.backward(loss)
        else:
            from paddle_tpu_torch.incubate.fleet.base.role_maker import \
                PaddleCloudRoleMaker
            from paddle_tpu_torch.incubate.fleet.parameter_server import (
                DistributeTranspilerConfig, fleet)

            fleet.init(PaddleCloudRoleMaker(is_collective=False))
            ps_cfg = DistributeTranspilerConfig()
            ps_cfg.block_dim = PS_BLOCK_DIM
            _, pg = fleet.distributed_optimizer(opt, ps_cfg).minimize(loss)
    return main, startup, loss, [(p.name, g.name) for p, g in pg]


def _digest(arrays):
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def bert_ps_child(cfg, device, weights, feed, out, steps, globals_):
    """One 16a trainer, through the PS fleet alone — init_worker (worker
    0 seeds the tables from ``weights``), ``steps``
    exe.run(fleet.main_program) on the npz ``feed`` with the launch counts
    reset before them; then the digest of the parameters it pulls after
    the last barrier, its launches, losses and each step's ``ps:pull``,
    ``ps:step`` and ``ps:push`` spans (host ms) into ``out``."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda, profiler, set_strict_fp32
    from paddle_tpu_torch.incubate.fleet.parameter_server import fleet
    from paddle_tpu_torch.models import BertConfig

    globals().update(globals_)
    main, startup, loss, _ = build_ps_bert(BertConfig(**cfg), "fleet")
    set_strict_fp32()
    device = torch.device(device)
    if device.type == "cpu":
        torch.set_num_threads(2)     # trainers share the host's cores
    exe = _executor(device)
    if fleet.worker_index() == 0:
        # only worker 0 seeds the tables; every step pulls them all
        w = np.load(weights)
        pt.io.load_params(pt.global_scope(), {n: w[n] for n in w.files},
                          device, program=main)
    t0 = time.perf_counter()
    fleet.init_worker()
    init_s = time.perf_counter() - t0
    f = np.load(feed)
    feed = {n: torch.from_numpy(f[n]).to(device) for n in f.files}
    profiler.reset_profiler()
    profiler.start_profiler("CPU")      # host spans only
    try:
        with _PlainCalls() as plain:
            _cuda.reset_launches()
            losses = [float(exe.run(fleet.main_program, feed=feed,
                                    fetch_list=[loss])[0])
                      for _ in range(steps)]
            launches = {k: _cuda.LAUNCHES.get(k, 0)
                        for k in FUSED_STEP_KERNELS}
    finally:
        profiler.stop_profiler(quiet=True)
    spans = collections.defaultdict(dict)
    for name, t0, t1, _, args in profiler._events:
        if name.startswith("ps:"):
            spans[args["step"]][name[3:]] = (t1 - t0) * 1e3
    timings = [spans[k] for k in sorted(spans)]
    tables = fleet._dense_tables
    digest = _digest(tables[n].pull() for n in sorted(tables))
    blocks = sum(t.n_blocks for t in tables.values())
    fleet.stop_worker()
    with open(out, "w") as fh:
        json.dump(dict(losses=losses, launches=launches,
                       plain_calls=plain.calls, timings=timings,
                       digest=digest, init_s=init_s, blocks=blocks), fh)


def _ps_run(device, cfg, params, weights, feeds, root, tag):
    """Start one pserver process (``PSServerProcess`` with the arguments
    the PS fleet's ``run_server`` passes: one table of PS_BLOCK_DIM-wide
    blocks, sgd, init range 0.1, seed 1234) and a trainer process per feed
    file (16a); returns the trainers' results, the parameters the PS
    holds after them (host numpy by name, ``params`` the program's) and
    the server's RSS when it listens and after the trainers."""
    from paddle_tpu_torch.distributed.ps import PSClient, PSServerProcess
    from paddle_tpu_torch.distributed.ps_sharded import (DenseTable,
                                                         ShardedPSClient)

    n = len(feeds)
    g = dict(TRAIN_SEQ=TRAIN_SEQ, PS_LR=PS_LR, PS_BLOCK_DIM=PS_BLOCK_DIM)
    args = dict(cfg=dataclasses.asdict(cfg), device=str(device),
                weights=weights, steps=PS_STEPS, globals_=g)
    outs = [os.path.join(root, f"{tag}_trainer{i}.json") for i in range(n)]
    res = _reserve(1)
    port = res.ports[0]
    res.release()
    server = PSServerProcess(port, num_tables=1, dim=PS_BLOCK_DIM,
                             optimizer="sgd", init_range=0.1, seed=1234,
                             num_workers=n)
    try:
        PSClient("127.0.0.1", port).close()        # it listens
        rss0 = _rss_bytes(server.proc.pid)
        with _Children(PS_LOG_DIR / tag) as ch:
            for i in range(n):
                ch.start(f"trainer{i}", _child("bert_ps", feed=feeds[i],
                                               out=outs[i], **args),
                         _ps_role_env("TRAINER", i, [port], n))
            ch.wait([f"trainer{i}" for i in range(n)], what=f"16a {tag}")
        rss = _rss_bytes(server.proc.pid)
        client = ShardedPSClient([("127.0.0.1", port)], worker_id=0)
        try:
            final = {p.name: DenseTable(client, 0, p.name, p.shape,
                                        PS_BLOCK_DIM).pull()
                     for p in params}
            client.stop_servers()
        finally:
            client.close()
        if server.wait(timeout=30) != 0:
            raise AssertionError(f"16a {tag}: the pserver exited with "
                                 f"{server.proc.returncode}")
    finally:
        server.kill()
    results = []
    for o in outs:
        with open(o) as fh:
            results.append(json.load(fh))
    return results, final, (rss0, rss)


def _step_split(results):
    """Mean pull/step/push ms over the trainers' steps after the first
    (the first lowers the program)."""
    rows = [t for r in results for t in r["timings"][1:]]
    return {k: float(np.mean([t[k] for t in rows])) for k in
            ("pull", "step", "push")}


def bert_ps_phase(device, cfg, root):
    """16a: build_bert_pretrain(cfg, TRAIN_SEQ) at dropout 0 through the
    PS fleet (sync, server sgd) with one pserver process: one trainer
    process on the TRAIN_BATCH batch against plain SGD(PS_LR) steps of the
    same program from the same weights, then two trainer processes of
    half the rows each against θ − lr·(g₀ + g₁) at the same θ."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda

    on_card = device.type == "cuda"
    cfg = _zero_dropout(cfg)
    exe = _executor(device)
    main, startup, loss, pg = build_ps_bert(cfg, "plain")
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    names = [p for p, _ in pg]
    w0 = {n: scope.find_var(n).detach().cpu().numpy() for n in names}
    weights = os.path.join(root, "ps_weights.npz")
    np.savez(weights, **w0)
    batch = {k: v.cpu().numpy() for k, v in
             train_batch(cfg.vocab_size, torch.device("cpu")).items()}
    half = TRAIN_BATCH // 2
    feeds = {"full": os.path.join(root, "feed_full.npz"),
             "half0": os.path.join(root, "feed_half0.npz"),
             "half1": os.path.join(root, "feed_half1.npz")}
    np.savez(feeds["full"], **batch)
    np.savez(feeds["half0"], **{k: v[:half] for k, v in batch.items()})
    np.savez(feeds["half1"], **{k: v[half:] for k, v in batch.items()})
    dev_batch = _on(device, batch)
    # the one-trainer reference: plain SGD steps from the same weights
    ref_losses = [float(exe.run(main, feed=dev_batch, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(PS_STEPS)]
    ref_one = {n: scope.find_var(n).detach().cpu().numpy() for n in names}
    del scope
    # the two-trainer reference: θ − lr·(g₀ + g₁), each half's gradient
    # at the same θ
    gmain, _, gloss, gpg = build_ps_bert(cfg, "grads")
    gscope = pt.Scope()
    pt.io.load_params(gscope, w0, device, program=gmain)
    halves = [_on(device, {k: v[:half] for k, v in batch.items()}),
              _on(device, {k: v[half:] for k, v in batch.items()})]
    ref_two_losses = [[], []]
    for _ in range(PS_STEPS):
        grads = []
        for h in range(2):
            got = exe.run(gmain, feed=halves[h],
                          fetch_list=[gloss] + [g for _, g in gpg],
                          scope=gscope, return_numpy=False)
            ref_two_losses[h].append(float(got[0]))
            grads.append(got[1:])
        for (p, _), g0, g1 in zip(gpg, *grads):
            gscope.set_var(p, gscope.find_var(p) - PS_LR * (g0 + g1))
    ref_two = {n: gscope.find_var(n).detach().cpu().numpy() for n in names}
    del gscope, grads, halves, dev_batch
    sync(device)
    if on_card:
        torch.cuda.empty_cache()

    def rel(a, b):
        return float(np.sqrt(sum(float(np.sum((a[n].astype(np.float64)
                                               - b[n]) ** 2)) for n in a)
                             / sum(float(np.sum(b[n].astype(np.float64)
                                                ** 2)) for n in b)))

    def update_rel(a, b):
        """The difference of two runs over the reference's update."""
        return float(np.sqrt(sum(float(np.sum((a[n].astype(np.float64)
                                               - b[n]) ** 2)) for n in a)
                             / sum(float(np.sum((b[n].astype(np.float64)
                                                 - w0[n]) ** 2))
                                   for n in b)))

    params = main.global_block().all_parameters()
    t0 = time.perf_counter()
    one, one_final, (one_rss0, one_rss) = _ps_run(
        device, cfg, params, weights, [feeds["full"]], root, "one")
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    two, two_final, (_, two_rss) = _ps_run(
        device, cfg, params, weights, [feeds["half0"], feeds["half1"]],
        root, "two")
    two_s = time.perf_counter() - t0
    want = cfg.num_layers * PS_STEPS if on_card else 0
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(one[0]["losses"], ref_losses))
    one_rel, two_rel = rel(one_final, ref_one), rel(two_final, ref_two)
    two_loss_rel = max(abs(a - b) / abs(b) for r, ref in zip(
        two, ref_two_losses) for a, b in zip(r["losses"], ref))
    launches = collections.Counter()
    for r in one + two:
        launches.update(r["launches"])
    blocks = one[0]["blocks"]
    split_one, split_two = _step_split(one), _step_split(two)
    out = dict(
        losses=one[0]["losses"], ref_losses=ref_losses,
        loss_rel_err=loss_rel, param_rel_err=one_rel,
        update_rel_err=update_rel(one_final, ref_one),
        two_losses=[r["losses"] for r in two],
        two_loss_rel_err=two_loss_rel, two_param_rel_err=two_rel,
        two_update_rel_err=update_rel(two_final, ref_two),
        two_bit_equal=two[0]["digest"] == two[1]["digest"],
        launches=dict(launches),
        trainer_launches=[r["launches"] for r in one + two],
        plain_calls=sum(r["plain_calls"] for r in one + two),
        step_split_ms=split_one, two_step_split_ms=split_two,
        blocks=blocks, bytes_each_way=blocks * PS_BLOCK_DIM * 4,
        rpcs_each_way=len(names), server_rss_bytes=one_rss,
        server_rss_listening_bytes=one_rss0,
        two_server_rss_bytes=two_rss, init_s=one[0]["init_s"],
        wall_s=one_s, two_wall_s=two_s)
    log(f"  16a BERT through one pserver (sync, server sgd, lr {PS_LR}), "
        f"{len(names)} dense tables of {blocks} blocks of {PS_BLOCK_DIM} "
        f"({out['bytes_each_way']} bytes each way a step, one RPC a "
        f"parameter): one trainer's losses "
        + " ".join(f"{x:.6f}" for x in out["losses"])
        + f" (plain SGD {' '.join(f'{x:.6f}' for x in ref_losses)}; "
        f"relative {loss_rel:.3e}), PS parameters after {PS_STEPS} steps "
        f"within {one_rel:.3e} relative norm of the plain steps' "
        f"({out['update_rel_err']:.3e} of the update); step split pull "
        f"{split_one['pull']:.1f} / step {split_one['step']:.1f} / push "
        f"{split_one['push']:.1f} ms; worker 0's init_worker (the "
        f"server's first touch of every row) {out['init_s']:.2f} s; "
        f"server RSS {one_rss} bytes ({one_rss0} "
        f"when it listened, before any row); two "
        f"trainers: parameters bit-equal {out['two_bit_equal']}, within "
        f"{two_rel:.3e} relative norm of θ − lr·(g₀ + g₁) "
        f"({out['two_update_rel_err']:.3e} of the update), losses within "
        f"{two_loss_rel:.3e}; split pull {split_two['pull']:.1f} / step "
        f"{split_two['step']:.1f} / push {split_two['push']:.1f} ms; "
        f"launches {out['launches']} (= {want} a trainer each); "
        f"{one_s:.1f} s and {two_s:.1f} s with the spawns")
    if not (loss_rel <= PS_RTOL and one_rel <= PS_RTOL):
        raise AssertionError(f"16a: one trainer departs from plain SGD: "
                             f"losses {loss_rel}, parameters {one_rel}")
    if not (out["two_bit_equal"] and two_rel <= PS_RTOL):
        raise AssertionError(f"16a: two trainers: bit-equal "
                             f"{out['two_bit_equal']}, relative {two_rel}")
    for what, err in (("one trainer", out["update_rel_err"]),
                      ("two trainers", out["two_update_rel_err"])):
        if not err <= PS_UPDATE_RTOL:
            raise AssertionError(f"16a: {what}: the PS update departs from "
                                 f"the reference's by {err} of it")
    if any(n != want for r in one + two for n in r["launches"].values()):
        raise AssertionError(f"16a: launches {out['trainer_launches']}, "
                             f"expected {want} each")
    if on_card and out["plain_calls"]:
        raise AssertionError("16a: a plain kernel version ran on the card")
    return out


def _fleet_modes_model(mode):
    """tests/dist_fleet_ps.py's program."""
    import paddle_tpu_torch as pt

    y = pt.data("y", [8, 1])
    if mode == "geo":
        x = pt.data("x", [8, 4])
        h = pt.layers.fc(x, 8, act="relu",
                         param_attr=pt.ParamAttr(name="fc_w"))
        pred = pt.layers.fc(h, 1, param_attr=pt.ParamAttr(name="fc_o"))
    else:
        ids = pt.data("ids", [8, 1], "int64")
        emb = pt.layers.embedding(ids, (50, 4), is_sparse=True,
                                  param_attr=pt.ParamAttr(name="table"))
        emb = pt.layers.reshape(emb, [8, 4])
        pred = pt.layers.fc(emb, 1, param_attr=pt.ParamAttr(name="fc_w"))
    return pt.layers.mean(pt.layers.square_error_cost(pred, y))


def fleet_modes_child(mode, out_dir, device, steps=PS_MODES_STEPS):
    """One role of tests/dist_fleet_ps.py through the port's PS fleet:
    pserver, or trainer on ``device`` — 12 steps on one fixed batch; the
    sync mode's first worker saves the servers' snapshot; every trainer
    reports the fc_w the PS holds after a barrier (async: after flushing
    its communicators)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.incubate.fleet.base.role_maker import \
        PaddleCloudRoleMaker
    from paddle_tpu_torch.incubate.fleet.parameter_server import (
        DistributeTranspilerConfig, fleet)

    main_prog, startup = pt.Program(), pt.Program()
    startup.random_seed = 17
    with pt.program_guard(main_prog, startup), pt.unique_name.guard():
        loss = _fleet_modes_model(mode)
        fleet.init(PaddleCloudRoleMaker(is_collective=False))
        cfg = DistributeTranspilerConfig()
        cfg.sync_mode = mode == "sync"
        cfg.geo_sgd_mode = mode == "geo"
        cfg.geo_sgd_need_push_nums = PS_GEO_PUSH_NUMS
        fleet.distributed_optimizer(pt.optimizer.SGD(0.1), cfg).minimize(
            loss)
    if fleet.is_server():
        fleet.init_server()
        fleet.run_server()
        return
    exe = _executor(torch.device(device))
    exe.run(fleet.startup_program)
    fleet.init_worker()
    wid = fleet.worker_index()
    rng = np.random.RandomState(100 + wid)
    feed = {"y": rng.randn(8, 1).astype(np.float32)}
    if mode == "geo":
        feed["x"] = rng.randn(8, 4).astype(np.float32)
    else:
        feed["ids"] = rng.randint(0, 50, (8, 1)).astype(np.int64)
    losses = [float(exe.run(fleet.main_program, feed=feed,
                            fetch_list=[loss])[0]) for _ in range(steps)]
    if mode == "sync" and fleet.is_first_worker():
        fleet.save_persistables(exe, os.path.join(out_dir, "snapshot"))
    if fleet._communicators:
        for c in fleet._communicators.values():
            c.flush()
    fleet._client.barrier()      # every worker's pushes have landed
    if mode == "geo":
        final_w = fleet._geo_worker.pull_all()["fc_w"]
    else:
        final_w = fleet._dense_tables["fc_w"].pull()
    on = [str(v.device) for v in (pt.global_scope().find_var("fc_w"),)]
    fleet.stop_worker()
    with open(os.path.join(out_dir, f"worker_{wid}.json"), "w") as f:
        json.dump({"losses": losses, "final_w": final_w.ravel().tolist(),
                   "scope_device": on[0]}, f)


def _modes_learn(mode, losses):
    """16b's learn gate on the two trainers' losses, one that holds
    whatever the startup's draw (tests/test_fleet_ps.py's "min of the last
    4 < 0.7 x max of the first 2" depends on it): sync — both trainers
    compute at one θ, and the server steps θ by lr·(g₀ + g₁), so their
    summed loss falls at every step; GEO — between two exchanges of
    deltas each trainer takes plain local SGD steps on its own batch, so
    its loss falls at each of them; async — the trainers race, so each
    trainer's last loss is below its first."""
    a = np.asarray(losses, np.float64)
    if not np.isfinite(a).all():
        return False
    if mode == "sync":
        return bool(np.all(np.diff(a.sum(axis=0)) < 0))
    if mode == "geo":
        local = [k for k in range(a.shape[1] - 1)
                 if (k + 1) % PS_GEO_PUSH_NUMS != 0]
        return bool(np.all(a[:, [k + 1 for k in local]] < a[:, local]))
    return bool(np.all(a[:, -1] < a[:, 0]))


def fleet_modes_phase(device, root):
    """16b: the three modes at tests/dist_fleet_ps.py's program, 2
    pservers x 2 trainers on the card each, all three at once: every
    trainer's losses learn (``_modes_learn``), the two trainers' fc_w
    after a barrier agree within 1e-5 (sync, GEO and async), sync writes
    the servers' snapshot through save_persistables."""
    out = {}
    t0 = time.perf_counter()
    with _Children(PS_LOG_DIR / "modes") as ch:
        dirs, trainers = {}, []
        for mode in ("sync", "async", "geo"):
            dirs[mode] = os.path.join(root, f"modes_{mode}")
            os.makedirs(dirs[mode], exist_ok=True)
            res = _reserve(2)
            ports = res.ports
            res.release()
            for i in range(2):
                ch.start(f"{mode}_pserver{i}",
                         _child("fleet_modes", mode=mode,
                                out_dir=dirs[mode], device="cpu"),
                         _ps_role_env("PSERVER", i, ports, 2))
            for i in range(2):
                trainers.append(f"{mode}_trainer{i}")
                ch.start(trainers[-1],
                         _child("fleet_modes", mode=mode,
                                out_dir=dirs[mode], device=str(device)),
                         _ps_role_env("TRAINER", i, ports, 2))
        ch.wait(trainers, what="16b")
    wall_s = time.perf_counter() - t0
    for mode, d in dirs.items():
        rs = []
        for i in range(2):
            with open(os.path.join(d, f"worker_{i}.json")) as f:
                rs.append(json.load(f))
        learn = _modes_learn(mode, [r["losses"] for r in rs])
        # tests/test_fleet_ps.py's ratio, reported beside the gate
        ratio = [min(r["losses"][-4:]) / max(r["losses"][:2]) for r in rs]
        w0, w1 = (np.asarray(r["final_w"]) for r in rs)
        agree = float(np.max(np.abs(w0 - w1)
                             / np.maximum(np.abs(w1), 1e-30)))
        snaps = sorted(f for f in os.listdir(d) if f.startswith("snapshot"))
        out[mode] = dict(losses=[r["losses"] for r in rs], learn=learn,
                         last4_over_first2=ratio,
                         w_rel_diff=agree, snapshots=snaps,
                         scope_device=rs[0]["scope_device"])
        log(f"  16b {mode}: 2 pservers x 2 trainers, {PS_MODES_STEPS} steps "
            f"(scope on {rs[0]['scope_device']}): losses "
            + " | ".join(" ".join(f"{x:.4f}" for x in r["losses"][::3])
                         for r in rs)
            + f"; learn {learn} (min of the last 4 over max of the first "
            f"2: {ratio[0]:.4f}, {ratio[1]:.4f}); fc_w after a barrier "
            f"within {agree:.3e}"
            + (f"; snapshot files {snaps}" if mode == "sync" else ""))
        if not learn:
            raise AssertionError(f"16b {mode}: losses do not learn")
        if not np.allclose(w0, w1, rtol=1e-5, atol=1e-7):
            raise AssertionError(f"16b {mode}: workers disagree: {w0} {w1}")
        if mode == "sync" and not (snaps and all(os.path.getsize(
                os.path.join(d, s)) > 0 for s in snaps)):
            raise AssertionError(f"16b sync: no server snapshot in {d}")
        if device.type == "cuda" and not rs[0]["scope_device"].startswith(
                "cuda"):
            raise AssertionError("16b: the trainer's scope is not on the card")
    out["wall_s"] = wall_s
    return out


def cache_phase(device):
    """16c: DeviceCachedEmbedding (capacity CACHE_CAPACITY) over a PS
    table of SPARSE_VOCAB x SPARSE_DIM, phase 13c's Zipf id stream: the
    program gathers cache[slots], its gradient rows push with the sgd
    mirror; after each push the cached rows within CACHE_RTOL of the
    PS's own pull."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.ps import (DeviceCachedEmbedding,
                                                 PSClient, PSServerProcess)

    exe = _executor(device)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        cache = pt.data("cache", [CACHE_CAPACITY, SPARSE_DIM])
        cache.stop_gradient = False
        slots = pt.data("slots", [SPARSE_IDS], "int64")
        target = pt.data("target", [SPARSE_IDS, SPARSE_DIM])
        rows = pt.layers.gather(cache, slots)
        loss = pt.layers.mean(pt.layers.square_error_cost(rows, target))
        (gcache,) = pt.gradients([loss], [cache])
    res = _reserve(1)
    port = res.ports[0]
    res.release()
    srv = PSServerProcess(port, num_tables=1, dim=SPARSE_DIM,
                          optimizer="sgd", init_range=0.1, seed=SEED)
    client = None
    try:
        client = PSClient("127.0.0.1", port)
        dce = DeviceCachedEmbedding(client, 0, SPARSE_DIM, CACHE_CAPACITY,
                                    device=device)
        steps = []
        for f in sparse_feeds():
            ids = f["ids"].ravel() % SPARSE_VOCAB
            before = dce.stats()
            t0 = time.perf_counter()
            s = dce.lookup_slots(ids)
            lv, g = exe.run(main, feed={
                "cache": dce.cache, "slots": s.astype(np.int64),
                "target": f["target"]}, fetch_list=[loss, gcache],
                return_numpy=False)
            uniq, first = np.unique(ids, return_index=True)
            idx = torch.as_tensor(s[first].astype(np.int64), device=device)
            dce.push(uniq, g.index_select(0, idx).cpu().numpy(), CACHE_LR)
            sync(device)
            wall = time.perf_counter() - t0
            cached = np.asarray(sorted(dce._slot_of), np.int64)
            truth = client.pull(0, cached, SPARSE_DIM)
            got = dce.cache.index_select(0, torch.as_tensor(
                [dce._slot_of[int(i)] for i in cached],
                device=device)).cpu().numpy()
            err = float(np.linalg.norm((got - truth).astype(np.float64))
                        / np.linalg.norm(truth.astype(np.float64)))
            after = dce.stats()
            steps.append(dict(
                loss=float(lv), ms=wall * 1e3, rel_err=err,
                unique=int(len(uniq)),
                misses=after["misses"] - before["misses"],
                pulls=after["pulls"] - before["pulls"],
                cached=after["cached"]))
        client.stop_server()
        srv.wait(timeout=30)
    finally:
        if client is not None:
            client.close()
        srv.kill()
    hit = [1.0 - s["misses"] / s["unique"] for s in steps]
    worst = max(s["rel_err"] for s in steps)
    out = dict(steps=steps, hit_rate=hit, max_rel_err=worst,
               step_ms=float(np.mean([s["ms"] for s in steps[1:]])),
               pulls_per_step=[s["pulls"] for s in steps],
               cache_bytes=CACHE_CAPACITY * SPARSE_DIM * 4)
    log(f"  16c DeviceCachedEmbedding: {CACHE_CAPACITY} x {SPARSE_DIM} on "
        f"{device.type} ({out['cache_bytes']} bytes) over a "
        f"{SPARSE_VOCAB}-row PS table, {SPARSE_IDS} Zipf({SPARSE_ZIPF_A}) "
        f"ids a batch: hit rate " + " ".join(f"{h:.3f}" for h in hit)
        + f"; pulls a step {out['pulls_per_step']}; cached rows within "
        f"{worst:.3e} of the PS's pull after each push; step "
        f"{out['step_ms']:.2f} ms (after the first); losses "
        + " ".join(f"{s['loss']:.5f}" for s in steps))
    if not worst <= CACHE_RTOL:
        raise AssertionError(f"16c: the cache departs from the PS: {worst}")
    return out


def collective_phase(device, cfg):
    """16d's first part: Collective + CollectiveOptimizer(Adam(TRAIN_LR))
    on phase 5's program at dropout 0 over a one-rank NCCL group (gloo on
    the CPU) started by ensure_distributed_initialized, against plain
    Executor.run steps from the same weights: PAR_STEPS steps, losses
    and parameters bit-equal, the fused kernels once per layer per step;
    then allreduce_bandwidth over the same group."""
    import torch
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.distributed.allreduce_bench import \
        allreduce_bandwidth
    from paddle_tpu_torch.distributed.collectives import \
        ensure_distributed_initialized
    from paddle_tpu_torch.incubate.fleet.base.role_maker import \
        UserDefinedRoleMaker
    from paddle_tpu_torch.incubate.fleet.collective import fleet

    on_card = device.type == "cuda"
    cfg = _zero_dropout(cfg)
    L = cfg.num_layers
    exe = _executor(device)
    feed = train_batch(cfg.vocab_size, device)
    res = _reserve(1)
    port = res.ports[0]
    res.release()
    # the rank's device and backend: PADDLE_TRAINER_DEVICE, else the card
    # and NCCL (a CPU rehearsal sets it to cpu, and gets gloo)
    ensure_distributed_initialized(f"127.0.0.1:{port}", 1, 0)
    try:
        backend = dist.get_backend()
        fleet.init(UserDefinedRoleMaker(current_id=0, worker_num=1))
        if fleet.device.type != device.type:
            raise AssertionError(f"16d: the fleet's rank runs on "
                                 f"{fleet.device}, the phase on {device}")
        main, startup, loss, _, params = build_train(
            cfg, wrap=lambda opt, _: fleet.distributed_optimizer(opt))
        plain_main, _, plain_loss, _, _ = build_train(cfg)
        scopes = {"plain": pt.Scope(), "fleet": pt.Scope()}
        exe.run(startup, scope=scopes["plain"])
        _load(scopes["fleet"], _snapshot(scopes["plain"], main), main)
        runs = {}
        for name, prog, lv in (("plain", plain_main, plain_loss),
                               ("fleet", fleet.main_program, loss)):
            with _PlainCalls() as plain:
                _cuda.reset_launches()
                runs[name] = [exe.run(prog, feed=feed, fetch_list=[lv],
                                      scope=scopes[name],
                                      return_numpy=False)[0]
                              for _ in range(PAR_STEPS)]
                sync(device)
                runs[name + "_launches"] = {
                    k: _cuda.LAUNCHES.get(k, 0) for k in DP_KERNELS}
                runs[name + "_plain_calls"] = plain.calls
        same = all(torch.equal(a, b) for a, b in zip(runs["plain"],
                                                      runs["fleet"]))
        unequal = [p for p in params if not torch.equal(
            scopes["plain"].find_var(p), scopes["fleet"].find_var(p))]
        degree = fleet.main_program.data_parallel_degree
        del scopes
        bench = allreduce_bandwidth(BENCH_SIZES_MB, reps=5, inner=8,
                                    device=device)
    finally:
        dist.destroy_process_group()
    want = L * PAR_STEPS if on_card else 0
    out = dict(losses=[float(x) for x in runs["fleet"]], bit_equal=same,
               params_equal=len(params) - len(unequal),
               params=len(params), launches=runs["fleet_launches"],
               degree=degree, backend=backend, allreduce=bench)
    log(f"  16d Collective + CollectiveOptimizer(Adam({TRAIN_LR})) over a "
        f"one-rank {backend} group (data_parallel_degree {degree}), "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, dropout 0: losses "
        + " ".join(f"{x:.6f}" for x in out["losses"])
        + f"; bit-equal to the plain steps: losses {same}, parameters "
        f"{out['params_equal']}/{len(params)}; launches "
        f"{out['launches']} (= {want} each); allreduce_bandwidth at world "
        f"1: " + ", ".join(f"{b['payload_mb']} MB {b['min_s']} s (gbps "
                           f"{b['gbps']})" for b in bench))
    if not same or unequal:
        raise AssertionError(f"16d: the collective fleet's step is not the "
                             f"plain one: unequal {unequal[:5]}")
    if any(n != want for n in out["launches"].values()):
        raise AssertionError(f"16d: launches {out['launches']}, expected "
                             f"{want} each")
    if on_card and runs["fleet_plain_calls"]:
        raise AssertionError("16d: a plain kernel version ran on the card")
    if any(b["gbps"] is not None or not b["min_s"] > 0 for b in bench):
        raise AssertionError(f"16d: allreduce_bandwidth at world 1: {bench}")
    return out


def local_sgd_rank(out_dir):
    """One rank of tests/dist_local_sgd.py's program under the port's
    launcher (``chip_smoke.py --local-sgd-rank <dir>``): the collective
    fleet with LocalSGD (k 2) from the launcher's variables, LSGD_STEPS
    local SGD(0.1) steps on rank-specific data, each step's weights
    before and after the syncer."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.launch import trainer_device
    from paddle_tpu_torch.incubate.fleet.base.role_maker import \
        PaddleCloudRoleMaker
    from paddle_tpu_torch.incubate.fleet.collective import (
        DistributedStrategy, fleet)

    device = trainer_device()
    fleet.init(PaddleCloudRoleMaker())
    rank = fleet.worker_index()
    main_prog, startup = pt.Program(), pt.Program()
    startup.random_seed = 42
    with pt.program_guard(main_prog, startup), pt.unique_name.guard():
        x = pt.data("x", [None, 2])
        y = pt.data("y", [None, 1])
        pred = pt.layers.fc(x, 1, param_attr=pt.ParamAttr(name="w"),
                            bias_attr=False)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        strategy = DistributedStrategy()
        strategy.use_local_sgd = True
        strategy.local_sgd_k_steps = 2
        fleet.distributed_optimizer(pt.optimizer.SGD(0.1),
                                    strategy).minimize(loss)
    exe = _executor(device)
    scope = pt.global_scope()
    exe.run(startup)
    syncer = fleet.local_sgd_syncer
    rng = np.random.RandomState(100 + rank)
    X = rng.randn(4, 2).astype(np.float32)
    Y = rng.rand(4, 1).astype(np.float32)
    hist = []
    for step in range(LSGD_STEPS):
        exe.run(fleet.main_program, feed={"x": X, "y": Y})
        pre = scope.find_var("w").detach().cpu().numpy().ravel().tolist()
        synced = syncer.step_end(scope)
        w = scope.find_var("w")
        hist.append({"step": step, "synced": bool(synced), "pre": pre,
                     "w": w.detach().cpu().numpy().ravel().tolist(),
                     "device": str(w.device)})
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"lsgd_rank_{rank}.json"), "w") as f:
        json.dump(hist, f)
    return 0


def local_sgd_start(device, root):
    """Start 16d's LocalSGD launch (``python -m
    paddle_tpu_torch.distributed.launch``, two ranks); ``local_sgd_phase``
    waits for it and checks it."""
    out_dir = os.path.join(root, "lsgd")
    log_dir = PS_LOG_DIR / "local_sgd"
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node=2", f"--log_dir={log_dir}"] \
        + (["--use_cpu_devices=1"] if device.type == "cpu" else []) \
        + [str(Path(__file__).resolve()), "--local-sgd-rank", out_dir]
    proc = subprocess.Popen(cmd, env=_child_env({}), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out_dir, log_dir, time.perf_counter()


def local_sgd_phase(device, root, started=None):
    """16d's second part: tests/dist_local_sgd.py's program on two ranks
    started by ``python -m paddle_tpu_torch.distributed.launch`` (gloo:
    the two ranks share the card; CPU ranks in a rehearsal): after each
    sync step both ranks hold the mean of their pre-sync weights within
    LSGD_TOL.  ``started``: ``local_sgd_start``'s launch, else one is
    started here."""
    proc, out_dir, log_dir, t0 = started or local_sgd_start(device, root)
    try:
        stdout, stderr = proc.communicate(timeout=PS_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.terminate()     # the launcher tears its ranks down
        stdout, stderr = proc.communicate()
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        logs = "".join(f"\n--- {p.name} ---\n{p.read_text()[-3000:]}"
                       for p in sorted(Path(log_dir).glob("*.log")))
        raise AssertionError(f"16d: the launcher exited {proc.returncode}:"
                             f"\n{stdout[-2000:]}\n{stderr[-3000:]}{logs}")
    ranks = []
    for i in range(2):
        with open(os.path.join(out_dir, f"lsgd_rank_{i}.json")) as f:
            ranks.append(json.load(f))
    worst, syncs = 0.0, 0
    for a, b in zip(*ranks):
        if not a["synced"]:
            continue
        syncs += 1
        mean = (np.asarray(a["pre"], np.float64)
                + np.asarray(b["pre"], np.float64)) / 2
        worst = max(worst, float(np.max(np.abs(np.asarray(a["w"]) - mean))),
                    float(np.max(np.abs(np.asarray(b["w"]) - mean))))
    diverged = any(a["pre"] != b["pre"] for a, b in zip(*ranks))
    out = dict(syncs=syncs, max_err=worst, diverged=diverged, wall_s=wall_s,
               device=ranks[0][0]["device"])
    log(f"  16d LocalSGD (k 2) on two gloo ranks on {out['device']} through "
        f"the launcher: {syncs} syncs, both ranks at the mean of their "
        f"pre-sync weights within {worst:.3e}; local weights diverged "
        f"between syncs {diverged}; {wall_s:.1f} s with the launch")
    if not (syncs == LSGD_STEPS // 2 and worst <= LSGD_TOL and diverged):
        raise AssertionError(f"16d: LocalSGD {out}")
    if device.type == "cuda" and not out["device"].startswith("cuda"):
        raise AssertionError("16d: the LocalSGD ranks did not run on the card")
    return out


def ps_phase(device, cfg, phase5_step_ms=float("nan")):
    """Phase 16: BERT through a pserver (16a), the PS fleet's three modes
    (16b), the device-cached embedding (16c), the collective fleet, the
    launcher with LocalSGD and the all-reduce harness (16d)."""
    import tempfile

    out = {"phase5_step_ms": phase5_step_ms}
    with tempfile.TemporaryDirectory() as root:
        out["bert"] = bert_ps_phase(device, cfg, root)
        out["cache"] = cache_phase(device)
        out["collective"] = collective_phase(device, cfg)
        # 16b and the LocalSGD launch are process start-ups and gates, no
        # timings: they run side by side
        lsgd = local_sgd_start(device, root)
        try:
            out["modes"] = fleet_modes_phase(device, root)
        finally:
            out["local_sgd"] = local_sgd_phase(device, root, lsgd)
    out["launches"] = {k: out["bert"]["launches"].get(k, 0)
                       + out["collective"]["launches"].get(k, 0)
                       for k in FUSED_STEP_KERNELS}
    return out


#: the phase-16 child processes ``chip_smoke.py --child <name> <json>``
#: runs
# -- phase 17: the JAX bench's other two training models ----------------------

#: 17a: ResNet-50 as bench.py:215 builds it (224 x 224 images, 1000
#: classes, Momentum(0.1, 0.9)), in float32; the batches tried in order
#: until a step fits the card
RESNET_DEPTH, RESNET_IMAGE, RESNET_CLASSES = 50, 224, 1000
RESNET_BATCHES = (256, 128, 64, 32)
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
P17_WARMUP, P17_STEPS = 2, 10
#: the first step's card run against the port's CPU run of the same
#: program from the same startup weights, on the batch's first images:
#: the loss within _PARITY_TOL, the first batch norm's moving mean and
#: variance and the classifier's weight within a relative norm error of
#: 1e-3, conv1's filter update (after minus before) within 0.15 of the
#: CPU's.  conv1's gradient at random initialization is a small
#: difference of large terms: the JAX package's own jitted and op-by-op
#: CPU runs of ResNet-50 part by 3–5% (relative norm) in it, and on an
#: H100 80GB HBM3 (700 W) the filter after the step sat 2.3% (of its
#: norm) from the CPU's, the loss 1.6e-5 and the statistics 7e-8 from
#: theirs (tests/test_torch_resnet.py holds the same update criterion
#: against the JAX package)
RESNET_PARITY_IMAGES = 4
RESNET_STATE_RTOL = 1e-3
RESNET_UPDATE_RTOL = 0.15
#: the kernel names of cuDNN's convolutions (forward, dgrad, wgrad) in a
#: device trace
CONV_KERNEL_NAMES = ("conv", "cudnn", "xmma", "fprop", "dgrad", "wgrad",
                     "implicit", "winograd", "fft")
#: 17b: NMTConfig.big() at bench.py:257's shapes (batch 32, 256 source and
#: 256 target tokens, Adam(1e-4)), float32, its dropout 0.3
NMT_BATCH, NMT_SRC, NMT_TGT, NMT_LR = 32, 256, 256, 1e-4
NMT_PARITY_STEPS = NMT_BASE_STEPS = 3
#: the JAX planner's groups of build_nmt_train(NMTConfig.big(), 256, 256)
#: (tests/test_torch_fusion.py::test_nmt_and_resnet_plans holds these
#: counts against the JAX package's plan)
NMT_PLAN = {"mul+bias+slice3+attention": 12,
            "mul+bias+relu+mul+bias+dropout+residual+layer_norm": 12,
            "mul+bias+dropout+residual+layer_norm": 18, "mul+bias": 12}
#: 17c: build_nmt_beam_infer(NMTConfig.big(), 64, 8, 32, beam_size=4) on
#: 17b's scope; its token gate at both stacks cut to 2 layers
BEAM_SRC, BEAM_BATCH, BEAM_OUT, BEAM_K = 64, 8, 32, 4
BEAM_RUNS = 2
BEAM_GATE_LAYERS = 2
BEAM_SCORE_TOL = 1e-3


def _host_arrays(scope, program):
    """Host numpy copies of every persistable of ``program``."""
    import paddle_tpu_torch as pt

    return {n: scope.find_var(n).detach().cpu().numpy()
            for n in pt.io.persistable_names(program)}


def _scope_from(arrays, device, program):
    import paddle_tpu_torch as pt

    scope = pt.Scope()
    pt.io.load_params(scope, arrays, device, program=program)
    return scope


def _free_card(device):
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def conv_matmul_flops(program):
    """bench.py:195's count: forward matmul FLOPs per image from the
    program IR — 2·OH·OW·Cout·(Cin/groups)·KH·KW a conv, 2·prod(weight
    shape) an fc/matmul; BN, pooling and elementwise not credited."""
    total = 0
    for block in program.blocks:
        for op in block.ops:
            if op.type in ("conv2d", "depthwise_conv2d"):
                w = block.var(op.inputs["Filter"][0])
                y = block.var(op.outputs["Output"][0])
                co, ci_g, kh, kw = w.shape
                total += 2 * y.shape[2] * y.shape[3] * co * ci_g * kh * kw
            elif op.type in ("mul", "matmul"):
                w = block.var(op.inputs["Y"][0])
                total += 2 * int(np.prod(w.shape))
    return total


def build_resnet(depth, image, classes, amp=None, lr=None):
    """resnet(img, label, depth) + Momentum(RESNET_LR, RESNET_MOMENTUM) in
    fresh programs -> (main, startup, loss, forward FLOPs an image);
    ``amp``: the optimizer under contrib.mixed_precision.decorate in that
    dtype (bench.py:231); ``lr`` in place of RESNET_LR."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED + 1701
    with pt.program_guard(main, startup), pt.unique_name.guard():
        img = pt.data("img", [None, 3, image, image])
        label = pt.data("label", [None, 1], "int64")
        _, loss, _ = resnet(img, label, depth=depth, class_num=classes)
        flops = conv_matmul_flops(main)
        _amp_wrap(pt.optimizer.Momentum(lr or RESNET_LR, RESNET_MOMENTUM),
                  amp).minimize(loss)
    return main, startup, loss, flops


def resnet_feed(batch, image, classes, device, seed=SEED + 1702):
    import torch

    rng = np.random.RandomState(seed)
    img = rng.rand(batch, 3, image, image).astype(np.float32)
    label = rng.randint(0, classes, (batch, 1)).astype(np.int64)
    return {"img": torch.from_numpy(img).to(device),
            "label": torch.from_numpy(label).to(device)}


def _step_oom(exc):
    import torch

    return isinstance(exc, torch.cuda.OutOfMemoryError) or (
        isinstance(exc, RuntimeError) and "out of memory" in str(exc))


def resnet_parity(device, main, loss, startup_w, feed):
    """The first step on the first RESNET_PARITY_IMAGES images, on the
    card and in the port's CPU run of the same program from the same
    startup weights: the loss within PARITY_LOSS_TOL; the first batch
    norm's moving mean and variance and the classifier's weight within
    RESNET_STATE_RTOL (relative norm), conv1's filter update within
    RESNET_UPDATE_RTOL; and the statistics themselves:
    momentum·startup + (1 − momentum)·conv1's batch mean and population
    variance, computed from conv1's filter with F.conv2d."""
    import torch
    import torch.nn.functional as F

    import paddle_tpu_torch as pt

    block = main.global_block()
    conv1 = next(op for op in block.ops if op.type == "conv2d")
    bn1 = next(op for op in block.ops if op.type == "batch_norm")
    fc_w = next(op for op in block.ops if op.type == "mul").inputs["Y"][0]
    w_name = conv1.inputs["Filter"][0]
    m_name, v_name = bn1.inputs["Mean"][0], bn1.inputs["Variance"][0]
    momentum = float(bn1.attrs.get("momentum", 0.9))
    part = {n: t[:RESNET_PARITY_IMAGES].detach().cpu() for n, t in
            feed.items()}
    got = {}
    for where in ((device,) if device.type == "cpu" else
                  (device, torch.device("cpu"))):
        scope = _scope_from(startup_w, where, main)
        fd = {n: t.to(where) for n, t in part.items()}
        (lv,) = _executor(where).run(main, feed=fd, fetch_list=[loss],
                                     scope=scope)
        got[where.type] = dict(
            loss=float(lv), **{n: scope.find_var(n).detach().cpu().double()
                               for n in (w_name, m_name, v_name, fc_w)})
    card, cpu = got[device.type], got["cpu"]
    x = part["img"].double()
    w0 = torch.from_numpy(startup_w[w_name]).double()
    z = F.conv2d(x, w0, stride=conv1.attrs["strides"],
                 padding=conv1.attrs["paddings"])
    var, mean = torch.var_mean(z, dim=(0, 2, 3), correction=0)
    want = {m_name: momentum * torch.from_numpy(startup_w[m_name]).double()
            + (1 - momentum) * mean,
            v_name: momentum * torch.from_numpy(startup_w[v_name]).double()
            + (1 - momentum) * var}
    errs = dict(
        loss=abs(card["loss"] - cpu["loss"]),
        **{f"{n}_vs_cpu": _rel_norm(card[n], cpu[n])
           for n in (m_name, v_name, fc_w)},
        **{f"{n}_vs_formula": _rel_norm(card[n], want[n])
           for n in (m_name, v_name)})
    update_err = _rel_norm(card[w_name] - w0, cpu[w_name] - w0)
    filter_err = _rel_norm(card[w_name], cpu[w_name])
    log(f"  17a parity on {RESNET_PARITY_IMAGES} images, one step from the "
        f"startup weights: loss card {card['loss']:.6f} cpu "
        f"{cpu['loss']:.6f} (|d| {errs['loss']:.3e}, tol "
        f"{PARITY_LOSS_TOL:g}); relative norm errors "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items() if k != "loss")
        + f" (tol {RESNET_STATE_RTOL:g}); conv1's update {update_err:.3e} "
        f"(tol {RESNET_UPDATE_RTOL:g}; its filter {filter_err:.3e})")
    if not (errs["loss"] <= PARITY_LOSS_TOL and np.isfinite(card["loss"])):
        raise AssertionError(f"17a: the first step's loss {card['loss']} is "
                             f"not the CPU run's {cpu['loss']}")
    bad = {k: v for k, v in errs.items()
           if k != "loss" and not v <= RESNET_STATE_RTOL}
    if not update_err <= RESNET_UPDATE_RTOL:
        bad["conv1_update"] = update_err
    if bad:
        raise AssertionError(f"17a: batch-norm statistics or weights "
                             f"after the first step off: {bad}")
    return dict(card_loss=card["loss"], cpu_loss=cpu["loss"],
                conv1_update_rel_err=update_err,
                conv1_filter_rel_err=filter_err, **errs)


def resnet_phase(device, depth=RESNET_DEPTH, image=RESNET_IMAGE,
                 classes=RESNET_CLASSES):
    """17a: ResNet through Executor.run, f32, the batch halved from
    RESNET_BATCHES[0] until a step fits: the parity gate, then
    P17_WARMUP + P17_STEPS steps — finite losses, the classifier's fused
    matmul once a step and no other kernel of the port, no plain kernel
    version on the card — step ms, images/s, peak memory, one profiled
    step (busy share, the convolutions' share) and bench.py's conv+matmul
    FLOPs over the step time."""
    import torch

    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.ops import fused_matmul as fm

    import paddle_tpu_torch as pt

    on_card = device.type == "cuda"
    _free_card(device)
    main, startup, loss, fwd_flops = build_resnet(depth, image, classes)
    exe = _executor(device)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    startup_w = _host_arrays(scope, main)
    del scope
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters())
    feed = resnet_feed(RESNET_BATCHES[-1], image, classes, device)
    parity = resnet_parity(device, main, loss, startup_w, feed)

    tried = []
    for batch in RESNET_BATCHES:
        _free_card(device)
        scope = _scope_from(startup_w, device, main)
        feed = resnet_feed(batch, image, classes, device)
        try:
            t0 = time.perf_counter()
            warm = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                  scope=scope)[0])
                    for _ in range(P17_WARMUP)]
            warm_s = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — only an OOM halves
            if not (on_card and _step_oom(e)):
                raise
            peak = torch.cuda.max_memory_allocated(device)
            tried.append(dict(batch=batch, fits=False, peak_bytes=peak,
                              error=str(e).splitlines()[0][:160]))
            log(f"  ResNet-{depth} at batch {batch}: out of memory (peak "
                f"{peak / 2**30:.2f} GiB); halving")
            del e
            scope = feed = None
            continue
        break
    else:
        raise AssertionError(f"17a: no batch of {RESNET_BATCHES} fits")
    with _PlainCalls() as plain:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        losses = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                          return_numpy=False)[0] for _ in range(P17_STEPS)]
        sync(device)
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
    losses = warm + [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    tried.append(dict(batch=batch, fits=True, peak_bytes=peak))
    step_ms = wall / P17_STEPS * 1e3
    tflops = 3 * fwd_flops * batch / (step_ms / 1e3) / 1e12
    want = {fm.LAUNCH: P17_STEPS} if on_card else {}
    log(f"  ResNet-{depth} ({n_params} parameters) at batch {batch} x 3 x "
        f"{image} x {image}, Momentum({RESNET_LR:g}, {RESNET_MOMENTUM:g}), "
        f"f32: warm-up {warm_s:.2f} s; {P17_STEPS} steps {step_ms:.3f} "
        f"ms/step, {batch / (step_ms / 1e3):.1f} images/s, conv+matmul "
        f"{tflops:.2f} TFLOP/s (bench.py's count: 3 x "
        f"{fwd_flops / 1e9:.3f} GFLOP an image); peak "
        f"{peak / 2**30:.2f} GiB; losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; launches {launches}; plain kernel versions {plain.calls}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"17a: a loss is not finite: {losses}")
    got = _launch_gate(launches, want, "17a", on_card)
    if on_card and plain.calls:
        raise AssertionError("17a: a plain kernel version ran on the card")
    prof = _profile_step(exe, main, feed, loss, scope, device,
                         f"ResNet-{depth}", CONV_KERNEL_NAMES,
                         "cuDNN's convolutions")
    del scope, feed
    _free_card(device)
    return dict(depth=depth, image=image, batch=batch, batches=tried,
                parameters=n_params, losses=losses, step_ms=step_ms,
                images_per_s=batch / (step_ms / 1e3),
                fwd_gflops_per_image=fwd_flops / 1e9,
                conv_matmul_tflops=tflops, peak_bytes=peak, launches=got,
                parity=parity, profile=prof)


def _amp_wrap(opt, amp):
    """``opt`` under bf16/fp16 AMP (``amp`` its dtype), or as it is."""
    if amp is None:
        return opt
    from paddle_tpu_torch.contrib import mixed_precision

    return mixed_precision.decorate(opt, amp_dtype=amp)


def build_nmt(cfg, src_len, tgt_len, lr=NMT_LR, amp=None):
    """build_nmt_train + Adam(lr) in fresh programs (``amp``: under
    decorate in that dtype, bench.py:273)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import build_nmt_train

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED + 1711
    main.random_seed = SEED + 1712
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = build_nmt_train(cfg, src_len, tgt_len)
        _amp_wrap(pt.optimizer.Adam(lr), amp).minimize(loss)
    return main, startup, loss


def nmt_feed(cfg, batch, src_len, tgt_len, device, seed=SEED + 1713):
    """bench.py:277-293: random ids and full masks from a seed."""
    import torch

    rng = np.random.RandomState(seed)
    V = cfg.vocab_size
    arrays = {
        "src_ids": rng.randint(0, V, (batch, src_len)).astype(np.int64),
        "src_mask": np.ones((batch, src_len), np.float32),
        "tgt_ids": rng.randint(0, V, (batch, tgt_len)).astype(np.int64),
        "tgt_mask": np.ones((batch, tgt_len), np.float32),
        "labels": rng.randint(0, V, (batch, tgt_len, 1)).astype(np.int64)}
    return {n: torch.from_numpy(a).to(device) for n, a in arrays.items()}


def nmt_step_flops(cfg, src_len, tgt_len, batch):
    """bench.py:305-318's strict matmul count of a training step."""
    H, F, V = cfg.d_model, cfg.ffn_size, cfg.vocab_size
    Le, Ld = cfg.num_encoder_layers, cfg.num_decoder_layers
    p_enc = Le * (4 * H * H + 2 * H * F)
    p_dec = Ld * (8 * H * H + 2 * H * F)
    w_flops = 2 * (p_enc * src_len + p_dec * tgt_len + V * H * tgt_len)
    attn = (4 * H * src_len ** 2 * Le + 2 * H * tgt_len ** 2 * Ld
            + 4 * H * src_len * tgt_len * Ld)
    return 3 * (w_flops + attn) * batch


def nmt_step_launches(cfg, on_card):
    """Each kernel's launches in one NMT training step, from the model's
    structure: #9 one a self-attention (encoder and causal decoder), #3
    one a cross-attention op, #5 and #6 one a self- and one a
    cross-attention, #10 one an attention-output, cross-attention
    output and projection group and two an FFN whose N is past the
    chain's (#11 one an FFN otherwise)."""
    from paddle_tpu_torch.ops import ffn_chain as fc
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_matmul as fm

    if not on_card:
        return {}
    Le, Ld = cfg.num_encoder_layers, cfg.num_decoder_layers
    M = NMT_BATCH * NMT_TGT
    chain = fc.ffn_chain_shapes_ok(M, cfg.d_model, cfg.ffn_size,
                                   cfg.d_model)
    ffn = Le + Ld
    return {fa.QKV: Le + Ld, fa.FWD: Ld, fa.DQ: Le + 2 * Ld,
            fa.DKV: Le + 2 * Ld,
            fm.LAUNCH: (Le + 2 * Ld) + 2 * Ld + (0 if chain else 2 * ffn),
            fc.LAUNCH: ffn if chain else 0}


def _plan_patterns(main):
    plans = [lowered.fusion_plan for lowered in main._exec_cache.values()]
    return [None if p is None else dict(collections.Counter(
        g.pattern for g in p.groups)) for p in plans]


def nmt_parity(device, cfg):
    """At dropout 0 (cfg's rates set to 0), NMT_PARITY_STEPS steps of the
    fused program and of its unfused lowering (fuse_epilogues=False) from
    the same startup weights: every loss within PARITY_LOSS_TOL."""
    import paddle_tpu_torch as pt

    cfg0 = dataclasses.replace(cfg, dropout=0.0, attn_dropout=0.0)
    main, startup, loss = build_nmt(cfg0, NMT_SRC, NMT_TGT)
    exe = _executor(device)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    weights = _snapshot(scope, main)
    feed = nmt_feed(cfg0, NMT_BATCH, NMT_SRC, NMT_TGT, device)
    fused = [float(exe.run(main, feed=feed, fetch_list=[loss],
                           scope=scope)[0]) for _ in range(NMT_PARITY_STEPS)]
    del scope
    bs = pt.BuildStrategy()
    bs.fuse_epilogues = False
    unfused_prog = pt.CompiledProgram(main, build_strategy=bs)
    scope = _fill_scope(weights)
    del weights
    unfused = [float(exe.run(unfused_prog, feed=feed, fetch_list=[loss],
                             scope=scope)[0])
               for _ in range(NMT_PARITY_STEPS)]
    del scope
    _free_card(device)
    dloss = max(abs(a - b) for a, b in zip(fused, unfused))
    log(f"  17b parity at dropout 0, {NMT_PARITY_STEPS} steps from the same "
        f"weights: fused {fused}, unfused lowering {unfused}, max |d| "
        f"{dloss:.3e} (tol {PARITY_LOSS_TOL:g})")
    if not (dloss <= PARITY_LOSS_TOL and np.all(np.isfinite(fused))):
        raise AssertionError(f"17b: fused {fused} and unfused {unfused} "
                             f"part past {PARITY_LOSS_TOL}")
    return dict(fused=fused, unfused=unfused, max_dloss=dloss)


def nmt_train_phase(device, cfg, base_cfg, plan=None):
    """17b: NMT training through Executor.run (the fusion pass on):
    P17_WARMUP + P17_STEPS steps at NMT_BATCH x NMT_SRC / NMT_TGT with
    the plan gate (``plan``: NMT_PLAN at NMTConfig.big()), the launch
    gate (nmt_step_launches), finite losses and no plain kernel version
    on the card; step ms, target tokens/s, peak memory, one profiled
    step; the dropout-0 parity gate; then NMT_BASE_STEPS steps at
    ``base_cfg`` (its N within the FFN chain's rule: #11 once an FFN).
    Returns (report, the trained scope and main program)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda

    on_card = device.type == "cuda"
    _free_card(device)
    main, startup, loss = build_nmt(cfg, NMT_SRC, NMT_TGT)
    exe = _executor(device)
    scope = pt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    sync(device)
    startup_s = time.perf_counter() - t0
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters())
    feed = nmt_feed(cfg, NMT_BATCH, NMT_SRC, NMT_TGT, device)
    t0 = time.perf_counter()
    warm = [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(P17_WARMUP)]
    warm_s = time.perf_counter() - t0
    patterns = _plan_patterns(main)
    with _PlainCalls() as plain:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        losses = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                          return_numpy=False)[0] for _ in range(P17_STEPS)]
        sync(device)
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
    losses = warm + [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    step_ms = wall / P17_STEPS * 1e3
    tflops = nmt_step_flops(cfg, NMT_SRC, NMT_TGT, NMT_BATCH) \
        / (step_ms / 1e3) / 1e12
    per_step = nmt_step_launches(cfg, on_card)
    want = {k: v * P17_STEPS for k, v in per_step.items()}
    log(f"  NMT (d_model {cfg.d_model}, {cfg.num_heads} heads, FFN "
        f"{cfg.ffn_size}, {cfg.num_encoder_layers} + "
        f"{cfg.num_decoder_layers} layers, {n_params} parameters), batch "
        f"{NMT_BATCH} x {NMT_SRC}/{NMT_TGT}, Adam({NMT_LR:g}), dropout "
        f"{cfg.dropout}: startup {startup_s:.2f} s, warm-up {warm_s:.2f} s; "
        f"{P17_STEPS} steps {step_ms:.3f} ms/step, "
        f"{NMT_BATCH * NMT_TGT / (step_ms / 1e3):.1f} target tokens/s, "
        f"{tflops:.2f} TFLOP/s (bench.py's count); peak "
        f"{peak / 2**30:.2f} GiB; plan {patterns}; losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; launches {launches} (want {want}); plain kernel versions "
        f"{plain.calls}")
    if plan is not None and patterns != [plan]:
        raise AssertionError(f"17b: fusion plan {patterns}, expected {plan}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"17b: a loss is not finite: {losses}")
    got = _launch_gate(launches, want, "17b", on_card)
    if on_card and plain.calls:
        raise AssertionError("17b: a plain kernel version ran on the card")
    prof = _profile_step(exe, main, feed, loss, scope, device, "NMT")
    report = dict(config=dataclasses.asdict(cfg), parameters=n_params,
                  batch=NMT_BATCH, src_len=NMT_SRC, tgt_len=NMT_TGT,
                  losses=losses, step_ms=step_ms,
                  target_tokens_per_s=NMT_BATCH * NMT_TGT / (step_ms / 1e3),
                  matmul_tflops=tflops, peak_bytes=peak, launches=got,
                  launches_per_step=per_step, plan=patterns,
                  startup_s=startup_s, profile=prof)
    trained = (main, scope)
    del feed
    report["parity"] = nmt_parity(device, cfg)

    bmain, bstartup, bloss = build_nmt(base_cfg, NMT_SRC, NMT_TGT)
    bscope = pt.Scope()
    exe.run(bstartup, scope=bscope)
    bfeed = nmt_feed(base_cfg, NMT_BATCH, NMT_SRC, NMT_TGT, device)
    exe.run(bmain, feed=bfeed, fetch_list=[bloss], scope=bscope)
    _cuda.reset_launches()
    blosses = [float(exe.run(bmain, feed=bfeed, fetch_list=[bloss],
                             scope=bscope)[0])
               for _ in range(NMT_BASE_STEPS)]
    blaunch = dict(_cuda.LAUNCHES)
    bper = nmt_step_launches(base_cfg, on_card)
    bwant = {k: v * NMT_BASE_STEPS for k, v in bper.items()}
    log(f"  NMT at d_model {base_cfg.d_model} (FFN N within the chain's "
        f"rule): {NMT_BASE_STEPS} steps, losses {blosses}, launches "
        f"{blaunch} (want {bwant})")
    if not all(np.isfinite(blosses)):
        raise AssertionError(f"17b base: a loss is not finite: {blosses}")
    report["base"] = dict(losses=blosses, launches=_launch_gate(
        blaunch, bwant, "17b base", on_card), launches_per_step=bper,
        plan=_plan_patterns(bmain))
    del bscope, bfeed
    _free_card(device)
    return report, trained


def build_beam(cfg, src_len, batch, max_out, beam):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import build_nmt_beam_infer

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        ids, scores = build_nmt_beam_infer(cfg, src_len, batch, max_out,
                                           beam_size=beam)
    return main, ids, scores


def beam_feed(cfg, device, seed=SEED + 1721):
    import torch

    rng = np.random.RandomState(seed)
    mask = np.ones((BEAM_BATCH, BEAM_SRC), np.float32)
    for b in range(BEAM_BATCH // 2):
        mask[b, rng.randint(BEAM_SRC // 2, BEAM_SRC):] = 0.0
    ids = rng.randint(2, cfg.vocab_size, (BEAM_BATCH, BEAM_SRC))
    return {"src_ids": torch.from_numpy(ids.astype(np.int64)).to(device),
            "src_mask": torch.from_numpy(mask).to(device)}


def _beam_weights(scope, main, device):
    """``main``'s persistables from ``scope`` (the trained NMT's), moved
    to ``device``."""
    return {n: scope.find_var(n).detach().to(device)
            for n in (v.name for v in main.list_vars() if v.persistable)}


def beam_phase(device, cfg, trained_scope):
    """17c: build_nmt_beam_infer on 17b's trained weights: one warm run,
    then BEAM_RUNS timed runs — ms a decode step, sentences/s, launches a
    run (#3 twice a decoder layer a step in the StaticRNN sub-block, #9
    once an encoder layer and #10 for the encoder's other groups: the
    fusion pass plans the top level only); then the token gate with both
    stacks cut to BEAM_GATE_LAYERS: the card's sentence ids equal the
    port's CPU run of the same program and weights, the scores within
    BEAM_SCORE_TOL, beside the smallest gap between adjacent final beam
    scores."""
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.ops import ffn_chain as fc
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_matmul as fm

    on_card = device.type == "cuda"
    main, ids, scores = build_beam(cfg, BEAM_SRC, BEAM_BATCH, BEAM_OUT,
                                   BEAM_K)
    scope = _fill_scope(_beam_weights(trained_scope, main, device))
    feed = beam_feed(cfg, device)
    exe = _executor(device)
    exe.run(main, feed=feed, fetch_list=[ids, scores], scope=scope)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for _ in range(BEAM_RUNS):
        out = exe.run(main, feed=feed, fetch_list=[ids, scores],
                      scope=scope)
    sync(device)
    run_s = (time.perf_counter() - t0) / BEAM_RUNS
    launches = {k: v / BEAM_RUNS for k, v in _cuda.LAUNCHES.items()}
    Le, Ld = cfg.num_encoder_layers, cfg.num_decoder_layers
    chain = fc.ffn_chain_shapes_ok(BEAM_BATCH * BEAM_SRC, cfg.d_model,
                                   cfg.ffn_size, cfg.d_model)
    want = {fa.FWD: 2 * Ld * BEAM_OUT, fa.QKV: Le,
            fm.LAUNCH: Le + (0 if chain else 2 * Le),
            fc.LAUNCH: Le if chain else 0} if on_card else {}
    sent_ids, sent_scores = (np.asarray(x) for x in out)
    log(f"  17c beam decode (B {BEAM_BATCH}, K {BEAM_K}, {BEAM_OUT} steps, "
        f"{BEAM_SRC} source tokens, {Le} + {Ld} layers): "
        f"{run_s * 1e3:.1f} ms a run, {run_s * 1e3 / BEAM_OUT:.3f} ms a "
        f"decode step, {BEAM_BATCH / run_s:.2f} sentences/s; launches a "
        f"run {launches} (want {want}); ids {sent_ids.shape}")
    got = _launch_gate({k: int(v) for k, v in launches.items()}, want,
                       "17c", on_card)
    if sent_ids.shape != (BEAM_OUT, BEAM_BATCH, BEAM_K) \
            or not np.all(np.isfinite(sent_scores)):
        raise AssertionError("17c: beam outputs malformed")
    del scope

    cut = dataclasses.replace(cfg, num_encoder_layers=BEAM_GATE_LAYERS,
                              num_decoder_layers=BEAM_GATE_LAYERS)
    gmain, gids, gscores = build_beam(cut, BEAM_SRC, BEAM_BATCH, BEAM_OUT,
                                      BEAM_K)
    res = {}
    import torch

    for where in ((device,) if device.type == "cpu" else
                  (device, torch.device("cpu"))):
        sc = _fill_scope(_beam_weights(trained_scope, gmain, where))
        fd = {n: t.to(where) for n, t in feed.items()}
        res[where.type] = [np.asarray(x) for x in _executor(where).run(
            gmain, feed=fd, fetch_list=[gids, gscores], scope=sc)]
        del sc
    (cid, csc), (hid, hsc) = res[device.type], res["cpu"]
    srt = -np.sort(-hsc, axis=1)
    margin = float((srt[:, :-1] - srt[:, 1:]).min())
    equal = bool(np.array_equal(cid, hid))
    serr = float(np.abs(csc - hsc).max())
    log(f"  17c token gate at {BEAM_GATE_LAYERS} + {BEAM_GATE_LAYERS} "
        f"layers: sentence ids equal the CPU run's: {equal}; scores max "
        f"|d| {serr:.3e} (tol {BEAM_SCORE_TOL:g}); smallest gap between "
        f"adjacent final beam scores {margin:.4e}")
    if not equal or not serr <= BEAM_SCORE_TOL:
        raise AssertionError(f"17c: the card's beams are not the CPU's "
                             f"(ids equal {equal}, scores |d| {serr})")
    _free_card(device)
    return dict(run_ms=run_s * 1e3, decode_step_ms=run_s * 1e3 / BEAM_OUT,
                sentences_per_s=BEAM_BATCH / run_s, launches=got,
                gate=dict(ids_equal=equal, score_max_abs_err=serr,
                          min_adjacent_score_gap=margin))


def bench_models_phase(device, nmt_cfg=None, nmt_base_cfg=None,
                       resnet_kw=None, plan=NMT_PLAN):
    """Phase 17: 17a ResNet, 17b NMT training (big, then base), 17c the
    beam decoder on 17b's weights."""
    from paddle_tpu_torch.models import NMTConfig

    nmt_cfg = nmt_cfg or NMTConfig.big()
    nmt_base_cfg = nmt_base_cfg or NMTConfig.base()
    t0 = time.perf_counter()
    out = dict(resnet=resnet_phase(device, **(resnet_kw or {})))
    out["nmt"], (main, scope) = nmt_train_phase(device, nmt_cfg,
                                                nmt_base_cfg, plan)
    out["beam"] = beam_phase(device, nmt_cfg, scope)
    del main, scope
    _free_card(device)
    launches = collections.Counter()
    for part in (out["resnet"], out["nmt"], out["nmt"]["base"],
                 out["beam"]):
        launches.update(part["launches"])
    out["launches"] = dict(launches)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 17 took {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# -- phase 18: bf16 and fp16 AMP training -----------------------------------

#: 18a, the bench's headline (bench.py:3121): BERT-large at 16 x 512, the
#: masked head at 80 positions a row; 18b (bench.py:3124): BERT-base at
#: 64 x 128, 20 positions.  Both under decorate(Adam(1e-4), "bfloat16"),
#: dropout 0.1, the fusion pass on
AMP_LARGE = (16, 512, 80)
AMP_BASE = (64, 128, 20)
AMP_WARMUP, AMP_STEPS, AMP_F32_STEPS = 2, 10, 3
#: 18c: BERT-base cut to 2 layers at 8 x 128 under decorate(SGD(0.1),
#: "float16") with dynamic loss scaling from a scale whose scaled
#: gradients overflow float16 (tests/test_amp.py:44's recipe, its
#: incr_every_n_steps=2, started past the overflow): the first steps find
#: inf and shrink the scale, the later ones grow it
#: and the unfused lowering's steps from the same weights (the packed
#: float16 kernels of the fused_attention op)
AMP_F16_UNFUSED = 2
AMP_F16 = dict(layers=2, batch=8, seq=128, masked=20, steps=8,
               init_loss_scaling=2.0 ** 24, incr_every_n_steps=2,
               decr_every_n_nan_or_inf=1, decr_ratio=2.0 ** -4)
#: 18d: the bench's other two models under bf16 AMP, phase 17's
#: configurations: warm-up and timed steps (cut before any gate is)
AMP_MODEL_WARMUP, AMP_MODEL_STEPS = 2, 5
#: 18e: the three models cut to 2 layers (ResNet: the zoo's smallest
#: depth, 18, on 16 images of 112, enough that 5 steps do not memorise
#: them) — the card's first bf16 step against the port's CPU run of the
#: same program and weights (relative), and at dropout 0 the bf16 loss
#: trajectory against the f32 one from the same weights on the card
#: (tests/test_amp.py:87's bound).  The ResNet runs Momentum(0.001, 0.9):
#: at the bench's 0.1 the first steps of a batch-norm net from random
#: weights are chaotic (phase 17a's note), so any two runs that round
#: differently part by far more than 5e-2 whatever their arithmetic
AMP_CPU_LOSS_RTOL = 5e-3
AMP_CURVE_RTOL = 5e-2
AMP_CURVE_STEPS = 5
AMP_GATE_BERT = (4, 128, 20)
AMP_GATE_RESNET = dict(depth=18, image=112, classes=1000, batch=16,
                       lr=1e-3)
AMP_GATE_NMT = (4, 64, 64)


def amp_masked_feed(vocab, batch, seq, masked, device, seed=SEED + 1800):
    """masked_arrays at ``seq`` and ``masked`` positions a row, on
    ``device``."""
    return _on(device, masked_arrays(vocab, batch, seed, seq, masked)[0])


def build_amp_bert(cfg, seq, masked, amp, opt=None, **amp_kw):
    """build_train at ``seq`` with ``masked`` positions a row, its Adam
    (or ``opt()``) under decorate(..., amp, **amp_kw) (as it is with
    ``amp`` None) -> (main, startup, loss)."""
    from paddle_tpu_torch.contrib import mixed_precision

    def wrap(adam, _):
        o = opt() if opt is not None else adam
        return o if amp is None else mixed_precision.decorate(
            o, amp_dtype=amp, **amp_kw)

    return build_train(cfg, masked, wrap, seq_len=seq)[:3]


def amp_plan_launches(main, feed_names, loss, cfg, rows, dtype, on_card):
    """The groups of the port's planner for ``main`` (what a CPU lowering
    plans: the planner reads the program alone) and each kernel
    variant's launches a step they give: #9, #5 and #6 one an attention
    group, #10 one a GEMM group within its rule (the MLM head's logits,
    N 30522, replay) and two an FFN group past the chain's rule (#11 one
    an FFN group within it)."""
    from paddle_tpu_torch.core.fusion import plan_fusion
    from paddle_tpu_torch.ops import ffn_chain as fc
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_matmul as fm

    plan = plan_fusion(main, list(main.global_block().ops), feed_names,
                       (loss.name,), block_patterns=True)
    kinds = collections.Counter(g.kind for g in plan.groups)
    chain = fc.ffn_chain_shapes_ok(rows, cfg.hidden_size, cfg.ffn_size,
                                   cfg.hidden_size, dtype)
    block = main.global_block()

    def w_shape(grp):
        uid, slot, j = grp.roles["w"]
        member = next(m for m in grp.members if m.uid == uid)
        return block.var(member.inputs[slot][j]).shape

    gemms = sum(fm.fused_shapes_ok(1, *w_shape(g), dtype)
                for g in plan.groups if g.kind == "gemm")
    want = {fa.QKV: kinds["attn"], fa.DQ: kinds["attn"],
            fa.DKV: kinds["attn"],
            fm.LAUNCH: gemms + (0 if chain else 2 * kinds["ffn_chain"]),
            fc.LAUNCH: kinds["ffn_chain"] if chain else 0, fa.FWD: 0}
    return plan, kinds, {amp_name(k, dtype): (n if on_card else 0)
                         for k, n in want.items()}


def _plan_key(plan):
    return [(g.kind, g.pattern, tuple(m.uid for m in g.members))
            for g in plan.groups]


def amp_bert_phase(device, cfg, shape, what):
    """18a / 18b: ``cfg`` pretraining under bf16 AMP at ``shape`` (batch,
    seq, masked positions) through the default fused program: the plan
    equal to the planner's, finite losses, each bf16 variant's launches
    per step as the plan gives them, no plain version and no library
    load after the warm-up; step ms, tokens/s, peak memory, one profiled
    step; then the same program without AMP for AMP_F32_STEPS steps."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda

    on_card = device.type == "cuda"
    B, T, masked = shape
    bf16 = torch.bfloat16
    main, startup, loss = build_amp_bert(cfg, T, masked, "bfloat16")
    exe = pt.Executor(pt.CUDAPlace(0) if on_card else pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = amp_masked_feed(cfg.vocab_size, B, T, masked, device)
    plan, kinds, want = amp_plan_launches(main, tuple(feed), loss, cfg,
                                          B * T, bf16, on_card)
    _free_card(device)
    t0 = time.perf_counter()
    warm = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
            for _ in range(AMP_WARMUP)]
    sync(device)
    warm_s = time.perf_counter() - t0
    lowered = [lw.fusion_plan for lw in main._exec_cache.values()]
    if [_plan_key(p) for p in lowered] != [_plan_key(plan)]:
        raise AssertionError(f"{what}: the lowered plan is not the "
                             f"planner's {dict(kinds)}")
    with _PlainCalls() as plain:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        losses = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                          return_numpy=False)[0] for _ in range(AMP_STEPS)]
        sync(device)
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
    losses = [float(x) for x in warm + losses]
    step_ms = wall / AMP_STEPS * 1e3
    tokens_per_s = B * T * AMP_STEPS / wall
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    got = {k: launches.get(k, 0) for k in want}
    per_step = {k: n * AMP_STEPS for k, n in want.items()}
    log(f"  {what}: bf16 AMP, {B} x {T} ({masked} masked a row), groups "
        f"{dict(kinds)}: {AMP_WARMUP} warm-up steps {warm_s:.2f} s; "
        f"{AMP_STEPS} steps {step_ms:.3f} ms/step, {tokens_per_s:.1f} "
        f"tokens/s, peak {peak / 2**30:.2f} GiB; losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; launches {got} (want {per_step}); plain versions "
        f"{plain.calls}; libraries loaded after the first step "
        f"{exe.compiles_after_first_step}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: a loss is not finite: {losses}")
    if got != per_step:
        raise AssertionError(f"{what}: launches {got}, expected {per_step}")
    if on_card and plain.calls:
        raise AssertionError(f"{what}: a plain kernel version ran")
    if exe.compiles_after_first_step:
        raise AssertionError(f"{what}: a library loaded after the first "
                             f"step")
    prof = _profile_step(exe, main, feed, loss, scope, device,
                         f"{what} bf16", names=("flash_", "gemm_tc_kernel",
                                                "ffn_chain"))
    del scope, exe
    _free_card(device)
    # the same program without AMP: the f32 step beside it
    main32, startup32, loss32 = build_amp_bert(cfg, T, masked, None)
    exe = pt.Executor(pt.CUDAPlace(0) if on_card else pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup32, scope=scope)
    exe.run(main32, feed=feed, fetch_list=[loss32], scope=scope)
    sync(device)
    t0 = time.perf_counter()
    f32_losses = [exe.run(main32, feed=feed, fetch_list=[loss32],
                          scope=scope, return_numpy=False)[0]
                  for _ in range(AMP_F32_STEPS)]
    sync(device)
    f32_ms = (time.perf_counter() - t0) / AMP_F32_STEPS * 1e3
    f32_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    log(f"  {what} f32 (no AMP), {AMP_F32_STEPS} steps: {f32_ms:.3f} "
        f"ms/step, {B * T / f32_ms * 1e3:.1f} tokens/s, peak "
        f"{f32_peak / 2**30:.2f} GiB; losses "
        + " ".join(f"{float(x):.4f}" for x in f32_losses))
    del scope, exe
    _free_card(device)
    return dict(batch=B, seq=T, masked=masked, losses=losses,
                step_ms=step_ms, tokens_per_s=tokens_per_s, peak_bytes=peak,
                launches=got, plan_groups=dict(kinds),
                busy_share=prof.get("device_busy_share"),
                kernels_share=prof.get("named_share"),
                device_ms=prof.get("device_ms_per_step"), profile=prof,
                f32_step_ms=f32_ms, f32_peak_bytes=f32_peak,
                f32_losses=[float(x) for x in f32_losses])


def _amp_scaling_names(program):
    names = {}
    for n in (v.name for v in program.list_vars() if v.persistable):
        for key in ("loss_scaling", "good_steps", "bad_steps"):
            if n.rsplit("_", 1)[0] == key:
                names[key] = n
    return names


def amp_f16_phase(device, cfg):
    """18c: fp16 AMP with dynamic loss scaling, the card against the
    port's CPU run of the same program and weights: loss_scaling,
    good_steps and bad_steps equal after every step (the overflowing
    ones too), the float16 variants launched; then AMP_F16_UNFUSED steps
    of the program's unfused lowering from the same weights on the card,
    whose attention ops run the packed float16 forward (#3) once a layer
    a step."""
    import dataclasses as dc

    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda

    p = AMP_F16
    cut = dc.replace(cfg, num_layers=p["layers"])
    kw = {k: p[k] for k in ("init_loss_scaling", "incr_every_n_steps",
                            "decr_every_n_nan_or_inf", "decr_ratio")}
    main, startup, loss = build_amp_bert(
        cut, p["seq"], p["masked"], "float16",
        opt=lambda: pt.optimizer.SGD(0.1), **kw)
    names = _amp_scaling_names(main)
    runs = {}
    weights = None
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        exe = pt.Executor(pt.CUDAPlace(0) if dev.type == "cuda"
                          else pt.CPUPlace())
        if weights is None:
            scope = pt.Scope()
            exe.run(startup, scope=scope)
            weights = _host_arrays(scope, main)
        scope = _scope_from(weights, dev, main)
        feed = amp_masked_feed(cut.vocab_size, p["batch"], p["seq"],
                               p["masked"], dev)
        _cuda.reset_launches()
        losses, states = [], []
        for _ in range(p["steps"]):
            losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope)[0]))
            states.append(tuple(float(scope.find_var(names[k]).item())
                                for k in ("loss_scaling", "good_steps",
                                          "bad_steps")))
        runs[dev.type] = dict(losses=losses, states=states,
                              launches=dict(_cuda.LAUNCHES),
                              seconds=time.perf_counter() - t0)
    card, cpu = runs[device.type], runs["cpu"]
    f16 = torch.float16
    kernels = [amp_name(k, f16) for k in (
        "flash_fwd_qkv", "flash_bwd_dq_packed", "flash_bwd_dkv_packed",
        "gemm_epilogue", "ffn_chain")]
    got = {k: card["launches"].get(k, 0) for k in kernels}
    bs = pt.BuildStrategy()
    bs.fuse_epilogues = False
    unfused = pt.CompiledProgram(main, build_strategy=bs)
    exe = pt.Executor(pt.CUDAPlace(0) if device.type == "cuda"
                      else pt.CPUPlace())
    scope = _scope_from(weights, device, main)
    feed = amp_masked_feed(cut.vocab_size, p["batch"], p["seq"],
                           p["masked"], device)
    _cuda.reset_launches()
    unfused_losses = [float(exe.run(unfused, feed=feed, fetch_list=[loss],
                                    scope=scope)[0])
                      for _ in range(AMP_F16_UNFUSED)]
    fwd = amp_name("flash_fwd_packed", f16)
    unfused_got = {k: _cuda.LAUNCHES.get(k, 0) for k in (
        fwd, amp_name("flash_bwd_dq_packed", f16),
        amp_name("flash_bwd_dkv_packed", f16))}
    want_fwd = p["layers"] * AMP_F16_UNFUSED if device.type == "cuda" \
        else 0
    log(f"  fp16 unfused lowering, {AMP_F16_UNFUSED} steps: losses "
        + " ".join(f"{x:.4f}" for x in unfused_losses)
        + f"; launches {unfused_got} ({fwd} want {want_fwd})")
    if unfused_got[fwd] != want_fwd \
            or not all(np.isfinite(unfused_losses)):
        raise AssertionError(f"fp16 unfused lowering: launches "
                             f"{unfused_got}, losses {unfused_losses}")
    for k, n in unfused_got.items():
        got[k] = got.get(k, 0) + n
    log(f"  fp16 AMP, BERT-base cut to {p['layers']} layers at "
        f"{p['batch']} x {p['seq']}, SGD(0.1), scale from "
        f"{p['init_loss_scaling']:g}: (scale, good, bad) on the card "
        f"{card['states']}, on the CPU {cpu['states']}; losses card "
        + " ".join(f"{x:.4f}" for x in card["losses"]) + " cpu "
        + " ".join(f"{x:.4f}" for x in cpu["losses"])
        + f"; float16 launches {got}; card {card['seconds']:.1f} s, CPU "
        f"{cpu['seconds']:.1f} s")
    if card["states"] != cpu["states"]:
        raise AssertionError("fp16 loss scaling on the card differs from "
                             "the CPU's")
    if card["states"][0][0] >= p["init_loss_scaling"]:
        raise AssertionError("fp16: the first step did not overflow")
    if device.type == "cuda" and not all(got.values()):
        raise AssertionError(f"fp16: a float16 variant did not launch: "
                             f"{got}")
    if not all(np.isfinite(card["losses"])):
        raise AssertionError(f"fp16: a loss is not finite: {card['losses']}")
    return dict(states=card["states"], cpu_states=cpu["states"],
                losses=card["losses"], cpu_losses=cpu["losses"],
                launches=got)


def amp_models_phase(device, nmt_cfg=None, resnet_kw=None):
    """18d: ResNet-50 (phase 17a's batch, halved until it fits) under
    decorate(Momentum(0.1, 0.9), "bfloat16") and NMT-big at 32 x 256/256
    under decorate(Adam(1e-4), "bfloat16"), dropout 0.3: finite losses,
    the bf16 variants' launches per step (ResNet: #10 once, the
    classifier; NMT: phase 17b's counts), no plain version; step ms,
    images/s, target tokens/s, peak memory.  ``nmt_cfg`` and
    ``resnet_kw`` (depth, image, classes) replace NMT-big and ResNet-50
    in a rehearsal."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.models import NMTConfig
    from paddle_tpu_torch.ops import fused_matmul as fm

    rk = dict(dict(depth=RESNET_DEPTH, image=RESNET_IMAGE,
                   classes=RESNET_CLASSES), **(resnet_kw or {}))
    on_card = device.type == "cuda"
    bf16 = torch.bfloat16
    out = {}
    exe = pt.Executor(pt.CUDAPlace(0) if on_card else pt.CPUPlace())

    def timed(main, loss, feed, scope, want, what, units):
        losses = [exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0] for _ in range(AMP_MODEL_WARMUP)]
        sync(device)
        with _PlainCalls() as plain:
            _cuda.reset_launches()
            t0 = time.perf_counter()
            losses += [exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope, return_numpy=False)[0]
                       for _ in range(AMP_MODEL_STEPS)]
            sync(device)
            wall = time.perf_counter() - t0
            launches = dict(_cuda.LAUNCHES)
        losses = [float(x) for x in losses]
        got = {k: launches.get(k, 0) for k in want}
        want = {k: n * AMP_MODEL_STEPS for k, n in want.items()}
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        step_ms = wall / AMP_MODEL_STEPS * 1e3
        log(f"  {what}: {AMP_MODEL_STEPS} steps {step_ms:.3f} ms/step, "
            f"{units / step_ms * 1e3:.1f} a second, peak "
            f"{peak / 2**30:.2f} GiB; losses "
            + " ".join(f"{x:.4f}" for x in losses)
            + f"; launches {got} (want {want}); plain versions "
            f"{plain.calls}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{what}: a loss is not finite")
        if got != want or (on_card and plain.calls):
            raise AssertionError(f"{what}: launches {got}, expected {want}, "
                                 f"plain calls {plain.calls}")
        return dict(steps=AMP_MODEL_STEPS, step_ms=step_ms,
                    per_s=units / step_ms * 1e3, peak_bytes=peak,
                    losses=losses, launches=got)

    for batch in RESNET_BATCHES:
        _free_card(device)
        main, startup, loss, _ = build_resnet(
            rk["depth"], rk["image"], rk["classes"], amp="bfloat16")
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        feed = resnet_feed(batch, rk["image"], rk["classes"], device)
        try:
            r = timed(main, loss, feed, scope,
                      {amp_name(fm.LAUNCH, bf16): 1 if on_card else 0},
                      f"ResNet-{rk['depth']} bf16 AMP at batch {batch}",
                      batch)
        except RuntimeError as e:
            if not _step_oom(e):
                raise
            log(f"  ResNet bf16 at batch {batch}: out of memory, halving")
            del scope, feed
            continue
        r.update(batch=batch, images_per_s=r.pop("per_s"))
        out["resnet"] = r
        break
    del scope, feed
    _free_card(device)
    cfg = nmt_cfg or NMTConfig.big()
    main, startup, loss = build_nmt(cfg, NMT_SRC, NMT_TGT, amp="bfloat16")
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = nmt_feed(cfg, NMT_BATCH, NMT_SRC, NMT_TGT, device)
    want = {amp_name(k, bf16): n
            for k, n in nmt_step_launches(cfg, on_card).items()}
    r = timed(main, loss, feed, scope, want,
              f"NMT-big bf16 AMP at {NMT_BATCH} x {NMT_SRC}/{NMT_TGT}",
              NMT_BATCH * NMT_TGT)
    r["target_tokens_per_s"] = r.pop("per_s")
    out["nmt"] = r
    del scope, feed
    _free_card(device)
    return out


def _amp_gate_run(device, build, feed_fn, steps, weights=None):
    """Build with ``build(amp)`` for amp in (bf16, None), run ``steps``
    steps of each from the same startup weights on ``device``; the
    weights come from the bf16 program's startup (or ``weights``) ->
    ({amp: losses}, weights)."""
    import paddle_tpu_torch as pt

    out = {}
    for amp in ("bfloat16", None):
        main, startup, loss = build(amp)
        exe = pt.Executor(pt.CUDAPlace(0) if device.type == "cuda"
                          else pt.CPUPlace())
        if weights is None:
            scope = pt.Scope()
            exe.run(startup, scope=scope)
            weights = _host_arrays(scope, main)
        scope = _scope_from(weights, device, main)
        feed = feed_fn(device)
        out[amp] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                  scope=scope)[0]) for _ in range(steps)]
        del scope
    return out, weights


def amp_gates_phase(device, bert=None, nmt=None):
    """18e: BERT-large cut to 2 layers (dropout 0, 4 x 128), ResNet-18 on
    4 images, NMT-big cut to 2 + 2 layers (dropout 0, 4 x 64/64): the
    card's first bf16 step within AMP_CPU_LOSS_RTOL of the port's CPU run
    of the same program and weights, and on the card the bf16 loss
    trajectory within AMP_CURVE_RTOL of the f32 one from the same
    weights.  ``bert`` and ``nmt`` (configurations) replace the cut
    BERT-large and NMT-big in a rehearsal."""
    import dataclasses as dc

    import torch

    from paddle_tpu_torch.models import BertConfig, NMTConfig

    cpu = torch.device("cpu")
    bert = dc.replace(bert or BertConfig.large(), num_layers=2,
                      hidden_dropout=0.0, attn_dropout=0.0)
    B, T, masked = AMP_GATE_BERT
    rk = AMP_GATE_RESNET
    nmt = dc.replace(nmt or NMTConfig.big(), num_encoder_layers=2,
                     num_decoder_layers=2, dropout=0.0, attn_dropout=0.0)
    nb, ns, nt = AMP_GATE_NMT

    def bert_build(amp):
        return build_amp_bert(bert, T, masked, amp)

    def resnet_build(amp):
        return build_resnet(rk["depth"], rk["image"], rk["classes"],
                            amp=amp, lr=rk["lr"])[:3]

    def nmt_build(amp):
        return build_nmt(nmt, ns, nt, amp=amp)

    models = {
        "bert_large_2l": (bert_build, lambda d: amp_masked_feed(
            bert.vocab_size, B, T, masked, d)),
        "resnet18": (resnet_build, lambda d: resnet_feed(
            rk["batch"], rk["image"], rk["classes"], d)),
        "nmt_big_2l": (nmt_build, lambda d: nmt_feed(nmt, nb, ns, nt, d)),
    }
    out = {}
    for name, (build, feed_fn) in models.items():
        t0 = time.perf_counter()
        card, weights = _amp_gate_run(device, build, feed_fn,
                                      AMP_CURVE_STEPS)
        t1 = time.perf_counter()
        host, _ = _amp_gate_run(cpu, build, feed_fn, 1, weights)
        t2 = time.perf_counter()
        first = abs(card["bfloat16"][0] - host["bfloat16"][0]) \
            / abs(host["bfloat16"][0])
        curve = max(abs(a - b) / abs(b)
                    for a, b in zip(card["bfloat16"], card[None]))
        log(f"  {name}: first bf16 loss card {card['bfloat16'][0]:.6f}, "
            f"cpu {host['bfloat16'][0]:.6f} (rel {first:.2e}, tol "
            f"{AMP_CPU_LOSS_RTOL:g}); bf16 trajectory "
            + " ".join(f"{x:.4f}" for x in card["bfloat16"]) + " f32 "
            + " ".join(f"{x:.4f}" for x in card[None])
            + f" (worst rel {curve:.2e}, tol {AMP_CURVE_RTOL:g}); card "
            f"{t1 - t0:.1f} s, CPU {t2 - t1:.1f} s")
        if not (first <= AMP_CPU_LOSS_RTOL and curve <= AMP_CURVE_RTOL):
            raise AssertionError(f"18e {name}: first-step rel {first}, "
                                 f"trajectory rel {curve}")
        out[name] = dict(first_rel=first, curve_rel=curve,
                         bf16=card["bfloat16"], f32=card[None],
                         cpu_first=host["bfloat16"][0])
        _free_card(device)
    return out


def amp_phase(device, large_cfg=None, base_cfg=None, nmt_cfg=None,
              resnet_kw=None):
    """Phase 18: 18a BERT-large, 18b BERT-base (bf16), 18c fp16 loss
    scaling against the CPU, 18d ResNet-50 and NMT-big (bf16), 18e the
    gates against the CPU and against f32.  The configurations replace
    the bench's in a rehearsal."""
    from paddle_tpu_torch.models import BertConfig

    t0 = time.perf_counter()
    large_cfg = large_cfg or BertConfig.large()
    base_cfg = base_cfg or BertConfig.base()
    parts = dict(
        large=lambda: amp_bert_phase(device, large_cfg, AMP_LARGE,
                                     "18a BERT-large"),
        base=lambda: amp_bert_phase(device, base_cfg, AMP_BASE,
                                    "18b BERT-base"),
        f16=lambda: amp_f16_phase(device, base_cfg),
        models=lambda: amp_models_phase(device, nmt_cfg, resnet_kw),
        gates=lambda: amp_gates_phase(device, large_cfg, nmt_cfg))
    out, part_s = {}, {}
    for name, run in parts.items():
        t1 = time.perf_counter()
        out[name] = run()
        part_s[name] = time.perf_counter() - t1
    out["part_s"] = part_s
    launches = collections.Counter()
    for part in (out["large"], out["base"], out["f16"],
                 out["models"]["resnet"], out["models"]["nmt"]):
        launches.update(part["launches"])
    out["launches"] = dict(launches)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 18 took {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items())
        + f"); launches {out['launches']}")
    return out


CHILDREN = {"bert_ps": bert_ps_child, "fleet_modes": fleet_modes_child}


# -- phase 19: the Megatron split under {model: 2}, sync-BN under {data: 2} ---

#: 19a's steps (each of fused and unfused), 19b's steps and shape (NMT-big
#: at full depth, dropout 0), 19c's steps, images a rank and learning
#: rate (ResNet-50's early-layer gradients are ill-conditioned at random
#: weights: on an H100 at 0.01 the second step's loss parted from one
#: rank's by 4.3e-3, the first's by 2e-6), and the rate of 19c's control
#: run (recorded, not gated: the two ranks and the world-1 mesh each
#: against one rank at the rate that parted), the gates, the ranks' time
#: limit.  Whole parameters are held by their worst element and by each
#: parameter's distance from the one rank's over the one rank's update
#: of it (relative norms).  A rank whose shard of a parameter never
#: updated leaves at least 0.7 of that update; one product on the other
#: side of relu's 0 from the one rank's (phase 2 counts one in 4M at
#: NMT's FFN) gives its unit a gradient in one run only, and Adam then
#: moves that element by about lr a step in that run alone: 1/sqrt(n) of
#: an n-element parameter's update, 1/32 at 1024.
TP_STEPS, TP_NMT_STEPS = 5, 3
TP_NMT_BATCH, TP_NMT_LEN = 16, 128
TP_BN_STEPS, TP_BN_PER_RANK, TP_BN_LR = 2, 32, 1e-3
TP_BN_CONTROL_LR = 1e-2
TP_PARAM_TOL, TP_PARAM_REL_TOL, TP_STAT_TOL = 1e-3, 0.1, 1e-4
TP_RANK_TIMEOUT_S = 900.0
#: overrides of BertConfig.base() and NMTConfig.big() (a rehearsal's cuts)
TP_BERT, TP_NMT = {}, {}
#: 19a's kernels per layer, rank and step (6 of 12 heads a rank): the
#: attention output on #10 with its epilogue off, the FFN on #11 at F
#: 1536 with its epilogue off (the vocab logits, N 15261, replay)
TP_FUSED_KERNELS = {"flash_fwd_qkv": 1, "flash_bwd_dq_packed": 1,
                    "flash_bwd_dkv_packed": 1, "gemm_epilogue": 1,
                    "ffn_chain": 1}
TP_UNFUSED_KERNELS = {"flash_fwd_packed": 1, "flash_bwd_dq_packed": 1,
                      "flash_bwd_dkv_packed": 1, "gemm_epilogue": 0,
                      "ffn_chain": 0}


def _tp_target(main, axes, fuse=True, rules=None, device_type="cuda"):
    from paddle_tpu_torch.compiler import BuildStrategy, CompiledProgram
    from paddle_tpu_torch.parallel import build_mesh

    bs = BuildStrategy()
    bs.fuse_epilogues = fuse
    target = CompiledProgram(main, build_strategy=bs)
    if axes is None:
        return target
    if axes == "local":
        # {data: 1} without a process group: the mesh lowering at world 1
        from paddle_tpu_torch.parallel import LocalMesh

        return target.with_sharding(LocalMesh(device_type=device_type))
    return target.with_sharding(build_mesh(axes, device_type=device_type),
                                param_rules=rules)


def _tp_jobs(device):
    """19a-c's programs, feeds and meshes, the same in the parent (one
    rank, no mesh) and in the two ranks."""
    from paddle_tpu_torch.models import (BertConfig, NMTConfig,
                                         nmt_tp_sharding_rules,
                                         tp_sharding_rules)

    bert = dataclasses.replace(_zero_dropout(BertConfig.base()), **TP_BERT)
    nmt = dataclasses.replace(NMTConfig.big(), dropout=0.0,
                              attn_dropout=0.0, **TP_NMT)
    jobs = []
    for fuse in (True, False):
        jobs.append(dict(
            name="bert_fused" if fuse else "bert_unfused", fuse=fuse,
            steps=TP_STEPS, axes={"model": 2}, rules=tp_sharding_rules,
            build=lambda: build_train(bert)[:3],
            feed=lambda: train_batch(bert.vocab_size, device)))
    jobs.append(dict(
        name="nmt_big", fuse=True, steps=TP_NMT_STEPS, axes={"model": 2},
        rules=nmt_tp_sharding_rules,
        build=lambda: build_nmt(nmt, TP_NMT_LEN, TP_NMT_LEN),
        feed=lambda: nmt_feed(nmt, TP_NMT_BATCH, TP_NMT_LEN, TP_NMT_LEN,
                              device)))
    for name, lr in (("resnet50", TP_BN_LR),
                     ("resnet50_control", TP_BN_CONTROL_LR)):
        jobs.append(dict(
            name=name, fuse=True, steps=TP_BN_STEPS, axes={"data": 2},
            rules=None,
            build=lambda lr=lr: build_resnet(RESNET_DEPTH, RESNET_IMAGE,
                                             RESNET_CLASSES, lr=lr)[:3],
            feed=lambda: resnet_feed(2 * TP_BN_PER_RANK, RESNET_IMAGE,
                                     RESNET_CLASSES, device)))
    return jobs


def _bn_stats(main, scope):
    """The batch-norm running statistics as host arrays."""
    names = [v.name for v in main.list_vars() if v.persistable
             and v.name.startswith("batch_norm")
             and (".mean" in v.name or ".variance" in v.name)]
    return {n: scope.find_var(n).detach().float().cpu() for n in names}


def _params(main, scope):
    return {p.name: scope.find_var(p.name).detach().float().cpu().clone()
            for p in main.all_parameters()}


def _tp_run(job, exe, device, axes, init=None):
    """One job's steps from its startup (``axes`` None: one rank) ->
    (losses, scope, main, launches, peak bytes, wall s, stats after the
    first step); ``init``, a dict, receives the startup's parameters."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda

    main, startup, loss = job["build"]()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    if init is not None:
        init.update(_params(main, scope))
    target = _tp_target(main, axes, job["fuse"],
                        job["rules"]() if axes and job["rules"] else None,
                        device.type)
    feed = job["feed"]()
    _free_card(device)
    sync(device)
    before = dict(_cuda.LAUNCHES)
    t0 = time.perf_counter()
    losses, stats = [], None
    for s in range(job["steps"]):
        losses.append(float(exe.run(target, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
        if stats is None:
            stats = _bn_stats(main, scope)
    sync(device)
    wall = time.perf_counter() - t0
    launches = {k: v - before.get(k, 0) for k, v in _cuda.LAUNCHES.items()
                if v - before.get(k, 0)}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    return losses, scope, main, launches, peak, wall, stats


def _tp_rank(rank, store, out_dir, job_dev, ref_dir):
    """One of phase 19's two gloo ranks on the card (or the CPU in a
    rehearsal): every job of ``_tp_jobs`` on its mesh, each rank's whole
    parameters after the steps held against the one-rank run's."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch import set_strict_fp32
    from paddle_tpu_torch.core.spmd import whole_value

    set_strict_fp32()
    device = torch.device(job_dev.pop("device"))
    globals().update(job_dev.pop("globals"))
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    res = {}
    try:
        exe = _executor(device)
        for job in _tp_jobs(device):
            losses, scope, main, launches, peak, wall, stats = _tp_run(
                job, exe, device, job["axes"])
            ref = torch.load(os.path.join(ref_dir, job["name"] + ".pt"),
                             weights_only=False)
            # the worst element, and the worst parameter's distance over
            # the one rank's update of it, with the count of its elements
            # that parted by more than a tenth of its largest move
            dparam, rel, worst, parted = 0.0, 0.0, None, None
            for n, want in ref["params"].items():
                got = whole_value(scope, n, scope.find_var(n))
                d = got.detach().float().cpu() - want
                dparam = max(dparam, float(d.abs().max()))
                norm, top = ref["moved"][n]
                r = float(d.norm()) / max(norm, 1e-30)
                if worst is None or r > rel:
                    rel, worst = r, n
                    parted = [int((d.abs() > 0.1 * top).sum()), d.numel()]
            dstat = max((float((stats[n] - v).abs().max())
                         for n, v in ref["stats"].items()), default=0.0)
            plan = next(lw.mesh_plan for lw in main._exec_cache.values()
                        if lw.mesh_plan is not None)
            split = plan.split
            qkv = scope.find_var("encoder.layer0.attn.qkv.w")
            res[job["name"]] = dict(
                losses=losses, launches=launches, peak_bytes=peak,
                step_ms=wall / job["steps"] * 1e3, max_dparam=dparam,
                max_dparam_rel=rel, worst_param=worst,
                worst_param_parted=parted, max_dstat=dstat,
                stats=dict(plan.last_stats),
                planned=None if split is None else split.planned,
                qkv_shard=None if qkv is None else list(qkv.shape))
            del scope, main
            _free_card(device)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"tp{rank}.json"), "w") as f:
        json.dump(res, f)


def tensor_parallel_phase(device):
    """Phase 19: BERT-base at {model: 2} fused and unfused (19a), NMT-big
    at {model: 2} (19b), ResNet-50 at {data: 2} under sync-BN (19c, and
    its control at TP_BN_CONTROL_LR), on two gloo ranks sharing the
    card, each against the one-rank run of the same program on the
    card."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    exe = _executor(device)
    one = {}
    with tempfile.TemporaryDirectory() as tmp:
        for job in _tp_jobs(device):
            init = {}
            losses, scope, main, launches, peak, wall, stats = _tp_run(
                job, exe, device, None, init)
            params = _params(main, scope)
            moved = {n: (float((v - init[n]).norm()),
                         float((v - init[n]).abs().max()))
                     for n, v in params.items()}
            torch.save(dict(params=params, moved=moved, stats=stats),
                       os.path.join(tmp, job["name"] + ".pt"))
            one[job["name"]] = dict(losses=losses, launches=launches,
                                    peak_bytes=peak,
                                    step_ms=wall / job["steps"] * 1e3)
            del scope, main, params, init
            _free_card(device)
            if job["name"].startswith("resnet50"):
                # the same statistics' formula at world 1: how far two
                # f32 runs of this step part without a second rank
                one[job["name"]]["world1_losses"] = _tp_run(
                    job, exe, device, "local")[0]
                _free_card(device)
        job_dev = dict(device=str(device), globals=dict(
            TRAIN_BATCH=TRAIN_BATCH, TRAIN_SEQ=TRAIN_SEQ, TP_STEPS=TP_STEPS,
            TP_NMT_STEPS=TP_NMT_STEPS, TP_NMT_BATCH=TP_NMT_BATCH,
            TP_NMT_LEN=TP_NMT_LEN, TP_BN_STEPS=TP_BN_STEPS,
            TP_BN_PER_RANK=TP_BN_PER_RANK, RESNET_IMAGE=RESNET_IMAGE,
            RESNET_DEPTH=RESNET_DEPTH, RESNET_CLASSES=RESNET_CLASSES,
            TP_BERT=TP_BERT, TP_NMT=TP_NMT))
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            _tp_rank, args=(f"{tmp}/store", tmp, job_dev, tmp), nprocs=2,
            join=False, start_method="spawn")
        deadline = time.monotonic() + TP_RANK_TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise AssertionError(f"19: the gloo ranks still run after "
                                     f"{TP_RANK_TIMEOUT_S} s")
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"tp{r}.json")) as f:
                ranks.append(json.load(f))
    out = {"spawn_s": spawn_s, "jobs": {}}
    for name, ref in one.items():
        got = [r[name] for r in ranks]
        out["jobs"][name] = j = dict(
            one_rank=ref, ranks=got,
            max_dloss=max(abs(a - b) for g in got
                          for a, b in zip(g["losses"], ref["losses"])),
            max_dparam=max(g["max_dparam"] for g in got),
            max_dparam_rel=max(g["max_dparam_rel"] for g in got),
            **{k: max(got, key=lambda g: g["max_dparam_rel"])[k]
               for k in ("worst_param", "worst_param_parted")},
            max_dstat=max(g["max_dstat"] for g in got))
        if "world1_losses" in ref:
            j["world1_dloss"] = max(abs(a - b) for a, b in zip(
                ref["world1_losses"], ref["losses"]))
        log(f"  19 {name}, two ranks at "
            f"{'{data: 2}' if name.startswith('resnet') else '{model: 2}'}: "
            f"losses {[g['losses'] for g in got]} against one rank's "
            f"{ref['losses']}: max |dloss| {j['max_dloss']:.3e}"
            + (f" (the world-1 mesh against one rank: "
               f"{j['world1_dloss']:.3e})" if "world1_dloss" in j else "")
            + f", whole params {j['max_dparam']:.3e} (worst parameter "
            f"{j['worst_param']}: {j['max_dparam_rel']:.3e} of the one "
            f"rank's update; {j['worst_param_parted'][0]} of its "
            f"{j['worst_param_parted'][1]} elements parted by more than a "
            f"tenth of its largest move), stats "
            f"{j['max_dstat']:.3e}; step {got[0]['step_ms']:.1f} ms a rank "
            f"(gloo through the host) against {ref['step_ms']:.1f} one "
            f"rank; peak {[g['peak_bytes'] for g in got]} B a rank against "
            f"{ref['peak_bytes']}; launches a rank {got[0]['launches']}; "
            f"collectives {got[0]['stats']}")
    for name, j in out["jobs"].items():
        if name != "resnet50_control" and not j["max_dloss"] \
                < PARITY_LOSS_TOL:
            raise AssertionError(f"19 {name}: max |dloss| "
                                 f"{j['max_dloss']:.3e}")
        if not name.startswith("resnet") and not (
                j["max_dparam"] < TP_PARAM_TOL
                and j["max_dparam_rel"] < TP_PARAM_REL_TOL):
            raise AssertionError(
                f"19 {name}: whole parameters {j['max_dparam']:.3e} from "
                f"the one rank's, {j['worst_param']} "
                f"{j['max_dparam_rel']:.3e} of its update")
        if name.startswith("resnet") and not j["max_dstat"] < TP_STAT_TOL:
            raise AssertionError(f"19c {name}: running statistics "
                                 f"{j['max_dstat']:.3e} from the one rank's")
        for g in j["ranks"]:
            if g["stats"].get("whole_gathers", 0):
                raise AssertionError(f"19 {name}: whole gathers "
                                     f"{g['stats']}")
            if g["planned"] is not None:
                seen = {k: g["stats"].get(k, 0) for k in g["planned"]}
                if seen != g["planned"]:
                    raise AssertionError(f"19 {name}: collectives {seen}, "
                                         f"planned {g['planned']}")
    from paddle_tpu_torch.models import BertConfig, NMTConfig

    bert = dataclasses.replace(BertConfig.base(), **TP_BERT)
    nl = dataclasses.replace(NMTConfig.big(), **TP_NMT).num_encoder_layers
    for name, want in (("bert_fused", TP_FUSED_KERNELS),
                       ("bert_unfused", TP_UNFUSED_KERNELS)):
        for g in out["jobs"][name]["ranks"]:
            got = {k: g["launches"].get(k, 0) for k in want}
            if device.type == "cuda" and got != {
                    k: v * bert.num_layers * TP_STEPS
                    for k, v in want.items()}:
                raise AssertionError(f"19a {name}: launches {got} per rank "
                                     f"in {TP_STEPS} steps, want {want} a "
                                     f"layer and step")
            if g["qkv_shard"] != [bert.hidden_size,
                                  3 * bert.hidden_size // 2]:
                raise AssertionError(f"19a: qkv shard {g['qkv_shard']}")
    nmt = out["jobs"]["nmt_big"]["ranks"][0]["launches"]
    # self-attention on #9 (encoder and decoder), the cross-attention on
    # #3, both backward kernels for all three
    want_nmt = {"flash_fwd_qkv": 2 * nl, "flash_fwd_packed": nl,
                "flash_bwd_dq_packed": 3 * nl, "flash_bwd_dkv_packed": 3 * nl}
    if device.type == "cuda" and (
            {k: nmt.get(k, 0) for k in want_nmt}
            != {k: v * TP_NMT_STEPS for k, v in want_nmt.items()}
            or not nmt.get("gemm_epilogue")):
        raise AssertionError(f"19b: launches {nmt}")
    if device.type == "cuda" and not out["jobs"]["resnet50"]["ranks"][0][
            "launches"].get("gemm_epilogue"):
        raise AssertionError("19c: the classifier's #10 never launched")
    # phase 19's launches on the kernels line: rank 0's of the split runs
    out["launches"] = {}
    for j in out["jobs"].values():
        for k, n in j["ranks"][0]["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + n
    return out


def child_main(argv):
    """Run a phase-16 child: ``--child <name> <json kwargs>`` or
    ``--local-sgd-rank <out_dir>``."""
    if argv[0] == "--local-sgd-rank":
        return local_sgd_rank(argv[1])
    CHILDREN[argv[1]](**json.loads(argv[2]))
    return 0


# -- phase 20: dygraph (imperative mode) --------------------------------------

#: phase 20's eager training: warm-up and timed steps (phase 5's batch,
#: sequence and Adam rate), the 2-layer card-against-CPU parity cut
#: (dropout 0; losses within phase 5's PARITY_LOSS_TOL, every parameter
#: within DY_PARAM_ATOL), the traced program against the eager forward,
#: the @declarative loop's trips
DY_WARMUP, DY_STEPS = 2, 10
DY_PARITY_LAYERS, DY_PARITY_BATCH, DY_PARITY_STEPS = 2, 8, 2
DY_PARAM_ATOL = 1e-3
DY_TRACE_ATOL = 1e-4
DY_PREDICTOR_ATOL = 1e-5
DY_LOOP_TRIPS, DY_LOOP_ATOL = 4, 1e-5
DY_SEED = SEED + 20
#: the package phase 20d's function is transpiled over (to_static copies
#: a function's globals when it transpiles)
_PT = None


def dygraph_bert(pkg, cfg):
    """BERT's encoder and tied MLM logits as a dygraph Layer of ``pkg``
    (paddle_tpu_torch here; the CPU tests build the same source over the
    JAX package too): word, position and type Embeddings then LayerNorm;
    per layer a qkv Linear(H, 3H), three slices, fused_multihead_attention
    (num_heads, the key-padding bias, cfg.attn_dropout, is_test in eval
    mode), an output Linear, residual + LayerNorm, Linear(H, F, gelu),
    Linear(F, H), residual + LayerNorm; logits = h · word_embᵀ.  Weights
    are N(0, initializer_range) (LayerNorm 1/0, biases 0), drawn from
    ``pkg.dygraph.seed``.  forward(src, pos, sent, bias) -> logits
    [B, T, V]."""
    import math

    dg, dnn, L = pkg.dygraph, pkg.dygraph.nn, pkg.layers
    H, nh, F = cfg.hidden_size, cfg.num_heads, cfg.ffn_size

    def w():
        return pkg.ParamAttr(initializer=pkg.initializer.NormalInitializer(
            0.0, cfg.initializer_range))

    class EncoderLayer(dg.Layer):
        def __init__(self):
            super().__init__()
            self.qkv = dnn.Linear(H, 3 * H, param_attr=w())
            self.out = dnn.Linear(H, H, param_attr=w())
            self.ln1 = dnn.LayerNorm(H)
            self.ffn_in = dnn.Linear(H, F, param_attr=w(), act="gelu")
            self.ffn_out = dnn.Linear(F, H, param_attr=w())
            self.ln2 = dnn.LayerNorm(H)

        def forward(self, x, bias):
            qkv = self.qkv(x)
            q = L.slice(qkv, [2], [0], [H])
            k = L.slice(qkv, [2], [H], [2 * H])
            v = L.slice(qkv, [2], [2 * H], [3 * H])
            ctxt = L.fused_multihead_attention(
                q, k, v, attn_bias=bias, dropout_rate=cfg.attn_dropout,
                sm_scale=1.0 / math.sqrt(H // nh),
                is_test=not self.training, num_heads=nh)
            x = self.ln1(x + self.out(ctxt))
            return self.ln2(x + self.ffn_out(self.ffn_in(x)))

    class Bert(dg.Layer):
        def __init__(self):
            super().__init__()
            self.word = dnn.Embedding([cfg.vocab_size, H], param_attr=w())
            self.pos = dnn.Embedding([cfg.max_position, H], param_attr=w())
            self.sent = dnn.Embedding([cfg.type_vocab_size, H],
                                      param_attr=w())
            self.ln = dnn.LayerNorm(H)
            self.encoder = [self.add_sublayer(f"layer{i}", EncoderLayer())
                            for i in range(cfg.num_layers)]

        def forward(self, src, pos, sent, bias):
            x = self.ln(self.word(src) + self.pos(pos) + self.sent(sent))
            for layer in self.encoder:
                x = layer(x, bias)
            return L.matmul(x, self.word.weight, transpose_y=True)

    return Bert()


def dygraph_arrays(cfg, batch, seq, seed=DY_SEED):
    """Phase 20's batch from a numpy seed: token ids, position and type
    ids, the key-padding bias [B, 1, 1, T] (-1e4 on a quarter of the
    rows' padded tails, train_batch's mask), labels [B, T, 1] at ~15% of
    the real positions (-1 elsewhere) and their count ``n_valid``."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    mask = np.ones((batch, seq), np.float32)
    for b in range(batch // 4):
        mask[b, rng.randint(seq // 2, seq):] = 0.0
    labels = np.full((batch, seq, 1), -1, np.int64)
    pick = (rng.rand(batch, seq) < 0.15) & (mask > 0)
    labels[pick] = src[pick][:, None]
    return dict(src=src, pos=np.tile(np.arange(seq, dtype=np.int64),
                                     (batch, 1)),
                sent=np.zeros((batch, seq), np.int64),
                bias=((mask - 1.0) * 1e4)[:, None, None, :],
                labels=labels, n_valid=max(int(pick.sum()), 1))


def dygraph_feeds(pkg, arrays):
    """dygraph_arrays' arrays as VarBases on the guard's device."""
    return {k: v if k == "n_valid" else pkg.dygraph.to_variable(v)
            for k, v in arrays.items()}


def dygraph_loss(pkg, model, feeds):
    """The mean MLM cross entropy over the labelled positions; ``feeds``:
    dygraph_arrays' arrays, or dygraph_feeds' VarBases of them."""
    dg, L = pkg.dygraph, pkg.layers
    v = {k: dg.to_variable(feeds[k])
         for k in ("src", "pos", "sent", "bias", "labels")}
    logits = model(v["src"], v["pos"], v["sent"], v["bias"])
    ce = L.softmax_with_cross_entropy(logits, v["labels"], ignore_index=-1)
    return L.reduce_sum(ce) * (1.0 / feeds["n_valid"])


def dygraph_step(pkg, model, opt, feeds):
    """One eager training step: forward, backward, the optimizer, clear;
    returns the loss VarBase."""
    loss = dygraph_loss(pkg, model, feeds)
    loss.backward()
    opt.minimize(loss)
    model.clear_gradients()
    return loss


def _dy_params(model):
    return {k: np.asarray(v).copy() for k, v in model.state_dict().items()}


class _EagerOps:
    """Counts the registered op computes (the eager op dispatches of a
    dygraph model without inline ops) while active."""

    def __enter__(self):
        from paddle_tpu_torch.core.registry import REGISTRY

        self.n, self.saved = 0, []
        for od in REGISTRY._ops.values():
            self.saved.append((od, od.compute))

            def counted(*a, _fn=od.compute, **kw):
                self.n += 1
                return _fn(*a, **kw)

            od.compute = counted
        return self

    def __exit__(self, *exc):
        for od, fn in self.saved:
            od.compute = fn
        return False


def dygraph_train_phase(device, cfg):
    """20a: phase 5's batch through dygraph_bert(cfg) eagerly with
    Adam(TRAIN_LR): DY_WARMUP + DY_STEPS steps — finite losses, the packed
    flash forward, dq and dk/dv kernels once a layer a step each and no
    other port kernel, no plain version; step ms, peak memory, host µs
    per eager op (the forward's dispatch over its op count), one profiled
    step's busy share.  Returns (report, model, optimizer, feeds)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import _cuda, dygraph as dg
    from paddle_tpu_torch.ops import flash_attention as fa

    on_card = device.type == "cuda"
    L = cfg.num_layers
    with dg.guard(device):
        dg.seed(DY_SEED)
        t0 = time.perf_counter()
        with pt.unique_name.guard():
            model = dygraph_bert(pt, cfg)
        sync(device)
        build_s = time.perf_counter() - t0
        opt = pt.optimizer.Adam(TRAIN_LR, parameter_list=model.parameters())
        feeds = dygraph_feeds(pt, dygraph_arrays(cfg, TRAIN_BATCH,
                                                 TRAIN_SEQ))
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        losses = [dygraph_step(pt, model, opt, feeds)
                  for _ in range(DY_WARMUP)]
        sync(device)
        loads = _cuda.library_loads()
        with _PlainCalls() as plain:
            _cuda.reset_launches()
            t0 = time.perf_counter()
            losses += [dygraph_step(pt, model, opt, feeds)
                       for _ in range(DY_STEPS)]
            sync(device)
            wall = time.perf_counter() - t0
            launches = _launch_gate(
                dict(_cuda.LAUNCHES), {fa.FWD: L * DY_STEPS,
                                       fa.DQ: L * DY_STEPS,
                                       fa.DKV: L * DY_STEPS},
                "20a eager steps", on_card)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        losses = [float(x.numpy()) for x in losses]
        # the host's cost: the forward's dispatch (enqueued, not synced)
        # over its eager ops, and the whole step's
        sync(device)
        with _EagerOps() as ops:
            t0 = time.perf_counter()
            loss = dygraph_loss(pt, model, feeds)
            fwd_host_s = time.perf_counter() - t0
        n_fwd = ops.n
        sync(device)
        with _EagerOps() as ops:
            t0 = time.perf_counter()
            loss.backward()
            opt.minimize(loss)
            model.clear_gradients()
            rest_host_s = time.perf_counter() - t0
        n_opt = ops.n
        sync(device)
        prof = _profile_call(lambda: dygraph_step(pt, model, opt, feeds),
                             device, "20a eager", ("flash_",),
                             "the flash kernels")
    step_ms = wall / DY_STEPS * 1e3
    out = dict(
        build_s=build_s, step_ms=step_ms,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ * DY_STEPS / wall,
        losses=losses, launches=launches, plain_calls=plain.calls,
        loads_after_warmup=_cuda.library_loads() - loads, peak_bytes=peak,
        n_params=sum(int(np.prod(p.shape)) for p in model.parameters()),
        forward_ops=n_fwd, forward_host_ms=fwd_host_s * 1e3,
        host_us_per_op=fwd_host_s * 1e6 / max(n_fwd, 1),
        update_ops=n_opt, backward_update_host_ms=rest_host_s * 1e3,
        profile=prof)
    log(f"  20a dygraph BERT ({out['n_params']} parameters, {L} layers) "
        f"eager, batch {TRAIN_BATCH} x {TRAIN_SEQ}, Adam({TRAIN_LR:g}), "
        f"attention dropout {cfg.attn_dropout}: built in {build_s:.2f} s; "
        f"{DY_STEPS} steps {step_ms:.3f} ms/step "
        f"({out['tokens_per_s']:.1f} tokens/s); losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; launches {launches}; plain versions {plain.calls}; "
        f"libraries loaded after warm-up {out['loads_after_warmup']}; "
        f"peak memory {peak / 2**30:.2f} GiB; forward: {n_fwd} eager ops "
        f"in {fwd_host_s * 1e3:.2f} ms of host "
        f"({out['host_us_per_op']:.1f} us an op); backward + Adam + clear "
        f"{rest_host_s * 1e3:.2f} ms of host ({n_opt} eager ops)")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"20a: a loss is not finite: {losses}")
    if on_card and (plain.calls or out["loads_after_warmup"]):
        raise AssertionError(f"20a: plain versions {plain.calls}, loads "
                             f"{out['loads_after_warmup']}")
    return out, model, opt, feeds


def dygraph_parity_phase(device, cfg):
    """20a's gate: dygraph_bert(cfg) cut to DY_PARITY_LAYERS at dropout 0,
    DY_PARITY_STEPS Adam steps on DY_PARITY_BATCH rows on the card and
    the same steps from the same weights on the CPU (the kernels' plain
    versions): every loss within PARITY_LOSS_TOL, every parameter after
    the steps within DY_PARAM_ATOL (the distance over the CPU run's own
    update reported)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph as dg

    small = _zero_dropout(cfg, DY_PARITY_LAYERS)
    arrays = dygraph_arrays(small, DY_PARITY_BATCH, TRAIN_SEQ)
    runs = []
    for dev in (device, torch.device("cpu")):
        with dg.guard(dev):
            dg.seed(DY_SEED)
            with pt.unique_name.guard():
                model = dygraph_bert(pt, small)
            if runs:
                model.set_state_dict(runs[0]["w0"])
            w0 = _dy_params(model)
            opt = pt.optimizer.Adam(TRAIN_LR,
                                    parameter_list=model.parameters())
            losses = [float(dygraph_step(pt, model, opt, arrays).numpy())
                      for _ in range(DY_PARITY_STEPS)]
            runs.append(dict(w0=w0, losses=losses, w=_dy_params(model)))
    card, cpu = runs
    dloss = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
    dparam = max(float(np.max(np.abs(card["w"][k] - cpu["w"][k])))
                 for k in cpu["w"])
    upd = float(np.sqrt(sum(np.sum((card["w"][k].astype(np.float64)
                                    - cpu["w"][k]) ** 2) for k in cpu["w"])
                        / sum(np.sum((cpu["w"][k].astype(np.float64)
                                      - cpu["w0"][k]) ** 2)
                              for k in cpu["w"])))
    out = dict(card_losses=card["losses"], cpu_losses=cpu["losses"],
               max_dloss=dloss, max_dparam=dparam, update_rel=upd)
    log(f"  20a parity at {DY_PARITY_LAYERS} layers, dropout 0, "
        f"{DY_PARITY_BATCH} x {TRAIN_SEQ}: card losses "
        + " ".join(f"{x:.6f}" for x in card["losses"]) + ", CPU "
        + " ".join(f"{x:.6f}" for x in cpu["losses"])
        + f"; max |dloss| {dloss:.3e} (gate {PARITY_LOSS_TOL}), max "
        f"|dparam| {dparam:.3e} (gate {DY_PARAM_ATOL}), distance over the "
        f"CPU run's update {upd:.3e}")
    if dloss > PARITY_LOSS_TOL or dparam > DY_PARAM_ATOL:
        raise AssertionError(f"20a parity: {out}")
    return out


def dygraph_resume_phase(device, cfg, model, opt, feeds, root):
    """20b: save_dygraph of the model and Adam's state, load_dygraph into
    a fresh model and optimizer: the next step (the same seed) bit-equal
    to the uninterrupted step — its loss and every parameter."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph as dg

    path = os.path.join(root, "bert")
    with dg.guard(device):
        t0 = time.perf_counter()
        dg.save_dygraph(model.state_dict(), path)
        dg.save_dygraph(opt.state_dict(), path)
        save_s = time.perf_counter() - t0
        dg.seed(DY_SEED + 1)
        loss_a = float(dygraph_step(pt, model, opt, feeds).numpy())
        after_a = _dy_params(model)
        with pt.unique_name.guard():
            fresh = dygraph_bert(pt, cfg)
        fopt = pt.optimizer.Adam(TRAIN_LR, parameter_list=fresh.parameters())
        t0 = time.perf_counter()
        params, state = dg.load_dygraph(path)
        fresh.set_state_dict(params)
        fopt.set_state_dict(state)
        load_s = time.perf_counter() - t0
        dg.seed(DY_SEED + 1)
        loss_b = float(dygraph_step(pt, fresh, fopt, feeds).numpy())
        after_b = _dy_params(fresh)
        state_a, state_b = opt.state_dict(), fopt.state_dict()
    differ = [k for k in after_a if not np.array_equal(after_a[k],
                                                       after_b[k])]
    state_differ = {k: float(np.max(np.abs(v - state_b[k])))
                    for k, v in state_a.items()
                    if not np.array_equal(v, state_b[k])}
    nbytes = sum(os.path.getsize(path + s) for s in (".pdparams", ".pdopt"))
    out = dict(save_s=save_s, load_s=load_s, bytes=nbytes, loss=loss_a,
               resumed_loss=loss_b, params_differ=len(differ),
               state_differ=state_differ)
    log(f"  20b save_dygraph (.pdparams + .pdopt, {nbytes} bytes) "
        f"{save_s:.2f} s, load_dygraph into a fresh model and Adam "
        f"{load_s:.2f} s; the next step: loss {loss_a!r} uninterrupted, "
        f"{loss_b!r} resumed; parameters differing {len(differ)}; Adam "
        f"state entries differing {len(state_differ)} "
        f"{sorted(state_differ.items(), key=lambda kv: -kv[1])[:4]}")
    if loss_a != loss_b or differ or state_differ:
        raise AssertionError(f"20b: the resumed step is not bit-equal: "
                             f"{out}, {differ[:5]}")
    return out


def dygraph_traced_phase(device, cfg, model, feeds, root):
    """20c: TracedLayer.trace of the trained model in eval mode, run
    through the port's Executor (the fusion pass on): the qkv-folded
    forward, the fused matmul and the FFN chain once a layer each and no
    other port kernel, no plain version, the logits within DY_TRACE_ATOL
    of the eager forward's; save_inference_model, then a Predictor on it
    giving the traced run's logits within DY_PREDICTOR_ATOL."""
    from paddle_tpu_torch import _cuda, dygraph as dg, inference

    on_card = device.type == "cuda"
    L = cfg.num_layers
    ins = [feeds[k] for k in ("src", "pos", "sent", "bias")]
    with dg.guard(device):
        model.eval()
        try:
            t0 = time.perf_counter()
            eager, traced = dg.TracedLayer.trace(model, ins)
            trace_s = time.perf_counter() - t0
            eager = eager.numpy()
            traced(ins)             # lowers (plans) the program
            sync(device)
            with _PlainCalls() as plain:
                _cuda.reset_launches()
                t0 = time.perf_counter()
                got, = traced(ins)
                run_s = time.perf_counter() - t0
                launches = _launch_gate(
                    dict(_cuda.LAUNCHES), {"flash_fwd_qkv": L,
                                           "gemm_epilogue": L,
                                           "ffn_chain": L},
                    "20c the traced program", on_card)
            kinds = _plan_kinds(traced.program)
            path = os.path.join(root, "traced")
            traced.save_inference_model(path)
        finally:
            model.train()
    config = inference.Config(path)
    if not on_card:
        config.disable_gpu()
    pred = inference.create_predictor(config)
    served, = pred.run([x.numpy() for x in ins])
    err = float(np.max(np.abs(got - eager)))
    perr = float(np.max(np.abs(served - got)))
    n_ops = len(traced.program.global_block().ops)
    out = dict(trace_s=trace_s, run_s=run_s, ops=n_ops, launches=launches,
               plan_groups=[dict(k) for k in kinds if k], max_abs_err=err,
               predictor_max_abs_err=perr, plain_calls=plain.calls)
    log(f"  20c TracedLayer: {n_ops} ops traced in {trace_s:.2f} s; plan "
        f"{out['plan_groups']}; a run {run_s * 1e3:.1f} ms, launches "
        f"{launches}, plain versions {plain.calls}; logits within "
        f"{err:.3e} of the eager forward (gate {DY_TRACE_ATOL}); the "
        f"Predictor on its save_inference_model within {perr:.3e}")
    want_kinds = collections.Counter(attn=L, gemm=L, ffn_chain=L)
    if kinds != [want_kinds] or err > DY_TRACE_ATOL \
            or perr > DY_PREDICTOR_ATOL or (on_card and plain.calls):
        raise AssertionError(f"20c: {out}")
    return out


def _dy_power_loop(x, w, n):
    """Phase 20d's function: n rounds of x <- tanh(x w).  Transpiled by
    to_static, its while's predicate is a tensor when n is one (a While
    op in the program) and a Python bool in the eager call."""
    i = 0
    while i < n:
        x = _PT.layers.tanh(_PT.layers.matmul(x, w))
        i = i + 1
    return x


def dygraph_to_static_phase(device, cfg):
    """20d: _dy_power_loop under @declarative at BERT-base width (x
    [B·T, H], w [H, H]) built into a program with a tensor trip count —
    a While op, run through the Executor on the card — against its eager
    call with DY_LOOP_TRIPS as a Python int: within DY_LOOP_ATOL."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph as dg

    global _PT
    _PT = pt
    f = dg.declarative(_dy_power_loop)
    H = cfg.hidden_size
    rng = np.random.RandomState(DY_SEED + 2)
    x = rng.randn(TRAIN_BATCH * TRAIN_SEQ, H).astype(np.float32)
    w = (rng.randn(H, H) / np.sqrt(H)).astype(np.float32)
    with pt.new_program_scope():
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            xv = pt.data("x", [TRAIN_BATCH * TRAIN_SEQ, H])
            wv = pt.data("w", [H, H])
            nv = pt.data("n", [1], "int64")
            y = f(xv, wv, pt.layers.reduce_sum(nv))
        types = [o.type for o in main.global_block().ops]
        exe = _executor(device)
        t0 = time.perf_counter()
        static, = exe.run(main, feed={"x": x, "w": w, "n": np.array(
            [DY_LOOP_TRIPS], np.int64)}, fetch_list=[y])
        static_s = time.perf_counter() - t0
    with dg.guard(device):
        eager = f(dg.to_variable(x), dg.to_variable(w), DY_LOOP_TRIPS).numpy()
    err = float(np.max(np.abs(static - eager)))
    out = dict(ops=types, static_s=static_s, max_abs_err=err)
    log(f"  20d @declarative while at [{TRAIN_BATCH * TRAIN_SEQ}, {H}] x "
        f"[{H}, {H}], {DY_LOOP_TRIPS} trips: program ops {types} "
        f"({static_s:.2f} s through the Executor); against the eager call "
        f"within {err:.3e} (gate {DY_LOOP_ATOL})")
    if "while" not in types or err > DY_LOOP_ATOL:
        raise AssertionError(f"20d: {out}")
    return out


def dygraph_dp_phase(device, cfg, model, opt, feeds, root):
    """20e: DataParallel at world 1 over a one-rank group (NCCL on the
    card): scale_loss, backward, apply_collective_grads, Adam — one step
    bit-equal to a plain eager step from the same state (saved before
    the plain step, loaded back after it) and the same seed."""
    import tempfile

    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph as dg

    on_card = device.type == "cuda"
    path = os.path.join(root, "dp")
    with dg.guard(device):
        dg.save_dygraph(model.state_dict(), path)
        dg.save_dygraph(opt.state_dict(), path)
        dg.seed(DY_SEED + 3)
        plain = float(dygraph_step(pt, model, opt, feeds).numpy())
        want = _dy_params(model)
        params, state = dg.load_dygraph(path)
        model.set_state_dict(params)
        opt.set_state_dict(state)
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group("nccl" if on_card else "gloo",
                                    store=dist.FileStore(f"{tmp}/store", 1),
                                    rank=0, world_size=1)
            try:
                dp = dg.DataParallel(model, dg.parallel.Env())
                dg.seed(DY_SEED + 3)
                loss = dygraph_loss(pt, dp, feeds)
                loss = dp.scale_loss(loss)
                loss.backward()
                dp.apply_collective_grads()
                opt.minimize(loss)
                dp.clear_gradients()
                got_loss = float(loss.numpy())
                nranks, backend = dp.nranks, dist.get_backend()
            finally:
                dist.destroy_process_group()
        got = _dy_params(model)
    differ = [k for k in want if not np.array_equal(want[k], got[k])]
    out = dict(nranks=nranks, backend=backend, loss=got_loss,
               plain_loss=plain, params_differ=len(differ))
    log(f"  20e DataParallel over a one-rank {backend} group (nranks "
        f"{nranks}): loss {got_loss!r} against the plain step's "
        f"{plain!r}; parameters differing {len(differ)}")
    if got_loss != plain or differ:
        raise AssertionError(f"20e: {out}")
    return out


def dygraph_phase(device, cfg=None):
    """Phase 20: dygraph — 20a eager training of dygraph_bert at
    BertConfig.base() (and the 2-layer card-against-CPU parity), 20b
    save/load_dygraph resume, 20c TracedLayer through the Executor and a
    Predictor, 20d a @declarative tensor while, 20e DataParallel at world
    1.  Files in a temporary directory (removed in a finally)."""
    import tempfile

    if cfg is None:
        from paddle_tpu_torch.models import BertConfig

        cfg = BertConfig.base()
    t0 = time.perf_counter()
    out = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_dygraph_")
    try:
        out["train"], model, opt, feeds = dygraph_train_phase(device, cfg)
        out["parity"] = dygraph_parity_phase(device, cfg)
        out["resume"] = dygraph_resume_phase(device, cfg, model, opt, feeds,
                                             root)
        out["traced"] = dygraph_traced_phase(device, cfg, model, feeds, root)
        out["to_static"] = dygraph_to_static_phase(device, cfg)
        out["dp"] = dygraph_dp_phase(device, cfg, model, opt, feeds, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = collections.Counter(out["train"]["launches"])
    launches.update(out["traced"]["launches"])
    out["launches"] = dict(launches)
    out["seconds"] = time.perf_counter() - t0
    return out


def main():
    import torch

    if len(sys.argv) > 1:
        return child_main(sys.argv[1:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch import _cuda, set_strict_fp32
        from paddle_tpu_torch.generation import GenerationConfig
        from paddle_tpu_torch.models import BertConfig, lm_random_params
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    set_strict_fp32()       # full float32 matmuls (no TF32) for every phase
    report = {}
    # the tuning store every engine resolves block_rows from: empty, in a
    # temporary directory (phase 14 searches into its own)
    import tempfile

    tune_root = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = os.path.join(tune_root,
                                                           "autotune.json")
    try:
        card = card_line()
        log(f"[1] card: {card}")
        built = _cuda.build(sorted({k["build"] for k in KERNELS}))
        report["ptxas"] = {}
        for name, secs in built.items():
            entries = ptxas_entries(_cuda.BUILD_LOG[name][1])
            report["ptxas"][name] = entries
            log(f"  built {name}.cu in {secs:.2f} s; ptxas (entry: "
                f"registers/spill bytes): " + " | ".join(
                    f"{e} {r}/{sp}" for e, r, sp in entries))
        report["build_s"] = built
        report["launch_cost_us"] = launch_cost_us(device)
        log(f"  {report['launch_cost_us']:.2f} us per small eager op "
            f"(before any profiler session)")

        model_cfg = dataclasses.replace(BertConfig.base(),
                                        initializer_range=0.6)
        log("[2] kernels against their plain versions")
        report["kernels"] = {
            "ragged_paged_attention": kernel_phase(device, model_cfg),
            "paged_decode_attention": decode_kernel_phase(device),
            **flash_kernel_phase(device), **qkv_kernel_phase(device),
            **epilogue_kernel_phase(device), **flat_kernel_phase(device)}
        for name, t in decoder_attention_phase(device).items():
            report["kernels"][name]["timing"]["decoder_causal"] = t
        for name, cases in p17_kernel_timing(device).items():
            report["kernels"][name]["timing"].update(cases)
        report["kernels"].update(amp_kernel_phase(device))

        log("[3] engine at BertConfig.base() width")
        t0 = time.perf_counter()
        params_np = lm_random_params(model_cfg, np.random.RandomState(SEED))
        log(f"  random weights made in {time.perf_counter() - t0:.2f} s")
        gen_cfg = GenerationConfig(page_size=PAGE_SIZE, max_seqs=MAX_SEQS,
                                   max_seq_len=MAX_SEQ_LEN, seed=SEED)
        engine, params, report["engine"] = engine_phase(
            device, model_cfg, gen_cfg, N_PROMPTS, PROMPT_LEN, MAX_NEW,
            params_np)
        report["features"], engines = feature_phase(device, model_cfg,
                                                    gen_cfg, params)
        # each kernel's launches on its own path's main run
        report["kernels"]["ragged_paged_attention"]["launches"] = \
            report["engine"]["launches"]
        report["kernels"]["paged_decode_attention"]["launches"] = \
            report["features"]["legacy_paged"]["launches"].get(
                "paged_decode_attention", 0)
        report["reference"] = reference_phase(
            device, model_cfg, gen_cfg, params, REFERENCE_LAYERS, N_PROMPTS,
            PROMPT_LEN, MAX_NEW)
        legacy = engines["legacy_paged"]
        report["profile"] = {
            "chunked": profile_phase(engine, model_cfg, device),
            "legacy": profile_phase(legacy, model_cfg, device,
                                    steps_key="decode_steps",
                                    kernel="paged_decode")}

        log("[4] server")
        report["server"] = {
            "chunked": server_phase(engine, model_cfg),
            "legacy": server_phase(legacy, model_cfg)}
        del engine, engines, legacy, params

        log("[5] training: BERT-base pretraining through the Executor")
        report["training"] = training_phase(device, BertConfig.base())
        for name, n in report["training"]["launches"].items():
            report["kernels"][name]["launches"] = n
        # the packed flash forward's path is the unfused lowering's
        report["kernels"]["flash_fwd_packed"]["launches"] = \
            report["training"]["parity"]["launches"]["unfused_lowering"][
                "flash_fwd_packed"]

        log("[6] the 4-D fused_attention op through the Executor")
        report["op4d"] = op4d_phase(device)
        for name in FLAT_KERNELS:
            report["kernels"][name]["launches"] = \
                report["op4d"]["launches"][name]

        log("[7] the sequence-parallel train step (ring attention)")
        report["seq_parallel"] = seq_parallel_phase(device)

        log("[8] the traced path: profiler device trace on, flight "
            "recorder armed")
        report["traced"] = {
            mode: traced_serving_phase(device, model_cfg, gen_cfg,
                                       params_np, mode)
            for mode in ("chunked", "legacy")}
        report["traced"]["training"] = traced_training_phase(
            device, BertConfig.base())
        report["traced"]["engine_untraced_decode_tokens_per_s"] = \
            report["engine"]["snapshot"]["decode_tokens_per_sec"]

        log("[9] disaggregated serving: prefill -> K/V handoff -> decode, "
            "in process and over worker processes")
        report["cluster"] = cluster_phase(device, model_cfg, gen_cfg,
                                          params_np)

        log("[10] BERT pretraining with the published recipe: schedule, "
            "clip, AdamW, checkpoints, resume, NaN rollback, eval clone")
        report["recipe"] = recipe_phase(device, BertConfig.base(),
                                        report["training"]["step_ms"])

        log("[11] control flow: the StaticRNN greedy decoder, the "
            "Predictor and its server, build_lm_logits, loop backward")
        report["control_flow"] = control_flow_phase(device, gen_cfg)
        for name, n in report["control_flow"]["kernel_launches"].items():
            report["kernels"][name]["launches"] += n

        log("[12] training from files: the repaired ops on the card, the "
            "slot parser, BERT-base through train_from_dataset, parity "
            "with Executor.run, the flags")
        report["dataset"] = dataset_phase(device, BertConfig.base(),
                                          report["training"]["step_ms"])
        for name, n in report["dataset"]["launches"].items():
            report["kernels"][name]["launches"] += n

        log("[13] the rest of training: the masked-position head, "
            "Recompute, sparse gradients at a 1M-row table, the optimizer "
            "wrappers, the loss and metric ops")
        report["sparse_recompute"] = sparse_recompute_phase(
            device, BertConfig.base(), report["training"]["step_ms"])
        sr = report["sparse_recompute"]
        for name, n in list(sr["masked"]["launches"].items()) \
                + list(sr["recompute"]["launches"].items()):
            report["kernels"][name]["launches"] += n

        log("[14] the serving artifact (torch.export of a frozen "
            "Predictor, loaded in a fresh process), the tuning plane "
            "(block_rows and fusion-plan searches), the fleet (autoscaler, "
            "supervisor, rolling swap, tuning verbs) over worker processes")
        report["fleet_tuning_artifact"] = fleet_tuning_artifact_phase(
            device, gen_cfg, params_np)
        for name, n in report["fleet_tuning_artifact"]["launches"].items():
            report["kernels"][name]["launches"] += n

        log("[15] parallelism in the Program front end: data parallel at "
            "world 1 over NCCL, two gloo ranks on the card (data 2, ZeRO-1, "
            "model 2, expert 2), the pipeline at full width, MoE at "
            "BERT-base FFN width")
        report["parallel"] = parallel_phase(device, BertConfig.base(),
                                            report["training"]["step_ms"])
        par = report["parallel"]
        for name, n in list(par["dp"]["launches"].items()) \
                + list(par["pipeline"]["launches"].items()):
            report["kernels"][name]["launches"] += n

        log("[16] the parameter-server tier: BERT-base through a pserver "
            "(one and two trainer processes), the PS fleet's sync, async "
            "and GEO modes, the device-cached embedding at 1M x 128, the "
            "collective fleet, LocalSGD through the launcher, the "
            "all-reduce harness")
        torch.cuda.empty_cache()
        report["ps"] = ps_phase(device, dataclasses.replace(
            BertConfig.base(), num_layers=PS_DEPTH),
            report["training"]["step_ms"])
        for name, n in report["ps"]["launches"].items():
            report["kernels"][name]["launches"] += n

        log("[17] the JAX bench's other two training models: ResNet-50 "
            "(conv2d, pool2d, batch_norm), the Transformer-big NMT (label "
            "smoothing; #9, #3, #5, #6, #10) and its beam decoder")
        torch.cuda.empty_cache()
        report["bench_models"] = bench_models_phase(device)
        for name, n in report["bench_models"]["launches"].items():
            report["kernels"][name]["launches"] += n

        log("[18] bf16 and fp16 AMP training: BERT-large at 16 x 512 and "
            "BERT-base at 64 x 128 (bf16), fp16 loss scaling against the "
            "CPU, ResNet-50 and NMT-big (bf16), the gates against the CPU "
            "and f32")
        _free_card(device)
        report["amp"] = amp_phase(device)
        for name, n in report["amp"]["launches"].items():
            report["kernels"][name]["launches"] = \
                report["kernels"][name].get("launches", 0) + n

        log("[19] the Megatron split: BERT-base (fused and unfused) and "
            "NMT-big at {model: 2} against one rank, ResNet-50 at {data: 2} "
            "under sync-BN, two gloo ranks on the card")
        _free_card(device)
        report["tensor_parallel"] = tensor_parallel_phase(device)
        for name, n in report["tensor_parallel"]["launches"].items():
            report["kernels"][name]["launches"] = \
                report["kernels"][name].get("launches", 0) + n

        log("[20] dygraph: BERT-base trained eagerly (#3, #5, #6), "
            "save/load_dygraph, TracedLayer through the Executor (#9, #10, "
            "#11) and a Predictor, a @declarative while, DataParallel")
        _free_card(device)
        report["dygraph"] = dygraph_phase(device, BertConfig.base())
        for name, n in report["dygraph"]["launches"].items():
            report["kernels"][name]["launches"] = \
                report["kernels"][name].get("launches", 0) + n
        idle = [k["name"] for k in KERNELS
                if not report["kernels"][k["name"]].get("launches")]
        if idle:
            raise AssertionError(f"kernels no path launched: {idle}")
    except Exception:  # noqa: BLE001 — any phase failing fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tune_root, ignore_errors=True)

    line = {"kernels": []}
    for k in KERNELS:
        r = report["kernels"][k["name"]]
        t = r["timing"]
        line["kernels"].append(dict(
            name=k["name"], route=k["route"], source=k["source"],
            replaces=k["replaces"], launches=r["launches"],
            max_abs_err=r["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    OUT_DIR.mkdir(exist_ok=True)
    report["card"] = card
    report["phase_s"] = phase_seconds()
    log(f"seconds by phase: {report['phase_s']}")
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    tr = report["traced"]
    print(json.dumps({"observability": {
        mode: {"decode_tokens_per_s": tr[mode]["decode_tokens_per_s"],
               "spans_ms": tr[mode]["spans_ms"]}
        for mode in ("chunked", "legacy")} | {"training": {
            k: tr["training"][k] for k in (
                "untraced_step_ms", "traced_step_ms", "ratio", "run_span_ms",
                "op_scopes_ms", "device_busy_ms")}}}))
    print(json.dumps({"cluster": dict(card=card,
                                      **report["cluster"]["line"])}))
    rc = report["recipe"]
    print(json.dumps({"recipe": dict(card=card, **{k: rc[k] for k in (
        "step_ms", "phase5_step_ms", "save_ms", "write_ms", "version_bytes",
        "restore_ms", "disk_peak_bytes", "launches", "eval_launches",
        "lr_max_ulps", "losses", "eval_loss", "eval_unfused_loss")})}))
    cf = report["control_flow"]
    print(json.dumps({"control_flow": dict(
        card=card, decoder=dict(
            tokens_per_s=cf["tokens_per_s"], run_s=cf["run_s"],
            launches_per_run=cf["launches_per_run"],
            engine_tokens_per_s=cf["engine_tokens_per_s"],
            speedup_vs_while_op=cf["speedup_vs_while_op"],
            matched_prefix_vs_engine=cf["matched_prefix_vs_engine"],
            depth2_worst_gap=cf["depth2"]["worst_gap"],
            profile={k: cf["profile"][k] for k in (
                "steps", "wall_ms", "op_scopes_ms", "device_busy_ms",
                "device_busy_share")}),
        predictor={k: cf["predictor"][k] for k in (
            "save_s", "load_s", "run_s", "batches", "round_trip_ms",
            "compile_count", "compiles_after_warmup")},
        logits={k: cf["logits"][k] for k in (
            "plan_groups", "launches", "rel_err_by_depth")},
        loops={k: v["grad_rel_err"] for k, v in cf["loops"].items()})}))
    ds = report["dataset"]
    print(json.dumps({"dataset": dict(
        card=card, phase5_step_ms=ds["phase5_step_ms"],
        run_step_ms=ds["run_step_ms"], launch_cost_us=ds["launch_cost_us"],
        epochs={kind: {k: e[k] for k in (
            "step_ms", "tokens_per_s", "feed_wait_ms", "feed_waits",
            "chunk_means", "launches")} for kind, e in ds["epochs"].items()},
        busy_share=ds["profile"]["device_busy_share"],
        parser={k: ds["parser"][k] for k in ("native_ms", "plain_ms")},
        parity={k: ds["parity"][k] for k in (
            "dlast", "dmean", "param_max_diff", "bit_equal",
            "thread_bit_equal")},
        queue3_max_rel_err=max(ds["queue3"].values()))}))
    sr = report["sparse_recompute"]
    print(json.dumps({"sparse_recompute": dict(
        card=card,
        masked={k: sr["masked"][k] for k in (
            "step_ms", "tokens_per_s", "phase5_step_ms", "turns_ms",
            "head_device_ms_saved", "launches")} | dict(
            device_ms_per_step={k: v.get("device_ms_per_step") for k, v in
                                sr["masked"]["profile"].items()},
            parity={k: sr["masked"]["parity"][k][
                "max_dloss"] for k in ("blocks", "unfused_lowering")},
            dense_head_rel_err=sr["masked"]["dense_head"]["rel_err"]),
        recompute={k: sr["recompute"][k] for k in (
            "step_ms", "unfused_step_ms", "peak_bytes", "unfused_peak_bytes",
            "launches", "max_dloss", "max_grad_rel_err")},
        sparse={k: {m: v for m, v in sr["sparse"][k].items()
                    if m != "losses"} for k in ("sgd", "adam", "lazy_adam")}
        | {"oob": sr["sparse"]["oob"]},
        wrappers=dict(
            gradient_merge_rel_err=sr["wrappers"]["gradient_merge"][
                "rel_err"],
            ema_rel_err=sr["wrappers"]["ema"]["rel_err"],
            programs=sr["wrappers"]["programs"]),
        loss_ops_max_rel_err=max(sr["loss_ops"].values()))}))
    ft = report["fleet_tuning_artifact"]
    tu, fl = ft["tuning"], ft["fleet"]
    print(json.dumps({"fleet_tuning_artifact": dict(
        card=card,
        artifact=dict(
            bytes=ft["bytes"], export_s=ft["export_s"],
            predictor_run_s=ft["predictor_run_s"],
            **{tag: {k: ft["child"][tag][k] for k in (
                "load_s", "run_s", "max_abs_err", "launches",
                "plain_calls")} for tag in ("baked", "unbaked")}),
        tuning=dict(
            geometry=tu["geometry"], device_kind=tu["device_kind"],
            ragged={f"block_rows_{c['block_rows']}": c.get(
                "ms", c.get("error")) for c in tu["ragged"]["candidates"]},
            ragged_winner=tu["ragged"]["config"], engine=tu["engine"],
            plan=tu["plan"], override=tu["override"]),
        fleet={k: fl[k] for k in (
            "first_ready_s", "spawn_to_attached_s", "drain_s",
            "swap_s_per_worker", "respawn_s", "router", "degradations",
            "parked_failure")})}))
    par = report["parallel"]
    print(json.dumps({"parallel": dict(
        card=card, phase5_step_ms=par["phase5_step_ms"],
        dp={k: par["dp"][k] for k in (
            "step_ms", "plain_step_ms", "degree", "launches")} | dict(
            nccl_ms_per_step=par["dp"]["profile"].get("nccl_ms_per_step"),
            nccl_kernels_per_step=par["dp"]["profile"].get(
                "nccl_kernels_per_step"),
            device_ms_per_step=par["dp"]["profile"].get(
                "device_ms_per_step")),
        ranks={k: {m: v[m] for m in ("max_dloss", "step_ms")}
               for k, v in par["ranks"]["cases"].items()} | dict(
            one_rank_step_ms=par["ranks"]["one_rank_step_ms"],
            zero1_ratio=par["ranks"]["cases"]["zero1"]["report"][
                "ratio_vs_ideal"]),
        pipeline={k: par["pipeline"][k] for k in (
            "step_ms", "unfused_step_ms", "peak_bytes", "unfused_peak_bytes",
            "max_dloss", "launches_per_step")},
        moe={k: par["moe"][k] for k in (
            "step_ms", "dispatch_bytes", "peak_bytes", "max_dloss")})}))
    ps = report["ps"]
    print(json.dumps({"ps": dict(
        card=card, phase5_step_ms=ps["phase5_step_ms"],
        bert={k: ps["bert"][k] for k in (
            "loss_rel_err", "param_rel_err", "update_rel_err",
            "two_bit_equal", "two_param_rel_err", "two_update_rel_err",
            "step_split_ms", "two_step_split_ms", "bytes_each_way",
            "rpcs_each_way", "blocks", "server_rss_bytes",
            "server_rss_listening_bytes", "init_s", "launches")},
        modes={m: {k: ps["modes"][m][k] for k in ("learn", "w_rel_diff")}
               for m in ("sync", "async", "geo")},
        cache={k: ps["cache"][k] for k in (
            "hit_rate", "pulls_per_step", "step_ms", "max_rel_err")},
        collective={k: ps["collective"][k] for k in (
            "bit_equal", "params_equal", "backend", "launches")},
        local_sgd={k: ps["local_sgd"][k] for k in ("syncs", "max_err")},
        allreduce=[{k: b[k] for k in ("payload_mb", "min_s", "gbps")}
                   for b in ps["collective"]["allreduce"]])}))
    bm = report["bench_models"]
    rn, nm, bb = bm["resnet"], bm["nmt"], bm["beam"]
    print(json.dumps({"bench_models": dict(
        card=card, seconds=bm["seconds"],
        resnet={k: rn[k] for k in (
            "batch", "batches", "step_ms", "images_per_s", "peak_bytes",
            "conv_matmul_tflops", "launches")} | dict(
            parity={k: rn["parity"][k] for k in ("card_loss", "cpu_loss")},
            busy_share=rn["profile"].get("device_busy_share"),
            conv_share=rn["profile"].get("named_share"),
            device_ms=rn["profile"].get("device_ms_per_step")),
        nmt={k: nm[k] for k in (
            "step_ms", "target_tokens_per_s", "peak_bytes", "matmul_tflops",
            "launches")} | dict(
            parity_max_dloss=nm["parity"]["max_dloss"],
            busy_share=nm["profile"].get("device_busy_share"),
            device_ms=nm["profile"].get("device_ms_per_step"),
            base_launches=nm["base"]["launches"]),
        beam={k: bb[k] for k in (
            "run_ms", "decode_step_ms", "sentences_per_s", "launches",
            "gate")})}))
    am = report["amp"]
    print(json.dumps({"amp": dict(
        card=card, seconds=am["seconds"],
        **{k: {m: am[k][m] for m in (
            "batch", "seq", "masked", "step_ms", "tokens_per_s",
            "peak_bytes", "busy_share", "kernels_share", "launches",
            "f32_step_ms", "f32_peak_bytes")} for k in ("large", "base")},
        f16={k: am["f16"][k] for k in ("states", "cpu_states",
                                       "launches")},
        resnet={k: am["models"]["resnet"][k] for k in (
            "batch", "steps", "step_ms", "images_per_s", "peak_bytes",
            "launches")},
        nmt={k: am["models"]["nmt"][k] for k in (
            "steps", "step_ms", "target_tokens_per_s", "peak_bytes",
            "launches")},
        gates={k: {m: v[m] for m in ("first_rel", "curve_rel")}
               for k, v in am["gates"].items()})}))
    tp = report["tensor_parallel"]
    print(json.dumps({"tensor_parallel": dict(
        card=card, spawn_s=tp["spawn_s"], **{name: dict(
            max_dloss=j["max_dloss"], max_dparam=j["max_dparam"],
            max_dparam_rel=j["max_dparam_rel"], worst_param=j["worst_param"],
            worst_param_parted=j["worst_param_parted"],
            max_dstat=j["max_dstat"], **({"world1_dloss": j["world1_dloss"]}
                                         if "world1_dloss" in j else {}),
            one_rank={k: j["one_rank"][k] for k in (
                "losses", "step_ms", "peak_bytes")},
            ranks=[{k: g[k] for k in (
                "losses", "step_ms", "peak_bytes", "launches", "stats")}
                for g in j["ranks"]]) for name, j in tp["jobs"].items()})}))
    dy = report["dygraph"]
    print(json.dumps({"dygraph": dict(
        card=card, seconds=dy["seconds"],
        train={k: dy["train"][k] for k in (
            "step_ms", "tokens_per_s", "peak_bytes", "launches",
            "forward_ops", "host_us_per_op", "backward_update_host_ms")}
        | dict(busy_share=dy["train"]["profile"].get("device_busy_share"),
               device_ms=dy["train"]["profile"].get("device_ms_per_step"),
               phase5_step_ms=report["training"]["step_ms"]),
        parity={k: dy["parity"][k] for k in (
            "max_dloss", "max_dparam", "update_rel")},
        resume={k: dy["resume"][k] for k in (
            "save_s", "load_s", "bytes", "params_differ")},
        traced={k: dy["traced"][k] for k in (
            "run_s", "launches", "max_abs_err", "predictor_max_abs_err")},
        to_static_max_abs_err=dy["to_static"]["max_abs_err"],
        dp={k: dy["dp"][k] for k in ("backend", "nranks", "params_differ")})
    }))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
