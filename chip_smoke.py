#!/usr/bin/env python3
"""Chip smoke for paddle_tpu_torch: decode serving, Transformer training,
ResNet-50 training, NMT inference, the training lifecycle (Trainer,
checkpoints and resume, inference-model export), disaggregated decode
serving (the KV page handoff, PhaseRouter), Wide&Deep CTR training
with row-sparse embedding gradients, the public layers (an encoder
layer built from them, every new and repaired op), the staging ring,
the Switch-MoE LM, remat and gradient accumulation, and the recurrent
and sequence path (bench_rnn_lstm, the LSTM sequence kernels, the LSTM
and GRU cell kernels, the sequence models), and control flow with the
RNN-search seq2seq and SSD, and the conv path's CNNs (MobileNet v1,
SE-ResNeXt-50, VGG, AlexNet, GoogLeNet, LeNet-5) on one CUDA card.

    python3 chip_smoke.py                  # on a machine with one H100
    python3 chip_smoke.py --cpu-rehearsal  # phases 4-21 on the host, tiny

Every path runs through the executor's CUDA graphs (one a key, captured on
its second call; core/executor.py), and phase 11 holds each against the
same path run eagerly (use_program_cache=False).

Phases (any fault exits non-zero; no phase is skipped over):

1. Device: name, count, nvidia-smi's name and power limit, TF32 flags
   (both set off: fp32 matmuls and convolutions run in full fp32).
2. Build: every CUDA kernel from paddle_tpu_torch/csrc, one nvcc a
   source, all started together, then a link; build time and ptxas's
   registers / shared memory / spills per kernel.
3. Kernel vs plain version on the card at the main paths' shapes, fp32
   and bf16, with the stated tolerance; device times of the kernel, the
   plain version and a library yardstick (CUDA-graph replay, CUDA
   events) beside each kernel's bound, and the kernel's eager time.
   Layer norm (K1) and its two backward kernels (against autograd of the
   plain forward, twice for equal bits, beside F.layer_norm's backward),
   at [4096, 512] (the Transformer's) among others; paged attention (K4)
   against both its plain versions
   (one-pass softmax; per-chunk partials merged in split order) at the
   decode shapes (16 rows, lengths 1..2048 with empty slots; every row at
   2,048 tokens: every split live; the engine's range 64..576) and the
   prefill's broadcast table at 128 and 512 rows, fp32 and bf16, and a
   row-independence check: one row in a 16-row batch, alone and inside a
   128-row broadcast call gives the same bits, and its any-width kernel
   at bf16 d_key 36, fp32 d_key 30 and D = Dv = 192; flash attention
   forward
   (K2, against the whole-row and the 64-key tiled plain versions, each
   case run twice, the launch-variant counters read) and backward (K3:
   its tensor-core pair and, on copies one element into their storage,
   its SIMT pair, each run twice for equal bits, the variant counters
   read; SDPA's backward timed by graph replay beside it) at the
   training shapes: B=64 H=8 T=64 D=64 bf16
   non-causal and causal, B=8 H=8 T=512 causal with kv_len 256-512 and
   one row at 1, B=4 H=4 T=200 D=128 bf16 and B=64 T=64 fp32 (the SIMT
   kernels), and the inputs of the JAX op's default path: causal Tq=256
   Tk=512 and Tq=512 Tk=256 (bottom-right), kv_len-0 rows, D=256 bf16 and
   D=192 fp32; batch norm (K5, one launch a call, run twice for equal bits)
   at ResNet-50's stem, stage-1, stage-2 and stage-4 shapes in bf16 NHWC,
   two NCHW shapes, an fp32 and an odd shape, each staged on chip or read
   twice as its plan says (both happen in both orders), and its backward
   kernel at each shape (one launch, twice for equal bits, against
   batch_norm_reference_bwd, beside F.batch_norm's backward) and through
   autograd against autograd of the plain version. K4's quantized variant
   (int8 and e4m3 pages with fp32 row scales) at the engine shape, with
   every row at 2,048 tokens, at the verify shape (64 rows: 16 sequences
   x k+1 = 4) and on the any-width kernel (d_key 8), against both plain
   versions within 1e-5 of the largest value; fp32 K4 at the verify
   shape; and the LM's row tiles: torch.matmul's rows at M = 16, 64, 512
   compared (printed), paged_decode_ops._mm's bit-equal at every M.
   Head dims above 256: K2 and K3 at D = 320 (the wide SIMT kernels, fp32
   causal and bf16 with kv_len-0 rows) and K4's any-width kernel at
   D = Dv = 320 (fp32, bf16). The captured step's kernels, bit for bit
   with their plain versions: the stand-alone KV write at a decode step's
   rows (16, 13 kept) into fp32, bf16, int8 and e4m3 arenas and at the
   512-row prefill (fp32, int8); the KV write folded into K4's launch
   (the decode and verify steps on fp32 arenas) at the decode step's rows
   into fp32 and bf16 arenas and the verify step's 64 rows (fp32): arenas
   bit for bit with kv_write_reference, the rows that read only kept rows
   bit for bit with the unfused K4 after it, within K4's tolerances of
   both plain versions, timed beside K4 alone on the same inputs; the
   keep mask at
   the Transformer's dropout shapes, and the fused dropout at [64, 64,
   2048] and [64, 64, 512] in bf16 and fp32, each mode (mul, mul_div,
   where_div) forward and backward, beside F.dropout (forward, its own
   bits) and dy * mask (backward). K2 at the NMT decode's shapes (phase
   12's unrolled decoder: B = 64 x beam 4 = 256, H = 8, D = 64, on
   head-split views): causal Tq = Tk = t and cross-attention Tq = t
   against Tk = 64 with kv_len 16-64, t in {1, 7, 16, 31}, fp32 and bf16,
   against both plain versions, beside SDPA and the bound. The
   row-sparse update (sparse_rows, grouped) at Wide&Deep's width for SGD,
   Adagrad, lazy Momentum and lazy Adam, bit for bit with its plain
   version: one table of 1,000,000 rows, 4,096 ids from a Zipf(1.1) law,
   at dim 16 and dim 1 (and on the host); the step's 52 tables (26 of
   each width) in one launch; the large-n variant (two tables of 65,536
   ids: sorted on the device, then the presorted launch); index_add_ on
   each table (atomic scatter-adds) beside SGD's. The max pool at the
   main paths' pools (pool_shapes: ResNet-50's NHWC stem, a ceil / spp
   shape, GoogLeNet's stem and inception pools, VGG-16's 224² and
   vgg_bn_drop's fp32): max_pool_fwd's y bit for bit and picks equal to
   its plain version's (and y to F.max_pool2d's), max_pool_bwd from the picks twice
   bit for bit and equal to (or within an ulp of the fp32 sums of) its
   plain version, each half beside its bound, the pair's bound,
   F.max_pool2d and torch's max_pool2d_with_indices_backward.
4. Engine: DecodeEngine at the documented serving configuration
   (docs/serving.md: vocab 32000, 12 layers, 8 heads, d_model 512,
   d_inner 2048; max_batch 16, block 32, 4096 pages, 64 pages a
   sequence; fp32 arena; random_weights(seed 0)). warmup(), start(), 32
   requests from 16 submitter threads (prompts 64-512 tokens, 64 new
   tokens, 28 greedy and 4 at temperature 0.7). warmup() captures one
   graph a shape (12 prompt buckets and the decode step; the verify step
   with speculation); each then runs as a replay, and serving captures
   nothing. Checks every stream
   completes, 4 greedy streams re-run alone equal their concurrent
   runs, pages return after drain, and the kernels' launch counters
   grew by 2*L (layer norm) and L (paged attention) per prefill and
   decode step of the run: on fp32 arenas every decode and verify layer's
   KV write folded into its paged-attention launch, every prefill layer's
   a stand-alone KV-write launch (and every layer's on the arenas that
   convert the rows: int8, fp8).
5. Card vs CPU: the same port on CPUPlace() (plain versions), 2 prompts x
   16 greedy tokens, must give the card's token streams.
5a. Decode extras at the same width: 32 requests from 16 clients, each
   sharing a 256-token system prompt (8 full pages) with probability 0.95
   followed by 16-256 random tokens, else a cold 64-512-token prompt; 64
   new tokens, 28 greedy and 4 at temperature 0.7. Served by the plain
   engine and by one with prefix_cache=True and spec_k=3: every stream
   equal between the two, cache hits and accepted drafts > 0, the pool
   back at num_blocks after shutdown, layer norm and paged attention at
   2*L and L launches per prefill, decode and verify step; tokens/s, TTFT
   and inter-token gaps of both, hit rate, prefill tokens skipped, mean
   accepted length.
5b. Quantized arenas: the same traffic at int8, then fp8 (cache and
   spec_k=3 on): the phase-4 checks, every paged-attention launch on the
   quantized variant, and the same engine on CPUPlace() equal to the card
   (2 prompts x 16 greedy tokens); kv bytes a token and tokens/s.
6. Training: bench.py's bench_transformer through the port's user API
   (transformer_base at vocab 32000, 6+6 layers, d_model 512, dropout
   and label smoothing 0.1; Adam(1e-4).minimize; amp 'bf16';
   Executor(CUDAPlace(0)).run) on make_fake_batch(64, 64, 64, ...): 3
   warm-up and 20 timed steps. ms a step, tokens/s, MFU against 989
   TFLOP/s, the first and last loss (finite, falling), peak memory, and
   the launch counts of the timed steps (K2, both K3 kernels 18 a step,
   K1 30 a step and its backward 60; every flash launch through its
   tensor-core variant; the fused dropout and its backward 62 a step,
   the keep mask none).
6b. The same training with transformer_base(..., scan_layers=True) (one
   transformer_layer_stack op a side): ms a step, tokens/s, MFU beside
   phase 6's, the same launch counts. Then phase 8's program with
   scan_layers from phase 8's unrolled weights stacked by
   stack_trained_weights: 3 Adam steps within 1e-5 relative of the
   unrolled program's; at dropout 0.1, 3 captured steps equal 3 eager
   steps bit for bit.
7. Masked training: 3 + 10 steps at bench_transformer_masked's shape
   (batch 8, seq 512, src_length uniform in [256, 512], lbl_weight
   masking the same positions): padded and real tokens/s, the phase-6
   launch counts.
7b. The dropout op's Mask read: the Transformer's FFN (x [4096, 512] ->
   fc(2048, relu) -> dropout(0.1) -> fc(512) -> mean, Adam, bf16 AMP)
   with Mask fetched each step: one keep-mask, one dropout and one
   dropout_bwd launch a step, the Mask equal to its step's keep bits.
8. Training card vs CPU: the same Program at batch 2 x seq 64, fp32,
   dropout 0, no amp; 3 Adam steps on CUDAPlace(0) and on CPUPlace()
   from the same weights: each loss within 1e-4 relative, every
   parameter within 2*lr*steps.
9. ResNet-50 training: bench.py's bench_resnet50 through the port's user
   API (resnet50_with_loss, NHWC; Momentum(0.1, 0.9).minimize; amp
   'bf16'; Executor(CUDAPlace(0)).run) at batch 64 x 3 x 224 x 224,
   1000 classes, on bench.py's RandomState(0) feed: 3 warm-up and 20
   timed steps. ms a step, images/s, MFU of the conv and fc FLOPs, the
   first and last loss (finite, falling), peak memory, K5 launches and
   its backward's (53 a step each), one max_pool_fwd and one
   max_pool_bwd launch a step, every running mean and variance moved and
   finite.
10. ResNet card vs CPU: ResNet-50 at 32x32, batch 8, 10 classes, NCHW,
   fp32, Momentum(0.01), 3 steps from the same weights on each place:
   the first loss within 1e-3 relative, the running statistics and
   gradients of the first step within stated bounds, later losses
   printed beside the host's own spread.
11. Captured against eager, in this call: (a) bench_transformer's
   width, eager (use_program_cache=False) then captured, 3 + 20 steps
   each on one scope: ms a step, tokens/s, MFU; then phase 8's program
   with dropout 0.1: 3 captured steps equal 3 eager steps, and
   run_steps(3) 3 run calls, bit for bit in the losses and every scope
   variable, every scope tensor at its address. (b) bench_resnet50's
   width the same way (images/s); then phase 10's program, the first step
   from the same state captured against eager (and run_steps(1)), with
   cuDNN's default backward algorithms (printed beside two eager runs'
   own gap) and with torch.backends.cudnn.deterministic (within 1e-6).
   (c) phase 4's and phase 5b's int8 traffic through an eager engine:
   all 32 streams (greedy and sampled) equal the captured runs'; tokens/s,
   TTFT and inter-token gaps of both.

12. NMT inference: Transformer-base at bench width (6 + 6 layers, d_model
   512, vocab 32000 both sides) from the port's seeded startup, the
   decoder stacked by stack_trained_weights on the card; 64 sentences x
   src 64, src_length uniform in [16, 64], bos 0, eos 1. Greedy and beam
   4 through transformer_greedy_infer / transformer_beam_infer at 114
   positions (input + 50; incremental) and at 32 (incremental and
   unrolled, the unrolled graphs' cut), fp32 (TF32 off) then bf16 AMP,
   every call captured: ms a batch, tokens/s, sentences/s, peak memory,
   the exact K2 and K1 launches a call. Checks: incremental equals
   unrolled at 32 positions (fp32; a stream may differ only where it
   first diverges at a near tie of the unrolled run, at most 2), the
   114-position graphs captured equal eager bit for bit and a second
   batch of other sentences captures nothing, and the card equals the
   CPU place (incremental, fp32, 2 sentences, 16 positions).
13. The training lifecycle (checkpoints written under the checkout in a
   temporary chip_smoke_ckpt.* directory, removed at the end).
   (a) bench.py's bench_pipeline_ablation through the port's
   Trainer.train: transformer_base at vocab 32000 (dropout 0.1),
   Adam(1e-4), amp bf16, 2 epochs of make_fake_batch(64, 64, 64, 32000,
   32000, seed=i) for i < 20, epoch 1 timed, at pipeline_depth 1, 2 and 4
   (host_prefetch 2 above 1): tokens/s a depth, the timed steps' launches
   (K2 and each K3 kernel 18 a step, K1 30 and its backward 60), and the
   final persistables and every loss of depths 2 and 4 equal depth 1's
   bit for bit. (b) At the same width, noam_decay(512, 4000), Adam(0.9,
   0.98, 1e-9), GradientClipByGlobalNorm(1.0), dropout 0.1,
   CheckpointConfig(save_every_steps=5): 10 steps; io.load_checkpoint of
   step 5 into that run's live executor, then one step, replays (no
   capture) and gives step 6's loss; a fresh Trainer on a fresh scope and
   executor resumes from step 5 and trains to 10: losses 6-10 and every
   persistable equal the uninterrupted run's bit for bit; the
   checkpoint's bytes, a sync and an async save's seconds. (c)
   save_inference_model of phase 12's incremental greedy program (T =
   114), load_inference_model in a fresh executor and scope: 64 sentences
   translate token for token as the in-memory program. (d) Card against
   host (TF32 off), 3 steps from the same weights: fit_a_line with SGD +
   L2Decay(1e-4) + exponential_decay, and a 2-layer Transformer at
   d_model 64 with noam + a global-norm clip + L1Decay(1e-4): each loss
   within 1e-5 relative.
14. Disaggregated serving at the decode configuration of phase 4 with
   prefix_cache=True, with observe on. 48 requests drawn by
   serving.loadgen.phase_mix (35 % prompts of 448-512 tokens with 4-8 new
   tokens, the rest 16-64 tokens with 48-64 new; 60 % starting with one
   256-token system prompt; 12 at temperature 0.7): one plain engine's
   streams, then legs of three engines each, one after the other, three
   times in turn: PhaseRouter(1 prefill, 2 decode) and
   PhaseRouter(colocated=True), driven by loadgen.closed_loop from 16
   clients with every launch count at 0 just before. Checks: every stream
   of every leg equals the plain
   engine's; no capture and no executor cache miss after warmup on any
   engine; pages deduplicated across the hop; every pool drained; 2 L
   layer-norm and L paged-attention launches a prefill or step of the
   three engines, every decode replica stepping. Prints tokens/s, TTFT
   and inter-token p50 / p99 of every leg and their median and spread;
   handoffs, pages exported, installed and deduped, bytes a handoff and a
   page, export, install and hop ms p50 / p99, GB/s over the hop, and the
   export and install seconds split into the wait for the arena lock and
   the copies under it. Then the KV packet round trip at
   fp32, bf16, int8 and fp8 arenas (export, to_bytes, from_bytes,
   install into a fresh engine, read_pages: bit for bit, scales
   included) and read_pages / write_pages of the longest prompt's fp32
   pages timed beside their bound.

15. Wide&Deep CTR training (models/wide_deep.py) in the Criteo schema:
   26 sparse slots and 13 dense features, 1,000,000 rows a slot in the
   deep (dim 16) and the wide (dim 1) tables, hidden (64, 32), batch
   4,096, fp32, ids from a Zipf(1.1) law folded onto each table. One
   captured leg each under SGD(0.1), Adagrad(0.05), Adam(1e-3,
   lazy_mode=True) and Momentum(0.1, 0.9, lazy_mode=True), 3 warm-up
   and 20 timed steps with every launch count at 0 before: ms a step,
   examples/s, one eager step's peak memory above the resident state
   (checked under one deep table's bytes, 64 MB: no table-sized
   gradient) and the leg's, sparse_rows launches and tables a step
   (checked: 1 launch for the 52 tables).
   Checks: all 52 tables row-sparse, rows never fed unchanged bit for
   bit, a second run from the same state and 3 captured against 3 eager
   steps bit for bit. Then SGD again with every table's sparse_grad off
   (dense gradients, the path before row-sparse gradients): ms a step
   and peak memory. Then, at 4 slots x 1,000 rows and batch 256, 3 steps
   from the same weights: each optimizer card against host (losses rtol
   1e-5; persistables rtol 1e-5 and atol 1e-6, or 1e-3 x lr for Adagrad
   and Adam, whose normalised first step lr * g / (|g| + eps) amplifies a
   near-zero gradient entry's summation-order error by up to lr / eps),
   sparse against dense SGD on the
   card, and the recommender at its defaults (emb 32, fc 200, cos_sim)
   card against host.
16. The public layers. (a) A Transformer-base encoder layer written by
   hand from public layers only at bench_transformer's width (batch 64 x
   seq 64, d_model 512, 8 heads, d_inner 2048): Q, K, V by
   fc(num_flatten_dims=2), nets.scaled_dot_product_attention, an output
   fc, the residual and layer_norm (K1); fc to 2 x 2048, nets.glu, fc
   back, the residual and layer_norm; loss reduce_mean(square(y -
   label)) under SGD. Captured at fp32 (TF32 off) and under bf16 AMP, 3
   warm-up and 20 timed steps each: ms a step, tokens/s, K1's launches
   checked exactly (2 forward and 4 backward kernels a step); card
   against host over 3 steps from the same weights at batch 4 (losses
   rtol 1e-4 fp32, 2e-2 bf16); captured against eager bit for bit under
   bf16 at dropout 0 and 0.1 (the attention weights' dropout: one fused
   dropout forward and backward launch a step). (b) Every op type the
   slice added and every repaired op (sign, gelu, cast, pow, clip, brelu,
   relu6, leaky_relu) in one captured program at [4096, 512], fp32 and
   bf16 AMP, the edge values of tests/test_torch_harness.py at the feed's
   head; each output and each op's gradient (through reduce_sum) card
   against the CPU place at the harness's tolerances, the repaired
   faults exactly where they were; then the two *_batch_size_like draws
   eagerly (host-bound ops): shape, range, moments, same-seed
   repeatability.
17. The staging ring and the rest of the op modules. (a) Phase 13a's
   Trainer for 2 epochs of 24 batches from the same weights, epoch 1
   timed, fed three ways: host stacking (steps_per_dispatch=4), the
   staging ring (reader.staged_superbatch(reader, 4) into
   train(stacked_windows=True)) and reader.prefetch_to_device at
   pipeline depth 2 over a reader that overwrites its buffer after every
   yield: ms a step each, the same parameters and losses bit for bit,
   K1/K2/K3/dropout launches a step exactly, every ring slot
   page-locked before its first copy, the ring's gauges at 0 occupancy.
   (c) The 38 op types the slice adds, through their layers, in one
   captured program at [4096, 512] (random feed) and in one at [4, 8]
   on the edge values, fp32 and bf16 AMP, card against host at the
   harness's tolerances (scatter's repeated ids exactly); the host-bound
   ops (truncated_gaussian_random, randint, shuffle_batch, nce, print)
   eagerly on shape, range, moments and repeatability; a fc with
   WeightNormParamAttr 3 SGD steps card against host (rtol 1e-5). (b)
   Phase 15's Wide&Deep SGD step, 48 steps step by step, as windows of
   4 through the ring and run_steps, and as the same windows already on
   the card, from the same state, bit for bit: wall and (last, under
   torch.profiler) device busy ms a step, no host copy for the windows
   on the card.

18. The rest of the training path. (a) bench.py's bench_moe (vocab
   32000, batch 32 x seq 64, 4 layers, 8 heads, d_model 512, d_inner
   2048, 8 experts, capacity factor 1.25, top-1, dropout 0.1, Adam(1e-4),
   bf16 AMP) through models/moe.py, scan_layers (moe_layer_stack) and
   unrolled, captured, 3 warm-up and 20 timed steps: ms a step, tokens/s,
   MFU, the share of tokens over capacity a layer (one more eager step
   with the slots read), peak memory, and K1 / K2 / K3 / dropout launches
   checked exactly against the count worked out from the program; at that
   width 3 captured steps against 3 eager ones and a second captured run
   from the same state, bit for bit; at a small width (2 layers, d_model
   64, 4 experts, top-1 and top-2, unrolled and scan) the card against
   the host over 3 Adam steps (losses rtol 1e-4 fp32, 2e-2 bf16), and
   scan against unrolled through stack_moe_trained_weights (1e-5). (b)
   memory_optimize level 0 and level 1 against no remat on phase 6's
   Transformer-base (unrolled and scan_layers), (a)'s LM (scan) and phase
   9's ResNet-50 (its batch norms move running statistics in the
   forward): ms a step, the step's peak memory (level 1's below no
   remat's), the losses of 3 steps and every trainable parameter and
   running statistic after them bit for bit, one CUDA graph. (c)
   GradientAccumulator(Adam(1e-4), 4) on Transformer-base, fp32 at
   micro-batch 16: the gated steps bit for bit, the mean gradient equal
   to the micro-batches' summed in its order, the parameters after 8
   micro steps against 2 Adam steps at batch 64 beside a permuted-batch
   control, captured == eager and run_steps(4) == 4 runs bit for bit.
19. The recurrent and sequence path. (a) bench.py's bench_rnn_lstm
   (benchmark/paddle/rnn: vocab 30000, batch 128 x seq 100, embedding
   128, one LSTM of hidden 128, Adam(2e-3) with L2Decay(8e-4) and
   element-wise clipping at 25, bf16) built by
   models/seq_models.lstm_text_classifier, the fluid layers the
   reference's v1 shim lowers it to: 3 warm-up and 20 timed captured
   steps (ms a step, tokens/s, MFU, peak memory), exactly one LSTM
   sequence launch forward and one backward a step and no cell launch;
   then at hidden 512 (bench.py's hidden argument), past the sequence
   kernels' plan, 5 timed steps with exactly 100 cell launches each way a
   step and no sequence launch; at batch 8 x seq 16 with
   ragged lengths 3 fp32 steps card against host (losses rtol 1e-5); at
   width 3 captured steps against 3
   eager ones and one run_steps(3), bit for bit. (b) stacked_lstm_net at
   its defaults, stacked_gru_tagger, convolution_net and srl_tagger with
   srl_decode at batch 64 x seq 100 (lengths 1-100, vocab 5147, SGD):
   ms a step captured (one graph), exactly one sequence launch each way
   a recurrent layer and step and no cell launch, 3 steps card against
   host (rtol 1e-4); stacked_gru_tagger at hidden 512, past the GRU
   cluster's plan, 3 timed steps with exactly one wide GRU launch each
   way a layer and step, and at hidden 1024, past every GRU plan, 3 with
   exactly 2 x 100 cell launches each way a layer and step. (c) each
   cell kernel
   (csrc/rnn_cell.cu: LSTM
   forward, backward; GRU forward, backward, two launches a step each)
   against its plain version at fp32 and bf16, at the bench step, ragged
   lengths, all padding and every activation, each twice for equal bits;
   timed at the bench step beside its bound and, for the LSTM, torch's
   fused LSTM cell and its backward; the LSTM sequence kernels
   (csrc/lstm_seq.cu) against their plain versions (the per-position loop
   with plain cells) at fp32 and bf16 on the bench recurrence, ragged
   lengths, all padding, every activation, B 37 x hidden 20 and reverse,
   with and without bias, dhidden and dcell, each twice for equal bits,
   timed at the bench recurrence beside their bound, their floor (T
   steps of the cluster's exchange alone, the same launch), the
   per-position path and cuDNN's nn.LSTM at fp16; the GRU sequence
   kernels (csrc/gru_seq.cu) likewise on the same cases (their floor two
   exchanges a step; no PyTorch call computes the GRU's function); the
   wide GRU kernels (csrc/gru_wide.cu: W over the card, the exchanges
   through L2) likewise at hidden 512 (GRU_WIDE_CASES), timed at 64 x
   100 x 512 in fp32 and bf16 beside their bound, their exchange floor,
   the plain version and the per-position path; the whole recurrences
   card against host at fp32 (ragged, reverse, length 0; the GRU at 512
   on the wide kernels, and past every plan, the LSTM at hidden 256 and
   the GRU at 1024, on the cells), and each recurrence beside the
   per-position path and torch.nn.LSTM / nn.GRU (cuDNN at fp16 and fp32;
   nn.GRU applies its reset gate after the product, a yardstick for
   another function), the GRU also at 64 x 100 x 512. (d) the 22 op
   types of
   the slice in one captured program (B 16, T 24, lengths 0-24), fp32
   and bf16 AMP, card against host (exact, or recurrence_difference).
20. Control flow, the RNN-search seq2seq and SSD. (a) models/rnn_search
   at the v1 seqToseq demo's widths (word vectors, encoder and decoder
   512, dictionaries of 30,000), batch 64 x 50 source and target tokens
   (source lengths 20-50), Adam, fp32: 3 warm-up and 10 timed captured
   steps (wall and device-busy ms a step, device kernels a step), the
   encoder's GRU at hidden 512 on the wide GRU kernels (no cluster holds
   W): exactly 2 launches each way a step; the 13 losses equal an
   eager run's from the same start bit for bit; then 2 + 5 bf16 AMP
   steps likewise; then greedy and beam-4 decoding of the batch at 50
   positions from the trained scope, ms a batch captured, ids equal the
   eager run's. (b) at hidden 128, vocab 1,000, batch 16 x 20: 3 Adam
   steps card against host (rtol 1e-4), the encoder on the GRU sequence
   kernels (one launch each way a direction and step), greedy ids equal.
   (c) a While countdown over a tensor array (eager: host-bound), an
   IfElse and a StaticRNN (captured), each card against host exactly.
   (d) models/ssd at its defaults (3 x 128 x 128, 21 classes, max_gt 8),
   batch 32, Adam, fp32: 3 warm-up and 10 timed captured steps with
   exactly 5 K5 forward and 5 backward launches a step, then ssd_infer's
   detection_output captured against eager; at 3 x 64 x 64, 4 classes,
   batch 2: 3 steps card against host (rtol 1e-4), then the detections
   (labels exact, scores and boxes within 1e-5). (e) generation_decode on
   the v1 seq2seq of tests/fixtures/generation_decode_v1.json, beam 4,
   captured on the card, ids equal the host's.
21. The conv path's rest. (a) MobileNet v1 (scale 1.0, NHWC and NCHW,
   batch 64) and SE-ResNeXt-50 32x4d (reduction 16, NCHW, batch 32) at
   224 x 224, 1000 classes, bf16 AMP, Momentum(0.1, 0.9): 3 eager steps,
   then 10 captured (wall, device-busy ms and kernels a step), exactly
   27 + 27 and 53 + 53 K5 launches a step; then each at its tests' small
   build, fp32: the first step captured against eager within 1e-6 under
   cudnn.deterministic (the default algorithms' gap printed). (b)
   VGG-16, AlexNet and GoogLeNet (224, batch 64, bf16), LeNet-5 (1 x 28 x
   28, batch 64, fp32) and vgg_bn_drop (3 x 32 x 32, batch 128, fp32 and
   bf16, 14 + 14 K5 launches a step, one of them the [128, 512] fc
   output), Momentum(0.01, 0.9): 3 captured steps each, losses finite
   and falling over a repeated batch; every model of (a) and (b) counts
   one max_pool_fwd and one max_pool_bwd launch a max pool a step
   (MAX_POOLS_A_STEP). (c) the seven small builds card
   against host from the same weights, 2 steps, fp32 and bf16: the first
   loss within 1e-5 (bf16: 1e-2) relative, the second printed (a step
   of these nets turns rounding into percents of the next loss). (d)
   the 12 op types card against host at working sizes, forward and
   gradient (roi_pool at Fast R-CNN's VGG-16 head, the pool / unpool
   round trip at SegNet's first pooling, ...): exact ones bit for bit.
   (e) K5 at MobileNet's and SE-ResNeXt's NCHW shapes and the 2-D
   [128, 512] in bf16 and fp32, against its plain versions.

The last line is {"ok": true, "device": {...}}; before it come one JSON
line with every kernel's numbers (and phase 13's under "lifecycle":
tokens/s a depth, launches a step, checkpoint bytes, save, restore and
export seconds; phase 14's under "disagg"; phase 15's under "ctr";
phase 16's under "layers"; phase 17's under "staging"; phase 18's under
"moe"; phase 19's under "rnn"; phase 20's under "control_flow"; phase
21's under "conv") and
nvidia-smi's name and power limit.
--cpu-rehearsal runs phases 4-21 at tiny sizes with the plain versions
(phases 8, 10, 11, 13d and 15 then compare the host with itself) and
never prints that last line. --profile adds, after every other phase, a torch.profiler
breakdown of decode steps (fp32 and int8 arenas, captured and eager),
verify steps (k = 3), Transformer (unrolled and scan_layers) and
ResNet-50 training steps (captured and eager): wall, device busy time and
share, host launches (kernels and graphs) a step; then phase 12's calls
(captured; eager at fp32 for the one-query attention's spans) by family;
then each phase-15 Wide&Deep leg's step: the four row-sparse legs
(checked: no sort kernel in them) and SGD with dense gradients
(captured).
--kernels-only stops after phase 3 (no verdict line). kernel_times.py
times K1, K4, K2, K3 and K5 and the backward kernels of any checkout of
this repository at phase 3's shapes.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
VOCAB = 32000


def fail(msg):
    print('chip_smoke: FAIL: %s' % msg, file=sys.stderr)
    sys.exit(1)


def require(cond, msg):
    if not cond:
        fail(msg)


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), elementwise, float64."""
    a = np.maximum(np.abs(np.asarray(x, dtype=np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _events_ms(torch, run, iters):
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def eager_ms(torch, fn, iters=100, warmup=10):
    """ms per call over ``iters`` back-to-back eager calls (CUDA events,
    after ``warmup`` calls). Small calls are bound by the host issuing
    them: the wrapper's Python, ctypes and the launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(torch, run, iters)


def device_ms(torch, fn, iters=100):
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed (after one warm replay), timed with CUDA events, so the
    host's cost of issuing each call is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(torch, graph.replay, iters)
    del graph
    return ms


def bound_ms(n_bytes, n_ops, peak_ops=FP32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


# the flash wrappers, which also count each of their two variants
VARIANTS = ('flash_attention_fwd', 'flash_attention_bwd_dkv',
            'flash_attention_bwd_dq')


def _counters():
    """[(name, wrapper, attribute)]: every launch count the smoke reads
    (each wrapper adds one where it launches its kernel; the executor adds
    a captured graph's at each replay), and the batch norm backward's
    copies of a gradient into x's layout."""
    from paddle_tpu_torch.ops.kernels import launch_counters
    return launch_counters()


def reset_launches():
    """Every kernel wrapper's launch counts to 0."""
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr) for name, fn, attr in _counters()}


# ------------------------------------------------------------ phase 1
def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, 'nvidia-smi failed: %s' % smi.stderr)
    card = smi.stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print('device: %s, count %d, torch %s, cuda %s'
          % (name, count, torch.__version__, torch.version.cuda))
    print('nvidia-smi: %s' % card)
    print('tf32: torch.backends.cuda.matmul.allow_tf32=%s '
          'torch.backends.cudnn.allow_tf32=%s'
          % (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32))
    return name, count, card


# ------------------------------------------------------------ phase 2
def phase_build():
    """Build, print ptxas's numbers, and fail unless its log shows the
    split-KV and the tensor-core kernels."""
    from paddle_tpu_torch.ops.kernels import build
    res = build.build()
    print('build: %.2f s (one nvcc a source, all started together, then a '
          'link: %s) -> %s' % (res.seconds, ' '.join(build.SOURCES),
                               os.path.relpath(res.path, REPO)))
    for line in res.log.splitlines():
        if 'ptxas info' in line and ('Compiling' in line or 'Used' in line):
            print('  ' + line.strip())
        elif 'spill' in line:   # the stack frame and spills of the above
            print('    ' + line.strip())
    lib = build.library()
    for kernel in ('paged_split_kernel', 'paged_merge_kernel',
                   'paged_split_any_kernel', 'flash_fwd_mma_kernel',
                   'flash_bwd_dkv_mma_kernel', 'flash_bwd_dq_mma_kernel',
                   'flash_fwd_wide_kernel', 'flash_bwd_dkv_wide_kernel',
                   'flash_bwd_dq_wide_kernel', 'bn_train_kernel',
                   'bn_bwd_kernel', 'ln_warp_kernel', 'ln_bwd_rows_kernel',
                   'ln_bwd_cols_kernel', 'kv_write_kernel',
                   'keep_mask_kernel', 'dropout_kernel',
                   'sparse_rows_group_kernel', 'lstm_cell_fwd_kernel',
                   'lstm_cell_bwd_kernel', 'gru_cell_fwd_kernel',
                   'gru_cell_bwd_kernel', 'lstm_seq_fwd_kernel',
                   'lstm_seq_bwd_kernel', 'gru_seq_fwd_kernel',
                   'gru_seq_bwd_kernel', 'gru_wide_fwd_kernel',
                   'gru_wide_bwd_kernel', 'max_pool_fwd_kernel',
                   'max_pool_bwd_kernel'):
        require(kernel in res.log, 'ptxas\'s log does not show %s' % kernel)
    print('  flash attention dynamic shared memory at D=64: tensor-core '
          'forward %d B, SIMT forward %d B, SIMT dK/dV %d B, SIMT dQ %d B, '
          'tensor-core backward %d B'
          % tuple(lib.ptt_flash_smem_bytes(i, 64) for i in (3, 0, 1, 2, 4)))
    return res


# ------------------------------------------------------------ phase 3
def _ln_case(torch, card, n, d, dtype, gen):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import layer_norm as K
    dev = torch.device('cuda', 0)
    x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    g = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev))
    b = 0.1 * torch.randn(d, generator=gen, device=dev)
    y = K.fused_layer_norm(x, g, b, eps=1e-5)
    ref = K._ln_reference(x, g, b, 1e-5)
    torch.cuda.synchronize()
    yf, rf = y.float().cpu().numpy(), ref.float().cpu().numpy()
    err = float(np.max(np.abs(yf - rf)))
    if dtype == torch.float32:
        tol = 'fp32: |kernel - plain| <= 1e-5 + 1e-5*|plain|'
        ok = np.all(np.abs(yf - rf) <= 1e-5 + 1e-5 * np.abs(rf))
    else:
        tol = 'bf16: |kernel - plain| <= 1 bf16 ulp'
        ok = np.all(np.abs(yf - rf) <=
                    bf16_ulp(np.maximum(np.abs(yf), np.abs(rf))))
    item = x.element_size()
    n_bytes = 2 * n * d * item + 2 * d * 4
    lo, by = bound_ms(n_bytes, 8 * n * d)
    gl, bl = g.to(dtype), b.to(dtype)
    ms = device_ms(torch, lambda: K.fused_layer_norm(x, g, b, eps=1e-5))
    eager = eager_ms(torch, lambda: K.fused_layer_norm(x, g, b, eps=1e-5))
    plain = device_ms(torch, lambda: K._ln_reference(x, g, b, 1e-5))
    lib = device_ms(torch, lambda: F.layer_norm(x, (d,), gl, bl, 1e-5))
    label = 'layer_norm [%d, %d] %s' % (n, d, str(dtype)[6:])
    print('%s: max_abs_err %.3g (%s) %s; device ms: kernel %.5f, plain '
          '%.5f, F.layer_norm %.5f, bound %.6f (%s); kernel eager %.5f ms '
          '[%s]' % (label, err, tol, 'ok' if ok else 'MISMATCH', ms, plain,
                    lib, lo, by, eager, card))
    require(ok, '%s disagrees with its plain version' % label)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=lib, eager_ms=eager)


def grad_ms(torch, fn, inputs, grad_out, iters=50):
    """The backward of ``fn(*inputs)`` under autograd: (device ms a call by
    CUDA-graph replay, the autograd node that ran it, eager ms). The forward
    runs once outside the graph, on the stream that then captures ``iters``
    calls of torch.autograd.grad of its output (autograd runs a backward on
    its forward's stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [x.detach().clone().requires_grad_() for x in inputs]
        out = fn(*leaves)

        def grad():
            return torch.autograd.grad(out, leaves, grad_out,
                                       retain_graph=True)

        for _ in range(3):
            grad()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                grad()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(torch, graph.replay, iters)
    del graph
    eager = eager_ms(torch, grad, iters=iters)
    return ms, out.grad_fn.name(), eager


GRAD_TOL = ('dx: bf16 within 1 bf16 ulp of max(|kernel|, |plain|) + 1e-6 '
            'max|dx|, fp32 max-norm relative 1e-5; parameter gradients '
            'max-norm relative 1e-5')


def grads_ok(torch, got, want, dtype):
    """(max abs errors, ok) of a backward kernel's outputs against its plain
    version's: dx in x's dtype first, then fp32 parameter gradients. bf16
    dx: within one bf16 ulp of max(|kernel|, |plain|), plus 1e-6 of the
    largest |dx| (fp32 sums taken in another order where dx cancels to
    near 0); fp32 dx and every parameter gradient: max-norm relative 1e-5
    (|kernel - plain| <= 1e-5 * max|plain|)."""
    errs, ok = [], True
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        top = float(w.abs().max())
        errs.append(float(diff.max()))
        if i == 0 and dtype == torch.bfloat16:
            ok = ok and bool((diff <= bf16_ulp_t(torch, torch.maximum(
                g.abs(), w.abs())) + 1e-6 * top).all())
        else:
            ok = ok and errs[-1] <= 1e-5 * top
    return errs, ok


def _ln_bwd_case(torch, card, n, d, dtype, gen):
    """K1's backward kernels (row kernel + column sum) against
    layer_norm_reference_bwd (autograd through the plain forward), two
    runs for equal bits, and their times beside F.layer_norm's autograd
    backward."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import layer_norm as K
    dev = torch.device('cuda', 0)
    x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    g = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    b = 0.1 * torch.randn(d, generator=gen, device=dev)
    gy = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    before = K.fused_layer_norm.bwd_launches
    got = K._ln_bwd_cuda(x, g, gy, 1e-5)
    again = K._ln_bwd_cuda(x, g, gy, 1e-5)
    torch.cuda.synchronize()
    require(K.fused_layer_norm.bwd_launches == before + 4,
            'layer_norm backward: %d launches for 2 calls, want 4'
            % (K.fused_layer_norm.bwd_launches - before))
    require(all(torch.equal(a, r) for a, r in zip(got, again)),
            'layer_norm backward [%d, %d]: two runs differ' % (n, d))
    want = K.layer_norm_reference_bwd(x, g, b, gy, 1e-5)
    errs, ok = grads_ok(torch, got, want, dtype)
    item = x.element_size()
    lo, by = bound_ms(3 * n * d * item + 3 * d * 4, 12 * n * d)
    bwd = lambda: K._ln_bwd_cuda(x, g, gy, 1e-5)  # noqa: E731
    ms = device_ms(torch, bwd)
    eager = eager_ms(torch, bwd)
    plain = device_ms(torch, lambda: K.layer_norm_reference_bwd(
        x, g, b, gy, 1e-5), iters=20)
    lib, node, lib_eager = grad_ms(
        torch, lambda a, w, c: F.layer_norm(a, (d,), w, c, 1e-5),
        (x, g.to(dtype), b.to(dtype)), gy)
    label = 'layer_norm backward [%d, %d] %s' % (n, d, str(dtype)[6:])
    print('%s: max_abs_err dx %.3g, dgamma %.3g, dbeta %.3g (%s) %s; two '
          'launches a call, two runs bit-equal; device ms: kernels %.5f, '
          'plain %.5f, F.layer_norm backward %.5f (%s; eager %.5f), bound '
          '%.6f (%s); kernels eager %.5f ms [%s]'
          % (label, errs[0], errs[1], errs[2], GRAD_TOL,
             'ok' if ok else 'MISMATCH', ms, plain, lib, node, lib_eager, lo,
             by, eager, card))
    require(ok, '%s disagrees with its plain version' % label)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=lib, eager_ms=eager)


def _paged_inputs(torch, gen, n, lens, dtype, broadcast, h=8, d=64, bs=32,
                  p=64, nb=4096, empty=(), dv=None, verify=0):
    """K4's inputs on the card. ``dtype`` 'int8' or 'float8_e4m3fn' gives
    pages quantized row by row and their scales (returned after the
    lengths). ``verify`` = k + 1 repeats each of the ``n`` sequences'
    table k + 1 times at lengths len .. len + k: the verify step's rows."""
    from paddle_tpu_torch.quant.core import quantize_rows
    dev = torch.device('cuda', 0)
    dv = d if dv is None else dv
    quant = isinstance(dtype, str)
    pdt = torch.float32 if quant else dtype
    kp = torch.randn(nb, h, bs, d, generator=gen, device=dev).to(pdt)
    vp = torch.randn(nb, h, bs, dv, generator=gen, device=dev).to(pdt)
    q = torch.randn(n * max(verify, 1), h, d, generator=gen, device=dev)
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    if broadcast:
        row = perm[:p].clone()
        owned = -(-max(lens) // bs)
        row[owned:] = nb          # "no page" past the owned pages
        tables = row.expand(n, p)
    else:
        top = [ln + max(verify - 1, 0) for ln in lens]
        tables = perm[:n * p].reshape(n, p).clone()
        for i, ln in enumerate(top):
            tables[i, -(-ln // bs):] = nb + 7
        for i in empty:
            tables[i] = nb        # empty decode slot: all entries >= NB
    if verify:
        tables = tables.repeat_interleave(verify, dim=0)
        lens = [ln + j for ln in lens for j in range(verify)]
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    if not quant:
        return q, kp, vp, tables, seq_lens
    kq, ks = quantize_rows(kp, dtype)
    vq, vs = quantize_rows(vp, dtype)
    del kp, vp
    return q, kq, vq, tables, seq_lens, ks, vs


def _paged_case(torch, card, label, q, kp, vp, tables, lens, ks=None,
                vs=None, heavy=False):
    """K4 against both its plain versions on one input, and its times.
    ``ks``/``vs`` are the row scales of int8 / e4m3 pages. ``heavy`` (the
    512-row prefill: the plain versions gather GBs) cuts the plain
    version's and the yardstick's timed calls to 5."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import paged_attention as K
    kw = {} if ks is None else dict(k_scales=ks, v_scales=vs)
    out = K.paged_attention(q, kp, vp, tables, lens, **kw)
    refs = [K.paged_attention_reference(q, kp, vp, tables, lens,
                                        **kw).float(),
            K.paged_attention_split_reference(q, kp, vp, tables, lens,
                                              **kw)]
    torch.cuda.synchronize()
    of = out.float().cpu().numpy()
    live = (lens > 0).cpu().numpy()    # an empty slot gives 0, no average
    require(np.all(of[~live] == 0), '%s: an empty row is not 0' % label)
    if ks is not None:
        tol = ('quantized: |kernel - plain| <= 1e-5 * max|plain| (the same '
               'dequantized operands, summed in another order)')
    elif kp.dtype == torch.float32:
        tol = 'fp32: |kernel - plain| <= 5e-5'
    else:
        tol = ('bf16: |kernel - plain| <= 2e-2 + 2e-2*|plain| (plain '
               'output rounded to bf16, 2^-7 at the top of a binade, and '
               'p rounded to bf16 at different points)')
    errs, ok = [], True
    for ref in refs:
        rf = ref.cpu().numpy()
        gap = np.abs(of - rf)[live]
        errs.append(float(gap.max()))
        if ks is not None:
            ok = ok and errs[-1] <= 1e-5 * float(np.abs(rf[live]).max())
        elif kp.dtype == torch.float32:
            ok = ok and errs[-1] <= 5e-5
        else:
            ok = ok and bool(np.all(gap <= 2e-2 + 2e-2 * np.abs(rf[live])))
    del refs
    err = max(errs)
    nb, h, bs, d = kp.shape
    n, p = tables.shape
    dv = vp.shape[-1]
    n_bytes = _paged_bytes(kp, vp, tables, lens, ks is not None)
    n_ops = int(lens.sum()) * h * (2 * d + 2 * dv + 5)
    lo, by = bound_ms(n_bytes, n_ops)
    ms = device_ms(torch, lambda: K.paged_attention(q, kp, vp, tables,
                                                    lens, **kw))
    eager = eager_ms(torch, lambda: K.paged_attention(q, kp, vp, tables,
                                                      lens, **kw))
    few = 5 if heavy else 20
    plain = device_ms(torch, lambda: K.paged_attention_reference(
        q, kp, vp, tables, lens, **kw), iters=few)
    lib = None      # quantized pages: no single PyTorch call
    if ks is None:
        # yardstick: SDPA over K/V already gathered (the gather is not
        # timed)
        idx = tables.long().clamp(0, nb - 1)
        kg = kp[idx].permute(0, 2, 1, 3, 4).reshape(n, h, p * bs, d)
        vg = vp[idx].permute(0, 2, 1, 3, 4).reshape(n, h, p * bs, dv)
        mask = (torch.arange(p * bs, device=q.device)[None, :] <
                lens[:, None])[:, None, None, :]
        qd = q[:, :, None, :].to(kp.dtype)
        lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kg, vg, attn_mask=mask), iters=few)
        del kg, vg
    print('%s: max_abs_err %s vs the one-pass and the split plain version '
          '(%s) %s; device ms: kernel %.5f, plain %.5f, SDPA(gathered) '
          '%s, bound %.6f (%s); kernel eager %.5f ms [%s]'
          % (label, ' / '.join('%.3g' % e for e in errs), tol,
             'ok' if ok else 'MISMATCH', ms, plain,
             'none (no single PyTorch call)' if lib is None else
             '%.5f' % lib, lo, by, eager, card))
    require(ok, '%s disagrees with its plain version' % label)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=lib, eager_ms=eager)


def _paged_row_independence(torch, card, gen):
    """A row's output must be a pure function of its q, pages and length:
    the same row in a 16-row decode batch, alone in a 1-row call and
    inside a 128-row broadcast-table call, bit for bit, fp32 and bf16
    (the engine's concurrent-equals-alone and preempt-and-recompute
    invariants rest on it)."""
    from paddle_tpu_torch.ops.kernels import paged_attention as K
    dev = torch.device('cuda', 0)
    lens16 = [1, 33, 300, 2048, 257, 256, 576, 1000, 64, 65, 2047, 31, 512,
              700, 1500, 2]
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, tables, lens = _paged_inputs(torch, gen, 16, lens16,
                                                dtype, False)
        full = K.paged_attention(q, kp, vp, tables, lens)
        for i in (1, 2, 3, 4, 9, 13):
            alone = K.paged_attention(q[i:i + 1], kp, vp, tables[i:i + 1],
                                      lens[i:i + 1])
            qs = torch.randn(128, 8, 64, generator=gen, device=dev)
            qs[77] = q[i]
            ls = torch.randint(1, 2049, (128,), generator=gen,
                               device=dev).to(torch.int32)
            ls[77] = lens[i]
            row = tables[i].clone()
            row[row >= kp.shape[0]] = 5   # other rows read past this one
            many = K.paged_attention(qs, kp, vp, row.expand(128, 64), ls)
            torch.cuda.synchronize()
            require(torch.equal(alone[0], full[i]) and
                    torch.equal(many[77], full[i]),
                    'paged_attention %s: row %d (length %d) differs between '
                    'a 16-row batch, a 1-row call and a 128-row broadcast '
                    'call' % (str(dtype)[6:], i, lens16[i]))
        del q, kp, vp
        torch.cuda.empty_cache()
    print('paged_attention row independence: 6 rows x 2 dtypes bit-equal in '
          'a 16-row batch, alone and inside a 128-row broadcast-table call '
          '[%s]' % card)


def _row_tile_check(torch, card, gen):
    """The LM's products run in fixed ROW_TILE-row tiles
    (paged_decode_ops._mm) because cuBLAS picks its fp32 algorithm by the
    row count: rows of torch.matmul at M = 16, 64 and 512 are compared
    (printed), and _mm's rows must be bit-equal at every M, so a
    sequence's stream does not depend on the batch, a cache hit or
    speculation."""
    from paddle_tpu_torch.ops.paged_decode_ops import ROW_TILE, _mm
    dev = torch.device('cuda', 0)
    h = torch.randn(512, 512, generator=gen, device=dev)
    differ = []
    for k, n in ((512, 512), (512, 2048), (2048, 512), (512, 32000)):
        x = h if k == 512 else torch.randn(512, k, generator=gen,
                                           device=dev)
        w = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
        plain = {m: x[:m] @ w for m in (16, 64, 512)}
        differ.append('[%d, %d] %s' % (k, n, not (
            torch.equal(plain[16], plain[64][:16]) and
            torch.equal(plain[64], plain[512][:64]))))
        tiled = _mm(x, w)
        for m in (ROW_TILE, 2 * ROW_TILE):
            require(torch.equal(_mm(x[:m], w), tiled[:m]),
                    'row tiles: _mm rows at M=%d differ from M=512' % m)
        pad = torch.cat([x[:16], x.new_zeros(ROW_TILE - 16, k)])
        require(torch.equal(_mm(pad, w)[:16], tiled[:16]),
                'row tiles: a padded 16-row call differs from M=512')
    print('row tiles: torch.matmul rows differ between M = 16, 64, 512: '
          '%s; _mm (%d-row tiles) rows bit-equal at every M [%s]'
          % (', '.join(differ), ROW_TILE, card))


def _live_pairs(b, tq, tk, lens, causal):
    """(query, key) pairs that attend, summed over the batch (per head;
    the causal band aligned bottom-right)."""
    rows = np.arange(tq)[:, None]
    cols = np.arange(tk)[None, :]
    live = 0
    for i in range(b):
        m = cols < (tk if lens is None else int(lens[i]))
        if causal:
            m = m & (cols <= rows + tk - tq)
        live += int(np.broadcast_to(m, (tq, tk)).sum())
    return live


def _key_reads(b, tk, lens):
    """(K rows, V rows) the forward must read, summed over the batch: the
    keys below each row's kv_len (every key without kv_len: the causal
    band's last row sees them all), and all of V for a row with no live
    key (its output is mean(V))."""
    if lens is None:
        return b * tk, b * tk
    live = [min(int(n), tk) for n in lens]
    return sum(live), sum(n if n else tk for n in live)


def _flash_case(torch, card, label, b, h, t, d, dtype, causal, lens, gen,
                tk=None, backward=True, strided=False):
    """K2 and, with ``backward``, K3 against their plain versions on one
    input (Tq = t, Tk = tk, default t; with ``strided``, q/k/v are
    head-split views of [B, T, H*D] projections, as the fused_attention op
    hands them over); returns the numbers of each (forward, backward or
    None)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as K
    dev = torch.device('cuda', 0)
    tk = t if tk is None else tk

    def draw(n):
        if strided:
            x = torch.randn(b, n, h * d, generator=gen, device=dev).to(dtype)
            return x.view(b, n, h, d).transpose(1, 2)
        return torch.randn(b, h, n, d, generator=gen, device=dev).to(dtype)

    q = draw(t)
    do = draw(t) if backward else None
    k, v = draw(tk), draw(tk)
    kv = None if lens is None else torch.tensor(lens, device=dev)
    fwd_count = K.flash_fwd_cuda
    before = (fwd_count.launches_mma, fwd_count.launches_simt)
    out, lse = K.flash_attention_fwd(q, k, v, kv, causal)
    # a second run must give the same bits: a copy that was not waited for
    # shows as rare wrong values, not as a fault
    out2, lse2 = K.flash_attention_fwd(q, k, v, kv, causal)
    torch.cuda.synchronize()
    require(torch.equal(out, out2) and torch.equal(lse, lse2),
            '%s: two runs of K2 differ' % label)
    del out2, lse2
    moved = (fwd_count.launches_mma - before[0],
             fwd_count.launches_simt - before[1])
    # the launchers' choice: bf16 with a head dim that is a multiple of 16
    # up to 128 on the tensor cores, everything else SIMT
    mma = dtype == torch.bfloat16 and d % 16 == 0 and d <= 128
    variant = 'tensor-core' if mma else 'SIMT'
    require(moved == ((2, 0) if mma else (0, 2)),
            '%s: K2 launched (tensor-core, SIMT) = %s, want the %s kernel '
            'twice' % (label, moved, variant))
    ref_out, ref_lse = K.flash_attention_reference_fwd(q, k, v, kv, causal)
    til_out, til_lse = K.flash_attention_tiled_reference_fwd(q, k, v, kv,
                                                             causal)
    if backward:
        # K3 twice on its own variant (the same bits), and for bf16 the
        # SIMT pair too, on copies that start one element into their storage
        variant_bwd = 'mma' if mma else 'simt'
        before = _bwd_counts(K)
        grads = K.flash_attention_bwd(q, k, v, out, lse, do, kv, causal)
        grads2 = K.flash_attention_bwd(q, k, v, out, lse, do, kv, causal)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(grads, grads2)),
                '%s: two runs of K3 differ' % label)
        require(_bwd_moved(K, before) == variant_bwd,
                '%s: K3 launched %s, want the %s pair twice'
                % (label, _bwd_moved(K, before), variant_bwd))
        del grads2
        ref_grads = K.flash_attention_reference_bwd(q, k, v, out, lse, do,
                                                    kv, causal)
        simt_grads = None
        if mma:
            shifted = [_shifted(torch, x) for x in (q, k, v, out, do)]
            before = _bwd_counts(K)
            simt_grads = K.flash_attention_bwd(*shifted[:4], lse, shifted[4],
                                               kv, causal)
            again = K.flash_attention_bwd(*shifted[:4], lse, shifted[4], kv,
                                          causal)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b)
                        for a, b in zip(simt_grads, again)),
                    '%s: two runs of the SIMT K3 pair differ' % label)
            require(_bwd_moved(K, before) == 'simt',
                    '%s: K3 on misaligned copies launched %s, want the SIMT '
                    'pair twice' % (label, _bwd_moved(K, before)))
            del shifted, again
        torch.cuda.synchronize()
    if dtype == torch.float32:
        tol = ('fp32: |kernel - plain| <= 1e-5 * max(1, max|plain|) (the '
               'same sums in another order)')
    else:
        tol = ('bf16: |kernel - plain| <= 1e-2 * max|plain| + 1e-2 * '
               '|plain| (outputs rounded to bf16; p rounded per tile '
               'against the running max, in the plain version against the '
               'row max)')

    def err_ok(got, want):
        g, w = got.float(), want.float()
        top = float(w.abs().max())
        diff = (g - w).abs()
        if dtype == torch.float32:
            ok = float(diff.max()) <= 1e-5 * max(top, 1.0)
        else:
            ok = bool((diff <= 1e-2 * top + 1e-2 * w.abs()).all())
        return float(diff.max()), ok

    fwd_err, fwd_ok = err_ok(out, ref_out)
    til_err, til_ok = err_ok(out, til_out)
    lse_err = max(float((lse - ref_lse).abs().max()),
                  float((lse - til_lse).abs().max()))
    fwd_ok = fwd_ok and til_ok and lse_err <= 1e-4
    del til_out, til_lse
    if backward:
        bwd = [err_ok(g, w) for g, w in zip(grads, ref_grads)]
        bwd_err = max(e for e, _ in bwd)
        bwd_ok = all(ok for _, ok in bwd)
        simt_note = ''
        if simt_grads is not None:
            simt = [err_ok(g, w) for g, w in zip(simt_grads, ref_grads)]
            simt_err = max(e for e, _ in simt)
            bwd_ok = bwd_ok and all(ok for _, ok in simt)
            simt_note = ', SIMT pair %.3g' % simt_err
            del simt_grads

    # bytes: Q read and O written, K and V read over the keys the function
    # needs, lse written (the backward: Q, O, dO read, dQ written, K and V
    # read over the live keys, dK and dV written in full)
    item = q.element_size()
    row = h * d * item
    nq, nk = b * t * row, b * tk * row
    k_rows, v_rows = _key_reads(b, tk, lens)
    live = _live_pairs(b, t, tk, lens, causal) * h
    peak = BF16_FLOPS if mma else FP32_FLOPS
    fwd_bound = bound_ms(2 * nq + (k_rows + v_rows) * row + b * h * t * 4,
                         4 * live * d, peak)

    fwd = lambda: K.flash_attention_fwd(q, k, v, kv, causal)  # noqa: E731
    times = dict(
        fwd_ms=device_ms(torch, fwd, iters=50),
        fwd_eager=eager_ms(torch, fwd, iters=50),
        fwd_plain=device_ms(torch, lambda: K.flash_attention_reference_fwd(
            q, k, v, kv, causal), iters=10))
    # yardstick: SDPA forward and its autograd backward (graph replay, as
    # the kernels; the backward also eager), on the same inputs and mask
    mask = sdpa_mask(torch, t, kv, causal, tk)
    sdpa_causal = causal and mask is None
    times['fwd_lib'] = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=sdpa_causal), iters=50)
    fwd_rec = dict(max_abs_err=max(fwd_err, til_err, lse_err),
                   ms=times['fwd_ms'],
                   plain_ms=times['fwd_plain'], bound_ms=fwd_bound[0],
                   bound_by=fwd_bound[1], library_ms=times['fwd_lib'],
                   eager_ms=times['fwd_eager'])
    fwd_note = ('%s: forward (%s kernel) max_abs_err %.3g vs the whole-row '
                'and %.3g vs the tiled plain version (lse %.3g, limit 1e-4)'
                % (label, variant, fwd_err, til_err, lse_err))
    fwd_times = ('forward kernel %.5f, plain %.5f, SDPA %.5f, bound %.6f '
                 '(%s)' % (times['fwd_ms'], times['fwd_plain'],
                           times['fwd_lib'], fwd_bound[0], fwd_bound[1]))
    if not backward:
        print('%s (%s) %s; device ms: %s; eager ms: forward %.5f [%s]'
              % (fwd_note, tol, 'ok' if fwd_ok else 'MISMATCH', fwd_times,
                 times['fwd_eager'], card))
        require(fwd_ok, '%s: K2 disagrees with its plain version' % label)
        return fwd_rec, None

    bwd_bound = bound_ms(4 * nq + 2 * k_rows * row + 2 * nk + b * h * t * 4,
                         2.5 * 4 * live * d, peak)
    bwd_fn = lambda: K.flash_attention_bwd(  # noqa: E731
        q, k, v, out, lse, do, kv, causal)
    times.update(
        bwd_ms=device_ms(torch, bwd_fn, iters=50),
        bwd_eager=eager_ms(torch, bwd_fn, iters=50),
        bwd_plain=device_ms(torch, lambda: K.flash_attention_reference_bwd(
            q, k, v, out, lse, do, kv, causal), iters=10))
    times['bwd_lib'], backend, times['bwd_lib_eager'] = sdpa_bwd_ms(
        torch, q, k, v, do, mask, sdpa_causal)
    print('%s, backward (%s pair) max_abs_err %.3g%s (%s) %s; device ms: %s; '
          'backward kernels %.5f, plain %.5f, SDPA backward %.5f (%s; eager '
          '%.5f), bound %.6f (%s); eager ms: forward %.5f, backward %.5f '
          '[%s]'
          % (fwd_note, 'tensor-core' if variant_bwd == 'mma' else 'SIMT',
             bwd_err, simt_note, tol,
             'ok' if fwd_ok and bwd_ok else 'MISMATCH', fwd_times,
             times['bwd_ms'], times['bwd_plain'], times['bwd_lib'], backend,
             times['bwd_lib_eager'], bwd_bound[0], bwd_bound[1],
             times['fwd_eager'], times['bwd_eager'], card))
    require(fwd_ok, '%s: K2 disagrees with its plain version' % label)
    require(bwd_ok, '%s: K3 disagrees with its plain version' % label)
    bwd_rec = dict(max_abs_err=bwd_err, ms=times['bwd_ms'],
                   plain_ms=times['bwd_plain'], bound_ms=bwd_bound[0],
                   bound_by=bwd_bound[1], library_ms=times['bwd_lib'],
                   eager_ms=times['bwd_eager'], library=backend,
                   library_eager_ms=times['bwd_lib_eager'])
    return fwd_rec, bwd_rec


def _bwd_counts(K):
    return [(w.launches_mma, w.launches_simt)
            for w in (K.flash_bwd_dq_cuda, K.flash_bwd_dkv_cuda)]


def _bwd_moved(K, before):
    """'mma' or 'simt' when each K3 kernel launched twice since ``before``,
    both on that variant; else the counts' moves."""
    moved = [(m - m0, n - n0)
             for (m, n), (m0, n0) in zip(_bwd_counts(K), before)]
    return {(2, 0): 'mma', (0, 2): 'simt'}.get(moved[0], moved) \
        if moved[0] == moved[1] else moved


def _shifted(torch, x):
    """A copy of x that starts one element into its storage: its 16-byte
    loads would be misaligned, so the flash launchers take the SIMT
    kernels."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def sdpa_mask(torch, t, kv, causal, tk=None):
    """SDPA's boolean mask for the flash cases' kv_len and causal band
    (aligned bottom-right, as the port's), or None where ``is_causal``
    alone says it (Tq = Tk, no kv_len). A row with no live key gives NaN
    there: SDPA is a yardstick of time only."""
    tk = t if tk is None else tk
    if kv is None and (not causal or tk == t):
        return None
    dev = kv.device if kv is not None else 'cuda'
    mask = torch.ones(1, 1, t, tk, dtype=torch.bool, device=dev)
    if kv is not None:
        mask = mask & (torch.arange(tk, device=dev)[None, :] <
                       kv[:, None])[:, None, None, :]
    if causal:
        mask = mask & torch.ones(t, tk, dtype=torch.bool,
                                 device=dev).tril(tk - t)
    return mask


def sdpa_bwd_ms(torch, q, k, v, do, mask, is_causal, iters=50):
    """SDPA's backward on these inputs: (device ms a call by CUDA-graph
    replay, as the kernels are timed, the backend's autograd node, eager
    ms), by grad_ms."""
    import torch.nn.functional as F
    return grad_ms(torch, lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, attn_mask=mask, is_causal=is_causal), (q, k, v), do,
        iters=iters)


def flash_shapes(torch):
    """Phase 3's flash-attention cases: (label, B, H, T, D, dtype, causal,
    kv_len or None). The first is the kernels line's."""
    rng = np.random.RandomState(0)
    masked = rng.randint(256, 513, 8)
    masked[-1] = 1
    return [
        ('flash_attention B=64 H=8 T=64 D=64 bf16 encoder (non-causal, '
         'kv_len full)', 64, 8, 64, 64, torch.bfloat16, False, [64] * 64),
        ('flash_attention B=64 H=8 T=64 D=64 bf16 decoder (causal)', 64, 8,
         64, 64, torch.bfloat16, True, None),
        ('flash_attention B=8 H=8 T=512 D=64 bf16 causal, kv_len %d-%d '
         'and one row at 1' % (masked[:-1].min(), masked[:-1].max()), 8, 8,
         512, 64, torch.bfloat16, True, masked.tolist()),
        ('flash_attention B=4 H=4 T=200 D=128 bf16 (non-causal, kv_len '
         '200, 131, 64, 1)', 4, 4, 200, 128, torch.bfloat16, False,
         [200, 131, 64, 1]),
        ('flash_attention B=64 H=8 T=64 D=64 float32 encoder', 64, 8, 64, 64,
         torch.float32, False, [64] * 64),
    ]


def flash_fault_shapes(torch):
    """Phase 3's cases of the inputs the JAX op's default path takes:
    (label, B, H, Tq, Tk, D, dtype, causal, kv_len or None)."""
    return [
        ('flash_attention B=8 H=8 Tq=256 Tk=512 D=64 bf16 causal '
         '(bottom-right: a chunk of queries after a 256-token prefix)', 8, 8,
         256, 512, 64, torch.bfloat16, True, None),
        ('flash_attention B=8 H=8 Tq=512 Tk=256 D=64 bf16 causal (the first '
         '256 rows see no key)', 8, 8, 512, 256, 64, torch.bfloat16, True,
         None),
        ('flash_attention B=8 H=8 T=512 D=64 bf16, kv_len 512, 300 and two '
         'rows at 0', 8, 8, 512, 512, 64, torch.bfloat16, False,
         [512, 300, 0, 512, 0, 512, 512, 512]),
        ('flash_attention B=4 H=8 T=512 D=256 bf16 causal (SIMT, query '
         'tiles of 32 in the backward)', 4, 8, 512, 512, 256,
         torch.bfloat16, True, None),
        ('flash_attention B=4 H=4 T=200 D=192 float32 kv_len 200, 131, 0, '
         '1', 4, 4, 200, 200, 192, torch.float32, False, [200, 131, 0, 1]),
        ('flash_attention B=4 H=4 T=256 D=320 float32 causal (the wide SIMT '
         'kernels: 128-column chunks of the head dim)', 4, 4, 256, 256, 320,
         torch.float32, True, None),
        ('flash_attention B=4 H=4 T=200 D=320 bf16 kv_len 200, 131, 0, 1 '
         '(wide SIMT)', 4, 4, 200, 200, 320, torch.bfloat16, False,
         [200, 131, 0, 1]),
    ]


def decode_flash_shapes(torch):
    """Phase 3's K2 cases at the NMT decode's shapes (phase 12: 64
    sentences x beam 4 = 256 rows, 8 heads of 64): the unrolled decoder's
    causal self-attention over a prefix of t tokens and its
    cross-attention of t queries against the 64 encoder positions with
    kv_len 16-64, fp32 and bf16. (label, B, H, Tq, Tk, D, dtype, causal,
    kv_len or None)."""
    lens = np.random.RandomState(2).randint(16, 65, 256).tolist()
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace('torch.', '')
        for t in (1, 7, 16, 31):
            cases.append(('flash_attention decode B=256 H=8 D=64 %s causal '
                          'Tq=Tk=%d' % (name, t), 256, 8, t, t, 64, dtype,
                          True, None))
            cases.append(('flash_attention decode B=256 H=8 D=64 %s cross '
                          'Tq=%d Tk=64 kv_len %d-%d' % (name, t, min(lens),
                                                        max(lens)),
                          256, 8, t, 64, 64, dtype, False, lens))
    return cases


def phase_flash_kernels(torch, card):
    gen = torch.Generator(device='cuda').manual_seed(1)
    res = []
    for label, b, h, t, d, dtype, causal, lens in flash_shapes(torch):
        res.append(_flash_case(torch, card, label, b, h, t, d, dtype,
                               causal, lens, gen))
        torch.cuda.empty_cache()
    for label, b, h, tq, tk, d, dtype, causal, lens in \
            flash_fault_shapes(torch):
        _flash_case(torch, card, label, b, h, tq, d, dtype, causal, lens,
                    gen, tk=tk)
        torch.cuda.empty_cache()
    for label, b, h, tq, tk, d, dtype, causal, lens in \
            decode_flash_shapes(torch):
        _flash_case(torch, card, label, b, h, tq, d, dtype, causal, lens,
                    gen, tk=tk, backward=False, strided=True)
    torch.cuda.empty_cache()
    return res[0]


def paged_shapes(torch):
    """Phase 3's paged-attention cases: (key, label, page dtype, rows,
    lengths, broadcast table, empty rows). 'prefill512 float32' is the
    kernels line's."""
    decode_lens = [1, 2, 31, 32, 33, 64, 65, 200, 576, 1000, 1500, 2047,
                   2048, 1, 1, 1]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        cases += [
            ('decode ' + name, 'paged_attention decode N=16 H=8 D=64 bs=32 '
             'P=64 NB=4096 lens 1..2048 + 3 empty rows ' + name, dtype, 16,
             decode_lens, False, (13, 14, 15)),
            ('full ' + name, 'paged_attention decode N=16, every row at 2048 '
             'tokens (every split live) ' + name, dtype, 16, [2048] * 16,
             False, ()),
            ('prefill ' + name, 'paged_attention prefill N=128 broadcast '
             'table lens 1..128 ' + name, dtype, 128, list(range(1, 129)),
             True, ()),
            ('prefill512 ' + name, 'paged_attention prefill N=512 broadcast '
             'table lens 1..512 ' + name, dtype, 512, list(range(1, 513)),
             True, ())]
    # the engine run's own decode shape: 16 live rows, lengths across the
    # range its requests reach (prompts 64-512 plus up to 64 new tokens)
    cases.append(('engine', 'paged_attention decode N=16 lens 64..576 (the '
                  'engine run\'s range) float32', torch.float32, 16,
                  np.linspace(64, 576, 16).astype(int).tolist(), False, ()))
    return cases


def paged_q8_shapes():
    """Phase 3's cases of K4's quantized variant, each at int8 and e4m3:
    (key, label, rows, lengths, d_key, k + 1 rows a sequence). 'engine' is
    the kernels line's."""
    engine_lens = np.linspace(64, 576, 16).astype(int).tolist()
    return [
        ('engine', 'decode N=16 lens 64..576 (the engine run\'s range)', 16,
         engine_lens, 64, 0),
        ('full', 'decode N=16, every row at 2048 tokens', 16, [2048] * 16,
         64, 0),
        ('verify', 'verify N=64 (16 sequences x k+1 = 4 rows, lens '
         '64..579, tables repeated a row)', 16, engine_lens, 64, 4),
        ('any', 'any-width kernel, d_key 8 (8-byte rows), N=16 lens '
         '64..576', 16, engine_lens, 8, 0),
    ]


def paged_any_shapes(torch):
    """Phase 3's cases of K4's any-width variant: (label, page dtype, D,
    Dv), each at the decode shape (16 rows, lengths 1..2048, 3 empty)."""
    return [
        ('paged_attention any-width, bf16 d_key 36 (72-byte rows)',
         torch.bfloat16, 36, 36),
        ('paged_attention any-width, fp32 d_key 30 (120-byte rows)',
         torch.float32, 30, 30),
        ('paged_attention any-width, fp32 D = Dv = 192 (768-byte rows)',
         torch.float32, 192, 192),
        ('paged_attention any-width, fp32 D = Dv = 320 (1280-byte rows, '
         'two 256-column chunks)', torch.float32, 320, 320),
        ('paged_attention any-width, bf16 D = Dv = 320', torch.bfloat16, 320,
         320),
    ]


def ln_shapes(torch):
    """Phase 3's layer-norm cases: (rows, d). [16, 512] is decode's (the
    kernels line's forward), [4096, 512] the Transformer training step's
    (the kernels line's backward, fp32: AMP keeps layer_norm fp32)."""
    return [(16, 512), (512, 512), (64, 2048), (4096, 512)]


def phase_kernels(torch, card):
    gen = torch.Generator(device='cuda').manual_seed(0)
    ln = {}
    for n, d in ln_shapes(torch):
        for dtype in (torch.float32, torch.bfloat16):
            ln[(n, d, dtype)] = _ln_case(torch, card, n, d, dtype, gen)
    ln_bwd = {}
    for n, d in ((4096, 512), (16, 512), (64, 2048)):
        for dtype in (torch.float32, torch.bfloat16):
            ln_bwd[(n, d, dtype)] = _ln_bwd_case(torch, card, n, d, dtype,
                                                 gen)
    pa = {}
    for key, label, dtype, n, lens, broadcast, empty in paged_shapes(torch):
        args = _paged_inputs(torch, gen, n, lens, dtype, broadcast,
                             empty=empty)
        pa[key] = _paged_case(torch, card, label, *args, heavy=n >= 512)
        del args
        torch.cuda.empty_cache()
    from paddle_tpu_torch.ops.kernels import paged_attention as K
    decode_lens = paged_shapes(torch)[0][4]
    for label, dtype, d, dv in paged_any_shapes(torch):
        args = _paged_inputs(torch, gen, 16, decode_lens, dtype, False,
                             d=d, dv=dv, empty=(13, 14, 15))
        before = K.paged_attention.launches_any
        _paged_case(torch, card, label, *args)
        require(K.paged_attention.launches_any > before,
                '%s: the any-width kernel did not run' % label)
        del args
        torch.cuda.empty_cache()
    args = _paged_inputs(torch, gen, 16, paged_shapes(torch)[-1][4],
                         torch.float32, False, verify=4)
    pa['verify'] = _paged_case(torch, card, 'paged_attention verify N=64 '
                               '(16 sequences x k+1 = 4 rows, lens 64..579) '
                               'float32', *args)
    del args
    q8 = {}
    for kv_dtype in ('int8', 'float8_e4m3fn'):
        for key, label, n, lens, d, verify in paged_q8_shapes():
            args = _paged_inputs(torch, gen, n, lens, kv_dtype, False, d=d,
                                 verify=verify)
            before = (K.paged_attention.launches_q8,
                      K.paged_attention.launches_v16)
            q8[(kv_dtype, key)] = _paged_case(
                torch, card, 'paged_attention %s %s' % (kv_dtype, label),
                *args)
            require(K.paged_attention.launches_q8 > before[0] and
                    (K.paged_attention.launches_v16 > before[1]) ==
                    (key != 'any'),
                    '%s %s: not the quantized %s kernel' %
                    (kv_dtype, key, 'any-width' if key == 'any'
                     else '16-byte'))
            del args
            torch.cuda.empty_cache()
    _paged_row_independence(torch, card, gen)
    _row_tile_check(torch, card, gen)
    # the fp32 K4 launches without the write on the main path are the
    # prefills' (the steps fold the write in)
    return (ln[(16, 512, torch.float32)], ln_bwd[(4096, 512, torch.float32)],
            pa['prefill512 float32'], q8)


def _bn_case(torch, card, label, x, layout, gen):
    """K5 against its plain version on x: errors of y, mean and var, the
    kernel's device and eager times, its bound, the plain version's time
    and one F.batch_norm call's on the same tensor (never called by the
    port)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import batch_norm as K
    c = x.shape[1] if layout == 'NCHW' else x.shape[-1]
    dev = x.device
    g = 0.5 + torch.rand(c, generator=gen, device=dev)
    b = torch.randn(c, generator=gen, device=dev)
    x4 = x.permute(0, 3, 1, 2) if layout == 'NHWC' else x
    x3 = x4.reshape(x4.shape[0], c, -1) if x.dim() == 4 else x.unsqueeze(-1)

    def kernel():
        return K.fused_batch_norm_train(x, g, b, 1e-5, layout=layout)

    plan = K.launch_plan(x3)
    before = K.fused_batch_norm_train.launches
    y, m, v = kernel()
    again = kernel()
    torch.cuda.synchronize()
    require(K.fused_batch_norm_train.launches == before + 2,
            '%s: %d launches for 2 calls'
            % (label, K.fused_batch_norm_train.launches - before))
    require(all(torch.equal(a, r) for a, r in zip((y, m, v), again)),
            '%s: two runs of K5 differ' % label)
    del again
    ry, rm, rv = K._bn_reference(x3, g, b, 1e-5)
    torch.cuda.synchronize()
    y4 = y.permute(0, 3, 1, 2) if layout == 'NHWC' else y
    y3 = y4.reshape(ry.shape) if x.dim() == 4 else y.unsqueeze(-1)
    err_y = float((y3.float() - ry.float()).abs().max())
    err_m = float((m - rm).abs().max())
    err_v = float((v - rv).abs().max())
    stats_ok = bool(((m - rm).abs() <= 1e-5 + 1e-5 * rm.abs()).all()) and \
        bool(((v - rv).abs() <= 1e-5 + 1e-4 * rv.abs()).all())
    if x.dtype == torch.float32:
        tol = ('fp32: y within 1e-4 + 1e-4*|plain|, mean 1e-5 and var 1e-4 '
               'relative (+1e-5)')
        ok = bool(((y3 - ry).abs() <= 1e-4 + 1e-4 * ry.abs()).all())
    else:
        tol = ('bf16: y within one bf16 ulp each of |x*a|, |b| and |y| (a, '
               'b from statistics 1e-6 apart may round to the neighbouring '
               'bf16 value); mean 1e-5, var 1e-4 relative (+1e-5)')
        a = g * torch.rsqrt(rv + 1e-5)
        bound = (bf16_ulp_t(torch, (x3.float() * a[:, None]).abs()) +
                 bf16_ulp_t(torch, (b - rm * a)[:, None].abs()) +
                 bf16_ulp_t(torch, ry.float().abs()))
        ok = bool(((y3.double() - ry.double()).abs() <= bound).all())
        del a, bound
    del ry, y3, y4
    ok = ok and stats_ok and \
        [st for st, n in zip(y.stride(), y.shape) if n > 1] == \
        [st for st, n in zip(x.stride(), x.shape) if n > 1]
    n = x.numel()
    item = x.element_size()
    lo, by = bound_ms(2 * n * item + 4 * c * 4, 6 * n)
    ms = device_ms(torch, kernel, iters=20)
    eager = eager_ms(torch, kernel, iters=20)
    plain = device_ms(torch, lambda: K._bn_reference(x3, g, b, 1e-5),
                      iters=5)
    xl = x4 if x.dim() == 4 else x
    lib = device_ms(torch, lambda: F.batch_norm(xl, None, None, g, b,
                                                training=True, eps=1e-5),
                    iters=20)
    print('%s: max_abs_err y %.3g, mean %.3g, var %.3g (%s) %s; one launch '
          'of %d blocks (the card holds %d), x %s, two runs bit-equal; '
          'device ms: kernel %.5f, plain %.5f, F.batch_norm %.5f, bound %.6f '
          '(%s); kernel eager %.5f ms [%s]'
          % (label, err_y, err_m, err_v, tol, 'ok' if ok else 'MISMATCH',
             plan['blocks'], plan['card_blocks'],
             'staged on chip (read once)' if plan['on_chip']
             else 'read twice (off chip)', ms, plain, lib, lo, by, eager,
             card))
    require(ok, '%s disagrees with its plain version' % label)
    fwd = dict(max_abs_err=max(err_y, err_m, err_v), ms=ms, plain_ms=plain,
               bound_ms=lo, bound_by=by, library_ms=lib, eager_ms=eager,
               on_chip=bool(plan['on_chip']))
    return fwd, _bn_bwd_case(torch, card, label, x, x3, layout, g, b, gen)


def _bn_bwd_case(torch, card, label, x, x3, layout, g, b, gen):
    """K5's backward kernel against batch_norm_reference_bwd on x (the
    forward's saved statistics, a gradient in x's layout), twice for equal
    bits, one launch a call, and its times beside F.batch_norm's autograd
    backward."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import batch_norm as K
    _, m, v = K._bn_cuda(x3, g, b, 1e-5)
    gy = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    g4 = gy.permute(0, 3, 1, 2) if layout == 'NHWC' else gy
    g3 = g4.reshape(x3.shape) if x.dim() == 4 else gy.unsqueeze(-1)
    plan = K.launch_plan(x3, backward=True)
    before = (K.fused_batch_norm_train.bwd_launches,
              K.fused_batch_norm_train.bwd_gy_copies)
    got = K._bn_bwd_cuda(x3, g3, g, m, v, 1e-5)
    again = K._bn_bwd_cuda(x3, g3, g, m, v, 1e-5)
    torch.cuda.synchronize()
    require((K.fused_batch_norm_train.bwd_launches,
             K.fused_batch_norm_train.bwd_gy_copies) ==
            (before[0] + 2, before[1]),
            '%s backward: want 2 launches and no gradient copy for 2 calls'
            % label)
    require(all(torch.equal(a, r) for a, r in zip(got, again)),
            '%s backward: two runs differ' % label)
    del again
    want = K.batch_norm_reference_bwd(x3, g3, g, m, v, 1e-5)
    errs, ok = grads_ok(torch, got, want, x.dtype)
    del want, got
    n, c = x.numel(), g.shape[0]
    item = x.element_size()
    lo, by = bound_ms(3 * n * item + 5 * c * 4, 11 * n)
    bwd = lambda: K._bn_bwd_cuda(x3, g3, g, m, v, 1e-5)  # noqa: E731
    ms = device_ms(torch, bwd, iters=20)
    eager = eager_ms(torch, bwd, iters=20)
    plain = device_ms(torch, lambda: K.batch_norm_reference_bwd(
        x3, g3, g, m, v, 1e-5), iters=5)
    xl = x.permute(0, 3, 1, 2) if layout == 'NHWC' else x
    gl = gy.permute(0, 3, 1, 2) if layout == 'NHWC' else gy
    lib, node, lib_eager = grad_ms(
        torch, lambda a, w, c_: F.batch_norm(a, None, None, w, c_,
                                             training=True, eps=1e-5),
        (xl, g, b), gl, iters=20)
    print('%s backward: max_abs_err dx %.3g, dscale %.3g, dbias %.3g (%s) '
          '%s; one launch a call, x and gy %s, two runs bit-equal; device '
          'ms: kernel %.5f, plain %.5f, F.batch_norm backward %.5f (%s; '
          'eager %.5f), bound %.6f (%s); kernel eager %.5f ms [%s]'
          % (label, errs[0], errs[1], errs[2], GRAD_TOL,
             'ok' if ok else 'MISMATCH',
             'staged on chip (read once)' if plan['on_chip']
             else 'staged as far as they fit, the rest read twice', ms,
             plain, lib, node, lib_eager, lo, by, eager, card))
    require(ok, '%s backward disagrees with its plain version' % label)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=lib, eager_ms=eager)


def bf16_ulp_t(torch, a):
    """One bf16 ulp (8 significant bits) at |a|, elementwise, float64."""
    a = a.double().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _bn_grad_check(torch, card, gen):
    """K5's autograd Function (the backward kernel) against autograd
    through the plain forward, fp32, at a stage-1 shape: 1e-4."""
    from paddle_tpu_torch.ops.kernels import batch_norm as K
    dev = torch.device('cuda', 0)
    x = torch.randn(16, 56, 56, 64, generator=gen, device=dev)
    s = 0.5 + torch.rand(64, generator=gen, device=dev)
    b = torch.randn(64, generator=gen, device=dev)
    gy = torch.randn(x.shape, generator=gen, device=dev)
    leaves = [t.clone().requires_grad_() for t in (x, s, b)]
    y, _, _ = K.fused_batch_norm_train(*leaves, 1e-5, layout='NHWC')
    got = torch.autograd.grad(y, leaves, gy)
    ref = [t.clone().requires_grad_() for t in (x, s, b)]
    ry, _, _ = K._bn_reference(ref[0].permute(0, 3, 1, 2).reshape(16, 64, -1),
                               ref[1], ref[2], 1e-5)
    want = torch.autograd.grad(ry, ref,
                               gy.permute(0, 3, 1, 2).reshape(16, 64, -1))
    errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
    ok = all(bool(((a - w).abs() <= 1e-4 + 1e-4 * w.abs()).all())
             for a, w in zip(got, want))
    print('batch_norm backward [16, 56, 56, 64] fp32 NHWC vs autograd of the '
          'plain version: max_abs_err dx %.3g, dscale %.3g, dbias %.3g '
          '(1e-4 + 1e-4*|plain|) %s [%s]'
          % (errs[0], errs[1], errs[2], 'ok' if ok else 'MISMATCH', card))
    require(ok, 'batch_norm backward disagrees with autograd of the plain '
            'version')


def write_inputs(torch, gen, kind, kv_dtype, src=None, h=8, d=64, bs=32,
                 p=64, nb=4096):
    """A decode layer's KV write and attention inputs on the card, as the
    decode ops make them (``kind``): 'decode' (16 rows at the engine run's
    positions 64..576, the last 3 empty slots: length 0, every entry >= NB,
    their writes dropped), 'verify' (16 sequences x k+1 = 4 rows at
    64..579) or 'prefill512' (512 rows of one broadcast table row, nothing
    cached: every key a row reads is one this call writes). New rows in
    ``src`` (fp32 by default, the engine's); random arenas (int8 / e4m3
    ones quantized row by row, with their scales); phys, off and keep as
    ops/paged_decode_ops.write_slots computes them (here by hand, so that
    a checkout without it, a parent, takes the same inputs). Returns a
    dict of the tensors."""
    from paddle_tpu_torch.quant.core import quantize_rows
    dev = torch.device('cuda', 0)
    src = torch.float32 if src is None else src
    engine = np.linspace(64, 576, 16).astype(int).tolist()
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    if kind == 'prefill512':
        s = 512
        row = perm[:p].clone()
        row[-(-s // bs):] = nb          # "no page" past the owned pages
        tables = row.expand(s, p)
        pos = torch.arange(s, dtype=torch.int32, device=dev)
        live = torch.ones_like(pos, dtype=torch.bool)
        fresh_lo, fresh_src = torch.zeros_like(pos), torch.zeros_like(pos)
    else:
        k1 = 4 if kind == 'verify' else 1
        tables = perm[:16 * p].reshape(16, p).clone()
        for i, ln in enumerate(engine):
            tables[i, -(-(ln + k1) // bs):] = nb + 7
        lens = list(engine)
        if kind == 'decode':
            for i in (13, 14, 15):
                tables[i], lens[i] = nb, 0
        rep = torch.arange(16, device=dev).repeat_interleave(k1)
        fresh_lo = torch.tensor(lens, dtype=torch.int32, device=dev)[rep]
        pos = fresh_lo + torch.arange(k1, dtype=torch.int32,
                                      device=dev).repeat(16)
        tables = tables[rep].contiguous()
        live = torch.ones_like(pos, dtype=torch.bool)
        fresh_src = (rep * k1).to(torch.int32)
    n = pos.shape[0]
    logical = torch.clamp(pos // bs, 0, p - 1)
    phys = torch.gather(tables, 1, logical[:, None].long())[:, 0] \
        .to(torch.int32).contiguous()
    keep = ((pos < p * bs) & live & (phys >= 0) & (phys < nb)).contiguous()
    t = dict(q=torch.randn(n, h, d, generator=gen, device=dev),
             k_new=(3 * torch.randn(n, h, d, generator=gen,
                                    device=dev)).to(src),
             v_new=torch.randn(n, h, d, generator=gen, device=dev).to(src),
             tables=tables, lens=(pos + 1).contiguous(), phys=phys,
             off=(pos % bs).to(torch.int32).contiguous(), keep=keep,
             fresh_lo=fresh_lo.contiguous(),
             fresh_src=fresh_src.contiguous())
    kf = torch.randn(nb, h, bs, d, generator=gen, device=dev)
    vf = torch.randn(nb, h, bs, d, generator=gen, device=dev)
    if kv_dtype in ('int8', 'float8_e4m3fn'):
        t['kp'], t['ks'] = quantize_rows(kf, kv_dtype)
        t['vp'], t['vs'] = quantize_rows(vf, kv_dtype)
    else:
        dt = getattr(torch, kv_dtype)
        t['kp'], t['vp'], t['ks'], t['vs'] = kf.to(dt), vf.to(dt), None, None
    return t


def _write_args(t, kp=None, vp=None):
    """paged_attention_write's arguments over the given arenas (t's by
    default)."""
    kp = t['kp'] if kp is None else kp
    vp = t['vp'] if vp is None else vp
    return (t['q'], t['k_new'], t['v_new'], kp, vp, t['tables'], t['lens'],
            t['phys'], t['off'], t['keep'], t['fresh_lo'], t['fresh_src'])


def _paged_bytes(kp, vp, tables, lens, quant):
    """K4's least bytes: the pages its rows touch (K and V rows and,
    quantized, their row scales), q, the output, the table entries read
    and the lengths."""
    nb, h, bs, d = kp.shape
    dv = vp.shape[-1]
    n, p = tables.shape
    lens_h = lens.cpu().numpy().astype(np.int64)
    tab_h = tables.cpu().numpy()
    npages = np.minimum(-(-lens_h // bs), p)
    pages = set()
    for i in range(n):
        pages.update(np.clip(tab_h[i, :npages[i]], 0, nb - 1).tolist())
    item = kp.element_size()
    return (len(pages) * h * bs * ((d + dv) * item + (8 if quant else 0)) +
            n * h * (d + dv) * 4 + int(npages.sum()) * 4 + n * 4)


def _kv_write_case(torch, card, label, kv_dtype, gen, n=16, h=8, d=64,
                   nb=4096, bs=32):
    """The KV-write kernel against its plain version, bit for bit, at a
    decode step's rows (16 rows, 13 kept, 3 dropped through entries past
    the pool), and its times."""
    from paddle_tpu_torch.ops.kernels import kv_write as K
    dev = torch.device('cuda', 0)
    dtype = getattr(torch, kv_dtype)
    quant = kv_dtype in ('int8', 'float8_e4m3fn')
    k_new = 3 * torch.randn(n, h, d, generator=gen, device=dev)
    v_new = torch.randn(n, h, d, generator=gen, device=dev)
    slots = torch.randperm(nb * bs, generator=gen, device=dev)[:n]
    phys = (slots // bs).to(torch.int32)
    off = (slots % bs).to(torch.int32)
    phys[-3:] = nb
    keep = phys < nb
    if quant:
        ka = torch.zeros(nb, h, bs, d, dtype=torch.uint8,
                         device=dev).view(dtype)
        scales = [torch.zeros(nb, h, bs, device=dev) for _ in range(2)]
    else:
        ka = torch.zeros(nb, h, bs, d, dtype=dtype, device=dev)
        scales = [None, None]
    va = torch.zeros_like(ka)
    outs = []
    for fn in (K.kv_write_reference, K.kv_write):
        bufs = [ka.clone(), va.clone()] + \
            [x.clone() if x is not None else None for x in scales]
        fn(k_new, v_new, bufs[0], bufs[1], phys, off, keep, *bufs[2:])
        outs.append(bufs)
    torch.cuda.synchronize()

    def raw(t):
        return t.view(torch.uint8) if t.element_size() == 1 else t
    ok = all(torch.equal(raw(a), raw(b)) for a, b in zip(*outs)
             if a is not None)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(*outs) if a is not None)
    del outs
    kept = int(keep.sum())
    item = ka.element_size()
    n_bytes = kept * h * 2 * d * (4 + item) + (kept * h * 2 * 4 if quant
                                               else 0) + n * 9
    lo, by = bound_ms(n_bytes, kept * h * 2 * d * (3 if quant else 1))
    bufs = [ka, va] + scales

    def kernel():
        K.kv_write(k_new, v_new, bufs[0], bufs[1], phys, off, keep,
                   *bufs[2:])
    ms = device_ms(torch, kernel)
    eager = eager_ms(torch, kernel)
    # the plain version picks the kept rows with torch.nonzero, a host
    # read: it cannot be captured, so it is timed eagerly (CUDA events
    # over back-to-back calls)
    plain = eager_ms(torch, lambda: K.kv_write_reference(
        k_new, v_new, bufs[0], bufs[1], phys, off, keep, *bufs[2:]),
        iters=50)
    print('kv_write %s: %d rows (%d kept) x H=%d x D=%d, %s arenas [%d, %d, '
          '%d, %d]: bit for bit with its plain version (quantize_rows and '
          'the masked scatter) %s, max_abs_err %.3g; device ms: kernel %.5f, '
          'plain %.5f (eager: a host read), bound %.6f (%s); kernel eager '
          '%.5f ms; no single PyTorch call writes both arenas with the drop '
          '[%s]' % (label, n, kept, h, d, kv_dtype, nb, h, bs, d,
                    'ok' if ok else 'MISMATCH', err, ms, plain, lo, by,
                    eager, card))
    require(ok, 'kv_write %s disagrees with its plain version' % label)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=None, eager_ms=eager)


def _paged_write_case(torch, card, label, kind, kv_dtype, gen):
    """The KV write folded into K4's split launch against its plain
    versions on one row set, new rows of the arena's dtype: the arenas bit
    for bit with kv_write_reference, the rows that read only kept rows bit
    for bit with the unfused K4 run after that write and within K4's
    tolerances of both plain versions of the whole function
    (kv_write_reference then paged_attention_reference, and the
    kernel-order one); its time beside K4 alone on the same inputs, and
    its bound (K4's bytes and the write's) and the write's own."""
    from paddle_tpu_torch.ops.kernels import paged_attention as K
    t = write_inputs(torch, gen, kind, kv_dtype, src=getattr(torch,
                                                             kv_dtype))

    def arenas():
        return [t['kp'].clone(), t['vp'].clone()]
    want = arenas()
    K.kv_write_reference(t['k_new'], t['v_new'], want[0], want[1],
                         t['phys'], t['off'], t['keep'])
    unfused = K.paged_attention(t['q'], want[0], want[1], t['tables'],
                                t['lens'])
    one_pass = K.paged_attention_reference(
        t['q'], want[0], want[1], t['tables'], t['lens']).float()
    got = arenas()
    f = K.paged_attention
    before = (f.launches, f.launches_write)
    out = K.paged_attention_write(*_write_args(t, *got))
    require((f.launches - before[0], f.launches_write - before[1]) == (1, 1),
            '%s: not one launch that wrote' % label)
    split = K.paged_attention_write_split_reference(
        *_write_args(t, *arenas()))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    # rows whose every fresh position is a kept write (all but the empty
    # slots, whose output no caller reads)
    ok = t['keep'].clone()
    if kind == 'verify':
        ok &= t['keep'].reshape(-1, 4).cumprod(dim=1).bool().reshape(-1)
    bits = bool(torch.equal(out[ok], unfused[ok]))
    errs = [float((out[ok] - r[ok]).abs().max()) for r in (one_pass, split)]
    if kv_dtype == 'float32':
        tol = '5e-5 (fp32)'
        close = all(e <= 5e-5 for e in errs)
    else:
        tol = '2e-2 + 2e-2*|plain| (bf16)'
        close = all(bool(((out[ok] - r[ok]).abs() <=
                          2e-2 + 2e-2 * r[ok].abs()).all())
                    for r in (one_pass, split))
    del want, got, unfused, one_pass, split
    n, h, d = t['q'].shape
    kept = int(t['keep'].sum())
    item = t['kp'].element_size()
    # the write alone: each kept row's K and V read once and written once,
    # and phys, off, keep, fresh_lo and fresh_src read
    w_bytes = kept * h * 2 * d * 2 * item + n * 17
    w_ops = kept * h * 2 * d
    w_lo, _ = bound_ms(w_bytes, w_ops)
    k4_bytes = _paged_bytes(t['kp'], t['vp'], t['tables'], t['lens'], False)
    k4_ops = int(t['lens'].sum()) * h * (4 * d + 5)
    lo, by = bound_ms(k4_bytes + w_bytes, k4_ops + w_ops)
    args = _write_args(t)
    ms = device_ms(torch, lambda: K.paged_attention_write(*args))
    k4 = device_ms(torch, lambda: K.paged_attention(
        t['q'], t['kp'], t['vp'], t['tables'], t['lens']))
    eager = eager_ms(torch, lambda: K.paged_attention_write(*args))
    # the plain version picks the kept rows with torch.nonzero, a host
    # read: it cannot be captured, so it is timed eagerly (CUDA events
    # over back-to-back calls)

    def plain_fn():
        K.kv_write_reference(t['k_new'], t['v_new'], t['kp'], t['vp'],
                             t['phys'], t['off'], t['keep'])
        K.paged_attention_reference(t['q'], t['kp'], t['vp'], t['tables'],
                                    t['lens'])
    plain = eager_ms(torch, plain_fn, iters=20, warmup=2)
    print('paged_attention_write %s: %d rows (%d kept) x H=%d x D=%d, %s '
          'arenas and rows: arenas bit for bit with kv_write_reference %s; '
          'the %d rows that read only kept rows bit for bit with the unfused '
          'K4 after that write %s, max_abs_err %s vs write-then-attend and '
          'the kernel-order plain version (%s) %s; device ms: fused %.5f, K4 '
          'alone %.5f (the write: %+.5f), bound %.6f (%s; the write\'s own '
          '%.6f), plain %.5f (eager: a host read); fused eager %.5f ms; no '
          'single PyTorch call [%s]'
          % (label, n, kept, h, d, kv_dtype, 'ok' if same else 'MISMATCH',
             int(ok.sum()), 'ok' if bits else 'MISMATCH',
             ' / '.join('%.3g' % e for e in errs), tol,
             'ok' if close else 'MISMATCH', ms, k4, ms - k4, lo, by, w_lo,
             plain, eager, card))
    require(same and bits and close,
            '%s disagrees with its plain versions' % label)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=None, eager_ms=eager)


def _keep_mask_case(torch, card, shape, dtype):
    """The keep-mask kernel against its plain version, bit for bit, at a
    dropout of the Transformer's training step, and its times."""
    from paddle_tpu_torch.ops.kernels import random_bits as K
    dev = torch.device('cuda', 0)
    step = torch.tensor(7, dtype=torch.int64, device=dev)
    got = K.keep_mask(shape, 0.9, 0x1234567, step, dev, dtype)
    want = K.keep_mask_reference(shape, 0.9, 0x1234567, step, dev, dtype)
    torch.cuda.synchronize()
    ok = torch.equal(got, want)
    share = float(got.float().mean())
    n = got.numel()
    lo, by = bound_ms(n * got.element_size() + 8, 12 * n)
    ms = device_ms(torch, lambda: K.keep_mask(shape, 0.9, 0x1234567, step,
                                              dev, dtype))
    eager = eager_ms(torch, lambda: K.keep_mask(shape, 0.9, 0x1234567, step,
                                                dev, dtype))
    plain = device_ms(torch, lambda: K.keep_mask_reference(
        shape, 0.9, 0x1234567, step, dev, dtype), iters=20)
    label = 'keep_mask %s %s' % (list(shape), str(dtype)[6:])
    print('%s: bit for bit with its plain version %s (kept share %.5f at '
          'keep 0.9); device ms: kernel %.5f, plain %.5f, bound %.6f (%s); '
          'kernel eager %.5f ms; no single PyTorch call draws these bits '
          '[%s]' % (label, 'ok' if ok else 'MISMATCH', share, ms, plain, lo,
                    by, eager, card))
    require(ok, '%s disagrees with its plain version' % label)
    require(abs(share - 0.9) < 2e-3, '%s keeps %.4f, want ~0.9'
            % (label, share))
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=None, eager_ms=eager)


def _raw_bits(torch, t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int16)


def _dropout_case(torch, card, shape, dtype, mode, backward, gen):
    """The fused dropout kernel (one direction of one mode) against its
    plain version, bit for bit, at a dropout of the Transformer's training
    step (±0, ±inf and NaN among the inputs), and its times beside its
    bound; the library's: F.dropout for the forward (its own bits, time
    only), and for the backward dy * mask, the product the backward ran
    before on the mask autograd saved."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import random_bits as K
    dev = torch.device('cuda', 0)
    step = torch.tensor(7, dtype=torch.int64, device=dev)
    n = int(np.prod(shape))
    x = torch.randn(n, generator=gen, device=dev)
    x[:5] = torch.tensor([0.0, -0.0, float('inf'), -float('inf'),
                          float('nan')], device=dev)
    x = x.to(dtype).reshape(shape)
    key = 0x2468ace
    before = (K.fused_dropout.launches, K.fused_dropout.bwd_launches)
    got = K.fused_dropout(x, mode, 0.9, key, step, backward)
    require((K.fused_dropout.launches - before[0],
             K.fused_dropout.bwd_launches - before[1]) ==
            ((0, 1) if backward else (1, 0)),
            'dropout: one call did not launch its kernel once')
    want = K.dropout_reference(x, mode, 0.9, key, step, backward)
    torch.cuda.synchronize()
    ok = torch.equal(_raw_bits(torch, got), _raw_bits(torch, want))
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = float((got.float() - want.float())[fin].abs().max())
    kept = float((got != 0)[..., 8:].float().mean())
    item = x.element_size()
    lo, by = bound_ms(2 * n * item + 8, 14 * n)
    ms = device_ms(torch, lambda: K.fused_dropout(x, mode, 0.9, key, step,
                                                  backward))
    eager = eager_ms(torch, lambda: K.fused_dropout(x, mode, 0.9, key, step,
                                                    backward))
    plain = device_ms(torch, lambda: K.dropout_reference(
        x, mode, 0.9, key, step, backward), iters=20)
    if backward:
        mask = K.keep_mask_reference(shape, 0.9, key, step, dev, dtype)
        lib = device_ms(torch, lambda: x * mask)
        lib_name = 'dy * mask'
    else:
        lib = device_ms(torch, lambda: F.dropout(x, 0.1, training=True))
        lib_name = 'F.dropout (its own bits)'
    label = 'dropout %s %s %s %s' % ('bwd' if backward else 'fwd', mode,
                                     list(shape), str(dtype)[6:])
    print('%s: bit for bit with its plain version %s (max_abs_err %.3g over '
          'finite values; nonzero share %.5f at keep 0.9); device ms: kernel '
          '%.5f, plain %.5f, %s %.5f, bound %.6f (%s, %.0f %% of it); '
          'kernel eager %.5f ms [%s]'
          % (label, 'ok' if ok else 'MISMATCH', err, kept, ms, plain,
             lib_name, lib, lo, by, 100.0 * lo / ms, eager, card))
    require(ok, '%s disagrees with its plain version' % label)
    require(abs(kept - 0.9) < 2e-3, '%s keeps %.4f, want ~0.9'
            % (label, kept))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=lib, eager_ms=eager)


def phase_step_kernels(torch, card):
    """The captured step's kernels: the stand-alone KV write at the
    decode step's rows (fp32, bf16, int8 and e4m3 arenas) and the 512-row
    prefill's (fp32, int8); the KV write folded into K4's launch at the
    decode step's rows (fp32 and bf16 arenas, rows of their dtype) and the
    verify step's (fp32); the keep mask and the fused dropout (each mode,
    forward and backward) at the Transformer's dropout shapes; returns the
    kernels line's (the int8 decode step's stand-alone write, the fp32
    decode step's folded launch, the FFN's bf16 mask, the FFN's bf16
    dropout forward and backward, mode 'mul')."""
    gen = torch.Generator(device='cuda').manual_seed(5)
    kvw = {}
    for kv_dtype in ('float32', 'bfloat16', 'int8', 'float8_e4m3fn'):
        kvw[kv_dtype] = _kv_write_case(torch, card, 'decode step', kv_dtype,
                                       gen)
    for kv_dtype in ('float32', 'int8'):
        _kv_write_case(torch, card, 'prefill', kv_dtype, gen, n=512)
        torch.cuda.empty_cache()
    fused = {}
    for kind, kv_dtype in (('decode', 'float32'), ('decode', 'bfloat16'),
                           ('verify', 'float32')):
        fused[kind, kv_dtype] = _paged_write_case(
            torch, card, '%s %s' % (kind, kv_dtype), kind, kv_dtype, gen)
        torch.cuda.empty_cache()
    _keep_mask_case(torch, card, (64, 64, 512), torch.bfloat16)
    mask = _keep_mask_case(torch, card, (64, 64, 2048), torch.bfloat16)
    _keep_mask_case(torch, card, (64, 64, 512), torch.bool)
    drop = {}
    # the step's sites: the FFN hidden in bf16 (scan_layers) and fp32 (the
    # unrolled program's bias add), the rest in bf16 and fp32
    for shape, dtype in (((64, 64, 2048), torch.bfloat16),
                         ((64, 64, 2048), torch.float32),
                         ((64, 64, 512), torch.bfloat16),
                         ((64, 64, 512), torch.float32)):
        for mode in ('mul', 'mul_div', 'where_div'):
            for backward in (False, True):
                drop[shape, dtype, mode, backward] = _dropout_case(
                    torch, card, shape, dtype, mode, backward, gen)
        torch.cuda.empty_cache()
    ffn = ((64, 64, 2048), torch.bfloat16, 'mul')
    return (kvw['int8'], fused['decode', 'float32'], mask,
            drop[ffn + (False,)], drop[ffn + (True,)])


# ------------------------------------------------ phase 3: the max pool
def pool_shapes(torch):
    """The max pools of the main paths: (label, x shape, dtype,
    channels-last, ksize, stride, padding, ceil_mode)."""
    return [
        ('ResNet-50 stem [64, 64, 112, 112] bf16 NHWC 3x3/2 pad 1',
         (64, 64, 112, 112), torch.bfloat16, True, 3, 2, 1, False),
        ('ceil / spp-style [64, 64, 112, 112] bf16 3x3/2 ceil',
         (64, 64, 112, 112), torch.bfloat16, False, 3, 2, 0, True),
        ('GoogLeNet stem [64, 64, 112, 112] bf16 3x3/2 -> 55',
         (64, 64, 112, 112), torch.bfloat16, False, 3, 2, 0, False),
        ('GoogLeNet inception [64, 480, 14, 14] bf16 3x3/1 pad 1',
         (64, 480, 14, 14), torch.bfloat16, False, 3, 1, 1, False),
        ('VGG-16 [64, 64, 224, 224] bf16 2x2/2',
         (64, 64, 224, 224), torch.bfloat16, False, 2, 2, 0, False),
        ('vgg_bn_drop [128, 64, 32, 32] fp32 2x2/2',
         (128, 64, 32, 32), torch.float32, False, 2, 2, 0, False),
    ]


def pool_case_inputs(torch, case, gen):
    """x of a pool_shapes case with NaN, ±inf and ties (values on a 1/8
    grid) in its layout, and its geometry ((k, k), (s, s), pad)."""
    _, shape, dtype, cl, k, s, p, ceil = case
    dev = torch.device('cuda', 0)
    x = torch.round(torch.randn(shape, generator=gen, device=dev) * 8) / 8
    u = torch.rand(shape, generator=gen, device=dev)
    x = torch.where(u < 0.01, float('nan'), x)
    x = torch.where((u >= 0.01) & (u < 0.015), float('inf'), x)
    x = torch.where((u >= 0.015) & (u < 0.02), float('-inf'), x).to(dtype)
    if cl:
        x = x.contiguous(memory_format=torch.channels_last)
    h, w = shape[2:]
    eh = -(h + 2 * p - k) % s if ceil else 0
    ew = -(w + 2 * p - k) % s if ceil else 0
    return x, ((k, k), (s, s), (p, p + ew, p, p + eh))


def torch_pool_args(geo, size):
    """(padding, ceil_mode) with which one F.max_pool2d call computes the
    pool of an x of ``size`` (h, w) with geometry ``geo``, else None: the
    same top and left padding within torch's k // 2, and torch's output
    extents (ceil_mode's included) the pool's, so the right and bottom
    padding the windows reach is torch's too."""
    (kh, kw), (sh, sw), (left, right, top, bottom) = geo
    if top > kh // 2 or left > kw // 2:
        return None

    def torch_out(n, k, s, p, ceil):
        # torch's pooling_output_shape at dilation 1
        out = (n + 2 * p - k + (s - 1 if ceil else 0)) // s + 1
        if ceil and (out - 1) * s >= n + p:
            out -= 1
        return out
    want = ((size[0] + top + bottom - kh) // sh + 1,
            (size[1] + left + right - kw) // sw + 1)
    for ceil in (False, True):
        if (torch_out(size[0], kh, sh, top, ceil),
                torch_out(size[1], kw, sw, left, ceil)) == want:
            return (top, left), ceil
    return None


def torch_pool_fwd(torch, x, geo):
    """torch's own forward of the same pool: one F.max_pool2d call where
    torch's padding reaches (torch_pool_args), else F.max_pool2d after
    F.pad (the port's forward before the max pool had a kernel of its
    own)."""
    F = torch.nn.functional
    (k, _), (s, _), pad = geo
    args = torch_pool_args(geo, tuple(x.shape[2:]))
    if args is not None:
        return F.max_pool2d(x, k, s, args[0], ceil_mode=args[1])
    return F.max_pool2d(F.pad(x, pad, value=float('-inf')), k, s)


def same_bits(torch, a, b):
    """a and b NaN at the same places and bit for bit elsewhere (the sign
    of a zero included)."""
    iv = torch.int16 if a.element_size() == 2 else torch.int32
    return (a.shape == b.shape and a.dtype == b.dtype and
            torch.equal(a.isnan(), b.isnan()) and
            torch.equal(torch.where(a.isnan(), 0, a).view(iv),
                        torch.where(b.isnan(), 0, b).view(iv)))


def _nan_err(torch, a, b):
    """The largest |a - b|, 0 where both are NaN or equal (±inf)."""
    d = (a.float() - b.float()).abs()
    d = torch.where((a.isnan() & b.isnan()) | (a == b), 0.0, d)
    return float(d.max())


def _max_pool_case(torch, card, case, gen):
    """max_pool_fwd and max_pool_bwd against their plain versions on x
    with NaN, ±inf, ±0 and ties: y bit for bit (NaN at the same places,
    the sign of a zero max the reference's), equal to F.max_pool2d's (by
    value: torch keeps the first of -0 and +0), the picks equal; dx from
    the kernel's picks twice bit for bit, equal to the plain version in
    x's dtype where windows do not overlap, within one ulp of its fp32
    sums where they do; each half's time beside its bound and torch's
    call (one F.max_pool2d, ceil_mode where it gives the pool, else after
    F.pad; max_pool2d_with_indices_backward, which sends a NaN window's
    gradient to the NaN, on the same inputs made finite)."""
    from paddle_tpu_torch.ops.kernels import max_pool as K
    label, shape = case[:2]
    x, geo = pool_case_inputs(torch, case, gen)
    (k, _), (s, _), pad = geo
    size = tuple(shape[2:])
    f0, b0 = K.max_pool_fwd.launches, K.max_pool_bwd.launches
    y, pick = K.max_pool_fwd(x, *geo)
    y2, pick2 = K.max_pool_fwd(x, *geo)
    y3, none = K.max_pool_fwd(x, *geo, picks=False)
    want_y, want_pick = K.max_pool_fwd_reference(x, *geo)
    y_err = max(_nan_err(torch, y, want_y), _nan_err(torch, y2, want_y),
                _nan_err(torch, y3, want_y))
    y_bits = all(same_bits(torch, a, want_y) for a in (y, y2, y3))
    lib_y = torch_pool_fwd(torch, x, geo)
    fwd_ok = (y_err == 0.0 and y_bits and none is None and
              torch.equal(pick, want_pick) and torch.equal(pick, pick2) and
              _nan_err(torch, y, lib_y) == 0.0)
    dy = torch.randn(y.shape, generator=gen, device=x.device) \
        .to(x.dtype).contiguous(memory_format=K.memory_format(x))
    fmt = K.memory_format(x)
    got = K.max_pool_bwd(pick, dy, *geo, size, fmt)
    again = K.max_pool_bwd(pick, dy, *geo, size, fmt)
    require(K.max_pool_fwd.launches == f0 + 3 and
            K.max_pool_bwd.launches == b0 + 2,
            '%s: the kernels were not counted once a call' % label)
    want = K.max_pool_bwd_reference(want_pick, dy, *geo, size)
    want32 = K.max_pool_bwd_reference(want_pick, dy.float(), *geo, size)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    err = float((got.float() - want.float()).abs().max())
    if s >= k:
        bwd_ok = torch.equal(got, want)
    else:
        ulp = bf16_ulp_t(torch, want32.abs()) if x.dtype == torch.bfloat16 \
            else want32.double().abs() * 2.0 ** -22
        bwd_ok = bool(((got.double() - want32.double()).abs() <= ulp).all())
    e, b = x.element_size(), pick.element_size()
    n_x, n_y = x.numel(), y.numel()
    f_lo, f_by = bound_ms(n_x * e + n_y * (e + b), k * k * n_y)
    b_lo, b_by = bound_ms(n_y * (b + e) + n_x * e, k * k * n_y)
    pair_lo, _ = bound_ms(2 * (n_x + n_y) * e, 2 * k * k * n_y)
    f_ms = device_ms(torch, lambda: K.max_pool_fwd(x, *geo))
    b_ms = device_ms(torch, lambda: K.max_pool_bwd(pick, dy, *geo, size,
                                                   fmt))
    f_plain = device_ms(torch, lambda: K.max_pool_fwd_reference(x, *geo),
                        iters=10)
    b_plain = device_ms(torch, lambda: K.max_pool_bwd_reference(
        want_pick, dy, *geo, size), iters=10)
    f_lib = device_ms(torch, lambda: torch_pool_fwd(torch, x, geo))
    b_lib = None
    args = torch_pool_args(geo, size)
    if args is not None:
        finite = torch.nan_to_num(x, nan=0.0)
        _, idx = torch.nn.functional.max_pool2d(
            finite, k, s, args[0], ceil_mode=args[1], return_indices=True)
        b_lib = device_ms(torch, lambda: torch.ops.aten.
                          max_pool2d_with_indices_backward(
                              dy, finite, [k, k], [s, s], list(args[0]),
                              [1, 1], args[1], idx))
    print('max_pool %s: forward: y %s its plain version (bit for bit %s) '
          'and torch\'s, the picks %s; device ms: kernel %.5f, bound %.5f '
          '(%s), plain %.5f, F.max_pool2d%s %.5f [%s]'
          % (label, 'equal to' if y_err == 0.0 else 'MISMATCHES',
             'ok' if y_bits else 'MISMATCH', 'equal'
             if fwd_ok else 'MISMATCH', f_ms, f_lo, f_by, f_plain,
             ' + F.pad' if args is None else
             ' (ceil_mode)' if args[1] else '', f_lib, card))
    print('max_pool %s: backward from the picks: twice bit for bit %s; %s '
          'its plain version (largest difference %.3g) %s; device ms: '
          'kernel %.5f, bound %.5f (%s), plain %.5f, torch\'s '
          'max_pool2d backward %s; the pair %.5f against its bound %.5f '
          '(x + y + dy + dx) and torch\'s %s [%s]'
          % (label, 'ok' if same else 'MISMATCH',
             'equal to' if s >= k else 'within an ulp of the fp32 sums of',
             err, 'ok' if bwd_ok else 'MISMATCH', b_ms, b_lo, b_by, b_plain,
             '%.5f' % b_lib if b_lib is not None else 'n/a (padding past '
             'torch\'s)', f_ms + b_ms, pair_lo,
             '%.5f' % (f_lib + b_lib) if b_lib is not None else 'n/a', card))
    require(fwd_ok, '%s: max_pool_fwd disagrees with its plain version, '
            'with itself or with F.max_pool2d' % label)
    require(same and bwd_ok, '%s: max_pool_bwd disagrees with its plain '
            'version or with itself' % label)
    return (dict(max_abs_err=y_err, ms=f_ms, plain_ms=f_plain, bound_ms=f_lo,
                 bound_by=f_by, library_ms=f_lib),
            dict(max_abs_err=err, ms=b_ms, plain_ms=b_plain, bound_ms=b_lo,
                 bound_by=b_by, library_ms=b_lib))


def phase_pool_kernels(torch, card):
    """max_pool_fwd and max_pool_bwd at the main paths' pools; returns
    ResNet-50's stem pool's numbers of each (the kernels line's)."""
    gen = torch.Generator(device='cuda').manual_seed(23)
    rows = []
    for case in pool_shapes(torch):
        rows.append(_max_pool_case(torch, card, case, gen))
        torch.cuda.empty_cache()
    return rows[0]


# ------------------------------------------------------ phase 3: sparse_rows
CTR_SLOTS = 26
CTR_ROWS = 1000000
CTR_BATCH = 4096
CTR_DIMS = (16, 1)        # the deep tables' width, the wide tables'
SPARSE_KINDS = ('sgd', 'adagrad', 'momentum', 'adam')


def zipf_ids(rng, shape, rows, a=1.1):
    """Ids drawn from a Zipf(a) law folded onto ``rows`` table rows: CTR
    traffic's heavy head (the top id is ~9 % of a slot's ids at a = 1.1),
    so a batch repeats ids."""
    return ((rng.zipf(a, shape) - 1) % rows).astype('int64')


def _sparse_tables(torch, S, kind, shapes, gen, rng):
    """SparseTables on the card, one a (rows, dim, n) of ``shapes``: a
    table, its accumulators, n Zipf ids (each table its own draw) and
    gradient rows."""
    dev = torch.device('cuda', 0)
    out = []
    for rows, dim, n in shapes:
        out.append(S.SparseTable(
            torch.randn(rows, dim, generator=gen, device=dev),
            torch.randn(n, dim, generator=gen, device=dev),
            torch.from_numpy(zipf_ids(rng, n, rows)).to(dev),
            [torch.rand(rows, dim, generator=gen, device=dev)
             for _ in range(S.N_STATE[kind])],
            [torch.tensor([0.9 ** 5], device=dev),
             torch.tensor([0.999 ** 5], device=dev)] if kind == 'adam'
            else []))
    return out


def _copies(tables):
    return [t._replace(param=t.param.clone(),
                       state=tuple(s.clone() for s in t.state))
            for t in tables]


def _sparse_case(torch, card, label, kind, shapes, launches, gen, rng,
                 host=False):
    """The grouped row-sparse kernel against its plain version, bit for
    bit, on ``shapes`` (Zipf ids), in ``launches`` launches, and its times
    beside its bound; for sgd also index_add_ on each table (the same
    update as atomic scatter-adds) as the library's time; with ``host``
    the plain version on the host too."""
    from paddle_tpu_torch.ops.kernels import sparse_rows as S
    dev = torch.device('cuda', 0)
    tables = _sparse_tables(torch, S, kind, shapes, gen, rng)
    lr = torch.tensor([0.05], device=dev)
    outs, plain = [], None
    for fn in (S.sparse_rows_grouped_reference, S.sparse_rows_grouped):
        got = _copies(tables)
        before = (S.sparse_rows.launches, S.sparse_rows.tables)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(kind, got, lr)
        t1.record()
        torch.cuda.synchronize()
        if fn is S.sparse_rows_grouped_reference:
            # one call, timed with events (it reads each run's length on
            # the host)
            plain = t0.elapsed_time(t1)
        else:
            require((S.sparse_rows.launches - before[0],
                     S.sparse_rows.tables - before[1]) ==
                    (launches, len(shapes)), '%s: %d launches for %d '
                    'tables, want %d' % (label, S.sparse_rows.launches -
                                         before[0], len(shapes), launches))
        outs.append(got)
    ok = all(torch.equal(a.param, b.param) and
             all(torch.equal(x, y) for x, y in zip(a.state, b.state))
             for a, b in zip(*outs))
    err = max(float((a.param - b.param).abs().max()) for a, b in zip(*outs))
    host_ok = None
    if host:
        # every operation correctly rounded on both sides: the same bits
        cpu = [t._replace(param=t.param.cpu(), rows=t.rows.cpu(),
                          ids=t.ids.cpu(),
                          state=tuple(x.cpu() for x in t.state),
                          beta_pows=tuple(x.cpu() for x in t.beta_pows))
               for t in tables]
        S.sparse_rows_grouped_reference(kind, cpu, lr.cpu())
        host_ok = all(torch.equal(a.param.cpu(), b.param) and
                      all(torch.equal(x.cpu(), y)
                          for x, y in zip(a.state, b.state))
                      for a, b in zip(outs[1], cpu))
        del cpu
    del outs
    uniq = [int(torch.unique(t.ids).numel()) for t in tables]
    longest = max(int(torch.bincount(t.ids).max()) for t in tables)
    # each input read once, each output written once: the ids, the rows,
    # and the touched rows of each table and of its accumulators read and
    # written
    n_bytes = sum(8 * n + 4 * n * dim + 2 * 4 * u * dim *
                  (1 + S.N_STATE[kind])
                  for (_, dim, n), u in zip(shapes, uniq))
    n_ops = sum(n * dim * 3 + u * dim * 12
                for (_, dim, n), u in zip(shapes, uniq))
    lo, by = bound_ms(n_bytes, n_ops)
    ms = device_ms(torch, lambda: S.sparse_rows_grouped(kind, tables, lr))
    eager = eager_ms(torch, lambda: S.sparse_rows_grouped(kind, tables,
                                                          lr))
    lib = None
    if kind == 'sgd':
        def index_add():
            for t in tables:
                t.param.index_add_(0, t.ids, t.rows, alpha=-0.05)
        lib = device_ms(torch, index_add)
    print('sparse_rows %s %s: %d table(s) (%s) fp32, %d ids (%d-%d '
          'distinct a table, longest run %d), %d launch(es): bit for bit '
          'with its plain version %s, max_abs_err %.3g; device ms: kernel '
          '%.5f, plain %.5f (one eager call: host reads), bound %.6f (%s), '
          '%s; kernel eager %.5f ms%s [%s]'
          % (label, kind, len(shapes),
             ', '.join(sorted({'[%d, %d]' % (r, d) for r, d, _ in shapes})),
             sum(n for _, _, n in shapes), min(uniq), max(uniq), longest,
             launches, 'ok' if ok else 'MISMATCH', err, ms, plain, lo, by,
             'index_add_ on each table %.5f' % lib if lib is not None else
             'no single PyTorch call', eager,
             '' if host_ok is None else '; the plain version on the host: '
             'bit for bit %s' % ('ok' if host_ok else 'MISMATCH'), card))
    require(ok and host_ok is not False, 'sparse_rows %s %s disagrees with '
            'its plain version' % (label, kind))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=lo,
                bound_by=by, library_ms=lib, eager_ms=eager)


def phase_sparse_kernels(torch, card):
    """The row-sparse update kernel at Wide&Deep's full width for each
    optimizer: one table of 1,000,000 rows at dim 16 and at dim 1 (4,096
    Zipf ids; checked on the host too), the step's group of 52 tables (26
    of each width, one launch) and the large-n variant (two tables of
    65,536 ids: a sort on the device, then the presorted launch). Returns
    {(label, kind): numbers}; the kernels line's entry is ('group', 'sgd')."""
    gen = torch.Generator(device='cuda').manual_seed(15)
    rng = np.random.RandomState(15)
    group = [(CTR_ROWS, dim, CTR_BATCH) for dim in CTR_DIMS] * CTR_SLOTS
    cases = [('one table dim %d' % dim, [(CTR_ROWS, dim, CTR_BATCH)], 1,
              True) for dim in CTR_DIMS]
    cases += [('group', group, 1, False),
              ('large-n', [(CTR_ROWS, dim, 16 * CTR_BATCH)
                           for dim in CTR_DIMS], 1, False)]
    res = {}
    for label, shapes, launches, host in cases:
        for kind in SPARSE_KINDS:
            res[(label, kind)] = _sparse_case(torch, card, label, kind,
                                              shapes, launches, gen, rng,
                                              host)
            torch.cuda.empty_cache()
    return res


def phase_bn_kernels(torch, card):
    """K5 at ResNet-50's shapes (batch 64, 224x224: the stem, stage 1's
    64-channel, stage 2's and stage 4's widest), NCHW, fp32 and an odd
    shape, each staged on chip or read twice as its plan says (checked:
    both happen in both orders), and the backward kernel at each; returns
    the stem's numbers (forward, backward)."""
    gen = torch.Generator(device='cuda').manual_seed(3)
    dev = torch.device('cuda', 0)
    res = []
    for label, shape, dtype, layout, on_chip in bn_shapes(torch):
        x = (1.0 + 2.0 * torch.randn(shape, generator=gen, device=dev)) \
            .to(dtype)
        res.append(_bn_case(torch, card, label, x, layout, gen))
        staged = res[-1][0].pop('on_chip')
        require(staged == on_chip, '%s: x staged on chip is %s, want %s'
                % (label, staged, on_chip))
        del x
        torch.cuda.empty_cache()
    _bn_grad_check(torch, card, gen)
    return res[0]


def bn_shapes(torch):
    """Phase 3's batch-norm cases: (label, shape, dtype, layout, x staged
    on chip). The first is the kernels line's."""
    return [
        ('batch_norm [802816, 64] bf16 NHWC (stem)', (64, 112, 112, 64),
         torch.bfloat16, 'NHWC', False),
        ('batch_norm [200704, 64] bf16 NHWC', (64, 56, 56, 64),
         torch.bfloat16, 'NHWC', True),
        ('batch_norm [50176, 512] bf16 NHWC', (64, 28, 28, 512),
         torch.bfloat16, 'NHWC', False),
        ('batch_norm [3136, 2048] bf16 NHWC', (64, 7, 7, 2048),
         torch.bfloat16, 'NHWC', True),
        ('batch_norm [64, 128, 28, 28] bf16 NCHW', (64, 128, 28, 28),
         torch.bfloat16, 'NCHW', True),
        ('batch_norm [64, 256, 56, 56] bf16 NCHW', (64, 256, 56, 56),
         torch.bfloat16, 'NCHW', False),
        ('batch_norm [200704, 256] fp32 NHWC', (64, 56, 56, 256),
         torch.float32, 'NHWC', False),
        ('batch_norm [1003, 100] fp32 (odd shape)', (1003, 100),
         torch.float32, 'NC', True),
    ]


# ------------------------------------------------------------ phase 4
def _requests(spec, n, plen_lo, plen_hi, max_new, seed=1234):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.randint(plen_lo, plen_hi + 1))
        sampled = i % 8 == 7            # 4 of 32 at temperature 0.7
        reqs.append(dict(prompt_ids=rng.randint(0, spec.vocab_size,
                                                plen).tolist(),
                         max_new_tokens=max_new,
                         temperature=0.7 if sampled else 0.0,
                         seed=1000 + i))
    return reqs


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else float('nan')


def _decode_job(eng, spec, steps=20, k=0, mode='captured'):
    """--profile job: a decode step (``k`` = 0) or a verify step of k + 1
    tokens a row with every batch slot busy (lengths from 300), run on this
    thread through the shut-down engine's programs (``mode``: how that
    engine runs them). Returns (label, step, steps, release)."""
    mb, pps, bs = eng.max_batch, eng.pages_per_seq, eng.block_size
    rng = np.random.RandomState(7)
    need = -(-(300 + 2 * steps + k + 8) // bs)
    tables = np.full((mb, pps), eng.num_blocks, 'int32')
    for i in range(mb):
        tables[i, :need] = eng.pool.alloc(need)
    state = {'tokens': rng.randint(0, spec.vocab_size, mb).astype('int64'),
             'lens': np.full((mb,), 300, 'int32')}
    drafts = rng.randint(0, spec.vocab_size, (mb, k)).astype('int64')
    zf, zi = np.zeros((mb,), 'float32'), np.zeros((mb,), 'int32')

    def step():
        if k:
            tokens = np.concatenate([state['tokens'][:, None], drafts], 1)
            nxt = eng._run_verify(tokens, state['lens'], tables, zf, zi)
            nxt = nxt[:, 0]
        else:
            nxt = eng._run_decode(state['tokens'], state['lens'], tables,
                                  zf, zi)
        state['tokens'] = nxt.astype('int64')
        state['lens'] = state['lens'] + 1

    def release():
        for i in range(mb):
            eng.pool.free(tables[i, :need].tolist())
        require(eng.free_pages() == eng.num_blocks,
                'pages leaked after the decode profile')

    what = 'verify steps (k+1 = %d tokens a row)' % (k + 1) if k else \
        'decode steps'
    return ('%d %s x %d rows, %s arenas (lengths 300..%d), %s'
            % (steps, what, mb, eng.kv_dtype, 300 + 3 + 2 * steps, mode),
            step, steps, release)


def _family(name):
    low = name.lower()
    if 'ptt::flash' in low:
        return 'flash attention (K2, K3)'
    if 'ptt::paged' in low:
        return 'paged attention (K4)'
    if 'ptt::ln_bwd' in low:
        return 'layer norm backward (K1 backward)'
    if 'ptt::ln_' in low:
        return 'layer norm (K1)'
    if 'ptt::bn_bwd' in low:
        return 'batch norm backward (K5 backward)'
    if 'ptt::bn_' in low:
        return 'batch norm (K5)'
    if 'ptt::sparse_rows' in low:
        return 'row-sparse update (sparse_rows)'
    if any(w in low for w in ('fprop', 'dgrad', 'wgrad', 'conv', 'cudnn',
                              'implicit')):
        return 'convolution (cuDNN)'
    if any(w in low for w in ('gemm', 'gemv', 'xmma', 'nvjet', 'cutlass')):
        return 'matmul (cuBLAS)'
    if any(w in low for w in ('topk', 'sort', 'radix', 'kthvalue')):
        return 'top-k and sort'
    if 'copy' in low or 'cast' in low:
        return 'copies and casts'
    return 'other elementwise / reductions'


# record_function ranges: the executor's two of a training step, and the
# incremental decode's one-query attention (ops/transformer_ops.py). On
# the device timeline of an eager run each is one annotation span, which
# is not a kernel; a graph replay has none
SECTIONS = ('forward', 'optimizer', 'one_query_attention')
# autograd nodes whose device time (their kernels') the profile reports
NODES = ('_BatchNormTrainBackward', '_LayerNormBackward')


def profile_steps(torch, card, jobs):
    """--profile: for each job (label, step, steps, release), the wall
    time a step without the profiler — every job's before any profiler
    starts, because CUPTI stays attached to the process afterwards and
    slows what follows — then, under torch.profiler, the device busy
    time and share, device time by kernel family and by kernel, and host
    time by op, a step. Returns each job's {family: (launches, us)} over
    its profiled steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _, step, steps, _ in jobs:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    out = []
    for (label, step, steps, release), wall_ms in zip(jobs, walls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        kernels, host, families = {}, {}, {}
        spans, timed = {}, []
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            if e.name in SECTIONS:
                spans.setdefault(e.name, []).append(
                    (e.time_range.start, e.time_range.end))
                continue
            t = e.time_range.end - e.time_range.start
            timed.append((e.time_range.start, t))
            for table, key in ((kernels, e.name),
                               (families, _family(e.name))):
                c, total = table.get(key, (0, 0.0))
                table[key] = (c + 1, total + t)
        busy = sum(t for _, t in timed)
        # a kernel belongs to the section whose span holds its start; the
        # backward is what no span holds
        sections = {k: sum(t for s0, t in timed
                           if any(a <= s0 < b for a, b in spans[k]))
                    for k in SECTIONS if k in spans}
        if 'forward' in sections:
            sections['backward'] = busy - sum(sections.values())
        for a in prof.key_averages():
            if a.device_type == DeviceType.CPU and a.self_cpu_time_total > 0:
                host[a.key] = (a.count, a.self_cpu_time_total)
            if a.key in NODES:
                sections[a.key] = a.device_time_total
        busy_ms = busy / steps / 1e3
        # host launches: kernels (plain and cooperative) and CUDA graphs
        launches = sum(c for k, (c, _) in host.items()
                       if k.startswith('cudaLaunchKernel') or
                       k.startswith('cudaLaunchCooperativeKernel'))
        graphs = sum(c for k, (c, _) in host.items()
                     if k.startswith('cudaGraphLaunch'))
        copies = sum(c for k, (c, _) in kernels.items()
                     if 'direct_copy' in k)
        print('profile: %s: wall %.3f ms/step (no profiler), device busy '
              '%.3f ms/step, busy share %.3f; host launches/step: %.1f '
              'kernels + %.1f graphs; device kernels/step %.1f, %.1f of them '
              'direct_copy [%s]'
              % (label, wall_ms, busy_ms, busy_ms / wall_ms,
                 launches / steps, graphs / steps, len(timed) / steps,
                 copies / steps, card))
        if sections:
            print('  device time by section (us/step): %s'
                  % ', '.join('%s %.1f' % (k, t / steps)
                              for k, t in sections.items()))
        for title, table, n in (('family', families, 9),
                                ('device', kernels, 12)):
            for name, (c, t) in sorted(table.items(),
                                       key=lambda kv: -kv[1][1])[:n]:
                print('  %s %9.1f us/step %7.1f launches/step  %s'
                      % (title, t / steps, c / steps, name[:90]))
        for name, (c, t) in sorted(host.items(),
                                   key=lambda kv: -kv[1][1])[:12]:
            print('  host   %9.1f us/step %7.1f calls/step     %s'
                  % (t / steps, c / steps, name[:90]))
        if release is not None:
            release()
        out.append(families)
    return out


_WEIGHTS = {}


def lm_weights(spec):
    """random_weights(spec, seed 0), made once a spec and shared by every
    engine of the run."""
    from paddle_tpu_torch.serving.decode import random_weights
    key = tuple(sorted(vars(spec).items()))
    if key not in _WEIGHTS:
        _WEIGHTS[key] = random_weights(spec, seed=0)
    return _WEIGHTS[key]


def eager_engine(eng):
    """An engine whose programs run eagerly: its executor's run with
    use_program_cache=False (the comparison of phase 11)."""
    import functools
    eng._exe.run = functools.partial(type(eng._exe).run, eng._exe,
                                     use_program_cache=False)
    return eng


def _check_replays(eng, label):
    """After warmup, every shape the engine serves (each prompt bucket,
    the decode step and, with speculation, the verify step) runs as a
    replay of its graph: last_captured, and no capture."""
    nb, mb, pps = eng.num_blocks, eng.max_batch, eng.pages_per_seq
    captures = eng.captures
    idle = (np.zeros((mb,), 'int32'), np.full((mb, pps), nb, 'int32'),
            np.zeros((mb,), 'float32'), np.zeros((mb,), 'int32'))
    runs = [('prefill %d' % b, lambda b=b: eng._run_prefill(
        np.zeros((1, b), 'int64'), 1, 0, np.full((1, pps), nb, 'int32'),
        0.0, 0)) for b in eng.prompt_buckets]
    runs.append(('decode', lambda: eng._run_decode(
        np.zeros((mb,), 'int64'), *idle)))
    if eng.spec_k:
        runs.append(('verify', lambda: eng._run_verify(
            np.zeros((mb, eng.spec_k + 1), 'int64'), *idle)))
    for what, run in runs:
        run()
        require(eng._exe.last_captured, '%s: the %s step after warmup ran '
                'eagerly' % (label, what))
    require(eng.captures == captures, '%s: a step after warmup captured'
            % label)
    print('%s: after warmup, %d shapes (%s) each ran as a replay of its '
          'graph' % (label, len(runs), ', '.join(w for w, _ in runs)))


def phase_engine(torch, spec, engine_kw, reqs, place, card, on_card,
                 label='engine', alone=4, eager=False):
    """One engine run: build, warmup, ``reqs`` from 16 submitter threads
    with every launch count at 0 just before; checks and prints; then
    ``alone`` greedy streams re-run alone. On the card the engine's steps
    are CUDA graphs that warmup() captured, one a shape, and the run
    captures nothing more; ``eager`` runs every step eagerly instead.
    Returns (results, launches, engine, stats)."""
    from paddle_tpu_torch.serving.decode import DecodeEngine
    t0 = time.perf_counter()
    eng = DecodeEngine(spec, place=place, weights=lm_weights(spec),
                       **engine_kw)
    if eager:
        eager_engine(eng)
    t1 = time.perf_counter()
    n_shapes = eng.warmup()
    captured = on_card and not eager
    captures = eng.captures
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    print('%s: built + weights %.2f s, warmup %.2f s (%d shapes, %d CUDA '
          'graphs captured), kv %s %d B/token, %d pages x %d, prefix cache '
          '%s, spec_k %d, place %r, %s' % (
              label, t1 - t0, t2 - t1, n_shapes, captures, eng.kv_dtype,
              eng.kv_bytes_per_token, eng.num_blocks, eng.block_size,
              eng.prefix_cache is not None, eng.spec_k, eng.place,
              'captured' if captured else 'eager'))
    require(captures == (n_shapes if captured else 0),
            '%s: warmup captured %d graphs for %d shapes'
            % (label, captures, n_shapes))
    if captured:
        _check_replays(eng, label)
    eng.start()

    n_threads = 16
    results = [None] * len(reqs)
    reasons = [None] * len(reqs)
    ttft, gaps, errors = [], [], []
    mu = threading.Lock()

    def client(k):
        try:
            for i in range(k, len(reqs), n_threads):
                t_sub = time.perf_counter()
                stream = eng.submit(**reqs[i])
                toks, last = [], None
                for tok in stream:
                    now = time.perf_counter()
                    with mu:
                        if last is None:
                            ttft.append(now - t_sub)
                        else:
                            gaps.append(now - last)
                    last = now
                    toks.append(tok)
                results[i] = stream.result(timeout=60)
                reasons[i] = stream.finish_reason
                if toks != results[i]:
                    raise AssertionError('request %d: streamed tokens '
                                         'differ from its result' % i)
        except Exception as e:  # reported and failed below
            with mu:
                errors.append(repr(e))

    # the main path's run: every launch counter starts at 0 here
    reset_launches()
    steps0 = (eng.prefills, eng.decode_steps, eng.verify_steps)
    t_run = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    require(not any(t.is_alive() for t in threads),
            '%s: submitter threads still running after 600 s' % label)
    require(eng.drain(60), '%s: engine did not drain' % label)
    wall = time.perf_counter() - t_run
    launches = read_launches()
    steps = [b - a for a, b in zip(steps0, (eng.prefills, eng.decode_steps,
                                            eng.verify_steps))]
    runs = sum(steps)
    require(not errors, '%s: client errors: %s' % (label, errors[:3]))
    require(eng.captures == captures, '%s: %d captures during serving'
            % (label, eng.captures - captures))
    require(all(r is not None and len(r) == q['max_new_tokens']
                for r, q in zip(results, reqs)),
            '%s: a stream did not complete with max_new_tokens tokens'
            % label)
    require(all(r == 'max_tokens' for r in reasons),
            '%s: finish reasons %s' % (label, sorted(set(map(str, reasons)))))
    cache = eng.prefix_cache
    held = cache.cached_pages() if cache is not None else 0
    require(eng.free_pages() + held == eng.num_blocks,
            '%s: pages not reclaimed after drain: %d free + %d cached of %d'
            % (label, eng.free_pages(), held, eng.num_blocks))
    n_tok = sum(len(r) for r in results)
    layers = spec.n_layer
    stats = dict(tokens_per_s=n_tok / wall, ttft_p50_ms=1e3 * _pct(ttft, 50),
                 itl_p50_ms=1e3 * _pct(gaps, 50),
                 itl_p99_ms=1e3 * _pct(gaps, 99), steps=steps)
    print('%s run: %d requests, %d tokens in %.3f s: %.1f tokens/s; '
          'TTFT p50 %.1f ms; inter-token p50 %.2f ms p99 %.2f ms; '
          '%d prefills + %d decode steps + %d verify steps; %d preemptions; '
          'resident peak %d [%s]'
          % (label, len(reqs), n_tok, wall, stats['tokens_per_s'],
             stats['ttft_p50_ms'], stats['itl_p50_ms'], stats['itl_p99_ms'],
             steps[0], steps[1], steps[2], eng.preemptions,
             eng.resident_seqs_peak, card))
    if cache is not None:
        prompt_tokens = sum(len(q['prompt_ids']) for q in reqs)
        stats.update(hit_rate=cache.hit_rate(), hits=cache.hits,
                     tokens_skipped=cache.tokens_reused)
        print('%s prefix cache: hit rate %.3f (%d hits, %d misses), %d '
              'prefill tokens skipped of %d prompt tokens, %d pages cached, '
              '%d evictions' % (label, cache.hit_rate(), cache.hits,
                                cache.misses, cache.tokens_reused,
                                prompt_tokens, held, cache.evictions))
    if eng.spec_k:
        stats.update(accepted=eng.spec_accepted, spec_rows=eng.spec_rows,
                     mean_accepted=eng.spec_accepted / max(eng.spec_rows, 1))
        print('%s speculation: k %d, %d verify steps, %d rows verified, %d '
              'drafts proposed, %d accepted, mean accepted length %.3f'
              % (label, eng.spec_k, steps[2], eng.spec_rows,
                 eng.spec_drafted, eng.spec_accepted,
                 stats['mean_accepted']))
    q8 = launches['paged_attention_q8']
    wrote = launches['paged_attention_write']
    # the decode and verify steps fold the write into K4's launch on fp32
    # arenas (the LM's rows are fp32); the prefills, and every op on the
    # arenas that convert, launch the stand-alone write
    folds = layers * (steps[1] + steps[2]) if eng.kv_dtype == 'float32' \
        else 0
    print('launches in the run: layer_norm %d (= 2*%d*%d runs: %s), '
          'paged_attention %d (= %d*%d runs: %s), quantized %d, with the KV '
          'write folded in %d (want %d), stand-alone KV write %d (want %d)'
          % (launches['layer_norm'], layers, runs,
             launches['layer_norm'] == 2 * layers * runs,
             launches['paged_attention'], layers, runs,
             launches['paged_attention'] == layers * runs, q8, wrote, folds,
             launches['kv_write'], layers * runs - folds))
    if on_card:
        print('max_memory_allocated: %.3f GB [%s]'
              % (torch.cuda.max_memory_allocated() / 1e9, card))
        require(launches['layer_norm'] > 0 and
                launches['paged_attention'] > 0,
                '%s: a kernel of the path was never launched: %s'
                % (label, launches))
        require(launches['layer_norm'] == 2 * layers * runs and
                launches['paged_attention'] == layers * runs and
                wrote == folds and
                launches['kv_write'] == layers * runs - folds,
                '%s: launch counts %s do not match %d prefills + decode '
                'and verify steps, each layer\'s KV write folded into its '
                'paged-attention launch on the %d decode and verify layers '
                'that fold and stand-alone on the others'
                % (label, launches, runs, folds))
        quantized = eng.kv_dtype in ('int8', 'float8_e4m3fn')
        require(q8 == (layers * runs if quantized else 0),
                '%s: %d quantized paged-attention launches, want %d'
                % (label, q8, layers * runs if quantized else 0))

    greedy = [i for i, q in enumerate(reqs) if q['temperature'] == 0.0]
    for i in greedy[:alone]:
        got = eng.generate(timeout=120, **reqs[i])
        require(got == results[i],
                '%s: request %d: alone %s != concurrent %s'
                % (label, i, got[:8], results[i][:8]))
    if alone:
        print('%s: %d greedy streams re-run alone equal their concurrent '
              'runs' % (label, alone))
    require(eng.captures == captures, '%s: %d captures after warmup'
            % (label, eng.captures - captures))
    eng.shutdown()
    require(eng.free_pages() == eng.num_blocks,
            '%s: pages leaked after shutdown' % label)
    return results, launches, eng, stats


def _shared_requests(spec, n, sys_len, suffix, cold, max_new, seed=4321):
    """The prefix cache's traffic: each request shares one ``sys_len``-token
    system prompt followed by a random suffix of ``suffix`` = (lo, hi)
    tokens, with probability 0.95; the others are cold prompts of ``cold``
    = (lo, hi) tokens. One in 8 samples at temperature 0.7."""
    rng = np.random.RandomState(seed)
    system = rng.randint(0, spec.vocab_size, sys_len).tolist()
    reqs, n_shared = [], 0
    for i in range(n):
        if rng.rand() < 0.95:
            n_shared += 1
            tail = rng.randint(0, spec.vocab_size,
                               int(rng.randint(suffix[0], suffix[1] + 1)))
            prompt = system + tail.tolist()
        else:
            prompt = rng.randint(0, spec.vocab_size,
                                 int(rng.randint(cold[0], cold[1] + 1))) \
                .tolist()
        reqs.append(dict(prompt_ids=prompt, max_new_tokens=max_new,
                         temperature=0.7 if i % 8 == 7 else 0.0,
                         seed=2000 + i))
    print('shared-prefix traffic: %d of %d requests share the %d-token '
          'system prompt' % (n_shared, n, sys_len))
    return reqs


def phase_extras(torch, spec, engine_kw, reqs, place, card, on_card):
    """The decode extras at the same width: shared-prefix traffic served
    by the plain engine, then with prefix_cache=True and spec_k=3; every
    stream must be equal between the two, the cache must hit and drafts
    be accepted. Returns both runs' launch counts, the second run's
    engine and its stats."""
    plain, first, eng, base = phase_engine(torch, spec, engine_kw, reqs,
                                           place, card, on_card,
                                           label='extras plain', alone=0)
    del eng
    got, launches, eng, stats = phase_engine(
        torch, spec, dict(engine_kw, prefix_cache=True, spec_k=3), reqs,
        place, card, on_card, label='extras cache+spec', alone=0)
    diff = [i for i, (a, b) in enumerate(zip(plain, got)) if a != b]
    require(not diff, 'extras: streams %s differ with the prefix cache and '
            'speculation on (first: %s vs %s)'
            % (diff[:5], got[diff[0]][:8] if diff else None,
               plain[diff[0]][:8] if diff else None))
    require(stats['hits'] > 0, 'extras: the prefix cache never hit')
    require(stats['accepted'] > 0, 'extras: no draft was accepted')
    print('extras: %d streams equal with and without cache + speculation; '
          'tokens/s %.1f -> %.1f, TTFT p50 %.1f -> %.1f ms, inter-token '
          'p50 %.2f -> %.2f ms, p99 %.2f -> %.2f ms [%s]'
          % (len(got), base['tokens_per_s'], stats['tokens_per_s'],
             base['ttft_p50_ms'], stats['ttft_p50_ms'], base['itl_p50_ms'],
             stats['itl_p50_ms'], base['itl_p99_ms'], stats['itl_p99_ms'],
             card))
    return [first, launches], eng, stats


def phase_quantized(torch, spec, engine_kw, reqs, place, card, on_card,
                    kv_dtype, n_new):
    """The same traffic at quantized arenas, with the prefix cache and
    spec_k=3: the run's checks (4 greedy streams alone equal their
    concurrent runs, every K4 launch on the quantized variant), then the
    same engine on the host equal to the card. Returns (launches, engine,
    stats, results)."""
    kw = dict(engine_kw, prefix_cache=True, spec_k=3, kv_dtype=kv_dtype)
    results, launches, eng, stats = phase_engine(
        torch, spec, kw, reqs, place, card, on_card,
        label='quantized %s' % kv_dtype)
    print('quantized %s: kv %d B/token, %.1f tokens/s [%s]'
          % (kv_dtype, eng.kv_bytes_per_token, stats['tokens_per_s'], card))
    phase_cpu_compare(spec, reqs, results, engine_kw['block_size'], n_new,
                      dict(prefix_cache=True, spec_k=3, kv_dtype=kv_dtype))
    return launches, eng, stats, results


# ------------------------------------------------------------ phase 5
def phase_cpu_compare(spec, reqs, results, block_size, n_new,
                      engine_kw=None):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving.decode import DecodeEngine
    greedy = [i for i, q in enumerate(reqs) if q['temperature'] == 0.0]
    pick = sorted(greedy, key=lambda i: len(reqs[i]['prompt_ids']))[:2]
    longest = max(len(reqs[i]['prompt_ids']) for i in pick) + n_new
    pages = -(-longest // block_size)
    t0 = time.perf_counter()
    eng = DecodeEngine(spec, max_batch=2, block_size=block_size,
                       num_blocks=4 * pages, pages_per_seq=pages,
                       place=pt.CPUPlace(),
                       weights=lm_weights(spec), **(engine_kw or {}))
    eng.start()
    streams = [eng.submit(reqs[i]['prompt_ids'], max_new_tokens=n_new)
               for i in pick]
    got = [s.result(timeout=600) for s in streams]
    eng.shutdown()
    for i, g in zip(pick, got):
        require(g == results[i][:n_new],
                'request %d: CPU %s != first run %s'
                % (i, g, results[i][:n_new]))
    print('CPUPlace engine (plain versions, %s): %d prompts x %d greedy '
          'tokens equal the card run\'s streams (%.1f s)'
          % (engine_kw or 'plain', len(pick), n_new,
             time.perf_counter() - t0))


# ------------------------------------------------------- phases 6-8
def _build_train(pt, vocab, seq, dropout, amp, lr=1e-4, **dims):
    """bench_transformer's graph through the port's user API, on the
    default programs: transformer_base + Adam(lr).minimize, amp set on
    the main program."""
    from paddle_tpu_torch.models import transformer as T
    pt.reset_default_programs()
    avg_cost, _ = T.transformer_base(
        src_vocab_size=vocab, trg_vocab_size=vocab, src_seq_len=seq,
        trg_seq_len=seq, max_length=max(256, seq), dropout_rate=dropout,
        **dims)
    pt.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    pt.default_main_program().amp = amp
    return avg_cost


def _train_steps(torch, exe, feed, avg_cost, n, on_card):
    """n steps; returns (seconds, losses as floats)."""
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [exe.run(feed=feed, fetch_list=[avg_cost], return_numpy=False)[0]
           for _ in range(n)]
    if on_card:
        torch.cuda.synchronize()
    return time.perf_counter() - t0, [float(v.float()) for v in out]


def flash_want(layers, steps):
    """The flash kernels' launches in ``steps`` Transformer training steps:
    3 attentions a layer, each one forward and one of each backward kernel,
    all on their tensor-core variants."""
    n = 3 * layers * steps
    want = {}
    for name in VARIANTS:
        want.update({name: n, name + '_mma': n, name + '_simt': 0})
    return want


def train_want(layers, steps):
    """The kernels' launches in ``steps`` Transformer training steps at
    dropout > 0: the flash kernels' (flash_want), 5 layer norms a layer
    and their backward (2 kernels each), and the fused dropout forward
    and backward at every site (4 an encoder layer, 6 a decoder layer and
    the 2 embeddings), with no keep mask written."""
    want = flash_want(layers, steps)
    want['layer_norm'] = 5 * layers * steps
    want['layer_norm_bwd'] = 2 * 5 * layers * steps
    sites = (4 + 6) * layers + 2
    want.update(dropout=sites * steps, dropout_bwd=sites * steps,
                keep_mask=0)
    return want


def phase_train(torch, pt, place, card, on_card, batch, seq, vocab, dims,
                warmup=3, steps=20, label='train'):
    """Phase 6 (and 6b, with scan_layers in ``dims``): bench_transformer
    through the port; returns the launch counts of the timed steps, a
    --profile job of 5 more steps and (ms a step, tokens/s, MFU)."""
    from paddle_tpu_torch.models import transformer as T
    t0 = time.perf_counter()
    avg_cost = _build_train(pt, vocab, seq, 0.1, 'bf16', **dims)
    n_params = sum(int(np.prod(p.shape))
                   for p in pt.default_main_program().all_parameters())
    exe = pt.Executor(place)
    scope = pt.Scope()
    program = pt.default_main_program()
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        feed = {n: torch.as_tensor(v).to(exe.device) for n, v in
                T.make_fake_batch(batch, seq, seq, vocab, vocab,
                                  seed=0).items()}
        base = 0
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        _, first = _train_steps(torch, exe, feed, avg_cost, warmup, on_card)
        reset_launches()
        secs, losses = _train_steps(torch, exe, feed, avg_cost, steps,
                                    on_card)
        launches = read_launches()

    def profile_step():
        with pt.scope_guard(scope):
            exe.run(program, feed=feed, fetch_list=[avg_cost],
                    return_numpy=False)

    losses = first + losses
    ms = secs * 1e3 / steps
    tok_s = batch * seq / secs * steps
    flops = T.train_step_flops(batch, seq, seq, vocab,
                               n_layer=dims.get('n_layer', 6),
                               n_head=dims.get('n_head', 8),
                               d_key=dims.get('d_key', 64),
                               d_model=dims.get('d_model', 512),
                               d_inner=dims.get('d_inner', 2048))
    layers = dims.get('n_layer', 6)
    want = train_want(layers, steps)
    mfu = flops / (ms / 1e3) / BF16_FLOPS
    print('%s: transformer_base vocab %d, %d params, batch %d x seq %d, '
          'amp bf16, dropout 0.1, Adam(1e-4), scan_layers %s; build + '
          'startup %.2f s; place %r' % (label, vocab, n_params, batch, seq,
                                        bool(dims.get('scan_layers')),
                                        t1 - t0, place))
    print('%s: %d timed steps after %d warm-up: %.3f ms/step, %.1f '
          'tokens/s, analytic %.4g TFLOP/step, MFU %.4f of %g TFLOP/s; loss '
          'first %.5f last %.5f [%s]'
          % (label, steps, warmup, ms, tok_s, flops / 1e12, mfu,
             BF16_FLOPS / 1e12, losses[0], losses[-1], card))
    print('%s: launches in the %d timed steps: %s (want %s: per layer '
          'and step, 3 of each flash kernel, every one through its '
          'tensor-core variant, 5 layer norms and their backward, 2 kernels '
          'each; per step, a fused dropout forward and backward at each of '
          'the %d sites and no keep mask)'
          % (label, steps, {k: launches[k] for k in want}, want,
             10 * layers + 2))
    require(np.isfinite(losses).all(), 'training loss not finite: %s'
            % losses)
    require(losses[-1] < losses[0], 'training loss did not fall: %s'
            % losses)
    if on_card:
        peak = torch.cuda.max_memory_allocated()
        print('%s: max_memory_allocated %.3f GB, %.3f GB above what was '
              'allocated before the first step [%s]'
              % (label, peak / 1e9, (peak - base) / 1e9, card))
        require(all(launches[k] == n for k, n in want.items()),
                '%s launch counts %s, want %s' % (label, launches, want))
    return launches, ('5 %s steps' % label, profile_step, 5, None), \
        (ms, tok_s, mfu)


def phase_train_masked(torch, pt, place, card, on_card, batch, seq, vocab,
                       dims, warmup=3, steps=10):
    """Phase 7: bench_transformer_masked's shape; returns the launch
    counts of the timed steps."""
    from paddle_tpu_torch.models import transformer as T
    avg_cost = _build_train(pt, vocab, seq, 0.1, 'bf16', **dims)
    rng = np.random.RandomState(0)
    feed = T.make_fake_batch(batch, seq, seq, vocab, vocab)
    lens = rng.randint(seq // 2, seq + 1, (batch,)).astype('int64')
    feed['src_length'] = lens
    feed['lbl_weight'] = (np.arange(seq)[None, :] <
                          lens[:, None]).astype('float32')
    exe = pt.Executor(place)
    with pt.scope_guard(pt.Scope()):
        exe.run(pt.default_startup_program())
        feed = {n: torch.as_tensor(v).to(exe.device) for n, v in feed.items()}
        _, first = _train_steps(torch, exe, feed, avg_cost, warmup, on_card)
        reset_launches()
        secs, losses = _train_steps(torch, exe, feed, avg_cost, steps,
                                    on_card)
        launches = read_launches()
    losses = first + losses
    print('train masked: batch %d x seq %d, src_length %d-%d (mean %.1f), '
          '%d timed steps: %.3f ms/step, padded %.1f tokens/s, real %.1f '
          'tokens/s; loss first %.5f last %.5f [%s]'
          % (batch, seq, lens.min(), lens.max(), lens.mean(), steps,
             secs * 1e3 / steps, batch * seq * steps / secs,
             float(lens.sum()) * steps / secs, losses[0], losses[-1], card))
    require(np.isfinite(losses).all(), 'masked loss not finite: %s' % losses)
    if on_card:
        want = train_want(dims.get('n_layer', 6), steps)
        require(all(launches[k] == n for k, n in want.items()),
                'masked training launch counts %s, want %s'
                % (launches, want))
    return launches


def phase_dropout_mask(torch, pt, place, card, on_card, batch=4096,
                       d_model=512, d_inner=2048, steps=5):
    """Phase 7b: a program that reads the dropout op's Mask (the one path
    that still writes a mask): the Transformer's FFN at its width, x
    [batch, d_model] -> fc(d_inner, relu) -> dropout(0.1) -> fc(d_model)
    -> mean under Adam, bf16 AMP, Mask fetched each step. Checks, over
    ``steps`` steps after 3 warm-up, one keep_mask, one dropout and one
    dropout_bwd launch a step, and the last step's Mask: the keep bits of
    (seed, step, op) at the step set by exe.set_step, about 0.9 kept.
    Returns the launch counts of the timed steps."""
    from paddle_tpu_torch.core.registry import op_key
    from paddle_tpu_torch.ops.kernels import random_bits as K
    pt.reset_default_programs()
    main = pt.default_main_program()
    main.random_seed = 11
    x = pt.layers.data(name='x', shape=[d_model], dtype='float32')
    h = pt.layers.fc(input=x, size=d_inner, act='relu')
    h = pt.layers.dropout(h, dropout_prob=0.1)
    op = main.global_block().ops[-1]
    cost = pt.layers.mean(pt.layers.fc(input=h, size=d_model))
    pt.optimizer.Adam(learning_rate=1e-4).minimize(cost)
    main.amp = 'bf16'
    index = main.global_block().ops.index(op)
    exe = pt.Executor(place)
    feed = {'x': torch.from_numpy(np.random.RandomState(0).randn(
        batch, d_model).astype('f')).to(exe.device)}
    fetch = [cost, op.output('Mask')]
    with pt.scope_guard(pt.Scope()):
        exe.run(pt.default_startup_program())
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=fetch, return_numpy=False)
        reset_launches()
        _sync(torch, on_card)
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            exe.run(main, feed=feed, fetch_list=fetch, return_numpy=False)
        exe.set_step(100)
        loss, mask = exe.run(main, feed=feed, fetch_list=fetch,
                             return_numpy=False)
        _sync(torch, on_card)
        secs = time.perf_counter() - t0
        launches = read_launches()
    want = K.keep_mask_reference((batch, d_inner), 0.9,
                                 op_key(main.random_seed, index),
                                 torch.tensor(100), torch.device('cpu'),
                                 torch.float32)
    same = torch.equal(mask.float().cpu(), want)
    share = float(mask.float().mean())
    per_step = {k: launches[k] / steps for k in ('keep_mask', 'dropout',
                                                 'dropout_bwd')}
    print('phase 7b dropout with its Mask read: FFN [%d, %d], amp bf16, '
          'Adam, %d steps: %.3f ms/step; launches a step %s; the Mask of '
          'step 100 (%s) equals its keep bits %s, kept share %.5f; loss '
          '%.5f [%s]'
          % (batch, d_inner, steps, secs * 1e3 / steps, per_step,
             str(mask.dtype)[6:], same, share, float(loss.float()), card))
    require(same and abs(share - 0.9) < (2e-3 if on_card else 0.05),
            'phase 7b: the fetched Mask is not the keep bits of its step')
    require(np.isfinite(float(loss.float())), 'phase 7b: loss not finite')
    if on_card:
        require(per_step == {'keep_mask': 1, 'dropout': 1, 'dropout_bwd': 1},
                'phase 7b launches a step %s, want 1 each' % per_step)
    return launches


def phase_train_compare(torch, pt, places, vocab, dims, lr=1e-4, steps=3):
    """Phase 8: the same Program, fp32, no dropout, no amp, 3 Adam steps
    from the same weights on each place."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.weights import load_into_scope
    t0 = time.perf_counter()
    avg_cost = _build_train(pt, vocab, 64, 0.0, None, lr=lr, **dims)
    main = pt.default_main_program()
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    feed = T.make_fake_batch(2, 64, 64, vocab, vocab, seed=0)
    losses, scopes = [], []
    for place in places:
        scope = pt.Scope()
        load_into_scope(weights, scope, place)
        exe = pt.Executor(place)
        with pt.scope_guard(scope):
            losses.append([float(exe.run(main, feed=feed,
                                         fetch_list=[avg_cost])[0])
                           for _ in range(steps)])
        scopes.append(scope)
    names = [p.name for p in main.all_parameters() if p.trainable]
    gap = max(float(np.max(np.abs(scopes[0].numpy(n) - scopes[1].numpy(n))))
              for n in names)
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    print('train %r vs %r: batch 2 x seq 64, fp32, dropout 0, %d Adam steps '
          'from the same weights: losses %s vs %s (max rel %.3g, limit '
          '1e-4); max |param gap| %.3g over %d params (limit 2*lr*steps = '
          '%.3g) (%.1f s)'
          % (places[0], places[1], steps, ['%.6f' % v for v in losses[0]],
             ['%.6f' % v for v in losses[1]], rel, gap, len(names),
             2 * lr * steps, time.perf_counter() - t0))
    require(rel <= 1e-4, 'training losses differ across places')
    require(gap <= 2 * lr * steps, 'parameters differ across places')


def phase_scan_compare(torch, pt, place, card, vocab, dims, lr=1e-4,
                       steps=3):
    """Phase 6b's second half: phase 8's program (batch 2 x seq 64, fp32,
    no amp) with scan_layers=True from phase 8's unrolled weights stacked
    by stack_trained_weights: 3 Adam steps within 1e-5 relative of the
    unrolled program's; then at dropout 0.1, 3 captured steps equal 3
    eager steps bit for bit (losses and every scope variable)."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.weights import load_into_scope
    t0 = time.perf_counter()
    progs = {}
    for scan in (True, False):
        avg = _build_train(pt, vocab, 64, 0.0, None, lr=lr, scan_layers=scan,
                           **dims)
        progs[scan] = (pt.default_main_program(), avg,
                       pt.default_startup_program())
    host = pt.Scope()
    with pt.scope_guard(host):
        hexe = pt.Executor(pt.CPUPlace())
        # the scan program's own state (the stacked names' moments), then
        # the unrolled weights, stacked
        hexe.run(progs[True][2])
        hexe.run(progs[False][2])
    names = T.stack_trained_weights(host, dims.get('n_layer', 6))
    weights = {n: host.numpy(n) for n in host.keys()}
    feed = T.make_fake_batch(2, 64, 64, vocab, vocab, seed=0)
    losses = {}
    for scan, (main, avg, _) in progs.items():
        scope = pt.Scope()
        load_into_scope(weights, scope, place)
        exe = pt.Executor(place)
        with pt.scope_guard(scope):
            losses[scan] = [float(exe.run(main, feed=feed,
                                          fetch_list=[avg])[0])
                            for _ in range(steps)]
        del exe, scope
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                  losses[False]))
    avg = _build_train(pt, vocab, 64, 0.1, None, lr=lr, scan_layers=True,
                       **dims)
    res = _three_ways(torch, pt, place, pt.default_main_program(), avg,
                      weights, feed, modes=('captured', 'eager'))
    same = bool(np.array_equal(res['captured'][0], res['eager'][0])) and \
        all(np.array_equal(res['eager'][1][n], v)
            for n, v in res['captured'][1].items())
    print('phase 6b compare: batch 2 x seq 64, fp32, dropout 0, %d Adam '
          'steps from the same weights (%d stacked by stack_trained_weights):'
          ' scan_layers losses %s, unrolled %s (max rel %.3g, limit 1e-5); '
          'dropout 0.1: captured %s, eager %s, bit for bit in the losses and '
          '%d scope variables: %s (%.1f s) [%s]'
          % (steps, len(names), ['%.7f' % v for v in losses[True]],
             ['%.7f' % v for v in losses[False]], rel,
             ['%.7f' % v for v in res['captured'][0]],
             ['%.7f' % v for v in res['eager'][0]], len(res['captured'][1]),
             same, time.perf_counter() - t0, card))
    require(np.isfinite(losses[True]).all(), 'scan_layers losses not finite')
    require(rel <= 1e-5, 'scan_layers losses differ from the unrolled ones')
    require(same, 'captured scan_layers steps differ from eager')


# ------------------------------------------------------- phases 9-10
def _build_resnet(pt, image, class_dim, layout, amp, lr, small=False):
    """ResNet-50 (or, for the rehearsal, the tests' small bottleneck net)
    through the port's user API on the default programs:
    resnet50_with_loss + Momentum(lr, 0.9).minimize, amp on the main
    program."""
    from paddle_tpu_torch.models import resnet as R
    pt.reset_default_programs()
    if small:
        img = pt.layers.data(name='image', shape=[3, image, image],
                             dtype='float32')
        label = pt.layers.data(name='label', shape=[1], dtype='int64')
        h = pt.layers.transpose(img, [0, 2, 3, 1]) if layout == 'NHWC' \
            else img
        h = R.conv_bn_layer(h, 16, 3, 1, 1, data_format=layout)
        h = pt.layers.pool2d(h, pool_size=3, pool_type='max', pool_stride=2,
                             pool_padding=1, data_format=layout)
        h = R.layer_warp(R.bottleneck, h, 8, 2, 1, data_format=layout)
        h = R.layer_warp(R.bottleneck, h, 16, 2, 2, data_format=layout)
        h = pt.layers.pool2d(h, pool_type='avg', global_pooling=True,
                             data_format=layout)
        avg_cost = pt.layers.mean(pt.layers.cross_entropy(
            pt.layers.fc(h, size=class_dim, act='softmax'), label))
    else:
        _, avg_cost, _ = R.resnet50_with_loss(
            image_shape=(3, image, image), class_dim=class_dim,
            data_format=layout)
    pt.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(avg_cost)
    pt.default_main_program().amp = amp
    return avg_cost


def _running_stats(program):
    return [v.name for v in program.list_vars() if v.persistable and
            (v.name.endswith('.mean') or v.name.endswith('.variance'))]


def phase_resnet(torch, pt, place, card, on_card, batch, image, class_dim,
                 small=False, warmup=3, steps=20):
    """Phase 9: bench.py's bench_resnet50 through the port (batch 64,
    224x224, 1000 classes, NHWC, Momentum(0.1, 0.9), amp bf16); returns
    the launch counts of the timed steps and a --profile job of 5 more
    steps."""
    from paddle_tpu_torch.models import resnet as R
    t0 = time.perf_counter()
    avg_cost = _build_resnet(pt, image, class_dim, 'NHWC', 'bf16', 0.1,
                             small=small)
    program = pt.default_main_program()
    n_params = sum(int(np.prod(p.shape)) for p in program.all_parameters())
    n_bn = sum(op.type == 'batch_norm' for op in program.global_block().ops)
    flops = 3 * 2 * R.forward_macs_per_image(program) * batch
    stats = _running_stats(program)
    exe = pt.Executor(place)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        before = {n: scope.numpy(n) for n in stats}
        feed = {n: torch.as_tensor(v).to(exe.device) for n, v in
                R.make_fake_batch(batch, image, class_dim, seed=0).items()}
        base = 0
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        _, first = _train_steps(torch, exe, feed, avg_cost, warmup, on_card)
        reset_launches()
        secs, losses = _train_steps(torch, exe, feed, avg_cost, steps,
                                    on_card)
        launches = read_launches()
        after = {n: scope.numpy(n) for n in stats}

    def profile_step():
        with pt.scope_guard(scope):
            exe.run(program, feed=feed, fetch_list=[avg_cost],
                    return_numpy=False)

    losses = first + losses
    ms = secs * 1e3 / steps
    moved = sum(not np.array_equal(before[n], after[n]) for n in stats)
    finite = all(np.isfinite(after[n]).all() for n in stats)
    print('resnet: %s, batch %d x 3 x %d x %d, %d classes, NHWC, amp bf16, '
          'Momentum(0.1, 0.9); %d params, %d batch norms; build + startup '
          '%.2f s; place %r; torch.backends.cudnn.benchmark=%s'
          % ('small bottleneck net' if small else 'ResNet-50', batch, image,
             image, class_dim, n_params, n_bn, t1 - t0, place,
             torch.backends.cudnn.benchmark))
    print('resnet: %d timed steps after %d warm-up: %.3f ms/step, %.1f '
          'images/s, %.4g TFLOP/step (conv + fc, 3x forward), MFU %.4f of %g '
          'TFLOP/s; loss first %.5f last %.5f; %d of %d running statistics '
          'moved, all finite: %s [%s]'
          % (steps, warmup, ms, batch * steps / secs, flops / 1e12,
             flops / (ms / 1e3) / BF16_FLOPS, BF16_FLOPS / 1e12, losses[0],
             losses[-1], moved, len(stats), finite, card))
    print('resnet: batch_norm launches in the %d timed steps: forward %d, '
          'backward %d (want %d each = %d a step); gradients copied into '
          'x\'s layout first: %d; max pool forward %d, backward %d (want %d '
          'each)'
          % (steps, launches['batch_norm'], launches['batch_norm_bwd'],
             n_bn * steps, n_bn, launches['batch_norm_bwd_gy_copies'],
             launches['max_pool_fwd'], launches['max_pool_bwd'],
             MAX_POOLS_A_STEP['resnet'] * steps))
    require(np.isfinite(losses).all(), 'resnet loss not finite: %s' % losses)
    require(losses[-1] < losses[0], 'resnet loss did not fall: %s' % losses)
    require(finite and moved == len(stats),
            'running statistics: %d of %d moved, finite %s'
            % (moved, len(stats), finite))
    if on_card:
        peak = torch.cuda.max_memory_allocated()
        print('resnet: max_memory_allocated %.3f GB, %.3f GB above what was '
              'allocated before the first step [%s]'
              % (peak / 1e9, (peak - base) / 1e9, card))
        require(launches['batch_norm'] == n_bn * steps and
                launches['batch_norm_bwd'] == n_bn * steps,
                'resnet batch_norm launches %d forward, %d backward, want %d'
                % (launches['batch_norm'], launches['batch_norm_bwd'],
                   n_bn * steps))
        if not small:
            require(max_pools(program) == MAX_POOLS_A_STEP['resnet'],
                    'resnet: %d max pools' % max_pools(program))
            require_pools(launches, steps, MAX_POOLS_A_STEP['resnet'],
                          'resnet')
    return launches, ('5 ResNet-50 training steps', profile_step, 5, None)


def phase_resnet_compare(torch, pt, places, lr=0.01, steps=3):
    """Phase 10: ResNet-50 at 32x32, batch 8, 10 classes, NCHW, fp32,
    Momentum(lr) for 3 steps from the same startup weights on each place.
    The first step is the one a tolerance can hold: its loss within 1e-3
    relative, the running statistics it leaves within 1e-3 of their
    largest entry, its gradient (the velocity after one step) within
    0.25 of its largest entry. Later steps are printed beside the host's
    own spread (the same steps on the host with the images scaled by
    1 + 2^-23): one training step of this net turns rounding into
    percent-level changes of the next loss."""
    from paddle_tpu_torch.models import resnet as R
    from paddle_tpu_torch.weights import load_into_scope
    t0 = time.perf_counter()
    avg_cost = _build_resnet(pt, 32, 10, 'NCHW', None, lr)
    main = pt.default_main_program()
    stats = _running_stats(main)
    params = [p.name for p in main.all_parameters()]
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    feed = R.make_fake_batch(8, 32, 10, seed=0)
    nudged = dict(feed, image=feed['image'] * np.float32(1 + 2.0 ** -23))
    runs = []
    for place, f in ((places[0], feed), (places[1], feed),
                     (pt.CPUPlace(), nudged)):
        scope = pt.Scope()
        load_into_scope(weights, scope, place)
        exe = pt.Executor(place)
        losses, first = [], None
        with pt.scope_guard(scope):
            for _ in range(steps):
                losses.append(exe.run(main, feed=f,
                                      fetch_list=[avg_cost])[0].item())
                if first is None:
                    first = {n: scope.numpy(n) for n in
                             stats + [p + '_velocity_acc' for p in params]}
        runs.append((losses, first))
    (la, fa), (lb, fb), (lc, _) = runs

    def worst(names):
        return max(float(np.abs(fa[n] - fb[n]).max() /
                         max(np.abs(fb[n]).max(), 1e-30)) for n in names)

    rel = [abs(a - b) / abs(b) for a, b in zip(la, lb)]
    own = [abs(c - b) / abs(b) for b, c in zip(lb, lc)]
    stats_gap = worst(stats)
    grad_gap = worst([p + '_velocity_acc' for p in params])
    print('resnet %r vs %r: ResNet-50 32x32, batch 8, 10 classes, NCHW, '
          'fp32, Momentum(%g), %d steps from the same weights: losses %s vs '
          '%s; relative gaps %s (first step limit 1e-3); the host with its '
          'images scaled by 1 + 2^-23: %s; after the first step, running '
          'statistics within %.3g (limit 1e-3) and gradients within %.3g '
          '(limit 0.25) of their largest entry (%.1f s)'
          % (places[0], places[1], lr, steps, ['%.6f' % v for v in la],
             ['%.6f' % v for v in lb], ['%.3g' % v for v in rel],
             ['%.3g' % v for v in own], stats_gap, grad_gap,
             time.perf_counter() - t0))
    require(rel[0] <= 1e-3, 'resnet first-step losses differ across places')
    require(np.isfinite(la + lb).all(), 'resnet losses not finite')
    require(stats_gap <= 1e-3, 'running statistics differ across places')
    require(grad_gap <= 0.25, 'first-step gradients differ across places')


# ------------------------------------------------------------ phase 11
def _snapshot(scope):
    return {n: scope.find(n).detach().clone() for n in scope.keys()}


def _restore(scope, snap):
    """Every scope tensor takes its snapshot in place: the graphs captured
    over them stay valid."""
    for n, t in snap.items():
        scope.find(n).copy_(t)


def _mode_steps(torch, pt, exe, program, scope, feed, fetch, cache, warmup,
                steps, on_card):
    """``warmup`` then ``steps`` timed steps in one mode (cache: captured,
    else use_program_cache=False); returns (seconds, losses)."""
    def run(n):
        return [exe.run(program, feed=feed, fetch_list=[fetch],
                        return_numpy=False, use_program_cache=cache)[0]
                for _ in range(n)]
    with pt.scope_guard(scope):
        first = run(warmup)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(steps)
        if on_card:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    if on_card:
        require(exe.last_captured == cache, 'the %s steps ran %s' % (
            'captured' if cache else 'eager',
            'captured' if exe.last_captured else 'eagerly'))
    return secs, [float(v.float()) for v in first + out]


def _eager_vs_captured(torch, pt, place, card, on_card, program, fetch,
                       feed, label, unit, units, flops, warmup, steps):
    """The same training program eagerly (use_program_cache=False) and as
    a CUDA graph, one after the other on one scope: ms a step, units/s and
    MFU of each. Returns (rows, --profile jobs)."""
    exe = pt.Executor(place)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
    feed = {n: torch.as_tensor(v).to(exe.device) for n, v in feed.items()}
    rows, jobs = {}, []
    for mode, cache in (('eager', False), ('captured', True)):
        secs, losses = _mode_steps(torch, pt, exe, program, scope, feed,
                                   fetch, cache, warmup, steps, on_card)
        require(np.isfinite(losses).all(), '%s %s: loss not finite'
                % (label, mode))
        ms = secs * 1e3 / steps
        rows[mode] = dict(ms=ms, per_s=units * steps / secs,
                          mfu=flops / (ms / 1e3) / BF16_FLOPS)

        def job_step(cache=cache):
            with pt.scope_guard(scope):
                exe.run(program, feed=feed, fetch_list=[fetch],
                        return_numpy=False, use_program_cache=cache)
        jobs.append(('5 %s steps, %s' % (label, mode), job_step, 5, None))
    e, c = rows['eager'], rows['captured']
    print('phase 11 %s: eager %.3f ms/step, %.1f %s/s, MFU %.4f; captured '
          '%.3f ms/step, %.1f %s/s, MFU %.4f (%d timed steps each after %d '
          'warm-up; %d CUDA graph captured) [%s]'
          % (label, e['ms'], e['per_s'], unit, e['mfu'], c['ms'],
             c['per_s'], unit, c['mfu'], steps, warmup, exe.captures, card))
    if on_card:
        require(exe.captures == 1, '%s: %d captures, want 1'
                % (label, exe.captures))
    return rows, jobs


def _three_ways(torch, pt, place, program, fetch, weights, feed, steps=3,
                modes=('captured', 'eager', 'run_steps')):
    """The same ``steps`` steps from the same state three ways: replays of
    a captured graph, eager runs (use_program_cache=False) and one
    run_steps call. Each executor first runs two steps (the eager warm-up
    and the capture) and then takes its state back, so all three are at
    the same step index. Returns {mode: (losses, {var: numpy},
    addresses kept)}."""
    from paddle_tpu_torch.weights import load_into_scope
    res = {}
    for mode in modes:
        scope = pt.Scope()
        load_into_scope(weights, scope, place)
        exe = pt.Executor(place)
        cache = mode != 'eager'
        snap = _snapshot(scope)
        with pt.scope_guard(scope):
            for _ in range(2):
                exe.run(program, feed=feed, fetch_list=[fetch],
                        use_program_cache=cache)
            _restore(scope, snap)
            ptrs = {n: scope.find(n).data_ptr() for n in scope.keys()}
            if mode == 'run_steps':
                losses = exe.run_steps(steps, program, feed=feed,
                                       fetch_list=[fetch])[0].reshape(-1)
            else:
                losses = np.array([
                    exe.run(program, feed=feed, fetch_list=[fetch],
                            use_program_cache=cache)[0].reshape(())
                    for _ in range(steps)])
        kept = ptrs == {n: scope.find(n).data_ptr() for n in scope.keys()}
        res[mode] = (losses, {n: scope.numpy(n) for n in scope.keys()}, kept)
        del exe, scope
    return res


def phase_captured_train(torch, pt, place, card, on_card, batch, seq, vocab,
                         dims, cmp_batch=2, warmup=3, steps=20):
    """Phase 11a: bench_transformer eager against captured, then phase 8's
    program at fp32 with dropout 0.1: 3 captured steps equal 3 eager steps
    and run_steps(3) equals 3 run calls, bit for bit in the losses and
    every scope variable. Returns the --profile jobs."""
    from paddle_tpu_torch.models import transformer as T
    avg_cost = _build_train(pt, vocab, seq, 0.1, 'bf16', **dims)
    flops = T.train_step_flops(batch, seq, seq, vocab,
                               n_layer=dims.get('n_layer', 6),
                               n_head=dims.get('n_head', 8),
                               d_key=dims.get('d_key', 64),
                               d_model=dims.get('d_model', 512),
                               d_inner=dims.get('d_inner', 2048))
    _, jobs = _eager_vs_captured(
        torch, pt, place, card, on_card, pt.default_main_program(), avg_cost,
        T.make_fake_batch(batch, seq, seq, vocab, vocab, seed=0),
        'Transformer-base', 'tokens', batch * seq, flops, warmup, steps)
    avg_cost = _build_train(pt, vocab, seq, 0.1, None, **dims)
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    res = _three_ways(torch, pt, place, pt.default_main_program(), avg_cost,
                      weights, T.make_fake_batch(cmp_batch, seq, seq, vocab,
                                                 vocab, seed=0))
    base_losses, base_vars, _ = res['captured']
    verdict = {}
    for mode in ('eager', 'run_steps'):
        losses, vars_, _ = res[mode]
        verdict[mode] = bool(np.array_equal(losses, base_losses)) and all(
            np.array_equal(vars_[n], v) for n, v in base_vars.items())
    kept = all(r[2] for r in res.values())
    print('phase 11 Transformer compare (batch %d x seq %d, fp32, dropout '
          '0.1, Adam): losses captured %s, eager %s, run_steps %s; captured '
          '== eager bit for bit (losses and %d scope variables): %s; '
          'run_steps(3) == 3 run calls: %s; every scope tensor kept its '
          'address: %s [%s]'
          % (cmp_batch, seq, ['%.7f' % v for v in base_losses],
             ['%.7f' % v for v in res['eager'][0]],
             ['%.7f' % v for v in res['run_steps'][0]], len(base_vars),
             verdict['eager'], verdict['run_steps'], kept, card))
    require(np.isfinite(base_losses).all(), 'compare losses not finite')
    require(verdict['eager'], 'captured Transformer steps differ from eager')
    require(verdict['run_steps'], 'run_steps(3) differs from 3 run calls')
    require(kept, 'a scope tensor changed its address')
    return jobs


def phase_captured_resnet(torch, pt, place, card, on_card, batch, image,
                          class_dim, small=False, warmup=3, steps=20):
    """Phase 11b: bench_resnet50 eager against captured, then phase 10's
    program (32x32, batch 8, NCHW, fp32): the first step captured against
    eager within 1e-6 relative (loss; every scope variable against its
    largest entry), and whether two eager runs repeat their bits. Returns
    the --profile jobs."""
    from paddle_tpu_torch.models import resnet as R
    avg_cost = _build_resnet(pt, image, class_dim, 'NHWC', 'bf16', 0.1,
                             small=small)
    program = pt.default_main_program()
    flops = 3 * 2 * R.forward_macs_per_image(program) * batch
    _, jobs = _eager_vs_captured(
        torch, pt, place, card, on_card, program, avg_cost,
        R.make_fake_batch(batch, image, class_dim, seed=0), 'ResNet-50',
        'images', batch, flops, warmup, steps)
    avg_cost = _build_resnet(pt, 32, 10, 'NCHW', None, 0.01)
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    feed = R.make_fake_batch(8, 32, 10, seed=0)

    def gap(a, b):
        """The larger of the losses' relative gap and every scope
        variable's largest gap against its largest entry."""
        rel = float(np.max(np.abs(a[0] - b[0]) / np.abs(b[0])))
        return max([rel] + [float(np.abs(a[1][n] - v).max()) /
                            max(float(np.abs(v).max()), 1e-30)
                            for n, v in b[1].items()])

    # cuDNN's default backward algorithms need not repeat their bits from
    # run to run: the comparison runs twice, with its default algorithms
    # and with torch.backends.cudnn.deterministic, each time against two
    # eager runs
    found = {}
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        try:
            res = _three_ways(torch, pt, place, pt.default_main_program(),
                              avg_cost, weights, feed, steps=1)
            again = _three_ways(torch, pt, place, pt.default_main_program(),
                                avg_cost, weights, feed, steps=1,
                                modes=('eager',))['eager']
        finally:
            torch.backends.cudnn.deterministic = False
        base = res['eager']
        found[deterministic] = (gap(res['captured'], base),
                                gap(res['run_steps'], base),
                                gap(again, base))
    for deterministic, (cap, rsteps, eager) in found.items():
        print('phase 11 ResNet-50 compare (32x32, batch 8, NCHW, fp32, '
              'Momentum(0.01), cudnn.deterministic=%s), the first step from '
              'the same state: captured vs eager within %.3g relative (limit '
              '1e-6), run_steps(1) vs eager %.3g; two eager runs within %.3g '
              '(bit-equal: %s) [%s]' % (deterministic, cap, rsteps, eager,
                                        eager == 0.0, card))
    cap, rsteps, _ = found[True]
    require(cap <= 1e-6 and rsteps <= 1e-6,
            'captured ResNet-50 step differs from eager')
    return jobs


def phase_captured_engine(torch, spec, engine_kw, reqs, card, on_card,
                          captured, label, kv_dtype=None):
    """Phase 11c: the same traffic through an eager engine
    (use_program_cache=False): every stream equal to the captured run's,
    and both runs' tokens/s, TTFT and inter-token gaps. ``captured`` is
    that run's (results, stats). Returns the eager engine."""
    import paddle_tpu_torch as pt
    kw = dict(engine_kw)
    if kv_dtype is not None:
        kw.update(prefix_cache=True, spec_k=3, kv_dtype=kv_dtype)
    results, _, eng, stats = phase_engine(
        torch, spec, kw, reqs, pt.CUDAPlace(0) if on_card else pt.CPUPlace(),
        card, on_card, label=label + ' eager', alone=0, eager=True)
    got, base = captured
    diff = [i for i, (a, b) in enumerate(zip(got, results)) if a != b]
    print('phase 11 %s: %d streams (greedy and sampled) equal eager and '
          'captured: %s; tokens/s %.1f eager, %.1f captured; TTFT p50 %.1f, '
          '%.1f ms; inter-token p50 %.2f, %.2f ms; p99 %.2f, %.2f ms [%s]'
          % (label, len(got), not diff, stats['tokens_per_s'],
             base['tokens_per_s'], stats['ttft_p50_ms'], base['ttft_p50_ms'],
             stats['itl_p50_ms'], base['itl_p50_ms'], stats['itl_p99_ms'],
             base['itl_p99_ms'], card))
    require(not diff, '%s: streams %s differ between eager and captured'
            % (label, diff[:5]))
    return eng


# ------------------------------------------------------------ phase 12
# a stream may differ between two runs only where it first diverges at a
# near tie of the reference run: top-two gap <= NEAR_TIE * max |value|;
# more than NEAR_TIE_STREAMS such streams fail
NEAR_TIE = 1e-5
NEAR_TIE_STREAMS = 2


def _nmt_program(pt, kind, incremental, t_out, src_seq, vocab, dims, beam):
    """One inference graph on a fresh Program: (program, fetches); beam
    also fetches each step's selection ([T - 1, B, beam] ids and parents:
    the beam_search_decode op's inputs, or the transformer_beam_decode
    op's outputs of those names)."""
    from paddle_tpu_torch.models import transformer as T
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        kw = dict(max_out_len=t_out, src_seq_len=src_seq, bos_id=0,
                  eos_id=1, incremental=incremental, scan_layers=False,
                  **dims)
        if kind == 'greedy':
            return main, [T.transformer_greedy_infer(vocab, vocab, **kw)[0]]
        fetch = list(T.transformer_beam_infer(vocab, vocab, beam_size=beam,
                                              **kw)[0])
    op = [o for o in main.global_block().ops
          if o.type in ('beam_search_decode', 'transformer_beam_decode')][0]
    slots = op.output if incremental else op.input
    return main, fetch + [slots('StepIds'), slots('StepParents')]


def _nmt_weights(pt, vocab, src_seq, dims):
    """The port's seeded startup of the unrolled graphs' parameters, drawn
    on the host: {name: array}."""
    from paddle_tpu_torch.models import transformer as T
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        T.transformer_greedy_infer(vocab, vocab, max_out_len=2,
                                   src_seq_len=src_seq, scan_layers=False,
                                   **dims)
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(startup)
    return {n: host.numpy(n) for n in host.keys()}


def _nmt_scope(pt, weights, place, n_layer):
    """The weights on ``place``, the decoder's also stacked by
    stack_trained_weights (on that device) for the incremental graphs."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.weights import load_into_scope
    scope = pt.Scope()
    load_into_scope(weights, scope, place)
    return scope, T.stack_trained_weights(scope, n_layer)


def _nmt_feed(batch, src_seq, vocab, seed):
    """src_word uniform in [2, vocab), src_length uniform in [16, S]
    (seeded); bos 0 and eos 1 are never source tokens."""
    rng = np.random.RandomState(seed)
    return {'src_word': rng.randint(2, vocab, (batch, src_seq))
            .astype('int64'),
            'src_length': rng.randint(min(16, src_seq), src_seq + 1, batch)
            .astype('int64')}


def _nmt_run(pt, exe, scope, prog, fetch, feed, cache=True, numpy=False):
    with pt.scope_guard(scope):
        return exe.run(prog, feed=feed, fetch_list=fetch,
                       return_numpy=numpy, use_program_cache=cache)


def nmt_want(n_layer, t_out, incremental):
    """The launches of one decode call, from the code: K2 for each
    encoder layer's self-attention and, on the unrolled path, each
    decoder layer's two attentions at each of the t_out - 1 positions (the
    incremental path's one-query attention is plain torch); K1 twice an
    encoder layer and three times a decoder layer at each position; no
    backward kernel and no dropout mask."""
    return {'flash_attention_fwd': n_layer + (
        0 if incremental else 2 * n_layer * (t_out - 1)),
        'layer_norm': 2 * n_layer + 3 * n_layer * (t_out - 1),
        'flash_attention_bwd_dq': 0, 'flash_attention_bwd_dkv': 0,
        'layer_norm_bwd': 0, 'keep_mask': 0, 'dropout': 0, 'dropout_bwd': 0}


def _nmt_time(torch, pt, exe, scope, prog, fetch, feed, on_card, warmup=3,
              calls=10):
    """``warmup`` calls (on the card: the eager run, the capture, a replay)
    and ``calls`` timed ones on the host clock. Returns (ms a call, the
    last call's fetches, the launches of the timed calls, peak bytes above
    what was allocated before the first call)."""
    base = 0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    for _ in range(warmup):
        _nmt_run(pt, exe, scope, prog, fetch, feed)
    if on_card:
        torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(calls):
        out = _nmt_run(pt, exe, scope, prog, fetch, feed)
    if on_card:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - base if on_card else 0
    return ms, [o.cpu() for o in out], launches, peak


def _top_gap(vals, k):
    """The smallest gap between adjacent values among the k largest of
    the 1-D ``vals``, relative to the largest |value| among them."""
    top = np.sort(np.asarray(vals, np.float64))[::-1][:k]
    return float(np.min(top[:-1] - top[1:])) / max(float(np.abs(top).max()),
                                                   1e-30)


def _nmt_gap(pt, exe, scope, prog, feed, kind, beam, stream, pos):
    """The reference run's near-tie measure where ``stream`` first
    diverges, from an eager run of the unrolled ``prog``: greedy, the
    top-two gap of the logits that chose position ``pos``; beam, at the
    first step ``pos`` whose selection (ids or parents) differs for the
    sentence, the smallest top-(beam + 1) gap over the step's logits rows
    of the sentence and over its candidate totals (pre_scores + candidate
    log-probabilities)."""
    ops = prog.global_block().ops
    if kind == 'greedy':
        x = [op.input('X') for op in ops if op.type == 'argmax'][pos - 1]
        logits, = _nmt_run(pt, exe, scope, prog, [x], feed, cache=False,
                           numpy=True)
        return _top_gap(logits[stream], 2)
    b = stream[0]
    x = [op.input('X') for op in ops if op.type == 'log_softmax'][pos]
    bs = [op for op in ops if op.type == 'beam_search'][pos]
    logits, pre, cand = _nmt_run(
        pt, exe, scope, prog, [x, bs.input('pre_scores'), bs.input('scores')],
        feed, cache=False, numpy=True)
    gaps = [_top_gap(logits[b * beam + j], beam + 1) for j in range(beam)]
    totals = (pre[b][:, None].astype(np.float32) + cand[b]).reshape(-1)
    totals = totals[totals > -1e29]
    if totals.size > 1:
        gaps.append(_top_gap(totals, beam + 1))
    return min(gaps)


def _nmt_match(label, kind, got, want, gap_of, n_streams, card):
    """Hold ``got`` (ids; for beam also scores, step ids and step
    parents) to ``want``: every stream equal but at most NEAR_TIE_STREAMS
    that first diverge at a near tie of the reference run (``gap_of(stream,
    pos)``: greedy at the first differing position, beam at the first step
    whose selection differs for the sentence: a later step's parent
    rewrites earlier positions of a backtracked sentence); beam scores
    within 1e-4 relative for every sentence whose beams all match."""
    a, b = got[0].numpy(), want[0].numpy()
    diff = a != b
    if kind == 'greedy':
        streams = [(int(r), int(np.argmax(diff[r])))
                   for r in np.where(diff.any(axis=1))[0]]
        at = [(a[s][p], b[s][p]) for s, p in streams]
    else:
        split = ((got[2].numpy() != want[2].numpy()) |
                 (got[3].numpy() != want[3].numpy())).any(axis=2)
        streams = [((int(i), int(j)), int(np.argmax(split[:, i])))
                   for i, j in zip(*np.where(diff.any(axis=2)))]
        at = [tuple('ids %s, parents %s' % (o[2].numpy()[p, s[0]],
                                             o[3].numpy()[p, s[0]])
                    for o in (got, want)) for s, p in streams]
    ties = []
    for (stream, pos), (x, y) in zip(streams, at):
        gap = gap_of(stream, pos)
        ties.append(gap <= NEAR_TIE)
        print('%s: stream %s first diverges at %s %d (%s vs %s); the '
              'reference run\'s top-two gap there is %.3g of the largest '
              '|value| (a near tie at <= %g): %s'
              % (label, stream, 'position' if kind == 'greedy' else 'step',
                 pos, x, y, gap, NEAR_TIE,
                 'near tie' if ties[-1] else 'NOT a near tie'))
    rel = 0.0
    if kind == 'beam':
        same = ~diff.any(axis=(1, 2))
        sa, sb = got[1].numpy()[same], want[1].numpy()[same]
        rel = float(np.max(np.abs(sa - sb) / np.maximum(np.abs(sb), 1e-30))) \
            if sa.size else 0.0
    print('%s: %d of %d streams differ, each at a near tie: %s; %sequal '
          'otherwise [%s]' % (label, len(streams), n_streams, all(ties),
                              'beam scores of the matching sentences within '
                              '%.3g relative (limit 1e-4); ' % rel
                              if kind == 'beam' else '', card))
    require(all(ties) and len(streams) <= NEAR_TIE_STREAMS,
            '%s: ids differ beyond near ties' % label)
    require(rel <= 1e-4, '%s: beam scores differ' % label)


def phase_nmt(torch, pt, place, card, on_card, vocab, dims, batch=64,
              src_seq=64, beam=4, t_inc=114, t_unr=32, calls=10,
              host_place=None, host_batch=2, host_t=16, profile=False):
    """Phase 12: Transformer-base NMT inference through the port's entry
    points (transformer_greedy_infer / transformer_beam_infer,
    Executor(place).run captured) from the port's seeded startup, the
    decoder stacked by stack_trained_weights. Greedy and beam at
    t_inc positions (incremental) and at t_unr (incremental and unrolled),
    fp32 (TF32 off) then bf16 AMP: ms a batch, tokens/s, peak memory and
    the exact launches a call. Checks: incremental equals unrolled at
    t_unr (fp32), captured equals eager bit for bit and a second batch of
    other sentences captures nothing (the t_inc graphs), and the card
    equals ``host_place`` (incremental, fp32, host_batch sentences,
    host_t positions). Returns (the timed calls' launches, --profile
    jobs)."""
    t0 = time.perf_counter()
    n_layer = dims['n_layer']
    weights = _nmt_weights(pt, vocab, src_seq, dims)
    scope, stacked = _nmt_scope(pt, weights, place, n_layer)
    feed = _nmt_feed(batch, src_seq, vocab, seed=0)
    feed2 = _nmt_feed(batch, src_seq, vocab, seed=1)
    print('phase 12: Transformer-base NMT inference, vocab %d, %d + %d '
          'layers, d_model %d, %d heads, d_inner %d; %d sentences x src %d '
          '(src_length %d-%d), bos 0, eos 1, beam %d; %d layer parameters '
          'stacked by stack_trained_weights on %r; setup %.1f s'
          % (vocab, n_layer, n_layer, dims['d_model'], dims['n_head'],
             dims['d_inner'], batch, src_seq, feed['src_length'].min(),
             feed['src_length'].max(), beam, len(stacked), place,
             time.perf_counter() - t0))
    total, jobs, ms_of = {}, [], {}
    for amp in (None, 'bf16'):
        exe = pt.Executor(place)
        prec = 'bf16' if amp else 'fp32'
        kept = {}
        for kind in ('greedy', 'beam'):
            for incremental, t_out in ((True, t_inc), (True, t_unr),
                                       (False, t_unr)):
                prog, fetch = _nmt_program(pt, kind, incremental, t_out,
                                           src_seq, vocab, dims, beam)
                prog.amp = amp
                mode = 'incremental' if incremental else 'unrolled'
                label = 'phase 12 %s %s %s T=%d' % (kind, mode, prec, t_out)
                ms, out, launches, peak = _nmt_time(
                    torch, pt, exe, scope, prog, fetch, feed, on_card,
                    calls=calls)
                ms_of[kind, mode, prec, t_out] = ms
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
                want = nmt_want(n_layer, t_out, incremental)
                got = {k: launches[k] / calls for k in want}
                tokens = batch * (t_out - 1)
                print('%s: %.3f ms/batch, %.1f tokens/s%s, peak memory %.3f '
                      'GB above the weights and earlier graphs; launches a '
                      'call %s (want %s) [%s]'
                      % (label, ms, tokens / ms * 1e3,
                         ', %.1f sentences/s' % (batch / ms * 1e3)
                         if kind == 'beam' else '', peak / 1e9, got, want,
                         card))
                ids = out[0]
                require(tuple(ids.shape) == ((batch, t_out) if kind ==
                                             'greedy' else
                                             (batch, beam, t_out - 1)),
                        '%s: ids of shape %s' % (label, tuple(ids.shape)))
                require(bool(((ids >= 0) & (ids < vocab)).all()),
                        '%s: ids out of the vocabulary' % label)
                if kind == 'beam':
                    require(bool(torch.isfinite(out[1]).all()),
                            '%s: scores not finite' % label)
                if on_card:
                    require(got == want, '%s: launches %s, want %s'
                            % (label, got, want))
                if t_out == t_unr:
                    kept[kind, incremental] = (out, prog)
                if t_out != t_inc:
                    continue
                eager = _nmt_run(pt, exe, scope, prog, fetch, feed,
                                 cache=False)
                same = all(torch.equal(a, e.cpu()) for a, e in zip(out, eager))
                _nmt_run(pt, exe, scope, prog, fetch, feed2)
                miss, captured = exe.last_cache_miss, exe.last_captured
                print('%s: captured == eager bit for bit: %s; a second batch '
                      'of other sentences: cache miss %s, captured %s'
                      % (label, same, miss, captured))
                require(same, '%s: captured differs from eager' % label)
                require(not miss and (captured or not on_card),
                        '%s: the second batch was not a replay' % label)
                if profile:
                    # eager (one call, fp32 only: the profiler slows its
                    # ~30 k launches) for the one-query attention's spans
                    for cache in (True, False) if amp is None else (True,):
                        jobs.append((
                            '1 %s call, %s' % (label, 'captured' if cache
                                                else 'eager'),
                            lambda p=prog, f=fetch, c=cache, e=exe: _nmt_run(
                                pt, e, scope, p, f, feed, cache=c),
                            3 if cache else 1, None))
            if profile:
                jobs.append(('1 phase 12 %s unrolled %s T=%d call, captured'
                             % (kind, prec, t_unr),
                             lambda p=prog, f=fetch, e=exe: _nmt_run(
                                 pt, e, scope, p, f, feed), 3, None))
        for kind in ('greedy', 'beam'):
            print('phase 12 %s %s: incremental %.3f ms, unrolled %.3f ms at '
                  '%d positions: incremental %.2fx faster [%s]'
                  % (kind, prec, ms_of[kind, 'incremental', prec, t_unr],
                     ms_of[kind, 'unrolled', prec, t_unr], t_unr,
                     ms_of[kind, 'unrolled', prec, t_unr] /
                     ms_of[kind, 'incremental', prec, t_unr], card))
        if amp is None:
            for kind in ('greedy', 'beam'):
                (inc, _), (unr, uprog) = kept[kind, True], kept[kind, False]
                _nmt_match(
                    'phase 12 %s incremental vs unrolled, fp32, T=%d'
                    % (kind, t_unr), kind, inc, unr,
                    lambda stream, pos, k=kind, u=uprog: _nmt_gap(
                        pt, exe, scope, u, feed, k, beam, stream, pos),
                    batch * (1 if kind == 'greedy' else beam), card)
        del kept
        if not profile:
            del exe
        if on_card:
            torch.cuda.empty_cache()
    if host_place is not None:
        _nmt_vs_host(torch, pt, place, host_place, card, vocab, dims,
                     weights, src_seq, beam, host_batch, host_t)
    print('phase 12 done in %.1f s' % (time.perf_counter() - t0))
    return total, jobs


def _nmt_vs_host(torch, pt, place, host_place, card, vocab, dims, weights,
                 src_seq, beam, batch, t_out):
    """Incremental greedy and beam, fp32, on ``place`` (a replay on the
    card) against ``host_place``: ids equal but for near ties (read from
    the host's unrolled graph), beam scores within 1e-4 relative."""
    feed = _nmt_feed(batch, src_seq, vocab, seed=2)
    out = {}
    scopes = {}
    for where in (place, host_place):
        scope, _ = _nmt_scope(pt, weights, where, dims['n_layer'])
        scopes[str(where)] = scope
        exe = pt.Executor(where)
        for kind in ('greedy', 'beam'):
            prog, fetch = _nmt_program(pt, kind, True, t_out, src_seq, vocab,
                                       dims, beam)
            for _ in range(3):
                res = _nmt_run(pt, exe, scope, prog, fetch, feed)
            out[str(where), kind] = [r.cpu() for r in res]
    hexe = pt.Executor(host_place)
    hscope = scopes[str(host_place)]
    for kind in ('greedy', 'beam'):
        uprog, _ = _nmt_program(pt, kind, False, t_out, src_seq, vocab, dims,
                                beam)
        _nmt_match('phase 12 %s %r vs %r, fp32, %d sentences, T=%d'
                   % (kind, place, host_place, batch, t_out), kind,
                   out[str(place), kind], out[str(host_place), kind],
                   lambda stream, pos, k=kind, u=uprog: _nmt_gap(
                       pt, hexe, hscope, u, feed, k, beam, stream, pos),
                   batch * (1 if kind == 'greedy' else beam), card)


# ------------------------------------------------------------ phase 13
def _host_copy(torch, scope, names):
    """{name: CPU copy} of scope tensors (for bit-for-bit compares)."""
    return {n: scope.find(n).detach().to('cpu', copy=True) for n in names}


def _same_bits(torch, got, want):
    """Names whose tensors differ in any bit (NaN payloads included)."""
    def raw(t):
        return t.reshape(-1).view(torch.uint8)
    return [n for n, w in want.items()
            if got[n].dtype != w.dtype or got[n].shape != w.shape or
            not torch.equal(raw(got[n]), raw(w))]


def _persistable_names(program):
    return [v.name for v in program.list_vars()
            if v.persistable and not v.is_data]


def _bench_reader(batch, seq, vocab, n, seed0=0):
    """bench_pipeline_ablation's reader: make_fake_batch(seed=i)."""
    from paddle_tpu_torch.models import transformer as T

    def reader():
        for i in range(n):
            yield T.make_fake_batch(batch, seq, seq, vocab, vocab,
                                    seed=seed0 + i)
    return reader


def _sync(torch, on_card):
    if on_card:
        torch.cuda.synchronize()


def phase_trainer(torch, pt, place, card, on_card, batch, seq, vocab, dims,
                  steps=20, depths=(1, 2, 4)):
    """Phase 13a: bench.py's bench_pipeline_ablation through the port's
    Trainer.train: transformer_base (dropout 0.1) with Adam(1e-4), amp
    bf16, 2 epochs of ``steps`` make_fake_batch feeds, epoch 1 timed, at
    each pipeline depth (host_prefetch 2 above depth 1). Checks the timed
    launches (K2 and each K3 kernel 3 a layer and step, K1 5 and its
    backward 10, the fused dropout and its backward 10 a layer and 2 a
    step, no keep mask) and that every depth ends on depth 1's parameters and
    losses, bit for bit. Returns (the depth-1 timed launches, {depth:
    tokens/s}, {kernel: launches a step})."""
    from paddle_tpu_torch.models import transformer as T
    layers = dims.get('n_layer', 6)
    reader = _bench_reader(batch, seq, vocab, steps)
    tok_s, first, first_launches = {}, None, None

    def train_func():
        avg_cost, _ = T.transformer_base(
            src_vocab_size=vocab, trg_vocab_size=vocab, src_seq_len=seq,
            trg_seq_len=seq, max_length=max(256, seq), **dims)
        return [avg_cost]

    for d in depths:
        t0 = time.perf_counter()
        pt.reset_default_programs()
        state, losses = {}, []

        def handler(e):
            if isinstance(e, pt.BeginEpochEvent) and e.epoch == 1:
                _sync(torch, on_card)
                reset_launches()
                state['t0'] = time.perf_counter()
            elif isinstance(e, pt.EndEpochEvent) and e.epoch == 1:
                _sync(torch, on_card)
                state['t1'] = time.perf_counter()
                state['launches'] = read_launches()
            elif isinstance(e, pt.EndStepEvent):
                losses.append(np.asarray(e.metrics[0]).copy())

        scope = pt.Scope()
        with pt.scope_guard(scope):
            trainer = pt.Trainer(
                train_func=train_func,
                optimizer_func=lambda: pt.optimizer.Adam(learning_rate=1e-4),
                place=place)
            trainer.program.amp = 'bf16'
            trainer.train(num_epochs=2, event_handler=handler, reader=reader,
                          pipeline_depth=d,
                          host_prefetch=2 if d > 1 else 0)
            params = _host_copy(torch, scope, _persistable_names(
                trainer.program))
        secs = state['t1'] - state['t0']
        tok_s[d] = batch * seq * steps / secs
        launches = state['launches']
        want = train_want(layers, steps)
        per_step = {k: launches[k] / steps for k in want
                    if not k.endswith('_simt') and not k.endswith('_mma')}
        print('phase 13a Trainer.train depth %d (host_prefetch %d): epoch 1 '
              '%d steps in %.3f s: %.3f ms/step, %.1f tokens/s; launches a '
              'step %s; %.1f s with startup and epoch 0 [%s]'
              % (d, 2 if d > 1 else 0, steps, secs, secs * 1e3 / steps,
                 tok_s[d], per_step, time.perf_counter() - t0, card))
        require(len(losses) == 2 * steps and
                all(np.isfinite(v).all() for v in losses),
                'phase 13a depth %d: %d losses, not all finite'
                % (d, len(losses)))
        if on_card:
            require(all(launches[k] == n for k, n in want.items()),
                    'phase 13a depth %d launches %s, want %s'
                    % (d, {k: launches[k] for k in want}, want))
        if first is None:
            first, first_losses, first_launches = params, losses, launches
        else:
            bad = _same_bits(torch, params, first)
            same_losses = all(np.array_equal(a, b)
                              for a, b in zip(losses, first_losses))
            print('phase 13a depth %d vs depth 1: %d persistables, %d '
                  'differ; %d losses, equal bit for bit: %s'
                  % (d, len(first), len(bad), len(losses), same_losses))
            require(not bad and same_losses,
                    'phase 13a: depth %d ends elsewhere than depth 1 (%s)'
                    % (d, bad[:5]))
        del trainer, scope, params
        if on_card:
            torch.cuda.empty_cache()
    print('phase 13a tokens/s by depth: %s; depth 2 / depth 1 %.3f, depth 4 '
          '/ depth 1 %.3f [%s]'
          % ({d: round(v, 1) for d, v in tok_s.items()}, tok_s[2] / tok_s[1],
             tok_s[4] / tok_s[1], card))
    per_step = {k: first_launches[k] / steps for k in
                ('flash_attention_fwd', 'flash_attention_bwd_dkv',
                 'flash_attention_bwd_dq', 'layer_norm', 'layer_norm_bwd')}
    return first_launches, tok_s, per_step


def _lifecycle_trainer(pt, place, root, resume, batch, seq, vocab, dims,
                       every):
    """13b's Trainer: transformer_base at dropout 0.1, amp bf16, noam(512,
    4000), Adam(0.9, 0.98, 1e-9), GradientClipByGlobalNorm(1.0),
    CheckpointConfig(save_every_steps=every)."""
    from paddle_tpu_torch.models import transformer as T
    pt.reset_default_programs()

    def train_func():
        avg_cost, _ = T.transformer_base(
            src_vocab_size=vocab, trg_vocab_size=vocab, src_seq_len=seq,
            trg_seq_len=seq, max_length=max(256, seq), dropout_rate=0.1,
            **dims)
        pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(1.0))
        return [avg_cost]

    trainer = pt.Trainer(
        train_func=train_func,
        optimizer_func=lambda: pt.optimizer.Adam(
            learning_rate=pt.learning_rate_decay.noam_decay(
                dims.get('d_model', 512), 4000),
            beta1=0.9, beta2=0.98, epsilon=1e-9),
        place=place, checkpoint_config=pt.CheckpointConfig(
            root, save_every_steps=every, resume=resume))
    trainer.program.amp = 'bf16'
    return trainer


def phase_lifecycle(torch, pt, place, card, on_card, batch, seq, vocab,
                    dims, work, steps=10, every=5):
    """Phase 13b: the training lifecycle at 13a's width: ``steps`` steps
    with checkpoints every ``every``; a fresh Trainer on a fresh scope and
    executor resumes from step ``every``'s checkpoint and trains to
    ``steps``: its losses and every persistable equal the uninterrupted
    run's bit for bit; io.load_checkpoint of step ``every`` into the first
    run's live executor, then one step, replays (no capture) and gives
    that step's loss; a sync and an async save timed. Returns {metric:
    value} for the JSON line."""
    from paddle_tpu_torch import io
    t0 = time.perf_counter()
    reader = lambda: pt.reader.checkpointable(  # noqa: E731
        _bench_reader(batch, seq, vocab, steps, seed0=100))
    run1 = os.path.join(work, 'run1')
    out = {}

    def log_to(log):
        return lambda e: log.append(np.asarray(e.metrics[0]).copy()) \
            if isinstance(e, pt.EndStepEvent) else None

    losses = []
    scope1 = pt.Scope()
    with pt.scope_guard(scope1):
        t1 = _lifecycle_trainer(pt, place, run1, False, batch, seq, vocab,
                                dims, every)
        t1.train(num_epochs=1, event_handler=log_to(losses),
                 reader=reader())
        names = _persistable_names(t1.program)
        want = _host_copy(torch, scope1, names)
    require(len(losses) == steps and all(np.isfinite(v).all()
                                         for v in losses),
            'phase 13b: losses %s' % losses)
    mgr = pt.fault.CheckpointManager(pt.CheckpointConfig(run1))
    step_dir = mgr.step_dir(every)
    require(os.path.isdir(step_dir), 'phase 13b: no checkpoint at step %d'
            % every)
    # the restore into the live executor: a replay, and step every+1's loss
    exe1 = t1.exe
    captures = exe1.captures
    feed = _bench_reader(batch, seq, vocab, steps, seed0=100)
    feeds = list(feed())
    with pt.scope_guard(scope1):
        tr = time.perf_counter()
        got_step = io.load_checkpoint(exe1, step_dir, t1.program)
        restore_s = time.perf_counter() - tr
        exe1.set_step(every + 1)
        loss = exe1.run(t1.program, feed=feeds[every],
                        fetch_list=t1.fetches)[0]
        replayed = exe1.last_captured and exe1.captures == captures
    print('phase 13b restore of step %d into the live executor in %.3f s, '
          'then one step: replayed %s (captures %d -> %d), loss %r vs the '
          'run\'s step %d %r [%s]'
          % (got_step, restore_s, replayed, captures, exe1.captures,
             float(loss), every + 1, float(losses[every]), card))
    require(got_step == every, 'phase 13b: restored step %r' % got_step)
    require(replayed or not on_card,
            'phase 13b: the step after a restore captured again')
    require(np.array_equal(loss, losses[every]),
            'phase 13b: the step after the restore differs from the run')
    del t1, exe1, scope1
    if on_card:
        torch.cuda.empty_cache()
    # a fresh Trainer resumes from step `every`
    run2 = os.path.join(work, 'run2')
    os.makedirs(run2)
    shutil.copytree(step_dir, os.path.join(run2, os.path.basename(step_dir)))
    shutil.rmtree(run1)
    got = []
    scope2 = pt.Scope()
    with pt.scope_guard(scope2):
        t2 = _lifecycle_trainer(pt, place, run2, True, batch, seq, vocab,
                                dims, every)
        t2.train(num_epochs=1, event_handler=log_to(got), reader=reader())
        have = _host_copy(torch, scope2, names)
    bad = _same_bits(torch, have, want)
    same = len(got) == steps - every and all(
        np.array_equal(a, b) for a, b in zip(got, losses[every:]))
    print('phase 13b: noam(%d, 4000), Adam(0.9, 0.98, 1e-9), global-norm '
          'clip 1.0, dropout 0.1, amp bf16, checkpoints every %d steps; '
          'losses %s; resumed from step %d on a fresh Trainer, scope and '
          'executor: losses %d-%d equal bit for bit %s, %d persistables, '
          '%d differ [%s]'
          % (dims.get('d_model', 512), every,
             ['%.5f' % float(v) for v in losses], every, every + 1, steps,
             same, len(want), len(bad), card))
    require(same, 'phase 13b: resumed losses differ: %s vs %s'
            % (got, losses[every:]))
    require(not bad, 'phase 13b: resumed persistables differ: %s' % bad[:5])
    # the checkpoint's size and the saves' seconds, from the resumed scope
    with pt.scope_guard(scope2):
        d = os.path.join(work, 'sync')
        ts = time.perf_counter()
        io.save_checkpoint(t2.exe, d, t2.program, step=steps)
        sync_s = time.perf_counter() - ts
        n_bytes = sum(os.path.getsize(os.path.join(d, f))
                      for f in os.listdir(d))
        shutil.rmtree(d)
        d = os.path.join(work, 'async')
        ts = time.perf_counter()
        h = io.save_checkpoint(t2.exe, d, t2.program, step=steps,
                               async_save=True)
        async_return_s = time.perf_counter() - ts
        h.result()
        async_s = time.perf_counter() - ts
        io.verify_checkpoint(d)
        shutil.rmtree(d)
    out.update(checkpoint_bytes=n_bytes, save_sync_s=sync_s,
               save_async_return_s=async_return_s,
               save_async_done_s=async_s, restore_s=restore_s)
    print('phase 13b checkpoint: %d persistables, %d bytes; save %.3f s '
          'sync; async returns after %.3f s (the host copy), written after '
          '%.3f s; restore %.3f s; phase %.1f s [%s]'
          % (len(want), n_bytes, sync_s, async_return_s, async_s, restore_s,
             time.perf_counter() - t0, card))
    del t2, scope2
    shutil.rmtree(run2)
    return out


def phase_export(torch, pt, place, card, on_card, vocab, dims, work,
                 batch=64, src_seq=64, t_out=114):
    """Phase 13c: save_inference_model of phase 12's incremental greedy
    program (weights stacked by stack_trained_weights), then
    load_inference_model in a fresh executor and scope: the loaded
    program translates ``batch`` sentences token for token as the
    in-memory one. Returns {metric: value}."""
    from paddle_tpu_torch import io
    t0 = time.perf_counter()
    weights = _nmt_weights(pt, vocab, src_seq, dims)
    scope, _ = _nmt_scope(pt, weights, place, dims['n_layer'])
    prog, fetch = _nmt_program(pt, 'greedy', True, t_out, src_seq, vocab,
                               dims, 0)
    feed = _nmt_feed(batch, src_seq, vocab, seed=0)
    exe = pt.Executor(place)
    want = _nmt_run(pt, exe, scope, prog, fetch, feed, numpy=True)[0]
    d = os.path.join(work, 'nmt_greedy')
    ts = time.perf_counter()
    with pt.scope_guard(scope):
        io.save_inference_model(d, ['src_word', 'src_length'], fetch, exe,
                                prog)
    save_s = time.perf_counter() - ts
    n_bytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    del scope, exe
    exe2, scope2 = pt.Executor(place), pt.Scope()
    ts = time.perf_counter()
    with pt.scope_guard(scope2):
        prog2, feeds, fetch2 = io.load_inference_model(d, exe2)
    load_s = time.perf_counter() - ts
    got = None
    for _ in range(2):      # the eager warm-up, then the captured call
        got = _nmt_run(pt, exe2, scope2, prog2, fetch2,
                       {n: feed[n] for n in feeds}, numpy=True)[0]
    same = np.array_equal(got, want)
    print('phase 13c: save_inference_model of the incremental greedy '
          'program (T=%d, %d ops, %d persistables) %d bytes in %.3f s; '
          'load_inference_model in a fresh executor and scope %.3f s; %d '
          'sentences token for token equal to the in-memory program: %s '
          '(captured %s); phase %.1f s [%s]'
          % (t_out, len(prog2.global_block().ops),
             len(_persistable_names(prog2)), n_bytes, save_s, load_s, batch,
             same, exe2.last_captured, time.perf_counter() - t0, card))
    require(tuple(got.shape) == (batch, t_out), 'phase 13c: ids of shape %s'
            % (got.shape,))
    require(same, 'phase 13c: the loaded program translates otherwise')
    shutil.rmtree(d)
    del scope2, exe2
    if on_card:
        torch.cuda.empty_cache()
    return dict(export_bytes=n_bytes, export_save_s=save_s,
                export_load_s=load_s)


def _compare_places(torch, pt, places, build, feed, steps=3):
    """``steps`` steps of the program ``build()`` makes, from the host
    startup's weights, on each place: the losses of each place."""
    from paddle_tpu_torch.weights import load_into_scope
    pt.reset_default_programs()
    loss = build()
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    out = []
    for place in places:
        scope, exe = pt.Scope(), pt.Executor(place)
        load_into_scope(weights, scope, place)
        with pt.scope_guard(scope):
            out.append([float(np.asarray(exe.run(
                feed=feed, fetch_list=[loss])[0]).reshape(()))
                for _ in range(steps)])
    return out


def phase_lifecycle_vs_host(torch, pt, places, card, steps=3):
    """Phase 13d: card against host (TF32 off) for 3 steps from the same
    weights: fit_a_line with SGD + L2Decay(1e-4) + exponential_decay, and
    a 2-layer Transformer at d_model 64 with noam + a global-norm clip +
    L1Decay: each loss within 1e-5 relative."""
    from paddle_tpu_torch.models import transformer as T
    rng = np.random.RandomState(0)
    xs = rng.randn(64, 13).astype('float32')
    line_feed = {'x': xs, 'y': (xs @ rng.randn(13, 1).astype('float32') +
                                0.5).astype('float32')}

    def fit_a_line():
        x = pt.layers.data(name='x', shape=[13], dtype='float32')
        y = pt.layers.data(name='y', shape=[1], dtype='float32')
        pred = pt.layers.fc(input=x, size=1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.SGD(
            learning_rate=pt.learning_rate_decay.exponential_decay(
                0.05, 2, 0.9),
            regularization=pt.regularizer.L2Decay(1e-4)).minimize(loss)
        return loss

    def transformer():
        avg_cost, _ = T.transformer_base(
            src_vocab_size=1000, trg_vocab_size=1000, src_seq_len=32,
            trg_seq_len=32, n_layer=2, n_head=4, d_key=16, d_value=16,
            d_model=64, d_inner=256, dropout_rate=0.0)
        pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(1.0))
        pt.optimizer.Adam(
            learning_rate=pt.learning_rate_decay.noam_decay(64, 4),
            beta1=0.9, beta2=0.98, epsilon=1e-9,
            regularization=pt.regularizer.L1Decay(1e-4)).minimize(avg_cost)
        return avg_cost

    for label, build, feed in (
            ('fit_a_line, SGD + L2Decay(1e-4) + exponential_decay',
             fit_a_line, line_feed),
            ('2-layer Transformer d_model 64, noam + global-norm clip 1.0 + '
             'L1Decay(1e-4)', transformer,
             T.make_fake_batch(8, 32, 32, 1000, 1000, seed=3))):
        a, b = _compare_places(torch, pt, places, build, feed, steps)
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        print('phase 13d %s, %d steps, %r vs %r: losses %s vs %s, max rel '
              '%.3g (limit 1e-5) [%s]'
              % (label, steps, places[0], places[1],
                 ['%.7f' % v for v in a], ['%.7f' % v for v in b], rel,
                 card))
        require(np.isfinite(a).all() and rel <= 1e-5,
                'phase 13d %s: card and host differ' % label)


# ------------------------------------------------------------ phase 14
# H100 SXM host link: PCIe Gen5 x16, 128 GB/s both ways (NVIDIA data
# sheet), 64 GB/s each way
HOST_LINK_BYTES_PER_S = 64e9


def _disagg_requests(spec, n, sys_len, long_prompt, short_prompt, seed=1414):
    """Phase 14's traffic: ``loadgen.phase_mix`` shapes (35 % long prompts
    with 4-8 new tokens, the rest short prompts with 48-64), 60 % of the
    prompts starting with one shared ``sys_len``-token system prompt (the
    total length kept, at least one token after it, as bench_disagg
    builds them); one request in 4 samples at temperature 0.7, each with
    its own seed."""
    from paddle_tpu_torch.serving import loadgen
    rng = np.random.RandomState(seed)
    system = rng.randint(0, spec.vocab_size, sys_len).tolist()
    reqs = []
    for i in range(n):
        plen, max_new = loadgen.phase_mix(
            rng, long_prompt_frac=0.35, short_prompt=short_prompt,
            long_prompt=long_prompt, short_new=(4, 8), long_new=(48, 64))
        if rng.rand() < 0.6:
            prompt = system + rng.randint(
                0, spec.vocab_size, max(1, plen - sys_len)).tolist()
        else:
            prompt = rng.randint(0, spec.vocab_size, plen).tolist()
        reqs.append(dict(prompt_ids=prompt, max_new_tokens=max_new,
                         temperature=0.7 if i % 4 == 3 else 0.0,
                         seed=3000 + i))
    n_long = sum(len(r['prompt_ids']) >= long_prompt[0] for r in reqs)
    n_sys = sum(r['prompt_ids'][:sys_len] == system for r in reqs)
    print('phase 14 traffic: %d requests, %d long prompts (%d-%d tokens), '
          '%d sharing the %d-token system prompt, %d sampled; %d prompt and '
          '%d new tokens' % (n, n_long, long_prompt[0], long_prompt[1],
                             n_sys, sys_len, n // 4,
                             sum(len(r['prompt_ids']) for r in reqs),
                             sum(r['max_new_tokens'] for r in reqs)))
    return reqs


def _counter(snap, name):
    return sum(v for k, v in snap['counters'].items()
               if k == name or k.startswith(name + '{'))


def _hist(snap, name):
    return snap['histograms'].get(name) or {}


def _serve_plain(spec, geom, reqs, place):
    """The reference streams: one plain engine (no prefix cache) serving
    every request at once."""
    from paddle_tpu_torch.serving.decode import DecodeEngine
    eng = DecodeEngine(spec, place=place, weights=lm_weights(spec),
                       max_queue_depth=len(reqs), **geom)
    eng.warmup()
    eng.start()
    streams = [eng.submit(**r) for r in reqs]
    out = [s.result(timeout=600) for s in streams]
    eng.shutdown()
    require(eng.free_pages() == eng.num_blocks,
            'phase 14 plain engine: pages leaked')
    return out


def _disagg_leg(torch, spec, geom, reqs, want, place, card, on_card,
                disagg, clients=16):
    """One leg: three engines with prefix_cache=True behind a PhaseRouter
    (1 prefill + 2 decode, or colocated over 3), ``reqs`` through
    loadgen.closed_loop from ``clients`` clients with every launch count at
    0 just before. Checks every stream against ``want``, no capture and no
    executor cache miss after warmup on any engine, the launches (2 L K1
    and L K4 a prefill or step of every engine; every decode replica ran
    steps) and the pools drained. Returns (launches, stats)."""
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.serving import PhaseRouter, loadgen
    from paddle_tpu_torch.serving.decode import DecodeEngine
    tag = 'disagg' if disagg else 'colocated'
    t0 = time.perf_counter()
    engines = [DecodeEngine(spec, place=place, weights=lm_weights(spec),
                            prefix_cache=True, name='%s%d' % (tag, i),
                            max_queue_depth=len(reqs), **geom)
               for i in range(3)]
    for e in engines:
        e.warmup()
    captures = [e.captures for e in engines]
    if on_card:
        require(all(c == e.warmup_signatures
                    for c, e in zip(captures, engines)),
                'phase 14 %s: warmup captured %s graphs for %d shapes'
                % (tag, captures, engines[0].warmup_signatures))
    for e in engines:
        e.start()
    pre, dec = (engines[:1], engines[1:]) if disagg else ([], engines)
    router = PhaseRouter(pre, dec, route=tag, colocated=not disagg)
    t_ready = time.perf_counter() - t0

    results = [None] * len(reqs)
    ttft, gaps, errors = [], [], []
    mu = threading.Lock()
    order = iter(range(len(reqs)))

    def do_request(rng):
        with mu:
            i = next(order)
        r = reqs[i]
        try:
            t_sub = time.perf_counter()
            stream = router.submit(r['prompt_ids'],
                                   max_new_tokens=r['max_new_tokens'],
                                   temperature=r['temperature'],
                                   seed=r['seed'], session=i % 8)
            toks, last, first, local = [], None, None, []
            for tok in stream:
                now = time.perf_counter()
                if first is None:
                    first = now
                else:
                    local.append(now - last)
                last = now
                toks.append(tok)
            results[i] = toks
            with mu:
                ttft.append(first - t_sub)
                gaps.extend(local)
            return len(toks)
        except Exception as e:  # reported and failed below
            with mu:
                errors.append('request %d: %r' % (i, e))
            raise

    steps0 = [(e.prefills, e.decode_steps) for e in engines]
    observe.reset()     # the histograms hold this leg's traffic alone
    snap0 = observe.snapshot()
    stats = loadgen.Stats()
    reset_launches()
    t_run = time.perf_counter()
    loadgen.closed_loop(do_request, stats, t_run + 900, clients,
                        requests=len(reqs))
    wall = time.perf_counter() - t_run
    launches = read_launches()
    snap1 = observe.snapshot()
    steps = [(e.prefills - a, e.decode_steps - b)
             for e, (a, b) in zip(engines, steps0)]
    runs = sum(a + b for a, b in steps)
    router.close(shutdown_replicas=True)
    require(not errors and stats.errors == 0 and stats.rejected == 0,
            'phase 14 %s: %d errors, %d rejected: %s'
            % (tag, stats.errors, stats.rejected, errors[:3]))
    diff = [i for i, (a, b) in enumerate(zip(results, want)) if a != b]
    require(not diff, 'phase 14 %s: streams %s differ from the plain '
            'engine\'s (first: %s vs %s)'
            % (tag, diff[:5], results[diff[0]][:8] if diff else None,
               want[diff[0]][:8] if diff else None))
    require([e.captures for e in engines] == captures,
            'phase 14 %s: captures %s after warmup, %s before'
            % (tag, [e.captures for e in engines], captures))
    misses = _counter(snap1, 'executor.cache_miss_total') - \
        _counter(snap0, 'executor.cache_miss_total')
    require(misses == 0, 'phase 14 %s: %d executor cache misses after '
            'warmup' % (tag, misses))
    for e in engines:
        require(e.free_pages() == e.num_blocks,
                'phase 14 %s: %s holds %d of %d pages after shutdown'
                % (tag, e.name, e.num_blocks - e.free_pages(),
                   e.num_blocks))
    for e, (_, n_dec) in zip(engines, steps):
        if e in dec:
            require(n_dec > 0, 'phase 14 %s: decode replica %s ran no '
                    'decode step' % (tag, e.name))
    layers = spec.n_layer
    # decode steps on fp32 arenas fold the KV write into K4's launch;
    # prefills launch the stand-alone write
    folds = layers * sum(b for e, (_, b) in zip(engines, steps)
                         if e.kv_dtype == 'float32')
    if on_card:
        require(launches['layer_norm'] == 2 * layers * runs and
                launches['paged_attention'] == layers * runs and
                launches['paged_attention_write'] == folds and
                launches['kv_write'] == layers * runs - folds,
                'phase 14 %s: launches %s do not match %d prefills and '
                'steps of the three engines, %d of them with the KV write '
                'folded into K4\'s launch, the others with the stand-alone '
                'write' % (tag, launches, runs, folds))
    n_tok = sum(len(r) for r in results)
    stats_out = dict(
        tokens_per_s=n_tok / wall, wall_s=wall, ready_s=t_ready,
        ttft_p50_ms=1e3 * _pct(ttft, 50), ttft_p99_ms=1e3 * _pct(ttft, 99),
        itl_p50_ms=1e3 * _pct(gaps, 50), itl_p99_ms=1e3 * _pct(gaps, 99),
        steps=steps, misses=misses)
    print('phase 14 %s (%s): %d requests from %d clients, %d tokens in '
          '%.3f s: %.1f tokens/s; TTFT p50 %.1f ms p99 %.1f ms; inter-token '
          'p50 %.2f ms p99 %.2f ms; (prefills, decode steps) by engine %s; '
          'launches layer_norm %d = 2*%d*%d, paged_attention %d = %d*%d; '
          'built and warmed in %.1f s [%s]'
          % (tag, 'PhaseRouter(1 prefill, 2 decode)' if disagg else
             'PhaseRouter(colocated=True) over 3', len(reqs), clients, n_tok,
             wall, stats_out['tokens_per_s'], stats_out['ttft_p50_ms'],
             stats_out['ttft_p99_ms'], stats_out['itl_p50_ms'],
             stats_out['itl_p99_ms'], steps, launches['layer_norm'], layers,
             runs, launches['paged_attention'], layers, runs, t_ready, card))
    if disagg:
        d = {k: _counter(snap1, k) - _counter(snap0, k) for k in (
            'handoff.count_total', 'handoff.bytes_total',
            'handoff.pages_exported_total', 'handoff.pages_installed_total',
            'handoff.pages_deduped_total', 'handoff.pages_dropped_total',
            'handoff.empty_exports_total')}
        require(d['handoff.count_total'] > 0, 'phase 14: no handoff')
        require(d['handoff.pages_deduped_total'] > 0,
                'phase 14: no page deduplicated across the hop')
        ex, ins, hop = (_hist(snap1, 'handoff.export_seconds'),
                        _hist(snap1, 'handoff.install_seconds'),
                        _hist(snap1, 'handoff.seconds'))
        n = d['handoff.count_total']
        stats_out.update(
            handoffs=n, pages_exported=d['handoff.pages_exported_total'],
            pages_installed=d['handoff.pages_installed_total'],
            pages_deduped=d['handoff.pages_deduped_total'],
            pages_dropped=d['handoff.pages_dropped_total'],
            empty_exports=d['handoff.empty_exports_total'],
            bytes_per_handoff=d['handoff.bytes_total'] / n,
            bytes_per_page=d['handoff.bytes_total'] /
            d['handoff.pages_exported_total'],
            export_ms_p50=1e3 * ex['p50'], export_ms_p99=1e3 * ex['p99'],
            install_ms_p50=1e3 * ins['p50'], install_ms_p99=1e3 * ins['p99'],
            hop_ms_p50=1e3 * hop['p50'], hop_ms_p99=1e3 * hop['p99'],
            wire_gb_per_s=d['handoff.bytes_total'] / hop['sum'] / 1e9)
        # the export and install seconds split into the wait for the arena
        # lock and the copies under it (DecodeEngine read/write_pages)
        split = {}
        for op, whole in (('read', ex), ('write', ins)):
            wait = _hist(snap1, 'decode.arena_wait_seconds{op=%s}' % op)
            copy = _hist(snap1, 'decode.page_copy_seconds{op=%s}' % op)
            split[op] = dict(
                n=wait.get('count', 0), wait_ms_p50=1e3 * wait['p50'],
                wait_ms_p99=1e3 * wait['p99'], copy_ms_p50=1e3 * copy['p50'],
                copy_ms_p99=1e3 * copy['p99'],
                whole_ms_sum=1e3 * whole['sum'],
                wait_ms_sum=1e3 * wait['sum'], copy_ms_sum=1e3 * copy['sum'])
            split[op]['rest_ms_sum'] = (split[op]['whole_ms_sum'] -
                                        split[op]['wait_ms_sum'] -
                                        split[op]['copy_ms_sum'])
        stats_out['split'] = split
        print('phase 14 handoff: %d hops (%d prompts under a page), pages '
              'exported %d, installed %d, deduped %d, dropped %d; %.0f B a '
              'handoff, %.0f B a page (%s); export p50 %.3f ms p99 %.3f ms, '
              'install p50 %.3f ms p99 %.3f ms, whole hop p50 %.3f ms p99 '
              '%.3f ms; %.3f GB/s over the hop [%s]'
              % (n, d['handoff.empty_exports_total'],
                 stats_out['pages_exported'], stats_out['pages_installed'],
                 stats_out['pages_deduped'], stats_out['pages_dropped'],
                 stats_out['bytes_per_handoff'], stats_out['bytes_per_page'],
                 engines[0].kv_dtype, stats_out['export_ms_p50'],
                 stats_out['export_ms_p99'], stats_out['install_ms_p50'],
                 stats_out['install_ms_p99'], stats_out['hop_ms_p50'],
                 stats_out['hop_ms_p99'], stats_out['wire_gb_per_s'], card))
        for op, what in (('read', 'export'), ('write', 'install')):
            sp = split[op]
            print('phase 14 %s split (%d page %ss): arena-lock wait p50 %.3f '
                  'ms p99 %.3f ms, copies under the lock p50 %.3f ms p99 '
                  '%.3f ms; summed over the leg: %s %.3f ms = wait %.3f + '
                  'copies %.3f + the rest %.3f [%s]'
                  % (what, sp['n'], op, sp['wait_ms_p50'], sp['wait_ms_p99'],
                     sp['copy_ms_p50'], sp['copy_ms_p99'], what,
                     sp['whole_ms_sum'], sp['wait_ms_sum'],
                     sp['copy_ms_sum'], sp['rest_ms_sum'], card))
    del engines, pre, dec, router
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return launches, stats_out


def _equal_bits(torch, a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _packet_roundtrip(torch, spec, geom, prompt, place, card, on_card):
    """Export, to_bytes, from_bytes, install into a fresh engine, then
    read_pages: bit for bit at fp32, bf16, int8 and fp8 arenas (scales
    included), the wire bytes those of the shapes. At fp32, read_pages and
    write_pages of the prompt's pages timed (host clock, each call ends in
    a synchronize) beside their bound. Returns {dtype: numbers}."""
    from paddle_tpu_torch.serving import KVPacket, handoff
    from paddle_tpu_torch.serving.decode import DecodeEngine, kv_page_bytes
    out = {}
    for kv_dtype in ('float32', 'bfloat16', 'int8', 'float8_e4m3fn'):
        src, dst = [DecodeEngine(spec, place=place, weights=lm_weights(spec),
                                 prefix_cache=True, kv_dtype=kv_dtype,
                                 **geom) for _ in range(2)]
        src.start()
        src.generate(prompt, max_new_tokens=1, timeout=300)
        pkt = handoff.export_packet(src, prompt)
        wire = pkt.to_bytes()
        back = KVPacket.from_bytes(wire)
        covered, installed, dedup = handoff.install_packet(dst, back)
        n_pages = len(prompt) // geom['block_size']
        require((covered, installed, dedup) ==
                (n_pages * geom['block_size'], n_pages, 0),
                'phase 14 round trip %s: install gave %s'
                % (kv_dtype, (covered, installed, dedup)))
        ids, _ = dst.prefix_cache.acquire(prompt)
        got = dst.read_pages(ids)
        bad = [n for n, t in pkt.arrays.items()
               if not _equal_bits(torch, got[n], t) or
               not _equal_bits(torch, back.arrays[n], t)]
        require(not bad, 'phase 14 round trip %s: arenas %s differ from the '
                'exported packet' % (kv_dtype, bad))
        page = kv_page_bytes(spec, geom['block_size'], kv_dtype)
        require(pkt.wire_bytes() == page * n_pages,
                'phase 14 round trip %s: %d wire bytes, the shapes give %d'
                % (kv_dtype, pkt.wire_bytes(), page * n_pages))
        rec = dict(pages=n_pages, arenas=sorted(pkt.arrays),
                   bytes=pkt.wire_bytes(), bytes_per_page=page,
                   packet_bytes=len(wire))
        if kv_dtype == 'float32' and on_card:
            free = dst.pool.alloc(n_pages)
            reps = 20
            t0 = time.perf_counter()
            for _ in range(reps):
                dst.read_pages(ids)
            read_ms = (time.perf_counter() - t0) / reps * 1e3
            t0 = time.perf_counter()
            for _ in range(reps):
                dst.write_pages(free, got)
            write_ms = (time.perf_counter() - t0) / reps * 1e3
            back2 = dst.read_pages(free)
            require(all(_equal_bits(torch, back2[n], got[n]) for n in got),
                    'phase 14: write_pages then read_pages lost bits')
            dst.pool.free(free)
            n_bytes = pkt.wire_bytes()
            # the gather reads and writes the pages on the card, and the
            # host link carries them once
            hbm_ms = 2 * n_bytes / HBM_BYTES_PER_S * 1e3
            link_ms = n_bytes / HOST_LINK_BYTES_PER_S * 1e3
            rec.update(read_ms=read_ms, write_ms=write_ms,
                       bound_ms=max(hbm_ms, link_ms),
                       bound_by='host link' if link_ms >= hbm_ms else 'bytes',
                       hbm_ms=hbm_ms, link_ms=link_ms)
            print('phase 14 page copies, %d fp32 pages (%d B): read_pages '
                  '%.4f ms, write_pages %.4f ms; bound %.4f ms (%d B over '
                  'the host link at 64 GB/s; twice over HBM %.4f ms) [%s]'
                  % (n_pages, n_bytes, read_ms, write_ms, rec['bound_ms'],
                     n_bytes, hbm_ms, card))
        dst.pool.free(ids)
        src.shutdown()
        dst.shutdown()
        require(src.free_pages() == src.num_blocks and
                dst.free_pages() == dst.num_blocks,
                'phase 14 round trip %s: pages leaked' % kv_dtype)
        out[kv_dtype] = rec
        print('phase 14 round trip %s: %d pages, arenas %s, %d payload bytes '
              '(%d a page), %d on the wire; export, to_bytes, from_bytes, '
              'install, read_pages bit for bit [%s]'
              % (kv_dtype, n_pages, ', '.join(rec['arenas']), rec['bytes'],
                 page, len(wire), card))
        del src, dst
        if on_card:
            torch.cuda.empty_cache()
    ratio = out['float32']['bytes_per_page'] / out['int8']['bytes_per_page']
    print('phase 14 bytes a page: fp32 %d, bf16 %d, int8 %d, fp8 %d (fp32 / '
          'int8 %.2fx)' % (out['float32']['bytes_per_page'],
                           out['bfloat16']['bytes_per_page'],
                           out['int8']['bytes_per_page'],
                           out['float8_e4m3fn']['bytes_per_page'], ratio))
    return out


def _spread(legs, key):
    """'median [min-max]' of ``key`` over repeated legs."""
    xs = sorted(leg[key] for leg in legs)
    return '%.2f [%.2f-%.2f]' % (xs[len(xs) // 2], xs[0], xs[-1])


def phase_disagg(torch, spec, geom, place, card, on_card, n=48,
                 sys_len=256, long_prompt=(448, 512), short_prompt=(16, 64),
                 clients=16, repeats=1):
    """Phase 14: disaggregated serving. The plain engine's streams, then
    ``repeats`` times the disaggregated and the colocated leg in turn
    (each shut down before the next; every check holds on every leg),
    then the packet round trip at four arena dtypes. Returns (the legs'
    launch counts, the numbers: a list of legs a mode)."""
    from paddle_tpu_torch import observe
    t0 = time.perf_counter()
    reqs = _disagg_requests(spec, n, sys_len, long_prompt, short_prompt)
    want = _serve_plain(spec, geom, reqs, place)
    if on_card:
        torch.cuda.empty_cache()
    print('phase 14 plain engine: %d streams in %.1f s'
          % (len(want), time.perf_counter() - t0))
    observe.reset()
    observe.enable()
    leg_launches, dis, col = [], [], []
    try:
        for _ in range(repeats):
            for disagg, legs in ((True, dis), (False, col)):
                got, stats = _disagg_leg(torch, spec, geom, reqs, want,
                                         place, card, on_card, disagg,
                                         clients)
                leg_launches.append(got)
                legs.append(stats)
    finally:
        observe.disable()
        observe.reset()
    for tag, legs in (('disaggregated', dis), ('colocated', col)):
        print('phase 14 %s over %d legs, median [min-max]: %s tokens/s, '
              'TTFT p50 %s ms, p99 %s ms, inter-token p50 %s ms, p99 %s ms '
              '(a leg\'s TTFT p99 lies between its two largest of %d '
              'samples) [%s]'
              % (tag, len(legs), _spread(legs, 'tokens_per_s'),
                 _spread(legs, 'ttft_p50_ms'), _spread(legs, 'ttft_p99_ms'),
                 _spread(legs, 'itl_p50_ms'), _spread(legs, 'itl_p99_ms'),
                 len(reqs), card))
    print('phase 14 hop over %d legs, median [min-max]: export p50 %s ms, '
          'install p50 %s ms, hop p50 %s ms, hop p99 %s ms, %s GB/s [%s]'
          % (len(dis), _spread(dis, 'export_ms_p50'),
             _spread(dis, 'install_ms_p50'), _spread(dis, 'hop_ms_p50'),
             _spread(dis, 'hop_ms_p99'), _spread(dis, 'wire_gb_per_s'), card))
    for op in ('read', 'write'):
        sp = [leg['split'][op] for leg in dis]
        print('phase 14 %s split over %d legs, median [min-max], ms summed '
              'over a leg: whole %s = arena-lock wait %s + copies %s + the '
              'rest %s [%s]'
              % (op, len(sp), _spread(sp, 'whole_ms_sum'),
                 _spread(sp, 'wait_ms_sum'), _spread(sp, 'copy_ms_sum'),
                 _spread(sp, 'rest_ms_sum'), card))
    print('phase 14 legs: every stream of all %d legs equals the plain '
          'engine\'s [%s]' % (len(dis) + len(col), card))
    # the round trip's prompt: the longest request's, its full pages
    prompt = max((r['prompt_ids'] for r in reqs), key=len)
    rt_geom = dict(geom, num_blocks=max(64, 4 * geom['pages_per_seq']))
    rt = _packet_roundtrip(torch, spec, rt_geom, prompt, place, card,
                           on_card)
    secs = time.perf_counter() - t0
    print('phase 14 done in %.1f s' % secs)
    return leg_launches, dict(
        disaggregated=dis, colocated=col, round_trip=rt, seconds=secs)


# ------------------------------------------------------------ phase 15
# (leg, optimizer, atol of the card against the host): Adagrad's and
# Adam's first step on an entry is lr * g / (|g| + eps), whose slope in g
# near g = 0 is lr / eps, so a gradient entry's summation-order error
# (cuBLAS against the host's BLAS, ~1e-10 on entries ~1e-5) moves it by
# up to ~1e-4 x lr a step: 1e-3 x lr over 3 steps
CTR_OPTS = (
    ('sgd', lambda pt: pt.optimizer.SGD(0.1), 1e-6),
    ('adagrad', lambda pt: pt.optimizer.Adagrad(0.05), 1e-3 * 0.05),
    ('adam', lambda pt: pt.optimizer.Adam(1e-3, lazy_mode=True),
     1e-3 * 1e-3),
    ('momentum', lambda pt: pt.optimizer.Momentum(0.1, 0.9, lazy_mode=True),
     1e-6),
)


def _ctr_program(pt, slots, rows, opt, sparse=True):
    """Wide&Deep in the Criteo schema (``slots`` sparse slots of ``rows``
    rows, dim 16 deep and dim 1 wide tables, hidden (64, 32), 13 dense
    features) under ``opt``; ``sparse=False`` turns every table's
    sparse_grad off (the dense gradient path)."""
    from paddle_tpu_torch.models import wide_deep as W
    pt.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 15
    with pt.program_guard(main, startup):
        _, cost, _, _ = W.build(num_slots=slots, vocab_size=rows)
        if not sparse:
            for p in main.all_parameters():
                p.sparse_grad = False
        opt(pt).minimize(cost)
    return main, startup, cost


def ctr_feeds(n, slots, rows, batch, seed):
    """``n`` Wide&Deep batches: each slot's ids from a Zipf(1.1) law
    folded onto its table, 13 dense features, a click label."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = {'C%d' % i: zipf_ids(rng, (batch, 1), rows)
             for i in range(slots)}
        f['dense'] = rng.rand(batch, 13).astype('float32')
        f['label'] = rng.randint(0, 2, (batch, 1)).astype('int64')
        out.append(f)
    return out


def _ctr_steps(pt, exe, main, cost, feeds, n, cache=True):
    """``n`` steps cycling through ``feeds``; the losses as device
    tensors."""
    return [exe.run(main, feed=feeds[i % len(feeds)], fetch_list=[cost],
                    return_numpy=False, use_program_cache=cache)[0]
            for i in range(n)]


def _ctr_state(pt, main):
    return [v.name for v in main.list_vars()
            if v.persistable and not v.is_data]


def _ctr_checks(torch, pt, exe, scope, main, cost, name, names, snap, feeds,
                warmup, steps, slots, rows, place):
    """After a leg's timed run: rows no batch fed keep their bits (and fed
    rows moved), a second run from the same state gives the same bits, and
    3 captured steps from it equal 3 eager ones bit for bit."""
    first = {n: scope.find(n).clone() for n in names}
    for i in range(slots):
        fed = torch.zeros(rows, dtype=torch.bool)
        for f in feeds:
            fed[torch.from_numpy(f['C%d' % i][:, 0])] = True
        fed = fed.to(place.device())
        for n in ('emb_slot_%d' % i, 'wide_slot_%d' % i):
            t = scope.find(n)
            require(torch.equal(t[~fed], snap[n][~fed]),
                    'ctr %s: %s changed on rows no batch fed' % (name, n))
            require(not torch.equal(t[fed], snap[n][fed]),
                    'ctr %s: %s did not move on fed rows' % (name, n))
    for n in names:
        scope.find(n).copy_(snap[n])
    exe.set_step(1)
    _ctr_steps(pt, exe, main, cost, feeds[:warmup], warmup)
    _ctr_steps(pt, exe, main, cost, feeds[warmup:], steps)
    require(all(torch.equal(scope.find(n), first[n]) for n in names),
            'ctr %s: a second run from the same state differs' % name)
    del first
    ends = []
    for cache in (False, True):
        for n in names:
            scope.find(n).copy_(snap[n])
        exe.set_step(1)
        _ctr_steps(pt, exe, main, cost, feeds, 3, cache=cache)
        ends.append({n: scope.find(n).clone() for n in names})
    require(all(torch.equal(ends[0][n], ends[1][n]) for n in names),
            'ctr %s: 3 captured steps differ from 3 eager ones' % name)


def _ctr_leg(torch, pt, card, on_card, name, opt, slots, rows, batch,
             feeds, warmup, steps, sparse=True, profile=False):
    """One leg: Wide&Deep at (slots, rows, batch) under ``opt``, captured:
    ``warmup`` then ``steps`` timed steps (``feeds``, one each) with every
    launch count at 0 just before. Checks the marker (every table sparse,
    or none), the sparse_rows launches a step and the peak memory above
    the resident state; a sparse leg also runs _ctr_checks. Returns
    (launch counts, numbers, a --profile job or None: with ``profile`` the
    job keeps the leg's executor and scope)."""
    main, startup, cost = _ctr_program(pt, slots, rows, opt, sparse)
    marker = [op for op in main.global_block().ops
              if op.type == 'backward_marker'][0]
    n_sparse = len(marker.attrs['sparse_grads'])
    require(n_sparse == (2 * slots if sparse else 0),
            'ctr %s: %d tables take row-sparse gradients, want %d'
            % (name, n_sparse, 2 * slots if sparse else 0))
    place = pt.CUDAPlace(0) if on_card else pt.CPUPlace()
    exe, scope = pt.Executor(place), pt.Scope()
    names = _ctr_state(pt, main)
    t0 = time.perf_counter()
    with pt.scope_guard(scope):
        exe.run(startup)
        snap = {n: scope.find(n).clone() for n in names}
        if on_card:
            torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        resident = sum(t.numel() * t.element_size() for t in snap.values())
        step_peak = leg_peak = None
        if on_card:
            # one eager step's peak above what is resident before it (a
            # first eager step has set up cuBLAS on this stream), then the
            # state goes back to the startup's
            _ctr_steps(pt, exe, main, cost, feeds, 1, cache=False)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _ctr_steps(pt, exe, main, cost, feeds, 1, cache=False)
            torch.cuda.synchronize()
            step_peak = torch.cuda.max_memory_allocated() - base
            for n in names:
                scope.find(n).copy_(snap[n])
            exe.set_step(1)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        _ctr_steps(pt, exe, main, cost, feeds[:warmup], warmup)
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses = _ctr_steps(pt, exe, main, cost, feeds[warmup:], steps)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = read_launches()
        if on_card:
            leg_peak = torch.cuda.max_memory_allocated() - base
        losses = [float(v.float()) for v in losses]
        require(all(np.isfinite(losses)), 'ctr %s: a loss is not finite'
                % name)
        if on_card:
            require(exe.last_captured, 'ctr %s: the timed steps ran eagerly'
                    % name)
        if sparse:
            _ctr_checks(torch, pt, exe, scope, main, cost, name, names,
                        snap, feeds, warmup, steps, slots, rows, place)
        del snap
    ms = wall / steps * 1e3
    per_step = counts['sparse_rows'] / float(warmup + steps)
    tables_per_step = counts['sparse_rows_tables'] / float(warmup + steps)
    res = dict(ms_per_step=ms, examples_per_s=batch * steps / wall,
               step_peak_bytes=step_peak, leg_peak_bytes=leg_peak,
               resident_bytes=resident, sparse_rows_per_step=per_step,
               sparse_rows_tables_per_step=tables_per_step,
               setup_s=setup, first_loss=losses[0], last_loss=losses[-1])

    def mb(v):
        return '%.3f MB' % (v / 1e6) if v is not None else \
            'not measured (host)'
    print('phase 15 ctr %s (%s): %d slots x %d rows, batch %d, fp32, %d '
          'tables row-sparse: %.3f ms/step, %.1f examples/s; resident '
          'state %.3f GB; above it, an eager step peaks %s, the leg '
          '(warm-up, capture, cuBLAS workspaces, timed steps) %s; '
          'sparse_rows %.2f launches and %.2f tables a step; loss %.5f -> '
          '%.5f;%s startup %.2f s [%s]'
          % (name, 'sparse' if sparse else 'dense gradients', slots, rows,
             batch, n_sparse, ms, res['examples_per_s'], resident / 1e9,
             mb(step_peak), mb(leg_peak), per_step, tables_per_step,
             losses[0], losses[-1],
             ' unfed rows unchanged, a second run and 3 eager = 3 captured '
             'steps bit for bit;' if sparse else '', setup, card))
    if on_card and sparse:
        require(per_step == 1 and tables_per_step == 2 * slots,
                'ctr %s: %.2f sparse_rows launches and %.2f tables a step, '
                'want 1 and %d' % (name, per_step, tables_per_step,
                                   2 * slots))
        limit = rows * 16 * 4
        require(step_peak < limit, 'ctr %s: a step peaks %.1f MB above the '
                'resident state, over one deep table (%.1f MB)'
                % (name, step_peak / 1e6, limit / 1e6))
    job = None
    if profile:
        def step():
            with pt.scope_guard(scope):
                _ctr_steps(pt, exe, main, cost, feeds, 1)
        job = ('Wide&Deep %s step, %d slots x %d rows, batch %d, captured'
               % (name, slots, rows, batch), step, 5, lambda: None)
    return counts, res, job


def _ctr_compare(torch, pt, sides, feeds, atol, label, steps=3):
    """Each side, a (place, build) with build() giving a fresh (main,
    startup, cost) of the same persistables, trains ``steps`` steps from
    the first build's startup weights (drawn on the host): losses within
    rtol 1e-5 and every persistable within rtol 1e-5 / ``atol``."""
    got = []
    init = None
    for place, build in sides:
        main, startup, cost = build()
        names = _ctr_state(pt, main)
        if init is None:
            init = pt.Scope()
            with pt.scope_guard(init):
                pt.Executor(pt.CPUPlace()).run(startup)
        scope, exe = pt.Scope(), pt.Executor(place)
        for n in names:
            scope.set(n, init.find(n).clone().to(place.device()))
        with pt.scope_guard(scope):
            losses = [float(np.asarray(exe.run(
                main, feed=feeds[i % len(feeds)], fetch_list=[cost])[0])
                .reshape(())) for i in range(steps)]
        got.append((losses, {n: scope.find(n).cpu() for n in names}))
    (la, ta), (lb, tb) = got
    require(sorted(ta) == sorted(tb), 'phase 15 %s: the two programs hold '
            'other persistables' % label)
    err = max(float((ta[n] - tb[n]).abs().max()) for n in ta)
    ok = np.allclose(la, lb, rtol=1e-5) and all(
        torch.allclose(ta[n], tb[n], rtol=1e-5, atol=atol) for n in ta)
    print('phase 15 %s: %d steps, losses %s vs %s, max |diff| over every '
          'persistable %.3g (rtol 1e-5, atol %.3g): %s'
          % (label, steps, ['%.7f' % v for v in la],
             ['%.7f' % v for v in lb], err, atol,
             'ok' if ok else 'MISMATCH'))
    require(ok, 'phase 15 %s disagrees' % label)


def _recommender_program(pt):
    from paddle_tpu_torch.models import recommender as R
    pt.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 15
    with pt.program_guard(main, startup):
        cost = R.recommender()[1]
        pt.optimizer.SGD(0.2).minimize(cost)
    return main, startup, cost


def recommender_feeds(n, batch, seed):
    rng = np.random.RandomState(seed)
    vocab = {'uid': 944, 'gender': 2, 'age': 7, 'job': 21, 'mov_id': 1683,
             'category': 19}
    out = []
    for _ in range(n):
        f = {k: rng.randint(0, v, (batch, 1)).astype('int64')
             for k, v in vocab.items()}
        f['score'] = (5.0 * rng.rand(batch, 1)).astype('float32')
        out.append(f)
    return out


def phase_ctr(torch, pt, card, on_card, slots=CTR_SLOTS, rows=CTR_ROWS,
              batch=CTR_BATCH, warmup=3, steps=20, profile=False):
    """Phase 15: Wide&Deep CTR training at full width, one captured leg a
    optimizer (SGD, Adagrad, lazy Adam, lazy Momentum) and SGD with dense
    gradients (the path before row-sparse gradients), then the card
    against the host at 4 slots x 1,000 rows and batch 256 (each
    optimizer, sparse SGD against dense SGD) and the recommender at its
    defaults. Returns ({leg: launch counts}, numbers, --profile jobs:
    each leg's step, the four row-sparse legs first, with
    ``profile``)."""
    feeds = ctr_feeds(warmup + steps, slots, rows, batch, seed=15)
    runs, legs, jobs = {}, {}, []
    for name, opt, _ in CTR_OPTS:
        runs[name], legs[name], job = _ctr_leg(
            torch, pt, card, on_card, name, opt, slots, rows, batch, feeds,
            warmup, steps, profile=profile)
        jobs += [job] if job else []
        if on_card:
            torch.cuda.empty_cache()
    _, legs['sgd_dense'], job = _ctr_leg(
        torch, pt, card, on_card, 'sgd_dense', CTR_OPTS[0][1], slots, rows,
        batch, feeds, warmup, steps, sparse=False, profile=profile)
    jobs += [job] if job else []
    if on_card:
        torch.cuda.empty_cache()
    card_place = pt.CUDAPlace(0) if on_card else pt.CPUPlace()
    host = pt.CPUPlace()
    small = ctr_feeds(3, 4, 1000, 256, seed=16)
    for name, opt, atol in CTR_OPTS:
        build = lambda opt=opt: _ctr_program(pt, 4, 1000, opt)  # noqa: E731
        _ctr_compare(torch, pt, ((card_place, build), (host, build)), small,
                     atol, 'ctr %s, card vs host (4 slots x 1,000 rows, '
                     'batch 256)' % name)
    sgd = CTR_OPTS[0][1]
    _ctr_compare(torch, pt, (
        (card_place, lambda: _ctr_program(pt, 4, 1000, sgd)),
        (card_place, lambda: _ctr_program(pt, 4, 1000, sgd, sparse=False))),
        small, 1e-6, 'ctr SGD, sparse vs dense gradients on the card')
    _ctr_compare(torch, pt, ((card_place, lambda: _recommender_program(pt)),
                             (host, lambda: _recommender_program(pt))),
                 recommender_feeds(3, 256, seed=17), 1e-6,
                 'recommender (emb 32, fc 200, batch 256, SGD), card vs '
                 'host')
    return runs, legs, jobs


# ------------------------------------------------------------ phase 16
# the public layers: a Transformer-base encoder layer written by hand from
# public layers (16a) and every new and repaired op on the card (16b)
ENC_DIMS = dict(d_model=512, n_head=8, d_inner=2048)


def _encoder_program(pt, batch, seq, d_model, n_head, d_inner, dropout,
                     amp, lr=1e-3):
    """One Transformer-base encoder layer from public layers only: Q, K, V
    by fc(num_flatten_dims=2), nets.scaled_dot_product_attention, an
    output fc, the residual and layer_norm (K1); fc to 2 x d_inner,
    nets.glu, fc back, the residual and layer_norm; the loss
    reduce_mean(square(y - label)) under SGD(lr). Returns (main, startup,
    loss)."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 16
    with pt.program_guard(main, startup):
        L = pt.layers
        x = L.data(name='x', shape=[batch, seq, d_model], dtype='float32',
                   append_batch_size=False)
        label = L.data(name='label', shape=[batch, seq, d_model],
                       dtype='float32', append_batch_size=False)
        q, k, v = [L.fc(x, size=d_model, num_flatten_dims=2)
                   for _ in range(3)]
        att = pt.nets.scaled_dot_product_attention(
            q, k, v, num_heads=n_head, dropout_rate=dropout)
        h = L.layer_norm(L.elementwise_add(
            x, L.fc(att, size=d_model, num_flatten_dims=2)),
            begin_norm_axis=2)
        g = pt.nets.glu(L.fc(h, size=2 * d_inner, num_flatten_dims=2),
                        dim=-1)
        y = L.layer_norm(L.elementwise_add(
            h, L.fc(g, size=d_model, num_flatten_dims=2)), begin_norm_axis=2)
        loss = L.reduce_mean(L.square(L.elementwise_sub(y, label)))
        pt.optimizer.SGD(learning_rate=lr).minimize(loss)
    main.amp = amp
    return main, startup, loss


def _encoder_feed(batch, seq, d_model, seed=16):
    rng = np.random.RandomState(seed)
    return {'x': rng.randn(batch, seq, d_model).astype('f'),
            'label': rng.randn(batch, seq, d_model).astype('f')}


def _encoder_weights(pt, startup):
    """The startup's values on the host: {name: numpy}."""
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(startup)
    return {n: scope.numpy(n) for n in scope.keys()}


def encoder_want(steps, dropout):
    """K1's launches in ``steps`` encoder steps: 2 layer norms a step, and
    their backward, 2 kernels each; with dropout one fused dropout
    forward and backward a step (the attention weights')."""
    n = steps * (1 if dropout else 0)
    return dict(layer_norm=2 * steps, layer_norm_bwd=4 * steps,
                dropout=n, dropout_bwd=n, keep_mask=0)


def _encoder_timed(torch, pt, place, card, on_card, dims, batch, seq, amp,
                   warmup, steps):
    """The encoder layer at dropout 0, captured: ``warmup`` then ``steps``
    timed steps with every launch count at 0 before. Returns (ms a step,
    tokens/s, launches, losses)."""
    main, startup, loss = _encoder_program(pt, batch, seq, dropout=0.0,
                                           amp=amp, **dims)
    exe = pt.Executor(place)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
    feed = {n: torch.as_tensor(v).to(exe.device) for n, v in
            _encoder_feed(batch, seq, dims['d_model']).items()}
    _mode_steps(torch, pt, exe, main, scope, feed, loss, True, warmup, 0,
                on_card)
    reset_launches()
    secs, losses = _mode_steps(torch, pt, exe, main, scope, feed, loss,
                               True, 0, steps, on_card)
    launches = read_launches()
    ms = secs * 1e3 / steps
    return ms, batch * seq * steps / secs, launches, losses


def _encoder_compare(torch, pt, places, dims, batch, seq, amp, steps=3):
    """3 steps of the encoder layer from the same weights on each place;
    returns the losses of each."""
    main, startup, loss = _encoder_program(pt, batch, seq, dropout=0.0,
                                           amp=amp, **dims)
    weights = _encoder_weights(pt, startup)
    feed = _encoder_feed(batch, seq, dims['d_model'])
    from paddle_tpu_torch.weights import load_into_scope
    out = []
    for place in places:
        scope, exe = pt.Scope(), pt.Executor(place)
        load_into_scope(weights, scope, place)
        with pt.scope_guard(scope):
            out.append([float(exe.run(main, feed=feed, fetch_list=[loss])[0]
                              .reshape(())) for _ in range(steps)])
    return out


def _encoder_modes(torch, pt, place, dims, batch, seq, dropout, steps=3):
    """The encoder layer under bf16 AMP at ``dropout``: ``steps`` captured
    steps (graph replays) and ``steps`` eager ones (use_program_cache=
    False) from the same weights at the same step indices (each executor
    first runs two steps, the eager warm-up and the capture, and takes
    its state back). Returns {mode: (losses, {var: numpy}, launches of
    the ``steps`` steps)}."""
    from paddle_tpu_torch.weights import load_into_scope
    main, startup, loss = _encoder_program(pt, batch, seq, dropout=dropout,
                                           amp='bf16', **dims)
    weights = _encoder_weights(pt, startup)
    feed = _encoder_feed(batch, seq, dims['d_model'])
    res = {}
    for mode in ('captured', 'eager'):
        scope, exe = pt.Scope(), pt.Executor(place)
        load_into_scope(weights, scope, place)
        cache = mode == 'captured'
        snap = _snapshot(scope)
        with pt.scope_guard(scope):
            for _ in range(2):
                exe.run(main, feed=feed, fetch_list=[loss],
                        use_program_cache=cache)
            _restore(scope, snap)
            reset_launches()
            losses = np.array([float(exe.run(
                main, feed=feed, fetch_list=[loss],
                use_program_cache=cache)[0].reshape(()))
                for _ in range(steps)])
            launches = read_launches()
        res[mode] = (losses, {n: scope.numpy(n) for n in scope.keys()},
                     launches)
    return res


def phase_layers_encoder(torch, pt, place, card, on_card, dims=ENC_DIMS,
                         batch=64, seq=64, cmp_batch=4, warmup=3, steps=20):
    """Phase 16a: the encoder layer from public layers at fp32 (TF32 off)
    and under bf16 AMP, captured, timed, K1's launches checked exactly;
    card against host (3 steps, batch ``cmp_batch``); captured against
    eager bit for bit at dropout 0 and 0.1, dropout's launches checked at
    0.1. Returns (launch counts of the timed runs, numbers)."""
    t0 = time.perf_counter()
    runs, numbers = [], {}
    host = pt.CPUPlace()
    for amp, rtol in ((None, 1e-4), ('bf16', 2e-2)):
        label = 'bf16' if amp else 'fp32'
        ms, tok_s, launches, losses = _encoder_timed(
            torch, pt, place, card, on_card, dims, batch, seq, amp, warmup,
            steps)
        want = encoder_want(steps, 0.0)
        got = {k: launches[k] for k in want}
        print('phase 16a encoder layer from public layers (batch %d x seq '
              '%d, d_model %d, %d heads, d_inner %d, SGD), %s: %d timed '
              'steps after %d warm-up: %.3f ms/step, %.1f tokens/s; loss '
              'first %.5f last %.5f; launches %s (want %s) [%s]'
              % (batch, seq, dims['d_model'], dims['n_head'],
                 dims['d_inner'], label, steps, warmup, ms, tok_s,
                 losses[0], losses[-1], got, want, card))
        require(np.isfinite(losses).all(), 'phase 16a %s: loss not finite'
                % label)
        if on_card:
            require(got == want, 'phase 16a %s launches %s, want %s'
                    % (label, got, want))
        runs.append(launches)
        card_l, host_l = _encoder_compare(torch, pt, (place, host), dims,
                                          cmp_batch, seq, amp)
        err = float(np.max(np.abs(np.array(card_l) - host_l) /
                           np.abs(host_l)))
        print('phase 16a %s, card vs host (3 steps, batch %d x seq %d): '
              'card %s host %s, largest relative difference %.3g (rtol '
              '%g) [%s]' % (label, cmp_batch, seq, card_l, host_l, err,
                            rtol, card))
        require(err <= rtol, 'phase 16a %s: card and host losses %s, %s'
                % (label, card_l, host_l))
        numbers[label] = dict(ms=ms, tokens_per_s=tok_s, card_vs_host=err)
    for dropout in (0.0, 0.1):
        res = _encoder_modes(torch, pt, place, dims, cmp_batch, seq, dropout)
        (lc, sc, nc), (le, se, ne) = res['captured'], res['eager']
        same = np.array_equal(lc, le) and all(
            np.array_equal(sc[n].view(np.uint8), se[n].view(np.uint8))
            for n in sc)
        want = encoder_want(3, dropout)
        print('phase 16a bf16, dropout %.1f, batch %d x seq %d: 3 captured '
              'steps against 3 eager from the same state and step: losses '
              '%s / %s, every persistable bit for bit: %s; launches '
              'captured %s, eager %s (want %s) [%s]'
              % (dropout, cmp_batch, seq, list(lc), list(le), same,
                 {k: nc[k] for k in want}, {k: ne[k] for k in want}, want,
                 card))
        require(same, 'phase 16a: captured and eager differ at dropout %g'
                % dropout)
        if on_card:
            require(all(nc[k] == ne[k] == v for k, v in want.items()),
                    'phase 16a dropout %g launches %s / %s, want %s'
                    % (dropout, nc, ne, want))
    numbers['seconds'] = time.perf_counter() - t0
    return runs, numbers


# ---- parity: the edge values, the repaired faults and the tolerance
# rule of phase 16b, shared with tests/test_torch_harness.py (the port
# against the JAX package) and tests/test_torch_gpu.py (card against host)
PARITY_RTOL = 1e-6          # fp32
PARITY_FTZ = 1.2e-38        # fp32's smallest normal number, 2^-126
# NaN, +-inf, +-0, ties and halves, the clips' bounds (-1.5, 2.5, 0, 6,
# 24), leaky_relu's 0, soft_relu's 40, beyond int32 (+-3e9)
LAYERS_EDGE = np.array([
    [np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -0.5, 1.0],
    [-1.0, 1.5, -1.5, 2.5, -2.5, 6.0, 24.0, 40.0],
    [-40.0, 100.0, -100.0, 3e9, -3e9, 3.0, 3.0, 3.0],
    [1.0, 3.0, 3.0, -2.0, -2.0, 0.0, -0.0, 0.75]], np.float32)
# an input beyond this, subnormal or not finite is extreme: the
# tolerance's scale comes from the other elements (the random feeds lie
# in [-2, 2))
ORDINARY = 2.5
# where each repaired fault was, by the value of x: compared exactly
LAYERS_FAULTS = {
    'sign': lambda x: np.isnan(x),
    'gelu': lambda x: np.isinf(x),
    'cast': lambda x: ~np.isfinite(x) | (np.abs(x) > 2 ** 31),
    'pow': lambda x: np.isinf(x),
    'clip': lambda x: (x == -1.5) | (x == 2.5),
    'brelu': lambda x: (x == 0) | (x == 24),
    'relu6': lambda x: (x == 0) | (x == 6),
    'leaky_relu': lambda x: x == 0,
}


def bf16_ulp(a):
    """One bf16 ulp at |a| (8 significant bits), float64."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
                   - 7)


def ordinary(shape, *inputs):
    """The elements of an output of ``shape`` where every float input of
    that shape is 0 or a normal number at most ORDINARY in magnitude
    (every element where no input has the shape)."""
    mask = np.ones(shape, bool)
    for v in inputs:
        v = np.asarray(v)
        if v.shape == tuple(shape) and v.dtype.kind == 'f':
            a = np.abs(v.astype(np.float64))
            with np.errstate(invalid='ignore'):
                mask &= (a <= ORDINARY) & ((a == 0) | (a >= 2.0 ** -126))
    return mask


def prod_others(a, axis=None):
    """For each element of ``a``, the product of the others along
    ``axis`` (None: of every other element), from exclusive products
    left and right (float64)."""
    a = np.asarray(a, np.float64)
    flat = a.reshape(-1) if axis is None else np.moveaxis(a, axis, -1)
    one = np.ones(flat.shape[:-1] + (1,))
    with np.errstate(over='ignore', invalid='ignore'):
        left = np.cumprod(np.concatenate([one, flat[..., :-1]], -1), -1)
        right = np.cumprod(np.concatenate(
            [one, flat[..., ::-1][..., :-1]], -1), -1)[..., ::-1]
        out = left * right
    return out.reshape(a.shape) if axis is None else \
        np.moveaxis(out, -1, axis)


def parity_difference(got, want, exact=False, bf16=False, grad=False,
                      where=None, terms=0, sums=None, skip_nan=False):
    """None if ``got`` matches ``want``, else the largest difference
    outside the tolerance (inf for a NaN or an infinity placed apart or
    another shape). ``exact``: equal. An op that sums each element from
    ``terms`` terms whose magnitudes add up to ``sums`` (per element; a
    product: its magnitude): PARITY_RTOL * (|want| + terms * sums) +
    PARITY_FTZ at fp32, one bf16 ulp (of the larger of |want| and |got|)
    + PARITY_RTOL * terms * sums for a ``bf16`` value (the terms of bf16
    inputs are exact in fp32, summed there). A pointwise op:
    PARITY_RTOL * (|want| + M) + PARITY_FTZ at fp32, one bf16 ulp + 2^-8
    M in bf16 (2^-6 M for a gradient), M the largest finite |want| over
    the elements ``where`` (a mask; default all): a formula's own
    cancellation at the ordinary inputs' scale, so an extreme input's
    value (3e9) is held to its own magnitude and widens no other
    element's bound. PARITY_FTZ is for results XLA's CPU backend flushes
    to zero where torch keeps the subnormal. ``skip_nan``: an element
    NaN in ``want`` is not compared."""
    r = np.asarray(want).astype(np.float64)
    g = np.asarray(got).astype(np.float64)
    if r.shape != g.shape:
        return float('inf')
    keep = np.ones(r.shape, bool)
    if skip_nan:
        keep = ~np.isnan(r)
    special = keep & (~np.isfinite(r) | ~np.isfinite(g))
    if not np.array_equal(r[special], g[special], equal_nan=True):
        return float('inf')
    fin = keep & ~special
    err = np.abs(g[fin] - r[fin])
    if exact:
        bound = 0.0
    elif sums is not None:
        s = np.asarray(sums, np.float64)
        s = s.reshape(r.shape) if s.size == r.size else \
            np.broadcast_to(s, r.shape)
        s = np.where(np.isfinite(s), s, 0.0)[fin]
        if bf16:
            bound = bf16_ulp(np.maximum(np.abs(r[fin]), np.abs(g[fin]))) + \
                PARITY_RTOL * terms * s
        else:
            bound = PARITY_RTOL * (np.abs(r[fin]) + terms * s) + PARITY_FTZ
    else:
        pick = fin if where is None else fin & np.broadcast_to(where, r.shape)
        m = float(np.abs(r[pick]).max()) if pick.any() else 0.0
        if bf16:
            bound = bf16_ulp(np.maximum(np.abs(r[fin]), np.abs(g[fin]))) + \
                2.0 ** -8 * (4.0 if grad else 1.0) * m
        else:
            bound = PARITY_RTOL * (np.abs(r[fin]) + m) + PARITY_FTZ
    bad = err > bound
    return float(err[bad].max()) if bad.any() else None


def _op_helper(pt, op_type, inputs, out_dtype=None, slots=('Out',),
               attrs=None):
    """One ``op_type`` op on ``inputs``; its ``slots``' outputs take
    ``out_dtype`` (a dtype, or {slot: dtype} beside the first input's)."""
    from paddle_tpu_torch.layers.helper import LayerHelper
    helper = LayerHelper(op_type)
    first = next(iter(inputs.values()))
    dtypes = out_dtype if isinstance(out_dtype, dict) else \
        dict.fromkeys(slots, out_dtype)
    outs = {s: [helper.create_variable_for_type_inference(
        dtypes.get(s) or first.dtype)] for s in slots}
    helper.append_op(type=op_type, inputs={k: [v] for k, v in
                                           inputs.items()},
                     outputs=outs, attrs=attrs or {})
    return [outs[s][0] for s in slots]


def _sums_mean(f):
    a = np.abs(f['x'].astype(np.float64))
    n, d = a.shape
    return [a.mean(), a.mean(1, keepdims=True)], \
        {'x': np.full(a.shape, 1.0 / (n * d) + 1.0 / d)}


def _sums_prod(f):
    z = np.abs(0.25 * f['x'].astype(np.float64) + 1.0)
    with np.errstate(over='ignore', invalid='ignore'):
        return [z.prod(1)], {'x': 0.25 * prod_others(z, 1)}


def _sums_dot(f):
    a, b = (np.abs(f[k].astype(np.float64)) for k in ('x', 'y'))
    return [(a * b).sum(1, keepdims=True)], {'x': b, 'y': a}


def _sums_distance(f):
    d = np.abs(f['x'].astype(np.float64) - f['y'])
    # sub_result, x - y, is pointwise
    return [(d * d).sum(1, keepdims=True), None], {'x': 2 * d, 'y': 2 * d}


def layers_ops(pt):
    """[(name, build(L, v) -> outputs, exact, terms, sums)] of every op
    type this slice adds (but the two random fills) and every repaired
    op; v(k) is input k ('x', 'y', 'label' or the bools 'a', 'b');
    ``terms``: how many terms an element sums (0: pointwise); ``sums``
    (None: pointwise): a function of the feed giving the magnitudes of
    those terms, per element, as ([one array an output], {input: one
    array for its gradient}) (parity_difference)."""
    def h(op, out_dtype=None, **kw):
        return lambda L, v: _op_helper(pt, op, {'X': v('x'), 'Y': v('y')},
                                       out_dtype=out_dtype, **kw)

    def u(layer, **attrs):
        return lambda L, v: getattr(L, layer)(v('x'), **attrs)
    return [
        ('elementwise_max', lambda L, v: L.elementwise_max(v('x'), v('y')),
         True, 0, None),
        ('elementwise_min', lambda L, v: L.elementwise_min(v('x'), v('y')),
         True, 0, None),
        ('elementwise_pow', lambda L, v: L.elementwise_pow(
            L.abs(v('x')), v('y')), False, 0, None),
        ('elementwise_mod', h('elementwise_mod'), True, 0, None),
        ('elementwise_floordiv', h('elementwise_floordiv'), True, 0, None),
        ('reduce_mean', lambda L, v: [L.reduce_mean(v('x')), L.reduce_mean(
            v('x'), dim=1, keep_dim=True)], False, 512, _sums_mean),
        ('reduce_max', lambda L, v: [L.reduce_max(v('x'), dim=1),
                                     L.reduce_max(v('x'))], True, 0, None),
        ('reduce_min', lambda L, v: L.reduce_min(v('x'), dim=0,
                                                 keep_dim=True), True, 0,
         None),
        ('reduce_prod', lambda L, v: L.reduce_prod(
            L.scale(v('x'), scale=0.25, bias=1.0), dim=1), False, 512,
         _sums_prod),
        ('greater_than', h('greater_than', 'bool'), True, 0, None),
        ('greater_equal', h('greater_equal', 'bool'), True, 0, None),
        ('less_equal', h('less_equal', 'bool'), True, 0, None),
        ('not_equal', h('not_equal', 'bool'), True, 0, None),
        ('logical_and', lambda L, v: L.logical_and(v('a'), v('b')), True,
         0, None),
        ('logical_or', lambda L, v: L.logical_or(v('a'), v('b')), True, 0,
         None),
        ('logical_xor', lambda L, v: L.logical_xor(v('a'), v('b')), True,
         0, None),
        ('logical_not', lambda L, v: L.logical_not(v('a')), True, 0, None),
        ('dot', lambda L, v: L.dot(v('x'), v('y')), False, 512, _sums_dot),
        ('minus', h('minus'), True, 0, None),
        ('l1_norm', u('l1_norm'), False, 512, lambda f: (
            [np.abs(f['x']).sum()], {'x': np.ones(f['x'].shape)})),
        ('squared_l2_norm', u('squared_l2_norm'), False, 512, lambda f: (
            [np.square(f['x'].astype(np.float64)).sum()],
            {'x': 2 * np.abs(f['x'])})),
        ('squared_l2_distance', h('squared_l2_distance',
                                  slots=('Out', 'sub_result')), False, 512,
         _sums_distance),
        ('prelu', lambda L, v: [L.prelu(v('x'), mode='all'),
                                L.prelu(v('x'), mode='element')], False, 0,
         None),
        ('mish', u('mish'), False, 0, None),
        ('stanh', u('stanh'), False, 0, None),
        ('hard_shrink', u('hard_shrink'), True, 0, None),
        ('softshrink', u('softshrink'), True, 0, None),
        ('hard_sigmoid', u('hard_sigmoid'), False, 0, None),
        ('soft_relu', u('soft_relu'), False, 0, None),
        ('thresholded_relu', u('thresholded_relu'), True, 0, None),
        ('sigmoid_cross_entropy_with_logits', lambda L, v:
         L.sigmoid_cross_entropy_with_logits(v('x'), v('label')), False, 0,
         None),
        ('split', lambda L, v: L.split(v('x'), 2, dim=1) + L.split(
            v('x'), [16, v('x').shape[1] - 16], dim=-1), True, 0, None),
        ('sign', u('sign'), True, 0, None),
        ('gelu', u('gelu'), False, 0, None),
        ('cast', lambda L, v: [L.cast(v('x'), d) for d in (
            'int32', 'int16', 'int8', 'uint8', 'bool')], True, 0, None),
        ('pow', u('pow', factor=0.5), False, 0, None),
        ('clip', lambda L, v: L.clip(v('x'), -1.5, 2.5), True, 0, None),
        ('brelu', u('brelu', t_min=0.0, t_max=24.0), True, 0, None),
        ('relu6', u('relu6'), True, 0, None),
        ('leaky_relu', u('leaky_relu'), False, 0, None),
    ]


def _layers_ops_program(pt, n, d, amp, cases_of=layers_ops, extra=()):
    """Every op of ``cases_of(pt)`` (layers_ops: phase 16b's) on [n, d] in
    one program: each float input through its own -0.0 probe (x + -0.0 is
    x bit for bit; the probe's gradient is the op's at x), cast to bf16
    under amp; the loss sums reduce_sum of every float output. ``extra``:
    (name, shape, dtype) of further data inputs, read unprobed, or (name,
    shape, dtype, True): probed like x at their own shape. Returns
    (main, startup, [(name, exact, terms, sums, fetch names, [(input,
    gradient name)])])."""
    main, startup = pt.Program(), pt.Program()
    cases = []
    with pt.program_guard(main, startup):
        L = pt.layers

        def data(name, dtype='float32', shape=(n, d)):
            return L.data(name=name, shape=list(shape), dtype=dtype,
                          append_batch_size=False)
        xs = {k: data(k) for k in ('x', 'y', 'label')}
        xs.update(a=data('a', 'bool'), b=data('b', 'bool'))
        xs.update({e[0]: data(e[0], e[2], e[1]) for e in extra})
        shapes = dict.fromkeys(('x', 'y', 'label'), (n, d))
        shapes.update({e[0]: e[1] for e in extra if e[3:] == (True,)})
        sums = []
        for name, build, exact, terms, sums_of in cases_of(pt):
            probed, grads = {}, []

            def v(k, name=name, probed=probed, grads=grads):
                if k not in shapes:
                    return xs[k]
                if k not in probed:
                    probe = L.create_parameter(
                        shape=list(shapes[k]), dtype='float32',
                        name='%s_%s_probe' % (name, k),
                        default_initializer=pt.initializer.Constant(-0.0))
                    val = L.elementwise_add(xs[k], probe)
                    probed[k] = L.cast(val, 'bfloat16') if amp else val
                    grads.append((k, probe.name + '@GRAD'))
                return probed[k]
            outs = build(L, v)
            outs = outs if isinstance(outs, list) else [outs]
            floats = [o for o in outs if o.dtype in ('float32', 'bfloat16')]
            sums += [L.reduce_sum(L.cast(o, 'float32')) for o in floats]
            cases.append((name, exact, terms, sums_of,
                          [o.name for o in outs], grads if floats else []))
        loss = L.sums(sums)
        grads = pt.backward.append_backward(loss)
    used = {g.name for _, g in grads}
    cases = [c[:5] + ([(k, g) for k, g in c[5] if g in used],)
             for c in cases]
    main.amp = amp
    return main, startup, cases


def layers_ops_feed(n, d, seed=16):
    """x, y, label and two bool inputs of [n, d]: x and y uniform in
    [-2, 2) with the edge values and two subnormals (+-1e-40) at x's head
    (and y holding x's values at a quarter of the positions: ties), label
    in [0, 1]."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2.0, 2.0, (n, d)).astype('f')
    head = np.concatenate([LAYERS_EDGE.ravel(), [1e-40, -1e-40]])
    x.reshape(-1)[:head.size] = head
    y = np.roll(x, 3, axis=1)
    y[:, ::4] = x[:, ::4]
    return {'x': x, 'y': y, 'label': rng.rand(n, d).astype('f'),
            'a': rng.rand(n, d) > 0.5, 'b': rng.rand(n, d) > 0.5}


def _where_apart(got, want, feed, k=4):
    """The first ``k`` elements where got and want differ, with x and y
    there when they have the output's shape."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    apart = ~((g == w) | (np.isnan(g) & np.isnan(w)))
    out = []
    for i in np.argwhere(apart)[:k]:
        i = tuple(i)
        xy = ['%s=%r' % (n, feed[n][i]) for n in ('x', 'y')
              if n in feed and feed[n].shape == g.shape]
        out.append('at %s %s card %r host %r' % (i, ' '.join(xy), g[i],
                                                 w[i]))
    return ('; ' + '; '.join(out)) if out else ''


def _numpy_all(torch, values):
    return [v.float().cpu().numpy() if v.is_floating_point() else
            v.cpu().numpy() for v in values]


def _ops_card_vs_host(torch, pt, place, on_card, n, d, amp, feed, worst,
                      faults, label, cases_of=layers_ops, extra=(),
                      faults_at=None, phase='16b', times=None):
    """The program of ``cases_of`` (_layers_ops_program) run on ``place``
    (twice: captured on the card) and on the CPU place; every output and
    probe gradient held card against host by parity_difference (its
    scale from the ordinary elements of x and y), a repaired fault's
    elements (LAYERS_FAULTS, by ``faults_at``'s values) exactly. Appends
    to ``faults``, raises ``worst`` (an op's largest relative difference,
    absolute below 1); with ``times``, sets times[label] to the card's ms
    a replay of the captured program (its feed on the card). Returns
    (outputs and gradients compared, cases)."""
    compared = 0
    main, startup, cases = _layers_ops_program(pt, n, d, amp, cases_of,
                                               extra)
    fetch = [f for c in cases for f in c[4] + [g for _, g in c[5]]]
    res = {}
    for mode, pl in (('card', place), ('host', pt.CPUPlace())):
        exe = pt.Executor(pl)
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            for _ in range(2 if mode == 'card' else 1):
                out = exe.run(main, feed=feed, fetch_list=fetch,
                              return_numpy=False)
            if mode == 'card' and on_card:
                require(exe.last_captured, 'phase %s %s: the ops program '
                        'did not run captured' % (phase, label))
                if times is not None:
                    on = {k: torch.as_tensor(v).to(exe.device)
                          for k, v in feed.items()}
                    exe.run(main, feed=on, fetch_list=fetch,
                            return_numpy=False)
                    times[label] = _events_ms(torch, lambda: [
                        exe.run(main, feed=on, fetch_list=fetch,
                                return_numpy=False) for _ in range(3)], 3)
        res[mode] = dict(zip(fetch, _numpy_all(torch, out)))
    for name, exact, terms, sums_of, outs, grads in cases:
        s_outs, s_grads = sums_of(feed) if sums_of else ([], {})
        for i, f in enumerate(outs + [g for _, g in grads]):
            g, w = res['card'][f], res['host'][f]
            grad = i >= len(outs)
            sums = None
            if sums_of:
                sums = s_grads.get(grads[i - len(outs)][0]) if grad else \
                    s_outs[i] if i < len(s_outs) else None
            bf16 = amp is not None and w.dtype == np.float32
            # mod's gradient for y is -trunc(x / y): exact only where the
            # two quotients round alike
            ex = exact and not (grad and name == 'elementwise_mod')
            diff = parity_difference(
                g, w, ex, bf16, grad, terms=terms, sums=sums,
                where=ordinary(w.shape, *[feed[k] for k in ('x', 'y')
                                          if k in feed]))
            if diff is not None:
                faults.append('%s %s %s: card and host differ by %r%s'
                              % (label, name, f, diff,
                                 _where_apart(g, w, feed)))
            if faults_at is not None and name in LAYERS_FAULTS and \
                    g.shape == faults_at.shape:
                at = LAYERS_FAULTS[name](faults_at)
                if not np.array_equal(g[at], w[at], equal_nan=True):
                    faults.append('%s %s %s: card %s host %s at %s'
                                  % (label, name, f, g[at], w[at],
                                     faults_at[at]))
            # relative where |host| >= 1, absolute below
            with np.errstate(invalid='ignore'):
                err = np.abs(g.astype(np.float64) - w) / np.maximum(
                    np.abs(w.astype(np.float64)), 1.0)
            fin = np.isfinite(err)
            worst[name] = max(worst.get(name, 0.0),
                              float(err[fin].max()) if fin.any() else 0.0)
            compared += 1
    return compared, len(cases)


def phase_layers_ops(torch, pt, place, card, on_card, n=4096, d=512):
    """Phase 16b: every new op and every repaired op in one captured
    program at [n, d], fp32 and bf16 AMP, on the card against the CPU
    place (forward and each op's gradient through reduce_sum, at the
    harness's tolerances, parity_difference, whose scale comes from the
    ordinary elements: the edge values' outputs are held to their own
    magnitude; the repaired faults exactly where they were),
    then the two *_batch_size_like draws eagerly (shape, range, moments,
    same-seed repeatability). Returns its numbers."""
    t0 = time.perf_counter()
    feed = layers_ops_feed(n, d)
    x = feed['x']
    worst, total, faults = {}, 0, []
    for amp in (None, 'bf16'):
        label = 'bf16' if amp else 'fp32'
        compared, cases = _ops_card_vs_host(
            torch, pt, place, on_card, n, d, amp, feed, worst, faults,
            label, faults_at=x)
        print('phase 16b %s: %d op types in one captured program at [%d, '
              '%d] with the edge values: %d outputs and gradients card '
              'against host, %d outside the harness tolerances or, for a '
              'repaired fault, not exact [%s]'
              % (label, cases, n, d, compared, len(faults), card))
        total += compared
    require(not faults, 'phase 16b: %d differences:\n  %s'
            % (len(faults), '\n  '.join(faults)))
    # the random fills: host-bound, so eager; bits diverge by design
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 16
    with pt.program_guard(main, startup):
        L = pt.layers
        xv = L.data(name='x', shape=[n, d], dtype='float32',
                    append_batch_size=False)
        u = L.uniform_random_batch_size_like(xv, [1, 256], min=-0.5,
                                             max=2.0)
        gs = L.gaussian_random_batch_size_like(xv, [1, 256], mean=1.0,
                                               std=2.0)
    draws = []
    for _ in range(2):
        exe = pt.Executor(place)
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            draws.append([_numpy_all(torch, exe.run(
                main, feed={'x': x}, fetch_list=[u, gs],
                return_numpy=False)) for _ in range(2)])
    (u0, g0), (u1, g1) = draws[0]
    # within 5 standard errors of the law's mean and std
    m = float(u0.size)
    ok = (u0.shape == g0.shape == (n, 256) and u0.min() >= -0.5 and
          u0.max() < 2.0 and
          abs(u0.mean() - 0.75) < 5 * 2.5 / np.sqrt(12 * m) and
          abs(g0.mean() - 1.0) < 5 * 2.0 / np.sqrt(m) and
          abs(g0.std() - 2.0) < 5 * 2.0 / np.sqrt(2 * m) and
          all(np.array_equal(p, q) for p, q in zip(draws[0][0],
                                                   draws[1][0])) and
          all(np.array_equal(p, q) for p, q in zip(draws[0][1],
                                                   draws[1][1])) and
          not np.array_equal(u0, u1) and not np.array_equal(g0, g1))
    print('phase 16b *_batch_size_like on the card: shape %s, uniform in '
          '[%.4f, %.4f] mean %.4f, gaussian mean %.4f std %.4f; the same '
          'draws from a second executor at the same steps, new ones at the '
          'next step: %s [%s]' % (u0.shape, u0.min(), u0.max(), u0.mean(),
                                  g0.mean(), g0.std(), ok, card))
    require(ok, 'phase 16b: the *_batch_size_like draws')
    return dict(ops_compared=total, seconds=time.perf_counter() - t0,
                largest_card_host_difference=worst)

# ------------------------------------------------------------ phase 17
# the staging ring (17a: the Transformer's Trainer, 17b: the CTR step) and
# the rest of the tensor, nn, random and misc op modules (17c)
STAGE_W = 4             # the staging ring's window, in steps


def _reusing(reader):
    """``reader`` whose items land in one buffer a feed, overwritten at
    every yield (as a reader over recordio slots does)."""
    def out():
        bufs = None
        for item in reader():
            if bufs is None:
                bufs = {k: np.empty_like(v) for k, v in item.items()}
            for k, v in item.items():
                bufs[k][...] = v
            yield bufs
    return out


def phase_staging_trainer(torch, pt, place, card, on_card, batch, seq,
                          vocab, dims, steps=24):
    """Phase 17a: phase 13a's Trainer (transformer_base, dropout 0.1,
    Adam(1e-4), bf16 AMP, the _bench_reader batches), 2 epochs of
    ``steps`` batches from the same weights, epoch 1 timed, fed three
    ways: host stacking (steps_per_dispatch=4), the staging ring
    (reader.staged_superbatch(reader, 4) into train(stacked_windows=True))
    and reader.prefetch_to_device at pipeline depth 2 over a reader that
    overwrites its output buffer after every yield. Checks that the three
    end on the same parameters and losses bit for bit, the launches of
    K1, K2, K3 and the fused dropout a step (train_want), that every ring
    slot was page-locked before its first copy and that the ring's gauges
    end at 0 occupancy. Returns (the ring leg's timed launches,
    numbers)."""
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.models import transformer as T
    t_phase = time.perf_counter()
    layers = dims.get('n_layer', 6)
    reader = _bench_reader(batch, seq, vocab, steps)
    staged = pt.reader.staged_superbatch(reader, STAGE_W, place=place)
    legs = (('host stacking', reader, dict(steps_per_dispatch=STAGE_W)),
            ('staging ring', staged, dict(steps_per_dispatch=STAGE_W,
                                          stacked_windows=True)),
            ('prefetch_to_device', pt.reader.prefetch_to_device(
                _reusing(reader), place=place), dict(pipeline_depth=2)))

    def train_func():
        avg_cost, _ = T.transformer_base(
            src_vocab_size=vocab, trg_vocab_size=vocab, src_seq_len=seq,
            trg_seq_len=seq, max_length=max(256, seq), **dims)
        return [avg_cost]

    numbers, first, ring_launches = {}, None, None
    for leg, leg_reader, kw in legs:
        pt.reset_default_programs()
        state, losses = {}, []

        def handler(e):
            if isinstance(e, pt.BeginEpochEvent) and e.epoch == 1:
                _sync(torch, on_card)
                reset_launches()
                state['t0'] = time.perf_counter()
            elif isinstance(e, pt.EndEpochEvent) and e.epoch == 1:
                _sync(torch, on_card)
                state['t1'] = time.perf_counter()
                state['launches'] = read_launches()
            elif isinstance(e, pt.EndStepEvent):
                losses.append(np.asarray(e.metrics[0]).copy())

        scope = pt.Scope()
        with pt.scope_guard(scope):
            trainer = pt.Trainer(
                train_func=train_func,
                optimizer_func=lambda: pt.optimizer.Adam(learning_rate=1e-4),
                place=place)
            trainer.program.amp = 'bf16'
            trainer.train(num_epochs=2, event_handler=handler,
                          reader=leg_reader, **kw)
            params = _host_copy(torch, scope, _persistable_names(
                trainer.program))
        ms = (state['t1'] - state['t0']) * 1e3 / steps
        numbers[leg] = ms
        launches = state['launches']
        want = train_want(layers, steps)
        per_step = {k: launches[k] / steps for k in want
                    if not k.endswith('_simt') and not k.endswith('_mma')}
        print('phase 17a %s: epoch 1, %d steps: %.3f ms/step; launches a '
              'step %s [%s]' % (leg, steps, ms, per_step, card))
        require(len(losses) == 2 * steps and
                all(np.isfinite(v).all() for v in losses),
                'phase 17a %s: %d losses, not all finite' % (leg,
                                                             len(losses)))
        if on_card:
            require(all(launches[k] == n for k, n in want.items()),
                    'phase 17a %s launches %s, want %s'
                    % (leg, {k: launches[k] for k in want}, want))
        if leg == 'staging ring':
            ring_launches = launches
        if first is None:
            first, first_losses = params, losses
        else:
            bad = _same_bits(torch, params, first)
            same = all(np.array_equal(a, b)
                       for a, b in zip(losses, first_losses))
            print('phase 17a %s vs host stacking: %d persistables, %d '
                  'differ; %d losses equal bit for bit: %s'
                  % (leg, len(first), len(bad), len(losses), same))
            require(not bad and same, 'phase 17a: %s ends elsewhere than '
                    'host stacking (%s)' % (leg, bad[:5]))
        del trainer, scope, params
        if on_card:
            torch.cuda.empty_cache()
    # one more pass of the ring with telemetry on: its gauges and counters
    observe.reset()
    observe.enable()
    try:
        windows = sum(1 for _ in staged())
        gauges = (observe.get_gauge('reader.staging_ring_occupancy'),
                  observe.get_gauge('reader.staging_ring_slots'),
                  observe.get_counter('reader.staging_windows_produced_total'),
                  observe.get_counter('reader.staging_windows_consumed_total'))
    finally:
        observe.disable()
        observe.reset()
    stats = staged.stats
    pinned_ok = stats['slots_pinned'] == (
        stats['rings'] * min(3, steps // STAGE_W) if on_card else 0)
    print('phase 17a ring: %d rings of 3 slots, %d slots page-locked before '
          'their first copy (%.3f ms each), %d windows; with telemetry: '
          'occupancy %s at the end, slots %s, windows produced %s consumed '
          '%s' % (stats['rings'], stats['slots_pinned'],
                  stats['pin_seconds'] * 1e3 / max(stats['slots_pinned'], 1),
                  stats['windows'], gauges[0], gauges[1], gauges[2],
                  gauges[3]))
    require(pinned_ok and gauges == (0, 3, windows, windows) and
            windows == steps // STAGE_W,
            'phase 17a: the ring %s, gauges %s' % (stats, gauges))
    numbers.update(ring=dict(stats), seconds=time.perf_counter() - t_phase)
    return ring_launches, numbers


def _busy_ms(torch, run, steps):
    """Under torch.profiler, ``run()`` (``steps`` steps): the device busy
    ms a step (its kernels' and copies' summed durations), the host's ms
    a step inside cudaGraphLaunch, the host-to-device and device-to-host
    copies a step, and the device kernels a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.end - e.time_range.start for e in device)
    launch = sum(a.self_cpu_time_total for a in prof.key_averages()
                 if a.key.startswith('cudaGraphLaunch'))
    h2d = sum(1 for e in device if e.name.startswith('Memcpy HtoD'))
    d2h = sum(1 for e in device if e.name.startswith('Memcpy DtoH'))
    kernels = sum(1 for e in device if not e.name.startswith('Memcpy') and
                  not e.name.startswith('Memset'))
    return (busy / steps / 1e3, launch / steps / 1e3, h2d / float(steps),
            d2h / float(steps), kernels / float(steps))


def phase_staging_ctr(torch, pt, card, on_card, slots=CTR_SLOTS,
                      rows=CTR_ROWS, batch=CTR_BATCH, steps=48, warmup=3):
    """Phase 17b: phase 15's Wide&Deep step under SGD (26 slots x 10^6
    rows, batch 4,096, captured), ``steps`` batches from the same state
    three ways: step by step (Executor.run, each feed from the host), as
    windows of 4 from reader.staged_superbatch through
    Executor.run_steps(stacked_feed=True), and as the same windows
    already on the card (taken from the ring first) through run_steps
    alone. The three end on the same parameters and losses bit for bit.
    Wall ms a step of each (the ring's with its 3 slots page-locked at
    its start, each a cudaHostRegister of 4.4 MB, and split into the host
    ms a step spent getting windows from the ring and in run_steps), the
    sparse_rows launches a step and, last, under torch.profiler, the
    device busy ms a step, the host ms a step in cudaGraphLaunch and the
    copies to and from the host a step (none for the windows on the
    card: a window already there adds no host round trip). Returns
    (numbers, the ring leg's launch counts)."""
    t_phase = time.perf_counter()
    main, startup, cost = _ctr_program(pt, slots, rows, CTR_OPTS[0][1])
    place = pt.CUDAPlace(0) if on_card else pt.CPUPlace()
    feeds = ctr_feeds(warmup + steps, slots, rows, batch, seed=17)
    warm, timed = feeds[:warmup], feeds[warmup:]
    exe, scope = pt.Executor(place), pt.Scope()
    names = _ctr_state(pt, main)
    staged = pt.reader.staged_superbatch(lambda: iter(timed), STAGE_W,
                                         place=place)
    split = {}

    def by_step():
        return [exe.run(main, feed=f, fetch_list=[cost],
                        return_numpy=False)[0] for f in timed]

    def windows(source):
        out, it = [], iter(source)
        split.update(next=0.0, run_steps=0.0)
        while True:
            t0 = time.perf_counter()
            w = next(it, None)
            t1 = time.perf_counter()
            if w is None:
                return out
            out += list(exe.run_steps(STAGE_W, main, feed=w,
                                      fetch_list=[cost], return_numpy=False,
                                      stacked_feed=True)[0])
            split['next'] += t1 - t0
            split['run_steps'] += time.perf_counter() - t1

    res, numbers = {}, {}
    with pt.scope_guard(scope):
        exe.run(startup)
        snap = {n: scope.find(n).clone() for n in names}
        _ctr_steps(pt, exe, main, cost, warm, warmup)
        on_device = list(staged())
        legs = (('step by step', by_step),
                ('staging ring', lambda: windows(staged())),
                ('windows on the card', lambda: windows(on_device)))

        def from_snapshot():
            for n in names:
                scope.find(n).copy_(snap[n])
            exe.set_step(1 + warmup)
        for leg, run in legs:
            from_snapshot()
            _sync(torch, on_card)
            reset_launches()
            t0 = time.perf_counter()
            losses = run()
            _sync(torch, on_card)
            wall = (time.perf_counter() - t0) * 1e3 / steps
            launches = read_launches()
            if leg == 'staging ring':
                counts = launches
            if on_card:
                require(exe.last_captured, 'phase 17b %s: the steps ran '
                        'eagerly' % leg)
            # compared where they are: a host copy of 1.8 GB a leg costs
            # seconds
            res[leg] = (torch.stack(losses),
                        {n: scope.find(n).clone() for n in names})
            numbers[leg] = dict(wall_ms=wall, sparse_rows_per_step=(
                launches['sparse_rows'] / float(steps)))
            if leg != 'step by step':
                numbers[leg].update({'host_%s_ms' % k: v * 1e3 / steps
                                     for k, v in split.items()})
        la, pa = res['step by step']
        for leg in ('staging ring', 'windows on the card'):
            lb, pb = res[leg]
            bad = _same_bits(torch, pb, pa)
            require(not bad and torch.equal(la, lb) and len(lb) == steps,
                    'phase 17b: %s ends elsewhere than step by step (%s)'
                    % (leg, bad[:5]))
        n_state = len(pa)
        del res, la, pa, lb, pb
        if on_card:
            for leg, run in legs:
                from_snapshot()
                busy, launch, h2d, d2h, _ = _busy_ms(torch, run, steps)
                numbers[leg].update(busy_ms=busy, graph_launch_ms=launch,
                                    h2d_per_step=h2d, d2h_per_step=d2h)
            v = numbers['windows on the card']
            require(v['h2d_per_step'] == v['d2h_per_step'] == 0,
                    'phase 17b: run_steps over windows on the card copied '
                    'to or from the host (%s)' % v)
        for leg, _ in legs:
            v = numbers[leg]
            busy = 'device busy not measured (host)' if 'busy_ms' not in v \
                else 'device busy %.3f ms/step (busy share %.3f), host in ' \
                'cudaGraphLaunch %.3f ms/step, %.2f host-to-device and %.2f ' \
                'device-to-host copies a step (profiled)' % (
                    v['busy_ms'], v['busy_ms'] / v['wall_ms'],
                    v['graph_launch_ms'], v['h2d_per_step'],
                    v['d2h_per_step'])
            host = '' if 'host_next_ms' not in v else \
                '; host getting windows %.3f, in run_steps %.3f ms/step' % (
                    v['host_next_ms'], v['host_run_steps_ms'])
            print('phase 17b ctr sgd %s: %d slots x %d rows, batch %d, %d '
                  'steps: wall %.3f ms/step, %s%s; sparse_rows %.2f '
                  'launches a step [%s]'
                  % (leg, slots, rows, batch, steps, v['wall_ms'], busy,
                     host, v['sparse_rows_per_step'], card))
            if on_card:
                require(v['sparse_rows_per_step'] == 1, 'phase 17b %s: '
                        '%.2f sparse_rows launches a step' % (
                            leg, v['sparse_rows_per_step']))
        st = staged.stats
        numbers['pin_ms'] = st['pin_seconds'] * 1e3 / max(
            st['slots_pinned'], 1)
        print('phase 17b: the ring, the windows on the card and step by step '
              'end on the same %d persistables and %d losses bit for bit; the '
              'ring page-locked %d slots of %.1f MB in %d rings, %.3f ms each'
              % (n_state, steps, st['slots_pinned'],
                 sum(v.nbytes for v in timed[0].values()) * STAGE_W / 1e6,
                 st['rings'], numbers['pin_ms']))
        del snap, on_device
    numbers['seconds'] = time.perf_counter() - t_phase
    return numbers, counts


def _sl(L, v, rows, cols):
    """The top-left [rows, cols] of x (at most its own shape)."""
    n, d = v.shape
    return L.slice(v, axes=[0, 1], starts=[0, 0],
                   ends=[min(rows, n), min(cols, d)])


def _sums_l2(f):
    x = f['x'].astype(np.float64)
    with np.errstate(invalid='ignore', over='ignore', divide='ignore'):
        return [np.abs(x) / np.sqrt((x * x).sum(1, keepdims=True))], {}


def _sums_smooth_l1(f):
    a = np.abs(f['x'].astype(np.float64) - f['y'])
    with np.errstate(invalid='ignore', over='ignore'):
        return [(a * a + a).sum(1, keepdims=True)], {}


def _sums_btp(f):
    x, y = (np.abs(f[k][:, :16].astype(np.float64)) for k in ('x', 'y'))
    gx, gy = np.zeros(f['x'].shape), np.zeros(f['y'].shape)
    with np.errstate(invalid='ignore', over='ignore'):
        gx[:, :16] = 0.42 * y.sum(1, keepdims=True)
        gy[:, :16] = 0.42 * x.sum(1, keepdims=True)
        return [np.broadcast_to(0.14 * (x.sum(1) * y.sum(1))[:, None],
                                (x.shape[0], 3))], {'x': gx, 'y': gy}


def module_ops(pt):
    """[(name, build(L, v), exact, terms, sums)] of the tensor, nn and
    misc op modules' op types the port adds (the format of layers_ops;
    the host-bound ones are phase 17c's eager checks). v(k): 'x', 'y',
    'label' ([n, d] floats, probed), 'a' (bool), 'ids' (int64 [n, 1] in
    [0, n / 4), so ids repeat) and 'sel' (int32 [n, 1] of {0, 1}). The
    images are x as [n d / 32, 2, 4, 4] (and [n d / 16, 4, 2, 2] for
    maxout and pixel_shuffle); the auc and the bilinear product read a
    corner of x (64 x 8, n x 16)."""
    def img(L, v, c=2, hw=4):
        x = v('x')
        n, d = x.shape
        return L.reshape(x, [n * d // (c * hw * hw), c, hw, hw])

    def f32(L, t):
        return L.cast(t, 'float32')
    return [
        ('assign', lambda L, v: L.assign(v('x')), True, 0, None),
        ('squeeze', lambda L, v: L.squeeze(L.unsqueeze(v('x'), [1]), [1]),
         True, 0, None),
        ('gather', lambda L, v: L.gather(v('x'), v('ids')), True, 0, None),
        ('scatter', lambda L, v: L.scatter(v('x'), v('ids'), v('y')), True,
         0, None),
        ('shape', lambda L, v: L.shape(v('x')), True, 0, None),
        ('pad', lambda L, v: L.pad(v('x'), [1, 2, 0, 3], pad_value=0.5),
         True, 0, None),
        ('reverse', lambda L, v: L.reverse(v('x'), [0, 1]), True, 0, None),
        ('multiplex', lambda L, v: L.multiplex([v('x'), v('y')], v('sel')),
         True, 0, None),
        ('smooth_l1_loss', lambda L, v: L.smooth_l1(v('x'), v('y')), False,
         512, _sums_smooth_l1),
        ('auc', lambda L, v: L.auc(_sl(L, v('x'), 64, 8),
                                   L.cast(_sl(L, v('a'), 64, 8), 'int64')),
         True, 0, None),
        ('l2_normalize', lambda L, v: L.l2_normalize(v('x'), axis=1), False,
         512, _sums_l2),
        ('maxout', lambda L, v: L.maxout(img(L, v, 4, 2), 2), True, 0,
         None),
        ('im2sequence', lambda L, v: L.im2sequence(
            img(L, v), filter_size=[2, 3], stride=[1, 2],
            padding=[1, 0, 0, 1]), True, 0, None),
        ('label_smooth', lambda L, v: L.label_smooth(v('x'), epsilon=0.2),
         False, 0, None),
        ('huber_loss', lambda L, v: L.huber_loss(v('x'), v('y'), delta=0.5),
         False, 0, None),
        ('rank_loss', lambda L, v: L.rank_loss(v('label'), v('x'), v('y')),
         False, 0, None),
        ('margin_rank_loss', lambda L, v: L.margin_rank_loss(
            v('label'), v('x'), v('y'), margin=0.5), False, 0, None),
        ('hinge_loss', lambda L, v: L.hinge_loss(v('x'), f32(L, v('a'))),
         False, 0, None),
        ('log_loss', lambda L, v: L.log_loss(v('label'), f32(L, v('a'))),
         False, 0, None),
        ('bilinear_tensor_product', lambda L, v: L.bilinear_tensor_product(
            _sl(L, v('x'), 1 << 30, 16), _sl(L, v('y'), 1 << 30, 16), 3),
         False, 256, _sums_btp),
        ('pixel_shuffle', lambda L, v: L.pixel_shuffle(img(L, v, 4, 2), 2),
         True, 0, None),
        ('modified_huber_loss', lambda L, v: L.modified_huber_loss(
            v('x'), f32(L, v('a'))), False, 0, None),
        ('argmin', lambda L, v: L.argmin(v('x'), axis=1), True, 0, None),
        ('argsort', lambda L, v: list(L.argsort(v('x'), axis=1)), True, 0,
         None),
        ('bilinear_interp', lambda L, v: [L.resize_bilinear(img(L, v), s)
                                          for s in ((5, 3), (9, 11))],
         False, 0, None),
        ('nearest_interp', lambda L, v: [L.resize_nearest(img(L, v), s)
                                         for s in ((5, 3), (9, 11))],
         True, 0, None),
        ('isfinite', lambda L, v: L.isfinite(v('x')), True, 0, None),
        ('lod_reset', lambda L, v: _op_helper(pt, 'lod_reset',
                                              {'X': v('x')}), True, 0,
         None),
        ('where', lambda L, v: L.where(v('x'), v('x'), v('y')), True, 0,
         None),
        ('linspace', lambda L, v: [L.linspace(-3.5, 2.25, 37),
                                   L.linspace(2, 9, 5, 'int32')], True, 0,
         None),
        ('range', lambda L, v: [L.range(0, 10, 3),
                                L.range(0.1, 1.0, 0.1, 'float32')], True, 0,
         None),
        ('weight_norm', lambda L, v: L.elementwise_mul(
            v('x'), L.create_parameter(
                list(v('x').shape), 'float32',
                attr=pt.WeightNormParamAttr(dim=0))), False, 0, None),
    ]


def _ops_inputs(n, seed=17):
    """The int inputs of module_ops at [n, ...] (ids in [0, n / 4), so
    they repeat, and a 0/1 selector), and their (name, shape, dtype)."""
    rng = np.random.RandomState(seed)
    feed = {'ids': rng.randint(0, max(n // 4, 1), (n, 1)).astype('int64'),
            'sel': rng.randint(0, 2, (n, 1)).astype('int32')}
    return feed, [(k, v.shape, str(v.dtype)) for k, v in feed.items()]


def _eager_draws(torch, pt, place, n, d):
    """The host-bound ops on ``place``, eagerly: truncated_gaussian_random
    and randint (shape, range, moments), shuffle_batch (a permutation of
    x's rows, Out = X[ShuffleIdx]), nce (shape, finite) and Print (Out is
    In), twice from two executors of one program seed (the same draws)
    and at the next step (new ones). Returns a list of faults."""
    from paddle_tpu_torch.layers.helper import LayerHelper
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 17
    with pt.program_guard(main, startup):
        L = pt.layers
        x = L.data(name='x', shape=[n, d], dtype='float32',
                   append_batch_size=False)
        lbl = L.data(name='lbl', shape=[n, 1], dtype='int64',
                     append_batch_size=False)
        outs = []
        for op, attrs, dtype in (
                ('truncated_gaussian_random',
                 {'shape': [n, d], 'mean': 1.0, 'std': 2.0}, 'float32'),
                ('randint', {'shape': [n, d], 'low': -3, 'high': 7},
                 'int64')):
            h = LayerHelper(op)
            o = h.create_variable_for_type_inference(dtype)
            h.append_op(type=op, inputs={}, outputs={'Out': [o]},
                        attrs=attrs)
            outs.append(o)
        h = LayerHelper('shuffle_batch')
        sh, idx = (h.create_variable_for_type_inference(t)
                   for t in ('float32', 'int64'))
        h.append_op(type='shuffle_batch', inputs={'X': [x]},
                    outputs={'Out': [sh], 'ShuffleIdx': [idx]})
        cost = L.nce(_sl(L, x, n, 64), lbl, num_total_classes=1000,
                     num_neg_samples=16)
        shown = L.Print(_sl(L, x, 2, 4), message='phase 17c Print: ')
        outs += [sh, idx, cost, shown]
    rng = np.random.RandomState(18)
    feed = {'x': rng.randn(n, d).astype('f'),
            'lbl': rng.randint(0, 1000, (n, 1)).astype('int64')}
    runs = []
    for _ in range(2):
        exe = pt.Executor(place)
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            runs.append([exe.run(main, feed=feed, fetch_list=outs)
                         for _ in range(2)])
    (r0, r1), (s0, _) = runs
    t, ri, sh, idx, cost, shown = r0
    faults = []
    m = float(t.size)
    checks = {
        'repeat': all(np.array_equal(a, b) for a, b in zip(r0, s0)),
        'next step': not np.array_equal(r0[0], r1[0]) and
        not np.array_equal(r0[1], r1[1]) and not np.array_equal(r0[3],
                                                                r1[3]),
        'truncated': t.shape == (n, d) and t.min() >= -3.0 and
        t.max() <= 5.0 and abs(t.mean() - 1.0) < 5 * 1.76 / np.sqrt(m) and
        abs(t.std() - 2.0 * 0.8796) < 5 * 1.76 / np.sqrt(2 * m),
        'randint': ri.shape == (n, d) and ri.dtype == np.int64 and
        ri.min() == -3 and ri.max() == 6 and
        abs(ri.mean() - 1.5) < 5 * np.sqrt(8.25 / m),
        'shuffle_batch': np.array_equal(np.sort(idx), np.arange(n)) and
        np.array_equal(sh, feed['x'][idx]),
        'nce': cost.shape == (n, 1) and np.isfinite(cost).all(),
        'print': np.array_equal(shown, feed['x'][:2, :4]),
    }
    for k, ok in checks.items():
        if not ok:
            faults.append('host-bound ops: %s' % k)
    return faults, checks


def _weight_norm_compare(torch, pt, places, steps=3):
    """An fc with WeightNormParamAttr (dim 0), SGD, 3 steps on each place
    from the host startup's weights: the losses."""
    rng = np.random.RandomState(19)
    feed = {'x': rng.randn(256, 128).astype('f'),
            'y': rng.randn(256, 64).astype('f')}

    def build():
        L = pt.layers
        x = L.data(name='x', shape=[256, 128], dtype='float32',
                   append_batch_size=False)
        y = L.data(name='y', shape=[256, 64], dtype='float32',
                   append_batch_size=False)
        pred = L.fc(x, size=64, param_attr=pt.WeightNormParamAttr(
            dim=0, name='wn_fc'))
        loss = L.mean(L.square_error_cost(pred, y))
        pt.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return loss
    return _compare_places(torch, pt, places, build, feed, steps)


def phase_module_ops(torch, pt, place, card, on_card, n=4096, d=512):
    """Phase 17c: the op types of the tensor, nn and misc op modules the
    port adds, through their layers (module_ops), in one captured
    program at [n, d] with a random feed, fp32 and bf16 AMP, and again in
    a small program on the edge values: the card against the CPU place at
    the harness's tolerances (parity_difference; exact for the exact ops,
    scatter's repeated ids included). Then the host-bound ops eagerly
    (_eager_draws) and a weight-normalized fc trained 3 steps on the card
    and on the host from the same weights (losses within rtol 1e-5).
    Returns its numbers."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(17)
    big = {'x': rng.uniform(-2.0, 2.0, (n, d)).astype('f'),
           'y': rng.uniform(-2.0, 2.0, (n, d)).astype('f'),
           'label': rng.rand(n, d).astype('f'), 'a': rng.rand(n, d) > 0.5,
           'b': rng.rand(n, d) > 0.5}
    ints, extra = _ops_inputs(n)
    big.update(ints)
    edge_y = np.roll(LAYERS_EDGE, 3, axis=1)
    edge_y[:, ::4] = LAYERS_EDGE[:, ::4]
    en, ed = LAYERS_EDGE.shape
    edge = {'x': LAYERS_EDGE, 'y': edge_y,
            'label': np.clip(np.nan_to_num(np.abs(edge_y)), 0, 1)
            .astype('f'), 'a': LAYERS_EDGE > 0, 'b': edge_y > 0}
    ints, edge_extra = _ops_inputs(en)
    edge.update(ints)
    worst, faults, total = {}, [], 0
    for feed, (rows, cols), kind, ex in (
            (big, (n, d), 'random', extra),
            (edge, (en, ed), 'edge', edge_extra)):
        for amp in (None, 'bf16'):
            label = '%s %s' % (kind, 'bf16' if amp else 'fp32')
            compared, cases = _ops_card_vs_host(
                torch, pt, place, on_card, rows, cols, amp, feed, worst,
                faults, label, cases_of=module_ops, extra=ex,
                phase='17c')
            print('phase 17c %s: %d op types in one captured program at '
                  '[%d, %d]: %d outputs and gradients card against host, '
                  '%d outside the harness tolerances [%s]'
                  % (label, cases, rows, cols, compared, len(faults), card))
            total += compared
    draw_faults, checks = _eager_draws(torch, pt, place, n, d)
    print('phase 17c host-bound ops on the card (eager): %s [%s]'
          % (', '.join('%s %s' % (k, 'ok' if v else 'FAILED')
                       for k, v in checks.items()), card))
    faults += draw_faults
    (lc, lh) = _weight_norm_compare(torch, pt, (place, pt.CPUPlace()))
    wn_ok = np.allclose(lc, lh, rtol=1e-5)
    print('phase 17c WeightNormParamAttr fc, SGD, 3 steps: card %s, host %s '
          '(rtol 1e-5): %s' % (['%.7f' % v for v in lc],
                               ['%.7f' % v for v in lh],
                               'ok' if wn_ok else 'MISMATCH'))
    if not wn_ok:
        faults.append('weight norm: card %s host %s' % (lc, lh))
    require(not faults, 'phase 17c: %d differences:\n  %s'
            % (len(faults), '\n  '.join(faults)))
    return dict(ops_compared=total, seconds=time.perf_counter() - t0,
                largest_card_host_difference=worst)


# ------------------------------------------------------------- phase 18
# bench_moe's Switch-MoE LM (bench.py:308-333)
MOE_DIMS = dict(n_layer=4, n_head=8, d_model=512, d_inner=2048,
                num_experts=8, capacity_factor=1.25, top_k=1)
MOE_SMALL = dict(n_layer=2, n_head=4, d_model=64, d_inner=128,
                 num_experts=4, capacity_factor=1.25)


def _build_moe(pt, vocab, seq, dropout, amp, lr=1e-4, scan=False, **dims):
    """bench_moe's graph through the port's user API, on the default
    programs: switch_transformer_lm + Adam(lr).minimize, amp set on the
    main program."""
    from paddle_tpu_torch.models import moe
    pt.reset_default_programs()
    avg_cost, _ = moe.switch_transformer_lm(
        vocab_size=vocab, seq_len=seq, dropout_rate=dropout,
        max_length=max(512, seq), scan_layers=scan, **dims)
    pt.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    pt.default_main_program().amp = amp
    return avg_cost


def moe_feed(batch, seq, vocab, seed=0):
    """bench_moe's feed: random words in [1, vocab), labels the next
    word."""
    rng = np.random.RandomState(seed)
    words = rng.randint(1, vocab, (batch, seq)).astype('int64')
    return {'word': words, 'label': np.roll(words, -1, axis=1)}


def moe_want(layers, steps):
    """K1/K2/K3/dropout launches in ``steps`` MoE LM training steps at
    dropout > 0: a layer's causal attention (one forward and one of each
    backward kernel, on their tensor-core variants), its 2 layer norms and
    their backward (2 kernels each) and one fused dropout forward and
    backward (the attention output's), no keep mask."""
    n = layers * steps
    want = {}
    for name in VARIANTS:
        want.update({name: n, name + '_mma': n, name + '_simt': 0})
    want.update(layer_norm=2 * n, layer_norm_bwd=4 * n, dropout=n,
                dropout_bwd=n, keep_mask=0)
    return want


def moe_step_flops(batch, seq, vocab, n_layer, n_head, d_model, d_inner,
                   num_experts, capacity_factor, top_k):
    """Analytic FLOPs of one training step (3x the forward's matmuls): per
    layer the q, k, v, o projections, the attention's two products, the
    router and the experts' FFN over all E * C slots; the logits."""
    from paddle_tpu_torch.ops.moe_ops import moe_capacity
    t = batch * seq
    slots = num_experts * moe_capacity(capacity_factor, top_k, t,
                                       num_experts)
    layer = (4 * 2.0 * t * d_model * d_model
             + 2 * 2.0 * batch * seq * seq * d_model
             + 2.0 * t * d_model * num_experts
             + 2 * 2.0 * slots * d_model * d_inner)
    return 3.0 * (n_layer * layer + 2.0 * t * d_model * vocab)


def _moe_drop_share(torch, pt, exe, program, feed, fetch):
    """One eager step (use_program_cache=False) with every layer's slots
    recorded: the share of (token, choice) assignments over capacity, a
    layer (routing is read where the step computes it; nothing on the
    timed path records it)."""
    from paddle_tpu_torch.ops import moe_ops, transformer_ops
    seen = []
    orig = moe_ops.switch_moe_slots

    def spy(*args, **kwargs):
        res = orig(*args, **kwargs)
        # the spare slot E * C: (x2, gate_w, ..., capacity, k)
        seen.append((res[3], args[1].shape[-1] * args[6]))
        return res
    moe_ops.switch_moe_slots = transformer_ops.switch_moe_slots = spy
    try:
        exe.run(program, feed=feed, fetch_list=[fetch],
                use_program_cache=False)
    finally:
        moe_ops.switch_moe_slots = transformer_ops.switch_moe_slots = orig
    return [float((slots == spare).float().mean()) for slots, spare in seen]


def _moe_timed(torch, pt, place, card, on_card, batch, seq, vocab, dims,
               scan, warmup, steps):
    """bench_moe captured: ``warmup`` then ``steps`` timed steps; returns
    (launches of the timed steps, row of numbers, a --profile job of 5
    more steps)."""
    t0 = time.perf_counter()
    avg = _build_moe(pt, vocab, seq, 0.1, 'bf16', scan=scan, **dims)
    program = pt.default_main_program()
    n_params = sum(int(np.prod(p.shape)) for p in program.all_parameters())
    exe = pt.Executor(place)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        feed = {n: torch.as_tensor(v).to(exe.device)
                for n, v in moe_feed(batch, seq, vocab).items()}
        base = 0
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        _, first = _train_steps(torch, exe, feed, avg, warmup, on_card)
        reset_launches()
        secs, losses = _train_steps(torch, exe, feed, avg, steps, on_card)
        launches = read_launches()
        captured = exe.last_captured
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        drops = _moe_drop_share(torch, pt, exe, program, feed, avg)
    losses = first + losses
    ms = secs * 1e3 / steps
    flops = moe_step_flops(batch, seq, vocab, **dims)
    row = dict(ms=ms, tokens_per_s=batch * seq * steps / secs,
               mfu=flops / (ms / 1e3) / BF16_FLOPS,
               drop_share=float(np.mean(drops)),
               drop_share_by_layer=drops, peak_gb=peak / 1e9,
               above_resident_gb=(peak - base) / 1e9, params=n_params,
               loss_first=losses[0], loss_last=losses[-1])
    label = 'moe scan_layers' if scan else 'moe unrolled'
    want = moe_want(dims['n_layer'], steps)
    print('phase 18a %s: vocab %d, %d params, batch %d x seq %d, %d layers, '
          '%d experts, capacity factor %g, top-%d, amp bf16, dropout 0.1, '
          'Adam(1e-4); build + startup %.2f s; %d timed steps after %d '
          'warm-up: %.3f ms/step, %.1f tokens/s, analytic %.4g TFLOP/step, '
          'MFU %.4f; tokens over capacity %.5f (by layer %s); '
          'max_memory_allocated %.3f GB, %.3f GB above the resident state; '
          'loss first %.5f last %.5f [%s]'
          % (label, vocab, n_params, batch, seq, dims['n_layer'],
             dims['num_experts'], dims['capacity_factor'], dims['top_k'],
             t1 - t0, steps, warmup, ms, row['tokens_per_s'], flops / 1e12,
             row['mfu'], row['drop_share'],
             ['%.5f' % d for d in drops], row['peak_gb'],
             row['above_resident_gb'], losses[0], losses[-1], card))
    print('phase 18a %s: launches in the %d timed steps %s (want %s: per '
          'layer and step one causal attention through the tensor-core '
          'flash kernels, 2 layer norms and their backward, 2 kernels each, '
          'one fused dropout forward and backward)'
          % (label, steps, {k: launches[k] for k in want}, want))
    require(np.isfinite(losses).all(), '%s: loss not finite' % label)
    require(losses[-1] < losses[0], '%s: loss did not fall: %s'
            % (label, losses))
    if on_card:
        require(captured, '%s: the timed steps did not replay a graph'
                % label)
        require(exe.captures == 1, '%s: %d captures, want 1'
                % (label, exe.captures))
        require(all(launches[k] == n for k, n in want.items()),
                '%s launch counts %s, want %s' % (label, launches, want))

    def profile_step():
        with pt.scope_guard(scope):
            exe.run(program, feed=feed, fetch_list=[avg],
                    return_numpy=False)
    return launches, row, ('5 %s steps' % label, profile_step, 5, None)


def _moe_same_bits(res, a, b):
    return bool(np.array_equal(res[a][0], res[b][0])) and all(
        np.array_equal(res[b][1][n], v) for n, v in res[a][1].items())


def _moe_compare_width(torch, pt, place, card, batch, seq, vocab, dims,
                       scan):
    """At bench_moe's width, bf16 AMP and dropout 0.1 as timed: 3 captured
    steps against 3 eager steps from the same state, and a second captured
    run from that state (_three_ways)."""
    avg = _build_moe(pt, vocab, seq, 0.1, 'bf16', scan=scan, **dims)
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    del host
    feed = moe_feed(batch, seq, vocab, seed=1)
    res = _three_ways(torch, pt, place, pt.default_main_program(), avg,
                      weights, feed, modes=('captured', 'eager'))
    again = _three_ways(torch, pt, place, pt.default_main_program(), avg,
                        weights, feed, modes=('captured',))
    res['again'] = again['captured']
    return res


def _moe_small(torch, pt, places, vocab=256, seq=16, batch=8, steps=3):
    """At the small width (2 layers, d_model 64, 4 experts), top-1 and
    top-2: the card against the host over 3 Adam steps from the same
    weights, fp32 (rtol 1e-4) and bf16 AMP (rtol 2e-2), unrolled and
    scan; then scan against unrolled at dropout 0 through
    stack_moe_trained_weights on the card (3 SGD steps, rtol 1e-5)."""
    from paddle_tpu_torch.models import moe
    from paddle_tpu_torch.weights import load_into_scope
    feed = moe_feed(batch, seq, vocab, seed=2)
    out = {}
    for top_k in (1, 2):
        for scan in (False, True):
            for amp, rtol in ((None, 1e-4), ('bf16', 2e-2)):
                dims = dict(MOE_SMALL, top_k=top_k)
                avg = _build_moe(pt, vocab, seq, 0.0, amp, lr=1e-3,
                                 scan=scan, **dims)
                main = pt.default_main_program()
                host = pt.Scope()
                with pt.scope_guard(host):
                    pt.Executor(pt.CPUPlace()).run(
                        pt.default_startup_program())
                weights = {n: host.numpy(n) for n in host.keys()}
                losses = []
                for place in places:
                    scope = pt.Scope()
                    load_into_scope(weights, scope, place)
                    exe = pt.Executor(place)
                    with pt.scope_guard(scope):
                        losses.append([float(exe.run(
                            main, feed=feed, fetch_list=[avg])[0])
                            for _ in range(steps)])
                rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
                key = 'top%d %s %s' % (top_k, 'scan' if scan else 'unrolled',
                                       amp or 'fp32')
                out[key] = (rel, rtol, losses)
                require(rel <= rtol, 'phase 18a small %s: card %s, host %s '
                        '(rel %.3g > %g)' % (key, losses[0], losses[1],
                                             rel, rtol))
    # scan against unrolled on the card, from the unrolled startup stacked
    dims = dict(MOE_SMALL, top_k=2)
    progs = {}
    for scan in (True, False):
        pt.reset_default_programs()
        avg, _ = moe.switch_transformer_lm(vocab, seq, scan_layers=scan,
                                           **dims)
        pt.optimizer.SGD(learning_rate=0.3).minimize(avg)
        progs[scan] = (pt.default_main_program(), avg,
                       pt.default_startup_program())
    host = pt.Scope()
    with pt.scope_guard(host):
        hexe = pt.Executor(pt.CPUPlace())
        hexe.run(progs[True][2])
        hexe.run(progs[False][2])
    stacked = moe.stack_moe_trained_weights(host, dims['n_layer'])
    weights = {n: host.numpy(n) for n in host.keys()}
    scan_losses = {}
    for scan, (main, avg, _) in progs.items():
        scope = pt.Scope()
        load_into_scope(weights, scope, places[0])
        exe = pt.Executor(places[0])
        with pt.scope_guard(scope):
            scan_losses[scan] = [float(exe.run(main, feed=feed,
                                               fetch_list=[avg])[0])
                                 for _ in range(steps)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(scan_losses[True],
                                                  scan_losses[False]))
    require(rel <= 1e-5, 'phase 18a: scan %s against unrolled %s (rel %.3g)'
            % (scan_losses[True], scan_losses[False], rel))
    return out, (rel, len(stacked), scan_losses)


def phase_moe(torch, pt, place, card, on_card, batch=32, seq=64,
              vocab=VOCAB, dims=MOE_DIMS, warmup=3, steps=20,
              host_place=None, cmp_batch=None, profile=False):
    """Phase 18a: bench_moe's Switch-MoE LM, scan_layers and unrolled,
    captured; captured against eager and a second run bit for bit; the
    small width card against host and scan against unrolled. Returns
    (the timed runs' launch counts, summary, --profile jobs: with
    ``profile`` their executors and graphs stay alive)."""
    t0 = time.perf_counter()
    runs, rows, jobs = [], {}, []
    for scan in (True, False):
        launches, row, job = _moe_timed(torch, pt, place, card, on_card,
                                        batch, seq, vocab, dims, scan,
                                        warmup, steps)
        runs.append(launches)
        rows['scan' if scan else 'unrolled'] = row
        if profile:
            jobs.append(job)
        del job
        if on_card:
            torch.cuda.empty_cache()
    bits = {}
    for scan in (True, False):
        res = _moe_compare_width(torch, pt, place, card, cmp_batch or batch,
                                 seq, vocab, dims, scan)
        label = 'scan' if scan else 'unrolled'
        bits[label] = dict(eager=_moe_same_bits(res, 'captured', 'eager'),
                           again=_moe_same_bits(res, 'captured', 'again'))
        print('phase 18a %s compare (batch %d x seq %d, bf16, dropout 0.1, '
              '3 Adam steps from one state): losses captured %s, eager %s, '
              'again %s; captured == eager bit for bit (losses and %d scope '
              'variables): %s; a second captured run: %s [%s]'
              % (label, cmp_batch or batch, seq,
                 ['%.7f' % v for v in res['captured'][0]],
                 ['%.7f' % v for v in res['eager'][0]],
                 ['%.7f' % v for v in res['again'][0]],
                 len(res['captured'][1]), bits[label]['eager'],
                 bits[label]['again'], card))
        require(bits[label]['eager'], 'phase 18a %s: captured differs from '
                'eager' % label)
        require(bits[label]['again'], 'phase 18a %s: a second run from the '
                'same state differs' % label)
        del res
        if on_card:
            torch.cuda.empty_cache()
    small, scan_cmp = _moe_small(torch, pt, (place, host_place or
                                             pt.CPUPlace()))
    for key, (rel, rtol, losses) in small.items():
        print('phase 18a small %s: card %s, host %s (max rel %.3g, limit '
              '%g)' % (key, ['%.6f' % v for v in losses[0]],
                       ['%.6f' % v for v in losses[1]], rel, rtol))
    print('phase 18a small scan against unrolled (top-2, dropout 0, %d '
          'names stacked, 3 SGD steps): %s against %s (max rel %.3g, limit '
          '1e-5); phase 18a %.1f s'
          % (scan_cmp[1], scan_cmp[2][True], scan_cmp[2][False],
             scan_cmp[0], time.perf_counter() - t0))
    return runs, dict(rows, bits=bits,
                      small={k: v[0] for k, v in small.items()},
                      scan_vs_unrolled=scan_cmp[0]), jobs


REMAT_LEVELS = ((None, 'none'), (0, 'level 0 (dots_saveable)'),
                (1, 'level 1 (full)'))


def _remat_leg(torch, pt, place, on_card, build, feed, warmup, steps,
               level, check_steps=3):
    """One program under memory_optimize(level) (None: no remat): the
    losses of the first ``check_steps`` steps and the trainable parameters
    after them, then ms a step over ``steps`` more and the step's peak
    memory (max_memory_allocated above what was allocated before the
    first step) and the graphs captured."""
    avg = build()
    program = pt.default_main_program()
    if level is not None:
        pt.memory_optimize(program, level=level)
    names = [p.name for p in program.all_parameters() if p.trainable] + \
        _running_stats(program)
    exe = pt.Executor(place)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        feed = {n: torch.as_tensor(v).to(exe.device) for n, v in feed.items()}
        base = 0
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        _, losses = _train_steps(torch, exe, feed, avg, check_steps, on_card)
        params = {n: scope.numpy(n) for n in names}
        _train_steps(torch, exe, feed, avg, warmup, on_card)
        secs, _ = _train_steps(torch, exe, feed, avg, steps, on_card)
        peak = torch.cuda.max_memory_allocated() - base if on_card else 0
        captured = exe.last_captured
    captures = exe.captures
    del exe, scope
    if on_card:
        torch.cuda.empty_cache()
    return dict(ms=secs * 1e3 / steps, peak_gb=peak / 1e9,
                captures=captures, captured=captured), losses, params


def phase_remat(torch, pt, place, card, on_card, batch=64, seq=64,
                vocab=VOCAB, base=None, moe_batch=32, moe_dims=MOE_DIMS,
                resnet=(64, 224, 1000, False), warmup=2, steps=10,
                require_drop=True):
    """Phase 18b: memory_optimize on phase 6's Transformer-base (batch 64
    x seq 64, bf16, dropout 0.1, Adam; unrolled and scan_layers), on 18a's
    MoE LM (scan_layers) and on phase 9's ResNet-50 (batch 64, 224 x 224,
    NHWC, bf16, Momentum: its batch norms move their running statistics in
    the forward), level 0 and level 1 against no remat: ms a step, the
    step's peak memory (level 1's below no remat's), the losses of 3 steps
    and every trainable parameter and running statistic after them bit for
    bit equal to no remat, one CUDA graph. ``resnet``: (batch, image,
    classes, the rehearsal's small net); ``require_drop`` False: the
    peak is printed and not held (a tiny width). Returns {model: {level:
    row}}."""
    from paddle_tpu_torch.models import resnet as R
    from paddle_tpu_torch.models import transformer as T
    base = base or dict(n_layer=6, n_head=8, d_key=64, d_value=64,
                        d_model=512, d_inner=2048)
    t0 = time.perf_counter()
    models = {
        'transformer unrolled': (
            lambda: _build_train(pt, vocab, seq, 0.1, 'bf16', **base),
            T.make_fake_batch(batch, seq, seq, vocab, vocab, seed=0)),
        'transformer scan_layers': (
            lambda: _build_train(pt, vocab, seq, 0.1, 'bf16',
                                 scan_layers=True, **base),
            T.make_fake_batch(batch, seq, seq, vocab, vocab, seed=0)),
        'moe scan_layers': (
            lambda: _build_moe(pt, vocab, seq, 0.1, 'bf16', scan=True,
                               **moe_dims),
            moe_feed(moe_batch, seq, vocab)),
        'resnet': (
            lambda: _build_resnet(pt, resnet[1], resnet[2], 'NHWC', 'bf16',
                                  0.1, small=resnet[3]),
            R.make_fake_batch(resnet[0], resnet[1], resnet[2], seed=0)),
    }
    out = {}
    for model, (build, feed) in models.items():
        rows, ref = {}, None
        for level, label in REMAT_LEVELS:
            row, losses, params = _remat_leg(torch, pt, place, on_card,
                                             build, feed, warmup, steps,
                                             level)
            if ref is None:
                ref = (losses, params)
            row['same_bits'] = losses == ref[0] and all(
                np.array_equal(v, ref[1][n]) for n, v in params.items())
            rows[label] = row
            print('phase 18b %s, %s: %.3f ms/step, step peak %.3f GB above '
                  'the resident state, %d graph(s) captured, last step '
                  'replayed %s; losses %s; losses and %d parameters and '
                  'running statistics after 3 '
                  'steps bit for bit equal to no remat: %s [%s]'
                  % (model, label, row['ms'], row['peak_gb'],
                     row['captures'], row['captured'],
                     ['%.7f' % v for v in losses], len(params),
                     row['same_bits'], card))
            require(row['same_bits'], 'phase 18b %s %s: not bit for bit '
                    'equal to no remat' % (model, label))
            if on_card:
                require(row['captures'] == 1 and row['captured'],
                        'phase 18b %s %s: %d captures, last replayed %s'
                        % (model, label, row['captures'], row['captured']))
        none, full = rows['none'], rows[REMAT_LEVELS[2][1]]
        if on_card:
            print('phase 18b %s: level 1 holds %.4f of no remat\'s step '
                  'peak at %.4f of its time [%s]'
                  % (model, full['peak_gb'] / none['peak_gb'],
                     full['ms'] / none['ms'], card))
        if on_card and require_drop:
            require(full['peak_gb'] < none['peak_gb'],
                    'phase 18b %s: level 1 peak %.3f GB, no remat %.3f'
                    % (model, full['peak_gb'], none['peak_gb']))
        out[model] = rows
    print('phase 18b %.1f s' % (time.perf_counter() - t0))
    return out


def phase_accum(torch, pt, place, card, on_card, seq=64, vocab=VOCAB,
                base=None, micro=16, k=4):
    """Phase 18c: GradientAccumulator(Adam(1e-4), 4) on Transformer-base
    (fp32, dropout 0, TF32 off) at micro-batch 16 from the same weights
    as the plain Adam program: every parameter bit for bit unchanged on
    the 3 gated micro steps of each round; the mean gradient the update
    reads on the 4th micro step against the plain program's gradients of
    the 4 micro-batches, summed in the accumulator's order (within 1e-6
    of each tensor's largest; bit for bit reported) and against batch
    64's; after 8 micro steps, against 2 plain Adam steps at batch 64
    (the 4 slices): the share of parameter elements within rtol 1e-4 and
    the largest gap in lr, beside a control (batch 64 with its sentences
    permuted: the same math, the sums in another order). The card's
    GEMMs round a row by the batch it is in, so a pre-activation near 0
    can take the ReLU's other side at batch 16 than at 64, and Adam
    divides each gradient by its own magnitude: the last check is held
    to 98 % and 2 lr, the gradient ones exactly. At dropout 0.1, 3
    captured micro steps equal 3 eager ones and run_steps(4) equals 4
    run calls, bit for bit (losses and every scope variable)."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.weights import load_into_scope
    base = base or dict(n_layer=6, n_head=8, d_key=64, d_value=64,
                        d_model=512, d_inner=2048)
    lr = 1e-4
    t0 = time.perf_counter()

    def build(accum, dropout=0.0):
        pt.reset_default_programs()
        avg, _ = T.transformer_base(
            src_vocab_size=vocab, trg_vocab_size=vocab, src_seq_len=seq,
            trg_seq_len=seq, max_length=max(256, seq),
            dropout_rate=dropout, **base)
        opt = pt.optimizer.Adam(learning_rate=lr)
        if accum:
            opt = pt.optimizer.GradientAccumulator(opt, k)
        opt.minimize(avg)
        return pt.default_main_program(), avg

    big = T.make_fake_batch(micro * k, seq, seq, vocab, vocab, seed=0)
    micros = [{n: v[i * micro:(i + 1) * micro] for n, v in big.items()}
              for i in range(k)]
    main, avg = build(False)
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    names = [p.name for p in main.all_parameters() if p.trainable]
    grads = [n + '@GRAD' for n in names]
    # the plain program: 2 steps at batch 64, the same permuted (the
    # control), and each micro-batch's gradient from the start
    perm = np.random.RandomState(1).permutation(micro * k)
    params = []
    for feed in (big, {n: v[perm] for n, v in big.items()}):
        scope, exe = pt.Scope(), pt.Executor(place)
        load_into_scope(weights, scope, place)
        with pt.scope_guard(scope):
            for _ in range(2):
                exe.run(main, feed=feed, fetch_list=[avg])
            params.append({n: scope.numpy(n) for n in names})
        del scope, exe
    want, control = params
    summed = None
    scope, exe = pt.Scope(), pt.Executor(place)
    with pt.scope_guard(scope):
        for m in micros:
            load_into_scope(weights, scope, place)
            g = exe.run(main, feed=m, fetch_list=grads)
            summed = g if summed is None else [a + b for a, b in
                                               zip(summed, g)]
        load_into_scope(weights, scope, place)
        big_g = exe.run(main, feed=big, fetch_list=grads)
    del scope, exe
    micro_mean = [a * np.float32(1.0 / k) for a in summed]

    amain, aavg = build(True)
    astart = pt.default_startup_program()
    scope, exe = pt.Scope(), pt.Executor(place)
    with pt.scope_guard(scope):
        exe.run(astart)         # the accumulators and the phase
        load_into_scope(weights, scope, place)
        prev = {n: scope.numpy(n) for n in names}
        gated_same = []
        for i in range(2 * k):
            got_g = exe.run(amain, feed=micros[i % k], fetch_list=grads)
            now = {n: scope.numpy(n) for n in names}
            if i % k != k - 1:
                gated_same.append(all(np.array_equal(now[n], prev[n])
                                      for n in names))
            elif i == k - 1:
                acc_g = got_g
            prev = now
    del scope, exe

    def rel_gap(got, ref):
        return max(float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                   for a, b in zip(got, ref))
    g_gap = rel_gap(acc_g, micro_mean)
    g_same = all(np.array_equal(a, b) for a, b in zip(acc_g, micro_mean))
    big_gap = rel_gap(acc_g, big_g)

    def within(p):
        return sum(int(np.sum(np.abs(p[n] - want[n]) <=
                              1e-4 * np.abs(want[n]))) for n in names)

    def largest_gap(p):
        return max(float(np.max(np.abs(p[n] - want[n]))) for n in names)
    n_all = sum(want[n].size for n in names)
    share, gap = within(prev) / n_all, largest_gap(prev)
    c_share, c_gap = within(control) / n_all, largest_gap(control)
    # captured against eager and run_steps against run, dropout 0.1
    amain, aavg = build(True, dropout=0.1)
    astart = pt.default_startup_program()
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(astart)
    load_into_scope(weights, host, pt.CPUPlace())
    aweights = {n: host.numpy(n) for n in host.keys()}
    res = _three_ways(torch, pt, place, amain, aavg, aweights, micros[0],
                      steps=k)
    same = {m: _moe_same_bits(res, 'captured', m)
            for m in ('eager', 'run_steps')}
    print('phase 18c GradientAccumulator(Adam(1e-4), %d), Transformer-base '
          'fp32 at micro-batch %d x seq %d: the %d gated micro steps leave '
          'the %d parameters bit for bit: %s; the mean gradient of the 4th '
          'micro step against the plain program\'s micro-batch gradients '
          'summed in its order: max gap %.3g of each tensor\'s largest '
          '(limit 1e-6), bit for bit %s; against batch %d\'s gradient: '
          '%.3g; after %d micro steps against 2 Adam steps at batch %d: '
          '%.5f of %d parameter elements within rtol 1e-4, the largest gap '
          '%.3g lr (limits 0.98, 2 lr); the control (batch %d permuted) '
          '%.5f, %.3g lr; dropout 0.1: captured == eager %s, run_steps(%d) '
          '== %d run calls %s (losses and %d scope variables) (%.1f s) [%s]'
          % (k, micro, seq, len(gated_same), len(names), all(gated_same),
             g_gap, g_same, micro * k, big_gap, 2 * k, micro * k, share,
             n_all, gap / lr, micro * k, c_share, c_gap / lr,
             same['eager'], k, k, same['run_steps'],
             len(res['captured'][1]), time.perf_counter() - t0, card))
    require(all(gated_same), 'phase 18c: a gated micro step moved a '
            'parameter')
    require(g_gap <= 1e-6, 'phase 18c: the accumulated gradient is not '
            'the mean of the micro-batch gradients (%.3g)' % g_gap)
    require(share >= 0.98 and gap <= 2 * lr, 'phase 18c: %.5f of the '
            'parameters within rtol 1e-4 of the big-batch steps, the '
            'largest gap %.3g lr' % (share, gap / lr))
    require(same['eager'], 'phase 18c: captured differs from eager')
    require(same['run_steps'], 'phase 18c: run_steps differs from run')
    return dict(gated_same=all(gated_same), grad_gap=g_gap,
                grad_bits=g_same, big_grad_gap=big_gap,
                within_rtol_share=share, gap_lr=gap / lr,
                control_within_share=c_share, control_gap_lr=c_gap / lr,
                captured_eq_eager=same['eager'],
                run_steps_eq_run=same['run_steps'])


# ------------------------------------------------------------- phase 19
# the recurrent and sequence path: bench.py's bench_rnn_lstm
# (benchmark/paddle/rnn: IMDB stacked-LSTM sentiment) at its width, the
# sequence models, the LSTM and GRU cell kernels, the new op types
RNN_BENCH = dict(batch=128, seq=100, vocab=30000, hidden=128)
# the IMDB word dictionary of the book's understand_sentiment chapter
IMDB_VOCAB = 5147
RNN_CELL_TOL = ('fp32: |kernel - plain| <= 1e-6 * max(1, max|plain|) (the '
                'fp32 carries 1e-5); bf16: within 1 bf16 ulp of max(|kernel|, '
                '|plain|) + 1e-6 (each value rounded once, on either side of '
                'a rounding boundary)')


def _build_rnn_lstm(pt, vocab, hidden, amp):
    """bench_rnn_lstm's program through the port's layers
    (models/seq_models.lstm_text_classifier: the v1 shim's lowering), on
    the default programs, amp set on the main program."""
    from paddle_tpu_torch.models import seq_models
    pt.reset_default_programs()
    _, avg = seq_models.lstm_text_classifier(vocab, hidden_dim=hidden)
    pt.default_main_program().amp = amp
    return avg


def rnn_lstm_feed(batch, seq, vocab, lens=None, seed=0):
    """bench_rnn_lstm's feed: random words in [1, vocab), every length
    ``seq`` (or ``lens``), random labels."""
    rng = np.random.RandomState(seed)
    lens = np.full(batch, seq) if lens is None else np.asarray(lens)
    return {'data': rng.randint(1, vocab, (batch, seq)).astype('int64'),
            'data_len': lens.astype('int32'),
            'label': rng.randint(0, 2, (batch, 1)).astype('int64')}


def rnn_want(lstm_steps=0, gru_steps=0, lstm_seqs=0, gru_seqs=0,
             gru_wides=0):
    """The recurrences' launches: ``lstm_steps`` LSTM and ``gru_steps`` GRU
    positions run forward and backward by the cells (a GRU position: two
    launches each way), ``lstm_seqs`` LSTM and ``gru_seqs`` GRU sequences
    by the cluster's sequence kernels and ``gru_wides`` GRU sequences by
    the wide ones (one launch each way)."""
    return dict(lstm_cell_fwd=lstm_steps, lstm_cell_bwd=lstm_steps,
                gru_cell_fwd=2 * gru_steps, gru_cell_bwd=2 * gru_steps,
                lstm_seq_fwd=lstm_seqs, lstm_seq_bwd=lstm_seqs,
                gru_seq_fwd=gru_seqs, gru_seq_bwd=gru_seqs,
                gru_wide_fwd=gru_wides, gru_wide_bwd=gru_wides)


def recurrence_want(torch, kind, batch, seq, width, dtype=None, times=1):
    """The launches (rnn_want) of ``times`` runs of one recurrence ('lstm'
    or 'gru'), forward and backward: one sequence launch each way a run
    where a plan has a launch (the GRU: the cluster's, else the wide
    one), else the cells a position."""
    from paddle_tpu_torch.ops.kernels import rnn_cell as K
    dtype = dtype or torch.float32
    if kind == 'lstm':
        path = 'cells' if K.lstm_seq_plan(batch, width, dtype) is None \
            else 'seq'
    else:
        path = K.gru_path(batch, width, dtype)
    if path == 'cells':
        return rnn_want(**{'%s_steps' % kind: seq * times})
    if path == 'wide':
        return rnn_want(gru_wides=times)
    return rnn_want(**{'%s_seqs' % kind: times})


def rnn_lstm_flops(batch, seq, vocab, hidden, emb=128):
    """Analytic FLOPs of one training step (3x the forward's matmuls): the
    input projection, the recurrent product a position, the classifier."""
    t = batch * seq
    fwd = 2.0 * t * emb * 4 * hidden + 2.0 * t * hidden * 4 * hidden + \
        2.0 * batch * hidden * 2
    return 3.0 * fwd


def _rnn_timed(torch, pt, place, card, on_card, batch, seq, vocab, hidden,
               warmup, steps):
    """19a: bench_rnn_lstm captured, bf16: ``warmup`` then ``steps`` timed
    steps; returns (launches of the timed steps, row)."""
    t0 = time.perf_counter()
    avg = _build_rnn_lstm(pt, vocab, hidden, 'bf16')
    program = pt.default_main_program()
    n_params = sum(int(np.prod(p.shape)) for p in program.all_parameters())
    exe = pt.Executor(place)
    with pt.scope_guard(pt.Scope()):
        exe.run(pt.default_startup_program())
        feed = {n: torch.as_tensor(v).to(exe.device)
                for n, v in rnn_lstm_feed(batch, seq, vocab).items()}
        base = 0
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        _, first = _train_steps(torch, exe, feed, avg, warmup, on_card)
        reset_launches()
        secs, losses = _train_steps(torch, exe, feed, avg, steps, on_card)
        launches = read_launches()
        captured = exe.last_captured
        peak = torch.cuda.max_memory_allocated() if on_card else 0
    losses = first + losses
    ms = secs * 1e3 / steps
    flops = rnn_lstm_flops(batch, seq, vocab, hidden)
    row = dict(ms=ms, tokens_per_s=batch * seq * steps / secs,
               mfu=flops / (ms / 1e3) / BF16_FLOPS, peak_gb=peak / 1e9,
               above_resident_gb=(peak - base) / 1e9, params=n_params,
               loss_first=losses[0], loss_last=losses[-1])
    want = recurrence_want(torch, 'lstm', batch, seq, hidden, torch.bfloat16,
                           steps)
    path = ('the sequence kernels, one launch each way a step'
            if want['lstm_seq_fwd'] else 'no sequence-kernel plan at this '
            'width: one LSTM cell a position, forward and backward')
    print('phase 19a bench_rnn_lstm: vocab %d, %d params, batch %d x seq %d, '
          'emb 128, hidden %d, Adam(2e-3) + L2Decay(8e-4) + value clip 25, '
          'amp bf16; build + startup %.2f s; %d timed steps after %d '
          'warm-up: %.3f ms/step, %.1f tokens/s, analytic %.4g GFLOP/step, '
          'MFU %.5f; max_memory_allocated %.3f GB, %.3f GB above the '
          'resident state; loss first %.5f last %.5f; recurrence launches %s '
          '(want %s: %s) [%s]'
          % (vocab, n_params, batch, seq, hidden, t1 - t0, steps, warmup, ms,
             row['tokens_per_s'], flops / 1e9, row['mfu'], row['peak_gb'],
             row['above_resident_gb'], losses[0], losses[-1],
             {k: launches[k] for k in want}, want, path, card))
    require(np.isfinite(losses).all(), 'bench_rnn_lstm: loss not finite')
    require(losses[-1] < losses[0], 'bench_rnn_lstm: loss did not fall: %s'
            % losses)
    if on_card:
        require(captured and exe.captures == 1, 'bench_rnn_lstm: the timed '
                'steps did not replay one graph (%d captures)'
                % exe.captures)
        require(all(launches[k] == n for k, n in want.items()),
                'bench_rnn_lstm launch counts %s, want %s'
                % ({k: launches[k] for k in want}, want))
    return launches, row


def _rnn_small(torch, pt, places, vocab, hidden, batch=8, seq=16,
               steps=3):
    """19a at batch 8 x seq 16 with ragged lengths (0 and seq among them),
    fp32 (TF32 off): (the card's losses, the host's, the largest relative
    difference; held to 1e-5)."""
    lens = np.array([seq, 0, 5, 1, seq, 9, 3, 12][:batch])
    feed = rnn_lstm_feed(batch, seq, vocab, lens=lens, seed=5)
    card, host = _compare_places(
        torch, pt, places, lambda: _build_rnn_lstm(pt, vocab, hidden, None),
        feed, steps)
    return card, host, max(abs(a - b) / abs(b) for a, b in zip(card, host))


def seq_model_builds(pt, seq, vocab=IMDB_VOCAB, small=False,
                     gru_hidden=None):
    """{name: build} of the sequence models at their defaults (``small``:
    narrow; ``gru_hidden``: stacked_gru_tagger's width): each appends its
    layers and SGD(0.05) to the default programs and returns the loss.
    Feeds: seq_model_feed."""
    from paddle_tpu_torch.models import seq_models, srl

    def data():
        L = pt.layers
        return (L.data(name='words', shape=[seq], dtype='int64'),
                L.data(name='label', shape=[1], dtype='int64'),
                L.data(name='length', shape=[], dtype='int64'))

    def lstm_net():
        w, lab, ln = data()
        kw = dict(emb_dim=16, hid_dim=32) if small else {}
        return seq_models.stacked_lstm_net(w, lab, vocab, length=ln,
                                           **kw)[1]

    def conv_net():
        w, lab, ln = data()
        kw = dict(emb_dim=8, hid_dim=8) if small else {}
        return seq_models.convolution_net(w, lab, vocab, length=ln, **kw)[1]

    def gru_tagger():
        L = pt.layers
        w = L.data(name='words', shape=[seq], dtype='int64')
        target = L.data(name='target', shape=[seq, 1], dtype='int64')
        ln = L.data(name='length', shape=[], dtype='int64')
        kw = dict(emb_dim=8, hidden_dim=16) if small else {}
        if gru_hidden:
            kw['hidden_dim'] = gru_hidden
        return seq_models.stacked_gru_tagger(w, target, vocab, 9, length=ln,
                                             **kw)[1]

    def srl_tagger():
        L = pt.layers
        word, mark, target = (L.data(name=n, shape=[seq], dtype='int64')
                              for n in ('word', 'mark', 'target'))
        ln = L.data(name='length', shape=[], dtype='int64')
        kw = dict(emb_dim=8, hidden_dim=16) if small else {}
        emission, _, avg = srl.srl_tagger(word, mark, target, vocab, 9,
                                          length=ln, **kw)
        srl.srl_decode(emission, length=ln)
        return avg

    def with_sgd(build):
        def run():
            pt.reset_default_programs()
            loss = build()
            pt.optimizer.SGD(learning_rate=0.05).minimize(loss)
            return loss
        return run
    return {k: with_sgd(v) for k, v in (
        ('stacked_lstm_net', lstm_net), ('stacked_gru_tagger', gru_tagger),
        ('convolution_net', conv_net), ('srl_tagger', srl_tagger))}


def seq_model_recurrences(small=False):
    """{model: (kind, hidden, layers)} of seq_model_builds' recurrences."""
    return {'stacked_lstm_net': ('lstm', 8 if small else 128, 3),
            'stacked_gru_tagger': ('gru', 16 if small else 128, 2),
            'srl_tagger': ('gru', 16 if small else 64, 2)}


def seq_model_feed(name, batch, seq, vocab=IMDB_VOCAB, seed=19):
    """A model's feed: lengths drawn from 1..seq, words in [1, vocab)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, seq + 1, batch).astype('int64')
    if name == 'srl_tagger':
        words = rng.randint(1, vocab, (batch, seq)).astype('int64')
        marks = (rng.rand(batch, seq) < 0.2).astype('int64')
        return {'word': words, 'mark': marks,
                'target': ((words + marks) % 9).astype('int64'),
                'length': lens}
    feed = {'words': rng.randint(1, vocab, (batch, seq)).astype('int64'),
            'length': lens}
    if name == 'stacked_gru_tagger':
        feed['target'] = rng.randint(0, 9, (batch, seq, 1)).astype('int64')
    else:
        feed['label'] = rng.randint(0, 2, (batch, 1)).astype('int64')
    return feed


def _seq_model_timed(torch, pt, place, on_card, build, feed, steps):
    """``steps`` captured steps of ``build()``'s program after 2 warm-up:
    (launches of the timed steps, ms a step, captured)."""
    loss = build()
    exe = pt.Executor(place)
    with pt.scope_guard(pt.Scope()):
        exe.run(pt.default_startup_program())
        dfeed = {n: torch.as_tensor(v).to(exe.device)
                 for n, v in feed.items()}
        _train_steps(torch, exe, dfeed, loss, 2, on_card)
        reset_launches()
        secs, losses = _train_steps(torch, exe, dfeed, loss, steps, on_card)
        launches = read_launches()
    require(np.isfinite(losses).all(), 'a sequence model: loss not finite')
    return launches, secs * 1e3 / steps, exe.last_captured and \
        exe.captures == 1


def _rnn_cell_inputs(torch, kind, b, t, d, dtype, gen, lens):
    """Sequence tensors of one cell call at position t // 2 (the views the
    recurrence hands the kernels), random in the ranges a step sees."""
    dev = torch.device('cuda', 0)
    g = 4 if kind == 'lstm' else 3

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(
            dtype)
    return dict(
        x=r(b, t, g * d, scale=0.5), mm=r(b, g * d if kind == 'lstm' else
                                         2 * d, scale=0.5),
        mm_c=r(b, d, scale=0.5), bias=r(g * d, scale=0.1),
        seq=r(b, t, d, scale=0.5), cell=r(b, t, d), gates=torch.sigmoid(
            r(b, t, g * d)).to(dtype), dh=r(b, t, d), dc=r(b, t, d),
        dmm=r(b, d), carry=torch.randn(b, d, generator=gen, device=dev),
        carry2=torch.randn(b, d, generator=gen, device=dev),
        length=torch.as_tensor(lens, dtype=torch.int32, device=dev),
        pos=t // 2)


def _rnn_close(torch, got, want, dtype, fp32_carry=False):
    """(largest difference, within RNN_CELL_TOL)."""
    g, w = (np.asarray(v.float().cpu(), np.float64) for v in (got, want))
    err = float(np.abs(g - w).max()) if g.size else 0.0
    if dtype == torch.float32 or fp32_carry:
        tol = (1e-5 if fp32_carry else 1e-6) * max(1.0, np.abs(w).max())
        return err, bool(np.all(np.abs(g - w) <= tol))
    return err, bool(np.all(np.abs(g - w) <= bf16_ulp(
        np.maximum(np.abs(g), np.abs(w))) + 1e-6))


def _rnn_cell_case(torch, card, kind, direction, dtype, b, t, d, lens, acts,
                   gen, timed=False):
    """One cell kernel (kind: 'lstm' or 'gru'; direction 'fwd' or 'bwd')
    against its plain version on the same card tensors (the views of the
    sequence tensors the recurrence hands it), each output within
    RNN_CELL_TOL, run twice for equal bits; with ``timed``, its device ms
    (graph replay of a step's launches: one for the LSTM, the two phases
    for the GRU), the plain version's, the bound and the library call's
    (torch's fused LSTM cell and its backward, the same gate order; the
    GRU has none: torch's applies its reset gate after the product).
    Returns the row."""
    from paddle_tpu_torch.ops.kernels import rnn_cell as K
    v = _rnn_cell_inputs(torch, kind, b, t, d, dtype, gen, lens)
    p = v['pos']
    x, bias, length = v['x'][:, p], v['bias'], v['length']
    hp, cp = v['seq'][:, p - 1], v['cell'][:, p - 1]
    if timed and kind == 'lstm':
        # torch's fused cell on contiguous copies of the same inputs (its
        # second bias zero: it adds both); its backward on its own
        # forward's workspace
        lib_in = (x.contiguous(), v['mm'], cp.contiguous(), bias,
                  torch.zeros_like(bias))
        _, cy, ws = torch.ops.aten._thnn_fused_lstm_cell(*lib_in)
        lib_bwd = (v['dh'][:, p].contiguous(), cy, ws)
    m = K.step_mask(length, p, b, x.device)
    elt = x.element_size()
    carries = [v['carry'].clone(), v['carry2'].clone()]
    library, fp32 = None, ()
    if kind == 'lstm' and direction == 'fwd':
        outs = [torch.empty_like(v[k])[:, p] for k in ('seq', 'cell',
                                                       'gates')]

        def launch():
            K.lstm_cell_fwd(x, v['mm'], bias, hp, cp, length, p, *outs, acts)

        def plain():
            return K.lstm_cell_reference(x, v['mm'], bias, hp, cp, m, acts,
                                         dtype)
        n_bytes = elt * (b * 10 * d + 4 * d + b * 6 * d) + 4 * b

        def library():
            return torch.ops.aten._thnn_fused_lstm_cell(*lib_in)
    elif kind == 'lstm':
        dh_out, gates, cell = v['dh'][:, p], v['gates'][:, p], \
            v['cell'][:, p]
        outs = [torch.empty_like(v['gates'])[:, p]] + carries

        def launch():
            K.lstm_cell_bwd(dh_out, None, v['dmm'], carries[0], carries[1],
                            gates, cell, cp, length, p, outs[0], acts)

        def plain():
            return K.lstm_cell_reference_bwd(
                dh_out, None, v['dmm'], v['carry'], v['carry2'], gates, cell,
                cp, m, acts, dtype)
        n_bytes = elt * b * 12 * d + 16 * b * d + 4 * b
        fp32 = (1, 2)

        def library():
            return torch.ops.aten._thnn_fused_lstm_cell_backward_impl(
                lib_bwd[0], None, lib_in[2], lib_bwd[1], lib_bwd[2], True)
    elif direction == 'fwd':
        gates = torch.empty_like(v['gates'])[:, p]
        outs = [gates, torch.empty_like(v['seq'])[:, p],
                torch.empty_like(v['seq'])[:, p]]

        def launch():
            K.gru_cell_fwd(0, x, bias, v['mm'], hp, length, p, gates,
                           outs[1], acts)
            K.gru_cell_fwd(1, x, bias, v['mm_c'], hp, length, p, gates,
                           outs[2], acts)

        def plain():
            ur, rh = K.gru_cell_reference(0, x, bias, v['mm'], hp, None, m,
                                          acts, dtype)
            c, h = K.gru_cell_reference(1, x, bias, v['mm_c'], hp, ur, m,
                                        acts, dtype)
            return torch.cat([ur, c], -1), rh, h
        n_bytes = elt * (b * 12 * d + 3 * d) + 4 * b
    else:
        dh_out, gates = v['dh'][:, p], v['gates'][:, p]
        outs = [torch.empty_like(v['gates'])[:, p], carries[0]]

        def launch():
            K.gru_cell_bwd(0, dh_out, v['dmm'], carries[0], gates, hp,
                           length, p, outs[0], acts)
            K.gru_cell_bwd(1, None, v['mm_c'], carries[0], gates, hp,
                           length, p, outs[0], acts)

        def plain():
            (du, dc), carry = K.gru_cell_reference_bwd(
                0, dh_out, v['dmm'], v['carry'], gates, hp, m, acts, dtype)
            dr, carry = K.gru_cell_reference_bwd(1, None, v['mm_c'], carry,
                                                 gates, hp, m, acts, dtype)
            return torch.cat([du, dr, dc], -1), carry
        n_bytes = elt * b * 10 * d + 8 * b * d + 4 * b
        fp32 = (1,)

    def check():
        carries[0].copy_(v['carry'])
        carries[1].copy_(v['carry2'])
        launch()
        return [o.clone() for o in outs]
    first, again = check(), check()
    want = plain()
    torch.cuda.synchronize()
    errs, ok = [], True
    for i, (a, w) in enumerate(zip(first, want)):
        e, good = _rnn_close(torch, a, w, dtype, fp32_carry=i in fp32)
        errs.append(e)
        ok = ok and good
    same = all(torch.equal(a, c) for a, c in zip(first, again))
    label = '%s_cell_%s %s B=%d D=%d pos %d lengths %s acts %s' % (
        kind, direction, str(dtype)[6:], b, d, p,
        'all 0' if not np.any(lens) else 'ragged' if len(set(
            np.asarray(lens).tolist())) > 1 else 'full', acts)
    row = dict(max_abs_err=max(errs))
    note = ''
    if timed:
        launches = 1 if kind == 'lstm' else 2
        lo, by = bound_ms(n_bytes, 40 * b * d * launches)
        ms = device_ms(torch, launch)
        plain_ms = device_ms(torch, plain)
        lib = device_ms(torch, library) if library is not None else None
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=lo, bound_by=by,
                   library_ms=lib)
        note = ('; device ms a step (%d launch%s): kernel %.5f, plain %.5f, '
                '%s, bound %.6f (%s)'
                % (launches, '' if launches == 1 else 'es', ms, plain_ms,
                   'library %.5f' % lib if lib is not None else
                   'no single PyTorch call', lo, by))
    print('%s: max_abs_err %s (%s) %s, second run bit for bit %s%s [%s]'
          % (label, ['%.3g' % e for e in errs], RNN_CELL_TOL,
             'ok' if ok else 'MISMATCH', same, note, card))
    require(ok, '%s disagrees with its plain version' % label)
    require(same, '%s: a second run gave other bits' % label)
    return row


def _recurrence_places(torch, kind, b, t, d, lens, reverse, acts, gen_seed):
    """The whole recurrence, forward and backward, at fp32 on the card
    (the kernels) and on the host (the plain cells) from the same inputs:
    the largest difference relative to each array's largest magnitude."""
    from paddle_tpu_torch.ops.kernels import rnn_cell as K
    rng = np.random.RandomState(gen_seed)
    g = 4 if kind == 'lstm' else 3
    arrays = [rng.randn(b, t, g * d) * 0.5, rng.randn(d, g * d) * 0.3 /
              np.sqrt(d / 8.0), rng.randn(g * d) * 0.1, rng.randn(b, d) * 0.5,
              rng.randn(b, d) * 0.5][:5 if kind == 'lstm' else 4]
    cots = [rng.randn(b, t, d) for _ in range(2 if kind == 'lstm' else 1)]
    res = {}
    for dev in ('cuda', 'cpu'):
        ts = [torch.tensor(a, dtype=torch.float32, device=dev)
              .requires_grad_() for a in arrays]
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        if kind == 'lstm':
            out = K.LstmRecurrence.apply(*ts, lt, acts, reverse)
        else:
            out = (K.GruRecurrence.apply(*ts, lt, acts, reverse),)
        grads = torch.autograd.grad(out, ts, [torch.tensor(
            c, dtype=torch.float32, device=dev) for c in cots])
        res[dev] = [a.detach().cpu().numpy() for a in list(out) + list(grads)]
    torch.cuda.synchronize()
    return max(float(np.abs(a - w).max() / max(np.abs(w).max(), 1e-30))
               for a, w in zip(res['cuda'], res['cpu']))


RNN_SEQ_RAGGED = [100, 0, 37, 1, 50, 99, 51, 12]
RNN_SEQ_CASES = {
    # (B, T, D, lengths, activation codes (gate, cell, candidate), reverse,
    #  with bias, with dhidden, with dcell)
    'bench': (128, 100, 128, [100] * 128, [(0, 1, 1)], False, True, True,
              True),
    'ragged': (8, 100, 24, RNN_SEQ_RAGGED, [(0, 1, 1)], False, True, True,
               True),
    'all_padding': (8, 100, 32, [0] * 8, [(0, 1, 1)], False, True, True,
                    False),
    'every_activation': (8, 100, 32, RNN_SEQ_RAGGED,
                         [(1, 2, 3), (2, 3, 0), (3, 0, 2)], False, True, True,
                         True),
    'odd': (37, 100, 20, [100, 0] + [7 * i % 101 for i in range(1, 36)],
            [(0, 1, 1)], False, False, True, False),
    'reverse': (8, 100, 32, RNN_SEQ_RAGGED, [(0, 1, 1)], True, True, False,
                True),
}
# the GRU's counterpart: the same shapes, lengths and switches (no cell
# state, so no dcell), activation codes (gate, candidate); every code as
# gate and as candidate in pairs that stay finite over 100 steps (a relu
# gate with an identity candidate, or identity with identity, grows to
# inf)
GRU_SEQ_CASES = {
    name: (b, t, d, lens, [(0, 1)] if acts == [(0, 1, 1)] else
           [(1, 2), (2, 0), (3, 0), (0, 3)], rev, bias, dh, False)
    for name, (b, t, d, lens, acts, rev, bias, dh, _) in
    RNN_SEQ_CASES.items()}
# the wide GRU kernels' cases: the same at hidden 512 (the odd case at 500,
# neither a multiple of 16 nor of 8), the bench case at 64 rows (the GRU
# models' batch), where no cluster holds W. At 512 with these draws an
# identity gate (u unbounded) and a relu gate with a sigmoid candidate
# reach inf within the 100 steps in the plain version itself, so every
# other code is a gate and every code a candidate
GRU_WIDE_CASES = {
    name: (64 if name == 'bench' else b, t, 500 if name == 'odd' else 512,
           [t] * 64 if name == 'bench' else lens,
           [(1, 2), (2, 3), (1, 0), (0, 3)] if len(acts) > 1 else acts, rev,
           bias, dh, dc)
    for name, (b, t, d, lens, acts, rev, bias, dh, dc) in
    GRU_SEQ_CASES.items()}
SEQ_CASES = {'lstm': RNN_SEQ_CASES, 'gru': GRU_SEQ_CASES,
             'gru_wide': GRU_WIDE_CASES}
# bf16: the kernel's recurrent products and cuBLAS's round to bf16 from
# sums in other orders, and a one-ulp difference in a step's product
# carries through the earlier steps (the LSTM backward's worst measured
# on an H100 0.0040 of an array's largest magnitude, the forward's 0)
RNN_SEQ_BF16_TOL = 2.0 ** -7
RNN_SEQ_TOL = ('fp32: |kernel - plain| <= 1e-5 x the array\'s largest '
               'magnitude; bf16: <= %.4g x it' % RNN_SEQ_BF16_TOL)
# the wide kernels in bf16: at hidden 512 each product sums 512 (backward
# 1,024) terms before it rounds to bf16, and a one-ulp difference from
# cuBLAS's order carries through the 100 steps; with an unbounded
# activation (a relu gate, an identity or relu candidate) it grows with
# h, as bf16's own rounding does (on an H100: 2 ulps of the largest
# magnitude with a relu candidate, 4 with a relu gate and an identity
# candidate). So bf16 is held as phase 21c holds it, to twice the plain
# version's own distance from fp32 on the same inputs, or 2^-7 of the
# largest magnitude where that is larger
RNN_WIDE_TOL = ('fp32: |kernel - plain| <= 1e-5 x the array\'s largest '
                'magnitude; bf16: <= max(%.4g x it, 2 x |plain bf16 - plain '
                'fp32|) on the same inputs' % RNN_SEQ_BF16_TOL)


def _seq_inputs(torch, kind, case, dtype, seed=20):
    """SEQ_CASES[kind][case]'s tensors on the card, from numpy (seed)."""
    b, t, d, lens, acts, reverse, bias, dh, dc = SEQ_CASES[kind][case]
    g = 4 if kind == 'lstm' else 3
    rng = np.random.RandomState(seed)
    dev = torch.device('cuda', 0)

    def r(*shape, scale=1.0):
        return torch.tensor(rng.randn(*shape) * scale, dtype=torch.float32,
                            device=dev).to(dtype)
    return dict(
        x=r(b, t, g * d, scale=0.5),
        w=r(d, g * d, scale=0.3 / np.sqrt(max(d / 8.0, 1.0))),
        bias=r(g * d, scale=0.1) if bias else None, h0=r(b, d, scale=0.5),
        c0=r(b, d, scale=0.5),
        length=torch.tensor(lens, dtype=torch.int32, device=dev),
        dh=r(b, t, d) if dh else None, dc=r(b, t, d) if dc else None,
        acts=acts, reverse=reverse)


def _seq_bytes_ops(kind, b, t, d, elt, direction):
    """The bytes a sequence kernel must move (each input once, each output
    once) and its products' operations."""
    if kind != 'lstm':
        if direction == 'fwd':
            n = elt * (b * t * 3 * d + d * 3 * d + 3 * d + b * d +
                       2 * b * t * d + b * t * 3 * d) + 4 * b
        else:
            n = elt * (2 * b * t * d + d * 3 * d + 2 * b * t * 3 * d +
                       2 * b * d) + 4 * b * d + 4 * b
        return n, 2.0 * b * t * d * 3 * d
    if direction == 'fwd':
        n = elt * (b * t * 4 * d + d * 4 * d + 4 * d + 2 * b * d +
                   2 * b * t * d + b * t * 4 * d) + 4 * b
    else:
        n = elt * (2 * b * t * d + d * 4 * d + b * t * 4 * d + b * t * d +
                   b * d + b * t * 4 * d + b * d) + 8 * b * d + 4 * b
    return n, 2.0 * b * t * d * 4 * d


def _rnn_seq_case(torch, card, kind, direction, dtype, case, timed=False):
    """One sequence kernel (kind 'lstm', 'gru' or 'gru_wide', direction
    'fwd' or 'bwd') against its plain version (the per-position loop of
    torch.mm and plain cells) on the same card tensors, every output within
    RNN_SEQ_TOL (the wide kernels' RNN_WIDE_TOL), run twice for equal bits
    and counted once a launch; the backward's inputs are the plain
    forward's. With ``timed``: device ms
    (graph replay) beside the plain version's, the per-position path's
    (torch.mm and the cell kernels), the bound, the floor (T steps of the
    exchanges alone at the same launch geometry: one a step for the LSTM,
    two for the GRU) and the library call (the LSTM: cuDNN's nn.LSTM at
    fp16, forward without grad, or its backward alone; the GRU: none, no
    PyTorch call computes its function). Returns the row."""
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import rnn_cell as K
    lstm, wide = kind == 'lstm', kind == 'gru_wide'
    stem = 'gru_wide' if wide else '%s_seq' % kind
    v = _seq_inputs(torch, kind, case, dtype)
    b, t, d = v['x'].shape[0], v['x'].shape[1], v['w'].shape[0]
    name = '%s_%s' % (stem, direction)
    counter = getattr(K, name)
    worst, rel_worst = 0.0, 0.0
    tol = 1e-5 if dtype == torch.float32 else RNN_SEQ_BF16_TOL
    tol_text = RNN_WIDE_TOL if wide else RNN_SEQ_TOL
    for acts in v['acts']:
        if lstm:
            fargs = (v['x'], v['w'], v['bias'], v['h0'], v['c0'],
                     v['length'], acts, v['reverse'])
            fwd, fwd_plain = K.lstm_seq_fwd, K.lstm_seq_fwd_reference
            pos_fwd, pos_bwd = K.lstm_positions_fwd, K.lstm_positions_bwd
        else:
            fargs = (v['x'], v['w'], v['bias'], v['h0'], v['length'], acts,
                     v['reverse'])
            fwd = getattr(K, stem + '_fwd')
            fwd_plain = K.gru_seq_fwd_reference
            pos_fwd, pos_bwd = K.gru_positions_fwd, K.gru_positions_bwd
        if direction == 'fwd':
            def launch(fargs=fargs, fwd=fwd):
                return fwd(*fargs)

            def plain(fargs=fargs, fwd_plain=fwd_plain):
                return fwd_plain(*fargs)

            def positions(fargs=fargs, pos_fwd=pos_fwd):
                return pos_fwd(*fargs)
            names = ('hidden', 'cell', 'gates') if lstm else \
                ('hidden', 'gates', 'rh')
        else:
            outs = fwd_plain(*fargs)
            if lstm:
                _, cell, gates = outs
                bargs = (v['dh'], v['dc'], v['w'], gates, cell, v['c0'],
                         v['length'], acts, v['reverse'])
                bwd, bwd_plain = K.lstm_seq_bwd, K.lstm_seq_bwd_reference
                names = ('dx', 'dh0', 'dc0')
            else:
                hidden, gates, _ = outs
                bargs = (v['dh'], v['w'], gates, hidden, v['h0'],
                         v['length'], acts, v['reverse'])
                bwd = getattr(K, stem + '_bwd')
                bwd_plain = K.gru_seq_bwd_reference
                names = ('dx', 'dh0')

            def launch(bargs=bargs, bwd=bwd):
                return bwd(*bargs)

            def plain(bargs=bargs, bwd_plain=bwd_plain):
                return bwd_plain(*bargs)

            def positions(bargs=bargs, pos_bwd=pos_bwd):
                return pos_bwd(*bargs)
        before = counter.launches
        first, again = launch(), launch()
        want = plain()
        # the wide kernels in bf16: the plain version's own bf16 gap, its
        # fp32 run on the same inputs
        gaps = [0.0] * len(names)
        if wide and dtype == torch.bfloat16:
            args = fargs if direction == 'fwd' else bargs
            wide32 = (fwd_plain if direction == 'fwd' else bwd_plain)(*[
                a.float() if torch.is_tensor(a) and a.is_floating_point()
                else a for a in args])
            gaps = [float((a.float() - c).abs().max()) if a.numel() else 0.0
                    for a, c in zip(want, wide32)]
        torch.cuda.synchronize()
        require(counter.launches == before + 2, '%s: %d launches counted '
                'for 2 calls' % (name, counter.launches - before))
        errs = []
        for out, got, ref, gap in zip(names, first, want, gaps):
            g, r = (np.asarray(a.float().cpu(), np.float64) for a in (got, ref))
            require(np.isfinite(r).all(), '%s case %s: the plain %s is not '
                    'finite' % (name, case, out))
            err = float(np.abs(g - r).max()) if g.size else 0.0
            scale = float(np.abs(r).max()) if r.size else 0.0
            errs.append((out, err, err / max(scale, 1e-30)))
            require(err <= max(tol * scale, 2.0 * gap), '%s %s case %s acts '
                    '%s: %s differs from the plain version by %.3g (largest '
                    'magnitude %.3g, the plain bf16 gap %.3g; %s)'
                    % (name, str(dtype)[6:], case, acts, out, err, scale, gap,
                       tol_text))
        same = all(torch.equal(a, c) for a, c in zip(first, again))
        require(same, '%s %s case %s: a second run gave other bits'
                % (name, str(dtype)[6:], case))
        worst = max([worst] + [e for _, e, _ in errs])
        rel_worst = max([rel_worst] + [r for _, _, r in errs])
        print('%s %s case %s (B %d T %d D %d, acts %s%s%s%s%s): max abs err '
              '%s%s (%s): ok, second run bit for bit [%s]'
              % (name, str(dtype)[6:], case, b, t, d, acts,
                 ', reverse' if v['reverse'] else '',
                 '' if v['bias'] is not None else ', no bias',
                 '' if v['dh'] is not None else ', no dhidden',
                 '' if v['dc'] is not None or not lstm else ', no dcell',
                 ', '.join('%s %.3g (%.3g of its largest)' % e for e in errs),
                 '; the plain bf16 gaps %s' % ', '.join(
                     '%.3g' % g for g in gaps) if any(gaps) else '',
                 tol_text, card))
    row = dict(max_abs_err=worst, max_rel_err=rel_worst)
    if not timed:
        return row
    plan = getattr(K, '%s_plan' % stem)(b, d, dtype)
    lib = build.library()
    code = build.dtype_code(dtype)
    bwd_code = int(direction == 'bwd')
    require(getattr(lib, 'ptt_%s_smem' % stem)(
        d, plan['units'], code, bwd_code) == plan['smem_%s' % direction],
        '%s_plan\'s shared memory differs from csrc/%s.cu\'s layout'
        % (stem, stem))
    if wide:
        # the floor stages its rows from a [B, T, 3D] buffer, its counters
        # zeroed before each launch as the wrapper's are
        buf = torch.zeros(b, t, 3 * d, dtype=dtype, device=v['x'].device)
        count = torch.zeros(plan['groups'], dtype=torch.int32,
                            device=v['x'].device)

        def floor_run():
            count.zero_()
            build.check(lib.ptt_gru_wide_floor(
                buf.data_ptr(), count.data_ptr(), b, t, d, plan['units'],
                plan['cluster'], code, bwd_code,
                torch.cuda.current_stream().cuda_stream),
                'ptt_gru_wide_floor')
        geometry = ('%d row groups x %d CTAs of %d units, clusters of %d, '
                    'cooperative' % (plan['groups'], plan['slices'],
                                     plan['units'], plan['cluster']))
    else:
        def floor_run():
            build.check(getattr(lib, 'ptt_%s_floor' % stem)(
                b, t, d, plan['cluster'], plan['units'], code, bwd_code,
                torch.cuda.current_stream().cuda_stream),
                'ptt_%s_floor' % stem)
        geometry = '%d clusters of %d CTAs' % (
            plan['grid'] // plan['cluster'], plan['cluster'])
    ms = device_ms(torch, launch, iters=20)
    plain_ms = device_ms(torch, plain, iters=3)
    positions_ms = device_ms(torch, positions, iters=3)
    floor = device_ms(torch, floor_run, iters=20)
    n_bytes, n_ops = _seq_bytes_ops(kind, b, t, d, v['x'].element_size(),
                                    direction)
    lo, by = bound_ms(n_bytes, n_ops, BF16_FLOPS if dtype == torch.bfloat16
                      else FP32_FLOPS)
    lib_ms = None
    if lstm:
        dev = torch.device('cuda', 0)
        net = torch.nn.LSTM(d, d, batch_first=True).to(dev).half()
        net.flatten_parameters()
        xin = torch.randn(b, t, d, device=dev).half().requires_grad_()
        if direction == 'fwd':
            def library():
                with torch.no_grad():
                    net(xin)
        else:
            y, _ = net(xin)
            dy = torch.randn_like(y)
            params = [xin] + list(net.parameters())

            def library():
                torch.autograd.grad(y, params, dy, retain_graph=True)
        lib_ms = eager_ms(torch, library, iters=20, warmup=3)
    row.update(ms=ms, plain_ms=plain_ms, positions_ms=positions_ms,
               bound_ms=lo, bound_by=by, library_ms=lib_ms, floor_ms=floor,
               us_per_step=ms * 1e3 / t, cluster=plan.get('cluster'),
               units=plan['units'], smem=plan['smem_%s' % direction],
               grid=plan['grid'])
    print('%s %s at the bench recurrence (B %d T %d hidden %d; %s, %d '
          'threads, %d B shared memory a CTA): device ms %.5f (%.3f us a '
          'step), plain (T torch.mm + plain cells) %.5f, the per-position '
          'path (torch.mm + cell kernels) %.5f, bound %.6f (%s), floor (T '
          'steps of %s alone, same launch) %.5f (%.3f us a step), %s [%s]'
          % (name, str(dtype)[6:], b, t, d, geometry, plan['threads'],
             plan['smem_%s' % direction], ms, ms * 1e3 / t, plain_ms,
             positions_ms, lo, by,
             'one exchange' if lstm else 'two exchanges', floor,
             floor * 1e3 / t,
             'cuDNN nn.LSTM fp16 %s %.5f (eager)'
             % ('forward (no grad)' if direction == 'fwd' else
                'backward alone', lib_ms) if lstm else
             'no single PyTorch call (nn.GRU applies its reset gate after '
             'the product)', card))
    return row


def phase_rnn_kernels(torch, card, b=128, t=100, d=128):
    """19c: each cell kernel against its plain version on the card, fp32
    and bf16, forward and backward, at bench_rnn_lstm's step (B 128, hidden
    128, full lengths; timed in bf16), at ragged lengths, at all padding
    (length 0) and at every activation; twice each for equal bits. Then the
    LSTM and GRU sequence kernels against their plain versions on
    RNN_SEQ_CASES / GRU_SEQ_CASES (timed at the bench case in bf16, beside
    their floor, the per-position path and, for the LSTM, cuDNN) and the
    wide GRU kernels on GRU_WIDE_CASES (timed at 64 x 100 x 512 in fp32
    and bf16 likewise), the whole recurrences card against host at fp32
    with ragged, reverse and length-0 rows (through each path:
    RECURRENCE_WIDTHS), and each recurrence beside the cells' path and
    torch.nn.LSTM / nn.GRU at full lengths (the GRU also at 64 x 100 x
    512, on the wide kernels). Returns {kernel: row}."""
    from paddle_tpu_torch.ops.kernels import rnn_cell as K
    gen = torch.Generator(device='cuda').manual_seed(19)
    rows = {}
    ragged = np.array([100, 0, 37, 1, 50, 99, 51, 12])
    for kind in ('lstm', 'gru'):
        base = (0, 1, 1) if kind == 'lstm' else (0, 1)
        every = [(1, 2, 3), (2, 3, 0), (3, 0, 2)] if kind == 'lstm' else \
            [(1, 2), (2, 3), (3, 0)]
        for direction in ('fwd', 'bwd'):
            for dtype in (torch.float32, torch.bfloat16):
                bf16 = dtype == torch.bfloat16
                row = _rnn_cell_case(torch, card, kind, direction, dtype, b,
                                     t, d, np.full(b, t), base, gen,
                                     timed=bf16)
                if bf16:
                    rows['%s_cell_%s' % (kind, direction)] = row
                _rnn_cell_case(torch, card, kind, direction, dtype, 8, t, 24,
                               ragged, base, gen)
                _rnn_cell_case(torch, card, kind, direction, dtype, 8, t, 20,
                               np.zeros(8, int), base, gen)
                for acts in every:
                    _rnn_cell_case(torch, card, kind, direction, dtype, 8, t,
                                   32, ragged, acts, gen)
    for kind in ('lstm', 'gru', 'gru_wide'):
        wide = kind == 'gru_wide'
        for direction in ('fwd', 'bwd'):
            key = '%s_%s' % ('gru_wide' if wide else kind + '_seq', direction)
            for dtype in (torch.float32, torch.bfloat16):
                bf16 = dtype == torch.bfloat16
                for case in SEQ_CASES[kind]:
                    timed = case == 'bench' and (bf16 or wide)
                    row = _rnn_seq_case(torch, card, kind, direction, dtype,
                                        case, timed=timed)
                    # the wide kernels' row is fp32's (the GRU models'
                    # dtype), with bf16's beside it
                    if timed and wide and bf16:
                        rows[key]['bf16'] = row
                    elif timed:
                        rows[key] = row
    for kind, width in RECURRENCE_WIDTHS:
        for reverse in (False, True):
            before = read_launches()
            rel = _recurrence_places(torch, kind, 8, 40, width,
                                     np.array([40, 0, 17, 1, 40, 9, 3, 33]),
                                     reverse, ACTS_OF[kind], 7)
            moved = {k: read_launches()[k] - before[k] for k in rnn_want()}
            print('phase 19c %s recurrence %s, fp32, B 8 T 40 D %d, lengths '
                  '40, 0, 17, 1, 40, 9, 3, 33: card (kernels) against host '
                  '(plain cells), forward and every gradient: largest '
                  'difference %.3g of the array\'s largest magnitude (limit '
                  '1e-5); launches %s [%s]'
                  % (kind, 'reverse' if reverse else 'forward', width, rel,
                     moved, card))
            require(rel <= 1e-5, 'phase 19c: the %s recurrence on the card '
                    'differs from the host by %.3g' % (kind, rel))
            want = recurrence_want(torch, kind, 8, 40, width)
            require(moved == want, 'phase 19c: the %s recurrence at hidden '
                    '%d launched %s, want %s' % (kind, width, moved, want))
    rows['recurrence'] = _recurrence_vs_cudnn(torch, card, b, t, d)
    rows['gru_recurrence'] = _recurrence_vs_cudnn(torch, card, b, t, d,
                                                  'gru')
    rows['gru_wide_recurrence'] = _recurrence_vs_cudnn(torch, card, 64, t,
                                                       512, 'gru')
    return rows


# the recurrences held card against host at B 8, fp32: each kind through
# its sequence kernels (hidden 32), the GRU through the wide ones (512),
# and each at a width past every plan, through the cells (the LSTM at 256,
# the GRU at 1024)
RECURRENCE_WIDTHS = [('lstm', 32), ('gru', 32), ('lstm', 256), ('gru', 512),
                     ('gru', 1024)]
ACTS_OF = {'lstm': (0, 1, 1), 'gru': (0, 1)}



def _recurrence_vs_cudnn(torch, card, b, t, d, kind='lstm'):
    """One recurrence (LstmRecurrence or GruRecurrence: the sequence
    kernels, one launch each way) at bench_rnn_lstm's shape, full lengths,
    forward and backward with dW and dbias, beside the per-position path
    (the products and cells a position each way) and torch.nn.LSTM /
    nn.GRU over the same [B, T, D] -> [B, T, D] (which also project their
    input: one GEMM more; nn.GRU applies its reset gate after the
    product, so it is a yardstick for another function): bf16 (cuDNN
    declines bf16, so torch runs its own cells) beside torch in bf16 and
    in fp16 (cuDNN), and fp32 beside cuDNN in fp32. Eager, CUDA events
    over 20 calls; the recurrence also by graph replay. Returns the bf16
    row and the others' times."""
    from paddle_tpu_torch.ops.kernels import rnn_cell as K
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(23)
    lstm = kind == 'lstm'
    g = 4 if lstm else 3
    acts = ACTS_OF[kind]
    row = {}
    for dt in (torch.bfloat16, torch.float32):
        x = (0.5 * torch.randn(b, t, g * d, generator=gen, device=dev)).to(dt)
        w = (0.1 * torch.randn(d, g * d, generator=gen, device=dev)).to(dt)
        bias = torch.zeros(g * d, device=dev, dtype=dt)
        h0 = torch.zeros(b, d, device=dev, dtype=dt)
        leaves = [a.requires_grad_() for a in (x, w, bias)]
        dy = torch.randn(b, t, d, generator=gen, device=dev).to(dt)

        def ours():
            if lstm:
                h, _ = K.LstmRecurrence.apply(*leaves, h0, h0, None, acts,
                                              False)
            else:
                h = K.GruRecurrence.apply(*leaves, h0, None, acts, False)
            torch.autograd.grad(h, leaves, dy)

        xd, wd, bd = (a.detach() for a in leaves)

        def cells():
            # the per-position path: the products and the cell launches a
            # position each way, dW and dbias as the recurrence takes them
            if lstm:
                hid, cel, gat = K.lstm_positions_fwd(xd, wd, bd, h0, h0, None,
                                                     acts, False)
                dx, _, _ = K.lstm_positions_bwd(dy, torch.zeros_like(dy), wd,
                                                gat, cel, h0, None, acts,
                                                False)
                prev = K._previous(h0, hid, False)
                torch.mm(prev.reshape(-1, d).t(), dx.reshape(-1, 4 * d))
            else:
                hid, gat, rh = K.gru_positions_fwd(xd, wd, bd, h0, None, acts,
                                                   False)
                dx, _ = K.gru_positions_bwd(dy, wd, gat, hid, h0, None, acts,
                                            False)
                prev = K._previous(h0, hid, False).reshape(-1, d)
                dx2 = dx.reshape(-1, 3 * d)
                torch.mm(prev.t(), dx2[:, :2 * d])
                torch.mm(rh.reshape(-1, d).t(), dx2[:, 2 * d:])
            dx.sum((0, 1))
        libs = {}
        for lt in ((torch.bfloat16, torch.float16) if dt == torch.bfloat16
                   else (torch.float32,)):
            net = (torch.nn.LSTM if lstm else torch.nn.GRU)(
                d, d, batch_first=True).to(dev).to(lt)
            net.flatten_parameters()
            xin = torch.randn(b, t, d, generator=gen, device=dev).to(lt) \
                .requires_grad_()
            params = [xin] + list(net.parameters())
            dyl = dy.to(lt)

            def lib(net=net, xin=xin, params=params, dyl=dyl):
                y, _ = net(xin)
                torch.autograd.grad(y, params, dyl)
            key = '%s%s' % (str(lt)[6:], ' cuDNN' if
                            torch.backends.cudnn.is_acceptable(xin) else
                            ' (no cuDNN)')
            libs[key] = eager_ms(torch, lib, iters=20, warmup=3)
        eager = eager_ms(torch, ours, iters=20, warmup=3)
        graph = device_ms(torch, ours, iters=5)
        cells_ms = device_ms(torch, cells, iters=5)
        flops = 3 * 2.0 * b * t * d * g * d
        elt = x.element_size()
        lo, by = bound_ms(elt * (2 * (b * t * g * d + d * g * d) +
                                 2 * b * t * d),
                          flops, BF16_FLOPS if dt == torch.bfloat16 else
                          FP32_FLOPS)
        name = str(dt)[6:]
        print('phase 19c %s recurrence forward + backward, B %d T %d hidden '
              '%d %s, full lengths: the sequence kernels eager %.4f ms, '
              'graph replay %.4f ms; the per-position path (torch.mm + cell '
              'launches each way) graph replay %.4f ms; bound %.5f ms (%s); '
              'torch.nn.%s eager (its input GEMM too; all rows full, so its '
              'zeroed padding does not differ%s): %s [%s]'
              % (kind.upper(), b, t, d, name, eager, graph, cells_ms, lo, by,
                 kind.upper(), '' if lstm else '; its reset gate applied '
                 'after the product: a yardstick for another function',
                 ', '.join('%s %.4f ms' % kv for kv in libs.items()), card))
        res = dict(eager_ms=eager, ms=graph, cells_ms=cells_ms, bound_ms=lo,
                   bound_by=by, library_ms=libs)
        if dt == torch.bfloat16:
            row = res
        else:
            row['fp32'] = res
    return row


def seq_ops_cases(pt):
    """[(name, build(L, v), rule)] of the 22 op types this slice adds
    through their layers (one op where there is none); rule: 'exact', or
    'sums' (recurrence_difference)."""
    from paddle_tpu_torch.param_attr import ParamAttr

    def pool(t):
        return lambda L, v: L.sequence_pool(v('x3'), t, length=v('len'))

    def op(op_type, inputs, out_dtype=None, attrs=None, slots=('Out',)):
        from paddle_tpu_torch.layers.helper import LayerHelper
        helper = LayerHelper(op_type)
        first = next(iter(inputs.values()))
        outs = {s: [helper.create_variable_for_type_inference(
            out_dtype or first.dtype)] for s in slots}
        helper.append_op(type=op_type, inputs={k: [x] for k, x in
                                               inputs.items()},
                         outputs=outs, attrs=attrs or {})
        return [outs[s][0] for s in slots]
    return [
        ('sequence_pool', lambda L, v: [pool(t)(L, v) for t in (
            'average', 'sum', 'sqrt')], 'sums'),
        ('sequence_pool_pick', lambda L, v: [pool(t)(L, v) for t in (
            'max', 'first', 'last')], 'exact'),
        ('sequence_softmax', lambda L, v: L.elementwise_mul(
            L.sequence_softmax(v('x2'), v('len')), v('w2')), 'sums'),
        ('sequence_expand', lambda L, v: L.sequence_expand(v('row'), v('x3')),
         'exact'),
        ('sequence_reshape', lambda L, v: L.sequence_reshape(v('x3'), 16),
         'exact'),
        ('sequence_concat', lambda L, v: L.sequence_concat([v('x3'),
                                                            v('x3')]),
         'exact'),
        ('sequence_slice', lambda L, v: L.sequence_slice(v('x3'), 3, 7),
         'exact'),
        ('sequence_conv', lambda L, v: L.sequence_conv(v('x3'), 24,
                                                       filter_size=3,
                                                       act='tanh'), 'sums'),
        ('sequence_erase', lambda L, v: op('sequence_erase', {'X': v('ids')},
                                           attrs={'tokens': [2, 5]}),
         'exact'),
        ('kmax_seq_score', lambda L, v: op(
            'kmax_seq_score', {'X': v('x2'), 'Length': v('len')}, 'int64',
            {'beam_size': 3}), 'exact'),
        ('lstm', lambda L, v: list(L.dynamic_lstm(
            v('x4'), 4 * 32, h_0=v('h0'), c_0=v('h0'), is_reverse=True,
            length=v('len'))), 'sums'),
        ('gru', lambda L, v: L.dynamic_gru(v('x3g'), 32, h_0=v('h0'),
                                           length=v('len')), 'sums'),
        ('lstmp', lambda L, v: list(L.dynamic_lstmp(v('x4'), 4 * 32, 16,
                                                    length=v('len'))),
         'sums'),
        ('simple_rnn', lambda L, v: L.simple_rnn(v('x3'), length=v('len')),
         'sums'),
        ('lstm_unit', lambda L, v: list(L.lstm_unit(v('row'), v('h0'),
                                                    v('h0'))), 'sums'),
        ('gru_unit', lambda L, v: list(L.gru_unit(v('row3'), v('h0'),
                                                  3 * 32)), 'sums'),
        ('warpctc', lambda L, v: L.warpctc(v('logits'), v('label'),
                                           input_length=v('len'),
                                           label_length=v('l_len')), 'sums'),
        ('ctc_align', lambda L, v: list(L.ctc_greedy_decoder(
            v('logits'), 0, v('len'))), 'exact'),
        ('linear_chain_crf', lambda L, v: L.linear_chain_crf(
            v('logits'), v('tags'), length=v('len'),
            param_attr=ParamAttr(name='p19_crf')), 'sums'),
        ('crf_decoding', lambda L, v: [L.crf_decoding(
            v('logits'), ParamAttr(name='p19_crf'), length=v('len')),
            L.crf_decoding(v('logits'), ParamAttr(name='p19_crf'),
                           label=v('tags'), length=v('len'))], 'exact'),
        ('precision_recall', lambda L, v: list(L.precision_recall(
            v('idx'), v('lab'), 6, weights=v('wt'))), 'sums'),
        ('positive_negative_pair', lambda L, v: list(
            L.positive_negative_pair(v('score'), v('lab_f'), v('qid'),
                                     weight=v('wt'))), 'sums'),
        ('edit_distance', lambda L, v: list(L.edit_distance(
            v('ids'), v('ids2'), input_length=v('len'),
            label_length=v('len2'))), 'exact'),
    ]


def seq_ops_feed(b=16, t=24, d=32, c=6, seed=19):
    """The inputs of seq_ops_cases: floats in [-2, 2) with the edge values
    at the head of x3, lengths from 0 to t."""
    rng = np.random.RandomState(seed)

    def f(*shape):
        return rng.uniform(-2.0, 2.0, shape).astype('f')
    x3 = f(b, t, d)
    x3.reshape(-1)[:LAYERS_EDGE.size] = LAYERS_EDGE.ravel()
    lens = rng.randint(0, t + 1, b)
    lens[:3] = (0, t, 1)
    n = 40
    return {
        'x3': x3, 'x2': f(b, t), 'w2': f(b, t), 'row': f(b, d),
        'row3': f(b, 3 * d), 'x4': f(b, t, 4 * d) * 0.5,
        'x3g': f(b, t, 3 * d) * 0.5, 'h0': f(b, d) * 0.5,
        'logits': f(b, t, c), 'len': lens.astype('int64'),
        'label': rng.randint(1, c, (b, 5)).astype('int64'),
        'l_len': np.minimum(rng.randint(0, 6, b), lens).astype('int64'),
        'tags': rng.randint(0, c, (b, t)).astype('int64'),
        'ids': rng.randint(0, 7, (b, t)).astype('int64'),
        'ids2': rng.randint(0, 7, (b, t - 4)).astype('int64'),
        'len2': rng.randint(0, t - 3, b).astype('int64'),
        'idx': rng.randint(0, 6, (n, 1)).astype('int64'),
        'lab': rng.randint(0, 6, (n, 1)).astype('int64'),
        'lab_f': rng.randint(0, 3, (n, 1)).astype('f'),
        'wt': np.abs(f(n, 1)), 'score': f(n, 2),
        'qid': rng.randint(0, 4, (n, 1)).astype('int64')}


def recurrence_difference(got, want, bf16=False, grad=False):
    """None if ``got`` is within the tolerance of a recurrence, a product
    or a sum over T (tests/test_torch_sequence.py's rule): 1e-5 of the
    array's largest finite magnitude M (at least 1), and for a bf16 array
    (or a gradient under bf16 AMP) 2^-8 of its own magnitude and 2^-8 M
    (2^-6 M for a gradient) more; NaN and inf placed alike; integers
    exactly. Else the largest difference."""
    if np.asarray(want).dtype.name == 'bfloat16':
        bf16 = True
    r = np.asarray(want).astype(np.float64)
    g = np.asarray(got).astype(np.float64)
    if r.shape != g.shape:
        return float('inf')
    if np.asarray(want).dtype.kind in 'biu':
        return None if np.array_equal(r, g) else float('inf')
    special = ~np.isfinite(r) | ~np.isfinite(g)
    if not np.array_equal(r[special], g[special], equal_nan=True):
        return float('inf')
    fin = ~special
    if not fin.any():
        return None
    err = np.abs(g[fin] - r[fin])
    m = max(np.abs(r[fin]).max(), 1.0)
    bound = 1e-5 * m
    if bf16:
        bound = bound + 2.0 ** -8 * np.abs(r[fin]) + \
            2.0 ** (-6 if grad else -8) * m
    bad = err > bound
    return float(err[bad].max()) if bad.any() else None


def _seq_ops_program(pt, feed, amp):
    """Every case of seq_ops_cases in one program, each float input
    through its own -0.0 probe (cast to bf16 under amp); the loss sums
    reduce_sum of every float output. Returns (main, startup, [(name,
    rule, fetch names, gradient names)])."""
    main, startup = pt.Program(), pt.Program()
    cases = []
    with pt.program_guard(main, startup):
        L = pt.layers
        data = {k: L.data(name=k, shape=list(a.shape), dtype=str(a.dtype),
                          append_batch_size=False) for k, a in feed.items()}
        sums = []
        for name, build, rule in seq_ops_cases(pt):
            probed, grads = {}, []

            def v(k, name=name, probed=probed, grads=grads):
                if feed[k].dtype.kind != 'f':
                    return data[k]
                if k not in probed:
                    probe = L.create_parameter(
                        shape=list(feed[k].shape), dtype='float32',
                        name='%s_%s_probe' % (name, k),
                        default_initializer=pt.initializer.Constant(-0.0))
                    val = L.elementwise_add(data[k], probe)
                    probed[k] = L.cast(val, 'bfloat16') if amp else val
                    grads.append(probe.name + '@GRAD')
                return probed[k]
            outs = build(L, v)
            outs = outs if isinstance(outs, list) else [outs]
            floats = [o for o in outs if o.dtype in ('float32', 'bfloat16')]
            sums += [L.reduce_sum(L.cast(o, 'float32')) for o in floats]
            cases.append((name, rule, [o.name for o in outs],
                          grads if floats else []))
        loss = L.sums(sums)
        used = {g.name for _, g in pt.backward.append_backward(loss)}
    main.amp = amp
    return main, startup, [c[:3] + ([g for g in c[3] if g in used],)
                           for c in cases]


def phase_seq_ops(torch, pt, place, card, on_card):
    """19d: the 22 op types this slice adds in one captured program (B 16,
    T 24, lengths 0..24, the edge values at x's head), fp32 and bf16 AMP:
    every output and every probe's gradient on the card against the CPU
    place, exact where the op is (paths, indices, lengths, picks and
    moves), else recurrence_difference. Returns its numbers."""
    t0 = time.perf_counter()
    feed = seq_ops_feed()
    faults, total = [], 0
    for amp in (None, 'bf16'):
        compared = 0
        main, startup, cases = _seq_ops_program(pt, feed, amp)
        fetch = [f for _, _, outs, grads in cases for f in outs + grads]
        res = {}
        for mode, pl in (('card', place), ('host', pt.CPUPlace())):
            exe = pt.Executor(pl)
            with pt.scope_guard(pt.Scope()):
                # the startup draws its values on the host: both places
                # start from the same parameters
                exe.run(startup)
                for _ in range(2 if mode == 'card' else 1):
                    out = exe.run(main, feed=feed, fetch_list=fetch,
                                  return_numpy=False)
                if mode == 'card' and on_card:
                    require(exe.last_captured, 'phase 19d: the ops program '
                            'did not run captured')
            res[mode] = dict(zip(fetch, _numpy_all(torch, out)))
        for name, rule, outs, grads in cases:
            for f in outs + grads:
                grad = f in grads
                g, w = res['card'][f], res['host'][f]
                if rule == 'exact' and not grad:
                    diff = None if np.array_equal(g, w, equal_nan=True) \
                        else float('inf')
                else:
                    # the fetches arrive as fp32 arrays: under AMP every
                    # float array takes the bf16 rule
                    diff = recurrence_difference(g, w, bf16=amp is not None,
                                                 grad=grad)
                if diff is not None:
                    faults.append('%s %s %s: card and host differ by %r'
                                  % ('bf16' if amp else 'fp32', name, f,
                                     diff))
                compared += 1
        print('phase 19d %s: %d op types (%d cases) in one captured program '
              '(B 16, T 24, lengths 0..24): %d outputs and gradients card '
              'against host, %d outside the tolerance [%s]'
              % ('bf16' if amp else 'fp32', 22, len(cases), compared,
                 len(faults), card))
        total += compared
    require(not faults, 'phase 19d: %d differences:\n  %s'
            % (len(faults), '\n  '.join(faults)))
    return dict(ops_compared=total, seconds=time.perf_counter() - t0)


def phase_rnn(torch, pt, place, card, on_card, batch=128, seq=100,
              vocab=30000, hidden=128, warmup=3, steps=20, model_batch=64,
              model_seq=100, model_steps=3, small=False, host_place=None,
              wide_hidden=512, cells_hidden=1024):
    """Phase 19 (a, b, d; 19c is phase_rnn_kernels): bench_rnn_lstm timed
    and checked (and at hidden ``wide_hidden``, past the sequence kernels'
    plan), card against host at fp32, captured == eager == run_steps;
    the sequence models timed (their recurrences' launches exact) and card
    against host, and stacked_gru_tagger at hidden ``wide_hidden`` (past
    the GRU cluster's plan in fp32: the wide kernels) and ``cells_hidden``
    (past every GRU plan: the cells); every new op type card against host.
    Returns (the timed runs' launch counts, summary)."""
    t0 = time.perf_counter()
    host_place = host_place or pt.CPUPlace()
    runs, out = [], {}
    launches, out['bench_rnn_lstm'] = _rnn_timed(
        torch, pt, place, card, on_card, batch, seq, vocab, hidden, warmup,
        steps)
    runs.append(launches)
    # bench.py's hidden argument at a width past the sequence kernels'
    # plan: the per-position path (cells and products)
    launches, out['bench_rnn_lstm_wide'] = _rnn_timed(
        torch, pt, place, card, on_card, batch, seq, vocab, wide_hidden, 2,
        5)
    runs.append(launches)
    if on_card:
        torch.cuda.empty_cache()
    cbatch, cseq = (8, 16) if not small else (4, 8)
    lc, lh, rel = _rnn_small(torch, pt, (place, host_place), vocab, hidden,
                             cbatch, cseq)
    print('phase 19a card against host, fp32, batch %d x seq %d, lengths %s, '
          '3 steps: losses card %s, host %s (max rel %.3g, limit 1e-5) [%s]'
          % (cbatch, cseq, [cseq, 0, 5, 1, cseq, 9, 3, 12][:cbatch],
             ['%.7f' % v for v in lc], ['%.7f' % v for v in lh], rel, card))
    require(rel <= 1e-5, 'phase 19a: the card differs from the host')
    avg = _build_rnn_lstm(pt, vocab, hidden, 'bf16')
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    del host
    res = _three_ways(torch, pt, place, pt.default_main_program(), avg,
                      weights, rnn_lstm_feed(batch, seq, vocab, seed=1))
    bits = dict(eager=_moe_same_bits(res, 'captured', 'eager'),
                run_steps=_moe_same_bits(res, 'captured', 'run_steps'))
    print('phase 19a at width, bf16, 3 steps from one state: losses captured '
          '%s, eager %s, run_steps %s; captured == eager bit for bit (losses '
          'and %d scope variables): %s; run_steps == run: %s [%s]'
          % (['%.7f' % v for v in res['captured'][0]],
             ['%.7f' % v for v in res['eager'][0]],
             ['%.7f' % v for v in res['run_steps'][0]],
             len(res['captured'][1]), bits['eager'], bits['run_steps'], card))
    require(bits['eager'] and bits['run_steps'], 'phase 19a: captured, '
            'eager and run_steps differ')
    out['bits'] = bits
    out['card_vs_host'] = dict(loss_rel=rel)
    del res
    if on_card:
        torch.cuda.empty_cache()
    models = {}
    recurrences = seq_model_recurrences(small)
    for name, build in seq_model_builds(pt, model_seq, small=small).items():
        feed = seq_model_feed(name, model_batch, model_seq)
        launches, ms, one_graph = _seq_model_timed(torch, pt, place, on_card,
                                                   build, feed, 5)
        runs.append(launches)
        lcard, lhost = _compare_places(torch, pt, (place, host_place),
                                       build, feed, model_steps)
        rel = max(abs(a - b) / abs(b) for a, b in zip(lcard, lhost))
        cells = {k: launches[k] for k in rnn_want()}
        want = rnn_want()
        if name in recurrences:
            kind, width, layers = recurrences[name]
            want = recurrence_want(torch, kind, model_batch, model_seq,
                                   width, times=layers * 5)
        models[name] = dict(ms=ms, loss_rel=rel, launches=cells)
        print('phase 19b %s: batch %d x seq %d, lengths 1..%d, fp32, '
              'SGD(0.05): %.3f ms/step captured (%s), recurrence launches '
              'in 5 steps %s (want %s); %d '
              'steps card %s, host %s (max rel %.3g, limit 1e-4) [%s]'
              % (name, model_batch, model_seq, model_seq, ms,
                 'one graph' if one_graph else 'NOT one graph', cells, want,
                 model_steps, ['%.6f' % v for v in lcard],
                 ['%.6f' % v for v in lhost], rel, card))
        require(rel <= 1e-4, 'phase 19b %s: card and host differ' % name)
        if on_card:
            require(one_graph, 'phase 19b %s: not one captured graph' % name)
            require(cells == want, 'phase 19b %s: recurrence launches %s, '
                    'want %s' % (name, cells, want))
            torch.cuda.empty_cache()
    # stacked_gru_tagger past the GRU cluster's plan (the wide kernels)
    # and past every GRU plan (the cells and products), each on the main
    # path
    from paddle_tpu_torch.ops.kernels import rnn_cell as K
    for hidden_ in (wide_hidden, cells_hidden):
        build = seq_model_builds(pt, model_seq, small=small,
                                 gru_hidden=hidden_)['stacked_gru_tagger']
        feed = seq_model_feed('stacked_gru_tagger', model_batch, model_seq)
        launches, ms, one_graph = _seq_model_timed(torch, pt, place, on_card,
                                                   build, feed, 3)
        runs.append(launches)
        cells = {k: launches[k] for k in rnn_want()}
        want = recurrence_want(torch, 'gru', model_batch, model_seq, hidden_,
                               times=2 * 3)
        path = K.gru_path(model_batch, hidden_, torch.float32)
        models['stacked_gru_tagger_%d' % hidden_] = dict(
            ms=ms, launches=cells, hidden=hidden_, path=path)
        print('phase 19b stacked_gru_tagger at hidden %d (the GRU\'s path '
              'in fp32: %s): batch %d x seq %d, %.3f ms/step captured (%s), '
              'recurrence launches in 3 steps %s (want %s) [%s]'
              % (hidden_, path, model_batch, model_seq, ms,
                 'one graph' if one_graph else 'NOT one graph', cells, want,
                 card))
        if on_card:
            require(one_graph, 'phase 19b: the GRU tagger at hidden %d is '
                    'not one captured graph' % hidden_)
            require(cells == want, 'phase 19b: the GRU tagger at hidden %d '
                    'launched %s, want %s' % (hidden_, cells, want))
            torch.cuda.empty_cache()
    out['models'] = models
    out['ops'] = phase_seq_ops(torch, pt, place, card, on_card)
    out['seconds'] = time.perf_counter() - t0
    print('phase 19 (a, b, d) %.1f s' % out['seconds'])
    return runs, out


# ------------------------------------------------------------- phase 20
# the v1 seqToseq demo's widths (demo/seqToseq/seqToseq_net.py, the
# model models/rnn_search.py names as its source): word_vector_dim,
# encoder_size and decoder_size 512, source and target dictionaries of
# 30,000 words (wmt14)
RNN_SEARCH_WIDTH = dict(src_vocab=30000, trg_vocab=30000, emb_dim=512,
                        hidden_dim=512)
# the v1 seq2seq generation program (built by the JAX package's
# trainer_config_helpers shim) that tests/test_torch_rnn_search.py writes
GENERATION_FIXTURE = os.path.join(REPO, 'tests', 'fixtures',
                                  'generation_decode_v1.json')


def rnn_search_feed(batch, seq, vocab, seed=20, min_len=20):
    """A copy task at ``seq`` source and target tokens: source lengths
    drawn from [min_len, seq], the target masked past the same length."""
    rng = np.random.RandomState(seed)
    src = rng.randint(2, vocab, (batch, seq)).astype('int64')
    lens = rng.randint(min(min_len, seq), seq + 1, batch).astype('int32')
    lbl = (src % (vocab - 2) + 2).astype('int64')
    trg = np.concatenate([np.ones((batch, 1), 'int64'), lbl[:, :-1]], 1)
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype('float32')
    return {'src_word': src, 'src_len': lens, 'trg_word': trg,
            'lbl_word': lbl, 'lbl_mask': mask}


def _build_rnn_search(pt, dims, amp=None):
    """models/rnn_search.rnn_search with Adam(1e-3) in fresh default
    programs; returns the loss."""
    from paddle_tpu_torch.models import rnn_search as R
    pt.reset_default_programs()
    avg, _ = R.rnn_search(**dims)
    pt.optimizer.Adam(learning_rate=1e-3).minimize(avg)
    pt.default_main_program().amp = amp
    return avg


def rnn_search_decoders(pt, dims, max_out_len, beam):
    """The greedy and the beam program over the training parameters
    (shared by name): [(label, program, fetch names)]."""
    from paddle_tpu_torch.models import rnn_search as R
    gp, bp = pt.Program(), pt.Program()
    with pt.program_guard(gp, pt.Program()):
        ids, _ = R.rnn_search_greedy_infer(max_out_len=max_out_len, **dims)
    out = [('greedy', gp, [ids.name])]
    with pt.program_guard(bp, pt.Program()):
        ids, scores, _ = R.rnn_search_beam_infer(
            max_out_len=max_out_len, beam_size=beam, **dims)
    return out + [('beam %d' % beam, bp, [ids.name, scores.name])]


def _decode_timed(torch, pt, exe, scope, program, fetch, feed, calls,
                  on_card):
    """One eager run (use_program_cache=False), then the warm-up and the
    capture and ``calls`` timed replays: (ms a call, captured, the
    replay's fetches equal the eager run's, the fetches)."""
    with pt.scope_guard(scope):
        eager = exe.run(program, feed=feed, fetch_list=fetch,
                        use_program_cache=False)
        for _ in range(2):
            exe.run(program, feed=feed, fetch_list=fetch)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            got = exe.run(program, feed=feed, fetch_list=fetch,
                          return_numpy=False)
        if on_card:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / calls
        captured = exe.last_captured
    got = [v.cpu().numpy() for v in got]
    same = all(np.array_equal(a, b) for a, b in zip(eager, got))
    return ms, captured, same, got


def _rnn_search_timed(torch, pt, place, card, on_card, batch, seq, dims,
                      warmup, steps, amp=None, beam=4, calls=5,
                      max_out_len=None):
    """20a: models/rnn_search at ``dims``, Adam: ``warmup`` then ``steps``
    timed captured steps (wall and busy ms a step, device kernels a step,
    the encoder's recurrence launches); the same steps eager from the
    same start, bit for bit; then (fp32) greedy and beam decoding of the
    batch from the trained scope, each captured against its eager run.
    Returns (the timed steps' launch counts, row)."""
    t0 = time.perf_counter()
    avg = _build_rnn_search(pt, dims, amp)
    program = pt.default_main_program()
    n_params = sum(int(np.prod(p.shape)) for p in program.all_parameters())
    exe, scope = pt.Executor(place), pt.Scope()
    feed_np = rnn_search_feed(batch, seq, dims['src_vocab'])
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        snap = _snapshot(scope)
        feed = {n: torch.as_tensor(v).to(exe.device)
                for n, v in feed_np.items()}
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        _, first = _train_steps(torch, exe, feed, avg, warmup, on_card)
        reset_launches()
        secs, losses = _train_steps(torch, exe, feed, avg, steps, on_card)
        launches = read_launches()
        one_graph = exe.last_captured and exe.captures == 1
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        busy = kernels = None
        if on_card:
            busy, _, _, _, kernels = _busy_ms(torch, lambda: _train_steps(
                torch, exe, feed, avg, 3, on_card), 3)
    losses = first + losses
    eager_exe, eager_scope = pt.Executor(place), pt.Scope()
    for n, t in snap.items():
        eager_scope.set(n, t.clone())
    del snap
    with pt.scope_guard(eager_scope):
        eager = [float(eager_exe.run(feed=feed, fetch_list=[avg],
                                     use_program_cache=False,
                                     return_numpy=False)[0].float())
                 for _ in range(warmup + steps)]
    del eager_scope, eager_exe
    bits = eager == losses
    ms = secs * 1e3 / steps
    hidden = dims['hidden_dim']
    want = recurrence_want(torch, 'gru', batch, seq, hidden,
                           torch.bfloat16 if amp else torch.float32,
                           2 * steps)
    row = dict(ms=ms, busy_ms=busy, kernels_per_step=kernels,
               tokens_per_s=batch * seq * steps / secs, params=n_params,
               peak_gb=peak / 1e9, loss_first=losses[0],
               loss_last=losses[-1], captured_equals_eager=bits,
               launches={k: launches[k] for k in want})
    print('phase 20a rnn_search (%s): vocab %d/%d, emb %d, hidden %d, %d '
          'params, batch %d x src %d x trg %d (source lengths %d..%d), '
          'Adam(1e-3), amp %s; build + startup %.2f s; %d timed steps after '
          '%d warm-up: %.3f ms/step wall, %s ms/step device busy, %s '
          'device kernels/step, %.1f target tokens/s; max_memory_allocated '
          '%.3f GB; loss first %.6f last %.6f; captured == eager bit for bit '
          '(%d losses): %s; encoder recurrence launches %s (want %s) [%s]'
          % ('one graph' if one_graph else 'NOT one graph',
             dims['src_vocab'], dims['trg_vocab'], dims['emb_dim'], hidden,
             n_params, batch, seq, seq, feed_np['src_len'].min(),
             feed_np['src_len'].max(), amp, t1 - t0, steps, warmup, ms,
             'n/a' if busy is None else '%.3f' % busy,
             'n/a' if kernels is None else '%.1f' % kernels,
             row['tokens_per_s'], row['peak_gb'], losses[0], losses[-1],
             len(losses), bits, row['launches'], want, card))
    require(np.isfinite(losses).all(), 'rnn_search: loss not finite')
    require(losses[-1] < losses[0], 'rnn_search: loss did not fall: %s'
            % losses)
    require(bits, 'phase 20a: captured losses %s differ from eager %s'
            % (losses, eager))
    if on_card:
        require(one_graph, 'phase 20a: rnn_search is not one captured graph '
                '(%d captures)' % exe.captures)
        require(row['launches'] == want, 'phase 20a: encoder recurrence '
                'launches %s, want %s' % (row['launches'], want))
    if amp is None:
        src = {n: feed[n] for n in ('src_word', 'src_len')}
        for label, prog, fetch in rnn_search_decoders(
                pt, dims, max_out_len or seq, beam):
            dms, captured, same, got = _decode_timed(
                torch, pt, exe, scope, prog, fetch, src, calls, on_card)
            row[label] = dict(ms=dms, captured=captured, equals_eager=same)
            print('phase 20a rnn_search %s decode, batch %d, max_out_len '
                  '%d: %.3f ms/batch (%s), ids %s; ids equal the eager '
                  'run\'s: %s [%s]'
                  % (label, batch, max_out_len or seq, dms,
                     'captured' if captured else 'NOT captured',
                     'x'.join(str(s) for s in got[0].shape), same, card))
            require(same, 'phase 20a: the %s decode differs from its eager '
                    'run' % label)
            require(got[0].min() >= 0 and
                    got[0].max() < dims['trg_vocab'],
                    'phase 20a: %s ids out of the vocabulary' % label)
            if on_card:
                require(captured, 'phase 20a: the %s decode was not '
                        'captured' % label)
    del exe, scope
    return launches, row


def rnn_search_places(torch, pt, places, dims, batch, seq, steps=3):
    """20b: ``steps`` Adam steps of rnn_search from the host startup's
    weights on each place, then greedy decoding from each trained scope:
    ([losses of each place], [ids of each place], the first place's
    training launch counts)."""
    from paddle_tpu_torch.weights import load_into_scope
    avg = _build_rnn_search(pt, dims)
    main, start = pt.default_main_program(), pt.default_startup_program()
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(start)
    weights = {n: host.numpy(n) for n in host.keys()}
    feed = rnn_search_feed(batch, seq, dims['src_vocab'], seed=21,
                           min_len=max(1, seq // 4))
    _, greedy, fetch = rnn_search_decoders(pt, dims, seq, 2)[0]
    losses, ids, launches = [], [], None
    for i, place in enumerate(places):
        scope, exe = pt.Scope(), pt.Executor(place)
        load_into_scope(weights, scope, place)
        with pt.scope_guard(scope):
            if i == 0:
                reset_launches()
            losses.append([float(np.asarray(exe.run(
                main, feed=feed, fetch_list=[avg])[0]).reshape(()))
                for _ in range(steps)])
            if i == 0:
                launches = read_launches()
            ids.append(exe.run(greedy, feed={n: feed[n] for n in (
                'src_word', 'src_len')}, fetch_list=fetch)[0])
    return losses, ids, launches


def control_flow_builds(pkg):
    """{name: (build, feed)}: a While countdown over a tensor array (each
    turn writes twice the last entry one slot on), an IfElse and a
    StaticRNN, each of exact IEEE operations (adds, products, scales by
    powers of 2), so every place gives the same bits. ``pkg``: the
    package whose layers build (the port, or in the tests the
    reference)."""
    L = pkg.layers
    rng = np.random.RandomState(20)
    x2 = rng.uniform(-2, 2, (8, 4)).astype('float32')
    x3 = rng.uniform(-2, 2, (8, 6, 4)).astype('float32')

    def countdown():
        x = L.data(name='x', shape=[4], dtype='float32')
        i = L.fill_constant(shape=[1], dtype='int64', value=0)
        limit = L.fill_constant(shape=[1], dtype='int64', value=6)
        arr = L.array_write(x, i)
        cond = L.less_than(x=i, y=limit)
        w = L.While(cond=cond)
        with w.block():
            prev = L.array_read(arr, i)
            L.increment(x=i, value=1, in_place=True)
            L.array_write(L.scale(prev, scale=2.0), i, array=arr)
            L.less_than(x=i, y=limit, cond=cond)
        return [L.array_read(arr, limit), i, L.array_length(arr)]

    def if_else():
        x = L.data(name='x', shape=[4], dtype='float32')
        zeros = L.fill_constant_batch_size_like(x, shape=[1, 1],
                                                dtype='float32', value=0.0)
        cond = L.less_than(x=zeros, y=L.reduce_sum(x, dim=1, keep_dim=True))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.scale(x, scale=2.0))
        with ie.false_block():
            ie.output(L.elementwise_mul(x, x))
        return list(ie())

    def static_rnn():
        x = L.data(name='x', shape=[6, 4], dtype='float32')
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(batch_ref=x, shape=[4], value=0.0)
            h = L.elementwise_add(L.scale(mem, scale=0.5), xt)
            rnn.update_memory(mem, h)
            rnn.step_output(h)
        return [rnn()]
    return {'while': (countdown, {'x': x2}), 'if_else': (if_else, {'x': x2}),
            'static_rnn': (static_rnn, {'x': x3})}


def control_flow_on_card(pt, place, card, on_card):
    """20c: each control-flow program three times on ``place`` (the third
    a replay where it is captured) against one run on the host, exact;
    the While program runs eagerly every time."""
    out = {}
    for name, (build, feed) in sorted(control_flow_builds(pt).items()):
        pt.reset_default_programs()
        fetch = [v.name for v in build()]
        exe = pt.Executor(place)
        for _ in range(3):
            got = exe.run(feed=feed, fetch_list=fetch)
        captured = exe.last_captured
        want = pt.Executor(pt.CPUPlace()).run(feed=feed, fetch_list=fetch)
        same = all(np.array_equal(a, b) for a, b in zip(got, want))
        out[name] = dict(captured=captured, equals_host=same)
        print('phase 20c %s: %s on the third run; card == host exactly: %s '
              '[%s]' % (name, 'captured' if captured else 'eager', same,
                        card))
        require(same, 'phase 20c: %s differs from the host' % name)
        if on_card:
            require(captured == (name != 'while'), 'phase 20c: %s ran %s'
                    % (name, 'captured' if captured else 'eagerly'))
    return out


def ssd_feed(batch, size, max_gt, classes, seed=22):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(0.05, 0.6, (batch, max_gt, 4)).astype('float32')
    gt[:, :, 2:] = gt[:, :, :2] + rng.uniform(
        0.1, 0.35, (batch, max_gt, 2)).astype('float32')
    return {'image': rng.rand(batch, 3, size, size).astype('float32'),
            'gt_box': gt,
            'gt_label': rng.randint(1, classes, (batch, max_gt)).astype(
                'int64')}


def _build_ssd(pt, classes, size, max_gt):
    from paddle_tpu_torch.models import ssd
    pt.reset_default_programs()
    avg, _ = ssd.ssd_train(num_classes=classes, image_shape=(3, size, size),
                           max_gt=max_gt)
    pt.optimizer.Adam(learning_rate=1e-3).minimize(avg)
    return avg


def _ssd_infer_program(pt, classes, size):
    """ssd_infer in fresh default programs (its layers take the training
    program's parameter names): (program, the detections' name)."""
    from paddle_tpu_torch.models import ssd
    pt.reset_default_programs()
    out, _ = ssd.ssd_infer(num_classes=classes, image_shape=(3, size, size))
    return pt.default_main_program(), out.name


def _ssd_timed(torch, pt, place, card, on_card, batch, size, classes,
               max_gt, warmup, steps, calls=5):
    """20d: models/ssd.ssd_train, Adam, fp32: ``warmup`` then ``steps``
    timed captured steps (K5's launches: 5 forward and 5 backward a step),
    then ssd_infer's detection_output on the trained scope, captured
    against eager. Returns (the timed steps' launch counts, row)."""
    avg = _build_ssd(pt, classes, size, max_gt)
    exe, scope = pt.Executor(place), pt.Scope()
    feed_np = ssd_feed(batch, size, max_gt, classes)
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        feed = {n: torch.as_tensor(v).to(exe.device)
                for n, v in feed_np.items()}
        _, first = _train_steps(torch, exe, feed, avg, warmup, on_card)
        reset_launches()
        secs, losses = _train_steps(torch, exe, feed, avg, steps, on_card)
        launches = read_launches()
        one_graph = exe.last_captured and exe.captures == 1
        busy = kernels = None
        if on_card:
            busy, _, _, _, kernels = _busy_ms(torch, lambda: _train_steps(
                torch, exe, feed, avg, 3, on_card), 3)
    losses = first + losses
    ms = secs * 1e3 / steps
    want = dict(batch_norm=5 * steps, batch_norm_bwd=5 * steps)
    got = {k: launches[k] for k in want}
    print('phase 20d ssd_train (%s): %d classes, 3 x %d x %d, max_gt %d, '
          'batch %d, Adam(1e-3), fp32: %d timed steps after %d warm-up: '
          '%.3f ms/step wall, %s ms/step device busy, %s device kernels/step; '
          'loss first %.5f last %.5f; K5 launches %s (want %s) [%s]'
          % ('one graph' if one_graph else 'NOT one graph', classes, size,
             size, max_gt, batch, steps, warmup, ms,
             'n/a' if busy is None else '%.3f' % busy,
             'n/a' if kernels is None else '%.1f' % kernels, losses[0],
             losses[-1], got, want, card))
    require(np.isfinite(losses).all(), 'ssd: loss not finite')
    require(losses[-1] < losses[0], 'ssd: loss did not fall: %s' % losses)
    if on_card:
        require(one_graph, 'phase 20d: ssd_train is not one captured graph')
        require(got == want, 'phase 20d: K5 launches %s, want %s'
                % (got, want))
    program, name = _ssd_infer_program(pt, classes, size)
    dms, captured, same, det = _decode_timed(
        torch, pt, exe, scope, program, [name], {'image': feed['image']},
        calls, on_card)
    print('phase 20d ssd_infer detection_output, batch %d: %.3f ms/batch '
          '(%s), detections %s, %d kept; equal to the eager run: %s [%s]'
          % (batch, dms, 'captured' if captured else 'NOT captured',
             'x'.join(str(s) for s in det[0].shape),
             int((det[0][..., 0] >= 0).sum()), same, card))
    require(same, 'phase 20d: detection_output differs from its eager run')
    if on_card:
        require(captured, 'phase 20d: detection_output was not captured')
    row = dict(ms=ms, busy_ms=busy, kernels_per_step=kernels,
               loss_first=losses[0], loss_last=losses[-1], launches=got,
               infer_ms=dms)
    return launches, row


def ssd_places(torch, pt, places, batch=2, size=64, classes=4, max_gt=3,
               steps=3):
    """20d card against host: ``steps`` Adam steps of ssd_train from the
    host startup's weights on each place, then ssd_infer's detections
    from each trained scope: ([losses], [detections], the first place's
    training launch counts)."""
    from paddle_tpu_torch.weights import load_into_scope
    avg = _build_ssd(pt, classes, size, max_gt)
    main, start = pt.default_main_program(), pt.default_startup_program()
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(start)
    weights = {n: host.numpy(n) for n in host.keys()}
    feed = ssd_feed(batch, size, max_gt, classes, seed=23)
    infer, name = _ssd_infer_program(pt, classes, size)
    losses, dets, launches = [], [], None
    for i, place in enumerate(places):
        scope, exe = pt.Scope(), pt.Executor(place)
        load_into_scope(weights, scope, place)
        with pt.scope_guard(scope):
            if i == 0:
                reset_launches()
            losses.append([float(np.asarray(exe.run(
                main, feed=feed, fetch_list=[avg])[0]).reshape(()))
                for _ in range(steps)])
            if i == 0:
                launches = read_launches()
            dets.append(exe.run(infer, feed={'image': feed['image']},
                                fetch_list=[name])[0])
    return losses, dets, launches


def generation_places(torch, pt, places):
    """20e: the fixture's v1 generation program (generation_decode, beam
    4) from its own startup's weights on each place, run three times
    (captured on the card): [(ids, scores, captured) of each place]."""
    from paddle_tpu_torch.core.serialize import program_from_dict
    from paddle_tpu_torch.weights import load_into_scope
    with open(GENERATION_FIXTURE) as f:
        fixture = json.load(f)
    main = program_from_dict(fixture['main'])
    start = program_from_dict(fixture['startup'])
    v1 = fixture['v1']
    rng = np.random.RandomState(24)
    feed = {'src': rng.randint(2, v1['vocab'], (v1['batch'], v1['t']))
            .astype('int64'),
            'src_len': rng.randint(1, v1['t'] + 1, v1['batch'])
            .astype('int32')}
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(start)
    weights = {n: host.numpy(n) for n in host.keys()}
    out = []
    for place in places:
        scope, exe = pt.Scope(), pt.Executor(place)
        load_into_scope(weights, scope, place)
        with pt.scope_guard(scope):
            for _ in range(3):
                ids, scores = exe.run(main, feed=feed,
                                      fetch_list=fixture['fetch'])
        out.append((ids, scores, exe.last_captured))
    return out, v1


def phase_control_flow(torch, pt, place, card, on_card, small=False,
                       host_place=None):
    """Phase 20: (a) rnn_search at the seqToseq demo's widths, batch 64 x
    50 tokens, fp32 then bf16 AMP, and its greedy and beam 4 decoding;
    (b) rnn_search at hidden 128 card against host; (c) the control-flow
    programs card against host, While eager and the others captured; (d)
    SSD training and detection at the model's defaults, batch 32, and at
    64 x 64 card against host; (e) generation_decode card against host.
    Returns (the timed runs' launch counts, summary)."""
    t0 = time.perf_counter()
    host_place = host_place or pt.CPUPlace()
    runs, out = [], {}
    if small:
        dims = dict(src_vocab=64, trg_vocab=64, emb_dim=16, hidden_dim=16)
        batch, seq, warmup, steps, bf16_steps = 4, 8, 2, 2, 2
    else:
        dims, batch, seq = RNN_SEARCH_WIDTH, 64, 50
        warmup, steps, bf16_steps = 3, 10, 5
    launches, out['rnn_search'] = _rnn_search_timed(
        torch, pt, place, card, on_card, batch, seq, dims, warmup, steps)
    runs.append(launches)
    if on_card:
        torch.cuda.empty_cache()
    launches, out['rnn_search_bf16'] = _rnn_search_timed(
        torch, pt, place, card, on_card, batch, seq, dims, 2, bf16_steps,
        amp='bf16')
    runs.append(launches)
    if on_card:
        torch.cuda.empty_cache()
    small_dims = dict(src_vocab=1000, trg_vocab=1000, emb_dim=128,
                      hidden_dim=128)
    cbatch, cseq = (16, 20) if not small else (4, 8)
    losses, ids, launches = rnn_search_places(
        torch, pt, (place, host_place), small_dims, cbatch, cseq)
    runs.append(launches)
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    want = recurrence_want(torch, 'gru', cbatch, cseq, 128, times=2 * 3)
    got = {k: launches[k] for k in want}
    same = np.array_equal(ids[0], ids[1])
    out['rnn_search_vs_host'] = dict(loss_rel=rel, greedy_equal=same,
                                     launches=got)
    print('phase 20b rnn_search hidden 128, vocab 1000, batch %d x %d: 3 '
          'Adam steps card %s, host %s (max rel %.3g, limit 1e-4); encoder '
          'recurrence launches %s (want %s); greedy ids card == host: %s '
          '[%s]' % (cbatch, cseq, ['%.7f' % v for v in losses[0]],
                    ['%.7f' % v for v in losses[1]], rel, got, want, same,
                    card))
    require(rel <= 1e-4, 'phase 20b: the card differs from the host')
    require(same, 'phase 20b: greedy ids differ between card and host')
    if on_card:
        require(got == want, 'phase 20b: launches %s, want %s' % (got, want))
    out['control_flow'] = control_flow_on_card(pt, place, card, on_card)
    if small:
        sbatch, ssize, sclasses, swarm, ssteps = 2, 64, 4, 2, 2
    else:
        sbatch, ssize, sclasses, swarm, ssteps = 32, 128, 21, 3, 10
    launches, out['ssd'] = _ssd_timed(torch, pt, place, card, on_card,
                                      sbatch, ssize, sclasses, 8, swarm,
                                      ssteps)
    runs.append(launches)
    if on_card:
        torch.cuda.empty_cache()
    losses, dets, _ = ssd_places(torch, pt, (place, host_place))
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    labels = np.array_equal(dets[0][..., 0], dets[1][..., 0])
    box_err = float(np.abs(dets[0][..., 1:] - dets[1][..., 1:]).max())
    out['ssd_vs_host'] = dict(loss_rel=rel, labels_equal=labels,
                              box_score_err=box_err)
    print('phase 20d ssd 3 x 64 x 64, 4 classes, batch 2: 3 Adam steps card '
          '%s, host %s (max rel %.3g, limit 1e-4); detections %d kept, '
          'labels card == host: %s, scores and boxes max |diff| %.3g (limit '
          '1e-5) [%s]' % (['%.6f' % v for v in losses[0]],
                         ['%.6f' % v for v in losses[1]], rel,
                         int((dets[0][..., 0] >= 0).sum()), labels, box_err,
                         card))
    require(rel <= 1e-4, 'phase 20d: SSD losses differ between card and host')
    require(labels and box_err <= 1e-5, 'phase 20d: detections differ '
            'between card and host')
    (ci, cs, ccap), (hi, hs, _) = generation_places(torch, pt,
                                                    (place, host_place))[0]
    same = np.array_equal(ci, hi)
    err = float(np.abs(cs - hs).max())
    out['generation_decode'] = dict(ids_equal=same, score_err=err,
                                    captured=ccap)
    print('phase 20e generation_decode (the v1 seq2seq of '
          'tests/fixtures/generation_decode_v1.json, beam 4): sentences %s, '
          '%s on the card; ids card == host: %s, scores max |diff| %.3g '
          '[%s]' % ('x'.join(str(s) for s in ci.shape),
                    'captured' if ccap else 'NOT captured', same, err, card))
    require(same and err <= 1e-5, 'phase 20e: generation_decode differs '
            'between card and host')
    if on_card:
        require(ccap, 'phase 20e: generation_decode was not captured')
    out['seconds'] = time.perf_counter() - t0
    print('phase 20 %.1f s' % out['seconds'])
    return runs, out


# ------------------------------------------------------------ phase 21
def _conv_program(pt, builder, image, chans, class_dim, amp, lr, **kw):
    """One of the conv path's classifiers through the port's user API on
    the default programs: data 'image' [chans, image, image] (the MNIST
    nets' own 'img'), an int64 'label', the model's softmax output, mean
    cross-entropy, Momentum(lr, 0.9).minimize, amp on the main program.
    Returns the loss var."""
    from paddle_tpu_torch.models import (alexnet, googlenet, lenet,
                                         mobilenet, resnext, vgg)
    pt.reset_default_programs()
    if builder == 'lenet':
        _, avg, _ = lenet.convolutional_neural_network()
    else:
        img = pt.layers.data(name='image', shape=[chans, image, image],
                             dtype='float32')
        label = pt.layers.data(name='label', shape=[1], dtype='int64')
        fn = {'mobile_net': mobilenet.mobile_net,
              'se_resnext': resnext.se_resnext, 'vgg16': vgg.vgg16,
              'vgg_bn_drop': vgg.vgg_bn_drop, 'alexnet': alexnet.alexnet,
              'googlenet': googlenet.googlenet}[builder]
        avg = pt.layers.mean(pt.layers.cross_entropy(
            fn(img, class_dim=class_dim, **kw), label))
    pt.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(avg)
    pt.default_main_program().amp = amp
    return avg


def conv_feed(builder, batch, image, chans=3, class_dim=1000, seed=0):
    rng = np.random.RandomState(seed)
    name = 'img' if builder == 'lenet' else 'image'
    return {name: rng.rand(batch, chans, image, image).astype('float32'),
            'label': rng.randint(0, class_dim, (batch, 1)).astype('int64')}


# the full-width paths (21a) and the other models at their published
# inputs (21b): (label, builder, image, channels, batch, amp, builder
# arguments, K5 launches a step each way)
CONV_WIDE = [
    ('MobileNet v1 NHWC', 'mobile_net', 224, 3, 64, 'bf16',
     dict(scale=1.0, data_format='NHWC'), 27),
    ('MobileNet v1 NCHW', 'mobile_net', 224, 3, 64, 'bf16',
     dict(scale=1.0, data_format='NCHW'), 27),
    ('SE-ResNeXt-50 32x4d', 'se_resnext', 224, 3, 32, 'bf16',
     dict(depth=50, cardinality=32, reduction_ratio=16), 53),
]
CONV_OTHERS = [
    ('VGG-16', 'vgg16', 224, 3, 64, 'bf16', {}, 0),
    ('AlexNet', 'alexnet', 224, 3, 64, 'bf16', {}, 0),
    ('GoogLeNet', 'googlenet', 224, 3, 64, 'bf16', {}, 0),
    ('LeNet-5', 'lenet', 28, 1, 64, None, {}, 0),
    ('vgg_bn_drop fp32', 'vgg_bn_drop', 32, 3, 128, None, {}, 14),
    ('vgg_bn_drop bf16', 'vgg_bn_drop', 32, 3, 128, 'bf16', {}, 14),
]


# max pools a step of each model (pool2d max, not global), one
# max_pool_fwd and one max_pool_bwd launch each
MAX_POOLS_A_STEP = {'resnet': 1, 'mobile_net': 0, 'se_resnext': 1,
                    'vgg16': 5, 'alexnet': 3, 'googlenet': 13, 'lenet': 2,
                    'vgg_bn_drop': 5}


def max_pools(program):
    """The max pool2d ops (not global) of ``program``."""
    return sum(op.type == 'pool2d' and
               op.attrs.get('pooling_type', 'max') == 'max' and
               not op.attrs.get('global_pooling', False)
               for op in program.global_block().ops)


def require_pools(launches, steps, want, label):
    """One max_pool_fwd and one max_pool_bwd launch a max pool a step."""
    got = (launches['max_pool_fwd'] / steps, launches['max_pool_bwd'] / steps)
    require(got == (want, want), '%s: max pool launches a step %s, want %d '
            'each' % (label, got, want))
    return got


def _conv_timed(torch, pt, place, card, on_card, case, lr, warmup, steps,
                eager_steps=0, class_dim=1000, busy=False):
    """``case`` trained on ``place``: ``eager_steps`` steps with
    use_program_cache=False, then ``warmup`` steps (the eager run and the
    capture) and ``steps`` timed captured steps, whose launch counts are
    returned with the numbers: ms a step captured and eager, images/s,
    with ``busy`` the device-busy ms and kernels a step (torch.profiler
    over 3 more steps), losses."""
    label, builder, image, chans, batch, amp, kw, n_bn = case
    classes = 10 if builder in ('vgg_bn_drop', 'lenet') else class_dim
    avg = _conv_program(pt, builder, image, chans, classes, amp, lr, **kw)
    program = pt.default_main_program()
    require(max_pools(program) == MAX_POOLS_A_STEP[builder],
            '%s: %d max pools, want %d' % (label, max_pools(program),
                                           MAX_POOLS_A_STEP[builder]))
    exe = pt.Executor(place)
    scope = pt.Scope()
    feed = conv_feed(builder, batch, image, chans, classes)
    out = dict(batch=batch, image=image, amp=amp or 'fp32')
    with pt.scope_guard(scope):
        exe.run(pt.default_startup_program())
        feed = {n: torch.as_tensor(v).to(exe.device) for n, v in feed.items()}

        def run(n, cache=True):
            return [exe.run(program, feed=feed, fetch_list=[avg],
                            return_numpy=False, use_program_cache=cache)[0]
                    for _ in range(n)]
        losses = []
        if eager_steps:
            run(1, cache=False)
            _sync(torch, on_card)
            t0 = time.perf_counter()
            losses += run(eager_steps, cache=False)
            _sync(torch, on_card)
            out['eager_ms'] = (time.perf_counter() - t0) * 1e3 / eager_steps
        losses += run(warmup)
        reset_launches()
        _sync(torch, on_card)
        t0 = time.perf_counter()
        losses += run(steps)
        _sync(torch, on_card)
        secs = time.perf_counter() - t0
        launches = read_launches()
        if on_card:
            require(exe.last_captured, '%s: the timed steps ran eagerly'
                    % label)
        if busy and on_card:
            b, _, _, _, kernels = _busy_ms(torch, lambda: run(3), 3)
            out.update(busy_ms=b, kernels_per_step=kernels)
    losses = [float(v.float()) for v in losses]
    ms = secs * 1e3 / steps
    out.update(ms=ms, images_per_s=batch * steps / secs,
               loss_first=losses[0], loss_last=losses[-1],
               bn_per_step=(launches['batch_norm'] / steps,
                            launches['batch_norm_bwd'] / steps))
    if 'busy_ms' in out:
        out['busy_share'] = out['busy_ms'] / ms
    print('phase 21 %s: batch %d x %d x %d x %d, %s, Momentum(%g, 0.9); '
          '%d timed captured steps after %d: %.3f ms/step, %.1f images/s%s%s'
          '; loss %.5f -> %.5f; K5 a step: forward %g, backward %g (want %d '
          'each); max pool a step: forward %g, backward %g (want %d each) '
          '[%s]'
          % (label, batch, chans, image, image, out['amp'], lr, steps,
             warmup + eager_steps, ms, out['images_per_s'],
             '; eager %.3f ms/step' % out['eager_ms'] if eager_steps else '',
             '; device busy %.3f ms/step (%.3f of the wall), %.0f kernels a '
             'step' % (out['busy_ms'], out['busy_share'],
                       out['kernels_per_step']) if 'busy_ms' in out else '',
             losses[0], losses[-1], out['bn_per_step'][0],
             out['bn_per_step'][1], n_bn, launches['max_pool_fwd'] / steps,
             launches['max_pool_bwd'] / steps, MAX_POOLS_A_STEP[builder],
             card))
    require(np.isfinite(losses).all(), '%s: loss not finite: %s'
            % (label, losses))
    require(losses[-1] < losses[0], '%s: loss did not fall over a repeated '
            'batch: %s' % (label, losses))
    if on_card:
        require(out['bn_per_step'] == (n_bn, n_bn),
                '%s: K5 launches a step %s, want %d each'
                % (label, out['bn_per_step'], n_bn))
        out['pools_per_step'] = require_pools(
            launches, steps, MAX_POOLS_A_STEP[builder], label)
    return launches, out


# the small builds card against host (21c) and captured against eager
# (21a): (label, builder, image, batch, builder arguments, fp32 limit of
# the first step's gradient gap, conv_grad_gaps' norm over all
# parameters); the sizes of tests/test_torch_cnn_models.py and its
# companions, but SE-ResNeXt's: at 32^2 x 4 its last stage normalizes 4
# values a channel, and a one-ulp nudge of the images moves its first
# loss by 8e-5 on the host alone (tests/torch_cnn_conditioning.py). The
# limits: 2x the gaps that the nudge or another order of the host's
# convolution sums gives there (BN nets), 1e-3 for the others. Under bf16
# AMP the limit is twice the gap between the host's own bf16 and fp32
# gradients: bf16 rounding alone moves them by 1.6 % (LeNet-5) to 133 %
# (MobileNet) of their norm at these builds
CONV_SMALL = [
    ('MobileNet NHWC', 'mobile_net', 32, 16,
     dict(scale=0.25, data_format='NHWC'), 0.1),
    ('MobileNet NCHW', 'mobile_net', 32, 16,
     dict(scale=0.25, data_format='NCHW'), 0.1),
    ('SE-ResNeXt-50', 'se_resnext', 64, 8, dict(depth=50, cardinality=8),
     0.1),
    ('vgg_bn_drop', 'vgg_bn_drop', 32, 16, {}, 0.05),
    ('AlexNet', 'alexnet', 67, 4, {}, 1e-3),
    ('GoogLeNet', 'googlenet', 64, 4, {}, 1e-3),
    ('LeNet-5', 'lenet', 28, 8, {}, 1e-3),
]

def _conv_small_program(pt, case, amp):
    _, builder, image, _, kw = case[:5]
    return _conv_program(pt, builder, image, 1 if builder == 'lenet' else 3,
                         10, amp, 0.01, **kw)


def _conv_weights(pt):
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    return {n: host.numpy(n) for n in host.keys()}


def conv_places(torch, pt, places, case, amp, steps=2):
    """2 Momentum(0.01) steps of a small build on each place from the same
    weights (dropout at its published rate: the port's bits do not depend
    on the device). Returns, a place, (losses, the first step's gradient
    of each parameter)."""
    from paddle_tpu_torch.weights import load_into_scope
    builder, image, batch = case[1:4]
    avg = _conv_small_program(pt, case, amp)
    main = pt.default_main_program()
    grads = [p.name + '@GRAD' for p in main.all_parameters()]
    weights = _conv_weights(pt)
    feed = conv_feed(builder, batch, image, 1 if builder == 'lenet' else 3,
                     10, seed=1)
    runs = []
    for place in places:
        scope = pt.Scope()
        load_into_scope(weights, scope, place)
        exe = pt.Executor(place)
        losses = []
        with pt.scope_guard(scope):
            for i in range(steps):
                out = exe.run(main, feed=feed,
                              fetch_list=[avg] + (grads if i == 0 else []))
                losses.append(out[0].item())
                if i == 0:
                    first = {g: np.asarray(v, 'float64')
                             for g, v in zip(grads, out[1:])}
        runs.append((losses, first))
    return runs


def conv_grad_gaps(card, host):
    """(largest ||card - host|| / ||host|| of a parameter's gradient, its
    norm floored at 1e-3 of the largest parameter's (a conv bias before a
    batch norm has gradient 0 up to rounding); the same over all
    parameters together)."""
    norms = {n: float(np.linalg.norm(h)) for n, h in host.items()}
    top = max(norms.values())
    each = max(float(np.linalg.norm(card[n] - h)) /
               max(norms[n], 1e-3 * top, 1e-30) for n, h in host.items())
    whole = (sum(float(np.square(card[n] - h).sum())
                 for n, h in host.items()) /
             sum(v * v for v in norms.values())) ** 0.5
    return each, whole


def conv_captured_vs_eager(torch, pt, place, card, case):
    """Phase 11(b)'s check on a small fp32 build: the first step captured
    against eager, with cuDNN's default algorithms (printed) and under
    cudnn.deterministic (within 1e-6 relative: the loss, and every scope
    variable against its largest entry)."""
    builder, image, batch = case[1:4]
    avg = _conv_small_program(pt, case, None)
    weights = _conv_weights(pt)
    feed = conv_feed(builder, batch, image, 1 if builder == 'lenet' else 3,
                     10, seed=2)

    def gap(a, b):
        rel = float(np.max(np.abs(a[0] - b[0]) / np.abs(b[0])))
        return max([rel] + [float(np.abs(a[1][n] - v).max()) /
                            max(float(np.abs(v).max()), 1e-30)
                            for n, v in b[1].items()])
    found = {}
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        try:
            res = _three_ways(torch, pt, place, pt.default_main_program(),
                              avg, weights, feed, steps=1,
                              modes=('captured', 'eager'))
        finally:
            torch.backends.cudnn.deterministic = False
        found[deterministic] = gap(res['captured'], res['eager'])
    print('phase 21a %s %dx%d batch %d fp32: the first step captured vs '
          'eager within %.3g relative with cuDNN\'s default algorithms, '
          '%.3g under cudnn.deterministic (limit 1e-6) [%s]'
          % (case[0], image, image, batch, found[False], found[True], card))
    require(found[True] <= 1e-6, 'phase 21a %s: captured differs from '
            'eager' % case[0])
    return found


def _conv_sums(torch, device, fn, inputs, terms):
    """A convolution case's ``sums`` (parity_difference's, given with
    terms 1): ``fn`` of the |inputs| (feed names) and the gradient of its
    sum, each element's magnitude of terms times its count of terms
    (``terms``: the output's, then each input's), fp32 on ``device``."""
    def sums_of(feed):
        a = [torch.as_tensor(np.abs(feed[k])).to(device).requires_grad_()
             for k in inputs]
        out = fn(*a)
        out.backward(torch.ones_like(out))

        def scaled(t, count):
            return t.detach().double().cpu().numpy() * count
        return [scaled(out, terms[0])], {
            k: scaled(t.grad, c) for k, t, c in zip(inputs, a, terms[1:])}
    return sums_of


def conv_op_cases(torch, pt, device, rng, small=False):
    """21d at working sizes (``small``: the rehearsal's): (label, x, extra,
    case). x is the op's first input, fed as [n, d] (its leading
    dimensions flattened) and reshaped in the program; extra: {name:
    (array, probed)} of its other inputs, a probed one held for its
    gradient; case: _layers_ops_program's (name, build, exact, terms,
    sums), the convolutions' sums from _conv_sums on ``device``. The loss
    sums every float output (group_norm's Y times a fixed random tensor:
    under a cotangent of ones its gradients are sums that cancel)."""
    F = torch.nn.functional
    f = np.float32
    rois = np.zeros((128, 5), 'int64')
    rois[:, 0] = rng.randint(0, 2, 128)
    x1 = rng.randint(0, 700, 128)
    y1 = rng.randint(0, 500, 128)
    rois[:, 1], rois[:, 2] = x1, y1
    rois[:, 3] = np.minimum(x1 + rng.randint(16, 400, 128), 799)
    rois[:, 4] = np.minimum(y1 + rng.randint(16, 300, 128), 607)
    # [N, C, H, W] (or [N, C, D, H, W], [N, T, D]) of each op's input
    shapes = dict(
        roi=(2, 512, 38, 50), pool=(32, 64, 224, 224),
        lrn=(64, 96, 54, 54), convt=(32, 256, 14, 14),
        conv3d=(8, 64, 16, 56, 56), gn=(32, 256, 56, 56), row=(64, 5, 4),
        shift=(64, 6), spp=(64, 2, 8, 8), crop=(64, 5, 6),
        norm=(64, 8, 16, 16))
    if small:
        shapes.update(roi=(2, 3, 38, 50), pool=(2, 3, 8, 8),
                      lrn=(2, 7, 5, 5), convt=(2, 6, 5, 5),
                      conv3d=(1, 3, 4, 5, 5), gn=(2, 64, 3, 3),
                      row=(4, 5, 4), shift=(4, 6), spp=(4, 2, 8, 8),
                      crop=(64, 5, 6), norm=(4, 8, 3, 3))

    def img(*shape):
        return rng.randn(*shape).astype(f)
    x = {k: img(*v) for k, v in shapes.items()}
    n, cin, h, w = shapes['convt']
    convt_w = (0.05 * rng.randn(cin, cin // 2, 4, 4)).astype(f)
    nd, c3 = shapes['conv3d'][:2]
    conv3d_w = (0.05 * rng.randn(c3, c3, 3, 3, 3)).astype(f)
    gn_c = shapes['gn'][1]
    nb = shapes['shift'][0]

    def x_as(L, v, key):
        return L.reshape(v('x'), list(shapes[key]))

    def op(op_type, inputs, slots, attrs, dtypes=None):
        return _op_helper(pt, op_type, inputs, out_dtype=dtypes,
                          slots=slots, attrs=attrs)

    def pool_unpool(L, x4):
        out, mask = L.max_pool2d_with_index(x4, [2, 2], strides=[2, 2])
        return [out, mask, L.unpool(out, mask, [2, 2], strides=[2, 2])]
    one = [1, 1]
    return [
        ('roi_pool %s, 128 ROIs, 7x7, 1/16' % list(shapes['roi']),
         x['roi'], {'rois': (rois, False)},
         ('roi_pool', lambda L, v: op(
             'roi_pool', {'X': x_as(L, v, 'roi'), 'ROIs': v('rois')},
             ('Out', 'Argmax'), dict(pooled_height=7, pooled_width=7,
                                     spatial_scale=1.0 / 16),
             {'Argmax': 'int64'}), True, 0, None)),
        ('max_pool2d_with_index + unpool %s 2x2/2' % list(shapes['pool']),
         x['pool'], {},
         ('max_pool2d_with_index', lambda L, v: pool_unpool(
             L, x_as(L, v, 'pool')), True, 0, None)),
        ('lrn %s' % list(shapes['lrn']), x['lrn'], {},
         ('lrn', lambda L, v: op('lrn', {'X': x_as(L, v, 'lrn')},
                                 ('Out', 'MidOut'),
                                 dict(n=5, k=2.0, alpha=1e-4, beta=0.75)),
          False, 0, None)),
        ('conv2d_transpose %s -> %dx%d, k4 s2' % (list(shapes['convt']),
                                                  2 * h, 2 * w),
         x['convt'], {'filter': (convt_w, True)},
         ('conv2d_transpose', lambda L, v: op(
             'conv2d_transpose', {'Input': x_as(L, v, 'convt'),
                                  'Filter': v('filter')}, ('Output',),
             dict(strides=[2, 2], paddings=one, dilations=one)), False, 1,
          _conv_sums(torch, device, lambda a, k: F.conv_transpose2d(
              a.reshape(shapes['convt']), k, stride=2, padding=1),
              ('x', 'filter'), (cin * 4, cin // 2 * 16, n * h * w)))),
        ('conv3d %s k3' % list(shapes['conv3d']), x['conv3d'],
         {'filter': (conv3d_w, True)},
         ('conv3d', lambda L, v: op(
             'conv3d', {'Input': x_as(L, v, 'conv3d'),
                        'Filter': v('filter')}, ('Output',),
             dict(strides=[1, 1, 1], paddings=[1, 1, 1],
                  dilations=[1, 1, 1])), False, 1,
          _conv_sums(torch, device, lambda a, k: F.conv3d(
              a.reshape(shapes['conv3d']), k, padding=1), ('x', 'filter'),
              (c3 * 27, c3 * 27,
               nd * int(np.prod(shapes['conv3d'][2:])))))),
        ('group_norm %s, 32 groups' % list(shapes['gn']), x['gn'],
         {'scale': (img(gn_c), True), 'bias': (img(gn_c), True),
          'weight': (img(*shapes['gn']), False)},
         ('group_norm', lambda L, v: L.elementwise_mul(op(
             'group_norm', {'X': x_as(L, v, 'gn'), 'Scale': v('scale'),
                            'Bias': v('bias')}, ('Y',),
             dict(groups=32, epsilon=1e-5))[0], v('weight')), False, 0,
          None)),
        ('row_conv %s, 3 taps' % list(shapes['row']), x['row'],
         {'filter': (img(3, 4), True)},
         ('row_conv', lambda L, v: op(
             'row_conv', {'X': x_as(L, v, 'row'), 'Filter': v('filter')},
             ('Out',), {}), False, 0, None)),
        ('conv_shift [%d, 6] * [%d, 3]' % (nb, nb), x['shift'],
         {'shift': (img(nb, 3), True)},
         ('conv_shift', lambda L, v: op(
             'conv_shift', {'X': v('x'), 'Y': v('shift')}, ('Out',), {}),
          False, 0, None)),
        ('spp %s, height 2' % list(shapes['spp']), x['spp'], {},
         ('spp', lambda L, v: L.spp(x_as(L, v, 'spp'), 2), True, 0, None)),
        ('crop [64, 5, 6] -> [32, 3, 4] at Offsets (clamped)', x['crop'],
         {'off': (np.array([40, 2, 5], 'int32'), False)},
         ('crop', lambda L, v: op(
             'crop', {'X': x_as(L, v, 'crop'), 'Offsets': v('off')},
             ('Out',), dict(shape=[32, 3, 4])), True, 0, None)),
        ('norm %s axis 1' % list(shapes['norm']), x['norm'], {},
         ('norm', lambda L, v: op('norm', {'X': x_as(L, v, 'norm')},
                                  ('Out', 'Norm'),
                                  dict(axis=1, epsilon=1e-10)), False, 0,
          None)),
    ]


def phase_conv_ops(torch, pt, place, card, on_card, small=False):
    """21d: the 12 op types on the card against the port on the host at
    working sizes (``small``: the rehearsal's), fp32 with TF32 off, each in its own program, captured
    on the card (_ops_card_vs_host: every output and the gradient of
    every float input at the harness's tolerances, parity_difference; the
    exact ops, max_pool2d_with_index's round trip through unpool among
    them, bit for bit). Returns {op: card ms of its captured program,
    forward and backward}."""
    rng = np.random.RandomState(21)
    device = torch.device('cuda', 0) if on_card else torch.device('cpu')
    cases = conv_op_cases(torch, pt, device, rng, small)
    worst, faults, times = {}, [], {}
    for label, x, extra, case in cases:
        t0 = time.perf_counter()
        feed = {'x': x.reshape(-1, x.shape[-1])}
        feed.update({k: v for k, (v, _) in extra.items()})
        before = len(faults)
        compared, _ = _ops_card_vs_host(
            torch, pt, place, on_card, feed['x'].shape[0], x.shape[-1], None,
            feed, worst, faults, label, cases_of=lambda pt, c=case: [c],
            extra=[(k, v.shape, str(v.dtype), probed)
                   for k, (v, probed) in extra.items()],
            phase='21d', times=times)
        ms = times.get(label)
        print('phase 21d %s: %d outputs and gradients card against host, '
              '%s; largest difference %.3g (relative where |host| >= 1); '
              'card %s ms a replay of its captured program; %.1f s [%s]'
              % (label, compared, 'bit for bit' if case[2] else
                 'within the harness tolerances', worst[case[0]],
                 '%.3f' % ms if ms is not None else 'n/a',
                 time.perf_counter() - t0, card))
        require(len(faults) == before, 'phase 21d: %s' % '; '.join(
            faults[before:]))
        if on_card:
            torch.cuda.empty_cache()
    return {c[3][0]: times.get(c[0]) for c in cases}


def conv_bn_shapes(torch):
    """21e: K5 at the slice's new shapes: (label, shape, dtype, layout)."""
    return [
        ('batch_norm [64, 32, 112, 112] bf16 NCHW (MobileNet stem)',
         (64, 32, 112, 112), torch.bfloat16, 'NCHW'),
        ('batch_norm [64, 1024, 7, 7] bf16 NCHW (MobileNet last stage)',
         (64, 1024, 7, 7), torch.bfloat16, 'NCHW'),
        ('batch_norm [32, 1024, 14, 14] bf16 NCHW (SE-ResNeXt stage 3)',
         (32, 1024, 14, 14), torch.bfloat16, 'NCHW'),
        ('batch_norm [32, 2048, 7, 7] bf16 NCHW (SE-ResNeXt stage 4)',
         (32, 2048, 7, 7), torch.bfloat16, 'NCHW'),
        ('batch_norm [128, 512] bf16 (vgg_bn_drop fc)', (128, 512),
         torch.bfloat16, 'NC'),
        ('batch_norm [128, 512] fp32 (vgg_bn_drop fc)', (128, 512),
         torch.float32, 'NC'),
    ]


def phase_conv_bn(torch, card):
    """21e: K5 and its backward kernel at each new shape (_bn_case: twice
    for equal bits, against the plain versions, times beside F.batch_norm
    and the bound)."""
    gen = torch.Generator(device='cuda').manual_seed(21)
    dev = torch.device('cuda', 0)
    rows = {}
    for label, shape, dtype, layout in conv_bn_shapes(torch):
        x = (1.0 + 2.0 * torch.randn(shape, generator=gen, device=dev)) \
            .to(dtype)
        fwd, bwd = _bn_case(torch, card, label, x, layout, gen)
        fwd.pop('on_chip')
        rows[label] = dict(forward=fwd, backward=bwd)
        del x
        torch.cuda.empty_cache()
    return rows


def phase_conv(torch, pt, place, card, on_card, small=False,
               host_place=None):
    """Phase 21: (a) MobileNet v1 (NHWC and NCHW, batch 64) and
    SE-ResNeXt-50 (batch 32, NCHW) at 224 x 224 under bf16 AMP,
    Momentum(0.1, 0.9): 3 eager steps, then 10 captured, exactly 27 + 27
    and 53 + 53 K5 launches a step, and their small builds captured
    against eager; (b) VGG-16, AlexNet, GoogLeNet (224, batch 64, bf16),
    LeNet-5 (28, batch 64, fp32) and vgg_bn_drop (32, batch 128, fp32 and
    bf16, 14 + 14 K5 launches a step) 3 steps captured each,
    Momentum(0.01, 0.9); (c) the small builds card against host; (d) the
    12 op types card against host; (e) K5 at the new shapes. Returns (the
    timed runs' launch counts, summary)."""
    t0 = time.perf_counter()
    host_place = host_place or pt.CPUPlace()
    runs, out = [], {}
    for case in CONV_WIDE + CONV_OTHERS:
        wide = case in CONV_WIDE
        if small:
            label, builder, _, chans, _, amp, kw, n_bn = case
            image = {'lenet': 28, 'alexnet': 67,
                     'vgg_bn_drop': 32}.get(builder, 64)
            kw = dict(kw, scale=0.25) if builder == 'mobile_net' else \
                (dict(kw, cardinality=8) if builder == 'se_resnext' else kw)
            case = (label, builder, image, chans, 4, amp, kw, n_bn)
            args = dict(warmup=2, steps=2, eager_steps=1 if wide else 0,
                        class_dim=10)
        else:
            args = dict(warmup=3, steps=10, eager_steps=3, busy=True) \
                if wide else dict(warmup=2, steps=3, busy=True)
        launches, out[case[0]] = _conv_timed(
            torch, pt, place, card, on_card, case,
            0.1 if wide and not small else 0.01, **args)
        runs.append(launches)
        if on_card:
            torch.cuda.empty_cache()
    out['captured_vs_eager'] = {
        c[0]: conv_captured_vs_eager(torch, pt, place, card, c)
        for c in CONV_SMALL[:3]} if on_card else {}
    gaps = {}
    for case in CONV_SMALL:
        for amp in (None, 'bf16'):
            (card_l, card_g), (host_l, host_g) = conv_places(
                torch, pt, (place, host_place), case, amp)
            rel = [abs(a - b) / abs(b) for a, b in zip(card_l, host_l)]
            each, whole = conv_grad_gaps(card_g, host_g)
            tol = 1e-5 if amp is None else 1e-2
            if amp is None:
                grad_tol, host_fp32, rounding = case[5], host_g, ''
            else:
                own = conv_grad_gaps(host_g, host_fp32)[1]
                grad_tol = 2 * own
                rounding = ' (the host\'s bf16 against its fp32: %.3g)' % own
            gaps['%s %s' % (case[0], amp or 'fp32')] = dict(
                losses=rel, grad_each=each, grad_whole=whole,
                grad_limit=grad_tol)
            print('phase 21c %s %s: 2 Momentum steps card %s, host %s; '
                  'relative gaps %s (first step limit %g); the first '
                  'step\'s gradients: a parameter\'s relative gap up to %.3g, '
                  'all together %.3g (limit %.3g%s) [%s]'
                  % (case[0], amp or 'fp32', ['%.6f' % v for v in card_l],
                     ['%.6f' % v for v in host_l],
                     ['%.3g' % v for v in rel], tol, each, whole, grad_tol,
                     rounding, card))
            require(np.isfinite(card_l + host_l).all(),
                    'phase 21c %s: loss not finite' % case[0])
            require(rel[0] <= tol and whole <= grad_tol,
                    'phase 21c %s %s: the card differs from the host'
                    % (case[0], amp or 'fp32'))
            if on_card:
                torch.cuda.empty_cache()
    out['card_vs_host'] = gaps
    out['ops_ms'] = phase_conv_ops(torch, pt, place, card, on_card,
                                   small=small)
    if on_card:
        out['batch_norm'] = phase_conv_bn(torch, card)
    out['seconds'] = time.perf_counter() - t0
    print('phase 21 %.1f s' % out['seconds'])
    return runs, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--cpu-rehearsal', action='store_true',
                    help='run phases 4-21 on the host at tiny sizes with '
                         'the plain versions')
    ap.add_argument('--profile', action='store_true',
                    help='after every other phase, profile 20 decode '
                         'steps with every slot busy (fp32 and int8 '
                         'arenas), 20 verify steps (k = 3), 5 Transformer '
                         'and 5 ResNet-50 training steps (torch.profiler) '
                         'and, after phase 18, 5 MoE LM steps (scan and '
                         'unrolled), and print where the time goes')
    ap.add_argument('--kernels-only', action='store_true',
                    help='stop after phase 3 (kernels against their plain '
                         'versions, and their times); prints no verdict')
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke needs a CUDA '
             'card (use --cpu-rehearsal on the host)')
    sys.path.insert(0, REPO)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving.decode import LMSpec

    if args.cpu_rehearsal:
        spec = LMSpec(vocab_size=60, n_layer=2, n_head=2, d_key=8,
                      d_value=8, d_model=16, d_inner=32)
        reqs = _requests(spec, 32, 1, 9, 6)
        host = 'host CPU, rehearsal'
        results, _, _, stats4 = phase_engine(
            torch, spec, dict(max_batch=4, block_size=4, num_blocks=64,
                              pages_per_seq=4),
            reqs, pt.CPUPlace(), host, False)
        phase_cpu_compare(spec, reqs, results, 4, 4)
        geom = dict(max_batch=4, block_size=4, num_blocks=96,
                    pages_per_seq=16)
        shared = _shared_requests(spec, 32, 32, (4, 16), (8, 32), 6)
        phase_extras(torch, spec, geom, shared, pt.CPUPlace(), host, False)
        quant = {}
        for kv_dtype in ('int8', 'float8_e4m3fn'):
            quant[kv_dtype] = phase_quantized(
                torch, spec, geom, shared, pt.CPUPlace(), host, False,
                kv_dtype, 4)
        tiny = dict(n_layer=2, n_head=2, d_key=8, d_value=8, d_model=16,
                    d_inner=32)
        phase_train(torch, pt, pt.CPUPlace(), host, False, 4, 8, 64, tiny,
                    steps=20)
        phase_train(torch, pt, pt.CPUPlace(), host, False, 4, 8, 64,
                    dict(tiny, scan_layers=True), steps=20,
                    label='train scan_layers')
        phase_scan_compare(torch, pt, pt.CPUPlace(), host, 64, tiny)
        phase_train_masked(torch, pt, pt.CPUPlace(), host, False, 4, 16, 64,
                           tiny, steps=3)
        phase_dropout_mask(torch, pt, pt.CPUPlace(), host, False, batch=8,
                           d_model=16, d_inner=32)
        phase_train_compare(torch, pt, (pt.CPUPlace(), pt.CPUPlace()), 64,
                            tiny)
        phase_resnet(torch, pt, pt.CPUPlace(), host, False, 8, 16, 10,
                     small=True, steps=6)
        phase_resnet_compare(torch, pt, (pt.CPUPlace(), pt.CPUPlace()))
        phase_captured_train(torch, pt, pt.CPUPlace(), host, False, 4, 8,
                             64, tiny, steps=3)
        phase_captured_resnet(torch, pt, pt.CPUPlace(), host, False, 8, 16,
                              10, small=True, steps=3)
        small = dict(max_batch=4, block_size=4, num_blocks=64,
                     pages_per_seq=4)
        phase_captured_engine(torch, spec, small, reqs, host, False,
                              (results, stats4), 'engine')
        got, st = quant['int8'][3], quant['int8'][2]
        phase_captured_engine(torch, spec, geom, shared, host, False,
                              (got, st), 'int8 engine', kv_dtype='int8')
        phase_nmt(torch, pt, pt.CPUPlace(), host, False, 64, tiny, batch=4,
                  src_seq=20, beam=3, t_inc=10, t_unr=6, calls=2,
                  host_place=pt.CPUPlace(), host_t=5)
        work = tempfile.mkdtemp(prefix='chip_smoke_ckpt.', dir=REPO)
        try:
            phase_trainer(torch, pt, pt.CPUPlace(), host, False, 4, 8, 64,
                          tiny, steps=4)
            phase_lifecycle(torch, pt, pt.CPUPlace(), host, False, 4, 8, 64,
                            tiny, work, steps=4, every=2)
            phase_export(torch, pt, pt.CPUPlace(), host, False, 64, tiny,
                         work, batch=4, src_seq=20, t_out=10)
            phase_lifecycle_vs_host(torch, pt, (pt.CPUPlace(),
                                                pt.CPUPlace()), host)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        phase_disagg(torch, spec, dict(max_batch=4, block_size=4,
                                       num_blocks=512, pages_per_seq=32),
                     pt.CPUPlace(), host, False, sys_len=8,
                     long_prompt=(40, 48), short_prompt=(4, 12))
        phase_ctr(torch, pt, host, False, slots=4, rows=1000, batch=256,
                  steps=5)
        phase_layers_encoder(torch, pt, pt.CPUPlace(), host, False,
                             dims=dict(d_model=32, n_head=4, d_inner=64),
                             batch=4, seq=8, cmp_batch=2, steps=3)
        phase_layers_ops(torch, pt, pt.CPUPlace(), host, False, n=64, d=48)
        phase_staging_trainer(torch, pt, pt.CPUPlace(), host, False, 4, 8,
                              64, tiny, steps=4)
        phase_module_ops(torch, pt, pt.CPUPlace(), host, False, n=64, d=48)
        phase_staging_ctr(torch, pt, host, False, slots=4, rows=1000,
                          batch=256, steps=8)
        tiny_moe = dict(MOE_SMALL, n_layer=2, d_model=16, d_inner=32,
                        n_head=2, top_k=1)
        phase_moe(torch, pt, pt.CPUPlace(), host, False, batch=4, seq=8,
                  vocab=64, dims=tiny_moe)
        phase_remat(torch, pt, pt.CPUPlace(), host, False, batch=4, seq=8,
                    vocab=64, base=tiny, moe_batch=4, moe_dims=tiny_moe,
                    resnet=(4, 16, 10, True), steps=2)
        phase_accum(torch, pt, pt.CPUPlace(), host, False, seq=8, vocab=64,
                    base=tiny, micro=2)
        phase_rnn(torch, pt, pt.CPUPlace(), host, False, batch=4, seq=8,
                  vocab=64, hidden=8, steps=4, model_batch=4, model_seq=8,
                  small=True, wide_hidden=16, cells_hidden=24)
        phase_control_flow(torch, pt, pt.CPUPlace(), host, False, small=True)
        phase_conv(torch, pt, pt.CPUPlace(), host, False, small=True)
        print('cpu rehearsal ok in %.1f s' % (time.perf_counter() - t_start))
        return

    def done(phase):
        print('phase %s done at %.1f s' % (phase, time.perf_counter() -
                                           t_start))

    name, count, card = phase_device(torch)
    phase_build()
    done('2 (build)')
    ln, ln_bwd, pa, q8 = phase_kernels(torch, card)
    done('3 (K1, K4)')
    fa_fwd, fa_bwd = phase_flash_kernels(torch, card)
    bn, bn_bwd = phase_bn_kernels(torch, card)
    kvw, pa_write, mask, drop_fwd, drop_bwd = phase_step_kernels(torch,
                                                                  card)
    sparse = phase_sparse_kernels(torch, card)
    pool_fwd, pool_bwd = phase_pool_kernels(torch, card)
    done('3 (K2, K3, K5, KV write, keep mask, dropout, sparse rows, max '
         'pool forward and backward)')
    if args.kernels_only:
        print('kernels only: K1, K4 (and its quantized variant), K2, K3 and '
              'K5 and the K1 and K5 backward kernels agree with their plain '
              'versions; no verdict. total %.1f s'
              % (time.perf_counter() - t_start))
        return
    spec = LMSpec(vocab_size=32000, n_layer=12, n_head=8, d_key=64,
                  d_value=64, d_model=512, d_inner=2048)
    geom = dict(max_batch=16, block_size=32, num_blocks=4096,
                pages_per_seq=64)
    reqs = _requests(spec, 32, 64, 512, 64)
    results, launches, eng, stats4 = phase_engine(torch, spec, geom, reqs,
                                                  pt.CUDAPlace(0), card, True)
    phase_cpu_compare(spec, reqs, results, 32, 16)
    done('4-5 (engine, card vs host)')
    # each engine (fp32: 6.4 GB of arenas) stays only for --profile
    jobs = [_decode_job(eng, spec)] if args.profile else []
    del eng
    torch.cuda.empty_cache()
    shared = _shared_requests(spec, 32, 256, (16, 256), (64, 512), 64)
    extras, eng, _ = phase_extras(torch, spec, geom, shared,
                                  pt.CUDAPlace(0), card, True)
    if args.profile:
        jobs.append(_decode_job(eng, spec, k=3))
    del eng
    torch.cuda.empty_cache()
    done('5a (extras)')
    quant, quant_runs = {}, {}
    for kv_dtype in ('int8', 'float8_e4m3fn'):
        quant[kv_dtype], eng, stats, got = phase_quantized(
            torch, spec, geom, shared, pt.CUDAPlace(0), card, True, kv_dtype,
            16)
        quant_runs[kv_dtype] = (got, stats)
        if args.profile and kv_dtype == 'int8':
            jobs.append(_decode_job(eng, spec))
        del eng
        torch.cuda.empty_cache()
    done('5b (int8, fp8)')
    base = dict(n_layer=6, n_head=8, d_key=64, d_value=64, d_model=512,
                d_inner=2048)
    # a --profile job keeps its executor (and graph) alive to the end
    train, train_job, unrolled = phase_train(torch, pt, pt.CUDAPlace(0), card,
                                             True, 64, 64, VOCAB, base)
    train_job = train_job if args.profile else None
    torch.cuda.empty_cache()
    # phase 6b: the same training with scan_layers, then its compare
    scan_train, scan_job, scanned = phase_train(
        torch, pt, pt.CUDAPlace(0), card, True, 64, 64, VOCAB,
        dict(base, scan_layers=True), label='train scan_layers')
    scan_job = scan_job if args.profile else None
    print('phase 6b: scan_layers %.3f ms/step, %.1f tokens/s, MFU %.4f; '
          'unrolled (phase 6) %.3f ms/step, %.1f tokens/s, MFU %.4f [%s]'
          % (scanned + unrolled + (card,)))
    torch.cuda.empty_cache()
    phase_scan_compare(torch, pt, pt.CUDAPlace(0), card, VOCAB, base)
    torch.cuda.empty_cache()
    done('6, 6b (training, scan_layers)')
    masked = phase_train_masked(torch, pt, pt.CUDAPlace(0), card, True, 8,
                                512, VOCAB, base)
    torch.cuda.empty_cache()
    mask_read = phase_dropout_mask(torch, pt, pt.CUDAPlace(0), card, True)
    torch.cuda.empty_cache()
    phase_train_compare(torch, pt, (pt.CUDAPlace(0), pt.CPUPlace()), VOCAB,
                        base)
    torch.cuda.empty_cache()
    resnet, resnet_job = phase_resnet(torch, pt, pt.CUDAPlace(0), card, True,
                                      64, 224, 1000)
    resnet_job = resnet_job if args.profile else None
    torch.cuda.empty_cache()
    phase_resnet_compare(torch, pt, (pt.CUDAPlace(0), pt.CPUPlace()))
    torch.cuda.empty_cache()
    done('6-10 (training)')
    # phase 11: captured against eager (use_program_cache=False) on each
    # path, in this call
    train_jobs = phase_captured_train(torch, pt, pt.CUDAPlace(0), card, True,
                                      64, 64, VOCAB, base)
    train_jobs = train_jobs if args.profile else []
    torch.cuda.empty_cache()
    resnet_jobs = phase_captured_resnet(torch, pt, pt.CUDAPlace(0), card,
                                        True, 64, 224, 1000)
    resnet_jobs = resnet_jobs if args.profile else []
    torch.cuda.empty_cache()
    eng = phase_captured_engine(torch, spec, geom, reqs, card, True,
                                (results, stats4), 'engine')
    if args.profile:
        jobs.append(_decode_job(eng, spec, mode='eager'))
    del eng
    torch.cuda.empty_cache()
    eng = phase_captured_engine(torch, spec, geom, shared, card, True,
                                quant_runs['int8'], 'int8 engine',
                                kv_dtype='int8')
    if args.profile:
        jobs.append(_decode_job(eng, spec, mode='eager'))
    del eng
    torch.cuda.empty_cache()
    done('11 (captured against eager)')
    if args.profile:
        # the other paths' profiles first: then their engines and graphs
        # go, and phase 12 (profiled after it, with CUPTI attached since
        # this first profile) has the card's memory
        profile_steps(torch, card, jobs + [train_job, scan_job, resnet_job] +
                      train_jobs + resnet_jobs)
        del jobs, train_job, scan_job, resnet_job, train_jobs, resnet_jobs
        torch.cuda.empty_cache()
    nmt, nmt_jobs = phase_nmt(torch, pt, pt.CUDAPlace(0), card, True, VOCAB,
                              base, host_place=pt.CPUPlace(),
                              profile=args.profile)
    done('12 (NMT inference)')
    if args.profile:
        profile_steps(torch, card, nmt_jobs)
    del nmt_jobs
    torch.cuda.empty_cache()
    # phase 13: the training lifecycle (checkpoints under the checkout,
    # removed at the end)
    work = tempfile.mkdtemp(prefix='chip_smoke_ckpt.', dir=REPO)
    try:
        trainer, tok_s, per_step = phase_trainer(
            torch, pt, pt.CUDAPlace(0), card, True, 64, 64, VOCAB, base)
        torch.cuda.empty_cache()
        lifecycle = phase_lifecycle(torch, pt, pt.CUDAPlace(0), card, True,
                                    64, 64, VOCAB, base, work)
        torch.cuda.empty_cache()
        lifecycle.update(phase_export(torch, pt, pt.CUDAPlace(0), card,
                                      True, VOCAB, base, work))
        torch.cuda.empty_cache()
        phase_lifecycle_vs_host(torch, pt, (pt.CUDAPlace(0),
                                            pt.CPUPlace()), card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lifecycle.update(tokens_per_s={str(d): v for d, v in tok_s.items()},
                     launches_per_step=per_step)
    done('13 (training lifecycle)')
    # phase 14: disaggregated serving at the decode configuration
    disagg_runs, disagg = phase_disagg(torch, spec, geom, pt.CUDAPlace(0),
                                       card, True, repeats=3)
    torch.cuda.empty_cache()
    done('14 (disaggregated serving)')
    # phase 15: Wide&Deep CTR training with row-sparse gradients
    ctr_runs, ctr, ctr_jobs = phase_ctr(torch, pt, card, True,
                                        profile=args.profile)
    done('15 (Wide&Deep CTR)')
    if args.profile:
        families = profile_steps(torch, card, ctr_jobs)
        sorts = [f.get('top-k and sort', (0, 0.0))[0]
                 for f in families[:len(CTR_OPTS)]]
        print('profile: Wide&Deep row-sparse steps (%s): %s sort kernels'
              % (', '.join(n for n, _, _ in CTR_OPTS),
                 ', '.join(str(c) for c in sorts)))
        require(not any(sorts), 'a row-sparse CTR step still sorts outside '
                'the sparse_rows kernel')
    del ctr_jobs
    torch.cuda.empty_cache()
    # phase 16: the public layers
    layers_runs, layers = phase_layers_encoder(torch, pt, pt.CUDAPlace(0),
                                               card, True)
    torch.cuda.empty_cache()
    layers.update(ops=phase_layers_ops(torch, pt, pt.CUDAPlace(0), card,
                                       True))
    torch.cuda.empty_cache()
    done('16 (the public layers)')
    # phase 17: the staging ring and the rest of the op modules (17b, with
    # its profiled busy times, last)
    ring_runs, staging = phase_staging_trainer(
        torch, pt, pt.CUDAPlace(0), card, True, 64, 64, VOCAB, base)
    torch.cuda.empty_cache()
    staging.update(ops=phase_module_ops(torch, pt, pt.CUDAPlace(0), card,
                                        True))
    torch.cuda.empty_cache()
    staging['ctr'], ctr_ring_runs = phase_staging_ctr(torch, pt, card, True)
    torch.cuda.empty_cache()
    done('17 (the staging ring and the rest of the op modules)')
    # phase 18: the Switch-MoE LM, remat and gradient accumulation
    moe_runs, moe, moe_jobs = phase_moe(torch, pt, pt.CUDAPlace(0), card,
                                        True, host_place=pt.CPUPlace(),
                                        profile=args.profile)
    torch.cuda.empty_cache()
    moe['remat'] = phase_remat(torch, pt, pt.CUDAPlace(0), card, True)
    moe['accum'] = phase_accum(torch, pt, pt.CUDAPlace(0), card, True)
    torch.cuda.empty_cache()
    done('18 (the Switch-MoE LM, remat, gradient accumulation)')
    if args.profile:
        profile_steps(torch, card, moe_jobs)
    del moe_jobs
    torch.cuda.empty_cache()
    # phase 19: the recurrent and sequence path
    rnn_kernels = phase_rnn_kernels(torch, card)
    rnn_runs, rnn = phase_rnn(torch, pt, pt.CUDAPlace(0), card, True)
    rnn['recurrence'] = rnn_kernels.pop('recurrence')
    rnn['gru_recurrence'] = rnn_kernels.pop('gru_recurrence')
    rnn['gru_wide_recurrence'] = rnn_kernels.pop('gru_wide_recurrence')
    torch.cuda.empty_cache()
    done('19 (the recurrent and sequence path)')
    # phase 20: control flow, the RNN-search seq2seq and SSD
    cf_runs, control_flow = phase_control_flow(torch, pt, pt.CUDAPlace(0),
                                               card, True)
    torch.cuda.empty_cache()
    done('20 (control flow, rnn_search, SSD)')
    # phase 21: the conv path's rest
    conv_runs, conv = phase_conv(torch, pt, pt.CUDAPlace(0), card, True)
    torch.cuda.empty_cache()
    done('21 (MobileNet, SE-ResNeXt, the other CNNs, the conv path\'s ops)')

    # launches: the sum over the main paths' runs (the engine runs: plain,
    # extras plain and with cache + speculation, int8 and fp8; the timed
    # Transformer (unrolled and scan_layers), masked Transformer, phase
    # 7b's (the dropout Mask read) and ResNet-50 training steps; phase 12's
    # timed decode calls; phase 13a's timed Trainer epoch at depth 1; phase
    # 14's six legs; phase 15's four row-sparse legs; phase 16a's timed
    # encoder steps, fp32 and bf16; phase 17's staging-ring legs: the
    # Transformer's timed epoch and the CTR's steps; phase 18a's timed MoE
    # steps, scan_layers and unrolled; phase 19's timed bench_rnn_lstm
    # steps (at hidden 128 and 512), each sequence model's timed steps and
    # the wide GRU tagger's; phase 20's timed rnn_search steps (fp32 and
    # bf16), its hidden-128 card steps and the timed SSD steps; phase 21's
    # timed captured steps of the nine CNN runs), each read after its
    # counts were set to 0
    main_runs = [launches] + extras + list(quant.values()) + \
        [train, scan_train, masked, mask_read, resnet, nmt, trainer] + \
        disagg_runs + list(ctr_runs.values()) + layers_runs + \
        [ring_runs, ctr_ring_runs] + moe_runs + rnn_runs + cf_runs + \
        conv_runs

    def runs(key):
        return sum(r.get(key, 0) for r in main_runs)
    for key in ('max_pool_fwd', 'max_pool_bwd'):
        require(runs(key) > 0, '%s was never launched on the main paths'
                % key)

    kernels = [
        dict(name='layer_norm', route='cuda',
             source='paddle_tpu_torch/csrc/layer_norm.cu',
             replaces='paddle_tpu/ops/pallas/layer_norm.py:23',
             launches=runs('layer_norm'), **ln),
        dict(name='layer_norm_bwd', route='cuda',
             source='paddle_tpu_torch/csrc/layer_norm.cu',
             replaces='paddle_tpu/ops/pallas/layer_norm.py:91',
             launches=runs('layer_norm_bwd'), **ln_bwd),
        dict(name='paged_attention', route='cuda',
             source='paddle_tpu_torch/csrc/paged_attention.cu',
             replaces='paddle_tpu/ops/pallas/paged_attention.py:86',
             launches=runs('paged_attention') - runs('paged_attention_q8') -
             runs('paged_attention_write'), **pa),
        dict(name='paged_attention_write', route='cuda',
             source='paddle_tpu_torch/csrc/paged_attention.cu',
             replaces='paddle_tpu/ops/pallas/paged_attention.py:86',
             launches=runs('paged_attention_write'), **pa_write),
        dict(name='paged_attention_int8', route='cuda',
             source='paddle_tpu_torch/csrc/paged_attention.cu',
             replaces='paddle_tpu/ops/pallas/paged_attention.py:50',
             launches=quant['int8']['paged_attention_q8'],
             **q8[('int8', 'engine')]),
        dict(name='paged_attention_fp8', route='cuda',
             source='paddle_tpu_torch/csrc/paged_attention.cu',
             replaces='paddle_tpu/ops/pallas/paged_attention.py:50',
             launches=quant['float8_e4m3fn']['paged_attention_q8'],
             **q8[('float8_e4m3fn', 'engine')]),
        dict(name='flash_attention_fwd', route='cuda',
             source='paddle_tpu_torch/csrc/flash_attention.cu',
             replaces='paddle_tpu/ops/pallas/flash_attention.py:141',
             launches=runs('flash_attention_fwd'), **fa_fwd),
        dict(name='flash_attention_bwd', route='cuda',
             source='paddle_tpu_torch/csrc/flash_attention.cu',
             replaces='paddle_tpu/ops/pallas/flash_attention.py:278',
             launches=min(runs('flash_attention_bwd_dkv'),
                          runs('flash_attention_bwd_dq')), **fa_bwd),
        dict(name='batch_norm', route='cuda',
             source='paddle_tpu_torch/csrc/batch_norm.cu',
             replaces='paddle_tpu/ops/pallas/batch_norm.py:52',
             launches=runs('batch_norm'), **bn),
        dict(name='batch_norm_bwd', route='cuda',
             source='paddle_tpu_torch/csrc/batch_norm.cu',
             replaces='paddle_tpu/ops/pallas/batch_norm.py:159',
             launches=runs('batch_norm_bwd'), **bn_bwd),
        dict(name='kv_write', route='cuda',
             source='paddle_tpu_torch/csrc/kv_write.cu',
             replaces='paddle_tpu/ops/paged_decode_ops.py:90',
             launches=runs('kv_write'), **kvw),
        dict(name='keep_mask', route='cuda',
             source='paddle_tpu_torch/csrc/random_bits.cu',
             replaces='paddle_tpu/ops/nn_ops.py:163',
             launches=runs('keep_mask'), **mask),
        dict(name='dropout', route='cuda',
             source='paddle_tpu_torch/csrc/random_bits.cu',
             replaces='paddle_tpu/ops/nn_ops.py:163',
             launches=runs('dropout'), **drop_fwd),
        dict(name='dropout_bwd', route='cuda',
             source='paddle_tpu_torch/csrc/random_bits.cu',
             replaces='paddle_tpu/ops/nn_ops.py:163',
             launches=runs('dropout_bwd'), **drop_bwd),
        dict(name='sparse_rows', route='cuda',
             source='paddle_tpu_torch/csrc/sparse_rows.cu',
             replaces='paddle_tpu/ops/optimizer_ops.py:58',
             launches=runs('sparse_rows'), **sparse[('group', 'sgd')]),
        dict(name='max_pool_fwd', route='cuda',
             source='paddle_tpu_torch/csrc/max_pool.cu',
             replaces='paddle_tpu/ops/conv_ops.py:186',
             launches=runs('max_pool_fwd'), **pool_fwd),
        dict(name='max_pool_bwd', route='cuda',
             source='paddle_tpu_torch/csrc/max_pool.cu',
             replaces='paddle_tpu/ops/conv_ops.py:186',
             launches=runs('max_pool_bwd'), **pool_bwd),
    ] + [dict(name=name, route='cuda',
              source='paddle_tpu_torch/csrc/rnn_cell.cu',
              replaces='paddle_tpu/ops/rnn_ops.py:%d' % line,
              launches=runs(name), **rnn_kernels[name])
         for name, line in (('lstm_cell_fwd', 30), ('lstm_cell_bwd', 30),
                            ('gru_cell_fwd', 407), ('gru_cell_bwd', 407))] + \
        [dict(name='%s_seq_%s' % (kind, way), route='cuda',
              source='paddle_tpu_torch/csrc/%s_seq.cu' % kind,
              replaces='paddle_tpu/ops/rnn_ops.py:%d' % line,
              launches=runs('%s_seq_%s' % (kind, way)),
              **rnn_kernels['%s_seq_%s' % (kind, way)])
         for kind, line in (('lstm', 30), ('gru', 78))
         for way in ('fwd', 'bwd')] + \
        [dict(name='gru_wide_%s' % way, route='cuda',
              source='paddle_tpu_torch/csrc/gru_wide.cu',
              replaces='paddle_tpu/ops/rnn_ops.py:78',
              launches=runs('gru_wide_%s' % way),
              **rnn_kernels['gru_wide_%s' % way])
         for way in ('fwd', 'bwd')]
    ctr.update(kernel={'%s %s' % k: dict(ms=v['ms'], bound_ms=v['bound_ms'],
                                         library_ms=v['library_ms'])
                       for k, v in sparse.items()})
    print('total %.1f s' % (time.perf_counter() - t_start))
    print(json.dumps({'kernels': kernels, 'lifecycle': lifecycle,
                      'disagg': disagg, 'ctr': ctr, 'layers': layers,
                      'staging': staging, 'moe': moe, 'rnn': rnn,
                      'control_flow': control_flow, 'conv': conv}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': name,
                                             'count': count}}))


if __name__ == '__main__':
    main()
