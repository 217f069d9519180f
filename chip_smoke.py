#!/usr/bin/env python3
"""Smoke run of the PyTorch port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's training and serving paths the way a user would and
holds every hand-written kernel on them to its plain PyTorch version.
Phases, one JSON line each:

  env      torch and CUDA versions, the card's name and power limit;
  build    compiles every csrc/ source with nvcc (in parallel), with
           each kernel's ptxas registers, stack and spills;
  kernels  paged-attention decode at the serving geometry (8 slots,
           context 512 = 32 blocks of 16, d_model 512, 8 heads) for
           fp32/bf16/int8 pools and windows W in {1, 4}: the kernel
           against its plain version and against itself (bit-equal over
           two calls), with the kernel's time between CUDA events and
           its device time in torch.profiler, the host time of a call
           (direct, and through the decoder's wrapper), its split-KV
           grid (split length, CTAs), and the plain version's and a
           library composition's (gather + scaled_dot_product_attention)
           times beside the bound;
  flash    the flash-attention forward, dQ and dK/dV kernels at the
           LM's training shape [8, 512, 16, 128] (causal fp32, causal
           bf16, non-causal fp32, non-causal bf16) and at the seq2seq
           model's [32, 128, 8, 64] (causal and non-causal bf16), each
           against its plain version, with the
           kernel's, the plain version's and scaled_dot_product_attention's
           (forward against the forward kernel; backward against dQ +
           dK/dV; in every case) times
           beside the bound (float32 over TF32/3, the rate of float32-
           accurate 3xTF32 products, with the scalar-fp32 bound beside
           it; bf16 over the bf16 tensor peak);
  grads    the explicit gradient lowerings against the generic gradient
           (autograd over the forward lowering) at the train shapes: the
           `flash_attention` grad op (bf16 and fp32, from the forward's
           Out and lse: no forward launch, bit-equal to the generic
           route), and the `mul` grad op (a projection, fp32 and amp, and
           the LM head under amp) against autograd's matmul backward,
           with each route's time;
  train    the transformer LM of benchmark/run_ridge.py at its full
           width (vocab 30000, d_model 2048, 16 heads, 12 layers, seq
           512, batch 8; Momentum) under bf16 amp, as run_ridge runs it
           (`fluid.amp.enable_bf16()` before the Program is built; f32
           master weights), built as a Fluid Program and
           trained from one seeded startup in the Executor's default
           mode, as the JAX package's cells run: the block compiled,
           run eagerly at its miss, captured into a CUDA graph at its
           first hit and replayed after (G_STEPS = 3 timed steps and
           one profiled replay: one miss, then hits, no recompile; the
           kernels counted at the eager run and the capture, and by the
           profiler in the replay); then 3 from the same state in the
           interpreter (compiled=False), whose losses and parameters
           must equal the replay's bit for bit, and 3 on the plain path
           (interpreted; the op's lowering and its gradient swapped for
           the plain composition inside this script): per-step losses
           and every weight matrix's change compared; every parameter
           and parameter gradient float32; step time in both modes,
           capture seconds, the replay's device time and idle share,
           peak allocated and reserved memory, the interpreter's host
           synchronisations;
  ops      every op type of the op corpus (tests/torch_op_cases.py: 89
           dense types, 19 LoD sequence and recurrent types, the 4
           IfElse split and merge types, the 3 CRF types and the 8
           device types of CTC, the sampled losses and detection, their
           attribute, boundary and tie cases) on the card against the
           CPU from the same seeded inputs: the forward and the generic
           gradient in float32 (TF32 off) within 1e-5 of max(1,
           max|CPU|), ints, bools and LoDs exactly; matmul and cast
           again in bf16 under amp within one bf16 ulp; the drawn
           uniform_random_batch_size_like by distribution;
  ops_working  hsigmoid and nce at 30000 classes, width 512, 12800 rows
           (nce: 10 negatives), roi_pool at Fast R-CNN's shape and
           warpctc at the ocr_ctc phase's, card against CPU within 1e-5
           of max(1, max|CPU|), each gradient bit for bit over two card
           calls, each one's time and warpctc's kernels a call beside
           F.ctc_loss; the detection host ops' ms at SSD300's width;
  optimizers  each of the 12 optimizer update ops at one CTR table's
           shape [38462, 10], float32 and bf16 storage, with a dense and
           a Zipf-duplicated SelectedRows gradient (2048 rows): the card
           against the CPU within 1e-6 of max(1, max |CPU value|), two
           card calls bit for bit, and each call's time;
  train_fp32  the same LM and steps in float32 (amp off);
  lm_dropout  the train phase's LM under amp with dropout_rate 0.1, the
           attention weights' included (the composed transpose, matmul,
           softmax, dropout, matmul path): T_STEPS steps in the default
           mode (segmented: each dropout eager between captured device
           segments) and interpreted from the same state, bit for bit;
           the loss finite and falling; the attention keep rate within 4
           sigma of 0.9; with every dropout_prob 0, one step of the
           composed path against one of the flash path (one bf16 ulp of
           loss, each weight's change within 15 %); step times, segments,
           device time, idle share, peak memory, and the composed
           attention's time beside the flash kernels' at [8, 512, 16,
           128];
  seq2seq  the transformer translator of benchmark/run_seq2seq.py at its
           defaults (vocab 30000 on both sides, d_model 512, 8 heads,
           6 + 6 layers, batch 32, source and target length 128; Adam;
           bf16 amp as run_seq2seq runs it), trained as the train phase
           is: the default mode (one CUDA graph; 18 forward, dQ and
           dK/dV launches a replayed step, 12 of them non-causal), the
           interpreter bit for bit, the plain path within one bf16 ulp
           of loss; tokens/s as run_seq2seq counts them and the model
           FLOPs (mul and flash_attention shapes, forward x 3) against
           the bf16 peak;
  serve    the full-width LM of benchmark/run_generation.py (vocab
           32000, d_model 512, 8 heads, 6 layers, d_inner 2048) with
           seeded random weights, written as a model dir and served
           through server_from_model_dir (8 slots, 256 KV blocks):
           12 staggered requests per kv_dtype on the plain path and on
           the kernel path, batched-vs-solo bit identity, pool drain;
  spec     the same model as its own draft (spec_k 3, the W=4 kernel):
           accept rate 1.0 and the plain greedy tokens;
  dp       the train phase's LM with plain SGD under amp, trained
           data-parallel
           through ShardingTranspiler(mesh={"dp": 1}, overlap=
           "bucketed") and ParallelExecutor over a single-rank NCCL
           group: bucketed gradient all-reduces and the fused bucket
           update kernel in place over each bucket's flat parameter
           buffer, then the per-op sgd chain from the same state;
  fused_update  the fused bucket SGD kernel against its plain version
           (bit for bit), in place and into a new buffer, on the dp
           path's largest bucket and odd sizes, beside torch.add and
           p.add_;
  moe_kernel  the MoE gate + dispatch kernels against their plain
           versions at the MoE LM's shape (T 4096, D 1024, E 8): top-2,
           top-1 and an overflowing capacity; the routing form (routing,
           expert_in, slot weights, aux), the dense contract (combine)
           and the backward kernel, each bit-equal over two calls, the
           autograd Functions' gradients, and each one's time (events and
           device) beside its bound and its plain version;
  moe      the MoE transformer LM of benchmark/run_moe.py at its
           defaults (vocab 30000, d_model 1024, 8 heads, 6 layers, 8
           experts, top-2, capacity factor 1.25, seq 512, batch 8;
           Momentum; bf16 amp as run_moe runs it, which leaves the MoE
           FFN float32) trained as the train phase is: the kernel path
           in the default mode (routing form, gather combine; no
           [T, E, C] tensor and no GEMM with an E * C operand; the
           replay held bit for bit to the interpreter), then the plain
           path (the dense einsums, interpreted) from the same state,
           the for_test clone's forward on both, and a profiled step of
           each with its GEMMs split by shape;
  resnet50  benchmark/run_image.py's ResNet-50 at its defaults (224x224,
           1000 classes, batch 128, bf16 throughout: no amp; Momentum),
           seeded images and labels as run_image makes them: steps in
           the Executor's default mode (one CUDA graph: one miss, then
           hits replaying it) and a profiled replay (device time by
           group: cuDNN forward, dgrad and wgrad, layout transposes,
           pooling, copies, batch norm and elementwise), then the same
           steps interpreted from the same state (losses, parameters,
           velocities and running statistics bit for bit the replay's),
           then again with conv_layout=NHWC; ms a step, images/s, the
           idle share, peak memory, capture seconds and the model FLOPs
           (the Program's conv2d and fc shapes, forward x 3) against the
           bf16 peak;
  resnet_card_vs_cpu  ResNet-18 at 64x64, batch 8, float32: two steps
           on the CPU and on the card (with cuDNN's TF32 switch on) from
           the same startup weights, losses and every state within 1e-4;
  vgg_segmented  the book's VGG-16 with batch norm and dropout at the
           CIFAR-10 width (32x32, 10 classes, batch 128, float32) in the
           default mode, which the dropout ops make segmented (each runs
           eagerly between captured device segments): the segment
           counts, finite losses, and the interpreter's losses and keep
           rates from the same state and seed;
  dropout_rows  the batch-position-keyed dropout draw on the card
           against the CPU's, bit for bit (a whole draw, two halves at
           their row offsets, the op's lowering), its keep rate within
           4 sigma, and its time beside torch.rand;
  image_models  the rest of run_image's models at its defaults (alexnet
           227x227 with lrn, googlenet 224x224 with concat, smallnet
           32x32, vgg19 224x224; batch 128, bf16 throughout, Momentum):
           the default mode (segmented around the dropouts, one graph for
           smallnet) against the interpreter bit for bit, images/s, model
           FLOPs against the bf16 peak, device time by group, segments,
           graphs and peak memory;
  ctr      DeepFM and wide&deep (models/ctr.py, every slot an
           is_sparse embedding: SelectedRows gradients) at the DeepFM
           paper's Criteo setting (26 categorical slots of 38,462 rows,
           13 dense features, embed_dim 10, hidden 400-400-400, Adam
           1e-3, float32, batch 2048, Zipf ids): the default mode (one
           CUDA graph a step) against the interpreter bit for bit, the
           dense-gradient Program bit for bit, 3 steps on the CPU within
           1e-5 (losses, Adam's moments; the parameters when no ReLU of
           the MLP flipped between the two, with the flips counted),
           one sparse SGD step twice bit for bit (untouched rows
           unchanged), the loss falling; ms a step, examples/s, idle
           share, device time by group, peak memory, capture seconds and
           the interpreted step;
  rnn      run_rnn's LSTM text classifier at its defaults (vocab 30000,
           embedding 128 in bf16, fc to 4 x 512, dynamic_lstm hidden 512
           with peepholes, the last step, fc 2 softmax, Adam 2e-3, batch
           128, 100 int64 ids a sequence as one LoDTensor): the default
           mode (one CUDA graph) against the interpreter bit for bit
           (losses and every state), the loss falling; two seeded
           ragged LoDs (lengths 10-100) through the same Program, each a
           capture of its own and replays after; two Adam steps at batch
           16 with a float32 embedding on the card and on the CPU
           (losses within 1e-5, every state within 1e-4); ms a step,
           tokens/s beside the reference's published K40m time, model
           FLOPs against the fp32 peak, device time by group, idle share,
           peak memory and capture seconds;
  rnn_seq2seq  run_seq2seq's `--model rnn` LSTM translator at its
           defaults (batch 32, source and target 128, hidden and
           embedding 512, vocab 30000 on both sides, Adam 1e-4, bf16
           amp): the default mode against the interpreter bit for bit,
           tokens/s, device time by group and idle share;
  book08   book/08's machine translation (the Programs of
           tests/book/test_machine_translation.py, built here by a copy
           of its functions) at the scale of run_seq2seq's LSTM
           translator (vocab 30000 on both sides, embedding and hidden
           512, fc to 4 x 512 into dynamic_lstm, the shared `vemb`
           table, Adam 1e-4, float32; the book's copy task at batch 32,
           source lengths 10-127): mt_train (the DynamicRNN decoder)
           and mt_attention (the attention decoder, source padded to
           128), each in the default mode (one CUDA graph a LoD, one
           more seeded LoD after the timed one) against the
           interpreter bit for bit; mt_decode, the While + beam_search
           decoder (beam 2, top-k 4, 32 iterations) over 32 sources
           with mt_train's parameters; mt_card_vs_cpu, batch 8 (source
           lengths 10-32) on the card and on the CPU: two Adam steps
           (losses within 1e-5, states within 1e-4) and the decode (ids
           and LoDs equal, scores within 1e-5, the smallest
           chosen-vs-rejected score gap of the beams);
  book07   book/07's semantic-role tagger (db_lstm: eight is_sparse
           embeddings, 8 alternating LSTMs, linear_chain_crf, its
           crf_decoding and chunk_eval) at the book's published widths
           (see the L_ constants), batch 10, SGD: the default mode (one
           device segment replayed as a CUDA graph a LoD, then the host
           chunk_eval; one more seeded LoD) against the interpreter bit
           for bit, the loss falling, the eval program of
           fluid.io.get_inference_program on a fresh batch, and two steps
           on the card and on the CPU (losses within 1e-5, states within
           1e-4, Viterbi paths equal); ms a step, tokens/s, device time
           by group, kernels, idle share, chunk_eval's host ms, peak
           memory;
  dp_gspmd the GSPMD step's two forms: resnet50_dp1, run_scaling's
           ResNet-50 step (bf16, batch 64) through
           ParallelExecutor(mesh={"dp": 1}) and ShardingTranspiler
           (overlap="auto") under a one-rank NCCL group (the sync-BN
           form) against the Executor; dp2_one_card, two gloo ranks on
           the one card (this script run again as `--dp2-worker`):
           run_scaling's default ResNet (bf16 and float32; sync-BN) and
           book07 (replicated) against one process's serial run at the
           global batch (the ResNets within twice a band of the serial
           steps summed in other orders), the ranks bit-equal; the
           first step's gradients; ms a step per arm and form,
           all-reduces a step by kind, peak memory (see the P_
           constants);
  tp_zero  tensor parallelism and ZeRO-1: the train phase's LM through
           ShardingTranspiler(mesh={"dp": 2, "tp": 2}) with
           shard_optimizer_states=True and Megatron's placement
           (parallel/tensor_parallel.py megatron_placement: q, k, v and
           the FFN's first fc column-split with their biases, the
           attention output and the FFN's second fc row-split), four
           gloo ranks on the one card (this script run again as
           `--tp-zero-worker`), against the serial Executor's steps from
           the same startup (run first and freed): bf16 amp at 12
           layers for 3 steps, the losses within 2e-2 relative; float32
           (TF32 off) at 2 layers for 2 steps, every parameter within
           2e-4 relative and 1e-5 absolute; the flash kernels on each
           rank's local heads ([4, 512, 8, 128]), one of each a layer a
           step; the ranks' losses equal; the collective record a step
           (6 all-reduces over tp a layer, ZeRO-1's all-gathers over
           dp) by kind and bytes, ms a step and peak memory a rank (see
           the TZ_ constants);
  a9       pipeline, sequence and expert parallelism on four gloo ranks
           on the one card (this script run again as `--a9-worker`),
           each arm against the serial Executor's steps from the same
           startup (run first and freed): the train phase's LM built
           with pipeline_stages=4 through ShardingTranspiler(mesh={"dp":
           1, "pp": 4}).build_executor (PipelineExecutor, GPipe, 4
           microbatches, amp); 4 layers at {"pp": 2, "tp": 2} with 1F1B
           (amp) and at {"pp": 2, "sp": 2} with GPipe (float32, ring
           attention); the moe phase's LM through ParallelExecutor(mesh=
           {"dp": 1, "ep": 4}) with its experts placed P("ep") (amp);
           2 steps an arm; then ring and Ulysses attention at [2, 512,
           16, 128] against attention_reference and moe_ffn_a2a against
           moe_ffn; ms a rank-step, peak memory a rank, the collectives a
           step by axis, kind and bytes, flash and route launches a rank
           (see the A9_ constants);
  ssd      MobileNet-SSD300 on VOC's geometry (see the SSD_ constants):
           the default mode (three device segments around the host
           bipartite_match and mine_hard_examples, each a CUDA graph)
           against the interpreter bit for bit, the loss falling, three
           more ground-truth LoDs, the decode (detection_output,
           detection_map) on the batch; then card against CPU at batch
           2, a step at a time from the CPU's state (losses, matches,
           mined negatives, detections; states but those a flipped ReLU
           may move); images/s, the host ops' ms and share, decode ms
           and its NMS share;
  ocr_ctc  CRNN-CTC (see the OCR_ constants) as the ssd phase: one CUDA
           graph, three more label LoDs, the greedy decode and edit
           distance, card against CPU at batch 4; images/s and the
           decode's host ms;
  readers  the random -> shuffle(64) -> batch(32) reader chain at the
           ssd phase's image shape: the card's batches on cuda:0 and
           equal to the CPU chain's bit for bit;
  remat    the train phase's LM (amp) and ResNet-50 (bf16), each
           without and with recompute segments from the same states,
           default mode and interpreter bit for bit; losses, the LM's
           weights, flash launches (wrappers and the captured graph's
           kernel nodes), ResNet-50's running statistics, and a float64
           ResNet-50 pair whose running statistics are held; ms a step,
           peak memory, device time by group;
  memory_plan  the replayed train, seq2seq and resnet50 steps' peaks
           with the compiled mode's frees, and the memory_optimize flag
           on the interpreted ResNet-50 (states bit-equal);
  analysis the analysis package (A12) over the main path, no training
           step of its own: Program.verify(level="error") over the
           train LM, seq2seq, ResNet-50, book/08's DynamicRNN
           translator and While decoder, DeepFM (is_sparse), SSD300 and
           CRNN-CTC (train and decode) at full width, zero error
           diagnostics; the cost model's static FLOPs of the LM (amp,
           batch 8), seq2seq (32) and ResNet-50 (128) steps within
           [0.5, 2.5]x of the model FLOPs, their static bytes and
           roofline on the card's DEVICE_SPECS row beside the replayed
           step ms (the calibration ratio) and memory_plan's peaks;
           the serve phase's decode backend resolved "cuda", the
           decoder's; the paged kernel row's bytes-bound beside the
           kernels phase's; `cli verify --json`, `cli analyze --json`
           (the LM's config) and `cli concurrency --sched` as
           subprocesses, the last one's exit code 0.  (The train phase's
           Executor runs under PADDLE_TPU_VERIFY=error: its line's
           `verify` holds the one verification's seconds and the runs
           that hit the pre-flight cache);
  generate run_generation's LM decoded by the full forward, the kv
           cache and beam search, and run_seq2seq's translator: tokens
           a second, kernels and host syncs a token, kv equal to the
           full forward, card against CPU at a cut width;
  image_serve  run_image's serve_one on ResNet-50 through
           InferenceServer: single-stream ms, requests/s under 256
           concurrent requests, every result against the Executor's,
           no capture after construction;
  persist  run_seq2seq's translator (amp, Adam) through the port's
           Trainer, 4 iterations, a snapshot every 2: killed at iteration
           3 by the `trainer.iteration` fault site and resumed by a new
           Trainer in a fresh scope, bit-equal to an uninterrupted run
           in its steps, losses and every persistable; step 2's snapshot
           loaded into the uninterrupted run's captured graph replays
           steps 3-4 bit for bit; the checkpoint's bytes, save and load
           seconds; then image_serve's ResNet-50 saved as an inference
           model (one file a variable, and one params file), loaded into
           a fresh scope and served: logits bit-equal to the in-memory
           program's; its parameters through Parameters' tar bit for bit;
  conv_rest  A3's ten ops at published shapes (the CR_ constants):
           forward and gradient on the card, twice bit for bit, timed,
           with ATen's convolution route; card against the CPU at batch
           1 (float32 held to the CPU's float64 no worse than twice the
           CPU's float32; bf16 within one ulp of the CPU's float32 on the
           same values); then DCGAN (the DC_ constants) trained 4
           alternating iterations in the default mode and interpreted,
           bit for bit, and card against CPU in float64 at batch 8;
  aot_native  A10b: the flash forward's host time through the op
           paddle_tpu_torch::flash_attention_fwd against the direct
           call, a call and in the interpreted LM forward (the
           flash_attention lowering swapped to call the op); the train
           phase's LM forward (logits, amp, AOT_LM_LAYERS = 2 layers at
           full width) exported with io.export_aot_model and reloaded on
           the card: 2 flash op nodes and no SDPA, softmax or logsumexp
           node, 2 flash launches a call, logits at the flash phase's bf16 bar
           against the Executor's forward; a `go` block runs the
           artifact and sends its logits through a channel, bit-equal to
           the main thread's; the same at 1 layer loaded on the CPU,
           within SRV_ULPS of the card; the moe phase's MoE LM forward
           at AOT_MOE_LAYERS = 2 layers: 2 route op nodes, 2 route
           launches a call; image_serve's
           ResNet-50 at batch 16 within SRV_ULPS of the Executor's
           replayed step and unchanged after the scope is zeroed; the
           same model saved and run through the C ABI (`_capi`) on the
           card from a fresh interpreter (ctypes) and from a standalone
           C host (gcc, where the interpreter has a shared libpython),
           both within SRV_ULPS; ResNet-50 trained 4 steps at batch 32
           fed through reader.native_pipeline, losses and states
           bit-equal to direct feeds; export and load seconds, artifact
           bytes, ms a call against the Executor's replayed step, and
           the loader's batches/s against the step rate;
  pserver  A11's wire: Programs transpiled by DistributeTranspiler's
           pserver mode, trained with their trainers on the card and two
           pservers an arm on the host (subprocesses started through
           paddle_tpu_torch.launch; each pserver runs the Program's own
           optimizer ops in a CPU Executor).  ctr_t1: the ctr row's
           DeepFM (is_sparse, Adam, batch 2048) with one trainer in this
           process, 3 rounds, held against the serial Executor from the
           same parameters at the float32 gate (2e-4 / 1e-5); ctr_t2:
           the same model with two trainer processes, their batches
           through cloud_reader from a Master over RecordIO chunks and
           their pservers found through a Registry, 4 rounds (both
           trainers' parameters bit-equal and equal to a GET from the
           pservers; every chunk dispatched and finished once);
           vgg16_cluster: run_cluster_vgg16's 2 x 2 at its defaults,
           aggregate samples/s; seq2seq_t1: the seq2seq phase's
           translator (amp, Adam) with one trainer, 3 rounds (the eager
           run, the capture, a replay after a pull), against the serial
           Executor: every round's parameters and loss bit-equal
           (PS_S2S_GATE) and the serial step's flash launches;
           two serial runs give the card's own spread beside it.  For
           each arm: ms a round, split into the device segment and the
           host part (device-to-host copies, the wire round, the copies
           back), bytes and frames by verb a round, peak memory;
  elastic  A11's elastic cluster (after pserver): s2s_elastic, the
           seq2seq phase's translator (amp, Adam) trained 6 rounds by one
           trainer here through Trainer.train(cluster=) against a
           ClusterController here and elastic pservers on the host
           (VariableServer(elastic=True, snapshot_every=1), three
           subprocesses of this script, two leased at first): pserver 1
           SIGKILLed at round 3's send once its round-2 snapshot is
           written (round 3 replays against the next view, its shards
           and their Adam state restored from that snapshot), pserver 2
           joining before round 5 (fence, PUT_BATCH migration with the
           state, drop, commit); held to seq2seq_t1's gate against the
           serial Executor from the same parameters (_el_verdict), the
           final GET bit-equal to the trainer's copy, the final
           placement balanced_split over the live endpoints; ms a round
           (device, D2H, wire, H2D), SIGKILL to the next stable view,
           the replayed round, the join's bytes and seconds, the view
           epochs.  A TelemetryCollector here scrapes the cluster on a
           registry of its own: the trainer (this process, at
           Trainer.train) and each pserver (at its lease) announce; the
           collector must list the trainer and pservers 0 and 1, reclaim
           pserver 1's series within max(fail_limit x period, the
           announcement's TTL) of its SIGKILL, and list pserver 2 once
           it joins;
  fleet    A11's serving fleet at the serve phase's width and weights:
           the model saved with its warm-start artifact (the kernels'
           build cache and its manifest); a ReplicaRouter hosting the
           registry, a TelemetryCollector on it and an Autoscaler (min
           1, max 3) spawning `python -m paddle_tpu_torch.cli serve`
           replicas (--telemetry); one replica's token rate in a
           closed-loop burst, then an open-loop ramp of seeded greedy
           requests (prompts 16-64, max_new 32-128) at 0.3x, 1.5x and
           0.1x that rate; the peak runs until the scale-out replica
           (15-20 s from spawn to serving) has served beside the floor
           one for 4 s, when the busiest autoscaler-owned replica, with
           several streams on it, is SIGKILLed; the tail runs until a
           scale-in has brought the fleet back to one replica, which
           then serves a closing closed-loop burst.  Held: zero failed
           requests; every stream equal token for token to the same
           request decoded by an in-process GenerationServer on the
           same weights (the resumed ones included); at least 2
           replicas serving at the peak, the kill cutting >= 2 streams,
           a drain-then-retire scale-in and 1 at the end; every
           scale-out replica warm (0 compiles, 0 misses, >= 1 hit, 0
           rebuilds after warmup, decode on the kernel) and, once it
           served tokens, its own paged-attention launch count above
           0; a --cold replica (the build dir empty) compiling >= 1
           source; no crash loop; the router and every spawned replica
           listed and scraped by the collector, the killed one's series
           reclaimed within the bound, a retired one delisted; the
           federation dump holding member/kind-labelled series of the
           replicas and the router; `cli top` rendering the fleet,
           `cli slo --check` evaluating the serving lines (its verdict
           reported as it falls), `cli why` naming the decode phase,
           `cli trace-of` joining the router's p99 exemplar to a
           tail-sampled trace.  Reports the rate, the ramp's tokens/s
           by phase and over the peak's two-replica stretch, a warm and
           a cold replica's seconds from spawn to first token, SIGKILL
           to the resumed streams, the scale events, each replica's
           launches;
  tools    A10c, two lines.  "profiler" (run inside the train phase, on
           its replayed graph; its seconds are its own):
           profiler.profile_compiled_ops over 3 replays of the LM's
           step (each flash kernel 3 x 12 calls under its op's scope,
           flash_attention:... or flash_attention_grad:..., 95 % of the
           table's device time scoped, its total within 2 % of
           _profile_step's device time over 3 replays; the top 15 rows
           printed), xla_profiler's Chrome trace of a replay (the three
           flash kernels named), program_to_code and draw_block_graphviz
           over the LM's training Program (one op node an op).  "cli"
           (after seq2seq): the seq2seq phase's translator written as a
           CLI config and run through paddle_tpu_torch.cli.main in this
           process: train 4 batches with --save_dir (the flash wrappers
           18 a kernel on the eager run and on the capture; a profiled
           replay runs 18 of each), test on that pass (its losses those
           of the trained scope's test program run again, bit for bit),
           merge (the merged model's logits, loaded with
           load_inference_model, the test program's forward bit for
           bit), time 5 batches (within 1.5x of the seq2seq phase's
           replayed step), and the time job again as `python -m
           paddle_tpu_torch.cli`; then --job=checkgrad on a small fc
           config in the default mode and interpreted (both pass, the
           numeric gradients within 1e-6).

Every phase line carries `seconds`, its wall time (since the line
before it, but for lines that time their own part), and a `timing`
line before the kernels line lists them all.

The main paths are the train phase's kernel path (flash attention; the
train_fp32 and seq2seq phases' too), the kernel-path serve and spec
phases (paged attention), the dp phase's fused run (fused bucket update) and the moe
phase's kernel path (MoE gate + dispatch and its backward), and the
aot_native phase's calls of the loaded artifacts (the flash forward and
the MoE route kernel through their ops): each kernel's launch counts
are zeroed just before its path and read just after.  A CUDA graph's
replay runs the captured kernels without their wrappers, so on the
train, seq2seq and moe paths the counts cover the eager first step and
the capture, and the kernels line adds the profiler's count in a
replayed step (and the persist phase's uninterrupted seq2seq run's
wrapper counts, the aot_native phase's artifact calls, the pserver
phase's seq2seq_t1 trainer, the elastic phase's s2s_elastic trainer,
and the tp_zero and a9 ranks' own counts:
each process counts its own launches).  The image, optimizers, ctr,
rnn, book08, book07, dp_gspmd, ssd, ocr_ctc, readers and conv_rest
phases run no kernel of the port's own (the JAX package runs the recurrences, the CRF and CTC
as `lax.scan`, the sequence, sampling and detection geometry ops as XLA
gathers, einsums and segment sums, the While loop, beam search,
chunk_eval, matching, mining, NMS, mAP and the readers on the host and
the GSPMD step's collectives in XLA, with no Pallas kernel):
convolution, pooling, batch
norm, lrn and concat are cuDNN or plain PyTorch calls there, and the
SelectedRows gradients are made dense, and sparse SGD scatters, by
sorted segment sums in plain PyTorch, as all of these are XLA ops in
the JAX package.
Any failed check raises, and the script exits non-zero.  The last line is
the device record {"ok": true, "device": {...}}.  With no CUDA device,
or without the package beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# published dense peaks (NVIDIA data sheets, without sparsity) beyond the
# port's chip table (analysis/cost_model.DEVICE_SPECS: HBM bytes/s and
# the bf16 tensor-core peak): fp32 FLOP/s outside the tensor cores and
# TF32 FLOP/s on them, by the same keys
_CARD_PEAKS = {"H200": (67e12, 495e12),
               "H100 NVL": (60e12, 418e12),
               "H100 PCIe": (51e12, 378e12),
               "H100": (67e12, 495e12)}

V, D_MODEL, N_HEADS, N_LAYERS, D_INNER = 32000, 512, 8, 6, 2048
BLOCK, MAX_BLOCKS, SLOTS, KV_BLOCKS = 16, 32, 8, 256
N_REQUESTS, SEED = 12, 0
KV_DTYPES = ("fp32", "bf16", "int8")

# the training configuration: benchmark/run_ridge.py's defaults
T_VOCAB, T_D, T_HEADS, T_LAYERS, T_SEQ, T_BATCH = 30000, 2048, 16, 12, 512, 8
T_STEPS = 4
# the train and moe phases' steps in each mode: in the default mode the
# miss (eager), the first hit (captured into a CUDA graph, then
# replayed) and a replay
G_STEPS = 3
# kernel path vs plain path: per-step loss, and each weight matrix's
# change over the steps (||dW_kernel - dW_plain|| / ||dW_plain||).  At
# random init the attention is near uniform, so dS = P (dP - delta) is a
# difference of near-equal terms and the Q/K projections' updates differ
# by up to ~1e-3 from float32 summation order alone; a miswired backward
# (dK and dV swapped, a scale dropped) moves them by order one
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-2
# the same under bf16 amp (train and moe phases; the dp phase's fused
# and chain runs share every product, so they keep the fp32 limits):
# each step's loss within one bf16 ulp of the plain path's (ulp(v) =
# 2^(floor(log2|v|) - 7)), each weight matrix's change within 15 %.
# From the CPU parity runs (tests/test_torch_amp.py, 5 steps of a
# 2-layer LM): the step-0 forward is bit-equal to the JAX package's,
# and bf16 rounding flips (1-3 ulps in bias and layer-norm gradients)
# then grow to at most 0.4 ulp in the loss and 10 % in a parameter's
# change — the JAX package's own compiled and interpreted modes differ
# by up to 13.5 %.  A miswired gradient moves a weight by order one
LOSS_ULPS_BF16, PARAM_RTOL_BF16 = 1, 0.15
FLASH_SHAPE = (T_BATCH, T_SEQ, T_HEADS, T_D // T_HEADS)

# the seq2seq configuration: benchmark/run_seq2seq.py's defaults
# (transformer translator, d_model 512, 8 heads, 6 + 6 layers, vocab
# 30000 on both sides, batch 32, source and target length 128, Adam 1e-4,
# bf16 amp, dropout 0); tokens a step counted as run_seq2seq counts
# them, batch x (src + tgt)
S_VOCAB, S_D, S_HEADS, S_LAYERS, S_LEN, S_BATCH = 30000, 512, 8, 6, 128, 32
S2S_FLASH_SHAPE = (S_BATCH, S_LEN, S_HEADS, S_D // S_HEADS)

# the generate phase: benchmark/run_generation.py's defaults (vocab
# 32000, context 512, prompt 16, d_model 512, 6 layers, 8 heads, batch 8,
# beam 4, float32), ctx - prompt = 496 steps; the card-vs-CPU check cut
# to 2 layers and 64 steps; the translate generator at run_seq2seq's
# transformer (S_*), 127 steps
GEN_VOCAB, GEN_CTX, GEN_PROMPT, GEN_D, GEN_LAYERS = 32000, 512, 16, 512, 6
GEN_HEADS, GEN_BATCH, GEN_BEAM = 8, 8, 4
# beam search decodes GEN_BEAM_STEPS positions
GEN_STEPS, GEN_BEAM_STEPS = GEN_CTX - GEN_PROMPT, 64
GEN_CPU_LAYERS, GEN_CPU_STEPS, GEN_TIE_RTOL = 2, 64, 1e-5
GEN_FLASH_SHAPE = (GEN_BATCH, GEN_CTX, GEN_HEADS, GEN_D // GEN_HEADS)
# the image_serve phase: benchmark/run_image.py:154-204's serve_one for
# ResNet-50 (bf16): buckets, batching window, single-stream requests and
# concurrent ones
SRV_BUCKETS, SRV_WINDOW_MS, SRV_SINGLE, SRV_CONCURRENT = \
    (1, 2, 4, 8, 16), 0.3, 30, 256
# a served result against the Executor's batch-1 run of the same image:
# the bucket's batch size changes cuDNN's algorithms, so bf16 roundings
# flip in ~50 layers; a random walk of 1-ulp flips (2^-8) over sqrt(50)
# layers is ~4 ulps of the output: held at twice that, in bf16 ulps of
# max|reference| of the row
SRV_ULPS = 8

# the MoE configuration: benchmark/run_moe.py's defaults
M_VOCAB, M_D, M_HEADS, M_LAYERS, M_SEQ, M_BATCH = 30000, 1024, 8, 6, 512, 8
M_EXPERTS, M_TOPK, M_CF, M_AUX = 8, 2, 1.25, 0.01
# the moe_kernel phase's router: N(0, 0.05), about the spread of the
# LM's Xavier-initialised [1024, 8] gate weights
M_GATE_STD = 0.05

# the ops phase: every op type of the dense corpus, card against CPU in
# float32 (TF32 off), each output and generic gradient within OPS_RTOL
# of max(1, max|CPU value|); matmul and cast again in bf16 under amp,
# within one bf16 ulp
OPS_RTOL = 1e-5
# the corpus's op types: 89 dense, 19 LoD sequence and recurrent, the 4
# IfElse split and merge ops (host ops) and their gradient ops, the 3
# CRF ops (chunk_eval a host op), the 8 device ops of CTC, the
# sampled losses and detection, and the 10 conv ops of A3's rest
OPS_TYPES = 133

# the image configurations: benchmark/run_image.py's resnet50 at its
# defaults (224x224, 1000 classes, batch 128, bf16 throughout: the image,
# every parameter and Momentum's velocity); ResNet-18 at 64x64, batch 8,
# float32, on the card and on the CPU (the card-vs-CPU phase); the
# book's VGG-16 with batch norm and dropout at the CIFAR-10 width (32x32,
# 10 classes, batch 128, float32)
R_IMG, R_CLASSES, R_BATCH, R_DEPTH = 224, 1000, 128, 50
C_IMG, C_CLASSES, C_BATCH, C_DEPTH, C_STEPS = 64, 1000, 8, 18, 2
V_IMG, V_CLASSES, V_BATCH = 32, 10, 128
# card against CPU in float32: losses, and every parameter, velocity and
# running statistic after the steps, within 1e-4 of max(1, |CPU value|)
# (cuDNN and the CPU's convolutions sum in other orders; the CPU tests
# hold the CPU path to the JAX package at the same 1e-4)
CARD_CPU_RTOL = 1e-4
# the rest of run_image's models at its defaults (batch 128, bf16
# throughout, Momentum): (model, image side, classes)
IMAGE_MODELS = (("alexnet", 227, 1000), ("googlenet", 224, 1000),
                ("smallnet", 32, 10), ("vgg19", 224, 1000))
I_BATCH = 128
# the dropout_rows phase's draws: (name, shape, p, dtype); AlexNet's fc
# dropout as run_image runs it, and VGG-16's first conv dropout (float32,
# several chunks of the keyed draw)
DROPOUT_CASES = (("alexnet_fc", (128, 4096), 0.5, torch.bfloat16),
                 ("vgg_conv", (128, 64, 32, 32), 0.3, torch.float32))

# the CTR configuration: the DeepFM paper's Criteo setting (Guo et al.,
# IJCAI 2017, sec. 3.1): 26 categorical and 13 dense fields, embed_dim
# 10, hidden sizes (400, 400, 400), Adam 1e-3, float32; 38,462 rows a
# slot (1.0 M rows, the order of Criteo's hashed vocabulary), batch 2048;
# the paper's dropout 0.5 is not in models/ctr.py, so none.  Ids are
# drawn Zipf-like (a = 1.1, modulo the rows), so a batch repeats ids as
# click logs do; labels follow tests/test_ctr.py's interaction rule
X_MODELS = ("deepfm", "wide_deep")
X_SLOTS, X_DENSE, X_ROWS, X_EMBED = 26, 13, 38462, 10
X_HIDDEN, X_BATCH, X_LR, X_ZIPF = (400, 400, 400), 2048, 1e-3, 1.1
# card against CPU over the first X_CPU_STEPS steps: losses, and every
# state that is not a parameter (Adam's moments, the beta powers), within
# X_CPU_RTOL of max(1, |CPU value|) (relative for losses).  The
# parameters are held so too when no ReLU of the MLP took the other side
# of zero on the card: cuBLAS and the CPU sum the fc products in other
# orders, a pre-activation within rounding of 0 can flip its mask, and
# that example's gradient then changes by a few percent; Adam divides
# each element's step by its own running RMS, so such an element moves
# by up to the learning rate (1e-3) whatever the size of the change,
# and no limit below the learning rate holds a parameter then
X_CPU_STEPS, X_CPU_RTOL = 3, 1e-5
# the optimizers phase: each update op at one CTR table's shape, card
# against CPU within OPT_RTOL of max(1, max |CPU value|)
OPT_RTOL = 1e-6
OPT_ATTRS = {"proximal_gd": {"l1": 0.05, "l2": 0.1},
             "proximal_adagrad": {"l1": 0.05, "l2": 0.1},
             "ftrl": {"l1": 0.05, "l2": 0.1},
             "average_accumulates": {"average_window": 0.5,
                                     "min_average_window": 2,
                                     "max_average_window": 4}}


# the rnn phase: benchmark/run_rnn.py's defaults (:19-48, :97-99): vocab
# 30000, embedding 128 in bfloat16 (its --dtype), fc to 4 x 512,
# dynamic_lstm with hidden 512 and peepholes (the layer's default), the
# last step, fc 2 softmax, cross entropy, Adam 2e-3, batch 128, 100 int64
# ids a sequence; the reference's own published time for that setting,
# one K40m (run_rnn.py:23-28, benchmark/README.md:115-135)
N_VOCAB, N_EMB, N_HID, N_BATCH, N_LEN, N_LR = 30000, 128, 512, 128, 100, 2e-3
N_REF_MS = 261.0
# ragged LoDs through the same Program: N_RAGGED seeded length vectors in
# [N_RAGGED_MIN, N_LEN]; then more recurring LoDs than the graph budget
# (the budget set to the graphs live, N_OVER new LoDs and N_OVER of the
# captured ones fed in turns, N_OVER_ROUNDS rounds); card against CPU:
# N_CPU_STEPS Adam steps at
# batch N_CPU_BATCH with a float32 embedding, losses within
# N_CPU_LOSS_RTOL relative, every state within N_CPU_RTOL of max(1,
# |CPU value|) (the CPU tests hold the CPU path to the JAX package)
N_RAGGED, N_RAGGED_MIN = 2, 10
N_OVER, N_OVER_ROUNDS = 2, 3
N_CPU_BATCH, N_CPU_STEPS, N_CPU_LOSS_RTOL, N_CPU_RTOL = 16, 2, 1e-5, 1e-4
# run_seq2seq --model rnn at its defaults (:63-103, :155-162): batch 32,
# source and target length 128, hidden and embedding 512, vocab 30000 on
# both sides (N_VOCAB), Adam 1e-4, bf16 amp
Q_BATCH, Q_LEN, Q_HID, Q_EMB, Q_LR = 32, 128, 512, 512, 1e-4
# the book08 phase: book/08 (tests/book/test_machine_translation.py) at
# run_seq2seq's LSTM-translator scale (benchmark/run_seq2seq.py:63-103):
# vocab 30000 on both sides, embedding and hidden 512, float32, Adam 1e-4;
# the book's copy task (<s> = 0, <e> = 1) at batch 32 with source lengths
# drawn in [B_MIN_LEN, B_MAX_LEN], so every target with its <s> or <e> is
# at most 128 tokens; the attention decoder pads the source to B_MAXS;
# B_LODS more seeded LoDs after the timed one.  The decoder: beam 2, top-k
# 4 (the book's BEAM and TOPK) and B_DECODE_LEN While iterations over
# B_BATCH sources.  Card against CPU at batch B_CPU_BATCH and source
# lengths up to B_CPU_MAX_LEN (cut so the CPU runs it): B_CPU_STEPS Adam
# steps, losses within N_CPU_LOSS_RTOL and states within N_CPU_RTOL; the
# decode's ids and LoDs equal, its scores within B_SCORE_RTOL relative
B_VOCAB, B_EMB, B_HID, B_LR, B_START, B_END = 30000, 512, 512, 1e-4, 0, 1
B_BATCH, B_MIN_LEN, B_MAX_LEN, B_MAXS, B_LODS = 32, 10, 127, 128, 1
B_BEAM, B_TOPK, B_DECODE_LEN = 2, 4, 32
B_CPU_BATCH, B_CPU_MAX_LEN, B_CPU_STEPS, B_SCORE_RTOL = 8, 32, 2, 1e-5
# the book07 phase: book/07's semantic-role tagger (db_lstm of Paddle's
# python/paddle/v2/fluid/tests/book/test_label_semantic_roles.py) at its
# published widths: the CoNLL-05 dictionaries (44068 words, 3162
# predicates, 59 labels), 2 marks, word_dim 32, mark_dim 5, hidden_dim 512
# (each feature's fc and the dynamic_lstm size, 4 x its hidden 128), depth
# 8, the CRF transition `crfw` at learning rate mix_hidden_lr 1e-3,
# chunk_eval over IOB with 29 chunk types, batch 10 (BATCH_SIZE); SGD at
# L_LR, the book's 1e-4 (at 0.01 the loss goes 135 -> 1027 -> 1.8e6 -> NaN
# in five steps, on the card and on the CPU).  A synthetic CoNLL-shaped
# feed: sentence lengths drawn in
# [L_MIN_LEN, L_MAX_LEN], labels from a rule on the word ids so the loss
# can fall; L_LODS more LoDs after the timed one; card against CPU over
# L_CPU_STEPS steps (losses within N_CPU_LOSS_RTOL, every state within
# N_CPU_RTOL of max(1, |CPU value|), the Viterbi paths equal)
L_WORDS, L_PREDS, L_LABELS, L_MARKS = 44068, 3162, 59, 2
L_WORD_DIM, L_MARK_DIM, L_HIDDEN, L_DEPTH, L_CRF_LR = 32, 5, 512, 8, 1e-3
L_LR, L_BATCH, L_MIN_LEN, L_MAX_LEN, L_LODS, L_CPU_STEPS = \
    1e-4, 10, 5, 60, 1, 2
# the dp_gspmd phase: benchmark/run_scaling.py's step (:33-88; bf16
# throughout, Momentum 0.1 / 0.9): resnet50_dp1 at --depth 50 --img 224
# --batch-per-dev 64 (resnet_imagenet, 1000 classes) under a one-rank
# NCCL group, both arms against the Executor at batch 64; dp2_one_card at
# run_scaling's defaults (depth 32, img 32, batch 64 a rank:
# resnet_cifar10, 10 classes) and book07's program on two gloo ranks of
# the one card against one process's serial run at the global batch.
# Held over the first P_HELD steps: losses within one bf16 ulp (float32:
# N_CPU_LOSS_RTOL relative), parameters, velocities and running
# statistics within P_STATE_RTOL of max(1, |reference|) after the first
# step and after P_HELD steps, and the first step's gradients (Momentum's
# velocities after it) within P_STATE_RTOL of their largest magnitude;
# the ranks bit-equal; G_STEPS steps timed.  run_scaling's step at lr 0.1
# is ill-conditioned: any change in the order its sums are taken in moves
# its float32 states by about 1e-3 after one step and 0.1 after three
# (ReLUs flip).  So rank 0 also runs a band of the serial steps summed in
# other orders, P2_PERMS runs with each batch's rows permuted and, for
# the float32 ResNet, the float64 program from the same values; each
# limit of dp2_one_card's ResNets is twice the band's largest reading
# where that exceeds the fixed one.  book07 (replicated) has no band
P_DEPTH, P_IMG, P_BATCH, P_CLASSES = 50, 224, 64, 1000
P2_DEPTH, P2_IMG, P2_BATCH, P2_CLASSES = 32, 32, 64, 10
P_LR, P_MOMENTUM, P_HELD, P_STATE_RTOL = 0.1, 0.9, 3, 1e-2
# the band's row permutations, and the program each ResNet's band also
# runs in another dtype
P2_PERMS = 6

# the ssd phase: MobileNet-SSD300 on VOC's geometry (PaddlePaddle/models
# fluid/object_detection/mobilenet_ssd.py, 2018, on MobileNet v1 at width
# 1.0, Howard et al. 2017 Table 1): 300x300x3, 21 classes, the heads on
# module 11 (512 @ 19x19), module 13 (1024 @ 10x10) and four extra blocks
# (5x5, 3x3, 2x2, 1x1): 2278 priors; ssd_loss (overlap 0.5, neg_pos_ratio
# 3), reduce_sum / the priors matched, RMSProp 1e-3, float32, batch 32;
# 1-6 ground-truth boxes an image (VOC averages about 2.4).  RMSProp's
# first update, from a zero mean square, moves every weight by about
# lr / sqrt(1 - rho) = 4.5 x lr whatever its gradient: from random
# weights the loss jumps after it, so the loss is held from the second
# step (SSD_LOSS_FROM)
SSD_IMG, SSD_CLASSES, SSD_SCALE, SSD_LR, SSD_BATCH = 300, 21, 1.0, 1e-3, 32
SSD_LOSS_FROM = 1
SSD_BOXES, SSD_PRIORS, SSD_LODS = (1, 6), 2278, 3
# the ocr_ctc phase: CRNN-CTC (PaddlePaddle/models fluid/ocr_recognition/
# crnn_ctc_model.py, 2018): 1x48x512 images, conv groups of 16, 32, 64
# and 128 filters, each pooled (128 x 3 x 32), im2sequence to 32 steps of
# 384, fc to 3 x 200 into a forward and a reverse GRU of 200, fc to 95 + 1
# classes; warpctc (blank 95, norm_by_times), reduce_sum, Momentum 1e-3 /
# 0.9, float32, batch 32; labels of 3-12 characters
OCR_IMG, OCR_FILTERS, OCR_HIDDEN, OCR_CLASSES = (1, 48, 512), \
    (16, 32, 64, 128), 200, 95
OCR_LR, OCR_BATCH, OCR_LABEL_LENS, OCR_LODS = 1e-3, 32, (3, 12), 3
# card against CPU (cut so the CPU runs them): SSD_CPU_STEPS and
# OCR_CPU_STEPS steps at batch SSD_CPU_BATCH and OCR_CPU_BATCH, each
# program in CPU_DTYPE, losses within N_CPU_LOSS_RTOL, every state within
# N_CPU_RTOL; the matches, the mined negatives and the decoded ids equal,
# where a decision taken on the host from the card's values may differ
# only where the CPU's own margin there is within DECIDE_RTOL (a flipped
# near tie).  In float32 the two sides' summation orders flip ReLUs
# whose inputs lie within rounding of zero (15-17 of 18.4 M a step in
# the SSD), and each flip reroutes the gradient of every parameter below
# it; in float64 the inputs would have to lie within 1e-16 of zero
SSD_CPU_BATCH, SSD_CPU_STEPS, OCR_CPU_BATCH, OCR_CPU_STEPS = 2, 2, 4, 2
CPU_DTYPE = "float64"
DECIDE_RTOL = 1e-5
# the ops_working phase: hsigmoid and nce at run_rnn's 128 x 100 tokens,
# 30000 classes, width 512 (nce with 10 negatives); roi_pool at Fast
# R-CNN's shape (Girshick 2015: 2 images, 128 ROIs each, VGG-16's conv5 of
# 512 x 38 x 50 for a 600 x 800 image, 7 x 7 bins, spatial scale 1/16)
W_ROWS, W_WIDTH, W_CLASSES, W_NEG = 12800, 512, 30000, 10
W_ROI_X, W_ROIS = (2, 512, 38, 50), 128
P2_TWIN = {"resnet_cifar10": None, "resnet_cifar10_fp32": "float64"}
# dp2_one_card's steps a program (at least P_HELD)
P2_STEPS = 3

# the persist phase: run_seq2seq's translator (S_ constants, bf16 amp,
# Adam) through the port's Trainer for PS_ITERS iterations, a snapshot
# every PS_EVERY, killed at iteration PS_KILL and resumed; then
# image_serve's ResNet-50 saved and served from disk
PS_ITERS, PS_EVERY, PS_KILL = 4, 2, 3
# the conv_rest phase: A3's ten ops at published shapes, forward and
# gradient on the card, against the CPU at batch CR_CPU_BATCH.  C3D's
# conv1 and pool (Tran et al. 2015; the 2x2x2 / 2 pool of its later
# stages); 3D U-Net's 2x2x2 stride-2 up-convolution (Cicek et al.
# 2016); SegNet's first encoder pool (Badrinarayanan et al. 2017; and
# an overlapping 3x3 / 2 case); SPP-net's conv5 pyramid (He et al.
# 2014); DeepSpeech2's row convolution width (Amodei et al. 2016) with
# a 20-frame lookahead over a ragged LoD; NTM's shift weighting (Graves
# et al. 2014)
CR_C3D, CR_C3D_OUT = (8, 3, 16, 112, 112), 64
CR_UNET, CR_UNET_OUT = (2, 256, 16, 16, 16), 128
CR_SEGNET = (4, 64, 360, 480)
CR_SPP, CR_SPP_HEIGHT = (64, 256, 13, 13), 3
CR_ROW_BATCH, CR_ROW_LEN, CR_ROW_D, CR_ROW_FUTURE = 32, 500, 1760, 20
CR_SHIFT, CR_SHIFT_M = (128, 128), 3
CR_CPU_BATCH = 1
# DCGAN (Radford et al. 2016, sections 3-4): z 100 -> 4x4x1024 -> ... ->
# 64x64x3 through conv2d_transpose, the mirror through conv2d; batch
# norm but at G's output and D's input; ReLU / tanh in G, LeakyReLU 0.2
# in D; Adam 2e-4, beta1 0.5; batch 128; weights N(0, 0.02).  Cut: 4x4
# kernels at stride 2, pad 1 (the JAX conv2d_transpose has no
# output_padding, so the paper's 5x5 cannot map 4 -> 8)
DC_Z, DC_IMG, DC_BATCH = 100, 64, 128
DC_G_WIDTHS, DC_D_WIDTHS = (1024, 512, 256, 128), (128, 256, 512, 1024)
DC_LR, DC_BETA1, DC_STD, DC_SLOPE, DC_ITERS = 2e-4, 0.5, 0.02, 0.2, 4
DC_CPU_BATCH, DC_CPU_ITERS = 8, 2
# the aot_native phase: image_serve's ResNet-50 exported at AOT_BATCH
# and held to the Executor within SRV_ULPS; the train phase's LM forward
# (T_ constants, amp) and the moe phase's MoE LM forward (M_ constants)
# exported and reloaded, the LM's artifact loaded on the CPU at
# AOT_CPU_LAYERS decoder layers (full width) and held to the card's
# within SRV_ULPS; native_pipeline feeding NP_STEPS ResNet-50 training
# steps at NP_BATCH; AOT_REPS timed calls (median); AOT_HOST_CALLS
# calls a reading of the flash op's host time against the direct call
AOT_BATCH, AOT_CPU_LAYERS, AOT_REPS, AOT_HOST_CALLS = 16, 1, 3, 10
# the artifacts' depth: the LM's and the MoE LM's decoder layers at their
# full widths (an export's and a load's seconds go with the parameters
# written and read)
AOT_LM_LAYERS, AOT_MOE_LAYERS = 2, 2
NP_BATCH, NP_STEPS = 32, 4


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


# every phase line's `seconds`: the wall time since the previous phase
# line (the first: since the clock started), less the time set aside for
# a line of its own (`_aside`); a line that measures its own keeps it,
# and PHASE_SECONDS (the closing `timing` line) has the wall time of each
_CLOCK = {"last": time.perf_counter(), "aside": 0.0}
PHASE_SECONDS = []      # [(phase, part, seconds)] in the order emitted
# what the analysis phase reads of earlier phases: the replayed step's
# median ms of the train (amp), seq2seq and resnet50 phases, and the
# serve phase's spec and its decoder's paged-attention label
STEP_MS = {}
SERVE = {}


def _aside(seconds):
    """Take `seconds` out of the next phase line's time: they are a later
    line's own (the tools phase's profiler part runs inside train)."""
    _CLOCK["aside"] += seconds


def emit(obj, aside=False):
    """Print `obj` as a JSON line; a phase line gets its seconds.  With
    `aside` its own `seconds` were set aside from an earlier line's
    (`_aside`), and PHASE_SECONDS counts them."""
    if "phase" in obj:
        now = time.perf_counter()
        wall = now - _CLOCK["last"] - _CLOCK["aside"]
        obj.setdefault("seconds", wall)
        _CLOCK["last"], _CLOCK["aside"] = now, 0.0
        PHASE_SECONDS.append([obj["phase"], obj.get("part"),
                              obj["seconds"] if aside else wall])
    print(json.dumps(obj), flush=True)


def card_peaks(name):
    """-> (bytes/s, {torch.float32: scalar fp32, torch.bfloat16: bf16
    tensor, "tf32": TF32 tensor FLOP/s}) of the card: its row of the
    port's chip table (bandwidth, bf16) and of _CARD_PEAKS."""
    from paddle_tpu_torch.analysis.cost_model import (DEVICE_SPECS,
                                                      device_for_card)

    try:
        key = device_for_card(name)
    except KeyError:
        raise CheckFailed(f"no published peaks for card {name!r}")
    bf16, bw = DEVICE_SPECS[key]
    fp32, tf32 = _CARD_PEAKS[key]
    return bw, {torch.float32: fp32, torch.bfloat16: bf16, "tf32": tf32}


def _ptxas_summary(log):
    """nvcc -Xptxas=-v output -> one line per kernel: its name (the
    flash kernels as name<dtype,D>), registers, and stack and spills."""
    import re

    out, name, frame = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            short = re.search(
                r"([a-z_]+_kernel)I(f|13__nv_bfloat16|a)Li(\d+)E", name)
            if short:
                dt = {"f": "f32", "a": "i8"}.get(short.group(2), "bf16")
                name = f"{short.group(1)}<{dt},{short.group(3)}>"
            else:
                name = name[:80]
        elif "spill" in ln:
            frame = ln.strip()
        elif "registers" in ln:
            used = ln.split(":", 1)[-1].strip()
            out.append(f"{name}: {used}; {frame}")
    return out


def cold_ms(fn, n, flush):
    """Median device time of `fn` in ms over `n` calls, each after the
    L2 cache was overwritten (the serving step finds K/V cold: a tick
    streams 50+ MB of weights between two layers' attention)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def device_ms(fn, n, flush, match):
    """-> (median device time in ms of the kernels whose name contains
    `match`, how many there were, their launch grids) over `n` cold-L2
    calls of `fn` under torch.profiler: the kernel's own duration on the
    card, with no launch gap and no host time in it, and the grid as
    the profiler recorded the launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the profiler may miss kernels of a window (a few of the first; once,
    # in the moe_kernel phase, 17 of 30): up to three windows
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and match in e.get("name", "")]
        if len(kernels) >= n // 2:
            break
    check(len(kernels) >= n // 2, f"device_ms: the profile shows "
          f"{len(kernels)} {match!r} kernels for {n} calls")
    grids = sorted({tuple(e["args"]["grid"]) for e in kernels
                    if "grid" in e.get("args", {})})
    check(grids, f"device_ms: the profile records no grid for {match!r}")
    return (float(np.median([e["dur"] for e in kernels])) / 1e3,
            len(kernels), [list(g) for g in grids])


def _reset_peak():
    """Start a phase's peak-memory reading: tensors that an earlier phase
    left in reference cycles are collected first, so the peak counts
    what this phase holds, not what the collector had not reached yet."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def host_us(fn, n):
    """Host time of one call of `fn` in microseconds: `n` calls back to
    back with no synchronisation between them (the card finishes each
    faster than the host issues the next, so the clock reads the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


# -- kernels phase -----------------------------------------------------------

def _kernel_inputs(kv_dtype, w_n, dev, gen):
    s_n, ctx = SLOTS, BLOCK * MAX_BLOCKS
    nb_pool = KV_BLOCKS + 1
    # cursors spread over the whole context, the last one at its end
    positions = torch.tensor(
        [round(s * (ctx - w_n) / (s_n - 1)) for s in range(s_n)],
        dtype=torch.int32)
    tables = torch.zeros((s_n, MAX_BLOCKS), dtype=torch.int32)
    perm = torch.randperm(nb_pool - 1, generator=gen) + 1
    used = 0
    for s in range(s_n):
        n = -(-(int(positions[s]) + w_n) // BLOCK)
        tables[s, :n] = perm[used:used + n]
        used += n
    shape = (N_LAYERS, nb_pool, BLOCK, D_MODEL)
    pools = []
    for _ in range(2):
        if kv_dtype == "int8":
            pay = torch.randint(-127, 128, shape, generator=gen,
                                dtype=torch.int8)
            sc = torch.rand((N_LAYERS, nb_pool), generator=gen) * 0.05 + 1e-3
            pools.append((pay.to(dev), sc.to(dev)))
        else:
            t = torch.randn(shape, generator=gen)
            if kv_dtype == "bf16":
                t = t.bfloat16()
            pools.append(t.to(dev))
    q = torch.randn((s_n, w_n, D_MODEL), generator=gen).to(dev)
    return q, pools[0], pools[1], tables.to(dev), positions.to(dev)


def _library_attention(q, pool_k, pool_v, tables, positions, layer):
    """gather + dequantize + F.scaled_dot_product_attention with a mask:
    the yardstick a PyTorch user would write.  Timed only; the port
    never calls it."""
    from paddle_tpu_torch.kernels.paged_attention import _gather

    s_n, w_n, d = q.shape
    dh = d // N_HEADS
    k = _gather(pool_k, layer, tables).reshape(s_n, -1, N_HEADS, dh)
    v = _gather(pool_v, layer, tables).reshape(s_n, -1, N_HEADS, dh)
    ctx = k.shape[1]
    pos_w = positions.long()[:, None] + torch.arange(w_n, device=q.device)
    mask = torch.arange(ctx, device=q.device)[None, None, :] <= pos_w[:, :,
                                                                      None]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.reshape(s_n, w_n, N_HEADS, dh).transpose(1, 2),
        k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask[:, None])
    return out.transpose(1, 2).reshape(s_n, w_n, d)


def _bound(kv_dtype, q, positions, w_n, bw, flops):
    """Least time for the work these inputs need: each needed K/V row
    (positions <= pos + W - 1) read once, q/tables/positions read and
    the context written once; 4 fp32 operations per K/V element per
    window row (q.k and p.v multiply-adds)."""
    ctx = BLOCK * MAX_BLOCKS
    n_ctx = [min(int(p) + w_n, ctx) for p in positions.tolist()]
    elem = {"fp32": 4, "bf16": 2, "int8": 1}[kv_dtype]
    kv = 2 * sum(n_ctx) * D_MODEL * elem
    if kv_dtype == "int8":
        kv += 2 * 4 * sum(-(-n // BLOCK) for n in n_ctx)
    io = 2 * q.numel() * 4 + sum(-(-n // BLOCK) for n in n_ctx) * 4 \
        + positions.numel() * 4
    ops = 4 * w_n * sum(n_ctx) * D_MODEL
    t_bytes, t_ops = (kv + io) / bw * 1e3, ops / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), kv + io


def kernels_phase(dev, bw, flops):
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention, paged_attention_reference)

    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    layer = N_LAYERS // 2
    cases = {}
    for kv_dtype in KV_DTYPES:
        for w_n in (1, 4):
            q, pk, pv, tables, positions = _kernel_inputs(kv_dtype, w_n,
                                                          dev, gen)
            args = (q, pk, pv, tables, positions, layer)
            out = paged_attention(*args, n_heads=N_HEADS)
            ref = paged_attention_reference(*args, n_heads=N_HEADS)
            lib = _library_attention(*args)
            torch.cuda.synchronize()
            check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                  f"paged_attention {kv_dtype} W={w_n}: bad output")
            err = float((out - ref).abs().max())
            tol = 1e-5 * max(1.0, float(ref.abs().max()))
            lib_err = float((lib - ref).abs().max())
            check(err <= tol, f"paged_attention {kv_dtype} W={w_n}: "
                  f"max_abs_err {err} > {tol}")
            bound, bound_by, nbytes = _bound(kv_dtype, q, positions, w_n,
                                             bw, flops)
            again = paged_attention(*args, n_heads=N_HEADS)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"paged_attention {kv_dtype} "
                  f"W={w_n}: two calls differ")
            run = lambda: paged_attention(*args, n_heads=N_HEADS)  # noqa
            ms = cold_ms(run, 200, flush)
            dev_ms, n_kernels, grids = device_ms(run, 200, flush, "paged_")
            check(len(grids) == 1, f"paged_attention {kv_dtype} W={w_n}: "
                  f"launch grids {grids}")
            plain_ms = cold_ms(
                lambda: paged_attention_reference(*args, n_heads=N_HEADS),
                50, flush)
            library_ms = cold_ms(lambda: _library_attention(*args), 50, flush)
            cases[f"{kv_dtype}_w{w_n}"] = {
                "max_abs_err": err, "tol": tol, "library_max_abs_err": lib_err,
                "ms": ms, "device_ms": dev_ms,
                "device_kernels_profiled": n_kernels,
                # the grid is (splits, heads, slots)
                "grid": grids[0], "splits": grids[0][0],
                "ctas": int(np.prod(grids[0])),
                "host_us": host_us(run, 200),
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
                "bytes_per_s": nbytes / (dev_ms * 1e-3)}
    emit({"phase": "kernels", "kernel": "paged_attention_decode",
          "slots": SLOTS, "context": BLOCK * MAX_BLOCKS, "d_model": D_MODEL,
          "n_heads": N_HEADS, "layer": layer,
          "timing": "ms: median of cold-L2 calls between CUDA events; "
                    "device_ms: median duration of the kernel itself in "
                    "torch.profiler over the same cold-L2 calls, and grid "
                    "its launch grid there; host_us: host time per call "
                    "of paged_attention; bytes_per_s over device_ms",
          "cases": cases})
    return cases


# -- flash phase -------------------------------------------------------------

def _flash_work(kind, b, sq, sk, h, d, causal, elem):
    """(FLOPs, bytes) the kernel must do on these shapes: 2 per
    multiply-add, only the (query, key) pairs causal masking keeps; each
    input read once, each output written once."""
    pairs = b * h * (sum(min(i + 1, sk) for i in range(sq)) if causal
                     else sq * sk)
    qo = b * sq * h * d * elem
    kv = b * sk * h * d * elem
    vec = b * h * sq * 4
    if kind == "fwd":      # S = QK^T, O = PV; q,k,v in, o and lse out
        return 4 * d * pairs, 2 * qo + 2 * kv + vec
    if kind == "dq":       # S, dP = dO V^T, dQ = dS K
        return 6 * d * pairs, 3 * qo + 2 * kv + 2 * vec
    # S, dP, dV = P^T dO, dK = dS^T Q; q, do, k, v, lse, delta in
    return 8 * d * pairs, 2 * qo + 4 * kv + 2 * vec


def _sdpa(q, k, v, causal):
    """torch's fused attention on [b, s, h, d] views — the library
    yardstick.  Timed only; the port never calls it."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal)
    return out.transpose(1, 2)


def _close_bf16(got, want):
    """(ok, limits) for a bfloat16 result against its plain version, both
    rounded from float32: the largest error at most one bf16 ulp of
    max|plain| (a rounding flip where float32 sums differ), the error's
    RMS at most 2^-9 of the plain values' RMS."""
    top = float(want.abs().max())
    lim = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
    rms_lim = 2.0 ** -9 * float(want.pow(2).mean().sqrt())
    err = (got - want).abs()
    rms = float(err.pow(2).mean().sqrt())
    return float(err.max()) <= lim and rms <= rms_lim, lim, rms, rms_lim


# the flash phase's cases: (name, dtype, causal, [b, s, h, d]); the LM's
# training shape, the seq2seq model's (its encoder self-attention and
# cross-attention non-causal, its decoder self-attention causal), and
# the generate phase's float32 forwards (the LM's, the translator's)
FLASH_CASES = (("fp32_causal", torch.float32, True, FLASH_SHAPE),
               ("bf16_causal", torch.bfloat16, True, FLASH_SHAPE),
               ("fp32_full", torch.float32, False, FLASH_SHAPE),
               ("bf16_full", torch.bfloat16, False, FLASH_SHAPE),
               ("s2s_bf16_causal", torch.bfloat16, True, S2S_FLASH_SHAPE),
               ("s2s_bf16_full", torch.bfloat16, False, S2S_FLASH_SHAPE),
               ("gen_fp32_causal", torch.float32, True, GEN_FLASH_SHAPE),
               ("gen_s2s_fp32_full", torch.float32, False, S2S_FLASH_SHAPE))


def flash_phase(dev, bw, peaks):
    from paddle_tpu_torch.kernels import flash_attention as fa

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    cases = {}
    for name, dtype, causal, shape in FLASH_CASES:
        b, s, h, d = shape
        gen = torch.Generator().manual_seed(SEED)
        q, k, v, do = (torch.randn(shape, generator=gen).to(dev, dtype)
                       for _ in range(4))
        fp32 = dtype == torch.float32
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, causal)
        delta = fa.attention_delta(o_ref, do)
        bwd = (q, k, v, do, lse_ref, delta, causal)
        dq = fa.flash_attention_dq(*bwd)
        dk, dv = fa.flash_attention_dkv(*bwd)
        dq_ref = fa.flash_attention_dq_reference(*bwd)
        dk_ref, dv_ref = fa.flash_attention_dkv_reference(*bwd)
        lib_o = _sdpa(q, k, v, causal)
        torch.cuda.synchronize()
        errs, rms_errs = {}, {}
        for key, got, want, tol in (
                ("fwd", o, o_ref, 2e-5), ("lse", lse, lse_ref, 2e-5),
                ("dq", dq, dq_ref, 2e-4), ("dk", dk, dk_ref, 2e-4),
                ("dv", dv, dv_ref, 2e-4)):
            bf16 = got.dtype == torch.bfloat16
            got, want = got.float(), want.float()
            check(bool(torch.isfinite(got).all()), f"flash {name} {key}: "
                  "non-finite output")
            err = float((got - want).abs().max())
            rms_errs[key] = float((got - want).pow(2).mean().sqrt())
            if bf16:
                ok, lim, rms, rms_lim = _close_bf16(got, want)
                check(ok, f"flash {name} {key}: max_abs_err {err} > {lim} "
                      f"or RMS error {rms} > {rms_lim}")
            else:
                lim = tol * max(1.0, float(want.abs().max()))
                check(err <= lim,
                      f"flash {name} {key}: max_abs_err {err} > {lim}")
            errs[key] = err
        lib_err = float((lib_o.float() - o_ref.float()).abs().max())

        # library yardstick: SDPA forward, and its backward alone (one
        # autograd call computing dQ, dK and dV together)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = _sdpa(*leaves, causal)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, leaves, do, retain_graph=True)
        elem = 4 if fp32 else 2
        # float32-accurate products on the tensor cores take three TF32
        # products each (3xTF32: the backward kernels, and SDPA's float32
        # path); the scalar float32 peak stays beside it for PRs 2-3
        flops = peaks["tf32"] / 3 if fp32 else peaks[dtype]
        res = {"shape_bshd": list(shape), "causal": causal,
               "max_abs_err": errs, "rms_err": rms_errs,
               "sdpa_fwd_max_abs_err": lib_err, "peak_flops": flops,
               "sdpa_fwd_ms": cold_ms(lambda: _sdpa(q, k, v, causal), 20,
                                      flush),
               "sdpa_bwd_ms": cold_ms(lib_bwd, 20, flush)}
        res["sdpa_fwd_bwd_ms"] = res["sdpa_fwd_ms"] + res["sdpa_bwd_ms"]
        if fp32:
            res["peak_flops_fp32_scalar"] = peaks[torch.float32]
        for kind, run, plain in (
                ("fwd", lambda: fa.flash_attention_fwd(q, k, v, causal),
                 lambda: fa.flash_attention_fwd_reference(q, k, v, causal)),
                ("dq", lambda: fa.flash_attention_dq(*bwd),
                 lambda: fa.flash_attention_dq_reference(*bwd)),
                ("dkv", lambda: fa.flash_attention_dkv(*bwd),
                 lambda: fa.flash_attention_dkv_reference(*bwd))):
            n_ops, n_bytes = _flash_work(kind, b, s, s, h, d, causal, elem)
            t_ops, t_bytes = n_ops / flops * 1e3, n_bytes / bw * 1e3
            ms = cold_ms(run, 20, flush)
            bound = max(t_ops, t_bytes)
            res[kind] = {"ms": ms, "plain_ms": cold_ms(plain, 10, flush),
                         "bound_ms": bound,
                         "bound_by": ("operations" if t_ops >= t_bytes
                                      else "bytes"),
                         "bound_share": bound / ms,
                         "flop": n_ops, "bytes": n_bytes,
                         "flop_per_s": n_ops / (ms * 1e-3)}
            if fp32:
                res[kind]["bound_ms_fp32_scalar"] = max(
                    n_ops / peaks[torch.float32] * 1e3, t_bytes)
            check(res[kind]["bound_share"] <= 1.0,
                  f"flash {name} {kind}: {ms} ms beats its bound {bound} ms")
        res["fwd_over_sdpa_fwd"] = res["fwd"]["ms"] / res["sdpa_fwd_ms"]
        res["bwd_ms"] = res["dq"]["ms"] + res["dkv"]["ms"]
        res["bwd_over_sdpa_bwd"] = res["bwd_ms"] / res["sdpa_bwd_ms"]
        del leaves, lib_out
        cases[name] = res
    emit({"phase": "flash",
          "timing": "median of cold-L2 calls, CUDA events; the backward "
                    "kernels take the plain forward's lse and delta; "
                    "fwd against sdpa_fwd_ms, and bwd_ms = dq + dkv "
                    "against sdpa_bwd_ms (one call computing dQ, dK and "
                    "dV), in every case; bounds over "
                    "peak_flops: bf16 on the tensor cores for bf16, TF32/3 "
                    "(3xTF32) for float32, with bound_ms_fp32_scalar over "
                    "the scalar float32 peak beside it",
          "cases": cases})
    return cases


# -- grads phase -------------------------------------------------------------

def _close_ulp(got, want):
    """Each element within one bf16 ulp of the larger of the two values:
    two bf16 products whose float32 sums rounded to neighbouring bf16
    values."""
    a, b = got.float(), want.float()
    top = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top)) - 7),
                      torch.zeros_like(top))
    return bool(((a - b).abs() <= ulp).all())


def grads_phase(dev):
    """The explicit gradient lowerings (`registry.register_grad_lower`)
    against the generic gradient (torch autograd over the forward
    lowering, the route every other op takes) on the train shapes: the
    flash_attention grad op from the forward op's Out (and the lse it
    carries) — bit-equal to the generic route, whose forward recompute
    is the same deterministic kernel, with no forward launch; an Out
    without an lse re-runs the forward kernel.  The mul grad op against
    autograd's matmul backward: bit-equal, or else within 1e-5 of the
    largest element in float32 and one bf16 ulp under amp."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core.execution import (ExecContext,
                                                 generic_grad_lower)
    from paddle_tpu_torch.core.registry import get_op_info
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    ctx = ExecContext(dev)
    gen = torch.Generator().manual_seed(SEED)
    launches = flash_attention.launches
    info = get_op_info("flash_attention")
    attrs = {**info.attrs, "causal": True}
    flash = {}
    for name, dtype in (("bf16_causal", torch.bfloat16),
                        ("fp32_causal", torch.float32)):
        q, k, v, do = (torch.randn(FLASH_SHAPE, generator=gen).to(dev, dtype)
                       for _ in range(4))
        o = info.lower(ctx, {"Q": [q], "K": [k], "V": [v]}, attrs)["Out"]
        ins = {"Q": [q], "K": [k], "V": [v], "Out": [o], "Out@GRAD": [do]}
        routes = {
            "explicit": lambda: info.grad_lower(ctx, ins, attrs),
            "generic": lambda: generic_grad_lower(ctx, ins, attrs, info),
            "explicit_no_lse": lambda: info.grad_lower(
                ctx, dict(ins, Out=[o.clone()]), attrs)}
        grads, counted = {}, {}
        for route, fn in routes.items():
            before = dict(launches)
            grads[route] = fn()
            torch.cuda.synchronize()
            counted[route] = {kk: launches[kk] - before[kk] for kk in launches}
        for route, fwd in (("explicit", 0), ("generic", 1),
                           ("explicit_no_lse", 1)):
            check(counted[route] == {"fwd": fwd, "dq": 1, "dkv": 1},
                  f"grads flash {name} {route}: launches {counted[route]}")
        for route in ("generic", "explicit_no_lse"):
            for slot, g in grads["explicit"].items():
                check(g[0].dtype == dtype
                      and torch.equal(g[0], grads[route][slot][0]),
                      f"grads flash {name}: explicit {slot} is not the "
                      f"{route} route's bit for bit")
        del grads
        flash[name] = {
            "bit_equal_to_generic": True, "launches": counted,
            "explicit_ms": cold_ms(routes["explicit"], 10, flush),
            "generic_ms": cold_ms(routes["generic"], 10, flush)}
        del q, k, v, do, o, ins, routes

    minfo = get_op_info("mul")
    mattrs = {"x_num_col_dims": 2, "y_num_col_dims": 1}
    mul = {}
    for name, n_out, use_amp in (("proj_fp32", T_D, False),
                                 ("proj_amp", T_D, True),
                                 ("head_amp", T_VOCAB, True)):
        x = torch.randn((T_BATCH, T_SEQ, T_D), generator=gen).to(dev)
        w = (torch.randn((T_D, n_out), generator=gen) * 0.02).to(dev)
        if use_amp:
            amp.enable_bf16()
        try:
            y = minfo.lower(ctx, {"X": [x], "Y": [w]}, mattrs)["Out"]
            dy = torch.randn(tuple(y.shape), generator=gen).to(dev, y.dtype)
            ins = {"X": [x], "Y": [w], "Out": [y], "Out@GRAD": [dy]}
            explicit = minfo.grad_lower(ctx, ins, mattrs)
            generic = generic_grad_lower(ctx, ins, mattrs, minfo)
            torch.cuda.synchronize()
            res = {"out_dtype": str(y.dtype), "bit_equal": {},
                   "max_abs_err": {}}
            for slot, want_dt in (("X@GRAD", x.dtype), ("Y@GRAD", w.dtype)):
                got, want = explicit[slot][0], generic[slot][0]
                check(got.dtype == want.dtype == want_dt,
                      f"grads mul {name} {slot}: {got.dtype} / {want.dtype}")
                res["bit_equal"][slot] = bool(torch.equal(got, want))
                res["max_abs_err"][slot] = float((got - want).abs().max())
                if use_amp:
                    ok = _close_ulp(got, want)
                else:
                    err, lim = _tol_err(got, want, 1e-5)
                    ok = err <= lim
                check(ok, f"grads mul {name} {slot}: explicit and generic "
                      f"differ by {res['max_abs_err'][slot]}")
            del explicit, generic
            res["explicit_ms"] = cold_ms(
                lambda: minfo.grad_lower(ctx, ins, mattrs), 10, flush)
            res["generic_ms"] = cold_ms(
                lambda: generic_grad_lower(ctx, ins, mattrs, minfo), 10,
                flush)
        finally:
            if use_amp:
                amp.disable_bf16()
        mul[name] = dict(res, shape_x=[T_BATCH, T_SEQ, T_D],
                         shape_y=[T_D, n_out])
        del x, w, y, dy, ins
    emit({"phase": "grads", "flash": flash, "mul": mul,
          "timing": "median of cold-L2 calls, CUDA events, of the grad "
                    "op's explicit lowering and of the generic gradient "
                    "(forward recompute + autograd) on the same inputs"})
    return flash, mul


# -- train phase -------------------------------------------------------------

def _param_count(vocab, d_model, n_layers, seq):
    """benchmark/run_ridge.py's analytic count for the 6*N*P convention:
    12*d^2 per block plus token, position and output tables."""
    return (n_layers * 12 * d_model * d_model + 2 * vocab * d_model
            + max(seq, 2048) * d_model)


def _train_feed(step):
    """The periodic next-token data of examples/transformer_lm.py."""
    base = np.arange(T_BATCH * T_SEQ).reshape(T_BATCH, T_SEQ) % 97
    return {"ids": ((base + step) % 97).astype(np.int64),
            "lbl": ((base + step + 1) % 97).astype(np.int64)[..., None]}


def _timed_steps(run_step, counts, steps=T_STEPS):
    """`steps` steps of `run_step(step)` (-> the loss) -> (losses, step
    seconds, per step {name: how much counts[name]() grew})."""
    losses, secs, per_step = [], [], []
    for step in range(steps):
        before = {k: f() for k, f in counts.items()}
        t0 = time.perf_counter()
        out = run_step(step)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(out.reshape(-1)[0]))
        per_step.append({k: f() - before[k] for k, f in counts.items()})
    return losses, secs, per_step


def _lm_program(optimizer, dropout_rate=0.0, remat=False,
                n_layers=T_LAYERS, pipeline_stages=None):
    """The run_ridge transformer LM's training Program -> (main, startup,
    loss); with `dropout_rate` its dropouts, the attention weights'
    included (the composed attention path); with `remat` each decoder
    block a recompute segment (run_ridge's builder reads the `remat`
    flag); `n_layers` cuts its depth; `pipeline_stages` tags the blocks
    with their pipeline stage."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models.transformer import transformer_lm

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    set_flags({"remat": remat})
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[T_SEQ], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[T_SEQ, 1], dtype="int64")
        logits = transformer_lm(ids, T_VOCAB, d_model=T_D, n_heads=T_HEADS,
                                n_layers=n_layers, max_len=max(T_SEQ, 2048),
                                dropout_rate=dropout_rate,
                                return_logits=True,
                                pipeline_stages=pipeline_stages)
        cost = fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, T_VOCAB]),
            fluid.layers.reshape(lbl, shape=[-1, 1]))
        loss = fluid.layers.mean(cost)
        optimizer.minimize(loss)
    set_flags({"remat": False})
    return main, startup, loss


_GEMM_NAMES = ("gemm", "cublas", "cutlass", "nvjet", "xmma")


_CONV_GROUPS = (("wgrad", "conv_wgrad"), ("dgrad", "conv_dgrad"),
                ("fprop", "conv_fwd"), ("convolve", "conv_fwd"))


def _kernel_group(name):
    """Device-time group of a kernel by its name.  cuBLAS names its
    Hopper bf16 GEMMs `nvjet_*` or `sm90_xmma_*` beside the
    `*gemm*`/`cutlass` names of its float32 ones; cuDNN names its
    convolutions' implicit GEMMs by pass (`fprop`, `dgrad`, `wgrad`) and
    its layout changes `nchwToNhwc`/`nhwcToNchw`.  `sort_segment` is the
    ordered accumulation of embedding gradients (`sorted_segment_sum`:
    cub's radix sort and segment_reduce)."""
    low = name.lower()
    for pat, group in _CONV_GROUPS:
        if pat in low:
            return group
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout"
    if "pool" in low:
        return "pooling"
    if any(k in low for k in _GEMM_NAMES):
        return "matmul"
    if any(k in name for k in ("fwd_kernel<", "dq_kernel<", "dkv_kernel<")):
        return "flash_attention"
    if "route_kernel<" in name or "place_kernel(" in name:
        return "moe_dispatch"
    if "route_backward_kernel<" in name:
        return "moe_backward"
    if "fused_sgd_kernel" in name:
        return "fused_update"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "radix" in low or "segment_reduce" in low:
        return "sort_segment"
    return "other"


_GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def _gemm_split(prof, dim):
    """Device time of the profiled GEMM calls (aten mm/bmm/addmm/baddbmm,
    by input shape) with an operand dimension `dim` and of the others:
    at dim = E * C, the dense [T, E, C] dispatch and combine products
    and their VJPs."""
    from torch.autograd import DeviceType

    out = {"dim": dim, "with_dim_ms": 0.0, "with_dim_calls": 0,
           "other_ms": 0.0, "other_calls": 0, "shapes_with_dim": []}
    for ev in prof.key_averages(group_by_input_shape=True):
        if ev.device_type != DeviceType.CPU or ev.key not in _GEMM_OPS:
            continue
        shapes = [list(sh) for sh in (ev.input_shapes or []) if sh]
        key = "with_dim" if any(dim in sh for sh in shapes) else "other"
        out[f"{key}_ms"] += ev.self_device_time_total / 1e3
        out[f"{key}_calls"] += ev.count
        if key == "with_dim":
            out["shapes_with_dim"].append([ev.key, shapes])
    return out


_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def _profile_step(run_step, need, phase, gemm_dim=None, kinds=None):
    """`run_step()` (one more step) under torch.profiler -> device time
    by kernel group and the top kernels (self device time, ms), how many
    kernels ran (and of each kind in `kinds`, {kind: a substring of the
    kernel's name}), the device-to-device copies, the host's
    synchronisations (CUDA runtime calls that wait for the card), the
    step's span between CUDA events around it, and with `gemm_dim` the
    GEMMs split by that operand dimension (_gemm_split); every group in
    `need` must show."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=gemm_dim is not None) as prof:
        start.record()
        run_step()
        end.record()
        torch.cuda.synchronize()
    kernels, counts, syncs = {}, {}, {}
    # device-side events only: host ops would count twice
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            kernels[ev.key] = ev.self_device_time_total / 1e3
            counts[ev.key] = ev.count
        elif ev.key in _SYNC_CALLS:
            syncs[ev.key] = ev.count
    groups = {}
    for name, ms in kernels.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    for g in need:
        check(groups.get(g, 0.0) > 0,
              f"{phase}: the profile shows no {g} kernel: {groups}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    by_group_top = {}
    for n, ms in top:
        g = by_group_top.setdefault(_kernel_group(n), [])
        if len(g) < 3:
            g.append([n[:120], ms, counts[n]])
    dtod = [n for n in kernels if n.startswith("Memcpy DtoD")]
    out = {"device_ms": sum(kernels.values()), "by_group_ms": groups,
           "top_kernels_ms": [[n[:120], ms] for n, ms in top[:10]],
           "by_group_top_kernels": by_group_top,
           "kernels": sum(counts.values()),
           "kind_counts": {k: sum(c for n, c in counts.items() if pat in n)
                           for k, pat in (kinds or {}).items()},
           "memcpy_dtod_ms": sum(kernels[n] for n in dtod),
           "memcpy_dtod_count": sum(counts[n] for n in dtod),
           "host_syncs": syncs, "event_ms": start.elapsed_time(end)}
    if gemm_dim is not None:
        out["gemm_split"] = _gemm_split(prof, gemm_dim)
    return out


def _default_mode_path(exe, run, counts, want, kinds, need, phase,
                       snapshot, segments=1, gate_kinds=True):
    """The main path in the Executor's default mode: G_STEPS timed steps
    (the miss runs the block eagerly, the first hit captures it into a
    CUDA graph and replays it, every later hit replays) and a profiled
    replay.  Holds the cache (one miss, then hits, no recompile after
    warm-up), the graphs (one capture, then replays), the wrappers'
    counts (`want` a step on the eager run and on the capture, none on a
    replay) and the kernels the profiler saw the replay run (`want`
    again, by `kinds`).  A segmented block's `segments` device segments
    are each a cache entry and a graph of their own.  -> (losses, step
    seconds, per-step counts, `snapshot()` after the timed steps, the
    profile, a record for the phase's line)."""
    s0, g0 = exe.cache_stats(), exe.graph_stats()
    losses, secs, per_step = _timed_steps(run, counts, G_STEPS)
    state = snapshot()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    zero = {k: 0 for k in want}
    check(per_step[:2] == [want, want] and all(st == zero
                                               for st in per_step[2:]),
          f"{phase}: wrapper launches per step {per_step}: want {want} on "
          "the eager run and the capture, none on a replay")
    # the profiled step is a replay; the profiler may drop records of a
    # window (see device_ms): up to three windows.  With `gate_kinds`
    # False the replay's kernel counts are read, not held (the remat
    # phase, late in a run: there the profiler dropped one flash forward
    # of the LM's replay in every window, in whole runs; the phase holds
    # the captured graph's kernel nodes instead, `_GraphCensus`).  Its
    # peak memory is a replay's alone
    gate = bool(kinds) and gate_kinds
    torch.cuda.reset_peak_memory_stats()
    for windows in range(1, 4):
        before = {k: f() for k, f in counts.items()}
        profile = _profile_step(lambda: run(G_STEPS), need, phase,
                                kinds=kinds)
        check({k: f() - before[k] for k, f in counts.items()} == zero,
              f"{phase}: a wrapper ran during the profiled replay")
        if not gate or profile["kind_counts"] == want:
            break
    check(not gate or profile["kind_counts"] == want, f"{phase}: the "
          f"profiled replay ran kernels {profile['kind_counts']}, want "
          f"{want}")
    replay_peak = torch.cuda.max_memory_allocated()
    s1, g1 = exe.cache_stats(), exe.graph_stats()
    stats = {k: s1[k] - s0[k] for k in ("hits", "misses", "entries",
                                        "recompiles_after_warmup")}
    graphs = {k: g1[k] - g0[k] for k in ("captures", "replays")}
    n = segments
    check(stats == {"hits": n * (G_STEPS - 1 + windows), "misses": n,
                    "entries": n, "recompiles_after_warmup": 0}
          and graphs == {"captures": n,
                         "replays": n * (G_STEPS - 2 + windows)},
          f"{phase}: the main Program's cache {stats} and graphs {graphs}: "
          f"want one miss a segment ({n}), then hits replaying one "
          "captured graph a segment")
    return losses, secs, per_step, state, profile, {
        "cache": stats, "graphs": graphs, "profile_windows": windows,
        "capture_s": g1["capture_s"] - g0["capture_s"],
        "compile_s": s1["compile_s"] - s0["compile_s"],
        "write_back_bytes": g1["write_back_bytes"],
        "peak_memory_bytes": peak, "peak_reserved_bytes": reserved,
        "replay_peak_memory_bytes": replay_peak}


class _PlainAttention:
    """The `flash_attention` op's lowering and its gradient swapped for
    the plain composition and its autograd gradient while the block runs
    (the package itself has one path on the card); `calls` counts the
    plain forward runs (the op's and the gradient's recompute),
    `grad_calls` the gradient ops."""

    def __enter__(self):
        from paddle_tpu_torch.core.registry import get_op_info

        self.info = get_op_info("flash_attention")
        self.lower, self.grad_lower = self.info.lower, self.info.grad_lower
        self.calls = self.grad_calls = 0
        self.info.lower, self.info.grad_lower = self._plain, self._plain_grad
        return self

    def __exit__(self, *exc):
        self.info.lower, self.info.grad_lower = self.lower, self.grad_lower

    def _plain(self, ctx, ins, attrs):
        from paddle_tpu_torch.core.execution import one
        from paddle_tpu_torch.kernels.flash_attention import (
            flash_attention_reference)

        self.calls += 1
        scale = None if attrs.get("default_scale", True) else attrs["scale"]
        return {"Out": flash_attention_reference(
            one(ins, "Q"), one(ins, "K"), one(ins, "V"),
            causal=bool(attrs.get("causal", False)), scale=scale)}

    def _plain_grad(self, ctx, ins, attrs):
        from paddle_tpu_torch.core.execution import generic_grad_lower

        self.grad_calls += 1
        return generic_grad_lower(ctx, ins, attrs, self.info)


class _PlainMoe:
    """The `moe_ffn` op's lowering swapped for the plain composition
    (moe_gate, the dispatch einsum, the expert FFNs, the combine einsum)
    while the block runs; `calls` counts the forward and
    recomputed-forward runs."""

    def __enter__(self):
        from paddle_tpu_torch.core.registry import get_op_info

        self.info = get_op_info("moe_ffn")
        self.lower, self.calls = self.info.lower, 0
        self.info.lower = self._plain
        return self

    def __exit__(self, *exc):
        self.info.lower = self.lower

    def _plain(self, ctx, ins, attrs):
        from paddle_tpu_torch.core.execution import one
        from paddle_tpu_torch.kernels.moe_dispatch import (
            moe_gate_dispatch_reference)
        from paddle_tpu_torch.parallel.moe import _capacity, _expert_mm

        self.calls += 1
        x, gw = one(ins, "X"), one(ins, "GateW")
        flat = x.reshape(-1, x.shape[-1])
        e_n, top_k = gw.shape[1], int(attrs["top_k"])
        c_n = _capacity(flat.shape[0], e_n, float(attrs["capacity_factor"]),
                        top_k)
        expert_in, combine, aux = moe_gate_dispatch_reference(flat, gw, e_n,
                                                              c_n, top_k)
        y = torch.einsum("ecd,tec->td", _expert_mm(
            expert_in, one(ins, "WIn"), one(ins, "WOut"), torch.relu),
            combine)
        return {"Out": y.reshape(*x.shape[:-1], y.shape[-1]),
                "AuxLoss": aux.reshape(1)}


class _PerOpChain:
    """The ParallelExecutor's fused bucket update swapped for the
    program's own per-op `sgd` chain while the block runs (the package
    has one path on the card); `calls` counts the sgd ops run."""

    def __init__(self, pe):
        self.pe = pe

    def __enter__(self):
        from paddle_tpu_torch.core.registry import get_op_info

        self.plan = self.pe._plan
        buckets, issue_after, _ = self.plan
        self.pe._plan = (buckets, issue_after, None)
        self.info = get_op_info("sgd")
        self.lower, self.calls = self.info.lower, 0
        self.info.lower = self._counted
        return self

    def __exit__(self, *exc):
        self.info.lower = self.lower
        self.pe._plan = self.plan

    def _counted(self, ctx, ins, attrs):
        self.calls += 1
        return self.lower(ctx, ins, attrs)


def _param_rel_diff(current, init, k_params):
    """{name: ||dW_kernel - dW_plain|| / ||dW_plain||} over the weight
    matrices, dW = value after the steps - initial value; `current(n)`
    is the plain path's value now."""
    out = {}
    for n, k_val in k_params.items():
        d_plain = current(n) - init[n]
        d_kern = k_val - init[n]
        out[n] = float((d_kern - d_plain).norm() / d_plain.norm())
    return out


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(abs(v))) - 7)


def _loss_check(phase, k_loss, p_loss, amp):
    """-> (per-step differences, limit, unit): the kernel path's losses
    against the plain path's, in bf16 ulps of the plain loss under amp
    and relative in float32; raises outside the limit."""
    check(all(np.isfinite(k_loss + p_loss)), f"{phase}: non-finite "
          f"losses {k_loss} / {p_loss}")
    if amp:
        diff = [abs(a - b) / _bf16_ulp(b) for a, b in zip(k_loss, p_loss)]
        lim, unit = LOSS_ULPS_BF16, "bf16 ulps of the plain loss"
    else:
        diff = [abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss)]
        lim, unit = LOSS_RTOL, "relative"
    check(max(diff) <= lim, f"{phase}: kernel/plain losses differ {diff} "
          f"({unit}; limit {lim})")
    return diff, lim, unit


def _grad_names(program):
    """The gradient var each optimizer op applies, by parameter."""
    return {op.input("Param")[0]: op.input("Grad")[0]
            for op in program.global_block().ops
            if "Param" in op.inputs and "Grad" in op.inputs}


def _bit_equal(phase, k_loss, i_loss, k_params, current):
    """The default mode's losses and parameters against the
    interpreter's from the same state and feeds: bit for bit (same
    kernels, same order, one stream); `current(n)` is the interpreter's
    value now."""
    check(k_loss == i_loss, f"{phase}: replayed losses {k_loss} differ "
          f"from the interpreter's {i_loss}")
    diff = sorted(n for n, v in k_params.items()
                  if not torch.equal(v, current(n)))
    check(not diff, f"{phase}: after the same steps {len(diff)} "
          f"parameters differ between the replay and the interpreter: "
          f"{diff[:5]}")


def _interpreter_record(i_secs, i_profile):
    step_ms = float(np.median(i_secs[1:])) * 1e3
    return {"interpreted_ms_per_step": step_ms,
            "interpreted_device_idle_share":
                1.0 - i_profile["device_ms"] / step_ms,
            "interpreted_profiled_step": i_profile,
            "interpreted_host_syncs_per_step": i_profile["host_syncs"]}


def _default_and_interpreter(phase, place, main, startup, loss, feed_of,
                             need, i_need=None, after=None, segments=1,
                             counts=None, want=None, kinds=None, init=None,
                             interpret=True, gate_kinds=True):
    """A training Program's main path without a kernel of the port:
    the startup (or the states `init`), G_STEPS steps of `feed_of(step)`
    in the Executor's default mode (one miss, one capture, replays; the
    wrappers' `counts` growing by `want` a step on the eager run and the
    capture, the profiled replay running `want` kernels by `kinds`) and
    a profiled replay (`need` its kernel groups), `after(exe)` on that
    Executor, then (with `interpret`) the same steps interpreted from
    the same state (losses and every state bit for bit the replay's) and
    a profiled interpreted step (`i_need`, else `need`).  The scope ends
    with the interpreter's state -> a record, with the starting values
    ("init"), the replay's states ("k_state"), its wrapper counts a step
    ("k_steps") and the memory the steps started from
    ("base_memory_bytes").  A segmented block has `segments` device
    segments, each its own entry and graph."""
    import paddle_tpu_torch as fluid

    persist = _persistables(main)
    scope = fluid.global_scope()
    exe = fluid.Executor(place, seed=SEED)
    try:
        t0 = time.perf_counter()
        if init is None:
            exe.run(startup)
        else:
            for n in persist:
                scope.set_var(n, init[n].clone())
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        init = {n: scope.find_var(n).clone() for n in persist}
        snapshot = lambda: {n: scope.find_var(n).clone()  # noqa: E731
                            for n in persist}
        _reset_peak()
        base = torch.cuda.memory_allocated()
        run = lambda step: exe.run(  # noqa: E731
            main, feed=feed_of(step), fetch_list=[loss])[0]
        k_loss, k_secs, k_steps, k_state, profile, graph = \
            _default_mode_path(exe, run, counts or {}, want or {},
                               kinds or {}, need, phase, snapshot, segments,
                               gate_kinds)
        extra = after(exe) if after is not None else None
    finally:
        exe.close()
    if not interpret:
        return {"k_loss": k_loss, "k_secs": k_secs, "k_steps": k_steps,
                "profile": profile, "graph": graph, "startup_s": startup_s,
                "init": init, "k_state": k_state, "states": len(persist),
                "extra": extra, "base_memory_bytes": base}
    for n in persist:
        scope.set_var(n, init[n].clone())
    exe = fluid.Executor(place, seed=SEED)
    try:
        run_i = lambda step: exe.run(  # noqa: E731
            main, feed=feed_of(step), fetch_list=[loss], compiled=False)[0]
        i_loss, i_secs, _ = _timed_steps(run_i, {}, G_STEPS)
        _bit_equal(phase, k_loss, i_loss, k_state, scope.find_var)
        i_profile = _profile_step(lambda: run_i(G_STEPS), i_need or need,
                                  phase)
    finally:
        exe.close()
    return {"k_loss": k_loss, "k_secs": k_secs, "k_steps": k_steps,
            "profile": profile, "graph": graph, "i_loss": i_loss,
            "i_secs": i_secs, "i_profile": i_profile,
            "startup_s": startup_s, "init": init, "k_state": k_state,
            "states": len(persist), "extra": extra,
            "base_memory_bytes": base}


def _flash_paths(phase, place, main, startup, loss, feed_of, snapshot,
                 keep=(), on_replay=None):
    """A transformer Program's flash main path, under the caller's amp
    setting: G_STEPS steps in the Executor's default mode (eager at the
    miss, captured into a CUDA graph at the first hit, replayed after)
    and a profiled replay, the launch counts zeroed just before; then
    the same steps from the same state interpreted (losses and every
    state in `snapshot` bit for bit the replay's), and a profiled
    interpreted step that fetches every parameter's gradient (all
    float32, as every parameter); then the plain path (interpreted, the
    flash op and its gradient swapped for the plain composition).
    -> a dict of the three paths' readings, with the startup's values
    ("init") and the replay's of the states in `keep` ("kept"); the
    scope holds the plain path's.  `on_replay(exe, run)`, when given,
    runs after the default mode's steps, its graph live (its result is
    the dict's "on_replay")."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    blk = main.global_block()
    params = blk.all_parameters()
    persist = _persistables(main)
    grads = _grad_names(main)
    n_attn = sum(op.type == "flash_attention" for op in blk.ops)
    check(sorted(grads) == sorted(p.name for p in params)
          and all(p.dtype == "float32" for p in params),
          f"{phase}: a parameter is not float32 or has no gradient")
    scope = fluid.global_scope()
    exe = fluid.Executor(place, seed=SEED)
    try:
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        init = {n: scope.find_var(n).clone() for n in persist}

        # the main path: counts zeroed just before, read just after
        launches = flash_attention.launches
        for key in launches:
            launches[key] = 0
        _reset_peak()
        run = lambda step: exe.run(  # noqa: E731
            main, feed=feed_of(step), fetch_list=[loss])[0]
        counts = {k: (lambda k=k: launches[k]) for k in launches}
        want = {"fwd": n_attn, "dq": n_attn, "dkv": n_attn}
        k_loss, k_secs, k_steps, k_state, profile, graph = \
            _default_mode_path(
                exe, run, counts, want, {"fwd": "fwd_kernel<",
                                         "dq": "dq_kernel<",
                                         "dkv": "dkv_kernel<"},
                ("flash_attention", "matmul"), phase,
                lambda: {n: scope.find_var(n).clone() for n in snapshot})
        k_total = dict(launches)
        extra = on_replay(exe, run) if on_replay is not None else None
        # the graph and its pool go before the interpreter's runs
        exe.close()
        exe = fluid.Executor(place, seed=SEED)

        # the interpreter from the same state and feeds
        for n in persist:
            scope.set_var(n, init[n].clone())
        run_i = lambda step: exe.run(  # noqa: E731
            main, feed=feed_of(step), fetch_list=[loss], compiled=False)[0]
        i_loss, i_secs, i_steps = _timed_steps(run_i, counts, G_STEPS)
        check(all(st == want for st in i_steps),
              f"{phase}: interpreter flash launches per step {i_steps}, "
              f"want {want}")
        _bit_equal(phase, k_loss, i_loss, k_state, scope.find_var)
        kept = {n: k_state[n] for n in keep}
        del k_state
        fetched = []
        i_profile = _profile_step(
            lambda: fetched.extend(exe.run(
                main, feed=feed_of(G_STEPS),
                fetch_list=[loss] + list(grads.values()),
                return_numpy=False, compiled=False)),
            ("flash_attention", "matmul"), phase)
        # master weights: every parameter and its gradient float32
        bad = sorted(({str(t.dtype) for t in fetched[1:]}
                      | {str(scope.find_var(p.name).dtype) for p in params})
                     - {"torch.float32"})
        check(not bad, f"{phase}: parameters or gradients in {bad}")
        del fetched

        # the plain path from the same state and feeds, interpreted (its
        # counters tick at each run of the swapped lowering)
        for n in persist:
            scope.set_var(n, init[n].clone())
        with _PlainAttention() as plain:
            p_loss, p_secs, p_steps = _timed_steps(run_i, counts, G_STEPS)
        check(all(st == {"fwd": 0, "dq": 0, "dkv": 0} for st in p_steps),
              f"{phase}: the plain path launched flash kernels {p_steps}")
        check(plain.calls == 2 * n_attn * G_STEPS
              and plain.grad_calls == n_attn * G_STEPS,
              f"{phase}: {plain.calls} plain attentions and "
              f"{plain.grad_calls} plain gradients on the plain path")
    finally:
        exe.close()
    return {"want": want, "startup_s": startup_s, "init": init,
            "kept": kept, "on_replay": extra,
            "params": sum(int(np.prod(p.shape)) for p in params),
            "k_loss": k_loss, "k_secs": k_secs, "profile": profile,
            "p_loss": p_loss, "p_secs": p_secs, "i_secs": i_secs,
            "i_profile": i_profile,
            "kernel_path": {"losses": k_loss, "step_s": k_secs,
                            "launches_per_step": k_steps,
                            "launches": k_total,
                            "replayed_kernels_per_step":
                                profile["kind_counts"], **graph},
            "interpreter": {"losses": i_loss, "step_s": i_secs,
                            "launches_per_step": i_steps[0],
                            "bit_equal_to_replay": True},
            "plain_path": {"losses": p_loss, "step_s": p_secs,
                           "mode": "interpreted",
                           "plain_attentions": plain.calls,
                           "plain_attention_grads": plain.grad_calls}}


@contextlib.contextmanager
def _verify_error(**programs):
    """PADDLE_TPU_VERIFY=error over the block: every Executor.run of a
    Program goes through analysis.preflight, whose cache miss runs
    verify_program.  -> a record of the runs (preflight calls) and the
    verifications of each named Program, with the verifications'
    seconds and the Programs' op counts."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.core.flags import set_flags

    names = {id(p): n for n, p in programs.items()}
    rec = {"mode": "error", "runs": dict.fromkeys(programs, 0),
           "verifications": dict.fromkeys(programs, 0),
           "verify_s": dict.fromkeys(programs, 0.0),
           "ops": {n: len(p.global_block().ops)
                   for n, p in programs.items()}}
    real_preflight, real_verify = analysis.preflight, analysis.verify_program

    def preflight(program, *a, **kw):
        if id(program) in names:
            rec["runs"][names[id(program)]] += 1
        return real_preflight(program, *a, **kw)

    def verify_program(program, *a, **kw):
        t0 = time.perf_counter()
        try:
            return real_verify(program, *a, **kw)
        finally:
            if id(program) in names:
                n = names[id(program)]
                rec["verifications"][n] += 1
                rec["verify_s"][n] += time.perf_counter() - t0

    analysis.preflight, analysis.verify_program = preflight, verify_program
    set_flags({"verify": "error"})
    try:
        yield rec
    finally:
        set_flags({"verify": "off"})
        analysis.preflight = real_preflight
        analysis.verify_program = real_verify


def train_phase(card, place, peaks, flash_cases, amp, tools=False):
    """The run_ridge LM trained in the Executor's default mode (the block
    compiled: eager at the miss, then a CUDA graph, captured at the first
    hit and replayed), under bf16 amp (phase "train", the main path) or
    in float32 ("train_fp32"); then the interpreter and the plain path
    from the same state (`_flash_paths`), and each weight matrix's
    change on the kernel and plain paths.  With `tools`, the tools
    phase's profiler part runs on the replayed graph (`_tools_profiler`)
    -> (the wrappers' launches, the replayed step's kernels, the tools
    record or None)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    phase = "train" if amp else "train_fp32"
    if amp:
        fluid.amp.enable_bf16()     # before the Program is built
    prev_scope = executor_mod.switch_scope(Scope())
    try:
        main, startup, loss = _lm_program(
            fluid.Momentum(learning_rate=0.01, momentum=0.9))
        weights = [p.name for p in main.global_block().all_parameters()
                   if len(p.shape) == 2]
        # the replay is held to the interpreter over the parameters; the
        # main path (amp) runs every Executor under PADDLE_TPU_VERIFY=error
        with (_verify_error(main=main, startup=startup) if amp
              else contextlib.nullcontext()) as verify:
            r = _flash_paths(phase, place, main, startup, loss,
                             _train_feed, list(_grad_names(main)),
                             keep=weights,
                             on_replay=(lambda exe, run: _tools_profiler(
                                 card, exe, main, run)) if tools else None)
        # each weight's change on the kernel path (the replay's) and on
        # the plain path (the scope's now)
        param_rel = _param_rel_diff(fluid.global_scope().find_var,
                                    r.pop("init"), r.pop("kept"))
    finally:
        executor_mod.switch_scope(prev_scope)
        torch.cuda.empty_cache()
        if amp:
            fluid.amp.disable_bf16()

    diff, lim, unit = _loss_check(phase, r["k_loss"], r["p_loss"], amp)
    p_lim = PARAM_RTOL_BF16 if amp else PARAM_RTOL
    worst = max(param_rel, key=param_rel.get)
    check(param_rel[worst] <= p_lim, f"{phase}: weight {worst} moved "
          f"{param_rel[worst]} apart on the kernel and plain paths")
    tokens = T_BATCH * T_SEQ
    p_an = _param_count(T_VOCAB, T_D, T_LAYERS, T_SEQ)
    step_s = float(np.median(r["k_secs"][2:]))       # the replays
    plain_step_s = float(np.median(r["p_secs"][1:]))
    if amp:
        STEP_MS["train"] = step_s * 1e3
        check(verify["verifications"]["main"] == 1
              and verify["runs"]["main"] > G_STEPS,
              f"{phase}: the main Program verified "
              f"{verify['verifications']['main']} times over "
              f"{verify['runs']['main']} runs (want once: every later run "
              "a pre-flight cache hit)")
    fc = flash_cases["bf16_causal" if amp else "fp32_causal"]
    attn_ms = sum(fc[kind]["ms"] * n for kind, n in r["want"].items())
    profile = r["profile"]
    mfu = ({"mfu_6np_bf16": 6.0 * tokens * p_an / step_s
            / peaks[torch.bfloat16]} if amp else
           {"mfu_6np_fp32": 6.0 * tokens * p_an / step_s
            / peaks[torch.float32]})
    emit({"phase": phase, "card": card, "vocab": T_VOCAB, "d_model": T_D,
          "n_heads": T_HEADS, "n_layers": T_LAYERS, "seq": T_SEQ,
          "batch": T_BATCH,
          "dtype": "bf16 amp, f32 master weights" if amp else "float32",
          "optimizer": "momentum", "mode": "compiled (CUDA graph replay)",
          "params": r["params"], "params_analytic": p_an,
          "startup_s": r["startup_s"], "steps": G_STEPS,
          **{k: r[k] for k in ("kernel_path", "interpreter",
                               "plain_path")},
          "loss_diff": diff, "loss_limit": lim, "loss_diff_unit": unit,
          "weight_change_rel_diff": {"max": param_rel[worst],
                                     "argmax": worst,
                                     "n_weights": len(param_rel),
                                     "per_weight": param_rel,
                                     "limit": p_lim},
          "ms_per_step": step_s * 1e3,
          **_interpreter_record(r["i_secs"], r["i_profile"]),
          "plain_ms_per_step": plain_step_s * 1e3,
          "tokens_per_s": tokens / step_s, **mfu,
          "attention_ms_per_step": attn_ms,
          "attention_share": attn_ms / (step_s * 1e3),
          "profiled_step": profile,
          "device_idle_share": 1.0 - profile["device_ms"] / (step_s * 1e3),
          "peak_memory_bytes": r["kernel_path"]["peak_memory_bytes"],
          "peak_reserved_bytes": r["kernel_path"]["peak_reserved_bytes"],
          **({"verify": verify} if amp else {}),
          "timing": "host clock around exe.run + synchronize; ms_per_step "
                    "the median of the replayed steps (3..N), the "
                    "interpreter's and the plain path's of steps 2..N; "
                    "attention from the flash phase's cold kernel ms "
                    "(bf16 causal under amp) x launches per step; the "
                    "profiled step (torch.profiler, a replay after the "
                    "timed ones) gives device time by kernel, and the "
                    "idle share is 1 - its device time / the median "
                    "replayed step; peak memory over the default mode's "
                    "steps (allocated, and reserved with the graph's "
                    "pool)"})
    return (r["kernel_path"]["launches"], profile["kind_counts"],
            r["on_replay"])


# -- seq2seq phase -----------------------------------------------------------

def _s2s_program(with_opt=False):
    """run_seq2seq's transformer translator (`build_transformer`, :39-60)
    -> (main, startup, loss), and minimize's (optimize ops, params and
    grads) with `with_opt`."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.models.transformer import transformer_translate

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data(name="src", shape=[S_LEN], dtype="int64")
        tgt = fluid.layers.data(name="tgt", shape=[S_LEN], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[S_LEN, 1], dtype="int64")
        logits = transformer_translate(
            src, tgt, S_VOCAB, S_VOCAB, d_model=S_D, n_heads=S_HEADS,
            n_layers=S_LAYERS, dropout_rate=0.0, is_test=False,
            return_logits=True, remat=False)
        cost = fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, S_VOCAB]),
            fluid.layers.reshape(lbl, shape=[-1, 1]))
        loss = fluid.layers.mean(cost)
        opt = fluid.Adam(learning_rate=1e-4).minimize(loss)
    return (main, startup, loss, opt) if with_opt else (main, startup, loss)


def _s2s_feed():
    """run_seq2seq's feed (:117-126): ids from RandomState(0), the same
    every step (as int64, the port's id type)."""
    r = np.random.RandomState(0)
    shape = (S_BATCH, S_LEN)
    return {"src": r.randint(0, S_VOCAB, shape).astype(np.int64),
            "tgt": r.randint(0, S_VOCAB, shape).astype(np.int64),
            "lbl": r.randint(0, S_VOCAB, shape + (1,)).astype(np.int64)}


def seq2seq_phase(card, place, peaks, flash_cases):
    """run_seq2seq's transformer at its defaults under bf16 amp, trained
    in the Executor's default mode (one compiled block: eager at the
    miss, captured into a CUDA graph at the first hit, replayed after),
    then the same steps interpreted from the same state (bit for bit:
    losses, parameters and Adam's moments), then the plain path
    (interpreted, the flash op swapped for the plain composition): each
    loss within one bf16 ulp of the plain path's."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    phase = "seq2seq"
    fluid.amp.enable_bf16()     # before the Program is built
    prev_scope = executor_mod.switch_scope(Scope())
    try:
        main, startup, loss = _s2s_program()
        blk = main.global_block()
        causal = [bool(op.attrs.get("causal")) for op in blk.ops
                  if op.type == "flash_attention"]
        check(len(causal) == 3 * S_LAYERS and sum(causal) == S_LAYERS,
              f"{phase}: flash ops causal {causal}: want {S_LAYERS} causal "
              f"and {2 * S_LAYERS} non-causal")
        flops = _model_flops(main, S_BATCH)
        feed = _s2s_feed()
        # the replay is held to the interpreter over every state:
        # parameters, Adam's moments and beta powers
        r = _flash_paths(phase, place, main, startup, loss,
                         lambda step: feed, _persistables(main))
        del r["init"]
    finally:
        executor_mod.switch_scope(prev_scope)
        torch.cuda.empty_cache()
        fluid.amp.disable_bf16()

    diff, lim, unit = _loss_check(phase, r["k_loss"], r["p_loss"], amp=True)
    tokens = S_BATCH * (S_LEN + S_LEN)
    step_s = float(np.median(r["k_secs"][2:]))       # the replays
    step_ms = step_s * 1e3
    STEP_MS["seq2seq"] = step_ms
    bound_ms = flops / peaks[torch.bfloat16] * 1e3
    per_kind = {"s2s_bf16_full": 2 * S_LAYERS, "s2s_bf16_causal": S_LAYERS}
    attn_ms = sum(flash_cases[c][kind]["ms"] * n
                  for c, n in per_kind.items() for kind in r["want"])
    profile, graph = r["profile"], r["kernel_path"]
    emit({"phase": phase, "card": card,
          "source": "benchmark/run_seq2seq.py:39-60 (transformer, "
                    "defaults: batch 32, src and tgt length 128, "
                    "--dtype bfloat16 = amp)",
          "vocab": S_VOCAB, "d_model": S_D, "n_heads": S_HEADS,
          "n_layers": S_LAYERS, "src_len": S_LEN, "tgt_len": S_LEN,
          "batch": S_BATCH, "dtype": "bf16 amp, f32 master weights",
          "optimizer": "adam", "mode": "compiled (CUDA graph replay)",
          "ops": len(blk.ops), "params": r["params"],
          "startup_s": r["startup_s"], "steps": G_STEPS,
          **{k: r[k] for k in ("kernel_path", "interpreter",
                               "plain_path")},
          "loss_diff": diff, "loss_limit": lim, "loss_diff_unit": unit,
          "ms_per_step": step_ms, "tokens_per_step": tokens,
          "tokens_per_s": tokens / step_s,
          **_interpreter_record(r["i_secs"], r["i_profile"]),
          "plain_ms_per_step": float(np.median(r["p_secs"][1:])) * 1e3,
          "model_flops_per_step": flops, "bound_ms": bound_ms,
          "bound_by": "operations",
          "model_flops_share_of_bf16_peak": bound_ms / step_ms,
          "attention_ms_per_step": attn_ms,
          "attention_share": attn_ms / step_ms,
          "profiled_step": profile,
          "device_ms_by_group": profile["by_group_ms"],
          "device_idle_share": 1.0 - profile["device_ms"] / step_ms,
          "peak_memory_bytes": graph["peak_memory_bytes"],
          "peak_reserved_bytes": graph["peak_reserved_bytes"],
          "capture_s": graph["capture_s"],
          "timing": "host clock around exe.run + synchronize; ms_per_step "
                    "the median of the replayed steps (3..N), the "
                    "interpreter's and the plain path's of steps 2..N; "
                    "tokens a step batch x (src + tgt), as run_seq2seq "
                    "counts them; model FLOPs from the Program's mul and "
                    "flash_attention shapes (forward x 3) over the bf16 "
                    "dense peak; attention from the flash phase's s2s "
                    "cases (cold kernel ms x launches a step); device "
                    "time and idle share from one profiled replay"})
    return graph["launches"], profile["kind_counts"], step_ms


# -- serve / spec phases -----------------------------------------------------

def _random_states(shapes, seed):
    """Seeded parameters: N(0, 0.02) matrices and embeddings, layer-norm
    scales one, biases and shifts zero."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name in sorted(shapes):
        shp = shapes[name]
        if len(shp) >= 2:
            out[name] = (torch.randn(shp, generator=gen) * 0.02).numpy()
        elif ".scale" in name:
            out[name] = np.ones(shp, np.float32)
        else:
            out[name] = np.zeros(shp, np.float32)
    return out


def _requests(seed):
    r = np.random.RandomState(seed)
    prompts = [r.randint(0, V, int(r.randint(16, 129))).tolist()
               for _ in range(N_REQUESTS)]
    max_news = [int(r.randint(32, 65)) for _ in range(N_REQUESTS)]
    return prompts, max_news


def _serve(srv, prompts, max_news):
    """Half the requests first; the rest arrive once the first tokens
    are out, so admissions land in a running batch."""
    st0 = srv.stats()
    half = len(prompts) // 2
    t0 = time.perf_counter()
    streams = [srv.submit(p, m) for p, m in zip(prompts[:half],
                                                 max_news[:half])]
    while srv.stats()["generated_tokens"] == st0["generated_tokens"]:
        time.sleep(0.0005)
    streams += [srv.submit(p, m) for p, m in zip(prompts[half:],
                                                  max_news[half:])]
    out = [s.result(timeout=600) for s in streams]
    wall = time.perf_counter() - t0
    st = srv.stats()
    ticks = st["ticks"] - st0["ticks"]
    toks = st["generated_tokens"] - st0["generated_tokens"]
    check([len(o) for o in out] == list(max_news), "wrong token counts")
    check(all(0 <= t < V for o in out for t in o), "token out of vocab")
    return out, st, {"wall_s": wall, "ticks": ticks, "tokens": toks,
                     "tokens_per_s": toks / wall,
                     "ms_per_tick": wall / ticks * 1e3}


def _agreement(a, b):
    pairs = [(x, y) for oa, ob in zip(a, b) for x, y in zip(oa, ob)]
    return sum(x == y for x, y in pairs) / len(pairs)


def serve_phases(card, place):
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.flags import get_flag, set_flags
    from paddle_tpu_torch.kernels.paged_attention import paged_attention
    from paddle_tpu_torch.models.transformer import build_lm_paged_decoder
    from paddle_tpu_torch.serving import (save_generation_model,
                                          server_from_model_dir)

    fw.reset_unique_names()
    _, dec = build_lm_paged_decoder(V, BLOCK, MAX_BLOCKS, d_model=D_MODEL,
                                    n_heads=N_HEADS, n_layers=N_LAYERS,
                                    d_inner=D_INNER, place=place)
    states = _random_states(dec.state_shapes, SEED)
    n_params = sum(int(np.prod(s)) for s in dec.state_shapes.values())
    spec = {"vocab_size": V, "d_model": D_MODEL, "n_heads": N_HEADS,
            "n_layers": N_LAYERS, "d_inner": D_INNER, "block_size": BLOCK,
            "max_blocks_per_seq": MAX_BLOCKS, "slots": SLOTS,
            "kv_blocks": KV_BLOCKS}
    prompts, max_news = _requests(SEED + 1)
    solo_ids = (0, N_REQUESTS - 1)
    kw = {"slots": SLOTS, "kv_blocks": KV_BLOCKS, "place": place}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        model_dir = save_generation_model(os.path.join(tmp, "lm"), states,
                                          spec)
        spec_dir = save_generation_model(
            os.path.join(tmp, "lm_spec"), states,
            dict(spec, spec_k=3, draft={"d_model": D_MODEL,
                                        "n_heads": N_HEADS,
                                        "n_layers": N_LAYERS,
                                        "d_inner": D_INNER}),
            draft_states=states)

        # the plain path (kernel tier off) gives the reference tokens
        plain = {}
        mode = get_flag("serving_kernels")
        set_flags({"serving_kernels": "off"})
        try:
            for kv in KV_DTYPES:
                srv = server_from_model_dir(model_dir, kv_dtype=kv, **kw)
                try:
                    picked = srv.stats()["decode_kernel"]
                    check(picked == "plain:disarmed",
                          f"plain server picked {picked}")
                    plain[kv] = _serve(srv, prompts, max_news)
                finally:
                    srv.close()
        finally:
            set_flags({"serving_kernels": mode})

        # the main path: counts zeroed just before, read just after
        paged_attention.launches = 0
        serve, steps = {}, 0
        for kv in KV_DTYPES:
            srv = server_from_model_dir(model_dir, kv_dtype=kv, **kw)
            try:
                picked = srv.stats()["decode_kernel"]
                check(picked == "cuda", f"kernel server picked {picked}")
                SERVE.update(spec=spec, decode_kernel=srv._decoder.kernels[
                    "paged_attention_decode"])
                out, st, perf = _serve(srv, prompts, max_news)
                solo = [srv.generate(prompts[i], max_news[i], timeout=600)
                        for i in solo_ids]
                end = srv.stats()
                check(end["kv_blocks_free"] == KV_BLOCKS,
                      f"{kv}: pool did not drain back")
                steps += end["ticks"] + 1          # + the warmup step
            finally:
                srv.close()
            check(all(solo[j] == out[i] for j, i in enumerate(solo_ids)),
                  f"{kv}: batched tokens differ from solo")
            agree = _agreement(out, plain[kv][0])
            floor = 0.99 if kv == "fp32" else 0.9
            check(agree >= floor,
                  f"{kv}: kernel/plain greedy agreement {agree} < {floor}")
            serve[kv] = {"agreement_vs_plain": agree, "kernel_path": perf,
                         "plain_path": plain[kv][2],
                         "kv_blocks_free": st["kv_blocks_free"],
                         "decode_kernel": st["decode_kernel"],
                         "warmup": {k: st[k] for k in (
                             "warmup_s", "compiles", "cache_hits")}}
            serve[kv]["out"] = out
        serve_launches = paged_attention.launches
        check(serve_launches == N_LAYERS * steps,
              f"serve: {serve_launches} launches for {steps} decode steps "
              f"of {N_LAYERS} layers")
        emit({"phase": "serve", "card": card, "params": n_params,
              "vocab": V, "d_model": D_MODEL, "n_heads": N_HEADS,
              "n_layers": N_LAYERS, "context": BLOCK * MAX_BLOCKS,
              "slots": SLOTS, "kv_blocks": KV_BLOCKS,
              "requests": N_REQUESTS, "solo_checked": list(solo_ids),
              "paged_attention_launches": serve_launches,
              "decode_steps": steps,
              "by_kv_dtype": {kv: {k: v for k, v in r.items() if k != "out"}
                              for kv, r in serve.items()}})

        paged_attention.launches = 0
        srv = server_from_model_dir(spec_dir, **kw)
        try:
            check(srv.stats()["spec_k"] == 3, "spec model dir armed no draft")
            out, st, perf = _serve(srv, prompts, max_news)
        finally:
            srv.close()
        spec_launches = paged_attention.launches
        accept = st["draft_accepted"] / max(st["draft_proposed"], 1)
        check(st["draft_proposed"] > 0, "spec: nothing proposed")
        check(accept == 1.0, f"spec: accept rate {accept} with a perfect "
              "draft")
        check(out == serve["fp32"]["out"],
              "spec: tokens differ from greedy decode")
        check(spec_launches > 0, "spec phase launched no kernel")
        emit({"phase": "spec", "card": card, "spec_k": 3,
              "accept_rate": accept, "draft_proposed": st["draft_proposed"],
              "paged_attention_launches": spec_launches, **perf})
    return serve_launches + spec_launches


# -- dp / fused_update phases ------------------------------------------------

def dp_phase(card, place, peaks):
    """The data-parallel path at the train phase's width, under bf16 amp
    (f32 master weights, so every bucket is f32).  The optimizer
    is plain SGD (lr 0.01): ParallelExecutor._plan_fused_update fuses
    only a chain of plain dense `sgd` ops (Momentum or Adam keep the
    per-op chain, as in the JAX package), and this phase drives the
    fused update.  One card: a single-rank NCCL group, so every bucket's
    all-reduce is issued and waited on, and reduces nothing.  The chain
    run swaps the fused update for the per-op sgd chain in this script
    (`_PerOpChain`)."""
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.flags import get_flag
    from paddle_tpu_torch.kernels.fused_update import fused_bucket_sgd_

    fluid.amp.enable_bf16()     # before the Program is built
    main, startup, loss = _lm_program(fluid.SGD(learning_rate=0.01))
    params = main.global_block().all_parameters()
    weights = [p.name for p in params if len(p.shape) == 2]
    persist = [v.name for v in main.list_vars() if v.persistable]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    pe = None
    try:
        t = fluid.ShardingTranspiler()
        t.transpile(program=main, startup_program=startup, mesh={"dp": 1},
                    overlap="bucketed")
        t0 = time.perf_counter()
        pe = t.build_executor(["ids", "lbl"], [loss], place=place)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        info = dict(pe.overlap_info)
        check(info["mode"] == "bucketed" and info["update"] == "fused",
              f"dp: overlap_info {info}")
        init = {n: pe.state(n, return_numpy=False) for n in persist}
        buckets = info["buckets"]
        # a bucket holds at most overlap_bucket_bytes unless one
        # gradient is larger: then it is that gradient alone, so the
        # largest bucket is the largest parameter
        largest = max(int(np.prod(p.shape)) for p in params)
        check(4 * largest > get_flag("overlap_bucket_bytes"),
              "dp: the largest parameter fits a bucket with others")

        # the main path: counts zeroed just before, read just after
        fused_bucket_sgd_.launches = 0
        _reset_peak()
        run = lambda step: pe.run(_train_feed(step))[0]  # noqa: E731
        counts = {"fused": lambda: fused_bucket_sgd_.launches,
                  "grad_all_reduce":
                  lambda: pe.collective_calls["grad_all_reduce"]}
        k_loss, k_secs, k_steps = _timed_steps(run, counts)
        peak = torch.cuda.max_memory_allocated()
        k_params = {n: pe.state(n, return_numpy=False) for n in weights}
        before = fused_bucket_sgd_.launches
        profile = _profile_step(lambda: pe.run(_train_feed(T_STEPS)),
                                ("fused_update", "flash_attention",
                                 "matmul"), "dp")
        k_total = fused_bucket_sgd_.launches
        check(k_total - before == buckets,
              f"dp: {k_total - before} fused launches in the profiled step")
        # in place: every weight is still a view of its bucket's buffer
        in_place = all(pe._in_bucket(pe._states[n]) for n in weights)
        check(in_place, "dp: a weight is no view of its bucket's flat "
              "buffer after the fused steps")
        # every bucket holds its parameters' f32, and a gradient of
        # another dtype raises in the overlap step (`_bucket_grad`)
        dtypes = {str(pe.state(p.name, return_numpy=False).dtype)
                  for p in params} | {str(b[0][2]) for b in pe._plan[0]}
        check(dtypes == {"torch.float32", "float32"},
              f"dp: parameters or buckets in {dtypes}")
        want = {"fused": buckets, "grad_all_reduce": buckets}
        check(all(st == want for st in k_steps),
              f"dp: per-step launches {k_steps}, want {want}")

        # the per-op sgd chain from the same state and feeds
        for n in persist:
            pe.set_state(n, init[n].clone())
        with _PerOpChain(pe) as chain:
            p_loss, p_secs, p_steps = _timed_steps(run, counts)
        check(all(st == {"fused": 0, "grad_all_reduce": buckets}
                  for st in p_steps),
              f"dp: the chain run's per-step launches {p_steps}")
        check(chain.calls == info["grads"] * T_STEPS,
              f"dp: the chain run ran {chain.calls} sgd ops in {T_STEPS} "
              f"steps of {info['grads']} gradients")
        param_rel = _param_rel_diff(
            lambda n: pe.state(n, return_numpy=False), init, k_params)
        del init, k_params
    finally:
        del pe
        dist.destroy_process_group()
        torch.cuda.empty_cache()
        fluid.amp.disable_bf16()

    check(all(np.isfinite(k_loss + p_loss)), f"dp: non-finite losses "
          f"{k_loss} / {p_loss}")
    rel = [abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss)]
    check(max(rel) <= LOSS_RTOL, f"dp: fused/chain losses differ {rel}")
    worst = max(param_rel, key=param_rel.get)
    check(param_rel[worst] <= PARAM_RTOL, f"dp: weight {worst} moved "
          f"{param_rel[worst]} apart on the fused and chain runs")
    tokens = T_BATCH * T_SEQ
    p_an = _param_count(T_VOCAB, T_D, T_LAYERS, T_SEQ)
    step_s = float(np.median(k_secs[1:]))
    emit({"phase": "dp", "card": card, "mesh": {"dp": 1},
          "backend": "nccl", "vocab": T_VOCAB, "d_model": T_D,
          "n_heads": T_HEADS, "n_layers": T_LAYERS, "seq": T_SEQ,
          "batch": T_BATCH, "dtype": "bf16 amp, f32 master weights",
          "optimizer": "sgd", "overlap_info": info, "largest_bucket_numel": largest,
          "fused_in_place": in_place,
          "copies_ms": profile["by_group_ms"].get("copy", 0.0),
          "startup_s": startup_s, "steps": T_STEPS,
          "fused_run": {"losses": k_loss, "step_s": k_secs,
                        "launches_per_step": k_steps[0],
                        "fused_launches": k_total},
          "chain_run": {"losses": p_loss, "step_s": p_secs,
                        "sgd_ops": chain.calls,
                        "launches_per_step": p_steps[0]},
          "loss_rel_diff": rel, "loss_rtol": LOSS_RTOL,
          "weight_change_rel_diff": {"max": param_rel[worst],
                                     "argmax": worst,
                                     "n_weights": len(param_rel),
                                     "limit": PARAM_RTOL},
          "ms_per_step": step_s * 1e3,
          "chain_ms_per_step": float(np.median(p_secs[1:])) * 1e3,
          "tokens_per_s": tokens / step_s,
          "mfu_6np_bf16": 6.0 * tokens * p_an / step_s
          / peaks[torch.bfloat16],
          "profiled_step": profile,
          "device_idle_share": 1.0 - profile["device_ms"] / (step_s * 1e3),
          "peak_memory_bytes": peak,
          "timing": "host clock around pe.run + synchronize; median of "
                    "steps 2..N; the profiled step (torch.profiler, one "
                    "step after the timed ones) gives device time by "
                    "kernel group"})
    return k_total, largest


def fused_update_phase(dev, bw, flops, largest):
    """The fused bucket SGD kernel against its plain version on the dp
    path's largest bucket and odd sizes: in place, as the dp path calls
    it, bit for bit, lr a device scalar.  Times: the kernel, the plain
    version (two PyTorch kernels into a new tensor), and
    torch.add(p, g, alpha=-lr) and p.add_(g, alpha=-lr) with a host lr
    (one kernel each; yardsticks only, they round once)."""
    from paddle_tpu_torch.kernels.fused_update import (
        fused_bucket_sgd_, fused_bucket_sgd_reference)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lr_host = 0.01
    lr = torch.tensor([lr_host], device=dev)
    cases = {}
    for name, n in (("largest_bucket", largest), ("n1", 1),
                    ("n1023", 1023), ("n1048583", (1 << 20) + 7)):
        p = torch.randn(n, generator=gen, device=dev)
        g = torch.randn(n, generator=gen, device=dev)
        ref = fused_bucket_sgd_reference(p, g, lr)
        lib = torch.add(p, g, alpha=-lr_host)
        q = p.clone()
        got = fused_bucket_sgd_(q, g, lr)
        torch.cuda.synchronize()
        check(got is q and torch.equal(q, ref),
              f"fused_update {name}: the in-place update is not "
              "bit-identical to the plain version")
        nbytes, n_ops = 12 * n, 2 * n
        t_bytes, t_ops = nbytes / bw * 1e3, n_ops / flops * 1e3
        res = {
            "numel": n,
            "max_abs_err": float((q - ref).abs().max()),
            "library_max_abs_err": float((lib - ref).abs().max()),
            "plain_ms": cold_ms(
                lambda: fused_bucket_sgd_reference(p, g, lr), 50, flush),
            "library_ms": cold_ms(
                lambda: torch.add(p, g, alpha=-lr_host), 50, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes}
        del q, got, ref, lib
        # the in-place calls last: they move p
        res["ms"] = cold_ms(lambda: fused_bucket_sgd_(p, g, lr), 50, flush)
        res["library_in_place_ms"] = cold_ms(
            lambda: p.add_(g, alpha=-lr_host), 50, flush)
        res["bytes_per_s"] = nbytes / (res["ms"] * 1e-3)
        cases[name] = res
        del p, g
    emit({"phase": "fused_update", "kernel": "fused_bucket_sgd",
          "timing": "median of cold-L2 calls, CUDA events; library = "
                    "torch.add(p, g, alpha=-lr), library_in_place = "
                    "p.add_(g, alpha=-lr), with a host lr",
          "cases": cases})
    return cases


# -- moe_kernel / moe phases -------------------------------------------------

def _tol_err(got, want, tol):
    err = float((got - want).abs().max())
    return err, tol * max(1.0, float(want.abs().max()))


def _moe_bytes(t_n, d, e_n, c_n, top_k, dense):
    """Bytes the forward must move: x and gate_w read once; expert_in,
    the routing (probs, idx, slot_of, slot_token, slot_weight,
    first_count) and aux written once; the dense combine when asked."""
    n = (t_n * d + d * e_n + e_n * c_n * d + t_n * e_n + 2 * top_k * t_n
         + 2 * e_n * c_n + e_n + 1)
    return 4 * (n + (t_n * e_n * c_n if dense else 0))


def moe_kernel_phase(dev, bw, flops):
    from paddle_tpu_torch.kernels.moe_dispatch import (
        moe_gate_dispatch, moe_gate_dispatch_reference, moe_gate_route,
        moe_gate_route_backward, moe_gate_route_launch,
        moe_gate_route_reference, moe_gate_route_vjp,
        moe_route_backward_launch, moe_routing_reference)
    from paddle_tpu_torch.parallel.moe import _capacity

    t_n, d, e_n = M_BATCH * M_SEQ, M_D, M_EXPERTS
    # 1 GiB: its memset (about 0.4 ms) outlasts the host's ~0.1 ms of
    # Python a call, so the card never waits on the host between a cold
    # call's events and the events time the kernels
    flush = torch.empty(256 * 2 ** 20, dtype=torch.int32, device=dev)
    flush_l2 = flush[:64 * 2 ** 20]   # for device times: L2 is 50 MB
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((t_n, d), generator=gen).to(dev)
    gw = (torch.randn((d, e_n), generator=gen) * M_GATE_STD).to(dev)
    cases = {}
    for name, top_k, cf in (("top2", 2, M_CF), ("top1", 1, M_CF),
                            ("top2_cf0.5", 2, 0.5)):
        c_n = _capacity(t_n, e_n, cf, top_k)
        errs = {}
        # the routing form and the dense contract against their plain
        # versions, and each against a second call (bit for bit)
        runs = [moe_gate_route_launch(x, gw, e_n, c_n, top_k, dense=dense)
                for dense in (False, False, True, True)]
        (ei, sw, aux, slot_of, slot_token, probs, idx, first,
         _) = runs[0]
        ei_r, sw_r, aux_r, slot_of_r, slot_token_r = \
            moe_gate_route_reference(x, gw, e_n, c_n, top_k)
        _, idx_r, _ = moe_routing_reference(x, gw, e_n, c_n, top_k)
        _, cb_r, _ = moe_gate_dispatch_reference(x, gw, e_n, c_n, top_k)
        torch.cuda.synchronize()
        check(torch.equal(idx, idx_r), f"moe_kernel {name}: experts differ "
              f"for {int((idx != idx_r).any(0).sum())} tokens")
        check(torch.equal(slot_of, slot_of_r) and torch.equal(
            slot_token, slot_token_r), f"moe_kernel {name}: capacity "
            "slots differ")
        check(torch.equal(ei, ei_r), f"moe_kernel {name}: expert_in is not "
              "bit-equal")
        for key, got, want in (("slot_weight", sw, sw_r), ("aux", aux, aux_r),
                               ("combine", runs[2][8], cb_r)):
            err, lim = _tol_err(got, want, 1e-6)
            check(err <= lim, f"moe_kernel {name} {key}: {err} > {lim}")
            errs[key] = err
        for other in runs[1:]:
            check(all(torch.equal(a, b) for a, b in zip(runs[0][:8],
                                                        other[:8])),
                  f"moe_kernel {name}: two calls differ")
        check(torch.equal(runs[2][8], runs[3][8]),
              f"moe_kernel {name}: two dense combines differ")
        kept = int((slot_token >= 0).sum())
        del runs, cb_r

        # the backward kernel against the plain VJP at the kernel's
        # routing, twice (bit for bit); the Functions' gradients (routing
        # form and dense contract) against plain autograd
        cots = [torch.randn(s, generator=gen).to(dev)
                for s in (ei.shape, sw.shape, aux.shape)]
        bwd = [moe_gate_route_backward(x, gw, probs, idx, slot_of, first,
                                       *cots, capacity=c_n)
               for _ in range(2)]
        want = moe_gate_route_vjp(x, gw, probs, idx, slot_of, *cots)
        for key, g, g2, w in zip(("bwd_dx", "bwd_dgate_w"), bwd[0], bwd[1],
                                 want):
            err, lim = _tol_err(g, w, 1e-5)
            check(err <= lim, f"moe_kernel {name} {key}: {err} > {lim}")
            check(torch.equal(g, g2), f"moe_kernel {name} {key}: two calls "
                  "differ")
            errs[key] = err
        del bwd, want
        for form, fn, ref, shapes in (
                ("route", moe_gate_route, moe_gate_route_reference,
                 (ei.shape, sw.shape, aux.shape)),
                ("dense", moe_gate_dispatch, moe_gate_dispatch_reference,
                 (ei.shape, (t_n, e_n, c_n), aux.shape))):
            fcots = [torch.randn(s, generator=gen).to(dev) for s in shapes]
            leaves = [t.clone().requires_grad_(True) for t in (x, gw)]
            got = torch.autograd.grad(fn(*leaves, e_n, c_n, top_k)[:3],
                                      leaves, fcots)
            ref_leaves = [t.clone().requires_grad_(True) for t in (x, gw)]
            want = torch.autograd.grad(ref(*ref_leaves, e_n, c_n, top_k)[:3],
                                       ref_leaves, fcots)
            for key, g, w in zip(("dx", "dgate_w"), got, want):
                err, lim = _tol_err(g, w, 1e-5)
                check(err <= lim, f"moe_kernel {name} {form} {key}: "
                      f"{err} > {lim}")
                errs[f"{form}_{key}"] = err
            if form == "dense":   # the Function's whole backward
                outs = fn(*leaves, e_n, c_n, top_k)
                dense_bwd_ms = cold_ms(lambda: torch.autograd.grad(
                    outs, leaves, fcots, retain_graph=True), 10, flush)
                del outs
            del fcots, leaves, ref_leaves, got, want

        # times: CUDA events around the entry point (host time included
        # where the host is slower than the card) and the kernels' own
        # device time (torch.profiler)
        def route():
            return moe_gate_route(x, gw, e_n, c_n, top_k)

        def dense():
            return moe_gate_dispatch(x, gw, e_n, c_n, top_k)

        def backward():
            return moe_route_backward_launch(gw, probs, idx, slot_of, first,
                                             *cots, c_n, d)

        with torch.no_grad():
            forms = {}
            for form, fn, plain, is_dense in (
                    ("route", route, lambda: moe_gate_route_reference(
                        x, gw, e_n, c_n, top_k), False),
                    ("dense", dense, lambda: moe_gate_dispatch_reference(
                        x, gw, e_n, c_n, top_k), True)):
                nbytes = _moe_bytes(t_n, d, e_n, c_n, top_k, is_dense)
                t_bytes = nbytes / bw * 1e3
                t_ops = 2 * t_n * d * e_n / flops * 1e3
                dev_ms = [device_ms(fn, 30, flush_l2, k)[0]
                          for k in ("route_kernel<", "place_kernel(")]
                forms[form] = {
                    "ms": cold_ms(fn, 50, flush),
                    "host_us": host_us(fn, 200),
                    "device_ms": sum(dev_ms),
                    "device_ms_route_place": dev_ms,
                    "plain_ms": cold_ms(plain, 10, flush),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes}
            # the backward kernel: the kept d expert_in rows read, the
            # routing and d slot_weight read, dx and d_logits written
            nbytes = 4 * (kept * d + d * e_n + t_n * e_n + 2 * top_k * t_n
                          + e_n + e_n * c_n + 1 + t_n * d + t_n * e_n)
            t_bytes = nbytes / bw * 1e3
            t_ops = 2 * t_n * d * e_n / flops * 1e3
            forms["backward"] = {
                "ms": cold_ms(backward, 50, flush),
                "device_ms": device_ms(backward, 30, flush_l2,
                                       "route_backward_kernel<")[0],
                "plain_ms": cold_ms(lambda: moe_gate_route_vjp(
                    x, gw, probs, idx, slot_of, *cots), 10, flush),
                "function_ms": cold_ms(lambda: moe_gate_route_backward(
                    x, gw, probs, idx, slot_of, first, *cots,
                    capacity=c_n), 50, flush),
                "dense_function_backward_ms": dense_bwd_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes}
        for f in forms.values():
            f["library_ms"] = None
            f["bytes_per_s"] = f["bytes"] / (f["device_ms"] * 1e-3)
        cases[name] = {"top_k": top_k, "capacity_factor": cf,
                       "capacity": c_n, "assignments": t_n * top_k,
                       "kept": kept, "max_abs_err": errs, **forms}
        del ei, sw, aux, slot_of, slot_token, probs, idx, first, cots
        del ei_r, sw_r, aux_r, slot_of_r, slot_token_r
    emit({"phase": "moe_kernel", "kernel": "moe_gate_dispatch",
          "tokens": t_n, "d_model": d, "experts": e_n,
          "gate_std": M_GATE_STD,
          "timing": "cold L2 (a 1 GiB memset before each call timed "
                    "between events, 256 MB before each profiled one); "
                    "ms: median between CUDA events around the entry point "
                    "(moe_gate_route, moe_gate_dispatch, the backward "
                    "launch); host_us: host time of a call; device_ms: "
                    "the kernels' own durations "
                    "in torch.profiler (route + place for the forward); "
                    "backward function_ms: the kernel plus the dgate_w "
                    "GEMM; dense_function_backward_ms: the dense "
                    "contract's autograd backward; library_ms null: no "
                    "PyTorch call computes gate + capacity dispatch",
          "cases": cases})
    return cases


class _TecWatch:
    """Records every tensor an op makes (through a TorchDispatchMode)
    whose shape is a dense [T, E, C] dispatch or combine: dims T, E, C
    in a row, or dims T and E * C."""

    def __init__(self, t_n, e_n, c_n):
        from torch.utils._python_dispatch import TorchDispatchMode

        watch = self
        self.t_n, self.e_n, self.c_n, self.hits = t_n, e_n, c_n, []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in torch.utils._pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor) and watch.dense(t.shape):
                        watch.hits.append([str(func), list(t.shape)])
                return out

        self.mode = Mode()

    def dense(self, shape):
        sh = tuple(shape)
        tec = (self.t_n, self.e_n, self.c_n)
        return ((self.t_n in sh and self.e_n * self.c_n in sh)
                or any(sh[i:i + 3] == tec for i in range(len(sh) - 2)))

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def moe_phase(card, place, peaks, moe_cases):
    """The run_moe LM under bf16 amp, as run_moe runs it: the attention
    projections and the LM head in bf16, the MoE FFN in float32 (its
    input is the f32 layer-norm output; the MoE kernel takes f32 only
    and raises on bf16)."""
    import torch.utils._pytree  # noqa: F401  (_TecWatch)

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.kernels.moe_dispatch import (
        moe_gate_dispatch, moe_gate_route, moe_gate_route_backward)
    from paddle_tpu_torch.models.moe import active_param_count, build_moe_lm
    from paddle_tpu_torch.parallel.moe import _capacity
    from paddle_tpu_torch.parallel.spmd import backward_start_index

    tokens = M_BATCH * M_SEQ
    c_n = _capacity(tokens, M_EXPERTS, M_CF, M_TOPK)
    ec_n = M_EXPERTS * c_n
    fluid.amp.enable_bf16()     # before the Program is built
    fw.reset_unique_names()
    main, startup, loss = build_moe_lm(M_BATCH, M_SEQ, M_VOCAB, M_D,
                                       M_HEADS, M_LAYERS, M_EXPERTS, M_TOPK,
                                       M_CF, aux_weight=M_AUX)
    moe_x = {main.global_block().var(op.input("X")[0]).dtype
             for op in main.global_block().ops if op.type == "moe_ffn"}
    check(moe_x == {"float32"}, f"moe: the MoE FFN takes {moe_x} under amp")
    params = main.global_block().all_parameters()
    n_params = sum(int(np.prod(p.shape)) for p in params)
    weights = [p.name for p in params if len(p.shape) >= 2]
    persist = [v.name for v in main.list_vars() if v.persistable]
    # the for_test clone, cut to its forward; its logits are the cross
    # entropy's input
    test_prog = main.clone(for_test=True)
    blk = test_prog.global_block()
    blk.ops = blk.ops[:backward_start_index(blk)]
    logits_name = next(op.input("Logits")[0] for op in blk.ops
                       if op.type == "softmax_with_cross_entropy")
    prev_scope = executor_mod.switch_scope(Scope())
    exe = None
    try:
        scope = fluid.global_scope()
        exe = fluid.Executor(place, seed=SEED)
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        init = {n: scope.find_var(n).clone() for n in persist}

        # the main path: counts zeroed just before, read just after
        moe_gate_dispatch.launches = 0
        moe_gate_route_backward.launches = 0
        _reset_peak()
        run = lambda step: exe.run(  # noqa: E731
            main, feed=_train_feed(step), fetch_list=[loss])[0]
        counts = {"moe": lambda: moe_gate_dispatch.launches,
                  "moe_bwd": lambda: moe_gate_route_backward.launches}
        want = {"moe": 2 * M_LAYERS, "moe_bwd": M_LAYERS}
        grads = _grad_names(main)
        k_loss, k_secs, k_steps, k_params, profile, graph = \
            _default_mode_path(
                exe, run, counts, want,
                {"moe": "route_kernel<",
                 "moe_bwd": "route_backward_kernel<"},
                ("moe_dispatch", "moe_backward", "flash_attention",
                 "matmul"), "moe",
                lambda: {n: scope.find_var(n).clone() for n in grads})
        k_bwd = [st["moe_bwd"] for st in k_steps]
        k_steps = [st["moe"] for st in k_steps]
        k_total = moe_gate_dispatch.launches
        k_bwd_total = moe_gate_route_backward.launches
        # the graph and its pool go before the interpreter's runs
        exe.close()
        exe = fluid.Executor(place, seed=SEED)

        # the interpreter from the same state and feeds
        for n in persist:
            scope.set_var(n, init[n].clone())
        run_i = lambda step: exe.run(  # noqa: E731
            main, feed=_train_feed(step), fetch_list=[loss],
            compiled=False)[0]
        i_loss, i_secs, i_steps = _timed_steps(run_i, counts, G_STEPS)
        check(all(st == want for st in i_steps),
              f"moe: interpreter MoE launches per step {i_steps}, want "
              f"{want}")
        _bit_equal("moe", k_loss, i_loss, k_params, scope.find_var)
        fetched = []
        i_profile = _profile_step(
            lambda: fetched.extend(exe.run(
                main, feed=_train_feed(G_STEPS),
                fetch_list=[loss] + list(grads.values()),
                return_numpy=False, compiled=False)),
            ("moe_dispatch", "moe_backward", "flash_attention", "matmul"),
            "moe", gemm_dim=ec_n)
        # the GEMM split needs the aten ops a replay does not dispatch: it
        # is taken from this interpreted step of the kernel path, which
        # must show GEMMs and none with an E*C operand dimension
        split = i_profile["gemm_split"]
        check(split["other_calls"] > 0 and split["with_dim_calls"] == 0,
              f"moe: the kernel path's GEMMs {split['other_calls']} without "
              f"and {split['with_dim_calls']} with an E*C operand "
              f"dimension: {split['shapes_with_dim']}")
        # master weights: every parameter has an f32 gradient
        grad_dtypes = {str(t.dtype) for t in fetched[1:]}
        check(len(grads) == len(params)
              and grad_dtypes == {"torch.float32"},
              f"moe: {len(grads)} gradients for {len(params)} parameters, "
              f"in {grad_dtypes}")
        del fetched
        # the kernel takes float32 only: a bf16 x raises, launching nothing
        dev = exe.device
        x_bf16 = torch.zeros((tokens, M_D), dtype=torch.bfloat16,
                             device=dev)
        gw = torch.zeros((M_D, M_EXPERTS), device=dev)
        n_launched = moe_gate_dispatch.launches
        try:
            moe_gate_route(x_bf16, gw, M_EXPERTS, c_n, M_TOPK)
            raised = False
        except ValueError:
            raised = True
        check(raised and moe_gate_dispatch.launches == n_launched,
              "moe: the MoE kernel took a bf16 x")
        del x_bf16, gw
        # one more kernel-path step watched (interpreted: a replay makes
        # no tensor to watch): no [T, E, C] tensor is made
        with _TecWatch(tokens, M_EXPERTS, c_n) as k_watch:
            run_i(G_STEPS + 1)
        check(not k_watch.hits, "moe: the kernel path made dense [T, E, C] "
              f"tensors: {k_watch.hits[:4]}")

        # the for_test forward from the initial state on both paths
        for n in persist:
            scope.set_var(n, init[n].clone())
        logits_k, = exe.run(test_prog, feed=_train_feed(0),
                            fetch_list=[logits_name], return_numpy=False,
                            compiled=False)
        with _PlainMoe() as plain, _TecWatch(tokens, M_EXPERTS,
                                             c_n) as p_watch:
            logits_p, = exe.run(test_prog, feed=_train_feed(0),
                                fetch_list=[logits_name], return_numpy=False,
                                compiled=False)
        check(plain.calls == M_LAYERS,
              f"moe: {plain.calls} plain MoE FFNs in the for_test forward")
        # the watch's control: the plain composition makes them
        check(len(p_watch.hits) >= M_LAYERS, "moe: the [T, E, C] watch saw "
              f"{len(p_watch.hits)} dense tensors on the plain path")
        check(bool(torch.isfinite(logits_k).all()),
              "moe: non-finite for_test logits")
        logits_rel = float((logits_k - logits_p).abs().max()
                           / logits_p.abs().max())
        logits_ok, logits_lim, logits_rms, logits_rms_lim = _close_bf16(
            logits_k.float(), logits_p.float())
        del logits_k, logits_p

        # the plain path from the same state and feeds, interpreted (its
        # counter ticks at each run of the swapped lowering)
        for n in persist:
            scope.set_var(n, init[n].clone())
        _reset_peak()
        with _PlainMoe() as plain:
            p_loss, p_secs, p_steps = _timed_steps(run_i, counts, G_STEPS)
        p_peak = torch.cuda.max_memory_allocated()
        p_steps = [st["moe"] + st["moe_bwd"] for st in p_steps]
        check(all(st == 0 for st in p_steps),
              f"moe: the plain path launched the MoE kernels {p_steps}")
        check(plain.calls == 2 * M_LAYERS * G_STEPS,
              f"moe: {plain.calls} plain MoE FFNs on the plain path")
        param_rel = _param_rel_diff(scope.find_var, init,
                                    {n: k_params[n] for n in weights})
        with _PlainMoe():
            p_profile = _profile_step(
                lambda: run_i(G_STEPS), ("matmul",), "moe plain",
                gemm_dim=ec_n)
        # the split's control: the plain composition runs such GEMMs
        check(p_profile["gemm_split"]["with_dim_calls"] > 0,
              "moe: the GEMM split saw no E*C operand on the plain path")
        dtypes = {str(scope.find_var(p.name).dtype) for p in params}
        check(dtypes == {"torch.float32"}, f"moe: parameters in {dtypes}")
        del init, k_params
    finally:
        executor_mod.switch_scope(prev_scope)
        if exe is not None:
            exe.close()
        del exe
        torch.cuda.empty_cache()
        fluid.amp.disable_bf16()

    # bf16 logits: the largest error one bf16 ulp of max|plain| and the
    # RMS error 2^-9 of the RMS (the flash phase's bf16 gate; the same
    # comparison on the CPU at a small width is bit-equal: the f32 MoE
    # outputs' summation-order differences vanish in the bf16 residual)
    check(logits_ok, f"moe: for_test logits differ by {logits_rel} of "
          f"max|plain| (limit {logits_lim} absolute, RMS {logits_rms} "
          f"against {logits_rms_lim})")
    diff, lim, unit = _loss_check("moe", k_loss, p_loss, True)
    worst = max(param_rel, key=param_rel.get)
    check(param_rel[worst] <= PARAM_RTOL_BF16, f"moe: weight {worst} moved "
          f"{param_rel[worst]} apart on the kernel and plain paths")
    p_active = active_param_count(M_VOCAB, M_D, M_LAYERS, M_EXPERTS,
                                  M_TOPK, M_SEQ)
    step_s = float(np.median(k_secs[2:]))       # the replays
    p_step_s = float(np.median(p_secs[1:]))
    kern_ms = profile["by_group_ms"].get("moe_dispatch", 0.0)
    bwd_ms = profile["by_group_ms"].get("moe_backward", 0.0)
    emit({"phase": "moe", "card": card, "vocab": M_VOCAB, "d_model": M_D,
          "n_heads": M_HEADS, "n_layers": M_LAYERS, "experts": M_EXPERTS,
          "top_k": M_TOPK, "capacity_factor": M_CF, "capacity": c_n,
          "aux_weight": M_AUX, "seq": M_SEQ, "batch": M_BATCH,
          "dtype": "bf16 amp (MoE FFN float32), f32 master weights",
          "optimizer": "momentum", "params": n_params,
          "params_active": p_active, "startup_s": startup_s,
          "steps": G_STEPS, "mode": "compiled (CUDA graph replay)",
          "kernel_path": {"losses": k_loss, "step_s": k_secs,
                          "launches_per_step": k_steps,
                          "launches": k_total,
                          "backward_launches_per_step": k_bwd,
                          "backward_launches": k_bwd_total,
                          "replayed_kernels_per_step":
                              profile["kind_counts"],
                          "dense_tec_tensors": len(k_watch.hits), **graph},
          "interpreter": {"losses": i_loss, "step_s": i_secs,
                          "launches_per_step": i_steps[0],
                          "bit_equal_to_replay": True},
          **_interpreter_record(i_secs, i_profile),
          "plain_path": {"losses": p_loss, "step_s": p_secs,
                         "mode": "interpreted",
                         "launches_per_step": p_steps,
                         "plain_moe_ffns": plain.calls,
                         "dense_tec_tensors_for_test": len(p_watch.hits),
                         "peak_memory_bytes": p_peak,
                         "tokens_per_s": tokens / p_step_s,
                         "mfu_6np_active_bf16":
                             6.0 * tokens * p_active / p_step_s
                             / peaks[torch.bfloat16],
                         "device_idle_share":
                             1.0 - p_profile["device_ms"] / (p_step_s * 1e3),
                         "profiled_step": p_profile},
          "loss_diff": diff, "loss_limit": lim, "loss_diff_unit": unit,
          "for_test_logits_rel_diff": logits_rel,
          "for_test_logits_rms_err": logits_rms,
          "weight_change_rel_diff": {"max": param_rel[worst],
                                     "argmax": worst,
                                     "n_weights": len(param_rel),
                                     "limit": PARAM_RTOL_BF16},
          "ms_per_step": step_s * 1e3,
          "plain_ms_per_step": p_step_s * 1e3,
          "tokens_per_s": tokens / step_s,
          "mfu_6np_active_bf16": 6.0 * tokens * p_active / step_s
          / peaks[torch.bfloat16],
          "moe_kernel_ms_per_step": kern_ms,
          "moe_backward_kernel_ms_per_step": bwd_ms,
          "moe_kernel_share": (kern_ms + bwd_ms) / (step_s * 1e3),
          "moe_kernel_device_ms_x_launches":
              moe_cases["top2"]["route"]["device_ms"] * 2 * M_LAYERS,
          "profiled_step": profile,
          "device_idle_share": 1.0 - profile["device_ms"] / (step_s * 1e3),
          "peak_memory_bytes": graph["peak_memory_bytes"],
          "peak_reserved_bytes": graph["peak_reserved_bytes"],
          "timing": "host clock around exe.run + synchronize; ms_per_step "
                    "the median of the replayed steps (3..N), the "
                    "interpreter's and the plain path's of steps 2..N; "
                    "the MoE kernels' device time from the profiled "
                    "replay (route + place; the backward kernel); "
                    "gemm_split (of the interpreted kernel-path step and "
                    "the plain path's step): aten mm/bmm/addmm/baddbmm "
                    "device time by whether an operand has an E*C "
                    "dimension (the dense [T, E, C] dispatch/combine "
                    "products and their VJPs)"})
    return k_total, k_bwd_total, profile["kind_counts"]


# -- image phases -------------------------------------------------------------

def _image_program(model, img, classes, dtype, remat=False):
    """benchmark/run_image.py's training Program (`build`, :42-66) for
    `model` ("resnet<depth>" through resnet_imagenet, "alexnet",
    "googlenet", "smallnet", "vgg19", or the book's "vgg16_bn_drop")
    -> (main, startup, loss); `remat` wraps the ResNets' residual blocks
    in recompute segments."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import models
    from paddle_tpu_torch.core import framework as fw

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        data = fluid.layers.data(name="img", shape=[3, img, img],
                                 dtype=dtype)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        if model == "vgg16_bn_drop":
            predict = models.vgg16_bn_drop(data, class_dim=classes)
        elif model == "alexnet":
            predict = models.alexnet(data, class_dim=classes)
        elif model == "googlenet":
            predict = models.googlenet(data, class_dim=classes)
        elif model == "smallnet":
            predict = models.smallnet_mnist_cifar(data, class_dim=classes)
        elif model == "vgg19":
            predict = models.vgg(data, class_dim=classes, depth=19)
        else:
            predict = models.resnet_imagenet(data, class_dim=classes,
                                             depth=int(model[len("resnet"):]),
                                             remat=remat)
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        avg = fluid.layers.mean(cost)
        fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(avg)
    return main, startup, avg


def _image_feed(batch, img, classes, dtype):
    """run_image's feed (:76-79): uniform images from RandomState(0) in
    `dtype` (bf16 as a torch tensor: numpy has no bf16) and int32
    labels, the same every step."""
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.rand(batch, 3, img, img).astype(np.float32))
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    return {"img": x,
            "label": r.randint(0, classes, (batch, 1)).astype(np.int32)}


def _model_flops(program, batch):
    """A training step's model FLOPs from the Program's shapes: 2 x the
    multiply-adds of every conv2d (output positions x filter elements),
    every mul (rows x the weight's elements) and every flash_attention
    (QK^T and PV over the (query, key) pairs causal masking keeps),
    forward x 3 (the backward's data and weight gradients each cost a
    forward)."""
    blk = program.global_block()

    def rows(shape):
        return batch * int(np.prod([d for d in shape if d > 0]))

    fwd = 0
    for op in blk.ops:
        if op.type == "conv2d":
            out = blk.var(op.output("Output")[0]).shape
            w = blk.var(op.input("Filter")[0]).shape
            hw = out[1:3] if op.attrs.get("data_format") == "NHWC" \
                else out[2:4]
            fwd += 2 * batch * int(np.prod(w)) * int(np.prod(hw))
        elif op.type == "mul":
            x = blk.var(op.input("X")[0]).shape
            fwd += 2 * rows(x[:op.attrs.get("x_num_col_dims", 1)]) * \
                int(np.prod(blk.var(op.input("Y")[0]).shape))
        elif op.type == "flash_attention":
            _, sq, h, d = blk.var(op.input("Q")[0]).shape
            sk = blk.var(op.input("K")[0]).shape[1]
            fwd += _flash_work("fwd", batch, sq, sk, h, d,
                               op.attrs.get("causal"), 0)[0]
    return 3 * fwd


def _persistables(program):
    return [v.name for v in program.list_vars() if v.persistable]


def resnet50_phase(card, place, peaks):
    """run_image's ResNet-50, bf16, batch 128, 224x224: G_STEPS steps in
    the Executor's default mode (one compiled block: eager at the miss,
    captured into a CUDA graph at the first hit, replayed after) and a
    profiled replay, then the same steps from the same state
    interpreted (bit for bit the replay's losses, parameters, velocities
    and running statistics), then the default mode again with
    conv_layout=NHWC."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.core.scope import Scope

    phase = "resnet50"
    main, startup, loss = _image_program(f"resnet{R_DEPTH}", R_IMG,
                                         R_CLASSES, "bfloat16")
    blk = main.global_block()
    params = blk.all_parameters()
    check(all(p.dtype == "bfloat16" for p in params),
          f"{phase}: a parameter is not bf16")
    types = [op.type for op in blk.ops]
    persist = _persistables(main)
    flops = _model_flops(main, R_BATCH)
    feed = _image_feed(R_BATCH, R_IMG, R_CLASSES, "bfloat16")
    need = ("conv_fwd", "conv_dgrad", "conv_wgrad", "pooling")
    prev_scope = executor_mod.switch_scope(Scope())
    exe = None
    try:
        scope = fluid.global_scope()
        r = _default_and_interpreter(phase, place, main, startup, loss,
                                     lambda step: feed, need)
        k_loss, k_secs, graph, profile = (r["k_loss"], r["k_secs"],
                                          r["graph"], r["profile"])
        i_loss, i_secs, i_profile = r["i_loss"], r["i_secs"], r["i_profile"]
        startup_s, init = r["startup_s"], r["init"]
        del r

        # the default mode again, the convolutions channels-last
        set_flags({"conv_layout": "NHWC"})
        exe = fluid.Executor(place, seed=SEED)
        for n in persist:
            scope.set_var(n, init[n].clone())
        _reset_peak()
        run_n = lambda step: exe.run(  # noqa: E731
            main, feed=feed, fetch_list=[loss])[0]
        n_loss, n_secs, _ = _timed_steps(run_n, {}, G_STEPS)
        n_peak = torch.cuda.max_memory_allocated()
        n_profile = _profile_step(lambda: run_n(G_STEPS), need, phase)
        del init
    finally:
        set_flags({"conv_layout": ""})
        executor_mod.switch_scope(prev_scope)
        if exe is not None:
            exe.close()
        del exe
        torch.cuda.empty_cache()

    check(all(np.isfinite(k_loss + n_loss)), f"{phase}: non-finite losses "
          f"{k_loss} / {n_loss}")
    check(abs(n_loss[0] - k_loss[0]) <= _bf16_ulp(k_loss[0]),
          f"{phase}: the first NHWC loss {n_loss[0]} is more than one bf16 "
          f"ulp from the NCHW one {k_loss[0]}")
    step_s = float(np.median(k_secs[2:]))       # the replays
    i_step_s = float(np.median(i_secs[1:]))
    n_step_s = float(np.median(n_secs[2:]))
    step_ms = step_s * 1e3
    STEP_MS["resnet50"] = step_ms
    bound_ms = flops / peaks[torch.bfloat16] * 1e3
    emit({"phase": phase, "card": card, "model": f"resnet{R_DEPTH}",
          "source": "benchmark/run_image.py:42-66 (resnet50, defaults "
                    "224x224, 1000 classes, batch 128, --dtype bfloat16)",
          "image": R_IMG, "classes": R_CLASSES, "batch": R_BATCH,
          "dtype": "bfloat16 throughout (image, parameters, velocities)",
          "optimizer": "momentum", "mode": "compiled (CUDA graph replay)",
          "ops": len(types), "conv2d_ops": types.count("conv2d"),
          "batch_norm_ops": types.count("batch_norm"),
          "params": sum(int(np.prod(p.shape)) for p in params
                        if p.trainable),
          "startup_s": startup_s, "steps": G_STEPS,
          "default_mode": {"losses": k_loss, "step_s": k_secs, **graph},
          "interpreter": {"losses": i_loss, "step_s": i_secs,
                          "bit_equal_to_replay": True},
          "ms_per_step": step_ms, "images_per_s": R_BATCH / step_s,
          "interpreted_ms_per_step": i_step_s * 1e3,
          "interpreted_images_per_s": R_BATCH / i_step_s,
          "interpreted_device_idle_share":
              1.0 - i_profile["device_ms"] / (i_step_s * 1e3),
          "interpreted_profiled_step": i_profile,
          "model_flops_per_step": flops,
          "model_flops_share_of_bf16_peak": bound_ms / step_ms,
          "bound_ms": bound_ms, "bound_by": "operations",
          "profiled_step": profile,
          "device_ms_by_group": profile["by_group_ms"],
          "device_idle_share": 1.0 - profile["device_ms"] / step_ms,
          "peak_memory_bytes": graph["peak_memory_bytes"],
          "peak_reserved_bytes": graph["peak_reserved_bytes"],
          "capture_s": graph["capture_s"],
          "conv_layout_nhwc": {
              "losses": n_loss, "step_s": n_secs,
              "ms_per_step": n_step_s * 1e3,
              "images_per_s": R_BATCH / n_step_s,
              "device_ms_by_group": n_profile["by_group_ms"],
              "device_idle_share":
                  1.0 - n_profile["device_ms"] / (n_step_s * 1e3),
              "peak_memory_bytes": n_peak,
              "top_kernels_ms": n_profile["top_kernels_ms"]},
          "groups": "conv_fwd/conv_dgrad/conv_wgrad: cuDNN's kernels by "
                    "pass (fprop, dgrad, wgrad in the name); pooling; "
                    "layout: cuDNN's NCHW<->NHWC transposes; copy: "
                    "memcpy/memset (the state write-back); matmul: the "
                    "fc; other: batch norm, relu, the residual adds, the "
                    "loss and Momentum (elementwise and reductions)",
          "timing": "host clock around exe.run + synchronize; ms_per_step "
                    "the median of the replayed steps (3..N), the "
                    "interpreter's of steps 2..N; device time by group "
                    "from one profiled step (torch.profiler); idle share "
                    "1 - its device time / the median step; "
                    "model FLOPs from the Program's conv2d and mul shapes "
                    "(forward x 3) over the bf16 dense peak"})


def resnet_card_vs_cpu_phase(card, place):
    """ResNet-18 at 64x64, batch 8, float32: C_STEPS steps on the CPU,
    then on the card from the same startup weights, with the caller's
    cuDNN TF32 switch ON (the conv lowering must pin float32 itself):
    losses and every state within CARD_CPU_RTOL.  The CPU tests hold
    the CPU path to the JAX package; this ties the cuDNN route to it."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                             scope_to_numpy)

    phase = "resnet_card_vs_cpu"
    main, startup, loss = _image_program(f"resnet{C_DEPTH}", C_IMG,
                                         C_CLASSES, "float32")
    persist = _persistables(main)
    feed = _image_feed(C_BATCH, C_IMG, C_CLASSES, "float32")
    prev_scope = executor_mod.switch_scope(Scope())
    tf32 = torch.backends.cudnn.allow_tf32
    exe = None
    try:
        cpu = fluid.Executor(fluid.CPUPlace(), seed=SEED)
        cpu.run(startup)
        init = scope_to_numpy(fluid.global_scope(), persist)
        t0 = time.perf_counter()
        cpu_loss = [float(cpu.run(main, feed=feed, fetch_list=[loss])[0][0])
                    for _ in range(C_STEPS)]
        cpu_s = time.perf_counter() - t0
        cpu_state = scope_to_numpy(fluid.global_scope(), persist)

        executor_mod.switch_scope(Scope())
        scope_from_numpy(init, place, fluid.global_scope())
        torch.backends.cudnn.allow_tf32 = True
        exe = fluid.Executor(place, seed=SEED)
        card_loss = [float(exe.run(main, feed=feed, fetch_list=[loss])[0][0])
                     for _ in range(C_STEPS)]
        card_state = scope_to_numpy(fluid.global_scope(), persist)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        executor_mod.switch_scope(prev_scope)
        if exe is not None:
            exe.close()
        del exe

    loss_rel = [abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss)]
    check(all(np.isfinite(card_loss)) and max(loss_rel) <= CARD_CPU_RTOL,
          f"{phase}: card losses {card_loss} against the CPU's {cpu_loss}")
    rel = {n: float(np.abs(card_state[n] - cpu_state[n]).max()
                    / max(1.0, float(np.abs(cpu_state[n]).max())))
           for n in persist}
    worst = max(rel, key=rel.get)
    check(rel[worst] <= CARD_CPU_RTOL, f"{phase}: states differ by more "
          f"than {CARD_CPU_RTOL} of max(1, |CPU|) between the card and the "
          f"CPU: {sorted(rel.items(), key=lambda kv: -kv[1])[:5]}; losses "
          f"{card_loss} / {cpu_loss}")
    emit({"phase": phase, "card": card, "model": f"resnet{C_DEPTH}",
          "image": C_IMG, "classes": C_CLASSES, "batch": C_BATCH,
          "dtype": "float32", "steps": C_STEPS,
          "cudnn_allow_tf32_during_card_run": True,
          "card_losses": card_loss, "cpu_losses": cpu_loss,
          "loss_rel_diff": loss_rel, "states": len(persist),
          "state_max_rel_diff": rel[worst], "state_argmax": worst,
          "limit": CARD_CPU_RTOL, "cpu_s": cpu_s})


def vgg_segmented_phase(card, place):
    """The book's VGG-16 with batch norm and dropout at the CIFAR-10
    width, float32, batch 128, G_STEPS steps in the default mode: its
    dropout ops draw from per-run seeded generators, so on the card the
    block runs segmented (each dropout eagerly between captured device
    segments).  Then the interpreter from the same state, with the same
    executor seed and step count (so the same draws): the same losses
    and the same keep rate."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    phase = "vgg_segmented"
    main, startup, loss = _image_program("vgg16_bn_drop", V_IMG, V_CLASSES,
                                         "float32")
    blk = main.global_block()
    drops = [op for op in blk.ops if op.type == "dropout"]
    mask, prob = drops[0].output("Mask")[0], drops[0].attrs["dropout_prob"]
    persist = _persistables(main)
    feed = _image_feed(V_BATCH, V_IMG, V_CLASSES, "float32")
    prev_scope = executor_mod.switch_scope(Scope())
    exe = None
    runs = {}
    try:
        scope = fluid.global_scope()
        init = None
        for mode in ("segmented", "interpreted"):
            exe = fluid.Executor(place, seed=SEED)
            exe.run(startup)    # both executors count the same steps
            if init is None:
                init = {n: scope.find_var(n).clone() for n in persist}
            for n in persist:
                scope.set_var(n, init[n].clone())
            compiled = None if mode == "segmented" else False
            losses, keeps, secs = [], [], []
            s0, g0 = exe.cache_stats(), exe.graph_stats()
            for _ in range(G_STEPS):
                t0 = time.perf_counter()
                out, m = exe.run(main, feed=feed, fetch_list=[loss, mask],
                                 compiled=compiled)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(out[0]))
                keeps.append(float(m.mean()))
            s1, g1 = exe.cache_stats(), exe.graph_stats()
            runs[mode] = {"losses": losses, "keep_rates": keeps,
                          "step_s": secs,
                          "cache": {k: s1[k] - s0[k] for k in
                                    ("hits", "misses", "entries")},
                          "graphs": {k: g1[k] - g0[k] for k in
                                     ("captures", "replays")}}
            if mode == "segmented":
                segs = exe._segments(blk, exe._fingerprint(main))
            exe.close()
        del init
    finally:
        executor_mod.switch_scope(prev_scope)
        if exe is not None:
            exe.close()
        del exe
        torch.cuda.empty_cache()

    host = [op.type for h, ops, _ in segs if h for op in ops]
    n_device = sum(1 for h, _, _ in segs if not h)
    check(host == ["dropout"] * len(drops) and n_device == len(drops) + 1,
          f"{phase}: host segments run {host}, {n_device} device segments "
          f"for {len(drops)} dropout ops")
    seg = runs["segmented"]
    check(seg["graphs"]["captures"] == n_device
          and seg["cache"]["misses"] == n_device,
          f"{phase}: {seg['graphs']} and {seg['cache']} for {n_device} "
          "device segments")
    check(all(np.isfinite(seg["losses"])), f"{phase}: non-finite losses "
          f"{seg['losses']}")
    check(seg["losses"] == runs["interpreted"]["losses"]
          and seg["keep_rates"] == runs["interpreted"]["keep_rates"],
          f"{phase}: segmented {seg['losses']} / {seg['keep_rates']} "
          f"against interpreted {runs['interpreted']}")
    n_mask = V_BATCH * 64 * V_IMG * V_IMG
    sigma = float(np.sqrt(prob * (1 - prob) / (n_mask * G_STEPS)))
    keep = float(np.mean(seg["keep_rates"]))
    check(abs(keep - (1 - prob)) <= 4 * sigma, f"{phase}: keep rate {keep} "
          f"for dropout_prob {prob} (sigma {sigma})")
    step_s = float(np.median(seg["step_s"][2:]))
    i_step_s = float(np.median(runs["interpreted"]["step_s"][1:]))
    emit({"phase": phase, "card": card, "model": "vgg16_bn_drop",
          "source": "paddle_tpu/models/vgg.py:28 (the book's CIFAR-10 "
                    "model)", "image": V_IMG, "classes": V_CLASSES,
          "batch": V_BATCH, "dtype": "float32", "optimizer": "momentum",
          "dropout_ops": len(drops), "device_segments": n_device,
          "host_segments": len(host), **runs,
          "first_dropout_prob": prob, "keep_rate": keep,
          "keep_rate_sigma": sigma,
          "ms_per_step": step_s * 1e3, "images_per_s": V_BATCH / step_s,
          "interpreted_ms_per_step": i_step_s * 1e3,
          "timing": "host clock around exe.run + synchronize, the fetch "
                    "of the first dropout's mask included; ms_per_step "
                    "the median of the replayed steps (3..N), the "
                    "interpreter's of steps 2..N"})


def image_models_phase(card, place, peaks):
    """The rest of run_image's models at its defaults (batch 128, bf16
    throughout, Momentum): for each, G_STEPS steps in the Executor's
    default mode (one CUDA graph, or with dropout device segments
    captured between the eager dropouts) and a profiled step, then the
    same steps interpreted from the same state and with the same
    executor seed and step count (so the same masks): losses, parameters
    and velocities bit for bit."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    results = {}
    for model, img, classes in IMAGE_MODELS:
        phase = f"image_models/{model}"
        main, startup, loss = _image_program(model, img, classes,
                                             "bfloat16")
        blk = main.global_block()
        n_drop = sum(op.type == "dropout" for op in blk.ops)
        persist = _persistables(main)
        flops = _model_flops(main, I_BATCH)
        feed = _image_feed(I_BATCH, img, classes, "bfloat16")
        prev_scope = executor_mod.switch_scope(Scope())
        exe = None
        runs = {}
        try:
            scope = fluid.global_scope()
            init = None
            for mode in ("default", "interpreted"):
                exe = fluid.Executor(place, seed=SEED)
                exe.run(startup)    # both executors count the same steps
                if init is None:
                    init = {n: scope.find_var(n).clone() for n in persist}
                for n in persist:
                    scope.set_var(n, init[n].clone())
                compiled = None if mode == "default" else False
                _reset_peak()
                s0, g0 = exe.cache_stats(), exe.graph_stats()
                run = lambda step: exe.run(  # noqa: E731
                    main, feed=feed, fetch_list=[loss],
                    compiled=compiled)[0]
                losses, secs, _ = _timed_steps(run, {}, G_STEPS)
                peak = torch.cuda.max_memory_allocated()
                reserved = torch.cuda.max_memory_reserved()
                state = {n: scope.find_var(n).clone() for n in persist}
                s1, g1 = exe.cache_stats(), exe.graph_stats()
                runs[mode] = {
                    "losses": losses, "step_s": secs, "state": state,
                    "peak_memory_bytes": peak,
                    "peak_reserved_bytes": reserved,
                    "cache": {k: s1[k] - s0[k] for k in
                              ("hits", "misses", "entries")},
                    "graphs": {k: g1[k] - g0[k] for k in
                               ("captures", "replays", "capture_s")},
                    "profiled_step": _profile_step(
                        lambda: run(G_STEPS), (), phase)}
                if mode == "default":
                    segs = exe._segments(blk, exe._fingerprint(main))
                exe.close()
            del init
        finally:
            executor_mod.switch_scope(prev_scope)
            if exe is not None:
                exe.close()
            del exe
            torch.cuda.empty_cache()

        dflt, interp = runs["default"], runs["interpreted"]
        host = [op.type for h, ops, _ in segs if h for op in ops]
        n_device = sum(1 for h, _, _ in segs if not h)
        check(host == ["dropout"] * n_drop and n_device == n_drop + 1,
              f"{phase}: host segments run {host}, {n_device} device "
              f"segments for {n_drop} dropout ops")
        check(dflt["graphs"]["captures"] == n_device
              and dflt["cache"]["misses"] == n_device,
              f"{phase}: {dflt['graphs']} and {dflt['cache']} for "
              f"{n_device} device segments")
        check(all(np.isfinite(dflt["losses"])), f"{phase}: non-finite "
              f"losses {dflt['losses']}")
        _bit_equal(phase, dflt["losses"], interp["losses"], dflt["state"],
                   interp["state"].get)
        for r in (dflt, interp):
            del r["state"]
        step_s = float(np.median(dflt["step_s"][2:]))
        i_step_s = float(np.median(interp["step_s"][1:]))
        step_ms = step_s * 1e3
        bound_ms = flops / peaks[torch.bfloat16] * 1e3
        prof = dflt.pop("profiled_step")
        i_prof = interp.pop("profiled_step")
        results[model] = {
            "image": img, "classes": classes, "ops": len(blk.ops),
            "dropout_ops": n_drop, "device_segments": n_device,
            "mode": ("segmented (dropout eager between captured segments)"
                     if n_drop else "compiled (one CUDA graph)"),
            "default_mode": dflt, "interpreter": interp,
            "bit_equal_to_interpreter": True,
            "ms_per_step": step_ms, "images_per_s": I_BATCH / step_s,
            "interpreted_ms_per_step": i_step_s * 1e3,
            "interpreted_images_per_s": I_BATCH / i_step_s,
            "model_flops_per_step": flops, "bound_ms": bound_ms,
            "bound_by": "operations",
            "model_flops_share_of_bf16_peak": bound_ms / step_ms,
            "device_ms": prof["device_ms"],
            "device_ms_by_group": prof["by_group_ms"],
            "top_kernels_ms": prof["top_kernels_ms"],
            "device_idle_share": 1.0 - prof["device_ms"] / step_ms,
            "interpreted_device_idle_share":
                1.0 - i_prof["device_ms"] / (i_step_s * 1e3),
            "peak_memory_bytes": dflt["peak_memory_bytes"]}
    emit({"phase": "image_models", "card": card,
          "source": "benchmark/run_image.py:42-66 (defaults: batch 128, "
                    "--dtype bfloat16; alexnet 227x227, googlenet and "
                    "vgg19 224x224, smallnet 32x32 with 10 classes)",
          "batch": I_BATCH, "steps": G_STEPS,
          "dtype": "bfloat16 throughout (image, parameters, velocities)",
          "optimizer": "momentum", "models": results,
          "timing": "host clock around exe.run + synchronize; ms_per_step "
                    "the median of the default mode's steps 3..N (replays), "
                    "the interpreter's of steps 2..N; device time and "
                    "idle share from one profiled step after them; model "
                    "FLOPs from the Program's conv2d and mul shapes "
                    "(forward x 3) over the bf16 dense peak"})
    return results


def dropout_rows_phase(card, dev):
    """The batch-position-keyed dropout draw on the card against the
    CPU's: the same mask bits for one (seed, shape) at row offset 0, the
    same again from two halves drawn at offsets 0 and rows/2, the op's
    lowering the same on both, and the keep rate within 4 sigma of
    1 - p; with the draw's time."""
    from paddle_tpu_torch.core.execution import ExecContext, _mix
    from paddle_tpu_torch.core.registry import get_op_info
    from paddle_tpu_torch.ops.activation import keyed_uniform_mask

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    info = get_op_info("dropout")
    cases = {}
    for name, shape, p, dtype in DROPOUT_CASES:
        seed = _mix(SEED, len(cases))
        rows, half = shape[0], shape[0] // 2

        def draw(r0, n, where):
            return keyed_uniform_mask((n,) + shape[1:], p, seed, r0, dtype,
                                      where)

        card_mask = draw(0, rows, dev)
        cpu_mask = draw(0, rows, "cpu")
        check(card_mask.dtype == dtype and torch.equal(card_mask.cpu(),
                                                       cpu_mask),
              f"dropout_rows {name}: the card's mask differs from the CPU's")
        halves = torch.cat([draw(0, half, dev), draw(half, rows - half, dev)])
        check(torch.equal(halves, card_mask), f"dropout_rows {name}: two "
              "halves at offsets 0 and rows/2 differ from the whole draw")
        attrs = {**info.attrs, "dropout_prob": p}
        x = torch.ones(shape, dtype=dtype)
        op_card = info.lower(ExecContext(dev, seed=seed), {"X": [x.to(dev)]},
                             attrs)["Mask"]
        op_cpu = info.lower(ExecContext("cpu", seed=seed), {"X": [x]},
                            attrs)["Mask"]
        check(torch.equal(op_card.cpu(), op_cpu), f"dropout_rows {name}: "
              "the op's mask on the card differs from the CPU's")
        n = card_mask.numel()
        keep = float(card_mask.float().mean())
        sigma = float(np.sqrt(p * (1 - p) / n))
        check(abs(keep - (1 - p)) <= 4 * sigma, f"dropout_rows {name}: "
              f"keep rate {keep} for p {p} (sigma {sigma})")
        cases[name] = {"shape": list(shape), "p": p, "dtype": str(dtype),
                       "draws": n, "keep_rate": keep, "sigma": sigma,
                       "ms": cold_ms(lambda: draw(0, rows, dev), 10, flush),
                       "torch_rand_ms": cold_ms(
                           lambda: torch.rand(shape, device=dev), 10,
                           flush)}
    emit({"phase": "dropout_rows", "card": card, "cases": cases,
          "timing": "median of cold-L2 calls, CUDA events: the keyed draw "
                    "(plain integer ops, chunked) beside torch.rand of "
                    "the same shape"})
    return cases

# -- ops phase ---------------------------------------------------------------

def _op_cases():
    """tests/torch_op_cases.py's seeded cases (numpy only)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_op_cases import CASES

    return CASES


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _op_inputs(v):
    """A case slot's inputs: a list of them, or one (an array, or an
    (array, lod) tuple: a LoDTensor)."""
    return v if isinstance(v, list) else [v]


# drawn ops whose draws are a keyed hash of (the op's seed, the global
# row, the sample): the same numbers on the card and on the CPU, so
# their cases are held card against CPU like the others
_KEYED_DRAWS = ("nce",)


def _op_grad_slots(info, case, outs):
    """(input slots the generic gradient differentiates, float output
    slots that take a cotangent), by its rule; ((), ()) when the case has
    no gradient."""
    if info.not_differentiable or (case.random
                                   and case.op not in _KEYED_DRAWS):
        return (), ()
    floats = lambda vs: all(np.issubdtype(  # noqa: E731
        np.asarray(a[0] if isinstance(a, tuple) else a).dtype, np.floating)
        for a in vs)
    ins = (info.diff_inputs if info.diff_inputs is not None
           else [s for s in info.inputs if s in case.ins
                 and floats(_op_inputs(case.ins[s]))])
    ins = [s for s in ins if s in case.ins]
    out = (info.diff_outputs if info.diff_outputs is not None
           else info.outputs)
    out = [s for s in out if s in outs
           and all(v.is_floating_point() for v in outs[s])]
    return (ins, out) if ins and out else ((), ())


def _op_run(case, info, dev, dtype, cots=None):
    """The case's forward on `dev` with float inputs in `dtype` (an
    (array, lod) input as a LoDTensor) -> (outs, the generic gradient
    {slot@GRAD: [...]} for `cots`, or None, each value a tensor: a
    LoDTensor's data, its LoD under the key (slot, i, "lod"))."""
    from paddle_tpu_torch.core.execution import (GRAD, ExecContext,
                                                 generic_grad_lower)
    from paddle_tpu_torch.core.lod import LoDTensor

    def value(a):
        arr, lod = a if isinstance(a, tuple) else (a, None)
        t = torch.from_numpy(np.array(arr)).to(dev)
        t = t.to(dtype) if t.is_floating_point() else t
        return t if lod is None else LoDTensor(t, lod)

    def split(res):
        res = {s: _as_list(v) for s, v in res.items() if v is not None}
        lods = {(s, i, "lod"): v.lod for s, vs in res.items()
                for i, v in enumerate(vs) if isinstance(v, LoDTensor)}
        res = {s: [v.data if isinstance(v, LoDTensor) else v for v in vs]
               for s, vs in res.items()}
        return res, lods

    ins = {slot: [value(a) for a in _op_inputs(v)]
           for slot, v in case.ins.items()}
    attrs = {**info.attrs, **case.attrs}
    outs, lods = split(info.lower(ExecContext(dev), ins, attrs))
    outs["lods"] = lods
    if not cots:
        return outs, None
    g_ins = dict(ins)
    g_ins.update({s: outs[s] for s in info.outputs if s in outs})
    for s, cs in cots.items():
        g_ins[s + GRAD] = [torch.from_numpy(c).to(dev, v.dtype)
                           for c, v in zip(cs, outs[s])]
    grads, g_lods = split(generic_grad_lower(ExecContext(dev), g_ins, attrs,
                                             info))
    grads["lods"] = g_lods
    return outs, grads


def _op_err(card, cpu):
    """Card against CPU: max |card - cpu| over max(1, max |cpu|) for
    floats (the same NaN positions, the same infinities), 0 or inf for
    the rest."""
    card = card.cpu()
    if card.shape != cpu.shape or card.dtype != cpu.dtype:
        return float("inf")
    if not cpu.is_floating_point():
        return 0.0 if torch.equal(card, cpu) else float("inf")
    a, b = card.double(), cpu.double()
    fin = torch.isfinite(b)
    inf = torch.isinf(b)
    if not torch.equal(fin, torch.isfinite(a)) \
            or not torch.equal(torch.isnan(a), torch.isnan(b)) \
            or not torch.equal(a[inf], b[inf]):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    return float((a[fin] - b[fin]).abs().max()
                 / max(1.0, float(b[fin].abs().max())))


def ops_phase(card, dev):
    """Every op type of the corpus (tests/torch_op_cases.py: 89 dense
    types, the 19 LoD sequence and recurrent types, the 4 IfElse
    split and merge types and the 3 CRF types, their attribute,
    boundary and tie cases, LoD inputs as LoDTensors) on the card and on
    the CPU from the same seeded inputs: the forward and, where the op
    has one, the generic gradient (autograd over the lowering, seeded
    cotangents), in float32 with TF32 off, within OPS_RTOL of max(1,
    max |CPU value|); ints and bools exactly.  matmul and cast again
    with bf16 inputs under amp, each element within one bf16 ulp of the
    CPU's.  The drawn op (uniform_random_batch_size_like) is held by
    distribution on the card: its range, mean and variance within 4
    sigma; nce's keyed negatives are the CPU's, so it is held as the
    rest.  `print` writes its lines into a buffer here."""
    import io
    import zlib

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core.registry import get_op_info

    cases = _op_cases()
    t0 = time.perf_counter()
    worst, per_op, random = {"err": 0.0}, {}, {}
    bf16 = {"cases": 0, "outputs": 0, "max_ulps": 0.0}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        for case in cases:
            info = get_op_info(case.op)
            if case.random and case.op not in _KEYED_DRAWS:
                out = _op_run(case, info, dev, torch.float32)[0]["Out"][0]
                lo, hi = case.attrs["min"], case.attrs["max"]
                n = out.numel()
                mu, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
                mean, v = float(out.mean()), float(out.var())
                check(out.is_cuda and float(out.min()) >= lo
                      and float(out.max()) < hi
                      and abs(mean - mu) <= 4 * np.sqrt(var / n)
                      and abs(v - var) <= 4 * var * np.sqrt(0.8 / n),
                      f"ops {case.name}: the card's draws {mean} / {v} "
                      f"against U[{lo}, {hi})")
                random[case.name] = {"draws": n, "mean": mean, "var": v,
                                     "want_mean": mu, "want_var": var}
                per_op.setdefault(case.op, 0)
                continue
            cpu_outs = _op_run(case, info, "cpu", torch.float32)[0]
            cpu_outs.pop("lods")
            _, out_slots = _op_grad_slots(info, case, cpu_outs)
            r = np.random.RandomState(zlib.crc32(case.name.encode()))
            cots = {s: [r.standard_normal(tuple(v.shape)).astype(np.float32)
                        for v in cpu_outs[s]] for s in out_slots}
            cpu_outs, cpu_g = _op_run(case, info, "cpu", torch.float32, cots)
            card_outs, card_g = _op_run(case, info, dev, torch.float32, cots)
            check(set(card_outs) == set(cpu_outs) and set(card_g or {})
                  == set(cpu_g or {}), f"ops {case.name}: slots differ")
            check(card_outs.pop("lods") == cpu_outs.pop("lods")
                  and (card_g or {}).pop("lods", None)
                  == (cpu_g or {}).pop("lods", None),
                  f"ops {case.name}: the card's LoDs differ from the CPU's")
            pairs = [(f"{s}[{i}]", a, b) for s in cpu_outs
                     for i, (a, b) in enumerate(zip(card_outs[s],
                                                    cpu_outs[s]))]
            pairs += [(f"{s}[{i}]", a, b) for s in (cpu_g or {})
                      for i, (a, b) in enumerate(zip(card_g[s], cpu_g[s]))
                      if b is not None]
            for what, a, b in pairs:
                err = _op_err(a, b)
                check(err <= OPS_RTOL, f"ops {case.name} {what}: card "
                      f"against CPU {err} > {OPS_RTOL}")
                if err >= worst["err"]:
                    worst = {"err": err, "case": case.name, "slot": what}
            per_op[case.op] = per_op.get(case.op, 0) + len(pairs)
        with amp.bf16_guard():
            for case in cases:
                if case.op not in ("matmul", "cast"):
                    continue
                info = get_op_info(case.op)
                cpu_outs = _op_run(case, info, "cpu", torch.bfloat16)[0]
                cpu_outs.pop("lods")
                _, out_slots = _op_grad_slots(info, case, cpu_outs)
                cots = {s: [np.ones(tuple(v.shape), np.float32)
                            for v in cpu_outs[s]] for s in out_slots}
                cpu_outs, cpu_g = _op_run(case, info, "cpu", torch.bfloat16,
                                          cots)
                card_outs, card_g = _op_run(case, info, dev, torch.bfloat16,
                                            cots)
                for res in (cpu_outs, cpu_g, card_outs, card_g):
                    (res or {}).pop("lods", None)
                pairs = [(a, b) for s in cpu_outs
                         for a, b in zip(card_outs[s], cpu_outs[s])]
                pairs += [(a, b) for s in (cpu_g or {})
                          for a, b in zip(card_g[s], cpu_g[s])
                          if b is not None]
                for a, b in pairs:
                    a = a.cpu()
                    if b.is_floating_point():
                        top = torch.maximum(a.float().abs(), b.float().abs())
                        ulps = float(((a.float() - b.float()).abs()
                                      / torch.exp2(torch.floor(torch.log2(
                                          top.clamp(min=1e-30))) - 7))
                                     .max()) if a.numel() else 0.0
                    else:
                        ulps = 0.0 if torch.equal(a, b) else float("inf")
                    check(ulps <= 1.0 and a.dtype == b.dtype,
                          f"ops {case.name} (bf16 amp): card and CPU "
                          f"differ by {ulps} bf16 ulps")
                    bf16["max_ulps"] = max(bf16["max_ulps"], ulps)
                if case.op == "matmul":
                    check(all(v.dtype == torch.bfloat16
                              for vs in card_outs.values() for v in vs),
                          f"ops {case.name}: amp matmul output not bf16")
                bf16["cases"] += 1
                bf16["outputs"] += len(pairs)
    check(len(per_op) == OPS_TYPES, f"ops: {len(per_op)} op types checked, "
          f"want the corpus's {OPS_TYPES}")
    emit({"phase": "ops", "card": card, "op_types": len(per_op),
          "cases": len(cases), "compared_tensors": sum(per_op.values()),
          "tolerance": f"{OPS_RTOL} of max(1, max|CPU|) in float32, TF32 "
                       "off; ints and bools exact",
          "worst": worst, "bf16_amp": {"ops": ["matmul", "cast"],
                                       "tolerance": "one bf16 ulp", **bf16},
          "random": random, "printed_lines": len(
              printed.getvalue().splitlines()),
          "seconds": time.perf_counter() - t0})
    return worst


# -- lm_dropout phase --------------------------------------------------------

# the LM trained with dropout: run_ridge's width, dropout_rate 0.1 (the
# embedding's, each FFN's and each attention's weights, the composed path)
LD_RATE = 0.1


def _composed_attention_ms(dev, flush):
    """The composed attention (transpose, scale, matmul, + causal mask,
    softmax, dropout, matmul, transpose; the ops' own lowerings under
    amp) at the flash shape [8, 512, 16, 128] with bf16 q, k, v -> (fwd
    ms, fwd + bwd ms), cold L2, CUDA events; the backward by autograd
    over the same lowerings."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core.execution import ExecContext
    from paddle_tpu_torch.core.registry import get_op_info

    def op(t):
        info = get_op_info(t)
        return lambda ctx, ins, **a: info.lower(ctx, ins,
                                                {**info.attrs, **a})

    tr, sc, mm, add, sm, dr = (op(t) for t in (
        "transpose", "scale", "matmul", "elementwise_add", "softmax",
        "dropout"))
    b, s, h, d = FLASH_SHAPE
    gen = torch.Generator().manual_seed(SEED)
    q, k, v = (torch.randn((b, s, h, d), generator=gen).to(
        dev, torch.bfloat16).requires_grad_(True) for _ in range(3))
    mask = torch.triu(torch.full((s, s), -1e9, device=dev), 1)
    ctx = ExecContext(dev, seed=SEED)
    perm = [0, 2, 1, 3]

    def fwd():
        qt = tr(ctx, {"X": [q]}, axis=perm)["Out"]
        kt = tr(ctx, {"X": [k]}, axis=perm)["Out"]
        vt = tr(ctx, {"X": [v]}, axis=perm)["Out"]
        p = mm(ctx, {"X": [sc(ctx, {"X": [qt]}, scale=d ** -0.5)["Out"]],
                     "Y": [kt]}, transpose_Y=True)["Out"]
        p = add(ctx, {"X": [p], "Y": [mask]}, axis=2)["Out"]
        w = dr(ctx, {"X": [sm(ctx, {"X": [p]})["Out"]]},
               dropout_prob=LD_RATE)["Out"]
        o = mm(ctx, {"X": [w], "Y": [vt]})["Out"]
        return tr(ctx, {"X": [o]}, axis=perm)["Out"]

    with amp.bf16_guard():
        with torch.no_grad():
            f_ms = cold_ms(fwd, 10, flush)
        do = torch.randn((b, s, h, d), generator=gen).to(dev, torch.bfloat16)
        fb_ms = cold_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), do),
                        10, flush)
    return f_ms, fb_ms


def lm_dropout_phase(card, place, dev, flash_cases):
    """The run_ridge LM at full width under bf16 amp with dropout_rate
    0.1, the attention weights' included: the composed attention path,
    whose dropouts run eagerly between captured device segments in the
    Executor's default mode.  T_STEPS steps in the default mode and a
    profiled step, then the same steps interpreted from the same state
    with the same executor seed and step count (so the same draws):
    losses and parameters bit for bit; the loss finite and falling; the
    first attention dropout's keep rate within 4 sigma of 1 - 0.1 over
    its draws.  Then, with every dropout_prob set to 0, one interpreted
    step of the composed path against one of the flash path
    (dropout_rate 0) from the same state: loss within one bf16 ulp,
    every weight matrix's change within PARAM_RTOL_BF16.  Beside it the
    composed attention's time and the flash kernels' at [8, 512, 16,
    128]."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    phase = "lm_dropout"
    fluid.amp.enable_bf16()     # before the Programs are built
    prev_scope = executor_mod.switch_scope(Scope())
    exe = None
    runs = {}
    try:
        main, startup, loss = _lm_program(
            fluid.Momentum(learning_rate=0.01, momentum=0.9), LD_RATE)
        blk = main.global_block()
        drops = [op for op in blk.ops if op.type == "dropout"]
        attn = [op for op in drops
                if len(blk.var(op.input("X")[0]).shape) == 4]
        check(len(attn) == T_LAYERS and len(drops) == 2 * T_LAYERS + 1
              and not any(op.type == "flash_attention" for op in blk.ops),
              f"{phase}: {len(drops)} dropouts, {len(attn)} over attention "
              "weights, or a flash_attention op")
        mask = attn[0].output("Mask")[0]
        persist = _persistables(main)
        weights = [p.name for p in blk.all_parameters() if len(p.shape) == 2]
        scope = fluid.global_scope()
        init = None
        for mode in ("segmented", "interpreted"):
            exe = fluid.Executor(place, seed=SEED)
            exe.run(startup)    # both executors count the same steps
            if init is None:
                init = {n: scope.find_var(n).clone() for n in persist}
            for n in persist:
                scope.set_var(n, init[n].clone())
            compiled = None if mode == "segmented" else False
            _reset_peak()
            losses, keeps, secs = [], [], []
            s0, g0 = exe.cache_stats(), exe.graph_stats()
            for step in range(T_STEPS):
                t0 = time.perf_counter()
                out, m = exe.run(main, feed=_train_feed(step),
                                 fetch_list=[loss, mask], compiled=compiled,
                                 return_numpy=False)
                keeps.append(float(m.float().mean()))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(out.reshape(-1)[0]))
                del m
            s1, g1 = exe.cache_stats(), exe.graph_stats()
            rec = {"losses": losses, "keep_rates": keeps, "step_s": secs,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                   "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
                   "cache": {k: s1[k] - s0[k] for k in
                             ("hits", "misses", "entries")},
                   "graphs": {k: g1[k] - g0[k] for k in
                              ("captures", "replays", "capture_s")}}
            rec["profiled_step"] = _profile_step(
                lambda: exe.run(main, feed=_train_feed(T_STEPS),
                                fetch_list=[loss], compiled=compiled),
                ("matmul",), phase)
            if mode == "segmented":
                segs = exe._segments(blk, exe._fingerprint(main))
                state = {n: scope.find_var(n).clone() for n in weights}
            else:
                rec["params_bit_equal"] = not [
                    n for n in weights
                    if not torch.equal(state[n], scope.find_var(n))]
            runs[mode] = rec
            exe.close()
        del state

        # composed (every dropout_prob 0) against flash, one interpreted
        # step each from the same state
        for op in drops:
            op.attrs["dropout_prob"] = 0.0
        fmain, fstartup, floss = _lm_program(
            fluid.Momentum(learning_rate=0.01, momentum=0.9), 0.0)
        check(sorted(p.name for p in fmain.global_block().all_parameters())
              == sorted(p.name for p in blk.all_parameters()),
              f"{phase}: the flash and composed Programs' parameters differ")
        zeroed = {}
        for name, prog, lss in (("composed", main, loss),
                                ("flash", fmain, floss)):
            for n in persist:
                scope.set_var(n, init[n].clone())
            exe = fluid.Executor(place, seed=SEED)
            t0 = time.perf_counter()
            out = exe.run(prog, feed=_train_feed(0), fetch_list=[lss],
                          compiled=False)[0]
            torch.cuda.synchronize()
            zeroed[name] = {"loss": float(out.reshape(-1)[0]),
                            "step_s": time.perf_counter() - t0,
                            "after": {n: scope.find_var(n).clone()
                                      for n in weights}}
            exe.close()
        rel = {}
        for n in weights:
            d_c = zeroed["composed"]["after"][n] - init[n]
            d_f = zeroed["flash"]["after"][n] - init[n]
            rel[n] = float((d_c - d_f).norm() / d_f.norm())
        for z in zeroed.values():
            del z["after"]
        del init
    finally:
        executor_mod.switch_scope(prev_scope)
        if exe is not None:
            exe.close()
        del exe
        torch.cuda.empty_cache()
        fluid.amp.disable_bf16()

    seg, interp = runs["segmented"], runs["interpreted"]
    host = [op.type for h, ops, _ in segs if h for op in ops]
    n_device = sum(1 for h, _, _ in segs if not h)
    check(host == ["dropout"] * len(drops) and n_device == len(drops) + 1,
          f"{phase}: host segments run {host}, {n_device} device segments "
          f"for {len(drops)} dropout ops")
    check(all(np.isfinite(seg["losses"])) and seg["losses"][-1]
          < seg["losses"][0], f"{phase}: losses {seg['losses']} not finite "
          "or not falling")
    check(seg["losses"] == interp["losses"]
          and seg["keep_rates"] == interp["keep_rates"]
          and interp["params_bit_equal"],
          f"{phase}: segmented {seg['losses']} / {seg['keep_rates']} "
          f"against interpreted {interp['losses']} / "
          f"{interp['keep_rates']} (parameters bit-equal: "
          f"{interp['params_bit_equal']})")
    n_mask = T_BATCH * T_HEADS * T_SEQ * T_SEQ
    sigma = float(np.sqrt(LD_RATE * (1 - LD_RATE) / (n_mask * T_STEPS)))
    keep = float(np.mean(seg["keep_rates"]))
    check(abs(keep - (1 - LD_RATE)) <= 4 * sigma, f"{phase}: attention "
          f"keep rate {keep} (sigma {sigma})")
    z_c, z_f = zeroed["composed"]["loss"], zeroed["flash"]["loss"]
    loss_ulps = abs(z_c - z_f) / _bf16_ulp(z_f)
    worst = max(rel, key=rel.get)
    check(np.isfinite(z_c) and loss_ulps <= LOSS_ULPS_BF16
          and rel[worst] <= PARAM_RTOL_BF16,
          f"{phase}: with the draws zeroed the composed path's loss {z_c} "
          f"is {loss_ulps} bf16 ulps from the flash path's {z_f}, or "
          f"weight {worst} moved {rel[worst]} apart")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    c_fwd, c_fwd_bwd = _composed_attention_ms(dev, flush)
    fc = flash_cases["bf16_causal"]
    step_s = float(np.median(seg["step_s"][2:]))
    i_step_s = float(np.median(interp["step_s"][1:]))
    prof = seg["profiled_step"]
    emit({"phase": phase, "card": card, "vocab": T_VOCAB, "d_model": T_D,
          "n_heads": T_HEADS, "n_layers": T_LAYERS, "seq": T_SEQ,
          "batch": T_BATCH, "dtype": "bf16 amp, f32 master weights",
          "optimizer": "momentum", "dropout_rate": LD_RATE,
          "dropout_ops": len(drops), "attention_dropout_ops": len(attn),
          "mode": "segmented (dropouts eager between captured segments)",
          "device_segments": n_device, "host_segments": len(host),
          "steps": T_STEPS, "segmented": seg, "interpreted": interp,
          "keep_rate": keep, "keep_rate_sigma": sigma,
          "ms_per_step": step_s * 1e3,
          "interpreted_ms_per_step": i_step_s * 1e3,
          "tokens_per_s": T_BATCH * T_SEQ / step_s,
          "device_ms": prof["device_ms"],
          "device_idle_share": 1.0 - prof["device_ms"] / (step_s * 1e3),
          "interpreted_device_idle_share":
              1.0 - interp["profiled_step"]["device_ms"] / (i_step_s * 1e3),
          "peak_memory_bytes": seg["peak_memory_bytes"],
          "peak_reserved_bytes": seg["peak_reserved_bytes"],
          "draws_zeroed": {"composed": zeroed["composed"],
                           "flash": zeroed["flash"],
                           "loss_diff_bf16_ulps": loss_ulps,
                           "loss_limit_ulps": LOSS_ULPS_BF16,
                           "weight_change_rel_diff": {
                               "max": rel[worst], "argmax": worst,
                               "n_weights": len(rel),
                               "limit": PARAM_RTOL_BF16}},
          "attention_ms": {
              "shape_bshd": list(FLASH_SHAPE), "dtype": "bf16 (amp)",
              "causal": True, "composed_fwd": c_fwd,
              "composed_fwd_bwd": c_fwd_bwd,
              "flash_fwd": fc["fwd"]["ms"],
              "flash_fwd_bwd": fc["fwd"]["ms"] + fc["bwd_ms"],
              "composed_over_flash_fwd": c_fwd / fc["fwd"]["ms"],
              "composed_over_flash_fwd_bwd":
                  c_fwd_bwd / (fc["fwd"]["ms"] + fc["bwd_ms"])},
          "timing": "host clock around exe.run + synchronize, the fetch of "
                    "the first attention mask's mean included; ms_per_step "
                    "the median of the default mode's steps 3..N (replays "
                    "between the eager dropouts), the interpreter's of "
                    "steps 2..N; device time and idle share from one "
                    "profiled step after them; peak memory over each "
                    "mode's steps; attention times: median of cold-L2 "
                    "calls, CUDA events, the composed chain's backward by "
                    "autograd, the flash kernels from the flash phase"})
    return seg


# -- optimizers and ctr phases ------------------------------------------------

def _zipf_rows(rng, n):
    """`n` ids in [0, X_ROWS), Zipf-like (a = X_ZIPF): id 1 about a tenth
    of them, a long tail of ids seen once."""
    return (rng.zipf(X_ZIPF, n) % X_ROWS).astype(np.int64)


def _opt_inputs(op, grad, dtype, rng):
    """{slot: [value]} on the CPU for update op `op` at one CTR table's
    shape [X_ROWS, X_EMBED]: the parameter and a dense gradient N(0, 1),
    or a SelectedRows of X_BATCH Zipf rows; every other float state
    U(0.5, 1.5) (positive: a valid second moment, and a valid first one);
    all stored in `dtype` but the learning rate 0.05 and the beta powers
    (float32, as the optimizers keep them); average_accumulates' sums
    float32 and its counters int32 (ModelAverage's)."""
    from paddle_tpu_torch.core.lod import SelectedRows
    from paddle_tpu_torch.core.registry import get_op_info

    shape = (X_ROWS, X_EMBED)
    out = {}
    for slot in get_op_info(op).inputs:
        if slot == "LearningRate":
            v = torch.tensor([0.05])
        elif slot in ("Beta1Pow", "Beta2Pow"):
            v = torch.tensor([(0.9 if slot == "Beta1Pow" else 0.999) ** 3])
        elif slot.startswith("InNum") or slot == "InOldNumAccumulates":
            v = torch.tensor([{"InNumAccumulates": 3, "InNumUpdates": 5}
                              .get(slot, 2)], dtype=torch.int32)
        elif slot == "Grad" and grad == "sparse":
            v = SelectedRows(torch.from_numpy(_zipf_rows(rng, X_BATCH)),
                             torch.from_numpy(rng.standard_normal(
                                 (X_BATCH, X_EMBED)).astype(np.float32))
                             .to(dtype), X_ROWS)
        elif slot in ("Param", "Grad"):
            v = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dtype)
        else:
            v = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(
                np.float32))
            if not slot.startswith("InSum"):
                v = v.to(dtype)
        out[slot] = [v]
    return out


def _to_dev(v, dev):
    from paddle_tpu_torch.core.lod import SelectedRows

    if isinstance(v, SelectedRows):
        return v.map(lambda t: t.to(dev))
    return v.to(dev)


def optimizers_phase(card, dev):
    """Each of the 12 update ops (ops/optimizer_ops.py) at one CTR
    table's shape [38462, 10], float32 and bf16 storage, with a dense and
    a Zipf-duplicated SelectedRows gradient (2048 rows; average_
    accumulates takes none): the card against the CPU from the same
    seeded inputs within OPT_RTOL of max(1, max |CPU value|), two card
    calls bit-equal (no atomics: the SelectedRows are made dense, and
    sgd's scatter done, by sorted segment sums), every output stored in
    its input's dtype; and each call's time between CUDA events."""
    from paddle_tpu_torch.core.execution import ExecContext
    from paddle_tpu_torch.core.registry import get_op_info
    from paddle_tpu_torch.ops.optimizer_ops import UPDATE_OPS

    import zlib

    phase, t0 = "optimizers", time.perf_counter()
    cases, worst = {}, {"err": 0.0}
    for op in UPDATE_OPS:
        info = get_op_info(op)
        attrs = {**info.attrs, **OPT_ATTRS.get(op, {})}
        grads = ("dense",) if op == "average_accumulates" else ("dense",
                                                                "sparse")
        for grad in grads:
            for dtype in (torch.float32, torch.bfloat16):
                name = f"{op}/{grad}/{str(dtype)[6:]}"
                rng = np.random.RandomState(zlib.crc32(name.encode()))
                ins = _opt_inputs(op, grad, dtype, rng)
                dins = {s: [_to_dev(v, dev) for v in vs]
                        for s, vs in ins.items()}
                cpu = info.lower(ExecContext("cpu"), ins, attrs)
                first = info.lower(ExecContext(dev), dins, attrs)
                again = info.lower(ExecContext(dev), dins, attrs)
                errs = {}
                for slot, want in cpu.items():
                    src = ins[info.inplace[slot]][0]
                    got = first[slot]
                    check(got.dtype == want.dtype == src.dtype,
                          f"{phase}: {name} {slot} is {got.dtype}, stored "
                          f"{src.dtype}")
                    check(torch.equal(got, again[slot]), f"{phase}: {name} "
                          f"{slot} differs between two card calls")
                    m = max(1.0, float(want.double().abs().max()))
                    errs[slot] = float((got.cpu().double() - want.double())
                                       .abs().max()) / m
                    check(errs[slot] <= OPT_RTOL, f"{phase}: {name} {slot} "
                          f"is {errs[slot]} of max(1, |CPU|) off the CPU "
                          f"(limit {OPT_RTOL})")
                    if errs[slot] > worst["err"]:
                        worst = {"err": errs[slot], "case": name,
                                 "slot": slot}
                call = lambda: info.lower(  # noqa: E731
                    ExecContext(dev), dins, attrs)
                for _ in range(2):
                    call()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(10):
                    call()
                b.record()
                torch.cuda.synchronize()
                case = {"max_rel_err": errs, "ms": a.elapsed_time(b) / 10}
                if grad == "sparse":
                    rows = ins["Grad"][0].rows
                    case["rows"] = int(rows.numel())
                    case["unique_rows"] = int(torch.unique(rows).numel())
                cases[name] = case
    emit({"phase": phase, "card": card, "ops": list(UPDATE_OPS),
          "shape": [X_ROWS, X_EMBED], "sparse_rows": X_BATCH,
          "zipf_a": X_ZIPF, "cases": cases, "worst": worst,
          "limit": OPT_RTOL, "repeat_bit_equal": True,
          "seconds": time.perf_counter() - t0,
          "timing": "CUDA events around 10 back-to-back calls of the "
                    "op's lowering (the f32 wrapper included) after 2 "
                    "warm-up calls, warm L2; ms is a call's share"})


def _ctr_program(model, is_sparse, optimizer, with_opt=False):
    """models/ctr.py's `model` at the CTR configuration, its loss the
    mean of sigmoid_cross_entropy_with_logits (tests/test_ctr.py:39-40),
    minimized by `optimizer(fluid)` -> (main, startup, loss), and
    minimize's (optimize ops, params and grads) with `with_opt`."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.models import ctr

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        slots = [fluid.layers.data(name=f"slot{i}", shape=[1],
                                   dtype="int64") for i in range(X_SLOTS)]
        dense = fluid.layers.data(name="dense", shape=[X_DENSE],
                                  dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        _, logit = getattr(ctr, model)(
            slots, [X_ROWS] * X_SLOTS, dense_input=dense,
            embed_dim=X_EMBED, hidden_sizes=X_HIDDEN, is_sparse=is_sparse)
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(logit, label))
        opt = optimizer(fluid).minimize(loss)
    return (main, startup, loss, opt) if with_opt else (main, startup, loss)


def _ctr_feeds(n):
    """`n` seeded batches (host tensors): Zipf ids a slot, U(0, 1) dense
    features, clicks by tests/test_ctr.py's rule (slot 0 and slot 1 of
    one parity, and the first dense feature above 0.5)."""
    rng = np.random.RandomState(SEED)
    feeds = []
    for _ in range(n):
        ids = [_zipf_rows(rng, X_BATCH).reshape(-1, 1)
               for _ in range(X_SLOTS)]
        dense = rng.rand(X_BATCH, X_DENSE).astype(np.float32)
        p = 0.15 + 0.6 * ((ids[0] % 2) == (ids[1] % 2)) + 0.2 * (
            dense[:, :1] > 0.5)
        label = (rng.rand(X_BATCH, 1) < p).astype(np.float32)
        feed = {f"slot{i}": torch.from_numpy(v) for i, v in enumerate(ids)}
        feed["dense"] = torch.from_numpy(dense)
        feed["label"] = torch.from_numpy(label)
        feeds.append(feed)
    return feeds


def _states_rel_diff(got, want):
    """{name: max |got - want| / max(1, max |want|)} over float states."""
    return {n: float((got[n].double() - want[n].double()).abs().max())
            / max(1.0, float(want[n].double().abs().max()))
            for n in want if want[n].is_floating_point()}


def ctr_phase(card, place):
    """DeepFM and wide&deep (models/ctr.py, every slot an is_sparse
    embedding) at the CTR configuration.  Each model: G_STEPS Adam steps
    in the Executor's default mode (one compiled block, captured into a
    CUDA graph at the first hit and replayed after; a profiled replay),
    then the same steps interpreted from the same state (bit for bit
    the replay's losses and states), then the is_sparse=False Program in
    the default mode (bit for bit the sparse one's), then X_CPU_STEPS
    steps on the CPU against the card (losses and Adam's states within
    X_CPU_RTOL, the parameters too unless a ReLU flipped: see
    X_CPU_RTOL), then one sparse SGD step twice from the same state
    (bit-equal; a table row no id names unchanged)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    adam = lambda f: f.Adam(learning_rate=X_LR)  # noqa: E731
    sgd = lambda f: f.SGD(learning_rate=0.1)  # noqa: E731
    feeds = _ctr_feeds(G_STEPS + 1)
    unique = [int(np.unique(f["slot0"].numpy()).size) for f in feeds]
    for model in X_MODELS:
        phase = f"ctr_{model}"
        t_phase = time.perf_counter()
        main, startup, loss = _ctr_program(model, True, adam)
        blk = main.global_block()
        types = [op.type for op in blk.ops]
        grads = [op for op in blk.ops if op.type == "lookup_table_grad"]
        check(len(grads) == 2 * X_SLOTS
              and all(op.attrs["is_sparse"] for op in grads),
              f"{phase}: {len(grads)} embedding gradients, want "
              f"{2 * X_SLOTS} sparse")
        persist = _persistables(main)
        tables = sorted({op.input("W")[0] for op in grads})
        prev_scope = executor_mod.switch_scope(Scope())
        exe = None
        try:
            scope = fluid.global_scope()
            r = _default_and_interpreter(
                phase, place, main, startup, loss, lambda step: feeds[step],
                ("matmul", "sort_segment"), i_need=("matmul",))
            k_loss, k_secs, graph, profile = (r["k_loss"], r["k_secs"],
                                              r["graph"], r["profile"])
            i_loss, i_secs = r["i_loss"], r["i_secs"]
            i_profile, k_state = r["i_profile"], r["k_state"]
            startup_s, init = r["startup_s"], r["init"]
            del r

            def restore():
                for n in persist:
                    scope.set_var(n, init[n].clone())

            # the dense gradient, default mode, from the same state
            d_main, _, d_lossv = _ctr_program(model, False, adam)
            check(sorted(_persistables(d_main)) == sorted(persist),
                  f"{phase}: the is_sparse=False Program has other states")
            exe = fluid.Executor(place, seed=SEED)
            restore()
            d_loss = [float(exe.run(d_main, feed=feeds[s],
                                    fetch_list=[d_lossv])[0][0])
                      for s in range(G_STEPS)]
            check(d_loss == k_loss, f"{phase}: is_sparse=False losses "
                  f"{d_loss} differ from is_sparse=True's {k_loss}")
            diff = [n for n in persist
                    if not torch.equal(scope.find_var(n), k_state[n])]
            check(not diff, f"{phase}: is_sparse=False and True states "
                  f"differ after {G_STEPS} steps: {diff[:5]}")
            del k_state
            exe.close()

            # the card against the CPU, at this width, with the MLP's
            # ReLU outputs
            relus = [op.output("Out")[0] for op in blk.ops
                     if op.type == "relu"]
            exe = fluid.Executor(place, seed=SEED)
            restore()
            c_out = [exe.run(main, feed=feeds[s], fetch_list=[loss] + relus,
                             compiled=False) for s in range(X_CPU_STEPS)]
            c_loss = [float(o[0][0]) for o in c_out]
            card_state = {n: scope.find_var(n).cpu() for n in persist}
            exe.close()
            executor_mod.switch_scope(Scope())
            cpu_scope = fluid.global_scope()
            for n in persist:
                cpu_scope.set_var(n, init[n].cpu())
            cpu = fluid.Executor(fluid.CPUPlace(), seed=SEED)
            t0 = time.perf_counter()
            cpu_out = [cpu.run(main, feed=feeds[s],
                               fetch_list=[loss] + relus)
                       for s in range(X_CPU_STEPS)]
            cpu_s = time.perf_counter() - t0
            cpu_loss = [float(o[0][0]) for o in cpu_out]
            cpu_state = {n: cpu_scope.find_var(n) for n in persist}
            flips = [int(sum(((a > 0) != (b > 0)).sum()
                             for a, b in zip(c[1:], h[1:])))
                     for c, h in zip(c_out, cpu_out)]
            loss_rel = [abs(a - b) / abs(b) for a, b in zip(c_loss,
                                                           cpu_loss)]
            check(c_loss == k_loss[:X_CPU_STEPS],
                  f"{phase}: the interpreter's first losses {c_loss} are "
                  f"not the replay's {k_loss[:X_CPU_STEPS]}")
            check(max(loss_rel) <= X_CPU_RTOL, f"{phase}: card losses "
                  f"{c_loss} against the CPU's {cpu_loss}")
            rel = _states_rel_diff(card_state, cpu_state)
            param_names = {p.name for p in blk.all_parameters()}
            held = [n for n in rel if n not in param_names or not
                    any(flips)]
            worst = max(held, key=rel.get)
            top = sorted(held, key=rel.get, reverse=True)[:5]
            check(rel[worst] <= X_CPU_RTOL, f"{phase}: states differ by "
                  f"more than {X_CPU_RTOL} of max(1, |CPU|) between the "
                  f"card and the CPU ({sum(flips)} ReLU flips): "
                  f"{[(n, rel[n]) for n in top]}")
            p_worst = max(param_names, key=rel.get)
            beyond = sum(int(((card_state[n].double() - cpu_state[n]
                               .double()).abs() > X_CPU_RTOL * max(
                                   1.0, float(cpu_state[n].abs().max())))
                              .sum()) for n in param_names)
            del card_state, cpu_state
            executor_mod.switch_scope(scope)

            # one sparse SGD step, twice from the same state: the
            # parameters the Adam run started from, the SGD startup's
            # learning rate
            s_main, s_startup, s_loss = _ctr_program(model, True, sgd)
            s_blk = s_main.global_block()
            s_params = {p.name for p in s_blk.all_parameters()}
            s_persist = _persistables(s_main)
            s_tables = sorted({op.input("Param")[0] for op in s_blk.ops
                               if op.type == "sgd"} & set(tables))
            exe = fluid.Executor(place, seed=SEED)
            exe.run(s_startup)
            s_init = {n: (init[n] if n in s_params else scope.find_var(n))
                      .clone() for n in s_persist}
            after = []
            for _ in range(2):
                for n in s_persist:
                    scope.set_var(n, s_init[n].clone())
                exe.run(s_main, feed=feeds[0], fetch_list=[s_loss],
                        compiled=False)
                after.append({n: scope.find_var(n).clone()
                              for n in s_persist})
            diff = [n for n in after[0]
                    if not torch.equal(after[0][n], after[1][n])]
            check(not diff, f"{phase}: one sparse SGD step from the same "
                  f"state gave other bits twice: {diff[:5]}")
            slot_of = {op.input("W")[0]: op.input("Ids")[0] for op in grads}
            moved = 0
            for t in s_tables:
                ids = np.unique(feeds[0][slot_of[t]].numpy())
                keep = torch.ones(X_ROWS, dtype=torch.bool)
                keep[torch.from_numpy(ids)] = False
                keep = keep.to(init[t].device)
                check(torch.equal(after[0][t][keep], init[t][keep]),
                      f"{phase}: sparse SGD moved a row of {t} no id names")
                check(not torch.equal(after[0][t][~keep], init[t][~keep]),
                      f"{phase}: sparse SGD moved no row of {t}")
                moved += int(ids.size)
            exe.close()
        finally:
            executor_mod.switch_scope(prev_scope)
            if exe is not None:
                exe.close()
            del exe
            torch.cuda.empty_cache()

        check(all(np.isfinite(k_loss)) and k_loss[-1] < k_loss[0],
              f"{phase}: the loss does not fall: {k_loss}")
        step_s = float(np.median(k_secs[2:]))       # the replays
        i_step_s = float(np.median(i_secs[1:]))
        params = blk.all_parameters()
        emit({"phase": phase, "card": card, "model": model,
              "source": "Guo et al., DeepFM, IJCAI 2017, sec. 3.1 (Criteo: "
                        "26 categorical + 13 dense fields, embed_dim 10, "
                        "hidden 400-400-400, Adam 1e-3); models/ctr.py",
              "slots": X_SLOTS, "dense": X_DENSE, "rows_per_slot": X_ROWS,
              "embed_dim": X_EMBED, "hidden": list(X_HIDDEN),
              "batch": X_BATCH, "optimizer": f"adam {X_LR}",
              "ids": f"zipf(a={X_ZIPF}) % rows",
              "slot0_unique_ids_per_batch": unique,
              "reduced": "no dropout (the paper's 0.5 is not in "
                         "models/ctr.py)",
              "ops": len(types), "sparse_grads": len(grads),
              "params": sum(int(np.prod(p.shape)) for p in params),
              "embedding_params": sum(int(np.prod(p.shape)) for p in params
                                      if p.name in tables),
              "startup_s": startup_s, "steps": G_STEPS,
              "default_mode": {"losses": k_loss, "step_s": k_secs,
                               **graph},
              "interpreter": {"losses": i_loss, "step_s": i_secs,
                              "bit_equal_to_replay": True},
              "dense_grad_bit_equal": True,
              "card_vs_cpu": {"steps": X_CPU_STEPS, "card": c_loss,
                              "cpu": cpu_loss, "loss_rel_diff": loss_rel,
                              "relu_flips_per_step": flips,
                              "relu_outputs": len(relus),
                              "held_state_max_rel_diff": rel[worst],
                              "held_state_argmax": worst,
                              "held": "every state" if not any(flips)
                              else "every state but the parameters",
                              "param_max_rel_diff": rel[p_worst],
                              "param_argmax": p_worst,
                              "param_elements_beyond_limit": beyond,
                              "limit": X_CPU_RTOL, "cpu_s": cpu_s},
              "sparse_sgd": {"repeat_bit_equal": True,
                             "tables": len(s_tables),
                             "rows_moved": moved},
              "ms_per_step": step_s * 1e3,
              "examples_per_s": X_BATCH / step_s,
              **_interpreter_record(i_secs, i_profile),
              "interpreted_examples_per_s": X_BATCH / i_step_s,
              "profiled_step": profile,
              "device_ms_by_group": profile["by_group_ms"],
              "device_idle_share": 1.0 - profile["device_ms"]
              / (step_s * 1e3),
              "peak_memory_bytes": graph["peak_memory_bytes"],
              "peak_reserved_bytes": graph["peak_reserved_bytes"],
              "capture_s": graph["capture_s"],
              "seconds": time.perf_counter() - t_phase,
              "timing": "host clock around exe.run + synchronize; "
                        "ms_per_step the median of the replayed steps "
                        "(3..N), the interpreter's of steps 2..N; device "
                        "time by group from one profiled step; idle share "
                        "1 - its device time / the median step"})


# -- rnn phase ----------------------------------------------------------------

def _rnn_program(dtype, vocab=N_VOCAB, emb_dim=N_EMB, hidden=N_HID,
                 lr=N_LR):
    """run_rnn's LSTM text classifier (benchmark/run_rnn.py:33-50):
    embedding in `dtype`, fc to 4 x hidden, dynamic_lstm (peepholes, its
    default), the last step, fc 2 softmax, cross entropy, Adam ->
    (main, startup, loss)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                 lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(input=data, size=[vocab, emb_dim],
                                     dtype=dtype)
        proj = fluid.layers.fc(input=emb, size=hidden * 4)
        lstm_out, _ = fluid.layers.dynamic_lstm(input=proj, size=hidden * 4)
        last = fluid.layers.sequence_pool(lstm_out, pool_type="last")
        predict = fluid.layers.fc(input=last, size=2, act="softmax")
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        loss = fluid.layers.mean(cost)
        fluid.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def _rnn_s2s_program():
    """run_seq2seq's `--model rnn` (benchmark/run_seq2seq.py:63-103): an
    LSTM encoder, its last step expanded over the target and
    concatenated to the target embedding (a LoD concat), an LSTM
    decoder, fc softmax over the target vocabulary, cross entropy, Adam
    -> (main, startup, loss)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src, tgt, lbl = [fluid.layers.data(name=n, shape=[1], dtype="int64",
                                           lod_level=1)
                         for n in ("src", "tgt", "lbl")]
        src_emb = fluid.layers.embedding(input=src, size=[N_VOCAB, Q_EMB])
        enc_in = fluid.layers.fc(input=src_emb, size=Q_HID * 4, act="tanh")
        enc, _ = fluid.layers.dynamic_lstm(input=enc_in, size=Q_HID * 4,
                                           use_peepholes=False)
        context = fluid.layers.sequence_last_step(input=enc)
        tgt_emb = fluid.layers.embedding(input=tgt, size=[N_VOCAB, Q_EMB])
        ctx_exp = fluid.layers.sequence_expand(x=context, y=tgt_emb)
        dec_in = fluid.layers.concat([tgt_emb, ctx_exp], axis=1)
        dec_proj = fluid.layers.fc(input=dec_in, size=Q_HID * 4, act="tanh")
        dec, _ = fluid.layers.dynamic_lstm(input=dec_proj, size=Q_HID * 4,
                                           use_peepholes=False)
        probs = fluid.layers.fc(input=dec, size=N_VOCAB, act="softmax")
        cost = fluid.layers.cross_entropy(input=probs, label=lbl)
        loss = fluid.layers.mean(cost)
        fluid.Adam(learning_rate=Q_LR).minimize(loss)
    return main, startup, loss


def _lod_ids(rng, lens):
    """Seeded int64 ids in [0, N_VOCAB) as a host LoDTensor, one sequence
    a length."""
    from paddle_tpu_torch.core.lod import LoDTensor, lod_from_seq_lens

    ids = rng.randint(0, N_VOCAB, (int(sum(lens)), 1)).astype(np.int64)
    return LoDTensor(torch.from_numpy(ids), [lod_from_seq_lens(lens)])


def _rnn_feed(rng, lens):
    return {"words": _lod_ids(rng, lens),
            "label": torch.from_numpy(
                rng.randint(0, 2, (len(lens), 1)).astype(np.int64))}


def _rnn_flops(rows, batch, steps, emb, hidden, out_widths):
    """A step's model FLOPs: the Program's mul shapes (the input
    projection over `rows` rows, the heads over `out_widths` as
    (rows, in, out)) and the recurrence (steps x 2 B D 4D), forward x 3."""
    fwd = 2 * rows * emb * 4 * hidden + steps * 2 * batch * hidden * 4 * hidden
    fwd += sum(2 * r * k * n for r, k, n in out_widths)
    return 3 * fwd


def _loss_falls(phase, losses, start=0):
    """The losses finite and the last below the one at step `start`."""
    check(all(np.isfinite(losses)) and losses[-1] < losses[start],
          f"{phase}: the loss does not fall from step {start}: {losses}")


def _ragged_lods(exe, main, loss):
    """N_RAGGED seeded length vectors in [N_RAGGED_MIN, N_LEN], each fed
    twice and then once more: a miss and a capture for each new LoD, a
    replay after.  Then more recurring LoDs than the graph budget:
    GRAPHS_MAX set to the graphs live, N_OVER new LoDs and N_OVER
    captured ones fed in turns for N_OVER_ROUNDS rounds: no capture, the
    new LoDs' hits run eagerly, the captured ones replay; each step
    timed -> a record."""
    from paddle_tpu_torch.core import executor as executor_mod

    rng = np.random.RandomState(SEED + 1)
    lens = [rng.randint(N_RAGGED_MIN, N_LEN + 1, N_BATCH).tolist()
            for _ in range(N_RAGGED + N_OVER)]
    feeds = [_rnn_feed(rng, ls) for ls in lens]
    g0, s0 = exe.graph_stats(), exe.cache_stats()
    losses = []
    for rounds in (2, 1):
        for f in feeds[:N_RAGGED]:
            for _ in range(rounds):
                losses.append(float(exe.run(main, feed=f,
                                            fetch_list=[loss])[0][0]))
    g1, s1 = exe.graph_stats(), exe.cache_stats()
    check(g1["captures"] == 1 + N_RAGGED and g1["graphs"] == 1 + N_RAGGED
          and g1["replays"] - g0["replays"] == N_RAGGED
          and s1["misses"] - s0["misses"] == N_RAGGED
          and s1["entries"] - s0["entries"] == N_RAGGED,
          f"rnn_ragged: graphs {g1} and cache {s1} after {N_RAGGED} new "
          f"LoDs fed twice and once more: want {1 + N_RAGGED} captures")

    budget = executor_mod.GRAPHS_MAX
    executor_mod.GRAPHS_MAX = g1["graphs"]
    secs = {"miss": [], "eager_hit": [], "replay": []}
    try:
        seen = set()
        for _ in range(N_OVER_ROUNDS):
            for i in list(range(N_RAGGED, N_RAGGED + N_OVER)) + \
                    list(range(N_OVER)):
                kind = ("replay" if i < N_RAGGED else
                        "eager_hit" if i in seen else "miss")
                seen.add(i)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(exe.run(main, feed=feeds[i],
                                            fetch_list=[loss])[0][0]))
                secs[kind].append(time.perf_counter() - t0)
    finally:
        executor_mod.GRAPHS_MAX = budget
    g2, s2 = exe.graph_stats(), exe.cache_stats()
    over = {"captures": g2["captures"] - g1["captures"],
            "eager_hits": g2["eager_hits"] - g1["eager_hits"],
            "replays": g2["replays"] - g1["replays"],
            "misses": s2["misses"] - s1["misses"]}
    want = {"captures": 0, "eager_hits": N_OVER * (N_OVER_ROUNDS - 1),
            "replays": N_OVER * N_OVER_ROUNDS, "misses": N_OVER}
    check(over == want, f"rnn_ragged: past the graph budget {over}, want "
          f"{want}: no capture, the new LoDs' hits eager")
    check(all(np.isfinite(losses)), f"rnn_ragged: losses {losses}")
    capture_s = (g1["capture_s"] - g0["capture_s"]) / N_RAGGED
    return {"lengths_min_max": [[min(x), max(x)] for x in lens],
            "rows": [int(sum(x)) for x in lens], "losses": losses,
            "captures": g1["captures"], "graphs": g1["graphs"],
            "new_lod_misses": s1["misses"] - s0["misses"],
            "replays_after": g1["replays"] - g0["replays"],
            "capture_s_per_lod": capture_s,
            "past_graph_budget": {
                "graphs_max": g1["graphs"], "new_lods": N_OVER,
                "captured_lods": N_OVER, "rounds": N_OVER_ROUNDS, **over,
                "step_s": secs,
                "eager_hit_ms": float(np.median(secs["eager_hit"])) * 1e3,
                "replay_ms": float(np.median(secs["replay"])) * 1e3,
                "mean_step_ms": sum(map(sum, secs.values())) * 1e3
                / (N_OVER_ROUNDS * 2 * N_OVER),
                "timing": "host clock around exe.run after a synchronize "
                          "(the fetch synchronizes); the ragged captures' "
                          "mean capture_s_per_lod is what a recapture at "
                          "every hit would cost instead"}}


def _rnn_card_vs_cpu(place):
    """N_CPU_STEPS Adam steps of run_rnn's Program with a float32
    embedding at batch N_CPU_BATCH (seeded lengths in [N_RAGGED_MIN,
    N_LEN]) on the card and on the CPU from the same startup values:
    losses within N_CPU_LOSS_RTOL relative, every parameter and Adam
    moment within N_CPU_RTOL of max(1, |CPU value|)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    main, startup, loss = _rnn_program("float32")
    persist = _persistables(main)
    rng = np.random.RandomState(SEED + 2)
    feeds = [_rnn_feed(rng, rng.randint(N_RAGGED_MIN, N_LEN + 1,
                                        N_CPU_BATCH).tolist())
             for _ in range(N_CPU_STEPS)]
    scope = fluid.global_scope()
    exe = fluid.Executor(place, seed=SEED)
    exe.run(startup)
    init = {n: scope.find_var(n).clone() for n in persist}
    c_loss = [float(exe.run(main, feed=f, fetch_list=[loss])[0][0])
              for f in feeds]
    card = {n: scope.find_var(n).cpu() for n in persist}
    exe.close()
    prev = executor_mod.switch_scope(Scope())
    try:
        cpu_scope = fluid.global_scope()
        for n in persist:
            cpu_scope.set_var(n, init[n].cpu())
        cpu = fluid.Executor(fluid.CPUPlace(), seed=SEED)
        t0 = time.perf_counter()
        cpu_loss = [float(cpu.run(main, feed=f, fetch_list=[loss])[0][0])
                    for f in feeds]
        cpu_s = time.perf_counter() - t0
        want = {n: cpu_scope.find_var(n) for n in persist}
    finally:
        executor_mod.switch_scope(prev)
    rel = _states_rel_diff(card, want)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(c_loss, cpu_loss)]
    worst = max(rel, key=rel.get)
    check(max(loss_rel) <= N_CPU_LOSS_RTOL, f"rnn_card_vs_cpu: losses "
          f"{c_loss} against the CPU's {cpu_loss}")
    check(rel[worst] <= N_CPU_RTOL, f"rnn_card_vs_cpu: {worst} differs "
          f"by {rel[worst]} of max(1, |CPU|): "
          f"{sorted(rel.items(), key=lambda kv: -kv[1])[:5]}")
    return {"batch": N_CPU_BATCH, "steps": N_CPU_STEPS,
            "embedding": "float32", "card": c_loss, "cpu": cpu_loss,
            "loss_rel_diff": loss_rel, "loss_limit": N_CPU_LOSS_RTOL,
            "state_max_rel_diff": rel[worst], "state_argmax": worst,
            "state_limit": N_CPU_RTOL, "states": len(rel), "cpu_s": cpu_s}


def _rnn_record(r, step_s):
    profile = r["profile"]
    return {"default_mode": {"losses": r["k_loss"], "step_s": r["k_secs"],
                             **r["graph"]},
            "interpreter": {"losses": r["i_loss"], "step_s": r["i_secs"],
                            "bit_equal_to_replay": True,
                            "states_compared": r["states"]},
            "ms_per_step": step_s * 1e3,
            **_interpreter_record(r["i_secs"], r["i_profile"]),
            "profiled_step": profile,
            "device_ms_by_group": profile["by_group_ms"],
            "device_idle_share": 1.0 - profile["device_ms"] / (step_s * 1e3),
            "peak_memory_bytes": r["graph"]["peak_memory_bytes"],
            "peak_reserved_bytes": r["graph"]["peak_reserved_bytes"],
            "capture_s": r["graph"]["capture_s"],
            "startup_s": r["startup_s"]}


_RNN_TIMING = ("host clock around exe.run + synchronize; ms_per_step the "
               "median of the replayed steps (3..N), the interpreter's of "
               "steps 2..N; device time by group and idle share (1 - its "
               "device time / the median step) from one profiled replay")


def rnn_phase(card, place, peaks):
    """run_rnn's LSTM text classifier and run_seq2seq's LSTM translator
    at their defaults (see the N_ and Q_ constants), each trained in the
    Executor's default mode (one compiled block: eager at the miss,
    captured into a CUDA graph at the first hit, replayed after) and a
    profiled replay, then the same steps interpreted from the same
    state (losses and every state bit for bit); the classifier also
    takes N_RAGGED new LoDs through the same Program (a capture each)
    and N_CPU_STEPS steps card against CPU."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    t_phase = time.perf_counter()
    prev_scope = executor_mod.switch_scope(Scope())
    try:
        main, startup, loss = _rnn_program("bfloat16")
        types = [op.type for op in main.global_block().ops]
        check(types.count("lstm") == 1 and types.count("lstm_grad") == 1
              and types.count("sequence_pool") == 1,
              f"rnn: the Program's ops {types}")
        feed = _rnn_feed(np.random.RandomState(SEED), [N_LEN] * N_BATCH)
        r = _default_and_interpreter(
            "rnn", place, main, startup, loss, lambda step: feed,
            ("matmul",), after=lambda exe: _ragged_lods(exe, main, loss))
        del r["init"], r["k_state"]
        _loss_falls("rnn", r["k_loss"])
        ragged = r["extra"]
        executor_mod.switch_scope(Scope())
        vs_cpu = _rnn_card_vs_cpu(place)
    finally:
        executor_mod.switch_scope(prev_scope)
        torch.cuda.empty_cache()
    step_s = float(np.median(r["k_secs"][2:]))
    tokens = N_BATCH * N_LEN
    flops = _rnn_flops(tokens, N_BATCH, N_LEN, N_EMB, N_HID,
                       [(N_BATCH, N_HID, 2)])
    bound_ms = flops / peaks[torch.float32] * 1e3
    emit({"phase": "rnn", "card": card,
          "source": "benchmark/run_rnn.py:19-48, :97-99 (defaults: batch "
                    "128, hidden 512, --dtype bfloat16)",
          "vocab": N_VOCAB, "embedding": N_EMB, "embedding_dtype":
          "bfloat16", "hidden": N_HID, "peepholes": True, "batch": N_BATCH,
          "seq_len": N_LEN, "optimizer": f"adam {N_LR}", "ops": len(types),
          "mode": "compiled (CUDA graph replay)", "steps": G_STEPS,
          **_rnn_record(r, step_s),
          "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
          "reference_k40m_ms_per_batch": N_REF_MS,
          "reference_note": "the reference's own published number "
                            "(benchmark/README.md:115-135, one K40m, "
                            "batch 128, hidden 512), not this card's",
          "model_flops_per_step": flops, "bound_ms": bound_ms,
          "bound_by": "operations (fp32 peak outside the tensor cores)",
          "model_flops_share_of_fp32_peak": bound_ms / (step_s * 1e3),
          "ragged": ragged, "card_vs_cpu": vs_cpu,
          "timing": _RNN_TIMING + "; tokens a step batch x 100, as "
                    "run_rnn.py:71 counts them; model FLOPs from the "
                    "Program's mul shapes and the recurrence's 100 x 2 B "
                    "D 4D, forward x 3, over the fp32 peak",
          "seconds": time.perf_counter() - t_phase})

    t_phase = time.perf_counter()
    fluid.amp.enable_bf16()     # before the Program is built
    prev_scope = executor_mod.switch_scope(Scope())
    try:
        main, startup, loss = _rnn_s2s_program()
        rng = np.random.RandomState(SEED)
        feed = {n: _lod_ids(rng, [Q_LEN] * Q_BATCH)
                for n in ("src", "tgt", "lbl")}
        r = _default_and_interpreter("rnn_seq2seq", place, main, startup,
                                     loss, lambda step: feed, ("matmul",))
        del r["init"], r["k_state"]
        _loss_falls("rnn_seq2seq", r["k_loss"])
        n_ops = len(main.global_block().ops)
    finally:
        executor_mod.switch_scope(prev_scope)
        torch.cuda.empty_cache()
        fluid.amp.disable_bf16()
    step_s = float(np.median(r["k_secs"][2:]))
    rows = Q_BATCH * Q_LEN
    tokens = Q_BATCH * (Q_LEN + Q_LEN)
    flops = (_rnn_flops(rows, Q_BATCH, Q_LEN, Q_EMB, Q_HID, [])
             + _rnn_flops(rows, Q_BATCH, Q_LEN, 2 * Q_EMB, Q_HID,
                          [(rows, Q_HID, N_VOCAB)]))
    emit({"phase": "rnn_seq2seq", "card": card,
          "source": "benchmark/run_seq2seq.py:63-103, :155-162 (--model "
                    "rnn, defaults: batch 32, src and tgt length 128, "
                    "--dtype bfloat16 = amp)",
          "vocab": N_VOCAB, "hidden": Q_HID, "embedding": Q_EMB,
          "batch": Q_BATCH, "src_len": Q_LEN, "tgt_len": Q_LEN,
          "dtype": "bf16 amp, f32 master weights",
          "optimizer": f"adam {Q_LR}", "ops": n_ops,
          "mode": "compiled (CUDA graph replay)", "steps": G_STEPS,
          **_rnn_record(r, step_s),
          "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
          "model_flops_per_step": flops,
          "bound_ms": flops / peaks[torch.bfloat16] * 1e3,
          "bound_by": "operations (bf16 tensor peak)",
          "timing": _RNN_TIMING + "; tokens a step batch x (src + tgt), "
                    "as run_seq2seq.py:141 counts them",
          "seconds": time.perf_counter() - t_phase})


# -- book08 phase -------------------------------------------------------------

def _mt_encoder(fluid):
    """book/08's encoder (test_machine_translation.py:27-35 and its
    `_encoder_full_seq`) at B_ widths -> (the LSTM's states, the last
    step)."""
    src = fluid.layers.data(name="src_word_id", shape=[1], dtype="int64",
                            lod_level=1)
    emb = fluid.layers.embedding(input=src, size=[B_VOCAB, B_EMB],
                                 param_attr={"name": "vemb"})
    fc1 = fluid.layers.fc(input=emb, size=B_HID * 4, act="tanh")
    hidden, _ = fluid.layers.dynamic_lstm(input=fc1, size=B_HID * 4,
                                          use_peepholes=False)
    return hidden, fluid.layers.sequence_last_step(input=hidden)


def _mt_decoder_train(fluid, context):
    """book/08's `decoder_train` (:38-52): a DynamicRNN over the target."""
    trg = fluid.layers.data(name="target_language_word", shape=[1],
                            dtype="int64", lod_level=1)
    trg_emb = fluid.layers.embedding(input=trg, size=[B_VOCAB, B_EMB],
                                     param_attr={"name": "vemb"})
    rnn = fluid.layers.DynamicRNN()
    with rnn.block():
        word = rnn.step_input(trg_emb)
        pre_state = rnn.memory(init=context)
        state = fluid.layers.fc(input=[word, pre_state], size=B_HID,
                                act="tanh")
        score = fluid.layers.fc(input=state, size=B_VOCAB, act="softmax")
        rnn.update_memory(pre_state, state)
        rnn.output(score)
    return rnn()


def _mt_decoder_attention(fluid, enc_seq, context):
    """book/08's `decoder_train_attention` (:197-244), the source padded
    to B_MAXS and masked by the fed `att_mask`."""
    pd = fluid.layers
    blk = fluid.default_main_program().current_block
    padded = blk.create_var(name="enc_padded", dtype="float32")
    length = blk.create_var(name="enc_len", dtype="int64",
                            stop_gradient=True)
    blk.append_op("sequence_pad", {"X": [enc_seq.name]},
                  {"Out": [padded.name], "Length": [length.name]},
                  {"pad_value": 0.0, "padded_length": B_MAXS})
    padded.shape = (-1, B_MAXS, B_HID)
    padded.stop_gradient = False
    mask = pd.data(name="att_mask", shape=[B_MAXS], dtype="float32")
    trg = pd.data(name="target_language_word", shape=[1], dtype="int64",
                  lod_level=1)
    trg_emb = pd.embedding(input=trg, size=[B_VOCAB, B_EMB],
                           param_attr={"name": "vemb"})
    rnn = pd.DynamicRNN()
    with rnn.block():
        word = rnn.step_input(trg_emb)
        enc_s = rnn.static_input(padded)
        m = rnn.static_input(mask)
        pre_state = rnn.memory(init=context)
        query = pd.fc(input=pre_state, size=B_HID, bias_attr=False)
        q3 = pd.reshape(query, shape=[-1, B_HID, 1])
        scores = pd.reshape(pd.matmul(enc_s, q3), shape=[-1, B_MAXS])
        scores = pd.elementwise_add(scores,
                                    pd.scale(m, scale=1e9, bias=-1e9))
        att = pd.softmax(scores)
        ctx = pd.reshape(pd.matmul(pd.reshape(att, shape=[-1, 1, B_MAXS]),
                                   enc_s), shape=[-1, B_HID])
        state = pd.fc(input=[word, pre_state, ctx], size=B_HID, act="tanh")
        score = pd.fc(input=state, size=B_VOCAB, act="softmax")
        rnn.update_memory(pre_state, state)
        rnn.output(score)
    return rnn()


def _mt_decoder_decode(fluid, context, vocab=B_VOCAB, emb=B_EMB, hid=B_HID,
                       max_len=B_DECODE_LEN, beam=B_BEAM, topk=B_TOPK):
    """book/08's `decoder_decode` (:55-97): a While loop of `max_len`
    iterations over tensor arrays with beam_search, then
    beam_search_decode -> its (ids, scores)."""
    pd = fluid.layers
    array_len = pd.fill_constant(shape=[1], dtype="int64", value=max_len)
    counter = pd.zeros(shape=[1], dtype="int64")
    state_array = pd.create_array("float32")
    pd.array_write(context, array=state_array, i=counter)
    ids_array = pd.create_array("int64")
    scores_array = pd.create_array("float32")
    init_ids = pd.data(name="init_ids", shape=[1], dtype="int64",
                       lod_level=2)
    init_scores = pd.data(name="init_scores", shape=[1], dtype="float32",
                          lod_level=2)
    pd.array_write(init_ids, array=ids_array, i=counter)
    pd.array_write(init_scores, array=scores_array, i=counter)
    cond = pd.less_than(x=counter, y=array_len)
    while_op = pd.While(cond=cond)
    with while_op.block():
        pre_ids = pd.array_read(array=ids_array, i=counter)
        pre_state = pd.array_read(array=state_array, i=counter)
        pre_score = pd.array_read(array=scores_array, i=counter)
        pre_state_expanded = pd.sequence_expand(pre_state, pre_score)
        pre_ids_emb = pd.embedding(input=pre_ids, size=[vocab, emb],
                                   param_attr={"name": "vemb"})
        state = pd.fc(input=[pre_ids_emb, pre_state_expanded], size=hid,
                      act="tanh")
        score = pd.fc(input=state, size=vocab, act="softmax")
        topk_scores, topk_indices = pd.topk(score, k=topk)
        selected_ids, selected_scores = pd.beam_search(
            pre_ids, topk_indices, topk_scores, beam, end_id=B_END,
            level=0)
        pd.increment(x=counter, value=1, in_place=True)
        pd.array_write(state, array=state_array, i=counter)
        pd.array_write(selected_ids, array=ids_array, i=counter)
        pd.array_write(selected_scores, array=scores_array, i=counter)
        pd.less_than(x=counter, y=array_len, cond=cond)
    return pd.beam_search_decode(ids=ids_array, scores=scores_array)


def _mt_program(kind):
    """-> (main, startup, the loss or the decode's (ids, scores)) of
    book/08's `kind` in "train", "attention" or "decode"."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        enc_seq, context = _mt_encoder(fluid)
        if kind == "decode":
            return main, startup, _mt_decoder_decode(fluid, context)
        out = (_mt_decoder_attention(fluid, enc_seq, context)
               if kind == "attention" else _mt_decoder_train(fluid, context))
        label = fluid.layers.data(name="target_language_next_word",
                                  shape=[1], dtype="int64", lod_level=1)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=out,
                                                            label=label))
        fluid.Adam(learning_rate=B_LR).minimize(loss)
    return main, startup, loss


def _mt_lod(seqs):
    from paddle_tpu_torch.core.lod import LoDTensor, lod_from_seq_lens

    flat = np.concatenate(seqs).astype(np.int64).reshape(-1, 1)
    return LoDTensor(torch.from_numpy(flat),
                     [lod_from_seq_lens([len(s) for s in seqs])])


def _mt_feed(rng, n, max_len, attention=False):
    """The book's copy task (`_make_batch`, :100-110) at B_VOCAB: source
    lengths in [B_MIN_LEN, max_len], tokens in [2, B_VOCAB), target in
    <s> + source, next word source + <e>; with `attention` the book's
    [n, B_MAXS] validity mask -> (feed, tokens: sources + targets)."""
    srcs = [rng.randint(2, B_VOCAB, (int(rng.randint(B_MIN_LEN,
                                                     max_len + 1)),))
            for _ in range(n)]
    feed = {"src_word_id": _mt_lod(srcs),
            "target_language_word": _mt_lod(
                [np.concatenate([[B_START], s]) for s in srcs]),
            "target_language_next_word": _mt_lod(
                [np.concatenate([s, [B_END]]) for s in srcs])}
    if attention:
        m = np.zeros((n, B_MAXS), np.float32)
        for i, s in enumerate(srcs):
            m[i, :len(s)] = 1.0
        feed["att_mask"] = torch.from_numpy(m)
    return feed, sum(2 * len(s) + 1 for s in srcs)


def _mt_decode_feed(rng, n, max_len):
    """n sources and the decoder's start: one <s> a source, score 1, in
    the book's two-level LoD (:165-172)."""
    from paddle_tpu_torch.core.lod import LoDTensor

    srcs = [rng.randint(2, B_VOCAB, (int(rng.randint(B_MIN_LEN,
                                                     max_len + 1)),))
            for _ in range(n)]
    lod = [list(range(n + 1))] * 2
    return {"src_word_id": _mt_lod(srcs),
            "init_ids": LoDTensor(torch.full((n, 1), B_START,
                                             dtype=torch.int64), lod),
            "init_scores": LoDTensor(torch.ones((n, 1)), lod)}


def _mt_flops(tokens_src, tokens_trg, batch, src_len, attention):
    """A step's model FLOPs, forward x 3: the encoder's fc and LSTM over
    the padded [batch, src_len] (the recurrence runs every padded step),
    and per target row the state fc (2 inputs, or 3 with the attention's
    context, plus its query fc and the two [B_MAXS]-wide products) and
    the [B_HID, B_VOCAB] softmax fc."""
    enc = 2 * tokens_src * B_EMB * 4 * B_HID \
        + 2 * batch * src_len * B_HID * 4 * B_HID
    per_row = 2 * (3 if attention else 2) * B_HID * B_HID \
        + 2 * B_HID * B_VOCAB
    if attention:
        per_row += 2 * B_HID * B_HID + 4 * B_MAXS * B_HID
    return 3 * (enc + tokens_trg * per_row)


def _mt_more_lods(phase, exe, main, loss, feeds, segments=1):
    """Each of `feeds` (a new LoD) fed three times: a miss (eager), the
    first hit (a capture) and a replay -> a record; every LoD its own
    cache entry and graph (one a device segment of a segmented block:
    `segments`)."""
    g0, s0 = exe.graph_stats(), exe.cache_stats()
    losses, replay_s = [], []
    for feed in feeds:
        for k in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=feed,
                                        fetch_list=[loss])[0][0]))
            if k == 2:
                replay_s.append(time.perf_counter() - t0)
    g1, s1 = exe.graph_stats(), exe.cache_stats()
    n = len(feeds) * segments
    got = {"misses": s1["misses"] - s0["misses"],
           "entries": s1["entries"] - s0["entries"],
           "captures": g1["captures"] - g0["captures"],
           "replays": g1["replays"] - g0["replays"],
           "eager_hits": g1["eager_hits"] - g0["eager_hits"]}
    check(got == {"misses": n, "entries": n, "captures": n, "replays": n,
                  "eager_hits": 0},
          f"{phase}: {len(feeds)} new LoDs fed three times each gave "
          f"{got}: want a miss, a capture and a replay each a segment")
    check(all(np.isfinite(losses)), f"{phase}: losses {losses}")
    n = len(feeds)
    return {"lods": n, **got, "per_lod": {k: v / n for k, v in got.items()},
            "losses": losses, "replay_ms": [x * 1e3 for x in replay_s],
            "capture_s_per_lod": (g1["capture_s"] - g0["capture_s"]) / n}


def _mt_train(card, place, peaks, kind):
    """mt_train or mt_attention: the default mode against the
    interpreter, two more LoDs -> (the record, the trained states)."""
    import paddle_tpu_torch as fluid

    phase = "mt_train" if kind == "train" else "mt_attention"
    main, startup, loss = _mt_program(kind)
    types = [op.type for op in main.global_block().ops]
    check(types.count("dynamic_rnn") == 1
          and types.count("dynamic_rnn_grad") == 1,
          f"{phase}: the Program's ops {types}")
    rng = np.random.RandomState(SEED + (3 if kind == "train" else 4))
    attention = kind == "attention"
    feed, tokens = _mt_feed(rng, B_BATCH, B_MAX_LEN, attention)
    more = [_mt_feed(rng, B_BATCH, B_MAX_LEN, attention)[0]
            for _ in range(B_LODS)]
    r = _default_and_interpreter(
        phase, place, main, startup, loss, lambda step: feed, ("matmul",),
        after=lambda exe: _mt_more_lods(phase, exe, main, loss, more))
    _loss_falls(phase, r["k_loss"])
    scope = fluid.global_scope()
    trained = {n: scope.find_var(n).clone() for n in _persistables(main)}
    step_s = float(np.median(r["k_secs"][2:]))
    src = feed["src_word_id"]
    tokens_src = src.lod[0][-1]
    flops = _mt_flops(tokens_src, tokens - tokens_src, B_BATCH,
                      max(src.seq_lens()), attention)
    bound_ms = flops / peaks[torch.float32] * 1e3
    del r["init"], r["k_state"]
    rec = {"phase": phase, "card": card,
           "source": "tests/book/test_machine_translation.py:"
                     + ("38-52" if kind == "train" else "197-244")
                     + " at benchmark/run_seq2seq.py:63-103's widths",
           "vocab": B_VOCAB, "embedding": B_EMB, "hidden": B_HID,
           "dtype": "float32", "optimizer": f"adam {B_LR}",
           "batch": B_BATCH, "source_lengths": src.seq_lens(),
           "max_src_len": B_MAXS if attention else None,
           "ops": len(types), "mode": "compiled (CUDA graph replay)",
           "steps": G_STEPS, **_rnn_record(r, step_s),
           "interpreted_ms_per_step_3_6":
               float(np.median(r["i_secs"][2:])) * 1e3,
           "more_lods": r["extra"], "tokens_per_step": tokens,
           "tokens_per_s": tokens / step_s, "model_flops_per_step": flops,
           "bound_ms": bound_ms,
           "bound_by": "operations (fp32 peak outside the tensor cores)",
           "timing": _RNN_TIMING + "; tokens a step the sources' and the "
                     "targets' tokens, batch x (source + target) as "
                     "run_seq2seq.py:141 counts them; model FLOPs from the "
                     "Program's mul shapes, forward x 3"}
    return rec, trained


@contextlib.contextmanager
def _wrapped_lowering(op_type, wrap):
    """`op_type`'s lowering replaced by `wrap(lowering)` while inside (a
    new lowering generation: the Executor resolves its plans anew)."""
    from paddle_tpu_torch.core import registry

    info = registry.get_op_info(op_type)
    lower = info.lower
    info.lower = wrap(lower)
    try:
        yield
    finally:
        info.lower = lower


def _timed(secs):
    """A lowering wrapper appending each call's seconds to `secs` (host
    clock, a synchronize at its end): the `while` op's run alone,
    without the encoder's segments."""
    def wrap(lower):
        def timed(ctx, ins, attrs):
            t0 = time.perf_counter()
            out = lower(ctx, ins, attrs)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            return out
        return timed
    return wrap


def _beam_record(steps):
    """A beam_search lowering wrapper appending to `steps`, at each call,
    one tuple a source: (its selected ids, its selected candidates a
    prefix, their scores, its gap).  The gap is the one between the
    beam_size-th best candidate's score (the last chosen) and the next
    one's (the first rejected), relative to the chosen one; None where
    the source has no such pair."""
    from paddle_tpu_torch.ops.control_flow import _abs_offsets

    def wrap(lower):
        def recording(ctx, ins, attrs):
            beam = attrs["beam_size"]
            high = _abs_offsets(ins["ids"][0].lod, attrs["level"])
            sc = ins["scores"][0].data.reshape(high[-1], -1).cpu().numpy()
            out = lower(ctx, ins, attrs)
            low = out["selected_ids"].lod[1]
            ids = out["selected_ids"].data.reshape(-1).cpu().numpy()
            scs = out["selected_scores"].data.reshape(-1).cpu().numpy()
            step = []
            for s in range(len(high) - 1):
                v = np.sort(sc[high[s]:high[s + 1]].reshape(-1))[::-1]
                gap = (float((v[beam - 1] - v[beam]) / abs(v[beam - 1]))
                       if len(v) > beam else None)
                a, b = low[high[s]], low[high[s + 1]]
                step.append((tuple(ids[a:b].tolist()),
                             tuple(np.diff(low[high[s]:high[s + 1] + 1])
                                   .tolist()), scs[a:b], gap))
            steps.append(step)
            return out
        return recording
    return wrap


def _rel(got, want):
    """max |got - want| / |want| over the elements (0.0 for none)."""
    return (float(np.max(np.abs(got - want) / np.abs(want)))
            if np.size(want) else 0.0)


def _decode_verdict(got_steps, want_steps, got, want, rtol):
    """A decode (`got`: beam_search_decode's (ids, scores), `got_steps`:
    its `_beam_record`) against a reference one, step by step.  Up to
    the first step where a source's selection differs, every source's
    selections must be equal and its scores within `rtol` relative.
    Such a step passes only where each differing source's
    chosen-vs-rejected gap in the reference is within `rtol`: a near
    tie that the two devices' rounding flipped, not a port fault; the
    decodes after it are not compared.  With no such step the decodes'
    ids and LoDs must be equal and their scores within `rtol`.
    -> (ok, a record of what was compared)."""
    gaps = [src[3] for step in want_steps for src in step
            if src[3] is not None]
    rec = {"beam_steps": len(want_steps),
           "min_chosen_vs_rejected_gap": min(gaps) if gaps else None,
           "first_differing_step": None, "decode_equal": False}
    if len(got_steps) != len(want_steps):
        return False, rec
    step_rel = 0.0
    for t, (gs, ws) in enumerate(zip(got_steps, want_steps)):
        if len(gs) != len(ws):
            return False, {**rec, "first_differing_step": t}
        diff = [s for s, (g, w) in enumerate(zip(gs, ws)) if g[:2] != w[:2]]
        step_rel = max([step_rel] + [_rel(g[2], w[2]) for s, (g, w)
                                     in enumerate(zip(gs, ws))
                                     if s not in diff])
        rec["step_score_max_rel_diff"] = step_rel
        if diff:
            at = [ws[s][3] for s in diff]
            return (step_rel <= rtol and all(g is not None and g <= rtol
                                             for g in at),
                    {**rec, "first_differing_step": t,
                     "differing_sources": diff, "their_gaps": at})
    (g_ids, g_sc), (w_ids, w_sc) = got, want
    same = (g_ids.lod == w_ids.lod and g_sc.lod == w_sc.lod
            and np.array_equal(g_ids.data, w_ids.data))
    score_rel = _rel(g_sc.data, w_sc.data) if same else None
    return (same and step_rel <= rtol and score_rel <= rtol,
            {**rec, "decode_equal": same,
             "decode_score_max_rel_diff": score_rel})


def _mt_decode(card, place, trained):
    """mt_decode: the While + beam-search decoder over B_BATCH sources
    with mt_train's parameters, in the Executor's default mode (segmented:
    the encoder's device segments captured, the While loop and its body
    on the host, op by op) -> a record."""
    import paddle_tpu_torch as fluid

    main, startup, (ids, scores) = _mt_program("decode")
    scope = fluid.global_scope()
    persist = _persistables(main)
    check(set(persist) <= set(trained),
          f"mt_decode: parameters {sorted(set(persist) - set(trained))} "
          "were not trained by mt_train")
    for n in persist:
        scope.set_var(n, trained[n].clone())
    feed = _mt_decode_feed(np.random.RandomState(SEED + 5), B_BATCH,
                           B_MAX_LEN)
    exe = fluid.Executor(place, seed=SEED)
    _reset_peak()
    try:
        run = lambda: exe.run(main, feed=feed,  # noqa: E731
                              fetch_list=[ids, scores])
        secs, outs = [], []
        for _ in range(4):      # a miss, a capture, then replays
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(run())
            secs.append(time.perf_counter() - t0)
        profile = _profile_step(run, ("matmul",), "mt_decode")
        segs = exe._segments(main.global_block(), exe._fingerprint(main))
        graphs = exe.graph_stats()
        peak = torch.cuda.max_memory_allocated()
        while_s = []
        with _wrapped_lowering("while", _timed(while_s)):
            for _ in range(3):
                run()
    finally:
        exe.close()
    first = outs[0]
    for o in outs[1:]:
        check(o[0].lod == first[0].lod
              and np.array_equal(o[0].data, first[0].data)
              and np.array_equal(o[1].data, first[1].data),
              "mt_decode: a decode of the same sources differs from the "
              "first")
    sent = first[0]
    check(len(sent.lod[0]) - 1 == B_BATCH and sent.lod == first[1].lod
          and sent.lod[0][-1] >= B_BATCH
          and all(1 <= b - a <= B_DECODE_LEN + 1
                  for a, b in zip(sent.lod[1], sent.lod[1][1:]))
          and ((sent.data >= 0) & (sent.data < B_VOCAB)).all()
          and np.isfinite(first[1].data).all(),
          f"mt_decode: the sentences' LoD {sent.lod} or ids out of range")
    total_s = float(np.median(secs[2:]))
    return {"phase": "mt_decode", "card": card,
            "source": "tests/book/test_machine_translation.py:55-97, "
                      "beam 2 and top-k 4 (its BEAM, TOPK), "
                      f"{B_DECODE_LEN} iterations (its MAX_LEN is 6)",
            "sources": B_BATCH, "source_lengths": feed["src_word_id"]
            .seq_lens(), "beam": B_BEAM, "topk": B_TOPK,
            "while_iterations": B_DECODE_LEN,
            "segments": [["host" if h else "device", len(o)]
                         for h, o, _ in segs],
            "graphs": graphs, "sentences": sent.lod[0][-1],
            "tokens": int(sent.lod[1][-1]), "step_s": secs,
            "total_ms": total_s * 1e3,
            "while_ms": [x * 1e3 for x in while_s],
            "ms_per_while_iteration": float(np.median(while_s)) * 1e3
            / B_DECODE_LEN,
            "sentences_per_s": B_BATCH / total_s,
            "peak_memory_bytes": peak, "profiled_run": profile,
            "device_ms_by_group": profile["by_group_ms"],
            "host_share": 1.0 - profile["device_ms"] / profile["event_ms"],
            "timing": "host clock around exe.run (its fetch synchronizes), "
                      "the median of runs 3-4 (run 1 a miss of each device "
                      "segment, run 2 their captures); ms per While "
                      "iteration: the while op's own time (host clock "
                      "around its lowering, a synchronize at its end; the "
                      "median of three runs) over its iterations; host share "
                      "1 - device time / the profiled run's span between "
                      "CUDA events"}


def _mt_card_vs_cpu(place, trained):
    """mt_train at batch B_CPU_BATCH, source lengths up to
    B_CPU_MAX_LEN: B_CPU_STEPS Adam steps on the card and on the CPU
    from the same startup values (losses, every state); then the decoder
    over B_CPU_BATCH sources with mt_train's `trained` parameters on
    both, held step by step by `_decode_verdict` at B_SCORE_RTOL
    -> a record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    main, startup, loss = _mt_program("train")
    persist = _persistables(main)
    rng = np.random.RandomState(SEED + 6)
    feeds = [_mt_feed(rng, B_CPU_BATCH, B_CPU_MAX_LEN)[0]
             for _ in range(B_CPU_STEPS)]
    dmain, _, (ids, scores) = _mt_program("decode")
    dfeed = _mt_decode_feed(rng, B_CPU_BATCH, B_CPU_MAX_LEN)
    dpersist = _persistables(dmain)

    def decode(exe, scope):
        for n in dpersist:
            scope.set_var(n, trained[n].to(exe.device))
        return exe.run(dmain, feed=dfeed, fetch_list=[ids, scores])

    scope = fluid.global_scope()
    exe = fluid.Executor(place, seed=SEED)
    exe.run(startup)
    init = {n: scope.find_var(n).clone() for n in persist}
    c_loss = [float(exe.run(main, feed=f, fetch_list=[loss])[0][0])
              for f in feeds]
    card = {n: scope.find_var(n).cpu() for n in persist}
    c_steps, p_steps = [], []
    with _wrapped_lowering("beam_search", _beam_record(c_steps)):
        c_out = decode(exe, scope)
    exe.close()
    prev = executor_mod.switch_scope(Scope())
    try:
        cpu_scope = fluid.global_scope()
        for n in persist:
            cpu_scope.set_var(n, init[n].cpu())
        cpu = fluid.Executor(fluid.CPUPlace(), seed=SEED)
        t0 = time.perf_counter()
        cpu_loss = [float(cpu.run(main, feed=f, fetch_list=[loss])[0][0])
                    for f in feeds]
        cpu_s = time.perf_counter() - t0
        want = {n: cpu_scope.find_var(n) for n in persist}
        with _wrapped_lowering("beam_search", _beam_record(p_steps)):
            p_out = decode(cpu, cpu_scope)
    finally:
        executor_mod.switch_scope(prev)
    rel = _states_rel_diff(card, want)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(c_loss, cpu_loss)]
    worst = max(rel, key=rel.get)
    check(max(loss_rel) <= N_CPU_LOSS_RTOL, f"mt_card_vs_cpu: losses "
          f"{c_loss} against the CPU's {cpu_loss}")
    check(rel[worst] <= N_CPU_RTOL, f"mt_card_vs_cpu: {worst} differs by "
          f"{rel[worst]} of max(1, |CPU|): "
          f"{sorted(rel.items(), key=lambda kv: -kv[1])[:5]}")
    ok, decode = _decode_verdict(c_steps, p_steps, c_out, p_out,
                                 B_SCORE_RTOL)
    check(ok, f"mt_card_vs_cpu: the card's decode differs from the CPU's "
          f"beyond a near tie within {B_SCORE_RTOL}: {decode}")
    return {"batch": B_CPU_BATCH, "steps": B_CPU_STEPS,
            "max_source_length": B_CPU_MAX_LEN, "card": c_loss,
            "cpu": cpu_loss, "loss_rel_diff": loss_rel,
            "loss_limit": N_CPU_LOSS_RTOL,
            "state_max_rel_diff": rel[worst], "state_argmax": worst,
            "state_limit": N_CPU_RTOL, "states": len(rel), "cpu_s": cpu_s,
            "decode_sentences": p_out[0].lod[0][-1],
            "decode_score_limit": B_SCORE_RTOL, **decode}


def book08_phase(card, place, peaks):
    """book/08 at the bench scale: mt_train and mt_attention (the default
    mode against the interpreter bit for bit, one graph a LoD), mt_decode
    with mt_train's parameters, and batch B_CPU_BATCH card against CPU
    (see the B_ constants); one line each."""
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    prev_scope = executor_mod.switch_scope(Scope())
    try:
        t_phase = time.perf_counter()
        rec, trained = _mt_train(card, place, peaks, "train")
        emit({**rec, "seconds": time.perf_counter() - t_phase})
        t_phase = time.perf_counter()
        executor_mod.switch_scope(Scope())
        rec = _mt_decode(card, place, trained)
        emit({**rec, "seconds": time.perf_counter() - t_phase})
        t_phase = time.perf_counter()
        executor_mod.switch_scope(Scope())
        rec = _mt_card_vs_cpu(place, trained)
        emit({"phase": "mt_card_vs_cpu", "card": card, **rec,
              "seconds": time.perf_counter() - t_phase})
        del trained
        t_phase = time.perf_counter()
        executor_mod.switch_scope(Scope())
        rec, _ = _mt_train(card, place, peaks, "attention")
        emit({**rec, "seconds": time.perf_counter() - t_phase})
    finally:
        executor_mod.switch_scope(prev_scope)
        torch.cuda.empty_cache()


# -- book07 phase --------------------------------------------------------------

_SRL_FEEDS = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
              "verb", "mark")


def _srl_program(words=L_WORDS, preds=L_PREDS, labels=L_LABELS,
                 hidden=L_HIDDEN, depth=L_DEPTH):
    """book/07's db_lstm with its CRF head, SGD at L_LR, crf_decoding and
    chunk_eval -> (main, startup, loss, the decoded path, (precision,
    recall, F1), the emission)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw

    layers = fluid.layers
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        feats = [layers.data(name=n, shape=[1], dtype="int64", lod_level=1)
                 for n in _SRL_FEEDS]
        target = layers.data(name="target", shape=[1], dtype="int64",
                             lod_level=1)
        embs = [layers.embedding(
            input=x, size=[words, L_WORD_DIM], is_sparse=True,
            param_attr=fluid.ParamAttr(name="emb", trainable=False))
            for x in feats[:6]]
        embs.append(layers.embedding(input=feats[6],
                                     size=[preds, L_WORD_DIM],
                                     is_sparse=True,
                                     param_attr={"name": "vemb"}))
        embs.append(layers.embedding(input=feats[7],
                                     size=[L_MARKS, L_MARK_DIM],
                                     is_sparse=True))
        acts = dict(candidate_activation="relu", gate_activation="sigmoid",
                    cell_activation="sigmoid")
        hidden_0 = layers.sums(input=[layers.fc(input=e, size=hidden)
                                      for e in embs])
        pair = [hidden_0, layers.dynamic_lstm(input=hidden_0, size=hidden,
                                              **acts)[0]]
        for i in range(1, depth):
            mix = layers.sums(input=[layers.fc(input=pair[0], size=hidden),
                                     layers.fc(input=pair[1], size=hidden)])
            pair = [mix, layers.dynamic_lstm(input=mix, size=hidden,
                                             is_reverse=i % 2 == 1,
                                             **acts)[0]]
        feature = layers.sums(input=[layers.fc(input=pair[0], size=labels),
                                     layers.fc(input=pair[1], size=labels)])
        cost = layers.linear_chain_crf(
            input=feature, label=target,
            param_attr=fluid.ParamAttr(name="crfw", learning_rate=L_CRF_LR))
        loss = layers.mean(cost)
        fluid.SGD(learning_rate=L_LR).minimize(loss)
        decode = layers.crf_decoding(input=feature,
                                     param_attr=fluid.ParamAttr(name="crfw"))
        precision, recall, f1, *_ = layers.chunk_eval(
            input=decode, label=target, chunk_scheme="IOB",
            num_chunk_types=(labels - 1) // 2)
    return main, startup, loss, decode, (precision, recall, f1), feature


def _srl_feed(rng, n, words=L_WORDS, preds=L_PREDS, labels=L_LABELS):
    """A CoNLL-05-shaped batch of `n` sentences -> (feed, tokens): the
    five context slots the predicate's neighbours, the predicate and the
    context repeated over the sentence, the mark 1 within two words of
    the predicate; IOB labels by a rule on the word ids (a word divisible
    by 7 opens a chunk of two, by 11 a chunk of one, of type word % the
    chunk types; every other word O)."""
    from paddle_tpu_torch.core.lod import LoDTensor, lod_from_seq_lens

    types, other = (labels - 1) // 2, labels - 1
    lens = rng.randint(L_MIN_LEN, L_MAX_LEN + 1, n)
    cols = {k: [] for k in _SRL_FEEDS + ("target",)}
    for ln in lens:
        w = rng.randint(0, words, ln)
        p = rng.randint(0, ln)
        ctx = [w[min(max(p + d, 0), ln - 1)] for d in (-2, -1, 0, 1, 2)]
        for k, c in zip(_SRL_FEEDS[1:6], ctx):
            cols[k].append(np.full(ln, c))
        cols["word"].append(w)
        cols["verb"].append(np.full(ln, rng.randint(0, preds)))
        cols["mark"].append((np.abs(np.arange(ln) - p) <= 2).astype(int))
        tag = np.full(ln, other)
        i = 0
        while i < ln:
            t = int(w[i] % types)
            if w[i] % 7 == 0 and i + 1 < ln:
                tag[i], tag[i + 1] = 2 * t, 2 * t + 1
                i += 2
                continue
            if w[i] % 11 == 0:
                tag[i] = 2 * t
            i += 1
        cols["target"].append(tag)
    lod = [lod_from_seq_lens(lens)]
    return ({k: LoDTensor(np.concatenate(v).astype(np.int64)[:, None], lod)
             for k, v in cols.items()}, int(lens.sum()))


def _host_timed(secs):
    """A host op's lowering wrapper appending each call's host seconds
    to `secs`: the card drained first, so its wait for the device
    segment before it is not counted."""
    def wrap(lower):
        def timed(ctx, ins, attrs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = lower(ctx, ins, attrs)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            return out
        return timed
    return wrap


def _segment_runs(exe, program):
    """[[kind, ops]] of the block's maximal runs of device ops and of
    host ops, as the Executor's segmented mode splits it."""
    runs = []
    for op in program.global_block().ops:
        kind = "host" if exe._op_is_host(op) else "device"
        if runs and runs[-1][0] == kind:
            runs[-1][1] += 1
        else:
            runs.append([kind, 1])
    return runs


def _srl_train(card, place):
    """book07's train and eval parts -> a record."""
    import paddle_tpu_torch as fluid

    phase = "book07"
    main, startup, loss, _, metrics, _ = _srl_program()
    types = [op.type for op in main.global_block().ops]
    check(types.count("lstm") == L_DEPTH and types.count("chunk_eval") == 1
          and types.count("linear_chain_crf_grad") == 1
          and types.count("crf_decoding") == 1,
          f"{phase}: the Program's ops {types}")
    rng = np.random.RandomState(SEED + 7)
    feed, tokens = _srl_feed(rng, L_BATCH)
    more = [_srl_feed(rng, L_BATCH)[0] for _ in range(L_LODS)]
    fresh, _ = _srl_feed(rng, L_BATCH)
    eval_prog = fluid.io.get_inference_program(list(metrics), main)

    def after(exe):
        segs = _segment_runs(exe, main)
        extra = _mt_more_lods(phase, exe, main, loss, more)
        p, r, f1 = [float(np.asarray(v)) for v in exe.run(
            eval_prog, feed=fresh, fetch_list=list(metrics))]
        check(all(0.0 <= v <= 1.0 for v in (p, r, f1)),
              f"{phase}: eval precision/recall/F1 {p} / {r} / {f1}")
        return {"segments": segs, "more_lods": extra,
                "eval": {"precision": p, "recall": r, "f1": f1,
                         "ops": len(eval_prog.global_block().ops)}}

    chunk_s = []
    with _wrapped_lowering("chunk_eval", _host_timed(chunk_s)):
        r = _default_and_interpreter(phase, place, main, startup, loss,
                                     lambda step: feed,
                                     ("matmul", "sort_segment"),
                                     after=after)
    segs = r["extra"]["segments"]
    check(segs == [["device", len(types) - 1], ["host", 1]],
          f"{phase}: segments {segs}: want one device segment, then the "
          "host chunk_eval")
    _loss_falls(phase, r["k_loss"])
    step_s = float(np.median(r["k_secs"][2:]))
    del r["init"], r["k_state"]
    return {"phase": phase, "card": card,
            "source": "Paddle's python/paddle/v2/fluid/tests/book/"
                      "test_label_semantic_roles.py db_lstm (this repo's "
                      "tests/book/test_label_semantic_roles.py:58-90 at "
                      "test width)",
            "words": L_WORDS, "predicates": L_PREDS, "labels": L_LABELS,
            "word_dim": L_WORD_DIM, "mark_dim": L_MARK_DIM,
            "hidden_dim": L_HIDDEN, "depth": L_DEPTH,
            "optimizer": f"sgd {L_LR}, crfw x {L_CRF_LR}",
            "batch": L_BATCH, "sentence_lengths": feed["word"].seq_lens(),
            "ops": len(types), "segments": segs,
            "mode": "segmented (one device segment replayed as a CUDA "
                    "graph a LoD, then the host chunk_eval)",
            "steps": G_STEPS, **_rnn_record(r, step_s),
            "interpreted_ms_per_step_3_6":
                float(np.median(r["i_secs"][2:])) * 1e3,
            "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
            "chunk_eval_host_ms": float(np.median(chunk_s)) * 1e3,
            "chunk_eval_calls": len(chunk_s),
            "more_lods": r["extra"]["more_lods"],
            "eval": r["extra"]["eval"],
            "timing": _RNN_TIMING + "; chunk_eval_host_ms the median "
                      "host time of a chunk_eval call, the card drained "
                      "before it"}


def _viterbi_gaps(emission, transition, lod):
    """float64 Viterbi over each sequence -> per row, the margin by which
    the decoded tag's chosen predecessor beats the runner-up (at a
    sequence's last row the smaller of that and the final tag's
    margin over the next best; inf where there is no runner-up)."""
    start, end, trans = transition[0], transition[1], transition[2:]
    gaps = np.full(len(emission), np.inf)

    def margin(v):
        top = np.sort(v)[::-1]
        return float(top[0] - top[1]) if len(top) > 1 else np.inf

    for s in range(len(lod) - 1):
        em = emission[lod[s]:lod[s + 1]]
        alphas = [start + em[0]]
        for t in range(1, len(em)):
            alphas.append((alphas[-1][:, None] + trans).max(0) + em[t])
        final = alphas[-1] + end
        tag = int(final.argmax())
        gaps[lod[s + 1] - 1] = margin(final)
        for t in range(len(em) - 1, 0, -1):
            scores = alphas[t - 1] + trans[:, tag]
            row = lod[s] + t
            gaps[row] = min(gaps[row], margin(scores))
            tag = int(scores.argmax())
    return gaps


def _srl_card_vs_cpu(card, place):
    """L_CPU_STEPS SGD steps of book07's program at full width on the
    card and on the CPU from the same startup values -> a record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    main, startup, loss, decode, _, feature = _srl_program()
    persist = _persistables(main)
    rng = np.random.RandomState(SEED + 8)
    feeds = [_srl_feed(rng, L_BATCH)[0] for _ in range(L_CPU_STEPS)]
    fetch = [loss, decode, feature, "crfw"]

    def run(exe):
        return [exe.run(main, feed=f, fetch_list=fetch) for f in feeds]

    scope = fluid.global_scope()
    exe = fluid.Executor(place, seed=SEED)
    exe.run(startup)
    init = {n: scope.find_var(n).clone() for n in persist}
    c_out = run(exe)
    card = {n: scope.find_var(n).cpu() for n in persist}
    exe.close()
    prev = executor_mod.switch_scope(Scope())
    try:
        cpu_scope = fluid.global_scope()
        for n in persist:
            cpu_scope.set_var(n, init[n].cpu())
        t0 = time.perf_counter()
        p_out = run(fluid.Executor(fluid.CPUPlace(), seed=SEED))
        cpu_s = time.perf_counter() - t0
        want = {n: cpu_scope.find_var(n) for n in persist}
    finally:
        executor_mod.switch_scope(prev)
    c_loss = [float(o[0][0]) for o in c_out]
    p_loss = [float(o[0][0]) for o in p_out]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(c_loss, p_loss)]
    rel = _states_rel_diff(card, want)
    worst = max(rel, key=rel.get)
    paths = []
    for step, (c, p) in enumerate(zip(c_out, p_out)):
        cp = np.asarray(c[1].data).reshape(-1)
        pp = np.asarray(p[1].data).reshape(-1)
        lod = p[1].lod[0]
        diff = np.flatnonzero(cp != pp)
        rec = {"step": step, "rows": len(pp), "differing_rows": len(diff)}
        gaps = _viterbi_gaps(np.asarray(p[2].data, np.float64),
                             np.asarray(p[3], np.float64), lod)
        rec["smallest_gap"] = float(gaps.min())
        if len(diff):
            rec["first_differing_row"] = int(diff[0])
            rec["gap_at_first_difference"] = float(gaps[diff[0]])
        paths.append(rec)
    record = {"batch": L_BATCH, "steps": L_CPU_STEPS, "card": c_loss,
              "cpu": p_loss, "loss_rel_diff": loss_rel,
              "loss_limit": N_CPU_LOSS_RTOL,
              "state_max_rel_diff": rel[worst], "state_argmax": worst,
              "state_limit": N_CPU_RTOL, "states": len(rel), "cpu_s": cpu_s,
              "viterbi_paths": paths}
    emit({"phase": "book07_card_vs_cpu", "card": card, **record})
    check(max(loss_rel) <= N_CPU_LOSS_RTOL, f"book07_card_vs_cpu: losses "
          f"{c_loss} against the CPU's {p_loss}")
    check(rel[worst] <= N_CPU_RTOL, f"book07_card_vs_cpu: {worst} differs "
          f"by {rel[worst]} of max(1, |CPU|)")
    check(all(p["differing_rows"] == 0 for p in paths),
          f"book07_card_vs_cpu: the card's Viterbi paths differ from the "
          f"CPU's: {paths}")
    return record


def book07_phase(card, place):
    """book/07's tagger at its published widths: the default mode
    against the interpreter (one device segment a LoD, the host
    chunk_eval), the pruned eval program, and card against CPU (see the
    L_ constants); one line each."""
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    prev_scope = executor_mod.switch_scope(Scope())
    try:
        t_phase = time.perf_counter()
        rec = _srl_train(card, place)
        emit({**rec, "seconds": time.perf_counter() - t_phase})
        t_phase = time.perf_counter()
        executor_mod.switch_scope(Scope())
        _srl_card_vs_cpu(card, place)
        emit({"phase": "book07_card_vs_cpu_done",
              "seconds": time.perf_counter() - t_phase})
    finally:
        executor_mod.switch_scope(prev_scope)
        torch.cuda.empty_cache()


# -- dp_gspmd phase ------------------------------------------------------------

def _scaling_program(depth, img, classes, dtype="bfloat16"):
    """benchmark/run_scaling.py's step (:46-59): bf16 images, ResNet
    (resnet_cifar10 up to 64 pixels, else resnet_imagenet), cross entropy,
    Momentum -> (main, startup, loss); `dtype` float32 runs it in float32
    throughout."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import models
    from paddle_tpu_torch.core import framework as fw

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        data = fluid.layers.data(name="img", shape=[3, img, img],
                                 dtype=dtype)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        if img <= 64:
            predict = models.resnet_cifar10(data, class_dim=classes,
                                            depth=min(depth, 32))
        else:
            predict = models.resnet_imagenet(data, class_dim=classes,
                                             depth=depth)
        avg = fluid.layers.mean(fluid.layers.cross_entropy(input=predict,
                                                           label=label))
        fluid.Momentum(learning_rate=P_LR,
                       momentum=P_MOMENTUM).minimize(avg)
    return main, startup, avg


def _steps_held(run_step, snapshot, steps=G_STEPS):
    """`steps` steps of `run_step(step)` -> (losses, seconds, {1: the
    `snapshot()` after the first step, P_HELD: after P_HELD steps})."""
    held = {}

    def step(i):
        out = run_step(i)
        if i + 1 in (1, P_HELD):
            torch.cuda.synchronize()
            held[i + 1] = snapshot()
        return out

    losses, secs, _ = _timed_steps(step, {}, steps)
    return losses, secs, held


def _grads_rel_diff(got, want):
    """{velocity: max |got - want| / max |want|} over Momentum's
    velocities, which after the first step are its gradients."""
    return {n: float((got[n].double() - want[n].double()).abs().max())
            / max(float(want[n].double().abs().max()), 1e-30)
            for n in want if n.endswith("_velocity_acc")}


def _held_against(what, losses, held, ref_losses, ref_held, bf16,
                  band=()):
    """-> a record of `losses` (the first P_HELD) and the states `held`
    after the first step and after P_HELD steps against the reference's:
    loss differences in bf16 ulps (bf16) or relative, the states' by
    _states_rel_diff, the first step's gradients by _grads_rel_diff (the
    batch norms' scales and shifts on their own too).  `band` holds the
    same records of runs that take the reference's steps in other
    orders: each limit is then twice the band's largest reading where
    that is the larger.  `failed` names what is outside its limit."""
    n = P_HELD
    diff = [abs(a - b) / (_bf16_ulp(b) if bf16 else abs(b))
            for a, b in zip(losses[:n], ref_losses[:n])]
    base = 1.0 if bf16 else N_CPU_LOSS_RTOL
    lims = [max([base] + [2 * b["loss_diff"][i] for b in band])
            for i in range(n)]
    rec = {"what": what, "losses": losses[:n], "reference": ref_losses[:n],
           "loss_diff": diff, "loss_limit": lims,
           "loss_unit": "bf16 ulps" if bf16 else "relative"}
    failed = [] if (all(np.isfinite(losses[:n])) and all(
        d <= lim for d, lim in zip(diff, lims))) else ["losses"]
    checks = [(f"after_step_{k}", "state_max_rel_diff",
               _states_rel_diff(held[k], {m: ref_held[k][m]
                                          for m in held[k]}))
              for k in sorted(held)]
    grads = _grads_rel_diff(held[1], ref_held[1])
    if grads:
        checks += [("grads_after_step_1", "grad_max_rel_diff", grads),
                   ("bn_grads_after_step_1", "grad_max_rel_diff",
                    {m: v for m, v in grads.items()
                     if m.startswith("batch_norm")})]
    for key, metric, rel in checks:
        if not rel:
            continue
        worst = max(rel, key=rel.get)
        lim = max([P_STATE_RTOL] + [2 * b[key][metric] for b in band])
        rec[key] = {metric: rel[worst], "argmax": worst,
                    "tensors": len(rel), "limit": lim}
        if rel[worst] > lim:
            failed.append(key.replace("_", " "))
    rec["failed"] = failed
    return rec


def _per_step(calls, steps):
    return {k.replace("_all_reduce", "").replace("_all_gather",
                                                 "_gather"): v / steps
            for k, v in calls.items()}


def _resnet50_dp1(card, place):
    """run_scaling's ResNet-50 step under a one-rank NCCL group: the
    Executor (interpreted) and the two arms, each G_STEPS steps from the
    same startup values -> a record."""
    import socket

    import paddle_tpu_torch as fluid
    import torch.distributed as dist

    phase = "resnet50_dp1"
    r = np.random.RandomState(0)
    feed = {"img": torch.from_numpy(r.rand(P_BATCH, 3, P_IMG, P_IMG)
                                    .astype(np.float32)).to(torch.bfloat16),
            "label": r.randint(0, P_CLASSES, (P_BATCH, 1)).astype(np.int64)}
    main, startup, loss = _scaling_program(P_DEPTH, P_IMG, P_CLASSES)
    persist = _persistables(main)
    scope = fluid.global_scope()
    exe = fluid.Executor(place, seed=SEED)
    exe.run(startup)
    init = {n: scope.find_var(n).clone() for n in persist}
    _reset_peak()
    e_loss, e_secs, e_held = _steps_held(
        lambda i: exe.run(main, feed=feed, fetch_list=[loss],
                          compiled=False)[0],
        lambda: {n: scope.find_var(n).clone() for n in persist})
    exe.close()
    rec = {"phase": phase, "card": card,
           "source": "benchmark/run_scaling.py:33-88 --depth 50 --img 224 "
                     "--batch-per-dev 64",
           "batch": P_BATCH, "dtype": "bfloat16",
           "optimizer": f"momentum {P_LR} / {P_MOMENTUM}",
           "executor": {"losses": e_loss,
                        "ms_per_step_3_6":
                            float(np.median(e_secs[2:])) * 1e3,
                        "peak_memory_bytes":
                            torch.cuda.max_memory_allocated()},
           "arms": {}}
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        for arm in ("parallel_executor", "sharding_transpiler"):
            main, startup, loss = _scaling_program(P_DEPTH, P_IMG, P_CLASSES)
            if arm == "parallel_executor":
                pe = fluid.ParallelExecutor(main, ["img", "label"], [loss],
                                            mesh={"dp": 1},
                                            startup_program=startup)
            else:
                t = fluid.ShardingTranspiler()
                t.transpile(program=main, startup_program=startup,
                            mesh={"dp": 1}, overlap="auto",
                            shard_optimizer_states=False)
                pe = t.build_executor(["img", "label"], [loss])
            check(pe.gspmd_form == "sync_bn",
                  f"{phase}: {arm} took the {pe.gspmd_form} form")
            for n in persist:
                if n in pe._states:
                    pe.set_state(n, init[n])
            _reset_peak()
            losses, secs, held = _steps_held(
                lambda i: pe.run(feed, return_numpy=False)[0],
                lambda: {n: pe.state(n, return_numpy=False)
                         for n in persist if n in pe._states})
            got = _held_against(arm, losses, held, e_loss, e_held, True)
            rec["arms"][arm] = {
                "form": pe.gspmd_form, "overlap_info": pe.overlap_info,
                "gspmd_info": pe.gspmd_info, "losses": losses,
                "ms_per_step_3_6": float(np.median(secs[2:])) * 1e3,
                "all_reduces_per_step": _per_step(pe.collective_calls,
                                                  G_STEPS),
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "against_executor": got}
            pe.close()
            del pe
    finally:
        dist.destroy_process_group()
    emit(rec)
    failed = []
    for arm, a in rec["arms"].items():
        if a["against_executor"]["failed"]:
            failed.append(f"{phase}: {arm} against the Executor: "
                          f"{a['against_executor']}")
        if not (a["all_reduces_per_step"]["stat"] > 0
                and a["all_reduces_per_step"]["grad"] > 0):
            failed.append(f"{phase}: {arm} all-reduces "
                          f"{a['all_reduces_per_step']}")
    return failed


def _dp2_programs():
    """{name: (build() -> (main, startup, loss), feed_of(rng), bf16)} of
    the dp2_one_card part: run_scaling's default step at the global batch
    of two ranks (bf16, as run_scaling runs it, and in float32), and
    book07's program."""
    def resnet(dtype):
        return lambda: _scaling_program(P2_DEPTH, P2_IMG, P2_CLASSES, dtype)

    def resnet_feed(dtype):
        def feed(r):
            x = r.rand(2 * P2_BATCH, 3, P2_IMG, P2_IMG).astype(np.float32)
            return {"img": torch.from_numpy(x).to(getattr(torch, dtype)),
                    "label": r.randint(0, P2_CLASSES, (2 * P2_BATCH, 1))
                    .astype(np.int64)}
        return feed

    def srl():
        return _srl_program()[:3]

    return {"resnet_cifar10": (resnet("bfloat16"), resnet_feed("bfloat16"),
                               True),
            "resnet_cifar10_fp32": (resnet("float32"),
                                    resnet_feed("float32"), False),
            "book07": (srl, lambda r: _srl_feed(r, L_BATCH)[0], False)}


def _dp2_serial(main, loss, init, feeds, steps=G_STEPS):
    """The Executor's steps at the global batch on the card from `init`
    -> {"losses", "held", "ms_per_step_3_6"}."""
    import paddle_tpu_torch as fluid

    scope = fluid.Scope()
    for n, v in init.items():
        scope.set_var(n, v.clone())
    exe = fluid.Executor(fluid.CUDAPlace(0), seed=SEED)
    losses, secs, held = _steps_held(
        lambda i: exe.run(main, feed=feeds[i], fetch_list=[loss],
                          scope=scope, compiled=False)[0],
        lambda: {n: scope.find_var(n).cpu() for n in init}, steps)
    exe.close()
    return {"losses": losses, "held": held,
            "ms_per_step_3_6": float(np.median(secs[2:])) * 1e3}


def _dp2_band(main, loss, init, feeds, twin):
    """The serial steps again in other orders: P2_PERMS runs with each
    batch's rows permuted, and where `twin` names a dtype, the program
    in that dtype from the same values -> {name: _dp2_serial's record}."""
    r = np.random.RandomState(SEED + 11)
    band = {}
    for k in range(P2_PERMS):
        perms = [torch.from_numpy(r.permutation(len(f["label"])))
                 for f in feeds]
        band[f"rows_permuted_{k}"] = _dp2_serial(
            main, loss, init, [{n: torch.as_tensor(v)[p]
                                for n, v in f.items()}
                               for f, p in zip(feeds, perms)], P_HELD)
    if twin:
        dt = getattr(torch, twin)

        def cast(v):
            v = torch.as_tensor(v)
            return v.to(dt) if v.is_floating_point() else v

        main2, _, loss2 = _scaling_program(P2_DEPTH, P2_IMG, P2_CLASSES,
                                           twin)
        band[twin] = _dp2_serial(
            main2, loss2, {n: cast(v) for n, v in init.items()},
            [{n: cast(v) for n, v in f.items()} for f in feeds], P_HELD)
    return band


def _dp2_worker(rank, port, out_dir):
    """One of the two gloo ranks on the one card: each dp2 program through
    ParallelExecutor(mesh={"dp": 2}) for G_STEPS steps; rank 0 then runs
    the Executor at the global batch from the same values, and the
    ResNets' bands."""
    import paddle_tpu_torch as fluid
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    out = {}
    try:
        for name, (build, feed_of, _) in _dp2_programs().items():
            main, startup, loss = build()
            persist = _persistables(main)
            r = np.random.RandomState(SEED + 9)
            feeds = [feed_of(r) for _ in range(P2_STEPS)]
            pe = fluid.ParallelExecutor(main, list(feeds[0]), [loss],
                                        mesh={"dp": 2},
                                        startup_program=startup,
                                        place=fluid.CUDAPlace(0))
            init = {n: pe.state(n, return_numpy=False) for n in persist
                    if n in pe._states}
            _reset_peak()
            losses, secs, held = _steps_held(
                lambda i: pe.run(feeds[i], return_numpy=False)[0],
                lambda: {n: pe.state(n, return_numpy=False).cpu()
                         for n in init}, P2_STEPS)
            rec = {"form": pe.gspmd_form, "losses": losses, "held": held,
                   "gspmd_info": pe.gspmd_info,
                   "ms_per_step_3_6": float(np.median(secs[2:])) * 1e3,
                   "all_reduces_per_step": _per_step(pe.collective_calls,
                                                     P2_STEPS),
                   "peak_memory_bytes": torch.cuda.max_memory_allocated()}
            pe.close()
            del pe
            if rank == 0:
                rec["serial"] = _dp2_serial(main, loss, init, feeds,
                                            P2_STEPS)
                if name in P2_TWIN:
                    rec["band"] = _dp2_band(main, loss, init, feeds,
                                            P2_TWIN[name])
            out[name] = rec
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _dp2_ranks(worker):
    """The two gloo ranks, each `worker` + [rank, port, out_dir] run as a
    process on the one card -> their records."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen(
            worker + [str(rank), str(port), d],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"dp2_one_card: rank {rank} exited "
                  f"{p.returncode}: {log[-3000:]}")
        return [torch.load(os.path.join(d, f"rank{r}.pt"))
                for r in range(2)]


def _dp2_verdict(card, ranks):
    """Every rank's results bit-equal, and rank 0's equal to its serial
    run at the global batch within the limits (the ResNets': their
    bands') -> (a record, what failed)."""
    phase = "dp2_one_card"
    rec = {"phase": phase, "card": card, "ranks": 2,
           "backend": "gloo (CUDA tensors through the host)",
           "timing_note": "gloo all-reduces through the host, both ranks "
                          "sharing one card: not a scaling number",
           "programs": {}}
    held_recs = []
    for name, (_, _, bf16) in _dp2_programs().items():
        a, b = ranks[0][name], ranks[1][name]
        same = (a["losses"] == b["losses"] and all(
            torch.equal(a["held"][k][n], b["held"][k][n])
            for k in a["held"] for n in a["held"][k]))
        ref = a["serial"]
        band = [_held_against(k, r["losses"], r["held"], ref["losses"],
                              ref["held"], bf16)
                for k, r in a.get("band", {}).items()]
        got = _held_against(name, a["losses"], a["held"], ref["losses"],
                            ref["held"], bf16, band)
        got["band"] = {r["what"]: {
            key: r[key] for key in r if key == "loss_diff"
            or key.startswith(("after_step", "grads", "bn_grads"))}
            for r in band}
        held_recs.append(got)
        rec["programs"][name] = {
            "form": a["form"], "gspmd_info": a["gspmd_info"],
            "global_batch": (L_BATCH if name == "book07"
                             else 2 * P2_BATCH),
            "ranks_bit_equal": same, "losses": a["losses"],
            "ms_per_step_3_6": [a["ms_per_step_3_6"], b["ms_per_step_3_6"]],
            "serial_ms_per_step_3_6": ref["ms_per_step_3_6"],
            "all_reduces_per_step": a["all_reduces_per_step"],
            "peak_memory_bytes": [a["peak_memory_bytes"],
                                  b["peak_memory_bytes"]],
            "against_serial": got}
    failed = []
    forms = {n: p["form"] for n, p in rec["programs"].items()}
    if forms != {"resnet_cifar10": "sync_bn", "book07": "replicated",
                 "resnet_cifar10_fp32": "sync_bn"}:
        failed.append(f"{phase}: forms {forms}")
    for name, p in rec["programs"].items():
        if not p["ranks_bit_equal"]:
            failed.append(f"{phase}: {name}: the two ranks' losses or "
                          "states differ")
    failed += [f"{phase}: {got['what']} against the serial run: "
               f"{got['failed']}" for got in held_recs if got["failed"]]
    return rec, failed


def _dp2_one_card(card):
    """Two processes on the one card over a gloo group (NCCL refuses two
    ranks on one device), this script run again as `--dp2-worker` ->
    what failed (_dp2_verdict)."""
    rec, failed = _dp2_verdict(card, _dp2_ranks(
        [sys.executable, os.path.abspath(__file__), "--dp2-worker"]))
    emit(rec)
    return failed


def dp_gspmd_phase(card, place):
    """The GSPMD step's forms on the card: resnet50_dp1 (NCCL, one rank)
    and dp2_one_card (two gloo ranks); one line each."""
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    prev_scope = executor_mod.switch_scope(Scope())
    try:
        t_phase = time.perf_counter()
        failed = _resnet50_dp1(card, place)
        emit({"phase": "resnet50_dp1_done",
              "seconds": time.perf_counter() - t_phase})
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        failed += _dp2_one_card(card)
        emit({"phase": "dp2_one_card_done",
              "seconds": time.perf_counter() - t_phase})
        check(not failed, "; ".join(failed))
    finally:
        executor_mod.switch_scope(prev_scope)
        torch.cuda.empty_cache()


# the tp_zero phase: the train phase's LM (run_ridge's width, bf16 amp,
# Momentum 0.01 / 0.9) trained through ShardingTranspiler(mesh={"dp": 2,
# "tp": 2}, shard_optimizer_states=True) with Megatron's placement
# (parallel/tensor_parallel.py megatron_placement) on TZ_RANKS gloo ranks
# on the one card, TZ_STEPS steps, against the serial Executor's steps
# from the same startup: losses within TZ_AMP_LOSS_RTOL (the tp
# all-reduce sums bf16 partial products that serial's GEMM sums in one
# f32 accumulator); then the same width at TZ_FP32_LAYERS layers in
# float32 (TF32 off), TZ_FP32_STEPS steps, every parameter within
# TZ_FP32_RTOL / TZ_FP32_ATOL (tests/test_spmd_sharding.py:425-427's)
TZ_MESH, TZ_RANKS, TZ_STEPS = {"dp": 2, "tp": 2}, 4, 2
TZ_FP32_LAYERS, TZ_FP32_STEPS = 2, 2
TZ_AMP_LOSS_RTOL, TZ_FP32_RTOL, TZ_FP32_ATOL = 2e-2, 2e-4, 1e-5


def _tz_arms():
    """{arm: (amp, n_layers, steps)} of the tp_zero phase, in run order
    (the float32 arm first: the smaller one)."""
    return {"fp32_2_layers": (False, TZ_FP32_LAYERS, TZ_FP32_STEPS),
            "amp_12_layers": (True, T_LAYERS, TZ_STEPS)}


def _tz_program(amp, n_layers):
    import paddle_tpu_torch as fluid

    if amp:
        fluid.amp.enable_bf16()     # before the Program is built
    else:
        fluid.amp.disable_bf16()
    return _lm_program(fluid.Momentum(learning_rate=0.01, momentum=0.9),
                       n_layers=n_layers)


def _tz_serial(arm, out_dir):
    """The serial Executor's steps of `arm` on the card from the startup
    a fresh Executor runs (the ranks' ParallelExecutor runs the same
    startup with the same seed) -> its record; its parameters written
    to out_dir for the ranks and freed."""
    import paddle_tpu_torch as fluid

    amp, n_layers, steps = _tz_arms()[arm]
    main, startup, loss = _tz_program(amp, n_layers)
    params = [p.name for p in main.global_block().all_parameters()]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    _reset_peak()
    losses, secs, _ = _timed_steps(
        lambda i: exe.run(main, feed=_train_feed(i), fetch_list=[loss],
                          scope=scope, compiled=False)[0], {}, steps)
    peak = torch.cuda.max_memory_allocated()
    torch.save({n: scope.find_var(n).cpu() for n in params},
               os.path.join(out_dir, f"serial_{arm}.pt"))
    exe.close()
    del scope, exe
    _reset_peak()
    fluid.amp.disable_bf16()
    return {"losses": losses, "ms_per_step": [s * 1e3 for s in secs],
            "peak_memory_bytes": peak, "parameters": len(params)}


def _tz_worker(rank, port, out_dir):
    """One of the TZ_RANKS gloo ranks on the one card: each arm through
    ShardingTranspiler(mesh=TZ_MESH) with Megatron's placement and
    ZeRO-1; rank 0 holds the whole parameters (`state`, gathered over
    the mesh) against the serial run's."""
    import paddle_tpu_torch as fluid
    import torch.distributed as dist
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.ops import attention as attention_op
    from paddle_tpu_torch.parallel import PartitionSpec
    from paddle_tpu_torch.parallel.mesh import (collective_bytes,
                                                count_collectives)
    from paddle_tpu_torch.parallel.tensor_parallel import \
        megatron_placement

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=TZ_RANKS, rank=rank)
    # the shapes the flash op hands the kernels (each rank's local heads)
    shapes = []
    wrapped = attention_op.flash_attention

    def record_shape(q, k, v, **kw):
        shapes.append([list(q.shape), str(q.dtype).split(".")[-1]])
        return wrapped(q, k, v, **kw)

    attention_op.flash_attention = record_shape
    out = {}
    try:
        for arm, (amp, n_layers, steps) in _tz_arms().items():
            t_arm = time.perf_counter()
            main, startup, loss = _tz_program(amp, n_layers)
            params = [p.name for p in main.global_block().all_parameters()]
            specs = megatron_placement(main)
            t = fluid.ShardingTranspiler()
            t.transpile(program=main, startup_program=startup, mesh=TZ_MESH,
                        shard_optimizer_states=True)
            t0 = time.perf_counter()
            pe = t.build_executor(
                ["ids", "lbl"], [loss], place=fluid.CUDAPlace(0),
                param_shardings={n: PartitionSpec(*s)
                                 for n, s in specs.items()})
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            _reset_peak()
            for k in fa.flash_attention.launches:
                fa.flash_attention.launches[k] = 0
            shapes.clear()
            losses, secs, _ = _timed_steps(
                lambda i: pe.run(_train_feed(i), return_numpy=False)[0],
                {}, steps)
            launches = dict(fa.flash_attention.launches)
            record = list(pe.collective_record)
            rec = {"form": pe.gspmd_form, "overlap_info": pe.overlap_info,
                   "gspmd_info": pe.gspmd_info, "losses": losses,
                   "ms_per_step": [s * 1e3 for s in secs],
                   "build_s": build_s,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                   "flash_launches": launches,
                   "flash_shapes": sorted({json.dumps(x) for x in shapes}),
                   "collectives_per_step": count_collectives(record),
                   "collective_bytes_per_step": collective_bytes(record),
                   "collectives_by_axis": {
                       a: count_collectives([c for c in record
                                             if c.axis == a])
                       for a in TZ_MESH},
                   "calls": dict(pe.collective_calls),
                   "zero_states": len(pe._zero_states),
                   "placed": len(specs),
                   "local_parameters": sum(
                       pe._states[n].numel() for n in params)}
            # each rank holds its blocks of the parameters against the
            # same blocks of the serial run's (the file mapped, not read
            # whole): no gather; the phase takes the largest over ranks
            t0 = time.perf_counter()
            serial = torch.load(os.path.join(out_dir, f"serial_{arm}.pt"),
                                mmap=True)
            lays = pe._tp.base
            diffs = {}
            for n in params:
                mine = pe._states[n].float()
                want = serial[n]
                if n in lays:
                    want = pe._model_groups[lays[n][1]].block(
                        want, lays[n][0])
                want = want.to(mine.device).float()
                d = (mine - want).abs()
                diffs[n] = {"max_abs": float(d.max()),
                            "max_abs_want": float(want.abs().max()),
                            "outside_tol": int((d > TZ_FP32_ATOL
                                                + TZ_FP32_RTOL
                                                * want.abs()).sum())}
            rec["param_diffs"] = diffs
            rec["compare_s"] = time.perf_counter() - t0
            rec["arm_s"] = time.perf_counter() - t_arm
            pe.close()
            del pe, serial
            _reset_peak()
            out[arm] = rec
            fluid.amp.disable_bf16()
    finally:
        attention_op.flash_attention = wrapped
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _tz_ranks(out_dir):
    """The TZ_RANKS gloo ranks, this script run again as
    `--tp-zero-worker RANK PORT DIR`, each a process on the one card ->
    their records."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-zero-worker",
         str(rank), str(port), out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(TZ_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"tp_zero: rank {rank} exited "
              f"{p.returncode}: {log[-3000:]}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(TZ_RANKS)]


def tp_zero_phase(card):
    """Tensor parallelism and ZeRO-1 on the card: the serial arms first
    (and freed), then the four ranks (_tz_worker); one line -> the amp
    arm's flash launches, {kind: [each rank's count]}."""
    import paddle_tpu_torch as fluid

    t_phase = time.perf_counter()
    amp_was = fluid.amp.is_bf16_enabled()
    try:
        with tempfile.TemporaryDirectory() as d:
            serial = {arm: _tz_serial(arm, d) for arm in _tz_arms()}
            serial_s = time.perf_counter() - t_phase
            ranks = _tz_ranks(d)
    finally:
        (fluid.amp.enable_bf16 if amp_was else fluid.amp.disable_bf16)()
    phase = "tp_zero"
    rec = {"phase": phase, "card": card, "mesh": TZ_MESH,
           "ranks": TZ_RANKS, "backend": "gloo (four processes on the one "
           "card; NCCL refuses two ranks on one device)",
           "timing_note": "four ranks share the card and every collective "
                          "goes through gloo: a correctness run, not a "
                          "scaling number", "arms": {}}
    failed = []
    for arm, (amp, n_layers, steps) in _tz_arms().items():
        r0, ref = ranks[0][arm], serial[arm]
        same = all(r[arm]["losses"] == r0["losses"] for r in ranks)
        loss_rel = [abs(a - b) / abs(b)
                    for a, b in zip(r0["losses"], ref["losses"])]
        # each parameter over the ranks' blocks: its largest difference
        # relative to its largest magnitude, and the elements outside
        # the float32 gate's tolerance
        diffs = {}
        for n in r0["param_diffs"]:
            per = [r[arm]["param_diffs"][n] for r in ranks]
            diffs[n] = {"max_abs": max(p["max_abs"] for p in per),
                        "max_rel": max(p["max_abs"] for p in per) / max(
                            max(p["max_abs_want"] for p in per), 1e-30),
                        "outside_tol": sum(p["outside_tol"] for p in per)}
        worst = max(diffs, key=lambda n: diffs[n]["max_rel"])
        outside = {n: v["outside_tol"] for n, v in diffs.items()
                   if v["outside_tol"]}
        kinds = {k: [r[arm]["flash_launches"][k] for r in ranks]
                 for k in r0["flash_launches"]}
        a = {"amp": amp, "n_layers": n_layers, "steps": steps,
             "form": r0["form"], "overlap_info": r0["overlap_info"],
             "losses": r0["losses"], "serial_losses": ref["losses"],
             "loss_rel_diff": loss_rel, "ranks_same_losses": same,
             "largest_param_rel_diff": {worst: diffs[worst]},
             "params_outside_fp32_tol": outside,
             "ms_per_step": {f"rank{i}": r[arm]["ms_per_step"]
                             for i, r in enumerate(ranks)},
             "serial_ms_per_step": ref["ms_per_step"],
             "peak_memory_bytes": [r[arm]["peak_memory_bytes"]
                                   for r in ranks],
             "serial_peak_memory_bytes": ref["peak_memory_bytes"],
             "local_parameters": [r[arm]["local_parameters"]
                                  for r in ranks],
             "zero_states": r0["zero_states"], "placed": r0["placed"],
             "collectives_per_step": r0["collectives_per_step"],
             "collective_bytes_per_step": r0["collective_bytes_per_step"],
             "collectives_by_axis": r0["collectives_by_axis"],
             "flash_launches": kinds, "flash_shapes": r0["flash_shapes"],
             "build_s": [r[arm]["build_s"] for r in ranks],
             "compare_s": [r[arm]["compare_s"] for r in ranks],
             "rank_arm_s": [r[arm]["arm_s"] for r in ranks]}
        if amp:
            a["gate"] = f"losses within {TZ_AMP_LOSS_RTOL} relative"
            if not all(x <= TZ_AMP_LOSS_RTOL for x in loss_rel):
                failed.append(f"{phase}: {arm} losses {loss_rel}")
        else:
            a["gate"] = (f"every parameter within {TZ_FP32_RTOL} relative "
                         f"and {TZ_FP32_ATOL} absolute")
            if outside:
                failed.append(f"{phase}: {arm} parameters outside the "
                              f"tolerance: {outside}")
        if not same:
            failed.append(f"{phase}: {arm}: the ranks' losses differ")
        if r0["form"] != "sharded":
            failed.append(f"{phase}: {arm} form {r0['form']}")
        if not all(np.isfinite(r0["losses"])):
            failed.append(f"{phase}: {arm} losses not finite")
        # the attention ran through the kernels on each rank's local
        # heads: one forward, dQ and dK/dV launch a layer a step
        want = {k: n_layers * steps for k in kinds}
        if any(v != [want[k]] * TZ_RANKS for k, v in kinds.items()):
            failed.append(f"{phase}: {arm} flash launches {kinds}")
        local = [T_BATCH // TZ_MESH["dp"], T_SEQ,
                 T_HEADS // TZ_MESH["tp"], T_D // T_HEADS]
        if [json.loads(x)[0] for x in r0["flash_shapes"]] != [local]:
            failed.append(f"{phase}: {arm} flash shapes "
                          f"{r0['flash_shapes']}")
        tp_reduce = r0["collectives_by_axis"]["tp"].get("all-reduce", 0)
        if tp_reduce != 6 * n_layers or "all-gather" not in \
                r0["collectives_by_axis"]["dp"]:
            failed.append(f"{phase}: {arm} collectives "
                          f"{r0['collectives_by_axis']}")
        rec["arms"][arm] = a
    rec["seconds"] = time.perf_counter() - t_phase
    rec["serial_arms_s"] = serial_s
    emit(rec)
    check(not failed, "; ".join(failed))
    return rec["arms"]["amp_12_layers"]["flash_launches"]


# the a9 phase: model parallelism and MoE on A9_RANKS gloo ranks on the
# one card (this script run again as `--a9-worker`), each arm held to
# the serial Executor's steps from the same startup (run first, in this
# process, their parameters written to a temp dir and freed):
#   pp4_gpipe     the train phase's LM (run_ridge's width, 12 layers,
#                 bf16 amp, Momentum 0.01 / 0.9) built with
#                 pipeline_stages=4, ShardingTranspiler(mesh={"dp": 1,
#                 "pp": 4}).build_executor -> PipelineExecutor, GPipe,
#                 A9_MICRO microbatches;
#   pp2_tp2_1f1b  the same width at 4 layers, amp, {"pp": 2, "tp": 2},
#                 1F1B (the stage's weights Megatron-split);
#   pp2_sp2       the same width at 4 layers, float32 (TF32 off),
#                 {"pp": 2, "sp": 2}, GPipe: ring attention on local
#                 [mb, 256, 16, 128] blocks;
#   ep4           run_moe's LM (the moe phase's M_* width) under amp
#                 through ParallelExecutor(mesh={"dp": 1, "ep": 4}) with
#                 every w_in / w_out placed P("ep"): 2 experts a rank;
#   raw           ring_attention and all_to_all_attention at
#                 [2, 512, 16, 128] float32, causal and full, against
#                 attention_reference; moe_ffn_a2a against moe_ffn at a
#                 per-source capacity of 16 (A9_MOE_*: nothing drops).
# Gates: amp arms' losses within A9_AMP_RTOL relative of serial (the
# tp_zero phase's amp gate), and the largest parameter difference from
# serial within A9_AMP_PARAM of the largest serial update of the arm (the
# ranks start from the serial startup's values; bf16 steps of other
# shapes round differently, so this catches a lost or misplaced
# gradient, not rounding; each parameter's figure is reported); the
# float32 arm's parameters within A9_FP32_RTOL / A9_FP32_ATOL
# elementwise; the raw forms within A9_RAW_ATOL of their reference.
A9_RANKS, A9_STEPS, A9_MICRO = 4, 2, 4
A9_AMP_RTOL, A9_FP32_RTOL, A9_FP32_ATOL, A9_RAW_ATOL = 2e-2, 2e-4, 1e-5, 1e-4
A9_AMP_PARAM = 0.25
A9_RAW_SHAPE = (2, 512, 16, 128)
A9_MOE_T, A9_MOE_CF = 64, 4.0


def _a9_arms():
    """{arm: (kind, amp, n_layers, mesh, executor keywords)} in run
    order."""
    return {
        "pp4_gpipe": ("lm", True, T_LAYERS, {"dp": 1, "pp": 4},
                      {"schedule": "gpipe"}),
        "pp2_tp2_1f1b": ("lm", True, 4, {"dp": 1, "pp": 2, "tp": 2},
                         {"schedule": "1f1b"}),
        "pp2_sp2": ("lm", False, 4, {"dp": 1, "pp": 2, "sp": 2},
                    {"schedule": "gpipe"}),
        "ep4": ("moe", True, M_LAYERS, {"dp": 1, "ep": 4}, {}),
    }


def _a9_program(kind, amp, n_layers, stages):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.models.moe import build_moe_lm

    (fluid.amp.enable_bf16 if amp else fluid.amp.disable_bf16)()
    if kind == "moe":
        fw.reset_unique_names()
        return build_moe_lm(M_BATCH, M_SEQ, M_VOCAB, M_D, M_HEADS, n_layers,
                            M_EXPERTS, M_TOPK, M_CF, aux_weight=M_AUX)
    return _lm_program(fluid.Momentum(learning_rate=0.01, momentum=0.9),
                       n_layers=n_layers, pipeline_stages=stages)


def _a9_serial(arm, out_dir):
    """The serial Executor's steps of `arm` on the card -> its record;
    its parameters written to out_dir for the ranks, then freed."""
    import paddle_tpu_torch as fluid

    kind, amp, n_layers, mesh, _ = _a9_arms()[arm]
    main, startup, loss = _a9_program(kind, amp, n_layers, mesh.get("pp"))
    params = [p.name for p in main.global_block().all_parameters()]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    _reset_peak()
    losses, secs, _ = _timed_steps(
        lambda i: exe.run(main, feed=_train_feed(i), fetch_list=[loss],
                          scope=scope, compiled=False)[0], {}, A9_STEPS)
    peak = torch.cuda.max_memory_allocated()
    torch.save({n: scope.find_var(n).cpu() for n in params},
               os.path.join(out_dir, f"serial_{arm}.pt"))
    exe.close()
    del scope, exe
    _reset_peak()
    fluid.amp.disable_bf16()
    return {"losses": losses, "ms_per_step": [x * 1e3 for x in secs],
            "peak_memory_bytes": peak, "parameters": len(params)}


def _a9_diffs(states, init, serial, blocks):
    """{param: its largest difference from serial, the largest serial
    update from the start (`init`: this rank's values before the steps),
    the elements outside the float32 gate} for this rank's `states`
    against the same blocks of the serial run's (`blocks(name,
    tensor)`)."""
    out = {}
    for n, mine in states.items():
        want = blocks(n, serial[n]).to(mine.device).float()
        d = (mine.float() - want).abs()
        out[n] = {"max_abs": float(d.max()),
                  "max_update": float((want - init[n].float()).abs().max()),
                  "outside_tol": int((d > A9_FP32_ATOL
                                      + A9_FP32_RTOL * want.abs()).sum())}
    return out


def _a9_record(pe, axes):
    from paddle_tpu_torch.parallel.mesh import (collective_bytes,
                                                count_collectives)

    record = list(pe.collective_record)
    return {a: {"counts": count_collectives([c for c in record
                                             if c.axis == a]),
                "bytes": collective_bytes([c for c in record
                                           if c.axis == a])}
            for a in axes}


def _a9_arm(arm, out_dir):
    """One arm on this rank -> its record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels.moe_dispatch import (
        moe_gate_dispatch, moe_gate_route_backward)
    from paddle_tpu_torch.parallel import PartitionSpec

    kind, amp, n_layers, mesh, kw = _a9_arms()[arm]
    t_arm = time.perf_counter()
    main, startup, loss = _a9_program(kind, amp, n_layers, mesh.get("pp"))
    params = [p.name for p in main.global_block().all_parameters()]
    t0 = time.perf_counter()
    if kind == "lm":
        t = fluid.ShardingTranspiler()
        t.transpile(program=main, startup_program=startup, mesh=mesh)
        pe = t.build_executor(["ids", "lbl"], [loss],
                              place=fluid.CUDAPlace(0), n_micro=A9_MICRO,
                              **kw)
    else:
        experts = [n for n in params if ".w_in" in n or ".w_out" in n]
        pe = fluid.ParallelExecutor(
            main, ["ids", "lbl"], [loss], mesh=mesh,
            startup_program=startup, place=fluid.CUDAPlace(0),
            param_shardings={n: PartitionSpec("ep") for n in experts})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if kind == "lm":
        held = [n for n in params if n in pe._states]
        lays = pe._tp_layouts
    else:
        held, lays = params, pe._tp.base
    init = {n: pe._states[n].clone() for n in held}
    _reset_peak()
    # the main path: the counts zeroed just before, read just after
    for k in fa.flash_attention.launches:
        fa.flash_attention.launches[k] = 0
    moe_gate_dispatch.launches = 0
    moe_gate_route_backward.launches = 0
    losses, secs, _ = _timed_steps(
        lambda i: pe.run(_train_feed(i), return_numpy=False)[0], {},
        A9_STEPS)
    rec = {"type": type(pe).__name__, "losses": losses,
           "ms_per_step": [x * 1e3 for x in secs], "build_s": build_s,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "flash_launches": dict(fa.flash_attention.launches),
           "route_launches": {"route": moe_gate_dispatch.launches,
                              "route_backward":
                                  moe_gate_route_backward.launches},
           "collectives_per_step": _a9_record(pe, mesh)}
    t0 = time.perf_counter()
    serial = torch.load(os.path.join(out_dir, f"serial_{arm}.pt"),
                        mmap=True)
    if kind == "lm":
        rec["stage"] = pe.stage
        rec["tp_param_specs"] = len(pe.tp_param_specs)
    mine = {n: pe._states[n] for n in held}
    groups = {a: pe.mesh.axis_group(a) for a in mesh}

    def blocks(n, t):
        lay = lays.get(n)
        return t if lay is None else groups[lay[1]].block(t, lay[0])

    rec["param_diffs"] = _a9_diffs(mine, init, serial, blocks)
    rec["held_parameters"] = len(mine)
    rec["local_parameter_elements"] = sum(v.numel() for v in mine.values())
    rec["compare_s"] = time.perf_counter() - t0
    rec["arm_s"] = time.perf_counter() - t_arm
    pe.close()
    del pe, serial, init
    _reset_peak()
    fluid.amp.disable_bf16()
    return rec


def _a9_raw(dev):
    """ring / Ulysses attention and moe_ffn_a2a on the four ranks."""
    import importlib

    from paddle_tpu_torch.kernels.moe_dispatch import moe_gate_dispatch
    from paddle_tpu_torch.parallel import make_mesh

    ra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")
    moe = importlib.import_module("paddle_tpu_torch.parallel.moe")
    gen = torch.Generator().manual_seed(SEED)
    q, k, v = (torch.randn(A9_RAW_SHAPE, generator=gen).to(dev)
               for _ in range(3))
    mesh = make_mesh({"sp": A9_RANKS})
    out = {}
    for causal in (False, True):
        ref = ra.attention_reference(q, k, v, causal=causal)
        for form, fn in (("ring", ra.ring_attention),
                         ("ulysses", ra.all_to_all_attention)):
            got = fn(q, k, v, mesh, "sp", causal=causal)
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(q, k, v, mesh, "sp", causal=causal)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            out[f"{form}_{'causal' if causal else 'full'}"] = {
                "max_abs_err": float((got - ref).abs().max()),
                "ms": sorted(secs)[1] * 1e3}
    ep = make_mesh({"ep": A9_RANKS})
    x = torch.randn(A9_MOE_T, M_D, generator=gen).to(dev)
    gw = (torch.randn(M_D, M_EXPERTS, generator=gen) * M_GATE_STD).to(dev)
    wi = (torch.randn(M_EXPERTS, M_D, 4 * M_D, generator=gen)
          * M_D ** -0.5).to(dev)
    wo = (torch.randn(M_EXPERTS, 4 * M_D, M_D, generator=gen)
          * (4 * M_D) ** -0.5).to(dev)
    before = moe_gate_dispatch.launches
    y_rep, aux_rep = moe.moe_ffn(x, gw, wi, wo, ep, capacity_factor=A9_MOE_CF,
                                 top_k=M_TOPK)
    y_a2a, aux_a2a = moe.moe_ffn_a2a(x, gw, wi, wo, ep,
                                     capacity_factor=A9_MOE_CF,
                                     top_k=M_TOPK)
    out["moe_a2a_vs_replicated"] = {
        "tokens": A9_MOE_T,
        "capacity": moe._capacity(A9_MOE_T, M_EXPERTS, A9_MOE_CF, M_TOPK),
        "a2a_capacity": moe._capacity(A9_MOE_T // A9_RANKS, M_EXPERTS,
                                      A9_MOE_CF, M_TOPK),
        "max_abs_err": float((y_a2a - y_rep).abs().max()),
        "max_abs_y": float(y_rep.abs().max()),
        "aux": [float(aux_rep), float(aux_a2a)],
        "route_launches": moe_gate_dispatch.launches - before}
    return out


def _a9_worker(rank, port, out_dir):
    """One of the A9_RANKS gloo ranks on the one card: every arm, then
    the raw forms."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=A9_RANKS, rank=rank)
    out = {}
    try:
        for arm in _a9_arms():
            out[arm] = _a9_arm(arm, out_dir)
        t0 = time.perf_counter()
        out["raw"] = _a9_raw(torch.device("cuda", 0))
        out["raw"]["seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"a9_rank{rank}.pt"))


def _a9_ranks(out_dir):
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--a9-worker",
         str(rank), str(port), out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(A9_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"a9: rank {rank} exited "
              f"{p.returncode}: {log[-3000:]}")
    return [torch.load(os.path.join(out_dir, f"a9_rank{r}.pt"))
            for r in range(A9_RANKS)]


def a9_phase(card):
    """Pipeline, tensor x pipeline, sequence x pipeline and expert
    parallelism on the card: the serial arms first (and freed), then the
    four ranks (_a9_worker); one line -> {kernel kind: {arm: [each
    rank's launches]}}."""
    import paddle_tpu_torch as fluid

    t_phase = time.perf_counter()
    amp_was = fluid.amp.is_bf16_enabled()
    try:
        with tempfile.TemporaryDirectory() as d:
            serial = {arm: _a9_serial(arm, d) for arm in _a9_arms()}
            serial_s = time.perf_counter() - t_phase
            ranks = _a9_ranks(d)
    finally:
        (fluid.amp.enable_bf16 if amp_was else fluid.amp.disable_bf16)()
    phase = "a9"
    rec = {"phase": phase, "card": card, "ranks": A9_RANKS,
           "steps": A9_STEPS, "n_micro": A9_MICRO,
           "backend": "gloo (four processes on the one card; every "
                      "stage hop, ring shift and all_to_all through host "
                      "copies)",
           "timing_note": "four ranks share the card: a correctness run, "
                          "not a scaling number", "arms": {}}
    failed = []
    launches = {"fwd": {}, "dq": {}, "dkv": {}, "route": {},
                "route_backward": {}}
    for arm, (kind, amp, n_layers, mesh, kw) in _a9_arms().items():
        r0, ref = ranks[0][arm], serial[arm]
        same = all(r[arm]["losses"] == r0["losses"] for r in ranks)
        loss_rel = [abs(a - b) / abs(b)
                    for a, b in zip(r0["losses"], ref["losses"])]
        diffs = {}
        for r in ranks:
            for n, v in r[arm]["param_diffs"].items():
                cur = diffs.setdefault(n, {"max_abs": 0.0,
                                           "max_update": 0.0,
                                           "outside_tol": 0})
                cur["max_abs"] = max(cur["max_abs"], v["max_abs"])
                cur["max_update"] = max(cur["max_update"], v["max_update"])
                cur["outside_tol"] += v["outside_tol"]
        for v in diffs.values():
            v["max_rel"] = v["max_abs"] / max(v["max_update"], 1e-30)
        worst = max(diffs, key=lambda n: diffs[n]["max_rel"])
        outside = {n: v["outside_tol"] for n, v in diffs.items()
                   if v["outside_tol"]}
        flash = {k: [r[arm]["flash_launches"][k] for r in ranks]
                 for k in ("fwd", "dq", "dkv")}
        route = {k: [r[arm]["route_launches"][k] for r in ranks]
                 for k in ("route", "route_backward")}
        for k, v in {**flash, **route}.items():
            launches[k][arm] = v
        a = {"kind": kind, "amp": amp, "n_layers": n_layers, "mesh": mesh,
             **kw, "executor": r0["type"],
             "stages": [r[arm].get("stage") for r in ranks],
             "losses": r0["losses"], "serial_losses": ref["losses"],
             "loss_rel_diff": loss_rel, "ranks_same_losses": same,
             "largest_param_rel_diff": {worst: diffs[worst]},
             "params_held": len(diffs),
             "ms_per_rank_step": {f"rank{i}": r[arm]["ms_per_step"]
                                  for i, r in enumerate(ranks)},
             "serial_ms_per_step": ref["ms_per_step"],
             "peak_memory_bytes": [r[arm]["peak_memory_bytes"]
                                   for r in ranks],
             "serial_peak_memory_bytes": ref["peak_memory_bytes"],
             "local_parameter_elements": [
                 r[arm]["local_parameter_elements"] for r in ranks],
             "collectives_per_step": {f"rank{i}": r[arm][
                 "collectives_per_step"] for i, r in enumerate(ranks)},
             "flash_launches": flash, "route_launches": route,
             "build_s": [r[arm]["build_s"] for r in ranks],
             "rank_arm_s": [r[arm]["arm_s"] for r in ranks]}
        if "tp_param_specs" in r0:
            a["tp_param_specs"] = r0["tp_param_specs"]
        a["largest_param_diff"] = max(v["max_abs"] for v in diffs.values())
        a["largest_serial_update"] = max(v["max_update"]
                                         for v in diffs.values())
        a["param_diff_over_update"] = a["largest_param_diff"] / max(
            a["largest_serial_update"], 1e-30)
        if amp:
            a["gate"] = (f"losses within {A9_AMP_RTOL} relative; the "
                         f"largest parameter difference within "
                         f"{A9_AMP_PARAM} of the largest serial update")
            if not all(x <= A9_AMP_RTOL for x in loss_rel) or \
                    a["param_diff_over_update"] > A9_AMP_PARAM:
                failed.append(f"{phase}: {arm} losses {loss_rel}, "
                              f"parameters {a['param_diff_over_update']}")
        else:
            a["gate"] = (f"every parameter within {A9_FP32_RTOL} relative "
                         f"and {A9_FP32_ATOL} absolute")
            if outside:
                failed.append(f"{phase}: {arm} parameters outside the "
                              f"tolerance: {outside}")
        if not same:
            failed.append(f"{phase}: {arm}: the ranks' losses differ")
        if not all(np.isfinite(r0["losses"])):
            failed.append(f"{phase}: {arm} losses not finite")
        if len(diffs) != ref["parameters"]:
            failed.append(f"{phase}: {arm} ranks hold {len(diffs)} of "
                          f"{ref['parameters']} parameters")
        # the kernels ran on the main path: flash on every pipeline rank
        # (none under sp, which rings), the route kernels on every ep rank
        if kind == "lm":
            per = n_layers // mesh["pp"] * A9_MICRO * A9_STEPS
            want = 0 if mesh.get("sp", 1) > 1 else per
            if any(v != [want] * A9_RANKS for v in flash.values()):
                failed.append(f"{phase}: {arm} flash launches {flash}, "
                              f"want {want} each")
            if r0["type"] != "PipelineExecutor":
                failed.append(f"{phase}: {arm} built {r0['type']}")
        else:
            if route["route"] != [2 * n_layers * A9_STEPS] * A9_RANKS or \
                    route["route_backward"] != [n_layers * A9_STEPS] * \
                    A9_RANKS:
                failed.append(f"{phase}: {arm} route launches {route}")
        rec["arms"][arm] = a
    raw = {k: v for k, v in ranks[0]["raw"].items()}
    for k, v in raw.items():
        if isinstance(v, dict) and "max_abs_err" in v:
            errs = [r["raw"][k]["max_abs_err"] for r in ranks]
            v["max_abs_err"] = max(errs)
            if not v["max_abs_err"] <= A9_RAW_ATOL:
                failed.append(f"{phase}: raw {k} error {errs}")
    rec["raw"] = raw
    rec["raw_gate"] = f"within {A9_RAW_ATOL} absolute of the reference"
    rec["seconds"] = time.perf_counter() - t_phase
    rec["serial_arms_s"] = serial_s
    emit(rec)
    check(not failed, "; ".join(failed))
    return launches


_REPLAY_NOTE = ("launches: the wrappers' count over the main path, which "
                "runs them at the Executor's eager first step and at the "
                "capture; a replay runs the captured kernels without the "
                "wrapper: replayed_per_step is the profiler's count in a "
                "replayed step")
_A9_NOTE = ("launches_a9: the a9 phase's count on its main path, {arm: "
            "[each of its four ranks' wrapper count over the arm's "
            "steps]}: the pipeline arms' stages (none under sp, whose "
            "attention rings), the ep arm's routing")
_PS_NOTE = ("launches_pserver: the pserver phase's seq2seq_t1 arm, the "
            "wrappers' count over its trainer's three rounds on the card "
            "(the device segment's eager run and its capture, each the "
            "serial step's launches; the third round a replay)")
_AOT_NOTE = ("launches_aot: the aot_native phase's count over the calls of "
             "the loaded torch.export artifacts on the card (the LM's, at "
             "4 and 1 layers, a go block's call among them, for the "
             "flash forward; the MoE LM's for the route kernel), each "
             "through the op paddle_tpu_torch::flash_attention_fwd or "
             "paddle_tpu_torch::moe_gate_route")


# -- pserver phase (A11's wire): trainers on the card, pservers on the host --

# arm -> (model, trainer processes, rounds): ctr_t1 and seq2seq_t1 train
# in this process, held against the serial Executor; ctr_t2 and
# vgg16_cluster in two worker processes on the card.  Two pservers an
# arm, on the host, in subprocesses started through
# paddle_tpu_torch.launch.
PS_ARMS = {"ctr_t1": ("ctr", 1, 3), "ctr_t2": ("ctr", 2, 4),
           "vgg16_cluster": ("vgg16", 2, 6), "seq2seq_t1": ("s2s", 1, 3)}
PS_PSERVERS = 2
# the arms whose pservers have static endpoints, all served by the same
# two pserver processes (ctr_t2's come through its registry); the two
# trainer processes run ctr_t2, then vgg16_cluster
PS_STATIC = ("ctr_t1", "vgg16_cluster", "seq2seq_t1")
# vgg16_cluster: benchmark/run_cluster_vgg16.py's build (:44-59) at its
# defaults (:174-176); its first round warms up, the rest are timed
PS_VGG_BATCH, PS_VGG_CLASSES = 128, 10
# ctr_t2: the seeded CTR set as RecordIO chunks of one batch each, two
# tasks of four chunks: one a trainer, one chunk a round.  A first task
# of four empty chunks is held open by the phase until both trainers
# are done: the master starts the next pass at the first get_task after
# the pass's last FIN, and a reader still polling would take a task of
# it
PS_CTR_CHUNKS, PS_CTR_CHUNKS_PER_TASK = 8, 4
# seq2seq_t1's gate (amp), _ps_s2s_gate: every round's parameters and
# loss bit-equal to the serial step's.  The host's Adam takes its square
# root correctly rounded (ops/_math.py), as the card's does, so the
# pservers' updates are the serial Executor's bit for bit; a dropped,
# repeated or stale round is a round's update off
PS_S2S_GATE = ("every round's parameters and loss bit-equal to the "
               "serial step's")


def _ps_s2s_gate(per_round, losses, serial_losses):
    """seq2seq_t1's gate over a run's rounds against the serial steps
    (`per_round`: _ps_round_diffs of its parameters after each round)
    and its losses -> the failures."""
    failed = []
    if len(per_round) != len(serial_losses):
        failed.append(f"rounds {len(per_round)} of {len(serial_losses)}")
    off = [x["not_bit_equal"] for x in per_round]
    if any(off):
        failed.append(f"rounds not bit-equal to the serial steps "
                      f"(elements off a round: {off}; updates off by "
                      f"{[x['update_err'] for x in per_round]})")
    if list(losses) != list(serial_losses):
        failed.append(f"losses {list(losses)} vs serial "
                      f"{list(serial_losses)}")
    return failed


def _ps_build(arm):
    """The arm's Program, built alike by its pservers and trainers ->
    (main, startup, loss, optimize ops, params and grads)."""
    import paddle_tpu_torch as fluid

    model = PS_ARMS[arm][0]
    if model == "ctr":
        main, startup, loss, opt = _ctr_program(
            "deepfm", True, lambda f: f.Adam(learning_rate=X_LR),
            with_opt=True)
    elif model == "s2s":
        main, startup, loss, opt = _s2s_program(with_opt=True)
    else:
        from paddle_tpu_torch.core import framework as fw
        from paddle_tpu_torch.models.vgg import vgg16_bn_drop

        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            img = fluid.layers.data(name="pixel", shape=[3, 32, 32],
                                    dtype="float32")
            label = fluid.layers.data(name="label", shape=[1],
                                      dtype="int64")
            predict = vgg16_bn_drop(img, class_dim=PS_VGG_CLASSES)
            loss = fluid.layers.mean(
                fluid.layers.cross_entropy(input=predict, label=label))
            opt = fluid.SGD(learning_rate=0.01).minimize(loss)
    return (main, startup, loss) + tuple(opt)


def _ps_transpile(arm, built, pservers):
    import paddle_tpu_torch as fluid

    main, startup, _, opt_ops, pg = built
    t = fluid.DistributeTranspiler()
    with fluid.program_guard(main, startup):
        t.transpile(optimize_ops=opt_ops, params_grads=pg,
                    trainers=PS_ARMS[arm][1], pservers=pservers)
    return t


def _ps_batches(arm, master_ep=None, out_dir=None):
    """The arm's batches, a generator of host feeds: ctr_t1 _ctr_feeds'
    seeded batches; ctr_t2 read through cloud_reader from the master
    (one RecordIO chunk of 2048 records a batch); vgg16 one seeded batch
    every round, as run_cluster_vgg16 feeds it (:104-106); seq2seq
    _s2s_feed."""
    model = PS_ARMS[arm][0]
    if arm == "ctr_t1":
        yield from _ctr_feeds(PS_ARMS[arm][2])
    elif arm == "ctr_t2":
        import paddle_tpu_torch as fluid

        reader = fluid.reader.creator.cloud_reader(
            os.path.join(out_dir, "ctr_chunk*.rec"), master_ep,
            timeout_sec=30, buf_size=X_BATCH)
        rows = []
        for rec in reader():
            rows.append(rec)
            if len(rows) == X_BATCH:
                ids = np.asarray([r[0] for r in rows], np.int64)
                feed = {f"slot{i}": torch.from_numpy(
                    np.ascontiguousarray(ids[:, i:i + 1]))
                    for i in range(X_SLOTS)}
                feed["dense"] = torch.from_numpy(
                    np.asarray([r[1] for r in rows], np.float32))
                feed["label"] = torch.from_numpy(
                    np.asarray([[r[2]] for r in rows], np.float32))
                rows = []
                yield feed
    elif model == "vgg16":
        r = np.random.RandomState(0)
        feed = {"pixel": r.rand(PS_VGG_BATCH, 3, 32, 32).astype(np.float32),
                "label": r.randint(0, PS_VGG_CLASSES,
                                   (PS_VGG_BATCH, 1)).astype(np.int64)}
        while True:
            yield feed
    else:
        feed = _s2s_feed()
        while True:
            yield feed


def _ps_write_ctr_chunks(out_dir):
    """The seeded CTR set (_ctr_feeds' batches) as RecordIO chunks, one
    batch a chunk, a record (26 ids, 13 dense features, the click) ->
    (the held task's empty chunks, the set's chunks)."""
    from paddle_tpu_torch.reader.creator import write_recordio

    held = []
    for c in range(PS_CTR_CHUNKS_PER_TASK):
        held.append(os.path.join(out_dir, f"ctr_hold{c}.rec"))
        write_recordio(held[-1], [])
    paths = []
    for c, feed in enumerate(_ctr_feeds(PS_CTR_CHUNKS)):
        ids = np.concatenate([feed[f"slot{i}"].numpy()
                              for i in range(X_SLOTS)], axis=1).tolist()
        dense = feed["dense"].numpy().tolist()
        label = feed["label"].numpy()[:, 0].tolist()
        path = os.path.join(out_dir, f"ctr_chunk{c}.rec")
        write_recordio(path, list(zip(ids, dense, label)))
        paths.append(path)
    return held, paths


def _ps_digest(values):
    """sha256 over the values' bytes, in name order."""
    import hashlib

    h = hashlib.sha256()
    for n in sorted(values):
        t = values[n].detach().cpu().contiguous()
        h.update(n.encode() + t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _ps_round_counters(pool):
    """bytes and frames the pool's clients have moved so far."""
    out = {"bytes_sent": 0, "bytes_recv": 0, "frames": {}}
    for c in list(pool._clients.values()):
        out["bytes_sent"] += c.bytes_sent
        out["bytes_recv"] += c.bytes_recv
        for verb, n in c.frames.items():
            out["frames"][verb] = out["frames"].get(verb, 0) + n
    return out


def _ps_train(arm, pservers, trainer_id, built=None, batches=None,
              snapshots=False):
    """One trainer of `arm` on the card against the pservers `pservers`:
    the startup program (its recv ops pull the pservers' parameters),
    then the arm's rounds of the transpiled program -> its record:
    losses; each round's ms, split into the device segment and the
    host part (the send op: device-to-host copies, the wire round —
    bucketed sends, barrier, pull — and the host-to-device copies into
    the parameters); bytes and frames a round; the flash wrappers'
    launches a round; peak memory; with `snapshots`, the parameters
    after each round.  `built`: the arm's (_ps_build, transpiler), else
    built here; `batches`: its feeds, else _ps_batches'."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.kernels.flash_attention import flash_attention
    from paddle_tpu_torch.ops import distributed as dist_ops
    from paddle_tpu_torch.parallel import comm

    model, _, rounds = PS_ARMS[arm]
    flash = flash_attention.launches
    if model == "s2s":
        fluid.amp.enable_bf16()
    marks = {"begin": time.time()}
    if built is None:
        b = _ps_build(arm)
        built = b, _ps_transpile(arm, b, pservers)
    (main, startup, loss, _, pg), t = built
    names = sorted(p.name for p, _ in pg)
    marks["built"] = time.time()
    prev_scope = executor_mod.switch_scope(Scope())
    scope = executor_mod.global_scope()
    secs = {"host": [], "wire": [], "h2d": []}
    orig_round, orig_into = comm.elastic_round, dist_ops._into_scope

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[key].append(time.perf_counter() - t0)
            return out
        return run

    def host_part(lower):
        def run(ctx, ins, attrs):
            torch.cuda.synchronize()    # the device segment ends here
            return timed("host", lower)(ctx, ins, attrs)
        return run

    exe = None
    try:
        torch.cuda.reset_peak_memory_stats()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        marks["startup"] = time.time()
        init = {n: scope.find_var(n).detach().clone() for n in names}
        pool = comm.comm_pool()
        prog = t.get_trainer_program()
        batches = batches if batches is not None else _ps_batches(arm)
        losses, round_s, per_round, snaps = [], [], [], []
        comm.elastic_round = timed("wire", orig_round)
        dist_ops._into_scope = timed("h2d", orig_into)
        with _wrapped_lowering("send", host_part):
            for _ in range(rounds):
                feed = next(batches)
                before = _ps_round_counters(pool)
                f0 = dict(flash)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, = exe.run(prog, feed=feed, fetch_list=[loss])
                torch.cuda.synchronize()
                round_s.append(time.perf_counter() - t0)
                losses.append(float(np.asarray(out).reshape(-1)[0]))
                after = _ps_round_counters(pool)
                per_round.append({
                    "bytes_sent": after["bytes_sent"] - before["bytes_sent"],
                    "bytes_recv": after["bytes_recv"] - before["bytes_recv"],
                    "frames": {v: n - before["frames"].get(v, 0)
                               for v, n in after["frames"].items()
                               if n - before["frames"].get(v, 0)},
                    "flash": {k: flash[k] - f0[k] for k in flash}})
                if snapshots:
                    snaps.append({n: scope.find_var(n).detach().clone()
                                  for n in names})
        marks["rounds"] = time.time()
        final = {n: scope.find_var(n).detach().clone() for n in names}
        peak = torch.cuda.max_memory_allocated()
    finally:
        comm.elastic_round, dist_ops._into_scope = orig_round, orig_into
        if exe is not None:
            exe.close()
        executor_mod.switch_scope(prev_scope)
        comm.reset_comm_pool()
        if model == "s2s":
            fluid.amp.disable_bf16()
    rounds_ms = []
    for i, s in enumerate(round_s):
        host, wire, h2d = secs["host"][i], secs["wire"][i], secs["h2d"][i]
        rounds_ms.append({"round_ms": s * 1e3,
                          "device_segment_ms": (s - host) * 1e3,
                          "host_ms": host * 1e3,
                          "d2h_ms": (host - wire - h2d) * 1e3,
                          "wire_ms": wire * 1e3, "h2d_ms": h2d * 1e3,
                          **per_round[i]})
    marks["closed"] = time.time()
    return {"arm": arm, "trainer_id": trainer_id, "losses": losses,
            "marks": marks,
            "rounds": rounds_ms, "startup_s": startup_s,
            "peak_memory_bytes": peak, "n_params": sum(
                v.numel() for v in final.values()),
            "digest": _ps_digest(final), "init": init, "final": final,
            "snapshots": snaps}


def _ps_serve(startup, pserver):
    """One arm's pserver: its startup program, then its listen_and_serv
    program (serving until a client stops it), in a CPU Executor and a
    scope of its own."""
    import paddle_tpu_torch as fluid

    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(pserver, scope=scope)


def _ps_worker(kind, out_dir, master_ep=None):
    """A process of the pserver phase, its role from TRAINING_ROLE (the
    launcher's environment):

    * "static" PSERVER (two of them): the i-th pserver of each static
      arm (PS_STATIC; i its SERVER_ENDPOINT's place in ctr_t1's list,
      the other arms' endpoints in the phase's endpoints.json), each
      arm's server on a thread of its own;
    * "ctr_t2" PSERVER: one of ctr_t2's, found through the registry;
    * "ctr_t2" TRAINER (two of them): ctr_t2's trainer (pservers from
      the registry, batches through cloud_reader), then
      vgg16_cluster's; both Programs built first, then each arm waits
      for its go file and writes its record."""
    import threading

    from paddle_tpu_torch.cloud.registry import resolve_pserver_cluster

    t_entry = time.time()
    role = os.environ["TRAINING_ROLE"]
    with open(os.path.join(out_dir, "endpoints.json")) as f:
        static_eps = json.load(f)
    if kind == "static":
        i = static_eps["ctr_t1"].index(os.environ["SERVER_ENDPOINT"])
        serving = []
        for arm in PS_STATIC:
            # every Program is built here, before the next arm's
            # thread starts: the default programs and unique names
            # are process-global
            eps = static_eps[arm]
            t = _ps_transpile(arm, _ps_build(arm), ",".join(eps))
            serving.append(threading.Thread(target=_ps_serve, args=(
                t.get_startup_program(eps[i]),
                t.get_pserver_program(eps[i]))))
            serving[-1].start()
        for th in serving:
            th.join()
        return
    pservers, my_ep, lease = resolve_pserver_cluster(timeout_s=120.0)
    if role == "PSERVER":
        t = _ps_transpile(kind, _ps_build(kind), pservers)
        _ps_serve(t.get_startup_program(my_ep), t.get_pserver_program(my_ep))
        lease.release()
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tid = int(os.environ["PADDLE_INIT_TRAINER_ID"])
    torch.cuda.init()
    # the Programs are built while earlier arms run (a fresh process's
    # first build also pays the lazy imports)
    plan = []
    for arm, eps in (("ctr_t2", pservers),
                     ("vgg16_cluster", ",".join(static_eps["vgg16_cluster"]))):
        b = _ps_build(arm)
        plan.append((arm, eps, (b, _ps_transpile(arm, b, eps)),
                     _ps_batches(arm, master_ep, out_dir)))
    t_ready = time.time()
    with open(os.path.join(out_dir, f"ready_{tid}"), "w"):
        pass
    for arm, eps, built, batches in plan:
        while not os.path.exists(os.path.join(out_dir, f"go_{arm}")):
            time.sleep(0.02)
        t_go = time.time()
        rec = _ps_train(arm, eps, tid, built, batches)
        del rec["init"], rec["final"], rec["snapshots"]
        rec["clock"] = {"entry": t_entry, "ready": t_ready, "go": t_go,
                        **rec.pop("marks"), "done": time.time()}
        path = os.path.join(out_dir, f"{arm}_trainer{tid}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(path + ".tmp", path)
    # out at once: ctr_t2's cloud_reader worker still polls the master
    # (the held task keeps the pass open), and closing it would wait
    # out its join timeout
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _ps_free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _ps_wait_ready(out_dir, static_eps, registry, timeout=300):
    """Until both trainer processes have built their Programs (their
    ready files) and every pserver serves: the arms then run on a quiet
    host, their rounds timed without processes booting beside them."""
    import socket

    deadline = time.time() + timeout
    want = [f"ready_{tid}" for tid in range(PS_ARMS["ctr_t2"][1])]
    while not all(os.path.exists(os.path.join(out_dir, w)) for w in want):
        check(time.time() < deadline, "pserver: trainers not ready")
        time.sleep(0.05)
    for ep in static_eps:
        host, port = ep.rsplit(":", 1)
        while True:
            try:
                socket.create_connection((host, int(port)), 1.0).close()
                break
            except OSError:
                check(time.time() < deadline, f"pserver: {ep} not up")
                time.sleep(0.05)
    check(registry.wait_ready("pserver", PS_PSERVERS,
                              max(deadline - time.time(), 0.0)),
          "pserver: the registry's pservers not up")


def _ps_go(arm, out_dir):
    """Release the arm's trainer processes (_ps_worker) -> the time."""
    with open(os.path.join(out_dir, f"go_{arm}"), "w"):
        pass
    return time.time()


def _ps_launch(kind, out_dir, trainers=0, registry=False, extra=(),
               endpoints=None):
    """Start the phase's processes of `kind` through
    paddle_tpu_torch.launch (each sends its output to the phase's log,
    _ps_log_to) -> (procs, the registry or None)."""
    from paddle_tpu_torch import launch

    script = os.path.abspath(__file__)
    args = ["--pserver-worker", kind, out_dir, *extra]
    if registry:
        reg, procs = launch.launch_registry_cluster(
            script, args, PS_PSERVERS, trainers)
        return procs, reg
    return launch.launch_pserver_cluster(
        script, args, PS_PSERVERS, trainers,
        endpoints=",".join(endpoints)), None


def _ps_log_to(out_dir):
    """Send this process's output (its descriptors 1 and 2) to the
    pserver phase's log, processes.log in `out_dir`."""
    sys.stdout.flush()
    sys.stderr.flush()
    fd = os.open(os.path.join(out_dir, "processes.log"),
                 os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)


def _ps_records(arm, out_dir, procs, timeout=300):
    """The trainers' records of `arm`, once both are written (a trainer
    process that exits early fails the phase with the log's tail)."""
    deadline = time.time() + timeout
    paths = [os.path.join(out_dir, f"{arm}_trainer{tid}.json")
             for tid in range(PS_ARMS[arm][1])]
    while not all(os.path.exists(p) for p in paths):
        bad = [p.returncode for role, p in procs
               if role == "trainer" and p.poll() not in (None, 0)]
        if bad or time.time() > deadline:
            with open(os.path.join(out_dir, "processes.log")) as f:
                tail = f.read()[-4000:]
            raise CheckFailed(f"pserver: {arm} trainers exited {bad} or "
                              f"timed out: {tail}")
        time.sleep(0.02)
    recs = []
    for path in paths:
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _ps_stop(eps):
    """STOP the pservers at `eps` over the wire."""
    from paddle_tpu_torch.parallel.pserver import VariableClient

    for ep in eps or ():
        try:
            VariableClient(ep, connect_timeout=5.0).stop_server()
        except Exception:
            pass


def _ps_reap(procs):
    """Wait for the phase's processes (a kill past 30 s)."""
    for _, p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _ps_pulled(arm, eps):
    """The arm's parameters as a VariableClient GETs them from their
    pservers -> {name: host tensor}."""
    from paddle_tpu_torch.parallel.pserver import VariableClient

    t = _ps_transpile(arm, _ps_build(arm), ",".join(eps))
    out = {}
    for ep in eps:
        names = [p.name for p, _ in t._pairs_by_ep[ep]]
        c = VariableClient(ep, connect_timeout=30.0)
        out.update(zip(names, c.get_vars(names)))
        c.close()
    return out


def _ps_serial(arm, init):
    """The arm's untranspiled Program on the serial Executor on the card,
    started from `init` (the trainer's pulled parameters), over the
    trainer's batches -> (losses, {param: final value}, flash launches a
    step, [{param: value} after each step], {param: Adam's second
    moment at the end})."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    model, _, rounds = PS_ARMS[arm]
    if model == "s2s":
        fluid.amp.enable_bf16()
    prev = executor_mod.switch_scope(Scope())
    exe = None
    try:
        main, startup, loss, _, pg = _ps_build(arm)
        scope = executor_mod.global_scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        for n, v in init.items():
            scope.find_var(n).copy_(v)
        batches = _ps_batches(arm)
        reads = _flash_counts()
        losses, flash, snaps = [], [], []
        for _ in range(rounds):
            before = {k: r() for k, r in reads.items()}
            out, = exe.run(main, feed=next(batches), fetch_list=[loss])
            losses.append(float(np.asarray(out).reshape(-1)[0]))
            flash.append({k: r() - before[k] for k, r in reads.items()})
            snaps.append({p.name: scope.find_var(p.name).detach().clone()
                          for p, _ in pg})
        final = snaps[-1]
        moment2 = {p.name: scope.find_var(f"{p.name}_moment2_acc")
                   .detach().clone() for p, _ in pg}
    finally:
        if exe is not None:
            exe.close()
        executor_mod.switch_scope(prev)
        if model == "s2s":
            fluid.amp.disable_bf16()
    return losses, final, flash, snaps, moment2


def _ps_steady(rounds):
    """The rounds past the device segment's eager run (the first) and
    its capture (the second), or the last where there are no more."""
    return rounds[2:] or rounds[-1:]


def _ps_summary(recs):
    """An arm's figures over its trainers' records: ms a round (the
    median over the steady rounds, _ps_steady; the first two apart),
    its device and host parts, bytes and frames a round, peak
    memory."""
    def med(key, r):
        return float(np.median([x[key] for x in _ps_steady(r["rounds"])]))

    keys = ("round_ms", "device_segment_ms", "host_ms", "d2h_ms",
            "wire_ms", "h2d_ms")
    per = [{k: med(k, r) for k in keys} for r in recs]
    out = {k: float(np.mean([p[k] for p in per])) for k in keys}
    out["host_share"] = out["host_ms"] / out["round_ms"]
    out["first_rounds_ms"] = [[x["round_ms"] for x in r["rounds"][:2]]
                              for r in recs]
    last = [r["rounds"][-1] for r in recs]
    out["bytes_sent_per_round"] = [x["bytes_sent"] for x in last]
    out["bytes_recv_per_round"] = [x["bytes_recv"] for x in last]
    out["frames_per_round"] = [x["frames"] for x in last]
    out["peak_memory_bytes"] = [r["peak_memory_bytes"] for r in recs]
    out["startup_s"] = [r["startup_s"] for r in recs]
    out["losses"] = [r["losses"] for r in recs]
    return out


def _ps_round_diffs(got, want, init):
    """Each round's parameters (`got`, [{param: value}]) against the
    serial steps' (`want`), both from `init`: the elements not
    bit-equal, the largest difference, the elements outside the float32
    gate, and the round's update of the whole model off the serial
    step's (||update - serial update|| / ||serial update||, L2)."""
    out = []
    prev_g = prev_w = init
    for g, w in zip(got, want):
        rec = {"not_bit_equal": 0, "max_abs": 0.0, "outside_fp32_tol": 0}
        num = den = 0.0
        for n, b in w.items():
            a, b = g[n].to(b.device).float(), b.float()
            d = (a - b).abs()
            rec["not_bit_equal"] += int((a != b).sum())
            rec["max_abs"] = max(rec["max_abs"], float(d.max()))
            rec["outside_fp32_tol"] += int(
                (d > A9_FP32_ATOL + A9_FP32_RTOL * b.abs()).sum())
            upd = b - prev_w[n].to(b.device).float()
            num += float((a - prev_g[n].to(b.device).float() - upd)
                         .square().sum())
            den += float(upd.square().sum())
        rec["update_err"] = (num / den) ** 0.5 if den else float(num > 0)
        out.append(rec)
        prev_g, prev_w = g, w
    return out


def _ps_outside_grads(final, serial, moment2, steps, beta2=0.999):
    """The elements outside the float32 gate, by the serial run's RMS
    gradient over its steps (Adam's unbiased second moment): how many,
    how many had none, its quantiles; beside Adam's epsilon in the same
    units at each step (epsilon / sqrt(1 - beta2^t): the update is lr *
    m_hat / (sqrt(v_hat) + that))."""
    rms = []
    for n, w in serial.items():
        w = w.float()
        d = (final[n].to(w.device).float() - w).abs()
        bad = d > A9_FP32_ATOL + A9_FP32_RTOL * w.abs()
        if bad.any():
            rms.append((moment2[n].float()[bad] / (1 - beta2 ** steps))
                       .sqrt().cpu())
    rms = torch.cat(rms) if rms else torch.zeros(0)
    q = (0.5, 0.9, 0.99, 1.0)
    return {"count": rms.numel(), "serial_grad_zero": int((rms == 0).sum()),
            "grad_rms_quantiles": dict(zip(map(str, q), (
                np.quantile(rms.numpy(), q).tolist()
                if rms.numel() else []))),
            "adam_eps_in_grad_units": [1e-8 / (1 - beta2 ** t) ** 0.5
                                       for t in range(1, steps + 1)]}


def _ps_adam_host_vs_card(n=1 << 22):
    """The adam op's lowering on the host and on the card from the same
    float32 inputs (gradients of both signs over eight decades; two
    steps, the second from the first's states) -> {output: the
    elements not bit-equal}; and the two inexact ops of its parameter
    step, sqrt and the division, each on the same inputs on the host
    and on the card, against the correctly rounded result (float64,
    then rounded to float32) -> {op: elements that differ, host vs
    card, host vs correct, card vs correct}."""
    from paddle_tpu_torch.ops.optimizer_ops import adam

    gen = torch.Generator().manual_seed(SEED)

    def grad():
        scale = 10.0 ** -torch.randint(3, 11, (n,), generator=gen).float()
        return torch.randn(n, generator=gen) * scale

    def differ(a, b):
        return int((a != b).sum())

    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    state = {"Param": torch.randn(n, generator=gen) * 0.02,
             "Moment1": torch.zeros(n), "Moment2": torch.zeros(n)}
    out = {}
    for step, g in enumerate((grad(), grad()), 1):
        ins = dict(state, Grad=g, LearningRate=torch.tensor([1e-4]),
                   Beta1Pow=torch.tensor([0.9 ** step]),
                   Beta2Pow=torch.tensor([0.999 ** step]))
        host = adam(None, {k: [v] for k, v in ins.items()}, attrs)
        card = adam(None, {k: [v.cuda()] for k, v in ins.items()}, attrs)
        for k, v in host.items():
            out[f"step{step}.{k}"] = differ(v, card[k].cpu())
        root = torch.sqrt(host["Moment2Out"])
        for op, fn, args in (
                ("sqrt", torch.sqrt, (host["Moment2Out"],)),
                ("div", torch.div, (1e-4 * host["Moment1Out"], root + 1e-8))):
            h, c = fn(*args), fn(*(x.cuda() for x in args)).cpu()
            want = fn(*(x.double() for x in args)).float()
            out[f"step{step}.{op}"] = {"host_vs_card": differ(h, c),
                                       "host_vs_correct": differ(h, want),
                                       "card_vs_correct": differ(c, want)}
        state = {"Param": host["ParamOut"], "Moment1": host["Moment1Out"],
                 "Moment2": host["Moment2Out"]}
    return out


def _ps_t1_arm(arm, eps, failed):
    """A one-trainer arm in this process, held against the serial
    Executor from the same parameters; a second serial run from them
    gives the card's own spread between two runs of one step."""
    model, _, rounds = PS_ARMS[arm]
    reads = _flash_counts()
    r = _ps_train(arm, ",".join(eps), 0, snapshots=True)
    flash_total = {k: v() for k, v in reads.items()}
    pulled = _ps_pulled(arm, eps)
    same_as_pull = all(torch.equal(r["final"][n].cpu(), pulled[n])
                       for n in pulled)
    s_losses, s_final, s_flash, s_snaps, s_m2 = _ps_serial(arm, r["init"])
    b_losses, _, _, b_snaps, _ = _ps_serial(arm, r["init"])
    # reported as the a9 phase reports them (_a9_diffs: each
    # parameter's largest difference, the largest serial update, the
    # elements outside the float32 gate)
    diffs = _a9_diffs(r["final"], r["init"], s_final, lambda n, t: t)
    worst = max(diffs, key=lambda n: diffs[n]["max_abs"])
    outside = {n: d["outside_tol"] for n, d in diffs.items()
               if d["outside_tol"]}
    largest = max(d["max_update"] for d in diffs.values())
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"], s_losses)]
    per_round = _ps_round_diffs(r["snapshots"], s_snaps, r["init"])
    rec = {"model": model, "trainers": 1, "rounds": rounds,
           "n_params": r["n_params"], **_ps_summary([r]),
           "per_round": r["rounds"], "serial_losses": s_losses,
           "loss_rel_diff": loss_rel,
           "largest_param_diff": {worst: diffs[worst]},
           "largest_serial_update": largest,
           "param_diff_over_update": diffs[worst]["max_abs"] / max(
               largest, 1e-30),
           "params_outside_fp32_tol": outside,
           "rounds_vs_serial": per_round,
           "serial_vs_serial": {
               "losses": b_losses,
               "rounds": _ps_round_diffs(b_snaps, s_snaps, r["init"])},
           "outside_elements": _ps_outside_grads(r["final"], s_final, s_m2,
                                                 rounds),
           "adam_host_vs_card_not_bit_equal": _ps_adam_host_vs_card(),
           "trainer_params_equal_pservers": same_as_pull}
    del r, s_snaps, b_snaps, s_m2
    if not same_as_pull:
        failed.append(f"pserver: {arm}: the trainer's parameters are not "
                      "the pservers'")
    if not all(np.isfinite(rec["losses"][0])):
        failed.append(f"pserver: {arm} losses {rec['losses']}")
    if model == "s2s":
        rec["gate"] = PS_S2S_GATE
        failed += [f"pserver: {arm} {b}" for b in _ps_s2s_gate(
            per_round, rec["losses"][0], s_losses)]
        got = [x["flash"] for x in rec["per_round"]]
        rec["flash_launches_per_round"] = got
        rec["serial_flash_launches_per_step"] = s_flash
        # the serial step's flash kernels each round: the eager run, then
        # the capture, then a replay (no wrapper call), as the serial
        # steps run
        if got != s_flash or not all(v for x in got[:2]
                                     for v in x.values()):
            failed.append(f"pserver: {arm} flash launches {got} vs the "
                          f"serial steps' {s_flash}")
    else:
        rec["gate"] = (f"losses and every parameter within {TZ_FP32_RTOL} "
                       f"relative and {TZ_FP32_ATOL} absolute")
        if outside or not all(x <= TZ_FP32_RTOL for x in loss_rel):
            failed.append(f"pserver: {arm} parameters outside the "
                          f"tolerance {outside}, loss rel {loss_rel}")
    return rec, flash_total


def _ps_t2_arm(arm, recs, eps, failed):
    """A two-trainer arm's figures from its trainers' records; both
    trainers' parameters equal bit for bit, and equal to what a
    VariableClient GETs from the pservers."""
    pulled = _ps_digest(_ps_pulled(arm, eps))
    digests = [r["digest"] for r in recs]
    rec = {"model": PS_ARMS[arm][0], "trainers": len(recs),
           "rounds": PS_ARMS[arm][2], "n_params": recs[0]["n_params"],
           "clock": [r["clock"] for r in recs],
           **_ps_summary(recs),
           "per_round": [r["rounds"] for r in recs],
           "trainers_params_equal": len(set(digests)) == 1,
           "trainers_equal_pservers": digests[0] == pulled}
    if not (rec["trainers_params_equal"] and rec["trainers_equal_pservers"]):
        failed.append(f"pserver: {arm} parameter digests {digests} vs the "
                      f"pservers' {pulled}")
    if not all(np.isfinite(x) for r in recs for x in r["losses"]):
        failed.append(f"pserver: {arm} losses not finite")
    return rec


def pserver_phase(card):
    """A11's wire on the card: DeepFM over two pservers with one trainer
    (ctr_t1) and two (ctr_t2: its batches through cloud_reader from a
    Master, its pservers found through a Registry), vgg16 over two
    pservers and two trainers (vgg16_cluster), and the seq2seq
    translator over two pservers (seq2seq_t1).  The pservers are host
    subprocesses; the one-trainer arms train here and are held against
    the serial Executor -> the flash launches of seq2seq_t1's rounds.

    Six processes boot at once — two pserver processes serving every
    static arm, ctr_t2's two registry pservers and the two trainer
    processes — and the arms run one by one once all are up."""
    from paddle_tpu_torch.cloud import Master

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_pserver_")
    failed, arms, secs, clock = [], {}, {}, {"start": time.time()}
    procs, master, reg, prep, t2 = [], None, None, None, {}
    static_eps = {arm: [f"127.0.0.1:{_ps_free_port()}"
                        for _ in range(PS_PSERVERS)] for arm in PS_STATIC}
    try:
        with open(os.path.join(out_dir, "endpoints.json"), "w") as f:
            json.dump(static_eps, f)
        open(os.path.join(out_dir, "processes.log"), "w").close()
        procs += _ps_launch("static", out_dir,
                            endpoints=static_eps["ctr_t1"])[0]

        def start_ctr_t2():
            # the chunks, the master (its first use builds the native
            # library) and the registry cluster: ctr_t2's two pservers
            # and the two trainer processes
            try:
                t2["held"], paths = _ps_write_ctr_chunks(out_dir)
                t2["master"] = Master(failure_max=3, timeout_s=300)
                ep = f"127.0.0.1:{t2['master'].serve(0)}"
                t2["master"].set_dataset(t2["held"] + paths,
                                         PS_CTR_CHUNKS_PER_TASK)
                t2["task"] = t2["master"].get_task()
                t2["launched"] = _ps_launch("ctr_t2", out_dir,
                                            trainers=2, registry=True,
                                            extra=[ep])
                clock["spawned_ctr_t2"] = time.time()
            except BaseException as e:   # raised after the join
                t2["error"] = e

        prep = threading.Thread(target=start_ctr_t2)
        prep.start()
        clock["spawned"] = time.time()
        prep.join()
        master = t2.get("master")
        if "launched" in t2:
            t2_procs, reg = t2["launched"]
            procs += t2_procs
        if "error" in t2:
            raise t2["error"]
        held_task = t2["task"]
        check(held_task[1] == t2["held"], f"pserver: ctr_t2 held "
              f"{held_task}")
        _ps_wait_ready(out_dir, [ep for eps in static_eps.values()
                                 for ep in eps], reg)
        clock["ready"] = time.time()

        t0 = time.perf_counter()
        arms["ctr_t1"], _ = _ps_t1_arm("ctr_t1", static_eps["ctr_t1"],
                                       failed)
        _ps_stop(static_eps["ctr_t1"])
        secs["ctr_t1"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        clock["go_ctr_t2"] = _ps_go("ctr_t2", out_dir)
        recs = _ps_records("ctr_t2", out_dir, procs)
        eps = [a for _, a in sorted(reg.list("pserver").items())]
        arms["ctr_t2"] = _ps_t2_arm("ctr_t2", recs, eps, failed)
        before = master.counts()
        master.task_finished(held_task[0])
        counts = master.counts()
        # the trainers' two tasks done while the held one was pending,
        # then all three done, in one pass
        want = {"todo": 0, "pending": 0,
                "done": PS_CTR_CHUNKS // PS_CTR_CHUNKS_PER_TASK + 1,
                "discarded": 0, "pass": 0}
        if before != dict(want, pending=1, done=want["done"] - 1):
            failed.append(f"pserver: ctr_t2 master counts with the held "
                          f"task pending {before}")
        arms["ctr_t2"].update(master_counts=counts, chunks=PS_CTR_CHUNKS,
                              chunks_per_task=PS_CTR_CHUNKS_PER_TASK,
                              registry_endpoints=eps)
        if counts != want:
            failed.append(f"pserver: ctr_t2 master counts {counts}, want "
                          f"{want} (every chunk dispatched and finished "
                          "once)")
        _ps_stop(eps)
        secs["ctr_t2"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        clock["go_vgg16_cluster"] = _ps_go("vgg16_cluster", out_dir)
        recs = _ps_records("vgg16_cluster", out_dir, procs)
        arms["vgg16_cluster"] = v = _ps_t2_arm(
            "vgg16_cluster", recs, static_eps["vgg16_cluster"], failed)
        # run_cluster_vgg16's figure: each trainer's batch x timed
        # rounds over their time, summed over the trainers
        v["aggregate_samples_per_s"] = sum(
            PS_VGG_BATCH * len(_ps_steady(rr)) / (sum(
                x["round_ms"] for x in _ps_steady(rr)) / 1e3)
            for rr in v["per_round"])
        v["batch"] = PS_VGG_BATCH
        _ps_stop(static_eps["vgg16_cluster"])
        secs["vgg16_cluster"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        arms["seq2seq_t1"], flash = _ps_t1_arm(
            "seq2seq_t1", static_eps["seq2seq_t1"], failed)
        _ps_stop(static_eps["seq2seq_t1"])
        secs["seq2seq_t1"] = time.perf_counter() - t0
    finally:
        if prep is not None and prep.is_alive():
            prep.join()     # a raise before its join: reap its processes
            if "launched" in t2:
                procs += t2["launched"][0]
                reg = t2["launched"][1]
        master = master or t2.get("master")
        for arm in PS_STATIC:   # a no-op for the servers stopped already
            if arm not in secs:
                _ps_stop(static_eps[arm])
        if reg is not None and "ctr_t2" not in secs:
            _ps_stop(list(reg.list("pserver").values()))
        _ps_reap(procs)
        if reg is not None:
            reg.close()
        if master is not None:
            master.stop()
        shutil.rmtree(out_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    for arm, s in secs.items():
        arms[arm]["arm_s"] = s
        # the trainer processes' clocks from the phase's start: entry,
        # CUDA up, the arm's go, done
        arms[arm]["clock"] = [{k: v - clock["start"] for k, v in c.items()}
                              for c in arms[arm].get("clock", ())]
    emit({"phase": "pserver", "card": card, "pservers": PS_PSERVERS,
          "clock": {k: v - clock["start"] for k, v in clock.items()},
          "processes": len(procs),
          "placement": "the pservers' optimizer ops on the host "
                       "(Executor(CPUPlace()) in each pserver process), "
                       "the trainers' forward and backward on the card",
          "split_method": "balanced_split", "arms": arms,
          "timing": "host clock; a round: exe.run of the transpiled "
                    "program + synchronize; its device segment until the "
                    "send op starts (a synchronize there), its host part "
                    "the send op: device-to-host copies, the wire round "
                    "(bucketed SEND_BATCH frames, the barrier with the "
                    "pservers' optimize, the GET_BATCH pull) and the "
                    "host-to-device copies into the parameters; medians "
                    "over the rounds after the first two (the first runs "
                    "eagerly, the second captures the segment); bytes "
                    "are serialized payload bytes, frames by verb, of "
                    "the last round",
          "phase_s": time.perf_counter() - t_phase})
    check(not failed, "; ".join(failed))
    return flash


# -- elastic phase (A11's elastic cluster): a pserver killed, one joining --

# s2s_elastic: the seq2seq row's translator (amp, Adam 1e-4) trained
# through Trainer.train(cluster=) by one trainer on the card, against a
# ClusterController in this process and elastic host pservers; pserver
# 1 SIGKILLed at round EL_KILL_ROUND's send (round 2 snapshotted), a
# third pserver joining before round EL_JOIN_ROUND.  Only the lease
# that is meant to expire has the short TTL
EL_ROUNDS, EL_KILL_ROUND, EL_JOIN_ROUND = 6, 3, 5
EL_PSERVERS, EL_KILLED = 3, 1
EL_TTL_KILLED, EL_TTL = 1.0, 5.0
PS_ARMS["s2s_elastic"] = ("s2s", 1, EL_ROUNDS)
_EL_NOTE = ("launches_elastic: the elastic phase's s2s_elastic trainer, "
            "the wrappers' count over its six rounds through "
            "Trainer.train(cluster=) (the device segment's eager run and "
            "its capture; the later rounds replay it)")


def _el_optimize_program(pserver_program):
    """The optimize block of a transpiled pserver program's
    listen_and_serv op, as a Program (the op's own wrapping)."""
    import paddle_tpu_torch as fluid

    op = next(o for o in pserver_program.global_block().ops
              if o.type == "listen_and_serv")
    sub = op.sub_block()
    prog = fluid.Program()
    blk = prog.global_block()
    for v in sub.vars.values():
        if not blk.has_var(v.name):
            blk.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                           persistable=True)
    for o in sub.ops:
        blk.append_op(o.type, dict(o.inputs), dict(o.outputs),
                      dict(o.attrs))
    return prog


def _el_server(build, snapshot_dir):
    """An elastic pserver for the Program `build()` makes: the optimize
    block of every parameter (transpiled onto one endpoint) and its
    startup, run on the host -> the serving VariableServer (snapshot
    every round)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.pserver import VariableServer

    main, startup, _, opt_ops, pg = build()
    ep = "127.0.0.1:1"      # a name only: the server takes its own port
    t = fluid.DistributeTranspiler()
    with fluid.program_guard(main, startup):
        t.transpile(optimize_ops=opt_ops, params_grads=pg, trainers=1,
                    pservers=ep)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(t.get_startup_program(ep), scope=scope)
    srv = VariableServer(_el_optimize_program(t.get_pserver_program(ep)),
                         scope, exe, fan_in=1, sync=True, elastic=True,
                         snapshot_dir=snapshot_dir, snapshot_every=1)
    srv.serve(0)
    return srv


class _ElasticThreads:
    """The elastic pservers as servers in this process (the CPU tests):
    a kill stops the server's sockets and its heartbeats, as a SIGKILL
    does, without deregistering."""

    def __init__(self, build, root):
        self.build, self.root = build, root
        self.servers, self.leases, self.announcements = {}, {}, {}

    def snapshot_dir(self, i):
        return os.path.join(self.root, f"ps{i}")

    def endpoint(self, i):
        if i not in self.servers:
            self.servers[i] = _el_server(self.build, self.snapshot_dir(i))
        return f"127.0.0.1:{self.servers[i].port}"

    def lease(self, i, registry_addr, ttl_s, telemetry=None):
        from paddle_tpu_torch.cloud.registry import Lease, RegistryClient
        from paddle_tpu_torch.observability.collector import announce

        self.leases[i] = Lease(RegistryClient(registry_addr), "pserver",
                               self.endpoint(i), ttl_s=ttl_s)
        if telemetry:
            # a thread's pserver shares the process registry: its own
            # endpoint and lease stand for the process a pserver is
            self.announcements[i] = announce(telemetry, "pserver",
                                             member=f"pserver{i}")

    def kill(self, i):
        self.servers[i].stop()
        self.leases[i]._stop.set()
        ann = self.announcements.pop(i, None)
        if ann is not None:
            ann.lease._stop.set()
            ann.http.close()

    def close(self):
        for i, srv in self.servers.items():
            srv.stop()
            lease = self.leases.get(i)
            if lease is not None and not lease._stop.is_set():
                lease.release()
        for ann in self.announcements.values():
            ann.close()
        self.announcements.clear()


class _ElasticProcs:
    """The elastic pservers as host subprocesses of this script
    (`--elastic-worker`), all started at once; each serves as soon as
    its Program is built and takes its lease when told (a file), so the
    registry's indices follow the phase's order."""

    def __init__(self, root, n):
        self.root = root
        self.started = time.time()
        self.boot_s = {}
        script = os.path.abspath(__file__)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        self.log = open(os.path.join(root, "pservers.log"), "w")
        self.procs = [subprocess.Popen(
            [sys.executable, script, "--elastic-worker", str(i), root],
            stdout=self.log, stderr=subprocess.STDOUT, env=env)
            for i in range(n)]

    def snapshot_dir(self, i):
        return os.path.join(self.root, f"ps{i}")

    def endpoint(self, i, timeout=300):
        path = os.path.join(self.root, f"ready{i}")
        deadline = time.time() + timeout
        while not os.path.exists(path):
            if self.procs[i].poll() is not None or time.time() > deadline:
                self.log.flush()
                with open(os.path.join(self.root, "pservers.log")) as f:
                    tail = f.read()[-3000:]
                raise CheckFailed(f"elastic: pserver {i} not up "
                                  f"(rc {self.procs[i].poll()}): {tail}")
            time.sleep(0.05)
        # seconds from the processes' start to this one serving
        self.boot_s[i] = os.path.getmtime(path) - self.started
        with open(path) as f:
            return f.read().strip()

    def lease(self, i, registry_addr, ttl_s, telemetry=None):
        path = os.path.join(self.root, f"lease{i}")
        with open(path + ".tmp", "w") as f:
            json.dump({"registry": registry_addr, "ttl_s": ttl_s,
                       "telemetry": telemetry}, f)
        os.replace(path + ".tmp", path)

    def kill(self, i):
        import signal

        self.procs[i].send_signal(signal.SIGKILL)
        self.procs[i].wait(timeout=30)

    def close(self):
        """Stop every process (idempotent) and remove their directory."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        self.log.close()
        shutil.rmtree(self.root, ignore_errors=True)


def _el_worker(i, root):
    """An elastic pserver process: the seq2seq translator's optimize
    block on the host, serving, its lease taken when the phase says."""
    from paddle_tpu_torch.cloud.registry import Lease, RegistryClient

    # the boot runs beside an earlier phase: one intra-op thread until
    # the server serves, the machine's after
    from paddle_tpu_torch.observability import flightrecorder

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    srv = _el_server(lambda: _ps_build("s2s_elastic"),
                     os.path.join(root, f"ps{i}"))
    torch.set_num_threads(threads)
    # the optimize and snapshot seconds of each round, read by the
    # phase over FLIGHT
    flightrecorder.install(capture_spans=False)
    path = os.path.join(root, f"ready{i}")
    with open(path + ".tmp", "w") as f:
        f.write(f"127.0.0.1:{srv.port}")
    os.replace(path + ".tmp", path)
    go = os.path.join(root, f"lease{i}")
    while not os.path.exists(go) and not srv._stopping:
        time.sleep(0.02)
    with open(go) as f:
        cfg = json.load(f)
    lease = Lease(RegistryClient(cfg["registry"]), "pserver",
                  f"127.0.0.1:{srv.port}", ttl_s=cfg["ttl_s"])
    if cfg.get("telemetry"):
        # the pserver joins the fleet's telemetry as it joins the
        # cluster: the hook its serve() calls, armed now
        from paddle_tpu_torch.observability.collector import \
            maybe_announce

        os.environ["PADDLE_TPU_TELEMETRY_REGISTRY"] = cfg["telemetry"]
        os.environ["PADDLE_TPU_TELEMETRY_MEMBER"] = f"pserver{i}"
        maybe_announce("pserver")
    while not srv._stopping:
        time.sleep(0.1)
    lease.release()


# the elastic phase's telemetry: the collector's scrape period, and the
# TTL of a member's announcement (collector.announce's default, which
# maybe_announce keeps)
EL_SCRAPE_S, EL_ANNOUNCE_TTL = 0.5, 2.0


class _MemberWatch:
    """A watcher over a TelemetryCollector, noting on one clock when each
    member is first listed and first scraped, when its series leave the
    collector's store and when it is delisted."""

    def __init__(self, coll):
        self.coll = coll
        self.t0 = time.perf_counter()
        self.marks, self.members = {}, {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def _now(self):
        return time.perf_counter() - self.t0

    def mark(self, key):
        self.marks[key] = self._now()

    def wait(self, pred, timeout=30.0):
        """Block until `pred(members)` holds (or `timeout`) -> whether it
        held."""
        deadline = time.perf_counter() + timeout
        while True:
            with self._lock:
                if pred(self.members):
                    return True
            if time.perf_counter() > deadline:
                return False
            time.sleep(0.05)

    def _has_series(self, member):
        store = self.coll.series
        return any(member in store.label_values(n, "member")
                   for n in store.series_names()
                   if n != "paddle_tpu_member_up")

    def _watch(self):
        while not self._stop.wait(0.05):
            t = self._now()
            listed = {m["member"]: m for m in self.coll.members()}
            with self._lock:
                for name, m in listed.items():
                    rec = self.members.setdefault(
                        name, {"kind": m["kind"], "listed_s": t})
                    if m["up"]:
                        rec.setdefault("scraped_s", t)
                for name, rec in self.members.items():
                    if ("scraped_s" in rec and "reclaimed_s" not in rec
                            and not self._has_series(name)):
                        rec["reclaimed_s"] = t
                    if name not in listed:
                        rec.setdefault("delisted_s", t)

    def snapshot(self):
        with self._lock:
            return {"members": {n: dict(r) for n, r in
                                self.members.items()},
                    "marks": dict(self.marks),
                    "scrapes": self.coll.scrapes,
                    "fail_limit": self.coll.fail_limit,
                    "period_s": self.coll.period_s,
                    "scrape_timeout_s": self.coll.scrape_timeout_s}

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


class _ElTelemetry(_MemberWatch):
    """The elastic phase's fleet telemetry: a Registry and a
    TelemetryCollector (a scrape every EL_SCRAPE_S) in this process,
    watched."""

    def __init__(self):
        from paddle_tpu_torch.cloud.registry import Registry
        from paddle_tpu_torch.observability.collector import \
            TelemetryCollector

        self.registry = Registry()
        self.addr = f"127.0.0.1:{self.registry.serve(0)}"
        coll = TelemetryCollector(registry=self.registry,
                                  period_s=EL_SCRAPE_S)
        coll.start()
        super().__init__(coll)

    def close(self):
        """Stop the watcher, delist this process (the trainer) and close
        the collector and the registry."""
        from paddle_tpu_torch.observability import collector

        self.stop()
        if collector._ENV_ANNOUNCEMENT is not None:
            collector._ENV_ANNOUNCEMENT.close()
        os.environ.pop("PADDLE_TPU_TELEMETRY_REGISTRY", None)
        self.coll.close()
        self.registry.close()


def _el_telemetry_verdict(tel):
    """The elastic phase's telemetry facts -> (failures, record): the
    trainer and every pserver listed and scraped; pserver EL_KILLED's
    series reclaimed within max(fail_limit x period, the announcement's
    TTL), plus one period and a scrape's timeout, of its SIGKILL; the
    joiner listed only after its lease; the others still listed."""
    failed, members, marks = [], tel["members"], tel["marks"]
    trainers = sorted(n for n, r in members.items()
                      if r["kind"] == "trainer")
    if len(trainers) != 1:
        failed.append(f"telemetry: trainers listed {trainers}")
    for i in range(EL_PSERVERS):
        r = members.get(f"pserver{i}")
        if r is None or r["kind"] != "pserver" or "scraped_s" not in r:
            failed.append(f"telemetry: pserver{i} never scraped ({r})")
    bound = (max(tel["fail_limit"] * tel["period_s"], EL_ANNOUNCE_TTL)
             + tel["period_s"] + tel["scrape_timeout_s"])
    killed = members.get(f"pserver{EL_KILLED}", {})
    out = {"bound_s": bound}
    if "kill" in marks and "reclaimed_s" in killed:
        out["kill_to_reclaimed_s"] = killed["reclaimed_s"] - marks["kill"]
        if out["kill_to_reclaimed_s"] > bound:
            failed.append(f"telemetry: pserver{EL_KILLED}'s series "
                          f"reclaimed {out['kill_to_reclaimed_s']:.2f} s "
                          f"after its SIGKILL (> {bound} s)")
    else:
        failed.append(f"telemetry: pserver{EL_KILLED}'s series never "
                      f"reclaimed ({killed}, marks {marks})")
    if "delisted_s" in killed and "kill" in marks:
        out["kill_to_delisted_s"] = killed["delisted_s"] - marks["kill"]
    else:
        failed.append(f"telemetry: pserver{EL_KILLED} never delisted")
    joiner = members.get("pserver2", {})
    if "join" not in marks or joiner.get("listed_s", -1) < marks["join"]:
        failed.append(f"telemetry: the joiner listed at "
                      f"{joiner.get('listed_s')} s, its lease at "
                      f"{marks.get('join')} s")
    else:
        out["join_to_listed_s"] = joiner["listed_s"] - marks["join"]
    for name in trainers + ["pserver0", "pserver2"]:
        if "delisted_s" in members.get(name, {}):
            failed.append(f"telemetry: {name} delisted while serving")
    return failed, out


class _FeedAsIs:
    """A Trainer feeder for batches that are feeds already."""

    @staticmethod
    def feed(batch):
        return batch


def _el_run(build, feeds, place, pservers, amp=False,
            kill_round=EL_KILL_ROUND, join_round=EL_JOIN_ROUND,
            on_card=True, telemetry=None):
    """One trainer over an elastic cluster: a ClusterController here,
    `pservers` (_ElasticProcs or _ElasticThreads) leased in index
    order, two at first; the trainer built by `build` (-> main,
    startup, loss, optimize ops, params and grads), transpiled, and
    trained through Trainer.train(cluster=) over `feeds` (one a round).
    Pserver EL_KILLED is killed at round `kill_round`'s send, once its
    snapshot of the round before is written; pserver 2 joins before
    round `join_round`.  With `telemetry` (an _ElTelemetry), each
    pserver announces to its collector at its lease and this process
    as the trainer at Trainer.train; the kill and the join are marked
    on its clock.  -> the run's record: losses, the parameters after
    startup and after each round, each round's ms (device, D2H, wire,
    H2D), the views, the kill and join figures, the final GET and
    placement."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.cloud.cluster import ClusterController
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.ops import distributed as dist_ops
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.io import latest_checkpoint
    from paddle_tpu_torch.parallel.distributed_spliter import placement_map
    from paddle_tpu_torch.parallel.pserver import VariableClient
    from paddle_tpu_torch.trainer import (BeginIteration, EndIteration,
                                          Trainer)

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_start = time.perf_counter()
    rec = {"rounds": [], "losses": [], "views": [], "snapshots": [],
           "clock": {}}

    def mark(key):
        rec["clock"][key] = time.perf_counter() - t_start
    ctl = ClusterController(
        min_pservers=2, poll_s=0.05, push_timeout_s=5.0,
        snapshot_dirs={i: pservers.snapshot_dir(i)
                       for i in range(EL_PSERVERS)})
    prev_scope = executor_mod.switch_scope(Scope())
    orig_round, orig_into = comm.elastic_round, dist_ops._into_scope
    trainer = None
    try:
        ctl.serve(0)
        ctl.start()
        eps = [pservers.endpoint(i) for i in range(2)]
        pservers.endpoint(2)    # booted now, leased at the join
        mark("pservers_serving")
        tel_addr = telemetry.addr if telemetry is not None else None
        for i in range(2):
            pservers.lease(i, ctl.registry_addr,
                           EL_TTL_KILLED if i == EL_KILLED else EL_TTL,
                           telemetry=tel_addr)
            deadline = time.time() + 60
            while len(ctl._reg.list("pserver")) < i + 1:
                check(time.time() < deadline,
                      f"elastic: pserver {i} never registered")
                time.sleep(0.02)
        mark("leased")
        if amp:
            fluid.amp.enable_bf16()
        main, startup, loss, opt_ops, pg = build()
        names = sorted(p.name for p, _ in pg)
        t = fluid.DistributeTranspiler()
        with fluid.program_guard(main, startup):
            t.transpile(optimize_ops=opt_ops, params_grads=pg, trainers=1,
                        pservers=",".join(eps))
        mark("built")
        scope = executor_mod.global_scope()
        secs = {"host": {}, "wire": {}, "h2d": {}}
        state = {"round": None, "t0": 0.0}

        def params():
            return {n: scope.find_var(n).detach().clone() for n in names}

        def timed(key, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sync()
                if state["round"] is not None:
                    secs[key][state["round"]] = secs[key].get(
                        state["round"], 0.0) + time.perf_counter() - t0
                return out
            return run

        def wire(sends, gets, *a, **kw):
            r = state["round"]
            if r == kill_round and sends and "killed_at" not in rec:
                rec["view_before_kill"] = ctl.view().epoch
                pservers.kill(EL_KILLED)
                rec["killed_at"] = time.perf_counter()
                if telemetry is not None:
                    telemetry.mark("kill")
            return orig_round(sends, gets, *a, **kw)

        def host_part(lower):
            def run(ctx, ins, attrs):
                sync()      # the device segment ends here
                return timed("host", lower)(ctx, ins, attrs)
            return run

        def handler(event):
            if isinstance(event, BeginIteration):
                r = event.batch_id + 1
                if r == 1:
                    if telemetry is not None:
                        # the trainer announced at train(): every member
                        # scraped once before the rounds start
                        telemetry.wait(lambda m: all(
                            "scraped_s" in m.get(f"pserver{i}", {})
                            for i in range(2)) and any(
                            x["kind"] == "trainer" and "scraped_s" in x
                            for x in m.values()))
                    mark("startup_done")
                    rec["init"] = params()
                    rec["views"].append(ctl.view().epoch)
                if r == kill_round:
                    # the round before's optimize and snapshot are done
                    # (its barrier answered after the write): the newest
                    # valid snapshot of the pserver to be killed
                    _, meta = latest_checkpoint(
                        pservers.snapshot_dir(EL_KILLED))
                    rec["killed_after_snapshot_round"] = (
                        meta or {}).get("trainer_args", {}).get("round")
                if r == join_round:
                    before = ctl.view().epoch
                    t0 = time.perf_counter()
                    joiner = pservers.endpoint(2)
                    if telemetry is not None:
                        telemetry.mark("join")
                    pservers.lease(2, ctl.registry_addr, EL_TTL,
                                   telemetry=tel_addr)
                    if telemetry is not None:
                        telemetry.wait(lambda m: "scraped_s" in m.get(
                            "pserver2", {}))
                    v = ctl.wait_view(before + 1, timeout_s=120)
                    while v is not None and joiner not in v.endpoints:
                        v = ctl.wait_view(v.epoch + 1, timeout_s=120)
                    check(v is not None, "elastic: the join never "
                                         "committed")
                    tr = ctl.transitions[-1]
                    rec["join"] = {"view": v.epoch,
                                   "seconds_to_view":
                                       time.perf_counter() - t0,
                                   "rebalance_s": tr["seconds"],
                                   "fenced_s": tr.get("fenced_s"),
                                   "migrated_bytes": tr["bytes"],
                                   "migrated_params": tr["vars"],
                                   "migrated_state_vars":
                                       tr["state_vars"]}
                sync()
                state["round"], state["t0"] = r, time.perf_counter()
            elif isinstance(event, EndIteration):
                sync()
                r = state["round"]
                ms = (time.perf_counter() - state["t0"]) * 1e3
                host = secs["host"].get(r, 0.0) * 1e3
                w = secs["wire"].get(r, 0.0) * 1e3
                h2d = secs["h2d"].get(r, 0.0) * 1e3
                rec["rounds"].append({
                    "round": r, "round_ms": ms,
                    "device_segment_ms": ms - host, "d2h_ms": host - w - h2d,
                    "wire_ms": w, "h2d_ms": h2d,
                    "view": ctl.view().epoch})
                rec["losses"].append(float(event.cost))
                rec["snapshots"].append(params())
                rec["views"].append(ctl.view().epoch)
                state["round"] = None

        trainer = Trainer(loss, place=place,
                          main_program=t.get_trainer_program(),
                          startup_program=startup)
        comm.elastic_round = timed("wire", wire)
        dist_ops._into_scope = timed("h2d", orig_into)
        reads = _flash_counts()
        if telemetry is not None:
            # Trainer.train announces this process as the trainer
            os.environ["PADDLE_TPU_TELEMETRY_REGISTRY"] = telemetry.addr
        with _wrapped_lowering("send", host_part):
            trainer.train(1, lambda: iter(feeds), event_handler=handler,
                          feeder=_FeedAsIs(), cluster=ctl.addr)
        mark("rounds_done")
        if telemetry is not None:
            telemetry.wait(lambda m: {"reclaimed_s", "delisted_s"} <= set(
                m.get(f"pserver{EL_KILLED}", {})))
        rec["flash"] = {k: r() for k, r in reads.items()}
        if "killed_at" in rec:
            after = [x for x in ctl.transitions
                     if x["epoch"] > rec["view_before_kill"]]
            if after:
                rec["kill"] = {
                    "view": after[0]["epoch"],
                    "kill_to_view_s": after[0]["at"] - rec["killed_at"],
                    "rebalance_s": after[0]["seconds"],
                    "restored_params": after[0]["restored"],
                    "restored_state_vars": after[0]["state_vars"],
                    "restored_bytes": after[0]["bytes"],
                    "restored_round": after[0].get("restored_round"),
                    "replayed_round_ms":
                        rec["rounds"][kill_round - 1]["round_ms"]}
        view = ctl.view()
        rec["final_view"] = {"epoch": view.epoch, "status": view.status,
                             "endpoints": view.endpoints}
        final = {n: v.cpu() for n, v in rec["snapshots"][-1].items()}
        got, held = {}, {}
        rec["pserver_rounds"] = {}
        for ep in view.endpoints:
            c = VariableClient(ep, client_id="elastic-check",
                               connect_timeout=10.0)
            try:
                mine = sorted(n for n in names
                              if view.placement.get(n) == ep)
                got.update(zip(mine, c.get_vars(mine)))
                held[ep] = c.have_vars(names)
                # the pserver's optimize and snapshot seconds a round
                # (its flight recorder, where armed)
                rec["pserver_rounds"][ep] = [
                    {"event": e["kind"], **e["data"]}
                    for e in c.get_flight_record().get("events", ())
                    if e["kind"] in ("pserver.optimize",
                                     "pserver.snapshot")]
            finally:
                c.close()
        rec["final_get_equal"] = sorted(
            n for n in names if n in got and torch.equal(
                got[n].to(final[n].dtype), final[n]))
        rec["params"] = names
        descs = ctl._vars
        rec["placement_is_balanced_split"] = (
            view.placement == placement_map(descs, view.endpoints))
        rec["each_param_once"] = all(
            sum(n in held[ep] for ep in held) == 1
            and n in held[view.placement[n]] for n in names)
        rec["placement_counts"] = {ep: sum(
            1 for n in names if view.placement[n] == ep)
            for ep in view.endpoints}
        rec["transitions"] = list(ctl.transitions)
        rec["clock"]["first_view"] = ctl.transitions[0]["at"] - t_start
        if telemetry is not None:
            rec["telemetry"] = telemetry.snapshot()
        mark("checked")
    finally:
        comm.elastic_round, dist_ops._into_scope = orig_round, orig_into
        if trainer is not None:
            trainer.exe.close()
        executor_mod.switch_scope(prev_scope)
        if amp:
            fluid.amp.disable_bf16()
        comm.reset_comm_pool()
        ctl.close()
        pservers.close()
    return rec


def _el_verdict(rec, serial_snaps, serial_losses):
    """The s2s_elastic gate: seq2seq_t1's against the serial Executor
    from the same parameters (_ps_s2s_gate: every round's parameters
    and loss bit-equal), then the run's own facts: the kill after the
    snapshot of the round before it, restored from that snapshot; the
    join migrated; the final GET bit-equal to the trainer's copy; the
    final placement balanced_split over the live endpoints, each
    parameter on exactly one -> (the failures, the per-round diffs).  A
    dropped, repeated or stale round, or a shard skipped in a
    migration, leaves the serial steps."""
    per_round = _ps_round_diffs(rec["snapshots"], serial_snaps, rec["init"])
    failed = _ps_s2s_gate(per_round, rec["losses"], serial_losses)
    kill = rec.get("kill")
    if kill is None:
        failed.append("no stable view after the kill")
    else:
        if rec.get("killed_after_snapshot_round") != EL_KILL_ROUND - 1:
            failed.append(f"killed after snapshot round "
                          f"{rec.get('killed_after_snapshot_round')}")
        if kill["restored_round"] != EL_KILL_ROUND - 1 or \
                not kill["restored_params"]:
            failed.append(f"kill restore {kill}")
    join = rec.get("join")
    if join is None or not join["migrated_bytes"]:
        failed.append(f"join {join}")
    if rec["final_get_equal"] != rec["params"]:
        off = sorted(set(rec["params"]) - set(rec["final_get_equal"]))
        failed.append(f"final GET differs from the trainer's copy in "
                      f"{len(off)} parameters: {off[:5]}")
    fv = rec["final_view"]
    # live at the end: pserver 0 and the joiner (pserver 1 was killed)
    if fv["status"] != "stable" or len(fv["endpoints"]) != EL_PSERVERS - 1:
        failed.append(f"final view {fv}")
    if not rec["placement_is_balanced_split"] or not rec["each_param_once"]:
        failed.append(f"final placement {rec['placement_counts']}")
    return failed, per_round


def elastic_phase(card, procs=None):
    """A11's elastic cluster on the card (s2s_elastic): the seq2seq
    translator at full width under amp, one trainer here through
    Trainer.train(cluster=), a ClusterController here, three elastic
    host pservers as subprocesses (two leased at first); pserver 1
    SIGKILLed at round 3's send once its round-2 snapshot is written
    (round 3 replays against the next view, its shards restored from
    that snapshot), pserver 2 joining before round 5 (a rebalance,
    PUT_BATCH migration).  Held to seq2seq_t1's gate against the serial
    Executor from the same parameters (_el_verdict) -> the flash
    wrappers' launches over the trainer's rounds."""
    from paddle_tpu_torch import CUDAPlace

    t_phase = time.perf_counter()
    if procs is None:
        procs = _ElasticProcs(
            tempfile.mkdtemp(prefix="chip_smoke_elastic_"), EL_PSERVERS)
    failed = []
    telemetry = _ElTelemetry()
    try:
        t0 = time.perf_counter()
        try:
            rec = _el_run(lambda: _ps_build("s2s_elastic"),
                          [_s2s_feed()] * EL_ROUNDS, CUDAPlace(0), procs,
                          amp=True, telemetry=telemetry)
        finally:
            telemetry.close()
        run_s = time.perf_counter() - t0
        bad, tel_out = _el_telemetry_verdict(rec["telemetry"])
        failed += [f"elastic: {b}" for b in bad]
        t0 = time.perf_counter()
        s_losses, _, s_flash, s_snaps, _ = _ps_serial("s2s_elastic",
                                                      rec["init"])
        serial_s = time.perf_counter() - t0
        bad, per_round = _el_verdict(rec, s_snaps, s_losses)
        failed += [f"elastic: {b}" for b in bad]
        serial_flash = {k: sum(x[k] for x in s_flash) for k in rec["flash"]}
        if rec["flash"] != serial_flash or not all(rec["flash"].values()):
            failed.append(f"elastic: flash launches {rec['flash']} vs the "
                          f"serial steps' {serial_flash}")
        n_params = sum(v.numel() for v in rec["init"].values())
        out = {k: rec[k] for k in (
            "losses", "rounds", "views", "kill", "join", "final_view",
            "placement_counts", "placement_is_balanced_split",
            "each_param_once", "killed_after_snapshot_round", "flash",
            "clock", "pserver_rounds")
            if k in rec}
        out["transitions"] = [
            {k: v for k, v in x.items() if k != "at"}
            for x in rec["transitions"]]
        out["final_get_bit_equal"] = (
            f"{len(rec['final_get_equal'])} of {len(rec['params'])}")
        out["telemetry"] = {**rec["telemetry"], **tel_out}
        out["pserver_boot_s"] = procs.boot_s
        del rec, s_snaps
    finally:
        procs.close()
        torch.cuda.empty_cache()
    emit({"phase": "elastic", "card": card, "arm": "s2s_elastic",
          "n_params": n_params, "pservers": EL_PSERVERS,
          "kill_round": EL_KILL_ROUND, "join_round": EL_JOIN_ROUND,
          **out, "serial_losses": s_losses,
          "serial_flash_launches_per_step": s_flash,
          "rounds_vs_serial": per_round,
          "gate": (PS_S2S_GATE + "; the final GET bit-equal to the "
                   "trainer's copy; the final placement balanced_split "
                   "over the live endpoints, each parameter on one"),
          "timing": "host clock; a round: BeginIteration to EndIteration "
                    "of Trainer.train, synchronized; its device segment "
                    "until the send op starts, then the send op: "
                    "device-to-host copies, the wire (elastic_round, the "
                    "replay included) and the host-to-device copies",
          "run_s": run_s, "serial_s": serial_s,
          "phase_s": time.perf_counter() - t_phase})
    check(not failed, "; ".join(failed))
    return out["flash"]


# -- fleet phase (A11's serving fleet): router, autoscaler, replicas --------

# the replicas: the serve phase's LM, weights and request shapes.  The
# autoscaler's band and clocks; its backlog thresholds in seconds of one
# replica's work (reserved tokens over its closed-loop tokens/s), and its
# windowed router p99 (hot above 2 s, cold at or below 1.5 s: the tail's
# requests take about 1 s alone).  The ramp's phases as multiples of one
# replica's rate: the low phase runs FLEET_LOW_S; the peak at least
# FLEET_PEAK_S and on until FLEET_AFTER_KILL_S after the SIGKILL.  A
# replica takes 15-20 s from spawn to serving on the card, so the peak
# lasts until the scale-out replica serves: its backlog (about half a
# second of one replica's work for each second before then, some 100
# requests) stays well below a replica's 256-request admission queue.
# Once two replicas have served for FLEET_KILL_AFTER_S, the busiest
# owned replica is SIGKILLed, with more than one stream on it; the tail
# runs until the fleet is back to one replica by a scale-in, at most
# FLEET_TAIL_MAX_S
FLEET_MIN, FLEET_MAX = 1, 3
FLEET_POLICY = {"p99_high_s": 2.0, "p99_low_s": 1.5, "sustain_s": 0.6,
                "idle_sustain_s": 3.0, "cooldown_s": 3.0}
FLEET_BACKLOG_HIGH_S, FLEET_BACKLOG_LOW_S = 0.6, 0.15
FLEET_POLL_S, FLEET_WINDOW_S, FLEET_SCRAPE_S = 0.2, 20.0, 0.5
FLEET_RAMP = (0.3, 1.5, 0.1)
FLEET_LOW_S, FLEET_PEAK_S, FLEET_PEAK_MAX_S = 6.0, 20.0, 60.0
FLEET_KILL_AFTER_S, FLEET_AFTER_KILL_S = 4.0, 2.0
FLEET_TAIL_MAX_S = 120.0
FLEET_TTL_S = 2.0           # each replica's registry and telemetry lease
FLEET_CUT_GAP_S = 0.1       # a started stream's gap at the kill: cut
FLEET_PROMPT, FLEET_NEW = (16, 64), (32, 128)
FLEET_BURST = 32            # closed-loop requests, SLOTS in flight
FLEET_TAIL_S = 0.5          # the tail sampler's threshold (seconds)


def _runs(values):
    """[[value, times in a row], ...] of a sequence."""
    out = []
    for v in values:
        if out and out[-1][0] == v:
            out[-1][1] += 1
        else:
            out.append([v, 1])
    return out


def _fleet_requests(n, seed):
    r = np.random.RandomState(seed)
    return [(r.randint(0, V, int(r.randint(FLEET_PROMPT[0],
                                           FLEET_PROMPT[1] + 1))).tolist(),
             int(r.randint(FLEET_NEW[0], FLEET_NEW[1] + 1)))
            for _ in range(n)]


class _FleetLauncher:
    """SubprocessReplicaLauncher that names each replica's telemetry
    member (`<prefix><n>`, n counting its spawns), notes its spawn time
    (for its time to first token) and logs its stderr to a file."""

    def __init__(self, model_dir, registry_addr, env, log, use_gpu,
                 extra=(), prefix="replica"):
        from paddle_tpu_torch.cloud.autoscaler import \
            SubprocessReplicaLauncher

        self.inner = SubprocessReplicaLauncher(
            model_dir, registry_addr, use_gpu=use_gpu, ttl_s=FLEET_TTL_S,
            drain_grace_s=30.0, extra_args=list(extra), env=env,
            stderr=log)
        self.env, self.prefix = env, prefix
        self.spawned = []       # [(handle, perf_counter at spawn)]
        self.members = {}       # handle pid -> its telemetry member
        self._lock = threading.Lock()

    def spawn(self):
        with self._lock:
            member = f"{self.prefix}{len(self.spawned)}"
            self.inner.env = dict(self.env,
                                  PADDLE_TPU_TELEMETRY_MEMBER=member)
            h = self.inner.spawn()
            self.spawned.append((h, time.perf_counter()))
            self.members[h.pid] = member
        return h


def _first_token_s(addr, t_spawn, prompt, max_new):
    """One request straight to the replica at `addr` -> (seconds from
    `t_spawn` to its first token, the tokens)."""
    from paddle_tpu_torch.serving.replica import replica_stream

    first, toks = None, []
    for tok in replica_stream(addr, {"op": "generate", "prompt": prompt,
                                     "max_new": max_new,
                                     "temperature": 0.0, "seed": 0}):
        if first is None:
            first = time.perf_counter() - t_spawn
        toks.append(tok)
    return first, toks


class _ColdReplica(threading.Thread):
    """Spawns one replica and, once its banner names its address, sends
    it one request (`record`: its seconds from spawn to first token and
    its stats), then ends it gracefully."""

    def __init__(self, launcher, prompt):
        super().__init__(daemon=True)
        self.launcher, self.prompt, self.record = launcher, prompt, {}
        self.handle = launcher.spawn()
        self.start()

    def run(self):
        try:
            addr = _banner_addr(self.handle)
            self.record["first_token_s"], _ = _first_token_s(
                addr, self.launcher.spawned[0][1], self.prompt, 8)
            self.record["stats"] = _replica_stats(addr)
        except Exception as e:  # noqa: BLE001 (reported by the phase)
            self.record["error"] = repr(e)
        finally:
            self.handle.terminate()

    def close(self):
        self.join(timeout=60)
        if self.handle.alive():
            self.handle.kill()
        self.handle.wait(timeout=60)


def _banner_addr(handle, timeout=300.0):
    deadline = time.time() + timeout
    while handle.addr is None:
        check(handle.alive() and time.time() < deadline,
              f"fleet: replica pid {handle.pid} printed no banner")
        time.sleep(0.05)
    return handle.addr


class _Streams:
    """Router streams, each drained by a thread of its own that notes
    every token's arrival (perf_counter)."""

    def __init__(self):
        self.items = []         # [(request index, stream, [(t, tok)])]
        self._lock = threading.Lock()
        self._threads = []

    def submit(self, router, idx, req):
        stream = router.submit(req[0], req[1], temperature=0.0, seed=0)
        got = []

        def drain():
            try:
                for tok in stream:
                    got.append((time.perf_counter(), tok))
            except Exception:
                pass    # the stream's result() raises it below
        t = threading.Thread(target=drain, daemon=True)
        t.start()
        with self._lock:
            self.items.append((idx, stream, got))
            self._threads.append(t)

    def in_flight(self):
        with self._lock:
            return [(i, s, g) for i, s, g in self.items if not s.done]

    def join(self, timeout=600.0):
        deadline = time.time() + timeout
        for t in list(self._threads):
            t.join(max(0.0, deadline - time.time()))


def _open_loop(router, streams, reqs, start, rate, seconds, until=None):
    """Submit requests reqs[start:] at `rate` a second, evenly spaced,
    for `seconds` and on until `until(now)` (asked every 50 ms) holds ->
    the next request index."""
    t0 = time.perf_counter()
    i, asked, done = start, -1.0, until is None
    while True:
        now = time.perf_counter() - t0
        if until is not None and now - asked >= 0.05:
            asked, done = now, until(now)
        if now >= seconds and done:
            return i
        due = start + int(now * rate) + 1
        while i < min(due, len(reqs)):
            streams.submit(router, i, reqs[i])
            i += 1
        check(i < len(reqs), "fleet: the request pool ran out")
        time.sleep(0.005)


def _closed_loop(router, reqs, idxs, n):
    """reqs[i] for i in `idxs` through the router, `n` in flight (each
    finished request replaced at once) -> (the seconds it took, {i:
    tokens})."""
    todo, lock, out = list(idxs), threading.Lock(), {}

    def worker():
        while True:
            with lock:
                if not todo:
                    return
                i = todo.pop()
            out[i] = router.submit(reqs[i][0], reqs[i][1], temperature=0.0,
                                   seed=0).result(timeout=600)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return time.perf_counter() - t0, out


def _decode_all(srv, items):
    """{key: (prompt, max_new)} through an in-process GenerationServer,
    greedy, its admission queue kept below its bound -> {key: tokens}."""
    from paddle_tpu_torch.serving import ServerSaturated

    pending, out = list(items.items()), {}
    streams = {}
    while pending or streams:
        while pending:
            key, (prompt, max_new) = pending[0]
            try:
                streams[key] = srv.submit(prompt, max_new)
            except ServerSaturated:
                break
            pending.pop(0)
        for key in [k for k, s in streams.items() if s.done]:
            out[key] = streams.pop(key).result(timeout=60)
        time.sleep(0.01)
    return out


def _replica_stats(addr):
    from paddle_tpu_torch.serving.replica import replica_call

    return replica_call(addr, {"op": "stats"}, timeout_s=10)["stats"]


class _StatsWatch:
    """Polls every live replica's stats once a second: each address's
    first reading (its warmup accounting) and its last."""

    def __init__(self, router):
        self.router, self.first, self.last = router, {}, {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(1.0):
            self.poll()

    def poll(self):
        for addr in self.router.live_replicas(refresh=False):
            try:
                st = _replica_stats(addr)
            except (OSError, ValueError, KeyError):
                continue    # dying or killed: its last reading stands
            self.first.setdefault(addr, st)
            self.last[addr] = st

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)


def _capture(fn, argv):
    """A CLI subcommand in this process -> (its exit code, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


def _fleet_tools(router_addr, dump, peak_dump, trace_dir, out_dir, root):
    """The telemetry tools against the fleet: the federation dump's
    member/kind labels, `cli top`, `cli slo --check` (on `dump` and on
    `peak_dump`, the fleet's at the peak), `cli why`, `cli trace-of`
    -> (failures, record)."""
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.observability.collector import \
        parse_prometheus_text

    failed, rec = [], {}
    with open(dump) as f:
        text = f.read()
    fams = parse_prometheus_text(text)
    kinds = {}
    for fam in fams.values():
        for smp in fam["samples"]:
            lbl = smp["labels"]
            if "member" in lbl and "kind" in lbl:
                kinds.setdefault(lbl["kind"], set()).add(lbl["member"])
    rec["dump"] = {"bytes": len(text), "families": len(fams),
                   "members_by_kind": {k: sorted(v)
                                       for k, v in kinds.items()}}
    for kind, fam in (("generation",
                       "paddle_tpu_serving_generation_requests_total"),
                      ("router", "paddle_tpu_serving_router_requests_total")):
        if not any(s["labels"].get("kind") == kind
                   for s in fams.get(fam, {}).get("samples", ())):
            failed.append(f"fleet: the dump has no {fam} series of kind "
                          f"{kind}")
    rc, top = _capture(cli.cmd_top, ["--registry", router_addr,
                                     "--samples", "2", "--period", "0.5"])
    rec["top"] = top
    if rc != 0 or "generation" not in top or "router" not in top:
        failed.append(f"fleet: cli top (rc {rc}) rendered {top!r}")
    # the SLOs' verdicts stand as they fall, on the dump taken at the
    # peak (just before the SIGKILL) and on the closing one; the tool
    # must evaluate the serving lines and exit as its table says
    for key, path in (("slo_peak", peak_dump), ("slo", dump)):
        rc, slo = _capture(cli.cmd_slo, [
            "--check", "--spec", os.path.join(root, "tools", "slo.json"),
            "--prom", path])
        rows = [ln.rstrip() for ln in slo.splitlines()[1:]]
        alerting = [ln.rsplit(None, 3)[0] for ln in rows
                    if ln.endswith(" ALERT")]
        serving = [ln for ln in rows if ln.startswith(
            ("serving p99", "serving.first_token p99"))]
        rec[key] = {"rc": rc, "met": rc == 0, "alerting": alerting,
                    "table": slo}
        if (rc != (1 if alerting else 0) or len(serving) != 2
                or any(ln.endswith("no-data") for ln in serving)):
            failed.append(f"fleet: cli slo --check (rc {rc}) on "
                          f"{os.path.basename(path)}:\n{slo}")
    rc, why = _capture(cli.cmd_why, ["--kind", "generation", "--prom",
                                     dump])
    rec["why"] = why
    rows = [ln.split() for ln in why.splitlines()[1:] if ln.strip()]
    if rc != 0 or not any("decode" in r for r in rows):
        failed.append(f"fleet: cli why named no decode phase: {why!r}")
    rc, tof = _capture(cli.cmd_trace_of, [
        "--metric", "router", "--prom", dump, "--trace-dir", trace_dir,
        "--out", out_dir])
    rec["trace_of"] = tof
    joined = [ln.split(None, 1)[1] for ln in tof.splitlines()
              if ln.startswith("trace ")]
    if rc != 0 or not joined:
        failed.append(f"fleet: cli trace-of joined no trace: {tof!r}")
    else:
        with open(joined[0]) as f:
            events = json.load(f)["traceEvents"]
        pids = {e["pid"] for e in events}
        names = sorted({e["name"] for e in events})
        rec["trace"] = {"events": len(events), "pids": len(pids),
                        "names": names}
        if len(pids) < 2 or "router.request" not in names:
            failed.append(f"fleet: the joined trace spans {len(pids)} "
                          f"process(es): {names}")
    return failed, rec


def _fleet_members_verdict(snap, launcher, owned, killed_pid):
    """The fleet's members in the collector -> (failures, record): the
    router and every replica the autoscaler spawned listed and scraped;
    the SIGKILLed replica's series reclaimed within max(fail_limit x
    period, the lease's TTL), plus one period and a scrape's timeout, of
    the kill; a retired replica delisted; the ones the autoscaler still
    owns (pids `owned`) still listed."""
    failed, rec = [], {}
    members, marks = snap["members"], snap["marks"]
    bound = (max(snap["fail_limit"] * snap["period_s"], FLEET_TTL_S)
             + snap["period_s"] + snap["scrape_timeout_s"])
    router = members.get("router", {})
    if router.get("kind") != "router" or "scraped_s" not in router \
            or "delisted_s" in router:
        failed.append(f"fleet telemetry: the router member {router}")
    for h, _ in launcher.spawned:
        name = launcher.members[h.pid]
        r = members.get(name)
        rec[name] = dict(r or {}, pid=h.pid, owned=h.pid in owned)
        if r is None or r["kind"] != "generation" or "scraped_s" not in r:
            failed.append(f"fleet telemetry: {name} never scraped ({r})")
            continue
        if h.pid in owned:
            if "delisted_s" in r:
                failed.append(f"fleet telemetry: {name} delisted while "
                              f"serving")
        elif h.pid == killed_pid:
            if "reclaimed_s" not in r or "delisted_s" not in r:
                failed.append(f"fleet telemetry: the killed {name} not "
                              f"reclaimed and delisted ({r})")
                continue
            rec[name].update(
                kill_to_reclaimed_s=r["reclaimed_s"] - marks["kill"],
                kill_to_delisted_s=r["delisted_s"] - marks["kill"],
                bound_s=bound)
            if rec[name]["kill_to_reclaimed_s"] > bound:
                failed.append(f"fleet telemetry: the killed {name}'s "
                              f"series reclaimed "
                              f"{rec[name]['kill_to_reclaimed_s']:.2f} s "
                              f"after its SIGKILL (> {bound} s)")
        elif "delisted_s" not in r:
            failed.append(f"fleet telemetry: the retired {name} still "
                          f"listed ({r})")
    return failed, rec


def fleet_phase(card, place):
    """A11's serving fleet on the card (see the module docstring) -> the
    record of the phase line."""
    from paddle_tpu_torch.cloud.autoscaler import (Autoscaler,
                                                   AutoscalerPolicy)
    from paddle_tpu_torch.cloud.router import ReplicaRouter
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.executor import resolve_place
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models.transformer import build_lm_paged_decoder
    from paddle_tpu_torch.observability import (collector, exemplars,
                                                tracing)
    from paddle_tpu_torch.serving import (save_generation_model,
                                          server_from_model_dir)
    from paddle_tpu_torch.serving.generation import (WARM_START_DIRNAME,
                                                     WARM_START_MANIFEST)

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    trace_dir = os.path.join(tmp, "traces")
    os.makedirs(trace_dir)
    log = open(os.path.join(tmp, "replicas.log"), "w")
    failed, out = [], {}
    fw.reset_unique_names()
    _, dec = build_lm_paged_decoder(V, BLOCK, MAX_BLOCKS, d_model=D_MODEL,
                                    n_heads=N_HEADS, n_layers=N_LAYERS,
                                    d_inner=D_INNER, place=place)
    states = _random_states(dec.state_shapes, SEED)   # the serve phase's
    del dec
    spec = {"vocab_size": V, "d_model": D_MODEL, "n_heads": N_HEADS,
            "n_layers": N_LAYERS, "d_inner": D_INNER, "block_size": BLOCK,
            "max_blocks_per_seq": MAX_BLOCKS, "slots": SLOTS,
            "kv_blocks": KV_BLOCKS}
    t0 = time.perf_counter()
    model_dir = save_generation_model(os.path.join(tmp, "lm"), states,
                                      spec, warm_start=True, place=place)
    out["artifact_s"] = time.perf_counter() - t0
    with open(os.path.join(model_dir, WARM_START_DIRNAME,
                           WARM_START_MANIFEST)) as f:
        manifest = json.load(f)
    out["manifest"] = manifest
    on_card = resolve_place(place).type == "cuda"
    check(set(manifest["sources"]) == ({pa.SOURCE} if on_card else set())
          and manifest["compute_capability"] == (
              list(torch.cuda.get_device_capability(0)) if on_card
              else None),
          f"fleet: warm-start manifest {manifest}")
    reqs = _fleet_requests(4000, SEED + 2)
    env = dict(os.environ, PADDLE_TPU_METRICS="on",
               PADDLE_TPU_EXEMPLARS="on", PADDLE_TPU_TRACE_DIR=trace_dir,
               PADDLE_TPU_TAIL_SAMPLE=str(FLEET_TAIL_S),
               PADDLE_TPU_FLIGHT_DIR=trace_dir,
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("PADDLE_TPU_COMPILATION_CACHE_DIR", None)
    env.pop("PADDLE_TPU_TELEMETRY_REGISTRY", None)
    # this process is the router member: its latency histogram keeps
    # exemplars and its slow requests' traces are tail-sampled
    exemplars.set_armed(True)
    tracing.arm_tail_sampler(threshold_s=FLEET_TAIL_S, out_dir=trace_dir,
                             max_kept=1 << 14)
    router = ReplicaRouter(desired=8, refresh_s=0.1)
    coll = collector.TelemetryCollector(registry_addr=router.registry_addr,
                                        period_s=FLEET_SCRAPE_S)
    coll.start()
    members = _MemberWatch(coll)
    ann = collector.announce(router.registry_addr, "router",
                             member="router")
    launcher = _FleetLauncher(model_dir, router.registry_addr, env, log,
                              int(on_card),
                              extra=("--telemetry", router.registry_addr))
    policy = AutoscalerPolicy(FLEET_MIN, FLEET_MAX, **FLEET_POLICY)
    scaler = Autoscaler(router, launcher, policy, poll_s=FLEET_POLL_S,
                        window_s=FLEET_WINDOW_S, spawn_timeout_s=300.0,
                        drain_grace_s=30.0)
    watch = streams = None
    # the cold replica (the build dir empty, the artifact ignored; no
    # registry, no telemetry) boots beside the floor replica and answers
    # one request
    cold_dir = os.path.join(tmp, "cold_build")
    os.makedirs(cold_dir)
    cold = _ColdReplica(_FleetLauncher(
        model_dir, "", dict(env, PADDLE_TPU_COMPILATION_CACHE_DIR=cold_dir),
        log, int(on_card), extra=("--cold",), prefix="cold"), reqs[0][0])
    # the autoscaler's notes on the phase's clock
    timeline, note = [], scaler._note

    def noted(what):
        timeline.append([time.perf_counter() - t_phase, what])
        note(what)
    scaler._note = noted
    try:
        # the floor replica, warm from the artifact; its first token
        t0 = time.perf_counter()
        scaler.ensure_min(timeout_s=300)
        live = router.live_replicas()
        check(len(live) == 1, f"fleet: ensure_min left {live}")
        h, t_spawn = launcher.spawned[0]
        out["warm_first_token_s"], _ = _first_token_s(
            live[0], t_spawn, reqs[0][0], 8)
        out["floor_up_s"] = time.perf_counter() - t0
        watch = _StatsWatch(router)

        # one replica's sustained rate: a closed-loop burst
        burst = range(1, 1 + FLEET_BURST)
        burst_s, closed = _closed_loop(router, reqs, burst, SLOTS)
        tokens_per_s = sum(reqs[i][1] for i in burst) / burst_s
        req_per_s = tokens_per_s / float(np.mean([m for _, m in reqs]))
        out["closed_loop"] = {"requests": len(burst), "seconds": burst_s,
                              "tokens_per_s": tokens_per_s,
                              "requests_per_s": req_per_s}

        # the open-loop ramp: low, the peak (on until the scale-out
        # replica has served beside the floor one and the busiest owned
        # replica is SIGKILLed), the tail (until a scale-in leaves one)
        scaler.policy = AutoscalerPolicy(
            FLEET_MIN, FLEET_MAX,
            backlog_high=FLEET_BACKLOG_HIGH_S * tokens_per_s,
            backlog_low=FLEET_BACKLOG_LOW_S * tokens_per_s, **FLEET_POLICY)
        scaler.start()
        streams, kill, two = _Streams(), {}, {}
        sizes = {"peak": [], "tail": []}
        nxt = 1 + FLEET_BURST
        marks = [("low", time.perf_counter())]
        nxt = _open_loop(router, streams, reqs, nxt,
                         FLEET_RAMP[0] * req_per_s, FLEET_LOW_S)

        def live_now(phase):
            live = router.live_replicas(include_draining=False,
                                        refresh=False)
            sizes[phase].append(len(live))
            return live

        def maybe_kill(live):
            owned = scaler.owned_pids()
            serving = [a for a in owned if a in live]
            if len(serving) < 2:
                return
            t = time.perf_counter()
            two.setdefault("t", t)
            load = router.stats()["replicas"]
            addr = max(serving, key=lambda a: load.get(a, 0))
            # more than one request's tokens: several streams on it
            if (t - two["t"] < FLEET_KILL_AFTER_S
                    or load.get(addr, 0) <= FLEET_NEW[1]):
                return
            # the fleet's federation dump at the peak, for `cli slo`
            coll.scrape_once()
            kill["peak_dump"] = coll.write_federation(
                os.path.join(tmp, "peak.prom"))
            in_flight = streams.in_flight()
            kill.update(addr=addr, pid=owned[addr],
                        t=time.perf_counter(), live=len(live),
                        outstanding=load[addr],
                        streams_in_flight=len(in_flight),
                        retries_before=router.stats()["retries"],
                        in_flight=[(i, len(g)) for i, _, g in in_flight])
            members.mark("kill")
            os.kill(owned[addr], signal.SIGKILL)

        def peak_done(now):
            live = live_now("peak")
            if "pid" not in kill:
                maybe_kill(live)
            check(now < FLEET_PEAK_MAX_S or "pid" in kill,
                  f"fleet: no SIGKILL {FLEET_PEAK_MAX_S} s into the peak "
                  f"(sizes {_runs(sizes['peak'])}, two serving since "
                  f"{two.get('t')})")
            return ("pid" in kill and time.perf_counter() - kill["t"]
                    >= FLEET_AFTER_KILL_S)

        marks.append(("peak", time.perf_counter()))
        nxt = _open_loop(router, streams, reqs, nxt,
                         FLEET_RAMP[1] * req_per_s, FLEET_PEAK_S,
                         until=peak_done)
        marks.append(("tail", time.perf_counter()))

        def scaled_in(now):
            live = live_now("tail")
            check(now < FLEET_TAIL_MAX_S, f"fleet: {len(live)} replicas "
                  f"{FLEET_TAIL_MAX_S} s into the tail")
            return (len(live) == 1
                    and not scaler.status()["pending_spawns"]
                    and any(e.startswith("scale-in complete")
                            for e in scaler.events))

        nxt = _open_loop(router, streams, reqs, nxt,
                         FLEET_RAMP[2] * req_per_s, 0.0, until=scaled_in)
        streams.join()
        scaler.stop()
        marks.append(("close", time.perf_counter()))
        # the fleet, back at one replica and no longer scaled, serves a
        # closing closed-loop burst: the dump's latency and phase series
        # are the live members'
        close_s, closing = _closed_loop(
            router, reqs, range(nxt, nxt + FLEET_BURST), SLOTS)
        closed.update(closing)
        out["closing"] = {"requests": len(closing), "seconds": close_s,
                          "tokens_per_s": sum(
                              map(len, closing.values())) / close_s}
        watch.poll()
        final = router.live_replicas(include_draining=False)
        rstats = router.stats()

        # every stream whole, equal to the in-process reference
        results, bad = dict(closed), []
        for i, s, got in streams.items:
            try:
                results[i] = s.result(timeout=60)
            except Exception as e:  # noqa: BLE001 (a failed request)
                bad.append((i, repr(e)))
        t_in = time.perf_counter()
        ref = server_from_model_dir(model_dir, place=place)
        try:
            want = _decode_all(ref, {i: reqs[i] for i in results})
        finally:
            ref.close()
        out["reference_s"] = time.perf_counter() - t_in
        cold.join(timeout=600)
        check("stats" in cold.record, f"fleet: the cold replica never "
              f"served: {cold.record}")
        out["cold"] = {"first_token_s": cold.record["first_token_s"],
                       **{k: cold.record["stats"][k] for k in (
                           "warm_start", "compiles", "compile_seconds",
                           "cache_hits", "cache_misses", "warmup_s",
                           "decode_kernel", "paged_attention_launches")}}
        if out["cold"]["compiles"] < 1 or out["cold"]["warm_start"]:
            failed.append(f"fleet: the cold replica built nothing: "
                          f"{out['cold']}")
        if (out["cold"]["decode_kernel"] != "cuda"
                or out["cold"]["paged_attention_launches"] < 1):
            failed.append(f"fleet: the cold replica decoded off the "
                          f"kernel: {out['cold']}")
        differ = sorted(i for i in results if results[i] != want[i])
        if bad or rstats["requests_failed"]:
            failed.append(f"fleet: {len(bad)} streams failed "
                          f"({rstats['requests_failed']} at the router): "
                          f"{bad[:3]}")
        if differ:
            failed.append(f"fleet: {len(differ)} of {len(results)} "
                          f"streams differ from the reference: "
                          f"{differ[:5]}")
        # the streams the kill found started: seconds from the kill to
        # each one's next token (a cut one's includes its retry and its
        # wait in the survivor's queue)
        gaps = []
        for i, _, got in streams.items:
            if dict(kill["in_flight"]).get(i):
                after = [t for t, _ in got if t > kill["t"]]
                if after:
                    gaps.append(after[0] - kill["t"])
        # a stream on a survivor goes on within ticks (5 ms each); a
        # gap of FLEET_CUT_GAP_S or more is a cut one's
        cut = [g for g in gaps if g >= FLEET_CUT_GAP_S]
        kill_out = {k: v for k, v in kill.items()
                    if k not in ("in_flight", "t", "peak_dump")}
        kill_out.update(
            retries=rstats["retries"] - kill["retries_before"],
            started_streams=len(gaps), started_cut=len(cut),
            kill_to_resumed_s=max(gaps) if gaps else None,
            median_gap_s=float(np.median(gaps)) if gaps else None,
            cut_median_gap_s=float(np.median(cut)) if cut else None,
            cut_min_gap_s=min(cut) if cut else None)
        if kill_out["retries"] < 2:
            failed.append(f"fleet: the SIGKILL cut {kill_out['retries']} "
                          f"stream(s), not several")

        # the ramp by phase: tokens delivered; the peak's two-replica
        # stretch, from the first poll that saw two serve to the kill
        by_phase = {}
        spans = list(zip(marks, marks[1:])) + [
            (("peak_two_replicas", two["t"]), ("kill", kill["t"]))]
        for (name, ta), (_, tb) in spans:
            toks = sum(1 for _, _, g in streams.items for t, _ in g
                       if ta <= t < tb)
            by_phase[name] = {"seconds": tb - ta, "tokens": toks,
                              "tokens_per_s": toks / (tb - ta)}
        st = scaler.status()
        member_of = {h.addr: launcher.members[h.pid]
                     for h, _ in launcher.spawned if h.addr}
        warm = {a: {"member": member_of.get(a), **{k: s.get(k) for k in (
            "warm_start", "compiles", "cache_hits", "cache_misses",
            "warmup_s", "decode_kernel")}} for a, s in watch.first.items()}
        for a, s in watch.last.items():
            warm[a]["recompiles_after_warmup"] = s[
                "recompiles_after_warmup"]
            warm[a]["generated_tokens"] = s["generated_tokens"]
            warm[a]["paged_attention_launches"] = s[
                "paged_attention_launches"]
        for a, s in warm.items():
            if not (s["warm_start"] and s["compiles"] == 0
                    and s["cache_misses"] == 0 and s["cache_hits"] >= 1
                    and s["recompiles_after_warmup"] == 0
                    and s["decode_kernel"] == "cuda"):
                failed.append(f"fleet: replica {a} not warm: {s}")
            if s["generated_tokens"] and not s["paged_attention_launches"]:
                failed.append(f"fleet: replica {a} served "
                              f"{s['generated_tokens']} tokens and "
                              f"launched no paged-attention kernel")
        if max(sizes["peak"]) < 2:
            failed.append(f"fleet: the peak never had two replicas: "
                          f"{_runs(sizes['peak'])}")
        if len(final) != 1 or not any(
                e.startswith("scale-in complete") for e in scaler.events):
            failed.append(f"fleet: final {final}, no scale-in: "
                          f"{scaler.events}")
        if st["crashloops"]:
            failed.append(f"fleet: {st['crashloops']} crash loops")

        # the tools, on a federation dump of the fleet as it ends
        tracing.tail_sampler().flush(force=True)
        coll.scrape_once()
        dump = coll.write_federation(os.path.join(tmp, "fleet.prom"))
        bad_tools, tools = _fleet_tools(router.registry_addr, dump,
                                        kill["peak_dump"], trace_dir,
                                        os.path.join(tmp, "joined"), root)
        failed += bad_tools
        # every member this phase started, in the collector
        bad_members, tools["members"] = _fleet_members_verdict(
            members.snapshot(), launcher,
            set(scaler.owned_pids().values()), kill["pid"])
        failed += bad_members
        out.update(
            requests=len(results), tokens=sum(map(len, results.values())),
            streams_equal_reference=len(results) - len(differ),
            requests_failed=rstats["requests_failed"] + len(bad),
            sizes={p: _runs(v) for p, v in sizes.items()},
            final=len(final), peak=max(sizes["peak"]),
            ramp=by_phase, kill=kill_out, replicas=warm,
            scale_events=[e for e in scaler.events
                          if e.startswith(("scale", "spawn", "retire",
                                           "replica"))],
            timeline=timeline, crashloops=st["crashloops"],
            marks={n: t - t_phase for n, t in marks},
            two_replicas_at_s=two["t"] - t_phase,
            kill_at_s=kill["t"] - t_phase,
            tools=tools, rates=[r * req_per_s for r in FLEET_RAMP])
    except CheckFailed as e:
        # the record so far still goes out on the phase line
        failed.append(str(e))
        out["timeline"] = timeline
    finally:
        if watch is not None:
            watch.close()
        members.stop()
        cold.close()
        scaler.close(retire_owned=True)
        for h, _ in launcher.spawned:
            if h.alive():
                h.kill()
            h.wait(timeout=60)
        ann.close()
        coll.close()
        router.close()
        tracing.disarm_tail_sampler()
        exemplars.set_armed(False)
        log.close()
    out["phase_s"] = time.perf_counter() - t_phase
    if failed:
        with open(os.path.join(tmp, "replicas.log")) as f:
            tail = f.read()[-3000:]
        failed.append(f"replica log tail: {tail}")
    else:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "fleet", "card": card, "model": spec,
          "policy": dict(FLEET_POLICY, min=FLEET_MIN, max=FLEET_MAX,
                         poll_s=FLEET_POLL_S, window_s=FLEET_WINDOW_S),
          "ramp_rates_x": FLEET_RAMP, **out})
    check(not failed, "; ".join(failed))
    return out


def _conv_bn(fluid, x, filter_size, num_filters, stride, padding, groups=1,
             act="relu", is_test=False):
    """mobilenet_ssd.py conv_bn: a conv with no bias, then batch norm."""
    conv = fluid.layers.conv2d(input=x, num_filters=num_filters,
                               filter_size=filter_size, stride=stride,
                               padding=padding, groups=groups, act=None,
                               bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act, is_test=is_test)


def _ssd_net(fluid, img, classes, scale, is_test):
    """MobileNet-SSD's network (mobilenet_ssd.py mobile_net) -> (the
    locations [N, priors, 4], the confidences [N, priors, classes], the
    priors [priors, 4], their variances)."""
    def dw_sep(x, f1, f2, groups, stride):
        x = _conv_bn(fluid, x, 3, int(f1 * scale), stride, 1,
                     groups=int(groups * scale), is_test=is_test)
        return _conv_bn(fluid, x, 1, int(f2 * scale), 1, 0, is_test=is_test)

    def extra(x, f1, f2):
        x = _conv_bn(fluid, x, 1, int(f1 * scale), 1, 0, is_test=is_test)
        return _conv_bn(fluid, x, 3, int(f2 * scale), 2, 1, is_test=is_test)

    x = _conv_bn(fluid, img, 3, int(32 * scale), 2, 1, is_test=is_test)
    for f1, f2, stride in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                           (128, 256, 2), (256, 256, 1), (256, 512, 2)):
        x = dw_sep(x, f1, f2, f1, stride)
    for _ in range(5):
        x = dw_sep(x, 512, 512, 512, 1)
    module11 = x
    x = dw_sep(x, 512, 1024, 512, 2)
    module13 = dw_sep(x, 1024, 1024, 1024, 1)
    maps = [module11, module13]
    for f1, f2 in ((256, 512), (128, 256), (128, 256), (64, 128)):
        maps.append(extra(maps[-1], f1, f2))
    ars = [[2.0]] + [[2.0, 3.0]] * 5
    box, var = fluid.layers.prior_box(maps, img, min_ratio=20, max_ratio=90,
                                      aspect_ratios=ars,
                                      base_size=img.shape[2], offset=0.5,
                                      flip=True, clip=True)
    locs, confs = [], []
    for m, ar in zip(maps, ars):
        k = 2 * len(ar) + 2        # 1, each ratio and its flip, the max
        h, w = m.shape[2], m.shape[3]
        for out, n, width in ((locs, 4, 4), (confs, classes, classes)):
            head = fluid.layers.conv2d(input=m, num_filters=k * n,
                                       filter_size=3, padding=1)
            head = fluid.layers.transpose(head, axis=[0, 2, 3, 1])
            out.append(fluid.layers.reshape(head, shape=[-1, h * w * k,
                                                         width]))
    return (fluid.layers.concat(locs, axis=1),
            fluid.layers.concat(confs, axis=1), box, var)


def _ssd_program(fluid, fw, img=SSD_IMG, classes=SSD_CLASSES,
                 scale=SSD_SCALE, lr=SSD_LR, dtype="float32"):
    """MobileNet-SSD trained with ssd_loss and decoded -> (main, startup,
    the loss, the decode program, its detections, its mAP).  The loss is
    ssd_loss's reduce_sum over the priors times `inv_matched` (a [1]
    feed: 1 / the priors matched, one a ground-truth box); RMSProp at
    `lr`.  The
    decode program is the network again in test mode (batch norm's
    running statistics; the same parameter names), the box decode and
    multiclass_nms at their defaults (detection_output), and
    detection_map against `gt_map` rows (label, box, difficult)."""
    def build(is_test):
        image = fluid.layers.data(name="image", shape=[3, img, img],
                                  dtype=dtype)
        return image, _ssd_net(fluid, image, classes, scale, is_test)

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        _, (loc, conf, box, var) = build(False)
        gt_box = fluid.layers.data(name="gt_box", shape=[4],
                                   dtype=dtype, lod_level=1)
        gt_label = fluid.layers.data(name="gt_label", shape=[1],
                                     dtype="int64", lod_level=1)
        inv = fluid.layers.data(name="inv_matched", shape=[1],
                                dtype=dtype, append_batch_size=False)
        cost = fluid.layers.ssd_loss(loc, conf, gt_box, gt_label, box, var,
                                     overlap_threshold=0.5,
                                     neg_pos_ratio=3.0)
        loss = fluid.layers.elementwise_mul(fluid.layers.reduce_sum(cost),
                                            inv)
        fluid.RMSProp(learning_rate=lr).minimize(loss)
    fw.reset_unique_names()
    decode = fluid.Program()
    with fluid.program_guard(decode, fluid.Program()):
        _, (loc, conf, box, var) = build(True)
        scores = fluid.layers.transpose(fluid.layers.softmax(conf),
                                        axis=[0, 2, 1])
        nmsed = fluid.layers.detection_output(loc, scores, box, var)
        gt_map = fluid.layers.data(name="gt_map", shape=[6],
                                   dtype=dtype, lod_level=1)
        m_ap = fluid.layers.detection_map(nmsed, gt_map)
    return main, startup, loss, decode, nmsed, m_ap


def _ssd_feed(rng, n, img=SSD_IMG, classes=SSD_CLASSES,
              boxes=SSD_BOXES, dtype=np.float32):
    """A VOC-shaped batch of `n` images -> (the train feed, the decode
    feed): images uniform in [-1, 1), `boxes` (a (low, high) range) ground
    truth boxes an image, labels in 1..classes-1, normalised corners with
    sides of at least 0.05, a `difficult` flag one box in eight; the
    float values in `dtype`."""
    from paddle_tpu_torch.core.lod import LoDTensor, lod_from_seq_lens

    counts = rng.randint(boxes[0], boxes[1] + 1, n)
    g = int(counts.sum())
    lo = rng.uniform(0.0, 0.8, (g, 2))
    hi = np.minimum(lo + rng.uniform(0.05, 0.6, (g, 2)), 1.0)
    box = np.concatenate([lo, hi], 1).astype(np.float32)
    label = rng.randint(1, classes, (g, 1)).astype(np.int64)
    difficult = (rng.uniform(size=(g, 1)) < 0.125).astype(np.float32)
    lod = [lod_from_seq_lens(counts)]
    image = rng.uniform(-1, 1, (n, 3, img, img)).astype(np.float32)
    train = {"image": image.astype(dtype),
             "gt_box": LoDTensor(box.astype(dtype), lod),
             "gt_label": LoDTensor(label, lod),
             "inv_matched": np.asarray([1.0 / g], dtype)}
    gt_map = np.concatenate([label.astype(np.float32), box, difficult],
                            1).astype(dtype)
    return train, {"image": train["image"], "gt_map": LoDTensor(gt_map, lod)}


def _crnn_net(fluid, images, filters, hidden, classes, is_test,
              dtype="float32"):
    """CRNN-CTC's encoder (crnn_ctc_model.py encoder_net): four conv
    groups (crnn_ctc_model.py conv_bn_pool: two 3x3 convs, each with batch
    norm and ReLU, then a 2x2 max pool; nets.img_conv_group's ops),
    im2sequence over the feature map's height, two fc into a forward and
    a reverse GRU, an fc over both to classes + 1."""
    x = images
    for f in filters:
        for _ in range(2):
            x = fluid.layers.conv2d(input=x, num_filters=f, filter_size=3,
                                    padding=1)
            x = fluid.layers.batch_norm(input=x, act="relu",
                                        is_test=is_test)
        x = fluid.layers.pool2d(input=x, pool_size=2, pool_type="max",
                                pool_stride=2)
    seq = fluid.layers.im2sequence(input=x, stride=[1, 1],
                                   filter_size=[x.shape[2], 1])
    fc_1 = fluid.layers.fc(input=seq, size=hidden * 3)
    fc_2 = fluid.layers.fc(input=seq, size=hidden * 3)
    fwd = fluid.layers.dynamic_gru(input=fc_1, size=hidden,
                                   candidate_activation="relu", dtype=dtype)
    bwd = fluid.layers.dynamic_gru(input=fc_2, size=hidden, is_reverse=True,
                                   candidate_activation="relu", dtype=dtype)
    return fluid.layers.fc(input=[fwd, bwd], size=classes + 1)


def _crnn_program(fluid, fw, img=OCR_IMG, filters=OCR_FILTERS,
                  hidden=OCR_HIDDEN, classes=OCR_CLASSES, lr=OCR_LR,
                  dtype="float32"):
    """CRNN-CTC trained with warpctc (blank = classes, norm_by_times),
    reduce_sum, Momentum -> (main, startup, the loss, the decode program,
    its greedy decode, its edit distances).  The decode program is the
    network in test mode (the same parameter names), ctc_greedy_decoder
    and edit_distance against the labels."""
    def build(is_test):
        images = fluid.layers.data(name="pixel", shape=list(img),
                                   dtype=dtype)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64",
                                  lod_level=1)
        return label, _crnn_net(fluid, images, filters, hidden, classes,
                                is_test, dtype)

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        label, fc_out = build(False)
        cost = fluid.layers.warpctc(input=fc_out, label=label,
                                    blank=classes, norm_by_times=True)
        loss = fluid.layers.reduce_sum(cost)
        fluid.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    fw.reset_unique_names()
    decode = fluid.Program()
    with fluid.program_guard(decode, fluid.Program()):
        label, fc_out = build(True)
        decoded = fluid.layers.ctc_greedy_decoder(input=fc_out,
                                                  blank=classes)
        dist, _ = fluid.layers.edit_distance(decoded, label)
    return main, startup, loss, decode, decoded, dist


def _crnn_feed(rng, n, img=OCR_IMG, classes=OCR_CLASSES,
               lens=OCR_LABEL_LENS, dtype=np.float32):
    """`n` images uniform in [0, 1) (drawn in float32, held in `dtype`)
    and label sequences of lengths drawn in `lens` over the classes (the
    blank excluded)."""
    from paddle_tpu_torch.core.lod import LoDTensor, lod_from_seq_lens

    counts = rng.randint(lens[0], lens[1] + 1, n)
    label = rng.randint(0, classes, (int(counts.sum()), 1)).astype(np.int64)
    return {"pixel": rng.uniform(0, 1, (n,) + tuple(img)).astype(
        np.float32).astype(dtype),
        "label": LoDTensor(label, [lod_from_seq_lens(counts)])}


@contextlib.contextmanager
def _host_op_times(types):
    """Each host op type's lowering timed (`_host_timed`) while inside ->
    {type: [seconds a call]}."""
    secs = {t: [] for t in types}
    with contextlib.ExitStack() as stack:
        for t in types:
            stack.enter_context(_wrapped_lowering(t, _host_timed(secs[t])))
        yield secs


def _host_ms(secs):
    return {t: {"ms_per_call": float(np.median(v)) * 1e3, "calls": len(v)}
            for t, v in secs.items() if v}


def _op_var(program, op_type, slot, io="outputs"):
    """The name bound to `slot` of the first `op_type` op."""
    op = next(o for o in program.global_block().ops if o.type == op_type)
    return getattr(op, io)[slot][0]


def _match_rounds(dist, eps=1e-6):
    """bipartite_match's greedy rounds on one image's [rows, cols]
    distances -> [(column, row, best, runner-up)]: each round's choice
    and the margin it won by (ops/detection.py bipartite_match_np)."""
    rows = dist.shape[0]
    cand = np.where(dist.T >= eps, dist.T, -np.inf).astype(np.float64)
    rounds = []
    for _ in range(rows):
        flat = np.argsort(-cand, axis=None, kind="stable")[:2]
        j, m = divmod(int(flat[0]), rows)
        best = cand[j, m]
        if best == -np.inf:
            break
        second = cand.reshape(-1)[flat[1]] if len(flat) > 1 else -np.inf
        rounds.append((j, m, float(best), float(second)))
        cand[j, :] = -np.inf
        cand[:, m] = -np.inf
    return rounds


def _near(a, b, rtol=DECIDE_RTOL):
    return abs(a - b) <= rtol * max(1.0, abs(a), abs(b))


def _ssd_decisions(card, cpu, offs):
    """The card's bipartite matches and mined negatives against the
    CPU's, decision by decision -> (ok, a record).  `card` and `cpu` are
    (DistMat, match indices, class losses, NegIndices data, its LoD).
    A differing match round passes only where the CPU's winner beat its
    runner-up by at most DECIDE_RTOL (a flipped near tie); an image whose
    matches differ is not held on its negatives.  Differing negatives
    pass only where the CPU's last chosen and first passed-over
    candidates' losses are within DECIDE_RTOL."""
    c_dist, c_match, _, c_neg, c_lod = card
    p_dist, p_match, p_loss, p_neg, p_lod = cpu
    rec = {"images": len(offs) - 1, "match_flips": [], "negative_flips": []}
    for b in range(len(offs) - 1):
        if np.array_equal(c_match[b], p_match[b]):
            cn = c_neg[c_lod[b]:c_lod[b + 1]].reshape(-1)
            pn = p_neg[p_lod[b]:p_lod[b + 1]].reshape(-1)
            if np.array_equal(cn, pn):
                continue
            cands = np.flatnonzero(p_match[b] == -1)
            order = cands[np.argsort(-p_loss[b][cands], kind="stable")]
            k = len(pn)
            last, nxt = p_loss[b][order[k - 1]], (
                p_loss[b][order[k]] if k < len(order) else -np.inf)
            ok = _near(float(last), float(nxt))
            rec["negative_flips"].append({"image": b, "cpu_margin": float(
                last - nxt), "near_tie": ok})
            if not ok:
                return False, rec
            continue
        c_r = _match_rounds(c_dist[offs[b]:offs[b + 1]])
        p_r = _match_rounds(p_dist[offs[b]:offs[b + 1]])
        first = 0
        while first < min(len(c_r), len(p_r)) and \
                c_r[first][:2] == p_r[first][:2]:
            first += 1
        rnd = p_r[first] if first < len(p_r) else None
        ok = rnd is not None and _near(rnd[2], rnd[3])
        rec["match_flips"].append({"image": b, "round": first,
                                   "cpu_margin": None if rnd is None
                                   else rnd[2] - rnd[3], "near_tie": ok})
        if not ok:
            return False, rec
    return True, rec


def _ssd_train(card, place, peaks):
    """The ssd phase's training part -> (its record, the decode's)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw

    phase = "ssd"
    main, startup, loss, decode, nmsed, m_ap = _ssd_program(fluid, fw)
    blk = main.global_block()
    priors = blk.vars[_op_var(main, "iou_similarity", "Y", "inputs")].shape[0]
    check(priors == SSD_PRIORS, f"{phase}: {priors} priors, want "
          f"{SSD_PRIORS}")
    rng = np.random.RandomState(SEED + 17)
    feed, dfeed = _ssd_feed(rng, SSD_BATCH)
    more = [_ssd_feed(rng, SSD_BATCH)[0] for _ in range(SSD_LODS)]
    boxes = feed["gt_box"].seq_lens()
    decode_rec = {}

    def after(exe):
        segs = _segment_runs(exe, main)
        extra = _mt_more_lods(phase, exe, main, loss, more, segments=3)
        decode_rec.update(_ssd_decode(exe, decode, nmsed, m_ap, dfeed))
        return {"segments": segs, "more_lods": extra}

    with _host_op_times(("bipartite_match", "mine_hard_examples")) as secs:
        r = _default_and_interpreter(phase, place, main, startup, loss,
                                     lambda step: feed, ("matmul",),
                                     after=after, segments=3)
    segs = r["extra"]["segments"]
    check([k for k, _ in segs] == ["device", "host", "device", "host",
                                   "device"],
          f"{phase}: segments {segs}: want three device segments around "
          "the host bipartite_match and mine_hard_examples")
    _loss_falls(phase, r["k_loss"], SSD_LOSS_FROM)
    step_s = float(np.median(r["k_secs"][2:]))
    host = _host_ms(secs)
    host_s = sum(v["ms_per_call"] for v in host.values()) / 1e3
    flops = _model_flops(main, SSD_BATCH)
    del r["init"], r["k_state"]
    return {"phase": phase, "card": card,
            "source": "PaddlePaddle/models fluid/object_detection/"
                      "mobilenet_ssd.py (2018), MobileNet v1 width 1.0 "
                      "(Howard et al. 2017, Table 1); the widths PERF.md "
                      "section 4 gives where not checkable offline",
            "image": SSD_IMG, "classes": SSD_CLASSES, "priors": priors,
            "batch": SSD_BATCH, "optimizer": f"rmsprop {SSD_LR}",
            "loss_held_from_step": SSD_LOSS_FROM,
            "gt_boxes_per_image": boxes, "ops": len(blk.ops),
            "segments": segs, "steps": G_STEPS, **_rnn_record(r, step_s),
            "images_per_s": SSD_BATCH / step_s,
            "model_flops_per_step": flops,
            "fp32_flops_share": flops / step_s / peaks[torch.float32],
            "host_ops": host, "host_share_of_step": host_s / step_s,
            "more_lods": r["extra"]["more_lods"],
            "timing": _RNN_TIMING + "; host_ops the median host ms of a "
                      "call (the card drained before it), over the default "
                      "and the interpreted steps"}, decode_rec


def _ssd_decode(exe, decode, nmsed, m_ap, dfeed):
    """The decode program three times on the training batch (a miss, a
    capture of its device segment, a replay) -> a record: the replay's
    ms for the batch, the host ops' ms, detections and mAP."""
    with _host_op_times(("multiclass_nms", "detection_map")) as secs:
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det, m = exe.run(decode, feed=dfeed, fetch_list=[nmsed, m_ap],
                             return_numpy=False)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
    rows, lod = _to_host(det)
    m = float(_to_host(m)[0].reshape(-1)[0])
    check(rows.ndim == 2 and rows.shape[1] == 6 and np.isfinite(rows).all()
          and 0.0 <= m <= 1.0 and len(lod[0]) == SSD_BATCH + 1,
          f"ssd decode: detections {rows.shape}, mAP {m}")
    host = _host_ms(secs)
    ms = runs[-1] * 1e3
    return {"decode_ms": ms, "decode_runs_ms": [x * 1e3 for x in runs],
            "images": SSD_BATCH, "detections": int(rows.shape[0]),
            "detections_per_image": [b - a for a, b in zip(lod[0][:-1],
                                                           lod[0][1:])],
            "mAP": m, "host_ops": host,
            "nms_share": host["multiclass_nms"]["ms_per_call"] / ms}


def _to_host(v):
    """A fetched value as (numpy data, its LoD or None)."""
    lod = getattr(v, "lod", None)
    d = v.data if lod is not None else v
    d = d.detach().cpu().numpy() if isinstance(d, torch.Tensor) \
        else np.asarray(d)
    return d, lod


def _step_on(place, program, state, feed, fetch):
    """One run of `program` on `place` (None: the CPU) from `state` (CPU
    tensors) -> (its fetches as (numpy, LoD) pairs, the states after it
    as CPU tensors)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    prev = executor_mod.switch_scope(Scope())
    try:
        scope = fluid.global_scope()
        dev = place.torch_device() if place is not None else "cpu"
        for n, v in state.items():
            scope.set_var(n, v.to(dev))
        exe = fluid.Executor(place or fluid.CPUPlace(), seed=SEED)
        out = [_to_host(v) for v in exe.run(program, feed=feed,
                                              fetch_list=fetch,
                                              return_numpy=False)]
        after = {n: scope.find_var(n).cpu() for n in state}
        exe.close()
        return out, after
    finally:
        executor_mod.switch_scope(prev)


def _card_vs_cpu(phase, card, place, train, decode, decide=None, **info):
    """A program's steps on the card against the CPU, then its decode ->
    a record (one line, with `info`).  `train` is (main, startup, feeds, fetch): each
    feed is one step, run on `place` and on the CPU from the CPU's state
    before it; fetch[0] is the loss.  Each step holds the loss within
    N_CPU_LOSS_RTOL, every state after it within N_CPU_RTOL of max(1,
    |CPU|), and, where given, `decide(card fetches, CPU fetches, feed)`
    -> (ok, a record) on the decisions taken on the host.  `decode` is
    (program, feed, fetch, verdict): run on both from the CPU's last
    state and held by `verdict(card fetches, CPU fetches)` -> (ok, a
    record)."""
    main, startup, feeds, fetch = train
    t0 = time.perf_counter()
    state = _startup_state(place, startup, main)
    steps, fails = [], []
    for i, feed in enumerate(feeds):
        c, c_state = _step_on(place, main, state, feed, fetch)
        p, p_state = _step_on(None, main, state, feed, fetch)
        c_loss, p_loss = (float(v[0][0].reshape(-1)[0]) for v in (c, p))
        rel = _states_rel_diff(c_state, p_state)
        worst = max(rel, key=rel.get)
        ok, dec = decide(c, p, feed) if decide else (True, {})
        steps.append({"card": c_loss, "cpu": p_loss,
                      "loss_rel_diff": abs(c_loss - p_loss) / abs(p_loss),
                      "states": len(rel), "state_max_rel_diff": rel[worst],
                      "state_argmax": worst, **dec})
        if not ok:
            fails.append(f"step {i}: a decision differs from the CPU's "
                         f"beyond a near tie: {dec}")
        if not steps[-1]["loss_rel_diff"] <= N_CPU_LOSS_RTOL:
            fails.append(f"step {i}: loss {c_loss} against the CPU's "
                         f"{p_loss}")
        if not rel[worst] <= N_CPU_RTOL:
            fails.append(f"step {i}: {worst} differs by {rel[worst]} of "
                         "max(1, |CPU|)")
        state = p_state
    program, dfeed, dfetch, verdict = decode
    ok, rec = verdict(*(_step_on(pl, program, state, dfeed, dfetch)[0]
                        for pl in (place, None)))
    if not ok:
        fails.append(f"the decode differs from the CPU's beyond a near "
                     f"tie: {rec}")
    record = {"phase": phase, "card": card, **info, "steps": steps,
              "loss_limit": N_CPU_LOSS_RTOL, "state_limit": N_CPU_RTOL,
              "decision_rule": f"a differing decision passes where the "
                               f"CPU's margin there is within "
                               f"{DECIDE_RTOL}",
              "decode": rec, "seconds_both": time.perf_counter() - t0}
    emit(record)
    check(not fails, f"{phase}: " + "; ".join(fails))
    return record


def _ssd_card_vs_cpu(card, place, img=SSD_IMG, **cut):
    """`_card_vs_cpu` on the SSD (`_ssd_program`'s widths, or `cut`) in
    CPU_DTYPE at batch SSD_CPU_BATCH over SSD_CPU_STEPS steps: the
    bipartite matches and mined negatives by `_ssd_decisions`, the
    decode's detections by `_nms_verdict`."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw

    main, startup, loss, decode, nmsed, m_ap = _ssd_program(
        fluid, fw, img=img, dtype=CPU_DTYPE, **cut)
    rng = np.random.RandomState(SEED + 18)
    pairs = [_ssd_feed(rng, SSD_CPU_BATCH, img=img, dtype=CPU_DTYPE)
             for _ in range(SSD_CPU_STEPS)]
    fetch = [loss.name, _op_var(main, "bipartite_match", "DistMat",
                                "inputs"),
             _op_var(main, "bipartite_match", "ColToRowMatchIndices"),
             _op_var(main, "mine_hard_examples", "ClsLoss", "inputs"),
             _op_var(main, "mine_hard_examples", "NegIndices")]

    def decide(c, p, feed):
        return _ssd_decisions(
            (c[1][0], c[2][0], None, c[4][0], c[4][1][0]),
            (p[1][0], p[2][0], p[3][0].reshape(SSD_CPU_BATCH, -1), p[4][0],
             p[4][1][0]), feed["gt_box"].lod[0])

    def verdict(c, p):
        ok, rec = _nms_verdict(c[0][0], c[0][1][0], p[0][0], p[0][1][0])
        return ok, {**rec, "detections": int(p[0][0].shape[0]),
                    "mAP": [float(v[1][0].reshape(-1)[0]) for v in (c, p)]}

    return _card_vs_cpu("ssd_card_vs_cpu", card, place,
                        (main, startup, [f for f, _ in pairs], fetch),
                        (decode, pairs[0][1], [nmsed, m_ap], verdict),
                        decide, batch=SSD_CPU_BATCH, dtype=CPU_DTYPE)


def _nms_verdict(c_det, c_lod, p_det, p_lod, nms_threshold=0.3):
    """detection_output's rows (label, score, box) on the card against
    the CPU's, an image at a time, decision by decision -> (ok, a
    record).  Rows agree when the labels are equal and the score and the
    corners within DECIDE_RTOL.  At an image's first differing row the
    card may differ only by a flipped near tie on the CPU: the two rows'
    scores within DECIDE_RTOL (an order or a cut among near-equal
    scores), or a box one side kept whose IoU with a higher-scored box
    of its class the other side kept is within DECIDE_RTOL of the NMS
    threshold.  Rows after that point are not held."""
    from paddle_tpu_torch.ops.detection import iou_matrix_np

    def agree(a, b):
        return a[0] == b[0] and all(_near(float(x), float(y))
                                    for x, y in zip(a[1:], b[1:]))

    rec = {"images": len(p_lod) - 1, "differing_images": [],
           "equal": True}
    for b in range(len(p_lod) - 1):
        c = c_det[c_lod[b]:c_lod[b + 1]] if b + 1 < len(c_lod) else \
            c_det[:0]
        p = p_det[p_lod[b]:p_lod[b + 1]]
        r = 0
        while r < min(len(c), len(p)) and agree(c[r], p[r]):
            r += 1
        if r == len(c) == len(p):
            continue
        rec["equal"] = False
        why = None
        if r < min(len(c), len(p)) and _near(float(c[r][1]),
                                             float(p[r][1])):
            why = "score near tie"
        else:
            for side, other in ((c, p), (p, c)):
                if r >= len(side):
                    continue
                row = side[r]
                peers = other[(other[:, 0] == row[0])
                              & (other[:, 1] >= row[1])]
                if len(peers):
                    iou = iou_matrix_np(row[None, 2:6], peers[:, 2:6])
                    if _near(float(iou.max()), nms_threshold):
                        why = "IoU near the threshold"
        rec["differing_images"].append({"image": b, "row": r,
                                        "near_tie": why})
        if why is None:
            return False, rec
    return True, rec


def _startup_state(place, startup, main):
    """The startup's persistables on `place` -> CPU tensors."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    prev = executor_mod.switch_scope(Scope())
    try:
        exe = fluid.Executor(place, seed=SEED)
        exe.run(startup)
        state = {n: fluid.global_scope().find_var(n).cpu()
                 for n in _persistables(main)}
        exe.close()
        return state
    finally:
        executor_mod.switch_scope(prev)


def ssd_phase(card, place, peaks):
    """MobileNet-SSD300 on VOC's geometry (see the SSD_ constants): the
    default mode (three device segments between the host bipartite_match
    and mine_hard_examples, each captured and replayed) against the
    interpreter bit for bit on one batch, the loss falling, SSD_LODS
    more ground-truth LoDs; the decode program (detection_output's box
    decode and multiclass_nms, detection_map) on the batch; then card
    against CPU at batch SSD_CPU_BATCH; one line each."""
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    prev_scope = executor_mod.switch_scope(Scope())
    try:
        t_phase = time.perf_counter()
        rec, dec = _ssd_train(card, place, peaks)
        emit({**rec, "decode": dec,
              "seconds": time.perf_counter() - t_phase})
        t_phase = time.perf_counter()
        executor_mod.switch_scope(Scope())
        _ssd_card_vs_cpu(card, place)
        emit({"phase": "ssd_card_vs_cpu_done",
              "seconds": time.perf_counter() - t_phase})
    finally:
        executor_mod.switch_scope(prev_scope)
        torch.cuda.empty_cache()


def _ocr_train(card, place):
    """The ocr_ctc phase's training part -> its record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw

    phase = "ocr_ctc"
    main, startup, loss, decode, decoded, dist = _crnn_program(fluid, fw)
    rng = np.random.RandomState(SEED + 19)
    feed = _crnn_feed(rng, OCR_BATCH)
    more = [_crnn_feed(rng, OCR_BATCH) for _ in range(OCR_LODS)]
    dec = {}

    def after(exe):
        segs = _segment_runs(exe, main)
        extra = _mt_more_lods(phase, exe, main, loss, more)
        with _host_op_times(("ctc_align", "edit_distance")) as secs:
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, d = exe.run(decode, feed=feed, fetch_list=[decoded, dist],
                                 return_numpy=False)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
        d = _to_host(d)[0]
        check(np.isfinite(d).all() and d.shape == (OCR_BATCH, 1),
              f"{phase}: edit distances {d.shape}")
        dec.update({"decode_ms": runs[-1] * 1e3,
                    "decode_runs_ms": [x * 1e3 for x in runs],
                    "host_ops": _host_ms(secs),
                    "mean_edit_distance": float(d.mean()),
                    "decoded_chars": int(_to_host(out)[0].shape[0])})
        return {"segments": segs, "more_lods": extra}

    r = _default_and_interpreter(phase, place, main, startup, loss,
                                 lambda step: feed, ("matmul",), after=after)
    segs = r["extra"]["segments"]
    check(segs == [["device", len(main.global_block().ops)]],
          f"{phase}: segments {segs}: want one device segment")
    _loss_falls(phase, r["k_loss"])
    step_s = float(np.median(r["k_secs"][2:]))
    del r["init"], r["k_state"]
    return {"phase": phase, "card": card,
            "source": "PaddlePaddle/models fluid/ocr_recognition/"
                      "crnn_ctc_model.py (2018); the widths PERF.md "
                      "section 4 gives where not checkable offline",
            "image": list(OCR_IMG), "filters": list(OCR_FILTERS),
            "hidden": OCR_HIDDEN, "classes": OCR_CLASSES + 1,
            "batch": OCR_BATCH, "optimizer": f"momentum {OCR_LR} / 0.9",
            "label_lengths": feed["label"].seq_lens(),
            "ops": len(main.global_block().ops), "segments": segs,
            "steps": G_STEPS, **_rnn_record(r, step_s),
            "images_per_s": OCR_BATCH / step_s, "decode": dec,
            "more_lods": r["extra"]["more_lods"],
            "timing": _RNN_TIMING}


def _greedy_verdict(c_ids, p_ids, p_logits):
    """The card's per-frame argmax against the CPU's: equal, or differing
    only at frames where the CPU's two best logits are within
    DECIDE_RTOL -> (ok, differing frames, the CPU's largest margin
    among them)."""
    diff = np.flatnonzero(c_ids.reshape(-1) != p_ids.reshape(-1))
    if not len(diff):
        return True, 0, None
    top2 = -np.sort(-p_logits[diff], axis=1)[:, :2]
    margins = top2[:, 0] - top2[:, 1]
    ok = all(_near(float(a), float(b)) for a, b in top2)
    return ok, len(diff), float(margins.max())


def _ocr_card_vs_cpu(card, place, img=OCR_IMG, classes=OCR_CLASSES,
                     lens=OCR_LABEL_LENS, **cut):
    """`_card_vs_cpu` on the CRNN-CTC (`_crnn_program`'s widths, or
    `cut`) in CPU_DTYPE at batch OCR_CPU_BATCH over OCR_CPU_STEPS
    Momentum steps; the greedy decode's per-frame argmax equal but at the
    CPU's near ties (`_greedy_verdict`) and the decoded ids equal where
    no frame differs."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw

    main, startup, loss, decode, decoded, dist = _crnn_program(
        fluid, fw, img=img, classes=classes, dtype=CPU_DTYPE, **cut)
    rng = np.random.RandomState(SEED + 20)
    feeds = [_crnn_feed(rng, OCR_CPU_BATCH, img=img, classes=classes,
                        lens=lens, dtype=CPU_DTYPE)
             for _ in range(OCR_CPU_STEPS)]

    def verdict(c, p):
        ok, n_diff, margin = _greedy_verdict(c[1][0], p[1][0], p[2][0])
        equal = bool(np.array_equal(c[0][0], p[0][0])
                     and c[0][1] == p[0][1])
        return ok and (n_diff or equal), {
            "differing_frames": n_diff, "cpu_margin_there": margin,
            "decoded_equal": equal}

    return _card_vs_cpu(
        "ocr_ctc_card_vs_cpu", card, place,
        (main, startup, feeds, [loss.name]),
        (decode, feeds[0], [decoded, _op_var(decode, "top_k", "Indices"),
                            _op_var(decode, "top_k", "X", "inputs")],
         verdict), batch=OCR_CPU_BATCH, dtype=CPU_DTYPE)


def ocr_ctc_phase(card, place):
    """CRNN-CTC (see the OCR_ constants): the default mode (one CUDA
    graph) against the interpreter bit for bit on one batch, the loss
    falling, OCR_LODS more label LoDs, the greedy decode and edit
    distance; then card against CPU at batch OCR_CPU_BATCH; one line
    each."""
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    prev_scope = executor_mod.switch_scope(Scope())
    try:
        t_phase = time.perf_counter()
        rec = _ocr_train(card, place)
        emit({**rec, "seconds": time.perf_counter() - t_phase})
        t_phase = time.perf_counter()
        executor_mod.switch_scope(Scope())
        _ocr_card_vs_cpu(card, place)
        emit({"phase": "ocr_ctc_card_vs_cpu_done",
              "seconds": time.perf_counter() - t_phase})
    finally:
        executor_mod.switch_scope(prev_scope)
        torch.cuda.empty_cache()


# -- ops phase at working sizes (CTC, sampling, detection) --------------------

def _working_cases():
    """(name, op, inputs {slot: numpy or (numpy, lod)}, attrs, the input
    slots whose gradient is compared) at the working sizes."""
    r = np.random.RandomState(SEED + 21)
    rows, d, k = W_ROWS, W_WIDTH, W_CLASSES
    x = (0.1 * r.standard_normal((rows, d))).astype(np.float32)
    label = r.randint(0, k, (rows, 1)).astype(np.int64)
    t_lens = [OCR_IMG[2] // 16] * OCR_BATCH
    l_lens = r.randint(OCR_LABEL_LENS[0], OCR_LABEL_LENS[1] + 1, OCR_BATCH)
    n_img, c, h, w = W_ROI_X
    rois = []
    for _ in range(n_img * W_ROIS):
        x1, y1 = r.uniform(0, w * 16 - 64), r.uniform(0, h * 16 - 64)
        rois.append([x1, y1, x1 + r.uniform(32, w * 16 - x1),
                     y1 + r.uniform(32, h * 16 - y1)])
    return [
        ("hsigmoid", "hsigmoid", {
            "X": x, "W": (0.05 * r.standard_normal((k - 1, d))).astype(
                np.float32),
            "Bias": np.zeros(k - 1, np.float32), "Label": label},
         {"num_classes": k}, ("X", "W", "Bias")),
        ("nce", "nce", {
            "Input": x, "Weight": (0.05 * r.standard_normal((k, d))).astype(
                np.float32),
            "Bias": np.zeros(k, np.float32), "Label": label},
         {"num_total_classes": k, "num_neg_samples": W_NEG},
         ("Input", "Weight", "Bias")),
        ("roi_pool", "roi_pool", {
            "X": r.standard_normal(W_ROI_X).astype(np.float32),
            "ROIs": (np.asarray(rois, np.float32),
                     [[i * W_ROIS for i in range(n_img + 1)]])},
         {"pooled_height": 7, "pooled_width": 7, "spatial_scale": 1 / 16},
         ("X",)),
        ("warpctc", "warpctc", {
            "Logits": (r.standard_normal((sum(t_lens), OCR_CLASSES + 1))
                       .astype(np.float32), [list(np.cumsum([0] + t_lens))]),
            "Label": (r.randint(0, OCR_CLASSES, (int(l_lens.sum()), 1))
                      .astype(np.int64), [list(np.cumsum([0] + list(
                          l_lens)))])},
         {"blank": OCR_CLASSES, "norm_by_times": True}, ("Logits",)),
    ]


def _working_run(op, ins, attrs, slots, dev):
    """The op's forward and generic gradient (ones as the cotangent) on
    `dev` -> (outputs, gradients, a runner for timing: fwd, fwd + bwd)."""
    from paddle_tpu_torch.core.execution import (GRAD, ExecContext,
                                                 generic_grad_lower)
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.core.registry import get_op_info

    info = get_op_info(op)
    attrs = {**info.attrs, **attrs}
    vals = {}
    for s, a in ins.items():
        arr, lod = a if isinstance(a, tuple) else (a, None)
        t = torch.from_numpy(arr).to(dev)
        vals[s] = [t if lod is None else LoDTensor(t, lod)]
    ctx = ExecContext(dev, seed=SEED)
    out_slot = info.diff_outputs[0]

    def fwd():
        return info.lower(ctx, vals, attrs)

    def both():
        outs = fwd()
        o = outs[out_slot]
        o = o.data if isinstance(o, LoDTensor) else o
        g = dict(vals, **{s: [v] for s, v in outs.items()})
        g[out_slot + GRAD] = [torch.ones_like(o)]
        return outs, generic_grad_lower(ctx, g, attrs, info)

    outs, grads = both()
    data = lambda v: v.data if isinstance(v, LoDTensor) else v  # noqa: E731
    return ({s: data(v) for s, v in outs.items() if v is not None},
            {s: data(grads[s + GRAD][0]) for s in slots}, fwd, both)


def _host_op_inputs(r):
    """SSD300's host ops at full width (batch SSD_BATCH, 2278 priors, 21
    classes): the program's priors against a VOC-shaped feed's boxes ->
    {op: (inputs, attrs)}."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.core import executor as executor_mod

    fw.reset_unique_names()
    prog, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, start):
        img = fluid.layers.data(name="image", shape=[3, SSD_IMG, SSD_IMG],
                                dtype="float32")
        box = _ssd_net(fluid, img, SSD_CLASSES, SSD_SCALE, True)[2]
    prev = executor_mod.switch_scope(Scope())
    try:
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(start)
        priors = exe.run(prog, feed={"image": np.zeros(
            (1, 3, SSD_IMG, SSD_IMG), np.float32)}, fetch_list=[box])[0]
    finally:
        executor_mod.switch_scope(prev)
    feed, dfeed = _ssd_feed(r, SSD_BATCH)
    gt = feed["gt_box"]
    n, m, c = SSD_BATCH, len(priors), SSD_CLASSES
    lo = r.uniform(0, 0.8, (n, m, 2))
    boxes = np.concatenate([lo, lo + r.uniform(0.02, 0.3, (n, m, 2))], -1)
    logits = r.standard_normal((n, c, m))
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return priors, gt, boxes.astype(np.float32), scores.astype(np.float32), \
        dfeed["gt_map"], r.uniform(0, 3, (n, m)).astype(np.float32)


def _host_ops_at_width(dev):
    """bipartite_match, mine_hard_examples, multiclass_nms and
    detection_map at SSD300's width on the card's values -> {op: ms a
    call, the read-backs included}.  multiclass_nms sorts and takes its
    IoUs and greedy passes on the values' device: its rows and LoD on
    the card must equal the CPU's bit for bit."""
    from paddle_tpu_torch.core.execution import ExecContext
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.core.registry import get_op_info

    r = np.random.RandomState(SEED + 22)
    priors, gt, boxes, scores, gt_map, loss = _host_op_inputs(r)
    ctx = ExecContext(dev)

    def op(name, ins, **attrs):
        info = get_op_info(name)
        return lambda: info.lower(ctx, ins, {**info.attrs, **attrs})

    def on(a, lod=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t if lod is None else LoDTensor(t, lod)

    iou = get_op_info("iou_similarity").lower(
        ctx, {"X": [on(gt.data, gt.lod)], "Y": [on(priors)]}, {})["Out"]
    match = op("bipartite_match", {"DistMat": [iou]})()
    runs = {
        "bipartite_match": op("bipartite_match", {"DistMat": [iou]}),
        "mine_hard_examples": op("mine_hard_examples", {
            "ClsLoss": [on(loss)],
            "MatchIndices": [match["ColToRowMatchIndices"]],
            "MatchDist": [match["ColToRowMatchDist"]]}),
        "multiclass_nms": op("multiclass_nms", {"BBoxes": [on(boxes)],
                                                "Scores": [on(scores)]}),
    }
    det = runs["multiclass_nms"]()["Out"]
    cpu = get_op_info("multiclass_nms").lower(
        ExecContext(torch.device("cpu")), {
            "BBoxes": [torch.from_numpy(boxes)],
            "Scores": [torch.from_numpy(scores)]},
        dict(get_op_info("multiclass_nms").attrs))["Out"]
    check(det.lod == cpu.lod and torch.equal(det.data.cpu(), cpu.data),
          "ops_working: multiclass_nms at SSD300's width differs between "
          "the card and the CPU")
    runs["detection_map"] = op("detection_map", {
        "DetectRes": [det], "Label": [on(gt_map.data, gt_map.lod)]})
    out = {}
    for name, fn in runs.items():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = {"ms_per_call": float(np.median(times)) * 1e3,
                     "calls": len(times)}
    out["multiclass_nms"]["detections"] = int(det.data.shape[0])
    out["multiclass_nms"]["card_equals_cpu"] = True
    return out


def _ctc_kernels(fwd, both):
    """Kernels a call launches (torch.profiler): the warpctc forward, and
    the forward with its generic gradient."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for fn in (fwd, both):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(ev.count for ev in prof.key_averages()
                          if ev.device_type == DeviceType.CUDA))
    return {"forward": counts[0], "forward_and_gradient": counts[1]}


def ops_working_phase(card, dev):
    """hsigmoid and nce at W_CLASSES classes, width W_WIDTH, on W_ROWS
    rows (nce with W_NEG negatives), roi_pool at Fast R-CNN's shape,
    warpctc at the ocr_ctc phase's: the card against the CPU (forward and
    generic gradient within OPS_RTOL of max(1, max |CPU|), the drawn
    SampleLabels equal), each gradient bit for bit over two card calls,
    each op's time (forward, forward + gradient) and warpctc's kernels a
    call, beside F.ctc_loss's time on the same inputs; then the
    detection host ops at SSD300's width."""
    import torch.nn.functional as F

    t0 = time.perf_counter()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    rec = {}
    for name, op, ins, attrs, slots in _working_cases():
        c_out, c_grad, fwd, both = _working_run(op, ins, attrs, slots, dev)
        _, c_grad2, _, _ = _working_run(op, ins, attrs, slots, dev)
        p_out, p_grad, _, _ = _working_run(op, ins, attrs, slots, "cpu")
        errs = {f"out.{s}": _op_err(c_out[s], p_out[s]) for s in p_out}
        errs.update({f"grad.{s}": _op_err(c_grad[s], p_grad[s])
                     for s in p_grad})
        worst = max(errs, key=errs.get)
        check(errs[worst] <= OPS_RTOL, f"ops_working {name}: {worst} card "
              f"against CPU {errs[worst]} > {OPS_RTOL}")
        same = all(torch.equal(c_grad[s], c_grad2[s]) for s in slots)
        check(same, f"ops_working {name}: two card gradients differ")
        r = {"errors": errs, "gradient_repeatable": same,
             "forward_ms": cold_ms(fwd, 5, flush),
             "forward_and_gradient_ms": cold_ms(both, 5, flush)}
        if op == "warpctc":
            r["kernels_per_call"] = _ctc_kernels(fwd, both)
            lv, lab = ins["Logits"], ins["Label"]
            logp = torch.from_numpy(lv[0]).to(dev).reshape(
                OCR_BATCH, -1, lv[0].shape[1]).transpose(0, 1).log_softmax(2)
            tgt = torch.from_numpy(lab[0].reshape(-1)).to(dev)
            tl = torch.full((OCR_BATCH,), logp.shape[0], dtype=torch.long,
                            device=dev)
            ll = torch.tensor(np.diff(lab[1][0]), device=dev)
            r["library_ms"] = cold_ms(lambda: F.ctc_loss(
                logp, tgt, tl, ll, blank=OCR_CLASSES, reduction="none"), 5,
                flush)
            r["library"] = "F.ctc_loss forward (cuDNN or native)"
        rec[name] = r
    rec["host_ops_ssd300"] = _host_ops_at_width(dev)
    emit({"phase": "ops_working", "card": card, "tolerance": OPS_RTOL,
          "rows": W_ROWS, "width": W_WIDTH, "classes": W_CLASSES,
          "negatives": W_NEG, "roi_x": list(W_ROI_X),
          "rois_per_image": W_ROIS, **rec,
          "timing": "cold_ms: CUDA events around a call after the L2 "
                    "was overwritten, median of 5 after a warm-up; host "
                    "ops: host clock, the card drained before and after, "
                    "median of 3",
          "seconds": time.perf_counter() - t0})


def readers_phase(card, place):
    """The reader chain at the ssd phase's image shape: random [3, 300,
    300] samples through shuffle(64) and batch(32), made by a startup
    program and read by main: on the card each batch on cuda:0 and equal
    to the CPU chain's bit for bit; the read's ms."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    def chain(where):
        main, startup = fluid.Program(), fluid.Program()
        sb, mb = startup.global_block(), main.global_block()
        for n in ("raw", "shuf", "batch"):
            sb.create_var(name=n, persistable=True)
            mb.create_var(name=n, persistable=True)
        out = mb.create_var(name="image", dtype="float32")
        sb.append_op("create_random_data_generator", {}, {"Out": ["raw"]},
                     {"shape_concat": [3, SSD_IMG, SSD_IMG], "ranks": [3],
                      "lod_levels": [0], "min": -1.0, "max": 1.0,
                      "seed": SEED})
        sb.append_op("create_shuffle_reader", {"UnderlyingReader": ["raw"]},
                     {"Out": ["shuf"]}, {"buffer_size": 64})
        sb.append_op("create_batch_reader", {"UnderlyingReader": ["shuf"]},
                     {"Out": ["batch"]}, {"batch_size": SSD_BATCH})
        mb.append_op("read", {"Reader": ["batch"]}, {"Out": [out.name]}, {})
        prev = executor_mod.switch_scope(Scope())
        try:
            exe = fluid.Executor(where)
            exe.run(startup)
            got, secs = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                got.append(exe.run(main, fetch_list=[out],
                                   return_numpy=False)[0])
                secs.append(time.perf_counter() - t0)
            return got, secs
        finally:
            executor_mod.switch_scope(prev)

    card_out, secs = chain(place)
    cpu_out, _ = chain(fluid.CPUPlace())
    for a, b in zip(card_out, cpu_out):
        check(a.device == torch.device("cuda", 0)
              and tuple(a.shape) == (SSD_BATCH, 3, SSD_IMG, SSD_IMG)
              and torch.equal(a.cpu(), b),
              f"readers: a batch on {a.device} {tuple(a.shape)} differs "
              "from the CPU chain's")
    emit({"phase": "readers", "card": card, "batches": len(card_out),
          "shape": list(card_out[0].shape), "device": str(card_out[0].device),
          "bit_equal_to_cpu": True, "read_ms": [x * 1e3 for x in secs],
          "timing": "host clock around exe.run (the shuffle buffer's 64 "
                    "draws fall in the first read)"})


# -- remat phase (A4b): rematerialised segments ------------------------------

_FLASH_KINDS = {"fwd": "fwd_kernel<", "dq": "dq_kernel<",
                "dkv": "dkv_kernel<"}


def _flash_counts():
    """The flash wrappers' counts, zeroed -> ({kind: reader})."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    launches = flash_attention.launches
    for key in launches:
        launches[key] = 0
    return {k: (lambda k=k: launches[k]) for k in launches}


class _GraphCensus:
    """While active, every CUDA graph made (`torch.cuda.CUDAGraph()`, as
    the Executor makes them) keeps its topology (`keep_graph`: the
    executable graph is made at the first replay, from the same
    topology), so its kernel nodes can be counted by name: a witness of
    what each replay launches that does not depend on the profiler.
    `kernels(kinds)` dumps the graphs made so far that are still live
    (cudaGraphDebugDotPrint's DOT, under TMPDIR, deleted after) ->
    ({kind: kernel nodes whose function's name holds `<kind>_kernel`},
    the kernel nodes in all)."""

    def __enter__(self):
        self.orig, self.graphs = torch.cuda.CUDAGraph, []

        def make(*args, **kwargs):
            graph = self.orig(*args, **{**kwargs, "keep_graph": True})
            graph.enable_debug_mode()
            self.graphs.append(graph)
            return graph

        torch.cuda.CUDAGraph = make
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph = self.orig

    def kernels(self, kinds):
        import re

        counts, total, dumped, head = {k: 0 for k in kinds}, 0, 0, ""
        node = re.compile(r'^\s*"(graph_\d+_node_\d+)"\s*\[(.*?)\];',
                          re.M | re.S)
        for graph in self.graphs:
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "graph.dot")
                graph.debug_dump(path)      # writes nothing once reset
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    text = f.read()
            dumped += 1
            head = head or text[:800]
            for _, label in node.findall(text):
                if "KERNEL" not in label.upper():
                    continue
                total += 1
                for k in kinds:
                    counts[k] += bool(re.search(rf"(?<![A-Za-z_]){k}_kernel",
                                                label))
        check(total > 0, f"the dumps of {dumped} of {len(self.graphs)} "
                         f"graphs show no kernel node: {head!r}")
        return counts, total


def _remat_pair(phase, place, build, feed_of, need, counts=None,
                want_plain=None, want_remat=None):
    """The Program `build(remat)` without and with remat: the plain
    build's default mode from its startup, then the remat build's from
    the same states, each also interpreted (bit for bit its replay) ->
    (plain record, remat record).  With `counts` (the flash wrappers')
    the launches are held on each build's eager run and capture, and
    the captured graph's flash kernel nodes (`_GraphCensus`: what every
    replay launches) against `want_*` too; the profiler's count of one
    replay is read, not held (`_default_mode_path`'s `gate_kinds`: it
    dropped one record of such a replay in whole runs)."""
    def one(label, remat, want, init=None):
        with _GraphCensus() as census:
            found = {}
            rec = _default_and_interpreter(
                label, place, *build(remat), feed_of, need, counts=counts,
                want=want, kinds=_FLASH_KINDS if counts else None,
                init=init, gate_kinds=False,
                after=(lambda exe: found.update(
                    zip(("kinds", "kernels"), census.kernels(want))))
                if counts else None)
        if counts:
            check(found["kinds"] == want, f"{label}: the captured graph "
                  f"holds flash kernels {found['kinds']}, want {want}")
            rec["graph_kernels"] = found
        return rec

    plain = one(f"{phase}_plain", False, want_plain)
    init = plain.pop("init")
    torch.cuda.empty_cache()
    remat = one(phase, True, want_remat, init)
    remat.pop("init")
    plain["init"] = init
    return plain, remat


def _remat_record(plain, remat):
    def one(r):
        step_s = float(np.median(r["k_secs"][2:]))
        g = r["graph"]
        return {"losses": r["k_loss"], "ms_per_step": step_s * 1e3,
                "step_s": r["k_secs"],
                "device_ms": r["profile"]["device_ms"],
                "device_idle_share":
                    1.0 - r["profile"]["device_ms"] / (step_s * 1e3),
                "kernels_per_step": r["profile"]["kernels"],
                "peak_memory_bytes": g["peak_memory_bytes"],
                "peak_over_base_bytes":
                    g["peak_memory_bytes"] - r["base_memory_bytes"],
                "peak_reserved_bytes": g["peak_reserved_bytes"],
                "replay_peak_memory_bytes": g["replay_peak_memory_bytes"],
                "capture_s": g["capture_s"], "cache": g["cache"],
                "graphs": g["graphs"],
                "by_group_ms": r["profile"]["by_group_ms"],
                "by_group_top_kernels":
                    r["profile"]["by_group_top_kernels"],
                "interpreted_ms_per_step":
                    float(np.median(r["i_secs"][1:])) * 1e3,
                "interpreter_bit_equal": True}

    p, r = one(plain), one(remat)
    groups = set(p["by_group_ms"]) | set(r["by_group_ms"])
    return {"plain": p, "remat": r,
            "device_ms_added_by_group": {
                g: r["by_group_ms"].get(g, 0.0) - p["by_group_ms"].get(g, 0.0)
                for g in sorted(groups)},
            "time_ratio": r["ms_per_step"] / p["ms_per_step"],
            "peak_saved_bytes": p["peak_over_base_bytes"]
            - r["peak_over_base_bytes"]}


def remat_phase(card, place):
    """Rematerialisation at full width: the train phase's LM (run_ridge,
    bf16 amp, Momentum) and run_image's ResNet-50 (pure bf16, Momentum),
    each without and with remat from the same states, G_STEPS steps in
    the Executor's default mode (the remat build also interpreted: bit
    for bit its replay).  Gates: each remat loss within one bf16 ulp of
    the plain build's; the LM's weight changes within 15 %; the LM's
    flash launches 2 forwards a layer (the forward and the segment
    gradient's re-run) and one dQ, one dK/dV (the wrapper's autograd)
    a step (12/12/12 without remat), by the wrappers on the eager run
    and the capture and by the captured graph's kernel nodes;
    ResNet-50's batch-norm running statistics carried out of the
    segments: after one interpreted step from the same states they
    equal the plain build's bit for bit (the same forward), after
    G_STEPS every one has moved, and their distance to the plain
    build's is recorded (pure-bf16 parameters round their updates, and
    the explicit and autograd batch-norm gradients round differently);
    then the same ResNet-50 in float64 (`_remat_stats_f64`), where the
    running statistics after G_STEPS are held to the plain build's at
    REMAT_STATS_F64_TOL -> the LM's flash counts."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    phase_t0 = time.perf_counter()
    out = {}
    # the LM under amp
    fluid.amp.enable_bf16()
    prev_scope = executor_mod.switch_scope(Scope())
    try:
        def lm(remat):
            built = _lm_program(fluid.Momentum(learning_rate=0.01,
                                               momentum=0.9), remat=remat)
            ops = built[0].global_block().ops
            check([op.type for op in ops].count("recompute")
                  == (T_LAYERS if remat else 0),
                  f"remat_lm: {remat} build has the wrong segments")
            return built

        counts = _flash_counts()
        n = T_LAYERS
        plain, remat = _remat_pair(
            "remat_lm", place, lm, _train_feed, ("flash_attention", "matmul"),
            counts, {"fwd": n, "dq": n, "dkv": n},
            {"fwd": 2 * n, "dq": n, "dkv": n})
        weights = [k for k, v in remat["k_state"].items()
                   if v.dim() == 2 and k in plain["k_state"]
                   and not k.endswith("_velocity_0")
                   and "velocity" not in k]
        rel = _param_rel_diff(lambda nm: plain["k_state"][nm],
                              plain["init"],
                              {nm: remat["k_state"][nm] for nm in weights})
        worst = max(rel, key=rel.get)
        diff, lim, unit = _loss_check("remat_lm", remat["k_loss"],
                                      plain["k_loss"], True)
        check(rel[worst] <= PARAM_RTOL_BF16, f"remat_lm: weight {worst} "
              f"moved {rel[worst]} apart with and without remat")
        lm_rec = _remat_record(plain, remat)
        lm_rec.update({"loss_diff": diff, "loss_limit": lim,
                       "loss_diff_unit": unit,
                       "weight_change_rel_diff": {
                           "max": rel[worst], "argmax": worst,
                           "n_weights": len(rel), "limit": PARAM_RTOL_BF16},
                       "flash_launches_per_step": {
                           "plain": plain["k_steps"][0],
                           "remat": remat["k_steps"][0]},
                       "flash_replayed_per_step":
                           remat["profile"]["kind_counts"],
                       "flash_graph_kernels": {
                           "plain": plain["graph_kernels"],
                           "remat": remat["graph_kernels"]}})
        out["lm"] = lm_rec
        flash = {"per_step": remat["k_steps"][0],
                 "replayed_per_step": remat["profile"]["kind_counts"],
                 "graph_per_step": remat["graph_kernels"]["kinds"]}
        del plain, remat
    finally:
        executor_mod.switch_scope(prev_scope)
        fluid.amp.disable_bf16()
        torch.cuda.empty_cache()

    # ResNet-50, pure bf16
    prev_scope = executor_mod.switch_scope(Scope())
    try:
        feed = _image_feed(R_BATCH, R_IMG, R_CLASSES, "bfloat16")

        programs = {}

        def rn(remat):
            built = _image_program(f"resnet{R_DEPTH}", R_IMG, R_CLASSES,
                                   "bfloat16", remat=remat)
            check([op.type for op in built[0].global_block().ops].count(
                "recompute") == (16 if remat else 0),
                f"remat_resnet50: {remat} build has the wrong segments")
            programs[remat] = built
            return built

        plain, remat = _remat_pair(
            "remat_resnet50", place, rn, lambda step: feed,
            ("conv_fwd", "conv_dgrad", "conv_wgrad", "pooling"))
        diff, lim, unit = _loss_check("remat_resnet50", remat["k_loss"],
                                      plain["k_loss"], True)
        stats = sorted(k for k in remat["k_state"]
                       if k.endswith(".mean_0") or k.endswith(".var_0")
                       or k.endswith("_mean") or k.endswith("_variance"))
        check(stats, "remat_resnet50: no running statistics found")
        first = {}
        scope = fluid.global_scope()
        for flag, (main, _, loss) in programs.items():
            for k in plain["init"]:
                scope.set_var(k, plain["init"][k].clone())
            exe = fluid.Executor(place, seed=SEED)
            exe.run(main, feed=feed, fetch_list=[loss], compiled=False)
            first[flag] = {k: scope.find_var(k).clone() for k in stats}
            exe.close()
        unequal = [k for k in stats if not torch.equal(first[True][k],
                                                       first[False][k])]
        check(not unequal, f"remat_resnet50: after one step {len(unequal)} "
              f"running statistics differ from the plain build's: "
              f"{unequal[:4]}")
        del first, programs
        worst, moved = 0.0, 0
        for k in stats:
            got, want = remat["k_state"][k].float(), plain["k_state"][k].float()
            m = max(1.0, float(want.abs().max()))
            worst = max(worst, float((got - want).abs().max()) / m)
            moved += bool((got != plain["init"][k].float()).any())
        check(moved == len(stats), f"remat_resnet50: only {moved} of "
              f"{len(stats)} running statistics moved")
        rn_rec = _remat_record(plain, remat)
        rn_rec.update({"loss_diff": diff, "loss_limit": lim,
                       "loss_diff_unit": unit,
                       "running_stats": {
                           "n": len(stats), "moved": moved,
                           "first_step_bit_equal": True,
                           "after_steps_max_diff_of_max_plain": worst}})
        out["resnet50"] = rn_rec
        del plain, remat
    finally:
        executor_mod.switch_scope(prev_scope)
        torch.cuda.empty_cache()
    out["resnet50"]["float64"] = _remat_stats_f64(place)
    emit({"phase": "remat", "card": card,
          "phase_s": time.perf_counter() - phase_t0,
          "lm": {"source": "benchmark/run_ridge.py:136-143 (vocab 30000, "
                           "d 2048, 16 heads, 12 layers, seq 512, batch 8, "
                           "bf16 amp, Momentum)", **out["lm"]},
          "resnet50": {"source": "benchmark/run_image.py:42-66 (224, "
                                 "batch 128, bf16, Momentum)",
                       **out["resnet50"]},
          "timing": "host clock around exe.run + synchronize, the median "
                    "of the replayed steps (3..N); peak_over_base_bytes "
                    "the allocated peak over the default mode's steps (its "
                    "eager run, its capture and replays) less what was "
                    "allocated before them; device time from one profiled "
                    "replay"})
    return flash


# float64 ResNet-50, remat against plain after G_STEPS: the running
# statistics' largest distance over max(1, |plain|).  The two builds
# differ only in how their gradients round (autograd against the
# explicit batch-norm gradient), and these steps (one batch again and
# again from random weights) amplify a difference by orders of
# magnitude a step, so in bf16 and float32 the statistics part by
# rounding; a wrong gradient or a statistic written twice would show
# in float64 too
REMAT_STATS_F64_TOL = 1e-6
# the float64 pair's default-mode steps (the eager run, the capture, a
# replay)
REMAT_F64_STEPS = 3


def _remat_stats_f64(place):
    """run_image's ResNet-50 (224, batch 128, Momentum) in float64,
    without and with remat from the same states, G_STEPS default-mode
    steps each (the eager run, the capture, replays) -> the losses, the
    ms of a replayed step, and the running statistics' largest distance
    to the plain build's over max(1, |plain|), held at
    REMAT_STATS_F64_TOL; every statistic must have moved."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    feed = _image_feed(R_BATCH, R_IMG, R_CLASSES, "float32")
    feed["img"] = feed["img"].double()
    runs, init = {}, None
    for remat in (False, True):
        prev = executor_mod.switch_scope(Scope())
        exe = None
        try:
            main, startup, loss = _image_program(
                f"resnet{R_DEPTH}", R_IMG, R_CLASSES, "float64",
                remat=remat)
            persist = _persistables(main)
            scope = fluid.global_scope()
            exe = fluid.Executor(place, seed=SEED)
            if init is None:
                exe.run(startup)
                init = {n: scope.find_var(n).clone() for n in persist}
            else:
                for n in persist:
                    scope.set_var(n, init[n].clone())
            losses, secs = [], []
            for _ in range(REMAT_F64_STEPS):
                t0 = time.perf_counter()
                losses.append(float(np.asarray(exe.run(
                    main, feed=feed, fetch_list=[loss])[0]).reshape(-1)[0]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            check(exe.graph_stats()["captures"] == 1,
                  f"remat_resnet50_f64: {exe.graph_stats()}")
            stats = sorted(n for n in persist
                           if n.endswith(".mean_0") or n.endswith(".var_0")
                           or n.endswith("_mean")
                           or n.endswith("_variance"))
            runs[remat] = {"losses": losses,
                           "ms_per_step": float(np.median(secs[2:])) * 1e3,
                           "stats": {n: scope.find_var(n).clone()
                                     for n in stats}}
        finally:
            if exe is not None:
                exe.close()
            executor_mod.switch_scope(prev)
            torch.cuda.empty_cache()
    plain, remat = runs[False], runs[True]
    check(plain["stats"] and set(plain["stats"]) == set(remat["stats"]),
          "remat_resnet50_f64: the builds' running statistics differ in "
          "name")
    worst, argmax, moved = 0.0, None, 0
    for n, want in plain["stats"].items():
        got = remat["stats"][n]
        d = float((got - want).abs().max()) / max(1.0,
                                                  float(want.abs().max()))
        if d >= worst:
            worst, argmax = d, n
        moved += bool((got != init[n]).any())
    check(moved == len(plain["stats"]), f"remat_resnet50_f64: only {moved} "
          f"of {len(plain['stats'])} running statistics moved")
    check(worst <= REMAT_STATS_F64_TOL, f"remat_resnet50_f64: running "
          f"statistic {argmax} lies {worst} of max(1, |plain|) from the "
          f"plain build's, limit {REMAT_STATS_F64_TOL}")
    return {"losses": {"plain": plain["losses"], "remat": remat["losses"]},
            "ms_per_step": {"plain": plain["ms_per_step"],
                            "remat": remat["ms_per_step"]},
            "running_stats": {"n": len(plain["stats"]), "moved": moved,
                              "after_steps_max_diff_of_max_plain": worst,
                              "argmax": argmax,
                              "limit": REMAT_STATS_F64_TOL}}


# -- memory_plan phase (A4b): the compiled mode's frees, the flag ------------

def _replay_peak(place, build, feed_of, steps=4):
    """`build()` -> (main, startup, loss): its startup, then `steps`
    default-mode steps (the eager miss, the capture, replays) -> the
    allocated peak over them less what the states held before, the
    reserved peak, and the median replayed step's ms."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    prev = executor_mod.switch_scope(Scope())
    exe = None
    try:
        main, startup, loss = build()
        exe = fluid.Executor(place, seed=SEED)
        exe.run(startup)
        torch.cuda.synchronize()
        _reset_peak()
        base = torch.cuda.memory_allocated()
        secs = []
        for step in range(steps):
            t0 = time.perf_counter()
            exe.run(main, feed=feed_of(step), fetch_list=[loss])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        check(exe.graph_stats()["captures"] == 1,
              f"memory_plan: {exe.graph_stats()}")
        return {"peak_over_base_bytes":
                    torch.cuda.max_memory_allocated() - base,
                "base_bytes": base,
                "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
                "ms_per_replay": float(np.median(secs[2:])) * 1e3}
    finally:
        if exe is not None:
            exe.close()
        executor_mod.switch_scope(prev)
        torch.cuda.empty_cache()


def memory_plan_steps(place):
    """The replayed train (amp), seq2seq (amp) and resnet50 steps'
    peaks (`_replay_peak`), the package's frees as they stand."""
    import paddle_tpu_torch as fluid

    out = {}
    fluid.amp.enable_bf16()
    try:
        out["train"] = _replay_peak(place, lambda: _lm_program(
            fluid.Momentum(learning_rate=0.01, momentum=0.9)), _train_feed)
        feed = _s2s_feed()
        out["seq2seq"] = _replay_peak(place, _s2s_program,
                                      lambda step: feed)
    finally:
        fluid.amp.disable_bf16()
    feed = _image_feed(R_BATCH, R_IMG, R_CLASSES, "bfloat16")
    out["resnet50"] = _replay_peak(place, lambda: _image_program(
        f"resnet{R_DEPTH}", R_IMG, R_CLASSES, "bfloat16"),
        lambda step: feed)
    return out


def memory_plan_phase(card, place):
    """The compiled mode drops each value after its last reader (inside
    a CUDA-graph capture too): the replayed steps' peaks as they stand
    (`memory_plan_steps`; the same steps with the frees taken out are
    `tools/torch_tree_probe.py memory-plan`).  Then the `memory_optimize`
    flag on the interpreted ResNet-50: 2 steps with it off and on from
    the same states, peak memory and ms a step, the parameters, velocities
    and running statistics bit-equal."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.core.scope import Scope

    phase_t0 = time.perf_counter()
    steps = memory_plan_steps(place)
    main, startup, loss = _image_program(f"resnet{R_DEPTH}", R_IMG,
                                         R_CLASSES, "bfloat16")
    feed = _image_feed(R_BATCH, R_IMG, R_CLASSES, "bfloat16")
    persist = _persistables(main)
    prev = executor_mod.switch_scope(Scope())
    runs = {}
    try:
        scope = fluid.global_scope()
        exe = fluid.Executor(place, seed=SEED)
        exe.run(startup)
        init = {n: scope.find_var(n).clone() for n in persist}
        exe.close()
        for flag in (False, True):
            set_flags({"memory_optimize": flag})
            for n in persist:
                scope.set_var(n, init[n].clone())
            exe = fluid.Executor(place, seed=SEED)
            _reset_peak()
            base = torch.cuda.memory_allocated()
            losses, secs = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                losses.append(float(exe.run(main, feed=feed,
                                            fetch_list=[loss],
                                            compiled=False)[0].reshape(-1)[0]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            runs[flag] = {"losses": losses, "step_s": secs,
                          "ms_per_step": secs[-1] * 1e3,
                          "peak_over_base_bytes":
                              torch.cuda.max_memory_allocated() - base,
                          "state": {n: scope.find_var(n).clone()
                                    for n in persist}}
            exe.close()
    finally:
        set_flags({"memory_optimize": False})
        executor_mod.switch_scope(prev)
        torch.cuda.empty_cache()
    off, on = runs[False], runs[True]
    check(off["losses"] == on["losses"], f"memory_plan: losses with the "
          f"flag {on['losses']} differ from without it {off['losses']}")
    diff = [n for n in persist if not torch.equal(off["state"][n],
                                                  on["state"][n])]
    check(not diff, f"memory_plan: {len(diff)} states differ with the "
          f"memory_optimize flag: {diff[:5]}")
    for r in runs.values():
        r.pop("state")
    emit({"phase": "memory_plan", "card": card,
          "phase_s": time.perf_counter() - phase_t0,
          "replayed_steps_with_frees": steps,
          "interpreted_resnet50": {
              "source": "benchmark/run_image.py:42-66 (224, batch 128, "
                        "bf16, Momentum), interpreted, 2 steps",
              "memory_optimize_off": off, "memory_optimize_on": on,
              "states_bit_equal": True, "n_states": len(persist)},
          "timing": "peak_over_base_bytes: the allocated peak over the "
                    "steps less what the states held before them; the "
                    "replayed steps' ms the median of steps 3..4; the "
                    "interpreted ms the second step's"})
    return steps


# -- analysis phase (A12): the verifier, the cost model, the lint -----------

# the train LM's config for `cli verify` / `cli analyze` (the train phase's
# Program: run_ridge's LM under bf16 amp, built in build())
_ANALYSIS_CONFIG = """
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models.transformer import transformer_lm


def build():
    fluid.amp.enable_bf16()
    try:
        ids = fluid.layers.data(name="ids", shape=[{seq}], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[{seq}, 1], dtype="int64")
        logits = transformer_lm(ids, {vocab}, d_model={d}, n_heads={h},
                                n_layers={layers}, max_len={max_len},
                                return_logits=True)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, {vocab}]),
            fluid.layers.reshape(lbl, shape=[-1, 1])))
        fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    finally:
        fluid.amp.disable_bf16()
    return {{"loss": loss}}
"""


def _analysis_programs():
    """Every main-path Program the earlier phases build, at full width
    and under the flags they build it with -> {name: (main, batch, feed
    names or None, fetch names)}; batch None where the phase's steps
    are not costed."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw

    out = {}
    fluid.amp.enable_bf16()
    try:
        main, _, loss = _lm_program(fluid.Momentum(learning_rate=0.01,
                                                   momentum=0.9))
        out["train"] = (main, T_BATCH, ["ids", "lbl"], [loss.name])
        main, _, loss = _s2s_program()
        out["seq2seq"] = (main, S_BATCH, None, [loss.name])
    finally:
        fluid.amp.disable_bf16()
    main, _, loss = _image_program(f"resnet{R_DEPTH}", R_IMG, R_CLASSES,
                                   "bfloat16")
    out["resnet50"] = (main, R_BATCH, ["img", "label"], [loss.name])
    main, _, loss = _mt_program("train")
    out["book08_dynamic_rnn"] = (main, None, None, [loss.name])
    main, _, (ids, scores) = _mt_program("decode")
    out["book08_while_decoder"] = (main, None, None, [ids.name,
                                                      scores.name])
    main, _, loss = _ctr_program(
        "deepfm", True, lambda f: f.Adam(learning_rate=X_LR))
    out["deepfm_sparse"] = (main, None, None, [loss.name])
    main, _, loss, decode, nmsed, m_ap = _ssd_program(fluid, fw)
    out["ssd300"] = (main, None, None, [loss.name])
    out["ssd300_decode"] = (decode, None, None, [nmsed.name])
    main, _, loss, decode, decoded, dist = _crnn_program(fluid, fw)
    out["crnn_ctc"] = (main, None, None, [loss.name])
    out["crnn_ctc_decode"] = (decode, None, None, [decoded.name])
    return out


def analysis_phase(card, plan_steps, paged_case, bw):
    """The analysis package over the main path, no training step of its
    own: (a) `Program.verify(level="error")` over every main-path
    Program at full width, zero error diagnostics; (b) the cost model's
    static FLOPs of the train LM (amp, batch 8), seq2seq (batch 32) and
    ResNet-50 (batch 128) steps within [0.5, 2.5]x of `_model_flops`, and
    their static bytes and roofline seconds on the card's chip-table row
    beside the replayed step ms their phases measured (the calibration
    ratio), the static peak beside memory_plan's replayed peaks; (c)
    `analyze_generation_spec` on the serve phase's spec resolving the
    decode backend the decoder chose ("cuda"), and the paged kernel
    row's bytes-bound beside the kernels phase's bound; (d) `cli verify
    --json` and `cli analyze --json` over the train LM's config and `cli
    concurrency --sched` over paddle_tpu_torch/, as subprocesses (started
    first, running beside (a)-(c)), the last one's exit code 0."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.analysis import cost_model as cm

    phase_t0 = time.perf_counter()
    device = cm.device_for_card(card["name"])
    root = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = os.path.join(root, "train_lm.py")
    with open(cfg, "w") as f:
        f.write(_ANALYSIS_CONFIG.format(
            seq=T_SEQ, vocab=T_VOCAB, d=T_D, h=T_HEADS, layers=T_LAYERS,
            max_len=max(T_SEQ, 2048)))
    cli = [sys.executable, "-m", "paddle_tpu_torch.cli"]
    procs = {name: subprocess.Popen(cli + argv, cwd=here, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
             for name, argv in (
                 ("verify", ["verify", cfg, "--json"]),
                 ("analyze", ["analyze", cfg, "--json", "--batch",
                              str(T_BATCH), "--device", device]),
                 ("concurrency", ["concurrency", "--sched"]))}
    try:
        t0 = time.perf_counter()
        programs = _analysis_programs()
        build_s = time.perf_counter() - t0
        verified = {}
        for name, (main, batch, feeds, fetches) in programs.items():
            t0 = time.perf_counter()
            diags = main.verify(level="error", feed_names=feeds,
                                fetch_names=fetches)
            counts = {}
            for d in diags:
                counts[d.severity] = counts.get(d.severity, 0) + 1
            verified[name] = {"ops": sum(len(b.ops) for b in main.blocks),
                              "blocks": len(main.blocks),
                              "verify_s": time.perf_counter() - t0,
                              "diagnostics": counts}
        costed = {}
        for name in ("train", "seq2seq", "resnet50"):
            main, batch, feeds, fetches = programs[name]
            est = analysis.estimate_program(main, batch_size=batch,
                                            feed_names=feeds,
                                            fetch_names=fetches,
                                            device=device)
            model = _model_flops(main, batch)
            ratio = est.total_flops / model
            check(0.5 <= ratio <= 2.5, f"analysis: {name}'s static FLOPs "
                  f"{est.total_flops} are {ratio}x chip_smoke's model "
                  f"FLOPs {model}, outside [0.5, 2.5]")
            roof_s = cm.roofline_seconds(est.total_flops, est.total_bytes,
                                         device)
            step_ms = STEP_MS[name]
            plan = plan_steps[name]
            measured_peak = plan["base_bytes"] + plan["peak_over_base_bytes"]
            peak = est.peak_hbm["peak_bytes"]
            costed[name] = {
                "batch": batch, "static_flops": est.total_flops,
                "model_flops": model, "flops_ratio": ratio,
                "flops_band": [0.5, 2.5],
                "static_bytes": est.total_bytes,
                "unknown_ops": sum(est.unknown_types.values()),
                "roofline_ms": roof_s * 1e3,
                "bound": est.roofline().get("bound"),
                "measured_step_ms": step_ms,
                "calibration_ratio": step_ms / (roof_s * 1e3),
                "static_peak_bytes": peak,
                "replayed_peak_bytes": measured_peak,
                "peak_ratio": peak / measured_peak,
                "peak_band": [0.3, 3.0]}
        rep = analysis.analyze_generation_spec(SERVE["spec"],
                                               device=device)
        backend = rep["kernels"][0]["backend"]
        check(backend == "cuda" == SERVE["decode_kernel"],
              f"analysis: the decode backend resolves {backend!r}, the "
              f"serve phase's decoder ran {SERVE['decode_kernel']!r}")
        ctx = BLOCK * MAX_BLOCKS
        row = cm.serving_kernel_cost(
            "paged_attention_decode", dict(SERVE["spec"], n_layers=1),
            slots=SLOTS, context=ctx // 2, kv_dtype="fp32", window=1)
        lint_t0 = time.perf_counter()
        cli_out = {}
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            cli_out[name] = {"rc": proc.returncode, "stdout": out,
                             "stderr": err[-2000:]}
        cli_wait_s = time.perf_counter() - lint_t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    errors = {n: v["diagnostics"].get("error", 0)
              for n, v in verified.items()}
    check(not any(errors.values()), f"analysis: error diagnostics {errors}")
    conc = cli_out["concurrency"]
    check(conc["rc"] == 0, f"analysis: cli concurrency --sched exited "
          f"{conc['rc']}: {conc['stdout'][-2000:]} {conc['stderr']}")
    summary = {}
    for name in ("verify", "analyze"):
        r = cli_out[name]
        check(r["rc"] == 0, f"analysis: cli {name} exited {r['rc']}: "
              f"{r['stdout'][-2000:]} {r['stderr']}")
        doc = json.loads(r["stdout"])
        if name == "verify":
            summary[name] = {"rc": r["rc"], "failed": doc["failed"],
                             "programs": [
                                 {"label": p["label"], "status": p["status"],
                                  "n_diagnostics": len(p["diagnostics"])}
                                 for p in doc["programs"]]}
        else:
            summary[name] = {"rc": r["rc"], "programs": [
                {"label": p["label"], **{k: p["roofline"].get(k) for k in (
                    "device", "batch_size", "est_flops",
                    "est_hbm_traffic_gb", "est_peak_hbm_gb", "bound",
                    "unknown_ops")}} for p in doc["programs"]]}
    summary["concurrency"] = {"rc": conc["rc"],
                              "tail": conc["stdout"].strip().splitlines()[-6:]}
    emit({"phase": "analysis", "card": card, "device_row": device,
          "device_spec": {"bf16_flops": cm.DEVICE_SPECS[device][0],
                          "hbm_bytes_per_s": cm.DEVICE_SPECS[device][1]},
          "build_s": build_s, "verified": verified, "costed": costed,
          "decode": {"backend": backend,
                     "decoder": SERVE["decode_kernel"],
                     "rows": [{k: r.get(k) for k in (
                         "kernel", "backend", "flops", "bytes")}
                         for r in rep["kernels"]]},
          "paged_kernel_row": {
              "geometry": f"{SLOTS} slots of context {ctx} (the row at "
                          f"{ctx // 2}, analyze_generation_spec's mean "
                          "fill), fp32, W=1, one layer",
              "bytes": row["bytes"],
              "bytes_bound_ms": row["bytes"] / bw * 1e3,
              "kernels_phase_bound_ms": paged_case["bound_ms"],
              "kernels_phase_ms": paged_case["ms"]},
          "cli": summary, "cli_wait_s": cli_wait_s,
          "phase_s": time.perf_counter() - phase_t0,
          "timing": "verify_s: Program.verify(level='error') on the host; "
                    "measured_step_ms: the train, seq2seq and resnet50 "
                    "phases' median replayed step; replayed_peak_bytes: "
                    "memory_plan's base + peak over base; the CLI "
                    "subprocesses run beside the builds and verifications "
                    "(cli_wait_s: the wait for them after)"})


# -- generate phase (A6): the generation builders ----------------------------

def _gen_states(shapes, seed):
    """Seeded float32 parameters that make the next-token choice
    decisive: variance-keeping weights (N(0, 1/fan_in)), unit
    embeddings, layer-norm scales 1 and biases 0, so the logits spread
    about 1 (the startup's 0.02-scale tables give near-uniform
    softmaxes, whose argmax a reordered sum flips)."""
    rng = np.random.RandomState(seed)
    out = {}
    names = sorted(shapes)
    for n in names:
        shape = shapes[n]
        if "layer_norm" in n:
            v = np.ones(shape) if n.endswith(".w_0") else np.zeros(shape)
        elif len(shape) == 2 and shape[0] == GEN_VOCAB or "embedding" in n:
            v = rng.normal(0.0, 1.0, shape)
        elif len(shape) == 2:
            v = rng.normal(0.0, 1.0 / np.sqrt(shape[0]), shape)
        else:
            v = rng.normal(0.0, 0.02, shape)
        out[n] = v.astype(np.float32)
    return out


def _sync_calls(fn):
    """`fn()` under torch's sync debug mode -> (its result, how many
    synchronising calls it made: cudaStreamSynchronize, a device-to-host
    read, a .item())."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # each synchronising call warns "called a synchronizing CUDA
    # operation"; setting the mode warns once that it is a prototype
    return res, sum("called a synchronizing" in str(w.message)
                    for w in caught)


def _decode_timed(fn, tokens, warm):
    """`fn()` once warm (after `warm()`, a short decode of the same
    shapes: the forward's graph is captured at its second call, the kv
    step's at the first) -> (result, ms, ms a token, host syncs)."""
    warm()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res, syncs = _sync_calls(fn)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    return res, ms, ms / tokens, syncs


def _kernels_per_call(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total)


def _gen_verdict(got, want, probs):
    """Card ids `got` against the CPU's `want` [B, L]: equal, or each
    differing row's first differing position a near tie of the CPU's
    own distribution there (top-2 gap within GEN_TIE_RTOL of the top)
    -> (ok, the differing rows' (row, position, gap))."""
    got, want = np.asarray(got), np.asarray(want)
    rows = []
    for b in np.flatnonzero((got != want).any(axis=1)):
        t = int(np.flatnonzero(got[b] != want[b])[0])
        p = np.sort(probs[b, t - 1])[::-1]
        rows.append((int(b), t, float((p[0] - p[1]) / p[0])))
    return all(g <= GEN_TIE_RTOL for _, _, g in rows), rows


def generate_phase(card, place):
    """run_generation's three decoders at its defaults (full_forward:
    the fixed-width LM re-run a token, its forward one replayed CUDA
    graph; kv_cache: dense K/V caches, one captured step replayed a
    position; beam_search_k4), timed once warm: tokens/s, ms and
    kernels a token, host syncs a token (torch's sync debug mode;
    gated at zero).  kv_cache's greedy ids equal full_forward's; at 2
    layers and 64 steps the card's full_forward and kv_cache ids equal
    the CPU's kv_cache ids but at the CPU's near ties; then the
    translate generator at run_seq2seq's widths, 127 steps."""
    from paddle_tpu_torch import CPUPlace
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.models import transformer as tr

    phase_t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(SEED)
    prompt = torch.as_tensor(rng.randint(0, GEN_VOCAB,
                                         (GEN_BATCH, GEN_PROMPT)),
                             device=dev)
    kw = dict(d_model=GEN_D, n_heads=GEN_HEADS, n_layers=GEN_LAYERS)
    fw.reset_unique_names()
    _, full = tr.build_lm_generator(GEN_VOCAB, GEN_CTX, place=place, **kw)
    fw.reset_unique_names()
    _, kv = tr.build_lm_kv_decoder(GEN_VOCAB, GEN_CTX, place=place, **kw)
    fw.reset_unique_names()
    _, beam = tr.build_lm_beam_search(GEN_VOCAB, GEN_CTX,
                                      beam_size=GEN_BEAM, place=place, **kw)
    states = {n: torch.as_tensor(v, device=dev) for n, v in
              _gen_states(kv.state_shapes, SEED).items()}
    rows = {}
    runs = (("full_forward", lambda: full(states, prompt, GEN_STEPS),
             GEN_STEPS),
            ("kv_cache", lambda: kv(states, prompt, GEN_STEPS), GEN_STEPS),
            (f"beam_search_k{GEN_BEAM}",
             lambda: beam(states, prompt, GEN_BEAM_STEPS), GEN_BEAM_STEPS))
    ids = {}
    for name, fn, steps in runs:
        short = {"full_forward": lambda n: full(states, prompt, n),
                 "kv_cache": lambda n: kv(states, prompt, n)}.get(
            name, lambda n: beam(states, prompt, n))
        res, ms, ms_tok, syncs = _decode_timed(fn, steps, lambda: short(2))
        ids[name] = res[0] if isinstance(res, tuple) else res
        check(syncs == 0, f"generate {name}: {syncs} host syncs in "
              f"{steps} steps")
        k8 = _kernels_per_call(lambda: short(8))
        rows[name] = {"steps": steps, "ms": ms, "ms_per_token": ms_tok,
                      "tokens_per_s": GEN_BATCH * steps / (ms / 1e3),
                      "host_syncs_per_token": syncs / steps,
                      "kernels_per_token_8_steps": k8 / 8}
    if torch.equal(ids["kv_cache"], ids["full_forward"]):
        kv_diff = []
    else:
        probs = full.forward({"gen_ids": ids["full_forward"]}, states)[0]
        ok, kv_diff = _gen_verdict(ids["kv_cache"].cpu(),
                                      ids["full_forward"].cpu(),
                                      next(iter(probs.values())).cpu()
                                      .numpy())
        check(ok, f"generate: kv_cache's greedy ids differ from "
              f"full_forward's beyond near ties: {kv_diff}")
    rows["full_forward"]["graph"] = dict(full.forward.stats)
    rows[f"beam_search_k{GEN_BEAM}"]["graph"] = dict(beam.forward.stats)
    rows["kv_cache"]["graphs"] = len(kv.graphs)
    rows["kv_cache_vs_full_forward"] = {"equal": not kv_diff,
                                        "near_tie_rows": kv_diff}
    del full, kv, beam, ids
    torch.cuda.empty_cache()

    # card vs CPU at a cut depth
    cut = dict(kw, n_layers=GEN_CPU_LAYERS)
    built = {}
    for name, builder, where in (
            ("full_card", tr.build_lm_generator, place),
            ("kv_card", tr.build_lm_kv_decoder, place),
            ("kv_cpu", tr.build_lm_kv_decoder, CPUPlace()),
            ("full_cpu", tr.build_lm_generator, CPUPlace())):
        fw.reset_unique_names()
        built[name] = builder(GEN_VOCAB, GEN_CTX, place=where, **cut)[1]
    cpu_states = _gen_states(built["kv_cpu"].state_shapes, SEED + 1)
    card_states = {n: torch.as_tensor(v, device=dev)
                   for n, v in cpu_states.items()}
    t0 = time.perf_counter()
    want = built["kv_cpu"](cpu_states, prompt.cpu(), GEN_CPU_STEPS)
    cpu_s = time.perf_counter() - t0
    probs = None
    verdicts = {}
    for name in ("full_card", "kv_card"):
        got = built[name](card_states, prompt, GEN_CPU_STEPS).cpu()
        if not torch.equal(got, want) and probs is None:
            probs = built["full_cpu"].forward(
                {"gen_ids": want}, {n: torch.as_tensor(v) for n, v in
                                    cpu_states.items()})[0]
            probs = next(iter(probs.values())).numpy()
        ok, diff = ((True, []) if torch.equal(got, want)
                    else _gen_verdict(got, want, probs))
        check(ok, f"generate card vs CPU: {name} differs from the CPU "
              f"beyond near ties: {diff}")
        verdicts[name] = {"equal": not diff, "near_tie_rows": diff}
    del built
    torch.cuda.empty_cache()

    # the translate generator at run_seq2seq's transformer
    fw.reset_unique_names()
    _, translate = tr.build_translate_generator(
        S_VOCAB, S_VOCAB, S_LEN, S_LEN, d_model=S_D, n_heads=S_HEADS,
        n_layers=S_LAYERS, place=place)
    shapes = {}
    for n in translate.state_names:
        v = translate.forward.program.global_block().var(n)
        shapes[n] = tuple(int(d) for d in v.shape)
    t_states = {n: torch.as_tensor(v, device=dev) for n, v in
                _gen_states(shapes, SEED + 2).items()}
    src = torch.as_tensor(rng.randint(2, S_VOCAB, (S_BATCH, S_LEN)),
                          device=dev)
    tgt, ms, ms_tok, syncs = _decode_timed(
        lambda: translate(t_states, src, S_LEN - 1), S_LEN - 1,
        lambda: translate(t_states, src, 2))
    check(syncs == 0, f"generate translate: {syncs} host syncs")
    check(bool((tgt[:, 0] == 0).all()) and tgt.shape == (S_BATCH, S_LEN),
          "generate translate: bad output")
    rows["translate"] = {"steps": S_LEN - 1, "ms": ms,
                         "ms_per_token": ms_tok,
                         "tokens_per_s": S_BATCH * (S_LEN - 1) / (ms / 1e3),
                         "host_syncs_per_token": syncs / (S_LEN - 1),
                         "graph": dict(translate.forward.stats)}
    del translate, t_states
    torch.cuda.empty_cache()
    emit({"phase": "generate", "card": card,
          "phase_s": time.perf_counter() - phase_t0,
          "source": "benchmark/run_generation.py:22-33 defaults (vocab "
                    "32000, ctx 512, prompt 16, d 512, 6 layers, 8 heads, "
                    "batch 8, beam 4, float32); translate: "
                    "benchmark/run_seq2seq.py:39-60 (d 512, 8 heads, 6 + 6 "
                    "layers, vocab 30000, lengths 128, batch 32), float32",
          "decoders": rows,
          "card_vs_cpu": {"layers": GEN_CPU_LAYERS, "steps": GEN_CPU_STEPS,
                          "cpu_kv_s": cpu_s, **verdicts},
          "timing": "CUDA events around one warm call (its ids on the "
                    "card); host syncs counted by torch's sync debug mode "
                    "over that call; kernels a token from torch.profiler "
                    "over an 8-step call"})
    return rows


# -- image_serve phase (A6): InferenceServer ---------------------------------

def image_serve_phase(card, place):
    """benchmark/run_image.py:154-204's serve_one for ResNet-50 (bf16):
    an InferenceServer over the pruned inference Program, buckets (1, 2,
    4, 8, 16) captured at construction, window 0.3 ms; 30 single-stream
    requests, then 256 concurrent ones.  The served value is the
    classifier's logits (the softmax's input: at random init with unit
    running variances the softmax saturates to one class for every
    image, which would hide a result delivered to the wrong request).
    Every result is held to the Executor's run of the same image (the
    default mode, batch 1) within SRV_ULPS bf16 ulps of max|reference|
    a row, and that reference is the nearest of all the images' to it
    in the L2 norm (a result delivered to the wrong request is nearer
    another's: the random network's logits differ between images by a
    few ulps in their largest entries, but in every entry, where
    rounding flips touch a few); no capture happens after
    construction."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.io import prune
    from paddle_tpu_torch.serving import InferenceServer

    phase_t0 = time.perf_counter()
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, R_IMG, R_IMG],
                                dtype="bfloat16")
        probs = fluid.models.resnet_imagenet(img, class_dim=R_CLASSES,
                                             depth=R_DEPTH)
    soft, = [op for op in main.global_block().ops
             if op.type == "softmax" and op.output("Out") == [probs.name]]
    predict = main.global_block().var(soft.input("X")[0])
    infer = prune(main, [predict], for_test=True)
    scope = Scope()
    exe = fluid.Executor(place, seed=SEED)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    pool = [torch.from_numpy(rng.rand(1, 3, R_IMG, R_IMG).astype(
        np.float32)).to(torch.bfloat16)
        for _ in range(3 + SRV_SINGLE + SRV_CONCURRENT)]
    warm, single = pool[:3], pool[3:3 + SRV_SINGLE]
    reqs = pool[3 + SRV_SINGLE:]
    t0 = time.perf_counter()
    srv = InferenceServer(infer, "img", predict, scope, place=place,
                          buckets=SRV_BUCKETS, window_ms=SRV_WINDOW_MS)
    build_s = time.perf_counter() - t0
    try:
        built = srv.graph_stats()
        for q in warm:
            srv.submit(q).result(timeout=120)
        t0 = time.perf_counter()
        single_out = [srv.submit(q).result(timeout=120) for q in single]
        single_ms = (time.perf_counter() - t0) / SRV_SINGLE * 1e3
        d0 = srv.stats()["dispatches"]
        t0 = time.perf_counter()
        futs = [srv.submit(q) for q in reqs]
        conc_out = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        stats = srv.stats()
        after = srv.graph_stats()
    finally:
        srv.close()
    check(after["captures"] == built["captures"] == len(SRV_BUCKETS)
          and after["eager_runs"] == built["eager_runs"],
          f"image_serve: graphs {built} at construction, {after} after")
    wants = [exe.run(infer, feed={"img": q}, fetch_list=[predict],
                     scope=scope)[0] for q in single + reqs]
    exe.close()
    refs = np.concatenate(wants).astype(np.float64)
    worst, cross, misplaced = 0.0, np.inf, 0
    for i, got in enumerate(single_out + conc_out):
        diff = refs - np.asarray(got, np.float64)
        top = float(np.abs(refs[i]).max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        worst = max(worst, float(np.abs(diff[i]).max()) / ulp)
        l2 = np.sqrt((diff * diff).sum(axis=1))
        cross = min(cross, float(np.delete(l2, i).min() / max(l2[i], ulp)))
        misplaced += int(np.argmin(l2) != i)
    check(worst <= SRV_ULPS, f"image_serve: a result is {worst} bf16 ulps "
          f"of max|reference| from the Executor's (limit {SRV_ULPS})")
    check(not misplaced, f"image_serve: {misplaced} results are nearer "
          "another image's reference than their own")
    dispatches = stats["dispatches"] - d0
    emit({"phase": "image_serve", "card": card,
          "phase_s": time.perf_counter() - phase_t0,
          "source": "benchmark/run_image.py:154-204 serve_one (resnet50, "
                    "224, bf16, buckets (1, 2, 4, 8, 16), window 0.3 ms, "
                    "30 single-stream and 256 concurrent requests)",
          "construction_s": build_s, "graphs_at_construction": built,
          "graphs_after": after,
          "single_stream_ms": single_ms,
          "requests_per_s": SRV_CONCURRENT / wall,
          "concurrent_wall_s": wall, "dispatches": dispatches,
          "mean_batch": SRV_CONCURRENT / dispatches, "stats": stats,
          "max_err_bf16_ulps": worst, "limit_bf16_ulps": SRV_ULPS,
          "min_l2_to_another_over_l2_to_own": cross,
          "nearest_reference_is_own": True,
          "timing": "host clock: single-stream the mean of 30 submit -> "
                    "result round trips; requests_per_s 256 requests "
                    "submitted at once until the last result"})



# -- the DCGAN (conv_rest phase) ---------------------------------------------

def _dcgan_programs(fluid, fw, z_dim=DC_Z, img=DC_IMG, g_widths=DC_G_WIDTHS,
                    d_widths=DC_D_WIDTHS, dtype="float32"):
    """DCGAN's G and D as Paddle's fluid GAN demo builds them, in either
    package (`fluid`): D's program (a real and a fake batch, one Adam
    step over D's parameters), G + D's program (one Adam step over G's)
    and G alone (its clone before D), on one startup, the two nets'
    parameters shared by name -> (startup, d_prog, dg_prog, g_prog,
    d_loss, dg_loss, g_img).  A layer that batch norm follows has no
    bias: its gradient would be rounding noise (the norm removes the
    mean), which Adam turns into learning-rate-sized moves."""
    layers = fluid.layers
    fw.reset_unique_names()

    def attr(name, std=True):
        return fluid.ParamAttr(name=name, initializer=(
            fluid.initializer.Normal(0.0, DC_STD) if std else None))

    def bn(x, name, act):
        return layers.batch_norm(
            x, act=act, param_attr=attr(name + ".s", False),
            bias_attr=attr(name + ".o", False),
            moving_mean_name=name + ".m", moving_variance_name=name + ".v")

    def gen(z):
        side = img // 2 ** len(g_widths)
        h = layers.fc(z, g_widths[0] * side * side,
                      param_attr=attr("g.fc.w"), bias_attr=False)
        h = bn(layers.reshape(h, shape=[-1, g_widths[0], side, side]),
               "g.bn0", "relu")
        outs = list(g_widths[1:]) + [3]
        for i, c in enumerate(outs, 1):
            last = i == len(outs)
            h = layers.conv2d_transpose(
                h, c, filter_size=4, stride=2, padding=1,
                param_attr=attr(f"g.ct{i}.w"),
                bias_attr=attr(f"g.ct{i}.b", False) if last else False,
                act="tanh" if last else None)
            if not last:
                h = bn(h, f"g.bn{i}", "relu")
        return h

    def disc(x):
        h = x
        for i, c in enumerate(d_widths):
            h = layers.conv2d(h, c, 4, stride=2, padding=1,
                              param_attr=attr(f"d.c{i}.w"),
                              bias_attr=False if i else attr("d.c0.b",
                                                             False))
            if i:
                h = bn(h, f"d.bn{i}", None)
            h = layers.leaky_relu(h, alpha=DC_SLOPE)
        return layers.fc(h, 1, param_attr=attr("d.fc.w"),
                         bias_attr=attr("d.fc.b", False))

    def bce(logit, label):
        return layers.mean(layers.sigmoid_cross_entropy_with_logits(
            logit, label))

    startup, d_prog, dg_prog = (fluid.Program(), fluid.Program(),
                                fluid.Program())
    with fluid.program_guard(d_prog, startup):
        real = layers.data("real", [3, img, img], dtype=dtype)
        fake = layers.data("fake", [3, img, img], dtype=dtype)
        ones = layers.data("ones", [1], dtype=dtype)
        zeros = layers.data("zeros", [1], dtype=dtype)
        d_loss = layers.elementwise_add(bce(disc(real), ones),
                                        bce(disc(fake), zeros))
        fluid.Adam(learning_rate=DC_LR, beta1=DC_BETA1).minimize(
            d_loss, startup_program=startup, parameter_list=sorted(
                p.name for p in d_prog.global_block().all_parameters()))
    with fluid.program_guard(dg_prog, startup):
        noise = layers.data("noise", [z_dim], dtype=dtype)
        g_img = gen(noise)
        g_prog = dg_prog.clone()
        ones = layers.data("ones", [1], dtype=dtype)
        dg_loss = bce(disc(g_img), ones)
        fluid.Adam(learning_rate=DC_LR, beta1=DC_BETA1).minimize(
            dg_loss, startup_program=startup, parameter_list=sorted(
                p.name for p in dg_prog.global_block().all_parameters()
                if p.name.startswith("g.")))
    return startup, d_prog, dg_prog, g_prog, d_loss, dg_loss, g_img


def _dcgan_batches(iters, batch, z_dim=DC_Z, img=DC_IMG, dtype=np.float32,
                   seed=SEED):
    """Each iteration's real images in [-1, 1] and its two noise batches
    (numpy, from `seed`)."""
    r = np.random.RandomState(seed)
    return [{"real": (r.rand(batch, 3, img, img) * 2 - 1).astype(dtype),
             "z_d": r.standard_normal((batch, z_dim)).astype(dtype),
             "z_g": r.standard_normal((batch, z_dim)).astype(dtype)}
            for _ in range(iters)]


def _dcgan_iteration(exe, progs, batch, compiled=None, scope=None):
    """One alternating iteration: G makes a fake batch, D takes a step on
    it and the real batch, G + D a step for G -> (d_loss, dg_loss)."""
    _, d_prog, dg_prog, g_prog, d_loss, dg_loss, g_img = progs
    n = batch["real"].shape[0]
    one = np.ones((n, 1), batch["real"].dtype)
    fake, = exe.run(g_prog, feed={"noise": batch["z_d"]},
                    fetch_list=[g_img], compiled=compiled,
                    return_numpy=False, scope=scope)
    d, = exe.run(d_prog, feed={"real": batch["real"], "fake": fake,
                               "ones": one, "zeros": one * 0},
                 fetch_list=[d_loss], compiled=compiled, scope=scope)
    g, = exe.run(dg_prog, feed={"noise": batch["z_g"], "ones": one},
                 fetch_list=[dg_loss], compiled=compiled, scope=scope)
    return float(np.asarray(d).reshape(-1)[0]), \
        float(np.asarray(g).reshape(-1)[0])


# -- persist phase -----------------------------------------------------------

def _s2s_reader(iters):
    """PS_ITERS batches of run_seq2seq's shapes, ids from RandomState(SEED +
    i), as batch readers yield them (a list of (src, tgt, lbl) rows)."""
    def reader():
        for i in range(iters):
            r = np.random.RandomState(SEED + i)
            shape = (S_BATCH, S_LEN)
            src, tgt = (r.randint(0, S_VOCAB, shape) for _ in range(2))
            lbl = r.randint(0, S_VOCAB, shape + (1,))
            yield [(src[b], tgt[b], lbl[b]) for b in range(S_BATCH)]
    return reader


def _state_of(main, scope):
    """Every persistable's tensor in `scope`, cloned."""
    return {n: scope.find_var(n).clone() for n in _persistables(main)}


def _states_equal(got, want):
    """-> the names whose dtype or bits differ."""
    return sorted(n for n in want if got[n].dtype != want[n].dtype
                  or not torch.equal(got[n], want[n]))


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _persist_seq2seq(card, place):
    """run_seq2seq's translator through the port's Trainer: PS_ITERS
    iterations with a snapshot every PS_EVERY; a run killed at iteration
    PS_KILL by the `trainer.iteration` fault site and resumed by a new
    Trainer in a fresh scope; then step PS_EVERY's snapshot loaded into
    the uninterrupted run's own scope and Executor (its graph captured)
    and iterations PS_EVERY + 1 .. 2 PS_EVERY run again."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io, trainer
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.resilience import fault_injector
    from paddle_tpu_torch.core.scope import Scope

    root = tempfile.mkdtemp(prefix="persist_")
    fluid.amp.enable_bf16()     # before the Program is built
    prev_scope = executor_mod.switch_scope(Scope())
    t_ref = None
    try:
        main, startup, loss = _s2s_program()
        blk = main.global_block()
        feed_vars = [blk.var(n) for n in ("src", "tgt", "lbl")]
        reader = _s2s_reader(PS_ITERS)

        def run(ckpt, keep, kill=None, at=None, resume=False):
            scope = Scope()
            executor_mod.switch_scope(scope)
            t = trainer.Trainer(loss, feed_list=feed_vars,
                                main_program=main, startup_program=startup,
                                place=place)
            losses, states = [], {}

            def handler(e):
                if isinstance(e, trainer.EndIteration):
                    losses.append(float(e.cost))
                    if t.step == at:
                        states.update(_state_of(main, scope))
            if kill:
                fault_injector().inject("trainer.iteration", "error",
                                        nth=kill,
                                        exc=RuntimeError("killed"))
            t0 = time.perf_counter()
            try:
                t.train(1, reader, event_handler=handler,
                        checkpoint_dir=None if resume else ckpt,
                        resume_from=ckpt if resume else None,
                        checkpoint_every_n_passes=0,
                        checkpoint_every_n_iters=PS_EVERY,
                        checkpoint_max_keep=keep)
            except RuntimeError as e:
                if not (kill and str(e) == "killed"):
                    raise
            finally:
                fault_injector().clear()
            torch.cuda.synchronize()
            return t, scope, losses, states, time.perf_counter() - t0

        counts = _flash_counts()
        ref_dir = os.path.join(root, "uninterrupted")
        t_ref, ref_scope, ref_losses, at_4, ref_s = run(
            ref_dir, 3, at=2 * PS_EVERY)
        want = _state_of(main, ref_scope)
        launches = {k: f() for k, f in counts.items()}
        check(t_ref.step == PS_ITERS and len(ref_losses) == PS_ITERS,
              f"persist: the uninterrupted run took {t_ref.step} steps")
        # the wrappers count at the eager first step and at the capture;
        # the replays launch the captured 3 * S_LAYERS of each a step
        check(all(v == 2 * 3 * S_LAYERS for v in launches.values()),
              f"persist: flash launches {launches} over the uninterrupted "
              f"run, want {2 * 3 * S_LAYERS} of each")
        graphs = t_ref.exe.graph_stats()
        check(graphs["captures"] >= 1 and graphs["replays"] >= 1,
              f"persist: the uninterrupted run's graphs {graphs}")

        run_dir = os.path.join(root, "killed")
        t_k, _, k_losses, _, kill_s = run(run_dir, 1, kill=PS_KILL)
        check(t_k.step == PS_KILL - 1, f"persist: the killed run took "
              f"{t_k.step} steps, want {PS_KILL - 1}")
        t_k.exe.close()
        t_r, r_scope, r_losses, _, resume_s = run(run_dir, 1, resume=True)
        got = _state_of(main, r_scope)
        t_r.exe.close()
        differ = _states_equal(got, want)
        first = (PS_KILL - 1) // PS_EVERY * PS_EVERY   # the snapshot's step
        check(t_r.step == PS_ITERS and r_losses == ref_losses[first:]
              and k_losses == ref_losses[:PS_KILL - 1] and not differ,
              f"persist: the resumed run ({t_r.step} steps, losses "
              f"{r_losses}) against the uninterrupted ({ref_losses}); "
              f"persistables differing: {differ[:5]}")
        del got

        # in process: step PS_EVERY's snapshot into the captured run
        snaps = {}
        for name in os.listdir(ref_dir):
            meta = os.path.join(ref_dir, name, io.META_FILENAME)
            if os.path.exists(meta):
                with open(meta) as f:
                    snaps[json.load(f)["trainer_args"]["step"]] = name
        snap = os.path.join(ref_dir, snaps[PS_EVERY])
        executor_mod.switch_scope(ref_scope)
        replays = t_ref.exe.graph_stats()["replays"]
        t0 = time.perf_counter()
        io.load_persistables(t_ref.exe, snap, main)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        feeder = t_ref._feeder()
        again = []
        for batch in list(reader())[PS_EVERY:2 * PS_EVERY]:
            out = t_ref.exe.run(main, feed=feeder.feed(batch),
                                fetch_list=[loss])
            again.append(float(out[0].reshape(-1)[0]))
        in_process = _states_equal(_state_of(main, ref_scope), at_4)
        replayed = t_ref.exe.graph_stats()["replays"] - replays
        check(again == ref_losses[PS_EVERY:2 * PS_EVERY]
              and not in_process and replayed == PS_EVERY,
              f"persist: the in-process load gave losses {again}, want "
              f"{ref_losses[PS_EVERY:2 * PS_EVERY]} ({replayed} replays); "
              f"persistables differing: {in_process[:5]}")
        t0 = time.perf_counter()
        io.save_checkpoint(t_ref.exe, os.path.join(root, "timed"), main,
                           max_keep=1)
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(snap)
        return {"source": "benchmark/run_seq2seq.py:39-60 (transformer "
                          "defaults: d 512, 8 heads, 6 + 6 layers, vocab "
                          "30000, batch 32, lengths 128, Adam 1e-4, bf16 "
                          "amp)",
                "iterations": PS_ITERS, "snapshot_every": PS_EVERY,
                "killed_at_iteration": PS_KILL,
                "resumed_from_step": first, "losses": ref_losses,
                "persistables": len(want), "persistables_bit_equal": True,
                "in_process_load_into_captured_graph": {
                    "snapshot_step": PS_EVERY, "replays": replayed,
                    "losses": again, "bit_equal": True},
                "uninterrupted_graphs": graphs,
                "flash_launches_uninterrupted": launches,
                "checkpoint_bytes": nbytes, "checkpoint_files": len(
                    os.listdir(snap)),
                "save_s": save_s, "load_s": load_s,
                "load_note": "load_persistables of one snapshot (the "
                             "in-process load); save_s one "
                             "save_checkpoint (files, md5, pointer, GC)",
                "uninterrupted_s": ref_s, "killed_run_s": kill_s,
                "resumed_run_s": resume_s}
    finally:
        if t_ref is not None:
            t_ref.exe.close()
        executor_mod.switch_scope(prev_scope)
        fluid.amp.disable_bf16()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _persist_resnet_serve(card, place):
    """image_serve's ResNet-50 (bf16) saved with save_inference_model, one
    file a variable and with params_filename, each loaded into a fresh
    scope and served by an InferenceServer: its logits for SRV_SINGLE
    single requests (bucket 1) bit-equal to the in-memory inference
    Program's server; and the parameters through Parameters.to_tar /
    from_tar bit for bit."""
    import io as pyio

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.serving import InferenceServer

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, R_IMG, R_IMG],
                                dtype="bfloat16")
        probs = fluid.models.resnet_imagenet(img, class_dim=R_CLASSES,
                                             depth=R_DEPTH)
    soft, = [op for op in main.global_block().ops
             if op.type == "softmax" and op.output("Out") == [probs.name]]
    predict = main.global_block().var(soft.input("X")[0])
    scope = Scope()
    exe = fluid.Executor(place, seed=SEED)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    reqs = [torch.from_numpy(rng.rand(1, 3, R_IMG, R_IMG).astype(
        np.float32)).to(torch.bfloat16) for _ in range(SRV_SINGLE)]

    def serve(program, fetch, sc):
        srv = InferenceServer(program, "img", fetch, sc, place=place,
                              buckets=(1,), window_ms=SRV_WINDOW_MS)
        try:
            return [np.asarray(srv.submit(q).result(timeout=120))
                    for q in reqs]
        finally:
            srv.close()

    root = tempfile.mkdtemp(prefix="persist_serve_")
    try:
        want = serve(io.get_inference_program([predict], main), predict,
                     scope)
        layouts = {}
        for layout, params_filename in (("one_file_a_variable", None),
                                        ("params_filename", "__params__")):
            d = os.path.join(root, layout)
            t0 = time.perf_counter()
            io.save_inference_model(d, ["img"], [predict], exe,
                                    main_program=main, scope=scope,
                                    params_filename=params_filename)
            save_s = time.perf_counter() - t0
            sc = Scope()
            t0 = time.perf_counter()
            prog, feeds, fetches = io.load_inference_model(
                d, exe, params_filename=params_filename, scope=sc)
            load_s = time.perf_counter() - t0
            got = serve(prog, fetches[0], sc)
            equal = all(np.array_equal(a, b) for a, b in zip(got, want))
            check(feeds == ["img"] and equal, f"persist: ResNet-50 served "
                  f"from {layout} differs from the in-memory program's")
            layouts[layout] = {"files": len(os.listdir(d)),
                               "bytes": _dir_bytes(d), "save_s": save_s,
                               "load_s": load_s, "logits_bit_equal": True}
        params = Parameters(main, scope)
        buf = pyio.BytesIO()
        t0 = time.perf_counter()
        params.to_tar(buf)
        tar_s = time.perf_counter() - t0
        back = Parameters.from_tar(pyio.BytesIO(buf.getvalue()))
        differ = [n for n in params.names() if not torch.equal(
            back._tensor(n), scope.find_var(n).cpu())]
        check(back.names() == params.names() and not differ,
              f"persist: Parameters tar round trip differs in {differ[:5]}")
        return {"source": "benchmark/run_image.py:154-204 (resnet50, 224, "
                          "bf16; buckets (1,): every request alone)",
                "requests": SRV_SINGLE, "layouts": layouts,
                "parameters_tar": {"parameters": len(params.names()),
                                   "bytes": len(buf.getvalue()),
                                   "to_tar_s": tar_s, "bit_equal": True}}
    finally:
        exe.close()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def persist_phase(card, place):
    """The seq2seq Trainer killed and resumed, the in-process load into a
    captured graph, and ResNet-50 served from a saved model (see
    `_persist_seq2seq`, `_persist_resnet_serve`) -> the flash launches of
    the uninterrupted seq2seq run."""
    t0 = time.perf_counter()
    s2s = _persist_seq2seq(card, place)
    serve = _persist_resnet_serve(card, place)
    emit({"phase": "persist", "card": card, "seq2seq_resume": s2s,
          "resnet50_served_from_disk": serve,
          "phase_s": time.perf_counter() - t0,
          "timing": "host clock (time.perf_counter) around the calls, "
                    "synchronized; the checkpoint files on the machine's "
                    "local temporary directory (a warm page cache)"})
    return s2s["flash_launches_uninterrupted"]


# -- conv_rest phase ---------------------------------------------------------

def _cr_lod(batch, length, seed=SEED):
    """A ragged LoD of `batch` sequences of at most `length` rows."""
    lens = np.random.RandomState(seed).randint(length // 2, length + 1,
                                               batch)
    return [[0] + np.cumsum(lens).tolist()]


def _cr_cases():
    """(name, op, inputs at batch n -> {slot: numpy or (numpy, lod)}, attrs,
    float dtypes) for A3's ten ops at the conv_rest shapes."""
    def rnd(shape, seed, scale=1.0):
        return (np.random.RandomState(seed).standard_normal(shape)
                * scale).astype(np.float32)

    def c3d(n):
        return {"Input": rnd((n,) + CR_C3D[1:], 1),
                "Filter": rnd((CR_C3D_OUT, 3, 3, 3, 3), 2, 0.1)}

    def c3d_out(n):
        return {"X": rnd((n, CR_C3D_OUT) + CR_C3D[2:], 3)}

    def unet(n):
        return {"Input": rnd((n,) + CR_UNET[1:], 4),
                "Filter": rnd((CR_UNET[1], CR_UNET_OUT, 2, 2, 2), 5, 0.05)}

    def segnet(shape):
        return lambda n: {"X": rnd((n,) + shape[1:], 6)}

    def unpool(shape, attrs):
        """SegNet's pairing: the pooled values and the pool's indices."""
        def make(n):
            x = torch.from_numpy(segnet(shape)(n)["X"]).cuda()
            o, _ = _cr_call("max_pool2d_with_index", {"X": [x]}, attrs,
                            x.device)
            return {"X": o["Out"].cpu().numpy(),
                    "Indices": o["Mask"].cpu().numpy()}
        return make

    def row(n):
        lod = _cr_lod(n, CR_ROW_LEN)
        return {"X": (rnd((lod[0][-1], CR_ROW_D), 7), lod),
                "Filter": rnd((CR_ROW_FUTURE + 1, CR_ROW_D), 8, 0.1)}

    pool = {"ksize": [2, 2, 2], "strides": [2, 2, 2]}
    seg2 = {"ksize": [2, 2], "strides": [2, 2]}
    seg3 = {"ksize": [3, 3], "strides": [2, 2]}
    # 359 x 479: unpool's size rule maps the 3x3 / 2 pool's 179 x 239
    # back onto it
    seg_odd = CR_SEGNET[:2] + (359, 479)
    both = (torch.float32, torch.bfloat16)
    return [
        ("conv3d.c3d_conv1", "conv3d", c3d,
         {"paddings": [1, 1, 1]}, both),
        ("pool3d.c3d_pool", "pool3d", c3d_out, pool, (torch.float32,)),
        ("max_pool3d_with_index.c3d_pool", "max_pool3d_with_index",
         c3d_out, pool, (torch.float32,)),
        ("conv3d_transpose.unet_up", "conv3d_transpose", unet,
         {"strides": [2, 2, 2]}, both),
        ("conv2d_transpose.dcgan_g2", "conv2d_transpose",
         lambda n: {"Input": rnd((n, 512, 8, 8), 9),
                    "Filter": rnd((512, 256, 4, 4), 10, 0.05)},
         {"strides": [2, 2], "paddings": [1, 1]}, both),
        ("max_pool2d_with_index.segnet", "max_pool2d_with_index",
         segnet(CR_SEGNET), seg2, (torch.float32,)),
        ("max_pool2d_with_index.overlapping", "max_pool2d_with_index",
         segnet(seg_odd), seg3, (torch.float32,)),
        ("unpool.segnet", "unpool", unpool(CR_SEGNET, seg2), seg2,
         (torch.float32,)),
        ("unpool.overlapping", "unpool", unpool(seg_odd, seg3), seg3,
         (torch.float32,)),
        ("spp.sppnet_conv5", "spp",
         lambda n: {"X": rnd((n,) + CR_SPP[1:], 11)},
         {"pyramid_height": CR_SPP_HEIGHT}, (torch.float32,)),
        ("row_conv.deepspeech2", "row_conv", row, {}, (torch.float32,)),
        ("conv_shift.ntm", "conv_shift",
         lambda n: {"X": rnd((n, CR_SHIFT[1]), 12),
                    "Y": rnd((n, CR_SHIFT_M), 13)}, {},
         (torch.float32,)),
    ]


# each case's full batch (C3D, 3D U-Net, SegNet, SPP-net, DeepSpeech2 and
# NTM as above; conv2d_transpose at the DCGAN generator's second layer,
# [128, 512, 8, 8] -> 256 at 16 x 16)
_CR_FULL = {"conv3d": CR_C3D[0], "pool3d": CR_C3D[0],
            "max_pool3d_with_index": CR_C3D[0],
            "conv3d_transpose": CR_UNET[0], "conv2d_transpose": DC_BATCH,
            "max_pool2d_with_index": CR_SEGNET[0], "unpool": CR_SEGNET[0],
            "spp": CR_SPP[0], "row_conv": CR_ROW_BATCH,
            "conv_shift": CR_SHIFT[0]}


def _cr_inputs(ins, dev, dtype):
    """numpy case inputs -> {slot: [value on dev]}, floats in `dtype`, an
    (array, lod) input as a LoDTensor."""
    from paddle_tpu_torch.core.lod import LoDTensor

    out = {}
    for slot, a in ins.items():
        arr, lod = a if isinstance(a, tuple) else (a, None)
        t = torch.from_numpy(arr).to(dev)
        t = t.to(dtype) if t.is_floating_point() else t
        out[slot] = [LoDTensor(t, lod) if lod else t]
    return out


def _cr_call(op, vals, attrs, dev, cots=None):
    """The op's forward and, with `cots` ({slot: tensor on dev}), its
    gradient (the explicit gradient lowering where the op has one, else
    the generic one) -> ({slot: tensor}, {slot: tensor})."""
    from paddle_tpu_torch.core.execution import (GRAD, ExecContext,
                                                 generic_grad_lower)
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.core.registry import get_op_info

    info = get_op_info(op)
    attrs = {**info.attrs, **attrs}

    def data(v):
        return v.data if isinstance(v, LoDTensor) else v

    outs = {s: data(v) for s, v in info.lower(ExecContext(dev), vals,
                                              attrs).items()}
    if not cots:
        return outs, {}
    g_ins = dict(vals)
    g_ins.update({s: [outs[s]] for s in info.outputs if s in outs})
    g_ins.update({s + GRAD: [c] for s, c in cots.items()})
    fn = info.grad_lower or (lambda c, i, a: generic_grad_lower(c, i, a,
                                                                info))
    return outs, {s[:-len(GRAD)]: data(v[0]) for s, v in fn(
        ExecContext(dev), g_ins, attrs).items() if v and v[0] is not None}


def _cr_ulps(card, cpu):
    """bf16 card against the CPU's float32 on the same bf16 values: max
    |card - CPU| in bf16 ulps of max |CPU|."""
    if not cpu.is_floating_point():
        return _op_err(card, cpu)
    a, b = card.cpu().double(), cpu.double()
    ulp = 2.0 ** (np.floor(np.log2(float(b.abs().max()))) - 7)
    return float((a - b).abs().max()) / ulp


def _cr_route(op, ins, attrs, dtype):
    """ATen's convolution backend for the op's arguments (the lowering's
    own `_conv_args`) under its pinned flags."""
    from paddle_tpu_torch.core.registry import get_op_info
    from paddle_tpu_torch.ops.conv import _conv_args, conv_pinned

    if op not in ("conv3d", "conv2d_transpose", "conv3d_transpose"):
        return "plain PyTorch (no convolution)"
    x = torch.empty(ins["Input"].shape, dtype=dtype, device="cuda")
    w = torch.empty(ins["Filter"].shape, dtype=dtype, device="cuda")
    n, transposed = x.dim() - 2, op.endswith("transpose")
    s, p, d, g = _conv_args({**get_op_info(op).attrs, **attrs}, n,
                            groups=not transposed)
    with conv_pinned(dtype):
        return str(torch._C._select_conv_backend(
            x, w, None, list(s), list(p), list(d), transposed, [0] * n, g,
            None))


def _cr_ops(card, dev):
    """Each op of `_cr_cases` at its full batch on the card (forward, and
    forward with gradient, timed between CUDA events; two runs bit for
    bit), then at batch CR_CPU_BATCH on the card and on the CPU from the
    same inputs and cotangents (bf16: the CPU in float32 on the same
    bf16 values)."""
    rows = {}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    for name, op, make, attrs, dtypes in _cr_cases():
        full_np = make(_CR_FULL[op])
        for dtype in dtypes:
            key = name + ("" if dtype == torch.float32 else ".bf16")
            full = _cr_inputs(full_np, dev, dtype)
            outs, _ = _cr_call(op, full, attrs, dev)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            cots = {s: torch.randn(v.shape, generator=gen, device=dev,
                                   dtype=v.dtype)
                    for s, v in outs.items() if v.is_floating_point()}
            del outs
            first, again = (_cr_call(op, full, attrs, dev, cots)
                            for _ in range(2))
            check(all(torch.equal(a, b) for d1, d2 in zip(first, again)
                      for a, b in zip(d1.values(), d2.values())),
                  f"conv_rest {key}: two card runs differ")
            del first, again
            fwd_ms = cold_ms(lambda: _cr_call(op, full, attrs, dev), 3,
                             flush)
            both_ms = cold_ms(lambda: _cr_call(op, full, attrs, dev, cots),
                              3, flush)
            route = _cr_route(op, full_np, attrs, dtype)
            del full, cots
            torch.cuda.empty_cache()
            small = make(CR_CPU_BATCH)
            if dtype == torch.bfloat16:     # bf16 values, float32 arrays
                small = {k: torch.from_numpy(v).to(dtype).float().numpy()
                         for k, v in small.items()}
            c_vals = _cr_inputs(small, "cpu", torch.float32)
            c_out, _ = _cr_call(op, c_vals, attrs, "cpu")
            r = np.random.RandomState(SEED + 1)
            c_cots = {s: torch.from_numpy(r.standard_normal(
                tuple(v.shape)).astype(np.float32))
                for s, v in c_out.items() if v.is_floating_point()}
            if dtype == torch.bfloat16:
                c_cots = {k: v.to(dtype).float() for k, v in c_cots.items()}
            cpu = _cr_call(op, c_vals, attrs, "cpu", c_cots)
            card_ = _cr_call(op, _cr_inputs(small, dev, dtype), attrs, dev,
                             {k: v.to(dev, dtype) for k, v in
                              c_cots.items()})
            check(set(card_[0]) == set(cpu[0])
                  and set(card_[1]) == set(cpu[1]),
                  f"conv_rest {key}: the card's slots differ")
            errs, lims = {}, {}
            if dtype == torch.float32:
                # float32 sums of 400k products (conv3d's weight
                # gradient) round at ~sqrt(n) * 2^-24 of their largest:
                # the card is held to float64 no worse than twice the
                # CPU's float32, and within OPS_RTOL where that is less
                ref = _cr_call(op, _cr_inputs(small, "cpu", torch.float64),
                               attrs, "cpu", {k: v.double() for k, v in
                                              c_cots.items()})
                for i, kind in enumerate(("out", "grad")):
                    for sl, want in ref[i].items():
                        k, got = f"{kind}.{sl}", card_[i][sl]
                        if not want.is_floating_point():    # exact
                            errs[k], lims[k] = _op_err(got, want), 0.0
                            continue
                        errs[k] = _op_err(got.double(), want)
                        lims[k] = max(OPS_RTOL, 2 * _op_err(
                            cpu[i][sl].double(), want))
            else:
                for i, kind in enumerate(("out", "grad")):
                    for sl, c in cpu[i].items():
                        errs[f"{kind}.{sl}"] = _cr_ulps(card_[i][sl], c)
                        lims[f"{kind}.{sl}"] = 1.0
            bad = {k: (errs[k], lims[k]) for k in errs if errs[k] > lims[k]}
            check(not bad, f"conv_rest {key}: card against the reference "
                  f"(error, limit): {bad}")
            rows[key] = {"op": op, "dtype": str(dtype).split(".")[-1],
                         "shapes": {k: list((v[0] if isinstance(v, tuple)
                                             else v).shape)
                                    for k, v in full_np.items()},
                         "attrs": attrs, "route": route, "fwd_ms": fwd_ms,
                         "fwd_and_grad_ms": both_ms, "error": errs,
                         "limit": lims, "error_unit": (
                             "against the CPU's float64, of max(1, "
                             "max|float64|); limit max(OPS_RTOL, twice the "
                             "CPU's float32 error)"
                             if dtype == torch.float32 else
                             "bf16 ulps of max|CPU float32 on the bf16 "
                             "values|; limit one ulp"),
                         "two_card_runs_bit_equal": True}
        del full_np
    return rows


def _dcgan_names(progs):
    return sorted({v.name for p in progs[1:4] for v in p.list_vars()
                   if v.persistable})


def _dcgan_on(place, progs, state, batch):
    """One iteration on `place` (None: the CPU) from `state` (CPU tensors)
    in a scope of its own -> (losses, the states after it on the CPU)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    prev = executor_mod.switch_scope(Scope())
    try:
        scope = fluid.global_scope()
        dev = place.torch_device() if place is not None else "cpu"
        for n, v in state.items():
            scope.set_var(n, v.to(dev))
        exe = fluid.Executor(place or fluid.CPUPlace(), seed=SEED)
        losses = _dcgan_iteration(exe, progs, batch)
        after = {n: scope.find_var(n).cpu() for n in state}
        exe.close()
        return losses, after
    finally:
        executor_mod.switch_scope(prev)


def _dcgan(card, place):
    """DCGAN at full width in float32: DC_ITERS alternating iterations in
    the Executor's default mode (each program a CUDA graph from its
    second run) and again from the same state interpreted, losses and
    every persistable bit for bit; then card against CPU in float64 at
    batch DC_CPU_BATCH, an iteration at a time from the CPU's state."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope

    progs = _dcgan_programs(fluid, fw)
    names = _dcgan_names(progs)
    prev = executor_mod.switch_scope(Scope())
    try:
        scope = fluid.global_scope()
        exe = fluid.Executor(place, seed=SEED)
        exe.run(progs[0])
        init = {n: scope.find_var(n).clone() for n in names}
        batches = _dcgan_batches(DC_ITERS, DC_BATCH)
        runs = {}
        for mode, compiled in (("default", None), ("interpreted", False)):
            for n, v in init.items():
                scope.set_var(n, v.clone())
            losses, secs = [], []
            for b in batches:
                t0 = time.perf_counter()
                losses.append(_dcgan_iteration(exe, progs, b, compiled))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            runs[mode] = {"losses": losses, "secs": secs,
                          "state": {n: scope.find_var(n).clone()
                                    for n in names}}
        graphs = exe.graph_stats()
        exe.close()
    finally:
        executor_mod.switch_scope(prev)
    d, i = runs["default"], runs["interpreted"]
    differ = _states_equal(d["state"], i["state"])
    check(d["losses"] == i["losses"] and not differ,
          f"conv_rest dcgan: default mode {d['losses']} against the "
          f"interpreter {i['losses']}; states differing {differ[:5]}")
    check(all(np.isfinite(v) for pair in d["losses"] for v in pair),
          f"conv_rest dcgan: losses {d['losses']}")
    check(graphs["captures"] == 3 and graphs["replays"] == 3 * (
        DC_ITERS - 2), f"conv_rest dcgan: graphs {graphs}")
    f64 = _dcgan_programs(fluid, fw, dtype=CPU_DTYPE)
    prev = executor_mod.switch_scope(Scope())
    try:
        exe = fluid.Executor(place, seed=SEED)
        exe.run(f64[0])
        state = {n: fluid.global_scope().find_var(n).cpu()
                 for n in _dcgan_names(f64)}
        exe.close()
    finally:
        executor_mod.switch_scope(prev)
    steps = []
    for b in _dcgan_batches(DC_CPU_ITERS, DC_CPU_BATCH, dtype=np.float64):
        c_loss, c_state = _dcgan_on(place, f64, state, b)
        p_loss, p_state = _dcgan_on(None, f64, state, b)
        rel = _states_rel_diff(c_state, p_state)
        worst = max(rel, key=rel.get)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(c_loss, p_loss))
        steps.append({"card": c_loss, "cpu": p_loss,
                      "loss_rel_diff": loss_rel,
                      "state_max_rel_diff": rel[worst],
                      "state_argmax": worst})
        check(loss_rel <= N_CPU_LOSS_RTOL and rel[worst] <= N_CPU_RTOL,
              f"conv_rest dcgan: card against CPU {steps[-1]}")
        state = p_state
    step_s = float(np.median(d["secs"][2:]))
    n_params = sum(init[n].numel() for n in names
                   if n.startswith(("g.", "d.")) and not n.endswith(
                       (".m", ".v")) and "_moment" not in n
                   and "pow_acc" not in n)
    return {"source": "Radford et al. 2016 sections 3-4 (DCGAN: z 100 -> "
                      "4x4x1024 -> 8x8x512 -> 16x16x256 -> 32x32x128 -> "
                      "64x64x3, the mirror in D; Adam 2e-4, beta1 0.5; "
                      "batch 128; N(0, 0.02)); Paddle's fluid GAN demo's "
                      "program layout",
            "reduced": ["4x4 kernels at stride 2, pad 1 (the paper's "
                        "5x5: the JAX conv2d_transpose has no "
                        "output_padding)", "no bias before batch norm"],
            "dtype": "float32", "batch": DC_BATCH,
            "iterations": DC_ITERS, "parameters": int(n_params),
            "losses_default": d["losses"],
            "default_equals_interpreted_bit_for_bit": True,
            "graphs": graphs, "ms_per_iteration": step_s * 1e3,
            "interpreted_ms_per_iteration": float(np.median(
                i["secs"][1:])) * 1e3,
            "images_per_s": DC_BATCH / step_s,
            "images_per_s_note": "real images a second: batch over an "
                                 "iteration (G's fake batch, D's step on "
                                 "it and a real batch, G's step)",
            "card_vs_cpu": {"dtype": CPU_DTYPE, "batch": DC_CPU_BATCH,
                            "iterations": steps,
                            "loss_limit": N_CPU_LOSS_RTOL,
                            "state_limit": N_CPU_RTOL}}


def conv_rest_phase(card, dev, place):
    """A3's ten ops at published shapes (`_cr_ops`), then DCGAN trains
    (`_dcgan`)."""
    t0 = time.perf_counter()
    rows = _cr_ops(card, dev)
    emit({"phase": "conv_rest", "part": "ops", "card": card, "ops": rows,
          "ops_s": time.perf_counter() - t0,
          "timing": "CUDA events around the call (inputs already on the "
                    "card, L2 overwritten before each), median of 3 after "
                    "a warm call"})
    t1 = time.perf_counter()
    gan = _dcgan(card, place)
    emit({"phase": "conv_rest", "part": "dcgan", "card": card, **gan,
          "dcgan_s": time.perf_counter() - t1,
          "phase_s": time.perf_counter() - t0,
          "timing": "host clock around each iteration's three exe.run "
                    "calls + synchronize; ms_per_iteration the median of "
                    "the replayed iterations (3..N)"})


# -- aot_native phase (A10b): the AOT artifact, the C ABI, native runtime ----

_CAPI_CHILD = r"""
import ctypes, sys
import numpy as np
so, model_dir, src, dst = sys.argv[1:5]
dims = [int(d) for d in sys.argv[5:]]
lib = ctypes.CDLL(so)
i64, vp = ctypes.c_int64, ctypes.c_void_p
lib.paddle_tpu_inference_create.restype = i64
lib.paddle_tpu_inference_create.argtypes = [ctypes.c_char_p]
lib.paddle_tpu_inference_feed.restype = ctypes.c_int
lib.paddle_tpu_inference_feed.argtypes = [
    i64, ctypes.c_char_p, vp, ctypes.POINTER(i64), ctypes.c_int,
    ctypes.c_int]
lib.paddle_tpu_inference_run.restype = ctypes.c_int
lib.paddle_tpu_inference_run.argtypes = [i64]
lib.paddle_tpu_inference_fetch.restype = i64
lib.paddle_tpu_inference_fetch.argtypes = [
    i64, ctypes.c_int, ctypes.POINTER(ctypes.c_float), i64,
    ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_int)]
lib.paddle_tpu_inference_destroy.restype = ctypes.c_int
lib.paddle_tpu_inference_destroy.argtypes = [i64]
lib.paddle_tpu_last_error.restype = ctypes.c_char_p
err = lambda: lib.paddle_tpu_last_error().decode()
x = np.fromfile(src, dtype=np.float32).reshape(dims)
sid = lib.paddle_tpu_inference_create(model_dir.encode())
assert sid > 0, err()
cdims = (i64 * len(dims))(*dims)
assert lib.paddle_tpu_inference_feed(
    sid, b"img", x.ctypes.data_as(vp), cdims, len(dims), 0) == 0, err()
assert lib.paddle_tpu_inference_run(sid) == 1, err()
cap = 1 << 22
buf = (ctypes.c_float * cap)()
odims, ondim = (i64 * 8)(), ctypes.c_int()
n = lib.paddle_tpu_inference_fetch(sid, 0, buf, cap, odims,
                                   ctypes.byref(ondim))
assert n > 0, err()
np.ctypeslib.as_array(buf)[:n].tofile(dst)
rt = sys.modules["paddle_tpu_torch.capi_runtime"]
print("device=" + str(rt._sessions[sid].exe.device))
assert lib.paddle_tpu_inference_destroy(sid) == 0, err()
print("ok", ondim.value, *odims[:ondim.value])
"""


def _aot_roundtrip(exe, main, scope, target, specs, root, name, place):
    """export_aot_model of `target` into root/name, then load_aot_model
    on `place` -> (call, {export_s, load_s, bytes, files})."""
    from paddle_tpu_torch import io

    d = os.path.join(root, name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    io.export_aot_model(d, specs, [target], exe, main_program=main,
                        scope=scope)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    call, _, _ = io.load_aot_model(d, place)
    torch.cuda.synchronize()
    return call, {"export_s": export_s, "load_s": time.perf_counter() - t0,
                  "bytes": _dir_bytes(d), "files": sorted(os.listdir(d))}


class _Tally:
    """A kernel's launches made inside the wrapped calls alone: its
    count's change across each call, summed into `n`."""

    def __init__(self, read):
        self.read, self.n = read, 0

    def wrap(self, fn):
        def counted(*args):
            before = self.read()
            try:
                return fn(*args)
            finally:
                self.n += self.read() - before
        return counted


def _graph_targets(call):
    """{op target: nodes} of a loaded artifact's graph."""
    import collections

    return dict(collections.Counter(
        str(n.target) for n in call.exported_program.graph.nodes
        if n.op == "call_function"))


def _wall_ms(fn, n=AOT_REPS):
    """Median host-clock ms of `fn` + synchronize over `n` calls after a
    warm one."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def _ulps_of_rows(got, want):
    """Largest |got - want| of each row in bf16 ulps of the row's
    max|want| -> the worst row's."""
    got = np.asarray(got, np.float64).reshape(len(want), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    worst = 0.0
    for g, w in zip(got, want):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        worst = max(worst, float(np.abs(g - w).max()) / ulp)
    return worst


def _lm_forward(layers):
    """The train phase's LM forward (run_ridge's transformer_lm at the
    T_ widths, `layers` decoder layers, bf16 amp: the caller enables
    it) -> (main, startup, logits)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.models.transformer import transformer_lm

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[T_SEQ], dtype="int64")
        logits = transformer_lm(ids, T_VOCAB, d_model=T_D, n_heads=T_HEADS,
                                n_layers=layers, max_len=max(T_SEQ, 2048),
                                return_logits=True)
    return main, startup, logits


def _flash_op_host_us(dev):
    """Host µs a call of the flash forward at the LM's shape (bf16,
    causal) through the op `paddle_tpu_torch::flash_attention_fwd` and
    through the direct call, in turns (direct, op, op, direct)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(FLASH_SHAPE, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    scale = FLASH_SHAPE[3] ** -0.5
    routes = {"direct": lambda: fa.flash_attention_fwd(q, k, v, True,
                                                       scale),
              "op": lambda: fa.flash_attention_fwd_op(q, k, v, True,
                                                      scale)}
    o1, l1 = routes["direct"]()
    o2, l2 = routes["op"]()
    check(torch.equal(o1, o2) and torch.equal(l1, l2),
          "aot_native: the flash op's result differs from the direct "
          "call's")
    reads = {"direct": [], "op": []}
    for name in ("direct", "op", "op", "direct"):
        reads[name].append(host_us(routes[name], AOT_HOST_CALLS))
    return {k: float(np.mean(v)) for k, v in reads.items()} | {
        "reads": reads, "shape": list(FLASH_SHAPE), "dtype": "bfloat16",
        "calls_a_read": AOT_HOST_CALLS}


def _interpreted_host_ms(exe, infer, feed, fetch, scope):
    """Host ms of one interpreted forward (compiled=False: one run_op an
    op), its attention lowering the direct launch or the op
    `paddle_tpu_torch::flash_attention_fwd`, in turns (direct, op, op,
    direct), 3 steps a turn, each started on an idle card: what the
    host spends enqueueing the step.  The two routes' logits must be
    bit-equal (the same kernel)."""
    from paddle_tpu_torch.core.execution import one
    from paddle_tpu_torch.kernels import flash_attention as fa

    def op_route(lower):
        def lowered(ctx, ins, attrs):
            q, k, v = one(ins, "Q"), one(ins, "K"), one(ins, "V")
            scale = (q.shape[-1] ** -0.5 if attrs.get("default_scale", True)
                     else attrs["scale"])
            return {"Out": fa.flash_attention_fwd_op(
                q, k, v, bool(attrs.get("causal", False)), float(scale))[0]}
        return lowered

    def steps(reads, outs):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(exe.run(infer, feed=feed, fetch_list=[fetch],
                                scope=scope, return_numpy=False,
                                compiled=False)[0])
            reads.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()

    reads, outs = {"direct": [], "op": []}, {"direct": [], "op": []}
    for route in ("direct", "op", "op", "direct"):
        with (_wrapped_lowering("flash_attention", op_route)
              if route == "op" else contextlib.nullcontext()):
            steps(reads[route], outs[route])
    check(all(torch.equal(a, outs["direct"][0])
              for a in outs["direct"] + outs["op"]),
          "aot_native: the interpreted LM's logits differ between the "
          "flash op and the direct launch")
    med = {k: float(np.median(v)) for k, v in reads.items()}
    return {**med, "op_minus_direct_us_a_call":
            (med["op"] - med["direct"]) * 1e3 / T_LAYERS, "reads": reads}


def _aot_lm(place, root, tally):
    """The LM's forward (AOT_LM_LAYERS layers) exported and reloaded on
    the card (a flash op node a layer, no SDPA or plain attention node,
    a launch a layer a call, logits
    at the bf16 bar against the Executor's forward); a `go` block runs
    the artifact and sends its logits through a channel (bit-equal to
    the main thread's); the artifact of AOT_CPU_LAYERS layers loaded on
    the CPU against the card's.  The artifacts' calls on the card are
    counted in `tally`."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.kernels import flash_attention as fa

    op_name = "paddle_tpu_torch.flash_attention_fwd.default"
    ids = np.random.RandomState(SEED).randint(
        0, T_VOCAB, (T_BATCH, T_SEQ)).astype(np.int64)
    specs = {"ids": ([T_BATCH, T_SEQ], "int64")}
    out = {}
    fluid.amp.enable_bf16()     # before the Programs are built
    try:
        for layers in (AOT_LM_LAYERS, AOT_CPU_LAYERS):
            main, startup, logits = _lm_forward(layers)
            scope = Scope()
            exe = fluid.Executor(place, seed=SEED)
            try:
                exe.run(startup, scope=scope)
                name = f"lm{layers}"
                call, rec = _aot_roundtrip(exe, main, scope, logits, specs,
                                           root, name, place)
                targets = _graph_targets(call)
                call = tally.wrap(call)
                plain = sorted(t for t in targets if any(
                    w in t for w in ("scaled_dot_product", "softmax",
                                     "logsumexp")))
                check(targets.get(op_name) == layers and not plain,
                      f"aot_native: the LM{layers} graph holds "
                      f"{targets.get(op_name)} flash op nodes (want "
                      f"{layers}) and plain attention nodes {plain}")
                before = fa.flash_attention.launches["fwd"]
                got = call({"ids": ids})[0]
                torch.cuda.synchronize()
                per_call = fa.flash_attention.launches["fwd"] - before
                check(per_call == layers, f"aot_native: one call of the "
                      f"LM{layers} artifact launched the flash forward "
                      f"{per_call} times (want {layers})")
                infer = io.get_inference_program([logits], main)
                runs = [exe.run(infer, feed={"ids": ids},
                                fetch_list=[logits], scope=scope,
                                return_numpy=False)[0] for _ in range(3)]
                want = runs[-1]
                ok, lim, rms, rms_lim = _close_bf16(got.float(),
                                                    want.float())
                err = float((got.float() - want.float()).abs().max())
                check(ok, f"aot_native: LM{layers} artifact logits {err} "
                      f"(rms {rms}) from the Executor's (limits {lim}, "
                      f"{rms_lim})")
                rec.update(layers=layers, flash_op_nodes=layers,
                           flash_launches_a_call=per_call,
                           max_abs_err_vs_executor=err,
                           rms_err_vs_executor=rms, limit=lim,
                           rms_limit=rms_lim,
                           executor_bit_equal=bool(torch.equal(got, want)),
                           artifact_ms=_wall_ms(lambda: call(
                               {"ids": ids})),
                           executor_replay_ms=_wall_ms(lambda: exe.run(
                               infer, feed={"ids": ids},
                               fetch_list=[logits], scope=scope,
                               return_numpy=False)))
                if layers == AOT_LM_LAYERS:
                    rec["go"] = _aot_go(call, ids, got)
                    rec["interpreted_step_host_ms"] = _interpreted_host_ms(
                        exe, infer, {"ids": ids}, logits, scope)
                else:
                    t0 = time.perf_counter()
                    cpu_call, _, _ = io.load_aot_model(
                        os.path.join(root, name), fluid.CPUPlace())
                    cpu = cpu_call({"ids": ids})[0]
                    cpu_s = time.perf_counter() - t0
                    worst = _ulps_of_rows(got.float().cpu().numpy(),
                                          cpu.float().numpy())
                    check(cpu.device.type == "cpu" and worst <= SRV_ULPS,
                          f"aot_native: the LM{layers} artifact on the "
                          f"CPU is {worst} bf16 ulps of a row's max from "
                          f"the card's (limit {SRV_ULPS})")
                    rec["cpu"] = {"max_err_bf16_ulps": worst,
                                  "limit_bf16_ulps": SRV_ULPS,
                                  "load_and_call_s": cpu_s}
                out[name] = rec
                del call, got, want, runs
            finally:
                exe.close()
                torch.cuda.empty_cache()
    finally:
        fluid.amp.disable_bf16()
    return out


def _aot_go(call, ids, want):
    """A `go` block runs the loaded artifact and sends its logits
    through a channel; they must equal the main thread's bit for bit."""
    import paddle_tpu_torch as fluid

    ch = fluid.make_channel(capacity=1)
    t0 = time.perf_counter()
    with fluid.go() as g:
        g(lambda: fluid.channel_send(ch, call({"ids": ids})[0]))
    got = fluid.channel_recv(ch)
    g.wait(timeout=600)
    secs = time.perf_counter() - t0
    fluid.channel_close(ch)
    check(isinstance(got, torch.Tensor) and got.device == want.device
          and torch.equal(got, want), "aot_native: the logits a go block "
          "sent differ from the main thread's")
    return {"bit_equal": True, "device": str(got.device),
            "round_trip_s": secs}


def _aot_moe(place, root, tally):
    """The MoE LM's forward (the moe phase's configuration, amp)
    exported and reloaded on the card: AOT_MOE_LAYERS route op nodes, as many
    route launches a call, logits at the bf16 bar against the
    Executor's forward; the artifact's calls counted in `tally`."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.kernels.moe_dispatch import moe_gate_dispatch
    from paddle_tpu_torch.models.moe import build_moe_lm

    op_name = "paddle_tpu_torch.moe_gate_route.default"
    fluid.amp.enable_bf16()     # before the Program is built
    exe = None
    try:
        fw.reset_unique_names()
        main, startup, _ = build_moe_lm(M_BATCH, M_SEQ, M_VOCAB, M_D,
                                        M_HEADS, AOT_MOE_LAYERS, M_EXPERTS,
                                        M_TOPK, M_CF, aux_weight=M_AUX)
        logits = next(op.input("Logits")[0]
                      for op in main.global_block().ops
                      if op.type == "softmax_with_cross_entropy")
        scope = Scope()
        exe = fluid.Executor(place, seed=SEED)
        exe.run(startup, scope=scope)
        ids = np.random.RandomState(SEED + 1).randint(
            0, M_VOCAB, (M_BATCH, M_SEQ)).astype(np.int64)
        call, rec = _aot_roundtrip(exe, main, scope, logits,
                                   {"ids": ([M_BATCH, M_SEQ], "int64")},
                                   root, "moe_lm", place)
        targets = _graph_targets(call)
        call = tally.wrap(call)
        check(targets.get(op_name) == AOT_MOE_LAYERS, f"aot_native: the MoE "
              f"graph holds {targets.get(op_name)} route op nodes (want "
              f"{AOT_MOE_LAYERS})")
        before = moe_gate_dispatch.launches
        got = call({"ids": ids})[0]
        torch.cuda.synchronize()
        per_call = moe_gate_dispatch.launches - before
        check(per_call == AOT_MOE_LAYERS, f"aot_native: one call of the MoE "
              f"artifact launched the route kernel {per_call} times "
              f"(want {AOT_MOE_LAYERS})")
        infer = io.get_inference_program([logits], main)
        want = [exe.run(infer, feed={"ids": ids}, fetch_list=[logits],
                        scope=scope, return_numpy=False)[0]
                for _ in range(3)][-1]
        ok, lim, rms, rms_lim = _close_bf16(got.float(), want.float())
        err = float((got.float() - want.float()).abs().max())
        check(ok, f"aot_native: MoE artifact logits {err} (rms {rms}) "
              f"from the Executor's (limits {lim}, {rms_lim})")
        rec.update(route_op_nodes=AOT_MOE_LAYERS, route_launches_a_call=per_call,
                   max_abs_err_vs_executor=err, rms_err_vs_executor=rms,
                   limit=lim, rms_limit=rms_lim,
                   executor_bit_equal=bool(torch.equal(got, want)),
                   artifact_ms=_wall_ms(lambda: call({"ids": ids})),
                   executor_replay_ms=_wall_ms(lambda: exe.run(
                       infer, feed={"ids": ids}, fetch_list=[logits],
                       scope=scope, return_numpy=False)))
        return rec
    finally:
        fluid.amp.disable_bf16()
        if exe is not None:
            exe.close()
        torch.cuda.empty_cache()


def _resnet50_infer():
    """image_serve's ResNet-50 (bf16) -> (main, startup, logits: the
    classifier's output, the softmax's input)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, R_IMG, R_IMG],
                                dtype="bfloat16")
        probs = fluid.models.resnet_imagenet(img, class_dim=R_CLASSES,
                                             depth=R_DEPTH)
    soft, = [op for op in main.global_block().ops
             if op.type == "softmax" and op.output("Out") == [probs.name]]
    return main, startup, main.global_block().var(soft.input("X")[0])


def _aot_resnet_and_capi(place, root):
    """ResNet-50 exported at AOT_BATCH and reloaded (within SRV_ULPS of
    the Executor's replayed step; unchanged when the scope is zeroed
    after the export), then saved with save_inference_model and run
    through the C ABI on the card: from a fresh interpreter through
    ctypes, and from a standalone C host where the interpreter has a
    shared libpython."""
    import site

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io, native
    from paddle_tpu_torch.core.scope import Scope

    main, startup, predict = _resnet50_infer()
    scope = Scope()
    exe = fluid.Executor(place, seed=SEED)
    try:
        exe.run(startup, scope=scope)
        x32 = np.random.RandomState(SEED).rand(
            AOT_BATCH, 3, R_IMG, R_IMG).astype(np.float32)
        x = torch.from_numpy(x32).to(torch.bfloat16).to(exe.device)
        infer = io.get_inference_program([predict], main)
        run = lambda: exe.run(infer, feed={"img": x},  # noqa: E731
                              fetch_list=[predict], scope=scope,
                              return_numpy=False)[0]
        want = [run() for _ in range(3)][-1].float().cpu().numpy()
        exe_ms = _wall_ms(run)
        model_dir = os.path.join(root, "resnet50_model")
        io.save_inference_model(model_dir, ["img"], [predict], exe,
                                main_program=main, scope=scope)
        call, rec = _aot_roundtrip(
            exe, main, scope, predict,
            {"img": ([AOT_BATCH, 3, R_IMG, R_IMG], "bfloat16")}, root,
            "resnet50", place)
        got = call({"img": x})[0]
        worst = _ulps_of_rows(got.float().cpu().numpy(), want)
        check(got.device == exe.device and worst <= SRV_ULPS,
              f"aot_native: the ResNet-50 artifact is {worst} bf16 ulps "
              f"of a row's max from the Executor's (limit {SRV_ULPS})")
        for n in _persistables(main):
            v = scope.find_var(n)
            scope.set_var(n, torch.zeros_like(v))
        again = call({"img": x})[0]
        check(torch.equal(again, got), "aot_native: zeroing the scope "
              "after the export changed the artifact's logits")
        rec.update(batch=AOT_BATCH, max_err_bf16_ulps=worst,
                   limit_bf16_ulps=SRV_ULPS,
                   unchanged_after_scope_zeroed=True,
                   artifact_ms=_wall_ms(lambda: call({"img": x})),
                   executor_replay_ms=exe_ms)
        del call, got, again
    finally:
        exe.close()
        torch.cuda.empty_cache()

    src = os.path.join(root, "capi_in.f32")
    x32.tofile(src)
    dims = [str(d) for d in x32.shape]
    t0 = time.perf_counter()
    so = native.capi_library()
    capi = {"library": os.path.basename(so),
            "build_s": time.perf_counter() - t0,
            "shared_libpython": native.shared_libpython()}
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root, *site.getsitepackages(),
         *[p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]])
    # the session's place: the card by default (CPUPlace only where this
    # phase is rehearsed on the CPU)
    device = "cpu" if isinstance(place, fluid.CPUPlace) else "cuda:0"
    env.pop("PADDLE_TPU_CAPI_PLACE", None)
    if device == "cpu":
        env["PADDLE_TPU_CAPI_PLACE"] = "cpu"
    hosts = [("ctypes", [sys.executable, "-c", _CAPI_CHILD, so])]
    if capi["shared_libpython"]:
        t0 = time.perf_counter()
        hosts.append(("c_host", [native.build_capi_host()]))
        capi["c_host_build_s"] = time.perf_counter() - t0
    procs = []      # the hosts run at once, each its own process
    t0 = time.perf_counter()
    try:
        for kind, cmd in hosts:
            dst = os.path.join(root, f"capi_out_{kind}.f32")
            args = ([model_dir, "img", src, dst] if kind == "c_host"
                    else [model_dir, src, dst])
            procs.append((kind, dst, subprocess.Popen(
                cmd + args + dims, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env)))
        for kind, dst, proc in procs:
            stdout, stderr = proc.communicate(timeout=600)
            secs = time.perf_counter() - t0
            lines = stdout.strip().splitlines()
            check(proc.returncode == 0 and lines
                  and lines[-1] == f"ok 2 {AOT_BATCH} {R_CLASSES}",
                  f"aot_native: the C ABI through {kind} failed (rc "
                  f"{proc.returncode}): {stdout[-1500:]} {stderr[-3000:]}")
            if kind == "ctypes":
                check(f"device={device}" in lines,
                      f"aot_native: the C ABI session ran on {lines}")
            out = np.fromfile(dst, dtype=np.float32).reshape(want.shape)
            worst = _ulps_of_rows(out, want)
            check(worst <= SRV_ULPS, f"aot_native: the C ABI through "
                  f"{kind} is {worst} bf16 ulps of a row's max from the "
                  f"Executor's (limit {SRV_ULPS})")
            capi[kind] = {"max_err_bf16_ulps": worst, "process_s": secs,
                          "device": device, "concurrent": len(hosts) > 1}
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    capi["ran"] = [k for k, _ in hosts]
    return rec, capi


def _aot_native_pipeline(place):
    """ResNet-50 (bf16) training, NP_STEPS steps at NP_BATCH, fed through
    reader.native_pipeline (FIFO) and fed the same batches directly,
    from one startup state: the losses and every state bit-equal.  The
    loader's batches/s alone against the step rate."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import reader
    from paddle_tpu_torch.core.scope import Scope

    n = NP_BATCH * NP_STEPS
    rng = np.random.RandomState(SEED)
    imgs = rng.rand(n, 3, R_IMG, R_IMG).astype(np.float32)
    labels = rng.randint(0, R_CLASSES, (n, 1)).astype(np.int64)

    def samples():
        for i in range(n):
            yield imgs[i], labels[i]

    slots = [((3, R_IMG, R_IMG), np.float32), ((1,), np.int64)]
    pipe = reader.native_pipeline(samples, slots, NP_BATCH)
    t0 = time.perf_counter()
    batches = list(pipe())
    loader_s = time.perf_counter() - t0
    direct = [(imgs[i:i + NP_BATCH], labels[i:i + NP_BATCH])
              for i in range(0, n, NP_BATCH)]
    check(len(batches) == NP_STEPS and all(
        np.array_equal(a, c) and np.array_equal(b, d)
        for (a, b), (c, d) in zip(batches, direct)),
        "aot_native: native_pipeline's batches differ from the samples "
        "stacked in order")
    main, startup, loss = _image_program(f"resnet{R_DEPTH}", R_IMG,
                                         R_CLASSES, "bfloat16")
    scope = Scope()
    exe = fluid.Executor(place, seed=SEED)
    exe.run(startup, scope=scope)
    init = _state_of(main, scope)
    exe.close()
    runs = {}
    for kind in ("direct", "native_pipeline"):
        for name, v in init.items():
            scope.set_var(name, v.clone())
        exe = fluid.Executor(place, seed=SEED)
        feeds = iter(pipe()) if kind == "native_pipeline" else iter(direct)
        losses, secs = [], []
        try:
            for img, label in feeds:
                t0 = time.perf_counter()
                losses.append(exe.run(main, feed={
                    "img": torch.from_numpy(img).to(torch.bfloat16),
                    "label": label}, fetch_list=[loss], scope=scope)[0])
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        finally:
            exe.close()
        runs[kind] = {"losses": [float(np.asarray(v).reshape(-1)[0])
                                 for v in losses],
                      "step_s": secs, "state": _state_of(main, scope)}
    a, b = runs["direct"], runs["native_pipeline"]
    differ = _states_equal(b["state"], a["state"])
    check(len(b["losses"]) == NP_STEPS and a["losses"] == b["losses"]
          and not differ, f"aot_native: native_pipeline-fed losses "
          f"{b['losses']} against direct {a['losses']}; states differ in "
          f"{differ[:5]}")
    torch.cuda.empty_cache()
    replayed = b["step_s"][2:]
    return {"model": f"resnet{R_DEPTH}", "batch": NP_BATCH,
            "steps": NP_STEPS, "losses": b["losses"],
            "losses_bit_equal": True, "states_bit_equal": True,
            "loader_batches_per_s": NP_STEPS / loader_s,
            "replayed_steps_per_s": len(replayed) / sum(replayed),
            "step_s": b["step_s"], "direct_step_s": a["step_s"]}


def aot_native_phase(card, dev, place):
    """A10b on the card: the flash op's host cost against the direct
    call; the LM and MoE LM artifacts (`_aot_lm`, `_aot_moe`); ResNet-50's
    artifact and the C ABI (`_aot_resnet_and_capi`); native_pipeline
    feeding ResNet-50 training (`_aot_native_pipeline`) -> the launches
    made through the loaded artifacts, {"fwd": flash forward, "moe":
    route kernel}."""
    from paddle_tpu_torch import native
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels.moe_dispatch import moe_gate_dispatch

    t0 = time.perf_counter()
    native.lib()
    build_s = time.perf_counter() - t0
    host = _flash_op_host_us(dev)
    root = tempfile.mkdtemp(prefix="aot_native_")
    try:
        # the main path: the loaded artifacts' calls on the card, counted
        # from 0 (the Executor references beside them launch the same
        # kernels at a miss and a capture: not counted)
        fa.flash_attention.launches["fwd"] = 0
        moe_gate_dispatch.launches = 0
        flash = _Tally(lambda: fa.flash_attention.launches["fwd"])
        route = _Tally(lambda: moe_gate_dispatch.launches)
        lm = _aot_lm(place, root, flash)
        moe = _aot_moe(place, root, route)
        launches = {"fwd": flash.n, "moe": route.n}
        check(flash.n > 0 and route.n > 0, f"aot_native: the artifacts "
              f"launched the flash forward {flash.n} and the route kernel "
              f"{route.n} times")
        resnet, capi = _aot_resnet_and_capi(place, root)
        pipeline = _aot_native_pipeline(place)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "aot_native", "card": card,
          "native_build_s": build_s, "flash_op_host_us": host,
          "lm": lm, "moe": moe, "resnet50": resnet, "capi": capi,
          "native_pipeline": pipeline, "artifact_launches": launches,
          "phase_s": time.perf_counter() - t0,
          "timing": "host clock around each call + synchronize, median "
                    f"of {AOT_REPS} after a warm call (artifact_ms, "
                    "executor_replay_ms); the flash op's host time: "
                    f"{AOT_HOST_CALLS} calls back to back, no sync, in "
                    "turns direct/op/op/direct; the artifacts on the "
                    "machine's local temporary directory (a warm page "
                    "cache)"})
    return launches



# -- tools phase: the CLI jobs, checkgrad, the device profiler, the
# debugger (A10c) ----------------------------------------------------------

# profile_compiled_ops's replayed steps; the 2 % bar between its table's
# total and _profile_step's device time over as many replayed steps; the
# share of the table's device time that must carry an op scope
TOOLS_STEPS, TOOLS_TOTAL_RTOL, TOOLS_SCOPED = 3, 0.02, 0.95
# the CLI's translator: batches of the train job, the time job, and the
# test job (test_reader); the time job's ms a batch against the seq2seq
# phase's replayed step
CLI_TRAIN, CLI_TIME, CLI_TEST, CLI_TIME_RATIO = 4, 5, 2, 1.5
# checkgrad's per-sample numeric gradients, default mode against the
# interpreter
CHECKGRAD_RTOL = 1e-6
_FLASH_KINDS = {"fwd": "fwd_kernel<", "dq": "dq_kernel<",
                "dkv": "dkv_kernel<"}
_FLASH_SCOPES = {"fwd": "flash_attention:", "dq": "flash_attention_grad:",
                 "dkv": "flash_attention_grad:"}


def _tools_profiler(card, exe, main, run):
    """The tools phase's profiler and host-tools parts on the train
    phase's LM, its replayed graph live (`run(step)` one more replayed
    step): profile_compiled_ops over TOOLS_STEPS replays (each flash
    kernel 3 x 12 calls under its op's scope, TOOLS_SCOPED of the device
    time scoped, the total within TOOLS_TOTAL_RTOL of _profile_step's
    device time over as many replays), xla_profiler's trace of one
    replay (the three flash kernels named in it), program_to_code and
    draw_block_graphviz over the training Program (one op node an op),
    and the per-op ranges' host cost: TOOLS_STEPS interpreted steps
    without them and with them installed (no capture running)
    -> the record of the tools line's "profiler" part; its seconds are
    set aside from the train line's."""
    from paddle_tpu_torch import debugger, profiler
    from paddle_tpu_torch.core.execution import op_scopes

    t0 = time.perf_counter()
    phase = "tools"
    ops = main.global_block().ops
    n_attn = sum(op.type == "flash_attention" for op in ops)
    replay = lambda: run(G_STEPS)  # noqa: E731
    t1 = time.perf_counter()
    rows = profiler.profile_compiled_ops(replay, steps=TOOLS_STEPS,
                                         print_table=False)
    table_s = time.perf_counter() - t1
    print(profiler.format_op_table(rows, limit=15), flush=True)
    flash = {}
    for kind, pat in _FLASH_KINDS.items():
        mine = [r for r in rows if pat in r["name"]]
        flash[kind] = {"calls": sum(r["calls"] for r in mine),
                       "rows": len(mine),
                       "total_ms": sum(r["total"] for r in mine) * 1e3,
                       "scopes": sorted({r["scope"] for r in mine})}
        check(flash[kind]["calls"] == TOOLS_STEPS * n_attn,
              f"{phase}: {flash[kind]['calls']} {kind} kernels in the "
              f"table over {TOOLS_STEPS} replays, want "
              f"{TOOLS_STEPS} x {n_attn}")
        check(all(sc.startswith(_FLASH_SCOPES[kind])
                  for sc in flash[kind]["scopes"]),
              f"{phase}: {kind} kernels under scopes "
              f"{flash[kind]['scopes']}, want {_FLASH_SCOPES[kind]}...")
    total_ms = sum(r["total"] for r in rows) * 1e3
    scoped_ms = sum(r["total"] for r in rows if r["scope"]) * 1e3
    check(scoped_ms >= TOOLS_SCOPED * total_ms,
          f"{phase}: {scoped_ms} of the table's {total_ms} device ms carry "
          f"an op scope, want at least {TOOLS_SCOPED}")
    prof = _profile_step(lambda: [replay() for _ in range(TOOLS_STEPS)],
                         ("flash_attention", "matmul"), phase)
    total_rel = abs(total_ms - prof["device_ms"]) / prof["device_ms"]
    check(total_rel <= TOOLS_TOTAL_RTOL,
          f"{phase}: the table's total {total_ms} ms against "
          f"_profile_step's {prof['device_ms']} device ms over "
          f"{TOOLS_STEPS} replays ({total_rel} apart)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with profiler.xla_profiler(tmp) as log_dir:
            replay()
        path = os.path.join(log_dir, "trace.json")
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
        trace_bytes = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = {k: sum(pat in n for n in names)
             for k, pat in _FLASH_KINDS.items()}
    check(all(found.values()), f"{phase}: xla_profiler's trace names the "
          f"flash kernels {found}")
    t1 = time.perf_counter()
    code = debugger.program_to_code(main)
    code_s = time.perf_counter() - t1
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dot_")
    try:
        t1 = time.perf_counter()
        dot = debugger.draw_block_graphviz(
            main.global_block(), path=os.path.join(tmp, "lm.dot"))
        dot_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(dot.count("shape=box") == len(ops),
          f"{phase}: the .dot holds {dot.count('shape=box')} op nodes for "
          f"{len(ops)} ops")

    def interpreted():
        secs = []
        for _ in range(TOOLS_STEPS):
            t1 = time.perf_counter()
            exe.run(main, feed=_train_feed(G_STEPS), compiled=False)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
        return float(np.median(secs)) * 1e3

    ranges_off = interpreted()
    with op_scopes(profiler._range):
        ranges_on = interpreted()
    seconds = time.perf_counter() - t0
    _aside(seconds)
    return {"phase": phase, "part": "profiler", "card": card,
            "model": "the train phase's LM (run_ridge, amp, 12 layers)",
            "replayed_steps": TOOLS_STEPS, "table_rows": len(rows),
            "table_s": table_s,
            "top_rows": [[r["name"][:120], r["scope"], r["calls"],
                          r["total"] * 1e3] for r in rows[:15]],
            "flash": flash, "table_total_ms": total_ms,
            "scoped_ms": scoped_ms, "scoped_share": scoped_ms / total_ms,
            "profile_step_device_ms": prof["device_ms"],
            "total_rel_diff": total_rel,
            "trace_flash_kernel_names": found,
            "trace_kernel_names": len(names), "trace_bytes": trace_bytes,
            "ops": len(ops), "program_to_code_lines": code.count("\n") + 1,
            "program_to_code_s": code_s, "dot_op_nodes":
                dot.count("shape=box"), "dot_bytes": len(dot),
            "draw_block_graphviz_s": dot_s,
            "interpreted_ms_ranges_off": ranges_off,
            "interpreted_ms_ranges_on": ranges_on, "seconds": seconds,
            "timing": "profile_compiled_ops over replays of the train "
                      "phase's captured step (CUPTI kernel times; the "
                      "replay's kernels scoped by an eager re-run of its "
                      "plan); _profile_step over as many replays; host "
                      "clock for the host tools; the ranges' cost: the "
                      "median of TOOLS_STEPS interpreted steps each way "
                      "(host clock + synchronize), no capture running"}


_CLI_S2S_CONFIG = """
import numpy as np
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models.transformer import transformer_translate

V, D, H, L, N, B = {vocab}, {d}, {heads}, {layers}, {length}, {batch}


def _feed(seed):
    # run_seq2seq's feed (:117-126): the same batch every step
    r = np.random.RandomState(seed)
    shape = (B, N)
    return {{"src": r.randint(0, V, shape).astype(np.int64),
            "tgt": r.randint(0, V, shape).astype(np.int64),
            "lbl": r.randint(0, V, shape + (1,)).astype(np.int64)}}


def build():
    fluid.amp.enable_bf16()     # run_seq2seq --dtype bfloat16
    src = fluid.layers.data(name="src", shape=[N], dtype="int64")
    tgt = fluid.layers.data(name="tgt", shape=[N], dtype="int64")
    lbl = fluid.layers.data(name="lbl", shape=[N, 1], dtype="int64")
    logits = transformer_translate(
        src, tgt, V, V, d_model=D, n_heads=H, n_layers=L, dropout_rate=0.0,
        is_test=False, return_logits=True, remat=False)
    loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        fluid.layers.reshape(logits, shape=[-1, V]),
        fluid.layers.reshape(lbl, shape=[-1, 1])))

    def reader():
        for _ in range({train}):
            yield _feed(0)

    def test_reader():
        for i in range({test}):
            yield _feed(1 + i)

    return {{"loss": loss, "reader": reader, "test_reader": test_reader,
            "optimizer": fluid.Adam(learning_rate=1e-4),
            "infer_targets": [logits], "feed_order": ["src", "tgt"]}}
"""

_CLI_FC_CONFIG = """
import numpy as np
import paddle_tpu_torch as fluid


def build():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))

    def reader():
        r = np.random.RandomState(0)
        w = np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)
        for _ in range(8):
            xb = r.rand(16, 4).astype(np.float32)
            yield {"x": xb, "y": xb @ w}

    return {"loss": loss, "reader": reader,
            "optimizer": fluid.SGD(learning_rate=0.1),
            "infer_targets": [pred], "feed_order": ["x", "y"]}
"""


def _cli(argv):
    """paddle_tpu_torch.cli.main(argv) in this process, bf16 amp off
    again after it (the translator's config turns it on) -> the job's
    result."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import cli

    try:
        return cli.main(argv)
    finally:
        fluid.amp.disable_bf16()


def _cli_translator(card, place, s2s_ms, root, cfg):
    """(a): run_seq2seq's translator through the CLI: train CLI_TRAIN
    batches with --save_dir, test on that pass, time CLI_TIME batches,
    merge; the test program re-run on the trained scope, the merged
    model served, one replayed step profiled; the time job once more as
    a subprocess -> (the record, the wrappers' launches over the jobs)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    phase = "tools"
    save, merged = os.path.join(root, "save"), os.path.join(root, "merged")
    base = ["--config", cfg]
    launches = flash_attention.launches
    for key in launches:
        launches[key] = 0
    secs = {}

    t0 = time.perf_counter()
    tr = _cli([*base, "--job", "train", "--batches_per_pass",
               str(CLI_TRAIN), "--save_dir", save, "--log_period", "1"])
    secs["train"] = time.perf_counter() - t0
    train_launches = dict(launches)
    n_attn = sum(op.type == "flash_attention"
                 for op in tr["cfg"]["main"].global_block().ops)
    want = {k: 2 * n_attn for k in launches}     # the eager run, capture
    check(train_launches == want, f"{phase}: the train job's flash "
          f"launches {train_launches}, want {want} (eager and capture)")
    g = tr["exe"].graph_stats()
    check(g["captures"] == 1 and g["replays"] == CLI_TRAIN - 2,
          f"{phase}: the train job's graphs {g}")
    pass_dir = os.path.join(save, "pass-00000")

    t0 = time.perf_counter()
    te = _cli([*base, "--job", "test", "--init_model_path", pass_dir])
    secs["test"] = time.perf_counter() - t0
    # one more run of the trained scope's test program, bit for bit
    mod = cli._load_config(cfg)
    prev = executor_mod.switch_scope(tr["scope"])
    fluid.amp.enable_bf16()
    try:
        test_cfg = cli._build(mod)
        test_prog = test_cfg["main"].clone(for_test=True)
        exe = fluid.Executor(place)
        again = [float(exe.run(test_prog, feed=feed,
                               fetch_list=[test_cfg["loss"]])[0]
                       .reshape(-1)[0])
                 for feed in test_cfg["test_reader"]()]
        feed = next(iter(test_cfg["test_reader"]()))
        forward = exe.run(test_prog, feed=feed,
                          fetch_list=test_cfg["infer_targets"],
                          return_numpy=False)[0].clone()
        exe.close()
    finally:
        fluid.amp.disable_bf16()
        executor_mod.switch_scope(prev)
    check(te["costs"] == again, f"{phase}: the test job's losses "
          f"{te['costs']}, the trained scope's test program's {again}")
    te["exe"].close()

    t0 = time.perf_counter()
    _cli([*base, "--job", "merge", "--init_model_path", pass_dir,
          "--save_dir", merged])
    secs["merge"] = time.perf_counter() - t0
    scope = fluid.Scope()
    prev = executor_mod.switch_scope(scope)
    fluid.amp.enable_bf16()
    try:
        exe = fluid.Executor(place)
        prog, feeds, fetches = fluid.io.load_inference_model(
            merged, exe, model_filename="__model__",
            params_filename="__params__")
        served = exe.run(prog, feed={n: feed[n] for n in feeds},
                         fetch_list=fetches, return_numpy=False)[0]
        exe.close()
    finally:
        fluid.amp.disable_bf16()
        executor_mod.switch_scope(prev)
    check(served.is_cuda and torch.equal(served, forward),
          f"{phase}: the merged model's logits differ from the test "
          "program's forward")

    # a replayed step of the train job's graph: 18 of each flash kernel
    kinds = _FLASH_KINDS
    tr_cfg = tr["cfg"]
    prev = executor_mod.switch_scope(tr["scope"])
    fluid.amp.enable_bf16()
    try:
        before = dict(launches)
        feed = next(iter(tr_cfg["reader"]()))
        prof = _profile_step(lambda: tr["exe"].run(
            tr_cfg["main"], feed=feed, fetch_list=[tr_cfg["loss"]]),
            ("flash_attention", "matmul"), phase, kinds=kinds)
        check(dict(launches) == before,
              f"{phase}: a wrapper ran during the profiled replay")
    finally:
        fluid.amp.disable_bf16()
        executor_mod.switch_scope(prev)
        tr["exe"].close()
    per_step = {k: n_attn for k in kinds}
    check(prof["kind_counts"] == per_step, f"{phase}: the train job's "
          f"replayed step ran flash kernels {prof['kind_counts']}, want "
          f"{per_step}")
    train_costs = tr["costs"][0]
    del tr, te
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tm = _cli([*base, "--job", "time", "--batches_per_pass", str(CLI_TIME)])
    secs["time"] = time.perf_counter() - t0
    time_ms = tm["ms_per_batch"]
    tm["exe"].close()
    del tm
    torch.cuda.empty_cache()
    ratio = time_ms / s2s_ms
    check(1 / CLI_TIME_RATIO <= ratio <= CLI_TIME_RATIO,
          f"{phase}: the time job's {time_ms} ms a batch against the "
          f"seq2seq phase's replayed {s2s_ms} ms (x{ratio})")
    total = dict(launches)

    t0 = time.perf_counter()
    sub = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.cli", *base, "--job",
         "time", "--batches_per_pass", str(CLI_TIME)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    secs["time_subprocess"] = time.perf_counter() - t0
    line = [ln for ln in sub.stdout.splitlines() if "ms/batch" in ln]
    check(sub.returncode == 0 and line, f"{phase}: `python -m "
          f"paddle_tpu_torch.cli --job=time` exited {sub.returncode}: "
          f"{sub.stderr[-2000:]}")
    sub_ms = float(line[-1].split()[1])
    return {"model": "run_seq2seq's translator (benchmark/run_seq2seq.py"
                     ":39-60 defaults, amp, Adam 1e-4)",
            "train_costs": train_costs, "test_costs": again,
            "test_bit_equal": True, "merged_bit_equal": True,
            "train_launches": train_launches,
            "replayed_step_kernels": prof["kind_counts"],
            "replayed_step_device_ms": prof["device_ms"],
            "time_ms_per_batch": time_ms, "seq2seq_ms_per_step": s2s_ms,
            "time_over_seq2seq": ratio, "time_subprocess_ms": sub_ms,
            "job_seconds": secs}, total


def _cli_checkgrad(root):
    """(b): --job=checkgrad on the small fc config, in the default mode
    and interpreted: both pass, their per-sample numeric gradients
    within CHECKGRAD_RTOL."""
    from paddle_tpu_torch.core import flags

    phase = "tools"
    cfg = os.path.join(root, "fc_config.py")
    with open(cfg, "w") as f:
        f.write(_CLI_FC_CONFIG)
    argv = ["--config", cfg, "--job", "checkgrad"]
    default = _cli(argv)
    flags.set_flags({"jit_granularity": "op"})
    try:
        interp = _cli(argv)
    finally:
        flags.set_flags({"jit_granularity": "block"})
    g = default["exe"].graph_stats()
    check(g["replays"] > 0, f"{phase}: checkgrad's default mode "
          f"replayed no graph: {g}")
    worst = 0.0
    for name, d in default["params"].items():
        i = interp["params"][name]
        check(np.array_equal(d["indices"], i["indices"])
              and np.all(d["numeric"] != 0),
              f"{phase}: checkgrad {name}: indices or zero gradients")
        rel = np.abs(d["numeric"] - i["numeric"]) / np.maximum(
            np.abs(i["numeric"]), 1e-30)
        worst = max(worst, float(rel.max()))
    check(worst <= CHECKGRAD_RTOL, f"{phase}: checkgrad's numeric "
          f"gradients {worst} apart, default mode against the interpreter")
    for r in (default, interp):
        r["exe"].close()
    return {"worst_rel_err_default": default["worst"],
            "worst_rel_err_interpreted": interp["worst"],
            "numeric_default_vs_interpreted": worst,
            "graph_stats": {k: g[k] for k in ("captures", "replays")}}


def tools_cli_phase(card, place, s2s_ms):
    """The tools phase's CLI part: (a) the translator's jobs, (b)
    checkgrad -> the wrappers' flash launches over (a)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        cfg = os.path.join(root, "s2s_config.py")
        with open(cfg, "w") as f:
            f.write(_CLI_S2S_CONFIG.format(
                vocab=S_VOCAB, d=S_D, heads=S_HEADS, layers=S_LAYERS,
                length=S_LEN, batch=S_BATCH, train=CLI_TRAIN,
                test=CLI_TEST))
        translator, launches = _cli_translator(card, place, s2s_ms, root,
                                               cfg)
        checkgrad = _cli_checkgrad(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "tools", "part": "cli", "card": card,
          "translator": translator, "launches": launches,
          "checkgrad": checkgrad,
          "timing": "host clock around each job in this process (the "
                    "time job's own ms a batch: its clock read after a "
                    "device synchronize); the subprocess's as it prints"})
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)
    from paddle_tpu_torch.kernels import cuda_build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_update as fu
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, peaks = card_peaks(name)
    flops = peaks[torch.float32]
    card = {"name": name, "nvidia_smi": smi}
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "card": card, "peak_bytes_per_s": bw, "peak_fp32_flops": flops,
          "peak_bf16_tensor_flops": peaks[torch.bfloat16],
          "peak_tf32_tensor_flops": peaks["tf32"]})

    t0 = time.perf_counter()
    cuda_build.build_all()
    for mod in (pa, fa, fu, md):
        mod.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "counts": cuda_build.build_counts(),
          "ptxas": {src: _ptxas_summary(cuda_build.build_log(src))
                    for src in (pa.SOURCE, fa.SOURCE, fu.SOURCE,
                                md.SOURCE)}})

    cases = kernels_phase(dev, bw, flops)
    flash_cases = flash_phase(dev, bw, peaks)
    grads_flash, _ = grads_phase(dev)
    ops_phase(card, dev)
    ops_working_phase(card, dev)
    optimizers_phase(card, dev)
    from paddle_tpu_torch import CUDAPlace

    # the main path runs bf16 amp, the reference cells' mode
    flash_launches, flash_replayed, tools_profile = train_phase(
        card, CUDAPlace(0), peaks, flash_cases, amp=True, tools=True)
    emit(tools_profile, aside=True)     # the tools phase's profiler part
    fp32_launches, _, _ = train_phase(card, CUDAPlace(0), peaks,
                                      flash_cases, amp=False)
    lm_dropout_phase(card, CUDAPlace(0), dev, flash_cases)
    s2s_launches, s2s_replayed, s2s_ms = seq2seq_phase(
        card, CUDAPlace(0), peaks, flash_cases)
    tools_launches = tools_cli_phase(card, CUDAPlace(0), s2s_ms)
    launches = serve_phases(card, CUDAPlace(0))
    fused_launches, largest = dp_phase(card, CUDAPlace(0), peaks)
    fused_cases = fused_update_phase(dev, bw, flops, largest)
    moe_cases = moe_kernel_phase(dev, bw, flops)
    moe_launches, moe_bwd_launches, moe_replayed = moe_phase(
        card, CUDAPlace(0), peaks, moe_cases)
    resnet50_phase(card, CUDAPlace(0), peaks)
    resnet_card_vs_cpu_phase(card, CUDAPlace(0))
    vgg_segmented_phase(card, CUDAPlace(0))
    dropout_rows_phase(card, dev)
    image_models_phase(card, CUDAPlace(0), peaks)
    ctr_phase(card, CUDAPlace(0))
    rnn_phase(card, CUDAPlace(0), peaks)
    book08_phase(card, CUDAPlace(0), peaks)
    book07_phase(card, CUDAPlace(0))
    dp_gspmd_phase(card, CUDAPlace(0))
    tz_launches = tp_zero_phase(card)
    a9_launches = a9_phase(card)
    ssd_phase(card, CUDAPlace(0), peaks)
    ocr_ctc_phase(card, CUDAPlace(0))
    readers_phase(card, CUDAPlace(0))
    remat_flash = remat_phase(card, CUDAPlace(0))
    plan_steps = memory_plan_phase(card, CUDAPlace(0))
    analysis_phase(card, plan_steps, cases["fp32_w1"], bw)
    generate_phase(card, CUDAPlace(0))
    image_serve_phase(card, CUDAPlace(0))
    persist_flash = persist_phase(card, CUDAPlace(0))
    # the elastic phase's host pservers boot (one thread each) beside
    # conv_rest, aot_native and pserver, and serve once it starts
    el_procs = _ElasticProcs(
        tempfile.mkdtemp(prefix="chip_smoke_elastic_"), EL_PSERVERS)
    try:
        conv_rest_phase(card, dev, CUDAPlace(0))
        aot_launches = aot_native_phase(card, dev, CUDAPlace(0))
        # after aot_native, whose native pipeline builds the native
        # library the master and the registry run on
        ps_launches = pserver_phase(card)
        el_launches = elastic_phase(card, el_procs)
    finally:
        el_procs.close()    # a no-op once the elastic phase closed them
    fleet = fleet_phase(card, CUDAPlace(0))

    main_case = cases["fp32_w1"]    # the decode step's case
    entry = {"name": "paged_attention_decode", "route": "cuda",
             "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
             "replaces": "paddle_tpu/kernels/paged_attention.py:90",
             "launches": launches,
             "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
             **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "device_ms", "splits", "ctas")},
             "case": "fp32_w1", "cases": cases,
             "fleet_note": "the fleet phase's replicas decode through "
                           "this kernel in processes of their own; "
                           "each replica's wrapper counts there, and "
                           "fleet_launches holds each one's count since "
                           "its warmup, from its last stats",
             "fleet_launches": {
                 s["member"] or a: s["paged_attention_launches"]
                 for a, s in fleet["replicas"].items()},
             "fleet_cold_launches": fleet["cold"][
                 "paged_attention_launches"]}
    entries = [entry]
    src = "paddle_tpu_torch/kernels/csrc/flash_attention.cu"
    main_case = flash_cases["bf16_causal"]      # the amp train path's
    for kind, kname, line, err_keys in (
            ("fwd", "flash_attention_fwd", 63, ("fwd", "lse")),
            ("dq", "flash_attention_bwd_dq", 188, ("dq",)),
            ("dkv", "flash_attention_bwd_dkv", 239, ("dk", "dv"))):
        # SDPA computes the forward alone, but dQ, dK and dV only
        # together: the backward rows carry it, against dq + dkv
        sdpa_keys = (("sdpa_fwd_ms", "fwd_over_sdpa_fwd") if kind == "fwd"
                     else ("sdpa_bwd_ms", "bwd_ms", "bwd_over_sdpa_bwd"))
        per_case = {n: dict(c[kind], max_abs_err=max(
            c["max_abs_err"][e] for e in err_keys),
            peak_flops=c["peak_flops"], **{k: c[k] for k in sdpa_keys})
            for n, c in flash_cases.items()}
        lib = ({"library_ms": main_case["sdpa_fwd_ms"]} if kind == "fwd"
               else {"library_ms": None,
                     "library_bwd_ms": main_case["sdpa_bwd_ms"],
                     "bwd_ms": main_case["bwd_ms"]})
        entries.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
            "launches": flash_launches[kind],
            "replayed_per_step": flash_replayed[kind],
            "launches_note": _REPLAY_NOTE,
            "launches_train_fp32": fp32_launches[kind],
            "launches_seq2seq": s2s_replayed[kind],
            "launches_seq2seq_note": "the profiler's count in one replayed "
                                     "seq2seq step (6 encoder, 6 decoder "
                                     "and 6 cross attentions); the "
                                     "wrappers' count over its path is "
                                     "launches_seq2seq_wrapper",
            "launches_seq2seq_wrapper": s2s_launches[kind],
            "launches_persist": persist_flash[kind],
            "launches_tools": tools_launches[kind],
            "launches_tools_note": "the tools phase's CLI jobs on the "
                                   "seq2seq translator, in this process "
                                   "(the wrappers' count: the train, "
                                   "test and time jobs' eager runs and "
                                   "captures and the checks' runs; "
                                   "their replays launch the same "
                                   "kernels)",
            "launches_persist_note": "the persist phase's uninterrupted "
                                     "seq2seq Trainer run (the wrappers' "
                                     "count: its eager first step and its "
                                     "capture; the replays launch the "
                                     "same kernels)",
            "launches_remat_per_step": remat_flash["per_step"][kind],
            "replayed_remat_per_step":
                remat_flash["replayed_per_step"][kind],
            "graph_remat_per_step": remat_flash["graph_per_step"][kind],
            "launches_remat_note": "the remat phase's LM (every decoder "
                                   "block a recompute segment): the "
                                   "wrappers' count a step on its eager "
                                   "run and on its capture, and the "
                                   "captured graph's kernel nodes, which "
                                   "every replay launches (both held); "
                                   "the profiler's reading of one "
                                   "replayed step (read, not held)",
            **({"launches_aot": aot_launches["fwd"],
                "launches_aot_note": _AOT_NOTE} if kind == "fwd" else {}),
            "launches_tp_zero": tz_launches[kind],
            "launches_pserver": ps_launches[kind],
            "launches_pserver_note": _PS_NOTE,
            "launches_elastic": el_launches[kind],
            "launches_elastic_note": _EL_NOTE,
            "launches_a9": a9_launches[kind],
            "launches_a9_note": _A9_NOTE,
            "launches_tp_zero_note": "the tp_zero phase's amp run, each "
                                     "of its four ranks' wrapper count "
                                     "(3 interpreted steps, 12 layers: "
                                     "one a layer a step, on the rank's "
                                     "local heads)",
            "max_abs_err": per_case["bf16_causal"]["max_abs_err"],
            **{k: main_case[kind][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")},
            **lib, "case": "bf16_causal", "cases": per_case,
            "grad_op": grads_flash})
    main_case = fused_cases["largest_bucket"]
    entries.append({
        "name": "fused_bucket_sgd", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/fused_update.cu",
        "replaces": "paddle_tpu/kernels/fused_update.py:58",
        "launches": fused_launches,
        "max_abs_err": max(c["max_abs_err"] for c in fused_cases.values()),
        **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        "case": "largest_bucket", "cases": fused_cases})
    main_case = moe_cases["top2"]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    entries.append({
        "name": "moe_gate_dispatch", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/moe_dispatch.cu",
        "replaces": "paddle_tpu/kernels/moe_dispatch.py:68",
        "launches": moe_launches,
        "replayed_per_step": moe_replayed["moe"],
        "launches_note": _REPLAY_NOTE,
        "launches_aot": aot_launches["moe"],
        "launches_aot_note": _AOT_NOTE,
        "launches_a9": a9_launches["route"],
        "launches_a9_note": _A9_NOTE,
        "max_abs_err": max(c["max_abs_err"][k] for c in moe_cases.values()
                           for k in ("slot_weight", "combine", "aux")),
        **{k: main_case["route"][k] for k in keys},
        "form": "routing (the main path's); dense: the JAX contract",
        "dense": {k: main_case["dense"][k] for k in keys},
        "library_note": "no PyTorch call computes gate + capacity dispatch",
        "case": "top2", "cases": moe_cases})
    entries.append({
        "name": "moe_gate_dispatch_backward", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/moe_dispatch.cu",
        "replaces": "paddle_tpu/parallel/moe.py:48",
        "replaces_note": "no TPU kernel: the JAX package takes this "
                         "gradient by jax.vjp of moe_gate and the dispatch "
                         "einsum (its Pallas kernel has no VJP)",
        "launches": moe_bwd_launches,
        "launches_a9": a9_launches["route_backward"],
        "launches_a9_note": _A9_NOTE,
        "replayed_per_step": moe_replayed["moe_bwd"],
        "launches_note": _REPLAY_NOTE,
        "max_abs_err": max(c["max_abs_err"][k] for c in moe_cases.values()
                           for k in ("bwd_dx", "bwd_dgate_w")),
        **{k: main_case["backward"][k] for k in keys},
        "function_ms": main_case["backward"]["function_ms"],
        "dense_function_backward_ms":
            main_case["backward"]["dense_function_backward_ms"],
        "library_note": "no PyTorch call computes this gradient",
        "case": "top2"})
    emit({"phase": "timing", "phases": PHASE_SECONDS,
          "total_s": sum(w for _, _, w in PHASE_SECONDS)})
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp2-worker"]:
        # a rank of the dp_gspmd phase's dp2_one_card part
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _dp2_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--a9-worker"]:
        # a rank of the a9 phase
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _a9_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--pserver-worker"]:
        # a pserver (host) or a trainer (card) of the pserver phase
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _ps_log_to(sys.argv[3])
        _ps_worker(*sys.argv[2:])
        sys.exit(0)
    if sys.argv[1:2] == ["--elastic-worker"]:
        # an elastic pserver (host) of the elastic phase
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _el_worker(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--tp-zero-worker"]:
        # a rank of the tp_zero phase
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _tz_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
