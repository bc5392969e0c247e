#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. device: the card's name and power limit;
2. build: every kernel under deeplearning4j_tpu_torch/csrc/ with nvcc
   for sm_90a, one process per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card
   at the served path's shapes, with its time, the plain version's,
   one PyTorch library call's (a yardstick only; the port never calls
   it) and the least time the card could take (bound). The paged
   kernel runs over non-contiguous pool blocks with NaN in the null
   block and in every stale block tail;
4. end to end on the slot backend: the causal LM at the width
   documented in docs/generation.md (vocab 32000, d_model 512, 8
   layers, 8 heads, max_seq_len 1024, random weights from a seed)
   served by GenerationEngine(num_slots=32): ~32 concurrent requests,
   both kernels' launch counters must move, and a teacher-forced check
   against a CPU copy of the model holds each greedy token. The same
   requests then run on an engine with no CUDA graph (every prefill and
   decode step eager), and every token must be the graphs';
5. end to end on the paged backend: the same model served by the
   paged configuration of docs/generation.md (64 slots, 4096 blocks of
   16, chunks of 512, prefix sharing on): a primer that registers a
   320-token system prompt, 48 concurrent requests (32 of them behind
   that prompt) and 8 two-turn sessions. The paged kernel must launch
   once per layer and decode step, prefixes and sessions must hit,
   copy-on-write must run, the teacher-forced check must hold, and
   every block must come back to the pool. The primer and the burst
   then run on an engine with no CUDA graph (chunks, copies and decode
   steps eager), and every token must be the graphs';
6. int8 on the slot backend: phase 4's 32 requests served by
   GenerationEngine(num_slots=32, kv_dtype="int8"); the int8 decode
   kernel must launch once per layer and decode step, the flash kernel
   must run the prefills, and a teacher-forced check against the port's
   own int8 path on a CPU copy holds each greedy token;
7. int8 on the paged backend: phase 5's configuration and traffic with
   kv_dtype="int8", on a model copy whose MLP weights went through
   quantize_mlp_weights; the int8 paged kernel must launch once per
   layer and decode step, prefixes, sessions and copy-on-write must
   run, the int8 teacher-forced check must hold, and every block must
   come back;
8. flash backward: the dQ and dK/dV kernels against their plain
   versions over the prefill buckets (B=4, a ragged key mask and a
   fully masked row, which must give exactly 0), two calls of each
   bit-identical, then timed at the training shapes beside SDPA's
   backward, with their share of the 3xTF32-rate and f32-rate bounds;
   Then the bf16 legs of the three flash kernels (f32 from the same
   bf16 values in their plain versions) at phase 10's shapes (B=4, H=8,
   T=1024, D=64) and at B=1, causal and not, with a ragged key mask and
   a fully masked row (O and gradients exactly 0), two calls of each
   bit-identical, then each timed beside its bound at the bf16 rate,
   its plain version and SDPA at bf16 (its backward for dQ and dK/dV).
   The forward is also timed beside SDPA's bf16 forward with is_causal,
   and, like the dQ and dK/dV pair and the whole bf16 backward (delta,
   dQ, dK/dV), beside SDPA (with the mask and with is_causal) at B = 1
   and 4 and T = 1024, 2048 and 4096;
9. training: the served width in the layer DSL fitted through
   MultiLayerNetwork.fit (one warmup and five timed Adam steps of
   4 x 1024 tokens); each flash kernel must launch once per layer and
   step, the loss must fall, and a 2-block copy's loss and gradients on
   the card must match a CPU copy;
10. bf16 training: phase 9 with data_type("bfloat16") (the bf16
   mixed-precision policy: every layer but the output layer computes in
   bf16, the masters and Adam state stay f32); each bf16 flash leg must
   launch once per layer and step and the f32 legs never, the loss must
   fall, the masters and Adam state must stay f32, and a 2-block copy's
   loss and gradients on the card must match a CPU copy at bf16. Its
   profiled step splits device time into bf16 GEMMs, f32 GEMMs (the
   output layer), flash and the rest;
11. the fault ladder, on the warmed engines of phase 4 (slots, f32)
   and phase 7 (paged, int8) after their fault-free runs, through
   set_fault_injector (no warmup or capture added): phase 4's 32
   requests, and phase 7's primer and 48-request burst, again, each
   under one seeded FaultInjector plan with one transient fault
   (retried) and one corrupting fault (recovered) that lands while
   several lanes decode and, on the paged engine, while a two-chunk
   prompt is mid-chunk. No request may be lost, retries and recoveries
   must be one each, nothing may be captured, the decode kernel must
   launch once per layer and step, the slot engine's flash kernel once
   per layer and prefill (each re-admitted request re-prefilled once),
   the paged engine's chunks must outnumber a fault-free run's, every
   block must come back, and every lane's tokens must equal the same
   engine's fault-free tokens unless their first difference is a
   near-tie of the CPU reference at the phase's teacher tolerance. It
   prints how many lanes differed and the recovery's wall time (the
   fault to the last re-admitted lane's next token);
12. speculative decoding at k=4: (a) phase 4's engine and 32 requests
   with a same-config, same-seed copy of the target as the draft (the
   accept-heavy identity rig), then the same requests again under a
   corrupting verify fault (one recovery, none lost); (b) phase 5's
   engine and traffic (primer, burst, sessions) with make_draft_lm's
   default draft (d_model 32, one layer, 2 heads of 16: reject-heavy).
   Each engine must capture its graph plan at warmup (with the decode
   step and the draft's k-step proposal, the prime buckets and the
   verify spans) and none after, the draft's B1
   launches must be its layers x k x proposal calls and B3 must run its
   primes, and every lane's tokens must equal phase 4's or 5's unless
   their first difference is a near-tie of the CPU reference. It prints
   the accept rate, verify batches, rollbacks, draft fallbacks,
   tokens/s, decode step p50/p99, the draft call's and the verify's
   p50, and on the paged engine how many verify spans met a shared
   block in the copy-on-write guard;
13. bf16 on the slot backend: phase 4's 32 requests served by
   GenerationEngine(num_slots=32, kv_dtype="bf16"): the f32/bf16
   decode kernel's bf16 leg must launch once per layer and decode step,
   and a teacher-forced check against the port's own bf16 path on a
   CPU copy holds each greedy token;
14. the hierarchical KV tier (docs/generation.md's offload knobs: a
   host budget, a disk ring in a temp file, prefetch on) on phase 5's
   paged configuration with a pool that pins about three sessions: 32
   two-turn sessions (turn 1 of 100-400 tokens, half behind phase 5's
   system prompt; 32-64 new tokens a turn, every eighth sampled; all
   first turns as one burst, then all second turns), at f32 and on
   phase 7's int8 copy. The host budget (a quarter of the f32 working
   set) makes runs spill to the ring, which is large enough that none
   drops. Warmup must capture phase 5's plan plus a gather and a
   scatter per run bucket and nothing after; sessions and px: prefix
   entries must demote and restore, with no failed demotion or
   restore, spills at f32 and no drop; every turn 2 must be a session
   hit (no evicted session re-prefilled); the paged kernel must launch
   once per layer and decode step and nothing else; each lane's tokens
   must equal those of an engine with no offload and a pool that evicts
   nothing unless their first difference is a near-tie of the CPU
   reference; two restored greedy turn-2 lanes are held to a CPU copy
   (teacher-forced); after offload_sessions, clear_prefix_cache and
   clear_offload every block must be back and both tiers empty, and
   the ring file must be gone after stop. It prints demote and restore
   ms, prefetch hits, host bytes per demoted token and sessions per
   host GiB (f32 beside int8), a 64-block run's captured gather and
   scatter replayed alone, and the restored turn-2 TTFT p50 beside
   phase 5's (7's) hot-session turn-2 TTFT p50 (not gated);
15. traced serving (request tracing and the Prometheus text), on warmed
   engines of earlier phases, adding no warmup: (a) phase 4's engine
   and 32 requests and (b) phase 5's engine and whole traffic (primer,
   burst, both session turns, from emptied prefix and session caches
   each time) each run four times in turns, untraced, traced, traced,
   untraced, a fresh enabled Tracer tracing every request of a traced
   turn; (c) one traced greedy request on phase 12a's speculating
   engine; (d) phase 14's f32 run traces its turn-2 requests. Every
   turn's tokens must be the phase's first run's, nothing may be
   captured, the decode kernel must launch once per layer and decode
   step (counters set to 0 just before), and every traced request must
   have one admission span ("admitted"), one closed queue span, a
   prefill span, one decode span whose steps are its token count, one
   step_pipeline span on a pipelining engine and no open span; in (b)
   every request behind the system prompt or resuming a session a
   prefix_match span; in (c) draft and verify spans with 4 proposals a
   round, and the tokens of phase 12's own run; in (d) one
   offload_restore span per session restore of turn 2, and at least
   one. The engines' stats() rendered as Prometheus text
   (prometheus_text) must parse, each family typed once, with the
   generated-token counter equal to stats(). It prints tokens/s per
   turn, trace_overhead_frac (mean untraced over mean traced tokens/s,
   minus 1) with its spread (not gated), spans, families and the wall
   seconds the phase added.
16. the serving shell over HTTP (InferenceServer on its default asyncio
   backend): (a) generators "lm" (phase 4's engine configuration) and
   "plm" (phase 5's) on a model from phase 4's seed, warmed, serve
   phase 4's 32 requests from 32 threads of a client process (so the
   clients share no interpreter lock with the server), half of them
   streamed, then phase 5's primer and 48-request burst; phase 4's
   requests are also rerun none streamed, all streamed, and from
   threads inside the server's process (informative). Every lane's tokens must
   be phases 4 and 5's first runs' unless their first difference is a
   near-tie of the CPU reference (phase 11's rule); B1 must launch once
   per layer and decode step on "lm", B2 on "plm", and nothing may be
   captured after warmup. Four of phase 4's requests also go through a
   thread-backend server over the same registry. (b) /predict through
   the micro-batcher: phase 9's embedding and 8 encoder layers
   (non-causal) with average pooling and a 16-class softmax, buckets 1,
   2, 4, 8 and 16 captured as CUDA graphs at warmup (compiles must be
   5, and stay 5), 64 requests of 1-4 rows of 512 token ids from 16
   threads of a client process. Every row must be within FLASH_TOL of net.output on
   that row alone, B3 must launch 8 times a device call, and after
   fit() and then set_params() a request must return the new weights'
   answer. /stats must have the JAX server's key set, /metrics must
   parse with every model's families, /healthz and /readyz answer 200;
   then drain() with four long streams in flight: /readyz and a new
   POST answer 503 with Retry-After and the streams finish. It prints
   HTTP tokens/s and TTFT p50/p99 beside phases 4 and 5's, the decode
   step p50 of the half, none and all streamed turns, predict rows/s
   and request p50/p99, and the seconds the phase added.
17. the fleet: two InferenceServer replicas (aio) in this process, each
   built and warmed by one factory over one model from phase 4's seed
   ("lm" with phase 4's configuration, "plm" with phase 5's), behind a
   FleetRouter (health polls every 0.05 s, tracing on, no hedging) on
   its aio front-end. (a) From a client process, half streamed: phase
   4's 32 requests on "lm", then phase 5's primer, burst and the two
   turns of its 8 sessions on "plm" (turn 2 built on the fleet's own
   turn 1). Every "lm" lane must be phase 4's; every "plm" lane phase
   5's unless its first difference is a near-tie of the CPU reference;
   on each replica B1 must launch once per layer and decode step of its
   "lm" engine and B2 of its "plm" engine (the launches its engines'
   replays added, counted by thread, must be all the counters saw);
   each engine must capture its plan at warmup and nothing after; both
   replicas' session hits must sum to 8 and the router's affinity hits
   be 8 (each turn 2 on its turn 1's replica); each replica must serve
   at least a quarter of the requests; the router's /stats must show
   requests = responses + streams with none lost and no error; one
   request with ?trace=1 and "trace": 1 must return the router's pick
   and dispatch spans and the replica's queue, admission, prefill and
   decode spans under one request id. (b) 8 threads of a client process
   loop over phase 4's first 8 prompts (greedy, every other one
   streamed) through the router while fleet.rolling_restart() rebuilds
   both replicas:
   restarts 2, none lost, every answer the restart-free run's, each
   rebuilt replica capturing its plan at warmup and nothing after, and
   the device memory allocated after the restarts (gc and empty_cache
   first) within 5% of before. (c) A second router on the thread
   backend serves 4 of phase 4's requests (2 streamed) with 17a's
   tokens. It prints the router's tokens/s beside phase 16's single
   replica, TTFT p50/p99, each replica's restart wall time, the memory
   before and after, and the seconds the phase added.
18. the CNN training core, on no TPU kernel (every launch counter must
   stay 0): (a) BASELINE config 1 (LeNet exactly as
   tests/test_real_digits.py builds it, seed 123, Adam(1e-3), He init)
   fitted through MultiLayerNetwork.fit for 12 epochs at batch 128 over
   the 1,437 vendored real-digit scans, then evaluate() on the 360-image
   test split: accuracy at least 0.98; (b) a fresh LeNet on the card and
   a CPU copy over 3 batches: at each step the loss and every layer's
   pre-activation, then every gradient, the params and Adam's m and v
   after the step, the CPU copy computing its gradient on the card's
   pre-activations (z + (z_card - z).detach(), so its ReLUs and pools
   choose as the card's did) and each ReLU whose sign differs between
   the two being a near-tie (|z| within 1e-5 of its layer's max of 0:
   cuDNN leaves tiny values where the CPU's sum over zeros is 0); (c)
   the zoo's SimpleCNN (48x48x3, six conv + batch-norm layers, dropout
   0.5) at batch 64 on a learnable synthetic batch, one warmup and five
   timed steps: the loss must fall and every running stat move, then
   one step under a fixed key against a CPU copy (the dropout mask bit
   for bit, loss, gradients and new running stats as in (b)) and
   output() in eval mode. It prints accuracy, step p50, the host's
   enqueue p50, images/s, one profiled SimpleCNN step (device busy
   share, kernels), one dropout draw's kernels and the phase's wall
   time;
19. checkpoints, remat and the recurrent stack: (a) phase 9's net with
   remat(True) beside it without (bit for bit, B3 twice a block a
   step, a lower peak); (b) phase 9's net at 2 blocks under a
   CheckpointListener, resumed from its archive bit for bit; (c) the
   zoo's TextGenerationLSTM through fit, TBPTT(50) and rnn_time_step
   against a CPU copy;
20. transfer learning, pure-bf16 params and resilient training: (a)
   phase 9's net after 2 steps, TransferLearning with
   set_feature_extractor(6) (the embedding and blocks 1-6 frozen) and a
   new output layer, 1 + 3 fine-tune steps: every frozen leaf bit for
   bit unchanged, losses, the trainable leaves and Adam state against a
   CPU copy from the same params and batches, B3 once a block a step and
   B6/B7 once a trainable block a step (the frozen prefix runs no
   backward), step and enqueue p50 beside phase 9's; (b) phase 9's net
   at init(dtype=bf16), 3 steps: the dtypes of every param and Adam
   leaf after each step as JAX's rule gives them (bf16, then f32 params
   beside bf16 moments, then all f32), each step's flash legs (bf16
   then f32), and a 2-block B=1 copy against the CPU; (c)
   FaultTolerantTrainer at phase 9's width cut to 2 blocks, anomaly
   guard on: an uninterrupted run (A); a run with a transient step
   fault, two NaN batches (skipped, then a rollback to the last host
   snapshot's bits), a synchronous checkpoint and a preemption after
   step 4, equal to A at step 4 bit for bit (B); and its resume on a
   fresh card network fitted to the end, equal to A bit for bit (C). It
   prints the step loop's stall at a checkpoint (sync and async), the
   writer's seconds a write and the step p50 while a write runs beside
   none. The phase prints the seconds it added.
21. the DAG network (ComputationGraph), on no TPU kernel (every launch
   counter must stay 0): (a) the zoo's ResNet50 (BASELINE config 2:
   224x224x3, 1000 classes, f32, its Adam(1e-3)) fitted through
   ComputationGraph.fit at batch 64 on a learnable synthetic batch, one
   warmup and five timed steps: the loss must fall and every running
   stat move; then one step at batch 8 against a CPU copy (same params,
   layer state and Adam state): every node's pre-activation computed on
   the CPU from the card's inputs to it, each ReLU that chose otherwise
   a near-tie, the whole-graph loss, every gradient of the CPU run on
   the card's pre-activations (within its tolerance or 3x the CPU's own
   move when those pre-activations move by 1e-7), the new running
   stats, and the params and Adam's m and v after both apply the step;
   (b) the same under the bf16 policy, three steps, the loss falling,
   masters and Adam state f32, the first step's loss against a CPU
   copy; (c) (a)'s net, its softmax taken off so its rows are the
   logits (its probabilities are one-hot to f32 after (a)), behind
   InferenceEngine and the micro-batcher, every power-of-two bucket up
   to 32 captured at warmup and none after, 64 requests of 1-4 rows
   from 16 threads, each row against eager output(), one row's bits
   alone and inside buckets 8 and 32, then set_params and set_net_state
   with new values: each bucket captured once more and no compile, its
   rows the new output() and away from the old; (d) InceptionResNetV1
   (160x160x3) and SqueezeNet (227x227x3), every node of one forward
   against a CPU copy, and a SqueezeNet archive with its Adam state
   restored into a fresh card graph, the next step bit for bit (cuDNN
   deterministic). It prints step and
   enqueue p50, images/s beside the bound, peak memory, one profiled
   step, the CPU copy's gaps, rows/s and request p50/p99, and the
   seconds the phase added.
22. the conv family (``nn/layers/convolutional.py``), on no TPU kernel
   either: (a) the zoo's Xception at the JAX zoo's defaults (299x299x3,
   1000 classes, Adam(1e-3)) at batch 32, f32, one warmup and five
   timed steps, the loss falling and every running stat moving, one
   profiled step, then one step at batch 2 against a CPU copy as 21a
   holds ResNet-50; (b) a fresh Xception under the bf16 policy, three
   steps, its training loss on the first four images against a CPU
   copy's; (c) (a)'s logits served as 21c serves ResNet-50's; (d) UNet
   at 512x512x3 (1 class, sigmoid, xent, a learnable mask, Adam(1e-4))
   at batch 4, one warmup and three timed steps, then its step's
   gradients at batch 1 against a CPU copy (it draws dropout in
   training, so the fit that follows is not compared); (e) NASNet (224x224x3, four cells
   a stack, penultimate 1,056) at batch 32, three timed steps and the
   CPU copy at batch 2; (f) Darknet19 (224x224x3) at batch 32, one
   timed step, the CPU copy at batch 4; (g) every layer class of the
   module and FrozenLayer, forward and gradients on the card against
   the CPU at a small size (Deconvolution2D at k=3, s=2 "same", a
   Convolution3D among them). Each training bound counts the
   products of the network's own layer shapes (``train_bound_ms``).
23. layerwise pretraining, the specialized heads and the detectors, on
   no TPU kernel either: (a) the zoo's YOLO2 at the JAX zoo's defaults
   (608x608x3, 80 classes, 5 anchors: a 19x19x425 map) at batch 16,
   f32, trained on labels drawn from a seed (1-6 objects an image, each
   in one cell and anchor) with Adam(1e-5), one warmup and five timed
   steps, the loss falling and every running stat moving, one profiled
   step, then one step at batch 1 against a CPU copy as 21a holds
   ResNet-50; (b) a fresh YOLO2 under the bf16 policy, three steps, its
   training loss on the first image against a CPU copy's; (c) (a)'s net
   behind InferenceEngine and the micro-batcher, buckets 1-16 captured
   at warmup and none after, 32 requests of 1-4 images from 8 threads,
   each request's maps against eager output(), and host NMS of each
   bucket's served maps equal to NMS of the eager maps; (d) TinyYOLO
   (416x416x3, 20 classes) at batch 32, three timed steps, the CPU copy
   at batch 2; (e) on the vendored real digits' 8x8 scans, an
   AutoEncoder -> VAE (VaeMNISTAnomaly's widths: 256-256, latent 32,
   bernoulli) -> softmax network pretrained layer by layer and fitted,
   and a graph's VAE node pretrained and fitted, each against a CPU copy:
   every batch's pretraining loss, the params after each layer's first
   epoch, then from the card's pretrained state the first fit epoch's
   losses and params (the later epochs' gaps are printed: the VAE's
   training is chaotic); and the VAE's reconstruction error higher on
   uniform noise than on the test digits; (f) every
   layer class of misc.py, variational.py, specialized_outputs.py and
   objdetect.py (CnnLossLayer and Cnn3DLossLayer with each mask form) and
   a MaskingLayer -> LSTM -> MaskLayer network, forward (or loss) and
   gradients on the card against the CPU.
24. data-parallel training of phase 9's net (58.0 M params, Adam(1e-3),
   the global batch 4 x 1024 tokens, 1 + 5 steps): (a) ParallelWrapper
   at one worker, whose dense run must equal a clone's plain fit bit
   for bit with phase 9's launches, and its update and gradient modes
   with their compression telemetry; (b) two rank processes on the one
   card over gloo (the kernels built before they start), 2 x 1024
   tokens a rank, dense, update and gradient modes with the guard on
   and a NaN-label item in rank 1's rows: the params bit for bit across
   the ranks after every item, every item against a one-process
   reference on rank 0 (both workers' rows in turn, the plain encode,
   the mean), the NaN item skipped on both ranks with the residual
   kept, the loss falling, the dense gradient against (a)'s, step and
   collective p50, peak a rank; (c) FaultTolerantTrainer over an
   update-mode wrapper at two ranks on phase 19b's cut, v3 shards: a
   preemption resumed at two ranks bit for bit, and the same archive
   resumed at one worker re-meshed within 0.05 of the two-rank run;
   (d) ParallelInference's gathered rows against output(). A rank that
   fails fails the phase; the ranks are killed after 300 s.
25. Keras import (``modelimport/keras.py`` over the port's own HDF5
   reader, ``modelimport/_h5.py``), on no TPU kernel: (a) every
   committed tests/fixtures/keras_*.h5 imported on the card, its output
   against Keras's (keras_expected.npz, keras_extra_expected.npz) at
   tests/test_modelimport.py's tolerances, its params bit for bit a CPU
   import's and its output against the CPU import's at the same
   tolerance; (b) MobileNetV2 at
   its published width (alpha 1.0, 224x224x3, 1,000 classes, 3,538,984
   weights and statistics; the port's fixture, written by
   tools/make_keras_fixture.py with non-trivial batch-norm statistics),
   imported with its training config enforced: softmax and pooled
   features on 8 images against Keras's and a CPU copy's, served as 21c
   serves ResNet-50 (its logits behind InferenceEngine and the
   micro-batcher), the first step at batch 4 against a CPU copy as 21a
   holds ResNet-50, then a fresh import at batch 32 under the file's
   Adam(1e-4) and categorical cross-entropy, one warmup and five timed
   steps, the loss falling and every running stat moving, peak memory
   and one profiled step. ``--keras`` runs it alone and prints a
   "KERAS" JSON line (the full run prints it too).

Phases 4 to 7 and 12 to 17 serve with the engine's defaults on the card:
the pipelined decode loop, and every executable of the JAX engine's
warm set captured at warmup as a CUDA graph (``graph_plan``: the
decode step, each prefill bucket on slots, each (chunk, table) bucket
pair and the copy-on-write copy on the paged backend, with speculation
the proposal, the prime buckets and the verify spans) and replayed (a
replay counts the launches the capture recorded). Each phase must
capture exactly its plan at warmup and nothing after, phase 11's
recoveries included, and prints its captures, their wall time, the
shared graph pool's MiB, prefill (chunk) p50 and TTFT p50/p99.

Phase 3 holds B1 (f32 and bf16) against its plain version at head
dims 16, 64, 128, 160 and 256 with lengths at its chunk edges and NaN
in every stale tail, two calls giving the same bits, shows that a
slot's bits are the same alone and among 64 slots and at a capacity of
1024 and 2048 keys, reports each instantiation's registers, spills and
blocks per SM, and times B1, B2, B4 and B5 at the lengths phases 4 to 7
decode at (each request at its prompt plus half its new tokens).
Phase 3 also checks B1 (f32) and B3 (f32, causal, B=1) at the default
draft's head dim (2 heads of 16, T=1024) against their plain versions
and times them beside their bounds and SDPA (phase 12's proposals and
primes run them there), and the two int8 kernels (decode and paged) against
their plain versions at the served shapes, with NaN in the scale rows
of the null block and of every stale tail, a length-0 lane, two calls
giving the same bits, and K/V of mixed quantisation refused, and
reports their registers, spills and blocks per SM. The flash forward
(3xTF32 on the tensor cores) is also checked on a fully masked row (O
0, LSE -1e30) and timed at B=1 and B=4 beside both its bounds; each
key-group count (one and two groups of warps a block) is held against
the plain version there and timed over a sweep of batch and length
(the measurement behind the rule that picks it); the flash forward
must give the same bits on two calls, and reports registers, spills
and blocks per SM.
Phase 2 counts HMMA (``mma.sync``) and HGMMA (``wgmma``) in every flash
kernel and I2F in the two int8 kernels from ``cuobjdump -sass`` where
the toolkit has it: the three bf16 flash kernels (forward, dQ, dK/dV)
must run bf16 HGMMA and no HMMA at each head-dim bucket (32, 64, 128),
the f32 flash kernels HMMA, and the int8 kernels must convert without
I2F; B1's instantiations with 16-byte loads must issue LDG.128 and use
no local memory.

A "details:" line carries every measured number as JSON; then come
the kernels line, the card's name and power limit, and last
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --ab PARENT_CHECKOUT

compares the code of another checkout with this one on the card
instead: each checkout's own code in turns (parent, this, this,
parent), each turn a process of its own, timing the flash forward at
B=1 and B=4 and its backward kernels at B=4, the bf16 legs of all
three and the whole bf16 backward (delta included) at B=4, T=1024,
the decode and paged kernels, f32 and int8 (their phase-3 checks; B1
also in bf16 and at the draft's shape), the four decode kernels at the
lengths phases 4 to 7 serve, serving phases 4 to 7 with their profile
windows (tokens/s, TTFT p50/p99, prefill or chunk p50), phase 11's
recovery ms on phases 4 and 7's engines, phase 12 on both backends
(tokens/s, verify p50), and phase 10 (step p50, the host's enqueue
p50, device time by kind); an "A/B runs:" line carries every turn as
JSON.

    python3 chip_smoke.py --ab-train PARENT_CHECKOUT

turns the same way over phases 9 and 10 alone: each phase's step p50
and enqueue p50 over 20 timed steps, and one profiled step's kernels,
busy share and host ops.

    python3 chip_smoke.py --graph

runs phase 21 alone (it builds no kernel) and prints its numbers on a
"GRAPH" line as JSON.

    python3 chip_smoke.py --conv

runs phase 22 alone (it builds no kernel either) and prints its numbers
on a "CONV" line as JSON.

    python3 chip_smoke.py --detect

runs phase 23 alone (no kernel build) and prints its numbers on a
"DETECT" line as JSON.

    python3 chip_smoke.py --parallel

runs phase 24 alone (after building the kernels, which its rank
processes then load) and prints its numbers on a "PARALLEL" line as
JSON.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

# tolerances, each with its reason
DECODE_TOL_F32 = 1e-4   # f32, sums over up to 1024 keys in another order
DECODE_TOL_BF16 = 5e-3  # p rounded to bf16 before (kernel, as the
#                         Pallas kernel) or after (plain, as
#                         decode_attention_xla) normalisation; 1.9e-3
#                         measured on an H100 at these shapes
FLASH_TOL = 1e-4        # f32, sums over up to 1024 keys in another order
TEACHER_TOL = 1e-3      # logit gap allowed between a served greedy token
#                         and the CPU maximum at that position
INT8_TOL = 2e-2         # int8 kernels: the kernel rounds the unnormalised
#                         p * vscale to bf16 (as the Pallas kernel), the
#                         plain version the normalised one; each within
#                         2^-8 of its term, so an output may move by up to
#                         2^-7 of the largest |dequantised v| it averages.
#                         The JAX package's own Pallas-vs-xla int8
#                         tolerance; 1.0e-2 measured on an H100 here
FLASH_BWD_TOL = 1e-4    # relative to the largest gradient (at least
#                         1): f32, sums over up to 1024 keys in another
#                         order; dp = dO.V over D=64 has std 8 here, so
#                         gradients reach ~10
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU loss of one step: f32 on both, a
#                         mean over 1024 tokens summed in another order
TRAIN_GRAD_TOL = 1e-3   # card vs CPU, each gradient leaf's max error over
#                         its max |value|: f32 on both, but GEMMs over
#                         512-2048 terms and attention over 1024 keys sum
#                         in another order, and a leaf's small entries
#                         (embedding rows, biases) carry that error
FLASH_BF16_O_TOL = 1e-2     # bf16 legs vs plain, times max(1, max|O|): P
#                             is rounded to bf16 before P V, and both
#                             sides round O to bf16 (one ulp is up to
#                             2^-7 of the largest value)
FLASH_BF16_GRAD_TOL = 2e-2  # times max(1, max|grad|): P and dS rounded to
#                             bf16 before the second products, then the
#                             gradients rounded to bf16 on both sides
FLASH_BF16_LSE_TOL = 1e-5   # f32 on both sides, from bf16-exact products;
#                             9.5e-7 measured on an H100 at these shapes
TRAIN_BF16_LOSS_RTOL = 1e-2  # phase 10, card vs CPU at bf16: both round
#                              activations to bf16 (~2^-9 an op), at other
#                              places and in another order
TRAIN_BF16_GRAD_TOL = 3e-2   # each leaf's max error over its max |value|:
#                              bf16 activations on both sides, and the
#                              small leaves (biases, norm gains) sum 1024
#                              tokens' bf16-rounded terms
BF16_TEACHER_TOL = 1e-2  # bf16 teacher-forced gap (phase 13): card and
#                         CPU both run the bf16 cache, but K/V computed in
#                         another order can round to the neighbouring bf16
#                         value (2^-8 of it) and the kernel rounds p before
#                         normalising (DECODE_TOL_BF16); int8's bound on
#                         such noise holds a fortiori; 0.0 measured on
#                         an H100 at the served width
INT8_TEACHER_TOL = 1e-2  # int8 teacher-forced gap: card and CPU both run
#                         int8, but sums in another order can move a K/V
#                         value across an int8 rounding boundary (one step
#                         is ~1% of its row's max) and the kernels round p
#                         before normalising; the whole int8-vs-f32 logit
#                         error is 6.4e-3 at this width (CPU), a wrong
#                         scale or a leaked tail moves logits by ~0.1 and up

#: the served model (docs/generation.md), random weights from seed 0;
#: eos_id=None so every request runs its full length
SERVE_CFG = dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=8,
                 max_seq_len=1024, eos_id=None, seed=0)
#: the paged configuration of docs/generation.md
PAGED_ENGINE = dict(num_slots=64, cache="paged", block_size=16,
                    num_blocks=4096, prefill_chunk_tokens=512)

#: the training phase: SERVE_CFG's width in the layer DSL, batches of 4
#: sequences of 1024 tokens
TRAIN_CFG = dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=8,
                 d_ff=2048, batch=4, seq_len=1024, lr=1e-3, seed=0)
TRAIN_STEPS = 5  # timed steps, after one warmup step

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12      # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12    # TF32 tensor cores, dense
H100_BF16_FLOPS = 989e12    # bf16 tensor cores, dense

#: the device-side names of the port's kernels (csrc/*.cu)
PORT_KERNEL = re.compile(r"(decode_attention|paged_attention|flash_fwd|"
                         r"flash_bwd_dq|flash_bwd_dkv)\w*_kernel")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``. The timed calls queue up behind
    a device-side sleep that outlasts their enqueue, so the host's time
    between launches (Python, the wrappers' checks, ctypes) is not
    counted: a kernel shorter than its wrapper would otherwise be timed
    at the host's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once_s = time.perf_counter() - t0  # bounds one call's enqueue
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at 2 GHz, above the H100's top SM clock: the sleep lasts
    # at least twice the whole loop's enqueue
    torch.cuda._sleep(int(2e9 * 2 * iters * once_s))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _decode_inputs(dev, S, H, T, D, dtype, g):
    """q and K/V caches [S, H, T, D] with lengths 0, T, 1 and B1's chunk
    edges (C - 1, C, C + 1, 2C + 1, 7C + 1) as far as S and T allow,
    random others, and NaN past every slot's length."""
    import torch
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    C = da.CHUNK_KEYS
    q = torch.randn((S, H, D), generator=g).to(dev)
    k = torch.randn((S, H, T, D), generator=g).to(dev, dtype)
    v = torch.randn((S, H, T, D), generator=g).to(dev, dtype)
    lens = torch.randint(1, T + 1, (S,), generator=g)
    edges = [n for n in (0, T, 1, C - 1, C, C + 1, 2 * C + 1, 7 * C + 1)
             if n <= T][:S]
    lens[:len(edges)] = torch.tensor(edges)
    for s in range(S):  # stale non-finite tails must not leak
        k[s, :, int(lens[s]):] = float("nan")
        v[s, :, int(lens[s]):] = float("nan")
    return q, k, v, lens.to(dev, torch.int32)


def _decode_against_plain(q, k, v, lens, tol, label):
    """B1 against its plain version: within ``tol``, finite, slot 0
    (length 0) exactly 0 and two calls bit-identical; returns the
    largest error."""
    import torch
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    got = da.decode_attention(q, k, v, lens)
    again = da.decode_attention(q, k, v, lens)
    want = da.decode_attention_torch(q, k, v, lens)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    zero_row = got[0].abs().max().item()
    same = torch.equal(got, again)
    print(f"{label}: max_abs_err {err:.3e} (tol {tol:g}), finite {finite}, "
          f"len-0 row max {zero_row}, two calls bit-identical {same}")
    if not (finite and err <= tol and zero_row == 0.0 and same):
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def check_decode(dev, S=32, H=8, D=64, bf16=True):
    """Phase 3's decode kernel (B1) against its plain version at the
    served slot shapes (S=32, T=1024), f32 and (``bf16``) bf16, with
    lengths 0, 1, T, its chunk edges and ragged ones, NaN in every stale
    tail and two calls bit-identical; its registers, spills and blocks
    per SM; then timed with every slot full beside its bound and SDPA.
    ``S=64, H=2, D=16, bf16=False`` is the default draft's shape on the
    paged engine (phase 12b's proposals: its dense draft cache has the
    engine's 64 slots)."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    T = 1024
    g = torch.Generator(device="cpu").manual_seed(1)
    results = {}
    for dtype, tol in ((torch.float32, DECODE_TOL_F32),
                       (torch.bfloat16, DECODE_TOL_BF16))[:1 + bf16]:
        name = str(dtype)[6:]
        q, k, v, lens = _decode_inputs(dev, S, H, T, D, dtype, g)
        err = _decode_against_plain(
            q, k, v, lens, tol, f"decode_attention {name} S={S} H={H} D={D}")
        info = da.decode_kernel_info(D, dtype)
        print(f"decode_attention {name} D={D}: {info}")
        # timed at the served width with every slot full (lengths = T):
        # the cache read is the whole work, and one library call
        # computes the same function
        full = torch.full((S,), T, dtype=torch.int32, device=dev)
        k.nan_to_num_(0.0)
        v.nan_to_num_(0.0)
        ms = time_ms(lambda: da.decode_attention(q, k, v, full))
        plain_ms = time_ms(lambda: da.decode_attention_torch(q, k, v, full))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None].to(dtype), k, v))
        item = k.element_size()
        nbytes = q.numel() * 4 + 2 * S * H * T * D * item + S * 4 \
            + S * H * D * 4
        bound_ms, bound_by = _bound(nbytes, 4 * D * H * S * T)
        results[name] = dict(
            max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
            bytes=nbytes, info=info)
        print(f"decode_attention {name} S={S} H={H} T={T} D={D}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.2f} MB)")
    return results


def check_decode_dims(dev):
    """B1 at head dims above the served one (128, and 160 and 256 which
    the TPU-era port refused), f32 and bf16: 8 slots of 4 heads, T=1024,
    the chunk-edge lengths and NaN tails of check_decode; with each
    instantiation's registers, spills and blocks per SM."""
    import torch
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    g = torch.Generator(device="cpu").manual_seed(7)
    out = {}
    for D in (128, 160, 256):
        for dtype, tol in ((torch.float32, DECODE_TOL_F32),
                           (torch.bfloat16, DECODE_TOL_BF16)):
            name = f"{str(dtype)[6:]}_d{D}"
            q, k, v, lens = _decode_inputs(dev, 8, 4, 1024, D, dtype, g)
            err = _decode_against_plain(q, k, v, lens, tol,
                                        f"decode_attention {name}")
            out[name] = dict(max_abs_err=err, tol=tol,
                             info=da.decode_kernel_info(D, dtype))
            print(f"decode_attention {name}: {out[name]['info']}")
    return out


def check_decode_bits(dev):
    """A slot's B1 output bits depend only on its q, rows and length:
    the same alone (S=1) as among 64 slots, and with the caches at
    T_cap 1024 and 2048; f32 and bf16 at the served head dim, f32 at
    the draft's."""
    import torch
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    C = da.CHUNK_KEYS
    g = torch.Generator(device="cpu").manual_seed(8)
    S, alone = 64, (0, 1, 2, 3, 4, 5, 31, 63)
    out = {}
    for H, D, dtype in ((8, 64, torch.float32), (8, 64, torch.bfloat16),
                        (2, 16, torch.float32)):
        q = torch.randn((S, H, D), generator=g).to(dev)
        k = torch.randn((S, H, 2048, D), generator=g).to(dev, dtype)
        v = torch.randn((S, H, 2048, D), generator=g).to(dev, dtype)
        lens = torch.randint(1, 1025, (S,), generator=g)
        lens[:6] = torch.tensor([0, 1, C - 1, C + 1, 7 * C + 1, 1024])
        lens = lens.to(dev, torch.int32)
        wide = da.decode_attention(q, k, v, lens)
        k1, v1 = (x[:, :, :1024].contiguous() for x in (k, v))
        narrow = da.decode_attention(q, k1, v1, lens)
        same_t = torch.equal(wide, narrow)
        same_s = all(torch.equal(da.decode_attention(
            q[s:s + 1].contiguous(), k1[s:s + 1].contiguous(),
            v1[s:s + 1].contiguous(), lens[s:s + 1].contiguous())[0],
            narrow[s]) for s in alone)
        name = f"{str(dtype)[6:]}_h{H}_d{D}"
        out[name] = dict(same_at_t_cap_1024_and_2048=same_t,
                         same_alone_and_among_64=same_s)
        print(f"decode_attention {name}: bits the same at T_cap 1024 and "
              f"2048 {same_t}, alone and among {S} slots {same_s} (slots "
              f"{alone})")
        if not (same_t and same_s):
            raise AssertionError(f"decode_attention {name}: a slot's bits "
                                 f"depend on the batch or the capacity")
        del q, k, v, k1, v1
    return out


def served_lengths():
    """One length vector per serving phase, from its traffic: each
    request at its prompt plus half its new tokens (the mean length it
    decodes at), the slots it leaves idle at 0. Phases 4 and 6 serve
    slot_traffic on 32 slots; phases 5 and 7 paged_traffic's burst of
    48 on 64 slots."""
    slots = [len(r["prompt"]) + r["max_tokens"] // 2 for r in slot_traffic()]
    _, burst, _, _ = paged_traffic(SERVE_CFG["vocab_size"])
    paged = [len(r["prompt"]) + r["max_tokens"] // 2 for r in burst]
    paged += [0] * (PAGED_ENGINE["num_slots"] - len(paged))
    return {4: slots, 5: paged, 6: slots, 7: paged}


def served_decode_ms(dev):
    """Each decode kernel's device ms a decode step at the lengths its
    serving phase decodes at (served_lengths): B1 (phase 4), B2 (5), B4
    (6) and B5 (7) at the served width (8 heads of 64, T = 1024, blocks
    of 16 over a 4096-block pool through distinct blocks); one call
    timed, times the 8 layers of a step, beside the call's bound."""
    import torch
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import kv_quant as kvq
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    H, D, T = SERVE_CFG["n_heads"], 64, SERVE_CFG["max_seq_len"]
    layers = SERVE_CFG["n_layers"]
    Bs, N = PAGED_ENGINE["block_size"], PAGED_ENGINE["num_blocks"]
    g = torch.Generator(device="cpu").manual_seed(9)
    rs = np.random.RandomState(9)
    out = {}
    for phase, lens in served_lengths().items():
        S, live = len(lens), sum(lens)
        int8 = phase in (6, 7)
        cast = kvq.quantize_rows if int8 else (lambda x: x)
        q = torch.randn((S, H, D), generator=g).to(dev)
        lens_d = torch.tensor(lens, dtype=torch.int32, device=dev)
        if phase in (4, 6):
            k, v = (cast(torch.randn((S, H, T, D), generator=g).to(dev))
                    for _ in range(2))
            name = "B4 decode_attention_int8" if int8 else \
                "B1 decode_attention"
            fn = lambda: da.decode_attention(q, k, v, lens_d)  # noqa: E731
        else:
            k, v = (cast(torch.randn((N, H, Bs, D), generator=g).to(dev))
                    for _ in range(2))
            perm = rs.permutation(np.arange(1, N))
            tbl = np.zeros((S, T // Bs), np.int32)
            used = 0
            for s, n in enumerate(lens):
                nb = -(-n // Bs)
                tbl[s, :nb] = perm[used:used + nb]
                used += nb
            tbl_d = torch.from_numpy(tbl).to(dev)
            name = "B5 paged_attention_int8" if int8 else \
                "B2 paged_attention"
            fn = lambda: pa.paged_attention(  # noqa: E731
                q, k, v, tbl_d, lens_d)
        ms = time_ms(fn)
        row = 2 * D * (1 if int8 else 4) + (8 if int8 else 0)
        nbytes = live * H * row + 2 * S * H * D * 4 + S * 4
        bound_ms, _ = _bound(nbytes, 4 * D * H * live)
        out[phase] = dict(kernel=name, slots=S, live_slots=sum(
            n > 0 for n in lens), mean_live_length=live / max(1, sum(
                n > 0 for n in lens)), ms=ms, step_ms=ms * layers,
            bound_ms=bound_ms, step_bound_ms=bound_ms * layers)
        print(f"served lengths, phase {phase}: {name} over {S} slots "
              f"(mean live length {out[phase]['mean_live_length']:.1f}): "
              f"{ms:.4f} ms a call, {ms * layers:.4f} ms a step of "
              f"{layers} layers, bound {bound_ms:.4f} ms a call")
        del k, v
    return out


def check_flash(dev):
    """Phase 3's flash forward (B3): against its plain version over the
    prefill buckets (B=1, causal, a padded prompt), a fully masked row
    (O exactly 0, LSE exactly -1e30), two calls bit-identical, then
    timed at T=1024 with B=1 (a served prefill) and B=4 (a training
    batch) beside SDPA, with its share of the 3xTF32-rate and f32-rate
    bounds and either key-group count."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    B, H, D = 1, 8, 64
    g = torch.Generator(device="cpu").manual_seed(2)
    worst = 0.0
    per_bucket = {}
    T = 8
    while T <= 1024:
        q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev)
                   for _ in range(3))
        L = max(1, (3 * T) // 4 + 1)  # a padded prompt of length L
        km = (torch.arange(T) < L).to(torch.float32)[None].to(dev)
        o, lse = fa.flash_attention(q, k, v, True, km)
        o_ref, lse_ref = fa.flash_attention_torch(q, k, v, True, km)
        torch.cuda.synchronize()
        err = max((o - o_ref).abs().max().item(),
                  (lse - lse_ref).abs().max().item())
        per_bucket[T] = err
        worst = max(worst, err)
        if not (err <= FLASH_TOL and bool(torch.isfinite(o).all())):
            raise AssertionError(f"flash_attention T={T} disagrees with "
                                 f"its plain version: {err:.3e}")
        T *= 2
    print(f"flash_attention buckets 8..1024: max_abs_err {worst:.3e} "
          f"(tol {FLASH_TOL:g}) per bucket {per_bucket}")
    # a batch row whose keys are all masked, non-causal and causal
    q, k, v = (torch.randn((2, 257, H, D), generator=g).to(dev)
               for _ in range(3))
    km = torch.ones((2, 257), device=dev)
    km[1] = 0.0
    for causal in (False, True):
        ref = fa.flash_attention_torch(q, k, v, causal, km)
        # the chosen version, then each key-group count forced
        for kg in (None, 1, 2):
            o, lse = fa._flash_attention_cuda(q, k, v, causal, km, kg)
            err = _max_err((o, lse), ref)
            if not (err <= FLASH_TOL and o[1].abs().max().item() == 0.0
                    and bool((lse[1] == -1e30).all())):
                raise AssertionError(
                    f"flash_attention causal={causal} key groups {kg}: a "
                    f"fully masked row must give O = 0 and LSE = -1e30 "
                    f"(err {err:.3e})")
    print("flash_attention fully masked row (T=257, causal and not, one and "
          "two key groups): O 0, LSE -1e30")
    # timed at the largest prefill bucket, causal, every key live
    T = 1024
    rows = {}
    for B in (1, 4):
        q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev)
                   for _ in range(3))
        km = torch.ones((B, T), device=dev)
        first = fa.flash_attention(q, k, v, True, km)
        again = fa.flash_attention(q, k, v, True, km)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"flash_attention B={B}: two calls on the "
                                 f"same inputs differ")
        # the chosen version and each forced key-group count against plain
        ref = fa.flash_attention_torch(q, k, v, True, km)
        errs = {kg: _max_err(fa._flash_attention_cuda(q, k, v, True, km, kg),
                             ref) for kg in (1, 2)}
        errs["chosen"] = _max_err(first, ref)
        if not max(errs.values()) <= FLASH_TOL:
            raise AssertionError(f"flash_attention B={B} T={T} disagrees "
                                 f"with its plain version by key groups: "
                                 f"{errs}")
        worst = max(worst, errs["chosen"])
        ms = time_ms(lambda: fa.flash_attention(q, k, v, True, km))
        groups_ms = {kg: time_ms(lambda kg=kg: fa._flash_attention_cuda(
            q, k, v, True, km, kg)) for kg in (1, 2)}
        plain_ms = time_ms(lambda: fa.flash_attention_torch(q, k, v, True,
                                                            km))
        mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()[
            None, None] & (km > 0)[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        flops = 4 * D * H * B * (T * (T + 1) // 2)
        nbytes = 4 * B * T * H * D * 4 + B * T * 4 + B * H * T * 4
        # three TF32 products per f32 product (3xTF32)
        bound_ms, bound_by = _bound(nbytes, 3 * flops, H100_TF32_FLOPS)
        bound_f32_ms, _ = _bound(nbytes, flops)
        rows[B] = dict(ms=ms, key_groups_ms=groups_ms, err=errs,
                       plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bound_f32_ms=bound_f32_ms,
                       share_of_bound=bound_ms / ms,
                       share_of_f32_bound=bound_f32_ms / ms,
                       gflop=flops / 1e9)
        print(f"flash_attention B={B} H={H} T={T} D={D} causal: kernel "
              f"{ms:.4f} ms (key groups 1: {groups_ms[1]:.4f}, 2: "
              f"{groups_ms[2]:.4f}), plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms at 3xTF32 (share "
              f"{bound_ms / ms:.3f}), {bound_f32_ms:.4f} ms at f32 (share "
              f"{bound_f32_ms / ms:.3f}); two calls bit-identical; "
              f"max_abs_err by key groups {errs} (tol {FLASH_TOL:g})")
    info = {d: {kg: fa.fwd_kernel_info(d, kg) for kg in (1, 2)}
            for d in (32, 64, 128)}
    print(f"flash_attention registers, spills, shared bytes, blocks per SM "
          f"by head dim and key groups: {info}")
    return dict(max_abs_err=worst, tol=FLASH_TOL, per_bucket=per_bucket,
                **rows[1], b4=rows[4], info=info,
                key_group_sweep=key_group_sweep(dev, g))


def check_flash_draft(dev):
    """B3 f32 at the draft's head dim (``make_draft_lm``: 2 heads of
    16), as phase 12's draft primes run it: B=1 causal over the prefill
    buckets with a padded prompt against its plain version, two calls
    bit-identical, then timed at T=1024 beside its bounds and SDPA."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    B, H, D = 1, 2, 16
    g = torch.Generator(device="cpu").manual_seed(4)
    worst, T = 0.0, 8
    while T <= 1024:
        q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev)
                   for _ in range(3))
        km = (torch.arange(T) < max(1, (3 * T) // 4 + 1)).to(
            torch.float32)[None].to(dev)
        got = fa.flash_attention(q, k, v, True, km)
        err = _max_err(got, fa.flash_attention_torch(q, k, v, True, km))
        worst = max(worst, err)
        if not (err <= FLASH_TOL and bool(torch.isfinite(got[0]).all())):
            raise AssertionError(f"flash_attention D={D} T={T} disagrees "
                                 f"with its plain version: {err:.3e}")
        T *= 2
    T = 1024
    q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev)
               for _ in range(3))
    km = torch.ones((B, T), device=dev)
    first = fa.flash_attention(q, k, v, True, km)
    err = _max_err(first, fa.flash_attention_torch(q, k, v, True, km))
    if not (all(torch.equal(a, b) for a, b in
                zip(first, fa.flash_attention(q, k, v, True, km)))
            and err <= FLASH_TOL):
        raise AssertionError(f"flash_attention D={D} T={T}: two calls "
                             f"differ, or {err:.3e} from plain")
    ms = time_ms(lambda: fa.flash_attention(q, k, v, True, km))
    plain_ms = time_ms(lambda: fa.flash_attention_torch(q, k, v, True, km))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 4 * D * H * B * (T * (T + 1) // 2)
    nbytes = 4 * B * T * H * D * 4 + B * T * 4 + B * H * T * 4
    bound_ms, bound_by = _bound(nbytes, 3 * flops, H100_TF32_FLOPS)
    print(f"flash_attention draft B={B} H={H} T={T} D={D} causal: buckets "
          f"8..1024 max_abs_err {max(worst, err):.3e} (tol {FLASH_TOL:g}), "
          f"two calls bit-identical; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA is_causal {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms at 3xTF32 ({bound_by})")
    return dict(max_abs_err=max(worst, err), tol=FLASH_TOL, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def _max_err(got, ref) -> float:
    """Largest |difference| over the forward's (O, LSE) pair."""
    return max((a - b).abs().max().item() for a, b in zip(got, ref))


#: (B, T) at H=8, D=64: served prefill buckets at B=1 (8 to 128 blocks of
#: 64 query rows) and batches from 192 to 512 blocks (training's is the
#: last), two at 384 blocks with different T
KEY_GROUP_SHAPES = ((1, 64), (1, 128), (1, 256), (1, 512), (1, 1024),
                    (2, 768), (2, 1024), (3, 768), (4, 640), (3, 896),
                    (3, 960), (3, 1024), (6, 512), (4, 1024))


def key_group_sweep(dev, g):
    """The forward with one and with two key groups per block, each held
    against its plain version (causal, every key live) and timed, over
    KEY_GROUP_SHAPES: the measurement behind key_groups_for's rule."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    H, D = 8, 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for B, T in KEY_GROUP_SHAPES:
        q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev)
                   for _ in range(3))
        km = torch.ones((B, T), device=dev)
        ref = fa.flash_attention_torch(q, k, v, True, km)
        row = dict(B=B, T=T, blocks=B * H * -(-T // 64),
                   chosen=fa.key_groups_for(B, T, H, dev))
        for kg in (1, 2):
            err = _max_err(fa._flash_attention_cuda(q, k, v, True, km, kg),
                           ref)
            if not err <= FLASH_TOL:
                raise AssertionError(f"flash_attention B={B} T={T} key "
                                     f"groups {kg}: {err:.3e} from plain")
            row[f"err_{kg}"] = err
            row[f"ms_{kg}"] = time_ms(
                lambda kg=kg: fa._flash_attention_cuda(q, k, v, True, km, kg))
        out.append(row)
        print(f"flash_attention key groups B={B} T={T} ({row['blocks']} "
              f"blocks on {sms} SMs): 1 group {row['ms_1']:.4f} ms, 2 groups "
              f"{row['ms_2']:.4f} ms, chosen {row['chosen']}; max_abs_err "
              f"{row['err_1']:.2e}, {row['err_2']:.2e}")
    return out


def check_paged(dev):
    """The paged kernel against its plain version at the served shapes
    (64 slots, 8 heads, blocks of 16, head dim 64, 64-entry tables, a
    4096-block pool), then timed with every slot at length 1024."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    S, H, Bs, D, B, N = 64, 8, 16, 64, 64, 4096
    T = B * Bs
    rs = np.random.RandomState(4)
    g = torch.Generator(device="cpu").manual_seed(4)
    results = {}
    # the same function as decode attention, read through a table: the
    # decode tolerances and their reasons hold
    for dtype, tol in ((torch.float32, DECODE_TOL_F32),
                       (torch.bfloat16, DECODE_TOL_BF16)):
        q = torch.randn((S, H, D), generator=g).to(dev)
        k = torch.randn((N, H, Bs, D), generator=g).to(dev, dtype)
        v = torch.randn((N, H, Bs, D), generator=g).to(dev, dtype)
        lens = rs.randint(1, T + 1, S)
        lens[:6] = [0, 1, 15, 16, 17, T]
        # each slot's live blocks are distinct pool blocks, in random
        # order, NULL-padded past ceil(len / Bs); no two slots share a
        # block, so one slot's stale tail is no other slot's live key
        perm = rs.permutation(np.arange(1, N))
        tbl = np.zeros((S, B), np.int32)
        used = 0
        for s, n in enumerate(lens):
            nb = -(-int(n) // Bs)
            tbl[s, :nb] = perm[used:used + nb]
            used += nb
            if n % Bs:  # the stale tail of the last live block
                k[int(tbl[s, nb - 1]), :, int(n % Bs):] = float("nan")
                v[int(tbl[s, nb - 1]), :, int(n % Bs):] = float("nan")
        k[0] = float("nan")  # the null block, where padded lanes write
        v[0] = float("nan")
        tbl_d = torch.from_numpy(tbl).to(dev)
        lens_d = torch.from_numpy(lens.astype(np.int32)).to(dev)
        got = pa.paged_attention(q, k, v, tbl_d, lens_d)
        want = pa.paged_attention_torch(q, k, v, tbl_d, lens_d)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        zero_row = got[0].abs().max().item()
        name = str(dtype)[6:]
        print(f"paged_attention {name}: max_abs_err {err:.3e} (tol "
              f"{tol:g}), finite {finite}, len-0 row max {zero_row}, "
              f"{used} live blocks")
        if not (finite and err <= tol and zero_row == 0.0):
            raise AssertionError(f"paged_attention {dtype} disagrees "
                                 f"with its plain version")
        # timed with every slot at length T through a full table of
        # distinct blocks per slot (63 x 64 + 64 entries over 4095
        # blocks: the last slot repeats one block of the first)
        k.nan_to_num_(0.0)
        v.nan_to_num_(0.0)
        full_tbl = torch.from_numpy(np.resize(
            rs.permutation(np.arange(1, N)), S * B).reshape(S, B)
            .astype(np.int32)).to(dev)
        full = torch.full((S,), T, dtype=torch.int32, device=dev)
        kd = pa.gather_blocks(k, full_tbl).contiguous()
        vd = pa.gather_blocks(v, full_tbl).contiguous()
        got = pa.paged_attention(q, k, v, full_tbl, full)
        dense = da.decode_attention(q, kd, vd, full)
        torch.cuda.synchronize()
        slot_err = (got - dense).abs().max().item()
        if not slot_err <= tol:
            raise AssertionError(f"paged_attention {dtype} disagrees with "
                                 f"the slot kernel on the gathered panel: "
                                 f"{slot_err:.3e}")
        ms = time_ms(lambda: pa.paged_attention(q, k, v, full_tbl, full))
        plain_ms = time_ms(lambda: pa.paged_attention_torch(
            q, k, v, full_tbl, full))
        slot_ms = time_ms(lambda: da.decode_attention(q, kd, vd, full))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None].to(dtype), kd, vd))
        item = k.element_size()
        nbytes = 2 * S * H * T * D * item + 2 * S * H * D * 4 \
            + S * B * 4 + S * 4
        flops = 4 * D * H * S * T
        bound_ms = max(nbytes / H100_BYTES_PER_S,
                       flops / H100_F32_FLOPS) * 1e3
        results[name] = dict(
            max_abs_err=err, tol=tol, slot_kernel_err=slot_err,
            live_blocks=used, ms=ms, plain_ms=plain_ms,
            slot_kernel_dense_ms=slot_ms, library_ms=lib_ms,
            bound_ms=bound_ms,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S
            >= flops / H100_F32_FLOPS else "operations")
        print(f"paged_attention {name} S={S} H={H} Bs={Bs} D={D} B={B} "
              f"N={N}, every length {T}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, slot kernel on the gathered panel "
              f"{slot_ms:.4f} ms, library (SDPA on the gathered panel, "
              f"gather not timed) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms")
        del q, k, v, kd, vd
    return results


def _bound(nbytes, flops, rate=H100_F32_FLOPS):
    """The least time on the card (ms) for ``nbytes`` moved and
    ``flops`` done at ``rate`` (default the f32 rate), and which of the
    two sets it."""
    b, f = nbytes / H100_BYTES_PER_S, flops / rate
    return max(b, f) * 1e3, "bytes" if b >= f else "operations"


def _refuses_mixed(fn, quant, plain):
    """Mixed quantisation must raise, either way round."""
    for a, b in ((quant, plain), (plain, quant)):
        try:
            fn(a, b)
        except ValueError:
            continue
        raise AssertionError("K/V of mixed quantisation was not refused")


def check_decode_int8(dev):
    """The int8 decode kernel against its plain version at the slot
    phase's shapes (32 slots, 8 heads, T=1024, D=64), NaN in every stale
    tail's scales, then timed with every slot full."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import kv_quant as kvq
    S, H, T, D = 32, 8, 1024, 64
    g = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn((S, H, D), generator=g).to(dev)
    k = kvq.quantize_rows(torch.randn((S, H, T, D), generator=g).to(dev))
    v = kvq.quantize_rows(torch.randn((S, H, T, D), generator=g).to(dev))
    lens = torch.randint(1, T + 1, (S,), generator=g)
    lens[0], lens[1], lens[2] = 0, T, 1
    clean_k, clean_v = k.scale.clone(), v.scale.clone()
    for s in range(S):  # a stale tail's scale may be NaN
        k.scale[s, :, int(lens[s]):] = float("nan")
        v.scale[s, :, int(lens[s]):] = float("nan")
    lens = lens.to(dev, torch.int32)
    got = da.decode_attention(q, k, v, lens)
    again = da.decode_attention(q, k, v, lens)
    want = da.decode_attention_torch(q, k, v, lens)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    zero_row = got[0].abs().max().item()
    same = torch.equal(got, again)
    print(f"decode_attention int8: max_abs_err {err:.3e} (tol {INT8_TOL:g}),"
          f" finite {finite}, len-0 row max {zero_row}, two calls "
          f"bit-identical {same}")
    if not (finite and err <= INT8_TOL and zero_row == 0.0 and same):
        raise AssertionError("decode_attention int8 disagrees with its "
                             "plain version or with itself")
    _refuses_mixed(lambda a, b: da.decode_attention(q, a, b, lens), k,
                   kvq.dequantize(v))
    k.scale.copy_(clean_k)
    v.scale.copy_(clean_v)
    full = torch.full((S,), T, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: da.decode_attention(q, k, v, full))
    plain_ms = time_ms(lambda: da.decode_attention_torch(q, k, v, full))
    kd, vd = kvq.dequantize(k), kvq.dequantize(v)  # not timed
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd, vd))
    nbytes = 2 * S * H * T * D + 2 * S * H * T * 4 + 2 * S * H * D * 4 \
        + S * 4
    bound_ms, bound_by = _bound(nbytes, 4 * D * H * S * T)
    info = {d: da.int8_kernel_info(d) for d in (12, 32, 64, 128)}
    print(f"decode_attention int8 S={S} H={H} T={T} D={D}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA on the "
          f"dequantised f32 panel, dequantisation not timed) {lib_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms (share {bound_ms / ms:.3f}); "
          f"registers, spills, blocks per SM and load width by head dim: "
          f"{info}")
    return dict(max_abs_err=err, tol=INT8_TOL, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                info=info)


def check_paged_int8(dev):
    """The int8 paged kernel against its plain version at the paged
    phase's shapes (64 slots, 8 heads, blocks of 16, D=64, 64-entry
    tables, a 4096-block pool) over non-contiguous blocks, NaN in the
    null block's and every stale tail's scale rows, then timed with
    every slot at length 1024."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import kv_quant as kvq
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    S, H, Bs, D, B, N = 64, 8, 16, 64, 64, 4096
    T = B * Bs
    rs = np.random.RandomState(6)
    g = torch.Generator(device="cpu").manual_seed(6)
    q = torch.randn((S, H, D), generator=g).to(dev)
    k = kvq.quantize_rows(torch.randn((N, H, Bs, D), generator=g).to(dev))
    v = kvq.quantize_rows(torch.randn((N, H, Bs, D), generator=g).to(dev))
    clean_k, clean_v = k.scale.clone(), v.scale.clone()
    lens = rs.randint(1, T + 1, S)
    lens[:6] = [0, 1, 15, 16, 17, T]
    perm = rs.permutation(np.arange(1, N))
    tbl = np.zeros((S, B), np.int32)
    used = 0
    for s, n in enumerate(lens):
        nb = -(-int(n) // Bs)
        tbl[s, :nb] = perm[used:used + nb]
        used += nb
        if n % Bs:  # the stale tail of the last live block
            k.scale[int(tbl[s, nb - 1]), :, int(n % Bs):] = float("nan")
            v.scale[int(tbl[s, nb - 1]), :, int(n % Bs):] = float("nan")
    k.scale[0] = float("nan")  # the null block, where padded lanes write
    v.scale[0] = float("nan")
    tbl_d = torch.from_numpy(tbl).to(dev)
    lens_d = torch.from_numpy(lens.astype(np.int32)).to(dev)
    got = pa.paged_attention(q, k, v, tbl_d, lens_d)
    again = pa.paged_attention(q, k, v, tbl_d, lens_d)
    want = pa.paged_attention_torch(q, k, v, tbl_d, lens_d)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    zero_row = got[0].abs().max().item()
    same = torch.equal(got, again)
    print(f"paged_attention int8: max_abs_err {err:.3e} (tol {INT8_TOL:g}), "
          f"finite {finite}, len-0 row max {zero_row}, {used} live blocks, "
          f"two calls bit-identical {same}")
    if not (finite and err <= INT8_TOL and zero_row == 0.0 and same):
        raise AssertionError("paged_attention int8 disagrees with its plain "
                             "version or with itself")
    _refuses_mixed(lambda a, b: pa.paged_attention(q, a, b, tbl_d, lens_d),
                   k, kvq.dequantize(v))
    k.scale.copy_(clean_k)
    v.scale.copy_(clean_v)
    full_tbl = torch.from_numpy(np.resize(
        rs.permutation(np.arange(1, N)), S * B).reshape(S, B)
        .astype(np.int32)).to(dev)
    full = torch.full((S,), T, dtype=torch.int32, device=dev)
    gk, gv = pa.gather_blocks(k, full_tbl), pa.gather_blocks(v, full_tbl)
    kd = kvq.QuantArray(gk.q.contiguous(), gk.scale.contiguous())
    vd = kvq.QuantArray(gv.q.contiguous(), gv.scale.contiguous())
    got = pa.paged_attention(q, k, v, full_tbl, full)
    dense = da.decode_attention(q, kd, vd, full)
    torch.cuda.synchronize()
    slot_err = (got - dense).abs().max().item()
    if not slot_err <= DECODE_TOL_F32:
        raise AssertionError(f"paged_attention int8 disagrees with the int8 "
                             f"slot kernel on the gathered panel: "
                             f"{slot_err:.3e}")
    ms = time_ms(lambda: pa.paged_attention(q, k, v, full_tbl, full))
    plain_ms = time_ms(lambda: pa.paged_attention_torch(
        q, k, v, full_tbl, full))
    slot_ms = time_ms(lambda: da.decode_attention(q, kd, vd, full))
    kf, vf = kvq.dequantize(kd), kvq.dequantize(vd)  # not timed
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kf, vf))
    nbytes = 2 * S * H * T * D + 2 * S * H * T * 4 + 2 * S * H * D * 4 \
        + S * B * 4 + S * 4
    bound_ms, bound_by = _bound(nbytes, 4 * D * H * S * T)
    print(f"paged_attention int8 S={S} H={H} Bs={Bs} D={D} B={B} N={N}, "
          f"every length {T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"int8 slot kernel on the gathered panel {slot_ms:.4f} ms, "
          f"library (SDPA on the gathered dequantised f32 panel, gather and "
          f"dequantisation not timed) {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms")
    info = {d: pa.int8_kernel_info(d) for d in (12, 32, 64, 128)}
    print(f"paged_attention int8 registers, spills, blocks per SM and load "
          f"width by head dim: {info}")
    return dict(max_abs_err=err, tol=INT8_TOL, slot_kernel_err=slot_err,
                live_blocks=used, ms=ms, plain_ms=plain_ms,
                slot_kernel_dense_ms=slot_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, info=info)


def cpu_copy(lm, cfg):
    """The same model with its weights (int8 MLP weights included)
    copied to the CPU: the plain reference of the teacher-forced
    checks."""
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    cpu = CausalTransformerLM(**cfg, device="cpu")
    cpu._params = {k: (v.to("cpu") if k != "blocks" else
                       [{n: w.to("cpu") for n, w in bp.items()} for bp in v])
                   for k, v in lm._params.items()}
    return cpu


def f32_rows(cpu, prompt, tokens):
    """Plain f32 logits rows predicting each served token."""
    import torch
    with torch.inference_mode():
        logits = cpu.logits(np.asarray(list(prompt) + list(tokens))[None])[0]
    return logits[len(prompt) - 1:len(prompt) - 1 + len(tokens)]


def int8_slot_rows(cpu, prompt, tokens):
    """The port's own int8 slot path on the CPU: the prompt attends its
    own f32 K/V, which go into an int8 cache; each later token is a
    decode step over that cache, fed the served tokens."""
    return _slot_rows(cpu, prompt, tokens, "int8")


def bf16_slot_rows(cpu, prompt, tokens):
    """The port's own bf16 slot path on the CPU, as int8_slot_rows over
    a bf16 cache."""
    return _slot_rows(cpu, prompt, tokens, "bf16")


def _slot_rows(cpu, prompt, tokens, kv_dtype):
    import torch
    from deeplearning4j_tpu_torch.kernels.kv_quant import kv_update_slice
    from deeplearning4j_tpu_torch.serving import KVCache
    cache = KVCache(cpu.cache_shapes(), 1, kv_dtype=kv_dtype, device="cpu")
    params = cpu._params
    with torch.inference_mode():
        logits, ks, vs = cpu.forward_prefill(params,
                                             torch.tensor([list(prompt)]))
        for pool, slab in zip(cache.ks + cache.vs, ks + vs):
            kv_update_slice(pool, slab, (0, 0, 0, 0))
        rows = [logits[0, -1]]
        for j, t in enumerate(tokens[:-1]):
            lg, _, _ = cpu.forward_decode(
                params, torch.tensor([t]), torch.tensor([len(prompt) + j]),
                cache.ks, cache.vs)
            rows.append(lg[0])
    return torch.stack(rows)


def int8_paged_rows(cpu, prompt, tokens):
    """The port's own int8 paged path on the CPU: every query attends
    over the quantised pool, so one chunk over the whole served sequence
    gives every position's logits, whatever the chunking was."""
    import torch
    from deeplearning4j_tpu_torch.serving import PagedKVCache
    from deeplearning4j_tpu_torch.serving.paging import blocks_for
    bs = PAGED_ENGINE["block_size"]
    seq = list(prompt) + list(tokens[:-1])
    nb = blocks_for(len(seq), bs)
    pool = PagedKVCache(cpu.cache_shapes(bs), nb + 1, kv_dtype="int8",
                        device="cpu")
    with torch.inference_mode():
        logits, _, _ = cpu.forward_prefill_chunk(
            cpu._params, torch.tensor([seq]), 0, len(seq), pool.ks, pool.vs,
            torch.arange(1, nb + 1, dtype=torch.int32))
    return logits[len(prompt) - 1:]


def teacher_check(rows_fn, cpu, cases, tol=TEACHER_TOL, label=""):
    """Every served greedy token must have a reference logit within
    ``tol`` of the reference maximum at its position; ``rows_fn(cpu,
    prompt, tokens)`` gives the reference rows. ``cases`` are (prompt,
    served tokens); returns (checked, exact, worst gap)."""
    checked = exact = 0
    worst_gap = 0.0
    for prompt, tokens in cases:
        rows = rows_fn(cpu, prompt, tokens)
        for t, row in zip(tokens, rows):
            gap = float(row.max() - row[t])
            worst_gap = max(worst_gap, gap)
            exact += int(int(row.argmax()) == t)
            checked += 1
    if worst_gap > tol:
        raise AssertionError(f"teacher-forced check{label}: a served token "
                             f"is {worst_gap:.3e} below the reference "
                             f"maximum (tol {tol:g})")
    return checked, exact, worst_gap


def int8_vs_f32(f32_cpu, int8_cpu, cases, rows_fn):
    """Max |int8 - f32| logit over the cases' positions, relative to the
    largest f32 logit: what the int8 setup costs at this width
    (informative)."""
    diff = peak = 0.0
    for prompt, tokens in cases:
        a = f32_rows(f32_cpu, prompt, tokens)
        b = rows_fn(int8_cpu, prompt, tokens)
        diff = max(diff, float((a - b).abs().max()))
        peak = max(peak, float(a.abs().max()))
    return diff / peak


def slot_traffic():
    """Phase 4's (and phase 6's) 32 requests, from a fixed seed."""
    rs = np.random.RandomState(0)
    reqs = []
    for i in range(32):
        plen = int(rs.randint(8, 601))
        sampled = i % 8 == 7
        reqs.append(dict(prompt=rs.randint(0, 32000, plen).tolist(),
                         max_tokens=int(rs.randint(32, 65)),
                         temperature=0.8 if sampled else 0.0,
                         top_k=40 if sampled else 0, seed=i))
    return reqs


def serve(card: str, kv_dtype: str = "f32", cfg=SERVE_CFG, device=None,
          eager_ab: bool = False, chaos: bool = False, traced: bool = False):
    """Phase 4 (f32), 6 (int8) or 13 (bf16): the slot backend end to end,
    the decode step replayed as the engine's CUDA graph on the card. With
    ``chaos``, phase 11 then reruns the traffic on the same warmed engine
    under :data:`SLOT_FAULT_PLAN` (:func:`fault_ladder`); with ``traced``,
    phase 15a then runs it in traced and untraced turns
    (:func:`traced_turns`). With ``eager_ab`` the same traffic then runs
    through the eager step and must give the same tokens."""
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    int8 = kv_dtype == "int8"
    phase = {"f32": 4, "int8": 6, "bf16": 13}[kv_dtype]
    # the reference rows of the teacher-forced checks: at int8 and bf16
    # the port's own path over such a cache on the CPU
    rows_fn, tol = {"f32": (f32_rows, TEACHER_TOL),
                    "int8": (int8_slot_rows, INT8_TEACHER_TOL),
                    "bf16": (bf16_slot_rows, BF16_TEACHER_TOL)}[kv_dtype]
    lm = CausalTransformerLM(**cfg, device=device).init()
    engine_kw = dict(num_slots=32, kv_dtype=kv_dtype)
    eng = GenerationEngine(lm, **engine_kw)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        captures = warmed_compiles(eng)
        graphs = graph_memory(eng)
        calls = count_calls(eng)
        reqs = slot_traffic()
        st0 = eng.stats()
        reset_launches()
        results, wall = run_requests(eng, reqs)
        launches = {"decode_attention": da.launches,
                    "decode_attention_int8": da.launches_int8,
                    "flash_attention": fa.launches}
        st = eng.stats()
        check_lengths(results, reqs)
        steps = st["decode_steps"] - st0["decode_steps"]
        decode = "decode_attention_int8" if int8 else "decode_attention"
        other = "decode_attention" if int8 else "decode_attention_int8"
        if launches[decode] != cfg["n_layers"] * steps or not steps \
                or launches[other] or not launches["flash_attention"]:
            raise AssertionError(f"launches {launches} over {steps} decode "
                                 f"steps: {decode} must run "
                                 f"{cfg['n_layers']} x steps, flash must run")
        n_tok = sum(len(r["tokens"]) for r in results)
        prof = profile_window(eng)
        no_capture_since(eng, captures)
        replay = (busiest_replay(eng, calls, "prefill") if eng._cuda_graph
                  else None)
        ladder = None
        if chaos:
            ladder = fault_ladder(
                eng, card, f"slots {kv_dtype} on phase {phase}'s engine",
                reqs, results, SLOT_FAULT_PLAN, lambda: cpu_copy(lm, cfg),
                rows_fn, tol, cfg["n_layers"])
        trace15 = None
        if traced:
            trace15 = traced_turns(
                eng, card, f"15a, slots {kv_dtype} on phase {phase}'s "
                f"engine", [reqs], [r["tokens"] for r in results], captures,
                cfg["n_layers"], "decode_attention." + (
                    "launches_int8" if int8 else "launches"),
                also=("flash_attention.launches",))
    finally:
        eng.stop()
    eager = eager_run(lm, engine_kw, reqs, results) if eager_ab else None

    # teacher-forced check: every greedy token the card emitted has a
    # CPU logit within the tolerance of the CPU maximum there
    greedy = [i for i, q in enumerate(reqs) if q["temperature"] == 0.0][:4]
    cases = [(reqs[i]["prompt"], results[i]["tokens"]) for i in greedy]
    cpu = cpu_copy(lm, cfg)
    checked, exact, worst_gap = teacher_check(rows_fn, cpu, cases, tol)
    rel = int8_vs_f32(cpu, cpu, cases[:2], int8_slot_rows) if int8 else None
    e2e = dict(kv_dtype=kv_dtype, requests=len(reqs), tokens=n_tok,
               wall_s=wall, tokens_per_s=n_tok / wall,
               ttft_p50_ms=st["ttft_ms"]["p50"],
               ttft_p99_ms=st["ttft_ms"]["p99"],
               decode_step_p50_ms=st["decode_step_ms"]["p50"],
               decode_step_p99_ms=st["decode_step_ms"]["p99"],
               decode_sync_wait_p50_ms=st["decode_sync_wait_ms"]["p50"],
               decode_sync_wait_p99_ms=st["decode_sync_wait_ms"]["p99"],
               prefill_p50_ms=st["prefill_ms"]["p50"],
               decode_steps=steps, prefills=st["prefills"],
               cuda_graph=eng._cuda_graph, compiles_after_warmup=captures,
               graphs=graphs, busiest_replay=replay, eager=eager,
               mean_occupancy=st["slots"]["mean_occupancy"],
               kv_cache_bytes=st["kv_cache_bytes"],
               kv_bytes_per_token=st["kv_bytes_per_token"],
               quant=st["quant"], warmup_s=warm_s, launches=launches,
               teacher_checked=checked, teacher_exact=exact,
               teacher_exact_rate=exact / max(checked, 1),
               teacher_worst_gap=worst_gap, teacher_tol=tol,
               int8_vs_f32_logit_rel_err=rel, profile=prof,
               fault_ladder=ladder, traced=trace15,
               served=(None, [(reqs, results)]))
    tag = "" if kv_dtype == "f32" else f" {kv_dtype}"
    print(f"e2e{tag} [{card}]: {n_tok} tokens from {len(reqs)} requests in "
          f"{wall:.3f} s = {e2e['tokens_per_s']:.1f} tokens/s, TTFT p50/p99 "
          f"{e2e['ttft_p50_ms']:.1f}/{e2e['ttft_p99_ms']:.1f} ms, prefill "
          f"p50 {e2e['prefill_p50_ms']:.2f} ms, decode step p50/p99 "
          f"{e2e['decode_step_p50_ms']:.2f}/{e2e['decode_step_p99_ms']:.2f} "
          f"ms, sync wait p50/p99 {e2e['decode_sync_wait_p50_ms']:.2f}/"
          f"{e2e['decode_sync_wait_p99_ms']:.2f} ms, launches {launches} "
          f"over {steps} decode steps and {e2e['prefills']} prefills; "
          f"{graph_line(graphs)}{replay_line(replay)}; cache "
          f"{st['kv_cache_bytes']} bytes, {st['kv_bytes_per_token']} bytes "
          f"per token")
    if eager is not None:
        print(f"e2e{tag} eager [{card}]: the same requests on the engine "
              f"with no CUDA graph: {eager['identical']} requests' tokens "
              f"identical to the graphs', {eager['tokens_per_s']:.1f} "
              f"tokens/s, TTFT p50 {eager['ttft_p50_ms']:.1f} ms, prefill "
              f"p50 {eager['prefill_p50_ms']:.2f} ms, decode step p50/p99 "
              f"{eager['decode_step_p50_ms']:.2f}/"
              f"{eager['decode_step_p99_ms']:.2f} ms, sync wait p50 "
              f"{eager['decode_sync_wait_p50_ms']:.2f} ms")
    print(f"teacher-forced{tag}: {checked} greedy tokens checked, "
          f"exact-match rate {e2e['teacher_exact_rate']:.4f}, worst gap "
          f"{worst_gap:.3e} (tol {tol:g})"
          + (f"; int8-vs-f32 max logit rel err {rel:.4e} (informative)"
             if int8 else ""))
    print_profile(f"profile window{tag}", card, prof)
    return e2e


def check_flash_bwd(dev):
    """Phase 8: the dQ and dK/dV kernels against their plain versions
    across the prefill buckets, then timed at the training shapes."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    B, H, D = 4, 8, 64
    g = torch.Generator(device="cpu").manual_seed(8)
    worst = {"dq": 0.0, "dkv": 0.0}
    per_bucket = {}
    T = 8
    while T <= 1024:
        q, k, v, do = (torch.randn((B, T, H, D), generator=g).to(dev)
                       for _ in range(4))
        # rows of length T, ~3T/4, ~T/3 and 0 (every key masked)
        lens = torch.tensor([T, (3 * T) // 4 + 1, T // 3 + 1, 0])
        km = (torch.arange(T)[None] < lens[:, None]).to(torch.float32)
        km = km.to(dev)
        out, lse = fa.flash_attention(q, k, v, True, km)
        delta = fa.backward_delta(do, out)
        dq = fa.flash_attention_bwd_dq(q, k, v, km, do, lse, delta, True)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, km, do, lse, delta,
                                            True)
        _same_bits((dq, dk, dv), (q, k, v, km, do, lse, delta), f"T={T}")
        want_dq = fa.flash_attention_bwd_dq_torch(q, k, v, km, do, lse,
                                                  delta, True)
        want_dk, want_dv = fa.flash_attention_bwd_dkv_torch(
            q, k, v, km, do, lse, delta, True)
        torch.cuda.synchronize()
        errs = {}
        for name, pairs in (("dq", ((dq, want_dq),)),
                            ("dkv", ((dk, want_dk), (dv, want_dv)))):
            err = max((a - b).abs().max().item() for a, b in pairs)
            scale = max(max(b.abs().max().item() for _, b in pairs), 1.0)
            finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
            masked_row = max(a[3].abs().max().item() for a, _ in pairs)
            if not (finite and err <= FLASH_BWD_TOL * scale
                    and masked_row == 0.0):
                raise AssertionError(
                    f"flash backward {name} T={T} disagrees with its plain "
                    f"version: {err:.3e} (scale {scale:.2f}), finite "
                    f"{finite}, fully masked row max {masked_row}")
            errs[name] = err
            worst[name] = max(worst[name], err)
        per_bucket[T] = errs
        T *= 2
    print(f"flash backward buckets 8..1024, B={B} H={H} D={D} causal, "
          f"ragged key mask, a fully masked row: max_abs_err dq "
          f"{worst['dq']:.3e}, dk/dv {worst['dkv']:.3e} (tol "
          f"{FLASH_BWD_TOL:g} x max(1, largest gradient)); per bucket "
          f"{per_bucket}")

    # timed at the training shapes: T=1024, causal, every key live
    T = 1024
    q, k, v, do = (torch.randn((B, T, H, D), generator=g).to(dev)
                   for _ in range(4))
    km = torch.ones((B, T), device=dev)
    out, lse = fa.flash_attention(q, k, v, True, km)
    delta = fa.backward_delta(do, out)
    args = (q, k, v, km, do, lse, delta)
    _same_bits((fa.flash_attention_bwd_dq(*args, True),
                *fa.flash_attention_bwd_dkv(*args, True)), args, f"T={T}")
    pairs = T * (T + 1) // 2
    tensor = B * T * H * D * 4
    rows = B * H * T * 4
    res = {}
    for name, fn, plain, flops, nbytes in (
            ("dq",
             lambda: fa.flash_attention_bwd_dq(q, k, v, km, do, lse, delta,
                                               True),
             lambda: fa.flash_attention_bwd_dq_torch(q, k, v, km, do, lse,
                                                     delta, True),
             6 * D * B * H * pairs, 5 * tensor + 2 * rows + B * T * 4),
            ("dkv",
             lambda: fa.flash_attention_bwd_dkv(q, k, v, km, do, lse, delta,
                                                True),
             lambda: fa.flash_attention_bwd_dkv_torch(q, k, v, km, do, lse,
                                                      delta, True),
             8 * D * B * H * pairs, 6 * tensor + 2 * rows + B * T * 4)):
        # the kernels run three TF32 products per f32 product (3xTF32)
        bound_ms, bound_by = _bound(nbytes, 3 * flops, H100_TF32_FLOPS)
        bound_f32_ms, _ = _bound(nbytes, flops)
        ms = time_ms(fn)
        res[name] = dict(max_abs_err=worst[name], tol=FLASH_BWD_TOL,
                         per_bucket={t: e[name]
                                     for t, e in per_bucket.items()},
                         ms=ms, plain_ms=time_ms(plain),
                         bound_ms=bound_ms, bound_by=bound_by,
                         bound_f32_ms=bound_f32_ms,
                         share_of_bound=bound_ms / ms,
                         share_of_f32_bound=bound_f32_ms / ms,
                         gflop=flops / 1e9)
    # the library yardstick: SDPA's backward (dq, dk and dv in one) on
    # the same f32 inputs and mask, timed on a retained graph
    mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()[None,
                                                                   None]
    mask = mask & (km > 0)[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(1, 2)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                   retain_graph=True)
    lib_ms = time_ms(lib_bwd)
    backend = _top_kernel(lib_bwd)
    for name in res:
        res[name]["library_ms"] = lib_ms
        res[name]["library_backend"] = backend
    pair_ms = res["dq"]["ms"] + res["dkv"]["ms"]
    res["pair"] = dict(ms=pair_ms, library_ms=lib_ms,
                       ratio_to_library=pair_ms / lib_ms)
    res["occupancy"] = {d: fa.bwd_kernel_info(d) for d in (32, 64, 128)}
    for name, label in (("dq", "dQ (B6)"), ("dkv", "dK/dV (B7)")):
        r = res[name]
        print(f"flash backward {label} B={B} H={H} T={T} D={D} causal: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library (SDPA backward, dq+dk+dv, {backend}) "
              f"{lib_ms:.4f} ms, bound {r['bound_ms']:.4f} ms at 3xTF32 "
              f"(share {r['share_of_bound']:.3f}), {r['bound_f32_ms']:.4f} "
              f"ms at f32 (share {r['share_of_f32_bound']:.3f}) "
              f"({r['gflop']:.2f} GFLOP)")
    print(f"flash backward B6 + B7: {pair_ms:.4f} ms against SDPA's backward "
          f"{lib_ms:.4f} ms (ratio {pair_ms / lib_ms:.3f}); two calls of each "
          f"kernel bit-identical in every bucket; shared bytes and blocks "
          f"per SM by head dim {res['occupancy']}")
    return res


def _same_bits(got, args, where):
    """A second call of the dQ and dK/dV kernels on ``args`` (q, k, v,
    key mask, dO, lse, delta; causal) must give the bits of ``got`` (one
    owner per gradient row, no atomics)."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    again = (fa.flash_attention_bwd_dq(*args, True),
             *fa.flash_attention_bwd_dkv(*args, True))
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"flash backward {name} {where}: two calls "
                                 f"on the same inputs differ")


def check_flash_bf16(dev):
    """Phases 3 and 8 for the bf16 legs of B3, B6 and B7: each against
    its plain version (f32 from the same bf16 values) at phase 10's
    shapes (B=4, H=8, T=1024, D=64) and at B=1, causal and not, with a
    ragged key mask and (at B=4) a fully masked row (O and every
    gradient exactly 0, LSE -1e30), two calls of each bit-identical;
    then each timed at the training shapes (causal, every key live)
    beside its bound at the bf16 rate, its plain version and one library
    call (SDPA at bf16 for the forward, SDPA's backward at bf16 for the
    backward pair), with registers, spills, shared memory, blocks per SM
    and threads by head dim. The forward (see fwd_against_sdpa), the
    pair and the port's whole backward (delta included; see
    bwd_against_sdpa) are also held against SDPA at bf16, with the mask
    and with is_causal, there and at B = 1 and T = 2048 and 4096."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    H, T, D = 8, 1024, 64
    g = torch.Generator(device="cpu").manual_seed(10)
    worst = {"fwd": 0.0, "lse": 0.0, "dq": 0.0, "dkv": 0.0}
    cases = {}

    def scaled(a, b):
        a, b = a.float(), b.float()
        return ((a - b).abs().max() / max(b.abs().max().item(), 1.0)).item()

    for B in (1, 4):
        q, k, v, do = (torch.randn((B, T, H, D), generator=g).to(dev)
                       .bfloat16() for _ in range(4))
        # rows of length T, ~3T/4, ~T/3 and 0 (every key masked)
        lens = torch.tensor([T, (3 * T) // 4 + 1, T // 3 + 1, 0][:B]
                            if B == 4 else [(3 * T) // 4 + 1])
        km = (torch.arange(T)[None] < lens[:, None]).to(torch.float32)
        km = km.to(dev)
        for causal in (False, True):
            out, lse = fa.flash_attention(q, k, v, causal, km)
            again = fa.flash_attention(q, k, v, causal, km)
            ro, rl = fa.flash_attention_torch(q, k, v, causal, km)
            delta = fa.backward_delta(do, ro)
            args = (q, k, v, km, do, rl, delta)
            dq = fa.flash_attention_bwd_dq(*args, causal)
            dk, dv = fa.flash_attention_bwd_dkv(*args, causal)
            dq2 = fa.flash_attention_bwd_dq(*args, causal)
            dk2, dv2 = fa.flash_attention_bwd_dkv(*args, causal)
            want_dq = fa.flash_attention_bwd_dq_torch(*args, causal)
            want_dk, want_dv = fa.flash_attention_bwd_dkv_torch(*args,
                                                                causal)
            torch.cuda.synchronize()
            same = (all(torch.equal(a, b) for a, b in zip((out, lse), again))
                    and torch.equal(dq, dq2) and torch.equal(dk, dk2)
                    and torch.equal(dv, dv2))
            errs = dict(fwd=scaled(out, ro),
                        lse=(lse - rl).abs().max().item(),
                        dq=scaled(dq, want_dq),
                        dkv=max(scaled(dk, want_dk), scaled(dv, want_dv)))
            masked = (max(x[3].abs().max().item()
                          for x in (out, dq, dk, dv)) == 0.0
                      and bool((lse[3] == -1e30).all())) if B == 4 else True
            finite = all(bool(torch.isfinite(x).all())
                         for x in (out, dq, dk, dv))
            ok = (errs["fwd"] <= FLASH_BF16_O_TOL
                  and errs["lse"] <= FLASH_BF16_LSE_TOL
                  and errs["dq"] <= FLASH_BF16_GRAD_TOL
                  and errs["dkv"] <= FLASH_BF16_GRAD_TOL)
            if not (ok and same and masked and finite
                    and out.dtype == dq.dtype == torch.bfloat16):
                raise AssertionError(
                    f"bf16 flash legs B={B} causal={causal}: errors {errs} "
                    f"(tol O {FLASH_BF16_O_TOL:g}, grads "
                    f"{FLASH_BF16_GRAD_TOL:g}, LSE {FLASH_BF16_LSE_TOL:g}), "
                    f"two calls identical {same}, fully masked row 0 "
                    f"{masked}, finite {finite}")
            cases[f"B={B} causal={causal}"] = errs
            for key in worst:
                worst[key] = max(worst[key], errs[key])
    print(f"flash bf16 legs at H={H} T={T} D={D}, B=1 and B=4, causal and "
          f"not, ragged key mask, a fully masked row at B=4 (O, LSE and "
          f"gradients exact): errors (O and gradients over max(1, max)) "
          f"{cases}; two calls of each leg bit-identical")

    # timed at the training shapes, causal, every key live
    B = 4
    q, k, v, do = (torch.randn((B, T, H, D), generator=g).to(dev).bfloat16()
                   for _ in range(4))
    km = torch.ones((B, T), device=dev)
    out, lse = fa.flash_attention(q, k, v, True, km)
    delta = fa.backward_delta(do, out)
    pairs = T * (T + 1) // 2
    tensor = B * T * H * D * 2          # one bf16 [B, T, H, D] tensor
    rows = B * H * T * 4                # one f32 [B, H, T] row vector
    mask_bytes = B * T * 4
    res = {}
    for name, fn, plain, flops, nbytes in (
            ("fwd", lambda: fa.flash_attention(q, k, v, True, km),
             lambda: fa.flash_attention_torch(q, k, v, True, km),
             4 * D * B * H * pairs, 4 * tensor + rows + mask_bytes),
            ("dq",
             lambda: fa.flash_attention_bwd_dq(q, k, v, km, do, lse, delta,
                                               True),
             lambda: fa.flash_attention_bwd_dq_torch(q, k, v, km, do, lse,
                                                     delta, True),
             6 * D * B * H * pairs, 5 * tensor + 2 * rows + mask_bytes),
            ("dkv",
             lambda: fa.flash_attention_bwd_dkv(q, k, v, km, do, lse, delta,
                                                True),
             lambda: fa.flash_attention_bwd_dkv_torch(q, k, v, km, do, lse,
                                                      delta, True),
             8 * D * B * H * pairs, 6 * tensor + 2 * rows + mask_bytes)):
        bound_ms, bound_by = _bound(nbytes, flops, H100_BF16_FLOPS)
        ms = time_ms(fn)
        res[name] = dict(max_abs_err=worst[name], tol=FLASH_BF16_O_TOL
                         if name == "fwd" else FLASH_BF16_GRAD_TOL,
                         ms=ms, plain_ms=time_ms(plain), bound_ms=bound_ms,
                         bound_by=bound_by, share_of_bound=bound_ms / ms,
                         gflop=flops / 1e9, mbytes=nbytes / 1e6)
    res["fwd"]["lse_err"] = worst["lse"]
    # the library yardsticks, on the same bf16 inputs and mask
    mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()[None,
                                                                   None]
    mask = mask & (km > 0)[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))

    def fwd_lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    res["fwd"]["library_ms"] = time_ms(fwd_lib)
    res["fwd"]["library_backend"] = _top_kernel(fwd_lib)
    res["fwd"]["library_causal_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    lib_out = fwd_lib()
    dot = do.transpose(1, 2)
    backend = _top_kernel(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))
    res["pair"] = bwd_against_sdpa(dev, q, k, v, km, do, out, lse, mask)
    res["pair"]["library_backend"] = backend
    for name in ("dq", "dkv"):
        res[name]["library_ms"] = res["pair"]["library_ms"]
        res[name]["library_backend"] = backend
    # the forward and the pair at B = 1 and at longer sequences
    res["long"], res["fwd_long"] = {}, {}
    for Bl, Tl in ((1, 1024), (4, 2048), (1, 2048), (4, 4096), (1, 4096)):
        ql, kl, vl, dol = (torch.randn((Bl, Tl, H, D), generator=g).to(dev)
                           .bfloat16() for _ in range(4))
        kml = torch.ones((Bl, Tl), device=dev)
        outl, lsel = fa.flash_attention(ql, kl, vl, True, kml)
        maskl = torch.ones((Tl, Tl), dtype=torch.bool, device=dev).tril()[
            None, None] & (kml > 0)[:, None, None, :]
        res["fwd_long"][f"B={Bl} T={Tl}"] = fwd_against_sdpa(
            ql, kl, vl, kml, maskl)
        res["long"][f"B={Bl} T={Tl}"] = bwd_against_sdpa(
            dev, ql, kl, vl, kml, dol, outl, lsel, maskl)
    res["cases"] = cases
    res["info"] = {d: fa.bf16_kernel_info(d) for d in (32, 64, 128)}
    for name, label in (("fwd", "forward (B3)"), ("dq", "dQ (B6)"),
                        ("dkv", "dK/dV (B7)")):
        r = res[name]
        print(f"flash bf16 {label} B={B} H={H} T={T} D={D} causal: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms ({r['library_backend']}), bound "
              f"{r['bound_ms']:.5f} ms at bf16 ({r['bound_by']}; share "
              f"{r['share_of_bound']:.3f}) ({r['gflop']:.3f} GFLOP, "
              f"{r['mbytes']:.2f} MB)")
    print(f"flash bf16 forward (B3) B={B} T={T} against SDPA's bf16 "
          f"forward with is_causal: {res['fwd']['ms']:.4f} ms against "
          f"{res['fwd']['library_causal_ms']:.4f} ms")
    for shape, r in res["fwd_long"].items():
        print(f"flash bf16 forward (B3) {shape} H={H} D={D} causal: "
              f"{r['ms']:.4f} ms, against SDPA's bf16 forward with the mask "
              f"{r['library_ms']:.4f} ms and with is_causal "
              f"{r['library_causal_ms']:.4f} ms")
    for shape, r in [(f"B={B} T={T}", res["pair"])] + list(
            res["long"].items()):
        print(f"flash bf16 backward {shape} H={H} D={D} causal: B6 + B7 "
              f"{r['ms']:.4f} ms, the whole backward (delta "
              f"{r['delta_ms']:.4f} + B6 + B7) {r['whole_ms']:.4f} ms, "
              f"against SDPA's bf16 backward with the mask "
              f"{r['library_ms']:.4f} ms (pair ratio "
              f"{r['ratio_to_library']:.3f}, whole "
              f"{r['whole_ratio_to_library']:.3f}) and with is_causal "
              f"{r['library_causal_ms']:.4f} ms (pair "
              f"{r['ms'] / r['library_causal_ms']:.3f}, whole "
              f"{r['whole_ms'] / r['library_causal_ms']:.3f})")
    print(f"flash bf16 registers, spills, shared bytes, blocks per SM and "
          f"threads by head dim {res['info']}")
    return res


def fwd_against_sdpa(q, k, v, km, mask):
    """The bf16 forward's device time on these inputs (causal) beside
    SDPA's bf16 forward on the same values, once with the boolean mask
    the kernel applies and once with ``is_causal`` (every key live here,
    so the same function). Library calls are yardsticks only."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return dict(
        ms=time_ms(lambda: fa.flash_attention(q, k, v, True, km)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
        library_causal_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)))


def bwd_against_sdpa(dev, q, k, v, km, do, out, lse, mask):
    """The bf16 backward's device time on these inputs (causal): the dQ
    and dK/dV kernels alone (the pair) and the port's whole backward
    (``flash_attention_bwd``: delta, then both kernels), beside SDPA's
    bf16 backward on the same values, once with the boolean mask the
    kernels apply (causal and key mask) and once with ``is_causal``
    (every key live here, so the same function; SDPA picks its own
    kernel for each). Library calls are yardsticks only."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    delta = fa.backward_delta(do, out)
    dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, km, do, lse,
                                                      delta, True))
    dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, km, do, lse,
                                                        delta, True))
    whole_ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, km, out, lse,
                                                      do, True))
    delta_ms = time_ms(lambda: fa.backward_delta(do, out))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    lib = {}
    for name, kw in (("mask", dict(attn_mask=mask)),
                     ("causal", dict(is_causal=True))):
        o = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        lib[name] = time_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True))
    pair_ms = dq_ms + dkv_ms
    return dict(ms=pair_ms, pair_dq_ms=dq_ms, pair_dkv_ms=dkv_ms,
                whole_ms=whole_ms, delta_ms=delta_ms,
                library_ms=lib["mask"], library_causal_ms=lib["causal"],
                ratio_to_library=pair_ms / lib["mask"],
                whole_ratio_to_library=whole_ms / lib["mask"])


def _top_kernel(fn) -> str:
    """Name of the longest device kernel of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    best, best_us = "not traced", -1.0
    for e in p.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > best_us:
            best, best_us = e.key, us
    return best[:100]


def train_conf(cfg):
    """The training phase's network in the layer DSL."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        TransformerEncoderLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        EmbeddingSequenceLayer, RnnOutputLayer)
    b = (NeuralNetConfiguration.builder().seed(cfg["seed"])
         .updater(Adam(cfg["lr"])).weight_init("xavier")
         .remat(cfg.get("remat", False))
         .data_type(cfg.get("dtype", "float")).list()
         .layer(EmbeddingSequenceLayer(n_in=cfg["vocab_size"],
                                       n_out=cfg["d_model"])))
    for _ in range(cfg["n_layers"]):
        b = b.layer(TransformerEncoderLayer(n_heads=cfg["n_heads"],
                                            d_ff=cfg["d_ff"], causal=True))
    return (b.layer(RnnOutputLayer(n_out=cfg["vocab_size"], loss="mcxent",
                                   activation="softmax"))
            .input_type_recurrent(1, timesteps=cfg["seq_len"]).build())


def recurrence_batch(cfg, batch, seed, device):
    """Token rows of t[i+1] = (a t[i] + b) mod vocab from seeded starts:
    the next token is a function of the current one, so the loss can
    fall. Returns tokens [batch, T] and one-hot labels [batch, T, vocab]
    made on ``device``."""
    import torch
    V, T = cfg["vocab_size"], cfg["seq_len"]
    rs = np.random.RandomState(seed)
    seq = np.empty((batch, T + 1), np.int64)
    seq[:, 0] = rs.randint(0, V, batch)
    for i in range(T):
        seq[:, i + 1] = (7919 * seq[:, i] + 12345) % V
    seq = torch.from_numpy(seq).to(device)
    y = torch.zeros((batch, T, V), device=device)
    y.scatter_(2, seq[:, 1:, None], 1.0)
    return seq[:, :T], y


def train(card: str, cfg=TRAIN_CFG, device=None, steps=TRAIN_STEPS):
    """Phase 9 (f32) and, with ``cfg["dtype"] = "bfloat16"``, phase 10
    (the bf16 mixed-precision policy): the training path end to end (see
    the module doc). The phase's flash legs (f32 or bf16) must each
    launch once per layer and step, and the other legs never."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    bf16 = cfg.get("dtype", "float") == "bfloat16"
    net = MultiLayerNetwork(train_conf(cfg), device=device)
    t0 = time.perf_counter()
    net.init()
    init_s = time.perf_counter() - t0
    dev = net.device
    x, y = recurrence_batch(cfg, cfg["batch"], cfg["seed"], dev)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms, enqueue_ms = [], [], []
    for _ in range(1 + steps):   # one warmup step, then the timed ones
        t0 = time.perf_counter()
        net.fit(x, y)
        # fit returns once the step is queued: the host's share
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        if on_card:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score_)
    f32_legs = {"flash_attention": fa.launches,
                "flash_attention_bwd_dq": fa.launches_dq,
                "flash_attention_bwd_dkv": fa.launches_dkv}
    bf16_legs = {"flash_attention_bf16": fa.launches_bf16,
                 "flash_attention_bwd_dq_bf16": fa.launches_dq_bf16,
                 "flash_attention_bwd_dkv_bf16": fa.launches_dkv_bf16}
    launches = dict(f32_legs, **bf16_legs)
    want = cfg["n_layers"] * (1 + steps)
    ran, idle = (bf16_legs, f32_legs) if bf16 else (f32_legs, bf16_legs)
    if any(n != want for n in ran.values()) or any(idle.values()):
        raise AssertionError(
            f"launches {launches}: each {'bf16' if bf16 else 'f32'} flash "
            f"leg must run {cfg['n_layers']} layers x {1 + steps} steps = "
            f"{want} times, the other legs never")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    dtypes = sorted({str(t.dtype) for p in net.params().values()
                     for t in p.values()} |
                    {str(t.dtype) for st in net.get_updater_state().values()
                     for part in st.values() if isinstance(part, dict)
                     for t in part.values()})
    if dtypes != ["torch.float32"]:
        raise AssertionError(f"master params and Adam state must stay f32: "
                             f"{dtypes}")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    timed = sorted(step_ms[1:])
    p50 = timed[len(timed) // 2]
    enqueue_p50 = sorted(enqueue_ms[1:])[steps // 2]
    tokens = cfg["batch"] * cfg["seq_len"]
    prof = profile_train_step(net, x, y) if on_card else None
    grad = grad_check(cfg, device)
    phase = "train bf16" if bf16 else "train"
    res = dict(cfg=cfg, steps=steps, losses=losses, step_ms=step_ms,
               step_p50_ms=p50, enqueue_ms=enqueue_ms,
               enqueue_p50_ms=enqueue_p50, tokens_per_step=tokens,
               tokens_per_s=tokens / (p50 / 1e3), peak_bytes=peak,
               params=net.num_params(), init_s=init_s, launches=launches,
               master_dtypes=dtypes, grad_check=grad, profile=prof)
    print(f"{phase} [{card}]: {net.num_params()} params, {steps} timed "
          f"Adam steps of {tokens} tokens after one warmup: step p50 "
          f"{p50:.2f} ms (all {[round(t, 2) for t in step_ms]}; queued by "
          f"the host in p50 {enqueue_p50:.2f} ms), "
          f"{res['tokens_per_s']:.1f} tokens/s, loss "
          f"{[round(v, 4) for v in losses]}, peak "
          f"{'not measured' if peak is None else f'{peak / 2**30:.3f} GiB'}"
          f", launches {launches}, masters and Adam state {dtypes}")
    print(f"{phase} gradient check (2 blocks, B=1, card vs CPU): loss rel "
          f"err {grad['loss_rel_err']:.3e} (tol {grad['loss_tol']:g}), "
          f"worst leaf {grad['worst_leaf']} at {grad['worst_rel_err']:.3e} "
          f"of its max (tol {grad['grad_tol']:g}), {grad['leaves']} leaves")
    if prof is not None:
        print(f"{phase} profile [{card}] (one step, profiler on): device "
              f"busy {prof['busy_share']:.3f} of {prof['wall_ms']:.1f} ms, "
              f"{prof['device_kernels']} device kernels; by kind (ms) "
              f"{ {k: round(v, 3) for k, v in prof['by_kind'].items()} }; "
              f"top kernels (ms): "
              + ", ".join(f"{n[:60]} {t:.3f}" for n, t in prof["top"]))
        print(f"{phase} profile: host ops by self CPU ms (calls): "
              + ", ".join(f"{n[:40]} {t:.2f} ({c})"
                          for n, t, c in prof["host_top"]))
    return res


def profile_train_step(net, x, y):
    """Kernel time by name and the device's busy share over one train
    step, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    n_kernels = 0
    host = []
    for e in p.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append((e.key, e.self_cpu_time_total / 1e3, e.count))
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
        n_kernels += e.count
    busy_ms = sum(kernels.values())
    # layout copies: PyTorch's copy kernels and cuDNN's transposes (the
    # convolutions' NHWC <-> NCHW views, among other copies)
    layout = {n: ms for n, ms in kernels.items()
              if re.search(r"copy|nchwToNhwc|nhwcToNchw|transpose", n)}
    # convolutions: cuDNN's forward, data-gradient and weight-gradient
    # kernels (implicit GEMMs and its own engines)
    conv_ms = sum(ms for n, ms in kernels.items()
                  if re.search(r"fprop|dgrad|wgrad|conv", n))
    # device time by kind: the flash kernels, bf16 and f32 GEMMs (cuBLAS
    # names a GEMM's types, except its nvjet kernels, which run only
    # half-precision tensor-core products here: TF32 is off), everything
    # else (elementwise, reductions, copies, casts, the loss and Adam)
    by_kind = {"flash": 0.0, "gemm_bf16": 0.0, "gemm_f32": 0.0, "other": 0.0}
    gemms = {}
    for name, ms in kernels.items():
        low = name.lower()
        if "flash_" in name:
            kind = "flash"
        elif "gemm" in low or low.startswith("nvjet"):
            kind = "gemm_bf16" if "bf16" in low or low.startswith("nvjet") \
                else "gemm_f32"
            gemms[name[:120]] = (kind, ms)
        else:
            kind = "other"
        by_kind[kind] += ms
    return dict(wall_ms=wall * 1e3, busy_ms=busy_ms,
                busy_share=busy_ms / (wall * 1e3), device_kernels=n_kernels,
                by_kind=by_kind, gemms=gemms,
                layout_ms=sum(layout.values()), conv_ms=conv_ms,
                layout_top=sorted(layout.items(), key=lambda kv: -kv[1])[:4],
                top=sorted(kernels.items(), key=lambda kv: -kv[1])[:10],
                host_top=sorted(host, key=lambda h: -h[1])[:12])


def grad_check(cfg, device=None):
    """One step's loss and gradients of a reduced copy (2 blocks, the
    full width, B=1, T=1024) on the network's device (the flash
    kernels) against the same params on the CPU (plain attention), at
    the configuration's dtype (f32, or the bf16 policy on both sides)."""
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    small = dict(cfg, n_layers=2)
    net = MultiLayerNetwork(train_conf(small), device=device).init()
    cpu = MultiLayerNetwork(train_conf(small), device="cpu").init()
    cpu.set_params({k: {n: t.cpu() for n, t in p.items()}
                    for k, p in net.params().items()})
    x, y = recurrence_batch(small, 1, cfg["seed"] + 1, net.device)
    loss, grads = net.loss_and_gradients(x, y)
    ref_loss, ref = cpu.loss_and_gradients(x.cpu(), y.cpu())
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    worst, worst_leaf = 0.0, None
    for key, p in ref.items():
        for name, t in p.items():
            err = float((grads[key][name].cpu() - t).abs().max()) / max(
                float(t.abs().max()), 1e-30)
            if err >= worst:
                worst, worst_leaf = err, f"{key}.{name}"
    n = sum(len(p) for p in ref.values())
    bf16 = cfg.get("dtype", "float") == "bfloat16"
    loss_tol = TRAIN_BF16_LOSS_RTOL if bf16 else TRAIN_LOSS_RTOL
    grad_tol = TRAIN_BF16_GRAD_TOL if bf16 else TRAIN_GRAD_TOL
    if not (loss_rel <= loss_tol and worst <= grad_tol):
        raise AssertionError(f"card vs CPU: loss rel err {loss_rel:.3e}, "
                             f"{worst_leaf} off by {worst:.3e} of its max")
    return dict(loss=float(loss), cpu_loss=float(ref_loss),
                loss_rel_err=loss_rel, worst_rel_err=worst,
                worst_leaf=worst_leaf, leaves=n, loss_tol=loss_tol,
                grad_tol=grad_tol)


# -- phase 18: the CNN training core -----------------------------------
LENET_EPOCHS = 12      # BASELINE config 1 (tests/test_real_digits.py)
LENET_MIN_ACC = 0.98
LENET_COPY_STEPS = 3   # card against a CPU copy
REAL_DIGITS = "real-digits-8x8"   # the vendored fixture phase 18 trains on
SIMPLE_CNN_BATCH = 64
SIMPLE_CNN_STEPS = 5   # timed steps, after one warmup step
CNN_LOSS_RTOL = 1e-5   # card vs CPU loss of a step from the same params:
#                        f32 on both (TF32 off in device.py), convolutions
#                        and GEMMs summed in another order
CNN_PARAM_ATOL = 1e-4  # params after each step (Adam, lr 1e-3), absolute
CNN_TOL = 1e-4         # pre-activations, each gradient leaf, Adam's m and
#                        v, batch norm's running stats and output(): max
#                        error over the leaf's max |value|; f32 on both
#                        sides, sums of up to 25,088 terms in another order
NEAR_TIE = 1e-5        # a ReLU input whose sign differs between the card
#                        and the CPU must be within this share of its
#                        layer's largest |input| of 0: a near-tie, within
#                        the two sides' rounding of 0 (cuDNN leaves tiny
#                        values where the CPU's sum over zeros is 0)


def lenet_conf():
    """BASELINE config 1, as tests/test_real_digits.py builds it."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                    DenseLayer, OutputLayer,
                                                    SubsamplingLayer)
    return (NeuralNetConfiguration.builder().seed(123).updater(Adam(1e-3))
            .weight_init("relu").list()
            .layer(ConvolutionLayer(n_out=20, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=10, loss="mcxent", activation="softmax"))
            .input_type_convolutional(28, 28, 1).build())


class StepClock:
    """A training listener: the host's time to queue each step
    (``on_timing``) and, synchronizing after each, its wall time."""

    def __init__(self, sync: bool):
        import torch
        self.sync = torch.cuda.synchronize if sync else (lambda: None)
        self.enqueue_ms, self.step_ms, self.images = [], [], 0
        self._t = None

    def start(self):
        self.sync()
        self._t = time.perf_counter()

    def iteration_done(self, model, iteration, epoch):
        self.sync()
        now = time.perf_counter()
        self.step_ms.append((now - self._t) * 1e3)
        self._t = now

    def on_timing(self, model, seconds, batch_size):
        self.enqueue_ms.append(seconds * 1e3)
        self.images += batch_size


def _host(t):
    return t.detach().cpu().double()


def traced_step(net, x, y, rng=None, subst=None):
    """One step's loss, gradients (f32) and new layer state through the
    network's own ``_loss_fn``, with each hidden layer's pre-activation
    (the input of its activation) and the dropout masks drawn. With
    ``subst`` (pre-activations of another run), each pre-activation z
    becomes ``z + (subst - z).detach()``: the other run's values, so
    ReLUs and pools choose as it did, and this run's own gradient; the
    recorded z is this run's own, the layer computed here on the other
    run's inputs to it."""
    import torch
    from deeplearning4j_tpu_torch import random as R
    x, y, _ = net._to_device(x, y)
    pre = {}

    def recording(i, act):
        def f(z):
            pre[i] = _host(z)
            if subst is not None:
                z = z + (subst[i].to(z.device, z.dtype) - z).detach()
            return act(z)
        return f
    hidden = net.layers[:-1]
    acts = [layer.activation for layer in hidden]
    for i, layer in enumerate(hidden):
        layer.activation = recording(i, layer.activation)
    real, masks = R.bernoulli, []

    def bernoulli(*a, **kw):
        m = real(*a, **kw)
        masks.append(m.cpu())
        return m
    R.bernoulli = bernoulli
    try:
        keys = [(k, n) for k, p in net._params.items() for n in p]
        with torch.enable_grad():
            loss, state = net._loss_fn(net._params, net._net_state, x, y,
                                       None, True, rng)
            gs = torch.autograd.grad(loss, [net._params[k][n]
                                            for k, n in keys])
    finally:
        R.bernoulli = real
        for layer, act in zip(hidden, acts):
            layer.activation = act
    grads = {k: {} for k in net._params}
    for (k, n), g in zip(keys, gs):
        grads[k][n] = g.detach().cpu()
    return float(loss.detach()), grads, pre, {
        k: {n: t.detach().cpu() for n, t in st.items()}
        for k, st in state.items()}, masks


def _rel(got, ref) -> float:
    """Max error of a leaf over its max |value|."""
    got, ref = _host(got), _host(ref)
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def _worst(got, ref):
    """(worst leaf, its _rel) over two {key: {name: tensor}} trees."""
    errs = {f"{k}.{n}": _rel(got[k][n], t)
            for k, p in ref.items() for n, t in p.items()}
    worst = max(errs, key=errs.get) if errs else None
    return worst, errs.get(worst, 0.0)


def compare_step(card, cpu, x, y, rng=None):
    """One step from the same params on the card and on a CPU copy: the
    dropout masks bit for bit, the loss and every hidden layer's
    pre-activation, then every gradient leaf and the new layer state of
    the CPU copy run on the card's pre-activations (its ReLUs and pools
    then choose as the card's did; each ReLU that chose otherwise on
    the CPU's own values must be a near-tie, and is counted)."""
    xh = x.cpu() if hasattr(x, "cpu") else x
    yh = y.cpu() if hasattr(y, "cpu") else y
    lc, gc, pc, sc, mc = traced_step(card, x, y, rng)
    lh, _, ph, _, mh = traced_step(cpu, xh, yh, rng)
    if len(mc) != len(mh) or not all(a.shape == b.shape and bool((a == b)
                                                                 .all())
                                     for a, b in zip(mc, mh)):
        raise AssertionError("dropout masks differ between card and CPU")
    loss_rel = abs(lc - lh) / abs(lh)
    pre_err, ties, tie_worst = 0.0, 0, 0.0
    for i, z in ph.items():
        pre_err = max(pre_err, _rel(pc[i], z))
        if cpu.layers[i].activation.name == "relu":
            flip = (pc[i] > 0) != (z > 0)
            ties += int(flip.sum())
            if flip.any():
                tie_worst = max(tie_worst, max(
                    float(z[flip].abs().max()),
                    float(pc[i][flip].abs().max())) / float(z.abs().max()))
    _, gh, _, sh, _ = traced_step(cpu, xh, yh, rng, subst=pc)
    worst, grad_err = _worst(gc, gh)
    _, state_err = _worst(sc, sh)
    if not (loss_rel <= CNN_LOSS_RTOL and pre_err <= CNN_TOL
            and grad_err <= CNN_TOL and state_err <= CNN_TOL
            and tie_worst <= NEAR_TIE):
        raise AssertionError(
            f"card vs CPU: loss rel err {loss_rel:.3e}, pre-activations "
            f"{pre_err:.3e}, gradient {worst} {grad_err:.3e}, new layer "
            f"state {state_err:.3e}, {ties} ReLU choices differ (largest "
            f"|z| {tie_worst:.2e} of its layer's max)")
    return dict(loss=lc, loss_rel_err=loss_rel, pre_rel_err=pre_err,
                worst_grad=worst, worst_grad_rel_err=grad_err,
                state_rel_err=state_err, near_ties=ties,
                near_tie_worst=tie_worst, cpu_grads=gh, cpu_state=sh,
                masks=len(mc), mask_elems=sum(m.numel() for m in mc),
                kept=(float(sum(m.sum() for m in mc))
                      / max(sum(m.numel() for m in mc), 1)))


def lenet_vs_cpu(device, batches):
    """Phase 18b: a CPU copy of a fresh LeNet on the card. At each step
    both compute the step on the same batch (compare_step: the copy on
    the card's pre-activations), the card fits it and the copy applies
    its own gradients; the params and Adam state must then agree."""
    from deeplearning4j_tpu_torch import random as R
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    card = MultiLayerNetwork(lenet_conf(), device=device).init()
    cpu = card.clone(device="cpu")
    steps = []
    for x, y in batches:
        one = compare_step(card, cpu, x, y)
        card.fit(x, y)
        cpu.apply_gradients(one.pop("cpu_grads"), one.pop("cpu_state"))
        cpu._rng = R.key_at(R.split(cpu._rng), 0)
        pw, perr = _worst(card.params(), cpu.params())
        perr_abs = max(float((_host(t) - _host(cpu.params()[k][n])).abs()
                             .max()) for k, p in card.params().items()
                       for n, t in p.items())
        aw, aerr = _worst({f"{k}.{part}": st[part] for k, st in
                           card.get_updater_state().items() for part in st},
                          {f"{k}.{part}": st[part] for k, st in
                           cpu.get_updater_state().items() for part in st})
        if not (perr_abs <= CNN_PARAM_ATOL and aerr <= CNN_TOL):
            raise AssertionError(f"LeNet after step {card._step}: params "
                                 f"{perr_abs:.3e} ({pw}), Adam {aw} "
                                 f"{aerr:.3e}")
        one.update(param_abs_err=perr_abs, adam_worst=aw, adam_rel_err=aerr)
        steps.append(one)
    return steps


def simple_cnn_batch(n, seed, shape=(48, 48, 3), classes=10):
    """Images of a learnable task from ``seed``: the label is the argmax
    of a fixed projection of each channel's quadrant means."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, *shape).astype(np.float32)
    h, w = shape[0] // 2, shape[1] // 2
    quads = np.concatenate([x[:, i * h:(i + 1) * h, j * w:(j + 1) * w]
                            .mean((1, 2)) for i in (0, 1) for j in (0, 1)],
                           axis=1)
    proj = np.random.RandomState(1234).randn(quads.shape[1], classes)
    cls = ((quads - quads.mean(0)) @ proj).argmax(1)
    return x, np.eye(classes, dtype=np.float32)[cls]


def dropout_launches(device, shape):
    """Kernels and device ms of one Bernoulli draw (threefry in plain
    PyTorch integer ops) at ``shape``, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch import random as R
    key = R.PRNGKey(7)
    R.bernoulli(key, 0.5, shape, device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        R.bernoulli(key, 0.5, shape, device)
        torch.cuda.synchronize()
    n, us = 0, 0.0
    for e in p.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += e.count
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
    return dict(shape=list(shape), kernels=n, device_ms=us / 1e3)


def cnn_training(card: str, device=None, epochs=LENET_EPOCHS,
                 simple_input=(48, 48, 3), batch=SIMPLE_CNN_BATCH,
                 steps=SIMPLE_CNN_STEPS):
    """Phase 18: (a) BASELINE config 1 on the card through fit and
    evaluate, (b) LeNet on the card against a CPU copy, (c) the zoo's
    SimpleCNN (batch norm, dropout) timed, its loss falling, its running
    stats moving, and one step and output() against a CPU copy. No TPU
    kernel is on this path: the launch counters must stay 0."""
    import torch
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch import random as R
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import SimpleCNN
    t_phase = time.perf_counter()
    reset_launches()
    tr = MnistDataSetIterator(batch=128, train=True, flatten=False,
                              shuffle=True)
    if tr.source != REAL_DIGITS:
        raise AssertionError(f"phase 18 needs the vendored real digits, "
                             f"not {tr.source!r}")
    copy = lenet_vs_cpu(device, [b for _, b in zip(range(LENET_COPY_STEPS),
                                                    tr)])
    # (a) BASELINE config 1 through the entry points
    net = MultiLayerNetwork(lenet_conf(), device=device).init()
    dev = net.device
    on_card = dev.type == "cuda"
    clock = StepClock(sync=on_card)
    net.set_listeners(clock)
    clock.start()
    t0 = time.perf_counter()
    net.fit(tr, epochs=epochs)
    fit_s = time.perf_counter() - t0
    te = MnistDataSetIterator(batch=512, train=False, flatten=False)
    if te.source != REAL_DIGITS:
        raise AssertionError(f"phase 18 needs the vendored real digits, "
                             f"not {te.source!r}")
    t0 = time.perf_counter()
    ev = net.evaluate(te)
    eval_s = time.perf_counter() - t0
    acc = ev.accuracy()
    if not (net._step == epochs * (tr.total_examples() // 128)
            and acc >= LENET_MIN_ACC):
        raise AssertionError(f"LeNet: {net._step} steps, test accuracy "
                             f"{acc:.4f} (must be >= {LENET_MIN_ACC})")
    lenet = dict(source=tr.source, steps=net._step, accuracy=acc,
                 test_images=int(ev._conf.sum()), fit_s=fit_s,
                 eval_s=eval_s,
                 step_p50_ms=float(np.median(clock.step_ms)),
                 enqueue_p50_ms=float(np.median(clock.enqueue_ms)),
                 images_per_s=clock.images / fit_s,
                 params=net.num_params(), vs_cpu=copy)
    print(f"cnn (phase 18a) [{card}]: BASELINE config 1 (LeNet, "
          f"{lenet['params']} params) fitted {lenet['steps']} steps "
          f"({epochs} epochs x 128) on the {tr.source} scans: test accuracy "
          f"{acc:.4f} on {lenet['test_images']} images (>= "
          f"{LENET_MIN_ACC}), step p50 {lenet['step_p50_ms']:.3f} ms, "
          f"queued by the host in p50 {lenet['enqueue_p50_ms']:.3f} ms, "
          f"{lenet['images_per_s']:.1f} images/s, fit {fit_s:.2f} s, "
          f"evaluate {eval_s:.3f} s")
    print(f"cnn (phase 18b) [{card}]: LeNet card vs CPU copy over "
          f"{len(copy)} steps: loss rel err "
          f"{max(s['loss_rel_err'] for s in copy):.3e} (tol "
          f"{CNN_LOSS_RTOL:g}), pre-activations "
          f"{max(s['pre_rel_err'] for s in copy):.3e}, worst gradient "
          f"{max(s['worst_grad_rel_err'] for s in copy):.3e} of its max "
          f"(tol {CNN_TOL:g}), params after each step "
          f"{max(s['param_abs_err'] for s in copy):.3e} (tol "
          f"{CNN_PARAM_ATOL:g}), Adam state "
          f"{max(s['adam_rel_err'] for s in copy):.3e} of its max; ReLU "
          f"near-ties by step {[s['near_ties'] for s in copy]} (largest "
          f"|z| {max(s['near_tie_worst'] for s in copy):.1e} of its "
          f"layer's max, tol {NEAR_TIE:g}); losses "
          f"{[round(s['loss'], 6) for s in copy]}")
    # (c) SimpleCNN at the zoo's width
    scnn = SimpleCNN(device=device, input_shape=simple_input, seed=0).init()
    xs, ys = simple_cnn_batch(batch, 18, simple_input)
    x, y = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
    state0 = {k: {n: t.clone() for n, t in st.items()}
              for k, st in scnn.get_net_state().items()}
    clock = StepClock(sync=on_card)
    scnn.set_listeners(clock)
    losses = []
    clock.start()
    for _ in range(1 + steps):
        scnn.fit(x, y)
        losses.append(scnn.score_)
    scnn.set_listeners()
    moved = sum(int(not torch.equal(t, state0[k][n]))
                for k, st in scnn.get_net_state().items()
                for n, t in st.items())
    n_stats = sum(len(st) for st in state0.values())
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and moved == n_stats):
        raise AssertionError(f"SimpleCNN: losses {losses}, {moved} of "
                             f"{n_stats} running stats moved")
    cpu = scnn.clone(device="cpu")
    one = compare_step(scnn, cpu, x, y, rng=R.PRNGKey(2024))
    del one["cpu_grads"], one["cpu_state"]
    if not one["masks"]:
        raise AssertionError("SimpleCNN's step drew no dropout mask")
    out_err = _rel(scnn.output(x), cpu.output(x.cpu()))
    if out_err > CNN_TOL:
        raise AssertionError(f"SimpleCNN output() card vs CPU {out_err:.3e}")
    prof = profile_train_step(scnn, x, y) if on_card else None
    rng_cost = dropout_launches(dev, (batch,) + tuple(
        scnn.layers[-3].input_shape)) if on_card else None
    timed = clock.step_ms[1:]
    simple = dict(input=list(simple_input), batch=batch, steps=steps,
                  params=scnn.num_params(), losses=losses,
                  step_ms=clock.step_ms,
                  step_p50_ms=float(np.median(timed)),
                  enqueue_p50_ms=float(np.median(clock.enqueue_ms[1:])),
                  images_per_s=batch / (float(np.median(timed)) / 1e3),
                  stats_moved=moved, vs_cpu=one, output_abs_err=out_err,
                  profile=prof, dropout_rng=rng_cost)
    launches = kernels.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"phase 18 launched a TPU kernel: {launches}")
    wall = time.perf_counter() - t_phase
    print(f"cnn (phase 18c) [{card}]: SimpleCNN {tuple(simple_input)} "
          f"({simple['params']} params) at batch {batch}: step p50 "
          f"{simple['step_p50_ms']:.3f} ms, queued in p50 "
          f"{simple['enqueue_p50_ms']:.3f} ms, {simple['images_per_s']:.1f}"
          f" images/s, loss {[round(v, 4) for v in losses]}, "
          f"{moved}/{n_stats} running stats moved; one step vs CPU: "
          f"{one['masks']} dropout mask(s) of {one['mask_elems']} equal bit "
          f"for bit (kept {one['kept']:.4f}), loss rel err "
          f"{one['loss_rel_err']:.3e}, pre-activations "
          f"{one['pre_rel_err']:.3e}, worst gradient {one['worst_grad']} "
          f"{one['worst_grad_rel_err']:.3e} of its max, new running stats "
          f"{one['state_rel_err']:.3e}, {one['near_ties']} ReLU near-ties; "
          f"output() {out_err:.3e}")
    if prof is not None:
        print(f"cnn (phase 18c) profile [{card}] (one SimpleCNN step): "
              f"device busy {prof['busy_share']:.3f} of "
              f"{prof['wall_ms']:.1f} ms, {prof['device_kernels']} device "
              f"kernels; top (ms): "
              + ", ".join(f"{n[:50]} {t:.3f}" for n, t in prof["top"][:6]))
        print(f"cnn (phase 18c) dropout draw {rng_cost['shape']}: "
              f"{rng_cost['kernels']} kernels, {rng_cost['device_ms']:.3f} "
              f"ms of device time")
    print(f"cnn (phase 18): launches no TPU kernel (every counter 0: "
          f"{launches}); the phase took {wall:.2f} s")
    return dict(lenet=lenet, simple_cnn=simple, wall_s=wall,
                launches=launches)


# -- phase 19: checkpoints, remat and the recurrent stack ---------------
REMAT_LOSS_RTOL = 1e-5  # remat vs the same net without it (tests/test_remat.py)
REMAT_PARAM_TOL = 1e-5  # of a leaf's max; bit for bit is the prediction
RESUME_LAYERS = 2       # 19b's depth at phase 9's width: at 8 layers
#                         writing took 35 s an archive (PERF.md, §6)
RNN_BATCH = 32
RNN_STEPS = 5           # timed steps of 19c(i), after one warmup step
RNN_TBPTT = 50          # 19c(ii): chunks of 50 over 1,000 characters
RNN_TBPTT_CHARS = 1000
RNN_TBPTT_LR = 1e-4     # 19c(ii)'s Adam: JAX's TBPTT keeps the batch's step
#                         for all 20 chunks, so Adam's bias correction
#                         stays at step 0's and each chunk moves a param
#                         by ~2 lr; at the zoo's 1e-3 the loss rises and
#                         a 1e-7 perturbation grows to 4e-4 of the
#                         params in one fit (on the CPU too, PERF.md)
RNN_STREAM_STEPS = 200  # 19c(iii)
RNN_LOSS_RTOL = 1e-5    # card vs CPU copy, losses of each step
RNN_TOL = 1e-4          # card vs CPU copy, params and Adam state, of a
#                         leaf's max (f32 GEMMs summed in another order
#                         over 40-50 recurrent steps, a few Adam steps)
RNN_STREAM_TOL = 1e-5   # rnn_time_step vs output() on the card


def _leaves(tree, prefix=""):
    """(path, tensor) of a nested dict of tensors."""
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _leaves(v, key)
        else:
            yield key, v


def tree_diff(got, ref):
    """(worst leaf, its error over its max |value|, leaves that differ
    in any bit) of two trees of the same layout."""
    import torch
    ref_leaves = dict(_leaves(ref))
    worst, worst_err, differ = None, 0.0, 0
    for key, t in _leaves(got):
        r = ref_leaves[key].to(t.device)
        if not torch.equal(t, r):
            differ += 1
        err = _rel(t, r)
        if worst is None or err > worst_err:
            worst, worst_err = key, err
    return worst, worst_err, differ


def _train_run(net, x, y, steps, sync):
    """1 + ``steps`` fits of one batch: losses, step ms (synchronized)
    and the host's enqueue ms."""
    import torch
    losses, step_ms, enqueue_ms = [], [], []
    for _ in range(1 + steps):
        t0 = time.perf_counter()
        net.fit(x, y)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        if sync:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score_)
    return losses, step_ms, enqueue_ms


def remat_train(card: str, cfg=TRAIN_CFG, device=None, steps=TRAIN_STEPS):
    """Phase 19a: phase 9's configuration with ``remat(True)`` against
    the same configuration without it, built here from the same seed
    and run on the same batch for 1 + ``steps`` steps. Losses, final
    params and Adam state must agree (bit for bit is the prediction),
    the forward kernel must launch twice a layer a step and the backward
    kernels once, and the peak device memory of the remat run (from a
    reset) must be below the other's."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    base = MultiLayerNetwork(train_conf(cfg), device=device).init()
    rem = MultiLayerNetwork(train_conf(dict(cfg, remat=True)),
                            device=device).init()
    rem.set_params(base.params())
    dev = base.device
    on_card = dev.type == "cuda"
    x, y = recurrence_batch(cfg, cfg["batch"], cfg["seed"], dev)
    runs = {}
    for tag, net in (("base", base), ("remat", rem)):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, step_ms, enqueue_ms = _train_run(net, x, y, steps, on_card)
        runs[tag] = dict(
            losses=losses, step_ms=step_ms,
            step_p50_ms=float(np.median(step_ms[1:])),
            enqueue_p50_ms=float(np.median(enqueue_ms[1:])),
            peak_bytes=torch.cuda.max_memory_allocated() if on_card
            else None,
            launches={"flash_attention": fa.launches,
                      "flash_attention_bwd_dq": fa.launches_dq,
                      "flash_attention_bwd_dkv": fa.launches_dkv,
                      "bf16": fa.launches_bf16 + fa.launches_dq_bf16
                      + fa.launches_dkv_bf16})
    b, r = runs["base"], runs["remat"]
    loss_rel = max(abs(lr - lb) / abs(lb)
                   for lr, lb in zip(r["losses"], b["losses"]))
    pw, perr, pdiff = tree_diff(rem.params(), base.params())
    aw, aerr, adiff = tree_diff(rem.get_updater_state(),
                                base.get_updater_state())
    want = {"flash_attention": 2 * cfg["n_layers"] * (1 + steps),
            "flash_attention_bwd_dq": cfg["n_layers"] * (1 + steps),
            "flash_attention_bwd_dkv": cfg["n_layers"] * (1 + steps),
            "bf16": 0}
    bad = []
    if loss_rel > REMAT_LOSS_RTOL:
        bad.append(f"losses {r['losses']} vs {b['losses']}")
    if perr > REMAT_PARAM_TOL or aerr > REMAT_PARAM_TOL:
        bad.append(f"params {pw} {perr:.3e}, Adam {aw} {aerr:.3e}")
    if on_card and r["launches"] != want:
        bad.append(f"launches {r['launches']} (want {want})")
    if on_card and not r["peak_bytes"] < b["peak_bytes"]:
        bad.append(f"peak {r['peak_bytes']} not below {b['peak_bytes']}")
    if bad:
        raise AssertionError(f"phase 19a failed: {bad}")
    res = dict(base=b, remat=r, loss_rel_err=loss_rel,
               bitwise_losses=r["losses"] == b["losses"],
               param_worst=pw, param_err=perr, params_differing=pdiff,
               adam_worst=aw, adam_err=aerr, adam_differing=adiff,
               leaves=len(list(_leaves(base.params()))))
    gib = (lambda v: "not measured" if v is None else f"{v / 2**30:.3f} GiB")
    print(f"remat (phase 19a) [{card}]: {cfg['n_layers']} blocks, "
          f"{1 + steps} steps: step p50 {r['step_p50_ms']:.2f} ms (enqueue "
          f"{r['enqueue_p50_ms']:.2f}) against {b['step_p50_ms']:.2f} "
          f"({b['enqueue_p50_ms']:.2f}) without remat; peak "
          f"{gib(r['peak_bytes'])} against {gib(b['peak_bytes'])}; losses "
          f"{'bit for bit' if res['bitwise_losses'] else f'within {loss_rel:.3e}'}"
          f", params {pdiff} of {res['leaves']} leaves differ (worst "
          f"{pw} {perr:.3e}), Adam state {adiff} differ ({aerr:.3e}); "
          f"launches {r['launches']} (want {want})")
    return res


def resume_train(card: str, cfg=TRAIN_CFG, device=None, steps=6, every=3,
                 n_layers=RESUME_LAYERS):
    """Phase 19b: phase 9's net (at ``n_layers``) under
    ``CheckpointListener(save_every_n_iterations=every, keep_last=1)``,
    called after step ``every`` only (one archive: a second write would
    only show keep_last's pruning, which tests/test_torch_serializer.py
    holds on the CPU); the archive is restored
    on the card as a fresh network, which runs the remaining steps on
    the same batch. Its losses, params and Adam state must be the
    uninterrupted run's bit for bit; the archive restores on the CPU,
    where output() on one sequence matches the card's restore."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import CheckpointListener
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
    cfg = dict(cfg, n_layers=n_layers)
    d = tempfile.mkdtemp(prefix="dl4j_ckpt_")
    try:
        net = MultiLayerNetwork(train_conf(cfg), device=device).init()
        dev = net.device
        on_card = dev.type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        x, y = recurrence_batch(cfg, cfg["batch"], cfg["seed"], dev)
        lst = CheckpointListener(d, save_every_n_iterations=every,
                                 keep_last=1)
        write_s = []

        class Timed:
            def iteration_done(self, model, iteration, epoch):
                if iteration == every:
                    sync()
                    t0 = time.perf_counter()
                    lst.iteration_done(model, iteration, epoch)
                    write_s.append(time.perf_counter() - t0)
        net.set_listeners(Timed())
        losses = []
        for _ in range(every):
            net.fit(x, y)
            losses.append(net.score_)
        path = lst.last_checkpoint()
        nbytes = os.path.getsize(path)
        sync()
        t0 = time.perf_counter()
        resumed = ModelSerializer.restore(path, device=device)
        sync()
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = ModelSerializer.restore(path, device="cpu")
        cpu_restore_s = time.perf_counter() - t0
        one = x[:1]
        out_err = _rel(cpu.output(one.cpu()), resumed.output(one))
        resumed_losses = []
        for _ in range(steps - every):
            net.fit(x, y)
            losses.append(net.score_)
            resumed.fit(x, y)
            resumed_losses.append(resumed.score_)
        files = sorted(os.listdir(d))
        want_files = [f"checkpoint_iter_{every}.zip"]
        pw, perr, pdiff = tree_diff(resumed.params(), net.params())
        aw, aerr, adiff = tree_diff(resumed.get_updater_state(),
                                    net.get_updater_state())
        bad = []
        if resumed_losses != losses[every:]:
            bad.append(f"losses {resumed_losses} vs {losses[every:]}")
        if pdiff or adiff:
            bad.append(f"{pdiff} param and {adiff} Adam leaves differ "
                       f"(worst {pw} {perr:.3e}, {aw} {aerr:.3e})")
        if (resumed._step, resumed._rng) != (net._step, net._rng):
            bad.append(f"step/key {resumed._step} {resumed._rng} vs "
                       f"{net._step} {net._rng}")
        if files != want_files:
            bad.append(f"files {files} (want {want_files})")
        if not out_err <= TRAIN_GRAD_TOL:
            bad.append(f"CPU output {out_err:.3e}")
        if bad:
            raise AssertionError(f"phase 19b failed: {bad}")
        res = dict(n_layers=n_layers, params=net.num_params(),
                   losses=losses, resumed_losses=resumed_losses,
                   write_s=write_s, restore_s=restore_s,
                   cpu_restore_s=cpu_restore_s, archive_bytes=nbytes,
                   files=files, cpu_output_err=out_err)
        print(f"checkpoint resume (phase 19b) [{card}]: {n_layers} blocks "
              f"({res['params']} params"
              + ("" if n_layers == TRAIN_CFG["n_layers"] else
                 f", cut from {TRAIN_CFG['n_layers']}: see PERF.md")
              + f"), archive {nbytes} bytes, write "
              f"{[round(v, 3) for v in write_s]} s, restore on the card "
              f"{restore_s:.3f} s, on the CPU {cpu_restore_s:.3f} s; steps "
              f"{every + 1}-{steps} after the restore bit for bit the "
              f"uninterrupted run's (losses {resumed_losses}, every param "
              f"and Adam leaf, step and key); CPU output() "
              f"{out_err:.3e} of its max (tol {TRAIN_GRAD_TOL:g}); files "
              f"left {files}")
        return res
    finally:
        shutil.rmtree(d, ignore_errors=True)


def char_batch(classes, batch, T, seed, device):
    """One-hot characters of c[i+1] = (a c[i] + b) mod classes from
    seeded starts, [batch, T, classes], and the next character's one-hot
    labels: the next character is a function of the current one, so the
    loss can fall."""
    import torch
    rs = np.random.RandomState(seed)
    seq = np.empty((batch, T + 1), np.int64)
    seq[:, 0] = rs.randint(0, classes, batch)
    for i in range(T):
        seq[:, i + 1] = (31 * seq[:, i] + 7) % classes
    eye = torch.eye(classes, device=device)
    seq = torch.from_numpy(seq).to(device)
    return eye[seq[:, :T]], eye[seq[:, 1:]]


def rnn_training(card: str, device=None, batch=RNN_BATCH, steps=RNN_STEPS,
                 tbptt_chars=RNN_TBPTT_CHARS, stream_steps=RNN_STREAM_STEPS):
    """Phase 19c: the zoo's TextGenerationLSTM (77 classes, 2 x
    LSTM(256), 40 timesteps) at batch 32: (i) fit against a CPU copy;
    (ii) its layers with tbptt(50) over 1,000 characters, two fits, the
    first against a CPU copy; (iii) rnn_time_step over single steps
    against output() over the whole sequence. No TPU kernel is on this
    path: every launch counter must stay 0."""
    import json as _json

    import torch
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import (MultiLayerConfiguration,
                                             MultiLayerNetwork)
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    t_phase = time.perf_counter()
    reset_launches()
    zoo = TextGenerationLSTM(device=device, seed=0)
    net = zoo.init()
    dev = net.device
    on_card = dev.type == "cuda"
    C, T = zoo.num_classes, zoo.timesteps
    x, y = char_batch(C, batch, T, 19, dev)
    # (i) fit at the zoo's 40 timesteps, against a CPU copy
    cpu = net.clone(device="cpu")
    losses, step_ms, enqueue_ms = _train_run(net, x, y, steps, on_card)
    cpu_losses = []
    for _ in range(1 + steps):
        cpu.fit(x.cpu(), y.cpu())
        cpu_losses.append(cpu.score_)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    pw, perr, _ = tree_diff(net.params(), cpu.params())
    aw, aerr, _ = tree_diff(net.get_updater_state(),
                            cpu.get_updater_state())
    bad = []
    if loss_rel > RNN_LOSS_RTOL or perr > RNN_TOL or aerr > RNN_TOL:
        bad.append(f"(i) card vs CPU: losses {loss_rel:.3e}, params {pw} "
                   f"{perr:.3e}, Adam {aw} {aerr:.3e}")
    fit = dict(params=net.num_params(), losses=losses,
               cpu_losses=cpu_losses, loss_rel_err=loss_rel,
               param_worst=pw, param_err=perr, adam_worst=aw, adam_err=aerr,
               step_ms=step_ms, step_p50_ms=float(np.median(step_ms[1:])),
               enqueue_p50_ms=float(np.median(enqueue_ms[1:])))
    # (ii) the same layers with tbptt(50) over 1,000 characters
    t_i = time.perf_counter() - t_phase
    zoo_tb = TextGenerationLSTM(device=device, seed=0,
                                updater=Adam(RNN_TBPTT_LR))
    d = _json.loads(zoo_tb.init().conf.to_json())
    d["tbptt_fwd_length"] = d["tbptt_bwd_length"] = RNN_TBPTT
    conf = MultiLayerConfiguration.from_json(_json.dumps(d))
    tnet = MultiLayerNetwork(conf, device=device).init()
    tcpu = tnet.clone(device="cpu")
    xl, yl = char_batch(C, batch, tbptt_chars, 20, dev)
    before = tnet.score(xl, yl)
    chunks = -(-tbptt_chars // RNN_TBPTT)
    t_losses, t_ms, t_enqueue = [], [], []
    for i in range(2):
        t0 = time.perf_counter()
        tnet.fit(xl, yl)
        t_enqueue.append((time.perf_counter() - t0) * 1e3)
        if on_card:
            torch.cuda.synchronize()
        t_ms.append((time.perf_counter() - t0) * 1e3)
        t_losses.append(tnet.score_)
        if i == 0:   # the first fit against the CPU copy's
            tcpu.fit(xl.cpu(), yl.cpu())
            t_loss_rel = abs(t_losses[0] - tcpu.score_) / abs(tcpu.score_)
            tpw, tperr, _ = tree_diff(tnet.params(), tcpu.params())
            taw, taerr, _ = tree_diff(tnet.get_updater_state(),
                                      tcpu.get_updater_state())
    after = tnet.score(xl, yl)
    if not (after < before and t_loss_rel <= RNN_LOSS_RTOL
            and tperr <= RNN_TOL and taerr <= RNN_TOL):
        bad.append(f"(ii) TBPTT: score {before} -> {after}; first fit vs "
                   f"CPU: loss {t_loss_rel:.3e}, params {tpw} {tperr:.3e}, "
                   f"Adam {taw} {taerr:.3e}")
    # one profiled fit of two chunks (the same work a chunk as the
    # 1,000-character fits')
    prof = profile_train_step(tnet, xl[:, :2 * RNN_TBPTT],
                              yl[:, :2 * RNN_TBPTT]) if on_card else None
    t_ii = time.perf_counter() - t_phase - t_i
    tb = dict(chars=tbptt_chars, chunks=chunks, losses=t_losses,
              cpu_loss=tcpu.score_, loss_rel_err=t_loss_rel,
              score_before=before, score_after=after, param_worst=tpw,
              param_err=tperr, adam_worst=taw, adam_err=taerr,
              fit_ms=t_ms, enqueue_ms=t_enqueue,
              chunk_ms=[v / chunks for v in t_ms],
              profile=prof)
    # (iii) rnn_time_step over single steps from a cleared state
    xs, _ = char_batch(C, batch, stream_steps, 21, dev)
    full = net.output(xs)
    net.rnn_clear_previous_state()
    outs, stream_ms = [], []
    for t in range(stream_steps):
        t0 = time.perf_counter()
        outs.append(net.rnn_time_step(xs[:, t]))
        stream_ms.append((time.perf_counter() - t0) * 1e3)
    if on_card:
        torch.cuda.synchronize()
    stream_err = float((torch.stack(outs, 1) - full).abs().max())
    net.rnn_clear_previous_state()
    again = torch.equal(net.rnn_time_step(xs[:, 0]), outs[0])
    if stream_err > RNN_STREAM_TOL or not again:
        bad.append(f"(iii) rnn_time_step vs output {stream_err:.3e}, "
                   f"first step after a clear equal: {again}")
    launches = kernels.launch_counts()
    if any(launches.values()):
        bad.append(f"launched a TPU kernel: {launches}")
    wall = time.perf_counter() - t_phase
    res = dict(fit=fit, tbptt=tb, stream=dict(
        steps=stream_steps, max_abs_err=stream_err,
        step_p50_ms=float(np.median(stream_ms))), launches=launches,
        wall_s=wall)
    print(f"recurrent (phase 19c i) [{card}]: TextGenerationLSTM "
          f"({fit['params']} params) at batch {batch} x {T}: step p50 "
          f"{fit['step_p50_ms']:.3f} ms, queued in p50 "
          f"{fit['enqueue_p50_ms']:.3f} ms, loss "
          f"{[round(v, 4) for v in losses]}; card vs CPU copy: losses "
          f"{loss_rel:.3e} (tol {RNN_LOSS_RTOL:g}), params {pw} "
          f"{perr:.3e}, Adam {aw} {aerr:.3e} of the leaf's max (tol "
          f"{RNN_TOL:g})")
    print(f"recurrent (phase 19c ii) [{card}]: TBPTT({RNN_TBPTT}) over "
          f"{tbptt_chars} characters, Adam({RNN_TBPTT_LR:g}), "
          f"{chunks} chunk steps a fit: fits "
          f"{[round(v, 1) for v in t_ms]} ms ({[round(v, 3) for v in tb['chunk_ms']]}"
          f" ms a chunk; queued in {[round(v, 1) for v in t_enqueue]} ms), "
          f"score {before:.4f} -> {after:.4f}; first fit vs CPU: loss "
          f"{t_loss_rel:.3e}, params {tpw} {tperr:.3e}, Adam {taw} "
          f"{taerr:.3e}")
    if prof is not None:
        print(f"recurrent (phase 19c ii) profile [{card}] (one TBPTT fit "
              f"of 2 chunks): device busy {prof['busy_share']:.3f} of "
              f"{prof['wall_ms']:.1f} ms, {prof['device_kernels']} device "
              f"kernels ({prof['device_kernels'] / 2:.0f} a chunk); "
              f"top (ms): "
              + ", ".join(f"{n[:50]} {t:.3f}" for n, t in prof["top"][:5]))
    print(f"recurrent (phase 19c iii) [{card}]: rnn_time_step over "
          f"{stream_steps} single steps: max err {stream_err:.3e} against "
          f"output() (tol {RNN_STREAM_TOL:g}), p50 "
          f"{res['stream']['step_p50_ms']:.3f} ms a step; the first step "
          f"after rnn_clear_previous_state equal: {again}; TPU kernel "
          f"launches {launches}; the phase took {wall:.2f} s ((i) "
          f"{t_i:.1f}, (ii) {t_ii:.1f} s)")
    if bad:
        raise AssertionError(f"phase 19c failed: {bad}")
    return res


# -- phase 20: transfer learning, pure-bf16 params, resilient training ---
TL_FROZEN = 6           # 20a: set_feature_extractor(6), the embedding and
#                         blocks 1-6 frozen, blocks 7-8 and a new head train
TL_BASE_STEPS = 2       # 20a: steps of phase 9's net before the transfer
TL_STEPS = 3            # 20a: timed fine-tune steps, after one warmup step
TL_LOSS_RTOL = 1e-5     # 20a card vs CPU copy, the loss of each step (f32,
#                         CNN_LOSS_RTOL's reason)
TL_PARAM_TOL = 1.5e-3   # 20a card vs CPU copy, each trainable param leaf's
#                         max error over its max |value| after 4 Adam steps;
#                         measured 5.285e-4 on the H100 (PERF.md, PR 21)
TL_GRAD_TOL = TRAIN_GRAD_TOL  # the first fine-tune batch's gradients, card
#                         vs CPU on the same params: phase 9's tolerance
#                         (measured 4.802e-4, layer_7/attn_Wk, whose
#                         gradient cancels over the keys)
TL_M_TOL = 3e-3         # each Adam m leaf after 4 steps: the sum of the
#                         steps' gradients, so their gap (measured 1.012e-3
#                         in layer_7/attn_Wk, 2.1x its first-step gradient
#                         gap as the params part)
TL_V_TOL = 2 * TL_M_TOL  # each Adam v leaf: v grows as g^2, so its gap is
#                         twice m's (measured 2.008e-3, 1.98x m's)
TL_WITNESS_REL = 1e-4   # 20a's witness: a second card copy whose first-step
#                         gradients are scaled by 1 + 1e-4 * N(0, 1), the
#                         size the 3xTF32 flash kernels leave (~1e-5 to
#                         1e-4); its gaps from the card run (measured 1.1e-4
#                         params, 8.6e-5 m, 1.3e-4 v) show that noise in the
#                         first step alone does not make the Adam gaps above
BF16_STEPS = 3          # 20b
BF16_CPU_LAYERS = RESUME_LAYERS  # 20b's CPU comparison: bf16 GEMMs on the
#                         host are slow, so a 2-block copy at B=1
BF16_LOSS_RTOL = TRAIN_BF16_LOSS_RTOL  # 20b card vs CPU at bf16 (phase 10's)
BF16_STEP_ATOL = 2.5e-3  # 20b card vs CPU params after steps 2 and 3, per
#                         step: the entries that parted at step 1 (below)
#                         move the gradients after them
BF16_M_TOL1 = 4e-2      # 20b card vs CPU, each Adam m leaf's max error over
#                         its max |value| after step 1, where m is 0.1 g: the
#                         tolerance of bf16 gradients, as tests/
#                         test_torch_bf16_params.py holds the port to JAX
#                         (measured 2.13e-2 on the H100)
BF16_V_TOL1 = 2 * BF16_M_TOL1  # v after step 1, 1e-3 g^2: twice m's gap
#                         (measured 4.10e-2)
BF16_M_TOL = 1e-1       # m after steps 2 and 3: taken at params that parted
#                         at step 1 (below), in f32 (measured 4.99e-2,
#                         4.29e-2)
BF16_V_TOL = 1.5e-1     # v after steps 2 and 3 (measured 3.31e-2, 7.17e-2)
BF16_FIRST_ATOL = 3e-2 * 1e-3  # 20b params after step 1: 3e-2 lr. Adam's
#                         first step is lr * m / (sqrt(v) + eps) from bf16
#                         m and v, ~lr * sign(g) whatever g's size;
#                         gradients a few bf16 ulps apart move it by up to
#                         ~2.4e-2 lr; eps's own share of each side's step
#                         is taken out first (``_first_step_outliers``)
BF16_FIRST_EXCUSED = 2e-2  # entries beyond BF16_FIRST_ATOL allowed, as a
#                         share of the params, each one whose gradients
#                         differ in sign (2 lr apart) or so small that eps
#                         weighs (measured 417,244 of 39,101,696, 1.07e-2,
#                         most in the output layer's W; none unexcused)
ADAM_EPS = 1e-8         # Adam's epsilon (learning.Adam's default)
EPS_WEIGHS = ADAM_EPS / 3e-2  # sqrt(v) below Adam's eps over 3e-2: eps
#                         alone then moves the first step by more than
#                         3e-2 lr
RES_BATCHES = 8         # 20c: clean batches of one epoch
RES_NAN = (2, 3)        # 20c: positions of the NaN batches in the faulted
#                         stream (labels NaN: the loss goes NaN)
RES_ROLLBACK_AFTER = 2  # 20c: K consecutive anomalies roll back
RES_RETRY_CALL = 2      # 20c: the train_step call that fails once
RES_PREEMPT = 6         # 20c: the step boundary (seam call) that preempts:
#                         after step 4 (items b0 b1 nan nan b2 b3)


def _dtype_table(net) -> dict:
    """{"params": sorted dtypes, "adam": sorted dtypes} of a network."""
    return {"params": sorted({str(t.dtype).replace("torch.", "")
                              for _, t in _leaves(net.params())}),
            "adam": sorted({str(t.dtype).replace("torch.", "")
                            for _, t in _leaves(net.get_updater_state())})}


def _flash_counts() -> dict:
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    return {"flash_attention": fa.launches,
            "flash_attention_bwd_dq": fa.launches_dq,
            "flash_attention_bwd_dkv": fa.launches_dkv,
            "flash_attention_bf16": fa.launches_bf16,
            "flash_attention_bwd_dq_bf16": fa.launches_dq_bf16,
            "flash_attention_bwd_dkv_bf16": fa.launches_dkv_bf16}


def _snapshot_tree(tree):
    return {k: (_snapshot_tree(v) if isinstance(v, dict)
                else v.detach().clone()) for k, v in tree.items()}


def _adam_diffs(got, ref) -> dict:
    """{"m": (worst leaf, error), "v": ...} of two networks' Adam states,
    each leaf's max error over its max |value| (``tree_diff``)."""
    out = {}
    for slot in ("m", "v"):
        g = {k: st[slot] for k, st in got.get_updater_state().items()}
        r = {k: st[slot] for k, st in ref.get_updater_state().items()}
        out[slot] = tree_diff(g, r)[:2]
    return out


def _perturb_next_grads(net, rel: float, seed: int):
    """Scale every gradient of ``net``'s next step by 1 + rel * N(0, 1),
    drawn from a seeded generator on the network's device."""
    import torch
    gen = torch.Generator(device=net.device).manual_seed(seed)

    def once(*args):
        del net._step_grads
        loss, grads, state = net._step_grads(*args)
        for g in grads.values():
            for leaf in g.values():
                leaf.mul_(1 + rel * torch.randn(
                    leaf.shape, generator=gen, device=leaf.device,
                    dtype=leaf.dtype))
        return loss, grads, state
    net._step_grads = once


def _first_step_outliers(net, ref, before, atol: float) -> dict:
    """Params beyond ``atol`` between two networks after one Adam step
    from the same params ``before``: ``beyond`` entries, ``unexcused``
    of them, the largest unexcused error and its leaf, and the leaves
    with most entries beyond. An entry is excused when the two sides'
    gradients (the sign of m) differ in sign or either side's sqrt(v)
    is small enough for eps to move the step by more than ``atol`` /
    lr. Elsewhere eps's own share is taken out of each side's step
    before they are compared: Adam's step is lr bc m / (sqrt(v) + eps),
    so where the sides' gradients differ eps shortens their steps by
    different fractions (up to ``atol`` / lr on one side)."""
    import torch
    out = dict(beyond=0, unexcused=0, worst=0.0, worst_leaf=None,
               by_leaf={})
    st, rst = net.get_updater_state(), ref.get_updater_state()
    for key, p in net.params().items():
        for n, t in p.items():
            p0 = before[key][n].to(t.device).float()
            got = t.detach().float() - p0
            want = ref.params()[key][n].to(t.device).float() - p0
            m, rm = st[key]["m"][n], rst[key]["m"][n].to(t.device)
            sv = st[key]["v"][n].float().sqrt()
            rsv = rst[key]["v"][n].to(t.device).float().sqrt()
            weighs = torch.minimum(sv, rsv) < EPS_WEIGHS
            d = torch.where(weighs, (got - want).abs(),
                            (got * (1 + ADAM_EPS / sv)
                             - want * (1 + ADAM_EPS / rsv)).abs())
            far = d > atol
            excused = (torch.sign(m) != torch.sign(rm)) | weighs
            left = far & ~excused
            nb, nu = int(far.sum()), int(left.sum())
            out["beyond"] += nb
            out["unexcused"] += nu
            if nb:
                out["by_leaf"][f"{key}/{n}"] = nb
            if nu and float(d[left].max()) > out["worst"]:
                out["worst"] = float(d[left].max())
                out["worst_leaf"] = f"{key}/{n}"
    out["by_leaf"] = dict(sorted(out["by_leaf"].items(),
                                 key=lambda kv: -kv[1])[:4])
    return out


def transfer_train(card: str, cfg=TRAIN_CFG, device=None, phase9=None,
                   base_steps=TL_BASE_STEPS, steps=TL_STEPS,
                   frozen=TL_FROZEN):
    """Phase 20a: phase 9's net trained ``base_steps`` steps, then
    ``TransferLearning`` with ``set_feature_extractor(frozen)``, its
    output layer replaced by a new RnnOutputLayer, fine-tuned 1 +
    ``steps`` steps on new batches. Every frozen leaf must keep its
    bits; the trainable leaves, Adam's m and v and the losses must
    agree with a CPU copy that starts from the same params and takes the
    same batches, and so must the first batch's gradients; B3 must
    launch once a block a step and B6/B7 once a trainable block a step
    (the frozen prefix runs no backward). A witness copy on the card,
    its first gradients perturbed by TL_WITNESS_REL, shows how far such
    noise carries."""
    import torch
    from deeplearning4j_tpu_torch.nn import (MultiLayerConfiguration,
                                             MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.transferlearning import \
        TransferLearning
    t_phase = time.perf_counter()
    base = MultiLayerNetwork(train_conf(cfg), device=device).init()
    dev = base.device
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for s in range(base_steps):
        base.fit(*recurrence_batch(cfg, cfg["batch"], cfg["seed"] + s, dev))
    sync()
    t0 = time.perf_counter()
    net = (TransferLearning.builder(base).set_feature_extractor(frozen)
           .remove_output_layer()
           .add_layer(RnnOutputLayer(n_out=cfg["vocab_size"], loss="mcxent",
                                     activation="softmax"))
           .build())
    sync()
    build_s = time.perf_counter() - t0
    cpu = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        net.conf.to_json()), device="cpu").init()
    cpu.set_params(net.params())
    witness = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        net.conf.to_json()), device=device).init()
    witness.set_params(net.params())
    frozen_keys = net._layer_keys[:frozen + 1]
    before = {k: _snapshot_tree(net.params()[k]) for k in frozen_keys}
    batches = [recurrence_batch(cfg, cfg["batch"], cfg["seed"] + 100 + s,
                                dev) for s in range(1 + steps)]
    trained_keys = net._layer_keys[frozen + 1:]
    x0, y0 = batches[0]
    g_card = net.loss_and_gradients(x0, y0)[1]
    g_cpu = cpu.loss_and_gradients(x0.cpu(), y0.cpu())[1]
    grad_gap = tree_diff({k: g_card[k] for k in trained_keys},
                         {k: g_cpu[k] for k in trained_keys})[:2]
    del g_card, g_cpu
    reset_launches()
    losses, step_ms, enqueue_ms = [], [], []
    for x, y in batches:
        t0 = time.perf_counter()
        net.fit(x, y)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score_)
    launches = _flash_counts()
    _perturb_next_grads(witness, TL_WITNESS_REL, cfg["seed"])
    for x, y in batches:
        witness.fit(x, y)
    t0 = time.perf_counter()
    cpu_losses = []
    for x, y in batches:
        cpu.fit(x.cpu(), y.cpu())
        cpu_losses.append(cpu.score_)
    cpu_s = time.perf_counter() - t0
    n = 1 + steps
    # layer 0 is the embedding, layers 1..n_layers the blocks
    blocks = cfg["n_layers"]
    trainable_blocks = blocks - frozen
    trainable = len(net.layers) - (frozen + 1)
    want = {"flash_attention": blocks * n,
            "flash_attention_bwd_dq": trainable_blocks * n,
            "flash_attention_bwd_dkv": trainable_blocks * n,
            "flash_attention_bf16": 0, "flash_attention_bwd_dq_bf16": 0,
            "flash_attention_bwd_dkv_bf16": 0}
    frozen_differ = sum(
        not torch.equal(net.params()[k][name], t)
        for k in frozen_keys for name, t in before[k].items())
    pw, perr, _ = tree_diff({k: net.params()[k] for k in trained_keys},
                            {k: cpu.params()[k] for k in trained_keys})
    adam = _adam_diffs(net, cpu)
    wit = dict(params=tree_diff(
        {k: witness.params()[k] for k in trained_keys},
        {k: net.params()[k] for k in trained_keys})[:2],
        **_adam_diffs(witness, net))
    del witness
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    bad = []
    if frozen_differ:
        bad.append(f"{frozen_differ} frozen leaves moved")
    if on_card and launches != want:
        bad.append(f"launches {launches} (want {want})")
    if loss_rel > TL_LOSS_RTOL:
        bad.append(f"losses {losses} vs CPU {cpu_losses}")
    if perr > TL_PARAM_TOL or adam["m"][1] > TL_M_TOL or \
            adam["v"][1] > TL_V_TOL:
        bad.append(f"params {pw} {perr:.3e}, Adam {adam}")
    if grad_gap[1] > TL_GRAD_TOL:
        bad.append(f"first fine-tune gradients {grad_gap}")
    if not losses[-1] < losses[0]:
        bad.append(f"the fine-tune loss did not fall: {losses}")
    if bad:
        raise AssertionError(f"phase 20a failed: {bad}")
    timed = step_ms[1:]
    res = dict(frozen_layers=frozen + 1, trainable_blocks=trainable_blocks,
               trainable_layers=trainable, params=net.num_params(),
               build_s=build_s, losses=losses, cpu_losses=cpu_losses,
               loss_rel_err=loss_rel, step_ms=step_ms,
               step_p50_ms=float(np.median(timed)),
               enqueue_p50_ms=float(np.median(enqueue_ms[1:])),
               launches=launches, want=want, param_worst=pw,
               param_err=perr, adam=adam, grad_gap=grad_gap, witness=wit,
               frozen_leaves=sum(len(before[k]) for k in frozen_keys),
               cpu_s=cpu_s, seconds=time.perf_counter() - t_phase)
    beside = ("" if phase9 is None else
              f" beside phase 9's {phase9['step_p50_ms']:.2f} "
              f"({phase9['enqueue_p50_ms']:.2f})")
    print(f"transfer (phase 20a) [{card}]: phase 9's net after "
          f"{base_steps} steps, set_feature_extractor({frozen}) (the "
          f"embedding and blocks 1-{frozen} frozen, "
          f"{res['frozen_leaves']} leaves bit for bit unchanged), a new "
          f"head; build "
          f"{build_s:.3f} s; {1 + steps} fine-tune steps: step p50 "
          f"{res['step_p50_ms']:.2f} ms (enqueue "
          f"{res['enqueue_p50_ms']:.2f}){beside}; losses "
          f"{[round(v, 4) for v in losses]}; card vs CPU copy: losses "
          f"{loss_rel:.3e} (tol {TL_LOSS_RTOL:g}), of a leaf's max: "
          f"trainable params worst {pw} {perr:.3e} (tol {TL_PARAM_TOL:g}), "
          f"Adam m {adam['m'][0]} {adam['m'][1]:.3e} (tol {TL_M_TOL:g}), "
          f"v {adam['v'][0]} {adam['v'][1]:.3e} (tol {TL_V_TOL:g}); "
          f"the first fine-tune batch's gradients card vs CPU: worst "
          f"{grad_gap[0]} {grad_gap[1]:.3e} (tol {TL_GRAD_TOL:g}); "
          f"witness (first-step gradients x (1 + {TL_WITNESS_REL:g} "
          f"N(0,1)) on the card): params {wit['params'][1]:.3e}, m "
          f"{wit['m'][1]:.3e}, v {wit['v'][1]:.3e} (CPU copy "
          f"{cpu_s:.1f} s); launches {launches} "
          f"(want {want}); phase 20a took {res['seconds']:.1f} s")
    return res


def bf16_train(card: str, cfg=TRAIN_CFG, device=None, steps=BF16_STEPS,
               cpu_layers=BF16_CPU_LAYERS):
    """Phase 20b: phase 9's net with ``init(dtype=torch.bfloat16)`` for
    ``steps`` steps. After each step the dtypes must be JAX's (all bf16
    at init; f32 params beside bf16 Adam moments after step 1; all f32
    after step 2), and each step's flash legs are counted (bf16 while
    the activations are bf16, f32 after). A ``cpu_layers``-block copy at
    B=1 on the card and on the CPU, from the same bf16 params, must
    agree on losses and params within bf16 tolerances."""
    import torch
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    t_phase = time.perf_counter()
    net = MultiLayerNetwork(train_conf(cfg), device=device).init(
        dtype=torch.bfloat16)
    dev = net.device
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    x, y = recurrence_batch(cfg, cfg["batch"], cfg["seed"], dev)
    tables, legs, losses, step_ms = [_dtype_table(net)], [], [], []
    for _ in range(steps):
        reset_launches()
        t0 = time.perf_counter()
        net.fit(x, y)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        legs.append({k: v for k, v in _flash_counts().items() if v})
        losses.append(net.score_)
        tables.append(_dtype_table(net))
    want_tables = ([{"params": ["bfloat16"], "adam": ["bfloat16"]},
                    {"params": ["float32"], "adam": ["bfloat16"]}]
                   + [{"params": ["float32"], "adam": ["float32"]}]
                   * (steps - 1))
    L = cfg["n_layers"]
    bf16_legs = {"flash_attention_bf16": L, "flash_attention_bwd_dq_bf16": L,
                 "flash_attention_bwd_dkv_bf16": L}
    f32_legs = {"flash_attention": L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L}
    want_legs = [bf16_legs] + [f32_legs] * (steps - 1)
    # the CPU comparison at cpu_layers blocks, B=1
    small = dict(cfg, n_layers=cpu_layers)
    card_s = MultiLayerNetwork(train_conf(small), device=device).init(
        dtype=torch.bfloat16)
    cpu = MultiLayerNetwork(train_conf(small), device="cpu").init(
        dtype=torch.bfloat16)
    cpu.set_params(card_s.params())
    before = {k: {n: t.detach().float().cpu() for n, t in p.items()}
              for k, p in cpu.params().items()}
    xs, ys = recurrence_batch(small, 1, cfg["seed"] + 1, dev)
    n_small = card_s.num_params()
    t0 = time.perf_counter()
    worst, cmp_losses, adam = [], [], []
    for s in range(steps):
        card_s.fit(xs, ys)
        cpu.fit(xs.cpu(), ys.cpu())
        cmp_losses.append((card_s.score_, cpu.score_))
        err = max(float((a.detach().float().cpu()
                          - b.detach().float()).abs().max())
                  for (_, a), (_, b) in zip(_leaves(card_s.params()),
                                            _leaves(cpu.params())))
        worst.append(err)
        adam.append(_adam_diffs(card_s, cpu))
        if s == 0:
            first = _first_step_outliers(card_s, cpu, before,
                                         BF16_FIRST_ATOL)
        if _dtype_table(card_s) != _dtype_table(cpu):
            raise AssertionError(f"phase 20b: card {_dtype_table(card_s)} "
                                 f"vs CPU {_dtype_table(cpu)}")
    cpu_s = time.perf_counter() - t0
    loss_rel = max(abs(a - b) / abs(b) for a, b in cmp_losses)
    bad = []
    if tables != want_tables:
        bad.append(f"dtypes {tables} (want {want_tables})")
    if on_card and legs != want_legs:
        bad.append(f"flash legs {legs} (want {want_legs})")
    if not all(np.isfinite(losses)):
        bad.append(f"losses {losses}")
    if loss_rel > BF16_LOSS_RTOL:
        bad.append(f"card vs CPU losses {cmp_losses}")
    for s, e in enumerate(worst[1:], 2):
        if e > BF16_STEP_ATOL * s:
            bad.append(f"card vs CPU params after step {s}: {e:.3e}")
    if first["unexcused"] or \
            first["beyond"] > BF16_FIRST_EXCUSED * n_small:
        bad.append(f"card vs CPU params after step 1: {first}")
    for s, a in enumerate(adam, 1):
        m_tol, v_tol = (BF16_M_TOL1, BF16_V_TOL1) if s == 1 else \
            (BF16_M_TOL, BF16_V_TOL)
        if a["m"][1] > m_tol or a["v"][1] > v_tol:
            bad.append(f"card vs CPU Adam after step {s}: {a}")
    if bad:
        raise AssertionError(f"phase 20b failed: {bad}")
    res = dict(tables=tables, legs=legs, losses=losses, step_ms=step_ms,
               cpu_layers=cpu_layers, cmp_losses=cmp_losses,
               loss_rel_err=loss_rel, param_err_by_step=worst,
               first_step=first, small_params=n_small,
               adam_by_step=adam, cpu_s=cpu_s,
               seconds=time.perf_counter() - t_phase)
    print(f"pure bf16 (phase 20b) [{card}]: phase 9's net at init(bf16), "
          f"{steps} steps: dtypes after init and each step {tables} "
          f"(JAX's rule); flash legs a step {legs}; step ms "
          f"{[round(v, 2) for v in step_ms]}; losses "
          f"{[round(v, 4) for v in losses]}; a {cpu_layers}-block B=1 copy "
          f"card vs CPU: losses {loss_rel:.3e} (tol {BF16_LOSS_RTOL:g}), "
          f"params {[f'{e:.2e}' for e in worst]}, after step 1 "
          f"{first['beyond']} of {n_small} entries beyond "
          f"{BF16_FIRST_ATOL:g} {first['by_leaf']} "
          f"(all sign flips or eps-weighted; at most "
          f"{BF16_FIRST_EXCUSED:g} of them), later steps tol "
          f"{BF16_STEP_ATOL:g} a step; Adam m "
          f"{[round(a['m'][1], 5) for a in adam]}, v "
          f"{[round(a['v'][1], 5) for a in adam]} of a leaf's max (tol "
          f"{BF16_M_TOL1:g} and {BF16_V_TOL1:g} after step 1, "
          f"{BF16_M_TOL:g} and {BF16_V_TOL:g} after); CPU {cpu_s:.1f} s); "
          f"phase 20b took {res['seconds']:.1f} s")
    return res


def resilience_batches(cfg, dev, bad=()):
    """20c's stream: RES_BATCHES recurrence batches, with a NaN-label
    copy of the previous clean batch inserted at each position in
    ``bad`` (the loss of such a batch is NaN)."""
    out = []
    clean = [recurrence_batch(cfg, cfg["batch"], cfg["seed"] + 200 + s, dev)
             for s in range(RES_BATCHES)]
    for b in clean:
        while len(out) in bad:
            x, y = out[-1] if out else b
            out.append((x, y * float("nan")))
        out.append(b)
    return out


class _StepClock:
    """Listener: each iteration's wall time (from the previous
    iteration's end), the supervisor's stall so far, whether the async
    writer was mid-write, and per-step hooks."""

    def __init__(self, trainer, hooks=None):
        self.tr, self.hooks = trainer, hooks or {}
        self.rows, self.t = [], None

    def iteration_done(self, m, step, epoch):
        now = time.perf_counter()
        w = self.tr._writer
        stall = self.tr.supervisor.checkpoint_stall_s
        prev = self.rows[-1]["stall_s"] if self.rows else stall
        # the item's own time: since the last item's end, less the
        # checkpoint stall of that item's step boundary
        self.rows.append(dict(
            item=len(self.rows), step=step,
            ms=None if self.t is None
            else (now - self.t - (stall - prev)) * 1e3,
            stall_s=stall,
            writing=bool(w is not None and w.snapshot()["busy"])))
        hook = self.hooks.get(len(self.rows) - 1)
        if hook is not None:
            hook(m)
        self.t = time.perf_counter()


def _trees_equal(net, flat_params, flat_opt) -> int:
    """How many leaves of ``net`` differ in any bit from a host snapshot
    (``snapshot_training_state``'s flattened params and updater)."""
    from deeplearning4j_tpu_torch.convert import tensor_from_numpy
    from deeplearning4j_tpu_torch.util.serializer import _flatten_tree
    differ = 0
    for tree, flat in ((net.params(), flat_params),
                       (net.get_updater_state(), flat_opt)):
        for key, arr in _flatten_tree(tree).items():
            differ += not np.array_equal(arr, flat[key])
    return differ


def skip_epoch_archive(trainer):
    """Drop ``trainer``'s epoch-end archive (``checkpoint_epochN.zip``),
    keeping its step archives: 20c reads no epoch-end archive (A is the
    reference in memory, C is compared in memory after its fit), and at
    phase 9's width each is ~470 MB through host zlib (~25 s)."""
    write = trainer._checkpoint

    def checkpoint(path, snap=None):
        if "_step" in os.path.basename(path):
            write(path, snap)
    trainer._checkpoint = checkpoint
    return trainer


def resilient_train(card: str, cfg=TRAIN_CFG, device=None,
                    n_layers=RESUME_LAYERS):
    """Phase 20c: ``FaultTolerantTrainer`` at phase 9's width cut to
    ``n_layers`` blocks (each archive is ~470 MB of state), anomaly
    guard on, over one epoch of RES_BATCHES batches.

    A: the clean stream, uninterrupted, no archive: the reference, and
    the step times with no write running. B: the stream with NaN
    batches at RES_NAN, a transient ``train_step`` fault at call
    RES_RETRY_CALL, rollback after
    RES_ROLLBACK_AFTER anomalies, a host snapshot every 2 steps, a
    synchronous checkpoint every 4 steps and a ``preempt`` at boundary
    RES_PREEMPT (after step 4): the retry replays, the skips leave
    ``_step`` alone, the rollback restores the last snapshot's bits, and
    at step 4 B's state is A's bit for bit. C: ``resume`` of B's
    directory onto a fresh card network and ``fit`` to the end with an
    async write at step 5 (none at the epoch's end: see
    :func:`skip_epoch_archive`): its losses from step 5 on, params and
    Adam state are A's bit for bit. It prints the step loop's stall at
    a checkpoint (B sync, C async), the writer's seconds a write, and
    C's step p50 while its write runs beside A's with none running."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.faults import (FaultInjector,
                                                 PreemptionFault)
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.elastic import         FaultTolerantTrainer
    from deeplearning4j_tpu_torch.util.serializer import _flatten_tree
    cfg = dict(cfg, n_layers=n_layers)
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dl4j_elastic_")
    try:
        netA = MultiLayerNetwork(train_conf(cfg), device=device).init()
        dev = netA.device
        on_card = dev.type == "cuda"
        init = _snapshot_tree(netA.params())
        clean = resilience_batches(cfg, dev)
        faulted = resilience_batches(cfg, dev, bad=RES_NAN)
        at4 = {}

        def keep(tag):
            def hook(m):
                at4[tag] = (_flatten_tree(m.params()),
                            _flatten_tree(m.get_updater_state()),
                            m._rng, m._step)
            return hook

        # A: the uninterrupted reference
        trA = skip_epoch_archive(FaultTolerantTrainer(
            netA, os.path.join(root, "a"), save_every_n_steps=100,
            snapshot_every_n_steps=100, anomaly_guard=True))
        clockA = _StepClock(trA, {3: keep("A")})
        lossesA = []

        class Loss:
            def __init__(self, out):
                self.out = out

            def iteration_done(self, m, step, epoch):
                self.out.append((step, m.score_))
        netA.set_listeners(clockA, Loss(lossesA))
        reset_launches()
        t0 = time.perf_counter()
        trA.fit(clean, epochs=1)
        a_s = time.perf_counter() - t0
        launchesA = _flash_counts()
        # B: retry, skips, rollback, a sync checkpoint, the preemption
        netB = MultiLayerNetwork(train_conf(cfg), device=device).init()
        netB.set_params(init)
        inj = FaultInjector(plan={"train_step": [RES_RETRY_CALL],
                                  "preempt": [RES_PREEMPT]})
        dirB = os.path.join(root, "b")
        trB = FaultTolerantTrainer(netB, dirB, save_every_n_steps=4,
                                   snapshot_every_n_steps=2,
                                   async_write=False, anomaly_guard=True,
                                   rollback_after=RES_ROLLBACK_AFTER,
                                   fault_injector=inj)
        rolled = {}

        def check_rollback(m):
            snap = trB.supervisor.last_good
            rolled.update(
                rollbacks=trB.supervisor.rollbacks.value(), step=m._step,
                differ=_trees_equal(m, snap["params"], snap["opt_state"]),
                rng=m._rng == tuple(snap["meta"]["rng"]))
        # item 3 is the second NaN batch: the rollback ran inside it
        clockB = _StepClock(trB, {RES_NAN[1]: check_rollback,
                                  RES_NAN[1] + 2: keep("B")})
        netB.set_listeners(clockB)
        t0 = time.perf_counter()
        try:
            trB.fit(faulted, epochs=1)
            raise AssertionError("phase 20c: B was not preempted")
        except PreemptionFault:
            pass
        b_s = time.perf_counter() - t0
        supB = trB.supervisor.snapshot()
        namesB = [os.path.basename(p) for p in
                  FaultTolerantTrainer.list_checkpoints(dirB)]
        # C: resume B's checkpoint on a fresh network, fit to the end
        t0 = time.perf_counter()
        netC = FaultTolerantTrainer.resume(dirB, device=device)
        restore_s = time.perf_counter() - t0
        stepC0 = netC._step
        trC = skip_epoch_archive(FaultTolerantTrainer(
            netC, dirB, save_every_n_steps=5, anomaly_guard=True))
        clockC, lossesC = _StepClock(trC), []
        netC.set_listeners(clockC, Loss(lossesC))
        t0 = time.perf_counter()
        trC.fit(faulted, epochs=1)
        c_s = time.perf_counter() - t0
        pw, perr, pdiff = tree_diff(netC.params(), netA.params())
        aw, aerr, adiff = tree_diff(netC.get_updater_state(),
                                    netA.get_updater_state())
        pa, oa, rnga, stepa = at4["A"]
        pb, ob, rngb, stepb = at4["B"]
        diff4 = (sum(not np.array_equal(pa[k], pb[k]) for k in pa)
                 + sum(not np.array_equal(oa[k], ob[k]) for k in oa))
        tailA = [lv for s, lv in lossesA if s > stepC0]
        tailC = [lv for s, lv in lossesC]
        bad = []
        if supB["retries"] != 1 or supB["anomalies_skipped"] != 2 or \
                supB["rollbacks"] != 1 or supB["preemptions"] != 1:
            bad.append(f"B's counters {supB}")
        if rolled != {"rollbacks": 1, "step": 2, "differ": 0, "rng": True}:
            bad.append(f"rollback {rolled}")
        if (stepa, stepb) != (4, 4) or diff4 or rnga != rngb:
            bad.append(f"B at step 4 vs A: {diff4} leaves differ, steps "
                       f"{stepa} {stepb}, keys {rnga} {rngb}")
        if stepC0 != 4 or netC._step != netA._step:
            bad.append(f"steps: resumed at {stepC0}, ended "
                       f"{netC._step} vs {netA._step}")
        if tailC != tailA:
            bad.append(f"losses after the resume {tailC} vs {tailA}")
        if pdiff or adiff or netC._rng != netA._rng:
            bad.append(f"{pdiff} param and {adiff} Adam leaves differ "
                       f"(worst {pw} {perr:.3e}, {aw} {aerr:.3e})")
        if on_card and not (launchesA["flash_attention"] ==
                            launchesA["flash_attention_bwd_dq"] ==
                            launchesA["flash_attention_bwd_dkv"] ==
                            n_layers * RES_BATCHES):
            bad.append(f"A's launches {launchesA}")
        if bad:
            raise AssertionError(f"phase 20c failed: {bad}")
        stall = (lambda rows, i: rows[i + 1]["stall_s"]
                 - rows[i]["stall_s"])
        # the checkpoint steps: B's sync write after step 4 (item 5 of
        # the faulted stream), C's async submit after step 5 (its item 0)
        # (B is preempted at that boundary: its stall ends B's total)
        sync_stall = trB.supervisor.checkpoint_stall_s \
            - clockB.rows[RES_NAN[1] + 2]["stall_s"]
        async_stall = stall(clockC.rows, 0)
        none_ms = [r["ms"] for r in clockA.rows[2:]]
        writing_ms = [r["ms"] for r in clockC.rows[1:] if r["writing"]]
        wC = trC._writer.snapshot()
        res = dict(
            n_layers=n_layers, params=netA.num_params(),
            state_bytes=sum(a.nbytes for a in pa.values())
            + sum(a.nbytes for a in oa.values()),
            supervisor_b=supB, checkpoints_b=namesB, rollback=rolled,
            restore_s=restore_s, a_s=a_s, b_s=b_s, c_s=c_s,
            sync_stall_s=sync_stall, async_stall_s=async_stall,
            sync_write_s=supB["checkpoint_write_s"],
            async_write_s=wC["write_s_total"] / max(wC["writes"], 1),
            writes_c=wC["writes"],
            step_p50_none_ms=float(np.median(none_ms)),
            step_p50_writing_ms=(float(np.median(writing_ms))
                                 if writing_ms else None),
            steps_writing=len(writing_ms), steps_none=len(none_ms),
            launches_a=launchesA, losses_a=[lv for _, lv in lossesA],
            seconds=time.perf_counter() - t_phase)
        p50w = ("none ran during a write" if res["step_p50_writing_ms"]
                is None else f"{res['step_p50_writing_ms']:.2f}")
        print(f"resilient training (phase 20c) [{card}]: {n_layers} blocks "
              f"({res['params']} params, {res['state_bytes']} bytes of "
              f"params and Adam state; cut from {TRAIN_CFG['n_layers']}: see "
              f"PERF.md), {RES_BATCHES} batches, anomaly guard on: B "
              f"{supB['retries']} retry, {supB['anomalies_skipped']} skips "
              f"(_step held), {supB['rollbacks']} rollback to step "
              f"{rolled['step']}'s bits, preempted at step 4 with "
              f"{namesB}; B at step 4 and C from the resume on are A's bit "
              f"for bit (losses, every param and Adam leaf, key); restore "
              f"{restore_s:.2f} s; step-loop stall at a checkpoint "
              f"{sync_stall:.3f} s sync vs {async_stall:.3f} s async; "
              f"writer {res['sync_write_s']:.2f} s (sync), "
              f"{res['async_write_s']:.2f} s a write over {wC['writes']} "
              f"(async, C; no epoch-end archive in A or C); step p50 "
              f"{p50w} ms over "
              f"{res['steps_writing']} steps while a write ran vs "
              f"{res['step_p50_none_ms']:.2f} ms over {res['steps_none']} "
              f"with none (A); A {a_s:.1f} s, B {b_s:.1f} s, C {c_s:.1f} s;"
              f" phase 20c took {res['seconds']:.1f} s")
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- phase 21: ComputationGraph, the zoo's ResNet-50 ---------------------
RESNET_SHAPE = (224, 224, 3)   # BASELINE config 2, the zoo's ResNet50
RESNET_CLASSES = 1000
RESNET_BATCH = 64
RESNET_STEPS = 5        # 21a: timed steps, after one warmup step
RESNET_COPY_BATCH = 8   # 21a: the step held against a CPU copy
RESNET_BF16_STEPS = 3   # 21b
GRAPH_NODE_TOL = 1e-4   # 21a: each node's pre-activation computed on the
#                         CPU from the card's inputs to that node, against
#                         the card's, over the node's max |value| (f32 on
#                         both sides, TF32 off; sums of up to 4,608 terms in
#                         another order: CNN_TOL's reason)
GRAPH_LOSS_RTOL = 1e-4  # 21a: the whole-graph loss, the CPU copy on its own
#                         values against the card (53 conv and batch-norm
#                         layers, each adding its f32 rounding)
GRAPH_GRAD_TOL = 1e-4   # 21a: each gradient leaf (the CPU copy on the
#                         card's pre-activations) over its max |value|, or
#                         3x the most that leaf moves on the CPU itself when
#                         the card's pre-activations move by 1e-7 relative
#                         (two draws), whichever is larger: a random-init
#                         ResNet's batch-norm backward is ill-conditioned
#                         (tests/test_torch_zoo_graph.py: JAX's own gradient
#                         moves by up to 0.47 of a leaf's max at 32x32)
GRAPH_WITNESS_REL = 1e-7
GRAPH_PARAM_ATOL = CNN_PARAM_ATOL  # 21a: params after the step, absolute
GRAPH_SERVE_TOL = 1e-5  # 21c: served logits against eager output(), each
#                         row over its max |logit| (f32; cuDNN may pick
#                         another algorithm for another batch size: read
#                         1.3e-6 on an H100, a row's bits across buckets
#                         2.3e-7; a 1% change of the weights moves the
#                         rows by ~1)
GRAPH_SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)  # 21c: every power-of-two
#                         bucket up to 32 (the engine's), captured at warmup
GRAPH_BITS_BUCKETS = (1, 8, 32)  # 21c: one row's bits alone and inside these
GRAPH_SERVE_REQUESTS = 64
GRAPH_SERVE_CLIENTS = 16
INCEPTION_SHAPE = (160, 160, 3)
SQUEEZENET_SHAPE = (227, 227, 3)
GRAPH_FWD_BATCH = 4     # 21d: the forward held against a CPU copy


def graph_pre_nodes(g):
    """The layer nodes whose activation the loss's forward runs (all but
    the output layers), by name."""
    return [n for n in g._order if g.conf.nodes[n].layer is not None
            and n not in g.conf.graph_outputs]


def traced_graph_step(g, x, y, subst=None, record=True):
    """One step's loss, gradients (on the host) and new layer state
    through the graph's own ``_loss_fn``, with each layer node's
    pre-activation (the input of its activation). With ``subst`` (another
    run's pre-activations, by node) each z becomes ``z + (subst - z)
    .detach()``: the other run's values, so ReLUs and pools choose as it
    did, with this run's own gradient; the recorded z is this run's own,
    that is, the node computed here on the other run's inputs to it."""
    import torch
    xs, ys = g._as_inputs(x), g._as_labels(y)
    pre = {}
    layers = {n: g.conf.nodes[n].layer for n in graph_pre_nodes(g)}
    acts = {n: layer.activation for n, layer in layers.items()}

    def recording(n, act):
        def f(z):
            if record:
                pre[n] = z.detach().float().cpu()
            if subst is not None:
                z = z + (subst[n].to(z.device, z.dtype) - z).detach()
            return act(z)
        return f
    for n, layer in layers.items():
        layer.activation = recording(n, acts[n])
    try:
        keys = [(k, n) for k, p in g._params.items() for n in p]
        with torch.enable_grad():
            loss, state = g._loss_fn(g._params, g._net_state, xs, ys, None,
                                     True, None)
            gs = torch.autograd.grad(loss, [g._params[k][n]
                                            for k, n in keys])
    finally:
        for n, layer in layers.items():
            layer.activation = acts[n]
    grads = {k: {} for k in g._params}
    for (k, n), t in zip(keys, gs):
        grads[k][n] = t.detach().cpu()
    return float(loss.detach()), grads, pre, {
        k: {n: t.detach().cpu() for n, t in st.items()}
        for k, st in state.items()}


def graph_layer(net, n):
    """The layer of node ``n`` of a graph, or of layer ``n`` of a
    sequential network."""
    return net.conf.nodes[n].layer if hasattr(net.conf, "nodes") \
        else net.layers[n]


def traced_net_step(net, x, y, subst=None, record=True):
    """:func:`traced_graph_step` for a graph, :func:`traced_step` (no
    dropout key) for a sequential network: (loss, grads, pre, state)."""
    if hasattr(net.conf, "nodes"):
        return traced_graph_step(net, x, y, subst, record)
    return traced_step(net, x, y, None, subst)[:4]


def graph_vs_cpu(card, x, y, label: str, apply_step: bool = True,
                 witnesses: int = 2, grad_tol: float = GRAPH_GRAD_TOL):
    """One step of a card network (a graph or a sequential one) against
    a CPU copy with the same params, layer state and Adam state. Node by
    node, each pre-activation computed on the CPU from the card's inputs
    to it; the ReLUs that chose otherwise there are counted and each
    must be a near-tie; the whole loss of the CPU on its own values;
    every gradient of the CPU run on the card's pre-activations, within
    ``grad_tol`` or 3x the most that leaf moves on the CPU itself
    under a 1e-7 relative move of the card's values in ``witnesses``
    draws (batch norm's backward at random init is ill-conditioned; a
    net without batch norm needs none); then, with
    ``apply_step``, both apply the step (the card by a fit on the same
    batch, so a network that draws dropout in training sets it False)
    and the params must agree (``GRAPH_PARAM_ATOL``) and Adam's m and
    v, each leaf within its gradient's gate (v, a square, twice it).
    Where GRAPH_PARAM_ATOL is more than a tenth of the step (a learning
    rate below 1e-3, as an imported Keras file's Adam(1e-4)), each param
    must instead have moved by Adam's update of the card's own new m
    and v (:func:`adam_update_err`): a sign-of-noise gradient moves a
    param by about lr either way on each side."""
    import torch
    cpu = card.clone(device="cpu")
    cpu.set_updater_state(card.get_updater_state())
    cpu._step = card._step
    xh, yh = x.cpu(), y.cpu()
    t0 = time.perf_counter()
    lc, gc, pc, sc = traced_net_step(card, x, y)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, gh, ph, sh = traced_net_step(cpu, xh, yh, subst=pc)
    node_err, worst_node, ties, tie_worst = 0.0, None, 0, 0.0
    for n, z in ph.items():
        e = _rel(z, pc[n])
        if e > node_err:
            node_err, worst_node = e, n
        if graph_layer(cpu, n).activation.name == "relu":
            flip = (pc[n] > 0) != (z > 0)
            ties += int(flip.sum())
            if flip.any():
                tie_worst = max(tie_worst, max(
                    float(z[flip].abs().max()),
                    float(pc[n][flip].abs().max())) / float(z.abs().max()))
    del ph
    # the CPU's own gradient under tiny moves of the card's values: the
    # backward's own conditioning, leaf by leaf
    moved = []
    for seed in range(1, 1 + witnesses):
        gen = torch.Generator().manual_seed(seed)
        jitter = {n: z * (1 + GRAPH_WITNESS_REL * torch.randn(
            z.shape, generator=gen, dtype=z.dtype)) for n, z in pc.items()}
        moved.append(traced_net_step(cpu, xh, yh, subst=jitter,
                                     record=False)[1])
        del jitter
    with torch.no_grad():
        lh = float(cpu._loss_fn(cpu._params, cpu._net_state,
                                *cpu_feeds(cpu, xh, yh), None, True,
                                None)[0])
    t_cpu = time.perf_counter() - t0
    loss_rel = abs(lc - lh) / abs(lh)
    grad_err, grad_worst, over = 0.0, None, []
    floors, noise = {}, []
    for k, p in gh.items():
        for n, t in p.items():
            floor = max((_rel(m[k][n], t) for m in moved), default=0.0)
            floors[f"{k}.{n}"] = floor
            if max(grad_tol, 3 * floor) > 0.01:
                # held to no better than 1%: round-off where exact
                # arithmetic gives zero (a batch-norm beta that reaches
                # the loss only through another batch norm)
                noise.append(int(t.numel()))
            e = _rel(gc[k][n], t)
            if e > grad_err:
                grad_err, grad_worst = e, f"{k}.{n}"
            if e > max(grad_tol, 3 * floor):
                over.append((f"{k}.{n}", e, floor))
    _, state_err = _worst(sc, sh)
    perr, aw, aerr, adam_over, upd = None, None, 0.0, [], None
    if apply_step:
        # both apply the step: the card its own (a fit on the same
        # batch), the CPU copy its gradients from the card's
        # pre-activations
        step0 = card._step
        ups = card._updaters
        lr = min(float(u.lr(step0)) for u in (
            ups.values() if isinstance(ups, dict) else ups))
        adam_update = GRAPH_PARAM_ATOL > 0.1 * lr
        p0 = {k: {n: _host(t) for n, t in p.items()}
              for k, p in card.params().items()} if adam_update else None
        card.fit(x, y)
        cpu.apply_gradients(gh, sh)
        perr = max(float((_host(t) - _host(cpu.params()[k][n])).abs().max())
                   for k, p in card.params().items() for n, t in p.items())
        cs, hs = card.get_updater_state(), cpu.get_updater_state()
        for k, st in hs.items():
            for part, leaves in st.items():
                for n, t in leaves.items():
                    e = _rel(cs[k][part][n], t)
                    gate = max(grad_tol, 3 * floors[f"{k}.{n}"]) * (
                        2 if part == "v" and "m" in st else 1)
                    if e > aerr:
                        aw, aerr = f"{k}.{part}.{n}", e
                    if e > gate:
                        adam_over.append((f"{k}.{part}.{n}", e, gate))
        if adam_update:
            upd = adam_update_err(card, p0, step0)
    res = dict(batch=int(x.shape[0]), loss=lc, cpu_loss=lh,
               loss_rel_err=loss_rel, nodes=len(pc), node_rel_err=node_err,
               worst_node=worst_node, near_ties=ties,
               near_tie_worst=tie_worst, worst_grad=grad_worst,
               worst_grad_rel_err=grad_err,
               grad_floor_max=max(floors.values(), default=0.0),
               grads_over_tol=over[:5], state_rel_err=state_err,
               param_abs_err=perr, adam_worst=aw, adam_rel_err=aerr,
               adam_over_gate=adam_over[:5], adam_update=upd,
               noise_leaves=len(noise), noise_leaf_params=sum(noise),
               leaves=len(floors), card_trace_s=t_card, cpu_s=t_cpu)
    params_ok = not apply_step or (
        upd["within"] if upd is not None else perr <= GRAPH_PARAM_ATOL)
    if not (loss_rel <= GRAPH_LOSS_RTOL and node_err <= GRAPH_NODE_TOL
            and not over and state_err <= GRAPH_NODE_TOL
            and tie_worst <= NEAR_TIE and params_ok and not adam_over):
        raise AssertionError(f"phase {label} card vs CPU failed: {res}")
    return res


ADAM_UPDATE_LR = 1e-4   # 25b: each param's move against Adam's update of
#                         the card's own new m and v, elementwise within
#                         this fraction of the learning rate (the f32
#                         update's own rounding) plus 2^-22 of the param
#                         (the rounding of p - u); a missing update misses
#                         by ~lr, a halved one by ~lr / 2


def adam_update_err(net, p0, step0):
    """How far each param's move in a network's last step stands from
    Adam's update of its own new moments, computed here in f64 from the
    JAX package's formula (``t = step + 1``, ``u = lr * sqrt(1 - b2^t) /
    (1 - b1^t) * m / (sqrt(v) + eps)``): the worst element over its
    tolerance (``within`` when at most 1), and the largest move in
    learning rates (~1 at the first step: the check is not vacuous)."""
    worst, worst_leaf, move = 0.0, None, 0.0
    state = net.get_updater_state()
    ups = net._updaters  # by node for a graph, by layer for a sequential net
    ups = ups if isinstance(ups, dict) else dict(zip(net._layer_keys, ups))
    for k, p in net.params().items():
        upd = ups[k]
        if type(upd).__name__ != "Adam":
            raise AssertionError(f"{k}: updater {type(upd).__name__}, "
                                 "not Adam")
        t, lr = step0 + 1, float(upd.lr(step0))
        lr_bc = lr * (1 - upd.beta2 ** t) ** 0.5 / (1 - upd.beta1 ** t)
        for n, tp in p.items():
            p1 = _host(tp)
            m, v = _host(state[k]["m"][n]), _host(state[k]["v"][n])
            u = lr_bc * m / (v.sqrt() + upd.epsilon)
            err = ((p0[k][n] - p1) - u).abs() / (
                ADAM_UPDATE_LR * lr + 2.0 ** -22 * p1.abs())
            e = float(err.max())
            if e > worst:
                worst, worst_leaf = e, f"{k}.{n}"
            move = max(move, float((p0[k][n] - p1).abs().max()) / lr)
    return dict(worst=worst, worst_leaf=worst_leaf, within=worst <= 1.0,
                max_move_lr=move)


def cpu_feeds(net, x, y):
    """The (inputs, labels) ``_loss_fn`` takes: by name for a graph, as
    tensors for a sequential network."""
    if hasattr(net.conf, "nodes"):
        return net._as_inputs(x), net._as_labels(y)
    return net._to_device(x, y)[:2]


def layer_macs(layer) -> int:
    """Multiply-adds of one example through a layer's products (the
    convolutions and dense layers), from its built shapes; 0 for the
    layers without any."""
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                    DenseLayer)
    from deeplearning4j_tpu_torch.nn.layers.convolutional import (
        Deconvolution2D, DepthwiseConvolution2D, SeparableConvolution2D)
    shape = layer.input_shape
    if isinstance(layer, DenseLayer):
        return layer.n_in * layer.n_out
    if not isinstance(layer, (ConvolutionLayer, Deconvolution2D,
                              DepthwiseConvolution2D,
                              SeparableConvolution2D)):
        return 0
    kh, kw = layer.kernel
    if isinstance(layer, Deconvolution2D):   # every input pixel scatters
        return shape[0] * shape[1] * kh * kw * layer.n_in * layer.n_out
    oh, ow, n_out = layer.output_shape(shape)
    if isinstance(layer, SeparableConvolution2D):
        mid = layer.n_in * layer.depth_multiplier
        return oh * ow * (kh * kw * mid + mid * n_out)
    if isinstance(layer, DepthwiseConvolution2D):
        return oh * ow * kh * kw * n_out
    return oh * ow * kh * kw * (layer.n_in // layer.groups) * n_out


def net_layers(net):
    if hasattr(net.conf, "nodes"):
        return [nd.layer for nd in net.conf.nodes.values()
                if nd.layer is not None]
    return list(net.layers)


def train_bound_ms(net, batch: int, rate: float) -> float:
    """The least time a training step of ``batch`` examples could take
    at ``rate`` flops/s: three forwards' products (the forward, and the
    backward's two a layer), from the network's own layer shapes."""
    macs = sum(layer_macs(layer) for layer in net_layers(net))
    return 3 * 2 * macs * batch / rate * 1e3


def mask_batch(n, seed, shape):
    """Images and a learnable one-channel mask: each pixel is on where
    its channels' mean exceeds 0.5."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, *shape).astype(np.float32)
    return x, (x.mean(-1, keepdims=True) > 0.5).astype(np.float32)


def zoo_batch(n, seed, shape, classes):
    """Images and labels for a zoo model: a learnable one-channel mask
    for one class (UNet), else one-hot labels of a learnable rule."""
    return mask_batch(n, seed, shape) if classes == 1 else \
        simple_cnn_batch(n, seed, shape, classes)


def zoo_train(card: str, make, label: str, shape, batch: int, steps: int,
              copy_batch: int, classes: int, profile: bool = False,
              device=None, apply_step: bool = True, seed: int = 22,
              witnesses: int = 2, batch_fn=zoo_batch,
              grad_tol: float = GRAPH_GRAD_TOL):
    """One zoo model at full width through fit: one warmup and ``steps``
    timed Adam steps on a learnable synthetic batch (``batch_fn(n, seed,
    shape, classes)``), the loss falling and every running stat moving,
    peak memory, optionally one profiled step, then one step at
    ``copy_batch`` against a CPU copy (:func:`graph_vs_cpu`)."""
    import torch
    t_phase = time.perf_counter()
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = make(device)
    init_s = time.perf_counter() - t0
    dev = net.device
    xs, ys = batch_fn(batch, seed, shape, classes)
    x, y = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
    state0 = {k: {n: t.clone() for n, t in st.items()}
              for k, st in net.get_net_state().items()}
    clock = StepClock(sync=on_card)
    net.set_listeners(clock)
    losses = []
    clock.start()
    t0 = time.perf_counter()
    for _ in range(1 + steps):
        net.fit(x, y)
        losses.append(net.score_)
    train_s = time.perf_counter() - t0
    net.set_listeners()
    moved = sum(int(not torch.equal(t, state0[k][n]))
                for k, st in net.get_net_state().items()
                for n, t in st.items())
    n_stats = sum(len(st) for st in state0.values())
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and moved == n_stats):
        raise AssertionError(f"phase {label}: losses {losses}, {moved} of "
                             f"{n_stats} running stats moved")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    t0 = time.perf_counter()
    prof = profile_train_step(net, x, y) if on_card and profile else None
    profile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vs_cpu = graph_vs_cpu(net, x[:copy_batch], y[:copy_batch], label,
                          apply_step, witnesses, grad_tol)
    copy_s = time.perf_counter() - t0
    step_p50 = float(np.median(clock.step_ms[1:]))
    return net, dict(
        input=list(shape), classes=classes, batch=batch, steps=steps,
        params=net.num_params(), layers=len(net_layers(net)), init_s=init_s,
        losses=losses, step_ms=clock.step_ms, step_p50_ms=step_p50,
        enqueue_p50_ms=float(np.median(clock.enqueue_ms[1:])),
        images_per_s=batch / (step_p50 / 1e3),
        bound_ms=train_bound_ms(net, batch, H100_F32_FLOPS),
        peak_bytes=peak, stats_moved=moved, profile=prof, vs_cpu=vs_cpu,
        train_s=train_s, profile_s=profile_s, copy_s=copy_s,
        seconds=time.perf_counter() - t_phase)


def zoo_bf16(card: str, make, label: str, shape, batch: int, steps: int,
             rows: int, classes: int, device=None, seed: int = 22,
             batch_fn=zoo_batch):
    """A fresh zoo model under the bf16 policy: ``steps`` steps,
    the loss falling, the masters and Adam state f32; before them, the
    training loss of the first ``rows`` images on the card against a CPU
    copy's at bf16."""
    import torch
    t_phase = time.perf_counter()
    net = make(device)
    net.conf.dtype = "bfloat16"   # what data_type("bfloat16") sets
    on_card = net.device.type == "cuda"
    cpu = net.clone(device="cpu")
    xs, ys = batch_fn(batch, seed, shape, classes)
    x, y = torch.from_numpy(xs).to(net.device), torch.from_numpy(ys).to(
        net.device)
    t0 = time.perf_counter()
    with torch.no_grad():
        first = float(net._loss_fn(net._params, net._net_state,
                                   *cpu_feeds(net, x[:rows], y[:rows]),
                                   None, True, None)[0])
        cpu_loss = float(cpu._loss_fn(
            cpu._params, cpu._net_state,
            *cpu_feeds(cpu, torch.from_numpy(xs[:rows]),
                       torch.from_numpy(ys[:rows])), None, True, None)[0])
    cpu_s = time.perf_counter() - t0
    clock = StepClock(sync=on_card)
    net.set_listeners(clock)
    losses = []
    clock.start()
    for _ in range(steps):
        net.fit(x, y)
        losses.append(net.score_)
    net.set_listeners()
    loss_rel = abs(first - cpu_loss) / abs(cpu_loss)
    dtypes = {str(t.dtype) for p in net.params().values() for t in p.values()}
    dtypes |= {str(t.dtype) for st in net.get_updater_state().values()
               for part in st.values() for t in part.values()}
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and loss_rel <= TRAIN_BF16_LOSS_RTOL
            and dtypes == {"torch.float32"}):
        raise AssertionError(f"phase {label} bf16: losses {losses}, first "
                             f"{rows} rows' loss {first} vs CPU {cpu_loss} "
                             f"({loss_rel:.3e}), dtypes {dtypes}")
    step_p50 = float(np.median(clock.step_ms[1:]))
    return dict(batch=batch, steps=steps, losses=losses,
                step_ms=clock.step_ms, step_p50_ms=step_p50,
                enqueue_p50_ms=float(np.median(clock.enqueue_ms[1:])),
                images_per_s=batch / (step_p50 / 1e3),
                bound_ms=train_bound_ms(net, batch, H100_BF16_FLOPS),
                rows=rows, first_loss=first, cpu_loss=cpu_loss,
                loss_rel_err=loss_rel, cpu_s=cpu_s,
                seconds=time.perf_counter() - t_phase)


def zoo_make(name, shape, classes, seed=22, **kw):
    """A constructor of the zoo's ``name`` at ``shape`` on a device."""
    from deeplearning4j_tpu_torch import zoo

    def make(device):
        return getattr(zoo, name)(num_classes=classes, input_shape=shape,
                                  seed=seed, device=device, **kw).init()
    return make


def logits_graph(net):
    """A copy of ``net`` on its device whose output layer's softmax is
    taken off, so its rows are the logits. After 21a's steps on one
    batch the softmax rows are one-hot to f32, where stale batch-norm
    stats or wrong logits with the same top class give the same rows;
    the logits show them."""
    from deeplearning4j_tpu_torch import activations as A
    served = net.clone()
    for name in served.conf.graph_outputs:
        served.conf.nodes[name].layer.activation = A.get("identity")
    return served


def row_rel_err(got, want) -> float:
    """The largest gap of two [rows, classes] arrays, each row over its
    largest |value|."""
    want = np.asarray(want, np.float64)
    den = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1e-30)
    return float((np.abs(np.asarray(got, np.float64) - want) / den).max())


def graph_serve(card: str, net, shape=RESNET_SHAPE,
                buckets=GRAPH_SERVE_BUCKETS, n_requests=GRAPH_SERVE_REQUESTS,
                clients=GRAPH_SERVE_CLIENTS, label="21c"):
    """Phase 21c (22c for Xception): the trained ResNet-50, its logits
    (:func:`logits_graph`),
    behind InferenceEngine and the micro-batcher. Buckets captured at
    warmup and nothing after; every served row against eager
    ``output()`` on that row alone; one row's bits alone and inside each
    bucket; then ``set_params`` and ``set_net_state`` with new values:
    each bucket captured once more over the new leaves and no compile,
    its rows the new ``output()`` and away from the old; rows/s and
    request p50/p99."""
    import torch
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    from deeplearning4j_tpu_torch.serving.batcher import MicroBatcher
    t_phase = time.perf_counter()
    served = logits_graph(net)
    eng = InferenceEngine(served, max_batch_size=max(buckets))
    t0 = time.perf_counter()
    eng.warmup(list(buckets))
    warm_s = time.perf_counter() - t0
    compiles, captures = eng.metrics.compiles, eng.captures
    rs = np.random.RandomState(2121)
    sizes = rs.randint(1, 5, n_requests)
    xs = [rs.rand(int(k), *shape).astype(np.float32) for k in sizes]
    # a row's bits alone and inside each bucket
    row = xs[0][:1]
    by_bucket = {}
    for b in GRAPH_BITS_BUCKETS:
        filler = rs.rand(b - 1, *shape).astype(np.float32)
        by_bucket[b] = eng.predict(np.concatenate([row, filler]))[:1]
    bits_differ = {b: bool(not np.array_equal(by_bucket[b], by_bucket[1]))
                   for b in by_bucket}
    bucket_gap = max(row_rel_err(by_bucket[b], by_bucket[1])
                     for b in by_bucket)
    batcher = MicroBatcher(eng, max_batch_size=max(buckets),
                           max_latency_ms=5.0)
    outs, lat = [None] * n_requests, [None] * n_requests
    lock = threading.Lock()
    nxt = [0]

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= n_requests:
                return
            t = time.perf_counter()
            outs[i] = batcher.submit(xs[i])
            lat[i] = (time.perf_counter() - t) * 1e3
    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    batcher.stop()
    worst = max(row_rel_err(ob, served.output(xb).float().cpu().numpy())
                for xb, ob in zip(xs, outs))
    after_traffic = (eng.metrics.compiles, eng.captures)
    # new weights and new running stats, set on the served graph: every
    # bucket must serve them (a graph replayed over the old leaves fails)
    big = np.concatenate(xs)[:max(buckets)]
    old = {b: eng.predict(big[:b]) for b in buckets}
    with torch.no_grad():
        served.set_params({k: {n: t * 1.01 for n, t in p.items()}
                           for k, p in served.params().items()})
        served.set_net_state({k: {n: t * 1.1 for n, t in st.items()}
                              for k, st in served.get_net_state().items()})
    new = {b: eng.predict(big[:b]) for b in buckets}
    swap_captures = eng.captures - after_traffic[1]
    again = {b: eng.predict(big[:b]) for b in buckets}
    swap_err = max(row_rel_err(new[b], served.output(big[:b]).float().cpu()
                               .numpy()) for b in buckets)
    swap_moved = min(row_rel_err(new[b], old[b]) for b in buckets)
    swap_repeat = all(np.array_equal(again[b], new[b]) for b in buckets)
    rows = int(sizes.sum())
    res = dict(buckets=list(buckets), warmup_s=warm_s, compiles=compiles,
               captures=captures, requests=n_requests, rows=rows,
               rows_per_s=rows / wall,
               request_p50_ms=float(np.percentile(lat, 50)),
               request_p99_ms=float(np.percentile(lat, 99)),
               max_rel_err=worst, row_bits_differ_by_bucket=bits_differ,
               row_gap_across_buckets=bucket_gap,
               swap_rel_err=swap_err, swap_moved_rel=swap_moved,
               swap_captures=swap_captures,
               swap_compiles=eng.metrics.compiles - compiles,
               seconds=time.perf_counter() - t_phase)
    # one capture a bucket on the card; the CPU's entries capture none
    caps = len(buckets) if eng.device.type == "cuda" else 0
    if not (after_traffic == (compiles, captures) == (len(buckets), caps)
            and worst <= GRAPH_SERVE_TOL and swap_err <= GRAPH_SERVE_TOL
            and swap_moved > 100 * GRAPH_SERVE_TOL
            and swap_captures == caps and swap_repeat
            and eng.metrics.compiles == compiles):
        raise AssertionError(f"phase {label} failed: {res}, compiles now "
                             f"{eng.metrics.compiles}, captures now "
                             f"{eng.captures}")
    return res


def graph_forward_vs_cpu(net, shape, batch=GRAPH_FWD_BATCH, seed=0):
    """One inference forward of a card graph against a CPU copy: the
    output and every node's activation, each over its max |value|."""
    import torch
    cpu = net.clone(device="cpu")
    x = np.random.RandomState(seed).rand(batch, *shape).astype(np.float32)
    card_acts = net.feed_forward(x)
    cpu_acts = cpu.feed_forward(x)
    errs = {n: _rel(card_acts[n], cpu_acts[n]) for n in net._order
            if torch.is_tensor(cpu_acts[n])}
    worst = max(errs, key=errs.get)
    return dict(nodes=len(errs), worst_node=worst, node_rel_err=errs[worst],
                output_rel_err=errs[net.conf.graph_outputs[0]])


def squeezenet_resume(device=None, shape=SQUEEZENET_SHAPE, batch=8):
    """21d's archive: SqueezeNet after one step, written with its Adam
    state and restored into a fresh graph on the card; the next step of
    each (dropout drawn from the restored key chain) bit for bit. cuDNN
    may pick non-deterministic algorithms, so both run with
    ``cudnn.deterministic`` set."""
    import tempfile
    import torch
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import SqueezeNet
    prior = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        net = SqueezeNet(num_classes=RESNET_CLASSES, input_shape=shape,
                         seed=21, device=device).init()
        xs, ys = simple_cnn_batch(batch, 22, shape, RESNET_CLASSES)
        net.fit(xs, ys)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "squeezenet.zip")
            t0 = time.perf_counter()
            ModelSerializer.write_model(net, path)
            write_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            back = ModelSerializer.restore(path, device=device)
            restore_s = time.perf_counter() - t0
        net.fit(xs, ys)
        back.fit(xs, ys)
        diff = sum(int(not torch.equal(t, back.params()[k][n]))
                   for k, p in net.params().items() for n, t in p.items())
        diff += sum(int(not torch.equal(t, back.get_updater_state()[k][s][n]))
                    for k, st in net.get_updater_state().items()
                    for s, part in st.items() for n, t in part.items())
    finally:
        torch.backends.cudnn.deterministic = prior
    if diff or back._step != net._step or back._rng != net._rng:
        raise AssertionError(f"phase 21d: the restored SqueezeNet's next "
                             f"step differs in {diff} leaves")
    return net, dict(params=net.num_params(), archive_bytes=size,
                     write_s=write_s, restore_s=restore_s,
                     leaves_differing=diff)


def graph_phase(card: str, device=None, shape=RESNET_SHAPE,
                batch=RESNET_BATCH, steps=RESNET_STEPS,
                inception_shape=INCEPTION_SHAPE,
                squeeze_shape=SQUEEZENET_SHAPE,
                classes=RESNET_CLASSES):
    """Phase 21: (a) ResNet-50 trained at full width, (b) under the bf16
    policy, (c) served, (d) InceptionResNetV1 and SqueezeNet against CPU
    copies and SqueezeNet's archive. No TPU kernel is on this path: the
    launch counters must stay 0."""
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.zoo import InceptionResNetV1, SqueezeNet
    t_phase = time.perf_counter()
    reset_launches()
    resnet = zoo_make("ResNet50", shape, classes, seed=21)
    net, a = zoo_train(card, resnet, "21a", shape, batch, steps,
                       RESNET_COPY_BATCH, classes, profile=True,
                       device=device, seed=21)
    b = zoo_bf16(card, resnet, "21b", shape, batch, RESNET_BF16_STEPS,
                 batch, classes, device, seed=21)
    c = graph_serve(card, net, shape)
    del net
    gc.collect()
    inc = InceptionResNetV1(input_shape=inception_shape, seed=21,
                            device=device).init()
    d_inc = graph_forward_vs_cpu(inc, inception_shape)
    del inc
    sq, d_sq_resume = squeezenet_resume(device, squeeze_shape)
    d_sq = graph_forward_vs_cpu(sq, squeeze_shape)
    del sq
    for label, d in (("InceptionResNetV1", d_inc), ("SqueezeNet", d_sq)):
        if d["node_rel_err"] > GRAPH_NODE_TOL:
            raise AssertionError(f"phase 21d {label} card vs CPU: {d}")
    launches = kernels.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"phase 21 launched a TPU kernel: {launches}")
    wall = time.perf_counter() - t_phase
    v, p = a["vs_cpu"], a["profile"]
    print(f"graph (phase 21a) [{card}]: ResNet-50 {tuple(shape)} x "
          f"{classes} ({a['params']} params, {a['layers']} layers) at batch "
          f"{batch}, f32: step p50 {a['step_p50_ms']:.3f} ms (bound "
          f"{a['bound_ms']:.3f} ms at the f32 rate), queued in p50 "
          f"{a['enqueue_p50_ms']:.3f} ms, {a['images_per_s']:.1f} images/s, "
          f"peak {a['peak_bytes']} bytes, loss "
          f"{[round(l, 4) for l in a['losses']]}, {a['stats_moved']} running "
          f"stats moved, init {a['init_s']:.1f} s")
    if p is not None:
        print(f"graph (phase 21a) profile [{card}] (one step): device busy "
              f"{p['busy_share']:.3f} of {p['wall_ms']:.1f} ms, "
              f"{p['device_kernels']} device kernels, "
              f"{p['conv_ms']:.1f} ms in cuDNN's convolutions, "
              f"{p['layout_ms']:.1f} ms in layout copies; top (ms): "
              + ", ".join(f"{n[:50]} {t:.3f}" for n, t in p["top"][:6]))
    print(f"graph (phase 21a) vs CPU [{card}]: batch {v['batch']}: loss "
          f"rel err {v['loss_rel_err']:.3e} (tol {GRAPH_LOSS_RTOL:g}), "
          f"{v['nodes']} nodes on the card's inputs, worst "
          f"{v['worst_node']} {v['node_rel_err']:.3e} (tol "
          f"{GRAPH_NODE_TOL:g}), {v['near_ties']} ReLU near-ties (largest "
          f"|z| {v['near_tie_worst']:.1e} of its layer's max), worst "
          f"gradient {v['worst_grad']} {v['worst_grad_rel_err']:.3e} (the "
          f"CPU's own floor up to {v['grad_floor_max']:.3e}), new running "
          f"stats {v['state_rel_err']:.3e}, params after the step "
          f"{v['param_abs_err']:.3e}, Adam {v['adam_worst']} "
          f"{v['adam_rel_err']:.3e}; CPU {v['cpu_s']:.1f} s")
    print(f"graph (phase 21b) [{card}]: ResNet-50 under the bf16 policy at "
          f"batch {batch}: step p50 {b['step_p50_ms']:.3f} ms (bound "
          f"{b['bound_ms']:.3f} ms at the bf16 rate), "
          f"{b['images_per_s']:.1f} images/s beside f32's "
          f"{a['images_per_s']:.1f}, loss "
          f"{[round(l, 4) for l in b['losses']]}, first loss vs CPU "
          f"{b['loss_rel_err']:.3e} (tol {TRAIN_BF16_LOSS_RTOL:g})")
    print(f"graph (phase 21c) [{card}]: ResNet-50's logits behind "
          f"InferenceEngine and the micro-batcher: buckets {c['buckets']} "
          f"captured in {c['warmup_s']:.1f} s ({c['compiles']} compiles, "
          f"{c['captures']} captures, none after), {c['rows']} rows in "
          f"{c['requests']} requests from {GRAPH_SERVE_CLIENTS} threads at "
          f"{c['rows_per_s']:.1f} rows/s, request p50/p99 "
          f"{c['request_p50_ms']:.1f}/{c['request_p99_ms']:.1f} ms, rows vs "
          f"output() {c['max_rel_err']:.3e} of the row's max |logit| (tol "
          f"{GRAPH_SERVE_TOL:g}); one row's bits differ by bucket: "
          f"{c['row_bits_differ_by_bucket']} (largest gap "
          f"{c['row_gap_across_buckets']:.3e}); after set_params and "
          f"set_net_state: {c['swap_captures']} captures again, "
          f"{c['swap_compiles']} compiles, rows vs the new output() "
          f"{c['swap_rel_err']:.3e}, moved {c['swap_moved_rel']:.3e} from "
          f"the old rows")
    print(f"graph (phase 21d) [{card}]: InceptionResNetV1 "
          f"{tuple(inception_shape)} vs CPU: {d_inc['nodes']} nodes, worst "
          f"{d_inc['worst_node']} {d_inc['node_rel_err']:.3e}, output "
          f"{d_inc['output_rel_err']:.3e}; SqueezeNet {tuple(squeeze_shape)}:"
          f" worst {d_sq['worst_node']} {d_sq['node_rel_err']:.3e}; its "
          f"archive ({d_sq_resume['archive_bytes']} bytes, written in "
          f"{d_sq_resume['write_s']:.2f} s) resumed bit for bit; phase 21 "
          f"launched no TPU kernel and added {wall:.1f} s")
    return dict(resnet=a, resnet_bf16=b, serve=c, inception=d_inc,
                squeezenet=d_sq, squeezenet_resume=d_sq_resume,
                launches=launches, seconds=wall)


# -- phase 22: the conv family, the zoo's Xception, UNet, NASNet, Darknet19
XCEPTION_SHAPE = (299, 299, 3)   # the JAX zoo's defaults
XCEPTION_BATCH = 32
XCEPTION_STEPS = 5       # 22a: timed steps, after one warmup step
XCEPTION_COPY_BATCH = 2  # 22a: the step held against a CPU copy
XCEPTION_BF16_STEPS = 3  # 22b
XCEPTION_BF16_ROWS = 4   # 22b: the first loss held to the CPU's on these
UNET_SHAPE = (512, 512, 3)
UNET_BATCH = 4
UNET_STEPS = 3           # 22d: timed steps, after one warmup step
UNET_COPY_BATCH = 1
NASNET_SHAPE = (224, 224, 3)
NASNET_BATCH = 32
NASNET_STEPS = 3         # 22e
NASNET_COPY_BATCH = 2
DARKNET_SHAPE = (224, 224, 3)
DARKNET_BATCH = 32       # 22f: one warmup and one timed step
DARKNET_COPY_BATCH = 4   # 22f: the step held against a CPU copy
CONV_CLASSES = 1000
CONV_LAYER_TOL = 1e-4    # 22g: each layer's output and gradients, card vs
#                          CPU, over the tensor's max |value| (f32 on both,
#                          TF32 off; sums of up to 162 products in another
#                          order)


def conv_layer_cases():
    """22g: every layer of ``nn/layers/convolutional.py`` (and
    ``FrozenLayer``, re-exported there) with a small feature shape."""
    from deeplearning4j_tpu_torch.nn.layers import convolutional as C
    return [
        ("Convolution1D", C.Convolution1D(n_out=8, kernel=3, stride=2),
         (33, 6)),
        ("Convolution3D", C.Convolution3D(n_out=8, kernel=(3, 3, 3),
                                          stride=(2, 1, 2)), (9, 10, 11, 6)),
        ("Deconvolution2D", C.Deconvolution2D(
            n_out=8, kernel=(3, 3), stride=(2, 2), padding="same"),
         (9, 10, 6)),
        ("DepthwiseConvolution2D", C.DepthwiseConvolution2D(
            depth_multiplier=2, kernel=(3, 3), stride=(2, 2)), (13, 12, 6)),
        ("SeparableConvolution2D", C.SeparableConvolution2D(
            n_out=8, kernel=(5, 5), depth_multiplier=2), (12, 13, 6)),
        ("Subsampling1DLayer", C.Subsampling1DLayer(
            kernel=3, stride=2, padding="same", pooling="avg"), (33, 6)),
        ("Subsampling3DLayer", C.Subsampling3DLayer(
            kernel=(2, 3, 2), stride=(2, 2, 1), padding="same"),
         (9, 10, 11, 6)),
        ("Upsampling1D", C.Upsampling1D(size=3), (11, 6)),
        ("Upsampling3D", C.Upsampling3D(size=(2, 1, 3)), (5, 6, 4, 6)),
        ("Cropping1D", C.Cropping1D(cropping=(2, 3)), (17, 6)),
        ("Cropping2D", C.Cropping2D(cropping=((1, 2), (3, 0))), (12, 11, 6)),
        ("Cropping3D", C.Cropping3D(cropping=1), (6, 7, 8, 6)),
        ("ZeroPadding1DLayer", C.ZeroPadding1DLayer(padding=(2, 1)), (11, 6)),
        ("ZeroPadding3DLayer", C.ZeroPadding3DLayer(
            padding=((1, 0), (0, 2), (1, 1))), (5, 6, 4, 6)),
        ("SpaceToDepthLayer", C.SpaceToDepthLayer(block_size=2), (12, 10, 6)),
        ("DepthToSpaceLayer", C.DepthToSpaceLayer(block_size=2), (6, 5, 24)),
        ("SpaceToBatchLayer", C.SpaceToBatchLayer(
            blocks=(2, 2), padding=((1, 1), (0, 2))), (10, 10, 6)),
        ("PReLULayer", C.PReLULayer(shared_axes=[1, 2]), (12, 11, 6)),
        ("ElementWiseMultiplicationLayer", C.ElementWiseMultiplicationLayer(
            activation="tanh"), (12, 11, 6)),
        ("LocallyConnected2D", C.LocallyConnected2D(
            n_out=8, kernel=(3, 2), stride=(2, 2)), (13, 12, 6)),
        ("LocallyConnected1D", C.LocallyConnected1D(
            n_out=8, kernel=3, stride=2), (33, 6)),
        ("FrozenLayer", C.FrozenLayer(C.Deconvolution2D(
            n_out=8, kernel=(2, 2), stride=(2, 2))), (9, 10, 6)),
    ]


def conv_layers_vs_cpu(device=None, batch=4):
    """Phase 22g: each layer's forward and the gradients of sum(out * c)
    for its input and params on the card, against the same on the
    CPU."""
    import torch
    from deeplearning4j_tpu_torch import random as R
    from deeplearning4j_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    rows = {}
    for name, layer, shape in conv_layer_cases():
        layer.build(shape, {})
        params = layer.init_params(R.PRNGKey(len(rows)))
        gen = torch.Generator().manual_seed(len(rows))
        x = torch.randn((batch,) + shape, generator=gen)
        outs = {}
        for where in (dev, torch.device("cpu")):
            p = {n: t.to(where).requires_grad_(True)
                 for n, t in params.items()}
            xi = x.to(where).requires_grad_(True)
            out, _ = layer.apply(p, xi, {}, True, None)
            ct = torch.randn(out.shape, generator=torch.Generator()
                             .manual_seed(99)).to(where)
            grads = torch.autograd.grad((out * ct).sum(),
                                        [xi] + list(p.values()),
                                        allow_unused=True)
            outs[where.type] = [out] + [g for g in grads if g is not None]
        card, cpu = outs[dev.type], outs["cpu"]
        if len(card) != len(cpu):
            raise AssertionError(f"phase 22g {name}: gradients differ in "
                                 f"number")
        rows[name] = max(_rel(a, b) for a, b in zip(card, cpu))
        if rows[name] > CONV_LAYER_TOL:
            raise AssertionError(f"phase 22g {name} card vs CPU: "
                                 f"{rows[name]:.3e}")
    return rows


def conv_phase(card: str, device=None, xception_shape=XCEPTION_SHAPE,
               xception_batch=XCEPTION_BATCH, unet_shape=UNET_SHAPE,
               unet_batch=UNET_BATCH, nasnet_shape=NASNET_SHAPE,
               nasnet_batch=NASNET_BATCH, nasnet_kw=None,
               darknet_shape=DARKNET_SHAPE, darknet_batch=DARKNET_BATCH,
               classes=CONV_CLASSES, steps=XCEPTION_STEPS):
    """Phase 22: (a) Xception trained at full width, (b) under the bf16
    policy, (c) served; (d) UNet and (e) NASNet trained, (f) a Darknet19
    step, each held against a CPU copy; (g) every conv-family layer on
    the card against the CPU. No TPU kernel is on this path: the launch
    counters must stay 0."""
    import torch
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.learning import Adam
    t_phase = time.perf_counter()
    reset_launches()
    xception = zoo_make("Xception", xception_shape, classes)
    net, a = zoo_train(card, xception, "22a", xception_shape,
                       xception_batch, steps, XCEPTION_COPY_BATCH, classes,
                       profile=True, device=device)
    b = zoo_bf16(card, xception, "22b", xception_shape, xception_batch,
                 XCEPTION_BF16_STEPS, XCEPTION_BF16_ROWS, classes, device)
    c = graph_serve(card, net, xception_shape, label="22c")
    del net
    gc.collect()
    # UNet draws dropout in training, so its CPU copy holds the step's
    # gradients and not the fit that follows; without batch norm its
    # gradient needs no witness draws (2.3e-5 of a leaf's max on an
    # H100, the gate 1e-4). At the zoo's Adam(1e-3) a fresh UNet's summed
    # pixel loss jumps from step to step (2842.7, 2859.3, 2839.0 at
    # 64x64 on the CPU); at 1e-4 it falls every step
    net, d = zoo_train(card, zoo_make("UNet", unet_shape, 1,
                                      updater=Adam(1e-4)), "22d",
                       unet_shape, unet_batch, UNET_STEPS, UNET_COPY_BATCH,
                       1, device=device, apply_step=False, witnesses=0)
    del net
    gc.collect()
    net, e = zoo_train(card, zoo_make("NASNet", nasnet_shape, classes,
                                      **(nasnet_kw or {})), "22e",
                       nasnet_shape, nasnet_batch, NASNET_STEPS,
                       NASNET_COPY_BATCH, classes, device=device)
    del net
    gc.collect()
    net, f = zoo_train(card, zoo_make("Darknet19", darknet_shape, classes),
                       "22f", darknet_shape, darknet_batch, 1,
                       DARKNET_COPY_BATCH, classes, device=device)
    del net
    gc.collect()
    g = conv_layers_vs_cpu(device)
    launches = kernels.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"phase 22 launched a TPU kernel: {launches}")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase

    def held(v):
        return (f"{v['nodes']} nodes on the card's inputs, worst "
                f"{v['worst_node']} {v['node_rel_err']:.3e} (tol "
                f"{GRAPH_NODE_TOL:g}), loss {v['loss_rel_err']:.3e}, "
                f"{v['near_ties']} ReLU near-ties, worst gradient "
                f"{v['worst_grad']} {v['worst_grad_rel_err']:.3e} (the "
                f"CPU's own floor up to {v['grad_floor_max']:.3e}), new "
                f"running stats {v['state_rel_err']:.3e}"
                + ("" if v["param_abs_err"] is None else
                   f", params after the step {v['param_abs_err']:.3e}, "
                   f"Adam {v['adam_worst']} {v['adam_rel_err']:.3e}")
                + f"; CPU {v['cpu_s']:.1f} s")

    def trained(r, what):
        return (f"{what} {tuple(r['input'])} x {r['classes']} "
                f"({r['params']} params, {r['layers']} layers) at batch "
                f"{r['batch']}, f32: step p50 {r['step_p50_ms']:.3f} ms "
                f"(bound {r['bound_ms']:.3f} ms at the f32 rate), queued "
                f"in p50 {r['enqueue_p50_ms']:.3f} ms, "
                f"{r['images_per_s']:.1f} images/s, peak {r['peak_bytes']} "
                f"bytes, loss {[round(l, 4) for l in r['losses']]}, "
                f"{r['stats_moved']} running stats moved, init "
                f"{r['init_s']:.1f} s")
    p = a["profile"]
    print(f"conv (phase 22a) [{card}]: " + trained(a, "Xception"))
    if p is not None:
        print(f"conv (phase 22a) profile [{card}] (one step): device busy "
              f"{p['busy_share']:.3f} of {p['wall_ms']:.1f} ms, "
              f"{p['device_kernels']} device kernels, "
              f"{p['conv_ms']:.1f} ms in cuDNN's convolutions, "
              f"{p['layout_ms']:.1f} ms in layout copies; top (ms): "
              + ", ".join(f"{n[:50]} {t:.3f}" for n, t in p["top"][:6]))
    print(f"conv (phase 22a) vs CPU [{card}]: batch "
          f"{a['vs_cpu']['batch']}: " + held(a["vs_cpu"]))
    print(f"conv (phase 22b) [{card}]: Xception under the bf16 policy at "
          f"batch {b['batch']}: step p50 {b['step_p50_ms']:.3f} ms (bound "
          f"{b['bound_ms']:.3f} ms at the bf16 rate), "
          f"{b['images_per_s']:.1f} images/s beside f32's "
          f"{a['images_per_s']:.1f}, loss "
          f"{[round(l, 4) for l in b['losses']]}, the first {b['rows']} "
          f"rows' loss vs CPU {b['loss_rel_err']:.3e} (tol "
          f"{TRAIN_BF16_LOSS_RTOL:g})")
    print(f"conv (phase 22c) [{card}]: Xception's logits behind "
          f"InferenceEngine and the micro-batcher: buckets {c['buckets']} "
          f"captured in {c['warmup_s']:.1f} s ({c['compiles']} compiles, "
          f"{c['captures']} captures, none after), {c['rows']} rows in "
          f"{c['requests']} requests at {c['rows_per_s']:.1f} rows/s, "
          f"request p50/p99 {c['request_p50_ms']:.1f}/"
          f"{c['request_p99_ms']:.1f} ms, rows vs output() "
          f"{c['max_rel_err']:.3e} of the row's max |logit| (tol "
          f"{GRAPH_SERVE_TOL:g}); after set_params and set_net_state: "
          f"{c['swap_captures']} captures again, rows vs the new output() "
          f"{c['swap_rel_err']:.3e}")
    print(f"conv (phase 22d) [{card}]: " + trained(d, "UNet") + "; vs CPU "
          f"at batch {d['vs_cpu']['batch']}: " + held(d["vs_cpu"]))
    print(f"conv (phase 22e) [{card}]: " + trained(e, "NASNet") + "; vs "
          f"CPU at batch {e['vs_cpu']['batch']}: " + held(e["vs_cpu"]))
    print(f"conv (phase 22f) [{card}]: " + trained(f, "Darknet19")
          + f"; vs CPU at batch {f['vs_cpu']['batch']}: " + held(f["vs_cpu"]))
    print(f"conv (phase 22g) [{card}]: {len(g)} layers, forward and "
          f"gradients vs CPU, worst "
          f"{max(g, key=g.get)} {max(g.values()):.3e} (tol "
          f"{CONV_LAYER_TOL:g}); phase 22 launched no TPU kernel and added "
          f"{wall:.1f} s")
    return dict(xception=a, xception_bf16=b, serve=c, unet=d, nasnet=e,
                darknet19=f, layers=g, launches=launches, seconds=wall)


# -- phase 23: layerwise pretraining, the specialized heads, the detectors
YOLO2_SHAPE = (608, 608, 3)      # the JAX zoo's defaults: COCO's 80 classes,
YOLO2_CLASSES = 80               # 5 anchors, a 19x19x425 map
YOLO2_BATCH = 16
YOLO2_STEPS = 5          # 23a: timed steps, after one warmup step
YOLO2_COPY_BATCH = 1     # 23a: the step held against a CPU copy
DETECT_GRAD_TOL = 1e-3   # 23a, 23d: each gradient leaf and Adam's m, card vs
#                          CPU copy, over its max |value| (GRAPH_GRAD_TOL's
#                          rule otherwise). The first convolution's weight
#                          gradient sums 608^2 = 369,664 (YOLO2) or 416^2 =
#                          173,056 (TinyYOLO) positions an element against
#                          ResNet-50's stem's 112^2 = 12,544 (21a: 3.4e-5),
#                          behind batch norm, whose backward zeroes each
#                          channel's sum, so the terms cancel; cuDNN's
#                          weight-gradient kernels sum in a run-dependent
#                          order. Read on an H100: YOLO2 1.1e-4 to 3.2e-4
#                          over four runs, TinyYOLO 8.9e-5 to 1.08e-4 over
#                          three (1.08e-4 failed GRAPH_GRAD_TOL); the CPU's
#                          own floor 6e-6 to 9e-6
YOLO2_BF16_STEPS = 3     # 23b
YOLO2_BF16_ROWS = 1      # 23b: the first loss held to the CPU's on these
TINYYOLO_SHAPE = (416, 416, 3)   # the JAX zoo's defaults: VOC's 20 classes,
TINYYOLO_CLASSES = 20            # a 13x13x125 map
TINYYOLO_BATCH = 32
TINYYOLO_STEPS = 3       # 23d: timed steps, after one warmup step
TINYYOLO_COPY_BATCH = 2
YOLO_OBJECTS = (1, 6)    # objects an image in the seeded labels
YOLO_LR = 1e-5           # 23a/b/d's Adam: at the zoo's Adam(1e-3) a fresh
#                          detector's first step throws its loss up (YOLO2
#                          at 128x128 on the CPU: 130.3, 2582.5, 74.6, 70.0,
#                          65.1, 62.5; exp(wh) of the object cells); at 1e-5
#                          it falls every step (130.3, 34.1, 27.1, 26.7,
#                          23.6, 22.6; TinyYOLO 304.0 to 23.7)
DETECT_BUCKETS = (1, 2, 4, 8, 16)   # 23c: every power-of-two bucket up to
#                                     the training batch, captured at warmup
DETECT_REQUESTS = 32
DETECT_CLIENTS = 8
DETECT_SERVE_TOL = 1e-4  # 23c: served maps against eager output() of the
#                          request alone, each image over its max |value|
#                          (f32). cuDNN picks its algorithm per batch size,
#                          and the served request ran inside a padded bucket:
#                          on an H100 the same image's eager maps move by
#                          2.2e-5 from one batch size to another (printed as
#                          eager_batch_gap), where 21c read 1.1e-6 on ResNet-
#                          50's logits. A bucket served and the same batch
#                          eager must agree bit for bit
DETECT_NMS_IOU = 0.45    # 23c: the NMS of objdetect.non_max_suppression's
DETECT_NMS_TOP = 0.05    # default, over each image's top 5% of boxes by
#                          objectness (a fresh head scores no class at 0.5)
DIGITS_BATCH = 128       # 23e: the 1,437 train scans in 12 batches
PRETRAIN_EPOCHS = 10     # 23e: pretraining passes a pretrainable layer
FIT_EPOCHS = 10          # 23e: supervised passes after it
VAE_LATENT = 32          # 23e: DL4J's VaeMNISTAnomaly example's widths
VAE_WIDTHS = (256, 256)
PRETRAIN_LOSS_RTOL = 1e-4  # 23e: every batch's pretraining loss and the
#                            first fit epoch's, card vs CPU copy (f32 GEMMs
#                            over 64-256 terms in another order, the VAE's
#                            noise the same bits)
PRETRAIN_PARAM_TOL = 1e-4  # 23e: every param after a pretrainable layer's
#                            first epoch and after the first fit epoch, card
#                            vs CPU copy, over the leaf's max |value|. Later
#                            epochs are printed, not held: the graph's VAE on
#                            raw pixels is chaotic. On the CPU alone a 1e-7
#                            relative move of its initial params grows to
#                            8.2e-2 of e1_b's max after 120 pretraining steps,
#                            as card vs CPU did (8.0e-2; 1.2e-5 after 24
#                            steps), while its losses stay within 3.4e-5
NEW_LAYER_TOL = 1e-4     # 23f: each layer's output (or loss) and gradients,
#                          card vs CPU, over the tensor's max |value| (22g's)


def yolo_batch(n, seed, shape, classes, anchors=5, stride=32,
               objects=YOLO_OBJECTS):
    """Images and YOLO labels from a seed: 1-6 objects an image, each in
    one cell and one anchor of the stride-32 grid, xy in (0, 1), wh > 0
    (grid cells), a one-hot class and confidence 1. Detection accuracy
    needs real images (VOC, COCO); these train the path, not a
    detector."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, *shape).astype(np.float32)
    gh, gw = shape[0] // stride, shape[1] // stride
    y = np.zeros((n, gh, gw, anchors * (5 + classes)), np.float32)
    for b in range(n):
        for _ in range(rs.randint(objects[0], objects[1] + 1)):
            i, j, a = rs.randint(gh), rs.randint(gw), rs.randint(anchors)
            s = a * (5 + classes)
            y[b, i, j, s:s + 2] = rs.uniform(0.05, 0.95, 2)
            y[b, i, j, s + 2:s + 4] = rs.uniform(0.5, 6.0, 2)
            y[b, i, j, s + 4] = 1.0
            y[b, i, j, s + 5 + rs.randint(classes)] = 1.0
    return x, y


def decode_detections(maps, n_anchors: int):
    """Host decode of activated YOLO maps [B, H, W, A * (5 + C)]: per
    image the [H*W*A, 4] (x, y, w, h) boxes in image units and each
    box's objectness."""
    B, H, W, F = maps.shape
    z = np.asarray(maps, np.float64).reshape(B, H, W, n_anchors,
                                             F // n_anchors)
    gx = np.arange(W)[None, None, :, None]
    gy = np.arange(H)[None, :, None, None]
    boxes = np.stack([(gx + z[..., 0]) / W, (gy + z[..., 1]) / H,
                      z[..., 2] / W, z[..., 3] / H], -1)
    return boxes.reshape(B, -1, 4), z[..., 4].reshape(B, -1)


def detections(maps, n_anchors: int, thresholds=None):
    """NMS (``objdetect.non_max_suppression``, IoU DETECT_NMS_IOU) of each
    image's boxes scoring at least its threshold (by default the top
    DETECT_NMS_TOP of that image's objectness). Returns the kept (boxes,
    scores) an image and the thresholds."""
    from deeplearning4j_tpu_torch.nn.layers.objdetect import \
        non_max_suppression
    boxes, scores = decode_detections(maps, n_anchors)
    if thresholds is None:
        thresholds = [float(np.quantile(s, 1.0 - DETECT_NMS_TOP))
                      for s in scores]
    return [non_max_suppression(b, s, DETECT_NMS_IOU, t)
            for b, s, t in zip(boxes, scores, thresholds)], thresholds


def detect_serve(card: str, net, shape, buckets=DETECT_BUCKETS,
                 n_requests=DETECT_REQUESTS, clients=DETECT_CLIENTS):
    """Phase 23c: the trained YOLO2 behind InferenceEngine and the
    micro-batcher: every bucket captured at warmup and none after; each
    request's detection maps against eager ``output()`` of that request
    alone; then each bucket's served maps against eager ``output()`` of
    the same batch (bit for bit), and host NMS of both at the eager
    maps' thresholds."""
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    from deeplearning4j_tpu_torch.serving.batcher import MicroBatcher
    t_phase = time.perf_counter()
    A = net.conf.nodes[net.conf.graph_outputs[0]].layer.n_anchors
    eng = InferenceEngine(net, max_batch_size=max(buckets))
    t0 = time.perf_counter()
    eng.warmup(list(buckets))
    warm_s = time.perf_counter() - t0
    compiles, captures = eng.metrics.compiles, eng.captures
    rs = np.random.RandomState(2323)
    sizes = rs.randint(1, 5, n_requests)
    xs = [rs.rand(int(k), *shape).astype(np.float32) for k in sizes]
    batcher = MicroBatcher(eng, max_batch_size=max(buckets),
                           max_latency_ms=5.0)
    outs, lat = [None] * n_requests, [None] * n_requests
    lock = threading.Lock()
    nxt = [0]

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= n_requests:
                return
            t = time.perf_counter()
            outs[i] = batcher.submit(xs[i])
            lat[i] = (time.perf_counter() - t) * 1e3
    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    batcher.stop()

    def image_err(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        den = np.maximum(np.abs(want).reshape(len(want), -1).max(-1), 1e-30)
        return float((np.abs(got - want).reshape(len(want), -1).max(-1)
                      / den).max())
    worst = max(image_err(ob, net.output(xb).float().cpu().numpy())
                for xb, ob in zip(xs, outs))
    after_traffic = (eng.metrics.compiles, eng.captures)
    # NMS of the served maps against NMS of the eager maps, each bucket's
    # batch at the eager maps' thresholds; and the eager maps of one image
    # by the batch it is in
    big = np.concatenate(xs)
    alone = net.output(big[:1]).float().cpu().numpy()
    nms, batch_gap = {}, 0.0
    for b in buckets:
        served = eng.predict(big[:b])
        eager = net.output(big[:b]).float().cpu().numpy()
        want, thr = detections(eager, A)
        got, _ = detections(served, A, thr)
        same = all(np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
                   for g, w in zip(got, want))
        nms[b] = dict(kept=[len(w[1]) for w in want], equal=same,
                      bits_equal=bool(np.array_equal(served, eager)),
                      err=image_err(served, eager))
        batch_gap = max(batch_gap, image_err(eager[:1], alone))
    rows = int(sizes.sum())
    res = dict(buckets=list(buckets), warmup_s=warm_s, compiles=compiles,
               captures=captures, requests=n_requests, rows=rows,
               rows_per_s=rows / wall,
               request_p50_ms=float(np.percentile(lat, 50)),
               request_p99_ms=float(np.percentile(lat, 99)),
               max_rel_err=worst, eager_batch_gap=batch_gap, nms=nms,
               seconds=time.perf_counter() - t_phase)
    caps = len(buckets) if eng.device.type == "cuda" else 0
    if not (after_traffic == (compiles, captures) == (len(buckets), caps)
            and worst <= DETECT_SERVE_TOL
            and all(v["equal"] and v["bits_equal"] for v in nms.values())
            and eng.metrics.compiles == compiles and eng.captures == caps):
        raise AssertionError(f"phase 23c failed: {res}, compiles now "
                             f"{eng.metrics.compiles}, captures now "
                             f"{eng.captures}")
    return res


def digits_8x8(train: bool):
    """The vendored real digits (checksums verified) as their 8x8 scans:
    [n, 64] features in [0, 1] and one-hot labels."""
    from deeplearning4j_tpu_torch.datasets import _load_real_digits
    imgs, labels = _load_real_digits(train)
    x = imgs[:, 2:26:3, 2:26:3].reshape(len(imgs), 64).astype(np.float32)
    return x / 255.0, np.eye(10, dtype=np.float32)[labels]


def stacked_pretrain_conf(seed=23):
    """23e's stack: a denoising AutoEncoder (sparsity on) over the 64
    pixels, a VAE of VaeMNISTAnomaly's widths over its code, a softmax
    head."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (AutoEncoder,
                                                    OutputLayer,
                                                    VariationalAutoencoder)
    return (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-3))
            .weight_init("xavier").list()
            .layer(AutoEncoder(n_out=48, corruption_level=0.2, sparsity=0.05,
                               sparsity_target=0.1))
            .layer(VariationalAutoencoder(
                n_out=VAE_LATENT, encoder_layer_sizes=VAE_WIDTHS,
                decoder_layer_sizes=VAE_WIDTHS, activation="leakyrelu",
                reconstruction_distribution="bernoulli"))
            .layer(OutputLayer(n_out=10, loss="mcxent"))
            .input_type_feed_forward(64).build())


def vae_graph_conf(seed=24):
    """23e's graph: VaeMNISTAnomaly's VAE on the 64 pixels, a softmax head
    over its latent mean."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import InputType
    from deeplearning4j_tpu_torch.nn.layers import (OutputLayer,
                                                    VariationalAutoencoder)
    return (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-3))
            .weight_init("xavier").graph_builder()
            .add_inputs("in")
            .set_input_types(InputType.feed_forward(64))
            .add_layer("vae", VariationalAutoencoder(
                n_out=VAE_LATENT, encoder_layer_sizes=VAE_WIDTHS,
                decoder_layer_sizes=VAE_WIDTHS, activation="leakyrelu",
                reconstruction_distribution="bernoulli"), "in")
            .add_layer("out", OutputLayer(n_out=10, loss="mcxent"), "vae")
            .set_outputs("out").build())


def _recording_losses(net, epoch: int):
    """Wrap each pretrainable layer's ``pretrain_loss`` of ``net`` to
    record every batch's loss (on the host) and the layer's params after
    its first ``epoch`` batches; returns one dict a pretrainable layer,
    in the network's order."""
    out = []
    layers = (net.layers if hasattr(net, "layers") else
              [net.conf.nodes[n].layer for n in net._order
               if net.conf.nodes[n].layer is not None])
    for layer in layers:
        if layer.is_pretrain_layer:
            mine = dict(losses=[], epoch=None)

            def rec(p, x, rng, _f=layer.pretrain_loss, _out=mine):
                if len(_out["losses"]) == epoch:
                    _out["epoch"] = {n: _host(t) for n, t in p.items()}
                loss = _f(p, x, rng)
                _out["losses"].append(float(loss.detach()))
                return loss
            layer.pretrain_loss = rec
            out.append(mine)
    return out


def _fit_losses(net, data, epochs):
    """``fit`` over ``data`` batch by batch for ``epochs`` passes; each
    batch's loss."""
    out = []
    for _ in range(epochs):
        for x, y in data:
            net.fit(x, y)
            out.append(net.score_)
    return out


def _host_tree(tree):
    return {k: {n: _host(v) for n, v in p.items()} for k, p in tree.items()}


def pretrain_vs_cpu(card, make_net, label, data, pretrain):
    """A fresh network on the card and its CPU copy (same params, fresh
    updater state and key chain), pretrained by ``pretrain(net)``: every
    batch's pretraining loss, and every param after the first epoch of
    each pretrainable layer, card against CPU. The CPU copy then takes
    the card's params, layer state, Adam state and key, and both fit
    FIT_EPOCHS passes over ``data``: the first epoch's losses and the
    params after it, card against CPU. The later gaps are printed, not
    held: the training is chaotic (PRETRAIN_PARAM_TOL)."""
    t0 = time.perf_counter()
    net = make_net()
    cpu = net.clone(device="cpu")
    sides = {}
    for where, m in (("card", net), ("cpu", cpu)):
        losses = _recording_losses(m, len(data))
        t = time.perf_counter()
        pretrain(m)
        sides[where] = dict(losses=losses, pre_s=time.perf_counter() - t,
                            pretrained=_host_tree(m.params()))
    # the fit from the card's pretrained state on both sides
    cpu.set_params(net.params())
    cpu.set_net_state(net.get_net_state())
    cpu.set_updater_state(net.get_updater_state())
    cpu._rng = net._rng
    for where, m in (("card", net), ("cpu", cpu)):
        t = time.perf_counter()
        sides[where]["fit"] = _fit_losses(m, data, 1)
        sides[where]["epoch1"] = _host_tree(m.params())
        sides[where]["fit"] += _fit_losses(m, data, FIT_EPOCHS - 1)
        sides[where]["fit_s"] = time.perf_counter() - t
    c, h = sides["card"], sides["cpu"]

    def gap(a, b):
        return max((abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b)),
                   default=0.0)
    pre_losses = [v for lst in c["losses"] for v in lst["losses"]]
    cpu_pre_losses = [v for lst in h["losses"] for v in lst["losses"]]
    n = len(data)
    res = dict(
        pretrain_batches=[len(lst["losses"]) for lst in c["losses"]],
        fit_batches=len(c["fit"]),
        pretrain_losses=[[lst["losses"][0], lst["losses"][-1]]
                         for lst in c["losses"]],
        fit_losses=[c["fit"][0], c["fit"][-1]],
        pretrain_loss_rel_err=gap(pre_losses, cpu_pre_losses),
        pretrain_epoch_param=_worst(
            {i: a["epoch"] for i, a in enumerate(c["losses"])},
            {i: b["epoch"] for i, b in enumerate(h["losses"])}),
        pretrained_param=_worst(c["pretrained"], h["pretrained"]),
        fit_epoch_loss_rel_err=gap(c["fit"][:n], h["fit"][:n]),
        fit_epoch_param=_worst(c["epoch1"], h["epoch1"]),
        fit_loss_rel_err=gap(c["fit"], h["fit"]),
        fitted_param=_worst(_host_tree(net.params()),
                            _host_tree(cpu.params())),
        card_pretrain_s=c["pre_s"], cpu_pretrain_s=h["pre_s"],
        card_fit_s=c["fit_s"], seconds=time.perf_counter() - t0)
    if not (len(pre_losses) == len(cpu_pre_losses) > 0
            and all(lst["losses"][-1] < lst["losses"][0]
                    for lst in c["losses"])
            and c["fit"][-1] < c["fit"][0]
            and res["pretrain_loss_rel_err"] <= PRETRAIN_LOSS_RTOL
            and res["pretrain_epoch_param"][1] <= PRETRAIN_PARAM_TOL
            and res["fit_epoch_loss_rel_err"] <= PRETRAIN_LOSS_RTOL
            and res["fit_epoch_param"][1] <= PRETRAIN_PARAM_TOL):
        raise AssertionError(f"phase {label} card vs CPU failed: {res}")
    return net, res


def digits_pretraining(card, device=None):
    """Phase 23e: the stacked AutoEncoder -> VAE -> softmax network
    pretrained layer by layer and fitted on the real digits, a VAE node
    of a ComputationGraph pretrained the same way, each against a CPU
    copy batch by batch; then the graph's VAE scores uniform noise as
    less likely than the test digits (reconstruction error)."""
    import torch
    from deeplearning4j_tpu_torch.nn import (ComputationGraph,
                                             MultiLayerNetwork)
    xtr, ytr = digits_8x8(True)
    xte, yte = digits_8x8(False)
    data = [(xtr[i:i + DIGITS_BATCH], ytr[i:i + DIGITS_BATCH])
            for i in range(0, len(xtr), DIGITS_BATCH)]
    stack, s = pretrain_vs_cpu(
        card, lambda: MultiLayerNetwork(stacked_pretrain_conf(),
                                        device=device).init(),
        "23e stack", data, lambda m: m.pretrain(data, PRETRAIN_EPOCHS))
    acc = float((stack.output(xte).argmax(-1).cpu().numpy()
                 == yte.argmax(-1)).mean())
    graph, g = pretrain_vs_cpu(
        card, lambda: ComputationGraph(vae_graph_conf(),
                                       device=device).init(),
        "23e graph", data,
        lambda m: m.pretrain_node("vae", data, PRETRAIN_EPOCHS))
    vae = graph.conf.nodes["vae"].layer
    p = graph.params()["vae"]
    noise = np.random.RandomState(2324).rand(len(xte), 64).astype(np.float32)

    def recon_error(x):
        with torch.no_grad():
            t = torch.from_numpy(x).to(graph.device)
            return float(((vae.reconstruct(p, t) - t) ** 2).mean())
    e_digits, e_noise = recon_error(xte), recon_error(noise)
    res = dict(stack=s, stack_test_accuracy=acc, graph=g,
               recon_error_digits=e_digits, recon_error_noise=e_noise)
    if not e_noise > e_digits:
        raise AssertionError(f"phase 23e: noise reconstructs as well as "
                             f"digits: {res}")
    return res


def new_layer_cases():
    """23f: every layer class of ``misc.py``, ``variational.py``,
    ``specialized_outputs.py`` and ``objdetect.py`` at a small size:
    (name, layer, feature shape, mode, mask), mode "apply", "loss" or
    "pretrain"; the mask forms are CnnLossLayer's."""
    from deeplearning4j_tpu_torch.nn.layers import (
        CenterLossOutputLayer, OCNNOutputLayer, VariationalAutoencoder)
    from deeplearning4j_tpu_torch.nn.layers import misc as M
    from deeplearning4j_tpu_torch.nn.layers.objdetect import \
        Yolo2OutputLayer
    cases = [
        ("AutoEncoder", M.AutoEncoder(n_out=24, sparsity=0.1), (40,),
         "pretrain", None),
        ("AutoEncoder.apply", M.AutoEncoder(n_out=24), (40,), "apply", None),
        ("VariationalAutoencoder", VariationalAutoencoder(
            n_out=8, encoder_layer_sizes=(32, 16), decoder_layer_sizes=(16,),
            reconstruction_distribution="bernoulli", num_samples=2,
            activation="leakyrelu"), (40,), "pretrain", None),
        ("VariationalAutoencoder.gaussian", VariationalAutoencoder(
            n_out=8, encoder_layer_sizes=(32,), decoder_layer_sizes=(16,)),
         (40,), "pretrain", None),
        ("ReshapeLayer", M.ReshapeLayer(target_shape=(-1, 6)), (8, 9),
         "apply", None),
        ("CenterLossOutputLayer", CenterLossOutputLayer(
            n_out=5, alpha=0.5, lambda_=0.1), (24,), "loss", None),
        ("OCNNOutputLayer", OCNNOutputLayer(hidden_size=16, nu=0.1),
         (24,), "loss", None),
        ("OCNNOutputLayer.apply", OCNNOutputLayer(hidden_size=16), (24,),
         "apply", None),
        ("Yolo2OutputLayer", Yolo2OutputLayer(
            anchors=((1.0, 1.5), (2.5, 0.7))), (5, 6, 2 * (5 + 4)), "loss",
         None),
    ]
    for mask in (None, "bhw", "bhw1", "b11"):
        cases.append((f"CnnLossLayer.{mask}", M.CnnLossLayer(
            loss="mcxent", activation="softmax"), (6, 7, 5), "loss", mask))
        cases.append((f"Cnn3DLossLayer.{mask}", M.Cnn3DLossLayer(loss="mse"),
                      (3, 4, 5, 5), "loss", mask))
    return cases


def _case_inputs(name, layer, shape, mode, mask, batch, gen):
    """Labels (and a mask) of a loss case, from ``gen``."""
    import torch
    x = torch.randn((batch,) + shape, generator=gen)
    y = m = None
    if mode == "loss":
        if name.startswith("CnnLoss"):
            y = torch.eye(shape[-1])[torch.randint(
                0, shape[-1], (batch,) + shape[:-1], generator=gen)]
        elif name.startswith("Yolo2"):
            y = torch.from_numpy(yolo_batch(batch, 5, (160, 192, 3), 4,
                                            anchors=2)[1])
        elif name.startswith("CenterLoss"):
            y = torch.eye(layer.n_out)[torch.randint(0, layer.n_out, (batch,),
                                                     generator=gen)]
        else:
            y = torch.rand((batch,) + shape, generator=gen)
        if mask is not None:
            spatial = (batch,) + shape[:-1]
            full = {"bhw": spatial, "bhw1": spatial + (1,),
                    "b11": (batch,) + (1,) * (len(shape) - 1)}[mask]
            m = (torch.rand(full, generator=gen) > 0.3).float()
    elif mode == "pretrain":
        x = torch.rand((batch,) + shape, generator=gen)
    return x, y, m


def new_layers_vs_cpu(device=None, batch=4):
    """Phase 23f: each new layer's output (``apply``), loss
    (``compute_loss``, with each mask form) or pretraining loss (from
    one key) and the gradients for its input and params on the card,
    against the same on the CPU; then a MaskingLayer -> LSTM -> MaskLayer
    network's output and one step's gradients, card against CPU."""
    import torch
    from deeplearning4j_tpu_torch import random as R
    from deeplearning4j_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    rows = {}
    for i, (name, layer, shape, mode, mask) in enumerate(new_layer_cases()):
        layer.build(shape, {"weight_init": "xavier"})
        params = layer.init_params(R.PRNGKey(i))
        gen = torch.Generator().manual_seed(i)
        x, y, m = _case_inputs(name, layer, shape, mode, mask, batch, gen)
        ct = None
        outs = {}
        for where in (dev, torch.device("cpu")):
            p = {n: t.to(where).requires_grad_(True)
                 for n, t in params.items()}
            xi = x.to(where).requires_grad_(True)
            if mode == "apply":
                out, _ = layer.apply(p, xi, {}, False, None)
                if ct is None:
                    ct = torch.randn(out.shape, generator=gen)
                scalar = (out * ct.to(where)).sum()
            elif mode == "loss":
                out = layer.compute_loss(
                    p, xi, y.to(where), None if m is None else m.to(where))
                scalar = out
            else:
                out = layer.pretrain_loss(p, xi, R.PRNGKey(100 + i))
                scalar = out
            grads = torch.autograd.grad(scalar, [xi] + list(p.values()),
                                        allow_unused=True)
            outs[where.type] = [out] + [g for g in grads if g is not None]
        card, cpu = outs[dev.type], outs["cpu"]
        if len(card) != len(cpu):
            raise AssertionError(f"phase 23f {name}: gradients differ in "
                                 f"number")
        rows[name] = max(_rel(a, b) for a, b in zip(card, cpu))
    rows["Masking+MaskLayer network"] = masked_net_vs_cpu(device)
    bad = {k: v for k, v in rows.items() if not v <= NEW_LAYER_TOL}
    if bad:
        raise AssertionError(f"phase 23f card vs CPU: {bad}")
    return rows


def masked_net_vs_cpu(device=None):
    """MaskingLayer (a mask from padded steps) -> LSTM -> dense ->
    MaskLayer -> masked average pooling -> softmax: the output and one
    step's loss and gradients on the card against a CPU copy."""
    import torch
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (DenseLayer,
                                                    GlobalPoolingLayer,
                                                    MaskingLayer, MaskLayer,
                                                    OutputLayer)
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    conf = (NeuralNetConfiguration.builder().seed(23).updater(Adam(1e-2))
            .weight_init("xavier").list()
            .layer(MaskingLayer(mask_value=0.0))
            .layer(LSTM(n_out=32))
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(MaskLayer())
            .layer(GlobalPoolingLayer(pooling="avg"))
            .layer(OutputLayer(n_out=4, loss="mcxent"))
            .input_type_recurrent(8, 20).build())
    net = MultiLayerNetwork(conf, device=device).init()
    cpu = net.clone(device="cpu")
    rs = np.random.RandomState(23)
    x = rs.randn(8, 20, 8).astype(np.float32)
    for b in range(8):
        x[b, 20 - 2 * b:] = 0.0          # 0 to 14 padded steps
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 8)]
    errs = [_rel(net.output(x), cpu.output(x))]
    lc, gc = net.loss_and_gradients(x, y)
    lh, gh = cpu.loss_and_gradients(x, y)
    errs.append(abs(float(lc) - float(lh)) / abs(float(lh)))
    errs += [_rel(gc[k][n], gh[k][n]) for k in gh for n in gh[k]]
    return max(errs)


def detect_phase(card: str, device=None, yolo2_shape=YOLO2_SHAPE,
                 yolo2_batch=YOLO2_BATCH, yolo2_classes=YOLO2_CLASSES,
                 tiny_shape=TINYYOLO_SHAPE, tiny_batch=TINYYOLO_BATCH,
                 tiny_classes=TINYYOLO_CLASSES, steps=YOLO2_STEPS,
                 buckets=DETECT_BUCKETS):
    """Phase 23: (a) the zoo's YOLO2 trained at full width on seeded
    labels, (b) under the bf16 policy, (c) served, with host NMS; (d)
    TinyYOLO trained; each held against a CPU copy; (e) layerwise
    pretraining on the real digits (a stacked network and a graph's VAE
    node) against CPU copies, and the VAE's anomaly check; (f) every new
    layer class on the card against the CPU. Each part prints as it
    ends. No TPU kernel is on this path: the launch counters must stay
    0."""
    import torch
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.learning import Adam
    t_phase = time.perf_counter()
    reset_launches()

    def yolo_labels(n, seed, shape, classes):
        return yolo_batch(n, seed, shape, classes)

    def held(v):
        return (f"{v['nodes']} nodes on the card's inputs, worst "
                f"{v['worst_node']} {v['node_rel_err']:.3e} (tol "
                f"{GRAPH_NODE_TOL:g}), loss {v['loss_rel_err']:.3e}, worst "
                f"gradient {v['worst_grad']} {v['worst_grad_rel_err']:.3e} "
                f"(the CPU's own floor up to {v['grad_floor_max']:.3e}), new "
                f"running stats {v['state_rel_err']:.3e}, params after the "
                f"step {v['param_abs_err']:.3e}, Adam {v['adam_worst']} "
                f"{v['adam_rel_err']:.3e}; CPU {v['cpu_s']:.1f} s")

    def trained(r, what):
        return (f"{what} {tuple(r['input'])} x {r['classes']} classes "
                f"({r['params']} params, {r['layers']} layers) at batch "
                f"{r['batch']}, f32: step p50 {r['step_p50_ms']:.3f} ms "
                f"(bound {r['bound_ms']:.3f} ms at the f32 rate, share "
                f"{r['bound_ms'] / r['step_p50_ms']:.3f}), queued in p50 "
                f"{r['enqueue_p50_ms']:.3f} ms, {r['images_per_s']:.1f} "
                f"images/s, peak {r['peak_bytes']} bytes, loss "
                f"{[round(l, 4) for l in r['losses']]}, {r['stats_moved']} "
                f"running stats moved; init {r['init_s']:.1f} s, steps "
                f"{r['train_s']:.1f} s, profile {r['profile_s']:.1f} s, CPU "
                f"copy {r['copy_s']:.1f} s, {r['seconds']:.1f} s in all")
    yolo2 = zoo_make("YOLO2", yolo2_shape, yolo2_classes, seed=23,
                     updater=Adam(YOLO_LR))
    net, a = zoo_train(card, yolo2, "23a", yolo2_shape, yolo2_batch, steps,
                       YOLO2_COPY_BATCH, yolo2_classes, profile=True,
                       device=device, seed=23, batch_fn=yolo_labels,
                       grad_tol=DETECT_GRAD_TOL)
    p = a["profile"]
    print(f"detect (phase 23a) [{card}]: " + trained(a, "YOLO2"), flush=True)
    if p is not None:
        print(f"detect (phase 23a) profile [{card}] (one step): device busy "
              f"{p['busy_share']:.3f} of {p['wall_ms']:.1f} ms, "
              f"{p['device_kernels']} device kernels, "
              f"{p['conv_ms']:.1f} ms in cuDNN's convolutions, "
              f"{p['layout_ms']:.1f} ms in layout copies; top (ms): "
              + ", ".join(f"{n[:50]} {t:.3f}" for n, t in p["top"][:6]))
    print(f"detect (phase 23a) vs CPU [{card}]: batch "
          f"{a['vs_cpu']['batch']}: " + held(a["vs_cpu"])
          + f" (gradient tol {DETECT_GRAD_TOL:g})", flush=True)
    b = zoo_bf16(card, yolo2, "23b", yolo2_shape, yolo2_batch,
                 YOLO2_BF16_STEPS, YOLO2_BF16_ROWS, yolo2_classes, device,
                 seed=23, batch_fn=yolo_labels)
    print(f"detect (phase 23b) [{card}]: YOLO2 under the bf16 policy at "
          f"batch {b['batch']}: step p50 {b['step_p50_ms']:.3f} ms (bound "
          f"{b['bound_ms']:.3f} ms at the bf16 rate), "
          f"{b['images_per_s']:.1f} images/s beside f32's "
          f"{a['images_per_s']:.1f}, loss "
          f"{[round(l, 4) for l in b['losses']]}, the first {b['rows']} "
          f"image's loss vs CPU {b['loss_rel_err']:.3e} (tol "
          f"{TRAIN_BF16_LOSS_RTOL:g}; CPU {b['cpu_s']:.1f} s); "
          f"{b['seconds']:.1f} s", flush=True)
    c = detect_serve(card, net, yolo2_shape, buckets)
    print(f"detect (phase 23c) [{card}]: YOLO2 behind InferenceEngine and "
          f"the micro-batcher: buckets {c['buckets']} captured in "
          f"{c['warmup_s']:.1f} s ({c['compiles']} compiles, "
          f"{c['captures']} captures, none after), {c['rows']} images in "
          f"{c['requests']} requests from {DETECT_CLIENTS} threads at "
          f"{c['rows_per_s']:.1f} images/s, request p50/p99 "
          f"{c['request_p50_ms']:.1f}/{c['request_p99_ms']:.1f} ms, maps vs "
          f"output() of the request alone {c['max_rel_err']:.3e} of the "
          f"image's max (tol {DETECT_SERVE_TOL:g}; one image's eager maps "
          f"move by {c['eager_batch_gap']:.3e} from batch 1 to the buckets); "
          f"each bucket served and the same batch eager bit for bit, and "
          f"their host NMS equal (boxes kept by image: "
          f"{ {k: v['kept'][:4] for k, v in c['nms'].items()} }); "
          f"{c['seconds']:.1f} s", flush=True)
    del net
    gc.collect()
    net, d = zoo_train(card, zoo_make("TinyYOLO", tiny_shape, tiny_classes,
                                      seed=23, updater=Adam(YOLO_LR)),
                       "23d", tiny_shape, tiny_batch, TINYYOLO_STEPS,
                       TINYYOLO_COPY_BATCH, tiny_classes, device=device,
                       seed=23, batch_fn=yolo_labels,
                       grad_tol=DETECT_GRAD_TOL)
    del net
    gc.collect()
    print(f"detect (phase 23d) [{card}]: " + trained(d, "TinyYOLO")
          + f"; vs CPU at batch {d['vs_cpu']['batch']}: " + held(d["vs_cpu"])
          + f" (gradient tol {DETECT_GRAD_TOL:g})", flush=True)
    t0 = time.perf_counter()
    e = digits_pretraining(card, device)
    for tag in ("stack", "graph"):
        r = e[tag]
        print(f"pretraining (phase 23e {tag}) [{card}]: "
              f"{r['pretrain_batches']} pretraining batches a pretrainable "
              f"layer (loss first -> last "
              f"{[[round(v, 4) for v in l] for l in r['pretrain_losses']]})"
              f", then {r['fit_batches']} fit batches (loss "
              f"{r['fit_losses'][0]:.4f} -> {r['fit_losses'][1]:.4f}); card "
              f"vs CPU copy: every pretraining loss "
              f"{r['pretrain_loss_rel_err']:.3e}, params after each layer's "
              f"first epoch {r['pretrain_epoch_param'][0]} "
              f"{r['pretrain_epoch_param'][1]:.3e}, the first fit epoch's "
              f"losses {r['fit_epoch_loss_rel_err']:.3e} and params "
              f"{r['fit_epoch_param'][0]} {r['fit_epoch_param'][1]:.3e} "
              f"(tols {PRETRAIN_LOSS_RTOL:g}, {PRETRAIN_PARAM_TOL:g}); not "
              f"held: params after pretraining {r['pretrained_param'][0]} "
              f"{r['pretrained_param'][1]:.3e}, every fit loss "
              f"{r['fit_loss_rel_err']:.3e}, params after the fit "
              f"{r['fitted_param'][0]} {r['fitted_param'][1]:.3e}; "
              f"pretraining {r['card_pretrain_s']:.2f} s on the card, "
              f"{r['cpu_pretrain_s']:.2f} s on the CPU")
    print(f"pretraining (phase 23e) [{card}]: the stack's test accuracy "
          f"{e['stack_test_accuracy']:.4f} on the 360 test digits; the "
          f"graph's VAE reconstruction error {e['recon_error_digits']:.4f} "
          f"on the test digits vs {e['recon_error_noise']:.4f} on uniform "
          f"noise; {time.perf_counter() - t0:.1f} s", flush=True)
    f = new_layers_vs_cpu(device)
    launches = kernels.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"phase 23 launched a TPU kernel: {launches}")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"new layers (phase 23f) [{card}]: {len(f)} cases, forward (or "
          f"loss) and gradients vs CPU, worst {max(f, key=f.get)} "
          f"{max(f.values()):.3e} (tol {NEW_LAYER_TOL:g}); phase 23 launched "
          f"no TPU kernel (every counter 0) and took {wall:.1f} s")
    return dict(yolo2=a, yolo2_bf16=b, serve=c, tinyyolo=d, pretraining=e,
                layers=f, launches=launches, seconds=wall)


# -- phase 24: data-parallel training ---------------------------------
DP_WORLD = 2             # 24b-24d: rank processes on the one card (gloo)
DP_NAN_ITEM = 3          # 24b: the item (a NaN-label copy of the batch
#                          in rank 1's rows) the guarded runs must skip
DP_TOL = 2e-4            # 24b: the dense gradient at W = 2 (the ranks'
#                          sum) against 24a's at W = 1 from the same
#                          params and global batch, of a leaf's max. Each
#                          rank runs the batch of 2, where the flash
#                          forward picks another key-group split
#                          (key_groups_for, by grid) and cuBLAS other
#                          GEMMs: 8.8e-5 measured on attn_Wk, the
#                          backward kernels' own distance to their plain
#                          versions (up to 8e-5); 0 on the CPU. The
#                          ranks' step is the one-process reference's
#                          bit for bit. After 1 + 5 Adam steps the params
#                          differ by up to ~lr where a last-bit
#                          difference flips a near-zero gradient's sign:
#                          reported, not held.
DP_REF_TOL = 1e-6        # 24b: each step against the one-process
#                          reference where a leaf is not bit for bit
DP_INFER_TOL = 1e-4      # 24d: ParallelInference rows against output()
#                          of the whole batch, of the max: a rank's rows
#                          run at batch 2, output() at 4, and cuBLAS picks
#                          its GEMMs by shape (1.8e-5 measured);
#                          against output() of the rank's own rows: bit
#                          for bit
DP_RES_BATCHES = 6       # 24c: clean batches of one epoch
DP_PREEMPT = 3           # 24c: the step boundary that preempts B
DP_REMESH_TOL = 0.05     # 24c: relative L2 of the W = 1 resume against
#                          the fixed-shape run (docs/distributed.md)
DP_RANK_TIMEOUT_S = 300  # each rank spawn, killed after


def _bits_hash(tree):
    """One int64 a leaf over the leaf's bits (sorted keys): equal hashes
    across ranks say the leaves agree bit for bit."""
    import torch
    out = []
    for _, t in sorted(_leaves(tree)):
        b = t.detach().contiguous().view(torch.int32).reshape(-1) \
            .to(torch.int64)
        w = torch.arange(b.numel(), device=b.device, dtype=torch.int64) \
            * 2654435761 + 97
        out.append(torch.sum(b * w))
    return torch.stack(out).cpu()


def _ranks_agree(pw, tree) -> bool:
    """Whether every rank of the wrapper holds ``tree`` bit for bit."""
    h = _bits_hash(tree)
    tr = pw.mesh.whole()
    if tr is None:
        return True
    rows = tr.all_gather([h])[0]
    return bool((rows == rows[0]).all())


def _uncounted(fn):
    """Run ``fn`` without its kernel launches counting (a comparison, not
    the path)."""
    from deeplearning4j_tpu_torch import kernels
    before = kernels.launch_counts()
    try:
        return fn()
    finally:
        after = kernels.launch_counts()
        kernels.add_launches({k: before.get(k, 0) - n
                              for k, n in after.items()})


def _clone_nested(tree):
    return {k: (_clone_nested(v) if isinstance(v, dict)
                else v.detach().clone()) for k, v in tree.items()}


class DPReference:
    """24b's one-process reference of a W-worker step: each worker's
    rows of the global batch in turn through the network's own loss and
    gradients (the dense step under its global-batch view), clipping,
    the worker's updater (update mode) and the port's plain Strom
    encode, the decoded sum over workers times the f32 ``1 / W``, and
    the update, as the wrapper's steps must compute it on W ranks."""

    def __init__(self, net, pw, world):
        self.net, self.world = net, world
        self.mode = None if pw.accumulator is None else pw.accumulator.mode
        self.params = _clone_nested(net._params)
        self.net_state = _clone_nested(net._net_state)
        self.opt = _clone_nested(net._opt_state)
        acc = pw.accumulator
        if acc is not None:
            self.res = [_clone_nested(acc.residuals)
                        for _ in range(world)]
            self.thr = acc.threshold.clone()
            if self.mode == "update":
                self.opt = [_clone_nested(acc.opt_state)
                            for _ in range(world)]
            self.acc = acc

    def _grads(self, w, x, y, rng):
        from deeplearning4j_tpu_torch.nn import global_batch as G
        from deeplearning4j_tpu_torch.nn.multilayer import _tree_map
        b = x.shape[0] // self.world
        rows = slice(w * b, (w + 1) * b)
        leaves = _tree_map(lambda t: t.detach().requires_grad_(True),
                           self.params)
        view = G.over(w, self.world, _no_reduce) if self.mode is None \
            else contextlib.nullcontext()
        with view:
            loss, grads, _, _ = self.net._grads(
                leaves, self.net_state, x[rows], y[rows], None, True, rng)
        return loss, grads

    def grad_sum(self, x, y):
        """The dense step's gradient at these params: the workers' sum
        (no dropout here), as {leaf: host array}."""
        total = None
        for w in range(self.world):
            _, grads = self._grads(w, x, y, None)
            total = grads if total is None else {
                k: {n: total[k][n] + g for n, g in p.items()}
                for k, p in grads.items()}
        return {k: t.detach().float().cpu().numpy()
                for k, t in _leaves(total)}

    def step(self, x, y, rng, step):
        import torch
        from deeplearning4j_tpu_torch.nn.multilayer import (_clip_grads,
                                                            _finite_ok)
        from deeplearning4j_tpu_torch.parallel import _reciprocal
        from deeplearning4j_tpu_torch.parallel.compression import (
            adapt_threshold, strom_encode_decode, strom_value_encode_decode)
        net, conf = self.net, self.net.conf
        keys = [(k, n) for k in self.params for n in self.params[k]]
        inv = _reciprocal(self.world)
        sums, losses, oks, sparsity, new_res, new_opt = None, [], [], [], \
            [], []
        for w in range(self.world):
            loss, grads = self._grads(w, x, y, rng)
            oks.append(bool(_finite_ok(loss, grads)))
            losses.append(loss)
            if self.mode is None:
                parts = [grads[k][n] for k, n in keys]
            else:
                grads = _clip_grads(grads, conf.max_grad_norm,
                                    conf.grad_clip_value)
                with torch.no_grad():
                    if self.mode == "update":
                        upd, opt_w = {}, {}
                        for i, key in enumerate(net._layer_keys):
                            if key in self.params:
                                opt_w[key], upd[key] = \
                                    net._updaters[i].apply(
                                        _clone_nested(self.opt[w][key]),
                                        grads[key], step)
                        new_opt.append(opt_w)
                        vals, enc_fn = upd, strom_encode_decode
                    else:
                        vals, enc_fn = grads, strom_value_encode_decode
                    enc = [enc_fn(vals[k][n], self.res[w][k][n], self.thr)
                           for k, n in keys]
                parts = [d for d, _ in enc]
                fired = sum(torch.sum(torch.abs(d) > 0) for d in parts)
                total = sum(d.numel() for d in parts)
                sparsity.append(fired.to(torch.float32)
                                * _reciprocal(total))
                r = {k: {} for k in self.params}
                for (k, n), (_, rr) in zip(keys, enc):
                    r[k][n] = rr
                new_res.append(r)
            sums = parts if sums is None else \
                [a + p for a, p in zip(sums, parts)]
        ok = all(oks)
        loss = sum(losses[1:], losses[0])
        with torch.no_grad():
            if self.mode is None:
                g = {k: {} for k in self.params}
                for (k, n), s in zip(keys, sums):
                    g[k][n] = s
                g = _clip_grads(g, conf.max_grad_norm, conf.grad_clip_value)
            else:
                loss = loss * inv
                shared = {k: {} for k in self.params}
                for (k, n), s in zip(keys, sums):
                    shared[k][n] = s * inv
                sp = sum(sparsity[1:], sparsity[0]) * inv
            if not ok:
                return loss, False      # a skip: nothing moves
            if self.mode == "update":
                for k, n in keys:
                    self.params[k][n] = self.params[k][n] - shared[k][n]
                self.opt, self.res = new_opt, new_res
            else:
                src = g if self.mode is None else shared
                for i, key in enumerate(net._layer_keys):
                    if key not in self.params:
                        continue
                    self.opt[key], u = net._updaters[i].apply(
                        _clone_nested(self.opt[key]), src[key], step)
                    for n in self.params[key]:
                        self.params[key][n] = self.params[key][n] - u[n]
                if self.mode == "gradient":
                    self.res = new_res
            if self.mode is not None and self.acc.adaptive:
                a = self.acc
                self.thr = adapt_threshold(self.thr, sp, a.min_sparsity,
                                           a.max_sparsity, a.adapt_factor)
        return loss, True


def _no_reduce(t):
    raise AssertionError("phase 24's reference network has no batch "
                         "statistic to reduce")


def _leaf_gaps(got, ref) -> dict:
    """{"differ": leaves not bit for bit, "worst": the leaf with the
    largest error over its max |value|, "worst_err": that error} of two
    trees of the same layout, computed on their device."""
    ref_leaves = dict(_leaves(ref))
    worst, worst_err, differ = None, 0.0, 0
    for key, t in _leaves(got):
        r = ref_leaves[key].to(t.device)
        if t.equal(r):
            continue
        differ += 1
        err = float((t.double() - r.double()).abs().max()) / max(
            float(r.abs().max()), 1e-30)
        if worst is None or err > worst_err:
            worst, worst_err = key, err
    return {"differ": differ, "worst": worst, "worst_err": worst_err}


def dp_guarded_run(pw, net, x, y, steps, reference=None):
    """24b's guarded run of ``pw``'s step over ``1 + steps`` clean items
    with a NaN-label copy (rank 1's rows) before clean item DP_NAN_ITEM,
    committing as the resilient trainer's supervisor does (a skip keeps
    the step counter and the key chain). Checks every rank's params
    agree bit for bit after every item; with ``reference`` (rank 0),
    each item against it. Returns the run's numbers."""
    import torch
    from deeplearning4j_tpu_torch import random as R
    from deeplearning4j_tpu_torch.nn.multilayer import _as_leaves
    step = pw.ensure_step(guard=True)
    acc = pw.accumulator
    on_card = net.device.type == "cuda"
    bad_y = y.clone()
    half = y.shape[0] // DP_WORLD
    bad_y[half:] = float("nan")
    items = [y] * (1 + steps)
    items.insert(DP_NAN_ITEM, bad_y)
    losses, oks, ms, agree, ref_gaps, skip = [], [], [], [], [], {}
    # the step's own collectives (the barriers and checks use the same
    # process group): ms a timed item, and calls and bytes over all
    coll_ms, coll_calls, coll_bytes = [], 0, 0
    for i, yb in enumerate(items):
        rng_before = net._rng
        keys = R.split(net._rng)
        net._rng, sub = R.key_at(keys, 0), R.key_at(keys, 1)
        res_before = None if acc is None else _bits_hash(acc.residuals)
        params_before = _bits_hash(net._params)
        if on_card:
            torch.cuda.synchronize()
        # the ranks start each item together (rank 0's reference ran
        # outside the window)
        pw.agree_any([False])
        c0 = pw.collective_stats()
        t0 = time.perf_counter()
        params, opt, nst, loss, ok = step(net._params, net._opt_state,
                                          net._net_state, net._step, x, yb,
                                          None, sub)
        net._params = _as_leaves(params)
        net._opt_state, net._net_state = opt, nst
        ok = bool(ok)
        if on_card:
            torch.cuda.synchronize()
        c1 = pw.collective_stats()
        coll_calls += c1["calls"] - c0["calls"]
        coll_bytes += c1["bytes"] - c0["bytes"]
        if yb is not bad_y and i > 0:
            ms.append((time.perf_counter() - t0) * 1e3)
            coll_ms.append((c1["seconds"] - c0["seconds"]) * 1e3)
        ref_step = net._step
        if ok:
            net._step += 1
        else:
            net._rng = rng_before
            skip = dict(
                ok=ok,
                params_kept=bool(torch.equal(params_before,
                                             _bits_hash(net._params))),
                residual_kept=None if acc is None else bool(torch.equal(
                    res_before, _bits_hash(acc.residuals))))
        oks.append(ok)
        losses.append(float(loss))
        agree.append(_ranks_agree(pw, net._params))
        if reference is not None:
            rl, rok = _uncounted(lambda: reference.step(x, yb, sub,
                                                        ref_step))
            gap = _leaf_gaps(net._params, reference.params)
            if acc is not None:
                r = reference.res[pw.worker_index]
                gap["residual"] = _leaf_gaps(acc.residuals, r)
                gap["threshold_equal"] = bool(torch.equal(
                    acc.threshold, reference.thr))
            gap.update(ok=rok, loss=float(rl), loss_equal=(
                rok and float(rl) == float(loss)) or not rok)
            ref_gaps.append(gap)
    return dict(losses=losses, oks=oks, step_ms=ms,
                step_p50_ms=float(np.median(ms)), agree=agree, skip=skip,
                reference=ref_gaps, collective_step_ms=coll_ms,
                collective_p50_ms=float(np.median(coll_ms)),
                collective_calls=coll_calls,
                collective_bytes=coll_bytes // max(coll_calls, 1))


def dp_rank_24b(job, rank):
    """A rank of 24b (dense, update and gradient modes at W = 2, guard
    on, each against the one-process reference on rank 0) and 24d
    (ParallelInference)."""
    import torch
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import (
        GradientSharingAccumulator, ParallelInference, ParallelWrapper)
    cfg, steps, device = job["cfg"], job["steps"], job["device"]
    out = {}
    local = dict(cfg, batch=cfg["batch"] // DP_WORLD)
    for mode in ("dense", "update", "gradient"):
        net = MultiLayerNetwork(train_conf(cfg), device=device).init()
        dev = net.device
        on_card = dev.type == "cuda"
        x, y = recurrence_batch(cfg, cfg["batch"], cfg["seed"], dev)
        acc = None if mode == "dense" else GradientSharingAccumulator(
            mode=mode)
        pw = ParallelWrapper(net, accumulator=acc)
        pw.ensure_step(guard=True)   # builds: the broadcast, the carries
        ref = DPReference(net, pw, DP_WORLD) if rank == 0 else None
        if mode == "dense" and rank == 0:
            np.savez(os.path.join(job["out"], "dense_grads.npz"),
                     **_uncounted(lambda: ref.grad_sum(x, y)))
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        run = dp_guarded_run(pw, net, x, y, steps, reference=ref)
        run["launches"] = _flash_counts()
        run["peak_bytes"] = torch.cuda.max_memory_allocated() \
            if on_card else None
        run["telemetry"] = pw.telemetry_snapshot()
        if mode == "dense" and rank == 0:
            np.savez(os.path.join(job["out"], "dense_params.npz"),
                     **{k: t.detach().float().cpu().numpy() for k, t in
                        _leaves(net.params())})
        if mode == "gradient":
            # 24d: the rows split over the ranks and gathered
            t0 = time.perf_counter()
            got = ParallelInference(net).output(x)
            infer_s = time.perf_counter() - t0
            want = net.output(x)
            b = local["batch"]
            own = torch.cat([net.output(x[w * b:(w + 1) * b])
                             for w in range(DP_WORLD)])
            out["inference"] = dict(
                max_abs_err=float((got - want).abs().max()),
                max_abs=float(want.abs().max()),
                bit_equal=bool(torch.equal(got, want)),
                own_rows_bit_equal=bool(torch.equal(got, own)),
                rows=int(got.shape[0]), seconds=infer_s, local_rows=b)
        out[mode] = run
        del net, pw, ref, x, y
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return out


def dp_rank_24c(job, rank):
    """A rank of 24c: FaultTolerantTrainer over a W = 2 update-mode
    wrapper on phase 19b's cut, v3 shards. A runs the epoch; B is
    preempted at boundary DP_PREEMPT (its flush is the one archive); C
    resumes B's archive at W = 2 and must end as A bit for bit."""
    import torch
    from deeplearning4j_tpu_torch.faults import (FaultInjector,
                                                 PreemptionFault)
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import (
        GradientSharingAccumulator, ParallelWrapper)
    from deeplearning4j_tpu_torch.parallel.elastic import \
        FaultTolerantTrainer as FT
    cfg, device, root = job["cfg"], job["device"], job["out"]

    def wrapped(net):
        return ParallelWrapper(net, accumulator=GradientSharingAccumulator(
            mode="update"))

    def trainer(net, d, **kw):
        return FT(net, os.path.join(root, d), save_every_n_steps=100,
                  snapshot_every_n_steps=100, wrapper=wrapped(net),
                  sharded_checkpoints=True, **kw)

    netA = MultiLayerNetwork(train_conf(cfg), device=device).init()
    dev = netA.device
    batches = [recurrence_batch(cfg, cfg["batch"], cfg["seed"] + 200 + s,
                                dev) for s in range(DP_RES_BATCHES)]
    lossesA = []

    class Loss:
        def iteration_done(self, m, step, epoch):
            lossesA.append(m.score_)
    netA.set_listeners(Loss())
    t0 = time.perf_counter()
    trA = skip_epoch_archive(trainer(netA, "a"))
    trA.fit(batches, epochs=1)
    a_s = time.perf_counter() - t0
    if rank == 0:
        np.savez(os.path.join(root, "a_params.npz"),
                 **{k: t.detach().float().cpu().numpy()
                    for k, t in _leaves(netA.params())})
    netB = MultiLayerNetwork(train_conf(cfg), device=device).init()
    t0 = time.perf_counter()
    trB = trainer(netB, "b", async_write=False,
                  fault_injector=FaultInjector(plan={"preempt":
                                                     [DP_PREEMPT]}))
    try:
        trB.fit(batches, epochs=1)
        raise AssertionError("phase 24c: B was not preempted")
    except PreemptionFault:
        pass
    b_s = time.perf_counter() - t0
    names = [os.path.basename(p) for p in
             FT.list_checkpoints(os.path.join(root, "b"))]
    t0 = time.perf_counter()
    netC = FT.resume(os.path.join(root, "b"), device=device)
    restore_s = time.perf_counter() - t0
    stepC0 = netC._step
    trC = skip_epoch_archive(trainer(netC, "c"))
    trC.fit(batches, epochs=1)
    pwA, pwC = trA.wrapper, trC.wrapper
    return dict(
        names=names, resumed_step=stepC0, steps=[netA._step, netC._step],
        remesh=pwC.last_remesh, losses_a=lossesA,
        params=_leaf_gaps(netC.params(), netA.params()),
        adam=_leaf_gaps(netC.get_updater_state(),
                        netA.get_updater_state()),
        residual=_leaf_gaps(pwC.accumulator.residuals,
                            pwA.accumulator.residuals),
        threshold_equal=bool(torch.equal(pwC.accumulator.threshold,
                                         pwA.accumulator.threshold)),
        rng_equal=netC._rng == netA._rng, a_s=a_s, b_s=b_s,
        restore_s=restore_s,
        write_s=trB.supervisor.checkpoint_write_s,
        archive_bytes=FT._ckpt_bytes(FT.list_checkpoints(
            os.path.join(root, "b"))[-1]) if rank == 0 else None)


def dp_rank_main() -> int:
    """Entry of a phase-24 rank process: ``python -c "import chip_smoke;
    chip_smoke.dp_rank_main()" JOB RANK``."""
    job_path, rank = sys.argv[1], int(sys.argv[2])
    with open(job_path) as f:
        job = json.load(f)
    import torch
    from deeplearning4j_tpu_torch.parallel.elastic import initialize_cluster
    if job["device"] == "cpu":
        torch.set_num_threads(1)
    initialize_cluster(job["addr"], job["world"], rank)
    import torch.distributed as dist
    res = {"24b": dp_rank_24b, "24c": dp_rank_24c}[job["part"]](job, rank)
    res["backend"] = str(dist.get_backend())
    res["jax_imported"] = sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m.split(".")[0] == "deeplearning4j_tpu")
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f, default=str)
    dist.destroy_process_group()
    return 0


def run_dp_ranks(part: str, job: dict, timeout_s=DP_RANK_TIMEOUT_S):
    """Spawn DP_WORLD rank processes for ``part`` ("24b" or "24c"), wait
    for all (killing every rank at the deadline or when one fails) and
    return their results by rank. Kernels are built before: the ranks
    only load the build directory."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    job = dict(job, part=part, addr=f"127.0.0.1:{port}", world=DP_WORLD)
    path = os.path.join(job["out"], f"job_{part}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    logs = [os.path.join(job["out"], f"{part}_rank{r}.log")
            for r in range(DP_WORLD)]
    procs = []
    for r in range(DP_WORLD):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import sys, chip_smoke; sys.exit(chip_smoke."
                 "dp_rank_main())", path, str(r)],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=here))
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            if any(c not in (None, 0) for c in codes):
                failed = f"a rank exited with {codes}"
                break
            if time.monotonic() > deadline:
                failed = f"the ranks outlasted {timeout_s} s"
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is not None:
        tails = []
        for r, log in enumerate(logs):
            with open(log) as f:
                tails.append(f"--- rank {r} ---\n{f.read()[-3000:]}")
        raise AssertionError(f"phase {part}: {failed}\n" + "\n".join(tails))
    out = []
    for r in range(DP_WORLD):
        with open(os.path.join(job["out"], f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def dp_one_worker(card, cfg, device, steps):
    """24a: ParallelWrapper(net) at one worker, dense (against a clone's
    plain fit, bit for bit) and both compressed modes."""
    import torch
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import (
        GradientSharingAccumulator, ParallelWrapper)
    net = MultiLayerNetwork(train_conf(cfg), device=device).init()
    dev = net.device
    on_card = dev.type == "cuda"
    plain = net.clone()
    x, y = recurrence_batch(cfg, cfg["batch"], cfg["seed"], dev)
    _, grads, _, _ = plain._grads(plain._params, plain._net_state, x, y,
                                  None, True, None)
    grads1 = {k: t.detach().float().cpu().numpy() for k, t in
              _leaves(grads)}
    del grads
    for _ in range(1 + steps):
        plain.fit(x, y)
    pw = ParallelWrapper(net)
    reset_launches()
    ms, losses = [], []
    for _ in range(1 + steps):
        t0 = time.perf_counter()
        pw.fit([(x, y)])
        if on_card:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score_)
    launches = _flash_counts()
    res = dict(dense=dict(
        losses=losses, step_ms=ms, step_p50_ms=float(np.median(ms[1:])),
        launches=launches, workers=pw.num_workers,
        params=_leaf_gaps(net.params(), plain.params()),
        adam=_leaf_gaps(net.get_updater_state(),
                        plain.get_updater_state())))
    dense_params = {k: t.detach().float().cpu().numpy()
                    for k, t in _leaves(net.params())}
    del net, plain, pw
    for mode in ("update", "gradient"):
        m = MultiLayerNetwork(train_conf(cfg), device=device).init()
        pw = ParallelWrapper(m, accumulator=GradientSharingAccumulator(
            mode=mode))
        ms, losses = [], []
        for _ in range(1 + steps):
            t0 = time.perf_counter()
            pw.fit([(x, y)])
            if on_card:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m.score_)
        res[mode] = dict(losses=losses, step_ms=ms,
                         step_p50_ms=float(np.median(ms[1:])),
                         telemetry=pw.telemetry_snapshot(),
                         residual_leaves=len(list(_leaves(
                             pw.accumulator.residuals))))
        del m, pw
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return res, dense_params, grads1


def dp_remesh_one_worker(cfg, device, root):
    """24c's W = 1 resume of B's W = 2 archive in this process, to the
    epoch's end: its re-mesh and its distance to A's run."""
    from deeplearning4j_tpu_torch.parallel import (
        GradientSharingAccumulator, ParallelWrapper)
    from deeplearning4j_tpu_torch.parallel.elastic import \
        FaultTolerantTrainer as FT
    net = FT.resume(os.path.join(root, "b"), device=device)
    step0 = net._step
    pw = ParallelWrapper(net, accumulator=GradientSharingAccumulator(
        mode="update"))
    dev = net.device
    batches = [recurrence_batch(cfg, cfg["batch"], cfg["seed"] + 200 + s,
                                dev) for s in range(DP_RES_BATCHES)]
    skip_epoch_archive(FT(net, os.path.join(root, "w1"),
                          save_every_n_steps=100, snapshot_every_n_steps=100,
                          wrapper=pw, sharded_checkpoints=True)).fit(
        batches, epochs=1)
    with np.load(os.path.join(root, "a_params.npz")) as z:
        ref = np.concatenate([z[k].ravel() for k in sorted(z.files)])
    got = np.concatenate([t.detach().float().cpu().numpy().ravel() for _, t in
                          sorted(_leaves(net.params()))])
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    return dict(resumed_step=step0, step=net._step, remesh=pw.last_remesh,
                rel_l2=rel, finite=bool(np.isfinite(got).all()))


def parallel_phase(card: str, cfg=TRAIN_CFG, device=None,
                   steps=TRAIN_STEPS, resume_layers=RESUME_LAYERS):
    """Phase 24: data-parallel training of phase 9's net (see the module
    doc). 24a in this process; 24b/24d and 24c in DP_WORLD rank
    processes each on the one card over gloo (CUDA tensors staged
    through pinned host memory), then 24c's W = 1 resume here."""
    import tempfile

    import torch
    t_phase = time.perf_counter()
    bad = []
    one, dense1, grads1 = dp_one_worker(card, cfg, device, steps)
    d = one["dense"]
    want = cfg["n_layers"] * (1 + steps)
    if d["params"]["differ"] or d["adam"]["differ"]:
        bad.append(f"24a dense vs plain fit: {d['params']} {d['adam']}")
    on_card = (device or "cuda") != "cpu"
    if on_card and any(d["launches"][k] != want for k in (
            "flash_attention", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")):
        bad.append(f"24a launches {d['launches']} (want {want} each)")
    for mode in ("update", "gradient"):
        c = one[mode]
        if "compression" not in c["telemetry"] or \
                not all(np.isfinite(c["losses"])):
            bad.append(f"24a {mode}: {c['telemetry']} {c['losses']}")
    root = tempfile.mkdtemp(prefix="dl4j_dp_")
    try:
        job = dict(cfg=cfg, steps=steps, device=device or "cuda",
                   out=os.path.join(root, "b"))
        os.makedirs(job["out"])
        t0 = time.perf_counter()
        r24b = run_dp_ranks("24b", job)
        b_s = time.perf_counter() - t0
        def gaps(name, ref):
            with np.load(os.path.join(job["out"], name)) as z:
                got = {k: z[k] for k in z.files}
            g = {k: float(np.abs(got[k].astype(np.float64) - v).max()
                          / max(float(np.abs(v).max()), 1e-30))
                 for k, v in ref.items()}
            worst = max(g, key=g.get)
            return dict(worst=worst, worst_err=g[worst], leaves=len(g),
                        over=sum(e > DP_TOL for e in g.values()))
        grad_vs_24a = gaps("dense_grads.npz", grads1)
        dense_vs_24a = gaps("dense_params.npz", dense1)
        if grad_vs_24a["worst_err"] > DP_TOL:
            bad.append(f"24b's dense gradient vs 24a's: {grad_vs_24a}")
        for r, res in enumerate(r24b):
            if res["jax_imported"]:
                bad.append(f"rank {r} imported {res['jax_imported']}")
            for mode in ("dense", "update", "gradient"):
                run = res[mode]
                tag = f"24b {mode} rank {r}"
                oks = [True] * (1 + steps + 1)
                oks[DP_NAN_ITEM] = False
                if run["oks"] != oks or not all(run["agree"]):
                    bad.append(f"{tag}: oks {run['oks']} agree "
                               f"{run['agree']}")
                sk = run["skip"]
                if not sk.get("params_kept") or (
                        mode != "dense" and not sk.get("residual_kept")):
                    bad.append(f"{tag}: the skip moved state {sk}")
                clean = [lv for lv, ok in zip(run["losses"], run["oks"])
                         if ok]
                if not clean[-1] < clean[0]:
                    bad.append(f"{tag}: the loss did not fall {clean}")
                # every item runs forward and backward, the skipped one
                # too; the reference's launches are not counted
                if on_card and any(run["launches"][k] != cfg["n_layers"]
                                   * (2 + steps) for k in (
                                       "flash_attention",
                                       "flash_attention_bwd_dq",
                                       "flash_attention_bwd_dkv")):
                    bad.append(f"{tag}: launches {run['launches']}")
                for i, gap in enumerate(run["reference"]):
                    exact = gap["differ"] == 0 and (
                        "residual" not in gap
                        or gap["residual"]["differ"] == 0)
                    close = gap["worst_err"] <= DP_REF_TOL and (
                        "residual" not in gap
                        or gap["residual"]["worst_err"] <= DP_REF_TOL)
                    if not close or gap.get("threshold_equal") is False \
                            or gap["ok"] != run["oks"][i]:
                        bad.append(f"{tag} item {i} vs the reference: "
                                   f"{gap}")
                    gap["exact"] = exact
        inf = r24b[0]["inference"]
        if inf["max_abs_err"] > DP_INFER_TOL * inf["max_abs"] or not \
                all(r["inference"]["own_rows_bit_equal"] for r in r24b):
            bad.append(f"24d: {inf}")
        # 24c: the resilient trainer over the wrapper, phase 19b's cut
        cfg_c = dict(cfg, n_layers=resume_layers)
        job_c = dict(cfg=cfg_c, steps=steps, device=device or "cuda",
                     out=os.path.join(root, "c"))
        os.makedirs(job_c["out"])
        t0 = time.perf_counter()
        r24c = run_dp_ranks("24c", job_c)
        c_s = time.perf_counter() - t0
        for r, res in enumerate(r24c):
            if (res["resumed_step"] != DP_PREEMPT or res["remesh"]
                    is not None or res["steps"] != [DP_RES_BATCHES] * 2
                    or res["params"]["differ"] or res["adam"]["differ"]
                    or res["residual"]["differ"]
                    or not res["threshold_equal"] or not res["rng_equal"]
                    or len(res["names"]) != 1):
                bad.append(f"24c rank {r}: {res}")
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        remesh = dp_remesh_one_worker(cfg_c, device, job_c["out"])
        remesh["seconds"] = time.perf_counter() - t0
        if (tuple(remesh["remesh"] or ()) != (DP_WORLD, 1)
                or remesh["rel_l2"] > DP_REMESH_TOL
                or not remesh["finite"] or remesh["resumed_step"]
                != DP_PREEMPT):
            bad.append(f"24c W = 1 resume: {remesh}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res = dict(one=one, ranks_24b=r24b, grad_vs_24a=grad_vs_24a,
               dense_vs_24a=dense_vs_24a, ranks_24c=r24c, remesh=remesh,
               spawn_24b_s=b_s, spawn_24c_s=c_s,
               seconds=time.perf_counter() - t_phase)
    r0 = r24b[0]
    print(f"data parallel (phase 24a) [{card}]: ParallelWrapper(net) at "
          f"W = 1, {1 + steps} steps: params and Adam state equal a "
          f"clone's plain fit bit for bit, step p50 {d['step_p50_ms']:.2f}"
          f" ms, launches {d['launches']}; update mode step p50 "
          f"{one['update']['step_p50_ms']:.2f} ms "
          f"({one['update']['telemetry']['compression']}), gradient mode "
          f"{one['gradient']['step_p50_ms']:.2f} ms")
    for mode in ("dense", "update", "gradient"):
        runs = [rr[mode] for rr in r24b]
        tel = runs[0]["telemetry"].get("compression")
        ref_gaps = runs[0]["reference"]
        exact = all(g["exact"] for g in ref_gaps)
        print(f"data parallel (phase 24b, {mode}) [{card}]: W = "
              f"{DP_WORLD} ranks on one card over {r0['backend']}, "
              f"{cfg['batch'] // DP_WORLD} x {cfg['seq_len']} tokens a "
              f"rank, guard on: step p50 "
              f"{[round(rr['step_p50_ms'], 2) for rr in runs]} ms (by "
              f"rank), the step's collective p50 "
              f"{runs[0]['collective_p50_ms']:.2f} ms ("
              f"{runs[0]['collective_calls']} calls over the items, "
              f"{runs[0]['collective_bytes']} bytes each), params equal "
              f"across the ranks after every item, the NaN item skipped on "
              f"both ({runs[0]['skip']}), losses "
              f"{[round(v, 4) for v in runs[0]['losses']]}, against the "
              f"one-process reference "
              + ("bit for bit" if exact else
                 f"within {max(g['worst_err'] for g in ref_gaps):.3e} "
                 f"(not bit for bit)")
              + f"; peak {[rr['peak_bytes'] for rr in runs]} bytes a rank"
              + (f"; compression {tel}" if tel else ""))
    print(f"data parallel (phase 24b) [{card}]: the dense gradient at W "
          f"= {DP_WORLD} against 24a's from the same params: worst leaf "
          f"{grad_vs_24a['worst']} at {grad_vs_24a['worst_err']:.3e} of "
          f"its max (tol {DP_TOL:g}); the params after {1 + steps} Adam "
          f"steps: worst {dense_vs_24a['worst']} at "
          f"{dense_vs_24a['worst_err']:.3e}, {dense_vs_24a['over']} of "
          f"{dense_vs_24a['leaves']} leaves beyond {DP_TOL:g} (not held)")
    c0 = r24c[0]
    print(f"data parallel (phase 24c) [{card}]: FaultTolerantTrainer over "
          f"an update-mode wrapper at W = {DP_WORLD}, {resume_layers} "
          f"blocks, v3 shards: preempted at step {DP_PREEMPT} "
          f"({c0['names']}, {c0['archive_bytes']} bytes, written in "
          f"{c0['write_s']:.2f} s), resumed at W = {DP_WORLD} bit for bit "
          f"(params, Adam, residuals, threshold, key), restore "
          f"{c0['restore_s']:.2f} s; at W = 1: last_remesh "
          f"{remesh['remesh']}, rel L2 {remesh['rel_l2']:.4e} to the W = "
          f"{DP_WORLD} run (tol {DP_REMESH_TOL:g})")
    print(f"data parallel (phase 24d) [{card}]: ParallelInference at W = "
          f"{DP_WORLD}: {inf['rows']} rows gathered, max abs err "
          f"{inf['max_abs_err']:.3e} against output() of the whole batch "
          f"(tol {DP_INFER_TOL:g} of {inf['max_abs']:.3e}; bit for bit: "
          f"{inf['bit_equal']}), each rank's rows bit for bit output() "
          f"of those rows: {inf['own_rows_bit_equal']}; phase 24 took "
          f"{res['seconds']:.1f} s (24b's ranks {b_s:.1f} s, 24c's "
          f"{c_s:.1f} s)")
    if bad:
        raise AssertionError(f"phase 24 failed: {bad}")
    return res


# -- phase 25: Keras import ---------------------------------------------
#: 25a: (file, expected outputs, input key, output key, rtol) of every
#: committed Keras fixture, at tests/test_modelimport.py's tolerances
#: (atol 1e-5 each)
KERAS_CASES = (
    ("keras_seq_cnn.h5", "keras_expected.npz", "x1", "y1", 1e-3),
    ("keras_seq_lstm.h5", "keras_expected.npz", "x2", "y2", 1e-3),
    ("keras_func.h5", "keras_expected.npz", "x3", "y3", 1e-3),
    ("keras_seq_convs.h5", "keras_extra_expected.npz", "x_conv", "y_conv",
     1e-4),
    ("keras_seq_1d.h5", "keras_extra_expected.npz", "x_1d", "y_1d", 1e-4),
    ("keras_seq_gru.h5", "keras_extra_expected.npz", "x_gru", "y_gru", 1e-4),
    ("keras_seq_bidir.h5", "keras_extra_expected.npz", "x_bidir",
     "y_bidir", 1e-4),
    ("keras_seq_3d.h5", "keras_extra_expected.npz", "x_3d", "y_3d", 1e-4))
KERAS_ATOL = 1e-5
#: 25b: the port's MobileNetV2 (alpha 1.0, 224x224x3, 1,000 classes),
#: written by tools/make_keras_fixture.py with Keras's outputs beside it
KERAS_MOBILENET = os.path.join("deeplearning4j_tpu_torch", "modelimport",
                               "fixtures", "keras_mobilenet_v2_224")
KERAS_SHAPE = (224, 224, 3)
KERAS_CLASSES = 1000
KERAS_PARAMS = 3_538_984          # weights and batch-norm statistics
KERAS_POOL = "global_average_pooling2d"
KERAS_PROBS_TOL = dict(rtol=1e-3, atol=1e-5)   # test_modelimport's y1-y3;
#                   the CPU import stands 1.1e-5 from Keras at most (its
#                   softmax rows peak at 0.13-0.46)
KERAS_FEAT_TOL = dict(rtol=1e-4, atol=1e-5)    # the 1,280 pooled features
#                   (mean 0.41, std 0.22), as the extra set
# card vs a CPU import of the same file: the tolerance each output is
# held to Keras with (f32 sums in cuDNN's and the CPU's orders; TF32 is
# off). Read on the H100: 2.2e-7 of a row's max on the fixtures, 1.9e-5
# on MobileNetV2's softmax (its logits are scaled 6x; card and CPU stand
# 6.4e-6 and 1.1e-5 from Keras), 6.9e-6 on its pooled features.
KERAS_BATCH = 32       # 25b's training batch
KERAS_STEPS = 5        # 25b: timed steps, after one warmup step
KERAS_COPY_BATCH = 4   # 25b: the first step held against a CPU copy


def _keras_out(net, x):
    """A network's output on ``x`` as a host array (a graph's first)."""
    import torch
    with torch.no_grad():
        out = net.output([x]) if hasattr(net.conf, "nodes") else \
            net.output(x)
    out = out[0] if isinstance(out, list) else out
    return out.float().cpu().numpy()


def keras_fixtures(card: str, device=None) -> dict:
    """25a: every committed tests/fixtures/keras_*.h5 imported on the
    card through the port's HDF5 reader: its output on the fixture's
    input against Keras's at tests/test_modelimport.py's tolerance, its
    params bit for bit those of a CPU import of the same file, and its
    output against the CPU import's on the same input at the same
    tolerance."""
    import torch
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    here = os.path.dirname(os.path.abspath(__file__))
    fix = os.path.join(here, "tests", "fixtures")
    out, bad = {}, []
    for name, npz, xk, yk, rtol in KERAS_CASES:
        exp = np.load(os.path.join(fix, npz))
        path = os.path.join(fix, name)
        t0 = time.perf_counter()
        net = KerasModelImport.import_model(path, device=device)
        import_s = time.perf_counter() - t0
        cpu = KerasModelImport.import_model(path, device="cpu")
        got, ref = _keras_out(net, exp[xk]), _keras_out(cpu, exp[xk])
        keras_err = float(np.abs(got - exp[yk]).max())
        ok_keras = bool(np.allclose(got, exp[yk], rtol=rtol,
                                    atol=KERAS_ATOL))
        params_equal = all(
            torch.equal(t.cpu(), cpu.params()[k][n])
            for k, p in net.params().items() for n, t in p.items())
        cpu_err = row_rel_err(got.reshape(len(got), -1),
                              ref.reshape(len(ref), -1))
        ok_cpu = bool(np.allclose(got, ref, rtol=rtol, atol=KERAS_ATOL))
        out[name] = dict(kind=type(net).__name__, params=net.num_params(),
                         import_s=import_s, keras_abs_err=keras_err,
                         keras_rtol=rtol, cpu_rel_err=cpu_err,
                         params_equal_cpu=params_equal)
        if not (ok_keras and params_equal and ok_cpu):
            bad.append((name, out[name]))
    print(f"keras (phase 25a) [{card}]: {len(out)} fixtures imported on "
          f"the card; Keras abs err "
          + ", ".join(f"{n[6:-3]} {r['keras_abs_err']:.2e}"
                      for n, r in out.items())
          + f"; card vs CPU import at most "
          f"{max(r['cpu_rel_err'] for r in out.values()):.2e} of a row's "
          f"max (held at the Keras tolerance); params bit for bit the "
          f"CPU's: "
          f"{all(r['params_equal_cpu'] for r in out.values())}")
    if bad:
        raise AssertionError(f"phase 25a failed: {bad}")
    return out


def keras_mobilenet(card: str, device=None) -> dict:
    """25b's import and outputs: MobileNetV2 at its published width
    imported on the card with its training config enforced; its softmax
    and pooled features on the fixture's 8 images against Keras's and
    against a CPU copy's, at the same tolerances."""
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, KERAS_MOBILENET)
    exp = np.load(base + ".npz")
    x = exp["pixels"].astype(np.float32) / np.float32(127.5) - \
        np.float32(1.0)
    t0 = time.perf_counter()
    net = KerasModelImport.import_keras_model_and_weights(
        base + ".h5", enforce_training_config=True, device=device)
    _sync(net)
    import_s = time.perf_counter() - t0
    n_state = sum(int(t.numel()) for st in net.get_net_state().values()
                  for t in st.values())
    probs = _keras_out(net, x)
    feats = net.feed_forward([x])[KERAS_POOL].float().cpu().numpy()
    cpu = net.clone(device="cpu")
    cpu_probs = _keras_out(cpu, x)
    cpu_feats = cpu.feed_forward([x])[KERAS_POOL].float().numpy()
    res = dict(import_s=import_s, params=net.num_params(), state=n_state,
               probs_abs_err=float(np.abs(probs - exp["probs"]).max()),
               feats_abs_err=float(np.abs(feats - exp["features"]).max()),
               probs_row_max=[float(v) for v in exp["probs"].max(1)],
               feats_mean=float(exp["features"].mean()),
               feats_std=float(exp["features"].std()),
               probs_cpu_rel_err=row_rel_err(probs, cpu_probs),
               feats_cpu_rel_err=row_rel_err(feats, cpu_feats),
               argmax_equal=bool(np.array_equal(probs.argmax(1),
                                                exp["probs"].argmax(1))))
    ok = (net.num_params() + n_state == KERAS_PARAMS
          and np.allclose(probs, exp["probs"], **KERAS_PROBS_TOL)
          and np.allclose(feats, exp["features"], **KERAS_FEAT_TOL)
          and np.allclose(probs, cpu_probs, **KERAS_PROBS_TOL)
          and np.allclose(feats, cpu_feats, **KERAS_FEAT_TOL))
    if not ok:
        raise AssertionError(f"phase 25b outputs failed: {res}")
    return net, res


def _sync(net):
    import torch
    if net.device.type == "cuda":
        torch.cuda.synchronize()


def keras_train(card: str, net, shape=KERAS_SHAPE, batch=KERAS_BATCH,
                steps=KERAS_STEPS, copy_batch=KERAS_COPY_BATCH,
                classes=KERAS_CLASSES, seed=25) -> dict:
    """25b's training of an imported network not yet stepped, under its
    training config (Adam(1e-4), categorical cross-entropy): a clone's
    first step at ``copy_batch`` against a CPU copy (:func:`graph_vs_cpu`,
    each param's move held to Adam's update of the card's own moments),
    then the network itself through fit at ``batch``, one warmup and
    ``steps`` timed steps on a learnable synthetic batch, the loss
    falling and every running stat moving, peak memory and one profiled
    step."""
    import torch
    dev = net.device
    on_card = dev.type == "cuda"
    xs, ys = zoo_batch(batch, seed, shape, classes)
    x, y = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
    t0 = time.perf_counter()
    first = net.clone()
    vs_cpu = graph_vs_cpu(first, x[:copy_batch], y[:copy_batch], "25b")
    copy_s = time.perf_counter() - t0
    del first
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state0 = {k: {n: t.clone() for n, t in st.items()}
              for k, st in net.get_net_state().items()}
    clock = StepClock(sync=on_card)
    net.set_listeners(clock)
    losses = []
    clock.start()
    for _ in range(1 + steps):
        net.fit(x, y)
        losses.append(net.score_)
    net.set_listeners()
    moved = sum(int(not torch.equal(t, state0[k][n]))
                for k, st in net.get_net_state().items()
                for n, t in st.items())
    n_stats = sum(len(st) for st in state0.values())
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and moved == n_stats):
        raise AssertionError(f"phase 25b training: losses {losses}, "
                             f"{moved} of {n_stats} running stats moved")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    prof = profile_train_step(net, x, y) if on_card else None
    step_p50 = float(np.median(clock.step_ms[1:]))
    upd = next(iter(net._updaters.values()))
    return dict(batch=batch, steps=steps, losses=losses,
                updater=type(upd).__name__,
                learning_rate=float(upd.learning_rate),
                step_ms=clock.step_ms, step_p50_ms=step_p50,
                enqueue_p50_ms=float(np.median(clock.enqueue_ms[1:])),
                images_per_s=batch / (step_p50 / 1e3),
                bound_ms=train_bound_ms(net, batch, H100_F32_FLOPS),
                peak_bytes=peak, stats_moved=moved, profile=prof,
                vs_cpu=vs_cpu, copy_s=copy_s)


def keras_phase(card: str, device=None) -> dict:
    """Phase 25: Keras import on the card, on no TPU kernel (every launch
    counter must stay 0): (a) every committed Keras fixture; (b)
    MobileNetV2 at its published width: imported, held to Keras's
    softmax and pooled features and to a CPU copy, served through
    InferenceEngine (graph kind, as 21c serves ResNet-50), and trained
    under its imported training config."""
    from deeplearning4j_tpu_torch import kernels
    t_phase = time.perf_counter()
    reset_launches()
    a = keras_fixtures(card, device)
    net, b = keras_mobilenet(card, device)
    fresh = net.clone()  # one import: serving swaps the weights
    serve = graph_serve(card, net, KERAS_SHAPE, label="25b")
    del net
    gc.collect()
    train = keras_train(card, fresh)
    launches = kernels.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"phase 25 launched a TPU kernel: {launches}")
    res = dict(fixtures=a, mobilenet=b, serve=serve, train=train,
               seconds=time.perf_counter() - t_phase)
    v, p = train["vs_cpu"], train["profile"]
    u = v["adam_update"]
    print(f"keras (phase 25b) [{card}]: MobileNetV2 {KERAS_SHAPE} x "
          f"{KERAS_CLASSES} ({b['params']} params + {b['state']} batch-norm "
          f"statistics) imported in {b['import_s']:.2f} s; on the 8 images "
          f"softmax abs err {b['probs_abs_err']:.3e} (rtol "
          f"{KERAS_PROBS_TOL['rtol']:g}, atol {KERAS_PROBS_TOL['atol']:g}; "
          f"rows peak at {min(b['probs_row_max']):.3f}-"
          f"{max(b['probs_row_max']):.3f}), pooled features abs err "
          f"{b['feats_abs_err']:.3e} (rtol {KERAS_FEAT_TOL['rtol']:g}, atol "
          f"{KERAS_FEAT_TOL['atol']:g}; mean {b['feats_mean']:.3f}, std "
          f"{b['feats_std']:.3f}); card vs CPU copy {b['probs_cpu_rel_err']:.2e}"
          f" / {b['feats_cpu_rel_err']:.2e} of a row's max (held at the "
          f"same tolerances); top "
          f"class as Keras's: {b['argmax_equal']}")
    print(f"keras (phase 25b) served [{card}]: buckets {serve['buckets']} "
          f"captured at warmup ({serve['captures']} captures, none after), "
          f"{serve['rows']} rows in {serve['requests']} requests at "
          f"{serve['rows_per_s']:.1f} rows/s, request p50/p99 "
          f"{serve['request_p50_ms']:.1f}/{serve['request_p99_ms']:.1f} ms, "
          f"rows vs eager {serve['max_rel_err']:.2e}")
    print(f"keras (phase 25b) trained [{card}]: {train['updater']}"
          f"({train['learning_rate']:g}) and mcxent from the file, batch "
          f"{train['batch']}, 1 + {train['steps']} steps: step p50 "
          f"{train['step_p50_ms']:.3f} ms (bound {train['bound_ms']:.3f} ms "
          f"at the f32 rate), queued in p50 {train['enqueue_p50_ms']:.3f} "
          f"ms, {train['images_per_s']:.1f} images/s, peak "
          f"{train['peak_bytes']} bytes, loss "
          f"{[round(x, 4) for x in train['losses']]}, "
          f"{train['stats_moved']} running stats moved"
          + (f"; one profiled step: device busy {p['busy_share']:.3f} of "
             f"{p['wall_ms']:.1f} ms, {p['device_kernels']} device kernels, "
             f"{p['conv_ms']:.1f} ms in cuDNN's convolutions, "
             f"{p['layout_ms']:.1f} ms in layout copies" if p else ""))
    print(f"keras (phase 25b) first step vs CPU [{card}]: batch "
          f"{v['batch']}: loss rel err {v['loss_rel_err']:.3e}, "
          f"{v['nodes']} nodes, worst {v['worst_node']} "
          f"{v['node_rel_err']:.3e} (tol {GRAPH_NODE_TOL:g}), worst "
          f"gradient {v['worst_grad']} {v['worst_grad_rel_err']:.3e} (the "
          f"CPU's own floor up to {v['grad_floor_max']:.3e}; "
          f"{v['noise_leaves']} of {v['leaves']} leaves, "
          f"{v['noise_leaf_params']} params, held to no better than 1%), "
          f"Adam's m and v leaf by leaf within their gradient's gate, worst "
          f"{v['adam_worst']} {v['adam_rel_err']:.3e}; params after "
          f"{v['param_abs_err']:.3e} from the CPU's (not held: lr "
          f"{train['learning_rate']:g}); each param's move against Adam's "
          f"update of the card's own m and v: worst {u['worst']:.3e} of "
          f"its tolerance ({u['worst_leaf']}; {ADAM_UPDATE_LR:g} lr + "
          f"2^-22 of the param), largest move {u['max_move_lr']:.4f} lr; "
          f"phase 25 took {res['seconds']:.1f} s")
    return res


def reset_launches():
    """Set every kernel's launch count to 0 (just before a path runs)."""
    from deeplearning4j_tpu_torch import kernels
    kernels.add_launches({k: -n for k, n in kernels.launch_counts().items()})


def paged_traffic(vocab: int):
    """The paged phase's requests, from a fixed seed: a primer (the
    320-token system prompt + 16 tokens), a burst of 48 (every third
    one unrelated, the rest the system prompt + an own suffix; every
    eighth one samples) and the first turns of 8 sessions, with the
    tails their second turns append."""
    rs = np.random.RandomState(3)
    system = rs.randint(0, vocab, 320).tolist()
    primer = dict(prompt=system + rs.randint(0, vocab, 16).tolist(),
                  max_tokens=16, seed=0)
    burst = []
    for i in range(48):
        if i % 3 == 2:
            prompt = rs.randint(0, vocab, rs.randint(8, 601)).tolist()
        else:
            prompt = system + rs.randint(0, vocab,
                                         rs.randint(8, 281)).tolist()
        sampled = i % 8 == 7
        burst.append(dict(prompt=prompt, max_tokens=int(rs.randint(32, 65)),
                          temperature=0.8 if sampled else 0.0,
                          top_k=40 if sampled else 0, seed=i))
    turn1 = []
    for j in range(8):
        sampled = j == 7
        turn1.append(dict(prompt=rs.randint(0, vocab,
                                            rs.randint(100, 401)).tolist(),
                          max_tokens=int(rs.randint(32, 65)),
                          temperature=0.8 if sampled else 0.0,
                          top_k=40 if sampled else 0, seed=100 + j,
                          session_id=f"conv-{j}"))
    tails = [dict(tail=rs.randint(0, vocab, rs.randint(8, 65)).tolist(),
                  max_tokens=int(rs.randint(32, 65))) for _ in range(8)]
    return primer, burst, turn1, tails


def serve_paged(card: str, cfg=SERVE_CFG, device=None, kv_dtype="f32",
                chaos: bool = False, eager_ab: bool = False,
                traced: bool = False):
    """Phase 5 (f32) or 7 (int8, int8 MLP weights): the paged backend
    end to end (see the module doc). With ``chaos``, phase 11 then reruns
    the primer and the 48-request burst on the same warmed engine under
    :func:`paged_fault_plan`'s plan (:func:`fault_ladder`), and every
    block must come back again. With ``traced``, phase 15b then runs the
    whole traffic (primer, burst, both session turns) in traced and
    untraced turns (:func:`traced_turns`), from emptied prefix and
    session caches each time, as the first run started. With
    ``eager_ab`` the primer and the burst then run on an engine with no
    CUDA graph and must give the same tokens."""
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo.transformer_lm import (
        CausalTransformerLM, quantize_mlp_weights)
    int8 = kv_dtype == "int8"
    lm = CausalTransformerLM(**cfg, device=device).init()
    if int8:
        quantize_mlp_weights(lm)
    primer, burst, turn1, tails = paged_traffic(cfg["vocab_size"])
    bs = PAGED_ENGINE["block_size"]
    # a session's turn 2 matches the pinned prompt + tokens[:-1]
    mid_block = sum((len(t["prompt"]) + t["max_tokens"] - 1) % bs != 0
                    for t in turn1)
    if not mid_block:
        raise AssertionError("no session match ends mid-block: the "
                             "copy-on-write path would not run")
    eng = GenerationEngine(lm, **PAGED_ENGINE, kv_dtype=kv_dtype)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        captures = warmed_compiles(eng)
        graphs = graph_memory(eng)
        calls = count_calls(eng)
        st0 = eng.stats()
        reset_launches()
        primed = eng.generate(timeout_ms=600_000, **primer)
        results, wall = run_requests(eng, burst)
        res1, _ = run_requests(eng, turn1)
        turn2 = [dict(t, prompt=t["prompt"] + r["tokens"] + x["tail"],
                      max_tokens=x["max_tokens"])
                 for t, r, x in zip(turn1, res1, tails)]
        # the hot sessions' turn-2 TTFT (phase 14 prints it beside its
        # restored ones)
        turn2_ttft = first_token_ms(eng)
        res2, _ = run_requests(eng, turn2)
        launches = {"decode_attention": da.launches,
                    "decode_attention_int8": da.launches_int8,
                    "flash_attention": fa.launches,
                    "paged_attention": pa.launches,
                    "paged_attention_int8": pa.launches_int8}
        st = eng.stats()
        check_lengths(results + res1 + res2, burst + turn1 + turn2)
        steps = st["decode_steps"] - st0["decode_steps"]
        paged = "paged_attention_int8" if int8 else "paged_attention"
        if not steps or launches[paged] != cfg["n_layers"] * steps \
                or sum(launches.values()) != launches[paged]:
            raise AssertionError(f"launches {launches}: {paged} must run "
                                 f"{cfg['n_layers']} x {steps} decode steps "
                                 f"and nothing else")
        pc = st["paged"]["prefix_cache"]
        if not (pc["prefix_hits"] >= 32 and pc["session_hits"] == 8
                and pc["cow_copies"] >= 1):
            raise AssertionError(f"prefix cache did not serve as "
                                 f"expected: {pc}")
        prof = profile_window(eng)
        no_capture_since(eng, captures)
        all_blocks_back(eng)
        # every block is free: a replay's writes land on no live data
        replay = (busiest_replay(eng, calls, "chunk") if eng._cuda_graph
                  else None)
        ladder = None
        if chaos:
            plan, target, planned = paged_fault_plan(eng, primer, burst)
            eng.generate(timeout_ms=600_000, **primer)
            ladder = fault_ladder(
                eng, card, f"paged {kv_dtype} on phase "
                f"{7 if int8 else 5}'s engine", burst, results, plan,
                lambda: cpu_copy(lm, cfg),
                int8_paged_rows if int8 else f32_rows,
                INT8_TEACHER_TOL if int8 else TEACHER_TOL, cfg["n_layers"],
                planned_chunks=planned, mid_chunk_target=target)
            ladder["blocks_free_after"] = all_blocks_back(eng, " under "
                                                          "faults")
        trace15 = None
        if traced:
            # the burst's requests behind the system prompt, and every
            # session's turn 2, must match a cached prefix
            system = primer["prompt"][:320]
            behind = {1 + i for i, q in enumerate(burst)
                      if q["prompt"][:320] == system}
            behind |= set(range(1 + len(burst) + len(turn1),
                                1 + len(burst) + len(turn1) + len(turn2)))

            def empty_caches():
                eng.evict_sessions()
                eng.clear_prefix_cache()
            trace15 = traced_turns(
                eng, card, f"15b, paged {kv_dtype} on phase "
                f"{7 if int8 else 5}'s engine",
                [[primer], burst, turn1, turn2],
                [r["tokens"] for r in [primed] + results + res1 + res2],
                captures, cfg["n_layers"], "paged_attention." + (
                    "launches_int8" if int8 else "launches"),
                prep=empty_caches, prefix_idx=behind)
            all_blocks_back(eng, " after phase 15")
    finally:
        eng.stop()
    eager = (eager_run(lm, dict(PAGED_ENGINE, kv_dtype=kv_dtype), burst,
                       results, primer=primer) if eager_ab else None)

    greedy = [i for i, q in enumerate(burst) if q["temperature"] == 0.0]
    same = None
    if not int8:
        # the same burst on the slot engine: informative only, the two
        # kernels sum in different orders
        slot_eng = GenerationEngine(lm, num_slots=PAGED_ENGINE["num_slots"])
        try:
            slot_eng.warmup()
            slot_results, _ = run_requests(slot_eng, burst)
        finally:
            slot_eng.stop()
        same = sum(slot_results[i]["tokens"] == results[i]["tokens"]
                   for i in greedy)

    shared = [i for i in greedy if burst[i]["prompt"][:320]
              == primer["prompt"][:320]][:4]
    resumed = [j for j, t in enumerate(turn2) if t["temperature"] == 0.0][:2]
    cases = ([(burst[i]["prompt"], results[i]["tokens"]) for i in shared]
             + [(turn2[j]["prompt"], res2[j]["tokens"]) for j in resumed])
    cpu = cpu_copy(lm, cfg)
    rows_fn, tol = ((int8_paged_rows, INT8_TEACHER_TOL) if int8
                    else (f32_rows, TEACHER_TOL))
    checked, exact, worst_gap = teacher_check(rows_fn, cpu, cases, tol,
                                              " (paged)")
    rel = None
    if int8:  # the whole int8 setup (KV and MLP) against the f32 model
        rel = int8_vs_f32(CausalTransformerLM(**cfg, device="cpu").init(),
                          cpu, cases[:2], int8_paged_rows)
    n_tok = sum(len(r["tokens"]) for r in results)
    e2e = dict(kv_dtype=kv_dtype, requests=len(burst), tokens=n_tok,
               wall_s=wall,
               tokens_per_s=n_tok / wall,
               ttft_p50_ms=st["ttft_ms"]["p50"],
               ttft_p99_ms=st["ttft_ms"]["p99"],
               turn2_ttft_p50_ms=float(np.percentile(
                   list(turn2_ttft.values()), 50)),
               decode_step_p50_ms=st["decode_step_ms"]["p50"],
               decode_step_p99_ms=st["decode_step_ms"]["p99"],
               decode_sync_wait_p50_ms=st["decode_sync_wait_ms"]["p50"],
               decode_sync_wait_p99_ms=st["decode_sync_wait_ms"]["p99"],
               cuda_graph=eng._cuda_graph, compiles_after_warmup=captures,
               graphs=graphs, busiest_replay=replay, eager=eager,
               prefill_chunk_p50_ms=st["prefill_ms"]["p50"],
               decode_steps=steps,
               prefill_chunks=st["paged"]["prefill_chunks"],
               prefix_hits=pc["prefix_hits"],
               session_hits=pc["session_hits"],
               cow_copies=pc["cow_copies"],
               prefix_tokens_matched=pc["prefix_tokens_matched"],
               prefill_tokens=pc["prefill_tokens"],
               blocks_peak_used=st["paged"]["blocks_peak_used"],
               blocks_total=st["paged"]["blocks_total"],
               session_mid_block_matches=mid_block,
               warmup_s=warm_s, launches=launches,
               teacher_checked=checked, teacher_exact=exact,
               teacher_exact_rate=exact / max(checked, 1),
               teacher_worst_gap=worst_gap, teacher_tol=tol,
               kv_cache_bytes=st["kv_cache_bytes"],
               kv_bytes_per_token=st["kv_bytes_per_token"],
               quant=st["quant"], int8_vs_f32_logit_rel_err=rel,
               slot_engine_greedy_identical=None if same is None
               else f"{same}/{len(greedy)}",
               profile=prof, fault_ladder=ladder, traced=trace15,
               primer_tokens=primed["tokens"],
               served=(primer, [(burst, results), (turn1, res1),
                                (turn2, res2)]))
    tag = "" if kv_dtype == "f32" else f" {kv_dtype}"
    print(f"e2e paged{tag} [{card}]: {n_tok} tokens from {len(burst)} "
          f"requests "
          f"in {wall:.3f} s = {e2e['tokens_per_s']:.1f} tokens/s; phase "
          f"TTFT p50/p99 {e2e['ttft_p50_ms']:.1f}/{e2e['ttft_p99_ms']:.1f} "
          f"ms (session turn 2 p50 {e2e['turn2_ttft_p50_ms']:.1f}), decode "
          f"step p50/p99 {e2e['decode_step_p50_ms']:.2f}/"
          f"{e2e['decode_step_p99_ms']:.2f} ms, sync wait p50/p99 "
          f"{e2e['decode_sync_wait_p50_ms']:.2f}/"
          f"{e2e['decode_sync_wait_p99_ms']:.2f} ms, prefill chunk p50 "
          f"{e2e['prefill_chunk_p50_ms']:.2f} ms, {pc['prefix_hits']} "
          f"prefix hits ({pc['session_hits']} sessions), "
          f"{pc['prefix_tokens_matched']} prompt tokens matched, "
          f"{pc['cow_copies']} COW copies, peak {e2e['blocks_peak_used']} "
          f"of {e2e['blocks_total']} blocks, launches {launches} over "
          f"{steps} decode steps; {graph_line(graphs)}"
          f"{replay_line(replay)}; pool "
          f"{st['kv_cache_bytes']} bytes "
          f"({st['kv_cache_bytes'] / 2**30:.3f} GiB), "
          f"{st['kv_bytes_per_token']} bytes per token, quant {st['quant']}")
    if eager is not None:
        print(f"e2e paged{tag} eager [{card}]: the primer and burst on the "
              f"engine with no CUDA graph: {eager['identical']} requests' "
              f"tokens identical to the graphs', "
              f"{eager['tokens_per_s']:.1f} tokens/s, TTFT p50 "
              f"{eager['ttft_p50_ms']:.1f} ms, prefill chunk p50 "
              f"{eager['prefill_p50_ms']:.2f} ms, decode step p50/p99 "
              f"{eager['decode_step_p50_ms']:.2f}/"
              f"{eager['decode_step_p99_ms']:.2f} ms")
    print(f"teacher-forced (paged{tag}): {checked} greedy tokens of "
          f"{len(shared)} shared-prefix and {len(resumed)} turn-2 requests, "
          f"exact-match rate {e2e['teacher_exact_rate']:.4f}, worst gap "
          f"{worst_gap:.3e} (tol {tol:g}); "
          + (f"int8 (KV and MLP) vs f32 max logit rel err {rel:.4e} "
             f"(informative)" if int8 else
             f"slot engine on the same burst: {same} of {len(greedy)} "
             f"greedy requests identical"))
    print_profile(f"profile window paged{tag}", card, prof)
    return e2e


#: phase 12's speculation depth (docs/generation.md's example k)
SPEC_K = 4
#: phase 12a's fault rerun: a corrupting verify call while lanes decode
SPEC_FAULT_PLAN = dict(seed=11, plan={"verify": [40]},
                       corrupting=("verify",))


def serve_spec(card: str, served, paged: bool, cfg=SERVE_CFG, device=None,
               traced: bool = False):
    """Phase 12: speculative decoding at ``SPEC_K`` on the slot engine of
    phase 4 with a same-config, same-seed copy of the target as its
    draft (JAX's identity rig: with random weights only such a draft
    accepts), or on the paged engine of phase 5 with ``make_draft_lm``'s
    default draft (2 heads of 16: near-chance proposals). ``served`` is
    what phase 4 or 5 served at k=0 on the card (:func:`serve`,
    :func:`serve_paged`: the primer and the waves of requests with their
    tokens): the same traffic runs again, wave after wave, and every
    lane's tokens must equal those unless their first difference is a
    near-tie of the CPU reference (:func:`near_tie` at the teacher
    tolerance). Tokens/s is the first wave's (phase 4's or 5's burst). The
    engine must capture its graph plan at warmup (decode, proposal,
    prefill or chunk buckets, copy-on-write, primes, verify spans) and
    nothing after; the draft's B1 launches must be its layers x k x the
    proposal calls (graph replays counted) and B3 run its primes, and no
    draft call may fall back (random weights give finite logits, so a
    sound draft never does). The accept rate is split by lane
    (:func:`accept_split`). A profile window (:func:`profile_window`)
    gives the device's busy share under speculation. On the
    slot engine the traffic then runs again under a corrupting verify
    fault: one recovery, no request lost, no capture, the same gate. With
    ``traced``, phase 15c then traces one greedy request
    (:func:`traced_spec_request`)."""
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.faults import FaultInjector
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo.transformer_lm import (
        CausalTransformerLM, make_draft_lm)
    lm = CausalTransformerLM(**cfg, device=device).init()
    primer, waves = served
    reqs = [r for wave, _ in waves for r in wave]
    want = [r for _, res in waves for r in res]
    if paged:
        draft = make_draft_lm(lm)
        engine_kw = dict(PAGED_ENGINE)
    else:
        draft = CausalTransformerLM(**cfg, device=device).init()
        engine_kw = dict(num_slots=32)
    label = f"{'paged' if paged else 'slots'} k={SPEC_K}"
    eng = GenerationEngine(lm, **engine_kw, speculation_k=SPEC_K,
                           draft_model=draft)
    calls = []
    guard = dict(spans=0, shared=0)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        captures = warmed_compiles(eng)
        graphs = graph_memory(eng)
        graph_calls = count_calls(eng)
        propose = eng._propose_call
        eng._propose_call = lambda: calls.append(1) or propose()
        if paged:
            cow_guard = eng._spec_cow_guard

            def counted(slot, p0):
                table, bs = eng._slot_blocks[slot], eng.block_size
                last = min((p0 + eng._vbucket) // bs, len(table.blocks) - 1)
                guard["spans"] += 1
                guard["shared"] += any(
                    eng._allocator.ref(table.blocks[i]) > 1
                    for i in range(p0 // bs, last + 1))
                return cow_guard(slot, p0)
            eng._spec_cow_guard = counted
        # every prime and verify in order, for the per-lane accept rates
        events = []
        verify, prime = eng._verify_call, eng._spec_prime

        def verify_logged(slot, tokens, p0, req, table=None):
            out = verify(slot, tokens, p0, req, table)
            # (slot or, paged, None; temperature; accepted)
            events.append((None if paged else slot, req.temperature,
                           out[eng._vbucket]))
            return out

        def prime_logged(slot, seq):
            events.append((slot, None, None))
            return prime(slot, seq)
        eng._verify_call, eng._spec_prime = verify_logged, prime_logged
        st0 = eng.stats()
        reset_launches()
        if primer is not None:
            eng.generate(timeout_ms=600_000, **primer)
        results, wall = [], None
        for wave, _ in waves:
            got, w = run_requests(eng, wave)
            results += got
            wall = wall or w
        launches = {k: n for k, n in kernels.launch_counts().items() if n}
        n_calls = len(calls)
        st = eng.stats()
        split = accept_split(events, SPEC_K)
        prof = profile_window(eng)
        no_capture_since(eng, captures)
        ladder = None
        if not paged:
            ladder = dict(eng.stats()["faults"])
            eng.set_fault_injector(FaultInjector(**SPEC_FAULT_PLAN))
            try:
                again, _ = run_requests(eng, reqs)
            finally:
                eng.set_fault_injector(None)
            ladder = {k: eng.stats()["faults"][k] - ladder[k]
                      for k in ("retries", "recoveries")}
            no_capture_since(eng, captures)
            if ladder != {"retries": 0, "recoveries": 1}:
                raise AssertionError(f"{label}: the corrupting verify "
                                     f"fault gave {ladder}")
        trace15 = None
        if traced:
            i = next(i for i, q in enumerate(reqs) if q["temperature"] == 0)
            trace15 = traced_spec_request(eng, card, label, reqs[i],
                                          results[i]["tokens"], captures)
        if paged:
            all_blocks_back(eng)
        replay = (busiest_replay(eng, graph_calls, "verify")
                  if eng._cuda_graph else None)
    finally:
        eng.stop()
    check_lengths(results, reqs)
    steps = st["decode_steps"] - st0["decode_steps"]
    primes = st["prefills"] - st0["prefills"]
    layers, d_layers = cfg["n_layers"], draft.n_layers
    b1 = launches.get("decode_attention.launches", 0)
    b3 = launches.get("flash_attention.launches", 0)
    # slots: the target's plain steps (B1) and prefills (B3) too
    want_b1 = d_layers * SPEC_K * n_calls + (0 if paged
                                             else layers * steps)
    want_b3 = (d_layers + (0 if paged else layers)) * primes
    if not n_calls or b1 != want_b1 or b3 != want_b3:
        raise AssertionError(f"{label}: launches {launches} over "
                             f"{n_calls} proposal calls, {steps} plain "
                             f"steps and {primes} primes: B1 must run "
                             f"{want_b1}, B3 {want_b3}")
    if st["spec"]["draft_fallbacks"]:
        raise AssertionError(f"{label}: {st['spec']['draft_fallbacks']} "
                             f"draft fallbacks in fault-free traffic")
    cpu = None
    differ, ties = 0, []
    for run in ([results] if paged else [results, again]):
        for i, (r, w) in enumerate(zip(run, want)):
            if r["tokens"] == w["tokens"]:
                continue
            if cpu is None:
                cpu = cpu_copy(lm, cfg)
            differ += 1
            ties.append((i,) + near_tie(f32_rows, cpu, reqs[i], r["tokens"],
                                        w["tokens"], TEACHER_TOL))
    sp = st["spec"]
    n_tok = sum(len(r["tokens"]) for r in results[:len(waves[0][0])])
    out = dict(backend="paged" if paged else "slots", k=SPEC_K,
               draft=dict(d_model=draft.d_model, n_layers=d_layers,
                          n_heads=draft.n_heads),
               requests=len(reqs), burst_requests=len(waves[0][0]),
               tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
               warmup_s=warm_s, graphs=graphs, busiest_replay=replay,
               captures_at_warmup=captures, captures_after=0, spec=sp,
               decode_step_p50_ms=st["decode_step_ms"]["p50"],
               decode_step_p99_ms=st["decode_step_ms"]["p99"],
               draft_call_p50_ms=st["spec_draft_ms"]["p50"],
               verify_p50_ms=st["spec_verify_ms"]["p50"],
               verify_p99_ms=st["spec_verify_ms"]["p99"],
               ttft_p50_ms=st["ttft_ms"]["p50"],
               ttft_p99_ms=st["ttft_ms"]["p99"],
               prefill_p50_ms=st["prefill_ms"]["p50"], decode_steps=steps,
               proposal_calls=n_calls, primes=primes, launches=launches,
               b1_launches=b1, b3_launches=b3, accept_split=split,
               lanes_differing=differ, near_ties=ties,
               cow_guard=guard if paged else None, fault_ladder=ladder,
               traced=trace15, profile=prof)
    print(f"speculative {label} [{card}] (phase 12): {n_tok} tokens from "
          f"{len(waves[0][0])} requests in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tokens/s ({len(reqs)} requests in all); "
          f"draft d{draft.d_model} x L{d_layers} x H{draft.n_heads}; "
          f"{graph_line(graphs)}{replay_line(replay)}; TTFT p50/p99 "
          f"{out['ttft_p50_ms']:.1f}/"
          f"{out['ttft_p99_ms']:.1f} ms, prefill p50 "
          f"{out['prefill_p50_ms']:.2f} ms; "
          f"accept rate {sp['accept_rate']} (by lane as (rate, draft "
          f"tokens): {split}), {sp['verify_batches']} verify "
          f"batches, {sp['rollbacks']} rollbacks, {sp['draft_fallbacks']} "
          f"draft fallbacks; decode step p50/p99 "
          f"{out['decode_step_p50_ms']:.2f}/{out['decode_step_p99_ms']:.2f}"
          f" ms over {steps} plain steps; draft call p50 "
          f"{out['draft_call_p50_ms']:.2f} ms, verify p50/p99 "
          f"{out['verify_p50_ms']:.2f}/{out['verify_p99_ms']:.2f} ms; "
          f"B1 launches {b1} = draft "
          f"{d_layers} x {SPEC_K} x {n_calls} proposal calls"
          + ("" if paged else f" + target {layers} x {steps} steps")
          + f", B3 {b3} = " + ("" if paged else f"target {layers} + ")
          + f"draft {d_layers} x {primes} primes; launches "
          f"{launches}; {differ} lanes differ from k=0 (near-ties as "
          f"(request, position, gap): {ties})"
          + (f"; COW guard: {guard['spans']} spans checked, "
             f"{guard['shared']} met a shared block"
             + ("" if guard["shared"] else " (none shared a block)")
             if paged else
             f"; corrupting verify rerun: {ladder['recoveries']} recovery, "
             f"none lost, no capture"))
    print_profile(f"profile window speculative {label}", card, prof)
    return out


def traced_spec_request(eng, card, label, req, want, captures) -> dict:
    """Phase 15c on phase 12's warmed speculating engine: one greedy
    request traced (every counter set to 0 just before it). Its tokens
    must be ``want`` (the same request in phase 12's own run), nothing
    may be captured, B1 must run, its spans must pass
    :func:`span_problems` (no step_pipeline: speculation syncs every
    step), and its draft and verify spans must sum the same rounds with
    ``SPEC_K`` proposals a round."""
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.tracing import Tracer
    t0 = time.perf_counter()
    reset_launches()
    tracer = Tracer(enabled=True)
    tr = tracer.begin()
    out = eng.generate(timeout_ms=600_000, trace=tr, **req)
    tracer.finish(tr)
    launches = {k: n for k, n in kernels.launch_counts().items() if n}
    no_capture_since(eng, captures)
    bad = span_problems(tr, out["tokens"], eng.decode_pipeline)
    kinds = {s.kind: s.attrs for s in tr.spans}
    d, v = kinds.get("draft"), kinds.get("verify")
    if d is None or v is None or v["rounds"] < 1 \
            or d["rounds"] != v["rounds"] \
            or v["proposed"] != SPEC_K * v["rounds"] \
            or d["proposed"] != v["proposed"]:
        bad.append(f"draft and verify spans with proposed = {SPEC_K} x "
                   f"rounds: {d}, {v}")
    if out["tokens"] != want:
        bad.append("the tokens of phase 12's own run")
    if not launches.get("decode_attention.launches"):
        bad.append(f"B1 launches, got {launches}")
    if bad:
        raise AssertionError(f"phase 15c ({label}) failed: {bad}")
    res = dict(spans=len(tr.spans), kinds=[s.kind for s in tr.spans],
               draft=d, verify=v, tokens=len(out["tokens"]),
               launches=launches, wall_s=time.perf_counter() - t0)
    print(f"traced speculation {label} [{card}] (phase 15c): one greedy "
          f"request of {res['tokens']} tokens, spans {res['kinds']}; "
          f"verify {v}; tokens identical to phase 12's run, no capture; "
          f"launches {launches}; the phase added {res['wall_s']:.2f} s")
    return res


def accept_split(events, k: int) -> dict:
    """Phase 12's accept rate by lane, as (rate, draft tokens proposed)
    from the engine's primes and verifies in order (``events``: ``(slot,
    None, None)`` a prime, ``(slot, temperature, accepted)`` a verify,
    slot None on the paged engine): greedy lanes apart from sampled
    ones (a greedy draft rarely matches a sampled target token), and on
    the slot engine the greedy rounds before a lane's first
    all-accepted round apart from those after it. An all-accepted round
    commits k + 1 positions but the draft wrote K/V at only k of them:
    the last stays a hole in the draft cache (stale or a prime's padded
    row) that every later proposal of the lane attends to."""
    holes, tally = {}, {}
    for slot, temp, n in events:
        if temp is None:
            holes[slot] = 0
            continue
        n = int(n)
        keys = ["greedy" if temp == 0 else "sampled"]
        if temp == 0 and slot is not None:
            keys.append("greedy_after_a_hole" if holes.get(slot)
                        else "greedy_before_any_hole")
        for key in keys:
            a, p = tally.get(key, (0, 0))
            tally[key] = (a + n, p + k)
        if slot is not None and n == k:
            holes[slot] = holes.get(slot, 0) + 1
    return {key: (a / p, p) for key, (a, p) in sorted(tally.items())}


#: phase 14: 32 two-turn sessions (docs/generation.md's offload scenario,
#: "32 live two-turn sessions on a pool that pins ~3")
OFFLOAD_SESSIONS = 32
OFFLOAD_POOL_SESSIONS = 3


def offload_traffic(vocab: int):
    """Phase 14's sessions, from a fixed seed: 32 first turns of 100–400
    prompt tokens (the even ones phase 5's 320-token system prompt and
    an own suffix, so its blocks demote and restore as ``px:`` entries),
    32–64 new tokens each, every eighth one sampled, and the tail of
    8–64 tokens each second turn appends (with 32–64 new tokens)."""
    system = paged_traffic(vocab)[0]["prompt"][:320]
    rs = np.random.RandomState(14)
    turn1, tails = [], []
    for i in range(OFFLOAD_SESSIONS):
        if i % 2 == 0:
            prompt = system + rs.randint(0, vocab, rs.randint(8, 81)).tolist()
        else:
            prompt = rs.randint(0, vocab, rs.randint(100, 401)).tolist()
        sampled = i % 8 == 7
        turn1.append(dict(prompt=prompt, max_tokens=int(rs.randint(32, 65)),
                          temperature=0.8 if sampled else 0.0,
                          top_k=40 if sampled else 0, seed=200 + i,
                          session_id=f"user-{i}"))
        tails.append(dict(tail=rs.randint(0, vocab, rs.randint(8, 65)).tolist(),
                          max_tokens=int(rs.randint(32, 65))))
    return turn1, tails


def offload_sizes(lm, turn1, tails):
    """Phase 14's pool and tiers from the traffic: a pool that pins
    about ``OFFLOAD_POOL_SESSIONS`` first turns (and holds the largest
    second turn), a host budget of a quarter of the f32 working set
    (every second turn's pinned run), so runs spill, and a disk ring of
    four times it, so none drops (and the ring never wraps)."""
    from deeplearning4j_tpu_torch.kernels.kv_quant import kv_bytes_per_token
    from deeplearning4j_tpu_torch.serving.paging import blocks_for
    bs = PAGED_ENGINE["block_size"]
    pinned = [blocks_for(len(t["prompt"]) + t["max_tokens"] - 1, bs)
              for t in turn1]
    turn2 = [len(t["prompt"]) + t["max_tokens"] + len(x["tail"])
             + x["max_tokens"] for t, x in zip(turn1, tails)]
    num_blocks = 1 + max(OFFLOAD_POOL_SESSIONS
                         * int(round(np.mean(pinned))),
                         max(blocks_for(n, bs) for n in turn2))
    block_f32 = bs * kv_bytes_per_token(lm.cache_shapes(bs), "f32")
    working = sum(blocks_for(n - 1, bs) for n in turn2) * block_f32
    return dict(num_blocks=num_blocks, host_bytes=working // 4,
                disk_bytes=4 * working, working_set_f32=working,
                mean_pinned_blocks=float(np.mean(pinned)))


def wrap_counting(eng, name: str, key=None) -> list:
    """Wrap the engine method ``name`` to record each call that returns
    True (``key(args)`` of it, or True); returns the live list."""
    got = []
    fn = getattr(eng, name)

    def wrapped(*a):
        ok = fn(*a)
        if ok:
            got.append(key(*a) if key else True)
        return ok
    setattr(eng, name, wrapped)
    return got


def first_token_ms(eng) -> dict:
    """Each request's TTFT (submit to first token, ms) by session id,
    from a wrapper over the engine's token delivery; the live dict."""
    out = {}
    emit = eng._emit

    def wrapped(req, token, now, itl_out=None):
        first = req.t_first is None
        emit(req, token, now, itl_out=itl_out)
        if first and req.session_id is not None:
            out[req.session_id] = (req.t_first - req.t_submit) * 1e3
    eng._emit = wrapped
    return out


def offload_replay_ms(eng, n: int = 64) -> dict:
    """The captured gather and scatter of the ``n``-block run bucket,
    replayed alone on the card over ``n`` pool blocks (free by then:
    every block is back; a pool of fewer repeats them) and timed, beside
    the bound of the bytes they move (the run read once and written
    once, every layer's K and V)."""
    key_s, key_l = ("offload_save", n), ("offload_load", n)
    eng._off_in.load(idx=np.arange(n) % (eng.num_blocks - 1) + 1)
    save = time_ms(eng._graphs[key_s][0].replay)
    load = time_ms(eng._graphs[key_l][0].replay)
    nbytes = 2 * n * eng._cache.block_nbytes()
    return dict(blocks=n, save_ms=save, load_ms=load, bytes=nbytes,
                bound_ms=nbytes / H100_BYTES_PER_S * 1e3)


def serve_offload(card: str, kv_dtype: str = "f32", cfg=SERVE_CFG,
                  device=None, hot_turn2_ttft_ms=None, traced: bool = False):
    """Phase 14: the hierarchical KV tier (f32, or int8 KV on the int8
    MLP copy of phase 7) on phase 5's paged configuration with a pool
    that pins about three sessions (see the module doc).
    ``hot_turn2_ttft_ms`` is phase 5's (or 7's) hot-session turn-2 TTFT
    p50, printed beside this phase's (not gated). With ``traced`` (phase
    15d) every turn-2 request is traced: each must pass
    :func:`span_problems`, and there must be one offload_restore span per
    session restore of turn 2, and at least one."""
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo.transformer_lm import (
        CausalTransformerLM, quantize_mlp_weights)
    int8 = kv_dtype == "int8"
    lm = CausalTransformerLM(**cfg, device=device).init()
    if int8:
        quantize_mlp_weights(lm)
    turn1, tails = offload_traffic(cfg["vocab_size"])
    size = offload_sizes(lm, turn1, tails)

    def turn2_of(res1):
        return [dict(t, prompt=t["prompt"] + r["tokens"] + x["tail"],
                     max_tokens=x["max_tokens"])
                for t, r, x in zip(turn1, res1, tails)]

    # the reference: the same traffic on an engine with no offload and
    # a pool that evicts nothing
    ref = GenerationEngine(lm, **PAGED_ENGINE, kv_dtype=kv_dtype)
    try:
        ref.warmup()
        ref_plan = ref.graph_plan()
        want1, _ = run_requests(ref, turn1)
        turn2 = turn2_of(want1)
        want2, _ = run_requests(ref, turn2)
        if ref.stats()["paged"]["prefix_cache"]["session_evictions"]:
            raise AssertionError("the reference engine evicted a session")
    finally:
        ref.stop()

    eng = GenerationEngine(
        lm, **dict(PAGED_ENGINE, num_blocks=size["num_blocks"]),
        kv_dtype=kv_dtype, offload_host_bytes=size["host_bytes"],
        offload_disk_bytes=size["disk_bytes"], offload_dir=None,
        offload_prefetch=True)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        captures = warmed_compiles(eng)
        plan = eng.graph_plan()
        tier = {(k, b) for b in eng._off_buckets
                for k in ("offload_save", "offload_load")}
        if set(plan) != set(ref_plan) | tier or \
                len(plan) != len(ref_plan) + len(tier):
            raise AssertionError(f"the plan is not phase 5's plus a gather "
                                 f"and a scatter per run bucket: {plan}")
        graphs = graph_memory(eng)
        demoted_sessions = wrap_counting(eng, "_demote_session",
                                         lambda s: s.session_id)
        demoted_prefixes = wrap_counting(eng, "_demote_prefix",
                                         lambda digest, b: digest.hex())
        restored = wrap_counting(eng, "_offload_restore",
                                 lambda r: r.session_id)
        ttft = first_token_ms(eng)
        reset_launches()
        st0 = eng.stats()
        res1, wall1 = run_requests(eng, turn1)
        st1 = eng.stats()
        ttft1 = dict(ttft)
        # turn 2 follows this run's own turn 1 (a lane may differ from
        # the reference's at a near-tie, checked below)
        turn2_here = turn2_of(res1)
        restores1 = len(restored)
        run2 = turn2_here
        if traced:
            from deeplearning4j_tpu_torch.tracing import Tracer
            tracer = Tracer(enabled=True, ring=4096)
            run2 = [dict(q, trace=tracer.begin()) for q in turn2_here]
        res2, wall2 = run_requests(eng, run2)
        trace15 = None
        if traced:
            bad, n_spans, n_restore = [], 0, 0
            for q, r in zip(run2, res2):
                tracer.finish(q["trace"])
                n_spans += len(q["trace"].spans)
                n_restore += sum(s.kind == "offload_restore"
                                 for s in q["trace"].spans)
                bad += span_problems(q["trace"], r["tokens"],
                                     eng.decode_pipeline)
            if bad or not n_restore \
                    or n_restore != len(restored) - restores1:
                raise AssertionError(
                    f"phase 15d failed: {sorted(set(bad))}; "
                    f"{n_restore} offload_restore spans for "
                    f"{len(restored) - restores1} session restores")
            trace15 = dict(spans=n_spans, offload_restore_spans=n_restore,
                           traced_requests=len(run2), wall_turn2_s=wall2)
            print(f"traced offload {kv_dtype} [{card}] (phase 15d): "
                  f"{len(run2)} turn-2 requests traced, {n_spans} spans, "
                  f"{n_restore} offload_restore spans = the turn's session "
                  f"restores, turn 2 in {wall2:.3f} s")
        st2 = eng.stats()
        launches = {"decode_attention": da.launches,
                    "decode_attention_int8": da.launches_int8,
                    "flash_attention": fa.launches,
                    "paged_attention": pa.launches,
                    "paged_attention_int8": pa.launches_int8}
        no_capture_since(eng, captures)
        check_lengths(res1 + res2, turn1 + turn2_here)
        steps = st2["decode_steps"] - st0["decode_steps"]
        paged = "paged_attention_int8" if int8 else "paged_attention"
        if not steps or launches[paged] != cfg["n_layers"] * steps \
                or sum(launches.values()) != launches[paged]:
            raise AssertionError(f"launches {launches}: {paged} must run "
                                 f"{cfg['n_layers']} x {steps} decode steps "
                                 f"and nothing else")
        off = st2["paged"]["offload"]
        pc1, pc2 = (s["paged"]["prefix_cache"] for s in (st1, st2))
        hits2 = pc2["session_hits"] - pc1["session_hits"]
        misses2 = pc2["session_misses"] - pc1["session_misses"]
        px_restores = off["restores"] - len(restored)
        problems = []
        if not (demoted_sessions and demoted_prefixes):
            problems.append("demotions of both session and px: keys")
        if not int8 and not off["spills"]:
            problems.append("spills > 0 at f32")
        if off["drops"] or off["demote_failures"] or off["restore_failures"]:
            problems.append("no drop and no failed demotion or restore")
        # a resume held for blocks matches again at each attempt, so
        # hits may exceed the sessions; a miss is a re-prefill
        if hits2 < OFFLOAD_SESSIONS or misses2:
            problems.append("every turn 2 a session hit")
        if not (restored and px_restores > 0
                and off["prefetch_hits"] <= off["restores"]):
            problems.append("session and px: restores, prefetch hits <= "
                            "restores")
        if problems:
            raise AssertionError(f"phase 14 ({kv_dtype}) failed: "
                                 f"{problems}; offload {off}, turn-2 "
                                 f"session hits {hits2} misses {misses2}")
        # bytes a demoted token costs on the host, from the session runs
        # (every session demoted now)
        eng.offload_sessions()
        store = eng._offload
        runs = [store.get(k) for k in store.keys() if not k.startswith("px:")]
        run_bytes = sum(r.nbytes for r in runs)
        run_tokens = sum(len(r.tokens) for r in runs)
        eng.clear_prefix_cache()
        eng.clear_offload()
        st = store.stats()
        free, total = eng._allocator.free_count, eng._allocator.capacity
        if free != total or st["host_runs"] or st["disk_blocks"] \
                or st["host_bytes"] or st["disk_bytes"]:
            raise AssertionError(f"after offload_sessions, "
                                 f"clear_prefix_cache and clear_offload: "
                                 f"{free} of {total} blocks free, tiers {st}")
        replay = offload_replay_ms(eng) if eng._cuda_graph else None
        ring = store.disk._path
    finally:
        eng.stop()
    if ring is not None and os.path.exists(ring):
        raise AssertionError(f"stop() left the disk ring {ring}")

    cpu = cpu_copy(lm, cfg)
    rows_fn, tol = ((int8_paged_rows, INT8_TEACHER_TOL) if int8
                    else (f32_rows, TEACHER_TOL))
    differ = []
    for reqs, got, want in ((turn1, res1, want1), (turn2_here, res2, None)):
        for i, q in enumerate(reqs):
            if want is None:
                # a turn 2 is compared where its turn 1 matched (then its
                # prompt is the reference's)
                if res1[i]["tokens"] != want1[i]["tokens"]:
                    continue
                w = want2[i]["tokens"]
            else:
                w = want[i]["tokens"]
            if got[i]["tokens"] != w:
                differ.append((q["session_id"], near_tie(
                    rows_fn, cpu, q, got[i]["tokens"], w, tol)))
    resumed = [j for j, q in enumerate(turn2_here)
               if q["temperature"] == 0.0
               and q["session_id"] in restored][:2]
    if len(resumed) < 2:
        raise AssertionError("fewer than two restored greedy turn-2 lanes")
    checked, exact, worst_gap = teacher_check(
        rows_fn, cpu, [(turn2_here[j]["prompt"], res2[j]["tokens"])
                       for j in resumed], tol, " (offload)")
    t2 = [ttft[sid] for sid in set(restored) if sid in ttft]
    restored_ttft = float(np.percentile(t2, 50)) if t2 else None
    gib = float(2 ** 30)
    out = dict(
        kv_dtype=kv_dtype, sessions=OFFLOAD_SESSIONS, sizes=size,
        warmup_s=warm_s, compiles_after_warmup=captures, graphs=graphs,
        offload={k: off[k] for k in off},
        demoted_sessions=len(demoted_sessions),
        demoted_prefixes=len(demoted_prefixes),
        session_restores=len(restored),
        sessions_restored=len(set(restored)), prefix_restores=px_restores,
        turn2_session_hits=hits2, turn2_session_misses=misses2,
        launches=launches, decode_steps=steps,
        wall_turn1_s=wall1, wall_turn2_s=wall2,
        tokens_per_s=(sum(len(r["tokens"]) for r in res1 + res2)
                      / (wall1 + wall2)),
        host_bytes_per_token=run_bytes / max(run_tokens, 1),
        sessions_per_host_gib=gib / (run_bytes / max(len(runs), 1)),
        replay=replay, restored_turn2_ttft_p50_ms=restored_ttft,
        turn1_ttft_p50_ms=float(np.percentile(list(ttft1.values()), 50)),
        hot_turn2_ttft_p50_ms=hot_turn2_ttft_ms,
        ttft_ratio=(restored_ttft / hot_turn2_ttft_ms
                    if restored_ttft and hot_turn2_ttft_ms else None),
        lanes_differing=differ, teacher_checked=checked,
        teacher_exact=exact, teacher_worst_gap=worst_gap, teacher_tol=tol,
        traced=trace15)
    rm, dm = off["restore_ms"], off["demote_ms"]
    print(f"offload {kv_dtype} [{card}] (phase 14): {OFFLOAD_SESSIONS} "
          f"two-turn sessions on {size['num_blocks']} blocks (pins "
          f"~{OFFLOAD_POOL_SESSIONS} of {size['mean_pinned_blocks']:.1f} "
          f"blocks each), host budget {size['host_bytes']} bytes (f32 "
          f"working set {size['working_set_f32']}), disk ring "
          f"{size['disk_bytes']} bytes; {graph_line(graphs)}; demotions "
          f"{off['demotions']} ({len(demoted_sessions)} sessions, "
          f"{len(demoted_prefixes)} px:), restores {off['restores']} "
          f"({len(restored)} sessions, {px_restores} px:), prefetch hits "
          f"{off['prefetch_hits']}, spills {off['spills']}, drops "
          f"{off['drops']}; turn 2 session hits {hits2}, misses "
          f"{misses2}; demote ms p50/p99 {dm['p50']:.3f}/{dm['p99']:.3f}, "
          f"restore ms p50/p99 {rm['p50']:.3f}/{rm['p99']:.3f}; "
          f"{out['host_bytes_per_token']:.1f} host bytes per demoted "
          f"token, {out['sessions_per_host_gib']:.1f} sessions per host "
          f"GiB; restored turn-2 TTFT p50 "
          + ("not measured" if restored_ttft is None
             else f"{restored_ttft:.1f} ms")
          + f" (turn 1 {out['turn1_ttft_p50_ms']:.1f}) beside the hot "
          f"session's "
          + ("not measured" if hot_turn2_ttft_ms is None
             else f"{hot_turn2_ttft_ms:.1f} ms")
          + (f" (ratio {out['ttft_ratio']:.2f}, not gated)"
             if out["ttft_ratio"] else "")
          + f"; launches {launches} over {steps} decode steps; "
          f"{len(differ)} lanes differ from the eviction-free engine "
          f"(near-ties {differ}); teacher-forced {checked} tokens of "
          f"{len(resumed)} restored turn-2 lanes, worst gap "
          f"{worst_gap:.3e} (tol {tol:g})"
          + ("" if replay is None else
             f"; a {replay['blocks']}-block run's captured gather "
             f"{replay['save_ms']:.4f} ms and scatter "
             f"{replay['load_ms']:.4f} ms on the device (bound "
             f"{replay['bound_ms']:.4f} ms, {replay['bytes']} bytes)"))
    return out


#: phase 15: the turns of the traced-serving A/B (untraced, traced,
#: traced, untraced), each traced turn under a fresh enabled tracer
TRACE_TURNS = (False, True, True, False)
_PROM_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? '
                          r'(-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)$')
_PROM_TYPE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
                        r"(counter|gauge|summary)$")


def span_problems(tr, tokens, pipelined: bool) -> list:
    """Phase 15's checks of one finished traced request: one admission
    span (verdict "admitted"), one queue span, a prefill span, one decode
    span whose steps are the request's token count, one step_pipeline
    span on a pipelining engine, and no span left open. Returns what
    failed."""
    kinds = [s.kind for s in tr.spans]
    adm = [s for s in tr.spans if s.kind == "admission"]
    dec = [s for s in tr.spans if s.kind == "decode"]
    bad = []
    if len(adm) != 1 or adm[0].attrs.get("verdict") != "admitted":
        bad.append("one admitted admission span")
    if kinds.count("queue") != 1:
        bad.append("one queue span")
    if "prefill" not in kinds:
        bad.append("a prefill span")
    if len(dec) != 1 or dec[0].attrs.get("steps") != len(tokens):
        bad.append("one decode span, steps = tokens")
    if pipelined and kinds.count("step_pipeline") != 1:
        bad.append("one step_pipeline span")
    if any(s.t_end is None for s in tr.spans):
        bad.append("no open span")
    return bad


def parse_prometheus(text: str):
    """Parse Prometheus text exposition (format 0.0.4), failing on a line
    that is neither a sample nor a ``# TYPE`` line, a family typed twice,
    or a sample that does not follow its own family's ``# TYPE`` line.
    Returns ({(name, labels): value}, {name: type})."""
    samples, types, family = {}, {}, None
    for line in text.splitlines():
        if not line.strip():
            continue
        m = _PROM_TYPE.match(line)
        if m:
            if m.group(1) in types:
                raise AssertionError(f"family typed twice: {line!r}")
            family = m.group(1)
            types[family] = m.group(2)
            continue
        m = _PROM_SAMPLE.match(line)
        if not m or m.group(1) != family:
            raise AssertionError(f"invalid exposition line: {line!r}")
        samples[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return samples, types


def prometheus_check(eng) -> dict:
    """Phase 15's exposition check: the engine's ``stats()`` rendered as
    the serving shell will render it (``{"models": {"lm": ...}}``) parses,
    and its generated-token counter is the snapshot's."""
    from deeplearning4j_tpu_torch.serving import prometheus_text
    snap = eng.stats()
    samples, types = parse_prometheus(
        prometheus_text({"models": {"lm": snap}}))
    got = samples.get(("dl4j_model_tokens_generated_total", '{model="lm"}'))
    if got != snap["tokens_generated"]:
        raise AssertionError(f"dl4j_model_tokens_generated_total {got} != "
                             f"stats() {snap['tokens_generated']}")
    return dict(families=len(types), samples=len(samples))


def traced_turns(eng, card, label, waves, want, captures, n_layers,
                 decode_key, also=(), prep=None, prefix_idx=frozenset()):
    """Phase 15a/15b on a warmed engine after its own phase's runs:
    ``waves`` (lists of requests; each list at once, the lists in order)
    run in the four turns of :data:`TRACE_TURNS`, every request of a
    traced turn under its own trace; ``prep`` runs before each turn. Each
    turn's tokens must be ``want`` (the phase's first run, in wave
    order), nothing may be captured, ``decode_key``'s kernel must launch
    once per layer and decode step over the four turns (every counter set
    to 0 just before them), each kernel of ``also`` at least once and no
    other, every traced request must pass :func:`span_problems` (and
    carry a prefix_match span where its index in that order is in
    ``prefix_idx``), and :func:`prometheus_check` must pass.
    Prints each turn's tokens/s and the tracing overhead (the mean
    untraced tokens/s over the mean traced one, minus 1) with its spread:
    not gated, host noise moves serving tokens/s by more."""
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.tracing import Tracer
    t_phase = time.perf_counter()
    st0 = eng.stats()
    reset_launches()
    turns, problems, n_spans = [], [], 0
    for traced in TRACE_TURNS:
        if prep is not None:
            prep()
        tracer = Tracer(enabled=True, ring=4096) if traced else None
        got, wall, n_tok = [], 0.0, 0
        for wave in waves:
            reqs = [dict(r, trace=tracer.begin()) if traced else r
                    for r in wave]
            res, w = run_requests(eng, reqs)
            wall += w
            for q, r in zip(reqs, res):
                n_tok += len(r["tokens"])
                got.append(r["tokens"])
                if not traced:
                    continue
                tracer.finish(q["trace"])
                n_spans += len(q["trace"].spans)
                bad = span_problems(q["trace"], r["tokens"],
                                    eng.decode_pipeline)
                if len(got) - 1 in prefix_idx and not any(
                        s.kind == "prefix_match" for s in q["trace"].spans):
                    bad.append("a prefix_match span")
                if bad:
                    problems.append((len(got) - 1, bad))
        differ = sum(a != b for a, b in zip(got, want))
        if differ or len(got) != len(want):
            problems.append(f"{differ} of {len(want)} requests' tokens "
                            f"differ from the phase's first run")
        turns.append(dict(traced=traced, tokens=n_tok, wall_s=wall,
                          tokens_per_s=n_tok / wall))
    launches = {k: n for k, n in kernels.launch_counts().items() if n}
    steps = eng.stats()["decode_steps"] - st0["decode_steps"]
    if not steps or launches.get(decode_key) != n_layers * steps \
            or set(launches) != {decode_key, *also}:
        problems.append(f"launches {launches}: {decode_key} must run "
                        f"{n_layers} x {steps} decode steps, {also} run, "
                        f"nothing else")
    no_capture_since(eng, captures)
    prom = prometheus_check(eng)
    if problems:
        raise AssertionError(f"phase 15 ({label}) failed: {problems}")
    u = [t["tokens_per_s"] for t in turns if not t["traced"]]
    v = [t["tokens_per_s"] for t in turns if t["traced"]]
    pairs = [a / b - 1.0 for a in u for b in v]
    out = dict(turns=turns, trace_overhead_frac=float(np.mean(u)
                                                      / np.mean(v) - 1.0),
               overhead_pairs=[min(pairs), max(pairs)],
               untraced_spread=abs(u[0] - u[1]) / float(np.mean(u)),
               traced_spread=abs(v[0] - v[1]) / float(np.mean(v)),
               spans=n_spans, traced_requests=2 * len(want),
               launches=launches, decode_steps=steps, prometheus=prom,
               wall_s=time.perf_counter() - t_phase)
    print(f"traced serving {label} [{card}] (phase 15): tokens/s by turn "
          + ", ".join(f"{'traced' if t['traced'] else 'untraced'} "
                      f"{t['tokens_per_s']:.1f}" for t in turns)
          + f"; trace_overhead_frac {out['trace_overhead_frac']:.4f} "
          f"(pairs {out['overhead_pairs'][0]:.4f} to "
          f"{out['overhead_pairs'][1]:.4f}; the untraced turns differ by "
          f"{out['untraced_spread']:.4f}, the traced by "
          f"{out['traced_spread']:.4f}; not gated); {n_spans} spans over "
          f"{out['traced_requests']} traced requests, tokens identical to "
          f"the first run in all 4 turns, no capture; launches {launches} "
          f"over {steps} decode steps; Prometheus text of stats(): "
          f"{prom['families']} families, {prom['samples']} samples; the "
          f"phase added {out['wall_s']:.2f} s")
    return out


#: phase 11 on phase 4's engine: a transient fault at the 3rd prefill
#: (retried), then a corrupting 6th decode step, while every lane
#: decodes (recovered)
SLOT_FAULT_PLAN = dict(seed=11, plan={"prefill": [3], "device_step": [6]},
                       corrupting=("device_step",))


def paged_fault_plan(eng, primer, burst):
    """Phase 11's plan on phase 7's engine: a transient fault at the 3rd
    decode step (retried), and a corrupting fault at the prefill seam
    call that runs the SECOND chunk of the first two-chunk prompt behind
    at least four fully prefilled requests, so the recovery
    lands while those lanes decode and that prompt is mid-chunk. Chunk
    calls follow the burst's submission order (admission and the chunk
    queue are FIFO), and with the primer's system prompt in the prefix
    index every shared prompt prefills its suffix in one chunk. Returns
    (plan, index of the mid-chunk request, chunk calls the burst needs
    fault-free)."""
    system = primer["prompt"][:320]   # paged_traffic's system prompt
    calls, done, target = 0, 0, None
    for i, r in enumerate(burst):
        match = len(system) if r["prompt"][:len(system)] == system else 0
        n = len(eng._chunk_plan(len(r["prompt"]), start=match))
        if target is None and n > 1 and done >= 4:
            target, k = i, calls + 2
        calls += n
        done += 1
    if target is None:
        raise AssertionError("no two-chunk prompt behind enough prefilled "
                             "requests in the paged burst")
    return (dict(seed=11, plan={"device_step": [3], "prefill": [k]},
                 corrupting=("prefill",)), target, calls)


def watched_injector(eng, **plan):
    """A FaultInjector with ``plan`` that also notes, at each corrupting
    fire, what the engine had in flight: the time, the decoding lanes,
    the requests holding slots with their emitted token counts, and
    whether the head of the chunk queue is mid-prompt (a chunk done and
    one to go)."""
    from deeplearning4j_tpu_torch.faults import (CorruptedStateFault,
                                                 FaultInjector)

    class Watched(FaultInjector):
        def __init__(self):
            super().__init__(**plan)
            self.at_fault = []

        def fire(self, seam, worker=None):
            try:
                return super().fire(seam, worker)
            except CorruptedStateFault:
                chunks = getattr(eng, "_prefilling", ())
                self.at_fault.append(dict(
                    seam=seam, t=time.perf_counter(),
                    decoding=len(eng._ready_slots()),
                    in_flight=[(r, len(r.tokens))
                               for r in eng._slots.requests
                               if r is not None],
                    mid_chunk=bool(chunks) and chunks[0].idx > 0,
                    head=chunks[0].req if chunks else None))
                raise

    return Watched()


def ordered_streams(eng, reqs):
    """Submit every request as a stream from this thread, in list order
    (so admission follows it), and read each from a thread of its own
    that stamps every token's arrival. Returns the results, the
    arrival times, the requests' engine objects and the wall time. A
    failed request fails the run."""
    streams = []
    t0 = time.perf_counter()
    for r in reqs:
        streams.append(eng.stream(timeout_ms=600_000, **r))
    results = [None] * len(reqs)
    stamps = [[] for _ in reqs]
    errors = [None] * len(reqs)

    def read(i):
        try:
            for chunk in streams[i]:
                if "token" in chunk:
                    stamps[i].append(time.perf_counter())
                else:
                    results[i] = chunk
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[i] = e

    threads = [threading.Thread(target=read, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for i, e in enumerate(errors):
        if e is not None:
            raise RuntimeError(f"request {i} failed under the fault "
                               f"plan") from e
    return results, stamps, [s._req for s in streams], wall


def _pick(row, temp: float, top_k: int, u: float) -> int:
    """The engine's sampler on one logits row, in float64: the top-k
    filter, then the inverse CDF (in vocabulary order) at ``u``."""
    import torch
    if 0 < top_k < row.numel():
        row = torch.where(row < torch.topk(row, top_k).values[-1],
                          float("-inf"), row)
    c = torch.cumsum(torch.softmax(row / temp, -1), -1)
    return int(torch.argmax((c > u * c[-1]).int()))


def _reachable(r, temp: float, top_k: int, u: float, t: int,
               d: float) -> bool:
    """Whether some change of the logits ``r``, no entry moved by more
    than ``d``, makes the sampler (:func:`_pick`) pick token ``t``.

    With weights w_i = exp(logit_i / temp) over the top-k set F, the
    sampler picks t iff A <= u (A + W + C) < A + W, where A and C sum
    the weights of F's tokens before and after t in vocabulary order
    and W is t's: with D = (1 - u) A - u C, iff -(1 - u) W < D <= u W.
    F is a top-k set of the changed logits iff for some threshold h
    every member can reach h (logit + d >= h) and every token above h
    + d is a member; a member's weight then ranges from exp(max(logit -
    d, h) / temp) to exp((logit + d) / temp). For each breakpoint h
    (a logit +- d between the (k+1)-th logit - d and the k-th + d) the
    free members are chosen greedily to move D down (tokens after t by
    largest weight, then those before by smallest) or up (the mirror),
    t weighted at its largest, and D's range is tested."""
    import torch
    n = r.numel()
    top = float(r.max()) + d
    w_hi = torch.exp((r + d - top) / temp)
    before = torch.arange(n) < t
    after = torch.arange(n) > t
    if 0 < top_k < n:
        vals = torch.topk(r, top_k + 1).values
        lo_h, hi_h = float(vals[top_k]) - d, float(vals[top_k - 1]) + d
        band = r[(r >= lo_h - d) & (r <= hi_h + d)]
        hs = torch.cat([band - d, band + d, torch.tensor([lo_h, hi_h],
                                                         dtype=r.dtype)])
        hs = sorted({float(h) for h in hs if lo_h <= float(h) <= hi_h})
    else:
        hs = [None]
    for h in hs:
        if h is None:
            member = torch.ones(n, dtype=torch.bool)
            w_lo = torch.exp((r - d - top) / temp)
        else:
            eligible = r + d >= h
            forced = r - d > h
            if not eligible[t]:
                continue
            w_lo = torch.exp((torch.clamp(r - d, min=h) - top) / temp)
            forced[t] = True
            need = top_k - int(forced.sum())
            free = eligible & ~forced
            if need < 0 or int(free.sum()) < need:
                continue
        for down in (True, False):
            if h is not None:
                first = after if down else before
                second = before if down else after
                # free tokens that move D the wanted way, largest weight
                # first, then the others, smallest weight first
                key = torch.where(free & first, 2.0 + w_hi,
                                  torch.where(free & second, 1.0 - w_lo,
                                              torch.zeros_like(w_hi)))
                member = forced.clone()
                if need:
                    member[torch.topk(key, need).indices] = True
            a_lo, a_hi = float(w_lo[member & before].sum()), \
                float(w_hi[member & before].sum())
            c_lo, c_hi = float(w_lo[member & after].sum()), \
                float(w_hi[member & after].sum())
            w = float(w_hi[t])
            if (1 - u) * a_lo - u * c_hi <= u * w and \
                    (1 - u) * a_hi - u * c_lo > -(1 - u) * w:
                return True
    return False


def sample_gap(row, temp: float, top_k: int, u: float, a: int,
               b: int) -> float:
    """The sampled counterpart of a greedy logit gap: twice the smallest
    change d of the logits ``row`` (no entry moved by more than d) under
    which the engine's sampler at the request's uniform ``u`` picks
    ``a`` (:func:`_reachable`), and likewise ``b``; the larger of the
    two. A greedy choice of the top-k set may overstate it, never
    understate it; inf when even d = 1 does not reach a token."""
    r = row.double()
    worst = 0.0
    for t in (a, b):
        if _pick(r, temp, top_k, u) == t:
            continue
        if not _reachable(r, temp, top_k, u, t, 1.0):
            return float("inf")
        lo, hi = 0.0, 1.0
        for _ in range(30):
            mid = (lo + hi) / 2
            lo, hi = (lo, mid) if _reachable(r, temp, top_k, u, t, mid) \
                else (mid, hi)
        worst = max(worst, hi)
    return 2 * worst


def near_tie(rows_fn, cpu, req, got, want, tol):
    """The first position where a lane's tokens under faults (``got``)
    and fault-free (``want``) differ must be a near-tie of the reference
    (``rows_fn`` on the CPU copy, teacher-forced on the common prefix):
    a greedy lane's two tokens both within ``tol`` of the maximum logit
    (the teacher-forced check on each), a sampled lane's
    :func:`sample_gap` within ``tol``. Returns (the position, the
    gap)."""
    from deeplearning4j_tpu_torch.serving.generation import _uniforms
    p = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    row = rows_fn(cpu, req["prompt"], got[:p + 1])[p].double()
    a, b = got[p], want[p]
    if req["temperature"] <= 0:
        gap = float(row.max() - min(row[a], row[b]))
    else:
        u = float(_uniforms(np.array([req["seed"]], np.uint32),
                            np.array([p], np.int32))[0])
        gap = sample_gap(row, req["temperature"], req["top_k"], u, a, b)
    if gap > tol:
        raise AssertionError(f"a lane's tokens under faults differ from "
                             f"the fault-free run at position {p} "
                             f"({a} vs {b}) by more than a near-tie: gap "
                             f"{gap:.3e} (tol {tol:g})")
    return p, gap


def fault_ladder(eng, card, label, reqs, want, plan, cpu_fn, rows_fn, tol,
                 layers, planned_chunks=None, mid_chunk_target=None):
    """Phase 11 on a warmed engine of an earlier phase (through
    set_fault_injector, so no warmup or capture is added): ``reqs``
    again under the seeded ``plan``. No request may be lost, retries and
    recoveries must be what the plan fires (one each), nothing may be
    captured, the recovery must land while several lanes decode (and,
    with ``mid_chunk_target``, while that request is mid-chunk), and every
    lane's tokens must equal the fault-free ``want`` unless its first
    difference is a near-tie (:func:`near_tie`). The decode kernel must
    launch once per layer and decode step; on the slot backend the flash
    kernel once per layer and prefill, each request prefilled once and
    each re-admitted one once more; on the paged backend the chunks must
    outnumber the ``planned_chunks`` of a fault-free run. Prints the
    recovery's wall time, fault to the last re-admitted lane's next
    token."""
    from deeplearning4j_tpu_torch import kernels
    captures = eng.stats()["compile_cache"]["compiles"]
    st0 = eng.stats()
    inj = watched_injector(eng, **plan)
    eng.set_fault_injector(inj)
    try:
        reset_launches()
        results, stamps, objs, wall = ordered_streams(eng, reqs)
        launches = {k.split(".")[0] + k.split(".")[1][8:]: n
                    for k, n in kernels.launch_counts().items()
                    if n and "bf16" not in k}
    finally:
        eng.set_fault_injector(None)
    st = eng.stats()
    no_capture_since(eng, captures)
    check_lengths(results, reqs)
    faults = {k: st["faults"][k] - st0["faults"][k]
              for k in ("retries", "recoveries")}
    if faults != {"retries": 1, "recoveries": 1} or len(inj.at_fault) != 1:
        raise AssertionError(f"the plan fires one transient and one "
                             f"corrupting fault: {faults}, "
                             f"{len(inj.at_fault)} corrupting fires")
    snap = inj.at_fault[0]
    index = {id(r): i for i, r in enumerate(objs)}
    head = index.get(id(snap["head"]))
    if snap["decoding"] < 2 or (mid_chunk_target is not None and not (
            snap["mid_chunk"] and head == mid_chunk_target)):
        raise AssertionError(f"the recovery landed with {snap['decoding']} "
                             f"lanes decoding, request {head} at the head "
                             f"of the chunk queue (mid-chunk "
                             f"{snap['mid_chunk']}, aimed at "
                             f"{mid_chunk_target})")
    readmitted = [index[id(r)] for r, _ in snap["in_flight"]]
    # each re-admitted lane's next token is the first one it had not
    # emitted at the fault (its stamp is when its reader got it)
    nxt = [stamps[index[id(r)]][n] for r, n in snap["in_flight"]]
    recovery_ms = (max(nxt) - snap["t"]) * 1e3
    steps = st["decode_steps"] - st0["decode_steps"]
    prefills = st["prefills"] - st0["prefills"]
    chunks = (st["paged"]["prefill_chunks"]
              - st0["paged"]["prefill_chunks"]) if st["paged"] else None
    decode = [k for k in launches if "flash" not in k]
    if len(decode) != 1 or launches[decode[0]] != layers * steps \
            or not steps:
        raise AssertionError(f"launches {launches} over {steps} decode "
                             f"steps: one decode kernel, {layers} x steps")
    if chunks is None:
        if prefills != len(reqs) + len(readmitted) \
                or launches.get("flash_attention") != layers * prefills:
            raise AssertionError(
                f"{prefills} prefills for {len(reqs)} requests and "
                f"{len(readmitted)} re-admissions, launches {launches}")
    elif "flash_attention" in launches or chunks <= planned_chunks:
        raise AssertionError(f"{chunks} chunks (fault-free "
                             f"{planned_chunks}), launches {launches}")
    differ = [i for i, r in enumerate(results)
              if r["tokens"] != want[i]["tokens"]]
    ties, not_ties = [], []
    if differ:
        cpu = cpu_fn()
        for i in differ:
            try:
                ties.append((i,) + near_tie(rows_fn, cpu, reqs[i],
                                            results[i]["tokens"],
                                            want[i]["tokens"], tol))
            except AssertionError as e:
                not_ties.append(f"request {i}: {e}")
    out = dict(engine=label, requests=len(reqs), plan=plan["plan"],
               corrupting=list(plan["corrupting"]), **faults,
               decoding_at_fault=snap["decoding"],
               in_flight_at_fault=len(readmitted),
               mid_chunk_at_fault=snap["mid_chunk"],
               chunk_head_at_fault=head,
               recovery_ms=recovery_ms, wall_s=wall, decode_steps=steps,
               prefills=prefills, prefill_chunks=chunks, launches=launches,
               lanes_differing=len(differ), near_ties=ties,
               captures_after_warmup=captures)
    print(f"fault ladder [{card}] (phase 11, {label}): {len(reqs)} "
          f"requests under plan {plan['plan']} (corrupting "
          f"{list(plan['corrupting'])}): none lost, {faults['retries']} "
          f"retry, {faults['recoveries']} recovery with "
          f"{snap['decoding']} lanes decoding and {len(readmitted)} "
          f"requests re-admitted (mid-chunk: {snap['mid_chunk']}); "
          f"recovery {recovery_ms:.1f} ms from the fault to the last "
          f"re-admitted lane's next token; {len(differ)} lanes differ "
          f"from the fault-free run (near-ties as (request, position, "
          f"gap): {ties}); {prefills} "
          f"prefills, {chunks} chunks, {steps} decode steps, launches "
          f"{launches}; {captures} graphs captured at warmup, none "
          f"after")
    if not_ties:
        raise AssertionError("; ".join(not_ties))
    return out


#: phase 16b: the classifier's input length and classes, its buckets
PREDICT_T = 512
PREDICT_CLASSES = 16
PREDICT_BUCKETS = (1, 2, 4, 8, 16)
#: the key sets GET /stats has in the JAX package's InferenceServer
#: (``stats()`` and ``summary()``, deeplearning4j_tpu/serving/__init__.py
#: and registry.py): the CPU tests hold the port's to JAX's recursively;
#: here each model's block is also held to its engine's own snapshot
STATS_KEYS = {"summary", "models", "profiler"}
SUMMARY_KEYS = {"ready", "draining", "load", "shed", "client_disconnects",
                "models"}
MODEL_SUMMARY_KEYS = {"mode", "queue_depth", "queue_max", "active",
                      "capacity", "occupancy", "draining", "load", "shed"}
SERVED_KEYS = {"predict": {"version", "model_class", "batching"},
               "generation": {"version", "model_class", "serving_mode"}}


def http_call(port, method, path, body=None, stream=False, headers=None):
    """One HTTP request to the local server on its own connection.
    Returns (status, headers, parsed JSON body or, with ``stream``, the
    ndjson items, seconds to the first token item or None)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=None if body is None
                     else json.dumps(body), headers=headers or {})
        resp = conn.getresponse()
        hdrs = dict(resp.getheaders())
        if not stream or resp.status != 200:
            raw = resp.read()
            if path == "/metrics":
                return resp.status, hdrs, raw.decode(), None
            return resp.status, hdrs, json.loads(raw) if raw else None, None
        items, first = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            item = json.loads(line)
            if first is None and "token" in item:
                first = time.perf_counter() - t0
            items.append(item)
        return resp.status, hdrs, items, first
    finally:
        conn.close()


def _generate_clients(port, name, reqs, stream_every):
    """The client side of :func:`generate_over_http` (run in the client
    process): ``reqs`` at once, each from its own thread; every
    ``stream_every``-th (from the second) with ``"stream": true``."""
    results = [None] * len(reqs)
    errors = [None] * len(reqs)
    firsts = []

    def go(i):
        body = dict(reqs[i], timeout_ms=600_000)
        stream = stream_every and i % stream_every == stream_every - 1
        if stream:
            body["stream"] = True
        try:
            code, _, out, first = http_call(
                port, "POST", f"/v1/models/{name}/generate", body, stream)
            if code != 200:
                raise AssertionError(f"status {code}: {out}")
            if stream:
                toks = [o["token"] for o in out if "token" in o]
                if out[-1].get("done") is not True or \
                        out[-1]["tokens"] != toks:
                    raise AssertionError(f"stream's final item {out[-1]} "
                                         f"disagrees with its tokens {toks}")
                out = out[-1]
                firsts.append(first)
            results[i] = out
        except BaseException as e:  # noqa: BLE001 — reported below
            errors[i] = f"request {i}: {e!r}"

    t0 = time.perf_counter()
    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return dict(results=results, wall_s=time.perf_counter() - t0,
                firsts=firsts, errors=[e for e in errors if e])


def tokens_or_near_tie(label, reqs, got, want, cpu_fn):
    """Every lane's tokens must be ``want``'s (the phase's first run)
    unless its first difference is a near-tie of the CPU reference at
    the teacher tolerance (phase 11's rule). Returns how many lanes
    differed."""
    cpu = None
    differed = 0
    for q, g, w in zip(reqs, got, want):
        if g["tokens"] == w:
            continue
        differed += 1
        cpu = cpu or cpu_fn()
        near_tie(f32_rows, cpu, q, g["tokens"], w, TEACHER_TOL)
    print(f"  {label}: {len(reqs) - differed} of {len(reqs)} lanes' tokens "
          f"identical to the first run, {differed} differing at a near-tie")
    return differed


def stats_keys_check(port, srv):
    """``GET /stats`` must have the JAX server's key set at its own two
    levels, and each model's block its engine's snapshot keys plus the
    registry's."""
    code, _, st, _ = http_call(port, "GET", "/stats")
    if code != 200 or set(st) != STATS_KEYS \
            or set(st["summary"]) != SUMMARY_KEYS:
        raise AssertionError(f"/stats keys {sorted(st)}, summary "
                             f"{sorted(st.get('summary', {}))}")
    for name, m in st["models"].items():
        served = srv.served(name)
        mode = "generation" if hasattr(served, "generate") else "predict"
        want = set(served.metrics.snapshot()) | SERVED_KEYS[mode]
        if set(m) != want or \
                set(st["summary"]["models"][name]) != MODEL_SUMMARY_KEYS:
            raise AssertionError(f"/stats model {name!r}: keys "
                                 f"{sorted(set(m) ^ want)} differ")
    return st


def probes_check(port, names):
    """``/metrics`` parses with each model's families, ``/healthz`` and
    ``/readyz`` answer 200."""
    code, hdrs, text, _ = http_call(port, "GET", "/metrics")
    samples, types = parse_prometheus(text)
    for name in names:
        key = ("dl4j_model_requests_total", f'{{model="{name}"}}')
        if code != 200 or key not in samples:
            raise AssertionError(f"/metrics ({code}) lacks {key}")
    for path in ("/healthz", "/readyz"):
        code, _, body, _ = http_call(port, "GET", path)
        if code != 200:
            raise AssertionError(f"{path} answered {code}: {body}")
    return dict(families=len(types), samples=len(samples))


def classifier_conf(cfg):
    """Phase 16b's network: phase 9's embedding and encoder stack at the
    served width, non-causal, average-pooled into a 16-class softmax."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (GlobalPoolingLayer,
                                                    OutputLayer)
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        TransformerEncoderLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import \
        EmbeddingSequenceLayer
    b = (NeuralNetConfiguration.builder().seed(cfg["seed"])
         .updater(Adam(cfg["lr"])).weight_init("xavier").list()
         .layer(EmbeddingSequenceLayer(n_in=cfg["vocab_size"],
                                       n_out=cfg["d_model"])))
    for _ in range(cfg["n_layers"]):
        b = b.layer(TransformerEncoderLayer(n_heads=cfg["n_heads"],
                                            d_ff=cfg["d_ff"], causal=False))
    return (b.layer(GlobalPoolingLayer("avg"))
            .layer(OutputLayer(n_out=PREDICT_CLASSES, loss="mcxent",
                               activation="softmax"))
            .input_type_recurrent(1, timesteps=cfg["seq_len"]).build())


def predict_traffic(cfg, n=64, seed=16):
    """Phase 16b's 64 requests of 1-4 rows of token ids, from a fixed
    seed."""
    rs = np.random.RandomState(seed)
    return [rs.randint(0, cfg["vocab_size"],
                       (int(rs.randint(1, 5)), cfg["seq_len"])).tolist()
            for _ in range(n)]


def predict_rows_check(label, net, xs, outs):
    """Each row's output must be within FLASH_TOL of ``net.output`` on
    that row alone. Returns the worst error."""
    worst = 0.0
    for x, out in zip(xs, outs):
        for row, got in zip(x, out):
            want = net.output(np.asarray([row], np.float32))[0].cpu()
            worst = max(worst, float(np.abs(np.asarray(got)
                                            - want.numpy()).max()))
    if worst > FLASH_TOL:
        raise AssertionError(f"{label}: a served row is {worst:.3e} from "
                             f"net.output on it alone (tol {FLASH_TOL:g})")
    return worst


def _predict_clients(port, name, xs, clients):
    """The client side of :func:`predict_over_http` (run in the client
    process): ``xs`` over ``clients`` threads, each its share in turn."""
    outs = [None] * len(xs)
    lat = [None] * len(xs)
    errors = []

    def go(c):
        try:
            for i in range(c, len(xs), clients):
                t0 = time.perf_counter()
                code, _, body, _ = http_call(port, "POST",
                                             f"/v1/models/{name}/predict",
                                             {"inputs": xs[i]})
                lat[i] = time.perf_counter() - t0
                if code != 200:
                    raise AssertionError(f"status {code}: {body}")
                outs[i] = body["outputs"]
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=go, args=(c,)) for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return dict(outs=outs, wall_s=time.perf_counter() - t0, lat=lat,
                errors=errors)


def _loop_clients(port, name, reqs):
    """The client side of :func:`restart_traffic` (run in the client
    process): a thread a request, each posting it again and again (every
    other one streamed) until stdin closes, each answer a JSON line on
    stdout as it comes."""
    stop = threading.Event()
    lock = threading.Lock()

    def client(i):
        body = dict(reqs[i], timeout_ms=600_000)
        stream = i % 2 == 1
        while not stop.is_set():
            try:
                code, _, out, _ = http_call(
                    port, "POST", f"/v1/models/{name}/generate",
                    dict(body, stream=True) if stream else body, stream)
                line = ({"i": i, "tokens": out[-1]["tokens"] if stream
                         else out["tokens"]} if code == 200 else
                        {"i": i, "error": f"status {code}: {out}"})
            except Exception as e:  # noqa: BLE001 — reported to the parent
                line = {"i": i, "error": repr(e)}
            with lock:
                print(json.dumps(line), flush=True)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    sys.stdin.read()
    stop.set()
    for t in threads:
        t.join()
    return dict(errors=[])


def client_main():
    """The HTTP client process of phases 16 and 17: one job as a JSON
    line on stdin, its results as JSON on stdout. Only the standard
    library (and numpy) is imported, so the client shares no interpreter
    lock with the server."""
    job = json.loads(sys.stdin.readline())
    if job["kind"] == "generate":
        out = _generate_clients(job["port"], job["name"], job["reqs"],
                                job["stream_every"])
    elif job["kind"] == "loop":
        out = _loop_clients(job["port"], job["name"], job["reqs"])
    else:
        out = _predict_clients(job["port"], job["name"], job["xs"],
                               job["clients"])
    json.dump(out, sys.stdout)


def run_client(job: dict) -> dict:
    """Run one :func:`client_main` job in a process of its own (the load
    a server sees from its users, not from threads inside it); a failed
    request fails the run."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.client_main()"],
        input=json.dumps(job), capture_output=True, text=True, cwd=here,
        timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the HTTP client process failed: "
                           f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout)
    if out["errors"]:
        raise RuntimeError(f"HTTP requests to {job['name']} failed: "
                           f"{out['errors'][:3]}")
    return out


def generate_over_http(port, name, reqs, stream_every=2):
    """``reqs`` at once to ``/v1/models/<name>/generate``, each from its
    own thread of a client process; every ``stream_every``-th (from the
    second) with ``"stream": true``. Returns (results in ``reqs``'s order
    as {"tokens", "finish_reason", ...}, wall seconds, seconds to the
    first token of each stream)."""
    out = run_client(dict(kind="generate", port=port, name=name, reqs=reqs,
                          stream_every=stream_every))
    return out["results"], out["wall_s"], out["firsts"]


def predict_over_http(port, name, xs, clients=16):
    """``xs`` over ``clients`` threads of a client process (each its
    share in turn) to ``/v1/models/<name>/predict``. Returns (outputs in
    ``xs``'s order, wall seconds, each request's seconds)."""
    out = run_client(dict(kind="predict", port=port, name=name, xs=xs,
                          clients=clients))
    return out["outs"], out["wall_s"], out["lat"]


@contextlib.contextmanager
def recorded(reservoir):
    """The values ``reservoir`` records inside the block (a list that
    fills as they come)."""
    vals = []
    record = reservoir.record

    def keep(v):
        vals.append(float(v))
        record(v)
    reservoir.record = keep
    try:
        yield vals
    finally:
        del reservoir.record


def p50(xs):
    return float(np.percentile(xs, 50)) if len(xs) else None


def poll_until(cond, what: str, timeout_s: float = 30.0):
    """Wait for ``cond()`` (a state change made by another thread)."""
    t_end = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def drain_check(srv, port, reqs):
    """Streams in flight when ``drain()`` starts must finish; meanwhile
    ``/readyz`` and a new POST answer 503 with Retry-After."""
    import http.client
    conns, first = [], []
    for q in reqs:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/v1/models/lm/generate", body=json.dumps(
            dict(q, stream=True, timeout_ms=600_000)))
        resp = conn.getresponse()
        first.append(json.loads(resp.readline()))  # in flight
        conns.append((conn, resp))
    drained = []
    drainer = threading.Thread(target=lambda: drained.append(
        srv.drain(timeout_s=120.0)))
    drainer.start()
    try:
        poll_until(lambda: not srv.ready(), "drain() to flip readiness")
        code, hdrs, _, _ = http_call(port, "GET", "/readyz")
        post, phdrs, _, _ = http_call(port, "POST", "/v1/models/lm/generate",
                                      dict(prompt=[1, 2, 3], max_tokens=2))
        if code != 503 or "Retry-After" not in hdrs or post != 503 \
                or "Retry-After" not in phdrs:
            raise AssertionError(f"while draining /readyz answered {code} "
                                 f"{hdrs}, a new POST {post} {phdrs}")
        for (conn, resp), q, f in zip(conns, reqs, first):
            items = [f] + [json.loads(ln) for ln in resp.read().decode()
                           .splitlines() if ln.strip()]
            toks = [o["token"] for o in items if "token" in o]
            if len(toks) != q["max_tokens"] or items[-1].get("done") \
                    is not True:
                raise AssertionError(f"an in-flight stream did not finish "
                                     f"over the drain: {items[-1]}")
            conn.close()
    finally:
        drainer.join()
    if drained != [True]:
        raise AssertionError(f"drain() returned {drained}")
    return dict(readyz_while_draining=code, post_while_draining=post,
                streams_finished=len(reqs))


def serve_http(card: str, served4, served5, primer_tokens, cfg=SERVE_CFG,
               device=None, train_cfg=TRAIN_CFG):
    """Phase 16: the serving shell on the card (see the module doc).
    ``served4`` and ``served5`` are phases 4 and 5's ``served`` (their
    traffic and first-run tokens), ``primer_tokens`` phase 5's primer's
    tokens."""
    import torch
    from deeplearning4j_tpu_torch.kernels import decode_attention as da
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import InferenceServer
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    t_phase = time.perf_counter()
    reqs4, res4 = served4[1][0]
    primer, (burst, res5) = served5[0], served5[1][0]
    want5 = [r["tokens"] for r in res5]
    lm = CausalTransformerLM(**cfg, device=device).init()
    srv = InferenceServer(port=0)
    port = srv.port
    out = dict(backend=srv.http_backend)
    try:
        g = srv.register_generator("lm", lm, num_slots=32)
        pg = srv.register_generator("plm", lm, **PAGED_ENGINE)
        g.warmup()
        pg.warmup()
        caps = {n: warmed_compiles(s.engine) for n, s in (("lm", g),
                                                         ("plm", pg))}
        cpu_fn = (lambda: cpu_copy(lm, cfg))

        # (a) /generate: phase 4's 32 requests on the slot engine, half
        # of them streamed, then phase 5's primer and burst on the paged
        st0 = g.engine.stats()
        reset_launches()
        with recorded(g.engine.metrics.decode_step_ms) as half_steps:
            got4, wall4, firsts4 = generate_over_http(port, "lm", reqs4)
        st = g.engine.stats()
        ttft4 = st["ttft_ms"]
        steps = st["decode_steps"] - st0["decode_steps"]
        launches4 = dict(decode=da.launches, flash=fa.launches,
                         paged=pa.launches)
        if launches4["decode"] != cfg["n_layers"] * steps or not steps \
                or not launches4["flash"] or launches4["paged"]:
            raise AssertionError(f"16a slots: launches {launches4} over "
                                 f"{steps} decode steps")
        check_lengths(got4, reqs4)
        diff4 = tokens_or_near_tie("16a slots over HTTP", reqs4, got4,
                                   [r["tokens"] for r in res4], cpu_fn)
        n4 = sum(len(r["tokens"]) for r in got4)
        # informative reruns of the same requests: none streamed, all
        # streamed, and from client threads inside the server's own
        # process (sharing its interpreter lock)
        mix, mix_step = {}, {"half_streamed": p50(half_steps)}
        for label, every in (("none_streamed", 0), ("all_streamed", 1)):
            with recorded(g.engine.metrics.decode_step_ms) as steps_ms:
                got, wall, _ = generate_over_http(port, "lm", reqs4, every)
            tokens_or_near_tie(f"16a slots, {label.replace('_', ' ')}",
                               reqs4, got, [r["tokens"] for r in res4],
                               cpu_fn)
            mix[label] = n4 / wall
            mix_step[label] = p50(steps_ms)
        inproc = _generate_clients(port, "lm", reqs4, 2)
        if inproc["errors"]:
            raise RuntimeError(f"in-process clients: {inproc['errors'][:3]}")
        diff_in = tokens_or_near_tie(
            "16a slots, clients in the server's process", reqs4,
            inproc["results"], [r["tokens"] for r in res4], cpu_fn)

        pst0 = pg.engine.stats()
        reset_launches()
        code, _, primed, _ = http_call(port, "POST", "/v1/models/plm/generate",
                                       dict(primer, timeout_ms=600_000))
        if code != 200:
            raise AssertionError(f"the primer answered {code}: {primed}")
        got5, wall5, firsts5 = generate_over_http(port, "plm", burst)
        pst = pg.engine.stats()
        ttft5 = pst["ttft_ms"]
        psteps = pst["decode_steps"] - pst0["decode_steps"]
        launches5 = dict(decode=da.launches, flash=fa.launches,
                         paged=pa.launches)
        if launches5["paged"] != cfg["n_layers"] * psteps or not psteps \
                or launches5["decode"] or launches5["flash"]:
            raise AssertionError(f"16a paged: launches {launches5} over "
                                 f"{psteps} decode steps")
        check_lengths(got5, burst)
        diff5 = tokens_or_near_tie(
            "16a paged over HTTP",
            [dict(primer, temperature=0.0, top_k=0)] + burst,
            [primed] + got5, [primer_tokens] + want5, cpu_fn)
        n5 = sum(len(r["tokens"]) for r in got5)
        for name, s in (("lm", g), ("plm", pg)):
            no_capture_since(s.engine, caps[name])

        # the thread backend over the same registry: 4 of phase 4's
        # requests
        tsrv = InferenceServer(port=0, registry=srv.registry,
                               http_backend="thread")
        try:
            got_t, _, _ = generate_over_http(tsrv.port, "lm", reqs4[:4])
        finally:
            tsrv.stop()
        diff_t = tokens_or_near_tie("16a thread backend", reqs4[:4], got_t,
                                    [r["tokens"] for r in res4[:4]], cpu_fn)

        # (b) /predict through the micro-batcher: the classifier's 5
        # buckets captured at warmup, 64 requests from 16 clients
        pcfg = dict(train_cfg, seq_len=PREDICT_T)
        net = MultiLayerNetwork(classifier_conf(pcfg), device=device).init()
        cls = srv.register("cls", net, max_batch_size=PREDICT_BUCKETS[-1])
        t0 = time.perf_counter()
        cls.warmup(PREDICT_BUCKETS,
                   example=np.zeros((1, PREDICT_T), np.float32))
        pwarm = time.perf_counter() - t0
        cc = cls.metrics.snapshot()["compile_cache"]
        if cc["compiles"] != len(PREDICT_BUCKETS):
            raise AssertionError(f"16b: {cc['compiles']} captures at "
                                 f"warmup, not {len(PREDICT_BUCKETS)}")
        xs = predict_traffic(pcfg)
        b0 = cls.metrics.batches
        reset_launches()
        outs, pwall, lat = predict_over_http(port, "cls", xs)
        batches = cls.metrics.batches - b0
        plaunch = dict(flash=fa.launches, decode=da.launches,
                       paged=pa.launches)
        if plaunch["flash"] != pcfg["n_layers"] * batches or \
                plaunch["decode"] or plaunch["paged"]:
            raise AssertionError(f"16b: launches {plaunch} over {batches} "
                                 f"device calls: B3 must run "
                                 f"{pcfg['n_layers']} a call")
        if cls.metrics.compiles != len(PREDICT_BUCKETS):
            raise AssertionError("16b: a capture after warmup")
        worst = predict_rows_check("16b", net, xs, outs)
        rows = sum(len(x) for x in xs)

        # live weights: fit() updates the leaves in place, set_params()
        # replaces them; both must be served with no counted capture
        probe = xs[0][:1]
        before = np.asarray(http_call(port, "POST", "/v1/models/cls/predict",
                                      {"inputs": probe})[2]["outputs"])
        ids, labels = np.asarray(xs[1] + xs[2])[:4], np.zeros(
            (4, PREDICT_CLASSES), np.float32)
        labels[np.arange(4), np.arange(4)] = 1.0
        net.fit(ids, labels)
        after_fit = np.asarray(http_call(
            port, "POST", "/v1/models/cls/predict",
            {"inputs": probe})[2]["outputs"])
        fit_err = predict_rows_check("16b after fit", net, [probe],
                                     [after_fit])
        other = MultiLayerNetwork(classifier_conf(dict(pcfg, seed=1)),
                                  device=device).init()
        ewma, caps0 = cls.batcher._device_ewma_ms, cls.engine.captures
        net.set_params(other.params())
        after_set = np.asarray(http_call(
            port, "POST", "/v1/models/cls/predict",
            {"inputs": probe})[2]["outputs"])
        set_err = predict_rows_check("16b after set_params", net, [probe],
                                     [after_set])
        # the probe's bucket was captured again over the new leaves;
        # that call stays out of the batcher's device-time estimate, so
        # a budget of a few device calls is still admitted
        if cls.engine.captures != caps0 + 1 or not ewma or \
                cls.batcher._device_ewma_ms != ewma:
            raise AssertionError(
                f"16b: {cls.engine.captures - caps0} recaptures after "
                f"set_params, device estimate {ewma} -> "
                f"{cls.batcher._device_ewma_ms} ms")
        status = http_call(port, "POST", "/v1/models/cls/predict",
                           {"inputs": probe, "timeout_ms": 10 * ewma})[0]
        if status != 200:
            raise AssertionError(f"16b: a {10 * ewma:.1f} ms budget after "
                                 f"set_params answered {status}")
        moved = (float(np.abs(after_fit - before).max()),
                 float(np.abs(after_set - after_fit).max()))
        if min(moved) <= FLASH_TOL or \
                cls.metrics.compiles != len(PREDICT_BUCKETS):
            raise AssertionError(f"16b: the answer moved {moved} after fit "
                                 f"and set_params, compiles "
                                 f"{cls.metrics.compiles}")
        del other

        # probes, then the drain with streams in flight
        st_http = stats_keys_check(port, srv)
        prom = probes_check(port, ("lm", "plm", "cls"))
        drained = drain_check(srv, port, [
            dict(prompt=r["prompt"][:128], max_tokens=384, seed=r["seed"])
            for r in reqs4[:4]])
    finally:
        srv.stop()
    torch.cuda.synchronize()
    lat_ms = np.asarray(lat) * 1e3
    ttft = {"lm": ttft4, "plm": ttft5}
    out.update(
        generate=dict(
            slots=dict(tokens=n4, wall_s=wall4, tokens_per_s=n4 / wall4,
                       ttft_p50_ms=ttft["lm"]["p50"],
                       ttft_p99_ms=ttft["lm"]["p99"],
                       decode_step_p50_ms=st["decode_step_ms"]["p50"],
                       decode_step_p99_ms=st["decode_step_ms"]["p99"],
                       stream_first_token_p50_ms=float(
                           np.percentile(firsts4, 50) * 1e3),
                       lanes_differing=diff4, launches=launches4,
                       decode_steps=steps, captures=caps["lm"],
                       inproc_clients_tokens_per_s=n4 / inproc["wall_s"],
                       none_streamed_tokens_per_s=mix["none_streamed"],
                       all_streamed_tokens_per_s=mix["all_streamed"],
                       step_p50_ms_by_turn=mix_step,
                       inproc_clients_lanes_differing=diff_in),
            paged=dict(tokens=n5, wall_s=wall5, tokens_per_s=n5 / wall5,
                       ttft_p50_ms=ttft["plm"]["p50"],
                       ttft_p99_ms=ttft["plm"]["p99"],
                       decode_step_p50_ms=pst["decode_step_ms"]["p50"],
                       decode_step_p99_ms=pst["decode_step_ms"]["p99"],
                       stream_first_token_p50_ms=float(
                           np.percentile(firsts5, 50) * 1e3),
                       lanes_differing=diff5, launches=launches5,
                       decode_steps=psteps, captures=caps["plm"]),
            thread_backend_lanes_differing=diff_t),
        predict=dict(requests=len(xs), rows=rows, wall_s=pwall,
                     rows_per_s=rows / pwall,
                     request_p50_ms=float(np.percentile(lat_ms, 50)),
                     request_p99_ms=float(np.percentile(lat_ms, 99)),
                     device_calls=batches, mean_batch=rows / batches,
                     launches=plaunch, captures=cc["compiles"],
                     warmup_s=pwarm, max_abs_err=worst,
                     fit_err=fit_err, set_params_err=set_err,
                     moved_after_fit=moved[0],
                     moved_after_set_params=moved[1],
                     bucket_hist=st_http["models"]["cls"]["bucket_hist"]),
        prometheus=prom, drain=drained,
        seconds=time.perf_counter() - t_phase)
    return out


#: phase 17: the router's health poll, and how long a rolling restart
#: may wait for a replica to drain and for its rebuild to answer ready
FLEET_POLL_S = 0.05
FLEET_DRAIN_S = 120.0
FLEET_READY_S = 300.0
#: phase 17b: the client loops over phase 4's first prompts
RESTART_CLIENTS = 8
#: phase 17b: the device memory after the restarts, against before them
FLEET_MEMORY_RTOL = 0.05


def launches_by_thread():
    """Count the launches each thread's graph replays add (a replay adds
    its capture's tally through ``generation.add_launches`` on the
    engine's scheduler thread). Returns (counts keyed by thread ident,
    a function that stops counting)."""
    from deeplearning4j_tpu_torch.serving import generation
    counts = collections.defaultdict(collections.Counter)
    add = generation.add_launches

    def counting(c):
        counts[threading.get_ident()].update(c)
        add(c)
    generation.add_launches = counting
    return counts, lambda: setattr(generation, "add_launches", add)


def fleet_engines(fleet):
    """Each replica's "lm" and "plm" engines, by replica id."""
    return {rep.id: {name: rep.server.registry.get(name).engine
                     for name in ("lm", "plm")}
            for rep in fleet.replicas()}


def replica_launch_check(fleet, by_thread, steps0, n_layers, label):
    """Per replica: B1 = layers x its "lm" decode steps and B2 = layers x
    its "plm" decode steps since ``steps0``, B2 and B3 never on "lm"'s
    thread and B1 and B3 never on "plm"'s, and the kernels' counters
    (set to 0 before the traffic) are the engines' replays and nothing
    else. Returns the counts by replica."""
    from deeplearning4j_tpu_torch import kernels
    out, total = {}, collections.Counter()
    for rid, engs in fleet_engines(fleet).items():
        row = {}
        for name, key, others in (
                ("lm", "decode_attention.launches",
                 ("paged_attention.launches",)),
                ("plm", "paged_attention.launches",
                 ("decode_attention.launches",
                  "flash_attention.launches"))):
            eng = engs[name]
            c = by_thread.get(eng._thread.ident, collections.Counter())
            steps = eng.metrics.decode_steps - steps0[rid][name]
            if not steps or c[key] != n_layers * steps \
                    or any(c[k] for k in others):
                raise AssertionError(
                    f"{label}: replica {rid} {name!r}: launches "
                    f"{dict(c)} over {steps} decode steps")
            row[name] = dict(decode_steps=steps, launches=dict(c))
            total.update(c)
        out[rid] = row
    counted = {k: v for k, v in kernels.launch_counts().items() if v}
    if counted != {k: v for k, v in total.items() if v}:
        raise AssertionError(f"{label}: the kernels counted {counted}, the "
                             f"replicas' engines replayed {dict(total)}")
    return out


def fleet_no_capture(fleet, caps):
    """No engine of the fleet captured since ``caps`` (by replica id and
    name)."""
    for rid, engs in fleet_engines(fleet).items():
        for name, eng in engs.items():
            no_capture_since(eng, caps[rid][name])


def fleet_trace_check(port, req):
    """One request through the router with ``?trace=1`` (the router's
    trace) and ``"trace": 1`` (the replica's): both halves come back in
    the answer under one request id, with the router's pick and dispatch
    spans and the replica's queue, admission, prefill and decode
    spans."""
    rid = "fleet-trace-17a"
    code, hdrs, body, _ = http_call(
        port, "POST", "/v1/models/lm/generate?trace=1",
        dict(req, trace=1, timeout_ms=600_000),
        headers={"X-Request-Id": rid})
    if code != 200:
        raise AssertionError(f"17a trace: status {code}: {body}")
    rt, tr = body.get("router_trace") or {}, body.get("trace") or {}
    rkinds = {sp["kind"] for sp in rt.get("spans", [])}
    kinds = {sp["kind"] for sp in tr.get("spans", [])}
    ids = {hdrs.get("X-Request-Id"), rt.get("trace_id"), tr.get("trace_id")}
    if not ({"pick", "dispatch"} <= rkinds and {
            "queue", "admission", "prefill", "decode"} <= kinds
            and ids == {rid}):
        raise AssertionError(f"17a trace: router spans {sorted(rkinds)}, "
                             f"replica spans {sorted(kinds)}, ids {ids}")
    return dict(router_spans=sorted(rkinds), replica_spans=sorted(kinds),
                tokens=body["tokens"])


def restart_traffic(fleet, port, reqs):
    """Phase 17b: a client process loops over ``reqs`` through the
    router, a thread a request (every other one streamed), while
    ``fleet.rolling_restart()`` rebuilds every replica; the loops start
    before it and each gets one more answer after it. Returns (every
    answer's tokens by request, the restart's result, its wall seconds
    by replica, its wall seconds, failures)."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.client_main()"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=here)
    proc.stdin.write(json.dumps(dict(kind="loop", port=port, name="lm",
                                     reqs=reqs)) + "\n")
    proc.stdin.flush()
    answers = [[] for _ in reqs]
    failures = []

    def read():
        for line in proc.stdout:
            d = json.loads(line)
            if "i" not in d:
                continue
            if "tokens" in d:
                answers[d["i"]].append(d["tokens"])
            else:
                failures.append(f"request {d['i']}: {d['error']}")
    reader = threading.Thread(target=read)
    reader.start()
    spans, marks = {}, {}
    cordon, uncordon = fleet.cordon, fleet.uncordon

    def timed_cordon(rid):
        marks[rid] = time.perf_counter()
        cordon(rid)

    def timed_uncordon(rid):
        uncordon(rid)
        spans[rid] = time.perf_counter() - marks[rid]
    fleet.cordon, fleet.uncordon = timed_cordon, timed_uncordon
    try:
        poll_until(lambda: all(answers) or failures, "17b traffic", 600)
        t0 = time.perf_counter()
        ok = fleet.rolling_restart(drain_timeout_s=FLEET_DRAIN_S,
                                   ready_timeout_s=FLEET_READY_S)
        wall = time.perf_counter() - t0
        after = [len(a) for a in answers]
        poll_until(lambda: all(len(a) > n for a, n in zip(answers, after))
                   or failures, "17b traffic after the restarts", 600)
    finally:
        del fleet.cordon, fleet.uncordon
        proc.stdin.close()
        proc.wait(timeout=900)
        reader.join()
    if proc.returncode != 0:
        failures.append(f"the client process exited {proc.returncode}")
    return answers, ok, spans, wall, failures


def device_memory() -> int:
    """Allocated device bytes once every dropped object is collected."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def serve_fleet(card: str, served4, served5, primer_tokens, cfg=SERVE_CFG,
                device=None):
    """Phase 17: the fleet on the card (see the module doc). ``served4``
    and ``served5`` are phases 4 and 5's ``served`` (their traffic and
    first-run tokens), ``primer_tokens`` phase 5's primer's tokens."""
    from deeplearning4j_tpu_torch.serving import (FleetRouter,
                                                  InferenceServer,
                                                  ReplicaFleet)
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    t_phase = time.perf_counter()
    reqs4, res4 = served4[1][0]
    want4 = [r["tokens"] for r in res4]
    primer = served5[0]
    (burst, res5), (turn1, res1), (turn2, res2) = served5[1]
    lm = CausalTransformerLM(**cfg, device=device).init()
    cpu_fn = (lambda: cpu_copy(lm, cfg))
    builds = []

    def factory():
        """A warmed replica: "lm" with phase 4's configuration and "plm"
        with phase 5's, over the one model; each captures its plan."""
        t0 = time.perf_counter()
        srv = InferenceServer(port=0)
        for name, kw in (("lm", dict(num_slots=32)), ("plm", PAGED_ENGINE)):
            srv.register_generator(name, lm, **kw).warmup()
        caps = {name: warmed_compiles(srv.registry.get(name).engine)
                for name in ("lm", "plm")}
        builds.append(dict(seconds=time.perf_counter() - t0,
                           captures=caps))
        return srv

    def captures(fleet):
        return {rid: {n: warmed_compiles(e) for n, e in engs.items()}
                for rid, engs in fleet_engines(fleet).items()}

    fleet = ReplicaFleet(poll_interval_s=FLEET_POLL_S)
    routers = []
    by_thread, unhook = launches_by_thread()
    try:
        for _ in range(2):
            fleet.add(factory(), factory=factory)
        router = FleetRouter(fleet, tracing=True)
        routers.append(router)
        _, port = router.serve()
        caps = captures(fleet)

        # (a) phase 4's requests on "lm" and phase 5's traffic on "plm"
        # through the router, each half streamed, from a client process
        steps0 = {rid: {n: e.metrics.decode_steps for n, e in engs.items()}
                  for rid, engs in fleet_engines(fleet).items()}
        routed0 = {rep.id: rep.routed for rep in fleet.replicas()}
        lm_ttft = [recorded(engs["lm"].metrics.ttft_ms)
                   for engs in fleet_engines(fleet).values()]
        by_thread.clear()
        reset_launches()
        with contextlib.ExitStack() as stack:
            ttfts = [stack.enter_context(r) for r in lm_ttft]
            got4, wall4, firsts4 = generate_over_http(port, "lm", reqs4)
        ttft_ms = [v for vals in ttfts for v in vals]
        del lm_ttft, ttfts
        check_lengths(got4, reqs4)
        bad = [i for i, (g, w) in enumerate(zip(got4, want4))
               if g["tokens"] != w]
        if bad:
            raise AssertionError(f"17a: lanes {bad} of phase 4's requests "
                                 f"differ from phase 4 through the router")
        n4 = sum(len(r["tokens"]) for r in got4)
        code, _, primed, _ = http_call(port, "POST", "/v1/models/plm/generate",
                                       dict(primer, timeout_ms=600_000))
        if code != 200:
            raise AssertionError(f"17a: the primer answered {code}: {primed}")
        got5, wall5, firsts5 = generate_over_http(port, "plm", burst)
        got1, _, _ = generate_over_http(port, "plm", turn1)
        # turn 2 builds on the fleet's own turn 1, as a client would
        tails = [t2["prompt"][len(t1["prompt"]) + len(r1["tokens"]):]
                 for t1, r1, t2 in zip(turn1, res1, turn2)]
        turn2_fleet = [dict(t2, prompt=t1["prompt"] + g1["tokens"] + tail)
                       for t1, g1, t2, tail in zip(turn1, got1, turn2, tails)]
        got2, _, _ = generate_over_http(port, "plm", turn2_fleet)
        check_lengths(got5 + got1 + got2, burst + turn1 + turn2_fleet)
        same1 = [i for i, (g, r) in enumerate(zip(got1, res1))
                 if g["tokens"] == r["tokens"]]
        diff5 = tokens_or_near_tie(
            "17a paged through the router",
            [dict(primer, temperature=0.0, top_k=0)] + burst
            + turn1 + [turn2[i] for i in same1],
            [primed] + got5 + got1 + [got2[i] for i in same1],
            [primer_tokens] + [r["tokens"] for r in res5]
            + [r["tokens"] for r in res1] + [res2[i]["tokens"]
                                             for i in same1], cpu_fn)
        n5 = sum(len(r["tokens"]) for r in got5)
        launches = replica_launch_check(fleet, by_thread, steps0,
                                        cfg["n_layers"], "17a")
        fleet_no_capture(fleet, caps)
        session_hits = {rid: engs["plm"].stats()["paged"]["prefix_cache"]
                        ["session_hits"]
                        for rid, engs in fleet_engines(fleet).items()}
        fm = fleet.metrics
        if sum(session_hits.values()) != len(turn1) or \
                fm.session_affinity_hits != len(turn1):
            raise AssertionError(f"17a: session hits {session_hits}, "
                                 f"affinity hits {fm.session_affinity_hits}"
                                 f": a turn 2 missed its turn 1's replica")
        routed = {rep.id: rep.routed - routed0[rep.id]
                  for rep in fleet.replicas()}
        if min(routed.values()) * 4 < sum(routed.values()):
            raise AssertionError(f"17a: requests by replica {routed}")
        trace = fleet_trace_check(port, reqs4[0])
        if trace["tokens"] != want4[0]:
            raise AssertionError("17a trace: tokens differ from phase 4")
        _, _, stats, _ = http_call(port, "GET", "/stats")
        fs = stats["fleet"]
        if fs["requests"] != fs["responses"] + fs["streams"] or \
                fs["requests_lost"] or fs["server_errors"] or \
                fs["client_errors"]:
            raise AssertionError(f"17a: the router's /stats {fs}")

        # (b) a rolling restart under phase 4's first prompts, greedy
        reqs8 = [dict(q, temperature=0.0, top_k=0)
                 for q in reqs4[:RESTART_CLIENTS]]
        before = [http_call(port, "POST", "/v1/models/lm/generate",
                            dict(q, timeout_ms=600_000))[2]["tokens"]
                  for q in reqs8]
        restarts0 = fm.restarts
        mem0 = device_memory()
        answers, ok, spans, rwall, failures = restart_traffic(
            fleet, port, reqs8)
        mem1 = device_memory()
        wrong = [i for i, a in enumerate(answers)
                 if any(t != before[i] for t in a)]
        if not ok or failures or wrong or \
                fm.restarts - restarts0 != 2 or fm.requests_lost:
            raise AssertionError(
                f"17b: restart ok {ok}, restarts {fm.restarts - restarts0}, "
                f"lost {fm.requests_lost}, failures {failures[:3]}, lanes "
                f"differing from the restart-free run {wrong}")
        caps_after = captures(fleet)
        if [b["captures"] for b in builds[2:]] != list(caps_after.values()):
            raise AssertionError(f"17b: the rebuilt replicas captured "
                                 f"{builds[2:]} at warmup, {caps_after} "
                                 f"by now")
        if abs(mem1 - mem0) > FLEET_MEMORY_RTOL * mem0:
            raise AssertionError(f"17b: {mem1} bytes allocated after the "
                                 f"restarts, {mem0} before (rtol "
                                 f"{FLEET_MEMORY_RTOL:g})")

        # (c) the thread backend: 4 of phase 4's requests, 2 streamed
        trouter = FleetRouter(fleet)
        routers.append(trouter)
        _, tport = trouter.serve(backend="thread")
        got_t, _, _ = generate_over_http(tport, "lm", reqs4[:4])
        if [g["tokens"] for g in got_t] != [g["tokens"] for g in got4[:4]]:
            raise AssertionError("17c: the thread backend's tokens differ "
                                 "from 17a's")
        _, _, stats, _ = http_call(port, "GET", "/stats")
    finally:
        unhook()
        for r in routers:
            r.stop()
        fleet.stop(stop_replicas=True)
    fs = stats["fleet"]
    return dict(
        replicas=len(fleet.replicas()), captures=caps,
        builds=builds, launches=launches,
        tokens_per_s=n4 / wall4, tokens=n4, wall_s=wall4,
        ttft_p50_ms=float(np.percentile(ttft_ms, 50)),
        ttft_p99_ms=float(np.percentile(ttft_ms, 99)),
        stream_first_token_p50_ms=float(np.percentile(firsts4, 50) * 1e3),
        paged_tokens_per_s=n5 / wall5,
        paged_stream_first_token_p50_ms=float(
            np.percentile(firsts5, 50) * 1e3),
        paged_lanes_differing=diff5, session_hits=session_hits,
        routed=routed, trace=trace,
        restart=dict(ok=ok, wall_s=rwall, seconds_by_replica=spans,
                     answers=sum(len(a) for a in answers),
                     rebuild_s=[b["seconds"] for b in builds[2:]],
                     memory_before=mem0, memory_after=mem1,
                     captures_after=caps_after),
        router_stats={k: fs[k] for k in (
            "requests", "responses", "streams", "retries", "requests_lost",
            "restarts", "routed", "session_affinity_hits", "sheds",
            "server_errors", "client_errors")},
        seconds=time.perf_counter() - t_phase)


def all_blocks_back(eng, when: str = "") -> int:
    """Release the session pins and the prefix index; every block of
    the pool must then be free. Returns the free count."""
    eng.evict_sessions()
    eng.clear_prefix_cache()
    free, total = eng._allocator.free_count, eng._allocator.capacity
    if free != total:
        raise AssertionError(f"blocks leaked{when}: {free} of {total} free "
                             f"after the caches were cleared")
    return free


def warmed_compiles(eng) -> int:
    """Graph captures after warmup: exactly the engine's ``graph_plan``
    (the decode step and every bucket of the JAX engine's warm set)
    where it replays CUDA graphs (the card's default), none for the
    engine with no graph."""
    n = eng.stats()["compile_cache"]["compiles"]
    plan = eng.graph_plan() if eng._cuda_graph else []
    buckets = {k for k in plan if k[0] not in ("decode", "propose")}
    if n != len(plan) or set(eng._graphs) != buckets:
        raise AssertionError(f"{n} captures after warmup, graphs "
                             f"{sorted(eng._graphs)}: the plan is "
                             f"{plan} (CUDA graph {eng._cuda_graph})")
    return n


def no_capture_since(eng, captures: int):
    """Nothing may be captured once the engine is warm."""
    n = eng.stats()["compile_cache"]["compiles"]
    if n != captures:
        raise AssertionError(f"{n - captures} graph captures after "
                             f"warmup")


def graph_memory(eng) -> dict:
    """The captures' wall time and the bytes the per-bucket graphs'
    shared memory pool holds (its segments in the allocator's snapshot;
    None where the snapshot names no pools)."""
    import torch
    pool, mib = eng._graph_pool, None
    if pool is not None:
        segs = torch.cuda.memory_snapshot()
        if segs and "segment_pool_id" in segs[0]:
            mib = sum(x["total_size"] for x in segs
                      if tuple(x["segment_pool_id"]) == tuple(pool)) / 2**20
    return dict(captures=eng.stats()["compile_cache"]["compiles"],
                capture_ms=eng._capture_ms, graph_pool_mib=mib)


def count_calls(eng) -> dict:
    """Count the engine's per-bucket device calls by graph key (a
    wrapper over ``_device_call``); returns the live dict."""
    calls = {}
    call = eng._device_call

    def counted(key, *a, **k):
        calls[key] = calls.get(key, 0) + 1
        return call(key, *a, **k)
    eng._device_call = counted
    return calls


def busiest_replay(eng, calls: dict, kind: str):
    """The most called ``kind`` graph of this run, replayed alone on the
    card: its device ms a replay (:func:`time_ms`) and the kernels one
    replay runs (torch.profiler), beside its call count. Only where
    nothing live can be overwritten: the replay writes its last call's
    slot or blocks again (all free by then)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    keys = [k for k in calls if k[0] == kind and k in eng._graphs]
    if not keys:
        return None
    key = max(keys, key=lambda k: calls[k])
    graph = eng._graphs[key][0]
    ms = time_ms(graph.replay)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return dict(key=list(key), calls=calls[key], replay_ms=ms,
                kernels=kernels)


def replay_line(r) -> str:
    if r is None:
        return ""
    return (f"; busiest graph {tuple(r['key'])}: {r['calls']} calls, one "
            f"replay alone {r['replay_ms']:.3f} ms on the device over "
            f"{r['kernels']} kernels")


def graph_line(g: dict) -> str:
    mib = g["graph_pool_mib"]
    return (f"{g['captures']} graphs captured at warmup in "
            f"{g['capture_ms']:.1f} ms, none after; shared graph pool "
            + ("not measured" if mib is None else f"{mib:.1f} MiB"))


def eager_run(lm, engine_kw, reqs, results, primer=None):
    """``reqs`` again (after ``primer``, when given), on an engine with
    no CUDA graph at all (the private ``_cuda_graph`` switched off before
    warmup: the decode step, prefills, chunks and copies all eager):
    every request's tokens must be those of the graphed run
    (``results``). Returns its step and throughput numbers."""
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    eng = GenerationEngine(lm, **engine_kw)
    eng._cuda_graph = False
    try:
        eng.warmup()
        warmed_compiles(eng)
        if primer is not None:
            eng.generate(timeout_ms=600_000, **primer)
        got, wall = run_requests(eng, reqs)
        st = eng.stats()
    finally:
        eng.stop()
    same = sum(a["tokens"] == b["tokens"] for a, b in zip(got, results))
    if same != len(reqs):
        raise AssertionError(f"the eager engine gave other tokens than the "
                             f"CUDA graphs: {same} of {len(reqs)} identical")
    n_tok = sum(len(r["tokens"]) for r in got)
    return dict(identical=f"{same}/{len(reqs)}", wall_s=wall,
                tokens_per_s=n_tok / wall,
                ttft_p50_ms=st["ttft_ms"]["p50"],
                prefill_p50_ms=st["prefill_ms"]["p50"],
                decode_step_p50_ms=st["decode_step_ms"]["p50"],
                decode_step_p99_ms=st["decode_step_ms"]["p99"],
                decode_sync_wait_p50_ms=st["decode_sync_wait_ms"]["p50"],
                decode_sync_wait_p99_ms=st["decode_sync_wait_ms"]["p99"])


def check_lengths(results, reqs):
    """Every request must run its full length (eos_id is None)."""
    for r, q in zip(results, reqs):
        if r["finish_reason"] != "length" or \
                len(r["tokens"]) != q["max_tokens"]:
            raise AssertionError(f"request did not run its length: {r}")


def print_profile(label: str, card: str, prof: dict):
    print(f"{label} [{card}] (8 requests, prompt 256, 16 tokens, "
          f"profiler on): device busy {prof['busy_share']:.3f} of "
          f"{prof['wall_ms']:.1f} ms, {prof['device_kernels']} device "
          f"kernels over {prof['prefills']} prefills and "
          f"{prof['decode_steps']} decode steps; top kernels (ms): "
          + ", ".join(f"{n[:60]} {t:.3f}" for n, t in prof["top"]))


def run_requests(eng, reqs):
    """Submit every request at once from its own thread; returns the
    results and the wall time. A failed request fails the run."""
    results = [None] * len(reqs)
    errors = [None] * len(reqs)

    def go(i):
        try:
            results[i] = eng.generate(timeout_ms=600_000, **reqs[i])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[i] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for i, e in enumerate(errors):
        if e is not None:
            raise RuntimeError(f"request {i} failed") from e
    return results, wall


def profile_window(eng):
    """Kernel time by name and the device's busy share over a short
    window of traffic on the warmed engine, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    reqs = [dict(prompt=list(range(1, 257)), max_tokens=16, seed=i)
            for i in range(8)]
    st0 = eng.stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        _, wall = run_requests(eng, reqs)
        torch.cuda.synchronize()
    st1 = eng.stats()
    kernels = {}
    n_kernels = 0
    host = []
    for e in p.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append((e.key, e.self_cpu_time_total / 1e3, e.count))
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
        n_kernels += e.count
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    # the port's own kernels, whether or not they are among the top
    ours = {n: t for n, t in kernels.items() if PORT_KERNEL.search(n)}
    return dict(wall_ms=wall * 1e3, busy_ms=busy_ms,
                busy_share=busy_ms / (wall * 1e3), top=top, ours=ours,
                device_kernels=n_kernels,
                decode_steps=st1["decode_steps"] - st0["decode_steps"],
                prefills=st1["prefills"] - st0["prefills"])


def sass_counts():
    """Tensor-core instructions per instantiation of the flash kernels
    (f32 and bf16 legs): HMMA (``mma.sync``) and HGMMA (``wgmma``), each
    with its bf16 form; I2F (I2F, I2FP) in the two int8 kernels; and in
    each instantiation of B1's kernel (<type, load bytes, lanes a row,
    vectors a lane>) its 16-byte global loads (LDG128) and local-memory
    accesses (LOCAL: LDL, STL); in the built libraries, from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    from deeplearning4j_tpu_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    kernel = re.compile(r"(flash_fwd_kernel|flash_bwd_dq_kernel|"
                        r"flash_bwd_dkv_kernel|flash_fwd_bf16_kernel|"
                        r"flash_bwd_dq_bf16_kernel|flash_bwd_dkv_bf16_kernel|"
                        r"paged_attention_int8_kernel|"
                        r"decode_attention_int8_kernel)"
                        r"ILi(\d+)E(?:Li(\d+)E)?")
    opcode = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9]*)(\.[A-Za-z0-9.]*)?")
    split = re.compile(r"(decode_attention_split_kernel)I(f|13__nv_bfloat16)"
                       r"Li(\d+)ELi(\d+)ELi(\d+)E")
    counts = {}
    for lib in ("flash_attention", "paged_attention", "decode_attention"):
        text = subprocess.run([tool, "-sass", str(_build._lib_path(lib))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        fn = None
        for line in text.splitlines():
            if "Function :" in line:
                m, b1 = kernel.search(line), split.search(line)
                fn = (f"{m[1]}<{m[2]}" + (f",{m[3]}>" if m[3] else ">")
                      if m else None)
                if b1:
                    fn = (f"{b1[1]}<{'f32' if b1[2] == 'f' else 'bf16'},"
                          f"{b1[3]},{b1[4]},{b1[5]}>")
                if fn:
                    counts[fn] = {"HMMA": 0, "HMMA_BF16": 0, "HGMMA": 0,
                                  "HGMMA_BF16": 0, "I2F": 0, "LDG128": 0,
                                  "LOCAL": 0}
                continue
            op = opcode.search(line) if fn else None
            if op and op[1] == "LDG" and ".128" in (op[2] or ""):
                counts[fn]["LDG128"] += 1
            elif op and op[1] in ("LDL", "STL"):
                counts[fn]["LOCAL"] += 1
            elif op and op[1] in ("HMMA", "HGMMA"):
                counts[fn][op[1]] += 1
                if ".BF16" in (op[2] or ""):
                    counts[fn][op[1] + "_BF16"] += 1
            elif op and op[1] in ("I2F", "I2FP"):
                counts[fn]["I2F"] += 1
    return counts


#: the kernels on wgmma (bf16 HGMMA, no HMMA) at every head-dim bucket
WGMMA_KERNELS = ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                 "flash_bwd_dkv_bf16_kernel")


def check_sass(counts):
    """The bf16 forward, dQ and dK/dV kernels must run on wgmma (bf16
    HGMMA, no HMMA) at each head-dim bucket (32, 64, 128); every other
    flash kernel on mma.sync (HMMA); both int8 kernels must convert int8
    without I2F (0); B1's instantiations with 16-byte loads (every
    head dim that is a multiple of 16 bytes, with aligned caches) must
    issue them (LDG.128) and use no local memory (the narrower ones, for
    odd head dims and misaligned caches, may spill a word)."""
    def bad(f, c):
        if f.split("<")[0] in WGMMA_KERNELS:
            return not c["HGMMA_BF16"] or c["HMMA"]
        if f.startswith("decode_attention_split"):
            return f.split(",")[1] == "16" and (c["LOCAL"] or not c["LDG128"])
        return ((f.startswith("flash") and not c["HMMA"])
                or ("int8" in f and c["I2F"]))
    wrong = [f for f, c in counts.items() if bad(f, c)]
    missing = [f"{k}<{d}>" for k in WGMMA_KERNELS for d in (32, 64, 128)
               if f"{k}<{d}>" not in counts]
    kinds = {f.split("<")[0] for f in counts}
    if wrong or missing or len(kinds) != 9:
        raise AssertionError(f"SASS: the bf16 forward, dQ and dK/dV kernels "
                             f"must run bf16 HGMMA and no HMMA at D 32, 64, "
                             f"128 (missing {missing}), the f32 flash "
                             f"kernels HMMA, the int8 kernels no I2F, B1 "
                             f"LDG.128 and no local memory: {wrong} in "
                             f"{counts}")


AB_CODE = r"""
import importlib.util, json, sys, torch
import chip_smoke as cs
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
dev = torch.device("cuda")
card = cs.card_line()
out = {"flash_ms": {}}
g = torch.Generator(device="cpu").manual_seed(2)
for B in (1, 4):
    q, k, v = (torch.randn((B, 1024, 8, 64), generator=g).to(dev)
               for _ in range(3))
    km = torch.ones((B, 1024), device=dev)
    out["flash_ms"][B] = cs.time_ms(lambda: fa.flash_attention(q, k, v, True,
                                                               km))
    if B == 4:  # the backward kernels at the training shape
        do = torch.randn((B, 1024, 8, 64), generator=g).to(dev)
        o, lse = fa.flash_attention(q, k, v, True, km)
        args = (q, k, v, km, do, lse, fa.backward_delta(do, o), True)
        out["dq_ms"] = cs.time_ms(lambda: fa.flash_attention_bwd_dq(*args))
        out["dkv_ms"] = cs.time_ms(lambda: fa.flash_attention_bwd_dkv(*args))
# the bf16 legs at the training shape, and the whole bf16 backward
qb, kb, vb, dob = (torch.randn((4, 1024, 8, 64), generator=g).to(dev)
                   .bfloat16() for _ in range(4))
km = torch.ones((4, 1024), device=dev)
ob, lseb = fa.flash_attention(qb, kb, vb, True, km)
args = (qb, kb, vb, km, dob, lseb, fa.backward_delta(dob, ob), True)
out["bf16_ms"] = dict(
    fwd=cs.time_ms(lambda: fa.flash_attention(qb, kb, vb, True, km)),
    dq=cs.time_ms(lambda: fa.flash_attention_bwd_dq(*args)),
    dkv=cs.time_ms(lambda: fa.flash_attention_bwd_dkv(*args)),
    whole_bwd=cs.time_ms(lambda: fa.flash_attention_bwd(qb, kb, vb, km, ob,
                                                        lseb, dob, True)))
out["bf16_ms"]["pair"] = out["bf16_ms"]["dq"] + out["bf16_ms"]["dkv"]
dec = cs.check_decode(dev)
out["decode_ms"] = dec["float32"]["ms"]
out["decode_bf16_ms"] = dec["bfloat16"]["ms"]
out["decode_draft_ms"] = cs.check_decode(dev, S=64, H=2, D=16,
                                         bf16=False)["float32"]["ms"]
# B1, B2, B4 and B5 at the lengths phases 4 to 7 serve, through this
# checkout's kernels and the calling script's timing code
spec = importlib.util.spec_from_file_location("cs_this", sys.argv[1])
this = importlib.util.module_from_spec(spec)
spec.loader.exec_module(this)
out["served_decode"] = this.served_decode_ms(dev)
out["paged_ms"] = cs.check_paged(dev)["float32"]["ms"]
out["paged_int8_ms"] = cs.check_paged_int8(dev)["ms"]
out["decode_int8_ms"] = cs.check_decode_int8(dev)["ms"]
out["serving"] = {}
served = {}
# phases 4 and 7 with phase 11's fault reruns on their engines
for phase, run in ((4, lambda: cs.serve(card, chaos=True)),
                   (5, lambda: cs.serve_paged(card)),
                   (6, lambda: cs.serve(card, kv_dtype="int8")),
                   (7, lambda: cs.serve_paged(card, kv_dtype="int8",
                                              chaos=True))):
    e = run()
    served[phase] = e.pop("served")
    prof = e["profile"]
    out["serving"][phase] = dict(
        {k: e.get(k) for k in ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                               "prefill_p50_ms", "prefill_chunk_p50_ms",
                               "decode_step_p50_ms", "decode_step_p99_ms",
                               "decode_sync_wait_p50_ms",
                               "decode_sync_wait_p99_ms", "warmup_s")},
        recovery_ms=(e["fault_ladder"] or {}).get("recovery_ms"),
        window={k: prof[k] for k in ("busy_share", "busy_ms", "wall_ms",
                                     "device_kernels", "decode_steps",
                                     "ours")})
# phase 12 on phases 4 and 5's traffic
out["spec"] = {}
for label, phase, paged in (("12a", 4, False), ("12b", 5, True)):
    e = cs.serve_spec(card, served[phase], paged=paged)
    out["spec"][label] = {k: e.get(k) for k in (
        "tokens_per_s", "verify_p50_ms", "draft_call_p50_ms", "ttft_p50_ms",
        "decode_step_p50_ms", "warmup_s")}
    out["spec"][label]["busy_share"] = e["profile"]["busy_share"]
tr = cs.train(card, cfg=dict(cs.TRAIN_CFG, dtype="bfloat16"))  # phase 10
out["train_bf16"] = dict(
    {k: tr[k] for k in ("step_p50_ms", "enqueue_p50_ms", "step_ms",
                        "enqueue_ms")},
    device_ms_by_kind=tr["profile"]["by_kind"])
print("AB " + json.dumps(out))
"""


AB_TRAIN_CODE = r"""
import json, sys
import chip_smoke as cs
card = cs.card_line()
out = {}
for phase, cfg in ((9, cs.TRAIN_CFG), (10, dict(cs.TRAIN_CFG, dtype="bfloat16"))):
    tr = cs.train(card, cfg=cfg, steps=int(sys.argv[2]))
    prof = tr["profile"]
    out[phase] = dict(
        {k: tr[k] for k in ("step_p50_ms", "enqueue_p50_ms", "step_ms",
                            "enqueue_ms")},
        device_kernels=prof["device_kernels"], busy_share=prof["busy_share"],
        host_top=prof.get("host_top"))
print("AB " + json.dumps(out))
"""
AB_TRAIN_STEPS = 20   # timed steps of each phase in each --ab-train turn


def run_ab(parent: str, code: str = AB_CODE, *args: str) -> int:
    """``--ab PARENT``: the parent checkout's and this checkout's own
    code in turns (parent, this, this, parent), each in a process of its
    own: B3 at B=1 and B=4, B6 and B7 at B=4, the bf16 legs of B3, B6
    and B7 and the whole bf16 backward at B=4, B1 (f32 and bf16, and at
    the draft's shape), B2, B4 and B5 (their phase-3 checks), the four
    decode kernels at the lengths phases 4 to 7 serve
    (``served_decode_ms`` of this script, on each checkout's kernels),
    phases 4 to 7 with their profile windows (tokens/s, TTFT p50/p99,
    prefill or chunk p50, decode step), phase 11's recovery ms on phases
    4 and 7's engines, phase 12 (tokens/s, verify and draft call p50) on
    both backends, and phase 10's step p50, enqueue p50 and device time
    by kind; prints each turn as JSON, then all of them on one "A/B
    runs:" line. ``--ab-train PARENT`` turns the same way over phases 9
    and 10 alone (``AB_TRAIN_STEPS`` timed steps each, and one profiled
    step's kernels, busy share and host ops)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    card = card_line()
    print(f"device: {card}")
    runs = []
    for label, root in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", code,
                               os.path.abspath(__file__), *args], cwd=root,
                              capture_output=True, text=True, timeout=1500)
        if proc.returncode:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            raise RuntimeError(f"A/B turn {label} failed")
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        runs.append(dict(label=label, **json.loads(line[-1][3:])))
        print(f"A/B {label}: {json.dumps(runs[-1])}")
    print("A/B runs: " + json.dumps(dict(card=card, runs=runs)))
    print(card)
    return 0


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--ab"]:
        return run_ab(sys.argv[2])
    if sys.argv[1:2] == ["--ab-train"]:
        return run_ab(sys.argv[2], AB_TRAIN_CODE, str(AB_TRAIN_STEPS))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--graph"]:
        # phase 21 alone: it builds no kernel
        res = graph_phase(card_line())
        print("GRAPH " + json.dumps(res, default=str))
        return 0
    if sys.argv[1:2] == ["--conv"]:
        # phase 22 alone: it builds no kernel
        res = conv_phase(card_line())
        print("CONV " + json.dumps(res, default=str))
        return 0
    if sys.argv[1:2] == ["--detect"]:
        # phase 23 alone: it builds no kernel
        res = detect_phase(card_line())
        print("DETECT " + json.dumps(res, default=str))
        return 0
    if sys.argv[1:2] == ["--keras"]:
        # phase 25 alone: it builds no kernel
        res = keras_phase(card_line())
        print("KERAS " + json.dumps(res, default=str))
        return 0
    if sys.argv[1:2] == ["--parallel"]:
        # phase 24 alone: the kernels are built here, before the ranks
        from deeplearning4j_tpu_torch.kernels import _build
        _build.build()
        res = parallel_phase(card_line())
        print("PARALLEL " + json.dumps(res, default=str))
        return 0
    from deeplearning4j_tpu_torch.kernels import _build
    dev = torch.device("cuda")
    card = card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in sorted(logs.items()):
        for line in log["ptxas"].splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    sass = sass_counts()
    if sass is not None:
        check_sass(sass)
    print(f"SASS HMMA, HGMMA and I2F counts per kernel instantiation: "
          f"{'not measured (no cuobjdump)' if sass is None else sass}")

    decode = check_decode(dev)
    decode_dims = check_decode_dims(dev)
    decode_bits = check_decode_bits(dev)
    flash = check_flash(dev)
    paged = check_paged(dev)
    decode8 = check_decode_int8(dev)
    paged8 = check_paged_int8(dev)
    # the default draft's head dim at phase 12b's shapes (its proposals
    # over the paged engine's slots, and its primes)
    decode_draft = check_decode(dev, S=PAGED_ENGINE["num_slots"], H=2, D=16,
                                bf16=False)["float32"]
    flash_draft = check_flash_draft(dev)
    served_decode = served_decode_ms(dev)
    # phases 4 to 7; phase 11 (the fault ladder) runs on the warmed
    # engines of phases 4 and 7 after their fault-free runs, phase 12
    # (speculation) on their traffic and against their tokens
    e2e = serve(card, eager_ab=True, chaos=True, traced=True)
    e2e_paged = serve_paged(card, eager_ab=True, traced=True)
    e2e_int8 = serve(card, kv_dtype="int8")
    e2e_paged_int8 = serve_paged(card, kv_dtype="int8", chaos=True)
    served4, served5 = e2e["served"], e2e_paged["served"]
    spec = serve_spec(card, e2e.pop("served"), paged=False, traced=True)
    spec_paged = serve_spec(card, e2e_paged.pop("served"), paged=True)
    e2e_bf16 = serve(card, kv_dtype="bf16")  # phase 13: B1's bf16 leg
    for e in (e2e_int8, e2e_paged_int8, e2e_bf16):
        e.pop("served")
    # phase 14: the hierarchical KV tier at f32 (B2) and on phase 7's
    # int8 copy (B5), beside phases 5 and 7's hot-session turn-2 TTFT
    offload = serve_offload(
        card, hot_turn2_ttft_ms=e2e_paged["turn2_ttft_p50_ms"], traced=True)
    # phase 15 (traced serving) ran on the warmed engines of phases 4, 5,
    # 12a and 14
    added = sum(e["traced"]["wall_s"] for e in (e2e, e2e_paged, spec))
    print(f"traced serving (phase 15): trace_overhead_frac "
          f"{e2e['traced']['trace_overhead_frac']:.4f} (slots), "
          f"{e2e_paged['traced']['trace_overhead_frac']:.4f} (paged), not "
          f"gated; 15a-15c added {added:.2f} s; 15d traced phase 14's "
          f"turn 2 and added no run")
    offload8 = serve_offload(
        card, "int8", hot_turn2_ttft_ms=e2e_paged_int8["turn2_ttft_p50_ms"])
    print(f"offload host cost (phase 14): "
          f"{offload['host_bytes_per_token']:.1f} (f32) vs "
          f"{offload8['host_bytes_per_token']:.1f} (int8) host bytes per "
          f"demoted token, {offload['sessions_per_host_gib']:.1f} vs "
          f"{offload8['sessions_per_host_gib']:.1f} sessions per host GiB")
    # phase 16: the serving shell over HTTP, against phases 4 and 5
    shell = serve_http(card, served4, served5, e2e_paged["primer_tokens"])
    gen, pred = shell["generate"], shell["predict"]
    for tag, direct in (("slots", e2e), ("paged", e2e_paged)):
        h = gen[tag]
        print(f"serving shell (phase 16a, {shell['backend']}) [{card}]: "
              f"{tag} over HTTP {h['tokens_per_s']:.1f} tokens/s, TTFT "
              f"p50/p99 {h['ttft_p50_ms']:.1f}/{h['ttft_p99_ms']:.1f} ms, "
              f"streams' first token p50 "
              f"{h['stream_first_token_p50_ms']:.1f} ms, decode step "
              f"p50/p99 {h['decode_step_p50_ms']:.2f}/"
              f"{h['decode_step_p99_ms']:.2f} ms, beside the direct "
              f"engine's {direct['tokens_per_s']:.1f} tokens/s, "
              f"{direct['ttft_p50_ms']:.1f}/{direct['ttft_p99_ms']:.1f} ms "
              f"and {direct['decode_step_p50_ms']:.2f}/"
              f"{direct['decode_step_p99_ms']:.2f} ms "
              f"(phase {4 if tag == 'slots' else 5})"
              + (f"; {h['none_streamed_tokens_per_s']:.1f} tokens/s with "
                 f"none streamed, {h['all_streamed_tokens_per_s']:.1f} with "
                 f"all, {h['inproc_clients_tokens_per_s']:.1f} with the "
                 f"clients in the server's process; decode step p50 "
                 f"{h['step_p50_ms_by_turn']['half_streamed']:.3f} ms half "
                 f"streamed, "
                 f"{h['step_p50_ms_by_turn']['none_streamed']:.3f} none, "
                 f"{h['step_p50_ms_by_turn']['all_streamed']:.3f} all"
                 if tag == "slots" else "")
              + f"; {h['lanes_differing']} "
              f"lanes differing at a near-tie, launches {h['launches']} "
              f"over {h['decode_steps']} decode steps, {h['captures']} "
              f"captures at warmup, none after")
    print(f"serving shell (phase 16b) [{card}]: /predict {pred['rows']} rows "
          f"in {pred['requests']} requests at {pred['rows_per_s']:.1f} "
          f"rows/s, request p50/p99 {pred['request_p50_ms']:.1f}/"
          f"{pred['request_p99_ms']:.1f} ms, {pred['device_calls']} device "
          f"calls (mean {pred['mean_batch']:.2f} rows), launches "
          f"{pred['launches']}, {pred['captures']} captures, max err "
          f"{pred['max_abs_err']:.3e} (tol {FLASH_TOL:g}), after fit "
          f"{pred['fit_err']:.3e}, after set_params "
          f"{pred['set_params_err']:.3e}; drain {shell['drain']}; phase 16 "
          f"added {shell['seconds']:.2f} s")
    # phase 17: the fleet, two replicas behind the router
    fleet = serve_fleet(card, served4, served5, e2e_paged["primer_tokens"])
    rs = fleet["restart"]
    print(f"fleet (phase 17a) [{card}]: {fleet['replicas']} replicas "
          f"behind the router (aio), phase 4's requests at "
          f"{fleet['tokens_per_s']:.1f} tokens/s beside phase 16's "
          f"{gen['slots']['tokens_per_s']:.1f} on one replica, TTFT "
          f"p50/p99 {fleet['ttft_p50_ms']:.1f}/{fleet['ttft_p99_ms']:.1f} "
          f"ms, streams' first token p50 "
          f"{fleet['stream_first_token_p50_ms']:.1f} ms; phase 5's burst "
          f"{fleet['paged_tokens_per_s']:.1f} tokens/s, "
          f"{fleet['paged_lanes_differing']} paged lanes differing at a "
          f"near-tie; requests by replica {fleet['routed']}, session hits "
          f"{fleet['session_hits']}, launches {fleet['launches']}, "
          f"captures {fleet['captures']}, none after; router "
          f"{fleet['router_stats']}; trace spans {fleet['trace']}")
    print(f"fleet (phase 17b) [{card}]: rolling restart of both replicas "
          f"under {RESTART_CLIENTS} client loops in {rs['wall_s']:.2f} s "
          f"(by replica, cordon to uncordon: "
          f"{ {k: round(v, 3) for k, v in rs['seconds_by_replica'].items()} } "
          f"s; rebuilds {[round(x, 3) for x in rs['rebuild_s']]} s), "
          f"{rs['answers']} answers all equal to the restart-free run, "
          f"none lost; device memory {rs['memory_before']} bytes before, "
          f"{rs['memory_after']} after (rtol {FLEET_MEMORY_RTOL:g}); "
          f"17c thread-backend router: tokens equal 17a's; phase 17 added "
          f"{fleet['seconds']:.2f} s")
    bwd = check_flash_bwd(dev)
    bf16 = check_flash_bf16(dev)
    trained = train(card)
    trained_bf16 = train(card, cfg=dict(TRAIN_CFG, dtype="bfloat16"))
    cnn = cnn_training(card)   # phase 18
    # phase 19: remat on phase 9's net, checkpoint and resume, the
    # recurrent stack
    remat = remat_train(card)
    resume = resume_train(card)
    rnn = rnn_training(card)
    # phase 20: transfer learning, pure-bf16 params, resilient training
    t20 = time.perf_counter()
    transfer = transfer_train(card, phase9=trained)
    pure_bf16 = bf16_train(card)
    resilient = resilient_train(card)
    print(f"phase 20 added {time.perf_counter() - t20:.1f} s")
    # phase 21: ComputationGraph, the zoo's ResNet-50 trained and served,
    # the other graphs against CPU copies
    gc.collect()
    torch.cuda.empty_cache()
    graph = graph_phase(card)
    # phase 22: the conv family, the zoo's Xception (trained, bf16,
    # served), UNet, NASNet and Darknet19
    gc.collect()
    torch.cuda.empty_cache()
    conv = conv_phase(card)
    # phase 23: layerwise pretraining, the specialized heads, the zoo's
    # YOLO2 (trained, bf16, served) and TinyYOLO
    gc.collect()
    torch.cuda.empty_cache()
    detect = detect_phase(card)
    # phase 24: data-parallel training, ParallelWrapper at one worker
    # here and two rank processes on the card
    gc.collect()
    torch.cuda.empty_cache()
    parallel = parallel_phase(card)
    # phase 25: Keras import, the committed fixtures and MobileNetV2 at
    # its published width
    gc.collect()
    torch.cuda.empty_cache()
    keras = keras_phase(card)
    print("KERAS " + json.dumps(keras, default=str))
    print(f"phase 20c took {resilient['seconds']:.1f} s without its two "
          f"epoch-end archive writes; phase 23 took "
          f"{detect['seconds']:.1f} s; phase 24 took "
          f"{parallel['seconds']:.1f} s")
    dp_launches = {k: parallel["one"]["dense"]["launches"][k]
                   + sum(r[mode]["launches"][k]
                         for r in parallel["ranks_24b"]
                         for mode in ("dense", "update", "gradient"))
                   for k in ("flash_attention", "flash_attention_bwd_dq",
                             "flash_attention_bwd_dkv")}

    def row(name, src, replaces, launches, res):
        return dict(name=name, route="cuda",
                    source=f"deeplearning4j_tpu_torch/csrc/{src}",
                    replaces=f"deeplearning4j_tpu/kernels/{replaces}",
                    launches=launches,
                    **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")})

    kernels = [
        row("decode_attention", "decode_attention.cu",
            "decode_attention.py:100",
            e2e["launches"]["decode_attention"], decode["float32"]),
        row("decode_attention_bf16", "decode_attention.cu",
            "decode_attention.py:100",
            e2e_bf16["launches"]["decode_attention"], decode["bfloat16"]),
        row("flash_attention", "flash_attention.cu", "flash_attention.py:65",
            e2e["launches"]["flash_attention"], flash),
        row("paged_attention", "paged_attention.cu", "paged_attention.py:80",
            e2e_paged["launches"]["paged_attention"], paged["float32"]),
        row("decode_attention_int8", "decode_attention.cu",
            "decode_attention.py:143",
            e2e_int8["launches"]["decode_attention_int8"], decode8),
        row("paged_attention_int8", "paged_attention.cu",
            "paged_attention.py:130",
            e2e_paged_int8["launches"]["paged_attention_int8"], paged8),
        row("flash_attention_bwd_dq", "flash_attention.cu",
            "flash_attention.py:169",
            trained["launches"]["flash_attention_bwd_dq"], bwd["dq"]),
        row("flash_attention_bwd_dkv", "flash_attention.cu",
            "flash_attention.py:214",
            trained["launches"]["flash_attention_bwd_dkv"], bwd["dkv"]),
        row("flash_attention_bf16", "flash_attention.cu",
            "flash_attention.py:65",
            trained_bf16["launches"]["flash_attention_bf16"], bf16["fwd"]),
        row("flash_attention_bwd_dq_bf16", "flash_attention.cu",
            "flash_attention.py:169",
            trained_bf16["launches"]["flash_attention_bwd_dq_bf16"],
            bf16["dq"]),
        row("flash_attention_bwd_dkv_bf16", "flash_attention.cu",
            "flash_attention.py:214",
            trained_bf16["launches"]["flash_attention_bwd_dkv_bf16"],
            bf16["dkv"]),
        # the same kernels at the default draft's head dim (D=16):
        # phase 12b's proposals (B1) and draft primes (B3), as counted
        # there (the paged target runs neither)
        row("decode_attention_draft_d16", "decode_attention.cu",
            "decode_attention.py:100", spec_paged["b1_launches"],
            decode_draft),
        row("flash_attention_draft_d16", "flash_attention.cu",
            "flash_attention.py:65", spec_paged["b3_launches"],
            flash_draft),
        # phase 24's launches of the f32 legs (24a's dense run and every
        # rank's 24b runs, the references not counted), beside the same
        # kernels' timings above
        row("flash_attention_dp", "flash_attention.cu",
            "flash_attention.py:65", dp_launches["flash_attention"], flash),
        row("flash_attention_bwd_dq_dp", "flash_attention.cu",
            "flash_attention.py:169", dp_launches["flash_attention_bwd_dq"],
            bwd["dq"]),
        row("flash_attention_bwd_dkv_dp", "flash_attention.cu",
            "flash_attention.py:214",
            dp_launches["flash_attention_bwd_dkv"], bwd["dkv"]),
    ]
    print("details: " + json.dumps(
        dict(card=card, decode=decode, decode_dims=decode_dims,
             decode_bits=decode_bits, served_decode=served_decode,
             e2e_bf16=e2e_bf16, flash=flash, paged=paged,
             decode_int8=decode8, paged_int8=paged8,
             decode_draft=decode_draft, flash_draft=flash_draft, e2e=e2e,
             e2e_paged=e2e_paged, e2e_int8=e2e_int8,
             e2e_paged_int8=e2e_paged_int8, spec=spec,
             spec_paged=spec_paged, offload=offload,
             offload_int8=offload8, serving_shell=shell, fleet=fleet,
             flash_bwd=bwd, flash_bf16=bf16,
             train=trained, train_bf16=trained_bf16, cnn=cnn,
             remat=remat, resume=resume, rnn=rnn, transfer=transfer,
             pure_bf16=pure_bf16, resilient=resilient, graph=graph,
             conv=conv, detect=detect, parallel=parallel, keras=keras,
             build={n: l["seconds"] for n, l in logs.items()}, sass=sass),
        default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
