#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

Run ``python3 chip_smoke.py`` from the root of a checkout on a machine with
an NVIDIA H100 and the CUDA toolkit. It builds the port's CUDA kernels from
``bigdl_tpu_torch/kernels/csrc``, then:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. prints the build time and, for every instance of the three flash
   kernels (forward, dq, dk/dv), its registers and spills (``ptxas -v``),
   threads, dynamic shared memory and the count of ``HGMMA`` (tensor-core)
   and ``UTMALDG`` (TMA) instructions in its SASS (``cuobjdump -sass``); a
   zero count or a spill fails;
3. times an empty kernel launched through the C interface (the launch
   floor), then holds each kernel against its plain PyTorch version on the
   card (the LayerNorm forward at every main-path shape: (8, 512), the
   paged tick's (16, 512) and the verify chunk's (80, 512),
   (700, 512), (2·512, 512), (16·512, 512) fp32 and bf16, (1024, 256), and
   the bf16 step's (16·512, 512) and (2·512, 512) with bf16 gamma and
   beta; the LayerNorm backward at (16·512, 512) fp32, bf16 and bf16 with
   bf16 gamma, (2·512, 512) fp32 and bf16 with bf16 gamma, with dgamma and
   dbeta bitwise equal across two calls; the flash forward
   and the two flash backward kernels at (2, 8, T, 64) with T in
   {1024, 1000}, causal
   and not, fp32/bf16, and the forward also at the main paths' causal
   (2·8, 512, 64) and (16·8, 512, 64) in fp32 and bf16, the backward at
   the training step's (16·8, 512, 64) causal in fp32 and bf16; both at
   the seq2seq step's (32·8, 256, 64) non-causal and (32·8, 257, 64)
   causal in fp32 and bf16, with LayerNorm at its (32·256, 512) and
   (32·257, 512)), and times
   the kernel, the plain version and the one PyTorch call that computes
   the same function (a yardstick only; the port never calls it). fp32
   flash rows carry two bounds: FMA (fp32 at 67 TFLOP/s) and 3xTF32 (the
   kernels' three TF32 products at 495 TFLOP/s);
4. runs the full-sequence forward of the served model,
   ``TransformerLM(32000, 512, 8, 6, 1024)`` with seeded random weights, on
   a (2, 512) batch through both forward kernels, against the same weights
   on the CPU with the plain LayerNorm and ``attention_impl="full"``;
5. serves 16 requests (prompt lengths 17..700, 32 new tokens each) from 4
   client threads through ``ServingEngine(lm, max_len=1024, slots=8)``,
   whose prefill, decode and assign programs run as captured CUDA graphs,
   twice on the same engine (the first round captures each program at its
   first use, the second replays only; each round's decode rate, tick,
   prefill and TTFT), and holds every request's tokens against the port's
   solo ``greedy_generate``; checks the engine's program ledger
   (``compiled_programs`` = buckets used + 2, within ``len(buckets) + 2``)
   and that every model call launched the LayerNorm forward 13 times; then
   times one decode step of the slot grid eagerly and as a replayed graph
   (device and host), with the replayed step's log-probs and launches held
   against the eager step's;
6. trains the repo's training configuration,
   ``TransformerLM(32000, 512, 8, 6, max_len=512)`` with ``lm_criterion()``:
   the loss and every parameter's gradient of one (2, 512) step against the
   same weights on the CPU (``attention_impl="full"``), then 17 steps of
   ``LocalOptimizer`` with ``SGD(0.01, momentum=0.9, dampening=0)`` at
   batch 16 × 512 on ``synthetic_ptb`` windows (the step a captured graph,
   replayed after its first step), every loss finite, with the step time
   and tokens/s and one profiled replayed step (device time by kernel name,
   the GEMMs' share, the device's busy share, ``cudaLaunchKernel`` and
   ``cudaGraphLaunch`` calls), and again with ``set_fuse_steps(8)``; each
   of the two runs is held against the same steps run eagerly on the card
   (losses, parameters, launches); then the same under the bf16
   mixed-precision policy (``Engine.init(compute_dtype=torch.bfloat16)``,
   the JAX training leg's default): one (2, 512) step's loss and master
   gradients against the port's plain bf16 step on the CPU, the two timed
   runs with their eager comparisons and a profiled step, with the bf16
   step time and tokens/s beside the fp32 ones, then 17 bf16 steps with
   the flat update and 17 with every block under ``Remat`` (their step
   times; remat's losses within 1e-4 relative of the plain run's);
7. runs the llama-style path at full width, depth cut to 3 layers,
   ``TransformerLM(32000, 512, 8, 3)`` with 2 KV heads, RoPE, RMSNorm, SwiGLU and the fused head
   (``lm_criterion(fused_head=True)``, chunks of 8192): one (2, 256) step
   of a 2-layer, 8192-token llama model on the card against the CPU plain
   model in fp32 (loss 1e-4, gradients 1e-3) and bf16 (1e-2, 5e-2); 17
   bf16 ``LocalOptimizer`` steps at 16 x 512, fuse 1 and
   ``set_fuse_steps(8)``, replays bitwise equal to eager steps with equal
   launches; three bf16 steps with dropout 0.1 on one batch, whose two
   replays draw different masks; the head's forward and backward at (8192,
   512) x 32000, fused against the unfused bf16 head, with their bounds and
   peak memory; then, with ``max_len=1024``, the (2, 512) forward against
   the CPU plain model, two serving rounds of phase 5's 16 requests
   (tokens equal to ``greedy_generate``, the cache at KV-head width), and
   one ``SequenceBeamSearch`` (beam 3, decode 32, a 128-token seed; the
   flash forward at (3·8, 160, 64)) against ``beam_generate``;
8. runs the vision path at full width, NHWC, with cuDNN's deterministic
   algorithms (autotuned in each bf16 program's eager warm-up, cuDNN's
   heuristic choice for the one-step check and fp32): ``ImageNormalize
   -> ResNet(1000, depth 50, ImageNet, conv1SpaceToDepth)``, the JAX bench's
   resnet50 leg; one (2, 224, 224, 3) uint8 step's loss, gradients and
   running statistics on the card against the CPU in fp32 and bf16 (the
   gradients' limits measured: the CPU's NCHW step against its NHWC step,
   the CPU's bf16 step against its fp32 step); 17 bf16 steps of
   ``LocalOptimizer`` at batch 256 on 8 in-memory batches, fuse 1 and
   ``set_fuse_steps(8)``, each bitwise equal to the same steps run eagerly
   (losses, parameters, running statistics), with step ms, images/s, the
   share of the bf16 dense peak, peak memory, the first window and one
   profiled replayed step split into convolutions, batch norm and
   elementwise glue, pooling and the rest; 17 fp32 steps beside them;
   ``Top1Accuracy`` and ``Top5Accuracy`` over 868 held-out images (a padded
   last batch) through the captured eval program, equal to the host folds
   of eager logits; ``fuse_conv_bn``'s folded inference against the
   unfused model at batch 256 in fp32 and bf16, timed; and the LeNet-5 and
   VGG-for-CIFAR training mains on the card, whose losses must fall;
9. serves the extras at full width with the phase-5 model (its launches
   counted from a reset): ``ServingEngine(lm, 1024, slots=16, pages=512,
   page_tokens=16)``, the 8-slot grid's KV bytes, serves phase 5's 16
   requests twice (tokens bitwise the grid's, peak residency at least 2x
   the grid's, no page held after the drain; decode rate, tick and TTFT
   beside the grid's), then fails a request queued behind its full grid
   and one mid-decode with ``RequestTimeout`` on an injected clock (rows
   and pages recycled, the others' tokens the grid's); an exhausted
   96-page pool, the 16 requests queued longest first before the first
   prefill (``admit_wait_ms``), so that its preemptions do not hang on
   the clients' timing (at least one, every token solo decode's);
   ``overload="shed"`` (``EngineOverloaded`` with ``pages_free``) and
   ``"degrade"`` (half the new tokens) on a held pool; the prefix pool
   (``prefix_pool=16``) against a pool-less engine on a 512-token prefix
   with eight 33..64-token tails and a repeat (each tail a hit at 512
   through the 64 bucket, the repeat no prefill, tokens the pool-less
   engine's under the near-tie rule; warm against cold TTFT); the
   speculative engine (k = 4) on the grid and paged with the target as its
   own draft (acceptance exactly 1) and with a 256-wide 2-layer draft,
   tokens solo decode's under the near-tie rule, tokens/s against plain
   decode; ``SpeculativeDecoder`` on a (4, 8) batch against
   ``greedy_generate``; every engine's ledger within ``len(buckets) + 2``
   and its LayerNorm launches (13 a target call, 5 a draft call); one
   replayed paged tick and one replayed speculative step bitwise equal to
   eager runs (tokens, log-probs, live pages, the draft's cache, positions)
   and the paged tick to the slot grid's, with their device and host ms;
11. checkpoints, preempts, resumes and rolls back the trainer at full
   width (its launches counted from a reset): phase 6's LM, a checkpoint
   every 4 of 17 iterations keeping the newest 2, in fp32 at fuse 1 and
   in bf16 at ``set_fuse_steps(8)``: the uninterrupted run's files (the
   two newest versions) and its ``TrainSummary`` Loss (every iteration,
   equal to the run's losses); ``sigterm@9`` (``TrainingPreempted`` at
   JAX's iteration) and a fresh model resumed with ``resume="auto"``;
   ``nonfinite_loss@11`` (one rollback, the step program kept) with the
   write of version 16 torn, then a fresh resume that quarantines it and
   falls back to version 12, written synchronously, and profiled (fp32:
   ``set_profile`` over iterations 13-15, whose Chrome trace names the
   five kernels); fp32 with ``set_check_numerics(True)`` against without;
   every resumed, rolled-back and checked run bitwise the uninterrupted
   run's (losses and parameters); checkpoint bytes, loop-thread stalls
   (async and sync), writer seconds, resume seconds; then ResNet-50 (bf16,
   NHWC, batch 64, 6 iterations, a checkpoint at 3, ``sigterm@4``),
   whose resumed parameters and running statistics are bitwise the
   uninterrupted run's;
12. runs the trainer's feed at full width (its launches counted from a
   reset): phase 6's LM in fp32 at fuse 1 and in bf16 at
   ``set_fuse_steps(8)``, each with ``set_prefetch(2)`` against
   ``set_prefetch(0)`` (losses and parameters bitwise equal), and
   ``sigterm@9`` resumed with ``resume="auto"`` and the producer running
   (bitwise the uninterrupted run), with step ms, the loop's feed wait a
   step and the ``FeedStage`` stack and h2d ms; the native batchpack built
   and the ring pinned; then Inception-v1, the bench's inception leg
   (``ImageNormalize -> Inception_v1_NoAuxClassifier(1000,
   has_dropout=False)``, NHWC, uint8 224x224x3 at batch 256, 8 in-memory
   batches, SGD(0.01, momentum 0.9, dampening 0)): one (2, 224, 224, 3)
   step of ``Inception_v1`` with its aux heads into
   ``ParallelCriterion(repeat_target=True)`` against the CPU (fp32 loss
   1e-4, gradients by phase 8's rule; bf16 within limits measured from the
   CPU's bf16-vs-fp32 gaps); 17 steps in bf16 and fp32 through
   ``set_prefetch(2)`` with ``BIGDL_DEVICE_CACHE=0`` (bf16 replays bitwise
   equal to eager steps) and with the cache on, with step ms, images/s,
   the share of the bf16 peak (2.525 TFLOP a step), peak memory, the
   first window, the feed's wait and stages and a profiled replayed step
   by kind (convolutions, Concat copies, LRN, pooling, GEMM, elementwise
   glue); LRN alone; the Inception training main at its defaults and with
   ``--v2``; all of Inception under cuDNN's heuristic algorithms
   (``cudnn.benchmark`` off, the package's default), the setting its
   one-step check holds;
13. trains the text family at full width (its launches counted from a
   reset; it launches none of the five kernels): the PTB LSTM LM, the
   bench's ptb-lstm leg (``PTBModel(10000, 650, num_layers=2)``, batch 64
   x bptt 35, the PTB main's ``SGD(1.0)`` with clip-norm 5, the synthetic
   corpus over 10000 words): one (16, 35) step's loss and gradients
   against the CPU in fp32 (1e-4, 1e-3) and bf16 (per layer, within
   limits set from the CPU's bf16-vs-fp32 gaps); 17 steps through the
   prefetching feed and the captured step in fp32 and bf16 at fuse 1 and
   bf16 at ``set_fuse_steps(8)``, each bitwise equal to the same steps run
   eagerly, with step ms, words/s, the share of the peak (79.5 MFLOP a
   word), peak memory, the first window, a profiled replayed step by
   kernel kind and an eager step's GEMMs by shape (recurrent, input
   projection, decoder) and its update; cuDNN's ``torch.nn.LSTM`` with
   the same weights on the same (64, 35, 650) input, forward and backward,
   timed beside the port's two layers as one CUDA graph (a yardstick only;
   the port never calls it); a 20-word beam search (beam 3), timed; the
   TreeLSTM main at its defaults (loss falling; its ``TreeNNAccuracy``
   device fold equal to the host fold) and the text-classifier main; one
   forward and backward of ``Recurrent(ConvLSTMPeephole(16, 32))`` at (8,
   10, 16, 32, 32) against the CPU;
14. drives the rest of serving on phase 5's served LM at full width (8
   slots, fp32; every engine with a hang watchdog from ``BIGDL_WATCHDOG_S``;
   launches counted from a reset, the LayerNorm forward among them and,
   through the lifecycle's training, all five; references are phase 5's
   solo ``greedy_generate`` tokens, and greedy decoding by full-sequence
   forwards where there are none, each under the near-tie rule): (1) the
   16 requests with ``serve_thread`` killing the loop mid-decode: their
   references' tokens, one respawn, the same programs replayed, the time from the death to the
   next token; then the crash budget spent: the engine ``dead``, every
   handle failed, ``/healthz`` 503; (2) ``swap_weights`` v1 -> v2 (a
   second seeded LM) under traffic from a client thread: tokens before the
   swap v1's, after it greedy on v2 from that prefix, another engine over
   the module still v1's, ``promote_swap`` leaving v1 serving, the ledger
   unchanged, the engine's pause and the re-prefill's time; (3) SIGTERM
   through ``install_signal_drain`` with 8 requests in flight and 4 queued:
   the 8 finish, the 4 fail with ``EngineShutdown``, health ready ->
   draining -> dead, the previous handler called; (4) a 1.5 s
   ``serve_stall``: exactly one watchdog dump, naming the loop's thread,
   and none anywhere else in the phase; (5) ``FleetRouter.replicate(lm,
   1024, replicas=2, phases="prefill,decode", prefix_pool=16)``: the
   references' tokens, TTFT and decode rate beside one engine's, the
   handoff's ms and bytes; ``replica_down`` mid-traffic loses nothing and
   ``/healthz`` says ``degraded``, 200; (6) 8 fp32 steps of the served LM
   with a checkpoint every 4 publishing to a ``ModelRegistry``; a
   NaN-poisoned version; a ``PromotionController`` gating with the port's
   ``Evaluator`` (``Loss`` on 2 batches of the training data) rejects it
   and promotes the better trained version under traffic; a drill with the
   gate bypassed swaps a noisy version in, the watch window's SLO check
   breaches (``slo_breach@1``), the first rollback attempt is spent
   (``promote_rollback@1``) and the served tokens return bitwise to the
   promoted version's; (7) two native tenants of a ``SnapshotServer``,
   ``update_tenant`` on one (the other keeps its tokens), one scrape of a
   ``MetricsExporter(0)`` (``/metrics`` parses with both tenants' rows,
   ``/statusz`` is JSON);
15. fine-tunes and serves with LoRA, and trains and translates with the
   seq2seq Transformer, at full width: phase 6's LM adapted by
   ``nn.apply_lora`` at rank 8 (every attention and Linear, the head
   included; the rest frozen): one (2, 512) step's loss and every
   adapter's gradient against the CPU plain model (1e-4, 1e-3), no
   gradient on the base; 17 steps at 16 x 512 in fp32 and in bf16, each
   bitwise equal to the same steps run eagerly, with step ms and tokens/s
   beside phase 6's full fine-tune, the trainable parameters and the
   optimizer's slot bytes beside it, a profiled step's GEMM kernels beside
   it and all five kernels launched; the served LM adapted (``B = 0``)
   and published to a ``ModelRegistry``, its adapters fine-tuned 8 steps
   and published with ``publish_lora``; an engine serves phase 5's
   requests (their tokens), the LoRA version is promoted under traffic
   (the programs kept), then the engine serves the fine-tuned model's
   tokens (greedy by full-sequence forwards, ``greedy_generate`` on the
   two shortest prompts), and ``merge_lora``'s model serves the same, with
   the decode rate beside phase 5's; Transformer-base
   (``Transformer(37000, 37000, 512, 8, 6, 6)``, the seq2seq main's
   ``-b 32 --seq-len 256``): one (2, 256) step's loss and every gradient
   against the CPU plain model (1e-4, 1e-3); 17 steps of the main's
   configuration (Adam, the synthetic reversal corpus) in fp32 and bf16,
   each bitwise equal to eager steps, with step ms, target tokens/s and
   the flash forward, dq and dk/dv launched non-causal (the encoder) and
   causal (the decoder, T = 257) each; ``translate_generate`` against
   ``beam_translate`` on 4 held-out sources of 32 tokens, beam 4 (the same
   sequences but at ties, scores within 1e-4), with their walls; and the
   seq2seq main on the card (2 steps, 2 translations);
16. runs the layer tail and the MNIST autoencoder at full width (its
   launches counted from a reset; it launches none of the five kernels):
   every ported layer and criterion (the activations, the shape, table and
   container layers, ``nn/misc.py``, the normalization tail,
   ``nn/cosine.py``, ``TemporalAveragePooling``, the random layers, the
   convolution tail, ``nn/volumetric.py``, ``nn/tf_utils.py``, the 32
   criteria) forward and backward on the card in fp32 with TF32 off and
   cuDNN deterministic, at users' widths (pointwise and table layers at
   (256, 4096), spatial ones at (32, 64, 56, 56) in both layouts where the
   layer follows ``nn/layout.py``, volumetric ones at (8, 32, 16, 56, 56),
   ``LocallyConnected2D`` at (64, 32, 28, 28) with a 3x3 kernel, criteria
   at (256, 1000), ``TimeDistributedMaskCriterion`` at (32, 256, 1000))
   against the same module and inputs on the CPU (outputs within 1e-5 of
   1 + their largest magnitude, gradients 1e-4 relative, the cuDNN layers'
   outputs 1e-4);
   the random layers exact in eval mode and, in training mode, by the CPU
   tests' statistics; each layer again eagerly under
   ``torch.cuda.set_sync_debug_mode("error")`` (a host sync fails it), then
   as a ``utils/programs.Program`` whose replay is bitwise its eager run
   (``MaskedSelect`` must be refused by the capture instead); each layer's
   forward-plus-backward ms, and for the heavy ones the bound (bytes at
   3.35 TB/s or fp32 operations at 67 TFLOP/s, the larger) and
   ``MultiLabelMarginCriterion``'s peak memory; then the autoencoder at its
   main's configuration (784 -> 32 -> 784, batch 128, Adam 0.01, MSE,
   synthetic MNIST 2048): one step's loss and gradients against the CPU
   (1e-4, 1e-3), 17 steps in fp32 and in bf16 through the captured step,
   each bitwise equal to the same steps run eagerly, with step ms,
   images/s, the first window, a profiled replayed step and the replay's
   device time beside its host launch time, and the main at its defaults
   (the loss falling);
17. runs the recsys path and the Keras API (its launches counted from a
   reset: none of the five kernels may launch): NeuralCF at the MLPerf
   Training v0.5 NCF widths on MovieLens-20M (138,493 users, 26,744 items,
   GMF 64, MLP 256-256-128-64, ``sharded=True``, Adam, batch 65,536, ids
   from the NCF main's ``synthetic_interactions`` with 4 negatives a
   positive): one step's loss, dense and row gradients and unique ids
   against the CPU (1e-5, 1e-4 relative, exact); 21 captured sparse steps,
   bitwise the same steps run eagerly (losses, tables, slots), and 21
   dense ones (``set_sparse_embeddings(False)``), with step ms; HR@10 and
   NDCG@10 folded on the card over 4,096 held-out users x 1,000
   candidates (equal to the host fold on two batches); the
   ``RankingEngine`` serving 256 requests of 1,000 candidates at
   ``max_batch=8`` from 4 threads through one captured program, each order
   a stable sort of the eager model's scores, with requests/s and p50/p99
   latency; Wide & Deep's main at its defaults (beating the class prior);
   a Keras ``Sequential`` LeNet-5 fitted 2 epochs on 8,192 synthetic
   images at batch 128 with Adam, its losses equal to the same model built
   from ``nn`` with the same weights; a functional Keras ``Model`` over
   ``merge_nodes(mode="concat")``; and the NCF main with ``--sharded`` and
   with ``--hash-buckets 4096``, each beating its uniform baseline;
10. checks that the serving path (phases 4 and 5) launched both forward
   kernels and each training run (the 17 steps, fp32 and bf16) all five,
   every launch in the run's dtype (bf16 operands and bf16 gamma and beta
   under the bf16 policy), the LayerNorm backward once for each LayerNorm
   (the forward kernels once a step without remat, twice in each block
   with it) and the plain backward never (phase 7's path: the flash
   kernels only), and prints the kernel table as one JSON line (each
   kernel's row with its bf16 training instance and every path's
   launches), the card line, and the result line ``{"ok": true, "device":
   {...}}`` last.

Any failed check exits non-zero without the result line, as does a machine
without CUDA or a directory without the package. Phases 11, 12 and 13 run
before the kernel table, so their launches are in the ``kernels`` line
(``paths``); so do phase 14 (``paths.serving_stack``) and phase 15
(``paths.finetune_lora_training``, ``finetune_lora_serving``,
``seq2seq``; each flash row's ``seq2seq`` instances with their launches
by variant), phase 16 (``paths.tail``) and phase 17 (``paths.recsys``),
phase 18 (``paths.quantized``: ResNet-50 inference at batch 256 in bf16
and int8 dynamic, weight_only and static, images/s, weight bytes, top-1
agreement with fp32 and the int32 accumulators bitwise the CPU's; phase
4's LM served as fp32, weight_only, static and dynamic tenants of one
``SnapshotServer``) and phase 19 (``paths.detection``: SSD512-width
training under bf16 from four streamed ``.bdlrec`` shards, epoch 2 served
by the decoded-sample cache, one fp32 step against the CPU, a preemption
at step 4 of epoch 2 resumed onto the same batches bitwise; the trained
SSD's detections on 32 images against the CPU's head; the SSD main at
its defaults, held-out IoU > 0.3; Mask R-CNN at COCO test widths, eager
and replayed bitwise, against the CPU's detections; every eager NMS
call's words and keep bits held against the plain versions). The kernel
table has the NMS kernels' rows (``nms_mask_words``, ``nms_sweep``) at the
path's shapes, ``nms_keep`` (both) beside its bound (the IoUs this
data needs: ``nms_pairs``), the old path's plain version, the card's
``pairwise_iou`` alone and ``nms_keep``'s peak device memory. Phase 20
(``paths.images``, all 0: no ported kernel lies on it) builds the host
image codec with ``g++``, decodes every fixture of
``tests/torch_image_fixtures/`` against the SHA-256 of PIL's decode
recorded beside it, times the decode of a 500 x 375 4:2:0 JPEG and a 280
x 280 PNG on one thread and on a pool, trains the ResNet main on a
synthetic ImageNet folder (1,024 PNGs, ``--dataset ImageNet --depth 50
--classes 1000 -b 256``, two epochs, bf16, the transform chain serial and
on the parallel engine) and on a folder of 1,024 copies of the 500 x 375
JPEG fixture (ImageNet's traffic: each decoded and resized anew; the
parallel engine) with its step ms, images/s, feed wait a step and
whether the feed keeps up with the step (beside the same model's step on
in-memory batches), the VGG
main on CIFAR-10 binary batches and the LeNet main on MNIST idx files
(batch 128), runs ``converge`` on resnet50, lenet and vgg16 for one
epoch, resumes the LeNet main from a module and an optim method saved in
the phase, and saves and reloads ResNet-50 and phase 4's LM, their
forwards bitwise equal on the card.

``python3 chip_smoke.py --text-only`` builds the kernels and runs only
phase 13, printing its numbers as one JSON line (no result line).

``python3 chip_smoke.py --serving-only`` builds the kernels and runs only
phase 14, printing its numbers as one JSON line (no result line).

``python3 chip_smoke.py --finetune-only`` builds the kernels and runs only
phase 15, with phase 6's full fine-tune (fp32 and bf16) run first for its
comparisons, printing its numbers as one JSON line (no result line).

``python3 chip_smoke.py --tail-only`` builds the kernels and runs only
phase 16, printing its numbers as one JSON line (no result line).

``python3 chip_smoke.py --recsys-only`` builds the kernels and runs only
phase 17, printing its numbers as one JSON line (no result line).

``python3 chip_smoke.py --quantized-only`` and ``--detection-only`` build
the kernels and run only phase 18 or phase 19, printing its numbers as one
JSON line (no result line).

``python3 chip_smoke.py --images-only`` builds the kernels and runs only
phase 20, printing its numbers as one JSON line (no result line).

``python3 chip_smoke.py --remat-captures N`` builds the kernels and runs
only phase 6's bf16 training with every block under ``Remat`` N times in
one process, through the prefetching feed (its producer thread alive
during every capture), printing how many of its captures failed (ROADMAP
Queue C, the remat capture: closed after 0 failures in 56).

``python3 chip_smoke.py --lm-feed-ab N [--root DIR]`` builds the kernels
and times only phase 6's bf16 fuse-1 LM steps (both models) at prefetch 0
and 2, with and without the loop's event wait before its loss fetch, N
rounds in one process; with ``--root`` the package of the checkout at DIR
(an earlier commit unpacked there) instead of this one's.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

SEED = 1234
VOCAB, EMBED, HEADS, LAYERS, MAX_LEN = 32000, 512, 8, 6, 1024
TRAIN_LEN, TRAIN_BATCH, TRAIN_STEPS = 512, 16, 8   # benchmark.py:55,164
# iterations of a timed run: one epoch of 8 batches, a second, and one
# more, so that set_fuse_steps(8) runs one window that holds the capture
# and a second of replays only
TRAIN_ITERS = 2 * TRAIN_STEPS + 1
FUSE = 8
DEVICE = "cuda"
SLOTS, N_REQUESTS, N_CLIENTS, NEW_TOKENS = 8, 16, 4, 32
PROMPT_LO, PROMPT_HI = 17, 700
NEAR_TIE = 1e-4          # top-2 log-prob gap under which a token may differ
# an int8 static tenant: one activation's rounding flip (its float input a
# few ulps off the reference's, across a .5 boundary) moves a log-prob by
# about s_x * s_w * |w_q|, ~1e-3 at these widths (parts measured on an
# H100 at gaps up to 7.3e-3); the weight_only tenant keeps NEAR_TIE
NEAR_TIE_INT8 = 1e-2
# phase 9, the serving extras at full width: the paged pool at the 8-slot
# grid's KV bytes (8 x 1024 / 16 pages), an exhausted pool, the prefix
# pool, the speculative engine (k = 4) with the target as its own draft and
# with a smaller draft, deadlines and overload
EXTRA_SLOTS, EXTRA_PAGES, PAGE_TOKENS = 16, SLOTS * MAX_LEN // 16, 16
EXHAUST_PAGES = 96
ADMIT_ALL_MS = 60_000    # the exhausted pool's linger: ends at 16 queued
PREFIX_LEN, N_TAILS, TAIL_LO, TAIL_HI = 512, 8, 33, 64
SPEC_K = 4
DRAFT_WIDTH = (256, 4, 2)            # embed, heads, layers
# the llama-style path (phase 7): the transformerlm leg's widths with the
# JAX training main's options (bigdl_tpu/models/transformerlm/train.py)
LLAMA = dict(num_kv_heads=2, position="rope", norm="rms", mlp_kind="swiglu",
             fused_head=True)
# its depth, cut from the leg's 6 for the full run's time limit (its solo
# greedy_generate references step every prompt a position at a time:
# 66 s of the phase at 6 layers)
LLAMA_LAYERS = 3
BEAM, BEAM_SEED, BEAM_DECODE = 3, 128, 32
BEAM_SHAPE = (BEAM, HEADS, BEAM_SEED + BEAM_DECODE, 64)
HEAD_CHUNK = 8192                                # lm_criterion's default
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # fp32 non-tensor, bf16
TF32_FLOPS = 495e12                             # tensor cores, dense
SM_CLOCK_HZ = 1.98e9                            # H100 SXM boost clock
L2_BYTES = 50e6                                 # H100 SXM L2 cache
# fp32 lanes: 132 SMs x 128 lanes at the boost clock, an FMA one operation
# (PEAK_FLOPS counts it as two): the rate of the NMS words' IoU arithmetic
FP32_OPS = 132 * 128 * SM_CLOCK_HZ
NMS_IOU_OPS = 13           # pairwise_iou's fp32 operations a pair
# the detection path's kernels: every other path launches neither
NMS_KERNELS = ("nms_mask_words", "nms_sweep")
# phase 15: LoRA fine-tuning and serving of the full-width LM, and the
# seq2seq Transformer
LORA_RANK = 8                      # adapters of every attention and Linear
LORA_TUNE_STEPS = 8                # the served LM's fine-tune (Adam 1e-3)
# Transformer-base ("Attention Is All You Need", Table 3, row "base"):
# d_model 512, 8 heads, 6 + 6 layers, d_ff 2048, a shared BPE vocabulary of
# 37000; the seq2seq main's configuration at -b 32 --seq-len 256
S2S_ARGV = ["-b", "32", "--seq-len", "256", "--src-vocab", "37000",
            "--tgt-vocab", "37000", "--embed-dim", "512", "--num-heads", "8",
            "--num-encoder-layers", "6", "--num-decoder-layers", "6"]
S2S_BATCH, S2S_LEN = 32, 256
S2S_ENC_SHAPE = (S2S_BATCH, HEADS, S2S_LEN, 64)        # non-causal
S2S_DEC_SHAPE = (S2S_BATCH, HEADS, S2S_LEN + 1, 64)    # causal, ragged
S2S_HELD_OUT, S2S_HELD_LEN, S2S_BEAM = 4, 32, 4
FLASH_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")


class CheckFailed(Exception):
    pass


_START = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("phase "):       # a phase's header: when it began
        msg += f" [{time.perf_counter() - _START:.1f} s into the run]"
    print(msg, flush=True)


_WORK: list = []


def work_root() -> Path:
    """Where the phases write checkpoints, records and image folders: a
    directory of this run under /dev/shm when that has 16 GiB free (the
    phases measure the loop's stalls and the writers, not a disk), else
    under the checkout's build/. Removed when the script exits."""
    if not _WORK:
        import atexit
        import shutil
        import tempfile
        shm = "/dev/shm"
        base = (shm if os.path.isdir(shm) and os.access(shm, os.W_OK)
                and shutil.disk_usage(shm).free > 16 << 30 else
                Path(__file__).resolve().parent / "build")
        Path(base).mkdir(parents=True, exist_ok=True)
        _WORK.append(Path(tempfile.mkdtemp(prefix="bigdl-smoke-",
                                           dir=base)))
        atexit.register(shutil.rmtree, _WORK[0], True)
    return _WORK[0]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise CheckFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel")


def _instance(mangled: str) -> tuple:
    """(kernel, dtype, d, warpgroups) of a mangled flash kernel<T, D, NWG>."""
    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(f|13__nv_bfloat16)"
                  r"Li(\d+)ELi(\d+)E", mangled)
    if m is None:
        raise CheckFailed(f"unexpected flash kernel name {mangled}")
    return (m.group(1), "float32" if m.group(2) == "f" else "bfloat16",
            int(m.group(3)), int(m.group(4)))


def _sections(lines, start):
    """(name, line) for each line inside a section of a flash kernel
    instance; `start` finds a section's name in its first line."""
    current = None
    for line in lines:
        m = re.search(start, line)
        if m:
            current = m.group(1) if re.search(
                "|".join(FLASH_KERNELS), m.group(1)) else None
        elif current is not None:
            yield current, line


def report_flash_build(lib, kernels, nvcc):
    """Registers and spills (ptxas -v), threads, dynamic shared memory and
    the SASS counts of tensor-core (HGMMA) and TMA (UTMALDG) instructions
    of every instance of the three flash kernels. Fails if an instance
    spills or has none of either instruction."""
    info = {}
    for name, line in _sections(lib.build_log.splitlines(),
                                r"Compiling entry function '(\S+)'"):
        row = info.setdefault(_instance(name), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    if not info:
        raise CheckFailed("the build log holds no ptxas report of the flash "
                          "kernels: was the library built with -Xptxas -v?")
    out = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                          str(lib.path)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        raise CheckFailed(f"cuobjdump failed: {out.stderr.strip()[:500]}")
    for name, line in _sections(out.stdout.splitlines(),
                                r"Function : (\S+)"):
        row = info.setdefault(_instance(name), {})
        for op in ("HGMMA", "UTMALDG"):
            row[op] = row.get(op, 0) + (op in line)
    plans = {"flash_fwd_kernel": kernels.forward_launch_plan,
             "flash_bwd_dq_kernel": lambda *a: kernels.backward_launch_plan(
                 *a, dkv=False),
             "flash_bwd_dkv_kernel": lambda *a: kernels.backward_launch_plan(
                 *a, dkv=True)}
    for kernel, plan_fn in plans.items():
        for dtype in (torch.float32, torch.bfloat16):   # 1, then 2 WGs
            for d in (32, 64, 128):
                for bh in (1, 1 << 16):
                    plan = plan_fn(bh, 1024, d, dtype)
                    key = (kernel, str(dtype)[6:], d, plan["warpgroups"])
                    info.setdefault(key, {})["smem_bytes"] = \
                        plan["smem_bytes"]
                    info[key]["threads"] = plan["threads"]
    for key in sorted(info):
        row = info[key]
        log(f"  {key[0]} {key[1]} d={key[2]} warpgroups={key[3]}: "
            f"{row.get('registers')} registers, {row.get('spill_bytes')} "
            f"spill bytes, {row.get('threads')} threads, "
            f"{row.get('smem_bytes')} B dynamic shared; SASS "
            f"{row.get('HGMMA', 0)} HGMMA, {row.get('UTMALDG', 0)} UTMALDG")
        if not row.get("HGMMA") or not row.get("UTMALDG"):
            raise CheckFailed(f"{key} has no HGMMA or no UTMALDG instruction "
                              f"in its SASS")
        if row.get("spill_bytes") != 0:
            raise CheckFailed(f"{key} spills {row.get('spill_bytes')} bytes")
    return info


# ln_*<T, P, VEC, NV> and ln_bwd_reduce<P>: T is x's type, P gamma's
LN_INSTANCE = re.compile(r"(ln_(?:fwd|bwd)_(?:warp|loop)|ln_bwd_reduce)"
                         r"I((?:f|13__nv_bfloat16|S\d*_)+)"
                         r"(?:Li(\d+)ELi(\d+)E)?E")
LN_TYPE = re.compile(r"f|13__nv_bfloat16|S\d*_")
# the instances the main paths run, (kernel, x, gamma, vec, chunks): H = 512
# in 128-bit chunks, fp32 throughout or bf16 x with bf16 gamma (the bf16
# training step)
LN_MAIN_PATH = {("ln_fwd_warp", "float32", "float32", 4, 4),
                ("ln_bwd_warp", "float32", "float32", 4, 4),
                ("ln_bwd_reduce", None, "float32", None, None),
                ("ln_fwd_warp", "bfloat16", "bfloat16", 8, 2),
                ("ln_bwd_warp", "bfloat16", "bfloat16", 8, 2),
                ("ln_bwd_reduce", None, "bfloat16", None, None)}


def _ln_key(mangled: str):
    """(kernel, x dtype, gamma dtype, vec, chunks) of a LayerNorm instance,
    or None for another kernel. A substitution (S_) repeats bf16, the only
    class type among the arguments."""
    k = LN_INSTANCE.search(mangled)
    if k is None:
        return None
    types = ["float32" if t == "f" else "bfloat16"
             for t in LN_TYPE.findall(k.group(2))]
    x = None if k.group(1) == "ln_bwd_reduce" else types[0]
    return (k.group(1), x, types[-1],
            int(k.group(3)) if k.group(3) else None,
            int(k.group(4)) if k.group(4) else None)


def report_layer_norm_build(lib):
    """Registers and spills (ptxas -v) of every LayerNorm instance
    (kernel, x dtype, gamma dtype, values a chunk, chunks a thread). Fails
    if an instance of the main paths spills."""
    info = {}
    current = None
    for line in lib.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = _ln_key(m.group(1))
            continue
        if current is None:
            continue
        row = info.setdefault(current, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    if not info:
        raise CheckFailed("the build log holds no ptxas report of the "
                          "LayerNorm kernels")
    for key in sorted(info, key=str):
        log(f"  {key[0]} x={key[1]} gamma={key[2]} vec={key[3]} "
            f"chunks={key[4]}: "
            f"{info[key].get('registers')} registers, "
            f"{info[key].get('spill_bytes')} spill bytes")
    for key in LN_MAIN_PATH:
        if info.get(key, {}).get("spill_bytes") != 0:
            raise CheckFailed(f"{key} spills or is missing: {info.get(key)}")
    return info


# ----------------------------------------------------------------- timing
def time_ms(fn, reps: int = 20, trials: int = 5) -> tuple[float, float]:
    """(device ms, host ms) of one call of ``fn``. Device: the median over
    ``trials`` of CUDA events around ``reps`` back-to-back calls; a spin
    kernel (``torch.cuda._sleep``) holds the stream while the host enqueues
    them, so the calls run back to back and the events time the card rather
    than the host's launch rate. Host: the time to enqueue one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(2 * max(enqueue_s, 1e-4) * SM_CLOCK_HZ)
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), enqueue_s * 1e3 / reps


def rotating(fn, sets: int):
    """A call of ``fn(k)`` for k = 0, 1, ..., sets - 1, 0, 1, ... that keeps
    each result until its slot comes round again: the inputs rotate through
    ``sets`` buffers and the outputs through sets + 1. The ring is filled
    once here, so no call in a timing loop allocates new device memory."""
    ring = [fn(k) for k in range(sets)]
    step = itertools.count()

    def call():
        k = next(step) % sets
        ring[k] = fn(k)
    return call


def rotation(bytes_per_call: float) -> int:
    """Sets of buffers a timing loop rotates through so that one pass over
    them moves 4x the L2: each call then reads its inputs from, and writes
    its outputs to, device memory, as the bytes bound assumes. At most 256:
    a decode tick's (8, 512) then stays in L2, as on the serving path, where
    the op before it has just written its input."""
    return min(256, max(2, math.ceil(4 * L2_BYTES / bytes_per_call)))


def bound_ms(bytes_moved: float, flops: float, dtype_name: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def within(got, want, atol, rtol) -> bool:
    err = (got.float() - want.float()).abs()
    return bool((err <= atol + rtol * want.float().abs()).all())


# ------------------------------------------------------- phase 3: kernels
def launch_floor_ms(lib) -> float:
    """Device time of an empty kernel launched through the C interface, as
    the kernels are: the floor under any of their times."""
    stream = torch.cuda.current_stream().cuda_stream
    ms, _ = time_ms(lambda: lib.bigdl_empty_launch(stream), 50)
    return ms


def check_layer_norm(kernels, card, floor_ms):
    """The forward at every shape the main paths give it: a decode tick
    (8, 512), the longest prefill (700, 512), the full forward (2·512, 512),
    training (16·512, 512) in fp32 and bf16, and the flagship width
    (1024, 256), with fp32 gamma and beta; and the bf16 training step's
    (16·512, 512) and (2·512, 512) with bf16 gamma and beta. The kernel,
    its plain version and ``F.layer_norm`` are timed over rotating inputs
    and outputs 4x the L2 (``rotation``)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((SLOTS, EMBED), f32, f32, 1e-5, 1e-5),
             ((EXTRA_SLOTS, EMBED), f32, f32, 1e-5, 1e-5),
             ((EXTRA_SLOTS * (SPEC_K + 1), EMBED), f32, f32, 1e-5, 1e-5),
             ((PROMPT_HI, EMBED), f32, f32, 1e-5, 1e-5),
             ((2 * 512, EMBED), f32, f32, 1e-5, 1e-5),
             ((TRAIN_BATCH * TRAIN_LEN, EMBED), f32, f32, 1e-5, 1e-5),
             ((TRAIN_BATCH * TRAIN_LEN, EMBED), bf16, f32, 2e-2, 0.0),
             ((1024, 256), f32, f32, 1e-5, 1e-5),
             ((TRAIN_BATCH * TRAIN_LEN, EMBED), bf16, bf16, 2e-2, 0.0),
             ((2 * TRAIN_LEN, EMBED), bf16, bf16, 2e-2, 0.0)]
    # the seq2seq step's encoder and decoder rows
    for n in (S2S_BATCH * S2S_LEN, S2S_BATCH * (S2S_LEN + 1)):
        cases += [((n, EMBED), f32, f32, 1e-5, 1e-5),
                  ((n, EMBED), bf16, bf16, 2e-2, 0.0)]
    rows = []
    for (n, h), dtype, pdtype, atol, rtol in cases:
        item = torch.finfo(dtype).bits // 8
        sets = rotation(2 * n * h * item)
        xs = torch.randn(sets, n, h, generator=g, device=dev).to(dtype)
        x = xs[0]
        gamma = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(pdtype)
        beta = (0.1 * torch.randn(h, generator=g, device=dev)).to(pdtype)
        got = kernels.layer_norm_cuda(x, gamma, beta, 1e-5)
        want = kernels.layer_norm_reference(x, gamma, beta, 1e-5)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol)
        k_ms, _ = time_ms(rotating(
            lambda k: kernels.layer_norm_cuda(xs[k], gamma, beta, 1e-5),
            sets), 50)
        p_ms, _ = time_ms(rotating(
            lambda k: kernels.layer_norm_reference(xs[k], gamma, beta, 1e-5),
            sets), 50)
        g_lib, b_lib = gamma.to(dtype), beta.to(dtype)
        l_ms, _ = time_ms(rotating(lambda k: torch.nn.functional.layer_norm(
            xs[k], (h,), g_lib, b_lib, 1e-5), sets), 50)
        ys = torch.empty_like(xs)
        c_ms, _ = time_ms(rotating(lambda k: ys[k].copy_(xs[k]), sets), 50)
        del ys
        p_item = torch.finfo(pdtype).bits // 8
        b_ms, b_by = bound_ms(2 * n * h * item + 2 * h * p_item, 8.0 * n * h,
                              str(dtype).split(".")[-1])
        log(f"  layer_norm ({n}, {h}) {str(dtype)[6:]}, gamma "
            f"{str(pdtype)[6:]}: max|err| {err:.3e} "
            f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'FAIL'}; kernel "
            f"{k_ms:.5f} ms, plain {p_ms:.5f} ms, F.layer_norm {l_ms:.5f} "
            f"ms, bound {b_ms:.5f} ms ({b_by}, {b_ms / k_ms:.0%} of it), "
            f"copy of x {c_ms:.5f} ms, launch floor {floor_ms:.5f} ms; "
            f"{sets} rotating sets [{card}]")
        if not ok:
            raise CheckFailed(f"layer_norm ({n}, {h}) {dtype} disagrees with "
                              f"its plain version: max|err| {err}")
        rows.append(dict(shape=[n, h], dtype=str(dtype)[6:],
                         params=str(pdtype)[6:], err=err, ms=k_ms,
                         plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                         bound_by=b_by, copy_ms=c_ms))
    return rows


def check_layer_norm_bwd(kernels, card):
    """The backward kernel against ``layer_norm_backward`` at the training
    paths' shapes: the 8-step runs' (16·512, 512) in fp32, bf16 with fp32
    gamma and bf16 with bf16 gamma (the bf16 step), and the one-step
    checks' (2·512, 512) in fp32 and in bf16 with bf16 gamma. dx within
    rtol 1e-4 / atol 1e-5 (fp32) or 2e-2 (bf16); dgamma and dbeta, fp32
    sums over all N rows taken in another order than the plain version's,
    within rtol 1e-4 and atol 1e-5·(max|want| + 1), or, rounded to bf16
    gamma's dtype, within rtol 2^-7 (one bf16 ulp), and equal bit for bit
    across two calls. Library yardstick: the backward of ``F.layer_norm``,
    (forward + backward) - forward under autograd. All three are timed over
    rotating inputs and outputs 4x the L2 (``rotation``)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((TRAIN_BATCH * TRAIN_LEN, EMBED), bf16, f32),
             ((TRAIN_BATCH * TRAIN_LEN, EMBED), bf16, bf16),
             ((2 * TRAIN_LEN, EMBED), bf16, bf16),
             ((2 * TRAIN_LEN, EMBED), f32, f32),
             ((TRAIN_BATCH * TRAIN_LEN, EMBED), f32, f32)]
    # the seq2seq step's encoder and decoder rows
    for n in (S2S_BATCH * S2S_LEN, S2S_BATCH * (S2S_LEN + 1)):
        cases += [((n, EMBED), f32, f32), ((n, EMBED), bf16, bf16)]
    rows = []
    for (n, h), dtype, pdtype in cases:
        item = torch.finfo(dtype).bits // 8
        p_item = torch.finfo(pdtype).bits // 8
        sets = rotation(3 * n * h * item)
        xs = torch.randn(sets, n, h, generator=g, device=dev).to(dtype)
        dys = torch.randn(sets, n, h, generator=g, device=dev).to(dtype)
        x, dy = xs[0], dys[0]
        gamma = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(pdtype)
        got = kernels.layer_norm_bwd_cuda(x, gamma, dy, 1e-5)
        again = kernels.layer_norm_bwd_cuda(x, gamma, dy, 1e-5)
        want = kernels.layer_norm_backward(x, gamma, 1e-5, dy)
        torch.cuda.synchronize()
        errs = [max_err(a, b) for a, b in zip(got, want)]
        dx_tol = (1e-5, 1e-4) if dtype == torch.float32 else (2e-2, 0.0)
        sum_atol = [1e-5 * (float(b.float().abs().max()) + 1)
                    for b in want[1:]]
        sum_rtol = 1e-4 if pdtype == torch.float32 else 2 ** -7
        ok = (within(got[0], want[0], *dx_tol)
              and all(a.dtype == pdtype for a in got[1:])
              and all(within(a, b, t, sum_rtol)
                      for a, b, t in zip(got[1:], want[1:], sum_atol)))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        k_ms, _ = time_ms(rotating(
            lambda k: kernels.layer_norm_bwd_cuda(xs[k], gamma, dys[k], 1e-5),
            sets), 50)
        p_ms, _ = time_ms(rotating(
            lambda k: kernels.layer_norm_backward(xs[k], gamma, 1e-5, dys[k]),
            sets), 20)
        xr = [t.detach().requires_grad_() for t in xs.unbind(0)]
        gr, br = (t.detach().to(dtype).requires_grad_()
                  for t in (gamma, torch.zeros_like(gamma)))
        ln = torch.nn.functional.layer_norm
        fb_ms, _ = time_ms(rotating(lambda k: torch.autograd.grad(
            ln(xr[k], (h,), gr, br, 1e-5), (xr[k], gr, br), dys[k]),
            sets), 50)
        with torch.no_grad():
            f_ms, _ = time_ms(rotating(
                lambda k: ln(xr[k], (h,), gr, br, 1e-5), sets), 50)
        l_ms = fb_ms - f_ms
        name = str(dtype).split(".")[-1]
        b_ms, b_by = bound_ms(3 * n * h * item + 3 * h * p_item,
                              12.0 * n * h, name)
        log(f"  layer_norm bwd ({n}, {h}) {name}, gamma {str(pdtype)[6:]}: "
            f"max|err| dx {errs[0]:.3e} "
            f"dgamma {errs[1]:.3e} dbeta {errs[2]:.3e} (dx atol "
            f"{dx_tol[0]}, rtol {dx_tol[1]}; dgamma, dbeta atol "
            f"{sum_atol[0]:.2e}, {sum_atol[1]:.2e}, rtol {sum_rtol:.2e}) "
            f"{'ok' if ok else 'FAIL'}; two calls bitwise "
            f"{'equal' if bitwise else 'DIFFER'}; kernel {k_ms:.5f} ms, plain "
            f"{p_ms:.5f} ms, F.layer_norm backward {l_ms:.5f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}, {b_ms / k_ms:.0%} of it); {sets} "
            f"rotating sets [{card}]")
        if not ok:
            raise CheckFailed(f"layer_norm bwd ({n}, {h}) {dtype} disagrees "
                              f"with its plain version: max|err| {errs}")
        if not bitwise:
            raise CheckFailed(f"layer_norm bwd ({n}, {h}) {dtype}: two calls "
                              f"differ")
        rows.append(dict(shape=[n, h], dtype=name, params=str(pdtype)[6:],
                         err=max(errs), ms=k_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
    return rows


def check_flash(kernels, card):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = []
    for t in (1024, 1000):
        for causal in (True, False):
            for dtype, atol, rtol in ((torch.float32, 2e-4, 2e-4),
                                      (torch.bfloat16, 2e-2, 0.0)):
                cases.append(((2, HEADS, t, 64), causal, dtype, atol, rtol))
    # the main paths' shapes: serving's full forward and the training step
    for shape in ((2, HEADS, 512, 64), (TRAIN_BATCH, HEADS, TRAIN_LEN, 64)):
        cases.append((shape, True, torch.float32, 2e-4, 2e-4))
        cases.append((shape, True, torch.bfloat16, 2e-2, 0.0))
    # the static beam search's full forward: beam x heads, seed + decode
    cases.append((BEAM_SHAPE, True, torch.float32, 2e-4, 2e-4))
    # the seq2seq step's: the encoder non-causal, the decoder causal at a
    # ragged length
    for shape, causal in ((S2S_ENC_SHAPE, False), (S2S_DEC_SHAPE, True)):
        cases.append((shape, causal, torch.float32, 2e-4, 2e-4))
        cases.append((shape, causal, torch.bfloat16, 2e-2, 0.0))
    rows = []
    for (b, h, t, d), causal, dtype, atol, rtol in cases:
        q, k, v = (torch.randn(b * h, t, d, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        o, lse = kernels.flash_attention_cuda(q, k, v, causal)
        o_ref, lse_ref = kernels.flash_attention_reference(q, k, v, causal)
        torch.cuda.synchronize()
        err = max(max_err(o, o_ref), max_err(lse, lse_ref))
        ok = (within(o, o_ref, atol, rtol)
              and within(lse, lse_ref, atol, rtol))
        k_ms, _ = time_ms(
            lambda: kernels.flash_attention_cuda(q, k, v, causal))
        p_ms, _ = time_ms(lambda: kernels.flash_attention_reference(
            q, k, v, causal))
        q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
        l_ms, _ = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal))
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        item = q.element_size()
        moved = 4 * b * h * t * d * item + b * h * t * 4
        b_ms, b_by = bound_ms(moved, 4.0 * d * pairs,
                              str(dtype).split(".")[-1])
        plan = kernels.forward_launch_plan(b * h, t, d, dtype)
        bounds = f"bound {b_ms:.4f} ms ({b_by})"
        tf32_ms = None
        if dtype == torch.float32:   # the kernel's 3xTF32 work
            tf32_ms = max(moved / HBM_BYTES_PER_S,
                          3 * 4.0 * d * pairs / TF32_FLOPS) * 1e3
            bounds = (f"bounds {b_ms:.4f} ms (FMA, {b_by}), "
                      f"{tf32_ms:.4f} ms (3xTF32)")
        log(f"  flash ({b}, {h}, {t}, {d}) causal={causal} {str(dtype)[6:]}:"
            f" max|err| {err:.3e} (atol {atol}, rtol {rtol}) "
            f"{'ok' if ok else 'FAIL'}; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, sdpa {l_ms:.4f} ms, {bounds}; "
            f"{plan['warpgroups']} consumer warpgroup(s), "
            f"{plan['smem_bytes']} B shared [{card}]")
        if not ok:
            raise CheckFailed(f"flash ({b},{h},{t},{d}) causal={causal} "
                              f"{dtype} disagrees with its plain version: "
                              f"max|err| {err}")
        rows.append(dict(shape=[b, h, t, d], causal=causal,
                         dtype=str(dtype)[6:], err=err, ms=k_ms,
                         plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         bound_3xtf32_ms=tf32_ms, plan=plan))
    return rows


def find_row(rows, shape, dtype, params="float32", causal=True):
    """The row of ``shape`` and ``dtype``, causal or not (LayerNorm rows:
    with gamma in ``params``)."""
    return next(r for r in rows if r["shape"] == list(shape)
                and r["dtype"] == dtype and r.get("causal", True) == causal
                and r.get("params", "float32") == params)


def sdpa_backend(q4, k4, v4, causal) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these
    operands (PyTorch's own dispatch query), or "unknown"."""
    try:
        from torch.nn.attention import SDPBackend
        idx = torch._fused_sdp_choice(q4, k4, v4, None, 0.0, causal)
        return SDPBackend(idx).name
    except Exception as e:  # noqa: BLE001 — a label only
        return f"unknown ({type(e).__name__})"


def check_flash_bwd(kernels, card):
    """dq and dk/dv kernels against the plain backward. Tolerance: fp32
    atol 2e-4·(max|want| + 1), rtol 2e-4 (sums over T keys or queries in
    another order); bf16 2e-2·(max|want| + 1), rtol 2e-2 (a few ulps of the
    bf16 result)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases = [((2, HEADS, t, 64), causal, dtype)
             for t in (1024, 1000) for causal in (True, False)
             for dtype in (torch.float32, torch.bfloat16)]
    # the seq2seq step's: the encoder non-causal, the decoder causal at a
    # ragged length
    cases += [(shape, causal, dtype)
              for shape, causal in ((S2S_ENC_SHAPE, False),
                                    (S2S_DEC_SHAPE, True))
              for dtype in (torch.float32, torch.bfloat16)]
    # the training step's shape, in both dtypes; the fp32 one last
    cases.append(((TRAIN_BATCH, HEADS, TRAIN_LEN, 64), True, torch.bfloat16))
    cases.append(((TRAIN_BATCH, HEADS, TRAIN_LEN, 64), True, torch.float32))
    rows = []
    for (b, h, t, d), causal, dtype in cases:
        q, k, v, do = (torch.randn(b * h, t, d, generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        o, lse = kernels.flash_attention_cuda(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        dq = kernels.flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                 causal)
        dk, dv = kernels.flash_attention_bwd_dkv_cuda(q, k, v, do, lse,
                                                      delta, causal)
        want = kernels.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                     causal)
        torch.cuda.synchronize()
        errs, ok = [], True
        tol = 2e-4 if dtype == torch.float32 else 2e-2
        for got, ref in zip((dq, dk, dv), want):
            scale = float(ref.float().abs().max()) + 1.0
            errs.append(max_err(got, ref))
            ok = ok and within(got, ref, tol * scale, tol)
        dq_ms, _ = time_ms(lambda: kernels.flash_attention_bwd_dq_cuda(
            q, k, v, do, lse, delta, causal))
        dkv_ms, _ = time_ms(lambda: kernels.flash_attention_bwd_dkv_cuda(
            q, k, v, do, lse, delta, causal))
        p_ms, _ = time_ms(lambda: kernels.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal))
        # library yardstick: backward of scaled_dot_product_attention on
        # the same inputs, (forward + backward) - forward
        q4, k4, v4 = (x.view(b, h, t, d).detach().requires_grad_()
                      for x in (q, k, v))
        do4 = do.view(b, h, t, d)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        fb_ms, _ = time_ms(lambda: torch.autograd.grad(
            sdpa(q4, k4, v4, is_causal=causal), (q4, k4, v4), do4))
        with torch.no_grad():
            f_ms, _ = time_ms(lambda: sdpa(q4, k4, v4, is_causal=causal))
        l_ms = fb_ms - f_ms
        backend = sdpa_backend(q4, k4, v4, causal)
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        item = q.element_size()
        read = 4 * b * h * t * d * item + 2 * b * h * t * 4
        name = str(dtype).split(".")[-1]
        dq_moved = read + b * h * t * d * item
        dkv_moved = read + 2 * b * h * t * d * item
        dq_b = bound_ms(dq_moved, 6.0 * d * pairs, name)
        dkv_b = bound_ms(dkv_moved, 8.0 * d * pairs, name)
        tf32 = [None, None]
        bounds = (f"bounds dq {dq_b[0]:.4f}, dkv {dkv_b[0]:.4f} ms "
                  f"({dq_b[1]})")
        if dtype == torch.float32:   # the kernels' 3xTF32 work
            tf32 = [max(moved / HBM_BYTES_PER_S,
                        3 * f * d * pairs / TF32_FLOPS) * 1e3
                    for moved, f in ((dq_moved, 6.0), (dkv_moved, 8.0))]
            bounds = (f"bounds FMA dq {dq_b[0]:.4f}, dkv {dkv_b[0]:.4f} ms; "
                      f"3xTF32 dq {tf32[0]:.4f}, dkv {tf32[1]:.4f} ms")
        plans = [kernels.backward_launch_plan(b * h, t, d, dtype, dkv)
                 for dkv in (False, True)]
        log(f"  flash bwd ({b}, {h}, {t}, {d}) causal={causal} {name}: "
            f"max|err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
            f"(tol {tol}·(max|want|+1), rtol {tol}) "
            f"{'ok' if ok else 'FAIL'}; dq {dq_ms:.4f} ms, dkv "
            f"{dkv_ms:.4f} ms, {bounds}; plain dq+dk+dv {p_ms:.4f} ms, "
            f"sdpa backward {l_ms:.4f} ms ({backend}); consumer warpgroups "
            f"dq {plans[0]['warpgroups']}, dkv {plans[1]['warpgroups']} "
            f"[{card}]")
        if not ok:
            raise CheckFailed(f"flash bwd ({b},{h},{t},{d}) causal={causal} "
                              f"{dtype} disagrees with its plain version: "
                              f"max|err| {errs}")
        rows.append(dict(shape=[b, h, t, d], causal=causal, dtype=name,
                         err_dq=errs[0], err_dkv=max(errs[1:]), dq_ms=dq_ms,
                         dkv_ms=dkv_ms, plain_ms=p_ms, library_ms=l_ms,
                         library_backend=backend, dq_bound=dq_b,
                         dkv_bound=dkv_b, dq_bound_3xtf32_ms=tf32[0],
                         dkv_bound_3xtf32_ms=tf32[1], plans=plans))
    return rows


# ------------------------------------------------------- phases 4 and 5
def build_lm(TransformerLM, attention_impl, device):
    return TransformerLM(VOCAB, EMBED, HEADS, LAYERS, MAX_LEN,
                         attention_impl=attention_impl,
                         generator=torch.Generator().manual_seed(SEED),
                         device=device).evaluate()


def full_forward(lm, build_ref):
    """The (2, 512) forward on the card against ``build_ref()``, the same
    weights on the CPU with the plain attention."""
    g = torch.Generator().manual_seed(SEED + 2)
    ids = torch.randint(0, VOCAB, (2, 512), generator=g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        lp = lm(ids.cuda())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if tuple(lp.shape) != (2, 512, VOCAB) or not bool(lp.isfinite().all()):
        raise CheckFailed(f"full forward gave shape {tuple(lp.shape)} or "
                          f"non-finite log-probs")
    ref = build_ref()
    with torch.no_grad():
        lp_ref = ref(ids)
    err = max_err(lp.cpu(), lp_ref)
    log(f"  full forward (2, 512): {wall * 1e3:.1f} ms (first call); "
        f"max|log-prob err| vs CPU plain model {err:.3e} (atol 1e-3)")
    if err > 1e-3:
        raise CheckFailed(f"full forward disagrees with the plain model: "
                          f"{err}")
    return err


def serve_round(engine, prompts, order=None):
    """Submit every prompt from N_CLIENTS threads at once, or from one
    thread in ``order`` (prompt indices); returns the results in prompt
    order and the wall time until the last one."""
    handles = [None] * N_REQUESTS
    errors = []
    shares = ([range(c, N_REQUESTS, N_CLIENTS) for c in range(N_CLIENTS)]
              if order is None else [order])

    def client(c):
        try:
            for i in shares[c]:
                handles[i] = engine.submit(prompts[i], NEW_TOKENS,
                                           request_id=i)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,))
               for c in range(len(shares))]
    for th in clients:
        th.start()
    for th in clients:
        th.join(120)
    if errors or any(h is None for h in handles):
        raise CheckFailed(f"submit failed: {errors}")
    results = [h.result(timeout=600) for h in handles]
    return results, time.perf_counter() - t0


def serving_prompts():
    """Phase 5's 16 prompts of 17..700 tokens, from the seed."""
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(PROMPT_LO, PROMPT_HI + 1, N_REQUESTS)
    return [rng.integers(0, VOCAB, int(n)).astype(np.int32)
            for n in lengths]


def serve_rounds(engine, prompts, n, order=None):
    """``n`` rounds of ``prompts`` through ``engine`` (``serve_round``'s
    ``order``): each round's results, wall time and engine stats
    (cumulative)."""
    rounds = []
    for _ in range(n):
        results, wall = serve_round(engine, prompts, order)
        rounds.append((results, wall, engine.stats()))
    return rounds


def serve(lm, ServingEngine, **engine_kw):
    """Two rounds of the same requests through one engine: the first
    captures each program at its first use (JAX compiles there), the
    second replays only. Returns the prompts and each round's results,
    wall time and engine stats (cumulative)."""
    prompts = serving_prompts()
    engine = ServingEngine(lm, max_len=MAX_LEN, device=DEVICE,
                           **dict(dict(slots=SLOTS), **engine_kw))
    try:
        rounds = serve_rounds(engine, prompts, 2)
    finally:
        engine.shutdown()
    return prompts, rounds


def report_round(name, results, wall, stats, before, card):
    """One round's rates from its results and the engine's counters
    (``before``: the stats at the round's start)."""
    ttft = np.array([r.ttft_s for r in results]) * 1e3
    generated = sum(r.n_generated for r in results)
    ticks = stats["decode_ticks"] - before.get("decode_ticks", 0)
    tick_s = stats["decode_seconds"] - before.get("decode_seconds", 0.0)
    tokens = stats["decode_tokens"] - before.get("decode_tokens", 0)
    prefill_s = stats["prefill_seconds"] - before.get("prefill_seconds", 0.0)
    prefills = stats["prefills"] - before.get("prefills", 0)
    out = {"wall_s": wall, "tokens": generated,
           "decode_tokens_per_s": tokens / tick_s, "ticks": ticks,
           "tick_ms": tick_s / ticks * 1e3,
           "prefill_ms": prefill_s / prefills * 1e3,
           "ttft_p50_ms": float(np.percentile(ttft, 50)),
           "ttft_p99_ms": float(np.percentile(ttft, 99))}
    log(f"  {name}: {len(results)} requests, {generated} tokens in "
        f"{wall:.3f} s ({generated / wall:.1f} tokens/s with prefill); "
        f"decode {out['decode_tokens_per_s']:.1f} tokens/s over {ticks} "
        f"ticks, {out['tick_ms']:.3f} ms a tick (tokens in, the program, "
        f"results out); prefill {out['prefill_ms']:.2f} ms a request; TTFT "
        f"p50 {out['ttft_p50_ms']:.1f} ms, p99 {out['ttft_p99_ms']:.1f} ms "
        f"[{card}]")
    return out


def decode_step_ms(lm, install_decode_cache, card):
    """Device and host time of one cached decode step of the model over
    the full slot grid, the work of one engine tick without its host
    transfers, run eagerly."""
    state = install_decode_cache(lm, SLOTS, MAX_LEN)
    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device="cuda")
    with torch.no_grad():
        dev_ms, host_ms = time_ms(lambda: lm.run(tok, state), reps=2)
    log(f"  decode step ({SLOTS} slots, cache {MAX_LEN}), eager: device "
        f"{dev_ms:.3f} ms, host enqueue {host_ms:.3f} ms; device busy "
        f"{dev_ms / host_ms:.1%} of the host's time [{card}]")
    return {"device_ms": dev_ms, "host_ms": host_ms}


def copy_tree(tree):
    return {k: copy_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def replayed_decode_step(lm, kernels, install_decode_cache, Program, card):
    """The same step as a captured program (``utils/programs.py``): its
    log-probs against the eager step on a copy of the same cache (a
    64-token prefix in every row, then two steps), the LayerNorm launches
    one replay counts against one eager step's, and the replay's device
    and host time. Fails unless the log-probs agree within 1e-5 and the
    counts are equal."""
    rng = np.random.default_rng(SEED + 6)
    prefix = torch.from_numpy(rng.integers(0, VOCAB, (SLOTS, 64))).cuda()
    tok = torch.from_numpy(rng.integers(0, VOCAB, (SLOTS, 1))).cuda()
    with torch.no_grad():
        state = install_decode_cache(lm, SLOTS, MAX_LEN)
        lm.run(prefix, state)
        ref_state = copy_tree(state)
        prog = Program(("decode_check", SLOTS, MAX_LEN),
                       lambda t: lm.run(t, state)[0], (tok.clone(),), "cuda")
        prog()                                # warm-up, then capture
        lm.run(tok, ref_state)
        kernels.reset_launch_counts()
        got = prog().clone()                  # the first replay
        replay_counts = kernels.launch_counts()
        kernels.reset_launch_counts()
        want = lm.run(tok, ref_state)[0]
        eager_counts = kernels.launch_counts()
        torch.cuda.synchronize()
        err = max_err(got, want)
        bitwise = bool(torch.equal(got, want))
        dev_ms, host_ms = time_ms(prog, reps=2)
    log(f"  decode step, replayed: device {dev_ms:.3f} ms, host "
        f"{host_ms:.3f} ms a replay (device-bound when the host is the "
        f"shorter); log-probs against the eager step max|err| "
        f"{err:.3e} (atol 1e-5), bitwise {bitwise}; launches a step "
        f"replayed {replay_counts['layer_norm_fwd']} LN forward, eager "
        f"{eager_counts['layer_norm_fwd']} [{card}]")
    if err > 1e-5 or replay_counts != eager_counts:
        raise CheckFailed(f"the replayed decode step departs from the eager "
                          f"one: max|err| {err}, launches {replay_counts} "
                          f"against {eager_counts}")
    return {"device_ms": dev_ms, "host_ms": host_ms, "max_abs_err": err,
            "bitwise": bitwise, "launches": replay_counts}


def decode_kernels(lm, install_decode_cache, Program, card, name):
    """One replayed decode step of the slot grid under ``torch.profiler``
    (reported only): how many kernels the graph runs and their device
    time, with the largest by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device=DEVICE)
    with torch.no_grad():
        state = install_decode_cache(lm, SLOTS, MAX_LEN)
        prog = Program(("decode_profile", name),
                       lambda t: lm.run(t, state)[0], (tok,), DEVICE)
        prog()                                # warm-up, then capture
        prog()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prog()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
        except Exception as e:  # noqa: BLE001 — an observation, not a check
            log(f"  profiler: no device times ({type(e).__name__}: {e})")
            return None

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if us is None else us) / 1e3

    n = sum(e.count for e in events)
    busy = sum(dev_ms(e) for e in events)
    top = sorted(events, key=dev_ms, reverse=True)[:5]
    log(f"  {name} decode step, one replay profiled: {n} kernels, "
        f"{busy:.3f} ms of device time; largest: "
        + "; ".join(f"{e.key[:48]} x{e.count} {dev_ms(e):.3f} ms"
                    for e in top) + f" [{card}]")
    return {"kernels": n, "device_ms": busy,
            "top": [[e.key[:90], dev_ms(e), e.count] for e in top]}


def check_programs(stats, prompts, buckets, pick_bucket, launches,
                   fwd_counts, ln_per_call=2 * LAYERS + 1):
    """The engine's program ledger: one program per prefill bucket used,
    one decode, one assign, within ``len(buckets) + 2``; every model call
    of the run (a prefill or a tick, eager warm-up or replay) launched the
    LayerNorm forward ``ln_per_call`` times (13; none with RMSNorm), as an
    eager run does."""
    used = {pick_bucket(len(p), buckets) for p in prompts}
    n, bound = stats["compiled_programs"], stats["program_grid_bound"]
    calls = stats["prefills"] + stats["decode_ticks"]
    ln = launches["layer_norm_fwd"] - fwd_counts["layer_norm_fwd"]
    log(f"  programs: {n} compiled (bound {bound}; {len(used)} prefill "
        f"buckets used + decode + assign); LN forward launches {ln} over "
        f"{calls} model calls ({ln_per_call} each eagerly: "
        f"{ln_per_call * calls})")
    if n > bound or n != len(used) + 2:
        raise CheckFailed(f"the engine compiled {n} programs for "
                          f"{len(used)} buckets (bound {bound})")
    if ln != ln_per_call * calls:
        raise CheckFailed(f"serving launched the LayerNorm forward {ln} "
                          f"times over {calls} model calls")
    return {"compiled_programs": n, "program_grid_bound": bound,
            "buckets_used": len(used)}


def near_tie_gap(lm, seq) -> float:
    """Top-2 log-prob gap of the model's next-token distribution after
    ``seq`` (the full-sequence forward)."""
    with torch.no_grad():
        lp = lm(torch.as_tensor(np.asarray(seq), dtype=torch.long)[None]
                .to(DEVICE))[0, -1]
    top = lp.topk(2).values
    return float(top[0] - top[1])


def check_near_ties(lm, name, got, refs, lengths, near_tie=NEAR_TIE) -> int:
    """``got[i]`` against ``refs[i]`` (token arrays, prompt first): they
    may part only where the reference's top-2 gap is under ``near_tie``
    (the products of another shape round otherwise). Returns how many
    parted."""
    parted = 0
    for i, (g, ref, n) in enumerate(zip(got, refs, lengths)):
        g, ref = np.asarray(g), np.asarray(ref)
        if g.shape != ref.shape:
            raise CheckFailed(f"{name} request {i}: {g.shape} tokens, "
                              f"reference {ref.shape}")
        diff = np.nonzero(ref != g)[0]
        if diff.size == 0:
            continue
        j = int(diff[0])
        gap = near_tie_gap(lm, ref[:j])
        parted += 1
        log(f"  {name} request {i}: token {j - n} differs from its "
            f"reference; reference top-2 gap there {gap:.3e}")
        if gap >= near_tie:
            raise CheckFailed(f"{name} request {i} tokens differ from the "
                              f"reference at a gap of {gap}")
    return parted


def check_served_tokens(lm, greedy_generate, prompts, results, refs=None):
    """Each request's tokens against solo ``greedy_generate`` (computed
    unless ``refs`` holds them) under the near-tie rule; returns the
    references."""
    for i, r in enumerate(results):
        if r.n_generated != NEW_TOKENS:
            raise CheckFailed(f"request {i} generated {r.n_generated} tokens")
    if refs is None:
        refs = [greedy_generate(lm, p[None], NEW_TOKENS, device=DEVICE)[0]
                .cpu().numpy() for p in prompts]
    check_near_ties(lm, "served", [r.tokens for r in results], refs,
                    [len(p) for p in prompts])
    # the first served token is the argmax of the full-sequence forward
    p, r = prompts[0], results[0]
    with torch.no_grad():
        lp = lm(torch.as_tensor(p, dtype=torch.long)[None].to(DEVICE))[0, -1]
    first = int(lp.argmax())
    if first != int(r.generated[0]):
        gap = near_tie_gap(lm, p)
        log(f"  request 0 first token {int(r.generated[0])} vs full-forward "
            f"argmax {first}; top-2 gap {gap:.3e}")
        if gap >= NEAR_TIE:
            raise CheckFailed("first served token differs from the "
                              "full-sequence forward's argmax")
    return refs


# ---------------------------------------------------------------- phase 6
def build_train_lm(TransformerLM, attention_impl, device, remat=False):
    return TransformerLM(VOCAB, EMBED, HEADS, LAYERS, TRAIN_LEN,
                         attention_impl=attention_impl, remat=remat,
                         generator=torch.Generator().manual_seed(SEED + 4),
                         device=device)


def check_train_step(TransformerLM, lm_criterion):
    """Loss and every parameter's gradient of one (2, 512) step on the card
    (all four kernels) against the same weights on the CPU with the plain
    LayerNorm and ``attention_impl="full"``. Tolerances: loss relative 1e-4;
    per parameter ``|g - g_ref| / |g_ref|`` (Frobenius norms) <= 1e-3."""
    rng = np.random.default_rng(SEED + 4)
    ids = torch.from_numpy(rng.integers(0, VOCAB, (2, TRAIN_LEN + 1)))
    x, y = ids[:, :-1], ids[:, 1:]
    crit = lm_criterion()
    runs = []
    for device, impl in ((DEVICE, "auto"), ("cpu", "full")):
        lm = build_train_lm(TransformerLM, impl, device)
        names, params = zip(*lm.named_parameters())
        loss = crit(lm(x.to(device)), y.to(device))
        grads = torch.autograd.grad(loss, params)
        runs.append((loss.item(), {n: g.detach().cpu()
                                   for n, g in zip(names, grads)}))
        del lm, loss, grads
    (loss, grads), (loss_ref, grads_ref) = runs
    rel_loss = abs(loss - loss_ref) / abs(loss_ref)
    rel = {n: float((grads[n] - g).norm() / g.norm().clamp(min=1e-30))
           for n, g in grads_ref.items()}
    worst = max(rel, key=rel.get)
    log(f"  one (2, {TRAIN_LEN}) step: loss {loss:.6f} vs CPU plain "
        f"{loss_ref:.6f} (relative {rel_loss:.2e}, limit 1e-4); gradients "
        f"of {len(rel)} parameters, worst relative error {rel[worst]:.2e} "
        f"({worst}, limit 1e-3)")
    if rel_loss > 1e-4 or rel[worst] > 1e-3:
        raise CheckFailed(f"training step disagrees with the CPU plain "
                          f"model: loss {rel_loss:.3e}, {worst} "
                          f"{rel[worst]:.3e}")
    return loss_ref, grads_ref


def rel_errors(grads, grads_ref) -> dict:
    return {n: float((grads[n] - g).norm() / g.norm().clamp(min=1e-30))
            for n, g in grads_ref.items()}


def check_train_step_bf16(TransformerLM, lm_criterion, fp32_ref):
    """The bf16 mixed-precision step (``Engine.init(compute_dtype=
    torch.bfloat16)``): the loss and every master gradient of one (2, 512)
    step on the card (all five kernels in bf16, bf16 gamma and beta)
    against the port's plain bf16 step on the CPU with the same weights
    (the same casts; plain LayerNorm, ``attention_impl="full"``), both
    through ``LocalOptimizer``'s loss-and-gradient path. Tolerances, sized
    for bf16 (8 significant bits, 2^-9 relative rounding, compounded over
    6 blocks and a 32000-way head): loss relative 1e-2; per parameter
    ``|g - g_ref| / |g_ref|`` (Frobenius) <= 5e-2. The CPU bf16 step's own
    distance from the fp32 step is printed beside them (not a check)."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer

    rng = np.random.default_rng(SEED + 4)
    ids = torch.from_numpy(rng.integers(0, VOCAB, (2, TRAIN_LEN + 1)))
    x, y = ids[:, :-1], ids[:, 1:]
    runs = []
    for device, impl in ((DEVICE, "auto"), ("cpu", "full")):
        lm = build_train_lm(TransformerLM, impl, device)
        opt = LocalOptimizer(lm, DataSet.array([]), lm_criterion(),
                             device=device)
        names, params = zip(*lm.named_parameters())
        loss, grads = opt._loss_and_grads(list(params), x.to(device),
                                          y.to(device))
        if any(g.dtype != torch.float32 for g in grads):
            raise CheckFailed("the bf16 step's master gradients are not fp32")
        runs.append((loss.item(), {n: g.detach().cpu()
                                   for n, g in zip(names, grads)}))
        del lm, opt, loss, grads
    (loss, grads), (loss_ref, grads_ref) = runs
    rel_loss = abs(loss - loss_ref) / abs(loss_ref)
    rel = rel_errors(grads, grads_ref)
    worst = max(rel, key=rel.get)
    policy = rel_errors(grads_ref, fp32_ref[1])
    p_worst = max(policy, key=policy.get)
    log(f"  one (2, {TRAIN_LEN}) bf16 step: loss {loss:.6f} vs CPU plain "
        f"bf16 {loss_ref:.6f} (relative {rel_loss:.2e}, limit 1e-2); "
        f"gradients of {len(rel)} parameters, worst relative error "
        f"{rel[worst]:.2e} ({worst}, limit 5e-2); CPU bf16 against CPU "
        f"fp32: loss {abs(loss_ref - fp32_ref[0]) / abs(fp32_ref[0]):.2e}, "
        f"worst gradient {policy[p_worst]:.2e} ({p_worst})")
    if rel_loss > 1e-2 or rel[worst] > 5e-2:
        raise CheckFailed(f"bf16 training step disagrees with the CPU plain "
                          f"bf16 step: loss {rel_loss:.3e}, {worst} "
                          f"{rel[worst]:.3e}")
    return {"rel_loss": rel_loss, "worst_grad_rel": rel[worst]}


# kernel kinds of a profiled step, by words in the kernel's name (first
# match wins): the port's five kernels, the library's matrix products, the
# rest (elementwise and reduction glue, softmax, copies)
KERNEL_KINDS = (("ported kernels", ("ln_fwd", "ln_bwd", "flash_")),
                ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")))


def profile_step(opt, batch, card, kinds=KERNEL_KINDS):
    """Device time of one more training step by kernel name, from
    ``torch.profiler`` (reported only: the measurement, not a check)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def placed(a):     # a batch's tensor, or a tuple of them (seq2seq)
        return tuple(placed(x) for x in a) if isinstance(a, (tuple, list)) \
            else torch.as_tensor(a).to(DEVICE)

    inp, target = placed(batch.input), placed(batch.target)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            opt.train_step(inp, target)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]

        def dev_ms(e):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            return us / 1e3

        busy = sum(dev_ms(e) for e in events)
        calls = {name: sum(e.count for e in prof.key_averages()
                           if e.key == name)
                 for name in ("cudaLaunchKernel", "cudaGraphLaunch")}
        top = sorted(events, key=dev_ms, reverse=True)[:15]
        host = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    except Exception as e:  # noqa: BLE001 — an observation, not a check
        log(f"  profiler: no device times ({type(e).__name__}: {e})")
        return None
    shares, launched = {}, {}
    for e in events:
        name = e.key.lower()
        kind = next((k for k, words in kinds if any(
            w in name for w in words)), "other")
        shares[kind] = shares.get(kind, 0.0) + dev_ms(e)
        launched[kind] = launched.get(kind, 0) + e.count
    log(f"  profiled step: {wall_ms:.2f} ms wall, device busy {busy:.2f} ms "
        f"({busy / wall_ms:.1%}) over {len(events)} kernel names; by kind "
        f"{ {k: round(v, 3) for k, v in shares.items()} } ms; host calls "
        f"{calls} [{card}]")
    for e in top:
        log(f"    {dev_ms(e):9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    log("  host ops by self time (under the profiler, which adds to each):")
    for e in host:
        log(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:80]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "by_kind_ms": shares,
            "kernels_by_kind": launched, "host_calls": calls,
            "top": [[e.key[:90], dev_ms(e), e.count] for e in top]}


def eager_reference(TransformerLM, lm_criterion, kernels, method, steps,
                    remat, llama=False):
    """The same steps run eagerly on the card: a fresh model from the same
    seed, the trainer's step function called directly on each recorded
    batch with the host's step numbers, as the program would replay it.
    Returns the losses, the parameters and the launches of those steps."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer
    from bigdl_tpu_torch.optim.optim_method import hyper_tensor

    build = build_llama_lm if llama else build_train_lm
    lm = build(TransformerLM, "auto", DEVICE, remat=remat)
    opt = LocalOptimizer(lm, DataSet.array([]), lm_criterion(llama),
                         device=DEVICE).set_optim_method(method)
    named, scales, mask = opt._prepare_step()
    step = opt._make_step_fn(named, scales, mask)
    kernels.reset_launch_counts()
    losses = [float(step(inp, target, hyper_tensor(
        opt._method.hyper(k, opt._ostate), list(named.values()))))
        for k, (inp, target) in enumerate(steps)]
    torch.cuda.synchronize()
    return losses, {n: p.detach() for n, p in named.items()}, \
        kernels.launch_counts()


def lm_data(batches=TRAIN_STEPS, seed=SEED):
    """Phase 6's training data: ``synthetic_ptb`` windows of TRAIN_LEN at
    TRAIN_BATCH."""
    from bigdl_tpu_torch.dataset import (
        DataSet, Sample, SampleToMiniBatch, ptb_windows, synthetic_ptb,
    )
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    RandomGenerator.set_seed(seed)
    ids = synthetic_ptb(TRAIN_BATCH * batches * TRAIN_LEN + 1,
                        vocab_size=VOCAB)
    xs, ys = ptb_windows(ids, TRAIN_LEN)
    return (DataSet.array(Sample(x, y) for x, y in zip(xs, ys))
            >> SampleToMiniBatch(TRAIN_BATCH))


def train(TransformerLM, lm_criterion, kernels, card, bf16=False,
          flat=False, remat=False, fuse=1, profile=True, compare=False,
          llama=False):
    """TRAIN_ITERS LocalOptimizer steps at batch 16 x 512 on synthetic_ptb
    windows, with ``set_fuse_steps(fuse)``: the step program is captured at
    the first step and replayed after it. In fp32 or (``bf16``) under the
    bf16 mixed-precision policy, with the per-leaf update or (``flat``)
    the flat update, and (``remat``) with every block under ``Remat``.
    Returns the launch counts of the run (in all, and by dtype) and its
    step time: the median between consecutive step ends after the first
    (fuse 1) or the wall of the second window, all replays, over its
    steps. With ``compare`` the same steps run eagerly
    (:func:`eager_reference`) and the replayed losses, parameters and
    launches are held against them; with ``profile`` one more replayed
    step's device time by kernel."""
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    def method():
        return SGD(learningrate=0.01, momentum=0.9, dampening=0.0)

    data = lm_data()
    build = build_llama_lm if llama else build_train_lm
    lm = build(TransformerLM, "auto", DEVICE, remat=remat)
    opt = (LocalOptimizer(lm, data, lm_criterion(llama), device=DEVICE)
           .set_optim_method(method())
           .set_end_when(Trigger.max_iteration(TRAIN_ITERS))
           .set_flat_update(flat).set_fuse_steps(fuse))
    losses, marks, windows, seen = [], [], [], []
    run_steps = opt._run_steps

    def recorded(steps):
        out = run_steps(steps)
        marks.append(time.perf_counter())
        losses.extend(out)
        windows.append(len(steps))
        if compare:
            seen.extend((a.clone(), b.clone()) for a, b in steps)
        return out

    opt._run_steps = recorded
    # the plain LayerNorm backward must not run on the card
    from bigdl_tpu_torch.kernels import layernorm as ln_module
    plain_bwd, plain_calls = ln_module.layer_norm_backward, []

    def counted_plain_bwd(*args):
        plain_calls.append(1)
        return plain_bwd(*args)

    ln_module.layer_norm_backward = counted_plain_bwd
    torch.cuda.synchronize()
    try:
        # the training path: counted from here ...
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()     # ... to here
        by_dtype = kernels.launch_counts_by_dtype()
        if compare:
            ref = eager_reference(TransformerLM, lm_criterion, kernels,
                                  method(), seen, remat, llama)
    finally:
        opt._run_steps = run_steps
        ln_module.layer_norm_backward = plain_bwd
    what = ("llama " if llama else "") + \
        ("bf16 steps" if bf16 else "steps") + \
        (" with the flat update" if flat else "") + \
        (" with remat" if remat else "") + f", fuse {fuse}"
    if len(losses) != TRAIN_ITERS or not all(np.isfinite(losses)):
        raise CheckFailed(f"training gave losses {losses}")
    if fuse == 1:
        step_ms = float(statistics.median(np.diff(marks))) * 1e3
    else:
        if windows[:2] != [fuse, fuse]:
            raise CheckFailed(f"windows {windows}, not two of {fuse} first")
        step_ms = (marks[1] - marks[0]) / fuse * 1e3
    tokens = TRAIN_BATCH * TRAIN_LEN
    log(f"  {TRAIN_ITERS} {what} at ({TRAIN_BATCH}, {TRAIN_LEN}): windows "
        f"{windows}; losses {[round(v, 4) for v in losses]}; first window "
        f"(warm-up and capture) {(marks[0] - t0) * 1e3:.1f} ms, step "
        f"{step_ms:.2f} ms, {tokens / step_ms * 1e3:.0f} tokens/s; "
        f"{wall:.2f} s in all [{card}]")
    log(f"  launches on the training path ({what}): {by_dtype} "
        f"({ {k: v / TRAIN_ITERS for k, v in counts.items()} } a step)")
    for name, n in counts.items():
        if n == 0 and name not in NMS_KERNELS and not (
                llama and name.startswith("layer_norm")):
            raise CheckFailed(f"the training path never launched {name}")
    # LN: two a block, one final (none with RMSNorm); under remat a block's
    # forward kernels run again when its backward recomputes it
    runs = 2 if remat else 1
    norms = 0 if llama else 1
    layers = LLAMA_LAYERS if llama else LAYERS
    ln_per_run = (2 * layers + 1) * TRAIN_ITERS * norms
    ln_fwd = (2 * layers * runs + 1) * TRAIN_ITERS * norms
    flash_fwd = layers * runs * TRAIN_ITERS
    if (counts["layer_norm_fwd"] != ln_fwd
            or counts["flash_attention_bwd_dq"] != layers * TRAIN_ITERS
            or counts["flash_attention_bwd_dkv"] != layers * TRAIN_ITERS
            or counts["layer_norm_bwd"] != ln_per_run
            or counts["flash_attention_fwd"] != flash_fwd or plain_calls):
        raise CheckFailed(f"the training path ({what}) launched "
                          f"layer_norm_fwd {counts['layer_norm_fwd']}, "
                          f"layer_norm_bwd {counts['layer_norm_bwd']} and "
                          f"flash_attention_fwd "
                          f"{counts['flash_attention_fwd']} times (expected "
                          f"{ln_fwd}, {ln_per_run} and {flash_fwd}) and ran "
                          f"the plain backward {len(plain_calls)} times")
    # every launch in the run's dtypes: bf16 operands (and, for LayerNorm,
    # bf16 gamma and beta) under the bf16 policy, fp32 otherwise
    want = "bfloat16" if bf16 else "float32"
    for name, split in by_dtype.items():
        key = f"{want}/{want}" if name.startswith("layer_norm") else want
        if counts[name] and split != {key: counts[name]}:
            raise CheckFailed(f"the training path ({what}) launched {name} "
                              f"as {split}, not all as {key}")
    check = compare_eager(what, losses, lm, counts, ref, bf16,
                          bitwise_required=llama) if compare else None
    prof = (profile_step(opt, next(iter(data.data(train=True))), card)
            if profile else None)
    return counts, dict(losses=losses, step_ms=step_ms,
                        tokens_per_s=tokens / step_ms * 1e3,
                        first_window_ms=(marks[0] - t0) * 1e3, profile=prof,
                        by_dtype=by_dtype, windows=windows, eager=check)


def compare_eager(what, losses, lm, counts, ref, bf16,
                  bitwise_required=False):
    """The replayed run against the same steps run eagerly: every loss
    within the one-step check's loss tolerance (relative 1e-4, bf16 1e-2),
    every parameter within its gradient tolerance (relative Frobenius 1e-3,
    bf16 5e-2), and the same launches of every kernel. Reports the largest
    differences and whether everything is bitwise equal, which
    ``bitwise_required`` demands."""
    ref_losses, ref_params, ref_counts = ref
    loss_tol, param_tol = (1e-2, 5e-2) if bf16 else (1e-4, 1e-3)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    params = dict(lm.named_parameters())
    rel = {n: float((params[n].detach() - p).norm()
                    / p.norm().clamp(min=1e-30))
           for n, p in ref_params.items()}
    worst = max(rel, key=rel.get)
    abs_err = max(max_err(params[n].detach(), p)
                  for n, p in ref_params.items())
    bitwise = losses == ref_losses and all(
        torch.equal(params[n].detach(), p) for n, p in ref_params.items())
    log(f"  {what}, replayed against eager on the card: losses relative "
        f"{loss_rel:.2e} (limit {loss_tol}), parameters worst relative "
        f"{rel[worst]:.2e} ({worst}, limit {param_tol}), max|err| "
        f"{abs_err:.3e}; bitwise {bitwise}; launches a step "
        f"{ {k: v / TRAIN_ITERS for k, v in counts.items()} } replayed, "
        f"{ {k: v / TRAIN_ITERS for k, v in ref_counts.items()} } eager")
    if loss_rel > loss_tol or rel[worst] > param_tol:
        raise CheckFailed(f"{what}: the replayed steps depart from the eager "
                          f"ones: losses {loss_rel:.3e}, {worst} "
                          f"{rel[worst]:.3e}")
    if counts != ref_counts:
        raise CheckFailed(f"{what}: replayed launches {counts} against "
                          f"eager {ref_counts}")
    if bitwise_required and not bitwise:
        raise CheckFailed(f"{what}: the replayed steps are not bitwise "
                          f"equal to the eager ones")
    return {"loss_rel": loss_rel, "param_rel": rel[worst],
            "param_max_abs_err": abs_err, "bitwise": bitwise,
            "launches_per_step": {k: v / TRAIN_ITERS
                                  for k, v in counts.items()}}


# ---------------------------------------------------------------- phase 7
def build_llama_lm(TransformerLM, attention_impl, device, remat=False,
                   max_len=TRAIN_LEN, dropout=0.0):
    """The llama-style model at full width, its depth cut:
    ``TransformerLM(32000, 512, 8, LLAMA_LAYERS)`` with 2 KV heads, RoPE,
    RMSNorm, SwiGLU and the fused head."""
    return TransformerLM(VOCAB, EMBED, HEADS, LLAMA_LAYERS, max_len,
                         dropout=dropout, remat=remat,
                         attention_impl=attention_impl,
                         generator=torch.Generator().manual_seed(SEED + 8),
                         device=device, **LLAMA)


def check_llama_step(TransformerLM, lm_criterion, bf16):
    """Loss and every gradient of one (2, 256) step of a small llama-style
    model, ``TransformerLM(8192, 512, 8, 2, **LLAMA)`` through
    ``lm_criterion(fused_head=True, chunk_size=2048)``, on the card (flash
    kernels) against the same weights on the CPU (``attention_impl=
    "full"``), both through ``LocalOptimizer``'s loss-and-gradient path
    (under the bf16 policy with ``bf16``). Tolerances as phase 6: fp32
    loss 1e-4 and gradients 1e-3 relative; bf16 1e-2 and 5e-2."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer

    rng = np.random.default_rng(SEED + 9)
    ids = torch.from_numpy(rng.integers(0, 8192, (2, 257)))
    x, y = ids[:, :-1], ids[:, 1:]
    runs = []
    for device, impl in ((DEVICE, "auto"), ("cpu", "full")):
        lm = TransformerLM(8192, EMBED, HEADS, 2, 256, attention_impl=impl,
                           generator=torch.Generator().manual_seed(SEED + 9),
                           device=device, **LLAMA)
        opt = LocalOptimizer(lm, DataSet.array([]),
                             lm_criterion(True, chunk_size=2048),
                             device=device)
        names, params = zip(*lm.named_parameters())
        loss, grads = opt._loss_and_grads(list(params), x.to(device),
                                          y.to(device))
        runs.append((loss.item(), {n: g.detach().cpu()
                                   for n, g in zip(names, grads)}))
        del lm, opt, loss, grads
    (loss, grads), (loss_ref, grads_ref) = runs
    rel_loss = abs(loss - loss_ref) / abs(loss_ref)
    rel = rel_errors(grads, grads_ref)
    worst = max(rel, key=rel.get)
    loss_tol, grad_tol = (1e-2, 5e-2) if bf16 else (1e-4, 1e-3)
    log(f"  llama one (2, 256) {'bf16 ' if bf16 else ''}step: loss "
        f"{loss:.6f} vs CPU plain {loss_ref:.6f} (relative {rel_loss:.2e}, "
        f"limit {loss_tol}); gradients of {len(rel)} parameters, worst "
        f"relative error {rel[worst]:.2e} ({worst}, limit {grad_tol})")
    if rel_loss > loss_tol or rel[worst] > grad_tol:
        raise CheckFailed(f"llama training step disagrees with the CPU plain "
                          f"model: loss {rel_loss:.3e}, {worst} "
                          f"{rel[worst]:.3e}")
    return {"rel_loss": rel_loss, "worst_grad_rel": rel[worst]}


def cache_bytes(state) -> int:
    if isinstance(state, dict):
        return sum(cache_bytes(v) for v in state.values())
    return state.numel() * state.element_size()


def beam_search(lm, nn, card):
    """One ``SequenceBeamSearch`` (beam 3, decode 32, a 128-token seed, the
    full forward a step through the flash kernel) and one ``beam_generate``
    (KV-cached, plain cached attention) over the same model: their
    sequences must be equal. The search's candidate selections are
    recorded: where the two differ, the smallest gap a selection rested on
    must be under the near-tie bound (the flash kernel and the plain
    attention round differently)."""
    from bigdl_tpu_torch.nn import beam_search as bs_module

    rng = np.random.default_rng(SEED + 10)
    seed = rng.integers(0, VOCAB, (1, BEAM_SEED))
    gaps = []
    top_k = bs_module._top_k

    def recorded(x, k):
        vals, idx = top_k(x, k + 1 if k < x.shape[-1] else k)
        real = vals > bs_module._NEG / 2
        d = (vals[..., :-1] - vals[..., 1:])[real[..., 1:]]
        if d.numel():
            gaps.append(float(d.min()))
        return vals[..., :k], idx[..., :k]

    search = nn.SequenceBeamSearch(lm, BEAM, -1, BEAM_DECODE, alpha=0.6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs_module._top_k = recorded
    try:
        out = search.forward(seed)
    finally:
        bs_module._top_k = top_k
    torch.cuda.synchronize()
    static_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seqs, scores = nn.beam_generate(lm, seed, BEAM_DECODE, BEAM, -1, 0.6)
    torch.cuda.synchronize()
    cached_s = time.perf_counter() - t0
    equal = bool(torch.equal(out[1], seqs))
    score_err = max_err(out[2], scores)
    min_gap = min(gaps)
    log(f"  beam search (beam {BEAM}, decode {BEAM_DECODE}, seed "
        f"{BEAM_SEED}): SequenceBeamSearch {static_s * 1e3:.1f} ms "
        f"({BEAM_DECODE} full forwards at {BEAM_SHAPE}), beam_generate "
        f"{cached_s * 1e3:.1f} ms ({BEAM_SEED + BEAM_DECODE - 1} cached "
        f"steps); sequences equal {equal}, scores max|err| {score_err:.3e}, "
        f"smallest selection gap {min_gap:.3e} [{card}]")
    if not equal and min_gap >= NEAR_TIE:
        raise CheckFailed("SequenceBeamSearch and beam_generate chose other "
                          f"sequences with no near-tie (gap {min_gap})")
    if equal and score_err > 1e-3:
        raise CheckFailed(f"beam scores differ by {score_err}")
    return {"static_ms": static_s * 1e3, "cached_ms": cached_s * 1e3,
            "sequences_equal": equal, "score_max_abs_err": score_err,
            "min_selection_gap": min_gap}


def dropout_step(TransformerLM, lm_criterion, card):
    """Three bf16 steps of the full-width llama model with dropout 0.1 on
    one batch at learning rate 0: the first is the warm-up and capture, the
    next two are replays; each replay draws new masks, so their losses
    differ."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer

    lm = build_llama_lm(TransformerLM, "auto", DEVICE, dropout=0.1)
    opt = (LocalOptimizer(lm, DataSet.array([]), lm_criterion(True),
                          device=DEVICE)
           .set_optim_method(SGD(learningrate=0.0)))
    rng = np.random.default_rng(SEED + 11)
    x, y = (torch.from_numpy(rng.integers(0, VOCAB, (TRAIN_BATCH,
                                                     TRAIN_LEN))).cuda()
            for _ in range(2))
    losses = [opt.train_step(x, y) for _ in range(3)]
    replays = opt._step_program.replays
    log(f"  dropout 0.1, bf16, one batch three times (lr 0): losses "
        f"{losses}; replays {replays}")
    if replays != 2 or losses[1] == losses[2] or \
            not all(np.isfinite(losses)):
        raise CheckFailed(f"dropout replays did not draw new masks: "
                          f"{losses}, {replays} replays")
    return {"losses": losses, "replays": replays}


def time_head(nn, card):
    """The LM head's forward and backward at (8192, 512) x 32000 under the
    bf16 policy, as the step runs it: the fused head (bf16 hidden, weight
    and bias cast to fp32, ``chunked_softmax_xent`` in chunks of 8192, fp32
    products with TF32 off) against the unfused one (bf16 ``Linear``, the
    fp32 ``LogSoftMax`` island, NLL), with their bounds: four fp32 products
    of 2·N·V·d on the CUDA cores (67 TFLOP/s) for the fused head, two bf16
    ones plus the fp32 softmax's bytes for the unfused one."""
    import torch.nn.functional as F

    n, d = TRAIN_BATCH * TRAIN_LEN, EMBED
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    h = torch.randn(n, d, generator=g, device=DEVICE).bfloat16()
    w = (torch.randn(VOCAB, d, generator=g, device=DEVICE) * 0.02).bfloat16()
    b = torch.zeros(VOCAB, device=DEVICE).bfloat16()
    labels = torch.randint(0, VOCAB, (n,), generator=g, device=DEVICE)
    for t in (h, w, b):
        t.requires_grad_()

    def fused():
        loss = nn.chunked_softmax_xent(h.float(), w.float(), b.float(),
                                       labels, HEAD_CHUNK).mean()
        return torch.autograd.grad(loss, (h, w, b))

    def unfused():
        logp = F.log_softmax(F.linear(h, w, b).float(), dim=-1)
        return torch.autograd.grad(F.nll_loss(logp, labels), (h, w, b))

    with torch.no_grad():
        ref = (F.log_softmax((h.float() @ w.float().T + b.float()), -1)
               .gather(1, labels[:, None])[:, 0].neg())
    got = nn.chunked_softmax_xent(h.float(), w.float(), b.float(), labels,
                                  HEAD_CHUNK).detach()
    err = max_err(got, ref)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fused()
    fused_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    unfused()
    unfused_peak = torch.cuda.max_memory_allocated() - base
    f_ms, _ = time_ms(fused, reps=3, trials=3)
    u_ms, _ = time_ms(unfused, reps=3, trials=3)
    fma_ms = 4 * 2.0 * n * VOCAB * d / PEAK_FLOPS["float32"] * 1e3
    bf16_ms = max(2 * 2.0 * n * VOCAB * d / PEAK_FLOPS["bfloat16"],
                  4 * n * VOCAB * 4 / HBM_BYTES_PER_S) * 1e3
    log(f"  LM head forward + backward at ({n}, {d}) x {VOCAB}: fused "
        f"{f_ms:.3f} ms (bound {fma_ms:.3f} ms: four fp32 products on the "
        f"CUDA cores; peak memory {fused_peak / 2**20:.0f} MiB), unfused "
        f"bf16 {u_ms:.3f} ms (bound {bf16_ms:.3f} ms; peak "
        f"{unfused_peak / 2**20:.0f} MiB); fused losses against the plain "
        f"fp32 head max|err| {err:.3e} [{card}]")
    if err > 1e-3:
        raise CheckFailed(f"the fused head's losses disagree with the plain "
                          f"head: {err}")
    return {"fused_ms": f_ms, "unfused_ms": u_ms, "fused_bound_ms": fma_ms,
            "unfused_bound_ms": bf16_ms, "fused_peak_bytes": fused_peak,
            "unfused_peak_bytes": unfused_peak, "max_abs_err": err}


def llama_path(TransformerLM, lm_criterion, nn, kernels, card,
               ServingEngine, pick_bucket, Engine):
    """Phase 7: the llama-style path at full width. Its serving path (the
    full forward, two serving rounds, the beam searches) and its bf16
    training runs are each counted from a reset."""
    checks = {"fp32": check_llama_step(TransformerLM, lm_criterion, False)}
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        checks["bf16"] = check_llama_step(TransformerLM, lm_criterion, True)
        counts, run = train(TransformerLM, lm_criterion, kernels, card,
                            bf16=True, compare=True, llama=True)
        _, run_fused = train(TransformerLM, lm_criterion, kernels, card,
                             bf16=True, fuse=FUSE, compare=True,
                             profile=False, llama=True)
        drop = dropout_step(TransformerLM, lm_criterion, card)
    finally:
        Engine.reset()
    head = time_head(nn, card)

    lm = build_llama_lm(TransformerLM, "auto", DEVICE,
                        max_len=MAX_LEN).evaluate()
    # the serving path: counted from here ...
    kernels.reset_launch_counts()
    full_forward(lm, lambda: build_llama_lm(TransformerLM, "full", "cpu",
                                            max_len=MAX_LEN).evaluate())
    fwd_counts = kernels.launch_counts()
    prompts, rounds = serve(lm, ServingEngine)
    serve_counts = kernels.launch_counts()
    beams = beam_search(lm, nn, card)
    launches = kernels.launch_counts()     # ... to here
    (results, wall, stats0), (results2, wall2, stats) = rounds
    cold = report_round("llama first round (captures)", results, wall,
                        stats0, {}, card)
    warm = report_round("llama second round (replays only)", results2,
                        wall2, stats, stats0, card)
    check_served_tokens(lm, nn.greedy_generate, prompts, results)
    if any(not np.array_equal(a.tokens, b.tokens)
           for a, b in zip(results, results2)):
        raise CheckFailed("the llama engine's second round served other "
                          "tokens")
    programs = check_programs(stats, prompts, stats["buckets"], pick_bucket,
                              serve_counts, fwd_counts, ln_per_call=0)
    from bigdl_tpu_torch.utils.programs import Program
    tick_profile = decode_kernels(lm, nn.install_decode_cache, Program, card,
                                  "llama")
    engine_cache = cache_bytes(nn.install_decode_cache(lm, SLOTS, MAX_LEN))
    mha_cache = engine_cache * HEADS // LLAMA["num_kv_heads"]
    log(f"  llama serving: tokens match solo greedy_generate in both rounds; "
        f"the {SLOTS}-slot, {MAX_LEN}-position fp32 cache is "
        f"{engine_cache / 1e6:.1f} MB ({LLAMA['num_kv_heads']} KV heads; "
        f"{mha_cache / 1e6:.1f} MB with {HEADS}); launches {launches} "
        f"(full forward {fwd_counts})")
    if launches["flash_attention_fwd"] != LLAMA_LAYERS * (1 + BEAM_DECODE):
        raise CheckFailed(f"the llama serving path launched the flash "
                          f"forward {launches['flash_attention_fwd']} times, "
                          f"not {LLAMA_LAYERS * (1 + BEAM_DECODE)}")
    del lm
    torch.cuda.empty_cache()
    beam_counts = {k: launches[k] - serve_counts[k] for k in launches}
    return {"counts": counts, "serving_counts": launches,
            "beam_counts": beam_counts, "summary": {
        "one_step_check": checks,
        "training_bf16": {"step_ms": run["step_ms"],
                          "tokens_per_s": run["tokens_per_s"],
                          "replay_vs_eager": run["eager"],
                          "profile": {k: (run["profile"] or {}).get(k)
                                      for k in ("busy_ms", "wall_ms",
                                                "by_kind_ms", "host_calls")},
                          "fused": {"fuse": FUSE,
                                    "step_ms": run_fused["step_ms"],
                                    "tokens_per_s": run_fused["tokens_per_s"],
                                    "replay_vs_eager": run_fused["eager"]}},
        "dropout": drop, "head": head,
        "serving": {"programs": programs, "first_round": cold,
                    "second_round": warm, "cache_bytes": engine_cache,
                    "decode_step_profile": tick_profile,
                    "cache_bytes_all_heads": mha_cache},
        "beam_search": beams}}


# ---------------------------------------------------------------- phase 8
# the vision path: the JAX bench's resnet50 leg (bigdl_tpu/benchmark.py:
# 215-309): ImageNormalize -> ResNet-50 with the space-to-depth stem, NHWC
# (:197), uint8 224x224x3 pixels normalised on the card (:231-237), batch
# 256 (:163), ClassNLLCriterion (:239), 8 in-memory batches, SGD(0.01,
# momentum 0.9, dampening 0) (:354), bf16 (:349)
VISION_BATCH, VISION_HW, VISION_CLASSES = 256, 224, 1000
RESNET50_STEP_FLOPS = 3 * 2 * 4.09e9 * VISION_BATCH       # benchmark.py:42
VISION_PARITY_BATCH = 2
# each residual branch's last BN gamma in the one-step check's second bf16
# step, where the backward does not amplify rounding (check_resnet_step)
DAMPED_GAMMA = 0.05
# bf16 against fp32 losses: the first (rounding only, the one-step
# check's 1e-2) and all 17 (the trajectories also drift apart)
VISION_DRIFT = (1e-2, 5e-2)
VISION_FOLD_FP32 = 1e-3  # folded against unfused log-probs, relative
# kinds of a profiled vision step, by words in the kernel's name (first
# match wins)
VISION_KINDS = (
    ("layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "implicit")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("pooling", ("pool",)),
    ("bn/elementwise", ("elementwise", "reduce", "vectorized", "unrolled",
                        "batch_norm")))


def build_resnet50(device, seed=SEED + 8):
    """``ImageNormalize -> ResNet-50`` (s2d stem), weights from a seed."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.resnet import ResNet
    net = ResNet(VISION_CLASSES, {"depth": 50, "dataSet": "ImageNet",
                                  "conv1SpaceToDepth": True},
                 generator=torch.Generator().manual_seed(seed), device=device)
    return nn.Sequential().add(nn.ImageNormalize()).add(net).to(device)


def vision_batches(n, seed):
    """``n`` uint8 NHWC batches of 256 with labels, made from a seed."""
    from bigdl_tpu_torch.dataset import MiniBatch
    r = np.random.default_rng(seed)
    return [MiniBatch(r.integers(0, 256, (VISION_BATCH, VISION_HW, VISION_HW,
                                          3), dtype=np.uint8),
                      r.integers(0, VISION_CLASSES, VISION_BATCH).astype(
                          np.int32)) for _ in range(n)]


def flat_rel(a: dict, b: dict) -> float:
    """Relative Frobenius distance of two gradient sets, the whole model."""
    num = sum(float((a[n] - g).double().norm()) ** 2 for n, g in b.items())
    den = sum(float(g.double().norm()) ** 2 for g in b.values())
    return math.sqrt(num / max(den, 1e-300))


def resnet_loss_and_grads(model, x, y, device):
    """Loss, gradients (host, fp32) and running statistics after one
    forward and backward of the training step's own path."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import LocalOptimizer
    opt = LocalOptimizer(model, DataSet.array([]), ClassNLLCriterion(),
                         device=device)
    names, params = zip(*model.named_parameters())
    loss, grads = opt._loss_and_grads(list(params), x.to(device),
                                      y.to(device))
    stats = {n: b.detach().cpu().clone() for n, b in model.named_buffers()
             if "running" in n}
    return loss.item(), {n: g.detach().cpu().float()
                         for n, g in zip(names, grads)}, stats


def damp_residuals(model, gamma=DAMPED_GAMMA):
    """``model`` (as :func:`build_resnet50` makes it) with each residual branch's last BN gamma (the parameters
    that ``zeroInitResidual`` zeroes) set to ``gamma``, in place."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.resnet import ResNet
    zeroed = ResNet(VISION_CLASSES, {"depth": 50, "dataSet": "ImageNet",
                                     "conv1SpaceToDepth": True,
                                     "zeroInitResidual": True},
                    device="cpu")
    # the ResNet is the second child of build_resnet50's Sequential
    names = {"1." + n for n, p in zeroed.named_parameters()
             if n.endswith(".weight") and p.dim() == 1 and not bool(p.any())}
    params = dict(model.named_parameters())
    assert len(names) == 16 and names <= set(params), names
    with torch.no_grad():
        for n in names:
            params[n].fill_(gamma)
    return model


def gradient_groups(model) -> dict:
    """Parameter names by group: the whole model, each child of the ResNet
    that has parameters ("block <i>"), and the classifier (the last
    ``Linear``)."""
    from bigdl_tpu_torch import nn
    names = [n for n, _ in model.named_parameters()]
    out = {"all": names}
    for n in names:
        out.setdefault("block " + n.split(".")[1], []).append(n)
    fc = [n for n, m in model.named_modules() if isinstance(m, nn.Linear)][-1]
    out["classifier"] = [n for n in names if n.startswith(fc + ".")]
    return out


def group_rel(a: dict, b: dict, names) -> float:
    return flat_rel({n: a[n] for n in names}, {n: b[n] for n in names})


def check_resnet_step(layout, Engine):
    """One step of ``ImageNormalize -> ResNet-50`` (s2d, NHWC) at (2, 224,
    224, 3) uint8 on the card against the same weights on the CPU: the
    loss, the gradients, and the running statistics after the step, in
    fp32 (TF32 off) and under the bf16 policy.

    The loss and the statistics are smooth functions of the weights:
    fp32 within 1e-4 relative (the LM path's loss tolerance; statistics
    per buffer, Frobenius); bf16: the loss within 1e-2, the statistics
    within 1.5x the CPU bf16 step's own distance from the CPU fp32 step's
    (at least 1e-2: over 2 images the last stage's statistics are over 98
    values a channel, and bf16 inputs move them ~6%).

    The gradients are not smooth: a ReLU gate whose input lies within
    rounding of zero opens on one side and shuts on the other (a batch of
    2 at 224x224 has ~20 million gated values), and at init the backward
    amplifies any difference block by block. In fp32 the CPU runs the same
    step again in NCHW (other summation orders, the same arithmetic), and
    the card's distance from the CPU's NHWC gradient (whole model,
    relative Frobenius) must be within 3x that NCHW-to-NHWC distance (and
    within 1e-3 when that is smaller). Under bf16 the rounding alone moves
    the whole gradient at init more than 100% from the fp32 gradient, on
    the CPU and in JAX alike (tests/test_torch_resnet.py), so it is held
    only where rounding does not swamp it: per group, the card's bf16
    gradient within 1.25x the CPU bf16 step's distance from the CPU fp32
    gradient, measured from the fp32 gradient (1.5x for a tensor alone),
    and within 1.5x of it from the CPU bf16 gradient (two roundings), with
    that CPU distance under 0.5, so that every limit is below the 1.0 a
    zero gradient reads. The
    groups: the classifier at init; and, in a second bf16 step on the same
    weights with each residual branch's last BN gamma at DAMPED_GAMMA (the
    parameters ``zeroInitResidual`` zeroes; the backward is tame there),
    every block, the whole model and every tensor alone whose CPU gap is
    under 0.5."""
    import copy
    r = np.random.default_rng(SEED + 9)
    x = torch.from_numpy(r.integers(0, 256, (VISION_PARITY_BATCH, VISION_HW,
                                             VISION_HW, 3), dtype=np.uint8))
    y = torch.from_numpy(r.integers(0, VISION_CLASSES, VISION_PARITY_BATCH)
                         .astype(np.int64))
    base = build_resnet50("cpu")
    damped = damp_residuals(copy.deepcopy(base))
    groups = gradient_groups(base)
    out = {}

    def run(where, fmt, dtype, weights=base):
        layout.set_image_format(fmt)
        Engine.init(compute_dtype=dtype)
        try:
            model = copy.deepcopy(weights).to(where)
            xx = x if fmt == "NHWC" else x.permute(0, 3, 1, 2).contiguous()
            t0 = time.perf_counter()
            res = resnet_loss_and_grads(model, xx, y, where)
            if where != "cpu":
                torch.cuda.synchronize()
            del model
            return res + (time.perf_counter() - t0,)
        finally:
            Engine.reset()
            layout.set_image_format("NHWC")

    card32 = run(DEVICE, "NHWC", torch.float32)
    cpu32 = run("cpu", "NHWC", torch.float32)
    cpu32_nchw = run("cpu", "NCHW", torch.float32)
    card16 = run(DEVICE, "NHWC", torch.bfloat16)
    cpu16 = run("cpu", "NHWC", torch.bfloat16)
    card16d = run(DEVICE, "NHWC", torch.bfloat16, damped)
    cpu16d = run("cpu", "NHWC", torch.bfloat16, damped)
    cpu32d = run("cpu", "NHWC", torch.float32, damped)
    torch.cuda.empty_cache()

    def stats_rel(a, b):
        return max(float((a[n] - v).norm() / v.norm().clamp(min=1e-30))
                   for n, v in b.items())

    def worst(a, b):
        rel = rel_errors(a, b)
        k = max(rel, key=rel.get)
        return k, rel[k]

    def held(card, cpu_bf16, cpu_fp32, names, fp32_factor=1.25):
        """Per group: the CPU's bf16-vs-fp32 gap, the card's distances
        from the CPU's fp32 and bf16 gradients, and the limits."""
        gap = group_rel(cpu_bf16[1], cpu_fp32[1], names)
        return {"cpu_gap": gap,
                "to_fp32": group_rel(card[1], cpu_fp32[1], names),
                "to_bf16": group_rel(card[1], cpu_bf16[1], names),
                "limit_fp32": fp32_factor * gap, "limit_bf16": 1.5 * gap}

    order = flat_rel(cpu32_nchw[1], cpu32[1])
    g32 = flat_rel(card32[1], cpu32[1])
    out["float32"] = {
        "loss": card32[0], "loss_rel": abs(card32[0] - cpu32[0]) / cpu32[0],
        "grad_rel": g32, "grad_limit": max(3 * order, 1e-3),
        "cpu_nchw_vs_nhwc_grad_rel": order,
        "worst_tensor": worst(card32[1], cpu32[1]),
        "stats_rel": stats_rel(card32[2], cpu32[2]),
        "card_s": card32[3], "cpu_s": cpu32[3]}
    stats_noise = stats_rel(cpu16[2], cpu32[2])
    bf16_groups = {"init " + g: held(card16, cpu16, cpu32, groups[g])
                   for g in ("classifier",)}
    bf16_groups.update({f"damped {g}": held(card16d, cpu16d, cpu32d, names)
                        for g, names in groups.items() if g != "classifier"})
    # and at the damped weights every tensor alone whose CPU gap is under
    # 0.5 (all but a few, which the CPU runs alone decide): a fault
    # confined to one kind of tensor (the BN gammas' gradient, say) moves
    # its own tensors past their limits. One tensor's distance from the
    # fp32 gradient spreads more than a group's (the CPU's NCHW bf16 step
    # up to 1.11x its NHWC step's gap, the card 1.15x): 1.5x for both
    per_tensor = {n: held(card16d, cpu16d, cpu32d, [n], fp32_factor=1.5)
                  for n in groups["all"]}
    not_held = sorted(n for n, h in per_tensor.items() if h["cpu_gap"] >= 0.5)
    per_tensor = {n: h for n, h in per_tensor.items() if n not in not_held}
    out["bfloat16"] = {
        "loss": card16[0], "loss_rel": abs(card16[0] - cpu16[0]) / cpu16[0],
        "grad_rel": flat_rel(card16[1], cpu16[1]),
        "grad_rel_to_fp32": flat_rel(card16[1], cpu32[1]),
        "cpu_bf16_vs_fp32_grad_rel": flat_rel(cpu16[1], cpu32[1]),
        "worst_tensor": worst(card16[1], cpu16[1]),
        "stats_rel": stats_rel(card16[2], cpu16[2]),
        "stats_limit": max(1e-2, 1.5 * stats_noise),
        "cpu_bf16_vs_fp32_stats_rel": stats_noise,
        "damped_gamma": DAMPED_GAMMA,
        "damped_loss_rel": abs(card16d[0] - cpu16d[0]) / cpu16d[0],
        "held": bf16_groups,
        "per_tensor": {
            "tensors": len(per_tensor), "not_held": not_held,
            "max_cpu_gap": max(h["cpu_gap"] for h in per_tensor.values()),
            "worst_to_fp32": max(((n, h["to_fp32"] / h["limit_fp32"])
                                  for n, h in per_tensor.items()),
                                 key=lambda t: t[1]),
            "worst_to_bf16": max(((n, h["to_bf16"] / h["limit_bf16"])
                                  for n, h in per_tensor.items()),
                                 key=lambda t: t[1])},
        "card_s": card16[3], "cpu_s": cpu16[3]}
    b = out["bfloat16"]
    for name, c in out.items():
        log(f"  one (2, 224, 224, 3) uint8 step, {name}: loss {c['loss']:.6f} "
            f"(relative to the CPU {c['loss_rel']:.2e}); gradients, whole "
            f"model, {c['grad_rel']:.2e} from the CPU's (worst tensor "
            f"{c['worst_tensor'][0]} {c['worst_tensor'][1]:.2e}); running "
            f"statistics {c['stats_rel']:.2e}; card {c['card_s']:.2f} s, "
            f"CPU {c['cpu_s']:.2f} s")
    log(f"  fp32 gradient limit {out['float32']['grad_limit']:.2e} (the "
        f"CPU's NCHW step is {order:.2e} from its NHWC step); bf16 running "
        f"statistics {b['stats_rel']:.2e}, limit {b['stats_limit']:.2e} "
        f"(the CPU bf16 step's are {stats_noise:.2e} from its fp32 "
        f"step's); bf16 gradients at init, whole model (not held: rounding "
        f"swamps it): the CPU bf16 step {b['cpu_bf16_vs_fp32_grad_rel']:.2e} "
        f"from the CPU fp32 step, the card's {b['grad_rel_to_fp32']:.2e}")
    log(f"  bf16 gradients held (group: CPU bf16-vs-fp32 gap; the card's "
        f"distance from the CPU fp32 / bf16 gradient, each over its limit); "
        f"damped: residual branches' last BN gamma {DAMPED_GAMMA}, loss "
        f"{b['damped_loss_rel']:.2e} from the CPU's:")
    for g, h in bf16_groups.items():
        log(f"    {g}: {h['cpu_gap']:.3e}; {h['to_fp32']:.3e} / "
            f"{h['limit_fp32']:.3e}, {h['to_bf16']:.3e} / "
            f"{h['limit_bf16']:.3e}")
    pt = b["per_tensor"]
    log(f"    damped, each of {pt['tensors']} tensors alone (not held, CPU "
        f"gap 0.5 or more: {pt['not_held']}): CPU gaps up to "
        f"{pt['max_cpu_gap']:.3e}; the nearest to its limit "
        f"{pt['worst_to_fp32'][0]} at {pt['worst_to_fp32'][1]:.3f} of it "
        f"(from the CPU fp32 gradient), {pt['worst_to_bf16'][0]} at "
        f"{pt['worst_to_bf16'][1]:.3f} (from the CPU bf16 gradient)")
    f = out["float32"]
    if f["loss_rel"] > 1e-4 or f["stats_rel"] > 1e-4 \
            or f["grad_rel"] > f["grad_limit"]:
        raise CheckFailed(f"the fp32 ResNet-50 step disagrees with the CPU: "
                          f"{f}")
    bad = {g: h for g, h in list(bf16_groups.items()) + [
               ("damped tensor " + n, h) for n, h in per_tensor.items()]
           if h["cpu_gap"] >= 0.5 or h["to_fp32"] > h["limit_fp32"]
           or h["to_bf16"] > h["limit_bf16"]}
    if b["loss_rel"] > 1e-2 or b["damped_loss_rel"] > 1e-2 \
            or b["stats_rel"] > b["stats_limit"] or bad:
        raise CheckFailed(f"the bf16 ResNet-50 step disagrees with the CPU: "
                          f"{ {k: v for k, v in b.items() if k != 'held'} }; "
                          f"groups out of their limits {bad}")
    return out


def release() -> None:
    """Give the memory of the models and programs just dropped back."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def train_vision(batches, kernels, card, bf16=False, fuse=1, compare=False,
                 profile=True, build=None, name="ResNet-50",
                 step_flops=RESNET50_STEP_FLOPS, kinds=VISION_KINDS):
    """TRAIN_ITERS steps of the bench's resnet50 leg at batch 256 over the
    8 in-memory ``batches`` (a fresh dataset, so every run sees the same
    epoch orders), the step a captured program (fuse 1)
    or fused windows of ``fuse``; under the bf16 policy or in fp32. Returns
    the run's numbers and, with ``compare``, the same steps run eagerly
    from the same seed (:func:`vision_eager`), which must equal the
    replayed steps bit for bit (cuDNN runs deterministic algorithms in
    this phase), and that eagerly trained model. ``profile``: one more
    replayed step under ``torch.profiler``, its device time by ``kinds``.
    ``build`` makes the model (phase 8: :func:`build_resnet50`; phase 12:
    :func:`build_inception`), whose step has ``step_flops``."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    build = build or build_resnet50
    data = DataSet.array(batches)
    model = build(DEVICE)
    opt = (LocalOptimizer(model, data, ClassNLLCriterion(), device=DEVICE)
           .set_optim_method(SGD(learningrate=0.01, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(TRAIN_ITERS))
           .set_fuse_steps(fuse))
    losses, marks, windows, seen = [], [], [], []
    run_steps = opt._run_steps

    def recorded(steps):
        out = run_steps(steps)
        marks.append(time.perf_counter())
        losses.extend(out)
        windows.append(len(steps))
        if compare:
            seen.extend((a.clone(), b.clone()) for a, b in steps)
        return out

    opt._run_steps = recorded
    RandomGenerator.set_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    waits = feed_waits()
    t0 = time.perf_counter()
    try:
        opt.optimize()
        torch.cuda.synchronize()
    finally:
        opt._run_steps = run_steps
    wall = time.perf_counter() - t0
    waits = waits()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    what = ("bf16" if bf16 else "fp32") + f" steps, fuse {fuse}"
    if len(losses) != TRAIN_ITERS or not all(np.isfinite(losses)):
        raise CheckFailed(f"{name} training gave losses {losses}")
    if fuse == 1:
        step_ms = float(statistics.median(np.diff(marks))) * 1e3
    else:
        if windows[:2] != [fuse, fuse]:
            raise CheckFailed(f"windows {windows}, not two of {fuse} first")
        step_ms = (marks[1] - marks[0]) / fuse * 1e3
    ips = VISION_BATCH / step_ms * 1e3
    share = step_flops / (step_ms * 1e-3) / PEAK_FLOPS["bfloat16"]
    feed_ms = opt.metrics.totals().get("feed", 0.0) / TRAIN_ITERS * 1e3
    log(f"  {name} {TRAIN_ITERS} {what} at ({VISION_BATCH}, {VISION_HW}, "
        f"{VISION_HW}, 3) uint8: windows {windows}; losses "
        f"{[round(v, 4) for v in losses]}; first window (warm-up and "
        f"capture) {(marks[0] - t0) * 1e3:.1f} ms; step {step_ms:.2f} ms, "
        f"{ips:.1f} images/s, {share:.1%} of the bf16 dense peak "
        f"({step_flops / 1e12:.3f} TFLOP a step); peak memory "
        f"{peak / 2**30:.2f} GiB; the loop waited {feed_ms:.3f} ms a step "
        f"on the feed (after the first: {waits}), stages "
        f"{opt.feed_stage_ms} ms, device cache "
        f"{opt._device_batch_cache is not None}; {wall:.2f} s in all "
        f"[{card}]")
    if any(counts.values()):
        raise CheckFailed(f"the vision path launched the LM kernels "
                          f"{counts}")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()
             if "running" in n}
    if any(b.dtype != torch.float32 for b in stats.values()):
        raise CheckFailed("the running statistics are not fp32")
    prof = (profile_step(opt, next(iter(data.data(train=True))), card,
                         kinds=kinds) if profile else None)
    run = dict(losses=losses, step_ms=step_ms, images_per_s=ips,
               bf16_peak_share=share, peak_memory_bytes=peak,
               first_window_ms=(marks[0] - t0) * 1e3, windows=windows,
               profile=prof, feed_wait_ms_per_step=feed_ms,
               feed_wait_ms_after_first_window=waits,
               feed_stage_ms=dict(opt.feed_stage_ms),
               device_cache=opt._device_batch_cache is not None)
    opt._step_program = None
    del opt, model, recorded, run_steps
    release()
    if not compare:
        return run, None
    ref_losses, ref = vision_eager(seen, build)
    ref_params = dict(ref.named_parameters())
    ref_stats = dict(ref.named_buffers())
    bitwise = losses == ref_losses and all(
        torch.equal(p, ref_params[n]) for n, p in params.items()) and all(
        torch.equal(b, ref_stats[n]) for n, b in stats.items())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    param_err = max(max_err(p, ref_params[n]) for n, p in params.items())
    stats_err = max((max_err(b, ref_stats[n]) for n, b in stats.items()),
                    default=0.0)
    log(f"  {what}, replayed against eager on the card: losses relative "
        f"{loss_rel:.2e}, parameters max|err| {param_err:.3e}, running "
        f"statistics max|err| {stats_err:.3e}; bitwise {bitwise}")
    if not bitwise:
        raise CheckFailed(f"{name} {what}: the replayed steps are not "
                          f"bitwise equal to the eager ones")
    run["replay_vs_eager"] = {"bitwise": bitwise, "loss_rel": loss_rel,
                              "param_max_abs_err": param_err,
                              "stats_max_abs_err": stats_err}
    return run, ref


def vision_eager(steps, build=build_resnet50):
    """The recorded steps run eagerly from the same seed: the trainer's
    step function called on each batch with the host's step numbers."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer
    from bigdl_tpu_torch.optim.optim_method import hyper_tensor

    model = build(DEVICE)
    opt = (LocalOptimizer(model, DataSet.array([]), ClassNLLCriterion(),
                          device=DEVICE)
           .set_optim_method(SGD(learningrate=0.01, momentum=0.9,
                                 dampening=0.0)))
    named, scales, mask = opt._prepare_step()
    step = opt._make_step_fn(named, scales, mask)
    losses = [float(step(inp, target, hyper_tensor(
        opt._method.hyper(k, opt._ostate), list(named.values()))))
        for k, (inp, target) in enumerate(steps)]
    torch.cuda.synchronize()
    return losses, model


def check_validation(model, card, Engine):
    """``Top1Accuracy`` and ``Top5Accuracy`` over 3 held-out batches of 256
    and a padded fourth of 100 (``valid`` < batch) through the captured
    eval program under the bf16 policy, against the same methods' host
    folds of the logits of an eager eval forward of the same batches:
    equal counts, exactly."""
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.nn.abstractnn import evaluating
    from bigdl_tpu_torch.optim.evaluator import eval_forward, run_device_eval
    from bigdl_tpu_torch.optim.validation import Top1Accuracy, Top5Accuracy

    n = 3 * VISION_BATCH + 100
    r = np.random.default_rng(SEED + 10)
    imgs = r.integers(0, 256, (n, VISION_HW, VISION_HW, 3), dtype=np.uint8)
    labels = r.integers(0, VISION_CLASSES, n).astype(np.int32)
    val = (DataSet.array(Sample(imgs[i], labels[i]) for i in range(n))
           >> SampleToMiniBatch(VISION_BATCH))
    methods = [Top1Accuracy(), Top5Accuracy()]
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        t0 = time.perf_counter()
        results, stats = run_device_eval(model, val, methods, DEVICE)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        results2, _ = run_device_eval(model, val, methods, DEVICE)
        pass2_s = time.perf_counter() - t0
        host = [None, None]
        with torch.no_grad(), evaluating(model):
            for b in val.data(train=False):
                out = eval_forward(model, torch.from_numpy(b.input).to(
                    DEVICE)).cpu()
                for i, m in enumerate(methods):
                    part = m.apply(out, b.target, b.valid)
                    host[i] = part if host[i] is None else host[i] + part
    finally:
        Engine.reset()
    got = [(r_.correct, r_.count) for r_ in results]
    want = [(h.correct, h.count) for h in host]
    log(f"  validation (bf16): Top1 {results[0].result()[0]:.4f}, Top5 "
        f"{results[1].result()[0]:.4f} over {results[0].count} images in "
        f"{stats['batches']} batches (the last padded to {VISION_BATCH} with "
        f"100 valid); fetched {stats['fetch_bytes']} bytes; the host folds "
        f"of eager logits: {want}; first pass (captures) {pass_s:.2f} s, "
        f"second {pass2_s:.2f} s [{card}]")
    if got != want or [(r_.correct, r_.count) for r_ in results2] != want \
            or results[0].count != n:
        raise CheckFailed(f"device validation {got} differs from the host "
                          f"folds {want}")
    return {"top1": results[0].result()[0], "top5": results[1].result()[0],
            "count": n, "correct": got, "fetch_bytes": stats["fetch_bytes"],
            "first_pass_s": pass_s, "second_pass_s": pass2_s}


def check_folded_inference(model, card, Engine):
    """``fuse_conv_bn`` of the trained model in eval mode against the
    unfused model at batch 256, in fp32 (TF32 off) and under the bf16
    policy, both timed. Errors are the largest log-prob difference over
    the largest log-prob magnitude (at least 1). Limits: fp32 1e-3 (the
    fold changes the order of operations of 52 conv-BN pairs: every
    bottleneck's three and the four projection shortcuts; the s2d stem is
    not a ``SpatialConvolution`` and stays unfused, as in JAX); bf16 within
    2x the unfused bf16 forward's own distance from the fp32 forward (the
    folded weights are rounded to bf16 once, the unfused path rounds the
    convolution's output before the fp32 BN)."""
    from bigdl_tpu_torch.kernels.conv_bn import FusedConvBNReLU
    from bigdl_tpu_torch.nn import fuse_conv_bn
    from bigdl_tpu_torch.nn.abstractnn import evaluating
    from bigdl_tpu_torch.optim.evaluator import eval_forward

    fused = build_resnet50(DEVICE)
    fused.load_state_dict(model.state_dict())
    fused = fuse_conv_bn(fused)
    n_fused = sum(isinstance(m, FusedConvBNReLU) for m in fused.modules())
    x = torch.from_numpy(vision_batches(1, SEED + 11)[0].input).to(DEVICE)
    out = {}
    with torch.no_grad(), evaluating(model), evaluating(fused):
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            Engine.init(compute_dtype=dtype)
            try:
                plain = eval_forward(model, x)
                folded = eval_forward(fused, x)
                ms = time_ms(lambda: eval_forward(model, x), reps=3,
                             trials=3)[0]
                fms = time_ms(lambda: eval_forward(fused, x), reps=3,
                              trials=3)[0]
            finally:
                Engine.reset()
            out[name] = {"max_abs_err": max_err(folded, plain),
                         "scale": max(1.0, float(plain.abs().max())),
                         "unfused_ms": ms, "folded_ms": fms,
                         "plain": plain}
    drift = max_err(out["bfloat16"]["plain"], out["float32"]["plain"]) \
        / out["float32"]["scale"]
    for name, c in out.items():
        c.pop("plain")
        c["rel_err"] = c["max_abs_err"] / c["scale"]
        log(f"  folded inference ({n_fused} conv-BN pairs fused), {name}: "
            f"log-probs within {c['max_abs_err']:.3e} of the unfused "
            f"model's (largest |log-prob| {c['scale']:.3g}, relative "
            f"{c['rel_err']:.2e}); {c['folded_ms']:.2f} ms against "
            f"{c['unfused_ms']:.2f} ms unfused at batch {VISION_BATCH} "
            f"[{card}]")
    out["bf16_vs_fp32_unfused_rel_err"] = drift
    log(f"  the unfused bf16 forward is {drift:.2e} (relative) from the fp32 "
        f"forward: the bf16 fold's limit is {2 * drift:.2e}")
    if n_fused != 52 or out["float32"]["rel_err"] > VISION_FOLD_FP32 \
            or out["bfloat16"]["rel_err"] > 2 * drift:
        raise CheckFailed(f"folded inference: {n_fused} pairs fused, "
                          f"errors {out}")
    return out


def run_main(main, argv, card, batch, unit="images", keep=False,
             scored=True):
    """A training main on the card, its per-iteration losses read from the
    optimizer's log: the loss must fall (the mean of the last 4 below the
    mean of the first 4); ``unit``/s (the samples of a batch) over the
    steps after the first. With ``keep``, also the main's optimizer;
    ``scored=False`` for a main without validation (no Top1)."""
    import logging
    records = []

    class Losses(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("Epoch"):
                records.append((time.perf_counter(), record.args[2]))

    logger = logging.getLogger("bigdl_tpu_torch.optim.optimizer")
    handler, level = Losses(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        opt = main.main(argv)
        wall = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    times, losses = zip(*records)
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    ips = (len(losses) - 1) * batch / (times[-1] - times[0])
    name = main.__name__.split(".")[-2]
    top1 = opt.state["score"] if scored else None
    log(f"  {name} main ({' '.join(argv) or 'defaults'}): {len(losses)} "
        f"steps, loss {first:.4f} (first 4) -> {last:.4f} (last 4)"
        + (f", Top1 {top1:.4f}" if scored else "")
        + f"; {ips:.0f} {unit}/s after the first step; {wall:.2f} s in all "
        f"[{card}]")
    if not last < first:
        raise CheckFailed(f"{name}: the loss did not fall ({first} -> "
                          f"{last})")
    out = {"steps": len(losses), "first_loss": first, "last_loss": last,
           "top1": top1, f"{unit}_per_s": ips, "wall_s": wall}
    return (out, opt) if keep else out


def vision_path(kernels, card, Engine):
    """Phase 8: the vision path at full width, NHWC, cuDNN with its
    deterministic algorithms: autotuned in each program's eager warm-up
    for the bf16 runs; the one-step check and the fp32 run under cuDNN's
    heuristic choice (``cudnn.benchmark`` off, the package's default):
    autotuning the fp32 convolutions with TF32 off takes over a minute of
    that run's first window on an H100."""
    from bigdl_tpu_torch.models.lenet import train as lenet_main
    from bigdl_tpu_torch.models.vgg import train as vgg_main
    from bigdl_tpu_torch.nn import layout

    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    layout.set_image_format("NHWC")
    try:
        step_check = check_resnet_step(layout, Engine)
        data = vision_batches(TRAIN_STEPS, SEED + 12)
        torch.backends.cudnn.benchmark = True
        Engine.init(compute_dtype=torch.bfloat16)
        try:
            run16, trained = train_vision(data, kernels, card, bf16=True,
                                          compare=True)
            run16_fused, _ = train_vision(data, kernels, card, bf16=True,
                                          fuse=FUSE, compare=True,
                                          profile=False)
        finally:
            Engine.reset()
        torch.backends.cudnn.benchmark = False
        run32, _ = train_vision(data, kernels, card, profile=True)
        drift = [abs(a - b) / abs(b) for a, b in
                 zip(run16["losses"], run32["losses"])]
        log(f"  bf16 against fp32 at batch {VISION_BATCH}: step "
            f"{run16['step_ms']:.2f} (autotuned) against "
            f"{run32['step_ms']:.2f} ms (cuDNN's heuristic algorithms) "
            f"({run32['step_ms'] / run16['step_ms']:.2f}x); first loss "
            f"within {drift[0]:.2e} relative (limit {VISION_DRIFT[0]}), all "
            f"within {max(drift):.2e} (limit {VISION_DRIFT[1]}) [{card}]")
        if drift[0] > VISION_DRIFT[0] or max(drift) > VISION_DRIFT[1]:
            raise CheckFailed(f"bf16 ResNet-50 losses depart from fp32 by "
                              f"{drift}")
        drift = max(drift)
        validation = check_validation(trained, card, Engine)
        folded = check_folded_inference(trained, card, Engine)
        del trained, data
        release()
    finally:
        layout.set_image_format(None)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    kernels.reset_launch_counts()
    lenet = run_main(lenet_main, ["-b", "128", "--synthetic-size", "16384"],
                     card, 128)
    vgg = run_main(vgg_main, ["-b", "128", "--synthetic-size", "8192"],
                   card, 128)
    counts = kernels.launch_counts()
    if any(counts.values()):
        raise CheckFailed(f"LeNet-5 or VGG launched the LM kernels {counts}")
    return {"lm_kernel_launches": counts, "one_step_check": step_check,
            "training_bf16": {k: run16[k] for k in (
                "step_ms", "images_per_s", "bf16_peak_share",
                "peak_memory_bytes", "first_window_ms", "replay_vs_eager",
                "losses")} | {"profile": {k: (run16["profile"] or {}).get(k)
                              for k in ("busy_ms", "wall_ms", "by_kind_ms",
                                        "host_calls")}},
            "training_bf16_fused": {k: run16_fused[k] for k in (
                "step_ms", "images_per_s", "bf16_peak_share",
                "peak_memory_bytes", "first_window_ms", "replay_vs_eager")},
            "training_fp32": {k: run32[k] for k in (
                "step_ms", "images_per_s", "peak_memory_bytes",
                "first_window_ms", "losses")} | {
                "profile": {k: (run32["profile"] or {}).get(k) for k in (
                    "busy_ms", "wall_ms", "by_kind_ms", "host_calls")},
                "bf16_loss_drift": drift},
            "validation": validation, "folded_inference": folded,
            "lenet5": lenet, "vgg_cifar10": vgg}


# ---------------------------------------------------------------- phase 9
def ln_modules(nn, model) -> int:
    """LayerNorm forward launches a call of ``model``."""
    return sum(isinstance(m, nn.LayerNorm) for m in model.modules())


def check_engine(name, stats, ln, ln_target, ln_draft=0):
    """An engine's ledger (within ``len(buckets) + 2``) and its LayerNorm
    launches, counted across replays: ``ln_target`` a target call (a
    prefill or a tick), ``ln_draft`` a draft call (one a prefill, k + 1 a
    speculative tick)."""
    k = stats["spec_tokens"]
    calls = stats["prefills"] + stats["decode_ticks"]
    want = ln_target * calls + (
        ln_draft * (stats["prefills"] + (k + 1) * stats["decode_ticks"])
        if k else 0)
    n, bound = stats["compiled_programs"], stats["program_grid_bound"]
    log(f"  {name}: {n} programs (bound {bound}); LN forward {ln} launches "
        f"over {stats['prefills']} prefills and {stats['decode_ticks']} "
        f"ticks ({want} expected)")
    if n > bound:
        raise CheckFailed(f"{name} compiled {n} programs (bound {bound})")
    if ln != want:
        raise CheckFailed(f"{name} launched the LayerNorm forward {ln} "
                          f"times, not {want}")


def engine_run(ServingEngine, kernels, lm, name, prompts, n_rounds, ln,
               ln_draft=0, keep=False, order=None, **kw):
    """``n_rounds`` of ``prompts`` through a new engine over ``lm``
    (``serve_round``'s ``order``); its ledger and launches checked.
    Returns the rounds and the engine (shut down unless ``keep``)."""
    before = kernels.launch_counts()["layer_norm_fwd"]
    engine = ServingEngine(lm, max_len=MAX_LEN, device=DEVICE, **kw)
    try:
        rounds = serve_rounds(engine, prompts, n_rounds, order)
    except BaseException:
        engine.shutdown()
        raise
    if not keep:
        engine.shutdown()
    check_engine(name, engine.stats(),
                 kernels.launch_counts()["layer_norm_fwd"] - before, ln,
                 ln_draft)
    return rounds, engine


def same_tokens(name, got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if not np.array_equal(a.tokens, b.tokens):
            raise CheckFailed(f"{name}: request {i}'s tokens differ from "
                              f"the 8-slot grid engine's")


def check_deadlines(engine, prompts, grid, RequestTimeout):
    """On a warm paged engine, with its clock replaced (the deadlines' time
    source): B, behind a full grid of the 16 requests, fails while queued
    once all 16 hold their rows; C fails mid-decode once admitted beside
    A. The rows and pages come back; the others' tokens are the grid's."""
    seen = []
    p0 = engine.stats()["prefills"]

    def queued_clock():
        if engine._prefills >= p0 + N_REQUESTS and (
                engine._pending or engine._queue.qsize()):
            seen.append(engine.stats()["active_slots"])
            return 10.0
        return 0.0

    engine.clock = queued_clock
    hs = [engine.submit(p, NEW_TOKENS) for p in prompts]
    hb = engine.submit(prompts[0][:100], NEW_TOKENS, deadline_ms=1000)
    try:
        hb.result(600)
        raise CheckFailed("a queued request outlived its deadline")
    except RequestTimeout as e:
        queued = str(e)
    same_tokens("deadline round", [h.result(600) for h in hs], grid)
    if "while queued" not in queued or max(seen) != EXTRA_SLOTS:
        raise CheckFailed(f"the queued timeout: {queued!r}, active rows "
                          f"{max(seen)}")
    p1 = engine.stats()["prefills"]
    engine.clock = lambda: 10.0 if engine._prefills >= p1 + 2 else 0.0
    ha = engine.submit(prompts[0], NEW_TOKENS)
    hc = engine.submit(prompts[1], NEW_TOKENS, deadline_ms=1000)
    try:
        hc.result(600)
        raise CheckFailed("a decoding request outlived its deadline")
    except RequestTimeout as e:
        mid = str(e)
    same_tokens("mid-decode round", [ha.result(600)], grid[:1])
    st = engine.stats()
    engine.clock = time.perf_counter
    emitted = len(hc._request.generated)
    log(f"  deadlines: {queued!r} with {max(seen)} rows busy; {mid!r}; "
        f"timeouts {st['timeouts']}, pages used after {st['pages_used']}")
    if "mid-decode" not in mid or not 1 <= emitted < NEW_TOKENS \
            or st["timeouts"] != 2 or st["pages_used"] != 0:
        raise CheckFailed(f"the mid-decode timeout: {mid!r}, {emitted} "
                          f"tokens, stats {st}")
    return {"queued": queued, "mid_decode": mid, "rows_busy": max(seen),
            "timeouts": st["timeouts"]}


def check_overload(ServingEngine, EngineOverloaded, lm, prompts, grid):
    """Shed and degrade on an exhausted pool: all but one page fewer than
    the longest prompt needs now are held. Shed raises with
    ``pages_free``; degrade admits it with half its new tokens once the
    pages return."""
    i = int(np.argmax([len(p) for p in prompts]))
    free = len(prompts[i]) // PAGE_TOKENS
    kw = dict(max_len=MAX_LEN, slots=EXTRA_SLOTS, pages=EXHAUST_PAGES,
              page_tokens=PAGE_TOKENS, device=DEVICE)
    shed = ServingEngine(lm, overload="shed", **kw)
    held = shed._allocator.alloc(EXHAUST_PAGES - free)
    try:
        shed.submit(prompts[i], NEW_TOKENS)
        raise CheckFailed("shed admitted a request the pool cannot back")
    except EngineOverloaded as e:
        err = e
    finally:
        shed.shutdown()
    if err.pages_free != free:
        raise CheckFailed(f"shed reported pages_free={err.pages_free}")
    deg = ServingEngine(lm, overload="degrade", **kw)
    try:
        held = deg._allocator.alloc(EXHAUST_PAGES - free)
        h = deg.submit(prompts[i], NEW_TOKENS)
        halved = h._request.max_new_tokens
        deg._allocator.free(held)
        res = h.result(600)
        st = deg.stats()
    finally:
        deg.shutdown()
    want = grid[i].tokens[:len(prompts[i]) + NEW_TOKENS // 2]
    log(f"  overload: shed raised {type(err).__name__}(pages_free="
        f"{err.pages_free}, queue_depth={err.queue_depth}); degrade admitted "
        f"{halved} of {NEW_TOKENS} new tokens "
        f"(degraded_admits {st['degraded_admits']})")
    if halved != NEW_TOKENS // 2 or res.n_generated != halved \
            or not np.array_equal(res.tokens, want):
        raise CheckFailed(f"degrade served {res.n_generated} tokens "
                          f"(max_new_tokens {halved})")
    return {"shed_pages_free": err.pages_free, "degraded_to": halved}


def prefix_traffic(seed):
    """A 512-token prefix alone, then 8 requests of prefix + a 33..64
    token tail (a hit at 512 whose remainder takes the 64 bucket), then
    the first tail request again (an exact hit)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, VOCAB, PREFIX_LEN).astype(np.int32)
    tails = [np.concatenate([prefix, rng.integers(0, VOCAB, int(n))
                             .astype(np.int32)])
             for n in rng.integers(TAIL_LO, TAIL_HI + 1, N_TAILS)]
    return [prefix] + tails + [tails[0]]


def prefix_pool_run(ServingEngine, pick_seed_bucket, kernels, lm, ln, card):
    """The pooled engine against a pool-less one, two rounds of
    ``prefix_traffic`` each (the first holds the captures), submitted one
    at a time: every tail hits at 512 and prefills through the bucket
    ``pick_seed_bucket`` gives, the repeat runs no prefill, and the tokens
    are the pool-less engine's (near-tie rule)."""
    out = {}
    ttft = {}
    for name, kw in (("cold", {}), ("pooled", dict(prefix_pool=16,
                                                   prefix_chunk=16))):
        before = kernels.launch_counts()["layer_norm_fwd"]
        engine = ServingEngine(lm, max_len=MAX_LEN, slots=SLOTS,
                               device=DEVICE, **kw)
        try:
            tokens, firsts = [], []
            for rnd in range(2):
                for j, p in enumerate(prefix_traffic(SEED + 20 + rnd)):
                    st0 = engine.stats()
                    r = engine.submit(p, NEW_TOKENS).result(600)
                    st1 = engine.stats()
                    tokens.append(r.tokens)
                    if rnd == 1 and 1 <= j <= N_TAILS:
                        firsts.append(r.ttft_s * 1e3)
                    if name == "pooled":
                        check_prefix_step(j, p, st0, st1, pick_seed_bucket,
                                          engine.buckets)
            st = engine.stats()
        finally:
            engine.shutdown()
        check_engine(f"prefix traffic, {name}", st,
                     kernels.launch_counts()["layer_norm_fwd"] - before, ln)
        out[name] = (tokens, st)
        ttft[name] = float(np.percentile(firsts, 50))
    lengths = [len(p) for rnd in range(2)
               for p in prefix_traffic(SEED + 20 + rnd)]
    parted = check_near_ties(lm, "pooled", out["pooled"][0], out["cold"][0],
                             lengths)
    st = out["pooled"][1]
    log(f"  prefix pool: tails' TTFT p50 {ttft['pooled']:.2f} ms warm "
        f"(a hit at {PREFIX_LEN}) against {ttft['cold']:.2f} ms cold; "
        f"{st['prefix_hits']} hits, {st['prefix_tokens_saved']} tokens "
        f"saved, {st['prefix_entries']} entries, {st['prefix_bytes']} bytes; "
        f"prefills by bucket {st['prefills_by_bucket']}; {parted} requests "
        f"parted from the cold engine at near ties [{card}]")
    return {"ttft_p50_ms_warm": ttft["pooled"],
            "ttft_p50_ms_cold": ttft["cold"], "hits": st["prefix_hits"],
            "tokens_saved": st["prefix_tokens_saved"],
            "bytes": st["prefix_bytes"], "entries": st["prefix_entries"],
            "prefills_by_bucket": st["prefills_by_bucket"],
            "parted_at_near_ties": parted}


def check_prefix_step(j, prompt, st0, st1, pick_seed_bucket, buckets):
    """One pooled request's effect on the engine's counters: the prefix
    alone misses and prefills; a tail hits at 512 and prefills its
    remainder through ``pick_seed_bucket``'s bucket; the repeat hits
    whole and runs no prefill."""
    hits = st1["prefix_hits"] - st0["prefix_hits"]
    saved = st1["prefix_tokens_saved"] - st0["prefix_tokens_saved"]
    by = {b: n - st0["prefills_by_bucket"].get(b, 0)
          for b, n in st1["prefills_by_bucket"].items()}
    ran = {b: n for b, n in by.items() if n}
    if j == 0:
        want = (0, 0, {pick_bucket_of(len(prompt), buckets): 1})
    elif j <= N_TAILS:
        want = (1, PREFIX_LEN, {pick_seed_bucket(
            len(prompt) - PREFIX_LEN, buckets, PREFIX_LEN, MAX_LEN): 1})
    else:
        want = (1, len(prompt), {})
    if (hits, saved, ran) != want:
        raise CheckFailed(f"pooled request {j}: hits {hits}, tokens saved "
                          f"{saved}, prefills {ran}; expected {want}")


def pick_bucket_of(n, buckets):
    return min(b for b in buckets if b >= n)


def spec_runs(ServingEngine, SpeculativeDecoder, kernels, lm, draft, nn,
              prompts, refs, plain_rate, card):
    """The speculative engine, k = 4, on the slot grid and paged, with the
    target as its own draft (acceptance must be 1) and with the smaller
    draft; two rounds each (the first holds the captures), tokens against
    solo ``greedy_generate`` (near-tie rule); then ``SpeculativeDecoder``
    on a (4, 8) batch against ``greedy_generate``."""
    ln, ln_d = ln_modules(nn, lm), ln_modules(nn, draft)
    out = {}
    for grid in ("grid", "paged"):
        for dname, d, dln in (("self-draft", lm, ln), ("small draft", draft,
                                                      ln_d)):
            kw = (dict(slots=SLOTS) if grid == "grid" else
                  dict(slots=EXTRA_SLOTS, pages=EXTRA_PAGES,
                       page_tokens=PAGE_TOKENS))
            name = f"speculative, {grid}, {dname}"
            rounds, _ = engine_run(ServingEngine, kernels, lm, name, prompts,
                                   2, ln, dln, draft_model=d,
                                   spec_tokens=SPEC_K, **kw)
            (res1, _, st1), (res2, wall2, st2) = rounds
            parted = sum(check_near_ties(
                lm, name, [r.tokens for r in res], refs,
                [len(p) for p in prompts]) for res in (res1, res2))
            warm = report_round(f"{name}, second round", res2, wall2, st2,
                                st1, card)
            rate = st2["spec_acceptance"]
            log(f"  {name}: acceptance {rate:.4f} ({st2['spec_accepted']} of "
                f"{st2['spec_proposed']}); decode "
                f"{warm['decode_tokens_per_s']:.1f} tokens/s against plain "
                f"{plain_rate[grid]:.1f} [{card}]")
            if dname == "self-draft" and rate != 1.0:
                raise CheckFailed(f"{name}: acceptance {rate}, not 1.0")
            if grid == "paged" and st2["pages_used"] != 0:
                raise CheckFailed(f"{name} held {st2['pages_used']} pages "
                                  f"after the drain")
            out[f"{grid}_{dname.split()[0].replace('-', '_')}"] = dict(
                warm, acceptance_rate=rate, parted_at_near_ties=parted)
    g = torch.Generator().manual_seed(SEED + 11)
    batch = torch.randint(0, VOCAB, (4, 8), generator=g).numpy()
    want = nn.greedy_generate(lm, batch, NEW_TOKENS,
                              device=DEVICE).cpu().numpy()
    for dname, d in (("self-draft", lm), ("small draft", draft)):
        dec = SpeculativeDecoder(lm, d, spec_tokens=SPEC_K, device=DEVICE)
        got = dec.generate(batch, NEW_TOKENS)
        parted = check_near_ties(lm, f"SpeculativeDecoder, {dname}", got,
                                 want, [8] * 4)
        log(f"  SpeculativeDecoder, {dname}, (4, 8) + {NEW_TOKENS}: "
            f"{dec.stats()}; {parted} rows parted from greedy_generate at "
            f"near ties")
        if dname == "self-draft" and dec.stats()["acceptance_rate"] != 1.0:
            raise CheckFailed(f"SpeculativeDecoder self-draft acceptance "
                              f"{dec.stats()['acceptance_rate']}")
        out[f"decoder_{dname.split()[0].replace('-', '_')}"] = dec.stats()
    return out


def paged_state(lm, paged_cache, per_row):
    """A paged cache of EXTRA_SLOTS rows with ``per_row`` pages each."""
    state = paged_cache.install_paged_cache(lm, EXTRA_SLOTS, MAX_LEN,
                                            EXTRA_PAGES, PAGE_TOKENS)
    table = torch.zeros((EXTRA_SLOTS, MAX_LEN // PAGE_TOKENS),
                        dtype=torch.long)
    for r in range(EXTRA_SLOTS):
        table[r, :per_row] = torch.arange(1 + r * per_row,
                                          1 + (r + 1) * per_row)
    paged_cache.with_page_table(state, table.to(DEVICE))
    return state


def leaves(tree):
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def states_equal(a, b, live) -> bool:
    """Every leaf of two states equal bit for bit; pools on pages ``live``
    only (the trash page takes the free writes in no fixed order)."""
    for x, y in zip(leaves(a), leaves(b)):
        if x.dim() == 4 and x.shape[0] == EXTRA_PAGES + 1:
            x, y = x[live], y[live]
        if not torch.equal(x, y):
            return False
    return True


def replayed_extras(lm, draft, nn, kernels, Program, paged_cache,
                    build_spec_step, card):
    """One replayed paged tick and one replayed speculative step against
    the same work run eagerly on copies of the same states (a 64-token
    prefix in each of 16 rows of 16 pages): the tokens and log-probs,
    the live pages, the draft's cache and the positions bit for bit, and
    the launches; the paged tick's log-probs also against the slot grid's
    on the same prefix. Device and host ms of each replay."""
    per = min(16, EXTRA_PAGES // EXTRA_SLOTS, MAX_LEN // PAGE_TOKENS)
    live = slice(1, 1 + EXTRA_SLOTS * per)
    rng = np.random.default_rng(SEED + 7)
    prefix = torch.from_numpy(rng.integers(
        0, VOCAB, (EXTRA_SLOTS, per * PAGE_TOKENS // 4))).to(DEVICE)
    tok = torch.from_numpy(rng.integers(0, VOCAB, (EXTRA_SLOTS, 1))
                           ).to(DEVICE)

    def ln_count():
        return kernels.launch_counts()["layer_norm_fwd"]

    out = {}
    with torch.no_grad():
        state = paged_state(lm, paged_cache, per)
        grid = nn.install_decode_cache(lm, EXTRA_SLOTS, MAX_LEN)
        lm.run(prefix, state)
        lm.run(prefix, grid)
        ref = copy_tree(state)
        prog = Program(("paged_tick_check",),
                       lambda t: lm.run(t, state)[0], (tok.clone(),), DEVICE)
        prog()                               # warm-up, then capture
        lm.run(tok, ref)
        lm.run(tok, grid)
        c0 = ln_count()
        got = prog().clone()
        c1 = ln_count()
        want = lm.run(tok, ref)[0]
        c2 = ln_count()
        want_grid = lm.run(tok, grid)[0]
        bitwise = bool(torch.equal(got, want))
        pages_ok = states_equal(state, ref, live)
        grid_ok = bool(torch.equal(want, want_grid))
        dev_ms, host_ms = time_ms(prog, reps=2)
        out["paged_tick"] = {"device_ms": dev_ms, "host_ms": host_ms,
                             "bitwise": bitwise, "pages_bitwise": pages_ok,
                             "grid_bitwise": grid_ok,
                             "ln_replay": c1 - c0, "ln_eager": c2 - c1}
        log(f"  paged tick ({EXTRA_SLOTS} rows, {EXTRA_PAGES} pages), "
            f"replayed: device {dev_ms:.3f} ms, host {host_ms:.3f} ms; "
            f"log-probs against the eager step bitwise {bitwise}, live "
            f"pages bitwise {pages_ok}, against the slot grid bitwise "
            f"{grid_ok}; LN forward {c1 - c0} a replay, {c2 - c1} eager "
            f"[{card}]")
        if not (bitwise and pages_ok and grid_ok) or c1 - c0 != c2 - c1:
            raise CheckFailed(f"the replayed paged tick departs: "
                              f"{out['paged_tick']}")

        step = build_spec_step(lm, draft, SPEC_K)
        state_d = nn.install_decode_cache(draft, EXTRA_SLOTS, MAX_LEN)
        draft.run(prefix, state_d)

        def run(st, st_d, t):
            props, greedy, n_acc, ok = step(st, st_d, t[:, 0])
            return torch.cat([props, greedy, n_acc[:, None],
                              ok[:, None].long()], dim=1)

        ref, ref_d = copy_tree(state), copy_tree(state_d)
        prog = Program(("spec_step_check",),
                       lambda t: run(state, state_d, t), (tok.clone(),),
                       DEVICE)
        prog()                               # warm-up, then capture
        run(ref, ref_d, tok)
        c0 = ln_count()
        got = prog().clone()
        c1 = ln_count()
        want = run(ref, ref_d, tok)
        c2 = ln_count()
        bitwise = bool(torch.equal(got, want))
        pages_ok = states_equal(state, ref, live) and states_equal(
            state_d, ref_d, live)
        dev_ms, host_ms = time_ms(prog, reps=2)
        out["spec_step"] = {"device_ms": dev_ms, "host_ms": host_ms,
                            "bitwise": bitwise, "states_bitwise": pages_ok,
                            "ln_replay": c1 - c0, "ln_eager": c2 - c1}
        log(f"  speculative step (k={SPEC_K}, paged target, small draft), "
            f"replayed: device {dev_ms:.3f} ms, host {host_ms:.3f} ms; "
            f"tokens and accepts against the eager step bitwise {bitwise}, "
            f"live pages, draft cache and positions {pages_ok}; LN forward "
            f"{c1 - c0} a replay, {c2 - c1} eager [{card}]")
        if not (bitwise and pages_ok) or c1 - c0 != c2 - c1:
            raise CheckFailed(f"the replayed speculative step departs: "
                              f"{out['spec_step']}")
    return out


def serving_extras(TransformerLM, nn, kernels, card, grid_rounds, prompts,
                   refs):
    """Phase 9 (its launches are counted from a reset by the caller):
    ``grid_rounds`` are phase 5's two rounds through the 8-slot grid,
    ``refs`` the requests' solo ``greedy_generate`` tokens."""
    from bigdl_tpu_torch.serving import (
        EngineOverloaded, RequestTimeout, ServingEngine, SpeculativeDecoder,
        paged_cache, pick_seed_bucket,
    )
    from bigdl_tpu_torch.serving.speculative import build_spec_step
    from bigdl_tpu_torch.utils.programs import Program

    lm = build_lm(TransformerLM, "auto", DEVICE)
    ln = ln_modules(nn, lm)
    grid = grid_rounds[1][0]
    grid_stats = grid_rounds[1][2]
    grid_warm = report_round("8-slot grid (phase 5), second round",
                             grid_rounds[1][0], grid_rounds[1][1],
                             grid_stats, grid_rounds[0][2], card)
    out = {}
    rounds, engine = engine_run(
        ServingEngine, kernels, lm, "paged", prompts, 2, ln, keep=True,
        slots=EXTRA_SLOTS, pages=EXTRA_PAGES, page_tokens=PAGE_TOKENS)
    try:
        for r, (res, _, _) in enumerate(rounds):
            same_tokens(f"paged round {r + 1}", res, grid)
        (_, _, st1), (res2, wall2, st2) = rounds
        warm = report_round("paged, second round", res2, wall2, st2, st1,
                            card)
        peak, gpeak = st2["peak_active_slots"], grid_stats["peak_active_slots"]
        log(f"  paged ({EXTRA_SLOTS} slots, {EXTRA_PAGES} pages of "
            f"{PAGE_TOKENS}: the {SLOTS}-slot grid's KV bytes): tokens equal "
            f"the grid's bitwise in both rounds; peak resident {peak} "
            f"against the grid's {gpeak}; decode "
            f"{warm['decode_tokens_per_s']:.1f} against "
            f"{grid_warm['decode_tokens_per_s']:.1f} tokens/s, "
            f"tick {warm['tick_ms']:.3f} against {grid_warm['tick_ms']:.3f} "
            f"ms, TTFT p50 {warm['ttft_p50_ms']:.1f} / p99 "
            f"{warm['ttft_p99_ms']:.1f} against {grid_warm['ttft_p50_ms']:.1f}"
            f" / {grid_warm['ttft_p99_ms']:.1f} ms; after the drain "
            f"{st2['pages_used']} pages used, free ratio "
            f"{st2['free_page_ratio']} [{card}]")
        if peak < 2 * gpeak or st2["pages_used"] != 0 \
                or st2["free_page_ratio"] != 1.0:
            raise CheckFailed(f"paged: peak {peak} (grid {gpeak}), pages "
                              f"used {st2['pages_used']} after the drain")
        out["paged"] = dict(warm, peak_active_slots=peak,
                            grid_peak_active_slots=gpeak, grid=grid_warm)
        out["deadlines"] = check_deadlines(engine, prompts, grid,
                                           RequestTimeout)
    finally:
        engine.shutdown()
    del engine
    # the preemptions depend on the order the requests reach the pool:
    # all 16 queued before the first prefill, longest first, preempt twice
    # (in the prompts' own order, none), whatever the card's speed
    longest = [int(i) for i in np.argsort([-len(p) for p in prompts],
                                          kind="stable")]
    rounds, _ = engine_run(ServingEngine, kernels, lm, "exhausted pool",
                           prompts, 1, ln, order=longest, slots=EXTRA_SLOTS,
                           pages=EXHAUST_PAGES, page_tokens=PAGE_TOKENS,
                           admit_wait_ms=ADMIT_ALL_MS)
    res, wall, st = rounds[0]
    check_served_tokens(lm, None, prompts, res, refs)
    log(f"  exhausted pool ({EXHAUST_PAGES} pages): {st['completed']} of "
        f"{N_REQUESTS} completed in {wall:.2f} s, {st['page_evictions']} "
        f"preemptions, peak resident {st['peak_active_slots']}, "
        f"{st['pages_used']} pages used after; tokens match solo "
        f"greedy_generate [{card}]")
    if st["page_evictions"] < 1 or st["completed"] != N_REQUESTS \
            or st["pages_used"] != 0:
        raise CheckFailed(f"exhausted pool: {st}")
    out["exhausted"] = {"preemptions": st["page_evictions"], "wall_s": wall,
                        "peak_active_slots": st["peak_active_slots"]}
    out["overload"] = check_overload(ServingEngine, EngineOverloaded, lm,
                                     prompts, grid)
    torch.cuda.empty_cache()
    out["prefix"] = prefix_pool_run(ServingEngine, pick_seed_bucket, kernels,
                                    lm, ln, card)
    embed, heads, layers = DRAFT_WIDTH
    draft = TransformerLM(VOCAB, embed, heads, layers, MAX_LEN,
                          generator=torch.Generator().manual_seed(SEED + 9),
                          device=DEVICE).evaluate()
    torch.cuda.empty_cache()
    out["speculative"] = spec_runs(
        ServingEngine, SpeculativeDecoder, kernels, lm, draft, nn, prompts,
        refs, {"grid": grid_warm["decode_tokens_per_s"],
               "paged": warm["decode_tokens_per_s"]}, card)
    out["replays"] = replayed_extras(lm, draft, nn, kernels, Program,
                                     paged_cache, build_spec_step, card)
    del lm, draft
    torch.cuda.empty_cache()
    return out



# --------------------------------------------------------------- phase 11
# the trainer's robustness at full width: phase 6's LM configuration and
# data, a checkpoint every ROBUST_EVERY iterations keeping the newest
# ROBUST_KEEP versions, fp32 at fuse 1 and bf16 at fuse FUSE (windows
# clipped at the checkpoints); a preemption at ROBUST_SIGTERM, a NaN loss
# at ROBUST_NAN; phase 8's ResNet-50 at batch ROBUST_VISION_BATCH for
# ROBUST_VISION_ITERS steps, a checkpoint at 3, a preemption at 4
ROBUST_EVERY, ROBUST_KEEP, ROBUST_SIGTERM, ROBUST_NAN = 4, 2, 9, 11
ROBUST_VISION_BATCH, ROBUST_VISION_ITERS = 64, 6
ROBUST_PROFILE = (13, 3)             # set_profile's first iteration, count


def robust_dir(name: str) -> Path:
    """A fresh checkpoint directory of phase 11."""
    return phase_dir(name, "phase11")


def instrument(opt) -> dict:
    """Record the run's losses by iteration, its windows' ends and sizes,
    every checkpoint's loop-thread stall and writer seconds."""
    rec = {"losses": {}, "marks": [], "windows": [], "stall_ms": [],
           "write_s": [], "nbytes": [], "programs_at_load": []}
    run_steps, save, write, load = (
        opt._run_steps, opt._save_checkpoint, opt._write_checkpoint,
        opt._load_latest_checkpoint)

    def recorded_load():
        rec["programs_at_load"].append(opt._step_program)
        return load()

    def recorded(steps):
        first = opt.state["neval"]
        out = run_steps(steps)
        rec["marks"].append(time.perf_counter())
        rec["windows"].append(len(steps))
        rec["losses"].update({first + i: v for i, v in enumerate(out)})
        return out

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        try:
            return save(*a, **kw)
        finally:
            rec["stall_ms"].append((time.perf_counter() - t0) * 1e3)

    def timed_write(payload, path):
        t0 = time.perf_counter()
        write(payload, path)
        rec["write_s"].append(time.perf_counter() - t0)
        if os.path.exists(path):
            rec["nbytes"].append(os.path.getsize(path))

    opt._run_steps, opt._save_checkpoint = recorded, timed_save
    opt._write_checkpoint, opt._load_latest_checkpoint = (timed_write,
                                                          recorded_load)
    return rec


def lm_run(TransformerLM, lm_criterion, ckpt, fuse, plan=None, resume=False,
           summary=None, check_numerics=False, profile=None, sync=False,
           prefetch=2):
    """One run of phase 6's configuration to TRAIN_ITERS: a fresh model
    from phase 6's seed and a fresh dataset (the same epoch orders), the
    step a captured program; checkpoints under ``ckpt`` (None: none),
    ``plan`` a fault plan, ``resume`` with ``resume="auto"``, the feed's
    depth ``prefetch`` (``set_prefetch``). Returns the
    optimizer, the record, the parameters and the ``TrainingPreempted``
    the run ended with (None when it ran to the end)."""
    from bigdl_tpu_torch.dataset import (
        DataSet, Sample, SampleToMiniBatch, ptb_windows, synthetic_ptb,
    )
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.optim.optimizer import TrainingPreempted
    from bigdl_tpu_torch.utils import faults
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    RandomGenerator.set_seed(SEED)
    ids = synthetic_ptb(TRAIN_BATCH * TRAIN_STEPS * TRAIN_LEN + 1,
                        vocab_size=VOCAB)
    xs, ys = ptb_windows(ids, TRAIN_LEN)
    data = (DataSet.array(Sample(x, y) for x, y in zip(xs, ys))
            >> SampleToMiniBatch(TRAIN_BATCH))
    lm = build_train_lm(TransformerLM, "auto", DEVICE)
    opt = (LocalOptimizer(lm, data, lm_criterion(), device=DEVICE)
           .set_optim_method(SGD(learningrate=0.01, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(TRAIN_ITERS))
           .set_fuse_steps(fuse).set_check_numerics(check_numerics)
           .set_prefetch(prefetch))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), Trigger.several_iteration(ROBUST_EVERY))
        opt.ckpt_keep = ROBUST_KEEP
    if summary is not None:
        opt.set_train_summary(summary)
    if profile is not None:
        opt.set_profile(str(profile), *ROBUST_PROFILE)
    rec = instrument(opt)
    stopped = None
    env = os.environ.get("BIGDL_CKPT_ASYNC")
    os.environ["BIGDL_CKPT_ASYNC"] = "0" if sync else "1"
    torch.cuda.synchronize()
    rec["t0"] = time.perf_counter()
    try:
        with faults.inject_faults(plan or ""):
            opt.optimize(resume="auto" if resume else None)
    except TrainingPreempted as e:
        stopped = e
    finally:
        if env is None:
            os.environ.pop("BIGDL_CKPT_ASYNC")
        else:
            os.environ["BIGDL_CKPT_ASYNC"] = env
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - rec["t0"]
    params = {n: p.detach().clone() for n, p in lm.named_parameters()}
    return opt, rec, params, stopped


def same_run(what, rec, params, ref_rec, ref_params, iters):
    """Bitwise: the losses of ``iters`` and the final parameters."""
    lost = [i for i in iters if rec["losses"].get(i) != ref_rec["losses"][i]]
    differ = [n for n, p in params.items()
              if not torch.equal(p, ref_params[n])]
    if lost or differ:
        worst = max((max_err(params[n], ref_params[n]) for n in differ),
                    default=0.0)
        raise CheckFailed(f"{what}: not bitwise equal to the uninterrupted "
                          f"run: losses of iterations {lost} "
                          f"({[rec['losses'].get(i) for i in lost]} against "
                          f"{[ref_rec['losses'][i] for i in lost]}), "
                          f"{len(differ)} parameters (max|err| {worst:.3e})")


def versions(ckpt) -> list:
    from bigdl_tpu_torch.optim.optimizer import _ckpt_version
    return sorted((p for p in os.listdir(ckpt)
                   if _ckpt_version(p) is not None), key=_ckpt_version)


def release_run(*opts) -> None:
    for opt in opts:
        opt._step_program = None
    release()


def robust_lm(TransformerLM, lm_criterion, card, bf16):
    """Phase 11's LM checks in one precision (fp32 at fuse 1, bf16 at fuse
    FUSE): (g) the uninterrupted run's TrainSummary against its losses and
    (c) the files it leaves; (a) a preemption and a fresh resume; (b) a NaN
    rollback whose last write is torn, and (d) a fresh resume that
    quarantines it and falls back; (e) fp32 only, the numerics check; (f)
    fp32 only, a profile of the resumed run."""
    from bigdl_tpu_torch.utils.robustness import events
    from bigdl_tpu_torch.visualization import TrainSummary, read_events

    fuse = FUSE if bf16 else 1
    what = f"{'bf16' if bf16 else 'fp32'}, fuse {fuse}"
    out = {}
    iters = range(1, TRAIN_ITERS + 1)
    # the uninterrupted run, with a checkpoint every ROBUST_EVERY
    ck = robust_dir(f"ref_{fuse}")
    summary = TrainSummary(str(robust_dir(f"summary_{fuse}")), "lm")
    ref_opt, ref, ref_params, stopped = lm_run(
        TransformerLM, lm_criterion, ck, fuse, summary=summary)
    if stopped is not None or sorted(ref["losses"]) != list(iters) \
            or not all(np.isfinite(list(ref["losses"].values()))):
        raise CheckFailed(f"{what}: the uninterrupted run gave "
                          f"{ref['losses']} ({stopped})")
    want_files = [f"checkpoint.{v}.pkl" for v in range(
        ROBUST_EVERY, TRAIN_ITERS + 1, ROBUST_EVERY)][-ROBUST_KEEP:]
    if versions(ck) != want_files:                                  # (c)
        raise CheckFailed(f"{what}: files {versions(ck)} left, not "
                          f"{want_files}")
    summary.close()
    read = {}
    for f in os.listdir(summary.dir):
        for ev in read_events(os.path.join(summary.dir, f)):
            for tag, v in ev["values"]:
                if tag == "Loss":
                    read[ev["step"]] = v
    if read != ref["losses"]:                                       # (g)
        raise CheckFailed(f"{what}: the TrainSummary's Loss {read} is not "
                          f"the run's {ref['losses']}")
    ckpt_bytes = ref["nbytes"][-1]
    n_params = sum(p.numel() for p in ref_params.values())
    out.update(windows=ref["windows"], ckpt_bytes=ckpt_bytes,
               parameters=n_params,
               stall_ms_async=ref["stall_ms"], writer_s=ref["write_s"],
               wall_s=ref["wall_s"], losses=[ref["losses"][i] for i in iters])
    log(f"  {what}: uninterrupted run, windows {ref['windows']}, "
        f"{ref['wall_s']:.2f} s; checkpoints of {ckpt_bytes} bytes "
        f"({n_params} parameters and their momentum, fp32); loop-thread "
        f"stall {[round(v, 2) for v in ref['stall_ms']]} ms (async), writer "
        f"{[round(v, 3) for v in ref['write_s']]} s; files left "
        f"{versions(ck)}; the TrainSummary's Loss at all {len(read)} "
        f"iterations equals the run's [{card}]")
    release_run(ref_opt)

    # (a) preemption at ROBUST_SIGTERM, then a fresh model resumes
    ck = robust_dir(f"preempt_{fuse}")
    snap = events.snapshot()
    opt, rec, _, stopped = lm_run(TransformerLM, lm_criterion, ck, fuse,
                                  plan=f"sigterm@{ROBUST_SIGTERM}")
    # at fuse 1 the stop follows iteration 9; fused, the window holding 9
    # (clipped at the checkpoints) runs to its end first
    want = (ROBUST_SIGTERM + 1 if fuse == 1 else
            (ROBUST_SIGTERM // ROBUST_EVERY + 1) * ROBUST_EVERY + 1)
    if stopped is None or stopped.iteration != want \
            or stopped.checkpoint_path != str(ck) \
            or events.deltas(snap).get("preemption") != 1:
        raise CheckFailed(f"{what}: sigterm@{ROBUST_SIGTERM} gave "
                          f"{stopped!r} (iteration "
                          f"{getattr(stopped, 'iteration', None)}, want "
                          f"{want}), events {events.deltas(snap)}")
    release_run(opt)
    opt, rec, params, stopped = lm_run(TransformerLM, lm_criterion, ck, fuse,
                                       resume=True)
    first_replay = rec["marks"][1 if fuse == 1 else 0] - rec["t0"]
    same_run(f"{what}, preempted at {ROBUST_SIGTERM} and resumed", rec,
             params, ref, ref_params, range(want, TRAIN_ITERS + 1))
    log(f"  {what}: sigterm@{ROBUST_SIGTERM} stopped before iteration "
        f"{want}, files {versions(ck)}; a fresh model resumed to "
        f"{TRAIN_ITERS} (windows {rec['windows']}): losses "
        f"{want}..{TRAIN_ITERS} and parameters bitwise the uninterrupted "
        f"run's; resume to the end of the first replayed step "
        f"{first_replay:.3f} s (load, warm-up step, capture) [{card}]")
    out.update(preempt_iteration=want, resume_s_to_first_replay=first_replay,
               resume_windows=rec["windows"])
    release_run(opt)

    # (b) a NaN loss at ROBUST_NAN: one rollback to the last checkpoint,
    # copied into the live tensors (the step program stays); the 4th write
    # (version 16) is torn
    ck = robust_dir(f"rollback_{fuse}")
    snap = events.snapshot()
    plan = f"nonfinite_loss@{ROBUST_NAN};ckpt_write@4=torn"
    opt, rec, params, stopped = lm_run(
        TransformerLM, lm_criterion, ck, fuse, plan=plan)
    rollbacks = events.deltas(snap).get("nan_rollback")
    if stopped is not None or rollbacks != 1:
        raise CheckFailed(f"{what}: nonfinite_loss@{ROBUST_NAN} gave "
                          f"{rollbacks} rollbacks ({stopped})")
    same_run(f"{what}, rolled back at {ROBUST_NAN}", rec, params, ref,
             ref_params, iters)
    kept = rec["programs_at_load"] == [opt._step_program]
    if not kept:
        raise CheckFailed(f"{what}: the rollback replaced the step program")
    log(f"  {what}: nonfinite_loss@{ROBUST_NAN} rolled back once to "
        f"checkpoint.{ROBUST_NAN // ROBUST_EVERY * ROBUST_EVERY}.pkl and ran "
        f"to {TRAIN_ITERS}: losses and parameters bitwise the uninterrupted "
        f"run's, with the step program captured before the rollback "
        f"({opt._step_program.replays} replays) [{card}]")
    out["rollback_kept_program"] = kept
    release_run(opt)
    # (d) the torn newest version is quarantined; the resume falls back
    snap = events.snapshot()
    prof_dir = robust_dir(f"profile_{fuse}") if not bf16 else None
    opt, rec, params, stopped = lm_run(TransformerLM, lm_criterion, ck, fuse,
                                       resume=True, profile=prof_dir,
                                       sync=True)
    torn = f"checkpoint.{TRAIN_ITERS // ROBUST_EVERY * ROBUST_EVERY}.pkl"
    if events.deltas(snap).get("ckpt_quarantined") != 1 \
            or not (ck / (torn + ".corrupt")).exists():
        raise CheckFailed(f"{what}: the torn {torn} was not quarantined "
                          f"({events.deltas(snap)}, {os.listdir(ck)})")
    back_to = min(rec["losses"])
    if back_to != TRAIN_ITERS // ROBUST_EVERY * ROBUST_EVERY - ROBUST_EVERY + 1:
        raise CheckFailed(f"{what}: the fallback resumed at {back_to}")
    same_run(f"{what}, resumed past a torn {torn}", rec, params, ref,
             ref_params, range(back_to, TRAIN_ITERS + 1))
    out.update(stall_ms_sync=rec["stall_ms"], writer_s_sync=rec["write_s"])
    log(f"  {what}: the torn {torn} quarantined, the resume fell back to "
        f"iteration {back_to} and ran to {TRAIN_ITERS} bitwise; its "
        f"checkpoint written synchronously: stall "
        f"{[round(v, 2) for v in rec['stall_ms']]} ms [{card}]")
    if prof_dir is not None:                                        # (f)
        out["profile"] = check_trace(opt, card)
    release_run(opt)
    if not bf16:                                                    # (e)
        steps = {}
        for check in (False, True):
            opt, rec, params, _ = lm_run(TransformerLM, lm_criterion, None,
                                         1, check_numerics=check)
            same_run(f"{what}, set_check_numerics({check})", rec, params,
                     ref, ref_params, iters)
            steps[check] = float(statistics.median(np.diff(
                rec["marks"]))) * 1e3
            release_run(opt)
        log(f"  {what}: set_check_numerics(True) gave the same losses and "
            f"parameters bitwise; step {steps[True]:.2f} ms against "
            f"{steps[False]:.2f} ms unchecked (no checkpoints, median of "
            f"steps 2-17) [{card}]")
        out.update(check_numerics_step_ms=steps[True],
                   unchecked_step_ms=steps[False])
    del ref_params
    release()
    return out


def check_trace(opt, card) -> dict:
    """(f): the Chrome trace of ``set_profile`` names the five kernels."""
    path = getattr(opt, "profile_trace", None)
    if path is None or not os.path.exists(path):
        raise CheckFailed(f"set_profile wrote no trace ({path})")
    text = Path(path).read_text()
    names = {"layer_norm_fwd": "ln_fwd", "layer_norm_bwd": "ln_bwd",
             "flash_attention_fwd": "flash_fwd_kernel",
             "flash_attention_bwd_dq": "flash_bwd_dq_kernel",
             "flash_attention_bwd_dkv": "flash_bwd_dkv_kernel"}
    found = {k: text.count(w) for k, w in names.items()}
    log(f"  set_profile{ROBUST_PROFILE}: {path} ({len(text)} bytes) names "
        f"the kernels {found} times [{card}]")
    if not all(found.values()):
        raise CheckFailed(f"the profile does not name every kernel: {found}")
    return {"path": os.path.relpath(path), "bytes": len(text),
            "kernel_mentions": found}


def robust_vision(card, Engine):
    """Phase 11's ResNet-50 check: bf16, NHWC, batch 64, a checkpoint at 3
    and sigterm@4; the resumed run's parameters and running statistics
    bitwise the uninterrupted run's."""
    from bigdl_tpu_torch.dataset import DataSet, MiniBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion, layout
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.optim.optimizer import TrainingPreempted
    from bigdl_tpu_torch.utils import faults
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    r = np.random.default_rng(SEED + 13)
    batches = [MiniBatch(r.integers(0, 256, (ROBUST_VISION_BATCH, VISION_HW,
                                             VISION_HW, 3), dtype=np.uint8),
                         r.integers(0, VISION_CLASSES, ROBUST_VISION_BATCH)
                         .astype(np.int32))
               for _ in range(ROBUST_VISION_ITERS)]

    def run(ckpt, plan=None, resume=False):
        RandomGenerator.set_seed(SEED)
        model = build_resnet50(DEVICE)
        opt = (LocalOptimizer(model, DataSet.array(batches),
                              ClassNLLCriterion(), device=DEVICE)
               .set_optim_method(SGD(learningrate=0.01, momentum=0.9,
                                     dampening=0.0))
               .set_end_when(Trigger.max_iteration(ROBUST_VISION_ITERS))
               .set_checkpoint(str(ckpt), Trigger.several_iteration(3)))
        rec = instrument(opt)
        stopped = None
        try:
            with faults.inject_faults(plan or ""):
                opt.optimize(resume="auto" if resume else None)
        except TrainingPreempted as e:
            stopped = e
        torch.cuda.synchronize()
        state = {n: t.detach().clone() for n, t in
                 list(model.named_parameters()) + [
                     (n, b) for n, b in model.named_buffers()
                     if "running" in n]}
        opt._step_program = None
        del opt, model
        release()
        return rec, state, stopped

    # cuDNN's heuristic choice of its deterministic algorithms (the
    # package's default): the same in every run, with no autotuning
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    layout.set_image_format("NHWC")
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        ref, ref_state, _ = run(robust_dir("resnet_ref"))
        ck = robust_dir("resnet")
        _, _, stopped = run(ck, plan="sigterm@4")
        if stopped is None or stopped.iteration != 5:
            raise CheckFailed(f"ResNet-50: sigterm@4 gave {stopped!r}")
        rec, state, _ = run(ck, resume=True)
    finally:
        Engine.reset()
        layout.set_image_format(None)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    differ = [n for n, t in state.items() if not torch.equal(t, ref_state[n])]
    lost = [i for i in rec["losses"] if rec["losses"][i] != ref["losses"][i]]
    n_stats = sum(1 for n in state if "running" in n)
    log(f"  ResNet-50 bf16 NHWC at batch {ROBUST_VISION_BATCH}: sigterm@4 "
        f"stopped before 5 (checkpoint.3 and the emergency checkpoint.5, "
        f"{ref['nbytes'][-1]} bytes), the resumed run's iterations "
        f"{sorted(rec['losses'])}: {len(differ)} of {len(state)} tensors "
        f"({n_stats} running statistics) differ from the uninterrupted "
        f"run's, losses differing at {lost}; stall "
        f"{[round(v, 2) for v in ref['stall_ms']]} ms, writer "
        f"{[round(v, 3) for v in ref['write_s']]} s [{card}]")
    if differ or lost or sorted(rec["losses"]) != [5, 6]:
        raise CheckFailed(f"ResNet-50: the resumed run is not bitwise the "
                          f"uninterrupted one: {differ[:5]}, losses {lost}")
    return {"ckpt_bytes": ref["nbytes"][-1], "stall_ms": ref["stall_ms"],
            "writer_s": ref["write_s"], "running_statistics": n_stats}


def robustness(TransformerLM, lm_criterion, card, Engine):
    """Phase 11: checkpoint, preempt, resume and roll back the trainer at
    full width (the LM in fp32 and bf16, ResNet-50 in bf16)."""
    import shutil
    t0 = time.perf_counter()
    out = {"fp32": robust_lm(TransformerLM, lm_criterion, card, False)}
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        out["bf16"] = robust_lm(TransformerLM, lm_criterion, card, True)
    finally:
        Engine.reset()
    out["resnet50"] = robust_vision(card, Engine)
    shutil.rmtree(work_root() / "phase11",
                  ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 11 took {out['wall_s']:.1f} s [{card}]")
    return out


def remat_captures(n: int, TransformerLM, lm_criterion, kernels, card,
                   Engine) -> int:
    """``--remat-captures N``: phase 6's bf16 run with every block under
    ``Remat`` (the step captured at its first use), N times in this
    process; prints each capture's outcome (a failed one with its step
    and the threads alive as it began) and the count of failed captures
    (ROADMAP Queue C, the remat capture invalidated on the card). An
    observation, not a check: returns 0."""
    from bigdl_tpu_torch.utils import programs
    from bigdl_tpu_torch.utils.programs import ProgramCaptureError
    failures, live = [], []
    capture = programs.Program._warm_up_and_capture

    def spied(self):
        # is the feed's producer thread running while this one captures?
        threads = [t.name for t in threading.enumerate()]
        live.append(any(t.startswith("bigdl-prefetch") for t in threads))
        try:
            return capture(self)
        except ProgramCaptureError:
            failures.append({"threads_alive": threads})
            raise

    programs.Program._warm_up_and_capture = spied
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        for k in range(n):
            try:
                _, run16_remat = train(TransformerLM, lm_criterion, kernels,
                                       card, bf16=True, remat=True,
                                       profile=False)
                log(f"  remat capture {k + 1}/{n}: captured, step "
                    f"{run16_remat['step_ms']:.2f} ms")
            except ProgramCaptureError as e:
                # the step is captured at its first use: iteration 1
                failures[-1].update(run=k + 1, iteration=1, error=str(e))
                log(f"  remat capture {k + 1}/{n}: FAILED at iteration 1 "
                    f"with threads {failures[-1]['threads_alive']}: {e}")
            release()
    finally:
        Engine.reset()
        programs.Program._warm_up_and_capture = capture
    log(f"remat captures: {len(failures)} failed of {n}; {sum(live)} of "
        f"{len(live)} captures ran with the feed's producer thread alive "
        f"[{card}]")
    print(json.dumps({"remat_captures": n, "failed": len(failures),
                      "captures": len(live),
                      "with_live_producer": sum(live),
                      "errors": failures}), flush=True)
    return 0


def lm_feed_ab(rounds: int, TransformerLM, lm_criterion, kernels, card,
               Engine) -> int:
    """``--lm-feed-ab N``: phase 6's bf16 LM at fuse 1 (the LayerNorm/GELU
    model and the llama-style one), N rounds in this process, each round
    every variant in turn and then again in reverse order: prefetch 0 and
    2, each with the loop's event wait before its loss fetch
    (``utils/device.wait_for_stream``) and without it (the fetch a plain
    blocking ``tolist``). A package without the feed (an earlier commit's,
    given with ``--root``) runs its one variant. Prints each variant's
    step medians (phase 6's step time, ms) and returns 0: a measurement,
    not a check."""
    from bigdl_tpu_torch.optim import optimizer as optimizer_module
    has_feed = hasattr(optimizer_module, "wait_for_stream")
    variants = ([(p, w) for p in (0, 2) for w in (True, False)] if has_feed
                else [(None, None)])
    wait = getattr(optimizer_module, "wait_for_stream", None)
    prefetch = os.environ.get("BIGDL_PREFETCH")
    out: dict = {}
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        for k in range(rounds):
            for depth, event in variants + variants[::-1]:
                name = ("no feed" if depth is None else
                        f"prefetch {depth}, "
                        f"{'event wait' if event else 'blocking fetch'}")
                if depth is not None:
                    os.environ["BIGDL_PREFETCH"] = str(depth)
                    optimizer_module.wait_for_stream = (
                        wait if event else (lambda t: None))
                for llama in (False, True):
                    _, run = train(TransformerLM, lm_criterion, kernels,
                                   card, bf16=True, profile=False,
                                   llama=llama)
                    key = ("llama " if llama else "") + name
                    out.setdefault(key, []).append(run["step_ms"])
                    log(f"  round {k + 1}: {key}: step "
                        f"{run['step_ms']:.3f} ms")
                    release()
    finally:
        Engine.reset()
        if wait is not None:
            optimizer_module.wait_for_stream = wait
        if prefetch is None:
            os.environ.pop("BIGDL_PREFETCH", None)
        else:
            os.environ["BIGDL_PREFETCH"] = prefetch
    summary = {key: {"median_ms": statistics.median(v), "runs_ms": v}
               for key, v in out.items()}
    log(f"lm feed A/B, bf16 fuse 1 [{card}]:")
    for key, v in summary.items():
        log(f"  {key}: median {v['median_ms']:.3f} ms over "
            f"{len(v['runs_ms'])} runs")
    print(json.dumps({"lm_feed_ab": summary, "card": card}), flush=True)
    return 0


# --------------------------------------------------------------- phase 12
# the feed: phase 6's LM through set_prefetch(2) against set_prefetch(0)
# (fp32 at fuse 1, bf16 at fuse FUSE), and a preemption at ROBUST_SIGTERM
# resumed with the producer running; then Inception-v1 at the bench's
# inception leg (bigdl_tpu/benchmark.py:251-254): ImageNormalize ->
# Inception_v1_NoAuxClassifier(1000, has_dropout=False), NHWC (:197),
# uint8 224x224x3 (:231-237), batch 256 (:163), 8 in-memory batches,
# ClassNLLCriterion, SGD(0.01, momentum 0.9, dampening 0), bf16 and fp32,
# with the device batch cache off and on
INCEPTION_STEP_FLOPS = 3 * 3.288e9 * VISION_BATCH          # benchmark.py:44
# the one-step check's criterion weights (models/inception/train.py)
AUX_WEIGHTS = (1.0, 0.3, 0.3)
# kinds of a profiled Inception step, by words in the kernel's name (first
# match wins); LRN's band products are GEMMs (the LRN row is its pow and
# division kernels; LRN alone is also timed)
INCEPTION_KINDS = (
    ("layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "implicit")),
    ("concat copies", ("catarraybatchedcopy", "cat_")),
    ("lrn pow/div", ("pow",)),
    ("pooling", ("pool",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("elementwise glue", ("elementwise", "reduce", "vectorized", "unrolled")))
# the LRN layers of Inception-v1 at batch 256, NHWC: after the first pool
# and after conv2
LRN_SHAPES = ((VISION_BATCH, 56, 56, 64), (VISION_BATCH, 56, 56, 192))


def phase_dir(name: str, phase: str = "phase12", disk: bool = False
              ) -> Path:
    """A fresh directory ``<phase>/<name>`` under :func:`work_root`, or
    with ``disk`` under the checkout's build/."""
    import shutil
    d = (Path(__file__).resolve().parent / "build" if disk
         else work_root()) / phase / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def feed_waits():
    """Call before a run; the returned function, called after it, gives
    the run's loop waits on the feed (``phase/feed``), its placements
    (``phase/put_batch``, the h2d stage) and stacks (``feed/stack``) after
    the first of each: the median and the maximum, ms (the first wait and
    placement hold the producer's start, its pinned buffers and the
    capture, which a placement waits out under ``capture_guard``)."""
    from bigdl_tpu_torch.obs.registry import registry
    hists = {k: registry.histogram(n) for k, n in (
        ("wait", "phase/feed"), ("h2d", "phase/put_batch"),
        ("stack", "feed/stack"))}
    n0 = {k: h.count for k, h in hists.items()}

    def after():
        out = {}
        for k, h in hists.items():
            new = h.count - n0[k]
            vals = list(h._window)[-new:][1:] if new else []
            out[k] = ({"median_ms": float(np.median(vals)) * 1e3,
                       "max_ms": max(vals) * 1e3, "n": len(vals)}
                      if vals else None)
        return out
    return after


def lm_step_ms(rec, fuse) -> float:
    marks = rec["marks"]
    if fuse == 1:
        return float(statistics.median(np.diff(marks))) * 1e3
    return (marks[1] - marks[0]) / fuse * 1e3


def feed_lm(TransformerLM, lm_criterion, card, bf16):
    """Phase 12's LM runs in one precision: prefetch 2 against 0, bitwise;
    a preemption and a resume with the producer running, bitwise the
    uninterrupted run; the ring pinned. Returns the numbers."""
    from bigdl_tpu_torch.native import native_available

    fuse = FUSE if bf16 else 1
    what = f"{'bf16' if bf16 else 'fp32'}, fuse {fuse}"
    iters = range(1, TRAIN_ITERS + 1)
    runs = {}
    for depth in (2, 0):
        waits = feed_waits()
        opt, rec, params, stopped = lm_run(TransformerLM, lm_criterion, None,
                                           fuse, prefetch=depth)
        waits = waits()
        if stopped is not None or sorted(rec["losses"]) != list(iters):
            raise CheckFailed(f"the LM ({what}, prefetch {depth}) ran "
                              f"{sorted(rec['losses'])}")
        stm = opt.dataset.transformer
        batch = next(iter(opt.dataset.data(train=True)))
        runs[depth] = {
            "rec": rec, "params": params,
            "step_ms": lm_step_ms(rec, fuse),
            "feed_wait_ms_per_step": opt.metrics.totals().get("feed", 0.0)
            / TRAIN_ITERS * 1e3,
            "feed_wait_ms_after_first_window": waits,
            "feed_stage_ms": dict(opt.feed_stage_ms),
            "pinned": bool(stm.pinned and batch.pinned and torch.from_numpy(
                batch.input).is_pinned()),
            "wall_s": rec["wall_s"]}
        release_run(opt)
    p2, p0 = runs[2], runs[0]
    same_run(f"the LM ({what}) at prefetch 2 against prefetch 0", p2["rec"],
             p2["params"], p0["rec"], p0["params"], iters)
    if not (p2["pinned"] and p0["pinned"]):
        raise CheckFailed(f"the LM's ring ({what}) is not pinned")
    ck = phase_dir(f"lm_{fuse}")
    opt_a, rec_a, _, stopped = lm_run(
        TransformerLM, lm_criterion, ck, fuse,
        plan=f"sigterm@{ROBUST_SIGTERM}")
    if stopped is None:
        raise CheckFailed(f"sigterm@{ROBUST_SIGTERM} ({what}) did not stop "
                          f"the run")
    release_run(opt_a)
    opt_b, rec_b, params_b, stopped_b = lm_run(
        TransformerLM, lm_criterion, ck, fuse, resume=True)
    release_run(opt_b)
    merged = {"losses": {**{i: v for i, v in rec_a["losses"].items()
                            if i < stopped.iteration}, **rec_b["losses"]}}
    same_run(f"the LM ({what}) preempted at {stopped.iteration} and "
             f"resumed with the producer running", merged, params_b,
             p2["rec"], p2["params"], iters)
    if not native_available():
        raise CheckFailed("the native batchpack did not build")
    out = {k: {f: v for f, v in r.items() if f not in ("rec", "params")}
           for k, r in (("prefetch_2", p2), ("prefetch_0", p0))}
    out.update(fuse=fuse, bitwise_prefetch=True, bitwise_resume=True,
               preempted_at=stopped.iteration, native=True)
    log(f"  LM {what}, {TRAIN_ITERS} steps at ({TRAIN_BATCH}, {TRAIN_LEN}): "
        f"prefetch 2 step {p2['step_ms']:.3f} ms, the loop waited "
        f"{p2['feed_wait_ms_per_step']:.3f} ms a step (after the first: "
        f"{p2['feed_wait_ms_after_first_window']}), stages "
        f"{p2['feed_stage_ms']} ms; prefetch 0 step {p0['step_ms']:.3f} ms, "
        f"waited {p0['feed_wait_ms_per_step']:.3f} ms a step (after the "
        f"first: {p0['feed_wait_ms_after_first_window']}), stages "
        f"{p0['feed_stage_ms']} ms; losses and parameters bitwise equal; "
        f"preempted before {stopped.iteration} and resumed bitwise; ring "
        f"pinned, native batchpack built [{card}]")
    return out


def build_inception(device, seed=SEED + 14):
    """``ImageNormalize -> Inception_v1_NoAuxClassifier(1000,
    has_dropout=False)``, the bench's inception leg, weights from a
    seed."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.inception import Inception_v1_NoAuxClassifier
    net = Inception_v1_NoAuxClassifier(
        VISION_CLASSES, has_dropout=False,
        generator=torch.Generator().manual_seed(seed), device=device)
    return nn.Sequential().add(nn.ImageNormalize()).add(net).to(device)


def build_inception_aux(device, seed=SEED + 15):
    """``ImageNormalize -> Inception_v1(1000, has_dropout=False)``: the
    three heads."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.inception import Inception_v1
    net = Inception_v1(VISION_CLASSES, has_dropout=False,
                       generator=torch.Generator().manual_seed(seed),
                       device=device)
    return nn.Sequential().add(nn.ImageNormalize()).add(net).to(device)


def aux_criterion():
    from bigdl_tpu_torch import nn
    crit = nn.ParallelCriterion(repeat_target=True)
    for w in AUX_WEIGHTS:
        crit.add(nn.ClassNLLCriterion(), w)
    return crit


def loss_and_grads(model, criterion, x, y, device):
    """Loss and gradients (host, fp32) of one forward and backward of the
    training step's own path."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer
    opt = LocalOptimizer(model, DataSet.array([]), criterion, device=device)
    names, params = zip(*model.named_parameters())
    loss, grads = opt._loss_and_grads(list(params), x.to(device),
                                      y.to(device))
    return loss.item(), {n: g.detach().cpu().float()
                         for n, g in zip(names, grads)}


def check_inception_step(layout, Engine):
    """One step of ``ImageNormalize -> Inception_v1`` (the aux heads, the
    three log-probabilities into ``ParallelCriterion(repeat_target=True)``
    (1.0, 0.3, 0.3)) at (2, 224, 224, 3) uint8, NHWC, on the card against
    the same weights on the CPU, in fp32 (TF32 off) and bf16.

    fp32: the loss within 1e-4 relative; the gradients (whole model,
    relative Frobenius) within 3x the CPU's own NCHW-to-NHWC distance (at
    least 1e-3), phase 8's rule. ``View`` flattens an aux head's (4, 4,
    128) features in the activation's own order, so the NCHW step runs
    with the heads' first ``Linear`` columns permuted to NCHW order (the
    same function) and its gradients permuted back. bf16: the loss within
    1e-2; the gradients per group (the whole model and each node of the
    graph: the stem, the two aux heads, the middle, the tail) where the
    CPU's bf16-vs-fp32 gap is under 0.5: within 2x that gap of the CPU fp32
    gradient and 1.5x of the CPU bf16 gradient. The card's steps run
    cuDNN's heuristic algorithms (``cudnn.benchmark`` off), as the timed
    training in :func:`inception_path` and the package's own default do.
    Both factors were set from the card's readings (NVIDIA H100 80GB HBM3,
    700 W): 0.5-1.4x the gap from fp32 and 0.4-0.9x from the CPU's bf16
    gradient, group by group; ResNet-50's 1.25 (``check_resnet_step``)
    would fail the 1.4x. Every gap is under 5e-2, so a wrong gradient,
    which reads near 1, fails either limit."""
    import copy
    r = np.random.default_rng(SEED + 16)
    x = torch.from_numpy(r.integers(0, 256, (VISION_PARITY_BATCH, VISION_HW,
                                             VISION_HW, 3), dtype=np.uint8))
    y = torch.from_numpy(r.integers(0, VISION_CLASSES, VISION_PARITY_BATCH)
                         .astype(np.int64))
    base = build_inception_aux("cpu")
    names = [n for n, _ in base.named_parameters()]
    groups = {"all": names}
    for n in names:
        groups.setdefault("node " + n.split(".")[1], []).append(n)

    # an aux head's flattened (h, w, c) feature j is (c, h, w) feature
    # to_nchw[j] in NCHW order
    h, w, c = np.meshgrid(np.arange(4), np.arange(4), np.arange(128),
                          indexing="ij")
    to_nchw = torch.from_numpy((c * 16 + h * 4 + w).ravel())
    heads = [n + ".weight" for n, m in base.named_modules()
             if type(m).__name__ == "Linear" and m.weight.shape[1] == 2048]

    def run(where, fmt, dtype):
        layout.set_image_format(fmt)
        Engine.init(compute_dtype=dtype)
        try:
            model = copy.deepcopy(base)
            if fmt == "NCHW":
                params = dict(model.named_parameters())
                with torch.no_grad():
                    for n in heads:
                        wt = params[n].clone()
                        params[n][:, to_nchw] = wt
            model = model.to(where)
            xx = x if fmt == "NHWC" else x.permute(0, 3, 1, 2).contiguous()
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(model, aux_criterion(), xx, y,
                                         where)
            if where != "cpu":
                torch.cuda.synchronize()
            if fmt == "NCHW":
                for n in heads:
                    grads[n] = grads[n][:, to_nchw]
            del model
            return loss, grads, time.perf_counter() - t0
        finally:
            Engine.reset()
            layout.set_image_format("NHWC")

    card32 = run(DEVICE, "NHWC", torch.float32)
    card16 = run(DEVICE, "NHWC", torch.bfloat16)
    cpu32 = run("cpu", "NHWC", torch.float32)
    cpu32_nchw = run("cpu", "NCHW", torch.float32)
    cpu16 = run("cpu", "NHWC", torch.bfloat16)
    torch.cuda.empty_cache()
    order = flat_rel(cpu32_nchw[1], cpu32[1])
    f = {"loss": card32[0], "loss_rel": abs(card32[0] - cpu32[0]) / cpu32[0],
         "grad_rel": flat_rel(card32[1], cpu32[1]),
         "grad_limit": max(3 * order, 1e-3),
         "cpu_nchw_vs_nhwc_grad_rel": order,
         "card_s": card32[2], "cpu_s": cpu32[2]}
    held, not_held = {}, {}
    for g, ns in groups.items():
        gap = group_rel(cpu16[1], cpu32[1], ns)
        h = {"cpu_gap": gap, "to_fp32": group_rel(card16[1], cpu32[1], ns),
             "to_bf16": group_rel(card16[1], cpu16[1], ns),
             "limit_fp32": 2.0 * gap, "limit_bf16": 1.5 * gap}
        (held if gap < 0.5 else not_held)[g] = h
    b = {"loss": card16[0], "loss_rel": abs(card16[0] - cpu16[0]) / cpu16[0],
         "held": held, "not_held": not_held,
         "card_s": card16[2], "cpu_s": cpu16[2]}
    log(f"  Inception-v1 (aux heads) one (2, 224, 224, 3) uint8 step, fp32: "
        f"loss {f['loss']:.6f} ({f['loss_rel']:.2e} from the CPU's), "
        f"gradients {f['grad_rel']:.2e} (limit {f['grad_limit']:.2e}: the "
        f"CPU's NCHW step is {order:.2e} from its NHWC step); bf16: loss "
        f"{b['loss']:.6f} ({b['loss_rel']:.2e}); card {f['card_s']:.2f} / "
        f"{b['card_s']:.2f} s, CPU {f['cpu_s']:.2f} / {b['cpu_s']:.2f} s")
    for g, h in {**held, **not_held}.items():
        log(f"    bf16 {g} ({'held' if g in held else 'not held'}): CPU gap "
            f"{h['cpu_gap']:.3e}; card to fp32 {h['to_fp32']:.3e} / "
            f"{h['limit_fp32']:.3e}, to bf16 {h['to_bf16']:.3e} / "
            f"{h['limit_bf16']:.3e}")
    if f["loss_rel"] > 1e-4 or f["grad_rel"] > f["grad_limit"]:
        raise CheckFailed(f"the fp32 Inception-v1 step disagrees with the "
                          f"CPU: {f}")
    bad = {g: h for g, h in held.items() if h["to_fp32"] > h["limit_fp32"]
           or h["to_bf16"] > h["limit_bf16"]}
    if b["loss_rel"] > 1e-2 or bad or not held:
        raise CheckFailed(f"the bf16 Inception-v1 step disagrees with the "
                          f"CPU: loss {b['loss_rel']:.2e}, groups out of "
                          f"their limits {bad}, held {sorted(held)}")
    return {"float32": f, "bfloat16": b}


def time_lrn(card):
    """Inception-v1's two LRN layers alone at batch 256, NHWC, bf16 and
    fp32: forward and backward ms (CUDA events)."""
    from bigdl_tpu_torch.nn import SpatialCrossMapLRN
    lrn = SpatialCrossMapLRN(5, 0.0001, 0.75)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in LRN_SHAPES:
            x = torch.randn(shape, device=DEVICE, dtype=dtype,
                            requires_grad=True)
            g = torch.randn(shape, device=DEVICE, dtype=dtype)

            def step():
                x.grad = None
                lrn(x).backward(g)

            ms, _ = time_ms(step, reps=10, trials=3)
            out[f"{str(dtype)[6:]} {shape}"] = ms
    log(f"  LRN alone (forward and backward, NHWC, batch {VISION_BATCH}): "
        f"{ {k: round(v, 3) for k, v in out.items()} } ms [{card}]")
    return out


def run_inception_main(argv, card):
    """``python -m bigdl_tpu_torch.models.inception.train`` on the card:
    the final loss finite."""
    from bigdl_tpu_torch.models.inception import train as main
    t0 = time.perf_counter()
    opt = main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss = opt.state["loss"]
    log(f"  inception main ({' '.join(argv) or 'defaults'}): final loss "
        f"{loss:.4f}, {opt.state['neval'] - 1} steps, {wall:.2f} s in all "
        f"[{card}]")
    if not np.isfinite(loss):
        raise CheckFailed(f"the inception main ({argv}) gave loss {loss}")
    return {"final_loss": loss, "wall_s": wall}


def inception_path(kernels, card, Engine):
    """Phase 12's Inception-v1: the one-step checks, bf16 and fp32 at batch
    256 through the prefetching feed with the device cache off (replays
    bitwise against eager, bf16) and on, a profiled step of each, LRN
    alone, and the training main at its defaults and with ``--v2``. All
    of it under cuDNN's heuristic algorithms (``cudnn.benchmark`` off, the
    package's default), the setting the one-step check holds."""
    from bigdl_tpu_torch.nn import layout

    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    layout.set_image_format("NHWC")
    env = os.environ.get("BIGDL_DEVICE_CACHE")
    out = {}
    opts = dict(build=build_inception, name="Inception-v1",
                step_flops=INCEPTION_STEP_FLOPS, kinds=INCEPTION_KINDS)
    try:
        out["one_step_check"] = check_inception_step(layout, Engine)
        data = vision_batches(TRAIN_STEPS, SEED + 17)
        for precision in ("bf16", "fp32"):
            if precision == "bf16":
                Engine.init(compute_dtype=torch.bfloat16)
            try:
                for cache in ("0", "1"):
                    os.environ["BIGDL_DEVICE_CACHE"] = cache
                    run, _ = train_vision(
                        data, kernels, card, bf16=precision == "bf16",
                        compare=precision == "bf16" and cache == "0",
                        profile=cache == "0", **opts)
                    if run["device_cache"] != (cache == "1"):
                        raise CheckFailed(f"the device cache was "
                                          f"{run['device_cache']} with "
                                          f"BIGDL_DEVICE_CACHE={cache}")
                    key = f"training_{precision}_cache_{cache}"
                    out[key] = {k: run.get(k) for k in (
                        "step_ms", "images_per_s", "bf16_peak_share",
                        "peak_memory_bytes", "first_window_ms",
                        "feed_wait_ms_per_step",
                        "feed_wait_ms_after_first_window", "feed_stage_ms",
                        "replay_vs_eager", "losses")}
                    if run["profile"] is not None:
                        out[key]["profile"] = {k: run["profile"].get(k) for k
                                               in ("busy_ms", "wall_ms",
                                                   "by_kind_ms", "host_calls",
                                                   "top")}
                    release()
            finally:
                Engine.reset()
        out["lrn_alone_ms"] = time_lrn(card)
        del data
        release()
    finally:
        if env is None:
            os.environ.pop("BIGDL_DEVICE_CACHE", None)
        else:
            os.environ["BIGDL_DEVICE_CACHE"] = env
        layout.set_image_format(None)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    out["main"] = run_inception_main([], card)
    out["main_v2"] = run_inception_main(["--v2"], card)
    release()
    return out


def feed_path(TransformerLM, lm_criterion, kernels, card, Engine):
    """Phase 12: the feed under phase 6's LM (its launches counted from a
    reset), then Inception-v1 at full width."""
    import shutil
    t0 = time.perf_counter()
    kernels.reset_launch_counts()       # the feed's LM path: from here ...
    out = {"lm_fp32": feed_lm(TransformerLM, lm_criterion, card, False)}
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        out["lm_bf16"] = feed_lm(TransformerLM, lm_criterion, card, True)
    finally:
        Engine.reset()
    out["launches"] = kernels.launch_counts()   # ... to here
    log(f"  launches on the feed's LM path: {out['launches']}")
    for name, n in out["launches"].items():
        if n == 0 and name not in NMS_KERNELS:
            raise CheckFailed(f"phase 12's LM path never launched {name}")
    shutil.rmtree(work_root() / "phase12",
                  ignore_errors=True)
    t1 = time.perf_counter()
    out["inception"] = inception_path(kernels, card, Engine)
    out["lm_wall_s"] = t1 - t0
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 12 took {out['wall_s']:.1f} s (the LM {out['lm_wall_s']:.1f}"
        f" s) [{card}]")
    return out


# --------------------------------------------------------------- phase 13
# the text family: the PTB LSTM LM at the JAX bench's ptb-lstm leg
# (bigdl_tpu/benchmark.py:259-264): PTBModel(10000, 650, num_layers=2),
# batch 64 (:164), bptt 35 (:55), TimeDistributedCriterion(
# ClassNLLCriterion, size_average=True), trained as the PTB main trains
# (bigdl_tpu/models/rnn/train.py: SGD(1.0), clip-norm 5) on the synthetic
# corpus over 10000 words (8 batches an epoch), fp32 and bf16; then the
# TreeLSTM and text-classifier mains at their defaults and one ConvLSTM
# forward and backward
PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS = 10000, 650, 2
PTB_BATCH, PTB_BPTT = 64, 35
PTB_WORD_FLOPS = 3 * 26.5e6                     # benchmark.py:36-46
PTB_PARITY_BATCH = 16
PTB_BEAM, PTB_GENERATE = 3, 20
CONV_LSTM = (8, 10, 16, 32, 32)                 # N, T, C, H, W
# kinds of a profiled PTB step, by words in the kernel's name (first match
# wins): the gates' nonlinearities, the head's log-softmax and the NLL
# criterion, the embedding's gather and scatter, the stacked outputs
# (torch.stack: cat), reductions (the clip's norm), the remaining
# elementwise kernels (the gates' sums and products, the update)
PTB_KINDS = (
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("gate sigmoid/tanh", ("sigmoid", "tanh")),
    ("log-softmax/criterion", ("softmax", "nll_loss")),
    ("embedding", ("embedding", "indexselect", "index_select",
                   "indexing_backward", "index_put")),
    ("stack/copies", ("catarraybatchedcopy", "cat_", "copy")),
    ("reductions", ("reduce",)),
    ("other elementwise", ("elementwise", "vectorized", "unrolled")))


def build_ptb(device, seed=SEED + 20):
    from bigdl_tpu_torch.models.rnn import PTBModel
    return PTBModel(PTB_VOCAB, PTB_HIDDEN, num_layers=PTB_LAYERS,
                    generator=torch.Generator().manual_seed(seed),
                    device=device)


def ptb_criterion():
    from bigdl_tpu_torch import nn
    return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)


def ptb_optimizer(model, data):
    """The PTB main's trainer: SGD(1.0), the gradients clipped to L2 norm
    5."""
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer
    return (LocalOptimizer(model, data, ptb_criterion(), device=DEVICE)
            .set_optim_method(SGD(learningrate=1.0))
            .set_gradient_clipping_by_l2_norm(5.0))


def ptb_groups(names) -> dict:
    """Gradient groups of the one-step check: the whole model and each
    layer (embedding, lstm1, lstm2, decoder)."""
    groups = {"all": list(names)}
    labels = {"0": "embedding", "1": "lstm1", "2": "lstm2", "3": "decoder"}
    for n in names:
        groups.setdefault(labels[n.split(".")[0]], []).append(n)
    return groups


def check_ptb_step(Engine):
    """One (16, 35) step of the PTB LM (the trainer's loss-and-gradient
    path) on the card against the same weights and batch on the CPU.

    fp32 (TF32 off): loss within 1e-4 relative, every parameter's gradient
    within 1e-3 relative (Frobenius), phase 6's limits. bf16 (JAX's
    promotion: the embedding and the first layer's input projection in
    bf16, the recurrences, the second layer and the head in fp32): loss
    within 1e-2; each group's gradient (the whole model and each layer)
    within 2x the CPU's own bf16-vs-fp32 gap of that group from the CPU
    fp32 gradient and 1.5x of it from the CPU bf16 gradient, phase 12's
    factors, each limit at least 1e-3 (phase 6's fp32 limit, which the
    fp32 parts of the bf16 step alone may use)."""
    r = np.random.default_rng(SEED + 21)
    ids = torch.from_numpy(r.integers(0, PTB_VOCAB, (PTB_PARITY_BATCH,
                                                     PTB_BPTT + 1)))
    x, y = ids[:, :-1], ids[:, 1:]
    base = build_ptb("cpu")

    def run(where, dtype):
        import copy
        Engine.init(compute_dtype=dtype)
        try:
            model = copy.deepcopy(base).to(where)
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(model, ptb_criterion(), x, y, where)
            if where != "cpu":
                torch.cuda.synchronize()
            return loss, grads, time.perf_counter() - t0
        finally:
            Engine.reset()

    card32, card16 = run(DEVICE, torch.float32), run(DEVICE, torch.bfloat16)
    cpu32, cpu16 = run("cpu", torch.float32), run("cpu", torch.bfloat16)
    rel = rel_errors(card32[1], cpu32[1])
    worst = max(rel, key=rel.get)
    f = {"loss": card32[0], "loss_rel": abs(card32[0] - cpu32[0]) / cpu32[0],
         "worst_grad_rel": rel[worst], "worst": worst,
         "card_s": card32[2], "cpu_s": cpu32[2]}
    groups = {}
    for g, ns in ptb_groups(card16[1]).items():
        gap = group_rel(cpu16[1], cpu32[1], ns)
        groups[g] = {"cpu_gap": gap,
                     "to_fp32": group_rel(card16[1], cpu32[1], ns),
                     "to_bf16": group_rel(card16[1], cpu16[1], ns),
                     "limit_fp32": max(2.0 * gap, 1e-3),
                     "limit_bf16": max(1.5 * gap, 1e-3)}
    b = {"loss": card16[0], "loss_rel": abs(card16[0] - cpu16[0]) / cpu16[0],
         "groups": groups, "card_s": card16[2], "cpu_s": cpu16[2]}
    log(f"  PTB LM one ({PTB_PARITY_BATCH}, {PTB_BPTT}) step, fp32: loss "
        f"{f['loss']:.6f} ({f['loss_rel']:.2e} from the CPU's, limit 1e-4), "
        f"worst gradient {f['worst_grad_rel']:.2e} ({worst}, limit 1e-3); "
        f"bf16: loss {b['loss']:.6f} ({b['loss_rel']:.2e}, limit 1e-2); "
        f"card {f['card_s']:.2f} / {b['card_s']:.2f} s, CPU "
        f"{f['cpu_s']:.2f} / {b['cpu_s']:.2f} s")
    for g, h in groups.items():
        log(f"    bf16 {g}: CPU gap {h['cpu_gap']:.3e}; card to fp32 "
            f"{h['to_fp32']:.3e} / {h['limit_fp32']:.3e}, to bf16 "
            f"{h['to_bf16']:.3e} / {h['limit_bf16']:.3e}")
    if f["loss_rel"] > 1e-4 or f["worst_grad_rel"] > 1e-3:
        raise CheckFailed(f"the fp32 PTB step disagrees with the CPU: {f}")
    bad = {g: h for g, h in groups.items() if h["to_fp32"] > h["limit_fp32"]
           or h["to_bf16"] > h["limit_bf16"]}
    if b["loss_rel"] > 1e-2 or bad:
        raise CheckFailed(f"the bf16 PTB step disagrees with the CPU: loss "
                          f"{b['loss_rel']:.2e}, groups out of their limits "
                          f"{bad}")
    return {"float32": f, "bfloat16": b}


def ptb_data():
    """The synthetic corpus over 10000 words in (64, 35) windows: 8 batches
    an epoch."""
    from bigdl_tpu_torch.dataset import (
        DataSet, Sample, SampleToMiniBatch, ptb_windows, synthetic_ptb,
    )
    ids = synthetic_ptb(PTB_BATCH * TRAIN_STEPS * PTB_BPTT + 1,
                        vocab_size=PTB_VOCAB, seed=SEED)
    xs, ys = ptb_windows(ids, PTB_BPTT)
    return (DataSet.array(Sample(x, y) for x, y in zip(xs, ys))
            >> SampleToMiniBatch(PTB_BATCH))


def ptb_gemm_split(opt, batch, card) -> Optional[dict]:
    """Device time of the GEMMs of one eager step by operand shape, from
    ``torch.profiler`` with the shapes recorded (a replayed step shows
    kernels only): the recurrent products (64 rows), the hoisted input
    projection (N*T rows, 4H columns), the decoder (the vocabulary), forward
    and backward; and the update's ops (``update_with_trimmed`` run under a
    label). The eager step runs the replayed step's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from bigdl_tpu_torch.optim.optim_method import hyper_tensor

    named, scales, mask = opt._prepare_step()
    method = opt._method
    plain_update = method.update_with_trimmed

    def labelled(*args, **kw):
        with record_function("phase13/update"):
            return plain_update(*args, **kw)

    step = opt._make_step_fn(named, scales, mask)
    inp, target = (torch.as_tensor(a).to(DEVICE)
                   for a in (batch.input, batch.target))
    h = hyper_tensor(method.hyper(0, opt._ostate), list(named.values()))
    method.update_with_trimmed = labelled
    try:
        step(inp, target, h)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            step(inp, target, h)
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 — an observation, not a check
        log(f"  GEMM split: no device times ({type(e).__name__}: {e})")
        return None
    finally:
        del method.update_with_trimmed

    def dev_ms(e):
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        return us / 1e3

    split = {"recurrent": 0.0, "input projection": 0.0, "decoder": 0.0,
             "other gemm": 0.0}
    rows = PTB_BATCH * PTB_BPTT
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key not in ("aten::mm", "aten::addmm", "aten::bmm"):
            continue
        dims = {d for s in (e.input_shapes or []) for d in (s or [])}
        if PTB_VOCAB in dims:
            kind = "decoder"
        elif rows in dims and 4 * PTB_HIDDEN in dims:
            kind = "input projection"
        elif PTB_BATCH in dims:
            kind = "recurrent"
        else:
            kind = "other gemm"
        split[kind] += dev_ms(e)
    update = [dev_ms(e) for e in prof.key_averages()
              if e.key == "phase13/update"
              and e.device_type == DeviceType.CUDA]
    split["update"] = update[0] if update else None
    log(f"  GEMMs of one eager step by shape, and the update: "
        f"{ {k: (round(v, 3) if v is not None else None) for k, v in split.items()} } "
        f"ms of device time [{card}]")
    return split


def train_ptb(kernels, card, bf16=False, fuse=1, profile=True):
    """TRAIN_ITERS steps of the PTB LM at (64, 35) through the PTB main's
    trainer, the prefetching feed and the captured step (fuse 1) or fused
    windows of ``fuse``; the same steps run eagerly from the same seed,
    which the replays must equal bit for bit (losses and parameters).
    Returns the run's numbers."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.optim.optim_method import hyper_tensor
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    data = ptb_data()
    model = build_ptb(DEVICE)
    opt = (ptb_optimizer(model, data)
           .set_end_when(Trigger.max_iteration(TRAIN_ITERS))
           .set_fuse_steps(fuse))
    losses, marks, windows, seen = [], [], [], []
    run_steps = opt._run_steps

    def recorded(steps):
        out = run_steps(steps)
        marks.append(time.perf_counter())
        losses.extend(out)
        windows.append(len(steps))
        seen.extend((a.clone(), b.clone()) for a, b in steps)
        return out

    opt._run_steps = recorded
    RandomGenerator.set_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kernels.launch_counts()
    waits = feed_waits()
    t0 = time.perf_counter()
    try:
        opt.optimize()
        torch.cuda.synchronize()
    finally:
        opt._run_steps = run_steps
    wall = time.perf_counter() - t0
    waits = waits()
    counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    what = ("bf16" if bf16 else "fp32") + f" steps, fuse {fuse}"
    if len(losses) != TRAIN_ITERS or not all(np.isfinite(losses)):
        raise CheckFailed(f"PTB LM training gave losses {losses}")
    if fuse == 1:
        step_ms = float(statistics.median(np.diff(marks))) * 1e3
    else:
        if windows[:2] != [fuse, fuse]:
            raise CheckFailed(f"windows {windows}, not two of {fuse} first")
        step_ms = (marks[1] - marks[0]) / fuse * 1e3
    words = PTB_BATCH * PTB_BPTT
    wps = words / step_ms * 1e3
    peak_name = "bfloat16" if bf16 else "float32"
    share = PTB_WORD_FLOPS * wps / PEAK_FLOPS[peak_name]
    log(f"  PTB LM {TRAIN_ITERS} {what} at ({PTB_BATCH}, {PTB_BPTT}): "
        f"windows {windows}; losses {[round(v, 4) for v in losses]}; first "
        f"window (warm-up and capture) {(marks[0] - t0) * 1e3:.1f} ms; step "
        f"{step_ms:.3f} ms, {wps:.0f} words/s, {share:.2%} of the "
        f"{peak_name} peak ({PTB_WORD_FLOPS / 1e6:.1f} MFLOP a word); peak "
        f"memory {peak / 2**30:.2f} GiB; feed waits after the first {waits}; "
        f"{wall:.2f} s in all [{card}]")
    if any(counts.values()):
        raise CheckFailed(f"the PTB LM launched the LM kernels {counts}")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    prof = split = None
    if profile:
        batch = next(iter(data.data(train=True)))
        prof = profile_step(opt, batch, card, kinds=PTB_KINDS)
        split = ptb_gemm_split(opt, batch, card)
    opt._step_program = None
    del opt, model
    release()
    # the same steps, eagerly, from the same seed
    ref = build_ptb(DEVICE)
    ropt = ptb_optimizer(ref, DataSet.array([]))
    named, scales, mask = ropt._prepare_step()
    step = ropt._make_step_fn(named, scales, mask)
    ref_losses = [float(step(inp, target, hyper_tensor(
        ropt._method.hyper(k, ropt._ostate), list(named.values()))))
        for k, (inp, target) in enumerate(seen)]
    torch.cuda.synchronize()
    ref_params = dict(ref.named_parameters())
    bitwise = losses == ref_losses and all(
        torch.equal(p, ref_params[n]) for n, p in params.items())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    param_err = max(max_err(p, ref_params[n]) for n, p in params.items())
    log(f"  {what}, replayed against eager on the card: losses relative "
        f"{loss_rel:.2e}, parameters max|err| {param_err:.3e}; bitwise "
        f"{bitwise}")
    if not bitwise:
        raise CheckFailed(f"PTB LM {what}: the replayed steps are not bitwise "
                          f"equal to the eager ones")
    if any(p.dtype != torch.float32 for p in params.values()):
        raise CheckFailed("the PTB LM's master parameters are not fp32")
    run = dict(losses=losses, step_ms=step_ms, words_per_s=wps,
               peak_share=share, peak_of=peak_name, peak_memory_bytes=peak,
               first_window_ms=(marks[0] - t0) * 1e3, windows=windows,
               feed_wait_ms_after_first_window=waits,
               replay_vs_eager={"bitwise": bitwise, "loss_rel": loss_rel,
                                "param_max_abs_err": param_err},
               gemm_split_ms=split, profile=None if prof is None else {
                   k: prof.get(k) for k in ("busy_ms", "wall_ms",
                                            "by_kind_ms", "host_calls",
                                            "top")})
    del ref, ropt, seen
    release()
    return run


def graph_of(fn):
    """``fn`` captured as one CUDA graph (after a warm-up call on a side
    stream); returns the graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def cudnn_yardstick(card) -> dict:
    """Not on the port's path: ``torch.nn.LSTM(650, 650, 2,
    batch_first=True)`` (cuDNN) with the port's two ``Recurrent(LSTM)``
    layers' weights (i|f|g|o in both), forward and backward on the same
    (64, 35, 650) fp32 input (TF32 off), against the port's two layers
    captured as one CUDA graph (as the trainer runs them), both timed by
    device time; the outputs must agree (5e-5, the weight mapping)."""
    from bigdl_tpu_torch import nn
    g = torch.Generator().manual_seed(SEED + 22)
    port = nn.Sequential()
    for _ in range(PTB_LAYERS):
        port.add(nn.Recurrent(nn.LSTM(PTB_HIDDEN, PTB_HIDDEN, generator=g)))
    port = port.to(DEVICE)
    lib = torch.nn.LSTM(PTB_HIDDEN, PTB_HIDDEN, PTB_LAYERS,
                        batch_first=True).to(DEVICE)
    with torch.no_grad():
        for i in range(PTB_LAYERS):
            cell = port[i].cell
            for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
                name = k.replace("w_", "weight_").replace("b_", "bias_")
                getattr(lib, f"{name}_l{i}").copy_(getattr(cell, k))
    r = np.random.default_rng(SEED + 23)
    x = torch.from_numpy(r.normal(size=(PTB_BATCH, PTB_BPTT, PTB_HIDDEN))
                         .astype(np.float32)).to(DEVICE).requires_grad_()
    gy = torch.from_numpy(r.normal(size=(PTB_BATCH, PTB_BPTT, PTB_HIDDEN))
                          .astype(np.float32)).to(DEVICE)
    pp, lp = list(port.parameters()), list(lib.parameters())

    def port_step():
        return torch.autograd.grad(port(x), [x] + pp, gy)

    def lib_step():
        return torch.autograd.grad(lib(x)[0], [x] + lp, gy)

    with torch.no_grad():
        err = max_err(port(x), lib(x)[0])
    replay = graph_of(port_step)
    port_ms, port_host = time_ms(replay, reps=10, trials=5)
    eager_ms, eager_host = time_ms(port_step, reps=3, trials=3)
    lib_ms, lib_host = time_ms(lib_step, reps=10, trials=5)
    # the bound: the recurrences' and projections' products (2 layers,
    # forward and backward: 3x the forward's 2 x 4 x 2 x N x T x H^2)
    flops = 3 * PTB_LAYERS * 4 * 2 * 2 * PTB_BATCH * PTB_BPTT * \
        PTB_HIDDEN ** 2
    bound, by = bound_ms(0.0, flops, "float32")
    out = {"port_graph_ms": port_ms, "port_eager_ms": eager_ms,
           "port_eager_host_ms": eager_host, "cudnn_ms": lib_ms,
           "cudnn_host_ms": lib_host, "gap": port_ms / lib_ms,
           "bound_ms": bound, "bound_by": by, "max_abs_err": err}
    log(f"  yardstick (not on the path): two LSTM layers' forward and "
        f"backward at ({PTB_BATCH}, {PTB_BPTT}, {PTB_HIDDEN}) fp32: the "
        f"port's Recurrent(LSTM) layers as one CUDA graph {port_ms:.3f} ms "
        f"(eager {eager_ms:.3f} ms of device time, {eager_host:.3f} ms to "
        f"enqueue), cuDNN's torch.nn.LSTM {lib_ms:.3f} ms (the port takes "
        f"{out['gap']:.2f}x cuDNN's time); fp32 FMA bound {bound:.3f} ms; "
        f"outputs within {err:.2e} [{card}]")
    if err > 5e-5:
        raise CheckFailed(f"the yardstick's LSTM disagrees with the port's "
                          f"({err:.3e}): the weight mapping is wrong")
    del replay, port, lib
    release()
    return out


def ptb_generate(card) -> dict:
    """``--generate 20 --beam 3`` of the PTB main (``SequenceBeamSearch``,
    the full forward every step) on a full-width model, timed: 20 words
    from an 8-word seed, finite scores, ids in the vocabulary."""
    from bigdl_tpu_torch.dataset import Dictionary
    from bigdl_tpu_torch.models.rnn.train import generate
    model = build_ptb(DEVICE)
    seed = np.random.default_rng(SEED + 24).integers(
        1, PTB_VOCAB, PTB_BPTT // 4)
    generate(model, Dictionary.synthetic(PTB_VOCAB), seed, 2, PTB_BEAM, 0.6)
    toks, words, wall = generate(model, Dictionary.synthetic(PTB_VOCAB),
                                 seed, PTB_GENERATE, PTB_BEAM, 0.6)
    log(f"  beam search ({PTB_BEAM} beams, {PTB_GENERATE} words after "
        f"{len(seed)}, the full forward each step): {wall:.3f} s, "
        f"{wall / PTB_GENERATE * 1e3:.1f} ms a word; {' '.join(words[-5:])} "
        f"... [{card}]")
    if len(toks) != len(seed) + PTB_GENERATE or not all(
            0 <= t < PTB_VOCAB for t in toks):
        raise CheckFailed(f"beam search gave {toks}")
    del model
    release()
    return {"wall_s": wall, "ms_per_word": wall / PTB_GENERATE * 1e3,
            "tokens": len(toks)}


def check_tree_accuracy(opt, card) -> dict:
    """The TreeLSTM main's held-out set through ``run_device_eval`` (the
    ``TreeNNAccuracy`` device fold in the captured eval program) against
    the host fold of eager outputs: equal counts."""
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.models.treelstm.train import synthetic_trees
    from bigdl_tpu_torch.nn.abstractnn import evaluating
    from bigdl_tpu_torch.optim.evaluator import run_device_eval
    from bigdl_tpu_torch.optim.validation import TreeNNAccuracy
    samples = synthetic_trees(2048, 8, 60)[int(0.9 * 2048):]
    test = DataSet.array(samples) >> SampleToMiniBatch(64)
    (dev,), _ = run_device_eval(opt.model, test, [TreeNNAccuracy()], DEVICE)
    host = None
    with torch.no_grad(), evaluating(opt.model):
        for b in test.data(train=False):
            out = opt.model(tuple(torch.from_numpy(a).to(DEVICE)
                                  for a in b.input)).cpu()
            part = TreeNNAccuracy().apply(out, b.target, b.valid)
            host = part if host is None else host + part
    log(f"  TreeNNAccuracy over {dev.count} held-out trees: device fold "
        f"{dev.correct:.0f}/{dev.count}, host fold {host.correct:.0f}/"
        f"{host.count} [{card}]")
    if (dev.correct, dev.count) != (host.correct, host.count):
        raise CheckFailed(f"TreeNNAccuracy's device fold {dev} differs from "
                          f"the host fold {host}")
    return {"correct": dev.correct, "count": dev.count}


def check_conv_lstm(card) -> dict:
    """One forward and backward of ``Recurrent(ConvLSTMPeephole(16, 32))``
    at (8, 10, 16, 32, 32) fp32 (TF32 off) on the card against the CPU:
    the output within 1e-4 relative, every gradient (the input's and each
    parameter's) within 1e-3 relative (Frobenius)."""
    import copy
    from bigdl_tpu_torch import nn
    base = nn.Recurrent(nn.ConvLSTMPeephole(
        CONV_LSTM[2], 32, generator=torch.Generator().manual_seed(SEED + 25)))
    r = np.random.default_rng(SEED + 26)
    x = torch.from_numpy(r.normal(size=CONV_LSTM).astype(np.float32))
    runs = []
    for where in (DEVICE, "cpu"):
        m = copy.deepcopy(base).to(where)
        xx = x.to(where).requires_grad_()
        t0 = time.perf_counter()
        out = m(xx)
        gy = torch.ones_like(out) / out.numel() ** 0.5
        grads = torch.autograd.grad(out, [xx] + list(m.parameters()), gy)
        if where != "cpu":
            torch.cuda.synchronize()
        runs.append((out.detach().cpu(), {n: g.cpu() for n, g in zip(
            ["input"] + [n for n, _ in m.named_parameters()], grads)},
            time.perf_counter() - t0))
    (out, grads, s), (out_ref, grads_ref, s_ref) = runs
    out_rel = float((out - out_ref).norm() / out_ref.norm())
    rel = rel_errors(grads, grads_ref)
    worst = max(rel, key=rel.get)
    log(f"  Recurrent(ConvLSTMPeephole(16, 32)) at {CONV_LSTM}: output "
        f"{out_rel:.2e} from the CPU's (limit 1e-4), worst gradient "
        f"{rel[worst]:.2e} ({worst}, limit 1e-3); card {s:.2f} s, CPU "
        f"{s_ref:.2f} s [{card}]")
    if out_rel > 1e-4 or rel[worst] > 1e-3:
        raise CheckFailed(f"the ConvLSTM disagrees with the CPU: output "
                          f"{out_rel:.3e}, {worst} {rel[worst]:.3e}")
    return {"out_rel": out_rel, "worst_grad_rel": rel[worst]}


def text_path(kernels, card, Engine):
    """Phase 13: the PTB LSTM LM at full width (the one-step checks, fp32
    and bf16 at fuse 1 and bf16 at fuse 8, each replayed bitwise against
    eager steps, profiled; the cuDNN yardstick; generation), then the
    TreeLSTM and text-classifier mains and the ConvLSTM check."""
    from bigdl_tpu_torch.models.textclassifier import train as tc_main
    from bigdl_tpu_torch.models.treelstm import train as tree_main
    t0 = time.perf_counter()
    out = {"one_step_check": check_ptb_step(Engine),
           "training_fp32": train_ptb(kernels, card)}
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        out["training_bf16"] = train_ptb(kernels, card, bf16=True)
        out["training_bf16_fused"] = train_ptb(kernels, card, bf16=True,
                                               fuse=FUSE, profile=False)
    finally:
        Engine.reset()
    out["cudnn_yardstick"] = cudnn_yardstick(card)
    out["generate"] = ptb_generate(card)
    out["treelstm_main"], opt = run_main(tree_main, [], card, 64,
                                         unit="trees", keep=True)
    out["treelstm_main"]["accuracy_folds"] = check_tree_accuracy(opt, card)
    del opt
    out["textclassifier_main"] = run_main(tc_main, [], card, 64,
                                          unit="sentences")
    out["conv_lstm"] = check_conv_lstm(card)
    release()
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 13 took {out['wall_s']:.1f} s [{card}]")
    return out


# --------------------------------------------------------------- phase 14
# the rest of serving at full width: phase 5's served LM, 8 slots, fp32,
# the default buckets; the swap's v2 is a second LM of the same shape from
# STACK_SEED; the lifecycle trains the served LM (max_len MAX_LEN, so its
# tree fits the engine) STACK_STEPS fp32 steps at TRAIN_BATCH x TRAIN_LEN
# with a checkpoint every STACK_EVERY, and gates on STACK_EVAL_BATCHES
# batches of the training data
STACK_SEED = SEED + 40
STACK_STEPS, STACK_EVERY, STACK_EVAL_BATCHES = 8, 4, 2
STACK_STALL_S = 1.5        # the watchdog check's stall (BIGDL_FAULT_STALL_S)
# every engine's hard limit (BIGDL_WATCHDOG_S); the monitor polls every
# eighth of it, so a 1.5 s stall past the ratio rule's 0.25 s is seen
STACK_WATCHDOG_S = 2.0
STACK_CRASH_AT = 6         # serve_thread@N: the Nth loop iteration dies


def sync() -> None:
    if DEVICE != "cpu":
        torch.cuda.synchronize()


# phase 14's launches by who made them, beside the process-wide counts
_APART: dict = {}


def count_apart(part: str, counts: dict) -> None:
    acc = _APART.setdefault(part, {})
    for k, v in counts.items():
        acc[k] = acc.get(k, 0) + v


@contextlib.contextmanager
def apart(part: str):
    """Count the block's launches under ``part`` of phase 14: its
    references (greedy forwards, near-tie checks), left out of the phase's
    path; the trainer and the evaluator, kept in it but counted apart from
    the engines. The counts are process-wide, so a block runs only while
    every engine is idle. Yields the block's own counts, filled at its
    end."""
    from bigdl_tpu_torch import kernels
    before, mine = kernels.launch_counts(), {}
    try:
        yield mine
    finally:
        mine.update({k: v - before[k]
                     for k, v in kernels.launch_counts().items()})
        count_apart(part, mine)


def stack_launches(total: dict) -> dict:
    """Phase 14's launches, ``total`` since the reset before it: the path's
    (all but the references'), and the engines' (the path's less the
    trainer's and the evaluator's). The engines must have launched the
    LayerNorm forward and the trainer every kernel."""
    parts = {p: {k: _APART.get(p, {}).get(k, 0) for k in total}
             for p in ("references", "trainer", "evaluator")}
    path = {k: n - parts["references"][k] for k, n in total.items()}
    engines = {k: n - parts["trainer"][k] - parts["evaluator"][k]
               for k, n in path.items()}
    log(f"  launches on the path: {path}; the engines' {engines}, the "
        f"trainer's {parts['trainer']}, the evaluator's "
        f"{parts['evaluator']}; left out, the references' "
        f"{parts['references']}")
    if engines["layer_norm_fwd"] <= 0 or min(engines.values()) < 0:
        raise CheckFailed(f"phase 14's engines launched {engines}")
    idle = [k for k, n in parts["trainer"].items()
            if n == 0 and k not in NMS_KERNELS]
    if idle:
        raise CheckFailed(f"phase 14's trainer never launched {idle}")
    return dict(parts, path=path, engines=engines)


def hist_delta(before: dict, name: str) -> tuple:
    """(observations, their sum) of histogram ``name`` of the obs registry
    since its snapshot ``before``."""
    from bigdl_tpu_torch.obs.registry import registry
    zero = {"count": 0, "total": 0.0}
    h0 = before["histograms"].get(name, zero)
    h1 = registry.snapshot()["histograms"].get(name, zero)
    return h1["count"] - h0["count"], h1["total"] - h0["total"]


def one_observation(before: dict, name: str, what: str) -> float:
    n, total = hist_delta(before, name)
    if n != 1:
        raise CheckFailed(f"{what}: {n} observations of {name}, not 1")
    return total


def forward_greedy(lm, prefix, n: int) -> np.ndarray:
    """``prefix`` and the ``n`` greedy tokens after it, each the argmax of
    a full-sequence forward (no cache): a reference independent of the
    engine's cached path, and far cheaper at 700-token prompts than
    ``greedy_generate``, which steps the prompt a position at a time."""
    seq = torch.as_tensor(np.asarray(prefix), dtype=torch.long,
                          device=DEVICE)[None]
    with torch.no_grad():
        for _ in range(n):
            nxt = lm(seq)[0, -1].argmax()
            seq = torch.cat([seq, nxt.view(1, 1)], dim=1)
    return seq[0].cpu().numpy()


def stack_dir(name: str) -> Path:
    """A fresh directory under the checkout's build/phase14/."""
    return phase_dir(name, "phase14", disk=True)


def lm_tree(lm) -> dict:
    """A copy of the LM's weights laid out as JAX's ``get_params()``,
    tensors on the LM's device (what ``swap_weights`` takes)."""
    from bigdl_tpu_torch import convert
    with torch.no_grad():
        return convert.nest(lm, {n: p.detach().clone()
                                 for n, p in lm.named_parameters()})


class Stack:
    """Phase 14's engines: each one's watchdog dumps are summed at the end
    (the stall check's one dump, no other)."""

    def __init__(self, ServingEngine):
        self.ServingEngine = ServingEngine
        self.watched = []

    def engine(self, lm, name, **kw):
        eng = self.ServingEngine(lm, max_len=MAX_LEN, device=DEVICE,
                                 name=name, **dict(dict(slots=SLOTS), **kw))
        self.watch(eng)
        return eng

    def watch(self, eng):
        if eng._watchdog is None:
            raise CheckFailed(f"engine {eng.name!r} built no watchdog from "
                              f"BIGDL_WATCHDOG_S")
        self.watched.append((eng.name, eng._watchdog))

    def dumps(self) -> dict:
        return {n: wd.dumps for n, wd in self.watched if wd.dumps}


def warm_all_buckets(engine):
    """One request of each bucket's length, in turn: every prefill
    program, the assign and the tick are captured before the checks."""
    rng = np.random.default_rng(SEED + 41)
    for b in engine.buckets:
        n = min(b, MAX_LEN - 2)
        engine.submit(rng.integers(0, VOCAB, n).astype(np.int32),
                      2).result(timeout=600)


def wait_for(cond, what, bound=600.0):
    end = time.perf_counter() + bound
    while not cond():
        if time.perf_counter() > end:
            raise CheckFailed(f"phase 14: never reached {what}")
        time.sleep(0.001)


def same_programs(name, engine, progs, keys):
    st = engine.stats()
    now = engine._programs._programs
    if st["compiled_programs"] != keys or set(now) != set(progs) or any(
            now[k] is not progs[k] for k in progs):
        raise CheckFailed(f"{name}: the program ledger changed "
                          f"({keys} -> {st['compiled_programs']})")


def swapped_round(engine, prompts, first_id, swap):
    """Keep the grid full from a client thread (the prompts in turn, a new
    request as soon as fewer than SLOTS + SLOTS // 2 are outstanding) until
    ``swap()`` returns. Returns its result and the prompt index and result
    of every request sent."""
    sent, errors, stop = [], [], threading.Event()

    def client():
        try:
            i, outstanding = 0, []
            while not stop.is_set():
                outstanding = [h for h in outstanding if not h.done()]
                if len(outstanding) >= SLOTS + SLOTS // 2:
                    time.sleep(0.001)
                    continue
                sent.append((i % len(prompts), engine.submit(
                    prompts[i % len(prompts)], NEW_TOKENS,
                    request_id=first_id + i)))
                outstanding.append(sent[-1][1])
                i += 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=client)
    th.start()
    try:
        wait_for(lambda: engine.stats()["active_slots"] == SLOTS,
                 "a full grid")
        res = swap()
    finally:
        stop.set()
        th.join(120)
    if errors:
        raise CheckFailed(f"the swapped round's client: {errors}")
    return res, [(j, h.result(timeout=600)) for j, h in sent]


def done_before(in_flight: dict, results) -> set:
    """The ids of a swapped round's requests that finished before the swap.
    The engine admits in submission order, every request asks NEW_TOKENS,
    and a swap requeues every admitted request still running: so the
    requests admitted before it are the ids up to the last one in flight,
    and those of them not in flight had finished."""
    if not in_flight:
        raise CheckFailed("the swap found no request in flight")
    last = max(in_flight)
    return {r.request_id for _, r in results
            if r.request_id < last and r.request_id not in in_flight}


def check_split(name, lm_old, lm_new, prompts, results, in_flight, done,
                refs_old):
    """A swapped round (``results``: prompt index and result): each
    in-flight request's tokens before the swap are the old weights'
    (``refs_old``), the rest greedy on the new weights from that prefix; a
    request done before the swap is the old weights' throughout, one
    queued at the swap or sent after it the new weights'. Under the
    near-tie rule. Returns the count that parted at near ties."""
    fresh = {}
    old_got, old_ref, old_len, new_got, new_ref, new_len = ([] for _ in
                                                             range(6))
    for j, r in results:
        p, toks = prompts[j], np.asarray(r.tokens)
        if r.request_id in done:
            old_got.append(toks)
            old_ref.append(refs_old[j])
            old_len.append(len(p))
            continue
        k = in_flight.get(r.request_id, 0)
        if k:
            old_got.append(toks[:len(p) + k])
            old_ref.append(np.asarray(refs_old[j])[:len(p) + k])
            old_len.append(len(p))
            ref = forward_greedy(lm_new, toks[:len(p) + k], NEW_TOKENS - k)
        else:
            if j not in fresh:
                fresh[j] = forward_greedy(lm_new, p, NEW_TOKENS)
            ref = fresh[j]
        new_got.append(toks)
        new_ref.append(ref)
        new_len.append(len(p) + k)
    return (check_near_ties(lm_old, f"{name} (the old weights)", old_got,
                            old_ref, old_len)
            + check_near_ties(lm_new, f"{name} (the new weights)", new_got,
                              new_ref, new_len))


def crash_check(stack, lm, prompts, refs, card):
    """Check 1: 16 requests with ``serve_thread`` firing mid-decode, then
    the crash budget spent."""
    from bigdl_tpu_torch.obs import exporter
    from bigdl_tpu_torch.obs.registry import registry
    from bigdl_tpu_torch.utils import faults
    from bigdl_tpu_torch.utils.faults import WorkerDeathError
    eng = stack.engine(lm, "crash")
    warm_all_buckets(eng)
    serve_round(eng, prompts)               # the traffic's captures
    st0 = eng.stats()
    progs, keys = dict(eng._programs._programs), st0["compiled_programs"]
    obs0 = registry.snapshot()
    with faults.inject_faults(f"serve_thread@{STACK_CRASH_AT}") as plan:
        results, wall = serve_round(eng, prompts)
        if plan.unfired():
            raise CheckFailed(f"crash: the plan did not fire: "
                              f"{plan.unfired()}")
    st = eng.stats()
    with apart("references"):
        check_served_tokens(lm, None, prompts, results, refs)
    same_programs("crash", eng, progs, keys)
    if st["respawns"] != 1 or st["completed"] - st0["completed"] \
            != N_REQUESTS:
        raise CheckFailed(f"crash: respawns {st['respawns']}, completed "
                          f"{st['completed'] - st0['completed']}")
    # the engine's own readings: from the loop's death (stamped where the
    # fault raised) to the first token after it, and the requeued
    # requests' re-prefills
    death_ms = one_observation(obs0, "serving/resume_first_token_ms",
                               "crash")
    reprefill_ms = one_observation(obs0, "serving/reprefill_ms", "crash")
    out = {"respawns": st["respawns"], "compiled_programs": keys,
           "death_to_first_token_ms": death_ms,
           "reprefill_ms": reprefill_ms, "round_wall_s": wall,
           "replays_not_captures": True}
    log(f"  crash: serve_thread@{STACK_CRASH_AT} killed the loop mid-decode; "
        f"1 respawn, all {N_REQUESTS} requests equal their greedy "
        f"references, "
        f"{keys} programs before and after (the same graphs replayed); "
        f"from the loop's death to the first token after it "
        f"{death_ms:.2f} ms, the requeued requests' re-prefills "
        f"{reprefill_ms:.2f} ms, the round {wall:.2f} s [{card}]")
    # the rest of the budget (2 deaths after 1 respawn: 1 left)
    with faults.inject_faults("serve_thread@1;serve_thread@2") as plan:
        hs = [eng.submit(p, NEW_TOKENS) for p in prompts[:4]]
        aborted = 0
        for h in hs:
            try:
                h.result(timeout=600)
            except WorkerDeathError:
                aborted += 1
        if plan.unfired():
            raise CheckFailed(f"crash budget: unfired {plan.unfired()}")
    wait_for(lambda: eng.stats()["health"] == "dead", "a dead engine")
    for other in exporter.engines():     # earlier phases' engines
        if other is not eng:
            exporter.unregister_engine(other)
    code, payload = exporter.render_healthz()
    log(f"  crash budget spent: health {eng.stats()['health']}, "
        f"{aborted} of 4 handles failed with WorkerDeathError, /healthz "
        f"{code} {payload['status']!r}")
    if aborted != 4 or code != 503 or eng.stats()["respawns"] != 2:
        raise CheckFailed(f"crash budget: {aborted} aborted, /healthz "
                          f"{code}, respawns {eng.stats()['respawns']}")
    exporter.unregister_engine(eng)
    eng.shutdown()
    out.update(budget_aborted=aborted, healthz_code=code)
    return out


def swap_check(stack, lm, lm2, prompts, refs, card):
    """Check 2: v1 -> v2 under traffic; another engine over the module
    keeps v1; ``promote_swap`` leaves v1 serving."""
    from bigdl_tpu_torch.obs.registry import registry
    from bigdl_tpu_torch.utils import faults
    from bigdl_tpu_torch.utils.faults import FaultError
    laps, t0 = {}, time.perf_counter()
    tree2 = lm_tree(lm2)
    eng, other = stack.engine(lm, "swap"), stack.engine(lm, "keep")
    try:
        warm_all_buckets(eng)
        serve_round(eng, prompts)
        serve_round(other, prompts)
        laps["warm_s"] = time.perf_counter() - t0
        progs = dict(eng._programs._programs)
        keys = eng.stats()["compiled_programs"]

        def swap():
            t0 = time.perf_counter()
            out = eng.swap_weights(tree2, version=2)
            calls.append(time.perf_counter() - t0)
            return out

        calls = []
        obs0 = registry.snapshot()
        t0 = time.perf_counter()
        res, results = swapped_round(eng, prompts, 1000, swap)
        laps["round_s"] = time.perf_counter() - t0
        # the engine's own readings of the re-prefills and of the first
        # token after the swap began
        reprefill = one_observation(obs0, "serving/reprefill_ms", "swap")
        first = one_observation(obs0, "serving/resume_first_token_ms",
                                "swap")
        same_programs("swap", eng, progs, keys)
        t0 = time.perf_counter()
        with apart("references"):
            parted = check_split("swap", lm, lm2, prompts, results,
                                 res.in_flight,
                                 done_before(res.in_flight, results), refs)
        laps["references_s"] = time.perf_counter() - t0
        kept = [h.result(timeout=600) for h in
                [other.submit(p, NEW_TOKENS) for p in prompts[:SLOTS]]]
        with apart("references"):
            check_near_ties(lm, "the other engine (v1)",
                            [r.tokens for r in kept], refs[:SLOTS],
                            [len(p) for p in prompts[:SLOTS]])
        with faults.inject_faults("promote_swap@1") as plan:
            try:
                other.swap_weights(tree2, version=3)
                raise CheckFailed("promote_swap did not fail the swap")
            except FaultError:
                pass
            if plan.unfired():
                raise CheckFailed("promote_swap never fired")
        after = [h.result(timeout=600) for h in
                 [other.submit(p, NEW_TOKENS) for p in prompts[:2]]]
        if other.model_version != 0 or any(
                not np.array_equal(a.tokens, k.tokens)
                for a, k in zip(after, kept)):
            raise CheckFailed("a failed swap changed the served weights")
    finally:
        eng.shutdown()
        other.shutdown()
    if eng.stats()["model_version"] != 2 or not res.requeued:
        raise CheckFailed(f"swap: version {eng.stats()['model_version']}, "
                          f"{res.requeued} re-prefilled")
    out = {"pause_ms": res.duration_s * 1e3, "swap_call_ms": calls[0] * 1e3,
           "reprefill_ms": reprefill, "first_token_ms": first,
           "requeued": res.requeued,
           "requests": len(results), "near_ties_parted": parted,
           "compiled_programs": keys, "laps": laps}
    log(f"  swap v1 -> v2 under traffic: the engine paused "
        f"{out['pause_ms']:.2f} ms (swap_weights returned in "
        f"{out['swap_call_ms']:.2f} ms), {res.requeued} in-flight requests "
        f"re-prefilled in {reprefill:.2f} ms, the first token "
        f"{first:.2f} ms after the swap began; tokens before the "
        f"swap v1's, after it greedy on v2 from that prefix ({parted} "
        f"parted at near ties); the other engine over the same module still "
        f"serves v1; promote_swap left v1 serving; {keys} programs before "
        f"and after [{card}]")
    return out


def drain_check(eng, lm, prompts, refs, card):
    """Check 3, on a warm engine, which it ends: SIGTERM through
    ``install_signal_drain`` with 8 requests in flight and 4 queued (a
    backlog under the slot count: health stays ready until the
    signal)."""
    import signal
    from bigdl_tpu_torch.serving import EngineShutdown
    n = SLOTS + SLOTS // 2
    original = signal.getsignal(signal.SIGTERM)
    chained = []
    signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    try:
        eng.install_signal_drain()
        handles = [eng.submit(p, NEW_TOKENS) for p in prompts[:n]]
        # the health update follows the iteration's admissions
        wait_for(lambda: eng.stats()["active_slots"] == SLOTS
                 and eng.stats()["health"] == "ready", "a full grid")
        health = [eng.stats()["health"]]
        t0 = time.perf_counter()
        os.kill(os.getpid(), signal.SIGTERM)
        wait_for(lambda: chained, "the chained handler")
        health.append(eng.stats()["health"])
        eng._thread.join(600)
        drain_s = time.perf_counter() - t0
        health.append(eng.stats()["health"])
    finally:
        signal.signal(signal.SIGTERM, original)
    finished, refused = [], 0
    for h in handles:
        try:
            finished.append(h.result(timeout=60))
        except EngineShutdown:
            refused += 1
    with apart("references"):
        check_near_ties(lm, "drained", [r.tokens for r in finished],
                        refs[:len(finished)],
                        [len(p) for p in prompts[:len(finished)]])
    log(f"  drain: SIGTERM with {SLOTS} in flight and {n - SLOTS} queued: "
        f"{len(finished)} finished ({NEW_TOKENS} tokens each, their greedy "
        f"references), {refused} refused with EngineShutdown, health "
        f"{' -> '.join(health)}, the previous handler called; drained in "
        f"{drain_s * 1e3:.1f} ms [{card}]")
    if health != ["ready", "draining", "dead"] or len(finished) != SLOTS \
            or refused != n - SLOTS or chained != [signal.SIGTERM] \
            or any(r.n_generated != NEW_TOKENS for r in finished):
        raise CheckFailed(f"drain: health {health}, {len(finished)} "
                          f"finished, {refused} refused")
    return {"drain_ms": drain_s * 1e3, "finished": len(finished),
            "refused": refused, "health": health}


def watchdog_check(eng, prompts, card):
    """Check 4, on a warm engine (5+ ticks timed): ``serve_stall`` holds a
    tick for STACK_STALL_S seconds: exactly one dump, naming the engine's
    loop thread."""
    from bigdl_tpu_torch.utils import faults
    texts = []
    eng._watchdog.sink = texts.append
    before = os.environ.get("BIGDL_FAULT_STALL_S")
    os.environ["BIGDL_FAULT_STALL_S"] = str(STACK_STALL_S)
    try:
        with faults.inject_faults("serve_stall@10") as plan:
            serve_round(eng, prompts)
            if plan.unfired():
                raise CheckFailed("serve_stall never fired")
    finally:
        if before is None:
            os.environ.pop("BIGDL_FAULT_STALL_S")
        else:
            os.environ["BIGDL_FAULT_STALL_S"] = before
    limit = eng._watchdog.limit()
    loop = f"bigdl-serve-{eng.name}-loop"
    log(f"  watchdog: a {STACK_STALL_S:.1f} s serve_stall tripped "
        f"{eng._watchdog.dumps} dump(s) (limit {limit:.3f} s: 10 x the "
        f"median tick, floored at 0.25 s), naming {loop}: "
        f"{bool(texts) and loop in texts[0]}")
    if eng._watchdog.dumps != 1 or len(texts) != 1 or loop not in texts[0]:
        raise CheckFailed(f"watchdog: {eng._watchdog.dumps} dumps, "
                          f"{len(texts)} texts")
    return {"dumps": 1, "limit_s": limit, "stall_s": STACK_STALL_S}


def fleet_check(stack, lm, prompts, refs, engine_round, card):
    """Check 5: a prefill replica and a decode replica on the one card;
    then ``replica_down`` mid-traffic; /healthz shows the fleet
    degraded."""
    from bigdl_tpu_torch.obs import exporter
    from bigdl_tpu_torch.obs.registry import registry
    from bigdl_tpu_torch.serving import FleetRouter
    from bigdl_tpu_torch.serving.prefix_cache import _states_nbytes
    from bigdl_tpu_torch.utils import faults
    fleet = FleetRouter.replicate(lm, MAX_LEN, replicas=2,
                                  phases="prefill,decode", prefix_pool=16,
                                  device=DEVICE, slots=SLOTS)
    for eng in fleet.replicas.values():
        stack.watch(eng)
    try:
        # the captures, one request at a time (no two threads capture at
        # once), then the timed round
        for p in prompts:
            fleet.submit(p, NEW_TOKENS).result(timeout=600)
        # the prefill tier serves end to end after the decode tier dies
        # below: its tick and assign are captured now, alone
        fleet.engine("fleet-r0").submit(prompts[0], 2).result(timeout=600)

        class TimedFleet:
            """The fleet as ``serve_round``'s engine, each submit timed."""
            calls = {}

            def submit(self, p, n, request_id=None):
                t = time.perf_counter()
                h = fleet.submit(p, n, request_id=request_id)
                self.calls[request_id] = time.perf_counter() - t
                return h

        timed_fleet = TimedFleet()
        obs0 = registry.snapshot()     # the fleet's handoff_ms from here
        for _ in range(2):
            before = fleet.engine("fleet-r1").stats()
            results, wall = serve_round(timed_fleet, prompts)
        after = fleet.engine("fleet-r1").stats()
        calls = [timed_fleet.calls[i] for i in range(N_REQUESTS)]
        n_hand, hand_total = hist_delta(obs0, "serving/handoff_ms")
        with apart("references"):
            check_served_tokens(lm, None, prompts, results, refs)
        # a request's TTFT from its fleet submit: the call (the handoff,
        # then the decode engine's submit, its last step) and the decode
        # engine's TTFT from that submit
        ttft = np.array([c + r.ttft_s for c, r in zip(calls, results)]) \
            * 1e3
        ticks = after["decode_ticks"] - before["decode_ticks"]
        tick_s = after["decode_seconds"] - before["decode_seconds"]
        warm = {"wall_s": wall, "ticks": ticks,
                "decode_tokens_per_s": (after["decode_tokens"]
                                        - before["decode_tokens"]) / tick_s,
                "tick_ms": tick_s / ticks * 1e3,
                "ttft_p50_ms": float(np.percentile(ttft, 50)),
                "ttft_p99_ms": float(np.percentile(ttft, 99)),
                "engine_ttft_p50_ms": float(np.percentile(
                    [r.ttft_s * 1e3 for r in results], 50))}
        st = fleet.stats()
        if st["handoff_failures"] or st["handoffs"] != 3 * N_REQUESTS \
                or n_hand != 2 * N_REQUESTS \
                or st["replicas"]["fleet-r1"]["prefills"] != 0:
            raise CheckFailed(f"fleet: {st['handoffs']} handoffs "
                              f"({n_hand} timed), "
                              f"{st['handoff_failures']} failed, decode "
                              f"prefills {st['replicas']['fleet-r1']['prefills']}")
        tok, states = fleet.engine("fleet-r0").prefill_export(prompts[0])
        nbytes = _states_nbytes(states)
        del states
        log(f"  fleet: {N_REQUESTS} requests equal their greedy references; "
            f"decode {warm['decode_tokens_per_s']:.1f} tokens/s against one "
            f"engine's {engine_round['decode_tokens_per_s']:.1f} (tick "
            f"{warm['tick_ms']:.3f} against {engine_round['tick_ms']:.3f} "
            f"ms); TTFT from the fleet submit p50 {warm['ttft_p50_ms']:.1f} /"
            f" p99 {warm['ttft_p99_ms']:.1f} ms (from the decode engine's "
            f"submit p50 {warm['engine_ttft_p50_ms']:.1f}) against "
            f"{engine_round['ttft_p50_ms']:.1f} / "
            f"{engine_round['ttft_p99_ms']:.1f}; a handoff (export and "
            f"seed) "
            f"{hand_total / n_hand:.2f} ms mean over {n_hand}, "
            f"{nbytes / 2 ** 20:.2f} MiB for a {len(prompts[0])}-token "
            f"prompt (both tiers share the card: this is the handoff's "
            f"cost, not disaggregation's gain) [{card}]")
        # replica_down: the decode replica is killed at a dispatch
        with faults.inject_faults("replica_down@3") as plan:
            handles = [fleet.submit(p, NEW_TOKENS) for p in prompts]
            downed = [h.result(timeout=600) for h in handles]
            if plan.unfired():
                raise CheckFailed("replica_down never fired")
        wait_for(lambda: fleet.stats()["healthy_replicas"] == 1,
                 "one healthy replica")
        with apart("references"):
            check_served_tokens(lm, None, prompts, downed, refs)
        mine = set(fleet.replicas.values())
        for other in exporter.engines():
            if other not in mine:
                exporter.unregister_engine(other)
        code, payload = exporter.render_healthz()
        fb = payload["fleets"][fleet.name]
        log(f"  replica_down: {fleet.stats()['replica_downs']} replica "
            f"killed mid-traffic, all {N_REQUESTS} requests completed "
            f"(their greedy references), {fleet.stats()['retries']} "
            f"retries; "
            f"/healthz {code} {payload['status']!r}, replicas "
            f"{fb['replicas']}")
        if code != 200 or payload["status"] != "degraded" \
                or fb["healthy_replicas"] != 1:
            raise CheckFailed(f"fleet /healthz {code} {payload['status']}")
        out = dict(warm, handoff_ms=hand_total / n_hand,
                   handoff_bytes=nbytes, handoffs=st["handoffs"],
                   replica_downs=fleet.stats()["replica_downs"],
                   retries=fleet.stats()["retries"], healthz=code)
    finally:
        fleet.shutdown()
        exporter.unregister_fleet(fleet)
        for eng in fleet.replicas.values():
            exporter.unregister_engine(eng)
    return out


def stack_data():
    """The lifecycle's training data and its first STACK_EVAL_BATCHES
    batches (phase 6's synthetic corpus)."""
    from bigdl_tpu_torch.dataset import (
        DataSet, Sample, SampleToMiniBatch, ptb_windows, synthetic_ptb,
    )
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    RandomGenerator.set_seed(SEED)
    ids = synthetic_ptb(TRAIN_BATCH * STACK_STEPS * TRAIN_LEN + 1,
                        vocab_size=VOCAB)
    xs, ys = ptb_windows(ids, TRAIN_LEN)
    pairs = list(zip(xs, ys))

    def ds(rows):
        return (DataSet.array(Sample(x, y) for x, y in rows)
                >> SampleToMiniBatch(TRAIN_BATCH))

    return ds(pairs), ds(pairs[:TRAIN_BATCH * STACK_EVAL_BATCHES])


def lifecycle_check(stack, TransformerLM, lm_criterion, lm, prompts, refs,
                    card):
    """Check 6: train STACK_STEPS steps publishing to a registry; gate
    (the port's Evaluator) rejects a NaN version and promotes the best
    trained one under traffic; a gate-bypassed bad version is rolled back
    by the watch window."""
    from bigdl_tpu_torch.obs.slo import SLOMonitor
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.optim.validation import Loss
    from bigdl_tpu_torch.serving import (
        PromotionController, PromotionCriterion,
    )
    from bigdl_tpu_torch.utils import faults
    from bigdl_tpu_torch.utils.model_registry import ModelRegistry
    laps = {}
    reg = ModelRegistry(str(stack_dir("registry")), keep=8)
    train, evald = stack_data()
    model = TransformerLM(VOCAB, EMBED, HEADS, LAYERS, MAX_LEN,
                          attention_impl="auto",
                          generator=torch.Generator().manual_seed(SEED),
                          device=DEVICE)      # the served LM's weights
    opt = (LocalOptimizer(model, train, lm_criterion(), device=DEVICE)
           .set_optim_method(SGD(learningrate=0.01, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(STACK_STEPS))
           .set_checkpoint(str(stack_dir("ckpt")),
                           Trigger.several_iteration(STACK_EVERY))
           .set_model_registry(reg))
    sync()
    t0 = time.perf_counter()
    with apart("trainer"):
        opt.optimize()
        opt._join_checkpoint_writer()
    train_s = time.perf_counter() - t0
    trained = reg.versions()
    del opt, model
    release()
    if trained != [STACK_EVERY, STACK_STEPS]:
        raise CheckFailed(f"the trainer published {trained}")
    from bigdl_tpu_torch import convert
    v_nan = reg.publish(convert.map_tree(
        lambda a: np.full_like(a, np.nan), reg.resolve_params(trained[-1])),
        meta={"source": "poisoned"})
    eval_lm = build_lm(TransformerLM, "auto", DEVICE)
    live = stack.engine(lm, "live")
    serve_round(live, prompts)
    ctrl = PromotionController(
        reg, engine=live, eval_model=eval_lm, eval_dataset=evald,
        eval_methods=[Loss(lm_criterion())],
        criterion=PromotionCriterion(mode="min", no_regression=True),
        slo_monitor=SLOMonitor(), probe_prompts=[prompts[0]],
        watch_window_s=5.0, poll_s=0.05, rollback_budget=3)
    try:
        t0 = time.perf_counter()
        gates, gate_launches = {}, {}
        for v in trained + [v_nan]:
            with apart("evaluator") as gate_launches[v]:
                gates[v] = ctrl.gate(v)
        laps["gates_s"] = time.perf_counter() - t0
        if gates[v_nan][0] or "non-finite" not in gates[v_nan][2] \
                or reg.status(v_nan)["status"] != "rejected":
            raise CheckFailed(f"the NaN version passed the gate: "
                              f"{gates[v_nan]}")
        best = min(trained, key=lambda v: gates[v][1])
        # promote under traffic: a client keeps the grid full throughout
        t0 = time.perf_counter()
        res, results = swapped_round(
            live, prompts, 1000, lambda: ctrl.promote(best, watch=False))
        # the promotion gated v{best} again, its evaluator beside the
        # engine's traffic: the launches of the same gate run alone above
        # (the same model, batches and code)
        count_apart("evaluator", gate_launches[best])
        if not res.promoted or live.model_version != best \
                or not res.swap.requeued:
            raise CheckFailed(f"promotion of v{best}: {res}")
        best_lm = build_lm(TransformerLM, "auto", DEVICE)
        convert.load_jax_params(best_lm, reg.resolve_params(best))
        laps["promote_round_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with apart("references"):
            parted = check_split("promotion", lm, best_lm, prompts, results,
                                 res.swap.in_flight,
                                 done_before(res.swap.in_flight, results),
                                 refs)
        laps["references_s"] = time.perf_counter() - t0
        probe = live.submit(prompts[0], NEW_TOKENS).result(timeout=600)
        # the drill: a bad version (the best plus noise) with the gate
        # bypassed; the SLO check breaches in the window's first round, the
        # first rollback attempt is spent by promote_rollback
        g = torch.Generator(device="cpu").manual_seed(STACK_SEED + 1)
        bad = {n: p.detach().cpu() + 0.5 * torch.randn(
            p.shape, generator=g) for n, p in best_lm.named_parameters()}
        v_bad = reg.publish(convert.nest(best_lm, bad),
                            meta={"source": "drill"})
        with faults.inject_faults("slo_breach@1;promote_rollback@1") as plan:
            t0 = time.perf_counter()
            drill = ctrl.promote(v_bad, gate=False)
            laps["drill_s"] = time.perf_counter() - t0
            if plan.unfired():
                raise CheckFailed(f"the drill's plan: {plan.unfired()}")
        back = live.submit(prompts[0], NEW_TOKENS).result(timeout=600)
        with apart("references"):
            want = forward_greedy(best_lm, prompts[0], NEW_TOKENS)
    finally:
        live.shutdown()
    bitwise = np.array_equal(back.tokens, probe.tokens)
    log(f"  lifecycle: {STACK_STEPS} fp32 steps in {train_s:.1f} s "
        f"published v{trained}; gate (Loss on {STACK_EVAL_BATCHES} batches "
        f"of the training data): "
        + ", ".join(f"v{v} {gates[v][1]:.4f}" for v in trained)
        + f", v{v_nan} (NaN) rejected; v{best} promoted under traffic "
        f"({res.swap.requeued} re-prefilled, {parted} parted at near "
        f"ties); the drill's v{v_bad} rolled back after "
        f"{ctrl.rollbacks} attempt(s): served tokens bitwise v{best}'s: "
        f"{bitwise} [{card}]")
    if not drill.rolled_back or live.model_version != best or not bitwise \
            or reg.status(v_bad)["status"] != "rolled_back" \
            or ctrl.rollbacks != 2:
        raise CheckFailed(f"the drill: {drill}, serving "
                          f"v{live.model_version}, rollbacks "
                          f"{ctrl.rollbacks}, bitwise {bitwise}")
    with apart("references"):
        check_near_ties(best_lm, "promoted probe", [probe.tokens], [want],
                        [len(prompts[0])])
    del eval_lm, best_lm
    release()
    return {"train_s": train_s, "laps": laps, "requests": len(results),
            "published": trained,
            "gate": {str(v): gates[v][1] for v in trained},
            "rejected_nan": v_nan, "promoted": best,
            "requeued": res.swap.requeued, "rolled_back": v_bad,
            "rollback_attempts": ctrl.rollbacks}


def tenants_check(stack, lm, lm2, prompts, refs, card):
    """Check 7: two native tenants, ``update_tenant`` on one; the endpoint
    scraped once."""
    import json as _json
    import urllib.request
    from bigdl_tpu_torch.obs import exporter
    from bigdl_tpu_torch.serving import SnapshotServer
    srv = SnapshotServer({"tenant-a": lm, "tenant-b": lm}, max_len=MAX_LEN,
                         slots=SLOTS, device=DEVICE)
    for name in srv.snapshots:
        stack.watch(srv.engine(name))
    ep = exporter.MetricsExporter(0, host="127.0.0.1").start()
    try:
        for name in srv.snapshots:
            for p in prompts[:2]:
                srv.submit(name, p, NEW_TOKENS).result(timeout=600)
        srv.update_tenant("tenant-a", lm_tree(lm2), version=2)
        a = [srv.submit("tenant-a", p, NEW_TOKENS).result(timeout=600)
             for p in prompts[:2]]
        b = [srv.submit("tenant-b", p, NEW_TOKENS).result(timeout=600)
             for p in prompts[:2]]
        # the server is on this host: no proxy
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(ep.url + "/metrics", timeout=60) as r:
            metrics = exporter.parse_metrics(r.read().decode())
        with opener.open(ep.url + "/statusz", timeout=60) as r:
            statusz = _json.loads(r.read().decode())
    finally:
        ep.stop()
        srv.shutdown()
        for name in srv.snapshots:
            exporter.unregister_engine(srv.engine(name))
    with apart("references"):
        refs2 = [forward_greedy(lm2, p, NEW_TOKENS) for p in prompts[:2]]
        check_near_ties(lm2, "tenant-a (v2)", [r.tokens for r in a], refs2,
                        [len(p) for p in prompts[:2]])
        check_near_ties(lm, "tenant-b (v1)", [r.tokens for r in b],
                        refs[:2], [len(p) for p in prompts[:2]])
    rows = {t: metrics.get(f'bigdl_serving_tenant_model_version'
                           f'{{tenant="{t}"}}') for t in srv.snapshots}
    log(f"  tenants: update_tenant('tenant-a', v2) served v2's tokens, "
        f"tenant-b kept v1's; /metrics parsed {len(metrics)} series, "
        f"model_version rows {rows}; /statusz JSON with "
        f"{len(statusz['engines'])} engine ledgers [{card}]")
    if rows != {"tenant-a": 2.0, "tenant-b": 0.0} or not all(
            t in statusz["engines"] for t in srv.snapshots):
        raise CheckFailed(f"the endpoint: rows {rows}")
    return {"metrics_series": len(metrics), "model_version_rows": rows}


def serving_stack(TransformerLM, lm_criterion, card, prompts=None,
                  refs=None):
    """Phase 14 (its launches are counted from a reset by the caller, the
    references' apart: ``stack_launches``): crash recovery, hot swaps,
    drain, the watchdog, the fleet, the lifecycle and the snapshot server
    on phase 5's served LM."""
    from bigdl_tpu_torch.serving import ServingEngine
    t0 = time.perf_counter()
    _APART.clear()
    env = os.environ.get("BIGDL_WATCHDOG_S")
    os.environ["BIGDL_WATCHDOG_S"] = str(STACK_WATCHDOG_S)
    stack = Stack(ServingEngine)
    try:
        lm = build_lm(TransformerLM, "auto", DEVICE)
        lm2 = TransformerLM(VOCAB, EMBED, HEADS, LAYERS, MAX_LEN,
                            generator=torch.Generator().manual_seed(
                                STACK_SEED), device=DEVICE).evaluate()
        if prompts is None:
            prompts = serving_prompts()
        if refs is None:
            with apart("references"):
                refs = [forward_greedy(lm, p, NEW_TOKENS) for p in prompts]
        out = {}

        def timed(name, fn, *args):
            t = time.perf_counter()
            out[name] = fn(*args)
            out[name]["wall_s"] = time.perf_counter() - t
            release()

        timed("crash", crash_check, stack, lm, prompts, refs, card)
        timed("swap", swap_check, stack, lm, lm2, prompts, refs, card)
        # one engine: its rates (the fleet's yardstick), the watchdog's
        # stall, then the drain that ends it
        one = stack.engine(lm, "serve")
        try:
            serve_round(one, prompts)
            before = one.stats()
            results, wall = serve_round(one, prompts)
            out["one_engine"] = report_round(
                "one engine, second round", results, wall, one.stats(),
                before, card)
            timed("watchdog", watchdog_check, one, prompts, card)
            timed("drain", drain_check, one, lm, prompts, refs, card)
        finally:
            one.shutdown()
        timed("fleet", fleet_check, stack, lm, prompts, refs,
              out["one_engine"], card)
        timed("lifecycle", lifecycle_check, stack, TransformerLM,
              lm_criterion, lm, prompts, refs, card)
        timed("tenants", tenants_check, stack, lm, lm2, prompts, refs, card)
    finally:
        if env is None:
            os.environ.pop("BIGDL_WATCHDOG_S", None)
        else:
            os.environ["BIGDL_WATCHDOG_S"] = env
    dumps = stack.dumps()
    log(f"  watchdog dumps over the phase's {len(stack.watched)} engines: "
        f"{dumps} (the stall check's only)")
    if dumps != {"serve": 1}:
        raise CheckFailed(f"watchdog dumps elsewhere in phase 14: {dumps}")
    del lm, lm2
    release()
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 14 took {out['wall_s']:.1f} s [{card}]")
    return out


# -------------------------------------------------------------------- main
# ---------------------------------------------------------------- phase 15
def tree_bytes(tree) -> int:
    """Bytes of every tensor in nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def clone_batch(x):
    return tuple(clone_batch(a) for a in x) if isinstance(x, (tuple, list)) \
        else x.clone()


def adapt(nn, lm, seed, trained_b=True):
    """``apply_lora`` at LORA_RANK (alpha = rank) with ``A`` drawn from
    ``seed``; with ``trained_b`` every ``B`` is drawn N(0, 0.02) too (an
    adapter with signal in every path; ``B = 0`` is the identity). Returns
    the count of adapted modules."""
    n = nn.apply_lora(lm, rank=LORA_RANK,
                      generator=torch.Generator().manual_seed(seed))
    if trained_b:
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for name, p in lm.named_parameters():
                if "lora" in name and name.endswith("_b"):
                    p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return n


def build_lora_lm(TransformerLM, nn, attention_impl, device):
    """Phase 6's training LM adapted at LORA_RANK."""
    lm = build_train_lm(TransformerLM, attention_impl, device)
    adapt(nn, lm, SEED + 50)
    return lm


def check_lora_step(TransformerLM, lm_criterion, nn):
    """One (2, 512) LoRA step on the card against the same weights on the
    CPU (plain LayerNorm, ``attention_impl="full"``), through the
    trainer's loss-and-gradient path: the base is frozen (its gradient
    scale 0), so only the adapters get a gradient. Tolerances: loss
    relative 1e-4, every adapter's gradient relative (Frobenius) 1e-3."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer

    rng = np.random.default_rng(SEED + 4)
    ids = torch.from_numpy(rng.integers(0, VOCAB, (2, TRAIN_LEN + 1)))
    x, y = ids[:, :-1], ids[:, 1:]
    runs = []
    for device, impl in ((DEVICE, "auto"), ("cpu", "full")):
        lm = build_lora_lm(TransformerLM, nn, impl, device)
        opt = LocalOptimizer(lm, DataSet.array([]), lm_criterion(),
                             device=device)
        named, scales, _ = opt._prepare_step()
        frozen = frozenset(n for n in named if scales[n] == 0.0)
        train = [n for n in named if n not in frozen]
        if not train or any("lora" not in n for n in train) or any(
                "lora" in n for n in frozen):
            raise CheckFailed(f"LoRA: trainable {train}")
        loss, grads = opt._loss_and_grads([named[n] for n in train],
                                          x.to(device), y.to(device), frozen)
        if any(p.grad is not None for p in named.values()):
            raise CheckFailed("LoRA: a parameter holds a gradient")
        runs.append((loss.item(), {n: g.detach().cpu()
                                   for n, g in zip(train, grads)},
                     len(named), len(frozen)))
        del lm, opt, loss, grads
    (loss, grads, n_all, n_frozen), (loss_ref, grads_ref, _, _) = runs
    rel_loss = abs(loss - loss_ref) / abs(loss_ref)
    rel = rel_errors(grads, grads_ref)
    worst = max(rel, key=rel.get)
    log(f"  one (2, {TRAIN_LEN}) LoRA step (rank {LORA_RANK}): loss "
        f"{loss:.6f} vs CPU plain {loss_ref:.6f} (relative {rel_loss:.2e}, "
        f"limit 1e-4); gradients of {len(rel)} adapters, worst relative "
        f"error {rel[worst]:.2e} ({worst}, limit 1e-3); {n_frozen} of "
        f"{n_all} parameters frozen, none with a gradient")
    if rel_loss > 1e-4 or rel[worst] > 1e-3:
        raise CheckFailed(f"the LoRA step disagrees with the CPU plain "
                          f"model: loss {rel_loss:.3e}, {worst} "
                          f"{rel[worst]:.3e}")
    return {"rel_loss": rel_loss, "worst_grad_rel": rel[worst],
            "adapters": len(rel), "frozen": n_frozen}


def recorded_run(build, crit, method, data, iters, kernels, card, what,
                 tokens, profile=False):
    """``iters`` steps of ``LocalOptimizer`` (the step a captured program,
    replayed after the first), then the same steps run eagerly on a fresh
    model from ``build()`` (the step function called on each recorded
    batch): the losses and parameters must be bitwise equal and the
    launches the same. Returns the trained model, its optimizer and the
    run's numbers (step ms: the median between consecutive step ends after
    the first)."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer, Trigger
    from bigdl_tpu_torch.optim.optim_method import hyper_tensor

    model = build()
    opt = (LocalOptimizer(model, data, crit, device=DEVICE)
           .set_optim_method(method())
           .set_end_when(Trigger.max_iteration(iters)))
    losses, marks, seen = [], [], []
    run_steps = opt._run_steps

    def recorded(steps):
        out = run_steps(steps)
        marks.append(time.perf_counter())
        losses.extend(out)
        seen.extend((clone_batch(a), clone_batch(b)) for a, b in steps)
        return out

    opt._run_steps = recorded
    torch.cuda.synchronize()
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        variants = kernels.launch_counts_by_variant()
        by_dtype = kernels.launch_counts_by_dtype()
    finally:
        opt._run_steps = run_steps
    if len(losses) != iters or not all(np.isfinite(losses)):
        raise CheckFailed(f"{what}: losses {losses}")
    ref = build()
    ref_opt = LocalOptimizer(ref, DataSet.array([]), crit, device=DEVICE) \
        .set_optim_method(method())
    named, scales, mask = ref_opt._prepare_step()
    step = ref_opt._make_step_fn(named, scales, mask)
    kernels.reset_launch_counts()
    ref_losses = [float(step(inp, target, hyper_tensor(
        ref_opt._method.hyper(k, ref_opt._ostate), list(named.values()))))
        for k, (inp, target) in enumerate(seen)]
    torch.cuda.synchronize()
    ref_counts = kernels.launch_counts()
    params = dict(model.named_parameters())
    bitwise = losses == ref_losses and all(
        torch.equal(params[n], p) for n, p in named.items())
    step_ms = float(statistics.median(np.diff(marks))) * 1e3
    log(f"  {iters} {what}: losses {[round(v, 4) for v in losses]}; first "
        f"step (warm-up and capture) {(marks[0] - t0) * 1e3:.1f} ms, step "
        f"{step_ms:.2f} ms, {tokens / step_ms * 1e3:.0f} tokens/s; replayed "
        f"against eager: bitwise {bitwise}; launches {by_dtype}, flash by "
        f"variant { {k: variants[k] for k in FLASH_NAMES} } [{card}]")
    if not bitwise:
        raise CheckFailed(f"{what}: the replayed steps are not bitwise "
                          f"equal to the eager ones")
    if counts != ref_counts:
        raise CheckFailed(f"{what}: replayed launches {counts} against "
                          f"eager {ref_counts}")
    prof = None
    if profile:
        prof = profile_step(opt, next(iter(data.data(train=True))), card)
    del ref, ref_opt, named, step, seen
    return model, opt, {
        "losses": losses, "step_ms": step_ms,
        "tokens_per_s": tokens / step_ms * 1e3,
        "first_step_ms": (marks[0] - t0) * 1e3, "launches": counts,
        "launches_by_variant": {k: variants[k] for k in FLASH_NAMES},
        "launches_by_dtype": by_dtype, "bitwise_vs_eager": bitwise,
        "profile": prof}


def lora_training(TransformerLM, lm_criterion, nn, kernels, card, Engine,
                  full):
    """The LoRA fine-tune at phase 6's configuration: the one-step check,
    then TRAIN_ITERS steps fp32 and bf16, each bitwise equal to eager
    steps, with the step time, the trainable parameters, the optimizer's
    slot bytes and a profiled step's GEMMs beside the full fine-tune's
    (``full``: phase 6's runs, fp32 and bf16)."""
    from bigdl_tpu_torch.optim import SGD

    def method():
        return SGD(learningrate=0.01, momentum=0.9, dampening=0.0)

    check = check_lora_step(TransformerLM, lm_criterion, nn)
    tokens = TRAIN_BATCH * TRAIN_LEN
    out = {"one_step_check": check}
    launches = {}
    for bf16 in (False, True):
        key = "bf16" if bf16 else "fp32"
        if bf16:
            Engine.init(compute_dtype=torch.bfloat16)
        try:
            model, opt, run = recorded_run(
                lambda: build_lora_lm(TransformerLM, nn, "auto", DEVICE),
                lm_criterion(), method, lm_data(), TRAIN_ITERS, kernels,
                card, f"LoRA steps ({key}) at ({TRAIN_BATCH}, {TRAIN_LEN})",
                tokens, profile=True)
        finally:
            if bf16:
                Engine.reset()
        idle = [k for k, n in run["launches"].items()
                if n == 0 and k not in NMS_KERNELS]
        if idle:
            raise CheckFailed(f"the LoRA path ({key}) never launched {idle}")
        for k, n in run["launches"].items():
            launches[k] = launches.get(k, 0) + n
        trainable = sum(p.numel() for n, p in model.named_parameters()
                        if "lora" in n)
        total = sum(p.numel() for p in model.parameters())
        slot_bytes = tree_bytes(opt._ostate)
        # the full fine-tune of the same model: one momentum slot a weight
        base_params = total - trainable
        full_slot_bytes = base_params * 4
        fr = full[key]
        gemm = (run["profile"] or {}).get("kernels_by_kind", {}).get("gemm")
        full_gemm = ((fr.get("profile") or {}).get("kernels_by_kind", {})
                     .get("gemm"))
        gemm_ms = (run["profile"] or {}).get("by_kind_ms", {}).get("gemm")
        full_gemm_ms = ((fr.get("profile") or {}).get("by_kind_ms", {})
                        .get("gemm"))
        log(f"  LoRA {key}: step {run['step_ms']:.2f} ms "
            f"({run['tokens_per_s']:.0f} tokens/s) against the full "
            f"fine-tune's {fr['step_ms']:.2f} ms ({fr['tokens_per_s']:.0f} "
            f"tokens/s); trainable parameters {trainable} of {total} "
            f"(full fine-tune {base_params}); optimizer slots {slot_bytes} "
            f"bytes (full fine-tune {full_slot_bytes}); GEMM kernels in a "
            f"profiled step {gemm} ({gemm_ms} ms) against {full_gemm} "
            f"({full_gemm_ms} ms) [{card}]")
        out[key] = dict({k: run[k] for k in (
            "step_ms", "tokens_per_s", "first_step_ms", "launches",
            "launches_by_dtype", "bitwise_vs_eager")},
            losses=run["losses"], trainable_params=trainable,
            total_params=total, slot_bytes=slot_bytes,
            full_step_ms=fr["step_ms"], full_tokens_per_s=fr["tokens_per_s"],
            full_trainable_params=base_params,
            full_slot_bytes=full_slot_bytes, gemm_kernels=gemm,
            gemm_ms=gemm_ms, full_gemm_kernels=full_gemm,
            full_gemm_ms=full_gemm_ms,
            busy_ms=(run["profile"] or {}).get("busy_ms"),
            wall_ms=(run["profile"] or {}).get("wall_ms"))
        del model, opt
        release()
    return out, launches


def lora_serving(TransformerLM, lm_criterion, nn, kernels, card,
                 ServingEngine, prompts, refs, plain_rate):
    """The adapted served LM: ``TransformerLM(32000, 512, 8, 6, 1024)`` (phase
    5's weights) with fresh adapters (``B = 0``) published as the base, then
    fine-tuned LORA_TUNE_STEPS steps (Adam 1e-3) and its adapters published
    with ``publish_lora``. An engine serves the base to phase 5's requests
    (``refs``: their tokens, solo ``greedy_generate`` of the unadapted LM,
    the same function), the LoRA version is promoted under traffic, then
    the engine serves the fine-tuned model's tokens (greedy by
    full-sequence forwards; ``greedy_generate`` on the two shortest
    prompts), with its programs kept; the merged model serves the same.
    Returns the numbers and the engines' launches."""
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.nn import greedy_generate
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
    from bigdl_tpu_torch.serving import (
        PromotionController, PromotionCriterion,
    )
    from bigdl_tpu_torch.utils.model_registry import ModelRegistry, lora_delta

    def served_lm():
        lm = build_lm(TransformerLM, "auto", DEVICE)
        n = adapt(nn, lm, SEED + 52, trained_b=False)
        return lm.evaluate(), n

    launches = {}

    def engine_round(eng):
        kernels.reset_launch_counts()
        results, wall = serve_round(eng, prompts)
        for k, n in kernels.launch_counts().items():
            launches[k] = launches.get(k, 0) + n
        return results, wall

    reg = ModelRegistry(str(phase_dir("registry", "phase15", disk=True)),
                        keep=8)
    lm, n_adapted = served_lm()
    v_base = reg.publish(lm_tree(lm), meta={"source": "adapted base"})
    tuned, _ = served_lm()
    opt = (LocalOptimizer(tuned, lm_data(seed=SEED + 53), lm_criterion(),
                          device=DEVICE)
           .set_optim_method(Adam(learningrate=1e-3))
           .set_end_when(Trigger.max_iteration(LORA_TUNE_STEPS)))
    opt.optimize()
    tuned.evaluate()
    delta = lora_delta(lm_tree(tuned))
    v_lora = reg.publish_lora(delta, base_version=v_base,
                              meta={"source": "LoRA fine-tune"})
    del opt
    if refs is None:
        refs = [forward_greedy(lm, p, NEW_TOKENS) for p in prompts]
    eng = ServingEngine(lm, max_len=MAX_LEN, device=DEVICE, slots=SLOTS)
    try:
        results, wall = engine_round(eng)
        st0 = eng.stats()
        base_round = report_round("LoRA base, first round (captures)",
                                  results, wall, st0, {}, card)
        check_near_ties(lm, "LoRA base", [r.tokens for r in results], refs,
                        [len(p) for p in prompts])
        progs, keys = dict(eng._programs._programs), st0["compiled_programs"]
        ctrl = PromotionController(
            reg, engine=eng, eval_fn=lambda params: 1.0,
            criterion=PromotionCriterion(min_metric=0.5),
            watch_window_s=0.0)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res, swapped = swapped_round(
            eng, prompts, 1000, lambda: ctrl.promote(v_lora, watch=False))
        promote_s = time.perf_counter() - t0
        for k, n in kernels.launch_counts().items():
            launches[k] = launches.get(k, 0) + n
        if not res.promoted or eng.model_version != v_lora \
                or not res.swap.requeued:
            raise CheckFailed(f"the LoRA promotion: {res}")
        same_programs("the LoRA promotion", eng, progs, keys)
        resolved, _ = served_lm()
        convert.load_jax_params(resolved, reg.resolve_params(v_lora))
        if any(not torch.equal(p, q) for p, q in zip(
                resolved.parameters(), tuned.parameters())):
            raise CheckFailed("the resolved LoRA version is not the "
                              "fine-tuned model")
        parted = check_split("the LoRA promotion", lm, resolved, prompts,
                             swapped, res.swap.in_flight,
                             done_before(res.swap.in_flight, swapped), refs)
        st1 = eng.stats()
        results, wall = engine_round(eng)
        st2 = eng.stats()
        tuned_round = report_round("LoRA version, replays only", results,
                                   wall, st2, st1, card)
        same_programs("the LoRA version's round", eng, progs, keys)
    finally:
        eng.shutdown()
    tuned_refs = [forward_greedy(resolved, p, NEW_TOKENS) for p in prompts]
    parted += check_near_ties(resolved, "LoRA version",
                              [r.tokens for r in results], tuned_refs,
                              [len(p) for p in prompts])
    changed = sum(not np.array_equal(a, b) for a, b in zip(tuned_refs, refs))
    shortest = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[:2]
    solo = [greedy_generate(resolved, prompts[i][None], NEW_TOKENS,
                            device=DEVICE)[0].cpu().numpy() for i in shortest]
    parted += check_near_ties(resolved, "LoRA version against "
                              "greedy_generate",
                              [results[i].tokens for i in shortest], solo,
                              [len(prompts[i]) for i in shortest])
    # the merged model serves the same tokens
    n_merged = nn.merge_lora(resolved)
    if n_merged != n_adapted or any("lora" in n for n, _ in
                                    resolved.named_parameters()):
        raise CheckFailed(f"merge_lora merged {n_merged} of {n_adapted}")
    merged_eng = ServingEngine(resolved, max_len=MAX_LEN, device=DEVICE,
                               slots=SLOTS)
    try:
        merged, _ = engine_round(merged_eng)
    finally:
        merged_eng.shutdown()
    parted += check_near_ties(resolved, "merged LoRA version",
                              [r.tokens for r in merged], tuned_refs,
                              [len(p) for p in prompts])
    same = sum(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(merged, results))
    log(f"  LoRA serving: {n_adapted} modules adapted at rank "
        f"{LORA_RANK}; base v{v_base} served phase 5's tokens; v{v_lora} "
        f"({len(delta)} adapter leaves, "
        f"{sum(a.nbytes for a in delta.values())} bytes) promoted under "
        f"traffic in {promote_s:.2f} s (the gate, the artifact resolved "
        f"through its base, the engine's pause "
        f"{res.swap.duration_s * 1e3:.2f} ms; {res.swap.requeued} "
        f"re-prefilled), programs kept "
        f"({keys}); {changed} of {len(prompts)} requests' tokens changed "
        f"by the fine-tune; the merged model served {same} of "
        f"{len(prompts)} requests bitwise as the adapted engine; {parted} "
        f"parted at near ties; decode {tuned_round['decode_tokens_per_s']:.1f}"
        f" tokens/s adapted against {plain_rate} unadapted (phase 5) "
        f"[{card}]")
    del lm, tuned, resolved
    release()
    return {"adapted_modules": n_adapted, "base_version": v_base,
            "lora_version": v_lora, "delta_leaves": len(delta),
            "delta_bytes": sum(a.nbytes for a in delta.values()),
            "requeued": res.swap.requeued, "promote_s": promote_s,
            "swap_pause_ms": res.swap.duration_s * 1e3,
            "compiled_programs": keys, "changed_requests": changed,
            "merged_bitwise_requests": same, "parted_near_ties": parted,
            "base_round": base_round, "tuned_round": tuned_round,
            "plain_decode_tokens_per_s": plain_rate}, launches


def s2s_args(*extra):
    from bigdl_tpu_torch.models.transformer import train as s2s
    return s2s.build_parser().parse_args(S2S_ARGV + list(extra))


def check_s2s_step():
    """One (2, 256) step of Transformer-base on the card (the flash kernels
    non-causal in the encoder, causal at 257 in the decoder; the LayerNorm
    kernels) against the same weights on the CPU (plain LayerNorm,
    ``attention_impl="full"``): the loss (relative 1e-4) and every
    parameter's gradient (relative Frobenius 1e-3)."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models.transformer import train as s2s
    from bigdl_tpu_torch.optim import LocalOptimizer

    args = s2s_args()
    bos, eos, payload = s2s.special_ids(args)
    rng = np.random.default_rng(SEED + 60)
    src = rng.integers(0, payload, (2, S2S_LEN))
    tgt = src[:, ::-1]
    tin = np.concatenate([np.full((2, 1), bos), tgt], 1)
    tout = np.concatenate([tgt, np.full((2, 1), eos)], 1)
    inp = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (src, tin))
    target = torch.from_numpy(np.ascontiguousarray(tout))
    runs = []
    for device, impl in ((DEVICE, "auto"), ("cpu", "full")):
        model = s2s.build_model(args, device, attention_impl=impl)
        opt = LocalOptimizer(model, DataSet.array([]), s2s.criterion(),
                             device=device)
        names, params = zip(*model.named_parameters())
        loss, grads = opt._loss_and_grads(
            list(params), tuple(a.to(device) for a in inp), target.to(device))
        runs.append((loss.item(), {n: g.detach().cpu()
                                   for n, g in zip(names, grads)},
                     sum(p.numel() for p in params)))
        del model, opt, loss, grads
    (loss, grads, n_params), (loss_ref, grads_ref, _) = runs
    rel_loss = abs(loss - loss_ref) / abs(loss_ref)
    rel = rel_errors(grads, grads_ref)
    worst = max(rel, key=rel.get)
    log(f"  Transformer-base ({n_params} parameters), one (2, {S2S_LEN}) "
        f"step: loss {loss:.6f} vs CPU plain {loss_ref:.6f} (relative "
        f"{rel_loss:.2e}, limit 1e-4); gradients of {len(rel)} parameters, "
        f"worst relative error {rel[worst]:.2e} ({worst}, limit 1e-3)")
    if rel_loss > 1e-4 or rel[worst] > 1e-3:
        raise CheckFailed(f"the seq2seq step disagrees with the CPU plain "
                          f"model: loss {rel_loss:.3e}, {worst} "
                          f"{rel[worst]:.3e}")
    return {"rel_loss": rel_loss, "worst_grad_rel": rel[worst],
            "parameters": n_params}


def same_translations(name, a, b) -> int:
    """Two searches' ``(sequences, scores)``: scores within 1e-4, and the
    sequences equal except where a beam's score is within 1e-4 of another
    beam's of its row (a tie either search may break its own way).
    Returns how many rows differed at ties."""
    (sa, ca), (sb, cb) = a, b
    sa, sb = sa.cpu().numpy(), sb.cpu().numpy()
    ca, cb = ca.float().cpu().numpy(), cb.float().cpu().numpy()
    err = float(np.abs(ca - cb).max())
    if err > 1e-4:
        raise CheckFailed(f"{name}: scores differ by {err}")
    tied = 0
    for n in range(sa.shape[0]):
        if np.array_equal(sa[n], sb[n]):
            continue
        gaps = np.abs(np.diff(np.sort(ca[n])))
        if gaps.size == 0 or gaps.min() > 1e-4:
            raise CheckFailed(f"{name}: row {n}'s sequences differ with no "
                              f"tie among its beams")
        tied += 1
    return tied


def seq2seq_path(kernels, card, Engine):
    """Transformer-base through the seq2seq main's configuration: the
    one-step check, TRAIN_ITERS steps fp32 and bf16 (Adam 3e-3, the
    synthetic reversal corpus), each bitwise equal to eager steps, with the
    flash kernels' causal and non-causal launches; ``translate_generate``
    against ``beam_translate`` on held-out sources; the main itself."""
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.models.transformer import (
        beam_translate, translate_generate,
    )
    from bigdl_tpu_torch.models.transformer import train as s2s
    from bigdl_tpu_torch.optim import Adam

    check = check_s2s_step()
    args = s2s_args("--synthetic-size", str(S2S_BATCH * TRAIN_STEPS))
    bos, eos, payload = s2s.special_ids(args)
    rng = np.random.default_rng(0)
    srcs, tgts = s2s.corpus(args, rng)
    data = (DataSet.array(s2s.samples(args, srcs, tgts))
            >> SampleToMiniBatch(args.batch_size))

    def method():
        return Adam(learningrate=args.learning_rate)

    tokens = S2S_BATCH * (S2S_LEN + 1)
    out, launches, variants = {"one_step_check": check}, {}, {}
    for bf16 in (False, True):
        key = "bf16" if bf16 else "fp32"
        if bf16:
            Engine.init(compute_dtype=torch.bfloat16)
        try:
            model, opt, run = recorded_run(
                lambda: s2s.build_model(args, DEVICE), s2s.criterion(),
                method, data, TRAIN_ITERS, kernels, card,
                f"Transformer-base steps ({key}) at ({S2S_BATCH}, "
                f"{S2S_LEN} -> {S2S_LEN + 1})", tokens, profile=True)
        finally:
            if bf16:
                Engine.reset()
        for name in FLASH_NAMES:
            split = run["launches_by_variant"][name]
            if not split.get("full") or not split.get("causal"):
                raise CheckFailed(f"the seq2seq path ({key}) launched "
                                  f"{name} as {split}: both non-causal and "
                                  f"causal must be > 0")
            for v, n in split.items():
                variants.setdefault(name, {})
                variants[name][v] = variants[name].get(v, 0) + n
        idle = [k for k, n in run["launches"].items()
                if n == 0 and k not in NMS_KERNELS]
        if idle:
            raise CheckFailed(f"the seq2seq path ({key}) never launched "
                              f"{idle}")
        for k, n in run["launches"].items():
            launches[k] = launches.get(k, 0) + n
        out[key] = {k: run[k] for k in (
            "losses", "step_ms", "tokens_per_s", "first_step_ms", "launches",
            "launches_by_variant", "launches_by_dtype", "bitwise_vs_eager")}
        if run["profile"]:
            out[key]["profile"] = {k: run["profile"][k] for k in (
                "wall_ms", "busy_ms", "by_kind_ms", "kernels_by_kind")}
        if not bf16:
            held = np.random.default_rng(SEED + 61).integers(
                0, payload, (S2S_HELD_OUT, S2S_HELD_LEN)).astype(np.int32)
            kw = dict(beam_size=S2S_BEAM, eos_id=eos, bos_id=bos,
                      decode_length=S2S_HELD_LEN + 1, device=DEVICE)
            walls = {}
            found = {}
            for name, fn in (("translate_generate", translate_generate),
                             ("beam_translate", beam_translate)):
                for _ in range(2):              # the second call is timed
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    found[name] = fn(model, held, **kw)
                    torch.cuda.synchronize()
                    walls[name] = (time.perf_counter() - t0) * 1e3
            seqs = found["translate_generate"][0]
            if tuple(seqs.shape) != (S2S_HELD_OUT, S2S_BEAM,
                                     S2S_HELD_LEN + 2) \
                    or not bool((seqs[:, :, 0] == bos).all()):
                raise CheckFailed(f"translate_generate gave "
                                  f"{tuple(seqs.shape)}")
            tied = same_translations("translate_generate against "
                                     "beam_translate",
                                     found["translate_generate"],
                                     found["beam_translate"])
            log(f"  {S2S_HELD_OUT} held-out sources of {S2S_HELD_LEN} "
                f"tokens, beam {S2S_BEAM}: translate_generate "
                f"{walls['translate_generate']:.1f} ms, beam_translate "
                f"{walls['beam_translate']:.1f} ms; the same sequences "
                f"({tied} rows apart at ties), scores within 1e-4 [{card}]")
            out["translate"] = {"wall_ms": walls, "rows_apart_at_ties": tied,
                                "best": seqs[:, 0].tolist()}
        del model, opt
        release()
    # the main on the card at Transformer-base widths: 2 steps, 2 rows
    t0 = time.perf_counter()
    loss = s2s.main(S2S_ARGV + ["--synthetic-size", str(2 * S2S_BATCH),
                                "--max-epoch", "1", "--translate", "2",
                                "--device", DEVICE])
    out["main"] = {"loss": loss, "wall_s": time.perf_counter() - t0}
    if not np.isfinite(loss):
        raise CheckFailed(f"the seq2seq main's loss {loss}")
    release()
    return out, launches, variants


def finetune_path(TransformerLM, lm_criterion, nn, kernels, card, Engine,
                  ServingEngine, full=None, prompts=None, refs=None,
                  plain_rate=None):
    """Phase 15: LoRA fine-tuning and serving of the full-width LM, and the
    seq2seq Transformer at Transformer-base widths. ``full``: phase 6's
    full fine-tune runs (``{"fp32": run, "bf16": run}``), run here when
    None; ``prompts``/``refs``: phase 5's requests and their tokens;
    ``plain_rate``: phase 5's warm decode rate."""
    if full is None:
        full = {"fp32": train(TransformerLM, lm_criterion, kernels, card)[1]}
        Engine.init(compute_dtype=torch.bfloat16)
        try:
            full["bf16"] = train(TransformerLM, lm_criterion, kernels, card,
                                 bf16=True)[1]
        finally:
            Engine.reset()
        release()
    t0 = time.perf_counter()
    lora, lora_launches = lora_training(TransformerLM, lm_criterion, nn,
                                        kernels, card, Engine, full)
    laps = {"lora_training_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    serving, serve_launches = lora_serving(
        TransformerLM, lm_criterion, nn, kernels, card, ServingEngine,
        prompts or serving_prompts(), refs, plain_rate)
    laps["lora_serving_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s2s, s2s_launches, variants = seq2seq_path(kernels, card, Engine)
    laps["seq2seq_s"] = time.perf_counter() - t0
    # an engine's prefill and ticks attend through the cached path (plain
    # attention); its LayerNorms run the kernel
    if serve_launches.get("layer_norm_fwd", 0) <= 0:
        raise CheckFailed(f"the adapted engines launched {serve_launches}")
    log(f"  phase 15 laps {laps}; launches: LoRA training {lora_launches}, "
        f"LoRA serving {serve_launches}, seq2seq {s2s_launches} (flash by "
        f"variant {variants})")
    return {"lora": lora, "lora_serving": serving, "seq2seq": s2s,
            "laps": laps, "launches": {
                "lora_training": lora_launches,
                "lora_serving": serve_launches, "seq2seq": s2s_launches,
                "seq2seq_by_variant": variants}}


# --------------------------------------------------------------- phase 16
# the layer tail and the MNIST autoencoder at full width. Sweep shapes: the
# pointwise and table layers at TAIL_P, the spatial ones at TAIL_S (both
# layouts where the layer follows nn/layout.py), the volumetric ones at
# TAIL_V, LocallyConnected2D at TAIL_LC, the criteria at TAIL_CRIT and
# TimeDistributedMaskCriterion at TAIL_TIME
TAIL_SEED = SEED + 60
TAIL_P = (256, 4096)
TAIL_S = (32, 64, 56, 56)                   # N, C, H, W
TAIL_V = (8, 32, 16, 56, 56)                # N, C, D, H, W
TAIL_LC = (64, 32, 28, 28)
TAIL_CRIT = (256, 1000)
TAIL_TIME = (32, 256, 1000)
TAIL_SEQ = (32, 256, 512)                   # N, T, F of the temporal layers
TAIL_TOL = (1e-5, 1e-4)     # outputs (absolute, and relative to their
                            # largest magnitude), gradients (relative)
TAIL_CONV_TOL = (1e-4, 1e-4)                # cuDNN against the CPU, TF32 off
TAIL_REPS = (5, 3)                          # time_ms's reps and trials
# the autoencoder main's configuration (bigdl_tpu/models/autoencoder/train.py)
AE_BATCH, AE_BOTTLENECK, AE_LR, AE_SYNTHETIC = 128, 32, 0.01, 2048
AE_IMAGE_FLOPS = 3 * 2 * 2 * 784 * AE_BOTTLENECK    # fwd + bwd, both Linears


class TailCase:
    """One layer (or criterion) of the sweep: ``build(nn)`` makes it on the
    CPU (its weights from the seeded default generator), ``inputs(nhwc)``
    the nested list of its CPU input tensors; ``target`` a criterion's
    target; ``flops`` the fwd + bwd operations for the bound (0: the bytes
    bound only); ``heavy`` prints the bound; ``random`` checks training
    draws by their statistics; ``train`` runs the layer in training mode
    (the others run in eval mode, where the random layers are exact)."""

    def __init__(self, name, build, inputs, *, target=None, layout=False,
                 tol=TAIL_TOL, flops=None, heavy=False, random=None,
                 eager_only=False, peak=False, train=False):
        self.name, self.build, self.inputs = name, build, inputs
        self.train = train
        self.target, self.layout, self.tol = target, layout, tol
        self.flops, self.heavy, self.random = flops, heavy, random
        self.eager_only, self.peak = eager_only, peak


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def t_rn(*shape, seed=0):
    return torch.randn(shape, generator=_gen(TAIL_SEED + seed))


def t_pos(*shape, seed=0):
    return torch.rand(shape, generator=_gen(TAIL_SEED + seed)) * 1.8 + 0.2


def t_img(nhwc, seed=0, shape=None):
    n, c, h, w = shape or TAIL_S
    return t_rn(n, h, w, c, seed=seed) if nhwc else t_rn(n, c, h, w,
                                                         seed=seed)


def t_labels(n, c, seed=0, low=0):
    return torch.randint(low, c + low, (n,), generator=_gen(TAIL_SEED + seed))


def conv_flops(n_out_elems, c_in, k_elems):
    """fwd + the two backward products of a convolution."""
    return 3 * 2 * n_out_elems * c_in * k_elems


def tail_cases(nn) -> list:
    P, S, V, CR = TAIL_P, TAIL_S, TAIL_V, TAIL_CRIT
    n, c, h, w = S
    vn, vc, vd, vh, vw = V
    pair = lambda: [t_rn(*P), t_rn(*P, seed=1)]          # noqa: E731
    three = lambda: [t_rn(*P), t_rn(*P, seed=1), t_rn(*P, seed=2)]  # noqa
    x = lambda _: t_rn(*P)                               # noqa: E731
    img = lambda f: t_img(f)                             # noqa: E731
    nchw = lambda _: t_img(False)                        # noqa: E731
    vol = lambda _: t_rn(*V)                             # noqa: E731
    seq = lambda _: t_rn(*TAIL_SEQ)                      # noqa: E731
    C = TailCase
    cases = [C(name, (lambda m: lambda nn: getattr(nn, m)())(name), x)
             for name in ("Abs", "ELU", "Exp", "HardSigmoid", "HardTanh",
                          "LeakyReLU", "LogSigmoid", "ReLU6", "Sigmoid",
                          "SoftMax", "SoftMin", "SoftPlus", "SoftSign",
                          "Square", "TanhShrink", "Negative", "HardShrink",
                          "SoftShrink", "Threshold")]
    cases += [
        C("AddConstant", lambda nn: nn.AddConstant(0.5), x),
        C("BinaryThreshold", lambda nn: nn.BinaryThreshold(0.1), x),
        C("Clamp", lambda nn: nn.Clamp(-0.5, 0.7), x),
        C("Log", lambda nn: nn.Log(), lambda _: t_pos(*P)),
        C("Sqrt", lambda nn: nn.Sqrt(), lambda _: t_pos(*P)),
        C("MulConstant", lambda nn: nn.MulConstant(1.5), x),
        C("Power", lambda nn: nn.Power(2.5, 0.5, 2.0), x),
        C("PReLU", lambda nn: nn.PReLU(), x),
        C("PReLU-channels", lambda nn: nn.PReLU(c), img, layout=True,
          heavy=True),
        C("SReLU", lambda nn: nn.SReLU((P[1],)), x),
        # shape layers
        C("Flatten", lambda nn: nn.Flatten(), nchw),
        C("Unsqueeze", lambda nn: nn.Unsqueeze(2), x),
        C("Transpose", lambda nn: nn.Transpose([(1, 2)]), x),
        C("Narrow", lambda nn: nn.Narrow(2, P[1] // 4 + 1, P[1] // 2), x),
        C("SplitTable", lambda nn: nn.SplitTable(2),
          lambda _: t_rn(P[0], 8, P[1] // 8)),
        C("Padding", lambda nn: nn.Padding(2, 64, value=0.5), x),
        C("SpatialZeroPadding", lambda nn: nn.SpatialZeroPadding(1, 1, 1, 1),
          nchw),
        C("Contiguous", lambda nn: nn.Contiguous(), x),
        C("Replicate", lambda nn: nn.Replicate(4, 2),
          lambda _: t_rn(P[0], P[1] // 4)),
        C("Tile", lambda nn: nn.Tile(2, 2), x),
        C("Reverse", lambda nn: nn.Reverse(2), x),
        # a permutation of the rows and two out of range (NaN rows): no
        # repeated index, so the backward's scattered adds do not collide
        C("Index", lambda nn: nn.Index(1), lambda _: [t_rn(*P), torch.cat([
            torch.randperm(P[0], generator=_gen(TAIL_SEED)),
            torch.tensor([P[0], -P[0] - 1])])]),
        C("InferReshape", lambda nn: nn.InferReshape([0, -1, 64]), x),
        # containers and table layers
        C("ParallelTable", lambda nn: nn.ParallelTable().add(nn.Tanh())
          .add(nn.Sigmoid()), lambda _: pair()),
        C("MapTable", lambda nn: nn.MapTable(nn.Linear(P[1], 1024)),
          lambda _: pair()),
        C("NarrowTable", lambda nn: nn.NarrowTable(2, 2), lambda _: three()),
        C("FlattenTable", lambda nn: nn.FlattenTable(), lambda _: [
            t_rn(*P), [t_rn(*P, seed=1), [t_rn(*P, seed=2)]]]),
        C("CSubTable", lambda nn: nn.CSubTable(), lambda _: pair()),
        C("CDivTable", lambda nn: nn.CDivTable(),
          lambda _: [t_rn(*P), t_pos(*P, seed=1)]),
        C("CMaxTable", lambda nn: nn.CMaxTable(), lambda _: three()),
        C("CMinTable", lambda nn: nn.CMinTable(), lambda _: three()),
        C("CAveTable", lambda nn: nn.CAveTable(), lambda _: three()),
        C("MixtureTable", lambda nn: nn.MixtureTable(), lambda _: [
            t_rn(P[0], 4), [t_rn(*P, seed=k + 1) for k in range(4)]]),
        C("Bottle", lambda nn: nn.Bottle(nn.Linear(P[1] // 16, 256), 2),
          lambda _: t_rn(P[0], 16, P[1] // 16)),
        C("Pack", lambda nn: nn.Pack(2), lambda _: pair()),
        C("Echo", lambda nn: nn.Echo(), x),
        C("BifurcateSplitTable", lambda nn: nn.BifurcateSplitTable(2), x),
        C("MaskedSelect", lambda nn: nn.MaskedSelect(), lambda _: [
            t_rn(*P), (t_rn(*P, seed=1) > 0).float()], eager_only=True),
        # nn/misc.py
        C("Max", lambda nn: nn.Max(2), x),
        C("Min", lambda nn: nn.Min(2), x),
        C("Mean", lambda nn: nn.Mean(2), x),
        C("Sum", lambda nn: nn.Sum(2), x),
        C("RReLU", lambda nn: nn.RReLU(), x, random="rrelu"),
        C("DotProduct", lambda nn: nn.DotProduct(), lambda _: pair()),
        C("MM", lambda nn: nn.MM(False, True), lambda _: [
            t_rn(P[0], 64, 64), t_rn(P[0], 64, 64, seed=1)]),
        C("MV", lambda nn: nn.MV(True), lambda _: [
            t_rn(P[0], 64, 64), t_rn(P[0], 64, seed=1)]),
        C("Euclidean", lambda nn: nn.Euclidean(1024, 128),
          lambda _: t_rn(P[0], 1024), heavy=True,
          flops=3 * 3 * P[0] * 128 * 1024),
        C("Bilinear", lambda nn: nn.Bilinear(512, 512, 128), lambda _: [
            t_rn(P[0], 512), t_rn(P[0], 512, seed=1)],
          heavy=True, flops=3 * 2 * P[0] * 128 * 512 * 512),
        C("Maxout", lambda nn: nn.Maxout(P[1], 1024, 4), x,
          heavy=True, flops=3 * 2 * P[0] * P[1] * 4096),
        C("SpatialUpSamplingNearest",
          lambda nn: nn.SpatialUpSamplingNearest(2), nchw, heavy=True),
        C("SpatialUpSamplingBilinear",
          lambda nn: nn.SpatialUpSamplingBilinear(2), nchw, heavy=True,
          flops=3 * 2 * n * c * (2 * h * h * w + 2 * h * w * 2 * w)),
        C("GradientReversal", lambda nn: nn.GradientReversal(0.7), x),
        C("L1Penalty", lambda nn: nn.L1Penalty(0.1, True), x, train=True),
        C("Scale", lambda nn: nn.Scale((c, 1, 1)), nchw, heavy=True),
        C("PairwiseDistance", lambda nn: nn.PairwiseDistance(2),
          lambda _: pair()),
        C("GaussianSampler", lambda nn: nn.GaussianSampler(), lambda _: [
            torch.full(P, 0.5), torch.full(P, 2 * math.log(0.7))],
          random="sampler"),
        C("Highway", lambda nn: nn.Highway(P[1]), x,
          heavy=True, flops=3 * 2 * 2 * P[0] * P[1] * P[1]),
        C("UpSampling1D", lambda nn: nn.UpSampling1D(2), seq),
        C("UpSampling2D", lambda nn: nn.UpSampling2D((2, 2)), img,
          layout=True, heavy=True),
        C("UpSampling3D", lambda nn: nn.UpSampling3D((2, 2, 2)), vol,
          heavy=True),
        C("ResizeBilinear", lambda nn: nn.ResizeBilinear(112, 112), nchw,
          heavy=True,
          flops=3 * 2 * n * c * (112 * h * w + 112 * w * 112)),
        C("ResizeBilinear-corners", lambda nn: nn.ResizeBilinear(28, 28, True),
          nchw, heavy=True,
          flops=3 * 2 * n * c * (28 * h * w + 28 * w * 28)),
        C("Cropping2D", lambda nn: nn.Cropping2D((2, 2), (2, 2)), nchw),
        C("Cropping3D", lambda nn: nn.Cropping3D((1, 1), (2, 2), (2, 2)),
          vol),
        C("ActivityRegularization",
          lambda nn: nn.ActivityRegularization(0.1, 0.2), x),
        C("NegativeEntropyPenalty",
          lambda nn: nn.NegativeEntropyPenalty(0.3), lambda _: t_pos(*P)),
        C("CrossProduct", lambda nn: nn.CrossProduct(8, 512),
          lambda _: [t_rn(P[0], 512, seed=k) for k in range(8)]),
        C("ImageNormalize", lambda nn: nn.ImageNormalize(
            tuple(np.linspace(0.4, 0.5, c)), tuple(np.linspace(0.2, 0.3, c)),
            1.0), img, layout=True, heavy=True),
        # nn/normalization.py's tail, nn/cosine.py, nn/pooling.py
        C("Normalize", lambda nn: nn.Normalize(2.0), x),
        C("CMul", lambda nn: nn.CMul((1, P[1])), x),
        C("CAdd", lambda nn: nn.CAdd((P[1],)), x),
        C("Mul", lambda nn: nn.Mul(), x),
        C("Add", lambda nn: nn.Add(P[1]), x),
        C("SpatialWithinChannelLRN",
          lambda nn: nn.SpatialWithinChannelLRN(5, 1.0, 0.75), nchw,
          heavy=True),
        C("SpatialSubtractiveNormalization",
          lambda nn: nn.SpatialSubtractiveNormalization(c), nchw, heavy=True,
          tol=TAIL_CONV_TOL, flops=2 * conv_flops(n * h * w, c, 81)),
        # with a threshold far below the local deviations (about 1 here):
        # the default floor, the per-sample mean deviation, has pixels
        # within rounding of it, whose branch then differs between the
        # card and the CPU (a gradient 1.67e-4 apart, PR 16); both modes
        # are held against JAX on the CPU (tests/test_torch_layer_tail.py)
        C("SpatialDivisiveNormalization",
          lambda nn: nn.SpatialDivisiveNormalization(c, threshold=0.05),
          nchw, heavy=True, tol=TAIL_CONV_TOL,
          flops=2 * conv_flops(n * h * w, c, 81)),
        C("SpatialContrastiveNormalization",
          lambda nn: nn.SpatialContrastiveNormalization(c, threshold=0.05),
          nchw, heavy=True, tol=TAIL_CONV_TOL,
          flops=4 * conv_flops(n * h * w, c, 81)),
        C("Cosine", lambda nn: nn.Cosine(P[1], 1000), x,
          heavy=True, flops=3 * 2 * P[0] * P[1] * 1000),
        C("CosineDistance", lambda nn: nn.CosineDistance(), lambda _: pair()),
        C("TemporalAveragePooling", lambda nn: nn.TemporalAveragePooling(3, 2),
          seq),
        # the random layers (checked in training mode by their statistics)
        C("SpatialDropout1D", lambda nn: nn.SpatialDropout1D(0.3), seq,
          random="dropout"),
        C("SpatialDropout2D", lambda nn: nn.SpatialDropout2D(0.3), img,
          layout=True, random="dropout"),
        C("SpatialDropout3D", lambda nn: nn.SpatialDropout3D(0.3), vol,
          random="dropout"),
        C("GaussianDropout", lambda nn: nn.GaussianDropout(0.3),
          lambda _: torch.ones(P), random="gauss_mul"),
        C("GaussianNoise", lambda nn: nn.GaussianNoise(0.7),
          lambda _: torch.zeros(P), random="gauss_add"),
        # nn/convolution.py's tail and nn/volumetric.py
        C("SpatialDilatedConvolution", lambda nn: nn.SpatialDilatedConvolution(
            c, c, 3, 3, 1, 1, 2, 2, 2, 2), nchw, heavy=True,
          tol=TAIL_CONV_TOL, flops=conv_flops(n * c * h * w, c, 9)),
        C("SpatialFullConvolution", lambda nn: nn.SpatialFullConvolution(
            c, c // 2, 4, 4, 2, 2, 1, 1), nchw, heavy=True, tol=TAIL_CONV_TOL,
          flops=conv_flops(n * c * h * w, c // 2, 16)),
        C("SpatialSeparableConvolution",
          lambda nn: nn.SpatialSeparableConvolution(c, 2 * c, 1, 3, 3, 1, 1,
                                                    1, 1),
          img, layout=True, heavy=True, tol=TAIL_CONV_TOL,
          flops=conv_flops(n * c * h * w, 1, 9)
          + conv_flops(n * 2 * c * h * w, c, 1)),
        C("SpatialShareConvolution", lambda nn: nn.SpatialShareConvolution(
            c, c, 3, 3, 1, 1, 1, 1), img, layout=True, heavy=True,
          tol=TAIL_CONV_TOL, flops=conv_flops(n * c * h * w, c, 9)),
        C("SpatialConvolutionMap", lambda nn: nn.SpatialConvolutionMap(
            nn.SpatialConvolutionMap.random(c, c, min(16, c), seed=1), 3, 3,
            1, 1, 1, 1), img, layout=True, heavy=True, tol=TAIL_CONV_TOL,
          flops=conv_flops(n * c * h * w, c, 9)),
        C("LocallyConnected2D", lambda nn: nn.LocallyConnected2D(
            TAIL_LC[1], TAIL_LC[3], TAIL_LC[2], TAIL_LC[1], 3, 3),
          lambda _: t_rn(*TAIL_LC), heavy=True, tol=TAIL_CONV_TOL,
          flops=3 * 2 * TAIL_LC[0] * (TAIL_LC[2] - 2) * (TAIL_LC[3] - 2)
          * TAIL_LC[1] * TAIL_LC[1] * 9),
        C("LocallyConnected1D", lambda nn: nn.LocallyConnected1D(
            TAIL_SEQ[1], TAIL_SEQ[2], 256, 3, 2), seq, heavy=True,
          tol=TAIL_CONV_TOL,
          flops=3 * 2 * TAIL_SEQ[0] * ((TAIL_SEQ[1] - 3) // 2 + 1) * 256 * 3
          * TAIL_SEQ[2]),
        C("VolumetricConvolution", lambda nn: nn.VolumetricConvolution(
            vc, vc, 3, 3, 3, 1, 1, 1, 1, 1, 1), vol, heavy=True,
          tol=TAIL_CONV_TOL, flops=conv_flops(vn * vc * vd * vh * vw, vc, 27)),
        C("VolumetricFullConvolution", lambda nn: nn.VolumetricFullConvolution(
            vc, vc // 2, 2, 2, 2, 2, 2, 2), vol, heavy=True,
          tol=TAIL_CONV_TOL, flops=conv_flops(vn * vc * vd * vh * vw,
                                              vc // 2, 8)),
        # windows that do not overlap: the pooling backwards' scattered
        # adds then never collide (bitwise replays)
        C("VolumetricMaxPooling", lambda nn: nn.VolumetricMaxPooling(2, 2, 2),
          vol, heavy=True),
        C("VolumetricAveragePooling",
          lambda nn: nn.VolumetricAveragePooling(2, 2, 2), vol, heavy=True),
        # nn/tf_utils.py
        C("Const", lambda nn: nn.Const(np.linspace(0, 1, P[1],
                                                   dtype=np.float32)), x),
        C("Fill", lambda nn: nn.Fill(), lambda _: [P, torch.tensor(1.5)]),
        C("Shape", lambda nn: nn.Shape(), nchw),
        C("StrideSlice", lambda nn: nn.StrideSlice([(1, 0, P[1], 2)]), x),
        C("SplitAndSelect", lambda nn: nn.SplitAndSelect(1, 1, 4), x),
    ]
    n_, k_ = CR
    crit = lambda _: t_rn(*CR)                            # noqa: E731
    prob = lambda _: torch.softmax(t_rn(*CR), -1)         # noqa: E731
    sign = lambda: torch.where(t_rn(*CR, seed=5) > 0, 1.0, -1.0)  # noqa
    labels = lambda: t_labels(n_, k_, seed=6)             # noqa: E731
    # every row lists 4 distinct labels, then the sentinel
    multi = torch.full(CR, -1, dtype=torch.int64)
    multi[:, :4] = torch.stack([torch.randperm(k_, generator=_gen(
        TAIL_SEED + r))[:4] for r in range(n_)])
    tn, tt, tk = TAIL_TIME
    times = t_labels(tn * tt, tk, seed=7).reshape(tn, tt)
    times[:, tt // 2:] = 0                  # the padded half of each row

    def crit_case(name, build, inp, target, **kw):
        return C(name, build, inp, target=target, **kw)

    cases += [
        crit_case("MSECriterion", lambda nn: nn.MSECriterion(), crit,
                  lambda: t_rn(*CR, seed=1)),
        crit_case("AbsCriterion", lambda nn: nn.AbsCriterion(), crit,
                  lambda: t_rn(*CR, seed=1)),
        crit_case("BCECriterion", lambda nn: nn.BCECriterion(),
                  lambda _: torch.rand(CR, generator=_gen(1)) * 0.9 + 0.05,
                  lambda: (t_rn(*CR, seed=1) > 0).float()),
        crit_case("BCECriterionWithLogits",
                  lambda nn: nn.BCECriterionWithLogits(), crit,
                  lambda: torch.rand(CR, generator=_gen(2))),
        crit_case("SmoothL1Criterion", lambda nn: nn.SmoothL1Criterion(),
                  crit, lambda: t_rn(*CR, seed=1)),
        crit_case("MarginCriterion", lambda nn: nn.MarginCriterion(0.7), crit,
                  sign),
        crit_case("HingeEmbeddingCriterion",
                  lambda nn: nn.HingeEmbeddingCriterion(0.8), crit, sign),
        crit_case("DistKLDivCriterion", lambda nn: nn.DistKLDivCriterion(),
                  lambda _: torch.log_softmax(t_rn(*CR), -1),
                  lambda: torch.softmax(t_rn(*CR, seed=1), -1)),
        crit_case("MultiLabelSoftMarginCriterion",
                  lambda nn: nn.MultiLabelSoftMarginCriterion(), crit,
                  lambda: (t_rn(*CR, seed=1) > 0).float()),
        crit_case("CosineEmbeddingCriterion",
                  lambda nn: nn.CosineEmbeddingCriterion(0.2),
                  lambda _: [t_rn(*CR), t_rn(*CR, seed=1)],
                  lambda: torch.where(t_rn(n_, seed=5) > 0, 1.0, -1.0)),
        crit_case("MarginRankingCriterion",
                  lambda nn: nn.MarginRankingCriterion(0.5),
                  lambda _: [t_rn(n_), t_rn(n_, seed=1)],
                  lambda: torch.where(t_rn(n_, seed=5) > 0, 1.0, -1.0)),
        crit_case("MultiMarginCriterion", lambda nn: nn.MultiMarginCriterion(),
                  crit, labels),
        crit_case("MultiLabelMarginCriterion",
                  lambda nn: nn.MultiLabelMarginCriterion(), crit,
                  lambda: multi, heavy=True, peak=True,
                  flops=0),
        crit_case("SoftMarginCriterion", lambda nn: nn.SoftMarginCriterion(),
                  crit, sign),
        crit_case("CosineDistanceCriterion",
                  lambda nn: nn.CosineDistanceCriterion(), crit,
                  lambda: t_rn(*CR, seed=1)),
        crit_case("L1HingeEmbeddingCriterion",
                  lambda nn: nn.L1HingeEmbeddingCriterion(30.0),
                  lambda _: [t_rn(*CR), t_rn(*CR, seed=1)],
                  lambda: torch.where(t_rn(n_, seed=5) > 0, 1.0, -1.0)),
        crit_case("PoissonCriterion", lambda nn: nn.PoissonCriterion(),
                  lambda _: t_pos(*CR), lambda: t_pos(*CR, seed=1)),
        crit_case("CosineProximityCriterion",
                  lambda nn: nn.CosineProximityCriterion(), crit,
                  lambda: t_rn(*CR, seed=1)),
        crit_case("MeanAbsolutePercentageCriterion",
                  lambda nn: nn.MeanAbsolutePercentageCriterion(), crit,
                  lambda: t_pos(*CR, seed=1)),
        crit_case("MeanSquaredLogarithmicCriterion",
                  lambda nn: nn.MeanSquaredLogarithmicCriterion(),
                  lambda _: t_pos(*CR), lambda: t_pos(*CR, seed=1)),
        crit_case("KullbackLeiblerDivergenceCriterion",
                  lambda nn: nn.KullbackLeiblerDivergenceCriterion(), prob,
                  lambda: torch.softmax(t_rn(*CR, seed=1), -1)),
        crit_case("ClassSimplexCriterion",
                  lambda nn: nn.ClassSimplexCriterion(k_), crit, labels),
        crit_case("MultiCriterion", lambda nn: nn.MultiCriterion()
                  .add(nn.MSECriterion(), 0.5).add(nn.AbsCriterion(), 2.0),
                  crit, lambda: t_rn(*CR, seed=1)),
        crit_case("L1Cost", lambda nn: nn.L1Cost(), crit,
                  lambda: t_rn(*CR, seed=1)),
        crit_case("KLDCriterion", lambda nn: nn.KLDCriterion(),
                  lambda _: [t_rn(*CR), 0.5 * t_rn(*CR, seed=1)],
                  lambda: t_rn(*CR, seed=2)),
        crit_case("GaussianCriterion", lambda nn: nn.GaussianCriterion(),
                  lambda _: [t_rn(*CR), 0.5 * t_rn(*CR, seed=1)],
                  lambda: t_rn(*CR, seed=2)),
        crit_case("DiceCoefficientCriterion",
                  lambda nn: nn.DiceCoefficientCriterion(),
                  lambda _: torch.rand(CR, generator=_gen(3)),
                  lambda: (t_rn(*CR, seed=1) > 0).float()),
        crit_case("SoftmaxWithCriterion",
                  lambda nn: nn.SoftmaxWithCriterion(), crit, labels),
        crit_case("CategoricalCrossEntropy",
                  lambda nn: nn.CategoricalCrossEntropy(), prob,
                  lambda: torch.eye(k_)[labels()]),
        crit_case("TimeDistributedMaskCriterion",
                  lambda nn: nn.TimeDistributedMaskCriterion(
                      nn.CrossEntropyCriterion(), 0),
                  lambda _: t_rn(*TAIL_TIME), lambda: times, heavy=True),
        crit_case("SmoothL1CriterionWithWeights",
                  lambda nn: nn.SmoothL1CriterionWithWeights(2.0, 3), crit,
                  lambda: [t_rn(*CR, seed=1), t_pos(*CR, seed=2),
                           t_pos(*CR, seed=3)]),
        crit_case("TransformerCriterion",
                  lambda nn: nn.TransformerCriterion(
                      nn.MSECriterion(), nn.Linear(k_, 256),
                      nn.Linear(k_, 256)), crit, lambda: t_rn(*CR, seed=1),
                  flops=3 * 2 * 2 * n_ * k_ * 256),
    ]
    return cases


def _nest(spec, fn):
    """``spec`` (a tensor, a tuple, or nested lists of them) with ``fn``
    applied to every tensor, the lists as port Tables."""
    from bigdl_tpu_torch.utils.table import T
    if isinstance(spec, list):
        return T(*[_nest(s, fn) for s in spec])
    return fn(spec) if isinstance(spec, torch.Tensor) else spec


def _tensors_in(spec) -> list:
    if isinstance(spec, list):
        return [t for s in spec for t in _tensors_in(s)]
    return [spec] if isinstance(spec, torch.Tensor) else []


def _outputs(out) -> list:
    from bigdl_tpu_torch.utils.table import Table
    if isinstance(out, Table):
        return [t for v in out.values() for t in _outputs(v)]
    return [out]


def _on(module, device):
    """A copy of a layer or criterion on ``device`` (a criterion's modules
    and constants too)."""
    import copy
    m = copy.deepcopy(module)
    if isinstance(m, torch.nn.Module):
        return m.to(device)
    for k, v in vars(m).items():
        if isinstance(v, torch.nn.Module):
            setattr(m, k, v.to(device))
    return m


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns (NaN equal to itself)."""
    if t.dtype.is_floating_point:
        return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                    8: torch.int64}[t.element_size()])
    return t


def bitwise_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(a, b))


class TailRun:
    """One case on one device: its module, its inputs (floating ones with
    ``requires_grad``), the weights of ``sum(out * w)``, and the function
    that runs the forward and backward, returning ``[outputs..., grads
    of the parameters..., grads of the floating inputs...]``."""

    def __init__(self, case, module, spec, target, weights, device):
        self.case, self.device = case, device
        self.module = _on(module, device)
        # fresh leaves on the device (a CUDA copy of a CPU leaf that
        # requires grad would hang the card's graph off the CPU's)
        self.spec = _nest(spec, lambda t: t.detach().to(device)
                          .requires_grad_(t.is_floating_point()))
        self.inputs = [t for t in _tensors_in(self.spec) if t.requires_grad]
        self.target = None if target is None else _nest(
            target, lambda t: t.detach().to(device))
        self.weights = None if weights is None else [
            None if w is None else w.to(device) for w in weights]
        self.params = list(self.module.parameters()) if isinstance(
            self.module, torch.nn.Module) else []

    def forward(self):
        if self.target is not None:
            return [self.module.apply(self.spec, self.target)]
        return _outputs(self.module.run(self.spec, None)[0])

    def __call__(self):
        outs = self.forward()
        if self.target is not None:
            loss = outs[0]
        else:
            terms = [(o * w).sum() for o, w in zip(outs, self.weights)
                     if w is not None]
            loss = sum(terms) if terms else None
        wrt = self.params + self.inputs
        grads = [None] * len(wrt)
        if loss is not None and loss.requires_grad and wrt:
            grads = list(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, wrt)]
        return [o.detach() for o in outs] + grads


def _weights_for(outs: list) -> list:
    return [t_rn(*o.shape, seed=11 + k) if o.is_floating_point() else None
            for k, o in enumerate(outs)]


def _close(what, got, want, tol):
    atol, grad_rel = tol
    n_out = len(want["outs"])
    for k, (g, w) in enumerate(zip(got[:n_out], want["outs"])):
        g = g.cpu()
        # relative to the output's scale: a reduction's rounding grows with
        # its terms' magnitude, not with the (possibly cancelled) result
        scale = float(w.float().nan_to_num(0.0).abs().max()) \
            if w.is_floating_point() and w.numel() else 0.0
        if g.shape != w.shape or (g.is_floating_point() and not torch.allclose(
                g.float(), w.float(), rtol=0.0, atol=atol * (1.0 + scale),
                equal_nan=True)) \
                or (not g.is_floating_point() and not torch.equal(g, w)):
            raise CheckFailed(f"{what}: output {k} differs from the CPU's "
                              f"(max|err| {max_err(g, w):.3e})")
    errs = []
    for k, (g, w) in enumerate(zip(got[n_out:], want["grads"])):
        rel = float((g.cpu().double() - w.double()).norm()
                    / max(float(w.double().norm()), 1e-30))
        errs.append(rel)
        if rel > grad_rel:
            raise CheckFailed(f"{what}: gradient {k} is {rel:.3e} from the "
                              f"CPU's (limit {grad_rel})")
    return max(errs, default=0.0)


def _fwd_bwd_bytes(run) -> float:
    """Bytes of a forward and backward: each floating input and parameter
    read twice (forward and backward) and its gradient written, each
    output written once and its gradient read once."""
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa
    outs = run.forward()
    return 3 * size(run.inputs) + 3 * size(run.params) + 2 * size(
        [o for o in outs if o.is_floating_point()])


def _random_stats(case, run, card):
    """Training-mode draws on the card held by the CPU tests' statistics
    (5 sigma): the kept share (per channel for the spatial dropouts), the
    noise's mean and variance, RReLU's slopes in [lower, upper]."""
    kind = case.random
    x = run.spec
    with torch.no_grad():
        if kind == "dropout":
            keep = 1.0 - run.module.p
            kept = run.module.run(torch.ones_like(x))[0] > 0
            mask_shape = run.module._mask_shape(x)
            # one draw a (sample, channel): the mask's own entries
            small = kept[tuple(slice(None) if s > 1 else slice(0, 1)
                               for s in mask_shape)]
            if not torch.equal(small.expand(kept.shape), kept):
                raise CheckFailed(f"{case.name}: a channel was not dropped "
                                  f"whole")
            draws = small.reshape(-1, math.prod(mask_shape[1:])).float()
            n = draws.shape[0]
            worst = float((draws.mean(0) - keep).abs().max())
            limit = 5 * (keep * (1 - keep) / n) ** 0.5
            total = float(draws.mean())
            stats = {"kept_share": total, "worst_channel_dev": worst,
                     "channel_limit_5sigma": limit, "draws": draws.numel()}
            ok = worst <= limit and abs(total - keep) <= 5 * (
                keep * (1 - keep) / draws.numel()) ** 0.5
        elif kind in ("gauss_mul", "gauss_add", "sampler"):
            out = run.forward()[0].double()
            if kind == "gauss_mul":
                r = run.module.rate
                mean, var = 1.0, r / (1 - r)
            elif kind == "gauss_add":
                mean, var = 0.0, run.module.stddev ** 2
            else:
                mean, var = 0.5, 0.49
            m, v, n = float(out.mean()), float(out.var()), out.numel()
            stats = {"mean": m, "var": v, "want_mean": mean,
                     "want_var": var, "n": n}
            ok = (abs(m - mean) <= 5 * (var / n) ** 0.5
                  and abs(v - var) <= 5 * var * (2.0 / n) ** 0.5)
        else:                                            # rrelu
            lo, hi = run.module.lower, run.module.upper
            slopes = -run.module.run(-torch.ones(x.shape, device=DEVICE))[0]
            n = slopes.numel()
            stats = {"min": float(slopes.min()), "max": float(slopes.max()),
                     "mean": float(slopes.mean()), "n": n}
            ok = (stats["min"] >= lo and stats["max"] <= hi and abs(
                stats["mean"] - (lo + hi) / 2) <= 5 * (
                (hi - lo) ** 2 / 12 / n) ** 0.5)
    if not ok:
        raise CheckFailed(f"{case.name}: training-mode draws off their "
                          f"statistics {stats}")
    return stats


def tail_case(case, nhwc, Program, card) -> dict:
    """One layer or criterion of the sweep on the card against the CPU
    (the same module and inputs), eager under the sync-debug mode, as a
    captured program replayed bitwise against its eager run, timed."""
    from bigdl_tpu_torch.nn.containers import MaskedSelectCaptureError
    from bigdl_tpu_torch.nn.layout import set_image_format
    from bigdl_tpu_torch.nn.normalization import dropout_generators
    from bigdl_tpu_torch.utils.programs import ProgramCaptureError
    what = case.name + ("-NHWC" if nhwc else "")
    set_image_format("NHWC" if nhwc else "NCHW")
    t0 = time.perf_counter()
    torch.manual_seed(TAIL_SEED)
    try:
        module = case.build(__import__("bigdl_tpu_torch.nn").nn)
        spec = case.inputs(nhwc)
        target = case.target() if case.target is not None else None
        if isinstance(module, torch.nn.Module):
            module.train(case.train)
        cpu = TailRun(case, module, spec, target, None, "cpu")
        weights = None if target is not None else _weights_for(cpu.forward())
        cpu.weights = weights
        res = cpu()
        cpu_s = time.perf_counter() - t0
        n_out = len(res) - len(cpu.params) - len(cpu.inputs)
        want = {"outs": res[:n_out], "grads": res[n_out:]}
        card_run = TailRun(case, module, spec, target, weights, DEVICE)
        got = card_run()
        grad_err = _close(what, got, want, case.tol)
        row = {"name": what, "grad_rel_err": grad_err, "cpu_s": cpu_s}
        if case.eager_only:        # MaskedSelect: its size is a host read
            prog = Program(("tail", what), card_run, (), DEVICE)
            try:
                prog()
            except ProgramCaptureError as e:
                if not isinstance(e.__cause__, MaskedSelectCaptureError):
                    raise
                row["capture"] = "refused: " + str(e.__cause__)[:60]
            else:
                if DEVICE != "cpu":
                    raise CheckFailed(f"{what} ran inside a capture")
            return row
        if DEVICE != "cpu":
            # a second eager run: no host sync (a hidden read fails here)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                card_run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        gens = []
        if case.random:     # training mode, from a generator of its own
            m = card_run.module
            m.train()
            m.generator = torch.Generator(DEVICE)
            row["training_draws"] = _random_stats(case, card_run, card)
            gens = [m.generator]

        def reseed():
            for g in gens:
                g.manual_seed(TAIL_SEED)

        reseed()
        eager = [t.clone() for t in card_run()]
        prog = Program(("tail", what), card_run, (), DEVICE,
                       generators=dropout_generators(card_run.module)
                       if gens else ())
        prog()                                       # warm-up and capture
        reseed()
        replay = [t.clone() for t in prog()]
        if not bitwise_equal(replay, eager):
            raise CheckFailed(f"{what}: the replayed program is not bitwise "
                              f"equal to its eager run")
        row["replay_bitwise"] = True
        if DEVICE != "cpu":
            if case.peak:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                card_run()
                torch.cuda.synchronize()
                row["peak_memory_bytes"] = \
                    torch.cuda.max_memory_allocated() - base
            row["ms"], row["host_ms"] = time_ms(prog, *TAIL_REPS)
            if case.heavy:
                nbytes = _fwd_bwd_bytes(card_run)
                row["bytes"] = nbytes
                row["bound_ms"], row["bound_by"] = bound_ms(
                    nbytes, case.flops or 0, "float32")
                row["bound_share"] = row["bound_ms"] / row["ms"]
        row["wall_s"] = time.perf_counter() - t0
        return row
    finally:
        set_image_format(None)


def tail_sweep(card, Program) -> list:
    """Every ported layer and criterion of the tail, forward and
    backward on the card in fp32 with TF32 off (cuDNN deterministic),
    against the CPU."""
    import bigdl_tpu_torch.nn as nn
    rows = []
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for case in tail_cases(nn):
            for nhwc in ((False, True) if case.layout else (False,)):
                row = tail_case(case, nhwc, Program, card)
                rows.append(row)
                extra = ""
                if "bound_ms" in row:
                    extra = (f", bound {row['bound_ms']:.4f} ms by "
                             f"{row['bound_by']} ({row['bound_share']:.1%})")
                if "peak_memory_bytes" in row:
                    extra += (f", peak {row['peak_memory_bytes'] / 2**30:.2f}"
                              f" GiB")
                if "training_draws" in row:
                    extra += f", training draws {row['training_draws']}"
                if "capture" in row:
                    extra += f", capture {row['capture']}"
                timing = (f"{row['ms']:.4f} ms fwd+bwd" if "ms" in row
                          else "not timed")
                log(f"  {row['name']}: {timing}{extra}; gradients "
                    f"{row['grad_rel_err']:.1e} from the CPU's")
                if case.heavy and DEVICE != "cpu":
                    release()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    walls = sorted(rows, key=lambda r: -r.get("wall_s", 0.0))[:8]
    log(f"  the sweep: {len(rows)} runs; every replay bitwise its eager "
        f"run; the longest (wall s, of which the CPU reference) "
        f"{[(r['name'], round(r.get('wall_s', 0), 2), round(r['cpu_s'], 2)) for r in walls]} "
        f"[{card}]")
    return rows


def ae_data():
    """The autoencoder main's data: synthetic MNIST (2048 images), scaled
    to [0, 1] and flattened, input and target alike, batches of 128."""
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.dataset.mnist import load_mnist
    imgs, _ = load_mnist(None, "train", synthetic_size=AE_SYNTHETIC)
    flat = (imgs.astype(np.float32) / 255.0).reshape(len(imgs), -1)
    return (DataSet.array([Sample(x, x) for x in flat])
            >> SampleToMiniBatch(AE_BATCH))


def ae_model(device):
    from bigdl_tpu_torch.models.autoencoder import Autoencoder
    return Autoencoder(AE_BOTTLENECK, generator=_gen(TAIL_SEED),
                       device=device)


def ae_optimizer(model, data):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer
    return (LocalOptimizer(model, data, nn.MSECriterion(), device=DEVICE)
            .set_optim_method(Adam(learningrate=AE_LR)))


def check_ae_step() -> dict:
    """One batch's loss and every gradient on the card against the same
    weights on the CPU (loss 1e-4, gradients 1e-3 relative)."""
    from bigdl_tpu_torch import nn
    batch = next(iter(ae_data().data(train=False)))
    out = {}
    for dev in ("cpu", DEVICE):
        model = ae_model(dev)
        x = torch.as_tensor(batch.input).to(dev)
        loss = nn.MSECriterion()(model(x), x)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (loss.item(), {n: g.cpu() for (n, _), g in zip(
            model.named_parameters(), grads)})
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out[DEVICE]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    grad_rel = max(float((g_card[n] - g).norm() / g.norm())
                   for n, g in g_cpu.items())
    log(f"  autoencoder one step, card against CPU: loss {l_card:.6f} "
        f"({loss_rel:.2e} relative), gradients {grad_rel:.2e} relative")
    if loss_rel > 1e-4 or grad_rel > 1e-3:
        raise CheckFailed(f"the autoencoder step departs from the CPU: loss "
                          f"{loss_rel:.3e}, gradients {grad_rel:.3e}")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel}


def train_ae(kernels, card, bf16=False, profile=True) -> dict:
    """TRAIN_ITERS steps of the autoencoder main's configuration through
    the captured step at fuse 1, each bitwise equal to the same steps run
    eagerly from the same weights (losses and parameters)."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.optim.optim_method import hyper_tensor
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    data = ae_data()
    model = ae_model(DEVICE)
    opt = ae_optimizer(model, data).set_end_when(
        Trigger.max_iteration(TRAIN_ITERS))
    losses, marks, seen = [], [], []
    run_steps = opt._run_steps

    def recorded(steps):
        out = run_steps(steps)
        sync()
        marks.append(time.perf_counter())
        losses.extend(out)
        seen.extend((a.clone(), b.clone()) for a, b in steps)
        return out

    opt._run_steps = recorded
    RandomGenerator.set_seed(SEED)
    sync()
    t0 = time.perf_counter()
    try:
        opt.optimize()
    finally:
        opt._run_steps = run_steps
    what = "bf16" if bf16 else "fp32"
    if len(losses) != TRAIN_ITERS or not all(np.isfinite(losses)):
        raise CheckFailed(f"autoencoder {what} training gave {losses}")
    step_ms = float(statistics.median(np.diff(marks))) * 1e3
    ips = AE_BATCH / step_ms * 1e3
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    prof = timing = None
    if profile and DEVICE != "cpu":
        batch = next(iter(data.data(train=True)))
        prof = profile_step(opt, batch, card)
        dev_ms, host_ms = time_ms(opt._step_program, *TAIL_REPS)
        # the card works dev_ms of each step: the rest of the step is the
        # host's (the graph's launch and the trainer's loop around it)
        timing = {"replay_device_ms": dev_ms, "replay_host_ms": host_ms,
                  "device_share_of_step": dev_ms / step_ms,
                  "paced_by": "host" if dev_ms < step_ms / 2 else "device"}
        log(f"  autoencoder {what}: a replayed step {dev_ms:.4f} ms on the "
            f"device, {host_ms:.4f} ms to launch from the host, in a "
            f"{step_ms:.4f} ms step ({dev_ms / step_ms:.1%} on the device): "
            f"the {timing['paced_by']} sets the pace [{card}]")
    opt._step_program = None
    # the same steps, eagerly, from the same weights
    ref = ae_model(DEVICE)
    ropt = ae_optimizer(ref, DataSet.array([]))
    named, scales, mask = ropt._prepare_step()
    step = ropt._make_step_fn(named, scales, mask)
    ref_losses = [float(step(inp, target, hyper_tensor(
        ropt._method.hyper(k, ropt._ostate), list(named.values()))))
        for k, (inp, target) in enumerate(seen)]
    ref_params = dict(ref.named_parameters())
    bitwise = losses == ref_losses and all(
        torch.equal(p, ref_params[n]) for n, p in params.items())
    log(f"  autoencoder {TRAIN_ITERS} {what} steps at batch {AE_BATCH}: "
        f"losses {[round(v, 5) for v in losses]}; first window (warm-up and "
        f"capture) {(marks[0] - t0) * 1e3:.1f} ms; step {step_ms:.4f} ms, "
        f"{ips:.0f} images/s; replays bitwise the eager steps: {bitwise} "
        f"[{card}]")
    if not bitwise:
        raise CheckFailed(f"autoencoder {what}: the replayed steps are not "
                          f"bitwise equal to the eager ones")
    return {"losses": losses, "step_ms": step_ms, "images_per_s": ips,
            "first_window_ms": (marks[0] - t0) * 1e3, "bitwise": bitwise,
            "replay": timing,
            "profile": None if prof is None else {
                k: prof.get(k) for k in ("busy_ms", "wall_ms", "by_kind_ms",
                                         "host_calls")}}


def tail_path(kernels, card, Engine, Program) -> dict:
    """Phase 16: the layer sweep, then the autoencoder at its main's
    configuration (one-step check, 17 fp32 and 17 bf16 captured steps
    against eager, a profiled step, the main at its defaults)."""
    from bigdl_tpu_torch.models.autoencoder import train as ae_main
    t0 = time.perf_counter()
    out = {"sweep": tail_sweep(card, Program),
           "autoencoder": {"one_step_check": check_ae_step(),
                           "training_fp32": train_ae(kernels, card)}}
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        out["autoencoder"]["training_bf16"] = train_ae(kernels, card,
                                                       bf16=True)
    finally:
        Engine.reset()
    out["autoencoder"]["main"] = run_main(
        ae_main, [] if DEVICE != "cpu" else AE_CPU_ARGV, card, AE_BATCH,
        scored=False)
    ranked = sorted((r for r in out["sweep"] if "bound_share" in r),
                    key=lambda r: r["bound_share"])
    out["farthest_from_bound"] = [
        {k: r[k] for k in ("name", "ms", "bound_ms", "bound_by",
                           "bound_share")} for r in ranked[:5]]
    if DEVICE != "cpu":
        release()
    out["wall_s"] = time.perf_counter() - t0
    log(f"  the five layers farthest from their bound: "
        f"{[(r['name'], round(r['bound_share'], 3)) for r in ranked[:5]]}; "
        f"phase 16 took {out['wall_s']:.1f} s [{card}]")
    return out


AE_CPU_ARGV = ["--device", "cpu", "--synthetic-size", "512", "-b", "64"]


def tail_launches(counts: dict) -> dict:
    """Phase 16's launches of the five kernels: none (the tail is torch
    ops, cuBLAS and cuDNN)."""
    log(f"  phase 16 launched none of the five kernels: {counts}")
    if any(counts.values()):
        raise CheckFailed(f"phase 16 launched the LM kernels {counts}")
    return counts


# --------------------------------------------------------------- phase 17
# NeuralCF at the MLPerf Training v0.5 NCF reference's widths on
# MovieLens-20M: its user and item counts, factors 64 (the GMF tables) and
# MLP layers 256-256-128-64 (two 128-wide tables, then the tower)
RECSYS_SEED = SEED + 70
NCF_USERS, NCF_ITEMS = 138_493, 26_744
NCF_WIDTHS = dict(mf_embed=64, user_embed=128, item_embed=128,
                  hidden_layers=(256, 128, 64))
NCF_BATCH = 65_536
NCF_NEG = 4                   # training negatives a positive
NCF_BATCHES = 4               # distinct training batches, cycled
NCF_STEPS = 20                # timed steps, after the first (the capture)
NCF_LR = 1e-3
NCF_EVAL_USERS = 4096
NCF_EVAL_CANDIDATES = 1000    # the held-out positive and 999 negatives
NCF_EVAL_GROUPS = 64          # groups a batch: 64,000 pairs
NCF_K = 10
NCF_TOL = (1e-5, 1e-4)        # the one-step check: loss, gradients
RANK_REQUESTS, RANK_BATCH, RANK_CLIENTS = 256, 8, 4
KERAS_IMAGES, KERAS_BATCH, KERAS_EPOCHS = 8192, 128, 2
KERAS_TOL = 1e-6              # the Keras LeNet's losses against nn's


def ncf_model(device, hash_buckets=0):
    from bigdl_tpu_torch.models.ncf import NeuralCF
    return NeuralCF(NCF_USERS, NCF_ITEMS, class_num=2,
                    hash_buckets=hash_buckets, sharded=True,
                    generator=_gen(RECSYS_SEED), device=device,
                    **NCF_WIDTHS)


def ncf_data() -> tuple:
    """``(training batches, eval batches)`` as MiniBatches made with numpy
    from the seed: positives from the NCF main's ``synthetic_interactions``
    at MovieLens-20M's counts; the first ``NCF_EVAL_USERS`` users' last
    interaction held out; the rest each with ``NCF_NEG`` uniform negatives,
    shuffled into ``NCF_BATCHES`` batches of ``NCF_BATCH`` 1-based pairs
    (classes 1 and 0); each held-out positive ranked against 999 negatives
    other than it, the positive first in its group."""
    from bigdl_tpu_torch.dataset import MiniBatch
    from bigdl_tpu_torch.models.ncf import train as ncf_main
    n_train = NCF_BATCHES * NCF_BATCH // (1 + NCF_NEG) + 1
    users, items, _, _ = ncf_main.synthetic_interactions(
        NCF_USERS, NCF_ITEMS, n_train + 2 * NCF_EVAL_USERS, seed=RECSYS_SEED)
    last = {}
    for idx, u in enumerate(users):
        last[int(u)] = idx
    held = np.array(sorted(last.values())[:NCF_EVAL_USERS])
    train = np.setdiff1d(np.arange(len(users)), held)[:n_train]
    rng = np.random.default_rng(RECSYS_SEED + 1)
    u, i = users[train], items[train]
    neg = rng.integers(0, NCF_ITEMS, (len(u), NCF_NEG))
    pairs = np.concatenate([
        np.stack([u, i], 1),
        np.stack([np.repeat(u, NCF_NEG), neg.reshape(-1)], 1)]) + 1
    labels = np.concatenate([np.ones(len(u)), np.zeros(len(u) * NCF_NEG)])
    order = rng.permutation(len(pairs))[:NCF_BATCHES * NCF_BATCH]
    pairs = pairs[order].astype(np.int32)
    labels = labels[order].astype(np.int32)
    train_batches = [MiniBatch(pairs[k * NCF_BATCH:(k + 1) * NCF_BATCH],
                               labels[k * NCF_BATCH:(k + 1) * NCF_BATCH])
                     for k in range(NCF_BATCHES)]
    eu, ei = users[held], items[held]
    negs = rng.integers(0, NCF_ITEMS, (len(eu), NCF_EVAL_CANDIDATES - 1))
    while (hit := negs == ei[:, None]).any():
        negs[hit] = rng.integers(0, NCF_ITEMS, int(hit.sum()))
    cands = np.concatenate([ei[:, None], negs], 1) + 1
    eval_pairs = np.stack([np.repeat(eu + 1, NCF_EVAL_CANDIDATES),
                           cands.reshape(-1)], 1).astype(np.int32)
    eval_labels = np.zeros(len(eval_pairs), np.int32)
    eval_labels[::NCF_EVAL_CANDIDATES] = 1
    per = NCF_EVAL_GROUPS * NCF_EVAL_CANDIDATES
    eval_batches = [MiniBatch(eval_pairs[k:k + per], eval_labels[k:k + per])
                    for k in range(0, len(eval_pairs), per)]
    return train_batches, eval_batches


def ncf_optimizer(model, data, device=None, sparse=True):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer
    return (LocalOptimizer(model, data, nn.ClassNLLCriterion(),
                           device=device or DEVICE)
            .set_optim_method(Adam(learningrate=NCF_LR))
            .set_sparse_embeddings(sparse))


def ncf_grads(model, batch, device) -> tuple:
    """The sparse step's loss, dense gradients, row gradients and unique
    ids of one batch (the step function's forward and backward, without
    the update)."""
    from bigdl_tpu_torch.dataset import DataSet
    opt = ncf_optimizer(model, DataSet.array([]), device)
    named, _, _ = opt._prepare_step()
    plan = opt._ostate_plan
    x = torch.as_tensor(batch.input).to(device)
    y = torch.as_tensor(batch.target).to(device)
    deltas = plan.zero_deltas(model, x)
    train = [n for n in named if n not in plan.weight_names()]
    plan.inject(model, deltas)
    try:
        loss, grads = opt._value_and_grad([named[n] for n in train]
                                          + list(deltas.values()), x, y)
        uids = plan.pop_uids(model)
    finally:
        plan.clear(model)
    out = dict(zip(train, grads))
    out.update({f"rows:{k}": g for k, g in zip(deltas, grads[len(train):])})
    return float(loss), {k: g.cpu() for k, g in out.items()}, {
        k: u.cpu() for k, u in uids.items()}


def check_ncf_step(model, batch) -> dict:
    """One full-width sparse step's loss, dense and row gradients and
    unique ids on the card against the same weights on the CPU."""
    cpu = ncf_model("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    l_cpu, g_cpu, u_cpu = ncf_grads(cpu, batch, "cpu")
    l_card, g_card, u_card = ncf_grads(model, batch, DEVICE)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    grad_rel = max(float((g_card[n] - g).norm() / g.norm())
                   for n, g in g_cpu.items())
    same_ids = all(torch.equal(u_card[k], u) for k, u in u_cpu.items())
    n_unique = {k: int((u < cpu.get_submodule(k).table.n_index).sum())
                for k, u in u_cpu.items()}
    log(f"  NCF one sparse step, card against CPU: loss {l_card:.6f} "
        f"({loss_rel:.2e} relative), gradients {grad_rel:.2e} relative "
        f"(dense and rows), unique ids equal: {same_ids} ({n_unique})")
    if loss_rel > NCF_TOL[0] or grad_rel > NCF_TOL[1] or not same_ids:
        raise CheckFailed(f"the NCF step departs from the CPU: loss "
                          f"{loss_rel:.3e}, gradients {grad_rel:.3e}, ids "
                          f"equal {same_ids}")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel,
            "unique_ids": n_unique}


def train_ncf(model, batches, card, sparse=True) -> tuple:
    """1 + NCF_STEPS steps through the trainer's captured step; the step's
    ms is the median between step ends after the first. Returns the
    optimizer, the batches it ran and the numbers."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    opt = ncf_optimizer(model, DataSet.array(batches), sparse=sparse) \
        .set_end_when(Trigger.max_iteration(1 + NCF_STEPS))
    losses, marks, seen = [], [], []
    run_steps = opt._run_steps

    def recorded(steps):
        out = run_steps(steps)
        sync()
        marks.append(time.perf_counter())
        losses.extend(out)
        seen.extend((a.clone(), b.clone()) for a, b in steps)
        return out

    opt._run_steps = recorded
    RandomGenerator.set_seed(RECSYS_SEED)
    sync()
    t0 = time.perf_counter()
    try:
        opt.optimize()
    finally:
        opt._run_steps = run_steps
    what = "sparse" if sparse else "dense"
    if len(losses) != 1 + NCF_STEPS or not all(np.isfinite(losses)):
        raise CheckFailed(f"NCF {what} training gave {losses}")
    if (type(opt._method).__name__ == "SparseEmbeddingUpdate") != sparse:
        raise CheckFailed(f"NCF {what}: the step ran {opt._method!r}")
    step_ms = float(statistics.median(np.diff(marks))) * 1e3
    out = {"losses": losses, "step_ms": step_ms,
           "pairs_per_s": NCF_BATCH / step_ms * 1e3,
           "first_step_ms": (marks[0] - t0) * 1e3}
    log(f"  NCF {what}: {len(losses)} steps at batch {NCF_BATCH}, loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; first step (warm-up and "
        f"capture) {out['first_step_ms']:.1f} ms, step {step_ms:.3f} ms "
        f"({out['pairs_per_s']:.0f} pairs/s) [{card}]")
    return opt, seen, out


RECSYS_KINDS = (("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
                ("sort", ("sort", "radix")),
                ("gather/scatter", ("index", "gather", "scatter",
                                    "embedding")),
                ("cat", ("cat",)),
                ("reduce", ("reduce",)),
                ("elementwise", ("elementwise", "vectorized", "unrolled")))


def replay_ms(opt, batch, what, out, card) -> None:
    """The device and host time of one replay of the step program, and a
    profiled replay by kernel kind (more steps: run it after any
    comparison of the trained state)."""
    if DEVICE == "cpu":
        out["replay_device_ms"] = out["replay_host_ms"] = None
        return
    dev_ms, host_ms = time_ms(opt._step_program, 5, 3)
    out["replay_device_ms"], out["replay_host_ms"] = dev_ms, host_ms
    log(f"  NCF {what}: a replayed step {dev_ms:.4f} ms on the device, "
        f"{host_ms:.4f} ms to launch, in a {out['step_ms']:.3f} ms step "
        f"[{card}]")
    out["profile"] = profile_step(opt, batch, card, RECSYS_KINDS)


def ncf_replays_bitwise(opt, model, seen, losses, card) -> bool:
    """The sparse run's steps again, eagerly (the step function called on
    each recorded batch) from the same initial weights: losses, tables,
    the other parameters and every slot bitwise equal."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim.optim_method import hyper_tensor
    ref = ncf_model(DEVICE)
    ropt = ncf_optimizer(ref, DataSet.array([]))
    named, scales, mask = ropt._prepare_step()
    step = ropt._make_step_fn(named, scales, mask, seen[0][0])
    ref_losses = [float(step(x, y, hyper_tensor(
        ropt._method.hyper(k, ropt._ostate), list(named.values()))))
        for k, (x, y) in enumerate(seen)]
    from bigdl_tpu_torch.optim.optimizer import _tensors_of
    params = dict(model.named_parameters())
    bitwise = (ref_losses == losses and bitwise_equal(
        [params[n] for n in named], list(named.values()))
        and bitwise_equal(_tensors_of(opt._ostate), _tensors_of(ropt._ostate)))
    log(f"  NCF sparse: the {len(seen)} replayed steps bitwise the eager "
        f"ones (losses, parameters, slots): {bitwise} [{card}]")
    if not bitwise:
        raise CheckFailed("NCF sparse: the replayed steps are not bitwise "
                          "equal to the eager ones")
    del ref, ropt, step
    return bitwise


def ncf_eval(model, eval_batches, card) -> dict:
    """HR@10 and NDCG@10 folded on the card over every held-out group, and
    the fold of two batches against the host fold of the same scores."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import NDCG, HitRatio
    from bigdl_tpu_torch.optim.evaluator import run_device_eval
    neg = NCF_EVAL_CANDIDATES - 1
    methods = [HitRatio(NCF_K, neg), NDCG(NCF_K, neg)]
    sync()
    t0 = time.perf_counter()
    (hr, ndcg), stats = run_device_eval(model, DataSet.array(eval_batches),
                                        methods, device=DEVICE)
    sync()
    wall = time.perf_counter() - t0
    (hr_v, n), (ndcg_v, _) = hr.result(), ndcg.result()
    few = eval_batches[:2]
    (hr2, nd2), _ = run_device_eval(model, DataSet.array(few), methods,
                                    device=DEVICE)
    host = [None, None]
    model.eval()
    with torch.no_grad():
        for b in few:
            s = model(torch.as_tensor(b.input).to(DEVICE))[:, -1].cpu()
            for j, m in enumerate(methods):
                r = m.apply(s.numpy(), b.target)
                host[j] = r if host[j] is None else host[j] + r
    model.train()
    fold_ok = (abs(hr2.result()[0] - host[0].result()[0]) <= 1e-12
               and abs(nd2.result()[0] - host[1].result()[0]) <= 1e-9)
    log(f"  NCF eval: HR@{NCF_K} {hr_v:.4f}, NDCG@{NCF_K} {ndcg_v:.4f} over "
        f"{n} users x {NCF_EVAL_CANDIDATES} candidates (uniform "
        f"{NCF_K / NCF_EVAL_CANDIDATES:.4f}) in {wall * 1e3:.1f} ms, "
        f"{stats['fetch_bytes']} bytes fetched; device fold equals the host "
        f"fold on two batches: {fold_ok} [{card}]")
    if n != NCF_EVAL_USERS or not 0 <= hr_v <= 1 or not fold_ok \
            or not np.isfinite(ndcg_v):
        raise CheckFailed(f"NCF eval: HR {hr_v} over {n}, NDCG {ndcg_v}, "
                          f"fold equal {fold_ok}")
    return {"hr": hr_v, "ndcg": ndcg_v, "groups": n, "wall_ms": wall * 1e3,
            "fetch_bytes": stats["fetch_bytes"], "fold_equals_host": fold_ok}


def ranking_run(model, eval_batches, card) -> dict:
    """RANK_REQUESTS requests of NCF_EVAL_CANDIDATES candidates (the held-out
    groups) through a RankingEngine at max_batch RANK_BATCH from
    RANK_CLIENTS threads, after one warm-up request (the capture): one
    program, each order a stable descending sort of the eager model's
    scores at the engine's shape; requests/s and p50/p99 latency."""
    from bigdl_tpu_torch.serving import RankingEngine
    c = NCF_EVAL_CANDIDATES
    pairs = np.concatenate([b.input for b in eval_batches])
    reqs = [(int(pairs[k * c, 0]), pairs[k * c:(k + 1) * c, 1].copy())
            for k in range(RANK_REQUESTS)]
    results = [None] * RANK_REQUESTS
    with RankingEngine(model, max_candidates=c, max_batch=RANK_BATCH) as eng:
        eng.rank(*reqs[0], timeout=600)            # warm-up and capture
        t0 = time.perf_counter()

        def client(j):
            hs = [(k, eng.submit(*reqs[k]))
                  for k in range(j, RANK_REQUESTS, RANK_CLIENTS)]
            for k, h in hs:
                results[k] = h.result(600)

        threads = [threading.Thread(target=client, args=(j,))
                   for j in range(RANK_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        stats = eng.stats()
        captured, replays = eng._program.captured, eng._program.replays
    lat = np.array([r.latency_s for r in results]) * 1e3
    mismatched, max_diff = 0, 0.0
    model.eval()
    with torch.no_grad():
        for (u, items), r in zip(reqs, results):
            batch = np.ones((RANK_BATCH * c, 2), np.int32)
            batch[:c, 0], batch[:c, 1] = u, items
            s = model(torch.from_numpy(batch).to(DEVICE)).reshape(
                RANK_BATCH * c, -1)[:c, -1].cpu().numpy()
            order = np.argsort(-s, kind="stable")
            mismatched += not np.array_equal(r.item_ids, items[order])
            max_diff = max(max_diff, float(np.abs(r.scores - s[order]).max()))
    model.train()
    out = {"requests": RANK_REQUESTS, "candidates": c,
           "max_batch": RANK_BATCH, "requests_per_s": RANK_REQUESTS / wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "ticks": stats["ticks"], "mean_batch_fill":
               stats["mean_batch_fill"], "program_replays": replays,
           "orders_mismatched": mismatched, "max_score_diff": max_diff}
    log(f"  ranking engine: {RANK_REQUESTS} requests of {c} candidates from "
        f"{RANK_CLIENTS} threads in {wall * 1e3:.1f} ms "
        f"({out['requests_per_s']:.1f} requests/s), latency p50 "
        f"{out['p50_ms']:.2f} ms, p99 {out['p99_ms']:.2f} ms, "
        f"{stats['ticks']} ticks (fill {stats['mean_batch_fill']:.2f}); one "
        f"program captured ({captured}, {replays} replays); orders unlike a "
        f"stable sort of the eager scores: {mismatched}, scores within "
        f"{max_diff:.2e} [{card}]")
    if (DEVICE != "cpu" and not captured) \
            or stats["compiled_programs"] != 1 or mismatched:
        raise CheckFailed(f"ranking engine: captured {captured}, "
                          f"{mismatched} orders unlike the eager scores'")
    return out


def widedeep_main(card) -> dict:
    """Wide & Deep's main at its defaults on the card: the held-out
    Top1Accuracy must beat the class prior."""
    from bigdl_tpu_torch.models.widedeep import train as wd_main
    argv = ["--device", "cpu"] if DEVICE == "cpu" else []
    t0 = time.perf_counter()
    acc = wd_main.main(argv)
    wall = time.perf_counter() - t0
    a = wd_main.build_parser().parse_args(argv)
    held = [int(s.label[0]) for s in wd_main.synthetic_tabular(
        a.examples, a.wide_features, a.deep_vocab, a.dense_dim, a.wide_k,
        a.deep_k)[int(0.9 * a.examples):]]
    prior = max(np.mean(held), 1 - np.mean(held))
    log(f"  Wide & Deep main (defaults): held-out Top1 {acc:.4f} against the "
        f"class prior {prior:.4f}, {wall:.2f} s [{card}]")
    if not acc > prior:
        raise CheckFailed(f"Wide & Deep: Top1 {acc} under the prior {prior}")
    return {"top1": acc, "prior": prior, "wall_s": wall}


def ncf_main_run(argv, card) -> dict:
    from bigdl_tpu_torch.models.ncf import train as ncf_main
    t0 = time.perf_counter()
    hr, ndcg = ncf_main.main(argv)
    wall = time.perf_counter() - t0
    a = ncf_main.build_parser().parse_args(argv)
    uniform = a.k / (a.eval_neg_num + 1)
    log(f"  NCF main ({' '.join(argv)}): HR@{a.k} {hr:.4f} against uniform "
        f"{uniform:.4f}, NDCG@{a.k} {ndcg:.4f}, {wall:.2f} s [{card}]")
    if not hr > uniform:
        raise CheckFailed(f"the NCF main {argv}: HR {hr} not above the "
                          f"uniform {uniform}")
    return {"hr": hr, "ndcg": ndcg, "uniform": uniform, "wall_s": wall}


def step_losses(fit):
    """The per-iteration losses that ``fit()`` logs."""
    import logging
    records = []

    class Losses(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("Epoch"):
                records.append(record.args[2])

    logger = logging.getLogger("bigdl_tpu_torch.optim.optimizer")
    handler, level = Losses(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        fit()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return records


def keras_runs(card) -> dict:
    """The Keras LeNet-5 fitted against the same stack of ``nn`` layers from
    the same weights (cuDNN deterministic), then a functional Keras Model
    over ``merge_nodes(mode="concat")``."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.dataset.mnist import load_mnist
    from bigdl_tpu_torch.nn import keras as K
    from bigdl_tpu_torch.nn.keras.topology import merge_nodes
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    imgs, labels = load_mnist(None, "train", synthetic_size=KERAS_IMAGES)
    x = (imgs.astype(np.float32) / 255.0)[:, None]
    y = labels.astype(np.int32)
    torch.manual_seed(RECSYS_SEED)
    km = K.Sequential(device=DEVICE)
    for layer in (K.Convolution2D(6, 5, 5, activation="tanh",
                                  input_shape=(1, 28, 28)),
                  K.MaxPooling2D(), K.Convolution2D(12, 5, 5,
                                                    activation="tanh"),
                  K.MaxPooling2D(), K.Flatten(),
                  K.Dense(100, activation="tanh"),
                  K.Dense(10, activation="softmax")):
        km.add(layer)
    ref = (nn.Sequential()
           .add(nn.Sequential().add(nn.SpatialConvolution(1, 6, 5, 5))
                .add(nn.Tanh()))
           .add(nn.SpatialMaxPooling(2, 2, 2, 2, 0, 0))
           .add(nn.Sequential().add(nn.SpatialConvolution(6, 12, 5, 5))
                .add(nn.Tanh()))
           .add(nn.SpatialMaxPooling(2, 2, 2, 2, 0, 0))
           .add(nn.Reshape([192]))
           .add(nn.Sequential().add(nn.Linear(192, 100)).add(nn.Tanh()))
           .add(nn.Sequential().add(nn.Linear(100, 10)).add(nn.SoftMax())))
    ref.load_state_dict(km._module().state_dict())
    ref.to(DEVICE)
    km.compile("adam", "sparse_categorical_crossentropy")
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        RandomGenerator.set_seed(RECSYS_SEED)
        t0 = time.perf_counter()
        klosses = step_losses(lambda: km.fit(x, y, batch_size=KERAS_BATCH,
                                             nb_epoch=KERAS_EPOCHS))
        kwall = time.perf_counter() - t0
        data = (DataSet.array([Sample(a, b) for a, b in zip(x, y)])
                >> SampleToMiniBatch(KERAS_BATCH))
        opt = (optim.LocalOptimizer(
            ref, data, nn.ClassNLLCriterion(logprob_as_input=False),
            device=DEVICE)
            .set_optim_method(optim.Adam())
            .set_end_when(optim.Trigger.max_epoch(KERAS_EPOCHS)))
        RandomGenerator.set_seed(RECSYS_SEED)
        rlosses = step_losses(opt.optimize)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
    steps = KERAS_EPOCHS * KERAS_IMAGES // KERAS_BATCH
    rel = max(abs(a - b) / abs(b) for a, b in zip(klosses, rlosses))
    acc = km.evaluate(x[:1024], y[:1024], batch_size=KERAS_BATCH)[0]
    log(f"  Keras LeNet-5: {len(klosses)} steps, loss {klosses[0]:.4f} -> "
        f"{klosses[-1]:.4f}, against the nn stack's {rlosses[-1]:.4f} (the "
        f"losses within {rel:.1e} relative, bitwise {klosses == rlosses}), "
        f"Top1 {acc:.4f} on 1,024 training images; fit {kwall:.2f} s "
        f"[{card}]")
    if len(klosses) != steps or len(rlosses) != steps or rel > KERAS_TOL \
            or not klosses[-1] < klosses[0]:
        raise CheckFailed(f"Keras LeNet: {len(klosses)} losses, {rel:.2e} "
                          f"from the nn stack's")
    flat = x.reshape(len(x), -1)
    rows = x.mean(axis=3).reshape(len(x), -1)
    ia, ib = K.Input((784,)), K.Input((28,))
    merged = merge_nodes([K.Dense(64, activation="relu")(ia),
                          K.Dense(16, activation="relu")(ib)],
                         mode="concat")
    fm = K.Model([ia, ib], K.Dense(10, activation="softmax")(merged),
                 device=DEVICE)
    fm.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
    flosses = step_losses(lambda: fm.fit([flat, rows], y,
                                         batch_size=KERAS_BATCH, nb_epoch=1))
    facc = fm.evaluate([flat, rows], y, batch_size=KERAS_BATCH)[0]
    pred = fm.predict([flat[:256], rows[:256]], batch_size=KERAS_BATCH)
    log(f"  functional Keras Model (concat merge of two Dense branches): "
        f"{len(flosses)} steps, loss {flosses[0]:.4f} -> {flosses[-1]:.4f}, "
        f"Top1 {facc:.4f}, predict {pred.shape} [{card}]")
    if not (flosses[-1] < flosses[0] and pred.shape == (256, 10)
            and np.isfinite(pred).all()):
        raise CheckFailed(f"functional Keras Model: losses {flosses[0]} -> "
                          f"{flosses[-1]}, predict {pred.shape}")
    return {"lenet": {"steps": len(klosses), "first_loss": klosses[0],
                      "last_loss": klosses[-1], "max_rel_vs_nn": rel,
                      "bitwise_vs_nn": klosses == rlosses, "top1": acc,
                      "fit_s": kwall},
            "functional": {"steps": len(flosses), "first_loss": flosses[0],
                           "last_loss": flosses[-1], "top1": facc}}


def recsys_path(card) -> dict:
    """Phase 17: NeuralCF at full width (the one-step check, 21 sparse
    steps bitwise against eager, 21 dense steps, the eval, the ranking
    engine), then Wide & Deep's main, the Keras runs and the NCF mains."""
    t0 = time.perf_counter()
    laps = {}
    train_batches, eval_batches = ncf_data()
    laps["data_s"] = time.perf_counter() - t0
    model = ncf_model(DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    tables = sum(p.numel() for n, p in model.named_parameters()
                 if "table" in n)
    log(f"  NeuralCF({NCF_USERS}, {NCF_ITEMS}, {NCF_WIDTHS}): {n_params} "
        f"parameters, {tables} in the four tables; {len(train_batches)} "
        f"batches of {NCF_BATCH} pairs, {len(eval_batches)} eval batches "
        f"({laps['data_s']:.1f} s to make)")
    out = {"parameters": n_params, "table_parameters": tables,
           "one_step_check": check_ncf_step(model, train_batches[0])}
    laps["check_s"] = time.perf_counter() - t0
    opt, seen, out["sparse"] = train_ncf(model, train_batches, card)
    out["sparse"]["bitwise_vs_eager"] = ncf_replays_bitwise(
        opt, model, seen, out["sparse"]["losses"], card)
    replay_ms(opt, train_batches[0], "sparse", out["sparse"], card)
    opt._step_program = None
    del opt, seen
    laps["sparse_s"] = time.perf_counter() - t0
    dense = ncf_model(DEVICE)
    dopt, _, out["dense"] = train_ncf(dense, train_batches, card,
                                      sparse=False)
    replay_ms(dopt, train_batches[0], "dense", out["dense"], card)
    dopt._step_program = None
    del dense, dopt
    if DEVICE != "cpu":
        release()
    log(f"  NCF step: sparse {out['sparse']['step_ms']:.3f} ms against dense "
        f"{out['dense']['step_ms']:.3f} ms "
        f"({out['dense']['step_ms'] / out['sparse']['step_ms']:.2f}x) "
        f"[{card}]")
    laps["dense_s"] = time.perf_counter() - t0
    out["eval"] = ncf_eval(model, eval_batches, card)
    out["ranking"] = ranking_run(model, eval_batches, card)
    laps["serve_s"] = time.perf_counter() - t0
    del model
    out["widedeep_main"] = widedeep_main(card)
    out["keras"] = keras_runs(card)
    laps["keras_s"] = time.perf_counter() - t0
    cpu = ["--device", "cpu"] if DEVICE == "cpu" else []
    out["ncf_main"] = {"sharded": ncf_main_run(["--sharded"] + cpu, card),
                       "hashed": ncf_main_run(["--hash-buckets", "4096"]
                                              + cpu, card)}
    if DEVICE != "cpu":
        release()
    out["wall_s"] = laps["total_s"] = time.perf_counter() - t0
    out["laps_s"] = laps
    log(f"  phase 17 laps {laps}; took {out['wall_s']:.1f} s [{card}]")
    return out


def recsys_launches(counts: dict) -> dict:
    """Phase 17's launches of the five kernels: none (the recsys path and
    the Keras runs are torch ops, cuBLAS and cuDNN)."""
    log(f"  phase 17 launched none of the five kernels: {counts}")
    if any(counts.values()):
        raise CheckFailed(f"phase 17 launched the LM kernels {counts}")
    return counts


# ---------------------------------------------------------------- phase 18
Q_SEED = SEED + 80
Q_BATCH = 256                 # benchmark.py:504-556's int8 leg, ResNet-50
Q_HW, Q_CLASSES = 224, 1000
Q_REPS = (2, 3)               # time_ms's reps and trials of one forward
Q_CHECK_IMAGES = 4            # images of the CPU's int32 check of a conv
Q_MODES = ("dynamic", "weight_only", "static")
Q_TENANTS = ("fp32", "weight_only", "static", "dynamic")
Q_CALIBRATION = 4             # prompts the static tenant calibrates on


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def captured_input(model, module, x, n=None):
    """The input ``module`` gets in ``model``'s forward of ``x`` (its first
    ``n`` rows): ``run`` patched for one call (containers call ``run``, so
    forward hooks never fire)."""
    seen = {}
    run = module.run

    def spy(inp, state=None):
        seen.setdefault("x", inp[:n].detach().clone())
        return run(inp, state)

    module.run = spy
    try:
        with torch.no_grad():
            model(x)
    finally:
        del module.run
    return seen["x"]


def int32_checks(forms, x) -> dict:
    """One QuantizedSpatialConvolution (the first 3x3) and the
    QuantizedLinear of the dynamic ResNet-50 at the path's shapes: the
    card's int32 accumulators against the CPU's, bit for bit."""
    from bigdl_tpu_torch.nn import quantized as tq
    m = forms["dynamic"]
    conv = next(q for q in m.modules()
                if isinstance(q, tq.QuantizedSpatialConvolution)
                and q.kernel_w == 3)
    fc = next(q for q in m.modules() if isinstance(q, tq.QuantizedLinear))
    out = {}
    xc = captured_input(m, conv, x, Q_CHECK_IMAGES)
    x_q, _ = tq._quantize_activation(xc)
    args = conv._conv_args(xc)
    card = tq.int8_conv2d(x_q, conv.weight_q, *args).cpu()
    cpu = tq.int8_conv2d(x_q.cpu(), conv.weight_q.cpu(), *args)
    out["conv"] = {"input": list(xc.shape),
                   "weight": list(conv.weight_q.shape),
                   "bitwise": bool(torch.equal(card, cpu))}
    xf = captured_input(m, fc, x).reshape(x.shape[0], -1)
    f_q, _ = tq._quantize_activation(xf)
    card = tq.int8_matmul(f_q, fc.weight_q).cpu()
    cpu = tq.int8_matmul(f_q.cpu(), fc.weight_q.cpu())
    out["linear"] = {"input": list(xf.shape),
                     "weight": list(fc.weight_q.shape),
                     "bitwise": bool(torch.equal(card, cpu))}
    log(f"  int32 accumulators card vs CPU: conv {out['conv']}, linear "
        f"{out['linear']}")
    if not (out["conv"]["bitwise"] and out["linear"]["bitwise"]):
        raise CheckFailed(f"the card's int32 accumulators differ from the "
                          f"CPU's: {out}")
    return out


def quantized_resnet(card) -> dict:
    """ResNet-50 inference at batch 256: bf16 against ``quantize()``
    dynamic, weight_only and static (calibrated on the batch): images/s,
    weight bytes, top-1 agreement with fp32, and the int32 checks."""
    import copy
    from bigdl_tpu_torch.models.resnet import ResNet50
    from bigdl_tpu_torch.nn import calibrate
    model = ResNet50(Q_CLASSES, generator=torch.Generator().manual_seed(
        Q_SEED), device=DEVICE).evaluate()
    x = torch.randn(Q_BATCH, 3, Q_HW, Q_HW, generator=torch.Generator()
                    .manual_seed(Q_SEED + 1)).to(DEVICE)
    forms = {"fp32": model, "bf16": copy.deepcopy(model).bfloat16()}
    for mode in Q_MODES:
        forms[mode] = model.quantize(mode).evaluate()
    calibrate(forms["static"], [x])
    out = {"batch": Q_BATCH, "int32": int32_checks(forms, x), "forms": {}}
    with torch.no_grad():
        top1 = model(x).argmax(1)
    for name, m in forms.items():
        inp = x.bfloat16() if name == "bf16" else x

        def fwd(m=m, inp=inp):
            with torch.no_grad():
                return m(inp)

        with torch.no_grad():
            y = m(inp)
        if not bool(y.float().isfinite().all()):
            raise CheckFailed(f"ResNet-50 {name}: non-finite outputs")
        ms = time_ms(fwd, *Q_REPS)[0]
        out["forms"][name] = {
            "ms": ms, "images_per_s": Q_BATCH / ms * 1e3,
            "weight_bytes": param_bytes(m),
            "top1_agreement_with_fp32": float(
                (y.float().argmax(1) == top1).float().mean())}
        log(f"  ResNet-50 {name}: {ms:.2f} ms a batch of {Q_BATCH}, "
            f"{Q_BATCH / ms * 1e3:.0f} images/s, weights "
            f"{param_bytes(m) / 2**20:.1f} MiB, top-1 agreement with fp32 "
            f"{out['forms'][name]['top1_agreement_with_fp32']:.4f} [{card}]")
        del y
    del forms, model
    if DEVICE != "cpu":
        release()
    return out


def quantized_tenants(TransformerLM, kernels, card) -> dict:
    """Phase 4's LM served as fp32, weight_only, static and dynamic tenants
    of one SnapshotServer, phase 5's 16 requests each, a round that
    captures and a round of replays, one tenant at a time. Each compared
    tenant's tokens against its own greedy reference (full-sequence
    forwards) under the near-tie rule (NEAR_TIE_INT8 for the static
    tenant); the dynamic tenant, whose scale spans the whole slot grid,
    is timed only. Returns the numbers and the
    launches of the serving rounds (not the references')."""
    from bigdl_tpu_torch.nn import calibrate
    from bigdl_tpu_torch.serving import SnapshotServer
    lm = build_lm(TransformerLM, "auto", DEVICE)
    prompts = serving_prompts()
    tenants = {"fp32": lm}
    for mode in Q_TENANTS[1:]:
        tenants[mode] = lm.quantize(mode).evaluate()
    calibrate(tenants["static"],
              [torch.as_tensor(p[None], dtype=torch.long)
               for p in prompts[:Q_CALIBRATION]])
    srv = SnapshotServer(tenants, max_len=MAX_LEN, slots=SLOTS,
                         device=DEVICE)
    out, rounds = {}, {}
    try:
        for name in Q_TENANTS:
            eng = srv.engine(name)
            first = serve_round(eng, prompts)
            before = eng.stats()
            results, wall = serve_round(eng, prompts)
            rounds[name] = results
            out[name] = report_round(f"{name} tenant (replays)", results,
                                     wall, eng.stats(), before, card)
            out[name]["compiled_programs"] = eng.stats()["compiled_programs"]
            # the dynamic tenant's scale spans the batch, which the
            # arrival order sets: its rounds may differ
            if name != "dynamic" and any(
                    not np.array_equal(a.tokens, b.tokens)
                    for a, b in zip(first[0], results)):
                raise CheckFailed(f"the {name} tenant's two rounds differ")
    finally:
        srv.shutdown()
    launches = kernels.launch_counts()
    for name in Q_TENANTS[:3]:
        m = tenants[name]
        refs = [forward_greedy(m, p, NEW_TOKENS) for p in prompts]
        near_tie = NEAR_TIE_INT8 if name == "static" else NEAR_TIE
        out[name]["near_tie"] = near_tie
        out[name]["parted_near_ties"] = check_near_ties(
            m, f"{name} tenant", [r.tokens for r in rounds[name]], refs,
            [len(p) for p in prompts], near_tie)
    log(f"  the fp32, weight_only and static tenants served their own "
        f"greedy tokens; launches of the rounds {launches}")
    out["weight_bytes"] = {n: param_bytes(m) for n, m in tenants.items()}
    del tenants, lm
    if DEVICE != "cpu":
        release()
    return out, launches


def quantized_path(TransformerLM, kernels, card) -> dict:
    """Phase 18: int8 inference (ResNet-50 at batch 256) and the full-width
    LM served as int8 tenants."""
    t0 = time.perf_counter()
    out = {"resnet50": quantized_resnet(card)}
    resnet_counts = kernels.launch_counts()
    if any(resnet_counts.values()):
        raise CheckFailed(f"the int8 ResNet-50 launched {resnet_counts}")
    out["tenants"], out["launches"] = quantized_tenants(TransformerLM,
                                                        kernels, card)
    if DEVICE != "cpu" and out["launches"]["layer_norm_fwd"] == 0:
        raise CheckFailed("the int8 tenants never launched layer_norm_fwd")
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 18 took {out['wall_s']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------- phase 19
DET_SEED = SEED + 90
SSD_CLASSES, SSD_IMG = 21, 512          # SSD512, VOC's 20 classes + bg
SSD_WIDTHS, SSD_RATIOS = (64, 128, 256), (2.0, 3.0)
SSD_SAMPLES, SSD_SHARDS, SSD_BATCH = 256, 4, 32
SSD_WINDOW, SSD_EPOCHS = 64, 2
SSD_PREEMPT = 12                        # step 4 of epoch 2
SSD_PARITY_BATCH = 2
SSD_SERVE = 32
SSD_TOL = (1e-4, 1e-3)                  # the one-step check: loss, grads
NMS_MARGINS = (1e-5, 1e-6)              # IoU off its threshold, scores apart
MRCNN_CLASSES = 81                      # COCO
MRCNN = dict(image_size=(800, 1344), out_channels=256, post_nms_topn=1000,
             max_per_image=100, box_resolution=7, mask_resolution=14)
MRCNN_GAINS = (1, 2, 4, 8, 16, 32, 64, 128)   # of the class layer


class SSDRecordDecoder:
    """An SSD record: the (1, 5) float32 ground truth, then the (3, H, W)
    uint8 image; decoded to a Sample of the image in [0, 1]."""

    def __call__(self, payload: bytes):
        from bigdl_tpu_torch.dataset import Sample
        gt = np.frombuffer(payload[:20], np.float32).reshape(1, 5).copy()
        img = np.frombuffer(payload[20:], np.uint8).reshape(
            3, SSD_IMG, SSD_IMG).astype(np.float32) / 255.0
        return Sample(img, gt)


def ssd_sample(rng, img):
    """The SSD main's ``make_dataset`` at ``img`` pixels and VOC's 20
    classes, the image stored as uint8: one square a class, its brightness
    the class's."""
    x = rng.rand(3, img, img) * 0.1
    side = rng.randint(img // 8, img // 4)
    y0 = rng.randint(0, img - side)
    x0 = rng.randint(0, img - side)
    cls = rng.randint(1, SSD_CLASSES)
    x[:, y0:y0 + side, x0:x0 + side] = 0.3 + 0.035 * cls
    gt = np.array([[cls, x0 / img, y0 / img, (x0 + side) / img,
                    (y0 + side) / img]], np.float32)
    return np.round(x * 255).astype(np.uint8), gt


def ssd_records(root: Path) -> list:
    from bigdl_tpu_torch.dataset import RecordWriter
    rng = np.random.RandomState(DET_SEED)
    paths = [str(root / f"ssd-{s:02d}.bdlrec") for s in range(SSD_SHARDS)]
    writers = [RecordWriter(p) for p in paths]
    try:
        for i in range(SSD_SAMPLES):
            img, gt = ssd_sample(rng, SSD_IMG)
            writers[i % SSD_SHARDS].write(gt.tobytes() + img.tobytes())
    finally:
        for w in writers:
            w.close()
    return paths


def ssd_model(device):
    from bigdl_tpu_torch.models.ssd import SSD
    return SSD(SSD_CLASSES, img_size=SSD_IMG, base_channels=SSD_WIDTHS,
               aspect_ratios=SSD_RATIOS, generator=torch.Generator()
               .manual_seed(DET_SEED), device=device)


def ssd_batch(n, seed):
    rng = np.random.RandomState(seed)
    dec = SSDRecordDecoder()
    s = [dec(gt.tobytes() + img.tobytes())
         for img, gt in (ssd_sample(rng, SSD_IMG) for _ in range(n))]
    return (torch.from_numpy(np.stack([x.feature[0] for x in s])),
            torch.from_numpy(np.stack([x.label[0] for x in s])))


def check_ssd_step() -> dict:
    """One fp32 step at batch 2: the card's loss and every parameter's
    gradient against the same weights on the CPU (TF32 off)."""
    from bigdl_tpu_torch import nn
    x, y = ssd_batch(SSD_PARITY_BATCH, DET_SEED + 1)
    res = {}
    for dev in ("cpu", DEVICE):
        model = ssd_model(dev)
        loss = nn.MultiBoxCriterion(SSD_CLASSES)(model(x.to(dev)), y.to(dev))
        loss.backward()
        res[dev] = (loss.item(), {n: p.grad.detach().cpu()
                                  for n, p in model.named_parameters()})
    loss_rel = abs(res[DEVICE][0] - res["cpu"][0]) / abs(res["cpu"][0])
    grads = rel_errors(res[DEVICE][1], res["cpu"][1])
    worst = max(grads, key=grads.get)
    log(f"  SSD512 one fp32 step at batch {SSD_PARITY_BATCH}: loss "
        f"{res[DEVICE][0]:.6f} vs CPU {res['cpu'][0]:.6f} (rel "
        f"{loss_rel:.2e}); worst gradient {worst} rel {grads[worst]:.2e}")
    if loss_rel > SSD_TOL[0] or grads[worst] > SSD_TOL[1]:
        raise CheckFailed(f"the SSD step disagrees with the CPU: loss "
                          f"{loss_rel}, {worst} {grads[worst]}")
    return {"loss_rel": loss_rel, "max_grad_rel": grads[worst],
            "worst": worst}


def ssd_run(paths, cache_dir, ckpt=None, plan=None, resume=False) -> dict:
    """Train the SSD512 from the streamed shards under bf16 (Adam, 2
    epochs of 8 steps); ``plan`` a fault plan (a preemption), ``resume``
    from ``ckpt``. Returns the losses, step end times, batches seen (a
    fingerprint a batch), feed stages by epoch and the model."""
    import warnings
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.dataset.profiling import feed_stats
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
    from bigdl_tpu_torch.optim.optimizer import TrainingPreempted
    from bigdl_tpu_torch.utils import faults
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    RandomGenerator.set_seed(DET_SEED)
    ds = DataSet.stream_shards(paths, decoder=SSDRecordDecoder(),
                               shuffle_window=SSD_WINDOW, cache=True,
                               cache_dir=str(cache_dir))
    model = ssd_model(DEVICE)
    opt = (LocalOptimizer(model, ds >> SampleToMiniBatch(SSD_BATCH),
                          nn.MultiBoxCriterion(SSD_CLASSES), device=DEVICE)
           .set_optim_method(Adam(learningrate=1e-3))
           .set_end_when(Trigger.max_epoch(SSD_EPOCHS)))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), Trigger.every_epoch())
    rec = {"losses": [], "ends": [], "batches": [], "epochs": []}
    data, run_steps, place = ds.data, opt._run_steps, opt._place

    def epoch_data(train):
        rec["epochs"].append(feed_stats.snapshot())
        return data(train)

    def recorded(steps):
        got = run_steps(steps)
        rec["losses"].extend(got)
        rec["ends"].append(time.perf_counter())
        return got

    def seen(item, *a, **k):
        rec["batches"].append(batch_fingerprint(item))
        return place(item, *a, **k)

    ds.data, opt._run_steps, opt._place = epoch_data, recorded, seen
    Engine.init(compute_dtype=torch.bfloat16)
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if plan is None:
                opt.optimize(resume="auto" if resume else None)
            else:
                try:
                    with faults.inject_faults(plan):
                        opt.optimize()
                    raise CheckFailed(f"{plan} did not preempt the SSD run")
                except TrainingPreempted:
                    pass
    finally:
        torch.use_deterministic_algorithms(False)
        Engine.reset()
        ds.close()
    rec["wall_s"] = time.perf_counter() - t0
    rec["epochs"].append(feed_stats.snapshot())
    rec["nondeterministic"] = sorted({
        str(w.message).split(" does not have")[0] for w in caught
        if "deterministic" in str(w.message)})
    opt._step_program = None            # its graph and memory pool
    rec["model"] = model
    return rec


def batch_fingerprint(item) -> int:
    """A CRC of a batch's targets and a strided sample of its images."""
    import zlib
    return zlib.crc32(np.ascontiguousarray(np.asarray(item.target)).tobytes(),
                      zlib.crc32(np.ascontiguousarray(
                          np.asarray(item.input)[:, :, ::37, ::41]).tobytes()))


def stage_deltas(a: dict, b: dict) -> dict:
    """``{stage: (ms, count)}`` between two feed_stats snapshots."""
    return {k: ((b[k][0] - a.get(k, (0.0, 0))[0]) * 1e3,
                b[k][1] - a.get(k, (0.0, 0))[1]) for k in b}


def ssd_training(kernels, card, root: Path) -> dict:
    """The streamed SSD512 training: the uninterrupted run, a preemption
    at step 4 of epoch 2 and its resume, one timed fp32 step."""
    from bigdl_tpu_torch.dataset.profiling import STAGE_CACHE, STAGE_DECODE
    t0 = time.perf_counter()
    paths = ssd_records(root)
    shard_bytes = sum(os.path.getsize(p) for p in paths)
    out = {"records_s": time.perf_counter() - t0, "shard_bytes": shard_bytes}
    log(f"  {SSD_SAMPLES} records of {SSD_IMG}x{SSD_IMG} uint8 images in "
        f"{SSD_SHARDS} .bdlrec shards, {shard_bytes / 2**20:.1f} MiB "
        f"({out['records_s']:.1f} s to write)")
    out["one_step_check"] = check_ssd_step()
    ref = ssd_run(paths, root / "cache")
    steps = len(ref["losses"])
    if steps != SSD_EPOCHS * SSD_SAMPLES // SSD_BATCH or not all(
            np.isfinite(ref["losses"])):
        raise CheckFailed(f"the SSD run took {steps} steps, losses "
                          f"{ref['losses']}")
    e1 = stage_deltas(ref["epochs"][0], ref["epochs"][1])
    e2 = stage_deltas(ref["epochs"][1], ref["epochs"][2])
    out["feed"] = {"epoch1": e1, "epoch2": e2}
    log(f"  feed stages (ms, count): epoch 1 {e1}; epoch 2 {e2}")
    if e2.get(STAGE_DECODE, (0, 0))[1] != 0 or \
            e2.get(STAGE_CACHE, (0, 0))[1] != SSD_SAMPLES:
        raise CheckFailed(f"epoch 2 was not served by the cache: {e2}")
    per = np.diff(ref["ends"])[-(steps // 2 - 1):]
    step_ms = float(np.median(per)) * 1e3
    out["bf16"] = {"losses": ref["losses"], "step_ms": step_ms,
                   "images_per_s": SSD_BATCH / step_ms * 1e3,
                   "wall_s": ref["wall_s"],
                   "nondeterministic_ops": ref["nondeterministic"]}
    log(f"  SSD512 bf16 at batch {SSD_BATCH}: {step_ms:.2f} ms a step "
        f"(median of epoch 2), {SSD_BATCH / step_ms * 1e3:.1f} images/s; "
        f"loss {ref['losses'][0]:.4f} -> {ref['losses'][-1]:.4f} [{card}]")
    ckpt = root / "ckpt"
    stopped = ssd_run(paths, root / "cache", ckpt,
                      plan=f"sigterm@{SSD_PREEMPT}")
    resumed = ssd_run(paths, root / "cache", ckpt, resume=True)
    n_after = steps - SSD_PREEMPT
    same_batches = resumed["batches"][-n_after:] == ref["batches"][-n_after:]
    same_losses = resumed["losses"] == ref["losses"][-n_after:]
    named = ref["nondeterministic"] + resumed["nondeterministic"]
    rels = {n: float((p.detach().float() - q.detach().float()).norm()
                     / q.detach().float().norm().clamp(min=1e-30))
            for (n, p), q in zip(resumed["model"].named_parameters(),
                                 ref["model"].parameters())}
    bitwise = all(torch.equal(p, q) for p, q in zip(
        resumed["model"].parameters(), ref["model"].parameters()))
    out["resume"] = {"preempted_at": SSD_PREEMPT,
                     "resumed_steps": len(resumed["losses"]),
                     "same_batches": same_batches,
                     "same_losses": same_losses,
                     "params_bitwise": bitwise,
                     "max_param_rel": max(rels.values()),
                     "nondeterministic_ops": sorted(set(named)),
                     "wall_s": resumed["wall_s"]}
    log(f"  preempted at iteration {SSD_PREEMPT}, resumed "
        f"{len(resumed['losses'])} steps in {resumed['wall_s']:.2f} s: "
        f"{out['resume']} [{card}]")
    if not (same_batches and same_losses and len(resumed["losses"])
            == n_after):
        raise CheckFailed(f"the resume did not replay the same batches: "
                          f"{out['resume']}")
    if not bitwise and (not named or max(rels.values()) > 1e-6):
        raise CheckFailed(f"the resumed parameters differ: {out['resume']}")
    # one timed fp32 step (Engine reset: fp32)
    model = ref["model"]
    del stopped, resumed, ref
    out["fp32_step_ms"] = fp32_ssd_step_ms(card)
    return out, model


def fp32_ssd_step_ms(card) -> float:
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer
    x, y = ssd_batch(SSD_BATCH, DET_SEED + 2)
    x, y = x.to(DEVICE), y.to(DEVICE)
    model = ssd_model(DEVICE)
    opt = LocalOptimizer(model, DataSet.array([]),
                         nn.MultiBoxCriterion(SSD_CLASSES), device=DEVICE) \
        .set_optim_method(Adam(learningrate=1e-3))
    opt.train_step(x, y)                       # the capture
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        opt.train_step(x, y)
    sync()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    log(f"  SSD512 fp32 step at batch {SSD_BATCH}: {ms:.2f} ms, "
        f"{SSD_BATCH / ms * 1e3:.1f} images/s [{card}]")
    opt._step_program = None
    return ms


def margin_mismatches(got, want, thr) -> int:
    """Rows of ``got`` ((..., 6) detections) that differ from ``want``, each
    explained by a near-tie (two scores within NMS_MARGINS[1], or an IoU
    with a detection of its class within NMS_MARGINS[0] of ``thr``); raises
    on a difference that is not. Returns how many were left out."""
    from bigdl_tpu_torch.nn import pairwise_iou
    got = np.asarray(got, np.float64).reshape(-1, got.shape[-2], 6)
    want = np.asarray(want, np.float64).reshape(got.shape)
    left_out = 0
    for g, w in zip(got, want):
        diff = ~np.all(np.isclose(g, w, rtol=1e-5, atol=1e-5), axis=1)
        for i in np.nonzero(diff)[0]:
            others = np.delete(w, i, axis=0)
            tie = np.any(np.abs(others[:, 1] - w[i, 1]) < NMS_MARGINS[1]) \
                or np.any(np.abs(w[:, 1] - g[i, 1]) < NMS_MARGINS[1])
            same = others[others[:, 0] == w[i, 0]]
            near = same.size and bool((pairwise_iou(
                torch.from_numpy(w[i:i + 1, 2:]),
                torch.from_numpy(same[:, 2:])) - thr).abs().min()
                < NMS_MARGINS[0])
            if not (tie or near):
                raise CheckFailed(f"detection {i} differs from the CPU's "
                                  f"with no near-tie: {g[i]} vs {w[i]}")
            left_out += 1
    return left_out


def ssd_serving(model, card) -> dict:
    """The trained SSD behind ``detector`` at the paper's NMS settings on 32
    held-out images (640 NMS rows of K = 400, one launch): the head's
    detections on the card against the CPU's on the same head inputs, and
    ms a batch."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.ssd import detector
    from bigdl_tpu_torch.utils.table import T
    x, _ = ssd_batch(SSD_SERVE, DET_SEED + 3)
    x = x.to(DEVICE)
    serve = detector(model, SSD_CLASSES, keep_topk=200, conf_thresh=0.01)
    dets = serve(x)
    head = nn.DetectionOutputSSD(SSD_CLASSES, keep_topk=200, conf_thresh=0.01)
    with torch.no_grad():
        wire = model(x)
        card_dets = head(wire).cpu()
        cpu_dets = head(T(*(t.cpu() for t in wire.values())))
    if not torch.equal(card_dets, dets.cpu()):
        raise CheckFailed("detector() and the head on the same forward "
                          "disagree on the card")
    left_out = margin_mismatches(card_dets.numpy(), cpu_dets.numpy(), 0.45)
    with nms_unchecked():
        ms = time_ms(lambda: serve(x), 2, 3)[0]
        head_ms = time_ms(lambda: head(wire), 2, 3)[0]
    valid = int((card_dets[..., 0] >= 0).sum())
    log(f"  SSD512 serving: {SSD_SERVE} images, {valid} detections, equal "
        f"to the CPU's but {left_out} near-tie rows; {ms:.2f} ms a batch, "
        f"of which the head (decode, sorts, NMS) {head_ms:.2f} ms [{card}]")
    return {"images": SSD_SERVE, "detections": valid,
            "left_out_near_ties": left_out, "ms_per_batch": ms,
            "head_ms": head_ms, "nms_rows": SSD_SERVE * (SSD_CLASSES - 1),
            "nms_k": 400}


def ssd_main_run(card) -> dict:
    from bigdl_tpu_torch.models.ssd import train as ssd_train
    argv = [] if DEVICE != "cpu" else ["--device", "cpu", "--max-epoch", "2",
                                       "--n-train", "32"]
    t0 = time.perf_counter()
    iou = ssd_train.main(argv)
    wall = time.perf_counter() - t0
    log(f"  SSD main ({' '.join(argv) or 'defaults'}): held-out IoU "
        f"{iou:.3f} in {wall:.1f} s [{card}]")
    if DEVICE != "cpu" and not iou > 0.3:
        raise CheckFailed(f"the SSD main's held-out IoU {iou} <= 0.3")
    return {"iou": iou, "wall_s": wall}


def maskrcnn_run(kernels, Program, card) -> dict:
    """Mask R-CNN at Detectron's R-50-FPN test settings on one seeded image,
    fp32: eager and as a captured program (replay bitwise eager), its
    detections against the CPU's under the margin rule, 4 launches of each
    NMS kernel an image."""
    from bigdl_tpu_torch.models.maskrcnn import MaskRCNN

    def build(device, gain=1.0):
        m = MaskRCNN(MRCNN_CLASSES, **MRCNN, generator=torch.Generator()
                     .manual_seed(DET_SEED + 5), device=device).evaluate()
        with torch.no_grad():
            m[2][2].weight.mul_(gain)
            m[2][2].bias.mul_(gain)
        return m

    h, w = MRCNN["image_size"]
    img = torch.randn(1, 3, h, w, generator=torch.Generator().manual_seed(
        DET_SEED + 6))
    # random class logits barely move off uniform (1/81 < the 0.05 score
    # threshold): scale the class layer by the least gain at which a tenth
    # of the ROIs have a class above 0.1, the same gain on the card and
    # the CPU
    model = build(DEVICE)
    cls = model[2][2]
    feats = captured_input(model, cls, img.to(DEVICE))
    with torch.no_grad():
        logits = torch.nn.functional.linear(feats, cls.weight, cls.bias)
        gain = next((g for g in MRCNN_GAINS if int(
            (torch.softmax(g * logits, -1)[:, 1:] >= 0.1).sum())
            >= feats.shape[0] // 10), MRCNN_GAINS[-1])
        cls.weight.mul_(gain)
        cls.bias.mul_(gain)

    def fn(x):
        with torch.no_grad():
            return tuple(model(x).values())

    x = img.to(DEVICE)
    fn(x)
    sync()
    before = kernels.launch_counts()
    eager = fn(x)
    n_nms = {k: kernels.launch_counts()[k] - before[k] for k in NMS_KERNELS}
    with nms_unchecked():
        eager_ms = time_ms(lambda: fn(x), 2, 3)[0] \
            if DEVICE != "cpu" else None
    out = {"nms_launches_an_image": n_nms, "eager_ms": eager_ms}
    if DEVICE != "cpu":
        prog = Program(("maskrcnn",), fn, (x.clone(),), DEVICE)
        prog()
        replay = [t.clone() for t in prog()]
        out["replay_bitwise"] = all(torch.equal(a, b)
                                    for a, b in zip(replay, eager))
        out["replay_ms"] = time_ms(prog, 2, 3)[0]
        if not (prog.captured and out["replay_bitwise"]):
            raise CheckFailed("the Mask R-CNN replay differs from its eager "
                              "run")
        if set(n_nms.values()) != {4}:
            raise CheckFailed(f"Mask R-CNN launched the NMS kernels {n_nms} "
                              f"times an image, not 4 each")
        del prog
    ref = build("cpu", gain)
    with torch.no_grad():
        cpu = tuple(ref(img).values())
    dets, valid = eager[0].cpu(), eager[1].cpu()
    out["detections"] = int(valid.sum())
    out["left_out_near_ties"] = margin_mismatches(
        dets.numpy()[None], cpu[0].numpy()[None], 0.5)
    out["class_logit_gain"] = gain
    log(f"  Mask R-CNN {MRCNN}: {out['detections']} detections, equal to "
        f"the CPU's but {out['left_out_near_ties']} near-tie rows; eager "
        f"{eager_ms} ms, replay {out.get('replay_ms')} ms, bitwise "
        f"{out.get('replay_bitwise')}; {n_nms} NMS launches [{card}]")
    if out["detections"] == 0:
        raise CheckFailed("Mask R-CNN kept no detection: nothing compared")
    return out


_NMS_CHECKS = {"paused": False}


@contextlib.contextmanager
def nms_unchecked():
    """Time the path without its plain-version checks."""
    _NMS_CHECKS["paused"] = True
    try:
        yield
    finally:
        _NMS_CHECKS["paused"] = False


@contextlib.contextmanager
def nms_checked():
    """Hold every eager ``nms_keep`` call on the card against the plain
    versions on the same inputs (the words bitwise, then the sweep's keep
    bits), and keep the last inputs of each shape for the kernels' timing;
    calls inside a capture are left to the replay checks."""
    import importlib
    mod = importlib.import_module("bigdl_tpu_torch.kernels.nms")
    launch = mod.nms_keep_cuda
    stats = {"checked": 0, "rows": 0, "inputs": {}}

    def checked(boxes, alive, thr):
        if _NMS_CHECKS["paused"] or torch.cuda.is_current_stream_capturing():
            return launch(boxes, alive, thr)
        words = mod.nms_mask_words_cuda(boxes, alive, thr)
        keep = mod.nms_sweep_words_cuda(words, alive)
        if not torch.equal(words, mod.nms_mask_words_reference(boxes, alive,
                                                               thr)):
            raise CheckFailed(f"the NMS words differ from the plain "
                              f"version's at {tuple(boxes.shape)}")
        if not torch.equal(keep, mod.nms_sweep_words_reference(words,
                                                               alive)):
            raise CheckFailed(f"the NMS sweep's keep bits differ from the "
                              f"plain version's at {tuple(boxes.shape)}")
        stats["checked"] += 1
        stats["rows"] += boxes.shape[0]
        stats["inputs"][tuple(boxes.shape[:2])] = (boxes.clone(),
                                                   alive.clone(), thr)
        return keep

    mod.nms_keep_cuda = checked
    try:
        yield stats
    finally:
        mod.nms_keep_cuda = launch


def nms_pairs(boxes, alive, keep, thr) -> tuple:
    """The IoUs this data needs: the words hold one for every pair of alive
    candidates; the greedy pass needs, for each alive candidate i, one
    against each kept j < i up to the first that removes it (all of them
    where i is kept)."""
    from bigdl_tpu_torch.kernels.nms import pairwise_iou
    n = alive.sum(1).double()
    alive_pairs = float((n * (n - 1) / 2).sum())
    k = alive.shape[1]
    idx = torch.arange(k, device=alive.device)
    sup = (pairwise_iou(boxes, boxes).float() > thr) & keep[:, :, None] \
        & (idx[:, None] < idx[None, :])                  # (rows, j, i)
    upto = torch.cumsum(keep.long(), 1)                  # kept j <= this j
    first = torch.where(sup.any(1), sup.int().argmax(1),
                        torch.clamp(idx - 1, min=0)[None])
    need = torch.where(sup.any(1) | (idx > 0)[None],
                       upto.gather(1, first), torch.zeros_like(upto))
    return alive_pairs, float((need * alive).sum())


def nms_bounds(boxes, alive, words, keep, thr) -> dict:
    """Least times on the card (ms, by) for the NMS work of these inputs:
    the words (the boxes and alive flags read and the words written, or
    the IoU arithmetic of every pair of alive candidates at NMS_IOU_OPS
    fp32 operations on FP32_OPS), the sweep (the alive flags read, the keep
    flags written, and the words a kept candidate's row holds from its own
    block on, what the greedy pass must read of this data) and the whole
    function, sorted boxes to keep flags (boxes, alive and keep flags, or
    the IoUs the greedy pass needs of this data, ``nms_pairs``)."""
    rows, k = alive.shape
    w = words.shape[-1]
    alive_pairs, greedy_pairs = nms_pairs(boxes, alive, keep, thr)
    flags = 2 * rows * k
    blocks = torch.arange(k, device=keep.device) // 64
    read = float(((w - blocks) * keep).sum()) * 8

    def ops_ms(pairs):
        return pairs * NMS_IOU_OPS / FP32_OPS * 1e3

    def larger(nbytes, t_ops):
        t = nbytes / HBM_BYTES_PER_S * 1e3
        return (t, "bytes") if t >= t_ops else (t_ops, "operations")
    return {"words": larger(boxes.numel() * 4 + rows * k + words.numel() * 8,
                            ops_ms(alive_pairs)),
            "sweep": larger(flags + read, 0.0),
            "keep": larger(boxes.numel() * 4 + flags, ops_ms(greedy_pairs)),
            "alive_pairs": alive_pairs, "greedy_pairs": greedy_pairs,
            "all_pairs": rows * k * (k - 1) / 2}


def peak_mib(fn) -> float:
    """Device memory one call of ``fn`` allocates at its peak, beyond what
    was allocated before it (MiB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def nms_rows(kernels, inputs: dict, card) -> list:
    """The NMS kernels at the path's shapes, on the path's own inputs: the
    words, the sweep and ``nms_keep`` (both) each beside its bound and its
    plain version; the old path's plain version (the IoU tensor and its
    sweep), the card's ``pairwise_iou`` alone (``iou_ms``, what the old
    path formed before its sweep) and ``nms_keep``'s peak device memory.
    No PyTorch call computes the greedy sweep (``library_ms`` null)."""
    from bigdl_tpu_torch.kernels.nms import pairwise_iou
    rows = []
    for (r, k), (boxes, alive, thr) in sorted(inputs.items()):
        words = kernels.nms_mask_words_cuda(boxes, alive, thr)
        keep = kernels.nms_sweep_words_cuda(words, alive)
        want = kernels.nms_keep_reference(boxes, alive, thr)
        bad = int((words != kernels.nms_mask_words_reference(
            boxes, alive, thr)).sum()) + int((keep != want).sum())
        if bad:
            raise CheckFailed(f"the NMS kernels at ({r}, {k}): {bad} words "
                              f"and keep flags differ from the plain "
                              f"versions'")
        bounds = nms_bounds(boxes, alive, words, keep, thr)
        t = {"words_ms": lambda: kernels.nms_mask_words_cuda(boxes, alive,
                                                             thr),
             "sweep_ms": lambda: kernels.nms_sweep_words_cuda(words, alive),
             "ms": lambda: kernels.nms_keep_cuda(boxes, alive, thr),
             "iou_ms": lambda: pairwise_iou(boxes, boxes).float()}
        row = {"rows": r, "k": k, **{n: time_ms(f, 5, 3)[0]
                                     for n, f in t.items()}}
        plain = {"words_plain_ms": lambda: kernels.nms_mask_words_reference(
                     boxes, alive, thr),
                 "sweep_plain_ms": lambda: kernels.nms_sweep_words_reference(
                     words, alive),
                 "plain_ms": lambda: kernels.nms_keep_reference(boxes, alive,
                                                                thr)}
        row.update({n: time_ms(f, 1, 3)[0] for n, f in plain.items()})
        row.update({"bound_ms": bounds["keep"][0],
                    "bound_by": bounds["keep"][1],
                    "words_bound_ms": bounds["words"][0],
                    "words_bound_by": bounds["words"][1],
                    "sweep_bound_ms": bounds["sweep"][0],
                    "sweep_bound_by": bounds["sweep"][1],
                    **{n: bounds[n] for n in ("alive_pairs", "greedy_pairs",
                                              "all_pairs")},
                    "peak_mib": peak_mib(
                        lambda: kernels.nms_keep_cuda(boxes, alive, thr)),
                    "library_ms": None, "max_abs_err": float(bad),
                    "kept": int(keep.sum()), "alive": int(alive.sum())})
        log(f"  nms_keep ({r}, {k}): {row['ms']:.4f} ms (words "
            f"{row['words_ms']:.4f}, sweep {row['sweep_ms']:.4f}), bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}; words "
            f"{row['words_bound_ms']:.5f} {row['words_bound_by']}, sweep "
            f"{row['sweep_bound_ms']:.5f}); IoUs needed {row['greedy_pairs']:.0f}"
            f" (greedy), {row['alive_pairs']:.0f} (alive pairs) of "
            f"{row['all_pairs']:.0f}; plain {row['plain_ms']:.3f} ms (words "
            f"{row['words_plain_ms']:.3f}, sweep {row['sweep_plain_ms']:.3f})"
            f"; the card's pairwise_iou alone {row['iou_ms']:.4f} ms; peak "
            f"{row['peak_mib']:.3f} MiB; {row['kept']} kept of "
            f"{row['alive']} alive [{card}]")
        rows.append(row)
    return rows


def detection_path(kernels, card, Program) -> dict:
    """Phase 19: the streamed SSD512 training, its serving, the SSD main and
    Mask R-CNN. Returns the numbers, the path's launches and the NMS
    kernel's rows (timed after the launches are read)."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="bigdl-phase19-",
                                 dir=work_root()))
    out = {}
    try:
        with nms_checked() as checked:
            out["ssd"], model = ssd_training(kernels, card, root)
            out["ssd"]["serving"] = ssd_serving(model, card)
            del model
            if DEVICE != "cpu":
                release()
            out["ssd_main"] = ssd_main_run(card)
            out["maskrcnn"] = maskrcnn_run(kernels, Program, card)
            out["launches"] = kernels.launch_counts()
        out["nms_checked"] = {k: checked[k] for k in ("checked", "rows")}
        log(f"  every eager NMS call's words and keep bits held against the "
            f"plain versions: {out['nms_checked']}; launches "
            f"{out['launches']}")
        idle = [k for k in NMS_KERNELS if out["launches"][k] == 0]
        if DEVICE != "cpu" and idle:
            raise CheckFailed(f"phase 19 never launched {idle}")
        lm = {k: n for k, n in out["launches"].items()
              if k not in NMS_KERNELS}
        if any(lm.values()):
            raise CheckFailed(f"phase 19 launched the LM kernels {lm}")
        out["nms_rows"] = nms_rows(kernels, checked["inputs"], card) \
            if DEVICE != "cpu" else []
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if DEVICE != "cpu":
        release()
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 19 took {out['wall_s']:.1f} s [{card}]")
    return out


def nms_table_rows(detection: dict, paths: dict, src: str) -> list:
    """The NMS kernels' rows of the kernel table: the SSD serving shape
    (640 rows of K = 400) as their main instance, every path shape beside
    (``nms_keep``, both launches, in the sweep's row)."""
    rows = detection["nms_rows"]
    main = next(r for r in rows if r["k"] == 400)
    common = {"route": "cuda", "source": src + "nms.cu",
              "shape": [main["rows"], main["k"], 4], "dtype": "float32",
              "max_abs_err": main["max_abs_err"], "library_ms": None,
              "checked_calls": detection["nms_checked"]}
    return [
        dict(common, name="nms_mask_words",
             replaces="none: pairwise_iou and the suppression test of "
                      "bigdl_tpu/nn/detection.py:56 (nms_mask), no Pallas "
                      "kernel",
             launches=detection["launches"]["nms_mask_words"],
             ms=main["words_ms"], plain_ms=main["words_plain_ms"],
             bound_ms=main["words_bound_ms"],
             bound_by=main["words_bound_by"],
             paths=paths["nms_mask_words"],
             design="CTAs over (row, 64-block of j, 64-block of i >= j's), "
                    "64 threads; the alive i boxes and areas in shared "
                    "memory; thread j writes one 64-bit word of IoU > thr "
                    "bits of alive pairs, each IoU step a separately "
                    "rounded fp32 op; dead candidates' IoUs never computed"),
        dict(common, name="nms_sweep",
             replaces="none: the greedy pass of bigdl_tpu/nn/detection.py:"
                      "56 (nms_mask's lax.fori_loop), no Pallas kernel",
             launches=detection["launches"]["nms_sweep"],
             ms=main["sweep_ms"], plain_ms=main["sweep_plain_ms"],
             bound_ms=main["sweep_bound_ms"],
             bound_by=main["sweep_bound_by"],
             paths=paths["nms_sweep"], shapes=rows,
             design="one warp a row, the removed bits in shared memory; "
                    "a 64-block's candidates resolved in registers from "
                    "their diagonal words, then the kept rows' later words "
                    "ORed across lanes; W block steps, no block barrier"),
    ]


# ----------------------------------------------------------------- phase 20
# the folder-backed image pipeline at full width: a synthetic ImageNet
# folder of 280 x 280 PNGs (crop 224 + 56, what imagenet_sets writes), and
# one of the 500 x 375 fixture JPEG, four batches of 256 an epoch, two
# epochs a run; CIFAR-10's binary batches and MNIST's idx files in their
# real formats
IMG_CLASSES, IMG_PER_CLASS, IMG_SIDE, IMG_BATCH = 4, 256, 280, 256
RESNET_IMG_ARGV = ["--dataset", "ImageNet", "--depth", "50", "--classes",
                   "1000"]
IMG_EPOCHS = 1
CIFAR_PER_FILE, MNIST_TRAIN, MNIST_TEST, SMALL_BATCH = 1024, 6144, 1024, 128
DECODE_REPS = 200          # decodes a rate, one thread (the pool: x threads)


def fixture_decodes(codec, fixtures: Path) -> dict:
    """Every fixture decoded by the port against the SHA-256 and shape of
    PIL's decode recorded beside it."""
    import hashlib
    table = json.loads((fixtures / "fixtures.json").read_text())
    for name, want in sorted(table.items()):
        arr = codec.decode((fixtures / name).read_bytes())
        got = hashlib.sha256(arr.tobytes()).hexdigest()
        if list(arr.shape) != want["shape"] or got != want["sha256"]:
            raise CheckFailed(f"the codec's decode of {name} differs from "
                              f"PIL's ({list(arr.shape)}, {got[:12]})")
    log(f"  {len(table)} fixtures decode bitwise PIL's")
    return {"fixtures": len(table), "bitwise": True}


def decode_rates(codec, fixtures: Path, card) -> dict:
    """Images/s of the codec on one thread and on a pool of one thread a
    CPU: a 500 x 375 4:2:0 JPEG (ImageNet's typical shape) and a 280 x 280
    PNG (the synthetic folder's); and the pipeline's 280 → 256 resize."""
    from concurrent.futures import ThreadPoolExecutor
    threads = os.cpu_count() or 1
    png = codec.encode_png(np.random.default_rng(SEED).integers(
        0, 256, (IMG_SIDE, IMG_SIDE, 3), dtype=np.uint8))
    out = {"threads": threads}
    for name, data in (
            ("jpeg_500x375_420", (fixtures / "jpeg_420_500x375.jpg")
             .read_bytes()),
            ("png_280x280", png)):
        codec.decode(data)
        t0 = time.perf_counter()
        for _ in range(DECODE_REPS):
            codec.decode(data)
        one = DECODE_REPS / (time.perf_counter() - t0)
        with ThreadPoolExecutor(threads) as ex:
            list(ex.map(codec.decode, [data] * threads))
            t0 = time.perf_counter()
            list(ex.map(codec.decode, [data] * (DECODE_REPS * threads)))
            pool = DECODE_REPS * threads / (time.perf_counter() - t0)
        out[name] = {"bytes": len(data), "one_thread_images_per_s": one,
                     "pool_images_per_s": pool}
        log(f"  decode {name} ({len(data)} bytes): {one:.1f} images/s on "
            f"one thread, {pool:.1f} on {threads} [{card}]")
    img = codec.decode(png)
    t0 = time.perf_counter()
    for _ in range(DECODE_REPS):
        codec.resize_bilinear(img, 256, 256)
    out["resize_280_to_256_per_s"] = DECODE_REPS / (time.perf_counter() - t0)
    log(f"  resize 280x280 -> 256x256: {out['resize_280_to_256_per_s']:.1f} "
        f"images/s on one thread [{card}]")
    return out


def copy_jpeg_folder(fixtures: Path, root: Path) -> str:
    """An ImageNet-layout folder of the 500 x 375 4:2:0 fixture JPEG,
    ``IMG_PER_CLASS`` copies in each of ``IMG_CLASSES`` classes."""
    import shutil
    src = fixtures / "jpeg_420_500x375.jpg"
    for c in range(IMG_CLASSES):
        cdir = root / f"class_{c:03d}"
        cdir.mkdir(parents=True)
        for i in range(IMG_PER_CLASS):
            shutil.copyfile(src, cdir / f"img_{i:04d}.jpg")
    return str(root)


def write_cifar_bins(root: Path) -> str:
    """CIFAR-10's binary layout: five train batches and a test batch of
    ``CIFAR_PER_FILE`` records (a label byte, 3072 pixel bytes)."""
    rng = np.random.default_rng(SEED + 20)
    root.mkdir(parents=True, exist_ok=True)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + \
            ["test_batch.bin"]:
        raw = rng.integers(0, 256, (CIFAR_PER_FILE, 3073), dtype=np.uint8)
        raw[:, 0] %= 10
        raw.tofile(root / name)
    return str(root)


def write_mnist_idx(root: Path) -> str:
    """MNIST's idx files, gzipped: class prototypes plus noise."""
    import gzip
    import struct
    rng = np.random.default_rng(SEED + 21)
    protos = rng.integers(0, 256, (10, 28, 28))
    root.mkdir(parents=True, exist_ok=True)
    for split, n in (("train", MNIST_TRAIN), ("t10k", MNIST_TEST)):
        labels = rng.integers(0, 10, n)
        imgs = np.clip(protos[labels] + rng.integers(-40, 40, (n, 28, 28)),
                       0, 255)
        for kind, arr in (("images-idx3", imgs), ("labels-idx1", labels)):
            with gzip.open(root / f"{split}-{kind}-ubyte.gz", "wb") as f:
                f.write(struct.pack(">I", 0x800 | arr.ndim))
                f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
                f.write(arr.astype(np.uint8).tobytes())
    return str(root)


def folder_main_run(module, argv, name, batch, root: Path, card,
                    run=None) -> dict:
    """One training main through the entry point: its per-step losses (the
    train summary's: the main writes them under ``name``, into a folder of
    ``run``, default ``name``), step ms (``train/step_wall`` after the
    first), images/s, the loop's feed wait a step and the feed's stage
    ms."""
    from bigdl_tpu_torch.obs.registry import registry
    from bigdl_tpu_torch.visualization import TrainSummary
    summaries = root / f"tb_{run or name}"
    hist = registry.histogram("train/step_wall")
    n0 = hist.count
    waits = feed_waits()
    t0 = time.perf_counter()
    opt = module.main(argv + ["--device", DEVICE, "--summary-dir",
                              str(summaries)])
    sync()
    wall = time.perf_counter() - t0
    waits = waits()
    losses = [v for _, v, _ in TrainSummary(str(summaries), name)
              .read_scalar("Loss")]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise CheckFailed(f"the {name} main's losses {losses}")
    steps = hist.count - n0
    walls = list(hist._window)[-steps:][1:] if steps > 1 else []
    step_ms = float(np.median(walls)) * 1e3 if walls else None
    stack = (waits.get("stack") or {}).get("median_ms")
    wait = (waits.get("wait") or {}).get("median_ms")
    out = {"steps": steps, "first_loss": losses[0], "last_loss": losses[-1],
           "step_ms": step_ms,
           # after the first step: the loop's wait on the feed under 5% of
           # the step (the producer's host work can still slow the step:
           # compare the runs' step ms)
           "stack_ms_a_batch": stack,
           "feed_keeps_up": bool(step_ms and wait is not None
                                 and wait < 0.05 * step_ms),
           "images_per_s": batch / step_ms * 1e3 if step_ms else None,
           "feed_wait_ms_per_step": opt.metrics.totals().get("feed", 0.0)
           / max(steps, 1) * 1e3,
           "feed_wait_after_first": waits,
           "feed_stage_ms": dict(opt.feed_stage_ms),
           "top1": opt.state.get("score"), "wall_s": wall}
    log(f"  {name}: {steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"step {step_ms if step_ms is None else round(step_ms, 2)} ms "
        f"(median after the first), "
        f"{out['images_per_s'] and round(out['images_per_s'], 1)} images/s,"
        f" feed wait {out['feed_wait_ms_per_step']:.2f} ms a step (median "
        f"after the first {wait}; a batch's stack {stack} ms: no wait "
        f"{out['feed_keeps_up']}), stages "
        f"{ {k: round(v, 3) for k, v in out['feed_stage_ms'].items()} }, "
        f"wall {wall:.1f} s [{card}]")
    return out, opt


def resnet_in_memory(card) -> dict:
    """The ResNet main's model, criterion and SGD on two in-memory batches
    of the folder runs' shape, 8 steps: the step with no decode or augment
    beside it (the batches cached on the card), the folder runs'
    yardstick."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, MiniBatch
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.obs.registry import registry
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    r = np.random.default_rng(SEED + 23)
    classes = int(RESNET_IMG_ARGV[RESNET_IMG_ARGV.index("--classes") + 1])
    depth = int(RESNET_IMG_ARGV[RESNET_IMG_ARGV.index("--depth") + 1])
    batches = [MiniBatch(r.standard_normal((IMG_BATCH, 3, 224, 224),
                                           dtype=np.float32),
                         r.integers(0, classes, IMG_BATCH).astype(np.int32))
               for _ in range(2)]
    model = ResNet(classes, {"depth": depth, "dataSet": "ImageNet"},
                   generator=torch.Generator().manual_seed(0), device=DEVICE)
    opt = (LocalOptimizer(model, DataSet.array(batches * 4),
                          nn.ClassNLLCriterion(), device=DEVICE)
           .set_optim_method(SGD(learningrate=0.1, momentum=0.9,
                                 weightdecay=1e-4, nesterov=True,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(8)))
    hist = registry.histogram("train/step_wall")
    n0 = hist.count
    opt.optimize()
    sync()
    walls = list(hist._window)[-(hist.count - n0):][1:]
    step_ms = float(np.median(walls)) * 1e3
    log(f"  ResNet-{depth} in memory: step {step_ms:.2f} ms (median after "
        f"the first), {IMG_BATCH / step_ms * 1e3:.1f} images/s [{card}]")
    return {"steps": len(walls) + 1, "step_ms": step_ms,
            "images_per_s": IMG_BATCH / step_ms * 1e3}


def verdict(config, folder, batch, extra=()) -> dict:
    from bigdl_tpu_torch.convergence import converge
    v = converge(config, folder, epochs=1, batch_size=batch, device=DEVICE,
                 extra=tuple(extra))
    log(f"  converge {config}: {json.dumps(v)}")
    if set(v) != {"config", "metric", "value", "target", "achieved",
                  "synthetic", "epochs", "batch"} or v["synthetic"]:
        raise CheckFailed(f"converge {config}: {v}")
    return v


def same_forward(name, build, x, root: Path, card) -> dict:
    """``save_module`` then ``load_module`` of ``build()``; the reloaded
    module's forward equals the saved one's bitwise."""
    from bigdl_tpu_torch import nn
    model = build()
    n_params = sum(p.numel() for p in model.parameters())
    path = root / f"{name}.bdlm"
    t0 = time.perf_counter()
    model.save_module(str(path))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = nn.AbstractModule.load_module(str(path), DEVICE)
    sync()
    load_s = time.perf_counter() - t0
    model.eval()
    again.eval()
    with torch.no_grad():
        a, b = model(x), again(x)
    if not torch.equal(a, b):
        raise CheckFailed(f"{name} reloaded from its file: forward differs "
                          f"by {float((a - b).abs().max())}")
    out = {"params": n_params, "bytes": path.stat().st_size,
           "save_s": save_s, "load_s": load_s, "forward_bitwise": True}
    log(f"  {name}: {n_params} parameters, {out['bytes']} bytes, save "
        f"{save_s:.2f} s, load {load_s:.2f} s, forward bitwise [{card}]")
    return out


def images_path(kernels, card, repo: Path) -> dict:
    """Phase 20: the codec, the ImageNet folder path at full width, CIFAR-10
    and MNIST files, module save and load. The kernels' launches are read
    after the path and before the LM's reload check (counted apart)."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.dataset.image_folder import (
        write_synthetic_image_folder,
    )
    from bigdl_tpu_torch.models.lenet import train as lenet_main
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.models.resnet import train as resnet_main
    from bigdl_tpu_torch.models.transformerlm import TransformerLM
    from bigdl_tpu_torch.models.vgg import train as vgg_main
    from bigdl_tpu_torch.transform.vision import codec
    from bigdl_tpu_torch.utils import file as ufile
    from bigdl_tpu_torch.utils.engine import Engine

    t_phase = time.perf_counter()
    fixtures = repo / "tests" / "torch_image_fixtures"
    root = Path(tempfile.mkdtemp(prefix="bigdl-phase20-",
                                 dir=work_root()))
    out = {}
    try:
        Path(codec._SO).unlink(missing_ok=True)    # time a build
        codec.build()
        out["codec_build_s"] = codec.build_seconds
        log(f"  built the codec (g++ -O3 -ffp-contract=off) in "
            f"{codec.build_seconds:.2f} s")
        out["fixtures"] = fixture_decodes(codec, fixtures)
        out["decode"] = decode_rates(codec, fixtures, card)

        t0 = time.perf_counter()
        folder = write_synthetic_image_folder(
            str(root / "imagenet"), n_classes=IMG_CLASSES,
            n_per_class=IMG_PER_CLASS, size=IMG_SIDE, seed=SEED)
        out["imagenet_folder"] = {"images": IMG_CLASSES * IMG_PER_CLASS,
                                  "side": IMG_SIDE,
                                  "write_s": time.perf_counter() - t0}
        log(f"  wrote {IMG_CLASSES * IMG_PER_CLASS} PNGs of {IMG_SIDE} px "
            f"in {out['imagenet_folder']['write_s']:.1f} s")
        Engine.init(compute_dtype=torch.bfloat16)
        try:
            argv = RESNET_IMG_ARGV + ["-b", str(IMG_BATCH), "--folder",
                                      folder, "--max-epoch", str(IMG_EPOCHS)]
            out["resnet50_imagenet"] = {}
            for workers in ("0", "auto"):
                os.environ["BIGDL_DATA_WORKERS"] = workers
                try:
                    out["resnet50_imagenet"][f"data_workers_{workers}"], _ = \
                        folder_main_run(resnet_main, argv, "resnet", IMG_BATCH,
                                 root, card + f", bf16, data workers "
                                 f"{workers}", run=f"resnet_{workers}")
                finally:
                    os.environ.pop("BIGDL_DATA_WORKERS", None)
                release()
            # ImageNet's own traffic: 500 x 375 4:2:0 JPEGs, each decoded
            # and resized (to 341 x 256) anew, on the parallel engine
            jpeg_folder = copy_jpeg_folder(fixtures, root / "imagenet_jpeg")
            os.environ["BIGDL_DATA_WORKERS"] = "auto"
            try:
                out["resnet50_imagenet"]["jpeg_500x375_data_workers_auto"], \
                    _ = folder_main_run(
                        resnet_main, RESNET_IMG_ARGV + [
                            "-b", str(IMG_BATCH), "--folder", jpeg_folder,
                            "--max-epoch", str(IMG_EPOCHS)], "resnet",
                        IMG_BATCH, root, card + ", bf16, 500 x 375 JPEGs, "
                        "data workers auto", run="resnet_jpeg")
            finally:
                os.environ.pop("BIGDL_DATA_WORKERS", None)
            release()
            out["resnet50_imagenet"]["in_memory"] = resnet_in_memory(
                card + ", bf16")
            release()
            out["converge_resnet50"] = verdict(
                "resnet50", folder, IMG_BATCH, RESNET_IMG_ARGV)
        finally:
            Engine.init()
        release()

        cifar_dir = write_cifar_bins(root / "cifar")
        mnist_dir = write_mnist_idx(root / "mnist")
        out["vgg16_cifar10"], _ = folder_main_run(
            vgg_main, ["-b", str(SMALL_BATCH), "--folder", cifar_dir], "vgg",
            SMALL_BATCH, root, card)
        out["lenet5_mnist"], lenet = folder_main_run(
            lenet_main, ["-b", str(SMALL_BATCH), "--folder", mnist_dir],
            "lenet", SMALL_BATCH, root, card)
        out["converge_lenet"] = verdict("lenet", mnist_dir, SMALL_BATCH)
        out["converge_vgg16"] = verdict("vgg16", cifar_dir, SMALL_BATCH)
        release()

        # module save and load; the LeNet main from the files saved here
        lenet.model.save_module(str(root / "lenet.bdlm"))
        ufile.save(lenet.optim_method, str(root / "lenet_sgd.obj"))
        out["lenet_from_snapshots"], _ = folder_main_run(
            lenet_main, ["-b", str(SMALL_BATCH), "--folder", mnist_dir,
                         "--model-snapshot", str(root / "lenet.bdlm"),
                         "--state-snapshot", str(root / "lenet_sgd.obj")],
            "lenet", SMALL_BATCH, root / "again", card)
        if out["lenet_from_snapshots"]["first_loss"] >= \
                out["lenet5_mnist"]["first_loss"]:
            raise CheckFailed("the LeNet main resumed from its snapshot "
                              "started no lower than the fresh run")
        g = torch.Generator().manual_seed(SEED + 22)
        with cudnn_deterministic():
            out["save_load"] = {"resnet50": same_forward(
                "resnet50", lambda: ResNet(
                    1000, {"depth": 50, "dataSet": "ImageNet"},
                    generator=torch.Generator().manual_seed(SEED),
                    device=DEVICE),
                torch.randn(16, 3, 224, 224, generator=g).to(DEVICE),
                root, card)}
            out["launches"] = kernels.launch_counts()   # the path's, to here
            with apart("references") as lm_check:
                out["save_load"]["transformerlm"] = same_forward(
                    "transformerlm",
                    lambda: build_lm(TransformerLM, "auto", DEVICE),
                    torch.randint(0, VOCAB, (2, 512), generator=g).to(DEVICE),
                    root, card)
        out["reference_launches"] = dict(lm_check)
        log(f"  launches on the path {out['launches']} (the LM reload's "
            f"forward check, counted apart: {out['reference_launches']})")
        if any(out["launches"].values()):
            raise CheckFailed(f"phase 20 launched {out['launches']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        release()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 20 took {out['wall_s']:.1f} s [{card}]")
    return out


# ----------------------------------------------------------------- phase 21
DISTRI_STEPS = 6                 # a few steps a sync mode (the capture first)
DISTRI_MODES = ("allreduce", "zero1", "fsdp")
# bigdl_tpu/dryrun.py:14's entry model: TransformerLM(1024, 256, 4, 2, 256)
DRYRUN_LM = dict(vocab=1024, embed=256, heads=4, layers=2, max_len=256)
COLLECTIVE_KINDS = (("collectives", ("nccl",)),) + KERNEL_KINDS


def distri_lm_data(vocab, seq, batch, steps, seed):
    from bigdl_tpu_torch.dataset import (
        DataSet, Sample, SampleToMiniBatch, ptb_windows, synthetic_ptb,
    )
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    RandomGenerator.set_seed(seed)
    ids = synthetic_ptb(batch * steps * seq + 1, vocab_size=vocab)
    xs, ys = ptb_windows(ids, seq)
    return (DataSet.array((Sample(x, y) for x, y in zip(xs, ys)),
                          distributed=True) >> SampleToMiniBatch(batch))


def distri_lm_run(TransformerLM, lm_criterion, kernels, card, widths, seq,
                  batch, sync, profile=False):
    """``steps`` Adam steps of a TransformerLM of ``widths`` (vocab,
    embed, heads, layers) by ``DistriOptimizer(parameter_sync=sync)`` (or
    ``LocalOptimizer`` for ``sync=None``) over the one-rank NCCL mesh:
    losses, step ms (median after the capture), launches, and the final
    parameters."""
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    vocab, embed, heads, layers = widths
    lm = TransformerLM(vocab, embed, heads, layers, seq,
                       generator=torch.Generator().manual_seed(SEED + 21),
                       device=DEVICE)
    data = distri_lm_data(vocab, seq, batch, DISTRI_STEPS, SEED + 21)
    data.shuffle = lambda: None
    if sync is None:
        opt = LocalOptimizer(lm, data, lm_criterion(),
                             device=None if DEVICE == "cuda" else DEVICE)
    else:
        opt = DistriOptimizer(lm, data, lm_criterion(), parameter_sync=sync)
    opt.set_optim_method(Adam(learningrate=1e-3)) \
        .set_end_when(Trigger.max_iteration(DISTRI_STEPS))
    losses, times = [], []
    run_steps = opt._run_steps

    def timed(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_steps(steps)      # the loss fetch waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
        losses.extend(out)
        return out

    opt._run_steps = timed
    before = kernels.launch_counts()
    opt.optimize()
    counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    opt._run_steps = run_steps
    prog = opt._step_program
    out = {"losses": losses, "step_ms": statistics.median(times[1:]),
           "first_step_ms": times[0], "launches": counts,
           "captured": bool(prog.captured), "replays": prog.replays,
           "step_mode": getattr(opt, "step_mode", "captured")}
    params = {n: p.detach().clone() for n, p in lm.named_parameters()}
    if profile:     # one more (replayed) step, after the parameters' copy
        batch0 = next(iter(data.data(train=False)))
        out["profile"] = profile_step(opt, batch0, card, COLLECTIVE_KINDS)
    del opt, lm
    release()
    return out, params


def distri_lm_modes(TransformerLM, lm_criterion, kernels, card, widths, seq,
                    batch, name):
    """One model in every sync mode against LocalOptimizer on the same
    seed and batches: losses and parameters bitwise (at world 1 every
    collective is a copy and every scale a 1), the step captured and
    replayed, the LM kernels launched inside it."""
    local, lparams = distri_lm_run(TransformerLM, lm_criterion, kernels,
                                   card, widths, seq, batch, None)
    out = {"local": {k: local[k] for k in ("losses", "step_ms",
                                           "first_step_ms")}}
    for sync in DISTRI_MODES:
        run, params = distri_lm_run(TransformerLM, lm_criterion, kernels,
                                    card, widths, seq, batch, sync,
                                    profile=(sync == "allreduce"))
        same = run["losses"] == local["losses"] and all(
            torch.equal(params[n], p) for n, p in lparams.items())
        log(f"  {name} {sync}: step {run['step_ms']:.2f} ms against "
            f"LocalOptimizer's {local['step_ms']:.2f} ms; losses "
            f"{[round(v, 4) for v in run['losses']]}; bitwise equal to "
            f"LocalOptimizer: {same}; {run['step_mode']}, captured "
            f"{run['captured']}, {run['replays']} replays; launches "
            f"{run['launches']} [{card}]")
        if not same:
            raise CheckFailed(f"{name} {sync}: DistriOptimizer at world 1 "
                              f"departs from LocalOptimizer: "
                              f"{run['losses']} vs {local['losses']}")
        if not (run["captured"] and run["replays"] == DISTRI_STEPS - 1
                and run["step_mode"] == "captured"):
            raise CheckFailed(f"{name} {sync}: the step was not captured "
                              f"and replayed ({run['step_mode']})")
        for k in ("layer_norm_fwd", "layer_norm_bwd", "flash_attention_fwd",
                  "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            if run["launches"][k] == 0:
                raise CheckFailed(f"{name} {sync}: the step never "
                                  f"launched {k}")
        del params
        out[sync] = run
    return out


def distributed_path(TransformerLM, lm_criterion, kernels, card,
                     Engine) -> dict:
    """Phase 21: the distributed trainer. (a) World 1 on NCCL: the
    TransformerLM main ``--distributed`` at its default widths against its
    local run, then the main path's LM at full width and the dryrun's
    entry LM trained by DistriOptimizer in allreduce, zero1 and fsdp, each
    against LocalOptimizer bitwise, its step captured with the
    collectives inside. (b) Several ranks sharing the one card over gloo:
    ``dryrun_multichip(2)`` and ``(4)``, every leg; the 2-rank run also on
    the host's CPU, the losses compared."""
    from bigdl_tpu_torch import dryrun
    from bigdl_tpu_torch.models.transformerlm import train as lm_main
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    t0 = time.perf_counter()
    out = {"card": card}
    # the 2-rank dry run on the host's CPU, for comparison, runs beside
    # the card's work (its ranks are processes of their own)
    host: dict = {}

    def on_host():
        t = time.perf_counter()
        try:
            host.update(dryrun.dryrun_multichip(2, backend="cpu"))
        except BaseException as e:  # noqa: BLE001 — raised at the join
            host["error"] = e
        host["wall_s"] = time.perf_counter() - t

    beside = threading.Thread(target=on_host, name="phase21-host-dryrun")
    beside.start()
    Engine.init(backend="nccl")
    try:
        mesh = Engine.mesh()
        log(f"  one-rank NCCL mesh: {mesh}, device {Engine.device()}")
        # the phase's path: DistriOptimizer's runs (the LocalOptimizer runs
        # they are held against are left out)
        launches = {k: 0 for k in kernels.launch_counts()}
        main_runs = {}
        for flag in ([], ["--distributed"]):
            seen = []
            from bigdl_tpu_torch.optim.optimizer import Optimizer
            run_steps = Optimizer._run_steps

            def recording(self, batches, _seen=seen, _run=run_steps):
                got = _run(self, batches)
                _seen.extend(got)
                return got

            Optimizer._run_steps = recording
            RandomGenerator.set_seed(SEED)
            torch.manual_seed(SEED)
            before = kernels.launch_counts()
            try:
                loss = lm_main.main(flag)
            finally:
                Optimizer._run_steps = run_steps
            if flag:
                for k, v in kernels.launch_counts().items():
                    launches[k] += v - before[k]
            main_runs["distributed" if flag else "local"] = {
                "losses": seen, "final_loss": loss}
        same = main_runs["distributed"]["losses"] == \
            main_runs["local"]["losses"]
        log(f"  the TransformerLM main at its defaults: --distributed losses "
            f"{[round(v, 4) for v in main_runs['distributed']['losses']]}, "
            f"bitwise the local run's: {same} [{card}]")
        if not same or not np.isfinite(main_runs["distributed"]["losses"]
                                       ).all():
            raise CheckFailed("the TransformerLM main --distributed departs "
                              "from its local run")
        out["main"] = main_runs
        out["full_width"] = distri_lm_modes(
            TransformerLM, lm_criterion, kernels, card,
            (VOCAB, EMBED, HEADS, LAYERS), TRAIN_LEN, TRAIN_BATCH,
            f"TransformerLM({VOCAB}, {EMBED}, {HEADS}, {LAYERS}) at "
            f"{TRAIN_BATCH} x {TRAIN_LEN}")
        d = DRYRUN_LM
        out["dryrun_lm"] = distri_lm_modes(
            TransformerLM, lm_criterion, kernels, card,
            (d["vocab"], d["embed"], d["heads"], d["layers"]), d["max_len"],
            TRAIN_BATCH, f"TransformerLM({d['vocab']}, {d['embed']}, "
            f"{d['heads']}, {d['layers']}, {d['max_len']}) at "
            f"{TRAIN_BATCH} x {d['max_len']}")
        for part in (out["full_width"], out["dryrun_lm"]):
            for sync in DISTRI_MODES:
                for k, v in part[sync]["launches"].items():
                    launches[k] += v
        out["launches"] = launches
    finally:
        Engine.shutdown_distributed()
        Engine.reset()
    # (b) several ranks on the one card, over gloo (NCCL takes one rank a
    # device); the CUDA tensors staged through the host by one rule
    # (parallel/collectives._staged); the pp leg's toy blocks (head dim 8,
    # below the flash kernel's 32) attend through full_attention. The ranks
    # inherit TF32 off from the environment (this process sets it through
    # torch.backends, which a spawned rank does not read)
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    multi = {}
    for n in (2, 4):
        t1 = time.perf_counter()
        got = dryrun.dryrun_multichip(n, backend="gloo")
        multi[n] = {"losses": got["losses"], "step_modes": got["step_modes"],
                    "wall_s": time.perf_counter() - t1}
        bad = {k: v for k, v in got["losses"].items()
               if not np.isfinite(v)}
        if bad:
            raise CheckFailed(f"dryrun_multichip({n}) on the card: "
                              f"non-finite {bad}")
        log(f"  dryrun_multichip({n}), {n} ranks sharing {DEVICE}:0 over "
            f"gloo: {got['losses']}; {multi[n]['wall_s']:.1f} s [{card}]")
    beside.join()
    if "error" in host:
        raise host["error"]
    rel = {k: abs(multi[2]["losses"][k] - v) / max(abs(v), 1e-6)
           for k, v in host["losses"].items()}
    worst = max(rel, key=rel.get)
    log(f"  dryrun_multichip(2) on the card against the host's CPU "
        f"({host['wall_s']:.1f} s, beside the card's runs): worst relative "
        f"loss gap "
        f"{rel[worst]:.2e} ({worst}; TF32 off, the card's kernels against "
        f"the plain versions; limit 1e-3) [{card}]")
    if rel[worst] > 1e-3:
        raise CheckFailed(f"dryrun_multichip(2) on the card departs from "
                          f"the CPU run: {worst} {rel[worst]:.3e}")
    out["multi_rank"] = {str(k): v for k, v in multi.items()}
    out["multi_rank"]["cpu_2"] = host["losses"]
    out["multi_rank"]["card_vs_cpu_worst_rel"] = rel[worst]
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 21 took {out['wall_s']:.1f} s [{card}]")
    return out


# ----------------------------------------------------------------- phase 22
ELASTIC_STEPS = 6                # Adam steps of a run (saves every 2)
ELASTIC_TP_TOL = 1e-4            # a TP run resumed without TP, fp32
# bf16 GPipe against its fp32 twin, the worst step's loss (relative): the
# card read 4.43e-05; the losses fall 0.7% over the 4 steps, so a stage
# that does not update is off by ~3e-3 or more
ELASTIC_BF16_TOL = 1e-3
ELASTIC_GPIPE_KERNELS = ("layer_norm_fwd", "layer_norm_bwd",
                         "flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv")


def elastic_lm(TransformerLM, device, seed=SEED + 22):
    return TransformerLM(VOCAB, EMBED, HEADS, LAYERS, TRAIN_LEN,
                         generator=torch.Generator().manual_seed(seed),
                         device=device)


def elastic_opt(model, lm_criterion, sync, ck, steps, backend="elastic",
                rules=None, batch=TRAIN_BATCH, every=2):
    """DistriOptimizer over phase 21's LM data (Adam, ``steps`` steps, the
    order fixed), with a checkpoint every ``every`` iterations under
    ``ck`` (a resume passes a trigger that never fires in its run)."""
    from bigdl_tpu_torch.optim import Adam, Trigger
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    data = distri_lm_data(VOCAB, TRAIN_LEN, batch, ELASTIC_STEPS + 2,
                          SEED + 22)
    data.shuffle = lambda: None
    opt = (DistriOptimizer(model, data, lm_criterion(), parameter_sync=sync)
           .set_optim_method(Adam(learningrate=1e-3))
           .set_end_when(Trigger.max_iteration(steps)))
    if rules is not None:
        opt.set_tensor_parallel(rules)
    if ck is not None:
        opt.set_checkpoint(str(ck), Trigger.several_iteration(every),
                           backend=backend)
    return opt


def recorded(opt) -> list:
    seen = []
    run = opt._run_steps

    def rec(batches):
        out = run(batches)
        seen.extend(out)
        return out
    opt._run_steps = rec
    return seen


def ckpt_hists() -> dict:
    """The checkpoint histograms since the registry's reset, with each
    save's value in order (``each``)."""
    from bigdl_tpu_torch.obs.registry import registry
    h = registry.snapshot()["histograms"]
    return {k: dict(h.get(k, {}),
                    each=[round(v, 2) for v in registry.histogram(k)._window])
            for k in ("ckpt/stall_ms", "ckpt/async_write_ms")}


def lm_tp_rules():
    """Megatron's split of every block's MLP (up column-, down
    row-parallel) over ``model``."""
    from bigdl_tpu_torch.parallel import megatron_mlp_rules
    return megatron_mlp_rules(r"[0-9]+/1/0/1/1/0", r"[0-9]+/1/0/1/3/0")


def elastic_world1(TransformerLM, lm_criterion, kernels, card, tmp,
                   Engine) -> dict:
    """(a) One-rank NCCL mesh: zero1 and fsdp in fp32 and bf16, elastic
    saves every 2 steps with the step captured; a resume from version 4
    continues bitwise; the pickle backend's stalls beside."""
    import shutil
    from bigdl_tpu_torch.obs.registry import registry
    from bigdl_tpu_torch.utils import elastic_ckpt
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        Engine.init(backend="nccl", compute_dtype=dtype)
        try:
            for sync in ("zero1", "fsdp"):
                for backend in (("elastic", "pickle")
                                if sync == "zero1" and dtype == torch.float32
                                else ("elastic",)):
                    t1 = time.perf_counter()
                    ck = tmp / f"{sync}-{dtype}-{backend}"
                    registry.reset()
                    lm = elastic_lm(TransformerLM, DEVICE)
                    opt = elastic_opt(lm, lm_criterion, sync, ck,
                                      ELASTIC_STEPS, backend)
                    losses = recorded(opt)
                    before = kernels.launch_counts()
                    opt.optimize()
                    opt._join_checkpoint_writer()
                    counts = {k: v - before[k] for k, v in
                              kernels.launch_counts().items()}
                    prog = opt._step_program
                    hists = ckpt_hists()
                    key = f"{backend}/{sync}/{str(dtype)[6:]}"
                    run = {"losses": losses, "launches": counts,
                           "captured": bool(prog.captured),
                           "replays": prog.replays,
                           "stall_ms": hists["ckpt/stall_ms"],
                           "write_ms": hists["ckpt/async_write_ms"]}
                    final = {n: p.detach().clone()
                             for n, p in lm.named_parameters()}
                    del opt, lm
                    release()
                    if not run["captured"]:
                        raise CheckFailed(f"phase 22 {key}: the step was "
                                          f"not captured")
                    if backend == "elastic":
                        if elastic_ckpt.complete_versions(str(ck)) != \
                                [2, 4, 6]:
                            raise CheckFailed(f"phase 22 {key}: versions "
                                              f"{elastic_ckpt.complete_versions(str(ck))}")
                        shutil.rmtree(ck / "elastic.6")
                        lm = elastic_lm(TransformerLM, DEVICE, seed=7)
                        opt = elastic_opt(lm, lm_criterion, sync, ck,
                                          ELASTIC_STEPS, backend, every=100)
                        again = recorded(opt)
                        opt.optimize(resume="auto")
                        opt._join_checkpoint_writer()
                        same = again == losses[4:] and all(
                            torch.equal(p, final[n])
                            for n, p in lm.named_parameters())
                        run["resume_bitwise"] = same
                        del opt, lm
                        release()
                        if not same:
                            raise CheckFailed(
                                f"phase 22 {key}: the resume from version "
                                f"4 departs: {again} vs {losses[4:]}")
                    shutil.rmtree(ck, ignore_errors=True)
                    del final
                    run["wall_s"] = time.perf_counter() - t1
                    log(f"  (a) {key}: losses "
                        f"{[round(v, 4) for v in losses]}; each save's "
                        f"stall ms {run['stall_ms']['each']} (the first the "
                        f"snapshot alone, the others also the hard barrier: "
                        f"the previous write), writer ms "
                        f"{run['write_ms']['each']}; captured, "
                        f"{run['replays']} replays; resumed bitwise: "
                        f"{run.get('resume_bitwise', '-')}; launches "
                        f"{run['launches']}; {run['wall_s']:.1f} s [{card}]")
                    out[key] = run
        finally:
            Engine.shutdown_distributed()
            Engine.reset()
    return out


def elastic_ranks(tmp: str) -> dict:
    """(b), (d), (e) on 2 gloo ranks sharing cuda:0: a tensor-parallel
    LM's elastic versions; each sync mode's memory; bf16 GPipe."""
    import torch.distributed as dist
    from bigdl_tpu_torch import kernels, nn
    from bigdl_tpu_torch.models.transformerlm import (
        TransformerLM, lm_criterion,
    )
    from bigdl_tpu_torch.utils.engine import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, out = dist.get_rank(), {}
    dev = Engine.device()
    # (b) TP on (1, 2), zero1, versions 2, 4, 6
    Engine.reset()
    Engine.init(backend="gloo", mesh_shape=(1, 2),
                mesh_axes=("data", "model"))
    lm = elastic_lm(TransformerLM, str(dev))
    opt = elastic_opt(lm, lm_criterion, "zero1", Path(tmp) / "tp",
                      ELASTIC_STEPS, rules=lm_tp_rules())
    out["tp_losses"] = recorded(opt)
    opt.optimize()
    opt._join_checkpoint_writer()
    dist.barrier()
    out["tp_split"] = len(opt._tp_split)
    del opt, lm
    release()
    # (d) each sync mode at data 2: peak and resident bytes
    Engine.reset()
    Engine.init(backend="gloo", mesh_shape=(2,), mesh_axes=("data",))
    for sync in ("allreduce", "zero1", "fsdp"):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        lm = elastic_lm(TransformerLM, str(dev))
        opt = elastic_opt(lm, lm_criterion, sync, None, 1)
        resident = []
        run = opt._run_steps

        def held(batches, run=run):
            r = run(batches)
            torch.cuda.synchronize()
            resident.append(torch.cuda.memory_allocated() - base)
            return r
        opt._run_steps = held
        opt.optimize()
        out[f"mem/{sync}"] = {
            "peak": torch.cuda.max_memory_allocated() - base,
            "resident_between_steps": resident[-1],
            "loss": opt.state["loss"]}
        del opt, lm
        release()
    # (e) bf16 GPipe: the LM's blocks as 2 stages on a pipe mesh of 2
    from bigdl_tpu_torch.optim import Adam, Trigger
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    from bigdl_tpu_torch.parallel import GPipe
    for dtype in (torch.float32, torch.bfloat16):
        Engine.reset()
        Engine.init(backend="gloo", mesh_shape=(1, 2),
                    mesh_axes=("data", "pipe"), compute_dtype=dtype)
        lm = elastic_lm(TransformerLM, str(dev))
        kids = list(lm.children())
        half = 2 + LAYERS // 2
        stages = [nn.Sequential(), nn.Sequential()]
        for i, k in enumerate(kids):
            stages[0 if i < half else 1].add(k)
        pipe = GPipe(stages=stages, n_microbatches=2)
        data = distri_lm_data(VOCAB, TRAIN_LEN, TRAIN_BATCH, 6, SEED + 22)
        data.shuffle = lambda: None
        opt = (DistriOptimizer(pipe, data, lm_criterion())
               .set_optim_method(Adam(learningrate=1e-3))
               .set_end_when(Trigger.max_iteration(4)))
        losses = recorded(opt)
        kernels.reset_launch_counts()
        opt.optimize()
        out[f"gpipe/{str(dtype)[6:]}"] = {
            "losses": losses,
            "launches": kernels.launch_counts(),
            "by_dtype": kernels.launch_counts_by_dtype()}
        del opt, lm, pipe
        release()
    Engine.reset()
    out["rank"] = rank
    return out


def elastic_drill_worker(argv: list) -> int:
    """The host-loss drill's process (``--elastic-drill-worker PORT RANK
    OUT``): ``drill`` (2 gloo ranks sharing the card, zero1, the full-width
    LM, elastic saves every 2 steps; rank 1 killed by ``host_down@3``;
    rank 0 watches its peer and re-executes itself) or ``resume`` (world 1
    on NCCL from the newest complete version, to iteration 6)."""
    port, rank, out_file = argv[0], int(argv[1]), argv[2]
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bigdl_tpu_torch.kernels import _cuda
    from bigdl_tpu_torch.models.transformerlm import (
        TransformerLM, lm_criterion,
    )
    from bigdl_tpu_torch.utils import elastic_ckpt
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.robustness import events
    _cuda.library()
    ck = os.environ["BIGDL_DRILL_DIR"]
    if os.environ.get("BIGDL_DRILL_MODE") == "resume":
        Engine.init(backend="nccl")
        snap = events.snapshot()
        lm = elastic_lm(TransformerLM, DEVICE, seed=7)
        opt = elastic_opt(lm, lm_criterion, "zero1", ck, ELASTIC_STEPS,
                          every=100)
        versions = elastic_ckpt.complete_versions(ck)
        opt._load_latest_checkpoint()
        resumed_from = int(opt.state["neval"])
        losses = recorded(opt)
        opt.optimize(resume="auto")
        opt._join_checkpoint_writer()
        with open(out_file, "w") as f:
            json.dump({"mode": "resume", "versions": versions,
                       "resumed_from": resumed_from, "losses": losses,
                       "elastic_resume": events.deltas(snap).get(
                           "elastic_resume", 0),
                       "world": Engine.mesh().size}, f)
        Engine.shutdown_distributed()
        return 0
    Engine.init(backend="gloo", coordinator_address=f"localhost:{port}",
                process_id=rank, node_number=2)
    if rank == 0:
        peer = int(os.environ["BIGDL_DRILL_PEER"])

        def watch():
            while True:
                try:
                    os.kill(peer, 0)
                except OSError:
                    env = dict(os.environ, BIGDL_DRILL_MODE="resume")
                    env.pop("BIGDL_FAULT_PLAN", None)
                    os.execve(sys.executable, [sys.executable,
                                               str(here / "chip_smoke.py"),
                                               "--elastic-drill-worker",
                                               *argv], env)
                time.sleep(0.05)
        threading.Thread(target=watch, daemon=True).start()
    lm = elastic_lm(TransformerLM, str(Engine.device()))
    opt = elastic_opt(lm, lm_criterion, "zero1", ck, ELASTIC_STEPS)
    try:
        opt.optimize()
    except RuntimeError:
        if rank == 0:
            time.sleep(120)       # the watcher re-executes this process
        raise
    return 0


def elastic_drill_start(tmp: Path) -> dict:
    """(c) The host-loss drill's two ranks started (they run beside the
    rest of the phase; :func:`elastic_drill_finish` waits for them)."""
    import socket
    me = str(Path(__file__).resolve())
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ck = tmp / "drill"
    env = dict(os.environ, BIGDL_DRILL_DIR=str(ck), BIGDL_CKPT_ASYNC="0",
               BIGDL_CKPT_SYNC_TIMEOUT="20", BIGDL_INIT_TIMEOUT="120",
               BIGDL_FAILURE_RETRY_TIMES="0", NVIDIA_TF32_OVERRIDE="0")
    outs = [str(tmp / f"drill{r}.json") for r in (0, 1)]
    logs = [open(tmp / f"drill{r}.log", "w") for r in (0, 1)]
    t0 = time.perf_counter()
    p1 = subprocess.Popen([sys.executable, me, "--elastic-drill-worker",
                           str(port), "1", outs[1]],
                          env=dict(env, BIGDL_FAULT_PLAN="host_down@3"),
                          stdout=logs[1], stderr=subprocess.STDOUT)
    p0 = subprocess.Popen([sys.executable, me, "--elastic-drill-worker",
                           str(port), "0", outs[0]],
                          env=dict(env, BIGDL_DRILL_PEER=str(p1.pid)),
                          stdout=logs[0], stderr=subprocess.STDOUT)
    for f in logs:
        f.close()
    # reap rank 1 the moment host_down kills it: until its parent waits, it
    # is a zombie, os.kill(pid, 0) still finds it, and the survivor's
    # watcher would not re-execute before elastic_drill_finish waits
    threading.Thread(target=p1.wait, daemon=True).start()
    return {"p0": p0, "p1": p1, "outs": outs, "ck": ck, "t0": t0}


def elastic_drill_finish(drill: dict, TransformerLM, lm_criterion, card,
                         tmp: Path, Engine) -> dict:
    """(c) The drill's outcome, and a fresh resume (in this process, at
    world 1 on NCCL) from the version the survivor resumed from."""
    import shutil
    from bigdl_tpu_torch.utils import elastic_ckpt
    p0, p1, outs, ck, t0 = (drill[k] for k in ("p0", "p1", "outs", "ck",
                                               "t0"))
    try:
        p1.wait(timeout=300)
        p0.wait(timeout=300)
    except subprocess.TimeoutExpired:
        raise CheckFailed("phase 22 (c): the host-loss drill timed out")
    if p1.returncode != -9 or p0.returncode != 0:
        tail = (tmp / "drill0.log").read_text()[-3000:]
        raise CheckFailed(f"phase 22 (c): rank 1 exited {p1.returncode}, "
                          f"the survivor {p0.returncode}:\n{tail}")
    res = json.load(open(outs[0]))
    version = res["versions"][-1]
    if not (res["world"] == 1 and res["elastic_resume"] >= 1
            and res["resumed_from"] == version + 1):
        raise CheckFailed(f"phase 22 (c): the survivor's resume {res}")
    ck2 = tmp / "drill-replay"
    shutil.copytree(ck, ck2)
    for name in os.listdir(ck2):
        v = elastic_ckpt.version_of(name)
        if v is None or v > version:
            shutil.rmtree(ck2 / name, ignore_errors=True)
    Engine.init(backend="nccl")
    try:
        lm = elastic_lm(TransformerLM, DEVICE, seed=7)
        opt = elastic_opt(lm, lm_criterion, "zero1", ck2, ELASTIC_STEPS,
                          every=100)
        replay = {"losses": recorded(opt)}
        opt.optimize(resume="auto")
        del opt, lm
        release()
    finally:
        Engine.shutdown_distributed()
        Engine.reset()
    same = replay["losses"] == res["losses"]
    log(f"  (c) host_down@3 killed rank 1 (exit -9); the survivor "
        f"re-executed at world 1 on NCCL and resumed from version {version} "
        f"(iteration {res['resumed_from']}): losses "
        f"{[round(v, 4) for v in res['losses']]}; a fresh resume from that "
        f"version gives the same losses: {same}; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    if not same:
        raise CheckFailed("phase 22 (c): the replay departs from the "
                          "survivor's losses")
    return {"survivor": res, "replay_losses": replay["losses"],
            "wall_s": time.perf_counter() - t0}


def elastic_path(TransformerLM, lm_criterion, kernels, card,
                 Engine) -> dict:
    """Phase 22: the elastic checkpoint and the trainer's new
    configurations at full width (phase 6's LM, 16 x 512, Adam)."""
    import shutil
    import tempfile
    from bigdl_tpu_torch import dryrun
    from bigdl_tpu_torch.utils import elastic_ckpt
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bigdl-phase22-", dir=work_root()))
    log(f"  checkpoints under {tmp} [{card}]")
    launches = {k: 0 for k in kernels.launch_counts()}
    drill = None
    try:
        # the processes of (b)-(e) run beside (a): their ranks stage through
        # the host and leave the card mostly idle (the ranks inherit TF32
        # off from the environment)
        os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
        drill = elastic_drill_start(tmp)
        box: dict = {}

        def spawn_ranks():
            t1 = time.perf_counter()
            try:
                box["ranks"] = dryrun.spawn(elastic_ranks, 2, (str(tmp),),
                                            backend="gloo", timeout=600,
                                            workdir=str(tmp))
            except BaseException as e:  # noqa: BLE001 — raised below
                box["error"] = e
            box["s"] = time.perf_counter() - t1

        beside = threading.Thread(target=spawn_ranks, daemon=True)
        beside.start()
        out = {"world1": elastic_world1(TransformerLM, lm_criterion, kernels,
                                        card, tmp, Engine)}
        for run in out["world1"].values():
            for k, v in run["launches"].items():
                launches[k] += v
        beside.join()
        if "error" in box:
            raise box["error"]
        ranks = box["ranks"]
        log(f"  (b), (d), (e) on 2 gloo ranks (beside (a)): {box['s']:.1f} "
            f"s [{card}]")
        r0 = ranks[0]
        # (b) the TP versions resumed at world 1 on NCCL without TP
        ck = tmp / "tp"
        if elastic_ckpt.complete_versions(str(ck)) != [2, 4, 6]:
            raise CheckFailed(f"phase 22 (b): TP versions "
                              f"{elastic_ckpt.complete_versions(str(ck))}")
        shutil.rmtree(ck / "elastic.6")
        saved, _, man = elastic_ckpt.assemble(str(ck / "elastic.4"))
        Engine.init(backend="nccl")
        try:
            lm = elastic_lm(TransformerLM, DEVICE, seed=7)
            opt = elastic_opt(lm, lm_criterion, "zero1", ck, ELASTIC_STEPS,
                              every=100)
            opt._load_latest_checkpoint()
            from bigdl_tpu_torch import convert
            flat = convert.flatten_tree(saved["params"])
            bitwise = all(np.array_equal(p.detach().cpu().numpy(), flat[n])
                          for n, p in lm.named_parameters())
            cont = recorded(opt)
            before = kernels.launch_counts()
            opt.optimize(resume="auto")
            for k, v in kernels.launch_counts().items():
                launches[k] += v - before[k]
            del opt, lm
            release()
        finally:
            Engine.shutdown_distributed()
            Engine.reset()
        ref = r0["tp_losses"][4:]
        rel = max(abs(a - b) / abs(b) for a, b in zip(cont, ref))
        log(f"  (b) TransformerLM with {r0['tp_split']} leaves split over "
            f"`model` on a (1, 2) gloo mesh sharing the card, zero1, "
            f"versions 2, 4, 6 (manifest mesh {man['mesh']}); version 4 "
            f"resumed at world 1 on NCCL without TP: leaves bitwise "
            f"{bitwise}, continued losses {[round(v, 5) for v in cont]} "
            f"against the TP run's {[round(v, 5) for v in ref]}, worst "
            f"relative {rel:.2e} (limit {ELASTIC_TP_TOL}) [{card}]")
        if not bitwise or rel > ELASTIC_TP_TOL:
            raise CheckFailed("phase 22 (b): the TP version's resume "
                              "departs")
        out["tp"] = {"losses": r0["tp_losses"], "continued": cont,
                     "worst_rel": rel, "bitwise": bitwise}
        out["drill"] = elastic_drill_finish(drill, TransformerLM,
                                            lm_criterion, card, tmp, Engine)
        # (d) memory
        mem = {s: [r[f"mem/{s}"] for r in ranks]
               for s in ("allreduce", "zero1", "fsdp")}
        for s, m in mem.items():
            log(f"  (d) {s} at data 2 over gloo: each rank's "
                f"max_memory_allocated {[x['peak'] for x in m]} bytes, "
                f"resident between steps "
                f"{[x['resident_between_steps'] for x in m]} [{card}]")
        if not all(f["peak"] < z["peak"]
                   for f, z in zip(mem["fsdp"], mem["zero1"])):
            raise CheckFailed("phase 22 (d): fsdp's peak is not below "
                              "zero1's")
        out["memory"] = mem
        # (e) bf16 GPipe
        g16, g32 = r0["gpipe/bfloat16"], r0["gpipe/float32"]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(g16["losses"], g32["losses"]))
        by16 = [{k: r["gpipe/bfloat16"]["by_dtype"][k]
                 for k in ELASTIC_GPIPE_KERNELS} for r in ranks]
        log(f"  (e) GPipe of the LM's blocks on 2 gloo ranks (pipe 2), 4 "
            f"steps: bf16 losses {[round(v, 4) for v in g16['losses']]} "
            f"against fp32 {[round(v, 4) for v in g32['losses']]}, worst "
            f"relative {rel:.2e} (limit {ELASTIC_BF16_TOL}); the bf16 "
            f"run's launches by dtype, each rank {by16} [{card}]")
        if rel > ELASTIC_BF16_TOL or not all(
                np.isfinite(g16["losses"])):
            raise CheckFailed("phase 22 (e): bf16 GPipe departs from fp32")
        # each rank's stage launched every LM kernel, each launch in the
        # run's dtype (LayerNorm's x and gamma both)
        for r in ranks:
            for want in ("bfloat16", "float32"):
                by = r[f"gpipe/{want}"]["by_dtype"]
                for k in ELASTIC_GPIPE_KERNELS:
                    if not by[k] or any(set(key.split("/")) != {want}
                                        for key in by[k]):
                        raise CheckFailed(
                            f"phase 22 (e): rank {r['rank']}'s {want} "
                            f"GPipe launched {k} as {by[k]}")
        out["gpipe"] = {"bf16": g16, "fp32": g32, "worst_rel": rel}
        for r in ranks:
            for k in launches:
                launches[k] += r["gpipe/bfloat16"]["launches"].get(k, 0) \
                    + r["gpipe/float32"]["launches"].get(k, 0)
    finally:
        for p in ((drill["p0"], drill["p1"]) if drill else ()):
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 22 launches {launches}; took {out['wall_s']:.1f} s "
        f"[{card}]")
    return out


@contextlib.contextmanager
def cudnn_deterministic():
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "GPU only", file=sys.stderr)
        return 2
    if "--elastic-drill-worker" in sys.argv:
        i = sys.argv.index("--elastic-drill-worker")
        return elastic_drill_worker(sys.argv[i + 1:i + 4])
    here = Path(__file__).resolve().parent
    # --root DIR: the package of another checkout (the --lm-feed-ab mode's
    # comparison with an earlier commit)
    root = (Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
            if "--root" in sys.argv else here)
    sys.path.insert(0, str(root))
    try:
        import bigdl_tpu_torch
        from bigdl_tpu_torch import kernels, nn
        from bigdl_tpu_torch.kernels import _cuda
        from bigdl_tpu_torch.models.transformerlm import (
            TransformerLM, lm_criterion,
        )
        from bigdl_tpu_torch.nn import greedy_generate, install_decode_cache
        from bigdl_tpu_torch.serving import ServingEngine, pick_bucket
        from bigdl_tpu_torch.utils.engine import Engine
        from bigdl_tpu_torch.utils.programs import Program
    except ImportError as e:
        print(f"chip_smoke: the bigdl_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    if Path(bigdl_tpu_torch.__file__).resolve().parent.parent != root:
        print(f"chip_smoke: bigdl_tpu_torch was imported from "
              f"{bigdl_tpu_torch.__file__}, not from {root}",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    log("phase 2: build")
    lib = _cuda.library()
    log(f"  built {lib.path} in {lib.build_seconds:.1f} s")
    if "--remat-captures" in sys.argv:
        n = int(sys.argv[sys.argv.index("--remat-captures") + 1])
        return remat_captures(n, TransformerLM, lm_criterion, kernels, card,
                              Engine)
    if "--lm-feed-ab" in sys.argv:
        n = int(sys.argv[sys.argv.index("--lm-feed-ab") + 1])
        return lm_feed_ab(n, TransformerLM, lm_criterion, kernels, card,
                          Engine)
    if "--text-only" in sys.argv:
        log("phase 13 only")
        text = text_path(kernels, card, Engine)
        print(json.dumps({"text": text}), flush=True)
        return 0
    if "--finetune-only" in sys.argv:
        log("phase 15 only")
        finetune = finetune_path(TransformerLM, lm_criterion, nn, kernels,
                                 card, Engine, ServingEngine)
        print(json.dumps({"finetune": finetune}), flush=True)
        return 0
    if "--tail-only" in sys.argv:
        log("phase 16 only")
        kernels.reset_launch_counts()
        tail = tail_path(kernels, card, Engine, Program)
        tail["launches"] = tail_launches(kernels.launch_counts())
        print(json.dumps({"tail": tail}), flush=True)
        return 0
    if "--recsys-only" in sys.argv:
        log("phase 17 only")
        kernels.reset_launch_counts()
        recsys = recsys_path(card)
        recsys["launches"] = recsys_launches(kernels.launch_counts())
        print(json.dumps({"recsys": recsys}), flush=True)
        return 0
    if "--quantized-only" in sys.argv:
        log("phase 18 only")
        kernels.reset_launch_counts()
        quantized = quantized_path(TransformerLM, kernels, card)
        print(json.dumps({"quantized": quantized}), flush=True)
        return 0
    if "--detection-only" in sys.argv:
        log("phase 19 only")
        kernels.reset_launch_counts()
        detection = detection_path(kernels, card, Program)
        print(json.dumps({"detection": detection}), flush=True)
        return 0
    if "--distributed-only" in sys.argv:
        log("phase 21 only")
        distributed = distributed_path(TransformerLM, lm_criterion, kernels,
                                       card, Engine)
        print(json.dumps({"distributed": distributed}), flush=True)
        print(f"card: {card}", flush=True)
        return 0
    if "--elastic-only" in sys.argv:
        log("phase 22 only")
        elastic = elastic_path(TransformerLM, lm_criterion, kernels, card,
                               Engine)
        print(json.dumps({"elastic": elastic}), flush=True)
        print(f"card: {card}", flush=True)
        return 0
    if "--images-only" in sys.argv:
        log("phase 20 only")
        kernels.reset_launch_counts()
        images = images_path(kernels, card, root)
        print(json.dumps({"images": images}), flush=True)
        return 0
    if "--serving-only" in sys.argv:
        log("phase 14 only")
        kernels.reset_launch_counts()
        stack = serving_stack(TransformerLM, lm_criterion, card)
        stack["launches"] = stack_launches(kernels.launch_counts())
        print(json.dumps({"serving_stack": stack}), flush=True)
        return 0
    build = report_flash_build(lib, kernels, _cuda.find_nvcc())
    ln_build = report_layer_norm_build(lib)

    log("phase 3: kernels against their plain versions")
    floor_ms = launch_floor_ms(lib.lib)
    log(f"  launch floor: an empty kernel through the C interface "
        f"{floor_ms:.5f} ms [{card}]")
    ln_rows = check_layer_norm(kernels, card, floor_ms)
    lnb_rows = check_layer_norm_bwd(kernels, card)
    fa_rows = check_flash(kernels, card)
    bwd_rows = check_flash_bwd(kernels, card)

    log("phase 4: full-sequence forward, full width")
    lm = build_lm(TransformerLM, "auto", "cuda")
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"  TransformerLM({VOCAB}, {EMBED}, {HEADS}, {LAYERS}, {MAX_LEN}): "
        f"{n_params} parameters")
    # the serving path is phases 4 and 5: counted from here ...
    kernels.reset_launch_counts()
    full_forward(lm, lambda: build_lm(TransformerLM, "full", "cpu"))
    fwd_counts = kernels.launch_counts()

    log("phase 5: serving")
    prompts, rounds = serve(lm, ServingEngine)
    launches = kernels.launch_counts()     # ... to here
    (results, wall, stats0), (results2, wall2, stats) = rounds
    cold = report_round("first round (captures)", results, wall, stats0, {},
                        card)
    warm = report_round("second round (replays only)", results2, wall2,
                        stats, stats0, card)
    log(f"  engine stats: {stats}")
    log(f"  launches: full forward {fwd_counts}, serving "
        f"{ {k: launches[k] - fwd_counts[k] for k in launches} }")
    for name in ("layer_norm_fwd", "flash_attention_fwd"):
        if launches[name] == 0:
            raise CheckFailed(f"the serving path never launched {name}")
    refs = check_served_tokens(lm, greedy_generate, prompts, results)
    if any(not np.array_equal(a.tokens, b.tokens)
           for a, b in zip(results, results2)):
        raise CheckFailed("the second round served other tokens")
    log("  served tokens match solo greedy_generate, in both rounds")
    programs = check_programs(stats, prompts, stats["buckets"], pick_bucket,
                              launches, fwd_counts)
    if stats0["compiled_programs"] != stats["compiled_programs"]:
        raise CheckFailed("the second round captured new programs")
    eager_step = decode_step_ms(lm, install_decode_cache, card)
    replayed_step = replayed_decode_step(lm, kernels, install_decode_cache,
                                         Program, card)
    replayed_step["profile"] = decode_kernels(
        lm, install_decode_cache, Program, card, "LayerNorm/GELU")

    del lm
    torch.cuda.empty_cache()

    log("phase 6: training")
    fp32_ref = check_train_step(TransformerLM, lm_criterion)
    train_counts, run = train(TransformerLM, lm_criterion, kernels, card,
                              compare=True)
    _, run_fused = train(TransformerLM, lm_criterion, kernels, card,
                         fuse=FUSE, compare=True, profile=False)
    train_shape, serve_shape = (TRAIN_BATCH, HEADS, TRAIN_LEN, 64), \
        (2, HEADS, 512, 64)
    ln_shape = (TRAIN_BATCH * TRAIN_LEN, EMBED)

    def kernel_rows(dtype):
        """The phase-3 rows of the five kernels at the training step's
        shapes (LayerNorm with gamma in the step's dtype)."""
        return (find_row(ln_rows, ln_shape, dtype, dtype),
                find_row(lnb_rows, ln_shape, dtype, dtype),
                find_row(fa_rows, train_shape, dtype),
                find_row(bwd_rows, train_shape, dtype))

    def kernel_ms_a_step(counts, rows):
        per_step = {k: v / TRAIN_ITERS for k, v in counts.items()}
        ln_r, lnb_r, fa_r, bwd_r = rows
        return (per_step["layer_norm_fwd"] * ln_r["ms"]
                + per_step["layer_norm_bwd"] * lnb_r["ms"]
                + per_step["flash_attention_fwd"] * fa_r["ms"]
                + per_step["flash_attention_bwd_dq"] * bwd_r["dq_ms"]
                + per_step["flash_attention_bwd_dkv"] * bwd_r["dkv_ms"])

    ln_t, lnb, fa_t, bwd = kernel_rows("float32")
    kernel_ms = kernel_ms_a_step(train_counts, (ln_t, lnb, fa_t, bwd))
    log(f"  the five kernels: {kernel_ms:.3f} ms a step at their phase-3 "
        f"times, {kernel_ms / run['step_ms']:.1%} of the median step "
        f"[{card}]")

    # the same training under the bf16 mixed-precision policy
    Engine.init(compute_dtype=torch.bfloat16)
    try:
        bf16_check = check_train_step_bf16(TransformerLM, lm_criterion,
                                           fp32_ref)
        del fp32_ref
        counts16, run16 = train(TransformerLM, lm_criterion, kernels, card,
                                bf16=True, compare=True)
        _, run16_fused = train(TransformerLM, lm_criterion, kernels, card,
                               bf16=True, fuse=FUSE, compare=True,
                               profile=False)
        # the same with the flat update (off by default, as in JAX) and with
        # remat: their step times and launches, beside the plain run's
        _, run16_flat = train(TransformerLM, lm_criterion, kernels, card,
                              bf16=True, flat=True, profile=False)
        remat16, run16_remat = train(TransformerLM, lm_criterion, kernels,
                                     card, bf16=True, remat=True,
                                     profile=False)
    finally:
        Engine.reset()
    # remat re-runs the same forward: the same losses within 1e-4 relative
    remat_rel = max(abs(a - b) / abs(b) for a, b in
                    zip(run16_remat["losses"], run16["losses"]))
    if remat_rel > 1e-4:
        raise CheckFailed(f"bf16 training with remat departs from the run "
                          f"without it: losses {remat_rel:.3e} relative")
    rows16 = kernel_rows("bfloat16")
    kernel_ms16 = kernel_ms_a_step(counts16, rows16)

    log("phase 7: the llama-style path, full width")
    llama = llama_path(TransformerLM, lm_criterion, nn, kernels, card,
                       ServingEngine, pick_bucket, Engine)
    llama_step = llama["summary"]["training_bf16"]["step_ms"]
    llama_kernel_ms = kernel_ms_a_step(llama["counts"], rows16)
    log(f"  llama bf16 step {llama_step:.2f} ms "
        f"({llama['summary']['training_bf16']['tokens_per_s']:.0f} tokens/s) "
        f"against {run16['step_ms']:.2f} ms for the LayerNorm/GELU model's; "
        f"its flash kernels {llama_kernel_ms:.3f} ms a step at their "
        f"phase-3 times; the fused head "
        f"{llama['summary']['head']['fused_ms']:.2f} ms against "
        f"{llama['summary']['head']['unfused_ms']:.2f} ms unfused [{card}]")
    log(f"  set_fuse_steps({FUSE}): step {run_fused['step_ms']:.2f} ms fp32 "
        f"(fuse 1: {run['step_ms']:.2f}), {run16_fused['step_ms']:.2f} ms "
        f"bf16 (fuse 1: {run16['step_ms']:.2f}) [{card}]")
    log(f"  bf16 against fp32: median step {run16['step_ms']:.2f} ms against "
        f"{run['step_ms']:.2f} ms ({run['step_ms'] / run16['step_ms']:.2f}x), "
        f"{run16['tokens_per_s']:.0f} against {run['tokens_per_s']:.0f} "
        f"tokens/s; the five kernels in bf16 {kernel_ms16:.3f} ms a step at "
        f"their phase-3 times, {kernel_ms16 / run16['step_ms']:.1%} of the "
        f"bf16 step; with the flat update {run16_flat['step_ms']:.2f} ms, "
        f"with remat {run16_remat['step_ms']:.2f} ms (losses within "
        f"{remat_rel:.1e} relative of the run without) [{card}]")

    log("phase 8: the vision path, full width")
    vision = vision_path(kernels, card, Engine)
    log(f"  the vision path launched none of the five kernels (cuDNN "
        f"convolutions, cuBLAS for the final Linear, torch ops for batch "
        f"norm, pooling and the rest): {vision['lm_kernel_launches']}")

    log("phase 9: the serving extras, full width")
    kernels.reset_launch_counts()          # the phase's path: from here ...
    extras = serving_extras(TransformerLM, nn, kernels, card, rounds,
                            prompts, refs)
    extras_counts = kernels.launch_counts()    # ... to here
    log(f"  launches: {extras_counts}")
    if extras_counts["layer_norm_fwd"] == 0:
        raise CheckFailed("the serving extras never launched the LayerNorm "
                          "forward")

    log("phase 11: checkpoint, preempt, resume and roll back the trainer, "
        "full width")
    kernels.reset_launch_counts()          # the phase's path: from here ...
    robust = robustness(TransformerLM, lm_criterion, card, Engine)
    robust_counts = kernels.launch_counts()    # ... to here
    log(f"  launches: {robust_counts}")
    for name, n in robust_counts.items():
        if n == 0 and name not in NMS_KERNELS:
            raise CheckFailed(f"phase 11 never launched {name}")
    robust["launches"] = robust_counts

    log("phase 12: the feed (prefetch, the pinned ring, the copy stream) and "
        "Inception-v1, full width")
    feed = feed_path(TransformerLM, lm_criterion, kernels, card, Engine)

    log("phase 13: the text family: the PTB LSTM LM at full width, the "
        "TreeLSTM and text-classifier mains, the ConvLSTM")
    kernels.reset_launch_counts()          # the phase's path: from here ...
    text = text_path(kernels, card, Engine)
    text["launches"] = kernels.launch_counts()     # ... to here
    log(f"  the text path launched none of the five kernels (cuBLAS for "
        f"its products, cuDNN for the ConvLSTM's convolutions, torch ops "
        f"for the gates, the tree and the rest): {text['launches']}")
    if any(text["launches"].values()):
        raise CheckFailed(f"the text path launched the LM kernels "
                          f"{text['launches']}")

    log("phase 14: the rest of serving (crash recovery, hot swaps, drain, "
        "the watchdog, the fleet, the lifecycle, the snapshot server), full "
        "width")
    kernels.reset_launch_counts()          # the phase's path: from here ...
    stack = serving_stack(TransformerLM, lm_criterion, card, prompts, refs)
    # ... to here, the references' launches left out
    stack["launches"] = stack_launches(kernels.launch_counts())

    log("phase 15: LoRA fine-tuning and serving of the full-width LM; the "
        "seq2seq Transformer at Transformer-base widths")
    finetune = finetune_path(TransformerLM, lm_criterion, nn, kernels, card,
                             Engine, ServingEngine,
                             full={"fp32": run, "bf16": run16},
                             prompts=prompts, refs=refs,
                             plain_rate=warm["decode_tokens_per_s"])
    ft_launches = finetune["launches"]

    log("phase 16: the layer tail (every ported layer and criterion on the "
        "card against the CPU) and the MNIST autoencoder, full width")
    kernels.reset_launch_counts()          # the phase's path: from here ...
    tail = tail_path(kernels, card, Engine, Program)
    tail["launches"] = tail_launches(kernels.launch_counts())   # ... to here

    log("phase 17: the recsys path (NeuralCF at MLPerf's MovieLens-20M "
        "widths, sparse and dense steps, HR@10, the ranking engine), Wide & "
        "Deep and the Keras API")
    kernels.reset_launch_counts()          # the phase's path: from here ...
    recsys = recsys_path(card)
    recsys["launches"] = recsys_launches(kernels.launch_counts())  # to here

    log("phase 18: int8 inference (ResNet-50 at batch 256, bf16 against "
        "dynamic, weight_only and static) and the full-width LM as int8 "
        "tenants")
    kernels.reset_launch_counts()          # the phase's path: from here ...
    quantized = quantized_path(TransformerLM, kernels, card)  # ... to its
    # serving rounds (the counts read inside, before the references)

    log("phase 19: the streamed SSD512 training, its serving, the SSD main "
        "and Mask R-CNN")
    kernels.reset_launch_counts()          # the phase's path: from here ...
    detection = detection_path(kernels, card, Program)   # ... to its end

    log("phase 20: the folder-backed image pipeline (the codec against "
        "PIL's fixtures, ResNet-50 from an ImageNet folder at batch 256, "
        "VGG-16 and LeNet-5 from CIFAR-10 and MNIST files, the convergence "
        "harness), module save and load")
    kernels.reset_launch_counts()          # the phase's path: from here ...
    images = images_path(kernels, card, root)    # ... to its save and load

    log("phase 21: the distributed trainer (DistriOptimizer in allreduce, "
        "zero1 and fsdp on a one-rank NCCL mesh, the LM captured with its "
        "collectives; dryrun_multichip(2) and (4) with the ranks sharing the "
        "card over gloo)")
    distributed = distributed_path(TransformerLM, lm_criterion, kernels,
                                   card, Engine)

    log("phase 22: the elastic checkpoint (zero1 and fsdp saves at world 1 "
        "on NCCL, a tensor-parallel version resumed without TP, the "
        "host-loss drill), fsdp's memory and bf16 GPipe, full width")
    elastic = elastic_path(TransformerLM, lm_criterion, kernels, card,
                           Engine)

    log("phase 10: the kernel table")

    # each kernel's row: its own slice's path (serving for the forward
    # kernels, training for the backward ones) and shapes; both paths'
    # launches under "paths"
    ln = find_row(ln_rows, (2 * 512, EMBED), "float32")
    ln_dec = find_row(ln_rows, (SLOTS, EMBED), "float32")
    ln_extras = {name: {k: find_row(ln_rows, shape, "float32")[k] for k in (
        "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "err")} for name, shape in (
        ("paged_tick", (EXTRA_SLOTS, EMBED)),
        ("verify_chunk", (EXTRA_SLOTS * (SPEC_K + 1), EMBED)))}
    fa = find_row(fa_rows, serve_shape, "float32")

    def design_of(kernel, plan, summary):   # the fp32 d = 64 instance's
        key = (kernel, "float32", 64, plan["warpgroups"])
        return dict(plan, **{k: build[key].get(k) for k in (
            "registers", "spill_bytes", "HGMMA", "UTMALDG")},
            summary=summary)

    design = design_of("flash_fwd_kernel", fa["plan"], (
        "wgmma (bf16 on the tensor cores; fp32 as 3xTF32) fed by a 2-stage "
        "TMA ring of K/V tiles from one producer warp; 64 query rows a "
        "consumer warpgroup"))
    bf16 = {name: {k: find_row(fa_rows, shape, "bfloat16")[k] for k in (
        "ms", "bound_ms", "library_ms", "err")}
        for name, shape in (("serving", serve_shape),
                            ("training", train_shape))}
    # the backward rows: the training shape in fp32, with both bounds, and
    # bf16 at (2·8, 1024, 64) causal and at the training shape
    bwd_summary = ("all products on wgmma (bf16 on the tensor cores, P and "
                   "dS rounded to bf16 and fed from registers; fp32 as "
                   "3xTF32 with K-major and transposed working sets) fed "
                   "by a 2-stage TMA ring of the streamed tiles from one "
                   "producer warp; 64 resident rows a consumer warpgroup; "
                   "one CTA owns each output tile: no atomics")

    def bwd_bf16_row(shape):
        r = find_row(bwd_rows, shape, "bfloat16")
        return {"shape": list(shape), "dq_ms": r["dq_ms"],
                "dkv_ms": r["dkv_ms"], "dq_bound_ms": r["dq_bound"][0],
                "dkv_bound_ms": r["dkv_bound"][0], "bound_by":
                r["dq_bound"][1], "max_abs_err_dq": r["err_dq"],
                "max_abs_err_dkv": r["err_dkv"],
                "library_ms": r["library_ms"]}

    bwd_bf16 = {"long": bwd_bf16_row((2, HEADS, 1024, 64)),
                "training": bwd_bf16_row(train_shape)}
    paths = {k: {"serving": launches[k], "training": train_counts[k],
                 "training_bf16": counts16[k],
                 "llama_serving": llama["serving_counts"][k],
                 "llama_training_bf16": llama["counts"][k],
                 "vision": vision["lm_kernel_launches"][k],
                 "serving_extras": extras_counts[k],
                 "robustness": robust_counts[k],
                 "feed": feed["launches"][k],
                 "text": text["launches"][k],
                 "serving_stack": stack["launches"]["path"][k],
                 "serving_stack_engines": stack["launches"]["engines"][k],
                 "finetune_lora_training": ft_launches["lora_training"][k],
                 "finetune_lora_serving": ft_launches["lora_serving"][k],
                 "seq2seq": ft_launches["seq2seq"][k],
                 "tail": tail["launches"][k],
                 "recsys": recsys["launches"][k],
                 "quantized": quantized["launches"][k],
                 "detection": detection["launches"][k],
                 "images": images["launches"][k],
                 "distributed": distributed["launches"][k],
                 "elastic": elastic["launches"][k]}
             for k in launches}

    def s2s_flash(rows, name):
        """A flash kernel's seq2seq instances: the encoder's non-causal and
        the decoder's causal phase-3 rows, fp32 and bf16, and the seq2seq
        path's launches by variant."""
        part = {"flash_attention_fwd": None, "flash_attention_bwd_dq": "dq",
                "flash_attention_bwd_dkv": "dkv"}[name]
        out = {"launches_by_variant":
               ft_launches["seq2seq_by_variant"][name]}
        for where, shape, causal in (("encoder", S2S_ENC_SHAPE, False),
                                     ("decoder", S2S_DEC_SHAPE, True)):
            for dtype in ("float32", "bfloat16"):
                r = find_row(rows, shape, dtype, causal=causal)
                row = {"shape": list(shape), "causal": causal,
                       "plain_ms": r["plain_ms"],
                       "library_ms": r["library_ms"]}
                if part is None:
                    row.update(ms=r["ms"], bound_ms=r["bound_ms"],
                               bound_by=r["bound_by"], max_abs_err=r["err"])
                else:
                    row.update(ms=r[f"{part}_ms"],
                               bound_ms=r[f"{part}_bound"][0],
                               bound_by=r[f"{part}_bound"][1],
                               max_abs_err=r[f"err_{part}"],
                               plain_and_library_cover="dq+dk+dv")
                out[f"{where}_{dtype}"] = row
        return out

    beam_row = find_row(fa_rows, BEAM_SHAPE, "float32")

    def bf16_training(name):
        """The kernel's bf16 training instance: its phase-3 row at the
        training shape and its launches in the 8 bf16 steps."""
        ln_r, lnb_r, fa_r, bwd_r = rows16
        row = {"layer_norm_fwd": ln_r, "layer_norm_bwd": lnb_r,
               "flash_attention_fwd": fa_r}.get(name, bwd_r)
        out = {"shape": row["shape"], "dtype": row["dtype"],
               "launches": counts16[name],
               "launches_by_dtype": run16["by_dtype"][name],
               "plain_ms": row["plain_ms"], "library_ms": row["library_ms"]}
        if name.startswith("layer_norm"):
            out.update(params=row["params"], max_abs_err=row["err"],
                       ms=row["ms"], bound_ms=row["bound_ms"],
                       bound_by=row["bound_by"])
        elif name == "flash_attention_fwd":
            out.update(max_abs_err=row["err"], ms=row["ms"],
                       bound_ms=row["bound_ms"], bound_by=row["bound_by"])
        else:
            part = "dq" if name.endswith("dq") else "dkv"
            out.update(max_abs_err=row[f"err_{part}"], ms=row[f"{part}_ms"],
                       bound_ms=row[f"{part}_bound"][0],
                       bound_by=row[f"{part}_bound"][1],
                       plain_and_library_cover="dq+dk+dv")
        return out

    src = "bigdl_tpu_torch/kernels/csrc/"
    table = {"kernels": [
        {"name": "layer_norm_fwd", "route": "cuda",
         "source": src + "layernorm.cu",
         "replaces": "bigdl_tpu/kernels/layernorm.py:31",
         "launches": launches["layer_norm_fwd"], "shape": ln["shape"],
         "dtype": ln["dtype"], "max_abs_err": ln["err"], "ms": ln["ms"],
         "plain_ms": ln["plain_ms"], "bound_ms": ln["bound_ms"],
         "bound_by": ln["bound_by"], "library_ms": ln["library_ms"],
         "paths": paths["layer_norm_fwd"],
         "training_shape": ln_t["shape"], "training_ms": ln_t["ms"],
         "training_bound_ms": ln_t["bound_ms"],
         "training_library_ms": ln_t["library_ms"],
         "training_copy_ms": ln_t["copy_ms"],
         "decode_shape": ln_dec["shape"], "decode_ms": ln_dec["ms"],
         "decode_library_ms": ln_dec["library_ms"],
         "serving_extras": ln_extras,
         "launch_floor_ms": floor_ms,
         "design": "one warp per row (4 rows a CTA), the row in registers, "
                   "128-bit loads and stores, statistics by warp shuffles",
         "registers": ln_build[("ln_fwd_warp", "float32", "float32", 4,
                                 4)].get("registers"),
         "bf16_training": dict(bf16_training("layer_norm_fwd"), registers=(
             ln_build[("ln_fwd_warp", "bfloat16", "bfloat16", 8, 2)]
             .get("registers")))},
        {"name": "layer_norm_bwd", "route": "cuda",
         "source": src + "layernorm.cu",
         "replaces": "bigdl_tpu/kernels/layernorm.py:99 (_fln_bwd, plain "
                     "jnp)",
         "launches": train_counts["layer_norm_bwd"], "shape": lnb["shape"],
         "dtype": lnb["dtype"], "max_abs_err": lnb["err"], "ms": lnb["ms"],
         "plain_ms": lnb["plain_ms"], "bound_ms": lnb["bound_ms"],
         "bound_by": lnb["bound_by"], "library_ms": lnb["library_ms"],
         "paths": paths["layer_norm_bwd"],
         "bf16": {k: find_row(lnb_rows, lnb["shape"], "bfloat16")[k]
                  for k in ("ms", "bound_ms", "library_ms", "err")},
         "bf16_training": dict(bf16_training("layer_norm_bwd"), registers=(
             ln_build[("ln_bwd_warp", "bfloat16", "bfloat16", 8, 2)]
             .get("registers"))),
         "design": "one warp per row (8 warps a CTA, ~2 CTAs an SM striding "
                   "over rows), the row in registers; dgamma/dbeta partials "
                   "per CTA summed by a second kernel in a fixed order, no "
                   "float atomics",
         "registers": ln_build[("ln_bwd_warp", "float32", "float32", 4,
                                 4)].get("registers")},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "bigdl_tpu/kernels/flash_attention.py:54",
         "launches": launches["flash_attention_fwd"], "shape": fa["shape"],
         "dtype": fa["dtype"], "max_abs_err": fa["err"], "ms": fa["ms"],
         "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
         "bound_by": fa["bound_by"], "library_ms": fa["library_ms"],
         "paths": paths["flash_attention_fwd"],
         "training_shape": fa_t["shape"], "training_ms": fa_t["ms"],
         "bound_3xtf32_ms": fa["bound_3xtf32_ms"],
         "training_bound_ms": fa_t["bound_ms"],
         "training_bound_3xtf32_ms": fa_t["bound_3xtf32_ms"],
         "training_library_ms": fa_t["library_ms"],
         "bf16": bf16, "design": design,
         "bf16_training": bf16_training("flash_attention_fwd"),
         "beam_search": {k: beam_row[k] for k in (
             "shape", "dtype", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "bound_3xtf32_ms", "err")} | {
             "launches": llama["beam_counts"]["flash_attention_fwd"]},
         "seq2seq": s2s_flash(fa_rows, "flash_attention_fwd")},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": src + "flash_attention_bwd.cu",
         "replaces": "bigdl_tpu/kernels/flash_attention.py:132",
         "launches": train_counts["flash_attention_bwd_dq"],
         "shape": bwd["shape"], "dtype": bwd["dtype"],
         "max_abs_err": bwd["err_dq"], "ms": bwd["dq_ms"],
         "plain_ms": bwd["plain_ms"], "bound_ms": bwd["dq_bound"][0],
         "bound_by": bwd["dq_bound"][1], "library_ms": bwd["library_ms"],
         "plain_and_library_cover": "dq+dk+dv",
         "library_backend": bwd["library_backend"],
         "paths": paths["flash_attention_bwd_dq"],
         "bound_3xtf32_ms": bwd["dq_bound_3xtf32_ms"], "bf16": bwd_bf16,
         "bf16_training": bf16_training("flash_attention_bwd_dq"),
         "seq2seq": s2s_flash(bwd_rows, "flash_attention_bwd_dq"),
         "design": design_of("flash_bwd_dq_kernel", bwd["plans"][0],
                             bwd_summary)},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": src + "flash_attention_bwd.cu",
         "replaces": "bigdl_tpu/kernels/flash_attention.py:199",
         "launches": train_counts["flash_attention_bwd_dkv"],
         "shape": bwd["shape"], "dtype": bwd["dtype"],
         "max_abs_err": bwd["err_dkv"], "ms": bwd["dkv_ms"],
         "plain_ms": bwd["plain_ms"], "bound_ms": bwd["dkv_bound"][0],
         "bound_by": bwd["dkv_bound"][1], "library_ms": bwd["library_ms"],
         "plain_and_library_cover": "dq+dk+dv",
         "library_backend": bwd["library_backend"],
         "paths": paths["flash_attention_bwd_dkv"],
         "bound_3xtf32_ms": bwd["dkv_bound_3xtf32_ms"], "bf16": bwd_bf16,
         "bf16_training": bf16_training("flash_attention_bwd_dkv"),
         "seq2seq": s2s_flash(bwd_rows, "flash_attention_bwd_dkv"),
         "design": design_of("flash_bwd_dkv_kernel", bwd["plans"][1],
                             bwd_summary)},
        *nms_table_rows(detection, paths, src),
    ], "serving": {"programs": programs, "first_round": cold,
                   "second_round": warm,
                   "decode_step_eager": eager_step,
                   "decode_step_replayed": replayed_step},
        "training": {"step_ms": run["step_ms"],
                    "tokens_per_s": run["tokens_per_s"],
                    "kernel_ms_per_step": kernel_ms,
                    "replay_vs_eager": run["eager"],
                    "fused": {"fuse": FUSE, "step_ms": run_fused["step_ms"],
                              "tokens_per_s": run_fused["tokens_per_s"],
                              "replay_vs_eager": run_fused["eager"]},
                    "profile": {k: (run["profile"] or {}).get(k)
                                for k in ("busy_ms", "wall_ms",
                                          "host_calls")},
                    "bf16": {"step_ms": run16["step_ms"],
                             "tokens_per_s": run16["tokens_per_s"],
                             "kernel_ms_per_step": kernel_ms16,
                             "one_step_check": bf16_check,
                             "flat_update_step_ms": run16_flat["step_ms"],
                             "remat_step_ms": run16_remat["step_ms"],
                             "remat_launches": remat16,
                             "replay_vs_eager": run16["eager"],
                             "fused": {"fuse": FUSE,
                                       "step_ms": run16_fused["step_ms"],
                                       "tokens_per_s":
                                           run16_fused["tokens_per_s"],
                                       "replay_vs_eager":
                                           run16_fused["eager"]},
                             "profile": {k: (run16["profile"] or {}).get(k)
                                         for k in ("busy_ms", "wall_ms",
                                                   "host_calls")}}},
        "llama": dict(llama["summary"], kernel_ms_per_step=llama_kernel_ms),
        "vision": vision, "serving_extras": extras, "robustness": robust,
        "feed": feed, "text": text, "serving_stack": stack,
        "finetune": finetune, "tail": tail, "recsys": recsys,
        "quantized": quantized,
        "detection": {k: v for k, v in detection.items()
                      if k != "nms_rows"}, "images": images,
        "distributed": distributed, "elastic": elastic}
    print(json.dumps(table), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
