"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --tp-nccl N   # phases 1, 2, 5, then 5f across
                                        # N cards over NCCL, a card a rank
    python3 chip_smoke.py --sanitize    # each kernel once at small odd
                                        # shapes (run under compute-sanitizer
                                        # by phase 2b)
    python3 chip_smoke.py --turns DIR   # the LayerNorm forward, backward
                                        # and host cost, dropout, gpt3-1.3b
                                        # serving and three training steps
                                        # with the package of the checkout
                                        # DIR and with this one, in turns

Phases, each of which raises on failure:

1. card — the GPU's name and power limit (``nvidia-smi``) and versions;
2. build — compiles every CUDA kernel of the port from ``csrc/`` (one
   ``nvcc`` per source, all at once) into ``build/paddle_tpu_torch/``:
   ragged paged attention, flash attention, fused Adam, fused
   LayerNorm, dropout and the global norm;
2b. kernelcheck — ``analysis.kernelcheck`` certifies every kernel entry:
   its ptxas rows within its ``KernelBudget`` (registers, static plus
   dynamic shared memory within 227 KiB, registers x threads within the
   SM's 65,536, spills no more than the frozen bytes), its C launch
   geometry (each source's ``*_geometry`` query) equal to its Python plan
   at every phase-3 shape, its output maps injective and covering; prints
   the banked ``bound_ms`` and the bank's diff; counts the tensor-core
   instructions (``HMMA...TF32``) ``cuobjdump -sass`` finds in each float32
   flash program (3xTF32 on ``mma.sync``) and fails at 0; counts the
   dropout forward's instructions a mask element by pipe in its SASS
   (``dropout_sass_ops``: the INT32 ALU pipe bounds it) and fails where
   the count differs from kernelcheck's ``DROPOUT_INT_OPS``. Then each kernel once at
   small odd shapes under ``compute-sanitizer --tool memcheck`` and
   ``--tool racecheck`` (``--sanitize``, a subprocess with a time limit;
   any error fails the script) — left out, with the tool's own words,
   when the toolkit's sanitizer cannot run a trivial CUDA program on this
   machine;
3. kernels — holds each kernel against its plain PyTorch version on the
   card on the same inputs: the ragged kernel at the serving path's
   shapes (decode, cold prefill, prefix-tail prefill, verify; head_dim 64
   and 128; float32 and bfloat16; page tables with inactive null-page
   rows), over float pools and over int8 pools written by
   ``paged_write_quant`` (a third of the positions written again at 3x
   the magnitude, so those pages' scales grow; with q in bfloat16 the
   kernel and the plain version are each held against the plain version
   with q in float32, the kernel's error at most twice the plain one's);
   the LayerNorm forward and backward kernels (dx, and dgamma and dbeta
   within LN_SUM_RTOL of the plain version's float32 sums, the backward
   equal bit for bit run to run) at [8192, 1024] (the training
   shape), [4096, 2048] (a 1.3B prefill), [8, 2048] (a decode step),
   [1001, 64] (rows no multiple of 8, a small d), [37, 99] and [3, 20]
   (the element-wise path), [5, 8192], [8192, 768] (BERT), [8192,
   512] (Transformer-base), [1001, 776], [1001, 2048] (the forward's
   rows program at 8 warps a row, odd rows) and [1001, 1032] (5 warps a
   row, the last one mostly idle), in float32 (against the plain
   version) and bfloat16 (the kernel's error against the plain version
   in float32 at most twice the plain bf16 version's); flash attention
   forward and backward (o, dq, dk, dv) at the training shape
   [8, 16, 1024, 64] causal, [2, 16, 512, 128] causal,
   [2, 4, 384, 64] non-causal, tails that are no multiple of the 64-row
   tile ([2, 8, 1000, 64] causal; s_q 200 / s_k 333 at head_dim 128),
   causal s_q 256 / s_k 640 (splash's offset) and [1, 16, 4096, 64]
   causal (splash's route), [64, 12, 128, 64] non-causal (BERT) and
   [16, 12, 512, 64] non-causal (ERNIE), in
   float32 (against the plain version) and
   bfloat16 (kernel and plain version each against the plain version in
   float32 on the upcast inputs: the kernel's error at most twice the
   plain one's); fused Adam in one multi-tensor call over the training
   path's 292 parameter shapes and odd sizes (1 to 1,000,003 elements),
   the gradients float32 and bfloat16 in turn, unclipped and with a
   global-norm clip's scale on the device (bit for bit, in the launches
   of ``adam_launch_plan``); dropout at the training shapes [8, 1024,
   1024] and [8, 16, 1024, 64], sizes 1 and 1,000,003 and broadcast masks
   (``axis`` 0, [0, 1], [2]), float32, bfloat16 and float64, p 0.1 and
   0.5, both modes: the forward's y without and with its packed bits,
   the bits, and the backward from the bits (bit for bit); the global norm
   over the 292 gradient shapes and odd sizes (sum of squares and clip
   scale within a relative 2e-5, run to run equal). Then it times each
   kernel, its
   plain version and a library yardstick at the main paths' shapes on
   the device alone (``time_ms``: the host's launch gaps hidden behind a
   sleep kernel), beside the least time the card could take
   (``bound_ms``): the ragged kernel's three programs at the batch-8 and
   batch-1 decode, the 512-token prefill, a 64-token tail over 200
   cached positions, the speculative verify (the decode batch, 5 queries
   a row) and a 128-token prefill chunk over 256 prefilled positions
   (float and int8 pools), and each program at cold
   prefills of 8-64 queries (the tensor-core threshold); the flash
   forward twice on the same inputs (o and lse equal) and the backward
   twice (dq within one bf16 step, dk and dv equal); the host's cost per
   LayerNorm call; then the ragged kernel at one rank's shard of
   gpt3-1.3b at TP=2 (8 heads of 128, bf16), the decode batch and the
   512-token prefill over bf16 and int8 pools, checked (the same rules)
   and timed. The build logs each kernel's ptxas registers, shared
   memory and spills;
4. fp32 check — ``gpt3-1.3b`` at full width in float32 (random weights
   from a seed) serves 2 requests; every greedy token must equal the
   argmax of the model's no-cache forward over the same sequence (a
   reference path whose attention is the flash kernel, held against its
   plain version in phase 3), except past a position whose reference
   top-2 logits are within 1e-3 (a numerical tie); then twice more:
   with n-gram speculation at depth 4 and 64-token prefill chunks (the
   same greedy rule), and sampled (temperature 0.8, top-k 50, top-p
   0.95, seed 0), where every token must equal the port's
   ``sample_logits`` of the reference's logits under the engine's key
   ``fold_in(fold_in(key(0), rid), t)``, except past a position whose
   two largest perturbed logits are within 1e-3;
5. serve — the main path: ``gpt3-1.3b`` in bfloat16 serves 16 requests
   (prompts 32-512 tokens, four sharing a 256-token prefix, 64 new tokens
   each) through ``ServingEngine``; every kernel's launch counter is set
   to 0 just before and read just after, and each must equal its launches
   on that path: the ragged kernel 24 and the LayerNorm forward 49 per
   prefill and per decode step, the ragged launches by program as the
   shapes give them (every decode step on the split program, every bf16
   prefill bucket from ``MMA_MIN_QUERIES`` on the tensor cores) and every
   plain version's count 0. Like every serving phase, it runs the
   engine's default configuration, the observability layer on;
5c. serve sampled, chunked, speculative, swapped — phase 5's requests
   three times (each leg's counters set to 0 just before and read just
   after; the ragged launches by program must equal what the calls'
   shapes give, every verify step on the split program, the LayerNorm
   forward 49 per target forward plus the draft's, every plain version
   0): (a) sampled as in phase 4, prefill chunks of 128; (b) greedy,
   n-gram speculation at depth 4, chunks of 128, a pool of 145 pages so
   that swap preemption fires (swaps out > 0, swaps in = swaps out), the
   share of its tokens equal to phase 5's; (b) again over int8 pools;
   (c) greedy with a draft proposer (a 2-layer GPT at gpt3-125m's width,
   vocab 50304, from the seed) at depth 4, window 8, on 4 requests;
5d. observe — phase 5's requests four times in turns, the observability
   layer on, off, off, on: the launches (the ragged kernel's by program,
   the LayerNorm forward's, every plain version's 0) must be equal in all
   four; tokens/s and the mean decode-step ms of each, and from the last
   traced leg's ``ServingMetrics`` the TTFT, TPOT and queue-wait p50/p99
   and each phase's share of step time (``serving_step_phase_s``); then
   the same requests through a traced and an untraced engine stepped
   alternately, each step's host ms (the legs drift with the host). Then
   with two tenants, ``interactive`` and ``batch``, each with a
   ``TenantSLO``: goodput + badput must equal ``serving_tokens_total``, no
   watchdog may fire, and the flight record and Chrome trace it writes
   must validate and load, ``python -m paddle_tpu_torch.obs
   --flight-record ... --tenant-table`` must exit 0 and the Prometheus
   exposition must parse. Then chunks of 128 under an ``SLOConfig`` whose
   ``tpot_p99_s`` is half the traced TPOT p99: the controller must
   throttle; its ``chunk_limit`` at each change is printed;
6. profile — a short window of decode steps under ``torch.profiler``:
   device time by kernel, the device's busy share and the host's kernel
   launches a step (again for int8 pools in 6b);
6b. serve int8 — the same model and requests through int8 KV pools
   (``kv_dtype="int8"``): the int8 ragged kernel 24 and the LayerNorm
   forward 49 launches per step, plain versions 0, and the share of greedy
   tokens equal to phase 5's; then ``bench.py``'s KV-quantisation scenario
   at this width in three legs — bf16 pools sized so that one burst of 8
   whale requests (512 tokens, 64 new) fills the pool, int8 pools at the
   same byte budget, int8 pools at the bf16 page count plus a 64 MiB host
   tier — under a 256-token system prefix shared by warm requests (prefix
   + 32 tokens, 64 new), three cycles of a warm burst and a whale burst:
   the bf16 leg evicts but restores nothing, the tier leg restores pages
   and prefills no more tokens than the bf16 leg, and the byte-matched
   int8 leg prefills no more than the tier leg;
5g. debug checks — phase 5's model and requests under
   ``ServingConfig(debug_checks=True)``, over bf16 pools then int8 pools:
   tokens equal to phase 5's (and 6b's) bit for bit, no retrace,
   ``compile_counts`` the pad buckets used plus 1, host syncs exactly the
   decode steps plus the completed prefills (the card's sync debug mode
   counting what the patched reads cannot see), every audited program
   with no collective and no host read and its pools written in place,
   ``serving_mfu`` and ``serving_hbm_bw_util`` in (0, 1]; prints each
   program's cost-model flops, peak bytes beside
   ``torch.cuda.max_memory_allocated`` and its drift, and tokens/s and the
   mean decode-step ms with the checks on and off in turns (on, off, off,
   on); the kernel A/B gauges (``serving_kernel_speedup_*{kernel=}``,
   the reference's labels): each prediction equal to the port's
   kernelcheck bank, every decode (or verify) dispatch fed on the
   kernel's leg with its mean ms, the measured half absent (no plain
   version runs on the card); then phase 5c's leg (b) under the checks:
   ``verify`` audited, the swap movers counting their calls;
5e. fleet — three replicas of phase 5's model (one set of weights, a pool
   each) behind ``FleetRouter``: phase 5's 16 requests, then 8 more on
   the shared 256-token prefix, under affinity, round-robin,
   round-robin, affinity routing (each leg's counters set to 0 just
   before and read just after, the ragged launches by program as the
   shapes give them, every plain version 0): tokens/s, prefix-hit tokens
   by replica (affinity must hit more than round-robin); wave 1's tokens
   must equal phase 5's. Then a page fetch over a lossless
   ``SimChannel``: request Y's prefix pages read from the warm replica,
   framed (bf16, tag 2), decoded and restored into a cold replica's host
   tier; Y's tokens must equal a local prefix hit's. Then a seeded chaos
   soak (``serving.chaos.soak``) at the same width with 2 layers, every
   fault point armed, the invariants checked after every router step;
5f. tensor parallelism — ``distributed.spawn`` starts two ranks on the one
   card over gloo (NCCL refuses two ranks on one device; gloo stages
   CUDA tensors through the host); each joins the group, builds
   gpt3-1.3b from phase 5's seed and serves phase 5's requests at TP=2 in
   bf16, over int8 pools and with quantized logits (launches checked per
   rank), counting the all-reduces of every forward (49, or 50 with
   quantized logits), every leg under ``debug_checks``: each audited
   program's collective census equal to ``TPContext.step_budget`` (count
   and bytes), ``serving_ici_bytes_per_token`` > 0 and
   ``serving_dcn_bytes_per_token`` 0 on the default one-host topology,
   the link model's predicted collective seconds printed beside the
   measured all-reduce ms; the ranks' tokens must be equal and the share
   equal to phase 5's is reported, with the host ms of one all-reduce of a
   decode step's and a prefill's partial sum. Then, on a rank, 2 layers
   at that width in float32 with TF32 off at TP=1 and TP=2: logits within
   1e-4 of each other (relative to the largest), tokens equal to the
   no-cache forward's argmax under phase 4's tie rule. A rank that
   raises or outlasts its join limit fails the script;
7. training fp32 check — ``gpt3-350m`` widths with 2 layers, batch 2,
   seq 256, in float32 with TF32 off, and a copy of it on the CPU (where
   the plain versions run) take 2 AdamW steps each under the pretraining
   recipe (dropout 0.1 with the same keys, ``ClipGradByGlobalNorm(1.0)``,
   a warm-up then cosine learning rate) and the ``dots`` remat policy:
   the losses, every gradient of step 1 and every parameter after step 2
   agree within the stated tolerances, and at most a share of 1e-4 of
   the parameters are off by more than 1e-6;
8. train — the second main path: ``bench.py``'s ``350M-b8-off`` rung at
   full width (``gpt3-350m``: hidden 1024, 24 layers, 16 heads, vocab
   50304; batch 8, seq 1024, no remat; bf16 with float32 masters;
   ``loss_chunk`` 2048) through ``train.build_train_step``: 2 warm-up
   steps, then 10 timed steps on one seeded batch. The counters are set
   to 0 just before the 10 steps and read just after: flash forward 24,
   flash backward 24, fused Adam the plan's launches (one where the
   toolkit takes 32,764 bytes of kernel parameters) updating 292
   tensors, LayerNorm forward 49, its backward kernel 49 and reduction 49
   launches a step,
   every plain version 0. The loss must be finite and lower at the last
   step than at the first;
8b. train the recipe — ``bench.py``'s ``350M-b8-dots`` and
   ``350M-b8-full`` rungs at full width under the pretraining recipe
   (Megatron-LM's GPT-345M: dropout 0.1, ``ClipGradByGlobalNorm(1.0)``,
   ``LinearWarmup(CosineAnnealingDecay(1.5e-4, 1000), 2, 0, 1.5e-4)``; the
   base key bench.py passes every step), 2 warm-up steps and 10 timed
   steps each, the counters set to 0 just before and read just after and
   held to what the code gives (``expected_train_launches``: dropout
   forward 1 + 5L and backward 1 + 3L, flash forward 2L and backward L,
   LayerNorm forward 4L + 1, backward and reduction 2L + 1 each, the
   global norm's plan + 1,
   Adam's plan; every plain version 0); the loss finite and falling;
   the dots step profiled by layer (and the host's largest self times);
   then both rungs again with bench.py's options (no dropout, no clip, lr
   1e-4), what remat costs alone. Peak memory must order full < dots <
   off (phase 8);
8c. the other rungs — ``350M-b4-full`` and ``125M-b8-full`` at their full
   widths under the recipe, 4 timed steps each, with their launches;
9. training profile — one training step under ``torch.profiler``: device
   time by kernel and by layer (the LayerNorm kernels split out), the
   device's busy share; then the fused head + cross-entropy alone and 5
   training steps, each with the backward's dh and dw formed three ways,
   in turns: from the float32 logit gradient as two bf16 products of its
   hi and lo parts (the port's), from it in one TF32 product (the
   alternative) and from the gradient rounded to bf16 first (the
   earlier way, before the backward kept the float32 gradient).

10. the dygraph surface — ``examples/train_gpt.py``'s workflow through
   the port's Paddle surface (``import paddle_tpu_torch as paddle``) at
   ``gpt3-350m``'s full width, batch 8, seq 1024, float32, no dropout,
   no remat: ``seed``, ``set_device("gpu")``, ``to_tensor`` of a seeded
   numpy batch, ``model(ids, labels=)`` (a ``paddle.Tensor`` loss),
   ``backward``, ``AdamW(learning_rate=CosineAnnealingDecay,
   parameters=model.parameters())``, ``step`` / ``sched.step`` /
   ``clear_grad``, ``float(loss.numpy())``, 5 steps with the counters set
   to 0 just before and read just after (flash forward and backward in
   float32 at head_dim 64 24 each, LayerNorm forward, backward and
   reduction 49 each,
   fused Adam the plan's launches a step, every plain version 0); the
   loss finite and falling; ms a step, then the same step on plain
   tensors and through the surface in turns (the subclass's host cost);
   the float32 flash kernels timed at this shape against both bounds
   (3xTF32 on the tensor cores, and the CUDA cores' float32 rate) and
   against ``scaled_dot_product_attention`` by default and under the
   memory-efficient backend, the library's backend named as PyTorch's
   dispatch chooses it; two runs of each float32 kernel at this shape (o, lse, dk,
   dv equal bit for bit, dq within DQ_RUN_FP32_RTOL / ATOL); peak memory; then
   ``save`` of the ``state_dict`` to a temporary directory, ``load`` and
   ``set_state_dict`` into a fresh model: seconds, file bytes, and the
   reloaded model's logits on a fixed batch bit-equal to the saved
   model's;
11. BERT through ``nn.Layer`` — (a) a 2-layer, hidden-128 float32
   ``BertForPretraining`` on the card and a CPU copy with its weights
   (``set_state_dict``), three AdamW steps each: losses, step-1
   gradients and the parameters within BERT_CHECK_TOL; (b) fused Adam
   against its plain version, bit for bit, at BERT-base's 205 parameter
   shapes (bf16 gradients and parameters, float32 masters), then
   ``tools/bert_bench.py``'s first rung through the entry points
   (``seed``, ``BertForPretraining(BertConfig(...))``,
   ``model.to(dtype="bfloat16")``, ``AdamW(multi_precision=True)``,
   ``backward`` / ``step`` / ``clear_grad``): BERT-base, dropouts 0,
   batch 64, seq 128, 8 seeded batches, 2 warm-up and 6 timed steps each
   ended by a host read of the loss, with the counters set to 0 just
   before and held to ``expected_bert_launches`` just after (flash 12 +
   12, LayerNorm 26 + 26 + 26 (forward, backward, reduction), Adam the
   plan's, plain 0): ms a step,
   sequences/s, MFU, peak memory, falling losses; (c)
   ``BertForSequenceClassification`` at that width, batch 32, under a
   padding mask, 5 steps: no flash launch (a mask takes the composite);
   (d) every case of ``analysis.layercheck`` (every layer class of
   ``nn``) forward and backward on the card against a CPU copy within
   its tolerance; then the bf16 flash and LayerNorm kernels timed at
   BERT's shapes.

12. vision through ``nn`` — (a) ``resnet50()`` at 224 x 224, batch 4, on
   the card and on a CPU copy with its weights, three Momentum steps
   (0.1 / 0.9) each in float64 (in float32 at batch 4 the BatchNorms'
   backward leaves layer4's gradients only 22% right even on one device,
   and the loss climbs to about 60): losses, step-1 gradients,
   parameters and BatchNorm buffers within BERT_CHECK_TOL; then each of
   its 23 distinct convolutions in float32, forward and both gradients,
   against float64 with cuDNN's TF32 allowed process-wide: the port's
   local flag must keep every one within CONV_FP32_RTOL; (b)
   ``tools/resnet_bench.py``'s first rung: ResNet-50, batch 256, 224 x
   224, bf16 with float32 masters, ``Momentum(0.1, 0.9,
   multi_precision=True)``, images and labels drawn as the bench draws
   them, three passes over its 8 batches with the counters set to 0
   just before and read just after (every hand-written kernel 0: the
   reference's conv, pooling, BatchNorm and Momentum are XLA, not
   Pallas): ms a step (steps 3-8, median and spread), images/s, MFU
   against 989 TFLOP/s (flops from the layers' shapes), peak memory,
   the last pass's mean loss below the first's; one step profiled in
   two windows (forward and backward by layer, the optimizer step) with
   the device's busy share; (c) LeNet, batch 64, 1 x 28 x 28, float32,
   card against CPU copy under (a)'s limits; (d) the layer cases of
   item 12b-2 (``layercheck.SLICE_12B2``) on the card against CPU copies;
   (e) beam search (``BeamSearchDecoder`` over an ``LSTMCell`` through
   ``dynamic_decode``): tokens, parents and lengths equal to a CPU
   copy's.
13. text models and the vision zoo through ``nn`` — (a) ERNIE-3.0-base
   MLM pretraining (``ernie_config("ernie-3.0-base")``: hidden 768, 12
   layers, vocab 18,000, both dropouts 0.1; random weights from the
   seed): fused Adam against its plain version, bit for bit, at its 202
   live parameter shapes (AdamW's decay), then batch 16 at seq 512, 15% of positions labelled, bf16 with
   float32 masters, ``AdamW(1e-4)``, 2 warm-up and 6 timed steps with the
   counters set to 0 just before and read just after (flash 12 + 12,
   LayerNorm 26 + 26 + 26, dropout 37 + 37, Adam by its plan, every plain
   version 0): ms a step, sequences and tokens/s, MFU (6N + 12 L s h a
   token against 989 TFLOP/s), peak memory, one step profiled by layer
   with the device's idle share; (b) Transformer-base
   (``TransformerMTConfig()``: d_model 512, 8 heads, 6 + 6 layers, FFN
   2,048, dropout 0.1, label smoothing 0.1, vocabularies of 10,000)
   training on 64 pairs of lengths 16-128 padded to 128, bf16 with
   masters, ``Adam(0.9, 0.98, 1e-9)`` under ``NoamDecay(512, 4000)``
   (fused Adam against its plain version first, as in (a), no decay): the
   same readings plus real target tokens/s, and no flash launch (every
   attention is masked: the composite; LayerNorm 30 + 30 + 30, dropout 62 +
   62); (c) its ``translate`` with beam 4 on 16 of those sources in bf16:
   seconds, tokens/s, decoder steps and host reads by the line that made
   them (at most one a step and the closing synchronize); every best
   beam ends in ``eos`` or at ``max_len`` and is pad-filled past its
   length; (d)
   float64 on the card against a CPU copy: the float64 dropout kernel
   against its plain version bit for bit, then ERNIE at base width with
   2 layers (its dropouts on) and Transformer-base width with 2 + 2
   layers: the loss within 1e-9 and every gradient within 1e-9 of its
   own largest, then ``beam_search``'s ids, parents and lengths equal;
   (e) ``alexnet``, ``vgg16``, ``squeezenet1_1``, ``mobilenet_v1``,
   ``mobilenet_v2``, ``mobilenet_v3_large``, ``shufflenet_v2_x1_0``,
   ``googlenet``, ``inception_v3`` (299 x 299) and ``densenet121`` at 224
   x 224: a float64 training-mode forward and backward at batch 2 on the
   card against a CPU copy (loss within 1e-9, gradients and BatchNorm
   buffers within 1e-7 of their own largest), then bf16 ``Momentum(0.1,
   0.9)`` steps at batch 64 for images/s; then the flash kernels timed at
   ERNIE's ``[16, 12, 512, 64]`` non-causal and the LayerNorm kernels at
   Transformer-base's ``[8192, 512]``, both shapes also in FLASH_CASES
   and LN_SHAPES, so that phase 3 holds the kernels against their plain
   versions there.

14. the data half — (a) ``vision.ops`` at the widths of public
   detectors, each operator first in float64 on the card against a CPU
   copy of the same call (index outputs equal, values within 1e-10 of
   the larger of 1 and their largest), then in float32: the median ms of
   20 calls (``time_ms``'s flush and sleep), and one call's device
   operations (the ATen operations on the card that are no view, under
   a dispatch mode) and host reads (the synchronising calls
   ``set_sync_debug_mode("warn")`` reports). Faster R-CNN R50-FPN
   on COCO (two 800 x 1344 images, P2-P5 of 256 channels): ``nms`` of
   2,000 proposals clustered as an RPN's are (:func:`rpn_proposals`) at
   IoU 0.7, with its sweep's passes, ``distribute_fpn_proposals`` of 1,000
   RoIs an image over levels 2-5, ``roi_align`` 7 x 7 (ratio 2,
   aligned) on each level's RoIs forward and backward, and with all
   2,000 RoIs on P2 (its float64 peak memory under 8 GiB), ``box_coder``
   decoding 1,000 boxes, ``multiclass_nms`` of ``[81, 1000]`` scores
   over 1,000 such RoIs (threshold 0.05, top 1,000 / 100, IoU 0.5),
   ``anchor_generator`` on
   ``[1, 1024, 50, 84]``; YOLOv3-DarkNet53 at 608, batch 8, COCO's nine
   anchors: ``yolo_box`` (conf 0.005) and ``yolo_loss`` (50 boxes an
   image, forward and backward) on each head; DCNv2 at ResNet-50's res5
   (``deform_conv2d``, x ``[2, 512, 25, 42]``, weight ``[512, 512, 3,
   3]``, offset and mask, forward and backward); R-FCN's ``psroi_pool``
   on ``[1, 3969, 50, 84]`` with 300 RoIs; SSD300's ``prior_box`` over
   its six maps (8,732 priors), ``iou_similarity``, ``bipartite_match``
   and ``box_clip`` against 20 boxes; (b) LeNet trained one epoch on the
   card from ``paddle.batch(paddle.reader.shuffle(paddle.dataset.mnist.
   train(), 6000), 64)`` with Adam (1e-3), the fused Adam kernel first
   held bit for bit to its plain version at LeNet's float32 layout and
   its launches counted in the epoch: the first step's loss against
   a CPU copy fed the same batch, the first and last losses, and the
   accuracy on ``mnist.test()`` above 0.5; (c) images/s on the host of
   CIFAR-10's transform chain (its 5,000 synthetic images through
   ``BatchSampler(RandomSampler, 256)``) and ImageNet's
   (``RandomResizedCrop(224)`` on 512 arrays of 3 x 256 x 256), beside
   phase 12's ResNet-50 images/s; its seconds and the script's.

15. the training surface (``amp``, ``autograd``, ``jit``, ``io.DataLoader``,
   ``metric``, ``hapi``, ``profiler``) — (a) ERNIE at base width, 2
   layers, 15 classes, through ``Model.train_batch`` in float64 on the
   card and on a CPU copy (the loss, and every parameter after the AdamW
   step, within 1e-9; phase 13 (d)'s rule); (b) the main path:
   ERNIE-3.0-base, 15 classes (CLUE TNEWS's shape as PaddleNLP fine-tunes
   ERNIE 3.0: max_seq_length 128, batch 32) fine-tuned through
   ``Model.prepare(AdamW(5e-5, weight_decay=0.01) under LinearWarmup(10),
   CrossEntropyLoss(), Accuracy(), amp_configs="O1").fit(...)`` for 2
   epochs of 40 steps over a seeded synthetic set (the first token names
   the class), fed by a DataLoader with 2 workers, with the
   ``LRScheduler``, ``ModelCheckpoint`` and ``VisualDL`` callbacks: the
   second epoch's counters against ``hapi_expected`` (written out before
   the run), every plain version 0, the launch dtypes (flash bfloat16,
   LayerNorm float32), ms a step, sequences/s, MFU, peak memory, host
   reads a step, the loader's wait, the loss's first and last ten steps
   (the last below the first) and the eval accuracy; (c) ``to_static`` in
   eval under O1 bit-equal to eager, ``jit.save`` / ``jit.load`` of the
   float32 eval forward (within 1e-3 of eager; the loaded program launches
   the flash and LayerNorm forward kernels, L and 2L + 1); (e) three steps
   under ``Profiler(targets=[CPU, GPU])`` in ``RecordEvent("step")``
   spans, the trace holding the spans and the flash, LayerNorm and Adam
   kernels; the O2 leg (``amp.decorate(level="O2")``, 10 steps); (d)
   LeNet through ``Model`` in float16 with a ``GradScaler`` and an
   injected inf gradient (that step skipped, the scale halved, the
   found-inf flag one host read a step); (f) phase 14 (c)'s ImageNet
   chain through the DataLoader with 0, 2 and 4 workers beside ResNet-50's
   images/s; its seconds and the script's. Phase 3 holds the flash
   kernels at ``[32, 12, 128, 64]`` and the LayerNorm kernels at ``[4096,
   768]`` (in FLASH_CASES and LN_SHAPES), phase 15's shapes.

16. parallel training (``distributed``, ``distributed.fleet``,
   ``incubate.distributed.models.moe``) — four ranks share the card over
   gloo (NCCL refuses two ranks on one device), spawned once
   (``h16_rank``), each leg's counters set to 0 just before it: (a)
   GPT-350M's width (hidden 1024, 16 heads, vocab 50,304, seq 1,024) at
   2 layers in float32, dp2 x mp2 through ``fleet.init`` ->
   ``apply_megatron_specs`` -> ``distributed_model`` ->
   ``distributed_optimizer(AdamW)`` with ``ClipGradByGlobalNorm(1.0)``,
   against the one-rank port step on the same weights and batch of 8: the
   loss within H16_LOSS_RTOL, each updated parameter within
   H16_PARAM_RTOL of its largest entry (floored at the learning rate);
   (d) sharding 2 x mp2 at ZeRO ``os``, ``os_g`` and ``p_g_os``, two
   steps each, against the one-rank steps, with the optimizer bytes a
   rank; (c) pp2 x dp2 through ``build_gpt_pipeline``, 1F1B over 4
   micro-batches, float32 at 2 layers against the one-rank step of the
   same ``PipelineLayer``; (e) ``MoELayer(1024, 4096, 8 experts, gshard)``
   split over the four ranks, 8 tokens a rank, against the dense layer
   (outputs and expert gradients), then its bf16 ms and all-to-all
   census; (b) the main path: bench.py's 350M-b8-off rung in bf16 at 24
   layers, dp2 x mp2 (a rank: batch 4, 8 heads), dropout 0.1, 2 warm-up
   and 5 timed steps: ms a step, tokens/s over the ranks, the losses
   (finite, falling), peak memory a rank, the launches a step a rank and
   the collective census a step a rank (kind, count, bytes by group),
   each equal to its prediction from the code (``h16_predicted``); (c)
   again in bf16 at 24 layers, 3 timed steps and the send / receive
   census; then in this process (f) ERNIE-3.0-base under
   ``amp.auto_cast(dtype="float16")``: finite, within H16_F16_*_RTOL of
   its float32 run, the flash kernels 0 launches (float16 attention takes
   the composite) and the LayerNorm kernels float32 only.

17. Sequence parallelism (item 12e-2a): four ranks share the card over
   gloo, started by the port's launcher (``python -m
   paddle_tpu_torch.distributed.launch --nproc_per_node 4`` of a trainer
   script the phase writes; the launch's exit code must be 0 within
   H17_JOIN_TIMEOUT_S). GPT-350M's width with max_seq_len 8,192 at b1 x
   s8192 over sp4 through ``build_context_parallel_step``: (a) float32,
   2 layers, ring attention and Ulysses each against the one-rank step
   on the same weights and batch (the loss within H17_LOSS_RTOL, the
   summed gradients within H17_GRAD_RTOL and every updated parameter
   within H17_PARAM_RTOL of its largest entry); (b)
   the main path, bf16, 24 layers, 2 warm-up and 5 timed steps: ms a
   step, tokens/s over the ranks, the losses (finite, falling), peak
   memory a rank, the kernels' launches a step a rank, the ring's blocks
   by kind (rank r: r + 1 a layer, the diagonal causal) and the ring's
   bytes a step a rank, each equal to ``h17_predicted``; then the same
   model on one rank at s8192 (ms a step, peak memory); (c) 2 layers
   bf16 with ``AutoCheckpoint`` every 2 steps, run whole and run again
   with rank 2 exiting at step 3 (``--max_restart 1``: the launcher
   restarts the pod at generation 1, which resumes from ``latest()``):
   the restart's seconds, the checkpoint's bytes, the state after the
   resume against its snapshot bit for bit, the losses after it and the
   weights' drift at each snapshot against the unbroken run's (within a
   multiple of the two runs' run-to-run drift before the fault: the flash
   backward's dq order makes two runs differ); (d) a checkpoint the
   reference wrote on the CPU (``chip_scratch/reference_ckpt``, made by
   ``tests/make_reference_checkpoint.py``; where the checkout has none,
   one the port writes in the reference's format) loaded on the card,
   the next batch's loss against the one given for it; then the flash
   kernels timed at the ring's diagonal block and the one-rank step's
   causal shape.

18. Auto-parallel and the fleet executor (item 12e-2b): (a) the
   completion (``complete_param_specs``) of GPT-350M (24 layers) from
   ``shard_tensor`` annotations on the qkv and fc1 weights and the word
   embedding, the card's model against its CPU copy, every fc2 weight
   row-split and every fc1 and qkv bias split; (b) ``Engine.fit`` over
   four ranks sharing the card over gloo on a dp2 x mp2 ``ProcessMesh``:
   float32 at 2 layers, the completed run against the
   ``apply_megatron_specs`` run (1e-5) and phase 16's ``train_batch`` at
   that layout (H16_LOSS_RTOL); then bf16 at 24 layers at phase 16's
   batch, ms a step, tokens/s, peak memory a rank, launches a step a rank
   against ``h16_predicted``, the census, ``engine.layout``'s counts,
   ``evaluate``, ``predict``, ``save`` and ``load`` into a fresh Engine
   (the same eval loss); (c) ``plan_parallel`` on ``Cluster("h100", 1,
   4)`` and ``("h100", 4, 8)`` (no plan's time is compared with a
   measured one: four ranks share one card), and an Engine given no mesh
   training three steps; (d) GPT-350M bf16 in two stages of 12 blocks
   through the ``FleetExecutor`` over 4 micro-batches, in one process
   (the logits against the one-rank forward, the launches) and over the
   TCP ``MessageBus`` a stage a process (bit for bit), with ms a
   micro-batch against the stages called directly.

Phases 8b and 8c run after phase 9, once phase 8's model is freed, so
that each rung's peak memory is its own; phases 10 to 18 run last.

It prints one ``{"kernels": [...]}`` line (ragged float, ragged int8,
flash forward, flash backward, fused Adam, LayerNorm forward, LayerNorm
backward, dropout forward and backward, global norm — the last three with their launches on phase
8b's dots rung; the ragged entries with their launches by program (phase
5c's legs and 5e's fleet legs too), the verify and chunk timings and the
TP=2 shard's (``tp2_shard``: times, error, launches a rank), the flash
entries with their ptxas rows, phase 10's float32 timings, bounds,
library backend, run-to-run checks and launches (``fp32_surface``) and
the float32 programs' tensor-core instruction counts (``fp32_sass``), Adam with its ptxas rows, Adam with its launches and
tensors per step; the flash, LayerNorm and Adam entries with phase 11's
readings under ``bert``: launches a step, the fine-tune's, and the
kernels' times at BERT's shapes; the flash, LayerNorm, Adam and dropout
entries with phase 13's under ``text``: launches a step of ERNIE and of
Transformer-base, and the flash and LayerNorm times at their shapes; the
flash, LayerNorm, Adam and dropout entries with phase 15's under
``hapi``: launches a step of the fine-tune and the dtypes they took;
the flash, LayerNorm, Adam, dropout and global-norm entries with phase
16 (b)'s launches a step a rank under ``hybrid`` and phase 18 (b)'s
on each rank under ``auto_parallel``; the flash, LayerNorm,
Adam and global-norm entries with phase 17 (b)'s launches a step on each
rank under ``sequence_parallel``, the flash entries also with the ring's
blocks a step by rank, their times at the tile-skip shapes and the
one-rank s8192 step's launches),
one ``{"phase11": ...}`` line, one ``{"phase12": ...}`` line, one
``{"phase13": ...}`` line, one ``{"phase14": ...}`` line, one
``{"phase15": ...}`` line and, last,
``{"ok": true, "device": {...}}``. With no CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

if sys.argv[1:2] == ["--turn-leg"] and len(sys.argv) == 3:
    sys.path.insert(0, sys.argv[2])  # that checkout's package, not this one

import numpy as np
import torch
from torch.nn import functional as F

from paddle_tpu_torch.analysis import kernelcheck as kc
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import dropout as kd
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_layernorm as fl
from paddle_tpu_torch.kernels import fused_optimizer as fo
from paddle_tpu_torch.kernels import global_norm as gn
from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
from paddle_tpu_torch.kernels.paged_attention import (paged_gather,
                                                      paged_gather_quant,
                                                      paged_write_quant,
                                                      ragged_mask)
from paddle_tpu_torch import random as prng
from paddle_tpu_torch.nn import functional as ptf
from paddle_tpu_torch.nn.functional import linear_cross_entropy
from paddle_tpu_torch.obs import (PHASES, TenantSLO,
                                  load_banked_kernel_speedups,
                                  validate_flight_record)
from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.serving import (FleetConfig, FleetRouter, ServingConfig,
                                      ServingEngine, SimChannel, SpecConfig,
                                      Transport)
from paddle_tpu_torch.serving.chaos import ChaosConfig, soak
from paddle_tpu_torch.serving.slo import SLOConfig
from paddle_tpu_torch.text import GPTForCausalLM, gpt_config
from paddle_tpu_torch._device import resolve_device
from paddle_tpu_torch.text.generation import filter_logits, sample_logits
from paddle_tpu_torch.core.rng import trace_rng_scope
from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay, LinearWarmup
from paddle_tpu_torch.train import (BASE_RUNGS, KEY, build_train_step,
                                    flops_per_token)
from paddle_tpu_torch.utils import monitor
from paddle_tpu_torch.utils.clip_grad import ClipGradByGlobalNorm

SEED = 0
PRESET = "gpt3-1.3b"
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# float32-accurate products on the tensor cores: three TF32 products each
# (495 TFLOP/s dense TF32 / 3), the float32 flash kernels' rate
PEAK_TF32X3 = 495e12 / 3
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),   # summation order
       torch.bfloat16: dict(atol=2e-2, rtol=0.0)}   # plain rounds probs
TIE_GAP = 1e-3
L2_FLUSH_BYTES = 64 << 20  # above the 50 MB L2, so each timed launch is cold
# torch.cuda._sleep spins for a count of SM clock cycles: at most the
# H100's 1.98 GHz boost clock, so a lower clock only sleeps longer
SLEEP_CYCLES_PER_S = 2.0e9
# flash kernel vs plain, float32: summation order only
FLASH_TOL_FP32 = dict(atol=1e-4, rtol=1e-4)
# bfloat16, for the flash, int8 ragged and LayerNorm kernels: kernel and
# plain version round at different points (the plain attention rounds the
# probabilities and dP to bf16), so each is held against the plain
# version in float32 on the same inputs upcast, and the kernel's max abs
# error there may be at most this multiple of the plain bf16 version's
# own, plus a small floor
BF16_ERR_RATIO, BF16_ERR_FLOOR = 2.0, 1e-3
# the bf16 flash backward adds each key tile's part of dq into float32 in
# no fixed order: two runs on the same inputs may differ by one bf16 step
# of the larger value (its one rounding flipped) plus float32 reassociation
DQ_RUN_RTOL, DQ_RUN_ATOL = 2.0 ** -7, 1e-5
# the float32 backward adds them into its float32 output: two runs differ
# by float32 reassociation of at most 16 parts (a few ulps of the largest,
# about 1e-6 of the value)
DQ_RUN_FP32_RTOL, DQ_RUN_FP32_ATOL = 1e-5, 1e-6
FLASH_CASES = [  # (label, b, h, s_q, s_k, d, causal)
    ("train", 8, 16, 1024, 1024, 64, True),
    ("causal-d128", 2, 16, 512, 512, 128, True),
    ("noncausal", 2, 4, 384, 384, 64, False),
    ("causal-tail", 2, 8, 1000, 1000, 64, True),      # 1000 = 15 x 64 + 40
    ("rect-tail-d128", 1, 8, 200, 333, 128, True),
    ("splash-offset", 2, 16, 256, 640, 128, True),
    ("splash-route", 1, 16, 4096, 4096, 64, True),
    ("bert", 64, 12, 128, 128, 64, False),            # phase 11's shape
    ("ernie", 16, 12, 512, 512, 64, False),           # phase 13 (a)
    ("ernie-ft", 32, 12, 128, 128, 64, False),        # phase 15 (b)
    # phase 17: a ring rank's blocks at s8192 over sp4 (the diagonal,
    # causal with the tile skip, and a full block), Ulysses' dense
    # attention and the one-rank step
    ("ring-diagonal", 1, 16, 2048, 2048, 64, True),
    ("ring-full", 1, 16, 2048, 2048, 64, False),
    ("ulysses", 1, 4, 8192, 8192, 64, True),
    ("long-8192", 1, 16, 8192, 8192, 64, True),
]
TRAIN_RUNG = BASE_RUNGS[0]  # bench.py's 350M-b8-off
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# the pretraining recipe (Megatron-LM's GPT-345M: dropout 0.1, clip-grad
# 1.0, warm-up then cosine decay) on bench.py's remat rungs (phases 7,
# 8b, 8c)
RECIPE_DROPOUT, RECIPE_CLIP, RECIPE_LR = 0.1, 1.0, 1.5e-4
RECIPE_WARMUP, RECIPE_T_MAX = TRAIN_WARMUP, 1000
# phase 10: examples/train_gpt.py's workflow steps, then the turns that
# time the surface against plain tensors
SURFACE_STEPS, TURN_STEPS = 5, 3
RECIPE_RUNGS = [r for r in BASE_RUNGS if r["tag"] in ("350M-b8-dots",
                                                     "350M-b8-full")]
OTHER_RUNGS = [r for r in BASE_RUNGS if r["tag"] in ("350M-b4-full",
                                                    "125M-b8-full")]
OTHER_STEPS = 4
# LayerNorm kernels vs plain, float32: only the order of the row sums
# differs (bfloat16: BF16_ERR_RATIO)
LN_TOL_FP32 = dict(atol=2e-5, rtol=1e-5)
# dgamma and dbeta: float32 sums over the rows in two orders (the backward
# kernel's partials and their reduction; torch's own), each within its
# depth of sequential additions (at most about 150 at these shapes) times
# 2**-24 of the sum of the terms' magnitudes: the kernel's within
# LN_SUM_RTOL of that sum of the plain version's, plus one step of gamma's
# dtype (2**-7 of the value in bfloat16, which rounds both results once)
LN_SUM_RTOL = 2e-5
LN_EPS = 1e-5
# --turns: the LayerNorm shapes of the GPT, BERT/ERNIE and Transformer-base
# steps, and each leg's time limit
LN_TURN_SHAPES = ("train", "bert", "transformer-base")
TURN_LEG_TIMEOUT_S = 600
LN_SHAPES = [  # (label, rows, d)
    ("train", 8192, 1024), ("prefill-1.3b", 4096, 2048),
    ("decode-1.3b", 8, 2048), ("rows-1001-d64", 1001, 64),
    ("elementwise-d99", 37, 99), ("elementwise-d20", 3, 20),
    ("d8192", 5, 8192), ("bert", 8192, 768),   # phase 11: 64 x 128 rows
    ("transformer-base", 8192, 512),          # phase 13 (b): 64 x 128
    ("rows-1001-d776", 1001, 776),            # the rows program, odd rows
    ("rows-1001-d2048", 1001, 2048),          # forward rows at N = 8
    ("rows-1001-d1032", 1001, 1032),          # N = 5, its last warp idle
    ("ernie-ft", 4096, 768)]                  # phase 15 (b): 32 x 128
# the forward timed at the serving shapes too (phase 3)
LN_SERVING_SHAPES = ("prefill-1.3b", "decode-1.3b")
# bench.py's KV-quantisation scenario at gpt3-1.3b's width
KVQ_CYCLES, KVQ_BURST, KVQ_NEW = 3, 8, 64
KVQ_SYSTEM, KVQ_WARM_TAIL, KVQ_WHALE = 256, 32, 512
KVQ_TIER_BYTES = 64 << 20
# sampling and speculation on the serving path (phases 4 and 5c)
SAMPLING = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.95,
                seed=0)
SPEC_DEPTH = 4
# phase 5c: the pool of leg (b), small enough that swap preemption fires
# with 8 slots of phase 5's requests, and the draft of leg (c)
LEG_B_PAGES = 1 + 144
DRAFT_LAYERS = 2
# phase 5e: the fleet's replicas, its second wave on the shared prefix,
# the fetch leg's host tier and the chaos soak's seed and depth
FLEET_REPLICAS, FLEET_WAVE2 = 3, 8
FLEET_TIER_BYTES = 64 << 20
CHAOS_SEED, CHAOS_LAYERS = 3, 2
# phase 5f: two ranks share the one card, so the backend is gloo (its
# all_reduce stages CUDA tensors through the host); a rank's collective
# timeout and the parent's join limit; TP=2 logits of the 2-layer float32
# model against TP=1's, relative to their largest entry
TP_DEGREE, TP_BACKEND = 2, "gloo"
TP_RANK_TIMEOUT_S, TP_JOIN_TIMEOUT_S = 300.0, 420.0
TP_CHECK_LAYERS, TP_LOGITS_RTOL = 2, 1e-4
# the ragged kernel at gpt3-1.3b's TP=2 shard (phase 3): heads per rank
TP_HEADS = 16 // TP_DEGREE
# phase 2b: the CUDA toolkit's sanitizer and each run's time limit
SANITIZER = "/usr/local/cuda/bin/compute-sanitizer"
SANITIZE_TIMEOUT_S = 300
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    log(f"== {name} (at {time.perf_counter() - T_START:.1f} s)")


# ---------------------------------------------------------------- phase 1
def card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0].strip()
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return line


# ---------------------------------------------------------------- phase 2
def ptxas_report(log_text: str) -> list:
    """``(kernel, registers, shared bytes, spill stores, spill loads)`` for
    every entry function in an ``nvcc -Xptxas -v`` log, the name
    demangled where ``c++filt`` is on the path."""
    rows, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            rows.append([name, None, 0, 0, 0])
        elif name and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            rows[-1][3:5] = int(m.group(1)), int(m.group(2))
        elif name and "Used" in line and "registers" in line:
            rows[-1][1] = int(re.search(r"Used (\d+) registers", line)
                              .group(1))
            m = re.search(r"(\d+) bytes smem", line)
            rows[-1][2] = int(m.group(1)) if m else 0
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        for row, pretty in zip(rows, names):
            row[0] = pretty
    return [tuple(r) for r in rows]


def build() -> dict:
    """Every kernel built from its source, one ``nvcc`` each, all at once;
    logs the seconds of each build and every kernel's registers, static
    shared memory and spills (dynamic shared memory is set at launch)."""
    t0 = time.perf_counter()
    secs = _build.build(_build.KERNELS)
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f} s")
    report = {}
    for name in _build.KERNELS:
        report[name] = ptxas_report(_build.build_log(name))
        for kernel, regs, smem, st, ld in report[name]:
            log(f"  ptxas {name}: {regs} registers, {smem} B static smem, "
                f"spill stores {st} B, loads {ld} B: {kernel[:110]}")
    return {"seconds": secs, "ptxas": report}


# --------------------------------------------------------------- phase 2b
def kernelcheck_phase(built) -> dict:
    """Every kernel entry certified on the card: its library's ptxas rows
    within the budget, and at every main-path and odd shape its Python
    launch plan equal to the C launch geometry, within the budget with
    the ptxas static shared memory and registers, its output maps
    injective and covering. Raises on any violation; returns the bound
    and the certified shapes of each entry."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, spec in kc.REGISTRY.items():
        rows = built["ptxas"][spec.source]
        bad = kc.spill_budget_findings(rows)
        if bad:
            raise RuntimeError(f"kernelcheck {name}: "
                               + "; ".join(str(f) for f in bad))
        shapes = {**spec.shapes, **spec.odd}
        for label, shape in shapes.items():
            shape = dict(shape, sm_count=sms)
            kc.certify(name, shape, ptxas=rows,
                       geometry=kc.c_geometry(name, shape)).enforce()
        _, record = kc.run_kernel(name)
        out[name] = {"shapes": len(shapes), "bound_ms": record["bound_ms"],
                     "bound_by": record["bound_by"]}
        log(f"  kernelcheck {name}: {len(shapes)} shapes, C geometry equal "
            f"to the plan, within budget ({len(rows)} ptxas rows); bound "
            f"at {record['shape']} {record['bound_ms']:.4f} ms "
            f"({record['bound_by']})")
    with open(kc.bank_path()) as fh:
        banked = json.load(fh)
    drift = kc.diff_banked({n: kc.run_kernel(n)[1] for n in kc.REGISTRY},
                           banked)
    log(f"  kernelcheck bank diff: {[str(f) for f in drift] or 'none'}")
    if drift:
        raise RuntimeError(f"kernelcheck bank drifted: {drift}")
    return out


def flash_tensor_core_counts() -> dict:
    """The tensor-core instructions (``HMMA`` on ``TF32`` operands) that
    ``cuobjdump -sass`` finds in each float32 flash program of the built
    library (the forward and the fused backward at head_dim 64 and 128,
    3xTF32 on ``mma.sync``); raises when a program has none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "-sass", str(_build._library_path("flash_attention"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {f"{name}<{d}>": 0 for name in ("flash_fwd_tf32_kernel",
                                             "flash_bwd_tf32_kernel")
              for d in fa.HEAD_DIMS}
    program = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_(?:fwd|bwd)_tf32_kernel)ILi(\d+)E", line)
            program = f"{m.group(1)}<{m.group(2)}>" if m else None
        elif program and "HMMA" in line and "TF32" in line:
            counts[program] += 1
    log(f"  tensor-core instructions (HMMA ... TF32) in the float32 flash "
        f"programs: {json.dumps(counts)}")
    if not all(counts.values()):
        raise RuntimeError(f"a float32 flash program runs no tensor-core "
                           f"instruction: {counts}")
    return counts


def sanitize_calls() -> None:
    """``--sanitize``: every kernel once at small odd shapes, each output
    read back (the sanitizer reports at the synchronisation)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype, s in ((torch.float32, 7), (torch.bfloat16, 17),
                     (torch.bfloat16, 1)):
        q, kp, vp, table, ctx = attention_case(
            gen, b=3, s=s, ctx=[0, 7, 19], d=64, dtype=dtype, h=2, pps=5)
        rpa.ragged_paged_attention(q, kp, vp, table, ctx)
    q, kp, vp, table, ctx, ks, vs = int8_attention_case(
        gen, b=3, s=5, ctx=[0, 7, 19], d=64, dtype=torch.bfloat16, h=2,
        pps=5)
    rpa.ragged_paged_attention(q, kp, vp, table, ctx, k_scale=ks,
                               v_scale=vs)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = flash_inputs(gen, 1, 2, 200, 333, 64, dtype)
        o, lse = fa.flash_attention_forward(q, k, v, causal=True)
        fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
        x, g, b, dy = ln_inputs(gen, 37, 99, dtype)
        _, mu, rstd = fl.layer_norm_forward(x, g, b, LN_EPS)
        fl.layer_norm_backward(x, g, mu, rstd, dy)
        y = kd.dropout(torch.randn(1001, device="cuda", dtype=dtype,
                                   requires_grad=True), (1, 2), 0.1)
        y.backward(torch.ones_like(y))
        kd.dropout(torch.randn(3, 5, 7, device="cuda", dtype=dtype), (1, 2),
                   0.5, axis=[1])
    grads = grad_buffers(gen, [(3,), (4095,), (16385,)])
    gn.global_norm_scale(grads, 1.0)
    fo.fused_adam_update_many(
        [(torch.zeros_like(g, dtype=torch.float32), g,
          torch.zeros_like(g, dtype=torch.float32),
          torch.zeros_like(g, dtype=torch.float32), 1.0, None)
         for g in grads], 1e-4, 0.1, 0.001, beta1=0.9, beta2=0.999,
        eps=1e-8)
    torch.cuda.synchronize()
    print("sanitize calls done", flush=True)


def sanitizer_phase() -> dict:
    """``--sanitize`` under the sanitizer's memcheck and racecheck tools,
    each a subprocess with a time limit; any error fails the script. A
    sanitizer that cannot run even a trivial CUDA program here (its own
    failure, not a kernel's) leaves the step out, logging its words."""
    if not os.path.exists(SANITIZER):
        log(f"  compute-sanitizer: not in the toolkit ({SANITIZER}); step "
            f"left out")
        return {"ran": False, "why": "absent"}
    out = {}
    trivial = [sys.executable, "-c", "import torch; torch.ones(8, "
               "device='cuda').sum().item()"]
    here = os.path.dirname(os.path.abspath(__file__))
    for tool in ("memcheck", "racecheck"):
        probe = subprocess.run([SANITIZER, "--tool", tool, *trivial],
                               capture_output=True, text=True, timeout=120)
        if probe.returncode:
            words = [ln for ln in (probe.stdout + probe.stderr).splitlines()
                     if "Error" in ln or "error" in ln][:2]
            log(f"  compute-sanitizer --tool {tool}: cannot run a trivial "
                f"CUDA program on this machine (exit {probe.returncode}: "
                f"{words}); the step is left out for this tool")
            out[tool] = {"ran": False, "why": words}
            continue
        t0 = time.perf_counter()
        run = subprocess.run(
            [SANITIZER, "--tool", tool, "--error-exitcode", "9",
             sys.executable, os.path.join(here, "chip_smoke.py"),
             "--sanitize"], capture_output=True, text=True,
            timeout=SANITIZE_TIMEOUT_S, cwd=here)
        tail = (run.stdout + run.stderr)[-2000:]
        if run.returncode or "sanitize calls done" not in run.stdout:
            raise RuntimeError(f"compute-sanitizer --tool {tool} found "
                               f"errors (exit {run.returncode}):\n{tail}")
        out[tool] = {"ran": True, "s": time.perf_counter() - t0}
        log(f"  compute-sanitizer --tool {tool}: every kernel clean in "
            f"{out[tool]['s']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 3
def attention_case(gen, *, b, s, ctx, d, dtype, h=16, page_size=16, pps=64,
                   inactive_rows=1):
    """Random pools and q on the card; a page table of distinct random
    pages per row, the last ``inactive_rows`` rows all null page with
    ctx 0 (inactive slots). ``ctx`` is an int or a per-row list."""
    num_pages = 1 + b * pps
    dev = "cuda"
    k_pool = torch.randn((num_pages, page_size, h, d), generator=gen,
                         device=dev).to(dtype)
    v_pool = torch.randn((num_pages, page_size, h, d), generator=gen,
                         device=dev).to(dtype)
    q = torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    table = perm.view(b, pps).to(torch.int32)
    ctx_lens = torch.as_tensor(np.broadcast_to(ctx, (b,)).copy(),
                               dtype=torch.int32, device=dev)
    if inactive_rows:
        table[-inactive_rows:] = 0
        ctx_lens[-inactive_rows:] = 0
    return q, k_pool, v_pool, table, ctx_lens.contiguous()


def bound(q, k_pool, table, ctx_lens, quant=False):
    """(ms, "bytes" | "operations"): the least time the card could take —
    each input byte this call's data needs read once (the visible K/V
    prefix of every row at the pool's element size, for int8 pools also
    the float32 K and V scale of each page and head it covers, q, the
    table) and the output written once, over the HBM rate, against the
    score and PV operations over the peak rate of q's dtype."""
    b, h, s, d = q.shape
    item = q.element_size()
    ps = k_pool.shape[1]
    total = table.shape[1] * ps
    ctx = ctx_lens.long().cpu()
    positions = torch.clamp(ctx + s, max=total)
    kv_positions = int(positions.sum())
    visible = int(sum(torch.clamp(ctx + t + 1, max=total).sum()
                      for t in range(s)))
    nbytes = (2 * kv_positions * h * d * k_pool.element_size()
              + 2 * q.numel() * item + table.numel() * 4
              + ctx_lens.numel() * 4)
    if quant:
        nbytes += 2 * int(((positions + ps - 1) // ps).sum()) * h * 4
    flops = 4 * h * d * visible
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, flush, iters=20, warmup=3, median=False) -> float:
    """Mean (``median``: median) device time of one call, each after an L2
    flush. A sleep
    kernel queued ahead of every timed call outlasts the host's enqueue
    of it (twice the host time of one call, measured after the warm-up),
    so the events bracket the device's work alone and not the host's
    launch gaps, which dominate a call of a few microseconds. A call that
    reads the device from the host includes the host's work after each
    read."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int((2 * host_s + 50e-6) * SLEEP_CYCLES_PER_S)
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = [a.elapsed_time(z) for a, z in pairs]
    return float(np.median(times)) if median else sum(times) / iters


def check_kernels(gen) -> dict:
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    shapes = [("decode", dict(b=8, s=1, ctx=None)),
              ("prefill", dict(b=2, s=512, ctx=0)),
              ("prefix_tail", dict(b=2, s=64, ctx=200)),
              ("verify", dict(b=8, s=5, ctx=None)),
              ("chunk", dict(b=2, s=128, ctx=256))]
    for name, shp in shapes:
        for d in (64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                ctx = shp["ctx"]
                if ctx is None:  # decode/verify: random lengths per row
                    ctx = torch.randint(0, 64 * 16 - shp["s"], (shp["b"],),
                                        generator=gen, device="cuda").cpu()
                    ctx = ctx.numpy()
                args = attention_case(gen, b=shp["b"], s=shp["s"], ctx=ctx,
                                      d=d, dtype=dtype)
                got = rpa.ragged_paged_attention(*args)
                torch.cuda.synchronize()
                want = rpa.ragged_paged_attention_reference(*args)
                err = (got.float() - want.float()).abs().max().item()
                torch.testing.assert_close(got.float(), want.float(),
                                           **TOL[dtype])
                errs[dtype] = max(errs[dtype], err)
                log(f"  kernel vs plain {name:11s} d={d:3d} "
                    f"{str(dtype):14s} max_abs_err {err:.3e} "
                    f"(atol {TOL[dtype]['atol']}, rtol {TOL[dtype]['rtol']})")
    return errs


def time_ragged(name, args, flush, scales=None) -> dict:
    """One ragged case on the device alone, in turns: plain, kernel,
    kernel, plain (the lower of each pair), then the library yardstick,
    ``scaled_dot_product_attention`` over K/V gathered (and, int8 pools,
    dequantised) beforehand under the ragged mask: it attends the whole
    table width and leaves the gather out."""
    q, k_pool, v_pool, table, ctx_lens = args
    scales = scales or {}
    quant = bool(scales)
    if quant:
        k_all = paged_gather_quant(k_pool, scales["k_scale"], table, q.dtype)
        v_all = paged_gather_quant(v_pool, scales["v_scale"], table, q.dtype)
    else:
        k_all, v_all = paged_gather(k_pool, table), paged_gather(v_pool, table)
    mask = ragged_mask(ctx_lens, k_all.shape[2], q.shape[2])
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k_all, v_all, attn_mask=mask)
    kernel = lambda: rpa.ragged_paged_attention(*args, **scales)  # noqa
    plain = lambda: rpa.ragged_paged_attention_reference(  # noqa: E731
        *args, **scales)
    t_plain = time_ms(plain, flush)
    t_kernel = time_ms(kernel, flush)
    t_kernel = min(t_kernel, time_ms(kernel, flush))
    t_plain = min(t_plain, time_ms(plain, flush))
    t_lib = time_ms(lib, flush)
    b_ms, b_by = bound(q, k_pool, table, ctx_lens, quant=quant)
    b, h, s, d = q.shape
    program = rpa.choose_program(s, d, q.dtype)
    ctx = ctx_lens.tolist()
    shape = (f"b={b} h={h} s={s} d={d} q {str(q.dtype)[6:]}, "
             f"{'int8' if quant else str(k_pool.dtype)[6:]} pools, ctx="
             f"{ctx if len(set(ctx)) > 1 else ctx[0]} page_size="
             f"{k_pool.shape[1]} pages_per_seq={table.shape[1]}")
    log(f"  time ragged {name} ({program} program): kernel {t_kernel:.4f} "
        f"ms, plain {t_plain:.4f} ms, library (sdpa over the gathered, "
        f"masked K/V) {t_lib:.4f} ms = kernel / library "
        f"{t_kernel / t_lib:.2f}, bound {b_ms:.4f} ms ({b_by}) = "
        f"{100 * b_ms / t_kernel:.1f}% of the kernel [{shape}]")
    return {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": t_lib, "program": program,
            "shape": shape}


def time_kernels(gen) -> dict:
    """Kernel, plain and library times at the serving path's shapes: the
    bfloat16 decode batch (8 rows, contexts over the served range), one
    row decoding at the full table width, the 512-token cold prefill
    bucket, a 64-token prefill over 200 cached positions, the verify step
    (the decode batch's rows and contexts, K + 1 = 5 queries each) and a
    128-token prefill chunk over 256 prefilled positions."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    ctx = torch.randint(32, 576, (8,), generator=gen, device="cuda").cpu()
    bf16 = torch.bfloat16
    cases = {
        "decode": dict(b=8, s=1, ctx=ctx.numpy()),
        "decode_b1": dict(b=1, s=1, ctx=64 * 16 - 1),
        "prefill": dict(b=1, s=512, ctx=0),
        "prefix_tail": dict(b=1, s=64, ctx=200),
        # the speculative verify (K + 1 = 5 queries a row, the decode
        # batch's contexts) and a chunked-prefill chunk over its prefix
        "verify": dict(b=8, s=SPEC_DEPTH + 1, ctx=ctx.numpy()),
        "chunk": dict(b=1, s=128, ctx=256),
    }
    return {name: time_ragged(name, attention_case(
        gen, d=128, dtype=bf16, inactive_rows=0, **shp), flush)
        for name, shp in cases.items()}


def time_programs(gen) -> dict:
    """The tensor-core threshold: at a cold prefill of s queries (one row,
    16 heads, d 128, bf16) each program that takes s, timed in turns on
    the same inputs: from MMA_MIN_QUERIES on the tensor-core program
    should be at least as fast as the CUDA-core one."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for s in (8, 16, 32, 64):
        args = attention_case(gen, b=1, s=s, ctx=0, d=128,
                              dtype=torch.bfloat16, inactive_rows=0)
        programs = ["warp", "mma"] + (["split"]
                                      if s <= rpa.SPLIT_MAX_QUERIES else [])
        calls = {}
        for p in programs:  # each program as the wrapper would launch it
            plan = (rpa.split_plan(1, 16, 64 * 16, sms) if p == "split"
                    else (1, 0))
            calls[p] = functools.partial(rpa._launch, p, *plan, *args, None,
                                         None, None)
        times = {p: time_ms(fn, flush) for p, fn in calls.items()}
        for p in reversed(programs):  # in turns: the lower of each pair
            times[p] = min(times[p], time_ms(calls[p], flush))
        out[s] = times
        log(f"  programs at a cold prefill of s={s} (b=1 h=16 d=128 bf16): "
            + ", ".join(f"{p} {t:.4f} ms" for p, t in times.items())
            + f"; chosen: {rpa.choose_program(s, 128, torch.bfloat16)}")
    return out


def int8_attention_case(gen, *, b, s, ctx, d, dtype, h=16, page_size=16,
                        pps=64, inactive_rows=1):
    """``attention_case``'s table, ctx lens and q with int8 pools: every
    position of every row's table written through ``paged_write_quant``
    from standard normal K/V, then a third of them again at 3x the
    magnitude, so those pages' scales grow and their codes are rescaled.
    Returns ``(q, k_pool, v_pool, table, ctx_lens, k_scale, v_scale)``."""
    q, k_f, _, table, ctx_lens = attention_case(
        gen, b=b, s=s, ctx=ctx, d=d, dtype=dtype, h=h, page_size=page_size,
        pps=pps, inactive_rows=inactive_rows)
    num_pages = k_f.shape[0]
    del k_f
    codes = [torch.zeros((num_pages, page_size, h, d), dtype=torch.int8,
                         device="cuda") for _ in range(2)]
    scales = [torch.zeros((num_pages, h), device="cuda") for _ in range(2)]
    total = pps * page_size
    pos = torch.arange(total, device="cuda")
    pid = table.long()[:, pos // page_size]
    off = (pos % page_size)[None].expand(b, total)
    for mag, n in ((1.0, total), (3.0, total // 3)):
        k_new, v_new = (mag * torch.randn((b, n, h, d), generator=gen,
                                          device="cuda") for _ in range(2))
        paged_write_quant(*codes, *scales, k_new, v_new, pid[:, :n],
                          off[:, :n])
    return (q, *codes, table, ctx_lens, *scales)


def check_int8(gen) -> dict:
    """The int8-pool kernel against its plain version (dequantising
    gather + mask + composite) at the serving shapes. q float32: TOL.
    q bfloat16: the kernel and the plain version each against the plain
    version with q in float32 (K and V dequantised to float32); the
    kernel's error may be at most BF16_ERR_RATIO times the plain one's
    plus BF16_ERR_FLOOR. Returns, per q dtype, the max abs error against
    the plain version on the same inputs, and for bf16 also the kernel's
    and the plain version's against float32."""
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    shapes = [("decode", dict(b=8, s=1, ctx=None)),
              ("prefill", dict(b=2, s=512, ctx=0)),
              ("prefix_tail", dict(b=2, s=64, ctx=200)),
              ("verify", dict(b=8, s=5, ctx=None)),
              ("chunk", dict(b=2, s=128, ctx=256))]
    failures = []
    for name, shp in shapes:
        for d in (64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                ctx = shp["ctx"]
                if ctx is None:  # decode/verify: random lengths per row
                    ctx = torch.randint(0, 64 * 16 - shp["s"], (shp["b"],),
                                        generator=gen, device="cuda").cpu()
                    ctx = ctx.numpy()
                q, kp, vp, table, ctx_lens, ks, vs = int8_attention_case(
                    gen, b=shp["b"], s=shp["s"], ctx=ctx, d=d, dtype=dtype)
                rest = (kp, vp, table, ctx_lens)
                got = rpa.ragged_paged_attention(q, *rest, k_scale=ks,
                                                 v_scale=vs)
                torch.cuda.synchronize()
                want = rpa.ragged_paged_attention_reference(
                    q, *rest, k_scale=ks, v_scale=vs)
                diff = (got.float() - want.float()).abs()
                err = diff.max().item()
                errs[dtype] = max(errs[dtype], err)
                if dtype == torch.float32:
                    tol = TOL[dtype]
                    if bool((diff > tol["atol"] + tol["rtol"]
                             * want.abs()).any()):
                        failures.append(f"{name} d={d} {dtype}")
                    how = (f"max_abs_err {err:.3e} (atol {tol['atol']}, "
                           f"rtol {tol['rtol']})")
                else:
                    exact = rpa.ragged_paged_attention_reference(
                        q.float(), *rest, k_scale=ks, v_scale=vs)
                    e_kernel = (got.float() - exact).abs().max().item()
                    e_plain = (want.float() - exact).abs().max().item()
                    limit = BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR
                    for key, val in (("kernel_vs_fp32", e_kernel),
                                     ("plain_vs_fp32", e_plain)):
                        errs[dtype, key] = max(errs.get((dtype, key), 0.0),
                                               val)
                    if not e_kernel <= limit:
                        failures.append(f"{name} d={d} {dtype}")
                    how = (f"max_abs_err vs fp32 plain {e_kernel:.3e} "
                           f"(plain bf16 {e_plain:.3e}, limit {limit:.3e}; "
                           f"vs plain bf16 {err:.3e})")
                log(f"  int8 kernel vs plain {name:11s} d={d:3d} "
                    f"{str(dtype):14s} {how}")
                del q, kp, vp, ks, vs, got, want
    if failures:
        raise RuntimeError(f"int8 ragged kernel outside its limit: "
                           f"{failures}")
    return errs


def time_int8(gen) -> dict:
    """Kernel, plain and library times over int8 pools (q bf16) at the
    decode batch (8 rows, contexts over the served range) and the
    512-token cold prefill. The library yardstick reads K and V already
    dequantised and gathered: it leaves the dequant out."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    ctx = torch.randint(32, 576, (8,), generator=gen, device="cuda").cpu()
    cases = {"decode": dict(b=8, s=1, ctx=ctx.numpy()),
             "prefill": dict(b=1, s=512, ctx=0)}
    out = {}
    for name, shp in cases.items():
        q, kp, vp, table, ctx_lens, ks, vs = int8_attention_case(
            gen, d=128, dtype=torch.bfloat16, inactive_rows=0, **shp)
        out[name] = time_ragged(f"int8 {name}", (q, kp, vp, table, ctx_lens),
                                flush, dict(k_scale=ks, v_scale=vs))
        out[name]["library"] = ("scaled_dot_product_attention over K/V "
                                "already dequantised and gathered (no "
                                "dequant)")
        del q, kp, vp, ks, vs
    return out


def check_tp_heads(gen) -> dict:
    """The ragged kernel at one rank's shard of gpt3-1.3b at TP=2 (8 heads
    of 128, bf16) for the decode batch and two 512-token prefills, over
    bf16 pools (the kernel against the plain version, TOL) and int8 pools
    (kernel and plain version each against the plain version with q in
    float32: the kernel's error at most BF16_ERR_RATIO times the plain
    one's plus BF16_ERR_FLOOR). Returns the max abs errors against the
    plain version on the same inputs."""
    bf16 = torch.bfloat16
    errs = {"float": 0.0, "int8": 0.0}
    for name, shp in (("decode", dict(b=8, s=1, ctx=None)),
                      ("prefill", dict(b=2, s=512, ctx=0))):
        ctx = shp["ctx"]
        if ctx is None:
            ctx = torch.randint(0, 64 * 16 - 1, (8,), generator=gen,
                                device="cuda").cpu().numpy()
        kw = dict(b=shp["b"], s=shp["s"], ctx=ctx, d=128, dtype=bf16,
                  h=TP_HEADS)
        args = attention_case(gen, **kw)
        got = rpa.ragged_paged_attention(*args)
        torch.cuda.synchronize()
        want = rpa.ragged_paged_attention_reference(*args)
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **TOL[bf16])
        errs["float"] = max(errs["float"], err)
        q, kp, vp, table, ctx_lens, ks, vs = int8_attention_case(gen, **kw)
        rest = (kp, vp, table, ctx_lens)
        got8 = rpa.ragged_paged_attention(q, *rest, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        exact = rpa.ragged_paged_attention_reference(
            q.float(), *rest, k_scale=ks, v_scale=vs)
        plain = rpa.ragged_paged_attention_reference(
            q, *rest, k_scale=ks, v_scale=vs)
        e_kernel = (got8.float() - exact).abs().max().item()
        e_plain = (plain.float() - exact).abs().max().item()
        limit = BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR
        errs["int8"] = max(errs["int8"],
                           (got8.float() - plain.float()).abs().max().item())
        log(f"  TP=2 shard (h={TP_HEADS} d=128 bf16) {name}: float pools "
            f"max_abs_err {err:.3e} (atol {TOL[bf16]['atol']}); int8 pools "
            f"vs fp32 plain {e_kernel:.3e} (plain bf16 {e_plain:.3e}, "
            f"limit {limit:.3e})")
        if not e_kernel <= limit:
            raise RuntimeError(f"int8 ragged kernel at {TP_HEADS} heads "
                               f"({name}) outside its limit")
    return errs


def time_tp_heads(gen) -> dict:
    """Kernel, plain and library times at one TP=2 rank's shard of
    gpt3-1.3b (8 heads of 128, bf16): the decode batch and the 512-token
    prefill, over bf16 and over int8 pools."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    ctx = torch.randint(32, 576, (8,), generator=gen, device="cuda").cpu()
    cases = {"decode": dict(b=8, s=1, ctx=ctx.numpy()),
             "prefill": dict(b=1, s=512, ctx=0)}
    out = {}
    for name, shp in cases.items():
        kw = dict(d=128, dtype=torch.bfloat16, inactive_rows=0, h=TP_HEADS,
                  **shp)
        out[name] = time_ragged(f"TP=2 shard {name}",
                                attention_case(gen, **kw), flush)
        q, kp, vp, table, ctx_lens, ks, vs = int8_attention_case(gen, **kw)
        out[f"int8_{name}"] = time_ragged(
            f"TP=2 shard int8 {name}", (q, kp, vp, table, ctx_lens), flush,
            dict(k_scale=ks, v_scale=vs))
        del q, kp, vp, ks, vs
    return out


def ln_inputs(gen, rows, d, dtype):
    """x (mean 0.5, std 2), gamma (near 1), beta and dy on the card."""
    def mk(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(dtype)
    return (mk(rows, d, scale=2.0, shift=0.5), mk(d, scale=0.1, shift=1.0),
            mk(d, scale=0.1), mk(rows, d))


def check_layernorm(gen) -> dict:
    """The LayerNorm forward and backward kernels against their plain
    versions at every LN_SHAPES shape. float32: the kernel against the
    plain version on the same inputs (LN_TOL_FP32). bfloat16: the kernel
    and the plain version each against the plain version in float32 on
    the upcast inputs; the kernel's error may be at most BF16_ERR_RATIO
    times the plain one's plus BF16_ERR_FLOOR. dgamma and dbeta within
    LN_SUM_RTOL of the sum of their terms' magnitudes (plus one step of
    bfloat16) of the plain version's float32 sums, and the backward
    equal bit for bit from run to run. The backward kernels all take the
    plain version's mu and rstd. Every case is printed before any failure
    is raised. Returns, per dtype and fwd/dx, the max abs error against
    the plain version on the same inputs, and for bf16 also the kernel's
    and the plain version's against float32; the largest share of its
    limit a dgamma or dbeta column used; and whether every backward ran
    equal twice."""
    errs, failures = {"sums_share_of_limit": 0.0, "run_to_run_equal": True}, []
    for label, rows, d in LN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, g, b, dy = ln_inputs(gen, rows, d, dtype)
            y, mu, rstd = fl.layer_norm_forward(x, g, b, LN_EPS)
            yp, mup, rstdp = fl.fused_layer_norm_reference(x, g, b, LN_EPS)
            grads = fl.layer_norm_backward(x, g, mup, rstdp, dy)
            again = fl.layer_norm_backward(x, g, mup, rstdp, dy)
            dx, dg, db = grads
            dxp, dgp, dbp = fl.layer_norm_backward_reference(x, g, mup,
                                                              rstdp, dy)
            torch.cuda.synchronize()
            stats = max((mu - mup).abs().max().item(),
                        ((rstd - rstdp).abs() / rstdp).max().item())
            if not stats <= LN_TOL_FP32["atol"]:
                failures.append(f"{label} {dtype} mu/rstd")
            equal = all(torch.equal(a, b) for a, b in zip(grads, again))
            errs["run_to_run_equal"] &= equal
            if not equal:
                failures.append(f"{label} {dtype} backward run to run")
            xhat = (x.float() - mup) * rstdp
            step = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
            share = 0.0
            for got, plain, terms in ((dg, dgp, (dy.float() * xhat).abs()),
                                      (db, dbp, dy.float().abs())):
                limit = (LN_SUM_RTOL * terms.sum(0)
                         + step * plain.float().abs()).clamp_min(1e-30)
                share = max(share, ((got.float() - plain.float()).abs()
                                    / limit).max().item())
            errs["sums_share_of_limit"] = max(errs["sums_share_of_limit"],
                                              share)
            if not share <= 1.0:
                failures.append(f"{label} {dtype} dgamma/dbeta")
            exact = None
            if dtype == torch.bfloat16:
                yf = fl.fused_layer_norm_reference(x.float(), g.float(),
                                                   b.float(), LN_EPS)[0]
                exact = (yf, fl.layer_norm_backward_reference(
                    x.float(), g.float(), mup, rstdp, dy.float())[0])
            line = []
            for i, (part, got, plain) in enumerate((("fwd", y, yp),
                                                    ("dx", dx, dxp))):
                diff = (got.float() - plain.float()).abs()
                err = diff.max().item()
                errs[dtype, part] = max(errs.get((dtype, part), 0.0), err)
                if dtype == torch.float32:
                    if bool((diff > LN_TOL_FP32["atol"] + LN_TOL_FP32["rtol"]
                             * plain.abs()).any()):
                        failures.append(f"{label} {dtype} {part}")
                    line.append(f"{part} {err:.3e}")
                    continue
                e_kernel = (got.float() - exact[i]).abs().max().item()
                e_plain = (plain.float() - exact[i]).abs().max().item()
                limit = BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR
                for key, val in (("kernel_vs_fp32", e_kernel),
                                 ("plain_vs_fp32", e_plain)):
                    errs[dtype, part, key] = max(
                        errs.get((dtype, part, key), 0.0), val)
                if not e_kernel <= limit:
                    failures.append(f"{label} {dtype} {part}")
                line.append(f"{part} {e_kernel:.3e} (plain {e_plain:.3e}, "
                            f"limit {limit:.3e}; vs plain bf16 {err:.3e})")
            if dtype == torch.float32:
                how = (f"max_abs_err vs plain {', '.join(line)} (atol "
                       f"{LN_TOL_FP32['atol']}, rtol {LN_TOL_FP32['rtol']})")
            else:
                how = (f"max_abs_err vs fp32 plain on the upcast inputs "
                       f"{', '.join(line)} (limit = {BF16_ERR_RATIO} x "
                       f"plain + {BF16_ERR_FLOOR})")
            log(f"  layernorm {label:16s} [{rows},{d}] {str(dtype):14s} "
                f"mu/rstd {stats:.1e}; {how}; dgamma/dbeta at {share:.3f} "
                f"of their limit; backward run to run "
                f"{'equal' if equal else 'DIFFERENT'}")
            del x, g, b, dy, y, yp, grads, again, dxp, dgp, dbp, exact
    if failures:
        raise RuntimeError(f"layernorm kernels outside their limit: "
                           f"{failures}")
    return errs


def host_us(fn, calls=1000) -> float:
    """Host microseconds per call of ``fn``, after a warm-up. The device
    finishes each call sooner than the host issues the next, so this is
    the host's cost alone."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def layernorm_host_us(calls=1000) -> dict:
    """Host microseconds per call at the decode shape [8, 2048] bf16
    through the public entry points: the port's LayerNorm without a
    gradient (the serving path), with one (the training path's autograd
    function), the whole serving call through ``nn.LayerNorm`` on the
    decode step's [8, 1, 2048] under ``no_grad`` (as the engine calls
    it: layer, ``nn.functional.layer_norm``, ``fused_layer_norm``), and
    ``F.layer_norm``."""
    import paddle_tpu_torch as paddle

    x, g, b, _ = ln_inputs(torch.Generator(device="cuda").manual_seed(SEED),
                           8, 2048, torch.bfloat16)
    xg = x.clone().requires_grad_()
    layer = paddle.nn.LayerNorm(2048, LN_EPS).to(device="cuda",
                                                 dtype=torch.bfloat16)
    x3 = x.view(8, 1, 2048)
    fns = {"no_grad": lambda: fl.fused_layer_norm(x, g, b, LN_EPS),
           "autograd": lambda: fl.fused_layer_norm(xg, g, b, LN_EPS),
           "nn_layer_norm": lambda: layer(x3),
           "library": lambda: F.layer_norm(x, (2048,), g, b, LN_EPS)}
    out = {}
    for name, fn in fns.items():
        with torch.set_grad_enabled(name != "nn_layer_norm"):
            out[name] = host_us(fn, calls)
    log(f"  layernorm host cost per call at [8, 2048] bf16: without a "
        f"gradient {out['no_grad']:.1f} us, through the autograd function "
        f"{out['autograd']:.1f} us, through nn.LayerNorm under no_grad "
        f"{out['nn_layer_norm']:.1f} us, F.layer_norm "
        f"{out['library']:.1f} us")
    return out


def layernorm_host_parts(calls=1000) -> dict:
    """Host microseconds per call of each step of the forward's CUDA host
    path at [8, 2048] bf16, and of the steps it replaced: what each change
    of the launch path saves."""
    x, g, b, _ = ln_inputs(torch.Generator(device="cuda").manual_seed(SEED),
                           8, 2048, torch.bfloat16)
    dev = x.device
    fwd, _, raw = fl._entry_points()
    y = torch.empty_like(x)
    mu, rstd = fl._statistics(8, dev)
    args = (x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
            mu.data_ptr(), rstd.data_ptr(), 8, 2048, LN_EPS, 1, 1)
    stream = raw(0)
    x3 = x.view(8, 1, 2048)

    def device_context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "checks": lambda: (fl._check(x, g, b), fl._check_kernel(
            ("x", "gamma", "beta"), (x, g, b))),
        "y allocation": lambda: torch.empty_like(x),
        "mu and rstd, one allocation": lambda: fl._statistics(8, dev),
        "mu and rstd, two allocations (before)": lambda: torch.empty_like(
            torch.empty((8, 1), dtype=torch.float32, device=dev)),
        "x as rows, 3-D (before: also for 2-D)": lambda: x3.reshape(
            -1, 2048).contiguous(),
        "y.view_as(x), 3-D": lambda: y.view_as(x3),
        "y.view(x.shape), 3-D (before)": lambda: y.view(x3.shape),
        "current device": torch.cuda.current_device,
        "device context (before)": device_context,
        "raw stream": lambda: raw(0),
        "Stream object (before)": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "six data_ptr": lambda: (x.data_ptr(), g.data_ptr(), b.data_ptr(),
                                 y.data_ptr(), mu.data_ptr(),
                                 rstd.data_ptr()),
        "ctypes call and launch": lambda: fwd(*args, stream),
        "layer_norm_forward, statistics kept": lambda: fl.layer_norm_forward(
            x, g, b, LN_EPS),
        "layer_norm_forward, none kept": lambda: fl.layer_norm_forward(
            x, g, b, LN_EPS, stats=False),
    }
    out = {name: host_us(fn, calls) for name, fn in parts.items()}
    log("  layernorm forward host path by part at [8, 2048] bf16: "
        + ", ".join(f"{k} {v:.2f} us" for k, v in out.items()))
    return out


def time_layernorm(gen, label: str = "train", backward: bool = True) -> dict:
    """Forward and (with ``backward``) whole backward at an LN_SHAPES
    shape in bf16 (by default the training shape [8192, 1024]): the
    kernels, the plain versions and the library yardstick
    (``F.layer_norm`` and its autograd backward, which computes dx, dgamma
    and dbeta too; never called by the port), each timed alone; beside the
    backward also this dx kernel followed by the eight eager PyTorch ops
    with which the port summed dgamma and dbeta before its backward kernel
    wrote column partials. At the training shape also the host's cost per
    call and by part."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows, d = next((r, n) for lab, r, n in LN_SHAPES if lab == label)
    x, g, b, dy = ln_inputs(gen, rows, d, torch.bfloat16)
    _, mu, rstd = fl.layer_norm_forward(x, g, b, LN_EPS)
    xs = [t.clone().requires_grad_() for t in (x, g, b)]
    y_lib = F.layer_norm(xs[0], (d,), xs[1], xs[2], LN_EPS)
    item = x.element_size()

    def dx_and_eager_sums():
        fl.layer_norm_dx(x, g, mu, rstd, dy)
        prod = (x.float() - mu).mul_(rstd).mul_(dy)
        return (prod.sum(0).to(g.dtype),
                dy.sum(0, dtype=torch.float32).to(b.dtype))

    cases = {
        "fwd": (lambda: fl.layer_norm_forward(x, g, b, LN_EPS),
                lambda: fl.fused_layer_norm_reference(x, g, b, LN_EPS),
                lambda: F.layer_norm(x, (d,), g, b, LN_EPS),
                # x read, y written; gamma, beta read; mu, rstd written
                2 * rows * d * item + 2 * d * item + 8 * rows, 8),
        "bwd": (lambda: fl.layer_norm_backward(x, g, mu, rstd, dy),
                lambda: fl.layer_norm_backward_reference(x, g, mu, rstd, dy),
                lambda: torch.autograd.grad(y_lib, xs, dy, retain_graph=True),
                # x, dy read, dx written; gamma, mu, rstd read; dgamma,
                # dbeta written (the partials are the kernels' own)
                3 * rows * d * item + 3 * d * item + 8 * rows, 16),
    }
    if not backward:
        del cases["bwd"]
    shape = f"[{rows}, {d}] bf16 (gamma, beta bf16)"
    out = {}
    if label == "train":
        out = {"host_us": layernorm_host_us(),
               "host_us_by_part": layernorm_host_parts()}
    for name, (kernel, plain, lib, nbytes, ops) in cases.items():
        t_plain = time_ms(plain, flush)
        t_kernel = time_ms(kernel, flush)
        t_kernel = min(t_kernel, time_ms(kernel, flush))
        t_plain = min(t_plain, time_ms(plain, flush))
        t_lib = time_ms(lib, flush)
        # float32 arithmetic off the tensor cores, ops per element
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = ops * rows * d / PEAK_FLOPS[torch.float32]
        b_ms = max(t_bytes, t_ops) * 1e3
        b_by = "bytes" if t_bytes >= t_ops else "operations"
        what = ("F.layer_norm" if name == "fwd" else
                "autograd backward of F.layer_norm: dx, dgamma and dbeta")
        out[name] = {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": t_lib, "shape": shape,
                     "library": what}
        extra = ""
        if name == "fwd":
            program, grid = fl.forward_plan(rows, d, torch.bfloat16, True,
                                            torch.cuda.get_device_properties(
                                                0).multi_processor_count)
            y = torch.empty_like(x)
            t_copy = time_ms(lambda: y.copy_(x), flush)
            out[name].update(program=[*program, grid], copy_ms=t_copy)
            extra = (f", {program[0]} program (N/vec {program[1]}, grid "
                     f"{grid}); a copy of x into y (the same bytes less "
                     f"gamma, beta, mu and rstd) {t_copy:.4f} ms")
        if name == "bwd":
            t_old = time_ms(dx_and_eager_sums, flush)
            out[name]["dx_kernel_and_eager_sums_ms"] = t_old
            extra = (f", this dx kernel + the eager dgamma/dbeta sums "
                     f"{t_old:.4f} ms")
        log(f"  time layernorm {name} {label}: kernel {t_kernel:.4f} ms, "
            f"plain {t_plain:.4f} ms, library ({what}) {t_lib:.4f} ms"
            f"{extra}, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB) "
            f"[{shape}]")
    return out


def flash_inputs(gen, b, h, s_q, s_k, d, dtype):
    """q, k, v and an output gradient, standard normal, on the card."""
    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return mk(b, h, s_q, d), mk(b, h, s_k, d), mk(b, h, s_k, d), \
        mk(b, h, s_q, d)


def flash_outputs(fn, q, k, v, do, causal) -> list:
    """[o, dq, dk, dv] of ``fn`` under autograd on copies of q, k, v."""
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*x, causal=causal)
    out.backward(do)
    return [out.detach()] + [t.grad for t in x]


def check_flash(gen) -> dict:
    """Flash forward and backward against the plain version (autograd
    through ``sdpa_reference``) at every FLASH_CASES shape. float32: the
    kernel against the plain version on the same inputs. bfloat16: the
    kernel and the plain version, each against the plain version in
    float32 on the same inputs upcast; the kernel's error may be at most
    BF16_ERR_RATIO times the plain version's plus
    BF16_ERR_FLOOR. Every case is printed before any failure is
    raised. Returns, per dtype and fwd/bwd, the max abs error against the
    plain version on the same inputs, and for bf16 also the kernel's and
    the plain version's against float32."""
    errs = {}
    failures = []
    for label, b, h, s_q, s_k, d, causal in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_inputs(gen, b, h, s_q, s_k, d, dtype)
            got = flash_outputs(fa.flash_attention, q, k, v, do, causal)
            plain = flash_outputs(fa.flash_attention_reference, q, k, v, do,
                                  causal)
            exact = (flash_outputs(fa.flash_attention_reference,
                                   *(t.float() for t in (q, k, v, do)),
                                   causal) if dtype == torch.bfloat16
                     else None)
            torch.cuda.synchronize()
            line = []
            for i, name in enumerate(("o", "dq", "dk", "dv")):
                part = "fwd" if name == "o" else "bwd"
                diff = (got[i].float() - plain[i].float()).abs()
                err = diff.max().item()
                errs[dtype, part] = max(errs.get((dtype, part), 0.0), err)
                if dtype == torch.float32:
                    tol = FLASH_TOL_FP32
                    if bool((diff > tol["atol"] + tol["rtol"]
                             * plain[i].float().abs()).any()):
                        failures.append(f"{label} {dtype} {name}")
                    line.append(f"{name} {err:.3e}")
                    continue
                e_kernel = (got[i].float() - exact[i]).abs().max().item()
                e_plain = (plain[i].float() - exact[i]).abs().max().item()
                limit = BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR
                for key, val in (("kernel_vs_fp32", e_kernel),
                                 ("plain_vs_fp32", e_plain)):
                    errs[dtype, part, key] = max(
                        errs.get((dtype, part, key), 0.0), val)
                if not e_kernel <= limit:
                    failures.append(f"{label} {dtype} {name}")
                line.append(f"{name} {e_kernel:.3e} (plain {e_plain:.3e}, "
                            f"limit {limit:.3e}; vs plain bf16 {err:.3e})")
            del got, plain, exact
            if dtype == torch.float32:
                how = (f"max_abs_err vs plain {', '.join(line)} (atol "
                       f"{FLASH_TOL_FP32['atol']}, rtol "
                       f"{FLASH_TOL_FP32['rtol']})")
            else:
                how = (f"max_abs_err vs fp32 plain on the upcast inputs "
                       f"{', '.join(line)} (limit = "
                       f"{BF16_ERR_RATIO} x plain + "
                       f"{BF16_ERR_FLOOR})")
            log(f"  flash {label:14s} [{b},{h},{s_q},{s_k},{d}] "
                f"{'causal' if causal else 'full':6s} {str(dtype):14s} {how}")
    if failures:
        raise RuntimeError(f"flash kernel outside its limit: {failures}")
    return errs


ADAM_ODD_SIZES = [1, 3, 5, 1023, 4097, 1_000_003]


def adam_vs_plain(gen, sizes, layout, scale=None, hyper=None) -> tuple:
    """Fused Adam over tensors of ``sizes`` in one multi-tensor call
    against its plain version on the same buffers: p, m, v and the bf16
    parameter copy equal bit for bit, in the launches of
    ``adam_launch_plan``. ``layout(i)`` gives tensor i's gradient dtype,
    its AdamW decay and whether a bf16 parameter copy is written;
    ``scale`` a global-norm clip's scale on the device (each gradient
    read as ``g * scale`` rounded to its dtype); ``hyper`` the betas and
    epsilon (by default 0.9, 0.999, 1e-8). Returns the max abs error and
    the launches."""
    hyper = hyper or dict(beta1=0.9, beta2=0.999, eps=1e-8)
    groups, plain = [], []
    for i, n in enumerate(sizes):
        g_dtype, decay, bf16_out = layout(i)
        p = torch.randn(n, generator=gen, device="cuda")
        g = torch.randn(n, generator=gen, device="cuda").to(g_dtype)
        m = torch.randn(n, generator=gen, device="cuda")
        v = torch.rand(n, generator=gen, device="cuda")
        out = (torch.empty(n, dtype=torch.bfloat16, device="cuda")
               if bf16_out else None)
        groups.append((p, g, m, v, decay, out))
        plain.append((p.clone(), g, m.clone(), v.clone(), decay,
                      None if out is None else torch.empty_like(out)))
    plan = fo.adam_launch_plan(sizes, [t[1].dtype for t in groups],
                               fo.kernel_param_bytes())
    launches, tensors = fo.launches, fo.tensors
    fo.fused_adam_update_many(groups, 1e-4, 0.19, 0.001999, **hyper,
                              scale=scale)
    torch.cuda.synchronize()
    made = fo.launches - launches
    if made != len(plan) or fo.tensors - tensors != len(sizes):
        raise RuntimeError(f"fused adam: {made} launches for {len(plan)} "
                           f"planned, {fo.tensors - tensors} tensors for "
                           f"{len(sizes)}")
    for p, g, m, v, decay, out in plain:
        fo.fused_adam_update_reference(p, g, m, v, 1e-4, 0.19, 0.001999,
                                       decay=decay, p_out=out, scale=scale,
                                       **hyper)
    torch.cuda.synchronize()
    err = 0.0
    for i, (got, want) in enumerate(zip(groups, plain)):
        for name, a, w in zip(("p", "m", "v", "p_bf16"),
                              (got[0], got[2], got[3], got[5]),
                              (want[0], want[2], want[3], want[5])):
            if a is None:
                continue
            e = (a.float() - w.float()).abs().max().item()
            err = max(err, e)
            if not torch.equal(a, w):
                raise RuntimeError(
                    f"fused adam (scale {scale}) tensor {i} ({a.numel()} "
                    f"elements, g {got[1].dtype}) {name} differs from the "
                    f"plain version by up to {e:.3e}")
    return err, made


def check_adam(gen) -> dict:
    """Fused Adam against its plain version (:func:`adam_vs_plain`) over
    the training path's 292 parameter shapes and odd sizes (1, 3, 5,
    1023, 4097: tails past the last 4-element group; 1,000,003: many
    chunks), the gradients float32 and bfloat16 in turn, AdamW's decay on
    two tensors of three and the bf16 parameter copy on three of four,
    twice: unclipped, then with a global-norm clip's scale on the device.
    Returns the max abs error and the launches."""
    sizes = [int(np.prod(s)) for s in train_param_shapes()] + ADAM_ODD_SIZES

    def layout(i):
        return (torch.bfloat16 if i % 2 else torch.float32,
                1 - 1e-6 if i % 3 else 1.0, bool(i % 4))

    err, made = 0.0, 0
    # a scale whose products round: g * 0.3712 is rarely a bf16 value
    for scale in (None, torch.tensor(0.3712, device="cuda")):
        e, made = adam_vs_plain(gen, sizes, layout, scale)
        err = max(err, e)
    log(f"  adam vs plain: {len(sizes)} tensors ({sum(sizes)} elements; "
        f"the 292 training shapes and sizes {ADAM_ODD_SIZES}), g float32 "
        f"and bfloat16 in turn, unclipped and with a clip scale of 0.3712 "
        f"on the device, each in {made} launch(es) of the plan "
        f"({fo.kernel_param_bytes()} parameter bytes): p, m, v, p_bf16 "
        f"equal bit for bit (max_abs_err {err:.1e}; tolerance 0)")
    return {"max_abs_err": err, "launches": made, "tensors": len(sizes),
            "clip_scale_checked": True}


# dropout kernel vs plain: bit for bit, at the training path's shapes
# (the residual and MLP sites [8, 1024, 1024], the attention output [8,
# 16, 1024, 64]), odd sizes and broadcast masks
DROPOUT_CASES = [  # (label, shape, axis, window)
    ("hidden", (8, 1024, 1024), None, None),
    ("attention", (8, 16, 1024, 64), None, None),
    ("one", (1,), None, None),
    ("odd", (1_000_003,), None, None),
    ("axis-0", (8, 1024, 1024), 0, None),
    ("axis-01", (8, 16, 1024, 64), [0, 1], None),
    ("axis-2", (3, 5, 7, 11), [2], None),
    # a dp2 x mp2 rank's slices (phase 16 (a) at dropout 0.1): its rows
    # of the hidden states, its rows and heads of the attention output
    ("hidden-window", (4, 1024, 1024), None, ((8, 1024, 1024), (4, 0, 0))),
    ("attention-window", (4, 8, 1024, 64), None,
     ((8, 16, 1024, 64), (4, 8, 0, 0))),
    ("axis-01-window", (4, 8, 1024, 64), [0, 1],
     ((8, 16, 1024, 64), (0, 8, 0, 0))),
    # a slice whose full-tensor indices pass 2^32 (the counter's high word)
    ("far-window", (2, 4, 64, 64), None, ((64, 64, 4096, 512),
                                          (60, 30, 100, 0))),
]
# H100 SXM INT32 ALU rate: 64 lanes an SM a clock, 132 SMs, at the clock
# the data sheet's 67 TFLOP/s float32 implies (128 lanes x 2 a clock): a
# quarter of it. The dropout forward's instructions a mask element on
# that pipe are counted in its compiled code (``dropout_sass_ops``)
PEAK_INT32_OPS = PEAK_FLOPS[torch.float32] / 4
# the global norm kernel vs plain: float32 sums of up to 3.5e8 squares in
# two orders (per chunk then float64, per tensor then stacked)
NORM_RTOL = 2e-5
NORM_ODD_SIZES = [1, 3, 4097, 1_000_003]


def check_dropout(gen) -> dict:
    """The dropout kernels against their plain versions on the same inputs
    and key at every DROPOUT_CASES entry, float32, bfloat16 and float64, p
    0.1 and 0.5, both modes: the forward without bits and with them (y and
    the packed mask), and the backward from the forward's bits applied to
    an output gradient, each equal bit for bit (tolerance 0). Returns the
    max abs error and the cases."""
    err, n = 0.0, 0
    key = (0x12345678, 0x9ABCDEF0)
    for label, shape, axis, win in DROPOUT_CASES:
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            for p in (0.1, 0.5):
                x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for mode in kd.MODES:
                    y, bits = kd.dropout_forward(x, key, p, mode, axis,
                                                 mask=True, window=win)
                    y0 = kd.dropout_forward(x, key, p, mode, axis,
                                            window=win)[0]
                    g = kd.dropout_backward(dy, bits, p, mode, axis)
                    yp, bitsp = kd.dropout_forward_reference(x, key, p, mode,
                                                             axis, win)
                    gp = kd.dropout_backward_reference(dy, bitsp, p, mode,
                                                       axis)
                    torch.cuda.synchronize()
                    for part, got, want in (("fwd", y, yp), ("fwd-nobits",
                                                             y0, yp),
                                            ("bits", bits, bitsp),
                                            ("bwd", g, gp)):
                        e = (got.double() - want.double()).abs().max().item()
                        err = max(err, e)
                        n += 1
                        if not torch.equal(got, want):
                            raise RuntimeError(
                                f"dropout {label} {shape} axis {axis} "
                                f"window {win} "
                                f"{dtype} p {p} {mode} {part}: kernel "
                                f"differs from the plain version by up to "
                                f"{e:.3e} at {int((got != want).sum())} "
                                f"elements")
                    key = (key[0], (key[1] + 1) & 0xFFFFFFFF)
    kept = kd.dropout_apply(torch.ones(8, 1024, 1024, device="cuda"),
                            key, 0.1).ne(0).float().mean().item()
    if abs(kept - 0.9) > 1e-3:
        raise RuntimeError(f"dropout p 0.1 kept {kept:.5f} of 8.4 M")
    log(f"  dropout vs plain: {n} comparisons ({len(DROPOUT_CASES)} shapes: "
        f"{[c[1] for c in DROPOUT_CASES]}, axes "
        f"{[c[2] for c in DROPOUT_CASES]}, windows (full shape, starts) "
        f"{[c[3] for c in DROPOUT_CASES]}; float32, bfloat16 and float64; "
        f"p 0.1 and 0.5; both modes; the forward's y without and with its "
        f"bits, the bits, the backward from the bits) equal bit for bit "
        f"(max_abs_err {err:.1e}; tolerance 0); p 0.1 keeps {kept:.5f} of "
        f"8,388,608")
    return {"max_abs_err": err, "comparisons": n, "kept_at_p_0.1": kept}


def dropout_sass_ops() -> dict:
    """The integer instructions a mask element of the dropout forward, from
    ``cuobjdump -sass`` of the built library: in the bf16 forward with a
    32-bit index (the training path's), the longest branch-free run of
    instructions is the 8 unrolled hashes of a thread's group, their
    compares and the mask byte. Counted per element by pipe: LOP3, SHF,
    IADD3, ISETP, SEL, P2R, LEA and PRMT on the INT32 ALU pipe (64 lanes
    an SM a clock); IMAD and VIADD on the FMA pipe, which also takes
    integer adds at 64 a clock (VIADD's pipe is not documented: counted
    there, the lighter side, so the bound stays a least time); and all of
    them against the 128 instructions an SM issues a clock. ``ops`` is
    the busiest of the three in ALU-pipe instructions, the count the
    bound divides by PEAK_INT32_OPS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "-sass", str(_build._library_path("dropout"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    ops, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "dropout_fwd_kernelI13__nv_bfloat16jLb1E" in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                ops.append(re.sub(r"^@!?U?P\w+\s+", "", m.group(1)).split()[0])
    best, run = [], []
    for op in ops + ["EXIT"]:
        if op.split(".")[0] in ("BRA", "BSSY", "BSYNC", "EXIT", "CALL",
                                "RET"):
            best, run = max(best, run, key=len), []
        else:
            run.append(op)
    head = [op.split(".")[0] for op in best]
    alu = sum(h in ("LOP3", "SHF", "IADD3", "ISETP", "SEL", "P2R", "LEA",
                    "PRMT") for h in head) / 8
    fma = sum(h in ("IMAD", "VIADD") for h in head) / 8
    issued = sum(not h.startswith("U") for h in head) / 8
    out = {"alu": alu, "fma": fma, "issued": issued,
           "ops": max(alu, fma, issued / 2),
           "by_opcode": dict(collections.Counter(best).most_common())}
    log(f"  dropout forward SASS (bf16, 32-bit index), a mask element: "
        f"{alu} on the INT32 ALU pipe, {fma} IMAD/VIADD on the FMA pipe, "
        f"{issued} issued: {out['ops']} ALU-pipe instructions bound it "
        f"(kernelcheck's DROPOUT_INT_OPS {kc.DROPOUT_INT_OPS}); opcodes of "
        f"a group of 8 {json.dumps(out['by_opcode'])}")
    if not best or out["ops"] != kc.DROPOUT_INT_OPS:
        raise RuntimeError(f"the dropout forward's compiled hash takes "
                           f"{out['ops']} ALU-pipe instructions a mask "
                           f"element; kernelcheck's bound counts "
                           f"{kc.DROPOUT_INT_OPS}")
    return out


def time_dropout(gen, int_ops: float) -> dict:
    """At each training shape, bf16, p 0.1: the forward without bits (a
    no-grad call), the forward with them (the training path's) and the
    backward from them, each timed alone beside its plain version and
    bound. The forward's bound is the larger of the bytes (x read, y and
    the bits written) and ``int_ops`` ALU-pipe instructions a mask
    element over PEAK_INT32_OPS; the backward's is bytes (dy and the bits
    read, dx written). Library yardsticks, never called by the port:
    ``F.dropout`` for the forward (the same work on Philox bits) and
    ``aten.native_dropout_backward`` from the same mask as bools for the
    backward (a multiply by 1 / q where the port divides by q)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    key = (7, 11)
    out = {}
    for label, shape, _, _ in DROPOUT_CASES[:2]:
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        bits = kd.dropout_forward(x, key, 0.1, mask=True)[1]
        keep = kd.unpack_mask(bits, shape)
        q = kd.launch_args(key, 0.1, torch.bfloat16)[3]
        n, item = x.numel(), x.element_size()
        t_ops = n * int_ops / PEAK_INT32_OPS
        cases = {
            "fwd": (lambda: kd.dropout_forward(x, key, 0.1),
                    lambda: kd.dropout_reference(x, key, 0.1),
                    lambda: F.dropout(x, 0.1, training=True),
                    2 * n * item, t_ops),
            "fwd_bits": (lambda: kd.dropout_forward(x, key, 0.1, mask=True),
                         lambda: kd.dropout_forward_reference(x, key, 0.1),
                         lambda: F.dropout(x, 0.1, training=True),
                         2 * n * item + -(-n // 8), t_ops),
            "bwd": (lambda: kd.dropout_backward(dy, bits, 0.1),
                    lambda: kd.dropout_backward_reference(dy, bits, 0.1),
                    lambda: torch.ops.aten.native_dropout_backward(
                        dy, keep, 1.0 / q),
                    2 * n * item + -(-n // 8), 0.0)}
        desc = f"{list(shape)} bf16, p 0.1"
        out[label] = {}
        for name, (kernel, plain, lib, nbytes, t_int) in cases.items():
            iters = 5 if name != "bwd" else 20  # the plain hash is slow
            t_plain = time_ms(plain, flush, iters=iters)
            t_kernel = time_ms(kernel, flush)
            t_kernel = min(t_kernel, time_ms(kernel, flush))
            t_plain = min(t_plain, time_ms(plain, flush, iters=iters))
            t_lib = time_ms(lib, flush)
            t_bytes = nbytes / PEAK_BYTES_PER_S
            b_ms = max(t_bytes, t_int) * 1e3
            b_by = "bytes" if t_bytes >= t_int else "operations"
            out[label][name] = {
                "ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": t_lib, "shape": desc,
                "bound_bytes_ms": t_bytes * 1e3,
                "bound_int_ops_ms": t_int * 1e3}
            lib_name = ("native_dropout_backward" if name == "bwd" else
                        "F.dropout, Philox")
            ops_text = (f"{int_ops} ALU-pipe instructions x {n} at "
                        f"{PEAK_INT32_OPS / 1e12:.2f} T/s = "
                        f"{t_int * 1e3:.4f} ms; " if t_int else "")
            log(f"  time dropout {label} {name}: kernel {t_kernel:.4f} ms, "
                f"plain {t_plain:.4f} ms, library ({lib_name}) "
                f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {ops_text}"
                f"bytes {t_bytes * 1e3:.4f} ms) [{desc}]")
        del x, dy, bits, keep
    return out


def grad_buffers(gen, shapes, scale=1e-3):
    """bf16 gradients of ``shapes``, normal times ``scale``, on the card."""
    return [(torch.randn(shp, generator=gen, device="cuda") * scale).to(
        torch.bfloat16) for shp in shapes]


def check_global_norm(gen) -> dict:
    """The global norm kernel against its plain version over the training
    path's 292 gradient shapes (bf16) and odd sizes (float32 and bf16 in
    turn): the sum of squares and the clip scale within NORM_RTOL, in the
    launches of ``norm_launch_plan`` plus one, at clips that scale (0.5)
    and that do not (1e6); run to run equal. Returns the relative
    errors."""
    shapes = train_param_shapes()
    grads = grad_buffers(gen, shapes)
    grads += [torch.randn(n, generator=gen, device="cuda").to(
        torch.bfloat16 if i % 2 else torch.float32)
        for i, n in enumerate(NORM_ODD_SIZES)]
    plan = gn.norm_launch_plan([g.numel() for g in grads])
    worst = {"total_rel": 0.0, "scale_rel": 0.0}
    scale_abs = 0.0
    for clip in (0.5, 1e6):
        before = gn.launches
        total, scale = gn.global_norm_scale(grads, clip)
        again = gn.global_norm_scale(grads, clip)
        torch.cuda.synchronize()
        if gn.launches - before != 2 * (len(plan) + 1):
            raise RuntimeError(f"global norm: {gn.launches - before} "
                               f"launches for 2 x {len(plan) + 1}")
        if not (torch.equal(total, again[0]) and torch.equal(scale,
                                                             again[1])):
            raise RuntimeError("global norm: two runs differ")
        w_total, w_scale = gn.global_norm_scale_reference(grads, clip)
        for name, a, w in (("total_rel", total, w_total),
                           ("scale_rel", scale, w_scale)):
            rel = ((a - w).abs() / w.abs()).item()
            worst[name] = max(worst[name], rel)
        scale_abs = max(scale_abs, (scale - w_scale).abs().item())
        if clip > 1e3 and scale.item() != 1.0:
            raise RuntimeError(f"global norm: clip {clip} scaled by "
                               f"{scale.item()}")
    bad = {k: v for k, v in worst.items() if not v <= NORM_RTOL}
    log(f"  global norm vs plain: {len(grads)} gradients (the 292 training "
        f"shapes in bf16, sizes {NORM_ODD_SIZES}), clips 0.5 and 1e6, in "
        f"{len(plan)} + 1 launches: sum of squares rel diff "
        f"{worst['total_rel']:.2e}, scale rel diff {worst['scale_rel']:.2e} "
        f"(tol {NORM_RTOL}); two runs equal")
    if bad:
        raise RuntimeError(f"global norm disagrees with the plain version: "
                           f"{bad}")
    return {"max_abs_err": scale_abs, "rel_err": worst}


def time_global_norm(gen) -> dict:
    """The clip scale over one training step's 292 bf16 gradients: the
    kernel (the plan's launches and the reduction), the plain version and
    ``torch._foreach_norm`` then the norm of the stacked norms (the library
    yardstick, never called by the port), beside the bound (every
    gradient read once)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    grads = grad_buffers(gen, train_param_shapes())
    n = sum(g.numel() for g in grads)

    def lib():
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))

    kernel = lambda: gn.global_norm_scale(grads, 1.0)  # noqa: E731
    plain = lambda: gn.global_norm_scale_reference(grads, 1.0)  # noqa: E731
    t_plain = time_ms(plain, flush, iters=5)
    t_kernel = time_ms(kernel, flush)
    t_kernel = min(t_kernel, time_ms(kernel, flush))
    t_plain = min(t_plain, time_ms(plain, flush, iters=5))
    t_lib = time_ms(lib, flush)
    nbytes = 2 * n
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * n / PEAK_FLOPS[torch.float32]
    b_ms = max(t_bytes, t_ops) * 1e3
    b_by = "bytes" if t_bytes >= t_ops else "operations"
    shape = f"{len(grads)} bf16 gradients, {n} elements (one training step)"
    log(f"  time global norm: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} "
        f"ms, library (torch._foreach_norm + norm) {t_lib:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; {nbytes / 1e9:.3f} GB) [{shape}]")
    return {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": t_lib, "shape": shape}


def flash_bound(b, h, s_q, s_k, d, item, causal, backward, peak=None):
    """(ms, "bytes" | "operations") for one flash call: the (query, key)
    pairs these shapes make visible (causal bottom-right; a row that sees
    no key attends every key), 4·d operations per pair forward and 10·d
    backward (five products), against q, k, v, o (and do, dq, dk, dv
    backward) read or written once, plus the float32 row statistics. The
    products at bf16's rate, float32's at 3xTF32's (PEAK_TF32X3), or at
    ``peak`` FLOP/s where given."""
    if causal:
        i = np.arange(s_q)
        seen = np.clip(i + s_k - s_q + 1, 0, s_k)
        pairs = int(np.where(i + s_k - s_q < 0, s_k, seen).sum())
    else:
        pairs = s_q * s_k
    pairs *= b * h
    if backward:  # read q, o, do, k, v, lse; write dq, dk, dv
        flops = 10 * d * pairs
        nbytes = (4 * s_q + 4 * s_k) * d * b * h * item + 4 * b * h * s_q
    else:         # read q, k, v; write o, lse
        flops = 4 * d * pairs
        nbytes = (2 * s_q + 2 * s_k) * d * b * h * item + 4 * b * h * s_q
    if peak is None:
        peak = PEAK_FLOPS[torch.bfloat16] if item == 2 else PEAK_TF32X3
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_flash_at(gen, b, h, s, d, causal) -> tuple:
    """Forward and backward at ``[b, h, s, d]`` bf16: the kernel, the
    plain version and ``scaled_dot_product_attention`` (the library
    yardstick, never called by the port), each timed alone; the backward
    rows time only the backward (autograd over a kept graph). Returns the
    rows and the inputs, forward outputs and kept graph for more timing."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    q, k, v, do = flash_inputs(gen, b, h, s, s, d, torch.bfloat16)
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out_plain = fa.flash_attention_reference(*xs, causal=causal)
    out_lib = F.scaled_dot_product_attention(*xs, is_causal=causal)

    def plain_fwd():
        with torch.no_grad():
            fa.flash_attention_reference(q, k, v, causal=causal)

    cases = {
        "fwd": (lambda: fa.flash_attention_forward(q, k, v, causal=causal),
                plain_fwd,
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal)),
        "bwd": (lambda: fa.flash_attention_backward(q, k, v, o, lse, do,
                                                    causal=causal),
                lambda: torch.autograd.grad(out_plain, xs, do,
                                            retain_graph=True),
                lambda: torch.autograd.grad(out_lib, xs, do,
                                            retain_graph=True)),
    }
    shape = f"[{b}, {h}, {s}, {d}] bf16 {'causal' if causal else 'full'}"
    out = {}
    for name, (kernel, plain, lib) in cases.items():
        t_plain = time_ms(plain, flush)
        t_kernel = time_ms(kernel, flush)
        t_kernel = min(t_kernel, time_ms(kernel, flush))
        t_plain = min(t_plain, time_ms(plain, flush))
        t_lib = time_ms(lib, flush)
        b_ms, b_by = flash_bound(b, h, s, s, d, 2, causal, name == "bwd")
        out[name] = {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": t_lib, "shape": shape}
        log(f"  time flash {name}: kernel {t_kernel:.4f} ms, plain "
            f"{t_plain:.4f} ms, library (scaled_dot_product_attention) "
            f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{shape}]")
    return out, (flush, q, k, v, do, o, lse, xs)


def time_flash(gen) -> dict:
    """Forward and backward at the training shape (bf16, causal), timed
    by :func:`time_flash_at`, then forward + backward against the
    library's and the run-to-run checks."""
    _, b, h, s, _, d, _ = FLASH_CASES[0]
    out, (flush, q, k, v, do, o, lse, xs) = time_flash_at(gen, b, h, s, d,
                                                          True)
    shape = out["fwd"]["shape"]
    t_lib_fb = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*xs, is_causal=True), xs, do), flush)
    t_fb = time_ms(lambda: fa.flash_attention_backward(
        q, k, v, *fa.flash_attention_forward(q, k, v, causal=True), do,
        causal=True), flush)
    out["fwd_bwd"] = {"ms": t_fb, "library_ms": t_lib_fb}
    log(f"  time flash fwd+bwd: kernels {t_fb:.4f} ms, library "
        f"{t_lib_fb:.4f} ms [{shape}]")
    # the forward is deterministic: two runs on the same inputs are equal
    (o1, lse1), (o2, lse2) = (fa.flash_attention_forward(q, k, v, causal=True)
                              for _ in range(2))
    fwd_equal = torch.equal(o1, o2) and torch.equal(lse1, lse2)
    out["fwd_run_to_run_equal"] = fwd_equal
    log(f"  flash forward run to run: o and lse equal: {fwd_equal}")
    if not fwd_equal:
        raise RuntimeError("flash forward: two runs on the same inputs "
                           "differ")
    # dq is summed by float32 bulk adds in no fixed order: two runs on the
    # same inputs within one bf16 step plus DQ_RUN_ATOL, dk and dv equal
    (dq1, dk1, dv1), (dq2, dk2, dv2) = (fa.flash_attention_backward(
        q, k, v, o, lse, do, causal=True) for _ in range(2))
    diff = (dq1.float() - dq2.float()).abs()
    limit = DQ_RUN_RTOL * torch.maximum(dq1.float().abs(), dq2.float().abs())
    off = int((diff > limit + DQ_RUN_ATOL).sum())
    differ = int((dq1 != dq2).sum())
    out["dq_run_to_run"] = {"max_abs_diff": diff.max().item(),
                            "elements_differing": differ,
                            "elements_outside": off,
                            "rtol": DQ_RUN_RTOL, "atol": DQ_RUN_ATOL}
    log(f"  flash backward run to run: dq max abs diff "
        f"{diff.max().item():.3e}, {differ} of {dq1.numel()} elements "
        f"differ, {off} outside one bf16 step + {DQ_RUN_ATOL}; dk, dv "
        f"equal: {torch.equal(dk1, dk2) and torch.equal(dv1, dv2)}")
    if off or not (torch.equal(dk1, dk2) and torch.equal(dv1, dv2)):
        raise RuntimeError("flash backward: two runs on the same inputs "
                           "disagree beyond the stated tolerance")
    return out


def train_param_shapes() -> list:
    """The shapes of the training path's parameters, in optimizer order
    (a model on the meta device allocates nothing)."""
    cfg = gpt_config("gpt3-350m", max_seq_len=TRAIN_RUNG.get("seq", 1024))
    model = GPTForCausalLM(cfg, device="meta")
    return [tuple(p.shape) for _, p in model.named_parameters()]


def time_adam(gen) -> dict:
    """One optimizer step's fused Adam (one multi-tensor launch where the
    toolkit allows) over buffers of the training path's 292 parameter
    shapes (float32 master, moments, bf16
    gradient and parameter copy), against the plain version over the same
    buffers and ``torch.optim.AdamW(fused=True)`` (the library yardstick,
    never called by the port; it reads float32 gradients and writes no
    bf16 copy)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    shapes = train_param_shapes()
    n = sum(int(np.prod(s)) for s in shapes)
    bufs = []
    for shp in shapes:
        p = torch.randn(shp, generator=gen, device="cuda") * 0.02
        bufs.append((p, (torch.randn(shp, generator=gen, device="cuda")
                         * 1e-3).to(torch.bfloat16),
                     torch.zeros_like(p), torch.zeros_like(p),
                     torch.empty(shp, dtype=torch.bfloat16, device="cuda")))
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    decay = 1 - 1e-6
    groups = [(p, g, m, v, decay, out) for p, g, m, v, out in bufs]

    def kernel():  # one host call, the plan's launches: as the optimizer
        fo.fused_adam_update_many(groups, 1e-4, 0.1, 0.001, **hyper)

    def plain():
        for p, g, m, v, out in bufs:
            fo.fused_adam_update_reference(p, g, m, v, 1e-4, 0.1, 0.001,
                                           decay=decay, p_out=out, **hyper)

    lib_params = [torch.nn.Parameter(p.clone()) for p, *_ in bufs]
    for lp, (_, g, *_rest) in zip(lib_params, bufs):
        lp.grad = g.float()
    lib_opt = torch.optim.AdamW(lib_params, lr=1e-4, weight_decay=0.01,
                                fused=True)
    t_plain = time_ms(plain, flush, iters=5)
    t_kernel = time_ms(kernel, flush, iters=10)
    t_kernel = min(t_kernel, time_ms(kernel, flush, iters=10))
    t_plain = min(t_plain, time_ms(plain, flush, iters=5))
    t_lib = time_ms(lib_opt.step, flush, iters=10)
    nbytes = n * (3 * 4 + 2 + 3 * 4 + 2)  # p, m, v, g in; p, m, v, bf16 p out
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 10 * n / PEAK_FLOPS[torch.float32]
    b_ms = max(t_bytes, t_ops) * 1e3
    b_by = "bytes" if t_bytes >= t_ops else "operations"
    shape = f"{len(shapes)} tensors, {n} elements (one training step)"
    log(f"  time adam: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, "
        f"library (torch.optim.AdamW fused) {t_lib:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; {nbytes / 1e9:.3f} GB) [{shape}]")
    return {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": t_lib, "shape": shape}


# ---------------------------------------------------------------- phase 4
def fp32_check(model, label: str = "greedy", draft=None, **extra) -> None:
    """Serve 2 requests (100 and 300 prompt tokens, 16 new) and hold every
    token against the no-cache forward over the served sequence: greedy,
    its argmax; with ``do_sample`` in ``extra``, the port's
    ``sample_logits`` of the forward's logits under the engine's key
    ``fold_in(fold_in(key(seed), rid), t)``. A request's comparison stops
    past a position where the two largest logits (sampled: the two
    largest filtered logits plus the Gumbel noise) are within
    ``TIE_GAP``: a numerical tie. ``draft``: the speculative proposer,
    which must then have candidates accepted."""
    cfg = ServingConfig(max_batch=2, num_pages=1 + 2 * 64, page_size=16,
                        max_prompt_len=512, **extra)
    engine = ServingEngine(model, cfg, draft_model=draft)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (100, 300)]
    rids = [engine.add_request(p, 16) for p in prompts]
    out = engine.run()
    compared = 0
    for rid, prompt in zip(rids, prompts):
        seq = out[rid]
        if seq.shape != (len(prompt) + 16,):
            raise RuntimeError(f"request {rid}: output shape {seq.shape}")
        with torch.no_grad():
            logits = model(torch.as_tensor(seq, device=model.device)
                           .long()[None])[0]
        if not torch.isfinite(logits).all():
            raise RuntimeError("non-finite logits in the reference forward")
        for i in range(16):
            row = logits[len(prompt) - 1 + i]
            if cfg.do_sample:
                key = prng.fold_in(prng.fold_in(
                    prng.key(cfg.seed, model.device), rid), i)
                ranked = filter_logits(row, cfg.temperature, cfg.top_k,
                                       cfg.top_p) \
                    + prng.gumbel(key, row.shape)
                want = int(sample_logits(row[None], key[None],
                                         cfg.temperature, cfg.top_k,
                                         cfg.top_p)[0])
            else:
                ranked = row
                want = int(row.argmax())
            top2 = torch.topk(ranked, 2).values
            gap = (top2[0] - top2[1]).item()
            if gap < TIE_GAP:
                log(f"  fp32 {label} request {rid}: reference top-2 within "
                    f"{gap:.2e} at generated token {i}; comparison stops "
                    f"there")
                break
            if int(seq[len(prompt) + i]) != want:
                raise RuntimeError(
                    f"{label} request {rid} token {i}: served "
                    f"{seq[len(prompt) + i]}, reference {want} (top-2 gap "
                    f"{gap:.3e})")
            compared += 1
    c = engine.counters
    log(f"  fp32 check ({label}): {compared} of 32 tokens equal the no-cache "
        f"reference's; prefill chunks {c.prefill_chunks}, decode steps "
        f"{c.decode_steps} (verify {c.verify_steps}, accepted "
        f"{c.spec_accepted} of {c.spec_proposed} proposed)")
    if draft is not None and not c.spec_accepted:
        raise RuntimeError(f"{label}: no candidate accepted, so no step "
                           f"emitted more than one token")


# ---------------------------------------------------------------- phase 5
def serve_requests(vocab: int):
    """16 prompts of 32-512 tokens; requests 0, 8, 12 and 15 share a
    256-token prefix (0 is admitted first; the others after slots free,
    so they find its pages in the prefix cache)."""
    rng = np.random.default_rng(SEED + 2)
    shared = rng.integers(0, vocab, 256)
    prompts = []
    for i in range(16):
        if i in (0, 8, 12, 15):
            tail = rng.integers(0, vocab, int(rng.integers(16, 257)))
            prompts.append(np.concatenate([shared, tail]).astype(np.int32))
        else:
            n = int(rng.integers(32, 513))
            prompts.append(rng.integers(0, vocab, n).astype(np.int32))
    return prompts


def phase5_config(**kw) -> ServingConfig:
    """Phase 5's engine shape (batch 8, 513 pages of 16, prompts up to
    512), fields in ``kw`` taking precedence."""
    return ServingConfig(**{"max_batch": 8, "num_pages": 1 + 8 * 64,
                            "page_size": 16, "max_prompt_len": 512, **kw})


def serve(model, card_line: str, kv_dtype: str = "float32",
          baseline=None, label: str = "serve", inspect=None,
          **cfg_kw) -> dict:
    """The 16 requests through ``ServingEngine`` with ``kv_dtype`` pools
    and the other ``cfg_kw`` (with ``tenants``, the requests take the
    tenants in turn); the launch counters are set to 0 just before the
    run and read just after. ``baseline``: phase 5's outputs, against
    which the share of equal greedy tokens is reported. ``inspect(engine)``
    returns a dict of what else the caller reads off the engine."""
    cfg = phase5_config(kv_dtype=kv_dtype, **cfg_kw)
    engine = ServingEngine(model, cfg)
    prompts = serve_requests(model.cfg.vocab_size)
    tenants = sorted(cfg.tenants or {"default": None})
    rids = [engine.add_request(p, 64, tenant=tenants[i % len(tenants)])
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    gc.collect()  # engines of earlier runs (reference cycles) must not
    torch.cuda.reset_peak_memory_stats()  # count in this run's peak
    reset_counters()          # every kernel's count, just before the path
    t0 = time.perf_counter()
    with ProgramTally() as tally:
        out = engine.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    c = engine.counters
    peak = torch.cuda.max_memory_allocated()
    outputs = []
    for rid, prompt in zip(rids, prompts):
        seq = out[rid]
        if seq.shape != (len(prompt) + 64,) or \
                not ((seq >= 0) & (seq < model.cfg.vocab_size)).all():
            raise RuntimeError(f"request {rid}: bad output {seq.shape}")
        outputs.append(seq[len(prompt):])
    if c.prefix_hit_tokens <= 0:
        raise RuntimeError("no prefix-cache hit on the shared 256-token "
                           "prefix")
    steps = c.prefills + c.decode_steps
    ragged = "ragged_int8" if kv_dtype == "int8" else "ragged"
    want = {ragged: model.cfg.num_layers * steps,
            "ln_fwd": (2 * model.cfg.num_layers + 1) * steps,
            **tally.expected(model.cfg.num_layers, c.decode_steps,
                             next(model.parameters()).dtype
                             == torch.bfloat16)}
    check_launches(counts, want, f"serving ({kv_dtype} pools)")
    generated = 64 * len(prompts)
    equal = ""
    if baseline is not None:
        same = sum(int((a == b).sum()) for a, b in zip(outputs, baseline))
        prefix = np.mean([int(np.argmin(np.append(a == b, False)))
                          for a, b in zip(outputs, baseline)])
        equal = (f"; greedy tokens equal to the bf16-pool run "
                 f"{same}/{generated} = {same / generated:.4f} (mean common "
                 f"prefix {prefix:.1f} of 64)")
    log(f"  {label} {PRESET} bf16 weights, {kv_dtype} pools: {len(prompts)} "
        f"requests, {generated} tokens in {wall:.3f} s = "
        f"{generated / wall:.1f} tok/s; {c.prefills} prefills, mean "
        f"{1e3 * c.prefill_seconds / c.prefills:.3f} ms; {c.decode_steps} "
        f"decode steps, mean {1e3 * c.decode_seconds / c.decode_steps:.3f} "
        f"ms; prefix-hit tokens {c.prefix_hit_tokens}; preemptions "
        f"{c.preemptions}; kv_bytes_per_token {c.kv_bytes_per_token}; peak "
        f"memory {peak / 2**30:.3f} GiB; launches {ragged} "
        f"{counts[ragged]} = {model.cfg.num_layers} x ({c.prefills} + "
        f"{c.decode_steps}) by program split {counts['ragged_split']}, "
        f"mma {counts['ragged_mma']}, warp {counts['ragged_warp']} (calls "
        f"by query count: {tally.buckets()}), layernorm fwd "
        f"{counts['ln_fwd']} = {2 * model.cfg.num_layers + 1} x "
        f"{steps}{equal} [{card_line}]")
    return {"launches": counts, "outputs": outputs, "wall": wall,
            "tok_s": generated / wall,
            "decode_ms": 1e3 * c.decode_seconds / c.decode_steps,
            **(inspect(engine) if inspect is not None else {})}


def kvq_prompts(vocab: int):
    """The scenario's requests: one warm request to register the system
    prefix, then per cycle a burst of warm requests (the prefix plus a
    tail) and a burst of whales."""
    rng = np.random.default_rng(SEED + 6)
    system = rng.integers(0, vocab, KVQ_SYSTEM)
    warm = [np.concatenate([system, rng.integers(0, vocab, KVQ_WARM_TAIL)])
            .astype(np.int32) for _ in range(1 + KVQ_CYCLES * KVQ_BURST)]
    whales = [rng.integers(0, vocab, KVQ_WHALE).astype(np.int32)
              for _ in range(KVQ_CYCLES * KVQ_BURST)]
    return warm, whales


def kvq_leg(model, kv_dtype, num_pages, tier_bytes, prompts) -> dict:
    """One leg of the scenario; the launch counters are set to 0 before
    it and read after."""
    warm, whales = prompts
    engine = ServingEngine(model, ServingConfig(
        max_batch=KVQ_BURST, num_pages=num_pages, page_size=16,
        max_prompt_len=KVQ_WHALE, kv_dtype=kv_dtype,
        host_tier_bytes=tier_bytes))
    reset_counters()
    t0 = time.perf_counter()
    served = 0
    with ProgramTally() as tally:
        engine.add_request(warm[0], KVQ_NEW)
        served += len(engine.run())
        for cycle in range(KVQ_CYCLES):
            at = slice(cycle * KVQ_BURST, (cycle + 1) * KVQ_BURST)
            for p in warm[1:][at]:
                engine.add_request(p, KVQ_NEW)
            served += len(engine.run())
            for p in whales[at]:
                engine.add_request(p, KVQ_NEW)
            served += len(engine.run())
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = engine.counters
    ragged = "ragged_int8" if kv_dtype == "int8" else "ragged"
    check_launches(launch_counts(),
                   {ragged: model.cfg.num_layers
                    * (c.prefills + c.decode_steps),
                    "ln_fwd": (2 * model.cfg.num_layers + 1)
                    * (c.prefills + c.decode_steps),
                    **tally.expected(model.cfg.num_layers, c.decode_steps,
                                     True)},
                   f"the KV-quantisation scenario ({kv_dtype}, {num_pages} "
                   f"pages)")
    engine.cache.check_invariants()
    return {"counters": c, "wall": wall, "tokens": served * KVQ_NEW,
            "num_pages": num_pages}


def kvq_scenario(model, card_line: str) -> dict:
    """bench.py's KV-quantisation scenario at gpt3-1.3b's width: bf16
    pools sized so one whale burst fills them, int8 pools at the same
    byte budget, int8 pools at the bf16 page count plus the host tier."""
    mc = model.cfg
    hd = mc.hidden_size // mc.num_heads
    page_elems = 2 * mc.num_layers * 16 * mc.num_heads * hd
    bf16_page = page_elems * 2
    int8_page = page_elems + 2 * mc.num_layers * mc.num_heads * 4
    whale_pages = -(-(KVQ_WHALE + KVQ_NEW) // 16)
    float_pages = 1 + KVQ_BURST * whale_pages
    int8_pages = float_pages * bf16_page // int8_page
    prompts = kvq_prompts(mc.vocab_size)
    legs = {"bf16": kvq_leg(model, "float32", float_pages, 0, prompts),
            "int8 same bytes": kvq_leg(model, "int8", int8_pages, 0,
                                       prompts),
            "int8 + host tier": kvq_leg(model, "int8", float_pages,
                                        KVQ_TIER_BYTES, prompts)}
    for name, leg in legs.items():
        c = leg["counters"]
        log(f"  kvq leg {name:16s}: {leg['num_pages']} pages, "
            f"{leg['tokens']} tokens in {leg['wall']:.3f} s = "
            f"{leg['tokens'] / leg['wall']:.1f} tok/s; prefill tokens "
            f"{c.prefill_tokens}, prefix-hit tokens {c.prefix_hit_tokens}, "
            f"evictions {c.prefix_evictions}, spills {c.host_tier_spills}, "
            f"restores {c.host_tier_restores}, tier hits "
            f"{c.host_tier_hits}, tier bytes {c.host_tier_bytes}; decode "
            f"step mean {1e3 * c.decode_seconds / c.decode_steps:.3f} ms; "
            f"kv_bytes_per_token {c.kv_bytes_per_token} [{card_line}]")
    f, q8, tier = (legs[k]["counters"] for k in legs)
    checks = {
        "the bf16 leg evicts": f.prefix_evictions > 0,
        "the bf16 leg restores nothing": f.host_tier_restores == 0,
        "the tier leg restores pages": tier.host_tier_restores > 0,
        "the tier leg prefills no more than the bf16 leg":
            tier.prefill_tokens <= f.prefill_tokens,
        "the byte-matched int8 leg prefills no more than the tier leg":
            q8.prefill_tokens <= tier.prefill_tokens}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"KV-quantisation scenario: {failed}")
    log(f"  kvq asserts hold: {'; '.join(checks)}")
    return legs


# --------------------------------------------------------------- phase 5c
def serve_leg(model, card_line, name, prompts, *, draft=None, baseline=None,
              inspect=None, **cfg_kw) -> dict:
    """One leg of phase 5c: ``prompts`` (64 new tokens each) through
    ``ServingEngine`` with ``cfg_kw``; the launch counters are set to 0
    just before the run and read just after. Every target forward (prefill
    chunk or pass, decode or verify step) launches the ragged kernel once
    a layer and the LayerNorm forward 2 * layers + 1 times; the draft's
    forwards (K a verify step) add their LayerNorms. The ragged launches by
    program must equal what the calls' shapes give, every verify step on
    the split program, and every plain version 0. ``inspect(engine)``
    returns a dict of what else the caller reads off the engine."""
    cfg = phase5_config(**cfg_kw)
    engine = ServingEngine(model, cfg, draft_model=draft)
    rids = [engine.add_request(p, 64) for p in prompts]
    torch.cuda.synchronize()
    reset_counters()          # every kernel's count, just before the path
    t0 = time.perf_counter()
    out, limits = {}, []  # limits: (step, SLO chunk_limit) at each change
    with ProgramTally() as tally:
        while not engine.scheduler.all_done:  # engine.run(), step by step
            for rid in engine.step():
                out[rid] = engine.result(rid)
            limit = monitor.stat_get("serving_chunk_limit")
            if not limits or limits[-1][1] != limit:
                limits.append((engine._step_idx, limit))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    c = engine.counters
    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    outputs = []
    for rid, prompt in zip(rids, prompts):
        seq = out[rid]
        if seq.shape != (len(prompt) + 64,) or \
                not ((seq >= 0) & (seq < vocab)).all():
            raise RuntimeError(f"{name}: request {rid}: bad output")
        outputs.append(seq[len(prompt):])
    passes = c.prefill_chunks if cfg.chunk_size else c.prefills
    forwards = passes + c.decode_steps
    ln = (2 * layers + 1) * forwards
    if draft is not None:
        ln += (2 * draft.cfg.num_layers + 1) * cfg.spec.depth * c.verify_steps
    ragged = "ragged_int8" if cfg.kv_dtype == "int8" else "ragged"
    step_s = cfg.spec.depth + 1 if cfg.spec is not None else 1
    per_verify = (sum(s == step_s for s, _ in tally.calls) / c.verify_steps
                  if c.verify_steps else None)
    want = {ragged: layers * forwards, "ln_fwd": ln,
            **tally.expected(layers, c.decode_steps,
                             model.dtype == torch.bfloat16, step_s)}
    check_launches(counts, want, f"phase 5c leg {name}")
    engine.cache.check_invariants()
    if engine.cache.allocator.pages_in_use:
        raise RuntimeError(f"{name}: pages still in use after the run")
    generated = 64 * len(prompts)
    slots = c.spec_proposed // cfg.spec.depth if cfg.spec else 0
    verify_calls = ("" if per_verify is None else
                    f" ({per_verify} calls of {step_s} queries a verify step)")
    equal = ""
    if baseline is not None:
        same = sum(int((a == b).sum()) for a, b in zip(outputs, baseline))
        equal = (f"; greedy tokens equal to phase 5's {same}/{generated} = "
                 f"{same / generated:.4f}")
    log(f"  leg {name}: {len(prompts)} requests, {generated} tokens in "
        f"{wall:.3f} s = {generated / wall:.1f} tok/s; {engine._step_idx} "
        f"steps, {c.decode_steps} decode/verify steps (verify "
        f"{c.verify_steps}), accepted {c.spec_accepted} of "
        f"{c.spec_proposed} proposed = "
        f"{c.spec_accepted / max(c.verify_steps, 1):.3f} a verify step, "
        f"{c.spec_accepted / max(slots, 1):.3f} a request a verify step; "
        f"swaps out {c.swaps_out}, in {c.swaps_in}; preemptions "
        f"{c.preemptions}; prefill chunks {c.prefill_chunks}, prefills "
        f"{c.prefills}; launches {ragged} {counts[ragged]} = {layers} x "
        f"{forwards}{verify_calls} by program split {counts['ragged_split']}, mma "
        f"{counts['ragged_mma']}, warp {counts['ragged_warp']} (calls by "
        f"query count: {tally.buckets()}), layernorm fwd "
        f"{counts['ln_fwd']}{equal} [{card_line}]")
    return {"launches": counts, "counters": c, "wall": wall,
            "outputs": outputs, "launches_per_verify_step": per_verify,
            "chunk_limits": limits,
            "throttles": monitor.stat_get("serving_slo_throttles_total"),
            **(inspect(engine) if inspect is not None else {})}


def serve_features(model, card_line: str, baseline) -> dict:
    """Phase 5c: phase 5's requests through the sampled, chunked and
    speculative paths: (a) sampled, chunk 128; (b) greedy, n-gram
    speculation at depth 4, chunk 128, a pool small enough that swap
    preemption fires, then (b) again over int8 pools; (c) greedy with a
    draft proposer (a 2-layer GPT at gpt3-125m's width) on 4 requests."""
    prompts = serve_requests(model.cfg.vocab_size)
    ngram = SpecConfig(method="ngram", depth=SPEC_DEPTH)
    legs = {"a sampled": serve_leg(model, card_line, "a sampled", prompts,
                                   chunk_size=128, **SAMPLING)}
    for kv in ("float32", "int8"):
        leg = f"b spec+swap {kv}"
        legs[leg] = serve_leg(
            model, card_line, leg, prompts, baseline=baseline,
            spec=ngram, chunk_size=128, num_pages=LEG_B_PAGES,
            preemption_mode="swap", kv_dtype=kv)
        c = legs[leg]["counters"]
        if not c.swaps_out or c.swaps_in != c.swaps_out:
            raise RuntimeError(f"leg {leg}: swaps out {c.swaps_out}, in "
                               f"{c.swaps_in}")
    draft = GPTForCausalLM(
        gpt_config("gpt3-125m", num_layers=DRAFT_LAYERS,
                   vocab_size=model.cfg.vocab_size), device=model.device,
        dtype=model.dtype,
        generator=torch.Generator(model.device).manual_seed(SEED + 7))
    legs["c draft"] = serve_leg(
        model, card_line, "c draft", prompts[:4], draft=draft,
        spec=SpecConfig(method="draft", depth=SPEC_DEPTH, window=8,
                        draft=draft.cfg))
    return legs


# --------------------------------------------------------------- phase 5g
def debug_readings(engine) -> dict:
    """What phase 5g holds a debug-checked run to, read off its engine:
    no retrace, a signature per pad bucket used plus the decode step's,
    one host read a decode step and a completed prefill, every audited
    program free of collectives and host reads with its pools written in
    place, the roofline shares in (0, 1]."""
    snap = engine.metrics.snapshot()
    audits = engine.hlo_audits
    c = engine.counters
    buckets = sorted(int(k[8:-1]) for k in audits if k.startswith("prefill"))
    counts = engine.compile_counts
    syncs = snap["serving_analysis_host_syncs_total"]
    # a swap-out copies its slot's pages (at most one mover call) to the
    # host: one read, two over int8 pools (codes and scales)
    reads = c.decode_steps + c.prefills + c.swaps_out * (
        2 if engine.cache.cfg.quantized else 1)
    problems = []
    if snap["serving_analysis_retraces_total"]:
        problems.append(f"{snap['serving_analysis_retraces_total']} "
                        f"retraces")
    if counts["prefill"] != len(buckets) or \
            sum(counts.values()) != len(buckets) + 1:
        problems.append(f"compile_counts {counts} for buckets {buckets}")
    if syncs != reads:
        problems.append(f"{syncs} host syncs for {c.decode_steps} decode "
                        f"steps, {c.prefills} prefills and {c.swaps_out} "
                        f"swaps out")
    for label, r in audits.items():
        if r.collectives or r.host_transfers or \
                r.aliased_leaves != r.donated_leaves or not r.donated_leaves:
            problems.append(f"{label}: {r.summary()}")
    mfu, bw = snap["serving_mfu"], snap["serving_hbm_bw_util"]
    if not (0 < mfu <= 1 and 0 < bw <= 1):
        problems.append(f"serving_mfu {mfu}, serving_hbm_bw_util {bw}")
    kernel_ab = kernel_ab_readings(engine, snap)
    # every decode or verify dispatch ran the kernel (the card's leg); the
    # plain version's leg has no sample, so the measured half stays absent
    legs = engine._roofline._kernel_s
    kernel_calls = sum(acc[1] for acc in legs.values())
    if any(acc[3] for acc in legs.values()) or kernel_calls != \
            c.decode_steps or any(v["measured"] for v in kernel_ab.values()):
        problems.append(f"kernel A/B legs {legs} for {c.decode_steps} "
                        f"decode steps; gauges {kernel_ab}")
    if problems:
        raise RuntimeError("debug checks: " + "; ".join(problems))
    return {"buckets": buckets, "syncs": syncs, "mfu": mfu, "hbm_bw": bw,
            "kernel_ab": kernel_ab,
            "programs": {label: {
                "flops": r.flops, "peak_bytes": r.peak_bytes,
                "drift": snap[f"serving_cost_model_drift{{program={label}}}"]}
                for label, r in audits.items()},
            "max_memory": torch.cuda.max_memory_allocated(),
            "guards": {k: (g.traces, g.calls)
                       for k, g in engine.cache.guards.items()}}


def kernel_ab_readings(engine, snap) -> dict:
    """The ``serving_kernel_speedup_*{kernel=}`` gauges: each label's
    banked prediction (the port's kernelcheck bank, which must equal
    ``load_banked_kernel_speedups``), its measured ratio and drift, and
    the engine's samples on each leg (kernel calls, their mean ms)."""
    banked = load_banked_kernel_speedups()
    out = {}
    for label, predicted in banked.items():
        got = snap[f"serving_kernel_speedup_predicted{{kernel={label}}}"]
        if got != predicted:
            raise RuntimeError(f"kernel A/B {label}: predicted {got}, "
                               f"banked {predicted}")
        acc = engine._roofline._kernel_s.get(label, [0.0, 0, 0.0, 0])
        out[label] = {
            "predicted": predicted,
            "measured": snap[f"serving_kernel_speedup_measured{{kernel="
                             f"{label}}}"],
            "drift": snap[f"serving_kernel_speedup_drift{{kernel={label}}}"],
            "kernel_calls": acc[1], "plain_calls": acc[3],
            "kernel_mean_ms": acc[0] / acc[1] * 1e3 if acc[1] else None}
    return out


def serve_debug(model, card_line: str, served, served_int8) -> dict:
    """Phase 5g: phase 5's requests under ``debug_checks`` over bf16 then
    int8 pools (tokens equal bit for bit to phases 5 and 6b), then on and
    off in turns, then phase 5c's leg (b) under the checks."""
    out = {}
    for kv, base in (("float32", served), ("int8", served_int8)):
        got = serve(model, card_line, kv, base["outputs"],
                    label=f"debug checks ({kv} pools)",
                    inspect=debug_readings, debug_checks=True)
        if any(not np.array_equal(a, b)
               for a, b in zip(got["outputs"], base["outputs"])):
            raise RuntimeError(f"debug checks ({kv} pools): tokens differ "
                               f"from the unchecked run's")
        out[kv] = got
        log(f"  debug checks ({kv} pools): buckets {got['buckets']} + "
            f"decode, host syncs {got['syncs']} = decode steps + prefills, "
            f"no retrace, every program free of collectives and host reads "
            f"with its pools written in place; serving_mfu "
            f"{got['mfu']:.6f}, serving_hbm_bw_util {got['hbm_bw']:.6f}; "
            f"torch.cuda.max_memory_allocated "
            f"{got['max_memory'] / 2**30:.3f} GiB [{card_line}]")
        for label, p in got["programs"].items():
            log(f"    {label}: cost model {p['flops']:.4e} flops, peak "
                f"bytes {p['peak_bytes'] / 2**30:.3f} GiB, "
                f"serving_cost_model_drift {p['drift']:.3f}")
        fed = {k: v for k, v in got["kernel_ab"].items() if v["kernel_calls"]}
        log(f"    kernel A/B gauges: predicted (the port's bank) "
            + ", ".join(f"{k} {v['predicted']}"
                        for k, v in got["kernel_ab"].items())
            + "; fed on the kernel's leg: "
            + ", ".join(f"{k} {v['kernel_calls']} calls, mean "
                        f"{v['kernel_mean_ms']:.3f} ms (dispatch to token "
                        f"read)" for k, v in fed.items())
            + "; measured and drift absent (0): no plain-version leg on "
              "the card")
    turns = []
    for debug in (True, False, False, True):
        r = serve(model, card_line, baseline=served["outputs"],
                  label=f"debug checks {'on' if debug else 'off'}",
                  debug_checks=debug)
        turns.append({"debug": debug, "tok_s": r["tok_s"],
                      "decode_ms": r["decode_ms"]})
    log("  debug checks on/off/off/on: tokens/s "
        + ", ".join(f"{t['tok_s']:.1f}" for t in turns)
        + "; mean decode-step ms "
        + ", ".join(f"{t['decode_ms']:.3f}" for t in turns)
        + f" [{card_line}]")
    out["turns"] = turns
    prompts = serve_requests(model.cfg.vocab_size)
    leg = serve_leg(
        model, card_line, "b spec+swap under debug checks", prompts,
        baseline=served["outputs"], inspect=debug_readings,
        spec=SpecConfig(method="ngram", depth=SPEC_DEPTH), chunk_size=128,
        num_pages=LEG_B_PAGES, preemption_mode="swap", debug_checks=True)
    c = leg["counters"]
    gather, scatter = leg["guards"]["swap_gather"], leg["guards"][
        "swap_scatter"]
    if "verify" not in leg["programs"] or not c.swaps_out or \
            gather != (1, c.swaps_out) or scatter[0] != 1 or \
            scatter[1] < c.swaps_in:
        raise RuntimeError(f"leg (b) under debug checks: programs "
                           f"{sorted(leg['programs'])}, swaps out "
                           f"{c.swaps_out}, in {c.swaps_in}, swap movers "
                           f"(signatures, calls) {leg['guards']}")
    log(f"  leg (b) under debug checks: programs {sorted(leg['programs'])} "
        f"audited; swap movers (signatures, calls) {leg['guards']} for "
        f"{c.swaps_out} swaps out, {c.swaps_in} in; host syncs "
        f"{leg['syncs']}; kernel A/B fed: "
        + ", ".join(f"{k} {v['kernel_calls']} calls"
                    for k, v in leg["kernel_ab"].items()
                    if v["kernel_calls"]))
    out["leg_b"] = leg
    return out


# --------------------------------------------------------------- phase 5e
def fleet_waves(vocab: int):
    """Wave 1: phase 5's 16 prompts. Wave 2: FLEET_WAVE2 prompts of the
    shared 256-token prefix and fresh tails of 16-256 tokens."""
    wave1 = serve_requests(vocab)
    rng = np.random.default_rng(SEED + 5)
    wave2 = [np.concatenate([wave1[0][:256], rng.integers(
        0, vocab, int(rng.integers(16, 257)))]).astype(np.int32)
        for _ in range(FLEET_WAVE2)]
    return wave1, wave2


def fleet_leg(model, card_line, routing, waves, baseline) -> dict:
    """Both waves through FLEET_REPLICAS replicas of ``model`` (one set of
    weights, a pool each) under ``routing``; the counters are set to 0
    just before and read just after. Every replica's forwards launch the
    ragged kernel once a layer and the LayerNorm forward 2L + 1 times,
    the programs as the calls' shapes give them, every plain version 0.
    Wave 1 is phase 5's requests, greedy: its tokens must equal phase
    5's, whichever replica and batch served them."""
    fleet = FleetRouter(model, FleetConfig(
        num_replicas=FLEET_REPLICAS, routing=routing,
        engine=phase5_config()))
    torch.cuda.synchronize()
    reset_counters()          # every kernel's count, just before the path
    t0 = time.perf_counter()
    outs = []
    with ProgramTally() as tally:
        for wave in waves:
            rids = [fleet.submit(p, 64) for p in wave]
            done = fleet.run()
            outs.append([done[r] for r in rids])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    layers = model.cfg.num_layers
    cs = [e.counters for e in fleet.replicas]
    forwards = sum(c.prefills + c.decode_steps for c in cs)
    check_launches(counts, {
        "ragged": layers * forwards, "ln_fwd": (2 * layers + 1) * forwards,
        **tally.expected(layers, sum(c.decode_steps for c in cs), True)},
        f"phase 5e fleet ({routing})")
    for wave, out in zip(waves, outs):
        for p, seq in zip(wave, out):
            if seq.shape != (len(p) + 64,):
                raise RuntimeError(f"fleet ({routing}): bad output shape")
    gen1 = [seq[len(p):] for p, seq in zip(waves[0], outs[0])]
    same = sum(int((a == b).sum()) for a, b in zip(gen1, baseline))
    share = same / (64 * len(gen1))
    if same != 64 * len(gen1):
        raise RuntimeError(f"fleet ({routing}): wave-1 tokens equal to phase "
                           f"5's {same}/{64 * len(gen1)}")
    hits = [c.prefix_hit_tokens for c in cs]
    routed = np.bincount([r[0] for r in fleet.routes.values()],
                         minlength=FLEET_REPLICAS).tolist()
    snap = fleet.metrics.snapshot()
    tokens = 64 * sum(len(w) for w in waves)
    log(f"  fleet {routing}: {FLEET_REPLICAS} replicas, {tokens} tokens in "
        f"{wall:.3f} s = {tokens / wall:.1f} tok/s; prefix-hit tokens by "
        f"replica {hits} (total {sum(hits)}); requests by replica {routed}; "
        f"affinity hits {snap['serving_fleet_prefix_affinity_hits_total']}, "
        f"spills {snap['serving_fleet_spills_total']}; launches ragged "
        f"{counts['ragged']} = {layers} x {forwards} by program split "
        f"{counts['ragged_split']}, mma {counts['ragged_mma']}, warp "
        f"{counts['ragged_warp']}; wave-1 tokens equal to phase 5's "
        f"{same}/{64 * len(gen1)} = {share:.4f} [{card_line}]")
    return {"launches": counts, "wall": wall, "tok_s": tokens / wall,
            "prefix_hits": hits, "equal_share": share,
            "affinity_hits": snap["serving_fleet_prefix_affinity_hits_total"]}


def fetch_leg(model, card_line, waves) -> dict:
    """A cross-replica page fetch over a lossless ``SimChannel``: request
    X warms replica 0 with the shared prefix; round-robin sends request Y
    (the same prefix, another tail) to the cold replica 1, so the router
    reads replica 0's prefix pages to the host, frames them (bf16: the
    port's dtype tag 2), decodes them and imports them into replica 1's
    host tier, where Y's admission restores them. Y's tokens must equal
    those of Y served after X on one engine, where the same pages are a
    local prefix hit: a restore moves the bytes exactly."""
    x, y = waves[1][0], waves[1][1]
    cfg = phase5_config(host_tier_bytes=FLEET_TIER_BYTES)
    ref = ServingEngine(model, cfg)
    ref.add_request(x, 64)
    ref.run()
    ry = ref.add_request(y, 64)
    want = ref.run()[ry]
    del ref
    transport = Transport(SimChannel())
    fleet = FleetRouter(model, FleetConfig(
        num_replicas=2, routing="round_robin", engine=cfg,
        transport=transport, fetch_pages=True))
    fleet.submit(x, 64)
    fleet.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid = fleet.submit(y, 64)
    got = fleet.run()[rid]
    wall = time.perf_counter() - t0
    cold = fleet.replicas[1].cache
    if fleet.routes[rid][0] != 1 or cold.host_tier_hits != 1 \
            or cold.restores != 256 // cfg.page_size:
        raise RuntimeError(f"fetch leg: route {fleet.routes[rid]}, tier hits "
                           f"{cold.host_tier_hits}, restores {cold.restores}")
    if not np.array_equal(got, want):
        raise RuntimeError("fetch leg: tokens after the fetch differ from "
                           "a local prefix hit's")
    log(f"  fetch leg: {cold.restores} pages ({transport.rx_bytes} frame "
        f"bytes) fetched from replica 0 into replica 1's host tier and "
        f"restored; {transport.exchanges_total} exchanges, retries "
        f"{transport.retries_total}; request Y's 64 tokens equal a local "
        f"prefix hit's; Y served in {wall:.3f} s [{card_line}]")
    return {"pages": cold.restores, "rx_bytes": transport.rx_bytes}


def serve_fleet(model, card_line: str, baseline) -> dict:
    """Phase 5e: the fleet — both waves under affinity and round-robin
    routing in turns (affinity, round-robin, round-robin, affinity), the
    fetch leg, then a seeded chaos soak at CHAOS_LAYERS layers (every
    fault point armed, the invariants swept after every router step)."""
    waves = fleet_waves(model.cfg.vocab_size)
    legs = {}
    for i, routing in enumerate(("affinity", "round_robin", "round_robin",
                                 "affinity")):
        legs[f"{routing} {i}"] = fleet_leg(model, card_line, routing,
                                           waves, baseline)
        torch.cuda.empty_cache()
    aff = [sum(v["prefix_hits"]) for k, v in legs.items()
           if k.startswith("affinity")]
    rr = [sum(v["prefix_hits"]) for k, v in legs.items()
          if k.startswith("round_robin")]
    if min(aff) <= max(rr):
        raise RuntimeError(f"affinity routing hit {aff} prefix tokens, "
                           f"round-robin {rr}")
    fetched = fetch_leg(model, card_line, waves)
    torch.cuda.empty_cache()
    small = GPTForCausalLM(
        gpt_config(PRESET, num_layers=CHAOS_LAYERS), dtype=torch.bfloat16,
        generator=torch.Generator("cuda").manual_seed(SEED))
    t0 = time.perf_counter()
    rep = soak(small, ChaosConfig(seed=CHAOS_SEED))
    log(f"  chaos soak ({PRESET} width, {CHAOS_LAYERS} layers, bf16, seed "
        f"{CHAOS_SEED}) in {time.perf_counter() - t0:.3f} s, invariants "
        f"held after every step: {rep['requests']} requests over "
        f"{rep['steps']} steps, classes {rep['classes']}, ledger "
        f"{rep['goodput_tokens']} + {rep['badput_tokens']} = "
        f"{rep['tokens_total']}; wire {rep['wire']}; faults fired "
        f"{rep['faults_fired']}")
    return {"legs": legs, "fetch": fetched, "chaos": rep}


# --------------------------------------------------------------- phase 5f
def tp_rank(rank: int, world: int, init_method: str, backend: str) -> dict:
    """One rank of phase 5f, a spawned process on cuda:0 (gloo: the ranks
    share the card) or on cuda:``rank`` (NCCL: a card a rank): join the
    group over ``backend``, build gpt3-1.3b from phase 5's seed on the
    card (as phase 5 built it), serve phase 5's requests at TP=``world``
    in bf16, over int8 pools and with quantized logits, each leg's
    counters set to 0 just before and read just after; then the float32
    check against TP=1 on the same rank."""
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    ptd.init_parallel_env(backend, init_method, world, rank,
                          timeout_s=TP_RANK_TIMEOUT_S)
    try:
        model = GPTForCausalLM(
            gpt_config(PRESET), dtype=torch.float32,
            generator=torch.Generator("cuda").manual_seed(SEED)) \
            .to(torch.bfloat16)
        prompts = serve_requests(model.cfg.vocab_size)
        layers = model.cfg.num_layers
        legs = {}
        for name, kw in (("bf16", {}), ("int8", dict(kv_dtype="int8")),
                         ("quantized logits",
                          dict(tp_quantized_logits=True))):
            engine = ServingEngine(model, phase5_config(
                tensor_parallel=world, debug_checks=True, **kw))
            per_forward = []
            forward = engine._forward

            def counted(ids, paged, _forward=forward, _seen=per_forward):
                n0 = collective.all_reduces
                out = _forward(ids, paged)
                _seen.append(collective.all_reduces - n0)
                return out

            engine._forward = counted
            rids = [engine.add_request(p, 64) for p in prompts]
            torch.cuda.synchronize()
            reset_counters()  # every kernel's count, just before the path
            t0 = time.perf_counter()
            with ProgramTally() as tally:
                out = engine.run()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            c = engine.counters
            forwards = c.prefills + c.decode_steps
            ragged = "ragged_int8" if kw.get("kv_dtype") == "int8" \
                else "ragged"
            check_launches(counts, {
                ragged: layers * forwards,
                "ln_fwd": (2 * layers + 1) * forwards,
                **tally.expected(layers, c.decode_steps, True)},
                f"phase 5f rank {rank} ({name})")
            legs[name] = {
                "outputs": [out[r][len(p):] for r, p in zip(rids, prompts)],
                "per_forward": sorted(set(per_forward)),
                "forwards": len(per_forward), "wall": wall,
                "decode_ms": 1e3 * c.decode_seconds / c.decode_steps,
                "prefill_ms": 1e3 * c.prefill_seconds / c.prefills,
                "decode_steps": c.decode_steps, "prefills": c.prefills,
                "prefix_hit_tokens": c.prefix_hit_tokens,
                "pool_heads": engine.cache.pools.shape[4],
                "launches": {k: counts[k] for k in (
                    ragged, "ragged_split", "ragged_mma", "ragged_warp",
                    "ln_fwd")},
                "audits": tp_audits(engine)}
            del engine
            torch.cuda.empty_cache()
        dev = model.device
        del model
        torch.cuda.empty_cache()
        return {"legs": legs, "all_reduce_ms": all_reduce_ms(dev),
                "fp32": tp_fp32_check(world)}
    finally:
        ptd.destroy_process_group()


def tp_audits(engine) -> dict:
    """A TP rank's debug checks: every audited program's census equal to
    ``TPContext.step_budget`` in count and bytes, with no host read and
    the pools written in place; the placement gauges on the default
    one-host topology (NVLink bytes, no network bytes) and the host syncs
    (one a decode step and a completed prefill)."""
    snap = engine.metrics.snapshot()
    c = engine.counters
    problems = []
    programs = {}
    for label, r in engine.hlo_audits.items():
        budget = engine._step_budget(label)
        programs[label] = (len(r.collectives), r.collective_bytes)
        if programs[label] != (budget.all_reduce,
                               budget.max_collective_bytes) or \
                r.host_transfers or r.aliased_leaves != r.donated_leaves:
            problems.append(f"{label}: census {programs[label]}, budget "
                            f"({budget.all_reduce}, "
                            f"{budget.max_collective_bytes}); {r.summary()}")
    ici, dcn = (snap["serving_ici_bytes_per_token"],
                snap["serving_dcn_bytes_per_token"])
    syncs = snap["serving_analysis_host_syncs_total"]
    if not ici > 0 or dcn != 0 or syncs != c.decode_steps + c.prefills or \
            snap["serving_analysis_retraces_total"]:
        problems.append(f"ici {ici}, dcn {dcn} bytes a token, host syncs "
                        f"{syncs}, retraces "
                        f"{snap['serving_analysis_retraces_total']}")
    if problems:
        raise RuntimeError("TP debug checks: " + "; ".join(problems))
    return {"programs": programs, "ici_bytes_per_token": ici,
            "dcn_bytes_per_token": dcn, "host_syncs": syncs,
            "predicted_s": snap["serving_collective_time_predicted_s"]}


def all_reduce_ms(device) -> dict:
    """Host-clock ms of one all-reduce of a bf16 CUDA tensor of a decode
    step's partial sum ([8, 1, 2048], 32 KiB) and of a 512-token
    prefill's ([1, 512, 2048], 2 MiB), the mean of 50 and of 10 after 3
    warm-up calls, each run ending in a synchronise."""
    out = {}
    for label, shape, iters in (("32KiB", (8, 1, 2048), 50),
                                ("2MiB", (1, 512, 2048), 10)):
        x = torch.randn(shape, device=device, dtype=torch.bfloat16)
        for _ in range(3):
            collective.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            collective.all_reduce(x)
        torch.cuda.synchronize()
        out[label] = 1e3 * (time.perf_counter() - t0) / iters
    return out


def tp_fp32_check(world: int) -> dict:
    """On one rank: gpt3-1.3b's width at TP_CHECK_LAYERS layers in float32
    with TF32 off, served at TP=1 and at TP=``world`` (2 requests, 100
    and 300 prompt tokens, 16 new): every forward's logits at TP=``world``
    (the rows of its real tokens: padding and idle slots compute from the
    null page) within TP_LOGITS_RTOL of TP=1's (relative to their largest
    entry), and
    every TP token equal to the no-cache forward's argmax, except past a
    position whose top-2 logits are within TIE_GAP (phase 4's rule)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = GPTForCausalLM(
        gpt_config(PRESET, num_layers=TP_CHECK_LAYERS), dtype=torch.float32,
        generator=torch.Generator("cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (100, 300)]
    logits, outs = {}, {}
    for tp in (1, world):
        engine = ServingEngine(model, ServingConfig(
            max_batch=2, num_pages=1 + 2 * 64, page_size=16,
            max_prompt_len=512, tensor_parallel=tp))
        seen = logits[tp] = []
        forward = engine._forward

        def kept(ids, paged, _forward=forward, _seen=seen):
            out = _forward(ids, paged)
            _seen.append(out[paged.valid].float())  # the real tokens' rows
            return out

        engine._forward = kept
        rids = [engine.add_request(p, 16, rid=i)
                for i, p in enumerate(prompts)]
        done = engine.run()
        outs[tp] = [done[r] for r in rids]
    if len(logits[1]) != len(logits[world]):
        raise RuntimeError(f"TP=1 and TP={world} ran different forwards")
    err = max(((a - b).abs().max() / a.abs().max()).item()
              for a, b in zip(logits[1], logits[world]))
    if err > TP_LOGITS_RTOL:
        raise RuntimeError(f"TP={world} logits {err:.3e} from TP=1's "
                           f"(limit {TP_LOGITS_RTOL})")
    compared = 0
    for prompt, seq in zip(prompts, outs[world]):
        with torch.no_grad():
            ref = model(torch.as_tensor(seq, device=model.device)
                        .long()[None])[0]
        for i in range(16):
            row = ref[len(prompt) - 1 + i]
            top2 = torch.topk(row, 2).values
            if (top2[0] - top2[1]).item() < TIE_GAP:
                break
            if int(seq[len(prompt) + i]) != int(row.argmax()):
                raise RuntimeError(f"TP={world} token {i} differs from the "
                                   f"no-cache reference's argmax")
            compared += 1
    return {"logits_rel_err": err, "compared": compared,
            "equal_to_tp1": all(np.array_equal(a, b)
                                for a, b in zip(outs[1], outs[world]))}


def tensor_parallel(card_line: str, baseline, world: int = TP_DEGREE,
                    backend: str = TP_BACKEND) -> dict:
    """Phase 5f: spawn ``world`` ranks over ``backend`` (``tp_rank``): by
    default TP_DEGREE ranks sharing the one card over gloo; with NCCL a
    card a rank. A rank that fails or outlasts TP_JOIN_TIMEOUT_S fails
    the phase. The ranks' tokens must be equal and every forward must
    issue 2L + 1 all-reduces (2L + 2 with quantized logits); the share of
    tokens equal to phase 5's is reported."""
    where = ("a card a rank" if backend == "nccl"
             else f"all {world} ranks on cuda:0")
    rdv = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        t0 = time.perf_counter()
        ranks = ptd.spawn(tp_rank, world,
                          args=(f"file://{rdv}/rendezvous", backend),
                          timeout_s=TP_JOIN_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
    layers = gpt_config(PRESET).num_layers
    for name, leg in ranks[0]["legs"].items():
        for other in ranks[1:]:
            if any(not np.array_equal(a, b) for a, b in
                   zip(other["legs"][name]["outputs"], leg["outputs"])):
                raise RuntimeError(f"phase 5f {name}: the ranks' tokens "
                                   f"differ")
        want = 2 * layers + 1 + (name == "quantized logits")
        for r in ranks:
            if r["legs"][name]["per_forward"] != [want]:
                raise RuntimeError(
                    f"phase 5f {name}: all-reduces per forward "
                    f"{r['legs'][name]['per_forward']}, want {want}")
        gen = 64 * len(leg["outputs"])
        same = sum(int((a == b).sum()) for a, b in zip(leg["outputs"],
                                                         baseline))
        leg["equal_share"] = same / gen
        log(f"  TP={world} ({backend}, {where}) {name}: "
            f"{gen} tokens in {leg['wall']:.3f} s = {gen / leg['wall']:.1f} "
            f"tok/s (rank 0); {leg['prefills']} prefills, mean "
            f"{leg['prefill_ms']:.3f} ms; {leg['decode_steps']} decode "
            f"steps, mean {leg['decode_ms']:.3f} ms; all-reduces per "
            f"forward {want} on every rank; {leg['pool_heads']} heads in a "
            f"rank's pool; launches a rank {leg['launches']}; prefix-hit "
            f"tokens {leg['prefix_hit_tokens']}; tokens equal to phase 5's "
            f"{same}/{gen} = {same / gen:.4f} [{card_line}]")
    for name, leg in ranks[0]["legs"].items():
        a = leg["audits"]
        if any(r["legs"][name]["audits"]["programs"] != a["programs"]
               for r in ranks[1:]):
            raise RuntimeError(f"phase 5f {name}: the ranks' collective "
                               f"census differs")
        log(f"  TP={world} {name} under debug checks: every audited "
            f"program's census equals its step budget ({len(a['programs'])} "
            f"programs, decode {a['programs'].get('decode')} all-reduces "
            f"and bytes) on every rank; {a['ici_bytes_per_token']:.1f} "
            f"NVLink bytes a token, {a['dcn_bytes_per_token']:.1f} across "
            f"hosts; predicted collective time of the worst program "
            f"{1e3 * a['predicted_s']:.4f} ms; host syncs "
            f"{a['host_syncs']}")
    ar = ranks[0]["all_reduce_ms"]
    dec = ranks[0]["legs"]["bf16"]["decode_ms"]
    pred = ranks[0]["legs"]["bf16"]["audits"]["predicted_s"]
    log(f"  {backend} all_reduce of a bf16 CUDA tensor, {world} ranks "
        f"({where}): 32 KiB {ar['32KiB']:.3f} ms, 2 MiB {ar['2MiB']:.3f} "
        f"ms; {2 * layers + 1} x 32 KiB = "
        f"{(2 * layers + 1) * ar['32KiB']:.1f} ms of the bf16 leg's "
        f"{dec:.1f} ms decode step; the link model's predicted "
        f"serving_collective_time_predicted_s (NVLink, the worst program) "
        f"{1e3 * pred:.4f} ms [{card_line}]")
    fp = ranks[0]["fp32"]
    log(f"  TP={world} float32 check ({TP_CHECK_LAYERS} layers, TF32 "
        f"off): logits within {fp['logits_rel_err']:.3e} of TP=1's "
        f"(relative to the largest; limit {TP_LOGITS_RTOL}); "
        f"{fp['compared']} of 32 tokens equal the no-cache reference's "
        f"argmax; tokens equal to TP=1's: {fp['equal_to_tp1']}; spawn to "
        f"join {spawn_s:.1f} s")
    return ranks[0]


# --------------------------------------------------------------- phase 5d
# the Prometheus exposition sample grammar (tests/test_obs_journey.py's
# scrape test): every sample line matches, label keys sorted
PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r' -?[0-9.e+Inf]+$')


def scrape(text: str) -> dict:
    """Parse an exposition strictly: {name: type}; raises on a line off
    the grammar, unsorted labels or a name typed twice."""
    typed = {}
    for ln in text.splitlines():
        if ln.startswith("# TYPE"):
            _, _, name, typ = ln.split()
            if name in typed:
                raise RuntimeError(f"exposition types {name} twice")
            typed[name] = typ
        elif ln:
            keys = re.findall(r'[{,]([a-zA-Z_][a-zA-Z0-9_]*)="', ln)
            if not PROM_SAMPLE.match(ln) or keys != sorted(keys):
                raise RuntimeError(f"exposition line off the grammar: {ln!r}")
    return typed


def obs_readings(engine) -> dict:
    """What phase 5d reads off a traced engine: TTFT, TPOT and queue-wait
    p50/p99 (``ServingMetrics``) and each phase's share of step time
    (``serving_step_phase_s{phase=}``)."""
    snap = engine.metrics.snapshot()
    lat = {f"{h}_{q}": snap[f"serving_{h}_{q}"]
           for h in ("ttft_s", "tpot_s", "queue_wait_s")
           for q in ("p50", "p99")}
    sums = {p: h.sum for p, h in engine.metrics.phase_hist.children().items()}
    total = sum(sums.values())
    return {"latency": lat,
            "phase_share": {p: sums[p] / total for p in PHASES}}


def interleaved_step_ms(model) -> dict:
    """Phase 5's requests through two engines, tracing on and off, one
    step of each in turn: {tracing: mean ms of its steps}."""
    engines = {}
    for tracing in (True, False):
        engines[tracing] = ServingEngine(model, ServingConfig(
            max_batch=8, num_pages=1 + 8 * 64, page_size=16,
            max_prompt_len=512, enable_tracing=tracing))
        for p in serve_requests(model.cfg.vocab_size):
            engines[tracing].add_request(p, 64)
    spent = {True: [], False: []}
    while not all(e.scheduler.all_done for e in engines.values()):
        for tracing, engine in engines.items():
            if not engine.scheduler.all_done:
                t0 = time.perf_counter()
                engine.step()
                spent[tracing].append(time.perf_counter() - t0)
    return {t: 1e3 * sum(v) / len(v) for t, v in spent.items()}


def observe(model, card_line: str, baseline) -> None:
    """Phase 5d: phase 5's requests with the observability layer on (the
    default) and off, in turns (on, off, off, on): equal launches; then two
    tenants with their SLOs, goodput + badput = tokens; then chunks of 128
    under an SLO whose TPOT target is half the traced TPOT p99, which must
    throttle; then a flight record and a Chrome trace written, validated
    and read back through the CLI, and the exposition parsed."""
    legs = []
    for i, tracing in enumerate((True, False, False, True)):
        name = f"5d tracing {'on' if tracing else 'off'} ({i + 1} of 4)"
        legs.append((tracing, serve(
            model, card_line, baseline=baseline, label=name,
            enable_tracing=tracing,
            inspect=obs_readings if tracing else None)))
    ref = legs[0][1]["launches"]
    for tracing, leg in legs[1:]:
        if leg["launches"] != ref:
            raise RuntimeError(f"tracing {tracing} launched {leg['launches']}"
                               f", tracing on {ref}")
    lat, share = legs[-1][1]["latency"], legs[-1][1]["phase_share"]
    log(f"  tracing on/off/off/on tok/s "
        f"{[round(leg['tok_s'], 1) for _, leg in legs]}, decode-step ms "
        f"{[round(leg['decode_ms'], 3) for _, leg in legs]}; launches "
        f"equal in all four; latency (s, last on leg) "
        f"{ {k: round(v, 5) for k, v in lat.items()} }; phase share of step "
        f"time { {p: round(v, 4) for p, v in share.items()} } [{card_line}]")
    if not lat["tpot_s_p99"] > 0:
        raise RuntimeError("no TPOT observed with tracing on")
    # the legs' spread comes from the host's drift between them; the two
    # engines stepped alternately see the same host, step for step
    host_ms = interleaved_step_ms(model)
    log(f"  tracing on and off stepped alternately, host ms a step "
        f"(engine.step() wall, which ends in the step's device read): on "
        f"{host_ms[True]:.3f}, off {host_ms[False]:.3f}, difference "
        f"{host_ms[True] - host_ms[False]:.3f} [{card_line}]")

    tenants = {"interactive": TenantSLO(2 * lat["ttft_s_p99"],
                                        2 * lat["tpot_s_p99"]),
               "batch": TenantSLO(20 * lat["ttft_s_p99"],
                                  20 * lat["tpot_s_p99"])}
    tmp = tempfile.TemporaryDirectory()
    paths = {"record": f"{tmp.name}/flight.json",
             "trace": f"{tmp.name}/trace.json"}

    def dump(engine):
        rep = engine.tenant_report()
        snap = engine.metrics.snapshot()
        good = sum(e["goodput_tokens"] for e in rep.values())
        bad = sum(e["badput_tokens"] for e in rep.values())
        if good + bad != snap["serving_tokens_total"]:
            raise RuntimeError(f"goodput {good} + badput {bad} != tokens "
                               f"{snap['serving_tokens_total']}")
        if engine.alerts():
            raise RuntimeError(f"a clean run fired {engine.alerts()}")
        engine.dump_flight_record(paths["record"])
        engine.export_chrome_trace(paths["trace"])
        return {"tenants": rep, "good": good, "bad": bad,
                "prometheus": engine.metrics.prometheus()}

    ten = serve(model, card_line, baseline=baseline, label="5d tenants",
                tenants=tenants, inspect=dump)
    with open(paths["record"]) as fh:
        record = validate_flight_record(json.load(fh))
    with open(paths["trace"]) as fh:
        events = json.load(fh)["traceEvents"]
    cli = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.obs", "--flight-record",
         paths["record"], "--tenant-table"], capture_output=True, text=True,
        timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    tmp.cleanup()
    if cli.returncode != 0:
        raise RuntimeError(f"obs CLI exit {cli.returncode}: {cli.stdout}"
                           f"{cli.stderr}")
    typed = scrape(ten["prometheus"])
    if typed.get("serving_step_phase_s") != "histogram" or \
            typed.get("serving_tenant_retired_total") != "counter":
        raise RuntimeError("exposition lacks the phase or tenant families")
    log(f"  tenants: goodput {ten['good']} + badput {ten['bad']} = "
        f"serving_tokens_total; per tenant "
        f"{ {t: (e['goodput_tokens'], e['badput_tokens']) for t, e in ten['tenants'].items()} }; "
        f"flight record valid ({len(record['steps'])} steps, "
        f"{len(record['journeys'])} journeys), Chrome trace "
        f"{len(events)} events, CLI --tenant-table exit 0:\n"
        + cli.stdout.rstrip()
        + f"\n  exposition {len(ten['prometheus'].splitlines())} lines, "
        f"{len(typed)} families, all on the grammar")

    target = lat["tpot_s_p99"] / 2
    slo = serve_leg(model, card_line, "5d slo", serve_requests(
        model.cfg.vocab_size), chunk_size=128,
        slo=SLOConfig(tpot_p99_s=target))
    if not slo["throttles"] or min(v for _, v in slo["chunk_limits"]) >= 8:
        raise RuntimeError(f"the SLO leg never throttled: "
                           f"{slo['chunk_limits']}")
    log(f"  slo: tpot_p99_s target {target:.5f} (half the traced p99); "
        f"chunk_limit (step, limit) at each change {slo['chunk_limits']}; "
        f"slo_throttles_total {slo['throttles']}; "
        f"{64 * 16 / slo['wall']:.1f} tok/s [{card_line}]")


# ---------------------------------------------------------------- phase 6
def profile_decode(model, kv_dtype: str = "float32") -> dict:
    """Device time by kernel over 8 steady decode steps of a full batch
    with ``kv_dtype`` pools, the device's busy share of those steps' wall
    time (measured once without and once under the profiler), and the
    host's kernel launches a step; returns the step's ms unprofiled, its
    device ms, the LayerNorm forward's device ms and the ten largest
    kernels' names."""
    engine = ServingEngine(model, ServingConfig(
        max_batch=8, num_pages=1 + 8 * 64, page_size=16, max_prompt_len=512,
        kv_dtype=kv_dtype))
    rng = np.random.default_rng(SEED + 3)
    for _ in range(8):
        engine.add_request(rng.integers(0, model.cfg.vocab_size, 256), 40)
    for _ in range(3):  # admit + prefill all, then settle
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        engine.step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / 8
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            engine.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / 8
    events = prof.key_averages()
    # device-side events only: an aten op's row repeats its kernels' time
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cuLaunchKernelEx")) // 8
    busy_ms = sum(r[0] for r in rows) / 1e3 / 8
    if not busy_ms:
        log("  profile: the profiler recorded no device time (not measured)")
        return {"plain_ms": plain_ms}
    log(f"  profile: decode step of batch 8 (256-token prompts), {kv_dtype} "
        f"pools: {plain_ms:.3f} ms wall unprofiled, {prof_ms:.3f} ms "
        f"profiled; device busy {busy_ms:.3f} ms a step = "
        f"{100 * busy_ms / plain_ms:.1f}% of the unprofiled step "
        f"(idle {100 - 100 * busy_ms / plain_ms:.1f}%); {launches} kernel "
        f"launches from the host a step")
    for dev_us, key, count in rows[:10]:
        log(f"    {100 * dev_us / 1e3 / 8 / busy_ms:5.1f}%  "
            f"{dev_us / 1e3 / 8:7.3f} ms/step  x{count // 8:<4d} {key[:80]}")
    ln_fwd = sum(r[0] for r in rows
                 if kernel_layer(r[1]) == "LayerNorm forward (kernel)")
    return {"plain_ms": plain_ms, "busy_ms": busy_ms,
            "launches_per_step": launches, "ln_fwd_ms": ln_fwd / 1e3 / 8,
            "kernels": [r[1] for r in rows[:10]]}


# ---------------------------------------------------------------- phase 7
# training fp32 check: GPU step vs the CPU copy (plain versions). float32
# summation orders differ, so gradients are held relative to each
# tensor's largest entry. An Adam step moves a weight by up to about
# lr = 1e-4 whatever its gradient's size, in the gradient's direction
# over sqrt(v) + eps: where a gradient is within a few eps (1e-8) of
# zero, the summation order can flip that move, so a parameter may be
# off by up to 2 lr after two steps; but only a small share of entries
# may be off by more than PARAM_NEAR (2.4e-5 of them measured on an H100),
# which a fault that shifts every update would exceed
TRAIN_CHECK_TOL = dict(loss=1e-4, grad_rel=1e-3, param=2e-4,
                       param_off_share=1e-4)
PARAM_NEAR = 1e-6


def recipe(warmup: int = RECIPE_WARMUP) -> dict:
    """The pretraining recipe's options for ``build_train_step``: dropout
    0.1, ``ClipGradByGlobalNorm(1.0)`` and a linear warm-up from 0 over
    ``warmup`` steps to 1.5e-4, then cosine decay (a new scheduler each
    call: the step advances it)."""
    return dict(dropout=RECIPE_DROPOUT,
                grad_clip=ClipGradByGlobalNorm(RECIPE_CLIP),
                learning_rate=LinearWarmup(
                    CosineAnnealingDecay(RECIPE_LR, RECIPE_T_MAX), warmup,
                    0.0, RECIPE_LR))


def train_fp32_check() -> None:
    """The card's step against a CPU copy (plain versions), both under
    the recipe (dropout 0.1 with the same keys, the clip, the schedule)
    and the ``dots`` remat policy."""
    rung = dict(TRAIN_RUNG, layers=2, batch=2, seq=256, policy="dots")
    gpu = build_train_step(rung, dtype=torch.float32, **recipe(1))
    cpu = build_train_step(rung, device="cpu", dtype=torch.float32,
                           **recipe(1))
    cpu["model"].load_state_dict(
        {k: t.cpu() for k, t in gpu["model"].state_dict().items()})
    rng = np.random.default_rng(SEED + 4)
    vocab, shape = gpu["cfg"].vocab_size, (2, rung["batch"], rung["seq"])
    ids_all = torch.from_numpy(rng.integers(0, vocab, shape))
    labels_all = torch.from_numpy(rng.integers(0, vocab, shape))
    worst = dict(loss=0.0, grad_rel=0.0, param=0.0)
    for step in range(2):
        losses = []
        for built, dev in ((gpu, "cuda"), (cpu, "cpu")):
            with trace_rng_scope(KEY):
                loss = built["model"](ids_all[step].to(dev),
                                      labels=labels_all[step].to(dev))
            loss.backward()
            losses.append(loss.item())
        worst["loss"] = max(worst["loss"], abs(losses[0] - losses[1]))
        log(f"  train fp32 step {step + 1}: loss card {losses[0]:.6f}, cpu "
            f"{losses[1]:.6f}")
        if step == 0:
            cpu_params = dict(cpu["model"].named_parameters())
            for name, p in gpu["model"].named_parameters():
                want = cpu_params[name].grad
                rel = ((p.grad.cpu() - want).abs().max()
                       / want.abs().max().clamp(min=1e-30)).item()
                worst["grad_rel"] = max(worst["grad_rel"], rel)
        for built in (gpu, cpu):
            built["opt"].step()
            built["opt"]._lr_scheduler.step()
            built["opt"].zero_grad()
    cpu_params = dict(cpu["model"].named_parameters())
    off, total = 0, 0
    for name, p in gpu["model"].named_parameters():
        diff = (p.detach().cpu() - cpu_params[name].detach()).abs()
        worst["param"] = max(worst["param"], diff.max().item())
        off += int((diff > PARAM_NEAR).sum())
        total += diff.numel()
    worst["param_off_share"] = off / total
    log(f"  train fp32 check ({rung['layers']} layers, batch {rung['batch']},"
        f" seq {rung['seq']}, hidden {rung['hidden']}, vocab {vocab}; dots "
        f"remat, dropout {RECIPE_DROPOUT}, clip {RECIPE_CLIP}, warm-up 1 "
        f"then cosine): loss "
        f"diff {worst['loss']:.3e} (tol {TRAIN_CHECK_TOL['loss']}), step-1 "
        f"gradients max diff / max |grad| {worst['grad_rel']:.3e} (tol "
        f"{TRAIN_CHECK_TOL['grad_rel']}), parameters after step 2 max diff "
        f"{worst['param']:.3e} (tol {TRAIN_CHECK_TOL['param']}); {off} of "
        f"{total} entries off by more than {PARAM_NEAR}: share "
        f"{worst['param_off_share']:.3e} (tol "
        f"{TRAIN_CHECK_TOL['param_off_share']})")
    bad = [k for k, v in worst.items() if not v <= TRAIN_CHECK_TOL[k]]
    if bad:
        raise RuntimeError(f"training on the card disagrees with the CPU "
                           f"plain path: {bad}")


class ProgramTally:
    """Records the query count ``s`` of every ragged kernel call made while
    it is entered (through the module's ``choose_program``, which the
    wrapper calls once per launch), so a serving run's per-program launch
    counts can be checked against the shapes it served: every decode step
    (s = 1) on the split program, every bf16 prefill bucket at or above
    ``MMA_MIN_QUERIES`` on the tensor cores."""

    def __enter__(self):
        self.calls = []
        self._choose = rpa.choose_program

        def record(s, d, dtype):
            program = self._choose(s, d, dtype)
            self.calls.append((s, program))
            return program

        rpa.choose_program = record
        return self

    def __exit__(self, *exc):
        rpa.choose_program = self._choose

    def expected(self, layers: int, decode_steps: int, bf16: bool,
                 step_s: int = 1) -> dict:
        """The program launch counts the calls' shapes must give: every
        call of ``step_s`` queries (1: decode; K + 1: a speculative verify)
        is a decode or verify step's, all on the split program, and a bf16
        call of at least MMA_MIN_QUERIES queries on the tensor cores."""
        steps = [p for s, p in self.calls if s == step_s]
        if len(steps) != layers * decode_steps:
            raise RuntimeError(f"{len(steps)} ragged calls of {step_s} "
                               f"queries for {decode_steps} decode or "
                               f"verify steps of {layers} layers")
        if any(p != "split" for p in steps):
            raise RuntimeError(f"a step of {step_s} queries ran off the "
                               f"split program: {set(steps)}")
        want = {"ragged_split": sum(s <= rpa.SPLIT_MAX_QUERIES
                                    for s, _ in self.calls),
                "ragged_mma": sum(bf16 and s >= rpa.MMA_MIN_QUERIES
                                  for s, _ in self.calls)}
        want["ragged_warp"] = len(self.calls) - sum(want.values())
        return want

    def buckets(self) -> dict:
        """Calls per (query count, program)."""
        out = {}
        for s, program in self.calls:
            out[f"{s}:{program}"] = out.get(f"{s}:{program}", 0) + 1
        return out


# ---------------------------------------------------------------- phase 8
def reset_counters() -> None:
    rpa.launches = rpa.int8_launches = rpa.reference_calls = 0
    rpa.split_launches = rpa.mma_launches = rpa.warp_launches = 0
    fa.fwd_launches = fa.bwd_launches = fa.reference_calls = 0
    fo.launches = fo.tensors = fo.reference_calls = 0
    fl.fwd_launches = fl.dx_launches = fl.reduce_launches = 0
    fl.reference_calls = 0
    kd.fwd_launches = kd.bwd_launches = kd.reference_calls = 0
    gn.launches = gn.reference_calls = 0


def launch_counts() -> dict:
    """Every kernel's launch counter and every plain version's call
    counter, as they stand."""
    return {"ragged": rpa.launches, "ragged_int8": rpa.int8_launches,
            "ragged_split": rpa.split_launches,
            "ragged_mma": rpa.mma_launches,
            "ragged_warp": rpa.warp_launches,
            "flash_fwd": fa.fwd_launches, "flash_bwd": fa.bwd_launches,
            "adam": fo.launches, "adam_tensors": fo.tensors,
            "ln_fwd": fl.fwd_launches,
            "ln_dx": fl.dx_launches, "ln_reduce": fl.reduce_launches,
            "dropout_fwd": kd.fwd_launches,
            "dropout_bwd": kd.bwd_launches, "global_norm": gn.launches,
            "plain_ragged": rpa.reference_calls,
            "plain_flash": fa.reference_calls,
            "plain_adam": fo.reference_calls,
            "plain_ln": fl.reference_calls,
            "plain_dropout": kd.reference_calls,
            "plain_global_norm": gn.reference_calls}


def check_launches(counts: dict, want: dict, path: str) -> None:
    """``counts`` must hold ``want`` for the named kernels and 0 for every
    other kernel and every plain version."""
    expect = {k: want.get(k, 0) for k in counts}
    if counts != expect:
        bad = {k: (counts[k], expect[k]) for k in counts
               if counts[k] != expect[k]}
        raise RuntimeError(f"launches on {path} (counted, expected): {bad}")


def expected_train_launches(built, steps: int) -> dict:
    """Every kernel's launches in ``steps`` training steps of ``built``, as
    the code gives them. A step of L layers runs the LayerNorm forward 2L
    + 1 times and its backward kernel and reduction as often, the flash
    forward and backward L times
    each, the optimizer's plan once. Dropout (p > 0) draws at 1 + 3L sites
    (the embeddings; each block's attention output, attention residual and
    MLP output), a forward launch each and a backward launch each. Remat
    (full or ``dots``) runs each block's forward again in the backward up
    to its last saved tensor (fc2's input; torch's checkpoint stops there:
    dropout keeps its bits on the autograd context, outside the
    checkpoint's hooks), so the flash forward once more, both LayerNorm
    forwards and the first two dropouts of the block: L, 2L and 2L more.
    A global-norm clip adds
    the norm plan's launches and the reduction."""
    cfg = built["cfg"]
    layers, remat = cfg.num_layers, cfg.recompute
    params = list(built["model"].parameters())
    sizes = [p.numel() for p in params]
    adam_plan = fo.adam_launch_plan(
        sizes, [torch.bfloat16 if p.dtype == torch.bfloat16 else
                torch.float32 for p in params], fo.kernel_param_bytes())
    want = {"flash_fwd": layers * (2 if remat else 1), "flash_bwd": layers,
            "adam": len(adam_plan), "adam_tensors": len(params),
            "ln_fwd": 2 * layers + 1 + (2 * layers if remat else 0),
            "ln_dx": 2 * layers + 1, "ln_reduce": 2 * layers + 1}
    if cfg.dropout > 0:
        sites = 1 + 3 * layers
        want["dropout_fwd"] = sites + (2 * layers if remat else 0)
        want["dropout_bwd"] = sites
    if isinstance(built["opt"]._grad_clip, ClipGradByGlobalNorm):
        want["global_norm"] = len(gn.norm_launch_plan(
            sizes, gn.kernel_param_bytes())) + 1
    return {k: v * steps for k, v in want.items()}


def train(card_line: str, rung: dict = TRAIN_RUNG, steps: int = TRAIN_STEPS,
          options: dict | None = None, keep: bool = True) -> dict:
    """``rung`` at full width through ``build_train_step`` (with the
    ``options`` of :func:`recipe`, or bench.py's defaults): TRAIN_WARMUP
    steps, then ``steps`` timed steps on one seeded batch, the counters
    set to 0 just before them and read just after, and held to
    :func:`expected_train_launches`. The loss must be finite and lower at
    the last step than at the first. Returns the launches, ms/step,
    tokens/s, MFU and peak memory (and, with ``keep``, the model and the
    batch)."""
    gc.collect()  # an earlier phase's graphs must not count in the peak
    torch.cuda.empty_cache()
    built = build_train_step(rung, **(options or {}))
    cfg, step_fn = built["cfg"], built["train_step"]
    b, s = rung["batch"], rung.get("seq", 1024)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    losses = [step_fn(ids, labels) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()          # every kernel's count, just before the path
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step_fn(ids, labels))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).tolist()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training losses {losses} of {rung['tag']}: not "
                           f"finite, or the last is not below the first")
    check_launches(launches, expected_train_launches(built, steps),
                   f"{steps} training steps of {rung['tag']}")
    ms = wall * 1e3 / steps
    tok_s = b * s / (wall / steps)
    fpt = flops_per_token(cfg, built["n_params"], s)
    mfu = tok_s * fpt / PEAK_FLOPS[torch.bfloat16]
    per_step = {k: v // steps for k, v in launches.items() if v}
    opts = (f"dropout {cfg.dropout}, clip {RECIPE_CLIP}, warm-up "
            f"{RECIPE_WARMUP} then cosine from {RECIPE_LR}" if options
            else "bench.py's options")
    log(f"  train {rung['tag']} ({built['n_params']} parameters, bf16 + "
        f"fp32 masters, batch {b}, seq {s}, loss_chunk "
        f"{cfg.loss_chunk_size}, remat {rung['policy'] or 'full'}, {opts}):"
        f" {steps} steps in {wall:.3f} s = {ms:.3f} ms/step, {tok_s:.1f} "
        f"tokens/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s ({fpt / 1e9:.3f} "
        f"GFLOP/token); peak memory {peak / 2**30:.3f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches per step "
        f"{json.dumps(per_step)}; plain calls 0 [{card_line}]")
    out = {"launches": launches, "ms": ms, "tok_s": tok_s, "mfu": mfu,
           "peak_gib": peak / 2**30, "losses": losses, "tag": rung["tag"]}
    if keep:
        out.update(built=built, ids=ids, labels=labels)
    else:  # profile the step of the recipe's first rung, then let go
        if rung is RECIPE_RUNGS[0]:
            profile_step(built, ids, labels, rung["tag"])
        del built
        torch.cuda.empty_cache()
    return out


def train_ladder(card_line: str, off_peak_gib: float) -> dict:
    """Phases 8b and 8c: the recipe on bench.py's remat rungs at full
    width — 350M-b8-dots and 350M-b8-full for TRAIN_STEPS steps each (the
    dots step profiled by layer), then 350M-b4-full and 125M-b8-full for
    OTHER_STEPS; peak memory must order full < dots < off (phase 8)."""
    phase("8b train the recipe: 350M-b8-dots, 350M-b8-full")
    runs = {r["tag"]: train(card_line, r, TRAIN_STEPS, recipe(), keep=False)
            for r in RECIPE_RUNGS}
    # the same rungs with bench.py's options (no dropout, no clip, lr
    # 1e-4): what remat costs apart from the recipe's kernels
    for r in RECIPE_RUNGS:
        runs[r["tag"] + " bench"] = train(card_line, r, TRAIN_STEPS,
                                          keep=False)
    peaks = [runs["350M-b8-full"]["peak_gib"],
             runs["350M-b8-dots"]["peak_gib"], off_peak_gib]
    log(f"  peak memory full {peaks[0]:.3f} GiB < dots {peaks[1]:.3f} GiB < "
        f"off {peaks[2]:.3f} GiB (phase 8)")
    if not peaks[0] < peaks[1] < peaks[2]:
        raise RuntimeError(f"peak memory does not order full < dots < off: "
                           f"{peaks}")
    phase("8c train the recipe: 350M-b4-full, 125M-b8-full")
    for r in OTHER_RUNGS:
        runs[r["tag"]] = train(card_line, r, OTHER_STEPS, recipe(),
                               keep=False)
    return runs


# --------------------------------------------------------------- phase 10
def surface_step(paddle, model, opt, sched, data):
    """One step of ``examples/train_gpt.py``'s loop on ``data`` (a numpy
    ``[b, s + 1]`` batch): returns the loss as the workflow reads it."""
    ids = paddle.to_tensor(data[:, :-1])
    labels = paddle.to_tensor(data[:, 1:])
    loss = model(ids, labels=labels)
    if not isinstance(loss, paddle.Tensor):
        raise RuntimeError(f"the loss came back as {type(loss).__name__}, "
                           f"not the port's Tensor")
    loss.backward()
    opt.step()
    sched.step()
    opt.clear_grad()
    return float(loss.numpy())


def plain_step(model, opt, sched, ids, labels) -> None:
    """The same step on plain torch tensors (what train.py passes)."""
    model(ids, labels=labels).backward()
    opt.step()
    sched.step()
    opt.clear_grad()


def time_flash_fp32(gen, b, h, s, d) -> dict:
    """The float32 flash kernels at phase 10's shape (causal), beside the
    plain version and ``scaled_dot_product_attention`` (by default, and
    under the memory-efficient backend, the one that takes float32 on the
    tensor cores), on the device alone (``time_ms``), against the 3xTF32
    bound and the CUDA cores' float32 one; the library's backend named as
    PyTorch's dispatch chooses it (``torch._fused_sdp_choice``).
    Then two runs of each kernel on the same inputs: o, lse, dk and dv
    equal bit for bit, dq within DQ_RUN_FP32_RTOL / ATOL (raises)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    q, k, v, do = flash_inputs(gen, b, h, s, s, d, torch.float32)
    o, lse = fa.flash_attention_forward(q, k, v, causal=True)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    # the backend the default call dispatches to, as PyTorch chooses it
    names = {int(v): n for n, v in SDPBackend.__members__.items()}
    backend = names[int(torch._fused_sdp_choice(xs[0], xs[1], xs[2], None,
                                                0.0, True))]
    out_plain = fa.flash_attention_reference(*xs, causal=True)
    out_lib = F.scaled_dot_product_attention(*xs, is_causal=True)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out_eff = F.scaled_dot_product_attention(*xs, is_causal=True)

    def plain_fwd():
        with torch.no_grad():
            fa.flash_attention_reference(q, k, v, causal=True)

    def eff_fwd():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            F.scaled_dot_product_attention(q, k, v, is_causal=True)

    cases = {
        "fwd": (lambda: fa.flash_attention_forward(q, k, v, causal=True),
                plain_fwd,
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
                eff_fwd),
        "bwd": (lambda: fa.flash_attention_backward(q, k, v, o, lse, do,
                                                    causal=True),
                lambda: torch.autograd.grad(out_plain, xs, do,
                                            retain_graph=True),
                lambda: torch.autograd.grad(out_lib, xs, do,
                                            retain_graph=True),
                lambda: torch.autograd.grad(out_eff, xs, do,
                                            retain_graph=True)),
    }
    shape = f"[{b}, {h}, {s}, {d}] fp32 causal"
    out = {}
    for name, (kernel, plain, lib, eff) in cases.items():
        t_kernel = time_ms(kernel, flush)
        t_plain = time_ms(plain, flush, iters=5)
        t_lib = time_ms(lib, flush)
        t_eff = time_ms(eff, flush)
        b_ms, b_by = flash_bound(b, h, s, s, d, 4, True, name == "bwd")
        cc_ms, _ = flash_bound(b, h, s, s, d, 4, True, name == "bwd",
                               peak=PEAK_FLOPS[torch.float32])
        out[name] = {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
                     "bound_by": b_by, "bound_ms_cuda_cores": cc_ms,
                     "library_ms": t_lib, "library_efficient_ms": t_eff,
                     "library_backend": backend, "shape": shape}
        log(f"  time flash {name} fp32: kernel {t_kernel:.4f} ms, plain "
            f"{t_plain:.4f} ms, library (scaled_dot_product_attention) "
            f"{t_lib:.4f} ms, its memory-efficient backend {t_eff:.4f} ms; "
            f"bound {b_ms:.4f} ms ({b_by}; 3xTF32 at "
            f"{PEAK_TF32X3 / 1e12:.0f} TFLOP/s), {cc_ms:.4f} ms at the CUDA "
            f"cores' {PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s "
            f"[{shape}]; the library's backend {backend}")
    (o1, lse1), (o2, lse2) = (fa.flash_attention_forward(q, k, v, causal=True)
                              for _ in range(2))
    (dq1, dk1, dv1), (dq2, dk2, dv2) = (fa.flash_attention_backward(
        q, k, v, o, lse, do, causal=True) for _ in range(2))
    fwd_equal = torch.equal(o1, o2) and torch.equal(lse1, lse2)
    kv_equal = torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    diff = (dq1 - dq2).abs()
    limit = DQ_RUN_FP32_RTOL * torch.maximum(dq1.abs(), dq2.abs())
    outside = int((diff > limit + DQ_RUN_FP32_ATOL).sum())
    out["run_to_run"] = {"fwd_equal": fwd_equal, "dk_dv_equal": kv_equal,
                         "dq_max_abs_diff": diff.max().item(),
                         "dq_elements_differing": int((dq1 != dq2).sum()),
                         "dq_elements_outside": outside,
                         "rtol": DQ_RUN_FP32_RTOL, "atol": DQ_RUN_FP32_ATOL}
    log(f"  flash fp32 run to run [{shape}]: o and lse equal: {fwd_equal}; "
        f"dk, dv equal: {kv_equal}; dq max abs diff "
        f"{diff.max().item():.3e}, {out['run_to_run']['dq_elements_differing']}"
        f" of {dq1.numel()} elements differ, {outside} outside rtol "
        f"{DQ_RUN_FP32_RTOL} + atol {DQ_RUN_FP32_ATOL}")
    if not fwd_equal or not kv_equal or outside:
        raise RuntimeError("flash float32: two runs on the same inputs "
                           "disagree beyond the stated tolerance")
    return out


def surface_train(card_line: str, gen, phase8_ms: float) -> dict:
    """Phase 10: ``examples/train_gpt.py``'s workflow through the port's
    Paddle surface at gpt3-350m's full width (batch 8, seq 1024, float32,
    no dropout, no remat): ``seed``, ``set_device("gpu")``, ``to_tensor``
    of a seeded numpy batch, the model's loss with ``labels=``,
    ``backward``, ``AdamW(learning_rate=CosineAnnealingDecay,
    parameters=model.parameters())``, ``step`` / ``sched.step`` /
    ``clear_grad``, ``float(loss.numpy())`` for SURFACE_STEPS steps, the
    counters set to 0 just before and read just after and held to
    ``expected_train_launches``; the loss finite and falling. Then the
    same step on plain tensors and through the surface in turns (the
    subclass's host cost), the float32 flash kernels timed at this shape,
    and ``save`` / ``load`` / ``set_state_dict`` into a fresh model whose
    logits must equal the saved model's bit for bit."""
    import paddle_tpu_torch as paddle

    gc.collect()
    torch.cuda.empty_cache()
    b, s = TRAIN_RUNG["batch"], 1024
    cfg = gpt_config("gpt3-350m", dropout=0.0)
    paddle.seed(SEED)
    paddle.set_device("gpu")
    model = GPTForCausalLM(cfg).train()
    sched = paddle.optimizer.lr.CosineAnnealingDecay(3e-4, T_max=20)
    opt = paddle.optimizer.AdamW(learning_rate=sched,
                                 parameters=model.parameters(),
                                 weight_decay=0.01)
    data = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (b, s + 1)).astype("int64")
    built = {"cfg": cfg, "model": model, "opt": opt}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()          # every kernel's count, just before the path
    losses, step_ms = [], []
    for _ in range(SURFACE_STEPS):
        t0 = time.perf_counter()
        losses.append(surface_step(paddle, model, opt, sched, data))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"surface training losses {losses}: not finite, "
                           f"or the last is not below the first")
    check_launches(launches, expected_train_launches(built, SURFACE_STEPS),
                   f"{SURFACE_STEPS} surface training steps")
    per_step = {k: v // SURFACE_STEPS for k, v in launches.items() if v}
    log(f"  surface workflow (gpt3-350m, float32, batch {b}, seq {s}, "
        f"AdamW + CosineAnnealingDecay, loss_chunk {cfg.loss_chunk_size}): "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; ms a step "
        + ", ".join(f"{t:.1f}" for t in step_ms)
        + f" (each ends in float(loss.numpy()), a sync); peak memory "
        f"{peak / 2**30:.3f} GiB; launches per step {json.dumps(per_step)}; "
        f"plain calls 0 [{card_line}]")
    # the subclass's host cost: the same step, plain tensors then the
    # surface, in turns (each the lower of two turns of TURN_STEPS)
    dev = paddle.resolve_device(None)  # set_device's choice: the card
    ids = torch.as_tensor(data[:, :-1], device=dev)
    labels = torch.as_tensor(data[:, 1:], device=dev)
    turns = {"plain": [], "surface": []}
    for name in ("plain", "surface", "surface", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TURN_STEPS):
            if name == "plain":
                plain_step(model, opt, sched, ids, labels)
            else:
                surface_step(paddle, model, opt, sched, data)
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t0) * 1e3 / TURN_STEPS)
    t_plain, t_surf = min(turns["plain"]), min(turns["surface"])
    log(f"  surface step {t_surf:.3f} ms vs plain-tensor step "
        f"{t_plain:.3f} ms (same model and batch, {TURN_STEPS} steps a "
        f"turn, the lower of two turns; the surface's step ends in "
        f"float(loss.numpy())): host cost of the subclass and the read "
        f"{t_surf - t_plain:.3f} ms; phase 8's bf16 step at this shape "
        f"{phase8_ms:.3f} ms [{card_line}]")
    flash = time_flash_fp32(gen, b, cfg.num_heads, s,
                            cfg.hidden_size // cfg.num_heads)
    # checkpoint round trip through the surface
    model.eval()
    fixed = paddle.to_tensor(data[:2, :-1])
    with paddle.no_grad():
        want = model(fixed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        path = os.path.join(d, "gpt3-350m.pdparams")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paddle.save(model.state_dict(), path)
        t_save = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = paddle.load(path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    paddle.seed(SEED + 1)
    fresh = GPTForCausalLM(cfg).eval()
    missing, unexpected = fresh.set_state_dict(loaded)
    del loaded
    with paddle.no_grad():
        got = fresh(fixed)
    equal = bool(torch.equal(got, want))
    log(f"  save {t_save:.3f} s, {nbytes} bytes ({nbytes / 2**30:.3f} GiB); "
        f"load {t_load:.3f} s; set_state_dict missing {missing}, unexpected "
        f"{unexpected}; reloaded logits {list(got.shape)} bit-equal: "
        f"{equal} [{card_line}]")
    if missing or unexpected or not equal:
        raise RuntimeError("surface checkpoint round trip: the reloaded "
                           "model differs from the saved one")
    del model, fresh, opt, got, want
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "surface_ms": t_surf,
            "plain_ms": t_plain, "peak_gib": peak / 2**30,
            "launches": launches, "flash_fp32": flash, "save_s": t_save,
            "load_s": t_load, "file_bytes": nbytes}


# --------------------------------------------------------------- phase 11
# tools/bert_bench.py's first rung: BERT-base defaults with both dropouts
# 0, bf16 parameters with float32 masters, AdamW at 1e-4, batch 64, seq
# 128, 15% MLM labels (the rest -1) and NSP labels from RandomState(0)
BERT_BATCH, BERT_SEQ, BERT_LR, BERT_MASK_FRAC = 64, 128, 1e-4, 0.15
BERT_BATCHES, BERT_WARMUP, BERT_STEPS = 8, 2, 6
# leg (c): the classifier at the same width under a padding mask
BERT_FT_BATCH, BERT_FT_STEPS = 32, 5
# leg (a): a 2-layer, hidden-128 float32 model, card against CPU copy
BERT_CHECK_CFG = dict(hidden_size=128, num_layers=2, num_heads=2,
                      intermediate_size=512, hidden_dropout=0.0,
                      attn_dropout=0.0)
BERT_CHECK_BATCH, BERT_CHECK_STEPS = 4, 3
# Phase 7's limits: each parameter's step-1 gradient within grad_rel of
# its own largest, and at most param_off_share of the entries off by more
# than PARAM_NEAR after the last step. The key projection's bias is the
# one parameter whose exact gradient is 0 (softmax ignores a shift of
# every score): its gradient is rounding, held against the model's
# largest gradient, and Adam's first step moves it by up to lr either way
# (its entries count among those off).
BERT_CHECK_TOL = dict(loss=1e-4, grad_rel=1e-3, param_off_share=1e-4)


def bert_batches(vocab, n, b, s, seed=0):
    """``n`` batches drawn as ``tools/bert_bench.py`` draws them: ids, MLM
    labels (a ``BERT_MASK_FRAC`` share labelled, the rest -1) and NSP
    labels, int64 on the card."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (n, b, s))
    mlm = np.full((n, b, s), -1, np.int64)
    sel = rng.rand(n, b, s) < BERT_MASK_FRAC
    mlm[sel] = rng.randint(0, vocab, int(sel.sum()))
    nsp = rng.randint(0, 2, (n, b))
    dev = resolve_device(None)  # set_device's choice: the card
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=dev)
                 for a in (ids, mlm, nsp))


def expected_bert_launches(model, opt_params, steps, flash=True) -> dict:
    """A step of a BERT of L layers: the flash forward and backward once a
    layer (none under a mask), the LayerNorm forward and backward (its
    kernel and reduction) 2L + 1 times
    (the embeddings, two a layer) and once more for a pretraining head's
    ``mlm_norm``, fused Adam by ``adam_launch_plan`` over every trainable
    parameter; no dropout (both rates 0) and no plain version."""
    layers = model.bert.cfg.num_layers
    ln = 2 * layers + 1 + (1 if hasattr(model, "mlm_norm") else 0)
    plan = fo.adam_launch_plan(
        [p.numel() for p in opt_params],
        [torch.bfloat16 if p.dtype == torch.bfloat16 else torch.float32
         for p in opt_params], fo.kernel_param_bytes())
    want = {"ln_fwd": ln, "ln_dx": ln, "ln_reduce": ln, "adam": len(plan),
            "adam_tensors": len(opt_params)}
    if flash:
        want.update(flash_fwd=layers, flash_bwd=layers)
    return {k: v * steps for k, v in want.items()}


def card_and_copy(paddle, build, label, dtype):
    """``build()`` on the card from SEED and a CPU copy with its weights
    and buffers, both in ``dtype``. The copy is built under
    ``framework.LazyGuard`` (meta parameters: no initializer draws on the
    host), then each meta parameter takes the card's value on the host
    and every other entry is set through ``set_state_dict``."""
    from paddle_tpu_torch.nn.layer import Parameter

    paddle.set_device("gpu")
    paddle.seed(SEED)
    card = build()
    paddle.set_device("cpu")
    with paddle.LazyGuard():
        host = build()
    paddle.set_device("gpu")
    state = {k: v.detach().to("cpu", copy=True)
             for k, v in card.state_dict().items()}
    own = host.state_dict(keep_vars=True)
    given = set()
    for name, p in list(host.named_parameters()):
        if not p.is_meta or name not in state:
            continue
        new = Parameter.__new__(Parameter, state[name].to(p.dtype),
                                p.requires_grad)
        new.__dict__.update({k: v for k, v in p.__dict__.items()
                             if k != "_lazy_init"})
        for mod in host.modules():
            for key, q in mod._parameters.items():
                if q is p:
                    mod._parameters[key] = new
        given.add(name)
    for name, b in list(host.named_buffers()):
        if b.is_meta and name in state:  # a buffer made as a parameter
            mname, _, key = name.rpartition(".")
            host.get_submodule(mname)._buffers[key] = state[name].to(b.dtype)
            given.add(name)
    host.set_state_dict({k: v for k, v in state.items() if k not in given})
    missing = [k for k in own if k not in state]
    unexpected = [k for k in state if k not in own]
    meta = [n for n, t in list(host.named_parameters()) +
            list(host.named_buffers()) if t.is_meta]
    if missing or unexpected or meta:
        raise RuntimeError(f"{label} CPU copy: missing {missing}, "
                           f"unexpected {unexpected}, still meta {meta}")
    card.to(dtype=dtype)
    host.to(dtype=dtype)
    return card, host


def forward_backward_pair(paddle, models, loss_of, seed=None) -> list:
    """``loss_of(model, device)`` and its backward on the card's model and
    on its CPU copy, each package seeded with ``seed`` just before where
    given (so that dropout draws the same keys on both): for each, the
    loss, the gradients and the buffers, on the CPU."""
    out = []
    for model, where in zip(models, ("gpu", "cpu")):
        paddle.set_device(where)
        if seed is not None:
            paddle.seed(seed)
        loss = loss_of(model, model.parameters()[0].device)
        loss.backward()
        out.append((loss.item(),
                    {n: p.grad.detach().cpu()
                     for n, p in model.named_parameters()
                     if p.grad is not None},
                    {n: b.detach().cpu() for n, b in model.named_buffers()}))
    paddle.set_device("gpu")
    return out


def rel_diff(got: dict, want: dict, zero: float = 0.0) -> tuple:
    """The worst ``|got - want|`` over each entry's own largest ``|want|``,
    and its name. An entry whose largest is below ``zero`` times the
    largest of all (0 but for rounding) is held against that largest
    instead. Entries that differ by name count as infinitely off."""
    if set(got) != set(want):
        return float("inf"), sorted(set(got) ^ set(want))
    if not want:
        return 0.0, None
    top = max((float(w.abs().max()) for w in want.values() if w.numel()),
              default=0.0)
    worst, name = 0.0, None
    for n, w in want.items():
        if not w.numel():
            continue
        own = float(w.abs().max())
        scale = top if own < zero * top else own
        err = float((got[n] - w).abs().max()) / max(scale, 1e-300)
        if err > worst:
            worst, name = err, n
    return worst, name


def bert_fp32_check(paddle, card_line) -> dict:
    """Leg (a): a 2-layer, hidden-128 float32 ``BertForPretraining`` on the
    card and a CPU copy with its weights (``set_state_dict``), three
    AdamW steps each on the same batches, no mask (the flash kernels on
    the card, their plain versions on the CPU)."""
    from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

    cfg = BertConfig(**BERT_CHECK_CFG)
    card, host = card_and_copy(paddle, lambda: BertForPretraining(cfg),
                               "BERT", torch.float32)
    opts = [paddle.optimizer.AdamW(learning_rate=BERT_LR,
                                   parameters=m.parameters())
            for m in (card, host)]
    ids, mlm, nsp = bert_batches(cfg.vocab_size, BERT_CHECK_STEPS,
                                 BERT_CHECK_BATCH, BERT_SEQ, SEED + 5)
    worst = dict(loss=0.0, grad_rel=0.0)
    losses = []
    for step in range(BERT_CHECK_STEPS):
        (l_card, got, _), (l_host, want, _) = forward_backward_pair(
            paddle, (card, host), lambda m, where: m(
                ids[step].to(where), masked_lm_labels=mlm[step].to(where),
                next_sentence_labels=nsp[step].to(where)))
        losses.append([l_card, l_host])
        worst["loss"] = max(worst["loss"], abs(l_card - l_host))
        if step == 0:
            top = max(g.abs().max().item() for g in want.values())
            for n, g in got.items():
                den = top if n.endswith("self_attn.k_proj.bias") \
                    else want[n].abs().max().item()
                rel = (g - want[n]).abs().max().item() / den
                worst["grad_rel"] = max(worst["grad_rel"], rel)
        for opt in opts:
            opt.step()
            opt.clear_grad()
    host_params = dict(host.named_parameters())
    off = total = 0
    param_max = 0.0
    for n, p in card.named_parameters():
        diff = (p.detach().cpu() - host_params[n].detach()).abs()
        param_max = max(param_max, diff.max().item())
        off += int((diff > PARAM_NEAR).sum())
        total += diff.numel()
    worst["param_off_share"] = off / total
    log(f"  BERT fp32 check (2 layers, hidden 128, batch "
        f"{BERT_CHECK_BATCH}, seq {BERT_SEQ}, vocab {cfg.vocab_size}, "
        f"AdamW {BERT_LR}, {BERT_CHECK_STEPS} steps; card vs CPU copy): "
        f"losses {losses}; loss diff {worst['loss']:.3e} (tol "
        f"{BERT_CHECK_TOL['loss']}), step-1 gradients max diff / max |grad| "
        f"{worst['grad_rel']:.3e} (tol {BERT_CHECK_TOL['grad_rel']}), "
        f"parameters max diff {param_max:.3e}; {off} of {total} entries "
        f"off by more "
        f"than {PARAM_NEAR}: share {worst['param_off_share']:.3e} (tol "
        f"{BERT_CHECK_TOL['param_off_share']}) [{card_line}]")
    bad = [k for k, v in worst.items() if not v <= BERT_CHECK_TOL[k]]
    if bad:
        raise RuntimeError(f"BERT on the card disagrees with its CPU copy: "
                           f"{bad}")
    del card, host, opts
    return dict(worst, param_max=param_max)


def check_adam_at(gen, label, params, decay, hyper=None) -> dict:
    """Fused Adam against its plain version (:func:`adam_vs_plain`) at a
    model's parameter shapes as its training step runs them: bf16
    gradients, ``decay`` (AdamW's ``1 - lr * coeff``, 1.0 for Adam) and a
    bf16 parameter written from its float32 master on every tensor,
    ``hyper`` the optimizer's betas and epsilon, in the plan's launches;
    bit for bit. Made before the path's counters are set to 0."""
    sizes = [p.numel() for p in params]
    err, made = adam_vs_plain(gen, sizes,
                              lambda i: (torch.bfloat16, decay, True),
                              hyper=hyper)
    log(f"  adam vs plain at {label}'s {len(sizes)} parameter shapes "
        f"({sum(sizes)} elements; bf16 gradients, float32 masters, bf16 "
        f"parameters, decay {decay}, {hyper or 'default betas'}) in {made} "
        f"launch(es) of the plan: p, m, v, p_bf16 equal bit for bit "
        f"(max_abs_err {err:.1e}; tolerance 0)")
    return {"max_abs_err": err, "launches": made, "tensors": len(sizes)}


def bert_pretrain(paddle, card_line, gen) -> dict:
    """Leg (b): ``tools/bert_bench.py``'s step through the entry points —
    ``seed``, ``BertForPretraining(BertConfig(...))``,
    ``model.to(dtype="bfloat16")``, ``AdamW(multi_precision=True)``,
    ``loss.backward(); opt.step(); opt.clear_grad()`` — BERT_WARMUP steps
    then BERT_STEPS timed, each ended by a host read of the loss, the
    counters set to 0 just before the first and read after the last."""
    from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

    paddle.set_device("gpu")
    paddle.seed(SEED)
    cfg = BertConfig(hidden_dropout=0.0, attn_dropout=0.0)
    model = BertForPretraining(cfg)
    model.to(dtype="bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=BERT_LR,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    params = model.parameters()
    n_params = sum(p.numel() for p in params)
    adam = check_adam_at(gen, "BERT-base", params, 1 - BERT_LR * 0.01)
    torch.cuda.empty_cache()
    ids, mlm, nsp = bert_batches(cfg.vocab_size, BERT_BATCHES, BERT_BATCH,
                                 BERT_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()          # every kernel's count, just before the path
    losses, step_ms = [], []
    steps = BERT_WARMUP + BERT_STEPS
    for i in range(steps):
        j = i % BERT_BATCHES
        t0 = time.perf_counter()
        loss = model(ids[j], masked_lm_labels=mlm[j],
                     next_sentence_labels=nsp[j])
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"BERT losses {losses}: not finite, or the last "
                           f"is not below the first")
    check_launches(launches, expected_bert_launches(model, params, steps),
                   f"{steps} BERT-base pretraining steps")

    def one_step(*_):
        loss = model(ids[0], masked_lm_labels=mlm[0],
                     next_sentence_labels=nsp[0])
        loss.backward()
        opt.step()
        opt.clear_grad()

    profile_step({"train_step": one_step}, None, None,
                 f"BERT-base, batch {BERT_BATCH}, seq {BERT_SEQ}")
    ms = float(np.median(step_ms[BERT_WARMUP:]))
    tokens = BERT_BATCH * BERT_SEQ
    flops_tok = 6 * n_params + 12 * cfg.num_layers * BERT_SEQ \
        * cfg.hidden_size
    mfu = flops_tok * tokens / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    per_step = {k: v // steps for k, v in launches.items() if v}
    out = {"ms": ms, "step_ms": step_ms, "sequences_per_s":
           BERT_BATCH / (ms / 1e3), "mfu": mfu, "params": n_params,
           "flops_per_token": flops_tok, "peak_gib": peak / 2**30,
           "losses": losses, "launches_per_step": per_step,
           "tensors": len(params), "adam_check": adam}
    log(f"  BERT-base pretraining (bf16 + float32 masters, AdamW {BERT_LR}, "
        f"batch {BERT_BATCH}, seq {BERT_SEQ}, {n_params} parameters in "
        f"{len(params)} tensors): loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"ms a step " + ", ".join(f"{t:.2f}" for t in step_ms)
        + f" (each ends in loss.item(), a host read); median of the last "
        f"{BERT_STEPS} "
        f"{ms:.3f} ms, {out['sequences_per_s']:.1f} sequences/s, MFU "
        f"{mfu:.4f} (6N + 12 L s h = {flops_tok} flops a token against "
        f"989 TFLOP/s); peak memory {out['peak_gib']:.3f} GiB; launches "
        f"per step {json.dumps(per_step)}; plain calls 0 [{card_line}]")
    del model, opt
    return out


def bert_finetune(paddle, card_line) -> dict:
    """Leg (c): ``BertForSequenceClassification`` at BERT-base width, bf16
    with masters, batch BERT_FT_BATCH, seq BERT_SEQ, under a padding
    ``attention_mask`` (each row's tail, a seeded length of up to a
    quarter of the row, hidden): the composite attention, as the
    reference routes a mask, so no flash launch; LayerNorm and Adam on
    their kernels."""
    from paddle_tpu_torch.text.bert import (BertConfig,
                                            BertForSequenceClassification)

    paddle.set_device("gpu")
    paddle.seed(SEED + 1)
    cfg = BertConfig(hidden_dropout=0.0, attn_dropout=0.0)
    model = BertForSequenceClassification(cfg)
    model.to(dtype="bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=BERT_LR,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    params = model.parameters()
    rng = np.random.RandomState(SEED + 11)
    b, s = BERT_FT_BATCH, BERT_SEQ
    dev = resolve_device(None)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, s)),
                          device=dev)
    labels = torch.as_tensor(rng.randint(0, 2, (b,)), device=dev)
    pad = rng.randint(0, s // 4 + 1, (b,))
    visible = np.arange(s)[None, :] < (s - pad)[:, None]
    mask = torch.as_tensor(visible[:, None, None, :], device=dev)
    torch.cuda.synchronize()
    reset_counters()
    losses, step_ms = [], []
    for _ in range(BERT_FT_STEPS):
        t0 = time.perf_counter()
        loss = model(ids, attention_mask=mask, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"BERT fine-tune losses {losses}: not finite")
    check_launches(launches, expected_bert_launches(
        model, params, BERT_FT_STEPS, flash=False),
        f"{BERT_FT_STEPS} masked BERT fine-tune steps")
    ms = float(np.median(step_ms[1:]))
    per_step = {k: v // BERT_FT_STEPS for k, v in launches.items() if v}
    log(f"  BERT-base fine-tune (sequence classification, bf16, batch {b}, "
        f"seq {s}, padding mask hiding {int(pad.sum())} of {b * s} "
        f"positions): loss {losses[0]:.4f} -> {losses[-1]:.4f}; ms a step "
        + ", ".join(f"{t:.2f}" for t in step_ms) + f"; median after the "
        f"first {ms:.3f} ms; launches per step {json.dumps(per_step)} "
        f"(flash 0: a mask takes the composite) [{card_line}]")
    del model, opt
    return {"ms": ms, "step_ms": step_ms, "losses": losses,
            "launches_per_step": per_step}


def layers_on_card(paddle, card_line, slice_12b2=False) -> dict:
    """Leg (d): the cases of ``analysis.layercheck.LAYER_CASES`` (every
    layer class of ``nn``; phase 11 those before item 12b-2, phase 12 the
    ``SLICE_12B2`` ones) forward and backward on the card and on a CPU
    copy with its weights, on the same inputs, within the case's CPU-test
    tolerance — a tensor made on the wrong device inside a forward
    fails here."""
    from paddle_tpu_torch.analysis.layercheck import (LAYER_CASES,
                                                      SLICE_12B2,
                                                      TOLERANCES, run_case)

    worst, failures = {}, []
    cases = [c for c in LAYER_CASES if (c.name in SLICE_12B2) == slice_12b2]
    for case in cases:
        paddle.set_device("gpu")
        paddle.seed(SEED)
        card = case.build(paddle)
        paddle.set_device("cpu")
        host = case.build(paddle)
        host.set_state_dict({k: v.detach().cpu()
                             for k, v in card.state_dict().items()})
        arrays = case.inputs(np.random.default_rng(SEED))
        paddle.set_device("gpu")
        got = run_case(paddle, card, case, arrays)
        paddle.set_device("cpu")
        want = run_case(paddle, host, case, arrays)
        rtol, atol = TOLERANCES[case.kind]
        pairs = [(f"out{i}", g, w) for i, (g, w) in
                 enumerate(zip(got["outputs"], want["outputs"]))]
        for key in ("input_grads", "param_grads", "buffers"):
            if sorted(got[key]) != sorted(want[key]):
                failures.append(f"{case.name} {key} names")
            pairs += [(f"{key}:{n}", got[key][n], want[key][n])
                      for n in want[key] if n in got[key]]
        err = 0.0
        for what, g, w in pairs:
            d = np.abs(g.astype(np.float64) - w)
            err = max(err, float(d.max()) if d.size else 0.0)
            if d.size and bool((d > atol + rtol * np.abs(w)).any()):
                failures.append(f"{case.name} {what}")
        worst[case.name] = err
    paddle.set_device("gpu")
    log(f"  {len(cases)} layer cases on the card vs CPU copies: "
        f"largest max abs err {max(worst.values()):.3e} "
        f"({max(worst, key=worst.get)}); failures {failures} [{card_line}]")
    if failures:
        raise RuntimeError(f"layers on the card disagree with their CPU "
                           f"copies: {failures}")
    return worst


def bert_phase(card_line: str, gen) -> dict:
    """Phase 11: (a) the float32 check, (b) BERT-base pretraining at
    ``tools/bert_bench.py``'s first rung, (c) the masked fine-tune step,
    (d) every layer class on the card; then the flash and LayerNorm
    kernels timed at BERT's shapes."""
    import paddle_tpu_torch as paddle

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check = bert_fp32_check(paddle, card_line)
    torch.cuda.empty_cache()
    pre = bert_pretrain(paddle, card_line, gen)
    torch.cuda.empty_cache()
    ft = bert_finetune(paddle, card_line)
    torch.cuda.empty_cache()
    layers = layers_on_card(paddle, card_line)
    _, b, h, s, _, d, causal = next(c for c in FLASH_CASES
                                    if c[0] == "bert")
    flash, _ = time_flash_at(gen, b, h, s, d, causal)
    ln = time_layernorm(gen, "bert")
    seconds = time.perf_counter() - t0
    out = {"fp32_check": check, "pretrain": pre, "fine_tune": ft,
           "layer_cases": len(layers),
           "layer_max_abs_err": max(layers.values()), "flash": flash,
           "layernorm": ln, "seconds": seconds}
    log(f"  phase 11 took {seconds:.1f} s")
    print(json.dumps({"phase11": {
        k: v for k, v in out.items() if k not in ("flash", "layernorm")}}),
        flush=True)
    return out


# --------------------------------------------------------------- phase 12
# tools/resnet_bench.py's first rung: ResNet-50, batch 256, 224 x 224,
# bf16 parameters with float32 masters, Momentum(0.1, 0.9,
# multi_precision), cross-entropy on float32 logits; images from
# RandomState(0).rand and labels from randint(0, 1000), drawn for the
# bench's 8 inner steps at once
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 256, 224, 1000
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
RESNET_INNER, RESNET_WARMUP, RESNET_STEPS = 8, 2, 6
# the loss is held over RESNET_PASSES passes over the 8 batches, as the
# bench cycles them: with random labels a batch seen once says nothing
# (the first pass's losses wander 7.44-8.16), a batch seen again does
# (pass means 7.687, 7.651, 7.159, 6.854, measured on one H100)
RESNET_PASSES = 3
# leg (a): ResNet-50 at 224 x 224, batch 4, in float64 (see
# resnet_fp64_check), and its convolutions in float32 against float64 with
# TF32 allowed process-wide: the port's local flag must keep them within
# CONV_FP32_RTOL of the largest float64 value. Full float32 measured
# 1.528e-5 there (the first convolution's dw, a sum of 50,176 products);
# TF32's 10-bit mantissa puts its forward alone 3.564e-4 off (measured
# on one H100); leg (c): LeNet in float32
RESNET_CHECK_BATCH, CHECK_STEPS = 4, 3
CONV_FP32_RTOL = 1e-4
LENET_BATCH = 64
# leg (e): tests/test_decode.py's seq2seq beam search with an LSTMCell
BEAM_VOCAB, BEAM_HIDDEN, BEAM_SIZE, BEAM_BATCH, BEAM_STEPS = 17, 16, 4, 3, 12


def image_batches(n, b, c, image, seed):
    """``n`` batches of images ``RandomState(seed).rand`` and labels
    ``randint(0, RESNET_CLASSES)`` on the CPU, as ``tools/resnet_bench.py``
    draws them."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(n, b, c, image, image).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, RESNET_CLASSES, (n, b)))
    return x, y


def ce_loss(paddle, model, x, y):
    """Cross-entropy on float32 logits (float64 ones stay float64)."""
    logits = model(x)
    if logits.dtype != torch.float64:
        logits = logits.float()
    return paddle.nn.functional.cross_entropy(logits, y)


def momentum_vs_cpu(paddle, build, x, y, label, card_line,
                    dtype=torch.float32) -> dict:
    """``build()`` on the card and a CPU copy (:func:`card_and_copy`),
    CHECK_STEPS Momentum steps each on the same batches
    (:func:`forward_backward_pair`), held to phase 11's limits
    (``BERT_CHECK_TOL``): the
    losses; each parameter's step-1 gradient against its own largest; the
    share of parameter entries off by more than PARAM_NEAR after the last
    step; and the BatchNorm buffers after the last step, an entry off when
    it differs by more than PARAM_NEAR times ``max(1, |value|)`` (a
    running variance may be in the hundreds)."""
    card, host = card_and_copy(paddle, build, label, dtype)
    x = x.to(dtype)
    opts = [paddle.optimizer.Momentum(learning_rate=RESNET_LR,
                                      momentum=RESNET_MOMENTUM,
                                      parameters=m.parameters())
            for m in (card, host)]
    worst = dict(loss=0.0, grad_rel=0.0)
    losses = []
    t0 = time.perf_counter()
    for step in range(CHECK_STEPS):
        (l_card, g_card, _), (l_host, g_host, _) = forward_backward_pair(
            paddle, (card, host), lambda m, where: ce_loss(
                paddle, m, x[step].to(where), y[step].to(where)))
        losses.append([l_card, l_host])
        worst["loss"] = max(worst["loss"], abs(l_card - l_host))
        if step == 0:
            worst["grad_rel"] = rel_diff(g_card, g_host)[0]
        for opt in opts:
            opt.step()
            opt.clear_grad()

    def off_share(got, want, scaled):
        off = total = 0
        top = 0.0
        for n, w in want.items():
            d = (got[n].detach().cpu().float() - w.detach().float()).abs()
            top = max(top, d.max().item() if d.numel() else 0.0)
            near = PARAM_NEAR * (w.detach().float().abs().clamp(min=1.0)
                                 if scaled else 1.0)
            off += int((d > near).sum())
            total += d.numel()
        return off / max(total, 1), top

    worst["param_off_share"], param_max = off_share(
        dict(card.named_parameters()), dict(host.named_parameters()), False)
    worst["buffer_off_share"], buffer_max = off_share(
        dict(card.named_buffers()), dict(host.named_buffers()), True)
    seconds = time.perf_counter() - t0
    tol = dict(BERT_CHECK_TOL,
               buffer_off_share=BERT_CHECK_TOL["param_off_share"])
    log(f"  {label} ({str(dtype)[6:]}, TF32 off, Momentum {RESNET_LR}/"
        f"{RESNET_MOMENTUM}, {CHECK_STEPS} steps; card vs CPU copy, "
        f"{seconds:.1f} s): losses {losses}; loss diff {worst['loss']:.3e} "
        f"(tol {tol['loss']}), step-1 gradients max diff / own max |grad| "
        f"{worst['grad_rel']:.3e} (tol {tol['grad_rel']}), parameters max "
        f"diff {param_max:.3e}, share off by more than {PARAM_NEAR} "
        f"{worst['param_off_share']:.3e} (tol {tol['param_off_share']}), "
        f"BatchNorm buffers max diff {buffer_max:.3e}, share off "
        f"{worst['buffer_off_share']:.3e} (tol {tol['buffer_off_share']}) "
        f"[{card_line}]")
    bad = [k for k, v in worst.items() if not v <= tol[k]]
    if bad:
        raise RuntimeError(f"{label} on the card disagrees with its CPU "
                           f"copy: {bad}")
    del card, host, opts
    return dict(worst, param_max=param_max, buffer_max=buffer_max,
                losses=losses, seconds=seconds)


def resnet_fp64_check(paddle, card_line) -> dict:
    """Leg (a): ``resnet50()`` at 224 x 224, batch 4, in float64 on the
    card and on the CPU. Not float32: at batch 4 the BatchNorms' backward
    cancels so much that float32's own rounding moves layer4's step-1
    gradients by up to 22% of their largest (the CPU's float32 against
    its float64, measured at this seed), and at Momentum 0.1 / 0.9 the
    loss rises from 7.4 to about 60 in three steps, so any float32
    difference grows past every limit. In float64 the same path is held
    to phase 11's limits; the float32 convolutions are held to float64
    shape by shape in :func:`conv_fp32_check`, and LeNet (leg (c)) runs
    the whole float32 path."""
    from paddle_tpu_torch.vision.models import resnet50

    x, y = image_batches(CHECK_STEPS, RESNET_CHECK_BATCH, 3, RESNET_IMAGE,
                         SEED + 12)
    return momentum_vs_cpu(paddle, resnet50, x, y,
                           f"ResNet-50 check (batch {RESNET_CHECK_BATCH}, "
                           f"{RESNET_IMAGE} x {RESNET_IMAGE})", card_line,
                           torch.float64)


def resnet_conv_shapes(paddle, batch) -> list:
    """Every distinct convolution of ``resnet50()`` at ``batch`` images of
    224 x 224: (input shape, weight shape, stride, padding)."""
    from paddle_tpu_torch.vision.models import resnet50

    paddle.set_device("cpu")
    paddle.seed(SEED)
    model = resnet50()
    shapes = []

    def hook(layer, inputs, out):
        key = (tuple(inputs[0].shape), tuple(layer.weight.shape),
               layer._stride, layer._padding)
        if key not in shapes:
            shapes.append(key)

    for m in model.sublayers():
        if isinstance(m, paddle.nn.Conv2D):
            m.register_forward_post_hook(hook)
    with torch.no_grad():
        model.eval()
        model(torch.zeros((batch, 3, RESNET_IMAGE, RESNET_IMAGE)))
    paddle.set_device("gpu")
    return shapes


def conv_fp32_check(paddle, card_line, gen) -> dict:
    """Leg (a): each distinct convolution of ResNet-50 at leg (a)'s batch
    in float32 through ``nn.functional.conv2d`` on the card, forward and
    both gradients, against float64 on the card, with cuDNN's TF32
    allowed process-wide for the duration (the port's local flag must
    turn it off): every error within CONV_FP32_RTOL of the largest
    float64 value. The same convolution through ``torch.convolution``
    with TF32 allowed is printed beside it."""
    F = paddle.nn.functional
    shapes = resnet_conv_shapes(paddle, RESNET_CHECK_BATCH)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    worst = {"port": 0.0, "tf32": 0.0}
    try:
        for xs, ws, stride, pad in shapes:
            x = torch.randn(xs, generator=gen, device="cuda")
            w = torch.randn(ws, generator=gen, device="cuda") / np.sqrt(
                np.prod(ws[1:]))
            x.requires_grad_(True)
            w.requires_grad_(True)
            out = F.conv2d(x, w, None, stride, pad)
            cot = torch.randn(out.shape, generator=gen, device="cuda")
            dx, dw = torch.autograd.grad(out, (x, w), cot)
            x64, w64 = (t.detach().double().requires_grad_(True)
                        for t in (x, w))
            conf = (list(stride), [int(pad)] * 2, [1, 1], False, [0, 0], 1)
            out64 = torch.convolution(x64, w64, None, *conf)
            dx64, dw64 = torch.autograd.grad(out64, (x64, w64),
                                             cot.double())
            raw = torch.convolution(x.detach(), w.detach(), None, *conf)
            for got, want in ((out, out64), (dx, dx64), (dw, dw64)):
                err = ((got.double() - want).abs().max()
                       / want.abs().max()).item()
                worst["port"] = max(worst["port"], err)
            worst["tf32"] = max(worst["tf32"], ((raw.double() - out64)
                                                .abs().max()
                                                / out64.abs().max()).item())
    finally:
        torch.backends.cudnn.allow_tf32 = before
    log(f"  float32 convolutions of ResNet-50 at batch "
        f"{RESNET_CHECK_BATCH} ({len(shapes)} shapes; forward, dx, dw) "
        f"against float64 with cuDNN's TF32 allowed process-wide: the "
        f"port's largest error {worst['port']:.3e} of the largest value "
        f"(tol {CONV_FP32_RTOL}); torch.convolution's forward with TF32 "
        f"allowed {worst['tf32']:.3e} [{card_line}]")
    if not worst["port"] <= CONV_FP32_RTOL:
        raise RuntimeError(f"a float32 convolution of the port is not "
                           f"full float32: {worst}")
    return dict(worst, shapes=len(shapes))


def lenet_check(paddle, card_line) -> dict:
    """Leg (c): LeNet at batch 64, 1 x 28 x 28, float32."""
    from paddle_tpu_torch.vision.models import LeNet

    x, y = image_batches(CHECK_STEPS, LENET_BATCH, 1, 28, SEED + 13)
    return momentum_vs_cpu(paddle, LeNet, x, y % 10,
                           f"LeNet check (batch {LENET_BATCH}, 28 x 28)",
                           card_line)


def training_flops(paddle, model, image) -> int:
    """A training step's flops for one image, from the layers' shapes: 2
    multiply-adds a MAC of every convolution (``out * in / groups * k``
    at each output position) and linear layer, times 3 (forward, and the
    backward's two products)."""
    macs = []

    def conv_hook(layer, inputs, out):
        k = int(np.prod(layer.weight.shape[1:]))
        macs.append(out[0].numel() * k)

    def linear_hook(layer, inputs, out):
        macs.append(out[0].numel() * layer.weight.shape[0])

    hooks = [m.register_forward_post_hook(
        conv_hook if isinstance(m, paddle.nn.Conv2D) else linear_hook)
        for m in model.sublayers()
        if isinstance(m, (paddle.nn.Conv2D, paddle.nn.Linear))]
    dev = model.parameters()[0].device
    with torch.no_grad():
        model.eval()
        model(torch.zeros((1, 3, image, image), device=dev,
                          dtype=model.parameters()[0].dtype))
        model.train()
    for h in hooks:
        h.remove()
    return 3 * 2 * sum(macs)


def resnet_layer(name: str) -> str:
    """The layer of the ResNet step a device kernel belongs to, from its
    name (phase 12's profile)."""
    low = name.lower()
    if "pool" in low:
        return "pooling (max 3x3/2, adaptive average)"
    if any(t in low for t in ("conv", "xmma", "implicit", "gemm", "cutlass",
                              "sm90", "cudnn", "dgrad", "wgrad", "fprop",
                              "nchwtonhwc", "nhwctonchw", "nvjet",
                              "splitk")):
        return "convolutions and the fc product (cuDNN, cuBLAS)"
    return ("BatchNorm and elementwise (batch statistics, normalise, ReLU, "
            "residual adds, casts, cross-entropy)")


def device_rows(prof) -> list:
    """``(device us, kernel name, calls)`` of every kernel a profile
    recorded on the card."""
    return [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def profile_resnet(fwd_bwd, step, wall_ms) -> dict:
    """One step under ``torch.profiler``, in two windows: the forward and
    backward (device time by layer) and the optimizer step; the device's
    busy share of an unprofiled step's ``wall_ms``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    opt_rows = device_rows(prof)
    layers = {}
    for dev_us, key, count in rows:
        layer = layers.setdefault(resnet_layer(key), [0.0, 0])
        layer[0] += dev_us / 1e3
        layer[1] += count
    layers["optimizer (Momentum with float32 masters, per tensor)"] = [
        sum(r[0] for r in opt_rows) / 1e3, sum(r[2] for r in opt_rows)]
    busy = sum(v[0] for v in layers.values())
    if not busy:
        log("  ResNet-50 profile: the profiler recorded no device time (not "
            "measured)")
        return {}
    log(f"  ResNet-50 profile: device busy {busy:.3f} ms of an unprofiled "
        f"step's {wall_ms:.3f} ms wall = {100 * busy / wall_ms:.1f}% (idle "
        f"{100 - 100 * busy / wall_ms:.1f}%)")
    for name, (dev_ms, count) in sorted(layers.items(),
                                        key=lambda kv: -kv[1][0]):
        log(f"    layer {100 * dev_ms / busy:5.1f}%  {dev_ms:8.3f} ms  "
            f"x{count:<5d} {name}")
    for dev_us, key, count in sorted(rows, reverse=True)[:8]:
        log(f"    {100 * dev_us / 1e3 / busy:5.1f}%  {dev_us / 1e3:8.3f} ms  "
            f"x{count:<5d} {key[:80]}")
    return {"busy_ms": busy, "wall_ms": wall_ms,
            "layers": {k: {"ms": v[0], "launches": v[1]}
                       for k, v in layers.items()}}


def resnet_train(paddle, card_line) -> dict:
    """Leg (b): ``tools/resnet_bench.py``'s first rung through the entry
    points — ``seed``, ``resnet50()``, ``model.to(dtype="bfloat16")``,
    ``Momentum(multi_precision=True)``, ``backward`` / ``step`` /
    ``clear_grad`` — RESNET_PASSES passes over the bench's RESNET_INNER
    batches, each step ended by a host read of the loss: steps
    RESNET_WARMUP + 1 to RESNET_WARMUP + RESNET_STEPS are the timed ones;
    the last pass's mean loss must be below the first's. The counters are
    set to 0 just before the first step and read after the last: no
    hand-written kernel runs on this path (the reference's conv, pooling,
    BatchNorm and Momentum are XLA, not Pallas). An out-of-memory error
    fails the phase."""
    from paddle_tpu_torch.vision.models import resnet50

    paddle.set_device("gpu")
    paddle.seed(SEED)
    model = resnet50(num_classes=RESNET_CLASSES)
    model.to(dtype="bfloat16")
    opt = paddle.optimizer.Momentum(learning_rate=RESNET_LR,
                                    momentum=RESNET_MOMENTUM,
                                    parameters=model.parameters(),
                                    multi_precision=True)
    params = model.parameters()
    n_params = sum(p.numel() for p in params)
    flops_image = training_flops(paddle, model, RESNET_IMAGE)
    t0 = time.perf_counter()
    xs, ys = image_batches(RESNET_INNER, RESNET_BATCH, 3, RESNET_IMAGE, 0)
    dev = resolve_device(None)
    xs = xs.to(dev).to(torch.bfloat16)
    ys = ys.to(dev)
    data_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()          # every kernel's count, just before the path
    losses, step_ms = [], []
    steps = RESNET_INNER * RESNET_PASSES
    for i in range(steps):
        j = i % RESNET_INNER
        t0 = time.perf_counter()
        loss = ce_loss(paddle, model, xs[j], ys[j])
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    pass_mean = [float(np.mean(losses[k:k + RESNET_INNER]))
                 for k in range(0, steps, RESNET_INNER)]
    if not all(np.isfinite(losses)) or not pass_mean[-1] < pass_mean[0]:
        raise RuntimeError(f"ResNet-50 losses {losses}: not finite, or the "
                           f"last pass's mean is not below the first's")
    check_launches(launches, {}, f"{steps} ResNet-50 training steps")
    timed = step_ms[RESNET_WARMUP:RESNET_WARMUP + RESNET_STEPS]
    ms = float(np.median(timed))
    spread = [float(min(timed)), float(max(timed))]
    flops_step = flops_image * RESNET_BATCH
    mfu = flops_step / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16]

    def fwd_bwd():
        ce_loss(paddle, model, xs[0], ys[0]).backward()

    def step():
        opt.step()
        opt.clear_grad()

    fwd_bwd()
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd_bwd()
    step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_resnet(fwd_bwd, step, wall_ms)
    out = {"ms": ms, "step_ms": step_ms, "spread_ms": spread,
           "images_per_s": RESNET_BATCH / (ms / 1e3), "mfu": mfu,
           "flops_per_step": flops_step, "params": n_params,
           "tensors": len(params), "peak_gib": peak / 2**30,
           "losses": losses, "pass_mean_losses": pass_mean,
           "launches_per_step": {k: v // steps for k, v in launches.items()},
           "profile": prof, "data_s": data_s}
    log(f"  ResNet-50 training (bf16 + float32 masters, Momentum "
        f"{RESNET_LR}/{RESNET_MOMENTUM} multi_precision, batch "
        f"{RESNET_BATCH}, {RESNET_IMAGE} x {RESNET_IMAGE}, {n_params} "
        f"parameters in {len(params)} tensors): {steps} steps, "
        f"{RESNET_PASSES} passes over the bench's {RESNET_INNER} batches, "
        f"mean loss a pass " + " -> ".join(f"{v:.4f}" for v in pass_mean)
        + f"; ms a step " + ", ".join(f"{t:.2f}" for t in step_ms)
        + f" (each ends in loss.item(), a host read); median of steps "
        f"{RESNET_WARMUP + 1}-{RESNET_WARMUP + RESNET_STEPS} {ms:.3f} ms "
        f"(spread {spread[0]:.3f}-"
        f"{spread[1]:.3f}), {out['images_per_s']:.1f} images/s, MFU "
        f"{mfu:.4f} ({flops_step / 1e12:.3f} TFLOP a step from the layers' "
        f"shapes against 989 TFLOP/s); peak memory {out['peak_gib']:.3f} "
        f"GiB; hand-written kernel launches a step: all 0 "
        f"{json.dumps(out['launches_per_step'])} [{card_line}]")
    del model, opt, xs, ys
    return out


def beam_search_on_card(paddle, card_line) -> dict:
    """Leg (e): a ``BeamSearchDecoder`` over an ``LSTMCell`` through
    ``dynamic_decode``, as ``tests/test_decode.py`` builds it, on the card
    and on a CPU copy with its weights: the tokens, the parents and the
    lengths equal."""
    nn = paddle.nn

    class Recorded(nn.BeamSearchDecoder):
        def finalize(self, outputs, final_states, sequence_lengths):
            self.parents = outputs["parent_ids"]
            return super().finalize(outputs, final_states, sequence_lengths)

    def run(dev, weights=None):
        paddle.set_device(dev)
        paddle.seed(SEED)
        emb = nn.Embedding(BEAM_VOCAB, BEAM_HIDDEN)
        cell = nn.LSTMCell(BEAM_HIDDEN, BEAM_HIDDEN)
        proj = nn.Linear(BEAM_HIDDEN, BEAM_VOCAB)
        parts = {"emb": emb, "cell": cell, "proj": proj}
        if weights is not None:
            for k, m in parts.items():
                m.set_state_dict({n: v.cpu() for n, v in weights[k].items()})
        dec = Recorded(cell, start_token=1, end_token=2,
                       beam_size=BEAM_SIZE, embedding_fn=emb,
                       output_fn=proj)
        h0 = paddle.to_tensor(np.random.RandomState(0).randn(
            BEAM_BATCH, BEAM_HIDDEN).astype(np.float32))
        c0 = paddle.to_tensor(np.zeros((BEAM_BATCH, BEAM_HIDDEN),
                                       np.float32))
        ids, _, lengths = nn.dynamic_decode(dec, inits=(h0, c0),
                                            max_step_num=BEAM_STEPS,
                                            return_length=True)
        got = {"ids": ids, "parents": dec.parents, "lengths": lengths}
        return ({k: v.detach().cpu() for k, v in got.items()},
                {k: m.state_dict() for k, m in parts.items()})

    card, weights = run("gpu")
    host, _ = run("cpu", weights)
    paddle.set_device("gpu")
    equal = {k: bool(torch.equal(card[k], host[k])) for k in card}
    log(f"  beam search (LSTMCell {BEAM_HIDDEN}, vocab {BEAM_VOCAB}, beam "
        f"{BEAM_SIZE}, batch {BEAM_BATCH}, {BEAM_STEPS} steps): card vs CPU "
        f"copy equal {equal}; lengths {card['lengths'].tolist()} "
        f"[{card_line}]")
    if not all(equal.values()):
        raise RuntimeError(f"beam search on the card differs from its CPU "
                           f"copy: {equal}")
    return {"equal": equal, "lengths": card["lengths"].tolist()}


def vision_phase(card_line: str) -> dict:
    """Phase 12: (a) the ResNet-50 float32 check, (b) ResNet-50 training
    at ``tools/resnet_bench.py``'s first rung, (c) LeNet, (d) the layer
    cases of item 12b-2, (e) beam search."""
    import paddle_tpu_torch as paddle

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check = resnet_fp64_check(paddle, card_line)
    conv32 = conv_fp32_check(paddle, card_line,
                             torch.Generator(device="cuda").manual_seed(SEED))
    gc.collect()
    torch.cuda.empty_cache()
    trained = resnet_train(paddle, card_line)
    gc.collect()
    torch.cuda.empty_cache()
    lenet = lenet_check(paddle, card_line)
    layers = layers_on_card(paddle, card_line, slice_12b2=True)
    beam = beam_search_on_card(paddle, card_line)
    seconds = time.perf_counter() - t0
    out = {"resnet50_check": check, "conv_fp32": conv32,
           "resnet50_train": trained,
           "lenet_check": lenet, "layer_cases": len(layers),
           "layer_max_abs_err": max(layers.values()), "beam_search": beam,
           "seconds": seconds}
    log(f"  phase 12 took {seconds:.1f} s")
    print(json.dumps({"phase12": out}), flush=True)
    return out


# --------------------------------------------------------------- phase 13
# (a) ERNIE-3.0-base MLM pretraining at full width: ernie_config's base
# preset (hidden 768, 12 layers of 12 heads, intermediate 3,072, vocab
# 18,000, 513 positions, both dropouts 0.1), batch 16 at ERNIE 3.0's
# pretraining length 512, 15% of positions labelled; bf16 with float32
# masters, AdamW(1e-4)
ERNIE_BATCH, ERNIE_SEQ, ERNIE_LR, ERNIE_MASK_FRAC = 16, 512, 1e-4, 0.15
TEXT_WARMUP, TEXT_STEPS = 2, 6
# (b) Transformer-base (Vaswani et al. 2017, TransformerMTConfig() as it
# stands): 64 pairs, each side's length drawn from 16-128 and padded to
# 128 (about 4,700 real tokens a side, near the 4,096-token batches of
# Paddle's Transformer-base recipe); Adam(0.9, 0.98, 1e-9) under
# NoamDecay(512, 4000)
MT_PAIRS, MT_MIN_LEN, MT_MAX_LEN = 64, 16, 128
MT_WARMUP_STEPS = 4000
# (c) beam search: 16 of those sources, beam 4, 50 steps past the source
MT_BEAM, MT_BEAM_BATCH, MT_EXTRA = 4, 16, 50
# (d) float64 parity on the card against a CPU copy: the loss relative to
# itself, each gradient relative to its own largest value (a gradient
# that is 0 but for rounding, below 1e-8 of the model's largest, relative
# to the model's largest)
TEXT_F64_TOL, ZERO_GRAD = 1e-9, 1e-8
ERNIE_CHECK_LAYERS, ERNIE_CHECK_BATCH, ERNIE_CHECK_SEQ = 2, 2, 128
MT_CHECK_LAYERS, MT_CHECK_PAIRS, MT_CHECK_LEN = 2, 4, 32
MT_CHECK_BEAM_BATCH, MT_CHECK_MAX_LEN = 2, 24
# (e) one factory of each vision family: float64 training-mode forward
# and backward at batch 2 (loss within TEXT_F64_TOL; gradients and
# BatchNorm buffers within ZOO_F64_REL of their own largest), then a bf16
# Momentum(0.1, 0.9) step at batch 64 for images/s
ZOO = [("alexnet", 224), ("vgg16", 224), ("squeezenet1_1", 224),
       ("mobilenet_v1", 224), ("mobilenet_v2", 224),
       ("mobilenet_v3_large", 224), ("shufflenet_v2_x1_0", 224),
       ("googlenet", 224), ("inception_v3", 299), ("densenet121", 224)]
ZOO_CHECK_BATCH, ZOO_TRAIN_BATCH, ZOO_TRAIN_STEPS = 2, 64, 3
ZOO_F64_REL = 1e-7


def ernie_batches(vocab, n, b, s, seed):
    """``n`` batches of ids and MLM labels (an ERNIE_MASK_FRAC share
    labelled with random ids, the rest -1), int64 on the card."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (n, b, s))
    mlm = np.full((n, b, s), -1, np.int64)
    sel = rng.rand(n, b, s) < ERNIE_MASK_FRAC
    mlm[sel] = rng.randint(0, vocab, int(sel.sum()))
    dev = resolve_device(None)
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=dev)
                 for a in (ids, mlm))


def mt_pairs(cfg, n, max_len, seed=SEED):
    """``n`` pairs for ``TransformerMT``: each side's length drawn from
    MT_MIN_LEN to ``max_len``, tokens from 3 up (0-2 are bos, eos and
    pad); the target input ``bos + y`` and the labels ``y + eos``; every
    side padded with ``pad_id`` to ``max_len``. int64 on the card."""
    rng = np.random.RandomState(seed)
    src = np.full((n, max_len), cfg.pad_id, np.int64)
    tgt = np.full((n, max_len), cfg.pad_id, np.int64)
    lab = np.full((n, max_len), cfg.pad_id, np.int64)
    src_len = rng.randint(MT_MIN_LEN, max_len + 1, n)
    tgt_len = rng.randint(MT_MIN_LEN, max_len + 1, n)
    for i in range(n):
        src[i, :src_len[i]] = rng.randint(3, cfg.src_vocab_size, src_len[i])
        y = rng.randint(3, cfg.tgt_vocab_size, tgt_len[i] - 1)
        tgt[i, :tgt_len[i]] = np.concatenate([[cfg.bos_id], y])
        lab[i, :tgt_len[i]] = np.concatenate([y, [cfg.eos_id]])
    dev = resolve_device(None)
    return tuple(torch.as_tensor(a, device=dev) for a in (src, tgt, lab))


def mt_step_flops(cfg, b, s_src, s_tgt) -> int:
    """A Transformer-MT training step's flops from the layer shapes, at
    the padded lengths (the composite attention computes every pair): 2 a
    multiply-add of every projection and attention product, times 3
    (forward and the backward's two products)."""
    d, ff = cfg.d_model, cfg.dim_feedforward
    le, ld = cfg.num_encoder_layers, cfg.num_decoder_layers
    macs = (b * s_src * le * (4 * d * d + 2 * d * ff)        # encoder
            + b * s_tgt * ld * (6 * d * d + 2 * d * ff)      # decoder
            + b * s_src * ld * 2 * d * d                     # cross k, v
            + b * s_tgt * d * cfg.tgt_vocab_size             # head
            + le * 2 * b * s_src * s_src * d                 # attention
            + ld * 2 * b * (s_tgt * s_tgt + s_tgt * s_src) * d)
    return 6 * macs


def text_train(paddle, card_line, label, model, opt, batches, want,
               flops_per_step, tokens, real_tokens, sched=None,
               must_fall=True) -> dict:
    """TEXT_WARMUP + TEXT_STEPS steps of ``model`` through the entry
    points (``loss.backward(); opt.step(); opt.clear_grad()``, each ended
    by a host read of the loss), the counters set to 0 just before the
    first and read after the last and held to ``want`` a step; the losses
    finite and, with ``must_fall``, the last below the first; then one
    step profiled by layer."""
    steps = TEXT_WARMUP + TEXT_STEPS
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()          # every kernel's count, just before the path
    losses, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        loss = model(*batches(i))
        loss.backward()
        opt.step()
        opt.clear_grad()
        if sched is not None:
            sched.step()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or (must_fall and
                                        not losses[-1] < losses[0]):
        raise RuntimeError(f"{label} losses {losses}: not finite, or the "
                           f"last is not below the first")
    check_launches(launches, {k: v * steps for k, v in want.items()},
                   f"{steps} {label} steps")

    def one_step(*_):
        loss = model(*batches(0))
        loss.backward()
        opt.step()
        opt.clear_grad()

    prof = profile_step({"train_step": one_step}, None, None, label)
    ms = float(np.median(step_ms[TEXT_WARMUP:]))
    mfu = flops_per_step / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    per_step = {k: v // steps for k, v in launches.items() if v}
    out = {"ms": ms, "step_ms": step_ms, "tokens_per_s": tokens / (ms / 1e3),
           "real_tokens_per_s": real_tokens / (ms / 1e3), "mfu": mfu,
           "flops_per_step": flops_per_step, "peak_gib": peak / 2**30,
           "losses": losses, "launches_per_step": per_step,
           "profile": prof}
    log(f"  {label}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; ms a step "
        + ", ".join(f"{t:.2f}" for t in step_ms) + f" (each ends in "
        f"loss.item()); median of the last {TEXT_STEPS} {ms:.3f} ms, "
        f"{out['tokens_per_s']:.1f} tokens/s ({out['real_tokens_per_s']:.1f}"
        f" of them real), MFU {mfu:.4f} ({flops_per_step / 1e12:.3f} TFLOP "
        f"a step against 989 TFLOP/s); peak memory {out['peak_gib']:.3f} "
        f"GiB; launches a step {json.dumps(per_step)}; plain calls 0 "
        f"[{card_line}]")
    return out


def ernie_pretrain(paddle, card_line, gen) -> dict:
    """Leg (a): ``ErnieForMaskedLM(ernie_config("ernie-3.0-base"))``
    through the entry points, bf16 with float32 masters. A step launches
    the flash forward and backward once a layer, the LayerNorm forward
    and dx 2L + 2 times (the embeddings, two a layer, the MLM head),
    dropout's kernel 3L + 1 times each way (the embeddings; a layer's
    attention output and its two residual branches) and fused Adam by its
    plan over every parameter but the pooler's (the MLM loss gives it no
    gradient)."""
    from paddle_tpu_torch.text import ErnieForMaskedLM, ernie_config

    paddle.set_device("gpu")
    paddle.seed(SEED)
    cfg = ernie_config("ernie-3.0-base")
    model = ErnieForMaskedLM(cfg)
    model.to(dtype="bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=ERNIE_LR,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    params = model.parameters()
    n_params = sum(p.numel() for p in params)
    # the pooler takes no part in the MLM loss: no gradient, no update
    live = [p for n, p in model.named_parameters()
            if not n.startswith("ernie.pooler.")]
    adam = check_adam_at(gen, "ERNIE-3.0-base", live, 1 - ERNIE_LR * 0.01)
    steps = TEXT_WARMUP + TEXT_STEPS
    ids, mlm = ernie_batches(cfg.vocab_size, steps, ERNIE_BATCH, ERNIE_SEQ,
                             SEED)
    layers = cfg.num_layers
    plan = fo.adam_launch_plan(
        [p.numel() for p in live], [torch.bfloat16] * len(live),
        fo.kernel_param_bytes())
    want = {"flash_fwd": layers, "flash_bwd": layers,
            "ln_fwd": 2 * layers + 2, "ln_dx": 2 * layers + 2,
            "ln_reduce": 2 * layers + 2,
            "dropout_fwd": 3 * layers + 1, "dropout_bwd": 3 * layers + 1,
            "adam": len(plan), "adam_tensors": len(live)}
    tokens = ERNIE_BATCH * ERNIE_SEQ
    flops_tok = 6 * n_params + 12 * layers * ERNIE_SEQ * cfg.hidden_size
    out = text_train(
        paddle, card_line, f"ERNIE-3.0-base MLM pretraining (bf16 + float32 "
        f"masters, AdamW {ERNIE_LR}, batch {ERNIE_BATCH}, seq {ERNIE_SEQ}, "
        f"{n_params} parameters, 6N + 12 L s h = {flops_tok} flops a token)",
        model, opt, lambda i: (ids[i], None, None, None, mlm[i]), want,
        flops_tok * tokens, tokens, tokens)
    out.update(params=n_params, flops_per_token=flops_tok,
               sequences_per_s=ERNIE_BATCH / (out["ms"] / 1e3),
               adam_vs_plain=adam)
    del model, opt
    return out


def mt_model(**overrides):
    from paddle_tpu_torch.text import TransformerMT, TransformerMTConfig

    cfg = TransformerMTConfig(**overrides)
    return cfg, TransformerMT(cfg)


def mt_train(paddle, card_line, gen) -> tuple:
    """Leg (b): ``TransformerMT(TransformerMTConfig())`` through the
    entry points, bf16 with float32 masters, under NoamDecay. Every
    attention carries a mask, so the composite runs and no flash kernel;
    a step launches the LayerNorm forward and backward (its kernel and
    reduction) 2 L_enc + 3 L_dec times,
    dropout's kernel 2 + 4 L_enc + 6 L_dec times each way (the two
    embeddings; an encoder layer's attention, feed-forward and two
    residual branches; a decoder layer's two attentions, feed-forward and
    three residual branches) and fused Adam by its plan. The loss need not
    fall: NoamDecay's rate is 1.7e-7 at the first step and 1.4e-6 at the
    eighth. Returns the readings and the trained model."""
    paddle.set_device("gpu")
    paddle.seed(SEED)
    cfg, model = mt_model()
    model.to(dtype="bfloat16")
    sched = paddle.optimizer.lr.NoamDecay(d_model=cfg.d_model,
                                          warmup_steps=MT_WARMUP_STEPS)
    opt = paddle.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                                epsilon=1e-9, parameters=model.parameters(),
                                multi_precision=True)
    params = model.parameters()
    n_params = sum(p.numel() for p in params)
    adam = check_adam_at(gen, "Transformer-base", params, 1.0,
                         dict(beta1=0.9, beta2=0.98, eps=1e-9))
    src, tgt, lab = mt_pairs(cfg, MT_PAIRS, MT_MAX_LEN)
    le, ld = cfg.num_encoder_layers, cfg.num_decoder_layers
    plan = fo.adam_launch_plan(
        [p.numel() for p in params], [torch.bfloat16] * len(params),
        fo.kernel_param_bytes())
    want = {"ln_fwd": 2 * le + 3 * ld, "ln_dx": 2 * le + 3 * ld,
            "ln_reduce": 2 * le + 3 * ld,
            "dropout_fwd": 2 + 4 * le + 6 * ld,
            "dropout_bwd": 2 + 4 * le + 6 * ld,
            "adam": len(plan), "adam_tensors": len(params)}
    flops = mt_step_flops(cfg, MT_PAIRS, MT_MAX_LEN, MT_MAX_LEN)
    real_src = int((src != cfg.pad_id).sum())
    real_tgt = int((lab != cfg.pad_id).sum())
    out = text_train(
        paddle, card_line, f"Transformer-base training (bf16 + float32 "
        f"masters, Adam 0.9/0.98/1e-9 under NoamDecay({cfg.d_model}, "
        f"{MT_WARMUP_STEPS}), {MT_PAIRS} pairs padded to {MT_MAX_LEN}, "
        f"{real_src} real source and {real_tgt} real target tokens, "
        f"{n_params} parameters)", model, opt,
        lambda i: (src, tgt, lab), want, flops,
        2 * MT_PAIRS * MT_MAX_LEN, real_tgt, sched, must_fall=False)
    if out["launches_per_step"].get("flash_fwd", 0) or \
            out["launches_per_step"].get("flash_bwd", 0):
        raise RuntimeError("Transformer-base launched a flash kernel")
    out.update(params=n_params, adam_vs_plain=adam,
               real_source_tokens=real_src,
               real_target_tokens=real_tgt, flash_launches=0,
               real_target_tokens_per_s=real_tgt / (out["ms"] / 1e3))
    log(f"  Transformer-base: flash launches 0 (every attention is "
        f"masked: the composite); {out['real_target_tokens_per_s']:.1f} "
        f"real target tokens/s [{card_line}]")
    del opt
    return out, model, src


def mt_beam(paddle, card_line, model, src) -> dict:
    """Leg (c): ``translate`` with beam MT_BEAM on MT_BEAM_BATCH of leg
    (b)'s sources (bf16), ``max_len`` the padded source length plus
    MT_EXTRA; its seconds, decoded tokens/s (the best beams' lengths),
    steps (decoder runs) and host reads (synchronising calls the card
    reports, by the line that made them): at most one a step
    (``dynamic_decode``'s ``finished.all()``) and the closing
    synchronize; then ``beam_search`` on the same sources for the
    lengths: every best beam ends in ``eos_id`` or runs to ``max_len``,
    and ``translate``'s ids are its ids, ``pad_id`` past its length."""
    import warnings

    cfg = model.cfg
    src = src[:MT_BEAM_BATCH]
    max_len = src.shape[1] + MT_EXTRA
    runs = [0]
    hook = model.transformer.decoder.register_forward_pre_hook(
        lambda *_: runs.__setitem__(0, runs[0] + 1))
    model.eval()
    here = os.path.dirname(os.path.abspath(__file__))
    sites = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        # a synchronising call, by the innermost line of the checkout
        # that made it (the warning names a line inside torch)
        if "synchroniz" not in str(message):
            return
        frame = next((f for f in reversed(traceback.extract_stack()[:-1])
                      if f.filename.startswith(here + os.sep)), None)
        sites[f"{os.path.relpath(frame.filename, here)}:{frame.lineno}"
              if frame else f"{filename}:{lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            best = model.translate(src, beam_size=MT_BEAM, max_len=max_len)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        seconds = time.perf_counter() - t0
    hook.remove()
    host_reads = sum(sites.values())
    ids, lengths = model.beam_search(src, beam_size=MT_BEAM, max_len=max_len)
    best, ids, lengths = (t.cpu() for t in (best, ids, lengths))
    n = lengths[:, 0]
    steps = torch.arange(max_len)[None, :]
    want = torch.where(steps < n[:, None], ids[:, :, 0],
                       torch.full_like(ids[:, :, 0], cfg.pad_id))
    ends = [bool(L == max_len or best[i, L - 1] == cfg.eos_id)
            for i, L in enumerate(n.tolist())]
    padded = bool(((best == cfg.pad_id) | (steps < n[:, None])).all())
    decoded = int(n.sum())
    out = {"seconds": seconds, "decoded_tokens": decoded,
           "decoded_tokens_per_s": decoded / seconds, "steps": runs[0],
           "host_reads": host_reads, "host_read_sites": dict(sites),
           "lengths": n.tolist(),
           "ends_in_eos_or_max_len": all(ends), "pad_filled": padded,
           "translate_equals_beam_search": bool(torch.equal(best, want))}
    log(f"  Transformer-base beam search (bf16, beam {MT_BEAM}, "
        f"{MT_BEAM_BATCH} sources padded to {src.shape[1]}, max_len "
        f"{max_len}): {seconds:.3f} s, {decoded} tokens decoded "
        f"({out['decoded_tokens_per_s']:.1f} tokens/s), {out['steps']} "
        f"decoder steps, {host_reads} host reads (limit {runs[0] + 1}; "
        f"by line {dict(sites)}); best "
        f"lengths {n.tolist()}; every row ends in eos or at max_len: "
        f"{all(ends)}; pad-filled past its length: {padded}; translate == "
        f"beam_search's best beam: {out['translate_equals_beam_search']} "
        f"[{card_line}]")
    if not (all(ends) and padded and out["translate_equals_beam_search"]
            and host_reads <= runs[0] + 1):
        raise RuntimeError(f"Transformer-base beam search: {out}")
    return out


def text_f64_check(paddle, card_line) -> dict:
    """Leg (d): float64 on the card against a CPU copy. ERNIE at base
    width with ERNIE_CHECK_LAYERS layers and its dropouts (0.1), batch
    ERNIE_CHECK_BATCH at seq ERNIE_CHECK_SEQ: the MLM loss, then every
    gradient. Transformer-base width with MT_CHECK_LAYERS + MT_CHECK_LAYERS
    layers, no dropout: the loss and the gradients, then ``beam_search``'s
    ids, parents (each step's, as ``gather_tree`` receives them) and
    lengths equal at batch MT_CHECK_BEAM_BATCH, beam MT_BEAM, ``max_len``
    MT_CHECK_MAX_LEN. Each package is seeded just before its forward, so
    that dropout draws the same keys on both."""
    from paddle_tpu_torch.nn import decode as nd
    from paddle_tpu_torch.text import ErnieForMaskedLM, ernie_config

    out = {"dropout_f64": check_dropout_f64()}

    def step(card, host, batch):
        (l_card, g_card, _), (l_host, g_host, _) = forward_backward_pair(
            paddle, (card, host), lambda m, where: m(
                *(None if a is None else a.to(where) for a in batch)),
            seed=SEED + 3)
        loss_rel = abs(l_card - l_host) / abs(l_host)
        g_err, g_name = rel_diff(g_card, g_host, ZERO_GRAD)
        ok = loss_rel <= TEXT_F64_TOL and g_err <= TEXT_F64_TOL
        return {"losses": [l_card, l_host], "loss_rel": loss_rel,
                "grad_rel": g_err, "worst": g_name, "ok": ok}

    card, host = card_and_copy(paddle, lambda: ErnieForMaskedLM(ernie_config(
        "ernie-3.0-base", num_layers=ERNIE_CHECK_LAYERS)), "ERNIE check",
        torch.float64)
    ids, mlm = ernie_batches(card.cfg.vocab_size, 1, ERNIE_CHECK_BATCH,
                             ERNIE_CHECK_SEQ, SEED + 13)
    out["ernie"] = step(card, host, (ids[0], None, None, None, mlm[0]))
    del card, host
    card, host = card_and_copy(paddle, lambda: mt_model(
        num_encoder_layers=MT_CHECK_LAYERS,
        num_decoder_layers=MT_CHECK_LAYERS, dropout=0.0)[1],
        "Transformer check", torch.float64)
    src, tgt, lab = mt_pairs(card.cfg, MT_CHECK_PAIRS, MT_CHECK_LEN,
                             SEED + 17)
    out["transformer"] = step(card, host, (src, tgt, lab))
    seen = []
    own = nd.gather_tree

    def recording(ids, parents):
        seen.append((ids.detach().cpu(), parents.detach().cpu()))
        return own(ids, parents)

    beams = []
    nd.gather_tree = recording
    try:
        for model in (card, host):
            paddle.set_device("cpu" if model is host else "gpu")
            s = src[:MT_CHECK_BEAM_BATCH].to(model.parameters()[0].device)
            ids_b, lengths = model.beam_search(s, beam_size=MT_BEAM,
                                               max_len=MT_CHECK_MAX_LEN)
            beams.append((ids_b.cpu(), lengths.cpu()))
    finally:
        nd.gather_tree = own
        paddle.set_device("gpu")
    equal = {"ids": bool(torch.equal(beams[0][0], beams[1][0])),
             "lengths": bool(torch.equal(beams[0][1], beams[1][1])),
             "step_ids": bool(torch.equal(seen[0][0], seen[1][0])),
             "parents": bool(torch.equal(seen[0][1], seen[1][1]))}
    out["beam_equal"] = equal
    out["beam_lengths"] = beams[0][1].tolist()
    for name in ("ernie", "transformer"):
        r = out[name]
        log(f"  {name} float64, card vs CPU copy: losses {r['losses']}, "
            f"relative diff {r['loss_rel']:.3e}; gradients' worst diff over "
            f"their own largest {r['grad_rel']:.3e} ({r['worst']}) (tol "
            f"{TEXT_F64_TOL}) [{card_line}]")
    log(f"  Transformer float64 beam search (batch {MT_CHECK_BEAM_BATCH}, "
        f"beam {MT_BEAM}, max_len {MT_CHECK_MAX_LEN}), card vs CPU copy "
        f"equal: {equal}; lengths {out['beam_lengths']} [{card_line}]")
    if not (out["ernie"]["ok"] and out["transformer"]["ok"]
            and all(equal.values())):
        raise RuntimeError(f"float64 text models on the card disagree with "
                           f"their CPU copies: {out}")
    return out


def check_dropout_f64() -> dict:
    """The dropout kernel's float64 path (the float64 models' dropout on
    the card) against its plain version, bit for bit, forward and
    backward, at the float64 ERNIE check's hidden and attention-output
    shapes; not counted on any path's launches."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    err = 0.0
    for shape in ((ERNIE_CHECK_BATCH, ERNIE_CHECK_SEQ, 768),
                  (ERNIE_CHECK_BATCH, 12, ERNIE_CHECK_SEQ, 64)):
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float64).requires_grad_()
        dy = torch.randn(shape, generator=gen, device="cuda",
                         dtype=torch.float64)
        for p in (0.1, 0.5):
            key = (SEED + 29, int(p * 10))
            y = kd.dropout(x, key, p)
            (g,) = torch.autograd.grad(y, x, dy)
            for got, want in ((y.detach(),
                               kd.dropout_reference(x.detach(), key, p)),
                              (g, kd.dropout_reference(dy, key, p))):
                err = max(err, float((got - want).abs().max()))
    log(f"  dropout kernel, float64, vs plain at {ERNIE_CHECK_BATCH} x "
        f"{ERNIE_CHECK_SEQ} x 768 and the attention output, p 0.1 and 0.5, "
        f"forward and backward: max_abs_err {err:.1e} (tolerance 0)")
    if err:
        raise RuntimeError(f"the float64 dropout kernel differs from its "
                           f"plain version by {err}")
    return {"max_abs_err": err}


def zoo_loss(paddle, model, x, y):
    """Cross-entropy of every output (GoogLeNet's three) on ``y``, summed,
    on float32 logits (float64 ones stay float64)."""
    outs = model(x)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return sum(paddle.nn.functional.cross_entropy(
        o if o.dtype == torch.float64 else o.float(), y) for o in outs)


def zoo_family(paddle, card_line, name, image) -> dict:
    """One factory of leg (e): built on the card from the seed, a CPU copy
    with its weights and buffers, both float64 in training mode: the loss
    of a batch of ZOO_CHECK_BATCH (each package seeded just before its
    forward, for dropout's keys), every gradient and every BatchNorm
    buffer after the forward; then the card's model in bf16 with float32
    masters, ZOO_TRAIN_STEPS + 1 ``Momentum(0.1, 0.9)`` steps at batch
    ZOO_TRAIN_BATCH, the last ZOO_TRAIN_STEPS timed (images/s)."""
    from paddle_tpu_torch.vision import models

    card, host = card_and_copy(
        paddle, lambda: getattr(models, name)(num_classes=RESNET_CLASSES),
        name, torch.float64)
    rng = np.random.RandomState(SEED + 19)
    x = torch.from_numpy(rng.rand(ZOO_CHECK_BATCH, 3, image, image))
    y = torch.from_numpy(rng.randint(0, RESNET_CLASSES, ZOO_CHECK_BATCH))
    t0 = time.perf_counter()
    (l_card, g_card, b_card), (l_host, g_host, b_host) = \
        forward_backward_pair(paddle, (card, host), lambda m, where: zoo_loss(
            paddle, m, x.to(where), y.to(where)), seed=SEED + 23)
    check_s = time.perf_counter() - t0
    loss_rel = abs(l_card - l_host) / abs(l_host)
    g_err, g_name = rel_diff(g_card, g_host, ZERO_GRAD)
    b_err, b_name = rel_diff(b_card, b_host, ZERO_GRAD)
    ok = loss_rel <= TEXT_F64_TOL and g_err <= ZOO_F64_REL and \
        b_err <= ZOO_F64_REL
    del host
    card.to(dtype="bfloat16")
    opt = paddle.optimizer.Momentum(learning_rate=RESNET_LR,
                                    momentum=RESNET_MOMENTUM,
                                    parameters=card.parameters(),
                                    multi_precision=True)
    dev = resolve_device(None)
    xb = torch.rand((ZOO_TRAIN_BATCH, 3, image, image), device=dev,
                    dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    yb = torch.randint(0, RESNET_CLASSES, (ZOO_TRAIN_BATCH,), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    step_ms, train_losses = [], []
    for _ in range(ZOO_TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = zoo_loss(paddle, card, xb, yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        train_losses.append(loss.item())
        step_ms.append((time.perf_counter() - t1) * 1e3)
    ms = float(np.median(step_ms[1:]))
    out = {"loss_rel": loss_rel, "grad_rel": g_err, "worst_grad": g_name,
           "buffer_rel": b_err, "worst_buffer": b_name, "ok": ok,
           "check_s": check_s, "params": sum(p.numel()
                                             for p in card.parameters()),
           "train_ms": ms, "images_per_s": ZOO_TRAIN_BATCH / (ms / 1e3),
           "train_losses": train_losses,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"    {name} ({image} x {image}, {out['params']} parameters): "
        f"float64 loss rel diff {loss_rel:.3e}, gradients {g_err:.3e} "
        f"({g_name}), buffers {b_err:.3e} ({b_name}) in {check_s:.1f} s; "
        f"bf16 Momentum at batch {ZOO_TRAIN_BATCH}: ms a step "
        + ", ".join(f"{t:.2f}" for t in step_ms)
        + f", {out['images_per_s']:.1f} images/s [{card_line}]")
    del card, opt, xb
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_phase(paddle, card_line) -> dict:
    """Leg (e): every family of ZOO through :func:`zoo_family`; fails if
    any float64 check does."""
    log(f"  the vision zoo: float64 training-mode forward and backward at "
        f"batch {ZOO_CHECK_BATCH}, card vs CPU copy (loss within "
        f"{TEXT_F64_TOL}, gradients and BatchNorm buffers within "
        f"{ZOO_F64_REL} of their own largest); then bf16 training speed "
        f"(observations, not targets):")
    out = {name: zoo_family(paddle, card_line, name, image)
           for name, image in ZOO}
    bad = [n for n, r in out.items() if not r["ok"]]
    if bad:
        raise RuntimeError(f"vision models on the card disagree with their "
                           f"CPU copies: {bad}")
    return out


def text_phase(card_line: str, gen) -> dict:
    """Phase 13: (a) ERNIE-3.0-base pretraining, (b) Transformer-base
    training, (c) its beam search, (d) the float64 checks, (e) the vision
    zoo; then the flash kernels at ERNIE's attention shape and the
    LayerNorm kernels at Transformer-base's rows."""
    import paddle_tpu_torch as paddle

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ernie = ernie_pretrain(paddle, card_line, gen)
    gc.collect()
    torch.cuda.empty_cache()
    mt, model, src = mt_train(paddle, card_line, gen)
    beam = mt_beam(paddle, card_line, model, src)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    check = text_f64_check(paddle, card_line)
    gc.collect()
    torch.cuda.empty_cache()
    zoo = zoo_phase(paddle, card_line)
    _, b, h, s, _, d, causal = next(c for c in FLASH_CASES
                                    if c[0] == "ernie")
    flash, _ = time_flash_at(gen, b, h, s, d, causal)
    ln = time_layernorm(gen, "transformer-base")
    seconds = time.perf_counter() - t0
    out = {"ernie": ernie, "transformer": mt, "beam_search": beam,
           "f64_check": check, "zoo": zoo, "flash": flash, "layernorm": ln,
           "seconds": seconds}
    log(f"  phase 13 took {seconds:.1f} s")
    print(json.dumps({"phase13": {
        k: v for k, v in out.items() if k not in ("flash", "layernorm")}}),
        flush=True)
    return out


# ---------------------------------------------------------------- phase 9
# --------------------------------------------------------------- phase 14
# (a) the detection operators of vision.ops at the widths of two public
# detectors. Faster R-CNN R50-FPN on COCO: two 800 x 1344 images, FPN
# levels P2-P5 at strides 4-32, 1,000 RoIs an image, 81 classes
DET_IMAGE, DET_IMAGES, DET_CHANNELS = (800, 1344), 2, 256
DET_LEVELS = (2, 3, 4, 5)
DET_PROPOSALS, DET_ROIS_PER_IMAGE, DET_CLASSES = 2000, 1000, 81
# nms and multiclass_nms take proposals clustered as an RPN's are: around
# DET_OBJECTS seeded objects an image, anchors on the stride grid of each
# object's FPN level within half its side of its centre, sides jittered
DET_OBJECTS, DET_JITTER = 20, 0.1
# YOLOv3-DarkNet53 on COCO at 608, batch 8: COCO's nine anchors, three
# heads of 255 channels (3 x (5 + 80)) at strides 32, 16, 8
YOLO_BATCH, YOLO_IMAGE, YOLO_CLASSES, YOLO_GT = 8, 608, 80, 50
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_HEADS = ((32, [6, 7, 8]), (16, [3, 4, 5]), (8, [0, 1, 2]))
# DCNv2 at ResNet-50's res5 (3 x 3, 512 channels, stride 32 of 800 x 1344),
# R-FCN's position-sensitive pooling (7 x 7 bins x 81 classes at stride
# 16, 300 RoIs), SSD300's priors (VGG-16 maps 38-1, 8,732 priors)
DCN_SHAPE, DCN_OUT = (2, 512, 25, 42), 512
RFCN_SHAPE, RFCN_ROIS, RFCN_BINS = (1, 7 * 7 * 81, 50, 84), 300, 7
SSD_MAPS = ((38, 512), (19, 1024), (10, 512), (5, 256), (3, 256), (1, 256))
SSD_MIN = [30.0, 60.0, 111.0, 162.0, 213.0, 264.0]
SSD_MAX = [60.0, 111.0, 162.0, 213.0, 264.0, 315.0]
SSD_RATIOS = [[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0], [2.0]]
SSD_STEPS = [8.0, 16.0, 32.0, 64.0, 100.0, 300.0]
SSD_GT = 20
# the float64 card-against-CPU limit, of the larger of 1 and the largest
# value (a sum over 10^5 terms in another order moves float64 by ~1e-12
# of it); the float64 roi_align with every RoI on P2 must peak below this
DET_F64_TOL = 1e-10
# prior_box and anchor_generator give float32 whatever their inputs (as the
# reference's): those outputs are held within a float32 step of 1
DET_F32_TOL = 1e-6
DET_PEAK_LIMIT_GIB = 8.0
# (b) LeNet fed by the reader path: paddle.batch(reader.shuffle(
# dataset.mnist.train(), 6000), 64), one epoch of the 6,000 synthetic
# images, Adam(1e-3) (tests/test_hapi_mnist.py's optimizer), accuracy on
# dataset.mnist.test() above that gate's 0.5
LENET_READER_BATCH, LENET_SHUFFLE_BUF, LENET_MIN_ACC = 64, 6000, 0.5
# (c) host transform chains: CIFAR-10's over its 5,000 synthetic images in
# batches of 256, ImageNet's over 512 seeded 3 x 256 x 256 arrays
CIFAR_MEAN, CIFAR_STD = [125.3, 123.0, 113.9], [63.0, 62.1, 66.7]
IMAGENET_MEAN, IMAGENET_STD = [123.675, 116.28, 103.53], [58.395, 57.12,
                                                          57.375]
TRANSFORM_BATCH, IMAGENET_IMAGES = 256, 512


def _flat_tensors(out) -> list:
    """The tensors of an operator's output, nested lists and tuples in
    order."""
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat_tensors(o)]
    return [out]


def card_ops(fn) -> int:
    """The ATen operations ``fn`` runs on the card that are no view: each
    launches one kernel or copy, or a few (a sort, a nonzero). Counted
    under a dispatch mode: ``torch.profiler`` windows this short dropped
    some of the call's device events after the earlier phases' profiles
    (up to 44 a call, whether the window was opened cold, after a warm-up
    step or 50 ms ahead)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Tally(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            schema = func._schema
            writes = any(a.alias_info is not None and a.alias_info.is_write
                         for a in schema.arguments)
            fresh = any(r.alias_info is None for r in schema.returns)
            if (writes or fresh) and any(
                    isinstance(t, torch.Tensor) and t.is_cuda
                    for t in tree_leaves((args, kwargs, out))):
                self.ops += 1
            return out

    with Tally() as tally:
        fn()
    torch.cuda.synchronize()
    return tally.ops


def det_call_readings(fn) -> dict:
    """One call's device operations (:func:`card_ops`), host reads (the
    synchronising calls ``set_sync_debug_mode("warn")`` reports) and the
    greedy sweeps' passes (``vision.ops.sweep_passes``)."""
    import warnings

    import paddle_tpu_torch.vision.ops as ops

    launches = card_ops(fn)
    reads, passes = [0], ops.sweep_passes

    def note(message, *args, **kw):
        # not the once-a-process notice that the debug mode is a prototype
        if "called a synchronizing CUDA operation" in str(message):
            reads[0] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"launches": launches, "host_reads": reads[0],
            "sweep_passes": ops.sweep_passes - passes}


def det_f64_check(label, fn, arrays, grad=()) -> dict:
    """``fn(*tensors)`` in float64 on the card and on a CPU copy of the same
    inputs (``arrays``, host numpy; float ones go to float64): its outputs,
    and with ``grad`` the gradients of ``sum(out * cotangent)`` with
    respect to those inputs. Integer and boolean outputs must be equal;
    float64 ones within DET_F64_TOL of the larger of 1 and their largest
    value, float32 ones (an operator whose output is float32 by
    definition) within DET_F32_TOL of it. Returns the largest errors, and
    the card's peak memory."""
    runs = []
    for dev in ("cuda", "cpu"):
        ts = []
        for i, a in enumerate(arrays):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if t.is_floating_point():
                t = t.double()
            t = t.to(dev)
            ts.append(t.requires_grad_(True) if i in grad else t)
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        outs = _flat_tensors(fn(*ts))
        grads = []
        if grad:
            cot_rng = np.random.RandomState(SEED + 14)
            loss = sum((o * torch.from_numpy(cot_rng.standard_normal(
                tuple(o.shape))).to(dev)).sum()
                for o in outs if o.is_floating_point() and o.requires_grad)
            grads = torch.autograd.grad(loss, [ts[i] for i in grad])
        if dev == "cuda":
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        runs.append([t.detach().cpu() for t in (*outs, *grads)])
    err, err32, equal = 0.0, 0.0, True
    for got, want in zip(*runs):
        if got.shape != want.shape or got.dtype != want.dtype:
            equal = False
        elif not want.is_floating_point():
            equal &= bool(torch.equal(got, want))
        elif want.numel():
            scale = max(1.0, float(want.abs().max()))
            e = float((got.double() - want.double()).abs().max()) / scale
            if want.dtype == torch.float64:
                err = max(err, e)
            else:
                err32 = max(err32, e)
    if not (equal and err <= DET_F64_TOL and err32 <= DET_F32_TOL):
        raise RuntimeError(f"{label}: the card's result disagrees with its "
                           f"CPU copy (indices equal {equal}, float64 error "
                           f"{err:.3e}, limit {DET_F64_TOL}; float32 error "
                           f"{err32:.3e}, limit {DET_F32_TOL})")
    return {"max_err": err, "max_err_f32": err32, "indices_equal": equal,
            "outputs": len(runs[0]), "peak_gib": peak}


def det_op(name, fn, arrays, flush, card_line, grad=()) -> dict:
    """One operator: the float64 check (:func:`det_f64_check`), then in
    float32 on the card the median ms of 20 calls (``time_ms``'s flush
    and sleep; with ``grad``, the forward alone and forward + backward)
    and one call's device operations and host reads
    (:func:`det_call_readings`)."""
    f64 = det_f64_check(name, fn, arrays, grad)
    ts = []
    for i, a in enumerate(arrays):
        t = torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
        t = t.float() if t.dtype == torch.float64 else t
        ts.append(t.requires_grad_(True) if i in grad else t)

    def forward():
        with torch.set_grad_enabled(bool(grad)):
            return fn(*ts)

    def forward_backward():
        outs = [o for o in _flat_tensors(forward()) if o.requires_grad]
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])

    row = {"f64": f64, "ms": time_ms(forward, flush, median=True),
           **det_call_readings(forward)}
    if grad:
        row["fwd_bwd_ms"] = time_ms(forward_backward, flush, median=True)
        row["fwd_bwd"] = det_call_readings(forward_backward)
    f32_out = (f"; float32 outputs {f64['max_err_f32']:.3e}"
               if f64["max_err_f32"] else "")
    sweeps = (f" ({row['sweep_passes']} sweep passes)"
              if row["sweep_passes"] else "")
    log(f"  {name}: float64 vs CPU copy {f64['max_err']:.3e}{f32_out} "
        f"(indices equal: {f64['indices_equal']}); float32 {row['ms']:.4f} ms "
        f"median, {row['launches']} device ops, {row['host_reads']} host "
        f"reads{sweeps} a call"
        + (f"; forward + backward {row['fwd_bwd_ms']:.4f} ms, "
           f"{row['fwd_bwd']['launches']} ops, {row['fwd_bwd']['host_reads']}"
           f" reads" if grad else "")
        + f" [{card_line}]")
    return row


def det_boxes(rng, n, height, width, least, most):
    """``n`` boxes (x1, y1, x2, y2) inside a ``height`` x ``width`` image,
    sides drawn from [least, most)."""
    wh = rng.uniform(least, most, (n, 2))
    x1 = rng.uniform(0, np.maximum(width - wh[:, 0], 1))
    y1 = rng.uniform(0, np.maximum(height - wh[:, 1], 1))
    return np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], 1)


def rpn_proposals(rng, n, height, width, objects):
    """``n`` proposals (x1, y1, x2, y2) shaped as a region-proposal
    network's top ``n`` in one ``height`` x ``width`` image: ``objects``
    seeded objects, sides log-uniform in [32, 512); around each, anchors
    on the stride grid of its FPN level (``refer_level`` 4 at 224, levels
    2-5) within half its side of its centre, sides jittered by a
    log-normal of DET_JITTER, scores peaking where position and size
    match the object, plus noise. Returns the boxes, the scores and each
    box's object."""
    per = np.full(objects, n // objects)
    per[:n - per.sum()] += 1
    boxes, scores = [], []
    for m in per:
        side = np.exp(rng.uniform(np.log(32), np.log(512), 2))
        level = np.clip(np.floor(4 + np.log2(np.sqrt(side.prod()) / 224)),
                        2, 5)
        stride = 2.0 ** level
        cx, cy = rng.uniform(side / 2, [width - side[0] / 2,
                                        height - side[1] / 2])
        dx, dy = (np.round(rng.uniform(-0.5, 0.5, (2, m)) * side[:, None]
                           / stride) * stride)
        wh = side * np.exp(rng.normal(0, DET_JITTER, (m, 2)))
        boxes.append(np.stack([cx + dx - wh[:, 0] / 2, cy + dy - wh[:, 1] / 2,
                               cx + dx + wh[:, 0] / 2,
                               cy + dy + wh[:, 1] / 2], 1))
        off = ((dx / side[0]) ** 2 + (dy / side[1]) ** 2
               + (np.log(wh / side) ** 2).sum(1))
        scores.append(rng.uniform(0.6, 1.0) * np.exp(-off / 0.1)
                      + rng.uniform(0, 0.05, m))
    b = np.concatenate(boxes)
    b[:, 0::2] = b[:, 0::2].clip(0, width)
    b[:, 1::2] = b[:, 1::2].clip(0, height)
    return b, np.concatenate(scores), np.repeat(np.arange(objects), per)


def detection_ops(card_line) -> dict:
    """Leg (a): the operators at Faster R-CNN's, YOLOv3's, DCNv2's,
    R-FCN's and SSD300's widths."""
    import paddle_tpu_torch.vision.ops as ops

    rng = np.random.RandomState(SEED + 14)
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    h, w = DET_IMAGE
    out = {}
    before = ops.sweep_passes
    # Faster R-CNN R50-FPN
    props, scores, _ = rpn_proposals(rng, DET_PROPOSALS, h, w, DET_OBJECTS)
    out["nms"] = det_op(
        f"nms (2,000 RPN-shaped proposals around {DET_OBJECTS} objects, "
        f"IoU 0.7)",
        lambda b, s: ops.nms(b, 0.7, s), [props, scores], flush, card_line)
    rois = det_boxes(rng, DET_IMAGES * DET_ROIS_PER_IMAGE, h, w, 8, 700)
    out["distribute_fpn_proposals"] = det_op(
        "distribute_fpn_proposals (1,000 RoIs an image, levels 2-5)",
        lambda r: ops.distribute_fpn_proposals(r, 2, 5, 4, 224), [rois],
        flush, card_line)
    levels = ops.distribute_fpn_proposals(torch.from_numpy(rois), 2, 5, 4,
                                          224)[1]
    feats = {lvl: rng.standard_normal((DET_IMAGES, DET_CHANNELS,
                                       -(-h // 2 ** lvl), -(-w // 2 ** lvl)))
             .astype(np.float32) for lvl in DET_LEVELS}
    for lvl, idx in zip(DET_LEVELS, levels):
        idx = idx.numpy()
        num = np.bincount(idx // DET_ROIS_PER_IMAGE, minlength=DET_IMAGES)
        out[f"roi_align_p{lvl}"] = det_op(
            f"roi_align P{lvl} {list(feats[lvl].shape)}, {len(idx)} RoIs "
            f"{num.tolist()}, 7 x 7, ratio 2, aligned",
            lambda x, r, n, s=0.5 ** lvl: ops.roi_align(x, r, n, 7, s, 2),
            [feats[lvl], rois[idx], num], flush, card_line, grad=(0,))
    num = np.full(DET_IMAGES, DET_ROIS_PER_IMAGE)
    out["roi_align_p2_all"] = det_op(
        f"roi_align P2, all {len(rois)} RoIs (the memory worst case)",
        lambda x, r, n: ops.roi_align(x, r, n, 7, 0.25, 2),
        [feats[2], rois, num], flush, card_line, grad=(0,))
    peak = out["roi_align_p2_all"]["f64"]["peak_gib"]
    per_roi = len(rois) * feats[2][0].size * 8 / 2**30
    log(f"  roi_align P2 float64 forward + backward with all {len(rois)} "
        f"RoIs: peak {peak:.3f} GiB above its inputs (limit "
        f"{DET_PEAK_LIMIT_GIB}); a copy of P2 a RoI would be {per_roi:.1f} "
        f"GiB")
    if not peak < DET_PEAK_LIMIT_GIB:
        raise RuntimeError(f"roi_align on P2 peaked at {peak:.3f} GiB")
    deltas = rng.standard_normal((DET_ROIS_PER_IMAGE, 4)) * 0.5
    var = np.tile([0.1, 0.1, 0.2, 0.2], (DET_ROIS_PER_IMAGE, 1))
    out["box_coder"] = det_op(
        "box_coder (decode 1,000 boxes, pixel coordinates)",
        lambda p, v, d: ops.box_coder(p, v, d, "decode_center_size", False),
        [rois[:DET_ROIS_PER_IMAGE], var, deltas], flush, card_line,
        grad=(2,))
    # each RoI scores its object's class by the RPN's score; the other
    # classes draw low scores, about one in six above the threshold
    det, det_s, det_obj = rpn_proposals(rng, DET_ROIS_PER_IMAGE, h, w,
                                        DET_OBJECTS)
    cls_scores = rng.rand(DET_CLASSES, DET_ROIS_PER_IMAGE) ** 4 * 0.1
    cls_of = rng.randint(1, DET_CLASSES, DET_OBJECTS)
    cls_scores[cls_of[det_obj], np.arange(DET_ROIS_PER_IMAGE)] = det_s
    out["multiclass_nms"] = det_op(
        f"multiclass_nms (1,000 RPN-shaped RoIs around {DET_OBJECTS} "
        f"objects, scores [81, 1000], threshold 0.05, top 1,000 / 100, "
        f"IoU 0.5)",
        lambda b, s: ops.multiclass_nms(b, s, 0.05, 1000, 100, 0.5, False),
        [det, cls_scores], flush, card_line)
    out["anchor_generator"] = det_op(
        "anchor_generator ([1, 1024, 50, 84], sizes 32-512, ratios 0.5-2, "
        "stride 16)",
        lambda f: ops.anchor_generator(f, [32, 64, 128, 256, 512],
                                       [0.5, 1.0, 2.0], [0.1, 0.1, 0.2, 0.2],
                                       [16.0, 16.0]),
        [np.zeros((1, 1024, 50, 84), np.float32)], flush, card_line)
    # YOLOv3
    img = np.full((YOLO_BATCH, 2), YOLO_IMAGE, np.int32)
    gt = np.concatenate([rng.uniform(0.02, 0.98, (YOLO_BATCH, YOLO_GT, 2)),
                         rng.uniform(0.01, 0.6, (YOLO_BATCH, YOLO_GT, 2))],
                        -1)
    labels = rng.randint(0, YOLO_CLASSES, (YOLO_BATCH, YOLO_GT))
    for stride, mask in YOLO_HEADS:
        side = YOLO_IMAGE // stride
        head = rng.standard_normal((YOLO_BATCH, 3 * (5 + YOLO_CLASSES), side,
                                    side)).astype(np.float32)
        anchors = [YOLO_ANCHORS[2 * m + k] for m in mask for k in (0, 1)]
        out[f"yolo_box_{side}"] = det_op(
            f"yolo_box [8, 255, {side}, {side}], conf 0.005",
            lambda x, s, a=anchors, d=stride: ops.yolo_box(
                x, s, a, YOLO_CLASSES, 0.005, d), [head, img], flush,
            card_line)
        out[f"yolo_loss_{side}"] = det_op(
            f"yolo_loss [8, 255, {side}, {side}], 50 boxes an image",
            lambda x, g, lab, m=mask, d=stride: ops.yolo_loss(
                x, g, lab, YOLO_ANCHORS, m, YOLO_CLASSES, 0.7, d),
            [head, gt, labels], flush, card_line, grad=(0,))
    # DCNv2, R-FCN
    n, c, fh, fw = DCN_SHAPE
    out["deform_conv2d"] = det_op(
        f"deform_conv2d x {list(DCN_SHAPE)}, weight [512, 512, 3, 3], "
        f"offset and mask, padding 1",
        lambda x, o, wt, b, m: ops.deform_conv2d(x, o, wt, b, 1, 1, 1, 1, 1,
                                                 m),
        [rng.standard_normal(DCN_SHAPE).astype(np.float32),
         rng.standard_normal((n, 18, fh, fw)).astype(np.float32) * 2,
         (rng.standard_normal((DCN_OUT, c, 3, 3)) / np.sqrt(9 * c))
         .astype(np.float32),
         rng.standard_normal(DCN_OUT).astype(np.float32),
         rng.rand(n, 9, fh, fw).astype(np.float32)],
        flush, card_line, grad=(0, 1, 2, 3, 4))
    out["psroi_pool"] = det_op(
        f"psroi_pool {list(RFCN_SHAPE)}, {RFCN_ROIS} RoIs, 7 x 7",
        lambda x, r, k: ops.psroi_pool(x, r, k, RFCN_BINS, 1 / 16),
        [rng.standard_normal(RFCN_SHAPE).astype(np.float32),
         det_boxes(rng, RFCN_ROIS, h, w, 16, 600), np.array([RFCN_ROIS])],
        flush, card_line)
    # SSD300
    image = np.zeros((1, 3, 300, 300), np.float32)

    def priors(im, *maps):
        return torch.cat([ops.prior_box(
            f, im, [SSD_MIN[i]], [SSD_MAX[i]], SSD_RATIOS[i],
            flip=True, clip=True, steps=(SSD_STEPS[i],) * 2)[0].reshape(-1, 4)
            for i, f in enumerate(maps)])

    maps = [np.zeros((1, ch, side, side), np.float32)
            for side, ch in SSD_MAPS]
    out["prior_box"] = det_op("prior_box (SSD300's six maps, 8,732 priors)",
                              priors, [image, *maps], flush, card_line)
    prior = priors(torch.from_numpy(image),
                   *map(torch.from_numpy, maps)).numpy()
    if len(prior) != 8732:
        raise RuntimeError(f"SSD300 has 8,732 priors, not {len(prior)}")
    gt_ssd = det_boxes(rng, SSD_GT, 1.0, 1.0, 0.05, 0.5)
    out["iou_similarity"] = det_op(
        "iou_similarity (20 boxes x 8,732 priors)",
        lambda a, b: ops.iou_similarity(a, b), [gt_ssd, prior], flush,
        card_line)
    iou = ops.iou_similarity(torch.from_numpy(gt_ssd),
                             torch.from_numpy(prior)).numpy()
    out["bipartite_match"] = det_op(
        "bipartite_match ([20, 8732], per_prediction 0.5)",
        lambda d: ops.bipartite_match(d, "per_prediction", 0.5), [iou],
        flush, card_line)
    out["box_clip"] = det_op(
        "box_clip (8,732 priors in pixels, one 300 x 300 image)",
        lambda b, info: ops.box_clip(b, info),
        [(prior * 320 - 10)[None], np.array([[300.0, 300.0, 1.0]])], flush,
        card_line)
    out["sweep_passes"] = ops.sweep_passes - before
    return out


def lenet_reader(paddle, card_line) -> dict:
    """Leg (b): LeNet trained on the card from ``paddle.batch(paddle.reader.
    shuffle(paddle.dataset.mnist.train(), 6000), 64)`` for one epoch, its
    first step's loss held against a CPU copy fed the same batch
    (``card_and_copy``; BERT_CHECK_TOL's loss limit), then accuracy on
    ``paddle.dataset.mnist.test()``. The epoch's optimizer runs the fused
    Adam kernel in a layout no other phase trains (float32 parameters and
    gradients, no decay, no bf16 copy), so first the kernel is held to its
    plain version bit for bit at LeNet's parameter sizes in that layout
    (:func:`adam_vs_plain`); the counters are set to 0 just before the
    epoch and must show the optimizer's plan each step and nothing else."""
    import random

    from paddle_tpu_torch.vision.models import LeNet

    random.seed(SEED)
    feed = paddle.batch(paddle.reader.shuffle(paddle.dataset.mnist.train(),
                                              LENET_SHUFFLE_BUF),
                        LENET_READER_BATCH)

    def tensors(batch, dev):
        x = np.stack([s[0] for s in batch]).reshape(-1, 1, 28, 28)
        y = np.asarray([s[1] for s in batch], np.int64)
        return (torch.from_numpy(x).to(dev, non_blocking=True),
                torch.from_numpy(y).to(dev, non_blocking=True))

    card, host = card_and_copy(paddle, LeNet, "LeNet (reader path)",
                               torch.float32)
    sizes = [p.numel() for p in card.parameters()]
    adam_err, adam_made = adam_vs_plain(
        torch.Generator(device="cuda").manual_seed(SEED + 14), sizes,
        lambda i: (torch.float32, 1.0, False))
    log(f"  adam vs plain at LeNet's {len(sizes)} parameter shapes "
        f"({sum(sizes)} elements; float32 gradients and parameters, no "
        f"decay, no bf16 copy, default betas) in {adam_made} launch(es) of "
        f"the plan: p, m, v equal bit for bit (max_abs_err {adam_err:.1e}; "
        f"tolerance 0)")
    plan = fo.adam_launch_plan(sizes, [torch.float32] * len(sizes),
                               fo.kernel_param_bytes())
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=card.parameters())
    losses, first_diff = [], None
    reset_counters()          # every kernel's count, just before the path
    t0 = time.perf_counter()
    for step, batch in enumerate(feed()):
        x, y = tensors(batch, "cuda")
        loss = ce_loss(paddle, card, x, y)
        if step == 0:
            paddle.set_device("cpu")
            hx, hy = tensors(batch, "cpu")
            want = float(ce_loss(paddle, host, hx, hy).detach())
            paddle.set_device("gpu")
            first_diff = abs(loss.item() - want)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    losses = [float(v) for v in losses]
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(counts, {"adam": len(losses) * len(plan),
                            "adam_tensors": len(losses) * len(sizes)},
                   "LeNet's epoch on the reader path")
    card.eval()
    right = total = 0
    with torch.no_grad():
        for batch in paddle.batch(paddle.dataset.mnist.test(), 500)():
            x, y = tensors(batch, "cuda")
            right += int((card(x).argmax(-1) == y).sum())
            total += len(batch)
    acc = right / total
    out = {"steps": len(losses), "first_loss": losses[0],
           "last_loss": losses[-1], "first_loss_vs_cpu": first_diff,
           "accuracy": acc, "test_images": total, "seconds": seconds,
           "adam_vs_plain": {"max_abs_err": adam_err, "launches": adam_made,
                             "tensors": len(sizes)},
           "adam_launches": counts["adam"]}
    log(f"  LeNet from paddle.batch(reader.shuffle(dataset.mnist.train(), "
        f"{LENET_SHUFFLE_BUF}), {LENET_READER_BATCH}), one epoch on the card "
        f"(Adam 1e-3): {len(losses)} steps in {seconds:.2f} s, "
        f"{counts['adam']} fused Adam launches, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; first step against its CPU "
        f"copy {first_diff:.3e} (tol {BERT_CHECK_TOL['loss']}); accuracy on "
        f"mnist.test() {acc:.4f} of {total} (gate {LENET_MIN_ACC}) "
        f"[{card_line}]")
    if not (first_diff <= BERT_CHECK_TOL["loss"] and acc > LENET_MIN_ACC):
        raise RuntimeError(f"LeNet on the reader path: {out}")
    return out


def transform_rates(paddle, card_line, resnet_images_per_s) -> dict:
    """Leg (c): images/s on the host of two transform chains, beside
    phase 12's ResNet-50 training rate on the card."""
    T = paddle.vision.transforms
    np.random.seed(SEED)
    cifar = paddle.vision.datasets.Cifar10(transform=T.Compose([
        T.RandomCrop(32, padding=4), T.RandomHorizontalFlip(),
        T.Normalize(CIFAR_MEAN, CIFAR_STD)]))
    batches = paddle.io.BatchSampler(
        sampler=paddle.io.RandomSampler(cifar), batch_size=TRANSFORM_BATCH)
    t0 = time.perf_counter()
    n = sum(len([cifar[i] for i in b]) for b in batches)
    cifar_rate = n / (time.perf_counter() - t0)
    imgs = np.random.RandomState(SEED).rand(IMAGENET_IMAGES, 3, 256,
                                            256).astype(np.float32) * 255
    data = paddle.io.TensorDataset([imgs])
    chain = T.Compose([T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
                       T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])
    t0 = time.perf_counter()
    shapes = {chain(data[i][0]).shape for i in range(len(data))}
    imagenet_rate = len(data) / (time.perf_counter() - t0)
    if shapes != {(3, 224, 224)}:
        raise RuntimeError(f"the ImageNet chain gave shapes {shapes}")
    out = {"cifar10_images_per_s": cifar_rate, "cifar10_images": n,
           "imagenet_images_per_s": imagenet_rate,
           "resnet50_train_images_per_s": resnet_images_per_s}
    log(f"  host transforms (one process): CIFAR-10 (RandomCrop 32 pad 4, "
        f"flip, Normalize; {n} images in batches of {TRANSFORM_BATCH}) "
        f"{cifar_rate:.1f} images/s; ImageNet (RandomResizedCrop 224, flip, "
        f"Normalize; {len(data)} 3 x 256 x 256) {imagenet_rate:.1f} "
        f"images/s; ResNet-50 trains at {resnet_images_per_s:.1f} images/s "
        f"on the card (phase 12) [{card_line}]")
    return out


def data_phase(card_line: str, resnet_images_per_s: float) -> dict:
    """Phase 14: (a) the detection operators at full width, (b) LeNet fed
    by the reader path, (c) the host transforms' rate."""
    import paddle_tpu_torch as paddle

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    det = detection_ops(card_line)
    gc.collect()
    torch.cuda.empty_cache()
    lenet = lenet_reader(paddle, card_line)
    rates = transform_rates(paddle, card_line, resnet_images_per_s)
    seconds = time.perf_counter() - t0
    out = {"detection": det, "lenet_reader": lenet, "transforms": rates,
           "seconds": seconds,
           "script_seconds": time.perf_counter() - T_START}
    log(f"  phase 14 took {seconds:.1f} s (the script {out['script_seconds']:.1f}"
        f" s so far)")
    print(json.dumps({"phase14": out}), flush=True)
    return out


# ---------------------------------------------------------------- phase 15
# the training surface: ERNIE-3.0-base fine-tuned for sequence
# classification through paddle.Model.fit under amp O1, at CLUE TNEWS's
# shape as PaddleNLP fine-tunes ERNIE 3.0 on it (15 classes, max_seq_length
# 128, batch 32), on a seeded synthetic set
HAPI_CLASSES, HAPI_SEQ, HAPI_BATCH = 15, 128, 32
HAPI_TRAIN, HAPI_EVAL, HAPI_EPOCHS = 1280, 320, 2
HAPI_LR, HAPI_WD, HAPI_WARMUP = 5e-5, 0.01, 10
HAPI_WORKERS, HAPI_O2_STEPS, HAPI_PROFILED_STEPS = 2, 10, 3
# the first token of an example names its class (token 100 + class) and
# fills half of its other positions; the rest are drawn past the class
# tokens
HAPI_CLASS_TOKEN, HAPI_CLASS_SHARE = 100, 0.5
# (a) float64, card against a CPU copy (phase 13 (d)'s rule: loss within
# TEXT_F64_TOL of itself, each parameter after the step within it of its
# own largest, one whose largest is below ZERO_GRAD of the model's largest
# held against the model's largest)
HAPI_CHECK_LAYERS, HAPI_CHECK_BATCH = 2, 2
# (c) the loaded program's float32 logits against eager float32 (the same
# kernels and products, so rounding alone)
HAPI_JIT_TOL = 1e-3
# (d) LeNet under float16 with a GradScaler, an inf gradient at one step
LENET_FP16_BATCH, LENET_FP16_STEPS, LENET_INF_STEP = 64, 6, 3
LENET_FP16_SCALE = 2.0 ** 15
# (f) phase 14 (c)'s ImageNet chain through the DataLoader
LOADER_WORKERS, LOADER_BATCH = (0, 2, 4), 64


class TnewsLike:
    """``n`` examples of ``input_ids`` and ``token_type_ids`` (length
    HAPI_SEQ, the second half of type 1) and a label: the class named by
    the first token (``ids[0] - HAPI_CLASS_TOKEN``), which also fills a
    random HAPI_CLASS_SHARE of the other positions (a signal that a
    randomly initialised encoder carries to its pooled output); the rest
    drawn from the vocabulary past the class tokens. No padding (so
    attention takes the flash kernels). Host numpy, as a dataset the
    loader's workers read."""

    def __init__(self, n, vocab, seed):
        rng = np.random.RandomState(seed)
        self.labels = rng.randint(0, HAPI_CLASSES, (n, 1)).astype(np.int64)
        self.ids = rng.randint(HAPI_CLASS_TOKEN + HAPI_CLASSES, vocab,
                               (n, HAPI_SEQ)).astype(np.int64)
        named = rng.rand(n, HAPI_SEQ) < HAPI_CLASS_SHARE
        named[:, 0] = True
        self.ids = np.where(named, HAPI_CLASS_TOKEN + self.labels,
                            self.ids).astype(np.int64)
        self.types = np.zeros((n, HAPI_SEQ), np.int64)
        self.types[:, HAPI_SEQ // 2:] = 1

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.ids[i], self.types[i], self.labels[i]


class ImageNetChain:
    """Phase 14 (c)'s ImageNet transform chain over 3 x 256 x 256 arrays,
    applied where the loader fetches (in its workers)."""

    def __init__(self, images, chain):
        self.images, self.chain = images, chain

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.chain(self.images[i])


@contextlib.contextmanager
def sync_sites():
    """Count the card's synchronising calls inside, by the innermost line
    of the checkout that made them (``set_sync_debug_mode("warn")``); the
    counter is yielded and stays live."""
    import warnings

    here = os.path.dirname(os.path.abspath(__file__))
    sites = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frame = next((f for f in reversed(traceback.extract_stack()[:-1])
                      if f.filename.startswith(here + os.sep)
                      and "chip_smoke" not in f.filename), None)
        sites[f"{os.path.relpath(frame.filename, here)}:{frame.lineno}"
              if frame else f"{filename}:{lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def launch_dtypes():
    """The dtypes each kernel entry point was called with inside (its
    first tensor's), by kernel."""
    seen = collections.defaultdict(set)
    patched = [(fa, "flash_attention_forward", "flash_fwd"),
               (fa, "flash_attention_backward", "flash_bwd"),
               (fl, "layer_norm_forward", "ln_fwd"),
               (fl, "layer_norm_backward", "ln_bwd"),
               (kd, "dropout_forward", "dropout_fwd"),
               (kd, "dropout_backward", "dropout_bwd")]
    own = [getattr(m, n) for m, n, _ in patched]
    for (m, n, tag), fn in zip(patched, own):
        def rec(x, *a, _fn=fn, _tag=tag, **k):
            seen[_tag].add(str(x.dtype).replace("torch.", ""))
            return _fn(x, *a, **k)
        setattr(m, n, rec)
    try:
        yield seen
    finally:
        for (m, n, _), fn in zip(patched, own):
            setattr(m, n, fn)


def hapi_expected(model, layers) -> dict:
    """A fine-tuning step of ERNIE with L layers: the flash forward and
    backward once a layer; the LayerNorm forward, backward kernel and
    reduction 2L + 1 times (the embeddings, two a layer); dropout (0.1)
    forward and backward 3L + 2 times (the embeddings; a layer's attention
    output and its two residual branches; the classifier's input; the
    feed-forward's own dropout is 0); fused Adam by its plan over every
    parameter (each takes a gradient, float32 under O1). No plain
    version."""
    params = model.parameters()
    plan = fo.adam_launch_plan([p.numel() for p in params],
                               [torch.float32] * len(params),
                               fo.kernel_param_bytes())
    ln, drop = 2 * layers + 1, 3 * layers + 2
    return {"flash_fwd": layers, "flash_bwd": layers, "ln_fwd": ln,
            "ln_dx": ln, "ln_reduce": ln, "dropout_fwd": drop,
            "dropout_bwd": drop, "adam": len(plan),
            "adam_tensors": len(params)}


def hapi_f64_check(paddle, card_line) -> dict:
    """Leg (a): ERNIE at base width with HAPI_CHECK_LAYERS layers and 15
    classes through ``Model.train_batch`` in float64 on the card and on a
    CPU copy (``set_state_dict``), one AdamW step each, both seeded just
    before it: the float64 loss (taken before the step's float32 cast)
    and every parameter after the step."""
    from paddle_tpu_torch.text import (ErnieForSequenceClassification,
                                       ernie_config)

    card, host = card_and_copy(paddle, lambda: ErnieForSequenceClassification(
        ernie_config("ernie-3.0-base", num_layers=HAPI_CHECK_LAYERS),
        num_classes=HAPI_CLASSES), "hapi check", torch.float64)
    data = TnewsLike(HAPI_CHECK_BATCH, card.ernie.cfg.vocab_size, SEED + 21)
    batch = [data[i] for i in range(HAPI_CHECK_BATCH)]
    ids, types, labels = (np.stack([b[k] for b in batch]) for k in range(3))
    losses, params = [], []
    for model, where in ((card, "gpu"), (host, "cpu")):
        paddle.set_device(where)
        seen = []
        ce = paddle.nn.CrossEntropyLoss()

        def loss_fn(logits, label, _ce=ce, _seen=seen):
            out = _ce(logits, label)
            _seen.append(out.detach().cpu().item())
            return out

        m = paddle.Model(model)
        m.prepare(paddle.optimizer.AdamW(
            learning_rate=HAPI_LR, weight_decay=HAPI_WD,
            parameters=model.parameters()), loss_fn)
        paddle.seed(SEED + 5)
        m.train_batch([ids, types], [labels])
        losses.append(seen[0])
        params.append({n: p.detach().cpu() for n, p in
                       model.named_parameters()})
    paddle.set_device("gpu")
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    p_err, p_name = rel_diff(params[0], params[1], ZERO_GRAD)
    out = {"losses": losses, "loss_rel": loss_rel, "param_rel": p_err,
           "worst": p_name}
    log(f"  (a) ERNIE-base x {HAPI_CHECK_LAYERS} layers, {HAPI_CLASSES} "
        f"classes, float64 Model.train_batch (AdamW {HAPI_LR}), card vs CPU "
        f"copy: losses {losses}, relative diff {loss_rel:.3e}; parameters "
        f"after the step, worst diff over their own largest {p_err:.3e} "
        f"({p_name}) (tol {TEXT_F64_TOL}) [{card_line}]")
    if not (loss_rel <= TEXT_F64_TOL and p_err <= TEXT_F64_TOL):
        raise RuntimeError(f"float64 Model.train_batch on the card disagrees "
                           f"with its CPU copy: {out}")
    return out


def hapi_fit(paddle, card_line, train, evals) -> dict:
    """Leg (b): the main path. ``Model.fit`` of ERNIE-3.0-base, 15
    classes, AdamW under LinearWarmup, amp O1, fed by a multiprocess
    DataLoader, with the LRScheduler, ModelCheckpoint and VisualDL
    callbacks. The second epoch is timed: the counters set to 0 just
    before its first step and read after its last, the card's host reads
    counted and each kernel's launch dtypes recorded over it."""
    from paddle_tpu_torch.text import (ErnieForSequenceClassification,
                                       ernie_config)
    from paddle_tpu_torch.optimizer.lr import LinearWarmup as Warmup

    paddle.set_device("gpu")
    paddle.seed(SEED)
    cfg = ernie_config("ernie-3.0-base")
    net = ErnieForSequenceClassification(cfg, num_classes=HAPI_CLASSES)
    layers = cfg.num_layers
    sched = Warmup(HAPI_LR, HAPI_WARMUP, 0.0, HAPI_LR)
    opt = paddle.optimizer.AdamW(learning_rate=sched, weight_decay=HAPI_WD,
                                 parameters=net.parameters())
    model = paddle.Model(net)
    model.prepare(opt, paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy(),
                  amp_configs="O1")
    want = hapi_expected(net, layers)
    steps = len(train) // HAPI_BATCH
    log(f"  (b) expected launches a step, written before the run: "
        f"{json.dumps(want)}; every plain version 0")
    n_params = sum(p.numel() for p in net.parameters())

    class TimedLoader(paddle.io.DataLoader):
        """A ``DataLoader`` that notes the seconds its consumer waited on
        each batch (``waits``). (Defined here: ``--turns`` runs this
        script with checkouts whose ``io`` has no ``DataLoader``.)"""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.waits = []

        def __iter__(self):
            it = super().__iter__()
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.waits.append(time.perf_counter() - t0)
                yield batch

    loader = TimedLoader(train, batch_size=HAPI_BATCH, shuffle=True,
                         num_workers=HAPI_WORKERS, timeout=120)
    state = {"epoch": 0, "ends": [], "losses": []}
    stack = contextlib.ExitStack()

    class Timed(paddle.callbacks.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            state["epoch"] = epoch
            if epoch == HAPI_EPOCHS - 1:
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counters()  # just before the timed epoch's path
                state["sites"] = stack.enter_context(sync_sites())
                state["dtypes"] = stack.enter_context(launch_dtypes())
                state["wait0"] = len(loader.waits)
            state["t_begin"] = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            now = time.perf_counter()
            state["ends"].append((state["epoch"], now))
            state["losses"].append(logs["loss"])
            if state["epoch"] == HAPI_EPOCHS - 1 and step == steps - 1:
                state["launches"] = launch_counts()
                state["peak"] = torch.cuda.max_memory_allocated()
                stack.close()

    tmp = tempfile.mkdtemp(prefix="hapi_fit_")
    try:
        t0 = time.perf_counter()
        model.fit(loader, evals, batch_size=HAPI_BATCH, epochs=HAPI_EPOCHS,
                  num_workers=HAPI_WORKERS, verbose=0, callbacks=[
                      paddle.callbacks.LRScheduler(), Timed(),
                      paddle.callbacks.ModelCheckpoint(
                          save_freq=HAPI_EPOCHS, save_dir=tmp),
                      paddle.callbacks.VisualDL(tmp)])
        fit_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            records = [json.loads(x) for x in f]
        saved = sorted(os.listdir(tmp))
    finally:
        stack.close()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = state["launches"]
    check_launches(launches, {k: v * steps for k, v in want.items()},
                   f"{steps} Model.fit steps (epoch {HAPI_EPOCHS})")
    ends = [t for e, t in state["ends"] if e == HAPI_EPOCHS - 1]
    step_ms = np.diff(ends) * 1e3
    ms = float(np.median(step_ms))
    waits = loader.waits[state["wait0"]:state["wait0"] + steps]
    losses = state["losses"]
    first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    tokens = HAPI_BATCH * HAPI_SEQ
    flops_tok = 6 * n_params + 12 * layers * HAPI_SEQ * cfg.hidden_size
    mfu = flops_tok * tokens / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    reads = sum(state["sites"].values())
    eval_acc = records[-1].get("eval_acc")
    dtypes = {k: sorted(v) for k, v in state["dtypes"].items()}
    out = {"ms": ms, "step_ms": step_ms.tolist(),
           "sequences_per_s": HAPI_BATCH / (ms / 1e3),
           "tokens_per_s": tokens / (ms / 1e3), "mfu": mfu,
           "flops_per_token": flops_tok, "params": n_params,
           "peak_gib": state["peak"] / 2**30,
           "host_reads_per_step": reads / steps,
           "host_read_sites": dict(state["sites"]),
           "loader_wait_ms_per_step": 1e3 * float(np.mean(waits)),
           "loader_wait_ms_median": 1e3 * float(np.median(waits)),
           "loader_wait_ms_first": 1e3 * waits[0],
           "launches_per_step": {k: v // steps for k, v in launches.items()
                                 if v},
           "expected_per_step": want, "dtypes": dtypes,
           "first10_loss": first10, "last10_loss": last10,
           "eval_acc": eval_acc, "chance": 1 / HAPI_CLASSES,
           "visualdl_records": len(records), "checkpoints": saved,
           "fit_s": fit_s}
    log(f"  (b) ERNIE-3.0-base ({n_params} parameters), {HAPI_CLASSES} "
        f"classes, batch {HAPI_BATCH} x {HAPI_SEQ}, Model.fit {HAPI_EPOCHS} "
        f"epochs of {steps} steps, AdamW {HAPI_LR} (warm-up {HAPI_WARMUP}), "
        f"amp O1, DataLoader with {HAPI_WORKERS} workers: {fit_s:.1f} s; "
        f"epoch {HAPI_EPOCHS} median {ms:.3f} ms a step "
        f"({out['sequences_per_s']:.1f} sequences/s, MFU {mfu:.4f} at "
        f"6N + 12 L s h = {flops_tok} flops a token), peak "
        f"{out['peak_gib']:.3f} GiB, {out['host_reads_per_step']:.2f} host "
        f"reads a step (by line {dict(state['sites'])}), the loader "
        f"waited {out['loader_wait_ms_per_step']:.3f} ms a step (median "
        f"{out['loader_wait_ms_median']:.3f}; the epoch's first batch, its "
        f"workers' fork included, {out['loader_wait_ms_first']:.3f}); "
        f"launches a "
        f"step {json.dumps(out['launches_per_step'])}; launch dtypes "
        f"{json.dumps(dtypes)}; loss first 10 {first10:.4f}, last 10 "
        f"{last10:.4f}; eval accuracy {eval_acc} (chance "
        f"{1 / HAPI_CLASSES:.4f}); VisualDL records {len(records)}, "
        f"checkpoints {saved} [{card_line}]")
    if not (last10 < first10 and dtypes.get("flash_fwd") == ["bfloat16"]
            and dtypes.get("ln_fwd") == ["float32"]
            and np.isfinite(losses).all()
            and {"0.pdparams", "final.pdparams"} <= set(saved)):
        raise RuntimeError(f"Model.fit under amp O1: {out}")
    return out, model, opt


def hapi_jit(paddle, card_line, net, batch) -> dict:
    """Leg (c): ``to_static`` of the fine-tuned network in eval, under amp
    O1, bit for bit against its eager logits; then ``jit.save`` with the
    spec of a batch and ``jit.load``: the loaded program's float32 logits
    within HAPI_JIT_TOL of eager float32, and the flash and LayerNorm
    forward counters grown by one eval forward's launches (L and 2L + 1)
    when it runs."""
    ids, types = batch
    layers = net.ernie.cfg.num_layers
    net.eval()
    with torch.no_grad(), paddle.amp.auto_cast(level="O1"):
        eager = net(ids, types)
        paddle.jit.to_static(net)
        static = net.forward_traced(ids, types)
    with torch.no_grad():
        eager32 = net(ids, types)
    spec = [paddle.jit.InputSpec(list(ids.shape), "int64"),
            paddle.jit.InputSpec(list(types.shape), "int64")]
    tmp = tempfile.mkdtemp(prefix="hapi_jit_")
    try:
        path = os.path.join(tmp, "ernie")
        t0 = time.perf_counter()
        paddle.jit.save(net, path, input_spec=spec)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path + ".pdmodel")
        t0 = time.perf_counter()
        loaded = paddle.jit.load(path)
        load_s = time.perf_counter() - t0
        before = (fa.fwd_launches, fl.fwd_launches, fa.reference_calls,
                  fl.reference_calls)
        out32 = loaded(ids, types)
        torch.cuda.synchronize()
        grown = [a - b for a, b in zip((fa.fwd_launches, fl.fwd_launches,
                                        fa.reference_calls,
                                        fl.reference_calls), before)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    net.train()
    err = float((out32.float() - eager32.float()).abs().max())
    out = {"to_static_bit_equal": bool(torch.equal(eager, static)),
           "logits_dtype": str(eager.dtype).replace("torch.", ""),
           "loaded_max_abs_err": err, "tol": HAPI_JIT_TOL,
           "artifact_bytes": nbytes, "save_s": save_s, "load_s": load_s,
           "loaded_launches": {"flash_fwd": grown[0], "ln_fwd": grown[1],
                               "plain_flash": grown[2],
                               "plain_ln": grown[3]}}
    log(f"  (c) to_static in eval under O1: logits ({out['logits_dtype']}) "
        f"bit-equal to eager: {out['to_static_bit_equal']}; jit.save "
        f"{save_s:.2f} s ({nbytes} bytes .pdmodel), jit.load {load_s:.2f} s; "
        f"the loaded program's float32 logits within {err:.3e} of eager "
        f"(tol {HAPI_JIT_TOL}); its run launched {out['loaded_launches']} "
        f"[{card_line}]")
    if not (out["to_static_bit_equal"] and err <= HAPI_JIT_TOL
            and grown == [layers, 2 * layers + 1, 0, 0]):
        raise RuntimeError(f"jit on the card: {out}")
    return out


def hapi_profiled(paddle, card_line, model, batches, step_ms) -> dict:
    """Leg (e): HAPI_PROFILED_STEPS ``train_batch`` steps inside
    ``Profiler(targets=[CPU, GPU])``, each in ``RecordEvent("step")``:
    the exported chrome trace holds the ``step`` spans and the flash,
    LayerNorm and Adam kernels' device events; ``summary()`` and the
    native host tracer's event count; the device's busy ms a step by
    layer (the kernels' durations in the trace) against ``step_ms``, leg
    (b)'s unprofiled median step, for the idle share."""
    P = paddle.profiler
    tracer = P.host_tracer()
    if not tracer.native:
        raise RuntimeError(f"the native host tracer did not load: "
                           f"{tracer.error}")
    n0 = tracer.count()
    with P.Profiler(targets=[P.ProfilerTarget.CPU, P.ProfilerTarget.GPU]) \
            as prof:
        for i in range(HAPI_PROFILED_STEPS):
            with P.RecordEvent("step"):
                model.train_batch(*batches[i])
            prof.step()
    tmp = tempfile.mkdtemp(prefix="hapi_prof_")
    try:
        with open(prof.export(os.path.join(tmp, "trace.json"))) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = [e.get("name", "") for e in events
               if e.get("cat") == "kernel"]
    layers = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            layers[kernel_layer(e.get("name", ""))] += \
                e.get("dur", 0.0) / 1e3 / HAPI_PROFILED_STEPS
    busy_ms = sum(layers.values())
    found = {tag: sum(tag in k for k in kernels)
             for tag in ("flash_fwd", "flash_bwd", "ln_fwd_", "ln_bwd_",
                         "fused_adam", "dropout_fwd_kernel")}
    spans = sum(e.get("name") == "step" for e in events)
    summary = prof.summary()
    out = {"step_spans": spans, "kernel_events": found,
           "device_events": len(kernels), "summary": summary,
           "host_tracer_events": tracer.count() - n0,
           "host_tracer_native": tracer.native,
           "device_busy_ms_per_step": busy_ms,
           "idle_share": 1 - busy_ms / step_ms,
           "device_ms_by_layer": dict(layers.most_common())}
    log(f"  (e) profiler: {spans} 'step' spans, {len(kernels)} device "
        f"kernel events ({found}); summary: {summary}; host tracer "
        f"(native) {out['host_tracer_events']} events; device busy "
        f"{busy_ms:.3f} ms a step against (b)'s {step_ms:.3f} (idle "
        f"{100 * out['idle_share']:.1f}%), by layer "
        + ", ".join(f"{k} {v:.3f}" for k, v in layers.most_common())
        + f" [{card_line}]")
    if spans < HAPI_PROFILED_STEPS or not all(
            found[k] for k in ("flash_fwd", "ln_fwd_", "fused_adam")) or \
            out["host_tracer_events"] != HAPI_PROFILED_STEPS:
        raise RuntimeError(f"the profiler's trace: {out}")
    return out


def hapi_o2(paddle, card_line, net, train) -> dict:
    """The O2 leg: HAPI_O2_STEPS steps of the same run with the network
    cast by ``amp.decorate(level="O2")`` (bfloat16 parameters, float32
    masters in a new AdamW), for its ms a step."""
    opt = paddle.optimizer.AdamW(learning_rate=HAPI_LR, weight_decay=HAPI_WD,
                                 parameters=net.parameters())
    net, opt = paddle.amp.decorate(net, opt, level="O2")
    model = paddle.Model(net)
    model.prepare(opt, paddle.nn.CrossEntropyLoss(), amp_configs="O2")
    ends, losses = [], []

    class Ends(paddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            ends.append(time.perf_counter())
            losses.append(logs["loss"])

    np.random.seed(SEED + 2)
    model.fit(train, batch_size=HAPI_BATCH, epochs=1,
              num_iters=HAPI_O2_STEPS, num_workers=HAPI_WORKERS, verbose=0,
              callbacks=[Ends()])
    ms = float(np.median(np.diff(ends[2:]))) * 1e3
    out = {"ms": ms, "losses": losses, "param_dtype": str(
        net.classifier.weight.dtype).replace("torch.", "")}
    log(f"  O2 leg: {HAPI_O2_STEPS} steps, parameters "
        f"{out['param_dtype']}, median {ms:.3f} ms a step (steps 3 on); "
        f"losses {[round(x, 4) for x in losses]} [{card_line}]")
    if not np.isfinite(losses).all() or out["param_dtype"] != "bfloat16":
        raise RuntimeError(f"the O2 leg: {out}")
    return out


def hapi_fp16(paddle, card_line) -> dict:
    """Leg (d): LeNet, batch LENET_FP16_BATCH, through ``Model`` under amp
    O1 in float16 with a GradScaler (``init_loss_scaling`` 2**15, halved
    at each bad step); at step LENET_INF_STEP a hook makes the last layer's
    weight gradient inf: that step is skipped (no parameter moves) and the
    scale halves; the found-inf flag costs one host read a step."""
    from paddle_tpu_torch.vision.models import LeNet

    paddle.set_device("gpu")
    paddle.seed(SEED)
    net = LeNet()
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Adam(learning_rate=1e-3,
                                        parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss(),
                  amp_configs={"level": "O1", "dtype": "float16",
                               "init_loss_scaling": LENET_FP16_SCALE,
                               "decr_every_n_nan_or_inf": 1})
    rng = np.random.RandomState(SEED)
    x = rng.rand(LENET_FP16_STEPS, LENET_FP16_BATCH, 1, 28, 28).astype(
        np.float32)
    y = rng.randint(0, 10, (LENET_FP16_STEPS, LENET_FP16_BATCH, 1))
    step = [0]
    hook = net.fc[2].weight.register_hook(
        lambda g: torch.full_like(g, float("inf"))
        if step[0] == LENET_INF_STEP else g)
    rows = []
    try:
        with sync_sites() as sites:
            for i in range(LENET_FP16_STEPS):
                step[0] = i
                before = [p.detach().clone() for p in net.parameters()]
                scale = model._scaler._scale
                loss = model.train_batch([x[i]], [y[i]])[0]
                moved = any(not torch.equal(a, p.detach())
                            for a, p in zip(before, net.parameters()))
                rows.append({"step": i, "loss": loss, "scale_before": scale,
                             "scale_after": model._scaler._scale,
                             "moved": moved})
    finally:
        hook.remove()
    scaler_reads = sum(n for k, n in sites.items() if "grad_scaler" in k)
    out = {"steps": rows, "host_reads_per_step":
           sum(sites.values()) / LENET_FP16_STEPS,
           "found_inf_reads_per_step": scaler_reads / LENET_FP16_STEPS,
           "host_read_sites": dict(sites)}
    bad = rows[LENET_INF_STEP]
    # a step whose scale halved was skipped (the injected one, and any
    # that overflowed on its own), every other step moved the weights
    skipped_right = all(r["moved"] == (r["scale_after"] == r["scale_before"])
                        for r in rows)
    log(f"  (d) LeNet float16 + GradScaler: steps {rows}; host reads a step "
        f"{out['host_reads_per_step']:.2f} (found-inf "
        f"{out['found_inf_reads_per_step']:.2f}; by line {dict(sites)}) "
        f"[{card_line}]")
    if bad["moved"] or bad["scale_after"] != bad["scale_before"] / 2 or \
            not skipped_right or out["found_inf_reads_per_step"] != 1.0:
        raise RuntimeError(f"the GradScaler leg: {out}")
    return out


def loader_rates(paddle, card_line, resnet_images_per_s) -> dict:
    """Leg (f): phase 14 (c)'s ImageNet chain (RandomResizedCrop 224,
    flip, Normalize on 3 x 256 x 256 arrays) through the DataLoader with
    0, 2 and 4 workers, batches of LOADER_BATCH landing on the card:
    images/s each, beside phase 12's ResNet-50 training rate."""
    T = paddle.vision.transforms
    imgs = np.random.RandomState(SEED).rand(IMAGENET_IMAGES, 3, 256,
                                            256).astype(np.float32) * 255
    data = ImageNetChain(imgs, T.Compose([
        T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
        T.Normalize(IMAGENET_MEAN, IMAGENET_STD)]))
    rates, steady = {}, {}
    for workers in LOADER_WORKERS:
        np.random.seed(SEED)
        loader = paddle.io.DataLoader(data, batch_size=LOADER_BATCH,
                                      shuffle=True, num_workers=workers,
                                      timeout=120)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n, t_first = 0, None
        for batch in loader:
            if tuple(batch.shape[1:]) != (3, 224, 224) or \
                    batch.device.type != "cuda":
                raise RuntimeError(f"the loader gave {batch.shape} on "
                                   f"{batch.device}")
            n += batch.shape[0]
            if t_first is None:
                t_first, n_first = time.perf_counter(), n
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rates[workers] = n / (t1 - t0)
        steady[workers] = (n - n_first) / (t1 - t_first)
    try:  # the CPUs this process may use, and its cgroup's quota
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota = f.read().strip()
    except OSError:
        quota = "not readable"
    out = {"images_per_s": rates, "after_first_batch_images_per_s": steady,
           "cpu_count": os.cpu_count(),
           "cpus_usable": len(os.sched_getaffinity(0)),
           "cgroup_cpu_max": quota,
           "resnet50_train_images_per_s": resnet_images_per_s}
    log(f"  (f) DataLoader over the ImageNet chain ({IMAGENET_IMAGES} images,"
        f" batches of {LOADER_BATCH} onto the card): "
        + ", ".join(f"{w} workers {r:.1f} images/s ({steady[w]:.1f} after "
                    f"the first batch)" for w, r in rates.items())
        + f"; os.cpu_count() {os.cpu_count()}, usable "
        f"{out['cpus_usable']}, cgroup cpu.max {quota!r}; ResNet-50 trains "
        f"at {resnet_images_per_s:.1f} images/s (phase 12) [{card_line}]")
    return out


def hapi_phase(card_line: str, resnet_images_per_s: float) -> dict:
    """Phase 15: (a) float64 card vs CPU through ``Model.train_batch``,
    (b) ERNIE-3.0-base fine-tuned through ``Model.fit`` under amp O1,
    (c) ``to_static``, ``jit.save`` / ``jit.load``, (e) the profiler, the
    O2 leg, (d) LeNet in float16 with a GradScaler, (f) the DataLoader's
    workers against the card."""
    import paddle_tpu_torch as paddle

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"f64_check": hapi_f64_check(paddle, card_line)}
    gc.collect()
    torch.cuda.empty_cache()
    from paddle_tpu_torch.text import ernie_config

    vocab = ernie_config("ernie-3.0-base").vocab_size
    train = TnewsLike(HAPI_TRAIN, vocab, SEED + 1)
    evals = TnewsLike(HAPI_EVAL, vocab, SEED + 2)
    np.random.seed(SEED)
    out["fit"], model, opt = hapi_fit(paddle, card_line, train, evals)
    dev = resolve_device(None)
    batch = [torch.as_tensor(a[:HAPI_BATCH], device=dev)
             for a in (evals.ids, evals.types)]
    out["jit"] = hapi_jit(paddle, card_line, model.network, batch)
    batches = [([train.ids[i * HAPI_BATCH:(i + 1) * HAPI_BATCH],
                 train.types[i * HAPI_BATCH:(i + 1) * HAPI_BATCH]],
                [train.labels[i * HAPI_BATCH:(i + 1) * HAPI_BATCH]])
               for i in range(HAPI_PROFILED_STEPS)]
    out["profiler"] = hapi_profiled(paddle, card_line, model, batches,
                                    out["fit"]["ms"])
    out["o2"] = hapi_o2(paddle, card_line, model.network, train)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    out["fp16"] = hapi_fp16(paddle, card_line)
    out["loader"] = loader_rates(paddle, card_line, resnet_images_per_s)
    out["seconds"] = time.perf_counter() - t0
    out["script_seconds"] = time.perf_counter() - T_START
    log(f"  phase 15 took {out['seconds']:.1f} s (the script "
        f"{out['script_seconds']:.1f} s so far); O1 {out['fit']['ms']:.3f} "
        f"ms a step, O2 {out['o2']['ms']:.3f}")
    print(json.dumps({"phase15": out}, default=str), flush=True)
    return out


def kernel_layer(name: str) -> str:
    """The layer a device kernel belongs to, from its name."""
    low = name.lower()
    if "ln_fwd_" in low:  # the rows and strips programs
        return "LayerNorm forward (kernel)"
    if "ln_dx_kernel" in low:  # a checkout before the backward kernel
        return "LayerNorm dx (kernel; dgamma/dbeta in other)"
    if "ln_bwd_reduce_kernel" in low:
        return "LayerNorm dgamma/dbeta reduction (kernel)"
    if "ln_bwd_" in low:
        return "LayerNorm backward: dx and column partials (kernel)"
    if "flash_fwd" in low:
        return "attention forward (flash kernel)"
    if "flash_bwd" in low:
        return "attention backward (flash kernels)"
    if "fused_adam" in low:
        return "optimizer (fused Adam kernel)"
    if "dropout_fwd_kernel" in low:
        return "dropout forward (kernel)"
    if "dropout_apply_kernel" in low:
        return "dropout backward (kernel)"
    if "dropout_kernel" in low:  # a checkout before the stored bits
        return "dropout forward and backward (kernel)"
    if "sumsq_kernel" in low or "finalize_kernel" in low:
        return "global norm (kernel)"
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "sm90_",
                              "splitk")):
        return "matrix products (weights and LM head, cuBLAS)"
    return "other (GELU, CE softmax, residuals, elementwise, copies)"


def profile_step(built, ids, labels, tag: str) -> dict:
    """One training step of ``built`` under ``torch.profiler``: device
    time by kernel and by layer, the device's busy share (returned, with
    the layers, where the profiler saw the device)."""
    step_fn = built["train_step"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_fn(ids, labels)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step_fn(ids, labels)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(device_rows(prof), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    if not busy_ms:
        log("  training profile: the profiler recorded no device time (not "
            "measured)")
        return {}
    log(f"  training profile ({tag}): one step {plain_ms:.3f} ms wall "
        f"unprofiled, "
        f"{prof_ms:.3f} ms profiled; device busy {busy_ms:.3f} ms = "
        f"{100 * busy_ms / plain_ms:.1f}% of the unprofiled step (idle "
        f"{100 - 100 * busy_ms / plain_ms:.1f}%)")
    layers = {}
    for dev_us, key, count in rows:
        layer = layers.setdefault(kernel_layer(key), [0.0, 0])
        layer[0] += dev_us / 1e3
        layer[1] += count
    for name, (dev_ms, count) in sorted(layers.items(),
                                        key=lambda kv: -kv[1][0]):
        log(f"    layer {100 * dev_ms / busy_ms:5.1f}%  {dev_ms:8.3f} ms  "
            f"x{count:<5d} {name}")
    ln_ms = sum(v[0] for k, v in layers.items() if k.startswith("LayerNorm"))
    log(f"    LayerNorm kernels (forward + backward): {ln_ms:.3f} ms = "
        f"{100 * ln_ms / busy_ms:.1f}% of the step's device time")
    for dev_us, key, count in rows[:12]:
        log(f"    {100 * dev_us / 1e3 / busy_ms:5.1f}%  {dev_us / 1e3:8.3f} "
            f"ms  x{count:<5d} {key[:80]}")
    host = sorted(((e.self_cpu_time_total, e.key, e.count)
                   for e in prof.key_averages()), reverse=True)
    log(f"    host: the profiled step's largest self times on the CPU "
        f"(profiler overhead included):")
    for cpu_us, key, count in host[:10]:
        log(f"      {cpu_us / 1e3:8.3f} ms  x{count:<5d} {key[:70]}")
    return {"busy_ms": busy_ms, "wall_ms": plain_ms,
            "idle_share": 1 - busy_ms / plain_ms,
            "layers": {k: {"ms": v[0], "launches": v[1]}
                       for k, v in layers.items()}}


def profile_train(trained) -> None:
    """Phase 9: one step of phase 8's rung by layer, then the head + CE
    experiment below."""
    step_fn, ids, labels = (trained["built"]["train_step"], trained["ids"],
                            trained["labels"])
    model = trained["built"]["model"]
    profile_step(trained["built"], ids, labels, TRAIN_RUNG["tag"])
    # the fused head + cross-entropy alone, forward and backward
    cfg = trained["built"]["cfg"]
    h = torch.randn((*ids.shape, cfg.hidden_size), device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    w = model.gpt.wte.weight.detach().clone().requires_grad_()

    def head_ce():
        linear_cross_entropy(h, w, labels, transpose_y=True,
                             chunk_size=cfg.loss_chunk_size).backward()

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    shape = (f"[{ids.numel()}, {cfg.hidden_size}] x [{cfg.vocab_size}, "
             f"{cfg.hidden_size}], chunk {cfg.loss_chunk_size}")
    # the backward's dh and dw from the float32 logit gradient (the
    # port's: two bf16 products of its hi and lo parts) and from the
    # gradient rounded to bf16 first (the earlier way, patched in for its
    # turns): the head + CE alone and the whole step, in turns
    own = ptf._ce_input_grads
    ways = {"hi+lo bf16": own, "rounded bf16": rounded_ce_input_grads}
    t_head, t_step = {}, {}
    order = ("hi+lo bf16", "rounded bf16", "rounded bf16", "hi+lo bf16")
    for name in order:
        ptf._ce_input_grads = ways[name]
        try:
            t = time_ms(head_ce, flush, iters=5)
            t_head[name] = min(t, t_head.get(name, t))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                step_fn(ids, labels)
            torch.cuda.synchronize()
            t = (time.perf_counter() - t0) * 1e3 / 5
            t_step[name] = min(t, t_step.get(name, t))
        finally:
            ptf._ce_input_grads = own
    what = {"hi+lo bf16": "this port", "rounded bf16": "the earlier way"}
    for name in ways:
        log(f"    head + CE alone (linear_cross_entropy forward + backward, "
            f"{shape}), dh/dw from the {name} gradient ({what[name]}): "
            f"{t_head[name]:.3f} ms; training step {t_step[name]:.3f} ms "
            f"(5 steps, host clock; the lower of two turns)")


def rounded_ce_input_grads(grad, h, w, transpose_y, need_dh, need_dw):
    """The earlier backward products, kept here only to measure what the
    repair costs: the float32 logit gradient rounded to the inputs' dtype
    first, then one product each in that dtype."""
    g = grad.to(h.dtype)
    dh = (g @ w if transpose_y else g @ w.t()) if need_dh else None
    dw = (g.t() @ h if transpose_y else h.t() @ g) if need_dw else None
    return dh, dw


def bf16_vs_fp32(errs, part) -> dict:
    """The bf16 kernel's and plain version's max abs errors against the
    float32 plain version, for the kernels line."""
    return {f"bf16_{key}": errs[torch.bfloat16, part, key]
            for key in ("kernel_vs_fp32", "plain_vs_fp32")}


def kernel_entry(name, module, replaces, launches, err, err32, t,
                 card_line, **extra) -> dict:
    """One kernel's entry of the ``{"kernels": [...]}`` line."""
    return {"name": name, "route": "cuda", "source": module.SOURCE,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "max_abs_err_fp32": err32, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "card": card_line, **extra}


# --------------------------------------------------------------- phase 16
# parallel training (item 12e-1): four ranks share cuda:0 over gloo (NCCL
# refuses two ranks on one device; gloo reduces CUDA tensors through the
# host), spawned once; a rank's collective timeout and the parent's join
# limit
H16_WORLD, H16_BACKEND = 4, "gloo"
H16_RANK_TIMEOUT_S, H16_JOIN_TIMEOUT_S = 300.0, 900.0
# bench.py's 350M-b8-off rung: the global batch and sequence
H16_BATCH, H16_SEQ = TRAIN_RUNG["batch"], TRAIN_RUNG.get("seq", 1024)
H16_CHECK_LAYERS, H16_RUN_LAYERS = 2, TRAIN_RUNG["layers"]
# (a), (c), (d): the sharded steps against the one-rank port step in
# float32 (TF32 off): the loss's relative difference, and each updated
# parameter's largest difference relative to its largest entry, floored at
# the learning rate (the most one Adam step moves an element: a bias that
# starts at 0 holds no more than that, and its gradient is a cancelling
# sum over tokens whose order the ranks change). Adam's
# epsilon is 1e-4 in the checks (as the ERNIE tests'): an element whose
# exact gradient is 0 (the key bias) then moves by ~lr * 1e-8, not by +-lr
# on the sign of its rounding, which differs between any two summation
# orders
H16_LOSS_RTOL, H16_PARAM_RTOL = 1e-4, 1e-3
H16_CHECK_ADAM = dict(learning_rate=1e-4, weight_decay=0.01, epsilon=1e-4)
# (b): bench.py's AdamW, 2 warm-up steps then 5 timed, dropout 0.1 (the
# recipe's, so that the dropout kernels run)
H16_RUN_ADAM = dict(learning_rate=1e-4, weight_decay=0.01)
H16_WARMUP, H16_STEPS, H16_DROPOUT = 2, 5, 0.1
# (c): pp2 x dp2, 1F1B over 4 micro-batches; 3 timed bf16 steps
H16_PIPE_ACC, H16_PIPE_STEPS = 4, 3
# (d): two steps of each ZeRO level
H16_ZERO_STEPS = 2
# (e): the MoE layer over the four ranks, 8 tokens a rank; float32
# outputs and gradients against the dense one-rank layer
H16_MOE = dict(d_model=1024, d_hidden=4096, num_experts=8, gate="gshard")
H16_MOE_TOKENS, H16_MOE_RTOL = 8, 1e-4
# (f): ERNIE-3.0-base under auto_cast(dtype="float16") against its float32
# run on the same weights and ids: logits within 5e-2 of their largest
# entry (float16's 10-bit mantissa through 12 layers), the loss within
# 2e-2
H16_F16_BATCH, H16_F16_SEQ = 8, 128
H16_F16_LOGITS_RTOL, H16_F16_LOSS_RTOL = 5e-2, 2e-2


def h16_fleet(**hybrid):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(dict(dp_degree=1, mp_degree=1, pp_degree=1,
                                 sharding_degree=1), **hybrid)
    return s


def h16_init(strategy):
    from paddle_tpu_torch.distributed import fleet

    return fleet.fleet.reset().init(is_collective=True, strategy=strategy)


def h16_gpt(layers, dtype=torch.float32, dropout=0.0):
    """GPT-350M's width (hidden 1024, 16 heads, vocab 50,304, seq 1,024) at
    ``layers``, drawn from SEED on the card in float32 (every rank the
    same weights), cast to ``dtype``, in training mode."""
    cfg = gpt_config("gpt3-350m", num_layers=layers, max_seq_len=H16_SEQ,
                     dropout=dropout)
    model = GPTForCausalLM(cfg, dtype=torch.float32, generator=torch.Generator(
        "cuda").manual_seed(SEED)).to(dtype)
    model.train()
    return model


def h16_batch(vocab):
    g = torch.Generator("cuda").manual_seed(SEED + 16)
    ids = torch.randint(0, vocab, (H16_BATCH, H16_SEQ + 1), device="cuda",
                        generator=g)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def h16_adam(model, dtype, hyper):
    from paddle_tpu_torch.optimizer import AdamW

    return AdamW(parameters=list(model.named_parameters()),
                 grad_clip=ClipGradByGlobalNorm(1.0),
                 multi_precision=dtype != torch.float32, **hyper)


def h16_one_rank(layers, steps, ids, labels):
    """The one-rank port step (float32) on the full batch: the losses and
    the state after ``steps``."""
    model = h16_gpt(layers)
    opt = h16_adam(model, torch.float32, H16_CHECK_ADAM)
    losses = []
    for _ in range(steps):
        loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, opt
    return losses, state


def h16_param_err(state, want, lr=H16_CHECK_ADAM["learning_rate"]) -> tuple:
    """The largest of each entry's ``max |got - want| / max(max |want|,
    lr)`` and its name."""
    worst = (0.0, None)
    for k, v in state.items():
        w = want[k].to(v.device, torch.float32)
        err = float((v.float() - w).abs().max()) / max(
            float(w.abs().max()), lr)
        worst = max(worst, (err, k), key=lambda t: t[0])
    return worst


def h16_sharded(state, specs, hcg):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        shard_state_dict

    mp = hcg.get_model_parallel_group()
    return shard_state_dict(state, specs, mp.rank, mp.nranks)


def h16_check(ids, labels) -> dict:
    """(a): dp2 x mp2 through fleet against the one-rank step."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import model_specs

    ref_losses, ref_state = h16_one_rank(H16_CHECK_LAYERS, 1, ids, labels)
    f = h16_init(h16_fleet(dp_degree=2, mp_degree=2))
    model = h16_gpt(H16_CHECK_LAYERS)
    fleet.apply_megatron_specs(model)
    specs = model_specs(model)
    opt = h16_adam(model, torch.float32, H16_CHECK_ADAM)
    dm = f.distributed_model(model)
    loss = float(dm.train_batch([ids, labels], f.distributed_optimizer(opt)))
    hcg = f.get_hybrid_communicate_group()
    err, name = h16_param_err(dm.state_dict(),
                              h16_sharded(ref_state, specs, hcg))
    return {"loss": loss, "one_rank_loss": ref_losses[0],
            "loss_rel": abs(loss - ref_losses[0]) / abs(ref_losses[0]),
            "param_rel": err, "param": name}


def h16_check_dropout(ids, labels) -> dict:
    """(a) at dropout H16_DROPOUT: the one-rank step under the key the
    hybrid step then draws (both from the generator seeded with SEED);
    each rank draws its slice of the one-rank step's masks (its rows,
    and its heads of the attention output), so the hybrid step is the
    one-rank step."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import model_specs

    model = h16_gpt(H16_CHECK_LAYERS, dropout=H16_DROPOUT)
    opt = h16_adam(model, torch.float32, H16_CHECK_ADAM)
    rng.seed(SEED)
    with trace_rng_scope(rng.next_rng_key()):
        ref_loss = model(ids, labels=labels)
    ref_loss.backward()
    opt.step()
    ref_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, opt
    f = h16_init(h16_fleet(dp_degree=2, mp_degree=2))
    model = h16_gpt(H16_CHECK_LAYERS, dropout=H16_DROPOUT)
    fleet.apply_megatron_specs(model)
    specs = model_specs(model)
    opt = h16_adam(model, torch.float32, H16_CHECK_ADAM)
    dm = f.distributed_model(model)
    rng.seed(SEED)
    reset_counters()
    loss = float(dm.train_batch([ids, labels], f.distributed_optimizer(opt)))
    windowed = kd.fwd_launches
    err, name = h16_param_err(dm.state_dict(), h16_sharded(
        ref_state, specs, f.get_hybrid_communicate_group()))
    return {"loss": loss, "one_rank_loss": float(ref_loss),
            "loss_rel": abs(loss - float(ref_loss)) / abs(float(ref_loss)),
            "param_rel": err, "param": name, "dropout_fwd": windowed}


def h16_zero(ids, labels) -> dict:
    """(d): sharding 2 x mp2 at each ZeRO level against the one-rank
    step; the optimizer state a rank holds beside the unsharded step's."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import model_specs

    ref_losses, ref_state = h16_one_rank(H16_CHECK_LAYERS, H16_ZERO_STEPS,
                                         ids, labels)
    out = {}
    for stage, level in ((1, "os"), (2, "os_g"), (3, "p_g_os")):
        s = h16_fleet(sharding_degree=2, mp_degree=2)
        s.sharding = True
        s.sharding_configs = {"stage": stage, "sharding_degree": 2}
        f = h16_init(s)
        model = h16_gpt(H16_CHECK_LAYERS)
        fleet.apply_megatron_specs(model)
        specs = model_specs(model)
        opt = h16_adam(model, torch.float32, H16_CHECK_ADAM)
        dm = f.distributed_model(model)
        dopt = f.distributed_optimizer(opt)
        losses = [float(dm.train_batch([ids, labels], dopt))
                  for _ in range(H16_ZERO_STEPS)]
        hcg = f.get_hybrid_communicate_group()
        err, name = h16_param_err(dm.state_dict(),
                                  h16_sharded(ref_state, specs, hcg))
        local = sum(p.numel() for p in model.parameters())
        out[level] = {
            "losses": losses, "one_rank_losses": ref_losses,
            "loss_rel": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_losses)),
            "param_rel": err, "param": name,
            "state_bytes": dm._zero.state_bytes(),
            "moment_bytes": dm._zero.state_bytes() - 4 * dm._zero.chunk,
            "unsharded_state_bytes": 2 * 4 * local}
        del model, opt, dm, dopt
        torch.cuda.empty_cache()
    return out


def h16_predicted(model, opt, layers, dropout, hcg, bucket_mb) -> tuple:
    """A hybrid step's kernel launches and collectives on one rank, from
    the code: the kernels of ``expected_train_launches`` at the rank's
    shapes, and the census by group: on the model group 2L + 1 forward
    all-reduces (each layer's two row-parallel products, the vocab-split
    embedding), the vocab-parallel loss's three (its max, its
    denominator, the true logit), 2L + 1 backward (each column-parallel
    input's gradient and the head's input) and the norm's one; on the
    data group the gradient buckets (``parallel.bucket_plan``) and the
    loss's mean."""
    from paddle_tpu_torch.distributed.parallel import bucket_plan

    params = [p for _, p in opt._params]
    sizes = [p.numel() for p in params]
    dtypes = [torch.bfloat16 if p.dtype == torch.bfloat16 else
              torch.float32 for p in params]
    want = {"flash_fwd": layers, "flash_bwd": layers,
            "adam": len(fo.adam_launch_plan(sizes, dtypes,
                                            fo.kernel_param_bytes())),
            "adam_tensors": len(params), "ln_fwd": 2 * layers + 1,
            "ln_dx": 2 * layers + 1, "ln_reduce": 2 * layers + 1,
            "global_norm": len(gn.norm_launch_plan(
                sizes, gn.kernel_param_bytes())) + 1}
    if dropout > 0:
        # each site draws the rank's slice of the reference's mask: a
        # windowed forward, its bits then their application
        want["dropout_bwd"] = 1 + 3 * layers
        want["dropout_fwd"] = 2 * want["dropout_bwd"]
    mp = tuple(hcg.get_model_parallel_group().ranks)
    dp = tuple(hcg.get_batch_group().ranks)
    buckets = bucket_plan([(p.numel() * p.element_size(), p.dtype)
                           for p in params], int(bucket_mb * 2 ** 20))
    census = {("all-reduce", mp): 4 * layers + 6,
              ("all-reduce", dp): len(buckets) + 1}
    return want, census


def h16_census(calls, steps) -> dict:
    """``{(kind, ranks): calls a step}`` and the bytes a step by group."""
    count, nbytes = collections.Counter(), collections.Counter()
    for kind, nb, ranks, _, _ in calls:
        count[kind, ranks] += 1
        nbytes[kind, ranks] += nb
    return ({k: v / steps for k, v in count.items()},
            {k: v / steps for k, v in nbytes.items()})


def h16_run(ids, labels) -> dict:
    """(b): bench.py's 350M-b8-off rung in bf16 at dp2 x mp2 (each rank:
    batch 4, 8 heads), H16_WARMUP steps, then H16_STEPS timed with the
    counters set to 0 just before and read just after."""
    from paddle_tpu_torch.distributed import fleet

    s = h16_fleet(dp_degree=2, mp_degree=2)
    f = h16_init(s)
    model = h16_gpt(H16_RUN_LAYERS, torch.bfloat16, H16_DROPOUT)
    fleet.apply_megatron_specs(model)
    opt = h16_adam(model, torch.bfloat16, H16_RUN_ADAM)
    dm = f.distributed_model(model)
    dopt = f.distributed_optimizer(opt)
    hcg = f.get_hybrid_communicate_group()
    losses = [float(dm.train_batch([ids, labels], dopt))
              for _ in range(H16_WARMUP)]
    want, census_want = h16_predicted(model, opt, H16_RUN_LAYERS,
                                      H16_DROPOUT, hcg,
                                      s.fuse_grad_size_in_MB)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()  # every kernel's count, just before the path
    with collective.census() as calls:
        t0 = time.perf_counter()
        timed = [dm.train_batch([ids, labels], dopt)
                 for _ in range(H16_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    losses += [float(t) for t in timed]
    per_step, bytes_step = h16_census(calls, H16_STEPS)
    return {"losses": losses, "ms": 1e3 * wall / H16_STEPS,
            "tokens_per_s": H16_BATCH * H16_SEQ * H16_STEPS / wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": counts,
            "launches_per_step": {k: v / H16_STEPS for k, v in counts.items()
                                  if v},
            "expected_per_step": want,
            "census": per_step, "census_bytes": bytes_step,
            "census_expected": census_want,
            "local_heads": model.gpt.blocks[0].attn.qkv_proj.weight.shape[0]
            // (3 * model.gpt.blocks[0].attn.head_dim)}


def h16_pipeline(layers, dtype):
    from paddle_tpu_torch.text.gpt import build_gpt_pipeline

    torch.manual_seed(SEED)   # the pieces draw torch's generator
    cfg = gpt_config("gpt3-350m", num_layers=layers, max_seq_len=H16_SEQ,
                     dropout=0.0)
    pipe = build_gpt_pipeline(cfg, 2, device="cuda", dtype=torch.float32)
    return pipe.to(dtype=dtype)


def h16_pipe(ids, labels, check: bool) -> dict:
    """(c): pp2 x dp2, 1F1B over H16_PIPE_ACC micro-batches. ``check``:
    float32 at 2 layers, one step against the one-rank step of the same
    PipelineLayer (every stage on the rank); else bf16 at full depth,
    H16_PIPE_STEPS timed steps and the send / receive census."""
    layers = H16_CHECK_LAYERS if check else H16_RUN_LAYERS
    dtype = torch.float32 if check else torch.bfloat16
    hyper = H16_CHECK_ADAM if check else H16_RUN_ADAM
    s = h16_fleet(dp_degree=2, pp_degree=2)
    s.pipeline = True
    s.pipeline_configs = {"accumulate_steps": H16_PIPE_ACC,
                          "micro_batch_size": H16_BATCH // H16_PIPE_ACC}
    f = h16_init(s)
    pipe = h16_pipeline(layers, dtype)
    out = {}
    if check:
        ref = copy.deepcopy(pipe)
        ref.train()
        ropt = h16_adam(ref, dtype, hyper)
        loss = sum(ref.loss_fn(ref(x), y) for x, y in
                   zip(ids.chunk(H16_PIPE_ACC), labels.chunk(H16_PIPE_ACC))
                   ) / H16_PIPE_ACC
        loss.backward()
        ropt.step()
        want = {k: v.detach().clone() for k, v in ref.state_dict().items()}
        out["one_rank_loss"] = float(loss)
        del ref, ropt
    pipe.train()
    dm = f.distributed_model(pipe)
    dopt = f.distributed_optimizer(h16_adam(pipe, dtype, hyper))
    if check:
        got = float(dm.train_batch((ids, labels), dopt))
        err, name = h16_param_err(pipe.state_dict(), want)
        out.update(loss=got, loss_rel=abs(got - out["one_rank_loss"]) /
                   abs(out["one_rank_loss"]), param_rel=err, param=name)
        return out
    losses = [float(dm.train_batch((ids, labels), dopt))]
    torch.cuda.synchronize()
    reset_counters()
    with collective.census() as calls:
        t0 = time.perf_counter()
        timed = [dm.train_batch((ids, labels), dopt)
                 for _ in range(H16_PIPE_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    per_step, bytes_step = h16_census(calls, H16_PIPE_STEPS)
    return {"losses": losses + [float(t) for t in timed],
            "ms": 1e3 * wall / H16_PIPE_STEPS,
            "tokens_per_s": H16_BATCH * H16_SEQ * H16_PIPE_STEPS / wall,
            "stage": dm.stage,
            "launches_per_step": {k: v / H16_PIPE_STEPS
                                  for k, v in counts.items() if v},
            "census": per_step, "census_bytes": bytes_step}


def h16_moe(rank, world) -> dict:
    """(e): the MoE layer's experts split over the four ranks against the
    dense layer on one rank (the same weights; every rank's tokens, the
    expert gradients summed over them), float32; then bf16 ms of a
    forward and backward and the all-to-all census."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate import MoELayer

    paddle.set_device("gpu")

    def tokens(r, dtype=torch.float32):
        g = torch.Generator("cuda").manual_seed(SEED + 100 + r)
        return torch.randn(H16_MOE_TOKENS, H16_MOE["d_model"], device="cuda",
                           generator=g).to(dtype)

    paddle.seed(SEED)
    dense = MoELayer(**H16_MOE)
    moe = copy.deepcopy(dense).shard(collective.new_group(range(world)))
    ref_outs = []
    for r in range(world):   # every rank's tokens through the dense layer
        y = dense(tokens(r))
        y.square().sum().backward()
        ref_outs.append(y.detach())
    x = tokens(rank).requires_grad_(True)
    y = moe(x)
    y.square().sum().backward()
    k = H16_MOE["num_experts"] // world
    sl = slice(rank * k, (rank + 1) * k)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    out = {"out_rel": rel(y.detach(), ref_outs[rank]),
           "grad_rel": max(rel(getattr(moe, n).grad,
                               getattr(dense, n).grad[sl])
                           for n in ("w1", "b1", "w2", "b2")),
           "kept": int(moe.last_keep.sum()),
           "slots": int(moe.last_keep.numel())}
    moe = moe.to(dtype=torch.bfloat16)
    xb = tokens(rank, torch.bfloat16).requires_grad_(True)
    for _ in range(3):
        moe(xb).float().square().sum().backward()
    torch.cuda.synchronize()
    with collective.census() as calls:
        t0 = time.perf_counter()
        for _ in range(10):
            moe(xb).float().square().sum().backward()
        torch.cuda.synchronize()
        out["bf16_ms"] = 1e3 * (time.perf_counter() - t0) / 10
    out["census"], out["census_bytes"] = h16_census(calls, 10)
    return out


def h16_rank(rank: int, world: int, init_method: str) -> dict:
    """One rank of phase 16, a spawned process on cuda:0: join the gloo
    group and run (a), (d), (c)'s check, (e), (b) and (c)'s run in turn."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    ptd.init_parallel_env(H16_BACKEND, init_method, world, rank,
                          timeout_s=H16_RANK_TIMEOUT_S)
    try:
        ids, labels = h16_batch(gpt_config("gpt3-350m").vocab_size)
        out = {"seconds": {}}
        for leg, fn in (("check", lambda: h16_check(ids, labels)),
                        ("check_dropout",
                         lambda: h16_check_dropout(ids, labels)),
                        ("zero", lambda: h16_zero(ids, labels)),
                        ("pipe_check", lambda: h16_pipe(ids, labels, True)),
                        ("moe", lambda: h16_moe(rank, world)),
                        ("run", lambda: h16_run(ids, labels)),
                        ("pipe", lambda: h16_pipe(ids, labels, False))):
            t0 = time.perf_counter()
            out[leg] = fn()
            out["seconds"][leg] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
        return out
    finally:
        ptd.destroy_process_group()


def h16_fault4(card_line) -> dict:
    """(f): ERNIE-3.0-base (the classifier, 15 classes) under
    ``amp.auto_cast(dtype="float16")``: one forward and backward, finite,
    against its float32 run on the same weights and ids; the flash
    kernels launch 0 times (float16 attention takes the composite) and
    the LayerNorm kernels only in float32 (black-listed under O1; the
    kernel refuses float16)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.text import (ErnieForSequenceClassification,
                                       ernie_config)

    paddle.set_device("gpu")
    paddle.seed(SEED)
    net = ErnieForSequenceClassification(ernie_config("ernie-3.0-base"),
                                         num_classes=15)
    net.eval()   # no dropout: the two runs see the same graph
    g = torch.Generator("cuda").manual_seed(SEED + 17)
    ids = torch.randint(1, ernie_config("ernie-3.0-base").vocab_size,
                        (H16_F16_BATCH, H16_F16_SEQ), device="cuda",
                        generator=g)
    y = torch.randint(0, 15, (H16_F16_BATCH,), device="cuda", generator=g)
    runs = {}
    for label, ctx in (("float32", contextlib.nullcontext()),
                       ("float16", paddle.amp.auto_cast(dtype="float16"))):
        net.clear_gradients()
        torch.cuda.synchronize()
        reset_counters()
        with ctx:
            logits = net(ids)
            loss = paddle.nn.functional.cross_entropy(logits, y)
        loss.backward()
        torch.cuda.synchronize()
        runs[label] = (logits.detach().float(), float(loss),
                       launch_counts(), str(logits.dtype),
                       all(bool(torch.isfinite(p.grad).all())
                           for p in net.parameters() if p.grad is not None))
    (l32, loss32, c32, _, _), (l16, loss16, c16, dt16, finite) = \
        runs["float32"], runs["float16"]
    out = {"logits_dtype": dt16,
           "logits_rel": float((l16 - l32).abs().max())
           / float(l32.abs().max()),
           "loss": loss16, "loss32": loss32,
           "loss_rel": abs(loss16 - loss32) / abs(loss32),
           "finite": finite and bool(torch.isfinite(l16).all()),
           "launches_float16": {k: v for k, v in c16.items() if v},
           "launches_float32": {k: v for k, v in c32.items() if v}}
    log(f"  (f) ERNIE-3.0-base under auto_cast(dtype='float16'): logits "
        f"{dt16}, within {out['logits_rel']:.3e} of the float32 run's "
        f"(relative to the largest; limit {H16_F16_LOGITS_RTOL}), loss "
        f"{loss16:.5f} against {loss32:.5f} (rel {out['loss_rel']:.3e}, "
        f"limit {H16_F16_LOSS_RTOL}), finite {out['finite']}; launches in "
        f"float16 {out['launches_float16']} (flash 0: the composite "
        f"carries float16 attention; LayerNorm float32 under O1), in "
        f"float32 {out['launches_float32']} [{card_line}]")
    if not out["finite"] or out["logits_rel"] > H16_F16_LOGITS_RTOL or \
            out["loss_rel"] > H16_F16_LOSS_RTOL or \
            c16["flash_fwd"] or c16["flash_bwd"]:
        raise RuntimeError(f"phase 16 (f): {out}")
    return out


#: the kernel entries' counters in phase 16 (b)
H16_COUNTERS = {"flash_attention_forward": "flash_fwd",
                "flash_attention_backward": "flash_bwd",
                "fused_adam": "adam", "layernorm_forward": "ln_fwd",
                "layernorm_backward": "ln_dx", "dropout": "dropout_fwd",
                "dropout_backward": "dropout_bwd",
                "global_norm": "global_norm"}


def h16_key(k) -> str:
    kind, ranks = k
    return f"{kind} {list(ranks)}"


def hybrid_phase(card_line: str) -> dict:
    """Phase 16: H16_WORLD ranks sharing the card over gloo run (a)-(e)
    (``h16_rank``); a rank that fails or outlasts H16_JOIN_TIMEOUT_S fails
    the phase; then (f) in this process."""
    t_phase = time.perf_counter()
    rdv = tempfile.mkdtemp(prefix="chip_smoke_h16_")
    try:
        ranks = ptd.spawn(h16_rank, H16_WORLD,
                          args=(f"file://{rdv}/rendezvous",),
                          timeout_s=H16_JOIN_TIMEOUT_S)
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
    where = f"{H16_WORLD} ranks on cuda:0 over {H16_BACKEND}"
    for r, res in enumerate(ranks):
        a = res["check"]
        log(f"  (a) rank {r} dp2 x mp2, GPT-350M width, "
            f"{H16_CHECK_LAYERS} layers, float32: loss {a['loss']:.6f} "
            f"against the one-rank step's {a['one_rank_loss']:.6f} (rel "
            f"{a['loss_rel']:.3e}, limit {H16_LOSS_RTOL}); updated "
            f"parameters within {a['param_rel']:.3e} of their largest "
            f"entry (worst {a['param']}; limit {H16_PARAM_RTOL}) "
            f"[{card_line}]")
        if a["loss_rel"] > H16_LOSS_RTOL or a["param_rel"] > H16_PARAM_RTOL:
            raise RuntimeError(f"phase 16 (a) rank {r}: {a}")
        a = res["check_dropout"]
        log(f"  (a) rank {r} dp2 x mp2 at dropout {H16_DROPOUT} (the rank's "
            f"slice of each mask: its rows, its heads of the attention "
            f"output): loss {a['loss']:.6f} against the one-rank step's "
            f"{a['one_rank_loss']:.6f} under the same key (rel "
            f"{a['loss_rel']:.3e}, limit {H16_LOSS_RTOL}); parameters within "
            f"{a['param_rel']:.3e} (worst {a['param']}; limit "
            f"{H16_PARAM_RTOL}); windowed dropout forward launches "
            f"{a['dropout_fwd']} (predicted {2 * (1 + 3 * H16_CHECK_LAYERS)}"
            f": the slice's bits, then their application, at each of the "
            f"{1 + 3 * H16_CHECK_LAYERS} sites) [{card_line}]")
        if a["loss_rel"] > H16_LOSS_RTOL or \
                a["param_rel"] > H16_PARAM_RTOL or \
                a["dropout_fwd"] != 2 * (1 + 3 * H16_CHECK_LAYERS):
            raise RuntimeError(f"phase 16 (a) dropout rank {r}: {a}")
        for level, z in res["zero"].items():
            log(f"  (d) rank {r} ZeRO {level} (sharding 2 x mp2): losses "
                f"{z['losses']} against {z['one_rank_losses']} (rel "
                f"{z['loss_rel']:.3e}); parameters within "
                f"{z['param_rel']:.3e} (worst {z['param']}); optimizer "
                f"state a rank {z['moment_bytes'] / 2 ** 20:.1f} MiB of "
                f"moments + {(z['state_bytes'] - z['moment_bytes']) / 2 ** 20:.1f}"
                f" MiB of float32 master chunk, against "
                f"{z['unsharded_state_bytes'] / 2 ** 20:.1f} MiB unsharded "
                f"[{card_line}]")
            if z["loss_rel"] > H16_LOSS_RTOL or \
                    z["param_rel"] > H16_PARAM_RTOL:
                raise RuntimeError(f"phase 16 (d) rank {r} {level}: {z}")
        c = res["pipe_check"]
        log(f"  (c) rank {r} pp2 x dp2 1F1B ({H16_PIPE_ACC} micro-batches), "
            f"{H16_CHECK_LAYERS} layers, float32: loss {c['loss']:.6f} "
            f"against {c['one_rank_loss']:.6f} (rel {c['loss_rel']:.3e}); "
            f"this stage's parameters within {c['param_rel']:.3e} (worst "
            f"{c['param']}) [{card_line}]")
        if c["loss_rel"] > H16_LOSS_RTOL or c["param_rel"] > H16_PARAM_RTOL:
            raise RuntimeError(f"phase 16 (c) check rank {r}: {c}")
        m = res["moe"]
        log(f"  (e) rank {r} MoE {H16_MOE} over {H16_WORLD} ranks, "
            f"{H16_MOE_TOKENS} tokens a rank: outputs within "
            f"{m['out_rel']:.3e}, expert gradients within "
            f"{m['grad_rel']:.3e} of the dense layer's (limit "
            f"{H16_MOE_RTOL}); {m['kept']} of {m['slots']} (token, k) slots "
            f"kept; bf16 forward + backward {m['bf16_ms']:.3f} ms; census a "
            f"call { {h16_key(k): v for k, v in m['census'].items()} } "
            f"[{card_line}]")
        if m["out_rel"] > H16_MOE_RTOL or m["grad_rel"] > H16_MOE_RTOL:
            raise RuntimeError(f"phase 16 (e) rank {r}: {m}")
    for r, res in enumerate(ranks):
        b = res["run"]
        log(f"  (b) rank {r} GPT-350M bf16 {H16_RUN_LAYERS} layers dp2 x "
            f"mp2 ({where}; a rank: batch {H16_BATCH // 2}, "
            f"{b['local_heads']} heads): {b['ms']:.1f} ms a step, "
            f"{b['tokens_per_s']:.1f} tokens/s over the 4 ranks; losses "
            f"{[round(x, 4) for x in b['losses']]}; peak "
            f"{b['peak_gib']:.2f} GiB; launches a step "
            f"{b['launches_per_step']} (predicted {b['expected_per_step']}); "
            f"census a step { {h16_key(k): v for k, v in b['census'].items()} }"
            f" (predicted { {h16_key(k): v for k, v in b['census_expected'].items()} }"
            f"), bytes a step "
            f"{ {h16_key(k): int(v) for k, v in b['census_bytes'].items()} } "
            f"[{card_line}]")
        got = {k: v for k, v in b["launches_per_step"].items()}
        if got != {k: float(v) for k, v in b["expected_per_step"].items()} \
                or b["census"] != {k: float(v) for k, v in
                                   b["census_expected"].items()}:
            raise RuntimeError(f"phase 16 (b) rank {r}: launches or census "
                               f"differ from the prediction: {b}")
        losses = b["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"phase 16 (b) rank {r}: losses {losses}")
        p = res["pipe"]
        log(f"  (c) rank {r} (stage {p['stage']}) pp2 x dp2 bf16 "
            f"{H16_RUN_LAYERS} layers: {p['ms']:.1f} ms a step, "
            f"{p['tokens_per_s']:.1f} tokens/s; losses "
            f"{[round(x, 4) for x in p['losses']]}; launches a step "
            f"{p['launches_per_step']}; census a step "
            f"{ {h16_key(k): v for k, v in p['census'].items()} } "
            f"[{card_line}]")
        if not all(np.isfinite(p["losses"])):
            raise RuntimeError(f"phase 16 (c) rank {r}: {p['losses']}")
    torch.cuda.empty_cache()
    fault4 = h16_fault4(card_line)
    seconds = time.perf_counter() - t_phase
    log(f"  phase 16 took {seconds:.1f} s "
        f"(legs on rank 0: { {k: round(v, 1) for k, v in ranks[0]['seconds'].items()} })")
    return {"ranks": ranks, "fault4": fault4, "seconds": seconds}


# --------------------------------------------------------------- phase 17
# sequence parallelism (item 12e-2a): GPT-350M at b1 x s8192 (the repo's
# long-context rung, bench.py's seq 8,192) over four context-parallel
# ranks sharing cuda:0 over gloo, started through the port's launcher
H17_WORLD, H17_SEQ = 4, 8192
H17_CHECK_LAYERS, H17_RUN_LAYERS, H17_CK_LAYERS = 2, 24, 2
# (b): 2 warm-up steps and 3 timed (the phase's time: the script has to
# end within its limit); the one-rank step at s8192 beside it
H17_WARMUP, H17_STEPS, H17_ONE_WARMUP, H17_ONE_STEPS = 2, 3, 2, 3
# (a): against the one-rank step in float32: the loss's relative
# difference (H16's limit); the gradients summed over the ranks, each
# tensor relative to its largest entry; and each parameter after the
# AdamW step relative to its largest entry floored at the learning rate.
# The last is looser than H16's 1e-3: Adam's first step moves an element
# by lr g / (|g| + eps), so for an element whose gradient is a cancelling
# sum over 8,192 tokens near eps (a projection's bias) the ranks' other
# summation order and block shapes (the float32 flash kernels differ from
# their plain version by up to 2e-4 at s 8,192) move the parameter by a
# thousandth of lr and more; the gradients themselves are held at
# H17_GRAD_RTOL
H17_LOSS_RTOL, H17_GRAD_RTOL, H17_PARAM_RTOL = H16_LOSS_RTOL, 1e-3, 1e-2
# (c): AutoCheckpoint every 2 steps; rank 2 exits at step 3 of
# generation 0; 6 steps. Two runs of the same steps are not bit-equal:
# the flash backward adds dq in float32 in no fixed order
# (``flash_attention_backward``). So the restarted run is held to the
# unbroken run by what that noise leaves: the state each rank holds right
# after the resume equals the step-2 snapshot it loaded bit for bit; the
# losses after the resume within H17_CK_LOSS_RTOL of the unbroken run's;
# and at each later snapshot the two runs' weights differ, relative to
# the unbroken run's change from the initial weights (the drift), by at
# most H17_CK_DRIFT_FACTOR times their drift at step 2, before the fault
# (pure run-to-run noise), plus H17_CK_DRIFT_FLOOR. A resume that lost or
# misplaced state moves the drift by orders more.
H17_CK_STEPS, H17_CK_INTERVAL, H17_CK_FAIL_STEP, H17_CK_FAIL_RANK = 6, 2, 3, 2
H17_CK_FAIL_CODE, H17_CK_LOSS_RTOL = 3, 1e-4
H17_CK_DRIFT_FACTOR, H17_CK_DRIFT_FLOOR = 3.0, 1e-3
# (d): the reference's checkpoint (tests/make_reference_checkpoint.py, on
# a machine with JAX) and the loss it gave, against the port's on the card
H17_REF_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "chip_scratch", "reference_ckpt")
H17_D_RTOL = 1e-4
H17_RANK_TIMEOUT_S, H17_JOIN_TIMEOUT_S = 300.0, 600.0
# the trainer script the phase writes for the launcher
H17_TRAINER = """import sys
sys.path.insert(0, {root!r})
import chip_smoke
sys.exit(chip_smoke.h17_trainer(sys.argv[1:]))
"""


def h17_gpt(layers, dtype=torch.float32):
    """GPT-350M's width at ``layers`` with max_seq_len 8,192, drawn from
    SEED on the card in float32, cast to ``dtype``, in training mode."""
    cfg = gpt_config("gpt3-350m", num_layers=layers, max_seq_len=H17_SEQ,
                     dropout=0.0)
    model = GPTForCausalLM(cfg, dtype=torch.float32, generator=torch.Generator(
        "cuda").manual_seed(SEED)).to(dtype)
    model.train()
    return model


def h17_batch(step=0):
    """The b1 x s8192 batch of step ``step``."""
    g = torch.Generator("cuda").manual_seed(SEED + 1700 + step)
    ids = torch.randint(0, gpt_config("gpt3-350m").vocab_size,
                        (1, H17_SEQ + 1), device="cuda", generator=g)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def h17_step(model, opt, attention="ring"):
    """``build_context_parallel_step`` over sp4 (dp 1), the model's own
    loss (the fused head + cross-entropy)."""
    from paddle_tpu_torch.distributed.sequence_parallel import \
        build_context_parallel_step
    from paddle_tpu_torch.distributed.topology import CommunicateTopology

    mesh = CommunicateTopology(("dp", "sp"), [1, H17_WORLD])
    return build_context_parallel_step(model, opt, None, mesh,
                                       attention=attention)


def h17_grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def h17_one_rank(layers, ids, labels):
    """The one-rank port step (float32) on the whole sequence: its loss,
    its gradients and the state after it."""
    model = h17_gpt(layers)
    opt = h16_adam(model, torch.float32, H16_CHECK_ADAM)
    loss = model(ids, labels=labels)
    loss.backward()
    grads = h17_grads(model)
    opt.step()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, opt
    return float(loss), grads, state


def h17_check(attention: str) -> dict:
    """(a): sp4 at float32, 2 layers, against the one-rank step on the
    same weights and batch: the loss, the gradients summed over the
    ranks (each tensor relative to its largest entry) and the updated
    parameters."""
    ids, labels = h17_batch()
    ref_loss, ref_grads, ref_state = h17_one_rank(H17_CHECK_LAYERS, ids,
                                                  labels)
    model = h17_gpt(H17_CHECK_LAYERS)
    opt = h16_adam(model, torch.float32, H16_CHECK_ADAM)
    init, step, shard = h17_step(model, opt, attention)
    grads = {}
    update = opt.step

    def step_after_reading_grads():  # the summed gradients, before Adam
        grads.update(h17_grads(model))
        update()

    opt.step = step_after_reading_grads
    loss, _ = step(init(), (0, 0), None, shard([ids]), shard([labels]))
    err, name = h16_param_err(model.state_dict(), ref_state)
    g_err, g_name = max(
        ((float((grads[k] - g).abs().max()) / float(g.abs().max()), k)
         for k, g in ref_grads.items()), key=lambda t: t[0])
    out = {"loss": float(loss), "one_rank_loss": ref_loss,
           "loss_rel": abs(float(loss) - ref_loss) / abs(ref_loss),
           "grad_rel": g_err, "grad": g_name, "param_rel": err,
           "param": name}
    del model, opt
    return out


def h17_predicted(params, layers, rank) -> tuple:
    """A ring step's kernel launches on rank ``rank`` of 4 and its ring
    bytes, from the code. A rank computes the blocks of the ranks at or
    before it, each layer: ``rank + 1`` flash forwards (the diagonal
    causal, the rest full) and as many backwards. Its LayerNorms, Adam and
    the clip's norm are the one-rank step's. Forward: each layer passes
    its K and V blocks (bf16 ``[1, 16, 2048, 64]``, 4 MiB each) three
    times round the ring; backward: K and V three times and the float32
    dK and dV accumulators (8 MiB each) four times, home again."""
    sizes = [p.numel() for p in params]
    dtypes = [torch.bfloat16 if p.dtype == torch.bfloat16 else
              torch.float32 for p in params]
    n = H17_WORLD
    want = {"flash_fwd": layers * (rank + 1),
            "flash_bwd": layers * (rank + 1),
            "adam": len(fo.adam_launch_plan(sizes, dtypes,
                                            fo.kernel_param_bytes())),
            "adam_tensors": len(params), "ln_fwd": 2 * layers + 1,
            "ln_dx": 2 * layers + 1, "ln_reduce": 2 * layers + 1,
            "global_norm": len(gn.norm_launch_plan(
                sizes, gn.kernel_param_bytes())) + 1}
    blocks = {"fwd_causal": layers, "fwd_full": layers * rank,
              "bwd_causal": layers, "bwd_full": layers * rank}
    kv = 16 * (H17_SEQ // n) * 64
    ring = layers * ((n - 1) * 2 * kv * 2 + (n - 1) * 2 * kv * 2
                     + n * 2 * kv * 4)
    return want, blocks, ring


def h17_run() -> dict:
    """(b): GPT-350M bf16, 24 layers, b1 x s8192 over sp4 ring:
    H17_WARMUP steps, then H17_STEPS timed with every counter set to 0
    just before and read just after."""
    from paddle_tpu_torch.distributed import sequence_parallel as sp

    model = h17_gpt(H17_RUN_LAYERS, torch.bfloat16)
    opt = h16_adam(model, torch.bfloat16, H16_RUN_ADAM)
    init, step, shard = h17_step(model, opt)
    state = init()
    ids, labels = h17_batch()
    xs, ys = shard([ids]), shard([labels])
    losses = [float(step(state, (0, i), None, xs, ys)[0])
              for i in range(H17_WARMUP)]
    rank = ptd.get_rank()
    want, blocks_want, ring_want = h17_predicted(
        [p for _, p in opt._params], H17_RUN_LAYERS, rank)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()   # every kernel's count, just before the path
    sp.ring_bytes[:] = [0, 0]
    for k in sp.ring_blocks:
        sp.ring_blocks[k] = 0
    t0 = time.perf_counter()
    timed = [step(state, (0, H17_WARMUP + i), None, xs, ys)[0]
             for i in range(H17_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    losses += [float(t) for t in timed]
    return {"losses": losses, "ms": 1e3 * wall / H17_STEPS,
            "tokens_per_s": H17_SEQ * H17_STEPS / wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches_per_step": {k: v / H17_STEPS for k, v in counts.items()
                                  if v},
            "expected_per_step": want,
            "blocks_per_step": {k: v / H17_STEPS
                                for k, v in sp.ring_blocks.items()},
            "blocks_expected": blocks_want,
            "ring_bytes_per_step": [v / H17_STEPS for v in sp.ring_bytes],
            "ring_bytes_expected": ring_want}


def h17_ck_state(model, opt) -> dict:
    """What a checkpoint holds: the model's state and the optimizer's
    (moments, float32 masters, step), prefixed ``opt:``."""
    return {**model.state_dict(),
            **{f"opt:{k}": v for k, v in opt.state_dict().items()}}


def h17_ck(out_dir: str, fail: bool) -> dict:
    """(c) on this rank: 2 layers bf16 sp4, AutoCheckpoint every
    H17_CK_INTERVAL steps (the last at step H17_CK_STEPS); resumed from
    ``latest()`` when there is one, the state it then holds compared with
    the snapshot bit for bit; with ``fail``, rank H17_CK_FAIL_RANK exits
    at step H17_CK_FAIL_STEP of generation 0."""
    from paddle_tpu_torch.distributed import checkpoint as ck

    gen = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
    rank = ptd.get_rank()
    model = h17_gpt(H17_CK_LAYERS, torch.bfloat16)
    opt = h16_adam(model, torch.bfloat16, H16_RUN_ADAM)
    init, step, shard = h17_step(model, opt)
    state = init()
    auto = ck.AutoCheckpoint(os.path.join(out_dir, "auto"), H17_CK_INTERVAL,
                             max_to_keep=H17_CK_STEPS)
    start, out = 0, {"generation": gen}
    latest = auto.latest()
    if latest is not None:
        sd = ck.load_state_dict(latest)
        model.set_state_dict({k: v for k, v in sd.items()
                              if not k.startswith("opt:")})
        opt.set_state_dict({k[4:]: v for k, v in sd.items()
                            if k.startswith("opt:")})
        start = auto._step = int(os.path.basename(latest).split("_")[1])
        now = h17_ck_state(model, opt)
        out.update(resumed_from=start, resumed_at=time.time(),
                   resume_exact=sorted(now) == sorted(sd) and all(
                       torch.equal(torch.as_tensor(now[k]).cpu().float(),
                                   torch.as_tensor(sd[k]).float())
                       for k in sd))
    losses = []
    for i in range(start, H17_CK_STEPS):
        if fail and gen == 0 and rank == H17_CK_FAIL_RANK and \
                i + 1 == H17_CK_FAIL_STEP:
            with open(os.path.join(out_dir, "failed_at"), "w") as f:
                f.write(repr(time.time()))
            sys.stdout.flush()
            os._exit(H17_CK_FAIL_CODE)
        ids, labels = h17_batch(i)
        loss, _ = step(state, (0, i), None, shard([ids]), shard([labels]))
        losses.append(float(loss))
        auto.step(lambda: h17_ck_state(model, opt))
    out["losses"] = losses
    return out


def h17_trainer(argv) -> int:
    """A trainer of phase 17 under the launcher: ``argv`` = (leg, out
    directory); joins the process group from the launcher's environment
    (``PADDLE_MASTER``, gloo), runs the leg and writes its result as
    ``rank{r}.json`` there."""
    leg, out_dir = argv
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    ptd.init_parallel_env(timeout_s=H17_RANK_TIMEOUT_S)
    rank = ptd.get_rank()
    try:
        out = {"seconds": {}}
        # (c)'s unbroken run rides the (a) + (b) launch
        legs = ((("check_ring", lambda: h17_check("ring")),
                 ("check_ulysses", lambda: h17_check("ulysses")),
                 ("run", h17_run),
                 ("ck", lambda: h17_ck(os.path.join(out_dir, "whole"),
                                       False)))
                if leg == "ab" else
                (("ck", lambda: h17_ck(out_dir, True)),))
        for name, fn in legs:
            t0 = time.perf_counter()
            out[name] = fn()
            out["seconds"][name] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        return 0
    finally:
        ptd.destroy_process_group()


def h17_launch(leg: str, out_dir: str, max_restart: int = 0) -> tuple:
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4``
    of the phase's trainer script: its exit code must be 0 (a rank that
    fails or outlasts H17_JOIN_TIMEOUT_S fails the phase; its process
    group is killed). Returns the ranks' results and the seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(out_dir, "trainer.py")
    with open(script, "w") as f:
        f.write(H17_TRAINER.format(root=root))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(H17_WORLD), "--max_restart",
           str(max_restart), "--log_dir", os.path.join(out_dir, "log"),
           script, leg, out_dir]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=out_dir,
                            start_new_session=True)
    try:
        code = proc.wait(timeout=H17_JOIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        code = "timeout"
    seconds = time.perf_counter() - t0
    if code != 0:
        tails = {}
        for name in sorted(os.listdir(os.path.join(out_dir, "log"))):
            with open(os.path.join(out_dir, "log", name)) as f:
                tails[name] = f.read()[-3000:]
        raise RuntimeError(f"phase 17 launch {leg!r}: exit {code} after "
                           f"{seconds:.1f} s; worker logs' tails {tails}")
    ranks = []
    for r in range(H17_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, seconds


def h17_one_rank_run(card_line) -> dict:
    """(b) beside sp4: the same model on one rank at b1 x s8192,
    H17_ONE_WARMUP + H17_ONE_STEPS steps: ms a step, peak memory."""
    model = h17_gpt(H17_RUN_LAYERS, torch.bfloat16)
    opt = h16_adam(model, torch.bfloat16, H16_RUN_ADAM)
    ids, labels = h17_batch()

    def one():
        loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    losses = [float(one()) for _ in range(H17_ONE_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    timed = [one() for _ in range(H17_ONE_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    out = {"ms": 1e3 * wall / H17_ONE_STEPS,
           "tokens_per_s": H17_SEQ * H17_ONE_STEPS / wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": losses + [float(t) for t in timed],
           "flash_per_step": {k: counts[k] / H17_ONE_STEPS
                              for k in ("flash_fwd", "flash_bwd")}}
    log(f"  (b) one rank, the same GPT-350M bf16 {H17_RUN_LAYERS} layers at "
        f"b1 x s{H17_SEQ} (flash causal [1, 16, {H17_SEQ}, 64]): "
        f"{out['ms']:.1f} ms a step, {out['tokens_per_s']:.1f} tokens/s, "
        f"peak {out['peak_gib']:.2f} GiB, losses "
        f"{[round(x, 4) for x in out['losses']]}, flash a step "
        f"{out['flash_per_step']} [{card_line}]")
    del model, opt
    torch.cuda.empty_cache()
    return out


def h17_interop(card_line) -> dict:
    """(d): a checkpoint the reference wrote (H17_REF_CKPT) loaded on the
    card; the loss of its next batch against the reference's. Without one
    in this checkout (it is made on a machine with JAX), the port writes
    the same model's checkpoint in the reference's format and the loss is
    held against the port's CPU run of it."""
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.text import GPTConfig
    from paddle_tpu_torch.text.convert import (state_dict_from_jax,
                                               state_dict_to_jax)

    have = os.path.exists(os.path.join(H17_REF_CKPT, "state.pdparams"))
    if have:
        with open(os.path.join(H17_REF_CKPT, "reference.json")) as f:
            ref = json.load(f)
        cfg = GPTConfig(**ref["config"])
        batch = np.load(os.path.join(H17_REF_CKPT, "batch.npz"))
        path, want, source = H17_REF_CKPT, ref["loss"], "the reference's"
    else:
        cfg = GPTConfig(vocab_size=8192, hidden_size=512, num_layers=2,
                        num_heads=8, max_seq_len=256, dropout=0.0)
        cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32,
                             generator=torch.Generator().manual_seed(SEED))
        rng = np.random.default_rng(SEED)
        ids = rng.integers(0, cfg.vocab_size, (2, 257))
        batch = {"ids": ids[:, :-1], "labels": ids[:, 1:]}
        path = tempfile.mkdtemp(prefix="chip_smoke_h17d_")
        ck.save_state_dict(state_dict_to_jax(cpu.state_dict(), cfg), path)
        cpu.train()
        with torch.no_grad():
            want = float(cpu(torch.as_tensor(batch["ids"]),
                             labels=torch.as_tensor(batch["labels"])))
        source = "the port's CPU float32 (no reference checkpoint here)"
    sd = ck.load_state_dict(path)
    nbytes = os.path.getsize(os.path.join(path, "state.pdparams"))
    if not have:
        shutil.rmtree(path, ignore_errors=True)
    model = GPTForCausalLM(cfg, device="cuda")
    missing, unexpected = model.set_state_dict(state_dict_from_jax(
        {k: v.numpy() for k, v in sd.items()}, cfg))
    model.train()
    with torch.no_grad():
        loss = float(model(torch.as_tensor(batch["ids"], device="cuda"),
                           labels=torch.as_tensor(batch["labels"],
                                                  device="cuda")))
    out = {"loss": loss, "want": want, "source": source,
           "rel": abs(loss - want) / abs(want), "bytes": nbytes,
           "reference_written": have}
    log(f"  (d) a checkpoint {'the reference wrote on the CPU' if have else 'in the reference format, written here'} "
        f"({nbytes} bytes, {sum(v.numel() for v in sd.values())} values) "
        f"loaded on the card: the next batch's loss {loss:.6f} against "
        f"{source} {want:.6f} (rel {out['rel']:.3e}, limit {H17_D_RTOL}) "
        f"[{card_line}]")
    if missing or unexpected or out["rel"] > H17_D_RTOL:
        raise RuntimeError(f"phase 17 (d): {out}, missing {missing}, "
                           f"unexpected {unexpected}")
    return out


def h17_drift(a, b, init) -> float:
    """``|b - a| / |a - init|`` over the model's entries of two snapshots
    (float64 norms)."""
    num = den = 0.0
    for k, w0 in init.items():
        wa, wb = a[k].double(), b[k].double()
        num += float(((wb - wa) ** 2).sum())
        den += float(((wa - w0.double()) ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5


def h17_restart(card_line, whole, whole_dir) -> dict:
    """(c) through the launcher: the unbroken run (``whole``, the (a) +
    (b) launch's last leg, its snapshots under ``whole_dir``), then a
    launch where rank H17_CK_FAIL_RANK fails at step H17_CK_FAIL_STEP and
    the controller restarts the pod at generation 1 (``--max_restart
    1``), which resumes from ``AutoCheckpoint.latest()``; their snapshots
    compared as the constants' comment says."""
    from paddle_tpu_torch.distributed import checkpoint as ck

    init = {k: v.detach().float().cpu() for k, v in
            h17_gpt(H17_CK_LAYERS, torch.bfloat16).state_dict().items()}
    dirs = {"whole": whole_dir,
            "fault": tempfile.mkdtemp(prefix="chip_smoke_h17fault_")}
    try:
        fault, fault_s = h17_launch("ck_fault", dirs["fault"], max_restart=1)
        with open(os.path.join(dirs["fault"], "failed_at")) as f:
            failed_at = float(f.read())
        drift, byte_equal = {}, {}
        for snap in sorted(os.listdir(os.path.join(dirs["fault"], "auto"))):
            paths = [os.path.join(dirs[k], "auto", snap, "state.pdparams")
                     for k in ("whole", "fault")]
            with open(paths[0], "rb") as f1, open(paths[1], "rb") as f2:
                byte_equal[snap] = f1.read() == f2.read()
            a, b = (ck.load_state_dict(os.path.dirname(p)) for p in paths)
            drift[snap] = h17_drift(a, b, init)
        ck_bytes = os.path.getsize(os.path.join(
            dirs["fault"], "auto", "step_2", "state.pdparams"))
    finally:
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    gens = [r["ck"]["generation"] for r in fault]
    resumed = [r["ck"].get("resumed_from") for r in fault]
    exact = [r["ck"].get("resume_exact") for r in fault]
    after = whole[0]["ck"]["losses"][H17_CK_FAIL_STEP - 1:]
    got = fault[0]["ck"]["losses"]
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(got, after))
    noise = drift["step_2"]
    limit = H17_CK_DRIFT_FACTOR * noise + H17_CK_DRIFT_FLOOR
    out = {"generations": gens, "resumed_from": resumed,
           "resume_exact": exact,
           "restart_s": min(r["ck"]["resumed_at"] for r in fault) - failed_at,
           "whole_s": whole[0]["seconds"]["ck"], "fault_s": fault_s,
           "drift": drift,
           "drift_limit": limit, "snapshots_byte_equal": byte_equal,
           "loss_rel": loss_rel, "checkpoint_bytes": ck_bytes,
           "losses_whole": whole[0]["ck"]["losses"], "losses_resumed": got}
    log(f"  (c) AutoCheckpoint every {H17_CK_INTERVAL} steps, "
        f"{H17_CK_LAYERS} layers bf16 sp4, {H17_CK_STEPS} steps: rank "
        f"{H17_CK_FAIL_RANK} exited {H17_CK_FAIL_CODE} at step "
        f"{H17_CK_FAIL_STEP}; the launcher restarted the pod at generation "
        f"{sorted(set(gens))}, every rank resumed from step "
        f"{sorted(set(resumed))} {out['restart_s']:.2f} s after the "
        f"failure, its state then equal to the snapshot bit for bit: "
        f"{exact} (the unbroken run {out['whole_s']:.1f} s on its ranks, "
        f"the launch with the fault {fault_s:.1f} s); checkpoint {ck_bytes} bytes (model, AdamW "
        f"moments, float32 masters, step); losses after the resume "
        f"{[round(x, 6) for x in got]} against the unbroken run's "
        f"{[round(x, 6) for x in after]} (rel {loss_rel:.2e}, limit "
        f"{H17_CK_LOSS_RTOL}); the two runs' weights apart by "
        f"{ {k: f'{v:.3e}' for k, v in drift.items()} } of the unbroken "
        f"run's change (step 2: the run-to-run noise before the fault; "
        f"limit after it {limit:.3e}); snapshots byte-equal {byte_equal} "
        f"(the flash backward's dq order) [{card_line}]")
    if set(gens) != {1} or set(resumed) != {H17_CK_INTERVAL} or \
            not all(exact) or loss_rel > H17_CK_LOSS_RTOL or \
            any(v > limit for k, v in drift.items() if k != "step_2"):
        raise RuntimeError(f"phase 17 (c): {out}")
    return out


def sp_phase_ab(card_line: str, ranks) -> None:
    """Phase 17 (a) and (b): each rank's readings printed, and held to
    their limits and predictions."""
    where = f"{H17_WORLD} ranks on cuda:0 over gloo, started by the launcher"
    for r, res in enumerate(ranks):
        for att in ("ring", "ulysses"):
            a = res[f"check_{att}"]
            log(f"  (a) rank {r} sp4 {att}, GPT-350M width, "
                f"{H17_CHECK_LAYERS} layers, float32, b1 x s{H17_SEQ}: loss "
                f"{a['loss']:.6f} against the one-rank step's "
                f"{a['one_rank_loss']:.6f} (rel {a['loss_rel']:.3e}, limit "
                f"{H17_LOSS_RTOL}); gradients summed over the ranks within "
                f"{a['grad_rel']:.3e} of each tensor's largest entry (worst "
                f"{a['grad']}; limit {H17_GRAD_RTOL}); updated parameters "
                f"within {a['param_rel']:.3e} of their largest entry "
                f"(worst {a['param']}; limit {H17_PARAM_RTOL}) "
                f"[{card_line}]")
            if a["loss_rel"] > H17_LOSS_RTOL or \
                    a["grad_rel"] > H17_GRAD_RTOL or \
                    a["param_rel"] > H17_PARAM_RTOL:
                raise RuntimeError(f"phase 17 (a) rank {r} {att}: {a}")
    for r, res in enumerate(ranks):
        b = res["run"]
        log(f"  (b) rank {r} GPT-350M bf16 {H17_RUN_LAYERS} layers b1 x "
            f"s{H17_SEQ} sp4 ring ({where}; a rank: s_local "
            f"{H17_SEQ // H17_WORLD}): {b['ms']:.1f} ms a step, "
            f"{b['tokens_per_s']:.1f} tokens/s over the 4 ranks; losses "
            f"{[round(x, 4) for x in b['losses']]}; peak "
            f"{b['peak_gib']:.2f} GiB; launches a step "
            f"{b['launches_per_step']} (predicted {b['expected_per_step']});"
            f" ring blocks a step {b['blocks_per_step']} (predicted "
            f"{b['blocks_expected']}); ring bytes a step sent / received "
            f"{[int(v) for v in b['ring_bytes_per_step']]} (predicted "
            f"{b['ring_bytes_expected']} each) [{card_line}]")
        if b["launches_per_step"] != {k: float(v) for k, v in
                                      b["expected_per_step"].items()} or \
                b["blocks_per_step"] != {k: float(v) for k, v in
                                         b["blocks_expected"].items()} or \
                b["ring_bytes_per_step"] != [float(b["ring_bytes_expected"])] * 2:
            raise RuntimeError(f"phase 17 (b) rank {r}: launches, blocks or "
                               f"ring bytes differ from the prediction: {b}")
        losses = b["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"phase 17 (b) rank {r}: losses {losses}")


def sp_phase(card_line: str, gen) -> dict:
    """Phase 17: (a) and (b) on four ranks started by the port's
    launcher, the one-rank s8192 step, (c) the restart through the
    launcher, (d) the reference's checkpoint; then the flash kernels
    timed at the ring's and the one-rank step's causal shapes."""
    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_h17_")
    try:
        ranks, launch_s = h17_launch("ab", out_dir)
        sp_phase_ab(card_line, ranks)
        restart = h17_restart(card_line, ranks, os.path.join(out_dir,
                                                             "whole"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    one = h17_one_rank_run(card_line)
    interop = h17_interop(card_line)
    times = {}
    for label, s_len in (("ring_diagonal", H17_SEQ // H17_WORLD),
                         ("one_rank", H17_SEQ)):
        times[label], _ = time_flash_at(gen, 1, 16, s_len, 64, True)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"  phase 17 took {seconds:.1f} s (the (a)+(b) launch "
        f"{launch_s:.1f} s; legs on rank 0: "
        f"{ {k: round(v, 1) for k, v in ranks[0]['seconds'].items()} })")
    return {"ranks": ranks, "one_rank": one, "restart": restart,
            "interop": interop, "flash_times": times, "seconds": seconds}


# --------------------------------------------------------------- phase 18
# auto-parallel and the fleet executor (item 12e-2b): GPT-350M at phase
# 16's width and batch, annotated in part with ``shard_tensor`` (the qkv
# and fc1 weights on their output features, the word embedding on the
# vocabulary; ``tests/test_auto_parallel.py``'s annotations), the rest
# completed; ``Engine.fit`` over four ranks sharing cuda:0 over gloo (as
# phase 16 starts them) on a given dp2 x mp2 ``ProcessMesh``
H18_WORLD, H18_JOIN_TIMEOUT_S = 4, 600.0
H18_CHECK_LAYERS, H18_RUN_LAYERS = 2, TRAIN_RUNG["layers"]
# (b)'s check: float32 at 2 layers, two steps; the completed run against
# the apply_megatron_specs run (the reference's done-criterion) and both
# against phase 16's train_batch at that layout (H16_LOSS_RTOL)
H18_CHECK_STEPS, H18_SAME_RTOL = 2, 1e-5
# (b)'s run: bf16 at full depth, dropout H16_DROPOUT, 2 warm-up steps and
# 3 timed; (c): three steps of an Engine given no mesh
H18_WARMUP, H18_STEPS, H18_PLAN_STEPS = 2, 3, 3
# (d): two stages of 12 blocks over 4 micro-batches of phase 16's batch;
# the executor's logits against the one-rank forward's within 1e-2 of the
# largest (bf16's 8-bit mantissa), the TCP run's bit for bit against the
# one-process run's
H18_MICRO, H18_LOGITS_RTOL, H18_TIMED_RUNS = 4, 1e-2, 3


def h18_annotate(model, mesh):
    from paddle_tpu_torch.distributed.auto_parallel import shard_tensor

    for name, p in model.named_parameters():
        if name.endswith(("qkv_proj.weight", "fc1.weight")):
            shard_tensor(p, mesh, [None, "mp"])
        if name.endswith("wte.weight"):
            shard_tensor(p, mesh, ["mp", None])


def h18_mesh():
    from paddle_tpu_torch.distributed.auto_parallel import ProcessMesh

    return ProcessMesh(np.arange(4).reshape(2, 2), dim_names=["dp", "mp"])


def h18_inputs_spec():
    return [torch.zeros(H16_BATCH, H16_SEQ, dtype=torch.long)]


def h18_completion(card_line) -> dict:
    """(a): complete_param_specs on the card's GPT-350M (24 layers) and on
    a CPU copy; the completed specs named, held equal."""
    from paddle_tpu_torch.distributed.auto_parallel import \
        complete_param_specs

    specs, seconds = [], []
    ids = torch.zeros(H16_BATCH, H16_SEQ, dtype=torch.long)
    for where in ("cuda", "cpu"):
        cfg = gpt_config("gpt3-350m", num_layers=H18_RUN_LAYERS,
                         max_seq_len=H16_SEQ)
        model = h16_gpt(H18_RUN_LAYERS) if where == "cuda" else \
            GPTForCausalLM(cfg, device="cpu")
        h18_annotate(model, h18_mesh())
        t0 = time.perf_counter()
        complete_param_specs(model, [ids.to(where)])
        seconds.append(time.perf_counter() - t0)
        specs.append({n: getattr(p, "_sharding_spec", None)
                      for n, p in model.named_parameters()})
        n_params = sum(p.numel() for p in model.parameters())
        del model
        torch.cuda.empty_cache()
    card, host = specs
    names = [n for n in card if n.endswith(("fc2.weight", "fc1.bias",
                                            "qkv_proj.bias"))]
    want = {n: ("mp", None) if n.endswith("fc2.weight") else ("mp",)
            for n in names}
    got = {n: card[n] for n in names}
    counts = collections.Counter(str(v) for v in card.values())
    log(f"  (a) completion of GPT-350M ({H18_RUN_LAYERS} layers, ids "
        f"[{H16_BATCH}, {H16_SEQ}]) from {2 * H18_RUN_LAYERS + 1} "
        f"annotated weights: the trace and propagation {seconds[0]:.2f} s "
        f"(the card's model) / {seconds[1]:.2f} s (its CPU copy); specs "
        f"{dict(counts)}; every fc2.weight ('mp', None), every fc1.bias and "
        f"qkv_proj.bias ('mp',): {got == want}; the card's equal to the CPU "
        f"copy's on all {len(card)} parameters: {card == host} [{card_line}]")
    if got != want or card != host or len(names) != 3 * H18_RUN_LAYERS:
        raise RuntimeError(f"phase 18 (a): {got} / {card == host}")
    return {"seconds": seconds, "counts": dict(counts), "n_params": n_params}


def h18_plans(card_line, n_params) -> dict:
    """(c): plan_parallel for GPT-350M on one node of 4 H100s and on 4
    nodes of 8."""
    from paddle_tpu_torch.distributed.auto_parallel import (Cluster,
                                                            ModelDesc,
                                                            plan_parallel)

    desc = ModelDesc(n_params=n_params, layers=H18_RUN_LAYERS, hidden=1024,
                     heads=16, seq=H16_SEQ, batch=H16_BATCH, dtype_bytes=2)
    out = {}
    for label, (hosts, chips) in (("h100 1x4", (1, 4)), ("h100 4x8", (4, 8))):
        cluster = Cluster("h100", hosts, chips)
        plan = plan_parallel(cluster.n_chips, desc, cluster)
        placement = plan.process_mesh(cluster).placement
        out[label] = {"plan": plan.axis_sizes, "time_ms": 1e3 * plan.time,
                      "t_comm_ms": {k: 1e3 * v for k, v in plan.t_comm.items()},
                      "placement": placement,
                      "per_chip_gb": plan.per_chip_bytes / 1e9,
                      "candidates": len(plan.candidates)}
        log(f"  (c) plan_parallel GPT-350M ({n_params:,} parameters, batch "
            f"{H16_BATCH} x {H16_SEQ}, bf16) on Cluster('h100', {hosts}, "
            f"{chips}): {plan.axis_sizes}, predicted {1e3 * plan.time:.3f} "
            f"ms a step (the data sheet's constants; {len(plan.candidates)}"
            f" candidates), comm ms by axis "
            f"{ {k: round(1e3 * v, 4) for k, v in plan.t_comm.items()} }, "
            f"placement {placement}, {plan.per_chip_bytes / 1e9:.2f} GB a "
            f"card [{card_line}]")
    return out


def h18_engine(layers, dtype, dropout, annotate, mesh=True):
    """A prepared Engine over the four ranks and its optimizer: GPT-350M
    width at ``layers``, ``annotate`` "partial" (h18_annotate, then
    completion) or "megatron" (apply_megatron_specs) or None; on
    h18_mesh, or (``mesh`` False) on the planner's."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.auto_parallel import Engine

    model = h16_gpt(layers, dtype, dropout)
    pm = h18_mesh() if mesh else None
    if annotate == "partial":
        h18_annotate(model, pm)
    elif annotate == "megatron":
        fleet.apply_megatron_specs(model)
    hyper = H16_CHECK_ADAM if dtype == torch.float32 else H16_RUN_ADAM
    opt = h16_adam(model, dtype, hyper)
    eng = Engine(model=model, optimizer=opt, process_mesh=pm)
    eng.prepare(inputs_spec=h18_inputs_spec() if annotate else None)
    return eng, opt


def h18_check(ids, labels) -> dict:
    """(b)'s check: the completed Engine, the apply_megatron_specs
    Engine and phase 16's train_batch at dp2 x mp2, float32, 2 layers."""
    from paddle_tpu_torch.distributed import fleet

    out = {}
    for annotate in ("partial", "megatron"):
        eng, _ = h18_engine(H18_CHECK_LAYERS, torch.float32, 0.0, annotate)
        out[annotate] = eng.fit([(ids, labels)] * H18_CHECK_STEPS,
                                log_freq=1)["loss"]
        out[annotate + "_layout"] = dict(collections.Counter(
            eng.layout.values()))
        del eng
    f = h16_init(h16_fleet(dp_degree=2, mp_degree=2))
    model = h16_gpt(H18_CHECK_LAYERS)
    fleet.apply_megatron_specs(model)
    opt = h16_adam(model, torch.float32, H16_CHECK_ADAM)
    dm = f.distributed_model(model)
    dopt = f.distributed_optimizer(opt)
    out["train_batch"] = [float(dm.train_batch([ids, labels], dopt))
                          for _ in range(H18_CHECK_STEPS)]
    return out


def h18_run(ids, labels, out_dir) -> dict:
    """(b)'s run: bf16 at full depth through Engine.fit (warm-up, then
    timed steps between the counters' reset and their reading), then
    evaluate, predict, save, and load into a fresh Engine."""
    from paddle_tpu_torch.distributed.auto_parallel import Engine

    eng, opt = h18_engine(H18_RUN_LAYERS, torch.bfloat16, H16_DROPOUT,
                          "partial")
    eng.fit([(ids, labels)] * H18_WARMUP, log_freq=1)
    want, _ = h16_predicted(eng.model, opt, H18_RUN_LAYERS, H16_DROPOUT,
                            eng._dm._hcg, eng.strategy.fuse_grad_size_in_MB)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()  # every kernel's count, just before the path
    with collective.census() as calls:
        t0 = time.perf_counter()
        eng.fit([(ids, labels)] * H18_STEPS, log_freq=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    per_step, bytes_step = h16_census(calls, H18_STEPS)
    out = {"losses": list(eng.history["loss"]), "ms": 1e3 * wall / H18_STEPS,
           "tokens_per_s": H16_BATCH * H16_SEQ * H18_STEPS / wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_step": {k: v / H18_STEPS for k, v in counts.items()
                                 if v},
           "expected_per_step": want, "census": per_step,
           "census_bytes": bytes_step,
           "layout": dict(collections.Counter(eng.layout.values()))}
    t0 = time.perf_counter()
    out["eval"] = eng.evaluate([(ids, labels)])["loss"]
    out["eval_again"] = eng.evaluate([(ids, labels)])["loss"]
    pred = eng.predict([(ids[:1],)])[0][0]
    out["pred_shape"] = list(pred.shape)
    out["pred_finite"] = bool(np.isfinite(pred).all())
    path = os.path.join(out_dir, "gpt350m")
    eng.save(path)
    out["saved_bytes"] = os.path.getsize(path + ".pdparams")
    out["state"] = h18_state_digest(eng.model)
    del eng, opt, pred
    gc.collect()
    torch.cuda.empty_cache()
    fresh = h16_gpt(H18_RUN_LAYERS, torch.bfloat16, H16_DROPOUT)
    h18_annotate(fresh, h18_mesh())
    eng2 = Engine(model=fresh, process_mesh=h18_mesh())
    eng2.prepare(inputs_spec=h18_inputs_spec())
    eng2.load(path)
    out["state_loaded"] = h18_state_digest(eng2.model)
    out["eval_loaded"] = eng2.evaluate([(ids, labels)])["loss"]
    out["eval_save_load_s"] = time.perf_counter() - t0
    del eng2, fresh
    return out


def h18_state_digest(model) -> dict:
    """A digest of each entry of this rank's state."""
    import hashlib

    return {k: hashlib.sha256(v.detach().contiguous().view(torch.uint8)
                              .cpu().numpy().tobytes()).hexdigest()
            for k, v in model.state_dict().items()}


def h18_planned(ids, labels) -> dict:
    """(c): an Engine given no mesh (plan_mesh over the four ranks), float32
    at 2 layers, three steps."""
    eng, _ = h18_engine(H18_CHECK_LAYERS, torch.float32, 0.0, None,
                        mesh=False)
    losses = eng.fit([(ids, labels)] * H18_PLAN_STEPS, log_freq=1)["loss"]
    return {"mesh": dict(zip(eng.process_mesh.dim_names,
                             eng.process_mesh.shape)), "losses": losses,
            "zero": eng._dm._zero is not None}


def h18_stages(model, split):
    """``model`` (the port's GPT) as two stage functions: the embeddings
    and blocks ``[0, split)``; the rest, the final LayerNorm and the tied
    head."""
    g = model.gpt

    def first(x):
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        x = g.drop(g.wte(x) + g.wpe(pos))
        for blk in g.blocks[:split]:
            x = blk(x)
        return x

    def second(x):
        for blk in g.blocks[split:]:
            x = blk(x)
        return F.linear(g.ln_f(x), g.wte.weight)

    return first, second


def h18_nodes(first, second, micro):
    """Source -> stage 1 (rank 0) -> stage 2 -> Sink (rank 1)."""
    from paddle_tpu_torch.distributed.fleet_executor import TaskNode

    n = len(micro)
    nodes = [TaskNode(0, rank=0, max_run_times=n, type="Source",
                      run_fn=lambda i: micro[i]),
             TaskNode(1, rank=0, max_run_times=n, type="Compute",
                      run_fn=first),
             TaskNode(2, rank=1, max_run_times=n, type="Compute",
                      run_fn=second),
             TaskNode(3, rank=1, max_run_times=n, type="Sink")]
    for a, b in zip(nodes, nodes[1:]):
        a.add_downstream_task(b.task_id, 2)
        b.add_upstream_task(a.task_id, 2)
    return nodes


def h18_exec_launches() -> dict:
    """(d)'s kernels over the micro-batches: a flash forward a block,
    two LayerNorm forwards a block and the final one."""
    return {"flash_fwd": H18_RUN_LAYERS * H18_MICRO,
            "ln_fwd": (2 * H18_RUN_LAYERS + 1) * H18_MICRO}


def h18_digest(outs) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()


def h18_tcp(rank, ids) -> dict:
    """(d) over TCP: rank 0 holds the source and stage 1, rank 1 stage 2
    and the sink, each in its own process with its own MessageBus (the
    endpoints exchanged over gloo); ranks 2 and 3 wait."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import fleet_executor as fe

    os.environ["PADDLE_PS_BIND_HOST"] = "127.0.0.1"
    bus = fe.MessageBus()
    srv, port = bus.serve()
    ports = [None] * H18_WORLD
    dist.all_gather_object(ports, port)
    out = {}
    if rank < 2:
        model = h16_gpt(H18_RUN_LAYERS, torch.bfloat16)
        model.eval()
        first, second = h18_stages(model, H18_RUN_LAYERS // 2)
        bus.register_remote(1 - rank, f"127.0.0.1:{ports[1 - rank]}")
        micro = list(ids.chunk(H18_MICRO))
        exe = fe.FleetExecutor(h18_nodes(first, second, micro), bus=bus,
                               local_ranks={rank}, devices="cuda:0")
        t0 = time.perf_counter()
        with torch.no_grad():
            got = exe.run(timeout=120.0)
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        if rank == 1:
            out["digest"] = h18_digest(got)
        del model, got
    ptd.barrier()   # both servers up until every message is delivered
    srv.shutdown()
    bus.close()
    return out


def h18_rank(rank: int, world: int, init_method: str, out_dir: str) -> dict:
    """One rank of phase 18, a spawned process on cuda:0: (b)'s check and
    run, (c)'s planned Engine and (d) over TCP."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    ptd.init_parallel_env(H16_BACKEND, init_method, world, rank,
                          timeout_s=H16_RANK_TIMEOUT_S)
    try:
        ids, labels = h16_batch(gpt_config("gpt3-350m").vocab_size)
        out = {"seconds": {}}
        for leg, fn in (("check", lambda: h18_check(ids, labels)),
                        ("run", lambda: h18_run(ids, labels, out_dir)),
                        ("planned", lambda: h18_planned(ids, labels)),
                        ("tcp", lambda: h18_tcp(rank, ids))):
            t0 = time.perf_counter()
            out[leg] = fn()
            out["seconds"][leg] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
        return out
    finally:
        ptd.destroy_process_group()


def h18_one_process(card_line, tcp_digest) -> dict:
    """(d) in this process: the two stages on two carriers of one
    executor, the logits against the one-rank forward and the TCP run's;
    the executor's ms a micro-batch against calling the stages directly."""
    from paddle_tpu_torch.distributed import fleet_executor as fe

    model = h16_gpt(H18_RUN_LAYERS, torch.bfloat16)
    model.eval()
    ids, _ = h16_batch(gpt_config("gpt3-350m").vocab_size)
    micro = list(ids.chunk(H18_MICRO))
    first, second = h18_stages(model, H18_RUN_LAYERS // 2)

    def run_executor():
        exe = fe.FleetExecutor(h18_nodes(first, second, micro),
                               devices="cuda:0")
        with torch.no_grad():
            got = exe.run(timeout=120.0)
        torch.cuda.synchronize()
        return got

    torch.cuda.synchronize()
    reset_counters()
    got = run_executor()
    counts = {k: v for k, v in launch_counts().items() if v}
    with torch.no_grad():
        want = [model(m) for m in micro]
    rel = max(float((a.float() - b.float()).abs().max()) for a, b in
              zip(got, want)) / max(float(b.float().abs().max()) for b in want)
    digest = h18_digest(got)
    del got, want
    exe_ms, direct_ms = [], []
    for _ in range(H18_TIMED_RUNS):   # in turns
        t0 = time.perf_counter()
        run_executor()
        exe_ms.append(1e3 * (time.perf_counter() - t0) / H18_MICRO)
        t0 = time.perf_counter()
        with torch.no_grad():
            for m in micro:
                second(first(m))
        torch.cuda.synchronize()
        direct_ms.append(1e3 * (time.perf_counter() - t0) / H18_MICRO)
    want_launches = h18_exec_launches()
    out = {"logits_rel": rel, "tcp_equal": digest == tcp_digest,
           "launches": counts, "expected": want_launches,
           "executor_ms": exe_ms, "direct_ms": direct_ms}
    log(f"  (d) GPT-350M bf16 in two stages of {H18_RUN_LAYERS // 2} blocks, "
        f"Source -> Compute -> Compute -> Sink over {H18_MICRO} micro-batches "
        f"of [{H16_BATCH // H18_MICRO}, {H16_SEQ}]: logits within {rel:.3e} "
        f"of the one-rank forward's (relative to the largest; limit "
        f"{H18_LOGITS_RTOL}); over TCP, a stage a process, bit for bit the "
        f"one-process run's: {out['tcp_equal']}; launches {counts} "
        f"(predicted {want_launches}); ms a micro-batch through the executor "
        f"{[round(v, 3) for v in exe_ms]} against the stages called directly "
        f"{[round(v, 3) for v in direct_ms]} (in turns) [{card_line}]")
    if rel > H18_LOGITS_RTOL or not out["tcp_equal"] or \
            counts != want_launches:
        raise RuntimeError(f"phase 18 (d): {out}")
    del model
    torch.cuda.empty_cache()
    return out


def h18_report(card_line, ranks) -> None:
    """Each rank's (b) and (c), printed and held to their limits."""
    where = f"{H18_WORLD} ranks on cuda:0 over {H16_BACKEND}"
    for r, res in enumerate(ranks):
        c = res["check"]
        same = max(abs(a - b) / abs(b) for a, b in
                   zip(c["partial"], c["megatron"]))
        vs16 = max(abs(a - b) / abs(b) for run in ("partial", "megatron")
                   for a, b in zip(c[run], c["train_batch"]))
        log(f"  (b) rank {r} check, dp2 x mp2, {H18_CHECK_LAYERS} layers, "
            f"float32: Engine.fit losses completed {c['partial']} (layout "
            f"{c['partial_layout']}), apply_megatron_specs {c['megatron']} "
            f"(layout {c['megatron_layout']}): within {same:.3e} (limit "
            f"{H18_SAME_RTOL}); phase 16's train_batch {c['train_batch']}: "
            f"within {vs16:.3e} (limit {H16_LOSS_RTOL}) [{card_line}]")
        if same > H18_SAME_RTOL or vs16 > H16_LOSS_RTOL:
            raise RuntimeError(f"phase 18 (b) check rank {r}: {c}")
    for r, res in enumerate(ranks):
        b = res["run"]
        log(f"  (b) rank {r} Engine.fit GPT-350M bf16 {H18_RUN_LAYERS} layers"
            f" dp2 x mp2 ({where}), completed from the partial annotations "
            f"(layout {b['layout']}): {b['ms']:.1f} ms a step, "
            f"{b['tokens_per_s']:.1f} tokens/s over the 4 ranks; losses "
            f"{[round(x, 4) for x in b['losses']]}; peak "
            f"{b['peak_gib']:.2f} GiB; launches a step "
            f"{b['launches_per_step']} (predicted {b['expected_per_step']});"
            f" census a step "
            f"{ {h16_key(k): v for k, v in b['census'].items()} }, bytes "
            f"{ {h16_key(k): int(v) for k, v in b['census_bytes'].items()} };"
            f" evaluate {b['eval']:.7f} (again {b['eval_again']:.7f}), "
            f"after save ({b['saved_bytes']:,} bytes) and load into a fresh "
            f"Engine {b['eval_loaded']:.7f} (equal: "
            f"{b['eval_loaded'] == b['eval']}), the rank's state bit for bit "
            f"the saved engine's: {b['state_loaded'] == b['state']}; predict "
            f"{b['pred_shape']} finite {b['pred_finite']} "
            f"({b['eval_save_load_s']:.1f} s) [{card_line}]")
        losses = b["losses"]
        if b["launches_per_step"] != {k: float(v) for k, v in
                                      b["expected_per_step"].items()} or \
                not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0] or \
                b["eval_loaded"] != b["eval"] or \
                b["eval_again"] != b["eval"] or \
                b["state_loaded"] != b["state"] or not b["pred_finite"]:
            raise RuntimeError(f"phase 18 (b) rank {r}: {b}")
        p = res["planned"]
        log(f"  (c) rank {r} Engine given no mesh: plan_mesh over 4 ranks "
            f"gave {p['mesh']} (ZeRO {p['zero']}); losses {p['losses']} "
            f"[{card_line}]")
        if not p["losses"][-1] < p["losses"][0]:
            raise RuntimeError(f"phase 18 (c) rank {r}: {p}")


def auto_parallel_phase(card_line: str) -> dict:
    """Phase 18: (a) completion here; (b)-(d) on H18_WORLD spawned ranks
    (``h18_rank``); then (d) in this process."""
    t_phase = time.perf_counter()
    comp = h18_completion(card_line)
    plans = h18_plans(card_line, comp["n_params"])
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_h18_")
    try:
        ranks = ptd.spawn(h18_rank, H18_WORLD,
                          args=(f"file://{out_dir}/rendezvous", out_dir),
                          timeout_s=H18_JOIN_TIMEOUT_S)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    h18_report(card_line, ranks)
    torch.cuda.empty_cache()
    one = h18_one_process(card_line, ranks[1]["tcp"]["digest"])
    seconds = time.perf_counter() - t_phase
    log(f"  (d) over TCP: {ranks[1]['tcp']['seconds']:.2f} s for the "
        f"{H18_MICRO} micro-batches on rank 1")
    log(f"  phase 18 took {seconds:.1f} s (legs on rank 0: "
        f"{ {k: round(v, 1) for k, v in ranks[0]['seconds'].items()} })")
    return {"completion": comp, "plans": plans, "ranks": ranks,
            "executor": one, "seconds": seconds}


# ----------------------------------------------------------------- turns
def turn_leg(card_line: str) -> dict:
    """One leg of ``--turns``: with whichever package ``--turn-leg`` put
    first on the path, through the public entry points only, so that this
    checkout's and its parent's run the same code: the LayerNorm forward
    (``layer_norm_forward``) at LN_TURN_SHAPES and LN_SERVING_SHAPES, the
    whole LayerNorm backward (autograd over ``fused_layer_norm``) at
    LN_TURN_SHAPES, dropout at [8, 1024, 1024] bf16 p 0.1 (a forward under
    no_grad, a forward that records, its backward through autograd), each
    with ``time_ms``; the LayerNorm's host cost per call
    (``layernorm_host_us``); phase 5's serving run of gpt3-1.3b (decode
    step ms, tokens/s) and phase 6's decode-step profile; then the dots
    recipe step, ERNIE-3.0-base and Transformer-base as phases 8b and 13
    run them (launches not checked: the two trees count differently),
    each with ms a step, peak memory and one step's device ms by layer."""
    if not hasattr(fl, "reduce_launches"):  # a tree without the counter
        fl.reduce_launches = 0
    global check_launches
    check_launches = lambda *a, **k: None  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    kernels = {}
    for label in LN_TURN_SHAPES + LN_SERVING_SHAPES:
        rows, d = next((r, n) for lab, r, n in LN_SHAPES if lab == label)
        x, g, b, _ = ln_inputs(gen, rows, d, torch.bfloat16)
        kernels[f"layernorm forward {label} [{rows}, {d}]"] = min(
            time_ms(lambda: fl.layer_norm_forward(x, g, b, LN_EPS), flush)
            for _ in range(2))
        del x, g, b
    for label in LN_TURN_SHAPES:
        rows, d = next((r, n) for lab, r, n in LN_SHAPES if lab == label)
        x, g, b, dy = ln_inputs(gen, rows, d, torch.bfloat16)
        xs = [t.clone().requires_grad_() for t in (x, g, b)]
        y = fl.fused_layer_norm(*xs, LN_EPS)
        kernels[f"layernorm backward {label} [{rows}, {d}]"] = min(
            time_ms(lambda: torch.autograd.grad(y, xs, dy,
                                                retain_graph=True), flush)
            for _ in range(2))
        del x, g, b, dy, xs, y
    x = torch.randn(8, 1024, 1024, generator=gen, device="cuda").to(
        torch.bfloat16)
    dy = torch.randn_like(x)
    xg = x.clone().requires_grad_()
    key = (7, 11)
    y = kd.dropout(xg, key, 0.1)
    with torch.no_grad():
        no_grad = lambda: kd.dropout(xg, key, 0.1)  # noqa: E731
        kernels["dropout forward, no grad [8, 1024, 1024]"] = min(
            time_ms(no_grad, flush) for _ in range(2))
    kernels["dropout forward, recorded [8, 1024, 1024]"] = min(
        time_ms(lambda: kd.dropout(xg, key, 0.1), flush) for _ in range(2))
    kernels["dropout backward [8, 1024, 1024]"] = min(
        time_ms(lambda: torch.autograd.grad(y, xg, dy, retain_graph=True),
                flush) for _ in range(2))
    del x, dy, xg, y, flush
    for name, ms in kernels.items():
        log(f"  turn {name}: {ms:.4f} ms [{card_line}]")
    host = layernorm_host_us()
    model = GPTForCausalLM(
        gpt_config(PRESET), dtype=torch.float32,
        generator=torch.Generator("cuda").manual_seed(SEED)) \
        .to(torch.bfloat16)
    served = serve(model, card_line)
    prof = profile_decode(model)
    serving = {"decode_ms": served["decode_ms"], "tok_s": served["tok_s"],
               "profiled_decode_step": prof}
    del model, served
    gc.collect()
    torch.cuda.empty_cache()
    steps = {}
    run = train(card_line, RECIPE_RUNGS[0], TRAIN_STEPS, recipe())
    prof = profile_step(run["built"], run["ids"], run["labels"],
                        RECIPE_RUNGS[0]["tag"])
    steps["gpt dots"] = {"ms": run["ms"], "peak_gib": run["peak_gib"],
                         "profile": prof}
    del run
    import paddle_tpu_torch as paddle
    for name, fn in (("ernie", ernie_pretrain), ("transformer", mt_train)):
        out = fn(paddle, card_line, gen)
        out = out[0] if isinstance(out, tuple) else out
        steps[name] = {k: out[k] for k in ("ms", "peak_gib", "profile")}
        gc.collect()
        torch.cuda.empty_cache()
    return {"kernels": kernels, "host_us": host, "serving": serving,
            "steps": steps}


def turns(parent: str) -> None:
    """``--turns PARENT``: turn legs of the parent's checkout and this one
    in the order parent, this, this, parent, each a process of its own
    that imports its tree's package; then each reading side by side."""
    here = os.path.dirname(os.path.abspath(__file__))
    legs = []
    for tree in (parent, here, here, parent):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn-leg",
             os.path.abspath(tree)], capture_output=True, text=True,
            cwd=here, timeout=TURN_LEG_TIMEOUT_S)
        print(proc.stdout, proc.stderr[-4000:], sep="\n", flush=True)
        if proc.returncode:
            raise RuntimeError(f"turn leg of {tree} failed "
                               f"(exit {proc.returncode})")
        legs.append((tree == parent, json.loads(
            proc.stdout.strip().splitlines()[-1])["turn"]))
    log("== turns: parent, this, this, parent")
    def side_by_side(what, read, fmt):
        log(f"  {what}: " + ", ".join(
            f"{'parent' if p else 'this'} {format(read(leg), fmt)}"
            for p, leg in legs))

    for name in legs[0][1]["kernels"]:
        side_by_side(f"{name} ms", lambda leg: leg["kernels"][name], ".4f")
    for name in legs[0][1]["host_us"]:
        side_by_side(f"layernorm host us a call, {name}",
                     lambda leg: leg["host_us"][name], ".2f")
    for key in ("decode_ms", "tok_s"):
        side_by_side(f"serving {key}", lambda leg: leg["serving"][key],
                     ".3f")
    for key in ("plain_ms", "busy_ms", "ln_fwd_ms"):
        side_by_side(f"profiled decode step {key}", lambda leg: leg[
            "serving"]["profiled_decode_step"].get(key, 0.0), ".4f")
    for name in legs[0][1]["steps"]:
        for key in ("ms", "peak_gib"):
            log(f"  {name} {key}: " + ", ".join(
                f"{'parent' if p else 'this'} {leg['steps'][name][key]:.3f}"
                for p, leg in legs))
        layers = sorted({k for _, leg in legs for k in leg["steps"][name][
            "profile"].get("layers", {})})
        for layer in layers:
            log(f"  {name} device ms, {layer}: " + ", ".join(
                f"{'parent' if p else 'this'} "
                f"{leg['steps'][name]['profile'].get('layers', {}).get(layer, {}).get('ms', 0.0):.3f}"
                for p, leg in legs))
        log(f"  {name} device busy ms: " + ", ".join(
            f"{'parent' if p else 'this'} "
            f"{leg['steps'][name]['profile'].get('busy_ms', 0.0):.3f}"
            for p, leg in legs))
    print(json.dumps({"turns": [{"parent": p, **leg} for p, leg in legs]}),
          flush=True)


def tp_cards(world: int) -> None:
    """``python3 chip_smoke.py --tp-nccl N``: phase 5f across N cards over
    NCCL, a card a rank, against phase 5's outputs served on card 0
    (phases 1, 2 and 5 first); the rest of the script does not run."""
    if torch.cuda.device_count() < world:
        raise SystemExit(f"chip_smoke: --tp-nccl {world} needs {world} "
                         f"cards, {torch.cuda.device_count()} visible")
    phase("1 card")
    card_line = card()
    phase("2 build")
    build()
    phase("5 serve")
    model = GPTForCausalLM(
        gpt_config(PRESET), dtype=torch.float32,
        generator=torch.Generator("cuda").manual_seed(SEED)) \
        .to(torch.bfloat16)
    served = serve(model, card_line)
    del model
    torch.cuda.empty_cache()
    phase(f"5f tensor parallelism: TP={world} over NCCL")
    tensor_parallel(card_line, served["outputs"], world, "nccl")
    phase("done")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    if sys.argv[1:] == ["--sanitize"]:
        sanitize_calls()  # under compute-sanitizer (phase 2b); no result
        return
    if sys.argv[1:2] == ["--turns"] and len(sys.argv) == 3:
        turns(sys.argv[2])
        return
    if sys.argv[1:2] == ["--turn-leg"] and len(sys.argv) == 3:
        card_line = card()
        print(json.dumps({"turn": turn_leg(card_line)}, default=str),
              flush=True)
        return
    if sys.argv[1:]:
        if len(sys.argv) != 3 or sys.argv[1] != "--tp-nccl":
            raise SystemExit("usage: python3 chip_smoke.py [--tp-nccl N | "
                             "--sanitize | --turns PARENT_CHECKOUT]")
        tp_cards(int(sys.argv[2]))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    phase("1 card")
    card_line = card()
    phase("2 build")
    built = build()
    phase("2b kernelcheck: budgets, C geometry, races, bank, sanitizer")
    certified = kernelcheck_phase(built)
    fp32_sass = flash_tensor_core_counts()
    dropout_ops = dropout_sass_ops()
    sanitizer_phase()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase("3 kernels against their plain versions")
    errs = check_kernels(gen)
    int8_errs = check_int8(gen)
    ln_errs = check_layernorm(gen)
    flash_errs = check_flash(gen)
    adam_check = check_adam(gen)
    dropout_check = check_dropout(gen)
    norm_check = check_global_norm(gen)
    times = time_kernels(gen)
    program_times = time_programs(gen)
    int8_times = time_int8(gen)
    ln_times = time_layernorm(gen)
    ln_serving = {label: time_layernorm(gen, label, backward=False)["fwd"]
                  for label in LN_SERVING_SHAPES}
    flash_times = time_flash(gen)
    adam_times = time_adam(gen)
    dropout_times = time_dropout(gen, dropout_ops["ops"])
    norm_times = time_global_norm(gen)
    tp_errs = check_tp_heads(gen)
    tp_times = time_tp_heads(gen)
    torch.cuda.empty_cache()
    phase("4 fp32 check")
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    model = GPTForCausalLM(gpt_config(PRESET), dtype=torch.float32,
                           generator=torch.Generator("cuda").manual_seed(SEED))
    fp32_check(model)
    fp32_check(model, "n-gram speculation depth 4, chunk 64",
               spec=SpecConfig(method="ngram", depth=SPEC_DEPTH),
               chunk_size=64)
    # the target as its own draft: at the 300-token request's first verify
    # the window holds its whole sequence at the true positions, so the
    # draft proposes the target's greedy tokens and a step emits K + 1
    fp32_check(model, "the target as its own draft, depth 4, window 301",
               draft=model,
               spec=SpecConfig(method="draft", depth=SPEC_DEPTH, window=301,
                               draft=model.cfg))
    fp32_check(model, "sampled", **SAMPLING)
    phase("5 serve")
    model = model.to(torch.bfloat16)
    torch.cuda.empty_cache()
    served = serve(model, card_line)
    phase("6 profile")
    profile_decode(model)
    phase("5c serve sampled, chunked, speculative, swapped")
    legs = serve_features(model, card_line, served["outputs"])
    phase("5d observe: tracing on and off, tenants, the SLO controller, dumps")
    observe(model, card_line, served["outputs"])
    phase("6b serve int8 and the KV-quantisation scenario")
    served_int8 = serve(model, card_line, "int8", served["outputs"])
    profile_decode(model, "int8")
    kvq_scenario(model, card_line)
    phase("5g serve under the debug checks")
    serve_debug(model, card_line, served, served_int8)
    phase("5e fleet: affinity and round-robin, a page fetch, a chaos soak")
    fleet = serve_fleet(model, card_line, served["outputs"])
    del model  # the serving model's memory goes back before training
    torch.cuda.empty_cache()
    phase("5f tensor parallelism: TP=2 on the card")
    tp = tensor_parallel(card_line, served["outputs"])
    torch.cuda.empty_cache()
    phase("7 training fp32 check")
    train_fp32_check()
    torch.cuda.empty_cache()
    phase("8 train")
    trained = train(card_line)
    phase("9 training profile")
    profile_train(trained)
    tl = trained["launches"]
    off_peak = trained["peak_gib"]
    phase8_ms = trained["ms"]
    del trained  # phase 8's model goes before the ladder's peaks
    torch.cuda.empty_cache()
    ladder = train_ladder(card_line, off_peak)
    rl = ladder[RECIPE_RUNGS[0]["tag"]]["launches"]
    phase("10 the dygraph surface: examples/train_gpt.py's workflow")
    surface = surface_train(card_line, gen, phase8_ms)
    phase("11 BERT-base through nn.Layer: pretraining, fine-tune, layers")
    bert = bert_phase(card_line, gen)
    phase("12 vision through nn: ResNet-50 training, LeNet, conv, pooling, "
          "RNN and beam search")
    vision = vision_phase(card_line)
    phase("13 text models and the vision zoo through nn: ERNIE-3.0-base, "
          "Transformer-base, beam search, float64 checks, ten vision "
          "families")
    text = text_phase(card_line, gen)
    phase("14 the data half: detection operators at full width, LeNet fed "
          "by the reader path, host transforms")
    data_phase(card_line, vision["resnet50_train"]["images_per_s"])
    phase("15 the training surface: ERNIE-3.0-base fine-tuned through "
          "paddle.Model.fit under amp O1, jit, float16 with a GradScaler, "
          "the profiler, the DataLoader's workers")
    hapi = hapi_phase(card_line, vision["resnet50_train"]["images_per_s"])
    phase("16 parallel training: dp x mp, pipeline, ZeRO and MoE over four "
          "ranks sharing the card, GPT-350M at dp2 x mp2, float16 ERNIE")
    hybrid = hybrid_phase(card_line)
    phase("17 sequence parallelism: GPT-350M at b1 x s8192 over four "
          "context-parallel ranks started by the port's launcher, a restart "
          "from a checkpoint, the reference's checkpoint")
    sp17 = sp_phase(card_line, gen)
    phase("18 auto-parallel and the fleet executor: completion at GPT-350M, "
          "Engine.fit over four ranks sharing the card, the planner, a "
          "two-stage pipeline in one process and over TCP")
    auto18 = auto_parallel_phase(card_line)
    hapi_l = hapi["fit"]["launches_per_step"]
    hapi_dt = hapi["fit"]["dtypes"]

    def hapi_kernel(kernel, dtype_key, **extra):  # phase 15's readings
        return {"launches_per_step": hapi_l.get(kernel, 0),
                "dtypes": hapi_dt.get(dtype_key, ["float32"]), **extra}

    ernie_l = text["ernie"]["launches_per_step"]
    mt_l = text["transformer"]["launches_per_step"]

    def text_kernel(kernel, times=None, **extra):  # phase 13's readings
        row = {"ernie_launches_per_step": ernie_l.get(kernel, 0),
               "transformer_launches_per_step": mt_l.get(kernel, 0),
               **extra}
        return dict(row, **(times or {}))

    pre_l = bert["pretrain"]["launches_per_step"]
    ft_l = bert["fine_tune"]["launches_per_step"]

    def bert_kernel(kernel, times=None, **extra):  # phase 11's readings
        row = {"launches_per_step": pre_l.get(kernel, 0),
               "fine_tune_launches_per_step": ft_l.get(kernel, 0), **extra}
        return dict(row, **(times or {}))

    def ptxas(source, *names):  # the named kernels' registers and spills
        return [dict(zip(("kernel", "registers", "static_smem", "spill_stores",
                          "spill_loads"), row))
                for row in built["ptxas"][source]
                if any(n in row[0] for n in names)]

    def by_program(counts):
        return {p: counts[f"ragged_{p}"] for p in ("split", "mma", "warp")}

    ragged_ptxas = ptxas("ragged_paged_attention", "ragged_split_kernel",
                         "ragged_merge_kernel", "ragged_mma_kernel")
    kernels = [
        kernel_entry("ragged_paged_attention", rpa, rpa.REPLACES,
                     served["launches"]["ragged"], errs[torch.bfloat16],
                     errs[torch.float32], times["decode"], card_line,
                     program_launches=by_program(served["launches"]),
                     decode_b1=times["decode_b1"], prefill=times["prefill"],
                     prefix_tail=times["prefix_tail"],
                     verify=times["verify"], chunk=times["chunk"],
                     launches_per_verify_step=legs[
                         "b spec+swap float32"]["launches_per_verify_step"],
                     legs_5c={name: by_program(leg["launches"])
                              for name, leg in legs.items()
                              if "int8" not in name},
                     mma_threshold={"min_queries": rpa.MMA_MIN_QUERIES,
                                    "ms_by_s": program_times},
                     build_s=built["seconds"]["ragged_paged_attention"],
                     ptxas=ragged_ptxas,
                     tp2_shard={"max_abs_err": tp_errs["float"],
                                "decode": tp_times["decode"],
                                "prefill": tp_times["prefill"],
                                "launches_per_rank": {
                                    k: tp["legs"][k]["launches"]
                                    for k in ("bf16", "quantized logits")}},
                     fleet={name: by_program(leg["launches"])
                            for name, leg in fleet["legs"].items()}),
        kernel_entry("ragged_paged_attention_int8", rpa, rpa.REPLACES,
                     served_int8["launches"]["ragged_int8"],
                     int8_errs[torch.bfloat16], int8_errs[torch.float32],
                     int8_times["decode"], card_line,
                     library=int8_times["decode"]["library"],
                     program_launches=by_program(served_int8["launches"]),
                     legs_5c={name: by_program(leg["launches"])
                              for name, leg in legs.items()
                              if "int8" in name},
                     prefill=int8_times["prefill"],
                     tp2_shard={"max_abs_err": tp_errs["int8"],
                                "decode": tp_times["int8_decode"],
                                "prefill": tp_times["int8_prefill"],
                                "launches_per_rank":
                                    tp["legs"]["int8"]["launches"]},
                     launches_per_verify_step=legs[
                         "b spec+swap int8"]["launches_per_verify_step"],
                     **{f"bf16_{k}": int8_errs[torch.bfloat16, k]
                        for k in ("kernel_vs_fp32", "plain_vs_fp32")}),
        kernel_entry("flash_attention_forward", fa, fa.REPLACES,
                     tl["flash_fwd"], flash_errs[torch.bfloat16, "fwd"],
                     flash_errs[torch.float32, "fwd"], flash_times["fwd"],
                     card_line, replaces_splash=fa.REPLACES_SPLASH,
                     run_to_run_equal=flash_times["fwd_run_to_run_equal"],
                     fp32_surface=dict(surface["flash_fp32"]["fwd"],
                                       launches=surface["launches"][
                                           "flash_fwd"],
                                       run_to_run_equal=surface["flash_fp32"][
                                           "run_to_run"]["fwd_equal"]),
                     fp32_sass={k: n for k, n in fp32_sass.items()
                                if "fwd" in k},
                     ptxas=ptxas("flash_attention", "flash_fwd_wgmma",
                                 "flash_fwd_tf32"),
                     bert=bert_kernel("flash_fwd", bert["flash"]["fwd"]),
                     text=text_kernel("flash_fwd", text["flash"]["fwd"]),
                     hapi=hapi_kernel("flash_fwd", "flash_fwd",
                                      loaded_program_launches=hapi["jit"][
                                          "loaded_launches"]["flash_fwd"]),
                     **bf16_vs_fp32(flash_errs, "fwd")),
        kernel_entry("flash_attention_backward", fa, fa.REPLACES,
                     tl["flash_bwd"], flash_errs[torch.bfloat16, "bwd"],
                     flash_errs[torch.float32, "bwd"], flash_times["bwd"],
                     card_line, replaces_splash=fa.REPLACES_SPLASH,
                     fwd_bwd=flash_times["fwd_bwd"],
                     dq_run_to_run=flash_times["dq_run_to_run"],
                     fp32_surface=dict(surface["flash_fp32"]["bwd"],
                                       launches=surface["launches"][
                                           "flash_bwd"],
                                       run_to_run=surface["flash_fp32"][
                                           "run_to_run"]),
                     fp32_sass={k: n for k, n in fp32_sass.items()
                                if "bwd" in k},
                     build_s=built["seconds"]["flash_attention"],
                     ptxas=ptxas("flash_attention", "flash_bwd_wgmma",
                                 "flash_bwd_prep", "flash_bwd_dq_round",
                                 "flash_bwd_tf32"),
                     bert=bert_kernel("flash_bwd", bert["flash"]["bwd"]),
                     text=text_kernel("flash_bwd", text["flash"]["bwd"]),
                     hapi=hapi_kernel("flash_bwd", "flash_bwd"),
                     **bf16_vs_fp32(flash_errs, "bwd")),
        kernel_entry("fused_adam", fo, fo.REPLACES, tl["adam"],
                     adam_check["max_abs_err"], adam_check["max_abs_err"],
                     adam_times, card_line,
                     launches_per_step=tl["adam"] // TRAIN_STEPS,
                     tensors_per_step=tl["adam_tensors"] // TRAIN_STEPS,
                     check=adam_check,
                     bert=bert_kernel("adam", tensors_per_step=pre_l.get(
                         "adam_tensors", 0),
                         check=bert["pretrain"]["adam_check"]),
                     text=text_kernel("adam"),
                     hapi=hapi_kernel("adam", "adam", tensors_per_step=hapi_l.get(
                         "adam_tensors", 0)),
                     ptxas=ptxas("fused_adam", "fused_adam_multi")),
        kernel_entry("layernorm_forward", fl, fl.REPLACES_FWD, tl["ln_fwd"],
                     ln_errs[torch.bfloat16, "fwd"],
                     ln_errs[torch.float32, "fwd"], ln_times["fwd"],
                     card_line, library=ln_times["fwd"]["library"],
                     serving_launches=served["launches"]["ln_fwd"],
                     serving=ln_serving,
                     host_us_per_call=ln_times["host_us"],
                     host_us_by_part=ln_times["host_us_by_part"],
                     bert=bert_kernel("ln_fwd", bert["layernorm"]["fwd"]),
                     text=text_kernel("ln_fwd", text["layernorm"]["fwd"]),
                     hapi=hapi_kernel("ln_fwd", "ln_fwd",
                                      loaded_program_launches=hapi["jit"][
                                          "loaded_launches"]["ln_fwd"]),
                     ptxas=ptxas("fused_layernorm", "ln_fwd_"),
                     **bf16_vs_fp32(ln_errs, "fwd")),
        kernel_entry("layernorm_backward", fl, fl.REPLACES_DX, tl["ln_dx"],
                     ln_errs[torch.bfloat16, "dx"],
                     ln_errs[torch.float32, "dx"], ln_times["bwd"],
                     card_line, library=ln_times["bwd"]["library"],
                     replaces_sums=fl.REPLACES_SUMS,
                     reduce_launches=tl["ln_reduce"],
                     sums_share_of_limit=ln_errs["sums_share_of_limit"],
                     run_to_run_equal=ln_errs["run_to_run_equal"],
                     bert=bert_kernel("ln_dx", bert["layernorm"]["bwd"]),
                     text=text_kernel("ln_dx", text["layernorm"]["bwd"]),
                     hapi=hapi_kernel("ln_dx", "ln_bwd", reduce_launches_per_step=
                                      hapi_l.get("ln_reduce", 0)),
                     ptxas=ptxas("fused_layernorm", "ln_bwd_"),
                     **bf16_vs_fp32(ln_errs, "dx")),
        kernel_entry("dropout", kd, kd.REPLACES, rl["dropout_fwd"],
                     dropout_check["max_abs_err"],
                     dropout_check["max_abs_err"],
                     dropout_times["hidden"]["fwd_bits"], card_line,
                     without_bits=dropout_times["hidden"]["fwd"],
                     attention={k: dropout_times["attention"][k]
                                for k in ("fwd", "fwd_bits")},
                     path=RECIPE_RUNGS[0]["tag"], check=dropout_check,
                     sass_ops_per_element=dropout_ops,
                     text={"ernie_launches_per_step": ernie_l.get(
                         "dropout_fwd", 0),
                         "transformer_launches_per_step": mt_l.get(
                         "dropout_fwd", 0)},
                     hapi=hapi_kernel("dropout_fwd", "dropout_fwd"),
                     build_s=built["seconds"]["dropout"],
                     ptxas=ptxas("dropout", "dropout_fwd_kernel")),
        kernel_entry("dropout_backward", kd, kd.REPLACES,
                     rl["dropout_bwd"], dropout_check["max_abs_err"],
                     dropout_check["max_abs_err"],
                     dropout_times["hidden"]["bwd"], card_line,
                     attention=dropout_times["attention"]["bwd"],
                     path=RECIPE_RUNGS[0]["tag"],
                     text={"ernie_launches_per_step": ernie_l.get(
                         "dropout_bwd", 0),
                         "transformer_launches_per_step": mt_l.get(
                         "dropout_bwd", 0)},
                     hapi=hapi_kernel("dropout_bwd", "dropout_bwd"),
                     ptxas=ptxas("dropout", "dropout_apply_kernel")),
        kernel_entry("global_norm", gn, gn.REPLACES, rl["global_norm"],
                     norm_check["max_abs_err"], norm_check["max_abs_err"],
                     norm_times, card_line, path=RECIPE_RUNGS[0]["tag"],
                     rel_err=norm_check["rel_err"],
                     launches_per_step=rl["global_norm"] // TRAIN_STEPS,
                     build_s=built["seconds"]["global_norm"],
                     ptxas=ptxas("global_norm", "sumsq_kernel",
                                 "finalize_kernel")),
    ]
    run16 = hybrid["ranks"][0]["run"]["launches_per_step"]
    run18 = [r["run"]["launches_per_step"] for r in auto18["ranks"]]
    run17 = [r["run"] for r in sp17["ranks"]]
    for entry in kernels:  # phase 2b's certificate of each
        entry["kernelcheck"] = certified[entry["name"]]
        counter = H16_COUNTERS.get(entry["name"])
        if counter is not None:  # phase 16 (b)'s launches a step, rank 0
            entry["hybrid"] = {"launches_per_step_per_rank":
                               run16.get(counter, 0)}
            # phase 18 (b)'s Engine.fit, launches a step on each rank
            entry["auto_parallel"] = {"launches_per_step_by_rank": [
                r.get(counter, 0) for r in run18]}
        if counter is not None and counter != "dropout_fwd" and \
                counter != "dropout_bwd":
            # phase 17 (b)'s launches a step on each rank of sp4
            entry["sequence_parallel"] = {
                "launches_per_step_by_rank": [
                    r["launches_per_step"].get(counter, 0) for r in run17]}
    for entry in kernels[2:4]:  # the flash rows: the ring's blocks, the
        part = "fwd" if entry["name"].endswith("forward") else "bwd"
        entry["sequence_parallel"].update(
            blocks_per_step_by_rank=[
                {k: v for k, v in r["blocks_per_step"].items()
                 if k.startswith(part)} for r in run17],
            tile_skip_shapes={k: v[part] for k, v in
                              sp17["flash_times"].items()},
            one_rank_launches_per_step=sp17["one_rank"]["flash_per_step"][
                f"flash_{part}"])
    kernels[7]["hybrid"]["dropout_window_launches_check"] = \
        hybrid["ranks"][0]["check_dropout"]["dropout_fwd"]
    phase("done")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
