#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # dry run of the control flow on
                                           # the CPU at a small size

Phases (any failure exits non-zero; no error is swallowed):

1. device — the card's name and count, and ``nvidia-smi``'s name and
   power limit; no CUDA device means exit 2.
2. build — every CUDA kernel source under ``mxnet_tpu_torch/kernels/csrc``
   is compiled with nvcc for sm_90a (one process per source, in
   parallel), with ``-Xptxas -v``, and beside them the native RecordIO
   loader (``csrc/recordio.cc``), the engine, the storage pool and the C
   ABI library (``libmxnet.so``) with the host C++ compiler; the build
   time is set-up time. Then one
   line per kernel function of the flash library with its count of
   tensor-core instructions in ``cuobjdump -sass`` (HGMMA, HMMA); every
   flash kernel must have some (HGMMA in bf16).
3. kernels — the block-tail kernel (K1) against its plain PyTorch version
   at the shapes the serving path gives it (the four ResNet-50 block-tail
   shapes at batch 1 and 32) plus ragged shapes, fp32 (bit-equal) and
   bf16, with and without a residual; one JSON line per case with the
   kernel's device time alone (CUDA events around one launch behind a
   spinning stream, L2 flushed by writing 256 MB first, and warm), its
   CUDA-event time over 50 back-to-back calls (the host's path included),
   the plain version's time, the memory bound, the roofline share, the max
   abs error, and at batch 1 the host launch path (CUDA-event µs a call
   over 100 back-to-back calls). The flush writes 256 MB and reads it
   back, so the L2 holds clean lines and the kernel pays for no other
   write-back; at batch 32 ``dirty_flush_us`` beside it is the time after
   the write alone.
4. serving — the port's ``resnet50_v1`` (NHWC, fused block tails,
   1000 classes, 224x224x3, fp32, Xavier weights from a seeded
   ``torch.Generator``) exported and served through ``InferenceEngine``
   (max_batch 32): 64 requests of 1-4 rows, then a burst of 256 single-row
   requests. Every result must be finite and ``(rows, 1000)``; the
   block-tail kernel must have launched exactly 16 times per forward
   (warm-up forwards included); 4 requests recomputed by the port on the
   CPU (TF32 off) must agree. Also printed: req/s, request latency
   percentiles, each bucket's forward time, peak device memory and a
   ``torch.profiler`` view (device busy time, idle share, top kernels)
   of one bucket-1 and one bucket-32 forward.
5. attention_kernels — flash attention's forward (K2) and backward (K3)
   against their plain versions at (B, H, S, D) = (8, 8, 512, 64) causal
   fp32 (the LM's shape), (1, 8, 4096, 64) causal fp32 and bf16,
   (2, 16, 2048, 128) bf16, the ragged Sq 1000 / Skv 1500 case (fp32, and
   bf16 causal), head dims 20 and 3 (the plain-load path) and 72, and a
   two-half carry chain with offsets; one JSON line per case with the
   errors and tolerances, the kernel's, the plain version's and
   ``scaled_dot_product_attention``'s time (the yardstick, never called by
   the port; with the names of the kernels SDPA ran, which name its
   backend) and the bound. Kernel and SDPA times are given twice: CUDA
   events around 50 calls (host dispatch included) and device time from
   a ``torch.profiler`` trace (the kernels alone); shares use the device
   time, against 165 TFLOP/s in fp32 (3xTF32 on the tensor cores) and
   989 in bf16, with the CUDA-core fp32 share (67 TFLOP/s) beside.
6. training — the causal-attention LM of ``__graft_entry__.py`` at the
   repo's full attention width (vocab 8192, embed 512, 8 heads of 64,
   batch 8 x length 512, fp32, weights from ``np.random.RandomState(0)``)
   trained through ``parallel.SPMDTrainer`` (SGD, momentum 0.9, lr 0.1):
   5 steps with ``ulysses_attention`` (K2 + K3 per step), then 5 with
   ``ring_attention`` (K2 + the plain ring backward). Losses must be
   finite, the launch counts exact, and step 1 of each leg must agree
   with the port's CPU recompute (plain versions, TF32 off; the
   gradients from a recompute that takes the card's ReLU mask, with the
   count of MLP units whose sign differed). Printed per
   leg: step time, tokens/s, peak device memory and a profiler view of
   one step.
7. resnet_training — ``resnet50_v1`` (NHWC, fused tails, 224x224x3,
   1000 classes, seeded Xavier weights) trained through ``bench.py``'s
   raw step (``gluon.block.make_pure_fn``, ``torch.autograd``,
   multi-precision SGD-momentum, batch 128, bf16 weights with fp32
   masters): 2 + 5 steps on one batch, exactly 16 K1 launches per step,
   a finite loss that falls; step time, img/s, a profile (device busy,
   idle share, device time by class of kernel) and peak memory. Then
   ``Module.fit`` on the same net as a symbol + ``SoftmaxOutput`` (fp32,
   batch 32, 6 batches, TF32 off, ``cudnn.deterministic``) fused and
   phase-split from the same params (bit-equal), and step 1 recomputed
   by the port on the CPU: the loss within 1e-4, the weights within 1e-3
   of each tensor's largest value on the card's ReLU branches. Last,
   K1's backward kernel against its plain version at the batch-32 tail
   shapes and the ragged ones (fp32 and bf16, strided and dense incoming
   gradient; dx and dres bit-equal, two calls bit-equal) with its device
   time alone and its bound. Every training leg counts 16 K1 backward
   launches a step beside the 16 forward ones.
8. gluon_training — README.md's Gluon loop on the same ``resnet50_v1``
   (fp32, TF32 off, cudnn deterministic, batch 32, one fixed synthetic
   batch, seeded weights): ``autograd.record`` → ``SoftmaxCrossEntropyLoss``
   → ``backward`` → ``gluon.Trainer('sgd', lr 0.05, momentum 0.9).step``,
   5 steps unhybridized, then 5 hybridized from the same start. First the
   raw step of PR 4 (``make_pure_fn`` + ``torch.autograd`` +
   ``FusedUpdater``, same loss and optimizer) on the same weights and
   batch, timed. Step 1 of each leg must agree with it (loss 1e-5
   relative, parameters 1e-4 of each tensor's largest value), the two
   legs with each other, K1 must launch exactly 16 times per forward,
   and neither the peak nor the held memory may grow from step 2 to step
   5. Printed per leg: CUDA-event ms and host wall ms per step, img/s,
   peak and held bytes per step and a profile of one step (device busy,
   idle share, device time by class).
9. decode — ``bench.py``'s decode workload on the port: the KV-cached
   ``AttentionDecodeCell`` (vocab 8192, embed 512, 8 heads of 64,
   max_len 512, fp32, TF32 off, ``init_params(1)``) through
   ``DecodeEngine`` with 16 slots. Four prompts one at a time, then all
   at once (``keep_logits``): tokens equal; then recomputed by the port
   on the CPU: tokens equal up to the first top-2 logit margin under
   1e-4 of the largest |logit|, logits within that. Then bench.py's
   static (wave-synchronised) and continuous (open-loop) legs, 4 waves
   of one 192-token and fifteen 16-token generations: tok/s, token and
   request latency percentiles, steps, peak memory, and the allocator's
   segment count after warmup and after both legs, which must be equal;
   a profile of one full-bucket decode step and one prefill (device
   busy, idle share, device operations per call); a short bf16 run and
   the LSTM cell at the attention cell's widths against the CPU. The
   path runs no hand-written kernel: the JAX package's decode is plain
   ``jnp``.
10. rnn_training — the LSTM family at published widths (fp32, both TF32
   flags off, cudnn deterministic; the card's name and power limit in
   each record). (a) The word language model of
   ``examples/gluon/word_language_model/train.py`` at upstream MXNet's
   medium configuration (2 layers, emsize = nhid = 650, vocab 10,000,
   bptt 35, batch 32, 19.8 M parameters, synthetic tokens from a seed):
   step 1 at dropout 0 against the port's CPU recompute (loss 1e-4
   relative, parameters 1e-3 of each tensor's largest value) and
   hybridized against eager; then 5 eager and 5 hybridized steps at
   dropout 0.5 from the same start and ``mx.random.seed`` (whether
   their masks agree is printed): ms per step (CUDA events), host wall,
   tokens/s, peak memory per step (no growth from step 2 to 5), and a
   profile of one step with the count of ``aten::_cudnn_rnn`` calls
   (one per layer: cuDNN's fused RNN, no loop over time steps). (b)
   ``examples/rnn/bucketing_lstm.py`` at upstream
   ``lstm_bucketing.py``'s widths (2 layers of 200, embed 200, vocab
   10,000, batch 32, buckets 10-60, 1024 sentences of 5-60 tokens from
   the example's generator): ``BucketingModule.fit`` over three passes
   with Adam, fused then phase-split (bit-equal), batch 1 against the
   CPU: ms per batch by bucket length (first batches, which bind, apart),
   bound modules (6), parameter copies per bucket switch, Perplexity
   (``score`` after the passes under the vocabulary size), the peak of
   each pass (none above the second once every module is bound), a
   profile of one step at length 60. (c) The word LM with ``--tied``
   (the decoder's weight is the embedding's, one ``embedding0_weight``):
   step 1 at dropout 0 against the CPU, as in (a). K1-K3 launch 0 times
   on this path.
11. image_classification — the recipe of
   ``examples/image-classification`` (fp32, both TF32 flags off, cudnn
   deterministic). (a) ``common/fit.py``'s loop on
   ``symbols/inception_v3.py`` (299x299x3, 1000 classes, 23,834,568
   parameters, batch 32, seeded synthetic images): ``Module.fit`` with
   ``kvstore=mx.kvstore.create("device")`` (the optimizer in the store),
   SGD 0.05 with momentum 0.9 and wd 1e-4, ``MultiFactorScheduler`` from
   ``--lr-step-epochs 1``, ``Speedometer``, ``do_checkpoint``; 2 epochs of
   4 unshuffled batches: the rate at each update, ms per batch (CUDA
   events, host), a profiled batch, the peak per epoch (epoch 2 at most
   epoch 1's); no store and phase-split bit-equal over 2 batches; a
   fresh Module resumed from epoch 1 with the parameters only (rates
   equal) and with the store's optimizer states (bit-equal); ``score``
   and ``predict`` (a padded last batch); step 1 at Dropout 0, in fp32
   and in fp64 on the card, against the CPU's fp32 and fp64 steps
   (``_step1_gate``: per tensor, with planted faults). (b)
   ``benchmark_score.py`` for the ten networks of ``symbols/`` at batch
   32 (img/s), then ``Module.reshape`` to batch 2: the logits within
   1e-3 of the CPU's largest. (c) ``fine_tune.py``'s stage 2 from (a)'s
   checkpoint: cut at the flatten output, a 10-class head, the backbone
   fixed and bit-identical after 3 batches.
12. gluon_zoo — ``get_model`` for alexnet, densenet121, inception_v3
   (299), mobilenet1_0 and resnet50_v1 at batch 32 in inference (img/s,
   2 rows within 1e-3 of the CPU's largest logit); densenet121
   (224x224x3, batch 32, fp32) trained through the Gluon loop from
   ``DataLoader(ArrayDataset, shuffle=True, last_batch="discard",
   num_workers=2)`` over 96 images with a store: 3 steps eager, 3
   hybridized (bit-equal), 2 thread and 2 process workers against 0
   (the same batches, no shared memory left), a store against none
   (bit-equal), step 1 as in (a), ms per step,
   a profiled step, peaks flat from step 2. K1-K3 launch 0 times on both
   phases (the zoo's resnet50_v1 has no fused tails).
13. observability — the instruments around serving, decode and
   ``Module.fit`` (telemetry and its cost, autotune, faults and
   postmortems, the sampler, a merged profile).
14. dense_prediction — FCN-16s on VGG-16 (``fcn16s_symbol``: the
   pattern of ``examples/fcn-xs/fcn_xs.py`` at the FCN paper's widths,
   134,815,994 parameters, fp32, TF32 off, cudnn deterministic, batch 8
   x 3 x 384 x 384, 21 classes with a 255 void band, random weights):
   (a) the logits within 1e-3 of the CPU's largest; (b) ``Module.fit``
   for 2 epochs x 4 batches (SGD 1e-3, momentum 0.9, wd 5e-4): ms per
   batch, a profiled batch (device busy, idle share), the train-step
   card's FLOPs against the 3.0 T reckoned from the shapes, the peak per
   epoch (no growth); step 1 at Dropout 0 through ``_step1_gate``;
   (c) the same fit preempted by SIGTERM at epoch 1 batch 2 and resumed
   in a fresh Module: parameters, optimizer states and update counts
   bit-equal, the signal handlers restored, the checkpoint's sizes;
   (d) ``dispatch:nan`` at epoch 1 batch 3 under each divergence policy;
   (e) a monitor on the deconvolutions against the CPU's (1e-4), the
   ``monitor`` fallback counted; (f) ``gluon.SymbolBlock`` bit-equal to
   the Module's forward, eager and hybridized; (g) the ten new
   optimizers, 3 updates of the card's gradients, against CPU fp64 on
   sampled elements; (h) ``examples/module/seq_module.py``,
   ``vae.py``, ``autoencoder.py`` and each new ``gluon.nn`` block on
   the card against the CPU. K1-K3 launch 0 times on this path.
15. data_parallel — two workers of ``python -m mxnet_tpu_torch.launch -n
   2`` on the one card over gloo (``--dp-worker``, one launch), each leg
   under a hard limit: (a)-(c) ResNet-50 v1 ``Module.fit`` at batch 32 a
   worker, one epoch of 3 batches, on ``dist_sync`` (the fused step:
   BatchNorm over both workers' rows, step 1 through ``_step1_gate``
   against one process at batch 64),
   2-bit and fp16 stores (the wire bytes, rank 0's first update against
   a CPU recompute), ``dist_sync`` phase-split and ``dist_async``
   (BatchNorm over each worker's rows; bit-equal to each other);
   replicas bit-equal in every leg; (d) the LM's dp ``SPMDTrainer`` at
   global batch 8 against one process; (e) the Gluon loop over a
   ``dist_sync`` Trainer against one process running each worker's rows
   on their own (fp32 step 1 through ``_step1_gate``, fp64 steps 1-3
   within 1e-6 of the update), the resume bit-equal. The launches of K1
   (16 a forward), K2 and K3 in every worker are counted.
16. model_parallel — four workers of ``python -m mxnet_tpu_torch.launch
   -n 4`` on the one card over gloo (``--mp-worker``), each leg under a
   hard limit: (a) the LM at full width through ``SPMDTrainer`` over
   ``{"dp": 1, "sp": 2, "tp": 2}`` with ring attention (K2 twice a rank
   a forward) and (b) over ``{"dp": 2, "sp": 2}`` with Ulysses (K2 and
   K3 once a rank a step), step 1 within 1e-4 in loss, 1e-3 of each
   parameter's largest value and 1e-4 of each gradient's (the momentum)
   of the one-device trainer on the card, the ranks' whole parameters
   bit-equal, and each rank's attention on its step-1 q/k/v through the
   kernels against the plain ring or plain Ulysses attention (output
   and dq/dk/dv, ``_MP_ATTN_TOL``); (c) ``moe_ffn`` over ``{"ep": 4}``
   at the LM's width against a float64 dense oracle, nothing dropped and
   at capacity 1.25 exactly the tokens that a CPU recompute of the
   routing, written apart from the port's, drops; (d) ``pipeline_apply``
   over ``{"pp": 4}`` against the float64 sequential oracle. Each leg
   prints rank 0's ms a step (CUDA events), host seconds and payload
   bytes in collectives a step, a profiled step's device busy time and
   idle share, the peak of every rank, and the launches of K1-K3.
17. engine_meshes — four workers of ``python -m mxnet_tpu_torch.launch
   -n 4`` on the one card over gloo (``--em-worker``), each leg under a
   hard limit: (a) ``InferenceEngine`` serving ResNet-50 v1 (NHWC,
   fused tails, fp32, ``max_batch`` 32) over ``{"dp": 1, "mp": 4}`` with
   ``bench.py``'s layout rules, rank 0 the front end and the other ranks
   its followers: 8 requests of 1-4 rows, then 2 of 32; every bucket's
   logits bit-equal to a one-device engine's on the card, one bucket
   within 1e-3 of the largest logit of a CPU forward, K1 16 times a
   forward on every rank; (b) ``DecodeEngine`` at the decode phase's
   width and 16 slots over ``{"dp": 1, "mp": 4}`` under
   ``DECODE_PARTITION_RULES`` (2 heads a rank): tokens equal to the
   one-device engine's up to the first top-2 margin under 1e-4 of the
   largest logit, each rank's ``kv_cache_bytes`` exactly a quarter of
   the whole pool's, token latency p50/p95; (c) ``Module.fit`` on
   ResNet-50 v1 (fp32, global batch 64, SGD lr 0.05, momentum 0.9, wd
   1e-4, 2 fused batches) over ``{"dp": 2, "mp": 2}``: step 1 through
   ``_step1_gate`` against one process at batch 64 (fp32 and the fp64
   arbiter, run before the workers), the ranks' gathered parameters
   bit-equal, a checkpoint saved on the mesh restored into a one-device
   ``Module`` bit for bit and back. Each leg prints rank 0's time (CUDA
   events), host seconds and payload bytes in collectives a forward,
   token or step, each rank's peak and committed bytes against the
   replicated layout's, a profiled call's device busy time and idle
   share, and the launches of K1-K3 in every worker.
18. elastic — three workers of ``python -m mxnet_tpu_torch.launch -n 3
   --heartbeat-dir DIR --heartbeat-interval 0.25 --heartbeat-timeout 3``
   on the one card over gloo (``--el-worker``, under a hard limit):
   ResNet-50 v1 (NHWC, fused tails, fp32) through ``Module.fit`` on
   ``dist_sync``, batch 32 a worker, SGD 0.05, momentum 0.9, wd 1e-4, 3
   epochs of 3 batches, a ``CheckpointManager`` a rank, one shared
   flight directory. Rank 1 is a straggler (``dispatch:delay=250`` at
   its first 4 steps), then dies at its ``kv_collective`` crossing of
   epoch 1, batch 1 (the number is printed). Gates: the victim exits
   with its fault code and the survivors with 0; on each survivor
   ``elastic.dead_workers``, ``elastic.remesh`` and ``elastic.resumed``
   are 1; their ``dead_worker`` postmortems (through
   ``tools/flight_view.py``) name ``[1]`` at epoch 1, batch 1 and hold
   rank 1's ``worker_abort``; ``tools/fleet_view.py`` names rank 1 dead
   and the first straggler and solves the clocks within 0.25 s; the
   survivors {0, 2} end bit-equal; the first step after the resume
   passes ``_step1_gate`` (fp32, and the survivors' fp64 step as the
   arbiter) against one process restoring the same checkpoint on the
   survivors' 64 rows; K1 launches 16 times a forward on every worker.
   Printed: rank 0's ms a step before and after the loss, the seconds
   from the death to ``DeadWorkerError``, the re-mesh and the first
   resumed step, the gate's wait per crossing, host seconds in
   collectives a step, a profiled step, each worker's peak. Then
   ``group2ctxs`` on the card: ResNet-50 v1 with stages 3-4 and the head
   in group ``g2`` (``{"g1": gpu(0), "g2": gpu(0)}``), one ``fit``
   batch bit-equal to the ungrouped module, and the MLP with ``g1`` on
   ``cpu(0)`` and ``g2`` on ``gpu(0)`` within 1e-6 of an ungrouped card
   run.
19. sparse — ``examples/sparse/linear_classification.py`` at Avazu's
   width (1,000,001 features, batch 8192, ~15 non-zeros a row, 2
   classes; a LibSVM file of 32,768 rows written from the seed with the
   example's labelling rule): ``LibSVMIter`` csr batches on the card,
   ``row_sparse_pull`` of each batch's rows from a ``device`` store,
   ``sparse.dot`` under ``record``, ``cast_storage(grad, "row_sparse")``
   and a push that runs the store's lazy SGD (lr 0.5, ``rescale_grad``
   1/8192), 2 epochs of 4 batches. Gates: (a) batch 1 against float64 on
   the host (the ``dot`` at a seeded weight, the gradient's rows and
   values, the updated weight, within 1e-5; untouched rows still zero);
   (b) one lazy step each of SGD with momentum, Adam and AdaGrad on the
   trained weight against float64 on the touched rows, untouched weight
   and state rows bit-unchanged; (c) ``row_sparse_pull`` gives exactly
   the requested rows; (e) epoch 2's mean loss finite and below epoch
   1's; (f) peak device memory above the phase's start under 4 GB and no
   batch's dense view built; no K1-K3 launch. Then two workers of
   ``python -m mxnet_tpu_torch.launch -n 2`` on the card over gloo
   (``--sp-worker``, 4096 rows each, weight and bias pushed as one key
   list on ``dist_sync``): ranks bit-equal after every batch, the wire
   of every push by the JAX package's formula (padded power-of-two
   buckets of int32 ids and rows) and below the dense weight's, batch
   1's weight within 1e-6 of one process pushing both gradients as a
   list to a ``device`` store, and a zero row only rank 1 pushes seen by
   the store's optimizer. Printed: ms a batch (CUDA events), host ms and
   the share inside host reads, rows touched and their bucket, wire
   bytes, a profiled batch (device busy, idle share, classes), the top
   host functions of two batches, peak memory, the seconds.
20. detection — SSD-VGG16 at 300x300 (``ssd_symbol``: Liu et al.'s
   SSD300, upstream example/ssd's VGG16-reduced; 26,285,486 parameters,
   21 classes, six sources of 38, 19, 10, 5, 3 and 1 cells, 8,732
   anchors) trained through ``Module`` (fp32, TF32 off, batch 32 of 3 x
   300 x 300 images with 1-8 boxes each in ``(32, 50, 5)`` labels, all
   from a seed; SGD 0.002, momentum 0.9, wd 5e-4; 5 steps of
   ``forward_backward`` + ``update``). Gates: (a) step 1 at batch 2
   against the CPU's (the losses within 1e-4, the weights through
   ``_step1_gate`` with the fp64 arbiter); (b) ``MultiBoxPrior``,
   ``MultiBoxTarget`` and ``MultiBoxDetection`` on the step's own card
   inputs against the same ops on CPU copies (anchors within 1e-6,
   targets' classes and masks equal, the detection's class ids equal
   row for row, scores and boxes within 1e-5), with a flipped forced
   match and a dropped suppression planted as controls; (c) the
   detection output ``(32, 8732, 6)``, the kept rows printed; (d)
   ``gluon.loss.CTCLoss`` at examples/warpctc's width, ``ROIPooling``
   at examples/rcnn/fast_rcnn.py's and ``Proposal`` at an RPN's, the
   Custom softmax of examples/numpy-ops under ``Module.fit``, and
   ``SpatialTransformer`` forward and backward, each against the CPU.
   Printed: ms a step (CUDA events), host ms, a profiled step (device
   busy, idle share, classes), each multibox op's time and the NMS's
   host ms, the peak, K1-K3 launches (none: VGG-16 has no BatchNorm).
21. records — ImageNet-shaped records and the image pipeline (fp32, both
   TF32 flags off, cudnn deterministic). (a) 160 raw CHW uint8 records of
   3 x 224 x 224 with labels in 0-999 from a seed, written by the port's
   ``MXIndexedRecordIO`` and ``pack`` (24.1 MB), read by
   ``ImageRecordIter`` (batch 32, ``preprocess_threads`` 4, ImageNet's
   mean and std) through the native loader, then through the Python path
   (``rand_mirror``, ``np.random`` seeded); each batch against a numpy
   reading of the file (``struct`` over the framing and header, the same
   float32 arithmetic, the same mirror draws) within 1 ulp, img/s of each
   path. (b) ``resnet50_v1`` (NHWC, fused tails, seeded Xavier weights)
   behind one transpose of the iterator's NCHW batches, ``SoftmaxOutput``
   on top, one epoch of ``Module.fit`` (SGD 0.05, momentum 0.9) over
   (a)'s 5 batches: exactly 16 K1 launches a forward, a finite loss, and
   batch 0's forward through the record iterator bit-equal to the same
   forward from ``NDArrayIter`` over the numpy reading; ms a batch (CUDA
   events, host) with the record iterator and with ``NDArrayIter``, a
   profiled batch with its ``next()`` (device busy, idle share), the
   peak. (c) 64 raw HWC 3 x 300 x 300 records with 1-8 boxes each as
   multi-label headers (the detection phase's ``ssd_data``) through
   ``mx.image.ImageDetIter`` (batch 32, ``max_boxes`` 50,
   ``DetHorizontalFlipAug(0.5)`` and a colour normalise, Python's
   ``random`` seeded) into 2 ``forward_backward`` + ``update`` steps of
   ``ssd_symbol``: data and ``(32, 50, 5)`` labels equal to a numpy
   reference flipped where the same draws flip, finite losses. (d)
   ``"pillow"``: with Pillow, 64 JPEG records encoded at 256 x 256
   through ``ImageRecordIter(rand_crop=True)`` to 224, equal to a direct
   PIL decode and a numpy crop under the same draws; without it,
   ``imdecode`` must raise naming Pillow.
22. conv_recurrent — the ConvLSTM encoder-forecaster of Shi et al. 2015
   (section 4.1, Moving MNIST's shapes: 16 patch channels on 16 x 16, 10
   frames in and 10 out, 128-64-64 hidden channels, 5 x 5 kernels, batch
   16; sprites bouncing in 64 x 64 from a seed; fp32, both TF32 flags
   off, cuDNN's default algorithms). (a) ``gluon.contrib.rnn.
   Conv2DLSTMCell``s through ``autograd.record`` and ``gluon.Trainer``
   (RMSProp 1e-3, gamma1 0.9): step 1 eager and hybridized against each
   other (1e-6) and a CPU recompute (loss 1e-4 relative, parameters 1e-3
   of each tensor's largest value); then 20 steps: ms a step (CUDA
   events), the peak, a profiled step (idle share), and exactly 130
   ``cudnn_convolution`` and 130 ``convolution_backward`` calls a step.
   (b) The same network of ``mx.rnn.ConvLSTMCell``s through
   ``Module.fit`` (2 epochs of 3 batches) whose batches are made by host
   work pushed to ``mx.engine`` into ``resource`` temp space (bit-equal
   under ``NaiveEngine``), logged by ``mx.contrib.tensorboard.
   LogMetricsCallback``; ``mx.viz.print_summary``'s count equal to (a)'s;
   step 1 against the CPU as in (a). (c) ``mx.test_utils.
   check_consistency`` of one ``ConvLSTMCell`` step over the card and the
   CPU; the first layer's i2h weight gradient under cuDNN's deterministic
   and default algorithms against the CPU; ``Storage.device_stats``
   against ``torch.cuda.memory_stats``; ``InferenceEngine`` on ResNet-50
   v1 whose bucket-32 forward runs out of memory under
   ``torch.cuda.set_per_process_memory_fraction``: a
   ``DeviceMemoryError`` naming the ledger with PyTorch's OOM as its
   cause, then a bucket-1 forward with exactly 16 K1 launches;
   ``MXNET_PROFILER_AUTOSTART=1`` in a child process, whose trace holds
   the card's kernels.
23. c_boundary — a C deployment of ResNet-50 v1 through the port's own C
   library (``kernels/_build/libmxnet.so``, built from ``kernels/csrc``
   with ``c_api.cc``, ``c_predict_api.cc`` and ``embed_common.cc``), two
   C drivers compiled here and run as child processes (the second
   loads, compiles and binds while the first runs, and starts its timed
   batches when the first has ended) that embed the
   interpreter (``_build.driver_link_flags()``; ``PYTHONPATH`` holds the
   repo and this interpreter's site-packages; TF32 off through
   ``MXNET_CUDA_ALLOW_TENSOR_CORE=0``). (a) The build's seconds and the
   kind of libpython. (b) ``MXPredCreate`` at ``dev_type`` 2 on the
   serving phase's exported ``resnet50_v1`` (NHWC, fused tails), 3
   forwards of a seeded float32 batch of 32 x 224 x 224 x 3, host ms a
   forward, profiled through ``MXSetProfilerConfig``/``State``/
   ``MXDumpProfile``: the logits within 1e-5 of the largest of the
   port's Python ``Predictor`` on the card, the first 4 rows within 1e-3
   of a CPU forward, 16 K1 launches a forward in the child's trace and in
   its wrapper's count. (c) Seeded uint8 images (3 batches of 32 x 224
   x 224 x 3) through ``MXNDArrayCreateEx``/``SyncCopyFromCPU``, a CUDA
   C normaliser (``_CB_NORMALISE``: ImageNet's mean and 1/std, NHWC,
   float32 out) compiled by ``MXRtcCudaModuleCreate`` and launched by
   ``MXRtcCudaKernelCall`` into the float32 array that
   ``MXSymbolCreateFromFile``/``MXNDArrayLoad``/``MXExecutorBind`` bind
   as ``data``, ``MXExecutorForward``/``Outputs``: the normalised batch
   bit-equal to ``(x.float() - mean) * inv_std``, the logits within 1e-5
   of the Python ``Predictor`` fed the plain batch, K1 16 times a
   forward and K4 once a batch (trace and wrapper counts). (d)
   ``mx.rtc`` in this process: an ``extern "C"`` axpy, a mangled kernel
   staging through dynamic shared memory at two block sizes, a template
   exported by its name expression in float and double, a ``__half``
   kernel, a compile error carrying NVRTC's log, a dtype mismatch
   refused before any launch; then K4's time at (c)'s batch: device ms
   by CUDA events around one launch behind a spinning stream (the
   host's launch path hidden), with 256 MB written before it (the 24 MB
   it moves would stay in the 50 MB L2) and warm, CUDA-event ms over 100
   launches (the host's launch path included), the plain version's
   device ms (flushed alike), the bound (5 bytes an element at the
   memory rate).
24. a ``{"kernels": [...]}`` line — for K1 its ``ms`` (device time alone,
   L2 flushed with clean lines; ``warm_ms``, ``dirty_flush_ms`` and
   ``event_ms`` beside), ``plain_ms`` and
   ``bound_ms`` are per batch-32 forward (the sum over the 16 fp32 block
   tails with residual), ``launch_host_us`` the batch-1 launch path, and
   its ``bwd_*`` the backward kernel's per batch-32 step, with
   ``bwd_launches`` per path; for K2 and K3 they are at the LM's shape, ``ms``
   and ``library_ms`` device times (``event_ms`` beside), ``plain_ms`` by
   CUDA events; each
   ``launches`` is the count on that kernel's main paths (K1: serving,
   training and the Gluon loop), ``rnn_training_launches``,
   ``image_classification_launches``, ``gluon_zoo_launches``,
   ``dense_prediction_launches`` (0), ``data_parallel_launches``,
   ``model_parallel_launches``, ``engine_meshes_launches``,
   ``elastic_launches``, ``sparse_launches`` (0),
   ``detection_launches`` (0), ``records_launches`` and
   ``conv_recurrent_launches`` and ``c_boundary_launches`` its counts
   on those paths; K4 (``rtc_normalise_nhwc``: ``mx.rtc`` compiling and
   launching the normaliser) its time at (c)'s batch and its launches on
   (c)'s path — and,
   last, the ``{"ok": true,
   "device": {...}}`` line.

``--cpu-rehearsal`` runs phases 3-23 on the CPU at a small size, where
every kernel wrapper takes its plain version.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# memory rate of the card by nvidia-smi name (NVIDIA data sheets)
_MEM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))

# ResNet-50 v1 block tails at 224x224: (H=W, C, blocks in the stage)
_R50_TAILS = ((56, 256, 3), (28, 512, 4), (14, 1024, 6), (7, 2048, 3))
_RAGGED = ((3, 5, 7, 33), (2, 20, 7, 33), (2, 2, 2, 600))
_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
# K1's backward launches on each main path (in this process or read from
# its workers), for the kernels line
_K1_BWD = collections.Counter()


def emit(obj):
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    print("== phase %s" % name, flush=True)
    yield
    emit({"phase": name, "ok": True, "s": time.perf_counter() - t0})


def time_cuda(fn, iters=50, warmup=5):
    """Mean ms per call: CUDA events around ``iters`` calls after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _l2_flush(buf):
    """A ``before`` for :func:`_isolated_ms`: write ``buf`` (256 MB, over
    the 50 MB L2) and read it back, so the L2 holds clean lines of it and
    the timed kernel pays for no write-back of the flush's."""
    def flush():
        buf.zero_()
        buf.sum()
    return flush


def _isolated_ms(fn, before=None, reps=21):
    """The device ms of ``fn``'s kernels alone: the median over ``reps``
    of CUDA events recorded just around it while the stream still spins
    on ``torch.cuda._sleep`` (~1 ms), so the host's launch path, slower
    than a small kernel, is hidden; ``before`` (an L2 flush) runs ahead
    of the first event. A profiler trace is not used: after the earlier
    phases' traces in this process it attributes these short kernels
    wrongly (PERF.md §6)."""
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_time(fn, match=None, reps=20):
    """The device time per call of ``fn`` from a ``torch.profiler`` trace:
    the CUDA durations of the kernels whose name contains ``match`` (all
    kernels when None), summed and divided by ``reps``; returns (ms, {kernel
    name: ms}), ms None when the trace holds no such device events. Unlike
    ``time_cuda`` it leaves out the host's dispatch of each call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = {e.key: e.self_device_time_total / 1e3 / reps
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0
             and (match is None or match in e.key)}
    if not names:   # no device events in the trace: CUDA events instead
        return time_cuda(fn), {"(no device events; CUDA events)": None}
    return sum(names.values()), names


def sass_tensor_ops(lib_path):
    """Per kernel function of a built library, the count of tensor-core
    instructions in its SASS (``cuobjdump -sass``): HGMMA (wgmma) and HMMA
    (mma.sync)."""
    import shutil
    exe = next((c for c in ("/usr/local/cuda/bin/cuobjdump",
                            shutil.which("cuobjdump")) if c
                and os.path.isfile(c)), None)
    if exe is None:
        return {"error": "cuobjdump not found"}
    sass = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                if op + "." in line:
                    counts[fn][op] += 1
    return counts


def _card_line():
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_phase():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = _card_line()
    print(smi, flush=True)
    rate = next(r for key, r in _MEM_RATE if key in name)
    emit({"device": name, "count": count, "nvidia_smi": smi,
          "mem_rate_Bps": rate,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, count, rate


def build_phase():
    from mxnet_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    log = _build.build_all(_build.SOURCES + _build.HOST_SOURCES
                           + tuple(_build.EMBED_SOURCES), force=True)
    for name, rec in log.items():
        print("-- build output: %s\n%s" % (name, rec["ptxas"]), flush=True)
    emit({"setup_build_s": time.perf_counter() - t0,
          "per_source_s": {n: r["seconds"] for n, r in log.items()}})
    # the flash kernels run on the tensor cores: wgmma (HGMMA) in bf16,
    # mma.sync (HMMA) or wgmma in fp32
    counts = sass_tensor_ops(os.path.join(_build.BUILD_DIR,
                                          "libflash_attention.so"))
    for fn, c in sorted(counts.items()):
        emit({"sass": fn, "tensor_core_instructions": c})
    flash = {fn: c for fn, c in counts.items() if "flash_" in fn}
    assert flash, counts
    for fn, c in flash.items():
        need = c["HGMMA"] if "bfloat16" in fn else c["HGMMA"] + c["HMMA"]
        assert need > 0, ("no tensor-core instruction in", fn, c)


def kernel_cases():
    cases = []
    for b in (1, 32):
        for hw, c, _ in _R50_TAILS:
            cases.append(((b, hw, hw, c), True))
    return cases + [(s, False) for s in _RAGGED]


def kernel_phase(dev, rate):
    """Kernel vs plain version at every case of :func:`kernel_cases`; on
    the card each case's device time alone (``_isolated_ms``: L2 flushed
    by writing 256 MB first, and warm), its CUDA-event time over 50
    back-to-back calls (the host's path included) and the plain
    version's, and at batch 1 the host launch path (CUDA-event µs a call
    over 100 back-to-back calls, where the kernel takes 2-4 µs). Returns
    per-forward totals for the main path's shapes (fp32, batch 32, with
    residual), its max abs error and the batch-1 launch paths."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    cuda = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, device=dev) if cuda else None
    tot = collections.Counter()
    host = collections.defaultdict(list)
    main_err = 0.0
    for shape, main_shape in kernel_cases():
        for dtype in (torch.float32, torch.bfloat16):
            for with_res in (True, False):
                c = shape[-1]
                x = torch.randn(shape, generator=g, device=dev).to(dtype)
                r = torch.randn(shape, generator=g, device=dev).to(dtype) \
                    if with_res else None
                s = torch.randn(c, generator=g, device=dev)
                b = torch.randn(c, generator=g, device=dev)
                got = K.scale_bias_add_relu(x, s, b, r)
                want = K.scale_bias_add_relu_reference(x, s, b, r)
                if cuda:
                    torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = _TOL[dtype]
                ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                    atol=tol)
                rec = {"kernel": "scale_bias_add_relu", "shape": shape,
                       "dtype": str(dtype).replace("torch.", ""),
                       "residual": with_res, "max_abs_err": err,
                       "tol": tol, "match": bool(ok)}
                if dtype == torch.float32:
                    rec["bit_equal"] = bool(torch.equal(got, want))
                    ok = ok and rec["bit_equal"]
                if cuda:
                    fn = lambda: K.scale_bias_add_relu(x, s, b, r)  # noqa
                    plain = lambda: K.scale_bias_add_relu_reference(  # noqa
                        x, s, b, r)
                    ms = _isolated_ms(fn, before=_l2_flush(flush))
                    warm = _isolated_ms(fn)
                    plain_ms = _isolated_ms(plain, before=_l2_flush(flush))
                    event = time_cuda(fn)
                    nbytes = (3 if with_res else 2) * x.numel() \
                        * x.element_size() + 2 * c * s.element_size()
                    bound = nbytes / rate * 1e3
                    rec.update({"us": ms * 1e3, "warm_us": warm * 1e3,
                                "event_us": event * 1e3,
                                "plain_us": plain_ms * 1e3,
                                "plain_event_us": time_cuda(plain) * 1e3,
                                "bound_us": bound * 1e3, "bytes": nbytes,
                                "roofline_share": bound / ms,
                                "warm_roofline_share": bound / warm})
                    if shape[0] == 32:
                        dirty = _isolated_ms(fn, before=flush.zero_)
                        rec["dirty_flush_us"] = dirty * 1e3
                    if shape[0] == 1 and main_shape:
                        rec["launch_host_us"] = time_cuda(
                            fn, iters=100) * 1e3
                        host[rec["dtype"]].append(rec["launch_host_us"])
                    if main_shape and shape[0] == 32 and with_res \
                            and dtype == torch.float32:
                        n = next(k for hw, cc, k in _R50_TAILS if cc == c)
                        for key, v in (("ms", ms), ("warm_ms", warm),
                                       ("dirty_flush_ms", dirty),
                                       ("event_ms", event),
                                       ("plain_ms", plain_ms),
                                       ("bound_ms", bound)):
                            tot[key] += n * v
                if main_shape and with_res and dtype == torch.float32:
                    main_err = max(main_err, err)
                emit(rec)
                if not ok:
                    raise AssertionError("kernel disagrees with its plain "
                                         "version: %s" % rec)
    out = dict(tot, max_abs_err=main_err)
    for dt, v in host.items():
        out["launch_host_us_" + dt] = [min(v), max(v)]
    return out


def profile_forward(fn, reps=3):
    """Host wall time, device busy time and device operations (kernels and
    copies) per call of ``fn`` from a ``torch.profiler`` trace (CUDA self
    time summed by name); the device numbers are None when the trace
    holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kern = sorted(((e.key, e.self_device_time_total / 1e3 / reps)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda kv: -kv[1])
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0) / reps
    busy = sum(ms for _, ms in kern) if kern else None
    classes = collections.Counter()
    for k, ms in kern:
        classes[_kernel_class(k)] += ms
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / wall_ms,
            "kernels": len(kern), "device_ops_per_call": launches,
            "device_ms_by_class": dict(classes),
            "top": [[k[:80], ms] for k, ms in kern[:8]]}


# kernel-name fragments of each class of device work, first match wins
_KERNEL_CLASSES = (
    ("K1 block tail", ("scale_bias_add_relu",)),
    ("flash attention", ("flash_",)),
    ("pooling", ("pool",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "direct_copy", "CatArray",
                                "index", "fill")),
    ("convolutions and GEMMs (cuDNN, cuBLAS)",
     ("cudnn", "xmma", "gemm", "conv", "sm90", "sm80", "cutlass", "nhwc",
      "implicit", "wgrad", "dgrad", "fprop")))


def _kernel_class(name):
    low = name.lower()
    for cls, keys in _KERNEL_CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other"


def _randomize_bn(net, gen):
    """BN parameters and statistics drawn from ``gen`` (Xavier leaves BN
    at identity; random values make the folded coefficients matter)."""
    for name, p in net.collect_params().items():
        n = p.shape[0]
        if name.endswith(("gamma", "running_var")):
            p.data()[:] = torch.rand(n, generator=gen) + 0.5
        elif name.endswith(("beta", "running_mean")):
            p.data()[:] = torch.randn(n, generator=gen) * 0.1


def _served_resnet(mx, ctx, rehearsal, seed=0):
    """The serving phase's model and traffic: ``resnet50_v1`` (NHWC, fused
    tails, seeded Xavier weights, random BN) exported and loaded as a
    symbol and its parameters on ``ctx``, with 64 requests of 1-4 rows
    and a burst of 256 single rows (rehearsal: a narrow ResNet v1, 8 and
    16). Returns (sym, params, hw, classes, max_batch, reqs, burst)."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    os.environ["MXNET_FUSED_BN_ADD_RELU"] = "1"
    mx.layout.set_default_layout("NHWC")
    if rehearsal:   # a narrow ResNet v1 with a fused tail in every block
        hw, classes, max_batch, n_req, n_burst = 32, 10, 4, 8, 16
        make = lambda: resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                                       [16, 32, 64, 128, 256], classes=10)
    else:
        hw, classes, max_batch, n_req, n_burst = 224, 1000, 32, 64, 256
        make = resnet.resnet50_v1
    gen = torch.Generator().manual_seed(seed)
    with mx.name.NameManager():
        net = make()
    net.initialize(mx.init.Xavier(generator=gen), ctx=ctx)
    net(mx.nd.zeros((1, hw, hw, 3), ctx=ctx))   # finishes deferred init
    _randomize_bn(net, gen)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    with mx.name.NameManager():
        net.export(os.path.join(tmp, "resnet"))
    sym = mx.sym.load(os.path.join(tmp, "resnet-symbol.json"))
    params = mx.nd.load(os.path.join(tmp, "resnet-0000.params"), ctx=ctx)
    rng = np.random.RandomState(seed)
    reqs = [rng.uniform(-1, 1, (int(rng.randint(1, 5)), hw, hw, 3))
            .astype(np.float32) for _ in range(n_req)]
    burst = [rng.uniform(-1, 1, (1, hw, hw, 3)).astype(np.float32)
             for _ in range(n_burst)]
    return sym, params, hw, classes, max_batch, reqs, burst


def serving_phase(mx, ctx, rehearsal, seed=0):
    from mxnet_tpu_torch.kernels import fused_bn as K
    from mxnet_tpu_torch.serving import InferenceEngine
    sym, params, hw, classes, max_batch, reqs, burst = _served_resnet(
        mx, ctx, rehearsal, seed)
    n_req, n_burst = len(reqs), len(burst)
    graph_ops = collections.Counter(n.op.name for n in sym._topo_nodes()
                                    if n.op is not None)
    n_fused = graph_ops["_contrib_BatchNormAddReLU"]
    tf32 = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}

    # -- the main path: counts zeroed just before, read just after --------
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.launches = K.bwd_launches = 0
    t0 = time.perf_counter()
    eng = InferenceEngine(sym, params, {"data": (1, hw, hw, 3)},
                          max_batch=max_batch, max_wait_ms=2.0, ctx=ctx)
    t_ready = time.perf_counter()
    futs = [eng.submit(data=x) for x in reqs]
    outs = [f.result(timeout=600) for f in futs]
    t1 = time.perf_counter()
    bfuts = [eng.submit(data=x) for x in burst]
    bouts = [f.result(timeout=600) for f in bfuts]
    t2 = time.perf_counter()
    st = eng.stats()
    launches, _K1_BWD["serving"] = K.launches, K.bwd_launches
    forwards = len(eng.buckets) + st["batches"]
    # ---------------------------------------------------------------------

    for x, o in zip(reqs + burst, outs + bouts):
        assert o[0].shape == (x.shape[0], classes), o[0].shape
        assert np.isfinite(o[0]).all(), "non-finite logits"
    expect = n_fused * forwards if ctx.device_type == "gpu" else 0
    emit({"graph_ops": dict(graph_ops), "tails_per_forward": n_fused,
          "forwards": forwards,
          "kernel_launches": launches, "expected": expect,
          "bwd_launches": _K1_BWD["serving"]})
    assert n_fused == (16 if not rehearsal else 4), n_fused
    assert launches == expect, (launches, expect)
    assert _K1_BWD["serving"] == 0, _K1_BWD

    bucket_fwd_ms, profiles = {}, {}
    if ctx.device_type == "gpu":
        peak = torch.cuda.max_memory_allocated()
        for b in eng.buckets:
            xb = torch.zeros((b, hw, hw, 3), device=ctx.torch_device())
            args = dict(eng._param_raw, data=xb)
            args.update(eng._bucket_extras(b))
            fwd = lambda: eng._forward(args, eng._aux_raw)
            bucket_fwd_ms[str(b)] = time_cuda(fwd, iters=10, warmup=2)
            if b in (1, max_batch):
                profiles[str(b)] = profile_forward(fwd)
    else:
        peak = None
    emit({"serving": {
        "model": "resnet50_v1" if not rehearsal else "resnet_v1_small",
        "input": [hw, hw, 3], "classes": classes, "dtype": "float32",
        "tf32": tf32, "max_batch": max_batch,
        "requests": n_req + n_burst,
        "engine_build_and_warmup_s": t_ready - t0,
        "mixed_req_per_s": n_req / (t1 - t_ready),
        "burst_req_per_s": n_burst / (t2 - t1),
        "req_per_s": (n_req + n_burst) / (t2 - t_ready),
        "rows_per_s": (sum(x.shape[0] for x in reqs) + n_burst)
        / (t2 - t_ready),
        "latency_ms": st["latency_ms"], "batches": st["batches"],
        "buckets": st["buckets"], "batch_fill": st["batch_fill"],
        "bucket_dispatch_to_fetch_ms": {k: v["mean_ms"] for k, v in
                                        st["bucket_ms"].items()},
        "bucket_forward_ms": bucket_fwd_ms,
        "forward_profile": profiles,
        "max_memory_allocated": peak}})

    # -- the port on the CPU recomputes 4 requests (TF32 off on the card) -
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    check = reqs[:4]
    gpu_out = [eng.submit(data=x).result(timeout=600)[0] for x in check]
    eng.close()
    cpu_params = {k: v.as_in_context(mx.cpu()) for k, v in params.items()}
    pred = mx.predictor.Predictor(sym, cpu_params, {"data": (1, hw, hw, 3)},
                                  ctx=mx.cpu())
    worst = 0.0
    for x, g in zip(check, gpu_out):
        p = pred.reshape({"data": x.shape})
        p.forward(data=x)
        c = p.get_output(0).asnumpy()
        rel = float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-30))
        worst = max(worst, rel)
    # fp32 on both sides; cuDNN and the CPU sum in different orders over
    # 50+ layers, so agreement is held to 1e-3 of the largest logit
    emit({"cpu_recompute": {"requests": len(check), "tf32": False,
                            "max_abs_err_over_max_logit": worst,
                            "tol": 1e-3}})
    assert worst <= 1e-3, worst
    return launches


# flash attention cases: (label, B, H, Sq, Skv, D, causal, dtype)
_ATTN_CASES = (
    ("lm", 8, 8, 512, 512, 64, True, torch.float32),
    ("long", 1, 8, 4096, 4096, 64, True, torch.float32),
    ("long", 1, 8, 4096, 4096, 64, True, torch.bfloat16),
    ("wide", 2, 16, 2048, 2048, 128, False, torch.bfloat16),
    ("ragged", 1, 3, 1000, 1500, 64, False, torch.float32),
    ("ragged", 1, 3, 1000, 1500, 64, True, torch.bfloat16),
    ("d20", 2, 4, 300, 300, 20, True, torch.bfloat16),
    ("d3", 1, 4, 257, 311, 3, False, torch.float32),
    ("d72", 2, 8, 1024, 1024, 72, True, torch.bfloat16),
)
_ATTN_REHEARSAL = (
    ("lm", 2, 2, 64, 64, 16, True, torch.float32),
    ("long", 1, 2, 100, 100, 16, True, torch.bfloat16),
    ("ragged", 1, 3, 40, 70, 16, False, torch.float32),
    ("d20", 1, 2, 30, 30, 20, True, torch.bfloat16),
)
# the error of a kernel against its plain version, over max(1, the largest
# magnitude of the plain result): fp32 at the JAX package's flash-vs-plain
# tolerances (tests/test_pallas.py: 2e-5 forward, 1e-4 gradients); bf16
# rounds outputs to 8 bits of mantissa (one ulp at 1 is 2^-7), so 2e-2
_ATTN_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# peak rate of the card by operand type (H100 SXM data sheet), dense: bf16 on
# the tensor cores 989 TFLOP/s; fp32 at fp32 accuracy 495 / 3 = 165 TFLOP/s,
# because the tensor cores give that accuracy only as 3xTF32 (three tf32
# products of 495 TFLOP/s for each fp32 product), which is what the kernels
# and SDPA's fp32 kernel do. The CUDA-core fp32 rate (67 TFLOP/s), against
# which the earlier CUDA-core kernels were measured, is kept beside it as a
# second share.
_PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
_CUDA_CORE_FP32 = 67e12


def _visible_pairs(s_q, s_kv, causal):
    """(query, key) pairs the mask lets through, per batch*head: all of
    them, or under the causal mask min(row + 1, Skv) for each row."""
    if not causal:
        return s_q * s_kv
    return int(np.minimum(np.arange(1, s_q + 1), s_kv).sum())


def _bound_us(flops, nbytes, dtype, rate, peak=None):
    peak = _PEAK_FLOPS[dtype] if peak is None else peak
    t_ops, t_bytes = flops / peak, nbytes / rate
    return max(t_ops, t_bytes) * 1e6, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _short_names(names):
    """{kernel: us} with the demangled names cut to name<template args>."""
    out = {}
    for key, ms in names.items():
        short = key.split(">(")[0].replace("void (anonymous namespace)::", "")
        out[short + (">" if "<" in short else "")] = \
            None if ms is None else ms * 1e3
    return out


def _scaled_err(got, want):
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def _attn_plain_forward(FA, q, k, v, causal):
    """The plain version of the flash forward: the carry reference from
    the empty accumulator, then the normalisation."""
    b, h, s_q, d = q.shape
    bh = b * h
    flat = lambda x: x.reshape(bh, x.shape[2], d)  # noqa: E731
    o0 = torch.zeros((bh, s_q, d), device=q.device)
    m0 = torch.full((bh, s_q), FA.NEG_INF, device=q.device)
    l0 = torch.zeros((bh, s_q), device=q.device)
    o, m, l = FA.flash_attention_carry_reference(flat(q), flat(k), flat(v),
                                                 o0, m0, l0, 0, 0, causal)
    l = torch.clamp_min(l, 1e-30)
    return ((o / l[..., None]).to(q.dtype).reshape(q.shape),
            (m + torch.log(l)).reshape(b, h, s_q))


def attention_phase(dev, rate, rehearsal):
    """K2 and K3 against their plain versions; returns the LM-shape
    numbers for the kernels line."""
    from mxnet_tpu_torch.kernels import flash_attention as FA
    import torch.nn.functional as F
    cuda = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    lm = {}
    for label, b, h, s_q, s_kv, d, causal, dtype in (
            _ATTN_REHEARSAL if rehearsal else _ATTN_CASES):
        rnd = lambda s: torch.randn((b, h, s, d), generator=g,  # noqa: E731
                                    device=dev).to(dtype)
        q, k, v, gr = rnd(s_q), rnd(s_kv), rnd(s_kv), rnd(s_q)
        bh = b * h
        flat = lambda x: x.reshape(bh, x.shape[2], d)  # noqa: E731
        tol_f, tol_b = _ATTN_TOL[dtype]
        fwd = lambda: FA.flash_attention_forward(q, k, v, causal)  # noqa: E731
        fwd_plain = lambda: _attn_plain_forward(FA, q, k, v, causal)  # noqa: E731
        out, lse = fwd()
        out_p, lse_p = fwd_plain()
        delta = (gr.float() * out.float()).sum(-1)
        bargs = (flat(q), flat(k), flat(v), flat(gr), lse.reshape(bh, s_q),
                 delta.reshape(bh, s_q), causal)
        bwd = lambda: FA.flash_attention_bwd(*bargs)  # noqa: E731
        bwd_plain = lambda: FA.flash_attention_bwd_reference(*bargs)  # noqa: E731
        grads, grads_p = bwd(), bwd_plain()
        if cuda:
            torch.cuda.synchronize()
        err_out, rel_out = _scaled_err(out, out_p)
        err_lse, rel_lse = _scaled_err(lse, lse_p)
        bwd_errs = [_scaled_err(a, p) for a, p in zip(grads, grads_p)]
        err_b, rel_b = max(e for e, _ in bwd_errs), max(r for _, r in bwd_errs)
        ok = max(rel_out, rel_lse) <= tol_f and rel_b <= tol_b
        rec = {"kernel": "flash_attention", "case": label,
               "shape": [b, h, s_q, s_kv, d], "causal": causal,
               "dtype": str(dtype).replace("torch.", ""),
               "fwd_max_abs_err": max(err_out, err_lse),
               "fwd_scaled_err": max(rel_out, rel_lse), "fwd_tol": tol_f,
               "bwd_max_abs_err": err_b, "bwd_scaled_err": rel_b,
               "bwd_tol": tol_b, "match": bool(ok)}
        if cuda:
            item = q.element_size()
            pairs = bh * _visible_pairs(s_q, s_kv, causal)
            # each input read once, each output written once: forward
            # q, k, v -> out, lse; backward q, k, v, g, lse, delta -> dq, dk, dv
            fwd_bytes = item * (2 * bh * s_q * d + 2 * bh * s_kv * d) \
                + 4 * bh * s_q
            bwd_bytes = item * (3 * bh * s_q * d + 4 * bh * s_kv * d) \
                + 8 * bh * s_q
            bf, bf_by = _bound_us(4 * pairs * d, fwd_bytes, dtype, rate)
            bb, bb_by = _bound_us(10 * pairs * d, bwd_bytes, dtype, rate)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal)
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qr, kr, vr,
                                                   is_causal=causal)
            sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
                o_lib, (qr, kr, vr), gr, retain_graph=True)
            sdpa_both = lambda: torch.autograd.grad(  # noqa: E731
                F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal),
                (qr, kr, vr), gr)
            # event times (host dispatch included) beside device times
            # from a profiler trace (the kernels alone)
            f_dev, f_names = device_time(fwd, "flash_fwd_kernel")
            b_dev, b_names = device_time(bwd, "flash_bwd_")
            lf_dev, lf_names = device_time(sdpa)
            lb_dev, lb_names = device_time(sdpa_bwd)
            rec.update({
                "fwd_us": time_cuda(fwd) * 1e3,
                "fwd_device_us": f_dev * 1e3,
                "fwd_kernels_us": _short_names(f_names),
                "fwd_plain_us": time_cuda(fwd_plain) * 1e3,
                "fwd_library_us": time_cuda(sdpa) * 1e3,
                "fwd_library_device_us": lf_dev * 1e3,
                "fwd_library_kernels": sorted(lf_names),
                "fwd_bound_us": bf, "fwd_bound_by": bf_by,
                "fwd_flops": 4 * pairs * d, "fwd_bytes": fwd_bytes,
                "bwd_us": time_cuda(bwd) * 1e3,
                "bwd_device_us": b_dev * 1e3,
                "bwd_kernels_us": _short_names(b_names),
                "bwd_plain_us": time_cuda(bwd_plain) * 1e3,
                "bwd_library_us": time_cuda(sdpa_bwd) * 1e3,
                "bwd_library_device_us": lb_dev * 1e3,
                "bwd_library_kernels": sorted(lb_names),
                "fwd_bwd_library_us": time_cuda(sdpa_both) * 1e3,
                "bwd_bound_us": bb, "bwd_bound_by": bb_by,
                "bwd_flops": 10 * pairs * d, "bwd_bytes": bwd_bytes})
            # shares use the device time
            rec["fwd_roofline_share"] = bf / rec["fwd_device_us"]
            rec["bwd_roofline_share"] = bb / rec["bwd_device_us"]
            if dtype == torch.float32:
                rec["fwd_cuda_core_bound_us"] = _bound_us(
                    4 * pairs * d, fwd_bytes, dtype, rate, _CUDA_CORE_FP32)[0]
                rec["bwd_cuda_core_bound_us"] = _bound_us(
                    10 * pairs * d, bwd_bytes, dtype, rate, _CUDA_CORE_FP32)[0]
                rec["fwd_cuda_core_share"] = \
                    rec["fwd_cuda_core_bound_us"] / rec["fwd_device_us"]
                rec["bwd_cuda_core_share"] = \
                    rec["bwd_cuda_core_bound_us"] / rec["bwd_device_us"]
            del o_lib, qr, kr, vr
        emit(rec)
        if not ok:
            raise AssertionError("flash attention kernel disagrees with its "
                                 "plain version: %s" % rec)
        if label == "lm":
            lm = rec
    _carry_chain_case(FA, dev, g, rehearsal)
    return lm


def _carry_chain_case(FA, dev, g, rehearsal):
    """The second query block of a two-way causal ring at the LM's shape:
    queries at offset S merge the key halves [0, S) and [S, 2S) one after
    the other; equal to one call over all 2S keys and to the plain
    version's chain."""
    bh, s, d = (4, 48, 16) if rehearsal else (64, 512, 64)
    q = torch.randn((bh, s, d), generator=g, device=dev)
    k = torch.randn((bh, 2 * s, d), generator=g, device=dev)
    v = torch.randn((bh, 2 * s, d), generator=g, device=dev)

    def init():
        return (torch.zeros((bh, s, d), device=dev),
                torch.full((bh, s), FA.NEG_INF, device=dev),
                torch.zeros((bh, s), device=dev))

    def chain(fn):
        c = init()
        for kv_off in (0, s):
            c = fn(q, k[:, kv_off:kv_off + s].contiguous(),
                   v[:, kv_off:kv_off + s].contiguous(), *c,
                   q_offset=s, kv_offset=kv_off, causal=True)
        return c

    got = chain(FA.flash_attention_carry)
    want = chain(FA.flash_attention_carry_reference)
    whole = FA.flash_attention_carry(q, k, v, *init(), q_offset=s,
                                     kv_offset=0, causal=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    errs = [_scaled_err(a, b)[1] for a, b in zip(got, want)]
    norm = lambda c: c[0] / c[2][..., None]  # noqa: E731
    errs.append(_scaled_err(norm(got), norm(whole))[1])
    tol = _ATTN_TOL[torch.float32][0]
    rec = {"kernel": "flash_attention_carry", "case": "two-half chain",
           "shape": [bh, s, 2 * s, d], "q_offset": s, "kv_offsets": [0, s],
           "causal": True, "dtype": "float32", "scaled_err": max(errs),
           "tol": tol, "match": max(errs) <= tol}
    if dev.type == "cuda":
        kh, vh = k[:, s:].contiguous(), v[:, s:].contiguous()
        c0 = init()
        rec["carry_us"] = time_cuda(lambda: FA.flash_attention_carry(
            q, kh, vh, *c0, q_offset=s, kv_offset=s, causal=True)) * 1e3
        rec["carry_plain_us"] = time_cuda(
            lambda: FA.flash_attention_carry_reference(
                q, kh, vh, *c0, q_offset=s, kv_offset=s, causal=True)) * 1e3
    emit(rec)
    if not rec["match"]:
        raise AssertionError("carry chain disagrees: %s" % rec)


def _lm_params(vocab, embed, seed=0):
    """The graft LM's parameters (``__graft_entry__.py:76-86``)."""
    rng = np.random.RandomState(seed)
    shapes = (("embed", (vocab, embed)), ("wq", (embed, embed)),
              ("wk", (embed, embed)), ("wv", (embed, embed)),
              ("wo", (embed, embed)), ("w1", (4 * embed, embed)),
              ("w2", (embed, 4 * embed)), ("head", (vocab, embed)))
    return {n: rng.normal(0, 0.02, s).astype(np.float32) for n, s in shapes}


def _lm_apply(attn, batch, seq, heads, embed, relu=torch.relu):
    """``__graft_entry__.py:88-104`` in PyTorch, with the attention (and,
    for the CPU recompute, the MLP's ReLU) as a parameter: embedding,
    causal multi-head attention, a residual, a ReLU MLP of width 4E, the
    vocabulary head and the mean next-token NLL."""
    d = embed // heads

    def split(t):
        return t.reshape(batch, seq, heads, d).permute(0, 2, 1, 3)

    def apply_fn(p, x, y):
        e = p["embed"][x.long()]
        a = attn(split(e @ p["wq"].T), split(e @ p["wk"].T),
                 split(e @ p["wv"].T))
        h = e + a.permute(0, 2, 1, 3).reshape(batch, seq, embed) @ p["wo"].T
        h = h + relu(h @ p["w1"].T) @ p["w2"].T
        logp = torch.log_softmax(h @ p["head"].T, dim=-1)
        return (-logp.gather(-1, y.long()[..., None])).mean()
    return apply_fn


def _recording_relu(store, key):
    """torch.relu that keeps the sign mask of its first input under
    ``store[key]``."""
    def relu(x):
        if key not in store:
            store[key] = (x > 0).detach()
        return torch.relu(x)
    return relu


def _max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def training_phase(mx, ctx, rehearsal, steps=5):
    """The LM through SPMDTrainer, a Ulysses leg and a ring leg; returns
    the K2 and K3 launches over both legs."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.kernels import flash_attention as FA
    vocab, embed, heads, batch, seq = (64, 32, 4, 2, 16) if rehearsal \
        else (8192, 512, 8, 8, 512)
    gpu = ctx.device_type == "gpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = _lm_params(vocab, embed)
    batches = [(np.random.RandomState(1 + i).randint(0, vocab, (batch, seq))
                .astype(np.int32),
                np.random.RandomState(101 + i).randint(0, vocab, (batch, seq))
                .astype(np.int32)) for i in range(steps)]
    spec = parallel.P("dp", "sp")
    total = {"fwd": 0, "bwd": 0}
    first = {}         # leg -> (losses, momentum after step 1)
    for leg, fn, bwd_per_step in (("ulysses", parallel.ulysses_attention, 1),
                                  ("ring", parallel.ring_attention, 0)):
        def trainer_on(c, use_pallas=None, relu=torch.relu):
            mesh = parallel.make_mesh({"dp": 1, "sp": 1, "tp": 1},
                                      devices=[c])
            attn = lambda q, k, v: fn(q, k, v, mesh, axis_name="sp",  # noqa: E731
                                      batch_axis_name="dp", causal=True,
                                      use_pallas=use_pallas)
            return parallel.SPMDTrainer(
                _lm_apply(attn, batch, seq, heads, embed, relu), params, mesh,
                data_axis="dp", tp_axis="tp", learning_rate=0.1,
                momentum=0.9, batch_specs=[spec, spec])

        masks = {}     # the MLP's ReLU sign mask in step 1, per side
        tr = trainer_on(ctx, relu=_recording_relu(masks, "card"))
        # -- the main path: counts zeroed just before, read just after ----
        if gpu:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        FA.fwd_launches = FA.bwd_launches = 0
        losses = [float(tr.step(*batches[0]))]
        p1 = tr.get_params()
        mom1 = {n: m.cpu().numpy() for n, m in tr.mom.items()}
        t0 = time.perf_counter()
        if gpu:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        rest = [tr.step(*b) for b in batches[1:]]
        if gpu:
            end.record()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fwd": FA.fwd_launches, "bwd": FA.bwd_launches}
        # -----------------------------------------------------------------
        losses += [float(x) for x in rest]
        for key in total:
            total[key] += launches[key]
        expect = ({"fwd": steps, "bwd": bwd_per_step * steps} if gpu
                  else {"fwd": 0, "bwd": 0})
        rec = {"leg": leg, "model": {"vocab": vocab, "embed": embed,
                                     "heads": heads, "batch": batch,
                                     "seq": seq, "dtype": "float32"},
               "steps": steps, "losses": losses,
               "kernel_launches": launches, "expected": expect,
               "tf32": False}
        if gpu:
            step_ms = start.elapsed_time(end) / (steps - 1)
            rec.update({"step_ms": step_ms,
                        "step_wall_ms": wall * 1e3 / (steps - 1),
                        "tokens_per_s": batch * seq / step_ms * 1e3,
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated(),
                        "step_profile": profile_forward(
                            lambda: tr.step(*batches[0]), reps=2)})
        # -- step 1 again by the port on the CPU, plain versions ----------
        cpu_tr = trainer_on(mx.cpu(), use_pallas=True)
        cpu_loss = float(cpu_tr.step(*batches[0]))
        cpu_p = cpu_tr.get_params()
        param_err = max(_max_rel(p1[n], cpu_p[n]) for n in params)
        loss_err = abs(losses[0] - cpu_loss) / abs(cpu_loss)
        # The gradients: a ReLU unit of the MLP whose pre-activation lies
        # within rounding of zero can take the other branch on one side,
        # which moves a whole token's contribution (one such unit moved
        # 3.6e-3 of the largest w1 gradient on the H100, against float64).
        # So step 1 is recomputed on the CPU once more with the card's ReLU
        # mask in place of its own; after step 1 the momentum is
        # -lr * gradient, compared without the cancellation of p1 - p0.
        card_mask = masks["card"].cpu()
        own = {}
        def card_relu(x):  # noqa: E306
            if "cpu" not in own:
                own["cpu"] = (x > 0).detach()
            return torch.where(card_mask, x, torch.zeros_like(x))
        same_tr = trainer_on(mx.cpu(), use_pallas=True, relu=card_relu)
        same_tr.step(*batches[0])
        grad_errs = {n: _max_rel(mom1[n], same_tr.mom[n].numpy())
                     for n in params}
        mom_err = max(grad_errs.values())
        flips = int((own["cpu"] != card_mask).sum())
        # fp32 on both sides with TF32 off; cuBLAS, the kernels' 3xTF32 and
        # the CPU sum in other orders: 1e-4 of the largest magnitude for
        # the loss and the parameters, 1e-3 for the gradients
        rec["cpu_recompute"] = {"loss": cpu_loss, "loss_rel_err": loss_err,
                                "param_rel_err": param_err,
                                "relu_units_flipped": flips,
                                "grad_rel_err_with_card_relu_mask": mom_err,
                                "grad_rel_err_by_param": grad_errs,
                                "tol": 1e-4, "grad_tol": 1e-3}
        emit({"training": rec})
        assert all(np.isfinite(losses)), losses
        assert launches == expect, (launches, expect)
        assert loss_err <= 1e-4 and param_err <= 1e-4, rec["cpu_recompute"]
        assert mom_err <= 1e-3, rec["cpu_recompute"]
        first[leg] = (losses, mom1)
    # the two legs share every layer but the attention's backward (K3
    # against the plain ring backward) and its forward epilogue, on the
    # same device: the step-1 gradients and all losses agree closely
    (lu, mu), (lr_, mr) = first["ulysses"], first["ring"]
    cross = {"grad_rel_err": max(_max_rel(mu[n], mr[n]) for n in mu),
             "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(lu, lr_)),
             "tol": 1e-4}
    emit({"training_legs_agree": cross})
    assert max(cross["grad_rel_err"], cross["loss_rel_err"]) <= 1e-4, cross
    return total


# -- ResNet-50 training -------------------------------------------------------

_BENCH_LR, _BENCH_MOMENTUM = 0.05, 0.9      # bench.py:52-60


def _resnet_net(mx, ctx, rehearsal, seed=0, fused=True, init=True):
    """The model-zoo ``resnet50_v1``, NHWC with fused block tails, Xavier
    weights from a seeded ``torch.Generator`` (rehearsal: a narrow ResNet
    v1 at 32x32, 10 classes); deferred shapes completed on ``ctx``.
    ``fused=False`` builds the block tails as BatchNorm, add and ReLU
    (the same parameters in the same order, other names), which runs in
    fp64 where K1 takes fp32 and bf16 only. ``init=False`` leaves the
    weights uninitialised (the symbol and the parameter names only)."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    os.environ["MXNET_FUSED_BN_ADD_RELU"] = "1" if fused else "0"
    mx.layout.set_default_layout("NHWC")
    hw, classes = (32, 10) if rehearsal else (224, 1000)
    with mx.name.NameManager():
        net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                              [16, 32, 64, 128, 256], classes=10) \
            if rehearsal else resnet.resnet50_v1()
        sym = mx.sym.SoftmaxOutput(net(mx.sym.Variable("data")),
                                   mx.sym.Variable("softmax_label"),
                                   name="softmax")
    if init:
        net.initialize(mx.init.Xavier(generator=torch.Generator()
                                      .manual_seed(seed)), ctx=ctx)
        net(mx.nd.zeros((1, hw, hw, 3), ctx=ctx))
    return net, sym, hw, classes


class _RawStep:
    """``bench.py``'s raw step (``bench.py:191-300``) in the port: the
    pure function of ``gluon.block.make_pure_fn(net, train=True)``, the
    mean NLL over fp32 ``log_softmax``, ``torch.autograd.grad``, then
    multi-precision SGD-momentum: conv and FC weights bf16-resident with
    fp32 masters (``mp_sgd_mom_update``), BN gamma/beta and moving stats
    fp32 (``sgd_mom_update``), BN running stats written back from the aux
    map."""

    def __init__(self, net, dev, x, y):
        from mxnet_tpu_torch.gluon.block import make_pure_fn
        from mxnet_tpu_torch.ops import optimizer_ops as O
        self.O = O
        self.fn, raw, self.names = make_pure_fn(net, train=True)
        keep = [any(t in n for t in ("gamma", "beta", "running_mean",
                                     "running_var")) for n in self.names]
        self.lowp = [not k for k in keep]
        self.master = [r.detach().to(dev, torch.float32, copy=True)
                       for r in raw]
        self.mom = [torch.zeros_like(m) for m in self.master]
        self.pbf = [m.to(torch.bfloat16) if lp else None
                    for m, lp in zip(self.master, self.lowp)]
        self.x, self.y = x, y

    def __call__(self):
        full = [(self.pbf[i] if self.lowp[i] else self.master[i]).detach()
                .requires_grad_() for i in range(len(self.master))]
        (logits,), aux = self.fn(full, [self.x])
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -logp.gather(1, self.y[:, None]).mean()
        grads = torch.autograd.grad(loss, full, allow_unused=True)
        O = self.O
        with torch.no_grad():
            for i, g in enumerate(grads):
                if i in aux:
                    self.master[i] = aux[i].float()
                elif g is None:
                    continue
                elif self.lowp[i]:
                    self.pbf[i], self.mom[i], self.master[i] = \
                        O.mp_sgd_mom_update(
                            self.pbf[i], g, self.mom[i], self.master[i],
                            lr=_BENCH_LR, momentum=_BENCH_MOMENTUM)
                else:
                    self.master[i], self.mom[i] = O.sgd_mom_update(
                        self.master[i], g, self.mom[i], lr=_BENCH_LR,
                        momentum=_BENCH_MOMENTUM)
        return loss.detach()


def _raw_leg(mx, net, ctx, rehearsal, hw, classes):
    """The raw step at full width: batch 128, bf16 + fp32 masters, 2
    warm-up and 5 timed steps on one fixed synthetic batch."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    gpu = ctx.device_type == "gpu"
    dev = ctx.torch_device()
    batch, warm, timed = (8, 2, 5) if rehearsal else (128, 2, 5)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.uniform(-1, 1, (batch, hw, hw, 3))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, classes, batch)).to(dev)
    step = _RawStep(net, dev, x, y)
    # -- the main path: counts zeroed just before, read just after --------
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.launches = K.bwd_launches = K.strided_grads = 0
    losses = [step() for _ in range(warm)]
    if gpu:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    losses += [step() for _ in range(timed)]
    if gpu:
        end.record()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, strided = K.launches, K.strided_grads
    bwd = K.bwd_launches
    # ---------------------------------------------------------------------
    losses = [float(v) for v in losses]
    expect = 16 * (warm + timed) if gpu else 0
    rec = {"leg": "raw_step", "model": "resnet50_v1" if not rehearsal
           else "resnet_v1_small", "input": [hw, hw, 3], "classes": classes,
           "batch": batch, "precision": "bf16 weights + fp32 masters",
           "lr": _BENCH_LR, "momentum": _BENCH_MOMENTUM,
           "steps": warm + timed, "losses": losses,
           "kernel_launches": launches, "expected": expect,
           "bwd_launches": bwd,
           # of a step's 16 backward calls, those whose incoming
           # gradient arrived strided (the wrapper copies it dense)
           "bwd_strided_g_per_step": strided / (warm + timed)}
    if gpu:
        step_ms = start.elapsed_time(end) / timed
        rec.update({"step_ms": step_ms, "step_wall_ms": wall * 1e3 / timed,
                    "img_per_s": batch / step_ms * 1e3,
                    "max_memory_allocated":
                        torch.cuda.max_memory_allocated(),
                    "step_profile": profile_forward(step, reps=2)})
    emit({"resnet_training": rec})
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert launches == expect, (launches, expect)
    assert bwd == expect, (bwd, expect)
    _K1_BWD["training"] += bwd
    del step
    return launches


def _module_data(n, batch, hw, classes, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, (n * batch, hw, hw, 3)).astype(np.float32),
            rs.randint(0, classes, n * batch).astype(np.float32))


def _module_run(mx, sym, ctx, arg, aux, data, batch, fused, snap=None,
                tape=None):
    """One epoch of ``Module.fit`` over ``data`` from ``arg``/``aux``;
    ``snap`` collects the parameters and the cross-entropy after batch 0,
    ``tape`` the ReLU branches of batch 0's forward. Returns (module,
    metric, seconds per batch after the first)."""
    os.environ["MXNET_MODULE_FUSED_STEP"] = "1" if fused else "0"
    hw = data[0].shape[1]
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (batch, hw, hw, 3))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params=arg, aux_params=aux)
    np.random.seed(5)
    it = mx.io.NDArrayIter(data[0], data[1], batch_size=batch, shuffle=True)
    metric = mx.metric.create(["acc", "ce"])
    opt = {"learning_rate": _BENCH_LR, "momentum": _BENCH_MOMENTUM,
           "rescale_grad": 1.0 / batch}

    marks = []

    def batch_end(param):
        marks.append(time.perf_counter())
        if tape is not None:
            tape.mode = None
        if snap is not None and param.nbatch == 0:
            snap["ce"] = param.eval_metric.get_metric(1).get()[1]
            snap["params"] = {k: v.asnumpy()
                              for k, v in mod.get_params()[0].items()}
    if tape is not None:
        tape.mode = "record"
    mod.fit(it, eval_metric=metric, optimizer="sgd", optimizer_params=opt,
            num_epoch=1, batch_end_callback=batch_end)
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
    # bench.py's method: from the first batch's end to the drained queue,
    # over the batches after the first
    secs = (time.perf_counter() - marks[0]) / (len(marks) - 1)
    assert (mod._fused_fallback_reason is None) == fused, \
        mod._fused_fallback_reason
    os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
    return mod, metric, secs


def _masked_tail(x, scale, bias, residual, mask):
    """The plain block tail (``scale_bias_add_relu_reference``'s ops) with
    the ReLU's branch given per element, in place of the sign of its own
    sum: the plain version recomputed on another computation's branches
    (a bf16 sum within an ulp of zero can land on either side)."""
    y = x * scale.to(x.dtype) + bias.to(x.dtype)
    if residual is not None:
        y = y + residual
    return torch.where(mask, y, torch.zeros((), dtype=y.dtype,
                                            device=y.device))


class _BranchTape:
    """The ReLU branches of ResNet's forward — every ``Activation`` ReLU
    (as its gradient factor) and every block tail (as its mask) —
    recorded on one device and replayed on another (as the LM's CPU
    recompute takes the card's ReLU mask: a unit within rounding of zero
    can take the other branch on the other device and move a whole
    batch's gradient).
    ``mode`` None passes through, "record" keeps each branch mask,
    "replay" takes the recorded masks in order and counts the units whose
    own branch differs."""

    def __init__(self):
        from mxnet_tpu_torch.kernels import fused_bn as K
        from mxnet_tpu_torch.ops.registry import get_op
        self.K, self.op = K, get_op("Activation")
        self.act, self.tail = self.op.fn, K.scale_bias_add_relu
        self.mode, self.masks, self.flips, self.units = None, [], 0, 0

    def __enter__(self):
        self.op.fn, self.K.scale_bias_add_relu = self._act, self._tail
        return self

    def __exit__(self, *exc):
        self.op.fn, self.K.scale_bias_add_relu = self.act, self.tail

    def _take(self, own):
        mask = self.masks.pop(0).to(own.device)
        self.flips += int((mask != own).sum())
        self.units += mask.numel()
        return mask

    @staticmethod
    def _factor(data):
        """max(x, 0)'s gradient: 1 above 0, 1/2 at the tie, 0 below."""
        return (data > 0).to(data.dtype) + 0.5 * (data == 0).to(data.dtype)

    def _act(self, data, act_type="relu"):
        if act_type != "relu" or self.mode is None \
                or data.device.type == "meta":      # shape inference
            return self.act(data, act_type)
        twice = (2 * self._factor(data.detach())).to(torch.uint8)
        if self.mode == "record":
            self.masks.append(twice.cpu())
            return self.act(data, act_type)
        # x * factor: the recorded branch's value and gradient
        return data * (self._take(twice).to(data.dtype) / 2)

    def _tail(self, x, scale, bias, residual=None):
        if self.mode is None or x.device.type == "meta":
            return self.tail(x, scale, bias, residual)
        if self.mode == "record":
            out = self.tail(x, scale, bias, residual)
            self.masks.append((out > 0).cpu())
            return out
        own = self.K.scale_bias_add_relu_reference(x, scale, bias,
                                                   residual) > 0
        return _masked_tail(x, scale, bias, residual, self._take(own))


def _module_first_step(mx, sym, ctx, arg, aux, data, batch):
    """The first batch of ``_module_run``'s iterator through one fused
    step on ``ctx``: the cross-entropy and the parameters after it."""
    hw = data[0].shape[1]
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (batch, hw, hw, 3))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": _BENCH_LR, "momentum": _BENCH_MOMENTUM,
        "rescale_grad": 1.0 / batch})
    np.random.seed(5)
    it = mx.io.NDArrayIter(data[0], data[1], batch_size=batch, shuffle=True)
    it.reset()                  # as fit does before its first epoch
    metric = mx.metric.create(["acc", "ce"])
    assert mod.fused_step(next(it), eval_metric=metric)
    return {"ce": metric.get_metric(1).get()[1],
            "params": {k: v.asnumpy()
                       for k, v in mod.get_params()[0].items()}}


def _module_leg(mx, net, sym, ctx, rehearsal, hw, classes):
    """``Module.fit`` on the same net captured as a symbol with
    ``SoftmaxOutput``: fp32, batch 32, 6 batches, through the fused batch
    step and then phase-split from the same params; step 1 recomputed by
    the port on the CPU."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    gpu = ctx.device_type == "gpu"
    batch, n = (4, 6) if rehearsal else (32, 6)
    aux_names = set(sym.list_auxiliary_states())
    params = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    arg = {k: v for k, v in params.items() if k not in aux_names}
    aux = {k: v for k, v in params.items() if k in aux_names}
    data = _module_data(n, batch, hw, classes)
    torch.backends.cudnn.deterministic = True
    if gpu:
        torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts zeroed just before, read just after --------
    K.launches = K.bwd_launches = 0
    fused, f_metric, f_secs = _module_run(mx, sym, ctx, arg, aux, data,
                                          batch, True)
    launches_fused, bwd_fused = K.launches, K.bwd_launches
    K.launches = K.bwd_launches = 0
    snap = {}
    with _BranchTape() as tape:
        split, s_metric, s_secs = _module_run(mx, sym, ctx, arg, aux, data,
                                              batch, False, snap, tape)
    launches_split, bwd_split = K.launches, K.bwd_launches
    # ---------------------------------------------------------------------
    expect = 16 * n if gpu else 0
    peak = torch.cuda.max_memory_allocated() if gpu else None
    fa, fx = fused.get_params()
    sa, sx = split.get_params()
    f_states = mx.weights.module_to_numpy(fused)[2]
    s_states = mx.weights.module_to_numpy(split)[2]
    gap = 0.0
    for a, b in [(fa[k].asnumpy(), sa[k].asnumpy()) for k in fa] + \
            [(fx[k].asnumpy(), sx[k].asnumpy()) for k in fx] + \
            [(f_states[i], s_states[i]) for i in f_states]:
        gap = max(gap, _max_rel(a, b))
    rec = {"leg": "module_fit", "batch": batch, "batches": n,
           "dtype": "float32", "tf32": False, "cudnn_deterministic": True,
           "optimizer": {"learning_rate": _BENCH_LR,
                         "momentum": _BENCH_MOMENTUM,
                         "rescale_grad": 1.0 / batch},
           "fused_metric": f_metric.get_name_value(),
           "phase_split_metric": s_metric.get_name_value(),
           "kernel_launches": {"fused": launches_fused,
                               "phase_split": launches_split},
           "bwd_launches": {"fused": bwd_fused, "phase_split": bwd_split},
           "expected_each": expect,
           "fused_ms_per_batch": f_secs * 1e3,
           "phase_split_ms_per_batch": s_secs * 1e3,
           "fused_img_per_s": batch / f_secs,
           "fused_vs_phase_split_max_rel": gap,
           "max_memory_allocated": peak}
    del fused, split
    # -- step 1 again by the port on the CPU, from the same params: once
    # on its own ReLU branches (the loss), once on the card's (the
    # parameters: a branch within rounding of zero moves a gradient) ---
    t0 = time.perf_counter()
    own = _module_first_step(mx, sym, mx.cpu(), arg, aux, data, batch)
    cpu_s = time.perf_counter() - t0
    tape.mode = "replay"
    with tape:
        same = _module_first_step(mx, sym, mx.cpu(), arg, aux, data, batch)
    assert not tape.masks, len(tape.masks)
    loss_err = abs(snap["ce"] - own["ce"]) / abs(own["ce"])

    def param_errs(cpu):
        # a conv bias ahead of a BatchNorm has a zero gradient in exact
        # arithmetic: after the step its value is rounding noise on both
        # sides, held to the largest magnitude of all weights
        largest = float(max(np.abs(v).max() for v in cpu.values()))
        per, noise = 0.0, 0.0
        for k, card_v in snap["params"].items():
            if "conv" in k and k.endswith("_bias"):
                noise = max(noise, float(np.abs(card_v - cpu[k]).max())
                            / largest)
            else:
                per = max(per, _max_rel(card_v, cpu[k]))
        return per, noise
    own_err, _ = param_errs(own["params"])
    param_err, noise_err = param_errs(same["params"])
    rec["cpu_recompute"] = {
        "batch": batch, "seconds": cpu_s, "loss": own["ce"],
        "card_loss": snap["ce"], "loss_rel_err": loss_err,
        "param_rel_err_own_branches": own_err,
        "param_rel_err_card_branches": param_err,
        "conv_bias_err_over_largest_weight": noise_err,
        "relu_units_flipped": tape.flips, "relu_units": tape.units,
        "loss_tol": 1e-4, "param_tol": 1e-3}
    emit({"resnet_training": rec})
    torch.backends.cudnn.deterministic = False
    ok = [name for name, v in (("fused", f_metric), ("split", s_metric))
          if not all(np.isfinite(x) for _, x in v.get_name_value())]
    assert not ok, ok
    assert launches_fused == launches_split == expect, rec
    assert bwd_fused == bwd_split == expect, rec
    _K1_BWD["training"] += bwd_fused + bwd_split
    # max pooling's backward on CUDA adds through atomics, in no fixed
    # order; everything else repeats bit for bit under cudnn.deterministic
    assert gap <= 1e-4, rec
    assert loss_err <= 1e-4 and max(param_err, noise_err) <= 1e-3, \
        rec["cpu_recompute"]
    return launches_fused + launches_split


def _rel_to_max(got, want):
    """(max abs error, the same over the largest magnitude of ``want``)."""
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


# the block tails of resnet50_v1 at batch 32: (H=W, C, tails in the stage)
def _tail_cases(rehearsal):
    if rehearsal:
        return ((4, 8, 8, 16), 1), ((2, 3, 5, 33), 1)
    return tuple(((32, hw, hw, c), k) for hw, c, k in _R50_TAILS)


def tail_backward_phase(dev, rate, rehearsal):
    """K1 under autograd against autograd through its plain version at
    the batch-32 block-tail shapes and the ragged ones, fp32 and bf16,
    with a residual and the incoming gradient strided (as cuDNN's
    channels-last permutations hand it over) and contiguous: the forward
    bit-equal in fp32, the gradients within the JAX package's tolerances
    (1e-5 fp32, as ``tests/test_pallas.py::test_scale_bias_add_relu_grad``;
    2e-2 bf16) of the largest magnitude. The backward against its plain
    version (``scale_bias_add_relu_backward``) on the same inputs: dx
    and dres bit-equal, dscale and dbias within those tolerances; two
    backward calls bit-equal. On the card, at the batch-32 shapes with a
    contiguous gradient, the backward's device time alone (flushed and
    warm), the plain backward's and autograd's through the plain chain,
    against its bound: g, out and x read, dx and dres written, over the
    memory rate (the backward never reads the residual). Returns the
    fp32 per-step sums (16 tails)."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    cuda = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(4)
    flush = torch.empty(64 << 20, device=dev) if cuda else None
    tot = collections.Counter(bwd_max_scaled_err=0.0)
    cases = [(s, k) for s, k in _tail_cases(rehearsal)] \
        + [(s, 0) for s in _RAGGED]
    for shape, count in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for strided in (True, False):
                c = shape[-1]
                rnd = lambda s: torch.randn(s, generator=g,  # noqa: E731
                                            device=dev)
                x, r = rnd(shape).to(dtype), rnd(shape).to(dtype)
                sc, bi = rnd((c,)) + 1.0, rnd((c,))
                grad = rnd((shape[0], c) + shape[1:3]).to(dtype) \
                    .permute(0, 2, 3, 1)
                if not strided:
                    grad = grad.contiguous()
                leaves = [t.clone().requires_grad_() for t in (x, sc, bi, r)]
                ref_leaves = [t.clone().requires_grad_()
                              for t in (x, sc, bi, r)]
                out = K.scale_bias_add_relu(*leaves)
                ref = K.scale_bias_add_relu_reference(*ref_leaves)
                # the plain backward on the kernel's ReLU branches: in
                # bf16 a sum within an ulp of zero lands on either side;
                # in fp32 no branch may differ
                mask = out.detach() > 0
                flips = int((mask != (ref.detach() > 0)).sum())
                masked = _masked_tail(*ref_leaves, mask)
                got = torch.autograd.grad(out, leaves, grad,
                                          retain_graph=True)
                again = torch.autograd.grad(out, leaves, grad,
                                            retain_graph=True)
                want = torch.autograd.grad(masked, ref_leaves, grad,
                                           retain_graph=True)
                o = out.detach()
                pdx, pds, pdb, pdr = K.scale_bias_add_relu_backward(
                    grad.contiguous(), x, sc, bi, o, True)
                if cuda:
                    torch.cuda.synchronize()
                tol = 1e-5 if dtype == torch.float32 else 2e-2
                fwd_equal = bool(torch.equal(out, ref))
                fwd_err = _scaled_err(out, ref)[1]
                errs = [_rel_to_max(a, w) for a, w in zip(got, want)]
                err = max(e for _, e in errs)
                plain_err = max(_rel_to_max(got[1], pds)[1],
                                _rel_to_max(got[2], pdb)[1])
                rec = {"kernel": "scale_bias_add_relu_backward",
                       "shape": list(shape), "dtype": str(dtype)[6:],
                       "grad_contiguous": grad.is_contiguous(),
                       "fwd_bit_equal": fwd_equal, "fwd_scaled_err": fwd_err,
                       "relu_branches_differing": flips,
                       "bwd_scaled_err": err,
                       "bwd_max_abs_err": max(a for a, _ in errs),
                       "dx_dres_bit_equal_plain": bool(
                           torch.equal(got[0], pdx)
                           and torch.equal(got[3], pdr)),
                       "dscale_dbias_scaled_err_plain": plain_err,
                       "two_calls_bit_equal": all(
                           torch.equal(a, b) for a, b in zip(got, again)),
                       "tol": tol}
                ok = err <= tol and flips <= 1e-3 * out.numel() and (
                    fwd_equal and flips == 0 if dtype == torch.float32
                    else fwd_err <= tol) and plain_err <= tol \
                    and rec["dx_dres_bit_equal_plain"] \
                    and rec["two_calls_bit_equal"]
                rec["match"] = bool(ok)
                if cuda and count and not strided:
                    gc_ = grad.contiguous()
                    bwd = lambda: torch.autograd.grad(  # noqa: E731
                        out, leaves, gc_, retain_graph=True)
                    plain = lambda: K.scale_bias_add_relu_backward(  # noqa
                        gc_, x, sc, bi, o, True)
                    chain = lambda: torch.autograd.grad(  # noqa: E731
                        masked, ref_leaves, gc_, retain_graph=True)
                    # g, out and x read, dx and dres written (the
                    # residual is not read); scale read, dscale and
                    # dbias written
                    nbytes = 5 * x.numel() * x.element_size() + 3 * c * 4
                    bound = nbytes / rate * 1e3
                    clean = _l2_flush(flush)
                    t = {"bwd_ms": _isolated_ms(bwd, before=clean),
                         "bwd_warm_ms": _isolated_ms(bwd),
                         "bwd_dirty_flush_ms": _isolated_ms(
                             bwd, before=flush.zero_),
                         "bwd_event_ms": time_cuda(bwd, iters=20),
                         "bwd_plain_ms": _isolated_ms(plain, before=clean),
                         "bwd_autograd_ms": _isolated_ms(
                             chain, before=clean),
                         "bwd_bound_ms": bound}
                    rec.update({k.replace("_ms", "_us"): v * 1e3
                                for k, v in t.items()})
                    rec.update({"bytes": nbytes, "tails_per_step": count,
                                "roofline_share": bound / t["bwd_ms"]})
                    if dtype == torch.float32:
                        for k, v in t.items():
                            tot[k] += count * v
                if dtype == torch.float32 and count:
                    tot["bwd_max_scaled_err"] = max(
                        tot["bwd_max_scaled_err"], err, plain_err)
                emit(rec)
                if not ok:
                    raise AssertionError("K1's backward disagrees with its "
                                         "plain version: %s" % rec)
                del leaves, ref_leaves, out, ref, masked, got, again, want
    return dict(tot)


def resnet_training_phase(mx, ctx, dev, rate, rehearsal):
    """Train ResNet-50 v1 at full width through the raw step of bench.py
    and through Module.fit; K1's backward against its plain version.
    Returns the K1 launches of the training legs and the backward's
    numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()                # what the earlier phases left behind
    if ctx.device_type == "gpu":
        torch.cuda.empty_cache()
    net, sym, hw, classes = _resnet_net(mx, ctx, rehearsal)
    launches = _raw_leg(mx, net, ctx, rehearsal, hw, classes)
    if ctx.device_type == "gpu":
        torch.cuda.empty_cache()
    launches += _module_leg(mx, net, sym, ctx, rehearsal, hw, classes)
    if ctx.device_type == "gpu":
        torch.cuda.empty_cache()
    mx.layout.set_default_layout(None)
    return launches, tail_backward_phase(dev, rate, rehearsal)


# README.md's Gluon loop (gluon.Trainer, sgd, lr 0.05, momentum 0.9)
_GLUON_LR, _GLUON_MOMENTUM = 0.05, 0.9


class _GluonRawStep:
    """PR 4's route on the Gluon loop's weights and batch, in fp32: the
    pure function of ``make_pure_fn(net, train=True)``, the mean of the
    softmax cross-entropy (what ``SoftmaxCrossEntropyLoss`` + ``backward``
    + ``Trainer.step(batch)`` differentiate), ``torch.autograd.grad`` and
    ``FusedUpdater.update_batch`` of the same SGD; BN running stats from
    the aux map."""

    def __init__(self, mx, net, x, y):
        from mxnet_tpu_torch.gluon.block import make_pure_fn
        self.fn, raw, _ = make_pure_fn(net, train=True)
        params = list(net.collect_params().values())
        self.live = [i for i, p in enumerate(params) if p.grad_req != "null"]
        self.w = [mx.nd.NDArray(r.detach().clone()) for r in raw]
        self.upd = mx.optimizer.get_updater(mx.optimizer.SGD(
            learning_rate=_GLUON_LR, momentum=_GLUON_MOMENTUM))
        self.NDArray = mx.nd.NDArray
        self.x, self.y = x, y

    def __call__(self):
        full = [w._data.detach().requires_grad_() for w in self.w]
        (logits,), aux = self.fn(full, [self.x])
        loss = -torch.log_softmax(logits, dim=-1).gather(
            1, self.y[:, None]).mean()
        grads = torch.autograd.grad(loss, [full[i] for i in self.live])
        self.upd.update_batch(self.live, [self.NDArray(g) for g in grads],
                              [self.w[i] for i in self.live])
        with torch.no_grad():
            for i, v in aux.items():
                self.w[i]._data.copy_(v)
        return loss.detach()


def _timed_steps(step, n, gpu):
    """``n`` calls of ``step``: (results, CUDA-event ms of each, host wall
    ms of each)."""
    out, ms, wall = [], [], []
    for _ in range(n):
        if gpu:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        out.append(step())
        if gpu:
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        wall.append((time.perf_counter() - t0) * 1e3)
    return out, ms, wall


def _gluon_leg(mx, net, init, X, Y, batch, hybridize, gpu, steps=5):
    """README.md:47-54 on the card: ``net.hybridize()`` (or not), then per
    step ``autograd.record`` → ``SoftmaxCrossEntropyLoss`` →
    ``backward`` → ``Trainer.step(batch)``, from the weights ``init``.
    Returns the record, step 1's parameters and the parameters after the
    last step."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    params = net.collect_params()
    with torch.no_grad():
        for k, p in params.items():
            p.data()._data.copy_(init[k])
    net.hybridize(hybridize)
    L = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tr = mx.gluon.Trainer(params, "sgd", {"learning_rate": _GLUON_LR,
                                          "momentum": _GLUON_MOMENTUM})

    def step():
        with mx.autograd.record():
            loss = L(net(X), Y)
        loss.backward()
        tr.step(batch)
        return loss.mean()

    peaks, held = [], []

    def tracked():
        if gpu:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        out = step()
        if gpu:
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            held.append(torch.cuda.memory_allocated())
        return float(out.asscalar())     # keep no device tensor across steps

    # -- the main path: counts zeroed just before, read just after --------
    K.launches = K.bwd_launches = 0
    first, ms1, wall1 = _timed_steps(tracked, 1, gpu)
    snap1 = _host_copy(params)
    rest, ms, wall = _timed_steps(tracked, steps - 1, gpu)
    launches, bwd = K.launches, K.bwd_launches
    # ---------------------------------------------------------------------
    losses = first + rest
    rec = {"leg": "gluon_hybridized" if hybridize else "gluon_eager",
           "steps": steps, "losses": losses, "k1_launches": launches,
           "k1_launches_expected": 16 * steps if gpu else 0,
           "k1_bwd_launches": bwd}
    if gpu:
        rec.update({"step1_ms": ms1[0], "step_ms": ms,
                    "step_ms_mean": float(np.mean(ms)),
                    "step_wall_ms": wall, "img_per_s":
                        batch / float(np.mean(ms)) * 1e3,
                    "peak_bytes_per_step": peaks,
                    "held_bytes_after_step": held,
                    "step_profile": profile_forward(step, reps=1)})
    last = _host_copy(params)
    net.hybridize(False)
    return rec, snap1, last


def _host_copy(params):
    """The parameters' values on the host (the comparisons hold no device
    memory across the legs, so their peaks compare)."""
    return {k: p.data()._data.to("cpu", copy=True)
            for k, p in params.items()}


def _max_scaled(a, b):
    """Largest |a - b| of any tensor over that tensor's largest |b|."""
    return max(float((a[k].float() - b[k].float()).abs().max())
               / max(float(b[k].float().abs().max()), 1e-30) for k in b)


def gluon_training_phase(mx, ctx, rehearsal):
    """Train ``resnet50_v1`` at full width through the Gluon loop of
    README.md, unhybridized then hybridized, from the same seeded weights
    on one fixed batch of 32 (fp32, TF32 off, cudnn deterministic), held
    step 1 against the raw step of PR 4 and each other. Returns the K1
    launches of both legs."""
    gpu = ctx.device_type == "gpu"
    dev = ctx.torch_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()
    net, _, hw, classes = _resnet_net(mx, ctx, rehearsal)
    batch = 4 if rehearsal else 32
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (batch, hw, hw, 3)).astype(np.float32)
    y = rs.randint(0, classes, batch)
    X, Y = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
    params = net.collect_params()
    init = {k: p.data()._data.clone() for k, p in params.items()}

    raw = _GluonRawStep(mx, net, X._data, torch.from_numpy(y).to(dev))
    raw_losses, raw_ms, raw_wall = _timed_steps(raw, 1, gpu)
    raw1 = dict(zip(params.keys(), (w._data.to("cpu", copy=True)
                                    for w in raw.w)))
    more, ms, wall = _timed_steps(raw, 4, gpu)
    raw_rec = {"leg": "raw_step_fp32", "batch": batch,
               "losses": [float(v) for v in raw_losses + more]}
    if gpu:
        raw_rec.update({"step_ms": ms, "step_ms_mean": float(np.mean(ms)),
                        "step_wall_ms": wall})
    emit({"gluon_training": raw_rec})
    del raw, more
    if gpu:
        torch.cuda.empty_cache()

    recs, launches = {}, 0
    for hybridize in (False, True):
        rec, snap1, last = _gluon_leg(mx, net, init, X, Y, batch, hybridize,
                                      gpu)
        snap1 = _max_scaled(snap1, raw1)
        rec.update({
            "model": "resnet_v1_small" if rehearsal else "resnet50_v1",
            "input": [hw, hw, 3], "classes": classes, "batch": batch,
            "precision": "fp32, TF32 off, cudnn deterministic",
            "lr": _GLUON_LR, "momentum": _GLUON_MOMENTUM,
            "step1_loss_rel_err_vs_raw":
                abs(rec["losses"][0] - raw_rec["losses"][0])
                / abs(raw_rec["losses"][0]),
            "step1_param_scaled_err_vs_raw": snap1})
        recs[hybridize] = (rec, last)
        launches += rec["k1_launches"]
        emit({"gluon_training": rec})
        assert all(np.isfinite(rec["losses"])), rec["losses"]
        assert rec["losses"][-1] < rec["losses"][0], rec["losses"]
        assert rec["k1_launches"] == rec["k1_launches_expected"], rec
        assert rec["k1_bwd_launches"] == rec["k1_launches_expected"], rec
        _K1_BWD["gluon_training"] += rec["k1_bwd_launches"]
        assert rec["step1_loss_rel_err_vs_raw"] <= 1e-5, rec
        assert rec["step1_param_scaled_err_vs_raw"] <= 1e-4, rec
        if gpu:
            # no growth: the tape frees its graph every step
            p = rec["peak_bytes_per_step"]
            assert p[4] <= p[1], ("peak memory grew from step 2 to 5", p)
            h = rec["held_bytes_after_step"]
            assert h[4] <= h[1], ("memory held grew from step 2 to 5", h)
    (e_rec, e_last), (h_rec, h_last) = recs[False], recs[True]
    cmp = {"hybridized_vs_eager_loss_max_rel": max(
        abs(a - b) / abs(b) for a, b in zip(h_rec["losses"],
                                            e_rec["losses"])),
        "hybridized_vs_eager_param_scaled": _max_scaled(h_last, e_last)}
    emit({"gluon_training": cmp})
    assert cmp["hybridized_vs_eager_loss_max_rel"] <= 1e-5, cmp
    assert cmp["hybridized_vs_eager_param_scaled"] <= 1e-4, cmp
    torch.backends.cudnn.deterministic = det
    mx.layout.set_default_layout(None)
    del net, raw1, init
    if gpu:
        torch.cuda.empty_cache()
    return launches


# bench.py:991-994, decode_child: the attention cell at the repo's full
# decode width, 16 slots, 4 waves of one 192-token and fifteen 16-token
# generations from 16-token prompts; the rehearsal takes bench.py's own
# smoke sizes (:985-988)
_DECODE = {False: (dict(vocab=8192, embed=512, heads=8, head_dim=64,
                        max_len=512), 16, 4, 16, 192, 16),
           True: (dict(vocab=256, embed=64, heads=8, head_dim=16,
                       max_len=64), 8, 4, 4, 32, 4)}
_DECODE_TOL = 1e-4      # card against CPU, of the largest |logit|


def _margin_cut(logits, tol):
    """First position whose top-2 logit margin is under ``tol`` (the
    length when there is none): from it on, rounding may pick the other
    token; logits rows up to it depend only on the tokens before it."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    small = np.nonzero(top2[:, 1] - top2[:, 0] < tol)[0]
    return int(small[0]) if small.size else len(logits)


def _against_cpu(mx, cell, params, prompts, got, **kw):
    """The same prompts recomputed by the port on the CPU: tokens equal up
    to the first thin top-2 margin, logits rows to it within
    ``_DECODE_TOL`` of the largest |logit|. Returns the error, the
    positions compared and the positions cut."""
    from mxnet_tpu_torch.decode import DecodeEngine
    with DecodeEngine(cell, params, slots=len(prompts), keep_logits=True,
                      ctx=mx.cpu(), **kw) as ce:
        want = [ce.generate(p) for p in prompts]
    worst, compared, cut_total = 0.0, 0, 0
    for g, w in zip(got, want):
        scale = float(np.abs(w.logits).max())
        cut = _margin_cut(w.logits, _DECODE_TOL * scale)
        assert g.tokens[:cut] == w.tokens[:cut], (g.tokens, w.tokens, cut)
        rows = min(cut + 1, len(w.logits))
        worst = max(worst, float(np.abs(g.logits[:rows] - w.logits[:rows])
                                 .max()) / scale)
        compared += cut
        cut_total += len(w.tokens) - cut
    assert worst <= _DECODE_TOL, worst
    return {"max_abs_err_over_max_logit": worst, "tol": _DECODE_TOL,
            "positions_compared": compared, "positions_cut": cut_total}


def _segments(gpu):
    return torch.cuda.memory_stats()["segment.all.allocated"] if gpu \
        else None


def _pcts(samples):
    a = np.asarray(samples, np.float64)
    return {"p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "p99_ms": float(np.percentile(a, 99))} if a.size else None


def decode_phase(mx, ctx, rehearsal):
    """bench.py's decode_child on the port: equivalence on the card and
    against the CPU, the static and continuous legs, a profile of one
    full-bucket step and one prefill, then bf16 and the LSTM cell."""
    from mxnet_tpu_torch.decode import (DecodeEngine, AttentionDecodeCell,
                                        LSTMDecodeCell)
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = ctx.device_type == "gpu"
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()
    dims, slots, waves, short, long_, prompt_len = _DECODE[rehearsal]
    cell = AttentionDecodeCell(**dims)
    params = cell.init_params(1)
    kw = dict(slots=slots, max_prompt_len=prompt_len * 2)
    check = [np.random.RandomState(1 + i).randint(
        1, cell.vocab - 1, prompt_len).astype(np.int32) for i in range(4)]

    # -- 1-2. equivalence: one at a time, then all at once, then the CPU --
    with DecodeEngine(cell, params, keep_logits=True, max_new_tokens=32,
                      ctx=ctx, **kw) as eq:
        serial = [eq.generate(p) for p in check]
        futs = [eq.submit(p) for p in check]
        batched = [f.result(timeout=600) for f in futs]
    for a, b in zip(serial, batched):
        assert a.tokens == b.tokens, (a.tokens, b.tokens)
    bucket_gap = max(float(np.abs(a.logits - b.logits).max()
                           / np.abs(a.logits).max())
                     for a, b in zip(serial, batched))
    emit({"decode_equivalence": {
        "prompts": len(check), "new_tokens": 32, "tf32": False,
        "serial_vs_batched_tokens_equal": True,
        "serial_vs_batched_max_abs_err_over_max_logit": bucket_gap,
        "cpu_recompute": _against_cpu(mx, cell, params, check, serial,
                                      max_new_tokens=32,
                                      max_prompt_len=prompt_len * 2)}})

    # -- 3. bench.py's two legs, counts read around them -------------------
    rng = np.random.RandomState(0)

    def prompt():
        return rng.randint(1, cell.vocab - 1, prompt_len).astype(np.int32)

    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = DecodeEngine(cell, params, max_new_tokens=long_, ctx=ctx, **kw)
    startup = time.perf_counter() - t0
    seg_warm = _segments(gpu)
    plan = [[(prompt(), long_ if s == 0 else short) for s in range(slots)]
            for _ in range(waves)]
    total = sum(n for wave in plan for _, n in wave)
    stream = sorted((seq for wave in plan for seq in wave),
                    key=lambda s: -s[1])
    legs, outs = {}, []
    for leg in ("static", "continuous"):
        # the engine's own latency samples, sliced to this leg
        n_tok, n_req = len(eng._tok_lat), len(eng._req_lat)
        steps0 = eng.stats()["steps"]
        t0 = time.perf_counter()
        if leg == "static":      # wave-synchronised
            for wave in plan:
                futs = [eng.submit(p, max_new_tokens=n) for p, n in wave]
                outs += [(f.result(timeout=600), n)
                         for f, (_, n) in zip(futs, wave)]
        else:                    # the same work, open-loop
            futs = [eng.submit(p, max_new_tokens=n) for p, n in stream]
            outs += [(f.result(timeout=600), n)
                     for f, (_, n) in zip(futs, stream)]
        dt = time.perf_counter() - t0
        legs[leg] = {"tok_per_s": total / dt, "seconds": dt,
                     "steps": eng.stats()["steps"] - steps0,
                     "token_latency_ms": _pcts(list(eng._tok_lat)[n_tok:]),
                     "request_latency_ms": _pcts(list(eng._req_lat)[n_req:])}
    seg_end = _segments(gpu)
    st = eng.stats()
    for res, n in outs:
        assert len(res.tokens) == n, (len(res.tokens), n)
        assert all(0 <= t < cell.vocab for t in res.tokens)
    emit({"decode": {
        "cell": dict(dims, dtype="float32"), "slots": slots,
        "waves": waves, "gen_short": short, "gen_long": long_,
        "prompt_len": prompt_len, "total_tokens": total,
        "engine_startup_s": startup, "kv_cache_bytes": eng.kv_cache_bytes(),
        "param_bytes": sum(t.nbytes for t in eng._params.values()),
        "static_tok_s": legs["static"]["tok_per_s"],
        "continuous_tok_s": legs["continuous"]["tok_per_s"],
        "decode_speedup": legs["continuous"]["tok_per_s"]
        / legs["static"]["tok_per_s"],
        "legs": legs,
        "stats": {k: st[k] for k in ("tokens", "steps", "slot_fill",
                                     "shed_requests", "retries",
                                     "dispatch_failures")},
        "max_memory_allocated": torch.cuda.max_memory_allocated()
        if gpu else None,
        "segments_after_warmup": seg_warm, "segments_after_legs": seg_end}})
    assert st["tokens"] == 2 * total and not st["shed_requests"], st
    assert seg_end == seg_warm, ("new allocator segments in steady state",
                                 seg_warm, seg_end)

    # -- 4. profile of one full-bucket decode step and one prefill ---------
    if gpu:
        ids = np.arange(slots, dtype=np.int32)
        ones = np.ones(slots, np.int32)
        pos = np.full(slots, prompt_len, np.int32)
        toks = np.ones(eng.prompt_bucket_for(prompt_len), np.int32)
        step = lambda: eng._decode_prog(eng._params, eng._cache, ids, ones,
                                        pos)[1].cpu()
        prefill = lambda: eng._prefill_prog(eng._params, eng._cache, 0,
                                            toks, prompt_len)[1].item()
        emit({"decode_profile": {"full_bucket_step": profile_forward(step),
                                 "prefill": profile_forward(prefill)}})
    eng.close()

    # -- 5. bf16, and the LSTM cell at the attention cell's widths --------
    bcell = AttentionDecodeCell(dtype="bfloat16", **dims)
    with DecodeEngine(bcell, bcell.init_params(1), keep_logits=True,
                      max_new_tokens=32, ctx=ctx, **kw) as be:
        bf = [f.result(timeout=600) for f in [be.submit(p) for p in check]]
    for r in bf:
        assert len(r.tokens) == 32 and np.isfinite(r.logits).all()
        assert all(0 <= t < bcell.vocab for t in r.tokens)
    lcell = LSTMDecodeCell(vocab=dims["vocab"], embed=dims["embed"],
                           hidden=dims["embed"], max_len=dims["max_len"])
    lparams = lcell.init_params(1)
    with DecodeEngine(lcell, lparams, keep_logits=True, max_new_tokens=32,
                      ctx=ctx, **kw) as le:
        t0 = time.perf_counter()
        lo = [f.result(timeout=600) for f in [le.submit(p) for p in check]]
        l_s = time.perf_counter() - t0
    emit({"decode_bf16": {"prompts": len(bf), "new_tokens": 32,
                          "tokens_in_range": True, "logits_finite": True},
          "decode_lstm": {
              "cell": {"vocab": lcell.vocab, "embed": lcell.embed,
                       "hidden": lcell.hidden, "max_len": lcell.max_len},
              "widths": "borrowed from the attention cell: no repo file "
                        "gives the LSTM a full-width configuration",
              "tok_per_s": 4 * 32 / l_s,
              "cpu_recompute": _against_cpu(mx, lcell, lparams, check, lo,
                                            max_new_tokens=32,
                                            max_prompt_len=prompt_len * 2)}})
    return legs


# The recurrent family. (a) The medium configuration of upstream MXNet's
# example/gluon/word_language_model (2 layers, emsize = nhid = 650,
# dropout 0.5, bptt 35, batch 32, PTB's 10,000 words) trained by
# examples/gluon/word_language_model/train.py's loop on synthetic tokens.
# (b) upstream example/rnn/bucketing/lstm_bucketing.py's widths (2 layers,
# num_hidden = num_embed = 200, batch 32, buckets 10..60, vocabulary
# 10,000) through examples/rnn/bucketing_lstm.py's BucketingModule.fit.
_WLM = {False: dict(vocab=10000, emsize=650, nhid=650, nlayers=2,
                    dropout=0.5, bptt=35, batch=32),
        True: dict(vocab=60, emsize=32, nhid=32, nlayers=2, dropout=0.5,
                   bptt=8, batch=8)}
_BUCKETING = {False: dict(vocab=10000, num_hidden=200, num_embed=200,
                          num_layers=2, batch=32,
                          buckets=[10, 20, 30, 40, 50, 60], sentences=1024),
              True: dict(vocab=50, num_hidden=16, num_embed=8, num_layers=2,
                         batch=4, buckets=[6, 9, 12], sentences=96)}
_RNN_LOSS_TOL, _RNN_PARAM_TOL = 1e-4, 1e-3     # step 1 against the CPU


def _word_lm(mx, cfg):
    """``examples/gluon/word_language_model/train.py``'s RNNModel (its
    states begin on the input's context); ``cfg["tied"]`` ties the
    decoder's weight to the embedding (``--tied``, emsize = nhid)."""
    gluon = mx.gluon

    class RNNModel(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = gluon.nn.Dropout(cfg["dropout"])
                self.encoder = gluon.nn.Embedding(cfg["vocab"], cfg["emsize"])
                self.rnn = gluon.rnn.LSTM(cfg["nhid"], cfg["nlayers"],
                                          dropout=cfg["dropout"],
                                          input_size=cfg["emsize"])
                # --tied: the decoder shares the embedding's parameters
                self.decoder = gluon.nn.Dense(
                    cfg["vocab"], in_units=cfg["nhid"],
                    params=self.encoder.params if cfg.get("tied") else None)
                self.hidden_dim = cfg["nhid"]

        def forward(self, inputs, hidden=None):
            emb = self.drop(self.encoder(inputs))
            if hidden is None:
                hidden = self.rnn.begin_state(batch_size=inputs.shape[1],
                                              ctx=inputs.context)
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            decoded = self.decoder(output.reshape((-1, self.hidden_dim)))
            return decoded, hidden

    with mx.name.NameManager():
        return RNNModel()


def _set_dropout(model, p, hybridize):
    """The model's two dropout rates (the Dropout blocks' and the LSTM's
    between its layers) set to ``p``; hybridize(...) drops cached graphs."""
    model.drop._rate = p
    model.rnn._dropout = p
    model.hybridize(hybridize)


class _WordLMSteps:
    """train.py's inner loop from a given start: per step, the next bptt
    chunk, ``detach()`` of the carried state, ``autograd.record`` →
    ``SoftmaxCrossEntropyLoss().sum()`` → ``backward`` →
    ``clip_global_norm(grads, 0.25 * batch)`` → ``Trainer.step(bptt)``."""

    def __init__(self, mx, model, tokens, cfg, ctx):
        self.mx, self.model, self.tokens, self.cfg = mx, model, tokens, cfg
        self.ctx = ctx
        self.trainer = mx.gluon.Trainer(
            model.collect_params(), "sgd",
            {"learning_rate": 1.0, "rescale_grad": 1.0 / cfg["batch"]})
        self.loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        self.grads = [p.grad() for p in model.collect_params().values()
                      if p.grad_req != "null"]
        self.hidden, self.i = None, 0

    def __call__(self):
        mx, bptt, batch = self.mx, self.cfg["bptt"], self.cfg["batch"]
        i = self.i
        self.i += bptt
        x = mx.nd.array(self.tokens[i:i + bptt], ctx=self.ctx)
        y = mx.nd.array(self.tokens[i + 1:i + 1 + bptt].reshape(-1),
                        ctx=self.ctx)
        if self.hidden is not None:
            self.hidden = [h.detach() for h in self.hidden]
        with mx.autograd.record():
            out, self.hidden = self.model(x, self.hidden)
            loss = self.loss_fn(out, y).sum()
        loss.backward()
        mx.gluon.utils.clip_global_norm(self.grads, 0.25 * batch)
        self.trainer.step(bptt)
        return float(loss.asnumpy()) / (bptt * batch)


def _load_params(model, values):
    with torch.no_grad():
        for k, p in model.collect_params().items():
            p.data()._data.copy_(values[k])


def _rnn_profile(fn):
    """``profile_forward`` of one call, with the count of ATen's fused-RNN
    ops it dispatched (one per LSTM layer: no loop over time steps)."""
    from torch.profiler import ProfilerActivity, profile
    rec = profile_forward(fn, reps=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rec["fused_rnn_ops"] = {e.key: e.count for e in prof.key_averages()
                            if e.key in ("aten::_cudnn_rnn", "aten::lstm",
                                         "aten::_cudnn_rnn_backward")}
    return rec


def _word_lm_leg(mx, ctx, rehearsal, card):
    """(a): the word LM on the card, dropout 0 step 1 against the CPU and
    hybridized against eager, then 5 eager and 5 hybridized steps at
    dropout 0.5 from the same start and seed."""
    gpu = ctx.device_type == "gpu"
    cfg = _WLM[rehearsal]
    model = _word_lm(mx, cfg)
    model.initialize(mx.init.Xavier(generator=torch.Generator().manual_seed(
        0)), ctx=ctx)
    params = model.collect_params()
    n_params = sum(p.data().size for p in params.values())
    init = _host_copy(params)
    tokens = np.random.RandomState(0).randint(
        0, cfg["vocab"], (cfg["bptt"] * 5 + 1, cfg["batch"])).astype(
            np.float32)
    rec = {"config": dict(cfg), "parameters": int(n_params),
           "precision": "fp32; torch.backends.cuda.matmul.allow_tf32 and "
                        "torch.backends.cudnn.allow_tf32 False; cudnn "
                        "deterministic", "card": card}

    # step 1 at dropout 0: eager, hybridized, and the CPU recompute
    firsts = {}
    for hyb in (False, True):
        _load_params(model, init)
        _set_dropout(model, 0.0, hyb)
        loss = _WordLMSteps(mx, model, tokens, cfg, ctx)()
        firsts[hyb] = (loss, _host_copy(params))
    cpu = _word_lm(mx, dict(cfg, dropout=0.0))
    cpu.initialize(ctx=mx.cpu())
    _load_params(cpu, init)
    cpu_loss = _WordLMSteps(mx, cpu, tokens, cfg, mx.cpu())()
    cpu_params = _host_copy(cpu.collect_params())
    del cpu
    (e_loss, e_par), (h_loss, h_par) = firsts[False], firsts[True]
    rec["step1_dropout0"] = {
        "loss": e_loss, "cpu_loss": cpu_loss,
        "loss_rel_err_vs_cpu": abs(e_loss - cpu_loss) / abs(cpu_loss),
        "param_scaled_err_vs_cpu": _max_scaled(e_par, cpu_params),
        "hybridized_loss": h_loss,
        "hybridized_vs_eager_loss_abs": abs(h_loss - e_loss),
        "hybridized_vs_eager_param_scaled": _max_scaled(h_par, e_par),
        "hybridized_bit_equal": h_loss == e_loss and all(
            torch.equal(h_par[k], e_par[k]) for k in e_par)}
    s1 = rec["step1_dropout0"]
    assert s1["loss_rel_err_vs_cpu"] <= _RNN_LOSS_TOL, s1
    assert s1["param_scaled_err_vs_cpu"] <= _RNN_PARAM_TOL, s1
    assert s1["hybridized_vs_eager_param_scaled"] <= 1e-5, s1
    del firsts, e_par, h_par, cpu_params

    # 5 eager then 5 hybridized steps at dropout 0.5, same start and seed
    legs = {}
    for hyb in (False, True):
        _load_params(model, init)
        _set_dropout(model, cfg["dropout"], hyb)
        mx.random.seed(1)
        steps = _WordLMSteps(mx, model, tokens, cfg, ctx)
        peaks = []

        def tracked():
            if gpu:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            out = steps()
            if gpu:
                torch.cuda.synchronize()
                peaks.append(torch.cuda.max_memory_allocated())
            return out

        losses, ms, wall = _timed_steps(tracked, 5, gpu)
        leg = {"leg": "hybridized" if hyb else "eager", "steps": 5,
               "dropout": cfg["dropout"], "losses": losses}
        if gpu:
            tok = cfg["bptt"] * cfg["batch"]
            leg.update({
                "step_ms": ms, "step_ms_mean_2_5": float(np.mean(ms[1:])),
                "step_wall_ms": wall,
                "tokens_per_s": tok / float(np.mean(ms[1:])) * 1e3,
                "peak_bytes_per_step": peaks})
            steps.i = 0                     # one more chunk, profiled
            leg["step_profile"] = _rnn_profile(steps)
        legs[hyb] = (leg, _host_copy(params))
        assert all(np.isfinite(losses)), losses
        if gpu:
            assert peaks[4] <= peaks[1], ("peak grew from step 2 to 5",
                                          peaks)
            fused = leg["step_profile"]["fused_rnn_ops"]
            assert fused.get("aten::_cudnn_rnn", 0) == cfg["nlayers"], fused
        rec[leg["leg"]] = leg
    if gpu:
        rec["rnn_op_vs_nn_lstm"] = _rnn_op_vs_library(cfg)
    (el, ep), (hl, hp) = legs[False], legs[True]
    rec["dropout_masks"] = {
        "hybridized_vs_eager_loss_max_abs": max(
            abs(a - b) for a, b in zip(hl["losses"], el["losses"])),
        "hybridized_vs_eager_param_scaled": _max_scaled(hp, ep),
        "masks_agree": hl["losses"] == el["losses"]}
    _set_dropout(model, cfg["dropout"], False)
    emit({"rnn_training": {"word_lm": rec}})
    return rec


def _tied_word_lm_leg(mx, ctx, rehearsal, card):
    """(c): upstream's ``--tied`` medium word LM (emsize = nhid = 650,
    vocab 10,000; one ``embedding0_weight`` serves the embedding and the
    decoder): step 1 at dropout 0 on the card against the CPU."""
    cfg = dict(_WLM[rehearsal], dropout=0.0, tied=True)
    model = _word_lm(mx, cfg)
    model.initialize(mx.init.Xavier(generator=torch.Generator().manual_seed(
        2)), ctx=ctx)
    params = model.collect_params()
    names = list(params.keys())
    tied = [k for k in names if k.endswith("embedding0_weight")]
    assert len(tied) == 1 and not [k for k in names if "dense" in k], names
    init = _host_copy(params)
    tokens = np.random.RandomState(2).randint(
        0, cfg["vocab"], (cfg["bptt"] + 1, cfg["batch"])).astype(np.float32)
    _set_dropout(model, 0.0, False)
    loss = _WordLMSteps(mx, model, tokens, cfg, ctx)()
    got = _host_copy(params)
    cpu = _word_lm(mx, cfg)
    cpu.initialize(ctx=mx.cpu())
    _load_params(cpu, init)
    cpu_loss = _WordLMSteps(mx, cpu, tokens, cfg, mx.cpu())()
    want = _host_copy(cpu.collect_params())
    rec = {"config": {k: v for k, v in cfg.items()}, "card": card,
           "parameters": int(sum(p.data().size for p in params.values())),
           "tied_parameter": tied[0],
           "step1_dropout0": {
               "loss": loss, "cpu_loss": cpu_loss,
               "loss_rel_err_vs_cpu": abs(loss - cpu_loss) / abs(cpu_loss),
               "param_scaled_err_vs_cpu": _max_scaled(got, want)}}
    emit({"rnn_training": {"tied_word_lm": rec}})
    s1 = rec["step1_dropout0"]
    assert s1["loss_rel_err_vs_cpu"] <= _RNN_LOSS_TOL, s1
    assert s1["param_scaled_err_vs_cpu"] <= _RNN_PARAM_TOL, s1
    return rec


def _rnn_op_vs_library(cfg):
    """The fused RNN op (forward + backward, the LM's two layers at its
    shape) against ``torch.nn.LSTM`` with its weights flattened into
    cuDNN's one buffer, on the same inputs and weights: the difference
    is what the op's per-layer views cost (ATen copies them into one
    buffer at each call). Device time from the profiler."""
    from mxnet_tpu_torch.ops.rnn import rnn, rnn_param_size
    T, N, E, H, L = (cfg["bptt"], cfg["batch"], cfg["emsize"], cfg["nhid"],
                     cfg["nlayers"])
    g = torch.Generator(device="cuda").manual_seed(3)
    dev = torch.device("cuda")
    x = torch.randn(T, N, E, generator=g, device=dev).requires_grad_()
    flat = (0.05 * torch.randn(rnn_param_size(E, H, L, "lstm"),
                               generator=g, device=dev)).requires_grad_()
    h0 = torch.zeros(L, N, H, device=dev)
    lib = torch.nn.LSTM(E, H, L).to(dev)
    with torch.no_grad():
        off = 0
        for layer in range(L):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                w = getattr(lib, "%s_l%d" % (name, layer))
                w.copy_(flat[off:off + w.numel()].view_as(w))
                off += w.numel()
    lib.flatten_parameters()

    def port():
        out = rnn(x, flat, h0, h0, state_size=H, num_layers=L,
                  mode="lstm", state_outputs=True)[0]
        out.sum().backward()
        return out

    def library():
        out = lib(x, (h0, h0))[0]
        out.sum().backward()
        return out

    err = float((port() - library()).abs().max())
    port_ms, _ = device_time(port, reps=10)
    lib_ms, _ = device_time(library, reps=10)
    port_ev, lib_ev = time_cuda(port, 10, 2), time_cuda(library, 10, 2)
    x.grad = flat.grad = None
    return {"shape": [T, N, E, H, L], "max_abs_err": err,
            "ms": port_ms, "library_ms": lib_ms, "event_ms": port_ev,
            "library_event_ms": lib_ev,
            "library_call": "torch.nn.LSTM (flattened weights), fwd+bwd"}


def _bucket_sentences(cfg, seed=0):
    """``examples/rnn/bucketing_lstm.py``'s ``synthetic_sentences`` (next
    token = token + 1 mod vocab), lengths 5 to the largest bucket."""
    rng = np.random.RandomState(seed)
    top = max(cfg["buckets"])
    out = []
    for _ in range(cfg["sentences"]):
        length = rng.randint(min(5, top - 1), top + 1)
        start = rng.randint(0, cfg["vocab"])
        out.append([(start + t) % cfg["vocab"] for t in range(length)])
    return out


def _bucket_sym_gen(mx, cfg):
    """``examples/rnn/bucketing_lstm.py``'s ``sym_gen``."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=cfg["vocab"],
                                 output_dim=cfg["num_embed"], name="embed")
        stack = mx.rnn.SequentialRNNCell()
        for i in range(cfg["num_layers"]):
            stack.add(mx.rnn.LSTMCell(num_hidden=cfg["num_hidden"],
                                      prefix="lstm_l%d_" % i))
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, cfg["num_hidden"]))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=cfg["vocab"],
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, use_ignore=True,
                                    ignore_label=-1, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _bucket_iter(mx, cfg):
    import random
    random.seed(1)
    np.random.seed(1)
    return mx.rnn.BucketSentenceIter(_bucket_sentences(cfg), cfg["batch"],
                                     buckets=list(cfg["buckets"]))


def _bucket_module(mx, cfg, ctx, it, init):
    mod = mx.mod.BucketingModule(_bucket_sym_gen(mx, cfg),
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=init, aux_params={})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.01,
                                         "rescale_grad": 1.0 / cfg["batch"]})
    return mod


def _bucketing_fit(mx, cfg, ctx, init, fused, epochs=3):
    """``fit`` over three passes of the data: per batch, the CUDA-event
    and host ms by bucket length (a bucket's first batch, which binds its
    module, apart; the rest from the last pass); the state after batch 1
    (parameters, batch, its Perplexity); the peak of each pass. The
    first pass binds the modules one by one, so a bucket's batch may run
    there before the others' arrays exist: the second pass is the first
    whose every batch runs with all six bound, and the third must not
    peak above it."""
    import random
    gpu = ctx.device_type == "gpu"
    os.environ["MXNET_MODULE_FUSED_STEP"] = "1" if fused else "0"
    it = _bucket_iter(mx, cfg)
    mod = _bucket_module(mx, cfg, ctx, it, init)
    seen, first, marks, peaks = set(), {}, [], []
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def mark():
        ev = None
        if gpu:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        return ev, time.perf_counter()

    def on_batch(param):
        batch = param.locals["data_batch"]
        marks.append((param.epoch, batch.bucket_key) + mark())
        seen.add(batch.bucket_key)
        if param.epoch == 0 and param.nbatch == 0:
            met = mx.metric.Perplexity(ignore_label=-1)
            met.update(batch.label, mod.get_outputs())
            first.update(batch=batch, ppl=met.get()[1],
                         params=_host_copy_dict(mod.get_params()[0]))

    def on_epoch(*_):
        if gpu:
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

    random.seed(2)
    np.random.seed(2)
    met = mx.metric.Perplexity(ignore_label=-1)
    start = mark()
    mod.fit(it, eval_metric=met, num_epoch=epochs,
            batch_end_callback=on_batch, epoch_end_callback=on_epoch)
    if gpu:
        torch.cuda.synchronize()
    os.environ.pop("MXNET_MODULE_FUSED_STEP")
    first_ms, by_len, prev = {}, collections.defaultdict(list), start
    for epoch, key, ev, t in marks:
        dev_ms = prev[0].elapsed_time(ev) if ev is not None else None
        if key not in first_ms:
            first_ms[key] = dev_ms
        elif epoch == epochs - 1:
            by_len[key].append((dev_ms, (t - prev[1]) * 1e3))
        prev = (ev, t)
    params = _host_copy_dict(mod.get_params()[0])
    res = {"route": "fused" if fused else "phase_split", "epochs": epochs,
           "batches": len(marks),
           "batches_per_pass": len(marks) // epochs,
           "fit_perplexity_last_pass": met.get()[1],
           "bound_modules": len(mod._buckets),
           "bucket_switches": mod.bucket_switches,
           "param_copies": mod.param_copies,
           "param_copies_per_switch": mod.param_copies
           / max(mod.bucket_switches, 1),
           "buckets_seen": sorted(seen)}
    if gpu:
        res.update({
            "first_batch_ms_by_len": dict(sorted(first_ms.items())),
            "ms_per_batch_by_len": {k: float(np.mean([m for m, _ in v]))
                                    for k, v in sorted(by_len.items())},
            "host_ms_per_batch_by_len": {
                k: float(np.mean([w for _, w in v]))
                for k, v in sorted(by_len.items())},
            "batches_by_len_last_pass": {k: len(v) for k, v in
                                         sorted(by_len.items())},
            "peak_bytes_per_pass": peaks})
    it.reset()
    res["score_perplexity"] = dict(mod.score(
        it, mx.metric.Perplexity(ignore_label=-1)))["perplexity"]
    if gpu and fused:
        # one more fused step of the longest bucket, profiled
        top = max(cfg["buckets"])
        it.reset()
        batch = next(b for b in it if b.bucket_key == top)
        res["profile_len_%d" % top] = profile_forward(
            lambda: mod._fused_batch_step(batch), reps=1)
    return res, first, params


def _host_copy_dict(arrays):
    return {k: v._data.to("cpu", copy=True) for k, v in arrays.items()}


def _bucketing_leg(mx, ctx, rehearsal, card):
    """(b): BucketingModule.fit, fused then phase-split on the same
    batches from the same weights, batch 1 against the CPU."""
    cfg = _BUCKETING[rehearsal]
    it = _bucket_iter(mx, cfg)
    sym, _, _ = _bucket_sym_gen(mx, cfg)(it.default_bucket_key)
    shapes, _, _ = sym.infer_shape(data=it.provide_data[0].shape,
                                   softmax_label=it.provide_label[0].shape)
    init_fn = mx.init.Xavier(generator=torch.Generator().manual_seed(0))
    init = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        arr = mx.nd.zeros(shape, ctx=mx.cpu())
        init_fn(mx.init.InitDesc(name), arr)
        init[name] = arr.asnumpy()
    fused, first, fused_params = _bucketing_fit(mx, cfg, ctx, init, True)
    split, _, split_params = _bucketing_fit(mx, cfg, ctx, init, False)
    # batch 1 recomputed on the CPU: the same bucket's module, the same
    # weights, batch and Adam step
    batch = first["batch"]
    cpu_mod = mx.mod.Module(*_bucket_sym_gen(mx, cfg)(batch.bucket_key),
                            context=mx.cpu())
    cpu_mod.bind(batch.provide_data, batch.provide_label)
    cpu_mod.init_params(arg_params=init, aux_params={})
    cpu_mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 0.01,
                                             "rescale_grad":
                                                 1.0 / cfg["batch"]})
    cpu_met = mx.metric.Perplexity(ignore_label=-1)
    cpu_mod.forward_backward(batch)
    cpu_mod.update()
    cpu_met.update(batch.label, cpu_mod.get_outputs())
    cpu_params = _host_copy_dict(cpu_mod.get_params()[0])
    rec = {"config": {k: v for k, v in cfg.items()}, "card": card,
           "precision": "fp32; both TF32 flags False; cudnn deterministic",
           "fused": fused, "phase_split": split,
           "fused_vs_phase_split_bit_equal":
               fused["fit_perplexity_last_pass"]
               == split["fit_perplexity_last_pass"]
               and all(torch.equal(fused_params[k], split_params[k])
                       for k in fused_params),
           "batch1": {"bucket": batch.bucket_key, "perplexity": first["ppl"],
                      "cpu_perplexity": cpu_met.get()[1],
                      "ppl_rel_err_vs_cpu": abs(first["ppl"]
                                                - cpu_met.get()[1])
                      / cpu_met.get()[1],
                      "param_scaled_err_vs_cpu": _max_scaled(
                          first["params"], cpu_params)}}
    emit({"rnn_training": {"bucketing": rec}})
    b1 = rec["batch1"]
    assert b1["ppl_rel_err_vs_cpu"] <= _RNN_LOSS_TOL, b1
    assert b1["param_scaled_err_vs_cpu"] <= _RNN_PARAM_TOL, b1
    assert rec["fused_vs_phase_split_bit_equal"], rec
    for leg in (fused, split):
        assert leg["bound_modules"] == len(cfg["buckets"]), leg
        assert leg["buckets_seen"] == sorted(cfg["buckets"]), leg
        assert leg["batches_per_pass"] >= (24 if not rehearsal else 6), leg
        assert np.isfinite(leg["fit_perplexity_last_pass"]), leg
        assert leg["score_perplexity"] < cfg["vocab"], leg
        if "peak_bytes_per_pass" in leg:
            p = leg["peak_bytes_per_pass"]
            assert p[2] <= p[1], ("peak grew from pass 2 to 3", p)
    return rec


# ---------------------------------------------------------------------------
# The image-classification symbols: copies of
# examples/image-classification/symbols/*.py (each whole file, body
# unchanged), each wrapped in a function of the package ``mx`` that
# returns the file's ``get_symbol``
# ---------------------------------------------------------------------------


def _ic_mlp(mx):
    """examples/image-classification/symbols/mlp.py:1-13, whole."""
    def get_symbol(num_classes=10, **kwargs):
        data = mx.sym.Variable("data")
        data = mx.sym.Flatten(data=data)
        fc1 = mx.sym.FullyConnected(data=data, name="fc1", num_hidden=128)
        act1 = mx.sym.Activation(data=fc1, name="relu1", act_type="relu")
        fc2 = mx.sym.FullyConnected(data=act1, name="fc2", num_hidden=64)
        act2 = mx.sym.Activation(data=fc2, name="relu2", act_type="relu")
        fc3 = mx.sym.FullyConnected(data=act2, name="fc3", num_hidden=num_classes)
        return mx.sym.SoftmaxOutput(data=fc3, name="softmax")
    return get_symbol


def _ic_lenet(mx):
    """examples/image-classification/symbols/lenet.py:1-19, whole."""
    def get_symbol(num_classes=10, **kwargs):
        data = mx.sym.Variable("data")
        conv1 = mx.sym.Convolution(data=data, kernel=(5, 5), num_filter=20)
        tanh1 = mx.sym.Activation(data=conv1, act_type="tanh")
        pool1 = mx.sym.Pooling(data=tanh1, pool_type="max", kernel=(2, 2),
                               stride=(2, 2))
        conv2 = mx.sym.Convolution(data=pool1, kernel=(5, 5), num_filter=50)
        tanh2 = mx.sym.Activation(data=conv2, act_type="tanh")
        pool2 = mx.sym.Pooling(data=tanh2, pool_type="max", kernel=(2, 2),
                               stride=(2, 2))
        flatten = mx.sym.Flatten(data=pool2)
        fc1 = mx.sym.FullyConnected(data=flatten, num_hidden=500)
        tanh3 = mx.sym.Activation(data=fc1, act_type="tanh")
        fc2 = mx.sym.FullyConnected(data=tanh3, num_hidden=num_classes)
        return mx.sym.SoftmaxOutput(data=fc2, name="softmax")
    return get_symbol


def _ic_alexnet(mx):
    """examples/image-classification/symbols/alexnet.py:1-38, whole."""
    def get_symbol(num_classes=1000, **kwargs):
        data = mx.sym.Variable("data")
        conv1 = mx.sym.Convolution(data=data, kernel=(11, 11), stride=(4, 4),
                                   num_filter=96)
        relu1 = mx.sym.Activation(data=conv1, act_type="relu")
        lrn1 = mx.sym.LRN(data=relu1, alpha=0.0001, beta=0.75, knorm=2, nsize=5)
        pool1 = mx.sym.Pooling(data=lrn1, kernel=(3, 3), stride=(2, 2),
                               pool_type="max")
        conv2 = mx.sym.Convolution(data=pool1, kernel=(5, 5), pad=(2, 2),
                                   num_filter=256)
        relu2 = mx.sym.Activation(data=conv2, act_type="relu")
        lrn2 = mx.sym.LRN(data=relu2, alpha=0.0001, beta=0.75, knorm=2, nsize=5)
        pool2 = mx.sym.Pooling(data=lrn2, kernel=(3, 3), stride=(2, 2),
                               pool_type="max")
        conv3 = mx.sym.Convolution(data=pool2, kernel=(3, 3), pad=(1, 1),
                                   num_filter=384)
        relu3 = mx.sym.Activation(data=conv3, act_type="relu")
        conv4 = mx.sym.Convolution(data=relu3, kernel=(3, 3), pad=(1, 1),
                                   num_filter=384)
        relu4 = mx.sym.Activation(data=conv4, act_type="relu")
        conv5 = mx.sym.Convolution(data=relu4, kernel=(3, 3), pad=(1, 1),
                                   num_filter=256)
        relu5 = mx.sym.Activation(data=conv5, act_type="relu")
        pool3 = mx.sym.Pooling(data=relu5, kernel=(3, 3), stride=(2, 2),
                               pool_type="max")
        flatten = mx.sym.Flatten(data=pool3)
        fc1 = mx.sym.FullyConnected(data=flatten, num_hidden=4096)
        relu6 = mx.sym.Activation(data=fc1, act_type="relu")
        drop1 = mx.sym.Dropout(data=relu6, p=0.5)
        fc2 = mx.sym.FullyConnected(data=drop1, num_hidden=4096)
        relu7 = mx.sym.Activation(data=fc2, act_type="relu")
        drop2 = mx.sym.Dropout(data=relu7, p=0.5)
        fc3 = mx.sym.FullyConnected(data=drop2, num_hidden=num_classes)
        return mx.sym.SoftmaxOutput(data=fc3, name="softmax")
    return get_symbol


def _ic_resnet(mx):
    """examples/image-classification/symbols/resnet.py:1-85, whole."""
    def residual_unit(data, num_filter, stride, dim_match, name,
                      bottle_neck=True):
        if bottle_neck:
            body = mx.sym.Convolution(data=data, num_filter=num_filter // 4,
                                      kernel=(1, 1), stride=stride, no_bias=True,
                                      name=name + "_conv1")
            body = mx.sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                                    momentum=0.9, name=name + "_bn1")
            body = mx.sym.Activation(data=body, act_type="relu")
            body = mx.sym.Convolution(data=body, num_filter=num_filter // 4,
                                      kernel=(3, 3), pad=(1, 1), no_bias=True,
                                      name=name + "_conv2")
            body = mx.sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                                    momentum=0.9, name=name + "_bn2")
            body = mx.sym.Activation(data=body, act_type="relu")
            body = mx.sym.Convolution(data=body, num_filter=num_filter,
                                      kernel=(1, 1), no_bias=True,
                                      name=name + "_conv3")
            body = mx.sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                                    momentum=0.9, name=name + "_bn3")
        else:
            body = mx.sym.Convolution(data=data, num_filter=num_filter,
                                      kernel=(3, 3), stride=stride, pad=(1, 1),
                                      no_bias=True, name=name + "_conv1")
            body = mx.sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                                    momentum=0.9, name=name + "_bn1")
            body = mx.sym.Activation(data=body, act_type="relu")
            body = mx.sym.Convolution(data=body, num_filter=num_filter,
                                      kernel=(3, 3), pad=(1, 1), no_bias=True,
                                      name=name + "_conv2")
            body = mx.sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                                    momentum=0.9, name=name + "_bn2")
        if dim_match:
            shortcut = data
        else:
            shortcut = mx.sym.Convolution(data=data, num_filter=num_filter,
                                          kernel=(1, 1), stride=stride,
                                          no_bias=True, name=name + "_sc")
            shortcut = mx.sym.BatchNorm(data=shortcut, fix_gamma=False, eps=2e-5,
                                        momentum=0.9, name=name + "_sc_bn")
        return mx.sym.Activation(data=body + shortcut, act_type="relu")


    def get_symbol(num_classes=1000, num_layers=18, image_shape="3,224,224",
                   **kwargs):
        configs = {
            18: ([2, 2, 2, 2], False),
            34: ([3, 4, 6, 3], False),
            50: ([3, 4, 6, 3], True),
            101: ([3, 4, 23, 3], True),
            152: ([3, 8, 36, 3], True),
        }
        units, bottle_neck = configs[num_layers]
        filter_list = [256, 512, 1024, 2048] if bottle_neck \
            else [64, 128, 256, 512]

        data = mx.sym.Variable("data")
        body = mx.sym.Convolution(data=data, num_filter=64, kernel=(7, 7),
                                  stride=(2, 2), pad=(3, 3), no_bias=True,
                                  name="conv0")
        body = mx.sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                                momentum=0.9, name="bn0")
        body = mx.sym.Activation(data=body, act_type="relu")
        body = mx.sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                              pad=(1, 1), pool_type="max")

        for i, (n_units, n_filter) in enumerate(zip(units, filter_list)):
            stride = (1, 1) if i == 0 else (2, 2)
            body = residual_unit(body, n_filter, stride, False,
                                 "stage%d_unit1" % (i + 1), bottle_neck)
            for j in range(n_units - 1):
                body = residual_unit(body, n_filter, (1, 1), True,
                                     "stage%d_unit%d" % (i + 1, j + 2),
                                     bottle_neck)

        pool = mx.sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                              pool_type="avg")
        flat = mx.sym.Flatten(data=pool)
        fc1 = mx.sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
        return mx.sym.SoftmaxOutput(data=fc1, name="softmax")
    return get_symbol


def _ic_vgg(mx):
    """examples/image-classification/symbols/vgg.py:1-37, whole."""
    # layers-per-stage for each supported depth (VGG paper table 1)
    CONFIGS = {
        11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
        13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
        16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
        19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
    }


    def get_symbol(num_classes, num_layers=16, batch_norm=False, **kwargs):
        if num_layers not in CONFIGS:
            raise ValueError("vgg depth must be one of %s" % list(CONFIGS))
        layers, filters = CONFIGS[num_layers]
        net = mx.sym.Variable("data")
        for stage, (n, f) in enumerate(zip(layers, filters)):
            for i in range(n):
                net = mx.sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                                         num_filter=f,
                                         name="conv%d_%d" % (stage + 1, i + 1))
                if batch_norm:
                    net = mx.sym.BatchNorm(net,
                                           name="bn%d_%d" % (stage + 1, i + 1))
                net = mx.sym.Activation(net, act_type="relu")
            net = mx.sym.Pooling(net, pool_type="max", kernel=(2, 2),
                                 stride=(2, 2), name="pool%d" % (stage + 1))
        net = mx.sym.Flatten(net)
        for i, hidden in enumerate((4096, 4096)):
            net = mx.sym.FullyConnected(net, num_hidden=hidden,
                                        name="fc%d" % (6 + i))
            net = mx.sym.Activation(net, act_type="relu")
            net = mx.sym.Dropout(net, p=0.5)
        net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc8")
        return mx.sym.SoftmaxOutput(net, name="softmax")
    return get_symbol


def _ic_googlenet(mx):
    """examples/image-classification/symbols/googlenet.py:1-52, whole."""
    def conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
        c = mx.sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                               stride=stride, pad=pad, name="conv_%s" % name)
        return mx.sym.Activation(c, act_type="relu", name="relu_%s" % name)


    def inception(data, f1, f3r, f3, f5r, f5, proj, name):
        b1 = conv(data, f1, (1, 1), name="%s_1x1" % name)
        b3 = conv(data, f3r, (1, 1), name="%s_3x3r" % name)
        b3 = conv(b3, f3, (3, 3), pad=(1, 1), name="%s_3x3" % name)
        b5 = conv(data, f5r, (1, 1), name="%s_5x5r" % name)
        b5 = conv(b5, f5, (5, 5), pad=(2, 2), name="%s_5x5" % name)
        bp = mx.sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                            pool_type="max", name="%s_pool" % name)
        bp = conv(bp, proj, (1, 1), name="%s_proj" % name)
        return mx.sym.Concat(b1, b3, b5, bp, name="%s_concat" % name)


    def get_symbol(num_classes, **kwargs):
        data = mx.sym.Variable("data")
        net = conv(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="stem1")
        net = mx.sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                             pool_type="max")
        net = conv(net, 64, (1, 1), name="stem2r")
        net = conv(net, 192, (3, 3), pad=(1, 1), name="stem2")
        net = mx.sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                             pool_type="max")
        net = inception(net, 64, 96, 128, 16, 32, 32, "3a")
        net = inception(net, 128, 128, 192, 32, 96, 64, "3b")
        net = mx.sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                             pool_type="max")
        net = inception(net, 192, 96, 208, 16, 48, 64, "4a")
        net = inception(net, 160, 112, 224, 24, 64, 64, "4b")
        net = inception(net, 128, 128, 256, 24, 64, 64, "4c")
        net = inception(net, 112, 144, 288, 32, 64, 64, "4d")
        net = inception(net, 256, 160, 320, 32, 128, 128, "4e")
        net = mx.sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                             pool_type="max")
        net = inception(net, 256, 160, 320, 32, 128, 128, "5a")
        net = inception(net, 384, 192, 384, 48, 128, 128, "5b")
        net = mx.sym.Pooling(net, kernel=(7, 7), stride=(1, 1),
                             pool_type="avg", global_pool=True)
        net = mx.sym.Flatten(net)
        net = mx.sym.Dropout(net, p=0.4)
        net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc")
        return mx.sym.SoftmaxOutput(net, name="softmax")
    return get_symbol


def _ic_mobilenet(mx):
    """examples/image-classification/symbols/mobilenet.py:1-38, whole."""
    def conv_bn(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                num_group=1, name=None):
        c = mx.sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                               stride=stride, pad=pad, num_group=num_group,
                               no_bias=True, name="%s_conv" % name)
        c = mx.sym.BatchNorm(c, fix_gamma=False, name="%s_bn" % name)
        return mx.sym.Activation(c, act_type="relu", name="%s_relu" % name)


    def dw_sep(data, in_ch, out_ch, stride, name):
        """depthwise 3x3 (groups == channels) then pointwise 1x1"""
        dw = conv_bn(data, in_ch, (3, 3), stride=stride, pad=(1, 1),
                     num_group=in_ch, name="%s_dw" % name)
        return conv_bn(dw, out_ch, (1, 1), name="%s_pw" % name)


    def get_symbol(num_classes, alpha=1.0, **kwargs):
        def ch(n):
            return max(8, int(n * alpha))
        data = mx.sym.Variable("data")
        net = conv_bn(data, ch(32), (3, 3), stride=(2, 2), pad=(1, 1),
                      name="stem")
        plan = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
                (256, 256, 1), (256, 512, 2)] \
            + [(512, 512, 1)] * 5 + [(512, 1024, 2), (1024, 1024, 1)]
        for i, (cin, cout, s) in enumerate(plan):
            net = dw_sep(net, ch(cin), ch(cout), (s, s), "sep%d" % i)
        net = mx.sym.Pooling(net, kernel=(7, 7), pool_type="avg",
                             global_pool=True)
        net = mx.sym.Flatten(net)
        net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc")
        return mx.sym.SoftmaxOutput(net, name="softmax")
    return get_symbol


def _ic_resnext(mx):
    """examples/image-classification/symbols/resnext.py:1-64, whole."""
    def resnext_unit(data, num_filter, stride, dim_match, num_group, name):
        mid = num_filter // 2
        body = mx.sym.Convolution(data, num_filter=mid, kernel=(1, 1),
                                  no_bias=True, name=name + "_conv1")
        body = mx.sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                                name=name + "_bn1")
        body = mx.sym.Activation(body, act_type="relu")
        body = mx.sym.Convolution(body, num_filter=mid, kernel=(3, 3),
                                  stride=stride, pad=(1, 1),
                                  num_group=num_group, no_bias=True,
                                  name=name + "_conv2")
        body = mx.sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                                name=name + "_bn2")
        body = mx.sym.Activation(body, act_type="relu")
        body = mx.sym.Convolution(body, num_filter=num_filter, kernel=(1, 1),
                                  no_bias=True, name=name + "_conv3")
        body = mx.sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                                name=name + "_bn3")
        if dim_match:
            shortcut = data
        else:
            shortcut = mx.sym.Convolution(data, num_filter=num_filter,
                                          kernel=(1, 1), stride=stride,
                                          no_bias=True, name=name + "_sc")
            shortcut = mx.sym.BatchNorm(shortcut, fix_gamma=False, eps=2e-5,
                                        name=name + "_sc_bn")
        return mx.sym.Activation(body + shortcut, act_type="relu")


    # depth -> units per stage (same table as resnet bottleneck depths)
    UNITS = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


    def get_symbol(num_classes, num_layers=50, num_group=32, **kwargs):
        if num_layers not in UNITS:
            raise ValueError("resnext depth must be one of %s" % list(UNITS))
        units = UNITS[num_layers]
        filters = [256, 512, 1024, 2048]
        data = mx.sym.Variable("data")
        net = mx.sym.Convolution(data, num_filter=64, kernel=(7, 7),
                                 stride=(2, 2), pad=(3, 3), no_bias=True,
                                 name="conv0")
        net = mx.sym.BatchNorm(net, fix_gamma=False, eps=2e-5, name="bn0")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                             pool_type="max")
        for stage, (n, f) in enumerate(zip(units, filters)):
            stride = (1, 1) if stage == 0 else (2, 2)
            net = resnext_unit(net, f, stride, False, num_group,
                               "stage%d_unit0" % stage)
            for i in range(1, n):
                net = resnext_unit(net, f, (1, 1), True, num_group,
                                   "stage%d_unit%d" % (stage, i))
        net = mx.sym.Pooling(net, kernel=(7, 7), pool_type="avg",
                             global_pool=True)
        net = mx.sym.Flatten(net)
        net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc")
        return mx.sym.SoftmaxOutput(net, name="softmax")
    return get_symbol


def _ic_inception_bn(mx):
    """examples/image-classification/symbols/inception_bn.py:1-66, whole."""
    def conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
        c = mx.sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                               stride=stride, pad=pad, no_bias=True,
                               name="%s_conv" % name)
        c = mx.sym.BatchNorm(c, fix_gamma=False, name="%s_bn" % name)
        return mx.sym.Activation(c, act_type="relu", name="%s_relu" % name)


    def inception(data, f1, f3r, f3, fd3r, fd3, proj, pool, name):
        b1 = conv(data, f1, (1, 1), name="%s_1x1" % name)
        b3 = conv(data, f3r, (1, 1), name="%s_3x3r" % name)
        b3 = conv(b3, f3, (3, 3), pad=(1, 1), name="%s_3x3" % name)
        bd = conv(data, fd3r, (1, 1), name="%s_d3x3r" % name)
        bd = conv(bd, fd3, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
        bd = conv(bd, fd3, (3, 3), pad=(1, 1), name="%s_d3x3b" % name)
        bp = mx.sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                            pool_type=pool, name="%s_pool" % name)
        bp = conv(bp, proj, (1, 1), name="%s_proj" % name)
        return mx.sym.Concat(b1, b3, bd, bp, name="%s_concat" % name)


    def inception_down(data, f3r, f3, fd3r, fd3, name):
        """stride-2 module: no 1x1 branch, pool passes through un-projected"""
        b3 = conv(data, f3r, (1, 1), name="%s_3x3r" % name)
        b3 = conv(b3, f3, (3, 3), stride=(2, 2), pad=(1, 1),
                  name="%s_3x3" % name)
        bd = conv(data, fd3r, (1, 1), name="%s_d3x3r" % name)
        bd = conv(bd, fd3, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
        bd = conv(bd, fd3, (3, 3), stride=(2, 2), pad=(1, 1),
                  name="%s_d3x3b" % name)
        bp = mx.sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                            pool_type="max", name="%s_pool" % name)
        return mx.sym.Concat(b3, bd, bp, name="%s_concat" % name)


    def get_symbol(num_classes, **kwargs):
        data = mx.sym.Variable("data")
        net = conv(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="stem1")
        net = mx.sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                             pool_type="max")
        net = conv(net, 64, (1, 1), name="stem2r")
        net = conv(net, 192, (3, 3), pad=(1, 1), name="stem2")
        net = mx.sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                             pool_type="max")
        net = inception(net, 64, 64, 64, 64, 96, 32, "avg", "3a")
        net = inception(net, 64, 64, 96, 64, 96, 64, "avg", "3b")
        net = inception_down(net, 128, 160, 64, 96, "3c")
        net = inception(net, 224, 64, 96, 96, 128, 128, "avg", "4a")
        net = inception(net, 192, 96, 128, 96, 128, 128, "avg", "4b")
        net = inception(net, 160, 128, 160, 128, 160, 128, "avg", "4c")
        net = inception(net, 96, 128, 192, 160, 192, 128, "avg", "4d")
        net = inception_down(net, 128, 192, 192, 256, "4e")
        net = inception(net, 352, 192, 320, 160, 224, 128, "avg", "5a")
        net = inception(net, 352, 192, 320, 192, 224, 128, "max", "5b")
        net = mx.sym.Pooling(net, kernel=(7, 7), pool_type="avg",
                             global_pool=True)
        net = mx.sym.Flatten(net)
        net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc")
        return mx.sym.SoftmaxOutput(net, name="softmax")
    return get_symbol


def _ic_inception_v3(mx):
    """examples/image-classification/symbols/inception_v3.py:1-108, whole."""
    def conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
        c = mx.sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                               stride=stride, pad=pad, no_bias=True,
                               name="%s_conv" % name)
        c = mx.sym.BatchNorm(c, fix_gamma=True, eps=0.001, name="%s_bn" % name)
        return mx.sym.Activation(c, act_type="relu", name="%s_relu" % name)


    def inc_a(data, proj, name):
        b1 = conv(data, 64, (1, 1), name="%s_1x1" % name)
        b5 = conv(data, 48, (1, 1), name="%s_5x5r" % name)
        b5 = conv(b5, 64, (5, 5), pad=(2, 2), name="%s_5x5" % name)
        b3 = conv(data, 64, (1, 1), name="%s_3x3r" % name)
        b3 = conv(b3, 96, (3, 3), pad=(1, 1), name="%s_3x3a" % name)
        b3 = conv(b3, 96, (3, 3), pad=(1, 1), name="%s_3x3b" % name)
        bp = mx.sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                            pool_type="avg")
        bp = conv(bp, proj, (1, 1), name="%s_proj" % name)
        return mx.sym.Concat(b1, b5, b3, bp)


    def red_a(data, name):
        b3 = conv(data, 384, (3, 3), stride=(2, 2), name="%s_3x3" % name)
        bd = conv(data, 64, (1, 1), name="%s_d3x3r" % name)
        bd = conv(bd, 96, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
        bd = conv(bd, 96, (3, 3), stride=(2, 2), name="%s_d3x3b" % name)
        bp = mx.sym.Pooling(data, kernel=(3, 3), stride=(2, 2),
                            pool_type="max")
        return mx.sym.Concat(b3, bd, bp)


    def inc_b(data, mid, name):
        b1 = conv(data, 192, (1, 1), name="%s_1x1" % name)
        b7 = conv(data, mid, (1, 1), name="%s_7r" % name)
        b7 = conv(b7, mid, (1, 7), pad=(0, 3), name="%s_1x7" % name)
        b7 = conv(b7, 192, (7, 1), pad=(3, 0), name="%s_7x1" % name)
        bd = conv(data, mid, (1, 1), name="%s_d7r" % name)
        bd = conv(bd, mid, (7, 1), pad=(3, 0), name="%s_d7a" % name)
        bd = conv(bd, mid, (1, 7), pad=(0, 3), name="%s_d7b" % name)
        bd = conv(bd, mid, (7, 1), pad=(3, 0), name="%s_d7c" % name)
        bd = conv(bd, 192, (1, 7), pad=(0, 3), name="%s_d7d" % name)
        bp = mx.sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                            pool_type="avg")
        bp = conv(bp, 192, (1, 1), name="%s_proj" % name)
        return mx.sym.Concat(b1, b7, bd, bp)


    def red_b(data, name):
        b3 = conv(data, 192, (1, 1), name="%s_3r" % name)
        b3 = conv(b3, 320, (3, 3), stride=(2, 2), name="%s_3x3" % name)
        b7 = conv(data, 192, (1, 1), name="%s_7r" % name)
        b7 = conv(b7, 192, (1, 7), pad=(0, 3), name="%s_1x7" % name)
        b7 = conv(b7, 192, (7, 1), pad=(3, 0), name="%s_7x1" % name)
        b7 = conv(b7, 192, (3, 3), stride=(2, 2), name="%s_3x3b" % name)
        bp = mx.sym.Pooling(data, kernel=(3, 3), stride=(2, 2),
                            pool_type="max")
        return mx.sym.Concat(b3, b7, bp)


    def inc_c(data, name):
        b1 = conv(data, 320, (1, 1), name="%s_1x1" % name)
        b3 = conv(data, 384, (1, 1), name="%s_3r" % name)
        b3a = conv(b3, 384, (1, 3), pad=(0, 1), name="%s_1x3" % name)
        b3b = conv(b3, 384, (3, 1), pad=(1, 0), name="%s_3x1" % name)
        bd = conv(data, 448, (1, 1), name="%s_dr" % name)
        bd = conv(bd, 384, (3, 3), pad=(1, 1), name="%s_d3" % name)
        bda = conv(bd, 384, (1, 3), pad=(0, 1), name="%s_d1x3" % name)
        bdb = conv(bd, 384, (3, 1), pad=(1, 0), name="%s_d3x1" % name)
        bp = mx.sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                            pool_type="avg")
        bp = conv(bp, 192, (1, 1), name="%s_proj" % name)
        return mx.sym.Concat(b1, b3a, b3b, bda, bdb, bp)


    def get_symbol(num_classes, **kwargs):
        data = mx.sym.Variable("data")
        net = conv(data, 32, (3, 3), stride=(2, 2), name="stem1")
        net = conv(net, 32, (3, 3), name="stem2")
        net = conv(net, 64, (3, 3), pad=(1, 1), name="stem3")
        net = mx.sym.Pooling(net, kernel=(3, 3), stride=(2, 2),
                             pool_type="max")
        net = conv(net, 80, (1, 1), name="stem4")
        net = conv(net, 192, (3, 3), name="stem5")
        net = mx.sym.Pooling(net, kernel=(3, 3), stride=(2, 2),
                             pool_type="max")
        net = inc_a(net, 32, "mixed0")
        net = inc_a(net, 64, "mixed1")
        net = inc_a(net, 64, "mixed2")
        net = red_a(net, "mixed3")
        net = inc_b(net, 128, "mixed4")
        net = inc_b(net, 160, "mixed5")
        net = inc_b(net, 160, "mixed6")
        net = inc_b(net, 192, "mixed7")
        net = red_b(net, "mixed8")
        net = inc_c(net, "mixed9")
        net = inc_c(net, "mixed10")
        net = mx.sym.Pooling(net, kernel=(8, 8), pool_type="avg",
                             global_pool=True)
        net = mx.sym.Flatten(net)
        net = mx.sym.Dropout(net, p=0.5)
        net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc")
        return mx.sym.SoftmaxOutput(net, name="softmax")
    return get_symbol


IC_SYMBOLS = {"mlp": _ic_mlp, "lenet": _ic_lenet, "alexnet": _ic_alexnet,
              "resnet": _ic_resnet, "vgg": _ic_vgg,
              "googlenet": _ic_googlenet, "mobilenet": _ic_mobilenet,
              "resnext": _ic_resnext, "inception-bn": _ic_inception_bn,
              "inception-v3": _ic_inception_v3}


def ic_symbol(mx, network, num_classes, **kwargs):
    """``symbols.get_symbol`` of examples/image-classification/symbols/
    __init__.py:20-21 over the copies above, in package ``mx``."""
    return IC_SYMBOLS[network](mx)(num_classes=num_classes, **kwargs)


# ---------------------------------------------------------------------------
# image_classification: fit.py's recipe on Inception-v3, the symbol zoo
# through benchmark_score.py, fine_tune.py's stage 2
# ---------------------------------------------------------------------------

_IC_SEED = 17           # the generator (Dropout) at the start of each run


def _fitpy_lr(lr, factor, step_epochs, load_epoch, epoch_size, mx):
    """``_lr_scheduler`` of examples/image-classification/common/fit.py:
    31-45 (copied): the rate and scheduler of a run that begins at
    ``load_epoch``."""
    begin = load_epoch or 0
    for e in step_epochs:
        if begin >= e:
            lr *= factor
    steps = [epoch_size * (e - begin) for e in step_epochs if e > begin]
    if not steps:
        return lr, None
    return lr, mx.lr_scheduler.MultiFactorScheduler(step=steps,
                                                    factor=factor)


def _free(gpu):
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()


def _host_params(mod):
    arg, aux = mod.get_params()
    return ({k: v._data.to("cpu", copy=True) for k, v in arg.items()},
            {k: v._data.to("cpu", copy=True) for k, v in aux.items()})


def _bit_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in b) and sorted(a) == sorted(b)


def _ic_data(n, hw, classes, seed):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, (n, 3, hw, hw)).astype(np.float32),
            rs.randint(0, classes, n).astype(np.float32))


class _BatchLog:
    """A batch-end callback of fit.py's loop: the rate of each update,
    CUDA events and host time per batch, the weights after batch
    ``snap_at`` of the first epoch, the peak memory per epoch."""

    def __init__(self, mod, gpu, snap_at=None):
        self.mod, self.gpu, self.snap_at = mod, gpu, snap_at
        self.rates, self.events, self.wall, self.snap = [], [], [], None
        self.peaks = []

    def __call__(self, param):
        self.rates.append(self.mod._optimizer.learning_rate)
        self.wall.append(time.perf_counter())
        if self.gpu:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        if param.epoch == 0 and param.nbatch == self.snap_at:
            self.snap = _host_params(self.mod)

    def epoch_end(self, epoch, sym, arg, aux):
        if self.gpu:
            torch.cuda.synchronize()
            self.peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

    def ms_per_batch(self, per_epoch):
        """(CUDA-event ms, host ms) of each batch after an epoch's first."""
        if self.gpu:
            torch.cuda.synchronize()
        ev, wall = [], []
        for i in range(1, len(self.wall)):
            if i % per_epoch == 0:
                continue
            wall.append((self.wall[i] - self.wall[i - 1]) * 1e3)
            if self.gpu:
                ev.append(self.events[i - 1].elapsed_time(self.events[i]))
        return ev, wall


def _ic_fit(mx, sym, ctx, train, kv, opt, log=None, arg=None, aux=None,
            mod=None, begin_epoch=0, num_epoch=2, epoch_end=None, val=None):
    """fit.py:79-93 (copied, the loop): ``Module.fit`` with fit.py's
    arguments."""
    if mod is None:
        mod = mx.mod.Module(sym, context=ctx)
    batch_end = [mx.callback.Speedometer(train.batch_size, 3)]
    if log is not None:
        log.mod = mod
        batch_end.append(log)
    mod.fit(train, eval_data=val, eval_metric=["acc"], optimizer="sgd",
            optimizer_params=opt, arg_params=arg, aux_params=aux,
            initializer=mx.initializer.Xavier(magnitude=2.0),
            num_epoch=num_epoch, begin_epoch=begin_epoch,
            batch_end_callback=batch_end, epoch_end_callback=epoch_end,
            kvstore=kv)
    return mod


def _fitpy_opt(mx, load_epoch, epoch_size, batch):
    """fit.py:57-71's optimizer parameters for ``--lr 0.05 --momentum
    0.9 --wd 1e-4 --lr-step-epochs 1``."""
    lr, sched = _fitpy_lr(0.05, 0.1, [1], load_epoch, epoch_size, mx)
    opt = {"learning_rate": lr, "wd": 1e-4, "rescale_grad": 1.0 / batch,
           "momentum": 0.9}
    if sched is not None:
        opt["lr_scheduler"] = sched
    return opt


_EPS32 = float(np.finfo(np.float32).eps)
_EPS64 = float(np.finfo(np.float64).eps)


def _step1_gate(card, card64, cpu, cpu64, w0, n=6):
    """Step 1's weights on the card against the CPU's, tensor by tensor,
    with the CPU's fp64 step (``cpu64``, from the weights ``w0``) as the
    arbiter; ``upd`` is a tensor's largest update there, ``top`` its
    largest |value|.

    (A) The card's fp64 step: within 1e-6 of ``upd`` plus 4 fp64 ulps of
    ``top``, on every tensor.
    (B) The card's fp32 step: within 1e-3 of ``top`` or twice the CPU
    fp32's largest error on any tensor of its kind (``weight``, ``beta``,
    ...); and within a quarter of ``upd`` plus 4 fp32 ulps of ``top``, or
    twice the CPU fp32's error on that very tensor (where fp32 cannot
    resolve the update on the CPU either). One step leaves each
    BatchNorm shift a cancelling sum that fp32 rounds to a few percent on
    either device, so the first condition alone passes a dropped shift
    update; the second fails it wherever the CPU's fp32 resolves the
    update (twice its error below the update), and (A) fails it on every
    tensor.
    Control: a dropped update and one of the opposite sign, planted on
    each tensor in turn, must fail (A) on every tensor the step moves;
    the tensors (B) catches them on are counted. Returns (ok, report)."""
    def err(got, ref):
        return float((got.double() - ref).abs().max())

    rows, fam = {}, collections.defaultdict(float)
    for k, ref in cpu64.items():
        ref = ref.double()
        kind = k.rsplit("_", 1)[-1]
        r = {"kind": kind, "ref": ref, "w0": w0[k].double(),
             "upd": float((ref - w0[k].double()).abs().max()),
             "top": float(ref.abs().max()), "e_cpu": err(cpu[k], ref)}
        fam[kind] = max(fam[kind], r["e_cpu"])
        rows[k] = r

    def ok_a(r, got64):
        return err(got64, r["ref"]) <= 1e-6 * r["upd"] + 4 * _EPS64 * r["top"]

    def ok_b(r, got):
        e = err(got, r["ref"])
        return (e <= max(1e-3 * r["top"], 2 * fam[r["kind"]])
                and e <= max(0.25 * r["upd"] + 4 * _EPS32 * r["top"],
                             2 * r["e_cpu"]))

    kinds = sorted(fam)
    rep = {k: collections.Counter() for k in kinds}
    fail_a, fail_b, missed = [], [], []
    for k, r in rows.items():
        c = rep[r["kind"]]
        c["total"] += 1
        r["e_card"], r["e_card64"] = err(card[k], r["ref"]), \
            err(card64[k], r["ref"])
        c["within_1e-3_of_top"] += r["e_card"] <= 1e-3 * r["top"]
        if not ok_a(r, card64[k]):
            fail_a.append(k)
        if not ok_b(r, card[k]):
            fail_b.append(k)
        if r["upd"] == 0:
            c["not_moved"] += 1
            continue
        w0k = r["w0"]
        planted_a = (w0k, 2 * w0k - card64[k].double())
        planted_b = (w0k, 2 * w0k - card[k].double())
        caught_a = not any(ok_a(r, t) for t in planted_a)
        caught_b = not any(ok_b(r, t) for t in planted_b)
        c["planted_caught_fp64"] += caught_a
        c["planted_caught_fp32"] += caught_b
        c["fp32_resolves_update"] += 2 * r["e_cpu"] < r["upd"]
        if not caught_a:
            missed.append(k)
    worst = sorted(rows, key=lambda k: -rows[k]["e_card"]
                   / max(rows[k]["upd"], 1e-30))[:n]
    report = {
        "by_kind": {k: dict(v) for k, v in rep.items()},
        "fp64_worst_err_over_update": max(
            r["e_card64"] / max(r["upd"], 1e-30) for r in rows.values()),
        "fp32_worst_err_over_update": max(
            r["e_card"] / max(r["upd"], 1e-30) for r in rows.values()),
        "failed_fp64": fail_a[:n], "failed_fp32": fail_b[:n],
        "planted_not_caught": missed[:n],
        "worst_fp32": [[k, rows[k]["e_card"], rows[k]["e_cpu"],
                        rows[k]["upd"], rows[k]["top"]] for k in worst]}
    return not (fail_a or fail_b or missed), report


def _softmax_ce(prob, label):
    p = prob.double()[torch.arange(prob.shape[0]), label.long()]
    return float(-torch.log(p.clamp_min(1e-30)).mean())


def _ic_first_step(mx, sym, ctx, arg, aux, x, y, dtype="float32"):
    """One fused batch step of fit.py's optimizer through a store, from
    ``arg``/``aux``, in ``dtype``: (cross-entropy of the outputs, weights
    after)."""
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([mx.io.DataDesc("data", x.shape, dtype)],
             [mx.io.DataDesc("softmax_label", y.shape, dtype)])
    mod.init_params(arg_params={k: v.to(getattr(torch, dtype))
                                for k, v in arg.items()},
                    aux_params={k: v.to(getattr(torch, dtype))
                                for k, v in aux.items()})
    mod.init_optimizer(kvstore=mx.kvstore.create("device"), optimizer="sgd",
                       optimizer_params=_fitpy_opt(mx, None, 6, x.shape[0]))
    assert mod.fused_step(mx.io.DataBatch(
        [mx.nd.array(x, ctx=mx.cpu(), dtype=dtype)],
        [mx.nd.array(y, ctx=mx.cpu(), dtype=dtype)]))
    ce = _softmax_ce(mod.get_outputs()[0]._data, torch.from_numpy(y).to(
        mod.get_outputs()[0]._data.device))
    return ce, _host_params(mod)[0]


def _fit_leg(mx, ctx, rehearsal, card, tmp):
    """(a) fit.py on Inception-v3, resumed both ways; score and predict;
    step 1 against the CPU."""
    gpu = ctx.device_type == "gpu"
    batch, per_epoch, hw = (2, 2, 75) if rehearsal else (32, 4, 299)
    with mx.name.NameManager():
        sym = ic_symbol(mx, "inception-v3", 1000)
    shapes = sym.infer_shape(data=(batch, 3, hw, hw))[0]
    n_params = sum(int(np.prod(s)) for n, s in zip(sym.list_arguments(),
                                                   shapes)
                   if n not in ("data", "softmax_label"))
    if not rehearsal:
        assert n_params == 23834568, n_params
    x, y = _ic_data(batch * per_epoch, hw, 1000, seed=1)
    vx, vy = _ic_data(batch + batch // 2 + 1, hw, 1000, seed=2)

    def train(n=None):
        return mx.io.NDArrayIter(x[:n], y[:n], batch_size=batch)
    val = mx.io.NDArrayIter(vx, vy, batch_size=batch)
    # the weights every run starts from (Xavier, magnitude 2, seeded)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", (batch, 3, hw, hw))], [("softmax_label", (batch,))])
    mod.init_params(mx.initializer.Xavier(
        magnitude=2.0, generator=torch.Generator().manual_seed(0)))
    arg0, aux0 = _host_params(mod)
    del mod
    _free(gpu)
    pa, pb = os.path.join(tmp, "ic-a"), os.path.join(tmp, "ic-b")

    # the uninterrupted run: 2 epochs, the rate steps after epoch 1
    log = _BatchLog(None, gpu, snap_at=1)
    whole = mx.mod.Module(sym, context=ctx)

    def reseed(epoch, *_):
        mx.random.seed(_IC_SEED + epoch + 1)
    if gpu:
        torch.cuda.reset_peak_memory_stats()
    mx.random.seed(_IC_SEED)
    t0 = time.perf_counter()
    _ic_fit(mx, sym, ctx, train(), mx.kvstore.create("device"),
            _fitpy_opt(mx, None, per_epoch, batch), log=log, arg=arg0,
            aux=aux0, mod=whole, val=val,
            epoch_end=[mx.callback.do_checkpoint(pa),
                       mx.callback.module_checkpoint(
                           whole, pb, save_optimizer_states=True),
                       log.epoch_end, reseed])
    fit_s = time.perf_counter() - t0
    assert whole._update_on_kvstore and whole._fused_fallback_reason is None
    rates = list(log.rates)
    want_rates = [0.05] * per_epoch + [0.05 * 0.1] * per_epoch
    assert rates == want_rates, rates
    ev, wall = log.ms_per_batch(per_epoch)
    final = _host_params(whole)
    store = whole._kvstore._store
    assert all(torch.equal(store[i]._data.cpu(), final[0][n])
               for i, n in enumerate(whole._param_names))
    res = mx.metric.Accuracy()
    score = whole.score(val, res)
    pred = whole.predict(val)
    assert pred.shape == (len(vx), 1000), pred.shape
    p = pred._data.float()
    assert bool(torch.isfinite(p).all())
    assert float((p.sum(1) - 1).abs().max()) < 1e-3
    prof = profile_forward(lambda: whole.fused_step(next(iter(train()))),
                           reps=1) if gpu else None
    emit({"image_classification_fit": {
        "card": card, "network": "inception-v3", "params": n_params,
        "batch": batch, "image": [3, hw, hw], "dtype": "float32",
        "batches_per_epoch": per_epoch, "epochs": 2,
        "kvstore": "device (update_on_kvstore)", "fit_s": fit_s,
        "rate_per_update": rates,
        "ms_per_batch_events": ev, "ms_per_batch_host": wall,
        "images_per_s": [batch * 1e3 / m for m in (ev or wall)],
        "peak_bytes_per_epoch": log.peaks, "score": score,
        "predict_shape": list(pred.shape), "profile_one_batch": prof}})
    if gpu:
        assert log.peaks[1] <= log.peaks[0], log.peaks
    snap2 = log.snap
    del whole, pred, p
    _free(gpu)

    # routes over the first two batches: no store, phase-split
    routes = {}
    for name, kv, fused in (("kvstore=None fused", None, "1"),
                            ("store phase-split", "store", "0")):
        os.environ["MXNET_MODULE_FUSED_STEP"] = fused
        mx.random.seed(_IC_SEED)
        mod = _ic_fit(mx, sym, ctx, train(2 * batch),
                      mx.kvstore.create("device") if kv else None,
                      _fitpy_opt(mx, None, per_epoch, batch), arg=arg0,
                      aux=aux0, num_epoch=1)
        os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
        got = _host_params(mod)
        routes[name] = _bit_equal(got[0], snap2[0]) and \
            _bit_equal(got[1], snap2[1])
        del mod
        _free(gpu)

    # resume from epoch 1: fit.py:55-57 (parameters only), then with the
    # optimizer's states (Module.load + the store's states)
    _, arg1, aux1 = mx.model.load_checkpoint(pa, 1, ctx=ctx)
    log_p = _BatchLog(None, gpu)
    mod = _ic_fit(mx, sym, ctx, train(), mx.kvstore.create("device"),
                  _fitpy_opt(mx, 1, per_epoch, batch), log=log_p, arg=arg1,
                  aux=aux1, begin_epoch=1)
    params_route = _host_params(mod)[0]
    params_gap = max(float((params_route[k] - final[0][k]).abs().max())
                     for k in final[0])
    del mod, arg1, aux1
    _free(gpu)
    log_s = _BatchLog(None, gpu)
    mod = mx.mod.Module.load(pb, 1, load_optimizer_states=True, context=ctx)
    mx.random.seed(_IC_SEED + 1)
    _ic_fit(mx, sym, ctx, train(), mx.kvstore.create("device"),
            _fitpy_opt(mx, 1, per_epoch, batch), log=log_s, mod=mod,
            begin_epoch=1, epoch_end=[log_s.epoch_end])
    states_route = _host_params(mod)
    resumed = {"params_only": {"rates": log_p.rates,
                               "rates_equal": log_p.rates == rates[per_epoch:],
                               "max_abs_gap_to_uninterrupted": params_gap},
               "with_states": {"rates": log_s.rates,
                               "rates_equal": log_s.rates == rates[per_epoch:],
                               "bit_equal": _bit_equal(states_route[0],
                                                       final[0])
                               and _bit_equal(states_route[1], final[1]),
                               "peak_bytes": log_s.peaks}}
    del mod
    _free(gpu)

    # step 1 against the CPU, Dropout at 0 (the generators differ)
    sym0 = mx.sym.load_json(sym.tojson().replace('"p": "0.5"', '"p": "0"'))
    ce_card, w_card = _ic_first_step(mx, sym0, ctx, arg0, aux0, x[:batch],
                                     y[:batch])
    _free(gpu)
    if gpu:
        ce64_card, w64_card = _ic_first_step(mx, sym0, ctx, arg0, aux0,
                                             x[:batch], y[:batch],
                                             dtype="float64")
        _free(gpu)
        t0 = time.perf_counter()
        ce_cpu, w_cpu = _ic_first_step(mx, sym0, mx.cpu(), arg0, aux0,
                                       x[:batch], y[:batch])
        ce64, w64 = _ic_first_step(mx, sym0, mx.cpu(), arg0, aux0,
                                   x[:batch], y[:batch], dtype="float64")
        cpu_s = time.perf_counter() - t0
        loss_rel = abs(ce_card - ce_cpu) / abs(ce_cpu)
        loss64_rel = abs(ce64_card - ce64) / abs(ce64)
        params_ok, gate = _step1_gate(w_card, w64_card, w_cpu, w64, arg0)
        param_rel = _max_scaled(w_card, w_cpu)
    else:
        ce_cpu, loss_rel, loss64_rel, param_rel, cpu_s = \
            ce_card, 0.0, 0.0, 0.0, 0.0
        params_ok, gate = True, None
    emit({"image_classification_routes": {
        "card": card, "bit_equal_after_2_batches": routes,
        "resumed_epoch_2": resumed,
        "step1_vs_cpu": {"ce_card": ce_card, "ce_cpu": ce_cpu,
                         "loss_rel": loss_rel, "loss_rel_fp64": loss64_rel,
                         "param_rel_to_max": param_rel,
                         "params_within_gate": params_ok, "gate": gate,
                         "cpu_s": cpu_s, "dropout": 0}}})
    assert all(routes.values()), routes
    assert resumed["params_only"]["rates_equal"], resumed
    assert resumed["with_states"]["rates_equal"], resumed
    assert resumed["with_states"]["bit_equal"], resumed
    assert params_gap > 0, "momentum restarted, yet the weights are equal"
    assert loss_rel <= 1e-4 and loss64_rel <= 1e-9 and params_ok, \
        (loss_rel, loss64_rel, gate)
    return pa, batch, hw, x, y


_BENCH_NETS = (("mlp", 28, {}), ("lenet", 28, {}), ("alexnet", 224, {}),
               ("resnet", 224, {"num_layers": 50}),
               ("vgg", 224, {"num_layers": 16}), ("googlenet", 224, {}),
               ("mobilenet", 224, {}), ("resnext", 224, {"num_layers": 50}),
               ("inception-bn", 224, {}), ("inception-v3", 299, {}))


def _score_leg(mx, ctx, rehearsal, card):
    """(b) benchmark_score.py:10-38 for the ten networks of
    symbols/__init__.py at batch 32: images/s, then ``Module.reshape`` to
    batch 2 and the 2 rows against the CPU (logits: the SoftmaxOutput's
    input, grouped beside it)."""
    gpu = ctx.device_type == "gpu"
    batch, reps = (2, 1) if rehearsal else (32, 10)
    out = []
    for net, hw, kw in _BENCH_NETS:
        if rehearsal and hw > 28:
            hw = 75 if net == "inception-v3" else 67
        with mx.name.NameManager():
            sym = ic_symbol(mx, net, 1000, **kw)
        grouped = mx.sym.Group([sym, sym.get_children()[0]])
        shape = (batch, 1 if hw == 28 else 3, hw, hw)
        mod = mx.mod.Module(grouped, label_names=["softmax_label"],
                            context=ctx)
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (batch,))],
                 for_training=False)
        mod.init_params(mx.initializer.Xavier(
            generator=torch.Generator().manual_seed(1)))
        xs = np.random.RandomState(3).rand(*shape).astype(np.float32)
        data = mx.io.DataBatch(data=[mx.nd.array(xs, ctx=mx.cpu())],
                               label=[mx.nd.zeros((batch,), ctx=mx.cpu())])
        mod.forward(data, is_train=False)           # warm-up
        mod.get_outputs()[0].wait_to_read()
        t0 = time.perf_counter()
        if gpu:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            a.record()
        for _ in range(reps):
            mod.forward(data, is_train=False)
        mod.get_outputs()[0].wait_to_read()
        if gpu:
            b.record()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms = a.elapsed_time(b) / reps if gpu else wall * 1e3 / reps
        big = mod.get_outputs()[1]._data[:2].float().cpu()
        held = {n: a_ for n, a_ in mod._exec.arg_dict.items()
                if n in mod._param_names}
        mod.reshape([("data", (2,) + shape[1:])], [("softmax_label", (2,))])
        assert all(mod._exec.arg_dict[n] is a_ for n, a_ in held.items())
        two = mx.io.DataBatch(data=[mx.nd.array(xs[:2], ctx=mx.cpu())],
                              label=[mx.nd.zeros((2,), ctx=mx.cpu())])
        mod.forward(two, is_train=False)
        small = mod.get_outputs()[1]._data.float().cpu()
        arg, aux = mod.get_params()
        cpu = mx.mod.Module(grouped, label_names=["softmax_label"],
                            context=mx.cpu())
        cpu.bind(data_shapes=[("data", (2,) + shape[1:])],
                 label_shapes=[("softmax_label", (2,))], for_training=False)
        cpu.init_params(arg_params={k: v.asnumpy() for k, v in arg.items()},
                        aux_params={k: v.asnumpy() for k, v in aux.items()})
        cpu.forward(two, is_train=False)
        want = cpu.get_outputs()[1]._data.float()
        rec = {"network": net, "image": list(shape[1:]), "batch": batch,
               "ms_per_batch": ms, "images_per_s": batch * 1e3 / ms,
               "host_ms_per_batch": wall * 1e3 / reps,
               "finite": bool(torch.isfinite(big).all()
                              and torch.isfinite(small).all()),
               "batch32_rows_vs_cpu": _rel_to_max(big, want)[1],
               "batch2_vs_cpu": _rel_to_max(small, want)[1]}
        out.append(rec)
        del mod, cpu, arg, aux, held
        _free(gpu)
    emit({"image_classification_score": {"card": card, "networks": out}})
    for rec in out:
        assert rec["finite"], rec
        assert rec["batch32_rows_vs_cpu"] <= 1e-3, rec
        assert rec["batch2_vs_cpu"] <= 1e-3, rec


def _fine_tune_leg(mx, ctx, rehearsal, card, prefix, batch, hw, x, y):
    """(c) fine_tune.py:85-123's stage 2 on leg (a)'s checkpoint: cut at
    the flatten output, a fresh 10-class head, the backbone fixed."""
    gpu = ctx.device_type == "gpu"
    sym, arg_params, aux_params = mx.model.load_checkpoint(prefix, 2,
                                                           ctx=ctx)
    internals = sym.get_internals()
    flat = [n for n in internals.list_outputs()
            if n.startswith("flatten") and n.endswith("_output")]
    assert len(flat) == 1, flat
    features = internals[flat[0]]
    net = mx.sym.FullyConnected(features, num_hidden=10, name="tgt_fc")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    backbone = [n for n in net.list_arguments()
                if n not in ("data", "softmax_label")
                and not n.startswith("tgt_fc")]
    it = mx.io.NDArrayIter(x[:3 * batch], y[:3 * batch] % 10,
                           batch_size=batch, shuffle=True)
    tuned = mx.mod.Module(net, context=ctx, fixed_param_names=backbone)
    before = {n: arg_params[n]._data.to("cpu", copy=True) for n in backbone}
    np.random.seed(5)
    tuned.fit(it, num_epoch=1, arg_params=arg_params, aux_params=aux_params,
              allow_missing=True, initializer=mx.initializer.Xavier(
                  generator=torch.Generator().manual_seed(2)),
              optimizer_params={"learning_rate": 0.01})
    after = _host_params(tuned)[0]
    frozen = all(torch.equal(after[n], before[n]) for n in backbone)
    head = float(after["tgt_fc_weight"].abs().max())
    emit({"image_classification_fine_tune": {
        "card": card, "cut_at": flat[0], "frozen_params": len(backbone),
        "trained": ["tgt_fc_weight", "tgt_fc_bias"], "batches": 3,
        "frozen_bit_identical": frozen, "head_max_abs": head}})
    assert frozen and np.isfinite(head)
    del tuned, arg_params, aux_params
    _free(gpu)


def image_classification_phase(mx, ctx, rehearsal):
    """(a) fit.py on Inception-v3 through a store, resumed; (b) the ten
    symbols through benchmark_score.py; (c) fine_tune.py's stage 2.
    Returns the K1-K3 launches of the path (0: no hand-written kernel)."""
    gpu = ctx.device_type == "gpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _free(gpu)
    card = _card_line() if gpu else "CPU rehearsal"
    from mxnet_tpu_torch.kernels import fused_bn as K1
    from mxnet_tpu_torch.kernels import flash_attention as FA
    with tempfile.TemporaryDirectory() as tmp:
        # -- the main path: counts zeroed just before, read just after ----
        K1.launches = K1.bwd_launches = FA.fwd_launches = FA.bwd_launches = 0
        t0 = time.perf_counter()
        prefix, batch, hw, x, y = _fit_leg(mx, ctx, rehearsal, card, tmp)
        t1 = time.perf_counter()
        _score_leg(mx, ctx, rehearsal, card)
        t2 = time.perf_counter()
        _fine_tune_leg(mx, ctx, rehearsal, card, prefix, batch, hw, x, y)
        counts = _kernel_counts()
        _k1_bwd("image_classification")
        # -----------------------------------------------------------------
    emit({"image_classification": {
        "leg_s": {"fit": t1 - t0, "score": t2 - t1,
                  "fine_tune": time.perf_counter() - t2},
        "k1_launches": counts[0], "k2_launches": counts[1],
        "k3_launches": counts[2],
        "note": "no hand-written kernel on this path: the JAX package "
                "runs it through XLA; cuDNN, cuBLAS and ATen do its work"}})
    assert counts == (0, 0, 0), counts
    torch.backends.cudnn.deterministic = det
    _free(gpu)
    return counts


# ---------------------------------------------------------------------------
# gluon_zoo: the Gluon model zoo, and densenet121 trained from gluon.data
# ---------------------------------------------------------------------------

_ZOO_NETS = (("alexnet", 224), ("densenet121", 224), ("inception_v3", 299),
             ("mobilenet1_0", 224), ("resnet50_v1", 224))


def _zoo_copy(mx, name, params, ctx, x1, **kw):
    """The zoo network ``name`` on ``ctx`` holding ``params`` (host
    tensors by name; the ``zoo_`` prefix keeps the names equal), its
    shapes completed by a forward of ``x1``."""
    net = mx.gluon.model_zoo.vision.get_model(name, prefix="zoo_", **kw)
    net.initialize(ctx=ctx)
    net(mx.nd.array(x1, ctx=ctx))
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(params[k], ctx=ctx))
    return net


def _zoo_inference_leg(mx, ctx, rehearsal, card):
    gpu = ctx.device_type == "gpu"
    batch, reps = (2, 1) if rehearsal else (32, 10)
    out = []
    for name, hw in _ZOO_NETS:
        if rehearsal and name != "inception_v3":
            hw = 67
        net = mx.gluon.model_zoo.vision.get_model(name, prefix="zoo_")
        net.initialize(mx.init.Xavier(
            generator=torch.Generator().manual_seed(4)), ctx=ctx)
        xs = np.random.RandomState(5).uniform(-1, 1, (batch, 3, hw, hw)) \
            .astype(np.float32)
        xd = mx.nd.array(xs, ctx=ctx)
        big = net(xd)                               # deferred shapes, warm
        big.wait_to_read()
        t0 = time.perf_counter()
        if gpu:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            a.record()
        for _ in range(reps):
            big = net(xd)
        big.wait_to_read()
        if gpu:
            b.record()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms = a.elapsed_time(b) / reps if gpu else wall * 1e3 / reps
        small = net(mx.nd.array(xs[:2], ctx=ctx))._data.float().cpu()
        params = {k: p.data()._data.to("cpu", copy=True)
                  for k, p in net.collect_params().items()}
        n_values = sum(int(v.numel()) for v in params.values())
        cpu_net = _zoo_copy(mx, name, params, mx.cpu(), xs[:1])
        want = cpu_net(mx.nd.array(xs[:2], ctx=mx.cpu()))._data.float()
        bigr = big._data[:2].float().cpu()
        rec = {"model": name, "image": [3, hw, hw], "batch": batch,
               "parameter_values": n_values, "ms_per_batch": ms,
               "images_per_s": batch * 1e3 / ms,
               "host_ms_per_batch": wall * 1e3 / reps,
               "finite": bool(torch.isfinite(bigr).all()
                              and torch.isfinite(small).all()),
               "batch32_rows_vs_cpu": _rel_to_max(bigr, want)[1],
               "batch2_vs_cpu": _rel_to_max(small, want)[1]}
        out.append(rec)
        del net, cpu_net, big, xd, params
        _free(gpu)
    emit({"gluon_zoo_inference": {"card": card, "models": out}})
    for rec in out:
        assert rec["finite"], rec
        assert rec["batch32_rows_vs_cpu"] <= 1e-3, rec
        assert rec["batch2_vs_cpu"] <= 1e-3, rec


def _zoo_train(mx, params, ctx, loader, hybridize, kvstore, steps, seed,
               x1, dtype="float32"):
    """The Gluon loop on densenet121 from ``params``: DataLoader batches
    moved to ``ctx``, ``autograd.record`` -> SoftmaxCrossEntropyLoss ->
    ``backward`` -> ``Trainer.step``. Returns (losses, CUDA ms, host ms,
    peak and held bytes per step, the host batches, the weights after
    each step, the net and its step function)."""
    gpu = ctx.device_type == "gpu"
    net = _zoo_copy(mx, "densenet121", params, ctx, x1)
    if dtype != "float32":
        net.cast(dtype)
    if hybridize:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9,
                                "wd": 1e-4}, kvstore=kvstore)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    np.random.seed(seed)
    batches = list(loader)[:steps]
    it = iter(batches)
    losses, peaks, held, snaps = [], [], [], []

    def step(data_label=None):
        data, label = data_label or next(it)
        d, l_ = data.as_in_context(ctx), label.as_in_context(ctx)
        if dtype != "float32":
            d, l_ = d.astype(dtype), l_.astype(dtype)
        with mx.autograd.record():
            loss = loss_fn(net(d), l_)
        loss.backward()
        trainer.step(d.shape[0])
        return loss

    ms, wall = [], []
    for i in range(steps):
        if gpu:
            torch.cuda.reset_peak_memory_stats()
        loss, m, w = _timed_steps(step, 1, gpu)
        losses.append(float(loss[0].asnumpy().mean()))
        ms += m
        wall += w
        if gpu:
            peaks.append(torch.cuda.max_memory_allocated())
            held.append(torch.cuda.memory_allocated())
        snaps.append(_host_copy(net.collect_params()))
    host = [[b.asnumpy() for b in pair] for pair in batches]
    return losses, ms, wall, peaks, held, host, snaps, net, \
        (lambda: step(batches[0]))


def _shm_segments():
    return set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") \
        else set()


def _process_workers(loader, want, steps):
    """``DataLoader(num_workers=2, thread_pool=False)``: two spawned
    processes batch with numpy into shared memory (they never touch the
    card). Its batches under seed 8 against ``want`` (num_workers=0's),
    then an iterator closed after one batch: the segments left behind."""
    before = _shm_segments()
    np.random.seed(8)
    t0 = time.perf_counter()
    got = [[b.asnumpy() for b in pair] for pair in loader(2, False)][:steps]
    secs = time.perf_counter() - t0
    it = iter(loader(2, False))
    next(it)
    it.close()
    leaked = set()
    for _ in range(20):
        leaked = _shm_segments() - before
        if not leaked:
            break
        time.sleep(0.25)
    return {"equal_0": len(got) == len(want) and all(
        np.array_equal(a[i], b[i]) for a, b in zip(got, want)
        for i in (0, 1)), "epoch_s": secs, "leaked_segments": sorted(leaked)}


def _zoo_training_leg(mx, ctx, rehearsal, card):
    """(d) densenet121 through the Gluon loop fed by gluon.data."""
    gpu = ctx.device_type == "gpu"
    batch, n, hw, steps = (4, 12, 32, 2) if rehearsal else (32, 96, 224, 3)
    rs = np.random.RandomState(6)
    X = rs.uniform(-1, 1, (n, 3, hw, hw)).astype(np.float32)
    Y = rs.randint(0, 1000, n).astype(np.float32)
    ds = mx.gluon.data.ArrayDataset(X, Y)

    def loader(workers, thread_pool=True):
        return mx.gluon.data.DataLoader(ds, batch_size=batch, shuffle=True,
                                        last_batch="discard",
                                        num_workers=workers,
                                        thread_pool=thread_pool)
    net = mx.gluon.model_zoo.vision.get_model("densenet121", prefix="zoo_")
    net.initialize(mx.init.Xavier(generator=torch.Generator().manual_seed(7)),
                   ctx=mx.cpu())
    net(mx.nd.array(X[:1], ctx=mx.cpu()))
    init = {k: p.data()._data.clone() for k, p in
            net.collect_params().items()}
    n_values = sum(int(v.numel()) for v in init.values())
    if not rehearsal:
        assert n_values == 8062504, n_values
    del net
    runs = {}
    for name, hyb in (("eager", False), ("hybridized", True)):
        runs[name] = _zoo_train(mx, init, ctx, loader(2), hyb,
                                mx.kvstore.create("device"), steps, 8, X[:1])
        if name == "eager":
            prof = profile_forward(runs[name][-1], reps=1) if gpu else None
        runs[name] = runs[name][:-2]
        _free(gpu)
    e, h = runs["eager"], runs["hybridized"]
    np.random.seed(8)
    zero = [[b.asnumpy() for b in pair] for pair in loader(0)][:steps]
    workers_equal = all(np.array_equal(a[i], b[i]) for a, b in zip(e[5], zero)
                        for i in (0, 1))
    procs = _process_workers(loader, zero, steps)
    none = _zoo_train(mx, init, ctx, loader(0), False, None, 2, 8,
                      X[:1])[:-2]
    _free(gpu)
    store_vs_none = _bit_equal(none[6][1], e[6][1])
    hyb_equal = e[0] == h[0] and all(_bit_equal(a, b)
                                     for a, b in zip(h[6], e[6]))
    # step 1 recomputed on the CPU
    if gpu:
        card64 = _zoo_train(mx, init, ctx, loader(0), False,
                            mx.kvstore.create("device"), 1, 8, X[:1],
                            dtype="float64")[:-2]
        _free(gpu)
        t0 = time.perf_counter()
        cpu = _zoo_train(mx, init, mx.cpu(), loader(0), False, None, 1, 8,
                         X[:1])
        cpu64 = _zoo_train(mx, init, mx.cpu(), loader(0), False, None, 1, 8,
                           X[:1], dtype="float64")
        cpu_s = time.perf_counter() - t0
        loss_rel = abs(e[0][0] - cpu[0][0]) / abs(cpu[0][0])
        loss64_rel = abs(card64[0][0] - cpu64[0][0]) / abs(cpu64[0][0])
        params_ok, gate = _step1_gate(e[6][0], card64[6][0], cpu[6][0],
                                      cpu64[6][0], init)
        param_rel = _max_scaled(e[6][0], cpu[6][0])
    else:
        loss_rel, loss64_rel, param_rel, cpu_s, params_ok, gate = \
            0.0, 0.0, 0.0, 0.0, True, None
    emit({"gluon_zoo_training": {
        "card": card, "model": "densenet121", "parameter_values": n_values,
        "batch": batch, "image": [3, hw, hw], "dtype": "float32",
        "images": n, "loader": "DataLoader(ArrayDataset, shuffle, "
        "last_batch=discard, num_workers=2)",
        "kvstore": "device (update_on_kvstore)",
        "eager": {"loss": e[0], "ms_per_step_events": e[1],
                  "ms_per_step_host": e[2], "peak_bytes": e[3],
                  "held_bytes": e[4]},
        "hybridized": {"loss": h[0], "ms_per_step_events": h[1],
                       "ms_per_step_host": h[2], "peak_bytes": h[3],
                       "held_bytes": h[4]},
        "profile_one_eager_step": prof,
        "hybridized_bit_equal_eager": hyb_equal,
        "workers_2_equal_0": workers_equal,
        "process_workers_2": procs,
        "store_bit_equal_none_after_2_steps": store_vs_none,
        "step1_vs_cpu": {"loss_rel": loss_rel, "loss_rel_fp64": loss64_rel,
                         "param_rel_to_max": param_rel,
                         "params_within_gate": params_ok, "gate": gate,
                         "cpu_s": cpu_s}}})
    assert all(np.isfinite(e[0])) and hyb_equal and workers_equal
    assert procs["equal_0"] and not procs["leaked_segments"], procs
    assert store_vs_none, "kvstore store and None differ"
    assert loss_rel <= 1e-4 and loss64_rel <= 1e-9 and params_ok, \
        (loss_rel, loss64_rel, gate)
    if gpu:
        for r in (e, h):
            assert max(r[3][1:]) <= r[3][1] and max(r[4][1:]) <= r[4][1], r


def gluon_zoo_phase(mx, ctx, rehearsal):
    """(d) the Gluon model zoo at batch 32 in inference, and densenet121
    trained through the Gluon loop from ``gluon.data``. Returns the K1-K3
    launches of the path."""
    gpu = ctx.device_type == "gpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _free(gpu)
    card = _card_line() if gpu else "CPU rehearsal"
    from mxnet_tpu_torch.kernels import fused_bn as K1
    from mxnet_tpu_torch.kernels import flash_attention as FA
    # -- the main path: counts zeroed just before, read just after --------
    K1.launches = K1.bwd_launches = FA.fwd_launches = FA.bwd_launches = 0
    t0 = time.perf_counter()
    _zoo_inference_leg(mx, ctx, rehearsal, card)
    t1 = time.perf_counter()
    _zoo_training_leg(mx, ctx, rehearsal, card)
    counts = _kernel_counts()
    _k1_bwd("gluon_zoo")
    # ---------------------------------------------------------------------
    emit({"gluon_zoo": {
        "leg_s": {"inference": t1 - t0, "training": time.perf_counter() - t1},
        "k1_launches": counts[0], "k2_launches": counts[1],
        "k3_launches": counts[2],
        "note": "the zoo's resnet50_v1 runs without "
                "MXNET_FUSED_BN_ADD_RELU=1, so its tails stay unfused and "
                "K1 launches 0 times; no other hand-written kernel lies "
                "on this path"}})
    assert counts == (0, 0, 0), counts
    torch.backends.cudnn.deterministic = det
    _free(gpu)
    return counts


def _kernel_counts():
    from mxnet_tpu_torch.kernels import fused_bn as K1
    from mxnet_tpu_torch.kernels import flash_attention as FA
    return K1.launches, FA.fwd_launches, FA.bwd_launches


def _k1_bwd(path, since=0):
    """K1's backward launches on ``path``'s main path (since ``since``),
    kept for the kernels line; these paths train no fused block tail."""
    from mxnet_tpu_torch.kernels import fused_bn as K1
    _K1_BWD[path] = K1.bwd_launches - since
    assert _K1_BWD[path] == 0, (path, _K1_BWD[path])


def rnn_training_phase(mx, ctx, rehearsal):
    """Train the recurrent family at published widths: the Gluon word
    language model over ``gluon.rnn.LSTM`` (cuDNN's fused RNN) and the
    bucketing LSTM through ``BucketingModule.fit``. Returns the K1-K3
    launches of the main path (0: the path has no hand-written kernel)."""
    gpu = ctx.device_type == "gpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()
    card = _card_line() if gpu else "CPU rehearsal"
    from mxnet_tpu_torch.kernels import fused_bn as K1
    from mxnet_tpu_torch.kernels import flash_attention as FA
    # -- the main path: counts zeroed just before, read just after --------
    K1.launches = K1.bwd_launches = FA.fwd_launches = FA.bwd_launches = 0
    _word_lm_leg(mx, ctx, rehearsal, card)
    _bucketing_leg(mx, ctx, rehearsal, card)
    _tied_word_lm_leg(mx, ctx, rehearsal, card)
    counts = _kernel_counts()
    _k1_bwd("rnn_training")
    # ---------------------------------------------------------------------
    emit({"rnn_training": {"k1_launches": counts[0],
                           "k2_launches": counts[1],
                           "k3_launches": counts[2],
                           "note": "the recurrent path runs no "
                                   "hand-written kernel (the JAX package's "
                                   "RNN op is lax.scan); cuDNN's fused "
                                   "RNN and cuBLAS do its work"}})
    assert counts == (0, 0, 0), counts
    torch.backends.cudnn.deterministic = det
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# observability: telemetry, faults, the flight recorder, autotune and
# mx.profiler around serving, decode and Module.fit
# ---------------------------------------------------------------------------

# dense peak rates of one card by nvidia-smi name (NVIDIA data sheets):
# (fp32 on the CUDA cores, TF32 on the tensor cores), FLOP/s; the
# "80GB HBM3" part is the SXM5 card
_PEAKS = (("H100 PCIe", 51e12, 378e12), ("H100 NVL", 60e12, 417.5e12),
          ("H100", 67e12, 494.7e12))


def _peak_flops(card_name):
    """The data-sheet peak for the math the serving forward uses: its
    convolutions run in TF32 when ``torch.backends.cudnn.allow_tf32``
    (PyTorch's default), else in fp32. Returns (FLOP/s, which)."""
    fp32, tf32 = next((f, t) for key, f, t in _PEAKS if key in card_name)
    if torch.backends.cudnn.allow_tf32:
        return tf32, "TF32 dense (convolutions: cudnn.allow_tf32)"
    return fp32, "fp32 (CUDA cores)"


def _conv_fc_flops(sym, shapes):
    """Analytic 2*MAC count of the graph's Convolution and FullyConnected
    nodes: output elements x prod(weight.shape[1:]) (the program cards
    count these and nothing elementwise)."""
    internals = sym.get_internals()
    arg_shapes, out_shapes, _ = internals.infer_shape(**shapes)
    args = dict(zip(internals.list_arguments(), arg_shapes))
    outs = dict(zip(internals.list_outputs(), out_shapes))
    nodes = json.loads(sym.tojson())["nodes"]
    total = 0
    for node in nodes:
        if node["op"] in ("Convolution", "FullyConnected"):
            w = args[nodes[node["inputs"][1][0]]["name"]]
            total += 2 * int(np.prod(outs[node["name"] + "_output"])) \
                * int(np.prod(w[1:]))
    return total


def _load_flight_view():
    """``tools/flight_view.py`` (stdlib only) imported by its path."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "flight_view.py")
    spec = importlib.util.spec_from_file_location("flight_view", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _op_cost_s(fn, iters=20000, reps=5):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / iters)
    return best / 1e9


def _telemetry_ops(tel, batches, counter_calls):
    """The registry's own exact op counts over a window, per batch:
    spans, ``counter_inc`` calls (counted by the caller) plus the direct
    counter bumps (transfers, dispatches, host syncs), events, ledger
    tracks and card dispatch bumps."""
    counts = tel.counters()
    direct = sum(v for k, v in counts.items()
                 if k.endswith("_count")
                 or k.startswith(("dispatch.", "host_sync.")))
    return {
        "spans": sum(tel.span_count(n) for n in tel.span_stats()) / batches,
        "counter_ops": (counter_calls + direct) / batches,
        "events": len(tel.events()) / batches,
        "ledger_tracks": sum(st.get("tracked_total", 0)
                             for st in tel.ledger().values()) / batches,
        "card_bumps": sum(c.get("dispatches", 0)
                          for c in tel.programs().values()) / batches}


def _overhead_guard(tel, flight, ops, batch_s):
    """tests/test_telemetry.py's overhead guard on the card's host: the
    telemetry ops per batch times each op's microbenchmarked cost must
    stay under 2% of the batch time."""
    class _Obj:
        pass

    def one_span():
        with tel.span("_guard_probe", ctx={"req_id": 0}):
            pass

    _card = {"id": "_guard_card"}
    cost = {"spans": _op_cost_s(one_span),
            "counter_ops": _op_cost_s(lambda: tel.counter_inc("_guard")),
            "events": _op_cost_s(lambda: tel.record_event("_guard")),
            "ledger_tracks": _op_cost_s(lambda: tel.ledger_track(
                _Obj(), "cpu(0)", 128, shape=(32,), dtype="float32"),
                iters=5000),
            "card_bumps": _op_cost_s(lambda: tel.program_dispatch(_card))}
    tick_s = _op_cost_s(lambda: flight._build_sample({}, 0.05), iters=500)
    work = sum(ops[k] * cost[k] for k in cost)
    return {"ops_per_batch": ops,
            "cost_us": {k: v * 1e6 for k, v in cost.items()},
            "work_us_per_batch": work * 1e6, "batch_ms": batch_s * 1e3,
            "share": work / batch_s, "bound": 0.02,
            "sampler_tick_us": tick_s * 1e6}


def _serve(eng, reqs, timeout=600):
    """Submit ``reqs`` at once and wait: (outputs, req_ids, per-request
    submit-to-result ms, seconds)."""
    t0 = time.perf_counter()
    futs = [(time.perf_counter(), eng.submit(data=x)) for x in reqs]
    outs, lat = [], []
    for ts, f in futs:
        outs.append(f.result(timeout=timeout)[0])
        lat.append((time.perf_counter() - ts) * 1e3)
    return outs, [f.req_id for _, f in futs], lat, \
        time.perf_counter() - t0


def _obs_serving(mx, ctx, rehearsal, card, tmp):
    """Legs (a)-(d) and (g) on the serving phase's net. Returns the K1
    launches of the leg's forwards and (a)'s telemetry figures."""
    from mxnet_tpu_torch import telemetry as tel, faults, flight, \
        compile_cache
    from mxnet_tpu_torch.kernels import fused_bn as K
    from mxnet_tpu_torch.serving import InferenceEngine, CircuitOpen
    gpu = ctx.device_type == "gpu"
    sym, params, hw, classes, max_batch, reqs, burst = _served_resnet(
        mx, ctx, rehearsal)
    shapes = {"data": (1, hw, hw, 3)}
    n_tails = sum(1 for n in sym._topo_nodes() if n.op is not None
                  and n.op.name == "_contrib_BatchNormAddReLU")
    per_image = _conv_fc_flops(sym, {"data": (1, hw, hw, 3)})
    tel.enable()
    tel.reset()
    flight.series_clear()
    forwards = 1          # the forward that finished the net's deferred init

    # (a) telemetry on serving (the registry reset before the engine, so
    # its warm-up cards stay registered with 0 dispatches)
    eng = InferenceEngine(sym, params, shapes, max_batch=max_batch,
                          max_wait_ms=2.0, ctx=ctx)
    forwards += len(eng.buckets)
    inc, calls = tel.counter_inc, [0]

    def counting_inc(name, n=1):       # the guard's exact call count
        calls[0] += 1
        inc(name, n)
    tel.counter_inc = counting_inc
    try:
        t0 = time.perf_counter()
        outs, ids, _, _ = _serve(eng, reqs)
        bouts, bids, _, _ = _serve(eng, burst)
        wall = time.perf_counter() - t0
    finally:
        tel.counter_inc = inc
    st = eng.stats()
    forwards += st["batches"]
    answered = len(outs) + len(bouts)
    c = tel.counters()
    for x, o in zip(reqs + burst, outs + bouts):
        assert o.shape == (x.shape[0], classes) and np.isfinite(o).all()
    assert tel.span_count("serve_request") == answered, \
        (tel.span_count("serve_request"), answered)
    assert tel.span_count("serve_batch") == st["batches"]
    assert c["serving.requests"] == len(reqs) + len(burst)
    assert c["serving.rows"] == sum(x.shape[0] for x in reqs + burst)
    cards = eng.program_cards()
    by_bucket = {}
    for cid, cd in cards.items():
        b = next(e for e in cd["signature"] if "'data'" in e[0])[1][0]
        by_bucket[b] = cd
    assert sorted(by_bucket) == eng.buckets, (sorted(by_bucket), eng.buckets)
    flops_err = {}
    for b, cd in by_bucket.items():
        assert cd["dispatches"] == st["buckets"].get(str(b), 0), \
            (b, cd["dispatches"], st["buckets"])
        flops_err[str(b)] = abs(cd["flops"] - per_image * b) \
            / (per_image * b)
        assert flops_err[str(b)] <= 0.01, (b, cd["flops"], per_image * b)
    peak, peak_kind = _peak_flops(card) if gpu else (None, None)
    tel.set_peak_flops(peak)
    online = tel.online()
    flops_total = online["flops_dispatched"]
    batch_s = tel.span_seconds("serve_batch")
    spans = {k: {q: v[q] for q in ("count", "p50_ms", "p95_ms", "p99_ms")}
             for k, v in tel.span_stats().items() if k in tel.SERVE_SPANS}
    trace_path = os.path.join(tmp, "serving_chrome_events.json")
    with open(trace_path, "w") as f:
        json.dump(tel.chrome_events(since_trace_start=False), f)
    with open(trace_path) as f:
        evs = json.load(f)
    flows = collections.Counter(e["id"] for e in evs
                                if e.get("cat") == "flow")
    missing = [i for i in ids + bids if flows.get("req:%d" % i, 0) < 2]
    assert not missing, missing[:10]
    # the device-time MFU of one bucket-32 forward (the profiler)
    device = None
    if gpu:
        xb = torch.zeros((max_batch, hw, hw, 3), device=ctx.torch_device())
        args = dict(eng._param_raw, data=xb)
        args.update(eng._bucket_extras(max_batch))
        fwd = lambda: eng._forward._fn(args, eng._aux_raw)
        prof = profile_forward(fwd)
        busy = prof["device_busy_ms"]
        device = {"device_busy_ms": busy, "wall_ms": prof["wall_ms"],
                  "model_flops_per_s": per_image * max_batch / busy * 1e3
                  if busy else None,
                  "mfu": per_image * max_batch / busy * 1e3 / peak
                  if busy else None}
        forwards += 1 + 3      # profile_forward's warm call and 3 reps
    ops = _telemetry_ops(tel, st["batches"], calls[0])
    # the per-call signature key of the instrumented forward (computed
    # with telemetry on or off), over a bucket's full argument set
    from mxnet_tpu_torch.executor import _dispatch_key
    kargs = (dict(eng._param_raw, data=torch.zeros(
        (1, hw, hw, 3), device=ctx.torch_device())), eng._aux_raw)
    key_us = _op_cost_s(lambda: hash(_dispatch_key(kargs)), iters=200) * 1e6
    guard = _overhead_guard(tel, flight, ops, wall / st["batches"])
    emit({"observability_serving": {
        "card": card, "requests": answered, "batches": st["batches"],
        "buckets": st["buckets"], "req_per_s": answered / wall,
        "spans": spans, "span_counts_ok": True,
        "cards": {str(b): {"dispatches": cd["dispatches"],
                           "flops": cd["flops"],
                           "peak_bytes": cd["peak_bytes"],
                           "argument_bytes": cd["argument_bytes"]}
                  for b, cd in sorted(by_bucket.items())},
        "analytic_flops_per_image": per_image,
        "card_flops_rel_err": flops_err,
        "tf32": {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                 "cuda.matmul.allow_tf32":
                     torch.backends.cuda.matmul.allow_tf32},
        "peak_flops": peak, "peak_is": peak_kind,
        "online": online,
        "online_over_serve_batch_spans": {
            "flops": flops_total, "serve_batch_s": batch_s,
            "model_flops_per_s": flops_total / batch_s if batch_s else None,
            "mfu": flops_total / batch_s / peak if batch_s and peak
            else None,
            "note": "host span time (asynchronous launch), not device "
                    "time"},
        "device_time_bucket32": device,
        "dispatch_key_us": key_us,
        "dispatch_key_leaves": len(kargs[0]) + len(kargs[1]),
        "chrome_trace_events": len(evs),
        "request_flows": len([i for i in ids + bids])}})
    emit({"observability_overhead_guard": guard})
    assert guard["share"] < 0.02, guard

    # (b) telemetry's cost: 3 rounds on and 3 off in turns (on, off,
    # off, on, on, off), with the garbage collector's pauses per round
    rounds = []
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    full = [reqs[0][:1].repeat(max_batch, axis=0) * (1 + 0.1 * i)
            for i in range(2)]
    full_out = {}
    gc_log = {"s": 0.0, "n": collections.Counter(), "t0": None}

    def gc_timer(ph, info):
        if ph == "start":
            gc_log["t0"] = time.perf_counter()
        elif gc_log["t0"] is not None:
            gc_log["s"] += time.perf_counter() - gc_log["t0"]
            gc_log["n"][info["generation"]] += 1
    gc.callbacks.append(gc_timer)
    try:
        for on in (True, False, False, True, True, False):
            (tel.enable if on else tel.disable)()
            gc_log["s"], gc_log["n"] = 0.0, collections.Counter()
            _, _, lat, secs = _serve(eng, reqs)
            fo, _, _, _ = _serve(eng, full)
            full_out.setdefault(on, []).append(fo)
            rounds.append({"telemetry": on, "req_per_s": len(reqs) / secs,
                           "p50_ms": float(np.percentile(lat, 50)),
                           "gc_pause_ms": gc_log["s"] * 1e3,
                           "gc_collections": dict(gc_log["n"])})
    finally:
        gc.callbacks.remove(gc_timer)
    tel.enable()
    for fo in full_out[True] + full_out[False]:
        for a, b in zip(fo, full_out[True][0]):
            assert np.array_equal(a, b), "telemetry changed the outputs"
    torch.backends.cudnn.deterministic = det
    st_b = eng.stats()
    forwards += st_b["batches"] - st["batches"]
    emit({"observability_cost": {
        "rounds": rounds, "outputs_bit_equal_on_off": True,
        "on_req_per_s": [r["req_per_s"] for r in rounds if r["telemetry"]],
        "off_req_per_s": [r["req_per_s"] for r in rounds
                          if not r["telemetry"]]}})

    # (c) autotune from (a)'s corpus record
    corpus = os.path.join(tmp, "card_corpus.jsonl")
    os.environ["MXNET_CARD_CORPUS"] = corpus
    try:
        assert compile_cache.corpus_append(eng.corpus_record())
        tuned = InferenceEngine(sym, params, shapes, max_batch=max_batch,
                                max_wait_ms=2.0, ctx=ctx, autotune=True)
    finally:
        os.environ.pop("MXNET_CARD_CORPUS", None)
    forwards += len(tuned.buckets)
    plan = tuned.stats()["autotune_plan"]
    assert plan is not None and tuned.buckets == plan["buckets"]
    tcards = tuned.program_cards()
    assert tcards and all(cd.get("autotune_plan") == plan
                          for cd in tcards.values())
    touts, _, _, secs = _serve(tuned, reqs)
    forwards += tuned.stats()["batches"]
    tol = 1e-3 * max(float(np.abs(o).max()) for o in outs)
    worst = max(float(np.abs(a - b).max()) for a, b in zip(touts, outs))
    emit({"observability_autotune": {
        "plan": plan, "buckets": tuned.buckets,
        "max_inflight": tuned._max_inflight,
        "req_per_s": len(reqs) / secs, "max_abs_err": worst, "tol": tol}})
    assert worst <= tol, (worst, tol)
    tuned.close()

    # (g) mx.profiler around 3 bucket-32 forwards of the serving engine
    prof_file = os.path.join(tmp, "profile.json")
    mx.profiler.set_config(filename=prof_file)
    tel.reset()
    mx.profiler.set_state("run")
    gouts, _, _, _ = _serve(eng, [full[0]] * 3)
    mx.profiler.set_state("stop")
    mx.profiler.dump()
    forwards += 3
    with open(prof_file) as f:
        trace = json.load(f)
    tev = trace["traceEvents"]
    batches = [e for e in tev if e.get("cat") == "host"
               and e.get("name") == "serve_batch"]
    kern = [e for e in tev if e.get("cat") == "kernel"]
    k1 = [e for e in kern if "scale_bias_add_relu" in e.get("name", "")]
    conv = [e for e in kern if _kernel_class(e.get("name", "")).startswith(
        "convolutions")]
    assert len(batches) == 3, len(batches)
    overlap = []
    for b in batches:
        lo, hi = b["ts"], b["ts"] + b["dur"]
        overlap.append(sum(1 for e in k1 if lo <= e["ts"] <= hi))
    emit({"observability_profiler": {
        "file_bytes": os.path.getsize(prof_file), "events": len(tev),
        "host_spans": sum(1 for e in tev if e.get("cat") == "host"),
        "flow_events": sum(1 for e in tev if e.get("cat") == "flow"),
        "kernel_events": len(kern), "k1_events": len(k1),
        "conv_gemm_events": len(conv),
        "k1_events_inside_each_serve_batch": overlap}})
    if gpu:
        assert len(k1) >= 3 * n_tails and conv, (len(k1), len(conv))
        assert all(n > 0 for n in overlap), overlap

    # (d) faults and the flight recorder
    fv = _load_flight_view()
    flight.configure(tmp)
    try:
        faults.configure("d2h:raise:n=1")
        answered = retried = 0
        for x in reqs[:8]:
            try:
                eng.submit(data=x).result(timeout=600)
            except faults.InjectedFault:
                retried += 1
                eng.submit(data=x).result(timeout=600)
            answered += 1
        assert answered == 8 and retried == 1
        assert tel.counters()["faults.injected.d2h"] == 1
        faults.clear()
        forwards += 8 + retried
        beng = InferenceEngine(sym, params, shapes, max_batch=max_batch,
                               max_wait_ms=2.0, ctx=ctx, retry_budget=0,
                               breaker_threshold=3)
        forwards += len(beng.buckets)
        # postmortems of one reason are throttled to one a second: the
        # d2h failure above dumped serving_dispatch_failure already
        time.sleep(1.1)
        faults.configure("dispatch:raise:every=1")
        failed = []
        for x in reqs[:3]:
            f = beng.submit(data=x)
            try:
                f.result(timeout=600)
            except faults.InjectedFault:
                failed.append(f.req_id)
        assert len(failed) == 3, failed
        try:
            beng.submit(data=reqs[0])
            raise AssertionError("the breaker did not open")
        except CircuitOpen:
            pass
        dumps = sorted(d for d in os.listdir(tmp)
                       if d.startswith("postmortem-"))
        fail_dump = [fv.load_dump(os.path.join(tmp, d)) for d in dumps
                     if "serving_dispatch_failure" in d]
        fail_dump = [r for r in fail_dump
                     if r["exception"].get("fault_site") == "dispatch"]
        assert fail_dump and any("breaker_trip" in d for d in dumps), dumps
        rec = fail_dump[0]
        summary = fv.summarize(rec)
        assert rec["reason"] == "serving_dispatch_failure"
        assert rec["extra"]["req_ids"] == [failed[0]], rec["extra"]
        assert rec["exception"]["fault_site"] == "dispatch"
        faults.clear()
        beng.reset_breaker()
        ok = [beng.submit(data=x).result(timeout=600) for x in reqs[:8]]
        assert len(ok) == 8
        faults.configure("dispatch:nan:n=1")
        nan_out = beng.submit(data=reqs[0]).result(timeout=600)[0]
        after = beng.submit(data=reqs[0]).result(timeout=600)[0]
        faults.clear()
        assert np.isnan(nan_out).all() and np.isfinite(after).all()
        forwards += beng.stats()["batches"]
        beng.close()
        emit({"observability_faults": {
            "d2h_raise_retried": retried, "answered": answered,
            "faults_injected_d2h": 1,
            "breaker_open_after_failures": len(failed),
            "postmortems": dumps, "postmortem_reason": rec["reason"],
            "postmortem_req_ids": rec["extra"]["req_ids"],
            "flight_view_summary_keys": sorted(summary),
            "after_reset_answered": len(ok),
            "dispatch_nan_outputs_all_nan": True}})
    finally:
        faults.clear()
        flight.configure(None)
        flight.uninstall()
    eng.close()
    return forwards * n_tails if gpu else 0, forwards, n_tails


def _obs_decode(mx, ctx, rehearsal, card):
    """Leg (e): the decode phase's full-width cell through DecodeEngine
    with TelemetryLogger.log_decode, the flight sampler at 50 ms and the
    OpenMetrics endpoint on the loopback."""
    import urllib.request
    from mxnet_tpu_torch import telemetry as tel, flight
    from mxnet_tpu_torch.decode import DecodeEngine, AttentionDecodeCell
    dims, slots, _, _, _, prompt_len = _DECODE[rehearsal]
    cell = AttentionDecodeCell(**dims)
    params = cell.init_params(1)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cell.vocab - 1, int(rng.randint(
        2, prompt_len + 1))).astype(np.int32) for _ in range(4 * slots)]
    # no registry reset: the scrape must hold the serving legs' counters
    flight.series_clear()
    port = flight.metrics_http_start(port=0, host="127.0.0.1")
    flight.sampler_start(50)
    try:
        eng = DecodeEngine(cell, params, slots=slots,
                           max_prompt_len=prompt_len * 2, max_new_tokens=48,
                           ctx=ctx, telemetry_logger=mx.callback
                           .TelemetryLogger(frequent=16))
        with eng:
            base = {n: tel.span_count(n) for n in tel.DECODE_SPANS}
            futs = [eng.submit(p) for p in prompts]
            res = [f.result(timeout=600) for f in futs]
            time.sleep(0.15)          # one more sampler tick with state
            st = eng.stats()
            text = urllib.request.urlopen(
                "http://127.0.0.1:%d/metrics" % port, timeout=30) \
                .read().decode()
    finally:
        flight.sampler_stop()
        flight.metrics_http_stop()
    assert all(len(r.tokens) == 48 for r in res)
    counts = {n: tel.span_count(n) - base[n] for n in tel.DECODE_SPANS}
    assert counts["serve_prefill"] == st["slot_admit"] == len(prompts), \
        (counts, st["slot_admit"])
    assert counts["serve_decode_step"] == st["steps"], (counts, st["steps"])
    assert counts["serve_detokenize"] == st["resolved"]
    samples = flight.series()
    with_state = [s for s in samples if s["serving"]["engines"] >= 1
                  and s["serving"]["active_slots"] > 0]
    assert with_state, samples[-3:]
    # OpenMetrics: every sample line is `name{labels} value`, one TYPE per
    # family, '# EOF' last
    lines = text.rstrip("\n").split("\n")
    assert lines[-1] == "# EOF"
    families = [ln.split()[2] for ln in lines if ln.startswith("# TYPE ")]
    assert len(families) == len(set(families))
    for ln in lines[:-1]:
        if ln.startswith("#"):
            continue
        name, value = ln.rsplit(" ", 1)
        float(value)
        assert "{" in name and name.endswith("}"), ln
    for want in ("mxnet_tpu_serving_requests_total",
                 "mxnet_tpu_decode_tokens_total",
                 "mxnet_tpu_decode_steps_total"):
        assert want in text, want
    tick = _op_cost_s(lambda: flight._build_sample({}, 0.05), iters=200)
    emit({"observability_decode": {
        "card": card, "prompts": len(prompts), "new_tokens": 48,
        "slots": slots, "span_counts": counts, "steps": st["steps"],
        "prefills": st["slot_admit"],
        "token_latency_ms": st["token_latency_ms"],
        "series_samples": len(samples),
        "samples_with_engine_state": len(with_state),
        "sampler_tick_us": tick * 1e6,
        "openmetrics_lines": len(lines),
        "decode_cards": len(eng.program_cards())}})


def _obs_fit(mx, ctx, rehearsal, card):
    """Leg (f): 2 batches of the resnet_training phase's fp32 batch-32
    ``Module.fit`` with a ``device`` store and a TelemetryLogger, fused,
    then phase-split: the fit-phase spans by (epoch, nbatch), the store's
    push/pull counts and the host time per step by span."""
    from mxnet_tpu_torch import telemetry as tel
    net, sym, hw, classes = _resnet_net(mx, ctx, rehearsal)
    aux_names = set(sym.list_auxiliary_states())
    params = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    arg = {k: v for k, v in params.items() if k not in aux_names}
    aux = {k: v for k, v in params.items() if k in aux_names}
    del net
    batch = 4 if rehearsal else 32
    X, Y = _module_data(2, batch, hw, classes)
    out = {}
    for fused in (True, False):
        os.environ["MXNET_MODULE_FUSED_STEP"] = "1" if fused else "0"
        try:
            mod = mx.mod.Module(sym, context=ctx)
            mod.bind(data_shapes=[("data", (batch, hw, hw, 3))],
                     label_shapes=[("softmax_label", (batch,))])
            mod.init_params(arg_params=arg, aux_params=aux)
            kv = mx.kvstore.create("device")
            it = mx.io.NDArrayIter(X, Y, batch_size=batch)
            tel.reset()
            mod.fit(it, eval_metric="acc", optimizer="sgd", kvstore=kv,
                    optimizer_params={"learning_rate": _BENCH_LR,
                                      "momentum": _BENCH_MOMENTUM,
                                      "rescale_grad": 1.0 / batch},
                    num_epoch=1,
                    batch_end_callback=mx.callback.TelemetryLogger(1))
            if ctx.device_type == "gpu":
                torch.cuda.synchronize()
        finally:
            os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
        snap = mod.telemetry_snapshot()
        steps = collections.defaultdict(set)
        for sp in tel.recent_spans():
            cx = sp["ctx"] or {}
            if "nbatch" in cx and sp["name"] in tel.FIT_PHASE_SPANS:
                steps[(cx["epoch"], cx["nbatch"])].add(sp["name"])
        assert sorted(steps) == [(0, 0), (0, 1)], sorted(steps)
        for names in steps.values():
            assert {"fit_batch", "feed", "step"} <= names, names
        c = snap["counters"]
        if not fused:
            assert c["kvstore.push"] == 2 and c["kvstore.pull"] == 2, c
        out["fused" if fused else "phase_split"] = {
            "spans_by_step": {"%d:%d" % k: sorted(v)
                              for k, v in sorted(steps.items())},
            "kvstore_push": c.get("kvstore.push", 0),
            "kvstore_pull": c.get("kvstore.pull", 0),
            "host_ms_by_span": {k: v["total_ms"] for k, v in
                                snap["spans"].items()
                                if k in tel.FIT_PHASE_SPANS},
            "dispatches": {k: v for k, v in c.items()
                           if k.startswith("dispatch.")},
            "card_flops": {k: cd["flops"] for k, cd in
                           snap["programs"].items()}}
        out["snapshot_keys"] = sorted(snap)
    emit({"observability_fit": dict(out, card=card, batch=batch,
                                    note="the fused step subsumes the "
                                         "store; the phase-split step "
                                         "pushes and pulls through it")})
    # forwards: the deferred-init one, 2 batches fused, 2 phase-split
    return 5


def observability_phase(mx, ctx, rehearsal, card):
    """The serving path's instruments and controls: telemetry, its cost,
    autotune, faults and the flight recorder, mx.profiler (serving),
    then decode and Module.fit. Returns the K1 launches of the phase's
    forwards (16 per full-width forward, counted from the card)."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    gpu = ctx.device_type == "gpu"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # -- the main path: counts zeroed just before, read just after --------
    K.launches = K.bwd_launches = 0
    _, forwards, n_tails = _obs_serving(mx, ctx, rehearsal, card, tmp)
    _obs_decode(mx, ctx, rehearsal, card)
    forwards += _obs_fit(mx, ctx, rehearsal, card)
    launches, bwd = K.launches, K.bwd_launches
    # ---------------------------------------------------------------------
    expect = forwards * n_tails if gpu else 0
    # the fit's 4 batches (2 fused, 2 phase-split) are the only backwards
    bwd_expect = 4 * n_tails if gpu else 0
    emit({"observability_k1": {"forwards": forwards, "tails": n_tails,
                               "launches": launches, "expected": expect,
                               "bwd_launches": bwd,
                               "bwd_expected": bwd_expect}})
    assert launches == expect, (launches, expect)
    assert bwd == bwd_expect, (bwd, bwd_expect)
    _K1_BWD["observability"] += bwd
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    mx.layout.set_default_layout(None)
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# dense_prediction: FCN-16s on VGG-16 through Module.fit, the rest of the
# Module toolbox (slice 10)
# ---------------------------------------------------------------------------

_VGG16_LAYERS = (2, 2, 3, 3, 3)
# Long, Shelhamer and Darrell (CVPR 2015) at PASCAL VOC's 21 classes; the
# rehearsal (and tests/test_torch_fcn.py) cut the widths by 16
_FCN = {False: dict(widths=(64, 128, 256, 512, 512), fc=4096, classes=21,
                    hw=384, batch=8, epochs=2, batches=4, step1_batch=1,
                    params=134815994),
        True: dict(widths=(4, 8, 16, 32, 32), fc=64, classes=5, hw=64,
                   batch=2, epochs=2, batches=3, step1_batch=1,
                   params=None)}
_FCN_SEED = 23
_FCN_OPT = (("learning_rate", 1e-3), ("momentum", 0.9), ("wd", 5e-4))


def fcn16s_symbol(mx, classes, widths=(64, 128, 256, 512, 512), fc=4096,
                  p=0.5, head=True):
    """examples/fcn-xs/fcn_xs.py:23-50's FCN-16s pattern (score head at
    /32, a 2x Deconvolution cropped onto the /16 skip score and added, a
    16x Deconvolution cropped onto the input) over the VGG-16 body of
    examples/image-classification/symbols/vgg.py:19-28 (``CONFIGS[16]``,
    the copy ``_ic_vgg`` above), with the FCN paper's head: ``fc6`` a 7x7
    pad-3 convolution to ``fc`` channels, ``fc7`` 1x1, ReLU and Dropout
    after each, ``score_fr`` and ``score_pool4`` 1x1 to ``classes``,
    ``upscore2`` 4/2 and ``upscore16`` 32/16 without bias, the crops at
    offsets 1 and 8. ``head`` adds the per-pixel loss over VOC labels
    (255 void, normalised by the valid pixels); without it the symbol
    ends at the cropped scores."""
    data = mx.sym.Variable("data")
    net, pool4 = data, None
    for stage, (n, f) in enumerate(zip(_VGG16_LAYERS, widths)):
        for i in range(n):
            name = "%d_%d" % (stage + 1, i + 1)
            net = mx.sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                                     num_filter=f, name="conv" + name)
            net = mx.sym.Activation(net, act_type="relu", name="relu" + name)
        net = mx.sym.Pooling(net, pool_type="max", kernel=(2, 2),
                             stride=(2, 2), name="pool%d" % (stage + 1))
        if stage == 3:
            pool4 = net
    for name, k, pad in (("6", 7, 3), ("7", 1, 0)):
        net = mx.sym.Convolution(net, kernel=(k, k), pad=(pad, pad),
                                 num_filter=fc, name="fc" + name)
        net = mx.sym.Activation(net, act_type="relu", name="relu" + name)
        net = mx.sym.Dropout(net, p=p, name="drop" + name)
    score_fr = mx.sym.Convolution(net, kernel=(1, 1), num_filter=classes,
                                  name="score_fr")
    score_pool4 = mx.sym.Convolution(pool4, kernel=(1, 1),
                                     num_filter=classes, name="score_pool4")
    upscore2 = mx.sym.Deconvolution(score_fr, kernel=(4, 4), stride=(2, 2),
                                    num_filter=classes, no_bias=True,
                                    name="upscore2")
    fuse = mx.sym.Crop(upscore2, score_pool4, offset=(1, 1),
                       name="score_pool4c") + score_pool4
    upscore16 = mx.sym.Deconvolution(fuse, kernel=(32, 32), stride=(16, 16),
                                     num_filter=classes, no_bias=True,
                                     name="upscore16")
    score = mx.sym.Crop(upscore16, data, offset=(8, 8), name="score")
    if not head:
        return score
    return mx.sym.SoftmaxOutput(score, multi_output=True, use_ignore=True,
                                ignore_label=255, normalization="valid",
                                name="softmax")


def fcn_init(mx):
    """The FCN's initializer: ``mx.init.Mixed`` of bilinear upsampling
    kernels for ``upscore*`` and Xavier (magnitude 2) elsewhere. The
    bilinear kernel goes on the channel diagonal only (class c upsamples
    class c), as upstream example/fcn-xs/init_fcnxs.py places it:
    ``mx.init.Bilinear`` alone fills every (in, out) channel pair with
    the same kernel, and then the upsampling's backward sums ``p - onehot``
    over the classes, which is 0 at every pixel: the body's gradient would
    be rounding noise."""
    class DiagonalBilinear(mx.init.Bilinear):
        def _init_weight(self, name, arr):
            super()._init_weight(name, arr)
            w = np.array(arr.asnumpy())
            keep = np.zeros(w.shape[:2], bool)
            keep[np.arange(min(w.shape[:2])), np.arange(min(w.shape[:2]))] \
                = True
            w[~keep] = 0
            arr[:] = w

    return mx.init.Mixed(["upscore.*", ".*"],
                         [DiagonalBilinear(), mx.init.Xavier(magnitude=2)])


def fcn_data(seed, n, hw, classes):
    """examples/fcn-xs/fcn_xs.py:53-65's images (copied: a class
    rectangle per image, the class written into its pixels), with a void
    band (label 255) of ``max(1, hw // 64)`` pixels each side of every
    rectangle's edge, as VOC marks object boundaries."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(0, 0.2, (n, 3, hw, hw)).astype(np.float32)
    y = np.zeros((n, hw, hw), np.float32)
    b = max(1, hw // 64)
    for i in range(n):
        cls = rs.randint(1, classes)
        h0, w0 = rs.randint(0, hw // 2, 2)
        h1 = h0 + rs.randint(hw // 4, hw // 2)
        w1 = w0 + rs.randint(hw // 4, hw // 2)
        y[i, h0:h1, w0:w1] = cls
        x[i, :, h0:h1, w0:w1] += cls / float(classes)
        ring = np.zeros((hw, hw), bool)
        ring[max(h0 - b, 0):h1 + b, max(w0 - b, 0):w1 + b] = True
        ring[h0 + b:h1 - b, w0 + b:w1 - b] = False
        y[i][ring] = 255
    return x, y


def seq_module_parts(mx, ctx):
    """examples/module/seq_module.py:38-77 (copied): the host hinge
    gradient and the stage builders, on ``ctx``."""
    def mc_hinge_grad(scores, labels):
        scores = scores.asnumpy()
        labels = labels.asnumpy().astype(int)
        n, _ = scores.shape
        grad = np.zeros_like(scores)
        for i in range(n):
            margin = 1.0 + scores[i] - scores[i, labels[i]]
            margin[labels[i]] = 0.0
            pred = int(margin.argmax())
            if margin[pred] > 0:
                grad[i, labels[i]] -= 1.0
                grad[i, pred] += 1.0
        return grad / n

    def feature_module():
        data = mx.sym.Variable("data")
        fc1 = mx.sym.FullyConnected(data, name="fc1", num_hidden=128)
        act1 = mx.sym.Activation(fc1, name="relu1", act_type="relu")
        return mx.mod.Module(act1, label_names=[], context=ctx)

    def head_module():
        data = mx.sym.Variable("data")
        fc2 = mx.sym.FullyConnected(data, name="fc2", num_hidden=64)
        act2 = mx.sym.Activation(fc2, name="relu2", act_type="relu")
        fc3 = mx.sym.FullyConnected(act2, name="fc3", num_hidden=10)
        sm = mx.sym.SoftmaxOutput(fc3, name="softmax")
        return mx.mod.Module(sm, context=ctx)

    return mc_hinge_grad, feature_module, head_module


def seq_module_data(mx):
    """seq_module.py:31-35 and 155-163 (copied): 10 Gaussian prototypes of
    64 features, 1024 training samples, batch 64, shuffled (numpy's
    global state, seeded here)."""
    rs = np.random.RandomState(7)
    protos = rs.normal(0, 1.0, (10, 64)).astype(np.float32)
    y = rs.randint(0, 10, 1024).astype(np.float32)
    x = protos[y.astype(int)] + 0.25 * rs.normal(size=(1024, 64)).astype(
        np.float32)
    np.random.seed(5)
    return mx.io.NDArrayIter(x, y, batch_size=64, shuffle=True,
                             label_name="softmax_label")


def vae_symbol(mx, ndim=24, nhid=32, nz=4):
    """examples/vae/vae.py:23-38 (copied): encoder, reparameterised
    sample from a fed ``eps``, decoder, a MakeLoss head beside the
    BlockGrad'ed reconstruction."""
    data = mx.sym.Variable("data")
    eps = mx.sym.Variable("eps")
    h = mx.sym.FullyConnected(data, num_hidden=nhid, name="enc1")
    h = mx.sym.Activation(h, act_type="tanh")
    mu = mx.sym.FullyConnected(h, num_hidden=nz, name="mu")
    logvar = mx.sym.FullyConnected(h, num_hidden=nz, name="logvar")
    z = mu + mx.sym.exp(0.5 * logvar) * eps
    d = mx.sym.FullyConnected(z, num_hidden=nhid, name="dec1")
    d = mx.sym.Activation(d, act_type="tanh")
    y = mx.sym.FullyConnected(d, num_hidden=ndim, name="dec2")
    rec = mx.sym.sum(mx.sym.square(y - data), axis=1)
    kl = -0.5 * mx.sym.sum(1 + logvar - mx.sym.square(mu)
                           - mx.sym.exp(logvar), axis=1)
    loss = mx.sym.MakeLoss(mx.sym.mean(rec + 0.1 * kl), name="vae_loss")
    return mx.sym.Group([loss, mx.sym.BlockGrad(y)])


def autoencoder_symbol(mx, dims=(32, 24, 8)):
    """examples/autoencoder/autoencoder.py:16-25 (copied): an MLP
    encoder and decoder trained on reconstruction with
    LinearRegressionOutput (the data is the label)."""
    data = mx.sym.Variable("data")
    x = data
    for i, d in enumerate(dims[1:]):
        x = mx.sym.FullyConnected(x, num_hidden=d, name="enc%d" % i)
        x = mx.sym.Activation(x, act_type="relu")
    for i, d in enumerate(reversed(dims[:-1])):
        x = mx.sym.FullyConnected(x, num_hidden=d, name="dec%d" % i)
        if i < len(dims) - 2:
            x = mx.sym.Activation(x, act_type="relu")
    return mx.sym.LinearRegressionOutput(x, data, name="rec")



_FCN_OPTIMIZERS = (
    ("sgld", dict(learning_rate=1e-4)),
    ("dcasgd", dict(learning_rate=1e-3, momentum=0.9)),
    ("adagrad", dict(learning_rate=1e-3)),
    ("rmsprop", dict(learning_rate=1e-4)),
    ("rmsprop", dict(learning_rate=1e-4, centered=True)),
    ("adadelta", dict()),
    ("ftrl", dict(learning_rate=1e-2)),
    ("test", dict()),
    ("ccsgd", dict(learning_rate=1e-3, momentum=0.9)),
    ("adamax", dict(learning_rate=2e-4)),
    ("nadam", dict(learning_rate=1e-4)),
)
_FUSED_KERNELS = ("rmsprop", "adagrad", "adadelta", "ftrl")


def _keeping_monitor(mx, *args, **kwargs):
    """A ``Monitor`` whose ``toc_print`` (what ``fit`` calls) keeps the
    rows in ``rows``."""
    mon = mx.mon.Monitor(*args, **kwargs)
    mon.rows = []
    mon.toc_print = lambda: mon.rows.extend(mon.toc())
    return mon


def _fcn_macs(cfg):
    """Multiply-accumulates of one image's forward, reckoned from the
    shapes: the 3x3 convolutions, fc6/fc7, the scores and the two
    transposed convolutions (each input pixel times its kernel)."""
    hw, c_in, macs = cfg["hw"], 3, 0
    for n, f in zip(_VGG16_LAYERS, cfg["widths"]):
        for _ in range(n):
            macs += hw * hw * 9 * c_in * f
            c_in = f
        hw //= 2
    k = cfg["classes"]
    macs += hw * hw * (49 * c_in * cfg["fc"] + cfg["fc"] * cfg["fc"]
                       + cfg["fc"] * k)
    macs += (2 * hw) ** 2 * c_in * k            # score_pool4
    macs += hw * hw * 16 * k * k                # upscore2
    up = 2 * hw                                 # the fused /16 map
    macs += up * up * 32 * 32 * k * k           # upscore16
    return macs


def _fcn_iter(mx, x, y, batch):
    return mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)


def _fcn_fit(mx, sym, ctx, arg0, it, num_epoch, mod=None, **kw):
    """``Module.fit`` of the FCN from the weights ``arg0`` with the
    paper's SGD (lr 1e-3, momentum 0.9, wd 5e-4) and pixel accuracy."""
    if mod is None:
        mod = mx.mod.Module(sym, context=ctx)
    mod.fit(it, optimizer="sgd", optimizer_params=_FCN_OPT,
            arg_params=arg0, initializer=fcn_init(mx), num_epoch=num_epoch,
            eval_metric="acc", **kw)
    return mod


def _fcn_states(mod):
    import pickle
    return pickle.loads(mod._updater.get_states())


def _fcn_forward_leg(mx, cfg, ctx, arg0, x, card):
    """(a) the forward against the CPU's; (f) SymbolBlock over the
    symbol without its loss head, bit-equal to the Module's forward."""
    gpu = ctx.device_type == "gpu"
    score = fcn16s_symbol(mx, cfg["classes"], cfg["widths"], cfg["fc"],
                          p=0.5, head=False)
    xb = x[:2]

    def forward(c):
        mod = mx.mod.Module(score, label_names=[], context=c)
        mod.bind([mx.io.DataDesc("data", xb.shape)], for_training=False)
        mod.init_params(arg_params=arg0)
        mod.forward(mx.io.DataBatch([mx.nd.array(xb, ctx=mx.cpu())], None),
                    is_train=False)
        return mod.get_outputs()[0]._data
    got = forward(ctx)
    want = forward(mx.cpu()) if gpu else got
    err, rel = _rel_to_max(got.cpu(), want)
    blk = mx.gluon.SymbolBlock(score, mx.sym.var("data"))
    mx.weights.load_into_block(blk, {k: v.numpy() for k, v in arg0.items()},
                               ctx=ctx)
    xin = mx.nd.array(xb, ctx=ctx)
    eager = blk(xin)._data
    blk.hybridize()
    hyb = blk(xin)._data
    bit = bool(torch.equal(eager, got) and torch.equal(hyb, got))
    emit({"dense_prediction_forward": {
        "card": card, "rows": 2, "logits_max_abs_err": err,
        "logits_err_over_largest": rel, "tolerance": 1e-3,
        "symbol_block_bit_equal_eager_and_hybridized": bit}})
    assert rel <= 1e-3 and bit, (rel, bit)
    del blk, eager, hyb, got, want


def _fcn_train_leg(mx, cfg, sym, ctx, arg0, x, y, card, tmp):
    """(b) fit: ms per batch, a profiled batch, peaks per epoch; (c) the
    same fit preempted by SIGTERM at epoch 1 batch 2 and resumed in a
    fresh Module: parameters and optimizer states bit-equal. Returns the
    per-batch ms."""
    import signal
    gpu = ctx.device_type == "gpu"
    batch, nb = cfg["batch"], cfg["batches"]
    log = _BatchLog(None, gpu)
    handlers = [signal.getsignal(s) for s in (signal.SIGTERM,
                                              signal.SIGINT)]
    mx.random.seed(_FCN_SEED)
    mod = mx.mod.Module(sym, context=ctx)
    log.mod = mod
    ref_mgr = mx.CheckpointManager(os.path.join(tmp, "ref"), keep_last=2)
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _fcn_fit(mx, sym, ctx, arg0, _fcn_iter(mx, x, y, batch),
             cfg["epochs"], mod=mod, checkpoint=ref_mgr,
             batch_end_callback=log, epoch_end_callback=log.epoch_end)
    fit_s = time.perf_counter() - t0
    ev, wall = log.ms_per_batch(nb)
    ref_params, ref_states = _host_params(mod)[0], _fcn_states(mod)
    ref_counts = dict(mod._optimizer._index_update_count)
    acc = dict(mod.score(_fcn_iter(mx, x, y, batch), "acc"))
    one = mx.io.DataBatch([mx.nd.array(x[:batch], ctx=mx.cpu())],
                          [mx.nd.array(y[:batch], ctx=mx.cpu())])
    prof = profile_forward(lambda: mod.fused_step(one), reps=2) if gpu \
        else None
    step_flops = [c["flops"] for c in mx.telemetry.programs().values()
                  if c["kind"] == "train_step" and c["flops"]]
    del mod
    _free(gpu)
    # (c) preempted at epoch 1 batch 2, resumed in a fresh Module
    mgr = mx.CheckpointManager(os.path.join(tmp, "pre"), keep_last=2)

    def preempt(param):
        if (param.epoch, param.nbatch) == (1, 1):
            os.kill(os.getpid(), signal.SIGTERM)
    mx.random.seed(_FCN_SEED)
    try:
        _fcn_fit(mx, sym, ctx, arg0, _fcn_iter(mx, x, y, batch),
                 cfg["epochs"], checkpoint=mgr, batch_end_callback=preempt)
        raise AssertionError("SIGTERM did not preempt fit")
    except mx.checkpoint.TrainingPreempted as e:
        where = (e.epoch, e.nbatch)
    restored = [signal.getsignal(s) for s in (signal.SIGTERM,
                                              signal.SIGINT)] == handlers
    meta = mgr.latest()
    sizes = {ext: os.path.getsize("%s-%04d.%s" % (mgr.prefix,
                                                   meta["epoch"], ext))
             for ext in ("params", "states", "meta.json")}
    _free(gpu)
    mx.random.seed(_FCN_SEED + 1)       # the checkpoint's state must win
    t0 = time.perf_counter()
    res = _fcn_fit(mx, sym, ctx, arg0, _fcn_iter(mx, x, y, batch),
                   cfg["epochs"], resume=True,
                   checkpoint=mx.CheckpointManager(mgr.prefix, keep_last=2))
    resume_s = time.perf_counter() - t0
    params, states = _host_params(res)[0], _fcn_states(res)
    bit_params = _bit_equal(params, ref_params)
    bit_states = sorted(states) == sorted(ref_states) and all(
        np.array_equal(states[k], ref_states[k]) for k in ref_states)
    counts_equal = dict(res._optimizer._index_update_count) == ref_counts
    del res
    _free(gpu)
    emit({"dense_prediction_fit": {
        "card": card, "batch": batch, "hw": cfg["hw"],
        "classes": cfg["classes"], "epochs": cfg["epochs"],
        "batches_per_epoch": nb, "fit_s": fit_s,
        "ms_per_batch_cuda_events": ev, "ms_per_batch_host": wall,
        "pixel_accuracy_after": acc, "peak_bytes_per_epoch": log.peaks,
        "train_step_card_flops": step_flops,
        "flops_reckoned": 3 * 2 * _fcn_macs(cfg) * batch,
        "profiled_batch": prof}})
    emit({"dense_prediction_resume": {
        "card": card, "preempted_at": where, "handlers_restored": restored,
        "checkpoint_bytes": sizes, "resume_fit_s": resume_s,
        "params_bit_equal": bit_params, "states_bit_equal": bit_states,
        "update_counts_equal": counts_equal}})
    assert all(np.isfinite(v.numpy()).all() for v in ref_params.values())
    if gpu:
        assert log.peaks[1] <= log.peaks[0], log.peaks
    assert where == (1, 2) and restored, (where, restored)
    assert bit_params and bit_states and counts_equal, \
        (bit_params, bit_states, counts_equal)
    return ev


def _fcn_divergence_leg(mx, cfg, sym, ctx, arg0, x, y, card, tmp):
    """(d) ``dispatch:nan`` at the 3rd batch of epoch 1 with
    ``divergence_check_every=1``: halt raises, rollback restores epoch
    0's checkpoint and finishes finite, skip counts and goes on."""
    gpu = ctx.device_type == "gpu"
    at = cfg["batches"] + 3
    out = {}
    for policy in ("halt", "rollback", "skip"):
        mx.telemetry.reset()
        mx.faults.configure("dispatch:nan:n=%d" % at)
        mgr = mx.CheckpointManager(os.path.join(tmp, "div_" + policy), 2)
        try:
            mod = _fcn_fit(mx, sym, ctx, arg0,
                           _fcn_iter(mx, x, y, cfg["batch"]), cfg["epochs"],
                           checkpoint=mgr, divergence_check_every=1,
                           divergence_policy=policy)
            finite = all(np.isfinite(v.numpy()).all()
                         for v in _host_params(mod)[0].values())
            raised = False
            del mod
        except mx.checkpoint.DivergenceError:
            finite, raised = None, True
        finally:
            fired = mx.faults.counts().get("dispatch", {}).get("fired")
            mx.faults.clear()
        c = mx.telemetry.counters()
        out[policy] = {"raised": raised, "params_finite": finite,
                       "fault_fired": fired,
                       "detected": c.get("divergence.detected", 0),
                       "skipped": c.get("divergence.skipped", 0),
                       "rolled_back": c.get("divergence.rollback", 0)}
        _free(gpu)
    emit({"dense_prediction_divergence": {"card": card, "fault_at_step": at,
                                          "policies": out}})
    assert out["halt"]["raised"] and out["halt"]["detected"] == 1, out
    assert not out["rollback"]["raised"] and out["rollback"]["params_finite"]
    assert out["rollback"]["rolled_back"] == 1, out
    assert not out["skip"]["raised"] and out["skip"]["skipped"] == 1, out
    assert all(v["fault_fired"] == 1 for v in out.values()), out


def _fcn_step(mx, sym0, ctx, arg0, x, y, dtype, monitor=None):
    """One fit step at Dropout 0 in ``dtype`` (with ``monitor`` installed
    it phase-splits): (module, weights after on the host)."""
    tdt = getattr(torch, dtype)
    mod = mx.mod.Module(sym0, context=ctx)
    mod.bind([mx.io.DataDesc("data", x.shape, dtype)],
             [mx.io.DataDesc("softmax_label", y.shape, dtype)])
    mod.init_params(arg_params={k: v.to(tdt) for k, v in arg0.items()})
    it = _fcn_iter(mx, x.astype(dtype), y.astype(dtype), x.shape[0])
    _fcn_fit(mx, sym0, ctx, None, it, 1, mod=mod, monitor=monitor)
    return mod, _host_params(mod)[0]


def _fcn_monitor_step1_leg(mx, cfg, ctx, arg0, x, y, card):
    """(e) Monitor on the deconvolutions through ``fit(monitor=)`` on the
    card and the CPU (1e-4 relative; the fused step falls back with the
    ``monitor`` code); (b)'s step-1 gate on the same step, with fp64
    steps on both devices. Returns the card module (its gradients feed
    the optimizer leg)."""
    gpu = ctx.device_type == "gpu"
    sym0 = fcn16s_symbol(mx, cfg["classes"], cfg["widths"], cfg["fc"], p=0.0)
    n = cfg["step1_batch"]
    xs, ys = x[:n], y[:n]
    mx.telemetry.reset()
    mon = _keeping_monitor(mx, 1, pattern=".*upscore.*", sort=True)
    mod, w_card = _fcn_step(mx, sym0, ctx, arg0, xs, ys, "float32", mon)
    fallbacks = mx.telemetry.counters().get("fused_fallback.monitor", 0)
    code = getattr(mod._fused_fallback_reason, "code", None)
    if gpu:
        mon_cpu = _keeping_monitor(mx, 1, pattern=".*upscore.*", sort=True)
        _, w_cpu = _fcn_step(mx, sym0, mx.cpu(), arg0, xs, ys, "float32",
                             mon_cpu)
        _, w64_card = _fcn_step(mx, sym0, ctx, arg0, xs, ys, "float64")
        _free(gpu)
        _, w64 = _fcn_step(mx, sym0, mx.cpu(), arg0, xs, ys, "float64")
        rows_cpu = mon_cpu.rows
        ok, gate = _step1_gate(w_card, w64_card, w_cpu, w64, arg0)
    else:
        rows_cpu, ok, gate = mon.rows, True, None
    names = [r[1] for r in mon.rows]
    stat_rel = max(abs(float(a[2]) - float(b[2])) / abs(float(b[2]))
                   for a, b in zip(mon.rows, rows_cpu))
    emit({"dense_prediction_monitor": {
        "card": card, "rows": [[r[1], float(r[2])] for r in mon.rows],
        "max_rel_to_cpu": stat_rel, "tolerance": 1e-4,
        "fallback_code": code, "fused_fallback.monitor": fallbacks}})
    emit({"dense_prediction_step1": {"card": card, "batch": n,
                                     "dropout": 0, "within_gate": ok,
                                     "gate": gate}})
    assert names == ["upscore16_output", "upscore16_weight",
                     "upscore2_output", "upscore2_weight"], names
    assert [r[1] for r in rows_cpu] == names
    assert stat_rel <= 1e-4 and code == "monitor" and fallbacks == 1, \
        (stat_rel, code, fallbacks)
    assert ok, gate
    return mod


def _sample_idx(names, params, k=4096):
    g = torch.Generator().manual_seed(_FCN_SEED)
    return {n: (torch.randperm(params[n].numel(), generator=g)[:k]
                if params[n].numel() > k else
                torch.arange(params[n].numel())) for n in names}


def _opt_run(mx, name, kw, names, ws, gs, fused):
    """3 updates of every parameter by optimizer ``name``: through
    ``FusedUpdater.update_batch`` where ``fused``, else per parameter."""
    opt = mx.optimizer.create(name, param_idx2name=dict(enumerate(names)),
                              wd=5e-4, **kw)
    upd = mx.optimizer.get_updater(opt) if fused \
        else mx.optimizer.Updater(opt)
    for _ in range(3):
        if fused:
            upd.update_batch(list(range(len(names))), gs, ws)
        else:
            for i, (g, w) in enumerate(zip(gs, ws)):
                upd(i, g, w)
    return upd


def _fcn_optimizer_leg(mx, ctx, mod, arg0, card):
    """(g) each new optimizer: 3 updates of the full FCN from one card
    backward's gradients, against the same updates on CPU fp64 copies of
    sampled elements (4096 per tensor; every rule is elementwise):
    within 1e-5 relative (the JAX package's optimizer tests) plus 1e-6 of
    the tensor's largest; SGLD's noise by its mean and variance."""
    NDArray = mx.nd.NDArray
    names = list(mod._param_names)
    grads = {n: mod._exec.grad_dict[n]._data for n in names}
    idx = _sample_idx(names, arg0)
    dev = grads[names[0]].device
    rows = {}
    for name, kw in _FCN_OPTIMIZERS:
        fused = name in _FUSED_KERNELS and not kw.get("centered")
        ws = [NDArray(arg0[n].to(dev, copy=True), ctx) for n in names]
        gs = [NDArray(grads[n], ctx) for n in names]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _opt_run(mx, name, kw, names, ws, gs, fused)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        got = {n: w._data.reshape(-1)[idx[n].to(dev)].double().cpu()
               for n, w in zip(names, ws)}
        del ws, gs
        cw = [NDArray(arg0[n].reshape(-1)[idx[n]].double(), mx.cpu())
              for n in names]
        cg = [NDArray(grads[n].reshape(-1)[idx[n].to(dev)].double().cpu(),
                      mx.cpu()) for n in names]
        key = "%s%s" % (name, "_centered" if kw.get("centered") else "")
        if name == "sgld":
            lr, wd = kw["learning_rate"], 5e-4
            resid = []
            for n, w, g in zip(names, cw, cg):
                det = w._data.clone()
                mult = 0.0 if not n.endswith("_weight") else 1.0
                for _ in range(3):
                    det = det - lr / 2 * (g._data + mult * wd * det)
                resid.append(got[n] - det)
            r = torch.cat(resid)
            var_ratio = float(r.var() / (3 * lr))
            mean_sigmas = float(r.mean().abs() / (3 * lr / r.numel()) ** 0.5)
            rows[key] = {"noise_var_over_3lr": var_ratio,
                         "noise_mean_in_sigmas": mean_sigmas,
                         "card_s": card_s, "route": "per parameter"}
            continue
        cupd = mx.optimizer.Updater(mx.optimizer.create(
            name, param_idx2name=dict(enumerate(names)), wd=5e-4, **kw))
        for i, w in enumerate(cw):        # fp64 states on the CPU side
            st = cupd.optimizer.create_state_multi_precision(i, w)
            cupd.states[i] = _to_f64(mx, st)
            cupd.states_synced[i] = True
        for _ in range(3):
            for i, (g, w) in enumerate(zip(cg, cw)):
                cupd(i, g, w)
        worst, nans = 0.0, 0
        for n, w in zip(names, cw):
            ref, val = w._data, got[n]
            nan = torch.isnan(ref)
            if not torch.equal(nan, torch.isnan(val)):
                worst = float("inf")
                continue
            nans += int(nan.sum())
            ref, val = ref[~nan], val[~nan]
            if ref.numel() == 0:
                continue
            top = float(ref.abs().max())
            bound = 1e-5 * ref.abs() + 1e-6 * top
            worst = max(worst, float(((val - ref).abs() / bound).max()))
        rows[key] = {"worst_err_over_tolerance": worst, "nan_elements": nans,
                     "card_s": card_s,
                     "route": "fused kernel" if fused else "per parameter"}
    emit({"dense_prediction_optimizers": {"card": card, "updates": 3,
                                          "sampled_per_tensor": 4096,
                                          "optimizers": rows}})
    for key, r in rows.items():
        if key == "sgld":
            assert abs(r["noise_var_over_3lr"] - 1) < 0.03 and \
                r["noise_mean_in_sigmas"] < 4, r
        else:
            assert r["worst_err_over_tolerance"] <= 1.0, (key, r)


def _to_f64(mx, st):
    if st is None:
        return None
    if isinstance(st, tuple):
        return tuple(_to_f64(mx, s) for s in st)
    return mx.nd.NDArray(st._data.double(), st.context)


def _card_vs_cpu(mx, run, ctx):
    """``run(ctx)`` -> {name: host tensor} on the card and on the CPU:
    the largest gap of any tensor over its largest |value|."""
    got = run(ctx)
    return _max_scaled(got, run(mx.cpu()))


def _seq_leg(mx, python_loss):
    """examples/module/seq_module.py:79-118 (copied): the SequentialModule
    of a feature stage and a softmax head, or of the feature stage and a
    PythonLossModule with the host hinge gradient; the first 4 batches of
    an epoch (16 batches of the softmax head's summed gradient, lr 0.02,
    leave the card 8.1e-4 of the largest weight from the CPU: ReLU units
    near zero flip)."""
    def run(ctx):
        hinge, feature, head = seq_module_parts(mx, ctx)
        mod = mx.mod.SequentialModule()
        mod.add(feature())
        if python_loss:
            mod.add(mx.mod.PythonLossModule(grad_func=hinge),
                    take_labels=True, auto_wiring=True)
        else:
            mod.add(head(), take_labels=True, auto_wiring=True)
        mod.fit(mx.io.ResizeIter(seq_module_data(mx), 4),
                optimizer_params={"learning_rate": 0.1 if python_loss
                                  else 0.02},
                initializer=mx.initializer.Xavier(), num_epoch=1)
        return _host_params(mod)[0]
    return run


def _vae_leg(mx):
    """examples/vae/vae.py:54-84 (copied, 2 epochs): MakeLoss + BlockGrad
    heads, Adam 1e-2, forward/backward/update by hand."""
    def run(ctx):
        rs = np.random.RandomState(0)
        basis = rs.normal(size=(4, 24)).astype(np.float32)
        codes = rs.normal(size=(768, 4)).astype(np.float32)
        x = codes @ basis + 0.05 * rs.normal(size=(768, 24)).astype(
            np.float32)
        mod = mx.mod.Module(vae_symbol(mx), data_names=["data", "eps"],
                            label_names=[], context=ctx)
        it = mx.io.NDArrayIter({"data": x, "eps": rs.normal(
            size=(768, 4)).astype(np.float32)}, batch_size=64)
        mod.bind(data_shapes=it.provide_data)
        mod.init_params(mx.initializer.Xavier())
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 1e-2})
        for _ in range(2):
            it = mx.io.NDArrayIter({"data": x, "eps": rs.normal(
                size=(768, 4)).astype(np.float32)}, batch_size=64)
            for batch in it:
                mod.forward(batch, is_train=True)
                mod.backward()
                mod.update()
        return _host_params(mod)[0]
    return run


def _autoencoder_leg(mx):
    """examples/autoencoder/autoencoder.py:33-60 (copied, 2 epochs):
    LinearRegressionOutput against the data, Adam 1e-2."""
    def run(ctx):
        rs = np.random.RandomState(0)
        basis = rs.normal(size=(4, 32)).astype(np.float32)
        codes = rs.normal(size=(512, 4)).astype(np.float32)
        x = codes @ basis + 0.05 * rs.normal(size=(512, 32)).astype(
            np.float32)
        np.random.seed(0)
        it = mx.io.NDArrayIter(x, x[:, 0], batch_size=64, shuffle=True)
        mod = mx.mod.Module(autoencoder_symbol(mx), data_names=["data"],
                            label_names=[], context=ctx)
        mod.bind(data_shapes=it.provide_data)
        mod.init_params(mx.initializer.Xavier())
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 1e-2})
        for _ in range(2):
            it.reset()
            for batch in it:
                mod.forward(batch, is_train=True)
                mod.backward()
                mod.update()
        return _host_params(mod)[0]
    return run


_GLUON_BLOCKS = (
    ("Conv1DTranspose", lambda nn: nn.Conv1DTranspose(
        8, 3, strides=2, output_padding=1, prefix="ct1_"), (4, 6, 33)),
    ("Conv2DTranspose", lambda nn: nn.Conv2DTranspose(
        16, 4, strides=2, padding=1, prefix="ct2_"), (4, 8, 24, 24)),
    ("Conv3DTranspose", lambda nn: nn.Conv3DTranspose(
        4, 2, strides=2, prefix="ct3_"), (2, 4, 6, 6, 6)),
    ("InstanceNorm", lambda nn: nn.InstanceNorm(scale=True, prefix="in_"),
     (4, 8, 16, 16)),
    ("LayerNorm", lambda nn: nn.LayerNorm(prefix="ln_"), (8, 32, 64)),
    ("LeakyReLU", lambda nn: nn.LeakyReLU(0.1, prefix="lr_"), (8, 64)),
    ("Lambda", lambda nn: nn.Lambda("tanh", prefix="la_"), (8, 64)),
    ("HybridLambda", lambda nn: nn.HybridLambda(
        lambda F, x: F.LeakyReLU(x, act_type="elu", slope=0.5),
        prefix="hl_"), (8, 64)),
)


def _gluon_block_leg(mx, ctx, hybridize):
    """Each new ``gluon.nn`` block's forward and backward, with its
    parameters and input from one seed."""
    def run_block(make, shape):
        def run(c):
            blk = make(mx.gluon.nn)
            blk.initialize(mx.init.Xavier(), ctx=c)
            x = mx.nd.array(np.random.RandomState(3).uniform(
                -1, 1, shape).astype(np.float32), ctx=c)
            blk(x)              # finish deferred shapes
            if hybridize and isinstance(blk, mx.gluon.HybridBlock):
                blk.hybridize()
            x.attach_grad()
            with mx.autograd.record():
                out = blk(x)
            head = np.random.RandomState(4).uniform(-1, 1, out.shape)
            out.backward(mx.nd.array(head.astype(np.float32), ctx=c))
            res = {"out": out._data.detach().cpu(),
                   "dx": x.grad._data.cpu()}
            for k, p in blk.collect_params().items():
                if p.grad_req != "null":
                    res[k] = p.grad()._data.cpu()
            return res
        return run
    return {name: _card_vs_cpu(mx, run_block(make, shape), ctx)
            for name, make, shape in _GLUON_BLOCKS}


def _fcn_module_legs(mx, ctx, card):
    """(h) the Module and Gluon legs at their examples' own sizes, the
    card against the CPU: the trained parameters within 1e-3 of each
    tensor's largest (§2's gate for a training path), each block's
    forward and gradients within 1e-4."""
    t0 = time.perf_counter()
    gaps = {"seq_module_softmax_head": _card_vs_cpu(mx, _seq_leg(mx, False),
                                                    ctx),
            "seq_module_python_loss": _card_vs_cpu(mx, _seq_leg(mx, True),
                                                   ctx),
            "vae": _card_vs_cpu(mx, _vae_leg(mx), ctx),
            "autoencoder": _card_vs_cpu(mx, _autoencoder_leg(mx), ctx)}
    blocks = {"eager": _gluon_block_leg(mx, ctx, False),
              "hybridized": _gluon_block_leg(mx, ctx, True)}
    emit({"dense_prediction_module_legs": {
        "card": card, "max_gap_over_largest": gaps, "gluon_blocks": blocks,
        "tolerance": {"trained_parameters": 1e-3, "blocks": 1e-4},
        "s": time.perf_counter() - t0}})
    assert max(gaps.values()) <= 1e-3, gaps
    assert max(max(v.values()) for v in blocks.values()) <= 1e-4, blocks


def dense_prediction_phase(mx, ctx, rehearsal, card):
    """FCN-16s on VGG-16 through ``Module.fit`` (a)-(g), then the Module
    and Gluon legs (h). Returns the K1-K3 launches of the path (0: it
    has no hand-written kernel)."""
    gpu = ctx.device_type == "gpu"
    cfg = _FCN[rehearsal]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _free(gpu)
    from mxnet_tpu_torch.kernels import fused_bn as K1
    from mxnet_tpu_torch.kernels import flash_attention as FA
    sym = fcn16s_symbol(mx, cfg["classes"], cfg["widths"], cfg["fc"], p=0.5)
    n = cfg["batches"] * cfg["batch"]
    x, y = fcn_data(_FCN_SEED, n, cfg["hw"], cfg["classes"])
    init = mx.mod.Module(sym, context=mx.cpu())
    init.bind([mx.io.DataDesc("data", (1,) + x.shape[1:])],
              [mx.io.DataDesc("softmax_label", (1,) + y.shape[1:])],
              for_training=False)
    init.init_params(fcn_init(mx))
    arg0 = _host_params(init)[0]
    del init
    n_params = sum(v.numel() for v in arg0.values())
    emit({"dense_prediction_model": {
        "card": card, "parameters": n_params, "batch": cfg["batch"],
        "input": [3, cfg["hw"], cfg["hw"]], "classes": cfg["classes"],
        "void_label": 255, "widths": cfg["widths"], "fc": cfg["fc"]}})
    if cfg["params"] is not None:
        assert n_params == cfg["params"], n_params
    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- the main path: counts zeroed just before, read just after ----
        K1.launches = K1.bwd_launches = FA.fwd_launches = FA.bwd_launches = 0
        t = time.perf_counter()
        _fcn_forward_leg(mx, cfg, ctx, arg0, x, card)
        legs["forward"], t = time.perf_counter() - t, time.perf_counter()
        _fcn_train_leg(mx, cfg, sym, ctx, arg0, x, y, card, tmp)
        legs["fit_and_resume"], t = time.perf_counter() - t, \
            time.perf_counter()
        _fcn_divergence_leg(mx, cfg, sym, ctx, arg0, x, y, card, tmp)
        legs["divergence"], t = time.perf_counter() - t, time.perf_counter()
        mod = _fcn_monitor_step1_leg(mx, cfg, ctx, arg0, x, y, card)
        legs["monitor_and_step1"], t = time.perf_counter() - t, \
            time.perf_counter()
        _fcn_optimizer_leg(mx, ctx, mod, arg0, card)
        del mod
        _free(gpu)
        legs["optimizers"], t = time.perf_counter() - t, time.perf_counter()
        _fcn_module_legs(mx, ctx, card)
        legs["module_and_gluon"] = time.perf_counter() - t
        counts = _kernel_counts()
        _k1_bwd("dense_prediction")
        # -----------------------------------------------------------------
    emit({"dense_prediction": {
        "card": card, "leg_s": legs, "k1_launches": counts[0],
        "k2_launches": counts[1], "k3_launches": counts[2],
        "note": "no hand-written kernel on this path: the JAX package "
                "runs it through XLA; cuDNN (convolutions and their "
                "transposes), cuBLAS and ATen do its work"}})
    assert counts == (0, 0, 0), counts
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    torch.backends.cudnn.deterministic = det
    _free(gpu)
    return counts


# -- data parallelism across worker processes ---------------------------------

_DP_WORLD = 2
_DP_LEG_S = {False: 150, True: 120}     # one leg's hard limit in a worker
_DP_LAUNCH_S = {False: 420, True: 300}  # one launch's, the launcher's own
_DP_LR, _DP_MOMENTUM, _DP_WD = 0.05, 0.9, 1e-4
_DP_MODULE_LEGS = ("dist_sync", "2bit", "fp16", "dist_sync_split",
                   "dist_async")


def _dp_cfg(rehearsal):
    """Sizes of the phase: ResNet-50 v1 at batch 32 per worker (1 epoch
    of 3 batches), the LM at bench.py:991-992's width with 4 rows per
    worker (3 steps), the Gluon loop at 32 per worker (3 steps); the
    rehearsal takes the small nets of the other phases."""
    if rehearsal:
        return {"batch": 4, "epochs": 1, "batches": 3, "lm": (64, 32, 4, 16),
                "lm_batch": 4, "lm_steps": 3, "gluon_steps": 3}
    return {"batch": 32, "epochs": 1, "batches": 3, "lm": (8192, 512, 8, 512),
            "lm_batch": 8, "lm_steps": 3, "gluon_steps": 3}


def _digest(tensors):
    """sha256 of the tensors' bytes in name order: equal digests are equal
    bits."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().to("cpu").contiguous().numpy()
                 .tobytes())
    return h.hexdigest()


def _dp_module_digest(mod):
    """(digest of the weights, digest of the moving stats)."""
    arg, aux = mod.get_params()
    return (_digest({k: v._data for k, v in arg.items()}),
            _digest({k: v._data for k, v in aux.items()}))


def _dp_moving(k):
    """A BatchNorm moving statistic (Gluon's name for it)."""
    return "running_" in k


def _dp_local(a, rank, batch):
    """This worker's rows of every global batch of ``batch * world``."""
    g = batch * _DP_WORLD
    idx = np.concatenate([np.arange(i + rank * batch, i + (rank + 1) * batch)
                          for i in range(0, len(a), g)])
    return a[idx]


def _dp_opt(global_batch):
    return {"learning_rate": _DP_LR, "momentum": _DP_MOMENTUM, "wd": _DP_WD,
            "rescale_grad": 1.0 / global_batch}


def _dp_collective_steps(step, rank, gpu, reps=1):
    """``step`` run 1 + ``reps`` times on every worker (each call is a
    collective); rank 0 profiles its calls (``profile_forward``)."""
    if rank == 0 and gpu:
        return profile_forward(step, reps=reps)
    for _ in range(1 + reps):
        step()
    return None


def _dp_module_leg(mx, ctx, cfg, sym, arg, aux, hw, classes, rank, kv_type,
                   compression, out, tag, epochs, profile=False, fused=True):
    """``Module.fit`` in a worker: ``kv_type`` (with ``compression``),
    batch ``cfg['batch']`` of the global batch, ``epochs`` epochs of
    ``cfg['batches']`` batches from ``arg``/``aux``, phase-split with
    ``MXNET_MODULE_FUSED_STEP=0`` unless ``fused``. Writes rank 0's
    step-1 parameters, each rank's step-1 gradients (with compression)
    under ``out``; returns the leg's record."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    gpu = ctx.device_type == "gpu"
    batch, nb = cfg["batch"], cfg["batches"]
    x, y = _module_data(nb, batch * _DP_WORLD, hw, classes)
    x, y = _dp_local(x, rank, batch), _dp_local(y, rank, batch)
    mod = mx.mod.Module(sym, context=ctx, compression_params=compression)
    mod.bind(data_shapes=[("data", (batch, hw, hw, 3))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params=arg, aux_params=aux)
    kv = mx.kv.create(kv_type)
    mod.init_optimizer(kvstore=kv, optimizer="sgd",
                       optimizer_params=_dp_opt(batch * _DP_WORLD))
    metric = mx.metric.create(["acc", "ce"])
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    snap, digests, aux_digests, events = {}, [], [], []

    def batch_end(param):
        if gpu:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        if param.epoch == 0 and param.nbatch == 0:
            snap["ce"] = param.eval_metric.get_metric(1).get()[1]
            if rank == 0:
                torch.save({k: v._data.cpu() for k, v in
                            mod.get_params()[0].items()},
                           os.path.join(out, "%s-step1.pt" % tag))
            if compression:
                torch.save({n: mod._exec.grad_dict[n]._data.cpu()
                            for n in mod._param_names},
                           os.path.join(out, "%s-grad1-r%d.pt"
                                        % (tag, rank)))

    def epoch_end(*_):
        d_arg, d_aux = _dp_module_digest(mod)
        digests.append(d_arg)
        aux_digests.append(d_aux)

    mx.telemetry.reset()
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts zeroed just before, read just after --------
    pin = os.environ.get("MXNET_MODULE_FUSED_STEP")
    if not fused:
        os.environ["MXNET_MODULE_FUSED_STEP"] = "0"
    K.launches = K.bwd_launches = 0
    t0 = time.perf_counter()
    mod.fit(it, eval_metric=metric, num_epoch=epochs,
            batch_end_callback=batch_end, epoch_end_callback=epoch_end)
    if gpu:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, bwd = K.launches, K.bwd_launches
    # ---------------------------------------------------------------------
    if pin is None:
        os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
    else:
        os.environ["MXNET_MODULE_FUSED_STEP"] = pin
    spans = mx.telemetry.span_stats()
    reason = mod._fused_fallback_reason
    n = epochs * nb
    rec = {"leg": tag, "kvstore": kv_type, "compression": compression,
           "rank": rank, "batch": batch, "global_batch": batch * _DP_WORLD,
           "batches": n, "epoch_digests": digests,
           "aux_digests": aux_digests, "step1_ce": snap["ce"],
           "metric": metric.get_name_value(), "k1_launches": launches,
           "k1_bwd_launches": bwd, "k1_expected": 16 * n if gpu else 0,
           "fallback": getattr(reason, "code", None),
           "wire_bytes_per_batch": kv.wire_bytes_last_push,
           "wire_bytes_raw_per_batch": kv.wire_bytes_last_push_raw,
           "kv_push_span": spans.get("kv_push"),
           "fit_batch_span": spans.get("fit_batch"),
           "parameters": sum(int(np.prod(v.shape)) for v in arg.values()),
           "fit_wall_s": wall}
    if gpu:
        # the first batch of each epoch binds and warms up: CUDA events
        # from the end of batch 1 to the end of the last, per batch
        rec["ms_per_batch"] = events[0].elapsed_time(events[-1]) \
            / (len(events) - 1)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    if profile:
        data = mx.io.DataBatch([mx.nd.array(x[:batch], ctx=ctx)],
                               [mx.nd.array(y[:batch], ctx=ctx)])
        rec["profiled_batch"] = _dp_collective_steps(
            lambda: mod.fused_step(data), rank, gpu)
    del mod
    _free(gpu)
    return rec


def _dp_module_group(mx, ctx, cfg, rank, out, rehearsal):
    """Legs (a)-(c) in one worker: ResNet-50 v1 through ``Module.fit``
    on ``dist_sync`` (the fused step), 2-bit, fp16, ``dist_sync``
    phase-split and ``dist_async`` stores."""
    net, sym, hw, classes = _resnet_net(mx, ctx, rehearsal)
    aux_names = set(sym.list_auxiliary_states())
    params = {k: p.data()._data.clone() for k, p in
              net.collect_params().items()}
    del net
    arg = {k: v for k, v in params.items() if k not in aux_names}
    aux = {k: v for k, v in params.items() if k in aux_names}
    recs = {"init_digest": _digest(params)}
    for tag, kv_type, comp, epochs, prof in (
            ("dist_sync", "dist_sync", None, cfg["epochs"], True),
            ("2bit", "dist_sync", {"type": "2bit", "threshold": 0.5}, 1,
             False),
            ("fp16", "dist_sync", {"type": "fp16"}, 1, False),
            ("dist_sync_split", "dist_sync", None, cfg["epochs"], False),
            ("dist_async", "dist_async", None, cfg["epochs"], False)):
        with _dp_deadline(rehearsal, tag):
            recs[tag] = _dp_module_leg(mx, ctx, cfg, sym, arg, aux, hw,
                                       classes, rank, kv_type, comp, out,
                                       tag, epochs, profile=prof,
                                       fused=tag != "dist_sync_split")
    with _dp_deadline(rehearsal, "fp64_step1"):
        w64 = _dp_module_fp64_step(mx, ctx, cfg, rehearsal, rank)
        if rank == 0:
            torch.save(w64, os.path.join(out, "module-fp64-step1.pt"))
        del w64
        _free(ctx.device_type == "gpu")
    mx.layout.set_default_layout(None)
    return recs


def _dp_lm_leg(mx, ctx, cfg, rank, out):
    """(d) The LM through ``SPMDTrainer`` on a ``dp`` mesh of the
    workers: ``cfg['lm_batch']`` rows in all, Ulysses at sp 1."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.kernels import flash_attention as FA
    gpu = ctx.device_type == "gpu"
    vocab, embed, heads, seq = cfg["lm"]
    gb, steps = cfg["lm_batch"], cfg["lm_steps"]
    mesh = parallel.make_mesh({"dp": -1, "sp": 1, "tp": 1}, devices=[ctx])
    assert mesh.shape["dp"] == _DP_WORLD and mesh.is_process_spanning

    def attn(q, k, v):
        return parallel.ulysses_attention(q, k, v, mesh, axis_name="sp",
                                          batch_axis_name="dp", causal=True)
    spec = parallel.P("dp", "sp")
    tr = parallel.SPMDTrainer(
        _lm_apply(attn, gb // _DP_WORLD, seq, heads, embed),
        _lm_params(vocab, embed), mesh, data_axis="dp", tp_axis="tp",
        learning_rate=0.1, momentum=0.9, batch_specs=[spec, spec])
    batches = _dp_lm_batches(vocab, gb, seq, steps)
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts zeroed just before, read just after --------
    FA.fwd_launches = FA.bwd_launches = 0
    losses, ms, wall = _timed_steps(lambda: float(tr.step(*batches.pop(0))),
                                    steps, gpu)
    launches = {"fwd": FA.fwd_launches, "bwd": FA.bwd_launches}
    # ---------------------------------------------------------------------
    params = tr.get_params()
    if rank == 0:
        np.savez(os.path.join(out, "lm-params.npz"), **params)
    rec = {"leg": "lm_spmd", "rank": rank, "global_batch": gb,
           "local_batch": gb // _DP_WORLD, "steps": steps, "losses": losses,
           "digest": _digest({k: torch.from_numpy(v)
                              for k, v in params.items()}),
           "kernel_launches": launches,
           "expected": {"fwd": steps, "bwd": steps} if gpu
           else {"fwd": 0, "bwd": 0}}
    if gpu:
        rec.update({"step_ms": ms, "step_wall_ms": wall,
                    "peak_bytes": torch.cuda.max_memory_allocated()})
    del tr
    _free(gpu)
    return rec


def _dp_lm_batches(vocab, gb, seq, steps):
    return [(np.random.RandomState(1 + i).randint(0, vocab, (gb, seq))
             .astype(np.int32),
             np.random.RandomState(101 + i).randint(0, vocab, (gb, seq))
             .astype(np.int32)) for i in range(steps)]


def _dp_gluon_data(batch, hw, classes):
    rs = np.random.RandomState(0)
    g = batch * _DP_WORLD
    return (rs.uniform(-1, 1, (g, hw, hw, 3)).astype(np.float32),
            rs.randint(0, classes, g).astype(np.float32))


def _dp_gluon_step(mx, net, tr, X, Y, global_batch):
    L = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = L(net(X), Y)
    loss.backward()
    tr.step(global_batch)
    return float(loss.mean().asscalar())


def _dp_gluon_split_step(mx, net, tr, Xs, Ys, global_batch):
    """The two workers' Gluon step in one process: each worker's rows
    through the net on their own (BatchNorm over those rows, as a
    worker's Trainer on a dist store takes them in the JAX package and
    here), the gradients summed by one backward, one update at the
    global batch. Returns the mean of the workers' losses."""
    L = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        losses = [L(net(X), Y) for X, Y in zip(Xs, Ys)]
    mx.autograd.backward(losses)
    tr.step(global_batch)
    return float(np.mean([float(l.mean().asscalar()) for l in losses]))


def _dp_halves(x, batch, ctx, mx, dtype="float32"):
    """The global batch's rows of each worker, as NDArrays on ``ctx``."""
    return [mx.nd.array(x[r * batch:(r + 1) * batch], ctx=ctx, dtype=dtype)
            for r in range(_DP_WORLD)]


def _dp_gluon_leg(mx, ctx, cfg, rank, out, rehearsal):
    """(e) The Gluon loop on ``resnet50_v1`` with
    ``gluon.Trainer(kvstore="dist_sync")``: rank 1's weights seeded apart
    on purpose (rank 0's must win), ``cfg['gluon_steps']`` steps of
    ``cfg['batch']`` rows per worker (BatchNorm over those rows, the
    moving stats each worker's own), then a resume from step 2 through
    ``save_states``/``load_states``."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    gpu = ctx.device_type == "gpu"
    batch, steps = cfg["batch"], cfg["gluon_steps"]
    net, _, hw, classes = _resnet_net(mx, ctx, rehearsal, seed=rank)
    x, y = _dp_gluon_data(batch, hw, classes)
    rows = slice(rank * batch, (rank + 1) * batch)
    X, Y = mx.nd.array(x[rows], ctx=ctx), mx.nd.array(y[rows], ctx=ctx)
    params = net.collect_params()
    own = _digest({k: p.data()._data for k, p in params.items()})

    def weights(d):
        return {k: v for k, v in d.items() if not _dp_moving(k)}
    opt = {"learning_rate": _GLUON_LR, "momentum": _GLUON_MOMENTUM}
    K.launches = 0
    tr = mx.gluon.Trainer(params, "sgd", dict(opt), kvstore="dist_sync")
    start = _digest({k: p.data()._data for k, p in params.items()})
    if rank == 0:
        torch.save({k: p.data()._data.cpu() for k, p in params.items()},
                   os.path.join(out, "gluon-start.pt"))
    g = batch * _DP_WORLD
    losses, mid, fname = [], None, os.path.join(out, "gluon-r%d.states"
                                                 % rank)
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts zeroed just before, read just after --------
    K.launches = K.bwd_launches = 0
    for i in range(steps):
        if i == steps - 1:
            tr.save_states(fname)
            mid = {k: p.data()._data.clone() for k, p in params.items()}
        loss, ms, wall = _timed_steps(
            lambda: _dp_gluon_step(mx, net, tr, X, Y, g), 1, gpu)
        losses += loss
        if i == 0 and rank == 0:
            torch.save({k: p.data()._data.cpu() for k, p in params.items()},
                       os.path.join(out, "gluon-step1.pt"))
    launches, bwd = K.launches, K.bwd_launches
    # ---------------------------------------------------------------------
    end = {k: p.data()._data.clone() for k, p in params.items()}
    if rank == 0:
        torch.save({k: v.cpu() for k, v in end.items()},
                   os.path.join(out, "gluon-end.pt"))
    # the resume: the step-2 weights into the net, a new Trainer loads
    # the states saved there, the last step again
    with torch.no_grad():
        for k, p in params.items():
            p.data()._data.copy_(mid[k])
    tr2 = mx.gluon.Trainer(params, "sgd", dict(opt), kvstore="dist_sync")
    tr2.load_states(fname)
    _dp_gluon_step(mx, net, tr2, X, Y, g)
    resumed = {k: p.data()._data for k, p in params.items()}
    rec = {"leg": "gluon", "rank": rank, "batch": batch, "global_batch": g,
           "steps": steps, "losses": losses,
           "own_init_digest": own, "start_digest": start,
           "end_digest": _digest(weights(end)),
           "moving_digest": _digest({k: v for k, v in end.items()
                                     if _dp_moving(k)}),
           "resumed_bit_equal": _digest(resumed) == _digest(end),
           "resumed_num_update": tr2._optimizer.num_update,
           "k1_launches": launches, "k1_bwd_launches": bwd,
           "k1_expected": 16 * steps if gpu else 0}
    if gpu:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    del net, tr, tr2, mid, end
    mx.layout.set_default_layout(None)
    _free(gpu)
    return rec


@contextlib.contextmanager
def _dp_deadline(rehearsal, leg):
    """A hard limit on one leg in a worker: past it every thread's stack
    is printed and the worker exits nonzero (so the launcher stops the
    other)."""
    import faulthandler
    print("dp worker: leg %s" % leg, file=sys.stderr, flush=True)
    faulthandler.dump_traceback_later(_DP_LEG_S[rehearsal], exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def dp_worker(group, out, rehearsal, sp_dir=None):
    """One worker of the data_parallel phase (``chip_smoke.py
    --dp-worker GROUP DIR``, started by ``python -m mxnet_tpu_torch.launch
    -n 2``): the legs of ``group`` (``module``: (a)-(c); ``lm_gluon``: (d)
    and (e); ``all``: both, in that order); writes ``G-r<rank>.json``
    under ``out`` for each group G. With ``sp_dir`` (``--sp-dir``) the
    same workers then run the sparse phase's two-worker leg there."""
    import mxnet_tpu_torch as mx
    rank = mx.dist.rank()
    assert mx.dist.process_count() == _DP_WORLD, mx.dist.process_count()
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = _dp_cfg(rehearsal)
    for g in (("module", "lm_gluon") if group == "all" else (group,)):
        if ctx.device_type == "gpu":
            torch.cuda.reset_peak_memory_stats()
        res = {"rank": rank, "backend": mx.dist.backend(),
               "backend_reason": mx.dist.backend_reason(),
               "world": mx.dist.process_count(), "pid": os.getpid()}
        if g == "module":
            res["legs"] = _dp_module_group(mx, ctx, cfg, rank, out,
                                           rehearsal)
        else:
            with _dp_deadline(rehearsal, "lm"):
                lm = _dp_lm_leg(mx, ctx, cfg, rank, out)
            with _dp_deadline(rehearsal, "gluon"):
                res["legs"] = {"lm": lm, "gluon": _dp_gluon_leg(
                    mx, ctx, cfg, rank, out, rehearsal)}
            with _dp_deadline(rehearsal, "gluon_fp64_steps"):
                w64 = _dp_gluon_fp64_steps(mx, ctx, cfg, rehearsal, rank)
                if rank == 0:
                    torch.save(w64, os.path.join(out,
                                                 "gluon-fp64-steps.pt"))
                del w64
        if ctx.device_type == "gpu":
            res["peak_bytes"] = torch.cuda.max_memory_allocated()
        with open(os.path.join(out, "%s-r%d.json" % (g, rank)), "w") as f:
            json.dump(res, f)
    if sp_dir:
        with _dp_deadline(rehearsal, "sparse"):
            _sp_worker_leg(mx, sp_dir, rehearsal)
    mx.dist.finalize()


def _dp_launch(group, out, rehearsal, sp_dir=None):
    """Run ``group`` in 2 workers through the port's launcher under its
    hard timeout; raises when a worker fails, hangs or the launcher
    does. Returns the workers' records of each group run (``all``: the
    module group's, then lm_gluon's), rank order, and the seconds."""
    limit = _DP_LAUNCH_S[rehearsal] + (_SP_CARRY_S if sp_dir else 0)
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
           str(_DP_WORLD), "--timeout", str(limit)]
    if rehearsal:
        cmd.append("--force-cpu")
    cmd += ["--", sys.executable, os.path.abspath(__file__), "--dp-worker",
            group, out] + (["--cpu-rehearsal"] if rehearsal else []) \
        + (["--sp-dir", sp_dir] if sp_dir else [])
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=here, capture_output=True,
                         text=True, timeout=limit + 60)
    secs = time.perf_counter() - t0
    sys.stderr.write(res.stderr[-20000:])
    assert res.returncode == 0, ("data_parallel %s workers failed" % group,
                                 res.returncode)
    recs = []
    for g in (("module", "lm_gluon") if group == "all" else (group,)):
        recs.append([])
        for r in range(_DP_WORLD):
            with open(os.path.join(out, "%s-r%d.json" % (g, r))) as f:
                recs[-1].append(json.load(f))
    return recs, secs


def _dp_noise(k):
    """A conv bias ahead of a BatchNorm: its gradient is zero in exact
    arithmetic, so after a step its value is rounding noise on both
    sides (``_module_leg`` holds it to the largest weight)."""
    return "conv" in k and k.endswith("_bias")


def _dp_scaled(got, ref):
    """(largest |got - ref| of a tensor over that tensor's largest |ref|,
    conv biases ahead of BatchNorm left out; their largest error over the
    largest |ref| of all tensors)."""
    largest = max(float(v.float().abs().max()) for v in ref.values())
    per = _max_scaled({k: v for k, v in got.items() if not _dp_noise(k)},
                      {k: v for k, v in ref.items() if not _dp_noise(k)})
    noise = max([float((got[k].float() - v.float()).abs().max()) / largest
                 for k, v in ref.items() if _dp_noise(k)] or [0.0])
    return per, noise


def _dp_fp64_net(mx, ctx, rehearsal, seed=0):
    """The unfused ``resnet50_v1`` from the same seed, for the fp64
    arbiter steps, with a map from its parameter names to the fused
    net's (by position: same shapes, same Xavier draws)."""
    fused, _, _, _ = _resnet_net(mx, ctx, rehearsal, seed=seed)
    fp = [(k, tuple(p.shape)) for k, p in fused.collect_params().items()]
    del fused
    net, sym, hw, classes = _resnet_net(mx, ctx, rehearsal, seed=seed,
                                        fused=False)
    up = [(k, tuple(p.shape)) for k, p in net.collect_params().items()]
    assert [s for _, s in fp] == [s for _, s in up], "layouts differ"
    return net, sym, hw, classes, {u: f for (u, _), (f, _) in zip(up, fp)}


def _dp_module_fp64_step(mx, ctx, cfg, rehearsal, rank=None, mesh=None):
    """``_dp_module_reference``'s step 1 in fp64 on the unfused net: one
    process at the global batch (``rank`` None, a ``device`` store), a
    ``Module`` over the mesh ``mesh`` (its keyword arguments) of the
    workers at the global batch, or this worker's rows on ``dist_sync``.
    Returns the parameters after it under the fused net's names."""
    net, sym, hw, classes, rename = _dp_fp64_net(mx, ctx, rehearsal)
    aux_names = set(sym.list_auxiliary_states())
    params = {k: p.data()._data.double() for k, p in
              net.collect_params().items()}
    del net
    g = cfg["batch"] * _DP_WORLD
    x, y = _module_data(cfg["batches"], g, hw, classes)
    x, y = x[:g], y[:g]
    if rank is not None:
        rows = slice(rank * cfg["batch"], (rank + 1) * cfg["batch"])
        x, y = x[rows], y[rows]
    mod = mx.mod.Module(sym, context=ctx, **(mesh or {}))
    mod.bind([mx.io.DataDesc("data", x.shape, "float64")],
             [mx.io.DataDesc("softmax_label", y.shape, "float64")])
    mod.init_params(arg_params={k: v for k, v in params.items()
                                if k not in aux_names},
                    aux_params={k: v for k, v in params.items()
                                if k in aux_names})
    mod.init_optimizer(kvstore="device" if mesh else mx.kv.create(
        "device" if rank is None else "dist_sync"), optimizer="sgd",
        optimizer_params=_dp_opt(g))
    assert mod.fused_step(mx.io.DataBatch(
        [mx.nd.array(x, ctx=ctx, dtype="float64")],
        [mx.nd.array(y, ctx=ctx, dtype="float64")]))
    out = {rename[k]: v._data.to("cpu", copy=True)
           for k, v in mod.get_params()[0].items()}
    del mod
    mx.layout.set_default_layout(None)
    return out


def _dp_gluon_fp64_steps(mx, ctx, cfg, rehearsal, rank=None):
    """The Gluon loop's ``cfg['gluon_steps']`` steps in fp64 on the
    unfused net (``rank`` None: one process, ``_dp_gluon_split_step``;
    else this worker's rows over a ``dist_sync`` Trainer, rank 1 seeded
    apart). Returns the weights after each step under the fused net's
    names (the moving stats left out)."""
    net, _, hw, classes, rename = _dp_fp64_net(mx, ctx, rehearsal,
                                               seed=rank or 0)
    net.cast("float64")
    batch = cfg["batch"]
    x, y = _dp_gluon_data(batch, hw, classes)
    Xs = _dp_halves(x, batch, ctx, mx, "float64")
    Ys = _dp_halves(y, batch, ctx, mx, "float64")
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": _GLUON_LR,
                           "momentum": _GLUON_MOMENTUM},
                          kvstore=None if rank is None else "dist_sync")
    steps = []
    for _ in range(cfg["gluon_steps"]):
        if rank is None:
            _dp_gluon_split_step(mx, net, tr, Xs, Ys, batch * _DP_WORLD)
        else:
            _dp_gluon_step(mx, net, tr, Xs[rank], Ys[rank],
                           batch * _DP_WORLD)
        steps.append({rename[k]: p.data()._data.to("cpu", copy=True)
                      for k, p in net.collect_params().items()
                      if not _dp_moving(rename[k])})
    del net, tr, Xs, Ys
    mx.layout.set_default_layout(None)
    return steps


def _dp_fp64_steps_gate(card64, one64, w0):
    """The workers' fp64 steps (``card64``, one dict per step) against
    one process's (``one64``) from ``w0``: every tensor within 1e-6 of
    its largest update in that step plus 4 fp64 ulps of its largest
    value; a conv bias ahead of BatchNorm (``_dp_noise``, zero in exact
    arithmetic) within 1e-9 of the largest weight. Returns (ok, the worst
    error over its bound in each step)."""
    worst, prev = [], w0
    for got, ref in zip(card64, one64):
        largest = max(float(v.double().abs().max()) for v in ref.values())
        w = 0.0
        for k, r in ref.items():
            r = r.double()
            e = float((got[k].double() - r).abs().max())
            if _dp_noise(k):
                bound = 1e-9 * largest
            else:
                upd = float((r - prev[k].double()).abs().max())
                bound = 1e-6 * upd + 4 * _EPS64 * float(r.abs().max())
            w = max(w, e / max(bound, 1e-300))
        worst.append(w)
        prev = ref
    return all(w <= 1.0 for w in worst) and len(worst) == len(one64), worst


def _dp_gate(card, card64, one, one64, w0):
    """``_step1_gate`` of the two workers' step 1 (``card`` fp32,
    ``card64`` fp64) against one process's at the global batch (``one``,
    ``one64``: the arbiter), from ``w0``. The conv biases ahead of
    BatchNorm, zero in exact arithmetic (``_dp_noise``), are left to a
    check of their own: within 1e-3 of the largest weight in fp32 (as in
    ``_module_leg``) and 1e-9 in fp64. One step of this net is
    ill-conditioned in fp32 (a stage-4 convolution's update is a
    cancelling sum: one process's fp32 step is itself 0.21 of the update
    from its fp64 step on resnet50_v1 at batch 8 on the CPU), which is
    why the fp64 steps arbitrate. Returns (ok, report)."""
    keep = [k for k in one64 if not _dp_noise(k)]
    ok, rep = _step1_gate({k: card[k] for k in keep},
                          {k: card64[k] for k in keep},
                          {k: one[k] for k in keep},
                          {k: one64[k] for k in keep},
                          {k: w0[k] for k in keep})
    _, noise = _dp_scaled(card, one)
    _, noise64 = _dp_scaled(card64, one64)
    rep["conv_bias_err_over_largest_weight"] = [noise, noise64]
    return ok and noise <= 1e-3 and noise64 <= 1e-9, rep


def _dp_module_reference(mx, ctx, cfg, sym, arg, aux, hw, classes):
    """Step 1 of one process at the global batch on the card: the
    cross-entropy and the parameters after it."""
    batch = cfg["batch"] * _DP_WORLD
    x, y = _module_data(cfg["batches"], batch, hw, classes)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (batch, hw, hw, 3))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(kvstore=mx.kv.create("device"), optimizer="sgd",
                       optimizer_params=_dp_opt(batch))
    metric = mx.metric.create(["acc", "ce"])
    assert mod.fused_step(mx.io.DataBatch(
        [mx.nd.array(x[:batch], ctx=ctx)], [mx.nd.array(y[:batch], ctx=ctx)]),
        eval_metric=metric)
    out = (metric.get_metric(1).get()[1], _host_params(mod)[0])
    del mod
    return out


def _dp_compressed_recompute(mx, sym, arg, cfg, kind, out):
    """Rank 0's first update of the compressed leg ``kind`` recomputed by
    the port on the CPU from both workers' step-1 gradients: each
    quantised from a zero residual and dequantised, summed in rank
    order, then the store's SGD update (built as ``Module`` builds it:
    the symbol's wd multipliers). Returns (worst error over its bound,
    the tensor, the largest error over the tensor's largest update): the
    bound is 1e-6 of the update plus 2 fp32 ulps of the largest value
    (the card's elementwise update may fuse a multiply-add the CPU
    rounds twice)."""
    from mxnet_tpu_torch.gradient_compression import GradientCompression
    names = [n for n in sym.list_arguments()
             if n not in ("data", "softmax_label")]
    comp = GradientCompression(**({"type": "2bit", "threshold": 0.5}
                                  if kind == "2bit" else {"type": "fp16"}))
    grads = [torch.load(os.path.join(out, "%s-grad1-r%d.pt" % (kind, r)))
             for r in range(_DP_WORLD)]
    got = torch.load(os.path.join(out, "%s-step1.pt" % kind))
    summed, weights = [], []
    for n in names:
        total = torch.zeros(grads[0][n].shape)
        for r, g in enumerate(grads):
            total += comp.decompress(comp.compress((n, r), g[n]), g[n].shape)
        summed.append(mx.nd.array(total, ctx=mx.cpu()))
        weights.append(mx.nd.array(arg[n].cpu(), ctx=mx.cpu()))
    opt = mx.optimizer.create("sgd", sym=sym,
                              param_idx2name=dict(enumerate(names)),
                              **_dp_opt(cfg["batch"] * _DP_WORLD))
    mx.optimizer.get_updater(opt).update_batch(list(range(len(names))),
                                               summed, weights)
    worst, worst_k, over_upd = 0.0, None, 0.0
    for n, w in zip(names, weights):
        ref = w._data.double()
        upd = float((ref - arg[n].cpu().double()).abs().max())
        top = float(ref.abs().max())
        e = float((got[n].double() - ref).abs().max())
        r = e / (1e-6 * upd + 2 * _EPS32 * top + 1e-300)
        if r >= worst:
            worst, worst_k = r, n
        over_upd = max(over_upd, e / max(upd, 1e-30))
    return worst, worst_k, over_upd


def data_parallel_phase(mx, ctx, rehearsal, card, sp_dir=None):
    """Data parallelism across two worker processes on one card: every
    leg through ``python -m mxnet_tpu_torch.launch -n 2`` (both ranks on
    ``cuda:0``, gloo), against one process at the global batch on the
    card and the CPU. With ``sp_dir`` the workers then carry the sparse
    phase's two-worker leg (its gates are the sparse phase's). Returns
    the K1, K2 and K3 launches of the workers (both ranks)."""
    gpu = ctx.device_type == "gpu"
    cfg = _dp_cfg(rehearsal)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _free(gpu)
    t_phase = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        return _data_parallel(mx, ctx, rehearsal, card, cfg, gpu, out,
                              t_phase, sp_dir)
    finally:
        import shutil
        shutil.rmtree(out, ignore_errors=True)
        torch.backends.cudnn.deterministic = det
        mx.layout.set_default_layout(None)
        _free(gpu)


def _dp_references(mx, ctx, cfg, rehearsal):
    """One process at the global batch, on the card, before the workers
    start: ResNet-50's step 1 through ``Module`` (from the workers'
    seeded weights), the LM's steps, the Gluon loop's steps (each
    worker's rows on their own, as the workers' BatchNorm takes them)."""
    from mxnet_tpu_torch import parallel
    gpu = ctx.device_type == "gpu"
    ref = {}
    net, sym, hw, classes = _resnet_net(mx, ctx, rehearsal)
    aux_names = set(sym.list_auxiliary_states())
    params = {k: p.data()._data.to("cpu", copy=True)
              for k, p in net.collect_params().items()}
    ref["init_digest"] = _digest(params)
    ref["sym"], ref["hw"], ref["classes"] = sym, hw, classes
    ref["arg"] = {k: v for k, v in params.items() if k not in aux_names}
    aux = {k: v for k, v in params.items() if k in aux_names}
    ref["module_ce"], ref["module_step1"] = _dp_module_reference(
        mx, ctx, cfg, sym, ref["arg"], aux, hw, classes)
    _free(gpu)
    ref["gluon_w0"] = {k: v for k, v in params.items() if not _dp_moving(k)}
    # the Gluon loop from rank 0's weights: both workers' rows in one
    # process, each worker's on its own (``_dp_gluon_split_step``)
    batch, g = cfg["batch"], cfg["batch"] * _DP_WORLD
    x, y = _dp_gluon_data(batch, hw, classes)
    Xs, Ys = _dp_halves(x, batch, ctx, mx), _dp_halves(y, batch, ctx, mx)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": _GLUON_LR,
                           "momentum": _GLUON_MOMENTUM}, kvstore=None)
    ref["gluon_losses"] = []
    for i in range(cfg["gluon_steps"]):
        ref["gluon_losses"].append(_dp_gluon_split_step(mx, net, tr, Xs, Ys,
                                                        g))
        if i == 0:
            ref["gluon_step1"] = _host_copy(net.collect_params())
    ref["gluon_end"] = _host_copy(net.collect_params())
    del net, tr, Xs, Ys
    mx.layout.set_default_layout(None)
    _free(gpu)
    # the LM at the global batch
    vocab, embed, heads, seq = cfg["lm"]
    gb = cfg["lm_batch"]
    mesh = parallel.make_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=[ctx])

    def attn(q, k, v):
        return parallel.ulysses_attention(q, k, v, mesh, axis_name="sp",
                                          batch_axis_name="dp", causal=True)
    spec = parallel.P("dp", "sp")
    lm = parallel.SPMDTrainer(_lm_apply(attn, gb, seq, heads, embed),
                              _lm_params(vocab, embed), mesh, data_axis="dp",
                              tp_axis="tp", learning_rate=0.1, momentum=0.9,
                              batch_specs=[spec, spec])
    ref["lm_losses"] = [float(lm.step(x, y)) for x, y in
                        _dp_lm_batches(vocab, gb, seq, cfg["lm_steps"])]
    ref["lm_params"] = lm.get_params()
    del lm
    _free(gpu)
    # the fp64 arbiters of the two step-1 gates, on the unfused net
    ref["module64"] = _dp_module_fp64_step(mx, ctx, cfg, rehearsal)
    _free(gpu)
    ref["gluon64"] = _dp_gluon_fp64_steps(mx, ctx, cfg, rehearsal)
    _free(gpu)
    return ref


def _data_parallel(mx, ctx, rehearsal, card, cfg, gpu, out, t_phase,
                   sp_dir=None):
    ref = _dp_references(mx, ctx, cfg, rehearsal)
    ref_s = time.perf_counter() - t_phase
    (mod_recs, lg_recs), launch_s = _dp_launch("all", out, rehearsal,
                                                sp_dir)
    sym, arg = ref["sym"], ref["arg"]
    sizes = [int(np.prod(v.shape)) for v in arg.values()]
    n_params = sum(sizes)
    checks, legs = {}, {}
    for r, rec in enumerate(mod_recs + lg_recs):
        assert rec["backend"] == "gloo" and rec["world"] == _DP_WORLD, rec
    checks["workers_start_from_the_parent_weights"] = all(
        m["legs"]["init_digest"] == ref["init_digest"] for m in mod_recs)
    # (a)-(c): replicas bit-equal after every epoch, each leg's K1 count;
    # the moving stats equal on the fused step (BatchNorm over both
    # workers' rows) and each worker's own on the phase-split legs
    for tag in _DP_MODULE_LEGS:
        r0, r1 = (m["legs"][tag] for m in mod_recs)
        legs[tag] = {"rank0": r0, "rank1": {k: r1[k] for k in (
            "epoch_digests", "aux_digests", "k1_launches",
            "k1_bwd_launches", "ms_per_batch",
            "peak_bytes", "kv_push_span", "wire_bytes_per_batch")
            if k in r1}}
        checks["%s_replicas_bit_equal" % tag] = \
            r0["epoch_digests"] == r1["epoch_digests"]
        if tag == "dist_sync":
            checks["dist_sync_moving_stats_bit_equal"] = \
                r0["aux_digests"] == r1["aux_digests"]
        else:
            checks["%s_moving_stats_per_worker" % tag] = all(
                a != b for a, b in zip(r0["aux_digests"], r1["aux_digests"]))
        # 16 forward and 16 backward launches a training batch
        checks["%s_k1_launches" % tag] = all(
            r["k1_launches"] == r["k1_bwd_launches"] == r["k1_expected"]
            for r in (r0, r1))
        _K1_BWD["data_parallel"] += r0["k1_bwd_launches"] \
            + r1["k1_bwd_launches"]
    a0, a1 = (m["legs"]["dist_sync"] for m in mod_recs)
    checks["dist_sync_fused"] = a0["fallback"] is None
    checks["dist_sync_wire_bytes"] = \
        a0["wire_bytes_per_batch"] == a0["wire_bytes_raw_per_batch"] \
        == 4 * n_params
    # dist_async is dist_sync on the same (phase-split) path
    checks["dist_async_bit_equal_to_dist_sync_phase_split"] = all(
        m["legs"]["dist_async"][d] == m["legs"]["dist_sync_split"][d]
        for m in mod_recs for d in ("epoch_digests", "aux_digests"))
    checks["dist_sync_split_phase_split_env_pin"] = \
        mod_recs[0]["legs"]["dist_sync_split"]["fallback"] == "env_pin"
    ce = (a0["step1_ce"] + a1["step1_ce"]) / 2
    ce_rel = abs(ce - ref["module_ce"]) / abs(ref["module_ce"])
    got = torch.load(os.path.join(out, "dist_sync-step1.pt"))
    gate_ok, gate = _dp_gate(
        got, torch.load(os.path.join(out, "module-fp64-step1.pt")),
        ref["module_step1"], ref["module64"], arg)
    checks["dist_sync_step1_loss"] = ce_rel <= 1e-4
    checks["dist_sync_step1_gate"] = gate_ok
    comp = {}
    for kind, words in (("2bit", 4 * sum(-(-n // 16) for n in sizes)),
                        ("fp16", 2 * n_params)):
        c0 = mod_recs[0]["legs"][kind]
        worst, worst_k, over = _dp_compressed_recompute(mx, sym, arg, cfg,
                                                        kind, out)
        comp[kind] = {"wire_bytes": c0["wire_bytes_per_batch"],
                      "raw_bytes": c0["wire_bytes_raw_per_batch"],
                      "expected_wire_bytes": words,
                      "ratio": c0["wire_bytes_per_batch"]
                      / c0["wire_bytes_raw_per_batch"],
                      "fallback": c0["fallback"],
                      "recompute_err_over_bound": worst,
                      "recompute_worst_tensor": worst_k,
                      "recompute_err_over_update": over}
        checks["%s_wire" % kind] = (c0["wire_bytes_per_batch"] == words
                                    and c0["wire_bytes_raw_per_batch"]
                                    == 4 * n_params)
        checks["%s_phase_split_kvstore_dist" % kind] = \
            c0["fallback"] == "kvstore_dist"
        checks["%s_first_update_vs_cpu" % kind] = worst <= 1.0
    checks["dist_async_phase_split_kvstore_dist"] = \
        mod_recs[0]["legs"]["dist_async"]["fallback"] == "kvstore_dist"
    # (d) the LM
    l0, l1 = (m["legs"]["lm"] for m in lg_recs)
    lm_params = dict(np.load(os.path.join(out, "lm-params.npz")))
    lm_loss_rel = max(abs(a - b) / abs(b) for a, b in
                      zip(l0["losses"], ref["lm_losses"]))
    lm_param = _max_scaled({k: torch.from_numpy(v)
                            for k, v in lm_params.items()},
                           {k: torch.from_numpy(v)
                            for k, v in ref["lm_params"].items()})
    checks["lm_replicas_bit_equal"] = l0["digest"] == l1["digest"] \
        and l0["losses"] == l1["losses"]
    checks["lm_launches"] = all(r["kernel_launches"] == r["expected"]
                                for r in (l0, l1))
    checks["lm_vs_one_process"] = lm_loss_rel <= 1e-4 and lm_param <= 1e-4
    # (e) the Gluon loop
    e0, e1 = (m["legs"]["gluon"] for m in lg_recs)
    g_losses = [(a + b) / 2 for a, b in zip(e0["losses"], e1["losses"])]
    g_loss_rel = [abs(a - b) / abs(b)
                  for a, b in zip(g_losses, ref["gluon_losses"])]
    g_w0 = ref["gluon_w0"]
    g_card1 = {k: v for k, v in torch.load(
        os.path.join(out, "gluon-step1.pt")).items() if k in g_w0}
    g_ref1 = {k: v for k, v in ref["gluon_step1"].items() if k in g_w0}
    g_step1, g_noise1 = _dp_scaled(g_card1, g_ref1)
    g_card64 = torch.load(os.path.join(out, "gluon-fp64-steps.pt"))
    g_ok, g_gate = _dp_gate(g_card1, g_card64[0], g_ref1,
                            ref["gluon64"][0], g_w0)
    g64_ok, g64_worst = _dp_fp64_steps_gate(g_card64, ref["gluon64"], g_w0)
    g_end, g_noise = _dp_scaled(
        {k: v for k, v in torch.load(os.path.join(out, "gluon-end.pt"))
         .items() if k in g_w0},
        {k: v for k, v in ref["gluon_end"].items() if k in g_w0})
    checks["gluon_rank0_seeds_rank1"] = (
        e0["own_init_digest"] != e1["own_init_digest"]
        and e0["start_digest"] == e1["start_digest"]
        == e0["own_init_digest"])
    checks["gluon_replicas_bit_equal"] = e0["end_digest"] == e1["end_digest"]
    checks["gluon_moving_stats_per_worker"] = \
        e0["moving_digest"] != e1["moving_digest"]
    checks["gluon_resume_bit_equal"] = e0["resumed_bit_equal"] \
        and e1["resumed_bit_equal"]
    checks["gluon_k1_launches"] = all(
        r["k1_launches"] == r["k1_bwd_launches"] == r["k1_expected"]
        for r in (e0, e1))
    _K1_BWD["data_parallel"] += e0["k1_bwd_launches"] + e1["k1_bwd_launches"]
    checks["gluon_step1_loss"] = g_loss_rel[0] <= 1e-5
    checks["gluon_step1_gate"] = g_ok
    checks["gluon_fp64_steps_gate"] = g64_ok
    k1 = sum(m["legs"][t]["k1_launches"] for m in mod_recs
             for t in _DP_MODULE_LEGS) \
        + e0["k1_launches"] + e1["k1_launches"]
    k2 = l0["kernel_launches"]["fwd"] + l1["kernel_launches"]["fwd"]
    k3 = l0["kernel_launches"]["bwd"] + l1["kernel_launches"]["bwd"]
    emit({"data_parallel": {
        "card": card, "world": _DP_WORLD, "backend": mod_recs[0]["backend"],
        "backend_reason": mod_recs[0]["backend_reason"],
        "peak_bytes_per_rank": [[m.get("peak_bytes") for m in recs]
                                for recs in (mod_recs, lg_recs)],
        "seconds": {"references": ref_s, "launch": launch_s},
        "parameters": n_params,
        "module_legs": legs,
        "dist_sync_step1": {"ce_workers": ce, "ce_one_process":
                            ref["module_ce"], "ce_rel": ce_rel,
                            "gate": gate},
        "compressed": comp,
        "lm": {"rank0": l0, "rank1_losses": l1["losses"],
               "one_process_losses": ref["lm_losses"],
               "loss_rel": lm_loss_rel, "param_scaled": lm_param},
        "gluon": {"rank0": e0, "rank1": e1,
                  "one_process_losses": ref["gluon_losses"],
                  "loss_rel": g_loss_rel, "step1_gate": g_gate,
                  "fp64_steps_err_over_bound": g64_worst,
                  "step1_param_scaled": g_step1, "end_param_scaled": g_end,
                  "conv_bias_err_over_largest_weight": [g_noise1, g_noise],
                  "note": "the reference runs each worker's rows on their "
                          "own in one process; fp64 steps 1-3 and fp32 "
                          "step 1 are gated, fp32 steps 2-3 reported"},
        "launches": {"k1": k1, "k2": k2, "k3": k3},
        "checks": checks}})
    failed = sorted(k for k, v in checks.items() if not v)
    assert not failed, failed
    return k1, k2, k3


# -- model parallelism across worker processes (slice 12) ---------------------

_MP_WORLD = 4
_MP_STEPS = 3
_MP_LEG_S = {False: 240, True: 150}     # one leg's hard limit in a worker
_MP_LAUNCH_S = {False: 600, True: 400}  # the launch's, the launcher's own
# (tag, mesh axes, attention, K2 and K3 launches a rank a step)
_MP_LM_LEGS = (("ring", {"dp": 1, "sp": 2, "tp": 2}, "ring_attention",
                {"fwd": 2, "bwd": 0}),
               ("ulysses", {"dp": 2, "sp": 2}, "ulysses_attention",
                {"fwd": 1, "bwd": 1}))
_MP_MOE_CAPS = (("no_drop", float(_MP_WORLD)), ("drop", 1.25))


def _mp_cfg(rehearsal):
    """Sizes of the phase: the LM at the training phase's width (V 8192,
    E 512, 8 heads of 64, S 512, global batch 8); MoE at the LM's width
    (E 512, F 2048, 4 experts, tokens (8, 512, 512)); the pipeline at
    E 512, 8 microbatches of (2, 512, 512); the rehearsal at the tests'
    width."""
    if rehearsal:
        return {"lm": (64, 32, 4, 16), "lm_batch": 4,
                "moe": (16, 32, (8, 8)), "pipe": (16, 8, (2, 4))}
    return {"lm": (8192, 512, 8, 512), "lm_batch": 8,
            "moe": (512, 2048, (8, 512)), "pipe": (512, 8, (2, 512))}


def _mp_moe_inputs(cfg):
    """Tokens, a router that favours expert 3 (its row twice as large, so
    that capacity 1.25 drops tokens), the expert stacks, the output's
    cotangent."""
    e, f, (b, t) = cfg["moe"]
    rs = np.random.RandomState(3)
    favour = np.array([0.05] * (_MP_WORLD - 1) + [0.1], np.float32)
    return {"x": rs.randn(b, t, e).astype(np.float32) * 0.5,
            "wr": rs.randn(_MP_WORLD, e).astype(np.float32)
            * favour[:, None],
            "w1": rs.randn(_MP_WORLD, f, e).astype(np.float32) / e ** 0.5,
            "w2": rs.randn(_MP_WORLD, e, f).astype(np.float32) / f ** 0.5,
            "g": rs.randn(b, t, e).astype(np.float32)}


def _mp_pipe_inputs(cfg):
    e, n_micro, (b, t) = cfg["pipe"]
    rs = np.random.RandomState(4)
    return {"x": rs.randn(n_micro, b, t, e).astype(np.float32),
            "w": rs.randn(_MP_WORLD, e, e).astype(np.float32) / e ** 0.5,
            "b": rs.randn(_MP_WORLD, e).astype(np.float32) * 0.1,
            "g": rs.randn(n_micro, b, t, e).astype(np.float32)}


def _mp_stage(p, mb):
    return torch.tanh(mb @ p["w"] + p["b"])


def _mp_steps(step, rank, gpu, n):
    """``n`` timed calls of ``step`` (a collective) on every rank, then
    one more that rank 0 profiles; (results, CUDA-event ms, host ms,
    host seconds and payload bytes of the collectives a call, the
    profile)."""
    from mxnet_tpu_torch.parallel import collectives as C
    C.reset_wire()
    got, ms, wall = _timed_steps(step, n, gpu)
    wire = {"calls": C.wire["calls"] / n, "bytes": C.wire["bytes"] / n,
            "host_s": C.wire["seconds"] / n}
    prof = _dp_collective_steps(step, rank, gpu, reps=1)
    return got, ms, wall, wire, prof


# the leg's attention, kernels against the plain version on the ranks'
# step-1 q/k/v: the largest error over the largest value, of the output
# and of dq/dk/dv (Ulysses' gradients come from K3, the ring's from the
# plain backward over K2's output and log-sum-exp)
_MP_ATTN_TOL = {"ring_attention": {"out": 1e-5, "grads": 1e-5},
                "ulysses_attention": {"out": 1e-5,
                                      "grads": _ATTN_TOL[torch.float32][1]}}


def _mp_counts():
    """The launch counts of K1 and of K2/K3, the wrappers' own."""
    from mxnet_tpu_torch.kernels import flash_attention as FA
    from mxnet_tpu_torch.kernels import fused_bn as K
    return {"k1": K.launches, "k1_bwd": K.bwd_launches,
            "fwd": FA.fwd_launches, "bwd": FA.bwd_launches}


def _mp_zero_counts():
    from mxnet_tpu_torch.kernels import flash_attention as FA
    from mxnet_tpu_torch.kernels import fused_bn as K
    K.launches = K.bwd_launches = FA.fwd_launches = FA.bwd_launches = 0


def _mp_attn_vs_plain(fn, mesh, qkv, rank):
    """``fn`` (ring or Ulysses attention, causal) on this rank's q/k/v
    through the kernels and through the plain version, with one
    cotangent: errors of the output and dq/dk/dv over their largest
    value. Every rank calls it (the attention is a collective)."""
    gen = torch.Generator().manual_seed(100 + rank)
    w = torch.randn(qkv[0].shape, generator=gen).to(qkv[0].device)
    got = {}
    for kernels in (True, False):
        q, k, v = (t.detach().clone().requires_grad_() for t in qkv)
        o = fn(q, k, v, mesh, axis_name="sp", batch_axis_name="dp",
               causal=True, use_pallas=kernels)
        got[kernels] = [o.detach()] + list(torch.autograd.grad(
            (o * w).sum(), [q, k, v]))
    return {name: _mp_rel(a, b) for name, a, b in
            zip(("out", "dq", "dk", "dv"), got[True], got[False])}


def _mp_lm_leg(mx, ctx, cfg, rank, out, tag, axes, attn_name, per_step):
    """(a)/(b) The LM through ``SPMDTrainer`` over ``axes`` of the four
    workers: 1 step, the whole parameters and momentum read, then the
    rest of the steps timed; the counts cover every step. Then the
    attention alone on step 1's q/k/v, kernels against plain."""
    from mxnet_tpu_torch import parallel
    gpu = ctx.device_type == "gpu"
    vocab, embed, heads, seq = cfg["lm"]
    gb = cfg["lm_batch"]
    mesh = parallel.make_mesh(axes, devices=[ctx])
    assert mesh.is_process_spanning and mesh.size == _MP_WORLD, mesh
    fn = getattr(parallel, attn_name)
    step1_qkv = []

    def attn(q, k, v):
        if not step1_qkv:
            step1_qkv.extend(t.detach().clone() for t in (q, k, v))
        return fn(q, k, v, mesh, axis_name="sp", batch_axis_name="dp",
                  causal=True)
    spec = parallel.P("dp", "sp")
    tr = parallel.SPMDTrainer(
        _lm_apply(attn, gb // axes["dp"], seq // axes["sp"], heads, embed),
        _lm_params(vocab, embed), mesh, data_axis="dp",
        tp_axis="tp" if "tp" in axes else None, learning_rate=0.1,
        momentum=0.9, batch_specs=[spec, spec])
    batches = _dp_lm_batches(vocab, gb, seq, _MP_STEPS)
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts zeroed just before, read just after --------
    _mp_zero_counts()
    loss1 = float(tr.step(*batches[0]))
    counts1 = _mp_counts()
    p1 = tr.get_params()
    mom1 = {k: v.cpu().numpy() for k, v in tr.mom.items()}
    calls = [1]

    def step():                      # batches 2..n, then round again
        calls[0] += 1
        return float(tr.step(*batches[1 + (calls[0] - 2) % (_MP_STEPS - 1)]))
    losses, ms, wall, wire, prof = _mp_steps(step, rank, gpu, _MP_STEPS - 1)
    counts = _mp_counts()
    # ---------------------------------------------------------------------
    launches = {"fwd": counts["fwd"], "bwd": counts["bwd"]}
    steps = calls[0]                 # the profiled steps ran on every rank
    end = tr.get_params()
    attn_err = _mp_attn_vs_plain(fn, mesh, step1_qkv, rank)
    if rank == 0:
        np.savez(os.path.join(out, "lm-%s-step1.npz" % tag), **p1)
        np.savez(os.path.join(out, "lm-%s-mom1.npz" % tag), **mom1)
    shard = {k: tuple(v.shape) for k, v in tr.params.items()}
    rec = {"leg": tag, "axes": axes, "rank": rank, "coords": mesh.coords(),
           "losses": [loss1] + losses[:_MP_STEPS - 1], "steps": steps,
           "step1_digest": _digest({k: torch.from_numpy(v)
                                    for k, v in p1.items()}),
           "end_digest": _digest({k: torch.from_numpy(v)
                                  for k, v in end.items()}),
           "shard_shapes": shard, "kernel_launches": launches,
           "k1_launches": counts["k1"], "k1_bwd_launches": counts["k1_bwd"],
           "step1_launches": counts1,
           "expected": ({k: v * steps for k, v in per_step.items()} if gpu
                        else {"fwd": 0, "bwd": 0}),
           "attention_vs_plain": {"shape": list(step1_qkv[0].shape),
                                  "err_over_largest": attn_err,
                                  "gate": _MP_ATTN_TOL[attn_name]},
           "collectives_per_step": wire}
    if gpu:
        rec.update({"step_ms": ms, "step_wall_ms": wall,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "step_profile": prof})
    del tr
    _free(gpu)
    return rec


def _mp_moe_leg(mx, ctx, cfg, rank, out):
    """(c) ``moe_ffn`` over ``{"ep": 4}``: forward and backward at a
    capacity that drops nothing and at 1.25; saves this rank's output,
    gradients and routing keep mask."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import collectives as C
    from mxnet_tpu_torch.parallel.moe import route
    gpu = ctx.device_type == "gpu"
    mesh = parallel.make_mesh({"ep": _MP_WORLD}, devices=[ctx])
    inp = _mp_moe_inputs(cfg)
    blk = parallel.Placement(mesh, parallel.P("ep"))
    x = parallel.shard_put(inp["x"], blk)
    g = parallel.shard_put(inp["g"], blk)
    w1 = parallel.shard_put(inp["w1"], blk)
    w2 = parallel.shard_put(inp["w2"], blk)
    wr = torch.from_numpy(inp["wr"]).to(x.device)
    recs = {}
    for tag, cf in _MP_MOE_CAPS:
        if gpu:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        def step():
            xs, wrs, a, b = (t.detach().requires_grad_()
                             for t in (x, wr, w1, w2))
            y = parallel.moe_ffn(xs, wrs, a, b, mesh, capacity_factor=cf)
            grads = torch.autograd.grad((y * g).sum(), [xs, wrs, a, b])
            return (y.detach(),) + grads
        # -- the main path: counts zeroed just before, read just after ----
        _mp_zero_counts()
        got, ms, wall, wire, prof = _mp_steps(step, rank, gpu, _MP_STEPS)
        counts = _mp_counts()
        # -----------------------------------------------------------------
        y, dx, dwr, dw1, dw2 = got[0]
        dwr = C.all_reduce(dwr, mesh.group("ep"))
        b_, t_, e_ = x.shape
        cap = max(1, int(cf * b_ * t_ / _MP_WORLD))
        keep = route(x.reshape(-1, e_), wr, _MP_WORLD, cap)[3]
        torch.save({k: v.cpu() for k, v in (
            ("out", y), ("dx", dx), ("dwr", dwr), ("dw1", dw1), ("dw2", dw2),
            ("keep", keep))}, os.path.join(out, "moe-%s-r%d.pt" % (tag, rank)))
        rec = {"capacity_factor": cf, "capacity": cap,
               "tokens": b_ * t_, "dropped": int((~keep).sum()),
               "launches": counts, "collectives_per_step": wire}
        if gpu:
            rec.update({"step_ms": ms, "step_wall_ms": wall,
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "step_profile": prof})
        recs[tag] = rec
    _free(gpu)
    return recs


def _mp_pipe_leg(mx, ctx, cfg, rank, out):
    """(d) ``pipeline_apply`` over ``{"pp": 4}``: forward and backward;
    saves the output and this rank's stage gradients."""
    from mxnet_tpu_torch import parallel
    gpu = ctx.device_type == "gpu"
    mesh = parallel.make_mesh({"pp": _MP_WORLD}, devices=[ctx])
    inp = _mp_pipe_inputs(cfg)
    blk = parallel.Placement(mesh, parallel.P("pp"))
    w = parallel.shard_put(inp["w"], blk)
    b = parallel.shard_put(inp["b"], blk)
    x = torch.from_numpy(inp["x"]).to(w.device)
    g = torch.from_numpy(inp["g"]).to(w.device)
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def step():
        ws, bs = w.detach().requires_grad_(), b.detach().requires_grad_()
        y = parallel.pipeline_apply(_mp_stage, {"w": ws, "b": bs}, x, mesh)
        dw, db = torch.autograd.grad((y * g).sum(), [ws, bs])
        return y.detach(), dw, db
    # -- the main path: counts zeroed just before, read just after --------
    _mp_zero_counts()
    got, ms, wall, wire, prof = _mp_steps(step, rank, gpu, _MP_STEPS)
    counts = _mp_counts()
    # ---------------------------------------------------------------------
    y, dw, db = got[0]
    torch.save({"out": y.cpu() if rank == 0 else None, "dw": dw.cpu(),
                "db": db.cpu()}, os.path.join(out, "pipe-r%d.pt" % rank))
    rec = {"out_digest": _digest({"out": y}), "launches": counts,
           "collectives_per_step": wire}
    if gpu:
        rec.update({"step_ms": ms, "step_wall_ms": wall,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "step_profile": prof})
    _free(gpu)
    return rec


@contextlib.contextmanager
def _mp_deadline(rehearsal, leg):
    """A hard limit on one leg in a worker (as ``_dp_deadline``)."""
    import faulthandler
    print("mp worker: leg %s" % leg, file=sys.stderr, flush=True)
    faulthandler.dump_traceback_later(_MP_LEG_S[rehearsal], exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def mp_worker(out, rehearsal):
    """One worker of the model_parallel phase (``chip_smoke.py --mp-worker
    DIR``, started by ``python -m mxnet_tpu_torch.launch -n 4``): legs
    (a)-(d); writes ``mp-r<rank>.json`` under ``out``."""
    import mxnet_tpu_torch as mx
    rank = mx.dist.rank()
    assert mx.dist.process_count() == _MP_WORLD, mx.dist.process_count()
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _mp_cfg(rehearsal)
    res = {"rank": rank, "backend": mx.dist.backend(),
           "backend_reason": mx.dist.backend_reason(),
           "world": mx.dist.process_count(), "legs": {}}
    for tag, axes, attn, per_step in _MP_LM_LEGS:
        with _mp_deadline(rehearsal, tag):
            res["legs"][tag] = _mp_lm_leg(mx, ctx, cfg, rank, out, tag, axes,
                                          attn, per_step)
    with _mp_deadline(rehearsal, "moe"):
        res["legs"]["moe"] = _mp_moe_leg(mx, ctx, cfg, rank, out)
    with _mp_deadline(rehearsal, "pipeline"):
        res["legs"]["pipeline"] = _mp_pipe_leg(mx, ctx, cfg, rank, out)
    with open(os.path.join(out, "mp-r%d.json" % rank), "w") as f:
        json.dump(res, f)
    mx.dist.finalize()


def _mp_launch(out, rehearsal):
    """The four workers through the port's launcher under its hard
    timeout; raises when a worker fails, hangs or the launcher does.
    Returns the workers' records, rank order, and the seconds."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
           str(_MP_WORLD), "--timeout", str(_MP_LAUNCH_S[rehearsal])]
    if rehearsal:
        cmd.append("--force-cpu")
    cmd += ["--", sys.executable, os.path.abspath(__file__), "--mp-worker",
            out] + (["--cpu-rehearsal"] if rehearsal else [])
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    if rehearsal:
        env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=here, capture_output=True,
                         text=True, timeout=_MP_LAUNCH_S[rehearsal] + 60)
    secs = time.perf_counter() - t0
    sys.stderr.write(res.stderr[-20000:])
    assert res.returncode == 0, ("model_parallel workers failed",
                                 res.returncode)
    recs = []
    for r in range(_MP_WORLD):
        with open(os.path.join(out, "mp-r%d.json" % r)) as f:
            recs.append(json.load(f))
    return recs, secs


def _mp_lm_references(mx, ctx, cfg):
    """The LM in one process with the one-device trainer, per attention:
    step 1's loss, parameters and momentum, and every step's loss."""
    from mxnet_tpu_torch import parallel
    vocab, embed, heads, seq = cfg["lm"]
    gb = cfg["lm_batch"]
    spec = parallel.P("dp", "sp")
    refs = {}
    for tag, _, attn_name, _ in _MP_LM_LEGS:
        mesh = parallel.make_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=[ctx])
        fn = getattr(parallel, attn_name)
        tr = parallel.SPMDTrainer(
            _lm_apply(lambda q, k, v, fn=fn, mesh=mesh: fn(
                q, k, v, mesh, axis_name="sp", batch_axis_name="dp",
                causal=True), gb, seq, heads, embed),
            _lm_params(vocab, embed), mesh, data_axis="dp", tp_axis="tp",
            learning_rate=0.1, momentum=0.9, batch_specs=[spec, spec])
        batches = _dp_lm_batches(vocab, gb, seq, _MP_STEPS)
        losses = [float(tr.step(*batches[0]))]
        p1 = tr.get_params()
        mom1 = {k: v.cpu().numpy() for k, v in tr.mom.items()}
        losses += [float(tr.step(*b)) for b in batches[1:]]
        refs[tag] = {"losses": losses, "p1": p1, "mom1": mom1}
        del tr
        _free(ctx.device_type == "gpu")
    return refs


def _mp_moe_routing(cfg, capacity_factor):
    """Top-1 routing recomputed from scratch on the CPU, apart from the
    port's ``moe.route``: per rank's block of tokens, the first maximum
    of softmax(x wr^T) in float32, each token's position among the
    earlier tokens of its expert (a running count), kept when that
    position is below the capacity ``max(1, int(cf * local / n))``.
    Returns the experts, the keep mask and the capacity, every rank's
    tokens in rank order."""
    inp = _mp_moe_inputs(cfg)
    e = inp["x"].shape[-1]
    wr = torch.from_numpy(inp["wr"])
    experts, keeps = [], []
    for blk in np.split(inp["x"], _MP_WORLD):
        flat = torch.from_numpy(blk.reshape(-1, e))
        cap = max(1, int(capacity_factor * flat.shape[0] / _MP_WORLD))
        expert = torch.softmax(flat @ wr.T, -1).argmax(-1).numpy()
        seen = np.zeros(_MP_WORLD, np.int64)
        keep = np.zeros(len(expert), bool)
        for i, x in enumerate(expert):
            keep[i] = seen[x] < cap
            seen[x] += 1
        experts.append(torch.from_numpy(expert))
        keeps.append(torch.from_numpy(keep))
    return torch.cat(experts), torch.cat(keeps), cap


def _mp_moe_oracle(cfg, dev, expert, keep=None):
    """The dense one-process oracle (``__graft_entry__.py:181-202``) in
    float64: every token through its top-1 ``expert`` (the routing of
    :func:`_mp_moe_routing`, taken in float32, so a near tie cannot pick
    another), scaled by its gate; with ``keep``, dropped tokens give
    zeros. Returns the output and the gradients of ``sum(out * g)`` by
    x, wr, w1, w2."""
    inp = _mp_moe_inputs(cfg)
    t = {k: torch.from_numpy(v).to(dev, torch.float64).requires_grad_()
         for k, v in inp.items()}
    e = t["x"].shape[-1]
    flat = t["x"].reshape(-1, e)
    probs = torch.softmax(flat @ t["wr"].T, -1)
    expert = expert.to(dev)
    gate = probs.gather(-1, expert[:, None])
    out = torch.zeros_like(flat)
    for i in range(_MP_WORLD):
        sel = expert == i
        h = torch.relu(flat[sel] @ t["w1"][i].T) @ t["w2"][i].T
        out = out.index_put((sel.nonzero()[:, 0],), h * gate[sel])
    if keep is not None:
        out = out * keep.to(dev, torch.float64)[:, None]
    out = out.reshape(t["x"].shape)
    grads = torch.autograd.grad((out * t["g"]).sum(),
                                [t["x"], t["wr"], t["w1"], t["w2"]])
    return out.detach(), grads


def _mp_pipe_oracle(cfg, dev):
    """The sequential oracle (``__graft_entry__.py:163-179``) in float64:
    output and the gradients of ``sum(out * g)`` by w and b."""
    inp = _mp_pipe_inputs(cfg)
    t = {k: torch.from_numpy(v).to(dev, torch.float64).requires_grad_()
         for k, v in inp.items()}
    h = t["x"]
    for s in range(_MP_WORLD):
        h = torch.tanh(h @ t["w"][s] + t["b"][s])
    dw, db = torch.autograd.grad((h * t["g"]).sum(), [t["w"], t["b"]])
    return h.detach(), dw, db


def _mp_rel(got, want):
    """Largest |got - want| over the largest |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


def model_parallel_phase(mx, ctx, rehearsal, card):
    """Sequence, tensor, expert and pipeline parallelism across four
    worker processes on one card: every leg through ``python -m
    mxnet_tpu_torch.launch -n 4`` (the ranks share ``cuda:0`` over gloo),
    against one process on the card. Returns the K1, K2 and K3 launches
    of the workers' main paths (every rank)."""
    gpu = ctx.device_type == "gpu"
    cfg = _mp_cfg(rehearsal)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _free(gpu)
    out = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        return _model_parallel(mx, ctx, rehearsal, card, cfg, gpu, out)
    finally:
        import shutil
        shutil.rmtree(out, ignore_errors=True)
        _free(gpu)


def _model_parallel(mx, ctx, rehearsal, card, cfg, gpu, out):
    t0 = time.perf_counter()
    ref = _mp_lm_references(mx, ctx, cfg)
    ref_s = time.perf_counter() - t0
    recs, launch_s = _mp_launch(out, rehearsal)
    dev = ctx.torch_device()
    checks, report = {}, {}
    for r in recs:
        assert r["backend"] == "gloo" and r["world"] == _MP_WORLD, r
    # (a), (b): the LM against one process, replicas bit-equal, counts
    k1 = k2 = k3 = 0
    for tag, axes, attn_name, _ in _MP_LM_LEGS:
        legs = [r["legs"][tag] for r in recs]
        want = ref[tag]
        p1 = dict(np.load(os.path.join(out, "lm-%s-step1.npz" % tag)))
        mom1 = dict(np.load(os.path.join(out, "lm-%s-mom1.npz" % tag)))
        loss_rel = abs(legs[0]["losses"][0] - want["losses"][0]) \
            / abs(want["losses"][0])
        param_err = {k: float(np.abs(p1[k] - want["p1"][k]).max()
                              / np.abs(want["p1"][k]).max()) for k in p1}
        grad_err = {k: float(np.abs(mom1[k] - want["mom1"][k]).max()
                             / np.abs(want["mom1"][k]).max()) for k in mom1}
        attn_err = [g["attention_vs_plain"]["err_over_largest"]
                    for g in legs]
        tol = _MP_ATTN_TOL[attn_name]
        checks["%s_step1_loss" % tag] = loss_rel <= 1e-4
        checks["%s_step1_params" % tag] = max(param_err.values()) <= 1e-3
        checks["%s_step1_grads" % tag] = max(grad_err.values()) <= 1e-4
        checks["%s_attention_vs_plain" % tag] = all(
            a["out"] <= tol["out"]
            and max(a["dq"], a["dk"], a["dv"]) <= tol["grads"]
            for a in attn_err)
        checks["%s_ranks_bit_equal" % tag] = len(
            {(g["step1_digest"], g["end_digest"]) for g in legs}) == 1 \
            and len({tuple(g["losses"]) for g in legs}) == 1
        checks["%s_launches" % tag] = all(
            g["kernel_launches"] == g["expected"] for g in legs)
        if "tp" in axes:
            checks["%s_tp_shards" % tag] = all(
                tuple(shape)[0] * axes["tp"] == want["p1"][k].shape[0]
                for g in legs for k, shape in g["shard_shapes"].items())
        k1 += sum(g["k1_launches"] for g in legs)
        _K1_BWD["model_parallel"] += sum(g["k1_bwd_launches"] for g in legs)
        k2 += sum(g["kernel_launches"]["fwd"] for g in legs)
        k3 += sum(g["kernel_launches"]["bwd"] for g in legs)
        report[tag] = {"rank0": legs[0],
                       "attention_vs_plain_per_rank": attn_err,
                       "peak_bytes_per_rank": [g.get("peak_bytes")
                                               for g in legs],
                       "one_process_losses": want["losses"],
                       "step1_loss_rel": loss_rel,
                       "step1_param_err_over_largest": param_err,
                       "step1_grad_err_over_largest": grad_err,
                       "gate": {"loss": 1e-4, "param": 1e-3,
                                "grad": 1e-4, "attention_vs_plain": tol}}
    # (c) MoE against the dense oracle; dropped tokens against a CPU
    # recompute of the routing, apart from the port's
    inp = _mp_moe_inputs(cfg)
    e = inp["x"].shape[-1]
    report["moe"] = {}
    for tag, cf in _MP_MOE_CAPS:
        got = [torch.load(os.path.join(out, "moe-%s-r%d.pt" % (tag, r)))
               for r in range(_MP_WORLD)]
        leg = recs[0]["legs"]["moe"][tag]
        expert, keep, cap = _mp_moe_routing(cfg, cf)
        port_keep = torch.cat([g["keep"] for g in got])
        zero_rows = torch.cat([(g["out"].reshape(-1, e) == 0).all(-1)
                               for g in got])
        same_drops = cap == leg["capacity"] and torch.equal(
            port_keep, keep) and torch.equal(zero_rows, ~keep)
        o, grads = _mp_moe_oracle(cfg, dev, expert,
                                  None if tag == "no_drop" else keep)
        want = (o,) + tuple(grads)
        errs = {
            "out": _mp_rel(torch.cat([g["out"] for g in got]), want[0]),
            "dx": _mp_rel(torch.cat([g["dx"] for g in got]), want[1]),
            "dwr": max(_mp_rel(g["dwr"], want[2]) for g in got),
            "dw1": _mp_rel(torch.cat([g["dw1"] for g in got]), want[3]),
            "dw2": _mp_rel(torch.cat([g["dw2"] for g in got]), want[4])}
        dropped = sum(r["legs"]["moe"][tag]["dropped"] for r in recs)
        checks["moe_%s_vs_dense_oracle" % tag] = max(errs.values()) <= 1e-4
        checks["moe_%s_drops_as_cpu_routing" % tag] = same_drops
        checks["moe_%s_dropped_count" % tag] = \
            dropped == int((~keep).sum()) and (dropped == 0) == (tag ==
                                                                "no_drop")
        report["moe"][tag] = {"rank0": leg, "dropped_tokens": dropped,
                              "cpu_routing_dropped": int((~keep).sum()),
                              "err_over_largest": errs, "gate": 1e-4,
                              "peak_bytes_per_rank": [
                                  r["legs"]["moe"][tag].get("peak_bytes")
                                  for r in recs]}
    for r in recs:
        for c in ([r["legs"]["moe"][t]["launches"] for t, _ in _MP_MOE_CAPS]
                  + [r["legs"]["pipeline"]["launches"]]):
            k1, k2, k3 = k1 + c["k1"], k2 + c["fwd"], k3 + c["bwd"]
            _K1_BWD["model_parallel"] += c["k1_bwd"]
    # (d) the pipeline against the sequential oracle
    pouts, pdw, pdb = _mp_pipe_oracle(cfg, dev)
    got = [torch.load(os.path.join(out, "pipe-r%d.pt" % r))
           for r in range(_MP_WORLD)]
    perr = {"out": _mp_rel(got[0]["out"], pouts),
            "dw": _mp_rel(torch.stack([g["dw"][0] for g in got]), pdw),
            "db": _mp_rel(torch.stack([g["db"][0] for g in got]), pdb)}
    checks["pipeline_vs_sequential_oracle"] = max(perr.values()) <= 1e-4
    checks["pipeline_output_on_every_rank"] = len(
        {r["legs"]["pipeline"]["out_digest"] for r in recs}) == 1
    report["pipeline"] = {"rank0": recs[0]["legs"]["pipeline"],
                          "err_over_largest": perr, "gate": 1e-4,
                          "peak_bytes_per_rank": [
                              r["legs"]["pipeline"].get("peak_bytes")
                              for r in recs]}
    emit({"model_parallel": {
        "card": card, "world": _MP_WORLD, "backend": recs[0]["backend"],
        "backend_reason": recs[0]["backend_reason"],
        "config": {k: list(v) if isinstance(v, tuple) else v
                   for k, v in cfg.items()},
        "seconds": {"references": ref_s, "launch": launch_s},
        "legs": report, "launches": {"k1": k1, "k2": k2, "k3": k3},
        "checks": checks}})
    failed = sorted(k for k, v in checks.items() if not v)
    assert not failed, failed
    return k1, k2, k3


# -- engine_meshes: the engines and Module on partitioned meshes ------------
_EM_WORLD = 4
_EM_LEG_S = {False: 150, True: 120}     # one leg's hard limit in a worker
_EM_LAUNCH_S = {False: 420, True: 300}  # the launch's, the launcher's own
_EM_SERVE_AXES = {"dp": 1, "mp": 4}
_EM_FIT_AXES = {"dp": 2, "mp": 2}


def _em_cfg(rehearsal):
    """Sizes: serving at the serving phase's configuration (8 requests of
    1-4 rows, then 2 of ``max_batch``); decode at the decode phase's
    width, 16 prompts of its prompt length, 32 new tokens; ``Module.fit``
    at the data_parallel phase's global batch (64) for 2 batches. The
    rehearsal takes the small nets."""
    if rehearsal:
        return {"requests": 8, "full": 2, "prompts": 8, "new_tokens": 8,
                "fit_batches": 3}
    return {"requests": 8, "full": 2, "prompts": 16, "new_tokens": 32,
            "fit_batches": 2}


def _em_rules(mx):
    """``bench.py``'s ResNet layout rules (``_mp_bench_rules``,
    ``bench.py:678-690``): conv and FC weights' output channels, and the
    BatchNorm scales and shifts, over ``mp``."""
    P = mx.parallel.P
    return mx.parallel.PartitionRules([
        (r"(conv\d*|fc\d*)_weight$", P("mp")),
        (r"weight$", P("mp")),
        (r"(gamma|beta|bias)$", P("mp"))])


def _em_bytes(tensors):
    return int(sum(t.numel() * t.element_size() for t in tensors))


def _em_wire_per(n):
    from mxnet_tpu_torch.parallel import collectives as C
    return {"calls": C.wire["calls"] / n, "bytes": C.wire["bytes"] / n,
            "host_s": C.wire["seconds"] / n}


def _em_serve_leg(mx, ctx, cfg, rank, rehearsal):
    """(a) Serving ResNet-50 v1 over ``{"dp": 1, "mp": 4}``. Rank 0 first
    runs every bucket through a one-device engine on the card; then the
    counts are zeroed and every rank builds the mesh engine: rank 0
    serves the traffic and drives every bucket once more, the followers
    compute their members' part of each dispatch; the counts are read
    after ``close``."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    from mxnet_tpu_torch.parallel import collectives as C
    from mxnet_tpu_torch.serving import InferenceEngine
    gpu = ctx.device_type == "gpu"
    sym, params, hw, classes, max_batch, _, _ = _served_resnet(
        mx, mx.cpu(), rehearsal)
    n_fused = sum(1 for n in sym._topo_nodes() if n.op is not None
                  and n.op.name == "_contrib_BatchNormAddReLU")
    rs = np.random.RandomState(7)
    reqs = [rs.uniform(-1, 1, (int(rs.randint(1, 5)), hw, hw, 3))
            .astype(np.float32) for _ in range(cfg["requests"])]
    full = [rs.uniform(-1, 1, (max_batch, hw, hw, 3)).astype(np.float32)
            for _ in range(cfg["full"])]
    probe = rs.uniform(-1, 1, (max_batch, hw, hw, 3)).astype(np.float32)

    def bucket_out(eng, b):
        args = dict(eng._param_raw)
        args["data"] = eng._put_batch(probe[:b], "data")
        args.update(eng._bucket_extras(b))
        return eng._forward(args, eng._aux_raw)[0][0].cpu().numpy()
    one = {}
    if rank == 0:
        with InferenceEngine(sym, {k: v.as_in_context(ctx) for k, v in
                                   params.items()},
                             {"data": (1, hw, hw, 3)}, max_batch=max_batch,
                             ctx=ctx) as plain:
            one = {b: bucket_out(plain, b) for b in plain.buckets}
    _free(gpu)
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts zeroed just before, read just after --------
    K.launches = 0
    t0 = time.perf_counter()
    eng = InferenceEngine(sym, params, {"data": (1, hw, hw, 3)},
                          max_batch=max_batch, max_wait_ms=2.0,
                          partition_rules=_em_rules(mx),
                          mesh_axes=_EM_SERVE_AXES, contexts=[ctx])
    rec = {"engine_build_and_warmup_s": time.perf_counter() - t0,
           "buckets": list(eng.buckets)}
    held = [t for m in eng._members for part in ("params", "aux")
            for t in m[part].values()]
    rec["committed_param_bytes"] = _em_bytes(held)
    rec["replicated_param_bytes"] = _em_bytes(
        [v._data for v in params.values()])
    forwards = len(eng.buckets)
    if rank == 0:
        t1 = time.perf_counter()
        futs = [eng.submit(data=x) for x in reqs]
        outs = [f.result(timeout=600)[0] for f in futs]
        outs += [eng.predict(data=x)[0] for x in full]
        rec["traffic_s"] = time.perf_counter() - t1
        st = eng.stats()
        forwards += st["batches"]
        for x, o in zip(reqs + full, outs):
            assert o.shape == (x.shape[0], classes) and np.isfinite(o).all()
        mesh_out = {b: bucket_out(eng, b) for b in eng.buckets}
        forwards += len(eng.buckets)
        rec["buckets_bit_equal"] = {str(b): bool(np.array_equal(
            mesh_out[b], one[b])) for b in eng.buckets}
        rec["stats"] = {"batches": st["batches"], "buckets": st["buckets"],
                        "latency_ms": st["latency_ms"],
                        "device_bytes": st["device_bytes"]}
        rec["layout"] = eng.partition_summary()["mesh_axes"]
        fwd = lambda: bucket_out(eng, max_batch)       # noqa: E731
        C.reset_wire()
        _, ms, wall = _timed_steps(fwd, 2, gpu)
        rec["forward_wire"] = _em_wire_per(2)
        forwards += 2
        if gpu:
            rec.update({"forward_ms": ms, "forward_wall_ms": wall,
                        "forward_profile": profile_forward(fwd, reps=1)})
            forwards += 2
        rec["forwards"] = forwards
    else:
        try:
            eng.submit(data=reqs[0])
            rec["follower_refused"] = False
        except mx.MXNetError as e:
            rec["follower_refused"] = "rank 0" in str(e)
    eng.close()
    rec["k1_launches"] = K.launches
    # ---------------------------------------------------------------------
    rec["tails_per_forward"] = n_fused
    if gpu:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    if rank == 0:
        # the smallest bucket against a CPU forward (TF32 is off)
        pred = mx.predictor.Predictor(sym, params, {"data": (1, hw, hw, 3)},
                                      ctx=mx.cpu())
        pred.forward(data=probe[:1])
        c = pred.get_output(0).asnumpy()
        rec["cpu_recompute_max_abs_err_over_max_logit"] = float(
            np.abs(mesh_out[1] - c).max() / np.abs(c).max())
    del eng
    mx.layout.set_default_layout(None)
    _free(gpu)
    return rec


def _em_decode_leg(mx, ctx, cfg, rank, rehearsal):
    """(b) Decode over ``{"dp": 1, "mp": 4}`` under
    ``DECODE_PARTITION_RULES``. Rank 0 first decodes the prompts with a
    one-device engine on the card; then every rank builds the mesh
    engine, rank 0 submits the prompts, and a full-bucket step is timed
    and profiled (the followers follow)."""
    from mxnet_tpu_torch.decode import AttentionDecodeCell, DecodeEngine
    from mxnet_tpu_torch.parallel import collectives as C
    from mxnet_tpu_torch.parallel.ring_attention import \
        DECODE_PARTITION_RULES
    gpu = ctx.device_type == "gpu"
    dims, slots, _, _, _, prompt_len = _DECODE[rehearsal]
    cell = AttentionDecodeCell(**dims)
    params = cell.init_params(1)
    kw = dict(slots=slots, max_prompt_len=prompt_len * 2, keep_logits=True,
              max_new_tokens=cfg["new_tokens"])
    prompts = [np.random.RandomState(1 + i).randint(
        1, cell.vocab - 1, prompt_len).astype(np.int32)
        for i in range(cfg["prompts"])]
    whole = sum(int(np.prod(shape)) * torch.tensor([], dtype=dt)
                .element_size() for shape, dt in
                cell.cache_spec(slots).values())
    rec = {"cell": dims, "slots": slots, "whole_pool_bytes": whole}
    if rank == 0:
        with DecodeEngine(cell, params, ctx=ctx, **kw) as plain:
            want = [f.result(timeout=600)
                    for f in [plain.submit(p) for p in prompts]]
            rec["one_device_kv_cache_bytes"] = plain.kv_cache_bytes()
    _free(gpu)
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    eng = DecodeEngine(cell, params, partition_rules=DECODE_PARTITION_RULES,
                       mesh_axes=_EM_SERVE_AXES, contexts=[ctx], **kw)
    rec["kv_cache_bytes"] = eng.kv_cache_bytes()
    rec["committed_param_bytes"] = _em_bytes(
        t for m in eng._members for t in m["params"].values())
    rec["replicated_param_bytes"] = _em_bytes(
        torch.as_tensor(np.asarray(v, np.float32)) if not
        isinstance(v, torch.Tensor) else v for v in params.values())
    rec["shard_shapes"] = {k: list(v.shape) for k, v in eng._params.items()}
    if rank == 0:
        C.reset_wire()
        t0 = time.perf_counter()
        got = [f.result(timeout=600) for f in [eng.submit(p)
                                               for p in prompts]]
        rec["traffic_s"] = time.perf_counter() - t0
        st = eng.stats()
        rec["token_wire"] = _em_wire_per(max(st["tokens"], 1))
        rec["step_wire"] = _em_wire_per(max(st["steps"], 1))
        rec["token_latency_ms"] = st["token_latency_ms"]
        rec["tokens"], rec["steps"] = st["tokens"], st["steps"]
        worst, compared, cut_total = 0.0, 0, 0
        equal = True
        for g, w in zip(got, want):
            scale = float(np.abs(w.logits).max())
            cut = _margin_cut(w.logits, _DECODE_TOL * scale)
            equal = equal and g.tokens[:cut] == w.tokens[:cut]
            rows = min(cut + 1, len(w.logits))
            worst = max(worst, float(np.abs(g.logits[:rows]
                                            - w.logits[:rows]).max())
                        / scale)
            compared += cut
            cut_total += len(w.tokens) - cut
        rec["vs_one_device"] = {
            "tokens_equal_to_margin_cut": bool(equal),
            "max_abs_err_over_max_logit": worst, "tol": _DECODE_TOL,
            "positions_compared": compared, "positions_cut": cut_total}
        ids = np.arange(slots, dtype=np.int32)
        ones = np.ones(slots, np.int32)
        pos = np.full(slots, prompt_len, np.int32)
        step = lambda: eng._decode_prog(eng._params, eng._cache, ids, ones,
                                        pos)[1].cpu()   # noqa: E731
        C.reset_wire()
        _, ms, wall = _timed_steps(step, 3, gpu)
        rec["full_bucket_step_wire"] = _em_wire_per(3)
        if gpu:
            rec.update({"full_bucket_step_ms": ms,
                        "full_bucket_step_wall_ms": wall,
                        "step_profile": profile_forward(step, reps=1)})
    else:
        try:
            eng.generate(prompts[0])
            rec["follower_refused"] = False
        except mx.MXNetError as e:
            rec["follower_refused"] = "rank 0" in str(e)
    eng.close()
    if gpu:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    del eng
    _free(gpu)
    return rec


def _em_fit_leg(mx, ctx, rank, out, rehearsal):
    """(c) ``Module.fit`` on ResNet-50 v1 over ``{"dp": 2, "mp": 2}``:
    the data_parallel phase's model, data and optimizer at the global
    batch, 3 fused batches (step 1's parameters kept), the fp64 step 1 on
    the unfused net, timed steps, then the checkpoints both ways with a
    one-device ``Module`` on rank 0."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    from mxnet_tpu_torch.parallel import collectives as C
    gpu = ctx.device_type == "gpu"
    cfg = _dp_cfg(rehearsal)
    g = cfg["batch"] * _DP_WORLD
    mesh = {"partition_rules": _em_rules(mx), "mesh_axes": _EM_FIT_AXES}
    net, sym, hw, classes = _resnet_net(mx, mx.cpu(), rehearsal)
    aux_names = set(sym.list_auxiliary_states())
    params = {k: p.data()._data.to("cpu", copy=True)
              for k, p in net.collect_params().items()}
    del net
    arg = {k: v for k, v in params.items() if k not in aux_names}
    aux = {k: v for k, v in params.items() if k in aux_names}
    x, y = _module_data(cfg["batches"], g, hw, classes)
    n = _em_cfg(rehearsal)["fit_batches"]
    x, y = x[:n * g], y[:n * g]
    it = mx.io.NDArrayIter(x, y, batch_size=g, shuffle=False)
    mod = mx.mod.Module(sym, context=[ctx], **mesh)
    snap, marks = {}, []

    def batch_end(param):
        marks.append(time.perf_counter())
        if param.nbatch == 0:       # a collective: every rank gathers
            snap["step1"] = _host_params(mod)[0]
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts zeroed just before, read just after --------
    K.launches = K.bwd_launches = 0
    C.reset_wire()
    t0 = time.perf_counter()
    mod.fit(it, eval_metric=mx.metric.create(["acc", "ce"]),
            kvstore="device", optimizer="sgd", optimizer_params=_dp_opt(g),
            arg_params=arg, aux_params=aux, num_epoch=1,
            batch_end_callback=batch_end)
    if gpu:
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches, bwd = K.launches, K.bwd_launches
    # ---------------------------------------------------------------------
    assert mod._fused_fallback_reason is None, mod._fused_fallback_reason
    end_arg, end_aux = _host_params(mod)
    ex = mod._exec
    upd = mod._updater.members[0]
    rec = {"layout": mod.partition_summary()["mesh_axes"],
           "fit_s": fit_s, "batches": len(marks),
           "batch_s_after_first": (marks[-1] - marks[0]) / (len(marks) - 1),
           "k1_launches": launches, "k1_bwd_launches": bwd,
           "tails_per_step": 16 if not rehearsal else 4,
           "end_digest": _digest(end_arg), "end_aux_digest": _digest(end_aux),
           "committed_param_bytes": _em_bytes(
               ex.arg_dict[k]._data for k in mod._param_names),
           "committed_grad_bytes": _em_bytes(
               a._data for a in ex.grad_arrays if a is not None),
           "committed_state_bytes": _em_bytes(
               t._data for st in upd.states.values()
               for t in (st if isinstance(st, tuple) else (st,))
               if t is not None),
           "replicated_param_bytes": _em_bytes(arg.values()),
           "shard_shapes": {k: list(ex.arg_dict[k].shape)
                            for k in list(mod._param_names)[:4]}}
    if rank == 0:
        torch.save(snap["step1"], os.path.join(out, "fit-step1.pt"))

    def step():
        assert mod.fused_step(mx.io.DataBatch(
            [mx.nd.array(x[:g], ctx=mx.cpu())],
            [mx.nd.array(y[:g], ctx=mx.cpu())]))
    _, ms, wall, wire, prof = _mp_steps(step, rank, gpu, 2)
    rec["step_wire"] = wire
    if gpu:
        rec.update({"step_ms": ms, "step_wall_ms": wall,
                    "step_profile": prof,
                    "peak_bytes": torch.cuda.max_memory_allocated()})
    # the checkpoints: mesh -> one device, then one device -> mesh
    after, _ = _host_params(mod)
    mgr = mx.CheckpointManager(os.path.join(out, "fit-mesh"))
    meta = mgr.save(mod, 1)
    rec["checkpoint_layout"] = meta.get("layout", {}).get("mesh_axes")
    mx.parallel.barrier()
    if rank == 0:
        one = mx.mod.Module(sym, context=ctx)
        one.bind(data_shapes=[("data", (g, hw, hw, 3))],
                 label_shapes=[("softmax_label", (g,))])
        one.init_params(arg_params=arg, aux_params=aux)
        one.init_optimizer(kvstore="device", optimizer="sgd",
                           optimizer_params=_dp_opt(g))
        mgr.restore(one)
        rec["mesh_to_one_device_bit_equal"] = _bit_equal(
            _host_params(one)[0], after)
        step_one = mx.io.DataBatch([mx.nd.array(x[g:2 * g], ctx=ctx)],
                                   [mx.nd.array(y[g:2 * g], ctx=ctx)])
        assert one.fused_step(step_one)
        back, _ = _host_params(one)
        torch.save(back, os.path.join(out, "fit-one-device.pt"))
        mx.CheckpointManager(os.path.join(out, "fit-one")).save(one, 2)
        del one
        _free(gpu)
    mx.parallel.barrier()
    mx.CheckpointManager(os.path.join(out, "fit-one")).restore(mod)
    rec["restored_digest"] = _digest(_host_params(mod)[0])
    if rank == 0:
        rec["one_device_to_mesh_bit_equal"] = _bit_equal(
            _host_params(mod)[0], torch.load(
                os.path.join(out, "fit-one-device.pt")))
    else:
        _host_params(mod)            # the gather is a collective
    del mod
    _free(gpu)
    # fp64 step 1 on the mesh, the arbiter's counterpart
    w64 = _dp_module_fp64_step(mx, ctx, cfg, rehearsal, mesh=mesh)
    if rank == 0:
        torch.save(w64, os.path.join(out, "fit-step1-fp64.pt"))
    del w64
    _free(gpu)
    return rec


def em_worker(out, rehearsal):
    """One worker of the engine_meshes phase (``chip_smoke.py --em-worker
    DIR``, started by ``python -m mxnet_tpu_torch.launch -n 4``): legs
    (a)-(c); writes ``em-r<rank>.json`` under ``out``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as FA
    rank = mx.dist.rank()
    assert mx.dist.process_count() == _EM_WORLD, mx.dist.process_count()
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = _em_cfg(rehearsal)
    res = {"rank": rank, "backend": mx.dist.backend(),
           "world": mx.dist.process_count(), "legs": {}}
    FA.fwd_launches = FA.bwd_launches = 0
    for leg, run in (
            ("serving", lambda: _em_serve_leg(mx, ctx, cfg, rank, rehearsal)),
            ("decode", lambda: _em_decode_leg(mx, ctx, cfg, rank,
                                              rehearsal)),
            ("fit", lambda: _em_fit_leg(mx, ctx, rank, out, rehearsal))):
        t0 = time.perf_counter()
        with _mp_deadline(rehearsal, "em_" + leg):
            res["legs"][leg] = run()
        res["legs"][leg]["leg_s"] = time.perf_counter() - t0
    res["k2_launches"], res["k3_launches"] = FA.fwd_launches, \
        FA.bwd_launches
    with open(os.path.join(out, "em-r%d.json" % rank), "w") as f:
        json.dump(res, f)
    mx.dist.finalize()


def _em_launch(out, rehearsal):
    """The four workers through the port's launcher under its hard
    timeout; raises when a worker fails, hangs or the launcher does.
    Returns the workers' records, rank order, and the seconds."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
           str(_EM_WORLD), "--timeout", str(_EM_LAUNCH_S[rehearsal])]
    if rehearsal:
        cmd.append("--force-cpu")
    cmd += ["--", sys.executable, os.path.abspath(__file__), "--em-worker",
            out] + (["--cpu-rehearsal"] if rehearsal else [])
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    if rehearsal:
        env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=here, capture_output=True,
                         text=True, timeout=_EM_LAUNCH_S[rehearsal] + 60)
    secs = time.perf_counter() - t0
    sys.stderr.write(res.stderr[-20000:])
    assert res.returncode == 0, ("engine_meshes workers failed",
                                 res.returncode)
    recs = []
    for r in range(_EM_WORLD):
        with open(os.path.join(out, "em-r%d.json" % r)) as f:
            recs.append(json.load(f))
    return recs, secs


def engine_meshes_phase(mx, ctx, rehearsal, card):
    """Serving, decode and ``Module.fit`` over partitioned meshes across
    four worker processes on one card (``python -m mxnet_tpu_torch.launch
    -n 4``, the ranks share ``cuda:0`` over gloo), after one process's
    step-1 references. Returns the K1, K2 and K3 launches of the workers'
    main paths (every rank)."""
    gpu = ctx.device_type == "gpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _free(gpu)
    out = tempfile.mkdtemp(prefix="chip_smoke_em_")
    try:
        return _engine_meshes(mx, ctx, rehearsal, card, gpu, out)
    finally:
        import shutil
        shutil.rmtree(out, ignore_errors=True)
        _free(gpu)


def _engine_meshes(mx, ctx, rehearsal, card, gpu, out):
    t0 = time.perf_counter()
    cfg = _dp_cfg(rehearsal)
    net, sym, hw, classes = _resnet_net(mx, ctx, rehearsal)
    aux_names = set(sym.list_auxiliary_states())
    w = {k: p.data()._data.to("cpu", copy=True)
         for k, p in net.collect_params().items()}
    del net
    arg = {k: v for k, v in w.items() if k not in aux_names}
    aux = {k: v for k, v in w.items() if k in aux_names}
    _, one = _dp_module_reference(mx, ctx, cfg, sym, arg, aux, hw, classes)
    _free(gpu)
    one64 = _dp_module_fp64_step(mx, ctx, cfg, rehearsal)
    mx.layout.set_default_layout(None)
    _free(gpu)
    ref_s = time.perf_counter() - t0
    recs, launch_s = _em_launch(out, rehearsal)
    checks, report = {}, {}
    for r in recs:
        assert r["backend"] == "gloo" and r["world"] == _EM_WORLD, r
    k1 = sum(r["legs"]["serving"]["k1_launches"]
             + r["legs"]["fit"]["k1_launches"] for r in recs)
    k2 = sum(r["k2_launches"] for r in recs)
    k3 = sum(r["k3_launches"] for r in recs)
    # (a) serving
    sv = [r["legs"]["serving"] for r in recs]
    per_fwd = sv[0]["tails_per_forward"] if gpu else 0
    checks["serving_buckets_bit_equal_to_one_device"] = all(
        sv[0]["buckets_bit_equal"].values())
    checks["serving_cpu_recompute"] = \
        sv[0]["cpu_recompute_max_abs_err_over_max_logit"] <= 1e-3
    checks["serving_k1_per_forward_every_rank"] = all(
        s["k1_launches"] == per_fwd * sv[0]["forwards"] for s in sv)
    checks["serving_followers_refuse_requests"] = all(
        s["follower_refused"] for s in sv[1:])
    checks["serving_params_sharded"] = all(
        s["committed_param_bytes"] < s["replicated_param_bytes"] / 2
        for s in sv)
    report["serving"] = {"rank0": sv[0], "per_rank": [
        {k: s.get(k) for k in ("committed_param_bytes",
                               "replicated_param_bytes", "peak_bytes",
                               "k1_launches")} for s in sv],
        "gate": {"buckets": "bit-equal", "cpu_recompute": 1e-3}}
    # (b) decode
    dc = [r["legs"]["decode"] for r in recs]
    checks["decode_tokens_to_margin_cut"] = \
        dc[0]["vs_one_device"]["tokens_equal_to_margin_cut"]
    checks["decode_logits_to_margin_cut"] = \
        dc[0]["vs_one_device"]["max_abs_err_over_max_logit"] <= _DECODE_TOL
    checks["decode_kv_quarter_every_rank"] = all(
        d["kv_cache_bytes"] * _EM_WORLD == d["whole_pool_bytes"] for d in dc) \
        and dc[0]["one_device_kv_cache_bytes"] == dc[0]["whole_pool_bytes"]
    checks["decode_followers_refuse_requests"] = all(
        d["follower_refused"] for d in dc[1:])
    report["decode"] = {"rank0": dc[0], "per_rank": [
        {k: d.get(k) for k in ("kv_cache_bytes", "whole_pool_bytes",
                               "committed_param_bytes",
                               "replicated_param_bytes", "peak_bytes")}
        for d in dc]}
    # (c) Module.fit
    ft = [r["legs"]["fit"] for r in recs]
    card_step1 = torch.load(os.path.join(out, "fit-step1.pt"))
    card64 = torch.load(os.path.join(out, "fit-step1-fp64.pt"))
    ok, gate = _dp_gate(card_step1, card64, one, one64, arg)
    checks["fit_step1_gate"] = ok
    checks["fit_ranks_bit_equal"] = len(
        {(f["end_digest"], f["end_aux_digest"]) for f in ft}) == 1
    checks["fit_k1_per_step_every_rank"] = all(
        f["k1_launches"] == f["k1_bwd_launches"]
        == (f["tails_per_step"] if gpu else 0) * f["batches"] for f in ft)
    _K1_BWD["engine_meshes"] += sum(f["k1_bwd_launches"] for f in ft)
    checks["fit_checkpoint_mesh_to_one_device"] = \
        ft[0]["mesh_to_one_device_bit_equal"]
    checks["fit_checkpoint_one_device_to_mesh"] = \
        ft[0]["one_device_to_mesh_bit_equal"] \
        and len({f["restored_digest"] for f in ft}) == 1
    checks["fit_checkpoint_layout"] = all(
        f["checkpoint_layout"] == _EM_FIT_AXES for f in ft)
    report["fit"] = {"rank0": ft[0], "step1_gate": gate, "per_rank": [
        {k: f.get(k) for k in ("committed_param_bytes",
                               "committed_grad_bytes",
                               "committed_state_bytes",
                               "replicated_param_bytes", "peak_bytes",
                               "k1_launches", "k1_bwd_launches")}
        for f in ft]}
    emit({"engine_meshes": {
        "card": card, "world": _EM_WORLD, "backend": recs[0]["backend"],
        "serving_axes": _EM_SERVE_AXES, "fit_axes": _EM_FIT_AXES,
        "seconds": {"references": ref_s, "launch": launch_s,
                    "rank0_legs": {k: v["leg_s"]
                                   for k, v in recs[0]["legs"].items()}},
        "legs": report, "launches": {"k1": k1, "k2": k2, "k3": k3},
        "checks": checks}})
    failed = sorted(k for k, v in checks.items() if not v)
    assert not failed, failed
    return k1, k2, k3


# -- elastic data parallelism across worker processes (slice 14) -------------

_EL_WORLD = 3
_EL_VICTIM = 1
_EL_FAULT_RC = 17
_EL_HB = ("0.25", "3")                  # heartbeat interval, timeout (s)
_EL_LEG_S = {False: 300, True: 200}     # one leg's hard limit in a worker
_EL_LAUNCH_S = {False: 420, True: 300}  # the launch's, the launcher's own
_EL_G2C = ("stage3", "stage4", "pool1", "flatten", "dense", "softmax")


def _el_cfg(rehearsal):
    """Sizes: ResNet-50 v1 at the data_parallel phase's width, batch 32 a
    worker (global 96 while three live, 64 after the loss), 3 epochs of 3
    batches; rank 1 delayed 250 ms at its first 4 dispatches, then killed
    at epoch 1, batch 1. The rehearsal takes the small net."""
    return {"batch": 4 if rehearsal else 32, "epochs": 3, "batches": 3,
            "delay_ms": 250, "delayed": 4, "kill_at": (1, 1)}


def _el_kill_crossing(cfg):
    """The victim's gate crossing (1-based: the ``kv_collective`` fault
    site's call number) at the step of ``cfg['kill_at']``: ``Module``
    calls ``kv.init`` once with every parameter's key, which crosses the
    store's gate once before its broadcasts, then every fused step
    crosses the step gate once."""
    epoch, nbatch = cfg["kill_at"]
    return 1 + epoch * cfg["batches"] + nbatch + 1


def _el_local(a, rank, batch):
    """Worker ``rank``'s rows of every global batch of ``batch * 3``."""
    g = batch * _EL_WORLD
    idx = np.concatenate([np.arange(i + rank * batch, i + (rank + 1) * batch)
                          for i in range(0, len(a), g)])
    return a[idx]


def _el_survivor_rows(a, batch, nbatch=0):
    """The survivors' rows (ranks 0 and 2) of global batch ``nbatch``."""
    g = a[nbatch * batch * _EL_WORLD:(nbatch + 1) * batch * _EL_WORLD]
    return np.concatenate([g[r * batch:(r + 1) * batch]
                           for r in range(_EL_WORLD) if r != _EL_VICTIM])


def _el_ckpt_prefix(out, rank):
    return os.path.join(out, "ckpt", "r%d" % rank, "model")


def _el_step_from_ckpt(mx, ctx, cfg, rehearsal, prefix, dtype, rank=None):
    """One fused step from the checkpoint that resumes epoch 1 (weights,
    moving stats and momentum), in ``dtype``: ``rank`` None, one process
    on the survivors' 64 rows of global batch 0 (a ``device`` store);
    else this survivor's rows over ``dist_sync`` (the survivors' group).
    fp64 runs the unfused net (K1 takes fp32 and bf16 only), its names
    mapped from the fused net's. Returns the weights after the step under
    the fused net's names, on the host."""
    net, sym, hw, classes = _resnet_net(mx, ctx, rehearsal, init=False)
    names = list(net.collect_params())
    rename = {k: k for k in names}
    if dtype == "float64":
        net, sym, _, _ = _resnet_net(mx, ctx, rehearsal, fused=False,
                                     init=False)
        rename = dict(zip(net.collect_params(), names))
    del net
    back = {f: u for u, f in rename.items()}
    mgr = mx.CheckpointManager(prefix, keep_last=4)
    with open("%s-%04d.meta.json" % (prefix, 1)) as f:
        meta = json.load(f)
    _, arg, aux, _ = mgr.load(meta)
    tdt = getattr(torch, dtype)
    arg = {back[k]: v._data.to(tdt) for k, v in arg.items()}
    aux = {back[k]: v._data.to(tdt) for k, v in aux.items()}
    batch = cfg["batch"]
    x, y = _module_data(cfg["batches"], batch * _EL_WORLD, hw, classes)
    if rank is None:
        x, y = _el_survivor_rows(x, batch), _el_survivor_rows(y, batch)
    else:
        x, y = _el_local(x, rank, batch)[:batch], \
            _el_local(y, rank, batch)[:batch]
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([mx.io.DataDesc("data", x.shape, dtype)],
             [mx.io.DataDesc("softmax_label", y.shape, dtype)])
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(kvstore=mx.kv.create("device" if rank is None
                                            else "dist_sync"),
                       optimizer="sgd",
                       optimizer_params=_dp_opt(batch * _EL_WORLD))
    # the momentum by name (the fused and unfused symbols order their
    # parameters alike, but a name is the contract), cast to ``dtype``
    from mxnet_tpu_torch.optimizer import _StatesUnpickler
    with open("%s-%04d.states" % (prefix, int(meta["param_epoch"])),
              "rb") as f:
        states = _StatesUnpickler(f).load()
    if isinstance(states, tuple):           # (states, dumped optimizer)
        states = states[0]
    fused = [rename[n] for n in mod._param_names]
    ckpt_names = [n for n in mx.sym.load("%s-symbol.json" % prefix)
                  .list_arguments() if n not in ("data", "softmax_label")]
    upd = mod._active_updater()
    upd.states = {fused.index(ckpt_names[i]): None if s is None else
                  np.asarray(s).astype(dtype) for i, s in states.items()}
    upd.states_synced = {k: False for k in upd.states}
    assert mod.fused_step(mx.io.DataBatch(
        [mx.nd.array(x, ctx=ctx, dtype=dtype)],
        [mx.nd.array(y, ctx=ctx, dtype=dtype)]))
    out = {rename[k]: v._data.to("cpu", copy=True)
           for k, v in mod.get_params()[0].items()}
    del mod
    mx.layout.set_default_layout(None)
    return out


def _el_timeline(events):
    """ms a step by CUDA events between batch ends of one epoch of one
    membership (the first batch of an epoch, which follows a checkpoint,
    and the step the loss aborted, are not steps of their own), and host
    seconds in collectives a step, before and after the loss."""
    out = {"before": [], "after": [], "wire_before": [], "wire_after": []}
    for a, b in zip(events, events[1:]):
        if a["epoch"] != b["epoch"] or a["resumed"] != b["resumed"]:
            continue
        key = "after" if b["resumed"] else "before"
        if a.get("ev") is not None:
            out[key].append(a["ev"].elapsed_time(b["ev"]))
        out["wire_" + key].append(b["wire_s"] - a["wire_s"])
    return out


def _el_pcts(vals):
    if not vals:
        return None
    v = sorted(vals)
    return {"p50": v[len(v) // 2], "p95": v[min(len(v) - 1,
                                                int(0.95 * len(v)))],
            "n": len(v)}


def _el_fit_leg(mx, ctx, cfg, rank, out, rehearsal):
    """The main path in a worker: ResNet-50 v1 through ``Module.fit`` on
    ``dist_sync`` with a checkpoint manager of its own; rank 1 a
    straggler first, then killed at its ``kv_collective`` crossing.
    Returns the worker's record (the victim writes it and dies)."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    from mxnet_tpu_torch.parallel import collectives as C
    gpu = ctx.device_type == "gpu"
    net, sym, hw, classes = _resnet_net(mx, ctx, rehearsal)
    aux_names = set(sym.list_auxiliary_states())
    params = {k: p.data()._data.clone() for k, p in
              net.collect_params().items()}
    del net
    arg = {k: v for k, v in params.items() if k not in aux_names}
    aux = {k: v for k, v in params.items() if k in aux_names}
    kill = _el_kill_crossing(cfg)
    batch = cfg["batch"]
    x, y = _module_data(cfg["batches"], batch * _EL_WORLD, hw, classes)
    x, y = _el_local(x, rank, batch), _el_local(y, rank, batch)
    if rank == _EL_VICTIM:
        mx.faults.configure("dispatch:delay=%d:first=%d;"
                            "kv_collective:raise:n=%d"
                            % (cfg["delay_ms"], cfg["delayed"], kill))
    mgr = mx.CheckpointManager(_el_ckpt_prefix(out, rank), keep_last=4)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (batch, hw, hw, 3))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params=arg, aux_params=aux)
    metric = mx.metric.create(["acc", "ce"])
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    events, rec = [], {"rank": rank, "kill_crossing": kill,
                       "parameters": len(arg)}

    def batch_end(param):
        resumed = bool(mx.telemetry.counters().get("elastic.resumed"))
        ev = None
        if gpu:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        events.append({"epoch": param.epoch, "nbatch": param.nbatch,
                       "resumed": resumed, "wall": time.time(), "ev": ev,
                       "wire_s": C.wire["seconds"]})
        if resumed and "step1" not in rec and rank == 0:
            rec["step1"] = True
            torch.save({k: v._data.to("cpu", copy=True) for k, v in
                        mod.get_params()[0].items()},
                       os.path.join(out, "resumed-step1.pt"))

    mx.telemetry.enable()
    mx.telemetry.reset()
    C.reset_wire()
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts zeroed just before, read just after --------
    K.launches = K.bwd_launches = 0
    t0 = time.perf_counter()
    try:
        mod.fit(it, eval_metric=metric, num_epoch=cfg["epochs"],
                kvstore=mx.kv.create("dist_sync"), optimizer="sgd",
                optimizer_params=_dp_opt(batch * _EL_WORLD),
                batch_end_callback=batch_end, checkpoint=mgr)
    except mx.faults.InjectedFault:
        died = time.time()
        if gpu:
            torch.cuda.synchronize()
        cnt = mx.telemetry.counters()
        rec.update({"died": died, "k1_launches": K.launches,
                    "k1_bwd_launches": K.bwd_launches,
                    "fused_steps": cnt.get("kvstore.dist.fused_steps", 0),
                    "kv_crossings": cnt.get("heartbeat.gate_crossings.kv"),
                    "step_crossings": cnt.get(
                        "heartbeat.gate_crossings.step"),
                    "fault_counts": mx.faults.counts()})
        with open(os.path.join(out, "r%d.json" % rank), "w") as f:
            json.dump(rec, f)
        mx.dist.abort(_EL_FAULT_RC)
    if gpu:
        torch.cuda.synchronize()
    rec["fit_wall_s"] = time.perf_counter() - t0
    rec["k1_launches"], rec["k1_bwd_launches"] = K.launches, K.bwd_launches
    # ---------------------------------------------------------------------
    cnt = mx.telemetry.counters()
    rec["counters"] = {k: v for k, v in cnt.items() if k.startswith(
        ("elastic.", "heartbeat.", "kvstore.dist", "dist.straggler"))}
    rec["fused_steps"] = cnt.get("kvstore.dist.fused_steps", 0)
    rec["elastic_events"] = [{"kind": e["kind"], "ts": e["ts"],
                              "data": e["data"]}
                             for e in mx.telemetry.events()
                             if e["kind"].startswith("elastic.")]
    rec["first_resumed_step_end"] = next(
        (e["wall"] for e in events if e["resumed"]), None)
    tl = _el_timeline(events)
    rec["ms_per_step"] = {"before_loss": tl["before"],
                          "after_loss": tl["after"]}
    rec["collective_host_s_per_step"] = {
        "before_loss": tl["wire_before"], "after_loss": tl["wire_after"]}
    waits = collections.defaultdict(list)
    for s in mx.telemetry.recent_spans():
        if s["name"] == "gate_wait":
            waits[s["ctx"].get("channel")].append(s["dur_ms"])
    rec["gate_wait_ms"] = {ch: _el_pcts(v) for ch, v in waits.items()}
    rec["live_ranks"] = list(mx.dist.live_ranks())
    rec["dead_ranks"] = list(mx.dist.dead_ranks())
    rec["metric"] = metric.get_name_value()
    d_arg, d_aux = _dp_module_digest(mod)
    rec["digest"], rec["aux_digest"] = d_arg, d_aux
    if gpu:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        data = mx.io.DataBatch([mx.nd.array(x[:batch], ctx=ctx)],
                               [mx.nd.array(y[:batch], ctx=ctx)])
        rec["profiled_step"] = _dp_collective_steps(
            lambda: mod.fused_step(data), rank, gpu)
    del mod
    _free(gpu)
    return rec


def el_worker(out, rehearsal):
    """One worker of the elastic phase (``chip_smoke.py --el-worker DIR``,
    started by ``python -m mxnet_tpu_torch.launch -n 3 --heartbeat-dir``):
    the fit leg, then on the survivors the fp64 step from the checkpoint
    over the survivors' group; writes ``r<rank>.json`` under ``out``."""
    import mxnet_tpu_torch as mx
    rank = mx.dist.rank()
    assert mx.dist.process_count() == _EL_WORLD, mx.dist.process_count()
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = _el_cfg(rehearsal)
    with _dp_deadline(rehearsal, "elastic_fit"):
        rec = _el_fit_leg(mx, ctx, cfg, rank, out, rehearsal)
    with _dp_deadline(rehearsal, "elastic_fp64_step"):
        w64 = _el_step_from_ckpt(mx, ctx, cfg, rehearsal,
                                 _el_ckpt_prefix(out, rank), "float64",
                                 rank=rank)
        if rank == 0:
            torch.save(w64, os.path.join(out, "resumed-fp64-step1.pt"))
        del w64
    rec.update({"backend": mx.dist.backend(), "world": _EL_WORLD,
                "pid": os.getpid()})
    with open(os.path.join(out, "r%d.json" % rank), "w") as f:
        json.dump(rec, f)
    mx.dist.finalize()


def _el_launch(out, rehearsal):
    """The three workers through the port's launcher with a heartbeat
    directory, under its hard timeout. Returns the launcher's exit code,
    its standard error, each rank's record and the seconds."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
           str(_EL_WORLD), "--timeout", str(_EL_LAUNCH_S[rehearsal]),
           "--heartbeat-dir", os.path.join(out, "hb"),
           "--heartbeat-interval", _EL_HB[0], "--heartbeat-timeout",
           _EL_HB[1]]
    if rehearsal:
        cmd.append("--force-cpu")
    cmd += ["--", sys.executable, os.path.abspath(__file__), "--el-worker",
            out] + (["--cpu-rehearsal"] if rehearsal else [])
    env = dict(os.environ, MXNET_FLIGHT_DIR=os.path.join(out, "flight"),
               MXNET_METRICS_INTERVAL_MS="200")
    env.pop("MXNET_FAULTS", None)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=here, capture_output=True,
                         text=True, timeout=_EL_LAUNCH_S[rehearsal] + 60)
    secs = time.perf_counter() - t0
    sys.stderr.write(res.stderr[-20000:])
    recs = []
    for r in range(_EL_WORLD):
        with open(os.path.join(out, "r%d.json" % r)) as f:
            recs.append(json.load(f))
    return res.returncode, res.stderr, recs, secs


def _el_group2ctx_leg(mx, ctx, rehearsal):
    """``Module(group2ctxs=)`` on the card: (1) ResNet-50 v1 with stages 3,
    4 and the head in group ``g2`` and the rest in ``g1``, both on
    ``gpu(0)``, one ``fit`` batch against the ungrouped module's (the
    grouped step phase-splits, code ``group2ctx``; bit-equal to the
    ungrouped phase-split step, and the ungrouped fused step reported);
    (2) the MLP with ``g1`` on ``cpu(0)`` and ``g2`` on ``gpu(0)``: a real
    copy between host and card, forward and gradients against an
    ungrouped card run within 1e-6 of the largest value. Returns the
    leg's record and its K1 launches."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    gpu = ctx.device_type == "gpu"
    net, sym, hw, classes = _resnet_net(mx, ctx, rehearsal)
    aux_names = set(sym.list_auxiliary_states())
    params = {k: p.data()._data.clone() for k, p in
              net.collect_params().items()}
    del net
    arg = {k: v for k, v in params.items() if k not in aux_names}
    aux = {k: v for k, v in params.items() if k in aux_names}
    grouped = mx.sym.load_json(sym.tojson())
    for node in grouped._topo_nodes():
        node._extra_attrs["ctx_group"] = \
            "g2" if any(s in node.name for s in _EL_G2C) else "g1"
    n_fused = sum(1 for n in sym._topo_nodes() if n.op is not None
                  and n.op.name == "_contrib_BatchNormAddReLU")
    batch = 32 if not rehearsal else 4
    x, y = _module_data(1, batch, hw, classes, seed=5)

    def one_batch(s, g2c, fused):
        pin = os.environ.get("MXNET_MODULE_FUSED_STEP")
        os.environ["MXNET_MODULE_FUSED_STEP"] = "1" if fused else "0"
        try:
            mod = mx.mod.Module(s, context=ctx, group2ctxs=g2c)
            K.launches = K.bwd_launches = 0
            mod.fit(mx.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
                    arg_params=arg, aux_params=aux, kvstore=None,
                    optimizer="sgd", optimizer_params=_dp_opt(batch))
            launches = (K.launches, K.bwd_launches)
            code = getattr(mod._fused_fallback_reason, "code", None)
            got = _host_params(mod)
            ctxs = sorted({str(a.context) for a in
                           mod._exec.arg_dict.values()})
        finally:
            if pin is None:
                os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
            else:
                os.environ["MXNET_MODULE_FUSED_STEP"] = pin
        del mod
        _free(gpu)
        return got, launches, code, ctxs
    # -- the main path (the grouped batch): counts zeroed inside ---------
    g_par, (g_k1, g_bwd), g_code, g_ctxs = one_batch(
        grouped, {"g1": ctx, "g2": ctx}, True)
    # ---------------------------------------------------------------------
    u_par, (u_k1, _), _, _ = one_batch(sym, None, False)
    f_par, _, _, _ = one_batch(sym, None, True)
    rec = {"resnet": {
        "groups": {"g1": str(ctx), "g2": str(ctx)},
        "g2_nodes": sum(1 for n in grouped._topo_nodes()
                        if n._extra_attrs.get("ctx_group") == "g2"),
        "fallback": g_code, "contexts": g_ctxs, "k1_launches": g_k1,
        "k1_bwd_launches": g_bwd,
        "k1_expected": n_fused if gpu else 0, "ungrouped_k1_launches": u_k1,
        "bit_equal_ungrouped_phase_split": all(
            _bit_equal(a, b) for a, b in zip(g_par, u_par)),
        "bit_equal_ungrouped_fused": all(
            _bit_equal(a, b) for a, b in zip(g_par, f_par))}}
    mx.layout.set_default_layout(None)
    # (2) the MLP across host and card
    rs = np.random.RandomState(0)
    xm = rs.uniform(-1, 1, (4, 6)).astype(np.float32)
    w1 = rs.uniform(-0.5, 0.5, (5, 6)).astype(np.float32)
    w2 = rs.uniform(-0.5, 0.5, (3, 5)).astype(np.float32)

    def mlp(g2c):
        with mx.AttrScope(ctx_group="g1"):
            h = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=5,
                                      no_bias=True, name="fc1")
            h = mx.sym.Activation(h, act_type="tanh")
        with mx.AttrScope(ctx_group="g2"):
            h = mx.sym.FullyConnected(h, num_hidden=3, no_bias=True,
                                      name="fc2")
        ex = h.simple_bind(ctx=ctx, grad_req="write", group2ctx=g2c,
                           data=(4, 6))
        ex.arg_dict["data"][:] = xm
        ex.arg_dict["fc1_weight"][:] = w1
        ex.arg_dict["fc2_weight"][:] = w2
        o = ex.forward_backward(out_grads=mx.nd.ones((4, 3), ctx=ctx),
                                is_train=True)[0]
        return ex, o
    ex, o = mlp({"g1": mx.cpu(0), "g2": ctx})
    rex, ro = mlp(None)
    top = float(np.abs(ro.asnumpy()).max())
    gerr = {k: float(np.abs(ex.grad_dict[k].asnumpy()
                            - rex.grad_dict[k].asnumpy()).max()
                     / np.abs(rex.grad_dict[k].asnumpy()).max())
            for k in ("fc1_weight", "fc2_weight")}
    rec["mlp"] = {
        "groups": {"g1": "cpu(0)", "g2": str(ctx)},
        "fc1_on": str(ex.arg_dict["fc1_weight"]._data.device),
        "fc1_grad_on": str(ex.grad_dict["fc1_weight"]._data.device),
        "fc2_on": str(ex.arg_dict["fc2_weight"]._data.device),
        "out_context": str(o.context),
        "out_err_over_max": float(np.abs(o.asnumpy() - ro.asnumpy()).max())
        / top, "grad_err_over_max": gerr, "tol": 1e-6}
    return rec, g_k1


def elastic_phase(mx, ctx, rehearsal, card):
    """Elastic data parallelism on one card (the JAX package's
    ``tools/module_fit_probe.py`` leg C at the data_parallel phase's
    width): three workers of ``python -m mxnet_tpu_torch.launch -n 3
    --heartbeat-dir`` share ``cuda:0`` over gloo; rank 1 straggles, then
    dies at its ``kv_collective`` crossing of epoch 1, batch 1; the
    survivors name it, re-mesh over {0, 2} and resume from their
    checkpoints. Then the ``group2ctxs`` leg. Returns the K1, K2 and K3
    launches of the path."""
    gpu = ctx.device_type == "gpu"
    cfg = _el_cfg(rehearsal)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _free(gpu)
    out = tempfile.mkdtemp(prefix="chip_smoke_el_")
    try:
        return _elastic(mx, ctx, rehearsal, card, cfg, gpu, out)
    finally:
        import shutil
        shutil.rmtree(out, ignore_errors=True)
        torch.backends.cudnn.deterministic = det
        mx.layout.set_default_layout(None)
        _free(gpu)


def _elastic(mx, ctx, rehearsal, card, cfg, gpu, out):
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    rc, stderr, recs, launch_s = _el_launch(out, rehearsal)
    r0, rv, r2 = recs
    kill = r0["kill_crossing"]
    print("elastic: rank %d is killed at its gate crossing %d (1 for "
          "kv.init of %d parameters, then one a step up to epoch %d batch "
          "%d of %d-batch epochs)"
          % (_EL_VICTIM, kill, r0["parameters"], cfg["kill_at"][0],
             cfg["kill_at"][1], cfg["batches"]), flush=True)
    checks = {}
    codes = [line for line in stderr.splitlines()
             if line.startswith("launch: worker exit codes")]
    checks["victim_fault_code_survivors_0"] = (
        rc == _EL_FAULT_RC and bool(codes)
        and codes[-1].endswith("[0, %d, 0]" % _EL_FAULT_RC))
    for r, rec in ((0, r0), (2, r2)):
        for k in ("elastic.dead_workers", "elastic.remesh",
                  "elastic.resumed"):
            checks["rank%d_%s_is_1" % (r, k)] = \
                rec["counters"].get(k) == 1
        checks["rank%d_live_0_2" % r] = rec["live_ranks"] == [0, 2]
    checks["survivors_bit_equal"] = r0["digest"] == r2["digest"] \
        and r0["aux_digest"] == r2["aux_digest"]
    checks["victim_crossings_counted"] = (
        rv["kv_crossings"] == 1 and rv["step_crossings"] == kill - 2
        and rv["fault_counts"]["kv_collective"]["calls"] == kill)
    # K1: 16 a forward and 16 a backward on every worker (the victim's 4
    # steps, its last dying at the gradients' collective; the survivors'
    # 4 before and 6 after the loss)
    steps = {"victim": cfg["batches"] + cfg["kill_at"][1],
             "survivor": cfg["batches"] + cfg["kill_at"][1]
             + (cfg["epochs"] - cfg["kill_at"][0]) * cfg["batches"]}
    tails = 16 if not rehearsal else 0
    checks["k1_16_a_forward_every_worker"] = (
        rv["fused_steps"] == steps["victim"]
        and rv["k1_launches"] == rv["k1_bwd_launches"]
        == tails * steps["victim"]
        and all(r["fused_steps"] == steps["survivor"]
                and r["k1_launches"] == r["k1_bwd_launches"]
                == tails * steps["survivor"] for r in (r0, r2)))
    _K1_BWD["elastic"] += sum(r["k1_bwd_launches"] for r in (rv, r0, r2))
    # the postmortems through tools/flight_view.py
    flight = os.path.join(out, "flight")
    pms = sorted(f for f in os.listdir(flight)
                 if f.endswith("dead_worker.json"))
    views = []
    for f in pms:
        v = subprocess.run([sys.executable,
                            os.path.join(here, "tools", "flight_view.py"),
                            os.path.join(flight, f), "--json"],
                           capture_output=True, text=True, timeout=60)
        views.append(json.loads(v.stdout)["extra"] if v.returncode == 0
                     else None)
    checks["dead_worker_postmortems"] = len(views) == 2 and all(
        e is not None and e["dead_ranks"] == [_EL_VICTIM]
        and (e["epoch"], e["nbatch"]) == tuple(cfg["kill_at"])
        and any(p["rank"] == _EL_VICTIM and p["reason"] == "worker_abort"
                for p in e["peer_postmortems"]) for e in views)
    # the fleet view
    trace = os.path.join(out, "fleet-trace.json")
    fv = subprocess.run([sys.executable,
                         os.path.join(here, "tools", "fleet_view.py"),
                         flight, "--json", "--trace", trace],
                        capture_output=True, text=True, timeout=60)
    fleet = json.loads(fv.stdout) if fv.returncode == 0 else None
    checks["fleet_view_parses"] = fleet is not None
    if fleet is not None:
        top = fleet["stragglers"][0] if fleet["stragglers"] else {}
        offs = fleet["clock"]["offsets_s"]
        checks["fleet_names_rank1_dead"] = fleet["dead_ranks"] == [1]
        checks["fleet_rank1_first_straggler"] = (
            top.get("rank") == 1 and top.get("straggler_events", 0) > 0)
        checks["fleet_clocks_within_0.25s"] = bool(offs) and all(
            abs(o) <= 0.25 for o in offs.values())
    # the first step after the resume against one process from the same
    # checkpoint on the survivors' 64 rows (fp32 gate, fp64 arbiter)
    t_ref = time.perf_counter()
    prefix = _el_ckpt_prefix(out, 0)
    one = _el_step_from_ckpt(mx, ctx, cfg, rehearsal, prefix, "float32")
    _free(gpu)
    one64 = _el_step_from_ckpt(mx, ctx, cfg, rehearsal, prefix, "float64")
    _free(gpu)
    mgr = mx.CheckpointManager(prefix, keep_last=4)
    with open("%s-%04d.meta.json" % (prefix, 1)) as f:
        _, w0, _, _ = mgr.load(json.load(f))
    w0 = {k: v._data for k, v in w0.items()}
    got = torch.load(os.path.join(out, "resumed-step1.pt"))
    got64 = torch.load(os.path.join(out, "resumed-fp64-step1.pt"))
    gate_ok, gate = _dp_gate(got, got64, one, one64, w0)
    checks["resumed_step1_gate"] = gate_ok
    ref_s = time.perf_counter() - t_ref
    # group2ctxs on the card
    t_g = time.perf_counter()
    g2c, g_k1 = _el_group2ctx_leg(mx, ctx, rehearsal)
    g_s = time.perf_counter() - t_g
    checks["group2ctx_resnet_bit_equal"] = \
        g2c["resnet"]["bit_equal_ungrouped_phase_split"]
    checks["group2ctx_phase_split"] = g2c["resnet"]["fallback"] == "group2ctx"
    checks["group2ctx_k1_16_a_forward"] = \
        g2c["resnet"]["k1_launches"] == g2c["resnet"]["k1_bwd_launches"] \
        == g2c["resnet"]["k1_expected"]
    _K1_BWD["elastic"] += g2c["resnet"]["k1_bwd_launches"]
    m = g2c["mlp"]
    checks["group2ctx_mlp_host_and_card"] = (
        m["out_err_over_max"] <= 1e-6
        and max(m["grad_err_over_max"].values()) <= 1e-6
        and m["fc1_on"] == "cpu" and m["fc1_grad_on"] == "cpu")
    # timings of the recovery, on rank 0's clock and the victim's
    ev = {e["kind"]: e["ts"] for e in r0["elastic_events"]}
    died = rv["died"]
    recovery = {
        "to_dead_worker_error_s": ev.get("elastic.dead_worker", 0) - died,
        "to_remesh_s": ev.get("elastic.remesh", 0) - died,
        "to_first_resumed_step_s": (r0["first_resumed_step_end"] or 0)
        - died}
    k1 = rv["k1_launches"] + r0["k1_launches"] + r2["k1_launches"] + g_k1
    emit({"elastic": {
        "card": card, "world": _EL_WORLD, "backend": r0["backend"],
        "heartbeat": {"interval_s": float(_EL_HB[0]),
                      "timeout_s": float(_EL_HB[1])},
        "kill_crossing": kill, "parameters": r0["parameters"],
        "launcher_rc": rc, "exit_codes": codes[-1:] if codes else None,
        "seconds": {"launch": launch_s, "references": ref_s,
                    "group2ctx": g_s,
                    "phase": time.perf_counter() - t_phase},
        "rank0_ms_per_step": r0["ms_per_step"],
        "rank0_collective_host_s_per_step":
            r0["collective_host_s_per_step"],
        "recovery": recovery,
        "gate_wait_ms_per_crossing": {"rank0": r0["gate_wait_ms"],
                                      "rank2": r2["gate_wait_ms"]},
        "profiled_step_rank0": r0.get("profiled_step"),
        "peak_bytes": [r0.get("peak_bytes"), rv.get("peak_bytes"),
                       r2.get("peak_bytes")],
        "fused_steps": [r0["fused_steps"], rv["fused_steps"],
                        r2["fused_steps"]],
        "k1_launches": [r0["k1_launches"], rv["k1_launches"],
                        r2["k1_launches"]],
        "counters_rank0": r0["counters"],
        "postmortem_extras": [{k: e.get(k) for k in (
            "dead_ranks", "channel", "generation", "epoch", "nbatch",
            "survivor_rank", "live_ranks")} if e else None for e in views],
        "fleet": fleet and {k: fleet.get(k) for k in (
            "n_ranks", "dead_ranks", "stragglers", "clock", "warnings")},
        "resumed_step1_gate": gate, "group2ctx": g2c,
        "launches": {"k1": k1, "k2": 0, "k3": 0},
        "checks": checks}})
    failed = sorted(k for k, v in checks.items() if not v)
    assert not failed, failed
    return k1, 0, 0


_SP_WORLD = 2
_SP_LAUNCH_S = {False: 300, True: 180}  # the two workers' hard limit
_SP_CARRY_S = 90                        # what the leg adds to dp's launch
_SP_DENSE_BATCH_GB = 4.0                # gate (f): far below a dense batch


def _sp_cfg(rehearsal):
    """``examples/sparse/linear_classification.py`` at Avazu's width:
    1,000,001 features, batch 8192, ~15 non-zeros a row (one-hot
    categorical fields), 2 classes, SGD lr 0.5 with ``rescale_grad``
    1/batch in a ``device`` store; 2 epochs of 4 batches (32,768 rows).
    The rehearsal takes the example's own defaults (1000 features, batch
    64)."""
    if rehearsal:
        return {"features": 1000, "batch": 64, "nnz": 15, "batches": 4,
                "epochs": 2, "lr": 0.5}
    return {"features": 1_000_001, "batch": 8192, "nnz": 15, "batches": 4,
            "epochs": 2, "lr": 0.5}


def sp_write_libsvm(path, features, rows, nnz, seed=0):
    """The example's data (``write_synthetic_libsvm``: the label is the
    sign of a sparse linear functional, values ``%.4f``), drawn fast: the
    ids of a row by ``integers`` and then de-duplicated (the example's
    ``choice(..., replace=False)`` permutes every id for every row)."""
    rng = np.random.default_rng(seed)
    true_w = rng.standard_normal(features)
    ids = np.sort(rng.integers(0, features, (rows, nnz)), axis=1)
    keep = np.ones(ids.shape, bool)
    keep[:, 1:] = ids[:, 1:] != ids[:, :-1]
    vals = rng.standard_normal((rows, nnz))
    labels = ((true_w[ids] * vals * keep).sum(1) > 0).astype(int)
    with open(path, "w") as f:
        for i in range(rows):
            k = keep[i]
            f.write("%d %s\n" % (labels[i], " ".join(
                "%d:%.4f" % kv for kv in zip(ids[i][k], vals[i][k]))))


def _sp_host_csr(x):
    from scipy import sparse as sps
    return sps.csr_matrix((x.data.asnumpy().astype(np.float64),
                           x.indices.asnumpy(), x.indptr.asnumpy()),
                          shape=x.shape)


def _sp_rel(got, ref):
    """Largest |got - ref| over the largest |ref| (1 where ref is 0)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    return err / (scale or 1.0)


def _sp_rows_unchanged(before, after, touched):
    """Every row outside ``touched`` bit-unchanged, on the device."""
    keep = torch.ones(before.shape[0], dtype=torch.bool,
                      device=before.device)
    keep[torch.as_tensor(touched, dtype=torch.long, device=before.device)] \
        = False
    return bool(torch.equal(before[keep], after[keep]))


class _SpStep:
    """One batch of the example's loop: pull the batch's rows, the
    forward and backward under ``record``, the gradient row-sparse, a
    push that runs the store's lazy SGD, the bias's own update. With
    ``dist`` the bias lives in the store too and one key list carries
    both (the row-sparse and dense wire in one push)."""

    def __init__(self, mx, ctx, cfg, kv, dist=False):
        self.mx, self.ctx, self.kv, self.dist = mx, ctx, kv, dist
        f = cfg["features"]
        self.weight = mx.nd.zeros((f, 2), ctx=ctx)
        self.bias = mx.nd.zeros((2,), ctx=ctx)
        self.opt = mx.optimizer.create("sgd", learning_rate=cfg["lr"],
                                       rescale_grad=1.0 / cfg["batch"])
        if dist:
            kv.init(["weight", "bias"], [self.weight, self.bias])
        else:
            kv.init("weight", self.weight)
        kv.set_optimizer(self.opt)
        self.b_state = self.opt.create_state(1, self.bias)
        self.sync_s = 0.0

    def __call__(self, b):
        mx, sp, ctx = self.mx, self.mx.nd.sparse, self.ctx
        x, y = b.data[0], b.label[0]
        t0 = time.perf_counter()
        row_ids = mx.nd.array(np.unique(x.indices.asnumpy()), dtype="int64",
                              ctx=ctx)
        self.sync_s += time.perf_counter() - t0
        w_rsp = sp.zeros("row_sparse", self.weight.shape, ctx=ctx)
        self.kv.row_sparse_pull("weight", out=w_rsp, row_ids=row_ids)
        if self.dist:
            self.kv.pull("bias", out=self.bias)
        w_dense = w_rsp.tostype("default")
        w_dense.attach_grad()
        self.bias.attach_grad()
        with mx.autograd.record():
            pred = sp.dot(x, w_dense) + self.bias
            loss = mx.nd.softmax_cross_entropy(pred, y)
        loss.backward()
        t0 = time.perf_counter()
        grad = sp.cast_storage(w_dense.grad, "row_sparse")
        self.sync_s += time.perf_counter() - t0
        if self.dist:
            self.kv.push(["weight", "bias"], [grad, self.bias.grad])
        else:
            self.kv.push("weight", grad)
            self.opt.update(1, self.bias, self.bias.grad, self.b_state)
        return {"x": x, "y": y, "pred": pred, "loss": loss, "grad": grad,
                "row_ids": row_ids}


def _sp_host_top(fn, n=12):
    """``fn()`` under ``cProfile``: its result and the ``n`` functions with
    the most host time of their own (ms), where a call that waits for the
    card counts its wait."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    out = prof.runcall(fn)
    st = pstats.Stats(prof).stats
    top = sorted(st.items(), key=lambda kv: -kv[1][2])[:n]
    return out, [["%s:%d %s" % (os.path.basename(k[0]), k[1], k[2]),
                  v[2] * 1e3, v[1]] for k, v in top]


def _sp_timed(step, b, gpu, host_top=None):
    """(out, ms by CUDA events, host ms, host-sync ms) of one batch; with
    ``host_top`` a list, the batch runs under ``cProfile`` and its top
    host functions are appended."""
    step.sync_s = 0.0
    if gpu:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    if host_top is None:
        out = step(b)
    else:
        out, top = _sp_host_top(lambda: step(b))
        host_top.append(top)
    if gpu:
        end.record()
    host = (time.perf_counter() - t0) * 1e3
    if gpu:
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) if gpu else host
    return out, ms, host, step.sync_s * 1e3


def _sp_first_batch_gates(mx, step, b, out, cfg):
    """Gate (a): the first batch against float64 on the host: the sparse
    ``dot`` at a seeded random weight, the row-sparse gradient (row set
    and values) and the store's weight after the lazy SGD step; rows the
    batch did not touch bit-unchanged (still zero)."""
    X = _sp_host_csr(out["x"])
    y = out["y"].asnumpy().astype(int)
    f = cfg["features"]
    gen = torch.Generator(device=step.weight._data.device).manual_seed(3)
    w_r = torch.randn((f, 2), generator=gen, device=step.weight._data.device)
    got = mx.nd.sparse.dot(out["x"], mx.nd.NDArray(w_r, step.ctx)).asnumpy()
    fwd = _sp_rel(got, X @ w_r.cpu().double().numpy())
    z = np.zeros((X.shape[0], 2))              # zero weight and bias
    p = np.exp(z - z.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    p[np.arange(len(y)), y] -= 1.0
    g64 = np.asarray(X.T @ p)                  # (features, 2)
    rows64 = np.flatnonzero(np.any(g64 != 0, axis=1))
    gidx = out["grad"].indices.asnumpy()
    w = step.kv._store["weight"]._data
    touched = torch.as_tensor(gidx, dtype=torch.long, device=w.device)
    w_rows = w.index_select(0, touched).cpu().double().numpy()
    w64 = -cfg["lr"] * g64[gidx] / cfg["batch"]
    keep = torch.ones(f, dtype=torch.bool, device=w.device)
    keep[touched] = False
    checks = {
        "forward_rel": fwd,
        "pred_is_bias_at_zero_weight": bool(
            np.all(out["pred"].asnumpy() == 0.0)),
        "grad_rows_equal": bool(np.array_equal(gidx, rows64)),
        "grad_rows_are_the_batch_columns": bool(np.array_equal(
            gidx, np.unique(X.indices))),
        "grad_rel": _sp_rel(out["grad"].data.asnumpy(), g64[gidx]),
        "weight_rel": _sp_rel(w_rows, w64),
        "untouched_bit_unchanged": bool((w[keep] == 0).all()),
        "rows_touched": int(len(gidx))}
    checks["ok"] = bool(checks["forward_rel"] < 1e-5
                        and checks["pred_is_bias_at_zero_weight"]
                        and checks["grad_rows_equal"]
                        and checks["grad_rows_are_the_batch_columns"]
                        and checks["grad_rel"] < 1e-5
                        and checks["weight_rel"] < 1e-5
                        and checks["untouched_bit_unchanged"])
    return checks


def _sp_optimizer_gates(mx, step, grad, cfg):
    """Gate (b): one lazy step each of SGD with momentum, Adam and
    AdaGrad on a copy of the store's trained weight, with the first
    batch's row-sparse gradient, against a float64 recompute on the
    touched rows; untouched weight and state rows bit-unchanged."""
    rows = grad.indices.asnumpy().astype(np.int64)
    g64 = grad.data.asnumpy().astype(np.float64) / cfg["batch"]
    base = step.kv._store["weight"]._data
    w0 = base.index_select(0, torch.as_tensor(rows, device=base.device)) \
        .cpu().double().numpy()
    out = {}
    for name, kw in (("sgd", {"momentum": 0.9, "wd": 1e-4}),
                     ("adam", {"wd": 1e-4}), ("adagrad", {"wd": 1e-4})):
        opt = mx.optimizer.create(name, learning_rate=0.1,
                                  rescale_grad=1.0 / cfg["batch"], **kw)
        w = mx.nd.NDArray(base.clone(), step.ctx)
        st = opt.create_state(0, w)
        states = [s for s in (st if isinstance(st, tuple) else (st,))
                  if s is not None]
        opt.update(0, w, grad, st)
        g = g64 + 1e-4 * w0
        if name == "sgd":
            ref = w0 + (-0.1 * g)
        elif name == "adam":
            lr = 0.1 * np.sqrt(1 - 0.999) / (1 - 0.9)
            m, v = 0.1 * g, 0.001 * g * g
            ref = w0 - lr * m / (np.sqrt(v) + 1e-8)
        else:
            h = g64 * g64
            ref = w0 - 0.1 * (g64 / np.sqrt(h + 1e-7) + 1e-4 * w0)
        got = w._data.index_select(
            0, torch.as_tensor(rows, device=base.device)).cpu().double()
        out[name] = {
            "rel": _sp_rel(got.numpy() - w0, ref - w0),
            "untouched_weight": _sp_rows_unchanged(base, w._data, rows),
            "untouched_state": all(_sp_rows_unchanged(
                torch.zeros_like(s._data), s._data, rows) for s in states)}
        out[name]["ok"] = bool(out[name]["rel"] < 1e-5
                               and out[name]["untouched_weight"]
                               and out[name]["untouched_state"])
    return out


def _sp_pull_gate(mx, step, last_ids, cfg):
    """Gate (c): ``row_sparse_pull`` gives exactly the requested rows of
    the store's weight (its all-zero rows left out), bit for bit."""
    w = step.kv._store["weight"]._data
    f = cfg["features"]
    rng = np.random.default_rng(7)
    ask = np.concatenate([last_ids[::3], rng.integers(0, f, 64)])
    got = mx.nd.sparse.zeros("row_sparse", (f, 2), ctx=step.ctx)
    step.kv.row_sparse_pull("weight", out=got,
                            row_ids=mx.nd.array(ask, dtype="int64",
                                                ctx=step.ctx))
    uniq = torch.as_tensor(np.unique(ask), dtype=torch.long,
                           device=w.device)
    want_ids = uniq[(w.index_select(0, uniq) != 0).any(1)]
    ids = got._rsp_indices.long()
    ok = bool(torch.equal(ids, want_ids)
              and torch.equal(got._rsp_data, w.index_select(0, ids))
              and got._dense_cache is None)
    return {"ok": ok, "asked": int(len(ask)), "rows": int(ids.numel())}


def _sp_bucket(n):
    return max(8, 1 << (max(int(n), 1) - 1).bit_length())


def _sp_wire(counts, width=2, itemsize=4):
    """``mxnet_tpu/kvstore.py:392-437``: per row_sparse value the padded
    bucket of int32 ids and rows."""
    b = _sp_bucket(max(counts))
    return b * 4 + b * width * itemsize


def sp_worker(out, rehearsal):
    """One worker of the sparse phase's own two-worker launch
    (``chip_smoke.py --sp-worker DIR``, started by ``python -m
    mxnet_tpu_torch.launch -n 2`` when the data_parallel phase's workers
    do not carry the leg): :func:`_sp_worker_leg` under a hard limit."""
    import faulthandler
    import mxnet_tpu_torch as mx
    faulthandler.dump_traceback_later(_SP_LAUNCH_S[rehearsal] - 20,
                                      exit=True)
    _sp_worker_leg(mx, out, rehearsal)
    faulthandler.cancel_dump_traceback_later()
    mx.dist.finalize()


def _sp_worker_leg(mx, out, rehearsal):
    """The two-worker leg in one worker: the example's loop over a
    ``dist_sync`` store, this worker's share of the rows
    (``LibSVMIter(num_parts=2, part_index=rank)``, half the batch each),
    weight and bias pushed as one key list; then a probe push whose row
    only rank 1 touches, with a zero sum. Writes ``sp-r<rank>.json`` and,
    rank by rank, batch 1's gradient (``sp-grad-r<rank>.npz``)."""
    import hashlib
    rank = mx.dist.rank()
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    gpu = ctx.device_type == "gpu"
    cfg = _sp_cfg(rehearsal)
    if gpu:
        torch.cuda.reset_peak_memory_stats()
    kv = mx.kv.create("dist_sync")
    train = mx.io.LibSVMIter(data_libsvm=os.path.join(out, "train.libsvm"),
                             data_shape=(cfg["features"],),
                             batch_size=cfg["batch"] // _SP_WORLD,
                             num_parts=_SP_WORLD, part_index=rank, ctx=ctx)
    step = _SpStep(mx, ctx, cfg, kv, dist=True)
    k0 = _kernel_counts()
    rec = {"rank": rank, "backend": mx.dist.backend(), "batches": [],
           "world": mx.dist.process_count()}
    for i, b in enumerate(train):
        o, ms, host, sync = _sp_timed(step, b, gpu)
        w = kv._store["weight"]._data
        ids = o["grad"].indices.asnumpy()
        rec["batches"].append({
            "ms": ms, "host_ms": host, "sync_ms": sync, "rows": len(ids),
            "wire": kv.wire_bytes_last_push,
            "loss": float(o["loss"].asnumpy().sum()),
            "digest": hashlib.sha256(
                w.cpu().numpy().tobytes()
                + kv._store["bias"]._data.cpu().numpy().tobytes())
            .hexdigest()})
        if i == 0:
            np.savez(os.path.join(out, "sp-grad-r%d.npz" % rank),
                     indices=ids, data=o["grad"].data.asnumpy())
            if rank == 0:
                np.save(os.path.join(out, "sp-w1.npy"), w.cpu().numpy())
    # probe: rank 0 pushes a row it touched, rank 1 the last row no batch
    # touched (zero in the bit-equal weights), both as zeros; the store's
    # optimizer must see rank 1's row
    w = kv._store["weight"]._data
    probe = int(torch.nonzero((w == 0).all(1))[-1])
    mine = int(ids[0])
    seen = []
    orig = kv._updater.update_batch

    def record(indices, grads, weights):
        seen.append(grads[0].indices.asnumpy().tolist())
        return orig(indices, grads, weights)
    kv._updater.update_batch = record
    row = [mine] if rank == 0 else [probe]
    g = mx.nd.sparse.row_sparse_array(
        (np.zeros((1, 2), np.float32), row), shape=(cfg["features"], 2),
        ctx=ctx)
    kv.push(["weight", "bias"], [g, mx.nd.zeros((2,), ctx=ctx)])
    rec["probe"] = {"row": probe, "seen": seen[0],
                    "wire": kv.wire_bytes_last_push}
    rec["launches"] = [a - b for a, b in zip(_kernel_counts(), k0)]
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() if gpu else None
    with open(os.path.join(out, "sp-r%d.json" % rank), "w") as f:
        json.dump(rec, f)


def _sp_launch(out, rehearsal):
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
           str(_SP_WORLD), "--timeout", str(_SP_LAUNCH_S[rehearsal])]
    if rehearsal:
        cmd.append("--force-cpu")
    cmd += ["--", sys.executable, os.path.abspath(__file__), "--sp-worker",
            out] + (["--cpu-rehearsal"] if rehearsal else [])
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=here, capture_output=True,
                         text=True, timeout=_SP_LAUNCH_S[rehearsal] + 60)
    secs = time.perf_counter() - t0
    sys.stderr.write(res.stderr[-20000:])
    assert res.returncode == 0, ("sparse workers failed", res.returncode)
    recs = []
    for r in range(_SP_WORLD):
        with open(os.path.join(out, "sp-r%d.json" % r)) as f:
            recs.append(json.load(f))
    return recs, secs


def _sp_two_workers(mx, ctx, cfg, out, rehearsal, card):
    """The two-worker leg's gates: ranks bit-equal after every batch; the
    wire of every push by the formula and below the dense weight's bytes;
    after batch 1 the weight within 1e-6 of one process pushing both
    workers' gradients as a list to a ``device`` store; the probe's row
    reaching the optimizer. The records come from the data_parallel
    phase's workers where they carried the leg, else from a launch of
    two workers here."""
    if os.path.exists(os.path.join(out, "sp-r0.json")):
        recs, secs = [], None
        for r in range(_SP_WORLD):
            with open(os.path.join(out, "sp-r%d.json" % r)) as f:
                recs.append(json.load(f))
    else:
        recs, secs = _sp_launch(out, rehearsal)
    f = cfg["features"]
    dense_bytes = f * 2 * 4             # the weight pushed dense
    bit_equal = all(a["digest"] == b["digest"] for a, b in
                    zip(recs[0]["batches"], recs[1]["batches"]))
    wires = []      # [each rank's wire bytes, the formula's], a push
    for j in range(len(recs[0]["batches"])):
        counts = [r["batches"][j]["rows"] for r in recs]
        wires.append([[r["batches"][j]["wire"] for r in recs],
                      _sp_wire(counts) + 2 * 4])     # + the dense bias
    wire_ok = all(all(w == want for w in got) and want - 2 * 4 < dense_bytes
                  for got, want in wires)
    probe_wire = _sp_wire([1, 1]) + 2 * 4
    # one process, both gradients of batch 1 as one list
    kv = mx.kv.create("device")
    kv.init("weight", mx.nd.zeros((f, 2), ctx=ctx))
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=cfg["lr"],
                                         rescale_grad=1.0 / cfg["batch"]))
    gs = [np.load(os.path.join(out, "sp-grad-r%d.npz" % r))
          for r in range(_SP_WORLD)]
    kv.push("weight", [mx.nd.sparse.row_sparse_array(
        (g["data"], g["indices"]), shape=(f, 2), ctx=ctx) for g in gs])
    ref = kv._store["weight"].asnumpy()
    w1 = np.load(os.path.join(out, "sp-w1.npy"))
    rel = _sp_rel(w1, ref)
    untouched = np.ones(f, bool)
    for g in gs:
        untouched[g["indices"]] = False
    probes = [r["probe"] for r in recs]
    checks = {
        "ranks_bit_equal_every_batch": bit_equal, "wire_by_formula": wire_ok,
        "batch1_vs_one_process_rel": rel,
        "batch1_untouched_zero": bool((w1[untouched] == 0).all()),
        "probe_row_reached_optimizer": all(
            p["row"] == probes[1]["row"] and p["row"] in p["seen"]
            for p in probes),
        "probe_wire": all(p["wire"] == probe_wire for p in probes),
        "backend": [r["backend"] for r in recs],
        "no_kernel_launches": all(r["launches"] == [0, 0, 0] for r in recs)}
    ok = (bit_equal and wire_ok and rel < 1e-6
          and checks["batch1_untouched_zero"]
          and checks["probe_row_reached_optimizer"] and checks["probe_wire"]
          and checks["no_kernel_launches"])
    emit({"sparse_two_workers": {
        "card": card, "world": _SP_WORLD, "launch_s": secs,
        "carried_by_data_parallel_launch": secs is None,
        "per_worker_batch": cfg["batch"] // _SP_WORLD,
        "ms_per_batch_rank0": [b["ms"] for b in recs[0]["batches"]],
        "host_ms_per_batch_rank0": [b["host_ms"] for b in
                                    recs[0]["batches"]],
        "rows_per_batch": [[b["rows"] for b in r["batches"]] for r in recs],
        "wire_bytes_per_push": wires, "dense_weight_bytes": dense_bytes,
        "peak_bytes": [r["peak_bytes"] for r in recs], "checks": checks}})
    assert ok, checks


def sp_prepare(rehearsal):
    """A directory holding the phase's LibSVM file (32,768 rows at
    Avazu's width), made before the data_parallel phase when its workers
    carry the two-worker leg."""
    cfg = _sp_cfg(rehearsal)
    out = tempfile.mkdtemp(prefix="chip_smoke_sparse_")
    t0 = time.perf_counter()
    sp_write_libsvm(os.path.join(out, "train.libsvm"), cfg["features"],
                    cfg["batch"] * cfg["batches"], cfg["nnz"], seed=0)
    with open(os.path.join(out, "write_s"), "w") as f:
        f.write(repr(time.perf_counter() - t0))
    return out


def sparse_phase(mx, ctx, rehearsal, card, out=None):
    """The sparse linear classifier (``examples/sparse/
    linear_classification.py``) at Avazu's width on one card, then over
    ``dist_sync`` in two workers (``out``: the directory of
    :func:`sp_prepare`, where the data_parallel phase's workers may have
    left the two-worker leg's records). Returns the K1, K2 and K3
    launches of the phase (none: the sparse path has no hand-written
    kernel)."""
    gpu = ctx.device_type == "gpu"
    cfg = _sp_cfg(rehearsal)
    _free(gpu)
    t_phase = time.perf_counter()
    out = out or sp_prepare(rehearsal)
    try:
        return _sparse(mx, ctx, rehearsal, card, cfg, gpu, out, t_phase)
    finally:
        import shutil
        shutil.rmtree(out, ignore_errors=True)
        _free(gpu)


def _sparse(mx, ctx, rehearsal, card, cfg, gpu, out, t_phase):
    path = os.path.join(out, "train.libsvm")
    with open(os.path.join(out, "write_s")) as f:
        write_s = float(f.read())
    if gpu:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train = mx.io.LibSVMIter(data_libsvm=path, data_shape=(cfg["features"],),
                             batch_size=cfg["batch"], ctx=ctx)
    parse_s = time.perf_counter() - t0
    kv = mx.kv.create("device")
    step = _SpStep(mx, ctx, cfg, kv)
    from mxnet_tpu_torch.kernels import fused_bn as K1
    k0, bwd0 = _kernel_counts(), K1.bwd_launches
    batches, losses, first, host_top = [], [], None, []
    for epoch in range(cfg["epochs"]):
        train.reset()
        for i, b in enumerate(train):
            # the first batch and the last of epoch 1 under cProfile
            o, ms, host, sync = _sp_timed(
                step, b, gpu, host_top if (epoch, i) in (
                    (0, 0), (0, cfg["batches"] - 1)) else None)
            losses.append((epoch, float(o["loss"].asnumpy().sum())
                           / cfg["batch"]))
            batches.append({"epoch": epoch, "ms": ms, "host_ms": host,
                            "sync_ms": sync,
                            "rows": int(o["grad"].indices.shape[0]),
                            "bucket": _sp_bucket(o["grad"].indices.shape[0]),
                            "batch_dense_view_built":
                                o["x"]._dense_cache is not None})
            if first is None:
                first = (b, o, _sp_first_batch_gates(mx, step, b, o, cfg))
            last_ids = o["row_ids"].asnumpy()
    launches = [a - b for a, b in zip(_kernel_counts(), k0)]
    _k1_bwd("sparse", since=bwd0)
    peak = (torch.cuda.max_memory_allocated() - base) if gpu else None
    mean = [float(np.mean([l for e, l in losses if e == k]))
            for k in range(cfg["epochs"])]
    opt_gates = _sp_optimizer_gates(mx, step, first[1]["grad"], cfg)
    pull_gate = _sp_pull_gate(mx, step, last_ids, cfg)
    prof = profile_forward(lambda: step(first[0]), reps=1) if gpu else None
    checks = {
        "a_first_batch": first[2], "b_lazy_optimizers": opt_gates,
        "c_row_sparse_pull": pull_gate,
        "e_loss": {"epoch_mean": mean,
                   "ok": bool(np.isfinite(mean).all()
                              and mean[-1] < mean[0])},
        "f_no_dense_batch": {
            "peak_bytes_above_start": peak,
            "batch_dense_views": sum(b["batch_dense_view_built"]
                                     for b in batches),
            "ok": (peak is None or peak < _SP_DENSE_BATCH_GB * 1e9)
            and not any(b["batch_dense_view_built"] for b in batches)},
        "no_kernel_launches": launches == [0, 0, 0]}
    emit({"sparse": {
        "card": card, "config": cfg, "libsvm_write_s": write_s,
        "libsvm_parse_s": parse_s, "batches": batches,
        "ms_per_batch": [b["ms"] for b in batches],
        "host_sync_share": [b["sync_ms"] / b["host_ms"] for b in batches],
        "profiled_batch": prof, "host_top_first_and_fourth_batch": host_top,
        "launches": launches, "checks": checks}})
    oks = {"a": first[2]["ok"],
           "b": all(v["ok"] for v in opt_gates.values()),
           "c": pull_gate["ok"], "e": checks["e_loss"]["ok"],
           "f": checks["f_no_dense_batch"]["ok"],
           "launches": checks["no_kernel_launches"]}
    failed = sorted(k for k, v in oks.items() if not v)
    assert not failed, (failed, checks)
    del step, kv, train, first
    _free(gpu)
    _sp_two_workers(mx, ctx, cfg, out, rehearsal, card)
    emit({"sparse_phase_s": time.perf_counter() - t_phase, "card": card})
    return launches


# -- SSD-VGG16 detection through the multibox operators -----------------------

# SSD300 (Liu et al., 2016; upstream MXNet example/ssd's VGG16-reduced at
# data_shape 300): the sizes, ratios and steps of its six sources
_SSD_SIZES = ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
              (0.71, 0.79), (0.88, 0.961))
_SSD_RATIOS = ((1, 2, 0.5),) + ((1, 2, 0.5, 3, 1 / 3.),) * 3 \
    + ((1, 2, 0.5),) * 2
_SSD = {False: dict(classes=20, hw=300, batch=32, widths=(64, 128, 256, 512,
                                                          512),
                    fc=1024, extras=((256, 512), (128, 256), (128, 256),
                                     (128, 256)),
                    sizes=_SSD_SIZES, ratios=_SSD_RATIOS,
                    steps=tuple(s / 300. for s in (8, 16, 32, 64, 100, 300)),
                    anchors=8732, max_boxes=50, boxes=(1, 8), steps_n=5,
                    step1_batch=2),
        True: dict(classes=4, hw=64, batch=2, widths=(4, 8, 8, 16, 16),
                   fc=16, extras=((8, 16), (8, 16)), sizes=_SSD_SIZES[:4],
                   ratios=_SSD_RATIOS[:4],
                   steps=tuple(s / 64. for s in (8, 16, 32, 64)),
                   anchors=382, max_boxes=6, boxes=(1, 3), steps_n=2,
                   step1_batch=2)}
_SSD_SEED = 29
_SSD_OPT = (("learning_rate", 0.002), ("momentum", 0.9), ("wd", 0.0005))
_SSD_VARIANCES = (0.1, 0.1, 0.2, 0.2)


def ssd_symbol(mx, cfg):
    """SSD on VGG16-reduced (upstream example/ssd/symbol/vgg16_reduced.py
    and symbol_builder.py, copied in outline): conv1_1-conv5_3 at the
    VGG-16 widths of ``cfg``, pool3 rounding up, ``pool5`` 3x3/s1/p1,
    ``fc6`` a 3x3 convolution dilated 6, ``fc7`` 1x1; extra layers 1x1 ->
    3x3 (stride 2 and padded for the first two, unpadded after); sources
    ``relu4_3`` (L2-normalised per channel times a learned scale),
    ``relu7`` and the extras; per source 3x3 class and location heads and
    ``MultiBoxPrior`` anchors. Training outputs: the class probabilities
    (``SoftmaxOutput`` over ``MultiBoxTarget``'s targets, valid-normalised,
    -1 ignored), the smooth-L1 location loss (``MakeLoss``,
    valid-normalised), the class targets (no gradient) and
    ``MultiBoxDetection``'s rows (NMS 0.45, top 400, no gradient)."""
    sym = mx.sym
    data, label = sym.Variable("data"), sym.Variable("label")
    net, relu4_3 = data, None
    for stage, (n, f) in enumerate(zip(_VGG16_LAYERS, cfg["widths"])):
        for i in range(n):
            name = "%d_%d" % (stage + 1, i + 1)
            net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                                  num_filter=f, name="conv" + name)
            net = sym.Activation(net, act_type="relu", name="relu" + name)
        if stage == 3:
            relu4_3 = net
        if stage < 4:
            net = sym.Pooling(net, pool_type="max", kernel=(2, 2),
                              stride=(2, 2), name="pool%d" % (stage + 1),
                              pooling_convention="full" if stage == 2
                              else "valid")
    net = sym.Pooling(net, pool_type="max", kernel=(3, 3), stride=(1, 1),
                      pad=(1, 1), name="pool5")
    net = sym.Convolution(net, kernel=(3, 3), pad=(6, 6), dilate=(6, 6),
                          num_filter=cfg["fc"], name="fc6")
    net = sym.Activation(net, act_type="relu", name="relu6")
    net = sym.Convolution(net, kernel=(1, 1), num_filter=cfg["fc"],
                          name="fc7")
    net = sym.Activation(net, act_type="relu", name="relu7")
    scale = sym.Variable("relu4_3_scale",
                         shape=(1, cfg["widths"][3], 1, 1))
    sources = [sym.broadcast_mul(sym.L2Normalization(
        relu4_3, mode="channel", name="relu4_3_norm"), scale), net]
    for i, (mid, out) in enumerate(cfg["extras"]):
        net = sym.Convolution(net, kernel=(1, 1), num_filter=mid,
                              name="multi_feat_%d_conv_1x1" % i)
        net = sym.Activation(net, act_type="relu",
                             name="multi_feat_%d_relu_1x1" % i)
        s, p = (2, 1) if i < 2 else (1, 0)
        net = sym.Convolution(net, kernel=(3, 3), stride=(s, s), pad=(p, p),
                              num_filter=out,
                              name="multi_feat_%d_conv_3x3" % i)
        net = sym.Activation(net, act_type="relu",
                             name="multi_feat_%d_relu_3x3" % i)
        sources.append(net)
    k = cfg["classes"] + 1
    cls, loc, anc = [], [], []
    for i, (src, sizes, ratios, step) in enumerate(zip(
            sources, cfg["sizes"], cfg["ratios"], cfg["steps"])):
        na = len(sizes) + len(ratios) - 1
        c = sym.Convolution(src, kernel=(3, 3), pad=(1, 1),
                            num_filter=na * k, name="src%d_cls_pred" % i)
        cls.append(sym.Flatten(sym.transpose(c, axes=(0, 2, 3, 1))))
        b = sym.Convolution(src, kernel=(3, 3), pad=(1, 1),
                            num_filter=na * 4, name="src%d_loc_pred" % i)
        loc.append(sym.Flatten(sym.transpose(b, axes=(0, 2, 3, 1))))
        anc.append(sym.Flatten(sym.contrib.MultiBoxPrior(
            src, sizes=sizes, ratios=ratios, clip=False, steps=(step, step),
            name="src%d_anchors" % i)))
    cls_pred = sym.transpose(sym.Reshape(sym.Concat(*cls, dim=1),
                                         shape=(0, -1, k)),
                             axes=(0, 2, 1), name="multibox_cls_pred")
    loc_pred = sym.Concat(*loc, dim=1, name="multibox_loc_pred")
    anchors = sym.Reshape(sym.Concat(*anc, dim=1), shape=(0, -1, 4),
                          name="multibox_anchors")
    tgt = sym.contrib.MultiBoxTarget(
        anchors, label, cls_pred, overlap_threshold=0.5, ignore_label=-1,
        negative_mining_ratio=3, negative_mining_thresh=0.5,
        minimum_negative_samples=0, variances=_SSD_VARIANCES,
        name="multibox_target")
    loc_target, loc_mask, cls_target = tgt[0], tgt[1], tgt[2]
    cls_prob = sym.SoftmaxOutput(cls_pred, cls_target, ignore_label=-1,
                                 use_ignore=True, multi_output=True,
                                 normalization="valid", name="cls_prob")
    loc_loss = sym.MakeLoss(sym.smooth_l1(loc_mask * (loc_pred - loc_target),
                                          scalar=1.0, name="loc_loss_"),
                            normalization="valid", name="loc_loss")
    det = sym.contrib.MultiBoxDetection(
        cls_prob, loc_pred, anchors, nms_threshold=0.45, force_suppress=False,
        variances=_SSD_VARIANCES, nms_topk=400, name="detection")
    return sym.Group([cls_prob, loc_loss,
                      sym.BlockGrad(cls_target, name="cls_label"),
                      sym.BlockGrad(det, name="det_out")])


def ssd_data(cfg, n, seed):
    """``n`` images and their ``(n, max_boxes, 5)`` labels from a seed:
    ``boxes`` boxes an image over the ``classes`` classes, each painted
    into its image (its class in the channel ``class % 3``), the rest of
    the rows padded with class -1 (train_ssd.py's synthetic batch, at
    VOC's label layout)."""
    rs = np.random.RandomState(seed)
    hw = cfg["hw"]
    x = rs.uniform(0, 0.2, (n, 3, hw, hw)).astype(np.float32)
    y = np.full((n, cfg["max_boxes"], 5), -1, np.float32)
    for i in range(n):
        for b in range(rs.randint(cfg["boxes"][0], cfg["boxes"][1] + 1)):
            c = rs.randint(0, cfg["classes"])
            w, h = rs.uniform(0.1, 0.5, 2)
            x0, y0 = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            y[i, b] = [c, x0, y0, x0 + w, y0 + h]
            r0, r1 = int(y0 * hw), int((y0 + h) * hw)
            c0, c1 = int(x0 * hw), int((x0 + w) * hw)
            x[i, c % 3, r0:r1, c0:c1] += (c + 1.0) / cfg["classes"]
    return x, y


def ssd_init(mx, cfg, xshape, yshape, seed):
    """The SSD's weights as numpy arrays from a seed: normal of standard
    deviation sqrt(1 / fan-in), biases 0, the ``relu4_3`` scale 20."""
    sym = ssd_symbol(mx, cfg)
    shapes, _, _ = sym.infer_shape(data=xshape, label=yshape)
    rs = np.random.RandomState(seed)
    arg = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "label"):
            continue
        if name.endswith("_scale"):
            arg[name] = np.full(shape, 20.0, np.float32)
        elif name.endswith("_bias"):
            arg[name] = np.zeros(shape, np.float32)
        else:
            arg[name] = (rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))) \
                .astype(np.float32)
    return arg


def _ssd_module(mx, sym, ctx, arg, xshape, yshape, dtype="float32"):
    tdt = getattr(torch, dtype)
    mod = mx.mod.Module(sym, data_names=["data"], label_names=["label"],
                        context=ctx)
    mod.bind([mx.io.DataDesc("data", xshape, dtype)],
             [mx.io.DataDesc("label", yshape, dtype)])
    mod.init_params(arg_params={k: torch.from_numpy(v).to(tdt)
                                for k, v in arg.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=_SSD_OPT)
    return mod


def _ssd_batch(mx, x, y, dtype="float32"):
    return mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu(), dtype=dtype)],
                           [mx.nd.array(y, ctx=mx.cpu(), dtype=dtype)])


def _ssd_losses(outs):
    """(the class loss: cross-entropy over the anchors whose target is
    not ignored; the location loss: the smooth-L1 sum over the positive
    anchors' count), from a step's outputs."""
    prob, loc, tgt = (o._data.double() for o in outs[:3])
    keep = tgt >= 0
    p = torch.gather(prob, 1, tgt.clamp_min(0).long()[:, None])[:, 0]
    ce = float(-torch.log(p[keep].clamp_min(1e-30)).mean())
    return ce, float(loc.sum() / max(int((tgt > 0).sum()), 1))


def _ssd_step1(mx, sym, ctx, arg, x, y, dtype):
    """One step from ``arg`` in ``dtype``: (losses, weights after)."""
    mod = _ssd_module(mx, sym, ctx, arg, x.shape, y.shape, dtype)
    mod.forward_backward(_ssd_batch(mx, x, y, dtype))
    losses = _ssd_losses(mod.get_outputs())
    mod.update()
    return losses, _host_params(mod)[0]


class _Recording:
    """Each call of the named registry ops, inputs and outputs, while
    active (the op functions the executor runs)."""

    def __init__(self, names):
        from mxnet_tpu_torch.ops.registry import get_op
        self.ops = {n: get_op(n) for n in names}
        self.calls = {n: [] for n in names}

    def __enter__(self):
        self.fns = {n: op.fn for n, op in self.ops.items()}
        for n, op in self.ops.items():
            def rec(*a, _n=n, _fn=op.fn, **k):
                out = _fn(*a, **k)
                self.calls[_n].append((a, k, out))
                return out
            op.fn = rec
        return self

    def __exit__(self, *exc):
        for n, op in self.ops.items():
            op.fn = self.fns[n]


_MULTIBOX = ("_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
             "_contrib_MultiBoxDetection")


def _multibox_diffs(name, got, want):
    """The gate (b) numbers of one op's outputs against another's: the
    largest difference of each float output and whether each exact
    output (class targets and masks; the detection's class ids) is equal."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    got = [g.detach().cpu().double() for g in got]
    want = [w.detach().cpu().double() for w in want]
    if name == "_contrib_MultiBoxPrior":
        return {"max_abs_err": float((got[0] - want[0]).abs().max()),
                "ok": float((got[0] - want[0]).abs().max()) <= 1e-6}
    if name == "_contrib_MultiBoxTarget":
        err = float((got[0] - want[0]).abs().max())
        eq = bool(torch.equal(got[1], want[1]) and torch.equal(got[2],
                                                                want[2]))
        return {"loc_target_max_abs_err": err, "mask_and_cls_equal": eq,
                "ok": eq and err <= 1e-5}
    g, w = got[0], want[0]
    eq = bool(torch.equal(g[..., 0], w[..., 0]))
    err = float((g[..., 1:] - w[..., 1:]).abs().max())
    return {"class_ids_equal": eq, "score_box_max_abs_err": err,
            "ok": eq and err <= 1e-5}


def _ssd_multibox_gate(mx, rec, gpu):
    """(b) each multibox op on the step's own inputs against the same op
    on CPU copies; its device time (CUDA events) and, for the detection,
    the host time of its NMS resolution; then planted faults (one forced
    match flipped, one NMS suppression dropped) that the gate must
    catch."""
    from mxnet_tpu_torch.ops import contrib as C
    from mxnet_tpu_torch.ops.registry import get_op
    res = {}
    for name in _MULTIBOX:
        calls = rec.calls[name]
        a, k, out = calls[0]
        want = get_op(name).fn(*[t.detach().cpu() for t in a], **k)
        r = _multibox_diffs(name, out, want)
        r["calls_per_step"] = len(calls)
        if gpu:
            C.nms_host_s.update(s=0.0, calls=0)
            r["device_ms"] = time_cuda(lambda: get_op(name).fn(*a, **k),
                                       iters=5, warmup=1)
            r["nms_host_ms"] = C.nms_host_s["s"] * 1e3 / max(
                C.nms_host_s["calls"], 1) if name.endswith("Detection") \
                else None
        res[name] = r
    # the cost of nms_topk=-1 (every row may suppress), one image
    a, k, _ = rec.calls["_contrib_MultiBoxDetection"][0]
    one = [t[:1] for t in a[:2]] + [a[2]]
    C.nms_host_s.update(s=0.0, calls=0)
    t0 = time.perf_counter()
    get_op("_contrib_MultiBoxDetection").fn(*one, **dict(k, nms_topk=-1))
    if gpu:
        torch.cuda.synchronize()
    res["nms_topk_all_one_image"] = {
        "ms": (time.perf_counter() - t0) * 1e3,
        "host_ms": C.nms_host_s["s"] * 1e3}
    # planted: the forced match of image 0's first box flipped to
    # background; one suppressed row of image 0 restored
    a, k, out = rec.calls["_contrib_MultiBoxTarget"][0]
    anchors, label = a[0].reshape(-1, 4), a[1]
    best = int(C.box_iou(anchors, label[0, :1, 1:5])[:, 0].argmax())
    flipped = list(out)
    flipped[2] = out[2].clone()
    flipped[2][0, best] = 0.0
    caught_target = not _multibox_diffs(
        "_contrib_MultiBoxTarget", tuple(flipped), out)["ok"]
    a, k, det = rec.calls["_contrib_MultiBoxDetection"][0]
    # the rows' classes without the NMS (same order: the sort does not
    # depend on it), to put one suppressed row back
    free = get_op("_contrib_MultiBoxDetection").fn(
        *[t.detach().cpu() for t in a], **dict(k, nms_threshold=2.0))
    sup = ((det[0, :, 0].cpu() < 0) & (free[0, :, 0] >= 0)).nonzero()
    planted = det.clone()
    if len(sup):
        planted[0, int(sup[0]), 0] = free[0, int(sup[0]), 0]
    caught_det = bool(len(sup)) and not _multibox_diffs(
        "_contrib_MultiBoxDetection", planted, det)["ok"]
    res["planted_forced_match_flip_caught"] = caught_target
    res["planted_suppression_drop_caught"] = caught_det
    return res


def _ctc_leg(mx, ctx):
    """CTCLoss at examples/warpctc/ctc_seq_train.py's width (batch 32, 20
    frames, 10 digits + blank, labels of 4 padded with 0 in a quarter of
    the rows): the loss and the input gradient on ``ctx``."""
    rs = np.random.RandomState(41)
    logits = rs.randn(32, 20, 11).astype(np.float32)
    label = rs.randint(1, 11, (32, 4)).astype(np.float32)
    label[::4, 3] = 0
    x = mx.nd.array(logits, ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        loss = mx.gluon.loss.CTCLoss()(x, mx.nd.array(label, ctx=ctx))
    loss.backward()
    return {"loss": loss._data.cpu(), "grad": x.grad._data.cpu()}


def _roi_leg(mx, ctx):
    """ROIPooling at examples/rcnn/fast_rcnn.py's width (32 images of
    16 x 24 x 24 features, 8 rois an image, 4 x 4 bins) with its
    gradient, and Proposal at an RPN's (12 anchors on a 38 x 50 map of a
    600 x 800 image, 6000 before and 300 after the NMS)."""
    rs = np.random.RandomState(43)
    feat = rs.randn(32, 16, 24, 24).astype(np.float32)
    rois = []
    for i in range(32):
        for _ in range(8):
            x0, y0 = rs.randint(0, 17, 2)
            rois.append([i, x0, y0, x0 + 7, y0 + 7])
    d = mx.nd.array(feat, ctx=ctx)
    d.attach_grad()
    with mx.autograd.record():
        out = mx.nd.ROIPooling(d, mx.nd.array(np.asarray(rois, np.float32),
                                              ctx=ctx),
                               pooled_size=(4, 4), spatial_scale=1.0)
    out.backward(mx.nd.array(rs.randn(*out.shape).astype(np.float32),
                             ctx=ctx))
    cls = rs.rand(1, 24, 38, 50).astype(np.float32)
    bbox = (rs.randn(1, 48, 38, 50) * 0.1).astype(np.float32)
    info = np.array([[600, 800, 1.0]], np.float32)
    from mxnet_tpu_torch.ops.registry import get_op
    dev = ctx.torch_device()
    rois_p, scores = get_op("_contrib_Proposal").fn(
        torch.from_numpy(cls).to(dev), torch.from_numpy(bbox).to(dev),
        torch.from_numpy(info).to(dev), rpn_pre_nms_top_n=6000,
        rpn_post_nms_top_n=300, threshold=0.7)
    return {"roi": out._data.cpu(), "roi_grad": d.grad._data.cpu(),
            "proposal_rois": rois_p.cpu(), "proposal_scores": scores.cpu()}


def _register_example_softmax(mx):
    """examples/numpy-ops/custom_softmax.py's op (copied), its arrays
    made on the host, registered as ``example_softmax``."""
    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], mx.nd.array(y, ctx=mx.cpu()))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y, ctx=mx.cpu()))

    @mx.operator.register("example_softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()


def _custom_leg(mx, ctx):
    """custom_softmax.py's model (a 10 -> 3 FullyConnected under the
    Custom softmax) through ``Module.fit``, one epoch of 8 batches of 64
    (SGD 0.2, rescale 1/64) from fixed weights: the weights after."""
    _register_example_softmax(mx)
    rs = np.random.RandomState(0)
    centers = rs.uniform(-2, 2, size=(3, 10)).astype(np.float32)
    y = rs.randint(0, 3, 512)
    x = centers[y] + 0.3 * rs.normal(size=(512, 10)).astype(np.float32)
    it = mx.io.NDArrayIter(x.astype(np.float32), y.astype(np.float32),
                           batch_size=64, label_name="softmax_label")
    net = mx.sym.Custom(mx.sym.FullyConnected(mx.sym.Variable("data"),
                                              num_hidden=3, name="fc"),
                        mx.sym.Variable("softmax_label"),
                        op_type="example_softmax", name="softmax")
    mod = mx.mod.Module(net, context=ctx)
    w0 = {"fc_weight": torch.from_numpy(
        (rs.randn(3, 10) * 0.1).astype(np.float32)),
        "fc_bias": torch.zeros(3)}
    mod.fit(it, optimizer="sgd", arg_params=w0,
            optimizer_params={"learning_rate": 0.2,
                              "rescale_grad": 1.0 / 64},
            num_epoch=1, eval_metric="acc")
    return _host_params(mod)[0]


def _spatial_leg(mx, ctx):
    """SpatialTransformer on 8 x 3 x 64 x 64 to 32 x 32 from near-identity
    affine parameters: the output and the gradients of the data and the
    parameters."""
    rs = np.random.RandomState(47)
    x = mx.nd.array(rs.randn(8, 3, 64, 64).astype(np.float32), ctx=ctx)
    theta = np.tile(np.array([0.9, 0.1, 0.05, -0.1, 0.8, -0.05],
                             np.float32), (8, 1))
    loc = mx.nd.array(theta + 0.05 * rs.randn(8, 6).astype(np.float32),
                      ctx=ctx)
    x.attach_grad()
    loc.attach_grad()
    with mx.autograd.record():
        out = mx.nd.SpatialTransformer(x, loc, target_shape=(32, 32))
    out.backward(mx.nd.array(rs.randn(8, 3, 32, 32).astype(np.float32),
                             ctx=ctx))
    return {"out": out._data.cpu(), "data_grad": x.grad._data.cpu(),
            "loc_grad": loc.grad._data.cpu()}


def _small_legs(mx, ctx):
    """(d) each small leg on ``ctx`` against the CPU: the largest gap of
    each tensor over its largest |value| (the proposal's scores, which
    also give its order, equal)."""
    out = {}
    for name, leg in (("ctc", _ctc_leg), ("roi_and_proposal", _roi_leg),
                      ("custom", _custom_leg),
                      ("spatial_transformer", _spatial_leg)):
        got, want = leg(mx, ctx), leg(mx, mx.cpu())
        got = {k: v.detach().double() for k, v in got.items()}
        want = {k: v.detach().double() for k, v in want.items()}
        gaps = {k: float((got[k] - want[k]).abs().max()
                         / max(float(want[k].abs().max()), 1e-30))
                for k in want}
        ok = all(v <= (1e-4 if "grad" in k else 1e-5)
                 for k, v in gaps.items())
        if name == "roi_and_proposal":
            ok = ok and torch.equal(got["proposal_scores"],
                                    want["proposal_scores"])
        out[name] = {"rel_err": gaps, "ok": ok}
    return out


def detection_phase(mx, ctx, rehearsal, card):
    """SSD-VGG16 at 300x300 through ``Module`` (a)-(c), then the small
    legs (d). Returns the K1-K3 launches of the path (0: VGG-16 has no
    BatchNorm and no attention)."""
    gpu = ctx.device_type == "gpu"
    cfg = _SSD[rehearsal]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _free(gpu)
    from mxnet_tpu_torch.kernels import fused_bn as K1
    from mxnet_tpu_torch.kernels import flash_attention as FA
    from mxnet_tpu_torch.ops import contrib as C
    t_phase = time.perf_counter()
    sym = ssd_symbol(mx, cfg)
    x, y = ssd_data(cfg, cfg["batch"], _SSD_SEED)
    arg0 = ssd_init(mx, cfg, x.shape, y.shape, seed=0)
    _, outs, _ = sym.infer_shape(data=x.shape, label=y.shape)
    n_anchors = outs[3][1]
    emit({"detection_model": {
        "card": card, "parameters": sum(v.size for v in arg0.values()),
        "anchors": n_anchors, "batch": cfg["batch"],
        "input": [3, cfg["hw"], cfg["hw"]], "classes": cfg["classes"] + 1,
        "boxes_per_image": list(cfg["boxes"]),
        "label_shape": list(y.shape), "source":
            "Liu et al. 2016 SSD300; upstream example/ssd VGG16-reduced"}})
    assert n_anchors == cfg["anchors"], n_anchors
    batch = _ssd_batch(mx, x, y)
    # -- the main path: counts zeroed just before, read just after --------
    K1.launches = K1.bwd_launches = FA.fwd_launches = FA.bwd_launches = 0
    mod = _ssd_module(mx, sym, ctx, arg0, x.shape, y.shape)
    if gpu:
        torch.cuda.reset_peak_memory_stats()
    losses, ms, wall = [], [], []
    C.nms_host_s.update(s=0.0, calls=0)
    for step in range(cfg["steps_n"]):
        t = time.perf_counter()
        if gpu:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        if step == 0:
            with _Recording(_MULTIBOX) as rec:
                mod.forward_backward(batch)
        else:
            mod.forward_backward(batch)
        mod.update()
        if gpu:
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        wall.append((time.perf_counter() - t) * 1e3)
        losses.append(_ssd_losses(mod.get_outputs()))
    nms_host = dict(C.nms_host_s)
    mod.forward(batch, is_train=False)
    det = mod.get_outputs()[3]._data
    kept = int((det[..., 0] >= 0).sum())
    prof = profile_forward(lambda: (mod.forward_backward(batch),
                                    mod.update()), reps=1) if gpu else None
    peak = torch.cuda.max_memory_allocated() if gpu else None
    counts = _kernel_counts()
    _k1_bwd("detection")
    # ----------------------------------------------------------------------
    gates = {}
    # (c) the detection rows of the whole batch
    gates["c_detection_shape"] = list(det.shape)
    assert tuple(det.shape) == (cfg["batch"], cfg["anchors"], 6), det.shape
    assert all(np.isfinite(v) for l in losses for v in l), losses
    assert bool(torch.isfinite(det).all())
    # (b) the multibox ops on the step's own inputs
    mb = _ssd_multibox_gate(mx, rec, gpu)
    del rec
    _free(gpu)
    # (a) step 1 against the CPU, with the fp64 arbiter
    b1 = cfg["step1_batch"]
    x1, y1 = x[:b1], y[:b1]
    l_card, w_card = _ssd_step1(mx, sym, ctx, arg0, x1, y1, "float32")
    l_cpu, w_cpu = _ssd_step1(mx, sym, mx.cpu(), arg0, x1, y1, "float32")
    _, w_card64 = _ssd_step1(mx, sym, ctx, arg0, x1, y1, "float64")
    _, w_cpu64 = _ssd_step1(mx, sym, mx.cpu(), arg0, x1, y1, "float64")
    w0 = {k: torch.from_numpy(v) for k, v in arg0.items()}
    ok_a, rep_a = _step1_gate(w_card, w_card64, w_cpu, w_cpu64, w0)
    loss_err = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(l_card,
                                                                 l_cpu)]
    gates["a_step1"] = {"batch": b1, "loss_card": l_card, "loss_cpu": l_cpu,
                        "loss_rel_err": loss_err, "ok": ok_a, **rep_a}
    gates["b_multibox"] = mb
    small = _small_legs(mx, ctx)
    gates["d_small_legs"] = small
    emit({"detection": {
        "card": card, "ms_per_step": ms, "host_ms_per_step": wall,
        "losses": losses, "kept_boxes": kept,
        "kept_per_image": kept / cfg["batch"],
        "nms_host_ms_per_step": nms_host["s"] * 1e3 / cfg["steps_n"],
        "profile_step": prof, "peak_bytes": peak,
        "k1_launches": counts[0], "k2_launches": counts[1],
        "k3_launches": counts[2], "gates": gates,
        "seconds": time.perf_counter() - t_phase,
        "note": "no hand-written kernel on this path: cuDNN, cuBLAS and "
                "ATen do its work; the NMS's greedy order is resolved on "
                "the host"}})
    assert counts == (0, 0, 0), counts
    assert ok_a and max(loss_err) <= 1e-4, gates["a_step1"]
    for name in _MULTIBOX:
        assert mb[name]["ok"], (name, mb[name])
    assert mb["planted_forced_match_flip_caught"], mb
    assert mb["planted_suppression_drop_caught"], mb
    for name, r in small.items():
        assert r["ok"], (name, r)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    _free(gpu)
    return counts


# -- records: RecordIO, the native loader and mx.image feeding the models --

_REC = {False: dict(n=160, hw=224, batch=32, classes=1000, det_n=64,
                    jpeg_n=64, jpeg_hw=256, threads=4),
        True: dict(n=8, hw=32, batch=4, classes=10, det_n=4, jpeg_n=4,
                   jpeg_hw=40, threads=2)}
_REC_SEED = 31
# ImageNet's channel statistics, as examples/image-classification passes
# them to ImageRecordIter
_IMAGENET_MEAN = (123.68, 116.779, 103.939)
_IMAGENET_STD = (58.393, 57.12, 57.375)


def _rec_write_raw(mx, path, imgs, labels):
    """Raw uint8 records through the port's ``MXIndexedRecordIO`` and
    ``pack`` (``path`` .rec, its .idx beside it); a label is a float or a
    list (the multi-label header)."""
    w = mx.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i, (img, lab) in enumerate(zip(imgs, labels)):
        w.write_idx(i, mx.recordio.pack(mx.recordio.IRHeader(0, lab, i, 0),
                                        np.ascontiguousarray(img).tobytes()))
    w.close()


def _rec_read_numpy(path):
    """An independent reading of a RecordIO file: ``[(flag, label,
    payload bytes)]`` by ``struct`` over the dmlc framing (magic, length,
    4-byte padding) and the 24-byte ``IfQQ`` header."""
    import struct
    out = []
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                return out
            magic, lrec = struct.unpack("<II", head)
            assert magic == 0xced7230a, hex(magic)
            n = lrec & ((1 << 29) - 1)
            rec = f.read(n)
            f.read((4 - n % 4) % 4)
            flag, label = struct.unpack("<If", rec[:8])
            out.append((flag, label, rec[24:]))


def _ulps(got, want):
    """The largest difference in units of the last place of ``want``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want) / np.spacing(np.abs(want))).max())


def _rec_normalise(x):
    mean = np.array(_IMAGENET_MEAN, np.float32).reshape(3, 1, 1)
    std = np.array(_IMAGENET_STD, np.float32).reshape(3, 1, 1)
    return (x.astype(np.float32) * np.float32(1.0) - mean) / std


def _rec_iter(mx, path, cfg, **kw):
    return mx.io.ImageRecordIter(
        path_imgrec=path, data_shape=(3, cfg["hw"], cfg["hw"]),
        batch_size=cfg["batch"], preprocess_threads=cfg["threads"],
        mean_r=_IMAGENET_MEAN[0], mean_g=_IMAGENET_MEAN[1],
        mean_b=_IMAGENET_MEAN[2], std_r=_IMAGENET_STD[0],
        std_g=_IMAGENET_STD[1], std_b=_IMAGENET_STD[2], **kw)


def _rec_epoch(it):
    """One epoch's (data, label) numpy batches and its images a second."""
    it.reset()
    t = time.perf_counter()
    out = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
    s = time.perf_counter() - t
    return out, sum(len(l) for _, l in out) / s


def _rec_loader_leg(mx, cfg, path, ref, labels):
    """(a) the native loader and the Python path against the numpy
    reading."""
    it = _rec_iter(mx, path, cfg)
    assert it._native is not None, "the native loader is not in use"
    _rec_epoch(it)                              # warm: the first epoch
    native, native_rate = _rec_epoch(it)
    flat = np.concatenate([d for d, _ in native])
    native_ulps = _ulps(flat, ref)
    assert native_ulps <= 1, native_ulps
    assert np.array_equal(np.concatenate([l for _, l in native]), labels)
    np.random.seed(_REC_SEED)
    py = _rec_iter(mx, path, cfg, rand_mirror=True)
    assert py._native is None
    t = time.perf_counter()
    pybatches = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in py]
    py_rate = len(labels) / (time.perf_counter() - t)
    np.random.seed(_REC_SEED)
    flips = np.random.rand(len(labels)) < 0.5
    want = np.where(flips[:, None, None, None], ref[..., ::-1], ref)
    py_ulps = _ulps(np.concatenate([d for d, _ in pybatches]), want)
    assert py_ulps <= 1, py_ulps
    assert np.array_equal(np.concatenate([l for _, l in pybatches]), labels)
    return {"native_img_s": native_rate, "python_img_s": py_rate,
            "native_max_ulps": native_ulps, "python_max_ulps": py_ulps,
            "bit_equal": native_ulps == 0 and py_ulps == 0,
            "mirrored": int(flips.sum()), "batches": len(native)}


def _rec_symbol(mx, net):
    """The zoo net (NHWC inside) on the iterators' NCHW batches: one
    transpose on the device, then ``SoftmaxOutput``."""
    with mx.name.NameManager():
        data = mx.sym.transpose(mx.sym.Variable("data"), axes=(0, 2, 3, 1))
        return mx.sym.SoftmaxOutput(net(data), mx.sym.Variable(
            "softmax_label"), name="softmax")


def _rec_fit(mx, sym, ctx, arg, aux, it, gpu):
    """One epoch of ``Module.fit`` over ``it``: (module, CUDA-event ms
    and host ms of each batch after the first)."""
    mod = mx.mod.Module(sym, context=ctx)
    log = _BatchLog(mod, gpu)
    mod.fit(it, eval_metric="ce", optimizer="sgd",
            optimizer_params={"learning_rate": _BENCH_LR,
                              "momentum": _BENCH_MOMENTUM,
                              "rescale_grad": 1.0 / it.batch_size},
            arg_params=arg, aux_params=aux, num_epoch=1,
            batch_end_callback=log)
    return mod, log.ms_per_batch(10 ** 9)


def _rec_resnet_leg(mx, ctx, cfg, rehearsal, path, ref, labels):
    """(b) ResNet-50 v1 through ``Module.fit`` from the records."""
    from mxnet_tpu_torch.kernels import fused_bn as K1
    gpu = ctx.device_type == "gpu"
    net, _, hw, classes = _resnet_net(mx, ctx, rehearsal, seed=0)
    assert (hw, classes) == (cfg["hw"], cfg["classes"])
    sym = _rec_symbol(mx, net)
    aux_names = set(sym.list_auxiliary_states())
    params = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    arg = {k: v for k, v in params.items() if k not in aux_names}
    aux = {k: v for k, v in params.items() if k in aux_names}
    del net, params
    # batch 0 through the record iterator and through NDArrayIter over the
    # numpy reading: the same forward, bit for bit
    probe = mx.mod.Module(sym, context=ctx)
    probe.bind([("data", (cfg["batch"], 3, hw, hw))],
               [("softmax_label", (cfg["batch"],))], for_training=False)
    probe.init_params(arg_params=arg, aux_params=aux)
    outs = []
    for it in (_rec_iter(mx, path, cfg),
               mx.io.NDArrayIter(ref, labels, batch_size=cfg["batch"])):
        probe.forward(it.next(), is_train=False)
        outs.append(probe.get_outputs()[0]._data.clone())
    forward_equal = bool(torch.equal(outs[0], outs[1]))
    del probe, outs
    _free(gpu)
    if gpu:
        torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts zeroed just before, read just after --------
    K1.launches = K1.bwd_launches = 0
    it = _rec_iter(mx, path, cfg)
    mod, (ms, wall) = _rec_fit(mx, sym, ctx, arg, aux, it, gpu)
    launches, bwd = K1.launches, K1.bwd_launches
    # ---------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated() if gpu else None
    outs = mod.get_outputs()[0]._data
    finite = bool(torch.isfinite(outs).all())
    prob = outs.double().clamp_min(1e-30)
    lab = torch.as_tensor(labels[-cfg["batch"]:], device=prob.device).long()
    ce = float(-torch.log(prob.gather(1, lab[:, None])).mean())
    prof = None
    if gpu:
        it.reset()

        def step():
            b = it.next()
            mod.forward_backward(b)
            mod.update()
        prof = profile_forward(step, reps=2)
    del mod
    _free(gpu)
    nd_mod, (nd_ms, nd_wall) = _rec_fit(
        mx, sym, ctx, arg, aux,
        mx.io.NDArrayIter(ref, labels, batch_size=cfg["batch"]), gpu)
    del nd_mod
    _free(gpu)
    forwards = len(labels) // cfg["batch"]
    return {"k1_launches": launches, "k1_bwd_launches": bwd,
            "forwards": forwards, "k1_per_forward": launches / forwards,
            "loss_last_batch": ce, "finite": finite,
            "forward_bit_equal": forward_equal,
            "ms_per_batch": ms, "host_ms_per_batch": wall,
            "ndarrayiter_ms_per_batch": nd_ms,
            "ndarrayiter_host_ms_per_batch": nd_wall,
            "profile_batch_with_next": prof, "peak_bytes": peak}


def _rec_det_leg(mx, ctx, rehearsal, cfg, tmp):
    """(c) ``ImageDetIter`` over HWC records with multi-label headers into
    the detection phase's SSD: 2 steps."""
    import random
    gpu = ctx.device_type == "gpu"
    scfg = _SSD[rehearsal]
    n, hw, batch = cfg["det_n"], scfg["hw"], scfg["batch"]
    x, y = ssd_data(scfg, n, _REC_SEED)
    imgs = np.clip(x * 200.0, 0, 255).astype(np.uint8).transpose(0, 2, 3, 1)
    rows = [y[i][y[i, :, 0] >= 0] for i in range(n)]
    path = os.path.join(tmp, "det.rec")
    _rec_write_raw(mx, path, imgs, [r.ravel().tolist() for r in rows])
    mean, std = list(_IMAGENET_MEAN), list(_IMAGENET_STD)
    augs = [mx.image.DetHorizontalFlipAug(0.5),
            mx.image.DetBorrowAug(mx.image.ColorNormalizeAug(mean, std))]
    random.seed(_REC_SEED)
    it = mx.image.ImageDetIter(batch_size=batch, data_shape=(3, hw, hw),
                               max_boxes=scfg["max_boxes"], path_imgrec=path,
                               aug_list=augs)
    t = time.perf_counter()
    batches = [b for b in it]
    det_rate = n / (time.perf_counter() - t)
    # the numpy reference under the same draws
    random.seed(_REC_SEED)
    flips = [random.random() < 0.5 for _ in range(n)]
    want_x = np.empty((n, 3, hw, hw), np.float32)
    want_y = np.full((n, scfg["max_boxes"], 5), -1, np.float32)
    for i in range(n):
        img, lab = imgs[i], rows[i].copy()
        if flips[i]:
            img = img[:, ::-1]
            lab[:, 1], lab[:, 3] = 1.0 - lab[:, 3], 1.0 - lab[:, 1]
        want_x[i] = ((img.astype(np.float32) - np.asarray(mean))
                     / np.asarray(std)).astype(np.float32).transpose(2, 0, 1)
        want_y[i, :len(lab)] = lab
    got_x = np.concatenate([b.data[0].asnumpy() for b in batches])
    got_y = np.concatenate([b.label[0].asnumpy() for b in batches])
    data_equal = bool(np.array_equal(got_x, want_x))
    label_equal = bool(np.array_equal(got_y, want_y))
    assert got_y.shape[1:] == (scfg["max_boxes"], 5), got_y.shape
    sym = ssd_symbol(mx, scfg)
    arg0 = ssd_init(mx, scfg, (batch, 3, hw, hw),
                    (batch, scfg["max_boxes"], 5), seed=0)
    mod = _ssd_module(mx, sym, ctx, arg0, (batch, 3, hw, hw),
                      (batch, scfg["max_boxes"], 5))
    losses, ms = [], []
    for b in batches:
        if gpu:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        mod.forward_backward(b)
        mod.update()
        if gpu:
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(_ssd_losses(mod.get_outputs()))
    finite = all(np.isfinite(v) for l in losses for v in l)
    del mod, arg0
    _free(gpu)
    return {"images": n, "batches": len(batches), "flipped": sum(flips),
            "label_shape": list(got_y.shape[1:]), "data_equal": data_equal,
            "labels_equal": label_equal, "losses": losses, "finite": finite,
            "ms_per_step": ms, "detiter_img_s": det_rate}


def _rec_pillow_leg(mx, cfg, tmp):
    """(d) JPEG records through ``ImageRecordIter(rand_crop=True)``
    against a direct PIL decode and a numpy crop under the same draws, or,
    without Pillow, the error that names it."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    emit({"pillow": Image is not None})
    if Image is None:
        try:
            mx.image.imdecode(b"\xff\xd8\xff")
        except mx.MXNetError as e:
            assert "Pillow" in str(e), e
            return {"pillow": False, "raises_naming_pillow": True}
        raise AssertionError("imdecode without Pillow did not raise")
    import io as _pyio
    n, side, hw = cfg["jpeg_n"], cfg["jpeg_hw"], cfg["hw"]
    rs = np.random.RandomState(_REC_SEED)
    yy, xx = np.mgrid[0:side, 0:side]
    blobs = []
    for i in range(n):
        f = rs.uniform(0.5, 4.0, 3)
        arr = np.stack([127.5 + 127.5 * np.sin(f[c] * (xx + c * yy) / side
                                                 * np.pi + i)
                        for c in range(3)], axis=2).astype(np.uint8)
        buf = _pyio.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=90)
        blobs.append(buf.getvalue())
    path = os.path.join(tmp, "jpeg.rec")
    w = mx.recordio.MXRecordIO(path, "w")
    for i, b in enumerate(blobs):
        w.write(mx.recordio.pack(mx.recordio.IRHeader(0, float(i), i, 0), b))
    w.close()
    np.random.seed(_REC_SEED)
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, hw, hw),
                               batch_size=cfg["batch"], rand_crop=True)
    assert it._native is None
    t = time.perf_counter()
    got = np.concatenate([b.data[0].asnumpy() for b in it])
    rate = n / (time.perf_counter() - t)
    np.random.seed(_REC_SEED)
    want = []
    for b in blobs:
        img = np.asarray(Image.open(_pyio.BytesIO(b)).convert("RGB"),
                         np.float32)
        x0 = np.random.randint(0, side - hw + 1)
        y0 = np.random.randint(0, side - hw + 1)
        want.append(img[y0:y0 + hw, x0:x0 + hw].transpose(2, 0, 1))
    equal = bool(np.array_equal(got, np.stack(want)))
    return {"pillow": True, "images": n, "encoded_at": [side, side],
            "crop": [hw, hw], "equal": equal, "jpeg_img_s": rate}


def records_phase(mx, ctx, rehearsal, card):
    """Records written from the seed, read by the native loader and the
    Python path (a), ResNet-50 v1 through ``Module.fit`` from them (b),
    ``ImageDetIter`` into the SSD (c), JPEG records and Pillow (d).
    Returns the K1-K3 launches of (b)'s fit, the phase's main path."""
    import shutil
    gpu = ctx.device_type == "gpu"
    cfg = _REC[rehearsal]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    _free(gpu)
    from mxnet_tpu_torch.kernels import flash_attention as FA
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_records_")
    try:
        n, hw = cfg["n"], cfg["hw"]
        rs = np.random.RandomState(_REC_SEED)
        imgs = rs.randint(0, 256, (n, 3, hw, hw)).astype(np.uint8)
        labels = rs.randint(0, cfg["classes"], n).astype(np.float32)
        path = os.path.join(tmp, "train.rec")
        _rec_write_raw(mx, path, imgs, labels.tolist())
        recs = _rec_read_numpy(path)
        assert [r[1] for r in recs] == labels.tolist()
        ref = _rec_normalise(np.stack([
            np.frombuffer(p, np.uint8).reshape(3, hw, hw)
            for _, _, p in recs]))
        a = _rec_loader_leg(mx, cfg, path, ref, labels)
        a["file_bytes"] = os.path.getsize(path)
        FA.fwd_launches = FA.bwd_launches = 0
        b = _rec_resnet_leg(mx, ctx, cfg, rehearsal, path, ref, labels)
        k23 = (FA.fwd_launches, FA.bwd_launches)
        mx.layout.set_default_layout(None)
        c = _rec_det_leg(mx, ctx, rehearsal, cfg, tmp)
        d = _rec_pillow_leg(mx, cfg, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = tf32
    emit({"records": {
        "card": card, "a_loader": a, "b_resnet50_fit": b,
        "c_detection": c, "d_pillow": d,
        "seconds": time.perf_counter() - t_phase}})
    assert b["finite"] and np.isfinite(b["loss_last_batch"]), b
    assert b["forward_bit_equal"], b
    if gpu:
        assert b["k1_launches"] == b["k1_bwd_launches"] \
            == 16 * b["forwards"], b
    assert c["data_equal"] and c["labels_equal"] and c["finite"], c
    assert c["label_shape"] == [_SSD[rehearsal]["max_boxes"], 5], c
    assert not d["pillow"] or d["equal"], d
    _K1_BWD["records"] += b["k1_bwd_launches"]
    _free(gpu)
    return (b["k1_launches"],) + k23


# -- conv_recurrent: the ConvLSTM encoder-forecaster of Shi et al. 2015 ----

# Shi et al., "Convolutional LSTM Network", NIPS 2015, section 4.1 (Moving
# MNIST): 64x64 frames as 16x16 grids of 4x4 patches (16 channels), 10
# frames in and 10 predicted, three ConvLSTM layers of 128, 64 and 64
# hidden channels in the encoder and in the forecaster, 5x5 kernels with
# pad 2, RMSProp (lr 1e-3, decay 0.9). The rehearsal and the CPU tests
# take the small configuration.
_CONVLSTM = {False: dict(frame=64, patch=4, frames_in=10, frames_out=10,
                         hidden=(128, 64, 64), kernel=5, batch=16,
                         sprites=2, sprite=28, steps=20, epochs=2,
                         batches=3),
             True: dict(frame=32, patch=4, frames_in=3, frames_out=3,
                        hidden=(8, 8), kernel=3, batch=2, sprites=1,
                        sprite=10, steps=3, epochs=2, batches=3)}
# Table 1 of the paper: "ConvLSTM(5x5)-5x5-128-5x5-64-5x5-64", with the
# peephole weights that neither package's cells have
_CONVLSTM_PAPER_PARAMS = 7585296
_CONVLSTM_SEED = 18
_CONVLSTM_LR, _CONVLSTM_GAMMA1 = 1e-3, 0.9


def moving_sprites(cfg, n, seed):
    """Moving-MNIST-shaped sequences made from ``seed``: ``sprites``
    random ``sprite``x``sprite`` patterns bounce inside a ``frame`` square
    (the brighter pixel wins where they overlap); each frame is cut into
    ``patch``x``patch`` patches as channels. Returns float32 ``(x, y)``:
    ``(n, frames_in, patch**2, S, S)`` and ``(n, frames_out, ...)``,
    ``S = frame // patch``, values in [0, 1]."""
    rs = np.random.RandomState(seed)
    f, s, p = cfg["frame"], cfg["sprite"], cfg["patch"]
    T = cfg["frames_in"] + cfg["frames_out"]
    k = cfg["sprites"]
    look = rs.rand(n, k, s, s).astype(np.float32) ** 3
    pos = rs.uniform(0, f - s, (n, k, 2))
    vel = rs.uniform(-3.0, 3.0, (n, k, 2))
    frames = np.zeros((n, T, f, f), np.float32)
    for t in range(T):
        for i in range(n):
            for j in range(k):
                y, x = (int(round(v)) for v in pos[i, j])
                win = frames[i, t, y:y + s, x:x + s]
                np.maximum(win, look[i, j], out=win)
        pos += vel
        for lim in (pos < 0, pos > f - s):      # bounce off the walls
            vel[lim] = -vel[lim]
        pos = np.clip(pos, 0, f - s)
    g = f // p
    patches = frames.reshape(n, T, g, p, g, p).transpose(
        0, 1, 3, 5, 2, 4).reshape(n, T, p * p, g, g)
    return (np.ascontiguousarray(patches[:, :cfg["frames_in"]]),
            np.ascontiguousarray(patches[:, cfg["frames_in"]:]))


def convlstm_init(cfg, names_shapes, seed):
    """Seeded weights for either model: uniform in +-1/sqrt(fan_in) for
    each weight, zero biases (names and shapes in ``names_shapes``)."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(names_shapes.items()):
        if name.endswith("bias"):
            out[name] = np.zeros(shape, np.float32)
        else:
            bound = 1.0 / np.sqrt(float(np.prod(shape[1:])))
            out[name] = rs.uniform(-bound, bound, shape).astype(np.float32)
    return out


def convlstm_ef(mx, cfg):
    """The encoder-forecaster of ``gluon.contrib.rnn.Conv2DLSTMCell``s, a
    HybridBlock called as ``net(x, *states)``: ``x`` the input frames
    ``(N, frames_in, C, S, S)``, ``states`` the encoder's zero begin states
    (h and c of each layer). The forecaster's layers start from the
    encoder's last states and take zeros as input (the paper's forecaster
    takes none); a 1x1 convolution over the forecaster's concatenated
    hidden states gives each predicted frame's logits, stacked as
    ``(N, frames_out, C, S, S)``. Parameter names are the symbolic model's
    (``enc0_i2h_weight``, ..., ``pred_weight``)."""
    gluon = mx.gluon
    crnn = gluon.contrib.rnn
    c, s, k = cfg["patch"] ** 2, cfg["frame"] // cfg["patch"], cfg["kernel"]
    nl = len(cfg["hidden"])

    class EncoderForecaster(gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="")
            with self.name_scope():
                for tag in ("enc", "fore"):
                    cin = c
                    for i, h in enumerate(cfg["hidden"]):
                        setattr(self, "%s%d" % (tag, i), crnn.Conv2DLSTMCell(
                            input_shape=(cin, s, s), hidden_channels=h,
                            i2h_kernel=k, h2h_kernel=k, i2h_pad=k // 2,
                            prefix="%s%d_" % (tag, i)))
                        cin = h
                self.pred = gluon.nn.Conv2D(
                    c, kernel_size=1, in_channels=sum(cfg["hidden"]),
                    prefix="pred_")

        def hybrid_forward(self, F, x, *states):
            xs = F.SliceChannel(x, num_outputs=cfg["frames_in"], axis=1,
                                squeeze_axis=True)
            st = [list(states[2 * i:2 * i + 2]) for i in range(nl)]
            for t in range(cfg["frames_in"]):
                inp = xs[t]
                for i in range(nl):
                    inp, st[i] = getattr(self, "enc%d" % i)(inp, st[i])
            zero = F.zeros_like(xs[0])
            outs = []
            for t in range(cfg["frames_out"]):
                inp, hs = zero, []
                for i in range(nl):
                    inp, st[i] = getattr(self, "fore%d" % i)(inp, st[i])
                    hs.append(inp)
                outs.append(F.expand_dims(self.pred(F.Concat(*hs, dim=1)),
                                          axis=1))
            return F.Concat(*outs, dim=1)

    return EncoderForecaster()


def convlstm_ef_states(mx, cfg, ctx):
    """The encoder's zero begin states, h and c of each layer."""
    s = cfg["frame"] // cfg["patch"]
    return [mx.nd.zeros((cfg["batch"], h, s, s), ctx=ctx)
            for h in cfg["hidden"] for _ in range(2)]


def convlstm_ef_symbol(mx, cfg):
    """The same network of ``mx.rnn.ConvLSTMCell``s as one unrolled symbol
    for ``Module``: inputs ``data`` and ``label``, output the mean sigmoid
    cross-entropy (``MakeLoss``, the formula of Gluon's
    ``SigmoidBinaryCrossEntropyLoss`` on logits)."""
    sym = mx.sym
    c, s, k = cfg["patch"] ** 2, cfg["frame"] // cfg["patch"], cfg["kernel"]
    b = cfg["batch"]
    cells = {}
    for tag in ("enc", "fore"):
        cin = c
        for i, h in enumerate(cfg["hidden"]):
            cells[tag, i] = mx.rnn.ConvLSTMCell(
                input_shape=(b, cin, s, s), num_hidden=h, h2h_kernel=(k, k),
                i2h_kernel=(k, k), i2h_pad=(k // 2, k // 2),
                prefix="%s%d_" % (tag, i))
            cin = h
    nl = len(cfg["hidden"])
    xs = sym.SliceChannel(sym.Variable("data"), num_outputs=cfg["frames_in"],
                          axis=1, squeeze_axis=True)
    st = [[sym.zeros(shape=(b, h, s, s)) for _ in range(2)]
          for h in cfg["hidden"]]
    for t in range(cfg["frames_in"]):
        inp = xs[t]
        for i in range(nl):
            inp, st[i] = cells["enc", i](inp, st[i])
    pw, pb = sym.Variable("pred_weight"), sym.Variable("pred_bias")
    outs = []
    for t in range(cfg["frames_out"]):
        inp, hs = sym.zeros(shape=(b, c, s, s)), []
        for i in range(nl):
            inp, st[i] = cells["fore", i](inp, st[i])
            hs.append(inp)
        logit = sym.Convolution(sym.Concat(*hs, dim=1), weight=pw, bias=pb,
                                num_filter=c, kernel=(1, 1),
                                name="pred_t%d" % t)
        outs.append(sym.expand_dims(logit, axis=1))
    logits = sym.Concat(*outs, dim=1)
    label = sym.Variable("label")
    neg = sym.relu(-logits)
    bce = logits - logits * label + neg + sym.log(sym.exp(-neg)
                                                 + sym.exp(-logits - neg))
    return sym.MakeLoss(sym.mean(bce), name="bce")


def _ef_gluon_net(mx, cfg, ctx, init):
    net = convlstm_ef(mx, cfg)
    net.initialize(ctx=ctx)
    _ef_load(net.collect_params(), init)
    return net


def _ef_load(params, init):
    with torch.no_grad():
        for k, p in params.items():
            p.data()._data.copy_(torch.from_numpy(init[k]))


class _EFGluonStep:
    """One training step of the Gluon encoder-forecaster: ``record`` →
    ``SigmoidBinaryCrossEntropyLoss`` on the logits, mean → ``backward``
    → ``Trainer.step(1)`` (RMSProp)."""

    def __init__(self, mx, net, cfg, ctx):
        self.mx, self.net, self.cfg, self.ctx = mx, net, cfg, ctx
        self.loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
        self.trainer = mx.gluon.Trainer(
            net.collect_params(), "rmsprop",
            {"learning_rate": _CONVLSTM_LR, "gamma1": _CONVLSTM_GAMMA1})
        self.states = convlstm_ef_states(mx, cfg, ctx)

    def __call__(self, x, y):
        mx = self.mx
        X, Y = mx.nd.array(x, ctx=self.ctx), mx.nd.array(y, ctx=self.ctx)
        with mx.autograd.record():
            loss = self.loss_fn(self.net(X, *self.states), Y).mean()
        loss.backward()
        self.trainer.step(1)
        return loss


def _ef_step1(mx, cfg, ctx, init, x, y, hybridize):
    net = _ef_gluon_net(mx, cfg, ctx, init)
    net.hybridize(hybridize)
    loss = float(_EFGluonStep(mx, net, cfg, ctx)(x, y).asscalar())
    return loss, _host_copy(net.collect_params())


def _conv_calls(fn):
    """cuDNN convolutions of one call of ``fn``: ATen's
    ``cudnn_convolution`` (forward) and ``convolution_backward`` events
    of a CPU-side profile."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.key in ("aten::cudnn_convolution",
                         "aten::convolution_backward")}


def _ef_gluon_leg(mx, ctx, rehearsal, cfg, init, n_params, card):
    """(a): step 1 eager and hybridized on the card against each other
    and a CPU recompute, then ``steps`` timed eager steps on fresh
    batches, one profiled step and its cuDNN convolution count."""
    gpu = ctx.device_type == "gpu"
    x, y = moving_sprites(cfg, cfg["batch"], _CONVLSTM_SEED)
    e_loss, e_par = _ef_step1(mx, cfg, ctx, init, x, y, False)
    h_loss, h_par = _ef_step1(mx, cfg, ctx, init, x, y, True)
    t0 = time.perf_counter()
    c_loss, c_par = _ef_step1(mx, cfg, mx.cpu(), init, x, y, False)
    cpu_s = time.perf_counter() - t0
    rec = {"config": dict(cfg), "card": card, "parameters": n_params,
           "paper_table1_parameters": _CONVLSTM_PAPER_PARAMS,
           "precision": "fp32; TF32 off (cudnn and matmul); cudnn's "
                        "default (nondeterministic) algorithms",
           "step1": {"loss": e_loss, "cpu_loss": c_loss,
                     "loss_rel_err_vs_cpu": abs(e_loss - c_loss)
                     / abs(c_loss),
                     "param_scaled_err_vs_cpu": _max_scaled(e_par, c_par),
                     "hybridized_loss": h_loss,
                     "hybridized_vs_eager_loss_abs": abs(h_loss - e_loss),
                     "hybridized_vs_eager_param_scaled":
                         _max_scaled(h_par, e_par),
                     "hybridized_bit_equal": h_loss == e_loss and all(
                         torch.equal(h_par[k], e_par[k]) for k in e_par),
                     "cpu_recompute_s": cpu_s}}
    s1 = rec["step1"]
    assert s1["loss_rel_err_vs_cpu"] <= _RNN_LOSS_TOL, s1
    assert s1["param_scaled_err_vs_cpu"] <= _RNN_PARAM_TOL, s1
    assert s1["hybridized_vs_eager_loss_abs"] <= 1e-6, s1
    assert s1["hybridized_vs_eager_param_scaled"] <= 1e-6, s1
    del e_par, h_par, c_par

    net = _ef_gluon_net(mx, cfg, ctx, init)
    step = _EFGluonStep(mx, net, cfg, ctx)
    data = [moving_sprites(cfg, cfg["batch"], _CONVLSTM_SEED + 1 + i)
            for i in range(cfg["steps"])]
    it = iter(data)
    peaks = []

    def tracked():
        xb, yb = next(it)
        if gpu:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        out = float(step(xb, yb).asscalar())
        if gpu:
            peaks.append(torch.cuda.max_memory_allocated())
        return out

    losses, ms, wall = _timed_steps(tracked, cfg["steps"], gpu)
    assert all(np.isfinite(losses)), losses
    leg = {"steps": cfg["steps"], "losses": losses}
    # i2h and h2h of every layer at every frame, and the 1x1 head per
    # predicted frame
    nf = 2 * len(cfg["hidden"]) * (cfg["frames_in"] + cfg["frames_out"]) \
        + cfg["frames_out"]
    leg["convolutions_per_step"] = nf
    if gpu:
        seqs = cfg["batch"]
        leg.update({"step_ms": ms, "step_ms_mean_2_on": float(np.mean(
            ms[1:])), "step_wall_ms": wall,
            "sequences_per_s": seqs / float(np.mean(ms[1:])) * 1e3,
            "peak_bytes_per_step": peaks})
        xb, yb = data[-1]
        leg["step_profile"] = profile_forward(lambda: step(xb, yb),
                                              reps=1)
        calls = _conv_calls(lambda: step(xb, yb))
        leg["cudnn_calls_per_step"] = calls
        assert calls.get("aten::cudnn_convolution", 0) == nf, (calls, nf)
        assert calls.get("aten::convolution_backward", 0) == nf, (calls, nf)
    rec["steps"] = leg
    return rec, (e_loss, c_loss)


class _EngineFrames:
    """A DataIter whose next batch is made by host work pushed to
    ``mx.engine`` while the current one trains, into ``resource``
    temp space (pooled ``mx.storage``); ``next`` waits for the batch's
    variable, copies it to the card and pushes the one after."""

    def __init__(self, mx, cfg, ctx, engine, batches, seed):
        self.mx, self.cfg, self.ctx, self.engine = mx, cfg, ctx, engine
        self.batches, self.seed = batches, seed
        self.batch_size = cfg["batch"]
        s = cfg["frame"] // cfg["patch"]
        shape = (cfg["batch"], cfg["frames_in"], cfg["patch"] ** 2, s, s)
        self.provide_data = [mx.io.DataDesc("data", shape)]
        self.provide_label = [mx.io.DataDesc("label", shape)]
        self.res = mx.resource.request(mx.cpu(), "temp_space")
        self.buf = self.res.get_space((2,) + shape)
        self.var = engine.new_var()
        self.k = 0
        self.made = []
        self._push(0)

    def _push(self, k):
        if k >= self.batches:
            return

        def make():
            x, y = moving_sprites(self.cfg, self.cfg["batch"], self.seed + k)
            self.buf[0], self.buf[1] = x, y
        self.engine.push(make, mutable_vars=[self.var])

    def reset(self):
        self.engine.wait_for_var(self.var)
        self.k = 0
        self._push(0)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self.k >= self.batches:
            raise StopIteration
        self.engine.wait_for_var(self.var)
        self.made.append(self.buf.copy())
        mx = self.mx
        batch = mx.io.DataBatch([mx.nd.array(self.buf[0], ctx=self.ctx)],
                                [mx.nd.array(self.buf[1], ctx=self.ctx)],
                                pad=0)
        self.k += 1
        self._push(self.k)
        return batch


def _ef_module(mx, cfg, ctx, init):
    mod = mx.mod.Module(convlstm_ef_symbol(mx, cfg), data_names=("data",),
                        label_names=("label",), context=ctx)
    s = cfg["frame"] // cfg["patch"]
    shape = (cfg["batch"], cfg["frames_in"], cfg["patch"] ** 2, s, s)
    mod.bind(data_shapes=[("data", shape)], label_shapes=[("label", shape)])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in init.items()},
                    allow_missing=False)
    return mod


_EF_OPT = {"learning_rate": _CONVLSTM_LR, "gamma1": _CONVLSTM_GAMMA1,
           "rescale_grad": 1.0}


def _ef_module_step1(mx, cfg, ctx, init, x, y):
    mod = _ef_module(mx, cfg, ctx, init)
    mod.init_optimizer(optimizer="rmsprop", optimizer_params=_EF_OPT)
    mod.forward(mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                                [mx.nd.array(y, ctx=ctx)]), is_train=True)
    loss = float(mod.get_outputs()[0].asnumpy())
    mod.backward()
    mod.update()
    arg, _ = mod.get_params()
    return loss, {k: v._data.to("cpu", copy=True) for k, v in arg.items()}


def _ef_symbolic_leg(mx, ctx, rehearsal, cfg, init, n_params, card, tmp,
                     gluon_step1):
    """(b): the same network of ``mx.rnn.ConvLSTMCell``s through
    ``Module.fit`` (RMSProp, ``epochs`` x ``batches``), fed by
    ``_EngineFrames`` and logged by ``LogMetricsCallback``; the summary's
    parameter count; the batches bit-equal under ``NaiveEngine``; step 1
    against a CPU recompute."""
    import io as _io
    gpu = ctx.device_type == "gpu"
    sym = convlstm_ef_symbol(mx, cfg)
    s = cfg["frame"] // cfg["patch"]
    shape = (cfg["batch"], cfg["frames_in"], cfg["patch"] ** 2, s, s)
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        total = mx.viz.print_summary(sym, shape={"data": shape,
                                                 "label": shape})
    text = out.getvalue()
    assert total == n_params, (total, n_params)
    rec = {"card": card, "summary_total_params": total,
           "summary_lines": len(text.splitlines()),
           "summary_tail": text.splitlines()[-2:]}

    # step 1 on the card and the CPU, and against (a)'s step 1
    x, y = moving_sprites(cfg, cfg["batch"], _CONVLSTM_SEED)
    loss, par = _ef_module_step1(mx, cfg, ctx, init, x, y)
    t0 = time.perf_counter()
    c_loss, c_par = _ef_module_step1(mx, cfg, mx.cpu(), init, x, y)
    rec["step1"] = {"loss": loss, "cpu_loss": c_loss,
                    "loss_rel_err_vs_cpu": abs(loss - c_loss) / abs(c_loss),
                    "param_scaled_err_vs_cpu": _max_scaled(par, c_par),
                    "gluon_step1_loss": gluon_step1[0],
                    "loss_abs_vs_gluon": abs(loss - gluon_step1[0]),
                    "cpu_recompute_s": time.perf_counter() - t0}
    s1 = rec["step1"]
    assert s1["loss_rel_err_vs_cpu"] <= _RNN_LOSS_TOL, s1
    assert s1["param_scaled_err_vs_cpu"] <= _RNN_PARAM_TOL, s1
    del par, c_par

    # the batches: a threaded engine against NaiveEngine, bit for bit
    runs = {}
    for naive in (False, True):
        eng = mx.engine.NaiveEngine() if naive else mx.engine.Engine(
            num_workers=2)
        it = _EngineFrames(mx, cfg, ctx, eng, cfg["batches"],
                           _CONVLSTM_SEED + 100)
        for _ in it:
            pass
        runs[naive] = it.made
        it.res.release()
    rec["naive_engine_bit_equal"] = len(runs[False]) == cfg["batches"] \
        and all(np.array_equal(a, b) for a, b in zip(runs[False],
                                                     runs[True]))
    assert rec["naive_engine_bit_equal"], "engine batches differ"

    # Module.fit over the engine-fed batches, the metric log beside it
    st0 = mx.storage.Storage.get().stats()
    it = _EngineFrames(mx, cfg, ctx, mx.engine.get(), cfg["batches"],
                       _CONVLSTM_SEED + 100)
    st1 = mx.storage.Storage.get().stats()
    logdir = os.path.join(tmp, "tb")
    cb = mx.contrib.tensorboard.LogMetricsCallback(logdir, prefix="train")
    mod = _ef_module(mx, cfg, ctx, init)
    times = []

    def timed(param):
        if gpu:
            torch.cuda.synchronize()
        times.append(time.perf_counter())
        cb(param)

    t0 = time.perf_counter()
    mod.fit(it, num_epoch=cfg["epochs"], optimizer="rmsprop",
            optimizer_params=_EF_OPT, eval_metric=mx.metric.Loss(),
            batch_end_callback=timed)
    fit_s = time.perf_counter() - t0
    writer = cb.summary_writer
    if hasattr(writer, "flush"):
        writer.flush()
    events = sorted(os.listdir(logdir))
    arg, _ = mod.get_params()
    finite = all(bool(torch.isfinite(v._data).all()) for v in arg.values())
    rec["fit"] = {"epochs": cfg["epochs"], "batches": cfg["batches"],
                  "steps": len(times), "fit_s": fit_s,
                  "batch_ms": [1e3 * (b - a) for a, b in zip(times,
                                                             times[1:])],
                  "metric_log": events,
                  "metric_writer": type(writer).__name__,
                  "temp_space_pool_bytes": st1["allocated"]
                  - st0["allocated"], "finite": finite}
    it.res.release()
    assert len(times) == cfg["epochs"] * cfg["batches"], times
    assert events and finite, rec["fit"]
    return rec


def _ef_oom_leg(mx, ctx, rehearsal, card):
    """(c) 3: ``InferenceEngine`` on ResNet-50 v1: the bucket-32 forward
    run out of memory under ``set_per_process_memory_fraction`` (the
    rehearsal raises a synthetic ``torch.OutOfMemoryError`` there
    instead) must fail its request with ``DeviceMemoryError``; after the
    cap is lifted a bucket-1 forward is served with 16 K1 launches."""
    from mxnet_tpu_torch.kernels import fused_bn as K
    from mxnet_tpu_torch.serving import InferenceEngine, DeviceMemoryError
    gpu = ctx.device_type == "gpu"
    sym, params, hw, classes, max_batch, reqs, _ = _served_resnet(
        mx, ctx, rehearsal)
    eng = InferenceEngine(sym, params, {"data": (1, hw, hw, 3)},
                          max_batch=max_batch, max_wait_ms=2.0, ctx=ctx)
    rec = {}
    big = np.random.RandomState(3).uniform(
        -1, 1, (max_batch, hw, hw, 3)).astype(np.float32)
    fn = eng._forward._fn
    try:
        if gpu:
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            total = torch.cuda.get_device_properties(0).total_memory
            allowed = torch.cuda.memory_reserved() + (32 << 20)
            torch.cuda.set_per_process_memory_fraction(allowed / total)
            rec["cap_bytes"] = allowed
        else:
            def fake(args, aux):
                if args["data"].shape[0] == max_batch:
                    raise torch.OutOfMemoryError(
                        "CUDA out of memory. Tried to allocate 98.00 MiB "
                        "(rehearsal)")
                return fn(args, aux)
            eng._forward._fn = fake
        err = None
        try:
            eng.submit(data=big).result(timeout=600)
        except DeviceMemoryError as e:
            err = e
    finally:
        if gpu:
            torch.cuda.set_per_process_memory_fraction(1.0)
        eng._forward._fn = fn
    assert err is not None, "no DeviceMemoryError"
    msg = str(err)
    rec.update({"error": type(err).__name__,
                "cause": type(err.__cause__).__name__,
                "names_the_ledger": "live device-buffer ledger" in msg,
                "names_the_card": "program memory card" in msg,
                "message_head": msg.splitlines()[:3]})
    del err
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()
    K.launches = 0
    out = eng.submit(data=reqs[0][:1]).result(timeout=600)
    rec["bucket1_k1_launches"] = K.launches
    rec["bucket1_finite"] = bool(np.isfinite(out[0]).all())
    eng.close()
    assert rec["cause"] == "OutOfMemoryError", rec
    assert rec["names_the_ledger"] and rec["names_the_card"], rec
    assert rec["bucket1_finite"], rec
    assert rec["bucket1_k1_launches"] == (16 if gpu else 0), rec
    mx.layout.set_default_layout(None)
    return rec


def _wgrad_by_algorithm(cfg):
    """The weight gradient of the first layer's i2h convolution on the
    card, with cuDNN's deterministic algorithms and with its default
    ones, each against the CPU's: the largest difference over the CPU
    gradient's largest value."""
    c, s, k, b = cfg["patch"] ** 2, cfg["frame"] // cfg["patch"], \
        cfg["kernel"], cfg["batch"]
    o = 4 * cfg["hidden"][0]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, c, s, s, generator=g) * 0.1
    go = torch.randn(b, o, s, s, generator=g)
    wshape = (o, c, k, k)
    cpu = torch.nn.grad.conv2d_weight(x, wshape, go, padding=k // 2)
    out = {"shape": [list(x.shape), list(wshape)]}
    det = torch.backends.cudnn.deterministic
    try:
        for mode in (True, False):
            torch.backends.cudnn.deterministic = mode
            card = torch.nn.grad.conv2d_weight(x.cuda(), wshape, go.cuda(),
                                               padding=k // 2).cpu()
            out["deterministic" if mode else "default"] = float(
                (card - cpu).abs().max() / cpu.abs().max())
    finally:
        torch.backends.cudnn.deterministic = det
    return out


def _ef_runtime_leg(mx, ctx, rehearsal, cfg, card, tmp):
    """(c): ``check_consistency`` of one ``ConvLSTMCell`` step's symbol
    over the card and the CPU, ``Storage.device_stats`` against
    ``torch.cuda.memory_stats``, the OOM leg, and
    ``MXNET_PROFILER_AUTOSTART=1`` in a child process."""
    gpu = ctx.device_type == "gpu"
    rec = {"card": card}
    c, s, h = cfg["patch"] ** 2, cfg["frame"] // cfg["patch"], \
        cfg["hidden"][0]
    k = cfg["kernel"]
    cell = mx.rnn.ConvLSTMCell(input_shape=(cfg["batch"], c, s, s),
                               num_hidden=h, h2h_kernel=(k, k),
                               i2h_kernel=(k, k), i2h_pad=(k // 2, k // 2),
                               prefix="cc_")
    o, (hh, cc) = cell(mx.sym.Variable("data"),
                       [mx.sym.Variable("h0"), mx.sym.Variable("c0")])
    one = mx.sym.Group([o, cc])
    shapes = {"data": (cfg["batch"], c, s, s), "h0": (cfg["batch"], h, s, s),
              "c0": (cfg["batch"], h, s, s)}
    ctxs = [ctx, mx.cpu()] if gpu else [mx.cpu(0), mx.cpu(1)]
    t0 = time.perf_counter()
    res = mx.test_utils.check_consistency(
        one, [dict(shapes, ctx=c_) for c_ in ctxs], scale=0.1)
    (o0, g0), (o1, g1) = res
    rec["check_consistency"] = {
        "contexts": [str(c_) for c_ in ctxs], "rtol": 1e-3, "atol": 1e-4,
        "outputs_max_abs_err": max(float(np.abs(a - b).max())
                                   for a, b in zip(o0, o1)),
        "grads_max_abs_err": max(float(np.abs(g0[n] - g1[n]).max())
                                 for n in g0),
        "s": time.perf_counter() - t0}

    if gpu:
        rec["cudnn_wgrad"] = _wgrad_by_algorithm(cfg)

    st = mx.storage.Storage.device_stats(ctx)
    if gpu:
        torch.cuda.synchronize()
        raw = torch.cuda.memory_stats(0)
        keys = ("allocated_bytes.all.current", "reserved_bytes.all.current",
                "num_alloc_retries", "num_ooms")
        rec["device_stats"] = {kk: [st[kk], raw[kk]] for kk in keys}
        rec["device_stats"]["bytes_limit"] = st["bytes_limit"]
        assert all(a == b for a, b in
                   (rec["device_stats"][kk] for kk in keys)), rec
        assert st["bytes_in_use"] == st["allocated_bytes.all.current"]
        assert st["bytes_limit"] == torch.cuda.get_device_properties(
            0).total_memory
    else:
        assert st == {}, st
    rec["ledger_report_keys"] = sorted(mx.storage.Storage.ledger_report())

    rec["oom"] = _ef_oom_leg(mx, ctx, rehearsal, card)

    code = ("import mxnet_tpu_torch as mt, torch; "
            "print(mt.profiler._state['running']); "
            "ctx = mt.gpu(0) if torch.cuda.is_available() else mt.cpu(); "
            "a = mt.nd.ones((256, 256), ctx=ctx); "
            "print(float(mt.nd.dot(a, a).sum().asscalar()))")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MXNET_PROFILER_AUTOSTART="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    child_dir = os.path.join(tmp, "autostart")
    os.makedirs(child_dir)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=child_dir, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    trace = json.load(open(os.path.join(child_dir, "profile.json")))
    kernels = [e for e in trace["traceEvents"]
               if e.get("cat") == "kernel"]
    rec["profiler_autostart"] = {"running_at_import": lines[-2] == "True",
                                 "result": float(lines[-1]),
                                 "trace_events": len(trace["traceEvents"]),
                                 "device_kernels": len(kernels),
                                 "child_s": time.perf_counter() - t0}
    assert lines[-2] == "True" and float(lines[-1]) == 256.0 ** 3, lines
    if gpu:
        assert kernels, "the autostarted trace holds no device kernel"
    return rec


def conv_recurrent_phase(mx, ctx, rehearsal, card):
    """The ConvLSTM encoder-forecaster of Shi et al. (2015, section 4.1)
    at the paper's widths: (a) Gluon ``Conv2DLSTMCell``s through
    ``autograd.record`` and ``gluon.Trainer``, eager and hybridized; (b)
    ``mx.rnn.ConvLSTMCell``s through ``Module.fit``, fed by host work
    pushed to ``mx.engine`` into ``resource`` temp space; (c) the runtime
    on the card: ``check_consistency``, ``Storage.device_stats``,
    ``DeviceMemoryError`` from serving ResNet-50, the profiler's
    autostart. Returns the K1-K3 launches of the main path (16 K1: (c)'s
    bucket-1 forward)."""
    import shutil
    gpu = ctx.device_type == "gpu"
    cfg = _CONVLSTM[rehearsal]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's deterministic weight-gradient algorithm for the first
    # layer's i2h convolution (16 -> 512 channels, 5x5 on 16x16) is far
    # from the CPU's gradient, the default one is not (leg (c)'s
    # ``cudnn_wgrad`` line measures both): the phase takes cuDNN's
    # default algorithms
    torch.backends.cudnn.deterministic = False
    _free(gpu)
    from mxnet_tpu_torch.kernels import fused_bn as K1
    from mxnet_tpu_torch.kernels import flash_attention as FA
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_conv_recurrent_")
    try:
        probe = convlstm_ef(mx, cfg)
        shapes = {k: p.shape for k, p in probe.collect_params().items()}
        n_params = int(sum(np.prod(v) for v in shapes.values()))
        init = convlstm_init(cfg, shapes, _CONVLSTM_SEED)
        del probe
        # -- the main path: counts zeroed just before, read just after ----
        K1.launches = K1.bwd_launches = FA.fwd_launches = FA.bwd_launches = 0
        a, a1 = _ef_gluon_leg(mx, ctx, rehearsal, cfg, init, n_params, card)
        b = _ef_symbolic_leg(mx, ctx, rehearsal, cfg, init, n_params, card,
                             tmp, a1)
        c = _ef_runtime_leg(mx, ctx, rehearsal, cfg, card, tmp)
        counts = _kernel_counts()
        _k1_bwd("conv_recurrent")
        # -----------------------------------------------------------------
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    emit({"conv_recurrent": {
        "a_gluon": a, "b_module": b, "c_runtime": c,
        "k1_launches": counts[0], "k2_launches": counts[1],
        "k3_launches": counts[2],
        "seconds": time.perf_counter() - t_phase}})
    assert counts == ((16 if gpu else 0), 0, 0), counts
    _free(gpu)
    return counts


# -- c_boundary: the C ABI and runtime-compiled kernels (K4) ----------------

_CB = {False: dict(batch=32, forwards=3), True: dict(batch=4, forwards=3)}
_CB_SEED = 19
# ResNet-50's input statistics (the records phase's, ImageNet's)
_CB_MEAN, _CB_STD = _IMAGENET_MEAN, _IMAGENET_STD

# K4's kernel on the C path: uint8 NHWC images into float32 NHWC, minus the
# channel mean, times 1/std; one thread per 4 elements (a 4-byte load, a
# 16-byte store), the ragged tail element by element. Bound by bytes.
_CB_NORMALISE = r'''
extern "C" __global__ void normalise_nhwc(
    const unsigned char* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ mean, const float* __restrict__ inv_std,
    int n) {
  long i = 4L * (blockIdx.x * (long)blockDim.x + threadIdx.x);
  if (i + 3 < n) {
    uchar4 v = *reinterpret_cast<const uchar4*>(x + i);
    int c = (int)(i % 3);
    int c1 = c == 2 ? 0 : c + 1, c2 = c1 == 2 ? 0 : c1 + 1;
    float4 o;
    o.x = ((float)v.x - mean[c]) * inv_std[c];
    o.y = ((float)v.y - mean[c1]) * inv_std[c1];
    o.z = ((float)v.z - mean[c2]) * inv_std[c2];
    o.w = ((float)v.w - mean[c]) * inv_std[c];
    *reinterpret_cast<float4*>(y + i) = o;
  } else {
    for (long k = i; k < n; ++k) {
      int c = (int)(k % 3);
      y[k] = ((float)x[k] - mean[c]) * inv_std[c];
    }
  }
}
'''
_CB_NORMALISE_SIG = ("const uint8_t *x, float *y, const float *mean, "
                     "const float *inv_std, int n")

_CB_HEAD = r'''
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
typedef unsigned int mx_uint;
typedef void* Handle;
extern const char* MXGetLastError();
extern int MXSetProfilerConfig(int, const char*);
extern int MXSetProfilerState(int);
extern int MXDumpProfile();
#define CHECK(x) do { if ((x) != 0) { \
    printf("FAIL %s: %s\n", #x, MXGetLastError()); exit(1); } } while (0)
static char* slurp(const char* path, long* size) {
    FILE* f = fopen(path, "rb");
    if (!f) { printf("FAIL open %s\n", path); exit(2); }
    fseek(f, 0, SEEK_END); *size = ftell(f); fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc(*size + 1);
    if (fread(buf, 1, *size, f) != (size_t)*size) exit(2);
    buf[*size] = 0; fclose(f);
    return buf;
}
static double now_ms() {
    struct timespec t; clock_gettime(CLOCK_MONOTONIC, &t);
    return t.tv_sec * 1e3 + t.tv_nsec / 1e6;
}
'''

# (b): MXPred* serving. argv: symbol params input.f32 logits.f32 trace.json
# dev_type n h w c forwards
_CB_PREDICT_DRIVER = _CB_HEAD + r'''
extern int MXPredCreate(const char*, const void*, int, int, int, mx_uint,
                        const char**, const mx_uint*, const mx_uint*,
                        Handle*);
extern int MXPredSetInput(Handle, const char*, const float*, mx_uint);
extern int MXPredForward(Handle);
extern int MXPredGetOutputShape(Handle, mx_uint, mx_uint**, mx_uint*);
extern int MXPredGetOutput(Handle, mx_uint, float*, mx_uint);
extern int MXPredFree(Handle);

int main(int argc, char** argv) {
    long js, ps, xs;
    char* json = slurp(argv[1], &js);
    char* params = slurp(argv[2], &ps);
    float* x = (float*)slurp(argv[3], &xs);
    int dev = atoi(argv[6]), forwards = atoi(argv[11]);
    mx_uint shape[4];
    for (int i = 0; i < 4; ++i) shape[i] = (mx_uint)atoi(argv[7 + i]);
    const char* keys[] = {"data"};
    mx_uint indptr[] = {0, 4};
    Handle h;
    CHECK(MXSetProfilerConfig(0, argv[5]));
    CHECK(MXSetProfilerState(1));
    double t0 = now_ms();
    CHECK(MXPredCreate(json, params, (int)ps, dev, 0, 1, keys, indptr,
                       shape, &h));
    printf("CREATE_MS %.3f\n", now_ms() - t0);
    FILE* out = fopen(argv[4], "wb");
    for (int f = 0; f < forwards; ++f) {
        double t = now_ms();
        CHECK(MXPredSetInput(h, "data", x, (mx_uint)(xs / 4)));
        CHECK(MXPredForward(h));
        mx_uint* oshape; mx_uint ondim;
        CHECK(MXPredGetOutputShape(h, 0, &oshape, &ondim));
        mx_uint n = 1;
        for (mx_uint i = 0; i < ondim; ++i) n *= oshape[i];
        float* y = (float*)malloc(n * sizeof(float));
        CHECK(MXPredGetOutput(h, 0, y, n));   /* copies to the host: syncs */
        printf("FORWARD_MS %d %.3f\n", f, now_ms() - t);
        fwrite(y, sizeof(float), n, out);
        free(y);
    }
    fclose(out);
    CHECK(MXSetProfilerState(0));
    CHECK(MXDumpProfile());
    CHECK(MXPredFree(h));
    printf("PREDICT_OK\n");
    return 0;
}
'''

# (c): the general ABI with K4 on the input path. argv: symbol params
# images.u8 logits.f32 normalised.f32 trace.json kernel.cu mode n h w c
# batches; mode "rtc" normalises on the card through MXRtcCuda*, "host" in
# C on the host (the CPU rehearsal: no NVRTC there, and MXNDArrayLoad,
# which names no device, loads onto the default gpu(0) and refuses)
_CB_ABI_DRIVER = _CB_HEAD + r'''
extern int MXNDArrayCreateEx(const mx_uint*, mx_uint, int, int, int, int,
                             Handle*);
extern int MXNDArraySyncCopyFromCPU(Handle, const void*, size_t);
extern int MXNDArraySyncCopyToCPU(Handle, void*, size_t);
extern int MXNDArrayLoad(const char*, mx_uint*, Handle**, mx_uint*,
                         const char***);
extern int MXSymbolCreateFromFile(const char*, Handle*);
extern int MXSymbolListArguments(Handle, mx_uint*, const char***);
extern int MXSymbolListAuxiliaryStates(Handle, mx_uint*, const char***);
extern int MXExecutorBind(Handle, int, int, mx_uint, Handle*, Handle*,
                          mx_uint*, mx_uint, Handle*, Handle*);
extern int MXExecutorForward(Handle, int);
extern int MXExecutorOutputs(Handle, mx_uint*, Handle**);
extern int MXNDArrayGetShape(Handle, mx_uint*, const mx_uint**);
extern int MXRtcCudaModuleCreate(const char*, int, const char**, int,
                                 const char**, Handle*);
extern int MXRtcCudaKernelCreate(Handle, const char*, int, int*, int*, int*,
                                 Handle*);
extern int MXRtcCudaKernelCall(Handle, int, void**, mx_uint, mx_uint,
                               mx_uint, mx_uint, mx_uint, mx_uint, mx_uint);

static const float MEAN[3] = {@MEAN@};
static const float STD[3] = {@STD@};

/* the handle of "prefix:name" in the loaded list, or NULL */
static Handle find(const char* prefix, const char* name, mx_uint n,
                   Handle* arrs, char names[][128]) {
    char want[160];
    snprintf(want, sizeof(want), "%s:%s", prefix, name);
    for (mx_uint i = 0; i < n; ++i)
        if (strcmp(names[i], want) == 0) return arrs[i];
    return NULL;
}

int main(int argc, char** argv) {
    int rtc = strcmp(argv[8], "rtc") == 0, dev = rtc ? 2 : 1;
    mx_uint shape[4];
    for (int i = 0; i < 4; ++i) shape[i] = (mx_uint)atoi(argv[9 + i]);
    int batches = atoi(argv[13]);
    int n = (int)(shape[0] * shape[1] * shape[2] * shape[3]);
    CHECK(MXSetProfilerConfig(0, argv[6]));
    CHECK(MXSetProfilerState(1));
    long is, ks;
    unsigned char* images = (unsigned char*)slurp(argv[3], &is);
    if (is != (long)n * batches) { printf("FAIL images\n"); return 2; }
    char* kernel_src = slurp(argv[7], &ks);
    float inv_std[3];
    for (int c = 0; c < 3; ++c) inv_std[c] = 1.0f / STD[c];

    Handle x8, xf, mean, istd;
    mx_uint three = 3;
    CHECK(MXNDArrayCreateEx(shape, 4, dev, 0, 0, 3, &x8));   /* uint8 */
    CHECK(MXNDArrayCreateEx(shape, 4, dev, 0, 0, 0, &xf));   /* float32 */
    CHECK(MXNDArrayCreateEx(&three, 1, dev, 0, 0, 0, &mean));
    CHECK(MXNDArrayCreateEx(&three, 1, dev, 0, 0, 0, &istd));
    CHECK(MXNDArraySyncCopyFromCPU(mean, MEAN, 3));
    CHECK(MXNDArraySyncCopyFromCPU(istd, inv_std, 3));

    Handle mod = NULL, kern = NULL;
    if (rtc) {
        const char* exports[] = {"normalise_nhwc"};
        double t = now_ms();
        CHECK(MXRtcCudaModuleCreate(kernel_src, 0, NULL, 1, exports, &mod));
        printf("NVRTC_MS %.3f\n", now_ms() - t);
        int is_nd[] = {1, 1, 1, 1, 0}, is_const[] = {1, 0, 1, 1, 0};
        int types[] = {3, 0, 0, 0, 4};   /* uint8, float32 x3, int32 */
        CHECK(MXRtcCudaKernelCreate(mod, "normalise_nhwc", 5, is_nd,
                                    is_const, types, &kern));
    }

    Handle sym;
    CHECK(MXSymbolCreateFromFile(argv[1], &sym));
    mx_uint n_args, n_aux, n_loaded, n_names;
    const char** tmp;
    static char arg_names[1024][128], aux_names[1024][128],
        loaded_names[2048][128];
    CHECK(MXSymbolListArguments(sym, &n_args, &tmp));
    for (mx_uint i = 0; i < n_args; ++i)
        snprintf(arg_names[i], 128, "%s", tmp[i]);
    CHECK(MXSymbolListAuxiliaryStates(sym, &n_aux, &tmp));
    for (mx_uint i = 0; i < n_aux; ++i)
        snprintf(aux_names[i], 128, "%s", tmp[i]);
    Handle* loaded;
    if (MXNDArrayLoad(argv[2], &n_loaded, &loaded, &n_names, &tmp) != 0) {
        /* the ABI carries no device here: the default context, gpu(0),
           holds, and a box without a card refuses */
        printf("LOAD_REFUSED %s\n", MXGetLastError());
        CHECK(MXSetProfilerState(0));
        return rtc ? 1 : 0;
    }
    for (mx_uint i = 0; i < n_names; ++i)
        snprintf(loaded_names[i], 128, "%s", tmp[i]);
    Handle* held = (Handle*)malloc(n_loaded * sizeof(Handle));
    memcpy(held, loaded, n_loaded * sizeof(Handle));

    static Handle args[1024], grads[1024], aux[1024];
    static mx_uint reqs[1024];
    for (mx_uint i = 0; i < n_args; ++i) {
        args[i] = strcmp(arg_names[i], "data") == 0 ? xf :
            find("arg", arg_names[i], n_loaded, held, loaded_names);
        if (args[i] == NULL) { printf("FAIL arg %s\n", arg_names[i]);
                               return 1; }
        grads[i] = NULL;
        reqs[i] = 0;
    }
    for (mx_uint i = 0; i < n_aux; ++i) {
        aux[i] = find("aux", aux_names[i], n_loaded, held, loaded_names);
        if (aux[i] == NULL) { printf("FAIL aux %s\n", aux_names[i]);
                              return 1; }
    }
    Handle ex;
    CHECK(MXExecutorBind(sym, dev, 0, n_args, args, grads, reqs, n_aux, aux,
                         &ex));

    /* ready: the parent says when (b)'s child is done, so the timed
       batches run alone on the card */
    char go[16];
    if (fgets(go, sizeof(go), stdin) == NULL) {
        printf("FAIL no go from the parent\n");
        return 1;
    }
    float* host = (float*)malloc((size_t)n * sizeof(float));
    FILE* fnorm = fopen(argv[5], "wb");
    FILE* flog = fopen(argv[4], "wb");
    for (int b = 0; b < batches; ++b) {
        double t = now_ms();
        const unsigned char* src = images + (size_t)b * n;
        if (rtc) {
            CHECK(MXNDArraySyncCopyFromCPU(x8, src, (size_t)n));
            void* kargs[5] = {x8, xf, mean, istd, &n};
            mx_uint threads = (mx_uint)((n + 3) / 4);
            CHECK(MXRtcCudaKernelCall(kern, 0, kargs,
                                      (threads + 255) / 256, 1, 1,
                                      256, 1, 1, 0));
        } else {
            for (int k = 0; k < n; ++k)
                host[k] = ((float)src[k] - MEAN[k % 3]) * inv_std[k % 3];
            CHECK(MXNDArraySyncCopyFromCPU(xf, host, (size_t)n));
        }
        CHECK(MXExecutorForward(ex, 0));
        mx_uint n_out;
        Handle* outs;
        CHECK(MXExecutorOutputs(ex, &n_out, &outs));
        mx_uint ndim;
        const mx_uint* oshape;
        CHECK(MXNDArrayGetShape(outs[0], &ndim, &oshape));
        size_t m = 1;
        for (mx_uint i = 0; i < ndim; ++i) m *= oshape[i];
        float* logits = (float*)malloc(m * sizeof(float));
        CHECK(MXNDArraySyncCopyToCPU(outs[0], logits, m));
        printf("BATCH_MS %d %.3f\n", b, now_ms() - t);
        fwrite(logits, sizeof(float), m, flog);
        free(logits);
        CHECK(MXNDArraySyncCopyToCPU(xf, host, (size_t)n));
        fwrite(host, sizeof(float), (size_t)n, fnorm);
    }
    fclose(fnorm);
    fclose(flog);
    CHECK(MXSetProfilerState(0));
    CHECK(MXDumpProfile());
    printf("ABI_OK\n");
    return 0;
}
'''


def _cb_trace(path):
    """A child's trace: ({device kernel name: launches}, the wrappers'
    launch counts the child's profiler recorded, ``otherData.
    mxnet_kernel_launches``)."""
    with open(path) as f:
        trace = json.load(f)
    return (collections.Counter(e["name"] for e in trace["traceEvents"]
                                if e.get("cat") == "kernel"),
            trace["otherData"]["mxnet_kernel_launches"])


def _cb_count(kernels, fragment):
    return sum(n for k, n in kernels.items() if fragment in k)


def _cb_build(tmp):
    """(a): the C library from ``kernels/csrc`` and both drivers, linked
    with ``_build.driver_link_flags()``."""
    import shutil
    from mxnet_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    # the build phase built it beside the CUDA kernels (the rehearsal has
    # no build phase)
    log = _build.BUILD_LOG.get("mxnet") or _build.build_all(
        ("mxnet",), force=True)["mxnet"]
    t_lib, t0 = log["seconds"], time.perf_counter()
    cc = shutil.which("cc") or shutil.which("gcc") or _build.cxx_path()
    abi_src = _CB_ABI_DRIVER.replace(
        "@MEAN@", ", ".join("%.9gf" % m for m in _CB_MEAN)).replace(
        "@STD@", ", ".join("%.9gf" % s for s in _CB_STD))
    exes, procs = {}, {}
    for name, src in (("predict", _CB_PREDICT_DRIVER), ("abi", abi_src)):
        path = os.path.join(tmp, name + ".c")
        with open(path, "w") as f:
            f.write(src)
        exes[name] = os.path.join(tmp, name)
        procs[name] = subprocess.Popen(
            [cc, "-O2", path, "-o", exes[name]] + _build.driver_link_flags(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out, _ = p.communicate()
        assert p.returncode == 0, (name, out)
    rec = {"library_s": t_lib, "library": _build.lib_path("mxnet"),
           "drivers_s": time.perf_counter() - t0,
           "libpython": _build.libpython_kind(),
           "link_flags": _build.driver_link_flags()}
    emit({"c_boundary_build": rec})
    return exes, rec


def _cb_env():
    """A driver's environment: the repo and this interpreter's
    site-packages on ``PYTHONPATH`` (an embedded interpreter does not see
    a virtual environment), TF32 off through the ABI's knob."""
    import site
    root = os.path.dirname(os.path.abspath(__file__))
    path = [root] + site.getsitepackages()
    if os.environ.get("PYTHONPATH"):
        path.append(os.environ["PYTHONPATH"])
    return dict(os.environ, PYTHONPATH=os.pathsep.join(path),
                MXNET_CUDA_ALLOW_TENSOR_CORE="0")


def _cb_start(exe, args):
    """A driver started as a child process: (Popen, its start time)."""
    return (subprocess.Popen([exe] + [str(a) for a in args],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             env=_cb_env()), time.perf_counter())


def _cb_wait(started, go=False, timeout=600):
    """Its output lines and wall seconds once it ends (``go`` first tells
    a driver that waits on its stdin to go on); killed on any failure."""
    proc, t0 = started
    try:
        out, err = proc.communicate(input="go\n" if go else None,
                                    timeout=timeout)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    assert proc.returncode == 0, (proc.args[0], out[-3000:], err[-3000:])
    return out.splitlines(), time.perf_counter() - t0


def _cb_ms(lines, tag):
    return [float(l.split()[-1]) for l in lines if l.startswith(tag)]


def _cb_scaled(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cb_predictor(mx, files, shape, ctx):
    """The port's Python ``Predictor`` on the files the C drivers read:
    a function of one batch to its logits."""
    with open(files["json"]) as f:
        pred = mx.predictor.Predictor(f.read(), files["params"],
                                      {"data": shape}, ctx=ctx)

    def forward(x):
        pred.forward(data=x)
        return pred.get_output(0).asnumpy()
    return forward


def _cb_serving_leg(mx, exes, files, cfg, ctx, rehearsal, tmp):
    """(b): MXPred* serving from a C program at dev_type 2."""
    gpu = ctx.device_type == "gpu"
    hw, n = files["hw"], cfg["batch"]
    shape = (n, hw, hw, 3)
    x = np.random.RandomState(_CB_SEED).uniform(-1, 1, shape).astype(
        np.float32)
    xin, yout = os.path.join(tmp, "x.f32"), os.path.join(tmp, "pred.f32")
    trace = os.path.join(tmp, "predict_trace.json")
    x.tofile(xin)
    lines, wall = _cb_wait(_cb_start(exes["predict"], [
        files["json"], files["params"], xin, yout, trace, 2 if gpu else 1]
        + list(shape) + [cfg["forwards"]]))
    got = np.fromfile(yout, np.float32).reshape(cfg["forwards"], n, -1)
    assert np.isfinite(got).all() and got.shape[2] == files["classes"]
    assert all(np.array_equal(got[0], g) for g in got[1:]), \
        "the C forwards disagree with each other"
    kernels, wrappers = _cb_trace(trace)
    k1 = _cb_count(kernels, "scale_bias_add_relu")
    card = _cb_predictor(mx, files, shape, ctx)(x)
    err_card = _cb_scaled(got[0], card)
    rows = min(n, 4)
    cpu = _cb_predictor(mx, files, (rows,) + shape[1:], mx.cpu())(x[:rows])
    err_cpu = _cb_scaled(got[0][:rows], cpu)
    rec = {"batch": n, "forwards": cfg["forwards"],
           "create_ms": _cb_ms(lines, "CREATE_MS")[0],
           "forward_ms_host": _cb_ms(lines, "FORWARD_MS"),
           "child_s": wall, "trace_device_kernels": sum(kernels.values()),
           "k1_launches": k1, "k1_expected": 16 * cfg["forwards"]
           if gpu else 0, "child_wrapper_counts": wrappers,
           "vs_python_predictor_on_card": err_card, "tol_card": 1e-5,
           "cpu_rows": rows, "vs_cpu_forward": err_cpu, "tol_cpu": 1e-3,
           "tf32": False}
    emit({"c_boundary_serving": rec})
    assert err_card <= 1e-5, rec
    assert err_cpu <= 1e-3, rec
    assert k1 == rec["k1_expected"], rec
    assert wrappers["scale_bias_add_relu"] == k1, rec
    # the trace carries the backward's count too: none in a forward
    assert wrappers["scale_bias_add_relu_backward"] == 0, wrappers
    assert wrappers["rtc"] == 0, rec
    return rec


def _cb_abi_start(exes, files, cfg, ctx, tmp):
    """(c)'s child, started ahead: it loads, compiles and binds while (b)
    runs, then waits on its stdin before its timed batches."""
    gpu = ctx.device_type == "gpu"
    hw, n, batches = files["hw"], cfg["batch"], cfg["forwards"]
    shape = (n, hw, hw, 3)
    imgs = np.random.RandomState(_CB_SEED + 1).randint(
        0, 256, (batches,) + shape).astype(np.uint8)
    paths = {k: os.path.join(tmp, k) for k in
             ("images.u8", "abi_logits.f32", "normalised.f32",
              "abi_trace.json", "normalise.cu")}
    imgs.tofile(paths["images.u8"])
    with open(paths["normalise.cu"], "w") as f:
        f.write(_CB_NORMALISE)
    started = _cb_start(exes["abi"], [
        files["json"], files["params"], paths["images.u8"],
        paths["abi_logits.f32"], paths["normalised.f32"],
        paths["abi_trace.json"], paths["normalise.cu"],
        "rtc" if gpu else "host"] + list(shape) + [batches])
    return started, imgs, paths


def _cb_abi_leg(mx, started, files, cfg, ctx):
    """(c): the general ABI with the runtime-compiled normaliser (K4)
    feeding ``MXExecutorBind``/``MXExecutorForward``."""
    gpu = ctx.device_type == "gpu"
    hw, n, batches = files["hw"], cfg["batch"], cfg["forwards"]
    shape = (n, hw, hw, 3)
    started, imgs, paths = started
    lines, wall = _cb_wait(started, go=True)
    if not gpu:
        refused = [l for l in lines if l.startswith("LOAD_REFUSED")]
        rec = {"mode": "host", "load_refused": refused, "child_s": wall,
               "k1_launches": 0, "k4_launches": 0,
               "normalise_max_abs_err": 0.0}
        emit({"c_boundary_abi": rec})
        assert refused and "no CUDA device" in refused[0], lines
        return rec
    norm = np.fromfile(paths["normalised.f32"], np.float32).reshape(
        (batches,) + shape)
    logits = np.fromfile(paths["abi_logits.f32"], np.float32).reshape(
        batches, n, -1)
    # the plain version, on the card where the kernel ran
    dev = ctx.torch_device()
    mean = torch.tensor(_CB_MEAN, dtype=torch.float32, device=dev)
    inv_std = 1.0 / torch.tensor(_CB_STD, dtype=torch.float32, device=dev)
    plain = [((torch.from_numpy(b).to(dev).float() - mean) * inv_std)
             .cpu().numpy() for b in imgs]
    norm_err = max(float(np.abs(a - b).max()) for a, b in zip(norm, plain))
    norm_ulps = max(_ulps(a, b) for a, b in zip(norm, plain))
    kernels, wrappers = _cb_trace(paths["abi_trace.json"])
    k1 = _cb_count(kernels, "scale_bias_add_relu")
    k4 = _cb_count(kernels, "normalise_nhwc")
    predict = _cb_predictor(mx, files, shape, ctx)
    errs = [_cb_scaled(lg, predict(p)) for lg, p in zip(logits, plain)]
    rec = {"batch": n, "batches": batches, "mode": "rtc" if gpu else "host",
           "nvrtc_ms": (_cb_ms(lines, "NVRTC_MS") or [None])[0],
           "batch_ms_host": _cb_ms(lines, "BATCH_MS"), "child_s": wall,
           "normalise_max_abs_err": norm_err, "normalise_ulps": norm_ulps,
           "normalise_bit_equal": norm_err == 0.0,
           "vs_python_predictor": max(errs), "tol": 1e-5,
           "k1_launches": k1, "k1_expected": 16 * batches if gpu else 0,
           "k4_launches": k4, "k4_expected": batches if gpu else 0,
           "child_wrapper_counts": wrappers,
           "trace_device_kernels": sum(kernels.values())}
    emit({"c_boundary_abi": rec})
    assert np.isfinite(logits).all(), rec
    assert norm_err == 0.0, rec
    assert max(errs) <= 1e-5, rec
    assert (k1, k4) == (rec["k1_expected"], rec["k4_expected"]), rec
    assert wrappers["scale_bias_add_relu_backward"] == 0, wrappers
    assert (wrappers["scale_bias_add_relu"], wrappers["rtc"]) == (k1, k4), \
        rec
    return rec


_CB_RTC_CASES = r'''
extern "C" __global__ void axpy(const float* x, float* y, float alpha,
                                int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] += alpha * x[i];
}

// a C++ (mangled) kernel: each block reverses its segment through
// dynamic shared memory
__global__ void reverse_blocks(const float* x, float* y, int n) {
  extern __shared__ float tile[];
  int base = blockIdx.x * blockDim.x, t = threadIdx.x;
  if (base + t < n) tile[t] = x[base + t];
  __syncthreads();
  int j = blockDim.x - 1 - t;
  if (base + j < n) y[base + j] = tile[t];
}

template <typename T>
__global__ void scale(const T* x, T* y, T a, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * a;
}
'''

_CB_HALF = r'''
#include <cuda_fp16.h>
extern "C" __global__ void hscale(const __half* x, __half* y, __half a,
                                  int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __hmul(x[i], a);
}
'''


def _cb_rtc_leg(mx, ctx, rehearsal):
    """(d): ``mx.rtc`` in this process, each case against its plain
    PyTorch version; then K4's time at (c)'s batch."""
    from mxnet_tpu_torch import rtc
    gpu = ctx.device_type == "gpu"
    rec = {}
    if not gpu:     # the CPU holds only the refusals
        try:
            rtc.CudaKernel(None, "k", "k", rtc.parse_signature(
                "float *y")).launch([mx.nd.zeros((1,), ctx=ctx)], ctx,
                                    (1, 1, 1), (1, 1, 1))
            raise AssertionError("a cpu launch did not raise")
        except mx.MXNetError as e:
            rec["cpu_ctx_refused"] = "mx.gpu" in str(e)
        emit({"c_boundary_rtc": rec})
        assert rec["cpu_ctx_refused"], rec
        return rec, None
    dev = ctx.torch_device()
    g = torch.Generator(device=dev).manual_seed(_CB_SEED)
    n = 1 << 20
    t0 = time.perf_counter()
    mod = rtc.CudaModule(_CB_RTC_CASES,
                         exports=["reverse_blocks", "scale<float>",
                                  "scale<double>"])
    rec["compile_ms"] = (time.perf_counter() - t0) * 1e3
    rec["lowered"] = dict(mod._lowered)
    x = mx.nd.NDArray(torch.randn(n, generator=g, device=dev))
    y0 = torch.randn(n, generator=g, device=dev)

    # extern "C" axpy: y += a*x may contract to one fma, the plain version
    # rounds twice: 1 ulp of |y|'s scale
    y = mx.nd.NDArray(y0.clone())
    mod.get_kernel("axpy", "const float *x, float *y, float alpha, int n"
                   ).launch([x, y, 2.5, n], ctx, ((n + 255) // 256, 1, 1),
                            (256, 1, 1))
    want = y0 + 2.5 * x._data
    rec["axpy_max_abs_err"] = float((y._data - want).abs().max())
    assert rec["axpy_max_abs_err"] <= 1e-6 * float(want.abs().max()), rec

    # mangled export through dynamic shared memory, two splits
    k = mod.get_kernel("reverse_blocks", "const float *x, float *y, int n")
    for bd in (128, 512):
        out = mx.nd.NDArray(torch.empty(n, device=dev))
        k.launch([x, out, n], ctx, (n // bd, 1, 1), (bd, 1, 1),
                 shared_mem=bd * 4)
        want = x._data.view(-1, bd).flip(1).reshape(-1)
        rec["reverse_%d_equal" % bd] = bool(torch.equal(out._data, want))
        assert rec["reverse_%d_equal" % bd], rec

    # templates exported by their name expressions
    for t, tdt, cty in (("float", torch.float32, "float"),
                        ("double", torch.float64, "double")):
        xt = mx.nd.NDArray(x._data.to(tdt))
        out = mx.nd.NDArray(torch.empty(n, device=dev, dtype=tdt))
        mod.get_kernel("scale<%s>" % t, "const %s *x, %s *y, %s a, int n"
                       % (cty, cty, cty)).launch(
            [xt, out, 0.75, n], ctx, ((n + 255) // 256, 1, 1), (256, 1, 1))
        rec["scale_%s_equal" % t] = bool(torch.equal(out._data,
                                                     xt._data * 0.75))
        assert rec["scale_%s_equal" % t], rec

    # __half by its 16 bits: a product of two halves is exact in float,
    # so one rounding on both sides
    hmod = rtc.CudaModule(_CB_HALF)
    xh = mx.nd.NDArray(x._data.half())
    out = mx.nd.NDArray(torch.empty(n, device=dev, dtype=torch.float16))
    hmod.get_kernel("hscale", "const __half *x, __half *y, __half a, int n"
                    ).launch([xh, out, 1.5, n], ctx,
                             ((n + 255) // 256, 1, 1), (256, 1, 1))
    rec["half_equal"] = bool(torch.equal(out._data, xh._data * 1.5))
    assert rec["half_equal"], rec

    # a compile error raises with NVRTC's log
    try:
        rtc.CudaModule('extern "C" __global__ void broken(float* y) '
                       '{ y[0] = undeclared_name; }')
        raise AssertionError("a broken module compiled")
    except mx.MXNetError as e:
        rec["compile_error_has_log"] = "undeclared_name" in str(e)
    assert rec["compile_error_has_log"], rec

    # a dtype mismatch raises before any launch
    before = rtc.launches
    try:
        mod.get_kernel("axpy", "const float *x, float *y, float alpha, "
                       "int n").launch(
            [mx.nd.NDArray(x._data.int()), y, 1.0, n], ctx, (1, 1, 1),
            (1, 1, 1))
        raise AssertionError("a dtype mismatch launched")
    except mx.MXNetError:
        rec["dtype_mismatch_refused"] = rtc.launches == before
    assert rec["dtype_mismatch_refused"], rec

    # K4's time at (c)'s batch: the normaliser against its plain version
    b = _CB[rehearsal]["batch"]
    numel = b * 224 * 224 * 3
    norm = rtc.CudaModule(_CB_NORMALISE).get_kernel("normalise_nhwc",
                                                    _CB_NORMALISE_SIG)
    x8 = mx.nd.NDArray(torch.randint(0, 256, (b, 224, 224, 3),
                                     generator=g, device=dev,
                                     dtype=torch.uint8))
    yf = mx.nd.NDArray(torch.empty((b, 224, 224, 3), device=dev))
    mean = mx.nd.NDArray(torch.tensor(_CB_MEAN, device=dev))
    inv_std = mx.nd.NDArray(1.0 / torch.tensor(_CB_STD, device=dev))
    args = [x8, yf, mean, inv_std, numel]
    grid = (((numel + 3) // 4 + 255) // 256, 1, 1)
    launch = lambda: norm.launch(args, ctx, grid, (256, 1, 1))
    plain = lambda: (x8._data.float() - mean._data) * inv_std._data
    launch()
    err = float((yf._data - plain()).abs().max())
    # the 24 MB it moves fit the 50 MB L2: "warm" repeats the launch, the
    # kernel's ms writes 256 MB between launches (the C path's input
    # arrives by a fresh host copy, its output goes to the executor)
    flush = torch.empty(64 << 20, device=dev)
    ms = time_cuda(launch, iters=100)
    dms = _isolated_ms(launch, before=flush.zero_)
    warm_dms = _isolated_ms(launch)
    plain_ms = _isolated_ms(plain, before=flush.zero_)
    plain_event_ms = time_cuda(plain, iters=100)
    nbytes = numel * (1 + 4)
    rate = next(r for key, r in _MEM_RATE
                if key in torch.cuda.get_device_name(0))
    k4 = {"shape": [b, 224, 224, 3], "max_abs_err": err,
          "event_ms": ms, "ms": dms, "warm_ms": warm_dms,
          "plain_ms": plain_ms, "plain_event_ms": plain_event_ms,
          "bytes": nbytes,
          "bound_ms": nbytes / rate * 1e3, "bound_by": "bytes",
          "roofline_share": nbytes / rate * 1e3 / dms}
    rec["normalise"] = k4
    emit({"c_boundary_rtc": rec})
    assert err == 0.0, k4
    return rec, k4


def c_boundary_phase(mx, ctx, rehearsal, card):
    """A C deployment of ResNet-50 v1 through the port's own C library,
    with a runtime-compiled CUDA C kernel (K4) on its input path:
    (a) the library and two C drivers built; (b) ``MXPred*`` serving at
    ``dev_type`` 2; (c) the general ABI, ``MXRtcCudaModuleCreate``'s
    normaliser feeding ``MXExecutorBind``; (d) ``mx.rtc`` in this
    process. Returns the launches of K1 and K4 on the main path ((b) and
    (c), read from the children's traces) and K4's timing."""
    import shutil
    gpu = ctx.device_type == "gpu"
    cfg = _CB[rehearsal]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _free(gpu)
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.kernels import fused_bn as K1
    from mxnet_tpu_torch.kernels import flash_attention as FA
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_c_boundary_")
    abi = None
    try:
        exes, build = _cb_build(tmp)
        sym, params, hw, classes, _, _, _ = _served_resnet(mx, ctx,
                                                           rehearsal)
        files = {"json": os.path.join(tmp, "resnet-symbol.json"),
                 "params": os.path.join(tmp, "resnet-0000.params"),
                 "hw": hw, "classes": classes}
        sym.save(files["json"])
        mx.nd.save(files["params"], params)
        del params
        # -- the main path: counts zeroed just before, read just after ----
        K1.launches = K1.bwd_launches = FA.fwd_launches = FA.bwd_launches \
            = rtc.launches = 0
        abi = _cb_abi_start(exes, files, cfg, ctx, tmp)
        b = _cb_serving_leg(mx, exes, files, cfg, ctx, rehearsal, tmp)
        c = _cb_abi_leg(mx, abi, files, cfg, ctx)
        counts = _kernel_counts() + (rtc.launches,)
        _k1_bwd("c_boundary")
        # -----------------------------------------------------------------
        d, k4 = _cb_rtc_leg(mx, ctx, rehearsal)
    finally:
        if abi is not None and abi[0][0].poll() is None:
            abi[0][0].kill()
            abi[0][0].wait()
        shutil.rmtree(tmp, ignore_errors=True)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    k1 = b["k1_launches"] + c["k1_launches"]
    emit({"c_boundary": {
        "card": card, "a_build": build, "b_serving": b, "c_abi": c,
        "d_rtc": d, "k1_launches": k1, "k4_launches": c["k4_launches"],
        "parent_counts_during_children": counts,
        "seconds": time.perf_counter() - t_phase}})
    # the C programs ran in children (their wrappers' counts came back in
    # their traces): this process launched only the Python Predictor's K1
    # tails for the gates
    assert counts[1:] == (0, 0, 0), counts
    _free(gpu)
    return (k1, 0, 0, c["k4_launches"]), k4, c


PHASES = ("kernels", "serving", "attention_kernels", "training",
          "resnet_training", "gluon_training", "decode", "rnn_training",
          "image_classification", "gluon_zoo", "observability",
          "dense_prediction", "data_parallel", "model_parallel",
          "engine_meshes", "elastic", "sparse", "detection", "records",
          "conv_recurrent", "c_boundary")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the control flow on the CPU at a small size "
                         "(plain versions only; prints no result line)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %s to run after device "
                         "and build; a subset prints no result line"
                         % ",".join(PHASES))
    ap.add_argument("--dp-worker", nargs=2, metavar=("GROUP", "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--mp-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--em-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--el-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--sp-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--sp-dir", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    rehearsal = args.cpu_rehearsal
    if args.dp_worker:
        dp_worker(args.dp_worker[0], args.dp_worker[1], rehearsal,
                  args.sp_dir)
        return 0
    if args.mp_worker:
        mp_worker(args.mp_worker, rehearsal)
        return 0
    if args.em_worker:
        em_worker(args.em_worker, rehearsal)
        return 0
    if args.el_worker:
        el_worker(args.el_worker, rehearsal)
        return 0
    if args.sp_worker:
        sp_worker(args.sp_worker, rehearsal)
        return 0
    todo = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(todo) - set(PHASES))
    if unknown:
        ap.error("unknown phases %s" % unknown)
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    if rehearsal:
        dev, rate, ctx = torch.device("cpu"), None, mx.cpu()
    else:
        with phase("device"):
            name, count, rate = device_phase()
        with phase("build"):
            build_phase()
        dev, ctx = torch.device("cuda", 0), mx.gpu(0)
    res = {}
    # the data_parallel phase's workers carry the sparse phase's two-worker
    # leg when both run (one launch fewer)
    sp_dir = sp_prepare(rehearsal) if {"data_parallel", "sparse"} <= set(
        todo) else None
    if "kernels" in todo:
        with phase("kernels"):
            res["k1"] = kernel_phase(dev, rate)
    if "serving" in todo:
        with phase("serving"):
            res["k1_launches"] = serving_phase(mx, ctx, rehearsal=rehearsal)
    if "attention_kernels" in todo:
        with phase("attention_kernels"):
            res["attn"] = attention_phase(dev, rate, rehearsal)
    if "training" in todo:
        with phase("training"):
            res["attn_launches"] = training_phase(mx, ctx, rehearsal)
    if "resnet_training" in todo:
        with phase("resnet_training"):
            res["k1_train_launches"], res["k1_bwd"] = \
                resnet_training_phase(mx, ctx, dev, rate, rehearsal)
    if "gluon_training" in todo:
        with phase("gluon_training"):
            res["k1_gluon_launches"] = gluon_training_phase(mx, ctx,
                                                            rehearsal)
    if "decode" in todo:
        with phase("decode"):
            decode_phase(mx, ctx, rehearsal)
    if "rnn_training" in todo:
        with phase("rnn_training"):
            res["rnn_launches"] = rnn_training_phase(mx, ctx, rehearsal)
    if "image_classification" in todo:
        with phase("image_classification"):
            res["ic_launches"] = image_classification_phase(mx, ctx,
                                                            rehearsal)
    if "gluon_zoo" in todo:
        with phase("gluon_zoo"):
            res["zoo_launches"] = gluon_zoo_phase(mx, ctx, rehearsal)
    if "observability" in todo:
        with phase("observability"):
            res["obs_launches"] = observability_phase(
                mx, ctx, rehearsal, "cpu" if rehearsal else _card_line())
    if "dense_prediction" in todo:
        with phase("dense_prediction"):
            res["dense_launches"] = dense_prediction_phase(
                mx, ctx, rehearsal, "cpu" if rehearsal else _card_line())
    if "data_parallel" in todo:
        with phase("data_parallel"):
            res["dp_launches"] = data_parallel_phase(
                mx, ctx, rehearsal, "cpu" if rehearsal else _card_line(),
                sp_dir)
    if "model_parallel" in todo:
        with phase("model_parallel"):
            res["mp_launches"] = model_parallel_phase(
                mx, ctx, rehearsal, "cpu" if rehearsal else _card_line())
    if "engine_meshes" in todo:
        with phase("engine_meshes"):
            res["em_launches"] = engine_meshes_phase(
                mx, ctx, rehearsal, "cpu" if rehearsal else _card_line())
    if "elastic" in todo:
        with phase("elastic"):
            res["el_launches"] = elastic_phase(
                mx, ctx, rehearsal, "cpu" if rehearsal else _card_line())
    if "sparse" in todo:
        with phase("sparse"):
            res["sp_launches"] = sparse_phase(
                mx, ctx, rehearsal, "cpu" if rehearsal else _card_line(),
                sp_dir)
    if "detection" in todo:
        with phase("detection"):
            res["det_launches"] = detection_phase(
                mx, ctx, rehearsal, "cpu" if rehearsal else _card_line())
    if "records" in todo:
        with phase("records"):
            res["rec_launches"] = records_phase(
                mx, ctx, rehearsal, "cpu" if rehearsal else _card_line())
    if "conv_recurrent" in todo:
        with phase("conv_recurrent"):
            res["cr_launches"] = conv_recurrent_phase(
                mx, ctx, rehearsal, "cpu" if rehearsal else _card_line())
    if "c_boundary" in todo:
        with phase("c_boundary"):
            res["cb_launches"], res["k4"], res["cb_abi"] = \
                c_boundary_phase(mx, ctx, rehearsal,
                                 "cpu" if rehearsal else _card_line())
    if rehearsal or todo != list(PHASES):
        print("chip_smoke: %s passed (no device result)"
              % ("CPU rehearsal" if rehearsal else "phases " + ",".join(todo)))
        return 0
    k1, attn, launches = res["k1"], res["attn"], res["attn_launches"]
    bwd = res["k1_bwd"]
    emit({"kernels": [{
        "name": "scale_bias_add_relu", "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/fused_bn.cu",
        "replaces": "mxnet_tpu/pallas/fused_bn.py:44",
        "launches": res["k1_launches"] + res["k1_train_launches"]
        + res["k1_gluon_launches"] + res["obs_launches"]
        + res["dp_launches"][0] + res["mp_launches"][0]
        + res["em_launches"][0] + res["el_launches"][0]
        + res["sp_launches"][0] + res["det_launches"][0]
        + res["rec_launches"][0] + res["cr_launches"][0]
        + res["cb_launches"][0],
        "serving_launches": res["k1_launches"],
        "observability_launches": res["obs_launches"],
        "training_launches": res["k1_train_launches"],
        "gluon_training_launches": res["k1_gluon_launches"],
        "rnn_training_launches": res["rnn_launches"][0],
        "image_classification_launches": res["ic_launches"][0],
        "gluon_zoo_launches": res["zoo_launches"][0],
        "dense_prediction_launches": res["dense_launches"][0],
        "data_parallel_launches": res["dp_launches"][0],
        "model_parallel_launches": res["mp_launches"][0],
        "engine_meshes_launches": res["em_launches"][0],
        "elastic_launches": res["el_launches"][0],
        "sparse_launches": res["sp_launches"][0],
        "detection_launches": res["det_launches"][0],
        "records_launches": res["rec_launches"][0],
        "conv_recurrent_launches": res["cr_launches"][0],
        "c_boundary_launches": res["cb_launches"][0],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "warm_ms": k1["warm_ms"],
        "dirty_flush_ms": k1["dirty_flush_ms"],
        "event_ms": k1["event_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "launch_host_us": k1["launch_host_us_float32"],
        "launch_host_us_bf16": k1["launch_host_us_bfloat16"],
        "backward": "csrc/fused_bn.cu (one pass + a fixed-order finish)",
        "bwd_launches": sum(_K1_BWD.values()),
        "bwd_launches_by_path": dict(_K1_BWD),
        "bwd_ms": bwd["bwd_ms"], "bwd_warm_ms": bwd["bwd_warm_ms"],
        "bwd_dirty_flush_ms": bwd["bwd_dirty_flush_ms"],
        "bwd_event_ms": bwd["bwd_event_ms"],
        "bwd_plain_ms": bwd["bwd_plain_ms"],
        "bwd_autograd_ms": bwd["bwd_autograd_ms"],
        "bwd_bound_ms": bwd["bwd_bound_ms"],
        "bwd_max_scaled_err": bwd["bwd_max_scaled_err"]}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "mxnet_tpu/pallas/flash_attention.py:83",
        "launches": launches["fwd"] + res["dp_launches"][1]
        + res["mp_launches"][1] + res["em_launches"][1]
        + res["el_launches"][1] + res["sp_launches"][1]
        + res["det_launches"][1] + res["rec_launches"][1]
        + res["cr_launches"][1],
        "training_launches": launches["fwd"],
        "rnn_training_launches": res["rnn_launches"][1],
        "image_classification_launches": res["ic_launches"][1],
        "gluon_zoo_launches": res["zoo_launches"][1],
        "dense_prediction_launches": res["dense_launches"][1],
        "data_parallel_launches": res["dp_launches"][1],
        "model_parallel_launches": res["mp_launches"][1],
        "engine_meshes_launches": res["em_launches"][1],
        "elastic_launches": res["el_launches"][1],
        "sparse_launches": res["sp_launches"][1],
        "detection_launches": res["det_launches"][1],
        "records_launches": res["rec_launches"][1],
        "conv_recurrent_launches": res["cr_launches"][1],
        "c_boundary_launches": res["cb_launches"][1],
        "max_abs_err": attn["fwd_max_abs_err"],
        "ms": attn["fwd_device_us"] / 1e3,
        "event_ms": attn["fwd_us"] / 1e3,
        "plain_ms": attn["fwd_plain_us"] / 1e3,
        "bound_ms": attn["fwd_bound_us"] / 1e3,
        "bound_by": attn["fwd_bound_by"],
        "library_ms": attn["fwd_library_device_us"] / 1e3,
        "library_call": "scaled_dot_product_attention forward",
        "shape": attn["shape"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "mxnet_tpu/pallas/flash_attention.py:261",
        "launches": launches["bwd"] + res["dp_launches"][2]
        + res["mp_launches"][2] + res["em_launches"][2]
        + res["el_launches"][2] + res["sp_launches"][2]
        + res["det_launches"][2] + res["rec_launches"][2]
        + res["cr_launches"][2],
        "training_launches": launches["bwd"],
        "rnn_training_launches": res["rnn_launches"][2],
        "image_classification_launches": res["ic_launches"][2],
        "gluon_zoo_launches": res["zoo_launches"][2],
        "dense_prediction_launches": res["dense_launches"][2],
        "data_parallel_launches": res["dp_launches"][2],
        "model_parallel_launches": res["mp_launches"][2],
        "engine_meshes_launches": res["em_launches"][2],
        "elastic_launches": res["el_launches"][2],
        "sparse_launches": res["sp_launches"][2],
        "detection_launches": res["det_launches"][2],
        "records_launches": res["rec_launches"][2],
        "conv_recurrent_launches": res["cr_launches"][2],
        "c_boundary_launches": res["cb_launches"][2],
        "max_abs_err": attn["bwd_max_abs_err"],
        "ms": attn["bwd_device_us"] / 1e3,
        "event_ms": attn["bwd_us"] / 1e3,
        "plain_ms": attn["bwd_plain_us"] / 1e3,
        "bound_ms": attn["bwd_bound_us"] / 1e3,
        "bound_by": attn["bwd_bound_by"],
        "library_ms": attn["bwd_library_device_us"] / 1e3,
        "library_call": "torch.autograd.grad through "
                        "scaled_dot_product_attention",
        "shape": attn["shape"]}, {
        "name": "rtc_normalise_nhwc", "route": "cuda",
        "source": "mxnet_tpu_torch/rtc.py",
        "kernel_source": "chip_smoke.py (_CB_NORMALISE)",
        "replaces": "mxnet_tpu/rtc.py:37",
        "launches": res["cb_launches"][3],
        "c_boundary_launches": res["cb_launches"][3],
        "max_abs_err": max(res["k4"]["max_abs_err"],
                           res["cb_abi"]["normalise_max_abs_err"]),
        "ms": res["k4"]["ms"], "event_ms": res["k4"]["event_ms"],
        "plain_ms": res["k4"]["plain_ms"],
        "bound_ms": res["k4"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "shape": res["k4"]["shape"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
