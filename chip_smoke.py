#!/usr/bin/env python3
"""Smoke run of the torch port (deeplearning4j_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):

1. Header: the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, and the TF32 settings, which the script fixes to OFF so the
   float32 tolerances below mean float32 (and bfloat16 products to reduce
   in float32, so a bfloat16 tolerance means one rounding).
2. Build: every hand-written kernel from the checkout's sources
   (deeplearning4j_torch/ops/csrc), one nvcc per source, all started
   together; one ptxas record per kernel instantiation (registers, spill
   bytes, stack).
3. Kernels against their plain PyTorch versions on the card, at the shapes
   AlexNet gives them and at edge shapes, with warm CUDA-event times of the
   kernel, the plain version and one PyTorch library call computing the same
   function, beside the least time the card could take (bytes over 3.35 TB/s
   or operations over the peak for their type, whichever is larger: 67
   TFLOP/s for float32 elementwise work, 165 TFLOP/s (TF32 / 3) for float32
   attention products, 989 TFLOP/s bfloat16; the H100 SXM data-sheet
   peaks). K1 is the LRN forward; K2, the LRN backward, is also
   held to an error under 1% of the largest cross-channel term
   (max|2 alpha beta x u|), so a kernel that dropped that term fails.
   Both also run every shape in bfloat16, held within one bfloat16 ulp of
   each value of the float32 plain version on the upcast inputs, rounded
   once (`bf16_ulp_check`), and the AlexNet calls are timed in bfloat16
   too, against F.local_response_norm (and autograd of it) in bfloat16.
   K3-K5 (flash attention) at the char model's shape and edge shapes, on
   the tensor cores: 3xTF32 in float32, bfloat16 products in bfloat16.
   Then an embedding net behind a ParallelInference on the card serves a
   good request after a bad one (an index out of range raises IndexError
   before the gather, so the CUDA context stays usable). K6,
   the int8 product of quantized serving, bitwise against its plain
   version at AlexNet's three dense shapes for buckets 1 and 32, the JAX
   package's test shapes, m beyond 32, batch sizes around its 8-row
   n-fragment, the extreme values (at the largest K too, where K is split
   over a cluster of blocks) and operands one byte off alignment, with
   torch._int_mm as its yardstick and an int8 tensor-core bound of
   1,979 TOPS.
4. Serving: zoo AlexNet at full width (224x224x3, 1000 classes, random
   weights from its seed) behind a BATCHED ParallelInference (batch_limit
   32), 4 client threads x 8 requests of 1-8 images. Every answer is held to
   `net.output` on the same rows, to a forward whose LRN runs the plain
   version on the card, and (for the first request) to the CPU path, which
   the test suite holds to the JAX package. At random init the window term
   is a small part of k, so these whole-network comparisons barely see LRN;
   the kernel is held to its plain version inside those forwards, on the
   served activations, and on random inputs in phase 3. The launch counts are reset just
   before the clients start and read just after they finish: each kernel of
   the path must have launched, LRN twice per executed forward. Then one
   forward at bucket 32 is profiled: device time against wall time.
   Quantized serving: the same net and load with its tree quantized
   (`quantize_tree`) to int8, then to bf16. The counts are reset just before
   the clients start: K6 must launch 3 x executed forwards in int8 (fc6,
   fc7, output) and 0 in bf16, K1 2 x forwards in both, and every K6 call
   in those forwards is held bitwise to the plain product on its real
   inputs. Each answer is held to `net.output` of the batch it was served
   in, and the card to the CPU path layer by layer (the first bfloat16 conv
   and each bfloat16 product within one ulp of the layer's largest value,
   each int8 preout bitwise and
   within its envelope of float32); a sum in another order can tip a
   bfloat16 or int8 rounding, so the distances from an answer's own rows
   and from the CPU's answer are reported against quantization's own. Then
   the drift from the float32 answers on a batch of 32, latencies from a
   second, unchecked run, and one profiled forward.
5. Training: zoo AlexNet at full width, `fit` for TRAIN_STEPS steps at
   batch 128 on images and one-hot labels from a numpy seed (Nesterovs,
   L2, per-layer L2 renormalization, dropout 0.5 on the dense inputs). The
   counts are reset just before `fit` and read just after: K1 and K2 must
   each launch 2 x steps times. Every K2 call inside those steps is held to
   the plain backward on the real cotangents (and the cotangent's layout
   recorded); every score must be finite. Then, with cuDNN deterministic,
   `compute_gradient_and_score` with K1+K2 against the same call with LRN
   forward and backward bound to the plain versions (batch 128), and the
   card against the CPU path (batch 2), per parameter, the second run of
   each pinned to the first's ReLU and max-pool decisions (`pinned_kinks`;
   at most MAX_PINNED_SHARE of them may have flipped). Then the median warm
   step time, images/s, and one warm step under torch.profiler.
6. bfloat16 AlexNet (`phase_bf16_alexnet`): the JAX package's benchmark
   network, `AlexNet().init(dtype=torch.bfloat16)` at full width, served
   with phase 4's load and trained for TRAIN_STEPS `fit` steps at batch
   128, every LRN on K1 and K2 in bfloat16: launch counts reset just before
   and read just after each run; every K1 call of the re-run batches and
   every K2 call of the steps held to its yardstick; each answer bitwise
   its batch's rows; the card's layers against the CPU's one by one; one
   batch's score against the CPU's (rtol 1e-2); p50/p99, images/s, the
   median step, and a profiled forward and step.
7. Checkpoints (`phase_checkpoint_fixtures`, before the serving phases):
   the JAX package's `lenet_mnist.zip` and `graph_merge.zip` restored on
   the card by `restore_model`, against the CPU's restore (rtol 1e-5, atol
   1e-6, same top-1) and against `expected.npz`.
8. GoogLeNet, a ComputationGraph (`phase_googlenet_serving`,
   `phase_googlenet_training`): zoo GoogLeNet at full width (224x224x3,
   1000 classes), float32 with TF32 off, served with phase 4's load (K1 2 x
   executed forwards at lrn1 [b, 56, 56, 64] and lrn2 [b, 56, 56, 192], each
   answer bitwise its batch's rows, every re-run K1 call held to the plain
   version, a batch of 2 against the CPU path, p50/p99, images/s, a
   profiled bucket-32 forward with its H2D share, and the sibling-fused
   graph carrying the same parameters within rtol 1e-5); trained by `fit`
   for 6 steps at batch 64 (K1 and K2 2 x steps, every K2 call checked,
   gradients card vs CPU at batch 2 with the CPU run pinned to the card's
   ReLU and max-pool decisions (`pinned_kinks`), the median warm step,
   a profiled step) and then for 4 steps in bfloat16 at batch 128 (every
   K1 and K2 call within one bfloat16 ulp of its yardstick); each network
   then saved and restored bitwise (parameters, optimizer state, counters,
   answers). GoogLeNet's two LRN shapes are also LRN_CASES of phase 3.
9. ResNet50 (`phase_resnet_training`, `phase_resnet_serving`,
   `phase_resnet_bf16_training`): zoo ResNet50 at full width (224x224x3,
   1000 classes, 53 BatchNormalization nodes with their running state, 16
   shortcut adds), a ComputationGraph on no hand-written kernel: every
   count is reset just before each run and must read 0 just after. Trained
   by `fit` 6 steps at batch 128 in float32 (TF32 off): the BN state moves
   on every step, and the first step's is held to a float64 recompute of
   the batch statistics on the card; after a second epoch (both epochs on
   cuDNN's deterministic algorithms, so the state is the same in every
   run), train-mode gradients card vs CPU at batch 2, the CPU pinned to the
   card's ReLU and max-pool decisions, each node's limit times the BN
   cancellation its gradient passes back through (`bn_grad_factors`), and
   that step's new state; the median warm step from a third epoch on
   cuDNN's defaults, a profiled step with its device time by kernel group,
   the BN passes timed alone; a checkpoint round trip bitwise, BN state
   included. Served with
   phase 4's load through ParallelInference(check_finite=True) on the
   trained running statistics, or, where they overflow, on statistics set
   from one train-mode forward of a calibration batch (the phase says
   which): answers finite and bitwise their batch's rows, a batch of 2
   against the CPU path. Trained 4 steps as a bfloat16 network at batch 256
   (bench.py's 1024 cut for time and memory): BN state float32, scores
   finite. `phase_checkpoint_fixtures` also restores the JAX package's
   `mln_cnn.zip` (BN state, NormalizerStandardize) on the card.
10. The recurrent slice (`phase_text_generation`, `phase_rnn_checkpoint`):
   zoo TextGenerationLSTM at bench.py's bench_lstm width (two GravesLSTM(256),
   77 characters, batch 128 x 64 steps, truncated BPTT 50: two windows and
   two optimizer steps a batch), `fit` over TEXT_BATCHES batches with every
   count reset just before and read just after (0: the JAX LSTM is plain
   XLA); each window held a detached carry and none is left after a batch;
   the median warm batch, tokens/s, one profiled batch (device busy against
   wall); gradients card vs CPU at batch 2 (`compare_pinned_grads`);
   `rnn_time_step` step by step against `output` (rtol 1e-4, atol 1e-6) and
   RnnStateMismatchError for another batch size; served through
   ParallelInference (p50, sequences/s); a checkpoint round trip bitwise.
   The JAX package's `mln_rnn.zip` restored on the card against
   `expected.npz` (rtol 1e-5), resumed one step against the CPU's resume,
   and round-tripped bitwise.
11. The face models (`phase_face_model`): zoo InceptionResNetV1 (160x160x3,
   1001 labels) and FaceNetNN4Small2 (96x96x3, 5749 labels) at full width,
   served through ParallelInference(check_finite=True) (on calibrated BN
   statistics where the initial ones overflow), then trained FACE_STEPS
   steps at batch FACE_BATCH with every count 0, the first step's BN state
   held to a float64 recompute; card vs CPU at batch 2, the train-mode score
   and every node one by one (`check_nodes_one_by_one`).
12. The fit loop (`phase_fit_loop_alexnet`, `phase_fit_loop_char`):
   zoo AlexNet at full width, float32, batch 128, cuDNN deterministic:
   `fit` with device prefetch (pinned staging on a side stream) is the main
   path, K1 and K2 reset just before and read just after (2 a step each);
   prefetch against no prefetch, steps_per_dispatch=3 against single steps
   and `fit_batch_repeated` against a loop, each bitwise; an
   EarlyStoppingTrainer run whose restored best model answers bitwise as
   when saved; then, with cuDNN's defaults, the step time and the H2D share
   of busy time with and without prefetch, and `last_etl_host_ms` /
   `last_etl_h2d_ms`. The char model at bench.py's attention_longctx width
   (bfloat16, `packed_segments`) on 16 ragged sequences of 512-8192 tokens
   through PackToBucketIterator(bucket_len=8192): K3-K5 reset and read
   around one checkpointing epoch (2 a step each); the packed score against
   the unpacked one (PACKED_RTOL), a fresh network's resume bitwise, the
   sentinel's `skip_step` on an injected ``step.nonfinite`` bitwise; real
   tokens/s packed against padded.
13. Decode serving (`phase_decode_kernel` among the kernel phases, then
   `phase_decode_serving`, `phase_decode_stream`, `phase_packed_admission`
   at the end): K7, the single-query decode attention, against
   `decode_attention_reference` at the engine's geometry (b 8, t_kv 256, 4
   heads of 32, read in place from a layer of the step's view) and at b 16,
   t_kv 8192, 4 heads of 128 in float32 and bfloat16 (DECODE_REL; one
   bfloat16 ulp), timed beside its bytes bound, SDPA with a boolean mask
   and K3 at one query row, at each split count and with no key to read,
   its host microseconds a call beside; also the engine's 64-key bucket
   and lengths on the edges of the per-row split. The DecodeEngine at
   bench.py bench_serving_decode's defaults (TransformerDecoder(seed=7), 4
   layers, 6 clients x 4 prompts x 48 tokens): K7 = layers x steps, one K7
   device kernel a layer in a profiled step, every answer equal to
   `naive_generate`'s on the card, step logits against a full recompute,
   the KV cache drained, a `serve.decode_step` fault isolated to one
   rider; tokens/s, inter-token p50/p99. TextGenerationLSTM through
   RecurrentAdapter against a direct `rnn_time_step` stream. The bfloat16
   char model behind ParallelInference(packed_admission=True, pack_bucket
   8192): K3 = 2 x packed forwards, answers against each request alone, a
   `serve.pack` fault failing one request; requests/s, p50.
14. Data and pretraining (`phase_image_directory_alexnet`,
   `phase_vae_mnist`, `phase_dbn_mnist`, `phase_records_export`, after the
   fit loop): a directory of 16 label folders, 640 PPM images of
   256x256x3 written from a seed, read by ImageRecordReader(224, 224, 3)
   and ImageRecordReaderDataSetIterator(batch 128, 1000 classes, 8 workers)
   through a DevicePrefetchIterator into zoo AlexNet's float32 `fit` for
   one epoch: the host ETL's native arm carries every call (its resize
   within one grey level of the numpy arm, the share that differs logged),
   the first batch bitwise a direct decode, resize and scale, K1 and K2
   reset just before and read just after (2 a step each), the loss finite
   and the parameters moved; host ETL ms a batch at 1 and 8 workers and
   by stage, the image-fed step against the array-fed one, one profiled
   batch. DL4J's VariationalAutoEncoderExample at its widths (784-256-256-2,
   Bernoulli, RmsProp(1e-3)) `pretrain`ed one epoch over 60,000 synthesized
   MNIST images (IDX files, scaled to [0, 1]): the held-out negative ELBO
   falls, a step card vs CPU on the same eps (1e-4), `generate` and
   `reconstruction_error` on the card. The 784-1000-500-250-30 stack (an
   RBM with CD-1, three AutoEncoders, a softmax head) `pretrain`ed one epoch
   over 10,000 images, then `fit`: CD-1 card vs CPU on the same uniforms
   with near-ties pinned (1e-5), each layer's reconstruction MSE falls, a
   frozen layer skipped. A CSV through CSVRecordReader into an Iris net's
   `fit`, and `fit` on exported files bitwise `fit` on the same batches.
15. The serving plane (`phase_gateway`, right after the quantized serving
   of phase 4): a ServingGateway on 127.0.0.1 over a ModelPool serving zoo
   AlexNet at full width (tier "critical", with a CheckpointManager) and a
   fused group of two zoo GoogLeNets (tier "batch"; the phase fails if the
   group fell back); 4 clients x 8 requests of 1-8 images over HTTP
   /predict beside 2 clients on the members, K1 = 2 x AlexNet's forwards + 4
   x the fused ones; each HTTP answer against the same request in process
   and `net.output`, each member's columns against that member alone, a
   request of 2 against the CPU path; a second AlexNet trained 2 steps at
   batch 32 publishes a checkpoint and POST /swap runs under live traffic
   (no request fails, every answer the old parameters' or the new ones',
   the new ones' after the swap returned), then /swap {"quantize": "int8"}
   (the canary's drift under its budget, K6 = 3 x forwards, answers bitwise
   their batch's rows), then a checkpoint with a NaN in fc8's bias (409
   canary_rejected, the int8 tree itself restored, answers bitwise
   unchanged); the serve.forward fault opens the breaker (503 breaker_open
   without a forward, /health degraded) and one probe recloses it;
   TransformerDecoder(seed=7) through POST /generate (6 clients x 4 prompts
   x 48 tokens, every answer `naive_generate`'s, K7 = layers x steps); the
   flight recorder's exemplars (phases within 1 ms of their latency),
   /trace, and an AutoTuner with a temporary ledger behind /debug/tuner
   (every ledger row valid). Reports p50/p99 and images/s over HTTP and in
   process, one profiled request of each, the swap's pause, tokens/s and
   inter-token p50/p99 through /generate.
16. Scale-out (`phase_federation`, `phase_parallel_wrapper`,
   `phase_param_server`, `phase_multihost`, at the end): two serving
   replicas spawned by `spawn_replica` (AlexNet float32 and the decoder
   through `federation_builder`) behind a FederationFrontEnd in this
   process, on the one card: phase 15's /predict load cut to what JSON
   carries and /generate beside it, every answer against this process's
   own; each replica's K1 and K7 (its GET /metrics) held to the forwards
   and decode steps it served; SIGKILL of a replica holding a /predict and
   a /generate (the /predict retried on the sibling, no /predict failed,
   the /generate a typed replica_lost), its respawn JOINING then HEALTHY,
   a rolling /swap under traffic to the new parameters. ParallelWrapper
   over 2 data shards on the card at a global batch of 128: sync `fit`
   against a plain fit (each leaf's update within UPDATE_REL_STEP after a
   step and UPDATE_REL_FIT after four), local SGD
   against two networks averaged by hand, K1 and K2 = 2 x 2 shards x
   steps, step ms against the plain step. The parameter server: one
   worker at staleness 0 against the sequential fit, two racing workers
   (applied and dropped pushes, pull/push ms), the HTTP node and client at
   LeNet size. Two ranks of the multi-process runner over gloo (64 a
   rank): bitwise agreement, the update against a single-process fit at
   128, the chief's checkpoint restored, all-reduce ms; a killed rank
   answered by exit code 17, and SIGTERM's grace checkpoint, both ranks
   exiting 0, resumed to the uninterrupted run's parameters.
17. Word and graph embeddings (`phase_word2vec_device_corpus`,
   `phase_word2vec_builder`, `phase_doc_and_graph_embeddings`, at the end),
   plain torch on no hand-written kernel: every count reset before and 0
   after. The device-corpus engine (ShardedWord2Vec) at bench.py's w2v
   large geometry (Zipf 1.05 over 1M ids, 10M tokens, layer 128, chunk
   16384 x 8): a warm and a timed epoch (words/s), the tables' bytes, a
   profiled call; one chunk on the trained tables, card against CPU and
   against a float64 dense autograd form of the chunk (1e-5 of max|table|);
   two shards listing the card twice against one at bench_w2v's default
   geometry (rtol 2e-4, atol 2e-5 after 2 epochs); the planted two-cluster
   corpus separating by more than 0.3. Word2Vec.builder() at its defaults
   (HS) with negative 5 on that corpus as text: words/s, the host's share,
   one HS + NS batch card against CPU and the dense form (with syn1 scaled
   so that half the code bits leave the |score| < 6 window), a CBOW epoch,
   the serializer's round trips bitwise, `words_nearest`. ParagraphVectors
   DBOW and DM (purity of each probe's nearest document), `infer_vector`
   card against CPU, GloVe at its defaults, DeepWalk on 10,000 vertices and
   Node2Vec on 1,000 (same-topic or same-community neighbours first).
18. Clustering, the k-NN server and Keras import (`phase_knn`,
   `phase_kmeans`, `phase_tsne`, `phase_keras_import`, at the end), plain
   torch on no hand-written kernel: every count reset before and 0 after.
   Brute-force k-NN over a 1M x 128 float32 corpus (a Word2Vec table's
   size) in both metrics, 1,024 queries in batches of 256 (queries/s, ms a
   batch), a batch held to the CPU port (distances within 1e-5, indices but
   at near-ties), the tie order on a corpus of duplicate rows, and
   NearestNeighborsServer over HTTP (each answer a direct search's).
   KMeansClustering on 1M x 64 planted blobs, k 256, up to 100 Lloyd
   iterations (iterations/s), one step card and CPU against float64, the
   inertia on a 100,000-point subset against the CPU's. Exact t-SNE at
   5,000 x 50 with the defaults (calibration seconds and step ms apart),
   one step card against CPU, the whole run's KL at 1,000 points against
   the CPU's. Keras import of the eight fixtures through the port's own
   HDF5 reader (against the recorded Keras outputs and the CPU port), the
   full-width mnist_cnn.h5 served against the JAX package's outputs and
   trained through KerasBackendServer over HTTP (/fit, /predict).
19. Training observability, streaming and the estimators
   (`phase_training_ui`, `phase_streaming_route`, `phase_estimators`,
   `phase_churn_and_locks`, at the end). Full-width AlexNet `fit` at batch
   128 under a StatsListener (histograms, updates, memory) writing over HTTP
   (RemoteStatsStorageRouter -> StatsReceiverServer -> FileStatsStorage),
   a ConvolutionalIterationListener and a UIServer: every record held to
   float64 numpy on the phase's own host copies (histograms count for
   count against np.histogram), the pages answering, ms a step with the
   listener and without, the bytes it brings to the host a record. A
   ServeRoute over AlexNet behind an NDArrayStreamServer, 32 images from 2
   HttpBrokerClient threads, each answer a direct output's, the first after
   a subscribe delivered, a malformed message counted. MLNClassifier (a
   784-1000-10 MLP, one epoch over 60,000 synthesized MNIST images) and
   MLNRegressor against the same estimators on the CPU. The churn guard on
   AlexNet's `output`, and the lock recorder around a batched
   ParallelInference cross-checked against the static lock graph. K1 and K2
   counted where AlexNet runs, every other count 0.
20. Host syncs, and the port's analysis gate (`phase_host_syncs`): one
   `fit` group of full-width AlexNet at batch 128, 8 steps of the
   DecodeEngine at the decode phase's engine shape and 4 k-means iterations at 1M x 64,
   k 256, under `tracecheck.sync_debug("warn")` (the card's count of
   synchronizing CUDA operations, by call site) with each path's step
   function wrapped by `tracecheck.wrap` (the values the host reads
   implicitly): syncs per step for each site; `fenced_read` adds none to
   either count; `python -m deeplearning4j_torch.analysis` exits 0.
21. Across processes (`phase_word2vec_across_processes`,
   `phase_sequence_parallel_output_across_processes`): `ShardedWord2Vec`
   on a mesh of two gloo ranks on the one card (`chip_smoke.py
   --word2vec-rank`), 1M ids, layer 100, 1M tokens, held to the
   one-process two-shard mesh, words/s of both; `SequenceParallelWrapper.
   output` of the char model at t 8192 cut over two gloo ranks of two seq
   shards each (`multihost.main --mode sp --output`), held to the
   one-process SP output and the plain output within 1e-4, K3 launched
   layers x shards x hops times, output ms.
22. Heads wider than 128 and the bfloat16 backward accumulator
   (`phase_wide_kernels` among the kernel phases, `phase_char_model_wide`
   after the char model, `phase_decode_wide` after decode serving): the
   sliced arms of K3-K5 at head_dim 256 (the wide char model's shape, timed
   beside SDPA and the backend it took), 160, 300, 512 and 2688, in both
   types, causal, with a key mask and with packed segments; K4's and K5's
   bfloat16-accumulator arms at JAX blocks 128, 32 and 100 against the
   plain accumulator (at head_dim 1024, t 64 with segments within the plain
   version's own spread), and its path through `flash_attention(...,
   bwd_acc_dtype="bfloat16")`; K7's wide arm (K7w) at 256 (also at the wide
   decoder's own lengths), 300 and 2688, warm and cold, at 1-8 splits, its
   geometry held to the wrapper's and its ptxas record to no spill. The char
   model at width 1024 over 4 heads (t 8192, batch 4) served and trained in
   float32 and as a bfloat16 network (the sliced K3 once a layer a forward,
   K4 and K5 once a layer a backward), its gradients against the plain
   versions and the card against the CPU; a decoder with Gemma 2B's widths
   (8 heads of 256, ff 16384, 4 layers) behind the decode engine at
   bench_serving_decode's load, K7w once a layer a step, one step profiled, every
   answer equal to a run on K7's plain version and to `naive_generate`.
23. One JSON line with every kernel's numbers (K3's launches on each path
   it ran, the char model's and the SP output's across processes; the
   sliced and accumulator arms with their own), then the result line
   {"ok": true, "device": {...}}.

Needs one CUDA GPU; exits non-zero without one. ``chip_smoke.py
--word2vec-rank ...`` is one rank of phase 21, which the script spawns.
"""
import copy
import json
import logging
import os
import queue
import re
import subprocess
import sys
import threading
import time
import types
import zlib
from contextlib import ExitStack, contextmanager

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM data sheet, float32 outside tensor cores
LRN_K, LRN_ALPHA, LRN_BETA, LRN_N = 2.0, 1e-4, 0.75, 5  # AlexNet's LRN
SLEEP_CYCLES = 20_000_000   # ~10 ms at the H100's clock: longer than 20 launches take the host
LRN_RTOL, LRN_ATOL = 1e-5, 1e-6       # float32 kernel vs float32 plain
BF16_ULP = 2.0 ** -7   # the spacing of bfloat16 values, relative, at most
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-7   # float32 forwards, cuDNN's choice of algorithm per batch size
CROSS_SHARE = 0.01   # K2's error must stay under this share of its largest cross-channel term
TRAIN_BATCH, TRAIN_STEPS = 128, 6     # AlexNet's published batch size
# Per-parameter relative norm of a gradient difference: float32 convs and
# matmuls whose sums run in another order (another device, or LRN's
# rounding propagated through the layers below it), with the second run's
# kinks pinned to the first's decisions (pinned_kinks).
GRAD_REL = 1e-4
# Share of those decisions that the second run may take otherwise before
# they are pinned. Rounding flips 4.5e-7 (char model, t 8192), 1.5e-6 and
# 3.9e-6 (GoogLeNet, batch 2) of them on an H100 (PERF.md); parameters
# moved by 1e-4 of their values flip 1.6e-5 (batch 2) and 3.6e-5 (batch 8)
# of zoo AlexNet's at 60x60 (tests/test_torch_chip_smoke.py).
MAX_PINNED_SHARE = 1e-5
SCORE_RTOL = 1e-5

# (label, NHWC shape, n, alpha, scale of x, timed group): AlexNet's two LRN
# calls, GoogLeNet's two (lrn1 and lrn2 at 56x56, at the serving bucket 32
# and the training batch 64) and the edge cases, shared by K1 and K2. The
# calls of a group are timed and summed into the kernel's entry: "alexnet"
# its top-level numbers, "googlenet" its "googlenet" numbers.
LRN_CASES = [
    ("alexnet_lrn1_b128", (128, 55, 55, 64), LRN_N, LRN_ALPHA, 1.0, "alexnet"),
    ("alexnet_lrn2_b128", (128, 14, 14, 192), LRN_N, LRN_ALPHA, 1.0, "alexnet"),
    ("alexnet_lrn1_b32", (32, 55, 55, 64), LRN_N, LRN_ALPHA, 1.0, None),
    ("alexnet_lrn2_b32", (32, 14, 14, 192), LRN_N, LRN_ALPHA, 1.0, None),
    ("googlenet_lrn1_b64", (64, 56, 56, 64), LRN_N, LRN_ALPHA, 1.0, "googlenet"),
    ("googlenet_lrn2_b64", (64, 56, 56, 192), LRN_N, LRN_ALPHA, 1.0, "googlenet"),
    ("googlenet_lrn1_b32", (32, 56, 56, 64), LRN_N, LRN_ALPHA, 1.0, None),
    ("googlenet_lrn2_b32", (32, 56, 56, 192), LRN_N, LRN_ALPHA, 1.0, None),
    ("c3", (7, 5, 9, 3), LRN_N, 1e-2, 3.0, None),
    ("c1", (3, 7, 11, 1), LRN_N, 1e-2, 3.0, None),
    ("even_n4", (4, 9, 9, 64), 4, 1e-2, 3.0, None),
    ("rows_1013_n1", (1, 1, 1013, 96), 1, 1e-2, 3.0, None),
    ("c2048_large_smem", (2, 3, 5, 2048), 7, 1e-2, 3.0, None),
    # K2's tiles hold 2048 // C rows: C not a multiple of 4 (4-byte copies,
    # one channel a thread) over 32 tiles and a ragged last one, and a window
    # wider than 4 to a side (16-byte copies, one channel a thread)
    ("c67_969_rows", (3, 17, 19, 67), LRN_N, 1e-2, 3.0, None),
    ("c64_n10", (2, 9, 11, 64), 10, 1e-2, 3.0, None),
]


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=20):
    """Device time of one call of `fn`, for calls whose launch costs the host
    more than they cost the device: the calls are queued behind a sleep
    kernel that holds the device while the host launches them, so the CUDA
    events around them time back-to-back execution, not the launches."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def lrn_bound_ms(numel, n, elem=4):
    """Least time for LRN over `numel` elements of `elem` bytes: read x and
    write y once (2 elem bytes: 8 in float32, 4 in bfloat16), or 2n + 3
    float32 operations each (n squares, n - 1 adds, the scale, the offset,
    the power and the divide counted as one each; both types compute in
    float32)."""
    bytes_ms = 2.0 * elem * numel / HBM_BYTES_PER_S * 1e3
    ops_ms = (2 * n + 3) * numel / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def lrn_bwd_bound_ms(numel, n, elem=4):
    """Least time for the LRN backward over `numel` elements of `elem`
    bytes: read x and g and write dx once (3 elem bytes: 12 in float32, 6
    in bfloat16), or 3n + 8 float32 operations each (the squares' window
    2n - 1, scale and offset 2, the power 1, t = g x p / d 3, the transposed
    window n - 1, g p - 2ab x u 4, counted as one each)."""
    bytes_ms = 3.0 * elem * numel / HBM_BYTES_PER_S * 1e3
    ops_ms = (3 * n + 8) * numel / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def bf16_ulp_check(torch, label, got, want32, atol):
    """Hold a bfloat16 kernel's result to its yardstick, the float32 plain
    version on the upcast inputs (`want32`) rounded once: each value within
    one bfloat16 ulp of the rounded yardstick, beyond the float32 check's
    own slack (LRN_RTOL |want32| + atol, where a sum that cancels leaves
    float32 rounding larger than the small result's ulp). The kernel computes
    in float32 and rounds once too, so it lands on the other neighbour only
    where its float32 value and the yardstick's straddle a rounding
    boundary. Returns (max |got - rounded yardstick|, the largest error as a
    share of its limit); raises if any value is further off."""
    want = want32.to(torch.bfloat16).float()
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    ulp = torch.where(want == 0, torch.zeros_like(ulp), ulp)
    err = (got.float() - want).abs()
    limit = ulp + LRN_RTOL * want32.abs() + atol
    bad = int((err > limit).sum())
    if bad:
        raise RuntimeError(f"{label}: {bad} bfloat16 values lie beyond one ulp of "
                           f"the float32 yardstick rounded once (largest error "
                           f"{err.max().item()})")
    share = torch.where(limit > 0, err / limit, torch.zeros_like(err))
    return err.max().item(), share.max().item()


def lrn_cross_term(x, g, k, alpha, beta, n):
    """2 alpha beta x_i u_i: the part of the LRN backward that couples
    channels (the rest is g_i d_i^-beta)."""
    from deeplearning4j_torch.ops import lrn as lrn_ops
    up = n // 2
    d = k + alpha * lrn_ops.window_sum(x * x, up, n - 1 - up)
    u = lrn_ops.window_sum(g * x * d.pow(-beta) / d, n - 1 - up, up)
    return 2.0 * alpha * beta * x * u


def phase_header(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    # the settings every tolerance here assumes, in this process and in the
    # replicas and ranks it spawns
    from deeplearning4j_torch.utils.device import exact_float32
    exact_float32()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log("tf32: cudnn.allow_tf32=False (cuDNN's default is True), "
        "cuda.matmul.allow_tf32=False; bfloat16 products reduce in float32 "
        "(allow_bf16_reduced_precision_reduction=False)")
    return card


_PTXAS_ARGS = {"f": "float", "13__nv_bfloat16": "bf16", "Lb0E": "false", "Lb1E": "true"}
_PTXAS_ARG = r"f|13__nv_bfloat16|Li-?\d+E|Lb[01]E"   # a mangled template argument


def _kernel_name(mangled):
    """The kernel's name in a mangled symbol, with its template arguments
    (float, bf16, integers, booleans): the identifier that ends in _kernel
    and carries its own length in front, past any namespace prefix."""
    for m in re.finditer(r"(?=(\d+)([a-z]\w*?_kernel)(?:I((?:%s)+)E)?)" % _PTXAS_ARG,
                         mangled):
        n, name, args = m.groups()
        if len(name) == int(n):
            if args:
                name += "<" + ", ".join(_PTXAS_ARGS.get(t) or t[2:-1]
                                        for t in re.findall(_PTXAS_ARG, args)) + ">"
            return name
    return mangled


def ptxas_report(text):
    """[{"kernel": "flash_bwd_dq_kernel<bf16, 8>", "registers": 168,
    "spill_stores": 0, "spill_loads": 0, "stack": 0}, ...] from nvcc's
    -Xptxas -v output, one entry per kernel, with "smem" (static shared
    bytes) where ptxas reports any."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1))}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                cur["smem"] = int(m.group(1))
    return out


def phase_build():
    from deeplearning4j_torch.ops import cuda_build
    t0 = time.perf_counter()
    libs = cuda_build.build(["lrn", "flash_attention", "int8_matmul",
                             "decode_attention"])
    secs = time.perf_counter() - t0
    log(f"build: {len(libs)} kernel libraries in {secs:.2f} s")
    for name, text in cuda_build.build_logs.items():
        for kernel in ptxas_report(text):
            log(f"  ptxas[{name}] {json.dumps(kernel)}")
    return secs


def _lrn_library(F, x, n, alpha):
    """F.local_response_norm on the NCHW view of an NHWC tensor (its size
    n, its alpha the per-element alpha times n): the library call that
    computes K1's function."""
    return F.local_response_norm(x.permute(0, 3, 1, 2), n, alpha * n, LRN_BETA, LRN_K)


def phase_lrn(torch, card):
    """K1 against `lrn_reference` on random x at every LRN_CASES shape:
    float32 at LRN_RTOL/LRN_ATOL, bfloat16 within one bfloat16 ulp of the
    float32 plain version rounded once (`bf16_ulp_check`). The AlexNet
    calls are timed in both types beside the plain version and
    F.local_response_norm: device time behind a sleep kernel (`device_ms`),
    and the CUDA-event time of back-to-back calls (`events_ms`, how the
    LRN kernels were timed before; for a call this short it also counts
    the host's launches)."""
    import torch.nn.functional as F
    from deeplearning4j_torch.ops import lrn as lrn_ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, shape, n, alpha, scale, timed in LRN_CASES:
        hyper = (LRN_K, alpha, LRN_BETA, n)
        x = torch.randn(shape, device="cuda", generator=gen) * scale
        got = lrn_ops.lrn(x, *hyper)
        torch.cuda.synchronize()
        want = lrn_ops.lrn_reference(x, *hyper)
        torch.testing.assert_close(got, want, rtol=LRN_RTOL, atol=LRN_ATOL)
        xb = x.to(torch.bfloat16)
        got16 = lrn_ops.lrn(xb, *hyper)
        torch.cuda.synchronize()
        err16, share = bf16_ulp_check(torch, f"lrn {label} bfloat16", got16,
                                      lrn_ops.lrn_reference(xb.float(), *hyper), LRN_ATOL)
        row = {"case": label, "shape": list(shape), "n": n, "group": timed,
               "max_abs_err": (got - want).abs().max().item(),
               "bf16_max_abs_err": err16, "bf16_limit_share": share}
        if timed:
            row["library_max_abs_err"] = (_lrn_library(F, x, n, alpha).permute(0, 2, 3, 1)
                                          - want).abs().max().item()
            row["ms"] = device_ms(torch, lambda: lrn_ops.lrn(x, *hyper))
            row["events_ms"] = cuda_time_ms(lambda: lrn_ops.lrn(x, *hyper))
            row["plain_ms"] = device_ms(torch, lambda: lrn_ops.lrn_reference(x, *hyper))
            row["library_ms"] = device_ms(torch, lambda: _lrn_library(F, x, n, alpha))
            row["bound_ms"], row["bound_by"] = lrn_bound_ms(x.numel(), n)
            row["bf16_ms"] = device_ms(torch, lambda: lrn_ops.lrn(xb, *hyper))
            row["bf16_library_ms"] = device_ms(torch, lambda: _lrn_library(F, xb, n, alpha))
            row["bf16_bound_ms"], _ = lrn_bound_ms(x.numel(), n, elem=2)
            # a device copy of the same bytes: what reading x and writing y
            # take on this card at best
            y, yb = torch.empty_like(x), torch.empty_like(xb)
            row["copy_ms"] = device_ms(torch, lambda: y.copy_(x))
            row["bf16_copy_ms"] = device_ms(torch, lambda: yb.copy_(xb))
            del y, yb
        rows.append(row)
        log(f"lrn {label}: {json.dumps(row)}  [{card}]")
        del x, xb, got, got16, want
    # launches: filled from the serving run
    return kernel_entry("lrn_fwd", "deeplearning4j_tpu/ops/pallas_kernels.py:128", rows)


def _timed_sums(timed):
    """The times and bounds of a group of timed LRN calls, summed."""
    return {
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in timed)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in timed),
        "events_ms": sum(r["events_ms"] for r in timed),
        "bf16_ms": sum(r["bf16_ms"] for r in timed),
        "bf16_bound_ms": sum(r["bf16_bound_ms"] for r in timed),
        "bf16_library_ms": sum(r["bf16_library_ms"] for r in timed),
    }


def kernel_entry(name, replaces, rows):
    """A kernel's entry of the `kernels` line: AlexNet's two LRN calls at
    batch 128 (one forward's or one step's worth) summed, float32 and
    bfloat16; under "googlenet" the same for GoogLeNet's two calls at batch
    64 (its training step's); its largest errors over every case."""
    return {
        "name": name, "route": "cuda",
        "source": "deeplearning4j_torch/ops/csrc/lrn.cu",
        "replaces": replaces, "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **_timed_sums([r for r in rows if r["group"] == "alexnet"]),
        "bf16_max_abs_err": max(r["bf16_max_abs_err"] for r in rows),
        "bf16_limit_share": max(r["bf16_limit_share"] for r in rows),
        "googlenet": {"cases": [r["case"] for r in rows if r["group"] == "googlenet"],
                      **_timed_sums([r for r in rows if r["group"] == "googlenet"])},
    }


def phase_lrn_bwd(torch, card):
    """K2 against `lrn_bwd_reference` on random x and cotangents: float32
    at LRN_RTOL/LRN_ATOL and with an error under CROSS_SHARE of the largest
    cross-channel term; bfloat16 within one bfloat16 ulp of the float32
    plain version rounded once, where the alpha 1e-2 cases carry the
    cross-term evidence (at AlexNet's 1e-4 the term lies below a bfloat16
    ulp of dx; with 1e-2 a dropped window channel is many ulps off). The
    library yardstick is autograd's backward of F.local_response_norm on
    the NCHW view (its graph built once, only the backward timed); times as
    in phase_lrn, K2's the median of three readings."""
    import torch.nn.functional as F
    from deeplearning4j_torch.ops import lrn as lrn_ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label, shape, n, alpha, scale, timed in LRN_CASES:
        hyper = (LRN_K, alpha, LRN_BETA, n)
        x = torch.randn(shape, device="cuda", generator=gen) * scale
        g = torch.randn(shape, device="cuda", generator=gen)
        got = lrn_ops.lrn_bwd(x, g, *hyper)
        torch.cuda.synchronize()
        want = lrn_ops.lrn_bwd_reference(x, g, *hyper)
        torch.testing.assert_close(got, want, rtol=LRN_RTOL, atol=LRN_ATOL)
        err = (got - want).abs().max().item()
        cross = lrn_cross_term(x, g, *hyper).abs().max().item()
        if not err < CROSS_SHARE * cross:
            raise RuntimeError(f"lrn_bwd {label}: error {err} is not under "
                               f"{CROSS_SHARE} of the cross term {cross}")
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
        got16 = lrn_ops.lrn_bwd(xb, gb, *hyper)
        torch.cuda.synchronize()
        err16, share = bf16_ulp_check(
            torch, f"lrn_bwd {label} bfloat16", got16,
            lrn_ops.lrn_bwd_reference(xb.float(), gb.float(), *hyper), LRN_ATOL)
        row = {"case": label, "shape": list(shape), "n": n, "alpha": alpha,
               "group": timed, "max_abs_err": err, "max_cross_term": cross,
               "bf16_max_abs_err": err16, "bf16_limit_share": share,
               "bf16_max_cross_term": lrn_cross_term(
                   xb.float(), gb.float(), *hyper).abs().max().item()}
        if timed:
            graphs = {}
            for key, (xv, gv) in {"f32": (x, g), "bf16": (xb, gb)}.items():
                xr = xv.detach().requires_grad_()
                graphs[key] = (_lrn_library(F, xr, n, alpha), xr, gv.permute(0, 3, 1, 2))

            def library(key):
                y, xr, gn = graphs[key]
                return torch.autograd.grad(y, xr, gn, retain_graph=True)

            row["library_max_abs_err"] = (
                library("f32")[0] - want).abs().max().item()
            # the median of three readings: a single reading has come out
            # at six times the others on the same card
            row["ms_runs"] = [device_ms(torch, lambda: lrn_ops.lrn_bwd(x, g, *hyper))
                              for _ in range(3)]
            row["ms"] = sorted(row["ms_runs"])[1]
            row["events_ms"] = cuda_time_ms(lambda: lrn_ops.lrn_bwd(x, g, *hyper))
            row["plain_ms"] = device_ms(
                torch, lambda: lrn_ops.lrn_bwd_reference(x, g, *hyper))
            row["library_ms"] = device_ms(torch, lambda: library("f32"))
            row["bound_ms"], row["bound_by"] = lrn_bwd_bound_ms(x.numel(), n)
            row["bf16_ms"] = sorted(device_ms(torch, lambda: lrn_ops.lrn_bwd(xb, gb, *hyper))
                                    for _ in range(3))[1]
            row["bf16_library_ms"] = device_ms(torch, lambda: library("bf16"))
            row["bf16_bound_ms"], _ = lrn_bwd_bound_ms(x.numel(), n, elem=2)
            del graphs
        rows.append(row)
        log(f"lrn_bwd {label}: {json.dumps(row)}  [{card}]")
        del x, g, xb, gb, got, got16, want
    # launches: filled from the training run
    return kernel_entry("lrn_bwd", "deeplearning4j_tpu/ops/pallas_kernels.py:141", rows)


@contextmanager
def patched(obj, name, value):
    """Bind `obj.name` to `value` for the duration of the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextmanager
def checked_lrn(torch, stats):
    """Run every LRN of the network through the kernel and, on the same
    activations, through the plain version, holding one to the other at
    LRN_RTOL/LRN_ATOL (a bfloat16 call: within one bfloat16 ulp of the
    float32 plain version rounded once, `bf16_ulp_check`, its largest error
    as a share of that limit recorded). Records whether the layer's input already was a
    contiguous NHWC tensor (its `.contiguous()` then copies nothing), the
    largest error, and the largest effect of the window term (the distance
    from x * k^-beta, what LRN would give with the window dropped)."""
    from deeplearning4j_torch.nn.layers.convolution import LocalResponseNormalization
    from deeplearning4j_torch.ops import lrn as lrn_ops
    kernel, layer_forward = lrn_ops.lrn, LocalResponseNormalization.forward

    def lrn(x, k, alpha, beta, n):
        got = kernel(x, k, alpha, beta, n)
        with torch.no_grad():  # a training step's forward: check off the graph
            got_c, x_c = got.detach(), x.detach()
            if x.dtype == torch.bfloat16:
                want = lrn_ops.lrn_reference(x_c.float(), k, alpha, beta, n)
                err, share = bf16_ulp_check(torch, "lrn in the forward", got_c, want,
                                            LRN_ATOL)
                stats["limit_share"] = max(stats.get("limit_share", 0.0), share)
            else:
                want = lrn_ops.lrn_reference(x_c, k, alpha, beta, n)
                torch.testing.assert_close(got_c, want, rtol=LRN_RTOL, atol=LRN_ATOL)
                err = (got_c - want).abs().max().item()
            stats["calls"] += 1
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
            stats["window_effect"] = max(stats["window_effect"], (
                want - x_c * k ** -beta).abs().max().item())
        return got

    def forward(self, params, x, **kw):
        stats["input_contiguous"].append(x.is_contiguous())
        return layer_forward(self, params, x, **kw)

    with patched(lrn_ops, "lrn", lrn), \
            patched(LocalResponseNormalization, "forward", forward):
        yield


def serving_requests(rng, clients=4, per_client=8, shape=(224, 224, 3)):
    """The serving phases' client load: per client, `per_client` requests of
    1-8 random images of `shape` (224x224x3 unless a model takes another
    size)."""
    return [[rng.standard_normal((int(rng.integers(1, 9)),) + tuple(shape)
                                 ).astype(np.float32)
             for _ in range(per_client)] for _ in range(clients)]


def run_clients(pi, reqs):
    """One thread per client list, each sending its requests in turn to
    `pi`: ({(client, j): answer}, latencies in s, wall s). Raises if a client
    failed or did not finish."""
    answers, lat, errors = {}, [], []
    lat_lock = threading.Lock()

    def client(c):
        try:
            for j, x in enumerate(reqs[c]):
                t = time.perf_counter()
                answers[(c, j)] = pi.output(x)
                with lat_lock:
                    lat.append(time.perf_counter() - t)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serving clients failed: {errors!r}")
    return answers, lat, wall


def latency_stats(lat, images, wall):
    lat_ms = np.asarray(lat) * 1e3
    return {"requests": len(lat), "images": images, "wall_s": wall,
            "images_per_s": images / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99))}


def phase_serving(torch, card):
    from deeplearning4j_torch.models.zoo import AlexNet
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.ops import lrn as lrn_ops
    from deeplearning4j_torch.parallel.inference import (InferenceMode,
                                                          ParallelInference)
    t0 = time.perf_counter()
    net = AlexNet().init(device="cuda")
    log(f"serving: AlexNet 224x224x3/1000, {net.num_params()} params, "
        f"init {time.perf_counter() - t0:.2f} s")
    pi = ParallelInference(net, inference_mode=InferenceMode.BATCHED,
                           batch_limit=32)
    t0 = time.perf_counter()
    pi.warmup()
    log(f"serving: warmup of buckets {pi.warmed_buckets} in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(2026)
    reqs = serving_requests(rng)
    forwards0 = pi.total_forwards
    try:
        lrn_ops.launches = lrn_ops.bwd_launches = 0  # the serving run starts here
        answers, lat, wall = run_clients(pi, reqs)
        launches = {"lrn_fwd": lrn_ops.launches,
                    "lrn_bwd": lrn_ops.bwd_launches}  # ... and ends here
        forwards = pi.total_forwards - forwards0
    finally:
        pi.shutdown()
    if forwards < 1 or launches != {"lrn_fwd": 2 * forwards, "lrn_bwd": 0}:
        raise RuntimeError(f"lrn launches {launches}: expected 2 x {forwards} "
                           f"executed forwards of K1 and no K2")
    images = sum(x.shape[0] for xs in reqs for x in xs)
    log(f"serving: {forwards} forwards, batch sizes "
        f"{list(pi.executed_batch_sizes)[-forwards:]}, lrn launches "
        f"{launches['lrn_fwd']}")

    # correctness: every answer against direct output (its LRNs checked
    # against the plain version on the served activations) and against the
    # whole forward with LRN bound to the plain version
    max_direct = max_plain = 0.0
    lrn_stats = {"calls": 0, "max_abs_err": 0.0, "window_effect": 0.0,
                 "input_contiguous": []}
    for (c, j), out in answers.items():
        x = reqs[c][j]
        if out.shape != (x.shape[0], 1000) or not np.isfinite(out).all():
            raise RuntimeError(f"bad answer shape/values {out.shape}")
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
        with checked_lrn(torch, lrn_stats):
            direct = net.output(x)
        with patched(lrn_ops, "lrn", lrn_ops.lrn_reference):
            plain = net.output(x)
        np.testing.assert_allclose(out, direct, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        np.testing.assert_allclose(out, plain, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        if not (np.array_equal(out.argmax(-1), direct.argmax(-1))
                and np.array_equal(out.argmax(-1), plain.argmax(-1))):
            raise RuntimeError(f"top-1 disagrees on request {(c, j)}")
        max_direct = max(max_direct, float(np.abs(out - direct).max()))
        max_plain = max(max_plain, float(np.abs(out - plain).max()))
    if lrn_stats["calls"] != 2 * len(answers):
        raise RuntimeError(f"checked {lrn_stats['calls']} LRN calls, expected "
                           f"2 x {len(answers)} forwards")
    # The check above is only as sharp as the window term is large: hold the
    # error to a hundredth of it, so a kernel that dropped the window fails.
    if not lrn_stats["max_abs_err"] < 0.01 * lrn_stats["window_effect"]:
        raise RuntimeError(f"LRN error {lrn_stats['max_abs_err']} is not under "
                           f"1% of the window's effect {lrn_stats['window_effect']}")
    lrn_stats["input_contiguous"] = all(lrn_stats["input_contiguous"])
    log(f"serving: LRN on the served activations: {json.dumps(lrn_stats)} "
        f"(rtol {LRN_RTOL}, atol {LRN_ATOL})")
    # the CPU path, which tests/test_torch_mln.py holds to the JAX package
    cpu_net = MultiLayerNetwork(net.conf)
    cpu_net.init(device="cpu")
    cpu_net.params_tree = tuple({k: v.cpu() for k, v in layer.items()}
                                for layer in net.params_tree)
    x0 = reqs[0][0]
    cpu_out = cpu_net.output(x0)
    np.testing.assert_allclose(answers[(0, 0)], cpu_out, rtol=SERVE_RTOL,
                               atol=SERVE_ATOL)
    max_cpu = float(np.abs(answers[(0, 0)] - cpu_out).max())
    result = {
        **latency_stats(lat, images, wall), "forwards": forwards,
        "max_abs_err_vs_direct": max_direct,
        "max_abs_err_vs_plain_lrn": max_plain,
        "max_abs_err_vs_cpu": max_cpu,
        "lrn_in_forward": lrn_stats,
        "launches": launches, "card": card,
    }
    x32 = rng.standard_normal((32, 224, 224, 3)).astype(np.float32)
    result["profile"] = profile_call(
        torch, "forward", lambda: net.output(x32), {"batch": 32})
    log(f"serving: p50 {result['p50_ms']:.3f} ms p99 {result['p99_ms']:.3f} ms, "
        f"{result['images_per_s']:.1f} images/s  [{card}]")
    log(f"serving: max abs err vs direct {max_direct:.3e}, vs plain LRN "
        f"{max_plain:.3e}, vs CPU {max_cpu:.3e} (rtol {SERVE_RTOL}, atol {SERVE_ATOL})")
    return result, net, reqs, answers, cpu_net


#: Device-time groups of a profile, by kernel name, first match wins:
#: cuDNN's and cuBLAS's convolutions and products, reductions (BN's
#: statistics, the loss, the pools' and the updaters' sums), max and
#: average pools, and the element-wise rest (BN's normalization, ReLU, the
#: shortcut adds, the updates).
PROFILE_GROUPS = (
    ("h2d", ("HtoD",)),
    ("conv_and_gemm", ("conv", "xmma", "gemm", "cudnn", "cutlass", "wgrad",
                       "dgrad", "sm90_", "sm80_")),
    ("reduce", ("reduce",)),
    ("pool", ("pool",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile_groups(events):
    """{group: device ms} of the CUDA items of a profile (PROFILE_GROUPS,
    the rest under "other")."""
    out = {}
    for e in events:
        key = next((g for g, subs in PROFILE_GROUPS
                    if any(t in e.key for t in subs)), "other")
        out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3
    return out


def profile_call(torch, label, fn, info, count=None):
    """One warm call of `fn` (which ends synchronized) under torch.profiler:
    the device's summed kernel and copy time against the wall time of that
    same call, the host-to-device copies' time and share of it, the five
    largest device items, the device time by kernel group
    (`profile_groups`), and the LRN kernels' (K1, K2) time and calls,
    which the five rarely include; with `count`, the calls and device ms of
    the device kernels whose names hold it (`counted_calls`, `counted_ms`). The median wall time of 5
    unprofiled calls is reported beside it; the idle share is taken within
    the profiled call only, as busy and wall time from two different calls
    can give a share below 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    h2d_ms = sum(e.self_device_time_total for e in dev if "HtoD" in e.key) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    out = {**info, "wall_ms": wall_ms,
           "unprofiled_wall_ms": float(np.median(walls)),
           "device_busy_ms": busy_ms if dev else None,
           "device_idle_share": (1.0 - busy_ms / wall_ms) if dev else None,
           "h2d_ms": h2d_ms if dev else None,
           "h2d_share_of_busy": h2d_ms / busy_ms if dev and busy_ms else None,
           "top": [[e.key[:80], e.count, e.self_device_time_total / 1e3]
                   for e in top],
           "groups_ms": profile_groups(dev),
           "lrn_kernels": [[e.key[:40], e.count, e.self_device_time_total / 1e3]
                           for e in dev if "lrn_" in e.key]}
    if count is not None:
        out["counted_calls"] = sum(e.count for e in dev if count in e.key)
        out["counted_ms"] = sum(e.self_device_time_total for e in dev if count in e.key) / 1e3
    log(f"profile {label}: {json.dumps(out)}")
    return out


@contextmanager
def checked_lrn_bwd(torch, stats):
    """Run every LRN backward through K2 and, on the same x and cotangent,
    through the plain version, holding one to the other (rtol LRN_RTOL,
    atol LRN_ATOL times the largest |dx|: cotangents at random init are
    tiny; a bfloat16 call within one bfloat16 ulp of the float32 plain
    version rounded once, beyond that slack, its largest error as a share
    of that limit recorded). Records whether each cotangent reached the backward contiguous
    (if not, `lrn_bwd` copies it), the largest error and the largest
    cross-channel term."""
    from deeplearning4j_torch.ops import lrn as lrn_ops
    kernel = lrn_ops.lrn_bwd

    def lrn_bwd(x, g, k, alpha, beta, n):
        stats["cotangent_contiguous"].append(g.is_contiguous())
        got = kernel(x, g, k, alpha, beta, n)
        if x.dtype == torch.bfloat16:
            x, g = x.float(), g.float()
        want = lrn_ops.lrn_bwd_reference(x, g, k, alpha, beta, n)
        scale = want.abs().max().item()
        if got.dtype == torch.bfloat16:
            err, share = bf16_ulp_check(torch, "lrn backward in the step", got, want,
                                        LRN_ATOL * scale)
            stats["limit_share"] = max(stats.get("limit_share", 0.0), share)
        else:
            torch.testing.assert_close(got, want, rtol=LRN_RTOL,
                                       atol=LRN_ATOL * scale)
            err = (got - want).abs().max().item()
        stats["calls"] += 1
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        stats["max_abs_dx"] = max(stats["max_abs_dx"], scale)
        stats["max_cross_term"] = max(
            stats["max_cross_term"],
            lrn_cross_term(x, g, k, alpha, beta, n).abs().max().item())
        return got

    with patched(lrn_ops, "lrn_bwd", lrn_bwd):
        yield


def _layer_rel_errs(param_utils, got, want):
    """Per layer (index, or node name in a graph) and parameter:
    |got - want| / |want| (Frobenius norms)."""
    got, want = param_utils.params_to_numpy(got), param_utils.params_to_numpy(want)
    layers = want.items() if isinstance(want, dict) else enumerate(want)
    return {f"{i}.{k}": float(np.linalg.norm(got[i][k] - wl[k])
                              / max(np.linalg.norm(wl[k]), 1e-30))
            for i, wl in layers for k in wl}


def net_layers(net):
    """A network's layers: a MultiLayerNetwork's list, or a graph's layer
    nodes' layers in topological order."""
    if hasattr(net, "layers"):
        return net.layers
    return [net.conf.nodes[n].layer for n in net.conf.topo_order
            if net.conf.nodes[n].is_layer()]


#: Activations with a kink that `pinned_kinks` does not pin.
UNPINNED_KINKS = {"relu6", "leakyrelu", "rrelu", "selu", "hardtanh",
                  "hardsigmoid", "rectifiedtanh"}


@contextmanager
def pinned_kinks(torch, net, record, flips=None):
    """The kink rule of the gradient checks: every layer whose activation is
    ReLU and every max pool. Float32 runs whose activations differ by
    rounding (another device, another LRN or attention) can land on either
    side of a near-tie, at a ReLU's zero or between two elements of a pool
    window; the gradient then moves one cotangent to another place (at
    batch 2 about 1e-2 of conv1's weight gradient, where rounding gives
    1e-6). So with `flips` None, record each ReLU's decisions (z > 0) and
    each max pool's choice of element (its window's first maximum, the one
    its backward takes) into `record` and run them as they are; otherwise
    run each ReLU as z * mask and each max pool as a gather at the recorded
    elements, in call order, so the second run takes the first's branch of
    the piecewise-linear network whatever its rounding, and count in `flips`
    the decisions its own values would have taken otherwise. The recorded
    pool choice comes from F.max_pool2d, not from the network's pool, so a
    wrong pool still shows. Raises ValueError on a layer whose activation
    has a kink it cannot pin."""
    import torch.nn.functional as F
    from deeplearning4j_torch.ops import pooling as pool_ops
    max_pool = pool_ops.max_pool
    it = iter(record)

    def act(z):
        if flips is None:
            record.append((z > 0).detach())
            return F.relu(z)
        m = next(it).to(z.device)
        flips.append(int(((z > 0) != m).sum()))
        return z * m.to(z.dtype)

    def pool(x, window, strides, pads, **kw):
        xp = pool_ops._nchw_padded(x, pads, float("-inf"))
        with torch.no_grad():
            _, own = F.max_pool2d(xp, tuple(window), tuple(strides), return_indices=True)
        if flips is None:
            record.append(own)
            return max_pool(x, window, strides, pads, **kw)
        idx = next(it).to(x.device)
        flips.append(int((own != idx).sum()))
        y = torch.gather(xp.reshape(xp.shape[0], xp.shape[1], -1), 2,
                         idx.reshape(idx.shape[0], idx.shape[1], -1))
        return y.reshape(idx.shape).permute(0, 2, 3, 1)

    with ExitStack() as stack:
        stack.enter_context(patched(pool_ops, "max_pool", pool))
        for layer in net_layers(net):
            name = layer.activation
            if callable(name) or (name or "").lower() in UNPINNED_KINKS:
                raise ValueError(f"pinned_kinks cannot pin the kinks of {name!r}")
            if (name or "").lower() == "relu":
                stack.enter_context(patched(layer, "_act", lambda: act))
        yield


#: A parameter whose reference gradient is below this share of its layer's
#: (Frobenius norms) is left out of `compare_pinned_grads`, and logged: a key
#: bias's exact gradient is 0 (a shift common to every key leaves the softmax
#: as it is), so its computed value is rounding, 1e-10 to 1e-11 of the
#: layer's, and its relative difference is noise (0.19 and 0.89 in a run
#: whose weights agreed to 1e-6). The smallest gradients the kernels feed,
#: Wq's and Wk's, are small too at initialization, where the attention is
#: nearly uniform: in the second layer 4e-5 of the layer's at t 16, 5e-6 at
#: t 2048, falling as 1/sqrt(t).
NEGLIGIBLE_GRAD = 1e-8


def negligible_grads(param_utils, grads):
    """{"layer.param": share of the layer's gradient norm} for every
    parameter whose gradient is below NEGLIGIBLE_GRAD of its layer's."""
    out = {}
    tree = param_utils.params_to_numpy(grads)
    for i, lg in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        norms = {k: float(np.linalg.norm(g)) for k, g in lg.items()}
        layer = float(np.sqrt(sum(n * n for n in norms.values())))
        out.update({f"{i}.{k}": n / layer for k, n in norms.items()
                    if n < NEGLIGIBLE_GRAD * layer})
    return out


#: A gradient that is 0 by the network's structure (`zero_by_structure`) must
#: stay below this share of its layer's gradient (Frobenius norms) in both
#: runs: what is left is rounding.
STRUCTURAL_ZERO_SHARE = 1e-4


def zero_by_structure(net):
    """{"node.b"} of a graph's layer nodes whose every consumer is a
    BatchNormalization: under batch statistics a per-channel shift of the
    BN's input changes nothing, so the bias's gradient is 0 but for
    rounding, which pinned and unpinned runs round apart."""
    from deeplearning4j_torch.nn.layers.convolution import BatchNormalization
    conf = getattr(net, "conf", None)
    if not hasattr(conf, "nodes"):
        return set()
    consumers = {}
    for name, node in conf.nodes.items():
        for i in node.inputs:
            consumers.setdefault(i, []).append(node)
    return {f"{name}.b" for name, node in conf.nodes.items()
            if node.is_layer() and name in net.params_tree
            and "b" in net.params_tree[name] and consumers.get(name)
            and all(c.is_layer() and isinstance(c.layer, BatchNormalization)
                    for c in consumers[name])}


def _structural_zero_shares(param_utils, grads, names):
    tree = param_utils.params_to_numpy(grads)
    out = {}
    for name in names:
        node, k = name.rsplit(".", 1)
        layer = float(np.sqrt(sum(float(np.linalg.norm(g)) ** 2
                                  for g in tree[node].values())))
        out[name] = float(np.linalg.norm(tree[node][k])) / max(layer, 1e-30)
    return out


def compare_pinned_grads(label, torch, param_utils, run_got, run_want, ds,
                         structural_zeros=(), limit_factors=None):
    """Gradients of two runs of the same function on `ds`, the second with
    the first's kink decisions pinned (`pinned_kinks`): the decisions the
    second run would have taken otherwise under MAX_PINNED_SHARE of them,
    the scores under SCORE_RTOL, and every parameter's gradient under
    GRAD_REL relative norm, but those `negligible_grads` leaves out
    (logged) and the `structural_zeros` (`zero_by_structure`), which are
    held under STRUCTURAL_ZERO_SHARE of their layer's in both runs instead.
    Each parameter on its own, so that a fault in one cotangent
    (dq feeds Wq and bq, dk Wk, dv Wv) is not diluted by the larger
    gradients of the others. `limit_factors` ({layer or node: factor >= 1},
    `bn_grad_factors`) multiplies GRAD_REL for that layer's parameters."""
    record, flips = [], []
    g_got, s_got = run_got(ds, record, None)
    g_want, s_want = run_want(ds, record, flips)
    flipped, entries = sum(flips), sum(int(m.numel()) for m in record)
    if not flipped <= MAX_PINNED_SHARE * entries:
        raise RuntimeError(f"{label}: {flipped} of {entries} kink decisions flipped "
                           f"(> {MAX_PINNED_SHARE} of them) before they were pinned")
    if not abs(s_got - s_want) <= SCORE_RTOL * abs(s_want):
        raise RuntimeError(f"{label}: score {s_got} vs {s_want}")
    rel = _layer_rel_errs(param_utils, g_got, g_want)
    zero_shares = max([0.0] + [v for g in (g_got, g_want) for v in
                               _structural_zero_shares(param_utils, g,
                                                       structural_zeros).values()])
    if not zero_shares < STRUCTURAL_ZERO_SHARE:
        raise RuntimeError(f"{label}: a gradient that is 0 by structure is "
                           f"{zero_shares} of its layer's (>= {STRUCTURAL_ZERO_SHARE})")
    for name in structural_zeros:
        rel.pop(name)
    left_out = negligible_grads(param_utils, g_want)
    factor = lambda n: (limit_factors or {}).get(n.rsplit(".", 1)[0], 1.0)
    worst_at = max((n for n in rel if n not in left_out),
                   key=lambda n: rel[n] / factor(n))
    worst = rel[worst_at]
    if not worst < GRAD_REL * factor(worst_at):
        raise RuntimeError(f"{label}: gradient of {worst_at} differs by {worst} "
                           f"(> {GRAD_REL} x {factor(worst_at)}) with the kink "
                           f"decisions pinned, per parameter: {rel}, left out: "
                           f"{left_out}")
    out = {"worst_rel": worst, "worst_at": worst_at, "limit_factor": factor(worst_at),
           "worst_rel_unscaled": max(rel[n] for n in rel if n not in left_out),
           "per_parameter": rel,
           "left_out_share_of_layer": left_out,
           "zero_by_structure": len(structural_zeros),
           "zero_by_structure_max_share": zero_shares,
           "kink_flips_pinned": flipped, "kink_entries": entries,
           "score_got": s_got, "score_want": s_want}
    log(f"{label}: {json.dumps(out)} (limits {GRAD_REL}, {MAX_PINNED_SHARE} "
        f"of the decisions)")
    return out


class Steps:
    """Listener: each step's score, and its end time after a sync."""

    def __init__(self):
        self.scores, self.ends = [], []

    def iteration_done(self, model, iteration):
        import torch
        torch.cuda.synchronize()
        self.ends.append(time.perf_counter())
        self.scores.append(float(model.score_value))


def phase_training(torch, card):
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.models.zoo import AlexNet
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.ops import lrn as lrn_ops
    from deeplearning4j_torch.utils import params as param_utils
    t0 = time.perf_counter()
    net = AlexNet().init(device="cuda")
    log(f"training: AlexNet 224x224x3/1000, {net.num_params()} params, "
        f"init {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(2027)
    n = TRAIN_STEPS * TRAIN_BATCH
    x = rng.standard_normal((n, 224, 224, 3), dtype=np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, n)]

    # 1. the main path, every K2 call checked on its real cotangents
    steps = Steps()
    net.listeners.append(steps)
    stats = {"calls": 0, "max_abs_err": 0.0, "max_abs_dx": 0.0,
             "max_cross_term": 0.0, "cotangent_contiguous": []}
    with checked_lrn_bwd(torch, stats):
        lrn_ops.launches = lrn_ops.bwd_launches = 0  # the main path's run starts here
        net.fit(x, y, epochs=1, batch_size=TRAIN_BATCH)
        launches = {"lrn_fwd": lrn_ops.launches,
                    "lrn_bwd": lrn_ops.bwd_launches}  # ... and ends here
    want = 2 * TRAIN_STEPS
    if net.iteration != TRAIN_STEPS or launches != {"lrn_fwd": want,
                                                   "lrn_bwd": want}:
        raise RuntimeError(f"{net.iteration} steps, launches {launches}: "
                           f"expected {want} of each kernel")
    if not all(np.isfinite(steps.scores)) or len(steps.scores) != TRAIN_STEPS:
        raise RuntimeError(f"scores {steps.scores}")
    if stats["calls"] != want:
        raise RuntimeError(f"checked {stats['calls']} LRN backwards, expected {want}")
    stats["cotangent_contiguous"] = all(stats["cotangent_contiguous"])
    # the check is only as sharp as the cross term is large next to the error
    stats["cross_share_met"] = stats["max_abs_err"] < CROSS_SHARE * stats["max_cross_term"]
    log(f"training: scores {steps.scores}")
    log(f"training: launches {launches} over {TRAIN_STEPS} steps; K2 on the "
        f"training cotangents: {json.dumps(stats)} (rtol {LRN_RTOL}, atol "
        f"{LRN_ATOL} x max|dx|)")
    if not stats["cross_share_met"]:
        log(f"training: NOTE the in-step K2 error is not under {CROSS_SHARE} of "
            f"the cross term on these activations; phase 3 holds K2 to that "
            f"share on inputs where the term is large")

    # 2. timing: another epoch over the same batches, unchecked
    steps = Steps()
    net.listeners[:] = [steps]
    lrn_ops.launches = lrn_ops.bwd_launches = 0
    t0 = time.perf_counter()
    net.fit(x, y, epochs=1, batch_size=TRAIN_BATCH)
    timed_launches = {"lrn_fwd": lrn_ops.launches, "lrn_bwd": lrn_ops.bwd_launches}
    if timed_launches != {"lrn_fwd": want, "lrn_bwd": want}:
        raise RuntimeError(f"timed run launches {timed_launches}")
    if not all(np.isfinite(steps.scores)):
        raise RuntimeError(f"scores {steps.scores}")
    step_ms = np.diff([t0] + steps.ends) * 1e3
    warm_ms = float(np.median(step_ms[1:]))
    net.listeners.clear()
    log(f"training: step ms {step_ms.tolist()}, median warm {warm_ms:.3f} ms, "
        f"{TRAIN_BATCH / warm_ms * 1e3:.1f} images/s  [{card}]")

    # 3. gradients: K1+K2 against plain LRN on the card; the card against the
    # CPU; the second run of each pinned to the first's kink decisions
    def run(model, plain_lrn=False):
        def grads(ds, record, flips):
            before = (lrn_ops.launches, lrn_ops.bwd_launches)
            with ExitStack() as stack:
                stack.enter_context(pinned_kinks(torch, model, record, flips))
                if plain_lrn:
                    stack.enter_context(
                        patched(lrn_ops, "lrn", lrn_ops.lrn_reference))
                out = model.compute_gradient_and_score(ds)
            ran = (lrn_ops.launches - before[0], lrn_ops.bwd_launches - before[1])
            if model.device.type == "cuda" and not plain_lrn and ran != (2, 2):
                raise RuntimeError(f"compute_gradient_and_score ran K1 and K2 {ran} times")
            return out
        return grads

    cpu_net = MultiLayerNetwork(net.conf).init(device="cpu")
    cpu_net.params_tree = tuple({k: v.cpu() for k, v in layer.items()}
                                for layer in net.params_tree)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        vs_plain = compare_pinned_grads(f"K1+K2 vs plain LRN, batch {TRAIN_BATCH}",
                                        torch, param_utils, run(net),
                                        run(net, plain_lrn=True),
                                        DataSet(x[:TRAIN_BATCH], y[:TRAIN_BATCH]))
        vs_cpu = compare_pinned_grads("card vs CPU path, batch 2", torch, param_utils,
                                      run(net), run(cpu_net), DataSet(x[:2], y[:2]))
    finally:
        torch.backends.cudnn.deterministic = det

    # 4. one warm step under the profiler
    xb, yb = x[:TRAIN_BATCH], y[:TRAIN_BATCH]

    def one_step():
        net.fit(xb, yb, batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()

    profile = profile_call(torch, "train step", one_step, {"batch": TRAIN_BATCH})
    return {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "launches": launches,
            "scores": steps.scores, "step_ms": step_ms.tolist(),
            "median_warm_step_ms": warm_ms,
            "images_per_s": TRAIN_BATCH / warm_ms * 1e3,
            "lrn_bwd_in_step": stats,
            "grad_rel_vs_plain_lrn": vs_plain, "grad_rel_vs_cpu": vs_cpu,
            "profile": profile, "card": card}


# ------------------------------------------- the fit loop on AlexNet (K1, K2)

FIT_GROUP = 3        # steps_per_dispatch of the grouped run, and the repeats
FIT_PROFILE_BATCHES = 3   # batches of each profiled fit call
FIT_ES_MAX_EPOCHS = 2     # early stopping: epochs of FIT_ES_BATCHES batches
FIT_ES_BATCHES = 2


class _Deterministic:
    """cuDNN's deterministic algorithms and no autotuning inside the block,
    so that two runs of the same steps are bitwise equal."""

    def __init__(self, torch):
        self.cudnn = torch.backends.cudnn

    def __enter__(self):
        self.saved = self.cudnn.deterministic, self.cudnn.benchmark
        self.cudnn.deterministic, self.cudnn.benchmark = True, False

    def __exit__(self, *exc):
        self.cudnn.deterministic, self.cudnn.benchmark = self.saved
        return False


def _require_same(label, a, b):
    """`a` and `b` trained alike: parameters, optimizer state and counters
    bitwise equal."""
    same = {"params": _same_tree(a.params_tree, b.params_tree),
            "opt_state": _same_tree(a.opt_state, b.opt_state),
            "iteration": a.iteration == b.iteration}
    if not all(same.values()):
        raise RuntimeError(f"{label}: not bitwise equal: {same}")
    return same


def timed_fit_ms(torch, net, *args, **kw):
    """Wall ms of one `fit` call from a synced device to a synced device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(*args, **kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_fit_loop_alexnet(torch, card, device=None):
    """(a) The whole `fit` loop on zoo AlexNet at full width (float32, batch
    TRAIN_BATCH, TRAIN_STEPS steps, dropout on), cuDNN deterministic: `fit`
    with device prefetch (the default: pinned staging on a side stream) is
    the main path, its K1 and K2 counts reset just before and read just
    after (2 a step each, no other kernel); against it, bitwise after the
    same steps: `fit` without prefetch (pageable copies in the step) and
    with steps_per_dispatch=FIT_GROUP; `fit_batch_repeated` against a loop
    of single `fit` calls on one batch; an EarlyStoppingTrainer run
    (ScoreImprovement and MaxEpochs, the held-out score, `Evaluation` of the
    best model, a LocalFileModelSaver under build/) whose restored best
    model answers bitwise as the network did when it was saved. Then, with
    cuDNN's default algorithms, each way: a warm epoch timed from sync to
    sync, each step's median with a sync after it, and one profiled `fit`
    of FIT_PROFILE_BATCHES batches (H2D share of busy time)."""
    import shutil
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.earlystopping import (
        EarlyStoppingConfiguration, EarlyStoppingTrainer, LocalFileModelSaver,
        MaxEpochsTerminationCondition, ScoreImprovementEpochTerminationCondition)
    from deeplearning4j_torch.models.zoo import AlexNet
    make = lambda: AlexNet().init(device=device)
    net = make()
    shape = tuple(net._feature_struct(TRAIN_BATCH).shape[1:])
    classes = net.layers[-1].n_out
    rng = np.random.default_rng(2031)
    n = TRAIN_STEPS * TRAIN_BATCH
    x = rng.standard_normal((n,) + shape, dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    result = {"card": card, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS}
    with _Deterministic(torch):
        # 1. the main path: fit with device prefetch
        torch.cuda.synchronize()
        zero_launches()   # the main path's run starts here
        net.fit(x, y, batch_size=TRAIN_BATCH)
        launches = all_launches()   # ... and ends here
        want = dict.fromkeys(launches, 0)
        want.update(lrn_fwd=2 * TRAIN_STEPS, lrn_bwd=2 * TRAIN_STEPS)
        if launches != want or net.iteration != TRAIN_STEPS:
            raise RuntimeError(f"fit loop: {net.iteration} steps, launches "
                               f"{launches}, expected {want}")
        if not np.isfinite(float(net.score_value)):
            raise RuntimeError(f"fit loop: score {float(net.score_value)}")
        result["launches"] = launches
        result["etl"] = {"last_etl_ms": net.last_etl_ms,
                         "last_etl_host_ms": net.last_etl_host_ms,
                         "last_etl_h2d_ms": net.last_etl_h2d_ms}
        if not net.last_etl_h2d_ms > 0:
            raise RuntimeError("fit loop: the prefetched batch carries no h2d time")
        # 2. the same steps without prefetch, and grouped
        pageable, grouped = make(), make()
        pageable.fit(x, y, batch_size=TRAIN_BATCH, prefetch_to_device=False)
        grouped.fit(x, y, batch_size=TRAIN_BATCH, steps_per_dispatch=FIT_GROUP)
        result["prefetch_vs_pageable"] = _require_same(
            "prefetch vs no prefetch", net, pageable)
        result["grouped_vs_single"] = _require_same(
            f"steps_per_dispatch={FIT_GROUP} vs single steps", grouped, net)
        del grouped
        # 3. fit_batch_repeated against a loop on one batch (no mask, as the
        # repeats take the batch as it is)
        repeated, looped = make(), make()
        one = DataSet(x[:TRAIN_BATCH], y[:TRAIN_BATCH])
        repeated.fit_batch_repeated(one, FIT_GROUP)
        for _ in range(FIT_GROUP):
            looped.fit(one, batch_size=TRAIN_BATCH, pad_to_bucket=False)
        result["repeated_vs_loop"] = _require_same(
            "fit_batch_repeated vs a loop", repeated, looped)
        del repeated, looped
        log(f"fit loop: bitwise {json.dumps({k: result[k] for k in ('prefetch_vs_pageable', 'grouped_vs_single', 'repeated_vs_loop')})}")

        # 4. early stopping on a held-out split, the best model on disk
        es_dir = os.path.join(ROOT, "build", "fit_loop_early_stopping")
        shutil.rmtree(es_dir, ignore_errors=True)
        train_n = FIT_ES_BATCHES * TRAIN_BATCH
        xh, yh = x[train_n:train_n + TRAIN_BATCH], y[train_n:train_n + TRAIN_BATCH]
        saver = LocalFileModelSaver(es_dir)
        saved = {}
        save_best = saver.save_best_model

        def remember(model, score):
            t0 = time.perf_counter()
            save_best(model, score)
            saved.update(answer=model.output(xh[:32]), epoch=model.epoch,
                         save_s=time.perf_counter() - t0)

        saver.save_best_model = remember
        conf = (EarlyStoppingConfiguration.builder()
                .epoch_termination_conditions(
                    ScoreImprovementEpochTerminationCondition(1),
                    MaxEpochsTerminationCondition(FIT_ES_MAX_EPOCHS))
                .score_calculator(lambda m: m.score(DataSet(xh, yh)))
                .model_saver(saver).build())
        es_net = make()
        t0 = time.perf_counter()
        es = EarlyStoppingTrainer(conf, es_net, x[:train_n], y[:train_n],
                                  batch_size=TRAIN_BATCH).fit()
        es_s = time.perf_counter() - t0
        best = es.best_model
        if best is es_net or best.epoch != saved["epoch"]:
            raise RuntimeError(f"early stopping: best model of epoch {best.epoch}, "
                               f"saved at {saved.get('epoch')}")
        if not np.array_equal(best.output(xh[:32]), saved["answer"]):
            raise RuntimeError("early stopping: the restored best model answers "
                               "otherwise than when it was saved")
        ev = best.evaluate(xh, yh, batch_size=TRAIN_BATCH)
        if ev.num_examples() != len(xh):
            raise RuntimeError(f"early stopping: evaluated {ev.num_examples()} images")
        result["early_stopping"] = {
            "termination": es.termination_reason.value,
            "details": es.termination_details, "total_epochs": es.total_epochs,
            "best_epoch": es.best_model_epoch,
            "score_vs_epoch": es.score_vs_epoch, "best_answers_bitwise": True,
            "held_out_accuracy": ev.accuracy(), "seconds": es_s,
            "best_save_s": saved["save_s"], "device": str(best.device)}
        log(f"fit loop early stopping: {json.dumps(result['early_stopping'])}")
        shutil.rmtree(es_dir, ignore_errors=True)
    # 5. timing, with cuDNN's default algorithms as users run it: a warm
    # epoch each way (wall from sync to sync, the producer's start and first
    # batch included; and each step's median, synced by a listener), then
    # one profiled fit each way
    timing = {}
    for name, model, flag in (("prefetch", net, True), ("pageable", pageable, False)):
        model.fit(x, y, batch_size=TRAIN_BATCH, prefetch_to_device=flag)  # warm
        ms = timed_fit_ms(torch, model, x, y, batch_size=TRAIN_BATCH,
                          prefetch_to_device=flag)
        steps = Steps()
        model.listeners[:] = [steps]
        t0 = time.perf_counter()
        model.fit(x, y, batch_size=TRAIN_BATCH, prefetch_to_device=flag)
        model.listeners.clear()
        step_ms = np.diff([t0] + steps.ends) * 1e3
        xs = x[:FIT_PROFILE_BATCHES * TRAIN_BATCH]
        ys = y[:FIT_PROFILE_BATCHES * TRAIN_BATCH]

        def fit_call(model=model, flag=flag):
            model.fit(xs, ys, batch_size=TRAIN_BATCH, prefetch_to_device=flag)
            torch.cuda.synchronize()

        prof = profile_call(torch, f"fit of {FIT_PROFILE_BATCHES} batches, {name}",
                            fit_call, {"batch": TRAIN_BATCH,
                                       "batches": FIT_PROFILE_BATCHES})
        timing[name] = {"epoch_ms_per_step": ms / TRAIN_STEPS,
                        "images_per_s": TRAIN_STEPS * TRAIN_BATCH / ms * 1e3,
                        "synced_step_ms": step_ms.tolist(),
                        "median_synced_step_ms": float(np.median(step_ms[1:])),
                        "h2d_share_of_busy": prof.get("h2d_share_of_busy"),
                        "h2d_ms": prof.get("h2d_ms"),
                        "device_idle_share": prof.get("device_idle_share"),
                        "etl": {"last_etl_ms": model.last_etl_ms,
                                "last_etl_host_ms": model.last_etl_host_ms,
                                "last_etl_h2d_ms": model.last_etl_h2d_ms},
                        "profile": prof}
        log(f"fit loop {name}: {timing[name]['epoch_ms_per_step']:.3f} ms a step "
            f"over a warm epoch ({timing[name]['images_per_s']:.1f} images/s), "
            f"median synced step {timing[name]['median_synced_step_ms']:.3f} ms, "
            f"H2D share of busy {timing[name]['h2d_share_of_busy']}, etl "
            f"{json.dumps(timing[name]['etl'])}  [{card}]")
    result["timing"] = timing
    del pageable
    log(f"fit loop (AlexNet): launches {launches}, etl {json.dumps(result['etl'])}  [{card}]")
    return result


# ------------------------------------------------------- int8 matmul (K6)

INT8_OPS_PER_S = 1979e12   # H100 SXM data sheet, dense int8 tensor cores
# AlexNet's three dense layers as the int8 product sees them: (K, N)
ALEXNET_DENSE = {"fc6": (256, 4096), "fc7": (4096, 4096), "output": (4096, 1000)}
# the JAX package's int8 test shapes (tests/test_quantize.py SHAPES): (B, K, N)
JAX_INT8_SHAPES = [(1, 1, 1), (3, 5, 7), (8, 64, 16), (7, 127, 13),
                   (8, 128, 256), (9, 130, 33), (32, 256, 10), (5, 1024, 8)]
INT8_MAX_K = (2 ** 31 - 1) // (128 * 128)   # quant_matmul.MAX_K
# (label, m, K, N, fill, timed): fill None draws x and w uniformly from
# [-128, 127]; (a, b) sets every x to a and every w to b, the largest sums;
# "x+1" or "w+1" draws them but lays that operand out one byte into its
# buffer, so that it is not 16-byte aligned and takes the byte path
INT8_CASES = (
    [(f"alexnet_{name}_m{m}", m, k, n, None, True)
     for m in (1, 32) for name, (k, n) in ALEXNET_DENSE.items()]
    + [(f"jax_{b}x{k}x{n}", b, k, n, None, False) for b, k, n in JAX_INT8_SHAPES]
    + [("m33_output", 33, 4096, 1000, None, False),
       ("m129_fc6", 129, 256, 4096, None, False),
       ("m129_k130_bytes", 129, 130, 33, None, False),
       ("all_-128", 32, 4096, 1000, (-128, -128), False),
       ("all_127", 32, 4096, 1000, (127, 127), False),
       ("x_-128_w_127", 32, 4096, 1000, (-128, 127), False)]
    # K split over 8 blocks at the largest K, on the byte path (MAX_K is odd)
    # and on the 16-byte path: the largest partials and sums, bitwise
    + [("maxk_-128", 4, INT8_MAX_K, 80, (-128, -128), False),
       ("maxk_127", 32, INT8_MAX_K, 80, (127, 127), False),
       ("k131056_-128", 32, INT8_MAX_K // 16 * 16, 64, (-128, -128), False),
       ("n77_vec", 17, 512, 77, None, False)]
    # batch sizes around the 8-row n-fragment
    + [(f"b{b}_k1024_n200", b, 1024, 200, None, False) for b in (7, 8, 9, 17, 31)]
    + [("x_offset1", 32, 4096, 1000, "x+1", False),
       ("w_offset1", 9, 1024, 200, "w+1", False)])


def int8_bound_ms(m, k, n):
    """Least time for s8[m, K] x s8[N, K] -> s32[m, N]: read x and w and
    write the int32 result once, or 2 m N K operations at the int8
    tensor-core peak, whichever is longer."""
    bytes_ms = (m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * m * n * k / INT8_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def int8_operands(torch, gen, m, k, n, fill, device):
    """x [m, K] and w [N, K] int8 for one of INT8_CASES: drawn from `gen`,
    constant, or drawn and laid out one byte into a larger buffer (fill "x+1"
    or "w+1"; still contiguous, but not 16-byte aligned)."""
    def drawn(shape, offset=0):
        flat = torch.randint(-128, 128, (shape[0] * shape[1] + offset,),
                             dtype=torch.int8, device=device, generator=gen)
        return flat[offset:].view(shape)

    if isinstance(fill, tuple):
        return (torch.full((m, k), fill[0], dtype=torch.int8, device=device),
                torch.full((n, k), fill[1], dtype=torch.int8, device=device))
    return drawn((m, k), int(fill == "x+1")), drawn((n, k), int(fill == "w+1"))


def phase_int8(torch, card):
    """K6 against its plain version on the card, bitwise (torch.equal), at
    AlexNet's three dense shapes for buckets 1 and 32, the JAX package's test
    shapes, m-tiles beyond 32, batch sizes around the 8-row n-fragment, a K
    and unaligned operands that take the byte path, and constant inputs at
    the extremes (also at the largest K, split over 8 blocks); a
    non-contiguous weight must raise. Timed at
    AlexNet's shapes, as device time per call (`device_ms`; plain CUDA
    events around back-to-back calls, `events_ms`, time the host here):
    K6, the plain version, torch._int_mm (the library yardstick; it refuses
    m <= 16), and float32 and bfloat16 torch.matmul at the same shape for
    context."""
    from deeplearning4j_torch.ops import quant_matmul as qmm
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for label, m, k, n, fill, timed in INT8_CASES:
        x, w = int8_operands(torch, gen, m, k, n, fill, "cuda")
        got = qmm.int8_matmul(x, w)
        torch.cuda.synchronize()
        want = qmm.int8_matmul_reference(x, w)
        err = (got.long() - want.long()).abs().max().item()
        if not torch.equal(got, want):
            raise RuntimeError(f"int8_matmul {label}: {int((got != want).sum())} of "
                               f"{got.numel()} sums differ from the plain product "
                               f"(max {err})")
        row = {"case": label, "m": m, "k": k, "n": n, "max_abs_err": err,
               "max_abs_sum": want.abs().max().item()}
        if timed:  # device times: at these sizes a launch costs the host more
            row["ms"] = device_ms(torch, lambda: qmm.int8_matmul(x, w))
            row["events_ms"] = cuda_time_ms(lambda: qmm.int8_matmul(x, w))
            row["plain_ms"] = device_ms(torch, lambda: qmm.int8_matmul_reference(x, w))
            try:
                row["library_equal"] = torch.equal(torch._int_mm(x, w.t()), want)
                row["library_ms"] = device_ms(torch, lambda: torch._int_mm(x, w.t()))
            except RuntimeError as e:  # the yardstick's own shape rules
                row["library_ms"] = None
                row["library_refused"] = str(e).strip().splitlines()[0][:200]
            xf, wf, xb, wb = x.float(), w.float(), x.bfloat16(), w.bfloat16()
            row["fp32_matmul_ms"] = device_ms(torch, lambda: xf @ wf.T)
            row["bf16_matmul_ms"] = device_ms(torch, lambda: xb @ wb.T)
            row["bound_ms"], row["bound_by"] = int8_bound_ms(m, k, n)
            row["x_bound"] = row["ms"] / row["bound_ms"]
            row["x_library"] = (None if row["library_ms"] is None
                                else row["ms"] / row["library_ms"])
        rows.append(row)
        log(f"int8_matmul {label}: {json.dumps(row)}  [{card}]")
    strided = torch.zeros((256, 8), dtype=torch.int8, device="cuda").t()
    try:
        qmm.quant_matmul(torch.zeros((1, 256), dtype=torch.int8, device="cuda"), strided)
    except ValueError as e:
        log(f"int8_matmul: a strided weight raises: {e}")
    else:
        raise RuntimeError("int8_matmul took a non-contiguous weight")
    # the kernels line: one bucket-32 forward's three products
    timed = [r for r in rows if "ms" in r and r["m"] == 32]
    lib = [r["library_ms"] for r in timed]
    entry = {"name": "int8_matmul", "route": "cuda",
             "source": "deeplearning4j_torch/ops/csrc/int8_matmul.cu",
             "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:278",
             "launches": None, "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": sum(r["ms"] for r in timed),
             "plain_ms": sum(r["plain_ms"] for r in timed),
             "bound_ms": sum(r["bound_ms"] for r in timed),
             "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in timed)
             else "operations",
             "library_ms": None if None in lib else sum(lib)}
    return entry, rows


# ------------------------------------------------------- quantized serving

# A quantized answer is not held to a forward of its own rows at the float32
# tolerances: the served batch's convs and bfloat16 products sum in another
# order (cuDNN and cuBLAS choose by batch size), and where a value lies close
# to a rounding boundary the two land on its two sides. An int8 code of a
# dense input is one step of max|row| / 127, as large as a typical input; a
# bfloat16 value moves by 2^-8 of itself. On an H100 such flips moved 121 of
# 7,000 int8-arm probabilities by up to 4.7e-3 of themselves, and a bf16-arm
# answer by more than its own distance from the float32 one. So each answer
# is held exactly to the batch it was served in (`check_served_batches`),
# its distance from its own rows' forward is reported beside the distance
# quantization puts between it and the float32 answer (`quant_noise_share`),
# and the card is held to the CPU layer by layer, where the inputs are the
# same: the first conv and every dense product within one bfloat16 ulp, the
# int8 preouts bitwise (`check_layers_against_cpu`).
def quant_noise_share(got, want, fp32):
    """max|got - want| / max|want - fp32|: how far two evaluations of one
    quantized net lie apart, as a share of how far quantization moves it."""
    noise = float(np.abs(want - fp32).max())
    return float(np.abs(got - want).max()) / noise if noise else 0.0


@contextmanager
def recorded_outputs(net, records):
    """Append (input, output) of every `net.output` call in the block."""
    output = net.output

    def recording(x, *args, **kwargs):
        y = output(x, *args, **kwargs)
        # a served batch arrives on the card, staged through pinned memory
        records.append((x.cpu().numpy() if hasattr(x, "cpu") else np.array(x), y))
        return y

    net.output = recording
    try:
        yield
    finally:
        del net.output


def check_served_batches(net, batches, reqs, answers):
    """Each answer is bitwise the rows of the executed batch that held its
    request, and `net.output` of each executed batch gives its output again
    (SERVE tolerances): an answer is net.output of the rows it was served
    with. Returns the number of batches."""
    for bx, by in batches:
        np.testing.assert_allclose(by, net.output(bx), rtol=SERVE_RTOL, atol=SERVE_ATOL)
    for (c, j), out in answers.items():
        x = reqs[c][j]
        for bx, by in batches:
            hit = next((o for o in range(len(bx) - len(x) + 1)
                        if np.array_equal(bx[o:o + len(x)], x)), None)
            if hit is not None:
                break
        else:
            raise RuntimeError(f"request {(c, j)} is in no executed batch")
        if not np.array_equal(out, by[hit:hit + len(x)]):
            raise RuntimeError(f"request {(c, j)}: the answer is not its batch's rows")
    return len(batches)


@contextmanager
def checked_int8(torch, stats):
    """Run every int8 product of the network through `quant_matmul` (K6 on
    the card) and, on the same int8 inputs, through the plain version,
    holding the two bitwise equal. Counts the calls and records the shapes
    and the largest |sum|."""
    from deeplearning4j_torch.ops import quant_matmul as qmm
    kernel = qmm.quant_matmul

    def quant_matmul(x_q, w_q):
        got = kernel(x_q, w_q)
        want = qmm.int8_matmul_reference(x_q, w_q)
        if not torch.equal(got, want):
            raise RuntimeError(
                f"int8 product {list(x_q.shape)} x {list(w_q.shape)}: "
                f"{int((got != want).sum())} sums differ from the plain product")
        stats["calls"] += 1
        stats["shapes"].add((x_q.shape[0], x_q.shape[1], w_q.shape[0]))
        stats["max_abs_sum"] = max(stats["max_abs_sum"], want.abs().max().item())
        return got

    with patched(qmm, "quant_matmul", quant_matmul):
        yield


def expected_quant_launches(net, mode, forwards):
    """What `forwards` executed forwards of `net` must launch: K6 once per
    dense layer (output layers included) in int8 mode and never in bf16
    mode, K1 once per LRN layer in both."""
    from deeplearning4j_torch.nn.layers.convolution import LocalResponseNormalization
    from deeplearning4j_torch.nn.layers.core import DenseLayer
    dense = sum(isinstance(layer, DenseLayer) for layer in net.layers)
    lrn = sum(isinstance(layer, LocalResponseNormalization) for layer in net.layers)
    return {"int8_matmul": dense * forwards if mode == "int8" else 0,
            "lrn_fwd": lrn * forwards}


def check_launches(label, got, want):
    if got != want:
        raise RuntimeError(f"{label}: launches {got}, expected {want}")


@contextmanager
def recorded_dense_inputs(records):
    """Append (layer, input) for every dense preout in the block."""
    from deeplearning4j_torch.nn.layers.core import DenseLayer
    preout = DenseLayer.preout

    def recording(self, params, x):
        records.append((self, x))
        return preout(self, params, x)

    with patched(DenseLayer, "preout", recording):
        yield


def check_layers_against_cpu(torch, net, cpu_net, fp32_tree, x):
    """The card against the CPU path on identical inputs, layer by layer.
    The first layer's output (a bfloat16 conv of the same images) within
    one bfloat16 ulp of its largest value; then each dense preout of one
    forward of `x`, recomputed on its real input: an int8 preout bitwise
    (and within 2 sqrt(n_in) max|x| max W_scale of the float32 preout, the
    envelope of tests/test_quantize.py), a bfloat16 product within one
    bfloat16 ulp of its largest value (each value rounds once, to one of two
    neighbours; where a sum cancels, the two devices' float32 orders differ
    by far less than that ulp, though by more than the small value's own).
    Returns the rows and the CPU's answer."""
    from deeplearning4j_torch.quantize import quantize as quant
    cpu_acts = cpu_net.feed_forward(x)
    first = [net.feed_forward(x)[1], cpu_acts[1]]
    conv_err = float(np.abs(first[0] - first[1]).max())
    if not conv_err <= BF16_ULP * float(np.abs(first[1]).max()):
        raise RuntimeError(f"first layer: card and CPU differ by {conv_err}")
    records = []
    with recorded_dense_inputs(records):
        net.output(x)
    out = [{"layer": 0, "max_abs_card_vs_cpu": conv_err,
            "max_abs": float(np.abs(first[1]).max())}]
    for layer, a in records:
        i = next(j for j, other in enumerate(net.layers) if other is layer)
        p, cp = net.params_tree[i], cpu_net.params_tree[i]
        f32 = quant.matmul_any(a, fp32_tree[i]["W"], fp32_tree[i]["b"])
        row = {"layer": i, "rows": a.shape[0], "n_in": a.shape[1]}
        if quant.QUANT_WEIGHT in p:
            card = quant.dense_qforward(p, a)
            cpu = quant.dense_qforward(cp, a.cpu())
            diff = (card.cpu() - cpu).abs()
            if diff.max().item() != 0.0:
                raise RuntimeError(f"dense_qforward of layer {i}: card and CPU differ "
                                   f"by {diff.max().item()}")
            env = 2.0 * a.shape[1] ** 0.5 * a.abs().max().item() * p["W_scale"].max().item()
            dev = (card - f32).abs().max().item()
            if not dev <= env:
                raise RuntimeError(f"int8 preout of layer {i} is {dev} from float32, "
                                   f"beyond the envelope {env}")
            row["envelope"] = env
        else:
            card = quant.matmul_any(a, p["W"]).cpu()
            cpu = quant.matmul_any(a.cpu(), cp["W"])
            diff = (card - cpu).abs()
            top = max(card.abs().max().item(), cpu.abs().max().item())
            if not diff.max().item() <= BF16_ULP * top:
                raise RuntimeError(f"bfloat16 product of layer {i}: card and CPU differ "
                                   f"by {diff.max().item()}, more than one bfloat16 ulp "
                                   f"of its largest value {top}")
            dev = (card.to(f32.device) + p["b"] - f32).abs().max().item()
        row.update(max_abs_card_vs_cpu=diff.max().item(), max_abs_vs_fp32=dev)
        out.append(row)
    return out, cpu_acts[-1]


def serve_quantized(torch, card, net, cpu_net, mode, reqs, fp32_answers, x32, ref32,
                    fp32_tree):
    """One arm of phase_quant_serving: `net` already holds the `mode` tree."""
    from deeplearning4j_torch.ops import lrn as lrn_ops
    from deeplearning4j_torch.ops import quant_matmul as qmm
    from deeplearning4j_torch.parallel.inference import (InferenceMode,
                                                          ParallelInference)
    from deeplearning4j_torch.quantize import quantize as quant
    if quant.tree_precision(net.params_tree) != mode:
        raise RuntimeError(f"the {mode} tree reads as "
                           f"{quant.tree_precision(net.params_tree)}")
    images = sum(x.shape[0] for xs in reqs for x in xs)
    pi = ParallelInference(net, inference_mode=InferenceMode.BATCHED, batch_limit=32)
    stats = {"calls": 0, "shapes": set(), "max_abs_sum": 0}
    batches = []
    try:
        pi.warmup()
        # 1. the main path, every K6 call held to the plain product
        with checked_int8(torch, stats), recorded_outputs(net, batches):
            f0 = pi.total_forwards
            qmm.launches = lrn_ops.launches = 0  # the main path's run starts here
            answers, _, _ = run_clients(pi, reqs)
            launches = {"int8_matmul": qmm.launches,
                        "lrn_fwd": lrn_ops.launches}  # ... and ends here
            forwards = pi.total_forwards - f0
        check_launches(f"{mode} serving", launches,
                       expected_quant_launches(net, mode, forwards))
        if forwards < 1 or stats["calls"] != launches["int8_matmul"]:
            raise RuntimeError(f"{mode}: {forwards} forwards, {stats['calls']} "
                               f"checked products, {launches}")
        # 2. the same load again, unchecked, for its latencies
        f0 = pi.total_forwards
        qmm.launches = lrn_ops.launches = 0
        _, lat, wall = run_clients(pi, reqs)
        timed_forwards = pi.total_forwards - f0
        check_launches(f"{mode} timed serving",
                       {"int8_matmul": qmm.launches, "lrn_fwd": lrn_ops.launches},
                       expected_quant_launches(net, mode, timed_forwards))
    finally:
        pi.shutdown()
    stats["shapes"] = sorted(stats["shapes"])
    for (c, j), out in answers.items():
        if out.shape != (reqs[c][j].shape[0], net.layers[-1].n_out) or \
                not np.isfinite(out).all():
            raise RuntimeError(f"{mode}: bad answer shape/values {out.shape}")
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
    result = {**latency_stats(lat, images, wall), "forwards": forwards,
              "launches": launches, "k6_in_forward": stats,
              "batches_rechecked": check_served_batches(net, batches, reqs, answers)}
    del batches
    direct = {key: net.output(reqs[key[0]][key[1]]) for key in answers}
    result["vs_own_rows"] = {
        "max_abs": max(float(np.abs(answers[k] - direct[k]).max()) for k in answers),
        "max_share_of_quant_noise": max(quant_noise_share(
            answers[k], direct[k], fp32_answers[k]) for k in answers),
        "top1_equal": float(np.mean(np.concatenate(
            [answers[k].argmax(-1) == direct[k].argmax(-1) for k in answers])))}
    layers, cpu_out = check_layers_against_cpu(torch, net, cpu_net, fp32_tree, reqs[0][0])
    result["vs_cpu"] = {
        "max_abs": float(np.abs(direct[(0, 0)] - cpu_out).max()),
        "share_of_quant_noise": quant_noise_share(direct[(0, 0)], cpu_out,
                                                  fp32_answers[(0, 0)]),
        "top1_equal": bool(np.array_equal(direct[(0, 0)].argmax(-1), cpu_out.argmax(-1))),
        "layers": layers}
    q32 = net.output(x32)
    result["max_drift"] = float(np.abs(q32 - ref32).max())
    result["top1_agreement_vs_fp32"] = float((q32.argmax(-1) == ref32.argmax(-1)).mean())
    result["profile"] = profile_call(torch, f"forward {mode}", lambda: net.output(x32),
                                     {"batch": 32, "precision": mode})
    shown = {k: v for k, v in result.items() if k != "profile"}
    log(f"quantized serving {mode}: {json.dumps(shown)}  [{card}]")
    return result


def phase_quant_serving(torch, card, net, reqs, fp32_answers, cpu_net, fp32):
    """The fp32 serving net of phase_serving with its tree quantized
    (quantize_tree) to int8 and then to bf16, each served through
    ParallelInference to the same client load: launches (K6 3 x forwards in
    int8, 0 in bf16; K1 2 x forwards), every K6 call in the served forwards
    held bitwise to the plain product, each answer against `net.output` of
    the batch it was served in, the card against the CPU path layer by layer
    (`check_layers_against_cpu`), the drift from the float32 answers on a
    fixed batch of 32, latencies beside fp32's, and one profiled bucket-32
    forward. How far an answer lies from its own rows' forward and from the
    CPU's is reported as a share of its quantization noise (see BF16_ULP)."""
    from deeplearning4j_torch.quantize import quantize as quant
    fp32_tree = net.params_tree
    x32 = np.random.default_rng(2031).standard_normal((32, 224, 224, 3)).astype(np.float32)
    ref32 = net.output(x32)
    arms = {}
    try:
        for mode in ("int8", "bf16"):
            net.params_tree = quant.quantize_tree(fp32_tree, mode)
            cpu_net.params_tree = tuple({k: v.cpu() for k, v in layer.items()}
                                        for layer in net.params_tree)
            arms[mode] = serve_quantized(torch, card, net, cpu_net, mode, reqs,
                                         fp32_answers, x32, ref32, fp32_tree)
    finally:
        net.params_tree = fp32_tree
    for mode, arm in [("fp32", fp32)] + list(arms.items()):
        log(f"quantized serving: {mode}: p50 {arm['p50_ms']:.3f} ms, p99 "
            f"{arm['p99_ms']:.3f} ms, {arm['images_per_s']:.1f} images/s, "
            f"drift {arm.get('max_drift', 0.0):.3e}  [{card}]")
    return arms


# ------------------------------------------------------- the serving plane

#: phase_gateway's sizes: zoo AlexNet and two zoo GoogLeNets at full width,
#: the client load of phase_serving, bench.py bench_serving_decode's decoder
GATEWAY_FULL = dict(alexnet=((224, 224, 3), 1000), googlenet=((224, 224, 3), 1000),
                    clients=4, per_client=8, max_rows=8, face_clients=2,
                    face_per_client=4, train_batch=32, train_steps=2,
                    swap_clients=2, swap_inputs=4, int8_per_client=2,
                    probe_rows=2, batch_limit=None,   # None: SERVE_BATCH_LIMIT
                    decode=None)   # None: DECODE_GEOMETRY
GATEWAY_BREAKER = dict(breaker_threshold=3, breaker_reset_s=1.0)
GATEWAY_CANARY_DRIFT = 1e-2   # the int8 swap's golden-batch drift budget, of softmax outputs
GATEWAY_HTTP_TIMEOUT_S = 300  # one HTTP call of the phase
GATEWAY_JOIN_S = 600          # a client thread that has not ended by then fails the phase
GATEWAY_PHASE_SUM_MS = 1.0    # an exemplar's phases against its wall latency
GATEWAY_TUNER_S = 1.0         # the traffic the AutoTuner watches, s
GATEWAY_TRACED = 16           # requests traced by the flight recorder


def pixel_images(rng, n, shape):
    """`n` images of `shape` on an 8-bit grid (k / 32 for k in -128..127,
    standard normal before rounding): exact in float32 and short in JSON,
    as pixel data sent to an image service is."""
    x = np.clip(np.round(rng.standard_normal((n,) + tuple(shape)) * 32), -128, 127)
    return (x / 32).astype(np.float32)


def http_json(url, payload=None, timeout=GATEWAY_HTTP_TIMEOUT_S):
    """(status, parsed JSON body) of one GET (payload None) or POST (a dict,
    or JSON bytes already encoded) to the gateway; non-2xx answers too."""
    import urllib.error
    import urllib.request
    data = payload if isinstance(payload, bytes) or payload is None \
        else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def run_http_clients(url, jobs):
    """One thread per client, each POSTing its (key, JSON bytes) jobs in
    turn to `url`: ({key: (status, body)}, {key: (sent s, answered s)},
    wall s). Raises if a thread does not end within GATEWAY_JOIN_S."""
    answers, times, errors = {}, {}, []

    def client(c):
        try:
            for key, body in jobs[c]:
                t = time.perf_counter()
                answers[key] = http_json(url, body)
                times[key] = (t, time.perf_counter())
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(len(jobs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=GATEWAY_JOIN_S)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"gateway clients failed: {errors!r}")
    return answers, times, wall


def http_latency_stats(times, keys, images):
    """latency_stats of the requests `keys`, over the span from the first
    one sent to the last one answered."""
    wall = max(times[k][1] for k in keys) - min(times[k][0] for k in keys)
    return latency_stats([times[k][1] - times[k][0] for k in keys], images, wall)


def ok_predictions(label, answers):
    """{key: float32 predictions} of 200 answers; raises on any other."""
    bad = {k: a for k, a in answers.items() if a[0] != 200}
    if bad:
        raise RuntimeError(f"{label}: failed requests {bad!r}"[:2000])
    return {k: np.asarray(a[1]["predictions"], np.float32) for k, a in answers.items()}


def lrn_layers_of(net):
    """LRN layers one forward of `net` (a network or a graph) runs: K1 launches."""
    from deeplearning4j_torch.nn.layers.convolution import LocalResponseNormalization
    layers = net.layers if hasattr(net, "layers") else [
        n.layer for n in net.conf.nodes.values() if n.is_layer()]
    return sum(isinstance(layer, LocalResponseNormalization) for layer in layers)


def gateway_launches(want_lrn=0, want_int8=0, want_decode=0):
    want = dict.fromkeys(all_launches(), 0)
    want.update(lrn_fwd=want_lrn, int8_matmul=want_int8, decode_attention=want_decode)
    return want


def swap_under_traffic(gw, net, inputs, clients):
    """POST /swap while `clients` threads keep POSTing /predict over
    `inputs`: each client sends until it has two answers from after the swap
    returned. Returns ([(input index, sent s, status, predictions)], the
    swap's answer, the swap's own wall s, when it returned)."""
    bodies = [json.dumps({"model": "alexnet", "features": x.tolist()}).encode()
              for x in inputs]
    records, errors = [], []
    lock = threading.Lock()
    done_at = [None]
    started = [threading.Event() for _ in range(clients)]

    def client(c):
        after, i = 0, c
        try:
            while after < 2:
                k = i % len(inputs)
                t = time.perf_counter()
                code, body = http_json(gw.url + "/predict", bodies[k])
                with lock:
                    records.append((k, t, code, body.get("predictions")))
                    if done_at[0] is not None and t > done_at[0]:
                        after += 1
                started[c].set()   # the swap waits for one answer a client
                i += 1
        except BaseException as e:
            errors.append(e)
            started[c].set()

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for ev in started:
        ev.wait(timeout=GATEWAY_JOIN_S)
    t = time.perf_counter()
    swap = http_json(gw.url + "/swap", {"model": "alexnet"})
    with lock:
        done_at[0] = time.perf_counter()
    swap_wall = done_at[0] - t
    for th in threads:
        th.join(timeout=GATEWAY_JOIN_S)
    if errors or any(th.is_alive() for th in threads):
        raise RuntimeError(f"swap clients failed: {errors!r}")
    return records, swap, swap_wall, done_at[0]


def phase_gateway(torch, card, device=None, size=None):
    """The serving plane (serving/gateway.py over serving/model_pool.py),
    driven through its HTTP routes on 127.0.0.1 and in process:

    1. `ServingGateway` over a `ModelPool`: zoo AlexNet (full width,
       float32, on CUDA) as "alexnet" at tier "critical" (the highest of the
       scheduler's tiers) with a CheckpointManager; two zoo GoogLeNets
       (seeds 1 and 2) as the fused group "faces" at tier "batch", which
       must not have fallen back (`entry.group`, and
       serving_fused_fallback_total 0); `warmup()`. Four clients x 8
       requests of 1-8 images POST /predict to "alexnet" while two clients
       POST to the members. K1 is reset just before and read just after: 2
       x AlexNet's forwards + 4 x the fused forwards (two LRNs a member).
    2. The same AlexNet load in process (`gateway.predict`): each HTTP
       answer equals its in-process answer and `net.output` (SERVE
       tolerances); each member's columns equal that member alone; a request
       of `probe_rows` images equals the CPU path.
    3. A second AlexNet trained `train_steps` steps at batch `train_batch`
       publishes a checkpoint; POST /swap runs while clients keep sending:
       no request fails, every answer is the old parameters' or the new
       ones', every answer sent after the swap returned is the new ones'.
       Then POST /swap {"quantize": "int8"}: the golden batch's drift stays
       under GATEWAY_CANARY_DRIFT, K6 = 3 x forwards and K1 = 2 x forwards
       of a counted HTTP run, each answer bitwise its batch's rows. Then a
       checkpoint with a NaN in fc8's bias: 409 canary_rejected, the old
       tree itself restored, answers bitwise as before.
    4. The fault point serve.forward armed: the breaker opens after
       breaker_threshold failures, /predict then answers 503 breaker_open
       without a forward, /health is degraded; after breaker_reset_s one
       probe closes it.
    5. `add_decode_model` of TransformerDecoder(seed=7) at
       bench_serving_decode's defaults; 6 clients x 4 prompts x 48 tokens
       through POST /generate: every answer equals `naive_generate`'s, K7 =
       layers x decode steps.
    6. The flight recorder on and the critical tier's SLO set below any
       latency through POST /config: /debug/requests returns exemplars
       whose phases sum to their latency (GATEWAY_PHASE_SUM_MS); /trace
       parses; an AutoTuner with a temporary ledger runs one short window,
       /debug/tuner reports it and every ledger line passes
       `validate_entry`.

    Reports p50/p99 and images/s over HTTP and in process, the swap's pause
    (the serve/swap_pause span), tokens/s and inter-token p50/p99 through
    /generate, and the K1, K6 and K7 counts."""
    import tempfile

    from deeplearning4j_torch.models.zoo import AlexNet, GoogLeNet
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.optimize import tracing
    from deeplearning4j_torch.optimize.metrics import registry
    from deeplearning4j_torch.optimize.resilience import CheckpointManager
    from deeplearning4j_torch.serving import (FusedModelGroup, ModelPool,
                                              ServingGateway, SLOMonitor,
                                              autotuner, flight_recorder)
    from deeplearning4j_torch.serving import decode as sd
    from deeplearning4j_torch.serving.model_pool import _golden_forward
    from deeplearning4j_torch.utils import faults
    s = dict(GATEWAY_FULL, **(size or {}))
    dev = device or "cuda"
    batch_limit = s["batch_limit"] or SERVE_BATCH_LIMIT
    rng = np.random.default_rng(2171)
    reg = registry()
    result = {"card": card, "step_s": {}}
    t_phase = time.perf_counter()

    def step_done(name):
        result["step_s"][name] = time.perf_counter() - t_phase - sum(
            result["step_s"].values())

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_gateway_")
    gw = ServingGateway(ModelPool())
    try:
        # 1. the gateway, its entries and the storm
        (a_shape, a_classes), (g_shape, g_classes) = s["alexnet"], s["googlenet"]
        net = AlexNet(input_shape=a_shape, num_labels=a_classes).init(device=dev)
        mgr = CheckpointManager(os.path.join(tmp.name, "alexnet"), save_updater=False)
        entry = gw.add_model("alexnet", net, checkpoints=mgr, tier="critical",
                             batch_limit=batch_limit, **GATEWAY_BREAKER)
        members = {f"face_{c}": GoogLeNet(input_shape=g_shape, num_labels=g_classes
                                          ).init(device=dev, seed=i + 1)
                   for i, c in enumerate("ab")}
        fallbacks0 = reg.counter("serving_fused_fallback_total").total()
        group = gw.add_fused_group("faces", members, tier="batch",
                                   batch_limit=batch_limit)
        fallbacks = reg.counter("serving_fused_fallback_total").total() - fallbacks0
        if not isinstance(group, FusedModelGroup) or fallbacks != 0 or any(
                gw.pool.get(m).group is not group for m in members):
            raise RuntimeError(f"gateway: the fused group fell back ({fallbacks} "
                               f"members counted in serving_fused_fallback_total)")
        t0 = time.perf_counter()
        gw.warmup()
        log(f"gateway: warmup of alexnet {entry.engine.warmed_buckets} and faces "
            f"{group.engine.warmed_buckets} in {time.perf_counter() - t0:.2f} s, "
            f"fused nodes {len(group.fusion_groups)}")
        gw.start()
        predict = gw.url + "/predict"
        reqs = [[pixel_images(rng, int(rng.integers(1, s["max_rows"] + 1)), a_shape)
                 for _ in range(s["per_client"])] for _ in range(s["clients"])]
        face_reqs = [[(f"face_{'ab'[(c + j) % 2]}",
                       pixel_images(rng, int(rng.integers(1, s["max_rows"] + 1)), g_shape))
                      for j in range(s["face_per_client"])] for c in range(s["face_clients"])]
        jobs = [[((c, j), json.dumps({"model": "alexnet", "features": x.tolist()}).encode())
                 for j, x in enumerate(xs)] for c, xs in enumerate(reqs)]
        jobs += [[(("face", c, j), json.dumps({"model": m, "features": x.tolist()}).encode())
                  for j, (m, x) in enumerate(xs)] for c, xs in enumerate(face_reqs)]
        fa0, ff0 = entry.engine.total_forwards, group.engine.total_forwards
        torch.cuda.synchronize()
        zero_launches()   # the main path's run starts here
        answers, times, wall = run_http_clients(predict, jobs)
        launches = all_launches()   # ... and ends here
        fwd_a = entry.engine.total_forwards - fa0
        fwd_f = group.engine.total_forwards - ff0
        check_launches("gateway storm", launches, gateway_launches(
            lrn_layers_of(net) * fwd_a + lrn_layers_of(group.fused_net) * fwd_f))
        got = ok_predictions("gateway storm", answers)
        if fwd_a < 1 or fwd_f < 1:
            raise RuntimeError(f"gateway: {fwd_a} alexnet and {fwd_f} fused forwards")
        a_keys = [k for k in got if k[0] != "face"]
        images = sum(reqs[c][j].shape[0] for c, j in a_keys)
        http = http_latency_stats(times, a_keys, images)
        result.update(storm_launches=launches, alexnet_forwards=fwd_a,
                      fused_forwards=fwd_f, http=http, storm_wall_s=wall)

        # 2. the answers
        inproc, in_lat, in_wall = run_clients(
            types.SimpleNamespace(output=lambda x: gw.predict("alexnet", x)), reqs)
        result["in_process"] = latency_stats(in_lat, images, in_wall)
        max_http_vs_inproc = max_vs_direct = 0.0
        for c, j in a_keys:
            x, out = reqs[c][j], got[(c, j)]
            if out.shape != (x.shape[0], a_classes) or not np.isfinite(out).all():
                raise RuntimeError(f"gateway: bad answer {out.shape} for {(c, j)}")
            direct = net.output(x)
            np.testing.assert_allclose(out, inproc[(c, j)], rtol=SERVE_RTOL, atol=SERVE_ATOL)
            np.testing.assert_allclose(out, direct, rtol=SERVE_RTOL, atol=SERVE_ATOL)
            max_http_vs_inproc = max(max_http_vs_inproc,
                                     float(np.abs(out - inproc[(c, j)]).max()))
            max_vs_direct = max(max_vs_direct, float(np.abs(out - direct).max()))
        max_member = 0.0
        for c, xs in enumerate(face_reqs):
            for j, (m, x) in enumerate(xs):
                out, solo = got[("face", c, j)], members[m].output(x)
                if out.shape != solo.shape:
                    raise RuntimeError(f"gateway: member {m} answered {out.shape}, "
                                       f"alone {solo.shape}")
                np.testing.assert_allclose(out, solo, rtol=SERVE_RTOL, atol=SERVE_ATOL)
                max_member = max(max_member, float(np.abs(out - solo).max()))
        cpu_net = MultiLayerNetwork(net.conf).init(device="cpu")
        cpu_net.params_tree = tuple({k: v.cpu() for k, v in layer.items()}
                                    for layer in net.params_tree)
        x_probe = reqs[0][0][:s["probe_rows"]] if reqs[0][0].shape[0] >= s["probe_rows"] \
            else pixel_images(rng, s["probe_rows"], a_shape)
        code, body = http_json(predict, {"model": "alexnet", "features": x_probe.tolist()})
        if code != 200:
            raise RuntimeError(f"gateway: the probe request answered {code} {body}")
        probe, cpu_out = np.asarray(body["predictions"], np.float32), cpu_net.output(x_probe)
        np.testing.assert_allclose(probe, cpu_out, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        del cpu_net
        result["max_abs_err"] = {"http_vs_in_process": max_http_vs_inproc,
                                 "http_vs_direct": max_vs_direct,
                                 "member_vs_alone": max_member,
                                 "probe_vs_cpu": float(np.abs(probe - cpu_out).max())}
        log(f"gateway: storm {fwd_a} alexnet + {fwd_f} fused forwards, K1 "
            f"{launches['lrn_fwd']}; HTTP p50 {http['p50_ms']:.3f} ms p99 "
            f"{http['p99_ms']:.3f} ms {http['images_per_s']:.1f} images/s, in process "
            f"p50 {result['in_process']['p50_ms']:.3f} ms p99 "
            f"{result['in_process']['p99_ms']:.3f} ms "
            f"{result['in_process']['images_per_s']:.1f} images/s; "
            f"{json.dumps(result['max_abs_err'])}  [{card}]")
        c, j = max(a_keys, key=lambda k: reqs[k[0]][k[1]].shape[0])
        rows = int(reqs[c][j].shape[0])
        result["profile_http"] = profile_call(
            torch, "gateway /predict", lambda: http_json(predict, jobs[c][j][1]),
            {"route": "/predict", "rows": rows, "json_bytes": len(jobs[c][j][1])})
        result["profile_in_process"] = profile_call(
            torch, "gateway predict in process", lambda: gw.predict("alexnet", reqs[c][j]),
            {"rows": rows})
        step_done("serve")

        # 3. swaps: under traffic, to int8, and a NaN checkpoint
        trainer = AlexNet(input_shape=a_shape, num_labels=a_classes).init(device=dev)
        n_train = s["train_batch"] * s["train_steps"]
        xt = rng.standard_normal((n_train,) + tuple(a_shape)).astype(np.float32)
        yt = np.eye(a_classes, dtype=np.float32)[rng.integers(0, a_classes, n_train)]
        trainer.fit(xt, yt, epochs=1, batch_size=s["train_batch"])
        if trainer.iteration != s["train_steps"]:
            raise RuntimeError(f"gateway: the trainer took {trainer.iteration} steps")
        t0 = time.perf_counter()
        mgr.save(trainer)
        save_s = time.perf_counter() - t0
        swap_x = [pixel_images(rng, 1 + i % 2, a_shape) for i in range(s["swap_inputs"])]
        old_refs = [net.output(x) for x in swap_x]
        traced = tracing.is_enabled()
        if not traced:
            tracing.enable(fence_every=0)
        try:
            records, swap, swap_wall, done_at = swap_under_traffic(
                gw, net, swap_x, s["swap_clients"])
            spans = {e["name"]: e["dur"] / 1e3
                     for e in tracing.export_trace_events()["traceEvents"]
                     if e["name"] in ("serve/swap", "serve/swap_pause")}
        finally:
            if not traced:
                tracing.disable()
        if swap[0] != 200 or not swap[1].get("swapped"):
            raise RuntimeError(f"gateway: the live swap answered {swap}")
        new_refs = [net.output(x) for x in swap_x]
        close = lambda a, b: np.allclose(a, b, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        if any(close(o, n) for o, n in zip(old_refs, new_refs)):
            raise RuntimeError("gateway: the trained checkpoint answers as the old "
                               "parameters do; the swap cannot be seen")
        seen = {"old": 0, "new": 0, "after_swap": 0}
        for k, t, code, pred in records:
            if code != 200:
                raise RuntimeError(f"gateway: a request during the swap answered {code}")
            pred = np.asarray(pred, np.float32)
            which = "new" if close(pred, new_refs[k]) else \
                "old" if close(pred, old_refs[k]) else None
            if which is None:
                raise RuntimeError(f"gateway: an answer during the swap is neither the "
                                   f"old parameters' nor the new ones' (input {k})")
            seen[which] += 1
            if t > done_at:
                seen["after_swap"] += 1
                if which != "new":
                    raise RuntimeError("gateway: an answer sent after the swap returned "
                                       "came from the old parameters")
        result["swap"] = {"answers": seen, "requests": len(records),
                          "swap_wall_ms": swap_wall * 1e3,
                          "pause_ms": spans.get("serve/swap_pause"),
                          "span_ms": spans.get("serve/swap"),
                          "checkpoint_save_s": save_s, "file": swap[1]["file"]}
        golden = entry.golden_batch
        if golden is None:
            raise RuntimeError("gateway: no golden batch was captured for the canary")
        fp32_golden = _golden_forward(net, golden)
        # a trained checkpoint moves the answers by design; a quantized one
        # is bounded by the canary's drift budget
        entry.canary_max_drift = GATEWAY_CANARY_DRIFT
        code, body = http_json(gw.url + "/swap", {"model": "alexnet", "quantize": "int8"})
        if code != 200 or body.get("precision") != "int8" or entry.precision != "int8":
            raise RuntimeError(f"gateway: the int8 swap answered {code} {body}")
        drift = float(np.abs(_golden_forward(net, golden) - fp32_golden).max())
        if not drift <= GATEWAY_CANARY_DRIFT:
            raise RuntimeError(f"gateway: int8 golden drift {drift} over the budget")
        int8_jobs = [jobs[c][:s["int8_per_client"]] for c in range(s["clients"])]
        batches = []
        fa0 = entry.engine.total_forwards
        with recorded_outputs(net, batches):
            torch.cuda.synchronize()
            zero_launches()   # the int8 run starts here
            answers8, times8, _ = run_http_clients(predict, int8_jobs)
            launches8 = all_launches()   # ... and ends here
        fwd8 = entry.engine.total_forwards - fa0
        check_launches("gateway int8", launches8, gateway_launches(
            lrn_layers_of(net) * fwd8, expected_quant_launches(net, "int8", fwd8)
            ["int8_matmul"]))
        got8 = ok_predictions("gateway int8", answers8)
        check_served_batches(net, batches, reqs, got8)
        del batches
        result["int8"] = {"launches": launches8, "forwards": fwd8, "golden_drift": drift,
                          "drift_budget": GATEWAY_CANARY_DRIFT,
                          **http_latency_stats(times8, list(got8), sum(
                              reqs[c][j].shape[0] for c, j in got8))}
        probe_x = swap_x[:2]
        before = [gw.predict("alexnet", x) for x in probe_x]
        tree8 = net.params_tree
        tree = list(trainer.params_tree)
        fc8 = dict(tree[-1])
        fc8["b"] = fc8["b"].clone()
        fc8["b"][0] = float("nan")
        tree[-1] = fc8
        trainer.params_tree = tuple(tree)
        trainer.iteration += 1
        mgr.save(trainer)
        rejected = reg.counter("serving_swaps_total").value(
            model="alexnet", outcome="canary_rejected", precision="fp32")
        code, body = http_json(gw.url + "/swap", {"model": "alexnet"})
        rejected = reg.counter("serving_swaps_total").value(
            model="alexnet", outcome="canary_rejected", precision="fp32") - rejected
        if code != 409 or "canary gate rejected" not in body.get("error", "") \
                or rejected != 1:
            raise RuntimeError(f"gateway: the NaN checkpoint answered {code} {body} "
                               f"({rejected} canary rejections counted)")
        if net.params_tree is not tree8 or entry.precision != "int8" \
                or entry.version.get("file") != swap[1]["file"]:
            raise RuntimeError("gateway: the rollback did not restore the int8 tree")
        after = [gw.predict("alexnet", x) for x in probe_x]
        if not all(np.array_equal(a, b) for a, b in zip(before, after)):
            raise RuntimeError("gateway: answers moved across the rejected swap")
        result["nan_checkpoint"] = {"status": code, "outcome": "canary_rejected",
                                    "answers_bitwise_unchanged": True}
        log(f"gateway: swap under traffic {json.dumps(result['swap'])}; int8 swap "
            f"drift {drift:.3e}, K6 {launches8['int8_matmul']} K1 "
            f"{launches8['lrn_fwd']} in {fwd8} forwards; NaN checkpoint rejected "
            f"and rolled back  [{card}]")
        del trainer, xt, yt
        step_done("swaps")

        # 4. the breaker
        br = entry.breaker
        one = json.dumps({"model": "alexnet", "features": swap_x[0].tolist()}).encode()
        faults.inject("serve.forward", "fail:*")
        try:
            codes = [http_json(predict, one) for _ in range(br.failure_threshold)]
            if [c for c, _ in codes] != [500] * br.failure_threshold or \
                    any(b.get("reason") != "batch_failed" for _, b in codes) or \
                    br.state != "open":
                raise RuntimeError(f"gateway: breaker {br.state} after {codes}")
            f0, calls0 = entry.engine.total_forwards, faults.call_count("serve.forward")
            code, body = http_json(predict, one)
            if code != 503 or body.get("reason") != "breaker_open" or \
                    entry.engine.total_forwards != f0 or \
                    faults.call_count("serve.forward") != calls0:
                raise RuntimeError(f"gateway: an open breaker answered {code} {body}")
            health = http_json(gw.url + "/health")[1]
            if health["status"] != "degraded" or "alexnet" not in health["degraded"]:
                raise RuntimeError(f"gateway: /health with an open breaker: {health}")
        finally:
            faults.clear("serve.forward")
        time.sleep(br.reset_timeout_s + 0.05)
        code, body = http_json(predict, one)
        health = http_json(gw.url + "/health")[1]
        if code != 200 or br.state != "closed" or health["status"] != "ok":
            raise RuntimeError(f"gateway: the probe answered {code}, breaker "
                               f"{br.state}, /health {health}")
        result["breaker"] = {"opened_after": br.failure_threshold, "fast_fail": 503,
                             "reclosed_after_s": br.reset_timeout_s}
        step_done("breaker")

        # 5. decode through POST /generate
        g = s["decode"] or DECODE_GEOMETRY
        decoder = sd.TransformerDecoder(vocab=g["vocab"], layers=g["layers"],
                                        heads=g["heads"], head_dim=g["head_dim"],
                                        ff=g["ff"], max_context=g["max_context"],
                                        seed=7, device=dev)
        gw.add_decode_model("decoder", decoder, max_decode_batch=g["max_decode_batch"],
                            pack_bucket=g["pack_bucket"],
                            kv_block_tokens=g["block_tokens"],
                            kv_max_blocks=g["kv_max_blocks"])
        gw.warmup("decoder")
        n = g["clients"] * g["prompts_per_client"]
        drng = np.random.default_rng(0)
        prompts = [drng.integers(0, g["vocab"], size=ln).tolist()
                   for ln in drng.integers(g["prompt_lo"], g["prompt_hi"], size=n)]
        http_json(gw.url + "/generate", {"model": "decoder", "prompt": prompts[0],
                                         "max_new_tokens": 2})   # unmeasured seeding pass
        steps_c = reg.counter("serving_decode_steps_total").labels(model="decoder")
        itl_h = reg.histogram("serving_inter_token_ms",
                              buckets=sd.INTER_TOKEN_BUCKETS_MS).labels(model="decoder")
        steps0, itl0 = steps_c.value(), len(itl_h.window_values())
        per = g["prompts_per_client"]
        gen_jobs = [[(c * per + j, json.dumps({
            "model": "decoder", "prompt": prompts[c * per + j],
            "max_new_tokens": g["max_new_tokens"]}).encode()) for j in range(per)]
            for c in range(g["clients"])]
        torch.cuda.synchronize()
        zero_launches()   # the decode run starts here
        gen, _, gen_wall = run_http_clients(gw.url + "/generate", gen_jobs)
        launches_d = all_launches()   # ... and ends here
        steps = int(steps_c.value() - steps0)
        check_launches("gateway decode", launches_d,
                       gateway_launches(want_decode=g["layers"] * steps))
        bad = {i: a for i, a in gen.items() if a[0] != 200}
        if bad:
            raise RuntimeError(f"gateway: failed /generate requests {bad!r}"[:2000])
        naive = [sd.naive_generate(decoder, p, g["max_new_tokens"], pad_to=g["pack_bucket"])
                 for p in prompts]
        diverged = [i for i in range(n) if gen[i][1]["tokens"] != naive[i]]
        if diverged:
            raise RuntimeError(f"gateway: /generate differs from naive_generate for "
                               f"prompts {diverged}")
        itl = np.asarray(itl_h.window_values()[itl0:], np.float64)
        tokens = n * g["max_new_tokens"]
        result["decode"] = {"requests": n, "tokens": tokens, "steps": steps,
                            "launches": launches_d, "wall_s": gen_wall,
                            "tokens_per_s": tokens / gen_wall,
                            "inter_token_p50_ms": float(np.percentile(itl, 50)),
                            "inter_token_p99_ms": float(np.percentile(itl, 99)),
                            "all_equal_naive": True}
        log(f"gateway: /generate {json.dumps(result['decode'])}  [{card}]")
        step_done("decode")

        # 6. the observability routes
        flight_recorder.clear()
        flight_recorder.enable()
        ledger = os.path.join(tmp.name, "autotune_ledger.jsonl")
        code, body = http_json(gw.url + "/config", {"tier_slo_ms": {"critical": 1e-3}})
        if code != 200:
            raise RuntimeError(f"gateway: /config answered {code} {body}")
        for _ in range(GATEWAY_TRACED):
            if http_json(predict, one)[0] != 200:
                raise RuntimeError("gateway: a traced request failed")
        # read before the tuner starts: its ticks hold the interpreter, and a
        # woken caller's wait for them lands in its `respond` phase
        code, ex = http_json(gw.url + "/debug/requests?model=alexnet")
        if code != 200 or not ex.get("count"):
            raise RuntimeError(f"gateway: /debug/requests answered {code} {ex}"[:2000])
        gaps = [e["wall_ms"] - sum(p["ms"] for p in e["phases"]) for e in ex["requests"]]
        respond = [sum(p["ms"] for p in e["phases"] if p["phase"] == "respond")
                   for e in ex["requests"]]
        if not (min(gaps) >= -GATEWAY_PHASE_SUM_MS and max(gaps) <= GATEWAY_PHASE_SUM_MS):
            raise RuntimeError(f"gateway: exemplars' phases miss their latency by "
                               f"{min(gaps)} to {max(gaps)} ms")
        tuner = gw.attach_tuner(ledger_path=ledger, interval_s=0.2,
                                monitor=SLOMonitor(gw.pool, window_s=30.0, min_samples=1))
        t_end = time.perf_counter() + GATEWAY_TUNER_S
        while time.perf_counter() < t_end:
            if http_json(predict, one)[0] != 200:
                raise RuntimeError("gateway: a request under the tuner failed")
        tuner.stop()
        code, trace = http_json(gw.url + "/trace")
        serve_spans = sum(e.get("cat") == "serve" for e in trace.get("traceEvents", []))
        if code != 200 or not serve_spans:
            raise RuntimeError(f"gateway: /trace answered {code} with {serve_spans} "
                               f"serving spans")
        code, tuned = http_json(gw.url + "/debug/tuner")
        rows = autotuner.read_ledger(ledger)
        problems = [autotuner.validate_entry(r) for r in rows]
        if code != 200 or not tuned.get("enabled") or not rows or any(problems):
            raise RuntimeError(f"gateway: /debug/tuner {code} {tuned.get('state')}, "
                               f"ledger {len(rows)} rows, problems {problems}")
        http_json(gw.url + "/config", {"tier_slo_ms": {"critical": 50.0}})
        stats = http_json(gw.url + "/stats")[1]
        models = http_json(gw.url + "/models")[1]
        result["observability"] = {
            "exemplars": ex["count"], "phase_sum_gap_ms": [min(gaps), max(gaps)],
            "respond_ms": [min(respond), max(respond)],
            "trace_serve_spans": serve_spans, "tuner_state": tuned["state"],
            "ledger_rows": len(rows), "ledger_kinds": sorted({r["kind"] for r in rows}),
            "stats_models": sorted(stats["latency"]),
            "models": [m["model"] for m in models["models"]]}
        step_done("observability")
        log(f"gateway: observability {json.dumps(result['observability'])}; seconds "
            f"by step {json.dumps(result['step_s'])}")
    finally:
        flight_recorder.disable()
        faults.clear("serve.forward")
        gw.stop()
        tmp.cleanup()
    result["launches"] = {"lrn_fwd": result["storm_launches"]["lrn_fwd"],
                          "int8_matmul": result["int8"]["launches"]["int8_matmul"],
                          "decode_attention": result["decode"]["launches"]["decode_attention"]}
    log(f"gateway: launches K1 {result['launches']['lrn_fwd']} (storm), K6 "
        f"{result['launches']['int8_matmul']} (int8 run), K7 "
        f"{result['launches']['decode_attention']} (/generate)  [{card}]")
    return result


# ------------------------------------------------------- bfloat16 AlexNet

def check_layers_one_by_one(torch, net, cpu_net, x):
    """Each layer of `net` on the card against the same layer of `cpu_net`
    (the same parameters) on the CPU, both fed the card's input to that
    layer, so that no difference carries from one layer to the next: within
    one bfloat16 ulp of the layer's largest value (BF16_ULP), where each
    side rounds its float32 sum once and a sum in another order can tip a
    rounding. An LRN layer within two: the CPU's plain LRN rounds each op to
    bfloat16, as the JAX package's `lrn_reference` does, and K1 rounds once
    (K1 itself is held within one ulp of its float32 yardstick by
    `checked_lrn`). Returns one record a layer."""
    from deeplearning4j_torch.nn.layers.convolution import LocalResponseNormalization
    out = []
    with torch.inference_mode():
        a = net._as_input(x)
        for i, layer in enumerate(net.layers):
            pre = net.conf.preprocessor(i)
            if pre is not None:
                a = pre(a)
            card = layer.forward(net.params_tree[i], a)
            cpu = layer.forward(cpu_net.params_tree[i], a.cpu())
            diff = (card.cpu().float() - cpu.float()).abs().max().item()
            top = max(card.float().abs().max().item(), cpu.float().abs().max().item())
            ulps = 2 if isinstance(layer, LocalResponseNormalization) else 1
            if not diff <= ulps * BF16_ULP * top:
                raise RuntimeError(f"layer {i} ({type(layer).__name__}): card and CPU "
                                   f"differ by {diff}, more than {ulps} bfloat16 ulp "
                                   f"of its largest value {top}")
            out.append({"layer": i, "kind": type(layer).__name__,
                        "dtype": str(card.dtype).replace("torch.", ""),
                        "max_abs_card_vs_cpu": diff, "max_abs": top,
                        "share_of_limit": diff / (ulps * BF16_ULP * top) if top else 0.0})
            a = card
    return out


def phase_bf16_alexnet(torch, card):
    """The JAX package's benchmark AlexNet in bfloat16 (bench.py's
    `AlexNet(num_labels=1000).init(dtype=jnp.bfloat16)`), at full width,
    through the entry points a user calls: `AlexNet().init(dtype=
    torch.bfloat16)` on CUDA by default, served by a BATCHED
    ParallelInference (batch_limit 32, the serving phase's client load) and
    trained by `fit` for TRAIN_STEPS steps at batch 128. Every LRN runs K1
    in bfloat16 and every LRN backward K2: the counts are reset just before
    the clients start and before `fit`, and read just after (K1 2 x
    executed forwards and no K2 in serving; K1 and K2 2 x steps in
    training). Every K1 call of the re-run batches and every K2 call of the
    steps is held to its float32 yardstick rounded once (`checked_lrn`,
    `checked_lrn_bwd`); each answer is bitwise the rows of its executed
    batch (`check_served_batches`); each layer of the card's forward
    against the CPU's on the same input (`check_layers_one_by_one`); the
    card's score of one batch against the CPU's from the same parameters
    (rtol 1e-2: bfloat16 activations summed in another order). Latencies
    come from a second, unchecked run of the same load; the step time from
    a second, unchecked epoch."""
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.models.zoo import AlexNet
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.ops import lrn as lrn_ops
    from deeplearning4j_torch.parallel.inference import (InferenceMode,
                                                          ParallelInference)
    t0 = time.perf_counter()
    net = AlexNet().init(dtype=torch.bfloat16)
    if {t.dtype for lp in net.params_tree for t in lp.values()} != {torch.bfloat16}:
        raise RuntimeError("AlexNet().init(dtype=torch.bfloat16) gave parameters "
                           "that are not bfloat16")
    it, classes = net.conf.input_type, net.layers[-1].n_out
    hwc = (it.height, it.width, it.channels)
    log(f"bf16 AlexNet: {hwc}/{classes}, {net.num_params()} params on {net.device}, "
        f"init {time.perf_counter() - t0:.2f} s")
    cpu_net = MultiLayerNetwork(net.conf).init(dtype=torch.bfloat16, device="cpu")
    cpu_net.params_tree = tuple({k: v.cpu() for k, v in layer.items()}
                                for layer in net.params_tree)
    result = {"card": card}

    # 1. serving
    reqs = serving_requests(np.random.default_rng(2026))
    images = sum(x.shape[0] for xs in reqs for x in xs)
    pi = ParallelInference(net, inference_mode=InferenceMode.BATCHED, batch_limit=32)
    batches = []
    try:
        pi.warmup()
        with recorded_outputs(net, batches):
            f0 = pi.total_forwards
            lrn_ops.launches = lrn_ops.bwd_launches = 0  # the main path's run starts here
            answers, _, _ = run_clients(pi, reqs)
            launches = {"lrn_fwd": lrn_ops.launches,
                        "lrn_bwd": lrn_ops.bwd_launches}  # ... and ends here
            forwards = pi.total_forwards - f0
        check_launches("bf16 serving", launches, {"lrn_fwd": 2 * forwards, "lrn_bwd": 0})
        f0 = pi.total_forwards
        lrn_ops.launches = 0
        _, lat, wall = run_clients(pi, reqs)
        check_launches("bf16 timed serving", {"lrn_fwd": lrn_ops.launches},
                       {"lrn_fwd": 2 * (pi.total_forwards - f0)})
    finally:
        pi.shutdown()
    if forwards < 1:
        raise RuntimeError("bf16 serving executed no forward")
    for (c, j), out in answers.items():
        if out.dtype != np.float32 or out.shape != (reqs[c][j].shape[0], classes) \
                or not np.isfinite(out).all():
            raise RuntimeError(f"bf16: bad answer {out.dtype} {out.shape}")
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
    lrn_stats = {"calls": 0, "max_abs_err": 0.0, "window_effect": 0.0,
                 "input_contiguous": []}
    with checked_lrn(torch, lrn_stats):
        result["batches_rechecked"] = check_served_batches(net, batches, reqs, answers)
    lrn_stats["input_contiguous"] = all(lrn_stats["input_contiguous"])
    del batches
    result["serving"] = {**latency_stats(lat, images, wall), "forwards": forwards,
                         "launches": launches, "lrn_in_forward": lrn_stats}
    layers = check_layers_one_by_one(torch, net, cpu_net, reqs[0][0])
    result["layers_vs_cpu"] = layers
    x32 = np.random.default_rng(2031).standard_normal((32,) + hwc).astype(np.float32)
    result["serving"]["profile"] = profile_call(
        torch, "forward bf16 AlexNet", lambda: net.output(x32), {"batch": 32})
    log(f"bf16 AlexNet serving: {json.dumps(result['serving'])}  [{card}]")
    log(f"bf16 AlexNet layers, card vs CPU: {json.dumps(layers)}")

    # 2. training
    rng = np.random.default_rng(2027)
    n = TRAIN_STEPS * TRAIN_BATCH
    x = rng.standard_normal((n,) + hwc, dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    steps = Steps()
    net.listeners[:] = [steps]
    stats = {"calls": 0, "max_abs_err": 0.0, "max_abs_dx": 0.0,
             "max_cross_term": 0.0, "cotangent_contiguous": []}
    with checked_lrn_bwd(torch, stats):
        lrn_ops.launches = lrn_ops.bwd_launches = 0  # the main path's run starts here
        net.fit(x, y, epochs=1, batch_size=TRAIN_BATCH)
        launches = {"lrn_fwd": lrn_ops.launches,
                    "lrn_bwd": lrn_ops.bwd_launches}  # ... and ends here
    want = 2 * TRAIN_STEPS
    check_launches("bf16 training", launches, {"lrn_fwd": want, "lrn_bwd": want})
    if net.iteration != TRAIN_STEPS or stats["calls"] != want \
            or not all(np.isfinite(steps.scores)) or len(steps.scores) != TRAIN_STEPS:
        raise RuntimeError(f"bf16 training: {net.iteration} steps, {stats['calls']} "
                           f"checked K2 calls, scores {steps.scores}")
    if {t.dtype for lp in net.params_tree for t in lp.values()} != {torch.bfloat16}:
        raise RuntimeError("bf16 training left parameters that are not bfloat16")
    stats["cotangent_contiguous"] = all(stats["cotangent_contiguous"])
    log(f"bf16 AlexNet training: scores {steps.scores}; launches {launches}; K2 on "
        f"the step's cotangents: {json.dumps(stats)}")
    # timing: another epoch over the same batches, unchecked
    steps = Steps()
    net.listeners[:] = [steps]
    lrn_ops.launches = lrn_ops.bwd_launches = 0
    t0 = time.perf_counter()
    net.fit(x, y, epochs=1, batch_size=TRAIN_BATCH)
    check_launches("bf16 timed training", {"lrn_fwd": lrn_ops.launches,
                                           "lrn_bwd": lrn_ops.bwd_launches},
                   {"lrn_fwd": want, "lrn_bwd": want})
    net.listeners.clear()
    step_ms = np.diff([t0] + steps.ends) * 1e3
    warm_ms = float(np.median(step_ms[1:]))
    # one batch's score, the card against the CPU from the same parameters
    cpu_net.params_tree = tuple({k: v.cpu() for k, v in layer.items()}
                                for layer in net.params_tree)
    ds = DataSet(x[:2], y[:2])
    before = (lrn_ops.launches, lrn_ops.bwd_launches)
    _, card_score = net.compute_gradient_and_score(ds)
    ran = (lrn_ops.launches - before[0], lrn_ops.bwd_launches - before[1])
    _, cpu_score = cpu_net.compute_gradient_and_score(ds)
    if ran != (2, 2) or not abs(card_score - cpu_score) <= 1e-2 * abs(cpu_score):
        raise RuntimeError(f"bf16 score: card {card_score} vs CPU {cpu_score}, "
                           f"K1 and K2 ran {ran} times")
    xb, yb = x[:TRAIN_BATCH], y[:TRAIN_BATCH]

    def one_step():
        net.fit(xb, yb, batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()

    result["training"] = {
        "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "launches": launches,
        "scores": steps.scores, "step_ms": step_ms.tolist(),
        "median_warm_step_ms": warm_ms, "images_per_s": TRAIN_BATCH / warm_ms * 1e3,
        "lrn_bwd_in_step": stats, "score_card": card_score, "score_cpu": cpu_score,
        "profile": profile_call(torch, "train step bf16 AlexNet", one_step,
                                {"batch": TRAIN_BATCH})}
    s = result["serving"]
    log(f"bf16 AlexNet: serving p50 {s['p50_ms']:.3f} ms p99 {s['p99_ms']:.3f} ms, "
        f"{s['images_per_s']:.1f} images/s, K1 {s['launches']['lrn_fwd']} launches in "
        f"{s['forwards']} forwards; training step ms {step_ms.tolist()}, median warm "
        f"{warm_ms:.3f} ms, {TRAIN_BATCH / warm_ms * 1e3:.1f} images/s, K1 "
        f"{launches['lrn_fwd']} and K2 {launches['lrn_bwd']} launches in {TRAIN_STEPS} "
        f"steps; score card {card_score:.6g} vs CPU {cpu_score:.6g}  [{card}]")
    return result


# ----------------------------------------- checkpoints and GoogLeNet (graph)

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
LENET_ZIP = os.path.join(FIXTURES, "pretrained", "lenet_mnist.zip")
GRAPH_MERGE_ZIP = os.path.join(FIXTURES, "checkpoints", "graph_merge.zip")
MLN_CNN_ZIP = os.path.join(FIXTURES, "checkpoints", "mln_cnn.zip")
CKPT_RTOL, CKPT_ATOL = 1e-5, 1e-6   # a restored net on the card vs the CPU or the fixture
GOOGLENET_BATCH, GOOGLENET_STEPS = 64, 6   # float32 training
# bfloat16 training: bench.py's bench_googlenet runs batch 512; cut to 128 for time
GOOGLENET_BF16_BATCH, GOOGLENET_BF16_STEPS = 128, 4
FUSED_RTOL, FUSED_ATOL = 1e-5, 1e-9   # fused sibling convs vs the unfused graph


def phase_checkpoint_fixtures(torch, card, device=None):
    """The JAX package's checkpoints restored by the port, on the card by
    default (`restore_model` with no device): `lenet_mnist.zip` against the
    same zip restored on the CPU (CKPT_RTOL/CKPT_ATOL, same top-1), and
    `graph_merge.zip` and `mln_cnn.zip` (BatchNormalization's running
    statistics in its state.npz, float32 on the card) against the fixture's
    expected answers (`expected.npz`); `mln_cnn.zip`'s NormalizerStandardize
    restores with its 144 means."""
    from deeplearning4j_torch.utils import model_serializer as ser
    lenet = ser.restore_model(LENET_ZIP, device=device)
    lenet_cpu = ser.restore_model(LENET_ZIP, device="cpu")
    x = np.random.default_rng(2033).standard_normal((16, 28, 28, 1)).astype(np.float32)
    got, want = lenet.output(x), lenet_cpu.output(x)
    np.testing.assert_allclose(got, want, rtol=CKPT_RTOL, atol=CKPT_ATOL)
    if not np.array_equal(got.argmax(-1), want.argmax(-1)):
        raise RuntimeError("restored LeNet: top-1 differs between the card and the CPU")
    graph = ser.restore_model(GRAPH_MERGE_ZIP, device=device)
    expected = np.load(os.path.join(FIXTURES, "checkpoints", "expected.npz"))
    out = graph.output(expected["graph_merge_x"])
    np.testing.assert_allclose(out, expected["graph_merge_y"], rtol=CKPT_RTOL,
                               atol=CKPT_ATOL)
    from deeplearning4j_torch.data.normalizers import NormalizerStandardize
    from deeplearning4j_torch.utils import params as param_utils
    cnn = ser.restore_model(MLN_CNN_ZIP, device=device)
    state = param_utils.tree_leaves(cnn.state_tree)
    if not state or {(t.dtype, t.device.type) for t in state} != \
            {(torch.float32, cnn.device.type)}:
        raise RuntimeError(f"mln_cnn.zip: layer state {[(t.dtype, t.device) for t in state]}")
    cnn_out = cnn.output(expected["mln_cnn_x"])
    np.testing.assert_allclose(cnn_out, expected["mln_cnn_y"], rtol=CKPT_RTOL,
                               atol=CKPT_ATOL)
    norm = ser.restore_normalizer(MLN_CNN_ZIP)
    if not isinstance(norm, NormalizerStandardize) or len(norm.mean) != 144:
        raise RuntimeError(f"mln_cnn.zip: normalizer {type(norm).__name__}")
    result = {"lenet_device": str(lenet.device), "graph_merge_device": str(graph.device),
              "lenet_iteration": lenet.iteration,
              "lenet_max_abs_card_vs_cpu": float(np.abs(got - want).max()),
              "graph_merge_iteration": graph.iteration,
              "graph_merge_max_abs_vs_expected": float(
                  np.abs(out - expected["graph_merge_y"]).max()),
              "mln_cnn_device": str(cnn.device), "mln_cnn_iteration": cnn.iteration,
              "mln_cnn_state_leaves": len(state),
              "mln_cnn_max_abs_vs_expected": float(
                  np.abs(cnn_out - expected["mln_cnn_y"]).max()),
              "mln_cnn_normalizer": [type(norm).__name__, len(norm.mean)],
              "card": card}
    log(f"checkpoints: {json.dumps(result)} (rtol {CKPT_RTOL}, atol {CKPT_ATOL})")
    return result


def _same_tree(a, b):
    """Two port trees with the same leaves, bitwise and of the same type."""
    import torch
    from deeplearning4j_torch.utils import params as param_utils
    la, lb = param_utils.tree_leaves(a), param_utils.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        for x, y in zip(la, lb))


def check_checkpoint_round_trip(net, x, label):
    """`save_model` then `restore_model` (onto the network's device): the
    parameters, optimizer state, layer state, iteration and epoch bitwise
    equal, and the answer on `x` bitwise equal (NaN where NaN: an
    untrained ResNet50 overflows in evaluation). The archive goes to a
    temporary directory under the checkout's build/, which .gitignore
    lists."""
    import tempfile
    from deeplearning4j_torch.utils import model_serializer as ser
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        path = os.path.join(d, "model.zip")
        t0 = time.perf_counter()
        ser.save_model(net, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = ser.restore_model(path, device=net.device)
        restore_s = time.perf_counter() - t0
    same = {"params": _same_tree(net.params_tree, back.params_tree),
            "opt_state": _same_tree(net.opt_state, back.opt_state),
            "state": _same_tree(net.state_tree, back.state_tree),
            "counters": (back.iteration, back.epoch) == (net.iteration, net.epoch),
            "dtype": back._dtype == net._dtype,
            "output": bool(np.array_equal(net.output(x), back.output(x),
                                          equal_nan=True))}
    if not all(same.values()):
        raise RuntimeError(f"{label}: the checkpoint round trip is not bitwise: {same}")
    out = {"bytes": size, "save_s": save_s, "restore_s": restore_s,
           "iteration": net.iteration, "epoch": net.epoch,
           "dtype": str(net._dtype).replace("torch.", ""), "bitwise": same}
    log(f"{label}: checkpoint round trip {json.dumps(out)}")
    return out


def forward_ms(torch, net, x):
    """CUDA-event time of one inference walk of a single-input graph on
    `x` already on the device: back-to-back walks with no host copy (its
    `output` ends in a copy to the host, which would time the host too)."""
    xt = torch.as_tensor(x, device=net.device)
    name = net.conf.network_inputs[0]

    def walk():
        with torch.inference_mode():
            net._walk(net.params_tree, net.state_tree, {name: xt})

    return cuda_time_ms(walk, iters=5, warm=2)


def _graph_shape(net):
    it = net.conf.input_types[0]
    return (it.height, it.width, it.channels), net.conf.nodes["output"].layer.n_out


def _to_cpu_graph(net):
    """A ComputationGraph on the CPU with `net`'s parameters and layer
    state."""
    from deeplearning4j_torch.nn.graph.graph import ComputationGraph
    cpu = ComputationGraph(net.conf).init(dtype=net._dtype, device="cpu")
    cpu.params_tree, cpu.state_tree = (
        {n: {k: v.cpu() for k, v in lp.items()} for n, lp in tree.items()}
        for tree in (net.params_tree, net.state_tree))
    return cpu


def phase_googlenet_serving(torch, card):
    """Zoo GoogLeNet at full width (224x224x3, 1000 classes, random weights
    from its seed), a ComputationGraph, `GoogLeNet().init()` on CUDA by
    default, behind a BATCHED ParallelInference (batch_limit 32) with the
    AlexNet phases' client load, float32 (TF32 off). The counts are reset
    just before the clients start and read just after: K1 2 x executed
    forwards (lrn1 [b, 56, 56, 64], lrn2 [b, 56, 56, 192]), no K2. Each
    answer is bitwise the rows of its executed batch, and each executed
    batch's `output` is taken again with every K1 call held to the plain
    version (`check_served_batches` inside `checked_lrn`). A batch of 2 on
    the card against the CPU path (SERVE_RTOL/SERVE_ATOL, same top-1), which
    tests/test_torch_graph.py holds to the JAX package. Latencies come from
    a second, unchecked run of the same load; one bucket-32 forward is
    profiled. Then `GoogLeNet(fuse_siblings=True)` carrying the same
    parameters by `fuse_params` answers within FUSED_RTOL of the unfused
    graph (cuDNN may sum the wider conv in another order)."""
    from deeplearning4j_torch.models.zoo import GoogLeNet
    from deeplearning4j_torch.nn.graph.fusion import fuse_params, fuse_sibling_convs
    from deeplearning4j_torch.ops import lrn as lrn_ops
    from deeplearning4j_torch.parallel.inference import (InferenceMode,
                                                          ParallelInference)
    t0 = time.perf_counter()
    net = GoogLeNet(num_labels=1000).init()
    hwc, classes = _graph_shape(net)
    log(f"GoogLeNet: {hwc}/{classes}, {len(net.conf.nodes)} nodes, "
        f"{net.num_params()} params on {net.device}, init "
        f"{time.perf_counter() - t0:.2f} s")
    reqs = serving_requests(np.random.default_rng(2034))
    images = sum(x.shape[0] for xs in reqs for x in xs)
    pi = ParallelInference(net, inference_mode=InferenceMode.BATCHED, batch_limit=32)
    batches = []
    try:
        pi.warmup()
        with recorded_outputs(net, batches):
            f0 = pi.total_forwards
            lrn_ops.launches = lrn_ops.bwd_launches = 0  # the main path's run starts here
            answers, _, _ = run_clients(pi, reqs)
            launches = {"lrn_fwd": lrn_ops.launches,
                        "lrn_bwd": lrn_ops.bwd_launches}  # ... and ends here
            forwards = pi.total_forwards - f0
        check_launches("GoogLeNet serving", launches,
                       {"lrn_fwd": 2 * forwards, "lrn_bwd": 0})
        f0 = pi.total_forwards
        lrn_ops.launches = 0
        _, lat, wall = run_clients(pi, reqs)
        check_launches("GoogLeNet timed serving", {"lrn_fwd": lrn_ops.launches},
                       {"lrn_fwd": 2 * (pi.total_forwards - f0)})
    finally:
        pi.shutdown()
    if forwards < 1:
        raise RuntimeError("GoogLeNet serving executed no forward")
    for (c, j), out in answers.items():
        if out.shape != (reqs[c][j].shape[0], classes) or not np.isfinite(out).all():
            raise RuntimeError(f"GoogLeNet: bad answer {out.shape}")
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
    lrn_stats = {"calls": 0, "max_abs_err": 0.0, "window_effect": 0.0,
                 "input_contiguous": []}
    with checked_lrn(torch, lrn_stats):
        rechecked = check_served_batches(net, batches, reqs, answers)
    if lrn_stats["calls"] != 2 * rechecked:
        raise RuntimeError(f"checked {lrn_stats['calls']} LRN calls in {rechecked} "
                           f"batches, expected 2 a batch")
    lrn_stats["input_contiguous"] = all(lrn_stats["input_contiguous"])
    del batches
    rng = np.random.default_rng(2035)
    x2 = rng.standard_normal((2,) + hwc).astype(np.float32)
    cpu_net = _to_cpu_graph(net)
    card_out, cpu_out = net.output(x2), cpu_net.output(x2)
    del cpu_net
    np.testing.assert_allclose(card_out, cpu_out, rtol=SERVE_RTOL, atol=SERVE_ATOL)
    if not np.array_equal(card_out.argmax(-1), cpu_out.argmax(-1)):
        raise RuntimeError("GoogLeNet: top-1 differs between the card and the CPU")
    x32 = rng.standard_normal((32,) + hwc).astype(np.float32)
    profile = profile_call(torch, "forward GoogLeNet", lambda: net.output(x32),
                           {"batch": 32})
    # the sibling-fused graph with the same parameters
    _, groups = fuse_sibling_convs(net.conf)
    fused = GoogLeNet(num_labels=classes, fuse_siblings=True).init()
    fused.params_tree = fuse_params(groups, net.params_tree)
    want = net.output(x32)
    got = fused.output(x32)
    np.testing.assert_allclose(got, want, rtol=FUSED_RTOL, atol=FUSED_ATOL)
    fused_ms = forward_ms(torch, fused, x32)
    unfused_ms = forward_ms(torch, net, x32)
    del fused, net
    result = {**latency_stats(lat, images, wall), "forwards": forwards,
              "launches": launches, "batches_rechecked": rechecked,
              "lrn_in_forward": lrn_stats,
              "max_abs_card_vs_cpu_b2": float(np.abs(card_out - cpu_out).max()),
              "fused_groups": len(groups),
              "fused_max_abs_vs_unfused": float(np.abs(got - want).max()),
              "fused_forward_ms_b32": fused_ms, "unfused_forward_ms_b32": unfused_ms,
              "profile": profile, "card": card}
    log(f"GoogLeNet serving: p50 {result['p50_ms']:.3f} ms p99 {result['p99_ms']:.3f} "
        f"ms, {result['images_per_s']:.1f} images/s, K1 {launches['lrn_fwd']} launches "
        f"in {forwards} forwards; fused {len(groups)} groups, max abs "
        f"{result['fused_max_abs_vs_unfused']:.3e} (rtol {FUSED_RTOL})  [{card}]")
    log(f"GoogLeNet serving: {json.dumps(result)}")
    return result


def phase_googlenet_training(torch, card):
    """Zoo GoogLeNet at full width trained by `fit`: GOOGLENET_STEPS steps at
    batch GOOGLENET_BATCH, float32 (TF32 off), Nesterovs(1e-2, 0.9) with l2
    2e-4 and dropout 0.4 on fc1's input, as the zoo builds it. The counts are
    reset just before `fit` and read just after: K1 and K2 2 x steps each,
    every K2 call held to the plain backward on its real cotangents. The
    median warm step from a second, unchecked epoch. Gradients card vs CPU
    at batch 2 per parameter under GRAD_REL, the CPU run pinned to the
    card's ReLU and max-pool decisions (`pinned_kinks`,
    `compare_pinned_grads`; train=False, so no dropout). Then a
    checkpoint round trip of the trained network, bitwise. Then a bfloat16
    GoogLeNet (bench.py's type), GOOGLENET_BF16_STEPS steps at batch
    GOOGLENET_BF16_BATCH with every K1 and K2 call within one bfloat16 ulp
    of its float32 yardstick (`checked_lrn`, `checked_lrn_bwd`), its scores
    finite, and its checkpoint round trip bitwise too."""
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.models.zoo import GoogLeNet
    from deeplearning4j_torch.ops import lrn as lrn_ops
    from deeplearning4j_torch.utils import params as param_utils
    t0 = time.perf_counter()
    net = GoogLeNet(num_labels=1000).init()
    hwc, classes = _graph_shape(net)
    log(f"GoogLeNet training: {net.num_params()} params on {net.device}, init "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(2036)
    n = GOOGLENET_STEPS * GOOGLENET_BATCH
    x = rng.standard_normal((n,) + hwc, dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]

    steps = Steps()
    net.listeners[:] = [steps]
    stats = {"calls": 0, "max_abs_err": 0.0, "max_abs_dx": 0.0,
             "max_cross_term": 0.0, "cotangent_contiguous": []}
    with checked_lrn_bwd(torch, stats):
        lrn_ops.launches = lrn_ops.bwd_launches = 0  # the main path's run starts here
        net.fit(x, y, epochs=1, batch_size=GOOGLENET_BATCH)
        launches = {"lrn_fwd": lrn_ops.launches,
                    "lrn_bwd": lrn_ops.bwd_launches}  # ... and ends here
    want = 2 * GOOGLENET_STEPS
    check_launches("GoogLeNet training", launches, {"lrn_fwd": want, "lrn_bwd": want})
    if net.iteration != GOOGLENET_STEPS or stats["calls"] != want \
            or len(steps.scores) != GOOGLENET_STEPS or not all(np.isfinite(steps.scores)):
        raise RuntimeError(f"GoogLeNet training: {net.iteration} steps, "
                           f"{stats['calls']} checked K2 calls, scores {steps.scores}")
    stats["cotangent_contiguous"] = all(stats["cotangent_contiguous"])
    log(f"GoogLeNet training: scores {steps.scores}; launches {launches}; K2 on the "
        f"step's cotangents: {json.dumps(stats)}")
    # timing: another epoch over the same batches, unchecked
    steps = Steps()
    net.listeners[:] = [steps]
    lrn_ops.launches = lrn_ops.bwd_launches = 0
    t0 = time.perf_counter()
    net.fit(x, y, epochs=1, batch_size=GOOGLENET_BATCH)
    check_launches("GoogLeNet timed training", {"lrn_fwd": lrn_ops.launches,
                                                "lrn_bwd": lrn_ops.bwd_launches},
                   {"lrn_fwd": want, "lrn_bwd": want})
    net.listeners.clear()
    step_ms = np.diff([t0] + steps.ends) * 1e3
    warm_ms = float(np.median(step_ms[1:]))

    def grads(model):
        def run(ds, record, flips):
            before = (lrn_ops.launches, lrn_ops.bwd_launches)
            with pinned_kinks(torch, model, record, flips):
                out = model.compute_gradient_and_score(ds)
            ran = (lrn_ops.launches - before[0], lrn_ops.bwd_launches - before[1])
            if model.device.type == "cuda" and ran != (2, 2):
                raise RuntimeError(f"compute_gradient_and_score ran K1 and K2 {ran} times")
            return out
        return run

    # Every draw of 2 images flips 11 to 20 of GoogLeNet's ReLU zeros and
    # pool choices between the card and the CPU, so the CPU run takes the
    # card's decisions (`pinned_kinks`), and the flips are counted.
    cpu_net = _to_cpu_graph(net)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        vs_cpu = compare_pinned_grads("GoogLeNet: card vs CPU path, batch 2", torch,
                                      param_utils, grads(net), grads(cpu_net),
                                      DataSet(x[:2], y[:2]))
    finally:
        torch.backends.cudnn.deterministic = det
    del cpu_net
    xb, yb = x[:GOOGLENET_BATCH], y[:GOOGLENET_BATCH]

    def one_step():
        net.fit(xb, yb, batch_size=GOOGLENET_BATCH)
        torch.cuda.synchronize()

    profile = profile_call(torch, "train step GoogLeNet", one_step,
                           {"batch": GOOGLENET_BATCH})
    ckpt = check_checkpoint_round_trip(net, x[:8], "GoogLeNet float32")
    result = {"steps": GOOGLENET_STEPS, "batch": GOOGLENET_BATCH, "launches": launches,
              "scores": steps.scores, "step_ms": step_ms.tolist(),
              "median_warm_step_ms": warm_ms,
              "images_per_s": GOOGLENET_BATCH / warm_ms * 1e3,
              "lrn_bwd_in_step": stats, "grad_rel_vs_cpu": vs_cpu,
              "profile": profile, "checkpoint": ckpt, "card": card}
    log(f"GoogLeNet training: step ms {step_ms.tolist()}, median warm {warm_ms:.3f} ms, "
        f"{result['images_per_s']:.1f} images/s, K1 {launches['lrn_fwd']} and K2 "
        f"{launches['lrn_bwd']} launches in {GOOGLENET_STEPS} steps  [{card}]")
    del net, x, y, xb, yb
    torch.cuda.empty_cache()

    # bfloat16, bench.py's type
    net = GoogLeNet(num_labels=classes).init(dtype=torch.bfloat16)
    if {t.dtype for t in param_utils.tree_leaves(net.params_tree)} != {torch.bfloat16}:
        raise RuntimeError("GoogLeNet().init(dtype=torch.bfloat16) gave parameters "
                           "that are not bfloat16")
    n = GOOGLENET_BF16_STEPS * GOOGLENET_BF16_BATCH
    x = rng.standard_normal((n,) + hwc, dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    steps = Steps()
    net.listeners[:] = [steps]
    fwd_stats = {"calls": 0, "max_abs_err": 0.0, "window_effect": 0.0,
                 "input_contiguous": []}
    bwd_stats = {"calls": 0, "max_abs_err": 0.0, "max_abs_dx": 0.0,
                 "max_cross_term": 0.0, "cotangent_contiguous": []}
    with checked_lrn(torch, fwd_stats), checked_lrn_bwd(torch, bwd_stats):
        lrn_ops.launches = lrn_ops.bwd_launches = 0  # the bfloat16 run starts here
        net.fit(x, y, epochs=1, batch_size=GOOGLENET_BF16_BATCH)
        launches16 = {"lrn_fwd": lrn_ops.launches,
                      "lrn_bwd": lrn_ops.bwd_launches}  # ... and ends here
    want = 2 * GOOGLENET_BF16_STEPS
    check_launches("GoogLeNet bfloat16 training", launches16,
                   {"lrn_fwd": want, "lrn_bwd": want})
    if fwd_stats["calls"] != want or bwd_stats["calls"] != want \
            or len(steps.scores) != GOOGLENET_BF16_STEPS or not all(np.isfinite(steps.scores)):
        raise RuntimeError(f"GoogLeNet bfloat16: {fwd_stats['calls']} and "
                           f"{bwd_stats['calls']} checked K1 and K2 calls, scores "
                           f"{steps.scores}")
    net.listeners.clear()
    for st, key in ((fwd_stats, "input_contiguous"), (bwd_stats, "cotangent_contiguous")):
        st[key] = all(st[key])
    result["bf16"] = {
        "steps": GOOGLENET_BF16_STEPS, "batch": GOOGLENET_BF16_BATCH,
        "launches": launches16, "scores": steps.scores,
        "lrn_in_forward": fwd_stats, "lrn_bwd_in_step": bwd_stats,
        "checked_step_ms": (np.diff(steps.ends) * 1e3).tolist(),
        "checkpoint": check_checkpoint_round_trip(net, x[:8], "GoogLeNet bfloat16")}
    log(f"GoogLeNet bfloat16 training: {json.dumps(result['bf16'])}  [{card}]")
    del net, x, y
    torch.cuda.empty_cache()
    return result


# ------------------------------------------- ResNet50 (BatchNormalization)

RESNET_BATCH, RESNET_STEPS = 128, 6   # float32 training
# bfloat16 training: bench.py's bench_resnet50 runs batch 1024; cut to 256
# for time and memory
RESNET_BF16_BATCH, RESNET_BF16_STEPS = 256, 4
# BN running statistics against a plain float64 recompute of the batch's
# (a mean's error over the larger of |mean| and the batch's std), and the
# card's new state against the CPU's
STATE_RTOL = 1e-5


def all_launches():
    """Every hand-written kernel's launch count: K1-K7 and the sliced and
    bfloat16-accumulator arms of K3-K5 and K7."""
    from deeplearning4j_torch.ops import flash_attention as fa
    from deeplearning4j_torch.ops import lrn as lrn_ops
    from deeplearning4j_torch.ops import quant_matmul as qmm
    return {"lrn_fwd": lrn_ops.launches, "lrn_bwd": lrn_ops.bwd_launches,
            **_counts(fa), "int8_matmul": qmm.launches,
            "decode_attention": fa.decode_launches, **_wide_counts(fa)}


def zero_launches():
    from deeplearning4j_torch.ops import flash_attention as fa
    from deeplearning4j_torch.ops import lrn as lrn_ops
    from deeplearning4j_torch.ops import quant_matmul as qmm
    lrn_ops.launches = lrn_ops.bwd_launches = qmm.launches = 0
    fa.decode_launches = 0
    _zero_counts(fa)
    fa.fwd_wide_launches = fa.bwd_dkv_wide_launches = fa.bwd_dq_wide_launches = 0
    fa.bwd_dkv_acc16_launches = fa.bwd_dq_acc16_launches = fa.decode_wide_launches = 0


def bn_nodes(net):
    """{id(layer): node name} of a graph's BatchNormalization nodes."""
    from deeplearning4j_torch.nn.layers.convolution import BatchNormalization
    return {id(node.layer): name for name, node in net.conf.nodes.items()
            if node.is_layer() and isinstance(node.layer, BatchNormalization)}


@contextmanager
def recorded_bn_stats(torch, records, active):
    """While `active[0]`, append (layer, state in, batch mean, batch
    variance) for every train-mode BatchNormalization call in the block:
    the statistics of its input recomputed plainly, in float64 and two
    passes (the biased variance), on the input's device."""
    from deeplearning4j_torch.nn.layers.convolution import BatchNormalization
    fwd = BatchNormalization.forward_with_state

    def forward_with_state(self, params, state, x, *, train=False, **kw):
        if train and active[0]:
            with torch.no_grad():
                xd = x.detach().double().reshape(-1, x.shape[-1])
                mean = xd.mean(0)
                records.append((self, state, mean, ((xd - mean) ** 2).mean(0)))
        return fwd(self, params, state, x, train=train, **kw)

    with patched(BatchNormalization, "forward_with_state", forward_with_state):
        yield


def state_rel_err(torch, got, want_mean, want_var):
    """The largest error of a BN state {"mean", "var"} against float64
    (mean, var): a mean's over the larger of |mean| and the std, a
    variance's relative."""
    mean, var = got["mean"].double().to(want_mean.device), got["var"].double().to(
        want_var.device)
    e_mean = ((mean - want_mean).abs()
              / torch.maximum(want_mean.abs(), want_var.sqrt())).max().item()
    return max(e_mean, ((var - want_var).abs() / want_var).max().item())


def check_first_step_state(torch, net, records, state1):
    """The state the first step committed (`state1`) against the running
    update of each BN's plainly recomputed batch statistics:
    decay * state in + (1 - decay) * batch, under STATE_RTOL. Returns the
    worst error."""
    names = bn_nodes(net)
    if sorted(names[id(layer)] for layer, *_ in records) != sorted(names.values()):
        raise RuntimeError(f"recorded {len(records)} BN calls in the first step, "
                           f"expected one for each of {len(names)} BN nodes")
    worst, at, ratio = 0.0, None, None
    for layer, old, mean, var in records:
        d = layer.decay
        err = state_rel_err(torch, state1[names[id(layer)]],
                            d * old["mean"].double() + (1 - d) * mean,
                            d * old["var"].double() + (1 - d) * var)
        if err > worst:
            # the single-pass variance cancels as (|mean - pivot| / std)^2
            pivot = old["mean"].double().to(mean.device)
            worst, at = err, names[id(layer)]
            ratio = ((mean - pivot).abs() / var.sqrt()).max().item()
    if not worst <= STATE_RTOL:
        raise RuntimeError(f"the first step's BN state differs from a plain recompute "
                           f"by {worst} at {at} (> {STATE_RTOL})")
    return {"worst": worst, "at": at, "max_mean_off_pivot_over_std": ratio}


class StateSteps:
    """Listener: after each step, whether every running statistic moved
    from the step before, and (the first time) the state then, which also
    ends `recorded_bn_stats`' recording."""

    def __init__(self, torch, net, active):
        self.torch, self.prev, self.active = torch, net.state_tree, active
        self.moved, self.first = [], None

    def iteration_done(self, model, iteration):
        cur = model.state_tree
        self.moved.append(all(not self.torch.equal(cur[n][k], self.prev[n][k])
                              for n in cur for k in cur[n]))
        if self.first is None:
            self.first, self.active[0] = cur, False
        self.prev = cur


def check_state_float32(torch, net, label):
    leaves = [t for n in net.state_tree.values() for t in n.values()]
    if {t.dtype for t in leaves} != {torch.float32} or \
            not all(bool(torch.isfinite(t).all()) for t in leaves):
        raise RuntimeError(f"{label}: the BN state is not float32 and finite")
    return len(leaves)


def train_mode_grads(torch, model, new_states):
    """A `compare_pinned_grads` run of one train-mode step's gradients
    (batch statistics, as `fit` takes them; no dropout in ResNet50), its
    new layer state appended to `new_states`."""
    def run(ds, record, flips):
        inputs, labels, fm, lm = model._pack(model._coerce(ds))
        with pinned_kinks(torch, model, record, flips):
            loss, grads, new_state = model._value_and_grad(inputs, labels, fm, lm,
                                                           True, None)
        new_states.append(new_state)
        return grads, float(loss)
    return run


def bn_pass_ms(torch, net, x, train):
    """The BatchNormalization passes of one step (`train`: forward and
    backward with batch statistics) or one forward (running statistics) on
    `x`, timed alone: every BN layer at the shape and type one walk gives
    it, by `device_ms` (device time: the host's launches hidden behind a
    sleep), summed. With the bytes that step must move at least (each BN
    input read and output written once, and in training the cotangent read
    and dx written once) over HBM_BYTES_PER_S."""
    from deeplearning4j_torch.nn.layers.convolution import BatchNormalization
    calls, fwd = [], BatchNormalization.forward_with_state

    def recording(self, params, state, xx, **kw):
        calls.append((self, params, state, tuple(xx.shape), xx.dtype))
        return fwd(self, params, state, xx, **kw)

    with patched(BatchNormalization, "forward_with_state", recording), \
            torch.inference_mode():
        inputs, _ = net._pack_inputs([x])
        net._walk(net.params_tree, net.state_tree, inputs, train=train)
    total, nbytes = 0.0, 0
    gen = torch.Generator(device=net.device).manual_seed(7)
    for layer, params, state, shape, dtype in calls:
        xx = torch.randn(shape, generator=gen, device=net.device).to(dtype)
        elem = xx.element_size() * xx.numel()
        if train:
            xx.requires_grad_()
            p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
            g = torch.randn(shape, generator=gen, device=net.device).to(dtype)

            def run():
                y, _ = layer.forward_with_state(p, state, xx, train=True)
                torch.autograd.backward(y, g)
            nbytes += 4 * elem
        else:
            def run():
                with torch.inference_mode():
                    layer.forward_with_state(params, state, xx)
            nbytes += 2 * elem
        total += device_ms(torch, run, iters=5)
    return {"bn_layers": len(calls), "ms": total,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def share_of_busy(ms, profile):
    """`ms` over the profiled call's device-busy time, where it has one."""
    busy = profile.get("device_busy_ms")
    return ms / busy if busy else None


def h2d_copy_ms(torch, x):
    """CUDA-event time of the host-to-device copy of the numpy batch `x` as
    `fit` and `output` make it (from pageable memory), the median of 3:
    the profiler's trace does not always hold the copy."""
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.as_tensor(x, device="cuda")
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def resnet_grads_vs_cpu(torch, net, x, y):
    """Train-mode gradients card vs CPU on the batch (x, y) at the network's
    present state (`compare_pinned_grads`, the CPU pinned to the card's ReLU
    and max-pool decisions, cuDNN deterministic), each node's limit scaled
    by the BN cancellation it passes back through (`bn_grad_factors`); and
    the new BN state of that step card vs CPU under STATE_RTOL. Returns
    (the comparison, the state's error)."""
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.utils import params as param_utils
    cpu_net = _to_cpu_graph(net)
    new_states = []
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        factors, own = bn_grad_factors(torch, net, x)
        vs_cpu = compare_pinned_grads("ResNet50: card vs CPU path, train mode, batch 2",
                                      torch, param_utils,
                                      train_mode_grads(torch, net, new_states),
                                      train_mode_grads(torch, cpu_net, new_states),
                                      DataSet(x, y),
                                      structural_zeros=zero_by_structure(net),
                                      limit_factors=factors)
    finally:
        torch.backends.cudnn.deterministic = det
    vs_cpu["bn_factor_max"] = max(factors.values())
    del cpu_net
    card_state, cpu_state = new_states
    state_err, state_share = 0.0, 0.0
    for nm in cpu_state:
        if not cpu_state[nm]:
            continue
        err = state_rel_err(torch, card_state[nm], cpu_state[nm]["mean"].double(),
                            cpu_state[nm]["var"].double())
        if not err <= STATE_RTOL * own[nm]:
            raise RuntimeError(f"ResNet50: the step's new BN state card vs CPU differs "
                               f"by {err} at {nm} (> {STATE_RTOL} x {own[nm]})")
        state_err = max(state_err, err)
        state_share = max(state_share, err / (STATE_RTOL * own[nm]))
    vs_cpu["new_state_share_of_limit"] = state_share
    return vs_cpu, state_err


def phase_resnet_training(torch, card):
    """Zoo ResNet50 at full width (224x224x3, 1000 classes, 53 BN nodes, 16
    shortcut adds; random weights from its seed), `ResNet50().init()` on
    CUDA by default, trained by `fit` for RESNET_STEPS steps at batch
    RESNET_BATCH, float32 with TF32 off, RmsProp(0.1, 0.96, 1e-3), l1 and
    l2 as the zoo builds it. The first two epochs run with cuDNN's
    deterministic algorithms, so the state they leave is the same in every
    run (RmsProp at lr 0.1 trains it chaotically: a state reached by
    nondeterministic steps differed from run to run, and so did the
    gradient check on it). Every
    kernel count is reset just before `fit` and read just after:
    ResNet50's path runs none of K1-K7 (its BN, zero padding, adds and
    pools are plain torch, as plain XLA in the JAX package). The state tree
    moves on every step; the first step's state is held to a plain float64
    recompute of each BN's batch statistics on the card
    (`check_first_step_state`, STATE_RTOL). On the state the two epochs
    leave, train-mode gradients card vs CPU at batch 2 (batch statistics) per
    parameter under GRAD_REL times the BN cancellation each node's gradient
    passes back through, with the CPU run pinned to the card's ReLU and
    max-pool decisions, and the new state of that step card vs CPU under
    STATE_RTOL times each BN's own cancellation (`resnet_grads_vs_cpu`).
    The median warm step from a third, unchecked epoch with cuDNN's
    defaults; one profiled step, and the BN passes timed alone
    (`bn_pass_ms`). Then a checkpoint round trip, bitwise, BN state
    included. Returns the result and the trained network."""
    from deeplearning4j_torch.models.zoo import ResNet50
    t0 = time.perf_counter()
    net = ResNet50(num_labels=1000).init()
    hwc, classes = _graph_shape(net)
    kinds = [type(n.layer if n.is_layer() else n.vertex).__name__
             for n in net.conf.nodes.values()]
    shape = {"nodes": len(kinds), "bn": kinds.count("BatchNormalization"),
             "adds": kinds.count("ElementWiseVertex"), "params": net.num_params()}
    log(f"ResNet50: {hwc}/{classes}, {json.dumps(shape)} on {net.device}, init "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(2040)
    n = RESNET_STEPS * RESNET_BATCH
    x = rng.standard_normal((n,) + hwc, dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]

    steps, active, records = Steps(), [True], []
    moved = StateSteps(torch, net, active)
    net.listeners[:] = [steps, moved]
    with recorded_bn_stats(torch, records, active), _Deterministic(torch):
        zero_launches()   # the main path's run starts here
        net.fit(x, y, epochs=1, batch_size=RESNET_BATCH)
        launches = all_launches()   # ... and ends here
    check_launches("ResNet50 training", launches, dict.fromkeys(launches, 0))
    if net.iteration != RESNET_STEPS or len(steps.scores) != RESNET_STEPS \
            or not all(np.isfinite(steps.scores)):
        raise RuntimeError(f"ResNet50 training: {net.iteration} steps, scores "
                           f"{steps.scores}")
    if not all(moved.moved):
        raise RuntimeError(f"ResNet50: the BN state did not move on every step: "
                           f"{moved.moved}")
    first_step = check_first_step_state(torch, net, records, moved.first)
    del records, moved
    log(f"ResNet50 training: scores {steps.scores}; launches {launches}; first "
        f"step's BN state vs a float64 recompute {json.dumps(first_step)} "
        f"(limit {STATE_RTOL})")
    # the state the gradient check reads: a second epoch, deterministic too
    with _Deterministic(torch):
        net.fit(x, y, epochs=1, batch_size=RESNET_BATCH)
    vs_cpu, state_err = resnet_grads_vs_cpu(torch, net, x[:2], y[:2])
    # timing: another epoch over the same batches with cuDNN's defaults
    steps = Steps()
    net.listeners[:] = [steps]
    zero_launches()
    t0 = time.perf_counter()
    net.fit(x, y, epochs=1, batch_size=RESNET_BATCH)
    check_launches("ResNet50 timed training", all_launches(),
                   dict.fromkeys(launches, 0))
    net.listeners.clear()
    step_ms = np.diff([t0] + steps.ends) * 1e3
    warm_ms = float(np.median(step_ms[1:]))
    xb, yb = x[:RESNET_BATCH], y[:RESNET_BATCH]

    def one_step():
        net.fit(xb, yb, batch_size=RESNET_BATCH)
        torch.cuda.synchronize()

    profile = profile_call(torch, "train step ResNet50", one_step,
                           {"batch": RESNET_BATCH})
    profile["h2d_copy_ms_by_events"] = h2d_copy_ms(torch, xb)
    bn = bn_pass_ms(torch, net, xb, train=True)
    bn["share_of_busy"] = share_of_busy(bn["ms"], profile)
    log(f"ResNet50 training: BN passes alone {json.dumps(bn)}")

    ckpt = check_checkpoint_round_trip(net, x[:8], "ResNet50 float32")
    result = {"shape": shape, "steps": RESNET_STEPS, "batch": RESNET_BATCH,
              "launches": launches, "scores": steps.scores,
              "step_ms": step_ms.tolist(), "median_warm_step_ms": warm_ms,
              "images_per_s": RESNET_BATCH / warm_ms * 1e3,
              "first_step_state": first_step,
              "grad_rel_vs_cpu": vs_cpu, "new_state_err_vs_cpu": state_err,
              "bn_passes": bn, "profile": profile, "checkpoint": ckpt, "card": card}
    busy = profile.get("device_busy_ms")
    result["h2d_share_of_busy"] = share_of_busy(profile["h2d_copy_ms_by_events"],
                                                profile)
    log(f"ResNet50 training: step ms {step_ms.tolist()}, median warm {warm_ms:.3f} "
        f"ms, {result['images_per_s']:.1f} images/s; one step busy {busy} ms, idle "
        f"{profile.get('device_idle_share')}, H2D {profile['h2d_copy_ms_by_events']:.3f} "
        f"ms ({result['h2d_share_of_busy']} of busy), BN passes {bn['ms']:.3f} ms "
        f"alone ({bn['share_of_busy']} of busy); new state card vs CPU "
        f"{state_err:.3e}  [{card}]")
    del x, y, xb, yb
    return result, net


def calibrate_bn(torch, net, x):
    """Every BN's running statistics set to the batch statistics of one
    train-mode forward of `x` through the network's own walk, with each
    layer's decay at 0 for that forward."""
    from deeplearning4j_torch.nn.layers.convolution import BatchNormalization
    with ExitStack() as stack:
        for node in net.conf.nodes.values():
            if node.is_layer() and isinstance(node.layer, BatchNormalization):
                stack.enter_context(patched(node.layer, "decay", 0.0))
        with torch.inference_mode():
            inputs, _ = net._pack_inputs([x])
            _, _, net.state_tree = net._walk(net.params_tree, net.state_tree,
                                             inputs, train=True)


def phase_resnet_serving(torch, card, net):
    """The trained float32 ResNet50 behind a BATCHED ParallelInference
    (batch_limit 32, check_finite=True) with the AlexNet phases' client
    load, TF32 off, on its running statistics. Six steps leave them far
    from the statistics of the later layers' inputs, and a ResNet50 with
    normal(0, 0.5) weights overflows in evaluation without them (the JAX
    package's tests/test_zoo.py says so): if the trained state does not
    give finite answers on a probe batch, each BN's state is first set
    from one train-mode forward of a calibration batch (`calibrate_bn`),
    and the phase says which it took. Every kernel count is reset just
    before the clients start and read just after: none runs. Each answer
    finite and bitwise the rows of its executed batch; a batch of 2 on the
    card against the CPU path (SERVE_RTOL/SERVE_ATOL, same top-1);
    latencies from a second, unchecked run; one bucket-32 forward profiled
    and its BN passes timed alone."""
    hwc, classes = _graph_shape(net)
    rng = np.random.default_rng(2041)
    xcal = rng.standard_normal((32,) + hwc).astype(np.float32)
    probe = net.output(xcal[:8])
    trained_state_finite = bool(np.isfinite(probe).all())
    if not trained_state_finite:
        calibrate_bn(torch, net, xcal)
    log(f"ResNet50 serving: the trained running statistics give "
        f"{'finite' if trained_state_finite else 'non-finite'} answers on a probe "
        f"batch; {'served as trained' if trained_state_finite else 'BN state set from a train-mode forward of a calibration batch of 32'}")
    served, answers = serve_checked(torch, net,
                                    serving_requests(np.random.default_rng(2042)),
                                    "ResNet50 serving", check_finite=True)
    if any(out.shape[1:] != (classes,) for out in answers.values()):
        raise RuntimeError("ResNet50: an answer of another shape than [rows, classes]")
    x2 = rng.standard_normal((2,) + hwc).astype(np.float32)
    cpu_net = _to_cpu_graph(net)
    card_out, cpu_out = net.output(x2), cpu_net.output(x2)
    # the softmax of random weights saturates, so hold the features that
    # feed it too
    card_feat = net.feed_forward_named(x2)["avgpool"]
    cpu_feat = cpu_net.feed_forward_named(x2)["avgpool"]
    del cpu_net
    np.testing.assert_allclose(card_out, cpu_out, rtol=SERVE_RTOL, atol=SERVE_ATOL)
    np.testing.assert_allclose(card_feat, cpu_feat, rtol=SERVE_RTOL,
                               atol=SERVE_ATOL * np.abs(cpu_feat).max())
    if not np.array_equal(card_out.argmax(-1), cpu_out.argmax(-1)):
        raise RuntimeError("ResNet50: top-1 differs between the card and the CPU")
    x32 = rng.standard_normal((32,) + hwc).astype(np.float32)
    profile = profile_call(torch, "forward ResNet50", lambda: net.output(x32),
                           {"batch": 32})
    profile["h2d_copy_ms_by_events"] = h2d_copy_ms(torch, x32)
    bn = bn_pass_ms(torch, net, x32, train=False)
    bn["share_of_busy"] = share_of_busy(bn["ms"], profile)
    result = {**served, "trained_state_finite": trained_state_finite,
              "calibrated": not trained_state_finite,
              "max_abs_card_vs_cpu_b2": float(np.abs(card_out - cpu_out).max()),
              "avgpool_rel_card_vs_cpu_b2": float(
                  np.linalg.norm(card_feat - cpu_feat) / np.linalg.norm(cpu_feat)),
              "top1_prob_b2": card_out.max(-1).tolist(),
              "bn_passes_b32": bn, "profile": profile, "card": card}
    log(f"ResNet50 serving: p50 {result['p50_ms']:.3f} ms p99 {result['p99_ms']:.3f} "
        f"ms, {result['images_per_s']:.1f} images/s, {result['forwards']} forwards, "
        f"answers finite  [{card}]")
    log(f"ResNet50 serving: {json.dumps(result)}")
    return result


def phase_resnet_bf16_training(torch, card):
    """ResNet50 as a bfloat16 network, bench.py's bench_resnet50 type:
    `ResNet50().init(dtype=torch.bfloat16)`, RESNET_BF16_STEPS `fit` steps
    at batch RESNET_BF16_BATCH. Every kernel count is reset just before and
    read just after: none runs. The parameters are bfloat16, the BN state
    stays float32, finite, and moves on every step; every score is finite."""
    from deeplearning4j_torch.models.zoo import ResNet50
    from deeplearning4j_torch.utils import params as param_utils
    net = ResNet50(num_labels=1000).init(dtype=torch.bfloat16)
    if net.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    hwc, classes = _graph_shape(net)
    if {t.dtype for t in param_utils.tree_leaves(net.params_tree)} != {torch.bfloat16}:
        raise RuntimeError("ResNet50().init(dtype=torch.bfloat16) gave parameters "
                           "that are not bfloat16")
    check_state_float32(torch, net, "ResNet50 bfloat16 at init")
    rng = np.random.default_rng(2043)
    n = RESNET_BF16_STEPS * RESNET_BF16_BATCH
    x = rng.standard_normal((n,) + hwc, dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    steps, moved = Steps(), StateSteps(torch, net, [False])
    net.listeners[:] = [steps, moved]
    zero_launches()   # the bfloat16 run starts here
    net.fit(x, y, epochs=1, batch_size=RESNET_BF16_BATCH)
    launches = all_launches()   # ... and ends here
    net.listeners.clear()
    check_launches("ResNet50 bfloat16 training", launches, dict.fromkeys(launches, 0))
    if net.iteration != RESNET_BF16_STEPS or len(steps.scores) != RESNET_BF16_STEPS \
            or not all(np.isfinite(steps.scores)) or not all(moved.moved):
        raise RuntimeError(f"ResNet50 bfloat16: {net.iteration} steps, scores "
                           f"{steps.scores}, state moved {moved.moved}")
    leaves = check_state_float32(torch, net, "ResNet50 bfloat16 after training")
    step_ms = np.diff(steps.ends) * 1e3
    xb, yb = x[:RESNET_BF16_BATCH], y[:RESNET_BF16_BATCH]

    def one_step():
        net.fit(xb, yb, batch_size=RESNET_BF16_BATCH)
        torch.cuda.synchronize()

    profile = profile_call(torch, "train step ResNet50 bfloat16", one_step,
                           {"batch": RESNET_BF16_BATCH})
    profile["h2d_copy_ms_by_events"] = h2d_copy_ms(torch, xb)
    result = {"steps": RESNET_BF16_STEPS, "batch": RESNET_BF16_BATCH,
              "launches": launches, "scores": steps.scores,
              "state_leaves_float32": leaves,
              "step_ms_after_the_first": step_ms.tolist(),
              "median_step_ms": float(np.median(step_ms)) if len(step_ms) else None,
              "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                                 if net.device.type == "cuda" else None),
              "profile": profile, "card": card}
    log(f"ResNet50 bfloat16 training: {json.dumps(result)}")
    del net, x, y, xb, yb
    return result


# ------------------------------------------------------- embedding indices

EMBED_VOCAB = 1000


def phase_embedding_guard(torch, card):
    """An embedding index out of range on the card. `EmbeddingLayer(1000 ->
    4)` then `OutputLayer(3)` behind a BATCHED ParallelInference: a request
    holding index 1000 fails with the server's typed error, caused by the
    IndexError that the layer raises before its gather (a device-side assert
    in the gather would leave the process's CUDA context unusable); then a
    good request is served, and its answer matches `net.output` on the same
    rows. The int8 lookup (`embedding_qlookup`) raises alike on the card and
    then answers as on the CPU."""
    from deeplearning4j_torch import (EmbeddingLayer, MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer)
    from deeplearning4j_torch.parallel.inference import (BatchExecutionError,
                                                          InferenceMode,
                                                          ParallelInference)
    from deeplearning4j_torch.quantize import embedding_qlookup, quantize_tree
    conf = (NeuralNetConfiguration.builder().seed(9).list()
            .layer(EmbeddingLayer(n_in=EMBED_VOCAB, n_out=4))
            .layer(OutputLayer(n_in=4, n_out=3, activation="softmax", loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init(device="cuda")
    good = np.array([[257], [997], [3], [-EMBED_VOCAB]])
    pi = ParallelInference(net, inference_mode=InferenceMode.BATCHED, batch_limit=8)
    try:
        try:
            pi.output(np.array([[5], [EMBED_VOCAB]]))
        except BatchExecutionError as e:
            if not isinstance(e.__cause__, IndexError):
                raise RuntimeError(f"embedding guard: {e!r} not caused by IndexError")
            bad = repr(e.__cause__)
        else:
            raise RuntimeError("embedding guard: index 1000 of 1000 was served")
        served = pi.output(good)
    finally:
        pi.shutdown()
    torch.cuda.synchronize()
    want = net.output(good)
    np.testing.assert_allclose(served, want, rtol=1e-6, atol=1e-7)
    w = torch.randn(EMBED_VOCAB, 4, generator=torch.Generator().manual_seed(9))
    table = {"W": w, "b": torch.zeros(4)}
    q_cuda = quantize_tree({k: v.cuda() for k, v in table.items()})
    try:
        embedding_qlookup(q_cuda, torch.tensor([1, -EMBED_VOCAB - 1], device="cuda"))
    except IndexError:
        pass
    else:
        raise RuntimeError("embedding guard: embedding_qlookup took index -1001")
    idx = torch.tensor([0, 999, 257, -1])
    got = embedding_qlookup(q_cuda, idx.cuda()).cpu()
    torch.cuda.synchronize()
    want_q = embedding_qlookup(quantize_tree(table), idx)
    torch.testing.assert_close(got, want_q, rtol=1e-6, atol=1e-7)
    out = {"bad_request_error": bad,
           "served_max_abs_diff": float(np.abs(served - want).max()),
           "qlookup_max_abs_diff": (got - want_q).abs().max().item()}
    log(f"embedding guard: {json.dumps(out)}  [{card}]")
    return out


# ---------------------------------------------------------------- attention

BF16_OPS_PER_S = 989e12      # H100 SXM data sheet, dense bfloat16 tensor cores
# Float32 matrix products at float32 accuracy on the tensor cores: three TF32
# products (3xTF32, as K3 takes them) for each float32 one, so a third of the
# data sheet's 495 TFLOP/s TF32. The card does float32-accurate attention that
# fast, so a float32 attention bound at 67 TFLOP/s (CUDA cores) would sit
# above what a kernel on the tensor cores reaches.
TF32X3_OPS_PER_S = 495e12 / 3
# flops per allowed (query, key) pair and head_dim element: K3 two dot
# products (q.k, p.v), K4 four (q.k, do.v, the dv and dk updates), K5 three
FLASH_FLOPS_PER_PAIR = {"flash_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}
FLASH_REL = {"float32": 1e-5, "bfloat16": 1e-2}  # of max|plain|: f32 sums over up
# to 8192 keys in another order; bf16 p and ds rounded at other running maxima
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
# (label, b, tq, tk, h, d, dtype, causal, options, timed): the char model's
# shape (4 x 8192, 4 heads of 128, causal) in both types, then edge shapes
FLASH_CASES = [
    ("model_f32", 4, 8192, 8192, 4, 128, "float32", True, {}, True),
    ("model_bf16", 4, 8192, 8192, 4, 128, "bfloat16", True, {}, True),
    ("noncausal", 2, 512, 512, 4, 128, "float32", False, {}, False),
    ("key_mask_fully_masked_rows", 2, 300, 300, 2, 64, "float32", True,
     {"key_mask": True}, False),
    ("packed_segments", 2, 1024, 1024, 4, 128, "float32", True,
     {"segments": True}, False),
    ("position_offsets", 2, 256, 512, 2, 64, "float32", True,
     {"q_offset": 256}, False),
    # K4's transposed skip scan and per-column lse in bfloat16
    ("packed_segments_bf16", 2, 1024, 1024, 4, 128, "bfloat16", True,
     {"segments": True}, False),
    ("position_offsets_bf16", 2, 256, 512, 2, 64, "bfloat16", True,
     {"q_offset": 256}, False),
    ("d8", 2, 200, 200, 4, 8, "float32", True, {}, False),
    ("d64_bf16_key_mask", 2, 640, 640, 4, 64, "bfloat16", True,
     {"key_mask": True}, False),
    ("t1000", 2, 1000, 1000, 4, 128, "float32", True, {}, False),
    ("tq1", 4, 1, 777, 4, 128, "float32", False, {"key_mask": True}, False),
    # d * element size not a multiple of 16 bytes: K3's element-wise loads
    ("d36_bf16", 2, 300, 300, 4, 36, "bfloat16", True, {}, False),
    ("d19_f32_key_mask", 2, 300, 300, 4, 19, "float32", True, {"key_mask": True},
     False),
    # 80-byte rows: 16-byte copies, head_dim padded from 20 to 32
    ("d20_f32", 2, 300, 300, 4, 20, "float32", True, {}, False),
]
CHAR_VOCAB, CHAR_WIDTH, CHAR_HEADS = 96, 512, 4   # bench.py attention_longctx
CHAR_T, CHAR_BATCH, CHAR_STEPS = 8192, 4, 4       # 32768 tokens a step
CHAR_LR = 0.1
CHAR_SMALL_T = 256   # the card-vs-CPU comparison's sequence length
DISPATCH_TS = (1024, 2048, 4096, 8192)


def attention_pairs(torch, qp, kp, causal, batch, heads, km=None, qs=None,
                    ks=None):
    """How many (query, key) pairs the masks allow, over batch and heads:
    the work the attention kernels must do on these inputs."""
    keep = torch.ones(1, qp.shape[0], kp.shape[0], dtype=torch.bool,
                      device=qp.device)
    if causal:
        keep = keep & (kp[None, :] <= qp[:, None])[None]
    if km is not None:
        keep = keep & (km > 0)[:, None, :]
    if qs is not None:
        keep = keep & (qs[:, :, None] == ks[:, None, :])
    per = int(keep.sum())
    return per * heads * (batch if keep.shape[0] == 1 else 1)


def attention_bound_ms(kernel, pairs, head_dim, dtype, nbytes):
    """Least time for one attention kernel: its flops on the allowed pairs
    over the dtype's peak (165 TFLOP/s float32, TF32X3_OPS_PER_S; 989
    TFLOP/s bfloat16), or the bytes it must read and write over 3.35 TB/s,
    whichever is larger."""
    peak = TF32X3_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S
    ops_ms = FLASH_FLOPS_PER_PAIR[kernel] * head_dim * pairs / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _flash_inputs(torch, gen, b, tq, tk, h, d, dtype, opts, device="cuda"):
    mk = lambda *s: torch.randn(*s, device=device, generator=gen).to(dtype)
    q, k, v, do = mk(b, tq, h, d), mk(b, tk, h, d), mk(b, tk, h, d), mk(b, tq, h, d)
    km = qs = ks = None
    if opts.get("key_mask"):
        km = (torch.rand(b, tk, device=device, generator=gen) > 0.3).float()
        km[:, :5] = 0.0   # causal rows 0-4 see no key
        km[-1] = 0.0      # and the last batch row none at all
    if opts.get("segments"):
        # packed rows: 4 segments of random length each, then 10% padding
        rng = np.random.default_rng(tq)
        ids = np.zeros((b, tq), np.int32)
        for r in range(b):
            cuts = np.sort(rng.choice(np.arange(1, tq * 9 // 10), 3, replace=False))
            ids[r, :tq * 9 // 10] = np.searchsorted(cuts, np.arange(tq * 9 // 10),
                                                    side="right") + 1
        qs = ks = torch.from_numpy(ids).to(device)
        km = (qs > 0).float()
    if opts.get("offset"):
        # q, k, v, do each opts["offset"] elements into a storage of their own:
        # contiguous tensors whose pointers are only so far aligned
        def shifted(x, n=opts["offset"]):
            flat = torch.empty(x.numel() + n, device=device, dtype=x.dtype)
            flat[n:].copy_(x.reshape(-1))
            return flat[n:].view(x.shape)
        q, k, v, do = (shifted(x) for x in (q, k, v, do))
    qp = torch.arange(tq, device=device, dtype=torch.int32) + opts.get("q_offset", 0)
    kp = torch.arange(tk, device=device, dtype=torch.int32)
    return q, k, v, do, km, qs, ks, qp, kp


def _rel_err(got, want):
    """max |got - want| / max |want|, in float32."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def phase_flash(torch, card):
    """K3, K4 and K5 against their plain versions, on random inputs at the
    char model's shape and at edge shapes, with a nonzero lse cotangent;
    warm CUDA-event times of each kernel, its plain version and
    F.scaled_dot_product_attention (timed as the yardstick only): its forward
    for K3, and its autograd backward asked for (dk, dv) for K4 and for dq
    for K5. SDPA's fused backward computes all three gradients in either
    call, so both backward yardsticks time the same work."""
    import torch.nn.functional as F
    from deeplearning4j_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(3)
    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    worst = dict.fromkeys(names, 0.0)
    timed_rows = {}
    for label, b, tq, tk, h, d, dtype, causal, opts, timed in FLASH_CASES:
        dt = getattr(torch, dtype)
        q, k, v, do, km, qs, ks, qp, kp = _flash_inputs(torch, gen, b, tq, tk, h,
                                                        d, dt, opts)
        scale = d ** -0.5
        o, lse = fa._launch_fwd(q, k, v, km, qs, ks, qp, kp, scale, causal)
        torch.cuda.synchronize()
        ow, lw = fa.flash_fwd_reference(q, k, v, km, qs, ks, qp, kp, scale, causal)
        live = lw > fa.NEG / 2
        if not torch.equal(lse <= fa.NEG / 2, ~live):
            raise RuntimeError(f"flash_fwd {label}: fully masked rows differ")
        torch.testing.assert_close(lse[live], lw[live], **LSE_TOL)
        gl = torch.where(live, torch.randn(lw.shape, device="cuda", generator=gen),
                         0.0).contiguous()
        di = (ow.float() * do.float()).sum(-1)
        args = (q, k, v, do, lw, di, gl, km, qs, ks, qp, kp, scale, causal)
        dk, dv = fa._launch_bwd_dkv(*args)
        dq = fa._launch_bwd_dq(*args)
        torch.cuda.synchronize()
        dkw, dvw = fa.flash_bwd_dkv_reference(*args)
        dqw = fa.flash_bwd_dq_reference(*args)
        errs = {"flash_fwd": (o, ow), "flash_bwd_dkv_dk": (dk, dkw),
                "flash_bwd_dkv_dv": (dv, dvw), "flash_bwd_dq": (dq, dqw)}
        row = {"case": label, "shape": [b, tq, tk, h, d], "dtype": dtype,
               "causal": causal, **{k_: bool(v_) for k_, v_ in opts.items()},
               "fully_masked_rows": int((~live).sum()),
               "lse_max_abs_err": (lse[live] - lw[live]).abs().max().item()
               if live.any() else 0.0}
        for what, (got, want) in errs.items():
            rel = _rel_err(got, want)
            if not rel <= FLASH_REL[dtype] or not torch.isfinite(got).all():
                raise RuntimeError(f"{what} {label}: error {rel} of max|plain| "
                                   f"(limit {FLASH_REL[dtype]})")
            if not live.all() and what == "flash_fwd" and \
                    (got[~live] != 0).any():
                raise RuntimeError(f"{label}: a fully masked row is not 0")
            err = (got.float() - want.float()).abs().max().item()
            kernel = "flash_bwd_dkv" if what.startswith("flash_bwd_dkv") else what
            worst[kernel] = max(worst[kernel], err)
            row[f"{what}_rel_err"] = rel
        if timed:
            pairs = attention_pairs(torch, qp, kp, causal, b, h, km, qs, ks)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            lib = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
            row["library_fwd_rel_err"] = _rel_err(lib.transpose(1, 2), ow)
            ql, kl, vl = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
            lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
            gh = do.transpose(1, 2)
            t_ = lambda fn: cuda_time_ms(fn, iters=5, warm=1)
            times = {
                "flash_fwd": (t_(lambda: fa._launch_fwd(q, k, v, km, qs, ks, qp, kp,
                                                        scale, causal)),
                              t_(lambda: fa.flash_fwd_reference(
                                  q, k, v, km, qs, ks, qp, kp, scale, causal)),
                              t_(lambda: F.scaled_dot_product_attention(
                                  qh, kh, vh, is_causal=causal)),
                              _nbytes(q, k, v, km, qs, ks, qp, kp, o, lse)),
                "flash_bwd_dkv": (t_(lambda: fa._launch_bwd_dkv(*args)),
                                  t_(lambda: fa.flash_bwd_dkv_reference(*args)),
                                  t_(lambda: torch.autograd.grad(
                                      lo, (kl, vl), gh, retain_graph=True)),
                                  _nbytes(q, k, v, do, lw, di, gl, km, qs, ks, qp,
                                          kp, dk, dv)),
                "flash_bwd_dq": (t_(lambda: fa._launch_bwd_dq(*args)),
                                 t_(lambda: fa.flash_bwd_dq_reference(*args)),
                                 t_(lambda: torch.autograd.grad(
                                     lo, (ql,), gh, retain_graph=True)),
                                 _nbytes(q, k, v, do, lw, di, gl, km, qs, ks, qp,
                                         kp, dq)),
            }
            for name, (ms, plain_ms, lib_ms, nbytes) in times.items():
                bound, by = attention_bound_ms(name, pairs, d, dtype, nbytes)
                row[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                             "bound_ms": bound, "bound_by": by, "pairs": pairs}
            timed_rows[label] = row
            del qh, kh, vh, lib, ql, kl, vl, lo, gh
        log(f"flash {label}: {json.dumps(row)}  [{card}]")
        del q, k, v, do, o, lse, ow, lw, dk, dv, dq, dkw, dvw, dqw, args
        torch.cuda.empty_cache()
    # the kernels line reports the shape and type the char model's main path
    # gives the kernels: float32 (matmul_any's float32 epilogue)
    main = timed_rows["model_f32"]
    replaces = {"flash_fwd": "deeplearning4j_tpu/ops/flash_attention.py:139",
                "flash_bwd_dkv": "deeplearning4j_tpu/ops/flash_attention.py:193",
                "flash_bwd_dq": "deeplearning4j_tpu/ops/flash_attention.py:237"}
    entries = [{"name": n, "route": "cuda",
                "source": "deeplearning4j_torch/ops/csrc/flash_attention.cu",
                "replaces": replaces[n], "launches": None,
                "max_abs_err": worst[n], "ms": main[n]["ms"],
                "plain_ms": main[n]["plain_ms"], "bound_ms": main[n]["bound_ms"],
                "bound_by": main[n]["bound_by"],
                "library_ms": main[n]["library_ms"]} for n in names]
    return entries, timed_rows


def phase_attention_dispatch(torch, card):
    """Forward + backward of dense, blockwise (block 512) and the flash
    route at t in DISPATCH_TS, 32768 tokens (batch 32768 / t), 4 heads of
    128, causal, float32: where the flash route starts to win on this card
    (the dispatch rule's t >= 2048 was measured on a TPU; it is not changed
    here)."""
    from deeplearning4j_torch.ops import attention as att
    from deeplearning4j_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(4)
    impls = {
        "dense": lambda q, k, v: att.dense_attention(q, k, v, causal=True),
        "blockwise": lambda q, k, v: att.blockwise_attention(
            q, k, v, causal=True, q_block=512, kv_block=512),
        "flash": lambda q, k, v: fa.flash_attention(q, k, v, causal=True),
    }
    rows = []
    for t in DISPATCH_TS:
        b = 32768 // t
        q, k, v, g = (torch.randn(b, t, CHAR_HEADS, CHAR_WIDTH // CHAR_HEADS,
                                  device="cuda", generator=gen).requires_grad_()
                      for _ in range(4))
        row = {"t": t, "batch": b}
        for name, fn in impls.items():
            def fwd_bwd(fn=fn):
                torch.autograd.grad(fn(q, k, v), (q, k, v), g)
            row[f"{name}_ms"] = cuda_time_ms(fwd_bwd, iters=3, warm=1)
            torch.cuda.empty_cache()
        row["fastest"] = min(impls, key=lambda n: row[f"{n}_ms"])
        row["rule_picks"] = att.select_attention_impl(t, CHAR_WIDTH // CHAR_HEADS)
        rows.append(row)
        log(f"dispatch t={t}: {json.dumps(row)}  [{card}]")
        del q, k, v, g
    return rows


def char_conf(impl="auto", packed=False, width=CHAR_WIDTH, heads=CHAR_HEADS):
    """bench.py's attention_longctx network: two causal SelfAttentionLayers
    (512 wide, 4 heads, ReLU, unless `width`/`heads` say otherwise), an
    RnnOutputLayer (96-way softmax, MCXENT), Sgd(0.1), one-hot input of 96
    characters; with `packed`, the attention layers read segment ids from the
    features mask (`packed_segments`)."""
    from deeplearning4j_torch import (InputType, NeuralNetConfiguration,
                                      RnnOutputLayer, SelfAttentionLayer, Sgd)
    attn = lambda: SelfAttentionLayer(n_out=width, n_heads=heads,
                                      causal=True, activation="relu",
                                      attention_impl=impl,
                                      packed_segments=packed)
    return (NeuralNetConfiguration.builder().seed(0).updater(Sgd(CHAR_LR)).list()
            .layer(attn()).layer(attn())
            .layer(RnnOutputLayer(n_out=CHAR_VOCAB, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(CHAR_VOCAB))
            .build())


def char_data(rows, t, seed):
    """A DataSet of one-hot characters and their successors, from a numpy
    seed, with an all-ones [rows, t] labels mask: every step is present, and
    the score is the mean over steps (DL4J's masked-score normalization).
    Without a mask the score sums the 8192 steps of a row (37,391 at
    initialization) and Sgd(0.1) on that sum diverges within 4 steps."""
    from deeplearning4j_torch.data.dataset import DataSet
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, CHAR_VOCAB, (rows, t))
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    return DataSet(eye[idx], eye[np.roll(idx, -1, 1)], None,
                   np.ones((rows, t), np.float32))


def _counts(fa):
    return {"flash_fwd": fa.fwd_launches, "flash_bwd_dkv": fa.bwd_dkv_launches,
            "flash_bwd_dq": fa.bwd_dq_launches}


def _zero_counts(fa):
    fa.fwd_launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0


def _fit_char(torch, net, data, label, card):
    """`fit` over CHAR_STEPS batches with the launch counts reset just before
    and read just after; every score finite, 2 launches of each kernel a
    step. Returns (launches, scores, step ms)."""
    from deeplearning4j_torch.ops import flash_attention as fa

    class Steps:
        def __init__(self):
            self.scores, self.ends = [], []

        def iteration_done(self, model, iteration):
            torch.cuda.synchronize()
            self.ends.append(time.perf_counter())
            self.scores.append(float(model.score_value))

    steps = Steps()
    net.listeners[:] = [steps]
    torch.cuda.synchronize()
    _zero_counts(fa)  # the main path's run starts here
    t0 = time.perf_counter()
    net.fit(data, epochs=1, batch_size=CHAR_BATCH)
    launches = _counts(fa)  # ... and ends here
    net.listeners.clear()
    want = dict.fromkeys(launches, 2 * CHAR_STEPS)
    if launches != want or len(steps.scores) != CHAR_STEPS:
        raise RuntimeError(f"char model {label}: launches {launches} over "
                           f"{len(steps.scores)} steps, expected {want}")
    if not all(np.isfinite(steps.scores)):
        raise RuntimeError(f"char model {label}: scores {steps.scores}")
    step_ms = (np.diff([t0] + steps.ends) * 1e3).tolist()
    warm = float(np.median(step_ms[1:]))
    log(f"char model {label}: launches {launches}, scores {steps.scores}, step ms "
        f"{step_ms}, median warm {warm:.3f} ms, "
        f"{CHAR_BATCH * CHAR_T / warm * 1e3:.1f} tokens/s  [{card}]")
    return launches, steps.scores, step_ms, warm


def check_sgd_step(torch, net, ds, lr, need_visible):
    """One `fit` step on `ds` against `compute_gradient_and_score` on the same
    batch at the same parameters: with Sgd(lr) every parameter must end at
    p - (lr * g) in its own type, as the updater computes it, within one
    rounding of that type (eps |p|) plus 1e-4 of the largest lr |g| (the two
    gradients agree to rounding). A fit that leaves a parameter where it was
    fails wherever its update is larger than that tolerance; with
    `need_visible` some update must be, or the check could not tell. Returns
    per parameter the worst difference and the share of entries the update
    visibly moves."""
    grads, _ = net.compute_gradient_and_score(ds)
    before = net.params_tree
    net.fit(ds, batch_size=len(ds.features))
    out, visible = {}, 0
    for i, (lb, la, lg) in enumerate(zip(before, net.params_tree, grads)):
        for k, p in lb.items():
            step = (lr * lg[k]).to(p.dtype)
            want = (p - step).float()
            eps = torch.finfo(p.dtype).eps
            tol = eps * want.abs() + 1e-4 * step.float().abs().max()
            diff = (la[k].float() - want).abs()
            moved = (p.float() - want).abs() > tol
            if (diff > tol).any():
                raise RuntimeError(
                    f"fit step: {i}.{k} is {diff.max().item()} from p - lr g "
                    f"(moved {int((la[k] != p).sum())} of {p.numel()} entries)")
            visible += int(moved.sum())
            out[f"{i}.{k}"] = {"max_abs_diff": diff.max().item(),
                               "moved_share": moved.float().mean().item()}
    if need_visible and not visible:
        raise RuntimeError("fit step: no update is larger than its rounding")
    log(f"char model: one fit step against p - {lr} g: {json.dumps(out)}")
    return out


def phase_char_model(torch, card):
    """The long-context char model at full width (512 wide, 4 heads of 128,
    t 8192, batch 4, 96 characters), through MultiLayerNetwork.fit and
    output on the card."""
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.ops import attention as att
    from deeplearning4j_torch.ops import flash_attention as fa
    from deeplearning4j_torch.utils import params as param_utils
    result = {"card": card, "t": CHAR_T, "batch": CHAR_BATCH, "steps": CHAR_STEPS}
    data = char_data(CHAR_STEPS * CHAR_BATCH, CHAR_T, seed=2028)
    choice = att.select_attention_impl(CHAR_T, CHAR_WIDTH // CHAR_HEADS)
    if choice != "pallas":
        raise RuntimeError(f"the dispatch rule picked {choice} at t={CHAR_T}")

    # 1. the main path: the published bfloat16 net trains, then serves
    net = MultiLayerNetwork(char_conf()).init(dtype=torch.bfloat16)
    log(f"char model: {net.num_params()} params, bfloat16")
    launches, scores, step_ms, warm = _fit_char(torch, net, data, "bf16 fit", card)
    result["bf16"] = {"launches": launches, "scores": scores, "step_ms": step_ms,
                      "median_warm_step_ms": warm,
                      "tokens_per_s": CHAR_BATCH * CHAR_T / warm * 1e3}
    batch = DataSet(data.features[:CHAR_BATCH], data.labels[:CHAR_BATCH], None,
                    data.labels_mask[:CHAR_BATCH])
    result["bf16"]["sgd_step"] = check_sgd_step(torch, net, batch, CHAR_LR,
                                                need_visible=False)
    _zero_counts(fa)
    out = net.output(data.features[:CHAR_BATCH])
    out_launches = _counts(fa)
    if out_launches != {"flash_fwd": 2, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}:
        raise RuntimeError(f"output() launches {out_launches}, expected 2 of K3 only")
    if out.shape != (CHAR_BATCH, CHAR_T, CHAR_VOCAB) or not np.isfinite(out).all():
        raise RuntimeError(f"output {out.shape} not finite or misshapen")
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
    result["output_launches"] = out_launches

    def one_step():
        net.fit(batch, batch_size=CHAR_BATCH)
        torch.cuda.synchronize()

    result["profile"] = profile_call(torch, "char model step (bf16)", one_step,
                                     {"batch": CHAR_BATCH, "t": CHAR_T})
    del net
    torch.cuda.empty_cache()

    # 2. float32: fit, then gradients with the kernels against the plain versions
    net = MultiLayerNetwork(char_conf()).init(dtype=torch.float32)
    launches, scores, step_ms, warm = _fit_char(torch, net, data, "f32 fit", card)
    result["f32"] = {"launches": launches, "scores": scores, "step_ms": step_ms,
                     "median_warm_step_ms": warm,
                     "tokens_per_s": CHAR_BATCH * CHAR_T / warm * 1e3}
    result["f32"]["sgd_step"] = check_sgd_step(torch, net, batch, CHAR_LR,
                                               need_visible=True)

    def run(model, plain=False, kernels=2):
        def grads(ds, record, flips):
            before = _counts(fa)
            with ExitStack() as stack:
                stack.enter_context(pinned_kinks(torch, model, record, flips))
                if plain:
                    stack.enter_context(patched(fa, "flash_fwd", fa.flash_fwd_reference))
                    stack.enter_context(patched(fa, "flash_bwd", fa.flash_bwd_reference))
                out = model.compute_gradient_and_score(ds)
            ran = {k: v - before[k] for k, v in _counts(fa).items()}
            want = dict.fromkeys(ran, 0 if plain or model.device.type == "cpu"
                                 else kernels)
            if ran != want:
                raise RuntimeError(f"compute_gradient_and_score launched {ran}")
            return out
        return grads

    result["grad_rel_vs_plain"] = compare_pinned_grads(
        f"char model: kernels vs plain attention, f32, t {CHAR_T}, batch {CHAR_BATCH}",
        torch,
        param_utils, run(net), run(net, plain=True),
        char_data(CHAR_BATCH, CHAR_T, seed=2029))
    del net
    torch.cuda.empty_cache()

    # 3. the card against the CPU path at a small t, the flash route forced
    small = char_conf(impl="pallas")
    card_net = MultiLayerNetwork(small).init(dtype=torch.float32)
    cpu_net = MultiLayerNetwork(small).init(device="cpu")
    cpu_net.params_tree = tuple({k: v.cpu() for k, v in layer.items()}
                                for layer in card_net.params_tree)
    small_ds = char_data(2, CHAR_SMALL_T, seed=2030)
    result["grad_rel_vs_cpu"] = compare_pinned_grads(
        f"char model: card vs CPU path, f32, t {CHAR_SMALL_T}, batch 2", torch,
        param_utils,
        run(card_net), run(cpu_net), small_ds)
    np.testing.assert_allclose(card_net.output(small_ds.features),
                               cpu_net.output(small_ds.features),
                               rtol=1e-4, atol=1e-6)
    return result


# ------------------------- heads wider than 128 and the bfloat16 accumulator

WIDE_CHAR_WIDTH, WIDE_CHAR_HEADS = 1024, 4   # 4 heads of 256: the sliced arms
WIDE_HEAD = WIDE_CHAR_WIDTH // WIDE_CHAR_HEADS
ACC16_REL = 2.0 ** -7   # the bfloat16 accumulator, kernel against plain: two
# bfloat16 ulps of max|plain| (a block's float32 sum taken in another order
# can tip one of its roundings, and a tipped rounding moves the sum an ulp)
ACC16_SHARE = 0.05      # ... and at most this share of entries differing at all


def flash_wide_rel(d, dtype):
    """The sliced arms' limit against the plain version, of max|plain|:
    FLASH_REL, in float32 times d / 128 from 128 up: the scores are float32
    sums over head_dim (3xTF32 chunks in the kernel, another order in the
    plain version), whose rounding grows with their length."""
    return FLASH_REL[dtype] * (max(1.0, d / 128) if dtype == "float32" else 1.0)


def _wide_flash_cases():
    """(label, b, tq, tk, h, d, dtype, causal, options, timed): the wide char
    model's shape in both types (timed), then head_dim 256, 160 and 300 (a
    ragged last slice: 160 = 128 + 32, 300 = 128 + 128 + 44, and 600-byte
    bfloat16 rows, which load 8 bytes a copy) and 512, each in both types
    under a causal mask alone (timed at t 2048 but 256's, timed above), with
    a key mask and with packed segments; the
    gate's upper end, 2688 at t 128, and 2689 at t 64; a non-causal, a
    position-offset and a one-query-row case; the clustered arms' edges in
    both types, 1024 (8 chunks: the portable cluster) and 1152 (9 chunks:
    the first head_dim in two passes); and bfloat16 300 with q, k, v and do
    8 bytes into their storage (8-byte but not 16-byte aligned)."""
    cases = [("wide_model_f32", CHAR_BATCH, CHAR_T, CHAR_T, WIDE_CHAR_HEADS, WIDE_HEAD,
              "float32", True, {}, True),
             ("wide_model_bf16", CHAR_BATCH, CHAR_T, CHAR_T, WIDE_CHAR_HEADS, WIDE_HEAD,
              "bfloat16", True, {}, True)]
    variants = (("causal", {}), ("key_mask", {"key_mask": True}),
                ("segments", {"segments": True}))
    for d in (256, 160, 300, 512):
        for dtype in ("float32", "bfloat16"):
            for name, opts in variants:   # the causal case timed at t 2048
                timed = name == "causal" and d != 256
                t = 2048 if timed else 320
                cases.append((f"d{d}_{dtype}_{name}", 2, t, t, 4 if timed else 2, d,
                              dtype, True, opts, timed))
    for dtype in ("float32", "bfloat16"):
        for name, opts in variants:
            cases.append((f"d2688_{dtype}_{name}", 1, 128, 128, 2, 2688, dtype, True,
                          opts, name == "causal"))
    return cases + [
        ("d300_float32_noncausal", 2, 256, 256, 2, 300, "float32", False, {}, False),
        ("d300_float32_offsets", 2, 256, 512, 2, 300, "float32", True, {"q_offset": 256},
         False),
        # one query row against a masked cache, as K3 at q = 1
        ("d256_float32_tq1", 4, 1, 777, 2, 256, "float32", False, {"key_mask": True},
         False),
        # the gate's 2689 at t 64: rows of 10,756 bytes load element by element,
        # and the last slice is one column wide
        ("d2689_float32", 1, 64, 64, 2, 2689, "float32", True, {}, False)] + [
        (f"d{d}_{dtype}_{name}", 1, 256, 256, 2, d, dtype, True, opts, False)
        for d, name, opts in ((1024, "segments", {"segments": True}),
                              (1152, "key_mask", {"key_mask": True}))
        for dtype in ("float32", "bfloat16")] + [
        ("d300_bfloat16_offset8", 2, 320, 320, 2, 300, "bfloat16", True, {"offset": 4},
         False)]


FLASH_WIDE_CASES = _wide_flash_cases()
# (label, b, t, h, d, dtype, JAX block, options, timed): the bfloat16
# accumulator's arms of K4 and K5 against its plain version, at the JAX
# package's default block (128) and at 32, the wide model's shape timed; a
# head_dim under 128 (the accumulator runs the sliced arm at any head_dim);
# a block of 100, which the 32-row sweep tiles straddle. Options as
# `_flash_inputs`', and plain_bound: held to `acc16_plain_bound`, not to
# ACC16_SHARE
ACC16_CASES = [
    ("acc16_model_f32_128", CHAR_BATCH, CHAR_T, WIDE_CHAR_HEADS, WIDE_HEAD, "float32", 128,
     {}, True),
    ("acc16_d256_f32_32", 2, 1024, 2, 256, "float32", 32, {"key_mask": True}, False),
    ("acc16_d256_bf16_128", 2, 1024, 2, 256, "bfloat16", 128, {"segments": True}, False),
    ("acc16_d256_bf16_32", 2, 1024, 2, 256, "bfloat16", 32, {}, False),
    ("acc16_d300_f32_32", 2, 512, 2, 300, "float32", 32, {"segments": True}, False),
    ("acc16_d2688_f32_128", 1, 128, 2, 2688, "float32", 128, {}, False),
    ("acc16_d2688_bf16_32", 1, 128, 2, 2688, "bfloat16", 32, {"key_mask": True}, False),
    ("acc16_d64_bf16_128", 2, 512, 2, 64, "bfloat16", 128, {}, False),
    ("acc16_d100_f32_100", 2, 400, 2, 100, "float32", 100, {"key_mask": True}, False),
    # the clustered K4's edges: 8 chunks (one cluster of 8), 9 (two passes)
    ("acc16_d1024_f32_32", 1, 256, 2, 1024, "float32", 32, {}, False),
    ("acc16_d1024_bf16_128", 1, 256, 2, 1024, "bfloat16", 128, {"segments": True}, False),
    ("acc16_d1152_f32_128", 1, 256, 1, 1152, "float32", 128, {"key_mask": True}, False),
    ("acc16_d1152_bf16_32", 1, 256, 1, 1152, "bfloat16", 32, {}, False),
    # t 64 with segments: a segment's first rows see a key or two and their
    # dq is rounding noise, so the share of entries a sum in another order
    # tips says little; held to the plain version's own spread (plain_bound)
    ("acc16_d1024_f32_32_t64", 1, 64, 2, 1024, "float32", 32,
     {"segments": True, "plain_bound": True}, False),
    ("acc16_d1024_bf16_32_t64", 1, 64, 2, 1024, "bfloat16", 32,
     {"segments": True, "plain_bound": True}, False),
]
# (label, b, t_kv, h, d, dtype, layers of the view (0: contiguous), timed):
# K7w at the wide decoder's shape (8 heads of 256 read in place from a layer
# of its step's view, both types), at 2688, at 300 in bfloat16 (600-byte
# rows: one element a lane), and at the wide decoder's own lengths (a
# 128-key bucket, cache_len from DECODE_WIDE_LENS)
DECODE_WIDE_CASES = [
    ("wide_engine_f32", 8, 256, 8, 256, "float32", 4, True),
    ("wide_engine_bf16", 8, 256, 8, 256, "bfloat16", 4, True),
    ("d2688_f32", 4, 256, 2, 2688, "float32", 0, True),
    ("d2688_bf16", 4, 256, 2, 2688, "bfloat16", 0, True),
    ("d300_bf16", 3, 300, 2, 300, "bfloat16", 0, False),
    ("d160_f32", 3, 100, 2, 160, "float32", 2, False),
    ("d131_f32", 3, 90, 2, 131, "float32", 0, False),   # 524-byte rows: one element a lane
    ("wide_engine_short_f32", 8, 128, 8, 256, "float32", 4, True),
    ("wide_engine_short_bf16", 8, 128, 8, 256, "bfloat16", 4, True),
]
# cache_len drawn from a seed in [lo, hi] for these cases (the wide decoder's
# steps: prompts of 4-32 tokens plus up to 48 new ones), else `decode_lens`
DECODE_WIDE_LENS = {"wide_engine_short_f32": (5, 80), "wide_engine_short_bf16": (5, 80)}
L2_BYTES = 50 * 2 ** 20   # the H100's L2 (data sheet); the card's own where torch reports it
WIDE_COUNTS = ("flash_fwd_wide", "flash_bwd_dkv_wide", "flash_bwd_dq_wide",
               "flash_bwd_dkv_acc16", "flash_bwd_dq_acc16", "decode_attention_wide")


def _wide_counts(fa):
    return dict(zip(WIDE_COUNTS, (fa.fwd_wide_launches, fa.bwd_dkv_wide_launches,
                                  fa.bwd_dq_wide_launches, fa.bwd_dkv_acc16_launches,
                                  fa.bwd_dq_acc16_launches, fa.decode_wide_launches)))


def expect_launches(label, got, **want):
    """`got` (all_launches') is 0 for every kernel but those named."""
    check_launches(label, got, {**dict.fromkeys(got, 0), **want})


def sdpa_backend(torch, q, k, v, causal):
    """The backend torch's scaled_dot_product_attention takes for these
    inputs ([b, h, t, d]), by its own choice function."""
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(q, k, v, None, 0.0, causal)).name
    except Exception as e:  # noqa: BLE001 (a private function: report, do not fail)
        return f"unknown ({type(e).__name__})"


def _check_wide_flash(torch, label, dtype, d, got, want, worst, key):
    rel = _rel_err(got, want)
    limit = flash_wide_rel(d, dtype)
    if not rel <= limit or not torch.isfinite(got).all():
        raise RuntimeError(f"{key} {label}: error {rel} of max|plain| (limit {limit})")
    worst[key] = max(worst.get(key, 0.0), (got.float() - want.float()).abs().max().item())
    return rel


def acc16_plain_bound(fa, args, jb, kernel):
    """Limits on the mean |kernel - plain| for the bfloat16 accumulator's arm
    `kernel` ("dq", or "dkv": dk then dv) at JAX block jb, one an output
    from the plain version's own spread, as tests/test_torch_wide_heads.py
    takes its bound from the JAX package's: a tenth of the smaller mean of
    |plain at jb - plain at the other block| and |plain summed in float32 -
    plain at jb|. The other block is the JAX package's default at this t
    (`pick_kernel_block(t, 128)`), or jb / 2 where that is jb. That bound's
    largest-difference half (a quarter of the spread's largest) is left to
    ACC16_REL: at head_dim 1024, t 64 it is a fraction of one bfloat16 ulp of
    the largest entries, which one rounding tipped by another order of a
    float32 sum exceeds; a wrong accumulator differs in many entries, which
    the mean sees."""
    ref = fa.flash_bwd_dq_reference if kernel == "dq" else fa.flash_bwd_dkv_reference
    other = fa.pick_kernel_block(args[0].shape[1], fa.DEFAULT_BLOCK_KV)
    other = other if other != jb else jb // 2
    runs = [ref(*args, acc_block=blk) for blk in (jb, other, 0)]
    runs = [r if isinstance(r, tuple) else (r,) for r in runs]
    return [0.1 * min((mine.float() - blocks.float()).abs().mean().item(),
                      (f32.float() - mine.float()).abs().mean().item())
            for mine, blocks, f32 in zip(*runs)]


def _check_acc16(torch, label, got, want, worst, key, bound=None):
    """The bfloat16 accumulator's arm against its plain version: ACC16_REL of
    max|plain| and at most ACC16_SHARE of the entries different; with
    `bound` (`acc16_plain_bound`'s) no share limit, the mean |got - want|
    within the bound. Returns (rel, share)."""
    rel = _rel_err(got, want)
    err = (got.float() - want.float()).abs()
    share = (err != 0).float().mean().item()
    if bound is None:
        held = share <= ACC16_SHARE
        what = f"{share} of the entries differ (limit {ACC16_SHARE})"
    else:
        held = err.mean().item() <= bound
        what = (f"mean difference {err.mean().item()} (the plain version's spread "
                f"allows {bound})")
    if not rel <= ACC16_REL or not held or not torch.isfinite(got).all():
        raise RuntimeError(f"{key} {label}: error {rel} of max|plain| (limit "
                           f"{ACC16_REL}), {what}")
    worst[key] = max(worst.get(key, 0.0), err.max().item())
    return rel, share


def check_dq_ring(fa, d):
    """K5w's ring steps as the kernel takes them (`fa.kernel_dq_ring`), for
    every block of every pass at head_dim d, against the design: in one pass
    one step, K's and V's chunk of the block's rank (Q's and dO's resident);
    above, each of the block's chunks in `wide_block_chunks`' order, dO's
    and V's, then Q's and K's, so that the last step holds K's chunk of the
    block's output slice, which the dS K product reads from that slot."""
    g = fa.wide_geometry(d)
    for rank in range(g["cluster"]):
        for pass_ in range(g["passes"]):
            got = fa.kernel_dq_ring(d, rank, pass_)
            if g["passes"] == 1:
                want = [(rank, "K V")]
            else:
                want = [(c, ops) for c in fa.wide_block_chunks(d, rank, pass_)
                        for ops in ("dO V", "Q K")]
                slice_ = pass_ * g["cluster"] + rank
                if slice_ < g["chunks"] and want[-1] != (slice_, "Q K"):
                    raise RuntimeError(f"dq ring d {d} rank {rank} pass {pass_}: the design "
                                       f"{want} ends off the output slice {slice_}")
            if got != want:
                raise RuntimeError(f"dq ring d {d} rank {rank} pass {pass_}: kernel {got}, "
                                   f"design {want}")


def _wide_row_geometry(fa, d, q, k, v, do):
    """The clustered arms' cut of head_dim d and the bytes a load moves for
    these tensors."""
    return {**fa.wide_geometry(d), "load_width": fa.load_width(
        d, q.element_size(), [t.data_ptr() for t in (q, k, v, do)])}


def decode_wide_inputs(torch, label, b, t, h, d, dtype, layers, device):
    """K7w's inputs for the DECODE_WIDE_CASES case `label`, from seeds of
    its own (the label's crc32), so that `phase_wide_kernels` and
    tools/decode_wide_compare.py draw the same ones: cache_len in
    DECODE_WIDE_LENS' span where the case has one, else `decode_lens`."""
    seed = zlib.crc32(label.encode())
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    span = DECODE_WIDE_LENS.get(label)
    lens = rng.integers(span[0], span[1] + 1, b).astype(np.int32) if span else None
    return decode_inputs(torch, gen, rng, b, t, h, d, dtype, layers, device, lens)


def check_decode_wide_geometry(fa, d):
    """K7w's geometry as the CUDA source computes it
    (`fa.kernel_decode_wide_geometry`) against the wrapper's mirror
    (`fa.decode_wide_geometry`) at head_dim d, both types, both routes (the
    element route always, the 16-byte one where d is whole pieces), and its
    shared memory within SMEM_LIMIT."""
    import torch
    for dt in (torch.float32, torch.bfloat16):
        for vec in {False, d % (16 // (4 if dt == torch.float32 else 2)) == 0}:
            want = fa.decode_wide_geometry(d, dt, vec)
            got = fa.kernel_decode_wide_geometry(d, dt, vec)
            if got != want or not 0 < got["smem"] <= fa.SMEM_LIMIT:
                raise RuntimeError(f"decode wide geometry {dt} d {d} vec {vec}: kernel "
                                   f"{got}, wrapper {want} (limit {fa.SMEM_LIMIT} bytes)")


def check_no_spill(records, kernel):
    """The ptxas records of the instances of `kernel` (by name): fails if
    there is none, or if any spills or keeps a stack frame."""
    mine = [k for k in records if kernel in k["kernel"]]
    bad = [k for k in mine if k.get("spill_stores") or k.get("spill_loads") or k.get("stack")]
    if not mine or bad:
        raise RuntimeError(f"ptxas {kernel}: {bad or 'no record'}")
    return mine


def rotation(torch, tensors, copies):
    """`copies` sets of `tensors`, the first the tensors themselves, the
    others copies with the same sizes and strides in memory of their own."""
    out = [tuple(tensors)]
    for _ in range(copies - 1):
        out.append(tuple(torch.empty_strided(x.size(), x.stride(), dtype=x.dtype,
                                             device=x.device).copy_(x) for x in tensors))
    return out


def cold_ms(torch, fn, sets):
    """`device_ms` of fn(*set) over a rotation of input sets (`rotation`),
    each call on the set after the last one's: with sets whose bytes exceed
    twice the L2, every call reads its inputs from device memory."""
    turn = iter(range(1 << 30))
    call = lambda: fn(*sets[next(turn) % len(sets)])
    return device_ms(torch, call, iters=max(20, len(sets)))


def cold_copies(torch, nbytes, on_card):
    """Input sets a cold rotation takes: enough that `nbytes` a set exceed
    twice the L2 together (the card's L2 where torch reports it), at least
    2, at most 64."""
    l2 = L2_BYTES
    if on_card:
        l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", l2) or l2
    return max(2, min(64, -(-2 * l2 // max(1, nbytes)) + 1))


def time_decode_wide(torch, fa, label, q, k, v, lens, timed, on_card):
    """K7w (`fa._launch_decode`, head_dim > 128) on one case: checked
    against the plain version (`check_decode`), then again with a row at
    cache_len 0 (output 0) and one past the bucket. Timed cases: warm
    (`device_ms`, back to back) and cold (`cold_ms` over a rotation whose
    valid K and V exceed twice the L2) times of K7w, its plain version and
    SDPA with a boolean mask from cache_len (the yardstick only, its
    backend named), beside the bytes bound; on the card, K7w at each split
    count of DECODE_SPLITS_SWEPT, warm and cold, each held to the plain
    version. Returns the row."""
    import torch.nn.functional as F
    b, t, h, d = k.shape
    got = fa._launch_decode(q, k, v, lens)
    torch.cuda.synchronize()
    err = check_decode(torch, fa, label, got, q, k, v, lens)
    odd = lens.clone()
    odd[0], odd[1] = 0, t + 5
    got0 = fa._launch_decode(q, k, v, odd)
    torch.cuda.synchronize()
    if (got0[0] != 0).any():
        raise RuntimeError(f"decode wide {label}: a row with cache_len 0 is not 0")
    err = max(err, check_decode(torch, fa, label + " odd lens", got0, q, k, v, odd))
    vw = 16 // q.element_size()
    vec = all(x % vw == 0 for x in (d, *k.stride()[:2], *v.stride()[:2])) and all(
        x.data_ptr() % 16 == 0 for x in (q, k, v))
    row = {"case": label, "shape": [b, t, h, d], "dtype": str(q.dtype).split(".")[-1],
           "strided_view": not k.is_contiguous(), "max_abs_err": err,
           "lens": [int(x) for x in lens[:4]],
           "geometry": fa.decode_wide_geometry(d, q.dtype, vec),
           "splits": fa.decode_wide_splits(q.device, b * h, t, d, q.element_size())
           if on_card else None}
    if not timed:
        return row
    km = torch.arange(t, device=q.device)[None, :] < lens[:, None].long()
    mask = km[:, None, None, :]
    tr = lambda x: x.transpose(1, 2)
    sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(tr(q_), tr(k_), tr(v_),
                                                             attn_mask=mask)
    row["sdpa_backend"] = sdpa_backend(torch, tr(q), tr(k), tr(v), False) + " (masked)"
    row["bound_ms"], row["bound_by"] = decode_bound_ms(q, k, lens)
    valid = int(row["bound_ms"] * HBM_BYTES_PER_S / 1e3)
    sets = rotation(torch, (q, k, v, lens), cold_copies(torch, valid, on_card))
    row["cold_sets"] = len(sets)
    for key, fn in (("", lambda q_, k_, v_, l_: fa._launch_decode(q_, k_, v_, l_)),
                    ("plain_", fa.decode_attention_reference),
                    ("library_", lambda q_, k_, v_, l_: sdpa(q_, k_, v_))):
        row[f"{key}ms"] = device_ms(torch, lambda: fn(q, k, v, lens))
        row[f"{key}ms_cold"] = cold_ms(torch, fn, sets)
    if on_card:   # the split rule's alternatives, each checked
        row["ms_by_splits"], row["ms_cold_by_splits"] = {}, {}
        for s_ in DECODE_SPLITS_SWEPT:
            run = lambda q_, k_, v_, l_: fa._launch_decode(q_, k_, v_, l_, splits=s_)
            check_decode(torch, fa, f"{label} at {s_} splits", run(q, k, v, lens), q, k, v,
                         lens)
            row["ms_by_splits"][s_] = device_ms(torch, lambda: run(q, k, v, lens))
            row["ms_cold_by_splits"][s_] = cold_ms(torch, run, sets)
    del sets, km, mask
    return row


def phase_wide_kernels(torch, card, device=None):
    """The sliced arms of K3, K4 and K5 (head_dim > 128) against their plain
    versions at FLASH_WIDE_CASES, with a nonzero lse cotangent; the bfloat16
    accumulator's arms of K4 and K5 against its plain version at ACC16_CASES
    (`_check_acc16`; the cases marked plain_bound within the plain version's
    own spread, `acc16_plain_bound`);
    K7w at DECODE_WIDE_CASES (`time_decode_wide`: rows with cache_len 0 and
    past the bucket too; warm and cold times, and the split sweep). Timed
    flash cases: warm CUDA-event times
    of each kernel, its plain version and SDPA (the yardstick only; the
    backend torch took is named), beside the operations bound. Each row
    names its cluster geometry and the bytes its loads move (`wide_geometry`,
    `load_width`); on the card the CUDA source's geometry is held to the
    wrapper's at every head_dim 129-2689, in both types, K5w's ring order
    to `check_dq_ring`'s and K7w's geometry to `check_decode_wide_geometry`'s
    at the same head_dims, and the arms' ptxas records (registers, spills)
    are reported, K7w's held to no spill (`check_no_spill`). Then the
    bfloat16 accumulator's path through the public entry point: autograd of
    `flash_attention(..., bwd_acc_dtype="bfloat16")` at the wide model's
    shape, the counts reset just before and read just after (the sliced K3
    and the accumulator's K4 and K5, once each). Returns the kernels-line
    entries and the rows."""
    import torch.nn.functional as F
    from deeplearning4j_torch.ops import flash_attention as fa
    dev = device or "cuda"
    on_card = torch.device(dev).type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(24)
    worst, rows = {}, {}
    t_ = lambda fn: cuda_time_ms(fn, iters=3, warm=1)
    if on_card:
        from deeplearning4j_torch.ops import cuda_build
        for dt in (torch.float32, torch.bfloat16):
            for d in range(129, 2690):
                want = {**fa.wide_geometry(d), **fa.wide_smem(d, dt)}
                got = fa.kernel_wide_geometry(d, dt)
                if got != want or max(got[k] for k in ("fwd", "dkv", "dkv_acc16", "dq",
                                                       "dq_acc16")) > fa.SMEM_LIMIT:
                    raise RuntimeError(f"wide geometry {dt} d {d}: kernel {got}, "
                                       f"wrapper {want} (limit {fa.SMEM_LIMIT} bytes)")
        for d in range(129, 2690):
            check_dq_ring(fa, d)
            check_decode_wide_geometry(fa, d)
        rows["ptxas"] = [k for k in ptxas_report(cuda_build.build_logs.get(
            "flash_attention", "")) if "cluster_kernel" in k["kernel"]]
        rows["ptxas"] += check_no_spill(ptxas_report(cuda_build.build_logs.get(
            "decode_attention", "")), K7W_KERNEL)
        for k in rows["ptxas"]:
            log(f"ptxas sliced arm: {json.dumps(k)}")
    for label, b, tq, tk, h, d, dtype, causal, opts, timed in FLASH_WIDE_CASES:
        dt = getattr(torch, dtype)
        q, k, v, do, km, qs, ks, qp, kp = _flash_inputs(torch, gen, b, tq, tk, h, d, dt,
                                                        opts, device=dev)
        scale = d ** -0.5
        o, lse = fa._launch_fwd(q, k, v, km, qs, ks, qp, kp, scale, causal)
        torch.cuda.synchronize()
        ow, lw = fa.flash_fwd_reference(q, k, v, km, qs, ks, qp, kp, scale, causal)
        live = lw > fa.NEG / 2
        if not torch.equal(lse <= fa.NEG / 2, ~live):
            raise RuntimeError(f"flash_fwd_wide {label}: fully masked rows differ")
        torch.testing.assert_close(lse[live], lw[live], rtol=LSE_TOL["rtol"] * d / 128,
                                   atol=LSE_TOL["atol"] * d / 128)
        if not live.all() and (o[~live] != 0).any():
            raise RuntimeError(f"flash_fwd_wide {label}: a fully masked row is not 0")
        gl = torch.where(live, torch.randn(lw.shape, device=dev, generator=gen),
                         0.0).contiguous()
        di = (ow.float() * do.float()).sum(-1)
        args = (q, k, v, do, lw, di, gl, km, qs, ks, qp, kp, scale, causal)
        dk, dv = fa._launch_bwd_dkv(*args)
        dq = fa._launch_bwd_dq(*args)
        torch.cuda.synchronize()
        dkw, dvw = fa.flash_bwd_dkv_reference(*args)
        dqw = fa.flash_bwd_dq_reference(*args)
        row = {"case": label, "shape": [b, tq, tk, h, d], "dtype": dtype,
               "causal": causal, **{k_: bool(v_) for k_, v_ in opts.items()},
               "fully_masked_rows": int((~live).sum()),
               "geometry": _wide_row_geometry(fa, d, q, k, v, do)}
        if opts.get("offset") and row["geometry"]["load_width"] != 2 * opts["offset"]:
            raise RuntimeError(f"flash wide {label}: loads of "
                               f"{row['geometry']['load_width']} bytes")
        for key, got, want in (("flash_fwd_wide", o, ow), ("flash_bwd_dkv_wide", dk, dkw),
                               ("flash_bwd_dkv_wide", dv, dvw),
                               ("flash_bwd_dq_wide", dq, dqw)):
            row[f"{key}_rel_err"] = max(row.get(f"{key}_rel_err", 0.0), _check_wide_flash(
                torch, label, dtype, d, got, want, worst, key))
        if timed:
            pairs = attention_pairs(torch, qp, kp, causal, b, h, km, qs, ks)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            row["sdpa_backend"] = sdpa_backend(torch, qh, kh, vh, causal)
            ql, kl, vl = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
            lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
            gh = do.transpose(1, 2)
            times = {
                "flash_fwd_wide": (
                    t_(lambda: fa._launch_fwd(q, k, v, km, qs, ks, qp, kp, scale, causal)),
                    t_(lambda: fa.flash_fwd_reference(q, k, v, km, qs, ks, qp, kp, scale,
                                                      causal)),
                    t_(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                              is_causal=causal)),
                    _nbytes(q, k, v, km, qs, ks, qp, kp, o, lse), "flash_fwd"),
                "flash_bwd_dkv_wide": (
                    t_(lambda: fa._launch_bwd_dkv(*args)),
                    t_(lambda: fa.flash_bwd_dkv_reference(*args)),
                    t_(lambda: torch.autograd.grad(lo, (kl, vl), gh, retain_graph=True)),
                    _nbytes(q, k, v, do, lw, di, gl, km, qs, ks, qp, kp, dk, dv),
                    "flash_bwd_dkv"),
                "flash_bwd_dq_wide": (
                    t_(lambda: fa._launch_bwd_dq(*args)),
                    t_(lambda: fa.flash_bwd_dq_reference(*args)),
                    t_(lambda: torch.autograd.grad(lo, (ql,), gh, retain_graph=True)),
                    _nbytes(q, k, v, do, lw, di, gl, km, qs, ks, qp, kp, dq),
                    "flash_bwd_dq"),
            }
            for name, (ms, plain_ms, lib_ms, nbytes, kernel) in times.items():
                bound, by = attention_bound_ms(kernel, pairs, d, dtype, nbytes)
                row[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                             "bound_ms": bound, "bound_by": by, "pairs": pairs}
            del qh, kh, vh, ql, kl, vl, lo, gh
        rows[label] = row
        log(f"flash wide {label}: {json.dumps(row)}  [{card}]")
        del q, k, v, do, o, lse, ow, lw, dk, dv, dq, dkw, dvw, dqw, args
        if on_card:
            torch.cuda.empty_cache()

    for label, b, t, h, d, dtype, jb, opts, timed in ACC16_CASES:
        dt = getattr(torch, dtype)
        q, k, v, do, km, qs, ks, qp, kp = _flash_inputs(torch, gen, b, t, t, h, d, dt,
                                                        opts, device=dev)
        scale = d ** -0.5
        ow, lw = fa.flash_fwd_reference(q, k, v, km, qs, ks, qp, kp, scale, True)
        live = lw > fa.NEG / 2
        gl = torch.where(live, torch.randn(lw.shape, device=dev, generator=gen),
                         0.0).contiguous()
        di = (ow.float() * do.float()).sum(-1)
        args = (q, k, v, do, lw, di, gl, km, qs, ks, qp, kp, scale, True)
        dk, dv = fa._launch_bwd_dkv(*args, acc_block=jb)
        dq = fa._launch_bwd_dq(*args, acc_block=jb)
        torch.cuda.synchronize()
        dkw, dvw = fa.flash_bwd_dkv_reference(*args, acc_block=jb)
        dqw = fa.flash_bwd_dq_reference(*args, acc_block=jb)
        row = {"case": label, "shape": [b, t, t, h, d], "dtype": dtype, "jax_block": jb,
               **{k_: bool(v_) for k_, v_ in opts.items()},
               "geometry": _wide_row_geometry(fa, d, q, k, v, do)}
        bounds = [None] * 3
        if opts.get("plain_bound"):
            bounds = acc16_plain_bound(fa, args, jb, "dkv") + acc16_plain_bound(fa, args, jb,
                                                                               "dq")
            row["plain_bound"] = bounds
        for (what, key, got, want), bound in zip((("dk", "flash_bwd_dkv_acc16", dk, dkw),
                                                  ("dv", "flash_bwd_dkv_acc16", dv, dvw),
                                                  ("dq", "flash_bwd_dq_acc16", dq, dqw)),
                                                 bounds):
            row[f"{what}_rel_err"], row[f"{what}_differing_share"] = _check_acc16(
                torch, label, got, want, worst, key, bound)
        if timed:
            pairs = attention_pairs(torch, qp, kp, True, b, h, km, qs, ks)
            ql, kl, vl = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
            lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
            gh = do.transpose(1, 2)
            times = {
                "flash_bwd_dkv_acc16": (
                    t_(lambda: fa._launch_bwd_dkv(*args, acc_block=jb)),
                    t_(lambda: fa.flash_bwd_dkv_reference(*args, acc_block=jb)),
                    t_(lambda: torch.autograd.grad(lo, (kl, vl), gh, retain_graph=True)),
                    _nbytes(q, k, v, do, lw, di, gl, km, qs, ks, qp, kp, dk, dv),
                    "flash_bwd_dkv"),
                "flash_bwd_dq_acc16": (
                    t_(lambda: fa._launch_bwd_dq(*args, acc_block=jb)),
                    t_(lambda: fa.flash_bwd_dq_reference(*args, acc_block=jb)),
                    t_(lambda: torch.autograd.grad(lo, (ql,), gh, retain_graph=True)),
                    _nbytes(q, k, v, do, lw, di, gl, km, qs, ks, qp, kp, dq),
                    "flash_bwd_dq"),
            }
            for name, (ms, plain_ms, lib_ms, nbytes, kernel) in times.items():
                bound, by = attention_bound_ms(kernel, pairs, d, dtype, nbytes)
                row[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                             "bound_ms": bound, "bound_by": by, "pairs": pairs}
            del ql, kl, vl, lo, gh
        rows[label] = row
        log(f"flash acc16 {label}: {json.dumps(row)}  [{card}]")
        del q, k, v, do, ow, lw, dk, dv, dq, dkw, dvw, dqw, args
        if on_card:
            torch.cuda.empty_cache()

    # the accumulator's path: the public entry point, forward and backward
    b, t, h, d = CHAR_BATCH, CHAR_T, WIDE_CHAR_HEADS, WIDE_HEAD
    q, k, v, g = (torch.randn(b, t, h, d, device=dev, generator=gen).requires_grad_()
                  for _ in range(4))
    torch.cuda.synchronize()
    zero_launches()   # the path's run starts here
    out = fa.flash_attention(q, k, v, causal=True, bwd_acc_dtype="bfloat16")
    grads = torch.autograd.grad(out, (q, k, v), g)
    acc16_launches = all_launches()   # ... and ends here
    expect_launches("the bfloat16 accumulator's path", acc16_launches,
                    flash_fwd_wide=1, flash_bwd_dkv_acc16=1, flash_bwd_dq_acc16=1)
    if not all(torch.isfinite(x).all() for x in grads):
        raise RuntimeError("the bfloat16 accumulator's path: gradients not finite")
    rows["acc16_path"] = {"launches": acc16_launches, "shape": [b, t, h, d]}
    del q, k, v, g, out, grads

    decode_rows = {}
    for label, b, t, h, d, dtype, layers, timed in DECODE_WIDE_CASES:
        q, k, v, lens = decode_wide_inputs(torch, label, b, t, h, d, dtype, layers, dev)
        row = time_decode_wide(torch, fa, label, q, k, v, lens, timed, on_card)
        worst["decode_attention_wide"] = max(worst.get("decode_attention_wide", 0.0),
                                             row["max_abs_err"])
        rows[label] = decode_rows[label] = row
        log(f"decode wide {label}: {json.dumps(row)}  [{card}]")
        del q, k, v, lens
        if on_card:
            torch.cuda.empty_cache()

    src = "deeplearning4j_torch/ops/csrc/flash_attention.cu"
    tpu = "deeplearning4j_tpu/ops/flash_attention.py"
    arms = [("flash_fwd_wide", f"{tpu}:139", "wide_model_f32"),
            ("flash_bwd_dkv_wide", f"{tpu}:193", "wide_model_f32"),
            ("flash_bwd_dq_wide", f"{tpu}:237", "wide_model_f32"),
            ("flash_bwd_dkv_acc16", f"{tpu}:193", "acc16_model_f32_128"),
            ("flash_bwd_dq_acc16", f"{tpu}:237", "acc16_model_f32_128")]
    entries = []
    for name, replaces, case in arms:
        r = rows[case][name]
        entries.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": None,
                        "max_abs_err": worst[name], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "case": case, "sdpa_backend": rows[case].get("sdpa_backend"),
                        "cluster": rows[case]["geometry"]["cluster"]})
    r = rows["wide_engine_f32"]
    entries.append({"name": "decode_attention_wide", "route": "cuda",
                    "source": "deeplearning4j_torch/ops/csrc/decode_attention.cu",
                    "replaces": f"{tpu}:573", "launches": None,
                    "max_abs_err": worst["decode_attention_wide"],
                    **{key: r[key] for key in ("ms", "ms_cold", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")},
                    "case": "wide_engine_f32", "sdpa_backend": r["sdpa_backend"],
                    "cases": {lab: {key: row[key] for key in ("ms", "ms_cold", "bound_ms")}
                              for lab, row in decode_rows.items() if "ms" in row}})
    for e in entries:
        if e["name"] in ("flash_bwd_dkv_acc16", "flash_bwd_dq_acc16"):
            e["launches"] = acc16_launches[e["name"]]
    return entries, rows


WIDE_CHAR_FULL = dict(width=WIDE_CHAR_WIDTH, heads=WIDE_CHAR_HEADS, t=CHAR_T,
                      batch=CHAR_BATCH, steps=CHAR_STEPS, small_t=CHAR_SMALL_T)


def _fit_counted(torch, net, data, label, card, s, want):
    """`fit` over s["steps"] batches of s["batch"] rows with every count
    reset just before and read just after (`all_launches`); the counts must
    be `want` and every score finite. Returns (launches, scores, step ms,
    median warm step ms)."""
    steps = Steps()
    net.listeners[:] = [steps]
    torch.cuda.synchronize()
    zero_launches()   # the main path's run starts here
    t0 = time.perf_counter()
    net.fit(data, epochs=1, batch_size=s["batch"])
    launches = all_launches()   # ... and ends here
    net.listeners.clear()
    expect_launches(f"char model {label}", launches, **want)
    if len(steps.scores) != s["steps"] or not all(np.isfinite(steps.scores)):
        raise RuntimeError(f"char model {label}: scores {steps.scores}")
    step_ms = (np.diff([t0] + steps.ends) * 1e3).tolist()
    warm = float(np.median(step_ms[1:] or step_ms))
    log(f"char model {label}: launches {json.dumps(launches)}, scores {steps.scores}, "
        f"step ms {step_ms}, median warm {warm:.3f} ms, "
        f"{s['batch'] * s['t'] / warm * 1e3:.1f} tokens/s  [{card}]")
    return launches, steps.scores, step_ms, warm


def phase_char_model_wide(torch, card, device=None, size=None):
    """The char model with 256-wide heads: bench.py's attention_longctx stack
    (two causal SelfAttentionLayers and an RnnOutputLayer, 96 characters) at
    width 1024 over 4 heads, t 8192, batch 4, built with the config DSL and a
    MultiLayerNetwork, every attention call on the sliced arms. In float32
    and as a bfloat16 network: `output` (the sliced K3 once a layer, nothing
    else), then `fit` for CHAR_STEPS steps (the sliced K3, K4 and K5 once a
    layer a step), the counts reset just before and read just after each;
    the median warm step, tokens/s and one profiled step in each type. Then the
    float32 gradients with the kernels against the plain versions on the
    card (`compare_pinned_grads`, as `phase_char_model` at width 512), and
    the card against the CPU path at t CHAR_SMALL_T, the flash route forced
    (gradients and output)."""
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.ops import attention as att
    from deeplearning4j_torch.ops import flash_attention as fa
    from deeplearning4j_torch.utils import params as param_utils
    s = dict(WIDE_CHAR_FULL, **(size or {}))
    dev = device or "cuda"
    on_card = torch.device(dev).type == "cuda"
    layers = 2
    result = {"card": card, **s, "head_dim": s["width"] // s["heads"]}
    if s["width"] // s["heads"] <= fa.MAX_HEAD_DIM:
        raise RuntimeError(f"the wide char model's heads are {s['width'] // s['heads']} "
                           f"wide: not the sliced arms")
    choice = att.select_attention_impl(s["t"], s["width"] // s["heads"])
    if s["t"] >= 2048 and choice != "pallas":
        raise RuntimeError(f"the dispatch rule picked {choice} at t={s['t']}")
    data = char_data(s["steps"] * s["batch"], s["t"], seed=2424)
    batch = DataSet(data.features[:s["batch"]], data.labels[:s["batch"]], None,
                    data.labels_mask[:s["batch"]])
    # the rule's own choice at full length; a cut run forces the flash route
    rule = "auto" if s["t"] >= 2048 else "pallas"
    conf = lambda impl=rule: char_conf(impl=impl, width=s["width"], heads=s["heads"])
    fwd = {"flash_fwd_wide": layers}
    step = {"flash_fwd_wide": layers * s["steps"], "flash_bwd_dkv_wide": layers * s["steps"],
            "flash_bwd_dq_wide": layers * s["steps"]}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        net = MultiLayerNetwork(conf()).init(dtype=dtype, device=dev)
        torch.cuda.synchronize()
        zero_launches()   # output's run starts here
        t0 = time.perf_counter()
        out = net.output(data.features[:s["batch"]])
        out_ms = (time.perf_counter() - t0) * 1e3
        out_launches = all_launches()   # ... and ends here
        expect_launches(f"wide char model {name} output", out_launches, **fwd)
        if out.shape != (s["batch"], s["t"], CHAR_VOCAB) or not np.isfinite(out).all():
            raise RuntimeError(f"wide char model {name}: output {out.shape} not finite "
                               f"or misshapen")
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
        launches, scores, step_ms, warm = _fit_counted(
            torch, net, data, f"wide {name} fit", card, s, step)
        result[name] = {"params": net.num_params(), "output_launches": out_launches,
                        "output_ms": out_ms, "launches": launches, "scores": scores,
                        "step_ms": step_ms, "median_warm_step_ms": warm,
                        "tokens_per_s": s["batch"] * s["t"] / warm * 1e3}
        def one_step():
            net.fit(batch, batch_size=s["batch"])
            torch.cuda.synchronize()
        result["profile" if name == "f32" else "profile_bf16"] = profile_call(
            torch, f"wide char model step ({name})", one_step,
            {"batch": s["batch"], "t": s["t"]})
        if name == "f32":
            kept = net
        else:
            del net
        if on_card:
            torch.cuda.empty_cache()

    def run(model, plain=False, checked=True):
        """compute_gradient_and_score on the kernels (their launches held),
        on the plain versions (none launched), or, unchecked, on the CPU."""
        def grads(ds, record, flips):
            before = all_launches()
            with ExitStack() as stack:
                stack.enter_context(pinned_kinks(torch, model, record, flips))
                if plain:
                    stack.enter_context(patched(fa, "flash_fwd", fa.flash_fwd_reference))
                    stack.enter_context(patched(fa, "flash_bwd", fa.flash_bwd_reference))
                out = model.compute_gradient_and_score(ds)
            ran = {k: v - before[k] for k, v in all_launches().items()}
            if checked:
                expect_launches("compute_gradient_and_score", ran, **({} if plain else {
                    "flash_fwd_wide": layers, "flash_bwd_dkv_wide": layers,
                    "flash_bwd_dq_wide": layers}))
            return out
        return grads

    result["grad_rel_vs_plain"] = compare_pinned_grads(
        f"wide char model: kernels vs plain attention, f32, t {s['t']}, batch "
        f"{s['batch']}", torch, param_utils, run(kept), run(kept, plain=True),
        char_data(s["batch"], s["t"], seed=2425))
    del kept
    if on_card:
        torch.cuda.empty_cache()

    small = conf(impl="pallas")
    card_net = MultiLayerNetwork(small).init(dtype=torch.float32, device=dev)
    cpu_net = MultiLayerNetwork(small).init(device="cpu")
    cpu_net.params_tree = tuple({k: v.cpu() for k, v in layer.items()}
                                for layer in card_net.params_tree)
    small_ds = char_data(2, s["small_t"], seed=2426)
    result["grad_rel_vs_cpu"] = compare_pinned_grads(
        f"wide char model: card vs CPU path, f32, t {s['small_t']}, batch 2", torch,
        param_utils, run(card_net), run(cpu_net, checked=False), small_ds)
    np.testing.assert_allclose(card_net.output(small_ds.features),
                               cpu_net.output(small_ds.features), rtol=1e-4, atol=1e-6)
    log(f"wide char model: "
        f"{json.dumps({k: v for k, v in result.items() if not k.startswith('profile')})}"
        f"  [{card}]")
    return result


# the decoder with 256-wide heads: Gemma 2B's widths (8 heads of 256, d_model
# 2048, ff 16384) on the port's decoder (multi-head, its own MLP: only the
# widths are taken), depth cut to 4 layers; the rest bench_serving_decode's
DECODE_WIDE_GEOMETRY = dict(vocab=256, layers=4, heads=8, head_dim=256, ff=16384,
                            max_context=256, max_decode_batch=8, block_tokens=16,
                            kv_max_blocks=256, pack_bucket=128, clients=6,
                            prompts_per_client=4, max_new_tokens=48, prompt_lo=4,
                            prompt_hi=33)


def phase_decode_wide(torch, card, device=None, size=None):
    """The decode engine on a decoder with 256-wide heads
    (DECODE_WIDE_GEOMETRY: TransformerDecoder(seed=7) 4 layers x 8 heads of
    256, ff 16384, vocab 256, max_context 256, behind DecodeEngine(max_decode_
    batch 8) over a PagedKVCache; 6 clients x 4 prompts of 4-32 tokens x 48
    new tokens). Every count is reset just before the clients start and read
    just after: K7w must have launched layers x the decode steps
    taken, and nothing else. Then the same prompts again with K7 bound to its
    plain version (`decode_attention_reference` standing in for the launch):
    every answer must be the same, token for token, and so must
    `naive_generate`'s (full recompute, no cache). Reports tokens/s and
    inter-token p50/p99 of the kernel's run, the plain run's tokens/s, and
    one step of 8 rows under the profiler (`profile_decode_step`: device
    busy time, idle share, K7w's share of the busy time)."""
    from deeplearning4j_torch.optimize.metrics import registry
    from deeplearning4j_torch.ops import flash_attention as fa
    from deeplearning4j_torch.serving import decode as sd
    g = dict(DECODE_WIDE_GEOMETRY, **(size or {}))
    name = "chip_smoke_decode_wide"
    on_card = torch.device(device or "cuda").type == "cuda"
    eng, model, cache = decode_engine(g, name, device)
    try:
        n = g["clients"] * g["prompts_per_client"]
        rng = np.random.default_rng(24)
        prompts = [rng.integers(0, g["vocab"], size=ln).tolist()
                   for ln in rng.integers(g["prompt_lo"], g["prompt_hi"], size=n)]
        eng.generate(prompts[0], max_new_tokens=2)   # unmeasured seeding pass
        reg = registry()
        steps_c = reg.counter("serving_decode_steps_total").labels(model=name)
        itl_h = reg.histogram("serving_inter_token_ms",
                              buckets=sd.INTER_TOKEN_BUCKETS_MS).labels(model=name)
        steps0, itl0 = steps_c.value(), len(itl_h.window_values())
        torch.cuda.synchronize()
        zero_launches()   # the main path's run starts here
        results, wall = run_generate_clients(eng, prompts, g["prompts_per_client"],
                                             g["max_new_tokens"])
        launches = all_launches()   # ... and ends here
        steps = int(steps_c.value() - steps0)
        itl = np.asarray(itl_h.window_values()[itl0:], np.float64)
        expect_launches("wide decode serving", launches,
                        decode_attention_wide=g["layers"] * steps)
        bad = {i: r for i, r in results.items() if not isinstance(r, list)}
        if bad or len(results) != n:
            raise RuntimeError(f"wide decode serving: failed requests {bad!r}")
        plain = lambda q, k, v, cache_len, **kw: fa.decode_attention_reference(
            q, k, v, cache_len)
        with patched(fa, "_launch_decode", plain):
            zero_launches()
            plain_results, plain_wall = run_generate_clients(
                eng, prompts, g["prompts_per_client"], g["max_new_tokens"])
            if on_card:   # (the CPU's route is the plain version itself)
                expect_launches("wide decode serving, K7 bound to its plain version",
                                all_launches())
        diverged = [i for i in range(n) if results[i] != plain_results.get(i)]
        if diverged:
            raise RuntimeError(f"wide decode serving: K7's answers differ from the plain "
                               f"version's for prompts {diverged}")
        naive = [sd.naive_generate(model, p, g["max_new_tokens"], pad_to=g["pack_bucket"])
                 for p in prompts]
        diverged = [i for i in range(n) if results[i] != naive[i]]
        if diverged:
            raise RuntimeError(f"wide decode serving: the engine's tokens differ from "
                               f"naive_generate's for prompts {diverged}")
        if cache.blocks_in_use() != 0:
            raise RuntimeError(f"wide decode serving: {cache.blocks_in_use()} KV blocks "
                               f"left after the last retire")
        profile = profile_decode_step(torch, eng, cache, prompts, g["max_decode_batch"],
                                      g["layers"], kernel=K7W_KERNEL)
    finally:
        eng.shutdown()
    tokens = n * g["max_new_tokens"]
    result = {"geometry": {k: g[k] for k in ("layers", "heads", "head_dim", "ff", "vocab",
                                             "max_context", "max_decode_batch")},
              "requests": n, "tokens": tokens, "steps": steps, "launches": launches,
              "wall_s": wall, "tokens_per_s": tokens / wall,
              "plain_k7_tokens_per_s": tokens / plain_wall,
              "inter_token_p50_ms": float(np.percentile(itl, 50)),
              "inter_token_p99_ms": float(np.percentile(itl, 99)),
              "inter_token_samples": int(itl.size), "all_equal_plain": True,
              "all_equal_naive": True, "step_profile": profile, "card": card}
    log(f"wide decode serving: {json.dumps(result)}  [{card}]")
    return result


# ----------------------------------- the fit loop on the packed char model

FIT_SEQS, FIT_SEQ_MIN = 16, 512   # ragged sequences of FIT_SEQ_MIN..CHAR_T tokens
FIT_BASE_BATCH = 8                # sequences a base batch, before packing
PACKED_RTOL = 1e-4   # packed vs unpacked score: phase_char_model's output rtol
FIT_TIMED_EPOCHS = 3   # timed epochs each way, the median kept


def ragged_char_data(n, t, lo, seed):
    """`n` sequences of one-hot characters, their successors as labels, with
    lengths uniform in [lo, t] from a numpy seed, padded to `t` with a 0/1
    features and labels mask. Returns (DataSet, lengths)."""
    from deeplearning4j_torch.data.dataset import DataSet
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, t + 1, n)
    idx = rng.integers(0, CHAR_VOCAB, (n, t))
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    x, y = eye[idx] * mask[..., None], eye[np.roll(idx, -1, 1)] * mask[..., None]
    return DataSet(x, y, mask, mask.copy()), lengths


def _base_batches(ds, size):
    from deeplearning4j_torch.data.dataset import DataSet
    return [DataSet(ds.features[i:i + size], ds.labels[i:i + size],
                    ds.features_mask[i:i + size], ds.labels_mask[i:i + size])
            for i in range(0, ds.num_examples(), size)]


class _Iterations:
    """Listener: every iteration number, and the parameters (cloned) at
    iteration `keep_at`."""

    def __init__(self, torch, keep_at=None):
        self.torch, self.keep_at = torch, keep_at
        self.seen, self.params = [], None

    def iteration_done(self, model, iteration):
        from deeplearning4j_torch.utils import params as param_utils
        self.seen.append(iteration)
        if iteration == self.keep_at:
            self.params = param_utils.tree_map(self.torch.clone, model.params_tree)


def phase_fit_loop_char(torch, card, device=None):
    """(b) The fit loop on the char model at bench.py's attention_longctx
    width (two causal SelfAttentionLayer(512, 4 heads), bfloat16, the flash
    route) with `packed_segments`: FIT_SEQS ragged sequences of
    FIT_SEQ_MIN..CHAR_T tokens from a seed, in base batches of
    FIT_BASE_BATCH, packed by PackToBucketIterator(bucket_len=CHAR_T,
    rows=CHAR_BATCH), so segment ids reach K3-K5 at full width. The main
    path: one epoch of `fit` over the packed batches with a CheckpointManager
    saving after the next-to-last step, K3-K5 counts reset just before and
    read just after (2 a step each). Checks: the first packed batch's score
    equals its sequences' unpacked score (PACKED_RTOL); a fresh network's
    `fit(..., resume=True)` from that checkpoint takes the last step and
    ends bitwise where the main path did; a DivergenceSentinel("skip_step") tripped by an injected
    ``step.nonfinite`` on the second step leaves the parameters bitwise as
    after the first. Then real tokens/s, packed against the same sequences
    padded one a row (the median of FIT_TIMED_EPOCHS warm epochs each,
    taken in turns)."""
    import shutil
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.data.iterators import (ExistingDataSetIterator,
                                                     PackToBucketIterator)
    from deeplearning4j_torch.data.padding import first_fit_pack
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.ops import flash_attention as fa
    from deeplearning4j_torch.optimize.resilience import (CheckpointManager,
                                                          DivergenceSentinel)
    from deeplearning4j_torch.utils import faults
    conf = char_conf(impl="pallas", packed=True)
    make = lambda: MultiLayerNetwork(conf).init(dtype=torch.bfloat16, device=device)
    data, lengths = ragged_char_data(FIT_SEQS, CHAR_T, FIT_SEQ_MIN, seed=2032)
    bases = _base_batches(data, FIT_BASE_BATCH)
    packed = lambda: PackToBucketIterator(ExistingDataSetIterator(bases),
                                          bucket_len=CHAR_T, rows=CHAR_BATCH)
    batches = list(packed())
    real = int(lengths.sum())
    result = {"card": card, "t": CHAR_T, "rows": CHAR_BATCH, "sequences": FIT_SEQS,
              "real_tokens": real, "packed_batches": len(batches),
              "packed_util": real / (len(batches) * CHAR_BATCH * CHAR_T)}
    steps = len(batches)
    if steps < 2:
        raise RuntimeError(f"{steps} packed batch: the checks need two")
    ckpt_dir = os.path.join(ROOT, "build", "fit_loop_char_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    manager = lambda: CheckpointManager(ckpt_dir, save_every_n_iterations=steps - 1,
                                        save_every_n_epochs=None)

    # 1. the main path: one epoch of packed batches, checkpointing
    net = make()
    torch.cuda.synchronize()
    _zero_counts(fa)   # the main path's run starts here
    net.fit(packed(), checkpoint=manager())
    launches = _counts(fa)   # ... and ends here
    if launches != dict.fromkeys(launches, 2 * steps) or net.iteration != steps:
        raise RuntimeError(f"packed char model: {net.iteration} steps, launches "
                           f"{launches}, expected {2 * steps} of each")
    if not np.isfinite(float(net.score_value)):
        raise RuntimeError(f"packed char model: score {float(net.score_value)}")
    result["launches"] = launches
    result["etl"] = {"last_etl_ms": net.last_etl_ms,
                     "last_etl_host_ms": net.last_etl_host_ms,
                     "last_etl_h2d_ms": net.last_etl_h2d_ms}

    # 2. packed against unpacked score, on the first packed batch's sequences
    first = first_fit_pack(lengths[:FIT_BASE_BATCH], CHAR_T)[:CHAR_BATCH]
    members = sorted(i for b in first for i in b)
    base = bases[0]
    unpacked = DataSet(base.features[members], base.labels[members],
                       base.features_mask[members], base.labels_mask[members])
    s_packed, s_unpacked = net.score(batches[0]), net.score(unpacked)
    rel = abs(s_packed - s_unpacked) / abs(s_unpacked)
    if not rel <= PACKED_RTOL:
        raise RuntimeError(f"packed score {s_packed} vs unpacked {s_unpacked}")
    result["packed_vs_unpacked_score"] = {"packed": s_packed, "unpacked": s_unpacked,
                                          "rel": rel, "sequences": len(members)}

    # 3. resume: a fresh network from the checkpoint takes the last step
    resumed, ran = make(), _Iterations(torch)
    resumed.listeners.append(ran)
    resumed.fit(packed(), resume=True, checkpoint=manager())
    if ran.seen != [steps]:
        raise RuntimeError(f"resumed packed fit ran iterations {ran.seen}, "
                           f"not {[steps]}")
    result["resume"] = _require_same("resumed packed fit", resumed, net)
    result["resume"]["from_iteration"] = steps - 1
    del resumed
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # 4. the sentinel drops a step flagged non-finite
    guarded, after_first = make(), _Iterations(torch, keep_at=1)
    guarded.listeners.append(after_first)
    sentinel = DivergenceSentinel("skip_step")
    with faults.injected("step.nonfinite", "fail:2"):
        guarded.fit(ExistingDataSetIterator(batches[:2]), sentinel=sentinel)
    if sentinel.nonfinite_steps != 1 or guarded.iteration != 1 or \
            not _same_tree(guarded.params_tree, after_first.params):
        raise RuntimeError(f"skip_step: {sentinel.nonfinite_steps} flagged, "
                           f"iteration {guarded.iteration}, parameters as after "
                           f"step 1: {_same_tree(guarded.params_tree, after_first.params)}")
    result["skip_step"] = {"flagged": sentinel.nonfinite_steps, "bitwise": True}
    del guarded

    # 5. real tokens/s: packed against the same sequences padded one a row,
    # FIT_TIMED_EPOCHS warm epochs each in turns, the median epoch
    runs = {"packed": (net, packed, steps),
            "padded": (make(), lambda: ExistingDataSetIterator(
                _base_batches(data, CHAR_BATCH)), -(-FIT_SEQS // CHAR_BATCH))}
    epochs_ms = {name: [] for name in runs}
    for name, (model, source, _) in runs.items():
        model.fit(source())   # warm
    for _ in range(FIT_TIMED_EPOCHS):
        for name, (model, source, _) in runs.items():
            epochs_ms[name].append(timed_fit_ms(torch, model, source()))
    timing = {}
    for name, (_, _, n_steps) in runs.items():
        ms = float(np.median(epochs_ms[name]))
        timing[name] = {"epoch_ms": ms, "epochs_ms": epochs_ms[name],
                        "steps": n_steps, "real_tokens_per_s": real / ms * 1e3,
                        "util": real / (n_steps * CHAR_BATCH * CHAR_T)}
    timing["packed_over_padded"] = (timing["packed"]["real_tokens_per_s"]
                                    / timing["padded"]["real_tokens_per_s"])
    result["timing"] = timing
    log(f"packed char model: {json.dumps(result)}  [{card}]")
    return result


# ------------------------------------------------- the recurrent slice

# bench.py's bench_lstm (BASELINE.md's GravesLSTM char-RNN row): 77
# characters, batch 128 x 64 steps; the zoo's tBPTT of 50 cuts each batch
# into windows of 50 and 14
TEXT_LABELS, TEXT_BATCH, TEXT_T, TEXT_BATCHES = 77, 128, 64, 4
STREAM_RTOL, STREAM_ATOL = 1e-4, 1e-6   # rnn_time_step step by step vs output
STREAM_ROWS = 8
MLN_RNN_ZIP = os.path.join(FIXTURES, "checkpoints", "mln_rnn.zip")
RESUME_REL = 1e-5   # a resumed step, card vs CPU: relative norm per leaf


def text_data(rows, t, seed):
    """One-hot characters [rows, t, TEXT_LABELS] and their successors, from
    a numpy seed."""
    idx = np.random.default_rng(seed).integers(0, TEXT_LABELS, (rows, t + 1))
    eye = np.eye(TEXT_LABELS, dtype=np.float32)
    return eye[idx[:, :-1]], eye[idx[:, 1:]]


class CarryWindows:
    """Listener: for each truncated-BPTT window, whether the network held a
    carry there, and whether every carry tensor was detached (no autograd
    history to cross into the next window)."""

    def __init__(self):
        self.windows = []

    def iteration_done(self, model, iteration):
        from deeplearning4j_torch.utils import params as param_utils
        leaves = param_utils.tree_leaves(model._rnn_carry)
        self.windows.append(bool(leaves) and all(
            t.grad_fn is None and not t.requires_grad for t in leaves))


def _to_cpu_mln(net):
    """A MultiLayerNetwork on the CPU with `net`'s parameters, optimizer
    state and layer state."""
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.utils import params as param_utils
    cpu = MultiLayerNetwork(net.conf).init(dtype=net._dtype, device="cpu")
    cpu.params_tree, cpu.opt_state, cpu.state_tree = (
        param_utils.tree_map(lambda t: t.cpu(), tree)
        for tree in (net.params_tree, net.opt_state, net.state_tree))
    cpu.iteration = net.iteration
    return cpu


def gradient_run(torch, model):
    """A `compare_pinned_grads` run: `compute_gradient_and_score` (train
    False) under `pinned_kinks`."""
    def run(ds, record, flips):
        with pinned_kinks(torch, model, record, flips):
            return model.compute_gradient_and_score(ds)
    return run


def check_streaming(torch, net, x):
    """`rnn_time_step` over the steps of `x` one at a time from a cleared
    carry against `output` on the whole sequence (STREAM_RTOL, STREAM_ATOL);
    then a call with another batch size must raise RnnStateMismatchError
    and leave no carry. Returns the error and ms a step."""
    from deeplearning4j_torch.nn.multilayer import RnnStateMismatchError
    whole = net.output(x)
    net.rnn_clear_previous_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = np.stack([net.rnn_time_step(x[:, t]) for t in range(x.shape[1])], 1)
    step_ms = (time.perf_counter() - t0) * 1e3 / x.shape[1]
    np.testing.assert_allclose(streamed, whole, rtol=STREAM_RTOL, atol=STREAM_ATOL)
    try:
        net.rnn_time_step(np.concatenate([x[:, 0], x[:1, 0]]))   # one row more
    except RnnStateMismatchError:
        pass
    else:
        raise RuntimeError("rnn_time_step took another batch size than its carry's")
    if net._rnn_carry is not None:
        raise RuntimeError("a refused rnn_time_step left its carry behind")
    net.rnn_clear_previous_state()
    return {"rows": x.shape[0], "steps": x.shape[1],
            "max_abs_vs_output": float(np.abs(streamed - whole).max()),
            "ms_per_step": step_ms, "mismatch_raised_and_reset": True}


def sequence_requests(rng, clients=4, per_client=8):
    """The serving load of a character model: per client, `per_client`
    requests of 1-8 one-hot sequences of TEXT_T steps."""
    eye = np.eye(TEXT_LABELS, dtype=np.float32)
    return [[eye[rng.integers(0, TEXT_LABELS, (int(rng.integers(1, 9)), TEXT_T))]
             for _ in range(per_client)] for _ in range(clients)]


SERVE_BATCH_LIMIT = 32   # the serving phases' ParallelInference batch_limit


def serve_checked(torch, net, reqs, label, check_finite=False, time_steps=None):
    """`net` behind a BATCHED ParallelInference (SERVE_BATCH_LIMIT) with the
    client load `reqs`, every count reset just before the clients start and
    read just after: none of K1-K6 may run. Each answer finite and bitwise
    the rows of the batch it was served in (`check_served_batches`), whose
    `net.output` gives it again; latencies from a second, unchecked run.
    Returns (latency stats with the forwards and launches, answers)."""
    from deeplearning4j_torch.parallel.inference import (InferenceMode,
                                                          ParallelInference)
    rows = sum(x.shape[0] for xs in reqs for x in xs)
    pi = ParallelInference(net, inference_mode=InferenceMode.BATCHED,
                           batch_limit=SERVE_BATCH_LIMIT, check_finite=check_finite)
    batches = []
    try:
        pi.warmup(time_steps=time_steps)
        with recorded_outputs(net, batches):
            f0 = pi.total_forwards
            zero_launches()   # the main path's run starts here
            answers, _, _ = run_clients(pi, reqs)
            launches = all_launches()   # ... and ends here
            forwards = pi.total_forwards - f0
        check_launches(label, launches, dict.fromkeys(launches, 0))
        f0 = pi.total_forwards
        _, lat, wall = run_clients(pi, reqs)
        timed_forwards = pi.total_forwards - f0
    finally:
        pi.shutdown()
    if forwards < 1 or timed_forwards < 1:
        raise RuntimeError(f"{label} executed no forward")
    for (c, j), out in answers.items():
        if out.shape[0] != reqs[c][j].shape[0] or not np.isfinite(out).all():
            raise RuntimeError(f"{label}: bad answer {out.shape}")
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
    rechecked = check_served_batches(net, batches, reqs, answers)
    stats = latency_stats(lat, rows, wall)
    stats.update(forwards=forwards, launches=launches, batches_rechecked=rechecked)
    return stats, answers


def phase_text_generation(torch, card):
    """Zoo TextGenerationLSTM (two GravesLSTM(256) + RnnOutputLayer, RmsProp
    0.1, l2 1e-3, truncated BPTT 50) at bench.py's bench_lstm width: 77
    characters, batch 128 x 64 steps, float32 (TF32 off), `init()` on CUDA
    by default. `fit` over TEXT_BATCHES batches, each two windows (50 and
    14) and so two optimizer steps, with every count reset just before and
    read just after (no kernel of K1-K6 sits on this path: the JAX LSTM is a
    lax.scan in plain XLA); every window held a detached carry, and none is
    left after each batch; scores finite. The median warm batch, tokens/s,
    and one profiled batch (device busy against wall: the per-step loop of
    small launches is host-bound). Gradients card vs CPU on a batch of 2 x
    64 (`compare_pinned_grads`, GRAD_REL); `rnn_time_step` step by step
    against `output` (`check_streaming`); served behind ParallelInference
    (`serve_checked`); a checkpoint round trip bitwise."""
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.models.zoo import TextGenerationLSTM
    from deeplearning4j_torch.utils import params as param_utils
    net = TextGenerationLSTM(num_labels=TEXT_LABELS,
                             input_shape=(TEXT_T, TEXT_LABELS)).init()
    shape = {"layers": [type(layer).__name__ for layer in net.layers],
             "hidden": net.layers[0].n_out, "params": net.num_params(),
             "tbptt": net.conf.tbptt_fwd_length}
    x, y = text_data(TEXT_BATCHES * TEXT_BATCH, TEXT_T, seed=2050)
    windows = -(-TEXT_T // net.conf.tbptt_fwd_length)
    steps, carry = Steps(), CarryWindows()
    net.listeners[:] = [steps, carry]
    batch_ms, cleared = [], []
    zero_launches()   # the main path's run starts here
    for b in range(TEXT_BATCHES):
        rows = slice(b * TEXT_BATCH, (b + 1) * TEXT_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x[rows], y[rows], batch_size=TEXT_BATCH)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        cleared.append(net._rnn_carry is None)
    launches = all_launches()   # ... and ends here
    net.listeners.clear()
    check_launches("TextGenerationLSTM training", launches, dict.fromkeys(launches, 0))
    if net.iteration != windows * TEXT_BATCHES or not all(np.isfinite(steps.scores)):
        raise RuntimeError(f"TextGenerationLSTM: {net.iteration} steps, scores "
                           f"{steps.scores}")
    if not all(cleared) or len(carry.windows) != net.iteration or not all(carry.windows):
        raise RuntimeError(f"TextGenerationLSTM: carry cleared after each batch "
                           f"{cleared}, held detached in each window {carry.windows}")
    warm_ms = float(np.median(batch_ms[1:]))

    def one_batch():
        net.fit(x[:TEXT_BATCH], y[:TEXT_BATCH], batch_size=TEXT_BATCH)
        torch.cuda.synchronize()

    profile = profile_call(torch, "fit batch TextGenerationLSTM", one_batch,
                           {"batch": TEXT_BATCH, "steps": TEXT_T, "windows": windows})
    cpu_net = _to_cpu_mln(net)
    vs_cpu = compare_pinned_grads("TextGenerationLSTM: card vs CPU path, batch 2",
                                  torch, param_utils, gradient_run(torch, net),
                                  gradient_run(torch, cpu_net), DataSet(x[:2], y[:2]))
    del cpu_net
    stream = check_streaming(torch, net, x[:STREAM_ROWS])
    serving, _ = serve_checked(torch, net, sequence_requests(np.random.default_rng(2051)),
                               "TextGenerationLSTM serving", time_steps=TEXT_T)
    ckpt = check_checkpoint_round_trip(net, x[:4], "TextGenerationLSTM")
    result = {"shape": shape, "batch": TEXT_BATCH, "steps": TEXT_T,
              "windows_per_batch": windows, "launches": launches,
              "scores": steps.scores, "batch_ms": batch_ms,
              "median_warm_batch_ms": warm_ms,
              "tokens_per_s": TEXT_BATCH * TEXT_T / warm_ms * 1e3,
              "profile": profile, "grad_rel_vs_cpu": vs_cpu, "streaming": stream,
              "serving": serving, "checkpoint": ckpt, "card": card}
    log(f"TextGenerationLSTM: batch ms {batch_ms}, median warm {warm_ms:.3f} ms, "
        f"{result['tokens_per_s']:.1f} tokens/s; one batch busy "
        f"{profile.get('device_busy_ms')} ms of {profile['wall_ms']:.3f} ms wall "
        f"(idle {profile.get('device_idle_share')}); served p50 "
        f"{serving['p50_ms']:.3f} ms, {serving['images_per_s']:.1f} sequences/s  "
        f"[{card}]")
    log(f"TextGenerationLSTM: {json.dumps(result)}")
    return result


def phase_rnn_checkpoint(torch, card, device=None):
    """The JAX package's `mln_rnn.zip` (LSTM(8) + RnnOutputLayer(3), Adam)
    restored by `restore_model`, on the card by default: its output against
    `expected.npz` (rtol 1e-5, atol 1e-6, as the JAX package's own test);
    one resumed `fit` step on the card against the same step from the CPU's
    restore (score SCORE_RTOL, parameters and Adam state RESUME_REL per
    leaf); then the resumed network's checkpoint round trip, bitwise."""
    from deeplearning4j_torch.utils import model_serializer as ser
    from deeplearning4j_torch.utils import params as param_utils
    expected = np.load(os.path.join(FIXTURES, "checkpoints", "expected.npz"))
    net = ser.restore_model(MLN_RNN_ZIP, device=device)
    cpu = ser.restore_model(MLN_RNN_ZIP, device="cpu")
    if net._rnn_carry is not None or param_utils.tree_leaves(net.state_tree):
        raise RuntimeError("mln_rnn.zip restored with a carry or a layer state")
    x = expected["mln_rnn_x"]
    out = net.output(x)
    np.testing.assert_allclose(out, expected["mln_rnn_y"], rtol=1e-5, atol=1e-6)
    y = np.eye(3, dtype=np.float32)[np.arange(x.shape[0] * x.shape[1]).reshape(
        x.shape[:2]) % 3]
    it0 = net.iteration
    net.fit(x, y, batch_size=len(x))
    cpu.fit(x, y, batch_size=len(x))
    if not net.iteration == cpu.iteration == it0 + 1:
        raise RuntimeError(f"mln_rnn.zip resumed to {net.iteration}, {cpu.iteration}")
    s_card, s_cpu = float(net.score_value), float(cpu.score_value)
    if not abs(s_card - s_cpu) <= SCORE_RTOL * abs(s_cpu):
        raise RuntimeError(f"mln_rnn.zip resumed: score {s_card} vs {s_cpu}")
    rel = {}
    for what, mine, theirs in (("params", net.params_tree, cpu.params_tree),
                               ("adam", net.opt_state, cpu.opt_state)):
        for i, (a, b) in enumerate(zip(param_utils.tree_leaves(mine),
                                       param_utils.tree_leaves(theirs))):
            a, b = a.cpu().double(), b.double()
            rel[f"{what}{i}"] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    worst = max(rel.values())
    if not worst <= RESUME_REL:
        raise RuntimeError(f"mln_rnn.zip resumed: card vs CPU {rel}")
    ckpt = check_checkpoint_round_trip(net, x, "mln_rnn.zip resumed")
    result = {"device": str(net.device), "iteration": net.iteration,
              "max_abs_vs_expected": float(np.abs(out - expected["mln_rnn_y"]).max()),
              "resumed_score_card_vs_cpu": [s_card, s_cpu],
              "resumed_worst_rel_vs_cpu": worst, "checkpoint": ckpt, "card": card}
    log(f"mln_rnn.zip: {json.dumps(result)}")
    return result


# --------------------------------------------------------- the face models

FACE_MODELS = (("InceptionResNetV1", (160, 160, 3), 1001),
               ("FaceNetNN4Small2", (96, 96, 3), 5749))
FACE_BATCH, FACE_STEPS = 64, 6
FACE_CALIBRATION = 32   # images of the train-mode forward that sets BN's state
NODE_REL = 1e-5   # a node's output card vs CPU on the same inputs, of its largest value
# The whole train-mode score of a batch of 2, card vs CPU: the forward carries
# each device's rounding through the batch statistics of 107 BNs (of 37 in
# FaceNetNN4Small2), from weights that training on the card leaves different
# in every run; InceptionResNetV1 read 0, 1.4e-5 and 5.2e-5 in three runs on
# an H100. The nodes themselves are held one by one (`check_nodes_one_by_one`).
FACE_SCORE_RTOL = 1e-3


def _face_shape(net):
    kinds = [type(n.layer if n.is_layer() else n.vertex).__name__
             for n in net.conf.nodes.values()]
    return {"nodes": len(kinds), "bn": kinds.count("BatchNormalization"),
            "convs": kinds.count("ConvolutionLayer"),
            "adds": kinds.count("ElementWiseVertex"), "params": net.num_params()}


#: A BN channel whose variance formula magnifies float32 rounding more than
#: this (`bn_cancellation`) is left out of the node-by-node comparison and
#: counted: at 1e3 its output already moves by 1e-4 with either device's
#: rounding.
BN_CANCELLATION_MAX = 1e3


def bn_cancellation(torch, layer, state, x):
    """Per channel, how far a train-mode BatchNormalization magnifies the
    float32 rounding of its input: its single-pass variance, mean((x -
    pivot)^2) - mean(x - pivot)^2 with the running mean as pivot (the JAX
    package's formula), loses the share mean((x - pivot)^2) / (var + eps)
    of its float32 digits; in float64, at least 1. None for another
    layer."""
    from deeplearning4j_torch.nn.layers.convolution import BatchNormalization
    if not isinstance(layer, BatchNormalization):
        return None
    xc = x.detach().double().cpu().reshape(-1, x.shape[-1]) - state["mean"].double().cpu()
    second = (xc * xc).mean(0)
    var = second - xc.mean(0) ** 2
    return torch.clamp_min(second / (var + layer.eps), 1.0)


def bn_grad_factors(torch, net, x):
    """For a graph's card-vs-CPU check on the batch `x`, from each BN
    node's cancellation (`bn_cancellation`, its largest over channels, on
    the card's train-mode activations; at least 1), the factors by which
    the variance formula magnifies float32 rounding: ({layer node: the
    largest among the BN nodes at or after it in topological order, the
    nodes its gradient passes back through}, {BN node: its own})."""
    name_in = net.conf.network_inputs[0]
    with torch.no_grad():
        acts, _, _ = net._walk(net.params_tree, net.state_tree,
                               {name_in: torch.as_tensor(x, device=net.device)},
                               train=True)
    factors, own, running = {}, {}, 1.0
    for name in reversed(net.conf.topo_order):
        node = net.conf.nodes[name]
        if not node.is_layer():
            continue
        cancel = bn_cancellation(torch, node.layer, net.state_tree.get(name),
                                 acts[node.inputs[0]])
        if cancel is not None:
            own[name] = cancel.max().item()
            running = max(running, own[name])
        factors[name] = running
    return factors, own


def check_nodes_one_by_one(torch, net, cpu_net, x):
    """Every node of the graph on the card against the same node on the CPU
    (the same parameters and state), both fed the card's train-mode
    activations of its inputs, so that no difference carries from node to
    node: the output within NODE_REL of its largest value and a BN's new
    state within STATE_RTOL; for a layer, the gradients of its parameters
    and of its input under one random cotangent (the same on both) within
    GRAD_REL relative norm each, the CPU's ReLU and max-pool decisions
    pinned to the card's (`pinned_kinks`, at most MAX_PINNED_SHARE flipped).
    A BN node is compared per channel: a channel of a batch of 2 whose mean
    lies far from the running mean loses most of its float32 digits in BN's
    variance formula, in either package (`bn_cancellation`), so the limits
    are multiplied by the largest such magnification of the channels kept,
    and a channel above BN_CANCELLATION_MAX is left out and counted.
    A whole network's train-mode gradients cannot be held so: at random
    init these ReLU-before-BN stacks carry float32 rounding through the batch
    statistics of later layers into a few % of some gradients (the same
    network on the CPU with the two images swapped). Returns the worst
    errors."""
    name_in = net.conf.network_inputs[0]
    with torch.no_grad():
        acts, _, _ = net._walk(net.params_tree, net.state_tree,
                               {name_in: torch.as_tensor(x, device=net.device)},
                               train=True)
    gen = torch.Generator().manual_seed(2060)
    worst = {"out": 0.0, "grad": 0.0, "state": 0.0, "bn_cancellation": 1.0,
             "share_of_limit": 0.0}
    flipped = entries = left_out = 0

    class One:   # pinned_kinks' view of a single layer
        def __init__(self, layer):
            self.layers = [layer]

    for name in net.conf.topo_order:
        node = net.conf.nodes[name]
        ins = [acts[i] for i in node.inputs]
        if not node.is_layer():
            with torch.no_grad():
                got = node.vertex.forward(ins, train=True, masks=[None] * len(ins))
                want = node.vertex.forward([a.cpu() for a in ins], train=True,
                                           masks=[None] * len(ins))
            err = (got.cpu() - want).abs().max().item() / max(
                want.abs().max().item(), 1e-30)
            if not err <= NODE_REL:
                raise RuntimeError(f"node {name}: card vs CPU {err} (> {NODE_REL})")
            worst["out"] = max(worst["out"], err)
            continue
        layer, record, flips, res = node.layer, [], [], []
        g = None
        for side, model, dev in (("card", net, net.device), ("cpu", cpu_net, "cpu")):
            params = {k: v.detach().clone().requires_grad_()
                      for k, v in model.params_tree[name].items()}
            a = ins[0].detach().to(dev).requires_grad_()
            with torch.enable_grad(), pinned_kinks(torch, One(layer), record,
                                                   None if side == "card" else flips):
                y, st = layer.forward_with_state(params, model.state_tree[name], a,
                                                 train=True)
                if g is None:
                    g = torch.randn(y.shape, generator=gen, dtype=y.dtype)
                leaves = [a] + list(params.values())
                # a head's forward leaves its centers unused
                grads = [torch.zeros_like(t) if d is None else d for t, d in zip(
                    leaves, torch.autograd.grad(y, leaves, g.to(dev), allow_unused=True))]
            res.append((y.detach().cpu(), [t.cpu() for t in grads],
                        {k: v.cpu() for k, v in st.items()}))
        (y_card, g_card, s_card), (y_cpu, g_cpu, s_cpu) = res
        flipped += sum(flips)
        entries += sum(int(m.numel()) for m in record)
        serr = max([((s_card[k] - v).abs().max() / v.abs().max()).item()
                    for k, v in s_cpu.items()] + [0.0])
        factor, cancel = 1.0, bn_cancellation(torch, layer, net.state_tree[name], ins[0])
        if cancel is not None:
            # BN is per channel: compare the channels that keep their digits
            keep = cancel <= BN_CANCELLATION_MAX
            left_out += int((~keep).sum())
            factor = cancel[keep].max().item() if keep.any() else 1.0
            y_card, y_cpu = y_card[..., keep], y_cpu[..., keep]
            g_card, g_cpu = ([t[..., keep] for t in gs] for gs in (g_card, g_cpu))
        err = (y_card - y_cpu).abs().max().item() / max(y_cpu.abs().max().item(), 1e-30)
        gerr = max(((gc - gw).norm() / gw.norm().clamp_min(1e-30)).item()
                   for gc, gw in zip(g_card, g_cpu))
        if not (err <= NODE_REL * factor and gerr <= GRAD_REL * factor
                and serr <= STATE_RTOL):
            raise RuntimeError(f"node {name} ({type(layer).__name__}): card vs CPU "
                               f"output {err}, gradients {gerr} (limits x {factor}), "
                               f"state {serr}")
        worst = {"out": max(worst["out"], err), "grad": max(worst["grad"], gerr),
                 "state": max(worst["state"], serr),
                 "bn_cancellation": max(worst["bn_cancellation"], factor),
                 "share_of_limit": max(worst["share_of_limit"], err / (NODE_REL * factor),
                                       gerr / (GRAD_REL * factor), serr / STATE_RTOL)}
    if not flipped <= MAX_PINNED_SHARE * entries:
        raise RuntimeError(f"{flipped} of {entries} kink decisions flipped node by node")
    return {"nodes": len(net.conf.topo_order), **worst, "kink_flips_pinned": flipped,
            "kink_entries": entries, "bn_channels_left_out": left_out}


def phase_face_model(torch, card, name, hwc, classes):
    """Zoo InceptionResNetV1 (160x160x3, 1001 labels) or FaceNetNN4Small2
    (96x96x3, 5749 labels) at full width, random weights from its seed:
    conv_bn blocks, an avgpool, a 128-d bottleneck, L2NormalizeVertex and
    the CenterLossOutputLayer, a ComputationGraph on no hand-written kernel,
    float32 (TF32 off). Served first, with phase 4's load at the model's
    size, through ParallelInference(check_finite=True): on its initial
    running statistics, or, where a probe batch overflows (the normal(0,
    0.5) init of InceptionResNetV1 does), on statistics set from one
    train-mode forward of a calibration batch of FACE_CALIBRATION
    (`calibrate_bn`), the phase says which. Then trained by `fit`
    FACE_STEPS steps at batch FACE_BATCH, every count reset just before
    and read just after (0); the BN state moves on every step and the
    first step's is held to a float64 recompute of the batch statistics
    (`check_first_step_state`); the median step after the first, images/s,
    one profiled step. Card vs CPU on a batch of 2: the train-mode score
    (FACE_SCORE_RTOL) and every node one by one (`check_nodes_one_by_one`)."""
    from deeplearning4j_torch.models import zoo
    t0 = time.perf_counter()
    net = getattr(zoo, name)(num_labels=classes, input_shape=hwc).init()
    shape = _face_shape(net)
    log(f"{name}: {hwc}/{classes}, {json.dumps(shape)} on {net.device}, init "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(2070 + len(name))
    xcal = rng.standard_normal((FACE_CALIBRATION,) + hwc).astype(np.float32)
    initial_state_finite = bool(np.isfinite(net.output(xcal[:8])).all())
    if not initial_state_finite:
        calibrate_bn(torch, net, xcal)
    del xcal
    serving, _ = serve_checked(torch, net, serving_requests(rng, shape=hwc),
                               f"{name} serving", check_finite=True)
    n = FACE_STEPS * FACE_BATCH
    x = rng.standard_normal((n,) + hwc, dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    steps, active, records = Steps(), [True], []
    moved = StateSteps(torch, net, active)
    net.listeners[:] = [steps, moved]
    with recorded_bn_stats(torch, records, active):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zero_launches()   # the main path's run starts here
        net.fit(x, y, epochs=1, batch_size=FACE_BATCH)
        launches = all_launches()   # ... and ends here
    net.listeners.clear()
    check_launches(f"{name} training", launches, dict.fromkeys(launches, 0))
    if net.iteration != FACE_STEPS or not all(np.isfinite(steps.scores)) \
            or not all(moved.moved):
        raise RuntimeError(f"{name} training: {net.iteration} steps, scores "
                           f"{steps.scores}, state moved {moved.moved}")
    first_step = check_first_step_state(torch, net, records, moved.first)
    del records, moved
    step_ms = np.diff([t0] + steps.ends) * 1e3
    warm_ms = float(np.median(step_ms[1:]))
    xb, yb = x[:FACE_BATCH], y[:FACE_BATCH]

    def one_step():
        net.fit(xb, yb, batch_size=FACE_BATCH)
        torch.cuda.synchronize()

    profile = profile_call(torch, f"train step {name}", one_step, {"batch": FACE_BATCH})
    cpu_net = _to_cpu_graph(net)
    with torch.no_grad():
        scores = [float(m._loss(m.params_tree, m.state_tree, *m._pack(m._coerce(
            x[:2], y[:2])), True, None)[0]) for m in (net, cpu_net)]
    if not abs(scores[0] - scores[1]) <= FACE_SCORE_RTOL * abs(scores[1]):
        raise RuntimeError(f"{name}: train-mode score card vs CPU {scores}")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        nodes = check_nodes_one_by_one(torch, net, cpu_net, x[:2])
    finally:
        torch.backends.cudnn.deterministic = det
    del cpu_net
    result = {"shape": shape, "input": list(hwc), "classes": classes,
              "initial_state_finite": initial_state_finite,
              "calibrated": not initial_state_finite, "serving": serving,
              "steps": FACE_STEPS, "batch": FACE_BATCH, "launches": launches,
              "scores": steps.scores, "step_ms": step_ms.tolist(),
              "median_step_ms_after_the_first": warm_ms,
              "images_per_s": FACE_BATCH / warm_ms * 1e3,
              "first_step_state": first_step, "profile": profile,
              "train_score_card_vs_cpu_b2": scores, "nodes_card_vs_cpu_b2": nodes,
              "card": card}
    log(f"{name}: served p50 {serving['p50_ms']:.3f} ms, "
        f"{serving['images_per_s']:.1f} images/s "
        f"({'calibrated' if result['calibrated'] else 'initial state'}); step ms "
        f"{step_ms.tolist()}, median {warm_ms:.3f} ms, "
        f"{result['images_per_s']:.1f} images/s; one step busy "
        f"{profile.get('device_busy_ms')} ms, idle {profile.get('device_idle_share')}"
        f"  [{card}]")
    log(f"{name}: {json.dumps(result)}")
    del net, x, y, xb, yb
    return result


# ---------------------------------------------------------------------------
# Decode serving (K7): the kernel, the engine, the stream arm, packed admission
# ---------------------------------------------------------------------------
DECODE_REL = 1e-5   # float32 K7 against its plain version, of max|plain|
# (label, b, t_kv, h, d, dtype, layers of the view it is sliced from (0: a
# contiguous [b, t, h, d] tensor), timed): the engine's geometry (bench.py
# bench_serving_decode: max_decode_batch 8, KV view up to 256, 4 heads of 32,
# read in place from a layer of the step's [b, t, 4, h, d] view) and its
# 64-key bucket, a long cache in both types, lengths on the split edges
# (DECODE_EDGE_CASES), and edge shapes (one element a lane: d 19 in float32,
# 36 in bfloat16, 100 over 4 pieces; b 1; a cache_len past the bucket)
DECODE_CASES = [
    ("engine_f32", 8, 256, 4, 32, "float32", 4, True),
    ("long_f32", 16, 8192, 4, 128, "float32", 0, True),
    ("long_bf16", 16, 8192, 4, 128, "bfloat16", 0, True),
    ("d19_f32", 3, 300, 2, 19, "float32", 0, False),
    ("d36_bf16", 3, 300, 2, 36, "bfloat16", 2, False),
    ("d100_f32", 2, 100, 3, 100, "float32", 0, False),
    ("b1_d8", 1, 16, 1, 8, "float32", 0, False),
    # after the cases above, so that theirs draw the same inputs from the seeds
    ("engine_t64_f32", 8, 64, 4, 32, "float32", 4, True),
    ("edges_f32", 12, 512, 4, 32, "float32", 4, False),
    ("edges_bf16", 12, 4096, 2, 128, "bfloat16", 0, False),
]


def decode_lens(rng, b, t):
    """Ragged valid prefixes from a seed: 1 and t among them (b >= 2), the
    rest anywhere in [1, t]."""
    lens = rng.integers(1, t + 1, b).astype(np.int32)
    lens[0] = 1
    if b > 1:
        lens[-1] = t
    return lens


# The cases whose cache_len straddle K7's split edges (`decode_edge_lens`)
DECODE_EDGE_CASES = ("edges_f32", "edges_bf16")
DECODE_SPLITS_SWEPT = (1, 2, 4, 8)   # K7's blocks a (row, head), timed at each
HOST_CALLS = 1000   # wrapper calls timed on the host clock, no sync


def decode_block_keys(d, elem_bytes, bucket_keys):
    """Keys one K7 block takes an iteration on its 16-byte route, as
    decode_attention.cu computes them: lane groups of G lanes (the power of
    two, at most 32, that covers d in 16-byte pieces) in 4 warps, or in 8
    where the block takes at least 512 keys of the bucket (`bucket_keys`:
    t_kv over the split count, rounded up), 4 keys a group."""
    pieces = max(1, d * elem_bytes // 16)
    g = 1
    while g < pieces and g < 32:
        g *= 2
    warps = 8 if bucket_keys >= 512 else 4
    return warps * 32 // g * 4


def decode_edge_lens(b, t, splits, unit):
    """b cache lengths on the edges of K7's per-row split (S blocks of
    ceil(n / S) keys rounded up to `unit`): 1, S - 1, S, S + 1, unit S - 1,
    unit S, unit S + 1, 2 unit S - 1, 2 unit S + 1, t - 1, t, and more of t;
    each within [1, t]."""
    s, c = splits, unit
    edges = [1, s - 1, s, s + 1, c * s - 1, c * s, c * s + 1, 2 * c * s - 1,
             2 * c * s + 1, t - 1, t]
    lens = [min(max(1, n), t) for n in edges][:b]
    return np.asarray(lens + [t] * (b - len(lens)), np.int32)


def decode_inputs(torch, gen, rng, b, t, h, d, dtype, layers, device, lens=None):
    dt = getattr(torch, dtype)
    mk = lambda *s_: torch.randn(*s_, device=device, generator=gen).to(dt)
    q = mk(b, 1, h, d)
    if layers:   # a layer's slice of the step's [b, t, layers, h, d] view
        k, v = mk(b, t, layers, h, d)[:, :, 1], mk(b, t, layers, h, d)[:, :, 1]
    else:
        k, v = mk(b, t, h, d), mk(b, t, h, d)
    lens = decode_lens(rng, b, t) if lens is None else lens
    return q, k, v, torch.from_numpy(lens).to(device)


def host_us(torch, fn, calls=HOST_CALLS):
    """Host microseconds a call of `fn`: the host clock over `calls` calls
    with no sync between them (what the wrapper costs the launching thread),
    then one sync outside the clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def decode_bound_ms(q, k, lens):
    """Least time for K7: the valid prefixes of K and V read once, q read and
    o written once (and cache_len), over 3.35 TB/s."""
    b, _, h, d = q.shape
    valid = int(lens.clamp(max=k.shape[1]).clamp(min=0).sum())
    nbytes = (2 * valid * h * d + 2 * b * h * d) * q.element_size() + 4 * b
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def check_decode(torch, fa, label, got, q, k, v, lens):
    """K7's answer against `decode_attention_reference`: float32 within
    DECODE_REL of max|plain|; bfloat16 within one bfloat16 ulp of the float32
    plain version on the upcast inputs, rounded once (`bf16_ulp_check`, the
    float32 check's slack as its atol). Returns the largest error."""
    if q.dtype == torch.float32:
        want = fa.decode_attention_reference(q, k, v, lens)
        rel = _rel_err(got, want)
        if not rel <= DECODE_REL or not torch.isfinite(got).all():
            raise RuntimeError(f"decode {label}: error {rel} of max|plain| "
                               f"(limit {DECODE_REL})")
        return (got - want).abs().max().item()
    want32 = fa.decode_attention_reference(q.float(), k.float(), v.float(), lens)
    err, _ = bf16_ulp_check(torch, f"decode {label}", got, want32,
                            DECODE_REL * want32.abs().max().item())
    return err


def phase_decode_kernel(torch, card, device=None):
    """K7 (`_launch_decode`) against `decode_attention_reference` at
    DECODE_CASES, ragged cache_len from a seed (1 and t_kv among them; on
    the split edges for DECODE_EDGE_CASES), and rows with cache_len 0
    (output 0) and past the bucket (all keys). For the timed cases: device
    times of K7, its plain version, SDPA with a boolean mask from cache_len
    (the library call computing the same function, timed as the yardstick
    only) and K3 with one query row under the same key mask (`_launch_fwd`,
    the route the TPU kernel takes, held to the plain version too), beside
    the bytes bound; K7 with every row empty (`empty_ms`: its launch, merge
    and store, no key read); K7's host microseconds a call (`host_us`); and,
    on the card, K7 at each split count of DECODE_SPLITS_SWEPT, each held to
    the plain version. Returns the kernels-line entry (the engine's
    geometry) and the rows."""
    import torch.nn.functional as F
    from deeplearning4j_torch.ops import flash_attention as fa
    dev = device or "cuda"
    gen = torch.Generator(device=dev).manual_seed(14)
    rng = np.random.default_rng(14)
    rows, worst = {}, 0.0
    launches0 = fa.decode_launches
    on_card = torch.device(dev).type == "cuda"
    for label, b, t, h, d, dtype, layers, timed in DECODE_CASES:
        splits = fa.decode_splits(torch.device(dev), b * h, t) if on_card else None
        edges = None
        if label in DECODE_EDGE_CASES:
            elem = 4 if dtype == "float32" else 2
            s_ = splits or fa.DECODE_MAX_SPLITS
            edges = decode_edge_lens(b, t, s_, decode_block_keys(d, elem, -(-t // s_)))
        q, k, v, lens = decode_inputs(torch, gen, rng, b, t, h, d, dtype, layers, dev,
                                      edges)
        got = fa._launch_decode(q, k, v, lens)
        torch.cuda.synchronize()
        err = check_decode(torch, fa, label, got, q, k, v, lens)
        worst = max(worst, err)
        row = {"case": label, "shape": [b, t, h, d], "dtype": dtype,
               "strided_view": bool(layers),
               "lens": [int(x) for x in lens[:4 if edges is None else b]],
               "max_abs_err": err, "splits": splits}
        if b > 1:   # a row no key may see, and one past the bucket
            odd = lens.clone()
            odd[0], odd[1] = 0, t + 5
            got = fa._launch_decode(q, k, v, odd)
            torch.cuda.synchronize()
            if (got[0] != 0).any():
                raise RuntimeError(f"decode {label}: a row with cache_len 0 is not 0")
            worst = max(worst, check_decode(torch, fa, label + " odd lens", got, q, k,
                                            v, odd))
        if timed:
            km = (torch.arange(t, device=dev)[None, :] < lens[:, None].long()).float()
            qp = torch.zeros(1, dtype=torch.int32, device=dev)
            kp = torch.arange(t, dtype=torch.int32, device=dev)
            kc, vc = k.contiguous(), v.contiguous()
            k3 = lambda: fa._launch_fwd(q, kc, vc, km, None, None, qp, kp, d ** -0.5, False)
            o3, _ = k3()
            torch.cuda.synchronize()
            row["k3_q1_rel_err"] = _rel_err(o3, fa.decode_attention_reference(
                q, k, v, lens))
            if not row["k3_q1_rel_err"] <= FLASH_REL[dtype]:
                raise RuntimeError(f"decode {label}: K3 at q=1 differs by "
                                   f"{row['k3_q1_rel_err']} of max|plain|")
            qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            mask = (km > 0)[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
            row["library_rel_err"] = _rel_err(sdpa().transpose(1, 2),
                                              fa.decode_attention_reference(q, k, v, lens))
            row["ms"] = device_ms(torch, lambda: fa._launch_decode(q, k, v, lens))
            empty = torch.zeros_like(lens)   # no key read: the launch, merge and store
            row["empty_ms"] = device_ms(torch, lambda: fa._launch_decode(q, k, v, empty))
            row["host_us"] = host_us(torch, lambda: fa._launch_decode(q, k, v, lens))
            row["plain_ms"] = device_ms(torch, lambda: fa.decode_attention_reference(
                q, k, v, lens))
            row["library_ms"] = device_ms(torch, sdpa)
            row["k3_q1_ms"] = device_ms(torch, k3)
            row["bound_ms"], row["bound_by"] = decode_bound_ms(q, k, lens)
            if on_card:   # the split rule's alternatives, each checked
                row["ms_by_splits"] = {}
                for s_ in DECODE_SPLITS_SWEPT:
                    run = lambda: fa._launch_decode(q, k, v, lens, splits=s_)
                    check_decode(torch, fa, f"{label} at {s_} splits", run(), q, k, v,
                                 lens)
                    row["ms_by_splits"][s_] = device_ms(torch, run)
            del km, kc, vc, qh, kh, vh, mask, o3
        rows[label] = row
        log(f"decode {label}: {json.dumps(row)}  [{card}]")
        del q, k, v, lens, got
        if dev == "cuda":
            torch.cuda.empty_cache()
    log(f"decode kernel: {fa.decode_launches - launches0} K7 launches in this "
        f"phase (checks and timing)")
    main = rows["engine_f32"]
    entry = {"name": "decode_attention", "route": "cuda",
             "source": "deeplearning4j_torch/ops/csrc/decode_attention.cu",
             "replaces": "deeplearning4j_tpu/ops/flash_attention.py:573",
             "launches": None, "max_abs_err": worst,
             **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "k3_q1_ms")},
             "host_us": main["host_us"],
             "long": {lab: {key: rows[lab][key] for key in
                            ("ms", "plain_ms", "bound_ms", "library_ms", "k3_q1_ms")}
                      for lab in ("long_f32", "long_bf16") if lab in rows},
             "short": {lab: {key: rows[lab][key] for key in
                             ("ms", "plain_ms", "bound_ms", "library_ms", "k3_q1_ms")}
                       for lab in ("engine_t64_f32",) if lab in rows}}
    return entry, rows


# bench.py bench_serving_decode's defaults: the decoder (seed 7), the engine
# around it and the traffic (6 clients x 4 prompts of 4-32 tokens x 48 new)
DECODE_GEOMETRY = dict(vocab=256, layers=4, heads=4, head_dim=32, ff=512,
                       max_context=256, max_decode_batch=8, block_tokens=16,
                       kv_max_blocks=256, pack_bucket=128, clients=6,
                       prompts_per_client=4, max_new_tokens=48, prompt_lo=4,
                       prompt_hi=33)
DECODE_JOIN_S = 600   # a client thread that has not ended by then fails the phase


def decode_engine(g, name, device=None):
    """bench_serving_decode's engine: TransformerDecoder(seed=7), a paged
    cache of kv_max_blocks blocks of block_tokens, packed prefill rows of
    pack_bucket, warmed."""
    from deeplearning4j_torch.serving import decode as sd
    model = sd.TransformerDecoder(vocab=g["vocab"], layers=g["layers"],
                                  heads=g["heads"], head_dim=g["head_dim"], ff=g["ff"],
                                  max_context=g["max_context"], seed=7, device=device)
    cache = sd.PagedKVCache(layers=g["layers"], heads=g["heads"],
                            head_dim=g["head_dim"], block_tokens=g["block_tokens"],
                            max_blocks=g["kv_max_blocks"], device=device)
    eng = sd.DecodeEngine(sd.TransformerAdapter(model, cache,
                                                pack_bucket=g["pack_bucket"]),
                          name=name, max_decode_batch=g["max_decode_batch"],
                          device=device)
    eng.warmup()
    return eng, model, cache


def run_generate_clients(eng, prompts, per_client, max_new):
    """One thread per client, each generating its `per_client` prompts in
    turn: ({prompt index: result or the exception}, wall s). Raises if a
    thread does not end within DECODE_JOIN_S."""
    results = {}

    def client(c):
        for j in range(per_client):
            i = c * per_client + j
            try:
                results[i] = eng.generate(prompts[i], max_new_tokens=max_new)
            except Exception as e:  # noqa: BLE001 (the caller checks each)
                results[i] = e

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(len(prompts) // per_client)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=DECODE_JOIN_S)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a decode client did not finish")
    return results, wall


DECODE_LOGITS_REL = 1e-4   # a decode step's logits against a full recompute, of max|logit|


def check_step_logits(eng, model, cache, prompt, steps, pack_bucket):
    """`prompt` prefilled into the engine's cache alone, then `steps` greedy
    decode steps through the model's step (K7 on the card), each step's
    logits held to the prefill logits of the whole sequence so far (a full
    recompute through dense attention) within DECODE_LOGITS_REL of their
    largest value. Tokens alone would pass a step whose logits are somewhat
    off; this does not. Returns the largest error."""
    from deeplearning4j_torch.data.padding import next_pow2_bucket
    ad, rid, worst = eng.adapter, -1, 0.0
    with eng.paused():
        first, fails = ad.prefill_group([(rid, np.asarray(prompt, np.int32))])
        if fails:
            raise RuntimeError(f"decode logits check: prefill failed {fails!r}")
        toks = list(prompt) + [first[rid]]
        try:
            for _ in range(steps):
                n = cache.length(rid)
                kvb = max(cache.block_tokens, next_pow2_bucket(n + 1))
                k_view, v_view, lens = cache.batch_view([rid], kvb)
                logits, k_t, v_t = model.step([toks[-1]], lens, k_view, v_view, lens)
                cache.append(rid, k_t[0], v_t[0])
                t = len(toks)
                row, seg, pos = (np.zeros((1, pack_bucket), np.int32) for _ in range(3))
                row[0, :t], seg[0, :t], pos[0, :t] = toks, 1, np.arange(t)
                want = model.prefill(row, seg, pos)[0][0, t - 1]
                err = ((logits[0] - want).abs().max() / want.abs().max()).item()
                if not err <= DECODE_LOGITS_REL:
                    raise RuntimeError(f"decode logits check: a step's logits differ "
                                       f"from a full recompute by {err} of max|logit| "
                                       f"(> {DECODE_LOGITS_REL}) at length {t}")
                worst = max(worst, err)
                toks.append(int(logits[0].argmax()))
        finally:
            cache.free(rid)
    return worst


K7_KERNEL = "decode_attention_kernel"   # K7's device kernel, by name
K7W_KERNEL = "decode_wide_ring_kernel"  # K7w's (head_dim > 128)


def profile_decode_step(torch, eng, cache, prompts, rows, layers, kernel=K7_KERNEL):
    """One engine step of `rows` requests (prefilled from `prompts`, the
    engine paused) under torch.profiler (`profile_call`): its device busy
    time against its wall, where a step's time goes. Fails unless the step
    ran the decode kernel (`kernel`, by name: K7's, or K7w's) once a layer
    (`layers` calls): one kernel a decode_attention call. Adds the
    kernel's share of the busy time (`kernel_share_of_busy`, where the
    profile has device times)."""
    ad = eng.adapter
    rids = [-2 - i for i in range(rows)]
    items = [(rid, np.asarray(p, np.int32)) for rid, p in zip(rids, prompts)]
    last = {}
    with eng.paused():
        try:
            for group in ad.pack_groups(items):
                first, fails = ad.prefill_group(group)
                if fails:
                    raise RuntimeError(f"decode step profile: prefill failed {fails!r}")
                last.update(first)

            def one_step():
                out, fails = ad.step(rids, [last[r] for r in rids])
                if fails:
                    raise RuntimeError(f"decode step profile: step failed {fails!r}")
                last.update(out)
                torch.cuda.synchronize()

            prof = profile_call(torch, f"decode step of {rows} rows", one_step,
                                {"rows": rows}, count=kernel)
            if prof["counted_calls"] != layers:
                raise RuntimeError(f"decode step profile: {prof['counted_calls']} "
                                   f"{kernel} kernels in a step of {layers} layers")
            if prof.get("device_busy_ms"):
                prof["kernel_share_of_busy"] = prof["counted_ms"] / prof["device_busy_ms"]
            return prof
        finally:
            for rid in rids:
                cache.free(rid)


@contextmanager
def recorded_margins(model, margins):
    """Append, for every `prefill` of one sequence (naive_generate's), the
    gap between the top two logits of its last real position."""
    prefill = model.prefill

    def recording(tokens, seg, pos):
        out = prefill(tokens, seg, pos)
        t = int(np.asarray(seg).sum())
        top = out[0][0, t - 1].float().topk(2).values
        margins.append(float(top[0] - top[1]))
        return out

    with patched(model, "prefill", recording):
        yield


def decode_chaos(eng, model, cache, prompts, max_new, pack_bucket):
    """A `serve.decode_step` fault on the 3rd and 4th step attempts while two
    requests ride together (both are queued before the loop's first step,
    under `paused()`): the batch step and the first solo retry fail, so
    exactly one rider dies with DecodeStepError, its batchmate gets every
    token, the KV cache drains, and the engine serves afterwards."""
    from deeplearning4j_torch.parallel.inference import DecodeStepError
    from deeplearning4j_torch.serving import decode as sd
    from deeplearning4j_torch.utils import faults
    out = [None, None]

    def run(i):
        try:
            out[i] = eng.generate(prompts[i], max_new_tokens=max_new)
        except Exception as e:  # noqa: BLE001 (checked below)
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in (0, 1)]
    with faults.injected("serve.decode_step", "fail:3,4"):
        with eng.paused():
            rid0 = eng._rid
            for t in threads:
                t.start()
            deadline = time.monotonic() + 60
            while eng._rid < rid0 + 2 and time.monotonic() < deadline:
                time.sleep(0.001)
        for t in threads:
            t.join(timeout=DECODE_JOIN_S)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("decode chaos: a client did not finish")
    died = [o for o in out if isinstance(o, DecodeStepError)]
    lived = [o for o in out if isinstance(o, list)]
    if len(died) != 1 or len(lived) != 1 or len(lived[0]) != max_new:
        raise RuntimeError(f"decode chaos: outcomes {out!r}, expected one "
                           f"DecodeStepError and one full generation")
    if cache.blocks_in_use() != 0:
        raise RuntimeError(f"decode chaos: {cache.blocks_in_use()} KV blocks left")
    after = eng.generate(prompts[0], max_new_tokens=4)
    if after != sd.naive_generate(model, prompts[0], 4, pad_to=pack_bucket):
        raise RuntimeError("decode chaos: the engine's answer after the fault differs")
    survivor = out.index(lived[0])
    return {"died": 1, "survivor_tokens": len(lived[0]),
            "survivor_equals_naive": lived[0] == sd.naive_generate(
                model, prompts[survivor], max_new, pad_to=pack_bucket),
            "kv_blocks_after": 0, "served_after": True}


def phase_decode_serving(torch, card, device=None):
    """The decode engine at bench.py bench_serving_decode's defaults
    (DECODE_GEOMETRY): TransformerDecoder(seed=7) 4 layers x 4 heads of 32,
    ff 512, vocab 256, max_context 256, behind DecodeEngine(max_decode_batch
    8) over a PagedKVCache of 256 blocks of 16 tokens, packed prefill rows
    of 128; 6 clients x 4 prompts of 4-32 tokens (numpy seed 0) x 48 new
    tokens, after one unmeasured seeding request. Every count is reset just
    before the clients start and read just after: K7 must have launched
    layers x the decode steps taken, and nothing else. Every client's tokens
    must equal `naive_generate`'s on the card (full recompute through the
    prefill, no cache: the honesty rule of the JAX bench, here for all 24
    prompts), the KV cache must drain to 0 blocks, two prompts' step logits
    must agree with a full recompute (`check_step_logits`), and
    `decode_chaos` must hold. Reports tokens/s, the naive arm's tokens/s,
    inter-token p50/p99 (the engine's histogram), the peak KV utilization,
    the smallest top-2 logit margin the naive arm met, and one profiled
    step of 8 rows."""
    from deeplearning4j_torch.optimize.metrics import registry
    from deeplearning4j_torch.serving import decode as sd
    g = DECODE_GEOMETRY
    name = "chip_smoke_decode"
    eng, model, cache = decode_engine(g, name, device)
    try:
        n = g["clients"] * g["prompts_per_client"]
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, g["vocab"], size=ln).tolist()
                   for ln in rng.integers(g["prompt_lo"], g["prompt_hi"], size=n)]
        eng.generate(prompts[0], max_new_tokens=2)   # unmeasured seeding pass
        reg = registry()
        steps_c = reg.counter("serving_decode_steps_total").labels(model=name)
        itl_h = reg.histogram("serving_inter_token_ms",
                              buckets=sd.INTER_TOKEN_BUCKETS_MS).labels(model=name)
        steps0, itl0 = steps_c.value(), len(itl_h.window_values())
        kv_peak, stop = [0.0], threading.Event()

        def sample_kv():
            while not stop.is_set():
                kv_peak[0] = max(kv_peak[0], cache.utilization())
                time.sleep(0.005)

        sampler = threading.Thread(target=sample_kv, daemon=True)
        sampler.start()
        torch.cuda.synchronize()
        zero_launches()   # the main path's run starts here
        results, wall = run_generate_clients(eng, prompts, g["prompts_per_client"],
                                             g["max_new_tokens"])
        launches = all_launches()   # ... and ends here
        stop.set()
        sampler.join(timeout=5)
        steps = int(steps_c.value() - steps0)
        want = dict.fromkeys(launches, 0)
        want["decode_attention"] = g["layers"] * steps
        check_launches("decode serving", launches, want)
        bad = {i: r for i, r in results.items() if not isinstance(r, list)}
        if bad or len(results) != n:
            raise RuntimeError(f"decode serving: failed requests {bad!r}")
        if cache.blocks_in_use() != 0:
            raise RuntimeError(f"decode serving: {cache.blocks_in_use()} KV blocks "
                               f"left after the last retire")
        itl = np.asarray(itl_h.window_values()[itl0:], np.float64)
        margins = []
        with recorded_margins(model, margins):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            naive = [sd.naive_generate(model, p, g["max_new_tokens"],
                                       pad_to=g["pack_bucket"]) for p in prompts]
            naive_wall = time.perf_counter() - t0
        diverged = [i for i in range(n) if results[i] != naive[i]]
        if diverged:
            raise RuntimeError(f"decode serving: the engine's tokens differ from "
                               f"naive_generate's for prompts {diverged}")
        logits_err = max(check_step_logits(eng, model, cache, p, 8, g["pack_bucket"])
                         for p in prompts[:2])
        profile = profile_decode_step(torch, eng, cache, prompts,
                                      g["max_decode_batch"], g["layers"])
        chaos = decode_chaos(eng, model, cache, prompts[:2], g["max_new_tokens"],
                             g["pack_bucket"])
    finally:
        eng.shutdown()
    tokens = n * g["max_new_tokens"]
    result = {"requests": n, "tokens": tokens, "steps": steps, "launches": launches,
              "wall_s": wall, "tokens_per_s": tokens / wall,
              "naive_tokens_per_s": tokens / naive_wall,
              "inter_token_p50_ms": float(np.percentile(itl, 50)),
              "inter_token_p99_ms": float(np.percentile(itl, 99)),
              "inter_token_samples": int(itl.size),
              "kv_utilization_peak": kv_peak[0],
              "min_top2_margin": float(min(margins)), "all_equal_naive": True,
              "step_logits_rel_vs_recompute": logits_err, "step_profile": profile,
              "kv_blocks_after": 0, "chaos": chaos, "card": card}
    log(f"decode serving: {json.dumps(result)}  [{card}]")
    return result


STREAM_PROMPTS, STREAM_NEW, STREAM_CLIENTS = 8, 16, 4


def phase_decode_stream(torch, card, device=None):
    """Zoo TextGenerationLSTM at the width the port serves (two
    GravesLSTM(256), 77 characters; its softmax output fed back as its next
    input, n_out == n_in) through RecurrentAdapter behind a DecodeEngine
    (max_decode_batch 8): STREAM_CLIENTS clients generate STREAM_NEW rows
    after prompts of 8-32 one-hot characters from a seed, every count reset
    just before and read just after (none: the LSTM is plain torch, as plain
    XLA in the JAX package). Every generated row must match a direct
    `rnn_time_step` stream of the same prompt at batch 1 on the same device
    (STREAM_RTOL, STREAM_ATOL). Reports rows/s."""
    from deeplearning4j_torch.models.zoo import TextGenerationLSTM
    from deeplearning4j_torch.serving import decode as sd
    net = TextGenerationLSTM(num_labels=TEXT_LABELS,
                             input_shape=(TEXT_T, TEXT_LABELS)).init(device=device)
    rng = np.random.default_rng(2090)
    eye = np.eye(TEXT_LABELS, dtype=np.float32)
    prompts = [eye[rng.integers(0, TEXT_LABELS, int(t))]
               for t in rng.integers(8, 33, size=STREAM_PROMPTS)]
    eng = sd.DecodeEngine(sd.RecurrentAdapter(net, feature_dim=TEXT_LABELS),
                          name="chip_smoke_stream", max_decode_batch=8,
                          max_context=32 + STREAM_NEW, device=device)
    try:
        eng.warmup()
        torch.cuda.synchronize()
        zero_launches()   # the main path's run starts here
        results, wall = run_generate_clients(eng, prompts,
                                             STREAM_PROMPTS // STREAM_CLIENTS,
                                             STREAM_NEW)
        launches = all_launches()   # ... and ends here
    finally:
        eng.shutdown()
    check_launches("decode stream", launches, dict.fromkeys(launches, 0))
    worst = 0.0
    for i, p in enumerate(prompts):
        got = results[i]
        if isinstance(got, BaseException) or got.shape != (STREAM_NEW, TEXT_LABELS):
            raise RuntimeError(f"decode stream: prompt {i} gave {got!r}")
        net.rnn_clear_previous_state()
        for t in range(p.shape[0]):
            last = net.rnn_time_step(p[t:t + 1])
        direct = []
        for _ in range(STREAM_NEW):
            direct.append(last[0])
            last = net.rnn_time_step(last)
        net.rnn_clear_previous_state()
        np.testing.assert_allclose(got, np.stack(direct), rtol=STREAM_RTOL,
                                   atol=STREAM_ATOL)
        worst = max(worst, float(np.abs(got - np.stack(direct)).max()))
    result = {"prompts": STREAM_PROMPTS, "rows": STREAM_PROMPTS * STREAM_NEW,
              "launches": launches, "wall_s": wall,
              "rows_per_s": STREAM_PROMPTS * STREAM_NEW / wall,
              "max_abs_vs_direct_stream": worst, "card": card}
    log(f"decode stream: {json.dumps(result)}  [{card}]")
    return result


# Packed admission: the char model (bf16, 512 wide) behind ParallelInference
# packing single-sequence requests into rows of PACKED_BUCKET tokens
PACKED_BUCKET = 8192
PACKED_CLIENTS, PACKED_PER_CLIENT = 4, 4
PACKED_T_LO, PACKED_T_HI = 256, 2049
# A packed answer against the same request served alone: a bfloat16 network
# whose products run at another size can tip a bfloat16 rounding (ROADMAP,
# "Batch sum order": served bfloat16 answers are held at 2e-3)
PACKED_SERVE_REL = 2e-3


def packed_requests(rng, clients, per_client):
    """Per client, `per_client` single one-hot sequences [1, t, CHAR_VOCAB]
    of PACKED_T_LO..PACKED_T_HI - 1 tokens."""
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    return [[eye[rng.integers(0, CHAR_VOCAB, (1, int(rng.integers(PACKED_T_LO,
                                                                  PACKED_T_HI))))]
             for _ in range(per_client)] for _ in range(clients)]


def check_packed_answer(label, got, solo):
    if got.shape != solo.shape or not np.isfinite(got).all():
        raise RuntimeError(f"{label}: answer {got.shape}, alone {solo.shape}")
    rel = float(np.abs(got - solo).max() / max(np.abs(solo).max(), 1e-30))
    if not rel <= PACKED_SERVE_REL:
        raise RuntimeError(f"{label}: the packed answer differs from the request "
                           f"served alone by {rel} of its largest value "
                           f"(> {PACKED_SERVE_REL})")
    return rel


def phase_packed_admission(torch, card, device=None):
    """The char model of phase_char_model in bfloat16 with `packed_segments`
    behind ParallelInference(packed_admission=True, pack_bucket 8192): 4
    clients x 4 single sequences of 256-2048 tokens from a seed, every count
    reset just before the clients start and read just after: K3 2 x packed
    forwards (one launch an attention layer, segment ids in the key mask),
    nothing else, and no fallback to the row path. Each answer is held to
    the same request served alone (`net.output`, PACKED_SERVE_REL). Then a
    `serve.pack` fault on the 1st and 2nd calls while three requests ride
    one row: the row's assembly and the first solo retry fail, so exactly
    one request fails with BatchExecutionError and the other two are
    answered. Requests/s and p50 from a second, unchecked run."""
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.parallel.inference import (BatchExecutionError,
                                                          ParallelInference)
    from deeplearning4j_torch.utils import faults
    net = MultiLayerNetwork(char_conf(packed=True)).init(dtype=torch.bfloat16,
                                                         device=device)
    rng = np.random.default_rng(2080)
    reqs = packed_requests(rng, PACKED_CLIENTS, PACKED_PER_CLIENT)
    n = PACKED_CLIENTS * PACKED_PER_CLIENT
    pi = ParallelInference(net, packed_admission=True, pack_bucket=PACKED_BUCKET,
                           batch_limit=SERVE_BATCH_LIMIT, batch_timeout_ms=5.0)
    try:
        pi.warmup(max_bucket=1, time_steps=PACKED_BUCKET)
        f0, p0, fb0 = pi.total_forwards, pi.total_packed_requests, pi.total_pack_fallbacks
        torch.cuda.synchronize()
        zero_launches()   # the main path's run starts here
        answers, _, _ = run_clients(pi, reqs)
        launches = all_launches()   # ... and ends here
        forwards = pi.total_forwards - f0
        want = dict.fromkeys(launches, 0)
        want["flash_fwd"] = 2 * forwards
        check_launches("packed admission", launches, want)
        if pi.total_packed_requests - p0 != n or pi.total_pack_fallbacks != fb0:
            raise RuntimeError(f"packed admission: {pi.total_packed_requests - p0} of "
                               f"{n} requests packed, "
                               f"{pi.total_pack_fallbacks - fb0} fell back")
        worst = max(check_packed_answer(f"packed admission request {c}.{j}",
                                        answers[(c, j)], net.output(reqs[c][j]))
                    for c in range(PACKED_CLIENTS) for j in range(PACKED_PER_CLIENT))
        _, lat, wall = run_clients(pi, reqs)
        stats = latency_stats(lat, n, wall)
        # serve.pack chaos: three requests in one row (a long linger)
        trio = [x for xs in reqs for x in xs][:3]
        pi.batch_timeout_ms = 300.0
        out = [None] * 3

        def run(i):
            try:
                out[i] = pi.output(trio[i])
            except Exception as e:  # noqa: BLE001 (checked below)
                out[i] = e

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(3)]
        failures0 = pi.total_batch_failures
        with faults.injected("serve.pack", "fail:1,2"):
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=DECODE_JOIN_S)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("packed admission chaos: a client did not finish")
        failed = [i for i, o in enumerate(out) if isinstance(o, BatchExecutionError)]
        if len(failed) != 1 or any(isinstance(o, BaseException) for o in out
                                   if not isinstance(o, BatchExecutionError)):
            raise RuntimeError(f"packed admission chaos: outcomes {out!r}, expected "
                               f"exactly one BatchExecutionError")
        for i, o in enumerate(out):
            if i not in failed:
                check_packed_answer(f"packed admission chaos request {i}", o,
                                    net.output(trio[i]))
    finally:
        pi.shutdown()
    result = {"requests": n, "packed_forwards": forwards, "launches": launches,
              "max_rel_vs_alone": worst, "limit": PACKED_SERVE_REL,
              "requests_per_s": stats["requests"] / stats["wall_s"],
              "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
              "chaos": {"failed": len(failed),
                        "batch_failures": pi.total_batch_failures - failures0},
              "card": card}
    log(f"packed admission: {json.dumps(result)}  [{card}]")
    return result


# --------------------------------------- data and pretraining (the DataVec path)

# The image phase at full size: 16 label folders of 256x256x3 PPMs read into
# 224x224x3 batches of 128 for zoo AlexNet's 1000 classes; W = 1 and 8 ETL
# workers timed, 8 feeding fit.
IMAGE_FULL = dict(folders=16, images=640, src_px=256, out_px=224, batch=128,
                  classes=1000, workers=(1, 8))
# MNIST through the example's VAE (dl4j-examples VariationalAutoEncoderExample)
VAE_FULL = dict(n_train=60000, encoder=(256, 256), decoder=(256, 256), latent=2,
                batch=128, profiled_steps=10)
# the 784-1000-500-250-30 stack of Hinton & Salakhutdinov (2006)
DBN_FULL = dict(n_train=10000, widths=(1000, 500, 250, 30), batch=128)
VAE_STEP_REL = 1e-4   # a VAE step's loss and gradients, card vs CPU, relative norm
CD_STAT_REL = 1e-5    # CD-1 statistics, card vs CPU, relative norm
CD_NEAR = 1e-6        # a Bernoulli decision is pinned where |u - p| < CD_NEAR
SCALE_ULP = 1e-7      # native (x * (1/255)) against numpy (x / 255) scaling


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def write_image_directory(root, folders, per_folder, px, seed=2061):
    """`folders` label folders of `per_folder` PPMs of px x px x 3 under
    `root`, from a numpy seed: class k is a stripe texture of its own angle,
    frequency and tint, plus noise, so that the classes can be learned."""
    import shutil
    from deeplearning4j_torch.data.images import write_ppm
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:px, 0:px].astype(np.float32) / px
    for k in range(folders):
        angle = np.pi * k / folders
        freq = 4.0 + 3.0 * (k % 4)
        wave = np.sin(2 * np.pi * freq * (np.cos(angle) * xx + np.sin(angle) * yy))
        tint = np.array([0.5 + 0.5 * ((k + c) % 3 == 0) for c in range(3)], np.float32)
        base = (128.0 + 90.0 * wave)[:, :, None] * tint
        noise = rng.integers(-24, 25, (per_folder, px, px, 3), dtype=np.int16)
        imgs = np.clip(base[None] + noise, 0, 255).astype(np.uint8)
        d = os.path.join(root, f"class_{k:02d}")
        os.makedirs(d)
        for i, img in enumerate(imgs):
            write_ppm(os.path.join(d, f"{i:04d}.ppm"), img)


def etl_ms_per_batch(make_iterator):
    """Host ms a batch of one pass over a fresh image iterator (decode,
    resize, stack, scale, one-hot), and the batches' count."""
    it = make_iterator()
    t0 = time.perf_counter()
    n = sum(1 for _ in it)
    return (time.perf_counter() - t0) * 1e3 / n, n


def etl_breakdown(files, px, workers):
    """Host ms of each ETL stage over one batch's files: decode, the resize
    on the calling thread (its OpenMP team), the resize over a pool of
    `workers` threads each capped at one OpenMP thread (as the iterator
    runs it), the stack and the u8->f32 scale."""
    from concurrent.futures import ThreadPoolExecutor
    from deeplearning4j_torch import native_etl
    from deeplearning4j_torch.data.images import decode_image
    resize = lambda im: native_etl.resize_bilinear(im, px, px)
    out = {}
    t0 = time.perf_counter()
    decoded = [decode_image(p, 3) for p in files]
    out["decode_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    resized = [resize(im) for im in decoded]
    out["resize_ms_calling_thread"] = (time.perf_counter() - t0) * 1e3
    with ThreadPoolExecutor(workers, initializer=native_etl.set_omp_threads,
                            initargs=(1,)) as pool:
        list(pool.map(resize, decoded[:workers]))   # the workers started
        t0 = time.perf_counter()
        list(pool.map(resize, decoded))
        out[f"resize_ms_{workers}_workers"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch = np.stack(resized)
    out["stack_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    native_etl.u8_to_f32_scaled(batch)
    out["scale_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def phase_image_directory_alexnet(torch, card, device=None, size=None):
    """(a) The DataVec image path feeding zoo AlexNet at its published width:
    a directory of `folders` label folders of PPM images written from a
    seed, read by ImageRecordReader(out_px, out_px, 3) and
    ImageRecordReaderDataSetIterator(batch, classes, workers=W), staged by a
    DevicePrefetchIterator, and `fit` float32 for one epoch (images / batch
    steps). Checks: the native arm carries every ETL call of that run; the
    native resize and scale within one grey level of the numpy arm (the
    share of pixels that differ logged); the first batch bitwise a direct
    decode, resize and scale of its files; K1 and K2 counted twice a step,
    reset just before fit and read just after; the loss finite and the
    parameters moved. Readings: host ETL ms a batch at each W and one
    batch's ETL by stage (`etl_breakdown`), the image-fed step against the
    array-fed prefetched step, and one profiled batch."""
    from deeplearning4j_torch import native_etl
    from deeplearning4j_torch.data.images import (
        ImageRecordReader, ImageRecordReaderDataSetIterator, decode_image)
    from deeplearning4j_torch.data.iterators import DevicePrefetchIterator
    from deeplearning4j_torch.models.zoo import AlexNet
    s = dict(IMAGE_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    root = os.path.join(ROOT, "build", "image_directory")
    per = s["images"] // s["folders"]
    t0 = time.perf_counter()
    write_image_directory(root, s["folders"], per, s["src_px"])
    write_s = time.perf_counter() - t0
    if not native_etl.available():
        raise RuntimeError("image directory: the host ETL's native arm did not "
                           "build or load")
    px, batch = s["out_px"], s["batch"]
    reader = ImageRecordReader(px, px, 3, root=root)
    make = lambda w, r=reader: ImageRecordReaderDataSetIterator(
        r, batch_size=batch, num_classes=s["classes"], workers=w)
    result = {"card": card, "images": len(reader), "folders": len(reader.labels),
              "src_px": s["src_px"], "out_px": px, "batch": batch,
              "write_s": write_s, "etl_built_with": native_etl.built_with()}

    # 1. the ETL arms and the first batch against a direct decode
    first = next(iter(make(max(s["workers"]))))
    files = [p for p, _ in reader.items[:batch]]
    decoded = [decode_image(p, 3) for p in files]
    resized = np.stack([native_etl.resize_bilinear(im, px, px) for im in decoded])
    direct = native_etl.u8_to_f32_scaled(resized)
    if not np.array_equal(first.features, direct):
        raise RuntimeError("image directory: the first batch is not bitwise a "
                           "direct decode, resize and scale of its files")
    with native_etl.numpy_arm():
        plain_resized = np.stack([native_etl.resize_bilinear(im, px, px)
                                  for im in decoded])
        plain_scaled = native_etl.u8_to_f32_scaled(resized)
    grey = np.abs(resized.astype(np.int16) - plain_resized.astype(np.int16))
    scale_diff = np.abs(direct - plain_scaled)
    if grey.max() > 1 or scale_diff.max() > SCALE_ULP:
        raise RuntimeError(f"image directory: native resize {int(grey.max())} grey "
                           f"levels and scale {float(scale_diff.max())} off the "
                           "numpy arm")
    result["arms"] = {"resize_max_grey_levels": int(grey.max()),
                      "resize_share_differing": float(np.mean(grey > 0)),
                      "scale_max_abs_diff": float(scale_diff.max()),
                      "scale_share_not_bitwise": float(np.mean(scale_diff > 0))}
    log(f"image directory: native ETL arm (built with "
        f"{' '.join(result['etl_built_with'])}) against numpy "
        f"{json.dumps(result['arms'])}")

    # 2. host ETL ms a batch at each worker count (the files in the page cache)
    result["etl_ms_per_batch"] = {}
    for w in s["workers"]:
        ms, n = etl_ms_per_batch(lambda w=w: make(w))
        result["etl_ms_per_batch"][str(w)] = ms
    result["etl_breakdown"] = etl_breakdown(files, px, max(s["workers"]))
    log(f"image directory: host ETL ms a batch by workers "
        f"{json.dumps(result['etl_ms_per_batch'])}, one batch by stage "
        f"{json.dumps(result['etl_breakdown'])}  [{card}]")

    # 3. the main path: fit fed by the directory, staged on the device
    net = AlexNet(input_shape=(px, px, 3), num_labels=s["classes"]).init(device=dev)
    steps = -(-len(reader) // batch)
    w_fit = max(s["workers"])
    feed = lambda: DevicePrefetchIterator(make(w_fit), depth=2,
                                          cast_dtype=torch.float32, device=dev)
    before = {k: t.detach().clone() for k, t in net.params_tree[0].items()}
    _sync(torch, dev)
    native_etl.reset_calls()
    zero_launches()   # the main path's run starts here
    net.fit(feed(), pad_to_bucket=False)
    launches = all_launches()   # ... and ends here
    etl_calls = dict(native_etl.calls)
    want = dict.fromkeys(launches, 0)
    want.update(lrn_fwd=2 * steps, lrn_bwd=2 * steps)
    if launches != want or net.iteration != steps:
        raise RuntimeError(f"image directory: {net.iteration} steps, launches "
                           f"{launches}, expected {want}")
    if etl_calls["numpy"] or not etl_calls["native"]:
        raise RuntimeError(f"image directory: the ETL calls of fit went "
                           f"{etl_calls}, not all through the native arm")
    score = float(net.score_value)
    moved = any(not torch.equal(a, net.params_tree[0][k]) for k, a in before.items())
    if not np.isfinite(score) or not moved:
        raise RuntimeError(f"image directory: score {score}, parameters moved {moved}")
    result.update(launches=launches, etl_calls=etl_calls, steps=steps, score=score)
    log(f"image directory fit: {steps} steps, K1/K2 launches "
        f"{launches['lrn_fwd']}/{launches['lrn_bwd']}, ETL calls {etl_calls}, "
        f"score {score}")

    # 4. the step fed by images against the same net fed arrays, both warm
    xs = np.concatenate([ds.features for ds in make(w_fit)])
    ys = np.concatenate([ds.labels for ds in make(w_fit)])
    timing = {}
    for name, call in (("image_fed", lambda: net.fit(feed(), pad_to_bucket=False)),
                       ("array_fed", lambda: net.fit(xs, ys, batch_size=batch))):
        call()   # warm
        _sync(torch, dev)
        t0 = time.perf_counter()
        call()
        _sync(torch, dev)
        timing[name] = (time.perf_counter() - t0) * 1e3 / steps
    result["step_ms"] = timing
    one = ImageRecordReader(px, px, 3, paths=reader.items[:batch],
                            labels=reader.labels)

    def one_batch():
        net.fit(DevicePrefetchIterator(make(w_fit, one), depth=2,
                                       cast_dtype=torch.float32, device=dev),
                pad_to_bucket=False)
        _sync(torch, dev)

    result["profile"] = profile_call(torch, "image-fed AlexNet fit, one batch",
                                     one_batch, {"batch": batch, "workers": w_fit})
    log(f"image directory: step ms image-fed {timing['image_fed']:.3f} against "
        f"array-fed {timing['array_fed']:.3f}, idle share of one batch "
        f"{result['profile'].get('device_idle_share')}  [{card}]")
    return result


def vae_conf(s):
    """dl4j-examples VariationalAutoEncoderExample: 784 -> (256, 256) -> 2
    latent -> (256, 256) -> Bernoulli(784), LEAKYRELU, pzx IDENTITY,
    RmsProp(1e-3), XAVIER, l2 1e-4."""
    from deeplearning4j_torch import (NeuralNetConfiguration, RmsProp,
                                      VariationalAutoencoder, WeightInit)
    return (NeuralNetConfiguration.builder().seed(12345)
            .updater(RmsProp(learning_rate=1e-3)).weight_init(WeightInit.XAVIER)
            .l2(1e-4).list()
            .layer(VariationalAutoencoder(
                n_in=784, n_out=s["latent"], encoder_layer_sizes=s["encoder"],
                decoder_layer_sizes=s["decoder"], activation="leakyrelu",
                pzx_activation="identity", reconstruction_distribution="bernoulli"))
            .build())


def mnist_iterator(path, n_train, batch, seed=2071):
    """MnistDataSetIterator over `n_train` synthesized MNIST images (real IDX
    files under `path`), scaled to [0, 1] by ImagePreProcessingScaler."""
    from deeplearning4j_torch.data.fetchers import (MnistDataSetIterator,
                                                    synthesize_mnist_idx)
    from deeplearning4j_torch.data.normalizers import ImagePreProcessingScaler
    synthesize_mnist_idx(path, n_train=n_train, n_test=batch, seed=seed)
    it = MnistDataSetIterator(batch, path=path)
    it.pre_processor = ImagePreProcessingScaler()
    return it


def _grads_given(torch, fn, params):
    leaves = {k: t.detach().clone().requires_grad_() for k, t in params.items()}
    with torch.enable_grad():
        loss = fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def phase_vae_mnist(torch, card, device=None, size=None):
    """(b) DL4J's VariationalAutoEncoderExample at its published widths:
    `pretrain` for one epoch over synthesized MNIST (IDX files, scaled to
    [0, 1]) on the card. Checks: the negative ELBO of a held-out batch
    (fixed eps) falls; one step's loss and gradients on the card, given the
    same eps, within VAE_STEP_REL of the CPU port's; `reconstruction_error`
    and `generate` run on the card. Readings: ms a step, and the idle share
    of a profiled pretrain of `profiled_steps` steps."""
    from deeplearning4j_torch import MultiLayerNetwork
    from deeplearning4j_torch.utils import params as param_utils
    s = dict(VAE_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    t0 = time.perf_counter()
    it = mnist_iterator(os.path.join(ROOT, "build", "mnist_vae"), s["n_train"],
                        s["batch"])
    synth_s = time.perf_counter() - t0
    net = MultiLayerNetwork(vae_conf(s)).init(device=dev)
    layer = net.layers[0]
    held = torch.as_tensor(next(iter(it)).features, device=dev)
    eps_gen = lambda: torch.Generator(device=dev).manual_seed(77)

    def elbo():
        with torch.no_grad():
            return float(layer.pretrain_loss(net.params_tree[0], held, eps_gen()))

    # 1. one step, card against the CPU port, on the same eps
    eps = [torch.randn((s["batch"], s["latent"]), generator=torch.Generator()
                       .manual_seed(78))]
    step = lambda params, x, e: _grads_given(
        torch, lambda p: layer.pretrain_loss_given(p, x, e), params)
    loss_c, grads_c = step(net.params_tree[0], held, [e.to(dev) for e in eps])
    cpu_params = {k: t.cpu() for k, t in net.params_tree[0].items()}
    loss_h, grads_h = step(cpu_params, held.cpu(), eps)
    rel = _layer_rel_errs(param_utils, (grads_c,), (grads_h,))
    loss_rel = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    if not (loss_rel <= VAE_STEP_REL and max(rel.values()) <= VAE_STEP_REL):
        raise RuntimeError(f"VAE: a step on the card against the CPU: loss "
                           f"{loss_rel}, gradients {rel} (> {VAE_STEP_REL})")
    # 2. the main path: one epoch of pretrain
    before = elbo()
    steps = -(-it.total_examples() // s["batch"])
    _sync(torch, dev)
    t0 = time.perf_counter()
    net.pretrain(it, epochs=1)
    _sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    after = elbo()
    if not (np.isfinite(after) and after < before):
        raise RuntimeError(f"VAE: the held-out negative ELBO went {before} -> {after}")
    # 3. reconstruction_error and generate on the card
    with torch.no_grad():
        recon = float(layer.reconstruction_error(net.params_tree[0], held))
        z = torch.randn((16, s["latent"]), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(79))
        gen = layer.generate(net.params_tree[0], z)
    if not (np.isfinite(recon) and gen.shape == (16, 784) and gen.device.type == dev.type
            and bool(((gen >= 0) & (gen <= 1)).all())):
        raise RuntimeError(f"VAE: reconstruction error {recon}, generated "
                           f"{tuple(gen.shape)} on {gen.device}")
    few = next(iter(it)).features
    few = np.concatenate([few] * s["profiled_steps"])

    def pretrain_few():
        net.pretrain(few, epochs=1, batch_size=s["batch"])
        _sync(torch, dev)

    prof = profile_call(torch, f"VAE pretrain, {s['profiled_steps']} steps",
                        pretrain_few, {"steps": s["profiled_steps"]})
    result = {"card": card, "steps": steps, "step_ms": ms, "synth_s": synth_s,
              "elbo_before": before, "elbo_after": after,
              "reconstruction_error": recon, "step_vs_cpu": {"loss": loss_rel,
                                                             "grads": rel},
              "device_idle_share": prof.get("device_idle_share"), "profile": prof}
    log(f"VAE MNIST: {steps} pretrain steps, {ms:.3f} ms a step, negative ELBO "
        f"{before:.3f} -> {after:.3f}, card vs CPU {max(rel.values()):.3g}, idle "
        f"share {result['device_idle_share']}  [{card}]")
    return result


def dbn_conf(s):
    """784-1000-500-250-30 (Hinton & Salakhutdinov 2006's encoder): an RBM,
    three sigmoid AutoEncoders, then a softmax OutputLayer over 10 digits."""
    from deeplearning4j_torch import (RBM, Adam, AutoEncoder, InputType,
                                      NeuralNetConfiguration, OutputLayer,
                                      WeightInit)
    w = s["widths"]
    b = (NeuralNetConfiguration.builder().seed(2006)
         .updater(Adam(learning_rate=1e-3)).weight_init(WeightInit.XAVIER).list()
         .layer(RBM(n_out=w[0], cd_k=1)))
    for n in w[1:]:
        b = b.layer(AutoEncoder(n_out=n, activation="sigmoid", corruption_level=0.2))
    return (b.layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(784)).build())


def cd_chain(torch, layer, params, x, uniforms, pinned=None):
    """CD-k by the layer's own prop_up/prop_down from `uniforms`, returning
    (statistics as `RBM.pretrain_grads_given` forms them, per draw the
    probabilities and the decisions). `pinned` (per draw: mask, decisions)
    forces the decisions where the mask is set (`pinned_kinks`' role for
    Bernoulli draws)."""
    draws = []

    def sample(i, p):
        on = uniforms[i] < p
        if pinned is not None:
            mask, forced = pinned[i]
            on = torch.where(mask, forced, on)
        draws.append((p, on))
        return on.to(x.dtype)

    with torch.no_grad():
        h0p = layer.prop_up(params, x)
        hs, i = sample(0, h0p), 1
        for k in range(layer.cd_k):
            vkp = layer.prop_down(params, hs)
            vs = sample(i, vkp)
            hkp = layer.prop_up(params, vs)
            i += 1
            if k < layer.cd_k - 1:
                hs = sample(i, hkp)
                i += 1
        B = x.shape[0]
        stats = {"W": -(x.T @ h0p - vkp.T @ hkp) / B,
                 "b": -torch.mean(h0p - hkp, dim=0),
                 "vb": -torch.mean(x - vkp, dim=0)}
    return stats, draws


def check_cd_step(torch, layer, params, x, seed=2081):
    """One CD step on the card against the CPU on the same uniforms: the
    card's `pretrain_grads_given` is the chain `cd_chain` forms; the CPU's
    chain takes the card's decisions where |u - p| < CD_NEAR (pinned;
    above MAX_PINNED_SHARE of all decisions flipped fails) and its
    statistics are within CD_STAT_REL of the card's."""
    from deeplearning4j_torch.utils import params as param_utils
    gen = torch.Generator().manual_seed(seed)
    shapes = layer.noise_shapes(x.shape[0])
    u_cpu = [torch.rand(sh, generator=gen) for sh in shapes]
    u_dev = [u.to(x.device) for u in u_cpu]
    with torch.no_grad():
        _, lib_stats = layer.pretrain_grads_given(params, x, u_dev)
    card_stats, card_draws = cd_chain(torch, layer, params, x, u_dev)
    for k in card_stats:
        if not torch.equal(card_stats[k], lib_stats[k]):
            raise RuntimeError(f"CD step: pretrain_grads_given's {k} is not the "
                               "chain's on the card")
    pinned = [((u - p.cpu()).abs() < CD_NEAR, on.cpu())
              for u, (p, on) in zip(u_cpu, card_draws)]
    cpu_params = {k: t.cpu() for k, t in params.items()}
    cpu_stats, cpu_draws = cd_chain(torch, layer, cpu_params, x.cpu(), u_cpu, pinned)
    unpinned = [(u < p) for u, (p, _) in zip(u_cpu, cpu_draws)]
    flips = sum(int(((un != on.cpu()) & m).sum())
                for un, (_, on), (m, _) in zip(unpinned, card_draws, pinned))
    near = sum(int(m.sum()) for m, _ in pinned)
    total = sum(u.numel() for u in u_cpu)
    if flips > MAX_PINNED_SHARE * total:
        raise RuntimeError(f"CD step: {flips} of {total} Bernoulli decisions "
                           f"flipped before they were pinned")
    rel = _layer_rel_errs(param_utils, (card_stats,), (cpu_stats,))
    if max(rel.values()) > CD_STAT_REL:
        raise RuntimeError(f"CD step: statistics card vs CPU {rel} (> {CD_STAT_REL})")
    return {"stats_rel": rel, "near_decisions": near, "flipped": flips,
            "decisions": total}


def recon_mse(torch, layer, params, x):
    """Deterministic reconstruction MSE: the RBM's mean-field
    prop_down(prop_up(x)), an AutoEncoder's decode(encode(x))."""
    with torch.no_grad():
        if hasattr(layer, "prop_up"):
            r = layer.prop_down(params, layer.prop_up(params, x))
        else:
            r = layer.decode(params, layer.encode(params, x))
        return float(torch.mean(torch.sum((r - x) ** 2, dim=-1)))


def phase_dbn_mnist(torch, card, device=None, size=None):
    """(c) Greedy layerwise pretrain of the 784-1000-500-250-30 stack
    (RBM CD-1, then three AutoEncoders) for one epoch over synthesized MNIST
    in [0, 1], then `fit` of the whole network with its softmax head for one
    epoch, on the card. Checks: a CD-1 step card vs CPU on the same uniforms
    (`check_cd_step`); each layer's reconstruction MSE on a held-out batch
    falls from its initial parameters to its pretrained ones, on the same
    input (the pretrained layers below it); a frozen
    layer is skipped by pretrain; the fit score finite. Readings: ms a
    pretrain step, ms a fit step, and a profiled pretrain of one batch
    through the four layers."""
    from deeplearning4j_torch import MultiLayerNetwork
    s = dict(DBN_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    it = mnist_iterator(os.path.join(ROOT, "build", "mnist_dbn"), s["n_train"],
                        s["batch"], seed=2072)
    net = MultiLayerNetwork(dbn_conf(s)).init(device=dev)
    held = torch.as_tensor(next(iter(it)).features, device=dev)
    cd = check_cd_step(torch, net.layers[0], net.params_tree[0], held)
    log(f"DBN: CD-1 card vs CPU {json.dumps(cd)} (limits {CD_STAT_REL}, "
        f"{MAX_PINNED_SHARE} of the decisions)")
    n_pre = len(s["widths"])

    def recon_all(params):
        """Each layer's reconstruction MSE under `params` (per layer), its
        input from the network's current layers below it."""
        with torch.no_grad():
            return [recon_mse(torch, net.layers[i], params[i],
                              net._prefix_activations(i, held)) for i in range(n_pre)]

    # a frozen layer is skipped: a clone with layer 1 frozen, two batches
    frozen = net.clone()
    frozen.layers[1].frozen = True
    two = np.concatenate([held.cpu().numpy()] * 2)
    frozen.pretrain(two, epochs=1, batch_size=s["batch"])
    same = [all(torch.equal(frozen.params_tree[i][k], net.params_tree[i][k])
                for k in net.params_tree[i]) for i in range(n_pre + 1)]
    if same != [i in (1, n_pre) for i in range(n_pre + 1)]:
        raise RuntimeError(f"DBN: unchanged layers after pretrain with layer 1 "
                           f"frozen: {same}")
    del frozen
    initial = [dict(p) for p in net.params_tree]
    steps = -(-it.total_examples() // s["batch"])
    _sync(torch, dev)
    zero_launches()
    t0 = time.perf_counter()
    net.pretrain(it, epochs=1)
    _sync(torch, dev)
    pre_ms = (time.perf_counter() - t0) * 1e3 / (steps * n_pre)
    before, after = recon_all(initial), recon_all(net.params_tree)
    if not all(np.isfinite(a) and a < b for a, b in zip(after, before)):
        raise RuntimeError(f"DBN: reconstruction MSE by layer {before} -> {after}")
    if net.iteration != 0:
        raise RuntimeError("DBN: pretrain moved the network's iteration count")
    _sync(torch, dev)
    t0 = time.perf_counter()
    net.fit(it)
    _sync(torch, dev)
    fit_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = all_launches()
    score = float(net.score_value)
    if not np.isfinite(score) or net.iteration != steps or any(launches.values()):
        raise RuntimeError(f"DBN: fit score {score}, {net.iteration} steps, "
                           f"launches {launches}")
    one = held.cpu().numpy()

    def pretrain_one():
        net.pretrain(one, epochs=1, batch_size=s["batch"])
        _sync(torch, dev)

    prof = profile_call(torch, "DBN pretrain, one batch through the four layers",
                        pretrain_one, {"layer_steps": n_pre})
    result = {"card": card, "steps": steps, "pretrain_ms_per_layer_step": pre_ms,
              "fit_step_ms": fit_ms, "recon_before": before, "recon_after": after,
              "cd_step": cd, "fit_score": score, "launches": launches,
              "device_idle_share": prof.get("device_idle_share"), "profile": prof}
    log(f"DBN MNIST: pretrain {pre_ms:.3f} ms a layer step, fit {fit_ms:.3f} ms a "
        f"step, reconstruction MSE {before} -> {after}, idle share "
        f"{result['device_idle_share']}  [{card}]")
    return result


def phase_records_export(torch, card, device=None):
    """A CSV written here goes through CSVRecordReader and
    RecordReaderDataSetIterator into an Iris-shaped network (4-10-3) that
    runs `fit` on the card; its batches are the CSV's rows; then
    `export_datasets` re-batches the same records to files and `fit` on
    ExportedDataSetIterator is bitwise `fit` on the same batches held in
    memory."""
    import shutil
    from deeplearning4j_torch import (DenseLayer, InputType, MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer, Sgd)
    from deeplearning4j_torch.data.export import (ExportedDataSetIterator,
                                                  export_datasets)
    from deeplearning4j_torch.data.fetchers import iris_dataset
    from deeplearning4j_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_torch.data.records import (CSVRecordReader,
                                                   RecordReaderDataSetIterator)
    dev = torch.device(device or "cuda")
    d = os.path.join(ROOT, "build", "records_export")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    iris = iris_dataset()
    path = os.path.join(d, "iris.csv")
    with open(path, "w") as f:
        f.write("sepal_l,sepal_w,petal_l,petal_w,species\n")
        for x, y in zip(iris.features, iris.labels):
            f.write(",".join(repr(float(v)) for v in x) + f",{int(np.argmax(y))}\n")
    make = lambda: RecordReaderDataSetIterator(CSVRecordReader(path, skip_lines=1),
                                               batch_size=50, label_index=4,
                                               num_classes=3)
    rows = list(make())
    if not (np.array_equal(np.concatenate([r.features for r in rows]), iris.features)
            and np.array_equal(np.concatenate([r.labels for r in rows]), iris.labels)):
        raise RuntimeError("records: the CSV's batches are not its rows")
    conf = lambda: (NeuralNetConfiguration.builder().seed(4)
                    .updater(Sgd(learning_rate=0.1)).list()
                    .layer(DenseLayer(n_out=10, activation="tanh"))
                    .layer(OutputLayer(n_out=3, activation="softmax"))
                    .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf()).init(device=dev)
    net.fit(make(), epochs=5)
    acc = net.evaluate(iris.features, iris.labels).accuracy()
    if not np.isfinite(float(net.score_value)) or net.iteration != 15:
        raise RuntimeError(f"records: fit took {net.iteration} steps, score "
                           f"{float(net.score_value)}")
    files = export_datasets(make(), os.path.join(d, "exported"), 32)
    a = MultiLayerNetwork(conf()).init(device=dev)
    b = MultiLayerNetwork(conf()).init(device=dev)
    a.fit(ExportedDataSetIterator(os.path.join(d, "exported")), pad_to_bucket=False)
    b.fit(ListDataSetIterator(iris, 32), pad_to_bucket=False)
    if not _same_tree(a.params_tree, b.params_tree):
        raise RuntimeError("export: fit on the exported files is not bitwise fit "
                           "on the same batches")
    result = {"card": card, "csv_batches": len(rows), "fit_steps": net.iteration,
              "accuracy": acc, "exported_files": len(files), "export_bitwise": True}
    log(f"records and export: {json.dumps(result)}")
    shutil.rmtree(d, ignore_errors=True)
    return result


# ---------------------------------------------------------------------------
# Scale-out: the replica federation, ParallelWrapper, the parameter server
# and the multi-process runner
# ---------------------------------------------------------------------------

FEDERATION_FULL = dict(alexnet=((224, 224, 3), 1000), clients=4, bodies=24, max_rows=8,
                       load_s=30.0, gen_clients=2, gen_prompts=4,
                       kill_predict_clients=2, kill_generate_clients=2,
                       kill_new_tokens=64, decode_step_delay_ms=10,
                       train_batch=32, train_steps=2,
                       swap_clients=2, swap_inputs=4, batch_limit=None,
                       decode=None)   # None: DECODE_GEOMETRY
FEDERATION_HEALTH = dict(interval_s=0.2, timeout_s=3.0)   # the front end's sweep
FEDERATION_BEAT_S = 0.2       # each replica's beat cadence
FEDERATION_JOIN_S = 600       # spawn to HEALTHY, the kernels' load and warmup included
FEDERATION_WAIT_S = 120       # a chaos condition (an in-flight request) to arise
FEDERATION_BUILDER = "chip_smoke:federation_builder"


def federation_builder(gateway):
    """The replica of `phase_federation` (spawned with `--builder
    chip_smoke:federation_builder`): zoo AlexNet in float32 as "alexnet"
    with the shared checkpoint directory, and TransformerDecoder(seed=7) as
    "decoder" at bench_serving_decode's geometry, on the device and at the
    size that DL4JTPU_FED_SPEC (JSON) names. A metrics collector publishes
    this process's kernel launch counts and the AlexNet entry's forwards at
    GET /metrics, so the parent holds each replica's K1 and K7 to what it
    served."""
    import torch

    from deeplearning4j_torch.models.zoo import AlexNet
    from deeplearning4j_torch.optimize.metrics import registry
    from deeplearning4j_torch.optimize.resilience import CheckpointManager
    from deeplearning4j_torch.serving import decode as sd
    from deeplearning4j_torch.utils.device import exact_float32
    exact_float32()
    spec = json.loads(os.environ["DL4JTPU_FED_SPEC"])
    dev = spec["device"]
    shape, classes = spec["alexnet"]
    net = AlexNet(input_shape=tuple(shape), num_labels=classes).init(device=dev)
    gateway.add_model("alexnet", net, batch_limit=spec["batch_limit"],
                      checkpoints=CheckpointManager(spec["ckpt"], save_updater=False))
    g = spec["decode"]
    decoder = sd.TransformerDecoder(vocab=g["vocab"], layers=g["layers"],
                                    heads=g["heads"], head_dim=g["head_dim"],
                                    ff=g["ff"], max_context=g["max_context"],
                                    seed=7, device=dev)
    gateway.add_decode_model("decoder", decoder, max_decode_batch=g["max_decode_batch"],
                             pack_bucket=g["pack_bucket"],
                             kv_block_tokens=g["block_tokens"],
                             kv_max_blocks=g["kv_max_blocks"])

    def collect(reg):
        launches = reg.gauge("chip_smoke_kernel_launches",
                             "Kernel launches in this replica process")
        for name, n in all_launches().items():
            launches.labels(kernel=name).set(n)
        reg.gauge("chip_smoke_alexnet_forwards",
                  "Forwards of the alexnet entry").set(
                      gateway.pool.get("alexnet").engine.total_forwards)
    registry().register_collector(collect)


def scrape_metrics(url):
    """{sample name with labels: value} of GET /metrics."""
    import urllib.request
    with urllib.request.urlopen(url + "/metrics", timeout=GATEWAY_HTTP_TIMEOUT_S) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def replica_counts(url):
    """(K1 launches, K7 launches, AlexNet forwards, decode steps) of one
    replica so far."""
    m = scrape_metrics(url)
    k = lambda name: m.get(f'chip_smoke_kernel_launches{{kernel="{name}"}}', 0.0)
    return (k("lrn_fwd"), k("decode_attention"), m.get("chip_smoke_alexnet_forwards", 0.0),
            m.get('serving_decode_steps_total{model="decoder"}', 0.0))


def stop_processes(procs, timeout=30):
    """SIGTERM every live process, then SIGKILL what has not ended."""
    import signal
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def wait_for(cond, timeout, what, detail=lambda: ""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise RuntimeError(f"federation: {what} within {timeout} s {detail()}"[:4000])


def request_loop(url, bodies, stop, records, c, errors):
    """POST `bodies` in turn, from the `c`-th on, to `url` until `stop`:
    records (body index, sent s, answered s, status, body)."""
    i = c
    try:
        while not stop.is_set():
            k = i % len(bodies)
            t = time.perf_counter()
            code, body = http_json(url, bodies[k])
            records.append((k, t, time.perf_counter(), code, body))
            i += 1
    except BaseException as e:
        errors.append(e)


def phase_federation(torch, card, device=None, size=None, builder=FEDERATION_BUILDER):
    """Two serving replicas behind one `FederationFrontEnd`
    (serving/federation.py), on one card:

    1. The front end runs in this process; two replicas come from
       `spawn_replica` with `federation_builder` (AlexNet float32 and the
       decoder at bench_serving_decode's geometry), both on the card, the
       kernels loaded from the build this script made. For `load_s`
       seconds, `clients` closed-loop /predict clients (phase_gateway's
       mix of 1 to `max_rows` images a request, at the rate the JSON leg
       carries) and `gen_clients` /generate clients beside them go
       through the front end: every answer equals this process's AlexNet
       `output` on the same rows (SERVE tolerances) or `naive_generate`;
       both replicas served; each replica's K1 launches are 2 x the
       forwards it ran and its K7 launches layers x its decode steps (GET
       /metrics of the replica, before and after the load). HTTP p50/p99
       are over every /predict of the window.
    2. SIGKILL replica 0 while it holds a /predict and a /generate in
       flight: it is evicted, its /predict retries once on the sibling and
       no /predict fails; the cut /generate answers 503 replica_lost with
       tokens_so_far; every other answer across the kill is held as in 1.
       Decode steps are slowed by DL4JTPU_FAULT_SERVE_DECODE_STEP (delay),
       so a /generate is in flight long enough to be cut.
    3. Replica 0 respawned: JOINING until warmed, then HEALTHY, then it takes
       traffic again.
    4. A second AlexNet trained `train_steps` steps publishes a checkpoint;
       POST /swap to the front end (canary, then promote) under live
       traffic: no request fails, every answer is the old parameters' or the
       new ones', answers sent after it returned are the new ones', and each
       replica, asked directly, answers with the new parameters.

    Reports HTTP p50/p99 and images/s through the front end over the load
    window, the eviction time, the failover count, JOINING -> HEALTHY, and
    the swap's wall time."""
    import tempfile

    from deeplearning4j_torch.models.zoo import AlexNet
    from deeplearning4j_torch.optimize.metrics import registry
    from deeplearning4j_torch.optimize.resilience import CheckpointManager
    from deeplearning4j_torch.parallel.cluster_health import HealthConfig
    from deeplearning4j_torch.serving import decode as sd
    from deeplearning4j_torch.serving import federation as fed
    s = dict(FEDERATION_FULL, **(size or {}))
    dev = device or "cuda"
    g = s["decode"] or DECODE_GEOMETRY
    rng = np.random.default_rng(2191)
    reg = registry()
    a_shape, a_classes = s["alexnet"]
    result = {"card": card}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_federation_")
    spec = {"device": str(dev), "alexnet": [list(a_shape), a_classes],
            "decode": g, "ckpt": os.path.join(tmp.name, "alexnet"),
            "batch_limit": s["batch_limit"] or SERVE_BATCH_LIMIT}
    env = {"DL4JTPU_FED_SPEC": json.dumps(spec),
           "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
           "DL4JTPU_FAULT_SERVE_DECODE_STEP": f"delay:*@{s['decode_step_delay_ms']}"}
    fe = fed.FederationFrontEnd(health=HealthConfig(**FEDERATION_HEALTH),
                                request_timeout_s=GATEWAY_HTTP_TIMEOUT_S).start()
    procs = []

    def spawn(rid):
        return fed.spawn_replica(rid, fe.url, builder=builder,
                                 interval_s=FEDERATION_BEAT_S, env=env)

    def state(rid):
        with fe._lock:
            rep = fe._replicas.get(rid)
            return None if rep is None else rep.state

    def replica_urls():
        return {r["id"]: r["url"] for r in http_json(fe.url + "/replicas")[1]["replicas"]}

    try:
        t0 = time.perf_counter()
        procs = [spawn(0), spawn(1)]
        ref_net = AlexNet(input_shape=a_shape, num_labels=a_classes).init(device=dev)
        decoder = sd.TransformerDecoder(vocab=g["vocab"], layers=g["layers"],
                                        heads=g["heads"], head_dim=g["head_dim"],
                                        ff=g["ff"], max_context=g["max_context"],
                                        seed=7, device=dev)
        if not fe.wait_for_replicas(2, timeout=FEDERATION_JOIN_S):
            raise RuntimeError(f"federation: replicas not healthy: "
                               f"{http_json(fe.url + '/replicas')[1]}")
        result["join_s"] = time.perf_counter() - t0
        urls = replica_urls()

        # 1. the load through the front end, over a fixed window
        xs = [pixel_images(rng, int(rng.integers(1, s["max_rows"] + 1)), a_shape)
              for _ in range(s["bodies"])]
        bodies = [json.dumps({"model": "alexnet", "features": x.tolist()}).encode()
                  for x in xs]
        wants = [ref_net.output(x) for x in xs]
        prompts = [rng.integers(0, g["vocab"], size=ln).tolist()
                   for ln in rng.integers(g["prompt_lo"], g["prompt_hi"],
                                          size=s["gen_prompts"])]
        load_gen = [json.dumps({"model": "decoder", "prompt": p,
                                "max_new_tokens": g["max_new_tokens"]}).encode()
                    for p in prompts]
        naive = [sd.naive_generate(decoder, p, g["max_new_tokens"], pad_to=g["pack_bucket"])
                 for p in prompts]
        before = {rid: replica_counts(u) for rid, u in urls.items()}
        disp0 = {r["id"]: r["dispatched"] for r in
                 http_json(fe.url + "/replicas")[1]["replicas"]}
        stop, records, gen_out, errors = threading.Event(), [], [], []
        loops = [threading.Thread(target=request_loop, daemon=True, args=(
            fe.url + "/predict", bodies, stop, records, c * len(bodies) // s["clients"],
            errors)) for c in range(s["clients"])]
        loops += [threading.Thread(target=request_loop, daemon=True, args=(
            fe.url + "/generate", load_gen, stop, gen_out, c, errors))
            for c in range(s["gen_clients"])]
        t_load = time.perf_counter()
        for t in loops:
            t.start()
        stop.wait(s["load_s"])
        stop.set()
        for t in loops:
            t.join(timeout=GATEWAY_JOIN_S)
        if errors or any(t.is_alive() for t in loops):
            raise RuntimeError(f"federation: clients failed: {errors!r}")
        after = {rid: replica_counts(u) for rid, u in urls.items()}
        if not records or not gen_out:
            raise RuntimeError(f"federation: {len(records)} /predict and {len(gen_out)} "
                               f"/generate answered in {s['load_s']} s")
        failed = [(k, code, body) for k, _, _, code, body in records + gen_out
                  if code != 200]
        if failed:
            raise RuntimeError(f"federation: failed requests {failed!r}"[:2000])
        max_err = 0.0
        for k, _, _, _, body in records:
            got = np.asarray(body["predictions"], np.float32)
            np.testing.assert_allclose(got, wants[k], rtol=SERVE_RTOL, atol=SERVE_ATOL)
            max_err = max(max_err, float(np.abs(got - wants[k]).max()))
        for k, _, _, _, body in gen_out:
            if body["tokens"] != naive[k]:
                raise RuntimeError(f"federation: /generate of prompt {k} is not "
                                   "naive_generate's tokens")
        disp = {r["id"]: r["dispatched"] - disp0[r["id"]] for r in
                http_json(fe.url + "/replicas")[1]["replicas"]}
        if min(disp.values()) < 1:
            raise RuntimeError(f"federation: a replica served nothing: {disp}")
        counts = {}
        for rid in urls:
            k1, k7, fwd, steps = (a - b for a, b in zip(after[rid], before[rid]))
            if k1 != lrn_layers_of(ref_net) * fwd or k7 != g["layers"] * steps:
                raise RuntimeError(f"federation: replica {rid} launched K1 {k1} for "
                                   f"{fwd} forwards and K7 {k7} for {steps} decode steps")
            counts[rid] = {"lrn_fwd": k1, "decode_attention": k7, "forwards": fwd,
                           "decode_steps": steps}
        if sum(c["lrn_fwd"] for c in counts.values()) < 1 or \
                sum(c["decode_attention"] for c in counts.values()) < 1:
            raise RuntimeError(f"federation: the replicas launched no K1 or no K7: {counts}")
        images = sum(xs[k].shape[0] for k, *_ in records)
        span = max(r[2] for r in records) - min(r[1] for r in records)
        result.update(http=latency_stats([r[2] - r[1] for r in records], images, span),
                      load_window_s=s["load_s"], load_wall_s=time.perf_counter() - t_load,
                      generate_answers=len(gen_out), dispatched=disp,
                      replica_launches=counts, max_abs_err_vs_in_process=max_err)
        log(f"federation: {len(records)} /predict ({images} images) + {len(gen_out)} "
            f"/generate through the front end in a {s['load_s']} s window, dispatched "
            f"{json.dumps(disp)}, per replica {json.dumps(counts)}; HTTP p50 "
            f"{result['http']['p50_ms']:.3f} ms p99 {result['http']['p99_ms']:.3f} ms "
            f"{result['http']['images_per_s']:.2f} images/s  [{card}]")

        # 2. SIGKILL replica 0 mid-load
        gen_bodies = [json.dumps({"model": "decoder", "prompt": p,
                                  "max_new_tokens": s["kill_new_tokens"]}).encode()
                      for p in prompts]
        stop, records, gen_out, errors = threading.Event(), [], [], []
        retries0 = reg.counter("serving_failover_retries_total").total(outcome="ok")
        evict0 = reg.counter("serving_replica_evictions_total").total()
        loops = [threading.Thread(target=request_loop, daemon=True, args=(
            fe.url + "/predict", bodies, stop, records, c, errors))
            for c in range(s["kill_predict_clients"])]
        loops += [threading.Thread(target=request_loop, daemon=True, args=(
            fe.url + "/generate", gen_bodies, stop, gen_out, c, errors))
            for c in range(s["kill_generate_clients"])]
        for t in loops:
            t.start()

        def victim_busy():
            with fe._lock:
                kinds = {r.kind for r in fe._replicas[0].inflight}
            return {"predict", "generate"} <= kinds

        def detail():
            bad = [(code, b) for _, _, _, code, b in records + gen_out if code != 200]
            return (f"(replicas {http_json(fe.url + '/replicas')[1]}, errors "
                    f"{errors!r}, failed answers {bad[:4]!r})")
        wait_for(victim_busy, FEDERATION_WAIT_S,
                 "replica 0 never held a /predict and a /generate at once", detail)
        procs[0].kill()
        t_kill = time.perf_counter()
        wait_for(lambda: state(0) == fed.DEAD, FEDERATION_WAIT_S,
                 "replica 0 not evicted", detail)
        evict_ms = (time.perf_counter() - t_kill) * 1e3
        procs[0].wait(timeout=60)
        time.sleep(1.0)   # the survivor carries the load alone for a while
        stop.set()
        for t in loops:
            t.join(timeout=GATEWAY_JOIN_S)
        if errors or any(t.is_alive() for t in loops):
            raise RuntimeError(f"federation: kill-stage clients failed: {errors!r}")
        failed = [(k, code, body) for k, _, _, code, body in records if code != 200]
        if failed:
            raise RuntimeError(f"federation: /predict failed across the kill: "
                               f"{failed!r}"[:2000])
        for k, _, _, _, body in records:
            np.testing.assert_allclose(np.asarray(body["predictions"], np.float32),
                                       wants[k], rtol=SERVE_RTOL, atol=SERVE_ATOL)
        cut = [b for _, _, _, code, b in gen_out if code != 200]
        if not cut or any(b.get("reason") != "replica_lost" or "tokens_so_far" not in b
                          for b in cut):
            raise RuntimeError(f"federation: no typed replica_lost /generate: "
                               f"{[(c, b) for _, _, _, c, b in gen_out]!r}"[:2000])
        for k, _, _, code, body in gen_out:
            if code == 200 and body["tokens"] != sd.naive_generate(
                    decoder, prompts[k], s["kill_new_tokens"], pad_to=g["pack_bucket"]):
                raise RuntimeError(f"federation: /generate {k} across the kill is not "
                                   "naive_generate's")
        retries = reg.counter("serving_failover_retries_total").total(outcome="ok") - retries0
        if retries < 1:
            raise RuntimeError("federation: the killed replica's /predict did not fail over")
        result["kill"] = {"predicts": len(records), "failed_predicts": 0,
                          "failover_retries_ok": retries,
                          "evictions": reg.counter(
                              "serving_replica_evictions_total").total() - evict0,
                          "eviction_ms": evict_ms, "generate_cut": len(cut),
                          "generate_ok": len(gen_out) - len(cut)}
        log(f"federation: SIGKILL replica 0 {json.dumps(result['kill'])}  [{card}]")

        # 3. respawn
        t_respawn = time.perf_counter()
        procs[0] = spawn(0)
        seen = []

        def joined():
            st = state(0)
            if not seen or seen[-1] != st:
                seen.append(st)
            return st == fed.HEALTHY
        wait_for(joined, FEDERATION_JOIN_S, "the respawned replica never became healthy")
        if fed.JOINING not in seen:
            raise RuntimeError(f"federation: the respawned replica went {seen}, "
                               "never JOINING before HEALTHY")
        d0 = {r["id"]: r["dispatched"] for r in http_json(fe.url + "/replicas")[1]["replicas"]}
        answers, _, _ = run_http_clients(fe.url + "/predict", [
            [((c, j), bodies[2 * c + j]) for j in range(2)] for c in range(2)])
        ok_predictions("federation after respawn", answers)
        d1 = {r["id"]: r["dispatched"] for r in http_json(fe.url + "/replicas")[1]["replicas"]}
        if d1[0] <= d0[0]:
            raise RuntimeError("federation: the respawned replica took no traffic")
        result["respawn"] = {"states": seen, "to_healthy_s": time.perf_counter() - t_respawn}

        # 4. rolling swap under traffic
        trainer = AlexNet(input_shape=a_shape, num_labels=a_classes).init(device=dev)
        n_train = s["train_batch"] * s["train_steps"]
        xt = rng.standard_normal((n_train,) + tuple(a_shape)).astype(np.float32)
        yt = np.eye(a_classes, dtype=np.float32)[rng.integers(0, a_classes, n_train)]
        trainer.fit(xt, yt, epochs=1, batch_size=s["train_batch"])
        CheckpointManager(spec["ckpt"], save_updater=False).save(trainer)
        swap_x = [pixel_images(rng, 1 + i % 2, a_shape) for i in range(s["swap_inputs"])]
        old = [ref_net.output(x) for x in swap_x]
        new = [trainer.output(x) for x in swap_x]
        if all(np.allclose(a, b, rtol=SERVE_RTOL, atol=SERVE_ATOL) for a, b in zip(old, new)):
            raise RuntimeError("federation: the trained AlexNet answers as the old one does")
        sbodies = [json.dumps({"model": "alexnet", "features": x.tolist()}).encode()
                   for x in swap_x]
        stop, records, errors = threading.Event(), [], []
        loops = [threading.Thread(target=request_loop, daemon=True, args=(
            fe.url + "/predict", sbodies, stop, records, c, errors))
            for c in range(s["swap_clients"])]
        for t in loops:
            t.start()
        wait_for(lambda: len(records) >= s["swap_clients"], FEDERATION_WAIT_S,
                 "no answer before the swap")
        t = time.perf_counter()
        swap = http_json(fe.url + "/swap", {"model": "alexnet"})
        done_at = time.perf_counter()
        wait_for(lambda: sum(1 for r in records if r[1] > done_at) >= 2 * s["swap_clients"],
                 FEDERATION_WAIT_S, "no answer after the swap")
        stop.set()
        for th in loops:
            th.join(timeout=GATEWAY_JOIN_S)
        if errors or swap[0] != 200 or sorted(swap[1].get("swapped", [])) != [0, 1]:
            raise RuntimeError(f"federation: the rolling swap answered {swap} "
                               f"({errors!r})")
        seen_swap = {"old": 0, "new": 0, "after_swap": 0}
        for k, sent, _, code, body in records:
            if code != 200:
                raise RuntimeError(f"federation: a request during the swap answered {code}")
            out = np.asarray(body["predictions"], np.float32)
            is_new = np.allclose(out, new[k], rtol=SERVE_RTOL, atol=SERVE_ATOL)
            if not is_new and not np.allclose(out, old[k], rtol=SERVE_RTOL, atol=SERVE_ATOL):
                raise RuntimeError("federation: an answer during the swap is neither the "
                                   "old parameters' nor the new ones'")
            seen_swap["new" if is_new else "old"] += 1
            if sent > done_at:
                seen_swap["after_swap"] += 1
                if not is_new:
                    raise RuntimeError("federation: an answer sent after the swap "
                                       "returned is the old parameters'")
        for rid, url in replica_urls().items():
            code, body = http_json(url + "/predict", sbodies[0])
            if code != 200 or not np.allclose(np.asarray(body["predictions"], np.float32),
                                              new[0], rtol=SERVE_RTOL, atol=SERVE_ATOL):
                raise RuntimeError(f"federation: replica {rid} does not answer with the "
                                   "new parameters after the roll")
        result["swap"] = {"answers": seen_swap, "requests": len(records),
                          "swap_wall_ms": (done_at - t) * 1e3, "canary": swap[1]["canary"]}
        log(f"federation: respawn {json.dumps(result['respawn'])}; rolling swap "
            f"{json.dumps(result['swap'])}  [{card}]")
        return result
    finally:
        stop_processes(procs)
        fe.stop()
        tmp.cleanup()


WRAPPER_FULL = dict(alexnet=((224, 224, 3), 1000), batch=128, shards=2, sync_steps=4,
                    local_freq=3, local_steps=6, local_batches=3, timed_steps=3)
# A leaf's update, sharded against plain (`update_rel_errs`): after one step
# it differs by rounding, 8.0e-5 at most on the card (PR 18): one float32
# rounding of a dense bias of 1.0 whose update is 6.8e-4 in norm, the
# weights 4.1e-6; over a few steps ReLU and max-pool decisions tip where
# the two runs round apart and the conv layers' updates drift apart (2.5e-3
# after 4 steps; the dense layers' stay near 2e-6), as the card-vs-CPU
# gradient checks see.
UPDATE_REL_STEP = 1e-3
UPDATE_REL_FIT = 1e-2


def alexnet_batches(rng, n, batch, shape, classes):
    x = rng.standard_normal((n * batch,) + tuple(shape)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n * batch)]
    return x, y


UPDATE_ULP = 1e-6   # of a leaf's norm: float32 rounding of the parameter itself


def update_rel_errs(param_utils, init, got, want):
    """Per leaf, |got - want| / (|want - init| + UPDATE_ULP |want|): the
    sharded run's update against the plain run's, where a parameter near 1
    moved by 1e-5 (a bias) keeps its float32 rounding (6e-8) out of the
    ratio."""
    out = []
    for i, g, w in zip(param_utils.tree_leaves(init), param_utils.tree_leaves(got),
                       param_utils.tree_leaves(want)):
        w = w.double()
        scale = (w - i.double()).norm().item() + UPDATE_ULP * w.norm().item()
        if scale > 0:
            out.append((g.double() - w).norm().item() / scale)
    return out


class Snapshots:
    """A listener keeping a copy of the parameters after every step, after
    a copy of those it starts from."""

    def __init__(self, param_utils, net):
        self.param_utils, self.trees = param_utils, [param_utils.tree_copy(net.params_tree)]

    def iteration_done(self, model, iteration):
        self.trees.append(self.param_utils.tree_copy(model.params_tree))


def split_step(torch, net, x, y, blocks):
    """One plain step of `net` on (x, y) whose gradient is the mean of the
    gradients of `blocks` forwards and backwards of its row blocks: the
    rounding of a sharded step, without ParallelWrapper. Each block draws
    its rows of the whole batch's dropout mask (nn/shards.py), so only the
    rounding differs from the plain step."""
    from deeplearning4j_torch.nn import shards
    xt, yt = net._as_input(x), net._as_labels(y)
    n = xt.shape[0]
    c = n // blocks
    gen_state, state = net._dropout_gen.get_state(), net._merged_state()
    parts = []
    for i in range(blocks):
        g = torch.Generator(device=net._dropout_gen.device)
        g.set_state(gen_state)
        with shards.sharded(shards.ShardContext(i, blocks, i * c, c, n)):
            parts.append(net._value_and_grad(xt[i * c:(i + 1) * c], yt[i * c:(i + 1) * c],
                                             None, None, True, g, state=state))
    grads = tuple({k: sum(p[1][i][k] for p in parts) / blocks for k in lp}
                  for i, lp in enumerate(parts[0][1]))
    net._dropout_gen.set_state(g.get_state())
    net._apply_step(sum(p[0] for p in parts) / blocks, grads, parts[0][2])


def decisions(torch, net, params, x, blocks):
    """{layer index: bool tensor} of the decisions a forward of `net` at
    `params` takes on the rows `x`, run in `blocks` row blocks as a sharded
    step runs them: each ReLU layer's (activation > 0) and each max-pool
    layer's argmax in every window. The forward has no dropout, so from
    the first dropout on (AlexNet's dense layers) its decisions are not
    the training forward's."""
    import torch.nn.functional as F

    from deeplearning4j_torch.nn.layers.convolution import (ConvolutionLayer, ConvolutionMode,
                                                            PoolingType, SubsamplingLayer,
                                                            _pair, _same_pads)
    from deeplearning4j_torch.nn.layers.core import DenseLayer
    out = {}
    with torch.inference_mode():
        per_block = []
        for xb in torch.chunk(net._as_input(x), blocks):
            _, _, acts = net._forward(params, net.state_tree, xb)
            per_block.append([xb] + acts)
        for i, layer in enumerate(net.layers):
            if isinstance(layer, (ConvolutionLayer, DenseLayer)) and \
                    layer.activation == "relu":
                out[i] = torch.cat([a[i + 1] > 0 for a in per_block])
            elif isinstance(layer, SubsamplingLayer) and \
                    layer.pooling_type == PoolingType.MAX:
                win, st = _pair(layer.kernel_size), _pair(layer.stride)
                idx = []
                for a in per_block:
                    v = a[i].permute(0, 3, 1, 2)
                    if layer._mode() == ConvolutionMode.SAME:
                        (t, b), (l, r) = (_same_pads(v.shape[2], win[0], st[0]),
                                          _same_pads(v.shape[3], win[1], st[1]))
                    else:
                        (t, b), (l, r) = [(q, q) for q in _pair(layer.padding)]
                    v = F.pad(v, (l, r, t, b), value=float("-inf"))
                    idx.append(F.max_pool2d(v, win, st, return_indices=True)[1])
                out[i] = torch.cat(idx)
    return out


def decision_flips(torch, a, b):
    """{"relu": [flipped, of], "max_pool": [flipped, of]} between two
    `decisions` of one batch."""
    out = {"relu": [0, 0], "max_pool": [0, 0]}
    for i in a:
        kind = "relu" if a[i].dtype == torch.bool else "max_pool"
        out[kind][0] += int((a[i] != b[i]).sum())
        out[kind][1] += a[i].numel()
    return out


def fenced_step_ms(torch, dev, step, ds, n):
    """The median wall ms of `n` warm steps, each fenced by a sync."""
    step(ds)
    times = []
    for _ in range(n):
        _sync(torch, dev)
        t = time.perf_counter()
        step(ds)
        _sync(torch, dev)
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def wrapper_launches(k1, k2):
    return dict(gateway_launches(want_lrn=k1), lrn_bwd=k2)


def phase_parallel_wrapper(torch, card, device=None, size=None):
    """`ParallelWrapper` (parallel/wrapper.py) with zoo AlexNet in float32
    at a global batch of 128 over 2 data shards on the one card
    (`data_parallel_mesh(devices=[card, card])`), cuDNN deterministic:

    1. Sync mode, `sync_steps` steps through `fit` (batches prefetched onto
       the card and cut there into the shards) against a plain `fit` of the
       same batches at 128: every leaf's update within UPDATE_REL_STEP after
       the first step and within UPDATE_REL_FIT after the last; K1 and K2
       each launch 2 LRN layers x 2 shards x steps. Beside it, a control
       that changes only the rounding (`split_step`: plain steps whose
       gradient is the mean of the two row blocks'), held to the plain fit
       the same way step by step; and at every step, the ReLU and max-pool
       decisions of the sharded and of the control's forward (in row
       blocks, at that step's parameters) that differ from the plain
       forward's.
    2. Local SGD (averaging every `local_freq` steps, `local_steps` steps):
       held to two networks, each with its own `fit` on its 64 rows,
       averaged every `local_freq` steps (rtol 1e-5); K1 and K2 each 2 x 2 x
       steps.
    3. Step ms of the sharded step against the plain step, warm, the median
       of `timed_steps`."""
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.models.zoo import AlexNet
    from deeplearning4j_torch.parallel import ParallelWrapper, data_parallel_mesh
    from deeplearning4j_torch.utils import params as param_utils
    s = dict(WRAPPER_FULL, **(size or {}))
    dev = device or "cuda"
    shape, classes = s["alexnet"]
    rng = np.random.default_rng(2201)
    mesh = data_parallel_mesh(devices=[dev] * s["shards"])
    make = lambda: AlexNet(input_shape=shape, num_labels=classes).init(device=dev)
    lrn = lrn_layers_of(make())
    result = {"card": card, "shards": s["shards"], "batch": s["batch"]}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # 1. sync
        x, y = alexnet_batches(rng, s["sync_steps"], s["batch"], shape, classes)
        dp, plain, split = make(), make(), make()
        snaps = {k: Snapshots(param_utils, n) for k, n in
                 (("sharded", dp), ("plain", plain), ("control", split))}
        dp.set_listeners(snaps["sharded"])
        plain.set_listeners(snaps["plain"])
        pw = ParallelWrapper(dp, mesh=mesh)
        _sync(torch, dev)
        zero_launches()   # the main path's run starts here
        pw.fit(x, y, epochs=1, batch_size=s["batch"])
        launches = all_launches()   # ... and ends here
        want = s["shards"] * lrn * s["sync_steps"]
        check_launches("wrapper sync", launches, wrapper_launches(want, want))
        plain.fit(x, y, epochs=1, batch_size=s["batch"])
        b = s["batch"]
        for k in range(s["sync_steps"]):
            split_step(torch, split, x[k * b:(k + 1) * b], y[k * b:(k + 1) * b], s["shards"])
            snaps["control"].iteration_done(split, split.iteration)
        if dp.iteration != plain.iteration or dp.iteration != s["sync_steps"]:
            raise RuntimeError(f"wrapper: {dp.iteration} sharded, {plain.iteration} "
                               "plain steps")
        trees = {k: v.trees for k, v in snaps.items()}
        init = trees["plain"][0]
        by_step = {run: [max(update_rel_errs(param_utils, init, trees[run][k],
                                             trees["plain"][k]))
                         for k in range(1, s["sync_steps"] + 1)]
                   for run in ("sharded", "control")}
        flips = {"sharded": [], "control": []}
        for k in range(s["sync_steps"]):
            xk = x[k * b:(k + 1) * b]
            want_d = decisions(torch, plain, trees["plain"][k], xk, 1)
            for run in flips:
                flips[run].append(decision_flips(torch, decisions(
                    torch, plain, trees[run][k], xk, s["shards"]), want_d))
        del trees, snaps
        errs1, errs = by_step["sharded"][0], by_step["sharded"][-1]
        result["sync"] = {"steps": dp.iteration, "launches": launches,
                          "max_update_rel_err_step1": errs1,
                          "max_update_rel_err": errs,
                          "update_rel_err_by_step": by_step["sharded"],
                          "control_update_rel_err_by_step": by_step["control"],
                          "decision_flips_by_step": flips["sharded"],
                          "control_decision_flips_by_step": flips["control"],
                          "score": float(dp.score_value),
                          "plain_score": float(plain.score_value)}
        log(f"wrapper: sync {json.dumps(result['sync'])}  [{card}]")
        if errs1 > UPDATE_REL_STEP or errs > UPDATE_REL_FIT:
            raise RuntimeError(f"wrapper sync: a leaf's update differs from the plain "
                               f"fit's by {errs1:.3g} of its norm after the "
                               f"first step, {errs:.3g} after the last")
        del split

        # 3. step times (the warm networks of 1.)
        ds = DataSet(x[:s["batch"]], y[:s["batch"]])
        result["step_ms"] = {"sharded": fenced_step_ms(torch, dev, pw.fit_batch, ds,
                                                       s["timed_steps"]),
                             "plain": fenced_step_ms(torch, dev, plain._fit_batch, ds,
                                                     s["timed_steps"])}
        del dp, plain, pw

        # 2. local SGD
        F, steps = s["local_freq"], s["local_steps"]
        xl, yl = alexnet_batches(rng, s["local_batches"], s["batch"], shape, classes)
        order = [i % s["local_batches"] for i in range(steps)]
        xs = np.concatenate([xl[i * s["batch"]:(i + 1) * s["batch"]] for i in order])
        ys = np.concatenate([yl[i * s["batch"]:(i + 1) * s["batch"]] for i in order])
        local = make()
        lw = ParallelWrapper(local, mesh=mesh, averaging_frequency=F)
        _sync(torch, dev)
        zero_launches()
        lw.fit(xs, ys, epochs=1, batch_size=s["batch"])
        launches = all_launches()
        want = s["shards"] * lrn * steps
        check_launches("wrapper local SGD", launches, wrapper_launches(want, want))
        reps = [make() for _ in range(s["shards"])]
        c = s["batch"] // s["shards"]
        for r in range(steps):
            b = order[r] * s["batch"]
            for w, net in enumerate(reps):
                net.fit(xl[b + w * c:b + (w + 1) * c], yl[b + w * c:b + (w + 1) * c],
                        epochs=1, batch_size=c, use_async=False)
            if (r + 1) % F == 0:
                with torch.no_grad():
                    for key in ("params_tree", "opt_state"):
                        leaves = [param_utils.tree_leaves(getattr(n, key)) for n in reps]
                        avg = [torch.empty_like(ts[0]).copy_(torch.stack(ts).mean(0))
                               for ts in zip(*leaves)]
                        for n in reps:
                            setattr(n, key, param_utils.tree_unflatten(
                                getattr(n, key), [a.clone() for a in avg]))
        got = param_utils.tree_leaves(local.params_tree)
        want_leaves = param_utils.tree_leaves(reps[0].params_tree)
        max_err = max(float((a - b).abs().max()) for a, b in zip(got, want_leaves))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, want_leaves))
        for a, b in zip(got, want_leaves):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5,
                                       atol=1e-6)
        result["local_sgd"] = {"steps": local.iteration, "averaging_frequency": F,
                               "launches": launches, "max_abs_err": max_err,
                               "bitwise": bitwise}
        log(f"wrapper: local SGD {json.dumps(result['local_sgd'])}; step ms "
            f"{json.dumps(result['step_ms'])}  [{card}]")
        return result
    finally:
        torch.backends.cudnn.deterministic = prev


PS_FULL = dict(alexnet=((224, 224, 3), 1000), batch=64, seq_steps=3, async_batches=2,
               async_epochs=4, workers=2, staleness=(1, 0), lenet=((28, 28, 1), 10),
               lenet_batch=32)


def phase_param_server(torch, card, device=None, size=None):
    """The parameter server (parallel/param_server.py) with zoo AlexNet in
    float32, the server and its worker threads on the one card, cuDNN
    deterministic:

    1. One worker at max_staleness=0: the parameters equal the sequential
       `fit` of the same batches (rtol 1e-5; bitwise reported); K1 and K2
       each 2 x steps.
    2. `workers` worker threads over `async_batches` batches for
       `async_epochs` epochs, once at each max_staleness of `staleness`:
       the applied and dropped pushes (every batch applied once, each
       dropped push redone), the loss of the first and last applied pushes
       (falling), and pull / gradient / push ms. Two workers at
       max_staleness=1 can drop a push only when the other pushes twice
       during one gradient; at 0 each push the other overtook drops.
    3. The HTTP node and client at LeNet size: a pull equals the server's
       parameters bitwise, a fresh push applies and a stale one drops, and
       `remote_worker_fit` pushes one epoch; round-trip ms."""
    from deeplearning4j_torch.models.zoo import AlexNet, LeNet
    from deeplearning4j_torch.parallel import param_server as ps
    from deeplearning4j_torch.utils import params as param_utils
    s = dict(PS_FULL, **(size or {}))
    dev = device or "cuda"
    shape, classes = s["alexnet"]
    rng = np.random.default_rng(2211)
    make = lambda: AlexNet(input_shape=shape, num_labels=classes).init(device=dev)
    result = {"card": card}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        x, y = alexnet_batches(rng, s["seq_steps"], s["batch"], shape, classes)
        seq, net = make(), make()
        lrn = lrn_layers_of(seq)
        seq.fit(x, y, epochs=1, batch_size=s["batch"], use_async=False)
        _sync(torch, dev)
        zero_launches()
        tr = ps.ParameterServerTrainer(net, workers=1, max_staleness=0)
        tr.fit(x, y, epochs=1, batch_size=s["batch"])
        launches = all_launches()
        want = lrn * s["seq_steps"]
        check_launches("param server, one worker", launches, wrapper_launches(want, want))
        got, ref = (param_utils.tree_leaves(n.params_tree) for n in (net, seq))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5, atol=1e-6)
        result["one_worker"] = {
            "applied": tr.server.applied, "launches": launches,
            "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
            "bitwise": all(torch.equal(a, b) for a, b in zip(got, ref))}
        del seq, net, tr

        # 2. racing workers
        xa, ya = alexnet_batches(rng, s["async_batches"], s["batch"], shape, classes)
        result["workers"] = {}
        for stale in s["staleness"]:
            net = make()
            _sync(torch, dev)
            zero_launches()
            tr = ps.ParameterServerTrainer(net, workers=s["workers"], max_staleness=stale)
            tr.fit(xa, ya, epochs=s["async_epochs"], batch_size=s["batch"])
            launches = all_launches()
            st = tr.server.stats()
            computed = st["applied"] + st["stale_drops"]
            check_launches(f"param server, racing workers at staleness {stale}", launches,
                           wrapper_launches(lrn * computed, lrn * computed))
            if st["applied"] != s["async_batches"] * s["async_epochs"] or \
                    net.iteration != st["applied"]:
                raise RuntimeError(f"param server: {st} for {net.iteration} iterations")
            if not tr.losses[-1] < tr.losses[0]:
                raise RuntimeError(f"param server: the loss did not fall: {tr.losses}")
            t = np.asarray(tr.timings)
            result["workers"][str(stale)] = {
                **st, "launches": launches, "first_loss": tr.losses[0],
                "last_loss": tr.losses[-1], "pull_ms_p50": float(np.median(t[:, 0])),
                "grad_ms_p50": float(np.median(t[:, 1])),
                "push_ms_p50": float(np.median(t[:, 2]))}
            del net, tr

        # 3. HTTP at LeNet size
        (lshape, lclasses) = s["lenet"]
        lenet = LeNet(input_shape=lshape, num_labels=lclasses).init(device=dev)
        server = ps.ParameterServer(lenet, max_staleness=0)
        node = ps.ParameterServerHttpNode(server).start()
        try:
            client = ps.HttpParameterServerClient(node.url, lenet.params_tree)
            t0 = time.perf_counter()
            v0, pulled = client.pull()
            pull_ms = (time.perf_counter() - t0) * 1e3
            if v0 != 0 or not all(torch.equal(a, b) for a, b in zip(
                    param_utils.tree_leaves(pulled), param_utils.tree_leaves(server.params))):
                raise RuntimeError("param server: the HTTP pull is not the server's tree")
            zero = param_utils.tree_map(torch.zeros_like, lenet.params_tree)
            t0 = time.perf_counter()
            fresh = client.push(0, zero)
            push_ms = (time.perf_counter() - t0) * 1e3
            stale = client.push(0, zero)
            if not fresh or stale or client.stats() != {"version": 1, "applied": 1,
                                                        "stale_drops": 1}:
                raise RuntimeError(f"param server: HTTP pushes {fresh}, {stale}, "
                                   f"{client.stats()}")
            xl, yl = alexnet_batches(rng, 2, s["lenet_batch"], lshape, lclasses)
            worker = LeNet(input_shape=lshape, num_labels=lclasses).init(device=dev)
            applied = ps.remote_worker_fit(worker, node.url, xl, yl, epochs=1,
                                           batch_size=s["lenet_batch"])
            if applied != 2 or server.version != 3:
                raise RuntimeError(f"param server: remote worker applied {applied}, "
                                   f"server at {server.version}")
        finally:
            node.stop()
        result["http"] = {"params": param_utils.num_params(lenet.params_tree),
                          "pull_ms": pull_ms, "push_ms": push_ms,
                          "remote_applied": applied}
        log(f"param server: one worker {json.dumps(result['one_worker'])}; "
            f"{s['workers']} workers by max_staleness {json.dumps(result['workers'])}; HTTP "
            f"{json.dumps(result['http'])}  [{card}]")
        return result
    finally:
        torch.backends.cudnn.deterministic = prev


MULTIHOST_FULL = dict(conf=None, rank_batch=64, steps=3, health_timeout_s=5.0,
                      health_interval_s=0.2, exit_slack_s=15.0, grace_delay_ms=500,
                      device=None)   # conf None: zoo AlexNet's; device None: cuda:0
MULTIHOST_RUN_S = 600   # one two-rank run


def run_ranks(args, coord_port, env=None, expect=(0, 0), on_line=None):
    """Two ranks of `multihost.main` over gloo: (outputs, exit codes, wall s).
    `on_line(rank, line, procs)` sees each output line as it comes."""
    from deeplearning4j_torch.parallel.multihost import spawn_rank
    child_env = {"PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
                 **(env or {})}
    t0 = time.perf_counter()
    procs = [spawn_rank(r, 2, f"127.0.0.1:{coord_port}", args, env=child_env,
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [[], []]
    ends = [None, None]

    def reader(r):
        for line in procs[r].stdout:
            outs[r].append(line)
            if on_line is not None:
                on_line(r, line, procs)
        procs[r].wait()
        ends[r] = time.perf_counter()

    threads = [threading.Thread(target=reader, args=(r,), daemon=True) for r in range(2)]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join(timeout=MULTIHOST_RUN_S)
    finally:
        stop_processes([p for p in procs if p.poll() is None], timeout=5)
    rcs = tuple(p.returncode for p in procs)
    texts = ["".join(o) for o in outs]
    if rcs != tuple(expect):
        raise RuntimeError(f"multihost: ranks exited {rcs}, expected {expect}:\n"
                           + "\n".join(t[-3000:] for t in texts))
    return texts, ends, time.perf_counter() - t0


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_params(prefix, rank, freq=1):
    with np.load(f"{prefix}.f{freq}.rank{rank}.npz") as z:
        return [z[k] for k in sorted(z.files)]


def phase_multihost(torch, card, device=None, size=None):
    """The multi-process runner (parallel/multihost.py): two ranks spawned
    from the package's worker entry (`multihost.main`), both on the one card
    and so over gloo (NCCL refuses two ranks on one device), zoo AlexNet at
    64 a rank (a global batch of 128) on seeded images:

    1. `steps` sync steps: the ranks agree bitwise; every leaf's update
       within UPDATE_REL_FIT of a single-process `fit` of the global batches
       at 128 on the card; the chief's step checkpoint restores to rank 0's
       parameters bitwise; the all-reduce ms of each step; K1 and K2 2 x
       steps in each rank.
    2. Chaos: rank 1 SIGKILLs itself after step 1 with the health plane on;
       rank 0 leaves with PeerLostError and exit code 17 within the beat
       timeout plus `exit_slack_s` of rank 1's death.
    3. Grace: SIGTERM to rank 0 after its first step (the steps slowed by a
       step.stall delay): one grace checkpoint at an agreed step, both ranks
       exit 0; the resumed run ends where the uninterrupted run of 1.
       ended (rtol 1e-6)."""
    import signal
    import tempfile

    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.models.zoo import AlexNet
    from deeplearning4j_torch.nn.conf.builders import MultiLayerConfiguration
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.parallel.multihost import (StepCheckpointManager,
                                                         _synthetic)
    from deeplearning4j_torch.utils import params as param_utils
    s = dict(MULTIHOST_FULL, **(size or {}))
    dev = device or "cuda:0"
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_multihost_")
    result = {"card": card}
    try:
        conf_path = os.path.join(tmp.name, "conf.json")
        conf_json = s["conf"] or AlexNet().conf().to_json()
        with open(conf_path, "w") as f:
            f.write(conf_json)
        rows = 2 * s["rank_batch"] * s["steps"]
        base = ["--conf", conf_path, "--rows", str(rows), "--epochs", "1",
                "--batch-size", str(s["rank_batch"]), "--device", s["device"] or dev,
                "--backend", "gloo", "--exact-float32"]
        prefix = os.path.join(tmp.name, "run")
        ck = os.path.join(tmp.name, "ckpt")

        # 1. the sync run
        outs, _, wall = run_ranks(base + ["--out", prefix, "--checkpoint-dir", ck,
                                          "--checkpoint-every", str(s["steps"])],
                                  free_port())
        r0, r1 = rank_params(prefix, 0), rank_params(prefix, 1)
        if not all(np.array_equal(a, b) for a, b in zip(r0, r1)):
            raise RuntimeError("multihost: the ranks disagree")
        with open(f"{prefix}.f1.rank0.json") as f:
            stats = json.load(f)
        lrn = stats["launches"]
        conf = MultiLayerConfiguration.from_json(conf_json)
        # a rank on the CPU runs the plain versions, which count nothing
        per = lrn_layers_of(MultiLayerNetwork(conf)) * s["steps"] \
            if torch.device(s["device"] or dev).type == "cuda" else 0
        if lrn != {"lrn_fwd": per, "lrn_bwd": per}:
            raise RuntimeError(f"multihost: rank 0 launched {lrn}")
        x, y = _synthetic(conf, rows, 0)
        half, b = rows // 2, s["rank_batch"]
        single = MultiLayerNetwork(conf).init(device=dev)
        init = param_utils.tree_copy(single.params_tree)
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True   # as the ranks run
        try:
            for k in range(s["steps"]):
                sl = slice(k * b, (k + 1) * b)
                single._fit_batch(DataSet(np.concatenate([x[:half][sl], x[half:][sl]]),
                                          np.concatenate([y[:half][sl], y[half:][sl]])))
        finally:
            torch.backends.cudnn.deterministic = prev
        got = [torch.from_numpy(a) for a in r0]
        want = [torch.from_numpy(param_utils.leaf_to_reference_bits(t)[0])
                for t in param_utils.tree_leaves(single.params_tree)]
        start = [torch.from_numpy(param_utils.leaf_to_reference_bits(t)[0])
                 for t in param_utils.tree_leaves(init)]
        errs = update_rel_errs(param_utils, start, got, want)
        if max(errs) > UPDATE_REL_FIT:
            raise RuntimeError(f"multihost: a leaf's update differs from the "
                               f"single-process fit's by {max(errs):.3g} of its norm")
        restored = MultiLayerNetwork(conf).init(device=dev)
        if StepCheckpointManager(ck).restore_into(restored) != s["steps"]:
            raise RuntimeError("multihost: the chief's checkpoint did not restore")
        back = [param_utils.leaf_to_reference_bits(t)[0]
                for t in param_utils.tree_leaves(restored.params_tree)]
        if not all(np.array_equal(a, b) for a, b in zip(back, r0)):
            raise RuntimeError("multihost: the restored checkpoint is not rank 0's tree")
        result["sync"] = {"steps": stats["iteration"], "backend": stats["backend"],
                          "device": stats["device"], "launches_rank0": lrn,
                          "max_update_rel_err": max(errs),
                          "allreduce_ms": stats["allreduce_ms"],
                          "step_ms": stats["step_ms"], "wall_s": wall}
        log(f"multihost: sync {json.dumps(result['sync'])}  [{card}]")

        # 2. chaos: kill rank 1
        health = {"DL4JTPU_HEARTBEAT_TIMEOUT_S": str(s["health_timeout_s"]),
                  "DL4JTPU_HEARTBEAT_INTERVAL_S": str(s["health_interval_s"])}
        outs, ends, wall = run_ranks(base + ["--health", "--crash-at", "1"], free_port(),
                                     env=health, expect=(17, -9))
        gap = ends[0] - ends[1]
        if "PeerLostError" not in outs[0] or gap > s["health_timeout_s"] + s["exit_slack_s"]:
            raise RuntimeError(f"multihost: rank 0 left {gap:.1f} s after rank 1 died:\n"
                               + outs[0][-2000:])
        result["kill"] = {"rank0_exit": 17, "exit_after_death_s": gap,
                          "timeout_s": s["health_timeout_s"]}

        # 3. grace: SIGTERM to rank 0, then resume
        gk = os.path.join(tmp.name, "grace")
        sent = []

        def on_line(rank, line, procs):
            if rank == 0 and line.startswith("STEP 0 1") and not sent:
                procs[0].send_signal(signal.SIGTERM)
                sent.append(time.perf_counter())

        outs, _, _ = run_ranks(base + ["--health", "--checkpoint-dir", gk],
                               free_port(), on_line=on_line, env={
                                   **health, "DL4JTPU_FAULT_STEP_STALL":
                                   f"delay:*@{s['grace_delay_ms']}"})
        zips = [f for f in os.listdir(gk) if f.endswith(".zip")]
        if not sent or len(zips) != 1 or any("DONE" in o for o in outs):
            raise RuntimeError(f"multihost: grace wrote {zips} (SIGTERM sent: "
                               f"{bool(sent)})")
        grace_step = int(re.match(r"checkpoint_step(\d+)\.zip", zips[0]).group(1))
        rprefix = os.path.join(tmp.name, "resumed")
        run_ranks(base + ["--checkpoint-dir", gk, "--out", rprefix], free_port())
        for a, b in zip(rank_params(rprefix, 0), r0):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        result["grace"] = {"checkpoint_step": grace_step, "exits": [0, 0],
                           "resumed_max_abs_err": max(
                               float(np.abs(a - b).max())
                               for a, b in zip(rank_params(rprefix, 0), r0))}
        log(f"multihost: kill {json.dumps(result['kill'])}; grace "
            f"{json.dumps(result['grace'])}  [{card}]")
        return result
    finally:
        tmp.cleanup()


# ------------------------------------- tensor, sequence and pipeline parallelism

RING_FULL = dict(b=CHAR_BATCH, t=CHAR_T, h=CHAR_HEADS, d=CHAR_WIDTH // CHAR_HEADS,
                 shards=2)
SP_FULL = dict(t=CHAR_T, batch=CHAR_BATCH, seq=2, bf16_steps=3, threed_t=2048,
               width=CHAR_WIDTH, heads=CHAR_HEADS, vocab=CHAR_VOCAB)
TP_FULL = dict(alexnet=((224, 224, 3), 1000), batch=128, model=2, timed_steps=3)
PIPE_FULL = dict(width=4096, body=8, classes=1000, stages=4, microbatches=8,
                 batch=256, timed_steps=3)
MH_TP_SP_FULL = dict(device=None)   # device None: cuda:0


def ring_hops(n):
    """Every (my, src) pair of an n-shard ring, in hop order per shard."""
    return [(my, (my - s) % n) for my in range(n) for s in range(n)]


def phase_ring_kernels(torch, card, flash_rows=None, device=None, size=None):
    """K3-K5 on the operands the sequence-parallel ring gives them: the char
    model's per-hop geometry (t_loc = t / shards query and key rows, 4 heads
    of 128, batch 4, causal) at every (my, src) of a 2-shard ring, the
    positions my * t_loc + i and src * t_loc + j, in float32 and bfloat16:
    (o, lse) and, with a random non-zero lse cotangent, (dq, dk, dv) against
    the plain versions within FLASH_REL of max|plain|. The hop the causal
    mask hides whole (src > my) must give o = 0 and lse = NEG exactly and
    zero gradients. Each kernel's ms a hop beside its ms at the plain char
    model's shape (`flash_rows`, phase_flash's)."""
    from deeplearning4j_torch.ops import flash_attention as fa
    s = dict(RING_FULL, **(size or {}))
    dev = device or "cuda"
    b, h, d, n = s["b"], s["h"], s["d"], s["shards"]
    tl = s["t"] // n
    gen = torch.Generator(device=dev).manual_seed(19)
    rows = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        mk = lambda *shape: torch.randn(*shape, device=dev, generator=gen).to(dt)
        q, k, v, do = mk(b, tl, h, d), mk(b, tl, h, d), mk(b, tl, h, d), mk(b, tl, h, d)
        gl = torch.randn(b, tl, h, device=dev, generator=gen)
        scale = d ** -0.5
        for my, src in ring_hops(n):
            qp = my * tl + torch.arange(tl, device=dev, dtype=torch.int32)
            kp = src * tl + torch.arange(tl, device=dev, dtype=torch.int32)
            fwd = (q, k, v, None, None, None, qp, kp, scale, True)
            o, lse = fa._launch_fwd(*fwd)
            ow, lw = fa.flash_fwd_reference(*fwd)
            di = (ow.float() * do.float()).sum(-1)
            args = (q, k, v, do, lw, di, gl, None, None, None, qp, kp, scale, True)
            dk, dv = fa._launch_bwd_dkv(*args)
            dq = fa._launch_bwd_dq(*args)
            _sync(torch, dev)
            dkw, dvw = fa.flash_bwd_dkv_reference(*args)
            dqw = fa.flash_bwd_dq_reference(*args)
            row = {"dtype": dtype, "my": my, "src": src, "t_loc": tl,
                   "masked_whole": src > my}
            if src > my:
                zero = all(bool((t == 0).all()) for t in (o, dq, dk, dv))
                if not zero or not bool((lse == fa.NEG).all()):
                    raise RuntimeError(f"ring hop {dtype} ({my}, {src}): the hop the "
                                       "causal mask hides whole is not exactly 0 / NEG")
                row["exact_zero"] = True
            else:
                live = lw > fa.NEG / 2
                torch.testing.assert_close(lse[live], lw[live], **LSE_TOL)
                for what, (got, want) in {"flash_fwd": (o, ow), "flash_bwd_dkv_dk": (dk, dkw),
                                          "flash_bwd_dkv_dv": (dv, dvw),
                                          "flash_bwd_dq": (dq, dqw)}.items():
                    rel = _rel_err(got, want)
                    if not rel <= FLASH_REL[dtype] or not torch.isfinite(got).all():
                        raise RuntimeError(f"ring hop {what} {dtype} ({my}, {src}): "
                                           f"error {rel} of max|plain|")
                    row[f"{what}_rel_err"] = rel
            if dev != "cpu" and torch.device(dev).type == "cuda":
                pairs = attention_pairs(torch, qp, kp, True, b, h)
                t_ = lambda fn: cuda_time_ms(fn, iters=5, warm=1)
                for name, fn, nb in (
                        ("flash_fwd", lambda: fa._launch_fwd(*fwd),
                         _nbytes(q, k, v, qp, kp, o, lse)),
                        ("flash_bwd_dkv", lambda: fa._launch_bwd_dkv(*args),
                         _nbytes(q, k, v, do, lw, di, gl, qp, kp, dk, dv)),
                        ("flash_bwd_dq", lambda: fa._launch_bwd_dq(*args),
                         _nbytes(q, k, v, do, lw, di, gl, qp, kp, dq))):
                    bound, by = attention_bound_ms(name, pairs, d, dtype, nb)
                    plain = (flash_rows or {}).get(
                        "model_f32" if dtype == "float32" else "model_bf16", {})
                    row[name] = {"ms": t_(fn), "bound_ms": bound, "bound_by": by,
                                 "pairs": pairs,
                                 "char_model_shape_ms": plain.get(name, {}).get("ms")}
            rows.append(row)
            log(f"ring kernels: {json.dumps(row)}  [{card}]")
            del o, lse, ow, lw, dk, dv, dq, dkw, dvw, dqw, args
        del q, k, v, do, gl
    return {"card": card, "hops": rows}


def sp_conf(s, layers=2):
    """The char model's network (char_conf) at `s`'s width and depth."""
    from deeplearning4j_torch import (InputType, NeuralNetConfiguration,
                                      RnnOutputLayer, SelfAttentionLayer, Sgd)
    b = NeuralNetConfiguration.builder().seed(0).updater(Sgd(CHAR_LR)).list()
    for _ in range(layers):
        b = b.layer(SelfAttentionLayer(n_out=s["width"], n_heads=s["heads"],
                                       causal=True, activation="relu"))
    return (b.layer(RnnOutputLayer(n_out=s["vocab"], activation="softmax",
                                   loss="mcxent"))
            .set_input_type(InputType.recurrent(s["vocab"])).build())


def sp_data(s, rows, t, seed):
    """char_data at `s`'s vocabulary."""
    from deeplearning4j_torch.data.dataset import DataSet
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, s["vocab"], (rows, t))
    eye = np.eye(s["vocab"], dtype=np.float32)
    return DataSet(eye[idx], eye[np.roll(idx, -1, 1)], None,
                   np.ones((rows, t), np.float32))


def ring_launches(layers, shards, steps, backward=True):
    """K3, K4 and K5 launches `steps` ring steps make: every shard runs a
    hop of each kernel per shard of the ring, per attention layer."""
    n = layers * shards * shards * steps
    return {"flash_fwd": n, "flash_bwd_dkv": n if backward else 0,
            "flash_bwd_dq": n if backward else 0}


UPDATE_ULPS = 2.0   # a sub-rounding update: each entry within this many roundings


def rel_errs_set_aside(param_utils, init, got, want):
    """({"layer.param": `update_rel_errs`} of the parameters whose plain
    update is resolvable, {"layer.param": share of its layer's update} of
    those set aside, {"layer.param": roundings} of those held entry by
    entry). Set aside: an update below NEGLIGIBLE_GRAD of its layer's, 0
    but for rounding (the key biases: a shift of every key's score leaves
    the softmax as it is). Held entry by entry: an update below one
    rounding of the parameter (norm under eps |p|, the queries' and keys'
    weights at the char model's init), which moves an entry by a rounding
    or not at all; each entry must land within UPDATE_ULPS roundings
    (eps |p|) of the plain step's."""
    import torch
    errs, aside, ulps = {}, {}, {}
    items = lambda t: t.items() if isinstance(t, dict) else enumerate(t)
    for (k, li), lg, lw in zip(items(init), (v for _, v in items(got)),
                               (v for _, v in items(want))):
        norms = {n: (lw[n].double() - li[n].double()).norm().item() for n in li}
        layer = float(np.sqrt(sum(v * v for v in norms.values())))
        for n in li:
            name = f"{k}.{n}"
            w, g = lw[n].double(), lg[n].double()
            eps = torch.finfo(lw[n].dtype).eps
            if norms[n] < NEGLIGIBLE_GRAD * layer:
                aside[name] = norms[n] / max(layer, 1e-300)
            elif norms[n] < eps * w.norm().item():
                ulps[name] = ((g - w).abs() / (eps * w.abs()).clamp(min=1e-30)
                              ).max().item()
            else:
                errs[name] = update_rel_errs(param_utils, [li[n]], [lg[n]],
                                             [lw[n]])[0]
    return errs, aside, ulps


def check_one_step(label, errs, ulps):
    """Raise unless every resolvable update is within UPDATE_REL_STEP and
    every sub-rounding one within UPDATE_ULPS roundings."""
    worst = max(errs, key=errs.get)
    if errs[worst] > UPDATE_REL_STEP or any(u > UPDATE_ULPS for u in ulps.values()):
        raise RuntimeError(f"{label}: a leaf's update differs from the plain step's by "
                           f"{errs[worst]:.3g} of its norm ({worst}); sub-rounding "
                           f"updates {json.dumps(ulps)} roundings")


@contextmanager
def pinned_relus_by_block(torch, net, record, flips=None, pin=True):
    """`pinned_kinks`' ReLU rule across a sequence-parallel step: the plain
    run (`flips` None) records each ReLU's decisions over the whole batch,
    in call order; another run counts in `flips` the decisions its own
    values take otherwise (each shard of a sharded step in its (rows, time)
    block of each recorded decision, in its own call order), and with
    `pin` runs the ReLU as z * the recorded mask. Float32 attention through
    the ring rounds apart from one kernel call over the whole sequence by
    about 1e-6, which tips a few of the 3.4e7 ReLU decisions near zero,
    and a tipped decision moves the gradients of the weights below it by
    far more than the rounding (PERF.md §6): a comparison on the
    same decisions measures the step, one on its own decisions the tips."""
    import torch.nn.functional as F
    from deeplearning4j_torch.nn import shards
    calls = threading.local()

    def act(z):
        if flips is None:
            record.append((z > 0).detach())
            return F.relu(z)
        ctx = shards.current()
        k = getattr(calls, "k", 0)
        calls.k = k + 1
        m = record[k]
        if ctx is not None:
            m = m[ctx.start:ctx.start + z.shape[0]]
            if ctx.t_len and ctx.t_len < ctx.t_total and z.shape[1] == ctx.t_len:
                m = m[:, ctx.t_start:ctx.t_start + ctx.t_len]
        m = m.to(z.device)
        flips.append(int(((z > 0) != m).sum()))
        return z * m.to(z.dtype) if pin else F.relu(z)

    with ExitStack() as stack:
        for layer in net_layers(net):
            if (layer.activation or "").lower() == "relu":
                stack.enter_context(patched(layer, "_act", lambda: act))
        yield


def step_grads(torch, make, step, record=None, flips=None, pin=True):
    """(the gradient tree one `step(net)` of a fresh `make()` network
    applies, detached and whole: a leaf held in blocks gathered; the
    network). With `record`, the step's ReLUs run under
    `pinned_relus_by_block(record, flips, pin)`."""
    from deeplearning4j_torch.parallel.mesh import gather_replicated
    from deeplearning4j_torch.utils import params as param_utils
    net, got = make(), []
    apply_step = net._apply_step

    def capture(loss, grads, new_state):
        got.append(param_utils.tree_map(lambda t: t.detach().clone(),
                                        gather_replicated(grads)))
        return apply_step(loss, grads, new_state)

    with ExitStack() as stack:
        stack.enter_context(patched(net, "_apply_step", capture))
        if record is not None:
            stack.enter_context(pinned_relus_by_block(torch, net, record, flips, pin))
        step(net)
    return got[0], net


def grad_rel_errs(got, want):
    """({"layer.param": |got - want| / |want|} of every leaf whose plain
    gradient is resolvable, {"layer.param": share of its layer's gradient
    norm} of those set aside: below NEGLIGIBLE_GRAD of their layer's, 0 but
    for rounding (the key biases: a shift of every key's score leaves the
    softmax as it is))."""
    errs, aside = {}, {}
    items = lambda t: t.items() if isinstance(t, dict) else enumerate(t)
    for (k, lw), (_, lg) in zip(items(want), items(got)):
        norms = {n: lw[n].double().norm().item() for n in lw}
        layer = float(np.sqrt(sum(v * v for v in norms.values())))
        for n in lw:
            if norms[n] < NEGLIGIBLE_GRAD * layer:
                aside[f"{k}.{n}"] = norms[n] / max(layer, 1e-300)
            else:
                errs[f"{k}.{n}"] = (lg[n].double() - lw[n].double()).norm().item() \
                    / norms[n]
    return errs, aside


def one_step_rel(torch, param_utils, make, step_plain, step_sharded, tree_of=None):
    """(per-leaf update errors, the parameters set aside, the sub-rounding
    ones' roundings, plain net, sharded net) of one step of each from the
    same initial parameters (`rel_errs_set_aside`)."""
    plain, sharded = make(), make()
    init = param_utils.tree_copy(plain.params_tree)
    step_plain(plain)
    step_sharded(sharded)
    got = (tree_of or (lambda n: n.params_tree))(sharded)
    errs, aside, ulps = rel_errs_set_aside(param_utils, init, got, plain.params_tree)
    return errs, aside, ulps, plain, sharded


def phase_sequence_parallel(torch, card, char=None, device=None, size=None):
    """`SequenceParallelWrapper` on the char model of bench.py
    `bench_attention_longctx` at full width (2 causal SelfAttentionLayers of
    512, 4 heads of 128, an RnnOutputLayer of 96) at t 8192 and batch 4,
    over a 2-shard seq axis on the one card (`seq_parallel_mesh(devices=
    [card, card])`):

    1. One float32 step, its gradients against the plain single-device
       step's from the same parameters (`step_grads`, `grad_rel_errs`; the
       Wq/Wk updates at Sgd's rate are below a rounding of the weights,
       their gradients are not). On the plain step's ReLU decisions
       (`pinned_relus_by_block`, the flips counted) every leaf within
       UPDATE_REL_STEP. On its own decisions each leaf may stray no further
       than a rounding-only control does plus UPDATE_REL_STEP: the control
       is the plain step with attention through `ring_self_attention` on
       whole tensors (the ring's rounding, no wrapper). K3, K4 and K5 each
       launch layers x shards x hops times (the counts reset just before
       the unpinned step and read just after).
    2. `bf16_steps` bfloat16 steps through `fit` (the main path), every
       score finite, the launch counts held to the ring's, timed against
       phase_char_model's bfloat16 step (`char`).
    3. The 3-D mode: data 1 x model 2 x seq 2 (heads split over the model
       axis, parameters sharded over it) at one attention layer and t
       `threed_t`: one float32 step on the plain step's ReLU decisions,
       finite, each leaf's gradient within UPDATE_REL_STEP of the plain
       step's; then `output` against the plain network's."""
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.ops import flash_attention as fa
    from deeplearning4j_torch.ops.attention import sequence_parallel
    from deeplearning4j_torch.parallel import SequenceParallelWrapper, seq_parallel_mesh
    from deeplearning4j_torch.parallel.mesh import SEQ_AXIS, gather_replicated
    from deeplearning4j_torch.utils import params as param_utils
    s = dict(SP_FULL, **(size or {}))
    dev = device or "cuda"
    n = s["seq"]
    on_card = torch.device(dev).type == "cuda"
    result = {"card": card, "t": s["t"], "batch": s["batch"], "seq_shards": n}
    ds = sp_data(s, s["batch"], s["t"], seed=2191)
    mesh = seq_parallel_mesh(devices=[dev] * n)

    # 1. one float32 step, sharded against plain
    make = lambda: MultiLayerNetwork(sp_conf(s)).init(dtype=torch.float32, device=dev)
    launches = {}

    def sharded_step(net):
        w = SequenceParallelWrapper(net, mesh)
        _sync(torch, dev)
        _zero_counts(fa)   # the main path's run starts here
        w.fit_batch(ds)
        launches.update(_counts(fa))   # ... and ends here

    def control_step(net):
        with sequence_parallel(mesh, SEQ_AXIS, None):
            net._fit_batch(ds)

    record, flips = [], {"pinned": [], "unpinned": [], "control": []}
    plain_g, plain = step_grads(torch, make, lambda net: net._fit_batch(ds), record)
    control_g, _ = step_grads(torch, make, control_step, record, flips["control"],
                              pin=False)
    unpinned_g, sharded = step_grads(torch, make, sharded_step, record,
                                     flips["unpinned"], pin=False)
    check_launches("sequence parallel f32 step", launches, ring_launches(2, n, 1))
    pinned_g, _ = step_grads(torch, make, sharded_step, record, flips["pinned"])
    errs, aside = grad_rel_errs(pinned_g, plain_g)
    unpinned, _ = grad_rel_errs(unpinned_g, plain_g)
    control, _ = grad_rel_errs(control_g, plain_g)
    result["f32_step"] = {"max_grad_rel_err": max(errs.values()), "grad_rel_errs": errs,
                          "unpinned_grad_rel_errs": unpinned,
                          "control_grad_rel_errs": control, "set_aside": aside,
                          "launches": launches,
                          "relu_flips": {k: sum(v) for k, v in flips.items()},
                          "score": float(sharded.score_value),
                          "plain_score": float(plain.score_value)}
    log(f"sequence parallel: f32 step {json.dumps(result['f32_step'])}  [{card}]")
    strays = {k: e for k, e in unpinned.items() if e > control[k] + UPDATE_REL_STEP}
    if max(errs.values()) > UPDATE_REL_STEP or strays:
        raise RuntimeError(f"sequence parallel f32 step: gradients off the plain "
                           f"step's by {json.dumps(errs)} on its decisions; on their "
                           f"own, beyond the control's, {json.dumps(strays)}")
    if not np.isclose(float(sharded.score_value), float(plain.score_value), rtol=1e-4):
        raise RuntimeError(f"sequence parallel: score {float(sharded.score_value)} "
                           f"against {float(plain.score_value)}")
    del plain, sharded, plain_g, control_g, unpinned_g, pinned_g
    if on_card:
        torch.cuda.empty_cache()

    # 2. bfloat16 steps through fit, timed
    net = MultiLayerNetwork(sp_conf(s)).init(dtype=torch.bfloat16, device=dev)
    w = SequenceParallelWrapper(net, mesh)
    data = sp_data(s, s["batch"] * s["bf16_steps"], s["t"], seed=2192)
    ends, scores = [], []

    class Steps:
        def iteration_done(self, model, iteration):
            _sync(torch, dev)
            ends.append(time.perf_counter())
            scores.append(float(model.score_value))

    net.set_listeners(Steps())
    _sync(torch, dev)
    _zero_counts(fa)   # the main path's run starts here
    t0 = time.perf_counter()
    w.fit(data, epochs=1, batch_size=s["batch"])
    launches = _counts(fa)   # ... and ends here
    check_launches("sequence parallel bf16 fit", launches,
                   ring_launches(2, n, s["bf16_steps"]))
    if len(scores) != s["bf16_steps"] or not all(np.isfinite(scores)):
        raise RuntimeError(f"sequence parallel bf16: scores {scores}")
    step_ms = (np.diff([t0] + ends) * 1e3).tolist()
    warm = float(np.median(step_ms[1:])) if len(step_ms) > 1 else step_ms[0]
    plain_ms = (char or {}).get("bf16", {}).get("median_warm_step_ms")
    result["bf16"] = {"launches": launches, "scores": scores, "step_ms": step_ms,
                      "median_warm_step_ms": warm, "plain_step_ms": plain_ms,
                      "tokens_per_s": s["batch"] * s["t"] / warm * 1e3}
    log(f"sequence parallel: bf16 fit {json.dumps(result['bf16'])}  [{card}]")
    del net, w
    if on_card:
        torch.cuda.empty_cache()

    # 3. data 1 x model 2 x seq 2 at one attention layer
    t3 = s["threed_t"]
    ds3 = sp_data(s, s["batch"], t3, seed=2193)
    mesh3 = seq_parallel_mesh(seq_devices=2, model_devices=2, devices=[dev] * 4)
    make3 = lambda: MultiLayerNetwork(sp_conf(s, layers=1)).init(dtype=torch.float32,
                                                                 device=dev)
    holder = {}

    def threed_step(net):
        holder["w"] = SequenceParallelWrapper(net, mesh3)
        holder["w"].fit_batch(ds3)

    record3, flips3 = [], []
    plain3_g, plain3 = step_grads(torch, make3, lambda net: net._fit_batch(ds3),
                                  record3)
    got3_g, sharded3 = step_grads(torch, make3, threed_step, record3, flips3)
    errs3, aside3 = grad_rel_errs(got3_g, plain3_g)
    wq = sharded3.params_tree[0]["Wq"]
    finite = all(bool(torch.isfinite(t).all()) for t in param_utils.tree_leaves(
        gather_replicated(sharded3.params_tree)))
    out_err = float(np.abs(holder["w"].output(ds3.features) - plain3.output(
        ds3.features)).max())
    result["three_d"] = {"mesh": list(mesh3.dims), "t": t3, "layers": 1,
                         "max_grad_rel_err": max(errs3.values()),
                         "grad_rel_errs": errs3, "set_aside": aside3,
                         "relu_flips_pinned": sum(flips3), "finite": finite,
                         "wq_blocks": [list(b.shape) for b in wq.slices],
                         "output_max_abs_err": out_err}
    log(f"sequence parallel: 3-D step {json.dumps(result['three_d'])}  [{card}]")
    if max(errs3.values()) > UPDATE_REL_STEP:
        raise RuntimeError(f"sequence parallel 3-D step: gradients off the plain "
                           f"step's by {json.dumps(errs3)}")
    if not finite or out_err > 1e-4:
        raise RuntimeError(f"sequence parallel 3-D: output error {out_err:.3g}, "
                           f"finite {finite}")
    return result


def phase_tensor_parallel(torch, card, device=None, size=None):
    """`TensorParallelWrapper` on zoo AlexNet at batch 128, float32, over a
    2-shard model axis on the one card (cuDNN deterministic), K1 and K2
    under it: one step against the plain step from the same parameters
    (every leaf's update within UPDATE_REL_STEP; K1 and K2 2 launches each,
    the counts reset just before the step and read just after); the bytes
    of parameters and updater state each shard holds against the whole
    trees'; a checkpoint taken while placed that restores bitwise to the
    gathered trees; `materialize_local` then a plain `output` against the
    plain network's; the warm step ms against the plain step's."""
    import tempfile

    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.models.zoo import AlexNet
    from deeplearning4j_torch.parallel import TensorParallelWrapper, tensor_parallel_mesh
    from deeplearning4j_torch.parallel.mesh import gather_replicated
    from deeplearning4j_torch.utils import params as param_utils
    from deeplearning4j_torch.utils.model_serializer import restore_model, save_model
    s = dict(TP_FULL, **(size or {}))
    dev = device or "cuda"
    shape, classes = s["alexnet"]
    rng = np.random.default_rng(2194)
    x, y = alexnet_batches(rng, 1, s["batch"], shape, classes)
    ds = DataSet(x, y)
    mesh = tensor_parallel_mesh(devices=[dev] * s["model"])
    make = lambda: AlexNet(input_shape=shape, num_labels=classes).init(device=dev)
    lrn = lrn_layers_of(make())
    result = {"card": card, "batch": s["batch"], "model_shards": s["model"]}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tp_")
    try:
        holder = {}

        def tp_step(net):
            holder["w"] = TensorParallelWrapper(net, mesh)
            _sync(torch, dev)
            zero_launches()   # the main path's run starts here
            holder["w"].fit_batch(ds)
            holder["launches"] = all_launches()   # ... and ends here

        errs, aside, ulps, plain, tp = one_step_rel(
            torch, param_utils, make, lambda net: net._fit_batch(ds), tp_step,
            tree_of=lambda n: gather_replicated(n.params_tree))
        w = holder["w"]
        check_launches("tensor parallel step", holder["launches"],
                       wrapper_launches(lrn, lrn))
        sizes = w.shard_bytes()
        report = w.param_shard_report()
        path = os.path.join(tmp.name, "tp_placed.zip")
        save_model(tp, path)
        restored = restore_model(path, device=dev)
        w.materialize_local()
        bitwise = all(torch.equal(a, b) for a, b in zip(
            param_utils.tree_leaves((tp.params_tree, tp.opt_state)),
            param_utils.tree_leaves((restored.params_tree, restored.opt_state))))
        out_err = float(np.abs(tp.output(x[:8]) - plain.output(x[:8])).max())
        result["step"] = {"max_update_rel_err": max(errs.values()),
                          "set_aside": aside, "sub_rounding_ulps": ulps,
                          "launches": holder["launches"],
                          "score": float(tp.score_value),
                          "plain_score": float(plain.score_value),
                          "sharded_params": len(report), "shard_bytes": sizes,
                          "shard_share": max(sizes["per_shard"]) / sizes["whole"],
                          "checkpoint_bitwise": bitwise,
                          "output_max_abs_err": out_err}
        log(f"tensor parallel: {json.dumps(result['step'])}  [{card}]")
        check_one_step("tensor parallel step", errs, ulps)
        if not bitwise or out_err > 1e-5:
            raise RuntimeError(f"tensor parallel: checkpoint bitwise {bitwise}, "
                               f"output error {out_err}")
        result["step_ms"] = {"sharded": fenced_step_ms(torch, dev, w.fit_batch, ds,
                                                       s["timed_steps"]),
                             "plain": fenced_step_ms(torch, dev, plain._fit_batch, ds,
                                                     s["timed_steps"])}
        log(f"tensor parallel: step ms {json.dumps(result['step_ms'])}  [{card}]")
        return result
    finally:
        torch.backends.cudnn.deterministic = prev
        tmp.cleanup()


def pipe_conf(s):
    from deeplearning4j_torch import (DenseLayer, InputType, NeuralNetConfiguration,
                                      OutputLayer, Sgd)
    b = NeuralNetConfiguration.builder().seed(19).updater(Sgd(0.01)).list()
    for _ in range(s["body"]):
        b = b.layer(DenseLayer(n_in=s["width"], n_out=s["width"], activation="relu"))
    return (b.layer(OutputLayer(n_out=s["classes"], activation="softmax",
                                loss="mcxent"))
            .set_input_type(InputType.feed_forward(s["width"])).build())


def phase_pipeline(torch, card, device=None, size=None):
    """`PipelineParallelWrapper` on 8 identical DenseLayers of 4096 -> 4096
    (AlexNet's fc width) and an OutputLayer of 1000, float32: 4 stages on
    the one card, 8 microbatches, batch 256. One step against the plain
    `fit` step from the same parameters (every leaf's update within
    UPDATE_REL_STEP); `stage_shard_report` and each stage's bytes; the warm
    step ms against the plain step's and the bubble fraction (S-1)/(M+S-1)."""
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.parallel import PipelineParallelWrapper, pipeline_mesh
    from deeplearning4j_torch.utils import params as param_utils
    s = dict(PIPE_FULL, **(size or {}))
    dev = device or "cuda"
    rng = np.random.default_rng(2195)
    x = rng.standard_normal((s["batch"], s["width"])).astype(np.float32)
    y = np.eye(s["classes"], dtype=np.float32)[rng.integers(0, s["classes"], s["batch"])]
    ds = DataSet(x, y)
    mesh = pipeline_mesh(s["stages"], devices=[dev] * s["stages"])
    make = lambda: MultiLayerNetwork(pipe_conf(s)).init(device=dev)
    holder = {}

    def pipe_step(net):
        holder["w"] = PipelineParallelWrapper(net, mesh, n_microbatches=s["microbatches"])
        holder["w"].fit_batch(ds)

    errs, aside, ulps, plain, piped = one_step_rel(torch, param_utils, make,
                                      lambda net: net.fit(ds, batch_size=s["batch"]),
                                      pipe_step)
    w = holder["w"]
    report = w.stage_shard_report()
    result = {"card": card, "stages": s["stages"], "microbatches": s["microbatches"],
              "batch": s["batch"], "max_update_rel_err": max(errs.values()),
              "set_aside": aside, "sub_rounding_ulps": ulps,
              "score": float(piped.score_value), "plain_score": float(plain.score_value),
              "bubble_fraction": w.bubble_fraction(), "stage_bytes": w.stage_bytes(),
              "stages_reported": sorted({v[1] for v in report.values()})}
    log(f"pipeline: {json.dumps(result)}  [{card}]")
    check_one_step("pipeline step", errs, ulps)
    result["step_ms"] = {"pipeline": fenced_step_ms(torch, dev, w.fit_batch, ds,
                                                    s["timed_steps"]),
                         "plain": fenced_step_ms(torch, dev, plain._fit_batch, ds,
                                                 s["timed_steps"])}
    log(f"pipeline: step ms {json.dumps(result['step_ms'])}  [{card}]")
    return result


def mh_nets():
    """The JAX package's multi-host worker's TP and SP networks (its phases 5
    and 6) with their batches and step counts: {mode: (conf, x, y, steps)}."""
    from deeplearning4j_torch import (DenseLayer, InputType, Nesterovs,
                                      NeuralNetConfiguration, OutputLayer,
                                      RnnOutputLayer, SelfAttentionLayer, Sgd)
    tp = (NeuralNetConfiguration.builder().seed(7).updater(Nesterovs(0.1, momentum=0.9))
          .list().layer(DenseLayer(n_out=16, activation="tanh"))
          .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
          .set_input_type(InputType.feed_forward(8)).build())
    sp = (NeuralNetConfiguration.builder().seed(21).updater(Sgd(0.1)).list()
          .layer(SelfAttentionLayer(n_out=16, n_heads=4, causal=True))
          .layer(RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
          .set_input_type(InputType.recurrent(8)).build())
    rng = np.random.default_rng(5)
    tx = rng.standard_normal((16, 8)).astype(np.float32)
    ty = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=16)]
    rng = np.random.default_rng(6)
    sx = rng.standard_normal((4, 16, 8)).astype(np.float32)
    sy = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 16))]
    return {"tp": (tp, tx, ty, 3), "sp": (sp, sx, sy, 2)}


MH_HOLD = {"tp": 1e-3, "sp": 1e-2}   # the JAX multi-host test's |params| sum holds


def phase_multihost_tp_sp(torch, card, device=None, size=None):
    """Tensor and sequence parallelism across two gloo ranks sharing the card
    (`multihost.main --mode tp / sp`, 2 shards a rank): the JAX package's
    multi-host worker's TP net (8-16-3, Nesterovs, 3 steps on 16 rows, a
    model axis of 4) and SP net (causal attention of 16 wide, 4 heads, 2
    steps on 4 x 16, a seq axis of 4), every rank fed the whole batch. The
    ranks agree within 1e-4; both match the single-process fit on the card
    within the JAX test's holds (MH_HOLD, of the |params| sum); the TP
    checkpoint the chief writes restores on both ranks to the trained
    parameters bitwise; the hop, score and parameter-gather ms of each
    rank."""
    import tempfile

    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.utils import params as param_utils
    s = dict(MH_TP_SP_FULL, **(size or {}))
    dev = device or "cuda:0"
    rank_dev = s["device"] or dev
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mh_tp_sp_")
    result = {"card": card}
    try:
        for mode, (conf, x, y, steps) in mh_nets().items():
            conf_path = os.path.join(tmp.name, f"{mode}.json")
            with open(conf_path, "w") as f:
                f.write(conf.to_json())
            npz = os.path.join(tmp.name, f"{mode}.npz")
            np.savez(npz, x=x, y=y)
            prefix = os.path.join(tmp.name, "run")
            _, _, wall = run_ranks(["--conf", conf_path, "--data", npz, "--epochs",
                                    str(steps), "--batch-size", str(x.shape[0]),
                                    "--device", rank_dev, "--backend", "gloo",
                                    "--exact-float32", "--mode", mode,
                                    "--out", prefix], free_port())
            ranks = []
            for r in range(2):
                with np.load(f"{prefix}.{mode}.rank{r}.npz") as z:
                    ranks.append([z[k] for k in sorted(z.files)])
            agree = max(float(np.abs(a - b).max()) for a, b in zip(*ranks))
            single = MultiLayerNetwork(conf).init(device=dev)
            for _ in range(steps):
                single._fit_batch(DataSet(x, y))
            want = sum(float(np.abs(param_utils.leaf_to_reference_bits(t)[0]).sum())
                       for t in param_utils.tree_leaves(single.params_tree))
            got = sum(float(np.abs(a).sum()) for a in ranks[0])
            reports = []
            for r in range(2):
                with open(f"{prefix}.{mode}.rank{r}.json") as f:
                    reports.append(json.load(f))
            row = {"ranks_max_abs_diff": agree, "params_abs_sum": got,
                   "single_process_abs_sum": want, "hold": MH_HOLD[mode],
                   "cross_ms": [rep["cross_ms"] for rep in reports],
                   "step_ms": [rep["step_ms"] for rep in reports],
                   "backend": reports[0]["backend"], "device": reports[0]["device"],
                   "wall_s": wall}
            if mode == "tp":
                restored_ok = all(
                    all(np.array_equal(a, b) for a, b in zip(
                        [np.load(f"{prefix}.tp.rank{r}.restored.npz")[k] for k in sorted(
                            np.load(f"{prefix}.tp.rank{r}.restored.npz").files)], ranks[0]))
                    for r in range(2))
                row["checkpoint_restored_bitwise"] = restored_ok
                row["shard_bytes"] = reports[0]["shard_bytes"]
                if not restored_ok:
                    raise RuntimeError("multihost tp: the chief's checkpoint does not "
                                       "restore to the trained parameters")
            result[mode] = row
            log(f"multihost {mode}: {json.dumps(row)}  [{card}]")
            if agree > 1e-4 or abs(got - want) > MH_HOLD[mode]:
                raise RuntimeError(f"multihost {mode}: ranks differ by {agree}, |params| "
                                   f"{got} against {want} single-process")
        return result
    finally:
        tmp.cleanup()


# -------------------------------------------------- word and graph embeddings

# bench.py's bench_w2v "large" geometry (its w2v large workload): Zipf 1.05
# over 1M ids, 250,000 sentences of 40 tokens, a vocabulary of the ids drawn,
# layer 128, window 5, negative 5, chunk 16384, 8 chunks a call, seed 1; and
# its default geometry (50k ids, 10,000 sentences) for the two-shard check
W2V_FULL = dict(vocab=1_000_000, sentences=250_000, sent_len=40, layer=128,
                window=5, negative=5, chunk=16384, steps=8, seed=1,
                shard_vocab=50_000, shard_sentences=10_000, shard_epochs=2,
                shard_lr=0.025, profile=True)
# tests/test_distributed_nlp.py's planted two-cluster corpus and settings
W2V_PLANTED = dict(n_sent=600, layer=32, window=4, negative=5, lr=0.1, chunk=256,
                   steps=8, seed=3, epochs=15)
W2V_HOLD_REL = 1e-5        # a chunk or batch, card vs CPU and vs the dense form, of max|table|
W2V_SHARD_RTOL, W2V_SHARD_ATOL = 2e-4, 2e-5   # tests/test_distributed_nlp.py:79-80
W2V_CLUSTER_MIN = 0.3      # tests/test_distributed_nlp.py:66
# Word2Vec.builder() at its defaults (layer 100, HS, batch 1024, window 5)
# with negative 5 too, on bench_w2v's default corpus as text
W2V_BUILDER_FULL = dict(vocab=50_000, sentences=10_000, sent_len=40, negative=5,
                        seed=1, profile_sentences=1000, profile=True)
# tests/test_nlp.py's two-topic corpus and settings (fit_w2v, words_nearest)
NLP_PLANTED = dict(n=300, layer=24, window=3, epochs=25, batch=256, lr=0.1,
                   min_lr=0.01, seed=7)
# ParagraphVectors at tests/test_nlp.py's settings but 60 epochs, not 30 (at
# 30, PV-DM's purity ranges 6-10 of 10 over seeds 1-12 on the CPU and was 5
# on the card; at 60, 10 at every seed); GloVe at its builder's
# defaults on a planted-topic corpus cut to fit (20 topics of 50 words,
# 40,000 sentences of 10: 400k tokens, which the host's co-occurrence count
# takes seconds over); DeepWalk at its defaults on a planted partition
# of 10,000 vertices (100 communities of 100, 8 edges a vertex inside its
# community, 1 across), 10 walks a vertex (its default; 5 leave a 2,000-vertex
# graph's nearest neighbours 11% in their community); Node2Vec on 1,000 (its
# walker is a Python loop over every step's neighbours), for 3 epochs (after
# one, 65% of nearest neighbours are in their community; after three, all)
DOC_GRAPH_FULL = dict(pv_docs=60, pv_epochs=60, glove_topics=20, glove_words=50,
                      glove_sentences=40_000, glove_len=10, glove_epochs=25,
                      dw_vertices=10_000, dw_community=100, dw_degree_in=8,
                      dw_degree_out=1, dw_walks=10, dw_epochs=1, n2v_vertices=1_000,
                      n2v_community=50, n2v_walks=10, n2v_epochs=3)


def _sync_dev(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def zipf_corpus(vocab, sentences, sent_len, seed=0):
    """bench.py bench_w2v's corpus: ids drawn Zipf(1.05) over `vocab` in one
    vectorized draw, a VocabCache of the ids drawn (count order), and the
    flat (token ids, sentence ids) of `corpus_arrays`."""
    from deeplearning4j_torch.nlp.vocab import VocabCache
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.05
    probs /= probs.sum()
    corpus = rng.choice(vocab, size=(sentences, sent_len), p=probs).astype(np.int32)
    cache = VocabCache()
    flat, counts = np.unique(corpus, return_counts=True)
    for w, c in zip(flat, counts):
        cache.add_token(str(w), count=int(c))
    cache.finish(min_word_frequency=1)
    remap = np.zeros(vocab, np.int32)
    remap[flat] = [cache.index_of(str(w)) for w in flat]
    toks = remap[corpus].reshape(-1)
    sids = np.repeat(np.arange(sentences, dtype=np.int32), sent_len)
    return cache, corpus, toks, sids


def w2v_chunk_draws(torch, rng, chunk, window, negative, table_len):
    """One chunk's draws made on the host (windows, keep uniforms, table
    positions), so the card and the CPU see the same numbers."""
    return (torch.as_tensor(rng.integers(1, window + 1, chunk)),
            torch.as_tensor(rng.random((chunk, 2 * window + 1), dtype=np.float32)),
            torch.as_tensor(rng.integers(0, table_len, (chunk, negative))))


def dense_chunk_reference(torch, tables, corpus, sent, keep, unigram, start, lr,
                          b, u, neg_pos, window):
    """The JAX package's chunk (nlp/distributed.py:one_chunk) in its dense
    form, written apart from the port and in float64: autograd of the summed
    loss over the whole tables, each row's gradient divided by the chunk's
    touch count of that row, one full-table update. Returns the new
    tables."""
    import torch.nn.functional as F
    dev = tables["syn0"].device
    syn0 = tables["syn0"].detach().double().requires_grad_(True)
    syn1 = tables["syn1neg"].detach().double().requires_grad_(True)
    V, n, C = syn0.shape[0], corpus.shape[0], b.shape[0]
    offs = torch.tensor([o for o in range(-window, window + 1) if o], device=dev)
    idx = start + torch.arange(C, device=dev)
    P = idx[:, None] + offs[None, :]
    ic, Pc = idx.clamp(max=n - 1), P.clamp(0, n - 1)
    centers, contexts = corpus[ic].long(), corpus[Pc].long()
    valid = ((offs.abs()[None, :] <= b[:, None]) & (P >= 0) & (P < n)
             & (sent[Pc] == sent[ic][:, None]) & (idx < n)[:, None]
             & (u[:, :1] < keep[centers][:, None]) & (u[:, 1:] < keep[contexts]))
    vm = valid.double()
    m = vm.sum(1)
    negs = unigram[neg_pos.long()].long()
    h = syn0[centers]
    loss = -((F.logsigmoid((h[:, None, :] * syn1[contexts]).sum(-1)) * vm).sum()
             + (F.logsigmoid(-(h[:, None, :] * syn1[negs]).sum(-1)) * m[:, None]).sum())
    g0, g1 = torch.autograd.grad(loss, (syn0, syn1))
    c0 = torch.zeros(V, device=dev, dtype=torch.float64).index_put_((centers,), m,
                                                                    accumulate=True)
    c1 = torch.zeros(V, device=dev, dtype=torch.float64).index_put_(
        (torch.cat([contexts.reshape(-1), negs.reshape(-1)]),),
        torch.cat([vm.reshape(-1), m.repeat_interleave(negs.shape[1])]), accumulate=True)
    with torch.no_grad():
        return {"syn0": syn0 - lr * g0 / c0.clamp(min=1)[:, None],
                "syn1neg": syn1 - lr * g1 / c1.clamp(min=1)[:, None]}


def table_rel_errs(got, want):
    """{table: max|got - want| / max|want|}, on the host."""
    out = {}
    for k, w in want.items():
        w = w.detach().float().cpu()
        out[k] = float((got[k].detach().float().cpu() - w).abs().max()
                       / w.abs().max().clamp(min=1e-30))
    return out


def cluster_separation(cache, vectors, groups):
    """mean cosine within a group - mean cosine across groups, over the
    vocabulary entries named str(id); `groups` maps an id to its group."""
    ids = [w for w in groups if cache.index_of(str(w)) >= 0]
    v = vectors[[cache.index_of(str(w)) for w in ids]]
    v = v / np.clip(np.linalg.norm(v, axis=1, keepdims=True), 1e-12, None)
    sims = v @ v.T
    g = np.array([groups[w] for w in ids])
    same = (g[:, None] == g[None, :]) & ~np.eye(len(ids), dtype=bool)
    return float(sims[same].mean() - sims[g[:, None] != g[None, :]].mean())


def planted_cluster_corpus(n_sent, seed=0, words=60, length=12):
    """tests/test_distributed_nlp.py's corpus: two clusters of 30 ids whose
    sentences never mix; (cache, indexed sentences, {id: cluster})."""
    from deeplearning4j_torch.nlp.vocab import VocabCache
    rng = np.random.default_rng(seed)
    half = words // 2
    sents = []
    for _ in range(n_sent):
        c = rng.integers(0, 2)
        sents.append(rng.integers(half * c, half * (c + 1), length).astype(np.int32))
    cache = VocabCache()
    flat, counts = np.unique(np.concatenate(sents), return_counts=True)
    for w, c in zip(flat, counts):
        cache.add_token(str(w), count=int(c))
    cache.finish(min_word_frequency=1)
    remap = np.zeros(words, np.int32)
    for w in flat:
        remap[w] = cache.index_of(str(w))
    return cache, [remap[s] for s in sents], {w: int(w >= half) for w in range(words)}


def phase_word2vec_device_corpus(torch, card, device=None, size=None):
    """The device-corpus engine (`nlp.ShardedWord2Vec`) at bench.py's w2v
    large geometry: one warm epoch and one timed epoch over 10M tokens
    (words/s), the tables' bytes, one profiled call (device busy against
    wall, the top device ops). Holds: one chunk of the pure function
    (`distributed.one_chunk`) on the trained tables, the card against the
    CPU on the same host-made draws and against the dense autograd form of
    the chunk (`dense_chunk_reference`), each table within W2V_HOLD_REL of
    its max; at bench_w2v's default geometry, two shards listing the card
    twice against one shard after `shard_epochs` epochs (rtol 2e-4, atol
    2e-5); the planted two-cluster corpus separates by more than 0.3. No
    hand-written kernel runs here: every count stays 0."""
    from deeplearning4j_torch.nlp import distributed as dist
    from deeplearning4j_torch.parallel.mesh import data_parallel_mesh
    s = dict(W2V_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    result = {"card": card, "geometry": {k: s[k] for k in (
        "vocab", "sentences", "sent_len", "layer", "window", "negative", "chunk",
        "steps", "seed")}}
    t0 = time.perf_counter()
    cache, _, toks, sids = zipf_corpus(s["vocab"], s["sentences"], s["sent_len"])
    result["host_setup_s"] = time.perf_counter() - t0
    result["vocab_size"] = len(cache)
    make = lambda c, **kw: dist.ShardedWord2Vec(
        c, layer_size=s["layer"], window=s["window"], negative=s["negative"],
        chunk=s["chunk"], steps_per_call=s["steps"], seed=s["seed"], **kw)
    tr = make(cache, device=dev)
    result["tables_bytes"] = sum(t.numel() * t.element_size() for t in tr.tables.values())
    # 1. the main path: a warm epoch, then a timed one
    zero_launches()
    tr.fit_corpus(toks, sids, epochs=1)
    _sync_dev(torch, dev)
    t0 = time.perf_counter()
    tr.fit_corpus(toks, sids, epochs=1)
    _sync_dev(torch, dev)
    epoch_s = time.perf_counter() - t0
    launches = all_launches()
    check_launches("word2vec device corpus", launches, dict.fromkeys(launches, 0))
    losses = tr.last_losses.float().cpu().numpy()
    if not np.isfinite(losses).all() or not np.isfinite(tr.vectors()).all():
        raise RuntimeError(f"word2vec device corpus: losses {losses}")
    result.update(epoch_s=epoch_s, words_per_s=len(toks) / epoch_s,
                  calls_per_epoch=-(-len(toks) // (s["chunk"] * s["steps"])),
                  last_losses=losses.tolist())
    if s["profile"] and dev.type == "cuda":
        starts = np.arange(s["steps"]) * s["chunk"]
        lrs = np.full(s["steps"], tr.min_lr, np.float32)

        def one_call():
            tr._call(starts, lrs)
            _sync_dev(torch, dev)

        prof = profile_call(torch, f"word2vec device corpus, one call of {s['steps']} "
                            f"chunks", one_call, {"chunks": s["steps"]})
        result["profile"] = {k: prof[k] for k in (
            "wall_ms", "unprofiled_wall_ms", "device_busy_ms", "device_idle_share", "top")}
    # 2. one chunk on the trained tables: card against the CPU and against
    # the dense form, on the same host-made draws
    rng = np.random.default_rng(2201)
    b, u, neg_pos = w2v_chunk_draws(torch, rng, s["chunk"], s["window"], s["negative"],
                                    len(tr._unigram))
    start = int(rng.integers(0, max(1, len(toks) - s["chunk"])))
    lr = float(np.float32(tr.lr))
    before = {k: t.clone() for k, t in tr.tables.items()}
    rep = tr._replicas[tr.device]
    on_card = dist.Replica({k: t.clone() for k, t in before.items()}, rep.corpus,
                           rep.sent, rep.keep, rep.unigram)
    on_cpu = dist.Replica({k: t.to("cpu", copy=True) for k, t in before.items()},
                          rep.corpus.cpu(),
                          rep.sent.cpu(), rep.keep.cpu(), rep.unigram.cpu())
    cpu = torch.device("cpu")
    dist.one_chunk({dev: on_card}, [dev], start, lr, b.to(dev), u.to(dev),
                   neg_pos.to(dev), s["window"])
    dist.one_chunk({cpu: on_cpu}, [cpu], start, lr, b, u, neg_pos, s["window"])
    dense = dense_chunk_reference(torch, before, rep.corpus, rep.sent, rep.keep,
                                  rep.unigram, start, lr, b.to(dev), u.to(dev),
                                  neg_pos.to(dev), s["window"])
    moved = max(table_rel_errs(before, on_cpu.tables).values())
    hold = {"card_vs_cpu": table_rel_errs(on_card.tables, on_cpu.tables),
            "card_vs_dense": table_rel_errs(on_card.tables, dense),
            "chunk_moved_rel": moved, "start": start, "limit": W2V_HOLD_REL}
    result["hold"] = hold
    del before, on_card, on_cpu, dense
    log(f"word2vec device corpus hold: {json.dumps(hold)}  [{card}]")
    worst = max(list(hold["card_vs_cpu"].values()) + list(hold["card_vs_dense"].values()))
    if not worst <= W2V_HOLD_REL or not moved > 0:
        raise RuntimeError(f"word2vec device corpus: one chunk off by {worst} of max|table| "
                           f"(> {W2V_HOLD_REL}), or no move ({moved})")
    del tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # 3. two shards on the card against one, at bench_w2v's default geometry
    cache2, _, toks2, sids2 = zipf_corpus(s["shard_vocab"], s["shard_sentences"],
                                          s["sent_len"])
    single = make(cache2, device=dev, learning_rate=s["shard_lr"])
    single.fit_corpus(toks2, sids2, epochs=s["shard_epochs"])
    two = make(cache2, mesh=data_parallel_mesh(devices=[dev, dev]),
               learning_rate=s["shard_lr"])
    two.fit_corpus(toks2, sids2, epochs=s["shard_epochs"])
    a, w = two.vectors(), single.vectors()
    excess = float((np.abs(a - w) - (W2V_SHARD_ATOL + W2V_SHARD_RTOL * np.abs(w))).max())
    result["two_shards"] = {"max_abs_diff": float(np.abs(a - w).max()),
                            "max_excess_over_tolerance": excess,
                            "shards": len(two._shard_devices),
                            "epochs": s["shard_epochs"], "tokens": len(toks2)}
    if not excess <= 0:
        raise RuntimeError(f"word2vec two shards: {excess} beyond rtol {W2V_SHARD_RTOL}, "
                           f"atol {W2V_SHARD_ATOL} of one shard")
    # 4. quality: the planted two-cluster corpus
    p = W2V_PLANTED
    cache3, indexed, groups = planted_cluster_corpus(p["n_sent"])
    t3, s3 = dist.corpus_arrays(indexed)
    planted = dist.ShardedWord2Vec(cache3, layer_size=p["layer"], window=p["window"],
                                   negative=p["negative"], learning_rate=p["lr"],
                                   chunk=p["chunk"], steps_per_call=p["steps"],
                                   seed=p["seed"], device=dev)
    planted.fit_corpus(t3, s3, epochs=p["epochs"])
    score = cluster_separation(cache3, planted.vectors(), groups)
    result["planted_separation"] = score
    if not score > W2V_CLUSTER_MIN:
        raise RuntimeError(f"word2vec device corpus: planted clusters separate by {score} "
                           f"(<= {W2V_CLUSTER_MIN})")
    log(f"word2vec device corpus: {result['words_per_s']:.0f} words/s over "
        f"{len(toks)} tokens ({epoch_s:.3f} s an epoch, vocabulary {len(cache)}, "
        f"tables {result['tables_bytes']} bytes), idle share "
        f"{result.get('profile', {}).get('device_idle_share')}; two shards "
        f"{json.dumps(result['two_shards'])}; planted separation {score:.4f}; host "
        f"setup {result['host_setup_s']:.1f} s  [{card}]")
    return result


@contextmanager
def counted_embedding_steps(counts):
    """Count the device steps of the host-pair engine, ParagraphVectors and
    GloVe by name (each module's own binding of the step it calls)."""
    from deeplearning4j_torch.nlp import embeddings as emb
    from deeplearning4j_torch.nlp import glove
    from deeplearning4j_torch.nlp import paragraph_vectors as pv
    sites = [(emb, "_hs_step"), (emb, "_ns_step"), (pv, "_hs_step"), (pv, "_ns_step"),
             (pv, "_dm_hs_step"), (pv, "_dm_ns_step"), (glove, "_glove_step")]
    with ExitStack() as stack:
        for mod, name in sites:
            fn = getattr(mod, name)

            def counting(*a, _fn=fn, _name=name, **kw):
                counts[_name] = counts.get(_name, 0) + 1
                return _fn(*a, **kw)

            stack.enter_context(patched(mod, name, counting))
        yield counts


def dense_batch_reference(torch, tables, centers, contexts, codes, points, negs, lr):
    """The JAX package's HS step then NS step (nlp/embeddings.py:_hs_step,
    _ns_step, skip-gram) in their dense form, written apart from the port:
    autograd over the whole tables, word2vec.c's |score| < 6 window on the
    HS bits, each row's gradient divided by its touch count (`_row_scale`).
    Computed in float64; returns the new tables and the share of valid HS
    bits the window skipped."""
    import torch.nn.functional as F
    t = {k: v.detach().double() for k, v in tables.items()}
    dev = t["syn0"].device
    centers, contexts = centers.long(), contexts.long()

    def counts(n, idx, w):
        return torch.zeros(n, device=dev, dtype=torch.float64).index_put_(
            (idx.reshape(-1).clamp(min=0),), w.reshape(-1).double(), accumulate=True)

    syn0, syn1 = t["syn0"].requires_grad_(True), t["syn1"].requires_grad_(True)
    score = (syn0[centers][:, None, :] * syn1[points.clamp(min=0).long()]).sum(-1)
    valid = codes >= 0
    window = (score.abs() < 6.0).detach()
    sign = 1.0 - 2.0 * codes.clamp(min=0).double()
    loss = -(F.logsigmoid(sign * score) * (valid & window).double()).sum()
    g0, g1 = torch.autograd.grad(loss, (syn0, syn1))
    skipped = float((valid & ~window).sum()) / max(1, int(valid.sum()))
    with torch.no_grad():
        syn0 = syn0 - lr * g0 / counts(syn0.shape[0], centers,
                                       torch.ones_like(centers)).clamp(min=1)[:, None]
        syn1 = syn1 - lr * g1 / counts(syn1.shape[0], points, valid).clamp(min=1)[:, None]
    syn0.requires_grad_(True)
    s1n = t["syn1neg"].requires_grad_(True)
    h = syn0[centers]
    loss = -(F.logsigmoid((h * s1n[contexts]).sum(-1)).sum()
             + F.logsigmoid(-(h[:, None, :] * s1n[negs.long()]).sum(-1)).sum())
    g0, gn = torch.autograd.grad(loss, (syn0, s1n))
    slots = torch.cat([contexts[:, None], negs.long()], dim=1)
    with torch.no_grad():
        new = {"syn0": syn0 - lr * g0 / counts(syn0.shape[0], centers,
                                               torch.ones_like(centers)).clamp(min=1)[:, None],
               "syn1": syn1,
               "syn1neg": s1n - lr * gn / counts(s1n.shape[0], slots,
                                                 torch.ones_like(slots)).clamp(min=1)[:, None]}
    return new, skipped


def zipf_text(corpus):
    return [" ".join(f"w{t}" for t in row) for row in corpus]


def two_topic_text(n, seed):
    """tests/test_nlp.py's corpus: sentences of 6 words drawn from two
    disjoint five-word topics, alternating."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "bird", "horse", "fish"]
    foods = ["bread", "cheese", "apple", "rice", "soup"]
    return [" ".join(rng.choice(animals if i % 2 == 0 else foods, size=6))
            for i in range(n)], animals, foods


def skip_window_scale(score):
    """The factor on syn1 that takes about half of these |scores| out of
    word2vec.c's |score| < 6 window: 6 falls at the middle of the widest
    relative gap between neighbouring scores within 5% (of the count) of
    the median, so no score sits on the window's edge, where the card and
    the CPU, summing in other orders, could decide it either way (with
    the median scaled to 6, the median's own bit sat on the edge, and in
    one run the card decided some bit otherwise than the CPU)."""
    srt = score.double().sort().values
    n = srt.numel()
    lo = max(0, min(int(0.45 * n), n - 2))
    window = srt[lo:max(int(0.55 * n), lo + 1) + 1]
    i = int((window[1:] / window[:-1].clamp(min=1e-30)).argmax())
    return 12.0 / max(float(window[i] + window[i + 1]), 1e-12)


def phase_word2vec_builder(torch, card, device=None, size=None):
    """`Word2Vec.builder()` at its defaults (layer 100, hierarchical softmax,
    batch 1024) with negative 5 too, skip-gram, on bench_w2v's default
    corpus as text: the host-pair engine. Reports words/s and the host's
    share of the wall (tokenizing and vocabulary, pair generation and the
    per-batch negatives, timed again alone) against the device steps, and a
    profiled epoch over `profile_sentences` sentences. Holds: one HS + NS
    batch on the trained tables, and again with syn1 scaled so that about
    half the batch's code bits leave word2vec.c's |score| < 6 window, the
    card against the CPU and against the dense autograd form
    (`dense_batch_reference`), within W2V_HOLD_REL of max|table|. Then one CBOW epoch, the serializer's
    binary and header-text round trips (bitwise), and `words_nearest` on the
    planted two-topic corpus (every neighbour of "cat" an animal)."""
    from deeplearning4j_torch.nlp import WordVectorSerializer
    from deeplearning4j_torch.nlp import embeddings as emb
    from deeplearning4j_torch.nlp.tokenization import DefaultTokenizerFactory
    from deeplearning4j_torch.nlp.vocab import VocabConstructor
    from deeplearning4j_torch.nlp.word2vec import Word2Vec
    s = dict(W2V_BUILDER_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    _, corpus, _, _ = zipf_corpus(s["vocab"], s["sentences"], s["sent_len"])
    text = zipf_text(corpus)
    n_tokens = corpus.size
    result = {"card": card, "tokens": int(n_tokens)}

    def builder(sentences):
        return (Word2Vec.builder().iterate(sentences).negative_sample(s["negative"])
                .seed(s["seed"]).device(dev))

    # 1. the main path: fit, the launch counts 0
    zero_launches()
    steps = {}
    _sync_dev(torch, dev)
    t0 = time.perf_counter()
    with counted_embedding_steps(steps):
        w2v = builder(text).build().fit()
    _sync_dev(torch, dev)
    wall = time.perf_counter() - t0
    launches = all_launches()
    check_launches("word2vec builder", launches, dict.fromkeys(launches, 0))
    tr = w2v._trainer
    if not (tr.use_hs and tr.negative == s["negative"] and tr.layer_size == 100
            and tr.batch_size == 1024 and np.isfinite(tr.last_loss)):
        raise RuntimeError(f"word2vec builder: trainer {vars(tr).keys()} loss {tr.last_loss}")
    # the host's part, timed again alone with the same generator calls
    t0 = time.perf_counter()
    tokenized = [DefaultTokenizerFactory().create(x).get_tokens() for x in text]
    cache = VocabConstructor().build(tokenized)
    indexed = emb.sentences_to_indices(tokenized, cache)
    vocab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rng = np.random.default_rng(s["seed"])
    centers, contexts = emb.generate_pairs(indexed, tr.window, rng)
    order = rng.permutation(len(centers))
    centers, contexts = centers[order], contexts[order]
    for start in range(0, len(centers), tr.batch_size):
        rng.choice(tr._unigram, size=(min(tr.batch_size, len(centers) - start), tr.negative))
    pairs_s = time.perf_counter() - t0
    result.update(wall_s=wall, words_per_s=n_tokens / wall, pairs=int(len(centers)),
                  steps=steps, host_vocab_s=vocab_s, host_pairs_s=pairs_s,
                  host_share=(vocab_s + pairs_s) / wall)
    if s["profile"] and dev.type == "cuda":
        part = indexed[:s["profile_sentences"]]
        prof = profile_call(torch, f"word2vec builder, one epoch of {len(part)} sentences",
                            lambda: (tr.fit_sentences(part, 1), _sync_dev(torch, dev)),
                            {"sentences": len(part)})
        result["profile"] = {k: prof[k] for k in (
            "wall_ms", "unprofiled_wall_ms", "device_busy_ms", "device_idle_share", "top")}
    # 2. one HS + NS batch: card against the CPU and the dense form
    B = tr.batch_size
    c, x = torch.as_tensor(centers[:B]), torch.as_tensor(contexts[:B])
    codes = torch.as_tensor(tr._codes[contexts[:B]])
    points = torch.as_tensor(tr._points[contexts[:B]])
    negs = torch.as_tensor(np.random.default_rng(2202).choice(tr._unigram,
                                                              size=(B, tr.negative)))
    trained = {k: v.detach().float().cpu() for k, v in tr.tables.items()}
    score = (trained["syn0"][c.long()][:, None, :]
             * trained["syn1"][points.clamp(min=0).long()]).sum(-1)[codes >= 0].abs()
    # the trained tables, then syn1 scaled so that about half the batch's
    # code bits leave the |score| < 6 window
    scale = skip_window_scale(score)
    lr = float(np.float32(tr.lr))
    hold = {"limit": W2V_HOLD_REL, "syn1_scale": scale}
    for variant, factor in (("trained", 1.0), ("syn1_scaled", scale)):
        t = dict(trained, syn1=trained["syn1"] * factor)
        after = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            tb = {k: v.to(d, copy=True) for k, v in t.items()}
            emb._hs_step(tb, c.to(d), x.to(d), codes.to(d), points.to(d), lr)
            emb._ns_step(tb, c.to(d), x.to(d), negs.to(d), lr)
            after[where] = tb
        dense, skipped = dense_batch_reference(
            torch, {k: v.to(dev) for k, v in t.items()}, c.to(dev), x.to(dev),
            codes.to(dev), points.to(dev), negs.to(dev), lr)
        hold[variant] = {"card_vs_cpu": table_rel_errs(after["card"], after["cpu"]),
                         "card_vs_dense": table_rel_errs(after["card"], dense),
                         "hs_bits_skipped_share": skipped}
    result["hold"] = hold
    log(f"word2vec builder hold: {json.dumps(hold)}  [{card}]")
    worst = max(e for v in ("trained", "syn1_scaled") for k in ("card_vs_cpu", "card_vs_dense")
                for e in hold[v][k].values())
    skipped = hold["syn1_scaled"]["hs_bits_skipped_share"]
    if not (worst <= W2V_HOLD_REL and 0 < skipped < 1):
        raise RuntimeError(f"word2vec builder: one HS + NS batch off by {worst} of "
                           f"max|table| (> {W2V_HOLD_REL}); skipped share {skipped}")
    # 3. one CBOW epoch
    t0 = time.perf_counter()
    cbow = builder(text).elements_learning_algorithm("cbow").build().fit()
    _sync_dev(torch, dev)
    cbow_s = time.perf_counter() - t0
    if not (np.isfinite(cbow._trainer.last_loss)
            and np.isfinite(cbow.get_word_vector_matrix()).all()):
        raise RuntimeError(f"word2vec CBOW: loss {cbow._trainer.last_loss}")
    result["cbow"] = {"wall_s": cbow_s, "words_per_s": n_tokens / cbow_s,
                      "last_loss": cbow._trainer.last_loss}
    # 4. the serializer's round trips
    out = os.path.join(ROOT, "build", "word2vec_smoke")
    os.makedirs(out, exist_ok=True)
    mat = w2v.get_word_vector_matrix()
    trips = {}
    for name, binary in (("vectors.bin", True), ("vectors.txt", False)):
        path = os.path.join(out, name)
        WordVectorSerializer.write_word2vec_model(w2v, path, binary=binary)
        back = WordVectorSerializer.load_google_model(path, binary=binary)
        trips[name] = bool(back.vocab.index2word == w2v.vocab.index2word and np.array_equal(
            back.get_word_vector_matrix().view(np.uint32), mat.view(np.uint32)))
    result["round_trips_bitwise"] = trips
    if not all(trips.values()):
        raise RuntimeError(f"word2vec serializer: round trips {trips}")
    # 5. words_nearest on the planted two-topic corpus
    p = NLP_PLANTED
    sents, animals, _ = two_topic_text(p["n"], 0)
    planted = (Word2Vec.builder().iterate(sents).layer_size(p["layer"])
               .window_size(p["window"]).epochs(p["epochs"]).batch_size(p["batch"])
               .learning_rate(p["lr"]).min_learning_rate(p["min_lr"]).seed(p["seed"])
               .negative_sample(5).use_hierarchic_softmax(False).device(dev)
               .build().fit())
    near = planted.words_nearest("cat", top_n=4)
    result["nearest_cat"] = near
    if not set(near) <= set(animals):
        raise RuntimeError(f"word2vec builder: nearest to 'cat' {near}")
    log(f"word2vec builder: {result['words_per_s']:.0f} words/s ({wall:.3f} s for "
        f"{n_tokens} tokens, {steps} steps), host share {result['host_share']:.3f} "
        f"(vocabulary {vocab_s:.3f} s, pairs and negatives {pairs_s:.3f} s), idle "
        f"share {result.get('profile', {}).get('device_idle_share')}; CBOW "
        f"{result['cbow']['words_per_s']:.0f} words/s; round trips {trips}; "
        f"nearest 'cat' {near}  [{card}]")
    return result


def topic_text(topics, words, sentences, length, seed):
    """Planted topics: each sentence draws `length` words of one topic of
    `words` words; (sentences, {word: topic})."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, topics, sentences)
    ids = t[:, None] * words + rng.integers(0, words, (sentences, length))
    return ([" ".join(f"t{i}" for i in row) for row in ids],
            {f"t{i}": int(i // words) for i in range(topics * words)})


def planted_partition(core, n, community, deg_in, deg_out, seed):
    """A graph of n vertices in communities of `community`: each vertex
    draws deg_in / 2 edges inside its community and the graph n deg_out / 2
    edges between any two vertices (about deg_in and deg_out a vertex)."""
    rng = np.random.default_rng(seed)
    g = core.Graph(n)
    a = np.repeat(np.arange(n), deg_in // 2)
    b = (a // community) * community + rng.integers(0, community, a.size)
    u = rng.integers(0, n, n * deg_out // 2)
    v = rng.integers(0, n, u.size)
    for x, y in zip(np.concatenate([a, u]), np.concatenate([b, v])):
        if x != y:
            g.add_edge(int(x), int(y))
    return g


def community_scores(model, n, community, probes, seed):
    """(mean same-community cosine - mean cross-community cosine over probe
    vertices against samples of each, share of each probe's 10 nearest in
    its own community)."""
    rng = np.random.default_rng(seed)
    gap, near = [], []
    for v in rng.choice(n, probes, replace=False):
        base = (v // community) * community
        same = [int(x) for x in base + rng.integers(0, community, 8) if x != v]
        cross = [int(x) for x in rng.integers(0, n, 8) if x // community != v // community]
        gap.append(np.mean([model.similarity(int(v), x) for x in same])
                   - np.mean([model.similarity(int(v), x) for x in cross]))
        near.append(np.mean([x // community == v // community
                             for x in model.verticies_nearest(int(v), 10)]))
    return float(np.mean(gap)), float(np.mean(near))


def phase_doc_and_graph_embeddings(torch, card, device=None, size=None):
    """ParagraphVectors (DBOW and DM, then `infer_vector`, card against CPU
    within W2V_HOLD_REL of its largest entry) at tests/test_nlp.py's
    settings (60 epochs) on its planted two-topic documents; GloVe
    at its builder's defaults on a planted-topic corpus cut to fit; DeepWalk
    at its defaults on a planted partition of `dw_vertices` vertices and
    Node2Vec (p 0.5, q 2) on `n2v_vertices`. Each must put same-topic or
    same-community neighbours ahead of the others, as the JAX package's
    tests hold (tests/test_nlp.py:172, :213, :337); steps/s of each, every
    kernel count 0."""
    from deeplearning4j_torch.graph import DeepWalk, Node2Vec
    from deeplearning4j_torch.graph import core
    from deeplearning4j_torch.nlp import Glove, ParagraphVectors
    s = dict(DOC_GRAPH_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    result = {"card": card}
    zero_launches()

    def timed(label, fn):
        steps = {}
        _sync_dev(torch, dev)
        t0 = time.perf_counter()
        with counted_embedding_steps(steps):
            out = fn()
        _sync_dev(torch, dev)
        wall = time.perf_counter() - t0
        n = sum(steps.values())
        result[label] = {"wall_s": wall, "steps": steps, "steps_per_s": n / wall}
        return out

    # 1. ParagraphVectors: DBOW and DM, each probe's nearest document of its topic
    docs, _, _ = two_topic_text(s["pv_docs"], 1)
    labels = [f"DOC_{i}" for i in range(len(docs))]
    p = NLP_PLANTED
    for algo in ("dbow", "dm"):
        pv = timed(f"pv_{algo}", lambda: (
            ParagraphVectors.builder().iterate(docs).labels(labels)
            .sequence_learning_algorithm(algo).layer_size(p["layer"])
            .window_size(p["window"]).epochs(s["pv_epochs"]).batch_size(p["batch"])
            .learning_rate(p["lr"]).min_learning_rate(p["min_lr"]).seed(p["seed"])
            .negative_sample(5).use_hierarchic_softmax(False).device(dev).build().fit()))
        same = np.mean([pv.similarity_docs("DOC_0", f"DOC_{i}") for i in range(2, 20, 2)])
        cross = np.mean([pv.similarity_docs("DOC_0", f"DOC_{i}") for i in range(1, 20, 2)])
        purity = sum(max((pv.similarity_docs(f"DOC_{q}", f"DOC_{j}"), j)
                         for j in range(40) if j != q)[1] % 2 == q % 2 for q in range(10))
        result[f"pv_{algo}"].update(same=float(same), cross=float(cross), purity=purity)
        if not (same > cross and purity >= 8):
            raise RuntimeError(f"ParagraphVectors {algo}: same {same}, cross {cross}, "
                               f"purity {purity} of 10")
        if algo == "dbow":
            # infer_vector on the card against the same call on a CPU copy
            # of the tables; the topic margin is reported, not held (the
            # inferred vectors share the doc table's common component)
            text_in = "cat dog horse fish bird cat"
            inferred = pv.infer_vector(text_in)
            on_cpu = copy.copy(pv)
            on_cpu._trainer = copy.copy(pv._trainer)
            on_cpu._trainer.device = torch.device("cpu")
            on_cpu._trainer.tables = {k: v.cpu() for k, v in pv._trainer.tables.items()}
            want = on_cpu.infer_vector(text_in)
            err = float(np.abs(inferred - want).max() / np.abs(want).max())
            cos = lambda a, b: float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            animal = np.mean([cos(inferred, pv.doc_vector(f"DOC_{i}")) for i in range(0, 20, 2)])
            food = np.mean([cos(inferred, pv.doc_vector(f"DOC_{i}")) for i in range(1, 20, 2)])
            result["pv_dbow"]["infer"] = {"card_vs_cpu": err, "animal": float(animal),
                                          "food": float(food)}
            if not (err <= W2V_HOLD_REL and np.isfinite(inferred).all()):
                raise RuntimeError(f"ParagraphVectors infer_vector: card vs CPU {err}")
    # 2. GloVe at its defaults on the planted topics
    text, topic = topic_text(s["glove_topics"], s["glove_words"], s["glove_sentences"],
                             s["glove_len"], 3)
    g = timed("glove", lambda: Glove.builder().iterate(text).epochs(s["glove_epochs"])
              .seed(5).device(dev).build().fit())
    rng = np.random.default_rng(4)
    probes = [f"t{i}" for i in rng.choice(len(topic), 10, replace=False)]
    near_share = np.mean([np.mean([topic[w] == topic[q] for w in g.words_nearest(q, 4)])
                          for q in probes])
    others = [f"t{i}" for i in rng.choice(len(topic), 40, replace=False)]
    gap = np.mean([np.mean([g.similarity(q, w) for w in others if topic[w] == topic[q]]
                           or [0.0])
                   - np.mean([g.similarity(q, w) for w in others if topic[w] != topic[q]])
                   for q in probes])
    result["glove"].update(nearest_same_topic_share=float(near_share),
                           same_minus_cross=float(gap), last_loss=g.last_loss,
                           vocab=len(g.vocab))
    if not (near_share >= 0.75 and np.isfinite(g.last_loss)):
        raise RuntimeError(f"GloVe: nearest words of their topic {near_share}, "
                           f"loss {g.last_loss}")
    # 3. DeepWalk and 4. Node2Vec on planted partitions
    for label, cls, n, comm, walks, epochs, kw in (
            ("deepwalk", DeepWalk, s["dw_vertices"], s["dw_community"], s["dw_walks"],
             s["dw_epochs"], {}),
            ("node2vec", Node2Vec, s["n2v_vertices"], s["n2v_community"], s["n2v_walks"],
             s["n2v_epochs"], {"p": 0.5, "q": 2.0})):
        graph = planted_partition(core, n, comm, s["dw_degree_in"], s["dw_degree_out"], 6)
        model = timed(label, lambda: cls(device=dev, **kw).fit(
            graph, walks_per_vertex=walks, epochs=epochs))
        gap, near = community_scores(model, n, comm, 20, 7)
        result[label].update(vertices=n, same_minus_cross=gap, nearest_same_share=near)
        if not (gap > 0 and near > 0.5):
            raise RuntimeError(f"{label}: same minus cross community {gap}, nearest in "
                               f"community {near}")
    launches = all_launches()
    check_launches("doc and graph embeddings", launches, dict.fromkeys(launches, 0))
    log(f"doc and graph embeddings: {json.dumps(result)}  [{card}]")
    return result


# ----------------------------------------------------------------------------
# Clustering, the k-NN server and Keras import (plain torch, no hand-written
# kernel: every K1-K7 count is reset before each phase and must read 0 after)

# A Word2Vec-sized table behind the nearest-neighbour server (1M x 128
# float32, 512 MB), queried in batches of 256
KNN_FULL = dict(n=1_000_000, d=128, queries=1024, batch=256, k=10, http_requests=64,
                http_rows=8, http_clients=4, tie_rows=3000, tie_dim=8, tie_queries=256,
                seed=2111)
KNN_RTOL = 1e-5   # card against the CPU port: distances, and the near-ties that may swap
KMEANS_FULL = dict(n=1_000_000, d=64, k=256, max_iterations=100, subset=100_000,
                   spread=3.0, seed=2113)
KMEANS_REL = 1e-5           # centroids, of max|c|: card or CPU against float64
KMEANS_INERTIA_REL = 1e-4   # the final inertia on the subset, card against CPU
# float32 rounding of a d^2 by the expansion, of ||p||^2 + max ||c||^2: two
# centroids nearer each other than this may be taken in either order
KMEANS_TIE = 2.0 ** -21
# the usual MNIST t-SNE demo size, the JAX package's defaults (perplexity 30,
# 500 iterations)
TSNE_FULL = dict(n=5000, d=50, classes=10, n_iter=500, kl_n=1000, hold_steps=10,
                 seed=2117)
TSNE_STEP_REL = 1e-5   # one step card against CPU: y, velocity, KL
TSNE_KL_REL = 1e-2     # the whole run's KL at kl_n: chaotic, so reported and held no tighter
KERAS_DIR = os.path.join(ROOT, "tests", "fixtures", "keras")
# (fixture, imported as a graph, rtol, atol): tests/test_keras_import.py's
# tolerances against the recorded Keras outputs
KERAS_FIXTURES = [("mlp", False, 1e-4, 1e-5), ("cnn", False, 1e-3, 1e-4),
                  ("lstm", False, 1e-4, 1e-5), ("act_tail", False, 1e-4, 1e-5),
                  ("relu_tail", False, 1e-4, 1e-5), ("cnn_cf", False, 1e-4, 1e-5),
                  ("functional", True, 1e-4, 1e-5), ("lstm_last", True, 1e-4, 1e-5)]
KERAS_CPU_RTOL, KERAS_CPU_ATOL = 1e-4, 1e-7   # card against the CPU port
KERAS_FULL = dict(fit_images=1024, batch=128, epochs=1, serve_batch=128, timeout_s=600)


def wall_ms(torch, dev, fn):
    """(wall ms of one call of `fn` from a synced device to a synced device,
    its result)."""
    _sync_dev(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    _sync_dev(torch, dev)
    return (time.perf_counter() - t0) * 1e3, out


def step_device_ms(torch, dev, fn, iters=10):
    """Device ms of one call of `fn` on CUDA (queued behind a sleep, so the
    launches are not timed); wall ms on the CPU."""
    if torch.device(dev).type == "cuda":
        return device_ms(torch, fn, iters)
    return min(wall_ms(torch, dev, fn)[0] for _ in range(3))


def knn_hold(label, got_i, got_d, want_i, want_d, k):
    """Hold the card's k-NN answer ([Q, k]) to the CPU port's on the same
    batch (`want_*` with k + 1 columns): each distance within KNN_RTOL of
    the CPU's at its place; an index may differ only where its distance lies
    within KNN_RTOL of a neighbouring place's (a near-tie that rounding
    orders either way), and where the k-th and (k+1)-th distances are
    further apart than that, the two sets of k are the same. Returns (the
    count of places that differ, the largest relative distance error)."""
    wi, wd = want_i[:, :k], want_d[:, :k]
    err = np.abs(got_d - wd) / np.maximum(np.abs(wd), np.finfo(np.float32).tiny)
    if not err.max() <= KNN_RTOL:
        raise RuntimeError(f"{label}: distances off the CPU port's by {err.max()}")
    swaps = got_i != wi
    for r, j in zip(*np.nonzero(swaps)):
        row = want_d[r]
        if not any(abs(row[j] - row[m]) <= KNN_RTOL * abs(row[j])
                   for m in (j - 1, j + 1) if 0 <= m <= k):
            raise RuntimeError(f"{label}: query {r} place {j} holds {got_i[r, j]}, the "
                               f"CPU port {wi[r, j]}, with no near-tie there")
    apart = want_d[:, k] - want_d[:, k - 1] > KNN_RTOL * np.abs(want_d[:, k - 1])
    for r in np.nonzero(apart)[0]:
        if set(got_i[r].tolist()) != set(wi[r].tolist()):
            raise RuntimeError(f"{label}: query {r}'s {k} nearest differ from the CPU "
                               f"port's: {sorted(got_i[r])} against {sorted(wi[r])}")
    return int(swaps.sum()), float(err.max())


def knn_tie_check(torch, vptree, dev, s, k):
    """The tie order on a corpus of integer rows, each present two or three
    times (every dot product exact, so equal distances are equal bits): the
    answer must be the first k of the distances' (distance, index) order,
    `jax.lax.top_k`'s, recomputed from the same device's distance matrix;
    rows with a tie across the k-th place must occur. Returns per metric
    the count of such rows."""
    rng = np.random.default_rng(s["seed"] + 1)
    base = rng.integers(-1, 2, (s["tie_rows"], s["tie_dim"])).astype(np.float32)
    corpus = np.concatenate([base, base[rng.permutation(len(base))],
                             base[:len(base) // 2]])
    queries = rng.integers(-1, 2, (s["tie_queries"], s["tie_dim"])).astype(np.float32)
    cols = np.broadcast_to(np.arange(len(corpus)), (len(queries), len(corpus)))
    out = {}
    for metric in ("euclidean", "cosine"):
        idx, dist = vptree.knn_brute_force(corpus, queries, k, metric, device=dev)
        d = vptree.knn_distances(torch.as_tensor(corpus, device=dev),
                                 torch.as_tensor(queries, device=dev), metric).cpu().numpy()
        order = np.lexsort((cols, d))
        want = order[:, :k]
        boundary = int((np.take_along_axis(d, order[:, k - 1:k], 1)
                        == np.take_along_axis(d, order[:, k:k + 1], 1)).sum())
        if not (np.array_equal(idx, want)
                and np.array_equal(dist, np.take_along_axis(d, want, 1))):
            bad = int((idx != want).any(1).sum())
            raise RuntimeError(f"k-NN tie order ({metric}): {bad} of {len(queries)} "
                               "queries not in (distance, index) order")
        if boundary == 0:
            raise RuntimeError(f"k-NN tie order ({metric}): no tie across the k-th place")
        out[metric] = {"queries": len(queries), "ties_across_kth": boundary}
    return out


def knn_results(idx, dist):
    """The server's JSON for one answer (a list of results, or a list of such
    lists for a batch)."""
    if np.ndim(idx) == 1:
        return [{"index": int(i), "distance": float(d)} for i, d in zip(idx, dist)]
    return [knn_results(i, d) for i, d in zip(idx, dist)]


def phase_knn(torch, card, device=None, size=None):
    """The brute-force k-NN path (`clustering.knn_brute_force` behind
    `serving.NearestNeighbor`): a corpus of n x d float32 on the card,
    `queries` queries in batches of `batch`, k nearest in both metrics;
    queries/s and ms a batch; one batch of each held to the CPU port
    (`knn_hold`); the tie order (`knn_tie_check`); `NearestNeighborsServer`
    over HTTP on the card, single and batched requests from client threads,
    each answer equal to a direct `search`. Every kernel count 0."""
    from deeplearning4j_torch.clustering import vptree
    from deeplearning4j_torch.serving import NearestNeighbor, NearestNeighborsServer
    from deeplearning4j_torch.utils.http_server import json_request
    s = dict(KNN_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    zero_launches()
    rng = np.random.default_rng(s["seed"])
    corpus = rng.standard_normal((s["n"], s["d"]), dtype=np.float32)
    queries = rng.standard_normal((s["queries"], s["d"]), dtype=np.float32)
    k, b = s["k"], s["batch"]
    # one product and a top-k: read the corpus once, 2 n d flops a query
    bound_ms = max(4.0 * s["n"] * s["d"] / HBM_BYTES_PER_S,
                   2.0 * b * s["n"] * s["d"] / FP32_OPS_PER_S) * 1e3
    result = {"card": card, "corpus": [s["n"], s["d"]], "corpus_bytes": corpus.nbytes,
              "k": k, "batch": b, "batch_bound_ms": bound_ms}
    for metric in ("euclidean", "cosine"):
        nn = NearestNeighbor(corpus, metric=metric, device=dev)
        nn.search(queries[:b], k)   # warm
        batch_ms, answers = [], []
        for i in range(0, len(queries), b):
            ms, ans = wall_ms(torch, dev, lambda: nn.search(queries[i:i + b], k))
            batch_ms.append(ms)
            answers.append(ans)
        got_i, got_d = answers[0]
        want_i, want_d = vptree.knn_brute_force(corpus, queries[:b], k + 1, metric,
                                                device="cpu")
        swaps, err = knn_hold(f"k-NN {metric}", got_i, got_d, want_i, want_d, k)
        result[metric] = {"queries_per_s": len(queries) / (sum(batch_ms) / 1e3),
                          "ms_per_batch": batch_ms, "near_tie_swaps": swaps,
                          "max_rel_err": err}
        if dev.type == "cuda":
            result[metric]["profile"] = profile_call(
                torch, f"k-NN batch ({metric})", lambda: nn.search(queries[:b], k),
                {"batch": b, "k": k})
        del nn
    result["ties"] = knn_tie_check(torch, vptree, dev, s, k)
    # the server: single points and batches of http_rows, from client threads
    reqs = [queries[rng.integers(0, len(queries), 1 if i % 2 == 0 else s["http_rows"])]
            for i in range(s["http_requests"])]
    reqs = [q[0] if len(q) == 1 else q for q in reqs]
    latencies, replies, errors = [None] * len(reqs), [None] * len(reqs), []
    with NearestNeighborsServer(corpus, device=dev) as srv:
        health = json_request(srv.url + "/health")

        def client(c):
            try:
                for i in range(c, len(reqs), s["http_clients"]):
                    t0 = time.perf_counter()
                    replies[i] = json_request(srv.url + "/knn", {"point": reqs[i].tolist(),
                                                                 "k": k}, timeout=120)
                    latencies[i] = (time.perf_counter() - t0) * 1e3
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(s["http_clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        http_s = time.perf_counter() - t0
        if errors or any(r is None for r in replies):
            raise RuntimeError(f"k-NN server: {errors or 'a client did not finish'}")
        for i, q in enumerate(reqs):
            if replies[i]["results"] != knn_results(*srv.nn.search(q, k)):
                raise RuntimeError(f"k-NN server: request {i} differs from a direct search")
    if health != {"status": "ok", "corpus": s["n"], "dim": s["d"]}:
        raise RuntimeError(f"k-NN server /health: {health}")
    result["http"] = {"requests": len(reqs), "requests_per_s": len(reqs) / http_s,
                      "p50_ms": float(np.percentile(latencies, 50)),
                      "p99_ms": float(np.percentile(latencies, 99))}
    launches = all_launches()
    check_launches("k-NN", launches, dict.fromkeys(launches, 0))
    log(f"k-NN: {json.dumps(result)}  [{card}]")
    return result


def kmeans_blobs(n, d, k, spread, seed):
    """n points about k centres drawn normal(0, spread), each point its
    centre plus a unit normal."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0.0, spread, (k, d)).astype(np.float32)
    return centres[rng.integers(0, k, n)] + rng.standard_normal((n, d), dtype=np.float32)


def kmeans_step_hold(torch, KMeansClustering, pts, pts_cpu, c0):
    """One `_step` from centroids `c0`, card and CPU port, each against a
    float64 recompute on the card: its assignment the float64 argmin but at
    near-ties (KMEANS_TIE), its centroids those of its own assignment within
    KMEANS_REL of max|c|; card against CPU on the clusters no differing
    point touched."""
    dev = pts.device
    p64, c64 = pts.double(), c0.double()
    d2 = ((p64 * p64).sum(-1)[:, None] - 2.0 * (p64 @ c64.T)
          + (c64 * c64).sum(-1)[None, :])
    a64 = d2.argmin(-1)
    scale = (p64 * p64).sum(-1) + (c64 * c64).sum(-1).max()
    k = c0.shape[0]
    out = {}
    steps = {"card": KMeansClustering._step(pts, c0),
             "cpu": KMeansClustering._step(pts_cpu, c0.cpu())}
    for label, (c, a, shift) in steps.items():
        a = a.to(dev)
        differ = a != a64
        gap = d2.gather(1, a[:, None])[:, 0] - d2.gather(1, a64[:, None])[:, 0]
        far = int((differ & (gap > KMEANS_TIE * scale)).sum())
        sums = torch.zeros_like(c64).index_add_(0, a, p64)
        counts = torch.bincount(a, minlength=k).double()[:, None]
        want = torch.where(counts > 0, sums / counts.clamp(min=1.0), c64)
        err = float((c.to(dev).double() - want).abs().max() / want.abs().max())
        want_shift = float(torch.linalg.norm(want - c64, dim=-1).max())
        out[label] = {"near_tie_flips": int(differ.sum()), "centroid_rel_err": err,
                      "shift": float(shift), "shift_f64": want_shift}
        if far or not err <= KMEANS_REL:
            raise RuntimeError(f"k-means step ({label}): {far} points off the float64 "
                               f"argmin beyond a near-tie, centroids off by {err}")
    (c_card, a_card, _), (c_cpu, a_cpu, _) = steps.values()
    differ = a_card.cpu() != a_cpu
    touched = set(a_card.cpu()[differ].tolist()) | set(a_cpu[differ].tolist())
    keep = torch.tensor([j for j in range(k) if j not in touched], dtype=torch.long)
    err = float((c_card.cpu()[keep] - c_cpu[keep]).abs().max() / c_cpu.abs().max())
    out["card_vs_cpu"] = {"assignments_differ": int(differ.sum()),
                          "clusters_compared": len(keep), "centroid_rel_err": err}
    if not err <= KMEANS_REL:
        raise RuntimeError(f"k-means step: card against CPU centroids off by {err}")
    return out


def phase_kmeans(torch, card, device=None, size=None):
    """KMeansClustering on the card: `fit` on n x d planted blobs (k
    centres) up to max_iterations Lloyd iterations (iterations/s, a step's
    device ms beside its bound); one `_step` from the same initial
    centroids held by `kmeans_step_hold`; the final inertia of a fit on the
    first `subset` points, card against CPU port, within
    KMEANS_INERTIA_REL. Every kernel count 0."""
    from deeplearning4j_torch.clustering import KMeansClustering
    s = dict(KMEANS_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    zero_launches()
    x = kmeans_blobs(s["n"], s["d"], s["k"], s["spread"], s["seed"])
    pts = torch.as_tensor(x, device=dev)
    km = KMeansClustering(s["k"], max_iterations=s["max_iterations"], seed=s["seed"],
                          device=dev)
    fit_ms, _ = wall_ms(torch, dev, lambda: km.fit(pts))
    c_fit = torch.as_tensor(km.centroids, device=dev)
    step_ms = step_device_ms(torch, dev, lambda: KMeansClustering._step(pts, c_fit))
    profile = None
    if dev.type == "cuda":
        profile = profile_call(torch, "k-means step", lambda: (
            KMeansClustering._step(pts, c_fit), torch.cuda.synchronize()), {"k": s["k"]})
    # two [n, d] x [d, k] products; read the points twice, write nothing of size
    bound_ms = max(8.0 * s["n"] * s["d"] / HBM_BYTES_PER_S,
                   4.0 * s["n"] * s["d"] * s["k"] / FP32_OPS_PER_S) * 1e3
    init = np.random.default_rng(s["seed"]).choice(s["n"], size=s["k"], replace=False)
    c0 = pts[torch.as_tensor(init, device=dev)]
    hold = kmeans_step_hold(torch, KMeansClustering, pts, torch.as_tensor(x), c0)
    sub = x[:s["subset"]]
    inertia = {}
    for label, where in (("card", dev), ("cpu", "cpu")):
        m = KMeansClustering(s["k"], max_iterations=s["max_iterations"], seed=s["seed"],
                             device=where).fit(sub)
        inertia[label] = {"inertia": m.inertia(sub), "iterations": m.iterations_run}
    gap = abs(inertia["card"]["inertia"] - inertia["cpu"]["inertia"]) / inertia["cpu"]["inertia"]
    if not (np.isfinite(km.centroids).all() and gap <= KMEANS_INERTIA_REL):
        raise RuntimeError(f"k-means: subset inertia card against CPU off by {gap}")
    result = {"card": card, "points": [s["n"], s["d"]], "k": s["k"],
              "iterations": km.iterations_run, "fit_ms": fit_ms,
              "iterations_per_s": km.iterations_run / (fit_ms / 1e3),
              "step_device_ms": step_ms, "step_bound_ms": bound_ms, "step_hold": hold,
              "profile": profile,
              "subset": {"points": len(sub), "inertia_rel_gap": gap, **inertia}}
    launches = all_launches()
    check_launches("k-means", launches, dict.fromkeys(launches, 0))
    log(f"k-means: {json.dumps(result)}  [{card}]")
    return result


def tsne_points(n, d, classes, seed):
    """n points in `classes` clusters: centres normal(0, 4), unit noise."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0.0, 4.0, (classes, d))
    return (centres[rng.integers(0, classes, n)]
            + rng.standard_normal((n, d))).astype(np.float32)


def phase_tsne(torch, card, device=None, size=None):
    """Exact t-SNE on the card at the JAX package's defaults: the host
    calibration's seconds and the device steps' ms apart, a step's device
    ms beside its bound; one `_tsne_step` (after hold_steps exaggerated
    steps) card against CPU port within TSNE_STEP_REL (y, velocity, KL);
    the whole run's KL at kl_n points, card against CPU port, within
    TSNE_KL_REL (the descent is chaotic: float32 rounding grows step by
    step). Every kernel count 0."""
    from deeplearning4j_torch.clustering import Tsne
    from deeplearning4j_torch.clustering.tsne import _tsne_step
    s = dict(TSNE_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    zero_launches()
    x = tsne_points(s["n"], s["d"], s["classes"], s["seed"])
    ts = Tsne(n_iter=s["n_iter"], seed=s["seed"], device=dev)
    t0 = time.perf_counter()
    P = ts._affinities(x)
    calibration_s = time.perf_counter() - t0
    descent_ms, y = wall_ms(torch, dev, lambda: ts._descend(P))
    if not (y.shape == (s["n"], ts.n_components) and np.isfinite(y).all()
            and np.isfinite(ts.kl_divergence)):
        raise RuntimeError(f"t-SNE: embedding {y.shape}, KL {ts.kl_divergence}")
    rng = np.random.default_rng(ts.seed)
    yt = torch.as_tensor(rng.normal(0, 1e-4, (s["n"], ts.n_components)),
                         dtype=torch.float32, device=dev)
    vel = torch.zeros_like(yt)
    Pd = torch.as_tensor(P, dtype=torch.float32, device=dev)
    for _ in range(s["hold_steps"]):
        yt, vel, _ = _tsne_step(yt, vel, Pd * ts.early_exaggeration,
                                ts.initial_momentum, ts.learning_rate)
    args = (ts.final_momentum, ts.learning_rate)
    got = _tsne_step(yt, vel, Pd, *args)
    want = _tsne_step(yt.cpu(), vel.cpu(), Pd.cpu(), *args)
    rel = {name: float((g.cpu() - w).abs().max() / w.abs().max())
           for name, g, w in zip(("y", "velocity", "kl"), got, want)}
    if not max(rel.values()) <= TSNE_STEP_REL:
        raise RuntimeError(f"t-SNE step card against CPU: {rel}")
    step_ms = step_device_ms(torch, dev, lambda: _tsne_step(yt, vel, Pd, *args))
    profile = None
    if dev.type == "cuda":
        profile = profile_call(torch, "t-SNE step", lambda: (
            _tsne_step(yt, vel, Pd, *args), torch.cuda.synchronize()), {"n": s["n"]})
    # read P once and write nothing of its size
    bound_ms = 4.0 * s["n"] ** 2 / HBM_BYTES_PER_S * 1e3
    kl = {}
    for label, where in (("card", dev), ("cpu", "cpu")):
        m = Tsne(n_iter=s["n_iter"], seed=s["seed"], device=where)
        m.fit_transform(x[:s["kl_n"]])
        kl[label] = m.kl_divergence
    gap = abs(kl["card"] - kl["cpu"]) / abs(kl["cpu"])
    if not gap <= TSNE_KL_REL:
        raise RuntimeError(f"t-SNE at {s['kl_n']} points: KL card {kl['card']} against "
                           f"CPU {kl['cpu']}")
    result = {"card": card, "points": [s["n"], s["d"]], "n_iter": ts.n_iter,
              "perplexity": ts.perplexity, "calibration_s": calibration_s,
              "descent_ms": descent_ms, "ms_per_step": descent_ms / ts.n_iter,
              "step_device_ms": step_ms, "step_bound_ms": bound_ms,
              "kl": ts.kl_divergence, "step_hold": rel, "profile": profile,
              "whole_run": {"points": s["kl_n"], "kl": kl, "rel_gap": gap}}
    launches = all_launches()
    check_launches("t-SNE", launches, dict.fromkeys(launches, 0))
    log(f"t-SNE: {json.dumps(result)}  [{card}]")
    return result


def keras_leaves_equal(param_utils, a, b):
    """Two networks' parameter trees, leaf by leaf, bitwise."""
    la = param_utils.tree_leaves(param_utils.params_to_numpy(a))
    lb = param_utils.tree_leaves(param_utils.params_to_numpy(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        for x, y in zip(la, lb))


def phase_keras_import(torch, card, device=None, size=None):
    """Keras import on the card through the port's own HDF5 reader: each of
    the eight fixtures against its recorded Keras outputs (expected.npz at
    tests/test_keras_import.py's tolerances) and against the CPU port
    (KERAS_CPU_RTOL, KERAS_CPU_ATOL; parameter trees bitwise). Then the
    full-width mnist_cnn.h5 (Keras's examples/mnist_cnn.py): the file's read
    seconds, a batch of serve_batch served and held to the JAX package's
    outputs (mnist_cnn_expected.npz, SERVE_RTOL/SERVE_ATOL), and training
    through `KerasBackendServer` over HTTP: /fit on fit_images synthesized
    MNIST images (epochs, batch), /predict against the served network's own
    `output`, a bad handle's 400; a further epoch timed on the trained
    network (step ms, images/s). Every kernel count 0."""
    import urllib.error
    from deeplearning4j_torch.data.fetchers import MnistDataFetcher
    from deeplearning4j_torch.keras_import import Hdf5Archive, KerasModelImport
    from deeplearning4j_torch.serving import KerasBackendServer
    from deeplearning4j_torch.utils import params as param_utils
    from deeplearning4j_torch.utils.http_server import json_request
    s = dict(KERAS_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    zero_launches()
    expected = np.load(os.path.join(KERAS_DIR, "expected.npz"))
    result = {"card": card, "fixtures": {}}
    for name, graph, rtol, atol in KERAS_FIXTURES:
        path = os.path.join(KERAS_DIR, f"{name}.h5")
        imp = (KerasModelImport.import_keras_model_and_weights if graph
               else KerasModelImport.import_keras_sequential_model_and_weights)
        net, cpu = imp(path, device=dev), imp(path, device="cpu")
        x = expected[f"{name}_x"]
        if name == "cnn_cf":   # Keras consumed [b, c, h, w]; the network NHWC
            x = x.transpose(0, 2, 3, 1)
        got, want, on_cpu = net.output(x), expected[f"{name}_y"], cpu.output(x)
        keras_err = float(np.abs(got - want).max())
        cpu_err = float(np.abs(got - on_cpu).max())
        same_tree = keras_leaves_equal(param_utils, net.params_tree, cpu.params_tree)
        result["fixtures"][name] = {"vs_keras": keras_err, "vs_cpu": cpu_err,
                                    "trees_bitwise": same_tree}
        if not (np.allclose(got, want, rtol=rtol, atol=atol)
                and np.allclose(got, on_cpu, rtol=KERAS_CPU_RTOL, atol=KERAS_CPU_ATOL)
                and same_tree):
            raise RuntimeError(f"Keras import {name}: {result['fixtures'][name]}")
    # the full-width model
    path = os.path.join(KERAS_DIR, "mnist_cnn.h5")
    t0 = time.perf_counter()
    with Hdf5Archive(path) as ar:
        ar.model_config()
        weights = {n: ar.layer_weights(n) for n in ar.layer_names()}
    read_s = time.perf_counter() - t0
    n_weights = sum(a.size for w in weights.values() for a in w.values())
    net = KerasModelImport.import_keras_sequential_model_and_weights(path, device=dev)
    mexp = np.load(os.path.join(KERAS_DIR, "mnist_cnn_expected.npz"))
    xs = mexp["x"][:s["serve_batch"]]
    got = net.output(xs)
    serve_ms = min(wall_ms(torch, dev, lambda: net.output(xs))[0] for _ in range(3))
    err = float(np.abs(got - mexp["y"][:len(xs)]).max())
    if not (n_weights == net.num_params() == 1_199_882
            and np.allclose(got, mexp["y"][:len(xs)], rtol=SERVE_RTOL, atol=SERVE_ATOL)):
        raise RuntimeError(f"mnist_cnn: {n_weights} weights read, served batch off the "
                           f"JAX package's outputs by {err}")
    data = MnistDataFetcher(path=os.path.join(ROOT, "build", "keras_mnist"),
                            synthesize=True).as_dataset(s["fit_images"], flatten=False)
    x, y = data.features / np.float32(255.0), data.labels
    with KerasBackendServer(device=dev) as srv:
        body = {"model_path": path, "features": x.tolist(), "labels": y.tolist(),
                "epochs": s["epochs"], "batch_size": s["batch"]}
        t0 = time.perf_counter()
        fit = json_request(srv.url + "/fit", body, timeout=s["timeout_s"])
        fit_s = time.perf_counter() - t0
        steps = s["epochs"] * -(-len(x) // s["batch"])
        if not (np.isfinite(fit["score"]) and fit["iterations"] == steps):
            raise RuntimeError(f"Keras server /fit: {fit}")
        served = srv._models[fit["handle"]]
        pred = json_request(srv.url + "/predict", {"handle": fit["handle"],
                                                   "features": xs.tolist()},
                            timeout=s["timeout_s"])
        pred = np.asarray(pred["predictions"], np.float32)
        direct = served.output(xs)
        if not (np.allclose(pred, direct, rtol=1e-5, atol=0)
                and np.allclose(pred.sum(1), 1.0, rtol=1e-5)):
            raise RuntimeError("Keras server /predict differs from the network's output")
        try:
            json_request(srv.url + "/predict", {"handle": "nope", "features": xs[:1].tolist()})
            raise RuntimeError("Keras server: an unknown handle was answered")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise RuntimeError(f"Keras server: an unknown handle gave {e.code}") from e
        epoch_ms, _ = wall_ms(torch, dev, lambda: served.fit(
            x, y, epochs=1, batch_size=s["batch"]))
        second_score = float(served.score_value)
        profile = None
        if dev.type == "cuda":
            profile = profile_call(torch, "mnist_cnn fit step", lambda: (
                served.fit(x[:s["batch"]], y[:s["batch"]], epochs=1, batch_size=s["batch"]),
                torch.cuda.synchronize()), {"batch": s["batch"]})
    result["mnist_cnn"] = {
        "parameters": n_weights, "file_bytes": os.path.getsize(path), "read_s": read_s,
        "serve": {"batch": len(xs), "ms": serve_ms, "images_per_s": len(xs) / (serve_ms / 1e3),
                  "vs_jax": err},
        "fit": {"images": len(x), "batch": s["batch"], "request_s": fit_s,
                "score": fit["score"], "iterations": fit["iterations"],
                "step_ms": epoch_ms / (steps // s["epochs"]),
                "images_per_s": len(x) / (epoch_ms / 1e3),
                "score_after_second_epoch": second_score,
                "profile": profile}}
    launches = all_launches()
    check_launches("Keras import", launches, dict.fromkeys(launches, 0))
    log(f"Keras import: {json.dumps(result)}  [{card}]")
    return result


# ------------------------------- training observability, streaming, estimators

OBS_FULL = dict(alexnet=((224, 224, 3), 1000), batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                bins=20, conv_every=3, timed_fits=2, seed=2201)
STATS_MEAN_RTOL = 1e-5     # a record's mean |w| against float64 numpy on a host copy
STATS_UPDATE_RTOL = 1e-4   # a record's mean |w - w_prev| against float64 numpy
STREAM_FULL = dict(alexnet=((224, 224, 3), 1000), images=32, clients=2, poll_s=0.5,
                   wait_s=300, first_s=60, seed=2203)
STREAM_RTOL = 1e-5         # a routed answer against a direct `output` of its image
EST_FULL = dict(n_train=60000, hidden=1000, batch=128, epochs=1, lr=0.05,
                reg_n=4096, reg_d=16, reg_hidden=64, reg_epochs=3, seed=2205)
EST_ATOL = 1e-4            # card against CPU: predict_proba, regressor predictions
EST_NEAR_TIE = 1e-4        # top-2 probabilities this close may rank otherwise
CHURN_EXTRA = 2            # distinct batch sizes past the threshold
LOCK_FULL = dict(alexnet=((224, 224, 3), 1000), clients=4, per_client=4, max_rows=4,
                 batch_limit=16, join_s=600, seed=2207)


def _dev_sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


class _HostSnapshots:
    """Listener: after every step, a host copy of every leaf under the
    StatsListener's names and the score, taken by the phase and not by the
    listener under test."""

    def __init__(self):
        self.params, self.scores = {}, {}

    def take(self, model, iteration):
        self.params[iteration] = {
            f"layer{i}/{k}": v.detach().cpu().numpy()
            for i, layer in enumerate(model.params_tree) for k, v in layer.items()}
        if model.score_value is not None:
            self.scores[iteration] = float(model.score_value)

    def iteration_done(self, model, iteration):
        self.take(model, iteration)


class _StepEnds:
    """Listener: each step's end time, after a sync."""

    def __init__(self, torch, dev):
        self.torch, self.dev, self.ends = torch, dev, []

    def iteration_done(self, model, iteration):
        _dev_sync(self.torch, self.dev)
        self.ends.append(time.perf_counter())


def check_stats_records(records, snaps, bins):
    """Each record against float64 numpy on the phase's own host copies: the
    score exactly, mean magnitudes within STATS_MEAN_RTOL, update magnitudes
    within STATS_UPDATE_RTOL, every histogram equal to `np.histogram`, count
    for count. Returns the largest relative errors and the counts held."""
    worst = {"mean": 0.0, "update": 0.0, "histograms": 0, "updates": 0}
    for rec in records:
        it = rec["iteration"]
        host = snaps.params[it]
        if it in snaps.scores and rec["score"] != snaps.scores[it]:
            raise RuntimeError(f"stats record {it}: score {rec['score']} != "
                               f"{snaps.scores[it]}")
        if sorted(rec["param_mean_magnitudes"]) != sorted(host):
            raise RuntimeError(f"stats record {it}: leaves {sorted(rec['param_mean_magnitudes'])}")
        for name, a in host.items():
            want = float(np.mean(np.abs(a.astype(np.float64))))
            got = rec["param_mean_magnitudes"][name]
            err = abs(got - want) / max(abs(want), 1e-30)
            worst["mean"] = max(worst["mean"], err)
            if err > STATS_MEAN_RTOL:
                raise RuntimeError(f"stats record {it}: mean |{name}| {got} != {want}")
            counts, edges = np.histogram(a, bins=bins)
            h = rec["param_histograms"][name]
            if h["counts"] != counts.tolist() or \
                    (h["min"], h["max"]) != (float(edges[0]), float(edges[-1])):
                raise RuntimeError(f"stats record {it}: histogram of {name} {h} != "
                                   f"np.histogram {counts.tolist()} over "
                                   f"[{edges[0]}, {edges[-1]}]")
            worst["histograms"] += 1
        prev = snaps.params.get(it - 1)
        upd = rec.get("update_mean_magnitudes", {})
        if prev is not None and sorted(upd) != sorted(host):
            raise RuntimeError(f"stats record {it}: update leaves {sorted(upd)}")
        for name, got in upd.items():
            want = float(np.mean(np.abs(host[name].astype(np.float64)
                                        - prev[name].astype(np.float64))))
            err = abs(got - want) / max(abs(want), 1e-30)
            worst["update"] = max(worst["update"], err)
            if err > STATS_UPDATE_RTOL:
                raise RuntimeError(f"stats record {it}: update |{name}| {got} != {want}")
            worst["updates"] += 1
    return worst


class _Leaves:
    """A model whose parameter tree is the given tensors, one layer."""

    def __init__(self, tensors):
        self.params_tree = ({f"p{i}": t for i, t in enumerate(tensors)},)
        self.score_value = None


def check_edge_histograms(torch, dev, bins, seed):
    """The listener's histograms of leaves on `dev` built to sit on numpy's
    edges, count for count against `np.histogram`: normal values with every
    one of their edges planted among them (the max one of them), signed
    zeros beside tiny values, constant leaves (edges min - 0.5 and max +
    0.5), a span of 64 ulps (edges about 3 ulps apart, where the scaled
    estimate needs its corrections), float64. Returns the number of
    leaves."""
    from deeplearning4j_torch.ui import InMemoryStatsStorage, StatsListener, \
        StatsUpdateConfiguration
    rng = np.random.default_rng(seed)
    normal = rng.standard_normal(4099).astype(np.float32)
    normal[:bins + 1] = np.histogram_bin_edges(normal, bins)
    zeros = np.zeros(512, np.float32)
    zeros[::3] = -0.0
    zeros[1::5] = np.float32(1e-30)
    arrays = [normal, zeros, np.zeros(64, np.float32), np.full(33, -2.5, np.float32),
              (1 + (np.arange(300) % 65) * np.float32(2.0 ** -23)).astype(np.float32),
              rng.standard_normal(1000)]
    store = InMemoryStatsStorage()
    StatsListener(store, session_id="edges", config=StatsUpdateConfiguration(
        collect_histograms=True, histogram_bins=bins)).iteration_done(
        _Leaves([torch.from_numpy(a).to(dev) for a in arrays]), 0)
    hists = store.get_updates("edges")[0]["param_histograms"]
    for i, a in enumerate(arrays):
        counts, edges = np.histogram(a, bins)
        h = hists[f"layer0/p{i}"]
        if h["counts"] != counts.tolist() or \
                (h["min"], h["max"]) != (float(edges[0]), float(edges[-1])):
            raise RuntimeError(f"edge histogram {i}: {h['counts']} != np.histogram "
                               f"{counts.tolist()}")
    return len(arrays)


def _median_warm_ms(ends, t0):
    return float(np.median(np.diff([t0] + ends)[1:] * 1e3))


def phase_training_ui(torch, card, device=None, size=None):
    """Training observability (ui/) on a full-width zoo AlexNet `fit` in
    float32 at batch TRAIN_BATCH for TRAIN_STEPS steps, synthetic data from
    the seed:

    1. The main path: a StatsListener (frequency 1, histograms, updates,
       memory) writing through a RemoteStatsStorageRouter over HTTP into a
       StatsReceiverServer whose FileStatsStorage a UIServer (with
       `attach_model`) shows, and a ConvolutionalIterationListener with one
       probe image. The K1-K7 counts are reset just before and read just
       after: K1 2 x (steps + probe forwards), K2 2 x steps.
    2. Every record (and one taken before the first step) against float64
       numpy on host copies of the parameters taken by the phase
       (`check_stats_records`), and leaves built to sit on numpy's edges
       (`check_edge_histograms`); GET /, /model, /activations, /metrics,
       /train/sessions and the receiver's /sessions answer 200;
       `render_html_report` writes a file.
    3. ms a step of `fit` with a StatsListener and without it, on the same
       net and batch, in turns (plain, listener, listener, plain ...), the
       bytes the listener brought to the host for each record, and one
       record alone under the profiler."""
    import tempfile
    import urllib.request
    from deeplearning4j_torch.models.zoo import AlexNet
    from deeplearning4j_torch.ui import (ConvolutionalIterationListener, FileStatsStorage,
                                         InMemoryStatsStorage, RemoteStatsStorageRouter,
                                         StatsListener, StatsReceiverServer,
                                         StatsUpdateConfiguration, UIServer,
                                         render_html_report)
    s = dict(OBS_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    shape, classes = s["alexnet"]
    rng = np.random.default_rng(s["seed"])
    n = s["steps"] * s["batch"]
    x = rng.standard_normal((n,) + tuple(shape), dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    net = AlexNet(input_shape=shape, num_labels=classes).init(device=dev)
    leaves = [t for layer in net.params_tree for t in layer.values()]
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    cfg = dict(collect_histograms=True, histogram_bins=s["bins"], collect_updates=True,
               collect_memory=True)
    out_dir = os.path.join(ROOT, "build", "training_ui")
    os.makedirs(out_dir, exist_ok=True)
    path = tempfile.mkstemp(suffix=".jsonl", dir=out_dir)[1]
    store = FileStatsStorage(path)
    receiver = StatsReceiverServer(store).start()
    ui = UIServer(port=0).start()
    router = RemoteStatsStorageRouter(receiver.url)
    t_phase = time.perf_counter()
    try:
        ui.attach(store).attach_model(net)
        stats = StatsListener(router, frequency=1, session_id="alexnet",
                              config=StatsUpdateConfiguration(**cfg))
        conv = ConvolutionalIterationListener(x[:1], frequency=s["conv_every"], ui=ui)
        snaps = _HostSnapshots()
        snaps.take(net, 0)
        stats.iteration_done(net, 0)   # the record before the first step
        net.listeners[:] = [stats, conv, snaps]
        zero_launches()   # the main path's run starts here
        net.fit(x, y, epochs=1, batch_size=s["batch"])
        launches = all_launches()   # ... and ends here
        probes = s["steps"] // s["conv_every"]
        check_launches("training UI", launches,
                       dict(dict.fromkeys(launches, 0),
                            lrn_fwd=2 * (s["steps"] + probes), lrn_bwd=2 * s["steps"]))
        record_bytes, record_transfers = stats.last_host_bytes, stats.last_transfers
        router.flush(timeout=120)
        records = [r for r in store.get_updates("alexnet") if "epoch_end" not in r]
        if router.dropped or [r["iteration"] for r in records] != list(range(s["steps"] + 1)):
            raise RuntimeError(f"training UI: {router.dropped} records dropped, "
                               f"iterations {[r['iteration'] for r in records]}")
        held = check_stats_records(records, snaps, s["bins"])
        held["edge_leaves"] = check_edge_histograms(torch, dev, s["bins"], s["seed"])
        if dev.type == "cuda" and not all("device_bytes_in_use" in r for r in records):
            raise RuntimeError("training UI: a record lacks device_bytes_in_use")
        pages = {}
        for url in (ui.url + "/", ui.url + "/model", ui.url + "/activations",
                    ui.url + "/metrics", ui.url + "/train/sessions",
                    receiver.url + "/sessions"):
            with urllib.request.urlopen(url, timeout=60) as r:
                pages[url.split("/", 3)[-1] or "/"] = (r.status, len(r.read()))
        if any(code != 200 for code, _ in pages.values()):
            raise RuntimeError(f"training UI pages: {pages}")
        with urllib.request.urlopen(ui.url + "/activations", timeout=60) as r:
            if b"layer0 (ConvolutionLayer)" not in r.read():
                raise RuntimeError("training UI: /activations shows no conv grid")
        report = render_html_report(store, os.path.join(out_dir, "report.html"))
        if os.path.getsize(report) == 0:
            raise RuntimeError("training UI: empty report")
    finally:
        router.shutdown()
        ui.stop()
        receiver.stop()
    # 3. ms a step with and without the listener, in turns
    timed = {"plain": [], "stats": []}
    for kind in ["plain", "stats", "stats", "plain"] * s["timed_fits"]:
        ends = _StepEnds(torch, dev)
        lst = [StatsListener(InMemoryStatsStorage(), config=StatsUpdateConfiguration(**cfg))] \
            if kind == "stats" else []
        net.listeners[:] = lst + [ends]
        _dev_sync(torch, dev)
        t0 = time.perf_counter()
        net.fit(x, y, epochs=1, batch_size=s["batch"])
        timed[kind].append(_median_warm_ms(ends.ends, t0))
    net.listeners.clear()
    plain_ms, stats_ms = float(np.median(timed["plain"])), float(np.median(timed["stats"]))
    profile = None
    if dev.type == "cuda":   # one record alone: where the listener's time goes
        lst = StatsListener(InMemoryStatsStorage(), config=StatsUpdateConfiguration(**cfg))
        lst.iteration_done(net, 0)
        profile = profile_call(torch, "stats record", lambda: lst.iteration_done(net, 0),
                               {"leaves": len(leaves)})
    result = {"card": card, "steps": s["steps"], "batch": s["batch"],
              "launches": launches, "records": len(records), "held": held,
              "record_host_bytes": record_bytes, "record_transfers": record_transfers,
              "param_bytes": param_bytes, "pages": pages,
              "step_ms": {"plain": plain_ms, "stats_listener": stats_ms,
                          "runs": timed},
              "listener_share": (stats_ms - plain_ms) / plain_ms,
              "record_profile": profile, "seconds": time.perf_counter() - t_phase}
    log(f"training UI: {json.dumps(result)}  [{card}]")
    return result


def phase_streaming_route(torch, card, device=None, size=None):
    """streaming/ on the card: an NDArrayStreamServer on a local port runs a
    ServeRoute over full-width zoo AlexNet (float32); an HttpBrokerClient
    publishes `images` single images from `clients` threads and consumes the
    predictions over HTTP.

    - The first message after a subscribe is not lost: the client's
      subscription is registered on the server and the first image served
      into it before the client subscribes, so the registration consume
      returns that prediction, which must be delivered.
    - Every answer within STREAM_RTOL of a direct `output` of its image,
      each image answered once (`match_answers`; the two threads' images
      reach the route in no set order); `served` equals the images and
      `errors` 0; K1 2 x served, every other count 0.
    - A malformed message counts in `errors`, and the route serves the next
      image."""
    from deeplearning4j_torch.models.zoo import AlexNet
    from deeplearning4j_torch.streaming import (HttpBrokerClient, InProcessBroker,
                                                NDArrayConsumer, NDArrayPublisher,
                                                NDArrayStreamServer, ServeRoute)
    from deeplearning4j_torch.utils.http_server import json_request
    s = dict(STREAM_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    shape, classes = s["alexnet"]
    net = AlexNet(input_shape=shape, num_labels=classes).init(device=dev)
    rng = np.random.default_rng(s["seed"])
    images = rng.standard_normal((s["images"], 1) + tuple(shape), dtype=np.float32)
    net.output(images[0])   # warm: cuDNN's choice at batch 1
    broker = InProcessBroker()
    t_phase = time.perf_counter()
    with NDArrayStreamServer(broker=broker) as srv:
        route = ServeRoute(net, "images", "preds", broker=broker)
        client = HttpBrokerClient(srv.url, client_id="smoke", poll_timeout=s["poll_s"])
        publisher = NDArrayPublisher("images", broker=client)
        consumer = None
        try:
            zero_launches()   # the main path's run starts here
            route.start()
            # the subscription the client will register as "smoke-1", made
            # first and fed the first prediction
            json_request(srv.url + "/consume", {"topic": "preds", "client": "smoke-1",
                                                "timeout": 0.0})
            publisher.publish(images[0])
            deadline = time.monotonic() + s["wait_s"]
            while route.served + route.errors < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            consumer = NDArrayConsumer("preds", broker=client)
            try:
                first = consumer.get(timeout=s["first_s"])
            except queue.Empty:
                raise RuntimeError("streaming route: the first prediction after a "
                                   "subscribe was lost") from None
            rest, errors = images[1:], []

            def client_thread(c):
                try:
                    for img in rest[c::s["clients"]]:
                        publisher.publish(img)
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client_thread, args=(c,))
                       for c in range(s["clients"])]
            for t in threads:
                t.start()
            answers = [first] + [consumer.get(timeout=s["wait_s"]) for _ in rest]
            wall_s = time.perf_counter() - t0
            for t in threads:
                t.join(s["wait_s"])
            launches = all_launches()   # ... and ends here
            if errors or any(t.is_alive() for t in threads):
                raise RuntimeError(f"streaming route: client threads {errors or 'hung'}")
            if (route.served, route.errors) != (s["images"], 0):
                raise RuntimeError(f"streaming route: served {route.served}, "
                                   f"errors {route.errors}")
            check_launches("streaming route", launches,
                           dict(dict.fromkeys(launches, 0), lrn_fwd=2 * s["images"]))
            worst = match_answers(answers, [net.output(img) for img in images])
            # a malformed message, then a good image
            publisher.publish(np.ones((1, 7), np.float32))
            publisher.publish(images[1])
            after = consumer.get(timeout=s["wait_s"])
            if route.errors != 1 or not np.allclose(after, net.output(images[1]),
                                                    rtol=STREAM_RTOL, atol=0):
                raise RuntimeError(f"streaming route: after a malformed message errors "
                                   f"{route.errors}, served {route.served}")
        finally:
            if consumer is not None:
                client.topic("preds").unsubscribe(consumer._queue)
            route.stop()
    result = {"card": card, "images": s["images"], "clients": s["clients"],
              "launches": launches, "served": route.served, "errors": route.errors,
              "images_per_s": (s["images"] - 1) / wall_s, "max_rel_err": worst,
              "seconds": time.perf_counter() - t_phase}
    log(f"streaming route: {json.dumps(result)}  [{card}]")
    return result


def match_answers(answers, direct):
    """Pair each routed answer with the one direct output it equals within
    STREAM_RTOL (relative to each value), every direct output used once;
    returns the largest relative error of the pairs. Raises when an answer
    has no such output left: a lost, doubled or wrong answer."""
    left, worst = list(range(len(direct))), 0.0
    for k, got in enumerate(answers):
        errs = [float(np.max(np.abs(got - direct[j]) / np.maximum(np.abs(direct[j]), 1e-30)))
                if got.shape == direct[j].shape else np.inf for j in left]
        if not errs or min(errs) > STREAM_RTOL:
            raise RuntimeError(f"streaming route: answer {k} is no image's direct output "
                               f"(closest {min(errs, default=np.inf)}, rtol {STREAM_RTOL})")
        worst = max(worst, min(errs))
        left.pop(int(np.argmin(errs)))
    if left:
        raise RuntimeError(f"streaming route: images {left} were not answered")
    return worst


def _near_ties(proba, tol):
    top2 = np.sort(proba, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0] < tol


def phase_estimators(torch, card, device=None, size=None):
    """ml/ on the card: MLNClassifier, a 784-1000-10 MLP (Sgd), on
    synthesized MNIST (IDX files written from the seed under build/, no
    fetch), batch 128, one epoch over n_train images, and MLNRegressor on a
    synthetic linear problem; each beside the same estimator on the CPU from
    the same initial parameters (the seed) on the same batches:
    `predict_proba` and the regressor's predictions within EST_ATOL, the
    accuracy the same but for near-ties (top-2 within EST_NEAR_TIE, counted),
    R² within EST_ATOL; `get_params` round-trips `device`; images/s of the
    card's fit. No hand-written kernel runs: every count 0."""
    import deeplearning4j_torch as port
    from deeplearning4j_torch.data.fetchers import MnistDataFetcher, synthesize_mnist_idx
    from deeplearning4j_torch.ml import MLNClassifier, MLNRegressor
    s = dict(EST_FULL, **(size or {}))
    dev = device or "cuda"
    path = os.path.join(ROOT, "build", "estimators_mnist")
    synthesize_mnist_idx(path, n_train=s["n_train"], n_test=256, seed=s["seed"])
    data = MnistDataFetcher(path=path).as_dataset()
    X = data.features / np.float32(255.0)
    y = np.argmax(data.labels, axis=1)

    def clf_conf():
        return (port.NeuralNetConfiguration.builder().seed(s["seed"])
                .updater(port.Sgd(s["lr"])).list()
                .layer(port.DenseLayer(n_out=s["hidden"], activation="relu"))
                .layer(port.OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
                .set_input_type(port.InputType.feed_forward(X.shape[1])).build())

    t_phase = time.perf_counter()
    zero_launches()
    clf = MLNClassifier(clf_conf, epochs=s["epochs"], batch_size=s["batch"],
                        seed=s["seed"], device=dev)
    _dev_sync(torch, dev)
    t0 = time.perf_counter()
    clf.fit(X, y)
    _dev_sync(torch, dev)
    fit_s = time.perf_counter() - t0
    if clf.net_.device.type != torch.device(dev).type:
        raise RuntimeError(f"estimators: the classifier trained on {clf.net_.device}")
    params = clf.get_params()
    clone = MLNClassifier(**params)
    if params["device"] != dev or clone.get_params() != params:
        raise RuntimeError(f"estimators: get_params {params} does not round-trip device")
    cpu = MLNClassifier(**dict(params, device="cpu")).fit(X, y)
    got, want = clf.predict_proba(X), cpu.predict_proba(X)
    proba_err = float(np.abs(got - want).max())
    if proba_err > EST_ATOL:
        raise RuntimeError(f"estimators: predict_proba card vs CPU off by {proba_err}")
    ties = _near_ties(want, EST_NEAR_TIE)
    differ = clf.predict(X) != cpu.predict(X)
    if np.any(differ & ~ties):
        raise RuntimeError(f"estimators: {int(np.sum(differ & ~ties))} predictions differ "
                           f"away from near-ties")
    acc, acc_cpu = clf.score(X, y), cpu.score(X, y)
    if abs(acc - acc_cpu) > np.sum(differ) / len(y) + 1e-12:
        raise RuntimeError(f"estimators: accuracy {acc} vs {acc_cpu}")
    # the regressor
    rng = np.random.default_rng(s["seed"])
    Xr = rng.standard_normal((s["reg_n"], s["reg_d"])).astype(np.float32)
    yr = Xr @ rng.standard_normal(s["reg_d"]).astype(np.float32) \
        + 0.1 * rng.standard_normal(s["reg_n"]).astype(np.float32)

    def reg_conf():
        return (port.NeuralNetConfiguration.builder().seed(s["seed"])
                .updater(port.Sgd(0.01)).list()
                .layer(port.DenseLayer(n_out=s["reg_hidden"], activation="tanh"))
                .layer(port.OutputLayer(n_out=1, activation="identity", loss="mse"))
                .set_input_type(port.InputType.feed_forward(s["reg_d"])).build())

    reg = MLNRegressor(reg_conf, epochs=s["reg_epochs"], batch_size=s["batch"],
                       seed=s["seed"], device=dev).fit(Xr, yr)
    reg_cpu = MLNRegressor(**dict(reg.get_params(), device="cpu")).fit(Xr, yr)
    reg_err = float(np.abs(reg.predict(Xr) - reg_cpu.predict(Xr)).max())
    r2, r2_cpu = reg.score(Xr, yr), reg_cpu.score(Xr, yr)
    if reg_err > EST_ATOL or abs(r2 - r2_cpu) > EST_ATOL:
        raise RuntimeError(f"estimators: regressor card vs CPU off by {reg_err}, "
                           f"R2 {r2} vs {r2_cpu}")
    launches = all_launches()
    check_launches("estimators", launches, dict.fromkeys(launches, 0))
    result = {"card": card, "n_train": s["n_train"], "batch": s["batch"],
              "fit_s": fit_s, "images_per_s": s["n_train"] * s["epochs"] / fit_s,
              "accuracy": acc, "accuracy_cpu": acc_cpu,
              "proba_max_abs_err": proba_err, "near_ties": int(np.sum(ties)),
              "predictions_differing": int(np.sum(differ)),
              "regressor": {"r2": r2, "r2_cpu": r2_cpu, "max_abs_err": reg_err},
              "device_param": params["device"], "launches": launches,
              "seconds": time.perf_counter() - t_phase}
    log(f"estimators: {json.dumps(result)}  [{card}]")
    return result


class _WarningCount(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_churn_and_locks(torch, card, device=None, size=None):
    """The shape-churn guard and the lock recorder on the card.

    1. `output` of full-width zoo AlexNet at threshold + CHURN_EXTRA distinct
       batch sizes: exactly one warning, `recompile_churn_total{fn=
       mln_output#<tag>}` up by CHURN_EXTRA, the label first in
       `churn_offenders()`; K1 2 x calls.
    2. `lockcheck.recording()` around a BATCHED ParallelInference serving that
       net from `clients` threads, then `shutdown`: its locks adopted under
       the static names, the observed lock-order edges cross-checked against
       `lock_edges_from_source` of the port's parallel/inference.py (no
       cycle, no edge the static graph does not explain); K1 2 x executed
       forwards."""
    import inspect
    from deeplearning4j_torch.analysis import lockcheck
    from deeplearning4j_torch.analysis.rules import lock_edges_from_source
    from deeplearning4j_torch.models.zoo import AlexNet
    from deeplearning4j_torch.optimize import metrics as metrics_mod
    from deeplearning4j_torch.optimize import telemetry
    from deeplearning4j_torch.parallel import inference as inf
    s = dict(LOCK_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    shape, classes = s["alexnet"]
    net = AlexNet(input_shape=shape, num_labels=classes).init(device=dev)
    rng = np.random.default_rng(s["seed"])
    t_phase = time.perf_counter()
    # 1. the churn guard
    label = f"mln_output#{net._probe_tag}"
    counter = metrics_mod.registry().counter("recompile_churn_total")
    telemetry.reset_churn()
    before = counter.value(fn=label)
    sizes = list(range(1, telemetry.churn_threshold() + CHURN_EXTRA + 1))
    handler = _WarningCount()
    tel_log = logging.getLogger(telemetry.__name__)
    tel_log.addHandler(handler)
    zero_launches()
    try:
        for b in sizes:
            net.output(rng.standard_normal((b,) + tuple(shape), dtype=np.float32))
    finally:
        tel_log.removeHandler(handler)
    churn_launches = all_launches()
    churn = {"sizes": sizes, "warnings": len(handler.messages),
             "counter": counter.value(fn=label) - before,
             "offenders": telemetry.churn_offenders(), "launches": churn_launches}
    if churn["warnings"] != 1 or churn["counter"] != CHURN_EXTRA or \
            churn["offenders"][0] != (label, len(sizes)):
        raise RuntimeError(f"churn guard on {label}: {churn}")
    check_launches("churn guard", churn_launches,
                   dict(dict.fromkeys(churn_launches, 0), lrn_fwd=2 * len(sizes)))
    # 2. the lock recorder around a batched ParallelInference
    reqs = [rng.standard_normal((int(rng.integers(1, s["max_rows"] + 1)),) + tuple(shape),
                                dtype=np.float32)
            for _ in range(s["clients"] * s["per_client"])]
    answers, errors = [None] * len(reqs), []
    with lockcheck.recording():
        pi = inf.ParallelInference(net, inference_mode=inf.InferenceMode.BATCHED,
                                   batch_limit=s["batch_limit"])
        names = lockcheck.adopt(pi)
        try:
            def client(c):
                try:
                    for i in range(c, len(reqs), s["clients"]):
                        answers[i] = pi.output(reqs[i])
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))

            zero_launches()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(s["clients"])]
            for t in threads:
                t.start()
            for t in threads:
                t.join(s["join_s"])
            forwards = pi.total_forwards
            lock_launches = all_launches()
        finally:
            pi.shutdown()
    observed = lockcheck.observed_edges()
    if errors or any(a is None for a in answers):
        raise RuntimeError(f"lock recorder: clients {errors or 'did not finish'}")
    for a, r in zip(answers, reqs):
        if a.shape != (len(r), classes) or not np.all(np.isfinite(a)):
            raise RuntimeError(f"lock recorder: an answer of shape {a.shape}")
    check_launches("lock recorder", lock_launches,
                   dict(dict.fromkeys(lock_launches, 0), lrn_fwd=2 * forwards))
    with open(inspect.getsourcefile(inf), encoding="utf-8") as fh:
        static = lock_edges_from_source(fh.read())
    report = lockcheck.cross_check(observed, static)
    if not report.ok() or report.unexplained:
        raise RuntimeError(f"lock recorder: cycles {report.cycles}, unexplained "
                           f"{sorted(report.unexplained)}")
    result = {"card": card, "churn": churn,
              "locks": {"adopted": names, "observed": {f"{a} -> {b}": n
                                                       for (a, b), n in sorted(observed.items())},
                        "confirmed": sorted(f"{a} -> {b}" for a, b in report.confirmed),
                        "unexercised": sorted(f"{a} -> {b}" for a, b in report.unexercised),
                        "cycles": report.cycles, "forwards": forwards,
                        "launches": lock_launches},
              "seconds": time.perf_counter() - t_phase}
    log(f"churn and locks: {json.dumps(result)}  [{card}]")
    return result


# ------------------------------------------------- host syncs and the gate

HOST_SYNC_FULL = dict(alexnet=((224, 224, 3), 1000), batch=TRAIN_BATCH, group=FIT_GROUP,
                      decode_rows=8, decode_steps=8, kmeans_iterations=4)
ANALYSIS_GATE_S = 300   # `python -m deeplearning4j_torch.analysis` on the port's tree


def _sync_sites(seen, per):
    """{call site relative to the checkout: syncs per step} of
    `tracecheck.sync_debug`'s counts, largest first."""
    rel = lambda site: os.path.relpath(site, ROOT) if site.startswith(ROOT) else site
    return dict(sorted(((rel(k), v / per) for k, v in seen.items()),
                       key=lambda kv: -kv[1]))


def phase_host_syncs(torch, card, device=None, size=None):
    """Host syncs on three paths, counted two ways (analysis/tracecheck.py):
    the card's own count, every synchronizing CUDA operation under
    `sync_debug("warn")` by call site, and the spies' count of the values
    the host reads implicitly (`wrap` on each path's step function, sites
    `alexnet.train_step`, `decode.model_step`, `kmeans.step`):

    1. one `fit` group of full-width zoo AlexNet (steps_per_dispatch
       `group` batches of `batch`), after a warm group;
    2. `decode_steps` steps of the DecodeEngine's adapter at the engine's
       geometry (DECODE_GEOMETRY), `decode_rows` rows prefilled
       from seeded prompts;
    3. `kmeans_iterations` Lloyd iterations of KMeansClustering at
       KMEANS_FULL's 1M x 64, k 256 (the fit's convergence test reads the
       centroid shift every iteration, analysis finding JL101 at
       clustering/kmeans.py).

    Syncs per step for each site and call site. `fenced_read` adds none to
    either count, while a plain `.cpu()` of the same tensor adds one to the
    card's (the control that the count works). Nothing is fixed here. Then
    the port's analysis gate, `python -m deeplearning4j_torch.analysis`,
    must exit 0 (it runs in a process of its own meanwhile). No hand-written
    kernel is counted: K1 and K2 launch in AlexNet's steps and K7 in the
    decode steps, as their phases hold."""
    s = dict(HOST_SYNC_FULL, **(size or {}))
    dev = torch.device(device or "cuda")
    result = {"card": card}
    # the analysis gate on the port's tree, a process of its own meanwhile
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    t_gate = time.perf_counter()
    gate = subprocess.Popen([sys.executable, "-m", "deeplearning4j_torch.analysis"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        _host_sync_paths(torch, s, dev, result)
        gate_out = gate.communicate(timeout=ANALYSIS_GATE_S)[0]
    finally:
        if gate.poll() is None:
            gate.kill()
            gate.communicate()
    result["analysis_gate"] = {"exit_code": gate.returncode,
                               "summary": gate_out.strip().splitlines()[-1:],
                               "s": time.perf_counter() - t_gate}
    log(f"host syncs: {json.dumps(result)}  [{card}]")
    if gate.returncode != 0:
        raise RuntimeError(f"host syncs: the analysis gate exited {gate.returncode}:\n"
                           f"{gate_out[-3000:]}")
    return result


def _host_sync_paths(torch, s, dev, result):
    """phase_host_syncs' three paths and the fence's control, into
    `result`."""
    from deeplearning4j_torch.analysis import tracecheck as tc
    from deeplearning4j_torch.clustering import KMeansClustering
    from deeplearning4j_torch.models.zoo import AlexNet

    # 1. AlexNet: one fit group
    hwc, classes = s["alexnet"]
    net = AlexNet(input_shape=hwc, num_labels=classes).init(device=dev)
    x, y = alexnet_batches(np.random.default_rng(2301), s["group"], s["batch"], hwc,
                           classes)
    fit = lambda: net.fit(x, y, batch_size=s["batch"], steps_per_dispatch=s["group"])
    fit()   # warm: cuDNN's algorithm choice, the allocator
    _sync(torch, dev)
    net._train_step = tc.wrap(net._train_step, site="alexnet.train_step")
    tc.reset_counts()
    with tc.sync_debug("warn") as seen:
        fit()
        _sync(torch, dev)
    del net._train_step
    steps = s["group"]
    result["alexnet_fit_group"] = {
        "steps": steps, "card_syncs_per_step": seen.total() / steps,
        "spy_syncs_per_step": tc.sync_count("alexnet.train_step") / steps,
        "by_call_site": _sync_sites(seen, steps)}
    score = net.score_value
    del net, x, y
    # the fence's control: .cpu() of the score syncs, fenced_read does not
    spied = tc.watch(score, site="fence.control")
    with tc.sync_debug("warn") as fenced:
        fenced_value = tc.fenced_read(spied)
    with tc.sync_debug("warn") as plain:
        plain_value = score.cpu()
    result["fenced_read"] = {"card_syncs": fenced.total(), "spy_syncs": tc.sync_count(
        "fence.control"), "plain_cpu_card_syncs": plain.total()}
    if fenced.total() or tc.sync_count("fence.control") or \
            float(fenced_value) != float(plain_value.item()):
        raise RuntimeError(f"host syncs: fenced_read synced {fenced.total()} times on the "
                           f"card, {tc.sync_count('fence.control')} by the spy")
    if dev.type == "cuda" and not plain.total():
        raise RuntimeError("host syncs: a plain .cpu() of a device value raised no sync "
                           "warning: the card's count is not counting")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 2. the decode engine's steps
    g = DECODE_GEOMETRY
    eng, model, cache = decode_engine(g, "host_syncs", device=dev)
    try:
        rng = np.random.default_rng(2302)
        rows, n_steps = s["decode_rows"], s["decode_steps"]
        prompts = [rng.integers(0, g["vocab"], int(rng.integers(g["prompt_lo"],
                                                                g["prompt_hi"])))
                   for _ in range(rows)]
        ad = eng.adapter
        rids = [-2 - i for i in range(rows)]
        last = {}
        with eng.paused():
            try:
                for group in ad.pack_groups([(rid, np.asarray(p, np.int32))
                                             for rid, p in zip(rids, prompts)]):
                    first, fails = ad.prefill_group(group)
                    if fails:
                        raise RuntimeError(f"host syncs: prefill failed {fails!r}")
                    last.update(first)
                _sync(torch, dev)
                step = model.step
                model.step = tc.wrap(step, site="decode.model_step")
                try:
                    with tc.sync_debug("warn") as seen:
                        for _ in range(n_steps):
                            out, fails = ad.step(rids, [last[r] for r in rids])
                            if fails:
                                raise RuntimeError(f"host syncs: step failed {fails!r}")
                            last.update(out)
                        _sync(torch, dev)
                finally:
                    model.step = step
            finally:
                for rid in rids:
                    cache.free(rid)
    finally:
        eng.shutdown()
    result["decode_steps"] = {
        "steps": n_steps, "rows": rows, "card_syncs_per_step": seen.total() / n_steps,
        "spy_syncs_per_step": tc.sync_count("decode.model_step") / n_steps,
        "by_call_site": _sync_sites(seen, n_steps)}
    del eng, model, cache
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 3. k-means iterations
    k = KMEANS_FULL
    pts = torch.as_tensor(kmeans_blobs(k["n"], k["d"], k["k"], k["spread"], k["seed"]),
                          device=dev)
    its = s["kmeans_iterations"]
    km = KMeansClustering(k["k"], max_iterations=its, seed=k["seed"], device=dev)
    km._step = tc.wrap(KMeansClustering._step, site="kmeans.step")
    _sync(torch, dev)
    with tc.sync_debug("warn") as seen:
        km.fit(pts)
        _sync(torch, dev)
    ran = km.iterations_run
    result["kmeans"] = {
        "iterations": ran, "points": [k["n"], k["d"]], "k": k["k"],
        "card_syncs_per_iteration": seen.total() / ran,
        "spy_syncs_per_iteration": tc.sync_count("kmeans.step") / ran,
        "by_call_site": _sync_sites(seen, ran)}
    del pts, km


# ------------------------------------- the embeddings and SP across processes

# the device-corpus phase's geometry at 1M ids (bench.py bench_w2v's Zipf 1.05
# corpus), layer 100, cut to 25,000 sentences of 40 tokens (1M tokens), two
# epochs; two gloo ranks of one shard each on the one card
W2V_MP_FULL = dict(vocab=1_000_000, sentences=25_000, sent_len=40, layer=100, window=5,
                   negative=5, chunk=16384, steps=8, seed=1, epochs=2, device=None)
W2V_MP_RUN_S = 900   # one two-rank run


def w2v_epochs(torch, tr, toks, sids, epochs, dev):
    """`epochs` epochs of `fit_corpus`, one call each, each timed from sync
    to sync: the seconds of each."""
    out = []
    for _ in range(epochs):
        _sync(torch, dev)
        t0 = time.perf_counter()
        tr.fit_corpus(toks, sids, epochs=1)
        _sync(torch, dev)
        out.append(time.perf_counter() - t0)
    return out


def make_mp_w2v(dist, cache, s, **kw):
    return dist.ShardedWord2Vec(cache, layer_size=s["layer"], window=s["window"],
                                negative=s["negative"], chunk=s["chunk"],
                                steps_per_call=s["steps"], seed=s["seed"], **kw)


def word2vec_rank(argv):
    """One rank of phase_word2vec_across_processes (``chip_smoke.py
    --word2vec-rank``): `torch.distributed.init_process_group` over gloo at
    the given port, the corpus made from its seed, `ShardedWord2Vec` on a
    mesh of one shard per rank, `epochs` timed epochs; writes the tables
    (``<out>.rank<r>.npz``) and the epochs' seconds, losses and gather ms
    (``.json``)."""
    import argparse

    import torch
    from deeplearning4j_torch.nlp import distributed as dist
    from deeplearning4j_torch.nn import shards
    from deeplearning4j_torch.parallel.mesh import create_mesh
    p = argparse.ArgumentParser(prog="chip_smoke.py --word2vec-rank")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--size", required=True, help="the phase's geometry, JSON")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    s = json.loads(args.size)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args.port}", world_size=args.world,
        rank=args.rank)
    try:
        cache, _, toks, sids = zipf_corpus(s["vocab"], s["sentences"], s["sent_len"])
        dev = torch.device(args.device)
        mesh = create_mesh(devices=[dev] * args.world, processes=list(range(args.world)))
        tr = make_mp_w2v(dist, cache, s, mesh=mesh)
        shards.cross_ms["word2vec"] = 0.0
        epoch_s = w2v_epochs(torch, tr, toks, sids, s["epochs"], dev)
        np.savez(f"{args.out}.rank{args.rank}.npz",
                 **{k: v.float().cpu().numpy() for k, v in tr.tables.items()})
        with open(f"{args.out}.rank{args.rank}.json", "w") as f:
            json.dump({"epoch_s": epoch_s, "tokens": len(toks),
                       "last_losses": tr.last_losses.float().cpu().numpy().tolist(),
                       "gather_ms": shards.cross_ms["word2vec"],
                       "positions": tr._positions}, f)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    return 0


def run_script_ranks(argv_of, n, run_s):
    """`n` processes of this script, rank r with `argv_of(r)`: (outputs,
    wall s). Raises unless every rank exits 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__)] + argv_of(r),
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(n)]
    outs = [None] * n
    try:
        for r, proc in enumerate(procs):
            outs[r] = proc.communicate(timeout=max(1.0, run_s - (time.perf_counter() - t0)))[0]
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop_processes([p for p in procs if p.poll() is None], timeout=5)
    rcs = [p.returncode for p in procs]
    if rcs != [0] * n:
        raise RuntimeError(f"ranks exited {rcs}:\n" + "\n".join(
            (o or "")[-3000:] for o in outs))
    return outs, time.perf_counter() - t0


def phase_word2vec_across_processes(torch, card, device=None, size=None):
    """`ShardedWord2Vec` on a mesh that spans two gloo ranks on the one card
    (each rank one shard; `chip_smoke.py --word2vec-rank`, spawned as
    phase_multihost spawns its ranks), at 1M ids and layer 100 over
    W2V_MP_FULL's corpus: the counts all-reduced and every shard's rows and
    contributions all-gathered over the group each chunk. Held: each rank's
    tables after `epochs` epochs against the one-process two-shard mesh on
    the card (`data_parallel_mesh(devices=[card, card])`) over the same
    tokens, within the mesh's tolerance (rtol 2e-4, atol 2e-5; the card's
    index_add_ sums in no fixed order), the two ranks against each other, and
    every loss finite. Words/s of the last epoch, both ways. No hand-written
    kernel runs here: every count stays 0."""
    import tempfile

    from deeplearning4j_torch.nlp import distributed as dist
    from deeplearning4j_torch.parallel.mesh import data_parallel_mesh
    s = dict(W2V_MP_FULL, **(size or {}))
    dev = torch.device(device or "cuda:0")
    rank_dev = s["device"] or str(dev)
    result = {"card": card, "geometry": {k: s[k] for k in (
        "vocab", "sentences", "sent_len", "layer", "window", "negative", "chunk",
        "steps", "seed", "epochs")}}
    cache, _, toks, sids = zipf_corpus(s["vocab"], s["sentences"], s["sent_len"])
    zero_launches()
    one = make_mp_w2v(dist, cache, s, mesh=data_parallel_mesh(devices=[dev, dev]))
    one_s = w2v_epochs(torch, one, toks, sids, s["epochs"], dev)
    launches = all_launches()
    check_launches("word2vec across processes", launches, dict.fromkeys(launches, 0))
    want = {k: v.float().cpu().numpy() for k, v in one.tables.items()}
    one_losses = one.last_losses.float().cpu().numpy()
    del one
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_w2v_mp_")
    try:
        prefix = os.path.join(tmp.name, "w2v")
        port = free_port()
        _, wall = run_script_ranks(lambda r: [
            "--word2vec-rank", "--rank", str(r), "--world", "2", "--port", str(port),
            "--device", rank_dev, "--size", json.dumps(s), "--out", prefix], 2, W2V_MP_RUN_S)
        ranks, reports = [], []
        for r in range(2):
            with np.load(f"{prefix}.rank{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
            with open(f"{prefix}.rank{r}.json") as f:
                reports.append(json.load(f))
    finally:
        tmp.cleanup()
    excess, rel = {}, {}
    for name, w in want.items():
        a = ranks[0][name]
        excess[name] = float((np.abs(a - w) - (W2V_SHARD_ATOL + W2V_SHARD_RTOL
                                                 * np.abs(w))).max())
        rel[name] = float(np.abs(a - w).max() / max(np.abs(w).max(), 1e-30))
    between = max(float(np.abs(ranks[0][k] - ranks[1][k]).max()) for k in want)
    tokens = len(toks)
    result.update(
        tokens=tokens, vocab_size=len(cache),
        one_process={"epoch_s": one_s, "words_per_s": tokens / one_s[-1]},
        two_ranks={"epoch_s": [rep["epoch_s"] for rep in reports],
                   "words_per_s": tokens / max(rep["epoch_s"][-1] for rep in reports),
                   "gather_ms": [rep["gather_ms"] for rep in reports],
                   "positions": [rep["positions"] for rep in reports], "wall_s": wall},
        rel_vs_one_process=rel, excess_over_tolerance=excess,
        ranks_max_abs_diff=between,
        bitwise_vs_one_process=all(np.array_equal(ranks[0][k], want[k]) for k in want))
    losses = [np.asarray(rep["last_losses"]) for rep in reports] + [one_losses]
    log(f"word2vec across processes: {json.dumps(result)}  [{card}]")
    log(f"word2vec across processes: one process (2 shards) "
        f"{result['one_process']['words_per_s']:.0f} words/s, two gloo ranks "
        f"{result['two_ranks']['words_per_s']:.0f} words/s over {tokens} tokens  [{card}]")
    if max(excess.values()) > 0 or not all(np.isfinite(l).all() for l in losses):
        raise RuntimeError(f"word2vec across processes: tables {json.dumps(excess)} beyond "
                           f"rtol {W2V_SHARD_RTOL}, atol {W2V_SHARD_ATOL} of one process")
    if between > W2V_SHARD_ATOL:
        raise RuntimeError(f"word2vec across processes: the ranks differ by {between}")
    return result


SP_MP_FULL = dict(SP_FULL, layers=2, device=None)   # device None: cuda:0
SP_OUTPUT_HOLD = 1e-4   # phase_sequence_parallel's output limit (max abs)


def phase_sequence_parallel_output_across_processes(torch, card, device=None,
                                                     size=None):
    """`SequenceParallelWrapper.output` with time cut over two gloo ranks on
    the one card (`multihost.main --mode sp --epochs 0 --output`, 2 seq
    shards a rank, a seq axis of 4): the char model at phase_sequence_
    parallel's width (2 causal SelfAttentionLayers of 512, 4 heads of 128,
    vocabulary 96) at t 8192 and batch 4, every rank fed the whole batch,
    every rank returning the whole output. Held within SP_OUTPUT_HOLD (max
    abs) against the one-process SP `output` over 4 shards on the card and
    against the plain `output`; the two ranks bitwise alike. K3 launches
    layers x shards x hops (each rank its layers x 2 x 4) for the ranks'
    forward, and as many for the one-process one (counts reset just before
    and read just after); output ms of each, the second of two calls."""
    import tempfile

    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.ops import flash_attention as fa
    from deeplearning4j_torch.parallel import SequenceParallelWrapper, seq_parallel_mesh
    s = dict(SP_MP_FULL, **(size or {}))
    dev = device or "cuda:0"
    rank_dev = s["device"] or dev
    shards_per_rank, n_ranks = 2, 2
    n = shards_per_rank * n_ranks
    conf = sp_conf(s, layers=s["layers"])
    ds = sp_data(s, s["batch"], s["t"], seed=2194)
    x = ds.features
    result = {"card": card, "t": s["t"], "batch": s["batch"], "seq_shards": n,
              "layers": s["layers"]}
    # on the CPU (the tests) the wrappers run the plain version: no launch
    want_k3 = s["layers"] * n * n if torch.device(dev).type == "cuda" else 0
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sp_mp_")
    try:
        conf_path = os.path.join(tmp.name, "sp.json")
        with open(conf_path, "w") as f:
            f.write(conf.to_json())
        npz = os.path.join(tmp.name, "sp.npz")
        np.savez(npz, x=x, y=ds.labels)
        prefix = os.path.join(tmp.name, "run")
        _, _, wall = run_ranks(["--conf", conf_path, "--data", npz, "--epochs", "0",
                                "--batch-size", str(s["batch"]), "--device", rank_dev,
                                "--backend", "gloo", "--exact-float32", "--mode", "sp",
                                "--output", "--out", prefix], free_port())
        outs, reports = [], []
        for r in range(n_ranks):
            outs.append(np.load(f"{prefix}.sp.rank{r}.output.npy"))
            with open(f"{prefix}.sp.rank{r}.json") as f:
                reports.append(json.load(f))
    finally:
        tmp.cleanup()
    net = MultiLayerNetwork(conf).init(device=dev)
    w = SequenceParallelWrapper(net, seq_parallel_mesh(devices=[dev] * n))
    w.output(x), net.output(x)   # warm, as the ranks warm
    _sync(torch, dev)
    zero_launches()   # the one-process SP output starts here
    t0 = time.perf_counter()
    one = w.output(x)
    one_ms = (time.perf_counter() - t0) * 1e3
    launches = all_launches()   # ... and ends here
    want = dict.fromkeys(launches, 0)
    want["flash_fwd"] = want_k3
    check_launches("sequence parallel output, one process", launches, want)
    _sync(torch, dev)
    t0 = time.perf_counter()
    plain = net.output(x)
    plain_ms = (time.perf_counter() - t0) * 1e3
    rank_k3 = [rep["output_launches"]["flash_fwd"] for rep in reports]
    err_one = max(float(np.abs(o - one).max()) for o in outs)
    err_plain = max(float(np.abs(o - plain).max()) for o in outs)
    result.update(
        ranks={"output_ms": [rep["output_ms"] for rep in reports],
               "k3_launches": rank_k3,
               "gather_ms": [rep["output_cross_ms"]["output"] for rep in reports],
               "hop_ms": [rep["output_cross_ms"]["hop"] for rep in reports],
               "wall_s": wall},
        one_process={"output_ms": one_ms, "k3_launches": launches["flash_fwd"]},
        plain_output_ms=plain_ms, k3_launches_total=sum(rank_k3),
        k3_launches_expected=want_k3, max_abs_vs_one_process=err_one,
        max_abs_vs_plain=err_plain, hold=SP_OUTPUT_HOLD,
        ranks_bitwise=bool(np.array_equal(outs[0], outs[1])),
        shape=list(outs[0].shape))
    log(f"sequence parallel output across processes: {json.dumps(result)}  [{card}]")
    if sum(rank_k3) != want_k3 or any(k != want_k3 // n_ranks for k in rank_k3):
        raise RuntimeError(f"sequence parallel output across processes: K3 launches "
                           f"{rank_k3}, expected {want_k3 // n_ranks} a rank")
    if not (err_one <= SP_OUTPUT_HOLD and err_plain <= SP_OUTPUT_HOLD
            and result["ranks_bitwise"] and np.isfinite(outs[0]).all()
            and outs[0].shape == plain.shape):
        raise RuntimeError(f"sequence parallel output across processes: off the "
                           f"one-process output by {err_one}, the plain by {err_plain}, "
                           f"ranks bitwise {result['ranks_bitwise']}")
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = phase_header(torch)
    phase_build()
    lrn_entry = phase_lrn(torch, card)
    lrn_bwd_entry = phase_lrn_bwd(torch, card)
    flash_entries, flash_rows = phase_flash(torch, card)
    int8_entry, _ = phase_int8(torch, card)
    decode_entry, _ = phase_decode_kernel(torch, card)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    wide_entries, _ = phase_wide_kernels(torch, card)
    wide_s = {"kernels": time.perf_counter() - t1}
    torch.cuda.empty_cache()
    phase_embedding_guard(torch, card)
    phase_checkpoint_fixtures(torch, card)
    serving, net, reqs, answers, cpu_net = phase_serving(torch, card)
    quant = phase_quant_serving(torch, card, net, reqs, answers, cpu_net, serving)
    del answers
    del net, cpu_net
    torch.cuda.empty_cache()
    gateway = phase_gateway(torch, card)
    torch.cuda.empty_cache()
    training = phase_training(torch, card)
    torch.cuda.empty_cache()
    fit_loop = phase_fit_loop_alexnet(torch, card)
    torch.cuda.empty_cache()
    images = phase_image_directory_alexnet(torch, card)
    torch.cuda.empty_cache()
    phase_vae_mnist(torch, card)
    phase_dbn_mnist(torch, card)
    phase_records_export(torch, card)
    torch.cuda.empty_cache()
    phase_bf16_alexnet(torch, card)
    torch.cuda.empty_cache()
    phase_googlenet_serving(torch, card)
    torch.cuda.empty_cache()
    phase_googlenet_training(torch, card)
    torch.cuda.empty_cache()
    _, resnet = phase_resnet_training(torch, card)
    phase_resnet_serving(torch, card, resnet)
    del resnet
    torch.cuda.empty_cache()
    phase_resnet_bf16_training(torch, card)
    torch.cuda.empty_cache()
    phase_text_generation(torch, card)
    phase_rnn_checkpoint(torch, card)
    torch.cuda.empty_cache()
    for name, hwc, classes in FACE_MODELS:
        phase_face_model(torch, card, name, hwc, classes)
        torch.cuda.empty_cache()
    phase_attention_dispatch(torch, card)
    char = phase_char_model(torch, card)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    char_wide = phase_char_model_wide(torch, card)
    wide_s["char_model"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    fit_char = phase_fit_loop_char(torch, card)
    torch.cuda.empty_cache()
    decode = phase_decode_serving(torch, card)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    decode_wide = phase_decode_wide(torch, card)
    wide_s["decode"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    phase_decode_stream(torch, card)
    packed = phase_packed_admission(torch, card)
    torch.cuda.empty_cache()
    federation = phase_federation(torch, card)
    torch.cuda.empty_cache()
    wrapper = phase_parallel_wrapper(torch, card)
    torch.cuda.empty_cache()
    pserver = phase_param_server(torch, card)
    torch.cuda.empty_cache()
    multihost = phase_multihost(torch, card)
    torch.cuda.empty_cache()
    ring = phase_ring_kernels(torch, card, flash_rows)
    torch.cuda.empty_cache()
    seq_par = phase_sequence_parallel(torch, card, char)
    torch.cuda.empty_cache()
    tensor_par = phase_tensor_parallel(torch, card)
    torch.cuda.empty_cache()
    pipe = phase_pipeline(torch, card)
    torch.cuda.empty_cache()
    mh_tp_sp = phase_multihost_tp_sp(torch, card)
    embed_s = {}
    for name, phase in (("device_corpus", phase_word2vec_device_corpus),
                        ("builder", phase_word2vec_builder),
                        ("doc_and_graph", phase_doc_and_graph_embeddings)):
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        embed_s[name] = (phase(torch, card), time.perf_counter() - t1)
    lrn_entry["launches"] = serving["launches"]["lrn_fwd"]
    lrn_bwd_entry["launches"] = training["launches"]["lrn_bwd"]
    for entry in flash_entries:
        entry["launches"] = char["bf16"]["launches"][entry["name"]]
    int8_entry["launches"] = quant["int8"]["launches"]["int8_matmul"]
    decode_entry["launches"] = decode["launches"]["decode_attention"]
    for entry in wide_entries:   # the accumulator's arms carry their path's counts
        if entry["name"] in char_wide["f32"]["launches"] and entry["launches"] is None:
            entry["launches"] = char_wide["f32"]["launches"][entry["name"]]
        if entry["name"] == "decode_attention_wide":
            entry["launches"] = decode_wide["launches"]["decode_attention_wide"]
    kernels = {"kernels": [lrn_entry, lrn_bwd_entry] + flash_entries
               + [int8_entry, decode_entry] + wide_entries}
    log(f"chip_smoke: heads wider than 128: the wide char model (4 heads of 256) "
        f"{char_wide['f32']['tokens_per_s']:.0f} tokens/s f32, "
        f"{char_wide['bf16']['tokens_per_s']:.0f} bf16, launches "
        f"{json.dumps({k: v for k, v in char_wide['f32']['launches'].items() if v})} "
        f"(f32 fit); the wide decoder {decode_wide['tokens_per_s']:.1f} tokens/s, "
        f"inter-token p99 {decode_wide['inter_token_p99_ms']:.3f} ms, a profiled step busy "
        f"{decode_wide['step_profile'].get('device_busy_ms')} ms, K7w's share "
        f"{decode_wide['step_profile'].get('kernel_share_of_busy')}, K7w "
        f"{decode_wide['launches']['decode_attention_wide']} in {decode_wide['steps']} "
        f"steps; phases {json.dumps({k: round(v, 1) for k, v in wide_s.items()})} s  "
        f"[{card}]")
    log(f"chip_smoke: the image-directory AlexNet fit's launches: K1 "
        f"{images['launches']['lrn_fwd']}, K2 {images['launches']['lrn_bwd']} in "
        f"{images['steps']} steps, ETL calls {json.dumps(images['etl_calls'])}")
    log(f"chip_smoke: the fit loop's launches: AlexNet {json.dumps(fit_loop['launches'])}, "
        f"packed char model {json.dumps(fit_char['launches'])}; decode serving K7 "
        f"{decode['launches']['decode_attention']} in {decode['steps']} steps; packed "
        f"admission K3 {packed['launches']['flash_fwd']} in "
        f"{packed['packed_forwards']} packed forwards; the gateway's K1 "
        f"{gateway['launches']['lrn_fwd']} (storm), K6 "
        f"{gateway['launches']['int8_matmul']} (int8 run), K7 "
        f"{gateway['launches']['decode_attention']} (/generate)")
    log(f"chip_smoke: scale-out launches: federation replicas "
        f"{json.dumps(federation['replica_launches'])}; ParallelWrapper sync "
        f"{json.dumps(wrapper['sync']['launches'])}, local SGD "
        f"{json.dumps(wrapper['local_sgd']['launches'])}; parameter server "
        f"{json.dumps(pserver['one_worker']['launches'])} (one worker), "
        f"{json.dumps({k: w['launches'] for k, w in pserver['workers'].items()})} "
        f"(racing, by max_staleness); runner rank 0 "
        f"{json.dumps(multihost['sync']['launches_rank0'])}")
    log(f"chip_smoke: tensor, sequence and pipeline parallelism: ring hops "
        f"{len(ring['hops'])} held; sequence parallel f32 step "
        f"{json.dumps(seq_par['f32_step']['launches'])}, bf16 fit "
        f"{json.dumps(seq_par['bf16']['launches'])}; tensor parallel step "
        f"{json.dumps(tensor_par['step']['launches'])}; pipeline bubble "
        f"{pipe['bubble_fraction']:.4f}; across ranks tp "
        f"{mh_tp_sp['tp']['ranks_max_abs_diff']}, sp "
        f"{mh_tp_sp['sp']['ranks_max_abs_diff']}")
    (w2v, w2v_s), (builder, builder_s), (docs, docs_s) = embed_s.values()
    log(f"chip_smoke: word and graph embeddings (no hand-written kernel; every count 0): "
        f"device corpus {w2v['words_per_s']:.0f} words/s at 1M ids ({w2v_s:.1f} s), "
        f"builder {builder['words_per_s']:.0f} words/s ({builder_s:.1f} s), docs and "
        f"graphs {docs_s:.1f} s  [{card}]")
    cluster_s = {}
    for name, phase in (("knn", phase_knn), ("kmeans", phase_kmeans), ("tsne", phase_tsne),
                        ("keras_import", phase_keras_import)):
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cluster_s[name] = (phase(torch, card), time.perf_counter() - t1)
    (knn, knn_s), (km, km_s), (ts, ts_s), (keras, keras_s) = cluster_s.values()
    log(f"chip_smoke: clustering, k-NN and Keras import (no hand-written kernel; every "
        f"K1-K7 count 0): k-NN {knn['euclidean']['queries_per_s']:.0f} queries/s "
        f"euclidean, {knn['cosine']['queries_per_s']:.0f} cosine ({knn_s:.1f} s); k-means "
        f"{km['iterations_per_s']:.1f} iterations/s ({km_s:.1f} s); t-SNE "
        f"{ts['ms_per_step']:.3f} ms a step, calibration {ts['calibration_s']:.1f} s "
        f"({ts_s:.1f} s); Keras /fit {keras['mnist_cnn']['fit']['images_per_s']:.0f} "
        f"images/s ({keras_s:.1f} s)  [{card}]")
    obs = {}
    for name, phase in (("training_ui", phase_training_ui),
                        ("streaming_route", phase_streaming_route),
                        ("estimators", phase_estimators),
                        ("churn_and_locks", phase_churn_and_locks)):
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        obs[name] = (phase(torch, card), time.perf_counter() - t1)
    (tui, tui_s), (route, route_s), (est, est_s), (cl, cl_s) = obs.values()
    log(f"chip_smoke: training observability, streaming and the estimators: "
        f"AlexNet fit {tui['step_ms']['plain']:.3f} ms a step plain, "
        f"{tui['step_ms']['stats_listener']:.3f} ms with a StatsListener "
        f"({tui['record_host_bytes']} bytes to the host a record in "
        f"{tui['record_transfers']} transfers, launches {json.dumps(tui['launches'])}, "
        f"{tui_s:.1f} s); ServeRoute {route['images_per_s']:.2f} images/s (launches "
        f"{json.dumps(route['launches'])}, {route_s:.1f} s); MLNClassifier fit "
        f"{est['images_per_s']:.0f} images/s (launches {json.dumps(est['launches'])}, "
        f"{est_s:.1f} s); churn guard {cl['churn']['counter']:.0f} over the threshold "
        f"(launches {json.dumps(cl['churn']['launches'])}), lock edges observed "
        f"{json.dumps(cl['locks']['observed'])} (launches "
        f"{json.dumps(cl['locks']['launches'])}, {cl_s:.1f} s)  [{card}]")
    late = {}
    for name, phase in (("host_syncs", phase_host_syncs),
                        ("word2vec_across_processes", phase_word2vec_across_processes),
                        ("sp_output_across_processes",
                         phase_sequence_parallel_output_across_processes)):
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        late[name] = (phase(torch, card), time.perf_counter() - t1)
    (hs, hs_s), (w2v_mp, w2v_mp_s), (sp_mp, sp_mp_s) = late.values()
    k3 = next(e for e in kernels["kernels"] if e["name"] == "flash_fwd")
    k3["launches_by_path"] = {"char_model_bf16_fit": k3["launches"],
                              "sp_output_across_processes": sp_mp["k3_launches_total"]}
    log(f"chip_smoke: host syncs a step (card / spies): AlexNet fit "
        f"{hs['alexnet_fit_group']['card_syncs_per_step']:g} / "
        f"{hs['alexnet_fit_group']['spy_syncs_per_step']:g}, decode "
        f"{hs['decode_steps']['card_syncs_per_step']:g} / "
        f"{hs['decode_steps']['spy_syncs_per_step']:g}, k-means "
        f"{hs['kmeans']['card_syncs_per_iteration']:g} / "
        f"{hs['kmeans']['spy_syncs_per_iteration']:g}; analysis gate exit "
        f"{hs['analysis_gate']['exit_code']} ({hs_s:.1f} s); word2vec across two ranks "
        f"{w2v_mp['two_ranks']['words_per_s']:.0f} words/s against "
        f"{w2v_mp['one_process']['words_per_s']:.0f} in one process ({w2v_mp_s:.1f} s); "
        f"SP output across two ranks {max(sp_mp['ranks']['output_ms']):.1f} ms against "
        f"{sp_mp['one_process']['output_ms']:.1f} in one process, K3 "
        f"{sp_mp['k3_launches_total']} launches ({sp_mp_s:.1f} s)  [{card}]")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s  [{card}]")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--word2vec-rank"]:
        sys.exit(word2vec_rank(sys.argv[2:]))
    sys.exit(main())
