"""Smoke run of the PyTorch port (fenet_torch) on one CUDA card.

    python3 chip_smoke.py [--phases a,b,...]

With no arguments it runs every phase below, which is the whole check. For
development, ``--phases`` runs a chosen set in the same order, with the
phases whose results they take (``timing`` and ``wide``'s own eval and
train, ``analysis`` after ``eval``, ``serve`` after ``deploy``, ``parallel``
after ``data``, ``viz`` after ``goldens``): kernels, eval, train, timing,
plan, analysis, pix3d, deploy, serve, data, parallel, goldens, viz,
checkpoint, tools, wide (the 2048-point eval, train and timing), d2se,
adam.

Builds the hand-written CUDA kernels from ``fenet_torch/csrc`` and drives
the port's eval path (RepVGG-A2 generator -> batched ICP -> auction EMD +
chamfer), its training step (train-mode generator -> 100·CD + 100·EMD ->
backward -> Adam), its finetune step (the same plus 100·BCE of the
projected silhouettes), its Pix3D evaluation, its serving path (deploy
fold, export_deploy, the HTTP server, predict) and its on-disk data path
(prepare_data, the native batch loader, train_net fed from a written tree),
its parallel training (two ranks on torch.distributed, dp with sync-BN;
NCCL in a world of one), and
the rest (fscore, the dense auction and the Sinkhorn loss above 8192
points, the reference's golden metrics, a profiler trace,
the golden-table recorder, Grad-CAM, SimpleGenerator and the render and
heatmap CLIs), and fenet's flax and orbax checkpoint containers (train,
resume, eval and deploy through them), and the port's three evidence
tools (eps-scaling and Sinkhorn training equivalence, finetune convergence)
at full width with seeded random weights, at 1024 points and again at
2048 (phases 4-6 below, run at each; the Pix3D, serving, data, parallel,
analysis, goldens, viz, checkpoint and tools phases at 1024). Each phase
prints one JSON line; any failure raises, and the script exits non-zero.

1. device: requires a CUDA card; prints nvidia-smi's name and power limit.
2. build: compiles every kernel in parallel and prints the build seconds.
3. kernels: each kernel against its plain PyTorch version. Chamfer NN (K1)
   and the fixed-eps auction (K3) at the eval shapes (B=64, N=M=1024):
   bit-exact on dyadic inputs (coordinates k/64, where every product and
   sum is exact); on random normal inputs the chamfer distances agree to
   1e-5 and the EMD metric to 1e-2 relative (K1 splits M across blocks
   there, S > 1). K1 over M = 16384 points (K2's range, S > 1): bit-exact
   on dyadic inputs, with its device time, S and grid. The eps-scaling
   auction (K5) at B=64, N=1024 on dyadic inputs, gate open (on every element), gate closed
   (on every element; then also bit-identical to K3) and without the early
   exit: bit-exact. The Sinkhorn
   potentials (K6/K7) at B=128, N=M=1024 and at N=M=2048 and 8192 with a
   small batch: rtol 1e-4, atol 1e-5. The stream auction (K4) at N = 2048,
   4096, 8192, 1100 and 5000 on dyadic inputs, bit-exact: fixed eps at the
   eval and train settings, eps-scaling with the gate open (on every
   element), closed (on every element; then also the fixed-eps result) and
   without the early exit; on normal inputs the EMD metric to 1e-2. The
   auction's square root (branch-free, with a slow path for tiny and
   non-positive d) against __fsqrt_rn(max(d, 0)) on all 2^32 float bit
   patterns: no pattern may differ.
   plan: the Sinkhorn loss's fused plan (csrc/sinkhorn_plan.cu) at the
   2048-point train shape (PLAN_SHAPE) on K7's potentials, against
   pairwise_sqdist + plan_loss: the loss to 1e-5 relative, the prediction's
   gradient and, with gt requiring one (the column pass), gt's to 1e-4 of
   the largest element; one row launch a call, a column launch only for
   gt's gradient. The row and column kernels' device ms beside their bounds
   (operations and exponentials; issued instructions), the fused and the
   plain loss's ms (forward, and forward with backward), and each one's peak
   memory above its inputs: the fused one's must stay under one (B, N, M)
   float32 tensor.
4. eval: evaluate_dataset over SyntheticShapeNet(n_models=6) at batch 64
   with ICP on; the kernels' launch counts must rise by 2 (chamfer) and 1
   (EMD: K3 at 1024 points, K4 at 2048) per batch. Then, as the reference,
   each stage of the step against the same stage on the CPU (the plain
   versions) on identical small inputs.
5. train: Trainer.train_step at batch 128 over SyntheticShapeNet(variety=
   True) in each EMD mode (auction, eps-scaling auction, Sinkhorn): one
   warm-up step, then three steps on one repeated batch with the counts set
   to 0: 2 chamfer launches, 1 EMD launch and 1 launch of the Adam pass
   over every parameter element with a gradient per step, finite losses, the
   total falling from step 1 to step 3; each step's ms on the host clock and
   between CUDA events around it (the device's timeline, its idle gaps
   included); the step's ms split into forward,
   loss, backward and Adam; one step profiled; the chamfer backward twice on
   identical inputs, which must give identical bits; train_net for 2 epochs
   with validation at epoch 2, whose checkpoint must load back with
   strict=True; and (at 1024 points) one train step on the card against the
   same step on the CPU from identical weights. The Sinkhorn mode launches
   the fused plan once a step, the other modes never.
   Each mode also counts the gate's open elements on every step's clouds
   (eps-scaling) and the host syncs of one step (PyTorch's sync debug mode).
   finetune: Trainer(loss_mode="finetune") on the same batch from the
   unscaled init, one warm-up step and three counted ones (2 chamfer
   launches and 1 auction launch a step, finite losses), timed and split
   (forward, CD, EMD, projection + BCE, backward, Adam), its peak memory,
   host syncs and profile, and one step with proj_squash. finetune_net (at
   1024 points): train_net(loss_mode="finetune") resumes from train_net's
   epoch-2 checkpoint for one epoch. At 1024 points also one finetune step
   on the card against the CPU (BCE and CD losses 1e-5, EMD 1e-2, fc3_1's
   gradient 1e-2 relative L2).
   pix3d (at 1024 points): a synthetic Pix3D tree under build/, the eval
   init saved for the three mapped ShapeNet ids, eval_pix3d's entry point on
   the card: 2 chamfer launches and 1 auction launch a batch, finite
   metrics, samples/s, and the generator, ICP and EMD ms of a first batch.
6. timing: each kernel, its plain version and, where one exists, a PyTorch
   library call, timed with CUDA events on the inputs its path gave it;
   bounds from this run's work at the H100's published peaks (the auction's
   square roots at the special-function rate; its rows also carry
   ``bound_per_sm_ms``, the slowest element's pairs at 16 roots a clock on
   the one SM its CTA holds). On the train
   step's batch-128 clouds K1 (both directions, at 1024 and 2048 points,
   with S = 1: one launch and no key buffer) and K5 must equal their
   plain versions bit for bit and K6 must agree to rtol 1e-4, atol 1e-5; at
   2048 points K4 must equal its plain version on the first 32 train clouds
   and agree to 1e-2 in the EMD metric on the eval batch, and K7 must agree
   to rtol 1e-4, atol 1e-5. For K6 and K7 the Sinkhorn loss from their
   potentials must also be within SINKHORN_LOSS_REL_LIMIT of the loss from
   the plain potentials (``loss_rel_err``). K1's time is device time
   (CUDA-graph replays), beside its FLOP bound and its issue-slot floor
   (``issue_bound_ms``), on the eval batch and on the train clouds.
7. deploy (at 1024 points, after pix3d): the eval init with seeded random
   BN statistics folded by to_deploy in float32 and bf16. Asserted: the
   float32 fold against the branched eval forward within FOLD_REL_LIMIT of
   max|ref|, bf16 against float32 within BF16_REL_LIMIT, the float32 fold
   on the card against the CPU at batch 2 within 1e-4. The branched
   forward and both folds' CUDA-event ms and images/s at DEPLOY_BATCHES,
   and the peak memory.
8. serve: those weights as a .pth.tar under build/ (deleted after);
   export_deploy in both formats and both dtypes (sizes, export and load
   seconds; each .pt2 within ARTIFACT_REL_LIMIT of its module); the HTTP
   server on the bf16 artifact at max_batch 32 and a 5 ms window, driven
   by 64 client threads (a process of their own) with 1024 PNG renders in
   all (requests/s, p50 and p99 latency, the mean batch fill, the
   forwards' CUDA-event ms over the wall); /stats must read 1024 served and 0 errors the moment the last
   reply is in. Between the server and predict: the forward over every
   visible card (its count printed), then two replicas on one card at
   max_batch 33 (rounded to 34): the float32 fold and the bf16 .pt2 against
   their one-device forwards (SPLIT_REL_LIMIT, BF16_REL_LIMIT), with no
   host sync inside the split forward, and the server again on the bf16
   .pt2 through the two replicas. Then the predict CLI over 64 PNGs at
   --batchSize 32 (images/s); one PLY read back must equal its image's
   forward row. The serving path launches none of the kernels, and each of
   these runs asserts so with the counts set to 0 before it.
9. data (at 1024 points, after serve): builds the native loader
   (fenet_torch/native/loader.cpp, g++ and zlib) and writes a synthetic
   tree under build/ (DATA_MODELS models, 384 samples; one cloud with
   duplicated points). prepare_data on the card and on the CPU (on a copy)
   must write byte-identical files; one FPS call must make no host sync
   (sync debug mode "error"). One batch of 128 (variety, uint8) and one
   with multi_resolution (float32), natively and per item: byte-equal, ms
   and images/s, the native images at 1-8 threads. train_net for one epoch
   of 3 steps at batch 128 fed from the tree, natively and per item: K1 2
   and the auction 1 launch a step, every batch counted native (or
   declined), step and data-wait ms against the train phase's in-memory
   step.
10. parallel (at 1024 points, after data, whose tree it reads and then
   deletes): ranks in processes of their own (``python -m
   fenet_torch.tools.parallel_smoke``), two on the one card over gloo
   (NCCL refuses two ranks on one GPU), each under RANK_TIMEOUT_S. A dp=2
   pair with sync-BN: one step from phase train's init on its 64 rows of
   phase train's batch, against the one-process batch-128 step here (CD,
   EMD, and with the one-process assignment replayed, gradients:
   PARALLEL_LIMITS), then step ms, the gradient all-reduce's ms and K1 2 /
   K3 1 launches a step; train_net for one epoch of 3 steps with
   validation from the tree, every batch native, then a run that resumes
   from its checkpoint (rank 0 loads it and broadcasts) for epoch 2. NCCL
   in a world of one, joined through
   fenet's environment variables: its collectives on a CUDA tensor and a
   one-step train_net.

11. analysis (at 1024 points, after timing): fscore on the eval batch's
   aligned clouds at FSCORE_THRESHOLDS against the CPU (within one point a
   cloud), K1 2 launches a call; the dense auction (earth_mover_distance
   above 8192 points) at DENSE_SHAPE in eval settings on dyadic clouds
   against the CPU (bit for bit, and the EMD metric to 1e-2), its calls
   counted apart and no kernel launched, its time and peak memory; the
   Sinkhorn potentials above the kernel's 8192 points (SINKHORN_LARGE, the
   plain version on the card) against the CPU at rtol 1e-4 / atol 1e-5, the
   kernel wrapper raising there, and one Trainer(emd_impl="sinkhorn") step
   at 8448 points, batch 2, full width (finite losses, K1 2, the fused
   plan 1): no K6/K7 launch; K1 and K3 on the reference's four golden pairs of clouds
   (tests/goldens/metric_goldens.npz) at tests/test_reference_parity.py's
   bounds, the auction also at 3000 iterations within 0.5% above the
   optimal matching; profiling.trace over one eval step, which must write
   one Chrome trace holding CUDA kernel events.
12. goldens (after parallel): record_goldens at full width, the eval init
   as one .pth.tar, on a synthetic tree of the 13 categories (one model, 24
   views; GOLDENS_EMPTY without data, so skipped), batch 64, strict ICP: K1
   2 and K3 1 launches a batch, samples/s, one batch's stages (ICP's
   share); one category through the same CLI with --device cpu against the
   card (CD GOLDENS_CD_REL, EMD GOLDENS_EMD_REL).
13. viz (on goldens' tree and checkpoint): the heatmap CLI without and with
   --layer, and, where matplotlib is installed (looked up first), the
   render CLI plain and --deploy and render_pix3d twice (its skip rule),
   each writing the files fenet's would, with no kernel launch; Grad-CAM on
   the card against the CPU (GRADCAM_ATOL) at the final map and stage3, and
   SimpleGenerator's forward against the CPU (1e-4 of max|ref|).
14. checkpoint (after viz): fenet's flax and orbax containers at full
   width. First fenet's committed orbax fixture (tests/fixtures/
   fenet_orbax: OCDBT, zstd) read on this host through libzstd.so.1, every
   leaf bit for bit against tests/make_orbax_fixture.py's seeded arrays.
   train_net for 2 epochs of one step at batch TRAIN_BATCH with
   ckpt_format "orbax", validating at epoch 2 (K1 2 and K3 1 launches a
   step and a batch); its final state saved through the three containers
   (the orbax arrays equal train_net's own directory's) and loaded back,
   weights, BN statistics, both Adam moments and the step bit for bit;
   save and load seconds and GB/s, and a load's peak resident set in a CPU
   process of its own. A third epoch resumed from each container's
   model_best: identical CD and EMD. eval_shapenet on a tree holding only
   model_best.orbax, only model_best.ckpt or only model_best.pth.tar:
   identical metrics. export_deploy --format flax from the .ckpt and from
   the .orbax (the same bytes) and --format torch, in float32 and bf16,
   predict from each: the clouds equal the torch files' bit for bit, no
   kernel launched. Last the .orbax's chunks compressed with zstd at
   fenet's level 1 (ZSTD_compress) and loaded, timed, bit for bit.
15. tools (after checkpoint): python -m fenet_torch.tools.{eps_scaling_equiv,
   sinkhorn_equiv,finetune_convergence} at their defaults (A2, 1024 points;
   two arms of 24 steps at batch 128; 20 warm and twice 30 finetune steps
   at batch 32), records into a temporary directory: each arm's launches
   (the counts set to 0 before it) and per-step ms, the walls, their ratio,
   the cross-eval, the finetune pass rule. Every loss finite, the pass rule
   holding, each arm's kernel launched (K3 in the strict, adaptive and
   auction arms, K5 in the adaptive one, K6 in the Sinkhorn one), both arms
   of a tool at the same step-0 chamfer loss (rtol 1e-6).
16. d2se: the gate (ops/se_gate.py) at each of D2se's five gate shapes at
   batch 128 (D2SE_GATE_SHAPES): the backward's kernels (csrc/se_gate.cu)
   against the plain formulas (the five gradients within GATE_REL_LIMIT of
   each one's largest), the same bits on a second call, BACKWARD_LAUNCHES
   launches counted a backward and none a forward, the device operations a
   call of each direction and of the eager gate's under the profiler (over
   GATE_PROFILED calls), and each direction's device ms beside its bytes at
   PEAK_BYTES_PER_S and beside the eager gate's ms (the forward is PyTorch's
   operations with no autograd recording; eager's records). Then the
   generator on RepVGG-D2se (48 blocks, each with a squeeze-and-excite gate)
   at 1024 points, one train step at batch 8
   after a warm-up step: by CUDA events with no profiler, the gates'
   counter (``repvgg.se_work``) unmoved and the gate's kernels launched 48 x
   BACKWARD_LAUNCHES times; under a profiler, 48 gate
   forwards and 48 backwards counted, their device ms (positive) beside
   the step's, finite losses; the Adam pass one launch a step over every
   parameter element with a gradient.
17. adam: the Adam pass (csrc/adam.cu) on A2's and D2se's parameter sets
   (seeded values and gradients): three steps against torch's foreach Adam
   on copies (the moments within 1 ulp, the parameters within 4 ulp; the
   elements that differ counted), one launch a step over every element;
   the device ms a step of the pass, of torch's Adam(fused=True)
   (library_ms), of foreach Adam (foreach_ms) and of the plain version
   beside the 28-bytes-a-parameter bound, each one's host ms a call, and
   the pass's registers and spills.

The line before the last is one JSON object with every kernel's numbers
(each also with its launches in the finetune, finetune_net, pix3d, data,
parallel, analysis, goldens, viz, checkpoint and tools phases, K5 on the
tools' arms; every kernel with its launches on the serving paths, 0); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import functools
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM3 bandwidth, at a 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Dense bf16 on the tensor cores (the same data sheet), for the bf16 fold.
PEAK_BF16_FLOPS = 989e12
# Special-function results (exp2, log2, reciprocal, ...) per second: 16 per
# clock per SM at compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput table), on 132 SMs at the H100 SXM's
# 1.98 GHz boost clock. The float32 peak above is the same table's 128
# results per clock per SM.
SFU_PER_SM_PER_S = 16 * 1.98e9
PEAK_SFU_PER_S = 132 * SFU_PER_SM_PER_S
# Float32 operations per pair evaluation: chamfer's (aa + bb) - 2ab with a
# 3-term dot, max with 0; the auction adds a square root (one
# special-function evaluation a pair) and two subtractions (3 - sqrt(d) -
# price).
NN_OPS_PER_PAIR = 9
EMD_OPS_PER_PAIR = 11
# Issued instructions a second: 128 a clock per SM (four schedulers, 32
# lanes each) on 132 SMs at 1.98 GHz. PEAK_FP32_FLOPS counts an FMA as two
# operations, but chamfer's pair is 9 issued instructions (FMUL and two FFMA
# for the cross term, FADD, FFMA for - 2ab, the clamp, the compare, two
# selects), only some of them FMAs: its floor is the pairs' issue slots at
# this rate, twice the FLOP bound.
ISSUE_SLOTS_PER_S = 132 * 128 * 1.98e9
NN_ISSUES_PER_PAIR = 9
# Sinkhorn: a cost (9), then (pot - c) / e + log_w, the exp's argument and
# the running sum: 14 float32 operations and one exp per evaluation.
SINKHORN_OPS_PER_EVAL = 14
BATCH, N_POINTS = 64, 1024
# The second point count the reference's --num_points offers.
WIDE_POINTS = 2048
MODEL = dict(backbone="RepVGG-A2", fine_width=512, mid_width=128)
# The d2se phase: the generator of configuration d2se_1024 (portbench) at a
# batch that keeps the phase short.
D2SE_MODEL = dict(MODEL, backbone="RepVGG-D2se")
D2SE_BATCH = 8
D2SE_GATES = 48  # one squeeze-and-excite gate a block, stage 0 included
# The gates' (channels, h = w) at 128x128 images, each at TRAIN_BATCH: stage
# 0, then stages 1 to 4 (8, 14, 24 and 1 gates). Passes over x's bytes the
# gate needs forward (x twice, y once) and backward (dy twice, x once, dx
# once). The backward's kernels sum in another order than the plain
# formulas, over up to 4096 terms: each gradient within GATE_REL_LIMIT of its
# largest element.
D2SE_GATE_SHAPES = ((64, 64), (160, 32), (320, 16), (640, 8), (2560, 4))
GATE_PASSES = {"forward": 3, "backward": 4}
GATE_REL_LIMIT = 1e-5
GATE_PROFILED = 5
# The adam phase: the parameter sets of the train cells' generators at 1024
# points; the bytes one Adam pass must move a parameter (p, g, m, v read; p,
# m, v written); the steps held against torch's foreach Adam; the GPU cycles
# the device sleeps before a timed run while the host enqueues it (~1 s at
# 1.98 GHz), so that the events hold device time alone.
ADAM_SETS = {"a2": MODEL, "d2se": D2SE_MODEL}
ADAM_BYTES_PER_PARAM = 28
ADAM_STEPS = 3
ADAM_HEAD_START_CYCLES = 2_000_000_000
TRAIN_BATCH = 128
TRAIN_EPOCH = 1
# The finetune CLI's learning rate.
FINETUNE_LR = 5e-5
# Samples a category in the Pix3D phase's synthetic tree: a full batch of
# 32 and a partial one.
PIX3D_SAMPLES = 36
# Kernel checks beyond the eval shapes: K1 at K2's range (B, N, M), and the
# Sinkhorn potentials at (B, N = M, iterations).
NN_LARGE = (4, 2048, 16384)
SINKHORN_CASES = ((128, 1024, 300), (4, 2048, 300), (2, 8192, 30))
# K4 on dyadic clouds at (N, B): B·N² kept at 2^26 or below, so each of the
# plain version's float32 (B, N, N) tensors stays within 256 MB.
STREAM_CASES = ((2048, 4), (4096, 2), (8192, 1), (1100, 4), (5000, 1))
# K4 is held against its plain version on the first elements of the
# batch-128 train clouds: each element is an independent auction, in the
# kernel (one CTA each) and in the plain version, whose (B, N, N) tensors
# through up to 3000 iterations at all 128 elements would take minutes.
STREAM_TRAIN_CHECK = 32
# The Sinkhorn loss from the kernel's potentials may differ from the loss
# from the plain potentials on the same clouds by this much, relative: the
# plan exponentiates a potential's error times 1/eps = 1e4, which the check
# of the potentials alone does not show. The previous kernel (IEEE division,
# accurate expf) gave 4.6e-6 and 5.1e-6 on the train clouds (PERF.md); the
# limit is the larger of twice that and 1e-3.
SINKHORN_LOSS_REL_LIMIT = 1e-3
# The fused plan's check: (B, N, M, Sinkhorn iterations) of the 2048-point
# train step, and its float32 operations a pair: the cost (9), the exponent
# (5), the row's cost sum (2) and V (three differences, three FMAs: 9), with
# one exponential; and its issued instructions a pair (the same, the
# accurate expf's ~10 among them, the clamp's mask and select: ~31).
PLAN_SHAPE = (128, 2048, 2048, 300)
PLAN_OPS_PER_PAIR = 25
PLAN_ISSUES_PER_PAIR = 31
# The three EMD modes of TrainConfig and the kernel each one runs.
TRAIN_MODES = {
    "auction": ({}, "emd_auction"),
    "scaled": ({"emd_scale_phases": 3, "emd_scale_thresh": 0.3}, "emd_auction"),
    "sinkhorn": ({"emd_impl": "sinkhorn"}, "sinkhorn"),
}
# Phase parallel: two ranks on the one card (gloo: NCCL refuses two ranks on
# one GPU), each a process of its own under RANK_TIMEOUT_S; the gradient rows
# of fc1_1 each step rank saves.
PARALLEL_RANKS = 2
RANK_TIMEOUT_S = 600
GRAD_ROWS = 256
# A rank's step against the one-process step, replaying its assignment:
# CD and EMD as phase_train_reference's card-vs-CPU limits; the decoder's
# gradients (fc3_1, fc1_1's first rows) to 1e-3 relative L2, and two
# backbone convs upstream of every sync-BN to 1e-2,
# the card-vs-CPU gradient limit: a first layer's weight gradient is a
# cancelling sum over every position of the batch, so the order of its sums
# shows there (the phase prints the one-process step with its batch rows
# shuffled beside the ranks' gaps as that floor; a dropped cross-rank term is
# ~0.8, PERF.md §6). Left to its own auction a rank's step is held
# to the same CD and EMD limits only: on predictions ~1e-6 apart the
# auction at eps 0.05 may end in another matching, and the gradients move
# by percents (2.7e-2 for fc3_1 on an H100); the phase prints how the two
# matchings differ.
PARALLEL_LIMITS = {"cd_rel_err": 1e-5, "emd_rel_err": 1e-2, "fc3_1_grad_rel_err": 1e-3,
                   "fc1_1_grad_rel_err": 1e-3, "stage0_conv_grad_rel_err": 1e-2,
                   "edge0_conv_grad_rel_err": 1e-2}
# The serving phases: the deploy forward is timed at these batches; the
# server takes SERVE_REQUESTS PNG requests from SERVE_CLIENTS client threads
# at SERVE_MAX_BATCH and a SERVE_WINDOW_MS window; predict runs over
# PREDICT_IMAGES PNGs at --batchSize SERVE_MAX_BATCH.
DEPLOY_BATCHES = (1, 32, 64)
SERVE_MAX_BATCH = 32
SERVE_WINDOW_MS = 5.0
SERVE_CLIENTS = 64
SERVE_REQUESTS = 1024
PREDICT_IMAGES = 64
# The data phase's tree: one category of DATA_MODELS models, 24 views each,
# 384 samples, three batches of TRAIN_BATCH. The native loader is timed at
# each of DATA_THREADS threads, DATA_REPS times.
DATA_MODELS = 16
DATA_THREADS = (1, 2, 4, 8)
DATA_REPS = 3
# Limits: the float32 fold against the branched forward, of max|ref|
# (fenet's tests/test_deploy.py); the bf16 fold against the float32 fold
# (fenet's tests/test_extras.py); the artifact against the module it was
# exported from.
FOLD_REL_LIMIT = 1e-3
BF16_REL_LIMIT = 0.05
ARTIFACT_REL_LIMIT = 1e-6
# Two replicas on one card, the serving batch raised from 33 to 34 by the
# rounding to the device count; a split forward's rows against the
# one-device forward's, of max|ref|: the same weights at half the batch,
# where cuDNN may choose another algorithm (the deploy phase's card-vs-CPU
# limit; the bf16 .pt2 is held to BF16_REL_LIMIT).
TWO_REPLICAS = ("cuda:0", "cuda:0")
TWO_REPLICA_BATCH = 33
SPLIT_REL_LIMIT = 1e-4
# Phase goldens: the 13 categories, GOLDENS_EMPTY's files removed (its row
# is skipped; not one of Pix3D's mapped ids, which phase viz renders). One
# category through the CLI on the card and on the CPU, its CD and EMD: the
# EMD to the whole eval step's 5% (tests/test_torch_goldens.py), the CD to
# 1e-2, the eval phase's card-vs-CPU EMD limit. Strict ICP runs each cloud
# to a float32 fixed point; the generator's ~2e-6 card-vs-CPU gap moves
# that point, and the category's CD moved 1.4e-3 on an H100 (PERF.md §5). The
# phase prints the stages' gaps on identical inputs beside it.
GOLDENS_EMPTY = "04530566"
GOLDENS_CD_REL = 1e-2
GOLDENS_EMD_REL = 5e-2
# Phase analysis: fscore's thresholds on the squared distance (fenet's
# default and a looser one, which the eval clouds pass more often); the
# dense auction's (B, N), N above the kernels' 8192.
FSCORE_THRESHOLDS = (1e-4, 1e-2)
DENSE_SHAPE = (2, 8200)
# The Sinkhorn loss above the kernel's 8192 points: the potentials at (B, N =
# M, iterations), then one Sinkhorn train step at N, batch B (33·256, the
# first generator size above 8192).
SINKHORN_LARGE = (2, 8448, 3)
# The reference's golden metrics (tests/make_goldens.py), held as
# tests/test_reference_parity.py holds fenet to them.
GOLDENS_REF = ROOT / "tests" / "goldens" / "metric_goldens.npz"
# Phase viz: Grad-CAM's [0, 1] map on the card against the CPU, at full
# width, to the CPU tests' tolerance against fenet (tests/test_torch_viz.py;
# 6.0e-7 measured on an H100, PERF.md §5).
GRADCAM_ATOL = 1e-4
# The untrained prediction is ~30x the gt's scale; scaling the three output
# heads brings it to the gt's, as a trained model's is. Training starts from
# the unscaled init, as the reference does: Adam's first steps move every
# weight by about the LR (5e-4), 25% of a scaled head weight.
HEAD_SCALE = 0.03
# phase checkpoint: how often a load's resident set is sampled.
RSS_SAMPLE_S = 0.002


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float, special: float = 0.0):
    """The least time for ``ops`` float32 operations, ``special`` of them
    special-function evaluations as well, and ``nbytes`` moved."""
    t_ops = max(ops / PEAK_FP32_FLOPS, special / PEAK_SFU_PER_S)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def nn_device(a, b, inputs: str) -> dict:
    """K1 on clouds a (B,N,3), b (B,M,3) through the package's wrapper: its
    slices of M (S) and grid, its device ms (CUDA events around replays of
    a CUDA graph of 20 launches, so the wrapper's host time is not in it),
    and its bounds: float32 operations at PEAK_FP32_FLOPS (``bound_ms``)
    and issued instructions at ISSUE_SLOTS_PER_S (``issue_bound_ms``)."""
    from fenet_torch.ops import chamfer
    from fenet_torch.tools.devkit import graph_ms

    bsz, n, m = a.shape[0], a.shape[1], b.shape[1]
    slices = chamfer.nn_slices(bsz, n, m)
    pairs = bsz * n * m
    return {"inputs": inputs, "B": bsz, "N": n, "M": m, "slices": slices,
            "grid": [-(-n // chamfer.ROWS_PER_BLOCK), bsz, slices],
            "device_ms": graph_ms(lambda: chamfer.nn_kernel(a, b)),
            "bound_ms": bound_ms(pairs * NN_OPS_PER_PAIR,
                                 (bsz * n + bsz * m) * 12 + bsz * n * 8)[0],
            "issue_bound_ms": pairs * NN_ISSUES_PER_PAIR / ISSUE_SLOTS_PER_S * 1e3}


def nn_train_clouds(x1, x2) -> list:
    """K1 on the train step's clouds, both directions, as the step launches
    it: one launch each (S = 1, no key buffer), bit for bit against the
    plain version; each direction's ``nn_device`` numbers."""
    import torch

    from fenet_torch.ops.chamfer import _nn_ref, nn_kernel, nn_slices

    rows = []
    for name, a, c in (("pred -> gt", x1, x2), ("gt -> pred", x2, x1)):
        if nn_slices(a.shape[0], a.shape[1], c.shape[1]) != 1:
            raise AssertionError(f"chamfer_nn splits M at the train shape {tuple(a.shape)}")
        d_k, i_k = nn_kernel(a, c)
        d_p, i_p = _nn_ref(a, c)
        if not (torch.equal(d_k, d_p) and torch.equal(i_k, i_p)):
            raise AssertionError(
                f"chamfer_nn differs from plain on the train clouds (B={a.shape[0]}): "
                f"{float((d_k - d_p).abs().max())}, {float((i_k != i_p).float().mean())}")
        rows.append(nn_device(a, c, f"train clouds, {name}"))
    return rows


def auction_bounds(bid_rows, n: int, gate: bool = False):
    """(bound_ms, bound_by, bound_per_sm_ms) of an auction whose elements
    made ``bid_rows`` (B,) row bids at n points, each bid n pair
    evaluations with one square root each, plus the gate's n² pairs an
    element: the whole card's bound, and the slowest element's pairs at 16
    roots a clock on the one SM its CTA runs on."""
    pairs = bid_rows.double() * n + (n * n if gate else 0)
    total = float(pairs.sum())
    b = bid_rows.shape[0]
    bound, by = bound_ms(total * EMD_OPS_PER_PAIR, b * n * 12 * 2 + b * n * 8, special=total)
    return bound, by, float(pairs.max()) / SFU_PER_SM_PER_S * 1e3


def launch_counts():
    """Launches of each kernel: the auction wrapper counts all of its
    launches and, apart, those of the stream kernel (K4)."""
    from fenet_torch.ops import chamfer, emd, sinkhorn

    stream = emd.auction_kernel.stream_launches
    return {"chamfer_nn": chamfer.nn_kernel.launches,
            "emd_auction": emd.auction_kernel.launches - stream,
            "emd_auction_stream": stream,
            "sinkhorn": sinkhorn.potentials_kernel.launches}


def plan_launches() -> dict:
    """Launches of the fused Sinkhorn plan's row and column kernels."""
    from fenet_torch.ops import sinkhorn

    return {"sinkhorn_plan": sinkhorn.plan_kernel.launches,
            "sinkhorn_plan_columns": sinkhorn.plan_columns_kernel.launches}


def reset_counts() -> None:
    from fenet_torch.ops import adam, chamfer, emd, se_gate, sinkhorn

    se_gate.se_gate_kernel.launches = 0
    adam.adam_kernel.launches = 0
    adam.adam_kernel.elements = 0
    chamfer.nn_kernel.launches = 0
    emd.auction_kernel.launches = 0
    emd.auction_kernel.stream_launches = 0
    emd.auction_kernel.scaled_launches = 0
    sinkhorn.potentials_kernel.launches = 0
    sinkhorn.plan_kernel.launches = 0
    sinkhorn.plan_columns_kernel.launches = 0


def adam_counts(trainer, steps: int, what: str) -> dict:
    """The Adam pass's launches since the last reset_counts() and the
    elements its last step updated, held to ``steps`` train steps of
    ``trainer``: one launch a step for each MAX_TENSORS parameters that
    have a gradient, and every element of those parameters."""
    from fenet_torch.ops import adam

    with_grad = [p for group in trainer.optimizer.param_groups for p in group["params"]
                 if p.grad is not None]
    want = {"launches": steps * -(-len(with_grad) // adam.MAX_TENSORS),
            "elements": sum(p.numel() for p in with_grad)}
    got = {"launches": adam.adam_kernel.launches, "elements": adam.adam_kernel.elements}
    if got != want:
        raise AssertionError(f"{what}: the Adam pass counted {got} over {steps} steps, "
                             f"not {want}")
    return got


def emd_kernel_name(n: int) -> str:
    """The auction kernel that runs at n points."""
    from fenet_torch.ops.emd import RESIDENT_MAX_N

    return "emd_auction" if n <= RESIDENT_MAX_N else "emd_auction_stream"


def gate_open_elements(x1, x2, scale_thresh: float = 0.3) -> int:
    """Batch elements whose eps-scaling gate opens: fewer than
    ``scale_thresh·N`` distinct gt columns are some row's nearest (the
    argmax of the value at price 0), the quantity the kernel counts."""
    import torch

    from fenet_torch.ops.emd import gate_threshold
    from fenet_torch.ops.pairwise import pairwise_sqdist

    value = 3.0 - torch.sqrt(pairwise_sqdist(x1, x2))
    hit = torch.zeros(value.shape[:2], dtype=torch.int32, device=x1.device)
    hits = hit.scatter_(1, value.argmax(2), 1).sum(1)
    return int((hits.float() < gate_threshold(scale_thresh, x1.shape[1])).sum())


def host_syncs(fn) -> list:
    """Call ``fn`` with PyTorch's sync debug mode on. Returns one entry for
    each synchronising CUDA call it made (a blocking copy, a read to the
    host): the innermost line of the port on the Python stack, and the
    line that made the call. The kernels' ctypes launches do not
    synchronise."""
    import traceback
    import warnings

    import torch

    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        # PyTorch also warns, once a process, that the debug mode itself is
        # a prototype ("Synchronization debug mode is a prototype feature"):
        # that is no sync.
        if "synchroniz" not in str(message) or "prototype" in str(message):
            return
        port = [f for f in traceback.extract_stack()
                if Path(f.filename).resolve().is_relative_to(ROOT / "fenet_torch")]
        where = (f"{Path(port[-1].filename).resolve().relative_to(ROOT)}:{port[-1].lineno}"
                 if port else "outside the port")
        syncs.append(f"{where} ({'/'.join(Path(filename).parts[-2:])}:{lineno})")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return syncs


def timed_ms(phases: dict, name: str, fn):
    """Call ``fn`` between two synchronisations and record its host-clock
    ms in ``phases[name]``; returns its result."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    phases[name] = (time.perf_counter() - t) * 1e3
    return out


def clouds(kind: str, rng, device, shape=(BATCH, N_POINTS, 3)):
    import torch

    if kind == "dyadic":
        x = rng.randint(-64, 65, size=shape) / 64.0
    else:
        x = rng.randn(*shape)
    return torch.tensor(x, dtype=torch.float32, device=device)


def phase_kernels(device) -> None:
    import numpy as np
    import torch

    from fenet_torch.ops.chamfer import _nn_ref, nn_kernel, nn_slices
    from fenet_torch.ops.emd import _auction_plain, auction_kernel, root_mismatches

    nn_kernel.launches = auction_kernel.launches = 0
    rng = np.random.RandomState(0)
    for kind in ("dyadic", "normal"):
        a, b = clouds(kind, rng, device), clouds(kind, rng, device)
        d_k, i_k = nn_kernel(a, b)
        torch.cuda.synchronize()
        d_p, i_p = _nn_ref(a, b)
        err = float((d_k - d_p).abs().max())
        same = float((i_k == i_p).float().mean())
        if kind == "dyadic" and not (torch.equal(d_k, d_p) and torch.equal(i_k, i_p)):
            raise AssertionError(f"chamfer_nn differs from plain on dyadic inputs: {err}, {same}")
        if err > 1e-5:
            raise AssertionError(f"chamfer_nn max |d dist| {err} > 1e-5 on {kind} inputs")
        emit({"phase": "kernels", "kernel": "chamfer_nn", "inputs": kind,
              "slices": nn_slices(*a.shape[:2], b.shape[1]),
              "max_abs_dist_err": err, "idx_equal_share": same,
              "kernel_ms": cuda_ms(lambda: nn_kernel(a, b), 50),
              "plain_ms": cuda_ms(lambda: _nn_ref(a, b), 10),
              "library_ms": cuda_ms(lambda: torch.cdist(a, b).min(-1), 10)})
        for eps, iters in ((0.005, 50), (0.05, 3000)):
            d_k, a_k = auction_kernel(a, b, eps, iters)
            torch.cuda.synchronize()
            d_p, a_p = _auction_plain(a, b, eps, iters)
            err = float((d_k - d_p).abs().max())
            same = float((a_k == a_p).float().mean())
            m_k, m_p = float(d_k.sqrt().mean()), float(d_p.sqrt().mean())
            if kind == "dyadic" and not (torch.equal(d_k, d_p) and torch.equal(a_k, a_p)):
                raise AssertionError(f"emd_auction differs from plain on dyadic inputs "
                                     f"at eps {eps}/{iters}: {err}, {same}")
            if abs(m_k - m_p) > 1e-2 * m_p:
                raise AssertionError(f"emd_auction metric {m_k} vs plain {m_p} at {eps}/{iters}")
            emit({"phase": "kernels", "kernel": "emd_auction", "inputs": kind,
                  "eps": eps, "iters": iters, "max_abs_dist_err": err,
                  "assignment_equal_share": same,
                  "kernel_ms": cuda_ms(lambda: auction_kernel(a, b, eps, iters), 10),
                  "plain_ms": cuda_ms(lambda: _auction_plain(a, b, eps, iters), 1, warmup=0)})
    emit({"phase": "kernels", "launches": {"chamfer_nn": nn_kernel.launches,
                                           "emd_auction": auction_kernel.launches}})
    t0 = time.perf_counter()
    mismatches, lowest = root_mismatches(device)
    emit({"phase": "kernels", "kernel": "emd_auction", "check": "square root, 2^32 patterns",
          "mismatches": mismatches, "lowest": lowest, "s": time.perf_counter() - t0})
    if mismatches:
        raise AssertionError(f"emd_auction's square root differs from __fsqrt_rn on "
                             f"{mismatches} bit patterns, the lowest {lowest:#010x}")


def phase_kernels_train(device) -> None:
    """K2's range, K5 and K6/K7 against their plain versions."""
    import numpy as np
    import torch

    from fenet_torch.ops.chamfer import _nn_ref, nn_kernel
    from fenet_torch.ops.emd import _auction_plain, auction_kernel
    from fenet_torch.ops.sinkhorn import _potentials_plain, potentials_kernel

    rng = np.random.RandomState(2)
    dyadic = lambda *shape: torch.tensor(rng.randint(-64, 65, size=shape) / 64.0,
                                         dtype=torch.float32, device=device)
    bsz, n, m = NN_LARGE
    a, b = dyadic(bsz, n, 3), dyadic(bsz, m, 3)
    d_k, i_k = nn_kernel(a, b)
    torch.cuda.synchronize()
    d_p, i_p = _nn_ref(a, b)
    if not (torch.equal(d_k, d_p) and torch.equal(i_k, i_p)):
        raise AssertionError(f"chamfer_nn differs from plain at M = {m}")
    emit({"phase": "kernels", "kernel": "chamfer_nn", "bit_exact": True,
          **nn_device(a, b, "dyadic, NN_LARGE"),
          "kernel_ms": cuda_ms(lambda: nn_kernel(a, b), 20),
          "plain_ms": cuda_ms(lambda: _nn_ref(a, b), 3),
          "library_ms": cuda_ms(lambda: torch.cdist(a, b).min(-1), 3)})

    x1, x2 = dyadic(BATCH, N_POINTS, 3), dyadic(BATCH, N_POINTS, 3)
    clustered = torch.round(x1 * 4) / 256  # few distinct points: the gate opens
    for case, pred, early_exit in (("gate open", clustered, True),
                                   ("gate closed", x1, True),
                                   ("gate open, no early exit", clustered, False)):
        args = (pred, x2, 0.05, 3000, 3, early_exit, 0.3)
        opened = gate_open_elements(pred, x2)
        if opened != (0 if case == "gate closed" else BATCH):
            raise AssertionError(f"emd_auction ({case}): the gate opens on {opened} "
                                 f"of {BATCH} elements")
        d_k, a_k = auction_kernel(*args)
        torch.cuda.synchronize()
        d_p, a_p = _auction_plain(*args)
        if not (torch.equal(d_k, d_p) and torch.equal(a_k, a_p)):
            raise AssertionError(f"emd_auction (scaled, {case}) differs from plain")
        if case == "gate closed":
            d_f, a_f = auction_kernel(pred, x2, 0.05, 3000)
            if not (torch.equal(d_k, d_f) and torch.equal(a_k, a_f)):
                raise AssertionError("closed gate: not the fixed-eps kernel's result")
        emit({"phase": "kernels", "kernel": "emd_auction", "inputs": "dyadic",
              "mode": f"scale_phases 3, scale_thresh 0.3, {case}", "eps": 0.05,
              "iters": 3000, "bit_exact": True, "gate_open_elements": opened,
              "kernel_ms": cuda_ms(lambda: auction_kernel(*args), 5),
              "plain_ms": cuda_ms(lambda: _auction_plain(*args), 1, warmup=0)})

    for bsz, n, iters in SINKHORN_CASES:
        x = torch.rand(bsz, n, 3, device=device, generator=torch.Generator(device).manual_seed(n))
        y = torch.rand(bsz, n, 3, device=device, generator=torch.Generator(device).manual_seed(n + 1))
        f_k, g_k = potentials_kernel(x, y, 1e-4, iters, 0.25)
        torch.cuda.synchronize()
        f_p, g_p = _potentials_plain(x, y, 1e-4, iters, 0.25)
        for got, want in ((f_k, f_p), (g_k, g_p)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        evals = 2 * bsz * n * n * iters
        emit({"phase": "kernels", "kernel": "sinkhorn", "B": bsz, "N": n, "M": n,
              "iters": iters, "eps": 1e-4,
              "bound_ms": bound_ms(evals * SINKHORN_OPS_PER_EVAL, 2 * bsz * n * 16 + iters * 4,
                                   special=evals)[0],
              "max_abs_err": max(float((f_k - f_p).abs().max()), float((g_k - g_p).abs().max())),
              "kernel_ms": cuda_ms(lambda: potentials_kernel(x, y, 1e-4, iters, 0.25), 1),
              "plain_ms": cuda_ms(lambda: _potentials_plain(x, y, 1e-4, iters, 0.25), 1,
                                  warmup=0)})


def phase_kernels_stream(device) -> None:
    """K4 against its plain version at every N of STREAM_CASES. Dyadic
    clouds, bit for bit: fixed eps at the eval (0.005 / 50) and train
    (0.05 / 3000) settings; eps-scaling (3 phases, threshold 0.3) with the
    gate open on every element, closed on every element (then also the
    fixed-eps result) and open without the early exit. Random normal
    clouds at the eval settings: the EMD metric to 1e-2 relative."""
    import numpy as np
    import torch

    from fenet_torch.ops.emd import _auction_plain, auction_kernel

    rng = np.random.RandomState(3)
    for n, bsz in STREAM_CASES:
        x1, x2 = (clouds("dyadic", rng, device, (bsz, n, 3)) for _ in range(2))
        clustered = torch.round(x1 * 4) / 256  # few distinct points: the gate opens
        cases = (("eval", x1, 0.005, 50, 1, True), ("train", x1, 0.05, 3000, 1, True),
                 ("gate open", clustered, 0.05, 3000, 3, True),
                 ("gate closed", x1, 0.05, 3000, 3, True),
                 ("gate open, no early exit", clustered, 0.05, 3000, 3, False))
        results = {}
        for case, pred, eps, iters, phases, early_exit in cases:
            args = (pred, x2, eps, iters, phases, early_exit, 0.3 if phases > 1 else 0.0)
            extra = {}
            if phases > 1:
                opened = gate_open_elements(pred, x2)
                if opened != (0 if case == "gate closed" else bsz):
                    raise AssertionError(f"emd_auction_stream N={n} ({case}): the gate "
                                         f"opens on {opened} of {bsz} elements")
                extra["gate_open_elements"] = opened
            before = auction_kernel.stream_launches
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            d_k, a_k = auction_kernel(*args)
            end.record()
            torch.cuda.synchronize()
            if auction_kernel.stream_launches != before + 1:
                raise AssertionError(f"N={n}: the auction did not launch the stream kernel")
            t0 = time.perf_counter()
            d_p, a_p = _auction_plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            if not (torch.equal(d_k, d_p) and torch.equal(a_k, a_p)):
                raise AssertionError(
                    f"emd_auction_stream differs from plain at N={n} ({case}): "
                    f"{float((d_k - d_p).abs().max())}, {float((a_k != a_p).float().mean())}")
            results[case] = (d_k, a_k)
            if case == "gate closed" and not all(
                    torch.equal(a, b) for a, b in zip(results["train"], results[case])):
                raise AssertionError(f"N={n}, closed gate: not the fixed-eps kernel's result")
            emit({"phase": "kernels", "kernel": "emd_auction_stream", "inputs": "dyadic",
                  "B": bsz, "N": n, "case": case, "eps": eps, "iters": iters,
                  "scale_phases": phases, "early_exit": early_exit, "bit_exact": True, **extra,
                  "kernel_ms": start.elapsed_time(end), "plain_ms": plain_ms})
        a, b = (clouds("normal", rng, device, (bsz, n, 3)) for _ in range(2))
        d_k, a_k = auction_kernel(a, b, 0.005, 50)
        d_p, a_p = _auction_plain(a, b, 0.005, 50)
        m_k, m_p = float(d_k.sqrt().mean()), float(d_p.sqrt().mean())
        if abs(m_k - m_p) > 1e-2 * m_p:
            raise AssertionError(f"emd_auction_stream metric {m_k} vs plain {m_p} at N={n}")
        emit({"phase": "kernels", "kernel": "emd_auction_stream", "inputs": "normal", "B": bsz,
              "N": n, "eps": 0.005, "iters": 50, "metric": m_k, "plain_metric": m_p,
              "max_abs_dist_err": float((d_k - d_p).abs().max()),
              "assignment_equal_share": float((a_k == a_p).float().mean())})


def phase_plan(device) -> dict:
    """The fused Sinkhorn plan at PLAN_SHAPE on K7's potentials against
    pairwise_sqdist + plan_loss (the module docstring's ``plan``); returns
    its numbers."""
    import numpy as np
    import torch

    from fenet_torch.losses.sinkhorn import mean_root, plan_loss
    from fenet_torch.ops import sinkhorn
    from fenet_torch.ops.pairwise import pairwise_sqdist

    b, n, m, iters = PLAN_SHAPE
    eps = 1e-4  # the train loss's blur 0.01, squared
    rng = np.random.RandomState(25)
    x, y = (torch.tensor((rng.rand(b, k, 3) * 0.9).astype(np.float32), device=device)
            for k in (n, m))
    f, g = sinkhorn.potentials_kernel(x, y, eps, iters, 0.25)

    def fused(xl, yl):
        return mean_root(sinkhorn.plan_cost(xl, yl, f, g, eps))

    def plain(xl, yl):
        c = pairwise_sqdist(xl, yl)
        return plan_loss(c.detach(), c, f, g, eps)

    def run(loss_fn, gt_grad, backward=True):
        xl, yl = x.clone().requires_grad_(True), y.clone().requires_grad_(gt_grad)
        loss = loss_fn(xl, yl)
        if backward:
            loss.backward()
        return loss.detach(), xl.grad, yl.grad

    def peak_of(fn):
        """fn's result and its peak memory above what was allocated before."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        result = fn()
        torch.cuda.synchronize()
        return result, torch.cuda.max_memory_allocated() - base

    out = {"phase": "plan", "B": b, "N": n, "M": m, "sinkhorn_iters": iters, "eps": eps,
           "inputs": "uniform clouds in [0, 0.9)^3, K7's potentials"}
    for gt_grad in (False, True):
        reset_counts()
        (l_k, gx_k, gy_k), peak_k = peak_of(lambda: run(fused, gt_grad))
        launches = plan_launches()
        (l_p, gx_p, gy_p), peak_p = peak_of(lambda: run(plain, gt_grad))
        errs = {"loss_rel_err": abs(float(l_k) - float(l_p)) / abs(float(l_p)),
                "grad_x_err": float((gx_k - gx_p).abs().max() / gx_p.abs().max())}
        if gt_grad:
            errs["grad_gt_err"] = float((gy_k - gy_p).abs().max() / gy_p.abs().max())
        label = "gt_grad" if gt_grad else "pred_grad"
        out[label] = {**errs, "launches": launches, "fused_peak_bytes": peak_k,
                      "plain_peak_bytes": peak_p}
        want = {"sinkhorn_plan": 1, "sinkhorn_plan_columns": int(gt_grad)}
        if (not errs["loss_rel_err"] <= 1e-5
                or not max(v for k, v in errs.items() if k.startswith("grad")) <= 1e-4
                or launches != want or not peak_k < b * n * m * 4):
            raise AssertionError(f"the fused plan against the plain one ({label}): "
                                 f"{out[label]}; launches must be {want}, the peak under "
                                 f"B·N·M floats")
        del gx_k, gy_k, gx_p, gy_p
    pairs = b * n * m
    bound, by = bound_ms(pairs * PLAN_OPS_PER_PAIR, (b * n + b * m) * 16 + b * n * 16,
                         special=pairs)
    u = torch.rand(b, n, device=device)
    out.update({
        "kernel_ms": cuda_ms(lambda: sinkhorn.plan_kernel(x, y, f, g, eps), 20, warmup=2),
        "columns_kernel_ms": cuda_ms(lambda: sinkhorn.plan_columns_kernel(x, y, f, g, u, eps),
                                     20, warmup=2),
        "bound_ms": bound, "bound_by": by,
        "issue_bound_ms": pairs * PLAN_ISSUES_PER_PAIR / ISSUE_SLOTS_PER_S * 1e3,
        "fused_forward_ms": cuda_ms(lambda: run(fused, False, backward=False), 10),
        "fused_forward_backward_ms": cuda_ms(lambda: run(fused, False), 10),
        "plain_forward_ms": cuda_ms(lambda: run(plain, False, backward=False), 5),
        "plain_forward_backward_ms": cuda_ms(lambda: run(plain, False), 5),
    })
    emit(out)
    return out


def gate_rows(device) -> list:
    """The gate at each of D2SE_GATE_SHAPES (module docstring, phase d2se):
    seeded normal x and dy, the weights at nn.Linear's scale."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fenet_torch.ops.se_gate import (BACKWARD_LAUNCHES, gate_backward_plain, gate_forward,
                                         se_gate_kernel)

    def operations(fn) -> float:
        """Device operations a call under the profiler, over GATE_PROFILED
        calls (a single call's window has lost events to the profiler)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(GATE_PROFILED):
                fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA) / GATE_PROFILED

    def launches(fn) -> int:
        before = se_gate_kernel.launches
        fn()
        return se_gate_kernel.launches - before

    rows = []
    for c, side in D2SE_GATE_SHAPES:
        gen = torch.Generator(device=device).manual_seed(c)
        r = c // 16
        x, dy = (torch.randn(TRAIN_BATCH, c, side, side, device=device, generator=gen)
                 for _ in range(2))
        weights = (torch.randn(r, c, device=device, generator=gen) * c ** -0.5,
                   torch.randn(r, device=device, generator=gen) * c ** -0.5,
                   torch.randn(c, r, device=device, generator=gen) * r ** -0.5,
                   torch.randn(c, device=device, generator=gen) * r ** -0.5)
        wd, wu = weights[0], weights[2]

        def forward():
            with torch.no_grad():
                return gate_forward(x, *weights)

        _, *saved = forward()

        def backward():
            return se_gate_kernel(dy, x, *saved, wd, wu)

        got, again = backward(), backward()
        want = gate_backward_plain(dy, x, *saved, wd, wu)
        names = ("x", "down.weight", "down.bias", "up.weight", "up.bias")
        gaps = {n: float((g - w).abs().max() / w.abs().max())
                for n, g, w in zip(names, got, want)}
        leaves = [t.clone().requires_grad_(True) for t in (x, *weights)]
        eager_y = gate_forward(*leaves)[0]

        def eager_forward():
            return gate_forward(*leaves)

        def eager_backward():
            return torch.autograd.grad(eager_y, leaves, dy, retain_graph=True)

        nbytes = x.numel() * 4
        row = {"C": c, "hw": side * side, "batch": TRAIN_BATCH, "x_bytes": nbytes,
               "max_rel_gap": gaps, "repeats_bit_for_bit": all(
                   torch.equal(a, b) for a, b in zip(got, again)),
               "launches": {"forward": launches(forward), "backward": launches(backward)},
               "operations": {"forward": operations(forward), "backward": operations(backward),
                              "eager_forward": operations(eager_forward),
                              "eager_backward": operations(eager_backward)}}
        for way, fn, eager in (("forward", forward, eager_forward),
                               ("backward", backward, eager_backward)):
            row[f"{way}_ms"] = device_ms(fn, 20)
            row[f"{way}_bound_ms"] = GATE_PASSES[way] * nbytes / PEAK_BYTES_PER_S * 1e3
            row[f"eager_{way}_ms"] = device_ms(eager, 20)
        rows.append(row)
        if (max(gaps.values()) > GATE_REL_LIMIT or not row["repeats_bit_for_bit"]
                or row["launches"] != {"forward": 0, "backward": BACKWARD_LAUNCHES}):
            emit({"phase": "d2se", "gates": rows})
            raise AssertionError(f"d2se: the gate's kernels at C={c}, {side}x{side}: gaps "
                                 f"{gaps} (limit {GATE_REL_LIMIT}), bit-repeat "
                                 f"{row['repeats_bit_for_bit']}, launches {row['launches']}")
        del x, dy, weights, saved, got, again, want, leaves, eager_y
        torch.cuda.empty_cache()
    return rows


def phase_d2se(device) -> dict:
    """One RepVGG-D2se train step on the card (``D2SE_MODEL`` at 1024
    points, batch ``D2SE_BATCH``, from the unscaled init) after a warm-up
    step: timed by CUDA events with no profiler, when the gates must count
    nothing, then under a profiler, when the gates' counter must read each
    of the 48 gates' forward and backward once and a positive device time;
    their ms beside the step's; the Adam pass one launch a step over every
    parameter element with a gradient."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fenet_torch.models.generator import Generator, init_random_
    from fenet_torch.models.repvgg import se_work
    from fenet_torch.ops.se_gate import BACKWARD_LAUNCHES, se_gate_kernel
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer

    gates_rows = gate_rows(device)
    with torch.device(device):
        gen = Generator(num_points=N_POINTS, **D2SE_MODEL)
    init_random_(gen, torch.Generator(device=device).manual_seed(0))
    trainer = Trainer(gen, TrainConfig(batch_size=D2SE_BATCH, num_points=N_POINTS,
                                       **D2SE_MODEL), device=device)
    rng = np.random.RandomState(22)
    images = torch.tensor((rng.rand(D2SE_BATCH, 128, 128, 3) * 255).astype(np.uint8),
                          device=device)
    points = torch.tensor((rng.rand(D2SE_BATCH, N_POINTS, 3) * 0.9).astype(np.float32),
                          device=device)

    def step():
        return trainer.train_step(images, points, TRAIN_EPOCH, 5e-4)

    step()  # warm-up: cuDNN plans
    reset_counts()
    before = se_work(device)
    step_ms = cuda_ms(step, 1, warmup=0)
    if se_work(device) != before:
        raise AssertionError(f"d2se: the gates counted with no profiler: {before} -> "
                             f"{se_work(device)}")
    gate_launches = se_gate_kernel.launches
    if gate_launches != D2SE_GATES * BACKWARD_LAUNCHES:
        raise AssertionError(f"d2se: one step launched the gate's kernels {gate_launches} "
                             f"times, not {D2SE_GATES} x {BACKWARD_LAUNCHES}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        start.record()
        stats = step()
        end.record()
        torch.cuda.synchronize()
    after = se_work(device)
    gates = {k: after[k] - before[k] for k in after}
    profiled_ms = start.elapsed_time(end)
    adam_launches = adam_counts(trainer, 2, "d2se")
    out = {"phase": "d2se", "model": f"Generator({D2SE_MODEL['backbone']}, num_points="
                                     f"{N_POINTS})", "batch": D2SE_BATCH,
           "gates": gates_rows, "gate_kernel_launches_a_step": gate_launches,
           "step_ms": step_ms, "profiled_step_ms": profiled_ms,
           "gate_calls": gates["calls"], "gate_backward_calls": gates["backward_calls"],
           "gate_ms": gates["ms"], "gate_share_of_profiled_step": gates["ms"] / profiled_ms,
           "losses": {k: float(v) for k, v in stats.items()},
           "adam_launches": adam_launches,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    if (gates["calls"], gates["backward_calls"]) != (D2SE_GATES, D2SE_GATES) \
            or not gates["ms"] > 0 or not all(np.isfinite(v) for v in out["losses"].values()):
        raise AssertionError(f"d2se: one profiled step must count {D2SE_GATES} gate forwards "
                             f"and backwards, a positive time and finite losses: {out}")
    return out


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls, by
    CUDA events, after two warm-up calls: the device sleeps first while the
    host enqueues every call, so host time between launches is not counted."""
    import torch

    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(ADAM_HEAD_START_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_ulps(got, want) -> float:
    """The largest elementwise gap in units of the last place of the larger
    of the two values."""
    import torch

    tiny, eps = torch.finfo(torch.float32).tiny, torch.finfo(torch.float32).eps
    big = torch.maximum(got.abs(), want.abs()).clamp_min(tiny)
    return float(((got - want).abs() / (eps * 2.0 ** torch.floor(torch.log2(big)))).max())


def phase_adam(device, reports: dict) -> dict:
    """The Adam pass (``csrc/adam.cu`` through ``ops/adam.Adam``) on each
    of ADAM_SETS' parameter sets, seeded normal values and gradients:
    ADAM_STEPS steps against ``torch.optim.Adam(foreach=True)`` on copies
    (the moments within 1 ulp, the parameters within 4 ulp of their
    largest; the elements that differ at all counted), one launch a step
    and every element counted; then the device ms a step of the pass, of
    torch's one-pass ``Adam(fused=True)`` (``library_ms``), of foreach Adam
    (``foreach_ms``) and of the plain version beside the
    28-bytes-a-parameter bound, and each one's host ms a call. With the
    pass's ptxas line (registers, spills)."""
    import torch

    from fenet_torch.models.generator import Generator
    from fenet_torch.ops import adam

    hyper = dict(lr=5e-4, weight_decay=1e-4)
    out = {"phase": "adam", "ptxas": [ln.strip() for ln in reports.get("adam", "").splitlines()
                                      if "Used" in ln or "spill" in ln]}
    for name, model in ADAM_SETS.items():
        with torch.device("meta"):
            shapes = [p.shape for p in Generator(num_points=N_POINTS, **model).parameters()]
        gen = torch.Generator(device=device).manual_seed(24)
        init = [torch.randn(s, device=device, generator=gen) * 0.05 for s in shapes]
        grads = [[torch.randn(s, device=device, generator=gen) * 1e-3 for s in shapes]
                 for _ in range(ADAM_STEPS)]
        ours = [p.clone().requires_grad_() for p in init]
        theirs = [p.clone().requires_grad_() for p in init]
        fused = [p.clone().requires_grad_() for p in init]
        opt = adam.Adam(ours, **hyper)
        ref = torch.optim.Adam(theirs, foreach=True, **hyper)
        lib = torch.optim.Adam(fused, fused=True, **hyper)
        launches = []
        for step in range(ADAM_STEPS):
            for a, b, c, g in zip(ours, theirs, fused, grads[step]):
                a.grad, b.grad, c.grad = g, g, g  # none writes its gradient
            before = adam.adam_kernel.launches
            opt.step()
            launches.append(adam.adam_kernel.launches - before)
            ref.step()
            lib.step()
        torch.cuda.synchronize()
        n = sum(p.numel() for p in init)
        gaps, differ = {}, {}
        for key in ("param", "exp_avg", "exp_avg_sq"):
            pairs = [(a.detach(), b.detach()) if key == "param"
                     else (opt.state[a][key], ref.state[b][key]) for a, b in zip(ours, theirs)]
            gaps[key] = max(max_ulps(x, y) if key != "param" else float(
                (x - y).abs().max() / (torch.finfo(torch.float32).eps * y.abs().max()))
                for x, y in pairs)
            differ[key] = sum(int((x != y).sum()) for x, y in pairs)
        row = {"tensors": len(shapes), "parameters": n, "launches_a_step": launches,
               "elements_last_step": adam.adam_kernel.elements, "max_ulps_vs_foreach": gaps,
               "elements_differing_from_foreach": differ}
        plain = [p.detach().clone() for p in ours]
        moments = ([opt.state[p]["exp_avg"].clone() for p in ours],
                   [opt.state[p]["exp_avg_sq"].clone() for p in ours])
        steps = [float(ADAM_STEPS + 1)] * len(plain)
        calls = {"kernel": opt.step, "library": lib.step, "foreach": ref.step,
                 "plain": lambda: adam.adam_plain(plain, grads[0], *moments, steps, beta1=0.9,
                                                  beta2=0.999, eps=1e-8, **hyper)}
        for label, fn in calls.items():
            row[f"{label}_ms"] = device_ms(fn, 20 if label != "plain" else 5)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            row[f"{label}_host_ms"] = (time.perf_counter() - t) * 1e3
        row["bound_ms"] = n * ADAM_BYTES_PER_PARAM / PEAK_BYTES_PER_S * 1e3
        row["kernel_bytes_per_s"] = n * ADAM_BYTES_PER_PARAM / row["kernel_ms"] * 1e3
        out[name] = row
        want = [-(-len(shapes) // adam.MAX_TENSORS)] * ADAM_STEPS
        if (launches != want or adam.adam_kernel.elements != n
                or gaps["exp_avg"] > 1 or gaps["exp_avg_sq"] > 1 or gaps["param"] > 4):
            emit(out)
            raise AssertionError(f"adam ({name}): launches {launches} (want {want}), elements "
                                 f"{adam.adam_kernel.elements} (want {n}), ulps {gaps}")
        del init, grads, ours, theirs, fused, opt, ref, lib, plain, moments, calls
        torch.cuda.empty_cache()
    emit(out)
    return out


def model_name(n: int = N_POINTS) -> str:
    return (f"Generator({MODEL['backbone']}, num_points={n}, "
            f"fine_width={MODEL['fine_width']}, mid_width={MODEL['mid_width']})")


def make_model(device, head_scale: float = HEAD_SCALE, n: int = N_POINTS):
    import torch

    from fenet_torch.models.generator import Generator, init_random_

    with torch.device(device):
        gen = Generator(num_points=n, **MODEL)
    init_random_(gen, torch.Generator(device=device).manual_seed(0))
    with torch.no_grad():
        for layer in (gen.fc3_1, gen.conv2_1, gen.conv1_3):
            layer.weight.mul_(head_scale)
            layer.bias.mul_(head_scale)
    return gen.eval()


def phase_eval(device, n: int = N_POINTS):
    import numpy as np
    import torch

    from fenet_torch.data.loader import DataLoader
    from fenet_torch.data.synthetic import SyntheticShapeNet
    from fenet_torch.eval.runner import evaluate_dataset, make_eval_step
    from fenet_torch.geometry.icp import align_pred_to_gt
    from fenet_torch.ops import chamfer, emd

    gen = make_model(device, n=n)
    ds = SyntheticShapeNet(n_models=6, num_points=n, seed=0)
    loader = DataLoader(ds, BATCH)
    first = next(iter(loader))
    step = make_eval_step(gen, device=device)
    step(first["image"], first["points"])  # warm-up: cuDNN plans, library loads
    torch.cuda.synchronize()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, summary = evaluate_dataset(gen, loader, category="synthetic", device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    n_batches = len(loader)
    want = {"chamfer_nn": 2 * n_batches, "emd_auction": 0, "emd_auction_stream": 0,
            "sinkhorn": 0}
    want[emd_kernel_name(n)] = n_batches
    if launches != want:
        raise AssertionError(f"eval path launched {launches} over {n_batches} batches")
    if summary["samples"] != len(ds) or not all(
            np.isfinite(summary[k]) for k in ("EMD_distance", "ChamferDistance")):
        raise AssertionError(f"eval summary is wrong: {summary}")

    # Per-phase times on the first batch, host clock around synchronised work.
    images = torch.as_tensor(first["image"]).to(device)
    points = torch.as_tensor(first["points"]).to(device)
    phases = {}
    timed = functools.partial(timed_ms, phases)

    with torch.inference_mode():
        pred = timed("generator_ms", lambda: gen(images)[2])
        aligned = timed("icp_ms", lambda: align_pred_to_gt(pred, points))
        timed("emd_ms", lambda: emd.earth_mover_distance(aligned, points))
        timed("chamfer_ms", lambda: chamfer.chamfer_distance(aligned, points))
    emit({"phase": "eval", "model": model_name(n), "batch": BATCH, "batches": n_batches,
          "samples": summary["samples"], "wall_s": wall,
          "samples_per_s": summary["samples"] / wall,
          "EMD_distance": summary["EMD_distance"],
          "ChamferDistance": summary["ChamferDistance"], "launches": launches,
          "first_batch_phase_ms": phases,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "pred_abs_max": float(pred.abs().max())})

    # Reference on a small input: each stage on the card against the same
    # stage on the CPU, on identical inputs. The generator differs only by
    # convolution summation order. ICP is checked on a noise-free rotated
    # copy, which it aligns exactly (a translation would not come back
    # exactly: the eval's `pred @ R - t` is the reference's formula, not the
    # inverse transform); on noisy clouds its float32 plateau
    # test may stop on another iteration when sums round differently
    # (measured 3e-4 on the aligned clouds). The metrics then run on the
    # CPU's aligned noisy clouds on both sides.
    cpu_gen = copy.deepcopy(gen).cpu()
    with torch.inference_mode():
        ref = cpu_gen(images[:2].cpu())[2]
    rel = float((pred[:2].cpu() - ref).abs().max() / ref.abs().max())
    rng = np.random.RandomState(1)
    gt = points[:2].cpu()
    ang = 0.3
    rot = torch.tensor([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                        [0, 0, 1]], dtype=torch.float32)
    moved = gt @ rot.T
    noisy = moved + torch.tensor(rng.normal(0, 0.01, gt.shape), dtype=torch.float32)
    with torch.inference_mode():
        al_card = align_pred_to_gt(moved.to(device), gt.to(device)).cpu()
        al_host = align_pred_to_gt(moved, gt)
        al = align_pred_to_gt(noisy, gt)
    card, host = {}, {}
    for out, dev in ((card, device), (host, torch.device("cpu"))):
        with torch.inference_mode():
            d, _ = emd.earth_mover_distance(al.to(dev), gt.to(dev))
            d1, d2, _, _ = chamfer.chamfer_distance(al.to(dev), gt.to(dev))
        out.update(emd=d.sqrt().mean(1).cpu() * 100,
                   cd=(d1.mean(1) + d2.mean(1)).cpu() * 100)
    checks = {
        "generator_rel_err": rel,
        "icp_aligned_max_abs_err": float((al_card - al_host).abs().max()),
        "icp_residual": float((al_card - gt).abs().max()),
        "cd_rel_err": float(((card["cd"] - host["cd"]).abs() / host["cd"]).max()),
        "emd_rel_err": float(((card["emd"] - host["emd"]).abs() / host["emd"]).max()),
    }
    limits = {"generator_rel_err": 1e-4, "icp_aligned_max_abs_err": 1e-5,
              "icp_residual": 1e-4, "cd_rel_err": 1e-5, "emd_rel_err": 1e-2}
    emit({"phase": "reference", "path": f"eval, N={n}", "card_vs_cpu": checks,
          "limits": limits})
    for key, limit in limits.items():
        if not checks[key] <= limit:
            raise AssertionError(f"card vs CPU {key} = {checks[key]} > {limit}")
    profile_step(lambda: step(first["image"], first["points"]),
                 f"eval step (batch {BATCH}, N={n})")
    return launches, aligned.contiguous(), points.contiguous()


def phase_pix3d(device) -> dict:
    """eval_pix3d through its CLI entry on a synthetic Pix3D tree under
    build/ (PIX3D_SAMPLES a category, three categories), with the eval
    init saved as model_best.pth.tar for the three mapped ShapeNet ids: the
    counts set to 0 around it, 2 chamfer launches and 1 auction launch a
    batch; then the data (read and decoded in this thread), generator, ICP
    and EMD ms of one category's first batch. Returns the launch counts."""
    import shutil

    import numpy as np
    import torch

    from fenet_torch.cli import eval_pix3d
    from fenet_torch.data.loader import DataLoader
    from fenet_torch.data.pix3d import Pix3DDataset
    from fenet_torch.data.synthetic import write_synthetic_pix3d
    from fenet_torch.geometry.icp import align_pred_to_gt
    from fenet_torch.ops import emd

    root = ROOT / "build" / "chip_smoke_pix3d"
    shutil.rmtree(root, ignore_errors=True)
    cats = tuple(eval_pix3d.PIX3D_TO_SHAPENET)
    write_synthetic_pix3d(str(root / "pix3d"), cats=cats, samples_per_cat=PIX3D_SAMPLES,
                          num_points=N_POINTS)
    gen = make_model(device, n=N_POINTS)
    first = None
    for cat_id in eval_pix3d.PIX3D_TO_SHAPENET.values():
        path = root / "out" / cat_id / "checkpoints" / "model_best.pth.tar"
        path.parent.mkdir(parents=True)
        if first is None:
            torch.save({"state_dict": gen.state_dict()}, path)
            first = path
        else:
            path.symlink_to(first)
    args = ["--device", "cuda", "--num_points", str(N_POINTS), "--cats", *cats,
            "--backbone", MODEL["backbone"], "--fine_width", str(MODEL["fine_width"]),
            "--mid_width", str(MODEL["mid_width"]), "--data_dir", str(root / "pix3d"),
            "--model", str(root / "out" / "%s" / "checkpoints")]
    reset_counts()
    t0 = time.perf_counter()
    results = eval_pix3d.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    batches = len(cats) * -(-PIX3D_SAMPLES // 32)  # the CLI's --batchSize 32
    want = {"chamfer_nn": 2 * batches, "emd_auction": batches, "emd_auction_stream": 0,
            "sinkhorn": 0}
    if launches != want:
        raise AssertionError(f"eval_pix3d launched {launches}, not {want}")
    for cat, summary in results.items():
        if summary["samples"] != PIX3D_SAMPLES or not all(
                np.isfinite(summary[k]) for k in ("EMD_distance", "ChamferDistance")):
            raise AssertionError(f"eval_pix3d summary for {cat} is wrong: {summary}")

    phases = {}
    timed = functools.partial(timed_ms, phases)
    loader = DataLoader(Pix3DDataset(str(root / "pix3d"), category=cats[0], num_points=N_POINTS),
                        32, prefetch=0)
    batch = timed("data_ms", lambda: next(iter(loader)))
    images = torch.as_tensor(batch["image"]).to(device)
    points = torch.as_tensor(batch["points"]).to(device)

    with torch.inference_mode():
        pred = timed("generator_ms", lambda: gen(images)[2])
        aligned = timed("icp_ms", lambda: align_pred_to_gt(pred, points))
        timed("emd_ms", lambda: emd.earth_mover_distance(aligned, points))
    samples = sum(r["samples"] for r in results.values())
    emit({"phase": "pix3d", "model": model_name(N_POINTS), "cats": list(cats), "batch": 32,
          "samples": samples, "wall_s": wall, "samples_per_s": samples / wall,
          "cli_samples_per_s": {c: r["samples_per_second"] for c, r in results.items()},
          "launches": launches, "first_batch_phase_ms": phases,
          "summary": {c: {k: r[k] for k in ("EMD_distance", "ChamferDistance", "samples")}
                      for c, r in results.items()}})
    shutil.rmtree(root)
    return launches


def record_emd_inputs(trainer) -> list:
    """Make ``trainer`` record the (pred, gt) clouds of every EMD loss call,
    detached and contiguous, as its kernel takes them."""
    seen = []
    emd = trainer.emd

    def recording(pred, points):
        seen.append((pred.detach().contiguous(), points.detach().contiguous()))
        return emd(pred, points)

    trainer.emd = recording
    return seen


def counted_steps(trainer, images, points, lr):
    """Three train steps with the counts set to 0 and the peak memory reset
    before them: each step's losses, its ms on the host clock and between
    CUDA events around it (the device's timeline, idle gaps included), and
    the launch counts of the three."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_ms, step_event_ms = [], [], []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        stats = trainer.train_step(images, points, TRAIN_EPOCH, lr)
        end.record()
        losses.append({k: float(v) for k, v in stats.items()})  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_event_ms.append(start.elapsed_time(end))
    return losses, step_ms, step_event_ms, launch_counts()


def split_step(trainer, images, points, lr) -> dict:
    """One train step in its parts, each timed by the host clock around
    synchronised work: what Trainer.train_step does, piece by piece (in the
    finetune mode also the projection and its BCE)."""
    import torch

    from fenet_torch.losses.facade import chamfer_loss

    ms = {}
    torch.cuda.synchronize()
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[name] = (now - t) * 1e3
        t = now

    images = torch.as_tensor(images).to(trainer.device)
    points = torch.as_tensor(points).to(trainer.device, torch.float32)
    trainer.model.train()
    for group in trainer.optimizer.param_groups:
        group["lr"] = lr
    trainer.optimizer.zero_grad(set_to_none=True)
    mark("input_ms")
    _, _, pred = trainer.model(images)
    mark("forward_ms")
    cd = chamfer_loss(pred, points)
    mark("chamfer_loss_ms")
    emd = trainer.emd(pred, points)
    mark("emd_loss_ms")
    cfg = trainer.config
    total = cfg.lambda_cd * cd + cfg.lambda_emd * emd
    if trainer.loss_mode == "finetune":
        total = total + cfg.lambda_bce * trainer.bce(pred, points)
        mark("projection_bce_ms")
    total.backward()
    mark("backward_ms")
    trainer.optimizer.step()
    mark("adam_ms")
    return ms


def phase_train(device, n: int = N_POINTS) -> dict:
    """The training step at n points in each EMD mode, the chamfer
    backward's determinism, train_net, and (at 1024 points) one step on the
    card against the CPU. Returns each mode's launch counts and the clouds
    its kernels saw."""
    import numpy as np
    import torch

    from fenet_torch.data.loader import DataLoader
    from fenet_torch.data.synthetic import SyntheticShapeNet
    from fenet_torch.losses.facade import chamfer_loss
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer, reference_lr_schedule

    gen = make_model(device, head_scale=1.0, n=n)
    init_state = {k: v.clone() for k, v in gen.state_dict().items()}
    ds = SyntheticShapeNet(n_models=6, num_points=n, variety=True, seed=0)
    batch = next(iter(DataLoader(ds, TRAIN_BATCH, shuffle=True, drop_last=True, seed=0)))
    images = batch["image"].astype(np.uint8)  # the reader's uint8 pixels
    points = batch["points"]
    lr = reference_lr_schedule(5e-4, TRAIN_EPOCH)
    info = {}
    for mode, (overrides, kernel) in TRAIN_MODES.items():
        gen.load_state_dict(init_state)
        trainer = Trainer(gen, TrainConfig(batch_size=TRAIN_BATCH, **overrides), device=device)
        seen = record_emd_inputs(trainer)
        trainer.train_step(images, points, TRAIN_EPOCH, lr)  # warm-up: cuDNN plans
        losses, step_ms, step_event_ms, launches = counted_steps(trainer, images, points, lr)
        want = {"chamfer_nn": 6, "emd_auction": 0, "emd_auction_stream": 0, "sinkhorn": 0}
        want[emd_kernel_name(n) if kernel == "emd_auction" else kernel] = 3
        if launches != want:
            raise AssertionError(f"train ({mode}) launched {launches}, not {want}")
        plan = plan_launches()
        if plan != {"sinkhorn_plan": 3 if mode == "sinkhorn" else 0, "sinkhorn_plan_columns": 0}:
            raise AssertionError(f"train ({mode}) launched the plan kernels {plan}")
        adam_launches = adam_counts(trainer, 3, f"train ({mode})")
        if not all(np.isfinite(v) for step in losses for v in step.values()):
            raise AssertionError(f"train ({mode}) losses are not finite: {losses}")
        if not losses[2]["total_loss"] < losses[0]["total_loss"]:
            raise AssertionError(f"train ({mode}) loss did not fall: {losses}")
        peak = torch.cuda.max_memory_allocated()
        split = split_step(trainer, images, points, lr)
        syncs = host_syncs(lambda: trainer.train_step(images, points, TRAIN_EPOCH, lr))
        # The clouds the EMD loss saw: the warm-up step's, then the first
        # counted step's, on which the kernels line times this mode's kernel.
        info[mode] = {"launches": launches, "step_ms": step_ms,
                      "pred": seen[1][0], "gt": seen[1][1],
                      "warmup_pred": seen[0][0]}
        extra = {}
        if mode == "scaled":
            extra["gate_open_elements_per_step"] = [
                gate_open_elements(pred, gt) for pred, gt in seen[:4]]
        emit({"phase": "train", "mode": mode, "config": overrides,
              "model": model_name(n), "batch": TRAIN_BATCH, "launches": launches,
              "plan_launches": plan, "adam_launches": adam_launches, "losses": losses,
              "step_ms": step_ms, "step_event_ms": step_event_ms,
              "samples_per_s": TRAIN_BATCH * 3e3 / sum(step_ms),
              "split_step_ms": split, "max_memory_allocated_bytes": peak,
              "host_syncs_per_step": syncs, **extra})
        if mode == "auction":
            profile_step(lambda: trainer.train_step(images, points, TRAIN_EPOCH, lr),
                         f"train step ({mode}, batch {TRAIN_BATCH}, N={n})")
        # The recording wrapper refers back to the trainer: drop it, or this
        # trainer and its Adam state outlive the mode.
        del trainer.emd

    # The last mode's trainer holds its Adam state (~1.4 GB at full width):
    # drop it, or it counts in the finetune phase's peak memory.
    del trainer
    # The chamfer backward is a deterministic scatter: identical bits twice.
    grads = []
    for _ in range(2):
        pred = info["auction"]["pred"].clone().requires_grad_(True)
        chamfer_loss(pred, info["auction"]["gt"]).backward()
        grads.append(pred.grad)
    if not torch.equal(grads[0], grads[1]):
        raise AssertionError("chamfer backward differs between two identical runs")
    emit({"phase": "train", "check": "chamfer backward deterministic", "N": n,
          "identical": True, "grad_abs_max": float(grads[0].abs().max())})
    info["finetune"] = phase_finetune(device, gen, init_state, images, points, n)
    info["finetune_net"] = phase_train_net(device, gen, init_state, n)
    if n == N_POINTS:
        phase_train_reference(device, gen, init_state, images[:2], points[:2], lr)
        phase_train_reference(device, gen, init_state, images[:2], points[:2],
                              reference_lr_schedule(FINETUNE_LR, 1), finetune=True)
    return info


def phase_finetune(device, gen, init_state, images, points, n: int) -> dict:
    """The finetune step (100·BCE + 100·CD + 100·EMD, fenet's raw splat) at
    n points on the train phase's batch of 128, from the unscaled init: one
    warm-up step, three steps with the counts set to 0 (2 chamfer launches
    and 1 auction launch a step, finite losses), their ms on the host clock
    and between CUDA events, the step's split, peak memory, the host syncs
    of one step, one profiled step, and one step with ``proj_squash``.
    Returns the three steps' launch counts."""
    import numpy as np
    import torch

    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer, reference_lr_schedule

    lr = reference_lr_schedule(FINETUNE_LR, 1)
    gen.load_state_dict(init_state)
    trainer = Trainer(gen, TrainConfig(batch_size=TRAIN_BATCH, lr=FINETUNE_LR),
                      loss_mode="finetune", device=device)
    trainer.train_step(images, points, TRAIN_EPOCH, lr)  # warm-up
    losses, step_ms, step_event_ms, launches = counted_steps(trainer, images, points, lr)
    want = {"chamfer_nn": 6, "emd_auction": 0, "emd_auction_stream": 0, "sinkhorn": 0}
    want[emd_kernel_name(n)] = 3
    if launches != want:
        raise AssertionError(f"finetune launched {launches}, not {want}")
    peak = torch.cuda.max_memory_allocated()
    split = split_step(trainer, images, points, lr)
    syncs = host_syncs(lambda: trainer.train_step(images, points, TRAIN_EPOCH, lr))
    profile_step(lambda: trainer.train_step(images, points, TRAIN_EPOCH, lr),
                 f"finetune step (batch {TRAIN_BATCH}, N={n})")
    gen.load_state_dict(init_state)
    squashed = Trainer(gen, TrainConfig(batch_size=TRAIN_BATCH, lr=FINETUNE_LR,
                                        proj_squash=True), loss_mode="finetune", device=device)
    t0 = time.perf_counter()
    squash_losses = {k: float(v) for k, v in
                     squashed.train_step(images, points, TRAIN_EPOCH, lr).items()}
    squash_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.isfinite(v) for step in losses + [squash_losses] for v in step.values()):
        raise AssertionError(f"finetune losses are not finite: {losses}, {squash_losses}")
    cfg = trainer.config
    emit({"phase": "finetune", "model": model_name(n), "batch": TRAIN_BATCH, "lr": lr,
          "grid": [cfg.grid_h, cfg.grid_w], "sigma_sq": cfg.sigma_sq, "launches": launches,
          "launches_per_step": {k: v / 3 for k, v in launches.items() if v},
          "losses": losses, "step_ms": step_ms, "step_event_ms": step_event_ms,
          "samples_per_s": TRAIN_BATCH * 3e3 / sum(step_ms), "split_step_ms": split,
          "max_memory_allocated_bytes": peak, "host_syncs_per_step": syncs,
          "proj_squash_step": {"losses": squash_losses, "step_ms": squash_ms}})
    return launches


def phase_train_net(device, gen, init_state, n: int):
    """train_net at n points for 2 epochs, validating at epoch 2; its
    checkpoint must load back with strict=True. At N_POINTS, then
    train_net(loss_mode="finetune") resumes from that checkpoint for one
    epoch before the checkpoint is deleted; returns its launch counts."""
    import dataclasses
    import math
    import tempfile

    import torch

    from fenet_torch.data.synthetic import SyntheticShapeNet
    from fenet_torch.models.generator import Generator
    from fenet_torch.train.checkpoint import BEST, load_checkpoint
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.driver import train_net

    gen.load_state_dict(init_state)
    # 24 views a model: the fewest models that fill one batch an epoch.
    train_ds = SyntheticShapeNet(n_models=-(-TRAIN_BATCH // 24), num_points=n,
                                 variety=True, seed=0)
    val_ds = SyntheticShapeNet(n_models=1, num_points=n, seed=1)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        cfg = TrainConfig(batch_size=TRAIN_BATCH, num_points=n, nepoch=2,
                          validate_epochs=(2,), train_save_freq=0, dir_path=tmp,
                          manual_seed=0)
        reset_counts()
        t0 = time.perf_counter()
        out = train_net("synthetic", cfg, train_ds, val_ds, model=gen, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        # 2 epochs of training steps, then the validation batches: each runs
        # chamfer (2 launches) and the auction (1).
        steps = 2 * (len(train_ds) // TRAIN_BATCH) + -(-len(val_ds) // TRAIN_BATCH)
        want = {"chamfer_nn": 2 * steps, "emd_auction": 0, "emd_auction_stream": 0,
                "sinkhorn": 0}
        want[emd_kernel_name(n)] = steps
        if launches != want:
            raise AssertionError(f"train_net launched {launches}, not {want}")
        history = out["history"]
        if len(history) != 2 or "val" not in history[1]:
            raise AssertionError(f"train_net history is wrong: {history}")
        t1 = time.perf_counter()
        blob = load_checkpoint(str(Path(out["ckpt_dir"]) / BEST))
        with torch.device(device):
            fresh = Generator(num_points=n, **MODEL)
        fresh.load_state_dict(blob["state_dict"], strict=True)
        if not torch.equal(fresh.fc3_1.weight, gen.fc3_1.weight) or blob["epoch"] != 2:
            raise AssertionError("the checkpoint does not hold the trained weights")
        emit({"phase": "train_net", "N": n, "epochs": 2, "wall_s": wall, "launches": launches,
              "history": history, "checkpoint_load_s": time.perf_counter() - t1,
              "checkpoint_bytes": (Path(out["ckpt_dir"]) / BEST).stat().st_size,
              "loads_strict": True})
        if n != N_POINTS:
            return None
        # The finetune resumes from this checkpoint (epoch 2) for one epoch:
        # --nepoch 3 at the finetune CLI's LR, no validation.
        trained = fresh.fc3_1.weight.detach().clone()
        del blob, fresh
        cfg = dataclasses.replace(cfg, resume=True, nepoch=3, lr=FINETUNE_LR,
                                  validate_epochs=())
        reset_counts()
        t0 = time.perf_counter()
        out = train_net("synthetic", cfg, train_ds, val_ds, loss_mode="finetune", model=gen,
                        device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        steps = len(train_ds) // TRAIN_BATCH
        want = {"chamfer_nn": 2 * steps, "emd_auction": steps, "emd_auction_stream": 0,
                "sinkhorn": 0}
        if launches != want:
            raise AssertionError(f"finetune train_net launched {launches}, not {want}")
        history = out["history"]
        if [h["epoch"] for h in history] != [3] or not all(
                math.isfinite(history[0][k]) for k in ("chamfer_loss", "emd_loss")):
            raise AssertionError(f"finetune train_net history is wrong: {history}")
        if torch.equal(gen.fc3_1.weight, trained):
            raise AssertionError("the finetune epoch did not move the weights")
        emit({"phase": "finetune_net", "N": n, "resumed_from_epoch": 2, "epochs": [3],
              "wall_s": wall, "launches": launches, "history": history})
        return launches


def phase_train_reference(device, gen, init_state, images, points, lr,
                          finetune: bool = False) -> None:
    """One train step (default mode, or with ``finetune`` the finetune
    step) on the card against the same step on the CPU, from identical
    weights, at full width on a batch of 2. The finetune step's BCE term is
    read from the trainer's own call."""
    import copy

    import torch

    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer

    gen.load_state_dict(init_state)
    cpu_gen = copy.deepcopy(gen).cpu()
    cfg = TrainConfig(batch_size=len(images))
    mode = "finetune" if finetune else "schedule"
    stats = []
    for model, dev in ((gen, device), (cpu_gen, torch.device("cpu"))):
        trainer = Trainer(model, cfg, loss_mode=mode, device=dev)
        seen = {}

        def recording(pred, pts, bce=trainer.bce, seen=seen):
            value = bce(pred, pts)
            seen["bce"] = value.detach()
            return value

        trainer.bce = recording
        t0 = time.perf_counter()
        seen.update(trainer.train_step(images, points, TRAIN_EPOCH, lr))
        seen["s"] = time.perf_counter() - t0
        stats.append(seen)
    card, host = stats
    g_card, g_host = gen.fc3_1.weight.grad.cpu(), cpu_gen.fc3_1.weight.grad
    rel = lambda key: abs(float(card[key]) - float(host[key])) / abs(float(host[key]))
    checks = {"cd_rel_err": rel("chamfer_loss"), "emd_rel_err": rel("emd_loss"),
              "fc3_1_grad_rel_err": float((g_card - g_host).norm() / g_host.norm())}
    # CD as in eval. EMD as in eval: the auction may resolve a near-tie the
    # other way on predictions that differ by ~1e-6. The gradient of fc3_1
    # (relative L2) carries that: a few flipped rows of 2048 move it ~1e-3.
    limits = {"cd_rel_err": 1e-5, "emd_rel_err": 1e-2, "fc3_1_grad_rel_err": 1e-2}
    extra = {}
    if finetune:
        checks["bce_rel_err"] = rel("bce")
        limits["bce_rel_err"] = 1e-5
        extra = {"bce": float(host["bce"])}
    emit({"phase": "reference", "path": f"{mode} step, batch 2", "card_vs_cpu": checks,
          "limits": limits, "cpu_step_s": host["s"], **extra})
    for key, limit in limits.items():
        if not checks[key] <= limit:
            raise AssertionError(f"{mode} step card vs CPU {key} = {checks[key]} > {limit}")


def sinkhorn_loss_gap(x, y, kernel, plain) -> float:
    """The relative gap between the Sinkhorn-mode loss (eps 1e-4) from the
    kernel's potentials and from the plain ones, (f, g) each, on x, y.
    Raises above SINKHORN_LOSS_REL_LIMIT."""
    from fenet_torch.losses.sinkhorn import plan_loss
    from fenet_torch.ops.pairwise import pairwise_sqdist

    c = pairwise_sqdist(x, y)
    want = float(plan_loss(c, c, *plain, 1e-4))
    gap = abs(float(plan_loss(c, c, *kernel, 1e-4)) - want) / abs(want)
    if not gap <= SINKHORN_LOSS_REL_LIMIT:
        raise AssertionError(f"sinkhorn loss from the kernel's potentials is {gap} off the "
                             f"plain one's, over {SINKHORN_LOSS_REL_LIMIT} (B={x.shape[0]}, "
                             f"N={x.shape[1]})")
    return gap


def profile_step(step, path: str) -> None:
    """One call of ``step`` under torch.profiler: the device's busy time
    against the call's wall time, and the kernels that take the device time.
    The profiler's own host cost lengthens the wall time a little, so the
    idle share is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # Device-side events only: an operator's row repeats its kernels' time.
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    emit({"phase": "profile", "path": path, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
          "device_launches": sum(c for _, _, c in kernels),
          "top_kernels_ms": [[name[:90], ms, count] for name, ms, count in top]})


def randomize_bn_(model, seed: int):
    """Seeded random BN affine parameters and running statistics (on the
    model's device), so that the deploy fold is not the identity."""
    import torch

    g = torch.Generator(device=model.fc1.weight.device).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.3, 0.3, generator=g)
                m.running_mean.normal_(0.0, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref|, in float32."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max())


def assert_no_launches(path: str) -> dict:
    """The counts since the last reset_counts(): the serving path runs none
    of the kernels (its forward is the generator alone)."""
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"the {path} path launched {launches}")
    return launches


def phase_deploy(device):
    """to_deploy of the eval init with random BN statistics, in float32 and
    bf16: the fold against the branched forward, bf16 against float32, the
    float32 fold on the card against the CPU; then each forward's CUDA-event
    ms, images/s and bound at DEPLOY_BATCHES. Returns (branched model,
    launches)."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from fenet_torch.models.generator import to_deploy
    from fenet_torch.utils.device import full_fp32

    full_fp32()
    gen = randomize_bn_(make_model(device, n=N_POINTS), 7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    phases = {}
    dep32 = timed_ms(phases, "fold_float32_ms", lambda: to_deploy(gen))
    dep16 = timed_ms(phases, "fold_bfloat16_ms", lambda: to_deploy(gen, torch.bfloat16))
    rng = np.random.RandomState(3)
    images = torch.tensor(rng.randint(0, 256, (max(DEPLOY_BATCHES), 128, 128, 3)),
                          dtype=torch.uint8, device=device)
    with torch.inference_mode():
        branched = gen(images)[2]
        folded = dep32(images)[2]
        folded16 = dep16(images)[2]
        host = copy.deepcopy(dep32).cpu()(images[:2].cpu())[2]
    if folded16.dtype != torch.bfloat16 or not torch.isfinite(folded16).all():
        raise AssertionError(f"the bf16 fold gave {folded16.dtype}, finite "
                             f"{bool(torch.isfinite(folded16).all())}")
    checks = {"fold_rel_err": rel_err(folded, branched),
              "bf16_rel_err": rel_err(folded16, folded),
              "card_vs_cpu_rel_err": rel_err(folded[:2].cpu(), host)}
    limits = {"fold_rel_err": FOLD_REL_LIMIT, "bf16_rel_err": BF16_REL_LIMIT,
              "card_vs_cpu_rel_err": 1e-4}

    # Bounds: the forward's convolution and matmul FLOPs (PyTorch's FLOP
    # counter, an image) at the float32 peak (TF32 off) or the bf16 tensor
    # core peak, or its weights read once at the memory rate.
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        dep32(images[:1])
    flops = counter.get_total_flops()
    timing = {}
    for name, model, peak in (("branched", gen, PEAK_FP32_FLOPS),
                              ("float32_fold", dep32, PEAK_FP32_FLOPS),
                              ("bfloat16_fold", dep16, PEAK_BF16_FLOPS)):
        weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        for b in DEPLOY_BATCHES:
            x = images[:b]
            with torch.inference_mode():
                ms = cuda_ms(lambda: model(x), reps=20, warmup=3)
            t_ops, t_bytes = flops * b / peak, (weight_bytes + x.numel()) / PEAK_BYTES_PER_S
            timing[f"{name}_b{b}"] = {"ms": ms, "images_per_s": b / ms * 1e3,
                                      "bound_ms": max(t_ops, t_bytes) * 1e3,
                                      "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    launches = assert_no_launches("deploy")
    emit({"phase": "deploy", "model": model_name(N_POINTS), "checks": checks, "limits": limits,
          "fold_ms": phases, "gflop_per_image": flops / 1e9, "forward": timing,
          "launches": launches,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "pred_abs_max": float(folded.abs().max())})
    for key, limit in limits.items():
        if not checks[key] <= limit:
            raise AssertionError(f"deploy {key} = {checks[key]} > {limit}")
    return gen, launches


def serve_clients(url: str, paths: list, clients: int, per_client: int, n_points: int):
    """``clients`` threads, each POSTing ``per_client`` of the PNG files
    ``paths`` (in turn) to ``url`` and checking each reply's cloud. Runs in
    a process of its own, so the clients do not take the server's GIL.
    Returns (latencies in s, wall s, bad reply shapes, failures)."""
    import threading
    import urllib.request

    import numpy as np

    bodies = [Path(p).read_bytes() for p in paths]
    latencies, bad, failures = [], [], []
    lock = threading.Lock()

    def client(c):
        try:
            for k in range(per_client):
                body = bodies[(c * per_client + k) % len(bodies)]
                t = time.perf_counter()
                with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                            timeout=120) as r:
                    pts = np.asarray(json.load(r)["points"], np.float32)
                dt = time.perf_counter() - t
                with lock:
                    latencies.append(dt)
                    if pts.shape != (n_points, 3) or not np.isfinite(pts).all():
                        bad.append(pts.shape)
        except Exception as e:  # reported and asserted by the caller
            with lock:
                failures.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        failures.append("a client thread did not finish in 600 s")
    return latencies, wall, bad, failures


def phase_serve(device, gen) -> dict:
    """The serving path through its entry points, from a .pth.tar of
    ``gen`` under build/ (deleted after): export_deploy in both formats and
    dtypes (sizes, export and load seconds; each .pt2 against to_deploy's
    module), the HTTP server on the bf16 artifact driven by SERVE_CLIENTS
    client threads in a process of their own with SERVE_REQUESTS PNG
    renders (requests/s, latency, batch fill, the forwards' share of the
    wall, the host's ms a request; /stats must count every request the
    moment the last reply is in), then the predict CLI over PREDICT_IMAGES
    PNGs (one PLY against its forward row). Between the two, the forward
    over every visible card, and two replicas on one card (TWO_REPLICAS) at
    TWO_REPLICA_BATCH: the float32 fold and the bf16 .pt2 against their
    one-device forwards, no host sync in the split forward, and the HTTP
    server again through the bf16 .pt2's two replicas. Returns the launch
    counts of export_deploy's, the servers' and predict's runs."""
    import shutil

    import numpy as np
    import torch

    from fenet_torch.cli import export_deploy, predict
    from fenet_torch.data.synthetic import write_synthetic_shapenet
    from fenet_torch.models.generator import to_deploy
    from fenet_torch.serve.artifact import load_artifact
    from fenet_torch.serve.batcher import fetch
    from fenet_torch.serve.server import build_forward
    from fenet_torch.utils.ply import load_pointcloud

    root = ROOT / "build" / "chip_smoke_serve"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ckpt = root / "model_best.pth.tar"
    torch.save({"state_dict": gen.state_dict()}, ckpt)
    arch = ["--num_points", str(N_POINTS), "--backbone", MODEL["backbone"],
            "--fine_width", str(MODEL["fine_width"]), "--mid_width", str(MODEL["mid_width"])]
    rng = np.random.RandomState(4)
    images = torch.tensor(rng.randint(0, 256, (3, 128, 128, 3)), dtype=torch.uint8,
                          device=device)
    exports, artifact_err = {}, {}
    reset_counts()
    for fmt, suffix in (("torch", ".pth"), ("export", ".pt2")):
        for dtype in ("float32", "bfloat16"):
            out = str(root / f"deploy_{dtype}{suffix}")
            t0 = time.perf_counter()
            export_deploy.main(["--model", str(ckpt), *arch, "--device", str(device),
                                "--dtype", dtype, "--format", fmt, "--out", out])
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            if fmt == "torch":
                export_deploy.load_deploy_checkpoint(out, device)
            else:
                call, _ = load_artifact(out, device)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            exports[f"{fmt}_{dtype}"] = {"bytes": Path(out).stat().st_size,
                                         "export_s": export_s, "load_s": load_s}
            if fmt == "export":
                ref_model = to_deploy(gen, export_deploy.DTYPES[dtype])
                with torch.inference_mode():
                    artifact_err[dtype] = rel_err(call(images), ref_model(images)[2])
                del call, ref_model
    export_launches = assert_no_launches("export_deploy")
    emit({"phase": "serve", "step": "export_deploy", "exports": exports,
          "artifact_rel_err": artifact_err, "limit": ARTIFACT_REL_LIMIT})
    for dtype, err in artifact_err.items():
        if not err <= ARTIFACT_REL_LIMIT:
            raise AssertionError(f"the {dtype} .pt2 artifact is {err} off its module")

    # Requests: PNG renders of the synthetic ShapeNet writer, sent as files.
    write_synthetic_shapenet(str(root / "data"), cats=("02828884",), models_per_cat=4,
                             num_points=N_POINTS)
    pngs = sorted((root / "data" / "ShapeNetRendering").rglob("*.png"))
    artifact = str(root / "deploy_bfloat16.pt2")
    forward, meta = build_forward(artifact, SERVE_MAX_BATCH, device)
    serve_launches = serve_http("http", forward, meta, artifact, pngs)

    # Every visible card ("cuda": 1 on a one-card machine), then two replicas
    # on one card at a batch that the rounding raises (33 -> 34): the float32
    # fold and the bf16 .pt2 against their one-device forwards on the same
    # rows, with no host sync inside the split forward; then the HTTP server
    # on the bf16 .pt2 through the two replicas.
    _, every = build_forward(artifact, SERVE_MAX_BATCH, "cuda")
    reset_counts()
    replicas = {}
    for name, path, limit in (("float32_fold", str(root / "deploy_float32.pth"), SPLIT_REL_LIMIT),
                              ("bfloat16_pt2", artifact, BF16_REL_LIMIT)):
        two, two_meta = build_forward(path, TWO_REPLICA_BATCH, devices=TWO_REPLICAS)
        one, _ = build_forward(path, two_meta["max_batch"], device)
        batch = np.random.RandomState(5).randint(
            0, 256, (two_meta["max_batch"], 128, 128, 3)).astype(np.uint8)
        ref = torch.as_tensor(fetch(one(batch)))
        two(batch)  # warm-up: cuDNN plans at the shard batch, the pinned block
        syncs = host_syncs(lambda: two(batch))
        replicas[name] = {"max_batch": two_meta["max_batch"], "devices": two_meta["devices"],
                          "rel_err_vs_one_device": rel_err(torch.as_tensor(fetch(two(batch))), ref),
                          "limit": limit, "host_syncs_in_forward": syncs}
        if two_meta["max_batch"] != 34 or two_meta["devices"] != 2:
            raise AssertionError(f"two replicas at {TWO_REPLICA_BATCH}: {two_meta}")
        if syncs or not replicas[name]["rel_err_vs_one_device"] <= limit:
            raise AssertionError(f"two replicas ({name}): {replicas[name]}")
    emit({"phase": "serve", "step": "devices", "every_visible_card": every["devices"],
          "cuda_device_count": torch.cuda.device_count(), "two_replicas": replicas,
          "launches": assert_no_launches("split forwards")})
    two, two_meta = build_forward(artifact, SERVE_MAX_BATCH, devices=TWO_REPLICAS)
    two_launches = serve_http("http_two_replicas", two, two_meta, artifact, pngs)

    # predict over PREDICT_IMAGES PNGs.
    img_dir = root / "predict_in"
    img_dir.mkdir()
    for i, p in enumerate(pngs[:PREDICT_IMAGES]):
        shutil.copyfile(p, img_dir / f"{i:03d}.png")
    reset_counts()
    t0 = time.perf_counter()
    written = predict.main(["--deploy_ckpt", artifact, "--images", str(img_dir),
                            "--out_dir", str(root / "predict_out"), "--batchSize",
                            str(SERVE_MAX_BATCH), "--ply_binary", "--device", str(device)])
    predict_s = time.perf_counter() - t0
    predict_launches = assert_no_launches("predict")
    first = np.stack([predict._load_image(str(img_dir / f"{i:03d}.png"))
                      for i in range(SERVE_MAX_BATCH)]).astype(np.uint8)
    row = fetch(forward(first))[0]
    ply = load_pointcloud(str(root / "predict_out" / "000.ply"))
    ply_err = float(np.abs(ply - row).max() / np.abs(row).max())
    emit({"phase": "serve", "step": "predict", "images": len(written), "batch": SERVE_MAX_BATCH,
          "seconds": predict_s, "images_per_s": len(written) / predict_s,
          "ply_vs_forward_rel_err": ply_err, "limit": ARTIFACT_REL_LIMIT,
          "launches": predict_launches})
    if len(written) != PREDICT_IMAGES or not ply_err <= ARTIFACT_REL_LIMIT:
        raise AssertionError(f"predict wrote {len(written)} clouds, PLY {ply_err} off its row")
    shutil.rmtree(root)
    return {"export_deploy": export_launches, "serve": serve_launches,
            "serve_two_replicas": two_launches, "predict": predict_launches}


def serve_http(step: str, forward, meta: dict, artifact: str, pngs: list) -> dict:
    """make_server on ``forward`` at ``meta["max_batch"]`` and a
    SERVE_WINDOW_MS window, driven by SERVE_CLIENTS client threads in a
    process of their own with SERVE_REQUESTS PNG renders: requests/s,
    latency, batch fill, the forwards' share of the wall, the host's ms a
    request (each part alone); /stats must count every request the moment
    the last reply is in. Returns the launch counts of the clients' run."""
    import threading
    import urllib.request

    import cv2
    import numpy as np
    import torch

    from fenet_torch.serve.batcher import fetch
    from fenet_torch.serve.server import make_server
    from fenet_torch.utils.images import normalize_rgb

    max_batch = meta["max_batch"]
    events = []

    def timed_forward(batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = forward(batch)
        end.record()
        events.append((start, end))
        return out

    # Warm-up outside the measured window (cuDNN plans at the serving
    # batch), then the forward alone, back to back, for the device's share.
    full = np.zeros((max_batch, 128, 128, 3), np.uint8)
    fetch(forward(full))
    forward_alone_ms = cuda_ms(lambda: forward(full), reps=20, warmup=2)
    # The host's part of a request, each alone in one thread: the forward's
    # dispatch (the call's host time; the device runs behind it), the PNG
    # decode and crop, the JSON reply's encoding.
    reps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = forward(full)
    host_ms = {"forward_dispatch": (time.perf_counter() - t0) / reps * 1e3}
    cloud = fetch(out)[0]
    body = pngs[0].read_bytes()
    t0 = time.perf_counter()
    for _ in range(reps):
        normalize_rgb(cv2.cvtColor(cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR),
                                   cv2.COLOR_BGR2RGB))
    host_ms["png_decode"] = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        json.dumps({"points": cloud.tolist()}).encode()
    host_ms["json_reply"] = (time.perf_counter() - t0) / reps * 1e3
    server = make_server(artifact, port=0, max_batch=max_batch, window_ms=SERVE_WINDOW_MS,
                         forward=timed_forward, meta=meta)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset_counts()
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
            latencies, wall, bad, failures = pool.submit(
                serve_clients, url + "/predict", [str(p) for p in pngs], SERVE_CLIENTS,
                SERVE_REQUESTS // SERVE_CLIENTS, N_POINTS).result()
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.load(r)
        torch.cuda.synchronize()
        launches = assert_no_launches("serving")
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        thread.join(timeout=30)
    busy_ms = sum(s.elapsed_time(e) for s, e in events)
    lat = np.sort(np.asarray(latencies)) * 1e3
    emit({"phase": "serve", "step": step, "artifact": Path(artifact).name,
          "devices": meta["devices"], "max_batch": max_batch, "window_ms": SERVE_WINDOW_MS,
          "clients": SERVE_CLIENTS,
          "requests": len(latencies), "wall_s": wall, "requests_per_s": len(latencies) / wall,
          "latency_ms": {"p50": float(np.percentile(lat, 50)) if len(lat) else None,
                         "p99": float(np.percentile(lat, 99)) if len(lat) else None,
                         "max": float(lat[-1]) if len(lat) else None},
          "forwards": len(events), "mean_batch_fill": len(latencies) / max(len(events), 1),
          "forward_busy_ms": busy_ms, "forward_share_of_wall": busy_ms / 1e3 / wall,
          "forward_alone_ms": forward_alone_ms, "host_ms_alone": host_ms,
          "device_share_of_wall": len(events) * forward_alone_ms / 1e3 / wall,
          "stats": stats, "launches": launches, "failures": failures[:3]})
    if failures or bad:
        raise AssertionError(f"serving failed: {failures[:3]}, bad replies {bad[:3]}")
    if stats != {"served": SERVE_REQUESTS, "errors": 0}:
        raise AssertionError(f"/stats read {stats} after the last reply")
    return launches


def same_batches(a: dict, b: dict) -> bool:
    """The two batch dicts hold the same keys, dtypes, shapes and bytes."""
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def phase_data(device, in_memory_step_ms) -> dict:
    """The on-disk data path on a written tree under build/ (deleted after):
    DATA_MODELS models of one category at N_POINTS points, 137x137 noise
    PNGs, model 0's cloud repeating its first half (planted FPS ties).

    prepare_data: the tree's 128/256-point files deleted, the CLI on the
    card, then on a copy with --device cpu; the two sets of files must be
    byte-identical. Its seconds a model, one FPS call at 128 and at 256
    points by CUDA events, one call with PyTorch's sync debug mode set to
    "error" (no host sync in the loop; its indices equal the CPU's), one
    model profiled (launches). Batches: one shuffled batch of TRAIN_BATCH
    (variety, uint8, as train_net reads) and one with multi_resolution
    (float32), each through DataLoader._make_batch natively and on the
    per-item path (a dataset whose load_batch declines), in turns; the two
    must be byte-equal, and the batch counters must count each. The native
    images at DATA_THREADS threads. train_net: one epoch of three steps at
    TRAIN_BATCH from the unscaled init, no validation, fed from the tree
    natively and then per item; each with the counts set to 0: K1 2 and
    the auction 1 launch a step, and every batch counted native (or
    declined); the step and data-wait seconds from its log, beside the
    train phase's in-memory step. Returns the launch counts of the three
    paths (prepare_data, train_net native, train_net per item), and the tree
    (``root``, ``tree``), which phase ``parallel`` reads and then deletes."""
    import os
    import random
    import re
    import shutil

    import numpy as np
    import torch

    from fenet_torch import native
    from fenet_torch.cli import prepare_data
    from fenet_torch.data import loader as data_loader
    from fenet_torch.data.loader import DataLoader
    from fenet_torch.data.sample_pcl import sample_model_cloud
    from fenet_torch.data.shapenet import NUM_VIEWS, ShapeNetDataset, load_split
    from fenet_torch.data.synthetic import write_synthetic_shapenet
    from fenet_torch.ops.fps import farthest_point_sample
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.driver import train_net

    class PerItem(ShapeNetDataset):
        """The per-item path, forced: load_batch always declines."""

        def load_batch(self, indices):
            return None

    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError(native.build_error())
    build_s = time.perf_counter() - t0
    root = ROOT / "build" / "chip_smoke_data"
    shutil.rmtree(root, ignore_errors=True)
    tree = root / "tree"
    cat = "02828884"
    t0 = time.perf_counter()
    splits = write_synthetic_shapenet(str(tree), cats=(cat,), models_per_cat=DATA_MODELS,
                                      num_points=N_POINTS)
    write_s = time.perf_counter() - t0
    imgs, pcl = f"{tree}/ShapeNetRendering/", f"{tree}/ShapeNet_pointclouds/"
    models = splits[cat]
    tied = Path(pcl, models[0], f"pointcloud_{N_POINTS}.npy")
    cloud = np.load(tied)
    cloud[N_POINTS // 2:] = cloud[:N_POINTS // 2]
    np.save(tied, cloud)

    # prepare_data on the card, then on the CPU on a copy.
    for model in models:
        for n in (128, 256):
            Path(pcl, model, f"pointcloud_{n}.npy").unlink()
    shutil.copytree(pcl, root / "pcl_cpu")
    args = ["--splits_path", f"{tree}/splits", "--num_points", str(N_POINTS), "--cats", cat]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = prepare_data.main(args + ["--data_dir_pcl", pcl, "--device", device.type])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    prep_launches = assert_no_launches("prepare_data")
    t0 = time.perf_counter()
    written_cpu = prepare_data.main(args + ["--data_dir_pcl", f"{root}/pcl_cpu/",
                                            "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    if not written == written_cpu == DATA_MODELS:
        raise AssertionError(f"prepare_data wrote {written} (card), {written_cpu} (CPU) "
                             f"models, not {DATA_MODELS}")
    differ = [f"{m}/pointcloud_{n}.npy" for m in models for n in (128, 256)
              if Path(pcl, m, f"pointcloud_{n}.npy").read_bytes()
              != Path(root, "pcl_cpu", m, f"pointcloud_{n}.npy").read_bytes()]
    if differ:
        raise AssertionError(f"prepare_data's files differ between card and CPU: {differ}")

    x = torch.as_tensor(cloud, device=device)[None]
    fps_ms = {str(n): cuda_ms(lambda: farthest_point_sample(x, n, ran=n == 256), 5, warmup=1)
              for n in (128, 256)}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx = farthest_point_sample(x, 256, ran=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.equal(idx.cpu(), farthest_point_sample(x.cpu(), 256, ran=True)):
        raise AssertionError("farthest_point_sample differs between card and CPU")
    emit({"phase": "data", "step": "prepare_data", "models": written, "N": N_POINTS,
          "card_s": card_s, "cpu_s": cpu_s, "card_ms_per_model": card_s * 1e3 / written,
          "cpu_ms_per_model": cpu_s * 1e3 / written, "fps_call_ms": fps_ms,
          "files_byte_identical": True, "ties_planted": models[0],
          "fps_sync_free": True, "launches": prep_launches,
          "loader_build_s": build_s, "tree_write_s": write_s})
    profile_step(lambda: sample_model_cloud(cloud, random.Random(0), device),
                 f"prepare_data: one model (FPS of {N_POINTS} points to 128 and 256)")

    # One batch natively and per item, in turns.
    train_models = load_split(f"{tree}/splits", "train_models.json")
    order = np.random.RandomState(0).permutation(DATA_MODELS * NUM_VIEWS)[:TRAIN_BATCH]
    cases = {"variety, uint8": dict(variety=True, image_dtype="uint8"),
             "multi_resolution, float32": dict(multi_resolution=True)}
    batches = {}
    for name, kw in cases.items():
        loaders = {"native": DataLoader(ShapeNetDataset(imgs, pcl, train_models, [cat],
                                                        N_POINTS, **kw), TRAIN_BATCH),
                   "per_item": DataLoader(PerItem(imgs, pcl, train_models, [cat], N_POINTS,
                                                  **kw), TRAIN_BATCH)}
        ms, got = {"native": [], "per_item": []}, {}
        data_loader.batch_counts.update(native=0, declined=0)
        for label in ("native", "per_item", "per_item", "native", "native", "per_item"):
            t0 = time.perf_counter()
            got[label] = loaders[label]._make_batch(order)
            ms[label].append((time.perf_counter() - t0) * 1e3)
        if data_loader.batch_counts != {"native": 3, "declined": 3}:
            raise AssertionError(f"batch counts {data_loader.batch_counts}, not 3 and 3")
        if not same_batches(got["native"], got["per_item"]):
            raise AssertionError(f"native and per-item batches differ ({name})")
        batches[name] = {"ms": ms, "images_per_s": {
            k: TRAIN_BATCH * 1e3 / min(v) for k, v in ms.items()}, "byte_equal": True}
    paths = [loaders["native"].dataset._render_path(int(i)) for i in order]
    threads_ms = {}
    for n_threads in DATA_THREADS:
        threads_ms[str(n_threads)] = []
        for _ in range(DATA_REPS):
            t0 = time.perf_counter()
            native.load_images(paths, n_threads=n_threads, dtype=np.uint8)
            threads_ms[str(n_threads)].append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "data", "step": "batches", "batch": TRAIN_BATCH, "threads": native.N_THREADS,
          "cpu_count": os.cpu_count(), "cases": batches, "native_images_ms": threads_ms,
          "images": "137x137 RGB noise PNGs written by cv2 (compress worse than renders)"})

    # train_net fed from the tree: natively, then per item.
    gen = make_model(device, head_scale=1.0, n=N_POINTS)
    init_state = {k: v.clone() for k, v in gen.state_dict().items()}
    runs, launches = {}, {}
    for label in ("native", "per_item"):
        gen.load_state_dict(init_state)
        cfg = TrainConfig(batch_size=TRAIN_BATCH, num_points=N_POINTS, nepoch=1,
                          validate_epochs=(), train_save_freq=0, manual_seed=0,
                          dir_path=str(root / "out" / label), splits_path=f"{tree}/splits",
                          data_dir_imgs=imgs, data_dir_pcl=pcl)
        train_ds = val_ds = None  # train_net reads the tree itself
        if label == "per_item":
            train_ds = PerItem(imgs, pcl, train_models, [cat], N_POINTS, variety=True,
                               image_dtype="uint8")
            val_ds = PerItem(imgs, pcl, load_split(f"{tree}/splits", "val_models.json"),
                             [cat], N_POINTS, image_dtype="uint8")
        reset_counts()
        data_loader.batch_counts.update(native=0, declined=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_net(cat, cfg, train_ds, val_ds, model=gen, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = DATA_MODELS * NUM_VIEWS // TRAIN_BATCH
        launches[label] = launch_counts()
        want = {"chamfer_nn": 2 * steps, "emd_auction": 0, "emd_auction_stream": 0,
                "sinkhorn": 0}
        want[emd_kernel_name(N_POINTS)] = steps
        if launches[label] != want:
            raise AssertionError(f"train_net ({label}) launched {launches[label]}, not {want}")
        counts = dict(data_loader.batch_counts)
        want = {"native": steps, "declined": 0} if label == "native" else {
            "native": 0, "declined": steps}
        if counts != want:
            raise AssertionError(f"train_net ({label}) batches {counts}, not {want}")
        history = out["history"]
        if len(history) != 1 or not all(np.isfinite(history[0][k])
                                        for k in ("chamfer_loss", "emd_loss")):
            raise AssertionError(f"train_net ({label}) history is wrong: {history}")
        log = Path(out["ckpt_dir"], "logging.log").read_text()
        runs[label] = {"wall_s": wall, "batch_counts": counts, "launches": launches[label],
                       "step_ms": [float(v) * 1e3
                                   for v in re.findall(r"BatchTime = ([0-9.]+)", log)],
                       "data_wait_ms": [float(v) * 1e3
                                        for v in re.findall(r"DataTime = ([0-9.]+)", log)],
                       "history": history}
    emit({"phase": "data", "step": "train_net", "model": model_name(N_POINTS),
          "batch": TRAIN_BATCH, "steps": steps, "runs": runs,
          "in_memory_step_ms": in_memory_step_ms})
    del gen
    return {"prepare_data": prep_launches, "native": launches["native"],
            "per_item": launches["per_item"], "root": root, "tree": tree}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(label: str, spec: dict, world: int, work: Path, environ=None) -> list:
    """Run ``fenet_torch.tools.parallel_smoke`` in ``world`` rank processes
    (each with its spec under ``work``), all under RANK_TIMEOUT_S; their
    RESULT lines, by rank. Any rank's nonzero exit or timeout raises, with
    every rank's output."""
    import os

    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), **(environ or {})}
    procs = []
    for rank in range(world):
        path = work / f"{label}_rank{rank}.json"
        path.write_text(json.dumps({**spec, "rank": rank, "world": world, "port": port}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fenet_torch.tools.parallel_smoke", str(path)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    outputs, failed = [], False
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            out, _ = proc.communicate()
            failed = True
        outputs.append(out)
        failed |= proc.returncode != 0
    if failed:
        raise RuntimeError(f"parallel {label}: ranks exited "
                           f"{[p.returncode for p in procs]}:\n" + "\n".join(
                               f"--- rank {r}\n{o[-6000:]}" for r, o in enumerate(outputs)))
    return [json.loads(next(ln[7:] for ln in out.splitlines() if ln.startswith("RESULT ")))
            for out in outputs]


def rel_l2(got, ref) -> float:
    return float((got - ref).norm() / ref.norm())


def phase_parallel(device, data: dict) -> dict:
    """Training in two rank processes on the one card (gloo, each
    collective through host memory), against this process's
    one-process runs, and NCCL in a world of one; every rank launches K1
    and K3. The model and batch are phase train's: the unscaled seeded
    init, SyntheticShapeNet(variety=True)'s batch of TRAIN_BATCH.

    - dp=2, sync-BN: each rank one step on its 64 rows from the init,
      twice: left to its own auction (CD 1e-5, EMD 1e-2 against the
      one-process step at 128, as the card-vs-CPU check; the gradients'
      distance and how the two matchings differ reported) and replaying the
      one-process step's assignment (the same, and the gradients of fc3_1,
      fc1_1's first rows 1e-3 relative L2, two backbone convs 1e-2:
      PARALLEL_LIMITS; beside them the one-process step with its batch
      rows shuffled), the ranks' replicated gradients bit-identical;
      3 more steps: step ms, the all-reduce's ms, K1 2 and K3 1 a step.
      Then train_net for one epoch of 3 steps with validation, fed from
      phase data's tree, and a second run that resumes from its checkpoint
      (rank 0 loads, broadcasts) and runs epoch 2 with validation: every
      batch native on both ranks, the same history on both.
    - NCCL, world 1, joined through the environment: collectives on a CUDA
      tensor, then a one-step train_net.

    Deletes phase data's tree and its own directory after. Returns each
    path's launch counts, by path."""
    import shutil

    import numpy as np
    import torch

    from fenet_torch.data.loader import DataLoader
    from fenet_torch.data.shapenet import NUM_VIEWS
    from fenet_torch.data.synthetic import SyntheticShapeNet
    from fenet_torch.tools import parallel_smoke
    from fenet_torch.train.trainer import Trainer, reference_lr_schedule

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_parallel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    lr = reference_lr_schedule(5e-4, TRAIN_EPOCH)
    base = {"model": MODEL, "n_points": N_POINTS, "batch": TRAIN_BATCH, "seed": 0,
            "device": device.type, "work": str(work), "lr": lr, "grad_rows": GRAD_ROWS,
            "tree": str(data["tree"])}
    ds = SyntheticShapeNet(n_models=6, num_points=N_POINTS, variety=True, seed=0)
    batch = next(iter(DataLoader(ds, TRAIN_BATCH, shuffle=True, drop_last=True, seed=0)))
    images = batch["image"].astype(np.uint8)

    # The one-process step the ranks are held against, and its auction's
    # assignment (the kernel is deterministic: the same clouds give the same
    # matching again), which the ranks' second step replays.
    from fenet_torch.ops.emd import earth_mover_distance

    gen = parallel_smoke.init_model(base, device)
    trainer = Trainer(gen, parallel_smoke._config(base), device=device)
    seen = record_emd_inputs(trainer)
    stats = trainer.train_step(images, batch["points"], TRAIN_EPOCH, lr)
    cfg = trainer.config
    _, assignment = earth_mover_distance(*seen[0], cfg.emd_eps, cfg.emd_iters,
                                         cfg.emd_scale_phases, cfg.emd_early_exit,
                                         cfg.emd_scale_thresh)
    np.savez(work / "batch.npz", images=images, points=batch["points"],
             assignment=assignment.cpu().numpy())
    del trainer.emd, seen
    base["inputs"] = str(work / "batch.npz")
    ref_losses = {k: float(v) for k, v in stats.items()}
    params = dict(gen.named_parameters())
    ref_grads = {k: params[k].grad.cpu() for k in parallel_smoke.GRAD_KEYS}
    ref_grads["fc1_1.weight"] = ref_grads["fc1_1.weight"][:GRAD_ROWS]
    del params, trainer, gen, stats
    torch.cuda.empty_cache()
    # The float floor of those gradients: the same one-process step with its
    # batch rows shuffled (the same samples, summed in another order; a swap
    # of halves would only commute a tree's last sum), replaying the same
    # assignment.
    order = np.random.RandomState(0).permutation(TRAIN_BATCH)
    _, floor_grads, floor_trainer, _ = parallel_smoke._first_step(
        {**base, "dp": 1}, device, images[order], batch["points"][order],
        assignment[torch.as_tensor(order, device=assignment.device)])
    del floor_trainer
    torch.cuda.empty_cache()

    limits = PARALLEL_LIMITS
    per_step = {"chamfer_nn": 2, "emd_auction": 1, "emd_auction_stream": 0}
    paths = {}

    grad_checks = {"fc3_1_grad_rel_err": "fc3_1.weight",
                   "stage0_conv_grad_rel_err": "RepVGG.stage0.rbr_dense.conv.weight",
                   "edge0_conv_grad_rel_err": "edge0.0.weight",
                   "fc1_1_grad_rel_err": "fc1_1.weight"}

    def against_one(losses: dict, grads: dict) -> dict:
        rel = {"cd_rel_err": abs(losses["chamfer_loss"] - ref_losses["chamfer_loss"])
               / abs(ref_losses["chamfer_loss"]),
               "emd_rel_err": abs(losses["emd_loss"] - ref_losses["emd_loss"])
               / abs(ref_losses["emd_loss"])}
        rel.update({k: rel_l2(grads[name], ref_grads[name]) for k, name in grad_checks.items()})
        return rel

    floor = {k: rel_l2(floor_grads[name], ref_grads[name]) for k, name in grad_checks.items()}
    del floor_grads

    def check_step(label: str, results: list, dp: int) -> None:
        """Emit the ranks' steps against the one-process step, then raise on
        the first fault."""
        saved = [torch.load(work / f"step_dp{dp}_rank{r}.pt") for r in range(dp)]
        checks, faults = [], []
        for r, (res, grads) in enumerate(zip(results, saved)):
            rel = {"replayed": against_one(res["losses"], grads["replayed"]),
                   "free_auction": against_one(res["losses_free_auction"], grads["free"]),
                   "free_auction_matching": res["free_auction_matching"]}
            checks.append(rel)
            bad = {k: v for k, v in rel["replayed"].items() if not v <= limits[k]}
            bad.update({f"free_auction.{k}": rel["free_auction"][k]
                        for k in ("cd_rel_err", "emd_rel_err")
                        if not rel["free_auction"][k] <= limits[k]})
            if bad:
                faults.append(f"rank {r} against one process: {bad}")
            if res["launches_per_step"] != per_step:
                faults.append(f"rank {r} launched {res['launches_per_step']} a step, "
                              f"not {per_step}")
            paths[f"parallel_{label}_step_rank{r}"] = res["launches_per_step"]
        for kind in ("free", "replayed"):
            for name in grad_checks.values():
                if not torch.equal(saved[0][kind][name], saved[-1][kind][name]):
                    faults.append(f"the ranks' {name} gradients differ ({kind})")
        emit({"phase": "parallel", "run": f"{label} step", "backend": "gloo",
              "transport": results[0]["transport"], "model": model_name(N_POINTS),
              "global_batch": TRAIN_BATCH, "local_batch": results[0]["local_batch"],
              "vs_one_process": checks, "one_process_reordered": floor, "limits": limits,
              "one_process_losses": ref_losses,
              "per_rank": [{k: res[k] for k in ("losses", "step_ms", "all_reduce_ms",
                                                "launches_per_step")} for res in results],
              "gradient_bytes": results[0]["gradient_bytes"]})
        if faults:
            raise AssertionError(f"parallel {label}: " + "; ".join(faults))

    # Phase data's tree: its train and val splits both hold every sample; a
    # rank reads half of each at half the batch.
    steps = DATA_MODELS * NUM_VIEWS // TRAIN_BATCH
    val_batches = -(-DATA_MODELS * NUM_VIEWS // TRAIN_BATCH)
    want = {"chamfer_nn": 2 * (steps + val_batches), "emd_auction": steps + val_batches,
            "emd_auction_stream": 0}
    native = {"native": steps + val_batches, "declined": 0}

    # dp = 2 with sync-BN: the step, train_net with validation, and a run
    # that resumes from its checkpoint (rank 0 loads, broadcasts).
    results = spawn_ranks("dp2", {**base, "dp": 2, "cases": [
        ["step", {}],
        ["train_net", {"validate": [1, 2], "resume": True, "out": str(work / "dp_out")}]]},
        PARALLEL_RANKS, work)
    shutil.rmtree(data["root"])  # phase data's tree
    check_step("dp2", [res["step"] for res in results], 2)
    train_nets = [res["train_net"]["runs"] for res in results]
    for r, runs in enumerate(train_nets):
        for i, run in enumerate(runs):
            if run["launches"] != want:
                raise AssertionError(f"parallel dp2 train_net rank {r} run {i} launched "
                                     f"{run['launches']}, not {want}")
            if run["batch_counts"] != native:
                raise AssertionError(f"parallel dp2 train_net rank {r} run {i} batches "
                                     f"{run['batch_counts']}, not {native}")
            if run["data_parallel"] != 2:
                raise AssertionError(f"parallel dp2 train_net rank {r} run {i} sized the "
                                     f"mesh {run['data_parallel']}")
            paths[f"parallel_dp2_train_net_rank{r}" + (f"_run{i}" if i else "")] = \
                run["launches"]
    histories = [[run["history"] for run in runs] for runs in train_nets]
    if any(h != histories[0] for h in histories[1:]):
        raise AssertionError(f"parallel dp2 train_net: the ranks' histories differ: "
                             f"{histories}")
    if [[h["epoch"] for h in history] for history in histories[0]] != [[1], [2]]:
        raise AssertionError(f"parallel dp2 train_net ran the epochs {histories[0]}, not "
                             "[1] then, resumed, [2]")
    emit({"phase": "parallel", "run": "dp2 train_net (write, resume)", "backend": "gloo",
          "per_rank": train_nets})
    shutil.rmtree(work / "dp_out")

    # NCCL, a world of one, joined through fenet's environment variables.
    results = spawn_ranks("nccl", {**base, "cases": [["nccl", {"out": str(work / "nccl_out")}]]},
                          1, work, {"COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
                                    "FENET_NUM_PROCESSES": "1", "FENET_PROCESS_ID": "0"})
    res = results[0]["nccl"]
    want = {"chamfer_nn": 2 * res["train_net_steps"], "emd_auction": res["train_net_steps"],
            "emd_auction_stream": 0}
    if res["backend"] != "nccl" or res["launches"] != want:
        raise AssertionError(f"parallel nccl: {res}")
    paths["parallel_nccl_train_net"] = res["launches"]
    emit({"phase": "parallel", "run": "nccl world 1", **res})
    shutil.rmtree(work)
    emit({"phase": "parallel", "run": "summary", "wall_s": time.perf_counter() - t_phase,
          "rank_processes": PARALLEL_RANKS + 1})
    return paths


def phase_goldens(device) -> dict:
    """record_goldens through its entry point at full width: the eval init
    saved once as one .pth.tar, a synthetic tree of the 13 ALL_CATS (one
    model, 24 views each; GOLDENS_EMPTY's files removed, so its row is
    skipped), 1024 points, batch 64, strict ICP (the CLI's defaults). The
    counts set to 0 around it: K1 2 and K3 1 a batch. Samples/s of the
    whole CLI (its checkpoint loads included) and one category's batch
    split into generator, strict ICP, EMD and chamfer ms. Then that
    category through the same CLI on the CPU against the card's row: CD
    to GOLDENS_CD_REL, EMD to GOLDENS_EMD_REL. Returns the tree's paths for
    phase viz and the launches."""
    import shutil

    import numpy as np
    import torch

    from fenet_torch.cli import record_goldens
    from fenet_torch.cli.eval_shapenet import ALL_CATS
    from fenet_torch.data.loader import DataLoader
    from fenet_torch.data.shapenet import ShapeNetDataset, load_split
    from fenet_torch.data.synthetic import write_synthetic_shapenet
    from fenet_torch.geometry.icp import align_pred_to_gt
    from fenet_torch.ops import chamfer, emd

    root = ROOT / "build" / "chip_smoke_goldens"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_synthetic_shapenet(str(root), cats=ALL_CATS, models_per_cat=1, num_points=N_POINTS)
    for sub in ("ShapeNetRendering", "ShapeNet_pointclouds"):
        shutil.rmtree(root / sub / GOLDENS_EMPTY)
    tree_s = time.perf_counter() - t0
    gen = make_model(device, n=N_POINTS)
    ckpt = root / "model_best.pth.tar"
    torch.save({"state_dict": gen.state_dict()}, ckpt)
    tree = ["--num_points", str(N_POINTS), "--backbone", MODEL["backbone"],
            "--fine_width", str(MODEL["fine_width"]), "--mid_width", str(MODEL["mid_width"]),
            "--splits_path", str(root / "splits"),
            "--data_dir_imgs", str(root / "ShapeNetRendering"),
            "--data_dir_pcl", str(root / "ShapeNet_pointclouds"), "--torch_model", str(ckpt)]
    reset_counts()
    t0 = time.perf_counter()
    table = record_goldens.main(tree + ["--device", str(device), "--batchSize", str(BATCH),
                                        "--out", str(root / "goldens_card.json")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    recorded = [c for c in ALL_CATS if c != GOLDENS_EMPTY]
    batches = len(recorded) * -(-24 // BATCH)
    want = {"chamfer_nn": 2 * batches, "emd_auction": batches, "emd_auction_stream": 0,
            "sinkhorn": 0}
    if launches != want:
        raise AssertionError(f"record_goldens launched {launches}, not {want}")
    rows = table["categories"]
    if table["skipped"] != [GOLDENS_EMPTY] or not all(
            rows[c]["samples"] == 24 and np.isfinite(rows[c]["cd"]) and np.isfinite(rows[c]["emd"])
            for c in recorded):
        raise AssertionError(f"record_goldens table is wrong: {table}")

    # One category's batch, timed stage by stage in the CLI's strict mode.
    cat = recorded[0]
    ds = ShapeNetDataset(str(root / "ShapeNetRendering"), str(root / "ShapeNet_pointclouds"),
                         load_split(str(root / "splits"), "val_models.json"), [cat], N_POINTS,
                         check_exists=True, image_dtype="uint8")
    batch = next(iter(DataLoader(ds, BATCH, prefetch=0)))
    images = torch.as_tensor(batch["image"]).to(device)
    points = torch.as_tensor(batch["points"]).to(device)
    phases = {}
    timed = functools.partial(timed_ms, phases)
    with torch.inference_mode():
        pred = timed("generator_ms", lambda: gen(images)[2])
        aligned = timed("icp_ms", lambda: align_pred_to_gt(
            pred, points, max_iterations=1024, rel_tolerance=0.0, stall_patience=0))
        timed("emd_ms", lambda: emd.earth_mover_distance(aligned, points))
        timed("chamfer_ms", lambda: chamfer.chamfer_distance(aligned, points))

    # Where a card-vs-CPU gap comes from: the generator on the same images,
    # and strict ICP on the same (the card's) predictions.
    host_gen = copy.deepcopy(gen).cpu()
    with torch.inference_mode():
        host_pred = host_gen(images.cpu())[2]
        host_aligned = align_pred_to_gt(pred.cpu(), points.cpu(), max_iterations=1024,
                                        rel_tolerance=0.0, stall_patience=0)
    del host_gen
    stages = {"generator_rel_err": rel_err(pred.cpu(), host_pred),
              "icp_same_input_max_abs_err": float((aligned.cpu() - host_aligned).abs().max())}
    t0 = time.perf_counter()
    host = record_goldens.main(tree + ["--device", "cpu", "--cats", cat,
                                       "--out", str(root / "goldens_cpu.json")])
    cpu_s = time.perf_counter() - t0
    checks = {"cd_rel_err": abs(rows[cat]["cd"] - host["categories"][cat]["cd"])
              / host["categories"][cat]["cd"],
              "emd_rel_err": abs(rows[cat]["emd"] - host["categories"][cat]["emd"])
              / host["categories"][cat]["emd"]}
    limits = {"cd_rel_err": GOLDENS_CD_REL, "emd_rel_err": GOLDENS_EMD_REL}
    samples = sum(rows[c]["samples"] for c in recorded)
    emit({"phase": "goldens", "model": model_name(N_POINTS), "cats": len(ALL_CATS),
          "recorded": len(recorded), "skipped": table["skipped"], "batch": BATCH,
          "batches": batches, "samples": samples, "wall_s": wall,
          "samples_per_s": samples / wall, "tree_s": tree_s, "launches": launches,
          "settings": table["settings"], "mean_cd": table["mean_cd"],
          "mean_emd": table["mean_emd"], "strict_batch_phase_ms": {"samples": len(pred), **phases},
          "icp_share": phases["icp_ms"] / sum(phases.values()),
          "card_vs_cpu": {"category": cat, "samples": host["categories"][cat]["samples"],
                          "card": rows[cat], "cpu": host["categories"][cat], "cpu_s": cpu_s,
                          **checks, "stages_on_identical_inputs": stages},
          "limits": limits})
    for key, limit in limits.items():
        if not checks[key] <= limit:
            raise AssertionError(f"record_goldens card vs CPU {key} = {checks[key]} > {limit}")
    return {"root": root, "ckpt": ckpt, "cats": recorded, "dataset": ds, "launches": launches}


def phase_analysis(device, pred, gt) -> dict:
    """fscore on the eval phase's aligned clouds against the CPU (K1 2 a
    call, the counts set to 0 around it); the dense auction above the
    kernels' 8192 points (earth_mover_distance at DENSE_SHAPE, eval
    settings, dyadic clouds) against the CPU, bit for bit: its calls counted
    apart, no kernel launch, its time and peak memory; profiling.trace over one eval
    step, with the CUDA kernel events of the trace it writes. Returns each
    path's launches."""
    import shutil

    import numpy as np
    import torch

    from fenet_torch.eval.runner import make_eval_step
    from fenet_torch.losses.fscore import fscore
    from fenet_torch.ops import emd
    from fenet_torch.utils import profiling

    out = {}
    scores = {}
    n = pred.shape[1]
    for threshold in FSCORE_THRESHOLDS:
        reset_counts()
        card = [float(v) for v in fscore(pred, gt, threshold)]
        out["fscore"] = launch_counts()
        host = [float(v) for v in fscore(pred.cpu(), gt.cpu(), threshold)]
        gap = max(abs(a - b) for a, b in zip(card, host))
        scores[str(threshold)] = {"card": card, "cpu": host, "max_abs_err": gap}
        # A nearest distance on the threshold may round to the other side:
        # one point of N an element moves a mean fraction by 1/N.
        if out["fscore"]["chamfer_nn"] != 2 or not gap <= 1.0 / n:
            raise AssertionError(f"fscore at {threshold}: {scores}, {out['fscore']}")
    emit({"phase": "analysis", "step": "fscore", "B": pred.shape[0], "N": n, "scores": scores,
          "limit": 1.0 / n, "launches": out["fscore"]})

    b, n = DENSE_SHAPE
    rng = np.random.RandomState(11)
    x1, x2 = (clouds("dyadic", rng, device, (b, n, 3)) for _ in range(2))
    calls = emd.earth_mover_distance_ref.calls
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    d_card, a_card = emd.earth_mover_distance(x1, x2)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    out["dense_auction"] = assert_no_launches("dense auction")
    t0 = time.perf_counter()
    d_host, a_host = emd.earth_mover_distance(x1.cpu(), x2.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    m_card, m_host = float(d_card.sqrt().mean()), float(d_host.sqrt().mean())
    dense = {"B": b, "N": n, "eps": 0.005, "iters": 50,
             "calls": emd.earth_mover_distance_ref.calls - calls, "card_ms": card_ms,
             "cpu_ms": cpu_ms, "peak_bytes_above_inputs": peak,
             "emd_metric_rel_err": abs(m_card - m_host) / m_host, "limit": 1e-2,
             "assignment_equal_share": float((a_card.cpu() == a_host).float().mean()),
             "bit_exact": bool(torch.equal(d_card.cpu(), d_host)
                               and torch.equal(a_card.cpu(), a_host))}
    emit({"phase": "analysis", "step": "dense_auction", **dense, "launches": out["dense_auction"]})
    # Dyadic clouds make every value exact on both devices, so the two runs
    # must agree bit for bit.
    if dense["calls"] != 2 or not dense["bit_exact"] or not dense["emd_metric_rel_err"] <= 1e-2:
        raise AssertionError(f"the dense auction: {dense}")

    out["sinkhorn_large"] = sinkhorn_large(device)
    out["goldens_ref"] = goldens_ref(device)

    gen = make_model(device, n=N_POINTS)
    step = make_eval_step(gen, device=device)
    images = torch.zeros((gt.shape[0], 128, 128, 3), dtype=torch.uint8, device=device)
    step(images, gt)  # warm-up
    log_dir = ROOT / "build" / "chip_smoke_trace"
    shutil.rmtree(log_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with profiling.trace(str(log_dir)):
        step(images, gt)
        torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t0) * 1e3
    files = sorted(log_dir.iterdir())
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    emit({"phase": "analysis", "step": "trace",
          "path": f"eval step (batch {gt.shape[0]}, N={gt.shape[1]})",
          "files": [f.name for f in files], "bytes": files[0].stat().st_size,
          "events": len(events), "cuda_kernel_events": kernels, "traced_ms": traced_ms,
          "synced_seconds": profiling.synced_seconds(step, images, gt, iters=2)})
    if len(files) != 1 or not kernels:
        raise AssertionError(f"profiling.trace wrote {files}, {kernels} kernel events")
    shutil.rmtree(log_dir)
    return out


def sinkhorn_large(device) -> dict:
    """The Sinkhorn loss above the kernel's MAX_N, where the op runs its
    plain version on the card, as fenet runs its XLA loop: the potentials
    at SINKHORN_LARGE against the plain version on the CPU (rtol 1e-4, atol
    1e-5), the kernel wrapper still raising there, and one
    Trainer(emd_impl="sinkhorn") step at full width, batch B (finite
    losses, K1 2). No K6/K7 launch in either; returns their launches."""
    import numpy as np
    import torch

    from fenet_torch.models.generator import Generator, init_random_
    from fenet_torch.ops import sinkhorn
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer

    b, n, iters = SINKHORN_LARGE
    rng = np.random.RandomState(13)
    x, y = (torch.tensor(rng.rand(b, n, 3).astype(np.float32)) for _ in range(2))
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f, g = sinkhorn.sinkhorn_potentials(x.to(device), y.to(device), 1e-4, iters)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    f_p, g_p = sinkhorn._potentials_plain(x, y, 1e-4, iters, 0.25)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    gap = max(float(((got.cpu() - ref).abs() - 1e-4 * ref.abs()).max())
              for got, ref in ((f, f_p), (g, g_p)))
    try:
        sinkhorn.potentials_kernel(x.to(device), y.to(device), 1e-4, iters, 0.25)
        raised = False
    except ValueError:
        raised = True
    potentials = {"B": b, "N": n, "iters": iters, "card_ms": card_ms, "cpu_ms": cpu_ms,
                  "max_abs_err": max(float((f.cpu() - f_p).abs().max()),
                                     float((g.cpu() - g_p).abs().max())),
                  "max_err_over_rtol": gap, "atol": 1e-5, "kernel_raises": raised,
                  "max_memory_allocated_bytes": peak, "launches": launch_counts()}
    emit({"phase": "analysis", "step": "sinkhorn_potentials_large", **potentials})
    if not gap <= 1e-5 or not raised:
        raise AssertionError(f"the Sinkhorn potentials above {sinkhorn.MAX_N} points: "
                             f"{potentials}")

    gen = Generator(num_points=n, **MODEL)
    init_random_(gen, torch.Generator().manual_seed(0))
    trainer = Trainer(gen, TrainConfig(batch_size=b, num_points=n, emd_impl="sinkhorn", **MODEL),
                      device=device)
    images = (rng.rand(b, 128, 128, 3) * 255).astype(np.float32)
    points = (rng.rand(b, n, 3) * 0.9).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = {k: float(v) for k, v in trainer.train_step(images, points, TRAIN_EPOCH,
                                                         5e-4).items()}
    step_ms = (time.perf_counter() - t0) * 1e3
    launches, plan = launch_counts(), plan_launches()
    emit({"phase": "analysis", "step": "sinkhorn_train_step_large", "model": model_name(n),
          "batch": b, "losses": losses, "step_ms": step_ms,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "plan_launches": plan})
    want = {"chamfer_nn": 2, "emd_auction": 0, "emd_auction_stream": 0, "sinkhorn": 0}
    want_plan = {"sinkhorn_plan": 1, "sinkhorn_plan_columns": 0}
    if (launches != want or plan != want_plan
            or not all(np.isfinite(v) for v in losses.values())):
        raise AssertionError(f"the Sinkhorn train step at {n} points: {losses}, launched "
                             f"{launches} and the plan {plan}, not {want}, {want_plan}")
    return launches


def goldens_ref(device) -> dict:
    """K1 and K3 on the reference's four golden pairs of clouds at
    tests/test_reference_parity.py's bounds: CD to rtol 1e-5 with the 64
    index heads equal, the F-score to 2.5/4096, the eval-settings EMD within
    15% of the optimal matching, and the auction at 3000 iterations in [opt
    - 1e-4, 1.005·opt] with 99% of the columns matched. Returns the
    launches (K1 4, K3 2)."""
    import numpy as np
    import torch

    from fenet_torch.losses.fscore import fscore
    from fenet_torch.ops.chamfer import chamfer_distance
    from fenet_torch.ops.emd import earth_mover_distance

    data = np.load(GOLDENS_REF)
    rng = np.random.RandomState(int(data["seed"]))
    a, b = (torch.tensor(rng.rand(4, 1024, 3).astype(np.float32), device=device)
            for _ in range(2))
    reset_counts()
    d1, d2, i1, i2 = chamfer_distance(a, b)
    fs = [float(v) for v in fscore(a, b)]
    at_eval = earth_mover_distance(a, b, 0.005, 50)[0].sqrt().mean(1).double().cpu().numpy()
    dist, ass = earth_mover_distance(a, b, 0.005, 3000)
    converged = dist.sqrt().mean(1).double().cpu().numpy()
    launches = launch_counts()
    opt = data["emd_optimal_sqrt_mean"]
    cd = (d1.mean(1) + d2.mean(1)).cpu().numpy()
    matched = [len(torch.unique(ass[k])) for k in range(ass.shape[0])]
    rec = {"cd_rel_err": max(float(np.abs(got / data[key] - 1).max()) for got, key in (
               (cd, "cd_per_sample"), (d1.mean(1).cpu().numpy(), "dist1_mean"),
               (d2.mean(1).cpu().numpy(), "dist2_mean"))),
           "heads_equal": bool(np.array_equal(i1[:, :64].cpu().numpy(), data["idx1_head"])
                               and np.array_equal(i2[:, :64].cpu().numpy(), data["idx2_head"])),
           "fscore_abs_err": float(np.abs(np.asarray(fs) - [
               data["fscore"], data["precision_1"], data["precision_2"]]).max()),
           "emd_eval_rel_to_opt": (at_eval / opt - 1).tolist(),
           "emd_converged_rel_to_opt": (converged / opt - 1).tolist(),
           "columns_matched": matched, "launches": launches}
    emit({"phase": "analysis", "step": "goldens_ref", **rec})
    ok = (rec["cd_rel_err"] <= 1e-5 and rec["heads_equal"]
          and rec["fscore_abs_err"] <= 2.5 / 4096
          and (np.abs(at_eval - opt) <= 0.15 * opt).all()
          and (converged >= opt - 1e-4).all() and (converged <= 1.005 * opt).all()
          and min(matched) >= int(0.99 * 1024)
          and launches == {"chamfer_nn": 4, "emd_auction": 2, "emd_auction_stream": 0,
                           "sinkhorn": 0})
    if not ok:
        raise AssertionError(f"the reference's goldens on the card: {rec}")
    return launches


def phase_viz(device, goldens: dict) -> dict:
    """The pictures at full width on phase goldens' tree and checkpoint
    (deleted after): cli/render plain and --deploy, cli/render_pix3d on a
    synthetic Pix3D tree (its skip rule on a second run) and cli/heatmap
    without and with --layer, each with the counts set to 0 around it (no
    kernel lies on these paths). matplotlib is looked up first: without it
    the two render CLIs are not run, their clouds' forwards are, and the
    line says so. Then Grad-CAM on the card against the CPU on one image
    (GRADCAM_ATOL), and SimpleGenerator's forward card against CPU (1e-4 of
    max|ref|)."""
    import importlib.util
    import shutil

    import numpy as np
    import torch

    from fenet_torch.cli import heatmap, render, render_pix3d
    from fenet_torch.cli.eval_pix3d import PIX3D_TO_SHAPENET
    from fenet_torch.data.loader import DataLoader
    from fenet_torch.data.synthetic import write_synthetic_pix3d
    from fenet_torch.models.convert import load_reference_checkpoint
    from fenet_torch.models.generator import SimpleGenerator, init_random_
    from fenet_torch.viz.gradcam import grad_cam

    root = goldens["root"]
    for cat in goldens["cats"]:
        path = root / "out" / cat / "checkpoints" / "model_best.pth.tar"
        path.parent.mkdir(parents=True)
        path.symlink_to(goldens["ckpt"])
    arch = ["--num_points", str(N_POINTS), "--backbone", MODEL["backbone"],
            "--fine_width", str(MODEL["fine_width"]), "--mid_width", str(MODEL["mid_width"]),
            "--model", str(root / "out" / "%s" / "checkpoints"), "--device", str(device)]
    shapenet = ["--category", goldens["cats"][0], "--splits_path", str(root / "splits"),
                "--data_dir_imgs", str(root / "ShapeNetRendering"),
                "--data_dir_pcl", str(root / "ShapeNet_pointclouds"), "--n_samples", "2"]
    write_synthetic_pix3d(str(root / "pix3d"), cats=tuple(PIX3D_TO_SHAPENET), samples_per_cat=3,
                          num_points=N_POINTS)
    matplotlib = importlib.util.find_spec("matplotlib") is not None
    runs, launches = {}, {}

    def run(name, fn, outdir):
        reset_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        runs[name] = {"seconds": time.perf_counter() - t0,
                      "files": sorted(str(p.relative_to(outdir)) for p in outdir.rglob("*.png"))
                      if outdir.exists() else [], "result": result}
        launches[name] = assert_no_launches(name)

    for layer in ([], ["--layer", "stage3"]):
        run("heatmap" + "".join(layer[1:]), lambda: heatmap.main(
            arch + shapenet + layer + ["--out_dir", str(root / "heatmaps")]), root / "heatmaps")
    if matplotlib:
        for deploy in ([], ["--deploy"]):
            out = root / "renders" / ("deploy" if deploy else "plain")
            run("render" + "".join(deploy), lambda: render.main(
                arch + shapenet + deploy + ["--out_dir", str(out)]), out)
        pix3d = arch + ["--data_dir", str(root / "pix3d"), "--n_samples", "2",
                        "--out_dir", str(root / "pix3d_renders")]
        run("render_pix3d", lambda: render_pix3d.main(pix3d), root / "pix3d_renders")
        (root / "pix3d_renders" / "chair" / "0001_pr.png").unlink()
        run("render_pix3d_again", lambda: render_pix3d.main(pix3d), root / "pix3d_renders")
        want = {"heatmap": 2, "heatmapstage3": 4, "render": 2, "render--deploy": 2,
                "render_pix3d": 12, "render_pix3d_again": 18}
        if runs["render_pix3d_again"]["result"] != {"sofa": 1, "table": 1, "chair": 2}:
            raise AssertionError(f"render_pix3d's skip rule: {runs['render_pix3d_again']}")
    else:
        # The render CLIs' clouds without their pictures: the checkpoint's
        # generator on the category's first two samples.
        gen = load_reference_checkpoint(make_model(device, n=N_POINTS), str(goldens["ckpt"]))
        first = next(iter(DataLoader(goldens["dataset"], 2, prefetch=0)))

        def forwards():
            with torch.inference_mode():
                return [list(c.shape) for c in gen(torch.as_tensor(first["image"]).to(device))]

        run("render_forwards", forwards, root / "none")
        del gen
        want = {"heatmap": 2, "heatmapstage3": 4, "render_forwards": 0}
    for name, count in want.items():
        if len(runs[name]["files"]) != count:
            raise AssertionError(f"{name} wrote {runs[name]['files']}, not {count} files")
    for name in runs:
        runs[name]["files"] = len(runs[name]["files"])

    gen = make_model(device, n=N_POINTS)
    image = np.random.RandomState(12).randint(0, 256, (1, 128, 128, 3)).astype(np.float32)
    reset_counts()
    t0 = time.perf_counter()
    cam = grad_cam(gen, image)
    torch.cuda.synchronize()
    cam_ms = (time.perf_counter() - t0) * 1e3
    launches["grad_cam"] = assert_no_launches("grad_cam")
    host_gen = copy.deepcopy(gen).cpu()
    cams = {"final": (cam, grad_cam(host_gen, image)),
            "stage3": (grad_cam(gen, image, layer="stage3"),
                       grad_cam(host_gen, image, layer="stage3"))}
    cam_err = {k: float(np.abs(a - b).max()) for k, (a, b) in cams.items()}
    del gen, host_gen

    with torch.device(device):
        simple = SimpleGenerator(num_points=N_POINTS, backbone=MODEL["backbone"])
    simple = init_random_(simple, torch.Generator(device=device).manual_seed(3)).eval()
    images = torch.tensor(np.random.RandomState(13).randint(0, 256, (4, 128, 128, 3)),
                          dtype=torch.uint8, device=device)
    with torch.inference_mode():
        got = simple(images)
        ref = copy.deepcopy(simple).cpu()(images.cpu())
    simple_err = rel_err(got.cpu(), ref)
    checks = {"grad_cam_max_abs_err": max(cam_err.values()), "simple_generator_rel_err": simple_err}
    limits = {"grad_cam_max_abs_err": GRADCAM_ATOL, "simple_generator_rel_err": 1e-4}
    emit({"phase": "viz", "model": model_name(N_POINTS),
          "render": "matplotlib installed" if matplotlib else "matplotlib not installed",
          "runs": runs, "launches": launches, "grad_cam_ms": cam_ms,
          "grad_cam_card_vs_cpu": cam_err, "simple_generator": {
              "out": list(got.shape), "abs_max": float(got.abs().max())},
          "checks": checks, "limits": limits})
    for key, limit in limits.items():
        if not checks[key] <= limit:
            raise AssertionError(f"viz card vs CPU {key} = {checks[key]} > {limit}")
    shutil.rmtree(root)
    return {name: counts for name, counts in launches.items()}


def rss_of_load(path: str) -> dict:
    """Load ``path`` with ``load_checkpoint`` in a fresh CPU process: its
    resident set (``VmRSS``) after the imports and the most of it that a
    thread sampling every RSS_SAMPLE_S saw during the load, the load's
    seconds, and the bytes of the state_dict it returned. (The card
    machine's ``/proc/self/status`` has no ``VmHWM``, and ``ru_maxrss``
    carries the parent's peak across the exec.)"""
    code = (
        "import json, sys, threading, time\n"
        "import torch\n"
        "from fenet_torch.train.checkpoint import load_checkpoint\n"
        "def rss():\n"
        "    with open('/proc/self/status') as f:\n"
        "        line = next(ln for ln in f if ln.startswith('VmRSS:'))\n"
        "    return int(line.split()[1]) * 1024\n"
        "base = peak = rss()\n"
        "done = threading.Event()\n"
        "def sample():\n"
        "    global peak\n"
        "    while not done.is_set():\n"
        "        peak = max(peak, rss())\n"
        f"        time.sleep({RSS_SAMPLE_S})\n"
        "sampler = threading.Thread(target=sample)\n"
        "sampler.start()\n"
        "t0 = time.perf_counter()\n"
        "blob = load_checkpoint(sys.argv[1])\n"
        "seconds = time.perf_counter() - t0\n"
        "done.set()\n"
        "sampler.join()\n"
        "peak = max(peak, rss())\n"
        "nbytes = sum(v.numel() * v.element_size() for v in blob['state_dict'].values())\n"
        "print(json.dumps({'baseline_rss_bytes': base, 'load_s': seconds,\n"
        "                  'peak_rss_bytes': peak, 'state_dict_bytes': nbytes}))\n")
    out = subprocess.run([sys.executable, "-c", code, path], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT),
                                                      "CUDA_VISIBLE_DEVICES": ""})
    if out.returncode != 0:
        raise RuntimeError(f"loading {path} in a child failed:\n{out.stderr}")
    info = json.loads(out.stdout.strip().splitlines()[-1])
    info["peak_over_baseline_bytes"] = info["peak_rss_bytes"] - info["baseline_rss_bytes"]
    return info


def tree_bytes(path: Path) -> int:
    """The bytes of a file, or of every file under a directory."""
    if path.is_file():
        return path.stat().st_size
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def same_tree(a: Path, b: Path, skip=()) -> bool:
    """Whether two directories hold the same files with the same bytes
    (names in ``skip`` aside)."""
    import filecmp

    names = sorted(str(f.relative_to(a)) for f in a.rglob("*") if f.is_file())
    if names != sorted(str(f.relative_to(b)) for f in b.rglob("*") if f.is_file()):
        return False
    return all(n in skip or filecmp.cmp(a / n, b / n, shallow=False) for n in names)


def fixture_check() -> dict:
    """fenet's committed orbax fixture (tests/fixtures/fenet_orbax, written
    by fenet: OCDBT, zstd) read by the port on this host, every leaf held
    bit for bit against the seeded arrays of tests/make_orbax_fixture.py
    (numpy alone)."""
    import importlib.util

    import torch

    from fenet_torch.native import zstd
    from fenet_torch.train import orbax

    spec = importlib.util.spec_from_file_location(
        "make_orbax_fixture", ROOT / "tests" / "make_orbax_fixture.py")
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for key in tree:
                yield from leaves(tree[key], path + (key,))
        else:
            yield path, tree

    t0 = time.perf_counter()
    got = orbax.load(str(fixture.CHECKPOINT))
    load_s = time.perf_counter() - t0
    pairs = list(zip(leaves(got), leaves(fixture.seeded_tree())))
    for (path, a), (want_path, b) in pairs:
        a = a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) else a
        if path != want_path or a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"the orbax fixture's {path} differs from its seeded array")
    if len(pairs) != len(list(leaves(fixture.seeded_tree()))):
        raise AssertionError("the orbax fixture holds another tree than its seeded one")
    return {"leaves": len(pairs), "bit_equal": True, "load_s": load_s,
            "bytes": tree_bytes(fixture.CHECKPOINT), "libzstd": zstd.SONAME}


def compress_orbax(path: Path, level: int = 1) -> dict:
    """Rewrite every chunk of the port's (uncompressed) orbax directory as
    one zstd frame at ``level`` (libzstd's ZSTD_compress; fenet's level is
    1) and name the compressor in its .zarray, as fenet's arrays are."""
    from fenet_torch.native import zstd

    t0 = time.perf_counter()
    raw = packed = 0
    for zarray in sorted(path.glob("*/.zarray")):
        meta = json.loads(zarray.read_text())
        for chunk in zarray.parent.iterdir():
            if chunk.name != ".zarray":
                data = chunk.read_bytes()
                frame = zstd.compress(data, level)
                chunk.write_bytes(frame)
                raw, packed = raw + len(data), packed + len(frame)
        zarray.write_text(json.dumps({**meta, "compressor": {"id": "zstd", "level": level}}))
    return {"level": level, "chunk_bytes": raw, "compressed_bytes": packed,
            "ratio": packed / raw, "compress_s": time.perf_counter() - t0}


def phase_checkpoint(device) -> dict:
    """fenet's flax and orbax containers at full width (N_POINTS). First
    fenet's committed orbax fixture read on this host, bit for bit.
    train_net for 2 epochs of one step at batch TRAIN_BATCH in ckpt_format
    "orbax", validating at epoch 2; its final state saved again through the
    three containers (the orbax arrays must equal train_net's own
    directory's), each timed, and loaded back (timed here and, for the peak
    resident set, in a CPU process of its own): weights, BN statistics,
    both Adam moments and the step bit for bit. A third epoch resumed from
    each container's model_best: the first resumed step's CD and EMD
    identical. eval_shapenet on a tree holding only model_best.orbax, only
    model_best.ckpt or only model_best.pth.tar: identical metrics.
    export_deploy --format flax from the .ckpt and from the .orbax and
    --format torch, in float32 and bf16, then predict from each: the deploy
    files from the .orbax equal those from the .ckpt, and every cloud the
    torch files'. Last, the .orbax's chunks compressed with zstd at fenet's
    level 1 and loaded, timed, bit for bit. Returns each run's launch
    counts."""
    import dataclasses
    import filecmp
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fenet_torch.cli import eval_shapenet, export_deploy, predict
    from fenet_torch.data.synthetic import SyntheticShapeNet, write_synthetic_shapenet
    from fenet_torch.train import flax_msgpack, orbax
    from fenet_torch.train.checkpoint import SUFFIXES, load_checkpoint, save_checkpoint
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.driver import train_net
    from fenet_torch.utils.ply import load_pointcloud

    n, cat = N_POINTS, "02828884"
    arch = ["--num_points", str(n), "--backbone", MODEL["backbone"],
            "--fine_width", str(MODEL["fine_width"]), "--mid_width", str(MODEL["mid_width"])]
    train_ds = SyntheticShapeNet(n_models=-(-TRAIN_BATCH // 24), num_points=n, variety=True,
                                 seed=0)
    val_ds = SyntheticShapeNet(n_models=1, num_points=n, seed=1)
    steps_per_epoch = len(train_ds) // TRAIN_BATCH
    per_step = {"chamfer_nn": 2, "emd_auction": 1, "emd_auction_stream": 0, "sinkhorn": 0}
    formats = ("orbax", "flax", "torch")

    def expect(label, steps):
        launches = launch_counts()
        want = {k: v * steps for k, v in per_step.items()}
        if launches != want:
            raise AssertionError(f"checkpoint ({label}) launched {launches}, not {want}")
        return launches

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    counts, info = {}, {"model": model_name(n), "batch": TRAIN_BATCH,
                        "fenet_orbax_fixture": fixture_check()}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        gen = make_model(device, head_scale=1.0, n=n)
        cfg = TrainConfig(batch_size=TRAIN_BATCH, num_points=n, nepoch=2, validate_epochs=(2,),
                          train_save_freq=0, dir_path=str(tmp / "run"), manual_seed=0,
                          ckpt_format="orbax")
        reset_counts()
        out = train_net(cat, cfg, train_ds, val_ds, model=gen, device=device)
        torch.cuda.synchronize()
        counts["orbax_train_net"] = expect("train_net", 2 * steps_per_epoch
                                           + -(-len(val_ds) // TRAIN_BATCH))
        run_dir = Path(out["ckpt_dir"])
        written = run_dir / f"{cat}_checkpoint_2.orbax"
        best = run_dir / "model_best.orbax"
        if (not same_tree(best, written)
                or json.loads((run_dir / "model_best.orbax.json").read_text())["epoch"] != 2
                or list(run_dir.glob("*.pth.tar")) or list(run_dir.glob("*.ckpt"))):
            raise AssertionError(f"train_net wrote {sorted(p.name for p in run_dir.iterdir())}")
        shutil.rmtree(best)  # the disk holds three 2 GB checkpoints at most

        # The same state through the three containers, each timed; each
        # becomes its tree's model_best.
        state_dict, optimizer = out["trainer"].full_state()
        del out
        meta = json.loads((run_dir / f"{cat}_checkpoint_2.orbax.json").read_text())
        state = {"state_dict": state_dict, "optimizer": optimizer, **meta}
        paths, container = {}, {}
        for fmt in formats:
            ckpt_dir = tmp / fmt / cat / "checkpoints"
            t0 = time.perf_counter()
            path = Path(save_checkpoint(state, False, cat, str(ckpt_dir), 2, fmt=fmt))
            save_s = time.perf_counter() - t0
            size = tree_bytes(path)
            container[fmt] = {"bytes": size, "files": sum(1 for f in path.rglob("*")
                                                           if f.is_file()) if path.is_dir() else 1,
                              "save_s": save_s, "save_gb_per_s": size / save_s / 1e9}
            if fmt == "orbax":
                if not same_tree(path, written, skip=(orbax.CHECKPOINT_METADATA,)):
                    raise AssertionError("the orbax save of train_net's final state differs "
                                         "from train_net's own checkpoint")
                shutil.rmtree(tmp / "run")
            paths[fmt] = ckpt_dir / f"model_best{SUFFIXES[fmt]}"
            path.rename(paths[fmt])
            if fmt != "torch":
                Path(str(path) + ".json").rename(str(paths[fmt]) + ".json")
        del state, state_dict, optimizer
        blobs = {}
        for fmt in formats:
            t0 = time.perf_counter()
            blobs[fmt] = load_checkpoint(str(paths[fmt]))
            load_s = time.perf_counter() - t0
            container[fmt].update(load_s=load_s,
                                  load_gb_per_s=container[fmt]["bytes"] / load_s / 1e9,
                                  child_load=rss_of_load(str(paths[fmt])))
        # The containers' own readers alone (files opened and mapped, no
        # page of an array touched): what the container adds to a load.
        for fmt, read in (("orbax", orbax.load), ("flax", flax_msgpack.load)):
            t0 = time.perf_counter()
            read(str(paths[fmt]))
            container[fmt]["reader_only_s"] = time.perf_counter() - t0
        a = blobs["torch"]
        extra = {k for k in a["state_dict"] if k.endswith("num_batches_tracked")}
        for fmt in ("flax", "orbax"):
            b = blobs[fmt]
            if set(a["state_dict"]) - set(b["state_dict"]) != extra:
                raise AssertionError(f"the {fmt} container holds other tensors than the "
                                     ".pth.tar")
            for key, value in b["state_dict"].items():
                if not torch.equal(value, a["state_dict"][key]):
                    raise AssertionError(f"{key} differs between {fmt} and the .pth.tar")
            if a["optimizer"]["state"].keys() != b["optimizer"]["state"].keys():
                raise AssertionError(f"{fmt} holds Adam state for other parameters")
            for i, entry in a["optimizer"]["state"].items():
                for key in ("step", "exp_avg", "exp_avg_sq"):
                    got = b["optimizer"]["state"][i][key]
                    if not (got.dtype == entry[key].dtype and torch.equal(got, entry[key])):
                        raise AssertionError(f"Adam's {key} of parameter {i} differs in {fmt}")
            scalars = {k: v for k, v in a.items() if k not in ("state_dict", "optimizer")}
            if json.dumps(scalars) != json.dumps({k: b[k] for k in scalars}):
                raise AssertionError(f"the scalars differ: {scalars} vs {fmt}'s")
        tensors = len(blobs["orbax"]["state_dict"]) + 3 * len(blobs["orbax"]["optimizer"]["state"])
        reference = blobs.pop("torch")
        del a, b, blobs

        # A third epoch resumed from each container's model_best.
        resumed = {}
        for fmt in formats:
            gen = make_model(device, head_scale=1.0, n=n)
            rcfg = dataclasses.replace(cfg, dir_path=str(tmp / fmt), resume=True, nepoch=3,
                                       validate_epochs=(), ckpt_format=fmt)
            reset_counts()
            t0 = time.perf_counter()
            hist = train_net(cat, rcfg, train_ds, val_ds, model=gen, device=device)["history"]
            torch.cuda.synchronize()
            counts["orbax_resume" if fmt == "orbax" else f"resume_{fmt}"] = expect(
                f"resume from model_best{SUFFIXES[fmt]}", steps_per_epoch)
            if [h["epoch"] for h in hist] != [3]:
                raise AssertionError(f"the resume from {fmt} ran epochs {hist}")
            resumed[fmt] = {"wall_s": time.perf_counter() - t0,
                            "chamfer_loss": hist[0]["chamfer_loss"],
                            "emd_loss": hist[0]["emd_loss"]}
            (paths[fmt].parent / "logging.log").unlink()
        if any(resumed[fmt][k] != resumed["torch"][k] for fmt in formats
               for k in ("chamfer_loss", "emd_loss")):
            raise AssertionError(f"the resumed steps differ: {resumed}")
        del gen

        # eval_shapenet on a tree holding only one container's model_best.
        tree = tmp / "tree"
        write_synthetic_shapenet(str(tree), cats=(cat,), models_per_cat=1, num_points=n)
        metrics, eval_s = {}, {}
        for fmt in formats:
            if sorted(p.name for p in paths[fmt].parent.iterdir()) != sorted(
                    [paths[fmt].name] + ([paths[fmt].name + ".json"] if fmt != "torch" else [])):
                raise AssertionError(f"the {fmt} tree holds {list(paths[fmt].parent.iterdir())}")
            reset_counts()
            t0 = time.perf_counter()
            res = eval_shapenet.main([
                "--device", str(device), *arch, "--cats", cat,
                "--model", str(tmp / fmt / "%s" / "checkpoints"),
                "--splits_path", str(tree / "splits"),
                "--data_dir_imgs", str(tree / "ShapeNetRendering"),
                "--data_dir_pcl", str(tree / "ShapeNet_pointclouds")])[cat]
            torch.cuda.synchronize()
            eval_s[fmt] = time.perf_counter() - t0
            counts["orbax_eval" if fmt == "orbax" else f"eval_{fmt}"] = expect(
                f"eval_shapenet on model_best{SUFFIXES[fmt]}", -(-res["samples"] // 64))
            metrics[fmt] = {k: res[k] for k in ("ChamferDistance", "EMD_distance", "samples")}
        if any(metrics[fmt] != metrics["torch"] for fmt in formats) or not all(
                np.isfinite(metrics["orbax"][k]) for k in ("ChamferDistance", "EMD_distance")):
            raise AssertionError(f"eval_shapenet differs between the containers: {metrics}")

        # export_deploy from each container and dtype (fenet's deploy
        # container from the .orbax and the .ckpt), then predict.
        img_dir = tmp / "images"
        img_dir.mkdir()
        for i, png in enumerate(sorted((tree / "ShapeNetRendering").rglob("*.png"))[:8]):
            shutil.copyfile(png, img_dir / f"view{i}.png")
        deploy, clouds, files = {}, {}, {}
        for src, out_fmt, suffix in (("flax", "flax", ".ckpt"), ("orbax", "flax", ".ckpt"),
                                     ("torch", "torch", ".pth")):
            for dtype in ("float32", "bfloat16"):
                reset_counts()
                t0 = time.perf_counter()
                path = export_deploy.main([
                    "--model", str(tmp / src / "%s" / "checkpoints"), "--category", cat,
                    *arch, "--device", str(device), "--dtype", dtype,
                    "--format", out_fmt, "--out", str(tmp / f"deploy_{src}_{dtype}{suffix}")])
                export_s = time.perf_counter() - t0
                plys = predict.main([
                    "--deploy_ckpt", path, "--images", str(img_dir),
                    "--out_dir", str(tmp / f"predict_{src}_{dtype}"), "--batchSize", "8",
                    "--ply_binary", "--device", str(device)])
                assert_no_launches(f"export_deploy/predict ({src}, {dtype})")
                clouds[src, dtype] = np.stack([load_pointcloud(p) for p in sorted(plys)])
                files[src, dtype] = path
                deploy[f"{src}_{dtype}"] = {"file_bytes": Path(path).stat().st_size,
                                            "export_s": export_s}
        for dtype in ("float32", "bfloat16"):
            if not filecmp.cmp(files["orbax", dtype], files["flax", dtype], shallow=False):
                raise AssertionError(f"export_deploy from model_best.orbax ({dtype}) wrote "
                                     "another file than from model_best.ckpt")
            want = clouds["torch", dtype]
            for src in ("flax", "orbax"):
                got = clouds[src, dtype]
                if got.shape != (8, n, 3) or not np.isfinite(got).all() or not np.array_equal(
                        got, want):
                    raise AssertionError(f"predict from the {src} deploy file ({dtype}) differs "
                                         f"from the torch deploy file's: shapes {got.shape}, "
                                         f"{want.shape}")

        # fenet's compression: the .orbax's chunks as zstd frames at level 1.
        packed = compress_orbax(paths["orbax"])
        t0 = time.perf_counter()
        blob = load_checkpoint(str(paths["orbax"]))
        load_s = time.perf_counter() - t0
        for key, value in blob["state_dict"].items():
            if not torch.equal(value, reference["state_dict"][key]):
                raise AssertionError(f"{key} differs after the zstd round trip")
        for i, entry in reference["optimizer"]["state"].items():
            for key, value in entry.items():
                if not torch.equal(blob["optimizer"]["state"][i][key], value):
                    raise AssertionError(f"Adam's {key} of parameter {i} differs after zstd")
        container["orbax_zstd"] = {**packed, "bytes": tree_bytes(paths["orbax"]),
                                   "load_s": load_s,
                                   "load_decoded_gb_per_s": packed["chunk_bytes"] / load_s / 1e9}
        del blob, reference
    info.update(container=container, tensors=tensors, bit_equal_loads=True,
                resumed_epoch_3=resumed, resumed_identical=True, eval=metrics,
                eval_s=eval_s, eval_identical=True, deploy=deploy,
                deploy_from_orbax_equal=True, predict_bit_equal=True, launches=counts)
    emit({"phase": "checkpoint", "nvidia_smi": nvidia_smi(), **info})
    return counts


def phase_tools(device) -> dict:
    """The port's evidence tools (fenet_torch/tools/{eps_scaling_equiv,
    sinkhorn_equiv,finetune_convergence}.py) at their default settings on
    the card, each writing its record into a temporary directory. Each arm
    (each finetune phase, each cross-eval) runs with the counts set to 0
    before it and read after it; its per-step ms on the host clock. Asserted:
    every loss finite, the finetune pass rule, each arm's kernel launched
    (the auction in the strict, adaptive and auction arms, K5 in the
    adaptive one, K6 in the Sinkhorn one), and both arms of a tool (both
    finetune phases) at the same step-0 chamfer loss to rtol 1e-6: the same
    weights and batch before any update. Returns the launches by path."""
    import contextlib
    import io
    import tempfile

    from fenet_torch.ops import emd
    from fenet_torch.tools import (equiv_common, eps_scaling_equiv, finetune_convergence,
                                   sinkhorn_equiv)

    runs = []

    def counted(module, name, label):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            reset_counts()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            runs.append({"label": label(args), "seconds": time.perf_counter() - t0,
                         "launches": {**launch_counts(),
                                      "emd_auction_scaled": emd.auction_kernel.scaled_launches},
                         # train_arm: (losses, walls, trainer); the trainer is dropped.
                         "out": out[:2] if name == "train_arm" else out})
            return out

        return fn, wrapper

    patches = [(equiv_common, "train_arm", lambda args: args[3]),
               (sinkhorn_equiv, "score", lambda args: "cross_eval"),
               (finetune_convergence, "run_phase",
                lambda args: ("warm", "faithful", "squash")[sum(
                    r["label"] in ("warm", "faithful", "squash") for r in runs)])]
    originals = []
    out = {}
    t_phase = time.perf_counter()
    try:
        for module, name, label in patches:
            fn, wrapper = counted(module, name, label)
            originals.append((module, name, fn))
            setattr(module, name, wrapper)
        with tempfile.TemporaryDirectory() as tmp:
            for tool in (eps_scaling_equiv, sinkhorn_equiv, finetune_convergence):
                del runs[:]
                short = tool.__name__.rsplit(".", 1)[1]
                log = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(log):
                    record = tool.run(["--device", str(device), "--out",
                                       str(Path(tmp) / f"{short}.json")])
                seconds = time.perf_counter() - t0
                out.update(tools_check(short, record, runs, seconds))
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    emit({"phase": "tools", "seconds": time.perf_counter() - t_phase})
    return out


def tools_check(tool: str, record: dict, runs: list, seconds: float) -> dict:
    """One tool's summary line and checks (phase_tools); its launches by
    path ``tools_<tool>_<arm>``."""
    import numpy as np

    def finite(tree) -> bool:
        if isinstance(tree, dict):
            return all(finite(v) for v in tree.values())
        if isinstance(tree, list):
            return all(finite(v) for v in tree)
        return not isinstance(tree, float) or bool(np.isfinite(tree))

    arms, launches = {}, {}
    for run in runs:
        label, out = run["label"], run["out"]
        entry = {"launches": run["launches"], "seconds": run["seconds"]}
        if isinstance(out, tuple):  # a train arm: per-step losses and walls
            entry["step_ms"] = [w * 1e3 for w in out[1]]
            entry["step0_chamfer"] = out[0][0]["chamfer_loss"]
        elif isinstance(out, list):  # a finetune phase's trace
            entry["step_ms_mean"] = run["seconds"] * 1e3 / len(out)
            entry["step0_chamfer"] = out[0]["cd"]
        else:
            entry["scores"] = out
        # A cross-eval scores the arm trained just before it.
        key = label if label != "cross_eval" else f"{label}_{list(arms)[-1]}"
        arms[key] = entry
        launches[f"tools_{tool}_{key}"] = run["launches"]
    summary = {k: record[k] for k in record if k.endswith("ratio") or k.endswith("rel_diff")
               or k in ("all_finite", "reconstruction_preserved", "recon_head_mean5",
                        "recon_tail_mean5", "squash_recon_head_mean5",
                        "squash_recon_tail_mean5", "wall_seconds", "device")}
    for key in ("strict", "adaptive", "auction", "sinkhorn"):
        if key in record:
            summary[key] = {k: v for k, v in record[key].items() if k != "per_step"}
    emit({"phase": "tools", "tool": tool, "seconds": seconds, "arms": arms, **summary})

    trained = {k: v for k, v in arms.items() if "step0_chamfer" in v}
    kernel = {"phases=1": "emd_auction", "phases=3": "emd_auction_scaled",
              "auction": "emd_auction", "sinkhorn": "sinkhorn", "warm": "emd_auction",
              "faithful": "emd_auction", "squash": "emd_auction"}
    problems = []
    if not finite(record):
        problems.append("a loss is not finite")
    if tool == "finetune_convergence" and not (record["all_finite"]
                                               and record["reconstruction_preserved"]):
        problems.append("the finetune pass rule failed")
    for label, arm in trained.items():
        if not arm["launches"][kernel[label]] > 0 or not arm["launches"]["chamfer_nn"] > 0:
            problems.append(f"{label} did not launch {kernel[label]}: {arm['launches']}")
    if tool == "eps_scaling_equiv" and trained["phases=1"]["launches"]["emd_auction_scaled"]:
        problems.append("the strict arm ran eps-scaling phases")
    firsts = [arm["step0_chamfer"] for label, arm in trained.items() if label != "warm"]
    if len(firsts) != 2 or abs(firsts[0] - firsts[1]) > 1e-6 * abs(firsts[0]):
        problems.append(f"the arms' step-0 chamfer losses differ: {firsts}")
    if problems:
        raise AssertionError(f"tool {tool}: {problems}")
    return launches


def phase_timing(launches, pred, gt, train):
    """The kernels line. K1 and K3 on the eval path's inputs (the first eval
    batch: aligned predictions vs gt) at the eval settings; K5 and K6/K7 on
    the inputs the training step gave them, with their launches in that
    mode's three steps. Each kernel is also held against its plain version
    on the train step's batch-128 clouds: K1 and K5 bit for bit, K6 to
    rtol 1e-4 / atol 1e-5."""
    import torch

    from fenet_torch.ops.chamfer import _nn_ref, nn_kernel
    from fenet_torch.ops.emd import _auction_loop, auction_kernel
    from fenet_torch.ops.sinkhorn import _potentials_plain, potentials_kernel

    b, n, m = pred.shape[0], pred.shape[1], gt.shape[1]
    d_k, _ = nn_kernel(pred, gt)
    d_p, _ = _nn_ref(pred, gt)
    nn_by = bound_ms(b * n * m * NN_OPS_PER_PAIR, (b * n + b * m) * 12 + b * n * 8)[1]
    dev = nn_device(pred, gt, "eval batch 1")
    nn_row = {
        "name": "chamfer_nn", "route": "cuda", "source": "fenet_torch/csrc/chamfer_nn.cu",
        "replaces": "fenet/ops/chamfer.py:75", "launches": launches["chamfer_nn"],
        "max_abs_err": float((d_k - d_p).abs().max()),
        "ms": dev["device_ms"],
        "plain_ms": cuda_ms(lambda: _nn_ref(pred, gt), 20),
        "bound_ms": dev["bound_ms"], "bound_by": nn_by,
        "library_ms": cuda_ms(lambda: torch.cdist(pred, gt).min(-1), 20),
        "issue_bound_ms": dev["issue_bound_ms"], "slices": dev["slices"],
        "back_to_back_ms": cuda_ms(lambda: nn_kernel(pred, gt), 100, warmup=5),
    }
    d_k, _ = auction_kernel(pred, gt, 0.005, 50)
    d_p, _, bid_rows = _auction_loop(pred, gt, 0.005, 50)
    bids = int(bid_rows.sum())
    emd_bound, emd_by, emd_per_sm = auction_bounds(bid_rows, n)
    emd_row = {
        "name": "emd_auction", "route": "cuda", "source": "fenet_torch/csrc/emd_auction.cu",
        "replaces": "fenet/ops/emd.py:200", "launches": launches["emd_auction"],
        "max_abs_err": float((d_k - d_p).abs().max()),
        "ms": cuda_ms(lambda: auction_kernel(pred, gt, 0.005, 50), 50, warmup=5),
        "plain_ms": cuda_ms(lambda: _auction_loop(pred, gt, 0.005, 50), 5),
        "bound_ms": emd_bound, "bound_by": emd_by, "bound_per_sm_ms": emd_per_sm,
        "library_ms": None,
    }

    # K1 on the train step's clouds (batch 128), both directions, against
    # its plain version bit for bit: the step's own launches.
    nn_train = nn_train_clouds(train["auction"]["pred"], train["auction"]["gt"])

    # K5: the training auction with eps-scaling and the gate, on the clouds
    # of the mode's first counted step, and on the warm-up step's.
    x1, x2 = train["scaled"]["pred"], train["scaled"]["gt"]
    b, n = x1.shape[0], x1.shape[1]

    def scaled_auction(x1):
        args = (x1, x2, 0.05, 3000, 3, True, 0.3)
        d_k, a_k = auction_kernel(*args)
        t0 = time.perf_counter()
        d_p, a_p, bid_rows = _auction_loop(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(d_k, d_p) and torch.equal(a_k, a_p)):
            raise AssertionError(
                f"emd_auction (scaled) differs from plain on the train clouds (B={b}): "
                f"{float((d_k - d_p).abs().max())}, {float((a_k != a_p).float().mean())}")
        bids = int(bid_rows.sum())
        bound = auction_bounds(bid_rows, n, gate=True)
        return {"gate_open_elements": gate_open_elements(x1, x2), "bid_rows": bids,
                "max_abs_err": float((d_k - d_p).abs().max()),
                "ms": cuda_ms(lambda: auction_kernel(*args), 10, warmup=2),
                "plain_ms": plain_ms, "bound": bound}

    step1 = scaled_auction(x1)
    warmup = scaled_auction(train["scaled"]["warmup_pred"])
    k5_bound, k5_by, k5_per_sm = step1.pop("bound")
    warmup["bound_ms"], _, warmup["bound_per_sm_ms"] = warmup.pop("bound")
    k5_row = {
        "name": "emd_auction_scaled", "route": "cuda",
        "source": "fenet_torch/csrc/emd_auction.cu",
        "replaces": "fenet/ops/emd.py:200 (scale_phases > 1, :262-281, :401-419)",
        "launches": train["scaled"]["launches"]["emd_auction"],
        "max_abs_err": step1["max_abs_err"], "ms": step1["ms"], "plain_ms": step1["plain_ms"],
        "bound_ms": k5_bound, "bound_by": k5_by, "bound_per_sm_ms": k5_per_sm,
        "library_ms": None,
    }

    # K6/K7: the Sinkhorn loss's potentials, eps = blur² = 1e-4, 300 iters,
    # held to fenet's tolerance on the train step's clouds.
    x, y = train["sinkhorn"]["pred"], train["sinkhorn"]["gt"]
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    iters = 300
    f_k, g_k = potentials_kernel(x, y, 1e-4, iters, 0.25)
    f_p, g_p = _potentials_plain(x, y, 1e-4, iters, 0.25)
    for got, want in ((f_k, f_p), (g_k, g_p)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    evals = 2 * b * n * m * iters
    k6_bound, k6_by = bound_ms(evals * SINKHORN_OPS_PER_EVAL, (b * n + b * m) * 16 + iters * 4,
                               special=evals)
    k6_row = {
        "name": "sinkhorn", "route": "cuda", "source": "fenet_torch/csrc/sinkhorn.cu",
        "replaces": "fenet/ops/sinkhorn.py:43",
        "launches": train["sinkhorn"]["launches"]["sinkhorn"],
        "max_abs_err": max(float((f_k - f_p).abs().max()), float((g_k - g_p).abs().max())),
        "loss_rel_err": sinkhorn_loss_gap(x, y, (f_k, g_k), (f_p, g_p)),
        "ms": cuda_ms(lambda: potentials_kernel(x, y, 1e-4, iters, 0.25), 5, warmup=1),
        "plain_ms": cuda_ms(lambda: _potentials_plain(x, y, 1e-4, iters, 0.25), 1, warmup=0),
        "bound_ms": k6_bound, "bound_by": k6_by, "library_ms": None,
    }
    emit({"phase": "timing", "inputs": f"eval batch 1: aligned pred vs gt, B={pred.shape[0]}, "
          f"N={pred.shape[1]}; train: the batch-{TRAIN_BATCH} clouds of each mode's first "
          f"counted step (K5 also on its warm-up step's)",
          "emd_bid_rows": bids, "emd_eps": 0.005, "emd_iters": 50,
          "chamfer_nn_train_clouds_bit_exact": True, "chamfer_nn_train": nn_train,
          "scaled_step1": step1, "scaled_warmup": warmup,
          "sinkhorn_evaluations": evals})
    return [nn_row, emd_row, k5_row, k6_row]


def phase_timing_wide(launches, pred, gt, train):
    """The kernels line's rows at WIDE_POINTS. K4 on the eval path's first
    batch (aligned predictions vs gt, 0.005 / 50) and on the clouds the
    default-mode train step handed its loss (0.05 / 3000): on the first
    STREAM_TRAIN_CHECK elements the row's times, bound and check, bit for
    bit against the plain version; the kernel is also timed on all 128. K7
    on the Sinkhorn mode's clouds, to rtol 1e-4 / atol 1e-5."""
    import torch

    from fenet_torch.ops.emd import _auction_loop, auction_kernel
    from fenet_torch.ops.sinkhorn import _potentials_plain, potentials_kernel

    def stream_row(name, x1, x2, eps, iters, n_launches, bit_exact):
        b, n = x1.shape[0], x1.shape[1]
        d_k, a_k = auction_kernel(x1, x2, eps, iters)
        t0 = time.perf_counter()
        d_p, a_p, bid_rows = _auction_loop(x1, x2, eps, iters)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        same = torch.equal(d_k, d_p) and torch.equal(a_k, a_p)
        m_k, m_p = float(d_k.sqrt().mean()), float(d_p.sqrt().mean())
        if (bit_exact and not same) or abs(m_k - m_p) > 1e-2 * m_p:
            raise AssertionError(
                f"{name} differs from plain (B={b}, N={n}): {float((d_k - d_p).abs().max())}, "
                f"{float((a_k != a_p).float().mean())}, metric {m_k} vs {m_p}")
        bids = int(bid_rows.sum())
        bound, by, per_sm = auction_bounds(bid_rows, n)
        return {"name": name, "route": "cuda",
                "source": "fenet_torch/csrc/emd_auction.cu",
                "replaces": "fenet/ops/emd.py:200 (store_value=False, :228-237, :470)",
                "launches": n_launches, "max_abs_err": float((d_k - d_p).abs().max()),
                "ms": cuda_ms(lambda: auction_kernel(x1, x2, eps, iters), 10, warmup=2),
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "bound_per_sm_ms": per_sm, "library_ms": None}, {"B": b, "bid_rows": bids, "bit_exact": same,
                                      "assignment_equal_share": float((a_k == a_p).float().mean())}

    eval_row, eval_info = stream_row("emd_auction_stream", pred, gt, 0.005, 50,
                                     launches["emd_auction_stream"], bit_exact=False)
    x1, x2 = train["auction"]["pred"], train["auction"]["gt"]
    train_row, train_info = stream_row(
        "emd_auction_stream_train", x1[:STREAM_TRAIN_CHECK].contiguous(),
        x2[:STREAM_TRAIN_CHECK].contiguous(), 0.05, 3000,
        train["auction"]["launches"]["emd_auction_stream"], bit_exact=True)
    train_info["full_batch_ms"] = cuda_ms(lambda: auction_kernel(x1, x2, 0.05, 3000), 5,
                                          warmup=1)

    x, y = train["sinkhorn"]["pred"], train["sinkhorn"]["gt"]
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    iters = 300
    f_k, g_k = potentials_kernel(x, y, 1e-4, iters, 0.25)
    t0 = time.perf_counter()
    f_p, g_p = _potentials_plain(x, y, 1e-4, iters, 0.25)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for got, want in ((f_k, f_p), (g_k, g_p)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    evals = 2 * b * n * m * iters
    k7_bound, k7_by = bound_ms(evals * SINKHORN_OPS_PER_EVAL, (b * n + b * m) * 16 + iters * 4,
                               special=evals)
    k7_row = {
        "name": "sinkhorn_stream", "route": "cuda", "source": "fenet_torch/csrc/sinkhorn.cu",
        "replaces": "fenet/ops/sinkhorn.py:114",
        "launches": train["sinkhorn"]["launches"]["sinkhorn"],
        "max_abs_err": max(float((f_k - f_p).abs().max()), float((g_k - g_p).abs().max())),
        "loss_rel_err": sinkhorn_loss_gap(x, y, (f_k, g_k), (f_p, g_p)),
        "ms": cuda_ms(lambda: potentials_kernel(x, y, 1e-4, iters, 0.25), 2, warmup=1),
        "plain_ms": plain_ms, "bound_ms": k7_bound, "bound_by": k7_by, "library_ms": None,
    }
    emit({"phase": "timing", "N": pred.shape[1],
          "inputs": f"eval batch 1: aligned pred vs gt, B={pred.shape[0]}; train: the "
          f"clouds of the first counted step, K4 on the first {STREAM_TRAIN_CHECK} of "
          f"{TRAIN_BATCH} (full_batch_ms on all), K7 on all",
          "stream_eval": eval_info, "stream_train": train_info,
          "chamfer_nn_train": nn_train_clouds(train["auction"]["pred"], train["auction"]["gt"]),
          "sinkhorn_evaluations": evals})
    return [eval_row, train_row, k7_row]


# main's phases in their order; ``--phases`` picks some, and a picked phase
# brings the phases whose results it takes (NEEDS).
PHASES = ("kernels", "plan", "eval", "train", "timing", "analysis", "pix3d", "deploy", "serve",
          "data", "parallel", "goldens", "viz", "checkpoint", "tools", "wide", "d2se", "adam")
NEEDS = {"timing": ("eval", "train"), "analysis": ("eval",), "serve": ("deploy",),
         "parallel": ("data",), "viz": ("goldens",)}


def chosen_phases(argv) -> list:
    """The phases to run, in main's order: every phase without arguments
    (the whole check), else ``--phases a,b,...`` and what those need."""
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of fenet_torch on one CUDA card.")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {','.join(PHASES)} (default: all)")
    picked = [p for p in parser.parse_args(argv).phases.split(",") if p]
    unknown = set(picked) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}; choose from {','.join(PHASES)}")
    todo = set(picked)
    while True:
        more = {need for p in todo for need in NEEDS.get(p, ())} - todo
        if not more:
            return [p for p in PHASES if p in todo]
        todo |= more


def main(argv=None) -> int:
    import torch

    run = chosen_phases(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    import fenet_torch

    if Path(fenet_torch.__file__).resolve().parent.parent != ROOT:
        raise RuntimeError(f"fenet_torch imported from {fenet_torch.__file__}, "
                           f"not from this checkout ({ROOT})")
    from fenet_torch.ops import _build

    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "phases": run})

    t0 = time.perf_counter()
    reports = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": {
        name: [ln.strip() for ln in rep.splitlines()
               if "entry function" in ln or "Used" in ln or "spill" in ln]
        for name, rep in reports.items()}})

    # The launches of the finetune, finetune_net, pix3d, data, parallel,
    # analysis, goldens, viz, checkpoint and tools phases (the ranks' counts;
    # fscore's a call, goldens' a run of 12 batches, each tool's arm by arm),
    # beside each kernel's main-path count; the serving paths' apart.
    rows, new_paths, serving = [], {}, {}
    train = None
    if "kernels" in run:
        phase_kernels(device)
        phase_kernels_train(device)
        phase_kernels_stream(device)
    if "plan" in run:
        phase_plan(device)
    if "eval" in run:
        launches, pred, gt = phase_eval(device)
    if "train" in run:
        train = phase_train(device)
        new_paths.update(finetune=train["finetune"], finetune_net=train["finetune_net"])
    if "timing" in run:
        rows = phase_timing(launches, pred, gt, train)
    if "analysis" in run:
        analysis = phase_analysis(device, pred, gt)
        new_paths.update({name: analysis[name] for name in (
            "fscore", "dense_auction", "sinkhorn_large", "goldens_ref")})
    if "pix3d" in run:
        new_paths["pix3d"] = phase_pix3d(device)
    if "deploy" in run:
        gen, serving["deploy"] = phase_deploy(device)
    if "serve" in run:
        serving.update(phase_serve(device, gen))
        del gen
    if "data" in run:
        data = phase_data(device, train["auction"]["step_ms"] if train else None)
        new_paths.update(data_prepare_data=data["prepare_data"],
                         data_train_net_native=data["native"],
                         data_train_net_per_item=data["per_item"])
    if "parallel" in run:
        new_paths.update(phase_parallel(device, data))
    if "goldens" in run:
        goldens = phase_goldens(device)
        new_paths["goldens"] = goldens["launches"]
    if "viz" in run:
        new_paths.update({f"viz_{name}": counts
                          for name, counts in phase_viz(device, goldens).items()})
    if "checkpoint" in run:
        new_paths.update({f"checkpoint_{name}": counts
                          for name, counts in phase_checkpoint(device).items()})
    if "tools" in run:
        new_paths.update(phase_tools(device))
    if "wide" in run:
        launches, pred, gt = phase_eval(device, WIDE_POINTS)
        train_wide = phase_train(device, WIDE_POINTS)
        rows += phase_timing_wide(launches, pred, gt, train_wide)
        new_paths["finetune_wide"] = train_wide["finetune"]
    if "d2se" in run:
        phase_d2se(device)
    if "adam" in run:
        phase_adam(device, reports)
    for row in rows:
        counter = next(k for k in ("emd_auction_stream", "emd_auction", "chamfer_nn", "sinkhorn")
                       if row["name"].startswith(k))
        # K5's launches are counted apart only on the paths that record them.
        path_counter = "emd_auction_scaled" if row["name"] == "emd_auction_scaled" else counter
        row["launches_new_paths"] = {path: counts[path_counter]
                                     for path, counts in new_paths.items()
                                     if path_counter in counts}
        # The serving paths' counts (each asserted 0 in its phase).
        row["launches_serving_path"] = {path: counts[counter]
                                        for path, counts in serving.items()}
    print(smi, flush=True)
    if rows:
        emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
