#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tubelet_transformer_tpu_torch) on one
NVIDIA GPU.

Phases, each of which raises (and so exits non-zero) on failure:

1. environment: torch, CUDA, the card, its power limit, nvcc;
2. build of the hand-written CUDA kernels from ``csrc/`` into one library,
   one nvcc for each source, all started together;
3. each kernel against its plain PyTorch version at the shapes the main
   paths give it (the statistics kernel also at shapes its tiles do not
   divide, in bf16 and float32; the depthwise also at shapes its blocks do
   not divide, in bf16 with its epilogue and in float32, and bit for bit
   against a repeat launch; the bottleneck also at two clips of five
   frames, one frame and 56x56 frames, and bit for bit against the stage
   chain with K = 1, whose kernel it launches; the stage chain at the
   flagship's three identity tails with the K that ``max_chain`` gives,
   at two clips of five frames and in float32 at a ragged shape, bit for
   bit against K launches of itself with K = 1 and a repeat launch; the
   pooled stem also at a ragged shape in bf16 and float32; the unpooled
   stem, which no model path runs, at 256 and 224 px and at ragged shapes
   in bf16 and float32, bit for bit against a repeat launch, and in bf16
   with the ReLU, max-pooled, bit for bit against the pooled stem; the
   pooled stem, the depthwise and the chain's three tails also at the
   serving pool's largest bucket of 8 clips, each clip's output bit-equal
   whatever the other clips hold; the pooled stem and the statistics
   kernel on each model peer's row window of the clip (MESH.SPATIAL, 2
   and 4 peers, bf16 and float32, and 4 peers of 50 rows whose pooled
   bands are uneven), the pooled rows bit for bit against the same rows
   of the whole clip's launch; the stage chain on each peer's slabs at
   MODEL 2, SPATIAL_TAILS, and on each of JHMDB's uneven slab shapes at
   MODEL 4, JHMDB_SPATIAL_TAILS; the assignment solver of the matcher, the
   counterpart of the JAX package's on-device loop, at the train path's
   four problem shapes on random, integer-tied and non-finite costs, the
   assignments identical to the plain version's (on tied costs of equal
   total) and bit for bit against a repeat launch, beside the port's
   former host solve, the costs copied out to scipy), with
   CUDA-event times (``tools/timing.py``) of calls back to back for both
   (``ms``, host work included) and of the kernel on the device alone
   (``device_ms``), of the one PyTorch call that computes the same
   function where there is one, and the least time the card could take
   (``bound``);
4. small-input references: the port on the card against the port on the
   CPU (which the tests hold against the JAX package), float32, CSN-TINY:
   the forward, and one train step;
5. the streaming path: the flagship CSN-152 TubeR streaming detector
   (configuration/tuber_csn152_ava22.yaml, random weights from a seed) on
   synthetic 240x320 frames, >= 3 keyframe detections, counting the kernel
   launches that path makes;
6. in situ: one flagship clip with the stem kernel on and off;
7. the kernel path: the flagship streaming detector again, with
   ``MODEL.PALLAS_KERNELS`` and ``MODEL.FUSED_BLOCKS`` on
   (``build/chip_smoke_kernels.yaml``): 3 depthwise launches (layer1) and 7
   fused bottlenecks (layer2 blocks 1-7) per keyframe; in situ with those
   two kernels on and off, and the forward's host time both ways in
   alternating order; then the stage path: the detector with
   ``MODEL.FUSED_STAGES`` on as well (``build/chip_smoke_stages.yaml``): the
   identity tails of layers 2-4 as stage chains (3 launches per keyframe,
   no fused bottleneck), in situ and the host time with the chains on and
   off; then the serving pool (``StreamingDetectorPool``, max_batch 8) on
   the stage path's model: warmup of buckets 1, 2, 4 and 8, then 8 streams
   of four source geometries, staggered so that buckets 4 and 8 run
   padded, each stream's keyframes against a single detector's on the same
   frames, the launches per bucket forward, the pooled stem, the depthwise
   and the chains in situ on the path's own 8-clip inputs, and the step
   latency per bucket with its assemble/upload/exec split; then where the
   device time of one forward of each detector goes (torch.profiler), and
   the serving CLI through the stage path's YAML;
8. weights in, at flagship size: a Caffe2 ``.mat`` backbone, a COCO DETR
   ``detr.pth`` (100 query rows) and a ``module.``-prefixed TubeR ``.pth``
   written from a seed-1 model (``tools/fixtures.py``), each loaded into a
   seed-0 build on the card through ``train/checkpoint.py``, bit for bit,
   with the load times;
9. the train path: the flagship fine-tune recipe (TUNE_POINT 4: stem and
   layer1-2 frozen, their BN in train mode) through the ``train_ava``
   entry point on the synthetic set with PRETRAINED and LOAD_DETR pointed
   at phase 8's files, 4 steps at batch 2, one validation and a
   checkpoint, counting the kernel launches that path makes; its third
   step under ``torch.cuda.set_sync_debug_mode("error")``, so that any
   wait of the host for the card inside it raises;
10. the eval CLI (``eval_ava``) on that checkpoint (MODEL.LOAD with
    PRETRAINED_PATH): its weights equal the checkpoint's, its frame mAP
    beside the train run's; then the serving CLI with MODEL.LOAD on it,
    in this process, its weights equal the checkpoint's too; then
    long-term context: the ``generate_lfb`` CLI on that YAML writes a
    feature bank with one key per val keyframe, and ``train_ava`` with
    USE_LFB and LFB.BANK_PATH on it takes 2 steps at batch 2 and one
    validation from the checkpoint (``build/chip_smoke_lfb_train.yaml``),
    its LFB weights moved; then the HTTP server (``DetectionServer``,
    max_batch 8) on the stage path's YAML with USE_LFB
    (``build/chip_smoke_lfb_stages.yaml``): 4 streams through
    ``client.py``, two of JPEG and two of raw frames, every keyframe
    delivered with its memory size, /healthz and /v1/stats, the launches
    per forward, and no scheduler failure;
11. in situ, train: one flagship train forward with both stem kernels on
    and off;
12. one train step on uint8 clips, so that the HSV jitter runs on the card,
    and where the device time of a train step goes; then a step on NaN
    clips, after which the parameters, BN statistics, AdamW state, update
    count and rate are bit-equal to before it; then the control of the
    steps run under sync debug mode "error": the same step with the
    matcher's plain solver, whose loops read the card, raises there;
13. one flagship train step with ``MODEL.PALLAS_KERNELS`` on: layer1 is
    frozen (TUNE_POINT 4), so its 3 depthwise convs take the kernel under
    no_grad;
14. the JHMDB path at full width: ``train_jhmdb`` on
    configuration/tuber_csn152_jhmdb.yaml (CSN-152, 224 px on the 224x400
    canvas, T=32, 10 x 32 = 320 tubelet queries, bf16, batch 2, aux losses,
    TUNE_POINT 4 over phase 8's ``.mat``) on an ACT-detector fixture of
    random 320x240 frames, its third step under sync debug mode "error",
    with its validation (frame and video mAP), then
    ``eval_jhmdb`` on its checkpoint; the loss finite, the frozen prefix
    bit-equal across the steps, both stem kernels in situ on the path's own
    inputs against their plain versions and a repeat launch, the steady
    step and the eval step, and where the device time of each goes.

15. the train options of one device, each through the flagship YAML of
    phase 9 (its ``.mat`` and DETR seed): ``TRAIN.FROZEN_CHUNK 1`` at bs 2
    through ``train_ava`` (2 steps; #4 and #2 twice a step, in situ on the
    step's one-clip inputs; the chunked prefix and its BN statistics
    against the unchunked model on each clip in turn, bit for bit);
    ``TRAIN.ACCUM_STEPS 2`` at bs 4 through ``train_ava`` (2 steps), then
    from one state the peak memory against an unaccumulated bs-4 step and
    the step against two half-batch passes by hand (the loss, the pre-clip
    gradients and grad_norm, the updated parameters);
    ``TRAIN.REMAT_BACKBONE``
    on a full-backprop step (TUNE_POINT 0, ``MODEL.PALLAS_KERNELS``, bs 2)
    against two plain steps from the same state: the peak memory, the
    gradients within the plain steps' spread, the running statistics bit
    for bit, the depthwise launches with the backward's recompute;
16. the model options: ``MODEL.MOE_EXPERTS 4`` (top 2) through
    ``train_ava`` (2 steps, ``loss_moe_aux`` finite, the expert stacks
    moved), the stage-path detector's keyframes, a StreamingDetectorPool
    bucket of 8 streams, each stream's keyframes bit-equal whatever the
    other streams push, and the card against the CPU
    port at small size; ``MODEL.NORMALIZE_BEFORE``: the stage-path
    detector's keyframes, one train step, and the card against the CPU
    port at small size;
17. ``LOG.PROFILE_STEPS 2`` through ``train_ava``: the trace under
    ``<log dir>/profile`` must name the stem statistics kernel;
18. the classification trainer (``train/classify.py``):
    ``VideoClassifier`` (CSN-152, 400 classes; no hand kernel, as in JAX)
    on (2, 32, 224, 224, 3) float32 clips with TF32 off, 4 steps of
    ``train_classification`` with an explicit AdamW: the loss finite,
    every parameter and running statistic moved, every tensor on the card,
    the step times and peak memory; then CSN-TINY, card against CPU;
19. the segmentation heads and mask losses (``models/segmentation.py``) at
    the flagship's widths, card against CPU, and their times;
20. the rolling KV-cache attention (``ops/streaming.py``) on the
    flagship's pool_decoder cross-attention (E 2048, 8 heads), 256 rows, a
    window of 4, 64 steps, each against the full recompute;
21. the ``export_torch`` CLI on phase 9's checkpoint: bit-equal through
    ``load_tuber_pth``, one eval forward bit-equal, MoE and pre-norm
    refused with a nonzero exit; ``validate_ava`` with a dump directory
    on the exported weights: ``0.txt`` and ``pr_epoch_0.png``, or the
    "PR plot skipped" line where matplotlib is missing;
22. the ``pack_data`` CLI on the JHMDB fixture's val split, then
    ``eval_jhmdb`` with ``DATA.PACKED_PATH``: every eval step's scores and
    boxes and the frame and video mAP bit-equal to the unpacked run's;
23. the 'data' axis over ``torch.distributed``, two ranks on the one card
    over gloo (NCCL refuses two ranks of one communicator on one device):
    ``train_ava`` through torchrun on phase 9's YAML with ``MESH.DATA``
    and with ``MESH.ZERO1`` (the metrics, config and checkpoint from rank
    0 alone; the ZeRO-1 file in AdamW's layout); ``tools/dp_check``
    through torchrun, the DP step of 2 ranks x 2 clips against the
    one-process step on the global batch of 4 from one state under
    deterministic algorithms, in bf16 (the stem's global statistics from
    #4 on each shard against #4 over the whole batch; ZeRO-1 against the
    DATA-only step over two steps, bit for bit, its control without the
    all-gather missing, the moment bytes per rank, the all-gather's ms)
    and in float32 with TF32 off (those, the losses, the gradient norm,
    every gradient, the running statistics; the same with MoE encoder
    FFNs and their load-balance loss; the classifier's DP step), each
    reading within its bound and a control of local statistics and
    normalisers outside every one, with each rank's step and gradient
    all-reduce times; and ``train_ava`` through torchrun with the default
    backend (NCCL) at world size 1, resuming the ZeRO-1 checkpoint
    without ZeRO-1 for one more step (phases 23 and 24 run as one,
    ``phase_mesh``, in three stages whose jobs run at once, the timed
    checks alone; the 2-rank checks of both axes in one torchrun launch
    of ``tools/mesh_checks`` per stage);
24. the 'model' axis (``MESH.MODEL``) over ``torch.distributed``, the
    ranks on the one card over gloo: ``train_ava`` through torchrun on
    phase 9's YAML with ``MESH.MODEL 2`` (4 heads and FFN 1024 a peer, the
    pool_decoder's 6144-row in-projection cut in two; the metrics, config
    and checkpoint from rank 0 alone; the checkpoint in phase 9's
    one-process layout, resumed by ``train_ava`` in one process for one
    finite step); ``tools/tp_check`` through torchrun under deterministic
    algorithms, the TP step against the one-process step on the same batch
    from one state, with MODEL 2 in bf16 (each rank's step and model
    all-reduce times) and in float32 (TF32 off), with MoE encoder FFNs (4
    experts, top 2: 2 a peer) in float32, and on 4 ranks of MESH.DATA 2 x
    MESH.MODEL 2 in float32 at the same width (the pool_decoder split
    beside the data shards), where ZeRO-1 beside the 'model' axis runs
    too, bit for bit against the DATA x MODEL step over two steps, its
    control without the all-gather missing, each rank's moment bytes beside
    the DATA x MODEL step's: each reading within its bound, the
    control ("g" whose backward sums again) outside the gradient bounds,
    the model peers' replicated parameters bit-equal after each of two
    steps, #4 and #2 once on every rank a step; ``generate_lfb``
    through torchrun with MESH.MODEL 2 on phase 10's YAML: one bank, from
    rank 0, with phase 10's one-process bank's keys, its features and
    actor probabilities within a bound from bf16's rounding, a control
    (the bank's keyframes shifted) outside it; and mesh serving
    (``tools/serve_check``, in the launches of tp_check's float32 checks
    on 2 ranks and of DATA 2 x MODEL 2 on 4) under MESH.MODEL 2 and
    under MESH.DATA 2 x MESH.MODEL 2 on the stage path's YAML (full depth
    and width, bf16): rank 0's pool (warmup, then one forward of each of
    buckets 8, 4, 2 and 1, those that 'data' divides split over it) and
    HTTP server (3 streams from a client thread of rank 0's process, two
    keyframes each), the other ranks following; each forward and stream
    against the one-process pool's and detectors' within
    SERVE_MESH_ULPS, the control ("g" left out) outside, the model peers
    bit-equal, every follower back after the stop, #2, #5 and #8 (1, 3
    and 3) in every forward of every rank, and the send, the rows'
    forward and the gather per bucket, beside the bucket sent whole and
    as each data shard's rows; and spatial parallelism (MESH.SPATIAL, the
    clip's rows split over the model peers through the trunk):
    ``train_ava`` through torchrun with MESH.MODEL 2 and SPATIAL, and
    ``tools/tp_check --spatial`` (the spatial step against the one-process
    step, beside the one-process step's own spread on the batch
    reversed, its zero-halo control and its control without the trunk's
    gradient sum, the peers bit-equal, #4 and #2 once on every rank on
    its window, each rank's peak memory against the MODEL-only step's) in
    bf16 on 2 ranks, with the stage path's eval forward (#2, #5 and the
    chains, cut to the shortest band, on every rank; within 4 bf16 ulps
    of one process), in float32 on 4 ranks of DATA 2 x MODEL 2, and in
    float32 on JHMDB's 224 x 400 canvas over MODEL 4 (uneven bands: 4,
    3, 4 and 3 rows at layers 3-4), with the stage path's eval forward
    (14 chains a rank, JHMDB_SPATIAL_TAILS); SPATIAL beside PIPE 2 on 4
    ranks in float32 (both axes' controls); MESH.MODEL 3, whose heads
    split as JAX's rule splits them (every packed projection in q, k and
    v rows, one a peer), ``tools/tp_check --model 3`` on 3 ranks in
    float32 (its "gather" control, each rank's in_proj bytes a third);
    and pipeline parallelism (MESH.PIPE 2, the encoder's 6
    layers as GPipe stages of 3 in 2 microbatches): ``train_ava`` through
    torchrun (its checkpoint the one-process layout), and
    ``tools/tp_check --pipe 2`` (the PIPE step against the one-process
    step, read on the last stage, beside the one-process step's own
    spread, its zero-carry control and its control without the encoder
    input's gradient sum, the replicated parameters bit-equal over each
    data shard's ranks, #4 and #2 once on every rank, each rank's encoder
    bytes half one process's) in bf16 (each rank's step ms beside the
    bubble, the stage path's eval forward: #2, #5, #8 on every rank) and
    float32 on 2 ranks, and with ZeRO-1 on 4 ranks of DATA 2 x PIPE 2.

The profiled windows of phases 7, 12, 14, 16 and 17 (where the device
time goes, and in how many kernel launches; for the pool, one stage-path
forward of 8 clips) run last, after every timed phase: a window slows the
host work of its process after it.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero and prints no result.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FLAGSHIP_CONFIG = ROOT / "configuration" / "tuber_csn152_ava22.yaml"
JHMDB_CONFIG = ROOT / "configuration" / "tuber_csn152_jhmdb.yaml"
# Pooled stem (x shape, dtype): the streaming paths' 256 and 224 px, the
# serving pool's largest bucket (B = 8) at 256 px, the train path's batch
# of 2, and a shape the 8x8 pooled tiles do not divide,
# in bf16 (the tensor-core kernel's edge masking) and float32 (the CUDA-core
# kernel).
STEM_CASES = {"ava_256px": ((1, 32, 256, 256, 3), "bfloat16"),
              "ava_256px_b8": ((8, 32, 256, 256, 3), "bfloat16"),
              "jhmdb_224px": ((1, 32, 224, 224, 3), "bfloat16"),
              "ava_256px_train": ((2, 32, 256, 256, 3), "bfloat16"),
              "jhmdb_224x400": ((1, 32, 224, 400, 3), "bfloat16"),
              "jhmdb_224x400_train": ((2, 32, 224, 400, 3), "bfloat16"),
              "ragged_bf16": ((2, 3, 37, 45, 3), "bfloat16"),
              "ragged_f32": ((2, 3, 37, 45, 3), "float32")}
# Statistics kernel (x shape, dtype): the train path's batch of 2 at 256
# and 224 px, one clip at 256 px (TRAIN.FROZEN_CHUNK 1), and shapes its 16x16 conv tiles do not divide: in bf16 (the
# tensor-core kernel's edge mask; ~1e6 conv pixels, as at the train shape,
# since the plain version's bf16 rounding noise shrinks as 1/sqrt(pixels))
# and in float32 (the CUDA-core kernel).
STATS_CASES = {"ava_256px_train": ((2, 32, 256, 256, 3), "bfloat16"),
               "ava_256px_clip": ((1, 32, 256, 256, 3), "bfloat16"),
               "jhmdb_224px_train": ((2, 32, 224, 224, 3), "bfloat16"),
               "jhmdb_224x400_train": ((2, 32, 224, 400, 3), "bfloat16"),
               "ragged_bf16": ((2, 32, 250, 230, 3), "bfloat16"),
               "ragged_f32": ((2, 3, 37, 45, 3), "float32")}
# The stem kernels on a model peer's row window (MESH.SPATIAL): the clip's
# rows split over `model` peers, each peer's slab of its rows and their
# halo; #2's pooled rows of a window must equal the same rows of the whole
# clip's launch bit for bit, #4's window statistics the plain version's
# within STATS_*_TOL
WINDOW_CASES = {"ava_256px_train": ((2, 32, 256, 256, 3), "bfloat16", 2),
                "ava_256px_clip": ((1, 32, 256, 256, 3), "bfloat16", 2),
                "ava_256px_train_model4": ((2, 32, 256, 256, 3), "bfloat16",
                                           4),
                "ragged_f32": ((2, 3, 64, 45, 3), "float32", 2),
                # 50 rows a peer: pooled bands of 13, 12, 13 and 12 rows,
                # peers 1 and 3 from input rows not on a multiple of 4
                "uneven_200x400_model4": ((2, 32, 200, 400, 3), "bfloat16",
                                          4)}
BUILD_DIR = ROOT / "build"
# The weight files the smoke writes in the released formats, and the name
# of the released IG65M CSN-152 backbone export they stand for.
WEIGHTS_DIR = BUILD_DIR / "chip_smoke_weights"
MAT_NAME = "irCSN_152_ft_kinetics_from_ig65m_f126851907.mat"
# The JHMDB fixture: ACT-detector videos of JHMDB_FRAMES 320x240 frames,
# every frame a sample (JHMDBDataset): 20 train steps at batch 2 and 40
# validation forwards at batch 1.
JHMDB_TRAIN_VIDEOS = ("brush_hair/v0", "catch/v1")
JHMDB_TEST_VIDEOS = ("pour/v2", "run/v3")
JHMDB_FRAMES = 20
# Kernel against plain, bf16: the plain version rounds the conv output to
# bf16 before the f32 epilogue, the kernel rounds once at the end; each
# rounding is <= 2^-9 relative, so 2^-6 of the output's range is 4x margin.
# float32 (TF32 off): summation order only.
STEM_TOL = 2.0 ** -6
STEM_POOL_TOL = {"bfloat16": STEM_TOL, "float32": 1e-5}
# Flagship model, stem kernel on against off, bf16: the two stems differ by
# ~1 bf16 ulp on some elements; 50 bottlenecks and 12 transformer layers of
# bf16 arithmetic carry that on. 0.05 of each output's range (~13 ulp)
# separates that noise from a wrong stem, which moves outputs by O(1).
IN_SITU_TOL = 0.05
# Statistics kernel against plain: limits on the mean, in units of the
# largest std, and on the variance, relative. The inputs (_stats_inputs)
# put every channel's |mean| at 2-4x its std, so a fault of coverage shows:
# at 256 px, a kernel that skips one conv column, one frame or the tiles'
# edge moves mean or var by 80-900x the bf16 limits, one skipped 16x16 tile
# of 4096 by 4.6x (mean) and 17x (var). bf16: the plain version rounds the
# conv output to bf16 before it reduces, the kernel reduces the f32
# accumulator; a float64 emulation of that rounding on these inputs gives
# 0.08 of the mean limit and 0.30 of the variance limit. float32, at a shape
# the tiles do not divide (TF32 off): summation order only, the CUDA test's
# limits; there one tile counted twice and another skipped moves the mean by
# 2e5x the limit.
STATS_MEAN_TOL = {"bfloat16": 2.0 ** -12, "float32": 1e-6}
STATS_VAR_TOL = {"bfloat16": 2.0 ** -12, "float32": 1e-5}
# Small-input reference, float32 with TF32 off on the card: sums in
# another order only.
SMALL_TOL = 1e-4
# Flagship train forward, stem kernels on against off, bf16: the batch
# statistics differ by the bf16 rounding of the plain conv output (the
# STATS tolerances); the total loss (~100, a sum of 24 weighted terms)
# carries the bf16 noise of 50 blocks and 12 layers: 2% of it separates
# that from a wrong stem.
TRAIN_IN_SITU_TOL = 0.02
# The accumulated flagship step (bf16) against two half-batch passes run by
# hand, from one state: the same kernels on the same shapes, so the totals
# should agree to the last bit; 1e-3 relative leaves room for a GEMM that
# cuBLAS picks anew. The gradients are read before the clip (CLIPS_MAX_NORM
# 0.1 acts on a random-weight step and would normalise a wrong scale away),
# in relative L2 per tensor (_rel_diffs), and so is the step's grad_norm:
# cuDNN's weight-gradient kernels may sum in another order from call to
# call, each term carrying bf16 rounding (2^-8); a missing microbatch or a
# missing or doubled 1/ACCUM_STEPS moves them by O(1). The updated
# parameters, in units of the learning rate: AdamW's first step moves each
# weight by about lr times the sign of its gradient, so a gradient of
# another sign moves it by about 2 lr; 0.1 lr leaves room for the weights
# whose gradient is near AdamW's eps.
ACCUM_LOSS_TOL = 1e-3
ACCUM_GRAD_TOL = 5e-2
ACCUM_PARAM_TOL = 0.1
# Remat against plain, full backprop, bf16: each gradient tensor within
# twice the spread of two plain steps from the same state (relative L2),
# and at least 2^-6 (4 bf16 ulps, relative), where the plain steps agree
# bit for bit: the recompute may meet other free memory, and so other cuDNN
# algorithms, than the plain step's forward.
REMAT_FLOOR = 2.0 ** -6
# The MoE options of the MoE phase: 4 experts, each token to its top 2.
MOE = {"MOE_EXPERTS": 4, "MOE_TOP_K": 2}
TRAIN_STEPS = 4        # SYNTHETIC_SIZE 8 at BATCH_SIZE 2
VAL_FORWARDS = 8       # SYNTHETIC_SIZE 8 at VAL.BATCH_SIZE 1
FRAMES = 88            # 64-frame window + 3 x 8: four keyframe detections
# The serving pool at full width (phase_pool): 8 streams of four source
# geometries; streams 0-2 start at tick 0 and 3-7 at tick 4, so with one
# step per tick the pool runs 3 streams in bucket 4 and 5 in bucket 8, both
# padded, three keyframes each (a 64-frame window, then one every 8).
POOL_GEOMETRIES = ((240, 320), (360, 640), (480, 480), (720, 1280)) * 2
POOL_STARTS = (0, 0, 0, 4, 4, 4, 4, 4)
POOL_TICKS = 84
# A stream served in a bucket against the same stream served alone: the
# largest difference of scores and actor probabilities (absolute, both in
# [0, 1]) and of boxes over the source's longer side. The same phase reads
# a control, each stream against another stream's single detector, as a
# row handed another row's output would show; the limit must lie between
# the two readings, or the phase fails. bf16: cuBLAS may choose another
# GEMM for another batch, so the two differ by bf16 rounding carried
# through 50 blocks and 12 layers: 0.0061 on an H100, where the control's
# nearest pair differs by 0.0146 with pool_frames' brightness levels (noise
# at one level: 0.0062 against 0.0050, no limit between them;
# tools/pool_control.py reads both). float32 with TF32 off: 5.7e-7 against
# 0.0134.
POOL_TOL = 0.01
POOL_F32_TOL = 1e-4
# The HTTP server at full width (phase_http): 4 client streams of these
# geometries, the first two pushing JPEG and the others raw frames, each
# FRAMES frames (four keyframes), with a 3-keyframe x 2-slot memory.
HTTP_GEOMETRIES = ((360, 640), (480, 480), (240, 320), (720, 1280))
HTTP_MEMORY = (3, 2)
# Depthwise kernel (x, w, optional scale and bias: shape, dtype, epilogue):
# layer1 of CSN-152 at 256 px, bare and with the affine + ReLU epilogue,
# and bare at the serving pool's largest bucket (B = 8); a
# shape smaller than one tile in float32; and shapes its blocks (16x16
# pixels, 32 bf16 or 16 float channels, runs of 8 frames) do not divide: T
# not a multiple of the run, H and W not multiples of the tile, C = 8 and
# C = 72 (a partial channel slice), and two clips of five frames (the frame
# window's reset at each clip's edges), each in bf16 with the epilogue and
# in float32 without.
DW_RAGGED = {"t11": (1, 11, 16, 16, 64), "hw_20x37": (1, 8, 20, 37, 64),
             "c8": (1, 9, 18, 17, 8), "c72": (1, 9, 18, 17, 72),
             "two_clips_t5": (2, 5, 16, 16, 64)}
DW_CASES = {"layer1_256px": ((1, 32, 64, 64, 64), "bfloat16", False),
            "layer1_256px_b8": ((8, 32, 64, 64, 64), "bfloat16", False),
            "layer1_256px_affine_relu": ((1, 32, 64, 64, 64), "bfloat16",
                                         True),
            "ragged_f32": ((2, 5, 7, 9, 64), "float32", False),
            **{f"{k}_bf16_affine_relu": (v, "bfloat16", True)
               for k, v in DW_RAGGED.items()},
            **{f"{k}_f32": (v, "float32", False)
               for k, v in DW_RAGGED.items()}}
# Depthwise against plain: both round once to the output type, the 27-tap
# sums in another order; bf16: 2^-6 of the output's maximum (2-4 bf16 ulps
# there; the plain version with the epilogue rounds twice); float32 with
# TF32 off: summation order only.
DW_TOL = {"bfloat16": 2.0 ** -6, "float32": 1e-5}
# Bottleneck (B, T, H, W), Ci 512, C_mid 128: layer2 of CSN-152 at 256 px;
# two clips of five frames, whose first and last frames test the reset of
# the depthwise's frame window at each clip's edges; and two shapes that
# bottleneck_supported admits beyond the chain's predicate: one frame, and
# 56x56 frames (448 px), past its 2 MiB cap.
BN_CASES = {"layer2_256px": (1, 16, 32, 32), "two_clips_t5": (2, 5, 32, 32),
            "one_frame": (1, 1, 32, 32), "frame_56": (1, 4, 56, 56)}
# Bottleneck kernels against the plain version in float32 on the same bf16
# operands: the kernels round mid and the depthwise output to bf16, as the
# TPU kernel does; 5e-3 of max|ref| in every clip, the limit of the JAX
# package's test (tests/test_pallas_bottleneck.py).
BN_TOL = 5e-3
# Stage chain: the identity tails of the flagship (CSN-152, 256 px, batch
# 1) after each stage's block 0: x shape, C_mid and the tail's blocks; a
# chain takes at most max_chain of them.
FLAGSHIP_TAILS = {"layer2": ((1, 16, 32, 32, 512), 128, 7),
                  "layer3": ((1, 8, 16, 16, 1024), 256, 35),
                  "layer4": ((1, 4, 16, 16, 2048), 512, 2)}
# the chain's checks: those three, the same at the serving pool's largest
# bucket (B = 8), two clips of five frames at layer2 (the
# reset of the depthwise's frame window at each clip's edges), and float32
# at a shape the 8x8 tiles do not divide
# Under MESH.SPATIAL at MODEL 2 each peer's chains run on its slab (its
# rows and k halo rows of its one neighbour), at most its rows a chain:
# layer2 one chain of 7 on 16 + 7 rows, layer3 four of 8 on 8 + 8 and one
# of 3 on 8 + 3, layer4 one of 2 on 8 + 2 (7 launches a rank a forward)
SPATIAL_TAILS = {"layer2": ((1, 16, 23, 32, 512), 128, 7, 1),
                 "layer3": ((1, 8, 16, 16, 1024), 256, 8, 4),
                 "layer3_last": ((1, 8, 11, 16, 1024), 256, 3, 1),
                 "layer4": ((1, 4, 10, 16, 2048), 512, 2, 1)}
# Under MESH.SPATIAL at MODEL 4 on JHMDB's recipe (CSN-152, 224 x 400, T
# 32) the bands are uneven: 7 rows a peer at layer2's output, 4, 3, 4 and
# 3 at layer3's and layer4's. Every peer cuts its chains alike, at most
# the shortest band's rows (CSN.stage): layer2 one chain of 7, layer3
# eleven of 3 and one of 2, layer4 one of 2: 14 launches a rank a
# forward. Each peer's slab (its rows and k rows on each side, cut at the
# clip's border) by (stage, slab rows, k): the shape, C_mid, k, the
# launches of that shape over the 4 ranks in one forward, and the peers
# that launch it (checked against the port's bands, ``spatial_slabs``)
JHMDB_SPATIAL_TAILS = {
    "layer2_r14_k7": ((1, 16, 14, 50, 512), 128, 7, 2, (0, 3)),
    "layer2_r21_k7": ((1, 16, 21, 50, 512), 128, 7, 2, (1, 2)),
    "layer3_r7_k3": ((1, 8, 7, 25, 1024), 256, 3, 11, (0,)),
    "layer3_r9_k3": ((1, 8, 9, 25, 1024), 256, 3, 11, (1,)),
    "layer3_r10_k3": ((1, 8, 10, 25, 1024), 256, 3, 11, (2,)),
    "layer3_r6_k3": ((1, 8, 6, 25, 1024), 256, 3, 11, (3,)),
    "layer3_r6_k2": ((1, 8, 6, 25, 1024), 256, 2, 1, (0,)),
    "layer3_r7_k2": ((1, 8, 7, 25, 1024), 256, 2, 1, (1,)),
    "layer3_r8_k2": ((1, 8, 8, 25, 1024), 256, 2, 1, (2,)),
    "layer3_r5_k2": ((1, 8, 5, 25, 1024), 256, 2, 1, (3,)),
    "layer4_r6_k2": ((1, 4, 6, 25, 2048), 512, 2, 1, (0,)),
    "layer4_r7_k2": ((1, 4, 7, 25, 2048), 512, 2, 1, (1,)),
    "layer4_r8_k2": ((1, 4, 8, 25, 2048), 512, 2, 1, (2,)),
    "layer4_r5_k2": ((1, 4, 5, 25, 2048), 512, 2, 1, (3,))}
JHMDB_SPATIAL = {"height": 224, "width": 400, "frames": 32, "model": 4}
CHAIN_CASES = {**{f"{k}_256px": (v, "bfloat16") for k, v in
                  FLAGSHIP_TAILS.items()},
               **{f"{k}_256px_b8": (((8, *x[1:]), cm, tail), "bfloat16")
                  for k, (x, cm, tail) in FLAGSHIP_TAILS.items()},
               **{f"{k}_spatial2": ((x, cm, tail), "bfloat16")
                  for k, (x, cm, tail, _) in SPATIAL_TAILS.items()},
               **{f"{k}_jhmdb4": ((x, cm, k_), "bfloat16")
                  for k, (x, cm, k_, *_) in JHMDB_SPATIAL_TAILS.items()},
               "two_clips_t5": (((2, 5, 32, 32, 512), 128, 7), "bfloat16"),
               "ragged_f32": (((1, 4, 13, 21, 512), 128, 3), "float32")}
# Chain against the plain version. The kernel must equal K launches of
# itself with K = 1, bf16 between them (the same tile bodies and summation
# order: a difference is a race or a missing barrier), and a repeat launch:
# bit for bit. Against the plain version that rounds where the
# kernel rounds, computed in float64: a bf16 rounding that summation order
# flips is 1 ulp, 0.4-0.8% of an element near max|ref|, and flips cascade
# through the blocks that follow (the float32 and float64 rounded plain
# versions differ by ~1.2% of max|ref| over layer3's 35 blocks on the CPU),
# so no fixed limit holds for every K. Each clip's error must stay within
# CHAIN_TOL of max|ref| or twice the float32 plain version's own error
# against the float64 one, whichever is larger: the kernel is no further
# from the exact sums than the plain version, with 2x margin.
CHAIN_TOL = 5e-3
# Unpooled stem (x shape, dtype, relu): 256 and 224 px in bf16 with and
# without the ReLU, and shapes the 16x16 tiles do not divide: in bf16 (the
# tensor-core kernel's ragged edge; rows of 23 px, which it stores one
# element at a time, and rows of 40 px that end mid-tile) and in float32.
# The bf16 cases with the ReLU are also max-pooled and held bit for bit to
# the pooled kernel.
STEM_CONV_CASES = {"ava_256px": ((1, 32, 256, 256, 3), "bfloat16", True),
                   "ava_256px_no_relu": ((1, 32, 256, 256, 3), "bfloat16",
                                         False),
                   "jhmdb_224px": ((1, 32, 224, 224, 3), "bfloat16", True),
                   "ragged_bf16": ((2, 3, 37, 45, 3), "bfloat16", True),
                   "ragged_bf16_w80": ((1, 3, 50, 80, 3), "bfloat16",
                                       False),
                   "ragged_f32": ((2, 3, 37, 45, 3), "float32", True)}
# Unpooled stem against plain: bf16 as STEM_TOL (the plain version rounds
# the conv output before the affine); float32 with TF32 off: summation
# order only.
STEM_CONV_TOL = {"bfloat16": STEM_TOL, "float32": 1e-5}
# The aten ops of train-mode BN's batch statistics (models/csn.py:
# batch_stats: a float32 sum and vector norm of a bf16 x; var_mean was the
# form before), named in the train breakdown wherever they rank; sum also
# serves the losses.
BN_STATS_OPS = ("aten::sum", "aten::linalg_vector_norm", "aten::var_mean")
# the matcher's assignment problems on the path, (N, Q, M): N = decoder
# layers x batch; the train steps at batch 2 (each microbatch under
# ACCUM_STEPS 2 too), the eval step's losses at batch 1
ASSIGN_CASES = {"ava_train": (12, 15, 32), "jhmdb_train": (12, 10, 8),
                "ava_eval": (6, 15, 32), "jhmdb_eval": (6, 10, 8)}
ASSIGN_KINDS = ("random", "tied", "nonfinite")
# the train step that runs under sync debug mode "error" in the train_ava
# and train_jhmdb runs (0-based; steady, after the first)
NO_SYNC_STEP = 2
# Published NVIDIA H100 SXM peaks (data sheet, dense, 700 W): device memory
# and the rates for each input type (bf16 on the tensor cores, float32 on
# the CUDA cores, TF32 off).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, **kw) -> float:
    """CUDA-event time of one call of ``fn`` (tools/timing.py:time_ms): by
    default calls back to back, host work included (the ``ms`` of every
    kernel and plain version); with ``queued=True`` the device's alone,
    each run of calls queued behind a spin kernel that outlasts their host
    work (``device_ms``)."""
    del torch
    from tubelet_transformer_tpu_torch.tools.timing import time_ms as t

    return t(fn, **kw)


def phase_environment(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from tubelet_transformer_tpu_torch.ops.cuda.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
        f"  count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {smi}")
    log(f"[env] nvcc: {nvcc[-1]}")
    return smi.splitlines()[0]


def bound(nbytes: float, ops: float, dtype_name: str) -> tuple[float, str]:
    """The least time (ms) the card could take to move ``nbytes`` and do
    ``ops`` operations on inputs of ``dtype_name``, and which bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def phase_build() -> None:
    """One nvcc for each source, all started together, then one link; a
    failure raises."""
    from tubelet_transformer_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.kernels(verbose=True)
    wall = time.perf_counter() - t0
    built = {k: round(v, 2) for k, v in build.BUILD_SECONDS.items()}
    log(f"[build] kernel library: nvcc seconds {built or 'already built'}"
        f", {wall:.2f} s to build and load")


def rows_independent(torch, fn, x, rest, rows=(0, -1)) -> bool:
    """Whether row i of ``fn(x, *rest)`` is bit-equal whatever the other
    rows of the batch hold: for each i of ``rows``, the other rows are
    replaced by x's rows in reverse order (other contents, and rows the
    serving pool's padding repeats) and row i must not move by a bit."""
    want = fn(x, *rest)
    filler = x.flip(0)
    for i in rows:
        other = filler.clone()
        other[i] = x[i]
        if not torch.equal(fn(other, *rest)[i], want[i]):
            return False
    return True


def _dev(torch, a, dtype):
    return torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)


def phase_kernels(torch, stem) -> dict:
    """The pooled stem against stem_reference (STEM_CASES), a repeat launch
    bit for bit, and the times of the kernel and the plain version."""
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    results = {}
    for name, (shape, dtype_name) in STEM_CASES.items():
        dtype = getattr(torch, dtype_name)
        x = _dev(torch, rng.normal(size=shape), dtype)
        w = _dev(torch, rng.normal(size=stem.W_SHAPE) * 0.05, dtype)
        scale = _dev(torch, rng.uniform(0.5, 2.0, 64), torch.float32)
        bias = _dev(torch, rng.normal(size=64), torch.float32)
        got = stem.stem_forward(x, w, scale, bias)
        again = stem.stem_forward(x, w, scale, bias)
        torch.cuda.synchronize()
        ref = stem.stem_reference(x, w, scale, bias)
        if got.shape != ref.shape or got.dtype != dtype:
            raise AssertionError(f"stem {name}: {tuple(got.shape)} "
                                 f"{got.dtype}, want {tuple(ref.shape)}")
        bits = torch.equal(got, again)
        rows = shape[0] < 8 or rows_independent(torch, stem.stem_forward, x,
                                                 (w, scale, bias))
        err = (got.float() - ref.float()).abs().max().item()
        span = ref.float().abs().max().item()
        ms = time_ms(torch, lambda: stem.stem_forward(x, w, scale, bias))
        device_ms = time_ms(torch, lambda: stem.stem_forward(x, w, scale,
                                                             bias),
                            queued=True)
        plain_ms = time_ms(torch,
                           lambda: stem.stem_reference(x, w, scale, bias))
        b, t, h, wd, _ = shape
        gflop = 2 * b * t * ((h + 1) // 2) * ((wd + 1) // 2) * 64 * 441 / 1e9
        bound_ms, bound_by = bound(nbytes(x, w, scale, bias, got),
                                   gflop * 1e9, dtype_name)
        tol = STEM_POOL_TOL[dtype_name]
        log(f"[kernel] stem_pool {name} {shape} {dtype_name}: max_abs_err "
            f"{err:.6g} (rel to max|ref| {err / span:.3g}, tol {tol:.3g}); "
            f"repeat bit-equal {bits}; rows independent {rows}; kernel "
            f"{ms:.4f} ms (the device alone "
            f"{device_ms:.4f} ms, {gflop / device_ms:.2f} TFLOP/s, "
            f"{bound_ms / device_ms:.3f} of the bound), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not (err <= tol * span and bits and rows):
            raise AssertionError(f"stem {name}: kernel disagrees with plain "
                                 f"({err} > {tol} * {span}), repeats "
                                 f"differ ({bits}) or rows depend on each "
                                 f"other ({rows})")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None, "device_ms": device_ms}
    return results


def _stats_inputs(shape, seed: int):
    """x (B,T,H,W,3) and w whose conv statistics expose a fault of
    coverage: x is noise on an offset that changes with the clip and the
    frame and over bands of 24 rows and of 40 columns, w has a positive mean,
    so every channel's |mean| is 2-4x its std and tiles differ."""
    b, t, h, w, _ = shape
    rng = np.random.default_rng(seed)
    bt = np.arange(b)[:, None] + np.arange(t)[None, :]
    offset = (1.0 + 0.5 * (bt % 3)[:, :, None, None, None]
              + 0.5 * ((np.arange(h) // 24) % 2)[:, None, None]
              - 0.25 * ((np.arange(w) // 40) % 3)[:, None])
    x = offset + 0.5 * rng.normal(size=shape)
    return x, rng.normal(size=(3, 7, 7, 3, 64)) * 0.05 + 0.01


def phase_stats_kernel(torch, stem) -> dict:
    """The statistics kernel against stem_batch_stats_reference at the
    train path's shape and the 224 px one in bf16, and at a shape its tiles
    do not divide in float32."""
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for name, (shape, dtype_name) in STATS_CASES.items():
        dtype = getattr(torch, dtype_name)
        x, w = (_dev(torch, a, dtype) for a in _stats_inputs(shape, seed=1))
        mean, var = stem.stem_batch_stats(x, w)
        again = stem.stem_batch_stats(x, w)
        torch.cuda.synchronize()
        ref_mean, ref_var = stem.stem_batch_stats_reference(x, w)
        mean_err = (mean - ref_mean).abs().max().item()
        var_err = (var - ref_var).abs().max().item()
        var_rel = ((var - ref_var).abs() / ref_var).max().item()
        std = ref_var.sqrt().max().item()
        bits = torch.equal(mean, again[0]) and torch.equal(var, again[1])
        ms = time_ms(torch, lambda: stem.stem_batch_stats(x, w))
        device_ms = time_ms(torch, lambda: stem.stem_batch_stats(x, w),
                            queued=True)
        plain_ms = time_ms(torch,
                           lambda: stem.stem_batch_stats_reference(x, w))
        b, t, h, wd, _ = shape
        gflop = 2 * b * t * ((h + 1) // 2) * ((wd + 1) // 2) * 64 * 441 / 1e9
        bound_ms, bound_by = bound(nbytes(x, w, mean, var), gflop * 1e9,
                                   dtype_name)
        mean_tol = STATS_MEAN_TOL[dtype_name]
        var_tol = STATS_VAR_TOL[dtype_name]
        log(f"[kernel] stem_stats {name} {shape} {dtype_name}: mean "
            f"max_abs_err {mean_err:.4g} (rel to max std {mean_err / std:.3g},"
            f" tol {mean_tol:.3g}); var max_abs_err {var_err:.4g} (max rel "
            f"{var_rel:.3g}, tol {var_tol:.3g}); repeat bit-equal {bits}; "
            f"kernel {ms:.4f} ms (the device alone {device_ms:.4f} ms, "
            f"{gflop / device_ms:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        if not (mean_err <= mean_tol * std and var_rel <= var_tol and bits):
            raise AssertionError(f"stem_stats {name}: kernel disagrees with "
                                 "plain, or repeats differ")
        results[name] = {"max_abs_err": max(mean_err, var_err), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None,
                         "device_ms": device_ms}
    return results


def phase_window_kernels(torch, stem) -> dict:
    """#2 and #4 on each model peer's row window (WINDOW_CASES): the
    pooled rows of each peer's slab bit for bit against the same rows of
    the whole clip's launch, and against the windowed plain version; each
    window's statistics against the windowed plain version, and the peers'
    statistics averaged (weighted by their conv rows) against the whole
    clip's; the times of the first window whose input rows start off a
    multiple of 4 (an uneven band), else peer 0's (the kernel, the device
    alone, the plain version, the bound). Each peer's slab holds the rows
    above and below its band that ``stem_halo`` exchanges, as the model's
    spatial stem does."""
    from tubelet_transformer_tpu_torch.parallel.mesh import Bands

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(7)
    results = {}
    for name, (shape, dtype_name, model) in WINDOW_CASES.items():
        dtype = getattr(torch, dtype_name)
        xs, ws = _stats_inputs(shape, seed=2)
        x, w = _dev(torch, xs, dtype), _dev(torch, ws, dtype)
        scale = _dev(torch, rng.uniform(0.5, 2.0, 64), torch.float32)
        bias = _dev(torch, rng.normal(size=64), torch.float32)
        b, t, h, wd, _ = shape
        full = stem.stem_forward(x, w, scale, bias)
        full_mean, full_var = stem.stem_batch_stats(x, w)
        rows = h // model
        top, below = stem.stem_halo(Bands.split(h, model))
        equal, pool_err, means, msqs, windows = [], 0.0, [], [], []
        counts = []
        stat_err = [0.0, 0.0]             # of the means, of the variances
        for i in range(model):
            first = i * rows
            pw = stem.peer_window(first, rows, h, pooled=True, top=top)
            sw = stem.peer_window(first, rows, h, pooled=False)
            end = min(h, first + rows + below)
            pslab = x[:, :, pw.row0:end].contiguous()
            sslab = x[:, :, sw.row0:end].contiguous()
            got = stem.stem_forward(pslab, w, scale, bias, pw)
            ref = stem.stem_reference(pslab, w, scale, bias, pw)
            mean, var = stem.stem_batch_stats(sslab, w, sw)
            ref_mean, ref_var = stem.stem_batch_stats_reference(sslab, w, sw)
            torch.cuda.synchronize()
            equal.append(torch.equal(
                got, full[:, :, pw.out0:pw.out0 + pw.out_rows]))
            span = ref.float().abs().max().item()
            pool_err = max(pool_err, (got.float() - ref.float()).abs().max()
                           .item() / span)
            std = ref_var.sqrt().max().item()
            stat_err = [max(stat_err[0],
                            (mean - ref_mean).abs().max().item() / std),
                        max(stat_err[1],
                            ((var - ref_var).abs() / ref_var).max().item())]
            means.append(mean)
            msqs.append(var + mean.square())
            counts.append(float(sw.out_rows))
            windows.append((pslab, pw, got, sslab, sw, mean, var))
        n = torch.tensor(counts, device=means[0].device)[:, None]
        mean = (torch.stack(means) * n).sum(0) / n.sum()
        var = (torch.stack(msqs) * n).sum(0) / n.sum() - mean.square()
        avg_err = [(mean - full_mean).abs().max().item()
                   / full_var.sqrt().max().item(),
                   ((var - full_var).abs() / full_var).max().item()]
        timed_peer = next((i for i in range(model) if i * rows % 4), 0)
        pslab, pw, got, sslab, sw, mean, var = windows[timed_peer]
        c0, c1 = stem.pool_conv_rows(pw)
        wc = (wd - 1) // 2 + 1
        timed = {
            "stem_pool": (lambda: stem.stem_forward(pslab, w, scale, bias,
                                                    pw),
                          lambda: stem.stem_reference(pslab, w, scale, bias,
                                                      pw),
                          nbytes(pslab, w, scale, bias, got),
                          2 * b * t * (c1 - c0) * wc * 64 * 441),
            "stem_stats": (lambda: stem.stem_batch_stats(sslab, w, sw),
                           lambda: stem.stem_batch_stats_reference(sslab, w,
                                                                   sw),
                           nbytes(sslab, w, mean, var),
                           2 * b * t * sw.out_rows * wc * 64 * 441)}
        case = {"peers": model, "timed_peer": timed_peer,
                "pooled_rows": [w[1].out_rows for w in windows],
                "pool_bit_equal": equal,
                "pool_rel_err": pool_err, "stats_rel_err": stat_err,
                "stats_average_rel_err": avg_err}
        for kernel, (fn, plain, nb, ops) in timed.items():
            bound_ms, bound_by = bound(nb, ops, dtype_name)
            case[kernel] = {
                "shape": tuple((pslab if kernel == "stem_pool" else sslab)
                               .shape),
                "ms": time_ms(torch, fn),
                "device_ms": time_ms(torch, fn, queued=True),
                "plain_ms": time_ms(torch, plain), "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
        tol_pool = STEM_POOL_TOL[dtype_name]
        tol_stats = [STATS_MEAN_TOL[dtype_name], STATS_VAR_TOL[dtype_name]]
        log(f"[kernel] window {name} {shape} {dtype_name} over {model} "
            f"peers: #2 each peer's pooled rows bit-equal to the whole "
            f"clip's {equal}, against the windowed plain version "
            f"{pool_err:.3g} of max|ref| (tol {tol_pool:.3g}); #4 each "
            f"window against the windowed plain version, the mean (of the "
            f"max std) and the variance (relative) {stat_err} (tol "
            f"{tol_stats}), the peers' statistics averaged against the "
            f"whole clip's {avg_err}; pooled rows per peer "
            f"{case['pooled_rows']}; peer {timed_peer}: "
            + "; ".join(f"{k} {v['shape']} kernel {v['ms']:.4f} ms (the "
                        f"device alone {v['device_ms']:.4f}), plain "
                        f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} "
                        f"ms ({v['bound_by']})"
                        for k, v in case.items() if isinstance(v, dict)))
        if not (all(equal) and pool_err <= tol_pool
                and all(e <= t for e, t in zip(stat_err + avg_err,
                                               tol_stats * 2))):
            raise AssertionError(f"window {name}: {case}")
        results[name] = case
    return results


def phase_depthwise_kernel(torch) -> dict:
    """The depthwise kernel against depthwise_reference (DW_CASES), with the
    times of the kernel, the plain version and cuDNN's grouped conv
    (``F.conv3d(groups=C)``) on a contiguous channels-first copy, without
    and with the two layout copies around it."""
    import torch.nn.functional as F

    from tubelet_transformer_tpu_torch.ops.cuda import depthwise as D

    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for name, (shape, dtype_name, epilogue) in DW_CASES.items():
        dtype = getattr(torch, dtype_name)
        rng = np.random.default_rng(4)
        c = shape[-1]
        x = _dev(torch, rng.normal(size=shape), dtype)
        w = _dev(torch, rng.normal(0, 0.2, (3, 3, 3, c)), dtype)
        scale = bias = None
        if epilogue:
            scale = _dev(torch, rng.uniform(0.5, 1.5, c), torch.float32)
            bias = _dev(torch, rng.normal(0, 0.5, c), torch.float32)

        def kernel():
            return D.depthwise_conv3x3x3(x, w, scale, bias, relu=epilogue)

        def plain():
            return D.depthwise_reference(x, w, scale, bias, relu=epilogue)

        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        bits = torch.equal(got, again)
        rows = shape[0] < 8 or rows_independent(
            torch, lambda xs: D.depthwise_conv3x3x3(xs, w, scale, bias,
                                                    relu=epilogue), x, ())
        ref = plain()
        if got.shape != ref.shape or got.dtype != dtype:
            raise AssertionError(f"depthwise {name}: {tuple(got.shape)} "
                                 f"{got.dtype}, want {tuple(ref.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        span = ref.float().abs().max().item()
        w_cf = w.permute(3, 0, 1, 2).unsqueeze(1).contiguous()
        x_cf = x.permute(0, 4, 1, 2, 3).contiguous()
        ms = time_ms(torch, kernel)
        device_ms = time_ms(torch, kernel, queued=True)
        plain_ms = time_ms(torch, plain)
        library_ms = time_ms(torch, lambda: F.conv3d(x_cf, w_cf, padding=1,
                                                     groups=c))
        copies_ms = time_ms(torch, lambda: F.conv3d(
            x.permute(0, 4, 1, 2, 3).contiguous(), w_cf, padding=1,
            groups=c).permute(0, 2, 3, 4, 1).contiguous())
        ops = (2 * 27 + (3 if epilogue else 0)) * x.numel()
        bound_ms, bound_by = bound(nbytes(x, w, scale, bias, got), ops,
                                   dtype_name)
        tol = DW_TOL[dtype_name]
        log(f"[kernel] depthwise {name} {shape} {dtype_name}"
            f"{' +affine+relu' if epilogue else ''}: max_abs_err {err:.4g} "
            f"(rel to max|ref| {err / span:.3g}, tol {tol:.3g}); repeat "
            f"bit-equal {bits}; rows independent {rows}; kernel "
            f"{ms:.4f} ms (the device alone {device_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, cuDNN grouped conv "
            f"{library_ms:.4f} ms ({copies_ms:.4f} ms with the two layout "
            f"copies), bound {bound_ms:.4f} ms ({bound_by})")
        if not (err <= tol * span and bits and rows):
            raise AssertionError(f"depthwise {name}: kernel disagrees with "
                                 f"plain ({err} > {tol} * {span}), "
                                 f"repeats differ ({bits}) or rows depend "
                                 f"on each other ({rows})")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms,
                         "library_with_copies_ms": copies_ms,
                         "device_ms": device_ms}
    return results


def phase_bottleneck_kernel(torch) -> dict:
    """The fused bottleneck against bottleneck_reference (BN_CASES): the
    error against the plain version in float32 on the kernel's bf16
    operands, in every clip, and bit for bit against bottleneck_chain with
    K = 1 (the kernel it launches: a difference is a fault of the wrapper);
    times of the kernel and of the plain version in bf16 (no single PyTorch
    call computes the block). Only the cooperative launch is built: three
    ordinary launches of the chain's phase bodies lost to it on the card
    (PERF.md, section 6)."""
    from tubelet_transformer_tpu_torch.ops.cuda import bottleneck as B
    from tubelet_transformer_tpu_torch.ops.cuda import stage as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    ci, cm = 512, 128
    for name, (b, t, h, w) in BN_CASES.items():
        rng = np.random.default_rng(5)

        def mk(*shape, scale=1.0, mean=0.0):
            return _dev(torch, rng.normal(mean, scale, shape),
                        torch.bfloat16 if len(shape) > 1 else torch.float32)

        args = (mk(b, t, h, w, ci), mk(ci, cm, scale=.05),
                mk(3, 3, 3, cm, scale=.2), mk(cm, ci, scale=.05),
                mk(cm, scale=.3, mean=1.0), mk(cm, scale=.3),
                mk(cm, scale=.3, mean=1.0), mk(cm, scale=.3),
                mk(ci, scale=.3, mean=1.0), mk(ci, scale=.3))
        got = B.bottleneck_fused(*args)
        chain = S.bottleneck_chain(args[0], *(a[None] for a in args[1:]))
        torch.cuda.synchronize()
        exact = torch.equal(got, chain)
        ref = B.bottleneck_reference(*(a.float() for a in args))
        span = ref.abs().max().item()
        errs = [(got[i].float() - ref[i]).abs().max().item()
                for i in range(b)]
        ms = time_ms(torch, lambda: B.bottleneck_fused(*args))
        device_ms = time_ms(torch, lambda: B.bottleneck_fused(*args),
                            queued=True)
        plain_ms = time_ms(torch, lambda: B.bottleneck_reference(*args))
        pixels = b * t * h * w
        ops = 2 * pixels * (2 * ci * cm + 27 * cm)
        bound_ms, bound_by = bound(nbytes(*args, got), ops, "bfloat16")
        log(f"[kernel] bottleneck {name} ({b},{t},{h},{w},{ci}) Cm={cm} bf16: "
            f"bit-equal to the chain with K = 1 {exact}; max_abs_err per "
            f"clip {[round(e, 5) for e in errs]} (rel to max|ref| "
            f"{max(errs) / span:.3g}, tol {BN_TOL}); kernel {ms:.4f} ms "
            f"(the device alone {device_ms:.4f} ms, "
            f"{ops / device_ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        if not (exact and got.shape == ref.shape
                and max(errs) <= BN_TOL * span):
            raise AssertionError(f"bottleneck {name}: kernel disagrees with "
                                 f"the chain ({exact}) or with plain "
                                 f"({errs} vs {BN_TOL} * {span})")
        results[name] = {"max_abs_err": max(errs), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None,
                         "device_ms": device_ms}
    return results


def _chain_args(torch, shape, cm, k, dtype_name, seed):
    """x and the stacked weights of a K-block chain on the card, whose
    residual stream stays O(1) over 35 blocks: conv weights at 1/sqrt(fan
    in), the depthwise at 0.2, affines near 1 with conv4's near 0.2 (on the
    CPU, layer3's 35 blocks then keep ~90% of the stream positive, mean
    ~0.8, max ~7). x and the weights are bf16 values."""
    ci = shape[-1]
    rng = np.random.default_rng(seed)

    def mk(*s, scale=1.0, mean=0.0):
        return rng.normal(mean, scale, s)

    x = _dev(torch, mk(*shape), torch.bfloat16).to(getattr(torch,
                                                           dtype_name))
    weights = (mk(k, ci, cm, scale=ci ** -.5), mk(k, 3, 3, 3, cm, scale=.2),
               mk(k, cm, ci, scale=cm ** -.5))
    affines = (mk(k, cm, scale=.1, mean=1.), mk(k, cm, scale=.3),
               mk(k, cm, scale=.1, mean=1.), mk(k, cm, scale=.3),
               mk(k, ci, scale=.05, mean=.2), mk(k, ci, scale=.1))
    return (x, *(_dev(torch, w, torch.bfloat16) for w in weights),
            *(_dev(torch, a, torch.float32) for a in affines))


def chain_errors(torch, S, got, args
                 ) -> tuple[list, list, list, list, list]:
    """Per clip: the kernel's error against the float64 plain version that
    rounds where it does, the limit (CHAIN_TOL of max|ref|, or twice the
    float32 rounded plain version's own error, whichever is larger), that
    float32 error, max|ref|, and the kernel's error against the float64
    version with its output rounded to the kernel's type as well."""
    ref64 = S.chain_reference_rounded(args[0], args[1:], torch.float64)
    ref32 = S.chain_reference_rounded(args[0], args[1:])
    errs, limits, plain_errs, spans, rounded_errs = [], [], [], [], []
    for i in range(args[0].shape[0]):
        spans.append(ref64[i].abs().max().item())
        errs.append((got[i].double() - ref64[i]).abs().max().item())
        plain_errs.append((ref32[i].double() - ref64[i]).abs().max().item())
        limits.append(max(CHAIN_TOL * spans[-1], 2 * plain_errs[-1]))
        rounded_errs.append((got[i].double() - ref64[i].to(got.dtype)
                             .double()).abs().max().item())
    return errs, limits, plain_errs, spans, rounded_errs


def phase_stage_kernel(torch) -> dict:
    """The stage chain against K launches of itself with K = 1, a repeat
    launch and the plain version (CHAIN_CASES, CHAIN_TOL), with its grid,
    the work items of each phase, the times of the kernel and of the plain
    version (chain_reference in the working type; no single PyTorch call
    computes a chain) and its bound."""
    from tubelet_transformer_tpu_torch.ops.cuda import stage as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for name, ((shape, cm, tail), dtype_name) in CHAIN_CASES.items():
        b, t, h, w, ci = shape
        k = min(tail, S.max_chain(h * w, ci, cm))
        args = _chain_args(torch, shape, cm, k, dtype_name, seed=6)
        got = S.bottleneck_chain(*args)
        again = S.bottleneck_chain(*args)
        blocks = args[0]
        for i in range(k):
            blocks = S.bottleneck_chain(blocks,
                                        *(a[i:i + 1] for a in args[1:]))
            if i + 1 < k:
                blocks = blocks.to(torch.bfloat16).to(got.dtype)
        torch.cuda.synchronize()
        exact = got.shape == blocks.shape and torch.equal(got, blocks)
        repeat = torch.equal(got, again)
        rows = b < 8 or rows_independent(torch, S.bottleneck_chain, args[0],
                                         args[1:])
        errs, limits, plain_errs, spans, _ = chain_errors(torch, S, got,
                                                          args)
        span = max(spans)
        unrounded = S.chain_reference(args[0].float(),
                                      [a.float() for a in args[1:]])
        unrounded_errs = [(got[i].float() - unrounded[i]).abs().max().item()
                          / unrounded[i].abs().max().item()
                          for i in range(b)]
        finite = bool(torch.isfinite(got).all())
        ms = time_ms(torch, lambda: S.bottleneck_chain(*args))
        device_ms = time_ms(torch, lambda: S.bottleneck_chain(*args),
                            queued=True)
        plain_ms = time_ms(torch, lambda: S.chain_reference(args[0],
                                                            args[1:]),
                           runs=5, calls=2)
        ops = 2 * b * t * h * w * k * (2 * ci * cm + 27 * cm)
        bound_ms, bound_by = bound(nbytes(*args, got), ops, "bfloat16")
        log(f"[kernel] stage_chain {name} {shape} Cm={cm} K={k} {dtype_name}"
            f": a grid of {S.grid_blocks(args[0])} resident blocks; work "
            f"items per block of the chain {S.phase_tiles(shape, cm)}; "
            f"bit-equal to {k} launches with K = 1 {exact}, to a repeat "
            f"launch {repeat}; rows independent {rows}; max_abs_err per "
            f"clip vs the float64 rounded "
            f"plain version {[round(e, 5) for e in errs]} (limits "
            f"{[round(v, 5) for v in limits]}; the float32 rounded plain "
            f"version's {[round(e, 5) for e in plain_errs]}; max|ref| "
            f"{span:.4g}), vs the unrounded plain version "
            f"{[round(e, 4) for e in unrounded_errs]} of max|ref|; kernel "
            f"{ms:.4f} ms (the device alone {device_ms:.4f} ms, "
            f"{ops / device_ms / 1e9:.2f} TFLOP/s, "
            f"{bound_ms / device_ms:.3f} of the bound), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not (exact and repeat and rows and finite and all(
                e <= v for e, v in zip(errs, limits))):
            raise AssertionError(f"stage_chain {name}: the kernel disagrees "
                                 f"with its one-block launches ({exact}), a "
                                 f"repeat ({repeat}) or the plain version "
                                 f"({errs} vs {limits}), or rows depend on "
                                 f"each other ({rows})")
        results[name] = {"max_abs_err": max(errs), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None, "k": k,
                         "device_ms": device_ms}
    return results


def pool_channels_mid(y):
    """1x3x3 / (1,2,2) / pad (0,1,1) max-pool of a (B,T,64,Hc,Wc) tensor,
    channels-last out (B,T,Hp,Wp,64), as stem_forward lays it out."""
    import torch.nn.functional as F

    b, t = y.shape[:2]
    p = F.max_pool2d(y.flatten(0, 1), 3, 2, 1)
    return p.unflatten(0, (b, t)).permute(0, 1, 3, 4, 2).contiguous()


def phase_stem_conv_kernel(torch, stem) -> tuple[dict, int]:
    """The unpooled stem kernel (stem_conv_bn_relu) against
    stem_conv_reference (STEM_CONV_CASES) and a repeat launch; in bf16 with
    the ReLU, max-pooled, bit for bit against the pooled kernel (its
    partner: one GEMM body and epilogue); with the times of the kernel, the
    plain version and ``F.conv3d`` alone (the conv only: no single PyTorch
    call adds the affine and the ReLU) and its bound. No model path runs
    this kernel: returns its launches in the checks."""
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    stem.CONV_LAUNCHES = 0
    results, inputs = {}, {}
    rng = np.random.default_rng(8)
    for name, (shape, dtype_name, relu) in STEM_CONV_CASES.items():
        dtype = getattr(torch, dtype_name)
        x = _dev(torch, rng.normal(size=shape), dtype)
        w = _dev(torch, rng.normal(size=stem.W_SHAPE) * 0.05, dtype)
        scale = _dev(torch, rng.uniform(0.5, 2.0, 64), torch.float32)
        bias = _dev(torch, rng.normal(size=64), torch.float32)
        inputs[name] = x, w, scale, bias
        got = stem.stem_conv_bn_relu(x, w, scale, bias, relu)
        again = stem.stem_conv_bn_relu(x, w, scale, bias, relu)
        partner = None
        if dtype_name == "bfloat16" and relu:
            partner = torch.equal(pool_channels_mid(got),
                                  stem.stem_forward(x, w, scale, bias))
        torch.cuda.synchronize()
        bits = torch.equal(got, again)
        ref = stem.stem_conv_reference(x, w, scale, bias, relu)
        b, t, h, wd, _ = shape
        if got.shape != ref.shape or got.shape != (
                b, t, 64, (h + 1) // 2, (wd + 1) // 2) or got.dtype != dtype:
            raise AssertionError(f"stem_conv {name}: {tuple(got.shape)} "
                                 f"{got.dtype}, want {tuple(ref.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        span = ref.float().abs().max().item()
        results[name] = {"max_abs_err": err, "span": span,
                         "repeat_bit_equal": bits,
                         "pooled_bit_equal_to_stem_pool": partner}
        tol = STEM_CONV_TOL[dtype_name]
        if not (err <= tol * span and bits and partner is not False):
            raise AssertionError(f"stem_conv {name}: kernel disagrees with "
                                 f"plain ({err} > {tol} * {span}), repeats "
                                 f"differ ({bits}) or its pool differs from "
                                 f"the pooled kernel ({partner})")
    launches = stem.CONV_LAUNCHES
    for name, (shape, dtype_name, relu) in STEM_CONV_CASES.items():
        x, w, scale, bias = inputs[name]
        x_cf = x.permute(0, 4, 1, 2, 3).contiguous()
        w_cf = w.permute(4, 3, 0, 1, 2).contiguous()
        ms = time_ms(torch, lambda: stem.stem_conv_bn_relu(x, w, scale, bias,
                                                           relu))
        device_ms = time_ms(torch, lambda: stem.stem_conv_bn_relu(
            x, w, scale, bias, relu), queued=True)
        plain_ms = time_ms(torch, lambda: stem.stem_conv_reference(
            x, w, scale, bias, relu))
        library_ms = time_ms(torch, lambda: F.conv3d(
            x_cf, w_cf, stride=(1, 2, 2), padding=(1, 3, 3)))
        b, t, h, wd, _ = shape
        out_elems = b * t * 64 * ((h + 1) // 2) * ((wd + 1) // 2)
        ops = 2 * out_elems * 441
        bound_ms, bound_by = bound(
            nbytes(x, w, scale, bias) + out_elems * x.element_size(), ops,
            dtype_name)
        res = results[name]
        tol = STEM_CONV_TOL[dtype_name]
        log(f"[kernel] stem_conv {name} {shape} {dtype_name} relu {relu}: "
            f"max_abs_err {res['max_abs_err']:.6g} (rel to max|ref| "
            f"{res['max_abs_err'] / res['span']:.3g}, tol {tol:.3g}); "
            f"repeat bit-equal {res['repeat_bit_equal']}; max-pooled "
            f"bit-equal to stem_pool "
            f"{res['pooled_bit_equal_to_stem_pool']}; kernel {ms:.4f} ms "
            f"(the device alone {device_ms:.4f} ms, "
            f"{ops / device_ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"F.conv3d (conv only) {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        res.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms,
                   device_ms=device_ms)
    return results, launches


def _assign_inputs(torch, shape, kind: str, seed: int = 0):
    """cost (N, Q, M) float32 and valid (N, M) on the card: the valid
    counts 0, 1, a part, min(Q, M) and M among the problems, the rest
    random; ``tied`` costs are small integers, ``nonfinite`` ones hold a
    NaN row, a +inf row, a -inf row and a NaN entry."""
    n, q, m = shape
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, m + 1, n)
    counts[:5] = [0, 1, m // 2, min(q, m), m]
    valid = np.zeros((n, m), bool)
    for i, k in enumerate(counts):
        valid[i, rng.permutation(m)[:k]] = True
    cost = (rng.integers(0, 3, (n, q, m)) if kind == "tied"
            else rng.normal(size=(n, q, m))).astype(np.float32)
    if kind == "nonfinite":
        cost[1, 0], cost[2, q - 1], cost[3, 1] = np.nan, np.inf, -np.inf
        cost[4, 0, 0] = np.nan
    return (torch.from_numpy(cost).cuda(), torch.from_numpy(valid).cuda())


def _host_match(torch, cost, valid):
    """The port's former ``match``: the costs copied to the host in float64,
    scipy's linear_sum_assignment on each problem's valid columns, the
    result uploaded (the library time of the assignment kernel)."""
    from scipy.optimize import linear_sum_assignment

    n, q, m = cost.shape
    cost_h = np.nan_to_num(cost.detach().to("cpu", torch.float64).numpy(),
                           nan=1e6, posinf=1e6, neginf=-1e6)
    valid_h = valid.cpu().numpy()
    tfq = np.full((n, q), -1, np.int64)
    qft = np.full((n, m), -1, np.int64)
    for i in range(n):
        cols = np.flatnonzero(valid_h[i])
        rows, sel = linear_sum_assignment(cost_h[i][:, cols])
        tfq[i, rows] = cols[sel]
        qft[i, cols[sel]] = rows
    return (torch.from_numpy(tfq).to(cost.device),
            torch.from_numpy(qft).to(cost.device))


def phase_assign_kernel(torch) -> dict:
    """The matcher's assignment kernel (csrc/assign.cu) against its plain
    version on the card at the path's four problem shapes, on random,
    integer-tied and non-finite costs: the assignments identical on
    continuous costs and of equal total cost on tied ones (the largest
    difference of a problem's total is ``max_abs_err``), a repeat launch
    bit-equal; the times of the kernel, of the plain version and of the
    port's former host solve (``library_ms``), and the bound: the costs
    and masks read once and both outputs written once."""
    from tubelet_transformer_tpu_torch.ops.cuda import assign

    def total(cost, tfq):
        host = assign.sanitize(cost).double()
        picked = host.gather(2, tfq.clamp(min=0)[..., None])[..., 0]
        return torch.where(tfq >= 0, picked, 0.0).sum(1)

    out = {}
    for name, shape in ASSIGN_CASES.items():
        err, same = 0.0, {}
        for kind in ASSIGN_KINDS:
            cost, valid = _assign_inputs(torch, shape, kind)
            got = assign.assign(cost, valid)
            again = assign.assign(cost, valid)
            want = assign.assign_reference(cost, valid)
            torch.cuda.synchronize()
            same[kind] = all(torch.equal(a, b) for a, b in zip(got, want))
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            diff = (total(cost, got[0]) - total(cost, want[0])).abs().max()
            err = max(err, float(diff))
            if not repeat or float(diff) != 0.0 or (
                    kind != "tied" and not same[kind]):
                raise AssertionError(f"assign {name} {kind}: identical "
                                     f"{same[kind]}, repeat {repeat}, total "
                                     f"cost off by {float(diff)}")
        cost, valid = _assign_inputs(torch, shape, "random")
        n, q, m = shape
        # the two int64 outputs written once
        bound_ms, bound_by = bound(nbytes(cost, valid) + 8 * n * (q + m), 0,
                                   "float32")
        out[name] = {
            "shape": list(shape), "max_abs_err": err,
            "identical": same,
            "ms": time_ms(torch, lambda: assign.assign(cost, valid)),
            "device_ms": time_ms(torch, lambda: assign.assign(cost, valid),
                                 queued=True),
            "plain_ms": time_ms(torch, lambda: assign.assign_reference(
                cost, valid), warmup=1, runs=5, calls=1),
            "library_ms": time_ms(torch, lambda: _host_match(
                torch, cost, valid), runs=5),
            "bound_ms": bound_ms, "bound_by": bound_by}
        times = {k: out[name][k] for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"[assign] {name} {shape}: identical to the plain version "
            f"{same}, total cost difference {err}, repeat bit-equal; "
            f"{times}")
    return out


def small_config():
    from tubelet_transformer_tpu_torch.config import Config

    cfg = Config()
    cfg.data.num_classes = 5
    cfg.data.img_size = 64
    cfg.data.temp_len = 8
    cfg.model.backbone_name = "CSN-TINY"
    cfg.model.query_num = 5
    cfg.model.temp_len = 8
    cfg.model.enc_layers = 1
    cfg.model.dec_layers = 2
    cfg.model.d_model = 64
    cfg.model.nhead = 4
    cfg.model.dim_feedforward = 64
    cfg.model.compute_dtype = "float32"
    return cfg


def phase_small_reference(torch, stem, tag: str = "small",
                          edit=None) -> None:
    """CSN-TINY float32 on the card against the CPU port (TF32 off), the
    config changed by ``edit``: the heads, and the MoE loss where the
    model has one."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = small_config()
    if edit is not None:
        edit(cfg)
    cpu_model = build_model(cfg, device="cpu", seed=1)
    gpu_model = build_model(cfg, device="cuda", seed=1)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 8, 64, 64, 3)).astype(np.float32))
    pad = torch.zeros((1, 64, 64), dtype=torch.bool)
    pad[:, 48:] = True
    launches = stem.LAUNCHES
    with torch.inference_mode():
        ref = cpu_model(x, pad)
        got = gpu_model(x.cuda(), pad.cuda())
    if stem.LAUNCHES != launches + 1:
        raise AssertionError(f"{tag} model on the card did not run the "
                             "stem kernel")
    if set(got) != set(ref):
        raise AssertionError(f"{tag}: outputs {sorted(got)} on the card, "
                             f"{sorted(ref)} on the CPU")
    for k in ("pred_logits", "pred_boxes", "pred_logits_b", "moe_aux"):
        if k not in ref:
            continue
        err = (got[k].cpu() - ref[k]).abs().max().item()
        log(f"[{tag}] CSN-TINY f32 card vs CPU {k}: max_abs_err {err:.3g} "
            f"(tol {SMALL_TOL})")
        if not err <= SMALL_TOL:
            raise AssertionError(f"{tag} model {k}: card and CPU disagree")


def launch_counts() -> dict:
    """Launches of each kernel of the port in this process, by name."""
    from tubelet_transformer_tpu_torch.ops.cuda import (assign, bottleneck,
                                                        depthwise, stage,
                                                        stem)

    return {"stem_pool": stem.LAUNCHES, "stem_stats": stem.STATS_LAUNCHES,
            "stem_conv": stem.CONV_LAUNCHES, "depthwise": depthwise.LAUNCHES,
            "bottleneck": bottleneck.LAUNCHES, "chain": stage.LAUNCHES,
            "assign": assign.LAUNCHES}


def zero_counts() -> None:
    from tubelet_transformer_tpu_torch.ops.cuda import (assign, bottleneck,
                                                        depthwise, stage,
                                                        stem)

    stem.LAUNCHES = stem.STATS_LAUNCHES = stem.CONV_LAUNCHES = 0
    depthwise.LAUNCHES = bottleneck.LAUNCHES = stage.LAUNCHES = 0
    assign.LAUNCHES = 0


def without_sync(torch, fn, *args):
    """``fn(*args)`` under ``torch.cuda.set_sync_debug_mode("error")``: a
    call that makes the host wait for the card (a device tensor read on
    the host, a blocking copy) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def write_config(name: str, edit, source: Path = FLAGSHIP_CONFIG) -> Path:
    """The YAML ``source`` (the flagship's by default) with ``edit``
    applied to its CONFIG tree, written to build/<name>."""
    import yaml

    with open(source) as f:
        tree = yaml.safe_load(f)
    edit(tree["CONFIG"])
    BUILD_DIR.mkdir(exist_ok=True)
    path = BUILD_DIR / name
    with open(path, "w") as f:
        yaml.safe_dump(tree, f)
    return path


def phase_main_path(torch, cfg_path: Path, tag: str, per_keyframe: dict):
    """The streaming detector of ``cfg_path`` on synthetic frames; each
    keyframe must launch each kernel of ``per_keyframe`` that many times
    (every other kernel none). Returns the detector, the launches and the
    steady median latency."""
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.serving import StreamingDetector

    cfg = load_config(str(cfg_path))
    t0 = time.perf_counter()
    # actor_threshold -1 admits every query, so every output is checked
    det = StreamingDetector(cfg, fps=8.0, detect_every=8, rng_seed=0,
                            actor_threshold=-1.0, device="cuda")
    log(f"[{tag}] {cfg_path.name}: {cfg.model.backbone_name} "
        f"{cfg.data.img_size}px T={cfg.data.temp_len} d={cfg.model.d_model} "
        f"{cfg.model.enc_layers}+{cfg.model.dec_layers} "
        f"{cfg.model.temporal_ds_strategy} {cfg.model.compute_dtype}, "
        f"PALLAS_KERNELS {cfg.model.pallas_kernels}, FUSED_BLOCKS "
        f"{cfg.model.fused_blocks}, FUSED_STAGES {cfg.model.fused_stages}: "
        f"built with random weights in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
              for _ in range(FRAMES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    results = [r for f in frames if (r := det.push_frame(f)) is not None]
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_q, n_cls = cfg.model.query_num, cfg.data.num_classes
    if len(results) < 3:
        raise AssertionError(f"{len(results)} keyframe detections, want >= 3")
    for r in results:
        if len(r.detections) != n_q:
            raise AssertionError(f"{len(r.detections)} detections, want {n_q}")
        for d in r.detections:
            if d.box.shape != (4,) or d.scores.shape != (n_cls,):
                raise AssertionError("detection of the wrong shape")
            if not (np.isfinite(d.box).all() and np.isfinite(d.scores).all()
                    and np.isfinite(d.actor_prob)):
                raise AssertionError("non-finite detection output")
    want = {k: per_keyframe.get(k, 0) * len(results) for k in launches}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} for "
                             f"{len(results)} detections, want {want}")
    lat = [r.latency_ms for r in results]
    log(f"[{tag}] keyframes {[r.frame_index for r in results]}; kernel "
        f"launches {launches}; latency ms per keyframe "
        f"{[round(v, 3) for v in lat]}; steady (excluding the first) mean "
        f"{statistics.mean(lat[1:]):.3f} median "
        f"{statistics.median(lat[1:]):.3f}; peak device memory "
        f"{peak_gb:.2f} GB")
    return det, launches, statistics.median(lat[1:])


def stem_switch(model):
    def switch(on: bool) -> None:
        model.backbone.body.stem_kernel = on
    return switch


def backbone_kernels_switch(model):
    """Turns the depthwise kernel (MODEL.PALLAS_KERNELS) and the fused
    bottleneck (MODEL.FUSED_BLOCKS) of ``model`` on or off."""
    from tubelet_transformer_tpu_torch.models.csn import (CSNBottleneck,
                                                          DepthwiseConv3d)

    def switch(on: bool) -> None:
        for m in model.modules():
            if isinstance(m, DepthwiseConv3d):
                m.use_pallas = on
            elif isinstance(m, CSNBottleneck):
                m.fused_blocks = on
    return switch


def chain_totals(chains: dict, suffix: str = "") -> dict:
    """The chain's numbers for one flagship forward: the times and bounds of
    its three tails added (one launch each, in turn), the largest error, the
    bound's kind of the largest bound; ``suffix`` "_b8" for the pool's
    bucket of 8 clips."""
    tails = [chains[f"{k}_256px{suffix}"] for k in FLAGSHIP_TAILS]
    return {"max_abs_err": max(c["max_abs_err"] for c in tails),
            **{k: sum(c[k] for c in tails) for k in ("ms", "plain_ms",
                                                     "bound_ms",
                                                     "device_ms")},
            "bound_by": max(tails, key=lambda c: c["bound_ms"])["bound_by"],
            "library_ms": None}


def spatial_chain_cases(chains: dict, measured: list) -> dict:
    """The chain's cases under MESH.SPATIAL at MODEL 2 (SPATIAL_TAILS),
    each with its own measured numbers and the launches a rank makes of
    it in one forward by the table; the table's launches must add up to
    the chain launches each rank made in this run's spatial eval forward
    (``measured``)."""
    table = sum(n for *_, n in SPATIAL_TAILS.values())
    if any(m != table for m in measured):
        raise AssertionError(f"spatial chains: the ranks launched "
                             f"{measured} a forward, SPATIAL_TAILS {table}")
    return {k: {**chains[f"{k}_spatial2"], "table_launches_per_forward": n}
            for k, (*_, n) in SPATIAL_TAILS.items()}


def stages_switch(model):
    """Turns the stage chains (MODEL.FUSED_STAGES) of ``model`` on or
    off."""
    def switch(on: bool) -> None:
        model.backbone.body.fused_stages = on
    return switch


def flagship_chains() -> int:
    """Chain launches per flagship forward: each identity tail that
    chain_supported takes, in chains of at most max_chain blocks."""
    from tubelet_transformer_tpu_torch.ops.cuda import stage as S

    return sum(-(-tail // S.max_chain(shape[2] * shape[3], shape[4], cm))
               for shape, cm, tail in FLAGSHIP_TAILS.values()
               if S.chain_supported(shape, cm))


def spatial_slabs(height: int, width: int, frames: int, model: int,
                  last_stride: bool = False,
                  blocks: tuple = (3, 8, 36, 3)) -> list:
    """Each model peer's chain launches in a CSN-152 stage-path eval
    forward of one clip with its rows split over ``model`` peers
    (MESH.SPATIAL), as ``CSN.stage`` cuts them: every identity tail that
    chain_supported takes (on the clip's full height) in chains of at most
    the shortest non-empty band's rows, each on the peer's slab of its
    rows and k rows on each side, cut at the clip's border; per peer a
    list of (stage, slab shape, C_mid, k), none for an empty band."""
    from tubelet_transformer_tpu_torch.models.csn import (
        spatial_rows, stage_stride)
    from tubelet_transformer_tpu_torch.ops.cuda import stage as S
    from tubelet_transformer_tpu_torch.ops.cuda.stem import pooled_hw

    bands = spatial_rows(height, blocks, last_stride, model)
    w, t = pooled_hw(height, width)[1], frames
    out: list = [[] for _ in range(model)]
    for s, n in enumerate(blocks):
        w = -(-w // stage_stride(s, last_stride))
        t = t if s == 0 else -(-t // 2)
        b, cm = bands[3 + s], (64, 128, 256, 512)[s]
        full = (1, t, b.height, w, 4 * cm)
        if n < 2 or not S.chain_supported(full, cm):
            continue
        kmax = min(S.max_chain(b.height * w, 4 * cm, cm),
                   min(h for _, h in b.rows if h))
        ks = [kmax] * ((n - 1) // kmax) + [(n - 1) % kmax] * bool(
            (n - 1) % kmax)
        for i, (a, h) in enumerate(b.rows):
            out[i] += [(f"layer{s + 1}", (1, t, min(b.height, a + h + k)
                                          - max(0, a - k), w, 4 * cm), cm, k)
                       for k in ks if h]
    return out


def spatial_chains(model: int) -> int:
    """Chain launches per flagship forward on each rank with the clip's
    rows split over ``model`` peers (MESH.SPATIAL; ``spatial_slabs``)."""
    return len(spatial_slabs(256, 256, 32, model)[0])


def jhmdb_spatial_chain_cases(chains: dict, measured: list) -> dict:
    """The chain's cases under MESH.SPATIAL at MODEL 4 on JHMDB's recipe
    (JHMDB_SPATIAL_TAILS), each with its own measured numbers, the
    launches of its shape over the ranks in one forward and the peers that
    launch it; the table must be the port's cut (``spatial_slabs``), and
    its launches each rank's measured count in this run's JHMDB spatial
    eval forward (``measured``)."""
    slabs = spatial_slabs(**JHMDB_SPATIAL)
    cut: dict = {}
    for peer, launches in enumerate(slabs):
        for stage, shape, cm, k in launches:
            key = f"{stage}_r{shape[2]}_k{k}"
            cut.setdefault(key, [shape, cm, k, 0, ()])
            cut[key][3] += 1
            if peer not in cut[key][4]:
                cut[key][4] += (peer,)
    cut = {k: (tuple(v[0]), *v[1:]) for k, v in cut.items()}
    if cut != JHMDB_SPATIAL_TAILS:
        raise AssertionError(f"JHMDB_SPATIAL_TAILS is not the port's cut "
                             f"{cut}")
    if any(m != len(slabs[i]) for i, m in enumerate(measured)):
        raise AssertionError(f"JHMDB spatial chains: the ranks launched "
                             f"{measured} a forward, the table "
                             f"{[len(x) for x in slabs]}")
    return {k: {**chains[f"{k}_jhmdb4"], "launches_per_forward": n,
                "peers": list(peers)}
            for k, (_, _, _, n, peers) in JHMDB_SPATIAL_TAILS.items()}


def phase_in_situ(torch, det, switch, what: str) -> None:
    """One flagship clip through the detector's model with the kernels that
    ``switch`` turns on, and off."""
    from tubelet_transformer_tpu_torch.data.device_preprocess import (
        device_preprocess)

    model = det.model
    rng = np.random.default_rng(2)
    clip = torch.from_numpy(rng.integers(
        0, 256, (1, 32, 256, 256, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        x = device_preprocess(clip, dtype=model.dtype)
        on = model(x)
        switch(False)
        try:
            off = model(x)
        finally:
            switch(True)
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        diff = (on[k] - off[k]).abs().max().item()
        span = max(1.0, off[k].abs().max().item())
        log(f"[in situ] flagship {what} on vs off {k}: max_abs_diff "
            f"{diff:.4g} (max|off| {off[k].abs().max().item():.4g}, tol "
            f"{IN_SITU_TOL} x {span:.4g})")
        if not (torch.isfinite(on[k]).all() and diff <= IN_SITU_TOL * span):
            raise AssertionError(f"in situ {k}: kernel-on and kernel-off "
                                 "model outputs disagree")


def _report_device_time(torch, prof, tag: str, what: str, wall_ms: float,
                        kernels, top: int = 10, ops=()) -> None:
    """Device time of a profiled window: the total, the top aten ops by
    self device time, the aten ops named in ``ops`` wherever they rank, and
    the named hand-written kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    total = sum(ev.device_time_total for ev in prof.events()
                if ev.device_type == cuda) / 1e3
    if not total:
        log(f"[{tag}] the profiler saw no device time: not measured")
        return
    # device time of the kernels each aten op launched itself; kernels
    # launched outside aten (the ctypes stem kernels) are listed by name
    ops_ms = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
              for ev in prof.key_averages()
              if ev.device_type != cuda and ev.self_device_time_total > 0]
    attributed = sum(ms for _, ms, _ in ops_ms)
    launches = sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == cuda)
    log(f"[{tag}] {what}: device kernel time {total:.3f} ms "
        f"({100 * total / wall_ms:.1f}% of {wall_ms:.2f} ms) in {launches} "
        f"kernel launches; by aten op (self device time):")
    ranked = sorted(ops_ms, key=lambda o: -o[1])
    for name, ms, count in ranked[:top] + [o for o in ranked[top:]
                                           if o[0] in ops]:
        log(f"[{tag}]   {ms:8.3f} ms {100 * ms / total:5.1f}%  "
            f"{name} x{count}")
    for ev in prof.key_averages():
        if ev.device_type == cuda and any(k in ev.key for k in kernels):
            log(f"[{tag}]   {ev.device_time_total / 1e3:8.3f} ms "
                f"{100 * ev.device_time_total / 1e3 / total:5.1f}%  "
                f"{ev.key[:60]} x{ev.count}")
    log(f"[{tag}] device time outside aten ops: {total - attributed:.3f} ms")


def phase_switch_latency(torch, det, switch, what: str,
                         pairs: int = 10) -> None:
    """Host wall time of one flagship forward (ending in a sync) with the
    kernels that ``switch`` turns on, and off, in alternating order in one
    process: what the switch does to the latency, apart from the spread
    between processes."""
    from tubelet_transformer_tpu_torch.data.device_preprocess import (
        device_preprocess)

    model = det.model
    clip = torch.zeros((1, 32, 256, 256, 3), dtype=torch.uint8, device="cuda")
    times = {True: [], False: []}
    with torch.inference_mode():
        x = device_preprocess(clip, dtype=model.dtype)
        try:
            for i in range(2 * pairs + 2):
                on = (i % 4) in (0, 3)        # on, off, off, on, ...
                switch(on)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                if i >= 2:                    # the first pair warms up
                    times[on].append((time.perf_counter() - t0) * 1e3)
        finally:
            switch(True)
    log(f"[switch latency] flagship forward, {what} on vs off, {pairs} "
        f"alternating pairs: median {statistics.median(times[True]):.3f} vs "
        f"{statistics.median(times[False]):.3f} ms (on: min "
        f"{min(times[True]):.3f} max {max(times[True]):.3f}; off: min "
        f"{min(times[False]):.3f} max {max(times[False]):.3f})")


def phase_breakdown(torch, det, steady_ms: float, tag: str,
                    kernels, batch: int = 1, what: str = "one flagship "
                    "forward (against the steady keyframe latency)") -> None:
    """Where the device time of one flagship forward of ``batch`` clips
    goes (torch.profiler), against ``steady_ms`` of the host's clock."""
    from torch.profiler import ProfilerActivity, profile

    from tubelet_transformer_tpu_torch.data.device_preprocess import (
        device_preprocess)

    model = det.model
    clip = torch.zeros((batch, 32, 256, 256, 3), dtype=torch.uint8,
                       device="cuda")
    with torch.inference_mode():
        x = device_preprocess(clip, dtype=model.dtype)
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    _report_device_time(torch, prof, tag, what, steady_ms, kernels)


def phase_serve_cli(cfg_path: Path) -> None:
    """The serving CLI through ``cfg_path`` on 88 synthetic frames at 8 fps
    (4 keyframes), in its own process."""
    import os

    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "tubelet_transformer_tpu_torch.cli.serve",
         "--config-file", str(cfg_path), "--num-frames", str(FRAMES),
         "--fps", "8"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT)})
    if res.returncode != 0:
        raise AssertionError(f"serve CLI exited {res.returncode}:\n"
                             f"{res.stderr[-3000:]}")
    lines = [json.loads(line) for line in res.stdout.splitlines()
             if line.startswith("{")]
    keyframes = [d for d in lines if "keyframe" in d]
    summary = lines[-1].get("summary", {})
    if len(keyframes) < 3 or summary.get("keyframes") != len(keyframes):
        raise AssertionError(f"serve CLI: {len(keyframes)} keyframes, "
                             f"summary {summary}")
    log(f"[serve cli] {cfg_path.name}: keyframes "
        f"{[d['keyframe'] for d in keyframes]}, latency ms "
        f"{[d['latency_ms'] for d in keyframes]}; summary {summary}; "
        f"process wall {time.perf_counter() - t0:.1f} s")


def _train_batch(torch, cfg, uint8_seed: int | None = None) -> dict:
    """The first batch of the train loader of ``cfg`` on the card; with
    ``uint8_seed`` its clips are replaced by random raw pixels, as the AVA
    loader ships them."""
    from tubelet_transformer_tpu_torch.cli import runner
    from tubelet_transformer_tpu_torch.train import engine

    batches = iter(runner.make_loaders(cfg)[0])
    batch = next(batches)
    batches.close()
    if uint8_seed is not None:
        batch["clips"] = np.random.default_rng(uint8_seed).integers(
            0, 256, batch["clips"].shape, dtype=np.uint8)
    return engine.device_batch(batch, torch.device("cuda"))


def _no_dropout(model) -> dict:
    from tubelet_transformer_tpu_torch.models.layers import Dropout

    rates = {}
    for m in model.modules():
        if isinstance(m, Dropout):
            rates[m] = m.p
            m.p = 0.0
    return rates


def phase_small_train_reference(torch, stem) -> None:
    """One CSN-TINY train step (TUNE_POINT 4, dropout off) on the card
    against the same step on the CPU, float32 with TF32 off: the losses,
    the gradient norm and the BN running statistics."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = small_config()
    cfg.model.pretrained = True
    rng = np.random.default_rng(3)
    host = {"clips": rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32),
            "pad_mask": np.zeros((2, 64, 64), bool),
            "boxes": np.concatenate([rng.uniform(0.3, 0.7, (2, 4, 2)),
                                     rng.uniform(0.1, 0.3, (2, 4, 2))],
                                    -1).astype(np.float32),
            "labels": (rng.uniform(size=(2, 4, 5)) < 0.3).astype(np.float32),
            "valid": np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool),
            "sizes": np.full((2, 2), 64, np.float32)}
    results = []
    for device in ("cpu", "cuda"):
        model = build_model(cfg, device=device, seed=1, train=True)
        _no_dropout(model)
        state = engine.create_train_state(cfg, model, steps_per_epoch=10)
        launches = stem.LAUNCHES, stem.STATS_LAUNCHES
        metrics = engine.make_train_step(cfg, state)(
            engine.device_batch(host, torch.device(device)),
            cfg.loss.dice_cof)
        if device == "cuda" and (stem.LAUNCHES, stem.STATS_LAUNCHES) != (
                launches[0] + 1, launches[1] + 1):
            raise AssertionError("the small train step on the card did not "
                                 "run both stem kernels once")
        results.append((metrics, {
            n: b.cpu() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}))
    (m_cpu, bn_cpu), (m_gpu, bn_gpu) = results
    loss_err = max(abs(float(m_gpu[k]) - float(m_cpu[k])) /
                   max(1.0, abs(float(m_cpu[k]))) for k in m_cpu)
    bn_err = max((bn_gpu[k] - v).abs().max().item()
                 for k, v in bn_cpu.items())
    log(f"[small train] CSN-TINY f32 train step card vs CPU: max loss/metric "
        f"error {loss_err:.3g} (relative above 1), max BN running-stat error "
        f"{bn_err:.3g} (tol {SMALL_TOL})")
    if not (loss_err <= SMALL_TOL and bn_err <= SMALL_TOL):
        raise AssertionError("small train step: card and CPU disagree")


def phase_train_path(torch, stem, weights: dict) -> dict:
    """The flagship fine-tune recipe through the train_ava entry point,
    on the synthetic set, with PRETRAINED and LOAD_DETR pointed at the
    smoke's ``.mat`` and ``detr.pth`` (``weights``); returns the config, the
    run's checkpoint and the measurements."""
    from tubelet_transformer_tpu_torch.cli import train_ava
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import engine
    from tubelet_transformer_tpu_torch.train.optimizer import param_label

    base = BUILD_DIR / "chip_smoke_runs"

    def edit(c):
        c["DATA"].update(DATASET_NAME="synthetic", SYNTHETIC_SIZE=8,
                         LABEL_PATH="")
        c["TRAIN"]["EPOCH_NUM"] = 1
        c["MODEL"].update(PRETRAINED=True,
                          PRETRAIN_BACKBONE_DIR=str(weights["mat"]),
                          LOAD_DETR=True,
                          PRETRAIN_TRANSFORMER_DIR=str(weights["detr"]))
        c["LOG"]["BASE_PATH"] = str(base)

    cfg_path = write_config("chip_smoke_train.yaml", edit)
    cfg = load_config(str(cfg_path))

    # per-step wall time (each step ends in a host sync); one steady step
    # under sync debug mode "error"
    steps = []
    make_train_step = engine.make_train_step

    def timed_make(cfg_, state, **kw):
        step = make_train_step(cfg_, state, **kw)

        def timed(batch, weight):
            t0 = time.perf_counter()
            metrics = (without_sync(torch, step, batch, weight)
                       if len(steps) == NO_SYNC_STEP else step(batch, weight))
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t0) * 1e3,
                          float(metrics["total_loss"]),
                          float(metrics["finite"])))
            return metrics

        return timed

    engine.make_train_step = timed_make
    argv = sys.argv
    sys.argv = ["train_ava", "--config-file", str(cfg_path), "--device",
                "cuda", "--seed", "0"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    try:
        train_ava.main()
    finally:
        sys.argv = argv
        engine.make_train_step = make_train_step
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if len(steps) != TRAIN_STEPS or not all(
            fin == 1.0 and np.isfinite(loss) for _, loss, fin in steps):
        raise AssertionError(f"train steps {steps}: want {TRAIN_STEPS} "
                             "finite ones")
    if launches != {"stem_pool": TRAIN_STEPS + VAL_FORWARDS,
                    "stem_stats": TRAIN_STEPS, "stem_conv": 0,
                    "depthwise": 0, "bottleneck": 0, "chain": 0,
                    "assign": TRAIN_STEPS + VAL_FORWARDS}:
        raise AssertionError(f"kernel launches {launches}, want "
                             f"{TRAIN_STEPS + VAL_FORWARDS} pooled, "
                             f"{TRAIN_STEPS} statistics and "
                             f"{TRAIN_STEPS + VAL_FORWARDS} assignments")
    run = max(glob.glob(str(base / f"{cfg.log.exp_name}_*")),
              key=lambda d: Path(d).stat().st_mtime)
    ckpt = Path(run) / cfg.log.save_dir / "ckpt_epoch_0"
    with open(Path(run) / cfg.log.log_dir / "metrics.jsonl") as f:
        tags = {json.loads(line)["tag"]: json.loads(line)["value"]
                for line in f}
    if "val/val_mAP_epoch" not in tags or not ckpt.exists():
        raise AssertionError(f"no validation mAP or no checkpoint in {run}")
    final = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    start = build_model(cfg, device="cpu", seed=0, train=True,
                        pretrained=True).state_dict()
    # the run started from the .mat backbone and the DETR seed
    seeded = [n for n in weights["sd"] if n.startswith(
        ("backbone.body.", "transformer.", "bbox_embed."))
        and not n.endswith("num_batches_tracked")]
    if not all(torch.equal(start[n], weights["sd"][n]) for n in seeded):
        raise AssertionError("the train run's start is not the .mat "
                             "backbone and the DETR seed")
    frozen_moved, trained_still, frozen = [], [], 0
    for name, value in start.items():
        if name.endswith("num_batches_tracked"):
            continue
        label = (param_label(name, cfg) if not name.endswith(
            ("running_mean", "running_var")) else "stats")
        same = torch.equal(final[name], value)
        frozen += label == "frozen"
        if label == "frozen" and not same:
            frozen_moved.append(name)
        if label in ("main", "backbone") and same:
            trained_still.append(name)
    stem_stats_moved = not torch.equal(final["backbone.body.bn1.running_var"],
                                       start["backbone.body.bn1.running_var"])
    # a weight with an exactly zero gradient (the first decoder layer's
    # query/key projections see a zero target) still moves by weight decay
    # unless its float32 update rounds away; report, do not require
    if frozen_moved or not stem_stats_moved or any(
            n.startswith(("backbone.body.layer3", "backbone.body.layer4",
                          "class_fc", "bbox_embed")) for n in trained_still):
        raise AssertionError(f"freeze check: frozen moved {frozen_moved[:5]},"
                             f" trained unchanged {trained_still[:5]}, stem "
                             f"BN stats moved {stem_stats_moved}")
    step_ms = [ms for ms, _, _ in steps]
    log(f"[train] {cfg.model.backbone_name} {cfg.data.img_size}px "
        f"T={cfg.data.temp_len} bs={cfg.train.batch_size} "
        f"{cfg.model.compute_dtype} TUNE_POINT {cfg.model.tune_point}: "
        f"{len(steps)} steps, losses {[round(l, 4) for _, l, _ in steps]}; "
        f"validation frame mAP {tags['val/val_mAP_epoch']:.4f}; checkpoint "
        f"{ckpt.relative_to(ROOT)}; launches {launches}; the {frozen} frozen "
        f"params bit-equal to the .mat backbone, trained params moved "
        f"({len(trained_still)} unchanged: {trained_still[:3]}), stem BN "
        f"running stats moved")
    log(f"[train] step ms {[round(v, 2) for v in step_ms]}: first "
        f"{step_ms[0]:.2f}, steady median (after the first) "
        f"{statistics.median(step_ms[1:]):.2f}; step {NO_SYNC_STEP} ran "
        f"under sync debug mode \"error\": no host sync; peak device "
        f"memory {peak_gb:.2f} GB; train_ava wall {wall:.1f} s")
    return {"cfg": cfg, "cfg_path": cfg_path, "launches": launches,
            "ckpt": ckpt, "start": start,
            "val_map": tags["val/val_mAP_epoch"],
            "steady_ms": statistics.median(step_ms[1:])}


def phase_train_in_situ(torch, stem, cfg):
    """One flagship train forward (dropout off, one fixed batch) with both
    stem kernels on and off: the stem's batch statistics and the total
    loss. Returns the model (dropout restored)."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import engine

    model = build_model(cfg, device="cuda", seed=0, train=True)
    rates = _no_dropout(model)
    body = model.backbone.body
    batch = _train_batch(torch, cfg)
    seen = []
    affine = body.bn1.batch_affine

    def record(mean, var):
        seen.append((mean.detach().clone(), var.detach().clone()))
        return affine(mean, var)

    body.bn1.batch_affine = record
    totals = []
    launches = stem.LAUNCHES, stem.STATS_LAUNCHES
    try:
        with torch.no_grad():
            for kernel in (True, False):
                body.stem_kernel = kernel
                out = model(batch["clips"].to(model.dtype), batch["pad_mask"])
                losses = engine.compute_losses(
                    cfg, out, engine._targets_from_batch(cfg, batch))
                totals.append(float(engine.weighted_total(
                    cfg, losses, cfg.loss.dice_cof)))
    finally:
        body.stem_kernel = True
        del body.bn1.batch_affine
    if (stem.LAUNCHES, stem.STATS_LAUNCHES) != (launches[0] + 1,
                                                launches[1] + 1):
        raise AssertionError("the kernel-on train forward did not run both "
                             "stem kernels once")
    (m_on, v_on), (m_off, v_off) = seen
    mean_err = (m_on - m_off).abs().max().item()
    var_rel = ((v_on - v_off).abs() / v_off).max().item()
    std = v_off.sqrt().max().item()
    loss_diff = abs(totals[0] - totals[1])
    log(f"[in situ train] stem kernels on vs off: batch mean max diff "
        f"{mean_err:.4g} (rel to max std {mean_err / std:.3g}), batch var max "
        f"rel diff {var_rel:.3g}; total loss {totals[0]:.5f} vs "
        f"{totals[1]:.5f} (diff {loss_diff:.4g}, tol {TRAIN_IN_SITU_TOL} of "
        f"it)")
    if not (mean_err <= STATS_MEAN_TOL["bfloat16"] * std
            and var_rel <= STATS_VAR_TOL["bfloat16"]
            and np.isfinite(totals).all()
            and loss_diff <= TRAIN_IN_SITU_TOL * abs(totals[1])):
        raise AssertionError("in situ train: kernel-on and kernel-off "
                             "forwards disagree")
    for m, p in rates.items():
        m.p = p
    return model


def phase_jitter_and_train_breakdown(torch, stem, cfg, model,
                                     steady_ms: float) -> None:
    """One train step on uint8 clips (the HSV jitter on the card), then
    where the device time of a train step goes (torch.profiler); then a
    step on NaN clips, which must leave the parameters, the BN statistics,
    the AdamW moments and step counts, the update count and the rate bit
    for bit as they were (the guard decided on the card); then the control
    of the steps run under sync debug mode "error"."""
    from torch.profiler import ProfilerActivity, profile

    from tubelet_transformer_tpu_torch.data.device_preprocess import (
        device_preprocess)
    from tubelet_transformer_tpu_torch.train import engine

    state = engine.create_train_state(cfg, model, steps_per_epoch=1)
    step = engine.make_train_step(cfg, state)
    batch = _train_batch(torch, cfg, uint8_seed=7)
    g = torch.Generator(device="cuda").manual_seed(0)
    plain = device_preprocess(batch["clips"], pad_mask=batch["pad_mask"])
    jittered = device_preprocess(batch["clips"], pad_mask=batch["pad_mask"],
                                 jitter=True, generator=g)
    shift = (jittered - plain).abs().amax(dim=(1, 2, 3, 4))
    launches = stem.STATS_LAUNCHES
    metrics = step(batch, cfg.loss.dice_cof)
    torch.cuda.synchronize()
    if not (metrics["finite"] == 1.0 and stem.STATS_LAUNCHES == launches + 1
            and bool((shift > 0).all())):
        raise AssertionError("uint8 train step: not finite, no stats "
                             "kernel, or the jitter left a clip unchanged")
    log(f"[jitter] uint8 train step: total loss "
        f"{float(metrics['total_loss']):.5f}, grad norm "
        f"{float(metrics['grad_norm']):.4g}; jitter moved each clip by up "
        f"to {[round(v, 3) for v in shift.tolist()]} (normalised units)")

    step(batch, cfg.loss.dice_cof)                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch, cfg.loss.dice_cof)
        torch.cuda.synchronize()
    _report_device_time(torch, prof, "train breakdown",
                        f"one flagship train step (steady step "
                        f"{steady_ms:.2f} ms)", steady_ms,
                        ("stem_pool_tc_kernel", "stem_stats_tc_kernel",
                         "stem_stats_finalize_kernel", "assign_kernel"),
                        top=14, ops=BN_STATS_OPS)

    # a non-finite step skips on the card
    def snapshot():
        return ([t.clone() for t in model.state_dict().values()]
                + [t.clone() for st in state.optimizer.state.values()
                   for t in st.values()] + [state.updates.clone()])

    kept = snapshot()
    rates = [np.float32(state.schedule(int(state.updates)) * g["lr_scale"])
             for g in state.optimizer.param_groups]
    bad = dict(batch, clips=torch.full(batch["clips"].shape, float("nan"),
                                       device="cuda"))
    metrics = step(bad, cfg.loss.dice_cof)
    same = [torch.equal(a, b) for a, b in zip(snapshot(), kept)]
    lr = [np.float32(float(g["lr"])) for g in state.optimizer.param_groups]
    log(f"[nan guard] a train step on NaN clips: finite "
        f"{float(metrics['finite'])}; {sum(same)} of {len(same)} tensors "
        f"(parameters, BN statistics, AdamW moments and step counts, the "
        f"update count) bit-equal to before it, the rate {lr} against the "
        f"schedule's {rates} at the unchanged count")
    if not (float(metrics["finite"]) == 0.0 and all(same) and lr == rates):
        raise AssertionError("the NaN guard changed the state")

    # the control of the steps run under sync debug mode "error" (phases 9
    # and 14): the matcher's plain solver, whose loops read the card,
    # raises under the same mode in the same step
    from tubelet_transformer_tpu_torch.ops import matcher
    from tubelet_transformer_tpu_torch.ops.cuda import assign

    matcher.assign = assign.assign_reference
    try:
        without_sync(torch, step, batch, cfg.loss.dice_cof)
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        log(f"[no sync] control: the train step with the plain solver "
            f"raised under sync debug mode \"error\": {str(e)[:70]}")
    else:
        raise AssertionError("no-sync control: the train step with the "
                             "plain solver did not raise under sync debug "
                             "mode \"error\"")
    finally:
        matcher.assign = assign.assign


def phase_train_kernels(torch, cfg) -> dict:
    """One flagship train step with MODEL.PALLAS_KERNELS on: layer1 is
    frozen (TUNE_POINT 4), so its 3 depthwise convs run the kernel under
    no_grad; the loss must be finite."""
    import copy

    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import engine

    cfg = copy.deepcopy(cfg)
    cfg.model.pallas_kernels = True
    model = build_model(cfg, device="cuda", seed=0, train=True)
    step = engine.make_train_step(
        cfg, engine.create_train_state(cfg, model, steps_per_epoch=1))
    batch = _train_batch(torch, cfg)
    zero_counts()
    t0 = time.perf_counter()
    metrics = step(batch, cfg.loss.dice_cof)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    want = {"stem_pool": 1, "stem_stats": 1, "stem_conv": 0, "depthwise": 3,
            "bottleneck": 0, "chain": 0, "assign": 1}
    log(f"[train kernels] flagship train step, PALLAS_KERNELS on, TUNE_POINT "
        f"{cfg.model.tune_point}: total loss "
        f"{float(metrics['total_loss']):.5f}, finite "
        f"{float(metrics['finite'])}; launches {launches}; step "
        f"{wall_ms:.2f} ms (the first of this model)")
    if not (metrics["finite"] == 1.0
            and np.isfinite(float(metrics["total_loss"]))
            and launches == want):
        raise AssertionError(f"train step with PALLAS_KERNELS: launches "
                             f"{launches}, want {want}, or a loss that is "
                             "not finite")
    return launches


def _state_equal(torch, got: dict, want: dict, names) -> list:
    """The names among ``names`` where ``got`` and ``want`` differ in a
    bit (on the CPU)."""
    return [n for n in names if not torch.equal(got[n].cpu(), want[n].cpu())]


def phase_weights(torch) -> dict:
    """Weights in, at flagship size: a Caffe2 ``.mat`` backbone, a COCO DETR
    ``detr.pth`` (100 query rows) and a ``module.``-prefixed TubeR ``.pth``
    written from a seed-1 train build (tools/fixtures.py), each loaded into
    a seed-0 build on the card through train/checkpoint.py; each must bring
    over exactly its tensors, bit for bit, and leave the rest as they
    were."""
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.tools import fixtures
    from tubelet_transformer_tpu_torch.train import checkpoint as ckpt_lib

    cfg = load_config(str(FLAGSHIP_CONFIG))
    out = WEIGHTS_DIR
    out.mkdir(parents=True, exist_ok=True)
    sd1 = {k: v.clone() for k, v in build_model(
        cfg, device="cpu", seed=1, train=True).state_dict().items()}
    names = [k for k in sd1 if not k.endswith("num_batches_tracked")]
    t0 = time.perf_counter()
    paths = {"mat": fixtures.write_csn_mat(str(out / MAT_NAME), sd1,
                                           (3, 8, 36, 3)),
             "detr": fixtures.write_detr_pth(str(out / "detr.pth"), sd1),
             "tuber": fixtures.write_tuber_pth(str(out / "tuber_csn152.pth"),
                                               sd1)}
    log(f"[weights] wrote {', '.join(Path(p).name for p in paths.values())}"
        f" ({', '.join(f'{Path(p).stat().st_size / 2**20:.1f}' for p in paths.values())}"
        f" MiB) in {time.perf_counter() - t0:.1f} s")
    loaders = {"mat": (ckpt_lib.load_backbone_mat, ("backbone.body.",)),
               "detr": (ckpt_lib.seed_from_detr,
                        ("transformer.", "bbox_embed.")),
               "tuber": (ckpt_lib.load_tuber_pth, ("",))}
    detr_q = torch.load(paths["detr"], map_location="cpu",
                        weights_only=True)["model"]["query_embed.weight"]
    load_s = {}
    for kind, (load, prefixes) in loaders.items():
        model = build_model(cfg, device="cuda", seed=0, train=True)
        sd0 = {k: v.cpu().clone() for k, v in model.state_dict().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load(cfg, model, paths[kind])
        torch.cuda.synchronize()
        load_s[kind] = time.perf_counter() - t0
        got = model.state_dict()
        want = dict(sd0)
        moved = [n for n in names if n.startswith(prefixes)]
        want.update({n: sd1[n] for n in moved})
        if kind == "detr":
            want["query_embed.weight"] = detr_q[:cfg.model.query_num]
            moved.append("query_embed.weight")
        bad = _state_equal(torch, got, want, names)
        log(f"[weights] {kind}: {len(moved)} tensors loaded in "
            f"{load_s[kind]:.3f} s; the model's {len(names)} tensors bit-"
            f"equal to the file's (and the seed-0 build's elsewhere): "
            f"{not bad}")
        if bad or not moved:
            raise AssertionError(f"{kind}: {len(bad)} tensors differ, e.g. "
                                 f"{bad[:3]}")
        del model
        torch.cuda.empty_cache()
    return {**paths, "sd": sd1, "load_s": load_s}


def _capture(module, name: str, sink: list):
    """Wrap ``module.name`` so that each call appends its result to
    ``sink``; returns the undo."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        sink.append(out)
        return out

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, fn)


def _run_cli(module, argv: list) -> None:
    """``module.main()`` with ``argv`` as the command line."""
    saved = sys.argv
    sys.argv = [module.__name__, *argv]
    try:
        module.main()
    finally:
        sys.argv = saved


def phase_eval_cli(torch, train: dict) -> dict:
    """The eval CLI on the train phase's checkpoint (MODEL.LOAD with
    PRETRAINED_PATH): the eval build's weights equal the checkpoint's cast
    once to the compute dtype, and a float32 build's equal it bit for bit;
    its frame mAP beside the train run's last validation."""
    from tubelet_transformer_tpu_torch.cli import eval_ava, runner
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    ckpt = train["ckpt"]
    cfg_path = write_config("chip_smoke_eval.yaml", lambda c: c[
        "MODEL"].update(LOAD=True, PRETRAINED_PATH=str(ckpt)),
        source=train["cfg_path"])
    runs: list = []
    undo = _capture(runner, "run_eval", runs)
    zero_counts()
    t0 = time.perf_counter()
    try:
        _run_cli(eval_ava, ["--config-file", str(cfg_path), "--device",
                            "cuda", "--seed", "3"])
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    model = runs[0]["model"]
    got = model.state_dict()
    cast = {n: saved[n].to(got[n].dtype) for n in saved}
    bad = _state_equal(torch, got, cast, saved)
    f32 = build_model(load_config(str(cfg_path)), device="cpu", seed=3,
                      train=True, pretrained=True).state_dict()
    bad32 = _state_equal(torch, f32, saved, saved)
    val_map = runs[0]["val"]["mAP"]
    log(f"[eval cli] eval_ava on {ckpt.relative_to(ROOT)}: frame mAP "
        f"{val_map:.6f} (the train run's last validation "
        f"{train['val_map']:.6f}, difference {val_map - train['val_map']:.3g});"
        f" the eval build's {len(saved)} tensors equal the checkpoint's cast "
        f"to {model.dtype} (BN statistics float32): {not bad}; a float32 "
        f"build's equal it bit for bit: {not bad32}; launches {launches}; "
        f"wall {wall:.1f} s")
    if bad or bad32 or not np.isfinite(val_map) or launches[
            "stem_pool"] != VAL_FORWARDS or launches["assign"] != VAL_FORWARDS:
        raise AssertionError(f"eval CLI: weights differ ({bad[:3]}, "
                             f"{bad32[:3]}), mAP {val_map} or launches "
                             f"{launches}")
    return {"cfg_path": cfg_path, "launches": launches, "map": val_map}


def phase_serve_load(torch, cfg_path: Path, ckpt: Path) -> dict:
    """The serving CLI with MODEL.LOAD on the train phase's checkpoint, in
    this process: its model's weights equal the checkpoint's cast once to
    the compute dtype, and >= 3 keyframes are served."""
    import contextlib
    import io

    from tubelet_transformer_tpu_torch import serving
    from tubelet_transformer_tpu_torch.cli import serve

    made: list = []
    undo = _capture(serving, "StreamingDetector", made)
    buf = io.StringIO()
    zero_counts()
    try:
        with contextlib.redirect_stdout(buf):
            _run_cli(serve, ["--config-file", str(cfg_path), "--num-frames",
                             str(FRAMES), "--fps", "8", "--device", "cuda"])
    finally:
        undo()
    launches = launch_counts()
    lines = [json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    keyframes = [d for d in lines if "keyframe" in d]
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    got = made[0].model.state_dict()
    bad = _state_equal(torch, got, {n: saved[n].to(got[n].dtype)
                                    for n in saved}, saved)
    log(f"[serve load] serve with MODEL.LOAD: keyframes "
        f"{[d['keyframe'] for d in keyframes]}, latency ms "
        f"{[d['latency_ms'] for d in keyframes]}; weights equal the "
        f"checkpoint's (cast once): {not bad}; launches {launches}")
    if bad or len(keyframes) < 3 or launches["stem_pool"] != len(keyframes):
        raise AssertionError(f"serve with MODEL.LOAD: {len(keyframes)} "
                             f"keyframes, weights differ {bad[:3]}")
    return launches


def phase_jhmdb(torch, stem, weights: dict, smi: str) -> dict:
    """The JHMDB recipe at full width through train_jhmdb and eval_jhmdb,
    on an ACT-detector fixture of random 320x240 frames: the loss finite,
    the frozen prefix bit-equal across the steps, frame and video mAP
    finite; #2 and #4 in situ on the path's own stem inputs against their
    plain versions and a repeat launch; the steady train step and the eval
    step (their device breakdowns: phase_jhmdb_breakdown)."""
    import shutil

    from tubelet_transformer_tpu_torch.cli import (eval_jhmdb, runner,
                                                   train_jhmdb)
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.data.device_preprocess import (
        device_preprocess)
    from tubelet_transformer_tpu_torch.models import csn
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.tools import fixtures
    from tubelet_transformer_tpu_torch.train import engine
    from tubelet_transformer_tpu_torch.train.optimizer import param_label

    root = BUILD_DIR / "jhmdb_fixture"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    frames = fixtures.write_jhmdb_set(
        str(root), JHMDB_TRAIN_VIDEOS, JHMDB_TEST_VIDEOS, JHMDB_FRAMES,
        num_classes=21, hw=(240, 320))
    base = BUILD_DIR / "chip_smoke_runs"

    def edit(c):
        c["DATA"].update(ANNO_PATH=str(root), DATA_PATH=frames)
        c["TRAIN"]["EPOCH_NUM"] = 1
        c["MODEL"]["PRETRAIN_BACKBONE_DIR"] = str(weights["mat"])
        c["LOG"]["BASE_PATH"] = str(base)

    cfg_path = write_config("chip_smoke_jhmdb.yaml", edit,
                            source=JHMDB_CONFIG)
    cfg = load_config(str(cfg_path))
    log(f"[jhmdb] fixture: {len(JHMDB_TRAIN_VIDEOS)} train and "
        f"{len(JHMDB_TEST_VIDEOS)} test videos of {JHMDB_FRAMES} 320x240 "
        f"frames, 21 classes, in {time.perf_counter() - t0:.1f} s; "
        f"{cfg.model.backbone_name} {cfg.data.img_size}px T="
        f"{cfg.data.temp_len} Q={cfg.model.query_num}x{cfg.model.temp_len}, "
        f"{cfg.model.enc_layers}+{cfg.model.dec_layers} d={cfg.model.d_model}"
        f" {cfg.model.compute_dtype} bs={cfg.train.batch_size}, TUNE_POINT "
        f"{cfg.model.tune_point} over the smoke's .mat backbone")

    steps: list = []
    make = engine.make_train_step

    def timed_make(cfg_, state, **kw):
        step = make(cfg_, state, **kw)

        def timed(batch, weight):
            t = time.perf_counter()
            metrics = (without_sync(torch, step, batch, weight)
                       if len(steps) == NO_SYNC_STEP else step(batch, weight))
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t) * 1e3,
                          float(metrics["total_loss"]),
                          float(metrics["finite"])))
            return metrics

        return timed

    stem_in: dict = {"stats": [], "pool": []}
    saved_fns = (csn.stem_batch_stats, csn.stem_forward)
    csn.stem_batch_stats = _keep_stem_inputs(stem_in, "stats", saved_fns[0])
    csn.stem_forward = _keep_stem_inputs(stem_in, "pool", saved_fns[1])
    engine.make_train_step = timed_make
    zero_counts()
    t0 = time.perf_counter()
    try:
        _run_cli(train_jhmdb, ["--config-file", str(cfg_path), "--device",
                               "cuda", "--seed", "0"])
    finally:
        engine.make_train_step = make
        csn.stem_batch_stats, csn.stem_forward = saved_fns
    wall = time.perf_counter() - t0
    launches = launch_counts()
    n_train = len(JHMDB_TRAIN_VIDEOS) * JHMDB_FRAMES // cfg.train.batch_size
    n_val = len(JHMDB_TEST_VIDEOS) * JHMDB_FRAMES
    if len(steps) != n_train or not all(
            fin == 1.0 and np.isfinite(loss) for _, loss, fin in steps):
        raise AssertionError(f"jhmdb steps {steps}: want {n_train} finite")
    if launches != {"stem_pool": n_train + n_val, "stem_stats": n_train,
                    "stem_conv": 0, "depthwise": 0, "bottleneck": 0,
                    "chain": 0, "assign": n_train + n_val}:
        raise AssertionError(f"jhmdb launches {launches}")
    run = max(glob.glob(str(base / f"{cfg.log.exp_name}_*")),
              key=lambda d: Path(d).stat().st_mtime)
    ckpt = Path(run) / cfg.log.save_dir / "ckpt_epoch_0"
    with open(Path(run) / cfg.log.log_dir / "metrics.jsonl") as f:
        tags = {json.loads(line)["tag"]: json.loads(line)["value"]
                for line in f}
    maps = {k: tags.get(k) for k in ("val/val_mAP_epoch",
                                     "val/video_mAP@0.2",
                                     "val/video_mAP@0.5")}
    if not all(v is not None and np.isfinite(v) for v in maps.values()):
        raise AssertionError(f"jhmdb validation: {maps}")
    final = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    start = build_model(cfg, device="cpu", seed=0, train=True,
                        pretrained=True).state_dict()
    frozen = [n for n in start if not n.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))
        and param_label(n, cfg) == "frozen"]
    moved = _state_equal(torch, final, start, frozen)
    trained = [n for n in start if n.startswith(("class_fc.", "bbox_embed.",
                                                 "class_embed_b."))]
    still = [n for n in trained if torch.equal(final[n], start[n])]
    if not frozen or moved or still:
        raise AssertionError(f"jhmdb freeze check: frozen moved {moved[:3]},"
                             f" trained unchanged {still[:3]}")
    step_ms = [ms for ms, _, _ in steps]
    log(f"[jhmdb] train_jhmdb: {len(steps)} steps, losses "
        f"{[round(l, 3) for _, l, _ in steps]}; the {len(frozen)} frozen "
        f"params bit-equal across the steps; validation frame mAP "
        f"{maps['val/val_mAP_epoch']:.4f}, video mAP@0.2 "
        f"{maps['val/video_mAP@0.2']:.4f} @0.5 "
        f"{maps['val/video_mAP@0.5']:.4f}; launches {launches}; step "
        f"{NO_SYNC_STEP} ran under sync debug mode \"error\": no host "
        f"sync; wall {wall:.1f} s")
    log(f"[jhmdb] step ms: first {step_ms[0]:.2f}, steady median (after "
        f"the first) {statistics.median(step_ms[1:]):.2f} (min "
        f"{min(step_ms[1:]):.2f}, max {max(step_ms[1:]):.2f}); {smi}")

    # #2 and #4 in situ: the path's own stem inputs
    insitu = _stem_in_situ(torch, stem, stem_in, "jhmdb")
    if set(insitu) != {"stats_2", "pool_2", "pool_1"}:
        raise AssertionError(f"jhmdb in situ: saw {sorted(insitu)}")

    # eval_jhmdb on the run's checkpoint
    eval_path = write_config("chip_smoke_jhmdb_eval.yaml", lambda c: (
        edit(c), c["MODEL"].update(LOAD=True, PRETRAINED_PATH=str(ckpt))),
        source=JHMDB_CONFIG)
    runs: list = []
    undo = _capture(runner, "run_eval", runs)
    zero_counts()
    try:
        _run_cli(eval_jhmdb, ["--config-file", str(eval_path), "--device",
                              "cuda"])
    finally:
        undo()
    eval_launches = launch_counts()
    res = runs[0]["val"]
    if not (np.isfinite(res["mAP"]) and eval_launches["stem_pool"] == n_val
            and eval_launches["assign"] == n_val):
        raise AssertionError(f"eval_jhmdb: {res}, launches {eval_launches}")
    log(f"[jhmdb] eval_jhmdb on {ckpt.relative_to(ROOT)}: frame mAP "
        f"{res['mAP']:.4f}, video mAP "
        f"{ {k: round(v, 4) for k, v in res.items() if 'video' in k} }; "
        f"launches {eval_launches}")

    # the eval step's time (its breakdown waits for phase_jhmdb_breakdown)
    model = runs[0]["model"]
    batches = iter(runner.make_loaders(load_config(str(eval_path)),
                                       val_only=True)[1])
    batch = engine.device_batch(next(batches), torch.device("cuda"))
    batches.close()
    step_fn = engine.make_eval_step(cfg, model)
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_fn(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    eval_ms = statistics.median(times[2:])
    log(f"[jhmdb] eval step (1,32,224,400,3) forward + postprocess + "
        f"losses: median {eval_ms:.2f} ms of 10 (min {min(times[2:]):.2f});"
        f" {smi}")
    del runs
    return {"launches": launches, "eval_launches": eval_launches,
            "steady_ms": statistics.median(step_ms[1:]),
            "first_ms": step_ms[0], "eval_ms": eval_ms, "cfg": cfg,
            "eval_cfg": eval_path,
            "smi": smi,
            "eval_step": step_fn, "eval_batch": batch}


def phase_jhmdb_breakdown(torch, jhmdb: dict) -> None:
    """Where the device time of one JHMDB eval step and of one JHMDB train
    step goes (torch.profiler), against the times phase_jhmdb took before
    any profiled window."""
    from torch.profiler import ProfilerActivity, profile

    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import engine

    step_fn, batch = jhmdb.pop("eval_step"), jhmdb.pop("eval_batch")
    step_fn(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(batch)
        torch.cuda.synchronize()
    _report_device_time(torch, prof, "jhmdb eval breakdown",
                        f"one JHMDB eval step (eval step "
                        f"{jhmdb['eval_ms']:.2f} ms; {jhmdb['smi']})",
                        jhmdb["eval_ms"],
                        ("stem_pool_tc_kernel",), top=6)
    del step_fn, batch
    torch.cuda.empty_cache()

    cfg = jhmdb["cfg"]
    model = build_model(cfg, device="cuda", seed=0, train=True,
                        pretrained=True)
    step = engine.make_train_step(
        cfg, engine.create_train_state(cfg, model, steps_per_epoch=1))
    batch = _train_batch(torch, cfg)
    step(batch, cfg.loss.dice_cof)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch, cfg.loss.dice_cof)
        torch.cuda.synchronize()
    _report_device_time(torch, prof, "jhmdb train breakdown",
                        f"one JHMDB train step (steady step "
                        f"{jhmdb['steady_ms']:.2f} ms; {jhmdb['smi']})",
                        jhmdb["steady_ms"],
                        ("stem_pool_tc_kernel", "stem_stats_tc_kernel"),
                        top=10)


def _keep_stem_inputs(stem_in: dict, kind: str, fn):
    """A stem kernel's wrapper ``fn`` that also keeps a copy of the
    arguments of its first call at each input shape in ``stem_in[kind]``."""
    def wrapped(x, w, *rest):
        if not any(a[0].shape == x.shape for a in stem_in[kind]):
            stem_in[kind].append((x.detach().clone(), w.clone(),
                                  *(r.detach().clone() for r in rest)))
        return fn(x, w, *rest)
    return wrapped


def _keep_inputs(captured: dict, kind: str, fn, batch: int):
    """``fn`` that also keeps a copy of the arguments of its first call at
    each input shape with ``batch`` clips in ``captured[kind]``."""
    def wrapped(x, *rest):
        if x.shape[0] == batch and not any(
                a[0].shape == x.shape for a in captured[kind]):
            captured[kind].append((x.clone(), *(r.clone() for r in rest)))
        return fn(x, *rest)
    return wrapped


def pool_in_situ(torch, captured: dict) -> dict:
    """#2, #5 and #8 on the pool path's own inputs at 8 clips: against their
    plain versions (STEM_TOL, DW_TOL, the chain's limits), a repeat launch
    and rows_independent, bit for bit. Returns the errors by kernel."""
    from tubelet_transformer_tpu_torch.ops.cuda import depthwise as D
    from tubelet_transformer_tpu_torch.ops.cuda import stage as S
    from tubelet_transformer_tpu_torch.ops.cuda import stem

    kernels = {"stem": (stem.stem_forward, stem.stem_reference, STEM_TOL),
               "depthwise": (D.depthwise_conv3x3x3, D.depthwise_reference,
                             DW_TOL["bfloat16"]),
               "chain": (S.bottleneck_chain, None, None)}
    errors = {}
    with torch.inference_mode():
        for kind, (fn, plain, tol) in kernels.items():
            for args in captured[kind]:
                got, again = fn(*args), fn(*args)
                rows = rows_independent(torch, fn, args[0], args[1:],
                                        rows=range(args[0].shape[0]))
                detail = ""
                if plain is None:
                    errs, limits, plain_errs, spans, rounded = chain_errors(
                        torch, S, got, args)
                    # the kernel rounds its output to bf16 and the plain
                    # version does not: round to nearest adds at most half
                    # an ulp at each clip's max|ref|, which joins the limit
                    # (1.0 where layer4's stream reaches ~340 on the path's
                    # inputs, above phase 3's O(1) inputs)
                    eps = torch.finfo(got.dtype).eps
                    limits = [v + 0.5 * eps * 2.0 ** math.floor(math.log2(c))
                              for v, c in zip(limits, spans)]
                    ok = all(e <= v for e, v in zip(errs, limits))
                    err = max(errs) / max(spans)
                    detail = (
                        f" (per clip: max_abs_err "
                        f"{[round(e, 5) for e in errs]}, limits "
                        f"{[round(v, 5) for v in limits]}, the float32 "
                        f"rounded plain version's "
                        f"{[round(e, 5) for e in plain_errs]}, against the "
                        f"float64 version rounded to bf16 "
                        f"{[round(e, 5) for e in rounded]}, max|ref| "
                        f"{[round(c, 4) for c in spans]})")
                else:
                    ref = plain(*args)
                    span = ref.float().abs().max().item()
                    err = (got.float() - ref.float()).abs().max().item() / span
                    ok = err <= tol
                bits = torch.equal(got, again)
                torch.cuda.synchronize()
                shape = tuple(args[0].shape)
                log(f"[pool in situ] {kind} {shape} on the path's inputs: "
                    f"kernel vs plain {err:.4g} of max|ref|{detail}; "
                    f"repeat bit-equal {bits}; every row independent of the "
                    f"others {rows}")
                if not (ok and bits and rows):
                    raise AssertionError(f"pool in situ {kind} {shape}")
                errors[f"{kind}_{shape}"] = err
    if [len(captured[k]) for k in kernels] != [1, 1, 3]:
        raise AssertionError(f"pool in situ: saw "
                             f"{ {k: len(v) for k, v in captured.items()} }")
    return errors


def _timing_by_bucket(forwards: list) -> dict:
    """Median ms of each part of the pool's forwards, by bucket."""
    out = {}
    for b in sorted({f["bucket"] for f in forwards}):
        fs = [f for f in forwards if f["bucket"] == b]
        parts = {k: statistics.median(f[k] for f in fs) for k in (
            "assemble_ms", "upload_ms", "exec_fetch_ms")}
        parts["total_ms"] = statistics.median(
            f["assemble_ms"] + f["upload_ms"] + f["exec_fetch_ms"]
            for f in fs)
        out[b] = {"forwards": len(fs), "streams": sorted(
            {f["streams"] for f in fs}), **parts}
    return out


def pool_frames(i: int, h: int, w: int) -> list:
    """Stream ``i``'s 16 frames of ``h`` x ``w``: uniform noise in
    [24 i, 24 i + 64). Random weights map noise clips of one brightness to
    nearly one output, so the streams' levels set them apart."""
    rng = np.random.default_rng(100 + i)
    return [rng.integers(24 * i, 24 * i + 64, (h, w, 3), dtype=np.uint8)
            for _ in range(16)]


def _drive_pool(pool, frames: list) -> tuple[dict, list]:
    """POOL_TICKS ticks of the pool: every started stream (POOL_STARTS)
    pushes its next frame, then one step. Returns each stream's results and
    the forwards' timings (empty unless the pool instruments)."""
    forwards, results = [], {i: [] for i in range(len(POOL_STARTS))}
    for tick in range(POOL_TICKS):
        for i, start in enumerate(POOL_STARTS):
            if tick >= start:
                pool.push_frame(i, frames[i][(tick - start) % 16])
        for sid, res in pool.step().items():
            results[sid].append(res)
        forwards += pool.last_timing
    return results, forwards


def _pool_diff(got: list, sid: int, alone: dict, other: int) -> dict:
    """Largest difference of stream ``sid``'s keyframe results from
    stream ``other``'s single-detector results of the same frame indices:
    scores and actor probabilities absolute, boxes over each source's
    longer side."""
    diff = {"scores": 0.0, "boxes": 0.0, "actor_prob": 0.0}
    sides = (max(POOL_GEOMETRIES[sid]), max(POOL_GEOMETRIES[other]))
    for r in got:
        for d, e in zip(r.detections, alone[r.frame_index].detections):
            diff["scores"] = max(diff["scores"], float(
                np.abs(d.scores - e.scores).max()))
            diff["boxes"] = max(diff["boxes"], float(np.abs(
                d.box / sides[0] - e.box / sides[1]).max()))
            diff["actor_prob"] = max(diff["actor_prob"],
                                     abs(d.actor_prob - e.actor_prob))
    return diff


def _pool_against_single(cfg, model, kw: dict, frames: list, results: dict,
                         tol: float | None, tag: str) -> tuple[dict, dict]:
    """Each stream's pool results against a single StreamingDetector on the
    same model and frames (the sound reading), and against another
    stream's single detector (the control, as a fault that hands a row
    another row's output would show it): the sound reading must lie within
    ``tol`` and the nearest pair of the control beyond it (no check where
    ``tol`` is None). Returns both readings."""
    from tubelet_transformer_tpu_torch.serving import StreamingDetector

    alone = {}
    for sid in results:
        single = StreamingDetector(cfg, model, **kw)
        alone[sid] = {}
        for n in range(POOL_TICKS - POOL_STARTS[sid]):
            if (r := single.push_frame(frames[sid][n % 16])) is not None:
                alone[sid][r.frame_index] = r
        if [r.frame_index for r in results[sid]] != sorted(alone[sid]):
            raise AssertionError(f"{tag} stream {sid}: keyframes "
                                 f"{[r.frame_index for r in results[sid]]}, "
                                 f"alone {sorted(alone[sid])}")
        for r in results[sid]:
            if not (len(r.detections) == len(alone[sid][r.frame_index]
                                             .detections)
                    == cfg.model.query_num):
                raise AssertionError(f"{tag} stream {sid}: detections")
            if not all(np.isfinite(d.box).all() and np.isfinite(
                    d.scores).all() for d in r.detections):
                raise AssertionError(f"{tag}: non-finite detection")
    sound = {k: 0.0 for k in ("scores", "boxes", "actor_prob")}
    for sid in results:
        for k, v in _pool_diff(results[sid], sid, alone[sid], sid).items():
            sound[k] = max(sound[k], v)
    control = {(sid, other): _pool_diff(results[sid], sid, alone[other],
                                        other)
               for sid in results for other in results if other != sid}
    near = min(control, key=lambda p: max(control[p].values()))
    log(f"[{tag}] each stream's keyframes against a single detector on the "
        f"same model and frames: largest difference {sound} (scores and "
        f"actor probabilities absolute, boxes over the source's longer "
        f"side; tol {tol}); control, against another stream's single "
        f"detector: the nearest pair {near} differs by "
        f"{max(control[near].values())} {control[near]}")
    if tol is not None and not (max(sound.values()) <= tol
                                < max(control[near].values())):
        raise AssertionError(f"{tag} against single: {sound}, control "
                             f"{control[near]}, tol {tol}")
    return sound, control[near]


def phase_pool(torch, model, cfg_path: Path, per_forward: dict,
               smi: str) -> dict:
    """The serving pool at full width on ``cfg_path``'s model: warmup over
    the buckets, then 8 streams of POOL_GEOMETRIES staggered by
    POOL_STARTS, one step per tick, with instrument on: buckets 4 and 8
    padded, each stream's keyframes equal to a single StreamingDetector's on
    the same model and frames (POOL_TOL, with its control), the kernel
    launches per forward, #2/#5/#8 in situ on the path's inputs at 8 clips,
    and the step latency per bucket with its assemble/upload/exec split."""
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models import csn
    from tubelet_transformer_tpu_torch.serving import StreamingDetectorPool

    cfg = load_config(str(cfg_path))
    kw = dict(fps=8.0, detect_every=8, actor_threshold=-1.0, device="cuda")
    pool = StreamingDetectorPool(cfg, model, max_batch=8, instrument=True,
                                 **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pool.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    frames = [pool_frames(i, h, w) for i, (h, w) in
              enumerate(POOL_GEOMETRIES)]

    captured: dict = {"stem": [], "depthwise": [], "chain": []}
    saved = (csn.stem_forward, csn.depthwise_conv3x3x3, csn.bottleneck_chain)
    csn.stem_forward, csn.depthwise_conv3x3x3, csn.bottleneck_chain = (
        _keep_inputs(captured, k, f, 8) for k, f in zip(captured, saved))
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    try:
        results, forwards = _drive_pool(pool, frames)
    finally:
        csn.stem_forward, csn.depthwise_conv3x3x3, csn.bottleneck_chain = (
            saved)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: per_forward.get(k, 0) * len(forwards) for k in launches}
    shapes = sorted({(f["bucket"], f["streams"]) for f in forwards})
    log(f"[pool] {cfg_path.name}, max_batch 8, streams "
        f"{[f'{h}x{w}' for h, w in POOL_GEOMETRIES]}: warmup of buckets "
        f"1, 2, 4, 8 {warm_s:.2f} s; {len(forwards)} forwards (bucket, "
        f"streams) {shapes}; keyframes per stream "
        f"{[len(r) for r in results.values()]}; launches {launches}; "
        f"{POOL_TICKS} ticks in {wall:.2f} s; peak device memory "
        f"{peak_gb:.2f} GB")
    if launches != want or shapes != [(4, 3), (8, 5)] or any(
            len(r) != 3 for r in results.values()):
        raise AssertionError(f"pool: launches {launches} (want {want}), "
                             f"forwards {shapes}")
    sound, control = _pool_against_single(cfg, model, kw, frames, results,
                                          POOL_TOL, "pool")

    insitu = pool_in_situ(torch, captured)
    by_bucket = _timing_by_bucket(forwards)
    for b, t in by_bucket.items():
        log(f"[pool] bucket {b} ({t['forwards']} forwards of "
            f"{t['streams']} streams): step median {t['total_ms']:.2f} ms = "
            f"assemble {t['assemble_ms']:.2f} + upload {t['upload_ms']:.2f} "
            f"+ exec and fetch {t['exec_fetch_ms']:.2f} ms; {smi}")
    return {"launches": launches, "forwards": len(forwards),
            "by_bucket": by_bucket, "pool_vs_single": sound,
            "pool_control": control, "in_situ": insitu, "warmup_s": warm_s}


def phase_pool_float32(torch, cfg_path: Path) -> dict:
    """The pool's streams again on ``cfg_path``'s model built in float32
    (TF32 off), against single detectors with POOL_F32_TOL and its control:
    without bf16 rounding the batch's own noise is ~1e-6, so this reading
    sees a stream handed another row's output where the bf16 one barely
    can. No timing, no launch count (the bf16 phase has them)."""
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.serving import StreamingDetectorPool

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(str(cfg_path))
    cfg.model.compute_dtype = "float32"
    model = build_model(cfg, device="cuda", seed=0)
    kw = dict(fps=8.0, detect_every=8, actor_threshold=-1.0, device="cuda")
    pool = StreamingDetectorPool(cfg, model, max_batch=8, **kw)
    frames = [pool_frames(i, h, w) for i, (h, w) in
              enumerate(POOL_GEOMETRIES)]
    results, _ = _drive_pool(pool, frames)
    sound, control = _pool_against_single(cfg, model, kw, frames, results,
                                          POOL_F32_TOL, "pool float32")
    del model, pool
    torch.cuda.empty_cache()
    return {"pool_vs_single": sound, "pool_control": control}


def phase_lfb(torch, eval_cfg: Path, train: dict) -> dict:
    """Long-term context at full width: the generate_lfb CLI on phase 10's
    YAML (MODEL.LOAD on phase 9's checkpoint) writes a bank with one key per
    val keyframe; then train_ava with USE_LFB and LFB.BANK_PATH on it from
    that checkpoint (SYNTHETIC_SIZE 4: 2 steps at batch 2, one validation):
    the loss finite, the checkpoint's weights loaded, the LFB weights
    moved."""
    from tubelet_transformer_tpu_torch.cli import (generate_lfb, runner,
                                                   train_ava)
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.eval.lfb import FeatureBank
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import engine
    from tubelet_transformer_tpu_torch.train.checkpoint import LFB_MODULES

    bank_path = BUILD_DIR / "chip_smoke_lfb_bank.npz"
    zero_counts()
    t0 = time.perf_counter()
    # every query's actor probability by keyframe (sorted), for
    # generate_lfb over the mesh (phase_mesh)
    probs, add = {}, FeatureBank.add

    def adding(self, key, features, actor_prob, threshold=0.8):
        probs[key] = np.sort(np.asarray(actor_prob))[::-1]
        return add(self, key, features, actor_prob, threshold)

    FeatureBank.add = adding
    try:
        _run_cli(generate_lfb, ["--config-file", str(eval_cfg), "--out",
                                str(bank_path), "--device", "cuda", "--seed",
                                "0"])
    finally:
        FeatureBank.add = add
    gen_s = time.perf_counter() - t0
    gen_launches = launch_counts()
    bank = FeatureBank.load(str(bank_path))
    one_process = {"feats": dict(bank._bank), "valid": dict(bank._valid),
                   "probs": probs}
    keys = runner.build_dataset(load_config(str(eval_cfg)), "val").keys
    valid = sum(int(v.sum()) for v in bank._valid.values())
    log(f"[lfb] generate_lfb on {eval_cfg.name}: {len(bank)} keys, "
        f"{bank.slots} slots of {bank.feat_dim}, {valid} slots valid at "
        f"the actor threshold 0.8; launches {gen_launches}; wall "
        f"{gen_s:.1f} s")
    if (sorted(bank._bank) != sorted(keys) or bank.feat_dim != 256
            or gen_launches["stem_pool"] != VAL_FORWARDS):
        raise AssertionError(f"generate_lfb: keys {sorted(bank._bank)} "
                             f"against {sorted(keys)}, launches "
                             f"{gen_launches}")
    # the checkpoint has trained 4 steps from random heads: its actor
    # probabilities mean nothing, so every slot is admitted and the
    # USE_LFB steps train lfb_attn whatever they are
    for k, v in bank._valid.items():
        bank._valid[k] = np.ones_like(v)
    bank.save(str(bank_path))

    ckpt = train["ckpt"]
    base = BUILD_DIR / "chip_smoke_runs"

    def edit(c):
        c["USE_LFB"] = True
        c["LFB"] = {"BANK_PATH": str(bank_path)}
        c["DATA"]["SYNTHETIC_SIZE"] = 4
        c["MODEL"].update(LOAD=True, PRETRAINED_PATH=str(ckpt))
        c["LOG"]["EXP_NAME"] = "chip_smoke_lfb"

    cfg_path = write_config("chip_smoke_lfb_train.yaml", edit,
                            source=train["cfg_path"])
    cfg = load_config(str(cfg_path))
    steps = []
    make = engine.make_train_step

    def recording(cfg_, state, **kw):
        step = make(cfg_, state, **kw)

        def run(batch, weight):
            metrics = step(batch, weight)
            steps.append((tuple(batch["lfb_features"].shape),
                          float(metrics["total_loss"]),
                          float(metrics["finite"])))
            return metrics
        return run

    engine.make_train_step = recording
    zero_counts()
    t0 = time.perf_counter()
    try:
        _run_cli(train_ava, ["--config-file", str(cfg_path), "--device",
                             "cuda", "--seed", "0"])
    finally:
        engine.make_train_step = make
    wall = time.perf_counter() - t0
    launches = launch_counts()
    run = max(glob.glob(str(base / "chip_smoke_lfb_*")),
              key=lambda d: Path(d).stat().st_mtime)
    final = torch.load(Path(run) / cfg.log.save_dir / "ckpt_epoch_0",
                       map_location="cpu", weights_only=True)["model"]
    start = build_model(cfg, device="cpu", seed=0, train=True,
                        pretrained=True).state_dict()
    phase9 = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    loaded = not _state_equal(torch, start, phase9, [
        n for n in phase9 if not n.endswith("num_batches_tracked")])
    lfb_names = [n for n in final if n.startswith(LFB_MODULES)]
    still = [n for n in lfb_names if torch.equal(final[n], start[n])]
    l_mem = 2 * cfg.lfb.half_window * bank.slots
    log(f"[lfb] train_ava USE_LFB from {ckpt.relative_to(ROOT)}: steps "
        f"(memory shape, loss, finite) {steps}; the start is phase 9's "
        f"checkpoint {loaded}; the {len(lfb_names)} LFB tensors moved "
        f"({len(still)} unchanged: {still[:3]}); launches {launches}; wall "
        f"{wall:.1f} s")
    if launches != {"stem_pool": 2 + 4, "stem_stats": 2, "stem_conv": 0,
                    "depthwise": 0, "bottleneck": 0, "chain": 0,
                    "assign": 2 + 4}:
        raise AssertionError(f"USE_LFB train: launches {launches}, want 2 "
                             "statistics and 2 + 4 pooled")
    if not (len(steps) == 2 and all(
            shape == (2, l_mem, 256) and fin == 1.0 and np.isfinite(loss)
            for shape, loss, fin in steps) and loaded and len(lfb_names) == 8
            and not still):
        raise AssertionError(f"USE_LFB train: steps {steps}, loaded "
                             f"{loaded}, unchanged {still}")
    return {"generate_launches": gen_launches, "train_launches": launches,
            "steps": steps, "bank": one_process}


def phase_http(torch, cfg_path: Path, per_forward: dict, smi: str) -> dict:
    """The HTTP server at full width on ``cfg_path`` (USE_LFB on, memory
    HTTP_MEMORY), max_batch 8: 4 client streams through ``client.py``, two
    pushing JPEG and two raw frames, each waiting for its keyframe before
    it pushes the next 8 frames; every keyframe delivered with the memory
    sequence 0, 2, 4, 6; /healthz and /v1/stats; the kernel launches per
    forward, read after the scheduler has joined; no scheduler failure."""
    import contextlib
    import io
    import threading

    from PIL import Image

    from tubelet_transformer_tpu_torch.client import DetectionClient
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.serving_http import DetectionServer

    cfg = load_config(str(cfg_path))
    out = io.StringIO()
    batches: list = []
    results = {i: [] for i in range(len(HTTP_GEOMETRIES))}
    errors: list = []

    def client_stream(i, client):
        try:
            h, w = HTTP_GEOMETRIES[i]
            rng = np.random.default_rng(200 + i)
            pool = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                    for _ in range(8)]
            jpegs = []
            for f in pool:
                buf = io.BytesIO()
                Image.fromarray(f).save(buf, format="JPEG")
                jpegs.append(buf.getvalue())
            with client.open_stream() as stream:
                for n in range(FRAMES):
                    if i < 2:
                        stream.push_jpeg(jpegs[n % 8])
                    else:
                        stream.push(pool[n % 8])
                    if n + 1 >= 64 and (n + 1 - 64) % 8 == 0:
                        got = []
                        while not got:
                            got = stream.results(timeout_s=120)
                        results[i] += got
        except Exception as e:
            errors.append((i, repr(e)))

    with contextlib.redirect_stdout(out):
        server = DetectionServer(
            cfg, host="127.0.0.1", port=0, max_batch=8, detect_every=8,
            fps=8.0, actor_threshold=-1.0, memory_keyframes=HTTP_MEMORY[0],
            memory_slots=HTTP_MEMORY[1], device="cuda", rng_seed=0)
        core = server.pool._tpl._detect_core

        def counting(clips, *rest):
            batches.append(clips.shape[0])
            return core(clips, *rest)

        server.pool._tpl._detect_core = counting
        t0 = time.perf_counter()
        try:
            server.start(wait_ready=True)
            warm_s = time.perf_counter() - t0
            warmup = list(batches)
            client = DetectionClient(f"http://127.0.0.1:{server.port}",
                                     timeout_s=120)
            zero_counts()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client_stream,
                                        args=(i, client))
                       for i in range(len(HTTP_GEOMETRIES))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            health, stats = client.health(), client.stats()
        finally:
            server.stop()
    launches = launch_counts()
    printed = out.getvalue()
    streamed = batches[len(warmup):]
    want = {k: per_forward.get(k, 0) * len(streamed) for k in launches}
    n_mem, slots = HTTP_MEMORY
    want_sizes = [min(k * slots, n_mem * slots) for k in range(4)]
    log(f"[http] {cfg_path.name}, USE_LFB, memory {n_mem} x {slots}, "
        f"max_batch 8: warmup {warm_s:.2f} s over batches {warmup}; "
        f"streams {[f'{h}x{w}' for h, w in HTTP_GEOMETRIES]} (JPEG, JPEG, "
        f"raw, raw): keyframes {[[r['frame_index'] for r in v] for v in results.values()]}"
        f", memory sizes "
        f"{[[r['memory_size'] for r in v] for v in results.values()]}; "
        f"{len(streamed)} forwards of batches {streamed}; launches "
        f"{launches}; {wall:.2f} s; /healthz {health}; /v1/stats {stats}; "
        f"{smi}")
    if printed.strip():
        log(f"[http] the server printed: {printed.strip()[-2000:]}")
    bad_lines = [l for l in printed.splitlines()
                 if "warmup failed" in l or "step failed" in l]
    alive = [t.name for t in threads if t.is_alive()]
    if (errors or bad_lines or alive
            or any([r["frame_index"] for r in v] != [32, 40, 48, 56]
                   or [r["memory_size"] for r in v] != want_sizes
                   or any(len(r["detections"]) != cfg.model.query_num
                          for r in v) for v in results.values())
            or health.get("status") != "ok"
            or health.get("backend") != "cuda"
            or health.get("device") != torch.cuda.get_device_name(0)
            or stats.get("keyframes_served") != 16
            or warmup != [1, 2, 4, 8] or launches != want):
        raise AssertionError(f"http: errors {errors}, failures {bad_lines}, "
                             f"threads alive {alive}, launches {launches} "
                             f"(want {want})")
    return {"launches": launches, "forwards": len(streamed),
            "stats": stats}


def _train_run(torch, train: dict, name: str, edit,
               keep_stem: bool = False) -> dict:
    """train_ava on phase 9's YAML with ``edit`` applied, as experiment
    ``name`` (2 or more steps and one validation on the synthetic set):
    each step's time and metrics, the kernel launches, the peak device
    memory, the run's directory and its checkpoint's state; with
    ``keep_stem`` the first inputs of each shape of the two stem kernels.
    Raises unless every step is finite."""
    from tubelet_transformer_tpu_torch.cli import train_ava
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models import csn
    from tubelet_transformer_tpu_torch.train import engine

    cfg_path = write_config(f"{name}.yaml", lambda c: (
        c["LOG"].update(EXP_NAME=name), edit(c)), source=train["cfg_path"])
    cfg = load_config(str(cfg_path))
    steps: list = []
    make = engine.make_train_step

    def recording(cfg_, state, **kw):
        step = make(cfg_, state, **kw)

        def run(batch, weight):
            t = time.perf_counter()
            metrics = step(batch, weight)
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t) * 1e3,
                          {k: float(v) for k, v in metrics.items()}))
            return metrics
        return run

    stem_in: dict = {"stats": [], "pool": []}
    saved = (csn.stem_batch_stats, csn.stem_forward)
    if keep_stem:
        csn.stem_batch_stats = _keep_stem_inputs(stem_in, "stats", saved[0])
        csn.stem_forward = _keep_stem_inputs(stem_in, "pool", saved[1])
    engine.make_train_step = recording
    window = _peak_from(torch)
    zero_counts()
    t0 = time.perf_counter()
    try:
        _run_cli(train_ava, ["--config-file", str(cfg_path), "--device",
                             "cuda", "--seed", "0"])
    finally:
        engine.make_train_step = make
        csn.stem_batch_stats, csn.stem_forward = saved
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = _peak_gb(torch, window)
    if len(steps) < 2 or not all(m["finite"] == 1.0 and np.isfinite(
            m["total_loss"]) for _, m in steps):
        raise AssertionError(f"{name}: steps {steps}")
    run = Path(max(glob.glob(str(BUILD_DIR / "chip_smoke_runs"
                                 / f"{name}_*")),
                   key=lambda d: Path(d).stat().st_mtime))
    final = torch.load(run / cfg.log.save_dir / "ckpt_epoch_0",
                       map_location="cpu", weights_only=True)["model"]
    return {"cfg": cfg, "steps": steps, "launches": launches,
            "peak_gb": peak_gb, "wall": wall, "run": run, "final": final,
            "stem_in": stem_in}


def _peak_from(torch) -> tuple:
    """Start a peak-memory window: synchronise, reset the peak and return
    the memory the process holds now, which the window's peak is read
    against (_peak_gb)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return (torch.cuda.memory_allocated(),)


def _peak_gb(torch, window: tuple) -> float:
    """The window's peak device memory above what the process held at its
    start (the earlier phases' models, still alive), GB."""
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - window[0]) / 1e9


def _train_launches(steps: int, stats_per_step: int, val: int,
                    microbatches: int = 1) -> dict:
    """The launches of a train run of ``steps`` steps with the frozen stem
    (TUNE_POINT 4), ``stats_per_step`` two-phase stems a step, and ``val``
    validation forwards: an assignment for each microbatch's losses and
    each validation forward's (VAL.COMPUTE_LOSSES)."""
    n = steps * stats_per_step
    return {"stem_pool": n + val, "stem_stats": n, "stem_conv": 0,
            "depthwise": 0, "bottleneck": 0, "chain": 0,
            "assign": steps * microbatches + val}


def _frozen_still(torch, r: dict, start: dict) -> int:
    """The number of frozen parameters of run ``r``; raises unless each
    is bit-equal to ``start`` (phase 9's initial state) in its
    checkpoint."""
    from tubelet_transformer_tpu_torch.train.optimizer import param_label

    names = [n for n in start if not n.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))
        and param_label(n, r["cfg"]) == "frozen"]
    moved = _state_equal(torch, r["final"], start, names)
    if not names or moved:
        raise AssertionError(f"frozen parameters moved: {moved[:5]}")
    return len(names)


def _step_ms(steps: list) -> str:
    ms = [round(t, 2) for t, _ in steps]
    return f"step ms {ms} (steady: the last {ms[-1]})"


def _stem_in_situ(torch, stem, stem_in: dict, tag: str) -> set:
    """#2 and #4 on a path's own stem inputs: against their plain versions
    (STEM_TOL; STATS_MEAN_TOL / STATS_VAR_TOL) and a repeat launch, bit for
    bit. Returns the kinds and batch sizes checked ("stats_2"...)."""
    seen = set()
    for kind, args in stem_in.items():
        for a in args:
            shape = tuple(a[0].shape)
            if kind == "stats":
                got, again = stem.stem_batch_stats(*a), stem.stem_batch_stats(
                    *a)
                ref = stem.stem_batch_stats_reference(*a)
                var_rel = ((got[1] - ref[1]).abs() / ref[1]).max().item()
                mean_err = (got[0] - ref[0]).abs().max().item()
                std = ref[1].sqrt().max().item()
                ok = (mean_err <= STATS_MEAN_TOL["bfloat16"] * std
                      and var_rel <= STATS_VAR_TOL["bfloat16"])
                bits = all(torch.equal(p, q) for p, q in zip(got, again))
                err = f"mean {mean_err / std:.3g} of max std, var {var_rel:.3g}"
            else:
                got, again = stem.stem_forward(*a), stem.stem_forward(*a)
                ref = stem.stem_reference(*a)
                e = (got.float() - ref.float()).abs().max().item()
                span = ref.float().abs().max().item()
                ok = e <= STEM_TOL * span
                bits = torch.equal(got, again)
                err = f"{e / span:.3g} of max|ref|"
            torch.cuda.synchronize()
            log(f"[{tag} in situ] {'stem_stats' if kind == 'stats' else 'stem_pool'}"
                f" {shape} on the path's clips: kernel vs plain {err}; "
                f"repeat bit-equal {bits}")
            if not (ok and bits):
                raise AssertionError(f"{tag} in situ {kind} {shape}")
            seen.add(f"{kind}_{shape[0]}")
    return seen


def phase_frozen_chunk(torch, stem, train: dict, smi: str) -> dict:
    """TRAIN.FROZEN_CHUNK 1 at the recipe's batch of 2 (TUNE_POINT 4)
    through train_ava, 2 steps: the frozen prefix runs one clip at a time,
    so #4 and #2 launch twice a step; both in situ on the step's one-clip
    inputs; the chunked prefix and its BN running statistics against the
    unchunked model run on each clip in turn, bit for bit."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    r = _train_run(torch, train, "chip_smoke_frozen_chunk", lambda c: (
        c["DATA"].update(SYNTHETIC_SIZE=4),
        c["TRAIN"].update(BATCH_SIZE=2, FROZEN_CHUNK=1),
        c["MODEL"].update(TUNE_POINT=4)), keep_stem=True)
    want = _train_launches(len(r["steps"]), 2, 4)
    if len(r["steps"]) != 2 or r["launches"] != want:
        raise AssertionError(f"frozen chunk: launches {r['launches']}, want "
                             f"{want}")
    frozen = _frozen_still(torch, r, train["start"])
    seen = _stem_in_situ(torch, stem, r["stem_in"], "frozen chunk")
    if seen != {"stats_1", "pool_1"}:
        raise AssertionError(f"frozen chunk in situ: saw {sorted(seen)}")

    cfg = r["cfg"]
    batch = _train_batch(torch, cfg)
    models = []
    for ck in (1, 0):
        cfg.train.frozen_chunk = ck
        models.append(build_model(cfg, device="cuda", seed=0, train=True))
    chunked, plain = (m.backbone.body for m in models)
    clips = batch["clips"].to(models[0].dtype)
    with torch.no_grad():
        y_chunked = chunked(clips)
        y = torch.cat([plain.stage(1, plain.stage(0, plain.stem(c)))
                       for c in clips.split(1)])
        y_plain = plain.stage(3, plain.stage(2, y))
    stats = [n for n, _ in chunked.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    moved = _state_equal(torch, dict(chunked.named_buffers()),
                         dict(plain.named_buffers()), stats)
    same = torch.equal(y_chunked, y_plain)
    log(f"[frozen chunk] train_ava FROZEN_CHUNK 1, bs 2, TUNE_POINT 4: "
        f"losses {[round(m['total_loss'], 4) for _, m in r['steps']]}; "
        f"{_step_ms(r['steps'])}; launches {r['launches']}; the "
        f"{frozen} frozen params bit-equal; peak device memory "
        f"{r['peak_gb']:.2f} GB above the run's start; wall "
        f"{r['wall']:.1f} s; the chunked "
        f"backbone output {tuple(y_chunked.shape)} equal to the unchunked "
        f"model on each clip in turn {same}, its {len(stats)} running "
        f"statistics equal too: {not moved}; {smi}")
    if not same or moved:
        raise AssertionError(f"frozen chunk: output equal {same}, "
                             f"statistics differ {moved[:3]}")
    del models, chunked, plain
    return {"launches": r["launches"], "steady_ms": r["steps"][-1][0],
            "peak_gb": r["peak_gb"]}


def _grads(model) -> dict:
    """The model's gradients, copied to the host: copies on the card would
    count in the next step's peak memory."""
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


def _rel_diffs(got: dict, want: dict) -> dict:
    """The L2 distance of each tensor of ``got`` from ``want``, relative to
    the norm of ``want``'s tensor, or to 1e-6 of all of ``want`` where the
    tensor's own is smaller (a gradient that is zero but for noise)."""
    norms = {n: float(w.float().norm()) for n, w in want.items()}
    floor = 1e-6 * math.sqrt(sum(v * v for v in norms.values()))
    return {n: float((got[n].float() - w.float()).norm())
            / max(norms[n], floor, 1e-30) for n, w in want.items()}


def phase_accum(torch, train: dict, smi: str) -> dict:
    """TRAIN.ACCUM_STEPS 2 at batch 4 (microbatch 2, the recipe's batch)
    through train_ava, 2 steps: finite, the frozen parameters bit-equal,
    #4 once per microbatch; then, from one state, the peak memory of an
    accumulated step against an unaccumulated bs-4 step, and the
    accumulated step against two half-batch passes run by hand (loss,
    pre-clip gradients and grad_norm, updated parameters)."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import engine
    from tubelet_transformer_tpu_torch.train.optimizer import (
        clip_by_global_norm, param_label, set_learning_rate,
        trainable_params)

    r = _train_run(torch, train, "chip_smoke_accum", lambda c: (
        c["DATA"].update(SYNTHETIC_SIZE=8),
        c["TRAIN"].update(BATCH_SIZE=4, ACCUM_STEPS=2)))
    want = _train_launches(len(r["steps"]), 2, 8, microbatches=2)
    if len(r["steps"]) != 2 or r["launches"] != want:
        raise AssertionError(f"accum: launches {r['launches']}, want {want}")
    frozen = _frozen_still(torch, r, train["start"])

    cfg = r["cfg"]
    batch = _train_batch(torch, cfg)
    model = build_model(cfg, device="cuda", seed=0, train=True)
    _no_dropout(model)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    # each way twice, in turns, the second kept: a model's first step
    # carries its warm-up
    for accum in (1, 2, 1, 2):
        model.load_state_dict(saved)
        cfg.train.accum_steps = accum
        step = engine.make_train_step(
            cfg, engine.create_train_state(cfg, model, steps_per_epoch=1))
        torch.cuda.empty_cache()
        window = _peak_from(torch)
        t = time.perf_counter()
        step(batch, cfg.loss.dice_cof)
        torch.cuda.synchronize()
        runs[accum] = {"ms": (time.perf_counter() - t) * 1e3,
                       "peak_gb": _peak_gb(torch, window)}
    # the accumulated step once more, untimed, with its gradients read
    # before the clip
    model.load_state_dict(saved)
    step = engine.make_train_step(
        cfg, engine.create_train_state(cfg, model, steps_per_epoch=1))
    pre_clip: dict = {}
    clip = engine.clip_by_global_norm

    def recording_clip(params_, max_norm, *rest):
        pre_clip.update(_grads(model))
        return clip(params_, max_norm, *rest)

    engine.clip_by_global_norm = recording_clip
    try:
        metrics = step(batch, cfg.loss.dice_cof)
    finally:
        engine.clip_by_global_norm = clip
    got = {"total": float(metrics["total_loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "params": {n: p.detach().cpu()
                      for n, p in model.named_parameters()}}
    # the same step by hand: two half-batch passes, the gradients summed
    # by backward, averaged, clipped, one AdamW step
    model.load_state_dict(saved)
    cfg.train.accum_steps = 1
    state = engine.create_train_state(cfg, model, steps_per_epoch=1)
    params = trainable_params(state.optimizer)
    clips = batch["clips"].to(model.dtype)
    totals = []
    for rows in (slice(0, 2), slice(2, 4)):
        half = {k: v[rows] for k, v in batch.items()}
        out = model(clips[rows], half["pad_mask"])
        total = engine.weighted_total(cfg, engine.compute_losses(
            cfg, out, engine._targets_from_batch(cfg, half)),
            cfg.loss.dice_cof)
        total.backward()
        totals.append(total.detach())
    torch._foreach_mul_([p.grad for p in params if p.grad is not None], 0.5)
    hand_grads = _grads(model)
    hand_norm = float(clip_by_global_norm(params, cfg.loss.clips_max_norm))
    set_learning_rate(state.optimizer, state.schedule(0))
    state.optimizer.step()
    cfg.train.accum_steps = 2
    hand_total = float((totals[0] + totals[1]) * 0.5)
    total_rel = abs(got["total"] - hand_total) / abs(hand_total)
    grad_rel = _rel_diffs(pre_clip, hand_grads)
    norm_rel = abs(got["grad_norm"] - hand_norm) / hand_norm
    lr = {"main": cfg.train.lr, "backbone": cfg.train.lr_backbone}
    moved_rel = max(
        float((p.detach().cpu() - got["params"][n]).abs().max())
        / lr[param_label(n, cfg)] for n, p in model.named_parameters()
        if n in hand_grads)
    worst = max(grad_rel, key=grad_rel.get)
    clipped = hand_norm > cfg.loss.clips_max_norm
    log(f"[accum] train_ava bs 4 ACCUM_STEPS 2: losses "
        f"{[round(m['total_loss'], 4) for _, m in r['steps']]}; "
        f"{_step_ms(r['steps'])}; launches {r['launches']}; the {frozen} "
        f"frozen params bit-equal; wall {r['wall']:.1f} s. One state, bs 4, "
        f"the second step each way, peaks above the step's start: "
        f"unaccumulated step {runs[1]['ms']:.2f} ms, peak "
        f"{runs[1]['peak_gb']:.2f} GB; accumulated {runs[2]['ms']:.2f} ms, "
        f"peak {runs[2]['peak_gb']:.2f} GB; against two half-batch passes "
        f"by hand: total {got['total']:.6f} vs {hand_total:.6f} (rel "
        f"{total_rel:.3g}, tol {ACCUM_LOSS_TOL}), pre-clip grad_norm "
        f"{got['grad_norm']:.6g} vs {hand_norm:.6g} (rel {norm_rel:.3g}; "
        f"the clip at {cfg.loss.clips_max_norm} acts: {clipped}), pre-clip "
        f"gradients' largest relative L2 distance {grad_rel[worst]:.3g} "
        f"({worst}; tol {ACCUM_GRAD_TOL} for both), updated parameters "
        f"within {moved_rel:.3g} lr (tol {ACCUM_PARAM_TOL}); {smi}")
    if not (total_rel <= ACCUM_LOSS_TOL and grad_rel[worst] <= ACCUM_GRAD_TOL
            and norm_rel <= ACCUM_GRAD_TOL and moved_rel <= ACCUM_PARAM_TOL
            and set(pre_clip) == set(hand_grads)
            and runs[2]["peak_gb"] < runs[1]["peak_gb"]):
        raise AssertionError("accum: the accumulated step disagrees with the "
                             "hand-run halves, or takes no less memory")
    del model, runs, saved, got, pre_clip, hand_grads
    return {"launches": r["launches"], "steady_ms": r["steps"][-1][0]}


def phase_remat(torch, train: dict, smi: str) -> dict:
    """TRAIN.REMAT_BACKBONE on a full-backprop step (TUNE_POINT 0: nothing
    frozen) with MODEL.PALLAS_KERNELS, bs 2, from one state: two plain
    steps (their spread) and one with remat. Peak memory both ways; the
    gradients within the spread; the running statistics bit-equal; the
    depthwise launches, the recompute's included (3 per plain step, 6 with
    remat: layer1's convs run again in the backward)."""
    import copy

    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import engine

    cfg = copy.deepcopy(train["cfg"])
    cfg.model.tune_point = 0
    cfg.model.pallas_kernels = True
    model = build_model(cfg, device="cuda", seed=0, train=True)
    _no_dropout(model)
    batch = _train_batch(torch, cfg)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for remat in (False, False, True):
        model.load_state_dict(saved)
        model.backbone.body.remat = remat
        step = engine.make_train_step(
            cfg, engine.create_train_state(cfg, model, steps_per_epoch=1))
        torch.cuda.empty_cache()
        window = _peak_from(torch)
        zero_counts()
        t = time.perf_counter()
        metrics = step(batch, cfg.loss.dice_cof)
        torch.cuda.synchronize()
        runs.append({"ms": (time.perf_counter() - t) * 1e3,
                     "peak_gb": _peak_gb(torch, window),
                     "launches": launch_counts(),
                     "total": float(metrics["total_loss"]),
                     "grads": _grads(model),
                     "stats": {n: b.cpu() for n, b in model.named_buffers()
                               if n.endswith(("running_mean",
                                              "running_var"))}})
    model.backbone.body.remat = False
    plain, again, remat = runs
    spread = _rel_diffs(again["grads"], plain["grads"])
    diff = _rel_diffs(remat["grads"], plain["grads"])
    limit = max(2 * max(spread.values()), REMAT_FLOOR)
    worst = max(diff, key=diff.get)
    stats_moved = _state_equal(torch, remat["stats"], plain["stats"],
                               list(plain["stats"]))
    plain_stats = not _state_equal(torch, again["stats"], plain["stats"],
                                   list(plain["stats"]))
    want = {k: 0 for k in plain["launches"]}
    log(f"[remat] full-backprop step (TUNE_POINT 0, PALLAS_KERNELS) bs 2, "
        f"peaks above the step's start: "
        f"plain {plain['ms']:.2f} / {again['ms']:.2f} ms, peak "
        f"{plain['peak_gb']:.2f} GB, launches {plain['launches']}; remat "
        f"{remat['ms']:.2f} ms, peak {remat['peak_gb']:.2f} GB, launches "
        f"{remat['launches']}; totals {[round(x['total'], 5) for x in runs]}"
        f"; the spread of two plain steps' gradients (largest relative L2) "
        f"{max(spread.values()):.3g}, remat against plain "
        f"{diff[worst]:.3g} ({worst}; limit {limit:.3g}); running "
        f"statistics bit-equal: remat {not stats_moved}, plain twice "
        f"{plain_stats}; {smi}")
    if not (plain["launches"] == again["launches"] == dict(
            want, depthwise=3, assign=1)
            and remat["launches"] == dict(want, depthwise=6, assign=1)
            and diff[worst] <= limit and not stats_moved
            and remat["peak_gb"] < plain["peak_gb"]
            and np.isfinite(remat["total"])):
        raise AssertionError("remat: launches, gradients, statistics or "
                             "memory not as the plain step's")
    del model, runs, saved
    return {"launches_plain": plain["launches"]["depthwise"],
            "launches": remat["launches"]["depthwise"],
            "launches_assign": remat["launches"]["assign"],
            "peak_gb": {"plain": plain["peak_gb"],
                        "remat": remat["peak_gb"]},
            "ms": {"plain": plain["ms"], "remat": remat["ms"]}}


def phase_moe(torch, stem, train: dict, stage_forward: dict, sdet,
              smi: str) -> dict:
    """MODEL.MOE_EXPERTS 4, top 2: 2 train_ava steps (loss_moe_aux finite,
    the expert stacks moved); the stage-path detector's keyframes, and its
    forward against the stage path's in turns; a pool bucket of 8 streams,
    each stream's keyframes bit-equal whatever the others push
    (_pool_rows_independent), with the sizes of the dense routing tensors; the card against the CPU port at small size."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    r = _train_run(torch, train, "chip_smoke_moe", lambda c: (
        c["DATA"].update(SYNTHETIC_SIZE=4), c["MODEL"].update(**MOE)))
    want = _train_launches(len(r["steps"]), 1, 4)
    aux = [m.get("loss_moe_aux", float("nan")) for _, m in r["steps"]]
    start = build_model(r["cfg"], device="cpu", seed=0,
                        train=True).state_dict()
    experts = [n for n in start if ".moe_ffn.expert_w" in n]
    still = [n for n in experts if torch.equal(r["final"][n], start[n])]
    frozen = _frozen_still(torch, r, train["start"])
    log(f"[moe] train_ava MOE_EXPERTS 4 top 2: losses "
        f"{[round(m['total_loss'], 4) for _, m in r['steps']]}, "
        f"loss_moe_aux {[round(a, 5) for a in aux]}; "
        f"{_step_ms(r['steps'])}; launches {r['launches']}; the "
        f"{len(experts)} expert tensors moved ({len(still)} unchanged), the "
        f"{frozen} frozen params bit-equal; peak device memory "
        f"{r['peak_gb']:.2f} GB above the run's start; wall "
        f"{r['wall']:.1f} s; {smi}")
    if (len(r["steps"]) != 2 or r["launches"] != want
            or not np.isfinite(aux).all()
            or len(experts) != 2 * r["cfg"].model.enc_layers or still):
        raise AssertionError(f"moe train: launches {r['launches']}, aux "
                             f"{aux}, unchanged experts {still[:3]}")
    det, launches, steady, fwd_ms = _option_serving(
        torch, "chip_smoke_moe_stages", MOE, "moe", stage_forward, sdet, smi)
    moe = det.model.transformer.encoder.layers[0].moe_ffn
    seen = []
    hook = moe.register_forward_hook(
        lambda m, args, out: seen.append(tuple(args[0].shape)))
    try:
        rows = _pool_rows_independent(torch, det, "moe")
    finally:
        hook.remove()
    b, s, _ = seen[0]
    e, cap = moe.num_experts, moe.capacity(s)
    n = b * s * e * cap
    log(f"[moe] the dense routing tensors of one MoE layer at {b} clips: S "
        f"{s} tokens a clip, E {e}, C {cap}: (B,S,E,C) {n} elements; the "
        f"float32 combine {n * 4 / 1e6:.2f} MB, the bf16 dispatch "
        f"{n * 2 / 1e6:.2f} MB, each of the {moe.top_k} slots' float32 "
        f"position one-hots {n * 4 / 1e6:.2f} MB")
    def small_moe(c):
        c.model.moe_experts, c.model.moe_top_k = 4, 2

    phase_small_reference(torch, stem, "moe", small_moe)
    return {"det": det, "train_launches": r["launches"],
            "serve_launches": launches,
            "steady_ms": steady, "rows_independent": rows,
            "train_steady_ms": r["steps"][-1][0], "forward_ms": fwd_ms,
            "routing": {"S": s, "E": e, "C": cap}}


def _option_serving(torch, name: str, model_keys: dict, tag: str,
                    stage_forward: dict, sdet, smi: str):
    """The stage-path detector with ``model_keys`` set on the flagship
    YAML: phase_main_path's keyframes and launches; then one forward of it
    and of the stage path's own detector ``sdet`` in turns."""
    cfg_path = write_config(f"{name}.yaml", lambda c: c["MODEL"].update(
        PALLAS_KERNELS=True, FUSED_BLOCKS=True, FUSED_STAGES=True,
        **model_keys))
    det, launches, steady = phase_main_path(torch, cfg_path, f"{tag} stages",
                                            stage_forward)
    ms = _alternating_forward_ms(torch, {tag: det.model,
                                         "stage path": sdet.model})
    log(f"[{tag}] one flagship forward, {tag} against the stage path, 10 "
        f"alternating pairs: median {ms[tag]:.3f} vs "
        f"{ms['stage path']:.3f} ms; {smi}")
    return det, launches, steady, ms


def _alternating_forward_ms(torch, models: dict, pairs: int = 10) -> dict:
    """Host wall time of one flagship forward (ending in a sync) of each of
    two models, in turns (a, b, b, a, ...) in one process after a warm-up
    pair: the median ms of each."""
    from tubelet_transformer_tpu_torch.data.device_preprocess import (
        device_preprocess)

    names = list(models)
    clip = torch.zeros((1, 32, 256, 256, 3), dtype=torch.uint8, device="cuda")
    times = {n: [] for n in names}
    with torch.inference_mode():
        xs = {n: device_preprocess(clip, dtype=m.dtype)
              for n, m in models.items()}
        for i in range(2 * pairs + 2):
            n = names[0] if (i % 4) in (0, 3) else names[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            models[n](xs[n])
            torch.cuda.synchronize()
            if i >= 2:
                times[n].append((time.perf_counter() - t0) * 1e3)
    return {n: statistics.median(v) for n, v in times.items()}


def _pool_rows_independent(torch, det, tag: str) -> bool:
    """A StreamingDetectorPool (max_batch 8) on the detector's model and
    config, 8 streams of POOL_GEOMETRIES from tick 0, so that every forward
    is a bucket of 8, run twice: streams 0 and 7 push the same frames both
    times, streams 1-6 the levels of streams 6-1 the second time. Each keyframe result
    of streams 0 and 7 (scores, boxes, actor probabilities) must be
    bit-equal across the two runs, and stream 1's must differ (the
    control: the other rows did change)."""
    from tubelet_transformer_tpu_torch.serving import StreamingDetectorPool

    kw = dict(fps=8.0, detect_every=8, actor_threshold=-1.0, device="cuda")
    runs, buckets = [], set()
    for swap in (False, True):
        pool = StreamingDetectorPool(det.cfg, det.model, max_batch=8,
                                     instrument=True, **kw)
        frames = [pool_frames(7 - i if swap and i not in (0, 7) else i,
                              h, w)
                  for i, (h, w) in enumerate(POOL_GEOMETRIES)]
        results = {i: [] for i in range(8)}
        for tick in range(POOL_TICKS):
            for i in range(8):
                pool.push_frame(i, frames[i][tick % 16])
            for sid, res in pool.step().items():
                results[sid].append(res)
            buckets |= {(f["bucket"], f["streams"])
                        for f in pool.last_timing}
        runs.append({sid: [np.concatenate([np.concatenate(
            [d.scores.ravel(), d.box.ravel(), [d.actor_prob]])
            for d in r.detections]) for r in rs]
            for sid, rs in results.items()})
        del pool

    def same(sid):
        a, b = runs[0][sid], runs[1][sid]
        return len(a) == len(b) > 0 and all(
            np.array_equal(x, y) for x, y in zip(a, b))

    ok = same(0) and same(7)
    control = not same(1)
    log(f"[{tag}] StreamingDetectorPool, 8 streams from tick 0, forwards "
        f"(bucket, streams) {sorted(buckets)}, twice with streams 1-6 fed "
        f"other frames the second time: streams 0 and 7's "
        f"{len(runs[0][0])} + {len(runs[0][7])} keyframes bit-equal across "
        f"the runs: {ok}; control, stream 1's differ: {control}")
    if not (ok and control and buckets == {(8, 8)}):
        raise AssertionError(f"{tag}: a pool row depends on the other rows, "
                             f"or the control did not change (buckets "
                             f"{buckets})")
    return ok


def phase_prenorm(torch, stem, train: dict, stage_forward: dict, sdet,
                  smi: str) -> dict:
    """MODEL.NORMALIZE_BEFORE: the stage-path detector's keyframes, and its
    forward against the stage path's in turns; two flagship train steps
    (TUNE_POINT 4) finite; the card against the CPU port at small size."""
    import copy

    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import engine

    det, launches, steady, fwd_ms = _option_serving(
        torch, "chip_smoke_prenorm_stages", {"NORMALIZE_BEFORE": True},
        "pre-norm", stage_forward, sdet, smi)
    if det.model.transformer.encoder.norm is None:
        raise AssertionError("pre-norm: no encoder norm")
    cfg = copy.deepcopy(train["cfg"])
    cfg.model.normalize_before = True
    model = build_model(cfg, device="cuda", seed=0, train=True)
    step = engine.make_train_step(
        cfg, engine.create_train_state(cfg, model, steps_per_epoch=1))
    batch = _train_batch(torch, cfg)
    times = []
    zero_counts()
    for _ in range(2):
        t = time.perf_counter()
        metrics = step(batch, cfg.loss.dice_cof)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    step_launches = launch_counts()
    log(f"[pre-norm] flagship train step, NORMALIZE_BEFORE, TUNE_POINT "
        f"{cfg.model.tune_point}, bs {cfg.train.batch_size}: total loss "
        f"{float(metrics['total_loss']):.5f}, finite "
        f"{float(metrics['finite'])}; step ms {[round(t, 2) for t in times]}"
        f" (the second steady); launches {step_launches}; {smi}")
    if not (metrics["finite"] == 1.0 and step_launches == _train_launches(
            2, 1, 0)):
        raise AssertionError(f"pre-norm train step: launches "
                             f"{step_launches} or a loss not finite")
    del model, step
    def small_prenorm(c):
        c.model.normalize_before = True

    phase_small_reference(torch, stem, "pre-norm", small_prenorm)
    return {"det": det, "serve_launches": launches, "steady_ms": steady,
            "train_ms": times[-1], "forward_ms": fwd_ms}


def phase_profile(torch, train: dict) -> None:
    """LOG.PROFILE_STEPS 2 through train_ava (3 steps): a Chrome trace
    under <log dir>/profile that names the stem statistics kernel."""
    r = _train_run(torch, train, "chip_smoke_profile", lambda c: (
        c["DATA"].update(SYNTHETIC_SIZE=6),
        c["LOG"].update(PROFILE_STEPS=2)))
    traces = glob.glob(str(r["run"] / r["cfg"].log.log_dir / "profile"
                           / "*.json"))
    kernels = set()
    for path in traces:
        with open(path) as f:
            kernels |= {e.get("name", "") for e in json.load(f).get(
                "traceEvents", []) if e.get("cat") == "kernel"}
    stats = sorted(k for k in kernels if "stem_stats" in k)
    log(f"[profile] train_ava LOG.PROFILE_STEPS 2: {len(r['steps'])} steps, "
        f"{_step_ms(r['steps'])}; traces "
        f"{[str(Path(p).relative_to(ROOT)) for p in traces]} "
        f"({sum(Path(p).stat().st_size for p in traces) / 1e6:.1f} MB), "
        f"{len(kernels)} kernel names, the stem statistics kernels {stats}")
    if len(traces) != 1 or not stats:
        raise AssertionError(f"profile: traces {traces}, stem statistics "
                             f"kernels {stats}")


CLASSIFY_SHAPE = (2, 32, 224, 224, 3)   # two Kinetics-style clips
CLASSIFY_CLASSES = 400
CLASSIFY_STEPS = 4
# the card against the CPU at CSN-TINY, float32 with TF32 off: summation
# order through 13 convs and batch statistics, relative to max |logit|
CLASSIFY_TOL = 1e-4
# the segmentation heads at the flagship's widths (d 256, 8 heads, 15
# queries over a 256-px keyframe's 16x16 memory; the FPN maps shaped like
# CSN-152's layers 3/2/1 at 256 px), card against CPU, float32, TF32 off:
# the maps within SEG_MAP_TOL, the mask logits within SEG_TOL of their
# largest magnitude, the losses within SEG_LOSS_RTOL
SEG_QUERIES, SEG_D, SEG_HEADS = 15, 256, 8
SEG_FPN = ((1024, 16), (512, 32), (256, 64))
SEG_TARGET = 256
SEG_MAP_TOL, SEG_TOL, SEG_LOSS_RTOL = 1e-6, 1e-4, 1e-5
# the flagship's pool_decoder cross-attention (E 2048, 8 heads) over one
# 256-px keyframe's 16x16 locations, one query, the flagship's T' = 4
# window, 64 rolling steps; float32 with TF32 off, each step against the
# full recompute of its window within STREAM_RTOL and STREAM_ATOL x max|out|
STREAM_B, STREAM_E, STREAM_W, STREAM_STEPS = 256, 2048, 4, 64
STREAM_RTOL, STREAM_ATOL = 1e-5, 1e-5


def _no_tf32(torch):
    """Turn TF32 off; returns the undo."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def undo():
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved

    return undo


def _adamw(torch, model):
    """optax.adamw(1e-3)'s settings, stated: torch's default weight decay
    is 1e-2, optax's 1e-4."""
    return torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def phase_classify(torch, smi: str) -> None:
    """The classification trainer at full width: VideoClassifier(CSN-152,
    400 classes) on (2, 32, 224, 224, 3) float32 clips with TF32 off, 4
    steps of train_classification with an explicit AdamW: the loss finite
    on every step, every parameter and running statistic moved, every
    tensor on the card; the step times and the peak memory above a step's
    start. Then CSN-TINY on a small input: the step's loss and the
    train-mode logits after it, card against CPU."""
    from tubelet_transformer_tpu_torch.train import classify
    from tubelet_transformer_tpu_torch.utils import MetricsWriter

    undo = _no_tf32(torch)
    try:
        model = classify.build_classifier("CSN-152", CLASSIFY_CLASSES,
                                          seed=0, device="cuda")
        state = classify.create_classifier_state(model, _adamw(torch, model))
        step = classify.make_classification_train_step(state)
        g = torch.Generator(device="cuda").manual_seed(0)
        batches = [{"clips": torch.randn(CLASSIFY_SHAPE, generator=g,
                                         device="cuda"),
                    "labels": torch.randint(0, CLASSIFY_CLASSES, (2,),
                                            generator=g, device="cuda")}
                   for _ in range(CLASSIFY_STEPS)]
        start = {k: v.detach().clone() for k, v in
                 model.state_dict().items()}
        runs: list = []

        def timed(clips, labels):
            window = _peak_from(torch)
            t = time.perf_counter()
            loss = step(clips, labels)
            torch.cuda.synchronize()
            runs.append(((time.perf_counter() - t) * 1e3,
                         _peak_gb(torch, window), loss))
            return loss

        writer = MetricsWriter(str(BUILD_DIR / "chip_smoke_classify"))
        t0 = time.perf_counter()
        base_iter, state = classify.train_classification(
            0, state, timed, batches, 0, display_freq=2,
            lr_fn=state.schedule, writer=writer)
        writer.close()
        wall = time.perf_counter() - t0
        losses = [float(loss) for _, _, loss in runs]
        end = model.state_dict()
        stale = [k for k in start if not k.endswith("num_batches_tracked")
                 and torch.equal(start[k], end[k])]
        tensors = [*model.parameters(), *model.buffers(),
                   *(t for s in state.optimizer.state.values()
                     for t in s.values() if torch.is_tensor(t)
                     and t.dim() > 0)]
        off_card = sum(t.device.type != "cuda" for t in tensors)
        ms = [round(m, 2) for m, _, _ in runs]
        peak = max(p for _, p, _ in runs[1:])
        log(f"[classify] CSN-152, {CLASSIFY_CLASSES} classes, "
            f"{CLASSIFY_SHAPE} float32 (TF32 off), AdamW lr 1e-3 wd 1e-4: "
            f"{base_iter} steps, losses {[round(v, 4) for v in losses]}; "
            f"{len(start) - len(stale)} of {len(start)} tensors moved "
            f"(num_batches_tracked aside); {len(tensors)} tensors, "
            f"{off_card} off the card; wall {wall:.1f} s")
        log(f"[classify] step ms {ms} (steps 2-4 median "
            f"{statistics.median(ms[1:]):.2f}); peak memory above a step's "
            f"start {peak:.2f} GB; {smi}")
        if (base_iter != CLASSIFY_STEPS or not all(np.isfinite(losses))
                or stale or off_card):
            raise AssertionError(f"classify: steps {base_iter}, losses "
                                 f"{losses}, unmoved {stale[:5]}, off the "
                                 f"card {off_card}")
        del model, state, batches, start, end, runs, tensors
        torch.cuda.empty_cache()

        x = torch.randn(2, 8, 64, 64, 3, generator=torch.Generator()
                        .manual_seed(1))
        labels = torch.tensor([0, 3])
        small = {}
        for dev in ("cpu", "cuda"):
            m = classify.build_classifier("CSN-TINY", 5, seed=1, device=dev)
            before = [p.detach().cpu().clone() for p in m.parameters()]
            s = classify.create_classifier_state(m, _adamw(torch, m))
            with torch.no_grad():
                logits = m(x.to(dev)).cpu()
            loss = classify.make_classification_train_step(s)(
                x.to(dev), labels.to(dev))
            small[dev] = (loss.reshape(1).cpu(), logits, [
                (p.detach().cpu() - b, p.grad.cpu())
                for p, b in zip(m.parameters(), before)])
        err = max(float((a - b).abs().max() / b.abs().max()) for a, b in
                  zip(small["cuda"][:2], small["cpu"][:2]))
        # the first AdamW step moves a weight by lr * g / (|g| + eps): the
        # updates agree to 1e-3 lr but where g is near zero, whose sign the
        # summation order may flip; the largest gap is reported, not held
        upd, stray, n_off, n_all = 0.0, 0.0, 0, 0
        for (dg, _), (dw, g) in zip(small["cuda"][2], small["cpu"][2]):
            diff = (dg - dw).abs()
            upd = max(upd, float(diff.max()) / 1e-3)
            off = diff > 1e-6
            n_off, n_all = n_off + int(off.sum()), n_all + off.numel()
            if off.any():
                stray = max(stray, float(g[off].abs().max()
                                         / g.square().mean().sqrt()))
        log(f"[classify] CSN-TINY (2,8,64,64,3), one AdamW step, card "
            f"against CPU: the train-mode logits and the step's loss within "
            f"{err:.3g} of max|value| (limit {CLASSIFY_TOL}); the updates "
            f"within {upd:.3g} lr, apart by more than 1e-3 lr at "
            f"{n_off} of {n_all} weights (limit 0.1%), each with |g| <= "
            f"{stray:.3g} of its tensor's rms (limit 0.05)")
        if not (err <= CLASSIFY_TOL and stray <= 0.05
                and n_off <= 1e-3 * n_all):
            raise AssertionError(f"classify small: {err}, {stray}, {n_off}")
    finally:
        undo()


def phase_segmentation(torch, smi: str) -> None:
    """The segmentation heads and mask losses at the flagship's widths on
    the card against the same port code on the CPU, float32 with TF32 off:
    MHAttentionMap(256, 256, 8) of 15 queries over a (1, 256, 16, 16)
    memory with padded pixels, MaskHeadSmallConv(256 + 8, (1024, 512, 256),
    256) over FPN maps at 16, 32 and 64 px, loss_masks against 256x256
    targets with padded rows, postprocess_masks to 256x256; with their
    times on the card."""
    import copy

    from tubelet_transformer_tpu_torch.models import segmentation as seg

    undo = _no_tf32(torch)
    try:
        rng = np.random.default_rng(0)
        q = rng.normal(size=(1, SEG_QUERIES, SEG_D)).astype(np.float32)
        mem = rng.normal(size=(1, SEG_D, 16, 16)).astype(np.float32)
        mask = np.zeros((1, 16, 16), bool)
        mask[:, 12:, :] = True
        fpns = [rng.normal(size=(1, c, s, s)).astype(np.float32)
                for c, s in SEG_FPN]
        n_live = 10
        tgt = (rng.uniform(size=(SEG_QUERIES, SEG_TARGET, SEG_TARGET))
               > 0.5).astype(np.float32)
        valid = np.arange(SEG_QUERIES) < n_live
        attn = seg.MHAttentionMap(SEG_D, SEG_D, SEG_HEADS)
        head = seg.MaskHeadSmallConv(SEG_D + SEG_HEADS,
                                     [c for c, _ in SEG_FPN], SEG_D)
        for i, m in enumerate((attn, head)):
            seg.init_weights(m, torch.Generator().manual_seed(i))
        mods = {"cpu": (attn, head),
                "cuda": tuple(copy.deepcopy(m).cuda() for m in (attn, head))}

        def run(dev):
            a, h = mods[dev]
            def t(v):
                return torch.from_numpy(v).to(dev)

            with torch.no_grad():
                maps = a(t(q), t(mem), t(mask))
                logits = h(t(mem), maps, [t(f) for f in fpns])
                pred = logits[:, 0]
                losses = seg.loss_masks(pred, t(tgt), t(valid), n_live)
                masks = seg.postprocess_masks(pred[None], (SEG_TARGET,
                                                           SEG_TARGET))
            return {"maps": maps, "logits": logits, "losses": torch.stack(
                [losses["loss_mask"], losses["loss_dice"]]), "masks": masks,
                "up": seg._bilinear(pred[None], (SEG_TARGET, SEG_TARGET))}

        got, want = ({k: v.cpu() for k, v in run(d).items()}
                     for d in ("cuda", "cpu"))
        map_err = float((got["maps"] - want["maps"]).abs().max())
        logit_err = float((got["logits"] - want["logits"]).abs().max()
                          / want["logits"].abs().max())
        loss_err = float(((got["losses"] - want["losses"]).abs()
                          / want["losses"].abs()).max())
        away = (want["up"].sigmoid() - 0.5).abs() > 1e-4
        flips = int((got["masks"] != want["masks"])[away].sum())
        a, h = mods["cuda"]
        dq, dmem, dmask = (torch.from_numpy(v).cuda() for v in (q, mem, mask))
        dfpn = [torch.from_numpy(f).cuda() for f in fpns]
        with torch.no_grad():
            dmaps = a(dq, dmem, dmask)
            dpred = h(dmem, dmaps, dfpn)[:, 0]
            dtgt, dvalid = (torch.from_numpy(v).cuda() for v in (tgt, valid))
            times = {
                "mh_attention_map": time_ms(torch, lambda: a(dq, dmem,
                                                             dmask)),
                "mask_head": time_ms(torch, lambda: h(dmem, dmaps, dfpn)),
                "loss_masks": time_ms(torch, lambda: seg.loss_masks(
                    dpred, dtgt, dvalid, n_live)),
                "postprocess_masks": time_ms(torch, lambda: (
                    seg.postprocess_masks(dpred[None], (SEG_TARGET,
                                                        SEG_TARGET))))}
        log(f"[segmentation] card against CPU, float32 (TF32 off): the maps "
            f"{tuple(got['maps'].shape)} within {map_err:.3g} (limit "
            f"{SEG_MAP_TOL}); the mask logits {tuple(got['logits'].shape)} "
            f"within {logit_err:.3g} of max|logit| (limit {SEG_TOL}); "
            f"loss_mask / loss_dice {got['losses'].tolist()} within "
            f"{loss_err:.3g} relative (limit {SEG_LOSS_RTOL}); "
            f"postprocess_masks {tuple(got['masks'].shape)}: {flips} flips "
            f"away from the 0.5 boundary ({int(away.sum())} pixels)")
        log(f"[segmentation] ms on the card (back to back): "
            f"{ {k: round(v, 4) for k, v in times.items()} }; {smi}")
        if not (map_err <= SEG_MAP_TOL and logit_err <= SEG_TOL
                and loss_err <= SEG_LOSS_RTOL and flips == 0
                and all(bool(torch.isfinite(v.float()).all())
                        for v in got.values())):
            raise AssertionError("segmentation: card and CPU disagree")
    finally:
        undo()


def phase_streaming(torch, smi: str) -> None:
    """The rolling KV-cache attention on the flagship's pool_decoder
    cross-attention (E 2048, 8 heads): 256 rows (a 256-px keyframe's 16x16
    locations), one query, a window of T' = 4 positioned by the 1-D table,
    64 rolling steps, each against streaming_init + streaming_attend on
    the rolled window; the first pass against the module's own forward on
    the same window. float32, TF32 off; the step's and the recompute's
    times on the card."""
    from tubelet_transformer_tpu_torch.models.layers import LSTRDecoderLayer
    from tubelet_transformer_tpu_torch.models.tuber import init_weights
    from tubelet_transformer_tpu_torch.ops import streaming
    from tubelet_transformer_tpu_torch.ops.position_encoding import (
        positional_encoding_1d)

    undo = _no_tf32(torch)
    try:
        layer = LSTRDecoderLayer(STREAM_E, 8, 2048)
        init_weights(layer, torch.Generator().manual_seed(0))
        attn = layer.multihead_attn.cuda().eval()
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(STREAM_B, 1, STREAM_E, generator=g, device="cuda")
        window = torch.randn(STREAM_B, STREAM_W, STREAM_E, generator=g,
                             device="cuda")
        toks = torch.randn(STREAM_STEPS, STREAM_B, 1, STREAM_E, generator=g,
                           device="cuda")
        pos = positional_encoding_1d(STREAM_W, STREAM_E, device="cuda")
        pos_err = float((pos.cpu() - positional_encoding_1d(
            STREAM_W, STREAM_E)).abs().max())
        pos = pos.expand(STREAM_B, -1, -1)

        def recompute(w):
            return streaming.streaming_attend(attn, streaming.streaming_init(
                attn, q, w, pos))

        errs = []
        with torch.no_grad():
            state = streaming.streaming_init(attn, q, window, pos)
            first = streaming.streaming_attend(attn, state)
            kv = window + pos
            module = attn(q, kv, kv)
            first_err = float((first - module).abs().max()
                              / module.abs().max())
            for t in range(STREAM_STEPS):
                out, state = streaming.streaming_step(attn, state, toks[t])
                window = torch.cat([window[:, 1:], toks[t]], 1)
                want = recompute(window)
                errs.append(float(((out - want).abs() - STREAM_RTOL
                                   * want.abs()).max() / want.abs().max()))
            finite = bool(torch.isfinite(out).all())
            step_ms = time_ms(torch, lambda: streaming.streaming_step(
                attn, state, toks[0]))
            full_ms = time_ms(torch, lambda: recompute(window))
        log(f"[streaming] E {STREAM_E}, 8 heads, {STREAM_B} rows, 1 query, "
            f"window {STREAM_W}, {STREAM_STEPS} rolling steps, float32 (TF32 "
            f"off): each step against the full recompute, the largest "
            f"excess over rtol {STREAM_RTOL} {max(errs):.3g} of max|out| "
            f"(limit {STREAM_ATOL}); the first pass against the module's "
            f"forward {first_err:.3g} of max|out|; the 1-D table on the card "
            f"against the CPU {pos_err:.3g}")
        log(f"[streaming] ms on the card: a rolling step {step_ms:.4f}, the "
            f"full recompute of the window {full_ms:.4f}; {smi}")
        if not (max(errs) <= STREAM_ATOL and first_err <= STREAM_ATOL
                and pos_err <= 1e-6 and finite):
            raise AssertionError(f"streaming: steps {max(errs)}, first pass "
                                 f"{first_err}, table {pos_err}")
    finally:
        undo()


def _cli(module: str, *argv) -> subprocess.CompletedProcess:
    """``python -m tubelet_transformer_tpu_torch.cli.<module> argv`` from
    the repository root, as a user runs it."""
    return subprocess.run(
        [sys.executable, "-m", f"tubelet_transformer_tpu_torch.cli.{module}",
         *map(str, argv)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)


def phase_export(torch, train: dict, eval_cfg: Path) -> None:
    """The export CLI on the train phase's checkpoint: the .pth loaded
    through load_tuber_pth into a fresh build equals the checkpoint bit for
    bit, and one eval forward from it equals one from the checkpoint bit
    for bit; the MoE and the pre-norm configurations are refused with a
    nonzero exit. Then validate_ava with a dump directory on the exported
    weights: 0.txt and the PR-curve panel, or its skip line where
    matplotlib is missing."""
    import contextlib
    import io

    from tubelet_transformer_tpu_torch.cli import runner
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import engine, loop

    out = BUILD_DIR / "chip_smoke_export.pth"
    t0 = time.perf_counter()
    res = _cli("export_torch", "--config-file", eval_cfg, "--out", out,
               "--device", "cuda")
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"export_torch: {res.stderr[-2000:]}")
    exported = torch.load(out, map_location="cpu", weights_only=True)["model"]
    saved = torch.load(train["ckpt"], map_location="cpu",
                       weights_only=True)["model"]
    if sorted(exported) != sorted(f"module.{k}" for k in saved):
        raise AssertionError("export: keys differ from the checkpoint's")
    cfg_path = write_config("chip_smoke_export.yaml", lambda c: c[
        "MODEL"].update(PRETRAINED_PATH=str(out)), source=eval_cfg)
    cfg = load_config(str(cfg_path))
    fresh = build_model(cfg, device="cuda", seed=7, train=True,
                        pretrained=True).state_dict()
    bad = _state_equal(torch, fresh, saved, saved)
    models = {name: build_model(load_config(str(p)), device="cuda", seed=7,
                                pretrained=True)
              for name, p in (("ckpt", eval_cfg), ("export", cfg_path))}
    clip = torch.randn(1, 32, 256, 256, 3, generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda")
    pad = torch.zeros(1, 256, 256, dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        outs = {k: m(clip, pad) for k, m in models.items()}
    differ = [k for k in outs["ckpt"]
              if not torch.equal(outs["ckpt"][k], outs["export"][k])]
    # a refusal is the CLI's NotImplementedError naming the option, not any
    # nonzero exit: an import error or a bad config would exit nonzero too
    refused, wrong = {}, []
    for name, option, edit in (
            ("moe", "MODEL.MOE_EXPERTS",
             lambda c: c["MODEL"].update(MOE)),
            ("pre-norm", "MODEL.NORMALIZE_BEFORE",
             lambda c: c["MODEL"].update(NORMALIZE_BEFORE=True))):
        p = write_config(f"chip_smoke_export_{name}.yaml", edit,
                         source=eval_cfg)
        target = BUILD_DIR / f"chip_smoke_export_{name}.pth"
        target.unlink(missing_ok=True)
        r = _cli("export_torch", "--config-file", p, "--out", target,
                 "--device", "cuda")
        last = r.stderr.strip().splitlines()[-1:]
        refused[name] = (r.returncode, last)
        if (r.returncode == 0 or target.exists() or not last
                or not last[0].startswith("NotImplementedError")
                or option not in last[0]):
            wrong.append(name)
    log(f"[export] export_torch on {train['ckpt'].relative_to(ROOT)}: "
        f"{len(exported)} module.-prefixed tensors in {wall:.1f} s (the "
        f"process included); loaded through load_tuber_pth into a fresh "
        f"build, bit-equal to the checkpoint: {not bad}; one eval forward "
        f"bit-equal to the checkpoint's: {not differ} ({sorted(outs['ckpt'])})"
        f"; refused: {refused}")
    if bad or differ or wrong:
        raise AssertionError(f"export: state differs {bad[:3]}, outputs "
                             f"differ {differ}, not refused as expected "
                             f"{wrong}: {refused}")

    # validate_ava with a dump directory on the exported weights
    model = models["export"]
    del models["ckpt"], outs
    dump = BUILD_DIR / "chip_smoke_dump"
    for old in dump.glob("*"):
        old.unlink()
    _, val_loader = runner.make_loaders(cfg, val_only=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = loop.validate_ava(cfg, engine.make_eval_step(cfg, model),
                                   model, val_loader, 0,
                                   dump_dir=str(dump))
    printed = buf.getvalue()
    png = dump / "pr_epoch_0.png"
    skipped = [line for line in printed.splitlines()
               if line.startswith("PR plot skipped")]
    drew = png.exists() and png.read_bytes()[:4] == b"\x89PNG"
    log(f"[plots] validate_ava with a dump directory: 0.txt "
        f"{(dump / '0.txt').exists()}, frame mAP {result['mAP']:.4f}; "
        + (f"wrote {png.relative_to(ROOT)} ({png.stat().st_size} bytes)"
           if drew else f"the PR plot skipped: {skipped}"))
    if not (dump / "0.txt").exists() or drew == bool(skipped):
        raise AssertionError(f"validate_ava dump: png {drew}, skip lines "
                             f"{skipped}")


def phase_pack(torch, jhmdb: dict) -> None:
    """The pack_data CLI on the JHMDB fixture's val split, then eval_jhmdb
    with DATA.PACKED_PATH on it against eval_jhmdb on the unpacked frames,
    with the same weights: every eval step's scores and boxes, and the
    frame and video mAP, bit for bit."""
    from tubelet_transformer_tpu_torch.cli import eval_jhmdb, runner
    from tubelet_transformer_tpu_torch.train import engine

    packed = BUILD_DIR / "jhmdb_packed_val"
    t0 = time.perf_counter()
    res = _cli("pack_data", "--config-file", jhmdb["eval_cfg"], "--split",
               "val", "--out", packed, "--workers", "4")
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"pack_data: {res.stderr[-2000:]}")
    packed_cfg = write_config(
        "chip_smoke_jhmdb_packed.yaml", lambda c: c["DATA"].update(
            PACKED_PATH=str(BUILD_DIR / "jhmdb_packed_{}")),
        source=jhmdb["eval_cfg"])
    results = {}
    make = engine.make_eval_step
    for name, p in (("unpacked", jhmdb["eval_cfg"]), ("packed", packed_cfg)):
        outs: list = []

        def recording(cfg_, model, _outs=outs, **kw):
            step = make(cfg_, model, **kw)

            def rec(batch):
                out = step(batch)
                _outs.append({k: out[k].clone() for k in ("scores",
                                                          "boxes")})
                return out

            return rec

        runs: list = []
        undo = _capture(runner, "run_eval", runs)
        engine.make_eval_step = recording
        try:
            _run_cli(eval_jhmdb, ["--config-file", str(p), "--device",
                                  "cuda"])
        finally:
            engine.make_eval_step = make
            undo()
        results[name] = (runs[0]["val"], outs)
        del runs
    (want, wout), (got, gout) = results["unpacked"], results["packed"]
    same = len(gout) == len(wout) and all(
        torch.equal(a[k], b[k]) for a, b in zip(gout, wout) for k in a)
    log(f"[pack] pack_data on the JHMDB fixture's val split in {wall:.1f} s "
        f"(the process included): {sorted(x.name for x in packed.iterdir())}"
        f"; eval_jhmdb with DATA.PACKED_PATH against the unpacked frames: "
        f"{len(gout)} eval steps' scores and boxes bit-equal: {same}; "
        f"frame and video mAP {got} against {want}")
    if not same or got != want:
        raise AssertionError("pack: packed and unpacked evals differ")


# phase 23: data parallelism over torch.distributed, two ranks on one card
DP_RANKS = 2
DP_TIMEOUT = 600
# the DP step of 2 ranks x 2 clips against the one-process step on the
# global batch of 4 from one state (tools/dp_check.py, flagship width,
# deterministic algorithms): each reading's bound, in bf16 (the train
# path) and in float32 with TF32 off; the control (each rank's own BN
# statistics and loss normalisers, losses and gradients averaged) must
# miss every one. In bf16 the two steps' losses, gradients, gradient
# norms and running statistics part by about as much as the control's
# (gradients 0.115-0.146 against the control's 0.116-0.144, losses
# 0.0070-0.0077 against 0.012-0.098, over two seeds; not isolated: the
# kernels picked for 2 and for 4 clips round otherwise, and a matching
# near a tie at random init can flip): bf16 bounds the stem's statistics alone, float32 every
# reading. The bounds sit between the two seeds' readings and their
# controls' (float32: losses 1.1e-5-3.0e-5 against 0.012-0.099, gradient
# norm 2.5e-5-8.0e-5 against 0.0036-0.011, gradients 0.0087-0.0093
# against 0.116-0.143, running statistics 1.7e-5-2.2e-5 against 0.028;
# the stem's mean and variance 3.5e-8-7.0e-8 against 8e-1 and 1e-3)
DP_TOL = {"bfloat16": {"stem_mean_rel": 1e-5, "stem_var_rel": 1e-5},
          "float32": {"stem_mean_rel": 1e-5, "stem_var_rel": 1e-5,
                      "loss_rel": 1e-3, "grad_norm_rel": 1e-3,
                      "grads_rel": 0.04, "running_update_rel": 1e-3}}


# the MoE DP step (MOE, float32, TF32 off) against one process, and the
# classifier's DP step (CSN-152, 400 classes, 2 x (32, 224, 224) clips a
# rank) against one process on the 4: each bound between two seeds'
# readings and their controls' (LocalMesh: the MoE counts, the BN
# statistics and the loss normalisers of each rank's own shard). MoE:
# the load-balance loss 5.0e-6-1.6e-5 against 3.8e-4-4.2e-4, the losses
# 3.8e-4-1.2e-3 against 0.098-0.111 (the plain model reads 1.1e-5-3.0e-5;
# not isolated: a routing or matching near a tie can flip), the gradient
# norm 3.2e-5-9.4e-5 against 0.0065-0.022, the gradients 0.0076-0.0091
# against 0.100-0.133, the running statistics 1.9e-5-2.2e-5 against
# 0.028. The classifier: the loss 8.5e-6-9.2e-6 against 0.0047-0.0074,
# the running statistics 3.7e-5-4.7e-5 against 0.053-0.054, the
# gradients 0.094-0.105 against 1.32-1.33 (on the CPU at CSN-TINY 7.6e-6;
# here every one of CSN-152's BNs trains, and the trunk's max-pool
# backward has no deterministic CUDA kernel: the one-process step against
# a repeat of itself is read beside it as "repeat")
MOE_DP_TOL = {"moe_aux_rel": 1e-4, "loss_rel": 1e-2, "grad_norm_rel": 1e-3,
              "grads_rel": 0.04, "running_update_rel": 1e-3,
              "stem_mean_rel": 1e-5, "stem_var_rel": 1e-5}
CLASSIFIER_DP_TOL = {"loss_rel": 1e-3, "grads_rel": 0.5,
                     "running_update_rel": 1e-3}


def _torchrun_start(nproc: int, module: str, argv: list, log_name: str,
                    script: bool = False) -> dict:
    """Start ``python -m torch.distributed.run --standalone
    --nproc_per_node nproc -m module argv`` (``module`` a script's path
    with ``script``) from the repository root in a session of its own, its
    output in build/<log_name>; ``_torchrun_wait`` ends it."""
    path = BUILD_DIR / log_name
    f = open(path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), *([] if script else ["-m"]),
         module, *map(str, argv)],
        cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
        start_new_session=True)
    return {"proc": proc, "file": f, "path": path, "name": log_name,
            "nproc": nproc, "t0": time.perf_counter(), "start": time.time()}


def _torchrun_wait(job: dict) -> str:
    """Wait for a job of ``_torchrun_start``; the whole session is killed
    when DP_TIMEOUT (from its start) runs out. Raises unless it exits 0;
    logs its wall seconds and rank 0's ``[time]`` marks; returns the
    output."""
    proc = job["proc"]
    try:
        rc = proc.wait(timeout=max(1.0, DP_TIMEOUT - (
            time.perf_counter() - job["t0"])))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    job["file"].close()
    job["wall"] = time.perf_counter() - job["t0"]
    text = job["path"].read_text()
    if rc != 0:
        # the first rank's traceback, then the end of the log
        first = text.find("Traceback")
        head = text[first:first + 3000] if first >= 0 else ""
        raise AssertionError(f"{job['name']}: exit {rc}:\n{head}\n...\n"
                             f"{text[-3000:]}")
    log(f"[time] torchrun {job['name']} ({job['nproc']} processes): "
        f"{job['wall']:.1f} s, from {job['start']:.3f} to {time.time():.3f} "
        f"on the wall clock; the ranks' marks: "
        f"{[x[7:] for x in text.splitlines() if x.startswith('[time] ')]}")
    return text


def _torchrun(nproc: int, module: str, argv: list, log_name: str,
              script: bool = False) -> str:
    """``_torchrun_start`` then ``_torchrun_wait``."""
    return _torchrun_wait(_torchrun_start(nproc, module, argv, log_name,
                                          script))


def _kill_jobs(jobs) -> None:
    """Kill every job of ``_torchrun_start`` still running (a stage that
    failed leaves none behind)."""
    for job in jobs:
        if job["proc"].poll() is None:
            os.killpg(job["proc"].pid, signal.SIGKILL)
            job["proc"].wait()
        job["file"].close()


def _dist_lines(text: str, backend: str, world: int, devices) -> list:
    """The ranks' "distributed:" lines; raises unless each rank printed
    one with ``backend``, ``world`` and its device."""
    lines = sorted(re.findall(r"distributed: backend \S+, world \d+, rank "
                              r"\d+, device cuda:\d+", text))
    want = sorted(f"distributed: backend {backend}, world {world}, rank "
                  f"{r}, device {devices[r]}" for r in range(world))
    if lines != want:
        raise AssertionError(f"distributed lines {lines}, want {want}")
    return lines


def _dp_train_start(train: dict, name: str, edit) -> dict:
    """Start train_ava through torchrun, 2 ranks on cuda:0 over gloo, on
    phase 9's YAML with ``edit``, as experiment ``name``."""
    cfg_path = write_config(f"{name}.yaml", lambda c: (c["LOG"].update(
        EXP_NAME=name, DISPLAY_FREQ=1), edit(c)), source=train["cfg_path"])
    job = _torchrun_start(DP_RANKS,
                          "tubelet_transformer_tpu_torch.cli.train_ava",
                          ["--config-file", cfg_path, "--device", "cuda:0",
                           "--dist-backend", "gloo", "--seed", "0"],
                          f"{name}_train.log")
    return {**job, "cfg_path": cfg_path, "exp": name}


def _dp_train_cli(torch, job: dict, data: int = DP_RANKS) -> dict:
    """A train_ava job of ``_dp_train_start`` (of ``data`` shards: 2 steps
    a shard at 2, and a validation of 4 keyframes a shard): both exit 0,
    one run directory, one checkpoint and the metrics from rank 0 alone.
    Returns the YAML, the run directory, the checkpoint, the output and
    the wall seconds."""
    ranks = ["cuda:0"] * DP_RANKS
    name = job["exp"]
    text = _torchrun_wait(job)
    wall = job["wall"]
    lines = _dist_lines(text, "gloo", DP_RANKS, ranks)
    # the run directory <name>_<stamp>: not another experiment's whose
    # name starts with this one's (chip_smoke_dp_zero1 runs at once)
    runs = glob.glob(str(BUILD_DIR / "chip_smoke_runs" / f"{name}_[0-9]*"))
    ckpts = glob.glob(str(Path(runs[0], "checkpoints", "ckpt_*"))) \
        if len(runs) == 1 else []
    tags = [json.loads(x)["tag"] for x in Path(
        runs[0], "tb_log", "metrics.jsonl").read_text().splitlines()] \
        if len(runs) == 1 else []
    steps = TRAIN_STEPS // data
    epoch_lines = [x for x in text.splitlines() if x.startswith("Epoch:")]
    ok = (len(runs) == 1 and len(ckpts) == 1
          and tags.count("train/total_loss") == steps
          and tags.count("val/val_mAP_epoch") == 1
          and len(epoch_lines) == steps
          and Path(runs[0], "config.json").is_file())
    log(f"[dp] {name}: train_ava via torchrun, {DP_RANKS} ranks on cuda:0 "
        f"over gloo: {lines}; {wall:.1f} s (the processes included); one "
        f"run directory {len(runs) == 1}, checkpoints {len(ckpts)}, "
        f"train/total_loss lines {tags.count('train/total_loss')} (the "
        f"{steps} global steps of {data} data shard(s), rank 0 alone), "
        f"val/val_mAP_epoch "
        f"{tags.count('val/val_mAP_epoch')}; rank 0's epoch lines: "
        f"{[x.split(' data ')[0] for x in epoch_lines]}")
    if not ok:
        raise AssertionError(f"dp train {name}: runs {runs}, ckpts {ckpts}, "
                             f"tags {tags}, epoch lines {epoch_lines}")
    return {"cfg_path": job["cfg_path"], "run": runs[0], "ckpt": ckpts[0],
            "text": text, "wall": wall}


def _optimizer_layout(torch, path: str) -> dict:
    """A checkpoint's optimizer state dict reduced to its layout: each
    group's keys and parameter indices, and each state entry's shapes."""
    sd = torch.load(path, map_location="cpu", weights_only=True)["optimizer"]
    return {"groups": [(sorted(g), g["params"]) for g in sd["param_groups"]],
            "state": {i: {k: tuple(v.shape) for k, v in st.items()}
                      for i, st in sd["state"].items()}}


def _held(readings: dict, tol: dict) -> tuple[dict, dict]:
    """Each bounded reading of the DP step within its bound, and of the
    control outside it."""
    return ({k: readings["dp"][k] <= v for k, v in tol.items()},
            {k: readings["control"][k] > v for k, v in tol.items()})


def _mesh_checks_start(nproc: int, checks: list, log_name: str) -> dict:
    """Start ``tools/mesh_checks`` through torchrun, ``nproc`` ranks on
    cuda:0 over gloo with deterministic algorithms: ``checks`` a list of
    (tool, its arguments beyond those), each check's result written to
    its ``--out``."""
    argv = []
    for i, (tool, extra) in enumerate(checks):
        argv += [*(["--then"] if i else []), tool, "--device", "cuda:0",
                 "--dist-backend", "gloo", "--deterministic", *extra]
    return _torchrun_start(nproc, "tubelet_transformer_tpu_torch.tools."
                           "mesh_checks", argv, log_name)


def _dp_check_result(torch, dtype: str, out_path: Path, text: str,
                     smi: str) -> dict:
    """dp_check's result in ``dtype``: every reading of the DP step
    within DP_TOL[dtype], its control outside, #4 and #2 once each."""
    tol = DP_TOL[dtype]
    _dist_lines(text, "gloo", DP_RANKS, ["cuda:0"] * DP_RANKS)
    res = torch.load(out_path, weights_only=False)
    held, missed = _held(res["readings"], tol)
    launches = res["dp"]["launches"]
    log(f"[dp] dp_check {dtype}, {DP_RANKS} ranks x 2 clips against "
        f"one process on the 4 (deterministic algorithms): readings "
        f"{res['readings']['dp']}; control "
        f"{res['readings']['control']}; bounds {tol}: held {held}, "
        f"control missed {missed}; the DP step's launches on rank 0 "
        f"{launches} and all-reduces {res['dp']['all_reduces']}; "
        f"total loss DP "
        f"{res['dp']['metrics']['total_loss']:.6f}, one process "
        f"{res['single']['metrics']['total_loss']:.6f}, control "
        f"{res['control']['metrics']['total_loss']:.6f}; {smi}")
    if not (all(held.values()) and all(missed.values())
            and launches == {"stem_stats": 1, "stem_pool": 1}
            and res["dp"]["metrics"]["finite"] == 1.0):
        raise AssertionError(f"dp check {dtype}: held {held}, control "
                             f"missed {missed}, launches {launches}")
    return res


def _dp_layouts(torch, data: dict, z: dict, smi: str) -> None:
    """The ZeRO-1 train run's checkpoint has the DATA-only one's optimizer
    layout."""
    layouts = [_optimizer_layout(torch, r["ckpt"]) for r in (data, z)]
    log(f"[dp] the ZeRO-1 checkpoint's optimizer layout (each group's keys "
        f"and indices, each state entry's shapes) equals the DATA-only "
        f"one's: {layouts[0] == layouts[1]} ({len(layouts[0]['state'])} "
        f"state entries); train_ava wall {data['wall']:.1f} s DATA-only, "
        f"{z['wall']:.1f} s ZeRO-1; {smi}")
    if layouts[0] != layouts[1]:
        raise AssertionError("dp: the ZeRO-1 checkpoint's optimizer layout "
                             "differs from the DATA-only one's")


def _dp_bf16_logs(checks: dict, train: dict, smi: str) -> dict:
    """Each rank's DP step and gradient all-reduce times in bf16, and
    ZeRO-1 against the DATA-only step on each rank: bit for bit over two
    steps, the control missing, the moment bytes, #4 and #2 once a
    step. Returns the timings."""
    timings = checks["bfloat16"]["timings"]
    for r, (step_ms, reduce_ms) in enumerate(zip(
            timings["step_ms"], timings["grad_all_reduce_ms"])):
        log(f"[dp] rank {r} (gloo, cuda:0, bf16, bs 2): step ms "
            f"{[round(t, 2) for t in step_ms]}, gradient all-reduce ms "
            f"{[round(t, 2) for t in reduce_ms]} (one process at bs 2 in "
            f"phase 9: {train['steady_ms']:.2f} ms steady); {smi}")

    # ZeRO-1 against the DATA-only step, on each rank
    one_step = {"stem_stats": 1, "stem_pool": 1}
    for r, zr in enumerate(checks["bfloat16"]["zero1"]):
        t = zr["timings"]
        log(f"[dp] rank {r} ZeRO-1 (gloo, cuda:0, bf16, bs 2, deterministic "
            f"algorithms), two steps from one state: the model and the "
            f"gathered optimizer state dicts bit-equal to the DATA-only "
            f"step's after each step {zr['zero1_equal']}, the control "
            f"without the all-gather {zr['control_equal']} (must be "
            f"[False, False]); moment bytes {zr['zero1_moment_bytes']} "
            f"(from the shapes {zr['zero1_predicted_bytes']}) against "
            f"{zr['data_moment_bytes']} DATA-only (from the shapes "
            f"{zr['data_predicted_bytes']}); the all-gather "
            f"{t['all_gather_mb'][0]:.1f} MB sent, "
            f"{t['all_gather_mb'][1]:.1f} MB gathered, ms "
            f"{[round(v, 2) for v in t['all_gather_ms']]}; ZeRO-1 step ms "
            f"{[round(v, 2) for v in t['step_ms']]} against DATA-only "
            f"{[round(v, 2) for v in timings['step_ms'][r]]}; a ZeRO-1 "
            f"step's launches {zr['zero1_launches']}; {smi}")
        if not (zr["zero1_equal"] == [True, True]
                and zr["control_equal"] == [False, False]
                and zr["zero1_moment_bytes"] == zr["zero1_predicted_bytes"]
                and zr["data_moment_bytes"] == zr["data_predicted_bytes"]
                and zr["zero1_launches"] == [one_step, one_step]):
            raise AssertionError(f"dp zero1 rank {r}: {zr}")
    return timings


def _dp_f32_logs(f32: dict, smi: str) -> None:
    """The MoE and classifier DP steps in float32 within MOE_DP_TOL and
    CLASSIFIER_DP_TOL, each control outside; #4 and #2 once a MoE step."""
    one_step = {"stem_stats": 1, "stem_pool": 1}
    for what, res, tol in (("MoE", f32["moe"]["readings"], MOE_DP_TOL),
                           ("classifier", f32["classifier"],
                            CLASSIFIER_DP_TOL)):
        held, missed = _held(res, tol)
        log(f"[dp] dp_check float32 {what} DP step, {DP_RANKS} ranks x 2 "
            f"clips against one process on the 4: readings {res['dp']}; "
            f"control {res['control']}; bounds {tol}: held {held}, control "
            f"missed {missed}; one process against a repeat of itself "
            f"{res.get('repeat', 'not read')}; {smi}")
        if not (all(held.values()) and all(missed.values())):
            raise AssertionError(f"dp {what}: held {held}, control missed "
                                 f"{missed}")
    moe = f32["moe"]
    if moe["dp"]["launches"] != one_step or "loss_moe_aux" not in \
            moe["dp"]["metrics"]:
        raise AssertionError(f"dp MoE: launches {moe['dp']['launches']}, "
                             f"metrics {sorted(moe['dp']['metrics'])}")


def _nccl_start(train: dict) -> dict:
    """Start train_ava through torchrun with the default backend (NCCL) at
    world size 1, MODEL.LOAD on the ZeRO-1 run's experiment without
    ZeRO-1, for one more step."""
    one = write_config("chip_smoke_dp_nccl.yaml", lambda c: (
        c["LOG"].update(EXP_NAME="chip_smoke_dp_zero1"),
        c["MODEL"].update(LOAD=True, PRETRAINED_PATH=""),
        c["TRAIN"].update(EPOCH_NUM=2),
        c["DATA"].update(SYNTHETIC_SIZE=2)), source=train["cfg_path"])
    return _torchrun_start(1, "tubelet_transformer_tpu_torch.cli.train_ava",
                           ["--config-file", one], "chip_smoke_dp_nccl.log")


def _nccl_check(job: dict, z: dict, cfg_path: Path, smi: str) -> None:
    """The NCCL job resumed the ZeRO-1 checkpoint for one finite step (a
    card per rank at 2 ranks where the machine has two cards)."""
    text = _torchrun_wait(job)
    nccl = _dist_lines(text, "cuda:nccl,cpu:gloo", 1, ["cuda:0"])
    resumed = re.findall(r"resumed from (\S+) at epoch (\d+)", text)
    epoch_lines = [x for x in text.splitlines() if x.startswith("Epoch:")]
    losses = [float(v) for v in re.findall(r" loss (\S+)",
                                            "\n".join(epoch_lines))]
    log(f"[dp] train_ava via torchrun with the default backend at world "
        f"size 1, MODEL.LOAD without ZeRO-1: resumed {resumed} (the ZeRO-1 "
        f"checkpoint {z['ckpt']}), epoch lines "
        f"{[x.split(' data ')[0] for x in epoch_lines]}, losses {losses}; "
        f"{smi}")
    if ([(os.path.realpath(p), e) for p, e in resumed]
            != [(os.path.realpath(z["ckpt"]), "1")]
            or len(epoch_lines) != 1 or len(losses) != 1
            or not np.isfinite(losses).all()):
        raise AssertionError(f"dp resume: {resumed}, {epoch_lines}")
    import torch

    if torch.cuda.device_count() >= 2:
        text = _torchrun(2, "tubelet_transformer_tpu_torch.cli.train_ava",
                         ["--config-file", cfg_path],
                         "chip_smoke_dp_nccl2.log")
        nccl += _dist_lines(text, "cuda:nccl,cpu:gloo", 2,
                            ["cuda:0", "cuda:1"])
    else:
        log("[dp] one card: NCCL at 2 ranks (one a card) not run; NCCL "
            "refuses two ranks of one communicator on one device")
    log(f"[dp] train_ava via torchrun with the default backend: {nccl}; "
        f"{smi}")


# phase 24: tensor parallelism (MESH.MODEL) over torch.distributed, the
# ranks on the one card over gloo: 2 model peers, and 2 x 2 (data x model)
TP_RANKS = 2
PP_RANKS = 2
TP_BATCH = 2          # phase 9's BATCH_SIZE, each data shard's
# the TP step against the one-process step on the same batch from one
# state (tools/tp_check.py, flagship width, deterministic algorithms):
# each reading's bound per case, between two seeds' readings and the
# control's (seeds 0 and 2 on the H100, PERF.md). The control ("g"
# summing again in its backward) has the step's own forward, so only the
# gradient readings (TP_CONTROL_MISSES) can tell it apart, and its
# forward readings must equal the step's. MODEL 2, float32: losses
# 3.1e-7-4.1e-7, gradient norm 0-7.5e-7, gradients 2.8e-7-5.6e-5,
# updates 3.7e-6-4.7e-4, running and stem statistics 0 (no batch split);
# the control's gradient norm 20.6-31.8, gradients 1.31, updates
# 1.17-1.21. bf16: losses 3.8e-3-5.4e-3, gradient norm 1.1e-3-5.7e-3,
# gradients 0.022, updates 0.077-0.10 (the split partial sums round
# otherwise); the control's 21.4-29.8, 1.31, 1.17-1.21. MoE (float32):
# the load-balance loss 6.4e-8-2.3e-7, losses 4.7e-7-8.4e-7, gradient
# norm 0-1.5e-7, gradients 7.3e-6-2.4e-5, updates 9.0e-5-2.3e-4; the
# control's 12.8-15.2, 1.18-1.21, 1.12-1.14. DATA 2 x MODEL 2 (float32,
# the batch split as in phase 23's DP step, whose float32 readings these
# equal, so DP_TOL's float32 bounds): losses 1.1e-5-3.2e-5, gradient
# norm 7.5e-5-1.9e-4, gradients 8.7e-3-9.0e-3, running statistics
# 1.9e-5-2.2e-5, the stem's 3.9e-8-4.6e-8, updates 0.019-0.022; the
# control's 20.3-26.2, 1.30-1.31, 1.16-1.22
TP_TOL = {
    "float32": {"loss_rel": 1e-5, "grad_norm_rel": 1e-4, "grads_rel": 1e-3,
                "update_rel": 0.01, "running_update_rel": 1e-6,
                "stem_mean_rel": 1e-6, "stem_var_rel": 1e-6},
    "bfloat16": {"loss_rel": 0.02, "grad_norm_rel": 0.05, "grads_rel": 0.1,
                 "update_rel": 0.4, "running_update_rel": 1e-6,
                 "stem_mean_rel": 1e-6, "stem_var_rel": 1e-6},
    "moe": {"moe_aux_rel": 1e-5, "loss_rel": 1e-5, "grad_norm_rel": 1e-4,
            "grads_rel": 1e-3, "update_rel": 0.01, "running_update_rel": 1e-6,
            "stem_mean_rel": 1e-6, "stem_var_rel": 1e-6},
    "data_model": {"loss_rel": 1e-3, "grad_norm_rel": 1e-3,
                   "grads_rel": 0.04, "update_rel": 0.1,
                   "running_update_rel": 1e-3, "stem_mean_rel": 1e-6,
                   "stem_var_rel": 1e-6},
}
TP_CONTROL_MISSES = ("grad_norm_rel", "grads_rel", "update_rel")


def _tp_held(readings: dict, tol: dict) -> tuple[dict, dict, bool]:
    """Each bounded reading of the TP step within its bound; the control's
    gradient readings outside theirs; and the control's other readings
    equal to the step's."""
    tp, control = readings["tp"], readings["control"]
    return ({k: tp[k] <= v for k, v in tol.items()},
            {k: control[k] > tol[k] for k in TP_CONTROL_MISSES},
            all(control[k] == tp[k] for k in tol
                if k not in TP_CONTROL_MISSES))


def _tp_check_result(torch, name: str, ranks: int, text: str,
                     smi: str) -> dict:
    """tools/tp_check's result (build/<name>.pt) of ``ranks`` ranks on
    cuda:0 over gloo, deterministic algorithms: every case's readings
    within TP_TOL, the control outside its gradient bounds, the model
    peers bit-equal after each of two steps, #4 and #2 once each on every
    rank; with ZeRO-1 beside a 'model' axis (``--zero1``), on every rank
    the ZeRO-1 x MODEL step bit-equal to the DATA x MODEL step after each
    of two steps, the control without the all-gather missing, the moment
    bytes those from the shapes. Returns the saved result."""
    _dist_lines(text, "gloo", ranks, ["cuda:0"] * ranks)
    res = torch.load(BUILD_DIR / f"{name}.pt", weights_only=False)
    one_step = {"stem_stats": 1, "stem_pool": 1}
    for case, r in res.items():
        tol = TP_TOL["data_model" if r["mesh"][0] > 1 else case]
        held, missed, same_forward = _tp_held(r["readings"], tol)
        log(f"[tp] tp_check {case}, mesh {r['mesh'][0]} x {r['mesh'][1]} "
            f"(data x model), {ranks} ranks on cuda:0 over gloo, "
            f"{r['n_split']} split parameters, against one process on the "
            f"same batch (deterministic algorithms): readings "
            f"{r['readings']['tp']}; control (g summing again) "
            f"{r['readings']['control']}; bounds {tol}: held {held}, the "
            f"control's gradient readings missed {missed}, its forward "
            f"readings the step's own {same_forward}; model peers' "
            f"replicated parameters bit-equal after each of two steps "
            f"{r['peers_equal']}; #4 and #2 launches per rank in one TP "
            f"step {r['launches']}; all-reduces in a step: TP "
            f"{r['tp']['all_reduces']}, control "
            f"{r['control']['all_reduces']}; total loss TP "
            f"{r['tp']['metrics']['total_loss']:.6f}, one process "
            f"{r['single']['metrics']['total_loss']:.6f}; "
            f"{r['wall_s']:.1f} s; {smi}")
        for rank, t in enumerate(r["timings"]):
            if t:
                log(f"[tp] {case} rank {rank} (gloo, cuda:0, bs "
                    f"{TP_BATCH}): step ms "
                    f"{[round(v, 2) for v in t['step_ms']]}; the model "
                    f"group's {t['model_all_reduces']} all-reduces of a "
                    f"step ({t['model_all_reduce_mb']:.2f} MB), replayed, "
                    f"ms {[round(v, 2) for v in t['model_all_reduce_ms']]}; "
                    f"{smi}")
        if not (all(held.values()) and all(missed.values()) and same_forward
                and r["peers_equal"] == [True, True]
                and all(x == one_step for x in r["launches"])
                and r["tp"]["metrics"]["finite"] == 1.0):
            raise AssertionError(f"tp check {case}: held {held}, control "
                                 f"missed {missed}, same forward "
                                 f"{same_forward}, peers {r['peers_equal']},"
                                 f" launches {r['launches']}")
        for rank, zr in enumerate(r.get("zero1", ())):
            log(f"[tp] rank {rank} ZeRO-1 x MODEL ({case}, mesh "
                f"{r['mesh'][0]} x {r['mesh'][1]}, gloo, cuda:0, "
                f"deterministic algorithms), two steps from one state: the "
                f"model and optimizer state dicts bit-equal to the DATA x "
                f"MODEL step's after each step {zr['zero1_equal']}, the "
                f"control without the all-gather {zr['control_equal']} "
                f"(must be [False, False]); moment bytes "
                f"{zr['zero1_moment_bytes']} (from the shapes "
                f"{zr['zero1_predicted_bytes']}) beside the DATA x MODEL "
                f"step's {zr['data_moment_bytes']} (from the shapes "
                f"{zr['data_predicted_bytes']}); a ZeRO-1 x MODEL step's "
                f"launches {zr['zero1_launches']}; {smi}")
            if not (zr["zero1_equal"] == [True, True]
                    and zr["control_equal"] == [False, False]
                    and zr["zero1_moment_bytes"]
                    == zr["zero1_predicted_bytes"]
                    and zr["data_moment_bytes"] == zr["data_predicted_bytes"]
                    and zr["zero1_moment_bytes"] < zr["data_moment_bytes"]
                    and zr["zero1_launches"] == [one_step, one_step]):
                raise AssertionError(f"tp zero1 {case} rank {rank}: {zr}")
    return res


# generate_lfb over the mesh: the bank of MODEL 2 against the one-process
# bank of phase_lfb, both from phase 10's YAML and phase 9's checkpoint in
# bf16. The bound, in bf16 ulps (2^-8), on a slot's features (relative to
# the bank's largest feature) and on its actor probability: the model
# peers sum their heads' and FFN columns' partial outputs in another
# order than one process. On the H100 (PERF.md) they read 0.0065 and
# 0.0047 (under 2 ulps), and the control's features 0.036: 4 ulps sit
# between
LFB_MESH_ULPS = 4
BF16_EPS = 2.0 ** -8
# the probe that runs generate_lfb's CLI under torchrun and keeps, on each
# rank, every query's actor probability (sorted) and the pooled stem's
# launches (written by the smoke to build/)
LFB_PROBE = """import json, os
import numpy as np
from tubelet_transformer_tpu_torch.cli import generate_lfb
from tubelet_transformer_tpu_torch.eval import lfb
from tubelet_transformer_tpu_torch.ops.cuda import stem
from tubelet_transformer_tpu_torch.parallel import mesh

probs, add, shutdown = {}, lfb.FeatureBank.add, mesh.shutdown

def adding(self, key, features, actor_prob, threshold=0.8):
    probs[key] = np.sort(np.asarray(actor_prob))[::-1].tolist()
    return add(self, key, features, actor_prob, threshold)

def record():
    path = os.environ["LFB_PROBE_OUT"] + "." + str(mesh.process_index())
    with open(path, "w") as f:
        json.dump({"probs": probs, "launches": stem.LAUNCHES}, f)
    shutdown()

lfb.FeatureBank.add, mesh.shutdown = adding, record
generate_lfb.main()
"""


def _mesh_lfb_start(evaluated: dict) -> dict:
    """Start generate_lfb's CLI (through ``LFB_PROBE``) under torchrun with
    MESH.MODEL 2, 2 ranks on cuda:0 over gloo, on phase 10's YAML."""
    cfg_path = write_config("chip_smoke_lfb_mesh.yaml", lambda c: c[
        "MESH"].update(MODEL=TP_RANKS), source=evaluated["cfg_path"])
    out = BUILD_DIR / "chip_smoke_lfb_mesh" / "bank.npz"
    out.parent.mkdir(exist_ok=True)
    for old in out.parent.iterdir():
        old.unlink()
    probe = BUILD_DIR / "lfb_probe.py"
    probe.write_text(LFB_PROBE)
    os.environ["LFB_PROBE_OUT"] = str(BUILD_DIR / "lfb_probe.json")
    try:
        job = _torchrun_start(TP_RANKS, str(probe),
                              ["--config-file", cfg_path, "--out", out,
                               "--device", "cuda:0", "--dist-backend",
                               "gloo"], "chip_smoke_lfb_mesh.log",
                              script=True)
    finally:
        del os.environ["LFB_PROBE_OUT"]
    return {**job, "out": out}


def _mesh_lfb_check(job: dict, lfb: dict, smi: str) -> dict:
    """The job of ``_mesh_lfb_start``: rank 0 alone wrote the bank; its
    keys are phase_lfb's one-process bank's, every slot's features and
    actor probability within LFB_MESH_ULPS bf16 ulps of it, the validity
    the same where the probability is not within that of the 0.8 gate;
    the control (each keyframe's features from the next keyframe of the
    one-process bank) misses; #2 once per val forward on each rank. The
    probabilities of the queries the bank leaves out are logged beside
    the control: this checkpoint (4 steps from random heads) gives every
    query much the same actor probability, so no probability of another
    query misses a bound that bf16's rounding passes."""
    from tubelet_transformer_tpu_torch.eval.lfb import FeatureBank

    text = _torchrun_wait(job)
    _dist_lines(text, "gloo", TP_RANKS, ["cuda:0"] * TP_RANKS)
    ranks = [json.loads(Path(f"{BUILD_DIR / 'lfb_probe.json'}.{r}")
                        .read_text()) for r in range(TP_RANKS)]
    out = job["out"]
    files = sorted(x.name for x in out.parent.iterdir())
    got = FeatureBank.load(str(out))
    want = lfb["bank"]
    keys = sorted(want["feats"])
    slots = got.slots
    scale = max(float(np.abs(v).max()) for v in want["feats"].values())
    bound = LFB_MESH_ULPS * BF16_EPS

    def worst(feats, probs, ref=lambda k: want["probs"][k][:slots]):
        return (max(float(np.abs(feats[k] - want["feats"][k]).max())
                    for k in keys) / scale,
                max(float(np.abs(np.asarray(probs[k][:slots]) - ref(k))
                          .max()) for k in keys))

    readings = [worst(got._bank, r["probs"]) for r in ranks]
    rolled = dict(zip(keys, keys[1:] + keys[:1]))
    control = worst({k: want["feats"][rolled[k]] for k in keys},
                    ranks[0]["probs"],
                    ref=lambda k: want["probs"][k][-slots:])
    gate = {k: np.abs(want["probs"][k][:slots] - 0.8) > bound for k in keys}
    valid_same = all(np.array_equal(got._valid[k][gate[k]],
                                    want["valid"][k][gate[k]])
                     for k in keys)
    launches = [r["launches"] for r in ranks]
    log(f"[tp] generate_lfb via torchrun with MESH.MODEL {TP_RANKS} "
        f"({TP_RANKS} ranks on cuda:0 over gloo, bf16) on phase 10's YAML "
        f"and checkpoint: files {files} (rank 0 alone); {len(got)} keys, "
        f"phase_lfb's {len(keys)}, equal {sorted(got._bank) == keys}; the "
        f"largest difference from the one-process bank (features of the "
        f"largest feature, actor probabilities) per rank "
        f"{[(round(a, 6), round(b, 6)) for a, b in readings]}, bound "
        f"{bound:.6g} ({LFB_MESH_ULPS} bf16 ulps); the control (each "
        f"keyframe's features the next keyframe's) {control[0]:.6g}, and "
        f"beside it the probabilities of the queries the bank leaves out "
        f"{control[1]:.6g}; validity equal away from the 0.8 gate "
        f"{valid_same}; #2 launches per rank {launches} ({VAL_FORWARDS} "
        f"val forwards); {job['wall']:.1f} s; {smi}")
    if not (files == ["bank.npz"] and sorted(got._bank) == keys
            and all(max(r) <= bound for r in readings)
            and control[0] > bound and valid_same
            and launches == [VAL_FORWARDS] * TP_RANKS):
        raise AssertionError(f"generate_lfb over the mesh: files {files}, "
                             f"readings {readings}, control {control}, "
                             f"validity {valid_same}, launches {launches}")
    return {"launches": launches, "readings": readings, "control": control}


def _tp_resume_start(train: dict) -> dict:
    """Start train_ava in one process on the MODEL 2 run's experiment
    (MODEL.LOAD without PRETRAINED_PATH), for one more step."""
    one = write_config("chip_smoke_tp_resume.yaml", lambda c: (
        c["LOG"].update(EXP_NAME="chip_smoke_tp"),
        c["MODEL"].update(LOAD=True, PRETRAINED_PATH=""),
        c["TRAIN"].update(EPOCH_NUM=2),
        c["DATA"].update(SYNTHETIC_SIZE=2)), source=train["cfg_path"])
    path = BUILD_DIR / "chip_smoke_tp_resume.log"
    f = open(path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tubelet_transformer_tpu_torch.cli.train_ava",
         "--config-file", str(one), "--device", "cuda:0"], cwd=ROOT,
        stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
    return {"proc": proc, "file": f, "path": path,
            "t0": time.perf_counter()}


def _tp_layouts_and_resume(torch, tp: dict, train: dict, job: dict,
                           smi: str) -> None:
    """The MODEL 2 checkpoint has the keys and shapes of phase 9's
    one-process file, and train_ava in one process (``job``) resumed it
    for one finite step."""
    layouts = {}
    for what, path in (("tp", tp["ckpt"]), ("one", train["ckpt"])):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        layouts[what] = ({k: tuple(v.shape) for k, v in sd["model"].items()},
                         _optimizer_layout(torch, path))
        del sd
    same = layouts["tp"] == layouts["one"]
    try:
        rc = job["proc"].wait(timeout=max(1.0, DP_TIMEOUT - (
            time.perf_counter() - job["t0"])))
    except subprocess.TimeoutExpired:
        os.killpg(job["proc"].pid, signal.SIGKILL)
        rc = job["proc"].wait()
    job["file"].close()
    text = job["path"].read_text()
    log(f"[time] train_ava in one process (the MODEL 2 file resumed): "
        f"{time.perf_counter() - job['t0']:.1f} s")
    resumed = re.findall(r"resumed from (\S+) at epoch (\d+)", text)
    epoch_lines = [x for x in text.splitlines() if x.startswith("Epoch:")]
    losses = [float(v) for v in re.findall(r" loss (\S+)",
                                            "\n".join(epoch_lines))]
    log(f"[tp] the MESH.MODEL 2 checkpoint's model keys and shapes and its "
        f"optimizer layout equal phase 9's one-process file's: {same} "
        f"({len(layouts['tp'][0])} model entries, "
        f"{len(layouts['tp'][1]['state'])} AdamW state entries); train_ava "
        f"in one process (exit {rc}) resumed {resumed}, epoch "
        f"lines {[x.split(' data ')[0] for x in epoch_lines]}, losses "
        f"{losses}; train_ava wall {tp['wall']:.1f} s under MESH.MODEL 2; "
        f"{smi}")
    if not (same and rc == 0
            and [(os.path.realpath(q), e) for q, e in resumed]
            == [(os.path.realpath(tp["ckpt"]), "1")]
            and len(losses) == 1 and np.isfinite(losses).all()):
        raise AssertionError(f"tp checkpoint: layout equal {same}, resume "
                             f"{resumed}, {epoch_lines}: {text[-2000:]}")


# mesh serving (tools/serve_check.py): each pool forward over the mesh
# against the one-process pool's on the same batch, and the HTTP streams
# against one-process detectors, in bf16 ulps (2^-8) of the largest
# difference of scores, actor probabilities and boxes over the canvas (or
# the source's longer side). The model peers sum their heads' and FFN
# columns' partial outputs in another order than one process; a data
# split changes nothing here (each clip's row is its own). On the H100
# (PERF.md, mesh serving) MODEL 2 and DATA 2 x MODEL 2 read 0.0028-0.0080
# (the same to the digit), HTTP 0.0078, the control ("g" left out)
# 0.084-0.354: 4 ulps sit between
SERVE_MESH_ULPS = 4


def _serve_check_result(torch, name: str, ranks: int, per_forward: dict,
                        smi: str) -> dict:
    """tools/serve_check's result (build/<name>.pt) of ``ranks`` ranks on
    cuda:0 over gloo: every pool forward and every HTTP stream within
    SERVE_MESH_ULPS of one process, the control outside it in every
    reading, the model peers bit-equal, every follower through as many
    forwards as rank 0 led and back, and ``per_forward`` launches (#2, #5,
    #8) in every forward of every rank. Returns, by kernel, each rank's
    launches in each pool forward (warmup, then buckets 8, 4, 2, 1)."""
    r = torch.load(BUILD_DIR / f"{name}.pt", weights_only=False)
    tol = SERVE_MESH_ULPS * BF16_EPS
    worst = max(max(v.values()) for v in r["pool"].values())
    control = min(min(v.values()) for v in r["control"].values())
    http = max(v for k, v in r["http"].items() if k != "same_keyframes")
    leads = {ph: sum(f["phase"] == ph for f in r["forwards"][0])
             for ph in ("pool", "control", "http")}
    followed = [leads["pool"], leads["control"], leads["http"]]
    launches = {f["phase"]: f["launches"] for fw in r["forwards"]
                for f in fw if f["launches"] != per_forward}
    for t in r["timing"]:
        b = t["bucket"]
        log(f"[serve] {name}, mesh {r['mesh'][0]} x {r['mesh'][1]}, "
            f"bucket {t['bucket']} ({t['streams']} streams): send "
            f"{t['broadcast_ms']:.2f} ms, the rows' forward "
            f"{t['exec_fetch_ms']:.2f} ms, gather {t['gather_ms']:.2f} ms, "
            f"assembly {t['assemble_ms']:.2f} ms; replayed until every rank "
            f"has it ({r['send_ms'][b]['mb']:.1f} MB): the bucket "
            f"{statistics.median(r['send_ms'][b]['bucket']):.2f} ms, each "
            f"data shard's rows "
            f"{statistics.median(r['send_ms'][b].get('rows', [math.nan])):.2f}"
            f" ms; {smi}")
    log(f"[serve] {name}: serve_check, mesh {r['mesh'][0]} x "
        f"{r['mesh'][1]} (data x model), {ranks} ranks on cuda:0 over gloo, "
        f"the flagship stage path in bf16: pool forwards against one "
        f"process {r['pool']}; control (g left out) {r['control']}; HTTP "
        f"streams against one-process detectors {r['http']} (keyframes "
        f"{r['http_keyframes']}, errors {r['http_errors']}); bound "
        f"{tol:.4f}: worst {worst:.4f}, HTTP {http:.4f}, the control's "
        f"least {control:.4f}; model peers bit-equal {r['peers_equal']}; "
        f"forwards rank 0 led {followed}, each follower's {r['followed'][1:]}"
        f"; launches other than {per_forward}: {launches}; "
        f"{r['wall_s']:.1f} s; {smi}")
    if not (worst <= tol < control and http <= tol
            and r["http"]["same_keyframes"] and not r["http_errors"]
            and r["http_keyframes"] == [2, 2, 2] and r["peers_equal"]
            and all(f == followed for f in r["followed"][1:])
            and not launches and len(r["timing"]) == 4):
        raise AssertionError(f"serve check {name}: worst {worst}, control "
                             f"{control}, http {r['http']}, peers "
                             f"{r['peers_equal']}, followed {r['followed']}"
                             f", launches {launches}")
    return {k: [[f["launches"][k] for f in fw if f["phase"] == "pool"]
                for fw in r["forwards"]] for k in per_forward}


# the spatial train step (tools/tp_check.py --spatial: the clip's rows
# split over the model peers through the trunk) against the one-process
# step on the same batch from one state, flagship width, deterministic
# algorithms, seed 0: each reading's bound, in bf16 and in float32 (TF32
# off) on MODEL 2 and in float32 on DATA 2 x MODEL 2, from the flagship's
# own readings on the H100 (PERF.md). At random init the trunk's
# gradients part from one process's under any change of rounding: one
# process on the batch reversed (the same sums in another order, the
# "reversed" floor) parts them by 0.116-0.118 in float32 and 1.408 in
# bf16, and its bf16 step from its float32 step by 1.411. The spatial
# step reads the floor's own: trunk gradients 0.107-0.115 in float32,
# 1.405 in bf16; losses 1.1e-5-2.6e-5 (floor 1.6e-5-2.3e-5) and 0.0111
# (floor 0.0131); gradients 0.0083-0.0131 (0.0091-0.0134) and 0.169
# (0.170); updates 0.018-0.021 (0.019-0.021) and 0.319 (0.328); running
# statistics 2.1e-5-3.4e-5 (2.5e-5-3.6e-5) and 0.0257 (0.0261); the
# stem's statistics 4e-8-6e-8. Each bound sits above the step and the
# reversed floor; each control is held to miss where it acts: zero halo
# rows move the stem's statistics (0.044-0.088) and the losses (0.0104-
# 0.0145 float32, 0.0198 bf16), in float32 the gradients (0.114-0.168),
# the running statistics (0.034-0.043) and the trunk's gradients
# (1.36-1.37); the trunk's gradients left unsummed leave each peer its
# share, so the peers part after the update and in float32 the gradients
# (0.065-0.095) and the trunk's (0.83-0.84) miss. In bf16 the trunk's
# gradients carry no signal (both controls 1.30-1.36, inside the floor):
# their bound holds them to the floor's level, and the float32 step on
# the same 2 ranks holds them where rounding does not drown them
SPATIAL_TOL = {
    "bfloat16": {"loss_rel": 0.016, "grad_norm_rel": 0.02,
                 "grads_rel": 0.25, "update_rel": 0.5,
                 "running_update_rel": 0.05, "stem_mean_rel": 1e-6,
                 "stem_var_rel": 1e-6, "trunk_grads_rel": 1.6},
    "float32": {"loss_rel": 1e-3, "grad_norm_rel": 1e-3, "grads_rel": 0.04,
                "update_rel": 0.1, "running_update_rel": 1e-3,
                "stem_mean_rel": 1e-6, "stem_var_rel": 1e-6,
                "trunk_grads_rel": 0.2},
}
# the stage path's eval forward with the rows split against one process,
# by dtype: in bf16 SERVE_MESH_ULPS bf16 ulps; in float32 (JHMDB's recipe
# at MODEL 4, uneven bands) the forward read 1.4e-4 and its zero-halo
# control 0.037 on the H100 (PERF.md): 1e-3 sits between
SPATIAL_EVAL_BOUND = {"bfloat16": SERVE_MESH_ULPS * BF16_EPS,
                      "float32": 1e-3}
SPATIAL_CONTROL_MISSES = {
    "bfloat16": {"zero_halo": ("stem_mean_rel", "loss_rel"),
                 "no_trunk_sum": ()},
    "float32": {"zero_halo": ("stem_mean_rel", "loss_rel", "grads_rel",
                              "running_update_rel", "trunk_grads_rel"),
                "no_trunk_sum": ("grads_rel", "trunk_grads_rel")}}


def _spatial_check_result(torch, name: str, ranks: int, text: str,
                          smi: str, chains: int | None = None) -> dict:
    """tools/tp_check --spatial's result (build/<name>.pt) of ``ranks``
    ranks on cuda:0 over gloo: the step's readings within SPATIAL_TOL,
    and so, with ``--floors``, the one-process step's on the batch
    reversed (the bounds no tighter than one process's own spread), each
    control outside its bound where it acts (SPATIAL_CONTROL_MISSES; beside
    a 'pipe' axis PP_CONTROL_MISSES too), the ranks of a data shard
    bit-equal after each of two steps and after the step and each
    zeroing control (zero halo, zero carry), not after a control that
    leaves a gradient unsummed, #4 and #2 once each on every rank (on its
    window), each rank's peak memory of a spatial step below the step's
    with the rows whole; with the stage path's eval forward, every rank's
    #2, #5 and #8 launches (``chains`` #8 a rank, the flagship's
    ``spatial_chains`` by default), rank 0's outputs within
    SPATIAL_EVAL_BOUND of one process's and the zero-halo control's outside it
    somewhere. Returns the saved result."""
    _dist_lines(text, "gloo", ranks, ["cuda:0"] * ranks)
    res = torch.load(BUILD_DIR / f"{name}.pt", weights_only=False)
    one_step = {"stem_stats": 1, "stem_pool": 1}
    for case, r in res.items():
        tol = SPATIAL_TOL[case]
        got = r["readings"]
        held = {k: got["tp"][k] <= v for k, v in tol.items()}
        floors = r.get("floors")
        floor_held = ({k: floors["reversed"][k] <= v for k, v in tol.items()}
                      if floors else {})
        misses = {**SPATIAL_CONTROL_MISSES[case],
                  **(PP_CONTROL_MISSES if r["mesh"][2] > 1 else {})}
        missed = {c: {k: got[c][k] > tol[k] for k in ks}
                  for c, ks in misses.items()}
        agree = r["peers_agree"]
        want_agree = {"tp": True, **{c: c.startswith("zero_")
                                     for c in r["controls"]}}
        memory = r["memory"]
        lower = [m["spatial"] < m["model_only"] for m in memory]
        log(f"[spatial] tp_check --spatial {case}, mesh {r['mesh'][0]} x "
            f"{r['mesh'][1]} x {r['mesh'][2]} (data x model x pipe), the "
            f"clip's rows split over the model peers, {ranks} ranks on "
            f"cuda:0 over gloo, against one process on the same batch "
            f"(deterministic algorithms): readings {got['tp']}; controls "
            f"{ {c: got[c] for c in r['controls']} }; the one-process "
            f"step's floors {floors or 'not asked'}; bounds {tol}: held "
            f"{held}, by the reversed floor {floor_held}, the controls "
            f"missed {missed}; trunk gradients step "
            f"{got['tp']['trunk_grads_rel']:.4f}, "
            + ", ".join(f"{c} {got[c]['trunk_grads_rel']:.4f}"
                        for c in r["controls"])
            + f"; the ranks of a data shard's replicated parameters "
            f"bit-equal after each of two steps {r['peers_equal']}, after "
            f"the step and each control {agree} (want {want_agree}); #4 "
            f"and #2 launches per rank in one step {r['launches']}; peak "
            f"device memory above the step's start per rank, spatial "
            f"against the rows whole: "
            f"{[(m['spatial'], m['model_only']) for m in memory]} bytes, "
            f"lower {lower}; total loss {r['tp']['metrics']['total_loss']:.6f}"
            f", one process {r['single']['metrics']['total_loss']:.6f}; "
            f"{r['wall_s']:.1f} s; {smi}")
        ok = (all(held.values()) and all(floor_held.values())
              and all(all(m.values()) for m in missed.values())
              and r["peers_equal"] == [True, True] and all(lower)
              and agree == want_agree
              and all(x == one_step for x in r["launches"])
              and r["tp"]["metrics"]["finite"] == 1.0)
        if "eval" in r:
            ev = r["eval"]
            bound = SPATIAL_EVAL_BOUND[case]
            per = {"stem_pool": 1, "depthwise": 3,
                   "chain": (spatial_chains(r["mesh"][1]) if chains is None
                             else chains)}
            worst = max(ev["differences"]["mesh"].values())
            control = max(ev["differences"]["zero_halo"].values())
            log(f"[spatial] the stage path's eval forward ({case}, "
                f"PALLAS_KERNELS and FUSED_STAGES) with the rows split, "
                f"{ranks} ranks: rank 0's outputs against one process "
                f"{ev['differences']['mesh']}, the zero-halo control "
                f"{ev['differences']['zero_halo']}; bound {bound:.4f}: "
                f"worst {worst:.4g}, the control's largest {control:.4f}; "
                f"#2, #5, #8 launches per rank {ev['launches']} (want "
                f"{per}); {smi}")
            ok = ok and worst <= bound < control and all(
                e[k] == per for e in ev["launches"] for k in e)
        if not ok:
            raise AssertionError(f"spatial check {case}: held {held}, "
                                 f"missed {missed}, {r}")
    return res


def _uneven_heads_result(torch, name: str, ranks: int, text: str,
                         smi: str) -> dict:
    """tools/tp_check --model 3's result (build/<name>.pt) of ``ranks``
    ranks on cuda:0 over gloo, on the flagship (8 heads of d 256, FFN
    2048): MESH.MODEL 3 divides no attention's heads, so every packed
    projection is cut into its q, k and v rows, one a peer, and every
    ``out_proj`` and FFN stays whole (256 and 2048 rows), as JAX's
    param_shardings has it. The step's readings within TP_TOL, the control
    ("gather" summing again: no "g" runs) outside its gradient bounds with
    the step's own forward, the model peers bit-equal after each of two
    steps, #4 and #2 once each on every rank, each rank's in_proj bytes a
    third of one process's. Returns the saved result."""
    _dist_lines(text, "gloo", ranks, ["cuda:0"] * ranks)
    res = torch.load(BUILD_DIR / f"{name}.pt", weights_only=False)
    one_step = {"stem_stats": 1, "stem_pool": 1}
    for case, r in res.items():
        tol = TP_TOL[case]
        got = r["readings"]
        held = {k: got["tp"][k] <= v for k, v in tol.items()}
        control = got.get("gather_again", {})
        missed = {k: control.get(k, 0.0) > tol[k] for k in TP_CONTROL_MISSES}
        same_forward = all(control.get(k) == got["tp"][k] for k in tol
                           if k not in TP_CONTROL_MISSES)
        thirds = [ranks * b == r["one_process_in_proj_bytes"]
                  for b in r["in_proj_bytes"]]
        log(f"[tp] tp_check --model {ranks} {case} (the attentions split by "
            f"rows: q, k and v a peer), {ranks} ranks on cuda:0 over gloo, "
            f"{r['n_split']} split parameters, against one process on the "
            f"same batch (deterministic algorithms): readings {got['tp']}; "
            f"controls {r['controls']}: \"gather\" summing again "
            f"{control}; bounds {tol}: held {held}, the control's gradient "
            f"readings missed {missed}, its forward readings the step's own "
            f"{same_forward}; model peers' replicated parameters bit-equal "
            f"after each of two steps {r['peers_equal']}; in_proj bytes per "
            f"rank {r['in_proj_bytes']} against one process's "
            f"{r['one_process_in_proj_bytes']} (a third {thirds}); #4 and "
            f"#2 launches per rank in one step {r['launches']}; total loss "
            f"{r['tp']['metrics']['total_loss']:.6f}, one process "
            f"{r['single']['metrics']['total_loss']:.6f}; {r['wall_s']:.1f} "
            f"s; {smi}")
        if not (r["controls"] == ["gather_again"] and all(held.values())
                and all(missed.values()) and same_forward
                and r["peers_equal"] == [True, True] and all(thirds)
                and len(thirds) == ranks
                and all(x == one_step for x in r["launches"])
                and r["tp"]["metrics"]["finite"] == 1.0):
            raise AssertionError(f"tp check --model {ranks} {case}: held "
                                 f"{held}, control missed {missed}, same "
                                 f"forward {same_forward}, thirds {thirds}, "
                                 f"{r['controls']}, {r['launches']}")
    return res


# pipeline parallelism (tools/tp_check.py --pipe 2: the encoder's 6 layers
# as 2 GPipe stages of 3 over the pipe peers, 2 microbatches of 1 clip)
# against the one-process step on the same batch from one state, flagship
# width, deterministic algorithms, seed 0, read on the last stage: each
# reading's bound, from the flagship's own readings on the H100 (PERF.md,
# pipeline parallelism: the same to the digit in every run).
# PIPE 2 splits no batch: its step is one process's but for the encoder's
# microbatches, so its bounds sit between its readings and its controls'
# as TP_TOL's do for MODEL 2, far below one process's own floor (its step
# on the batch reversed: bf16 losses 0.013, gradients 0.170, updates
# 0.328, trunk 1.408; float32 1.6e-5, 0.0134, 0.0214, 0.118). bf16:
# losses 0, gradient norm 0, gradients 9.5e-5, updates 3.2e-4, running
# statistics 0, trunk gradients 0; float32 (TF32 off): 2.5e-7, 2.0e-6,
# 1.8e-5, 2.2e-4, 0, 8.3e-5. The zero-carry control parts the losses
# (0.764-0.766; its gradients NaN: the later stage's layers see zeros);
# without the input's gradient sum the last stage's backbone misses the
# encoder's gradient: gradient norm 3.7e-3, gradients 0.086, updates
# 0.824, trunk 0.452-0.459, in both dtypes. DATA 2 x PIPE 2 (float32)
# splits the batch as DATA 2 does, and reads DATA 2's rounding (losses
# 1.1e-5, gradients 0.0087, updates 0.0187, running statistics 2.2e-5,
# trunk 0.110; its floor 2.3e-5, 0.0091, 0.0195, 2.5e-5, 0.116), so
# SPATIAL_TOL's float32 bounds, above the step and its floor; its
# control without the sum reads gradient norm 3.0e-3, gradients 0.077,
# updates 0.824, trunk 0.480
PP_TOL = {
    "bfloat16": {"loss_rel": 1e-3, "grad_norm_rel": 1e-3, "grads_rel": 0.01,
                 "update_rel": 0.05, "running_update_rel": 1e-6,
                 "stem_mean_rel": 1e-6, "stem_var_rel": 1e-6,
                 "trunk_grads_rel": 0.01},
    "float32": {"loss_rel": 1e-5, "grad_norm_rel": 1e-4, "grads_rel": 1e-3,
                "update_rel": 0.01, "running_update_rel": 1e-6,
                "stem_mean_rel": 1e-6, "stem_var_rel": 1e-6,
                "trunk_grads_rel": 1e-3},
    "data_pipe": SPATIAL_TOL["float32"]}
PP_CONTROL_MISSES = {"zero_carry": ("loss_rel",),
                     "no_input_sum": ("grad_norm_rel", "grads_rel",
                                      "update_rel", "trunk_grads_rel")}


def _pp_train_layout(torch, pp: dict, train: dict, smi: str) -> None:
    """train_ava under PIPE 2 (``pp``, of ``_dp_train_cli``): every rank
    said its pipe stage, and the checkpoint rank 0 wrote has the keys and
    shapes and the optimizer layout of phase 9's one-process file, and
    records PIPE 2."""
    stages = sorted(re.findall(r"pipe stage (\d) of 2", pp["text"]))
    layouts = {}
    for what, path in (("pp", pp["ckpt"]), ("one", train["ckpt"])):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        layouts[what] = ({k: tuple(v.shape) for k, v in sd["model"].items()},
                         _optimizer_layout(torch, path), sd.get("pipe", 1))
        del sd
    same = layouts["pp"][:2] == layouts["one"][:2]
    log(f"[pp] train_ava under MESH.PIPE 2 (the encoder's 6 layers as 2 "
        f"stages of 3, 2 microbatches, VAL.BATCH_SIZE 2): the ranks' pipe "
        f"stages {stages}; the checkpoint's model keys and shapes and its "
        f"optimizer layout equal phase 9's one-process file's: {same} "
        f"({len(layouts['pp'][0])} model entries, "
        f"{len(layouts['pp'][1]['state'])} AdamW state entries), recorded "
        f"PIPE {layouts['pp'][2]}; train_ava wall {pp['wall']:.1f} s; {smi}")
    if not (same and stages == ["0", "1"] and layouts["pp"][2] == 2):
        raise AssertionError(f"pp train: stages {stages}, layout equal "
                             f"{same}, pipe {layouts['pp'][2]}")


def _pp_check_result(torch, name: str, ranks: int, text: str,
                     smi: str) -> dict:
    """tools/tp_check --pipe's result (build/<name>.pt) of ``ranks`` ranks
    on cuda:0 over gloo: each case's readings on the last stage within
    PP_TOL (with the batch split, DATA x PIPE, the one-process step's own
    floor on the batch reversed within them too: ``--floors``; without a
    split PP_TOL lies far below it, PP_TOL's note), each control outside its bound where it acts
    (PP_CONTROL_MISSES), the replicated parameters of a data shard's
    ranks bit-equal after each of two steps and after the zero-carry
    control, not after the control without the input's gradient sum, #4
    and #2 once each on every rank, each rank's encoder parameters and
    moments half one process's; with ``--timed-steps`` each rank's step
    ms beside the bubble; with the stage path's eval forward, #2, #5 and
    #8 per rank and the reporter's outputs within SERVE_MESH_ULPS of one
    process's; with ZeRO-1 beside DATA x PIPE, every rank bit-equal to
    the DATA x PIPE step after each of two steps, its control missing,
    the moment bytes those from the shapes. Returns the saved result."""
    _dist_lines(text, "gloo", ranks, ["cuda:0"] * ranks)
    res = torch.load(BUILD_DIR / f"{name}.pt", weights_only=False)
    one_step = {"stem_stats": 1, "stem_pool": 1}
    for case, r in res.items():
        split = r["mesh"][0] > 1
        tol = PP_TOL["data_pipe" if split else case]
        got = r["readings"]
        held = {k: got["tp"][k] <= v for k, v in tol.items()}
        floor_held = {k: r["floors"]["reversed"][k] <= v
                      for k, v in tol.items()} if split else {}
        missed = {c: {k: got[c][k] > tol[k] for k in ks}
                  for c, ks in PP_CONTROL_MISSES.items()}
        one = r["one_process_encoder_bytes"]
        halves = [2 * e["params"] == one["params"]
                  and 2 * e["moments"] == one["moments"]
                  for e in r["encoder_bytes"]]
        log(f"[pp] tp_check --pipe {case}, mesh {r['mesh'][0]} x "
            f"{r['mesh'][1]} x {r['mesh'][2]} (data x model x pipe), "
            f"{ranks} ranks on cuda:0 over gloo, against one process on the "
            f"same batch (deterministic algorithms), read on the last "
            f"stage: readings {got['tp']}; zero-carry control "
            f"{got['zero_carry']}; control without the input's gradient "
            f"sum {got['no_input_sum']}; the one-process step's floors "
            f"{r.get('floors', 'not asked')}; bounds {tol}: held {held}, "
            f"by the reversed "
            f"floor {floor_held or 'not asked: no batch split'}, the "
            f"controls missed {missed}; replicated "
            f"parameters bit-equal over each data shard's ranks after each "
            f"of two steps {r['peers_equal']}, after the step and each "
            f"control {r['peers_agree']}; #4 and #2 launches per rank in "
            f"one step {r['launches']}; encoder bytes per rank "
            f"{r['encoder_bytes']} against one process's {one} (half "
            f"{halves}); total loss {r['tp']['metrics']['total_loss']:.6f}, "
            f"one process {r['single']['metrics']['total_loss']:.6f}; "
            f"{r['wall_s']:.1f} s; {smi}")
        for rank, t in enumerate(r["timings"]):
            if t:
                log(f"[pp] {case} rank {rank} (gloo, cuda:0, bs "
                    f"{TP_BATCH}, microbatches of 1 clip): step ms "
                    f"{[round(v, 2) for v in t['step_ms']]}; the GPipe "
                    f"bubble (P-1)/(M+P-1) {t['bubble']:.4f}; {smi}")
        ok = (all(held.values()) and all(floor_held.values())
              and all(all(m.values()) for m in missed.values())
              and r["peers_equal"] == [True, True]
              and r["peers_agree"] == {"tp": True, "zero_carry": True,
                                       "no_input_sum": False}
              and all(x == one_step for x in r["launches"]) and all(halves)
              and r["tp"]["metrics"]["finite"] == 1.0)
        if "eval" in r:
            ev = r["eval"]
            bound = SERVE_MESH_ULPS * BF16_EPS
            per = {"stem_pool": 1, "depthwise": 3, "chain": flagship_chains()}
            worst = max(ev["differences"]["mesh"].values())
            log(f"[pp] the stage path's eval forward (bf16, PALLAS_KERNELS "
                f"and FUSED_STAGES) under PIPE 2, {ranks} ranks: the last "
                f"stage's outputs against one process "
                f"{ev['differences']['mesh']}; bound {bound:.4f}: worst "
                f"{worst:.4f}; #2, #5, #8 launches per rank "
                f"{ev['launches']} (want {per}); {smi}")
            ok = ok and worst <= bound and all(e["mesh"] == per
                                               for e in ev["launches"])
        for rank, zr in enumerate(r.get("zero1") or ()):
            log(f"[pp] rank {rank} ZeRO-1 x PIPE ({case}, mesh "
                f"{r['mesh'][0]} x {r['mesh'][2]} (data x pipe), gloo, "
                f"cuda:0, deterministic algorithms), two steps from one "
                f"state: the model and optimizer state dicts bit-equal to "
                f"the DATA x PIPE step's after each step "
                f"{zr['zero1_equal']}, the control without the all-gather "
                f"{zr['control_equal']} (must be [False, False]); moment "
                f"bytes {zr['zero1_moment_bytes']} (from the shapes "
                f"{zr['zero1_predicted_bytes']}) beside the DATA x PIPE "
                f"step's {zr['data_moment_bytes']}; a ZeRO-1 x PIPE step's "
                f"launches {zr['zero1_launches']}; {smi}")
            ok = ok and (zr["zero1_equal"] == [True, True]
                         and zr["control_equal"] == [False, False]
                         and zr["zero1_moment_bytes"]
                         == zr["zero1_predicted_bytes"]
                         and zr["zero1_moment_bytes"]
                         < zr["data_moment_bytes"]
                         and zr["zero1_launches"] == [one_step, one_step])
        if not ok:
            raise AssertionError(f"pipe check {case}: held {held}, floors "
                                 f"{floor_held}, missed {missed}, {r}")
    return res


def phase_mesh(torch, train: dict, evaluated: dict, lfb: dict,
               stages_cfg: Path, stage_forward: dict,
               smi: str) -> tuple[dict, dict]:
    """The 'data' and 'model' axes over torch.distributed (phases 23 and
    24), ranks on cuda:0 over gloo, in three stages of jobs; the jobs of a
    stage run at once, and the timed checks alone.
    Stage 1: train_ava through torchrun on phase 9's YAML (2 steps a rank,
    a validation of 4 keyframes a rank) with MESH.DATA alone, with
    MESH.ZERO1, with MESH.MODEL 2 (4 steps of 2 clips), with MESH.MODEL
    2 and MESH.SPATIAL (the same, every rank on its rows of the clips)
    and with MESH.PIPE 2 (the same, the encoder as 2 stages; VAL.BATCH_SIZE
    2): one run directory, one checkpoint and the metrics from rank 0
    alone each, the ZeRO-1 file in the DATA-only file's optimizer layout,
    the PIPE file in phase 9's one-process layout;
    generate_lfb's CLI with MESH.MODEL 2 on phase 10's YAML
    (``_mesh_lfb_check``); tools/mesh_checks on 3 ranks: tp_check --model
    3 in float32 (every attention's q, k and v a peer each:
    ``_uneven_heads_result``).
    Stage 2: NCCL, the default backend, at world size 1 through
    train_ava, resuming the ZeRO-1 checkpoint without ZeRO-1 for one more
    step; train_ava in one process resuming the MODEL 2 checkpoint (which
    has phase 9's keys and shapes) for one more step; tools/mesh_checks
    on 2 ranks in float32 with TF32 off: dp_check (2 ranks x 2 clips
    against the one-process step on the global batch of 4 from one state,
    deterministic algorithms) of the dense, MoE (MOE, its load-balance
    loss among the readings) and classifier DP steps within DP_TOL,
    MOE_DP_TOL and CLASSIFIER_DP_TOL, tp_check (MESH.MODEL 2: 4 heads
    and FFN 1024 a peer, the pool_decoder's 6144-row in-projection cut in
    two; against one process on the same batch of 2) of the dense and MoE
    (2 experts a peer) TP steps within TP_TOL, then serve_check (mesh
    serving under MESH.MODEL 2 on the stage path's YAML in bf16:
    ``_serve_check_result``), then tp_check --spatial in bf16 with the
    stage path's eval forward (``_spatial_check_result``:
    the spatial step against one process within SPATIAL_TOL, and so one
    process on the batch reversed, its zero-halo control and its control
    without the trunk's gradient sum outside it, each rank's peak memory
    below the MODEL-only step's, #2, #5 and #8 per eval forward on every
    rank, the eval outputs within 4 bf16 ulps of one process), then
    tp_check --pipe 2 in float32 (``_pp_check_result``: against one
    process within PP_TOL, logged beside its floors, its two controls
    outside where PP_CONTROL_MISSES says);
    tools/mesh_checks on 4 ranks of MESH.DATA 2 x MESH.MODEL 2: tp_check in
    float32 against one process on the batch of 4, and ZeRO-1 beside it
    bit for bit against it, then tp_check --spatial in float32, then
    SPATIAL x PIPE (MODEL 2 x PIPE 2, float32: within SPATIAL_TOL, the
    four controls outside it where they act), then JHMDB's recipe on its
    224 x 400 canvas with the rows split over MODEL 4 in float32 (uneven
    bands: within SPATIAL_TOL, its controls outside, the stage path's
    eval forward with #2, #5 and #8 on every rank, 14 chains a rank by
    JHMDB_SPATIAL_TAILS); as the one-process jobs end, tools/mesh_checks
    on 4 more ranks: serve_check (buckets 8, 4 and 2 split over 'data', bucket
    1 whole on each data group), then tp_check --pipe 2 on DATA 2 x PIPE
    2 in float32 with ZeRO-1 (``_pp_check_result``, within its floor's
    bounds).
    Stage 3, alone: tools/mesh_checks on 2 ranks in bf16 with each rank's
    step times: dp_check with the stem's global statistics (#4 on each
    shard, reduced) against #4 over the whole batch, the gradient
    all-reduce's times, and ZeRO-1 against the DATA-only step over two
    steps, bit for bit in the parameters, the BN statistics and the
    gathered moments, its control without the all-gather missing, the
    moment bytes per rank against the figure from the shapes, the
    all-gather's MB and ms and the ZeRO-1 step's ms; tp_check with the
    model group's all-reduces of a step replayed; tp_check --pipe 2 in
    bf16 (each rank's step ms beside the bubble, the stage path's eval
    forward), as the float32 one.
    Every control outside its bounds, the model peers bit-equal, #4 and
    #2 once each on every rank in every DP, ZeRO-1, MoE, TP and spatial
    step (the spatial step's on each rank's window of the clips' rows).
    Returns what phases 23 and 24 returned before them."""
    jobs: list = []

    def out(name: str) -> str:
        return str(BUILD_DIR / f"{name}.pt")

    try:
        t0 = time.perf_counter()
        started = {
            "dp": _dp_train_start(train, "chip_smoke_dp", lambda c: None),
            "zero1": _dp_train_start(train, "chip_smoke_dp_zero1",
                                     lambda c: c["MESH"].update(ZERO1=True)),
            "tp": _dp_train_start(train, "chip_smoke_tp", lambda c: c[
                "MESH"].update(MODEL=TP_RANKS)),
            "spatial": _dp_train_start(
                train, "chip_smoke_spatial",
                lambda c: c["MESH"].update(MODEL=TP_RANKS, SPATIAL=True)),
            "pp": _dp_train_start(train, "chip_smoke_pp", lambda c: (
                c["MESH"].update(PIPE=2), c["VAL"].update(BATCH_SIZE=2))),
            "lfb": _mesh_lfb_start(evaluated),
            "model3": _mesh_checks_start(3, [
                ("tp_check", ["--config-file", train["cfg_path"],
                              "--model", 3, "--dtypes", "float32", "--out",
                              out("chip_smoke_tp_check_model3")])],
                "chip_smoke_tp_check_model3.log")}
        jobs += started.values()
        data = _dp_train_cli(torch, started["dp"])
        z = _dp_train_cli(torch, started["zero1"])
        tp_train = _dp_train_cli(torch, started["tp"], data=1)
        sp_train = _dp_train_cli(torch, started["spatial"], data=1)
        split = sp_train["text"].count("(the clip rows split)")
        log(f"[spatial] train_ava under MESH.MODEL {TP_RANKS} with "
            f"SPATIAL: ranks that split the clip's rows {split}; {smi}")
        if split != DP_RANKS:
            raise AssertionError(f"train_ava with SPATIAL: {split} ranks "
                                 "split the rows")
        pp_train = _dp_train_cli(torch, started["pp"], data=1)
        _pp_train_layout(torch, pp_train, train, smi)
        lfb_mesh = _mesh_lfb_check(started["lfb"], lfb, smi)
        _dp_layouts(torch, data, z, smi)
        model3 = _uneven_heads_result(
            torch, "chip_smoke_tp_check_model3", 3,
            _torchrun_wait(started["model3"]), smi)["float32"]
        log(f"[time] stage 1 of the mesh phases (train_ava under DATA 2, "
            f"ZeRO-1, MODEL 2, MODEL 2 with SPATIAL and PIPE 2, "
            f"generate_lfb under MODEL 2, tp_check under MODEL 3, at once): "
            f"{time.perf_counter() - t0:.1f} s")

        t1 = time.perf_counter()
        cfg_path, tp_cfg = data["cfg_path"], tp_train["cfg_path"]
        f32 = _mesh_checks_start(DP_RANKS, [
            ("dp_check", ["--config-file", cfg_path, "--float32", "--moe",
                          "--classifier", "--out",
                          out("chip_smoke_dp_check_float32")]),
            ("tp_check", ["--config-file", tp_cfg, "--dtypes", "float32",
                          "--moe", "--out",
                          out("chip_smoke_tp_check_float32")]),
            ("serve_check", ["--config-file", stages_cfg, "--model",
                             TP_RANKS, "--out",
                             out("chip_smoke_serve_check_model2")]),
            ("tp_check", ["--config-file", tp_cfg, "--spatial", "--dtypes",
                          "bfloat16", "--eval-stages", "--floors",
                          "--out", out("chip_smoke_tp_check_spatial")]),
            ("tp_check", ["--config-file", tp_cfg, "--model", 1, "--pipe",
                          PP_RANKS, "--dtypes", "float32", "--out",
                          out("chip_smoke_pp_check_float32")])],
            "chip_smoke_mesh_float32.log")
        dm = _mesh_checks_start(2 * TP_RANKS, [
            ("tp_check", ["--config-file", tp_cfg, "--data", 2, "--model",
                          TP_RANKS, "--dtypes", "float32", "--zero1",
                          "--out", out("chip_smoke_tp_check_2x2")]),
            ("tp_check", ["--config-file", tp_cfg, "--data", 2, "--model",
                          TP_RANKS, "--spatial", "--dtypes", "float32",
                          "--floors", "--out",
                          out("chip_smoke_tp_check_spatial_2x2")]),
            ("tp_check", ["--config-file", tp_cfg, "--data", 1, "--model",
                          TP_RANKS, "--pipe", PP_RANKS, "--spatial",
                          "--dtypes", "float32", "--out",
                          out("chip_smoke_tp_check_spatial_pipe")]),
            ("tp_check", ["--config-file", JHMDB_CONFIG, "--data", 1,
                          "--model", 4, "--spatial", "--dtypes",
                          "float32", "--eval-stages", "--out",
                          out("chip_smoke_tp_check_spatial_jhmdb4")])],
            "chip_smoke_tp_check_2x2.log")
        nccl = _nccl_start(train)
        resume = _tp_resume_start(train)
        jobs += [f32, dm, nccl, resume]
        _tp_layouts_and_resume(torch, tp_train, train, resume, smi)
        _nccl_check(nccl, z, cfg_path, smi)
        # the 4-rank checks beyond the first launch's, started as the
        # one-process jobs end, so that no more processes share the host
        dm2 = _mesh_checks_start(2 * TP_RANKS, [
            ("serve_check", ["--config-file", stages_cfg, "--data", 2,
                             "--model", TP_RANKS, "--out",
                             out("chip_smoke_serve_check_2x2")]),
            ("tp_check", ["--config-file", tp_cfg, "--data", 2, "--model",
                          1, "--pipe", 2, "--dtypes", "float32", "--zero1",
                          "--floors", "--out",
                          out("chip_smoke_pp_check_2x2")])],
            "chip_smoke_mesh_2x2_b.log")
        jobs.append(dm2)
        text = _torchrun_wait(f32)
        checks = {"float32": _dp_check_result(
            torch, "float32", out("chip_smoke_dp_check_float32"), text, smi)}
        _dp_f32_logs(checks["float32"], smi)
        tp32 = _tp_check_result(torch, "chip_smoke_tp_check_float32",
                                TP_RANKS, text, smi)
        serve = {"model2": _serve_check_result(
            torch, "chip_smoke_serve_check_model2", TP_RANKS, stage_forward,
            smi)}
        spatial = _spatial_check_result(
            torch, "chip_smoke_tp_check_spatial", TP_RANKS, text,
            smi)["bfloat16"]
        pp = _pp_check_result(torch, "chip_smoke_pp_check_float32",
                              PP_RANKS, text, smi)
        text = _torchrun_wait(dm)
        dm_res = _tp_check_result(torch, "chip_smoke_tp_check_2x2",
                                  2 * TP_RANKS, text, smi)
        spatial_dm = _spatial_check_result(
            torch, "chip_smoke_tp_check_spatial_2x2", 2 * TP_RANKS, text,
            smi)["float32"]
        spatial_pp = _spatial_check_result(
            torch, "chip_smoke_tp_check_spatial_pipe", 2 * TP_RANKS, text,
            smi)["float32"]
        spatial_jhmdb = _spatial_check_result(
            torch, "chip_smoke_tp_check_spatial_jhmdb4", 4, text, smi,
            chains=len(spatial_slabs(**JHMDB_SPATIAL)[0]))["float32"]
        text = _torchrun_wait(dm2)
        serve["data_model"] = _serve_check_result(
            torch, "chip_smoke_serve_check_2x2", 2 * TP_RANKS, stage_forward,
            smi)
        pp_dm = _pp_check_result(torch, "chip_smoke_pp_check_2x2",
                                 2 * TP_RANKS, text, smi)["float32"]
        log(f"[time] stage 2 of the mesh phases (NCCL at world size 1, the "
            f"MODEL 2 file resumed in one process, the float32 checks, mesh "
            f"serving, the bf16 spatial step and the float32 PIPE 2 step on "
            f"2 ranks; DATA 2 x MODEL 2 with ZeRO-1, the float32 spatial "
            f"step, SPATIAL x PIPE and JHMDB's spatial step at MODEL 4 on "
            f"4; then mesh serving and DATA 2 x PIPE 2 with ZeRO-1 on 4, at "
            f"once): {time.perf_counter() - t1:.1f} s")

        t2 = time.perf_counter()
        bf = _mesh_checks_start(DP_RANKS, [
            ("dp_check", ["--config-file", cfg_path, "--timed-steps", "3",
                          "--zero1", "--out",
                          out("chip_smoke_dp_check_bfloat16")]),
            ("tp_check", ["--config-file", tp_cfg, "--dtypes", "bfloat16",
                          "--timed-steps", "3", "--out",
                          out("chip_smoke_tp_check_bfloat16")]),
            ("tp_check", ["--config-file", tp_cfg, "--model", 1, "--pipe",
                          PP_RANKS, "--dtypes", "bfloat16", "--timed-steps",
                          "3", "--eval-stages", "--out",
                          out("chip_smoke_pp_check_bfloat16")])],
            "chip_smoke_mesh_bfloat16.log")
        jobs.append(bf)
        text = _torchrun_wait(bf)
        checks["bfloat16"] = _dp_check_result(
            torch, "bfloat16", out("chip_smoke_dp_check_bfloat16"), text, smi)
        timings = _dp_bf16_logs(checks, train, smi)
        tp16 = _tp_check_result(torch, "chip_smoke_tp_check_bfloat16",
                                TP_RANKS, text, smi)
        pp.update(_pp_check_result(torch, "chip_smoke_pp_check_bfloat16",
                                   PP_RANKS, text, smi))
        log(f"[time] stage 3 of the mesh phases (the timed bf16 checks on "
            f"2 ranks, the PIPE 2 one among them, alone): "
            f"{time.perf_counter() - t2:.1f} s")
    finally:
        _kill_jobs(jobs)
    model2 = {**tp16, **tp32}
    dp = {"launches": checks["bfloat16"]["dp"]["launches"],
          "zero1_launches": checks["bfloat16"]["zero1"][0][
              "zero1_launches"][0],
          "moe_launches": checks["float32"]["moe"]["dp"]["launches"],
          "readings": {k: v["readings"] for k, v in checks.items()},
          "timings": timings}
    tp = {"launches": model2["bfloat16"]["launches"],
          "moe_launches": model2["moe"]["launches"],
          "data_model_launches": dm_res["float32"]["launches"],
          "zero1_launches": [zr["zero1_launches"][0]
                             for zr in dm_res["float32"]["zero1"]],
          "lfb_launches": lfb_mesh["launches"],
          "serve": serve,
          "spatial_launches": spatial["launches"],
          "spatial_data_model_launches": spatial_dm["launches"],
          "spatial_eval_launches": [e["mesh"] for e in
                                    spatial["eval"]["launches"]],
          "spatial_memory": {"model2": spatial["memory"],
                             "data_model": spatial_dm["memory"]},
          "readings": {**{k: v["readings"] for k, v in model2.items()},
                       "data_model": dm_res["float32"]["readings"]},
          "timings": model2["bfloat16"]["timings"],
          "pp_launches": pp["bfloat16"]["launches"],
          "pp_float32_launches": pp["float32"]["launches"],
          "pp_data_pipe_launches": pp_dm["launches"],
          "pp_zero1_launches": [zr["zero1_launches"][0]
                                for zr in pp_dm["zero1"]],
          "pp_eval_launches": [e["mesh"] for e in
                               pp["bfloat16"]["eval"]["launches"]],
          "model3_launches": model3["launches"],
          "spatial_pipe_launches": spatial_pp["launches"],
          "spatial_jhmdb_launches": spatial_jhmdb["launches"],
          "spatial_jhmdb_eval_launches": [
              e["mesh"] for e in spatial_jhmdb["eval"]["launches"]]}
    return dp, tp


def _time_phases() -> None:
    """Every ``phase_*`` function of this script logs its wall seconds as
    it returns ("[time] phase_...: s"), each call of it."""
    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
        return run

    module = globals()
    for name in [n for n in module if n.startswith("phase_")]:
        module[name] = timed(name, module[name])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on a GPU only",
              file=sys.stderr)
        return 1
    from tubelet_transformer_tpu_torch.ops.cuda import stem

    t_main = time.perf_counter()
    _time_phases()
    smi = phase_environment(torch)
    phase_build()
    pools = phase_kernels(torch, stem)
    pool = pools["ava_256px_train"]
    stats_cases = phase_stats_kernel(torch, stem)
    stats = stats_cases["ava_256px_train"]
    windows = phase_window_kernels(torch, stem)
    dw_cases = phase_depthwise_kernel(torch)
    dw, dw_b8 = dw_cases["layer1_256px"], dw_cases["layer1_256px_b8"]
    bn = phase_bottleneck_kernel(torch)["layer2_256px"]
    chains = phase_stage_kernel(torch)
    stem_conv, stem_conv_launches = phase_stem_conv_kernel(torch, stem)
    assign_cases = phase_assign_kernel(torch)
    phase_small_reference(torch, stem)
    phase_small_train_reference(torch, stem)
    det, stream_launches, steady_ms = phase_main_path(
        torch, FLAGSHIP_CONFIG, "main", {"stem_pool": 1})
    phase_in_situ(torch, det, stem_switch(det.model), "stem kernel")

    # the kernel path, its latencies taken before any profiled window
    kernels_cfg = write_config("chip_smoke_kernels.yaml", lambda c: c[
        "MODEL"].update(PALLAS_KERNELS=True, FUSED_BLOCKS=True))
    kdet, kernel_launches, kernel_steady_ms = phase_main_path(
        torch, kernels_cfg, "kernels",
        {"stem_pool": 1, "depthwise": 3, "bottleneck": 7})
    phase_in_situ(torch, kdet, backbone_kernels_switch(kdet.model),
                  "depthwise + bottleneck kernels")
    phase_switch_latency(torch, kdet, backbone_kernels_switch(kdet.model),
                         "depthwise + bottleneck kernels")

    # the stage path, its latencies too before any profiled window
    stages_cfg = write_config("chip_smoke_stages.yaml", lambda c: c[
        "MODEL"].update(PALLAS_KERNELS=True, FUSED_BLOCKS=True,
                        FUSED_STAGES=True))
    sdet, stage_launches, stage_steady_ms = phase_main_path(
        torch, stages_cfg, "stages",
        {"stem_pool": 1, "depthwise": 3, "chain": flagship_chains()})
    phase_in_situ(torch, sdet, stages_switch(sdet.model), "stage chains")
    phase_switch_latency(torch, sdet, stages_switch(sdet.model),
                         "stage chains")
    stage_forward = {"stem_pool": 1, "depthwise": 3,
                     "chain": flagship_chains()}
    pooled = phase_pool(torch, sdet.model, stages_cfg, stage_forward, smi)
    phase_pool_float32(torch, stages_cfg)

    phase_serve_cli(stages_cfg)

    weights = phase_weights(torch)
    train = phase_train_path(torch, stem, weights)
    torch.cuda.empty_cache()
    evaluated = phase_eval_cli(torch, train)
    torch.cuda.empty_cache()
    serve_launches = phase_serve_load(torch, evaluated["cfg_path"],
                                      train["ckpt"])
    torch.cuda.empty_cache()
    lfb = phase_lfb(torch, evaluated["cfg_path"], train)
    torch.cuda.empty_cache()
    http_cfg = write_config("chip_smoke_lfb_stages.yaml", lambda c: (
        c["MODEL"].update(PALLAS_KERNELS=True, FUSED_BLOCKS=True,
                          FUSED_STAGES=True), c.update(USE_LFB=True)))
    http = phase_http(torch, http_cfg, stage_forward, smi)
    torch.cuda.empty_cache()
    model = phase_train_in_situ(torch, stem, train["cfg"])
    train_kernel_launches = phase_train_kernels(torch, train["cfg"])
    torch.cuda.empty_cache()
    frozen_chunk = phase_frozen_chunk(torch, stem, train, smi)
    torch.cuda.empty_cache()
    accum = phase_accum(torch, train, smi)
    torch.cuda.empty_cache()
    remat = phase_remat(torch, train, smi)
    torch.cuda.empty_cache()
    moe = phase_moe(torch, stem, train, stage_forward, sdet, smi)
    torch.cuda.empty_cache()
    prenorm = phase_prenorm(torch, stem, train, stage_forward, sdet, smi)
    torch.cuda.empty_cache()
    jhmdb = phase_jhmdb(torch, stem, weights, smi)
    torch.cuda.empty_cache()
    t_slice = time.perf_counter()
    phase_classify(torch, smi)
    torch.cuda.empty_cache()
    phase_segmentation(torch, smi)
    phase_streaming(torch, smi)
    phase_export(torch, train, evaluated["cfg_path"])
    torch.cuda.empty_cache()
    phase_pack(torch, jhmdb)
    torch.cuda.empty_cache()
    log(f"[surfaces] the classify, segmentation, streaming, export, plots "
        f"and pack phases: {time.perf_counter() - t_slice:.1f} s; {smi}")
    t_mesh = time.perf_counter()
    dp, tp = phase_mesh(torch, train, evaluated, lfb, stages_cfg,
                        stage_forward, smi)
    mesh_s = time.perf_counter() - t_mesh
    log(f"[time] the data- and tensor-parallel phases: {mesh_s:.1f} s")

    # the profiled windows last: a window slows the host work of its
    # process after it, so every time above is taken before the first
    phase_breakdown(torch, det, steady_ms, "breakdown",
                    ("stem_pool_tc_kernel",))
    phase_breakdown(torch, kdet, kernel_steady_ms, "kernels breakdown",
                    ("stem_pool_tc_kernel", "depthwise_kernel", "chain_kernel"))
    phase_breakdown(torch, sdet, stage_steady_ms, "stages breakdown",
                    ("stem_pool_tc_kernel", "depthwise_kernel", "chain_kernel"))
    bucket8 = pooled["by_bucket"][8]["exec_fetch_ms"]
    phase_breakdown(torch, sdet, bucket8, "pool breakdown",
                    ("stem_pool_tc_kernel", "depthwise_kernel", "chain_kernel"),
                    batch=8, what=f"one stage-path forward of 8 clips "
                    f"(against the pool's bucket-8 exec and fetch, "
                    f"{bucket8:.2f} ms; {smi})")
    for tag, opt in (("moe", moe), ("pre-norm", prenorm)):
        phase_breakdown(torch, opt.pop("det"), opt["forward_ms"][tag],
                        f"{tag} breakdown",
                        ("stem_pool_tc_kernel", "depthwise_kernel",
                         "chain_kernel"),
                        what=f"one {tag} stage-path forward (against its "
                        f"median in alternating pairs; the stage path's "
                        f"{opt['forward_ms']['stage path']:.2f} ms there)")
    del det, kdet, sdet
    torch.cuda.empty_cache()
    phase_jitter_and_train_breakdown(torch, stem, train["cfg"], model,
                                     train["steady_ms"])
    del model
    torch.cuda.empty_cache()
    phase_jhmdb_breakdown(torch, jhmdb)
    torch.cuda.empty_cache()
    phase_profile(torch, train)
    outside_s = time.perf_counter() - t_main - mesh_s
    log(f"[time] the mesh phase {mesh_s:.1f} s, the phases outside it "
        f"{outside_s:.1f} s: {mesh_s / outside_s:.3f}x (at most 1.40x)")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "flax", "optax", "orbax", "tubelet_transformer_tpu"))
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")

    # launches: each kernel's count on the path that runs it, set to 0 just
    # before that path: the stem kernels on the train path (the streaming
    # paths' count of the pooled kernel beside it), the depthwise and the
    # bottleneck on the kernel path (the train step's depthwise beside it),
    # the chain on the stage path; the unpooled stem, which no model path
    # runs, in its checks of phase 3; the assignment on the train path
    # (each train step and each validation forward with its losses). The
    # option phases' counts stand beside them (launches_<path>); the remat
    # step's depthwise count holds the backward's recompute: each of
    # layer1's 3 convs launches twice
    def entry(name, source, replaces, launches, measured, **extra):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms")
        if "/" not in replaces:
            replaces = f"ops/pallas/{replaces}"
        return {"name": name, "route": "cuda",
                "source": f"tubelet_transformer_tpu_torch/csrc/{source}",
                "replaces": f"tubelet_transformer_tpu/{replaces}",
                "launches": launches, **{k: measured[k] for k in keys},
                **extra}

    print(smi)
    print(json.dumps({"kernels": [
        entry("stem_pool", "stem.cu", "stem.py:134",
              train["launches"]["stem_pool"], pool,
              launches_streaming=stream_launches["stem_pool"],
              launches_pool=pooled["launches"]["stem_pool"],
              launches_http=http["launches"]["stem_pool"],
              launches_lfb_generate=lfb["generate_launches"]["stem_pool"],
              launches_lfb_train=lfb["train_launches"]["stem_pool"],
              b8_case=pools["ava_256px_b8"],
              launches_eval_ava=evaluated["launches"]["stem_pool"],
              launches_serve_load=serve_launches["stem_pool"],
              launches_jhmdb=jhmdb["launches"]["stem_pool"],
              launches_eval_jhmdb=jhmdb["eval_launches"]["stem_pool"],
              launches_frozen_chunk=frozen_chunk["launches"]["stem_pool"],
              launches_accum=accum["launches"]["stem_pool"],
              launches_moe_train=moe["train_launches"]["stem_pool"],
              launches_moe_serve=moe["serve_launches"]["stem_pool"],
              launches_prenorm_serve=prenorm["serve_launches"]["stem_pool"],
              launches_dp_step=dp["launches"]["stem_pool"],
              launches_zero1_step=dp["zero1_launches"]["stem_pool"],
              launches_moe_dp_step=dp["moe_launches"]["stem_pool"],
              launches_tp_step=[x["stem_pool"] for x in tp["launches"]],
              launches_tp_moe_step=[x["stem_pool"]
                                    for x in tp["moe_launches"]],
              launches_tp_data_model_step=[
                  x["stem_pool"] for x in tp["data_model_launches"]],
              launches_tp_zero1_step=[x["stem_pool"]
                                      for x in tp["zero1_launches"]],
              launches_lfb_generate_tp=tp["lfb_launches"],
              launches_serve_model2=tp["serve"]["model2"]["stem_pool"],
              launches_serve_data_model=tp["serve"]["data_model"][
                  "stem_pool"],
              launches_tp_spatial_step=[x["stem_pool"]
                                        for x in tp["spatial_launches"]],
              launches_tp_spatial_data_model_step=[
                  x["stem_pool"] for x in tp["spatial_data_model_launches"]],
              launches_spatial_eval=[x["stem_pool"]
                                     for x in tp["spatial_eval_launches"]],
              launches_pp_step=[x["stem_pool"] for x in tp["pp_launches"]],
              launches_pp_float32_step=[x["stem_pool"] for x in
                                        tp["pp_float32_launches"]],
              launches_pp_data_pipe_step=[
                  x["stem_pool"] for x in tp["pp_data_pipe_launches"]],
              launches_pp_zero1_step=[x["stem_pool"]
                                      for x in tp["pp_zero1_launches"]],
              launches_pp_eval=[x["stem_pool"]
                                for x in tp["pp_eval_launches"]],
              launches_tp_model3_step=[x["stem_pool"]
                                       for x in tp["model3_launches"]],
              launches_spatial_pipe_step=[
                  x["stem_pool"] for x in tp["spatial_pipe_launches"]],
              launches_spatial_jhmdb_step=[
                  x["stem_pool"] for x in tp["spatial_jhmdb_launches"]],
              launches_spatial_jhmdb_eval=[
                  x["stem_pool"] for x in tp["spatial_jhmdb_eval_launches"]],
              window_cases={k: {**v["stem_pool"], "peers": v["peers"],
                                "bit_equal_to_whole_clip":
                                    v["pool_bit_equal"]}
                            for k, v in windows.items()},
              jhmdb_cases={k: pools[k] for k in ("jhmdb_224x400",
                                                 "jhmdb_224x400_train")}),
        entry("stem_stats", "stem_stats.cu", "stem.py:388",
              train["launches"]["stem_stats"], stats,
              launches_lfb_train=lfb["train_launches"]["stem_stats"],
              launches_jhmdb=jhmdb["launches"]["stem_stats"],
              launches_frozen_chunk=frozen_chunk["launches"]["stem_stats"],
              launches_accum=accum["launches"]["stem_stats"],
              launches_moe_train=moe["train_launches"]["stem_stats"],
              launches_dp_step=dp["launches"]["stem_stats"],
              launches_zero1_step=dp["zero1_launches"]["stem_stats"],
              launches_moe_dp_step=dp["moe_launches"]["stem_stats"],
              launches_tp_step=[x["stem_stats"] for x in tp["launches"]],
              launches_tp_moe_step=[x["stem_stats"]
                                    for x in tp["moe_launches"]],
              launches_tp_data_model_step=[
                  x["stem_stats"] for x in tp["data_model_launches"]],
              launches_tp_zero1_step=[x["stem_stats"]
                                      for x in tp["zero1_launches"]],
              launches_tp_spatial_step=[x["stem_stats"]
                                        for x in tp["spatial_launches"]],
              launches_tp_spatial_data_model_step=[
                  x["stem_stats"] for x in tp["spatial_data_model_launches"]],
              launches_pp_step=[x["stem_stats"] for x in tp["pp_launches"]],
              launches_pp_float32_step=[x["stem_stats"] for x in
                                        tp["pp_float32_launches"]],
              launches_pp_data_pipe_step=[
                  x["stem_stats"] for x in tp["pp_data_pipe_launches"]],
              launches_pp_zero1_step=[x["stem_stats"]
                                      for x in tp["pp_zero1_launches"]],
              launches_tp_model3_step=[x["stem_stats"]
                                       for x in tp["model3_launches"]],
              launches_spatial_pipe_step=[
                  x["stem_stats"] for x in tp["spatial_pipe_launches"]],
              launches_spatial_jhmdb_step=[
                  x["stem_stats"] for x in tp["spatial_jhmdb_launches"]],
              window_cases={k: {**v["stem_stats"], "peers": v["peers"],
                                "rel_err_against_plain":
                                    v["stats_rel_err"]}
                            for k, v in windows.items()},
              jhmdb_cases={"jhmdb_224x400_train":
                           stats_cases["jhmdb_224x400_train"]},
              one_clip_case=stats_cases["ava_256px_clip"]),
        entry("depthwise", "depthwise.cu", "depthwise.py:66",
              kernel_launches["depthwise"], dw,
              also_replaces="tubelet_transformer_tpu/ops/pallas/"
                            "depthwise.py:184",
              launches_train_step=train_kernel_launches["depthwise"],
              launches_pool=pooled["launches"]["depthwise"],
              launches_http=http["launches"]["depthwise"],
              launches_remat_step=remat["launches"],
              launches_full_backprop_step=remat["launches_plain"],
              launches_moe_serve=moe["serve_launches"]["depthwise"],
              launches_prenorm_serve=prenorm["serve_launches"]["depthwise"],
              launches_serve_model2=tp["serve"]["model2"]["depthwise"],
              launches_serve_data_model=tp["serve"]["data_model"][
                  "depthwise"],
              launches_spatial_eval=[x["depthwise"]
                                     for x in tp["spatial_eval_launches"]],
              launches_pp_eval=[x["depthwise"]
                                for x in tp["pp_eval_launches"]],
              launches_spatial_jhmdb_eval=[
                  x["depthwise"] for x in tp["spatial_jhmdb_eval_launches"]],
              b8_case=dw_b8,
              library_with_copies_ms=dw["library_with_copies_ms"]),
        entry("bottleneck", "stage.cu", "bottleneck.py:57",
              kernel_launches["bottleneck"], bn,
              kernel="the stage chain's kernel with K = 1"),
        entry("stage_chain", "stage.cu", "stage.py:69",
              stage_launches["chain"], chain_totals(chains),
              per_forward="the sum of the flagship's three tails (one "
                          "launch each)",
              launches_pool=pooled["launches"]["chain"],
              launches_http=http["launches"]["chain"],
              launches_moe_serve=moe["serve_launches"]["chain"],
              launches_prenorm_serve=prenorm["serve_launches"]["chain"],
              launches_serve_model2=tp["serve"]["model2"]["chain"],
              launches_serve_data_model=tp["serve"]["data_model"]["chain"],
              launches_spatial_eval=[x["chain"]
                                     for x in tp["spatial_eval_launches"]],
              launches_pp_eval=[x["chain"] for x in tp["pp_eval_launches"]],
              launches_spatial_jhmdb_eval=[
                  x["chain"] for x in tp["spatial_jhmdb_eval_launches"]],
              b8_case=chain_totals(chains, "_b8"),
              spatial_cases=spatial_chain_cases(
                  chains, [x["chain"] for x in tp["spatial_eval_launches"]]),
              jhmdb_spatial_cases=jhmdb_spatial_chain_cases(
                  chains, [x["chain"]
                           for x in tp["spatial_jhmdb_eval_launches"]]),
              cases=chains),
        entry("stem_conv", "stem.cu", "stem.py:134",
              stem_conv_launches, stem_conv["ava_256px"],
              reached_by="no model path (nor in the JAX package): the "
                         "launches are phase 3's checks",
              variant="pool=False, via stem_conv_bn_relu (stem.py:580)",
              library_call="F.conv3d, conv only"),
        entry("assign", "assign.cu", "ops/matcher.py:37",
              train["launches"]["assign"], assign_cases["ava_train"],
              also_replaces="tubelet_transformer_tpu/ops/matcher.py:117",
              tpu_kernel="none: JAX's on-device loop (lax.fori_loop and "
                         "lax.while_loop), vmapped, outside Pallas",
              library_call="the port's former match: the costs copied to "
                           "the host, scipy's linear_sum_assignment",
              launches_per_train_step=train_kernel_launches["assign"],
              launches_per_eval_forward=evaluated["launches"]["assign"]
              / VAL_FORWARDS,
              launches_eval_ava=evaluated["launches"]["assign"],
              launches_jhmdb=jhmdb["launches"]["assign"],
              launches_eval_jhmdb=jhmdb["eval_launches"]["assign"],
              launches_lfb_train=lfb["train_launches"]["assign"],
              launches_frozen_chunk=frozen_chunk["launches"]["assign"],
              launches_accum=accum["launches"]["assign"],
              launches_moe_train=moe["train_launches"]["assign"],
              launches_remat_step=remat["launches_assign"],
              cases=assign_cases)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
