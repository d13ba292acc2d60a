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
   with the ReLU, max-pooled, bit for bit against the pooled stem), with
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
   off; then where the device time of one forward of each detector goes
   (torch.profiler), and the serving CLI through the stage path's YAML;
8. weights in, at flagship size: a Caffe2 ``.mat`` backbone, a COCO DETR
   ``detr.pth`` (100 query rows) and a ``module.``-prefixed TubeR ``.pth``
   written from a seed-1 model (``tools/fixtures.py``), each loaded into a
   seed-0 build on the card through ``train/checkpoint.py``, bit for bit,
   with the load times;
9. the train path: the flagship fine-tune recipe (TUNE_POINT 4: stem and
   layer1-2 frozen, their BN in train mode) through the ``train_ava``
   entry point on the synthetic set with PRETRAINED and LOAD_DETR pointed
   at phase 8's files, 4 steps at batch 2, one validation and a
   checkpoint, counting the kernel launches that path makes;
10. the eval CLI (``eval_ava``) on that checkpoint (MODEL.LOAD with
    PRETRAINED_PATH): its weights equal the checkpoint's, its frame mAP
    beside the train run's; then the serving CLI with MODEL.LOAD on it,
    in this process, its weights equal the checkpoint's too;
11. in situ, train: one flagship train forward with both stem kernels on
    and off;
12. one train step on uint8 clips, so that the HSV jitter runs on the card,
    and where the device time of a train step goes;
13. one flagship train step with ``MODEL.PALLAS_KERNELS`` on: layer1 is
    frozen (TUNE_POINT 4), so its 3 depthwise convs take the kernel under
    no_grad;
14. the JHMDB path at full width: ``train_jhmdb`` on
    configuration/tuber_csn152_jhmdb.yaml (CSN-152, 224 px on the 224x400
    canvas, T=32, 10 x 32 = 320 tubelet queries, bf16, batch 2, aux losses,
    TUNE_POINT 4 over phase 8's ``.mat``) on an ACT-detector fixture of
    random 320x240 frames, with its validation (frame and video mAP), then
    ``eval_jhmdb`` on its checkpoint; the loss finite, the frozen prefix
    bit-equal across the steps, both stem kernels in situ on the path's own
    inputs against their plain versions and a repeat launch, the steady
    step and the eval step, and where the device time of each goes.

The profiled windows of phases 7, 12 and 14 (where the device time goes)
run last, after every timed phase: a window slows the host work of its
process after it.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero and prints no result.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import glob
import json
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
# train path's batch of 2, and a shape the 8x8 pooled tiles do not divide,
# in bf16 (the tensor-core kernel's edge masking) and float32 (the CUDA-core
# kernel).
STEM_CASES = {"ava_256px": ((1, 32, 256, 256, 3), "bfloat16"),
              "jhmdb_224px": ((1, 32, 224, 224, 3), "bfloat16"),
              "ava_256px_train": ((2, 32, 256, 256, 3), "bfloat16"),
              "jhmdb_224x400": ((1, 32, 224, 400, 3), "bfloat16"),
              "jhmdb_224x400_train": ((2, 32, 224, 400, 3), "bfloat16"),
              "ragged_bf16": ((2, 3, 37, 45, 3), "bfloat16"),
              "ragged_f32": ((2, 3, 37, 45, 3), "float32")}
# Statistics kernel (x shape, dtype): the train path's batch of 2 at 256
# and 224 px, and shapes its 16x16 conv tiles do not divide: in bf16 (the
# tensor-core kernel's edge mask; ~1e6 conv pixels, as at the train shape,
# since the plain version's bf16 rounding noise shrinks as 1/sqrt(pixels))
# and in float32 (the CUDA-core kernel).
STATS_CASES = {"ava_256px_train": ((2, 32, 256, 256, 3), "bfloat16"),
               "jhmdb_224px_train": ((2, 32, 224, 224, 3), "bfloat16"),
               "jhmdb_224x400_train": ((2, 32, 224, 400, 3), "bfloat16"),
               "ragged_bf16": ((2, 32, 250, 230, 3), "bfloat16"),
               "ragged_f32": ((2, 3, 37, 45, 3), "float32")}
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
TRAIN_STEPS = 4        # SYNTHETIC_SIZE 8 at BATCH_SIZE 2
VAL_FORWARDS = 8       # SYNTHETIC_SIZE 8 at VAL.BATCH_SIZE 1
FRAMES = 88            # 64-frame window + 3 x 8: four keyframe detections
# Depthwise kernel (x, w, optional scale and bias: shape, dtype, epilogue):
# layer1 of CSN-152 at 256 px, bare and with the affine + ReLU epilogue; a
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
# the chain's checks: those three, two clips of five frames at layer2 (the
# reset of the depthwise's frame window at each clip's edges), and float32
# at a shape the 8x8 tiles do not divide
CHAIN_CASES = {**{f"{k}_256px": (v, "bfloat16") for k, v in
                  FLAGSHIP_TAILS.items()},
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
            f"repeat bit-equal {bits}; kernel {ms:.4f} ms (the device alone "
            f"{device_ms:.4f} ms, {gflop / device_ms:.2f} TFLOP/s, "
            f"{bound_ms / device_ms:.3f} of the bound), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not (err <= tol * span and bits):
            raise AssertionError(f"stem {name}: kernel disagrees with plain "
                                 f"({err} > {tol} * {span}) or repeats "
                                 f"differ ({bits})")
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
            f"bit-equal {bits}; kernel "
            f"{ms:.4f} ms (the device alone {device_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, cuDNN grouped conv "
            f"{library_ms:.4f} ms ({copies_ms:.4f} ms with the two layout "
            f"copies), bound {bound_ms:.4f} ms ({bound_by})")
        if not (err <= tol * span and bits):
            raise AssertionError(f"depthwise {name}: kernel disagrees with "
                                 f"plain ({err} > {tol} * {span}) or "
                                 f"repeats differ ({bits})")
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
        ref64 = S.chain_reference_rounded(args[0], args[1:], torch.float64)
        ref32 = S.chain_reference_rounded(args[0], args[1:])
        unrounded = S.chain_reference(args[0].float(),
                                      [a.float() for a in args[1:]])
        errs, limits, plain_errs, unrounded_errs = [], [], [], []
        for i in range(b):
            span = ref64[i].abs().max().item()
            errs.append((got[i].double() - ref64[i]).abs().max().item())
            plain_errs.append((ref32[i].double() - ref64[i]).abs().max()
                              .item())
            unrounded_errs.append((got[i].float() - unrounded[i]).abs()
                                  .max().item() / span)
            limits.append(max(CHAIN_TOL * span, 2 * plain_errs[-1]))
        finite = bool(torch.isfinite(got).all())
        span = ref64.abs().max().item()
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
            f"launch {repeat}; max_abs_err per clip vs the float64 rounded "
            f"plain version {[round(e, 5) for e in errs]} (limits "
            f"{[round(v, 5) for v in limits]}; the float32 rounded plain "
            f"version's {[round(e, 5) for e in plain_errs]}; max|ref| "
            f"{span:.4g}), vs the unrounded plain version "
            f"{[round(e, 4) for e in unrounded_errs]} of max|ref|; kernel "
            f"{ms:.4f} ms (the device alone {device_ms:.4f} ms, "
            f"{ops / device_ms / 1e9:.2f} TFLOP/s, "
            f"{bound_ms / device_ms:.3f} of the bound), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not (exact and repeat and finite and all(
                e <= v for e, v in zip(errs, limits))):
            raise AssertionError(f"stage_chain {name}: the kernel disagrees "
                                 f"with its one-block launches ({exact}), a "
                                 f"repeat ({repeat}) or the plain version "
                                 f"({errs} vs {limits})")
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


def phase_small_reference(torch, stem) -> None:
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = small_config()
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
        raise AssertionError("small model on the card did not run the stem "
                             "kernel")
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        err = (got[k].cpu() - ref[k]).abs().max().item()
        log(f"[small] CSN-TINY f32 card vs CPU {k}: max_abs_err {err:.3g} "
            f"(tol {SMALL_TOL})")
        if not err <= SMALL_TOL:
            raise AssertionError(f"small model {k}: card and CPU disagree")


def launch_counts() -> dict:
    """Launches of each kernel of the port in this process, by name."""
    from tubelet_transformer_tpu_torch.ops.cuda import (bottleneck,
                                                        depthwise, stage,
                                                        stem)

    return {"stem_pool": stem.LAUNCHES, "stem_stats": stem.STATS_LAUNCHES,
            "stem_conv": stem.CONV_LAUNCHES, "depthwise": depthwise.LAUNCHES,
            "bottleneck": bottleneck.LAUNCHES, "chain": stage.LAUNCHES}


def zero_counts() -> None:
    from tubelet_transformer_tpu_torch.ops.cuda import (bottleneck,
                                                        depthwise, stage,
                                                        stem)

    stem.LAUNCHES = stem.STATS_LAUNCHES = stem.CONV_LAUNCHES = 0
    depthwise.LAUNCHES = bottleneck.LAUNCHES = stage.LAUNCHES = 0


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


def chain_totals(chains: dict) -> dict:
    """The chain's numbers for one flagship forward: the times and bounds of
    its three tails added (one launch each, in turn), the largest error, the
    bound's kind of the largest bound."""
    tails = [chains[f"{k}_256px"] for k in FLAGSHIP_TAILS]
    return {"max_abs_err": max(c["max_abs_err"] for c in tails),
            **{k: sum(c[k] for c in tails) for k in ("ms", "plain_ms",
                                                     "bound_ms",
                                                     "device_ms")},
            "bound_by": max(tails, key=lambda c: c["bound_ms"])["bound_by"],
            "library_ms": None}


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
    log(f"[{tag}] {what}: device kernel time {total:.3f} ms "
        f"({100 * total / wall_ms:.1f}% of {wall_ms:.2f} ms); by aten op "
        f"(self device time):")
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
                    kernels) -> None:
    from torch.profiler import ProfilerActivity, profile

    from tubelet_transformer_tpu_torch.data.device_preprocess import (
        device_preprocess)

    model = det.model
    clip = torch.zeros((1, 32, 256, 256, 3), dtype=torch.uint8, device="cuda")
    with torch.inference_mode():
        x = device_preprocess(clip, dtype=model.dtype)
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    _report_device_time(torch, prof, tag, "one flagship forward "
                        "(against the steady keyframe latency)", steady_ms,
                        kernels)


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
    from tubelet_transformer_tpu_torch.ops import matcher
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

    # per-step wall time (each step ends in a host sync) and the host time
    # of the assignment solve
    steps, solves = [], []
    make_train_step, lsa = engine.make_train_step, matcher.linear_sum_assignment

    def timed_make(cfg_, state):
        step = make_train_step(cfg_, state)

        def timed(batch, weight):
            t0 = time.perf_counter()
            metrics = step(batch, weight)
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t0) * 1e3,
                          float(metrics["total_loss"]),
                          float(metrics["finite"])))
            return metrics

        return timed

    def timed_lsa(cost):
        t0 = time.perf_counter()
        out = lsa(cost)
        solves.append((len(steps), time.perf_counter() - t0))
        return out

    engine.make_train_step, matcher.linear_sum_assignment = (timed_make,
                                                             timed_lsa)
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
        engine.make_train_step, matcher.linear_sum_assignment = (
            make_train_step, lsa)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if len(steps) != TRAIN_STEPS or not all(
            fin == 1.0 and np.isfinite(loss) for _, loss, fin in steps):
        raise AssertionError(f"train steps {steps}: want {TRAIN_STEPS} "
                             "finite ones")
    if launches != {"stem_pool": TRAIN_STEPS + VAL_FORWARDS,
                    "stem_stats": TRAIN_STEPS, "stem_conv": 0,
                    "depthwise": 0, "bottleneck": 0, "chain": 0}:
        raise AssertionError(f"kernel launches {launches}, want "
                             f"{TRAIN_STEPS + VAL_FORWARDS} pooled and "
                             f"{TRAIN_STEPS} statistics")
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
    # solves made while step i ran are tagged i; validation's come after
    solve_ms = {"train": 0.0, "val": 0.0}
    for tag, sec in solves:
        solve_ms["train" if tag < TRAIN_STEPS else "val"] += sec * 1e3
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
        f"{statistics.median(step_ms[1:]):.2f}; matcher host solve (scipy, "
        f"all layers) {solve_ms['train'] / TRAIN_STEPS:.3f} ms per train "
        f"step, {solve_ms['val'] / VAL_FORWARDS:.3f} ms per eval forward; "
        f"peak device "
        f"memory {peak_gb:.2f} GB; train_ava wall {wall:.1f} s")
    return {"cfg": cfg, "cfg_path": cfg_path, "launches": launches,
            "ckpt": ckpt,
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
    where the device time of a train step goes (torch.profiler)."""
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
                         "stem_stats_finalize_kernel"), top=14,
                        ops=BN_STATS_OPS)


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
            "bottleneck": 0, "chain": 0}
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
            "stem_pool"] != VAL_FORWARDS:
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

    def timed_make(cfg_, state):
        step = make(cfg_, state)

        def timed(batch, weight):
            t = time.perf_counter()
            metrics = step(batch, weight)
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t) * 1e3,
                          float(metrics["total_loss"]),
                          float(metrics["finite"])))
            return metrics

        return timed

    stem_in: dict = {"stats": [], "pool": []}

    def keep(kind, fn):
        def wrapped(x, w, *rest):
            if not any(a[0].shape == x.shape for a in stem_in[kind]):
                stem_in[kind].append((x.detach().clone(), w.clone(),
                                      *(r.detach().clone() for r in rest)))
            return fn(x, w, *rest)
        return wrapped

    saved_fns = (csn.stem_batch_stats, csn.stem_forward)
    csn.stem_batch_stats = keep("stats", saved_fns[0])
    csn.stem_forward = keep("pool", saved_fns[1])
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
                    "chain": 0}:
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
        f"{maps['val/video_mAP@0.5']:.4f}; launches {launches}; wall "
        f"{wall:.1f} s")
    log(f"[jhmdb] step ms: first {step_ms[0]:.2f}, steady median (after "
        f"the first) {statistics.median(step_ms[1:]):.2f} (min "
        f"{min(step_ms[1:]):.2f}, max {max(step_ms[1:]):.2f}); {smi}")

    # #2 and #4 in situ: the path's own stem inputs
    insitu = {}
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
            log(f"[jhmdb in situ] {'stem_stats' if kind == 'stats' else 'stem_pool'}"
                f" {shape} on the path's clips: kernel vs plain {err}; "
                f"repeat bit-equal {bits}")
            if not (ok and bits):
                raise AssertionError(f"jhmdb in situ {kind} {shape}")
            insitu[f"{kind}_{shape[0]}"] = True
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
    if not (np.isfinite(res["mAP"]) and eval_launches["stem_pool"] == n_val):
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on a GPU only",
              file=sys.stderr)
        return 1
    from tubelet_transformer_tpu_torch.ops.cuda import stem

    smi = phase_environment(torch)
    phase_build()
    pools = phase_kernels(torch, stem)
    pool = pools["ava_256px_train"]
    stats_cases = phase_stats_kernel(torch, stem)
    stats = stats_cases["ava_256px_train"]
    dw = phase_depthwise_kernel(torch)["layer1_256px"]
    bn = phase_bottleneck_kernel(torch)["layer2_256px"]
    chains = phase_stage_kernel(torch)
    stem_conv, stem_conv_launches = phase_stem_conv_kernel(torch, stem)
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

    phase_serve_cli(stages_cfg)

    weights = phase_weights(torch)
    train = phase_train_path(torch, stem, weights)
    torch.cuda.empty_cache()
    evaluated = phase_eval_cli(torch, train)
    torch.cuda.empty_cache()
    serve_launches = phase_serve_load(torch, evaluated["cfg_path"],
                                      train["ckpt"])
    torch.cuda.empty_cache()
    model = phase_train_in_situ(torch, stem, train["cfg"])
    train_kernel_launches = phase_train_kernels(torch, train["cfg"])
    torch.cuda.empty_cache()
    jhmdb = phase_jhmdb(torch, stem, weights, smi)
    torch.cuda.empty_cache()

    # the profiled windows last: a window slows the host work of its
    # process after it, so every time above is taken before the first
    phase_breakdown(torch, det, steady_ms, "breakdown",
                    ("stem_pool_tc_kernel",))
    phase_breakdown(torch, kdet, kernel_steady_ms, "kernels breakdown",
                    ("stem_pool_tc_kernel", "depthwise_kernel", "chain_kernel"))
    phase_breakdown(torch, sdet, stage_steady_ms, "stages breakdown",
                    ("stem_pool_tc_kernel", "depthwise_kernel", "chain_kernel"))
    del det, kdet, sdet
    torch.cuda.empty_cache()
    phase_jitter_and_train_breakdown(torch, stem, train["cfg"], model,
                                     train["steady_ms"])
    del model
    torch.cuda.empty_cache()
    phase_jhmdb_breakdown(torch, jhmdb)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "flax", "optax", "orbax", "tubelet_transformer_tpu"))
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")

    # launches: each kernel's count on the path that runs it, set to 0 just
    # before that path: the stem kernels on the train path (the streaming
    # paths' count of the pooled kernel beside it), the depthwise and the
    # bottleneck on the kernel path (the train step's depthwise beside it),
    # the chain on the stage path; the unpooled stem, which no model path
    # runs, in its checks of phase 3
    def entry(name, source, replaces, launches, measured, **extra):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms")
        return {"name": name, "route": "cuda",
                "source": f"tubelet_transformer_tpu_torch/csrc/{source}",
                "replaces": f"tubelet_transformer_tpu/ops/pallas/{replaces}",
                "launches": launches, **{k: measured[k] for k in keys},
                **extra}

    print(smi)
    print(json.dumps({"kernels": [
        entry("stem_pool", "stem.cu", "stem.py:134",
              train["launches"]["stem_pool"], pool,
              launches_streaming=stream_launches["stem_pool"],
              launches_eval_ava=evaluated["launches"]["stem_pool"],
              launches_serve_load=serve_launches["stem_pool"],
              launches_jhmdb=jhmdb["launches"]["stem_pool"],
              launches_eval_jhmdb=jhmdb["eval_launches"]["stem_pool"],
              jhmdb_cases={k: pools[k] for k in ("jhmdb_224x400",
                                                 "jhmdb_224x400_train")}),
        entry("stem_stats", "stem_stats.cu", "stem.py:388",
              train["launches"]["stem_stats"], stats,
              launches_jhmdb=jhmdb["launches"]["stem_stats"],
              jhmdb_cases={"jhmdb_224x400_train":
                           stats_cases["jhmdb_224x400_train"]}),
        entry("depthwise", "depthwise.cu", "depthwise.py:66",
              kernel_launches["depthwise"], dw,
              also_replaces="tubelet_transformer_tpu/ops/pallas/"
                            "depthwise.py:184",
              launches_train_step=train_kernel_launches["depthwise"],
              library_with_copies_ms=dw["library_with_copies_ms"]),
        entry("bottleneck", "stage.cu", "bottleneck.py:57",
              kernel_launches["bottleneck"], bn,
              kernel="the stage chain's kernel with K = 1"),
        entry("stage_chain", "stage.cu", "stage.py:69",
              stage_launches["chain"], chain_totals(chains),
              per_forward="the sum of the flagship's three tails (one "
                          "launch each)",
              cases=chains),
        entry("stem_conv", "stem.cu", "stem.py:134",
              stem_conv_launches, stem_conv["ava_256px"],
              reached_by="no model path (nor in the JAX package): the "
                         "launches are phase 3's checks",
              variant="pool=False, via stem_conv_bn_relu (stem.py:580)",
              library_call="F.conv3d, conv only")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
