#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tubelet_transformer_tpu_torch) on one
NVIDIA GPU.

Phases, each of which raises (and so exits non-zero) on failure:

1. environment: torch, CUDA, the card, its power limit, nvcc;
2. build of the hand-written CUDA kernels from ``csrc/`` into one library;
3. each kernel against its plain PyTorch version at the shapes the main
   paths give it (the statistics kernel also in float32 at a shape its
   tiles do not divide), with CUDA-event times of both;
4. small-input references: the port on the card against the port on the
   CPU (which the tests hold against the JAX package), float32, CSN-TINY:
   the forward, and one train step;
5. the streaming path: the flagship CSN-152 TubeR streaming detector
   (configuration/tuber_csn152_ava22.yaml, random weights from a seed) on
   synthetic 240x320 frames, >= 3 keyframe detections, counting the kernel
   launches that path makes;
6. in situ: one flagship clip with the stem kernel on and off;
7. where the device time of one flagship forward goes (torch.profiler);
8. the train path: the flagship fine-tune recipe (TUNE_POINT 4: stem and
   layer1-2 frozen, their BN in train mode) through the ``train_ava``
   entry point on the synthetic set, 4 steps at batch 2, one validation
   and a checkpoint, counting the kernel launches that path makes;
9. in situ, train: one flagship train forward with both stem kernels on
   and off;
10. one train step on uint8 clips, so that the HSV jitter runs on the card,
    and where the device time of a train step goes.

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
STEM_SHAPES = {"ava_256px": (1, 32, 256, 256, 3),
               "jhmdb_224px": (1, 32, 224, 224, 3),
               "ava_256px_train": (2, 32, 256, 256, 3)}
STATS_CASES = {"ava_256px_train": ((2, 32, 256, 256, 3), "bfloat16"),
               "jhmdb_224px_train": ((2, 32, 224, 224, 3), "bfloat16"),
               "ragged_f32": ((2, 3, 37, 45, 3), "float32")}
BUILD_DIR = ROOT / "build"
# Kernel against plain, bf16: the plain version rounds the conv output to
# bf16 before the f32 epilogue, the kernel rounds once at the end; each
# rounding is <= 2^-9 relative, so 2^-6 of the output's range is 4x margin.
STEM_TOL = 2.0 ** -6
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


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, warmup: int = 5, runs: int = 25) -> float:
    """Median over ``runs`` of one call's CUDA-event time, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_build(stem) -> None:
    """One nvcc for both kernels' library; a failure raises."""
    from tubelet_transformer_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    stem.library(verbose=True)
    wall = time.perf_counter() - t0
    built = {k: round(v, 2) for k, v in build.BUILD_SECONDS.items()}
    log(f"[build] kernel library: nvcc seconds {built or 'already built'}"
        f", {wall:.2f} s to build and load")


def _dev(torch, a, dtype):
    return torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)


def phase_kernels(torch, stem) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    results = {}
    for name, shape in STEM_SHAPES.items():
        x = _dev(torch, rng.normal(size=shape), torch.bfloat16)
        w = _dev(torch, rng.normal(size=stem.W_SHAPE) * 0.05, torch.bfloat16)
        scale = _dev(torch, rng.uniform(0.5, 2.0, 64), torch.float32)
        bias = _dev(torch, rng.normal(size=64), torch.float32)
        got = stem.stem_forward(x, w, scale, bias)
        torch.cuda.synchronize()
        ref = stem.stem_reference(x, w, scale, bias)
        if got.shape != ref.shape:
            raise AssertionError(f"stem {name}: shape {tuple(got.shape)} "
                                 f"!= {tuple(ref.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        span = ref.float().abs().max().item()
        ms = time_ms(torch, lambda: stem.stem_forward(x, w, scale, bias))
        plain_ms = time_ms(torch,
                           lambda: stem.stem_reference(x, w, scale, bias))
        b, t, h, wd, _ = shape
        gflop = 2 * b * t * ((h + 1) // 2) * ((wd + 1) // 2) * 64 * 441 / 1e9
        log(f"[kernel] stem_pool {name} {shape} bf16: max_abs_err {err:.6g} "
            f"(rel to max|ref| {err / span:.3g}, tol {STEM_TOL:.3g}); "
            f"kernel {ms:.4f} ms ({gflop / ms:.2f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms")
        if not err <= STEM_TOL * span:
            raise AssertionError(f"stem {name}: kernel disagrees with plain "
                                 f"({err} > {STEM_TOL} * {span})")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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
        plain_ms = time_ms(torch,
                           lambda: stem.stem_batch_stats_reference(x, w))
        b, t, h, wd, _ = shape
        gflop = 2 * b * t * ((h + 1) // 2) * ((wd + 1) // 2) * 64 * 441 / 1e9
        mean_tol = STATS_MEAN_TOL[dtype_name]
        var_tol = STATS_VAR_TOL[dtype_name]
        log(f"[kernel] stem_stats {name} {shape} {dtype_name}: mean "
            f"max_abs_err {mean_err:.4g} (rel to max std {mean_err / std:.3g},"
            f" tol {mean_tol:.3g}); var max_abs_err {var_err:.4g} (max rel "
            f"{var_rel:.3g}, tol {var_tol:.3g}); repeat bit-equal {bits}; "
            f"kernel {ms:.4f} ms ({gflop / ms:.2f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms")
        if not (mean_err <= mean_tol * std and var_rel <= var_tol and bits):
            raise AssertionError(f"stem_stats {name}: kernel disagrees with "
                                 "plain, or repeats differ")
        results[name] = {"max_abs_err": max(mean_err, var_err), "ms": ms,
                         "plain_ms": plain_ms}
    return results


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


def phase_main_path(torch, stem):
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.serving import StreamingDetector

    cfg = load_config(str(FLAGSHIP_CONFIG))
    t0 = time.perf_counter()
    # actor_threshold -1 admits every query, so every output is checked
    det = StreamingDetector(cfg, fps=8.0, detect_every=8, rng_seed=0,
                            actor_threshold=-1.0, device="cuda")
    log(f"[main] {cfg.model.backbone_name} {cfg.data.img_size}px "
        f"T={cfg.data.temp_len} d={cfg.model.d_model} "
        f"{cfg.model.enc_layers}+{cfg.model.dec_layers} "
        f"{cfg.model.temporal_ds_strategy} {cfg.model.compute_dtype}: "
        f"built with random weights in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
              for _ in range(FRAMES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stem.LAUNCHES = 0
    results = [r for f in frames if (r := det.push_frame(f)) is not None]
    launches = stem.LAUNCHES
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
    if launches != len(results):
        raise AssertionError(f"stem kernel launched {launches} times for "
                             f"{len(results)} detections")
    lat = [r.latency_ms for r in results]
    log(f"[main] keyframes {[r.frame_index for r in results]}; stem kernel "
        f"launches {launches}; latency ms per keyframe "
        f"{[round(v, 3) for v in lat]}; steady (excluding the first) mean "
        f"{statistics.mean(lat[1:]):.3f} median "
        f"{statistics.median(lat[1:]):.3f}; peak device memory "
        f"{peak_gb:.2f} GB")
    return det, launches, statistics.median(lat[1:])


def phase_in_situ(torch, det) -> None:
    from tubelet_transformer_tpu_torch.data.device_preprocess import (
        device_preprocess)

    model = det.model
    body = model.backbone.body
    rng = np.random.default_rng(2)
    clip = torch.from_numpy(rng.integers(
        0, 256, (1, 32, 256, 256, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        x = device_preprocess(clip, dtype=model.dtype)
        on = model(x)
        body.stem_kernel = False
        try:
            off = model(x)
        finally:
            body.stem_kernel = True
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        diff = (on[k] - off[k]).abs().max().item()
        span = max(1.0, off[k].abs().max().item())
        log(f"[in situ] flagship stem kernel on vs off {k}: max_abs_diff "
            f"{diff:.4g} (max|off| {off[k].abs().max().item():.4g}, tol "
            f"{IN_SITU_TOL} x {span:.4g})")
        if not (torch.isfinite(on[k]).all() and diff <= IN_SITU_TOL * span):
            raise AssertionError(f"in situ {k}: kernel-on and kernel-off "
                                 "model outputs disagree")


def _report_device_time(torch, prof, tag: str, what: str, wall_ms: float,
                        kernels, top: int = 10) -> None:
    """Device time of a profiled window: the total, the top aten ops by
    self device time, and the named hand-written kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    total = sum(ev.device_time_total for ev in prof.events()
                if ev.device_type == cuda) / 1e3
    if not total:
        log(f"[{tag}] the profiler saw no device time: not measured")
        return
    # device time of the kernels each aten op launched itself; kernels
    # launched outside aten (the ctypes stem kernels) are listed by name
    ops = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
           for ev in prof.key_averages()
           if ev.device_type != cuda and ev.self_device_time_total > 0]
    attributed = sum(ms for _, ms, _ in ops)
    log(f"[{tag}] {what}: device kernel time {total:.3f} ms "
        f"({100 * total / wall_ms:.1f}% of {wall_ms:.2f} ms); by aten op "
        f"(self device time):")
    for name, ms, count in sorted(ops, key=lambda o: -o[1])[:top]:
        log(f"[{tag}]   {ms:8.3f} ms {100 * ms / total:5.1f}%  "
            f"{name} x{count}")
    for ev in prof.key_averages():
        if ev.device_type == cuda and any(k in ev.key for k in kernels):
            log(f"[{tag}]   {ev.device_time_total / 1e3:8.3f} ms "
                f"{100 * ev.device_time_total / 1e3 / total:5.1f}%  "
                f"{ev.key[:60]} x{ev.count}")
    log(f"[{tag}] device time outside aten ops: {total - attributed:.3f} ms")


def phase_breakdown(torch, det, steady_ms: float) -> None:
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
    _report_device_time(torch, prof, "breakdown", "one flagship forward "
                        "(against the steady keyframe latency)", steady_ms,
                        ("stem_pool_kernel",))


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


def phase_train_path(torch, stem) -> dict:
    """The flagship fine-tune recipe through the train_ava entry point,
    on the synthetic set; returns the config and the measurements."""
    import yaml

    from tubelet_transformer_tpu_torch.cli import train_ava
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.ops import matcher
    from tubelet_transformer_tpu_torch.train import engine
    from tubelet_transformer_tpu_torch.train.optimizer import param_label

    with open(FLAGSHIP_CONFIG) as f:
        tree = yaml.safe_load(f)
    c = tree["CONFIG"]
    c["DATA"].update(DATASET_NAME="synthetic", SYNTHETIC_SIZE=8,
                     LABEL_PATH="")
    c["TRAIN"]["EPOCH_NUM"] = 1
    c["MODEL"].update(PRETRAIN_BACKBONE_DIR="", LOAD_DETR=False)
    base = BUILD_DIR / "chip_smoke_runs"
    c["LOG"]["BASE_PATH"] = str(base)
    BUILD_DIR.mkdir(exist_ok=True)
    cfg_path = BUILD_DIR / "chip_smoke_train.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(tree, f)
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
    stem.LAUNCHES = stem.STATS_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        train_ava.main()
    finally:
        sys.argv = argv
        engine.make_train_step, matcher.linear_sum_assignment = (
            make_train_step, lsa)
    wall = time.perf_counter() - t0
    launches = {"stem_pool": stem.LAUNCHES, "stem_stats": stem.STATS_LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if len(steps) != TRAIN_STEPS or not all(
            fin == 1.0 and np.isfinite(loss) for _, loss, fin in steps):
        raise AssertionError(f"train steps {steps}: want {TRAIN_STEPS} "
                             "finite ones")
    if launches != {"stem_pool": TRAIN_STEPS + VAL_FORWARDS,
                    "stem_stats": TRAIN_STEPS}:
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
    start = build_model(cfg, device="cpu", seed=0, train=True).state_dict()
    frozen_moved, trained_still = [], []
    for name, value in start.items():
        if name.endswith("num_batches_tracked"):
            continue
        label = (param_label(name, cfg) if not name.endswith(
            ("running_mean", "running_var")) else "stats")
        same = torch.equal(final[name], value)
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
        f"{ckpt.relative_to(ROOT)}; launches {launches}; frozen params "
        f"bit-equal, trained params moved "
        f"({len(trained_still)} unchanged: {trained_still[:3]}), stem BN "
        f"running stats moved")
    log(f"[train] step ms {[round(v, 2) for v in step_ms]}: first "
        f"{step_ms[0]:.2f}, steady median (after the first) "
        f"{statistics.median(step_ms[1:]):.2f}; matcher host solve (scipy, "
        f"all layers) {solve_ms['train'] / TRAIN_STEPS:.3f} ms per train "
        f"step, {solve_ms['val'] / VAL_FORWARDS:.3f} ms per eval forward; "
        f"peak device "
        f"memory {peak_gb:.2f} GB; train_ava wall {wall:.1f} s")
    return {"cfg": cfg, "launches": launches,
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
                losses = engine.compute_losses(cfg, out, engine._targets(
                    batch))
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
                        ("stem_pool_kernel", "stem_stats_partial_kernel",
                         "stem_stats_finalize_kernel"), top=14)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on a GPU only",
              file=sys.stderr)
        return 1
    from tubelet_transformer_tpu_torch.ops.cuda import stem

    smi = phase_environment(torch)
    phase_build(stem)
    pool = phase_kernels(torch, stem)["ava_256px_train"]
    stats = phase_stats_kernel(torch, stem)["ava_256px_train"]
    phase_small_reference(torch, stem)
    phase_small_train_reference(torch, stem)
    det, stream_launches, steady_ms = phase_main_path(torch, stem)
    phase_in_situ(torch, det)
    phase_breakdown(torch, det, steady_ms)
    del det
    torch.cuda.empty_cache()
    train = phase_train_path(torch, stem)
    torch.cuda.empty_cache()
    model = phase_train_in_situ(torch, stem, train["cfg"])
    phase_jitter_and_train_breakdown(torch, stem, train["cfg"], model,
                                     train["steady_ms"])
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "optax", "orbax"))
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")

    # launches: the train path's run (counts set to 0 just before it);
    # the streaming path's own count of the pooled kernel beside it
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "stem_pool", "route": "cuda",
         "source": "tubelet_transformer_tpu_torch/csrc/stem.cu",
         "replaces": "tubelet_transformer_tpu/ops/pallas/stem.py:134",
         "launches": train["launches"]["stem_pool"],
         "launches_streaming": stream_launches,
         "max_abs_err": pool["max_abs_err"], "ms": pool["ms"],
         "plain_ms": pool["plain_ms"]},
        {"name": "stem_stats", "route": "cuda",
         "source": "tubelet_transformer_tpu_torch/csrc/stem_stats.cu",
         "replaces": "tubelet_transformer_tpu/ops/pallas/stem.py:388",
         "launches": train["launches"]["stem_stats"],
         "max_abs_err": stats["max_abs_err"], "ms": stats["ms"],
         "plain_ms": stats["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
