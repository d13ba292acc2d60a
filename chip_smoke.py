#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tubelet_transformer_tpu_torch) on one
NVIDIA GPU.

Phases, each of which raises (and so exits non-zero) on failure:

1. environment: torch, CUDA, the card, its power limit, nvcc;
2. build of the hand-written CUDA kernels from ``csrc/``;
3. each kernel against its plain PyTorch version at the shapes the main
   path gives it, with CUDA-event times of both;
4. a small-input reference: the port on the card against the port on the
   CPU (which the tests hold against the JAX package), float32, CSN-TINY;
5. the main path: the flagship CSN-152 TubeR streaming detector
   (configuration/tuber_csn152_ava22.yaml, random weights from a seed) on
   synthetic 240x320 frames, >= 3 keyframe detections, counting the kernel
   launches that path makes;
6. in situ: one flagship clip with the stem kernel on and off;
7. where the device time of one flagship forward goes (torch.profiler).

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero and prints no result.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

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
               "jhmdb_224px": (1, 32, 224, 224, 3)}
# Kernel against plain, bf16: the plain version rounds the conv output to
# bf16 before the f32 epilogue, the kernel rounds once at the end; each
# rounding is <= 2^-9 relative, so 2^-6 of the output's range is 4x margin.
STEM_TOL = 2.0 ** -6
# Flagship model, stem kernel on against off, bf16: the two stems differ by
# ~1 bf16 ulp on some elements; 50 bottlenecks and 12 transformer layers of
# bf16 arithmetic carry that on. 0.05 of each output's range (~13 ulp)
# separates that noise from a wrong stem, which moves outputs by O(1).
IN_SITU_TOL = 0.05
# Small-input reference, float32 with TF32 off on the card: sums in
# another order only.
SMALL_TOL = 1e-4
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
    from tubelet_transformer_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    stem.library(verbose=True)
    wall = time.perf_counter() - t0
    built = build.BUILD_SECONDS.get("tuber_stem")
    log(f"[build] stem kernel library: "
        + (f"nvcc {built:.2f} s" if built is not None else "already built")
        + f", {wall:.2f} s to load")


def phase_kernels(torch, stem) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    results = {}
    for name, shape in STEM_SHAPES.items():
        def dev(a, dtype=torch.bfloat16):
            return torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)

        x = dev(rng.normal(size=shape))
        w = dev(rng.normal(size=stem.W_SHAPE) * 0.05)
        scale = dev(rng.uniform(0.5, 2.0, 64), torch.float32)
        bias = dev(rng.normal(size=64), torch.float32)
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
        log(f"[kernel] stem {name} {shape} bf16: max_abs_err {err:.6g} "
            f"(rel to max|ref| {err / span:.3g}, tol {STEM_TOL:.3g}); "
            f"kernel {ms:.4f} ms ({gflop / ms:.2f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms")
        if not err <= STEM_TOL * span:
            raise AssertionError(f"stem {name}: kernel disagrees with plain "
                                 f"({err} > {STEM_TOL} * {span})")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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
    cuda = torch.autograd.DeviceType.CUDA
    total = sum(ev.device_time_total for ev in prof.events()
                if ev.device_type == cuda) / 1e3
    if not total:
        log("[breakdown] the profiler saw no device time: not measured")
        return
    # device time of the kernels each aten op launched itself; kernels
    # launched outside aten (the ctypes stem) are listed by kernel name
    ops = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
           for ev in prof.key_averages()
           if ev.device_type != cuda and ev.self_device_time_total > 0]
    attributed = sum(ms for _, ms, _ in ops)
    log(f"[breakdown] one flagship forward: device kernel time {total:.3f} "
        f"ms ({100 * total / steady_ms:.1f}% of the steady keyframe "
        f"latency); by aten op (self device time):")
    for name, ms, count in sorted(ops, key=lambda o: -o[1])[:10]:
        log(f"[breakdown]   {ms:8.3f} ms {100 * ms / total:5.1f}%  "
            f"{name} x{count}")
    for ev in prof.key_averages():
        if ev.device_type == cuda and "stem_pool_kernel" in ev.key:
            log(f"[breakdown]   {ev.device_time_total / 1e3:8.3f} ms "
                f"{100 * ev.device_time_total / 1e3 / total:5.1f}%  "
                f"stem kernel x{ev.count}")
    log(f"[breakdown] device time outside aten ops: "
        f"{total - attributed:.3f} ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on a GPU only",
              file=sys.stderr)
        return 1
    from tubelet_transformer_tpu_torch.ops.cuda import stem

    smi = phase_environment(torch)
    phase_build(stem)
    stem_results = phase_kernels(torch, stem)
    phase_small_reference(torch, stem)
    det, launches, steady_ms = phase_main_path(torch, stem)
    phase_in_situ(torch, det)
    phase_breakdown(torch, det, steady_ms)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "optax", "orbax"))
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")

    flagship = stem_results["ava_256px"]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "stem_conv_bn_relu_maxpool", "route": "cuda",
        "source": "tubelet_transformer_tpu_torch/csrc/stem.cu",
        "replaces": "tubelet_transformer_tpu/ops/pallas/stem.py:134",
        "launches": launches, "max_abs_err": flagship["max_abs_err"],
        "ms": flagship["ms"], "plain_ms": flagship["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
