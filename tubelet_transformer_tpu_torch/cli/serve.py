"""CLI: online streaming inference demo on the PyTorch port.

Feeds a frame stream (a directory of JPEG/PNG frames, or synthetic frames)
through ``serving.StreamingDetector`` and prints one JSON line per keyframe
detection, then a summary line: the same flags and lines as
``tubelet_transformer_tpu.cli.serve``, plus ``--device`` and ``--seed``.
With ``MODEL.LOAD`` and ``PRETRAINED_PATH`` the model serves the weight
files the config names (``train.checkpoint.load_pretrained``: a TubeR
``.pth`` or the port's own ``ckpt_epoch_N``), else random weights from
``--seed``.

Usage:
  python -m tubelet_transformer_tpu_torch.cli.serve --config-file <yaml> \
      [--frames-dir DIR | --num-frames N] [--fps 30] [--detect-every N] \
      [--device cuda] [--seed 0]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def frame_source(args):
    if args.frames_dir:
        paths = sorted(glob.glob(os.path.join(args.frames_dir, "*.jpg")) +
                       glob.glob(os.path.join(args.frames_dir, "*.png")))
        if not paths:
            raise FileNotFoundError(f"no frames under {args.frames_dir}")
        from PIL import Image

        for p in paths:
            yield np.asarray(Image.open(p).convert("RGB"))
    else:
        rng = np.random.default_rng(0)
        for _ in range(args.num_frames):
            yield rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)


def main() -> None:
    import torch

    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.serving import StreamingDetector

    parser = argparse.ArgumentParser(description="TubeR streaming serve "
                                                 "(PyTorch)")
    parser.add_argument("--config-file", default=None)
    parser.add_argument("--frames-dir", default=None,
                        help="directory of ordered .jpg/.png frames")
    parser.add_argument("--num-frames", type=int, default=128,
                        help="synthetic frame count when no --frames-dir")
    parser.add_argument("--fps", type=float, default=30.0)
    parser.add_argument("--detect-every", type=int, default=None,
                        help="frames between detections (default: one/sec)")
    parser.add_argument("--top-k", type=int, default=3,
                        help="action classes reported per detection")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' only when asked for")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights")
    args = parser.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    cfg = load_config(args.config_file)
    model = build_model(cfg, device=device, seed=args.seed,
                        pretrained=bool(cfg.model.load
                                        and cfg.model.pretrained_path))
    detector = StreamingDetector(cfg, model, fps=args.fps,
                                 detect_every=args.detect_every,
                                 rng_seed=args.seed, device=device)

    n_frames = 0
    n_keyframes = 0
    latencies = []
    for frame in frame_source(args):
        n_frames += 1
        res = detector.push_frame(frame)
        if res is None:
            continue
        n_keyframes += 1
        latencies.append(res.latency_ms)
        print(json.dumps({
            "keyframe": res.frame_index,
            "time_s": round(res.time_s, 3),
            "latency_ms": round(res.latency_ms, 2),
            "memory_tokens": res.memory_size,
            "detections": [
                {"box": [round(float(v), 1) for v in d.box],
                 "actor": round(d.actor_prob, 3),
                 "top_actions": [
                     [int(c), round(float(d.scores[c]), 3)]
                     for c in np.argsort(-d.scores)[: args.top_k]]}
                for d in res.detections],
        }), flush=True)
    if latencies:
        # the first call includes the kernel build and cuDNN's algorithm
        # choice; steady state excludes it
        steady = latencies[1:] or latencies
        print(json.dumps({
            "summary": {"frames": n_frames, "keyframes": n_keyframes,
                        "steady_latency_ms": round(float(np.mean(steady)), 2),
                        "compile_latency_ms": round(latencies[0], 2)}}))


if __name__ == "__main__":
    main()
