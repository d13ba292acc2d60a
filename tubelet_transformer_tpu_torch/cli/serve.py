"""CLI: online streaming inference demo on the PyTorch port.

Feeds a frame stream (a directory of JPEG/PNG frames, or synthetic frames)
through ``serving.StreamingDetector`` and prints one JSON line per keyframe
detection, then a summary line: the same flags and lines as
``tubelet_transformer_tpu.cli.serve``, plus ``--device`` and ``--seed``.
With ``MODEL.LOAD`` and ``PRETRAINED_PATH`` the model serves the weight
files the config names (``train.checkpoint.load_pretrained``: a TubeR
``.pth`` or the port's own ``ckpt_epoch_N``), else random weights from
``--seed``.

Under torchrun (``--dist-backend`` as the train CLI takes it) with
``MESH.MODEL > 1`` the detector serves over the mesh of ``MESH.DATA`` x
``MESH.MODEL`` (``serving.py``): every rank loads the weights, then
splits the model; rank 0 reads the frames and prints, the other ranks
follow its forwards and print only their "distributed:" line.

Usage:
  python -m tubelet_transformer_tpu_torch.cli.serve --config-file <yaml> \
      [--frames-dir DIR | --num-frames N] [--fps 30] [--detect-every N] \
      [--device cuda] [--seed 0]
  python -m torch.distributed.run --standalone --nproc_per_node 2 \
      -m tubelet_transformer_tpu_torch.cli.serve --config-file <yaml with
      MESH.MODEL 2> [--dist-backend gloo]
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
    from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
    from tubelet_transformer_tpu_torch.serving import (StreamingDetector,
                                                       follow)

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
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:<LOCAL_RANK>); "
                             "'cpu' only when asked for")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights")
    parser.add_argument("--dist-backend", default=None,
                        help="process group backend under torchrun "
                             "(default: cuda:nccl,cpu:gloo on the card, "
                             "gloo on the CPU)")
    args = parser.parse_args()

    device = (torch.device(args.device) if args.device
              else mesh_lib.default_device())
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    cfg = load_config(args.config_file)
    # serving runs the sequential encoder, as the JAX detector does: a
    # MESH.PIPE training YAML still serves
    cfg.mesh.pipe = 1
    mesh_lib.init_distributed(device, args.dist_backend)
    try:
        mesh = (mesh_lib.create_mesh(cfg.mesh.data, cfg.mesh.model)
                if cfg.mesh.model > 1 else None)
        model = build_model(cfg, device=device, seed=args.seed,
                            pretrained=bool(cfg.model.load
                                            and cfg.model.pretrained_path),
                            mesh=mesh)
        detector = StreamingDetector(cfg, model, fps=args.fps,
                                     detect_every=args.detect_every,
                                     rng_seed=args.seed, device=device,
                                     mesh=mesh)
        if mesh_lib.is_main_process():
            _serve(args, detector)
            detector.stop_followers()
        else:
            follow(detector)
    finally:
        mesh_lib.shutdown()


def _serve(args, detector) -> None:
    """Rank 0: the frames through ``detector``, one JSON line a keyframe,
    then the summary line."""
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
