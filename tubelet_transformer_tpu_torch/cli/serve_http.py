"""CLI: HTTP detection service over the multi-stream serving pool, on the
PyTorch port.

Serves the TubeR streaming detector behind a stdlib HTTP API
(serving_http.DetectionServer): clients open streams, POST frames
(JPEG/PNG or raw RGB), and poll per-keyframe detections; all due streams
share one padded batched forward per scheduler tick. The JAX CLI's flags
plus ``--device`` and ``--seed`` (of the random weights), as
``cli/serve.py`` takes them. With ``MODEL.LOAD`` and ``PRETRAINED_PATH``
the model serves the weight files the config names
(``train.checkpoint.load_pretrained``: a TubeR ``.pth`` or the port's own
``ckpt_epoch_N``).

Under torchrun (``--dist-backend`` as the train CLI takes it) with
``MESH.MODEL > 1`` the pool serves over the mesh of ``MESH.DATA`` x
``MESH.MODEL`` (``serving.py``): every rank loads the weights, then
splits the model; rank 0 serves HTTP and prints, the other ranks follow
its forwards and print only their "distributed:" line, and a failed
warmup or step ends every rank non-zero.

Usage:
  python -m tubelet_transformer_tpu_torch.cli.serve_http \
      --config-file configuration/tuber_csn152_ava22.yaml \
      [--port 8000] [--max-batch 8] [--detect-every 30] [--fps 30] \
      [--actor-threshold 0.8] [--device cuda] [--seed 0]
  python -m torch.distributed.run --standalone --nproc_per_node 2 \
      -m tubelet_transformer_tpu_torch.cli.serve_http \
      --config-file <yaml with MESH.MODEL 2> [--dist-backend gloo]
"""

from __future__ import annotations

import argparse


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config-file", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--detect-every", type=int, default=None,
                   help="frames between detections (default: one per second "
                        "of source video, i.e. fps)")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--actor-threshold", type=float, default=0.8)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:<LOCAL_RANK>); 'cpu' "
                        "only when asked for")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--dist-backend", default=None,
                   help="process group backend under torchrun (default: "
                        "cuda:nccl,cpu:gloo on the card, gloo on the CPU)")
    args = p.parse_args()

    import torch

    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
    from tubelet_transformer_tpu_torch.serving import (StreamingDetector,
                                                       follow)
    from tubelet_transformer_tpu_torch.serving_http import DetectionServer

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
        if not mesh_lib.is_main_process():
            follow(StreamingDetector(
                cfg, model, detect_every=args.detect_every, fps=args.fps,
                actor_threshold=args.actor_threshold, mesh=mesh))
            return
        server = DetectionServer(
            cfg, model, host=args.host, port=args.port,
            max_batch=args.max_batch, detect_every=args.detect_every,
            fps=args.fps, actor_threshold=args.actor_threshold, mesh=mesh)
        print(f"serving on http://{args.host}:{server.port} "
              f"(device={device}, max_batch={args.max_batch})", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.stop()
    finally:
        mesh_lib.shutdown()


if __name__ == "__main__":
    main()
