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
``ckpt_epoch_N``). Mesh serving (``MESH.MODEL > 1``) is not ported.

Usage:
  python -m tubelet_transformer_tpu_torch.cli.serve_http \
      --config-file configuration/tuber_csn152_ava22.yaml \
      [--port 8000] [--max-batch 8] [--detect-every 30] [--fps 30] \
      [--actor-threshold 0.8] [--device cuda] [--seed 0]
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
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    args = p.parse_args()

    import torch

    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.serving_http import DetectionServer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    cfg = load_config(args.config_file)
    if cfg.mesh.model > 1:
        raise NotImplementedError("mesh serving (MESH.MODEL > 1) is not "
                                  "ported yet")
    model = build_model(cfg, device=device, seed=args.seed,
                        pretrained=bool(cfg.model.load
                                        and cfg.model.pretrained_path))
    server = DetectionServer(
        cfg, model, host=args.host, port=args.port,
        max_batch=args.max_batch, detect_every=args.detect_every,
        fps=args.fps, actor_threshold=args.actor_threshold)
    print(f"serving on http://{args.host}:{server.port} "
          f"(device={device}, max_batch={args.max_batch})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
