"""CLI: train TubeR on AVA (or the synthetic AVA set) with the PyTorch port.

The JAX CLI's flag plus ``--device`` and ``--seed`` (of the random initial
weights). Pretrained weights are not loaded yet: the config must name no
backbone ``.mat``, DETR seed or TubeR checkpoint.

Usage:
  python -m tubelet_transformer_tpu_torch.cli.train_ava --config-file <yaml> \
      [--device cuda] [--seed 0]
"""

from __future__ import annotations

import argparse


def main() -> None:
    import torch

    from tubelet_transformer_tpu_torch.cli.runner import run_training
    from tubelet_transformer_tpu_torch.config import load_config

    parser = argparse.ArgumentParser(description="TubeR AVA training "
                                                 "(PyTorch)")
    parser.add_argument("--config-file", default=None,
                        help="path to a YAML config (reference format OK)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' only when asked for")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random initial weights")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    cfg = load_config(args.config_file)
    if not args.config_file:
        cfg.data.dataset_name = "ava"
    run_training(cfg, device=device, seed=args.seed)


if __name__ == "__main__":
    main()
