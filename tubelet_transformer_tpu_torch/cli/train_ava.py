"""CLI: train TubeR on AVA (or the synthetic AVA set) with the PyTorch port
(reference train_tuber_ava.py equivalent).

The JAX CLI's flag plus ``--device`` and ``--seed`` (of the random initial
weights, which any weight files the config names replace).

Usage:
  python -m tubelet_transformer_tpu_torch.cli.train_ava --config-file <yaml> \
      [--device cuda] [--seed 0]
"""

from tubelet_transformer_tpu_torch.cli import runner


def main() -> None:
    runner.main("train", "ava")


if __name__ == "__main__":
    main()
