"""CLI: evaluate a TubeR checkpoint on JHMDB (or UCF24) with the PyTorch port
(reference eval_tuber_jhmdb.py equivalent).

The JAX CLI's flag plus ``--device`` and ``--seed`` (of the random initial
weights, which the checkpoint of ``MODEL.LOAD`` with ``PRETRAINED_PATH``
replaces: eval requires it).

Usage:
  python -m tubelet_transformer_tpu_torch.cli.eval_jhmdb --config-file <yaml> \
      [--device cuda] [--seed 0]
"""

from tubelet_transformer_tpu_torch.cli import runner


def main() -> None:
    runner.main("eval", "jhmdb")


if __name__ == "__main__":
    main()
