"""CLI: generate the long-term feature bank over the val split with the
PyTorch port.

The JAX CLI's flag plus ``--device``, ``--seed`` and ``--out`` (the bank's
path, ``lfb_bank.npz`` by default as there); a slot is valid where its actor
probability exceeds 0.8, as there. The checkpoint of
``MODEL.LOAD`` with ``PRETRAINED_PATH`` runs in ``generate_lfb`` mode; a
bank needs trained weights, so it is required. A later ``CONFIG.USE_LFB``
run reads the bank from ``LFB.BANK_PATH``. Under torchrun (``MESH.DATA``,
``MESH.MODEL``) each process runs its data shard of the val split with
the model split over the model peers, and rank 0 writes the full bank.

Usage:
  python -m tubelet_transformer_tpu_torch.cli.generate_lfb \
      --config-file <yaml> [--out lfb_bank.npz] \
      [--device cuda] [--seed 0] [--dist-backend gloo]
  python -m torch.distributed.run --standalone --nproc_per_node 2 \
      -m tubelet_transformer_tpu_torch.cli.generate_lfb \
      --config-file <yaml with MESH.MODEL 2> --out lfb_bank.npz
"""

from tubelet_transformer_tpu_torch.cli import runner


def main() -> None:
    runner.main("generate-lfb", "ava")


if __name__ == "__main__":
    main()
