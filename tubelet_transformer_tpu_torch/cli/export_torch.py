"""CLI: export a checkpoint to the reference's ``.pth`` format.

Usage:
  python -m tubelet_transformer_tpu_torch.cli.export_torch \
      --config-file <yaml> --out tuber_export.pth

Port of ``tubelet_transformer_tpu/cli/export_torch.py``. The weights come
from ``MODEL.PRETRAINED_PATH`` (a TubeR ``.pth`` or the port's own
``ckpt_epoch_N``) through ``train/checkpoint.py:load_pretrained``, into the
float32 train build on ``--device`` (``cuda`` unless asked otherwise). The
output is ``{"model": {"module.<reference name>": tensor}}`` (bare names
with ``--no-ddp-prefix``), the keys and tensors the JAX package's export
writes for the same weights. Refused, as there: MODEL.MOE_EXPERTS > 0 and
USE_LFB, which the reference's state dict has no slot for; and
MODEL.NORMALIZE_BEFORE, whose encoder norm the JAX package's export does
not write.
"""

import argparse

from tubelet_transformer_tpu_torch.config import load_config


def check_exportable(cfg) -> None:
    """Raise NotImplementedError for a model the export cannot write."""
    if cfg.model.moe_experts > 0:
        # the reference encoder FFN is dense linear1/linear2; MoE expert
        # stacks and the router have no slot in its state dict
        raise NotImplementedError(
            "cannot export a MODEL.MOE_EXPERTS checkpoint to reference "
            "format: the reference transformer has no MoE module; export "
            "a dense-FFN model instead")
    if cfg.use_lfb:
        # the reference model has no LFB fusion modules, so lfb_proj/
        # lfb_attn/lfb_norm cannot be represented in its state dict
        raise NotImplementedError(
            "cannot export a USE_LFB checkpoint to reference format: the "
            "reference ships no LFB module to receive the fusion weights; "
            "export the base model (USE_LFB: false) instead")
    if cfg.model.normalize_before:
        # the JAX package's export writes no transformer.encoder.norm, the
        # pre-norm encoder's final LayerNorm: its files lack that key
        raise NotImplementedError(
            "cannot export a MODEL.NORMALIZE_BEFORE checkpoint to reference "
            "format: the JAX package's export writes no "
            "transformer.encoder.norm, so the pre-norm encoder's final norm "
            "has no key in its scheme; export a post-norm model instead")


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Export TubeR weights to reference .pth format (PyTorch)")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--out", default="tuber_export.pth")
    parser.add_argument("--no-ddp-prefix", action="store_true",
                        help="emit bare module names (no 'module.' prefix)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' only when asked for")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the initial weights, before the load")
    args = parser.parse_args()

    import torch

    from tubelet_transformer_tpu_torch.convert import export_tuber_pth
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    cfg = load_config(args.config_file)
    if not (cfg.model.load and cfg.model.pretrained_path):
        raise ValueError("export requires MODEL.LOAD with PRETRAINED_PATH")
    # the export writes the sequential per-layer encoder layout
    cfg.mesh.pipe = 1
    check_exportable(cfg)
    model = build_model(cfg, device=device, seed=args.seed, train=True,
                        pretrained=True)
    out = export_tuber_pth(args.out, model, ddp_prefix=not args.no_ddp_prefix)
    print(f"exported reference-format checkpoint to {out}")


if __name__ == "__main__":
    main()
