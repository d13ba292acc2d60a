"""CLI: pack a split into pre-decoded clip shards (data/packed.py).

Usage:
  python -m tubelet_transformer_tpu_torch.cli.pack_data \
      --config-file <yaml> --split train --out /data/ava_packed_train

Port of ``tubelet_transformer_tpu/cli/pack_data.py``, on the host only:
AVA through ``pack_ava``, JHMDB/UCF24 through ``pack_jhmdb``. Then set
``DATA.PACKED_PATH: /data/ava_packed_{}`` (the ``{}`` receives the split)
to train and evaluate without any image decode in the hot path.
"""

import argparse
import os

from tubelet_transformer_tpu_torch.config import load_config


def main() -> None:
    p = argparse.ArgumentParser(
        description="Pack AVA clips into pre-decoded shards")
    p.add_argument("--config-file", required=True)
    p.add_argument("--split", choices=("train", "val"), default="train")
    p.add_argument("--out", required=True)
    p.add_argument("--limit", type=int, default=None,
                   help="pack only the first N keyframes (smoke runs)")
    p.add_argument("--workers", type=int, default=os.cpu_count() or 1,
                   help="decode threads (native decode releases the GIL)")
    p.add_argument("--part", type=int, default=0,
                   help="this machine's chunk (with --num-parts)")
    p.add_argument("--num-parts", type=int, default=1,
                   help="split the key list over N machines; each writes "
                        "OUT/part_NNN and the reader reassembles them")
    args = p.parse_args()

    from tubelet_transformer_tpu_torch.data.packed import pack_ava, pack_jhmdb

    cfg = load_config(args.config_file)
    if cfg.data.dataset_name in ("jhmdb", "ucf"):
        if args.num_parts > 1:
            raise SystemExit("--num-parts applies to AVA packs only "
                             "(JHMDB/UCF packs are small, per-video)")
        out = pack_jhmdb(cfg, args.split, args.out, limit=args.limit,
                         workers=args.workers)
    else:
        out = pack_ava(cfg, args.split, args.out, limit=args.limit,
                       workers=args.workers, part=args.part,
                       num_parts=args.num_parts)
    print(f"packed {args.split} split to {out}")


if __name__ == "__main__":
    main()
