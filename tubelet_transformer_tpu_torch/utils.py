"""Meters, experiment directories and metric logging: the port's copy of
``AverageMeter``, ``MetricsWriter`` and ``build_log_dir`` from
``tubelet_transformer_tpu/utils.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class AverageMeter:
    """Running average (reference utils/utils.py:53-69)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MetricsWriter:
    """Append-only JSONL scalar log + optional TensorBoard.

    The JSONL is the source of truth (greppable, no deps); TensorBoard is
    emitted when tensorboardX/tensorboard is importable (the reference uses
    tensorboardX rank-0 only — utils/utils.py:28-50).
    """

    def __init__(self, log_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.log_dir = log_dir
        self._tb = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int):
        if not self.enabled:
            return
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        if self.enabled:
            self._jsonl.close()
            if self._tb is not None:
                self._tb.close()


def build_log_dir(cfg, stamp: str = "",
                  write_config: bool = True) -> Dict[str, str]:
    """Timestamped experiment dir with tb/ckpt subdirs + resolved config dump
    (reference utils/utils.py:28-50). Multi-host callers pass a shared
    ``stamp`` so every process resolves the same run directory, and set
    ``write_config`` on rank 0 only (concurrent writers to the same file on
    a shared filesystem interleave/truncate)."""
    import dataclasses
    import datetime

    stamp = stamp or datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    exp_dir = os.path.join(cfg.log.base_path,
                           f"{cfg.log.exp_name}_{stamp}")
    tb_dir = os.path.join(exp_dir, cfg.log.log_dir)
    ckpt_dir = os.path.join(exp_dir, cfg.log.save_dir)
    os.makedirs(tb_dir, exist_ok=True)
    os.makedirs(ckpt_dir, exist_ok=True)
    if write_config:
        with open(os.path.join(exp_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
    return {"exp": exp_dir, "tb": tb_dir, "ckpt": ckpt_dir}
