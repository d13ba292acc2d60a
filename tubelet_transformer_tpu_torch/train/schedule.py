"""Learning-rate schedules, evaluated per optimizer update.

Port of ``tubelet_transformer_tpu/train/schedule.py``: the same three
policies ('step': MultiStepLR per epoch; 'cosine': timm-style warmup then
cosine on the absolute step; 'linear': warmup then linear decay to
``lr * lr_min_rate``), as plain functions of the update count.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def multistep_schedule(base_lr: float, milestones: Sequence[int],
                       gamma: float, steps_per_epoch: int) -> Schedule:
    ms = sorted(milestones)

    def fn(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * gamma ** sum(epoch >= m for m in ms)

    return fn


def cosine_schedule(base_lr: float, min_lr: float, total_steps: int,
                    warmup_steps: int, warmup_start_lr: float) -> Schedule:
    def fn(step: int) -> float:
        # past the horizon the rate holds min_lr (timm cycle_limit=1)
        step = min(step, total_steps)
        if step < warmup_steps:
            return warmup_start_lr + step * (
                (base_lr - warmup_start_lr) / max(warmup_steps, 1))
        return min_lr + 0.5 * (base_lr - min_lr) * (
            1.0 + math.cos(math.pi * step / max(total_steps, 1)))

    return fn


def linear_schedule(base_lr: float, total_steps: int, warmup_steps: int,
                    warmup_start_lr: float,
                    lr_min_rate: float = 0.01) -> Schedule:
    def fn(step: int) -> float:
        # past the horizon the line would go negative: hold its end
        step = min(step, total_steps)
        if step < warmup_steps:
            return warmup_start_lr + step * (
                (base_lr - warmup_start_lr) / max(warmup_steps, 1))
        t = step - warmup_steps
        total = max(total_steps - warmup_steps, 1)
        return base_lr - (base_lr - base_lr * lr_min_rate) * (t / total)

    return fn


def build_schedule(cfg, steps_per_epoch: int) -> Schedule:
    t = cfg.train
    total = t.epoch_num * steps_per_epoch
    warm = t.warmup_epochs * steps_per_epoch if t.use_warmup else 0
    if t.lr_policy == "step":
        return multistep_schedule(t.lr, t.lr_milestone or [30, 60],
                                  t.step, steps_per_epoch)
    if t.lr_policy == "cosine":
        return cosine_schedule(t.lr, t.min_lr, total, warm, t.warmup_start_lr)
    if t.lr_policy == "linear":
        return linear_schedule(t.lr, total, warm, t.warmup_start_lr)
    raise ValueError(f"unknown lr policy {t.lr_policy!r}")
