"""AdamW with the reference's per-group learning rates, freezing and the
global-norm clip.

Port of ``tubelet_transformer_tpu/train/optimizer.py``. Parameters are
labelled 'frozen', 'backbone' (the CSN trunk, ``backbone.body.*``, at
``LR_BACKBONE``) or 'main' (everything else at ``LR``; the pooling query and
decoder are 'main' as in the JAX package, where they sit outside its
backbone). Frozen parameters get ``requires_grad_(False)`` and no optimizer
state; their BN statistics still update in train mode. ``torch.optim.AdamW``
couples weight decay to the group's rate and decays every parameter, as the
JAX chain does; the clip runs over the trainable gradients before Adam.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch
from torch import nn

BODY = "backbone.body."


def stop_grad_stage(cfg) -> int:
    """Deepest fully frozen CSN boundary: -1 none, 0 after the stem, s
    after layer s, 5 after the whole trunk. Mirrors ``param_label``."""
    if cfg.train.lr_backbone <= 0:
        return 5
    if cfg.model.pretrained and cfg.model.tune_point >= 2:
        return cfg.model.tune_point - 2
    return -1


def param_label(name: str, cfg) -> str:
    """'frozen' | 'backbone' | 'main' for a parameter name of TubeR."""
    if not name.startswith(BODY):
        return "main"
    if cfg.train.lr_backbone <= 0:
        return "frozen"
    sub = name[len(BODY):]
    if cfg.model.pretrained and cfg.model.tune_point >= 2:
        tp = cfg.model.tune_point
        if sub.startswith(("conv1.", "bn1.")) and tp > 1:
            return "frozen"
        for s in range(1, 5):
            if sub.startswith(f"layer{s}.") and tp > s + 1:
                return "frozen"
    return "backbone"


def build_optimizer(cfg, model: nn.Module) -> torch.optim.AdamW:
    """AdamW over the trainable parameters of ``model``, one group per
    label; each group's ``lr_scale`` multiplies the schedule's rate. Freezes
    the frozen parameters in place."""
    groups: Dict[str, List[nn.Parameter]] = {"main": [], "backbone": []}
    for name, p in model.named_parameters():
        label = param_label(name, cfg)
        if label == "frozen":
            p.requires_grad_(False)
        else:
            groups[label].append(p)
    scale = {"main": 1.0,
             "backbone": (cfg.train.lr_backbone / cfg.train.lr
                          if cfg.train.lr > 0 else 0.0)}
    return torch.optim.AdamW(
        [{"params": ps, "name": k, "lr_scale": scale[k]}
         for k, ps in groups.items() if ps],
        lr=cfg.train.lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.train.w_decay)


def trainable_params(optimizer: torch.optim.Optimizer
                     ) -> List[nn.Parameter]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def clip_by_global_norm(params: Iterable[nn.Parameter],
                        max_norm: float) -> torch.Tensor:
    """The global L2 norm of the gradients (float32, on their device);
    when ``max_norm`` > 0 and the norm reaches it, scales the gradients by
    max_norm / norm in place, as ``optax.clip_by_global_norm`` does."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if max_norm > 0:
        scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
        torch._foreach_mul_(grads, scale)
    return norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for g in optimizer.param_groups:
        g["lr"] = lr * g["lr_scale"]
