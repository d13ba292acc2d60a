"""AdamW with the reference's per-group learning rates, freezing and the
global-norm clip.

Port of ``tubelet_transformer_tpu/train/optimizer.py``. Parameters are
labelled 'frozen', 'backbone' (the CSN trunk, ``backbone.body.*``, at
``LR_BACKBONE``) or 'main' (everything else at ``LR``; the pooling query and
decoder are 'main' as in the JAX package, where they sit outside its
backbone). Frozen parameters get ``requires_grad_(False)`` and no optimizer
state; their BN statistics still update in train mode. ``torch.optim.AdamW``
(fused: one kernel over the parameters, which can skip on a flag on the
device) couples weight decay to the group's rate and decays every
parameter, as the JAX chain does; the clip runs over the trainable gradients before Adam
(over the model peers' slices too under ``MESH.MODEL``, and the pipe
stages' encoder layers under ``MESH.PIPE``).
With ``MESH.ZERO1`` on a 'data' axis of more than one rank the same AdamW
keeps its moments sharded over the data shards (``parallel/zero.py``),
beside a 'model' axis too.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch
from torch import nn

from tubelet_transformer_tpu_torch.parallel.mesh import Mesh
from tubelet_transformer_tpu_torch.parallel.zero import ZeroAdamW

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


def build_optimizer(cfg, model: nn.Module, mesh: Mesh = Mesh()
                    ) -> torch.optim.AdamW | ZeroAdamW:
    """AdamW over the trainable parameters of ``model``, one group per
    label; each group's ``lr_scale`` multiplies the schedule's rate. Freezes
    the frozen parameters in place. With ``MESH.ZERO1`` and a ``mesh`` of
    more than one rank, the ZeRO-1 AdamW of the same groups; at one rank
    ZERO1 changes nothing, as in the JAX package."""
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
    groups = [{"params": ps, "name": k, "lr_scale": scale[k]}
              for k, ps in groups.items() if ps]
    hyper = dict(lr=cfg.train.lr, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=cfg.train.w_decay)
    if cfg.mesh.zero1 and mesh.data > 1:
        return ZeroAdamW(groups, mesh, **hyper)
    return torch.optim.AdamW(groups, fused=True, **hyper)


def trainable_params(optimizer: torch.optim.Optimizer
                     ) -> List[nn.Parameter]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def clip_by_global_norm(params: Iterable[nn.Parameter],
                        max_norm: float, mesh: Mesh = Mesh()
                        ) -> torch.Tensor:
    """The global L2 norm of the gradients (float32, on their device);
    when ``max_norm`` > 0 and the norm reaches it, scales the gradients by
    max_norm / norm in place, as ``optax.clip_by_global_norm`` does. Split
    over ``mesh``'s 'model' axis (``tp_split``), a parameter's gradient is
    this peer's slice: the squares of those are summed over the model
    group, the replicated ones counted once; held by this 'pipe' stage
    (``pipe_stage``), the squares are summed over the pipe group."""
    with_grad = [p for p in params if p.grad is not None]
    grads = [p.grad for p in with_grad]
    if not grads:
        return torch.zeros(())
    norms = torch.stack(torch._foreach_norm(grads))
    split = [getattr(p, "tp_split", None) is not None for p in with_grad]
    stage = [getattr(p, "pipe_stage", False) for p in with_grad]
    split_any = mesh.model > 1 and any(split)
    stage_any = mesh.pipe > 1 and any(stage)
    if not (split_any or stage_any):
        norm = torch.linalg.vector_norm(norms)
    else:
        split = torch.tensor(split, device=norms.device)
        stage = torch.tensor(stage, device=norms.device)
        sq = torch.linalg.vector_norm(norms[~split & ~stage]).square()
        if split_any:
            sq = sq + mesh.reduce_from_model(
                torch.linalg.vector_norm(norms[split]).square())
        if stage_any:
            sq = sq + mesh.reduce_from_pipe(
                torch.linalg.vector_norm(norms[stage]).square())
        norm = sq.sqrt()
    if max_norm > 0:
        scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
        torch._foreach_mul_(grads, scale)
    return norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for g in optimizer.param_groups:
        g["lr"] = lr * g["lr_scale"]


def skip_unless(optimizer, finite: torch.Tensor) -> None:
    """Make the next ``step()`` of ``optimizer`` (``build_optimizer``'s
    fused AdamW, or ``ZeroAdamW`` around one) leave the parameters, the
    moments and the step counts bit for bit as they are unless ``finite``
    (a 0-dim bool tensor on the parameters' device) holds: the fused
    kernel's ``found_inf``, read on the device."""
    getattr(optimizer, "inner", optimizer).found_inf = (~finite).float()
