"""Generic video-classification trainer.

Port of ``tubelet_transformer_tpu/train/classify.py``, the counterpart of
the reference's ``train_classification``
(``utils/video_action_recognition.py:26-75``). ``VideoClassifier`` is the
irCSN trunk (``models/csn.py``, built with ``stem_kernel=False`` as in
JAX: no hand kernel runs), a float32 mean over (T, H, W) and a linear
``head``. A step is eager PyTorch: the train-mode forward (the BN batch
statistics and their EMA as in the JAX CSN), the mean softmax
cross-entropy on integer labels, backward and the optimizer's step.

The loop keeps the reference's observability contract tag for tag:
``AverageMeter``s, a print block every ``display_freq`` steps, and the
scalars ``train_loss_iteration``, ``train_batch_size_iteration`` and
``learning_rate`` through ``MetricsWriter``. The loss is fetched from the
device on display steps only, as the JAX loop does.

The optimizer is the caller's: ``torch.optim.AdamW`` defaults to a weight
decay of 1e-2 where ``optax.adamw`` has 1e-4, so pass it explicitly.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tubelet_transformer_tpu_torch.models.csn import build_csn
from tubelet_transformer_tpu_torch.models.layers import Linear
from tubelet_transformer_tpu_torch.models.tuber import init_weights
from tubelet_transformer_tpu_torch.train.engine import TrainState
from tubelet_transformer_tpu_torch.utils import AverageMeter, MetricsWriter

TRUNK_DIM = 2048    # irCSN output channels


class VideoClassifier(nn.Module):
    """irCSN trunk -> global average pool -> linear logits head."""

    def __init__(self, backbone_name: str = "CSN-50", num_classes: int = 400,
                 last_stride: bool = True):
        super().__init__()
        self.trunk = build_csn(backbone_name, last_stride, stem_kernel=False)
        self.head = Linear(TRUNK_DIM, num_classes)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        """clips (B, T, H, W, 3) -> logits (B, num_classes)."""
        pooled = self.trunk(clips).float().mean(dim=(1, 2, 3))
        return self.head(pooled)


def build_classifier(backbone_name: str = "CSN-50", num_classes: int = 400,
                     last_stride: bool = True, seed: int = 0,
                     device: torch.device | str = "cpu") -> VideoClassifier:
    """A ``VideoClassifier`` with random weights drawn from ``seed`` on the
    CPU, as the port's TubeR draws them, moved to ``device``, in train
    mode."""
    model = VideoClassifier(backbone_name, num_classes, last_stride)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).train()


def create_classifier_state(model: VideoClassifier,
                            optimizer: torch.optim.Optimizer) -> TrainState:
    """The training state of ``model`` and its ``optimizer``; the schedule
    reads the optimizer's learning rate."""
    # The classification step draws no randomness, so the seed is unused.
    return TrainState(model=model, optimizer=optimizer,
                      schedule=lambda _: optimizer.param_groups[0]["lr"],
                      seed=0)


def make_classification_train_step(state: TrainState
                                   ) -> Callable[[torch.Tensor, torch.Tensor],
                                                 torch.Tensor]:
    """step(clips, labels) -> the mean cross-entropy (a 0-dim tensor on the
    device): forward in train mode, backward and the optimizer's step,
    updating ``state`` in place."""
    model, opt = state.model, state.optimizer

    def step(clips: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(clips).float(), labels.long())
        loss.backward()
        opt.step()
        state.step += 1
        state.updates += 1
        return loss.detach()

    return step


def train_classification(base_iter: int, state: TrainState, train_step,
                         loader, epoch: int, display_freq: int = 20,
                         lr_fn: Optional[Callable[[int], float]] = None,
                         writer: Optional[MetricsWriter] = None,
                         is_main: bool = True):
    """One classification epoch (reference video_action_recognition.py:
    26-75). ``loader`` yields dicts (or pairs) of ``clips`` (B, T, H, W, 3)
    and integer ``labels`` (B,), numpy arrays or tensors; they go to the
    model's device. Returns (base_iter, state), as the JAX loop does."""
    device = next(state.model.parameters()).device
    batch_time = AverageMeter("batch_time")
    data_time = AverageMeter("data_time")
    losses = AverageMeter("loss")

    n = len(loader) if hasattr(loader, "__len__") else None
    end = time.time()
    for step_i, data in enumerate(loader):
        base_iter += 1
        if isinstance(data, dict):
            clips, labels = data["clips"], data["labels"]
        else:
            clips, labels = data
        data_time.update(time.time() - end)

        loss = train_step(torch.as_tensor(clips).to(device),
                          torch.as_tensor(labels).to(device))
        # the loss stays on the device between display steps: a fetch per
        # step would wait for the step to finish
        if step_i % display_freq == 0:
            losses.update(float(loss), len(labels))

        batch_time.update(time.time() - end)
        end = time.time()
        if step_i % display_freq == 0 and is_main:
            lr = lr_fn(base_iter) if lr_fn else float("nan")
            total = f"/{n}" if n is not None else ""
            print("-" * 55)
            print(f"lr:  {lr}")
            print(f"Epoch: [{epoch}][{step_i + 1}{total}]")
            print(f"data_time: {data_time.val:.3f}, "
                  f"batch time: {batch_time.val:.3f}")
            print(f"loss: {losses.avg:.5f}")
            if writer is not None:
                writer.add_scalar("train_loss_iteration", losses.avg,
                                  base_iter)
                writer.add_scalar("train_batch_size_iteration", len(labels),
                                  base_iter)
                writer.add_scalar("learning_rate", lr, base_iter)
    return base_iter, state
