"""Train and eval steps.

Port of ``tubelet_transformer_tpu/train/engine.py`` for one device. A step
is eager PyTorch: preprocess (with the HSV jitter for uint8 clips), the
train forward, the matched losses (the assignment on the host, one
device-to-host copy of the costs), the weighted total, backward, the global
norm clip over the trainable gradients, and AdamW at the scheduled rate.

The NaN guard skips the whole update when the total loss is not finite:
the parameters and the Adam moments (no ``optimizer.step()``) and the BN
running statistics, which the forward has already updated in place and are
put back from a copy taken before it.

Randomness is a ``torch.Generator`` on the model's device, reseeded at each
step from ``TRAIN.SEED`` and the step number, so that a resumed run draws
what the uninterrupted one would have (the JAX step folds the step into its
key the same way).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.data.device_preprocess import (
    device_preprocess)
from tubelet_transformer_tpu_torch.models.csn import FoldableBN
from tubelet_transformer_tpu_torch.models.tuber import TubeR, dataset_mode
from tubelet_transformer_tpu_torch.train import criterion as crit
from tubelet_transformer_tpu_torch.train.optimizer import (
    build_optimizer, clip_by_global_norm, set_learning_rate,
    trainable_params)
from tubelet_transformer_tpu_torch.train.postprocess import (
    postprocess_ava, postprocess_softmax)
from tubelet_transformer_tpu_torch.train.schedule import build_schedule

# batch keys that go to the device; the rest (image_key, key_idx, ...)
# stay on the host. lfb_features / lfb_mask: the long-term memory window
# that USE_LFB attaches to each sample (eval/lfb.py:BankAttachDataset)
DEVICE_KEYS = ("clips", "pad_mask", "boxes", "labels", "valid", "sizes",
               "vis", "key_pos", "lfb_features", "lfb_mask")


@dataclass
class TrainState:
    model: TubeR
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    seed: int
    step: int = 0        # train steps taken, skipped ones included
    updates: int = 0     # optimizer updates applied: the schedule's count


def create_train_state(cfg: Config, model: TubeR, steps_per_epoch: int
                       ) -> TrainState:
    """AdamW and the schedule for ``model`` (the train build), which gets
    its frozen parameters frozen."""
    return TrainState(model=model, optimizer=build_optimizer(cfg, model),
                      schedule=build_schedule(cfg, steps_per_epoch),
                      seed=cfg.train.seed)


def device_batch(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The device keys of a host batch (numpy arrays) as tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items() if k in DEVICE_KEYS}


def lfb_kwargs(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The model's long-term memory arguments when the batch carries them
    (USE_LFB), else none."""
    if "lfb_features" not in batch:
        return {}
    return {"lfb_features": batch["lfb_features"],
            "lfb_mask": batch["lfb_mask"]}


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for the step options not ported yet."""
    unsupported = {
        "TRAIN.ACCUM_STEPS > 1": cfg.train.accum_steps > 1,
        "MODEL.MOE_EXPERTS": cfg.model.moe_experts > 0,
        "MODEL.INFER_CHUNK": cfg.model.infer_chunk > 0,
        "MESH.DATA > 1": cfg.mesh.data > 1,
        "MESH.MODEL > 1": cfg.mesh.model > 1,
        "MESH.PIPE > 1": cfg.mesh.pipe > 1,
        "MESH.ZERO1": cfg.mesh.zero1,
        "MESH.SPATIAL": cfg.mesh.spatial,
    }
    for name, asked in unsupported.items():
        if asked:
            raise NotImplementedError(f"{name} is not ported yet")


def is_ava_mode(cfg: Config) -> bool:
    """Everything but the tubelet (JHMDB/UCF) datasets uses AVA semantics."""
    return dataset_mode(cfg) == "ava"


def _targets_from_batch(cfg: Config, batch: Dict[str, torch.Tensor]):
    if is_ava_mode(cfg):
        return crit.TargetsAVA(boxes=batch["boxes"], labels=batch["labels"],
                               valid=batch["valid"])
    return crit.TargetsUCF(boxes=batch["boxes"], labels=batch["labels"],
                           valid=batch["valid"], vis=batch["vis"],
                           key_pos=batch["key_pos"])


def compute_losses(cfg: Config, outputs, targets, evaluation: bool = False):
    if is_ava_mode(cfg):
        return crit.criterion_ava(
            outputs, targets, cost_class=cfg.matcher.cost_class,
            cost_bbox=cfg.matcher.cost_bbox, cost_giou=cfg.matcher.cost_giou,
            weight=cfg.loss.weight, eos_coef=cfg.loss.eos_cof,
            aux_loss=cfg.train.aux_loss, evaluation=evaluation)
    return crit.criterion_ucf(
        outputs, targets, cost_class=cfg.matcher.cost_class,
        cost_bbox=cfg.matcher.cost_bbox, cost_giou=cfg.matcher.cost_giou,
        eos_coef=cfg.loss.eos_cof, num_classes=cfg.data.num_classes,
        num_queries=cfg.model.query_num, aux_loss=cfg.train.aux_loss)


def weighted_total(cfg: Config, loss_dict: Dict[str, torch.Tensor],
                   loss_ce_weight: float) -> torch.Tensor:
    """Weighted loss sum with the epoch's last-layer loss_ce weight."""
    total = loss_ce_weight * loss_dict["loss_ce"]
    for k, w in crit.build_weight_dict(cfg).items():
        if k != "loss_ce" and k in loss_dict:
            total = total + w * loss_dict[k]
    return total


def _bn_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    return [t for m in model.modules() if isinstance(m, FoldableBN)
            for t in (m.running_mean, m.running_var)]


def make_train_step(cfg: Config, state: TrainState):
    """The train step: (batch on the device, loss_ce weight) -> metrics
    (0-dim tensors), updating ``state`` in place."""
    check_supported(cfg)
    model = state.model
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    model.set_dropout_generator(generator)
    params = trainable_params(state.optimizer)
    stats = _bn_stats(model)
    saved = [torch.empty_like(t) for t in stats]

    def train_step(batch: Dict[str, torch.Tensor], loss_ce_weight: float
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        generator.manual_seed(state.seed * 1_000_003 + state.step)
        pad_mask = batch.get("pad_mask")
        clips = device_preprocess(batch["clips"], dtype=model.dtype,
                                  pad_mask=pad_mask, jitter=True,
                                  generator=generator)
        torch._foreach_copy_(saved, stats)
        outputs = model(clips, pad_mask, **lfb_kwargs(batch))
        loss_dict = compute_losses(cfg, outputs,
                                   _targets_from_batch(cfg, batch))
        total = weighted_total(cfg, loss_dict, loss_ce_weight)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        grad_norm = clip_by_global_norm(params, cfg.loss.clips_max_norm)
        finite = bool(torch.isfinite(total))
        if finite:
            set_learning_rate(state.optimizer, state.schedule(state.updates))
            state.optimizer.step()
            state.updates += 1
        else:
            torch._foreach_copy_(stats, saved)
        state.step += 1
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["total_loss"] = total.detach()
        metrics["finite"] = torch.tensor(float(finite))
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_eval_step(cfg: Config, model: TubeR):
    """The eval step: batch on the device -> detections (postprocess_ava,
    or postprocess_softmax for JHMDB/UCF) and, unless VAL.COMPUTE_LOSSES is
    off, the criterion's losses."""
    check_supported(cfg)
    postprocess = postprocess_ava if is_ava_mode(cfg) else postprocess_softmax

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict:
        model.eval()
        pad_mask = batch.get("pad_mask")
        outputs = model(device_preprocess(batch["clips"], dtype=model.dtype,
                                          pad_mask=pad_mask), pad_mask,
                        **lfb_kwargs(batch))
        if cfg.val.compute_losses:
            losses = compute_losses(cfg, outputs,
                                    _targets_from_batch(cfg, batch),
                                    evaluation=True)
        else:
            losses = {k: torch.zeros(()) for k in
                      ("loss_ce", "loss_ce_b", "loss_bbox", "loss_giou")}
        scores, boxes, binary = postprocess(outputs, batch["sizes"])
        return {"scores": scores, "boxes": boxes, "binary": binary,
                "losses": losses}

    return eval_step

