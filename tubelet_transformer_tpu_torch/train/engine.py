"""Train and eval steps.

Port of ``tubelet_transformer_tpu/train/engine.py`` for one device. A step
is eager PyTorch: preprocess (with the HSV jitter for uint8 clips), the
train forward, the matched losses (the assignment on the host, one
device-to-host copy of the costs), the weighted total, backward, the global
norm clip over the trainable gradients, and AdamW at the scheduled rate.
With MoE encoder FFNs the model's ``moe_aux`` joins the total, weighted by
``LOSS_COFS.MOE_AUX_COF``, and is reported as ``loss_moe_aux``.

With ``TRAIN.ACCUM_STEPS`` > 1 the step splits the batch (after the jitter,
which runs once on the whole batch) into that many microbatches, in order:
each runs its forward, its criterion (normalised within the microbatch)
and its backward, so that the gradients sum, and the BN running statistics
take one update per microbatch. The summed gradients, the total and every
loss term are then scaled by 1/ACCUM_STEPS, as the JAX step does
(engine.py:127-213 there), before the clip and the update.

The NaN guard skips the whole update when the total loss is not finite:
the parameters and the Adam moments (no ``optimizer.step()``) and the BN
running statistics, which the forward has already updated in place and are
put back from a copy taken before it.

Randomness is a ``torch.Generator`` on the model's device, reseeded at each
step from ``TRAIN.SEED``, the step number and the data-parallel rank, so
that a resumed run draws what the uninterrupted one would have (the JAX step
folds the step into its key the same way), and two ranks never draw the same
jitter or dropout masks.

Data parallelism (``MESH.DATA``, a ``parallel.mesh.Mesh`` of more than one
rank): each rank runs the step on its shard of the global batch. The BN
statistics are the global batch's (``CSN.set_rank_mean``), the criterion's
normalisers are summed over ranks, so that each rank's loss terms are its
additive shares of the global batch's, and after the backward one flat
all-reduce sums the ranks' gradients: the gradient of the global loss, on
every rank. The clip, the NaN guard (on the global total) and AdamW then
see the same values on every rank, and the metrics are the global ones.
With ACCUM_STEPS, microbatch i is the union of every rank's local slice i.
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
from tubelet_transformer_tpu_torch.parallel.mesh import Mesh
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


def check_supported(cfg: Config, data: int | None = None) -> None:
    """Raise NotImplementedError for the step options not ported yet;
    ``data`` is the mesh's 'data' size (``cfg.mesh.data`` when None)."""
    data = cfg.mesh.data if data is None else data
    unsupported = {
        "MODEL.INFER_CHUNK": cfg.model.infer_chunk > 0,
        "MESH.MODEL > 1": cfg.mesh.model > 1,
        "MESH.PIPE > 1": cfg.mesh.pipe > 1,
        "MESH.ZERO1": cfg.mesh.zero1,
        "MESH.SPATIAL": cfg.mesh.spatial,
    }
    for name, asked in unsupported.items():
        if asked:
            raise NotImplementedError(f"{name} is not ported yet")
    if cfg.model.moe_experts > 0 and data > 1:
        # the load-balance loss multiplies two means over the batch's
        # tokens: no sum of per-rank shares gives its gradient
        raise NotImplementedError(
            "MODEL.MOE_EXPERTS with MESH.DATA > 1 is not ported yet: the "
            "MoE auxiliary loss is a product of global means, not a sum of "
            "per-rank shares")


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


def compute_losses(cfg: Config, outputs, targets, evaluation: bool = False,
                   mesh: Mesh = Mesh()):
    """The criterion of the dataset's mode; under data parallelism each
    loss term is this rank's share (``criterion.GLOBAL_KEYS`` aside)."""
    if is_ava_mode(cfg):
        return crit.criterion_ava(
            outputs, targets, cost_class=cfg.matcher.cost_class,
            cost_bbox=cfg.matcher.cost_bbox, cost_giou=cfg.matcher.cost_giou,
            weight=cfg.loss.weight, eos_coef=cfg.loss.eos_cof,
            aux_loss=cfg.train.aux_loss, evaluation=evaluation,
            reduce=mesh.count_sum)
    return crit.criterion_ucf(
        outputs, targets, cost_class=cfg.matcher.cost_class,
        cost_bbox=cfg.matcher.cost_bbox, cost_giou=cfg.matcher.cost_giou,
        eos_coef=cfg.loss.eos_cof, num_classes=cfg.data.num_classes,
        num_queries=cfg.model.query_num, aux_loss=cfg.train.aux_loss,
        reduce=mesh.count_sum)


def global_losses(loss_dict: Dict[str, torch.Tensor], mesh: Mesh
                  ) -> Dict[str, torch.Tensor]:
    """The global batch's loss dict from this rank's shares: one
    all-reduce of the stacked shares (``criterion.GLOBAL_KEYS`` are global
    already)."""
    if mesh.data == 1:
        return loss_dict
    keys = [k for k in loss_dict if k not in crit.GLOBAL_KEYS]
    summed = mesh.share_sum(torch.stack([loss_dict[k] for k in keys]))
    return {**loss_dict, **dict(zip(keys, summed.unbind()))}


def sync_gradients(params: List[torch.nn.Parameter], mesh: Mesh) -> None:
    """Sum each gradient over ranks in place, in one all-reduce of the
    gradients flattened into one buffer. Every rank has run the same graph,
    so the same parameters have gradients on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if mesh.data == 1 or not grads:
        return
    flat = mesh.share_sum(torch.cat([g.reshape(-1) for g in grads]))
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


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


def make_train_step(cfg: Config, state: TrainState, mesh: Mesh = Mesh()):
    """The train step: (batch on the device, loss_ce weight) -> metrics
    (0-dim tensors, the global batch's under data parallelism), updating
    ``state`` in place. ``mesh``: this process's place on the 'data' axis
    (one device by default); the batch is this rank's shard."""
    check_supported(cfg, mesh.data)
    model = state.model
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    model.set_dropout_generator(generator)
    model.backbone.body.set_rank_mean(mesh.batch_mean if mesh.data > 1
                                      else None)
    params = trainable_params(state.optimizer)
    stats = _bn_stats(model)
    saved = [torch.empty_like(t) for t in stats]
    accum = max(1, cfg.train.accum_steps)

    def microbatch(batch: Dict[str, torch.Tensor], clips: torch.Tensor,
                   loss_ce_weight: float):
        """Forward, losses and backward of one microbatch: the total and
        the loss terms, detached."""
        outputs = model(clips, batch.get("pad_mask"), **lfb_kwargs(batch))
        loss_dict = compute_losses(cfg, outputs,
                                   _targets_from_batch(cfg, batch), mesh=mesh)
        total = weighted_total(cfg, loss_dict, loss_ce_weight)
        if "moe_aux" in outputs:
            loss_dict["loss_moe_aux"] = outputs["moe_aux"]
            total = total + cfg.loss.moe_aux_cof * outputs["moe_aux"]
        total.backward()
        return total.detach(), {k: v.detach() for k, v in loss_dict.items()}

    def train_step(batch: Dict[str, torch.Tensor], loss_ce_weight: float
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        # the rank by an odd 32-bit multiplier: the CPU generator keeps
        # the low 32 bits of a seed
        generator.manual_seed(state.seed * 1_000_003 + state.step
                              + mesh.rank * 2_654_435_761)
        clips = device_preprocess(batch["clips"], dtype=model.dtype,
                                  pad_mask=batch.get("pad_mask"),
                                  jitter=True, generator=generator)
        b = clips.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by "
                             f"TRAIN.ACCUM_STEPS={accum}")
        torch._foreach_copy_(saved, stats)
        state.optimizer.zero_grad(set_to_none=True)
        mb = b // accum
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            t, ld = microbatch({k: v[rows] for k, v in batch.items()},
                               clips[rows], loss_ce_weight)
            if i == 0:
                total, loss_dict = t, ld
            else:
                total = total + t
                loss_dict = {k: loss_dict[k] + v for k, v in ld.items()}
        sync_gradients(params, mesh)
        loss_dict = global_losses({**loss_dict, "total_loss": total}, mesh)
        total = loss_dict.pop("total_loss")
        if accum > 1:
            # the sums first, then the scaling, as the JAX step
            inv = 1.0 / accum
            torch._foreach_mul_([p.grad for p in params
                                 if p.grad is not None], inv)
            total = total * inv
            loss_dict = {k: v * inv for k, v in loss_dict.items()}
        grad_norm = clip_by_global_norm(params, cfg.loss.clips_max_norm)
        finite = bool(torch.isfinite(total))
        if finite:
            set_learning_rate(state.optimizer, state.schedule(state.updates))
            state.optimizer.step()
            state.updates += 1
        else:
            torch._foreach_copy_(stats, saved)
        state.step += 1
        metrics = dict(loss_dict)
        metrics["total_loss"] = total
        metrics["finite"] = torch.tensor(float(finite))
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_eval_step(cfg: Config, model: TubeR, mesh: Mesh = Mesh()):
    """The eval step: batch on the device -> detections (postprocess_ava,
    or postprocess_softmax for JHMDB/UCF) of this rank's shard and, unless
    VAL.COMPUTE_LOSSES is off, the criterion's losses of the global
    batch."""
    check_supported(cfg, mesh.data)
    postprocess = postprocess_ava if is_ava_mode(cfg) else postprocess_softmax

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict:
        model.eval()
        pad_mask = batch.get("pad_mask")
        outputs = model(device_preprocess(batch["clips"], dtype=model.dtype,
                                          pad_mask=pad_mask), pad_mask,
                        **lfb_kwargs(batch))
        if cfg.val.compute_losses:
            losses = global_losses(compute_losses(
                cfg, outputs, _targets_from_batch(cfg, batch),
                evaluation=True, mesh=mesh), mesh)
        else:
            losses = {k: torch.zeros(()) for k in
                      ("loss_ce", "loss_ce_b", "loss_bbox", "loss_giou")}
        scores, boxes, binary = postprocess(outputs, batch["sizes"])
        return {"scores": scores, "boxes": boxes, "binary": binary,
                "losses": losses}

    return eval_step

