"""Train and eval steps.

Port of ``tubelet_transformer_tpu/train/engine.py`` for one device. A step
is eager PyTorch: preprocess (with the HSV jitter for uint8 clips), the
train forward, the matched losses (the assignment solved on the device),
the weighted total, backward, the global
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

The NaN guard skips the whole update when the total loss is not finite,
decided on the device, as the JAX step decides it (engine.py:218-236
there): the fused AdamW step (``train/optimizer.py:skip_unless``) leaves
the parameters, the moments and the step counts as they were, the BN
running statistics, which the forward has already updated in place, are
selected back from a copy taken before it, and the update count, which
indexes the table of the schedule's rates on the device, does not move.
Nothing of the step waits for the device on one process: the assignment
is solved there too (``ops/cuda/assign.py``), and the metrics stay 0-dim
device tensors.

Randomness is a ``torch.Generator`` on the model's device, reseeded at each
step from ``TRAIN.SEED``, the step number and the data index, so that a
resumed run draws what the uninterrupted one would have (the JAX step
folds the step into its key the same way), two data shards never draw the
same jitter or dropout masks, and the model peers of one shard draw alike.

Data parallelism (``MESH.DATA``, a ``parallel.mesh.Mesh`` of more than one
rank): each rank runs the step on its shard of the global batch. The BN
statistics are the global batch's (``CSN.set_rank_mean``), the criterion's
normalisers are summed over ranks, so that each rank's loss terms are its
additive shares of the global batch's, and after the backward one flat
all-reduce sums the ranks' gradients: the gradient of the global loss, on
every rank. The clip, the NaN guard (on the global total) and AdamW then
see the same values on every rank, and the metrics are the global ones.
With ACCUM_STEPS, microbatch i is the union of every rank's local slice i.
With MoE the load-balance counts are summed over ranks in each MoE layer
(``MoEFFN.forward``'s ``reduce``), so ``loss_moe_aux`` is a share like the
criterion's terms. With ``MESH.ZERO1`` the optimizer is
``parallel.zero.ZeroAdamW``: the same all-reduced, clipped gradients, the
moments sharded over the data group, one all-gather of the updated
parameters over it (beside a 'model' axis too, where the split
parameters' moments stay the model peer's slices).

Tensor parallelism (``MESH.MODEL``, a mesh whose 'model' axis has more than
one peer, the model split over it by ``build_model(..., mesh=mesh)``): the
model peers of a data shard run the step on the same shard, the
replicated parts alike and the split parts on their own slices, with the
model group's collectives in the forward (``parallel/mesh.py``'s "f" and
"g"). Each peer then holds the whole loss of its shard, the gradients of
the replicated parameters equal on every peer and of its own slices; the
data reductions above run over the data group, and the clip sums the
squared norm of the split gradients over the model group. Every peer of
a shard draws the same jitter and dropout, so the matcher picks the same
matches and the replicated parameters stay equal.

Pipeline parallelism (``MESH.PIPE``, the model built on a mesh with a
'pipe' axis): the pipe peers of a data shard (and model index) run the
step on the same shard, everything but the encoder alike, the encoder as
GPipe stages (``parallel/pipeline.py``), each stage's layers its own.
Every pipe peer then holds the whole loss of its shard; the gradients of
the replicated parameters are equal on every stage (the encoder input's
gradient is stage 0's, summed over the pipe group) and each stage has
its layers'; the data reductions run over the data group (the ranks of
one model and pipe index), and the clip sums the squared norm of the
stages' gradients over the pipe group. The eval step runs the same
pipelined encoder; a shard's batch must divide by
MESH.PIPE_MICROBATCHES, or the step raises ValueError as JAX's does.

Spatial parallelism (``MESH.SPATIAL`` beside ``MESH.MODEL``, a mesh whose
``spatial`` is set, the model built on it): the steps preprocess the
whole clip, so that the jitter and the pad zeroing draw and read what one
process does, then hand the model this peer's rows of it
(``keep_rows``); the trunk runs on them (``models/csn.py``), its BN
statistics averaged over the data x model ranks of each pipe stage,
weighted by each rank's pixels, and its parameters' gradients, each
peer's share over its rows, are summed over the model group
(``sharding_rules.spatial_partial``) before the data group's all-reduce.
Beside a 'pipe' axis every pipe stage runs the trunk on its shard's rows
alike, and the gathered feature map enters the pipelined encoder as under
MESH.PIPE alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np
import torch

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.data import transforms
from tubelet_transformer_tpu_torch.data.device_preprocess import (
    device_preprocess)
from tubelet_transformer_tpu_torch.models.csn import (
    BLOCK_NUMS, FoldableBN, spatial_rows)
from tubelet_transformer_tpu_torch.models.tuber import TubeR, dataset_mode
from tubelet_transformer_tpu_torch.parallel.mesh import Mesh
from tubelet_transformer_tpu_torch.parallel.sharding_rules import (
    spatial_partial)
from tubelet_transformer_tpu_torch.parallel.zero import ZeroAdamW
from tubelet_transformer_tpu_torch.train import criterion as crit
from tubelet_transformer_tpu_torch.train.optimizer import (
    build_optimizer, clip_by_global_norm, skip_unless, trainable_params)
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
    # optimizer updates applied, the schedule's count: a 0-dim int64 tensor
    # on the model's device, which the train step advances there
    updates: torch.Tensor = field(
        default_factory=lambda: torch.zeros((), dtype=torch.long))
    # the update count from which the schedule's rate no longer changes
    horizon: int = 0


def create_train_state(cfg: Config, model: TubeR, steps_per_epoch: int,
                       mesh: Mesh = Mesh()) -> TrainState:
    """AdamW and the schedule for ``model`` (the train build), which gets
    its frozen parameters frozen; with ``MESH.ZERO1`` and a ``mesh`` of
    more than one rank, the ZeRO-1 AdamW over that mesh."""
    device = next(model.parameters()).device
    return TrainState(model=model,
                      optimizer=build_optimizer(cfg, model, mesh),
                      schedule=build_schedule(cfg, steps_per_epoch),
                      seed=cfg.train.seed,
                      updates=torch.zeros((), dtype=torch.long,
                                          device=device),
                      horizon=cfg.train.epoch_num * steps_per_epoch)


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


def clip_height(cfg: Config) -> int:
    """The rows of the clips the loaders give (``clip_canvas``)."""
    return clip_canvas(cfg)[0]


def clip_canvas(cfg: Config) -> tuple[int, int]:
    """(H, W) of the clips the loaders give: the synthetic set's square
    IMG_SIZE, else the canvas (DATA.CANVAS_H x CANVAS_W, or
    ``default_canvas``)."""
    if cfg.data.dataset_name == "synthetic":
        return cfg.data.img_size, cfg.data.img_size
    if cfg.data.canvas_h and cfg.data.canvas_w:
        return cfg.data.canvas_h, cfg.data.canvas_w
    return transforms.default_canvas(cfg.data.img_size)


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for the step options not ported yet, and
    with MESH.SPATIAL ValueError where MESH.MODEL does not divide the
    clip's rows (``csn.spatial_rows``), the one split JAX's ``device_put``
    refuses too: every other split runs, its deeper bands uneven or empty
    where the strides leave them so, beside a 'pipe' axis too."""
    if cfg.model.infer_chunk > 0:
        raise NotImplementedError("MODEL.INFER_CHUNK is not ported yet")
    if cfg.mesh.spatial and cfg.mesh.model > 1:
        spatial_rows(clip_height(cfg), BLOCK_NUMS[cfg.model.backbone_name],
                     cfg.model.last_stride, cfg.mesh.model)


def keep_rows(clips: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model peer's rows of the (B,T,H,W,C) clips when the peers
    split them (MESH.SPATIAL), else the clips."""
    first, count = mesh.own_rows(clips.shape[2])
    return clips if count == clips.shape[2] else clips[
        :, :, first:first + count].contiguous()


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


def sync_gradients(params: List[torch.nn.Parameter], mesh: Mesh,
                   trunk: frozenset = frozenset()) -> None:
    """Sum each gradient over ranks in place, in one all-reduce of the
    gradients flattened into one buffer. Every rank has run the same graph,
    so the same parameters have gradients on every rank. With the rows
    split (MESH.SPATIAL), the gradients of ``trunk`` (parameter ids) are
    first summed over the model group (``Mesh.trunk_sum``)."""
    mesh.trunk_sum([p.grad for p in params
                    if p.grad is not None and id(p) in trunk])
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


def check_model_mesh(model: TubeR, mesh: Mesh) -> None:
    """Raise ValueError unless ``model`` is split over ``mesh``'s 'model'
    axis exactly when that axis has more than one peer, runs its encoder
    as stages over the 'pipe' axis exactly when that one has, and splits
    the clip's rows exactly when the mesh does (MESH.SPATIAL)."""
    tp = getattr(model, "tp", None)
    split = tp.model if tp is not None else 1
    if split != mesh.model:
        raise ValueError(
            f"MESH.MODEL {mesh.model}: the model is split over {split} "
            "peers; build it with build_model(..., mesh=mesh)")
    pipe = model.transformer.pipe
    if (pipe.pipe if pipe is not None else 1) != mesh.pipe:
        raise ValueError(
            f"MESH.PIPE {mesh.pipe}: the model's encoder runs as "
            f"{pipe.pipe if pipe is not None else 1} stages; build it with "
            "build_model(..., mesh=mesh)")
    if (model.spatial is not None) != mesh.spatial:
        raise ValueError(
            f"MESH.SPATIAL {mesh.spatial} on MESH.MODEL {mesh.model}: the "
            f"model {'splits' if model.spatial is not None else 'keeps'} "
            "the clip's rows; build it with build_model(..., mesh=mesh)")


def step_seed(seed: int, step: int, data_index: int) -> int:
    """The seed of a train step's generator: TRAIN.SEED, the step, and
    the data index by an odd 32-bit multiplier (the CPU generator keeps
    the low 32 bits of a seed)."""
    return seed * 1_000_003 + step + data_index * 2_654_435_761


def make_train_step(cfg: Config, state: TrainState, mesh: Mesh = Mesh()):
    """The train step: (batch on the device, loss_ce weight) -> metrics
    (0-dim tensors, the global batch's under data parallelism), updating
    ``state`` in place. ``mesh``: this process's place on the 'data',
    'model' and 'pipe' axes (one device by default); the batch is this
    rank's data shard."""
    check_supported(cfg)
    check_model_mesh(state.model, mesh)
    sharded = isinstance(state.optimizer, ZeroAdamW)
    if sharded != (cfg.mesh.zero1 and mesh.data > 1) or (
            sharded and (state.optimizer.mesh.data, state.optimizer.mesh.model,
                         state.optimizer.mesh.pipe)
            != (mesh.data, mesh.model, mesh.pipe)):
        raise ValueError(
            f"MESH.ZERO1 {cfg.mesh.zero1} on a 'data' axis of {mesh.data}: "
            f"the state's optimizer is {type(state.optimizer).__name__}; "
            "build it with create_train_state(..., mesh=mesh)")
    model = state.model
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    model.set_dropout_generator(generator)
    model.backbone.body.set_rank_mean(
        mesh.batch_mean if mesh.data > 1 or mesh.spatial else None)
    params = trainable_params(state.optimizer)
    trunk = frozenset(id(p) for n, p in model.named_parameters()
                      if spatial_partial(n))
    stats = _bn_stats(model)
    sizes = [t.numel() for t in stats]
    # each group's rate at every update count up to the horizon, on the
    # device: the step indexes it by the device count
    groups = state.optimizer.param_groups
    rates = torch.tensor([[state.schedule(k) * g["lr_scale"]
                           for k in range(state.horizon + 1)]
                          for g in groups], dtype=torch.float32).to(device)
    accum = max(1, cfg.train.accum_steps)

    def microbatch(batch: Dict[str, torch.Tensor], clips: torch.Tensor,
                   loss_ce_weight: float):
        """Forward, losses and backward of one microbatch: the total and
        the loss terms, detached."""
        outputs = model(clips, batch.get("pad_mask"), **lfb_kwargs(batch),
                        moe_reduce=mesh.count_sum)
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
        generator.manual_seed(step_seed(state.seed, state.step,
                                        mesh.data_index))
        clips = keep_rows(device_preprocess(
            batch["clips"], dtype=model.dtype, pad_mask=batch.get("pad_mask"),
            jitter=True, generator=generator), mesh)
        b = clips.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by "
                             f"TRAIN.ACCUM_STEPS={accum}")
        saved = torch.cat([t.reshape(-1) for t in stats])
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
        sync_gradients(params, mesh, trunk)
        loss_dict = global_losses({**loss_dict, "total_loss": total}, mesh)
        total = loss_dict.pop("total_loss")
        if accum > 1:
            # the sums first, then the scaling, as the JAX step
            inv = 1.0 / accum
            torch._foreach_mul_([p.grad for p in params
                                 if p.grad is not None], inv)
            total = total * inv
            loss_dict = {k: v * inv for k, v in loss_dict.items()}
        grad_norm = clip_by_global_norm(params, cfg.loss.clips_max_norm,
                                        mesh)
        finite = torch.isfinite(total)
        lrs = rates.index_select(
            1, state.updates.clamp(max=state.horizon).view(1))[:, 0]
        for g, lr in zip(groups, lrs.unbind()):
            g["lr"] = lr
        skip_unless(state.optimizer, finite)
        state.optimizer.step()
        state.updates += finite
        # a true select: a non-finite statistic times 0 would stay NaN
        kept = torch.where(finite, torch.cat([t.reshape(-1) for t in stats]),
                           saved)
        torch._foreach_copy_(stats, [k.view_as(t) for k, t in zip(
            kept.split(sizes), stats)])
        state.step += 1
        metrics = dict(loss_dict)
        metrics["total_loss"] = total
        metrics["finite"] = finite.float()
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_eval_step(cfg: Config, model: TubeR, mesh: Mesh = Mesh()):
    """The eval step: batch on the device -> detections (postprocess_ava,
    or postprocess_softmax for JHMDB/UCF) of this rank's shard and, unless
    VAL.COMPUTE_LOSSES is off, the criterion's losses of the global
    batch."""
    check_supported(cfg)
    check_model_mesh(model, mesh)
    postprocess = postprocess_ava if is_ava_mode(cfg) else postprocess_softmax

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict:
        model.eval()
        pad_mask = batch.get("pad_mask")
        outputs = model(keep_rows(device_preprocess(
            batch["clips"], dtype=model.dtype, pad_mask=pad_mask), mesh),
            pad_mask, **lfb_kwargs(batch))
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

