"""Hungarian-matched DETR set losses with static shapes.

Port of ``tubelet_transformer_tpu/train/criterion.py``. AVA
(``criterion_ava``): 3-way actorness CE with class weights [1, 1,
eos_coef]; multi-label sigmoid BCE with weight ``weight`` on matched
queries; L1 + GIoU box losses over the target count. JHMDB/UCF24
(``criterion_ucf``): the key frame's Q queries gathered from the Q*T
tubelet layout, softmax CE with a no-object class weighted ``eos_coef``,
the clip-level (B, 2) visibility CE, and the box losses (0 when the batch
has no box). Targets are padded: boxes (B, M, 4) normalised cxcywh, labels
(B, M, C) multi-hot (AVA) or (B, M) class ids (UCF), valid (B, M) bool. The
aux (per-decoder-layer) losses fold the layer axis into the batch and share
one matcher call. Reductions follow torch: the weighted CE divides by the
sum of the applied weights, the weighted BCE is a plain mean of w * elem.

Data parallelism: ``reduce`` is the sum over ranks of a normaliser
(``parallel.mesh.Mesh.count_sum``; the identity on one device). Every
divisor (the box count, a sum of class weights, the element count of a
mean, class_error's counts) is summed over ranks before it divides, so
each loss term a rank returns is its additive share of the global batch's
term: the shares sum to it, and so do their gradients. ``class_error``
(``GLOBAL_KEYS``) is the global value itself on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from tubelet_transformer_tpu_torch.ops import box_ops, matcher


# the loss-dict entries that are global values, not a rank's share
GLOBAL_KEYS = ("class_error",)

Reduce = Callable[[torch.Tensor], torch.Tensor]


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _global_mean(x: torch.Tensor, dims: tuple, reduce: Reduce
                 ) -> torch.Tensor:
    """This rank's share of the mean over ``dims`` of the global batch: its
    sum over the element count summed over ranks."""
    n = 1
    for d in dims:
        n *= x.shape[d]
    return x.sum(dims) / reduce(x.new_full((), float(n)))


def _class_weights(n: int, eos_coef: float, device: torch.device
                   ) -> torch.Tensor:
    """(n,) float32 class weights, 1 but the last (no object) at
    ``eos_coef``; made on ``device``, with no upload from the host."""
    return torch.where(torch.arange(n, device=device) < n - 1, 1.0,
                       eos_coef)


def _class_error(correct: torch.Tensor, mf: torch.Tensor, dims: tuple,
                 reduce: Reduce) -> torch.Tensor:
    """100 (1 - matched correct / matched), both counts summed over ranks
    in one reduction."""
    n_match, n_correct = reduce(torch.stack(
        [mf.sum(dims), (correct * mf).sum(dims)])).unbind()
    return 100.0 * (1.0 - n_correct / n_match.clamp(min=1.0))


class TargetsAVA(NamedTuple):
    boxes: torch.Tensor   # (B, M, 4) cxcywh normalised
    labels: torch.Tensor  # (B, M, C) multi-hot float
    valid: torch.Tensor   # (B, M) bool


class TargetsUCF(NamedTuple):
    boxes: torch.Tensor    # (B, M, 4)
    labels: torch.Tensor   # (B, M) int class ids
    valid: torch.Tensor    # (B, M) bool
    vis: torch.Tensor      # (B,) int {0, 1} clip-level visibility
    key_pos: torch.Tensor  # (B,) int key-frame index in [0, T)


def _stable_bce_from_logits(logits: torch.Tensor, targets: torch.Tensor
                            ) -> torch.Tensor:
    """binary_cross_entropy(sigmoid(x), t) without the sigmoid."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(
        torch.exp(-logits.abs()))


def _weighted_ce(logits: torch.Tensor, target_idx: torch.Tensor,
                 class_weights: torch.Tensor, dims=None,
                 reduce: Reduce = _identity) -> torch.Tensor:
    """torch F.cross_entropy with per-class weights, sum(w*nll)/sum(w),
    reduced over ``dims`` of target_idx (all of them by default), sum(w)
    summed over ranks."""
    dims = tuple(range(target_idx.dim())) if dims is None else dims
    nll = -logits.log_softmax(-1).gather(-1, target_idx[..., None])[..., 0]
    w = class_weights[target_idx]
    return (w * nll).sum(dims) / reduce(w.sum(dims)).clamp(min=1e-12)


def match_ava(pred_boxes: torch.Tensor, pred_logits_b: torch.Tensor,
              targets: TargetsAVA, cost_class: float, cost_bbox: float,
              cost_giou: float):
    """AVA matching: class cost = -P(actor) from the binary head. Runs
    without gradients, as the reference's matcher does."""
    with torch.no_grad():
        p_actor = pred_logits_b.softmax(-1)[..., 1]                 # (B, Q)
        class_cost = -p_actor[..., None].expand(
            -1, -1, targets.boxes.shape[1])
        cost = matcher.compute_cost_matrix(
            pred_boxes, class_cost, targets.boxes, targets.valid,
            cost_class, cost_bbox, cost_giou)
        return matcher.match(cost, targets.valid)


def match_ucf(pred_boxes: torch.Tensor, pred_logits: torch.Tensor,
              targets: TargetsUCF, cost_class: float, cost_bbox: float,
              cost_giou: float):
    """JHMDB/UCF matching: class cost = -softmax(logits)[target class]
    (models/detr/matcher_ucf.py:73-74), without gradients."""
    with torch.no_grad():
        prob = pred_logits.softmax(-1)                           # (B,Q,C+1)
        cls = targets.labels.long().clamp(0, prob.shape[-1] - 1)  # (B, M)
        class_cost = -prob.gather(
            -1, cls[:, None, :].expand(-1, prob.shape[1], -1))   # (B,Q,M)
        cost = matcher.compute_cost_matrix(
            pred_boxes, class_cost, targets.boxes, targets.valid,
            cost_class, cost_bbox, cost_giou)
        return matcher.match(cost, targets.valid)


def _gather_matched(arr: torch.Tensor, tgt_for_query: torch.Tensor
                    ) -> torch.Tensor:
    """arr (N, M, ...) gathered by tgt_for_query (N, Q) (clipped at 0);
    pair with the mask tgt_for_query >= 0."""
    idx = tgt_for_query.clamp(min=0)
    idx = idx.reshape(idx.shape + (1,) * (arr.dim() - 2)).expand(
        idx.shape + arr.shape[2:])
    return arr.gather(1, idx)


def ava_layer_losses(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                     pred_logits_b: torch.Tensor, targets: TargetsAVA,
                     tgt_for_query: torch.Tensor, num_boxes: torch.Tensor, *,
                     weight: float, eos_coef: float,
                     evaluation: bool = False, reduce: Reduce = _identity
                     ) -> Dict[str, torch.Tensor]:
    """Losses of the layers stacked on a leading axis (L, B, Q, .): each
    returned value is (L,). ``tgt_for_query`` is (L, B, Q); ``num_boxes``
    the global box count."""
    matched = tgt_for_query >= 0                                  # (L,B,Q)
    lay_n = pred_logits.shape[0]
    mf = matched.float()
    red = tuple(range(1, matched.dim()))                         # (B, Q)

    # actorness CE: target 1 matched / 2 unmatched, weights [1, 1, eos]
    cw = _class_weights(3, eos_coef, pred_logits.device)
    loss_ce_b = _weighted_ce(pred_logits_b, torch.where(matched, 1, 2), cw,
                             red, reduce)

    # multi-label BCE, weight on the matched queries
    def per_layer(x):                    # (L,B,M,.) -> (L*B,M,.)
        return x.flatten(0, 1)

    tfq = per_layer(tgt_for_query)
    labels = targets.labels.repeat(lay_n, 1, 1)
    tgt_cls = _gather_matched(labels, tfq).reshape(pred_logits.shape)
    tgt_cls = torch.where(matched[..., None], tgt_cls, 0.0)
    bce = _stable_bce_from_logits(pred_logits, tgt_cls)
    if evaluation:
        loss_ce = _global_mean(bce, red + (3,), reduce)
    else:
        wq = torch.where(matched, weight, 1.0)[..., None]
        loss_ce = _global_mean(wq * bce, red + (3,), reduce)

    # box L1 + GIoU over the matched pairs, over the total target count
    tgt_box = _gather_matched(targets.boxes.repeat(lay_n, 1, 1),
                              tfq).reshape(pred_boxes.shape)
    l1 = (pred_boxes - tgt_box).abs().sum(-1)
    giou = box_ops.elementwise_giou(box_ops.box_cxcywh_to_xyxy(pred_boxes),
                                    box_ops.box_cxcywh_to_xyxy(tgt_box))
    loss_bbox = (l1 * mf).sum(red) / num_boxes
    loss_giou = ((1.0 - giou) * mf).sum(red) / num_boxes

    # class_error (logging only): a matched query counts as correct when its
    # top-k logits are exactly its k positive labels
    with torch.no_grad():
        pos = tgt_cls > 0.5
        k_pos = pos.sum(-1)
        rank = pred_logits.argsort(-1, descending=True).argsort(-1)
        correct = ((pos == (rank < k_pos[..., None])).all(-1)
                   & (k_pos > 0)).float()
        class_error = _class_error(correct, mf, red, reduce)

    return {"loss_ce": loss_ce, "loss_ce_b": loss_ce_b,
            "loss_bbox": loss_bbox, "loss_giou": loss_giou,
            "class_error": class_error}


def criterion_ava(outputs: Dict[str, torch.Tensor], targets: TargetsAVA, *,
                  cost_class: float, cost_bbox: float, cost_giou: float,
                  weight: float, eos_coef: float, aux_loss: bool = True,
                  evaluation: bool = False, reduce: Reduce = _identity
                  ) -> Dict[str, torch.Tensor]:
    """The AVA criterion over the last layer (and the stacked aux layers):
    loss_ce / loss_ce_b / loss_bbox / loss_giou / class_error, plus
    ``_<i>``-suffixed aux entries."""
    num_boxes = reduce(targets.valid.float().sum()).clamp(min=1.0)
    if aux_loss:
        logits = outputs["aux_logits"]                 # (L, B, Q, C)
        boxes = outputs["aux_boxes"]
        logits_b = outputs["aux_logits_b"]
    else:
        logits = outputs["pred_logits"][None]
        boxes = outputs["pred_boxes"][None]
        logits_b = outputs["pred_logits_b"][None]
    lay_n, b, q, _ = logits.shape

    # one matcher call for every layer
    reps = TargetsAVA(boxes=targets.boxes.repeat(lay_n, 1, 1),
                      labels=targets.labels.repeat(lay_n, 1, 1),
                      valid=targets.valid.repeat(lay_n, 1))
    tfq, _ = match_ava(boxes.flatten(0, 1), logits_b.flatten(0, 1), reps,
                       cost_class, cost_bbox, cost_giou)
    per_layer = ava_layer_losses(
        logits, boxes, logits_b, targets, tfq.reshape(lay_n, b, q),
        num_boxes, weight=weight, eos_coef=eos_coef, evaluation=evaluation,
        reduce=reduce)

    losses = {k: v[-1] for k, v in per_layer.items()}
    if aux_loss:
        for i in range(lay_n - 1):
            for k in ("loss_ce", "loss_ce_b", "loss_bbox", "loss_giou"):
                losses[f"{k}_{i}"] = per_layer[k][i]
    return losses


def ucf_layer_losses(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                     pred_logits_b: torch.Tensor, targets: TargetsUCF,
                     tgt_for_query: torch.Tensor, num_boxes: torch.Tensor, *,
                     eos_coef: float, num_classes: int,
                     reduce: Reduce = _identity) -> Dict[str, torch.Tensor]:
    """Losses of the softmax (JHMDB/UCF) criterion for the layers stacked
    on a leading axis: ``pred_*`` (L, B, Q, .) already key-frame gathered,
    ``pred_logits_b`` the clip-level (L, B, 2) visibility head,
    ``tgt_for_query`` (L, B, Q), ``num_boxes`` the global box count (0
    when no rank holds a box). Each returned value is (L,)."""
    matched = tgt_for_query >= 0                                  # (L,B,Q)
    lay_n = pred_logits.shape[0]
    mf = matched.float()
    red = (1, 2)

    # visibility CE over (B, 2), unweighted (criterion.py:251-253)
    vis = targets.vis.long()[None, :, None].expand(lay_n, -1, 1)
    loss_ce_b = _global_mean(
        -pred_logits_b.log_softmax(-1).gather(-1, vis)[..., 0], (1,), reduce)

    # softmax CE with the no-object class at weight eos_coef
    tfq = tgt_for_query.flatten(0, 1)
    labels = targets.labels.long().repeat(lay_n, 1)
    tgt_ids = _gather_matched(labels[..., None], tfq)[..., 0].reshape(
        matched.shape)
    tgt_full = torch.where(matched, tgt_ids, num_classes)
    cw = _class_weights(num_classes + 1, eos_coef, pred_logits.device)
    loss_ce = _weighted_ce(pred_logits, tgt_full, cw, red, reduce)

    # box losses over the matched pairs, 0 when the batch has no box
    # (criterion.py:308-318)
    tgt_box = _gather_matched(targets.boxes.repeat(lay_n, 1, 1),
                              tfq).reshape(pred_boxes.shape)
    l1 = (pred_boxes - tgt_box).abs().sum(-1)
    giou = box_ops.elementwise_giou(box_ops.box_cxcywh_to_xyxy(pred_boxes),
                                    box_ops.box_cxcywh_to_xyxy(tgt_box))
    has_boxes = num_boxes > 0
    denom = num_boxes.clamp(min=1.0)
    loss_bbox = torch.where(has_boxes, (l1 * mf).sum(red) / denom, 0.0)
    loss_giou = torch.where(has_boxes, ((1.0 - giou) * mf).sum(red) / denom,
                            0.0)

    # top-1 accuracy of the matched queries (logging only)
    with torch.no_grad():
        correct = ((pred_logits.argmax(-1) == tgt_full) & matched).float()
        class_error = _class_error(correct, mf, red, reduce)

    return {"loss_ce": loss_ce, "loss_ce_b": loss_ce_b,
            "loss_bbox": loss_bbox, "loss_giou": loss_giou,
            "class_error": class_error}


def gather_key_frame_queries(x: torch.Tensor, key_pos: torch.Tensor,
                             num_queries: int) -> torch.Tensor:
    """The key frame's Q queries of the (B, Q*T, ...) tubelet layout: rows
    key_pos*Q .. key_pos*Q + Q - 1 of each sample (criterion.py:378-380)."""
    rows = (key_pos.long()[:, None] * num_queries
            + torch.arange(num_queries, device=x.device)[None])  # (B, Q)
    return x[torch.arange(x.shape[0], device=x.device)[:, None], rows]


def criterion_ucf(outputs: Dict[str, torch.Tensor], targets: TargetsUCF, *,
                  cost_class: float, cost_bbox: float, cost_giou: float,
                  eos_coef: float, num_classes: int, num_queries: int,
                  aux_loss: bool = True, reduce: Reduce = _identity
                  ) -> Dict[str, torch.Tensor]:
    """The JHMDB/UCF criterion with the key-frame query gather, over the
    last layer (and the stacked aux layers)."""
    if aux_loss:
        logits = outputs["aux_logits"]                 # (L, B, Q*T, C+1)
        boxes = outputs["aux_boxes"]
        logits_b = outputs["aux_logits_b"]             # (L, B, 2)
    else:
        logits = outputs["pred_logits"][None]
        boxes = outputs["pred_boxes"][None]
        logits_b = outputs["pred_logits_b"][None]
    lay_n, b = logits.shape[:2]
    # (L, B, Q*T, .) -> (L, B, Q, .), the layers moved out of the way
    logits_k, boxes_k = (gather_key_frame_queries(
        x.movedim(0, 2), targets.key_pos, num_queries).movedim(2, 0)
        for x in (logits, boxes))

    reps = TargetsUCF(boxes=targets.boxes.repeat(lay_n, 1, 1),
                      labels=targets.labels.repeat(lay_n, 1),
                      valid=targets.valid.repeat(lay_n, 1),
                      vis=targets.vis.repeat(lay_n),
                      key_pos=targets.key_pos.repeat(lay_n))
    tfq, _ = match_ucf(boxes_k.flatten(0, 1), logits_k.flatten(0, 1), reps,
                       cost_class, cost_bbox, cost_giou)
    per_layer = ucf_layer_losses(
        logits_k, boxes_k, logits_b, targets,
        tfq.reshape(lay_n, b, num_queries),
        reduce(targets.valid.float().sum()), eos_coef=eos_coef,
        num_classes=num_classes, reduce=reduce)

    losses = {k: v[-1] for k, v in per_layer.items()}
    if aux_loss:
        for i in range(lay_n - 1):
            for k in ("loss_ce", "loss_ce_b", "loss_bbox", "loss_giou"):
                losses[f"{k}_{i}"] = per_layer[k][i]
    return losses


def build_weight_dict(cfg, epoch: int = 0) -> Dict[str, float]:
    """Loss weights, with the post-WEIGHT_CHANGE swap of the last layer's
    loss_ce weight (the aux layers keep theirs)."""
    wd = {"loss_ce": cfg.loss.dice_cof, "loss_bbox": cfg.loss.bbox_cof,
          "loss_giou": cfg.loss.giou_cof, "loss_ce_b": 1.0}
    if cfg.train.aux_loss:
        base = list(wd)
        for i in range(cfg.model.dec_layers - 1):
            for k in base:
                wd[f"{k}_{i}"] = wd[k]
    if epoch > cfg.loss.weight_change:
        wd["loss_ce"] = cfg.loss.loss_change_cof
    return wd
