"""Box utilities on torch tensors.

Port of ``tubelet_transformer_tpu/ops/box_ops.py`` (DETR's ``box_ops``
semantics). Like the JAX module there are no asserts on values: degenerate
boxes are the caller's responsibility.
"""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) [cx, cy, w, h] -> [x0, y0, x1, y1]."""
    cx, cy, w, h = b.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x0, y0, x1, y1] -> [cx, cy, w, h]."""
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU of xyxy boxes: (N, 4) x (M, 4) -> (N, M) iou, union."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    iou = inter / union.clamp(min=1e-12)
    return iou, union


def generalized_box_iou(boxes1: torch.Tensor,
                        boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes -> (N, M)."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-12)


def elementwise_giou(boxes1: torch.Tensor,
                     boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU of aligned (..., 4) xyxy boxes -> (...), the diagonal of
    ``generalized_box_iou`` without the N x N matrix."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / union.clamp(min=1e-12)

    lt_c = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_c = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_c = (rb_c - lt_c).clamp(min=0.0)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return iou - (area_c - union) / area_c.clamp(min=1e-12)


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               max_outputs: int, iou_threshold: float = 0.5,
               score_threshold: float = float("-inf")) -> torch.Tensor:
    """Greedy NMS with fixed shapes; returns the (n,) bool keep mask.

    Same rounds as the JAX version: at most ``max_outputs`` picks of the
    highest-scoring live box, each removing itself and every box whose IoU
    with it is strictly above ``iou_threshold``; scores at or below
    ``score_threshold`` never live."""
    n = boxes.shape[0]
    iou, _ = box_iou(boxes, boxes)
    alive = valid & (scores > score_threshold)
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    idx = torch.arange(n, device=boxes.device)
    for _ in range(min(max_outputs, n)):
        best = torch.argmax(torch.where(alive, scores, neg_inf))
        any_alive = alive.any()
        keep[best] = keep[best] | any_alive
        suppress = (iou[best] > iou_threshold) | (idx == best)
        alive = alive & torch.where(any_alive, ~suppress, True)
    return keep
