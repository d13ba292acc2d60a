"""Hungarian matching for DETR-style set losses.

Port of ``tubelet_transformer_tpu/ops/matcher.py``. The cost matrix is built
on the device, as there (``compute_cost_matrix``, invalid target columns at
``PAD_COST``), and the assignment is solved there too: on a CUDA tensor by
the kernel of ``ops/cuda/assign.py`` (the counterpart of JAX's on-device
``_solve_rect``), with no host round trip; on a CPU tensor by its plain
version. Each sample's valid target columns are solved exactly, as scipy's
``linear_sum_assignment`` solves them (JAX squares the problem with
``PAD_COST`` columns instead); on ties the two may pick different
assignments of equal cost.
"""

from __future__ import annotations

import torch

from tubelet_transformer_tpu_torch.ops import box_ops
from tubelet_transformer_tpu_torch.ops.cuda.assign import PAD_COST, assign


def compute_cost_matrix(pred_boxes: torch.Tensor, class_cost: torch.Tensor,
                        tgt_boxes: torch.Tensor, tgt_valid: torch.Tensor,
                        cost_class: float, cost_bbox: float,
                        cost_giou: float) -> torch.Tensor:
    """Weighted DETR matching cost (B, Q, M): L1 + class term - GIoU, with
    invalid target columns set to PAD_COST. pred_boxes (B,Q,4) and
    tgt_boxes (B,M,4) normalised cxcywh; class_cost (B,Q,M)."""
    cost_l1 = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]
               ).abs().sum(-1)
    giou = box_ops.generalized_box_iou(
        box_ops.box_cxcywh_to_xyxy(pred_boxes),
        box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    c = cost_bbox * cost_l1 + cost_class * class_cost + cost_giou * (-giou)
    return torch.where(tgt_valid[:, None, :], c, PAD_COST)


def match(cost: torch.Tensor, tgt_valid: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve the assignment; returns (tgt_for_query, query_for_tgt) on the
    cost's device.

    tgt_for_query: (B, Q) int64, the target matched to each query, -1 for an
      unmatched query.
    query_for_tgt: (B, M) int64, the query matched to each target, -1 for a
      padded or overflow target (more valid targets than queries)."""
    # non-finite costs (outputs of a diverged step) get an arbitrary but
    # valid assignment; the loss is not finite then, and the step skips
    return assign(cost.detach().float().contiguous(),
                  tgt_valid.bool().contiguous())
