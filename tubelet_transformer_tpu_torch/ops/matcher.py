"""Hungarian matching for DETR-style set losses.

Port of ``tubelet_transformer_tpu/ops/matcher.py``. The cost matrix is built
on the device, as there (``compute_cost_matrix``, invalid target columns at
``PAD_COST``). The assignment is solved on the host with scipy's
``linear_sum_assignment`` over each sample's valid target columns, after one
device-to-host copy of the whole stacked (N, Q, M) cost; the JAX package
solves the same rectangular problem on the device (Jonker-Volgenant). Both
give an optimal assignment; on ties they may pick different ones of equal
cost.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from tubelet_transformer_tpu_torch.ops import box_ops

PAD_COST = 1.0e6


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
    b, q, m = cost.shape
    # non-finite costs (outputs of a diverged step) get an arbitrary but
    # valid assignment; the loss is not finite then, and the step skips
    cost_h = np.nan_to_num(cost.detach().to("cpu", torch.float64).numpy(),
                           nan=PAD_COST, posinf=PAD_COST, neginf=-PAD_COST)
    valid_h = tgt_valid.cpu().numpy()
    tfq = np.full((b, q), -1, np.int64)
    qft = np.full((b, m), -1, np.int64)
    for i in range(b):
        cols = np.flatnonzero(valid_h[i])
        rows, sel = linear_sum_assignment(cost_h[i][:, cols])
        tfq[i, rows] = cols[sel]
        qft[i, cols[sel]] = rows
    return (torch.from_numpy(tfq).to(cost.device),
            torch.from_numpy(qft).to(cost.device))
