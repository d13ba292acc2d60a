"""Model outputs -> detection arrays, on the device.

Port of ``tubelet_transformer_tpu/train/postprocess.py``.
"""

from __future__ import annotations

import torch

from tubelet_transformer_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy


def _scaled_xyxy(boxes: torch.Tensor, target_sizes: torch.Tensor
                 ) -> torch.Tensor:
    """Normalised cxcywh (B,Q,4) -> absolute xyxy for (B,2) [h, w] sizes."""
    h, w = target_sizes[:, 0], target_sizes[:, 1]
    scale = torch.stack([w, h, w, h], dim=-1)[:, None, :]
    return box_cxcywh_to_xyxy(boxes) * scale


def postprocess_ava(outputs: dict, target_sizes: torch.Tensor,
                    binary_gate: float = 0.8):
    """AVA: scores (B,Q,C) = sigmoid(action logits) * P(actor), zero where
    P(actor) <= ``binary_gate``; boxes (B,Q,4) absolute xyxy; P(actor)
    (B,Q,1)."""
    prob_binary = outputs["pred_logits_b"].softmax(dim=-1)[..., 1:2]
    prob_gated = torch.where(prob_binary > binary_gate, prob_binary, 0.0)
    scores = torch.sigmoid(outputs["pred_logits"]) * prob_gated
    return (scores, _scaled_xyxy(outputs["pred_boxes"], target_sizes),
            prob_binary)


def postprocess_softmax(outputs: dict, target_sizes: torch.Tensor):
    """JHMDB/UCF: softmax class scores, absolute xyxy boxes and the
    clip-level visibility probability."""
    scores = outputs["pred_logits"].softmax(dim=-1)
    binary = outputs["pred_logits_b"].softmax(dim=-1)[..., 1:]
    return (scores, _scaled_xyxy(outputs["pred_boxes"], target_sizes),
            binary)
