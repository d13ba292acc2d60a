"""Segmentation heads and mask losses (the DETR panoptic surface), NCHW.

Port of ``tubelet_transformer_tpu/models/segmentation.py``, the
counterparts of the reference's ``models/detr/segmentation.py``:

* ``dice_loss`` / ``sigmoid_focal_loss`` (reference :172-215), float32,
  with an optional ``valid`` row mask: padded rows contribute 0.
* ``loss_masks``: the padded mask criterion (reference
  criterion.py:119-147); the predictions are resized to the targets'
  size by ``F.interpolate(mode="bilinear", align_corners=False)``, which
  is the JAX package's ``jax.image.resize(method="linear",
  antialias=False)`` both up and down.
* ``MHAttentionMap`` (reference :140-169): per-head query/feature attention
  maps, the softmax over the flattened (heads, H, W) axis in float32,
  padded pixels at the finite ``NEG``, not -inf.
* ``MaskHeadSmallConv`` (reference :69-137): the FPN-style conv head. The
  memory is repeated per query (``repeat_interleave``: row b*Q + q is batch
  b) and concatenated with the attention maps, in that channel order; the
  FPN merge upsamples with the port's ``nearest_resize_mask``; each
  ``GroupNorm(8)`` is flax's: the variance ``E[x^2] - E[x]^2`` from
  float32 means, clamped at 0, epsilon 1e-5.
* ``postprocess_masks``: the used core of ``PostProcessSegm`` (reference
  :218-238), bilinear upsample and sigmoid threshold.

Module names are the reference's (``q_linear``, ``k_linear``,
``lay1..lay5``, ``gn1..gn5``, ``adapter1..3``, ``out_lay``), so the weight
bridge (``convert.load_mh_attention_map`` / ``convert.load_mask_head``) is
a key map. Weights are cast to the input's dtype at use, as in the rest of
the port.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tubelet_transformer_tpu_torch.models.csn import cast
from tubelet_transformer_tpu_torch.models.layers import NEG, Linear
from tubelet_transformer_tpu_torch.models.tuber import (
    _lecun_normal_, nearest_resize_mask)

GN_EPS = 1e-5       # the JAX module's GroupNorm epsilon (segmentation.py:182)


# ---------------------------------------------------------------------------
# Losses (reference segmentation.py:172-215)
# ---------------------------------------------------------------------------

def dice_loss(inputs: torch.Tensor, targets: torch.Tensor, num_boxes,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DICE loss over per-row binary masks: inputs (N, ...) logits, targets
    the same shape in {0, 1}, valid an optional (N,) row mask."""
    probs = inputs.float().sigmoid().flatten(1)
    tgt = targets.float().flatten(1)
    numerator = 2.0 * (probs * tgt).sum(1)
    denominator = probs.sum(-1) + tgt.sum(-1)
    loss = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    if valid is not None:
        loss = loss * valid.to(loss.dtype)
    return loss.sum() / num_boxes


def sigmoid_focal_loss(inputs: torch.Tensor, targets: torch.Tensor,
                       num_boxes, alpha: float = 0.25, gamma: float = 2.0,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RetinaNet focal loss: the mean over each row's pixels, summed over
    the rows and divided by ``num_boxes``."""
    x = inputs.float().flatten(1)
    t = targets.float().flatten(1)
    prob = x.sigmoid()
    # binary cross-entropy with logits, elementwise, in the stable form
    ce = x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))
    p_t = prob * t + (1.0 - prob) * (1.0 - t)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * t + (1.0 - alpha) * (1.0 - t)) * loss
    loss = loss.mean(1)
    if valid is not None:
        loss = loss * valid.to(loss.dtype)
    return loss.sum() / num_boxes


def _bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(N, C, h, w) -> (N, C, *size), float32, half-pixel centres."""
    return F.interpolate(x.float(), size=tuple(int(s) for s in size),
                         mode="bilinear", align_corners=False,
                         antialias=False)


def loss_masks(pred_masks: torch.Tensor, target_masks: torch.Tensor,
               row_valid: torch.Tensor, num_boxes) -> dict:
    """pred_masks (N, h, w) logits of the matched rows, target_masks
    (N, H, W), row_valid (N,) with False on padding rows."""
    src = _bilinear(pred_masks[:, None], target_masks.shape[1:])[:, 0]
    return {
        "loss_mask": sigmoid_focal_loss(src, target_masks, num_boxes,
                                        valid=row_valid),
        "loss_dice": dice_loss(src, target_masks, num_boxes,
                               valid=row_valid),
    }


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with its weights cast to the input's dtype at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, cast(self.weight, x),
                                  cast(self.bias, x))


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm`` on NCHW: per (sample, group) ``E[x]`` and
    ``max(E[x^2] - E[x]^2, 0)`` from float32 means, then
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32, rounded
    once to x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = self.num_groups
        acc = torch.promote_types(x.dtype, torch.float32)
        xg = x.to(acc).reshape(n, g, c // g, -1)
        mean = xg.mean((2, 3), keepdim=True)
        var = (xg.square().mean((2, 3), keepdim=True)
               - mean.square()).clamp_min(0.0)
        affine = (1, g, c // g, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(acc).reshape(affine)
        y = (xg - mean) * mul + self.bias.to(acc).reshape(affine)
        return y.reshape(x.shape).to(x.dtype)


class MHAttentionMap(nn.Module):
    """Per-head 2-D attention maps: q (B, Q, E) against the feature map k
    (B, E, H, W) -> (B, Q, heads, H, W) softmax weights. ``k_linear`` is the
    reference's 1x1 conv, a matmul over the channel axis; the softmax runs
    over the flattened (heads, H, W) axis (the reference flattens from
    dim 2), in float32."""

    def __init__(self, query_dim: int, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.hidden_dim = hidden_dim
        self.q_linear = Linear(query_dim, hidden_dim)
        self.k_linear = Linear(query_dim, hidden_dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask (B, H, W), True = padding."""
        bq, qn, _ = q.shape
        _, _, h, w = k.shape
        nh = self.num_heads
        hd = self.hidden_dim // nh
        qp = self.q_linear(q).reshape(bq, qn, nh, hd)
        kp = self.k_linear(k.permute(0, 2, 3, 1)).reshape(bq, h, w, nh, hd)
        weights = torch.einsum("bqnc,bhwnc->bqnhw", qp * (float(hd) ** -0.5),
                               kp).float()
        if mask is not None:
            weights = weights.masked_fill(mask[:, None, None], NEG)
        flat = weights.reshape(bq, qn, -1).softmax(dim=-1)
        return flat.reshape(bq, qn, nh, h, w).to(q.dtype)


class MaskHeadSmallConv(nn.Module):
    """The FPN-style mask head. ``dim`` is hidden_dim + num_heads (the
    memory and the attention maps, concatenated); ``fpn_dims`` the channels
    of the three backbone levels, coarse to fine; ``context_dim`` the
    transformer's width."""

    def __init__(self, dim: int, fpn_dims: Sequence[int], context_dim: int):
        super().__init__()
        if len(fpn_dims) != 3:
            raise ValueError(f"MaskHeadSmallConv expects exactly 3 FPN "
                             f"levels, got {len(fpn_dims)} dims")
        cd = context_dim
        inter = [dim, cd // 2, cd // 4, cd // 8, cd // 16, cd // 64]
        ins = [dim, dim, *inter[1:4]]
        outs = [dim, *inter[1:5]]
        for i, (ci, co) in enumerate(zip(ins, outs), start=1):
            self.add_module(f"lay{i}", Conv2d(ci, co, 3, padding=1))
            self.add_module(f"gn{i}", GroupNorm(8, co, eps=GN_EPS))
        self.out_lay = Conv2d(inter[4], 1, 3, padding=1)
        for i, fd in enumerate(fpn_dims, start=1):
            self.add_module(f"adapter{i}", Conv2d(fd, inter[i], 1))

    def forward(self, x: torch.Tensor, bbox_mask: torch.Tensor,
                fpns: Sequence[torch.Tensor]) -> torch.Tensor:
        """x (B, context_dim, H, W); bbox_mask (B, Q, heads, H, W); fpns
        coarse to fine, (B, Ci, Hi, Wi). Returns (B*Q, 1, H', W') logits."""
        if len(fpns) != 3:
            raise ValueError(f"MaskHeadSmallConv expects exactly 3 FPN "
                             f"levels, got {len(fpns)} features")
        b, q, nh, h, w = bbox_mask.shape
        # the memory repeated per query (row b*Q + q), then the maps
        x = torch.cat([x.repeat_interleave(q, dim=0),
                       bbox_mask.to(x.dtype).reshape(b * q, nh, h, w)], 1)
        x = F.relu(self.gn1(self.lay1(x)))
        x = F.relu(self.gn2(self.lay2(x)))
        for i, fpn in enumerate(fpns, start=1):
            cur = getattr(self, f"adapter{i}")(fpn.to(x.dtype))
            if cur.shape[0] != x.shape[0]:
                cur = cur.repeat_interleave(x.shape[0] // cur.shape[0], 0)
            up = nearest_resize_mask(x.permute(0, 2, 3, 1), cur.shape[2],
                                     cur.shape[3]).permute(0, 3, 1, 2)
            x = cur + up
            x = F.relu(getattr(self, f"gn{i + 2}")(
                getattr(self, f"lay{i + 2}")(x)))
        return self.out_lay(x)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn like flax's defaults: LeCun normal for the
    dense layers and convs with zero biases, identity GroupNorms."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.reset_parameters()


# ---------------------------------------------------------------------------
# Postprocess (the used core of PostProcessSegm, segmentation.py:218-238)
# ---------------------------------------------------------------------------

def postprocess_masks(pred_masks: torch.Tensor, size,
                      threshold: float = 0.5) -> torch.Tensor:
    """(B, Q, h, w) logits -> (B, Q, H, W) booleans at the padded canvas
    size: bilinear upsample (half-pixel centres), sigmoid, threshold. The
    per-image crop and resize to the original resolution stay with the
    caller, on the host, as in the reference."""
    return _bilinear(pred_masks, size).sigmoid() > threshold
