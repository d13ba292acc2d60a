"""Mixture-of-Experts FFN for the encoder (``MODEL.MOE_EXPERTS``).

Port of ``tubelet_transformer_tpu/models/moe.py``, in its dense form, so
that the numerics follow the JAX package:

* the router and its softmax in float32 whatever the compute dtype, from a
  float32 router weight (``Router``, which the eval build does not cast);
* top-k slots by repeated argmax (the first index wins a tie in both
  frameworks); the gates are the softmax probabilities, renormalised over
  the kept slots (+1e-9) when k > 1;
* a per-row capacity ``C = min(S, max(1, ceil(S * cf * k / E)))``, the
  positions in each expert's buffer by a cumsum along the sequence, in slot
  order and then sequence order; a token over capacity has a zero combine
  weight, so the encoder's residual passes it through; padded tokens take
  no capacity and no part in the load-balance statistics;
* ``dispatch = (combine > 0)`` in the compute dtype, so a zero gate drops
  its token, as in JAX;
* the expert stacks ``expert_w1`` (E, D, F), ``expert_b1`` (E, F),
  ``expert_w2`` (E, F, D), ``expert_b2`` (E, D), in the JAX layouts;
* the Switch load-balance loss ``E * sum_e f_e * P_e`` over valid tokens,
  returned beside the output (the JAX module sows it into a collection).

The dense (B, S, E, C) dispatch and combine tensors grow as S^2 (C is
proportional to S).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tubelet_transformer_tpu_torch.models.layers import Dropout


class Router(nn.Linear):
    """The bias-free router; float32 logits from a float32 input."""

    def __init__(self, d_model: int, num_experts: int):
        super().__init__(d_model, num_experts, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight.float())


def expert_init_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``variance_scaling(1, "fan_avg", "uniform", batch_axis=0)``
    on an (E, fan_in, fan_out) stack: U(-a, a), a = sqrt(6 / (in + out))."""
    a = math.sqrt(6.0 / (t.shape[1] + t.shape[2]))
    nn.init.uniform_(t, -a, a, generator=generator)


class MoEFFN(nn.Module):
    """(B, S, D) tokens -> (B, S, D), and the load-balance loss."""

    def __init__(self, d_model: int, dim_feedforward: int, num_experts: int,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 dropout: float = 0.0):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} out of range for "
                             f"{num_experts} experts")
        e, d, f = num_experts, d_model, dim_feedforward
        self.num_experts, self.top_k = e, top_k
        self.capacity_factor = capacity_factor
        self.router = Router(d, e)
        self.expert_w1 = nn.Parameter(torch.empty(e, d, f))
        self.expert_b1 = nn.Parameter(torch.zeros(e, f))
        self.expert_w2 = nn.Parameter(torch.empty(e, f, d))
        self.expert_b2 = nn.Parameter(torch.zeros(e, d))
        self.dropout = Dropout(dropout)

    def capacity(self, s: int) -> int:
        """Each expert's buffer per batch row, for ``s`` tokens."""
        return min(s, max(1, math.ceil(
            s * self.capacity_factor * self.top_k / self.num_experts)))

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B,S,D), pad_mask (B,S) True = pad -> (y (B,S,D), aux ())."""
        b, s, _ = x.shape
        e, cap = self.num_experts, self.capacity(s)
        valid = (torch.ones((b, s), device=x.device) if pad_mask is None
                 else 1.0 - pad_mask.float())                     # (B,S)
        probs = self.router(x).softmax(dim=-1)                    # (B,S,E)

        slot_masks, slot_gates = [], []
        remaining = probs
        for _ in range(self.top_k):
            onehot = (F.one_hot(remaining.argmax(dim=-1), e).float()
                      * valid[..., None])                         # (B,S,E)
            slot_masks.append(onehot)
            slot_gates.append((probs * onehot).sum(dim=-1))       # (B,S)
            remaining = remaining * (1.0 - onehot)
        if self.top_k > 1:
            denom = sum(slot_gates) + 1e-9
            slot_gates = [g / denom for g in slot_gates]

        slots = torch.arange(cap, device=x.device)
        combine = torch.zeros((b, s, e, cap), device=x.device)
        taken = torch.zeros((b, 1, e), device=x.device)
        for mask, gate in zip(slot_masks, slot_gates):
            pos = mask.cumsum(dim=1) - mask + taken               # (B,S,E)
            fits = (pos < cap) & (mask > 0)
            # one_hot(pos, cap), zero where the token does not fit
            oh_pos = ((pos.long()[..., None] == slots).float()
                      * fits[..., None].float())                 # (B,S,E,C)
            combine = combine + oh_pos * gate[..., None, None]
            taken = taken + mask.sum(dim=1, keepdim=True)
        dt = x.dtype
        dispatch = (combine > 0.0).to(dt)

        xin = torch.einsum("bsec,bsd->ebcd", dispatch, x)         # (E,B,C,D)
        h = F.relu(torch.einsum("ebcd,edf->ebcf", xin,
                                self.expert_w1.to(dt))
                   + self.expert_b1.to(dt)[:, None, None, :])
        h = self.dropout(h)
        yo = (torch.einsum("ebcf,efd->ebcd", h, self.expert_w2.to(dt))
              + self.expert_b2.to(dt)[:, None, None, :])
        y = torch.einsum("bsec,ebcd->bsd", combine.to(dt), yo)

        n_valid = valid.sum() + 1e-9
        f_e = slot_masks[0].sum(dim=(0, 1)) / n_valid             # (E,)
        p_e = (probs * valid[..., None]).sum(dim=(0, 1)) / n_valid
        return y, e * (f_e * p_e).sum()
