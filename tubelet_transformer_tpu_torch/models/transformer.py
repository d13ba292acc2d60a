"""DETR-style encoder-decoder over spatio-temporal tokens, batch-first.

Port of ``tubelet_transformer_tpu/models/transformer.py`` (the sequential
encoder): the decoder returns the normed state after every layer, stacked
as (L, B, Q, E). With ``normalize_before`` the layers are pre-norm and the
encoder's output is normed (``encoder.norm``, the JAX ``encoder_norm``);
the decoder's norm is there in both cases. With ``moe_experts > 0`` every
encoder layer's FFN is a Mixture of Experts.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tubelet_transformer_tpu_torch.models.layers import (
    DecoderLayer, EncoderLayer, LayerStack, layer_norm)


class Transformer(nn.Module):

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.0,
                 normalize_before: bool = False, moe_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25):
        super().__init__()
        self.encoder = LayerStack(
            (EncoderLayer(d_model, nhead, dim_feedforward, dropout,
                          normalize_before, moe_experts, moe_top_k,
                          moe_capacity_factor)
             for _ in range(num_encoder_layers)),
            norm=layer_norm(d_model) if normalize_before else None)
        self.decoder = LayerStack(
            (DecoderLayer(d_model, nhead, dim_feedforward, dropout,
                          normalize_before)
             for _ in range(num_decoder_layers)), norm=layer_norm(d_model))

    def forward(self, src: torch.Tensor, mask: Optional[torch.Tensor],
                query_embed: torch.Tensor, pos_embed: torch.Tensor,
                moe_aux: Optional[list] = None,
                moe_reduce=None) -> torch.Tensor:
        """src/pos_embed (B,S,E), mask (B,S) True = pad, query_embed (Q,E)
        -> (L,B,Q,E). Each MoE encoder layer appends its load-balance loss
        to ``moe_aux`` when one is given, its counts summed by
        ``moe_reduce`` (``MoEFFN.forward``'s ``reduce``)."""
        memory = src
        for layer in self.encoder.layers:
            memory = layer(memory, key_padding_mask=mask, pos=pos_embed,
                           moe_aux=moe_aux, moe_reduce=moe_reduce)
        if self.encoder.norm is not None:
            memory = self.encoder.norm(memory)
        b = src.shape[0]
        query_pos = query_embed.to(src.dtype)[None].expand(b, -1, -1)
        out = torch.zeros_like(query_pos)
        intermediate = []
        for layer in self.decoder.layers:
            out = layer(out, memory, memory_key_padding_mask=mask,
                        pos=pos_embed, query_pos=query_pos)
            intermediate.append(self.decoder.norm(out))
        return torch.stack(intermediate)
