"""DETR-style encoder-decoder over spatio-temporal tokens, batch-first.

Port of ``tubelet_transformer_tpu/models/transformer.py`` (post-norm, the
sequential encoder): the decoder returns the normed state after every layer,
stacked as (L, B, Q, E).
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
                 dim_feedforward: int = 2048, dropout: float = 0.0):
        super().__init__()
        self.encoder = LayerStack(
            EncoderLayer(d_model, nhead, dim_feedforward, dropout)
            for _ in range(num_encoder_layers))
        self.decoder = LayerStack(
            (DecoderLayer(d_model, nhead, dim_feedforward, dropout)
             for _ in range(num_decoder_layers)), norm=layer_norm(d_model))

    def forward(self, src: torch.Tensor, mask: Optional[torch.Tensor],
                query_embed: torch.Tensor, pos_embed: torch.Tensor
                ) -> torch.Tensor:
        """src/pos_embed (B,S,E), mask (B,S) True = pad, query_embed (Q,E)
        -> (L,B,Q,E)."""
        memory = src
        for layer in self.encoder.layers:
            memory = layer(memory, key_padding_mask=mask, pos=pos_embed)
        b = src.shape[0]
        query_pos = query_embed.to(src.dtype)[None].expand(b, -1, -1)
        out = torch.zeros_like(query_pos)
        intermediate = []
        for layer in self.decoder.layers:
            out = layer(out, memory, memory_key_padding_mask=mask,
                        pos=pos_embed, query_pos=query_pos)
            intermediate.append(self.decoder.norm(out))
        return torch.stack(intermediate)
