"""Transformer building blocks, batch-first, eval mode.

Port of ``tubelet_transformer_tpu/models/layers.py``. Parameter names and
layouts are those of torch ``nn.MultiheadAttention`` and of the reference's
modules (``in_proj_weight`` (3E, E), ``out_proj``, ``linear1``, ``norm1``...),
so that ``train.torch_convert`` state dicts load with ``strict=True``.

Numerics follow the JAX layers: attention scores and the softmax are float32
whatever the compute dtype, padded keys get ``finfo(float32).min / 2``
rather than -inf (a fully padded row stays finite), and every LayerNorm has
flax's epsilon of 1e-6. Dropout is never active on this path, so it has no
modules here; training is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6                                   # flax nn.LayerNorm default
NEG = torch.finfo(torch.float32).min / 2.0      # additive -inf substitute


def layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class MultiHeadAttention(nn.Module):
    """Multi-head attention over (B, S, E) tensors.

    Projections sharing an input run as one matmul: pass the same tensor
    object for q and k (self-attention) or for k and v (cross-attention)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """q (B,Sq,E), k/v (B,Sk,E); key_padding_mask (B,Sk), True = pad."""
        e = q.shape[-1]
        w, b3 = self.in_proj_weight, self.in_proj_bias
        if q is k and k is v:
            qp, kp, vp = F.linear(q, w, b3).chunk(3, dim=-1)
        elif q is k:
            qp, kp = F.linear(q, w[:2 * e], b3[:2 * e]).chunk(2, dim=-1)
            vp = F.linear(v, w[2 * e:], b3[2 * e:])
        elif k is v:
            qp = F.linear(q, w[:e], b3[:e])
            kp, vp = F.linear(k, w[e:], b3[e:]).chunk(2, dim=-1)
        else:
            qp = F.linear(q, w[:e], b3[:e])
            kp = F.linear(k, w[e:2 * e], b3[e:2 * e])
            vp = F.linear(v, w[2 * e:], b3[2 * e:])

        b, sq, _ = qp.shape
        sk = kp.shape[1]
        h = self.num_heads
        d = e // h
        qp = qp.reshape(b, sq, h, d) * (float(d) ** -0.5)
        scores = torch.einsum("bqhd,bkhd->bhqk", qp.float(),
                              kp.reshape(b, sk, h, d).float())
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        NEG)
        attn = scores.softmax(dim=-1).to(vp.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vp.reshape(b, sk, h, d))
        return self.out_proj(out.reshape(b, sq, e))


class MLP(nn.Module):
    """Linear+ReLU layers ending in a plain Linear."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o)
                                    for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


def _add_pos(x: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
    return x if pos is None else x + pos


class EncoderLayer(nn.Module):
    """DETR post-norm encoder layer."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)

    def forward(self, src: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        qk = _add_pos(src, pos)
        src = self.norm1(src + self.self_attn(qk, qk, src, key_padding_mask))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DecoderLayer(nn.Module):
    """DETR post-norm decoder layer: query self-attention, cross-attention
    over the memory, FFN."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.multihead_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.norm3 = layer_norm(d_model)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                memory_key_padding_mask: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                query_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        qk = _add_pos(tgt, query_pos)
        tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(
            _add_pos(tgt, query_pos), _add_pos(memory, pos), memory,
            memory_key_padding_mask))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class FactorizedSTEncoderLayer(nn.Module):
    """Factorised space/time encoder layer over (B, T, HW, E) tokens.

    As in the reference, ``self_attn_t`` attends over SPACE (within each
    frame) and ``self_attn_s`` over TIME (at each location)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048):
        super().__init__()
        self.self_attn_t = MultiHeadAttention(d_model, nhead)
        self.self_attn_s = MultiHeadAttention(d_model, nhead)
        self.norm1_t = layer_norm(d_model)
        self.norm1_s = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.linear1 = nn.Linear(2 * d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, src: torch.Tensor) -> torch.Tensor:
        b, t, hw, e = src.shape
        xs = src.reshape(b * t, hw, e)
        xs = self.norm1_t(xs + self.self_attn_t(xs, xs, xs))
        xt = src.transpose(1, 2).reshape(b * hw, t, e)
        xt = self.norm1_s(xt + self.self_attn_s(xt, xt, xt))
        cat = torch.cat([xs.reshape(b, t, hw, e),
                         xt.reshape(b, hw, t, e).transpose(1, 2)], dim=-1)
        return self.norm2(src + self.linear2(F.relu(self.linear1(cat))))


class LSTRDecoderLayer(nn.Module):
    """LSTR decoder layer of the learned temporal pooling."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.multihead_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.norm3 = layer_norm(d_model)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        tgt = self.norm1(tgt + self.self_attn(tgt, tgt, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt, memory, memory))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class LayerStack(nn.Module):
    """``layers`` (+ an optional final ``norm``): the reference's container
    naming (``encoder.layers.0``, ``decoder.norm``)."""

    def __init__(self, layers, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm
