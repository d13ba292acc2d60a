"""Transformer building blocks, batch-first.

Port of ``tubelet_transformer_tpu/models/layers.py``. Parameter names and
layouts are those of torch ``nn.MultiheadAttention`` and of the reference's
modules (``in_proj_weight`` (3E, E), ``out_proj``, ``linear1``, ``norm1``...),
so that ``train.torch_convert`` state dicts load with ``strict=True``.

Numerics follow the JAX layers: in eval mode attention scores and the
softmax are float32 whatever the compute dtype; in train mode scores and
probabilities are in the compute dtype while the softmax reduces in float32
(layers.py:107-126 of the JAX package). Padded keys get
``finfo(float32).min / 2`` rather than -inf (a fully padded row stays
finite), and every LayerNorm has flax's epsilon of 1e-6. Weights are cast to
the input's dtype at use. Dropout sits where the JAX layers put it and
draws its masks from an explicit ``torch.Generator`` (``Dropout.generator``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tubelet_transformer_tpu_torch.models.csn import cast

LN_EPS = 1e-6                                   # flax nn.LayerNorm default
NEG = torch.finfo(torch.float32).min / 2.0      # additive -inf substitute


class Linear(nn.Linear):
    """``nn.Linear`` with its weights cast to the input's dtype at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, cast(self.weight, x), cast(self.bias, x))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with its weights cast to the input's dtype at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, cast(self.weight, x),
                            cast(self.bias, x), self.eps)


def layer_norm(d: int) -> LayerNorm:
    return LayerNorm(d, eps=LN_EPS)


class Dropout(nn.Module):
    """flax's dropout: in training, zero each element with probability
    ``p`` and scale the rest by 1/(1-p); the mask comes from ``generator``
    (one on the input's device; torch's default generator when None)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Multi-head attention over (B, S, E) tensors.

    Projections sharing an input run as one matmul: pass the same tensor
    object for q and k (self-attention) or for k and v (cross-attention)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        self.dropout = Dropout(dropout)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """q (B,Sq,E), k/v (B,Sk,E); key_padding_mask (B,Sk), True = pad."""
        e = q.shape[-1]
        w, b3 = cast(self.in_proj_weight, q), cast(self.in_proj_bias, q)
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
        kp = kp.reshape(b, sk, h, d)
        if not self.training:
            qp, kp = qp.float(), kp.float()
        scores = torch.einsum("bqhd,bkhd->bhqk", qp, kp)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        NEG)
        # torch's softmax reduces in float32 for a bfloat16 input
        attn = self.dropout(scores.softmax(dim=-1)).to(vp.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vp.reshape(b, sk, h, d))
        return self.out_proj(out.reshape(b, sq, e))


class MLP(nn.Module):
    """Linear+ReLU layers ending in a plain Linear."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(i, o)
                                    for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


def _add_pos(x: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
    return x if pos is None else x + pos


class EncoderLayer(nn.Module):
    """DETR encoder layer, post-norm or, with ``normalize_before``, pre-norm
    (layers.py:216-222 of the JAX package). ``moe_experts > 0`` swaps the
    dense FFN for ``MoEFFN`` (``moe_ffn``), whose load-balance loss is
    appended to the ``moe_aux`` list the caller passes."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.0, normalize_before: bool = False,
                 moe_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        if moe_experts > 0:
            from tubelet_transformer_tpu_torch.models.moe import MoEFFN

            self.moe_ffn = MoEFFN(d_model, dim_feedforward, moe_experts,
                                  moe_top_k, moe_capacity_factor, dropout)
        else:
            self.moe_ffn = None
            self.linear1 = Linear(d_model, dim_feedforward)
            self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.dropout = Dropout(dropout)

    def _ffn(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor],
             moe_aux: Optional[list]) -> torch.Tensor:
        if self.moe_ffn is None:
            return self.linear2(self.dropout(F.relu(self.linear1(x))))
        # padded tokens must not take expert capacity
        y, aux = self.moe_ffn(x, pad_mask=key_padding_mask)
        if moe_aux is not None:
            moe_aux.append(aux)
        return y

    def forward(self, src: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                moe_aux: Optional[list] = None) -> torch.Tensor:
        drop = self.dropout
        if self.normalize_before:
            s2 = self.norm1(src)
            qk = _add_pos(s2, pos)
            src = src + drop(self.self_attn(qk, qk, s2, key_padding_mask))
            return src + drop(self._ffn(self.norm2(src), key_padding_mask,
                                        moe_aux))
        qk = _add_pos(src, pos)
        src = self.norm1(src + drop(self.self_attn(qk, qk, src,
                                                   key_padding_mask)))
        return self.norm2(src + drop(self._ffn(src, key_padding_mask,
                                               moe_aux)))


class DecoderLayer(nn.Module):
    """DETR decoder layer: query self-attention, cross-attention over the
    memory, FFN; post-norm or, with ``normalize_before``, pre-norm
    (layers.py:271-281 of the JAX package)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.0, normalize_before: bool = False):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.multihead_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.norm3 = layer_norm(d_model)
        self.dropout = Dropout(dropout)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                memory_key_padding_mask: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                query_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        drop = self.dropout

        def ffn(x):
            return self.linear2(drop(F.relu(self.linear1(x))))

        if self.normalize_before:
            t2 = self.norm1(tgt)
            qk = _add_pos(t2, query_pos)
            tgt = tgt + drop(self.self_attn(qk, qk, t2))
            t2 = self.norm2(tgt)
            tgt = tgt + drop(self.multihead_attn(
                _add_pos(t2, query_pos), _add_pos(memory, pos), memory,
                memory_key_padding_mask))
            return tgt + drop(ffn(self.norm3(tgt)))
        qk = _add_pos(tgt, query_pos)
        tgt = self.norm1(tgt + drop(self.self_attn(qk, qk, tgt)))
        tgt = self.norm2(tgt + drop(self.multihead_attn(
            _add_pos(tgt, query_pos), _add_pos(memory, pos), memory,
            memory_key_padding_mask)))
        return self.norm3(tgt + drop(ffn(tgt)))


class FactorizedSTEncoderLayer(nn.Module):
    """Factorised space/time encoder layer over (B, T, HW, E) tokens.

    As in the reference, ``self_attn_t`` attends over SPACE (within each
    frame) and ``self_attn_s`` over TIME (at each location)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.0):
        super().__init__()
        self.self_attn_t = MultiHeadAttention(d_model, nhead, dropout)
        self.self_attn_s = MultiHeadAttention(d_model, nhead, dropout)
        self.norm1_t = layer_norm(d_model)
        self.norm1_s = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.linear1 = Linear(2 * d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.dropout = Dropout(dropout)

    def forward(self, src: torch.Tensor) -> torch.Tensor:
        drop = self.dropout
        b, t, hw, e = src.shape
        xs = src.reshape(b * t, hw, e)
        xs = self.norm1_t(xs + drop(self.self_attn_t(xs, xs, xs)))
        xt = src.transpose(1, 2).reshape(b * hw, t, e)
        xt = self.norm1_s(xt + drop(self.self_attn_s(xt, xt, xt)))
        cat = torch.cat([xs.reshape(b, t, hw, e),
                         xt.reshape(b, hw, t, e).transpose(1, 2)], dim=-1)
        return self.norm2(src + drop(self.linear2(drop(F.relu(
            self.linear1(cat))))))


class LSTRDecoderLayer(nn.Module):
    """LSTR decoder layer of the learned temporal pooling."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.multihead_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.norm3 = layer_norm(d_model)
        self.dropout = Dropout(dropout)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        drop = self.dropout
        tgt = self.norm1(tgt + drop(self.self_attn(tgt, tgt, tgt)))
        tgt = self.norm2(tgt + drop(self.multihead_attn(tgt, memory, memory)))
        return self.norm3(tgt + drop(self.linear2(drop(F.relu(
            self.linear1(tgt))))))


class LayerStack(nn.Module):
    """``layers`` (+ an optional final ``norm``): the reference's container
    naming (``encoder.layers.0``, ``decoder.norm``)."""

    def __init__(self, layers, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm
