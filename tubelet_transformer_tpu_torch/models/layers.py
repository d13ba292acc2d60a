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

Tensor parallelism (``MESH.MODEL``, ``parallel/sharding_rules.py``): a
module whose ``tp`` is a ``parallel.mesh.Mesh`` holds this model peer's
slice of its split weights. An attention whose heads the axis divides
then attends over its local heads and an FFN computes its local hidden
columns: the replicated inputs enter through ``Mesh.copy_to_model``, the
row-parallel output leaves through ``Mesh.reduce_from_model`` and its
replicated bias is added once, after the sum; the replicated
``in_proj_bias`` and ``linear1`` bias pass through ``copy_to_model``
before they are sliced, so that their gradients are summed over the
peers. An attention whose heads it does not divide holds a contiguous
block of the packed q/k/v rows instead (q, k and v themselves at 3
peers): each peer projects its block, the peers' blocks are gathered
(``Mesh.gather_from_model``), and every peer attends over all heads;
``out_proj`` then runs on this peer's columns of the result
(``Mesh.scatter_to_model``) and its rows of the weight, summed by
``reduce_from_model``, where the axis divides the width, and whole
otherwise. Dropout in a split region draws the full one-process mask and
keeps the local part, so every peer draws alike and the masks are the
one-process step's.
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

    def forward(self, x: torch.Tensor,
                shard: Optional[tuple[int, int, int]] = None
                ) -> torch.Tensor:
        """``shard`` (dim, n, i): ``x`` is part i of n along dim of the
        tensor whose mask is drawn (tensor parallelism)."""
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        shape = list(x.shape)
        if shard is not None:
            dim, n, i = shard
            shape[dim] *= n
        u = torch.rand(shape, generator=self.generator, device=x.device)
        if shard is not None:
            u = u.narrow(dim, i * x.shape[dim], x.shape[dim])
        return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


def _model_axis(tp) -> tuple[int, int]:
    """(peers, this peer's index) of a module's 'model' axis."""
    return (1, 0) if tp is None else (tp.model, tp.model_index)


def _enter(tp, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k and v entering a split attention, each distinct tensor once,
    so that shared inputs stay shared."""
    qq = tp.copy_to_model(q)
    kk = qq if k is q else tp.copy_to_model(k)
    vv = kk if v is k else (qq if v is q else tp.copy_to_model(v))
    return qq, kk, vv


class MultiHeadAttention(nn.Module):
    """Multi-head attention over (B, S, E) tensors.

    Projections sharing an input run as one matmul: pass the same tensor
    object for q and k (self-attention) or for k and v (cross-attention).
    With ``tp`` set, ``in_proj_weight`` holds the q, k and v rows of this
    peer's heads and ``out_proj.weight`` their columns, or, where the
    peers do not divide the heads, this peer's block of the packed rows
    (``Split(0)``, ``_forward_rows``)."""

    tp = None

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
        tp = self.tp
        if tp is not None and self.in_proj_weight.tp_split.groups == 1:
            return self._forward_rows(q, k, v, key_padding_mask, tp)
        n, i = _model_axis(tp)
        # the width of the heads this peer attends over
        e = self.in_proj_weight.shape[0] // 3
        b3 = self.in_proj_bias
        if tp is not None:
            q, k, v = _enter(tp, q, k, v)
            b3 = torch.cat([c.chunk(n)[i] for c in
                            tp.copy_to_model(b3).chunk(3)])
        w, b3 = cast(self.in_proj_weight, q), cast(b3, q)
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

        out = self._attend(qp, kp, vp, self.num_heads // n, key_padding_mask,
                           None if tp is None else (1, n, i))
        if tp is None:
            return self.out_proj(out)
        return self._row_parallel_out(out, tp)

    def _attend(self, qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                h: int, key_padding_mask: Optional[torch.Tensor],
                shard: Optional[tuple]) -> torch.Tensor:
        """Scaled dot-product attention of the projected (B,S,h*d) q, k and
        v over ``h`` heads; dropout's mask is part ``shard`` of the
        one-process mask."""
        b, sq, e = qp.shape
        sk = kp.shape[1]
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
        attn = self.dropout(scores.softmax(dim=-1), shard).to(vp.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vp.reshape(b, sk, h, d))
        return out.reshape(b, sq, e)

    def _row_parallel_out(self, out: torch.Tensor, tp) -> torch.Tensor:
        """``out_proj`` of this peer's columns ``out`` with its rows of the
        weight, summed over the peers ("g"), its bias added once."""
        return (tp.reduce_from_model(F.linear(
            out, cast(self.out_proj.weight, out)))
            + cast(self.out_proj.bias, out))

    def _forward_rows(self, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor,
                      key_padding_mask: Optional[torch.Tensor], tp
                      ) -> torch.Tensor:
        """The attention with this peer's contiguous block of the packed
        q/k/v rows (the JAX package's split where the peers do not divide
        the heads): each distinct input projects through the block's rows
        that it feeds (one matmul each; a block may straddle q, k and v,
        so its output is cut by global row), the peers' columns are
        gathered for the inputs of one shape at a time, and every peer
        attends over all heads, dropout drawing the one-process mask."""
        n, i = tp.model, tp.model_index
        e = self.in_proj_weight.shape[1]
        r = 3 * e // n
        a = i * r
        q, k, v = _enter(tp, q, k, v)
        w = cast(self.in_proj_weight, q)
        b3 = cast(tp.copy_to_model(self.in_proj_bias)[a:a + r], q)
        # each distinct input and the packed rows [lo, hi) it feeds
        if q is k and k is v:
            spans = [(q, 0, 3 * e)]
        elif q is k:
            spans = [(q, 0, 2 * e), (v, 2 * e, 3 * e)]
        elif k is v:
            spans = [(q, 0, e), (k, e, 3 * e)]
        else:
            spans = [(q, 0, e), (k, e, 2 * e), (v, 2 * e, 3 * e)]
        # consecutive inputs of one shape share one gather
        groups: list = []
        for x, lo, hi in spans:
            if groups and groups[-1][0][0].shape == x.shape:
                groups[-1].append((x, lo, hi))
            else:
                groups.append([(x, lo, hi)])
        packed = []
        for group in groups:
            lo, hi = group[0][1], group[-1][2]
            local = []
            for x, x_lo, x_hi in group:
                # this peer's rows of x's span; none where its block holds
                # no row of it, the empty matmul keeping x on the graph so
                # that "f"'s backward runs here too
                u = max(x_lo, a)
                t = max(u, min(x_hi, a + r))
                local.append(F.linear(x, w[u - a:t - a], b3[u - a:t - a]))
            widths = [max(0, min(hi, (j + 1) * r) - max(lo, j * r))
                      for j in range(n)]
            packed.append((lo, tp.gather_from_model(torch.cat(local, -1),
                                                    widths)))

        def part(j: int) -> torch.Tensor:
            lo, full = next((lo, t) for lo, t in packed
                            if lo <= j * e < lo + t.shape[-1])
            return full[..., j * e - lo:(j + 1) * e - lo]

        out = self._attend(part(0), part(1), part(2), self.num_heads,
                           key_padding_mask, None)
        if getattr(self.out_proj.weight, "tp_split", None) is None:
            return self.out_proj(out)
        return self._row_parallel_out(tp.scatter_to_model(out), tp)


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


def dense_ffn(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``layer.linear2(dropout(relu(layer.linear1(x))))``; with
    ``layer.tp`` set, over this peer's hidden columns, summed over the
    peers."""
    tp, drop = layer.tp, layer.dropout
    if tp is None:
        return layer.linear2(drop(F.relu(layer.linear1(x))))
    n, i = _model_axis(tp)
    x = tp.copy_to_model(x)
    b1 = tp.copy_to_model(layer.linear1.bias).chunk(n)[i]
    hidden = drop(F.relu(F.linear(x, cast(layer.linear1.weight, x),
                                  cast(b1, x))), (-1, n, i))
    return (tp.reduce_from_model(F.linear(
        hidden, cast(layer.linear2.weight, hidden)))
        + cast(layer.linear2.bias, hidden))


class EncoderLayer(nn.Module):
    """DETR encoder layer, post-norm or, with ``normalize_before``, pre-norm
    (layers.py:216-222 of the JAX package). ``moe_experts > 0`` swaps the
    dense FFN for ``MoEFFN`` (``moe_ffn``), whose load-balance loss is
    appended to the ``moe_aux`` list the caller passes, its counts summed
    by ``moe_reduce`` (over ranks under data parallelism)."""

    tp = None

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
             moe_aux: Optional[list], moe_reduce) -> torch.Tensor:
        if self.moe_ffn is None:
            return dense_ffn(self, x)
        # padded tokens must not take expert capacity
        y, aux = self.moe_ffn(x, pad_mask=key_padding_mask, reduce=moe_reduce)
        if moe_aux is not None:
            moe_aux.append(aux)
        return y

    def forward(self, src: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                moe_aux: Optional[list] = None,
                moe_reduce=None) -> torch.Tensor:
        drop = self.dropout
        if self.normalize_before:
            s2 = self.norm1(src)
            qk = _add_pos(s2, pos)
            src = src + drop(self.self_attn(qk, qk, s2, key_padding_mask))
            return src + drop(self._ffn(self.norm2(src), key_padding_mask,
                                        moe_aux, moe_reduce))
        qk = _add_pos(src, pos)
        src = self.norm1(src + drop(self.self_attn(qk, qk, src,
                                                   key_padding_mask)))
        return self.norm2(src + drop(self._ffn(src, key_padding_mask,
                                               moe_aux, moe_reduce)))


class DecoderLayer(nn.Module):
    """DETR decoder layer: query self-attention, cross-attention over the
    memory, FFN; post-norm or, with ``normalize_before``, pre-norm
    (layers.py:271-281 of the JAX package)."""

    tp = None

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
            return dense_ffn(self, x)

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

    tp = None

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
        return self.norm2(src + drop(dense_ffn(self, cat)))


class LSTRDecoderLayer(nn.Module):
    """LSTR decoder layer of the learned temporal pooling."""

    tp = None

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
        return self.norm3(tgt + drop(dense_ffn(self, tgt)))


class LayerStack(nn.Module):
    """``layers`` (+ an optional final ``norm``): the reference's container
    naming (``encoder.layers.0``, ``decoder.norm``)."""

    def __init__(self, layers, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm
