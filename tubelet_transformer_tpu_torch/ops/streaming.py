"""Streaming multi-head attention with a rolling KV cache.

Port of ``tubelet_transformer_tpu/ops/streaming.py``: the LSTR-style
incremental inference of the reference's ``online_inference``
(models/transformer/transformer_layers.py:121-304). Each step the oldest
memory token leaves the window and one new token enters. The cache holds:

* the projected queries, pre-scaled by ``head_dim**-0.5`` (fixed);
* content keys and values projected WITHOUT bias, rolled left each step;
* positional keys and values projected WITH bias (fixed window slots).

Attention runs over ``k + k_pos`` and reads ``v + v_pos``, so the position
embeddings stay with the window slots while the content slides through.
Scores and the softmax are float32.

The functions take the port's ``MultiHeadAttention`` (``models/layers.py``,
e.g. the cross-attention ``multihead_attn`` of ``LSTRDecoderLayer``), whose
packed projection is torch's ``in_proj_weight`` (3E, E) with q, k and v in
that order along the rows; the JAX functions take the flax ``in_proj``
(E, 3E). The state is an explicit ``NamedTuple`` of tensors, not mutation
inside the module: O(W) work per step instead of projecting the whole
window again.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from tubelet_transformer_tpu_torch.models.csn import cast


class StreamingState(NamedTuple):
    q: torch.Tensor        # (B, Q, E) projected, scaled queries (fixed)
    k: torch.Tensor        # (B, W, E) content keys (no bias), rolling
    v: torch.Tensor        # (B, W, E) content values (no bias), rolling
    k_pos: torch.Tensor    # (B, W, E) positional keys (with bias), fixed
    v_pos: torch.Tensor    # (B, W, E) positional values (with bias), fixed


def _proj(attn, x: torch.Tensor, i: int, bias: bool) -> torch.Tensor:
    """x through the i-th (0 q, 1 k, 2 v) block of the packed projection."""
    e = attn.in_proj_weight.shape[1]
    w = cast(attn.in_proj_weight[i * e:(i + 1) * e], x)
    b = cast(attn.in_proj_bias[i * e:(i + 1) * e], x) if bias else None
    return F.linear(x, w, b)


def streaming_init(attn, queries: torch.Tensor, memory: torch.Tensor,
                   pos: torch.Tensor) -> StreamingState:
    """The initial window state: queries (B, Q, E), memory (B, W, E) the
    window's content, pos (B, W, E) its position embeddings."""
    head_dim = queries.shape[-1] // attn.num_heads
    return StreamingState(
        q=_proj(attn, queries, 0, True) * (float(head_dim) ** -0.5),
        k=_proj(attn, memory, 1, False),      # content: NO bias (ref :234)
        v=_proj(attn, memory, 2, False),      # content: NO bias (ref :268)
        k_pos=_proj(attn, pos, 1, True),      # positional: bias (ref :246)
        v_pos=_proj(attn, pos, 2, True))      # positional: bias (ref :269)


def streaming_attend(attn, state: StreamingState) -> torch.Tensor:
    """Attend over the current window -> (B, Q, E)."""
    b, qn, e = state.q.shape
    w = state.k.shape[1]
    h = attn.num_heads
    d = e // h
    qh = state.q.reshape(b, qn, h, d)
    kh = (state.k + state.k_pos).reshape(b, w, h, d)
    vh = (state.v + state.v_pos).reshape(b, w, h, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    probs = scores.softmax(dim=-1).to(vh.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
    return attn.out_proj(out.reshape(b, qn, e))


def streaming_step(attn, state: StreamingState, new_token: torch.Tensor
                   ) -> Tuple[torch.Tensor, StreamingState]:
    """Advance the window by one token and attend: new_token (B, 1, E)
    enters at the window's end and the oldest content leaves (the
    reference's cat((cached[1:], new)), :234-237). Returns
    (the attention output (B, Q, E), the new state)."""
    state = state._replace(
        k=torch.cat([state.k[:, 1:], _proj(attn, new_token, 1, False)], 1),
        v=torch.cat([state.v[:, 1:], _proj(attn, new_token, 2, False)], 1))
    return streaming_attend(attn, state), state
