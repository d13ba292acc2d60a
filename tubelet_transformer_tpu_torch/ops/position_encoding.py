"""3-D sine/cosine position embedding, channels-last.

Port of ``tubelet_transformer_tpu/ops/position_encoding.py``: channels split
2/8 temporal, 3/8 y, 3/8 x; positions are cumulative sums of valid pixels,
normalised to [0, 2*pi]. Computed in float32, then cast.
"""

from __future__ import annotations

import math

import torch


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    """stack(sin(even), cos(odd)) flattened over the last axis."""
    s = torch.sin(pos[..., 0::2])
    c = torch.cos(pos[..., 1::2])
    return torch.stack([s, c], dim=-1).flatten(-2)


def position_embedding_sine_3d(not_mask: torch.Tensor, d_model: int,
                               temperature: float = 10000.0,
                               normalize: bool = True,
                               scale: float | None = None,
                               dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """(B, T, H, W) validity (True on valid pixels) -> (B, T, H, W, d_model)."""
    if d_model % 8 != 0:
        raise ValueError(f"d_model must be divisible by 8, got {d_model}")
    n_t = d_model // 8 * 2
    n_s = d_model // 8 * 3
    if scale is None:
        scale = 2.0 * math.pi

    nm = not_mask.to(torch.float32)
    t_embed = torch.cumsum(nm, dim=1)
    y_embed = torch.cumsum(nm, dim=2)
    x_embed = torch.cumsum(nm, dim=3)
    if normalize:
        eps = 1e-6
        t_embed = t_embed / (t_embed[:, -1:, :, :] + eps) * scale
        y_embed = y_embed / (y_embed[:, :, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, :, -1:] + eps) * scale

    dev = not_mask.device
    dim_t = torch.arange(n_t, dtype=torch.float32, device=dev)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / n_t)
    dim_s = torch.arange(n_s, dtype=torch.float32, device=dev)
    dim_s = temperature ** (2.0 * torch.floor(dim_s / 2.0) / n_s)

    pos_t = _interleave_sin_cos(t_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_s)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_s)
    return torch.cat([pos_t, pos_y, pos_x], dim=-1).to(dtype)
