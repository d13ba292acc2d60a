"""On-device photometric preprocessing, eval branch: uint8 clips in,
ImageNet-normalised clips of the compute dtype out.

Port of ``tubelet_transformer_tpu/data/device_preprocess.py`` without the
HSV jitter, which belongs to training (not ported yet).
"""

from __future__ import annotations

from typing import Optional

import torch

from tubelet_transformer_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD


def device_preprocess(clips: torch.Tensor, dtype: torch.dtype = torch.float32,
                      pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 (B,T,H,W,3) -> (x - mean) / std in ``dtype``; the padded canvas
    (``pad_mask`` (B,H,W), True = padding) is zeroed after normalising, as
    the host path does. A float input passes through, cast to ``dtype``."""
    if clips.dtype != torch.uint8:
        return clips.to(dtype)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=clips.device) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=clips.device) * 255.0
    out = (clips.float() - mean) / std
    if pad_mask is not None:
        out = out.masked_fill(pad_mask[:, None, :, :, None], 0.0)
    return out.to(dtype)
