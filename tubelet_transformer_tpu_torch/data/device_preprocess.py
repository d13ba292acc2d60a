"""On-device photometric preprocessing: uint8 clips in, ImageNet-normalised
clips of the compute dtype out, with the train-time HSV jitter.

Port of ``tubelet_transformer_tpu/data/device_preprocess.py``. The HSV math
follows cv2's uint8 convention (H in [0,180), S/V in [0,255]) in float; the
jitter magnitudes mirror the reference ColorJitter defaults (hue_shift=20 ->
+-10 H-units, sat/val 0.1 -> +-26 S/V-units), drawn once per clip from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from tubelet_transformer_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD


def rgb_to_hsv_cv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [0,255] float -> cv2-convention HSV (H [0,180), S/V [0,255])."""
    r, g, b = rgb.unbind(-1)
    v = torch.maximum(torch.maximum(r, g), b)
    c = v - torch.minimum(torch.minimum(r, g), b)
    safe_c = torch.where(c > 0, c, 1.0)
    # hue in degrees [0, 360)
    h = torch.where(
        v == r, 60.0 * (g - b) / safe_c,
        torch.where(v == g, 120.0 + 60.0 * (b - r) / safe_c,
                    240.0 + 60.0 * (r - g) / safe_c))
    h = torch.where(c > 0, torch.remainder(h, 360.0), 0.0)
    s = torch.where(v > 0, 255.0 * c / torch.where(v > 0, v, 1.0), 0.0)
    return torch.stack([h / 2.0, s, v], dim=-1)


def hsv_cv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """cv2-convention HSV -> RGB [0,255] float."""
    h = hsv[..., 0] * 2.0                     # degrees [0, 360)
    v = hsv[..., 2]
    c = v * (hsv[..., 1] / 255.0)
    hp = h / 60.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    sector = torch.remainder(torch.floor(hp).long(), 6)
    # (r, g, b) of sectors 0..5, as rows of (c, x, z) choices
    r = torch.stack([c, x, z, z, x, c], -1)
    g = torch.stack([x, c, c, x, z, z], -1)
    b = torch.stack([z, z, x, c, c, x], -1)
    idx = sector[..., None]
    m = v - c
    return torch.stack([r.gather(-1, idx)[..., 0] + m,
                        g.gather(-1, idx)[..., 0] + m,
                        b.gather(-1, idx)[..., 0] + m], dim=-1)


def hsv_shift(clips: torch.Tensor, sh: torch.Tensor, ss: torch.Tensor,
              sv: torch.Tensor) -> torch.Tensor:
    """Shift each clip's hue, saturation and value by its (B,) offsets:
    hue wraps at 180, saturation and value clip to [0, 255]."""
    hsv = rgb_to_hsv_cv(clips)
    per_clip = (-1,) + (1,) * (clips.dim() - 2)
    h = torch.remainder(hsv[..., 0] + sh.reshape(per_clip) + 180.0, 180.0)
    s = torch.clamp(hsv[..., 1] + ss.reshape(per_clip), 0.0, 255.0)
    v = torch.clamp(hsv[..., 2] + sv.reshape(per_clip), 0.0, 255.0)
    return hsv_cv_to_rgb(torch.stack([h, s, v], dim=-1))


def hsv_jitter(clips: torch.Tensor, generator: Optional[torch.Generator],
               hue_shift: float = 20.0, sat_shift: float = 0.1,
               val_shift: float = 0.1) -> torch.Tensor:
    """Per-clip random HSV shifts (reference ColorJitter semantics); clips
    (B,T,H,W,3) float in [0, 255]. The integer shifts are drawn from
    ``generator``, uniform on [-b, b] for b = round(hue_shift/2),
    round(sat_shift*255), round(val_shift*255)."""
    n = clips.shape[0]

    def draw(bound: int) -> torch.Tensor:
        return torch.randint(-bound, bound + 1, (n,), generator=generator,
                             device=clips.device).float()

    sh = draw(int(round(hue_shift / 2)))
    ss = draw(int(round(sat_shift * 255)))
    sv = draw(int(round(val_shift * 255)))
    return hsv_shift(clips, sh, ss, sv)


def device_preprocess(clips: torch.Tensor, dtype: torch.dtype = torch.float32,
                      pad_mask: Optional[torch.Tensor] = None,
                      jitter: bool = False,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """uint8 (B,T,H,W,3) -> (x - mean) / std in ``dtype``, with the HSV
    jitter first when ``jitter`` (its shifts from ``generator``); the padded
    canvas (``pad_mask`` (B,H,W), True = padding) is zeroed after
    normalising, as the host path does. A float input passes through, cast
    to ``dtype``."""
    if clips.dtype != torch.uint8:
        return clips.to(dtype)
    x = clips.float()
    if jitter:
        x = hsv_jitter(x, generator)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=clips.device) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=clips.device) * 255.0
    out = (x - mean) / std
    if pad_mask is not None:
        out = out.masked_fill(pad_mask[:, None, :, :, None], 0.0)
    return out.to(dtype)
