"""Box-aware video transforms (numpy/PIL/cv2, host-side).

Reimplements the used subset of the reference ``datasets/video_transforms.py``
on (T, H, W, 3) uint8 numpy clips with absolute-xyxy box targets:

  * ``crop`` co-transforms boxes and drops boxes with area <= 30
    (video_transforms.py:20-67);
  * ``hflip`` (:70-85); ``resize`` aspect logic (:88-148);
  * ``RandomSizeCrop_Custom``: random position window with the *image's*
    aspect ratio and short side min(short, size) (:184-211);
  * ``Resize_Custom``: the center "fake crop" used at eval (:213-228);
  * ``ColorJitter``: HSV-space jitter via cv2 with the same integer
    arithmetic (:338-369);
  * ``normalize_clip``: ImageNet mean/std + boxes -> normalized cxcywh
    (:308-324).

The terminal TPU-specific step is ``pad_to_canvas``: every sample lands on a
fixed (H, W) canvas with a padding mask, replacing the reference's
pad-to-batch-max ``NestedTensor`` collate (utils/misc.py:387-399) so XLA sees
one static shape.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def crop_clip(clip: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
              region: Tuple[int, int, int, int], keep_min_area: float = 30.0):
    """Crop (i, j, h, w); boxes absolute xyxy; drops tiny boxes."""
    i, j, h, w = region
    clip = clip[:, i:i + h, j:j + w]
    if boxes.shape[0]:
        b = boxes - np.array([j, i, j, i], np.float32)
        b = np.minimum(b.reshape(-1, 2, 2),
                       np.array([w, h], np.float32)).clip(min=0)
        area = (b[:, 1] - b[:, 0]).prod(axis=1)
        boxes = b.reshape(-1, 4)
        keep = area > keep_min_area
        boxes, labels = boxes[keep], labels[keep]
    return clip, boxes, labels


def hflip_clip(clip: np.ndarray, boxes: np.ndarray):
    w = clip.shape[2]
    clip = clip[:, :, ::-1]
    if boxes.shape[0]:
        boxes = boxes[:, [2, 1, 0, 3]] * np.array([-1, 1, -1, 1], np.float32) \
            + np.array([w, 0, w, 0], np.float32)
    return np.ascontiguousarray(clip), boxes


def resize_clip(clip: np.ndarray, boxes: np.ndarray, out_hw: Tuple[int, int]):
    """Resize all frames (PIL bilinear) and scale boxes."""
    from PIL import Image

    t, h, w = clip.shape[:3]
    oh, ow = out_hw
    frames = [np.asarray(Image.fromarray(f).resize((ow, oh), Image.BILINEAR))
              for f in clip]
    clip = np.stack(frames)
    if boxes.shape[0]:
        boxes = boxes * np.array([ow / w, oh / h, ow / w, oh / h], np.float32)
    return clip, boxes


def random_size_crop_custom(clip, boxes, labels, size: int,
                            rng: np.random.Generator):
    """Reference RandomSizeCrop_Custom: random window with image aspect."""
    t, hh, ww = clip.shape[:3]
    if ww < hh:
        w = min(ww, size)
        h = int(w * (hh / ww))
    else:
        h = min(hh, size)
        w = int(h * (ww / hh))
    x1 = int(rng.integers(0, ww - w + 1))
    y1 = int(rng.integers(0, hh - h + 1))
    return crop_clip(clip, boxes, labels, (y1, x1, h, w))


def resize_custom(clip, boxes, labels, size: int):
    """Reference Resize_Custom: centered window with image aspect."""
    t, hh, ww = clip.shape[:3]
    if ww < hh:
        w = size
        h = int(size * (hh / ww))
    else:
        h = size
        w = int(size * (ww / hh))
    top = int(round((hh - h) / 2.0))
    left = int(round((ww - w) / 2.0))
    return crop_clip(clip, boxes, labels, (top, left, h, w))


def color_jitter_hsv(clip: np.ndarray, rng: np.random.Generator,
                     hue_shift: float = 20.0, sat_shift: float = 0.1,
                     val_shift: float = 0.1) -> np.ndarray:
    """HSV jitter with the reference's integer arithmetic
    (video_transforms.py:338-369)."""
    import cv2

    hue_bound = int(round(hue_shift / 2))
    sat_bound = int(round(sat_shift * 255))
    val_bound = int(round(val_shift * 255))

    hsv = np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2HSV) for f in clip]
                   ).astype(np.int32)
    hue_s = int(rng.integers(-hue_bound, hue_bound + 1))
    hsv[..., 0] = (hsv[..., 0] + hue_s + 180) % 180
    sat_s = int(rng.integers(-sat_bound, sat_bound + 1))
    hsv[..., 1] = np.clip(hsv[..., 1] + sat_s, 0, 255)
    val_s = int(rng.integers(-val_bound, val_bound + 1))
    hsv[..., 2] = np.clip(hsv[..., 2] + val_s, 0, 255)
    hsv = hsv.astype(np.uint8)
    return np.stack([cv2.cvtColor(f, cv2.COLOR_HSV2RGB) for f in hsv])


def boxes_to_norm_cxcywh(boxes: np.ndarray, hw) -> np.ndarray:
    """absolute xyxy -> normalized cxcywh (video_transforms.py:316-323)."""
    if not boxes.shape[0]:
        return boxes
    h, w = hw
    x0, y0, x1, y1 = boxes.T
    cxcywh = np.stack([(x0 + x1) / 2, (y0 + y1) / 2,
                       x1 - x0, y1 - y0], axis=1)
    return cxcywh / np.array([w, h, w, h], np.float32)


def normalize_clip(clip: np.ndarray, boxes: np.ndarray):
    """uint8 -> float32 ImageNet-normalized; boxes -> normalized cxcywh."""
    out = (clip.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    return out, boxes_to_norm_cxcywh(boxes, clip.shape[1:3])


def pad_to_canvas(clip: np.ndarray, canvas_hw: Tuple[int, int]):
    """Place the clip at the top-left of a fixed canvas; mask marks padding.

    Boxes are untouched: they are normalized by the *valid* (pre-padding)
    size, matching the reference's NestedTensor semantics where predictions
    are relative to each sample's own image region.
    """
    t, h, w, c = clip.shape
    ch, cw = canvas_hw
    if h > ch or w > cw:
        raise ValueError(f"clip {h}x{w} exceeds canvas {ch}x{cw}")
    out = np.zeros((t, ch, cw, c), clip.dtype)
    out[:, :h, :w] = clip
    mask = np.ones((ch, cw), bool)
    mask[:h, :w] = False
    return out, mask


def pad_targets(boxes: np.ndarray, labels: np.ndarray, max_boxes: int,
                multilabel: bool, num_classes: int):
    """Pad per-sample targets to the static (max_boxes, ...) shape."""
    n = min(boxes.shape[0], max_boxes)
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    valid = np.zeros((max_boxes,), bool)
    out_boxes[:n] = boxes[:n]
    valid[:n] = True
    if multilabel:
        out_labels = np.zeros((max_boxes, num_classes), np.float32)
        if n:
            out_labels[:n] = labels[:n]
    else:
        out_labels = np.zeros((max_boxes,), np.int32)
        if n:
            out_labels[:n] = labels[:n]
    return out_boxes, out_labels, valid


def train_transform_ava(clip, boxes, labels, img_size: int,
                        rng: np.random.Generator,
                        device_mode: bool = False):
    """flip -> random aspect crop -> HSV jitter -> normalize
    (make_transforms('train'), ava_frame.py:164-170).

    ``device_mode``: leave the clip uint8 and skip jitter/normalize — the
    photometric stage runs on the TPU inside the jitted step
    (data/device_preprocess.py); boxes are still converted here."""
    if rng.random() < 0.5:
        clip, boxes = hflip_clip(clip, boxes)
    clip, boxes, labels = random_size_crop_custom(clip, boxes, labels,
                                                  img_size, rng)
    if device_mode:
        return clip, boxes_to_norm_cxcywh(boxes, clip.shape[1:3]), labels
    clip = color_jitter_hsv(clip, rng)
    clip, boxes = normalize_clip(clip, boxes)
    return clip, boxes, labels


def val_transform_ava(clip, boxes, labels, img_size: int,
                      device_mode: bool = False):
    """center fake-crop -> normalize (make_transforms('val'))."""
    clip, boxes, labels = resize_custom(clip, boxes, labels, img_size)
    if device_mode:
        return clip, boxes_to_norm_cxcywh(boxes, clip.shape[1:3]), labels
    clip, boxes = normalize_clip(clip, boxes)
    return clip, boxes, labels


def default_canvas(img_size: int, max_aspect: float = 16.0 / 9.0,
                   multiple: int = 16) -> Tuple[int, int]:
    """Static (H, W) canvas holding any *landscape* crop with short side
    == img_size and aspect up to ``max_aspect`` (AVA movies are 4:3..16:9),
    rounded up for TPU tiling. Rare portrait samples are shrunk to fit by
    ``shrink_to_canvas`` — a deliberate static-shape trade (the reference
    feeds variable shapes, which would force one XLA recompile per aspect
    ratio)."""
    h = int(math.ceil(img_size / multiple) * multiple)
    w = int(math.ceil(img_size * max_aspect / multiple) * multiple)
    return (h, w)


def shrink_to_canvas(clip: np.ndarray,
                     canvas_hw: Tuple[int, int]) -> np.ndarray:
    """Aspect-preserving cv2 downscale only when the clip exceeds the
    canvas — the live canvas-fit step for both dataset families (callers
    carry boxes normalized to the clip, so the scale cancels and boxes
    need no adjustment)."""
    t, h, w = clip.shape[:3]
    ch, cw = canvas_hw
    scale = min(ch / h, cw / w, 1.0)
    if scale >= 1.0:
        return clip
    import cv2

    nh, nw = max(int(h * scale), 1), max(int(w * scale), 1)
    return np.stack([
        cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR)
        for f in clip])
