"""Host-side box / mask set operations (numpy), arrays in, arrays out.

Covers the part of the reference's vendored TF-OD numpy box library that the
round-1 rebuild left out because the mAP path doesn't call it — NMS, windowing,
coordinate-frame changes, IoA, and the mask variants — so the full library
surface has a counterpart (reference: ``evaluates/utils/np_box_ops.py:25-97``,
``np_box_list_ops.py:39-560``, ``np_mask_ops.py:27-119``).

Design differences from the reference (deliberate, idiomatic):

  * No ``BoxList`` container. Functions take plain ``(n, 4)`` arrays and
    return either transformed arrays or **keep indices** into the input, so
    callers gather whatever side fields they carry themselves (the reference
    threads a dict of "extra fields" through every op).
  * Everything that can be vectorized is (the reference's mask intersection
    is an O(n·m) Python loop, ``np_mask_ops.py:63-68``; here one tensordot).
  * Box order follows the TF-OD convention ``[y1, x1, y2, x2]`` — documented
    per function — because the evaluator (`eval/ava_eval.py`) and these ops'
    oracle tests share fixtures with the reference code, which uses it.

The jit-compiled on-device counterpart of NMS (static shapes, lax loop) lives
in ``ops/box_ops.nms_padded``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

MASK_EPSILON = 1e-7  # np_mask_ops.py:24


# ---------------------------------------------------------------------------
# pairwise box measures ([y1, x1, y2, x2] corners, float)
# ---------------------------------------------------------------------------

def area(boxes: np.ndarray) -> np.ndarray:
    """(n, 4) -> (n,) box areas. np_box_ops.py:25-34."""
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def intersection(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(n, 4), (m, 4) -> (n, m) pairwise intersection areas. np_box_ops.py:37-60."""
    ymin1, xmin1, ymax1, xmax1 = np.split(boxes1, 4, axis=1)
    ymin2, xmin2, ymax2, xmax2 = np.split(boxes2, 4, axis=1)
    h = np.clip(np.minimum(ymax1, ymax2.T) - np.maximum(ymin1, ymin2.T), 0, None)
    w = np.clip(np.minimum(xmax1, xmax2.T) - np.maximum(xmin1, xmin2.T), 0, None)
    return h * w


def iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(n, m) pairwise intersection-over-union. np_box_ops.py:63-78."""
    inter = intersection(boxes1, boxes2)
    union = area(boxes1)[:, None] + area(boxes2)[None, :] - inter
    return inter / union


def ioa(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(n, m) intersection over *boxes2*'s area (asymmetric). np_box_ops.py:81-97."""
    return intersection(boxes1, boxes2) / area(boxes2)[None, :]


# ---------------------------------------------------------------------------
# selection / suppression — return indices into the input arrays
# ---------------------------------------------------------------------------

def filter_scores_greater_than(scores: np.ndarray, thresh: float) -> np.ndarray:
    """Indices of scores strictly greater than thresh (np_box_list_ops.py:473-503)."""
    return np.flatnonzero(scores > thresh)


def non_max_suppression(
    boxes: np.ndarray,
    scores: np.ndarray,
    max_output_size: int = 10000,
    iou_threshold: float = 1.0,
    score_threshold: float = -10.0,
) -> np.ndarray:
    """Greedy single-class NMS; returns keep indices into ``boxes``.

    Matches np_box_list_ops.py:161-233: score filter is strict ``>``, boxes
    are visited in descending-score order, a candidate is suppressed when its
    IoU with any already-selected box exceeds (strictly) ``iou_threshold``,
    and ``iou_threshold == 1.0`` short-circuits to top-``max_output_size``.
    """
    if not 0.0 <= iou_threshold <= 1.0:
        raise ValueError("iou_threshold must be in [0, 1]")
    if max_output_size < 0:
        raise ValueError("max_output_size must be >= 0")
    keep = filter_scores_greater_than(scores, score_threshold)
    if keep.size == 0:
        return keep
    order = np.argsort(scores[keep])[::-1]
    keep = keep[order]
    if iou_threshold == 1.0:
        return keep[:max_output_size]

    cand = boxes[keep]
    valid = np.ones(keep.size, dtype=bool)
    selected: List[int] = []
    for i in range(keep.size):
        if len(selected) >= max_output_size:
            break
        if not valid[i]:
            continue
        selected.append(i)
        valid[i] = False
        rest = np.flatnonzero(valid)
        if rest.size == 0:
            break
        overlap = iou(cand[i : i + 1], cand[rest])[0]
        valid[rest] = overlap <= iou_threshold
    return keep[np.asarray(selected, dtype=np.int64)]


def multi_class_non_max_suppression(
    boxes: np.ndarray,
    scores: np.ndarray,
    score_thresh: float,
    iou_thresh: float,
    max_output_size: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class NMS over a (n, num_classes) score matrix.

    Returns ``(boxes, scores, classes)`` sorted by descending score, one row
    per surviving (box, class) pair — np_box_list_ops.py:235-306 (which runs
    single-class NMS per column then concatenates and re-sorts).
    """
    if not 0.0 <= iou_thresh <= 1.0:
        raise ValueError("iou_thresh must be in [0, 1]")
    scores = np.reshape(scores, (scores.shape[0], -1))
    if scores.shape[0] != boxes.shape[0]:
        raise ValueError("scores and boxes disagree on the box count")
    out_boxes, out_scores, out_classes = [], [], []
    for class_idx in range(scores.shape[1]):
        col = scores[:, class_idx]
        keep = non_max_suppression(
            boxes, col, max_output_size=max_output_size,
            iou_threshold=iou_thresh, score_threshold=score_thresh,
        )
        out_boxes.append(boxes[keep])
        out_scores.append(col[keep])
        out_classes.append(np.full(keep.size, class_idx, dtype=np.int64))
    b = np.concatenate(out_boxes) if out_boxes else np.zeros((0, 4))
    s = np.concatenate(out_scores) if out_scores else np.zeros((0,))
    c = np.concatenate(out_classes) if out_classes else np.zeros((0,), np.int64)
    order = np.argsort(s)[::-1]
    return b[order], s[order], c[order]


def prune_non_overlapping_boxes(
    boxes1: np.ndarray, boxes2: np.ndarray, minoverlap: float = 0.0
) -> np.ndarray:
    """Indices of boxes1 whose max IoA with boxes2 >= minoverlap
    (np_box_list_ops.py:368-388; note the reference computes ioa(boxes2, boxes1))."""
    overlap = ioa(boxes2, boxes1).max(axis=0) if boxes2.size else np.zeros(len(boxes1))
    return np.flatnonzero(overlap >= minoverlap)


# ---------------------------------------------------------------------------
# geometric transforms — windows are [ymin, xmin, ymax, xmax]
# ---------------------------------------------------------------------------

def scale(boxes: np.ndarray, y_scale: float, x_scale: float) -> np.ndarray:
    """Scale y/x coordinates independently. np_box_list_ops.py:308-331."""
    return boxes * np.array([y_scale, x_scale, y_scale, x_scale], boxes.dtype)


def clip_to_window(
    boxes: np.ndarray, window: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Clip boxes into ``window``; returns ``(clipped_kept, keep_indices)``
    where boxes whose clipped area is 0 are dropped (np_box_list_ops.py:334-365)."""
    window = np.asarray(window, dtype=np.float64)
    lo = window[[0, 1, 0, 1]]
    hi = window[[2, 3, 2, 3]]
    clipped = np.clip(boxes, lo, hi)
    keep = np.flatnonzero(area(clipped) > 0.0)
    return clipped[keep], keep


def prune_outside_window(
    boxes: np.ndarray, window: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop boxes that even partially leave ``window``; returns
    ``(kept_boxes, keep_indices)`` (np_box_list_ops.py:391-421)."""
    window = np.asarray(window, dtype=np.float64)
    inside = (
        (boxes[:, 0] >= window[0]) & (boxes[:, 1] >= window[1])
        & (boxes[:, 2] <= window[2]) & (boxes[:, 3] <= window[3])
    )
    keep = np.flatnonzero(inside)
    return boxes[keep], keep


def change_coordinate_frame(boxes: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Re-express boxes relative to ``window`` (min corner -> 0, max -> 1).
    np_box_list_ops.py:506-533."""
    window = np.asarray(window, dtype=np.float64)
    shifted = boxes - window[[0, 1, 0, 1]]
    return scale(shifted, 1.0 / (window[2] - window[0]), 1.0 / (window[3] - window[1]))


# ---------------------------------------------------------------------------
# mask variants ((n, h, w) uint8 {0,1} masks) — np_mask_ops.py
# ---------------------------------------------------------------------------

def _check_masks(*mask_sets: np.ndarray) -> None:
    for m in mask_sets:
        if m.dtype != np.uint8:
            raise ValueError("masks must be np.uint8 (np_mask_ops.py contract)")


def mask_area(masks: np.ndarray) -> np.ndarray:
    """(n, h, w) -> (n,) float32 pixel counts. np_mask_ops.py:27-42."""
    _check_masks(masks)
    return np.sum(masks, axis=(1, 2), dtype=np.float32)


def mask_intersection(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """(n, m) pairwise intersection pixel counts — one tensordot instead of the
    reference's O(n·m) Python loop (np_mask_ops.py:45-68); binary {0,1} masks
    make min(a, b) == a·b."""
    _check_masks(masks1, masks2)
    n, m = masks1.shape[0], masks2.shape[0]
    flat1 = masks1.reshape(n, -1).astype(np.float32)
    flat2 = masks2.reshape(m, -1).astype(np.float32)
    return flat1 @ flat2.T


def mask_iou(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """(n, m) pairwise IoU. np_mask_ops.py:71-93."""
    inter = mask_intersection(masks1, masks2)
    union = mask_area(masks1)[:, None] + mask_area(masks2)[None, :] - inter
    return inter / np.maximum(union, MASK_EPSILON)


def mask_ioa(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """(n, m) intersection over masks2's area. np_mask_ops.py:96-119."""
    inter = mask_intersection(masks1, masks2)
    return inter / (mask_area(masks2)[None, :] + MASK_EPSILON)
