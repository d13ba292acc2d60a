"""Pascal-VOC style frame-mAP evaluation (numpy, host-side).

Reimplements the *used subset* of the reference's vendored TF Object
Detection API evaluator (evaluates/utils/{object_detection_evaluation,
per_image_evaluation,metrics}.py):

  * per image & class: greedy TP/FP assignment in the order detections are
    provided (the reference sorts each image's detections by descending score
    before adding, evaluate_ava.py:145-158; matching itself does NOT re-sort
    — per_image_evaluation.py:322-327 has the sort commented out);
  * a detection is TP iff its best-IoU ground-truth box clears the threshold
    and that GT box is not already detected (per_image_evaluation.py:357-369);
  * per class: cumulative precision/recall over globally score-sorted
    detections (metrics.py:22-71), AP = area under the monotonically
    decreasing precision envelope (metrics.py:74-124);
  * mAP = nanmean of per-class APs; classes without GT give NaN
    (object_detection_evaluation.py:666-737).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


def np_box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [y?,x?...] — here plain [x1,y1,x2,y2] boxes."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, np.finfo(np.float64).eps)


def compute_precision_recall(scores, labels, num_gt):
    """metrics.py:22-71 (None/None when the class has no ground truth)."""
    if num_gt == 0:
        return None, None
    order = np.argsort(scores)[::-1]
    tp = labels[order].astype(int)
    fp = 1 - tp
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(fp)
    precision = cum_tp.astype(float) / np.maximum(
        cum_tp + cum_fp, np.finfo(np.float64).eps)
    recall = cum_tp.astype(float) / num_gt
    return precision, recall


def compute_average_precision(precision, recall) -> float:
    """VOC all-point AP with monotone precision envelope (metrics.py:74-124)."""
    if precision is None:
        return float("nan")
    if precision.size == 0:
        return 0.0
    recall = np.concatenate([[0.0], recall, [1.0]])
    precision = np.concatenate([[0.0], precision, [0.0]])
    # monotone non-increasing envelope (vectorized reverse cummax)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


def per_image_tp_fp(det_boxes, det_scores, gt_boxes,
                    iou_threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy TP/FP labels for one (image, class), detection order preserved
    (per_image_evaluation.py:284-374, non-group-of path)."""
    n = det_boxes.shape[0]
    if n == 0:
        return np.array([], float), np.array([], bool)
    if gt_boxes.size == 0:
        return det_scores, np.zeros(n, bool)
    iou = np_box_iou(det_boxes, gt_boxes)
    tp = np.zeros(n, bool)
    gt_detected = np.zeros(gt_boxes.shape[0], bool)
    best = np.argmax(iou, axis=1)
    for i in range(n):
        g = best[i]
        if iou[i, g] >= iou_threshold and not gt_detected[g]:
            tp[i] = True
            gt_detected[g] = True
    return det_scores, tp


@dataclass
class _ClassState:
    scores: List[np.ndarray] = field(default_factory=list)
    tp: List[np.ndarray] = field(default_factory=list)
    num_gt: int = 0


class PascalMAPEvaluator:
    """Frame-mAP at a fixed IoU over integer class ids.

    ``class_ids`` is the evaluated label set (e.g. the AVA 60-class
    whitelist); GT/detections with other labels are ignored.
    """

    def __init__(self, class_ids, iou_threshold: float = 0.5):
        self.iou_threshold = iou_threshold
        self.class_ids = list(class_ids)
        self._gt: Dict[str, Dict[int, np.ndarray]] = {}
        self._state: Dict[int, _ClassState] = {
            c: _ClassState() for c in self.class_ids}
        self._det_images = set()
        # matrix fast path (add_detections_matrix): per-image (q, C) score
        # and TP matrices, flattened once at evaluate()
        self._mat_scores: List[np.ndarray] = []
        self._mat_tp: List[np.ndarray] = []
        # detections buffered until evaluate() so TP assignment sees the
        # complete ground truth regardless of add order
        self._pending_rows: List[tuple] = []
        self._pending_mat: List[tuple] = []

    def add_ground_truth(self, image_key: str, boxes: np.ndarray,
                         classes: np.ndarray) -> None:
        if image_key in self._gt:
            return  # reference ignores duplicate adds (raises; we dedupe)
        per_class: Dict[int, np.ndarray] = {}
        for c in self.class_ids:
            sel = classes == c
            if np.any(sel):
                per_class[c] = boxes[sel]
                self._state[c].num_gt += int(sel.sum())
        self._gt[image_key] = per_class

    def add_detections(self, image_key: str, boxes: np.ndarray,
                       classes: np.ndarray, scores: np.ndarray) -> None:
        """Detections for one image; sorted by descending score internally
        (evaluate_ava.py:147). TP assignment is deferred to ``evaluate()``
        so GT and detections for an image may arrive in either order (the
        reference loads all GT, then all detections; the live eval loop
        interleaves per image)."""
        if image_key in self._det_images:
            return
        self._det_images.add(image_key)
        order = np.argsort(-scores, kind="stable")
        self._pending_rows.append(
            (image_key, boxes[order], classes[order], scores[order]))

    def add_detections_matrix(self, image_key: str, boxes: np.ndarray,
                              scores: np.ndarray) -> None:
        """All-class detections for one image in one call: boxes (q, 4),
        scores (q, C) with columns aligned to ``class_ids``.

        Equivalent to ``add_detections`` on the q*C expanded rows (same
        per-class descending-score order, same greedy matching) but ~20x
        faster: TP assignment runs only for the classes that actually have
        ground truth in this image, and the score/TP matrices flatten once
        at ``evaluate()``. TP assignment itself is deferred to
        ``evaluate()`` (order-independent vs GT insertion).
        """
        if image_key in self._det_images:
            return
        self._det_images.add(image_key)
        self._pending_mat.append((image_key, np.asarray(boxes, float),
                                  np.asarray(scores, float)))

    def _flush_pending(self) -> None:
        """Assign TP/FP for buffered detections against the (now complete)
        ground truth."""
        for image_key, boxes, classes, scores in self._pending_rows:
            gt = self._gt.get(image_key, {})
            for c in self.class_ids:
                sel = classes == c
                if not np.any(sel):
                    continue
                s, tp = per_image_tp_fp(
                    boxes[sel], scores[sel], gt.get(c, np.zeros((0, 4))),
                    self.iou_threshold)
                st = self._state[c]
                st.scores.append(s)
                st.tp.append(tp)
        self._pending_rows.clear()
        for image_key, boxes, scores in self._pending_mat:
            q = boxes.shape[0]
            tp = np.zeros(scores.shape, bool)
            gt = self._gt.get(image_key, {})
            if gt and q:
                for j, cid in enumerate(self.class_ids):
                    g = gt.get(cid)
                    if g is None:
                        continue
                    od = np.argsort(-scores[:, j], kind="stable")
                    iou = np_box_iou(boxes[od], g)
                    gt_det = np.zeros(g.shape[0], bool)
                    best = np.argmax(iou, axis=1)
                    for i in range(q):
                        gi = best[i]
                        if iou[i, gi] >= self.iou_threshold and not gt_det[gi]:
                            tp[od[i], j] = True
                            gt_det[gi] = True
            self._mat_scores.append(scores)
            self._mat_tp.append(tp)
        self._pending_mat.clear()

    def precision_recall_curves(
            self) -> Dict[int, Tuple[np.ndarray, np.ndarray, float]]:
        """Per-class {class_id: (precision, recall, AP)} over all added data.

        The raw curves behind `evaluate()` — feeds the PR plotting helper
        (plots.plot_precision_recall), our counterpart of the reference's
        `util/plot_utils.py:plot_precision_recall` (which reads COCO eval
        pickles the reference never produces).
        """
        self._flush_pending()
        mat_s = (np.concatenate(self._mat_scores, axis=0)
                 if self._mat_scores else None)
        mat_t = (np.concatenate(self._mat_tp, axis=0)
                 if self._mat_scores else None)
        curves: Dict[int, Tuple[np.ndarray, np.ndarray, float]] = {}
        for j, c in enumerate(self.class_ids):
            st = self._state[c]
            parts_s = list(st.scores)
            parts_t = list(st.tp)
            if mat_s is not None:
                parts_s.append(mat_s[:, j])
                parts_t.append(mat_t[:, j])
            scores = (np.concatenate(parts_s) if parts_s
                      else np.array([], float))
            tp = (np.concatenate(parts_t) if parts_t
                  else np.array([], bool))
            p, r = compute_precision_recall(scores, tp, st.num_gt)
            curves[c] = (p, r, compute_average_precision(p, r))
        return curves

    def evaluate(self) -> Tuple[float, Dict[int, float]]:
        """Returns (mAP, per-class AP dict). mAP = nanmean over classes."""
        aps = {c: ap for c, (_, _, ap)
               in self.precision_recall_curves().items()}
        vals = np.array(list(aps.values()), float)
        with np.errstate(invalid="ignore"):
            mean_ap = float(np.nanmean(vals)) if vals.size else float("nan")
        return mean_ap, aps
