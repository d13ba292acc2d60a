"""AVA spatio-temporal detection evaluation (frame mAP + person AP).

Array-native equivalent of the reference ``STDetectionEvaluater`` /
``STDetectionEvaluaterSinglePerson`` (evaluates/evaluate_ava.py:17-326).
Detections flow in as in-memory arrays gathered across hosts by collectives —
no per-rank txt files — but the reference txt dump format
("<image_key> [x1, y1, x2, y2, s1..sC, binary]",
utils/video_action_recognition.py:411-420) is still supported for debugging
and for cross-testing against the reference evaluator.

Evaluation-protocol quirks reproduced exactly:
  * GT rows keep only classes with score > 1e-2 and (for 80-class AVA)
    ids in the labelmap whitelist (evaluate_ava.py:78-85);
  * detections keep every whitelisted class (no score floor,
    evaluate_ava.py:129-136), sorted per image by descending score;
  * AVA 2.1 excluded-timestamp keys are dropped from both sides
    (evaluate_ava.py:34-44, 66-68, 112-114);
  * person AP: class-agnostic, detections scored by the binary head, kept
    only when binary > 0 and the box area is within the size window
    (evaluate_ava.py:186-316).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from tubelet_transformer_tpu_torch.eval.labelmap import read_labelmap
from tubelet_transformer_tpu_torch.eval.map_eval import PascalMAPEvaluator


class AVADetectionEvaluator:
    def __init__(self, label_path: Optional[str] = None, class_num: int = 80,
                 iou_thresholds: Sequence[float] = (0.5,),
                 exclude_keys: Iterable[str] = (),
                 class_ids: Optional[Sequence[int]] = None):
        if class_ids is None:
            if label_path:
                _, whitelist = read_labelmap(label_path)
                class_ids = sorted(whitelist)
            else:
                class_ids = list(range(1, class_num + 1))
        # score column c (0-based) is class id c+1 everywhere in the matrix
        # API, so the evaluator's class list must be the sorted, in-range
        # subset — an unsorted or out-of-range id would silently shift the
        # column->class mapping in the compacted fast path.
        self.class_ids = sorted(set(int(c) for c in class_ids))
        if not all(1 <= c <= class_num for c in self.class_ids):
            raise ValueError(
                f"class_ids must lie in [1, {class_num}]: {self.class_ids}")
        self.class_num = class_num
        self.exclude_keys = set(exclude_keys)
        self.iou_thresholds = list(iou_thresholds)
        self._evals = [PascalMAPEvaluator(self.class_ids, t)
                       for t in self.iou_thresholds]
        # whitelist mask over class columns (AVA-80: labelmap subset);
        # cids[mask] enumerates in ascending order == self.class_ids, so
        # the compacted score columns align with PascalMAPEvaluator's ids
        cids = np.arange(1, class_num + 1)
        self._col_mask = np.isin(cids, np.asarray(self.class_ids))
        self._col_ids = cids[self._col_mask]
        assert list(self._col_ids) == self.class_ids

    # -- array API (collective-gathered eval path) --------------------------

    def add_ground_truth(self, image_key: str, boxes: np.ndarray,
                         label_multihot: np.ndarray) -> None:
        """boxes (n, 4) absolute xyxy; label_multihot (n, C) in {0,1}."""
        if image_key in self.exclude_keys:
            return
        hot = np.asarray(label_multihot) > 1e-2
        hot &= self._col_mask[None, : hot.shape[1]]
        rows, cols = np.nonzero(hot)
        if rows.size == 0:
            return
        for ev in self._evals:
            ev.add_ground_truth(image_key, np.asarray(boxes)[rows],
                                cols.astype(int) + 1)

    def add_detections(self, image_key: str, boxes: np.ndarray,
                       scores: np.ndarray) -> None:
        """boxes (q, 4) absolute xyxy; scores (q, C) gated class scores."""
        if image_key in self.exclude_keys:
            return
        boxes = np.asarray(boxes)
        scores = np.asarray(scores)
        m = self._col_mask[: scores.shape[1]]
        if not m.any() or boxes.shape[0] == 0:
            return
        sel = scores[:, m]
        for ev in self._evals:
            ev.add_detections_matrix(image_key, boxes, sel)

    def precision_recall_curves(self, iou_threshold: Optional[float] = None):
        """Per-class {class_id: (precision, recall, AP)} at one threshold."""
        t = self.iou_thresholds[0] if iou_threshold is None else iou_threshold
        ev = self._evals[self.iou_thresholds.index(t)]
        return ev.precision_recall_curves()

    def evaluate(self) -> Tuple[List[float], Dict]:
        maps, result = [], {}
        for t, ev in zip(self.iou_thresholds, self._evals):
            mean_ap, aps = ev.evaluate()
            maps.append(mean_ap)
            result[f"PascalBoxes_Precision/mAP@{t}IOU"] = mean_ap
            for c, ap in aps.items():
                result[f"PascalBoxes_PerformanceByCategory/AP@{t}IOU/{c}"] = ap
        return maps, result

    # -- txt-file API (reference dump format, debugging / cross-testing) ----

    def load_gt_from_files(self, paths: Sequence[str]) -> None:
        # buffer rows per image first: add_ground_truth accepts ONE call
        # per image key (duplicate adds are deduped away, matching the
        # reference evaluator's one-shot GT semantics), so feeding txt rows
        # one at a time would silently drop every GT after an image's first
        buf: Dict[str, List] = {}
        for key, vals in _parse_txt(paths, self.exclude_keys):
            buf.setdefault(key, []).append(vals)
        for key, rows in buf.items():
            boxes = np.asarray([r[2:6] for r in rows], float)
            scores = np.asarray([r[6:] for r in rows], float)
            self.add_ground_truth(key, boxes, scores)

    def load_detections_from_files(self, paths: Sequence[str]) -> None:
        buf: Dict[str, List] = {}
        for key, vals in _parse_txt(paths, self.exclude_keys):
            buf.setdefault(key, []).append(vals)
        for key, rows in buf.items():
            boxes = np.asarray([r[0:4] for r in rows], float)
            scores = np.asarray([r[4:4 + self.class_num] for r in rows], float)
            self.add_detections(key, boxes, scores)


class PersonDetectionEvaluator:
    """Class-agnostic actor AP with box-size window
    (STDetectionEvaluaterSinglePerson, evaluate_ava.py:173-326)."""

    def __init__(self, iou_thresholds: Sequence[float] = (0.5,),
                 size_min: float = 0.0, size_max: float = 555.0 * 555.0):
        self.iou_thresholds = list(iou_thresholds)
        self.size_min = size_min
        self.size_max = size_max
        self._evals = [PascalMAPEvaluator([1], t) for t in self.iou_thresholds]

    def _size_ok(self, box) -> bool:
        a = (box[2] - box[0]) * (box[3] - box[1])
        return self.size_min <= a <= self.size_max

    def add_ground_truth(self, image_key: str, boxes: np.ndarray) -> None:
        keep = np.array([self._size_ok(b) for b in boxes], bool) \
            if boxes.size else np.zeros(0, bool)
        if not keep.any():
            return
        b = boxes[keep]
        for ev in self._evals:
            ev.add_ground_truth(image_key, b, np.ones(len(b), int))

    def add_detections(self, image_key: str, boxes: np.ndarray,
                       binary_scores: np.ndarray) -> None:
        keep = [i for i in range(boxes.shape[0])
                if binary_scores[i] > 0 and self._size_ok(boxes[i])]
        if not keep:
            return
        b = boxes[keep]
        s = binary_scores[keep]
        for ev in self._evals:
            ev.add_detections(image_key, b, np.ones(len(b), int),
                              np.asarray(s, float))

    def evaluate(self) -> List[float]:
        return [ev.evaluate()[0] for ev in self._evals]


def _parse_txt(paths: Sequence[str], exclude: set):
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key = line.split(" [")[0]
                if key in exclude:
                    continue
                vals = [float(x) for x in
                        line.split(" [")[1].split("]")[0].split(",")]
                yield key, vals


def dump_detections_txt(path: str, rows) -> None:
    """Write the reference txt dump format
    (video_action_recognition.py:411-414)."""
    with open(path, "w") as f:
        for key, values in rows:
            f.write("{} [{}]\n".format(
                key, ", ".join(str(float(v)) for v in values)))


def load_excluded_keys(path: str):
    """AVA excluded-timestamps CSV ("vid,ssss" per row) -> set of image keys
    in the dump format ("vid_ssss") — reference evaluate_ava.py:36-41."""
    keys = set()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                keys.add(line.replace(",", "_"))
    return keys
