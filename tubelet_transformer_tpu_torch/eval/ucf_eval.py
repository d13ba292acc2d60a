"""UCF24 / JHMDB frame-level detection evaluation.

Reimplements ``STDetectionEvaluaterUCF`` (evaluates/evaluate_ucf.py:22-170):
  * GT rows with box area < 10 px^2 mark the image key as excluded for
    detections too (:61-63);
  * a detection row is dropped when its argmax over the full softmax
    (incl. the no-object class) is the no-object column; otherwise only the
    argmax foreground class is kept with its score (:111-128);
  * Pascal frame-AP machinery as in map_eval.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from tubelet_transformer_tpu_torch.eval.map_eval import PascalMAPEvaluator

UCF24_LABELS = [
    "Basketball", "BasketballDunk", "Biking", "CliffDiving", "CricketBowling",
    "Diving", "Fencing", "FloorGymnastics", "GolfSwing", "HorseRiding",
    "IceDancing", "LongJump", "PoleVault", "RopeClimbing", "SalsaSpin",
    "SkateBoarding", "Skiing", "Skijet", "SoccerJuggling", "Surfing",
    "TennisSwing", "TrampolineJumping", "VolleyballSpiking", "WalkingWithDog",
]


class UCFDetectionEvaluator:
    def __init__(self, class_num: int = 24,
                 iou_thresholds: Sequence[float] = (0.5,)):
        self.class_num = class_num
        self.iou_thresholds = list(iou_thresholds)
        self._evals = [PascalMAPEvaluator(list(range(1, class_num + 1)), t)
                       for t in self.iou_thresholds]
        self.exclude_keys: set = set()
        self._pending_dets: List[Tuple[str, np.ndarray, np.ndarray]] = []

    def add_ground_truth(self, image_key: str, boxes: np.ndarray,
                         label_onehot: np.ndarray) -> None:
        """boxes (n,4) absolute xyxy; label_onehot (n, C) (or multihot)."""
        all_boxes, all_classes = [], []
        for i in range(boxes.shape[0]):
            b = boxes[i]
            if (b[2] - b[0]) * (b[3] - b[1]) < 10:
                self.exclude_keys.add(image_key)
                continue
            for x in np.nonzero(label_onehot[i] > 1e-2)[0]:
                all_boxes.append(b)
                all_classes.append(int(x) + 1)
        if not all_boxes:
            return
        for ev in self._evals:
            ev.add_ground_truth(image_key, np.stack(all_boxes),
                                np.array(all_classes, int))

    def add_detections(self, image_key: str, boxes: np.ndarray,
                       softmax_scores: np.ndarray) -> None:
        """boxes (q,4) absolute; softmax_scores (q, C+1) incl. no-object.

        Buffered until evaluate() so GT-driven exclusions apply regardless of
        call order (the reference loads all GT first)."""
        self._pending_dets.append((image_key, boxes, softmax_scores))

    def _flush(self) -> None:
        for image_key, boxes, sm in self._pending_dets:
            if image_key in self.exclude_keys:
                continue
            keep_boxes, keep_classes, keep_scores = [], [], []
            for q in range(boxes.shape[0]):
                full = sm[q]
                if int(np.argmax(full)) == len(full) - 1:
                    continue
                fg = full[: self.class_num]
                x = int(np.argmax(fg))
                keep_boxes.append(boxes[q])
                keep_classes.append(x + 1)
                keep_scores.append(fg[x])
            if not keep_boxes:
                continue
            for ev in self._evals:
                ev.add_detections(image_key, np.stack(keep_boxes),
                                  np.array(keep_classes, int),
                                  np.array(keep_scores, float))
        self._pending_dets = []

    def evaluate(self) -> Tuple[List[float], Dict]:
        self._flush()
        maps, result = [], {}
        for t, ev in zip(self.iou_thresholds, self._evals):
            mean_ap, aps = ev.evaluate()
            maps.append(mean_ap)
            result[f"PascalBoxes_Precision/mAP@{t}IOU"] = mean_ap
            for c, ap in aps.items():
                result[f"PascalBoxes_PerformanceByCategory/AP@{t}IOU/{c}"] = ap
        return maps, result
