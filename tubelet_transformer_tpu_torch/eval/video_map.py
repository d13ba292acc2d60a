"""Video-mAP with tube linking for JHMDB / UCF24.

The reference README reports JHMDB video-mAP@0.2/0.5 (README.md:31) but the
repo ships only the frame-level evaluator — no linking code. This module
implements the standard ACT-detector protocol (Kalogeiton et al., the
lineage the reference's dataset code cites — jhmdb_frame.py:2):

  * per class and video, per-frame detections are greedily linked into
    tubes: each new frame's detections (score-sorted) extend the active tube
    with the highest last-box IoU above a threshold, else start a new tube;
    tubes idle for ``max_gap`` frames terminate;
  * tube score = mean of member detection scores;
  * a predicted tube matches a ground-truth tube when the spatio-temporal
    IoU — temporal-overlap ratio x mean per-frame box IoU over the temporal
    intersection — clears the threshold (0.2 / 0.5);
  * AP per class via the same VOC machinery as frame mAP; video-mAP =
    nanmean over classes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from tubelet_transformer_tpu_torch.eval.map_eval import (
    compute_average_precision,
    compute_precision_recall,
    np_box_iou,
)


@dataclass
class Tube:
    """frames[i] <-> boxes[i] (absolute xyxy); score = mean det score."""
    frames: List[int] = field(default_factory=list)
    boxes: List[np.ndarray] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)

    @property
    def score(self) -> float:
        return float(np.mean(self.scores)) if self.scores else 0.0

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return np.asarray(self.frames, int), np.stack(self.boxes)


def link_tubes(frame_dets: Dict[int, Tuple[np.ndarray, np.ndarray]],
               link_iou: float = 0.2, max_gap: int = 1,
               min_len: int = 1) -> List[Tube]:
    """Greedy online linking of one (video, class)'s frame detections.

    frame_dets: {frame_idx: (boxes (n,4), scores (n,))}.
    """
    active: List[Tube] = []
    done: List[Tube] = []
    for f in sorted(frame_dets):
        boxes, scores = frame_dets[f]
        order = np.argsort(-scores)
        # retire tubes that have been idle too long
        still = []
        for tb in active:
            if f - tb.frames[-1] > max_gap:
                done.append(tb)
            else:
                still.append(tb)
        active = still
        extended = set()
        for di in order:
            box, sc = boxes[di], float(scores[di])
            best, best_iou = None, link_iou
            for ti, tb in enumerate(active):
                if ti in extended or tb.frames[-1] == f:
                    continue
                iou = float(np_box_iou(box[None], tb.boxes[-1][None])[0, 0])
                if iou >= best_iou:
                    best, best_iou = ti, iou
            if best is not None:
                tb = active[best]
                tb.frames.append(f)
                tb.boxes.append(box)
                tb.scores.append(sc)
                extended.add(best)
            else:
                active.append(Tube([f], [box], [sc]))
    done.extend(active)
    return [t for t in done if len(t.frames) >= min_len]


def st_iou(frames_a: np.ndarray, boxes_a: np.ndarray,
           frames_b: np.ndarray, boxes_b: np.ndarray) -> float:
    """Spatio-temporal IoU: temporal IoU x mean spatial IoU over the
    temporal intersection."""
    set_a, set_b = set(frames_a.tolist()), set(frames_b.tolist())
    inter = sorted(set_a & set_b)
    union = len(set_a | set_b)
    if not inter or union == 0:
        return 0.0
    idx_a = {f: i for i, f in enumerate(frames_a.tolist())}
    idx_b = {f: i for i, f in enumerate(frames_b.tolist())}
    ious = [float(np_box_iou(boxes_a[idx_a[f]][None],
                             boxes_b[idx_b[f]][None])[0, 0]) for f in inter]
    return (len(inter) / union) * float(np.mean(ious))


class VideoMAPEvaluator:
    """Accumulate per-(video, class) frame detections + GT tubes, then link
    and score video-mAP at several st-IoU thresholds."""

    def __init__(self, num_classes: int,
                 thresholds: Sequence[float] = (0.2, 0.5),
                 link_iou: float = 0.2, max_gap: int = 1):
        self.num_classes = num_classes
        self.thresholds = list(thresholds)
        self.link_iou = link_iou
        self.max_gap = max_gap
        # dets[(vid, cls)][frame] = (boxes, scores)
        self._dets: Dict[Tuple[str, int], Dict[int, Tuple]] = {}
        # gt[(vid, cls)] = list of (frames, boxes)
        self._gt: Dict[Tuple[str, int], List[Tuple]] = {}

    def add_frame_detections(self, vid: str, frame: int, boxes: np.ndarray,
                             classes: np.ndarray, scores: np.ndarray) -> None:
        for c in np.unique(classes):
            sel = classes == c
            self._dets.setdefault((vid, int(c)), {})[frame] = (
                boxes[sel], scores[sel])

    def add_gt_tube(self, vid: str, cls: int, frames: np.ndarray,
                    boxes: np.ndarray) -> None:
        self._gt.setdefault((vid, cls), []).append(
            (np.asarray(frames, int), np.asarray(boxes, float)))

    def evaluate(self) -> Dict[float, float]:
        """Returns {threshold: video-mAP}."""
        # link predicted tubes per (video, class)
        pred: Dict[int, List[Tuple[str, Tube]]] = {}
        for (vid, cls), frames in self._dets.items():
            for tube in link_tubes(frames, self.link_iou, self.max_gap):
                pred.setdefault(cls, []).append((vid, tube))

        results: Dict[float, float] = {}
        for thr in self.thresholds:
            aps = []
            for cls in range(self.num_classes):
                gt_items = [(vid, f, b) for (vid, c), tubes in self._gt.items()
                            if c == cls for (f, b) in tubes]
                n_gt = len(gt_items)
                tubes = sorted(pred.get(cls, []),
                               key=lambda vt: -vt[1].score)
                if n_gt == 0:
                    aps.append(float("nan"))
                    continue
                matched = [False] * n_gt
                scores, tp = [], []
                for vid, tube in tubes:
                    tf, tb = tube.as_arrays()
                    best, best_iou = -1, thr
                    for gi, (gvid, gf, gb) in enumerate(gt_items):
                        if gvid != vid or matched[gi]:
                            continue
                        iou = st_iou(tf, tb, gf, gb)
                        if iou >= best_iou:
                            best, best_iou = gi, iou
                    scores.append(tube.score)
                    if best >= 0:
                        matched[best] = True
                        tp.append(True)
                    else:
                        tp.append(False)
                p, r = compute_precision_recall(
                    np.asarray(scores), np.asarray(tp, bool), n_gt)
                aps.append(compute_average_precision(p, r))
            with np.errstate(invalid="ignore"):
                results[thr] = float(np.nanmean(np.asarray(aps, float)))
        return results
