"""JHMDB / UCF24 per-frame tubelet dataset (ACT-detector pickle format).

Host-side re-implementation of ``datasets/jhmdb_frame.py``: same
``JHMDB-GT.pkl`` schema (gttubes / nframes / resolution / labels /
train_videos / test_videos), same per-frame sample enumeration over every
frame of every split video (:80-84), same boundary-padded clip sampling
(:201-208), same keyframe-box extraction with truncating coordinate scaling
(:140-156) — emitting fixed-shape samples for XLA.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.data import transforms as T


class JHMDBDataset:
    """Sample dict: clips/pad_mask/boxes/labels(valid int ids)/valid/vis/
    key_pos/sizes/image_key."""

    def __init__(self, cfg: Config, split: str):
        self.cfg = cfg
        self.split = split
        # JHMDB-GT.pkl / UCF101v24-GT.pkl share the ACT-detector schema;
        # anno_path may point at the directory or the .pkl itself.
        if cfg.data.anno_path.endswith(".pkl"):
            cache_file = cfg.data.anno_path
        else:
            name = ("UCF101v2-GT.pkl" if cfg.data.dataset_name == "ucf"
                    else "JHMDB-GT.pkl")
            cache_file = os.path.join(cfg.data.anno_path, name)
        with open(cache_file, "rb") as f:
            self.dataset = pickle.load(f, encoding="iso-8859-1")
        vids = (self.dataset["train_videos"][0] if split == "train"
                else self.dataset["test_videos"][0])
        self.samples: List[Tuple[str, int]] = [
            (vid, i) for vid in vids
            for i in range(self.dataset["nframes"][vid])]
        self.clip_len = cfg.data.temp_len
        self.img_size = cfg.data.img_size
        self.resize_size = (cfg.data.img_reshape_size if split == "train"
                            else cfg.data.img_size)
        if cfg.data.canvas_h and cfg.data.canvas_w:
            self.canvas = (cfg.data.canvas_h, cfg.data.canvas_w)
        else:
            self.canvas = T.default_canvas(cfg.data.img_size)
        self.max_boxes = cfg.data.max_boxes
        self.num_classes = cfg.data.num_classes

    def __len__(self) -> int:
        return len(self.samples)

    def _clip_ids(self, vid: str, mid: int) -> List[int]:
        """Boundary-padded frame ids for the window centered at ``mid``
        (reference jhmdb_frame.py:201-208) — shared with the packed reader."""
        p_t = self.clip_len // 2
        nframes = self.dataset["nframes"][vid]
        start = max(mid - p_t, 0)
        end = min(mid + self.clip_len - p_t, nframes - 1)
        ids = list(range(start, end))
        if len(ids) < self.clip_len:
            front = (self.clip_len - len(ids)) // 2
            ids = [0] * front + ids + [end] * (self.clip_len - len(ids) - front)
        return ids

    def _load_frames(self, vid: str, mid: int, nh: int, nw: int):
        from PIL import Image

        ids = self._clip_ids(vid, mid)
        frames = []
        for i in ids:
            path = os.path.join(self.cfg.data.data_path, vid,
                                "{:0>5}.png".format(i + 1))
            img = Image.open(path).convert("RGB")
            frames.append(np.asarray(img.resize((nw, nh))))
        return np.stack(frames)

    def _video_resize(self, vid: str) -> Tuple[int, int]:
        """Aspect-preserving short-side resize target (nh, nw)."""
        oh, ow = self.dataset["resolution"][vid]
        if oh <= ow:
            return self.resize_size, int(self.resize_size * (ow / oh))
        return int(self.resize_size * (oh / ow)), self.resize_size

    def get(self, index: int, rng: np.random.Generator):
        vid, frame_id = self.samples[index]
        p_t = self.clip_len // 2

        oh, ow = self.dataset["resolution"][vid]
        nh, nw = self._video_resize(vid)

        boxes, labels = [], []
        vis = 0
        for ilabel, tubes in self.dataset["gttubes"][vid].items():
            for tube in tubes:
                row = tube[tube[:, 0] == frame_id, 0:5]
                if len(row):
                    b = row[0]
                    boxes.append([int(b[1] / ow * nw), int(b[2] / oh * nh),
                                  int(b[3] / ow * nw), int(b[4] / oh * nh)])
                    labels.append(int(np.clip(ilabel, 0, 24)))
                    vis = 1
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        if boxes.shape[0]:
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, nw)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, nh)
        labels = np.asarray(labels, np.int32)

        clip = self._load_frames(vid, frame_id, nh, nw)
        if self.split == "train":
            clip, boxes, labels = T.train_transform_ava(
                clip, boxes, labels, self.img_size, rng,
                device_mode=self.cfg.data.device_preprocess)
        else:
            clip, boxes, labels = T.val_transform_ava(
                clip, boxes, labels, self.img_size,
                device_mode=self.cfg.data.device_preprocess)

        if self.split != "train" and boxes.shape[0] == 0:
            # test mode injects the reference's dummy box [0, 0, 1, 1]
            # (post-transform normalized cxcywh layout, jhmdb_frame.py:108-113)
            boxes = np.array([[0.0, 0.0, 1.0, 1.0]], np.float32)
            labels = np.array([0], np.int32)

        # boxes are normalized to the clip, so the canvas shrink needs no
        # box adjustment (cv2 default interpolation == INTER_LINEAR).
        clip = T.shrink_to_canvas(clip, self.canvas)
        h, w = clip.shape[1:3]          # effective (post-shrink) size
        padded, mask = T.pad_to_canvas(clip, self.canvas)
        pad_boxes, pad_labels, valid = T.pad_targets(
            boxes, labels, self.max_boxes, multilabel=False,
            num_classes=self.num_classes)
        return {
            # uint8 survives in device_preprocess mode (see data/ava.py).
            "clips": padded if padded.dtype == np.uint8
            else padded.astype(np.float32),
            "pad_mask": mask,
            "boxes": pad_boxes,
            "labels": pad_labels,
            "valid": valid,
            "vis": np.int32(vis),
            "key_pos": np.int32(p_t),
            "sizes": np.array([h, w], np.float32),
            "image_key": str(vid).replace("/", "_") + "-" + str(frame_id),
            "key_idx": np.int32(index),
        }
