"""AVA keyframe dataset (frame-JPEG directories + JSON annotations).

Host-side re-implementation of the reference ``datasets/ava_frame.py``:
same annotation JSON format ({"video_frame_bbox", "frame_keys_list"}, keys
"vid,ssss"), same 32-frame stride-2 sampling centered at the keyframe
(ava_frame.py:41-43), same aspect-preserving short-side pre-resize with
truncating box scaling (:82-114), same train/val transform pipelines — but
emitting fixed-shape samples (static canvas + padded box targets) for XLA.

Defects in the reference deliberately fixed (SURVEY §7):
  * frame globbing honours the video id ({} template or subdirectory) instead
    of globbing a single pre-formatted directory (ava_frame.py:134-135);
  * deprecated np.int is plain int();
  * empty-box resampling is bounded and deterministic per (epoch, index).
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import List

import numpy as np

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.data import transforms as T


def _frame_dir(data_path: str, vid: str) -> str:
    if "{}" in data_path:
        return data_path.format(vid)
    return os.path.join(data_path, vid)


class AVADataset:
    """Map-style dataset over AVA keyframes; ``get(idx, rng)`` -> sample dict.

    Sample dict (static shapes):
      clips (T, Hc, Wc, 3) float32 normalized; pad_mask (Hc, Wc) bool;
      boxes (M, 4) normalized cxcywh; labels (M, C); valid (M,);
      sizes (2,) float32 [h, w] of the valid region; image_key str;
      key_pos int.
    """

    def __init__(self, cfg: Config, split: str):
        self.cfg = cfg
        self.split = split
        anno_path = cfg.data.anno_path.format(split)
        with open(anno_path) as f:
            anno = json.load(f)
        self.video_frame_bbox = anno["video_frame_bbox"]
        self.keys: List[str] = list(anno["frame_keys_list"])
        self.clip_len = cfg.data.temp_len
        self.frame_rate = cfg.data.frame_rate
        self.num_classes = cfg.data.num_classes
        self.img_size = cfg.data.img_size
        self.resize_size = (cfg.data.img_reshape_size if split == "train"
                            else cfg.data.img_size)
        if cfg.data.canvas_h and cfg.data.canvas_w:
            self.canvas = (cfg.data.canvas_h, cfg.data.canvas_w)
        else:
            self.canvas = T.default_canvas(cfg.data.img_size)
        self.max_boxes = cfg.data.max_boxes

    def __len__(self) -> int:
        return len(self.keys)

    def _probe_video(self, vid: str):
        """Frame list + aspect-preserving short-side pre-resize target
        (ava_frame.py:86-91); resolution comes from the first frame."""
        frame_list = sorted(glob(_frame_dir(self.cfg.data.data_path, vid)
                                 + "/*.jpg"))
        if not frame_list:
            return None
        from PIL import Image

        with Image.open(frame_list[0]) as im:
            ow, oh = im.size
        if oh <= ow:
            nh = self.resize_size
            nw = int(self.resize_size * (ow / oh))
        else:
            nw = self.resize_size
            nh = int(self.resize_size * (oh / ow))
        return frame_list, nh, nw

    def decode_record(self, frame_key: str, probe=None,
                      require_boxes: bool = False):
        """Pre-transform clip + pixel-space annotations for one keyframe —
        shared by the JPEG sample path and the pack writer (data/packed.py).
        Returns (clip uint8 (T,nh,nw,3), boxes, labels) or None.
        ``require_boxes`` skips the (expensive) frame decode when the
        keyframe has no usable boxes (the resample path)."""
        vid, frame_second = frame_key.split(",")
        timef = int(frame_second) - 900
        start = max(timef * 30 - self.clip_len // 2 * self.frame_rate, 0)
        probe = probe or self._probe_video(vid)
        if probe is None:
            return None
        frame_list, nh, nw = probe
        boxes, labels = self._annotation(frame_key, nh, nw)
        if require_boxes and boxes.shape[0] == 0:
            return None
        clip = self._load_frames(frame_list, start, nh, nw)
        return clip, boxes, labels

    def _load_frames(self, frame_list, start: int, nh: int, nw: int):
        idxs = np.clip(
            np.arange(start, start + self.clip_len * self.frame_rate,
                      self.frame_rate), 0, len(frame_list) - 1)

        use_native = False
        if self.cfg.data.native_decode:
            from tubelet_transformer_tpu_torch.data import native

            use_native = native.is_available()
            if not use_native and not getattr(self, "_warned_pil", False):
                # say so ONCE: native resizes bilinear, PIL default is
                # bicubic — a silent fallback changes pixel values between
                # runs that believe they share DATA.NATIVE_DECODE
                self._warned_pil = True
                print("warning: DATA.NATIVE_DECODE requested but the "
                      "native decoder is unavailable; falling back to PIL "
                      "(bicubic resize — pixels differ slightly from the "
                      "native bilinear path)")
        frames = []
        if use_native:
            from tubelet_transformer_tpu_torch.data import native

            for i in idxs:
                with open(frame_list[int(i)], "rb") as f:
                    frames.append(native.decode_jpeg(f.read(), nw, nh))
        else:
            from PIL import Image

            for i in idxs:
                img = Image.open(frame_list[int(i)]).convert("RGB")
                frames.append(np.asarray(img.resize((nw, nh))))
        return np.stack(frames)

    def _annotation(self, frame_key: str, nh: int, nw: int):
        anno = self.video_frame_bbox[frame_key]
        boxes, labels = [], []
        for i, bbox in enumerate(anno["bboxes"]):
            lab = np.zeros((self.num_classes,), np.float32)
            for l in anno["acts"][i]:
                lab[l] = 1.0
            if lab.sum() == 0:
                continue
            boxes.append([int(bbox[0] * nw), int(bbox[1] * nh),
                          int(bbox[2] * nw), int(bbox[3] * nh)])
            labels.append(lab)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        if boxes.shape[0]:
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, int(nw))
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, nh)
        labels = np.asarray(labels, np.float32).reshape(-1, self.num_classes)
        return boxes, labels

    def _try_sample(self, index: int, rng: np.random.Generator):
        frame_key = self.keys[index]
        rec = self.decode_record(frame_key, require_boxes=True)
        if rec is None:
            return None
        clip, boxes, labels = rec

        if self.split == "train":
            clip, boxes, labels = T.train_transform_ava(
                clip, boxes, labels, self.img_size, rng,
                device_mode=self.cfg.data.device_preprocess)
        else:
            clip, boxes, labels = T.val_transform_ava(
                clip, boxes, labels, self.img_size,
                device_mode=self.cfg.data.device_preprocess)
        if boxes.shape[0] == 0:
            return None
        return self._finalize(clip, boxes, labels, frame_key, index)

    def _finalize(self, clip, boxes, labels, frame_key, index):
        # boxes here are already normalized cxcywh w.r.t. the crop size,
        # so they survive the canvas shrink unchanged (the scale cancels).
        clip_u8like = T.shrink_to_canvas(clip, self.canvas)
        h, w = clip_u8like.shape[1:3]   # effective (post-shrink) size
        padded, mask = T.pad_to_canvas(clip_u8like, self.canvas)

        pad_boxes, pad_labels, valid = T.pad_targets(
            boxes, labels, self.max_boxes, multilabel=True,
            num_classes=self.num_classes)
        # uint8 survives (device_preprocess mode): the photometric stage runs
        # in-jit and device_preprocess() no-ops on float input, so casting
        # here would ship unnormalized [0,255] floats straight to the model.
        return {
            "clips": padded if padded.dtype == np.uint8
            else padded.astype(np.float32),
            "pad_mask": mask,
            "boxes": pad_boxes,
            "labels": pad_labels,
            "valid": valid,
            "sizes": np.array([h, w], np.float32),
            "image_key": frame_key.replace(",", "_"),
            "key_idx": np.int32(index),
            "key_pos": self.clip_len // 2,
        }

    def get(self, index: int, rng: np.random.Generator):
        """Load one sample; resamples (bounded) on empty targets like the
        reference (ava_frame.py:53-69)."""
        for _ in range(20):
            s = self._try_sample(index, rng)
            if s is not None:
                return s
            index = int(rng.integers(0, len(self.keys)))
        raise RuntimeError("AVA sampling failed 20 times in a row")
