"""Synthetic datasets (no files needed) for tests, smoke-training and bench.

Produces the same fixed-shape sample dicts as the real AVA/JHMDB datasets,
with boxes whose position is weakly correlated with a bright blob painted
into the clip — enough signal for an end-to-end train-smoke loss decrease.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.data import transforms as T


class SyntheticAVADataset:
    def __init__(self, cfg: Config, size: int = 64, square: bool = True):
        self.cfg = cfg
        self.size = size
        c = cfg.data.img_size
        self.canvas = (c, c) if square else T.default_canvas(c)
        # "vid,ssss" keys like the real AVA dataset — consumed by the
        # evaluators, the LFB bank, and the bank-window gather
        self.keys = [f"synth,{900 + i:04d}" for i in range(size)]

    def __len__(self) -> int:
        return self.size

    def get(self, index: int, rng: np.random.Generator) -> Dict:
        cfg = self.cfg
        t = cfg.data.temp_len
        ch, cw = self.canvas
        m, c = cfg.data.max_boxes, cfg.data.num_classes

        clip = rng.normal(0, 0.3, (t, ch, cw, 3)).astype(np.float32)
        if getattr(cfg.data, "synthetic_pair", False):
            return self._pair_sample(clip, index, rng)
        easy = getattr(cfg.data, "synthetic_easy", False)
        n = 1 if easy else int(rng.integers(1, min(m, 4) + 1))
        boxes = np.zeros((m, 4), np.float32)
        labels = np.zeros((m, c), np.float32)
        valid = np.zeros((m,), bool)
        for i in range(n):
            if easy:
                # DATA.SYNTHETIC_EASY: one fixed-size box on the left or
                # right half — localization is a binary, quickly learnable
                # decision, so the e2e overfit test can bind the full
                # optimizer->matcher->criterion->postprocess->evaluator
                # stack to a non-trivial mAP within a slow-tier budget
                cx, cy = (0.3 if rng.random() < 0.5 else 0.7), 0.5
                w, h = 0.4, 0.4
            else:
                cx, cy = rng.uniform(0.25, 0.75, 2)
                w, h = rng.uniform(0.15, 0.3, 2)
            boxes[i] = [cx, cy, w, h]
            cls = int(rng.integers(0, c))
            labels[i, cls] = 1.0
            valid[i] = True
            # paint a blob so the task is learnable: box location from
            # brightness, action class color-coded into the channel
            # (cls % 3) so classification has a real signal too (the e2e
            # overfit test asserts a non-trivial mAP, which needs per-class
            # ranking above chance — brightness alone can't give that)
            x0, x1 = int((cx - w / 2) * cw), int((cx + w / 2) * cw)
            y0, y1 = int((cy - h / 2) * ch), int((cy + h / 2) * ch)
            clip[:, max(y0, 0):y1, max(x0, 0):x1] += 0.6
            clip[:, max(y0, 0):y1, max(x0, 0):x1, cls % 3] += 1.2

        return {
            "clips": clip,
            "pad_mask": np.zeros((ch, cw), bool),
            "boxes": boxes,
            "labels": labels,
            "valid": valid,
            "sizes": np.array([ch, cw], np.float32),
            "image_key": f"synth,{900 + index:04d}",
            "key_idx": np.int32(index),
            "key_pos": t // 2,
        }

    def _pair_sample(self, clip, index, rng):
        """DATA.SYNTHETIC_PAIR: two blobs every clip — left is class 0,
        right is class 1 — with the target ARRAY ORDER shuffled per
        sample (see config.py note: stable training then requires real
        cost-based assignment, not positional matching)."""
        cfg = self.cfg
        t = cfg.data.temp_len
        ch, cw = clip.shape[1:3]
        m, c = cfg.data.max_boxes, cfg.data.num_classes
        assert m >= 2 and c >= 2
        boxes = np.zeros((m, 4), np.float32)
        labels = np.zeros((m, c), np.float32)
        valid = np.zeros((m,), bool)
        order = [0, 1] if rng.random() < 0.5 else [1, 0]
        for slot, side in enumerate(order):
            cx, cy = (0.27 if side == 0 else 0.73), 0.5
            w, h = 0.38, 0.38
            boxes[slot] = [cx, cy, w, h]
            labels[slot, side] = 1.0
            valid[slot] = True
            x0, x1 = int((cx - w / 2) * cw), int((cx + w / 2) * cw)
            y0, y1 = int((cy - h / 2) * ch), int((cy + h / 2) * ch)
            clip[:, max(y0, 0):y1, max(x0, 0):x1] += 0.6
            clip[:, max(y0, 0):y1, max(x0, 0):x1, side] += 1.2
        return {
            "clips": clip,
            "pad_mask": np.zeros((ch, cw), bool),
            "boxes": boxes,
            "labels": labels,
            "valid": valid,
            "sizes": np.array([ch, cw], np.float32),
            "image_key": f"synth,{900 + index:04d}",
            "key_idx": np.int32(index),
            "key_pos": t // 2,
        }
