"""Online (streaming) inference, single stream.

Port of ``tubelet_transformer_tpu/serving.py``. The host side is the same:
a rolling window of ``TEMP_LEN`` frames at ``FRAME_RATE`` stride, one
detection per ``detect_every`` pushed frames, the keyframe at the window's
centre, frames aspect-resized onto the fixed ``IMG_SIZE`` canvas with PIL.
The device side is one forward under ``torch.inference_mode()`` (uint8
upload, normalisation on the device, model, postprocess) and one
device-to-host copy of all outputs. An AVA config is postprocessed with
``postprocess_ava`` (gated at the actor threshold); a JHMDB/UCF24 config
with ``postprocess_softmax``, whose clip-level visibility stands for every
one of the Q*T tubelet queries.

Not ported yet, and refused with ``NotImplementedError``: the long-term
feature memory (``CONFIG.USE_LFB``), mesh serving, ``MODEL.INFER_CHUNK``
(a TPU conv-emitter workaround) and ``StreamingDetectorPool``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.data.device_preprocess import (
    device_preprocess)
from tubelet_transformer_tpu_torch.models.tuber import TubeR, build_model
from tubelet_transformer_tpu_torch.train.postprocess import (
    postprocess_ava, postprocess_softmax)


def _per_query_binary(binary_row: np.ndarray, n_queries: int) -> np.ndarray:
    """Per-query actor probabilities from a postprocess binary row: AVA
    emits (Q, 1); JHMDB/UCF emit a clip-level (1,) visibility, which
    broadcasts to every query."""
    b = np.asarray(binary_row).reshape(-1)
    if b.shape[0] == n_queries:
        return b
    return np.full((n_queries,), float(b[0]), np.float32)


@dataclass
class Detection:
    """One detected actor at a keyframe."""

    box: np.ndarray          # (4,) xyxy in source-frame pixels
    actor_prob: float
    scores: np.ndarray       # (num_classes,) per-action scores


@dataclass
class KeyframeResult:
    frame_index: int         # source frame index of the keyframe
    time_s: float            # frame_index / fps
    detections: List[Detection]
    latency_ms: float        # host wall clock of the detection, device included
    memory_size: int = 0     # long-term memory tokens (no memory yet: 0)


class StreamingDetector:
    """Streaming TubeR detector over a live frame feed.

    Args:
      cfg: framework config (AVA or JHMDB/UCF24 mode).
      model: a built ``TubeR``; if None, one with random weights from
        ``rng_seed`` is built on ``device``.
      detect_every: one detection per this many pushed frames (default
        ``fps``: one per source second, the AVA keyframe cadence).
      fps: source frame rate, for timestamps and the default cadence.
      actor_threshold: actor probability a detection must exceed.
      device: where the model runs; the model's device when it is given.
    """

    def __init__(self, cfg: Config, model: Optional[TubeR] = None, *,
                 detect_every: Optional[int] = None, fps: float = 30.0,
                 actor_threshold: float = 0.8, rng_seed: int = 0,
                 device: torch.device | str = "cuda", mesh=None,
                 infer_chunk: Optional[int] = None):
        if cfg.use_lfb:
            raise NotImplementedError("long-term feature memory "
                                      "(CONFIG.USE_LFB) is not ported yet")
        if mesh is not None:
            raise NotImplementedError("mesh serving is not ported yet")
        if (cfg.model.infer_chunk if infer_chunk is None else infer_chunk):
            raise NotImplementedError("MODEL.INFER_CHUNK is not ported")
        self.cfg = cfg
        self.fps = fps
        self.t_len = cfg.data.temp_len
        self.stride = max(1, cfg.data.frame_rate)
        self.img_size = cfg.data.img_size
        self.detect_every = int(detect_every or round(fps))
        self.actor_threshold = actor_threshold
        # serving runs the sequential encoder, as the JAX detector does
        cfg.mesh.pipe = 1
        if model is None:
            model = build_model(cfg, device=device, seed=rng_seed)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self._frames: deque = deque(maxlen=self.t_len * self.stride)
        self._frame_count = 0
        self._since_detect = 0
        self._src_hw = None
        self._scale = 1.0

    # -- device step ------------------------------------------------------

    def _detect_core(self, clip_u8: torch.Tensor, pad_mask: torch.Tensor):
        clips = device_preprocess(clip_u8, dtype=self.model.dtype,
                                  pad_mask=pad_mask)
        out = self.model(clips, pad_mask)
        size = torch.tensor([[self.img_size, self.img_size]],
                            dtype=torch.float32, device=clip_u8.device)
        if self.model.is_ava:
            # gate at the serving threshold, not the offline-eval 0.8
            return postprocess_ava(out, size,
                                   binary_gate=self.actor_threshold)
        return postprocess_softmax(out, size)

    # -- host loop --------------------------------------------------------

    def _prep_frame(self, frame: np.ndarray) -> np.ndarray:
        """Aspect-preserving resize onto the fixed canvas (top-left)."""
        h, w = frame.shape[:2]
        if self._src_hw != (h, w):
            # a new resolution restarts the window: buffered frames were
            # resized at the old scale
            if self._src_hw is not None:
                self._frames.clear()
            self._src_hw = (h, w)
            self._scale = self.img_size / max(h, w)
        nh = max(1, int(round(h * self._scale)))
        nw = max(1, int(round(w * self._scale)))
        if (nh, nw) != (h, w):
            from PIL import Image

            frame = np.asarray(Image.fromarray(frame).resize(
                (nw, nh), Image.BILINEAR))
        canvas = np.zeros((self.img_size, self.img_size, 3), np.uint8)
        canvas[:nh, :nw] = frame
        self._valid_hw = (nh, nw)
        return canvas

    def push_frame(self, frame: np.ndarray) -> Optional[KeyframeResult]:
        """Feed one (H, W, 3) uint8 RGB frame; returns a result when a
        keyframe detection fires, else None."""
        self._frames.append(self._prep_frame(frame))
        self._frame_count += 1
        self._since_detect += 1
        window = self.t_len * self.stride
        if len(self._frames) < window or self._since_detect < self.detect_every:
            return None
        self._since_detect = 0
        return self._run_detection()

    def flush(self) -> Optional[KeyframeResult]:
        """Run a final detection on the current (possibly short) buffer by
        repeating the last frame to fill the window."""
        if not self._frames:
            return None
        while len(self._frames) < self._frames.maxlen:
            self._frames.append(self._frames[-1])
        return self._run_detection()

    def _run_detection(self) -> KeyframeResult:
        t0 = time.perf_counter()
        clip = np.stack(list(self._frames)[:: self.stride])[None]  # (1,T,H,W,3)
        nh, nw = self._valid_hw
        pad = np.ones((1, self.img_size, self.img_size), bool)
        pad[:, :nh, :nw] = False

        with torch.inference_mode():
            outs = self._detect_core(
                torch.from_numpy(clip).to(self.device),
                torch.from_numpy(pad).to(self.device))
            # one device-to-host copy for all outputs
            flat = torch.cat([o[0].float().reshape(-1) for o in outs]).cpu()
        scores, boxes, binary = (
            a.numpy().reshape(o.shape[1:]) for a, o in
            zip(flat.split([o[0].numel() for o in outs]), outs))
        binary = _per_query_binary(binary, scores.shape[0])

        # canvas pixels -> source-frame pixels
        sh, sw = self._src_hw
        boxes = np.clip(boxes / self._scale, 0, [sw, sh, sw, sh])
        dets = [Detection(box=boxes[q], actor_prob=float(binary[q]),
                          scores=scores[q])
                for q in range(len(binary))
                if binary[q] > self.actor_threshold]
        # keyframe = centre of the clip window
        key_idx = self._frame_count - self.t_len * self.stride // 2
        return KeyframeResult(
            frame_index=key_idx, time_s=key_idx / self.fps, detections=dets,
            latency_ms=(time.perf_counter() - t0) * 1e3)


class StreamingDetectorPool:
    """Multi-stream batched serving: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("StreamingDetectorPool is not ported yet")
