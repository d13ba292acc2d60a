"""Online (streaming) inference: one stream, and many streams in batches.

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

With ``CONFIG.USE_LFB`` a detector carries a rolling long-term memory
(``_Memory``): each detection's final-layer query features of its
``memory_slots`` most confident actors enter a fixed-shape window of the
last ``memory_keyframes`` keyframes, which the next detection
cross-attends over; a stream's first keyframe sees a fully padded memory.

``StreamingDetectorPool`` serves many streams with one model: every stream
whose keyframe is due is detected in one padded forward per bucket (powers
of two up to ``max_batch``, and ``max_batch``), scheduled by priority class
and then by deadline slack, with the pool lock held for the host work only.
Unlike the JAX pool it runs each bucket as one forward: ``infer_chunk``
(``MODEL.INFER_CHUNK``), a TPU conv-emitter workaround, is refused.

Mesh serving (``mesh``: ``parallel.mesh.create_mesh`` under torchrun): the
model is split over the 'model' axis (``parallel/sharding_rules.py``), as
JAX's ``param_shardings`` splits the detector's variables. JAX's detector
is one controller over its devices; here every rank is a process, so rank
0 leads and the other ranks follow. Rank 0 alone holds the host state (the
streams, their frame windows and memories, the HTTP server) and calls the
forward; each of its forwards (``_detect_core``) first sends every rank a
header (run or stop, the bucket, whether the memory is on) and the batch
(``parallel.mesh.broadcast_batch``), then runs the split forward on its
rows, then takes each data shard's rows back (``gather_rows``). A bucket
that ``MESH.DATA`` divides is split over the data shards, as JAX shards it
over 'data' (each shard's model peers run its rows); any other bucket runs
whole on every data group. The other ranks call ``follow``, which runs the
same steps until rank 0's ``stop_followers``. Every rank builds its
detector with the same arguments.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.data.device_preprocess import (
    device_preprocess)
from tubelet_transformer_tpu_torch.models.tuber import TubeR, build_model
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
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


# the first word of a mesh step's header
_STOP, _RUN = 0, 1


def _serving_mesh(mesh: Optional[mesh_lib.Mesh]) -> Optional[mesh_lib.Mesh]:
    """``mesh``, or None for a mesh of one process; ValueError when it does
    not span this launch's processes."""
    if mesh is None or mesh.data * mesh.model == 1:
        return None
    n = mesh_lib.process_count()
    if mesh.data * mesh.model != n:
        raise ValueError(f"mesh {mesh.data}x{mesh.model} (MESH.DATA x MODEL)"
                         f" != {n} processes: serve over a mesh under "
                         "torchrun")
    return mesh


def _to_host(outs: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Float32 numpy copies of ``outs``, in one device-to-host copy."""
    flat = torch.cat([o.float().reshape(-1) for o in outs]).cpu()
    return [a.numpy().reshape(o.shape) for a, o in
            zip(flat.split([o.numel() for o in outs]), outs)]


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
    memory_size: int = 0     # valid long-term memory tokens used
    waited_ms: float = 0.0   # time spent due before being scheduled (pool)
    deadline_met: Optional[bool] = None  # vs set_deadline SLO; None = no SLO


@dataclass
class _Memory:
    """Rolling long-term memory: per past keyframe, ``slots`` feature rows."""

    slots: int
    keyframes: int
    feat_dim: int
    feats: deque = field(default_factory=deque)
    valid: deque = field(default_factory=deque)

    def push(self, features: np.ndarray, actor_prob: np.ndarray,
             threshold: float) -> None:
        order = np.argsort(-actor_prob)[: self.slots]
        f = np.zeros((self.slots, self.feat_dim), np.float32)
        v = np.zeros((self.slots,), bool)
        f[: len(order)] = features[order]
        v[: len(order)] = actor_prob[order] > threshold
        self.feats.append(f)
        self.valid.append(v)
        while len(self.feats) > self.keyframes:
            self.feats.popleft()
            self.valid.popleft()

    def window(self):
        """Fixed-shape (keyframes*slots, D) memory + True-is-pad mask."""
        l_mem = self.keyframes * self.slots
        feats = np.zeros((l_mem, self.feat_dim), np.float32)
        mask = np.ones((l_mem,), bool)
        for i, (f, v) in enumerate(zip(self.feats, self.valid)):
            feats[i * self.slots:(i + 1) * self.slots] = f
            mask[i * self.slots:(i + 1) * self.slots] = ~v
        return feats, mask


class StreamingDetector:
    """Streaming TubeR detector over a live frame feed.

    Args:
      cfg: framework config (AVA or JHMDB/UCF24 mode); ``cfg.use_lfb``
        turns the online long-term memory on.
      model: a built ``TubeR``; if None, one with random weights from
        ``rng_seed`` is built on ``device``.
      detect_every: one detection per this many pushed frames (default
        ``fps``: one per source second, the AVA keyframe cadence).
      fps: source frame rate, for timestamps and the default cadence.
      memory_keyframes / memory_slots: the long-term memory's extent (past
        keyframes remembered x actor slots per keyframe).
      actor_threshold: actor probability a detection (and a valid memory
        slot) must exceed.
      device: where the model runs; the model's device when it is given.
      mesh: a ``parallel.mesh.Mesh`` of this launch's processes: the model
        (built here, or the one given) is split over its 'model' axis, and
        rank 0's forwards lead every rank's (module docstring).
    """

    def __init__(self, cfg: Config, model: Optional[TubeR] = None, *,
                 detect_every: Optional[int] = None, fps: float = 30.0,
                 memory_keyframes: int = 10, memory_slots: int = 5,
                 actor_threshold: float = 0.8, rng_seed: int = 0,
                 device: torch.device | str = "cuda", mesh=None,
                 infer_chunk: Optional[int] = None):
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
        self.mesh = _serving_mesh(mesh)
        if model is None:
            model = build_model(cfg, device=device, seed=rng_seed,
                                mesh=self.mesh)
        elif (self.mesh is not None and self.mesh.model > 1
              and getattr(model, "tp", None) is None):
            from tubelet_transformer_tpu_torch.parallel.sharding_rules import (
                shard_model)

            shard_model(model, self.mesh)
        self._followers_stopped = False
        # under a mesh, the last forward's send, rows and gather, in ms
        self.last_exchange: Dict[str, float] = {}
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.memory = (_Memory(memory_slots, memory_keyframes,
                               cfg.model.d_model) if cfg.use_lfb else None)
        self._frames: deque = deque(maxlen=self.t_len * self.stride)
        self._frame_count = 0
        self._since_detect = 0
        self._src_hw = None
        self._scale = 1.0

    # -- device step ------------------------------------------------------

    def _detect_core(self, clip_u8, pad_mask, lfb_feats, lfb_mask
                     ) -> List[np.ndarray]:
        """One forward of a batch (numpy arrays, or without a mesh tensors
        on the device): (B,T,H,W,3) uint8 clips, (B,H,W) pad masks and the
        (B,L_mem,E) memories with their (B,L_mem) masks (read only with the
        long-term memory on) -> scores, boxes, actor probabilities and the
        final-layer query features, as numpy arrays. Under a mesh, rank 0's
        lead of every rank's forward (``_lead``). The caller enters
        inference mode."""
        if self.mesh is None:
            return self._forward(clip_u8, pad_mask, lfb_feats, lfb_mask)
        return self._lead(clip_u8, pad_mask, lfb_feats, lfb_mask)

    def _header(self, run: int, bucket: int) -> List[int]:
        """A mesh step's header: run or stop, the bucket, and what every
        rank must agree on: the memory on or off, the canvas, and the actor
        threshold's bits (the postprocess gates at it)."""
        return [run, bucket, int(self.memory is not None), self.img_size,
                int(np.float64(self.actor_threshold).view(np.int64))]

    def _lead(self, clip_u8, pad_mask, lfb_feats, lfb_mask
              ) -> List[np.ndarray]:
        """Rank 0's forward under the mesh: the header and the batch to
        every rank (each data shard's rows alone when MESH.DATA divides the
        bucket), the split forward on its own rows, and each shard's
        outputs back in row order. ``last_exchange`` takes the times."""
        if self._followers_stopped:
            raise RuntimeError("the followers were stopped")
        arrays = [np.asarray(clip_u8, np.uint8), np.asarray(pad_mask, bool)]
        if self.memory is not None:
            arrays += [np.asarray(lfb_feats, np.float32),
                       np.asarray(lfb_mask, bool)]
        bucket = arrays[0].shape[0]
        split = self.mesh.data > 1 and bucket % self.mesh.data == 0
        t0 = time.perf_counter()
        rows = mesh_lib.broadcast_batch(self._header(_RUN, bucket), arrays,
                                        self.mesh, split)
        t1 = time.perf_counter()
        outs = self._forward(*rows, *[None] * (4 - len(rows)))
        t2 = time.perf_counter()
        if split:
            outs = mesh_lib.gather_rows(outs, self.mesh)
        self.last_exchange = {"broadcast_ms": (t1 - t0) * 1e3,
                              "rows_ms": (t2 - t1) * 1e3,
                              "gather_ms": (time.perf_counter() - t2) * 1e3}
        return outs

    def stop_followers(self) -> None:
        """Rank 0 under a mesh: the stop header, on which every rank's
        ``follow`` returns. Once; a no-op without a mesh."""
        if self.mesh is None or self._followers_stopped:
            return
        self._followers_stopped = True
        mesh_lib.broadcast_batch(self._header(_STOP, 0), [], self.mesh)
        # the followers' last reads of the store precede this
        mesh_lib.barrier()

    def _forward(self, clip_u8, pad_mask, lfb_feats, lfb_mask
                 ) -> List[np.ndarray]:
        """This process's forward of a batch (``_detect_core``'s
        arguments), the outputs from one device-to-host copy."""
        dev = self.device
        clips_u8 = torch.as_tensor(clip_u8, device=dev)
        pad = torch.as_tensor(pad_mask, device=dev)
        kw = {}
        if self.memory is not None:
            kw = dict(lfb_features=torch.as_tensor(lfb_feats, device=dev),
                      lfb_mask=torch.as_tensor(lfb_mask, device=dev))
        out = self.model(device_preprocess(clips_u8, dtype=self.model.dtype,
                                           pad_mask=pad),
                         pad, return_features=True, **kw)
        size = torch.tensor([[self.img_size, self.img_size]],
                            dtype=torch.float32, device=dev)
        if self.model.is_ava:
            # gate at the serving threshold, not the offline-eval 0.8
            post = postprocess_ava(out, size,
                                   binary_gate=self.actor_threshold)
        else:
            post = postprocess_softmax(out, size)
        return _to_host((*post, out["lfb_features"]))

    def _memory_window(self, memory: Optional[_Memory]):
        """(L_mem, E) memory and (L_mem,) mask of ``memory``, and its valid
        tokens; a one-token placeholder without a memory."""
        if memory is None:
            return (np.zeros((1, self.cfg.model.d_model), np.float32),
                    np.ones((1,), bool), 0)
        feats, mask = memory.window()
        return feats, mask, int((~mask).sum())

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

    def _pad_mask(self) -> np.ndarray:
        nh, nw = self._valid_hw
        pad = np.ones((self.img_size, self.img_size), bool)
        pad[:nh, :nw] = False
        return pad

    def reset(self) -> None:
        """Forget the frame window, the cadence and the memory."""
        self._frames.clear()
        self._frame_count = 0
        self._since_detect = 0
        if self.memory is not None:
            self.memory.feats.clear()
            self.memory.valid.clear()

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

    def _result(self, key_count: int, scale: float, src_hw, scores, boxes,
                binary, feats, memory: Optional[_Memory], **kw
                ) -> KeyframeResult:
        """One stream's result from its row of the outputs; its memory
        takes the row's features."""
        binary = _per_query_binary(binary, scores.shape[0])
        if memory is not None:
            memory.push(feats, binary, self.actor_threshold)
        # canvas pixels -> source-frame pixels
        sh, sw = src_hw
        boxes = np.clip(boxes / scale, 0, [sw, sh, sw, sh])
        dets = [Detection(box=boxes[q], actor_prob=float(binary[q]),
                          scores=scores[q])
                for q in range(len(binary))
                if binary[q] > self.actor_threshold]
        # keyframe = centre of the clip window
        key_idx = key_count - self.t_len * self.stride // 2
        return KeyframeResult(frame_index=key_idx, time_s=key_idx / self.fps,
                              detections=dets, **kw)

    def _run_detection(self) -> KeyframeResult:
        t0 = time.perf_counter()
        clip = np.stack(list(self._frames)[:: self.stride])[None]  # (1,T,H,W,3)
        mem, mmask, mem_size = self._memory_window(self.memory)
        with torch.inference_mode():
            outs = self._detect_core(clip, self._pad_mask()[None],
                                     mem[None], mmask[None])
        return self._result(
            self._frame_count, self._scale, self._src_hw,
            *(o[0] for o in outs), self.memory,
            latency_ms=(time.perf_counter() - t0) * 1e3,
            memory_size=mem_size)


def buckets(max_batch: int) -> List[int]:
    """The batch sizes ``StreamingDetectorPool.step`` runs: the powers of
    two below ``max_batch``, and ``max_batch``."""
    out, b = {max_batch}, 1
    while b < max_batch:
        out.add(b)
        b *= 2
    return sorted(out)


class StreamingDetectorPool:
    """Multi-stream serving: many concurrent video streams share one model,
    and all streams whose keyframe is due are detected in ONE padded
    batched forward per bucket (``buckets(max_batch)``).

    Usage: ``push_frame(stream_id, frame)`` per stream per tick, then
    ``step()`` — returns ``{stream_id: KeyframeResult}`` for every stream
    that fired. Per-stream rolling clip windows and (with ``cfg.use_lfb``)
    per-stream long-term memories are kept independently.

    Thread-safe: receiver threads may call ``push_frame`` /
    ``close_stream`` / ``set_deadline`` / ``set_priority`` while a scheduler
    thread calls ``step()``. The pool lock is not held across the device
    forward: each chunk's stream state is snapshotted under it, so frames
    keep flowing while a batch is on the card; a stream closed mid-forward
    drops its result. ``step`` enters ``torch.inference_mode`` on the
    calling thread.

    ``instrument=True`` splits each forward's latency into host assembly,
    upload (fenced by a device synchronisation) and execute + fetch; one
    dict per chunk lands in ``last_timing`` after every ``step()``. Under a
    mesh the upload is the rows' own, inside execute + fetch, and the batch's
    send (``broadcast_ms``) and the outputs' gather (``gather_ms``) stand
    beside them.

    Under a mesh (``StreamingDetector``'s ``mesh``) the pool lives on rank
    0, whose ``step`` and ``warmup`` lead every rank's forwards; the other
    ranks ``follow`` a detector of their own; ``stop_followers`` releases
    them. A forward that raises leaves the ranks out of step: end every
    process.
    """

    def __init__(self, cfg: Config, model: Optional[TubeR] = None, *,
                 max_batch: int = 8, detect_every: Optional[int] = None,
                 fps: float = 30.0, memory_keyframes: int = 10,
                 memory_slots: int = 5, actor_threshold: float = 0.8,
                 rng_seed: int = 0, device: torch.device | str = "cuda",
                 mesh=None, instrument: bool = False,
                 infer_chunk: Optional[int] = None):
        self.max_batch = max_batch
        self.instrument = instrument
        self.last_timing: List[Dict] = []
        # the template detector owns the model, the config and the prep
        self._tpl = StreamingDetector(
            cfg, model, detect_every=detect_every, fps=fps,
            memory_keyframes=memory_keyframes, memory_slots=memory_slots,
            actor_threshold=actor_threshold, rng_seed=rng_seed,
            device=device, mesh=mesh, infer_chunk=infer_chunk)
        self._mk = (memory_keyframes, memory_slots)
        self._streams: Dict = {}
        # guards _streams and all per-stream state (frame deques, cadence
        # counters, memories); never held across the device forward
        self._lock = threading.RLock()

    def warmup(self) -> None:
        """One forward of every bucket ``step()`` can run, so that the first
        live keyframe pays for no kernel build, no cuBLAS or cuDNN handle
        and no algorithm choice against its deadline (on every rank of a
        mesh, which follows these forwards)."""
        t = self._tpl
        l_mem = (t.memory.keyframes * t.memory.slots
                 if t.memory is not None else 1)
        for n in buckets(self.max_batch):
            with torch.inference_mode():
                t._detect_core(
                    np.zeros((n, t.t_len, t.img_size, t.img_size, 3),
                             np.uint8),
                    np.zeros((n, t.img_size, t.img_size), bool),
                    np.zeros((n, l_mem, t.cfg.model.d_model), np.float32),
                    np.ones((n, l_mem), bool))

    def stop_followers(self) -> None:
        """``StreamingDetector.stop_followers`` of the pool's model."""
        self._tpl.stop_followers()

    def _stream(self, sid) -> StreamingDetector:
        if sid not in self._streams:
            t = self._tpl
            s = StreamingDetector.__new__(StreamingDetector)
            s.__dict__.update(t.__dict__)      # share model and config
            s._frames = deque(maxlen=t.t_len * t.stride)
            s._frame_count = 0
            s._since_detect = 0
            s._src_hw = None
            s._scale = 1.0
            s._deadline_ms = None
            s._due_at = None
            s._priority = 0
            s.memory = (_Memory(self._mk[1], self._mk[0],
                                t.cfg.model.d_model)
                        if t.memory is not None else None)
            self._streams[sid] = s
        return self._streams[sid]

    def close_stream(self, sid) -> None:
        """Drop a finished stream's frame buffer and long-term memory. The
        pool never evicts on its own: a server with churning stream ids
        must close streams, or their canvases (~12 MB at 256 px, T=32,
        FRAME_RATE 2) accumulate."""
        with self._lock:
            self._streams.pop(sid, None)

    def set_deadline(self, sid, deadline_ms: Optional[float]) -> None:
        """Latency SLO for one stream: the most milliseconds between a
        keyframe becoming due and its detection being served. Within a
        priority class, streams with less slack are served first when more
        are due than one step serves (None = best effort, after every SLO
        stream)."""
        with self._lock:
            self._stream(sid)._deadline_ms = deadline_ms

    def set_priority(self, sid, priority: int) -> None:
        """Priority class for one stream (default 0; higher = served
        first): a priority-1 stream is admitted before any priority-0
        stream, even one about to miss its SLO; the deadline order applies
        within a class."""
        with self._lock:
            self._stream(sid)._priority = int(priority)

    def push_frame(self, sid, frame: np.ndarray) -> None:
        """Feed one frame of one stream (no detection yet; see step())."""
        with self._lock:
            s = self._stream(sid)
            s._frames.append(s._prep_frame(frame))
            s._frame_count += 1
            s._since_detect += 1
            window = s.t_len * s.stride
            if (s._due_at is None and len(s._frames) >= window
                    and s._since_detect >= s.detect_every):
                s._due_at = time.perf_counter()

    def _due(self) -> list:
        """Due streams: highest priority class first, then least remaining
        deadline slack (see set_priority / set_deadline)."""
        now = time.perf_counter()
        out = []
        for sid, s in self._streams.items():
            window = s.t_len * s.stride
            if (len(s._frames) >= window
                    and s._since_detect >= s.detect_every):
                waited = ((now - s._due_at) * 1e3
                          if s._due_at is not None else 0.0)
                slack = (float("inf") if s._deadline_ms is None
                         else s._deadline_ms - waited)
                out.append((-s._priority, slack, sid))
        out.sort(key=lambda p: p[:2])
        return [sid for _, _, sid in out]

    def _snapshot(self, chunk) -> list:
        """Under the lock: each live stream's clip, pad mask, memory window
        and the state its result needs."""
        t = self._tpl
        snaps = []
        with self._lock:
            for sid in chunk:
                s = self._streams.get(sid)
                if s is None:           # closed since _due()
                    continue
                mem, mmask, mem_size = t._memory_window(s.memory)
                snaps.append(dict(
                    sid=sid, clip=np.stack(list(s._frames)[:: s.stride]),
                    pad=s._pad_mask(), mem=mem, mmask=mmask,
                    mem_size=mem_size, frame_count=s._frame_count,
                    scale=s._scale, src_hw=s._src_hw,
                    since=s._since_detect, due_at=s._due_at,
                    deadline=s._deadline_ms))
        return snaps

    def step(self, max_chunks: Optional[int] = None) -> Dict:
        """Run padded batched detections over the due streams, in
        ``_due()`` order. ``max_chunks`` bounds the forwards per call
        (overflow streams stay due and lead the next step)."""
        with self._lock:
            due = self._due()
        self.last_timing = []
        if not due:
            return {}
        if max_chunks is not None:
            due = due[: max_chunks * self.max_batch]
        results: Dict = {}
        t = self._tpl
        for chunk_start in range(0, len(due), self.max_batch):
            snaps = self._snapshot(due[chunk_start:chunk_start
                                       + self.max_batch])
            n = len(snaps)
            if not n:
                continue
            bucket = min(b for b in buckets(self.max_batch) if b >= n)
            # spare rows: zero clips with the first stream's mask and memory
            fill = [dict(snaps[0], clip=np.zeros_like(snaps[0]["clip"]))
                    ] * (bucket - n)
            t0 = time.perf_counter()
            rows = snaps + fill
            batch = [np.stack([r[k] for r in rows])
                     for k in ("clip", "pad", "mem", "mmask")]
            t_assemble = time.perf_counter() - t0
            with torch.inference_mode():
                t_up = 0.0
                if self.instrument and t.mesh is None:
                    t1 = time.perf_counter()
                    batch = [torch.as_tensor(a, device=t.device)
                             for a in batch]
                    if t.device.type == "cuda":
                        torch.cuda.synchronize(t.device)
                    t_up = time.perf_counter() - t1
                t2 = time.perf_counter()
                outs = t._detect_core(*batch)
            lat = (time.perf_counter() - t0) * 1e3
            timing = {"bucket": bucket, "streams": n,
                      "assemble_ms": t_assemble * 1e3,
                      "upload_ms": t_up * 1e3,
                      "exec_fetch_ms": (time.perf_counter() - t2) * 1e3}
            if t.mesh is not None:
                # the rows' upload, forward and fetch on rank 0, beside the
                # batch's send and the outputs' gather
                x = t.last_exchange
                timing.update(exec_fetch_ms=x["rows_ms"],
                              broadcast_ms=x["broadcast_ms"],
                              gather_ms=x["gather_ms"])
            self.last_timing.append(timing)
            now = time.perf_counter()
            with self._lock:
                for i, snap in enumerate(snaps):
                    s = self._streams.get(snap["sid"])
                    if s is None:
                        continue        # closed mid-forward: drop result
                    # the cadence resets only once a result exists, so that
                    # a failed forward leaves its streams due; subtract the
                    # snapshot to keep frames pushed mid-forward
                    s._since_detect -= snap["since"]
                    s._due_at = None
                    due_at, dl = snap["due_at"], snap["deadline"]
                    waited = (now - due_at) * 1e3 if due_at is not None \
                        else 0.0
                    results[snap["sid"]] = t._result(
                        snap["frame_count"], snap["scale"], snap["src_hw"],
                        *(o[i] for o in outs), s.memory, latency_ms=lat,
                        memory_size=snap["mem_size"], waited_ms=waited,
                        deadline_met=None if dl is None else waited <= dl)
        return results


def follow(detector) -> int:
    """A rank other than 0 under a mesh: run rank 0's forwards, each on
    this rank's rows (``detector``: a ``StreamingDetector`` or a pool, on
    the same mesh and built with rank 0's arguments), until rank 0's
    ``stop_followers``. The header, batch, forward and gather of every
    step come in the order rank 0 sends them, warmup and padded buckets
    included; between steps the wait has no bound
    (``parallel.mesh.receive_batch``). Returns the number of forwards."""
    det = getattr(detector, "_tpl", detector)
    if det.mesh is None or mesh_lib.is_main_process():
        raise ValueError("follow runs on the ranks other than 0 of a mesh")
    n = 0
    while True:
        header, rows, split = mesh_lib.receive_batch(det.mesh)
        if header[0] == _STOP:
            mesh_lib.barrier()
            return n
        if header[2:] != det._header(_RUN, 0)[2:]:
            raise ValueError(f"rank {det.mesh.rank}: rank 0's detector "
                             f"differs from this one ({header} against "
                             f"{det._header(_RUN, header[1])})")
        with torch.inference_mode():
            outs = det._forward(*rows, *[None] * (4 - len(rows)))
        if split:
            mesh_lib.gather_rows(outs, det.mesh)
        n += 1
