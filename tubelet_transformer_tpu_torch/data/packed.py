"""Packed-clip dataset: pre-decoded shards for TPU-scale input pipelines.

JPEG decode of 32 frames/sample is the host-side bottleneck (SURVEY §7 hard
part 5: ~5 samples/s/core with the native decoder). A v5e chip consumes
~74 clips/s in the fine-tune recipe, so feeding a pod slice from JPEGs needs
dozens of cores per chip. This module removes the decode from the training
path entirely (FFCV-style):

  * ``pack_ava``: one offline pass over an AVA split — decode every
    keyframe's clip at the aspect-preserving pre-resize resolution
    (exactly what ``AVADataset`` feeds its transforms) and append the raw
    uint8 pixels to large shard files, with annotations and byte offsets in
    a compact ``index.npz``;
  * ``PackedAVADataset``: a drop-in replacement for ``AVADataset`` whose
    ``get`` memory-maps the shard, slices the clip, and runs the same
    random geometric transforms — per-epoch augmentation randomness is
    preserved because the pack stores the *pre-transform* clip.

Reading is sequential-friendly (shards are append-ordered by key) and
~free on CPU: the remaining per-sample work is the crop/flip + canvas pad.
Photometric work already runs on-device (data/device_preprocess.py).

Storage: ~T*H*W*3 bytes/sample (13 MB at 288p/32f — video packing is a
disk-for-CPU trade; pack to local NVMe or per-host dataset shards).

Enable via ``DATA.PACKED_PATH`` ("{}" formats the split) after running
``python -m tubelet_transformer_tpu.cli.pack_data`` (the shard format is
the same in both packages).

The port's copy of ``tubelet_transformer_tpu/data/packed.py``: the AVA
pack and the per-video JHMDB/UCF24 pack.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.data import transforms as T
from tubelet_transformer_tpu_torch.data.ava import AVADataset

_INDEX = "index.npz"
_SHARD = "shard_{:04d}.bin"


def _decode_ahead(items, decode_fn, workers: int):
    """Order-preserving bounded decode-ahead over ``items``.

    Returns (iterator, shutdown_fn). With workers > 1, up to workers*2
    decodes run in flight on a thread pool (decoded clips are ~13 MB each,
    so the queue must stay bounded); otherwise decodes inline. Shared by
    both pack writers."""
    if workers <= 1:
        return map(decode_fn, items), (lambda: None)
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=workers)

    def gen():
        q: "deque" = deque()
        for it in items:
            q.append(pool.submit(decode_fn, it))
            if len(q) >= workers * 2:
                yield q.popleft().result()
        while q:
            yield q.popleft().result()

    return gen(), pool.shutdown


class _ShardWriter:
    """Sequential size-rotated shard writer recording (shard, offset,
    shape) per array — the byte layout both packed readers memmap."""

    def __init__(self, out_dir: str, shard_bytes: int):
        self.out_dir = out_dir
        self.shard_bytes = shard_bytes
        self.shard_id = 0
        self.off = 0
        self.f = open(os.path.join(out_dir, _SHARD.format(0)), "wb")
        self.rec_shard: List[int] = []
        self.rec_off: List[int] = []
        self.rec_shape: List[List[int]] = []

    def write(self, arr: np.ndarray) -> None:
        data = np.ascontiguousarray(arr).tobytes()
        if self.off and self.off + len(data) > self.shard_bytes:
            self.f.close()
            self.shard_id += 1
            self.off = 0
            self.f = open(os.path.join(self.out_dir,
                                       _SHARD.format(self.shard_id)), "wb")
        self.rec_shard.append(self.shard_id)
        self.rec_off.append(self.off)
        self.rec_shape.append(list(arr.shape[:3]))
        self.f.write(data)
        self.off += len(data)

    def close(self) -> None:
        self.f.close()

    def index_fields(self) -> Dict[str, np.ndarray]:
        # explicit dtypes/shapes so an EMPTY part (--num-parts > keys)
        # still writes (0,)/(0,3) arrays the multi-part reader concatenates
        return {"shard": np.asarray(self.rec_shard, np.int32),
                "offset": np.asarray(self.rec_off, np.int64),
                "shape": np.asarray(self.rec_shape,
                                    np.int32).reshape(-1, 3)}


def pack_ava(cfg: Config, split: str, out_dir: str,
             shard_bytes: int = 1 << 31, limit: Optional[int] = None,
             progress_every: int = 200, workers: int = 1,
             part: int = 0, num_parts: int = 1) -> str:
    """Decode an AVA split once and write packed shards + index to out_dir.

    ``workers`` threads decode ahead of the (sequential, order-preserving)
    shard writer — JPEG decode releases the GIL in the native path
    (ctypes.CDLL), so packing scales with host cores.

    ``num_parts``/``part`` split the key list into contiguous chunks so N
    machines can pack one split concurrently; each writes
    ``out_dir/part_{part:03d}`` and the reader reassembles every part under
    ``out_dir`` in order.
    """
    if num_parts > 1:
        out_dir = os.path.join(out_dir, f"part_{part:03d}")
    os.makedirs(out_dir, exist_ok=True)
    ds = AVADataset(cfg, split)
    keys = ds.keys[:limit] if limit else ds.keys
    if num_parts > 1:
        # contiguous chunks keep each part's keys video-ordered (probe cache)
        chunks = np.array_split(np.arange(len(keys)), num_parts)
        keys = [keys[i] for i in chunks[part]]

    box_off = [0]
    all_boxes: List[np.ndarray] = []
    all_labels: List[np.ndarray] = []

    # cache the frame-dir probes (directory scan + first-frame size) per
    # video; bounded so frame lists don't pile up across hundreds of videos
    from functools import lru_cache

    @lru_cache(maxsize=64)
    def _probe(vid: str):
        p = ds._probe_video(vid)
        if p is None:
            raise FileNotFoundError(f"no frames for {vid}")
        return p

    def _decode(frame_key: str):
        rec = ds.decode_record(frame_key,
                               probe=_probe(frame_key.split(",")[0]))
        clip, boxes, labels = rec
        return clip.astype(np.uint8, copy=False), boxes, labels

    records, shutdown = _decode_ahead(keys, _decode, workers)
    writer = _ShardWriter(out_dir, shard_bytes)
    for i, (frame_key, (clip, boxes, labels)) in enumerate(
            zip(keys, records)):
        writer.write(clip)
        all_boxes.append(boxes)
        all_labels.append(labels)
        box_off.append(box_off[-1] + boxes.shape[0])
        if progress_every and (i + 1) % progress_every == 0:
            print(f"packed {i + 1}/{len(keys)}", flush=True)

    writer.close()
    shutdown()
    np.savez_compressed(
        os.path.join(out_dir, _INDEX),
        keys=np.asarray(keys, dtype=str),
        **writer.index_fields(),
        box_off=np.asarray(box_off, np.int64),
        boxes=(np.concatenate(all_boxes) if box_off[-1]
               else np.zeros((0, 4), np.float32)),
        labels=(np.concatenate(all_labels) if box_off[-1]
                else np.zeros((0, cfg.data.num_classes), np.float32)),
        clip_len=np.int32(ds.clip_len),
        frame_rate=np.int32(ds.frame_rate),
        num_classes=np.int32(ds.num_classes),
        resize_size=np.int32(ds.resize_size))
    return out_dir


class PackedAVADataset(AVADataset):
    """AVA samples from packed shards — same output dicts, same transforms,
    no JPEG decode. Drop-in for ``AVADataset`` (set ``DATA.PACKED_PATH``)."""

    def __init__(self, cfg: Config, split: str,
                 packed_dir: Optional[str] = None):
        # mirror AVADataset.__init__ without touching the annotation JSON —
        # everything needed at read time lives in the pack index
        self.cfg = cfg
        self.split = split
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

        self.packed_dir = packed_dir or cfg.data.packed_path.format(split)
        # a pack is either one directory with index.npz, or a directory of
        # ``part_NNN`` subpacks written concurrently by several machines
        # (pack_ava num_parts) — reassembled here in part order
        if os.path.exists(os.path.join(self.packed_dir, _INDEX)):
            part_dirs = [self.packed_dir]
        else:
            from glob import glob as _glob

            part_dirs = sorted(_glob(os.path.join(self.packed_dir,
                                                  "part_*")))
            if not part_dirs:
                raise FileNotFoundError(
                    f"no {_INDEX} or part_*/ under {self.packed_dir!r}")
        self._dirs = part_dirs
        keys: List[str] = []
        dir_ids, shard_ids, offsets, shapes = [], [], [], []
        box_off: List[int] = [0]
        boxes_l, labels_l = [], []
        for d_i, d in enumerate(part_dirs):
            idx = np.load(os.path.join(d, _INDEX), allow_pickle=False)
            if len(idx["keys"]) == 0:
                # a part that got no keys (--num-parts > remaining work);
                # also tolerates the pre-fix writer's shapeless empty index
                continue
            # every pack-time knob the shards bake in must match the
            # config — a silent mismatch would feed clips the JPEG path
            # never produces
            for field, want in (("clip_len", self.clip_len),
                                ("frame_rate", self.frame_rate),
                                ("num_classes", self.num_classes),
                                ("resize_size", self.resize_size)):
                if field in idx and int(idx[field]) != want:
                    raise ValueError(
                        f"pack {d} was built with {field}="
                        f"{int(idx[field])}, config asks {want} "
                        f"(re-pack for this split)")
            n = len(idx["keys"])
            keys += [str(k) for k in idx["keys"]]
            dir_ids.append(np.full(n, d_i, np.int32))
            shard_ids.append(idx["shard"])
            offsets.append(idx["offset"])
            shapes.append(idx["shape"])
            base = box_off[-1]
            box_off.extend((idx["box_off"][1:] + base).tolist())
            boxes_l.append(idx["boxes"])
            labels_l.append(idx["labels"])
        if not dir_ids:
            raise ValueError(
                f"pack under {self.packed_dir!r} contains no samples "
                "(every part index is empty)")
        self.keys = keys
        self._dir_ids = np.concatenate(dir_ids)
        self._shard_ids = np.concatenate(shard_ids)
        self._offsets = np.concatenate(offsets)
        self._shapes = np.concatenate(shapes)
        self._box_off = np.asarray(box_off, np.int64)
        self._boxes = np.concatenate(boxes_l)
        self._labels = np.concatenate(labels_l)
        self._mmaps: Dict[Tuple[int, int], np.memmap] = {}

    def _shard(self, dir_id: int, sid: int) -> np.memmap:
        m = self._mmaps.get((dir_id, sid))
        if m is None:
            m = np.memmap(os.path.join(self._dirs[dir_id],
                                       _SHARD.format(sid)),
                          dtype=np.uint8, mode="r")
            self._mmaps[(dir_id, sid)] = m
        return m

    def _read_record(self, index: int):
        t, h, w = (int(v) for v in self._shapes[index])
        nbytes = t * h * w * 3
        off = int(self._offsets[index])
        raw = self._shard(int(self._dir_ids[index]),
                          int(self._shard_ids[index]))[off:off + nbytes]
        clip = np.asarray(raw).reshape(t, h, w, 3)
        b0, b1 = int(self._box_off[index]), int(self._box_off[index + 1])
        return clip, self._boxes[b0:b1].copy(), self._labels[b0:b1].copy()

    def _try_sample(self, index: int, rng: np.random.Generator):
        clip, boxes, labels = self._read_record(index)
        if boxes.shape[0] == 0:
            return None
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
        return self._finalize(clip, boxes, labels, self.keys[index], index)


# ---------------------------------------------------------------------------
# JHMDB / UCF24: per-VIDEO packing (samples are overlapping windows over
# every frame — packing per sample would duplicate each frame ~T times, so
# the pack stores each video's full resized frame stack once and the reader
# slices the boundary-padded window at read time).
# ---------------------------------------------------------------------------

def pack_jhmdb(cfg: Config, split: str, out_dir: str,
               shard_bytes: int = 1 << 31, limit: Optional[int] = None,
               progress_every: int = 50, workers: int = 1) -> str:
    """Decode a JHMDB/UCF split's videos once into packed shards + index."""
    from tubelet_transformer_tpu_torch.data.jhmdb import JHMDBDataset

    os.makedirs(out_dir, exist_ok=True)
    ds = JHMDBDataset(cfg, split)
    vids = list(dict.fromkeys(v for v, _ in ds.samples))  # ordered unique
    if limit:
        vids = vids[:limit]

    def _decode(vid: str) -> np.ndarray:
        from PIL import Image

        nh, nw = ds._video_resize(vid)
        nframes = ds.dataset["nframes"][vid]
        frames = []
        for i in range(nframes):
            path = os.path.join(cfg.data.data_path, vid,
                                "{:0>5}.png".format(i + 1))
            img = Image.open(path).convert("RGB")
            frames.append(np.asarray(img.resize((nw, nh))))
        return np.stack(frames).astype(np.uint8, copy=False)

    stacks, shutdown = _decode_ahead(vids, _decode, workers)
    writer = _ShardWriter(out_dir, shard_bytes)
    for i, (vid, stack) in enumerate(zip(vids, stacks)):
        writer.write(stack)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"packed {i + 1}/{len(vids)} videos", flush=True)
    writer.close()
    shutdown()
    np.savez_compressed(
        os.path.join(out_dir, _INDEX),
        vids=np.asarray(vids, dtype=str),
        **writer.index_fields(),
        resize_size=np.int32(ds.resize_size))
    return out_dir


class PackedJHMDBDataset:
    """JHMDB/UCF24 samples from per-video packed shards.

    Annotations still come from the (small) GT pickle via the base
    ``JHMDBDataset``; only the frame decode is replaced by a memmap slice.
    Built by delegation so the transforms / dummy-box / canvas logic stays
    in exactly one place.
    """

    def __new__(cls, cfg: Config, split: str,
                packed_dir: Optional[str] = None):
        from tubelet_transformer_tpu_torch.data.jhmdb import JHMDBDataset

        self = JHMDBDataset(cfg, split)
        packed_dir = packed_dir or cfg.data.packed_path.format(split)
        idx = np.load(os.path.join(packed_dir, _INDEX), allow_pickle=False)
        if int(idx["resize_size"]) != self.resize_size:
            raise ValueError(
                f"pack was built at resize {int(idx['resize_size'])}, "
                f"config asks {self.resize_size} (re-pack for this split)")
        vid_row = {str(v): i for i, v in enumerate(idx["vids"])}
        shard_ids, offsets, shapes = idx["shard"], idx["offset"], idx["shape"]
        mmaps: Dict[int, np.memmap] = {}

        def _shard(sid: int) -> np.memmap:
            m = mmaps.get(sid)
            if m is None:
                m = np.memmap(os.path.join(packed_dir, _SHARD.format(sid)),
                              dtype=np.uint8, mode="r")
                mmaps[sid] = m
            return m

        def _load_frames(vid: str, mid: int, nh: int, nw: int):
            row = vid_row.get(vid)
            if row is None:
                raise KeyError(f"video {vid!r} missing from pack "
                               f"{packed_dir!r}")
            t, h, w = (int(v) for v in shapes[row])
            if (h, w) != (nh, nw):
                raise ValueError(
                    f"pack stores {vid} at {h}x{w}, config asks {nh}x{nw} "
                    f"(re-pack for this split)")
            off = int(offsets[row])
            raw = _shard(int(shard_ids[row]))[off:off + t * h * w * 3]
            stack = np.asarray(raw).reshape(t, h, w, 3)
            return stack[np.asarray(self._clip_ids(vid, mid))]

        self._load_frames = _load_frames  # instance override
        return self
