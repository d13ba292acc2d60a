"""Files in the released formats, written from the port's own weights and
random pixels, for checking the loaders and the JHMDB path where the
released files are absent: a Caffe2 CSN ``.mat`` backbone, a COCO DETR
``detr.pth``, a TubeR ``.pth`` and an ACT-detector JHMDB set
(``JHMDB-GT.pkl`` with PNG frames).

Each writer takes a state dict in the reference's key scheme (the port's
``model.state_dict()``) and reproduces the layout the released file has
(``train/torch_convert.py`` of the JAX package reads the same names).
"""

from __future__ import annotations

import os
import pickle
from typing import Mapping, Sequence

import numpy as np
import torch

from tubelet_transformer_tpu_torch.convert import MAT_START_COUNT


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else \
        np.asarray(t)


def write_csn_mat(path: str, sd: Mapping, block_nums,
                  prefix: str = "backbone.body.") -> str:
    """The CSN of ``sd`` as a Caffe2 ``.mat`` export: ``conv1_w``,
    ``comp_{n}_conv_{1,3,4}_w``, ``shortcut_projection_{n}_w`` and each
    BN's ``_s``/``_b``/``_rm``/``_riv`` (scale, bias, running mean, running
    variance), with n the flat block number of ``MAT_START_COUNT``."""
    import scipy.io as sio

    start = MAT_START_COUNT[tuple(block_nums)]
    blobs = {"conv1_w": _np(sd[f"{prefix}conv1.weight"])}

    def put_bn(name: str, ours: str) -> None:
        for blob, field in (("_s", "weight"), ("_b", "bias"),
                            ("_rm", "running_mean"), ("_riv", "running_var")):
            blobs[name + blob] = _np(sd[f"{prefix}{ours}.{field}"])

    put_bn("conv1_spatbn_relu", "bn1")
    for s, blocks in enumerate(tuple(block_nums)):
        for b in range(blocks):
            n, rp = start[s] + b, f"layer{s + 1}.{b}"
            for i in ("1", "3", "4"):
                blobs[f"comp_{n}_conv_{i}_w"] = _np(
                    sd[f"{prefix}{rp}.conv{i}.weight"])
                put_bn(f"comp_{n}_spatbn_{i}", f"{rp}.bn{i}")
            if b == 0:
                blobs[f"shortcut_projection_{n}_w"] = _np(
                    sd[f"{prefix}{rp}.down_sample.0.weight"])
                put_bn(f"shortcut_projection_{n}_spatbn",
                       f"{rp}.down_sample.1")
    sio.savemat(path, blobs)
    return path


def write_detr_pth(path: str, sd: Mapping, n_queries: int = 100,
                   seed: int = 0) -> str:
    """A COCO DETR checkpoint around the transformer and ``bbox_embed`` of
    ``sd``: ``{"model": ...}`` with ``n_queries`` query rows, a 92-way
    ``class_embed``, a 2-D ``input_proj`` and a ResNet stem entry (which a
    TubeR seed must skip)."""
    g = torch.Generator().manual_seed(seed)
    d = sd["query_embed.weight"].shape[1]
    model = {k: v.detach().float().cpu().clone() for k, v in sd.items()
             if k.startswith(("transformer.", "bbox_embed."))}
    model["query_embed.weight"] = torch.randn(n_queries, d, generator=g)
    model["class_embed.weight"] = torch.randn(92, d, generator=g)
    model["class_embed.bias"] = torch.zeros(92)
    model["input_proj.weight"] = torch.randn(d, 2048, 1, 1, generator=g)
    model["input_proj.bias"] = torch.zeros(d)
    model["backbone.0.body.conv1.weight"] = torch.randn(64, 3, 7, 7,
                                                        generator=g)
    torch.save({"model": model}, path)
    return path


def write_tuber_pth(path: str, sd: Mapping, ddp_prefix: bool = True) -> str:
    """A released-style TubeR checkpoint of ``sd``: ``{"model": ...}``,
    keys ``module.``-prefixed when ``ddp_prefix`` (saved from DDP)."""
    pre = "module." if ddp_prefix else ""
    torch.save({"model": {pre + k: v.detach().cpu().clone()
                          for k, v in sd.items()}, "epoch": 0}, path)
    return path


def write_jhmdb_set(root: str, train_videos: Sequence[str],
                    test_videos: Sequence[str], nframes: int,
                    num_classes: int = 21, hw=(240, 320), seed: int = 0
                    ) -> str:
    """An ACT-detector JHMDB set under ``root``: ``JHMDB-GT.pkl``
    (gttubes / nframes / resolution / labels / train_videos / test_videos)
    and ``rgb-images/<video>/{00001..}.png``, random pixels, each video one
    tube of a drifting box whose class is the video's index modulo
    ``num_classes``. Returns the frames' directory."""
    rng = np.random.default_rng(seed)
    from PIL import Image

    h, w = hw
    frames_dir = os.path.join(root, "rgb-images")
    gttubes, vids = {}, list(dict.fromkeys([*train_videos, *test_videos]))
    for i, v in enumerate(vids):
        t = np.arange(nframes, dtype=np.float32)
        x0 = 0.2 * w + 0.1 * w * np.sin(t / 5.0 + i)
        y0 = np.full(nframes, 0.25 * h + 3 * i, np.float32)
        tube = np.stack([t, x0, y0, x0 + 0.3 * w, y0 + 0.5 * h], 1)
        gttubes[v] = {i % num_classes: [tube.astype(np.float32)]}
        d = os.path.join(frames_dir, v)
        os.makedirs(d, exist_ok=True)
        for f in range(nframes):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                            ).save(os.path.join(d, f"{f + 1:05d}.png"))
    with open(os.path.join(root, "JHMDB-GT.pkl"), "wb") as f:
        pickle.dump({"train_videos": [list(train_videos)],
                     "test_videos": [list(test_videos)],
                     "nframes": {v: nframes for v in vids},
                     "resolution": {v: (h, w) for v in vids},
                     "gttubes": gttubes,
                     "labels": [f"class{c}" for c in range(num_classes)]}, f)
    return frames_dir
