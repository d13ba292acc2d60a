"""Checkpoints of the full training state, with ``torch.save``.

Port of the native half of ``tubelet_transformer_tpu/train/checkpoint.py``:
``ckpt_epoch_{N}`` (here one file, written to a temporary name and renamed,
so that a name without a suffix is always a whole checkpoint) holds the
model's parameters and BN statistics, the optimizer's state, the step and
update counts and the epoch. The foreign formats (the Caffe2 ``.mat``
backbone, ``detr.pth``, a released TubeR ``.pth``) are not ported yet:
``load_pretrained`` refuses them and is a no-op when none is configured.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

import torch

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.train.engine import TrainState


def _is_committed_ckpt(name: str) -> bool:
    """ckpt_epoch_<N> with an integer suffix (not a temporary file)."""
    return (name.startswith("ckpt_epoch_")
            and name.rsplit("_", 1)[1].isdigit())


def _epoch_of(path: str) -> int:
    return int(path.rsplit("_", 1)[1])


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int,
                    max_accuracy: float = 0.0, keep: int = 0) -> str:
    """Write ``ckpt_epoch_{epoch}`` under ``ckpt_dir``; ``keep`` > 0 then
    deletes all but the newest ``keep`` checkpoints of the directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"ckpt_epoch_{epoch}"))
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": state.step, "updates": state.updates, "epoch": epoch,
               "max_accuracy": float(max_accuracy)}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if keep > 0:
        done = sorted((os.path.join(ckpt_dir, d) for d in os.listdir(ckpt_dir)
                       if _is_committed_ckpt(d)), key=_epoch_of)
        for old in done[:-keep]:
            if os.path.abspath(old) != path:
                os.remove(old)
    return path


def load_checkpoint(path: str, state: TrainState
                    ) -> tuple[TrainState, int, float]:
    """Restore ``path`` into ``state`` in place; returns (state, epoch,
    max_accuracy)."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step, state.updates = payload["step"], payload["updates"]
    return state, payload["epoch"], payload["max_accuracy"]


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [d for d in os.listdir(ckpt_dir) if _is_committed_ckpt(d)]
    if not cands:
        return None
    return os.path.join(ckpt_dir, max(cands, key=_epoch_of))


def latest_checkpoint_any_run(base_path: str, save_dir: str = "checkpoints",
                              exp_name: str = "") -> Optional[str]:
    """Newest checkpoint across the timestamped run directories under
    ``base_path``; ``exp_name`` restricts the search to this experiment's
    runs (``{exp_name}_{%Y%m%d_%H%M%S}``)."""
    pat = f"{glob.escape(exp_name)}_*" if exp_name else "*"
    cands = [p for p in glob.glob(os.path.join(base_path, pat, save_dir,
                                               "ckpt_epoch_*"))
             if _is_committed_ckpt(os.path.basename(p))]
    if exp_name:
        rx = re.compile(re.escape(exp_name) + r"_\d{8}_\d{6}$")
        cands = [p for p in cands if rx.fullmatch(
            os.path.basename(os.path.dirname(os.path.dirname(p))))]
    if not cands:
        return None
    return max(cands, key=lambda p: (_epoch_of(p), os.path.getmtime(p)))


def load_pretrained(cfg: Config, model: torch.nn.Module) -> torch.nn.Module:
    """The reference's load order (backbone .mat if PRETRAINED, the DETR
    seed if LOAD_DETR, a TubeR checkpoint if LOAD with PRETRAINED_PATH):
    nothing is loaded when no file is configured."""
    m = cfg.model
    asked = {
        "MODEL.PRETRAIN_BACKBONE_DIR": m.pretrained and m.pretrain_backbone_dir,
        "MODEL.PRETRAIN_TRANSFORMER_DIR": (m.load_detr
                                           and m.pretrain_transformer_dir),
        "MODEL.PRETRAINED_PATH": m.load and m.pretrained_path,
    }
    for name, path in asked.items():
        if path:
            raise NotImplementedError(f"loading {name} ({path}) is not "
                                      "ported yet")
    return model
