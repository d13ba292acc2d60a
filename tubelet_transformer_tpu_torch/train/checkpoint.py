"""Checkpoints of the full training state, with ``torch.save``, and the
foreign weight files.

Port of ``tubelet_transformer_tpu/train/checkpoint.py``. ``ckpt_epoch_{N}``
(here one file, written to a temporary name and renamed, so that a name
without a suffix is always a whole checkpoint) holds the model's parameters
and BN statistics, the optimizer's state, the step and update counts and the
epoch. ``load_pretrained`` takes the reference's three foreign formats in
the reference's order: the Caffe2 CSN ``.mat`` backbone
(``load_backbone_mat``), the COCO DETR ``detr.pth`` seed
(``seed_from_detr``) and a TubeR ``.pth`` (``load_tuber_pth``: a released
checkpoint, with or without the DDP ``module.`` prefix, or the port's own
``ckpt_epoch_N``, whose ``model`` entry is in the same key scheme). Each
copies the tensors present on both sides, raises on a shape mismatch and
prints the counts, as the JAX loaders' ``_merge`` does. The JAX package's
orbax directories are not read: the port imports torch only.

Under data parallelism rank 0 alone writes a checkpoint (the ranks' states
are equal), and every rank waits for it at a barrier; every rank loads the
one path that rank 0 chose (``parallel.mesh.broadcast_string``). Under
ZeRO-1 every rank first takes part in the optimizer's ``state_dict``,
which gathers the sharded moments into ``torch.optim.AdamW``'s layout: the
file is the same with ZeRO-1 or without, and loads into either. Under
tensor parallelism (``MESH.MODEL``) every rank first takes part in
gathering the split parameters and their AdamW moments
(``parallel/sharding_rules.py``): rank 0 writes the one-process layout,
and every rank loads the whole file and keeps its slices, so a file
resumes at any ``MESH.MODEL``. With both (ZeRO-1 beside ``MESH.MODEL``) the
save gathers the moments over the data group first, then the split ones
over the model group; the load cuts the split moments to the peer's slice
first, then keeps the data slice. Under pipeline parallelism
(``MESH.PIPE``) the encoder layers are gathered over the pipe group too
and each stage keeps its own on the way in; the file records the PIPE it
was written under, and a full resume whose run has the other encoder
layout (pipelined or not, as JAX's stacked or sequential one) raises
ValueError naming MESH.PIPE, as the JAX package's does: weights alone
load across it (``load_pretrained``).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Mapping, Optional

import torch

from tubelet_transformer_tpu_torch import convert
from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.parallel import sharding_rules
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
    deletes all but the newest ``keep`` checkpoints of the directory. Under
    data parallelism rank 0 writes and deletes, and every rank returns the
    path once the file is there."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"ckpt_epoch_{epoch}"))
    # collectives under ZeRO-1 and MESH.MODEL: every rank gathers the
    # moments and the split parameters
    optimizer = sharding_rules.gather_optimizer_state(state.model,
                                                      state.optimizer)
    model = sharding_rules.gather_state(state.model)
    if mesh_lib.is_main_process():
        _write_checkpoint(ckpt_dir, path, state, model, optimizer, epoch,
                          max_accuracy, keep)
    mesh_lib.barrier()
    return path


def _write_checkpoint(ckpt_dir: str, path: str, state: TrainState,
                      model: dict, optimizer: dict, epoch: int,
                      max_accuracy: float, keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"model": model, "optimizer": optimizer,
               "step": state.step, "updates": int(state.updates),
               "epoch": epoch,
               "max_accuracy": float(max_accuracy),
               "pipe": _pipe_of(state.model)}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if keep > 0:
        done = sorted((os.path.join(ckpt_dir, d) for d in os.listdir(ckpt_dir)
                       if _is_committed_ckpt(d)), key=_epoch_of)
        for old in done[:-keep]:
            if os.path.abspath(old) != path:
                os.remove(old)


def _pipe_of(model: torch.nn.Module) -> int:
    """The pipe stages the model's encoder runs as (1 without a
    pipeline)."""
    pipe = model.transformer.pipe
    return 1 if pipe is None else pipe.pipe


def load_checkpoint(path: str, state: TrainState
                    ) -> tuple[TrainState, int, float]:
    """Restore ``path`` into ``state`` in place (this model peer's slices
    under MESH.MODEL, this stage's layers under MESH.PIPE); returns
    (state, epoch, max_accuracy). ValueError naming MESH.PIPE when the
    file was written with the encoder pipelined and the run's is not, or
    the other way round."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    written, run = payload.get("pipe", 1), _pipe_of(state.model)
    if (written > 1) != (run > 1):
        raise ValueError(
            f"cannot resume {path!r}: it was written under MESH.PIPE "
            f"{written}, the run's MESH.PIPE is {run} (the encoder "
            f"{'pipelined' if run > 1 else 'sequential'}). To continue "
            "training across a MESH.PIPE change, load weights only via "
            "MODEL.LOAD + MODEL.PRETRAINED_PATH (optimizer state restarts).")
    sharding_rules.load_full_state(state.model, payload["model"])
    state.optimizer.load_state_dict(sharding_rules.shard_optimizer_state(
        state.model, state.optimizer, payload["optimizer"]))
    state.step = payload["step"]
    state.updates = torch.tensor(payload["updates"], dtype=torch.long,
                                 device=device)
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


def _merge(dst: Mapping[str, torch.Tensor], src: Mapping[str, Any]) -> int:
    """Copy each entry of ``src`` whose name ``dst`` has into dst's tensor,
    in place and cast to its dtype; a shape mismatch raises ValueError.
    Returns the number copied."""
    n = 0
    with torch.no_grad():
        for k, v in src.items():
            if k not in dst:
                continue
            v = torch.as_tensor(v)
            if tuple(dst[k].shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch at {k}: "
                                 f"{tuple(dst[k].shape)} vs {tuple(v.shape)}")
            dst[k].copy_(v)
            n += 1
    return n


def _merge_model(model: torch.nn.Module, src: Mapping[str, Any]
                 ) -> tuple[int, int]:
    """``_merge`` into ``model``'s state; (parameters, BN statistics)
    copied."""
    sd = model.state_dict()
    stats = {n for n, _ in model.named_buffers()}
    return (_merge(sd, {k: v for k, v in src.items() if k not in stats}),
            _merge(sd, {k: v for k, v in src.items() if k in stats}))


# the long-term context's modules (CONFIG.USE_LFB), which the reference's
# checkpoints lack
LFB_MODULES = ("lfb_proj.", "lfb_attn.", "lfb_norm.")


def port_only(name: str) -> bool:
    """Whether the reference's key scheme lacks this entry: the long-term
    context's modules, an MoE encoder FFN (MODEL.MOE_EXPERTS) and the
    pre-norm encoder's final norm (MODEL.NORMALIZE_BEFORE)."""
    return (name.startswith(LFB_MODULES) or ".moe_ffn." in name
            or name.startswith("transformer.encoder.norm."))


def _wanted(model: torch.nn.Module, sd: Mapping[str, Any], prefixes=("",)
            ) -> dict:
    """The entries of ``sd`` for every parameter and statistic of ``model``
    under ``prefixes``; a missing one raises KeyError, as the JAX package's
    name-mapped conversion does. BN's ``num_batches_tracked`` is left out:
    the JAX variables have no such leaf, and the port never reads it. The
    weights the reference lacks (``port_only``) are taken when ``sd`` has
    them (the port's own checkpoint of such a run) and else keep their
    initial values, as the JAX package's loader keeps them for a reference
    checkpoint."""
    return {k: sd[k] for k in model.state_dict()
            if k.startswith(prefixes)
            and not k.endswith("num_batches_tracked")
            and (k in sd or not port_only(k))}


def load_tuber_pth(cfg: Config, model: torch.nn.Module,
                   path: Optional[str] = None) -> torch.nn.Module:
    """A TubeR checkpoint (``ckpt["model"]`` when present, ``module.``
    prefixes stripped) into ``model``: every weight of the model must be in
    the file; entries the model lacks are skipped."""
    path = path or cfg.model.pretrained_path
    sd = convert.strip_module_prefix(convert.load_torch_checkpoint(path))
    n_p, n_s = _merge_model(model, _wanted(model, sd))
    print(f"loaded TubeR checkpoint {path}: {n_p} params, {n_s} stats")
    return model


def load_backbone_mat(cfg: Config, model: torch.nn.Module,
                      path: Optional[str] = None) -> torch.nn.Module:
    """The Caffe2 CSN ``.mat`` backbone export into ``model``'s backbone."""
    path = path or cfg.model.pretrain_backbone_dir
    sd = convert.csn_state_from_mat(path, model.backbone.body.block_nums)
    n_p, n_s = _merge_model(model, sd)
    print(f"loaded CSN .mat {path}: {n_p} params, {n_s} stats")
    return model


def seed_from_detr(cfg: Config, model: torch.nn.Module,
                   path: Optional[str] = None) -> torch.nn.Module:
    """Seed the transformer, ``bbox_embed`` and the query embedding from
    COCO DETR's ``detr.pth`` (the reference's filter, model_utils.py:10-36):
    the query rows are the file's first ``n_q`` when it has that many, and
    stay as they are when it has fewer (JHMDB's Q x T = 320 queries against
    DETR's 100)."""
    path = path or cfg.model.pretrain_transformer_dir
    sd = convert.load_torch_checkpoint(path)
    n = sum(_merge_model(model, _wanted(model, sd,
                                        ("transformer.", "bbox_embed."))))
    q = sd["query_embed.weight"]
    dst = model.state_dict()["query_embed.weight"]
    if q.shape[0] >= dst.shape[0]:
        n += _merge({"query_embed.weight": dst},
                    {"query_embed.weight": q[:dst.shape[0]]})
    print(f"seeded from DETR {path}: {n} tensors")
    return model


def load_pretrained(cfg: Config, model: torch.nn.Module) -> torch.nn.Module:
    """The reference's load order: the backbone ``.mat`` if PRETRAINED,
    then the DETR seed if LOAD_DETR, then a TubeR checkpoint if LOAD with
    PRETRAINED_PATH. Nothing is loaded when no file is configured."""
    m = cfg.model
    if m.pretrained and m.pretrain_backbone_dir:
        load_backbone_mat(cfg, model)
    if m.load_detr and m.pretrain_transformer_dir:
        seed_from_detr(cfg, model)
    if m.load and m.pretrained_path:
        if os.path.isdir(m.pretrained_path):
            raise NotImplementedError(
                f"MODEL.PRETRAINED_PATH {m.pretrained_path} is a directory "
                "(an orbax checkpoint of the JAX package); the port reads "
                ".pth files and its own ckpt_epoch_N")
        load_tuber_pth(cfg, model)
    return model
