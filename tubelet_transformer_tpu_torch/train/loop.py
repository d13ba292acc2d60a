"""Epoch-level orchestration: the training loop, AVA validation and
JHMDB/UCF24 validation.

Port of ``tubelet_transformer_tpu/train/loop.py``: the per-iteration body
is one train step (train/engine.py); validation feeds the numpy evaluators
of ``eval/ava_eval.py`` (frame mAP and person AP), or of
``eval/ucf_eval.py`` and ``eval/video_map.py`` (frame mAP over the key
frame's tubelet queries, and video mAP by tube linking).

Under data parallelism every rank runs the steps on its shard; the
metrics the steps return are global, and rank 0 alone prints, logs and
profiles them. Validation gathers each batch's detections and ground
truth from every rank in one host collective
(``parallel.mesh.gather_global_tree``; under ``MESH.MODEL`` and
``MESH.PIPE`` each data shard once, from its first rank), and rank 0
alone evaluates, dumps and plots; the other ranks return the losses
alone.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from tubelet_transformer_tpu_torch.eval.ava_eval import (
    AVADetectionEvaluator, PersonDetectionEvaluator, dump_detections_txt,
    load_excluded_keys)
from tubelet_transformer_tpu_torch import profiling
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.utils import AverageMeter, MetricsWriter
from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.train.engine import TrainState, device_batch

LOSS_KEYS = ("loss_ce", "loss_ce_b", "loss_bbox", "loss_giou")


def loss_ce_weight(cfg: Config, epoch: int) -> float:
    """The last layer's loss_ce weight, swapped after LOSS.WEIGHT_CHANGE."""
    return (cfg.loss.loss_change_cof if epoch > cfg.loss.weight_change
            else cfg.loss.dice_cof)


def train_one_epoch(cfg: Config, train_step, state: TrainState, loader,
                    epoch: int, writer: Optional[MetricsWriter] = None
                    ) -> Dict[str, float]:
    """One training epoch; returns the epoch's mean metrics. With
    ``LOG.PROFILE_STEPS`` N, epoch 0 traces steps 1..N (step 0 warms up)
    into ``<writer's log dir>/profile`` (train/loop.py:60-80 of the JAX
    package)."""
    loader.set_epoch(epoch)
    device = next(state.model.parameters()).device
    is_main = mesh_lib.is_main_process()
    prof_steps = cfg.log.profile_steps if epoch == 0 and is_main else 0
    prof = contextlib.ExitStack()

    def stop_trace():
        if prof_steps and device.type == "cuda":
            torch.cuda.synchronize(device)   # the queued steps, traced
        prof.close()

    ce_w = loss_ce_weight(cfg, epoch)
    meters = {k: AverageMeter(k) for k in
              ("total_loss", *LOSS_KEYS, "class_error")}
    data_time = AverageMeter("data")
    step_time = AverageMeter("step")
    n_batches = len(loader)
    end = time.time()
    for it, batch in enumerate(loader):
        if prof_steps and it == 1:
            prof.enter_context(profiling.trace(os.path.join(
                writer.log_dir if writer else ".", "profile")))
        elif prof_steps and it == 1 + prof_steps:
            stop_trace()
        data_time.update(time.time() - end)
        metrics = train_step(device_batch(batch, device), ce_w)
        if (it + 1) % cfg.log.display_freq == 0 or it + 1 == n_batches:
            metrics = {k: float(v) for k, v in metrics.items()}
            bs = batch["clips"].shape[0]
            for k, m in meters.items():
                m.update(metrics[k], bs)
            step_time.update(time.time() - end)
            if is_main:
                if not metrics["finite"]:
                    print(f"WARNING: non-finite loss at epoch {epoch} it "
                          f"{it}; update skipped")
                print(f"Epoch: [{epoch}][{it + 1}/{n_batches}] "
                      f"loss {meters['total_loss'].avg:.4f} "
                      f"ce {meters['loss_ce'].avg:.4f} "
                      f"bbox {meters['loss_bbox'].avg:.4f} "
                      f"giou {meters['loss_giou'].avg:.4f} "
                      f"ce_b {meters['loss_ce_b'].avg:.4f} "
                      f"data {data_time.avg:.3f}s "
                      f"step {step_time.avg:.3f}s", flush=True)
            if writer:
                for k, m in meters.items():
                    writer.add_scalar(f"train/{k}", m.val, state.step)
        end = time.time()
    stop_trace()
    return {k: m.avg for k, m in meters.items()}


def validate_ava(cfg: Config, eval_step, model: torch.nn.Module, loader,
                 epoch: int, writer: Optional[MetricsWriter] = None,
                 dump_dir: Optional[str] = None,
                 label_path: Optional[str] = None,
                 exclude_keys=()) -> Dict[str, float]:
    """AVA validation -> frame mAP and person AP (and the size-banded
    person APs of VAL.PERSON_SIZE_BANDS), with the mean criterion losses.
    ``dump_dir`` also writes every keyframe's detections once to
    ``<dump_dir>/0.txt`` (``dump_detections_txt``) and the per-class
    precision/recall panel beside it, ``pr_epoch_{epoch}.png``
    (``plots.plot_pr_curves``); without matplotlib the panel is skipped
    with a "PR plot skipped" line, as in the JAX package."""
    dataset = loader.dataset
    device = next(model.parameters()).device
    if not exclude_keys and cfg.data.exclude_path:
        exclude_keys = load_excluded_keys(cfg.data.exclude_path)
    evaluator = AVADetectionEvaluator(
        label_path=label_path or (cfg.data.label_path or None),
        class_num=cfg.data.num_classes, exclude_keys=exclude_keys)
    person_eval = PersonDetectionEvaluator()
    band_evals = [(lo, hi, PersonDetectionEvaluator(size_min=lo, size_max=hi))
                  for lo, hi in (cfg.val.person_size_bands or ())]
    loss_meters = {k: AverageMeter(k) for k in LOSS_KEYS}
    dump_rows, dumped_keys = [], set()
    is_main = mesh_lib.is_main_process()

    for batch in loader:
        out = eval_step(device_batch(batch, device))
        bs = batch["clips"].shape[0]
        for k, m in loss_meters.items():
            m.update(float(out["losses"][k]), bs)
        # the global batch, shard-major
        g = mesh_lib.gather_global_tree({
            **{k: out[k].float() for k in ("scores", "boxes", "binary")},
            "key_idx": batch["key_idx"], "sizes": batch["sizes"],
            **{f"gt_{k}": batch[k] for k in ("boxes", "labels", "valid")}},
            cfg.mesh.model * cfg.mesh.pipe)
        if not is_main:
            continue
        scores, boxes, binary = g["scores"], g["boxes"], g["binary"]
        for i in range(len(g["key_idx"])):
            idx = int(g["key_idx"][i])
            image_key = dataset.keys[idx].replace(",", "_") if hasattr(
                dataset, "keys") else f"idx_{idx}"
            evaluator.add_detections(image_key, boxes[i], scores[i])
            person_eval.add_detections(image_key, boxes[i], binary[i][:, 0])
            for _, _, bev in band_evals:
                bev.add_detections(image_key, boxes[i], binary[i][:, 0])
            # ground truth: normalised cxcywh -> absolute xyxy
            h, w = g["sizes"][i]
            gv = g["gt_valid"][i]
            cx, cy, bw, bh = g["gt_boxes"][i][gv].astype(np.float64).T
            gxyxy = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                              cy + bh / 2], 1) * np.array([w, h, w, h])
            evaluator.add_ground_truth(image_key, gxyxy,
                                       g["gt_labels"][i][gv])
            person_eval.add_ground_truth(image_key, gxyxy)
            for _, _, bev in band_evals:
                bev.add_ground_truth(image_key, gxyxy)
            # the loader's wrap-padded tail repeats samples: dump each once
            if dump_dir is not None and image_key not in dumped_keys:
                dumped_keys.add(image_key)
                dump_rows.extend(
                    (image_key, list(boxes[i][q]) + list(scores[i][q])
                     + [binary[i][q, 0]]) for q in range(boxes.shape[1]))

    result: Dict[str, float] = {k: m.avg for k, m in loss_meters.items()}
    if not is_main:
        return result
    if dump_dir is not None:
        os.makedirs(dump_dir, exist_ok=True)
        dump_detections_txt(os.path.join(dump_dir, "0.txt"), dump_rows)
        try:
            # the PR-curve panel next to the dump (the counterpart of the
            # reference's util/plot_utils.py:plot_precision_recall)
            from tubelet_transformer_tpu_torch.plots import plot_pr_curves
            plot_pr_curves(evaluator.precision_recall_curves(),
                           os.path.join(dump_dir, f"pr_epoch_{epoch}.png"))
        except Exception as exc:  # plotting must never fail validation
            print(f"PR plot skipped: {exc}")
    maps, _ = evaluator.evaluate()
    result["mAP"] = maps[0]
    result["person_AP"] = person_eval.evaluate()[0]
    print(f"Validation epoch {epoch}: frame mAP {result['mAP']:.4f} "
          f"person AP {result['person_AP']:.4f}", flush=True)
    if writer:
        writer.add_scalar("val/val_mAP_epoch", result["mAP"], epoch)
        writer.add_scalar("val/val_person_AP_epoch", result["person_AP"],
                          epoch)
    for lo, hi, bev in band_evals:
        tag = f"person_AP_size_{int(lo)}_{int(hi)}"
        result[tag] = bev.evaluate()[0]
        print(f"  person AP (area {int(lo)}..{int(hi)}): {result[tag]:.4f}")
        if writer:
            writer.add_scalar(f"val/{tag}", result[tag], epoch)
    return result


def validate_ucf(cfg: Config, eval_step, model: torch.nn.Module, loader,
                 epoch: int, writer: Optional[MetricsWriter] = None,
                 iou_thresholds=(0.5,),
                 video_map_thresholds=(0.2, 0.5)) -> Dict[str, float]:
    """JHMDB/UCF24 validation -> frame mAP over the key frame's tubelet
    queries, and video mAP by tube linking when the dataset carries its GT
    tubes. Each sample's Q queries at ``key_pos`` are sliced from the Q*T
    layout before scoring; the UCF evaluator applies the argmax/no-object
    and tiny-GT exclusion rules."""
    from tubelet_transformer_tpu_torch.eval.ucf_eval import (
        UCFDetectionEvaluator)
    from tubelet_transformer_tpu_torch.eval.video_map import (
        VideoMAPEvaluator)

    dataset = loader.dataset
    device = next(model.parameters()).device
    evaluator = UCFDetectionEvaluator(class_num=cfg.data.num_classes,
                                      iou_thresholds=iou_thresholds)
    q = cfg.model.query_num
    n_cls = cfg.data.num_classes
    do_video = bool(video_map_thresholds) and "gttubes" in getattr(
        dataset, "dataset", {})
    video_eval = (VideoMAPEvaluator(n_cls, video_map_thresholds)
                  if do_video else None)

    is_main = mesh_lib.is_main_process()
    for batch in loader:
        out = eval_step(device_batch(batch, device))
        # the global batch, shard-major
        g = mesh_lib.gather_global_tree({
            **{k: out[k].float() for k in ("scores", "boxes")},
            **{k: batch[k] for k in ("key_idx", "key_pos", "sizes", "vis")},
            **{f"gt_{k}": batch[k] for k in ("boxes", "labels", "valid")}},
            cfg.mesh.model * cfg.mesh.pipe)
        if not is_main:
            continue
        scores, boxes = g["scores"], g["boxes"]
        for i in range(len(g["key_idx"])):
            idx = int(g["key_idx"][i])
            if hasattr(dataset, "samples"):
                vid, fid = dataset.samples[idx]
                image_key = str(vid).replace("/", "_") + "-" + str(fid)
            else:
                image_key = f"idx_{idx}"
            kp = int(g["key_pos"][i])
            det_boxes = boxes[i][kp * q:(kp + 1) * q]
            det_scores = scores[i][kp * q:(kp + 1) * q]     # (Q, C+1)
            evaluator.add_detections(image_key, det_boxes, det_scores)

            if video_eval is not None:
                # the key frame's argmax-class detections for tube linking
                # (the frame evaluator's no-object rule)
                keep = np.argmax(det_scores, 1) != det_scores.shape[1] - 1
                if keep.any():
                    fg = det_scores[keep][:, :n_cls]
                    cls = np.argmax(fg, axis=1)
                    video_eval.add_frame_detections(
                        str(vid), int(fid), det_boxes[keep], cls,
                        fg[np.arange(len(cls)), cls])

            h, w = g["sizes"][i]
            gv = g["gt_valid"][i]
            gb = g["gt_boxes"][i][gv]
            if gb.size and int(g["vis"][i]):
                cx, cy, bw, bh = gb.T
                gxyxy = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                                  cy + bh / 2], 1) * np.array(
                                      [w, h, w, h], np.float64)
                onehot = np.zeros((len(gb), n_cls), np.float32)
                onehot[np.arange(len(gb)), g["gt_labels"][i][gv]] = 1.0
                evaluator.add_ground_truth(image_key, gxyxy, onehot)

    result: Dict[str, float] = {}
    if not is_main:
        return result
    maps, _ = evaluator.evaluate()
    for t, m in zip(iou_thresholds, maps):
        result[f"mAP@{t}"] = m
    result["mAP"] = maps[0]
    print(f"UCF/JHMDB validation epoch {epoch}: " + " ".join(
        f"mAP@{t}={m:.4f}" for t, m in zip(iou_thresholds, maps)),
        flush=True)
    if writer:
        writer.add_scalar("val/val_mAP_epoch", maps[0], epoch)
    if video_eval is not None:
        # GT tubes from the pickle, scaled to the frame the detections were
        # scaled to (the dataset's own resize policy)
        for v in {v for v, _ in dataset.samples}:
            oh, ow = dataset.dataset["resolution"][v]
            nh, nw = dataset._video_resize(v)
            sc = np.array([nw / ow, nh / oh, nw / ow, nh / oh])
            for ilabel, tubes in dataset.dataset["gttubes"][v].items():
                for tube in tubes:
                    video_eval.add_gt_tube(str(v), int(ilabel),
                                           tube[:, 0].astype(int),
                                           tube[:, 1:5] * sc)
        vmaps = video_eval.evaluate()
        for t, m in vmaps.items():
            result[f"video_mAP@{t}"] = m
        print("video-mAP: " + " ".join(f"@{t}={m:.4f}"
                                       for t, m in vmaps.items()), flush=True)
        if writer:
            for t, m in vmaps.items():
                writer.add_scalar(f"val/video_mAP@{t}", m, epoch)
    return result
