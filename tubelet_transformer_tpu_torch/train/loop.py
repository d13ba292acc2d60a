"""Epoch-level orchestration: the training loop and AVA validation.

Port of ``tubelet_transformer_tpu/train/loop.py`` for one process: the
per-iteration body is one train step (train/engine.py); validation feeds the
shared numpy evaluators of ``tubelet_transformer_tpu/eval/ava_eval.py``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from tubelet_transformer_tpu.eval.ava_eval import (
    AVADetectionEvaluator, PersonDetectionEvaluator, load_excluded_keys)
from tubelet_transformer_tpu.utils import AverageMeter, MetricsWriter
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
    """One training epoch; returns the epoch's mean metrics."""
    loader.set_epoch(epoch)
    device = next(state.model.parameters()).device
    ce_w = loss_ce_weight(cfg, epoch)
    meters = {k: AverageMeter(k) for k in
              ("total_loss", *LOSS_KEYS, "class_error")}
    data_time = AverageMeter("data")
    step_time = AverageMeter("step")
    n_batches = len(loader)
    end = time.time()
    for it, batch in enumerate(loader):
        data_time.update(time.time() - end)
        metrics = train_step(device_batch(batch, device), ce_w)
        if (it + 1) % cfg.log.display_freq == 0 or it + 1 == n_batches:
            metrics = {k: float(v) for k, v in metrics.items()}
            if not metrics["finite"]:
                print(f"WARNING: non-finite loss at epoch {epoch} it {it}; "
                      "update skipped")
            bs = batch["clips"].shape[0]
            for k, m in meters.items():
                m.update(metrics[k], bs)
            step_time.update(time.time() - end)
            print(f"Epoch: [{epoch}][{it + 1}/{n_batches}] "
                  f"loss {meters['total_loss'].avg:.4f} "
                  f"ce {meters['loss_ce'].avg:.4f} "
                  f"bbox {meters['loss_bbox'].avg:.4f} "
                  f"giou {meters['loss_giou'].avg:.4f} "
                  f"ce_b {meters['loss_ce_b'].avg:.4f} "
                  f"data {data_time.avg:.3f}s step {step_time.avg:.3f}s",
                  flush=True)
            if writer:
                for k, m in meters.items():
                    writer.add_scalar(f"train/{k}", m.val, state.step)
        end = time.time()
    return {k: m.avg for k, m in meters.items()}


def validate_ava(cfg: Config, eval_step, model: torch.nn.Module, loader,
                 epoch: int, writer: Optional[MetricsWriter] = None,
                 label_path: Optional[str] = None,
                 exclude_keys=()) -> Dict[str, float]:
    """AVA validation -> frame mAP and person AP (and the size-banded
    person APs of VAL.PERSON_SIZE_BANDS), with the mean criterion losses."""
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

    for batch in loader:
        out = eval_step(device_batch(batch, device))
        bs = batch["clips"].shape[0]
        for k, m in loss_meters.items():
            m.update(float(out["losses"][k]), bs)
        scores, boxes, binary = (out[k].float().cpu().numpy()
                                 for k in ("scores", "boxes", "binary"))
        for i in range(bs):
            idx = int(batch["key_idx"][i])
            image_key = dataset.keys[idx].replace(",", "_") if hasattr(
                dataset, "keys") else f"idx_{idx}"
            evaluator.add_detections(image_key, boxes[i], scores[i])
            person_eval.add_detections(image_key, boxes[i], binary[i][:, 0])
            for _, _, bev in band_evals:
                bev.add_detections(image_key, boxes[i], binary[i][:, 0])
            # ground truth: normalised cxcywh -> absolute xyxy
            h, w = batch["sizes"][i]
            gv = batch["valid"][i]
            cx, cy, bw, bh = batch["boxes"][i][gv].astype(np.float64).T
            gxyxy = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                              cy + bh / 2], 1) * np.array([w, h, w, h])
            evaluator.add_ground_truth(image_key, gxyxy,
                                       batch["labels"][i][gv])
            person_eval.add_ground_truth(image_key, gxyxy)
            for _, _, bev in band_evals:
                bev.add_ground_truth(image_key, gxyxy)

    result: Dict[str, float] = {k: m.avg for k, m in loss_meters.items()}
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
