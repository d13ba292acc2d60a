"""Training-curve plots from the metrics JSONL.

Counterpart of the reference's ``models/{detr,transformer}/util/plot_utils.py``
(COCO-DETR log plotting helpers, unused there) — rebuilt against our own
observability format: ``MetricsWriter`` JSONL scalars (utils.py:50-86),
which already carry the reference's tag names (``train/total_loss``,
``val/val_mAP_epoch``, ...).

Usage:
  python -m tubelet_transformer_tpu_torch.plots <metrics.jsonl|exp_dir> [-o out.png]

Design: one panel per metric family (losses / val quality / lr), one y-axis
per panel, fixed colorblind-safe series order (Okabe-Ito), recessive grid.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

# Okabe-Ito: the standard CVD-safe categorical set; assigned to tags in
# first-seen order and never cycled past 8 series per panel.
_PALETTE = ("#0072B2", "#E69F00", "#009E73", "#D55E00",
            "#CC79A7", "#56B4E9", "#F0E442", "#000000")


def load_metrics(path: str) -> Dict[str, Tuple[List[int], List[float]]]:
    """metrics.jsonl -> {tag: (steps, values)} (file or experiment dir)."""
    if os.path.isdir(path):
        for sub in ("metrics.jsonl", os.path.join("tb_log", "metrics.jsonl")):
            cand = os.path.join(path, sub)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"no metrics.jsonl (or tb_log/metrics.jsonl) under {path!r}")
    series: Dict[str, Tuple[List[int], List[float]]] = defaultdict(
        lambda: ([], []))
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                # a process killed mid-write leaves a truncated final line;
                # the post-crash plot is exactly when this tool is needed
                continue
            s = series[rec["tag"]]
            s[0].append(int(rec["step"]))
            s[1].append(float(rec["value"]))
    # resumed runs append overlapping step ranges: sort by step and keep
    # the LAST value per step so curves don't zigzag backwards
    out: Dict[str, Tuple[List[int], List[float]]] = {}
    for tag, (steps, values) in series.items():
        by_step = {}
        for st, v in zip(steps, values):
            by_step[st] = v
        ordered = sorted(by_step.items())
        out[tag] = ([st for st, _ in ordered], [v for _, v in ordered])
    return out


def _panel_of(tag: str) -> str:
    if "lr" in tag.lower() or "learning_rate" in tag.lower():
        return "learning rate"
    if tag.startswith("val"):
        return "validation"
    return "training loss"


def plot_training(path: str, out_path: str = "training_curves.png",
                  tags: Sequence[str] = (), dpi: int = 120) -> str:
    """Render loss / validation / lr panels to a PNG; returns out_path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = load_metrics(path)
    if tags:
        series = {t: series[t] for t in tags if t in series}
    if not series:
        raise ValueError(f"no metrics found in {path!r}")

    panels: Dict[str, List[str]] = defaultdict(list)
    for tag in series:
        panels[_panel_of(tag)].append(tag)

    fig, axes = plt.subplots(len(panels), 1,
                             figsize=(8, 2.8 * len(panels)), squeeze=False)
    for ax, (panel, panel_tags) in zip(axes[:, 0], sorted(panels.items())):
        for i, tag in enumerate(sorted(panel_tags)[:8]):
            steps, values = series[tag]
            # short series are invisible as bare lines — mark the points
            marker = "o" if len(steps) < 3 else None
            ax.plot(steps, values, color=_PALETTE[i], linewidth=1.5,
                    label=tag, marker=marker, markersize=5)
        ax.set_title(panel, fontsize=10, loc="left")
        ax.grid(True, linewidth=0.4, alpha=0.3)
        for spine in ("top", "right"):
            ax.spines[spine].set_visible(False)
        if len(panel_tags) > 1:
            ax.legend(fontsize=7, frameon=False)
        if panel == "training loss" and all(
                v > 0 for t in panel_tags for v in series[t][1]):
            # log scale only when EVERY value is positive — zeros/negatives
            # would be silently dropped from a log axis
            ax.set_yscale("log")
    axes[-1, 0].set_xlabel("step", fontsize=9)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
    return out_path


def plot_pr_curves(curves, out_path: str, names: Dict = {},
                   top_k: int = 8, dpi: int = 120) -> str:
    """Render {class_id: (precision, recall, AP)} curves to a PNG.

    Takes the output of `PascalMAPEvaluator.precision_recall_curves()` /
    `AVADetectionEvaluator.precision_recall_curves()`; plots the top-k
    classes by AP plus the running mAP in the title.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    scored = [(c, p, r, ap) for c, (p, r, ap) in curves.items()
              if not np.isnan(ap)]
    scored.sort(key=lambda x: -x[3])
    mean_ap = (float(np.mean([s[3] for s in scored]))
               if scored else float("nan"))

    fig, ax = plt.subplots(figsize=(6, 5))
    for i, (c, p, r, ap) in enumerate(scored[:top_k]):
        label = f"{names.get(c, c)} (AP {ap:.3f})"
        ax.plot(r, p, color=_PALETTE[i % len(_PALETTE)], linewidth=1.5,
                label=label)
    ax.set_xlabel("recall", fontsize=9)
    ax.set_ylabel("precision", fontsize=9)
    ax.set_xlim(0, 1.0)
    ax.set_ylim(0, 1.05)
    ax.set_title(f"precision-recall (top {min(top_k, len(scored))} classes; "
                 f"mAP {mean_ap:.4f})", fontsize=10, loc="left")
    ax.grid(True, linewidth=0.4, alpha=0.3)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    ax.legend(fontsize=7, frameon=False, loc="lower left")
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
    return out_path


def plot_precision_recall(gt_files: Sequence[str],
                          det_files: Sequence[str],
                          out_path: str = "pr_curves.png",
                          label_path: str = "",
                          class_num: int = 80,
                          top_k: int = 8,
                          dpi: int = 120) -> str:
    """Per-class precision-recall curves from validation txt dumps.

    Counterpart of the reference's `util/plot_utils.py:plot_precision_recall`
    (models/detr/util/plot_utils.py:68-99, which reads COCO eval pickles the
    reference pipeline never writes) — ours reads the per-rank `GT_*.txt` /
    `*.txt` dumps that `validate_ava` actually produces.
    """
    from tubelet_transformer_tpu_torch.eval.ava_eval import AVADetectionEvaluator

    ev = AVADetectionEvaluator(label_path=label_path or None,
                               class_num=class_num)
    ev.load_gt_from_files(list(gt_files))
    ev.load_detections_from_files(list(det_files))
    names = {}
    if label_path:
        from tubelet_transformer_tpu_torch.eval.labelmap import read_labelmap
        cats, _ = read_labelmap(label_path)
        names = {c["id"]: c["name"] for c in cats}
    return plot_pr_curves(ev.precision_recall_curves(), out_path,
                          names=names, top_k=top_k, dpi=dpi)


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description="Plot TubeR-TPU training curves")
    p.add_argument("path", nargs="?", default=None,
                   help="metrics.jsonl or experiment directory")
    p.add_argument("-o", "--out", default=None)
    p.add_argument("--tags", nargs="*", default=[])
    p.add_argument("--pr-gt", nargs="*", default=[],
                   help="GT txt dumps (GT_*.txt) for a PR-curve plot")
    p.add_argument("--pr-det", nargs="*", default=[],
                   help="detection txt dumps (*.txt) for a PR-curve plot")
    p.add_argument("--labelmap", default="", help="pbtxt labelmap for names")
    p.add_argument("--class-num", type=int, default=80)
    args = p.parse_args()
    if args.pr_gt or args.pr_det:
        if not (args.pr_gt and args.pr_det):
            p.error("--pr-gt and --pr-det must be given together")
        out = plot_precision_recall(args.pr_gt, args.pr_det,
                                    args.out or "pr_curves.png",
                                    label_path=args.labelmap,
                                    class_num=args.class_num)
    elif args.path:
        out = plot_training(args.path, args.out or "training_curves.png",
                            tags=args.tags)
    else:
        p.error("give a metrics path, or --pr-gt/--pr-det dump files")
        return
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
