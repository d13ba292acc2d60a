"""A/B of two source trees of the port on one card, in alternating processes.

Each run is one fresh process that imports the port from one tree (its
kernels built from that tree's sources) and measures one of two things:

- by default, the streaming keyframe latency: the flagship streaming
  detector (``configuration/tuber_csn152_ava22.yaml``, random weights from
  seed 0) on synthetic 240x320 frames at 8 fps, a detection every 8 frames;
  its steady median latency, the first two keyframes excluded;
- with ``--train-steps N``, the flagship fine-tune step (TUNE_POINT 4,
  bf16, batch 2, random weights from seed 0, the synthetic set's first
  batch): the median of N steady steps, each ending in a synchronise,
  and from one more step under ``torch.profiler`` its device kernel time,
  its kernel launches and the busy share (device time over the steady
  step);
- with ``--calls FILE:FUNC[,FUNC...]``, wrapper calls: each FUNC of FILE
  (a Python file read from this tree, so both trees run the same calls;
  ``tools/kernel_calls.py`` holds the kernels at their main-path shapes)
  takes no argument and returns ``{name: call}``, calls of no argument
  that import the port from the tree under test. Each call is timed by
  ``tools/timing.py:time_ms`` two ways: ``call`` back to back, host work
  included, and ``device`` on the device alone.

Runs alternate A B B A A B ..., because the host spreads times between
processes by more than the differences sought; both trees run in the same
call on the same card. Prints the card's name and power limit, one JSON
line per run, one per tree (the median, quartiles, minimum and maximum of
each number over its runs) and, for each number, the pairs in which B took
less than A.

Usage, on a GPU from the repository root, with the other tree unpacked
there (``git archive <commit> | tar -x -C build/parent``):
  python -m tubelet_transformer_tpu_torch.tools.ab build/parent . \\
      [--pairs 10] [--keyframes 12] \\
      [--calls tubelet_transformer_tpu_torch/tools/kernel_calls.py:bottleneck]
      [--train-steps 8]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _load(path: str):
    """The module at ``path``, loaded by file: neither it nor the tree under
    test need the other's copy of it."""
    name = f"_ab_{Path(path).stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def stream(tree: str, keyframes: int) -> dict:
    """The steady median keyframe latency of the port found under
    ``tree``, and every keyframe's latency."""
    import numpy as np
    import torch

    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.serving import StreamingDetector

    cfg = load_config(os.path.join(tree, "configuration",
                                   "tuber_csn152_ava22.yaml"))
    det = StreamingDetector(cfg, fps=8.0, detect_every=8, rng_seed=0,
                            actor_threshold=-1.0, device="cuda")
    rng = np.random.default_rng(0)
    lat = []
    for _ in range(64 + 8 * keyframes):
        res = det.push_frame(rng.integers(0, 256, (240, 320, 3),
                                          dtype=np.uint8))
        if res is not None:
            lat.append(res.latency_ms)
    torch.cuda.synchronize()
    return {"steady_median_ms": statistics.median(lat[2:]),
            "latency_ms": [round(v, 3) for v in lat]}


def train(tree: str, steps: int) -> dict:
    """The flagship fine-tune step of the port found under ``tree``: its
    steady median ms over ``steps`` steps after two, then one profiled
    step's device time, launches and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tubelet_transformer_tpu_torch.cli import runner
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import engine

    cfg = load_config(os.path.join(tree, "configuration",
                                   "tuber_csn152_ava22.yaml"))
    cfg.data.dataset_name, cfg.data.synthetic_size = "synthetic", 8
    cfg.data.label_path = ""
    cfg.model.pretrained = True      # the recipe's freezing; random weights
    batches = iter(runner.make_loaders(cfg)[0])
    batch = engine.device_batch(next(batches), torch.device("cuda"))
    batches.close()
    model = build_model(cfg, device="cuda", seed=0, train=True)
    step = engine.make_train_step(cfg, engine.create_train_state(
        cfg, model, steps_per_epoch=steps + 3))
    ms = []
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step(batch, cfg.loss.dice_cof)
        torch.cuda.synchronize()
        if i >= 2:
            ms.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch, cfg.loss.dice_cof)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    device_ms = sum(ev.device_time_total for ev in prof.events()
                    if ev.device_type == cuda) / 1e3
    steady = statistics.median(ms)
    return {"train_step_ms": steady, "device_ms": device_ms,
            "busy": device_ms / steady,
            "launches": sum(ev.count for ev in prof.key_averages()
                            if ev.device_type == cuda),
            "finite": float(metrics["finite"]),
            "step_ms": [round(v, 3) for v in ms]}


def calls(spec: str) -> dict:
    """Both times of every call that the functions named in ``spec``
    (``FILE:FUNC[,FUNC...]``) return."""
    path, names = spec.rsplit(":", 1)
    timing = _load(str(Path(__file__).with_name("timing.py")))
    module = _load(path)
    out = {}
    for func in names.split(","):
        for name, fn in getattr(module, func)().items():
            out[f"{name} call ms"] = timing.time_ms(fn)
            out[f"{name} device ms"] = timing.time_ms(fn, queued=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="*", help="tree A and tree B")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--keyframes", type=int, default=12)
    parser.add_argument("--calls", default=None,
                        help="FILE:FUNC[,FUNC...]: time these calls, not "
                             "the streaming latency")
    parser.add_argument("--train-steps", type=int, default=0,
                        help="time this many fine-tune steps, not the "
                             "streaming latency")
    parser.add_argument("--one", default=None,
                        help="run once, in this process, from this tree")
    args = parser.parse_args()
    if args.one:
        run = (calls(args.calls) if args.calls
               else train(args.one, args.train_steps) if args.train_steps
               else stream(args.one, args.keyframes))
        print(json.dumps({"tree": args.one, **run}), flush=True)
        return
    if len(args.trees) != 2:
        parser.error("give two trees")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = [os.path.abspath(t) for t in args.trees]
    extra = ["--keyframes", str(args.keyframes), "--train-steps",
             str(args.train_steps)]
    if args.calls:
        extra += ["--calls", os.path.abspath(args.calls)]
    runs = {t: [] for t in trees}
    for i in range(args.pairs):
        for tree in (trees if i % 2 == 0 else trees[::-1]):
            # this file runs as a script, so the package comes from the
            # tree on PYTHONPATH and not from the tree holding this file
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 *extra],
                cwd=tree, env={**os.environ, "PYTHONPATH": tree},
                capture_output=True, text=True, check=True)
            line = json.loads(res.stdout.strip().splitlines()[-1])
            runs[tree].append(line)
            print(json.dumps(line), flush=True)
    # every number of any run, in order (a call may exist in one tree only)
    keys = list(dict.fromkeys(k for rs in runs.values() for r in rs
                              for k, v in r.items()
                              if isinstance(v, (int, float))))
    for tree, rs in runs.items():
        summary = {}
        for k in keys:
            vals = [r[k] for r in rs if k in r]
            if not vals:
                continue
            q1, _, q3 = (statistics.quantiles(vals, n=4) if len(vals) > 1
                         else (vals[0],) * 3)
            summary[k] = {"median": statistics.median(vals), "q1": q1,
                          "q3": q3, "min": min(vals), "max": max(vals)}
        print(json.dumps({"tree": tree, "runs": len(rs), **summary}),
              flush=True)
    a, b = (runs[t] for t in trees)
    print(json.dumps({"pairs": args.pairs, "b_less": {
        k: sum(y[k] < x[k] for x, y in zip(a, b)) for k in keys
        if all(k in r for r in a + b)}}), flush=True)


if __name__ == "__main__":
    main()
