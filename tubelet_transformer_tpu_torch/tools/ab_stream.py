"""A/B of the streaming keyframe latency of two source trees of the port.

Each run is one fresh process that builds the flagship streaming detector
(``configuration/tuber_csn152_ava22.yaml``, random weights from seed 0) from
one tree and pushes synthetic 240x320 frames at 8 fps through it, a
detection every 8 frames. Runs alternate A B B A A B ..., because the host
spreads the latency between processes by more than the differences sought;
both trees run in the same call on the same card. Prints one JSON line per
run (its steady median latency, the first two keyframes excluded), one per
tree (the median, quartiles, minimum and maximum of those medians) and the
number of pairs in which B ran faster than A.

Usage, on a GPU from the repository root, with the other tree unpacked
there (``git archive <commit> | tar -x -C build/parent``):
  python -m tubelet_transformer_tpu_torch.tools.ab_stream build/parent . \\
      [--pairs 10] [--keyframes 12]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def run_one(tree: str, keyframes: int) -> dict:
    """One run, in this process, of the port found under ``tree``."""
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
    return {"tree": tree, "steady_median_ms": statistics.median(lat[2:]),
            "latency_ms": [round(v, 3) for v in lat]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="*", help="tree A and tree B")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--keyframes", type=int, default=12)
    parser.add_argument("--one", default=None,
                        help="run once, in this process, from this tree")
    args = parser.parse_args()
    if args.one:
        print(json.dumps(run_one(args.one, args.keyframes)), flush=True)
        return
    if len(args.trees) != 2:
        parser.error("give two trees")
    trees = [os.path.abspath(t) for t in args.trees]
    medians = {t: [] for t in trees}
    for i in range(args.pairs):
        for tree in (trees if i % 2 == 0 else trees[::-1]):
            # this file runs as a script, so the package comes from the
            # tree on PYTHONPATH and not from the tree holding this file
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 "--keyframes", str(args.keyframes)],
                cwd=tree, env={**os.environ, "PYTHONPATH": tree},
                capture_output=True, text=True, check=True)
            line = json.loads(res.stdout.strip().splitlines()[-1])
            medians[tree].append(line["steady_median_ms"])
            print(json.dumps(line), flush=True)
    for tree, ms in medians.items():
        q1, _, q3 = statistics.quantiles(ms, n=4)
        print(json.dumps({"tree": tree, "runs": len(ms),
                          "median_ms": statistics.median(ms),
                          "q1_ms": q1, "q3_ms": q3,
                          "min_ms": min(ms), "max_ms": max(ms)}), flush=True)
    a, b = (medians[t] for t in trees)
    print(json.dumps({"pairs": args.pairs,
                      "b_faster": sum(y < x for x, y in zip(a, b))}),
          flush=True)


if __name__ == "__main__":
    main()
