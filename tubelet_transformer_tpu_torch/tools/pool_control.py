"""The serving pool's two readings on the card, by stream frames and compute
dtype.

``chip_smoke.py`` serves 8 streams through the pool on the flagship stage
path and compares each stream's keyframes with a single detector on the
same model and frames (the sound reading) and with another stream's single
detector (the control, as a fault that hands a row another row's output
would show it); its limit must lie between the two. This tool takes the
same readings, without a limit, for two kinds of stream frames:

- ``noise``: uniform noise over the whole range, every stream at one level;
- ``levels``: ``chip_smoke.pool_frames``, noise at a per-stream brightness;

each on the model built in bf16 and in float32 (random weights from seed
0; TF32 off). Prints the card's name and power limit and one line per
reading.

Usage, on a GPU from the repository root:
  python -m tubelet_transformer_tpu_torch.tools.pool_control
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def noise_frames(i: int, h: int, w: int) -> list:
    """Stream ``i``'s 16 frames of uniform noise in [0, 256)."""
    rng = np.random.default_rng(100 + i)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(16)]


def main() -> None:
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.serving import StreamingDetectorPool

    if not torch.cuda.is_available():
        raise SystemExit("pool_control: no CUDA device")
    cs.phase_environment(torch)
    cs.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = cs.write_config("chip_smoke_stages.yaml", lambda c: c[
        "MODEL"].update(PALLAS_KERNELS=True, FUSED_BLOCKS=True,
                        FUSED_STAGES=True))
    kinds = {"noise": noise_frames, "levels": cs.pool_frames}
    kw = dict(fps=8.0, detect_every=8, actor_threshold=-1.0, device="cuda")
    for dtype in ("bfloat16", "float32"):
        cfg = load_config(str(path))
        cfg.model.compute_dtype = dtype
        model = build_model(cfg, device="cuda", seed=0)
        for kind, make in kinds.items():
            frames = [make(i, h, w)
                      for i, (h, w) in enumerate(cs.POOL_GEOMETRIES)]
            pool = StreamingDetectorPool(cfg, model, max_batch=8, **kw)
            results, _ = cs._drive_pool(pool, frames)
            cs._pool_against_single(cfg, model, kw, frames, results, None,
                                    f"{dtype} {kind}")
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
