"""Several of the multi-rank checks in one torchrun launch: each rank
starts, imports and joins the process group once for all of them.

Run under torchrun, the checks separated by ``--then``, each named by its
tool (``dp_check``, ``tp_check``, ``serve_check``) and followed by that
tool's own arguments, as its command line takes them:

  python -m torch.distributed.run --nproc_per_node 2 \\
      -m tubelet_transformer_tpu_torch.tools.mesh_checks \\
      dp_check --config-file <yaml> --device cuda:0 --dist-backend gloo \\
          --deterministic --timed-steps 3 --zero1 --out build/dp.pt \\
      --then tp_check --config-file <yaml> --model 2 --device cuda:0 \\
          --dist-backend gloo --deterministic --dtypes bfloat16 \\
          --out build/tp.pt

The first check joins the process group with its ``--device`` and
``--dist-backend``; each writes its ``--out`` as it would alone, and
returns its cached device memory before the next; every rank marks the
wall-clock time at which it left the group. The
checks run in the order given, so settings one makes for the process
(``--float32`` and ``--dtypes float32`` turn TF32 off) hold for the
later ones.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import torch

from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.tools import dp_check, serve_check, tp_check

TOOLS = {"dp_check": dp_check.main, "tp_check": tp_check.main,
         "serve_check": serve_check.main}


def split(argv: List[str]) -> List[tuple]:
    """(tool, its arguments) of each check in ``argv``."""
    checks, current = [], []
    for a in argv + ["--then"]:
        if a != "--then":
            current.append(a)
            continue
        if not current or current[0] not in TOOLS:
            raise SystemExit(f"mesh_checks: a check must start with one of "
                             f"{sorted(TOOLS)}, got {current[:1]}")
        checks.append((current[0], current[1:]))
        current = []
    return checks


def main(argv: Optional[List[str]] = None) -> None:
    checks = split(sys.argv[1:] if argv is None else argv)
    try:
        for tool, args in checks:
            TOOLS[tool](args, keep_group=True)
            # the card is shared by every rank of every launch: hand back
            # the blocks this check's allocator keeps cached
            torch.cuda.empty_cache()
    finally:
        mesh_lib.shutdown()
    # every rank's end of work on the wall clock, which the launcher's own
    # (``chip_smoke.py:_torchrun_wait``) sets beside the launch's end
    dp_check.log_time(f"mesh_checks: the process group left at "
                      f"{time.time():.3f} (wall clock)", any_rank=True)


if __name__ == "__main__":
    main()
