"""CUDA-event time of one call, the one measure that ``chip_smoke.py`` and
the tools under ``tools/`` give every kernel and plain version.

Imports torch and nothing of the port, so the A/B tool (``tools/ab.py``)
can load it by path beside a tree that lacks it.
"""

from __future__ import annotations

import statistics
import time

import torch


def time_ms(fn, warmup: int = 5, runs: int = 25, calls: int = 10,
            queued: bool = False) -> float:
    """Median over ``runs`` of the CUDA-event time of ``calls`` calls of
    ``fn`` in a row, per call, after ``warmup`` calls. Inputs stay in L2
    between calls where they fit.

    By default the calls run back to back: where one call's host work
    (checks, allocation, the ctypes call, the launch) outlasts its kernel,
    the host sets the pace, as it does on a model path. With ``queued`` each
    run's calls wait behind a spin kernel of twice their host time plus
    1 ms (at ~2e9 cycles a second), so the events time the device alone:
    the kernels and the gaps between them."""
    for _ in range(warmup):
        fn()
    if queued:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        spin = int((2 * calls * host + 1e-3) * 2e9)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)
