"""Device traces of the train loop (``LOG.PROFILE_STEPS``).

Port of ``tubelet_transformer_tpu/profiling.py`` over ``torch.profiler``:
``trace(logdir)`` records the CPU and, where there is a card, the CUDA
activity of the steps it wraps, and writes a Chrome trace
(``trace_<pid>_<ms>.json``, viewable in Perfetto or ``chrome://tracing``)
under ``logdir``. A profiler that fails to start or stop warns and the run
goes on, as the JAX package's does.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True) -> Iterator[None]:
    """Capture a torch.profiler trace into ``logdir`` (a no-op when
    disabled)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.start()
    except Exception as exc:  # a silent miss leaves an empty profile dir
        print(f"warning: torch.profiler failed to start "
              f"({type(exc).__name__}: {exc}); tracing disabled")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}"
                    ".json"))
            except Exception as exc:
                print(f"warning: torch.profiler failed to stop or write "
                      f"under {logdir!r} ({type(exc).__name__}: {exc}); the "
                      "trace may be missing")
