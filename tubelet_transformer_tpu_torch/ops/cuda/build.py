"""Build the port's CUDA sources into plain-C shared libraries and load them.

``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` at the repository root, one ``nvcc``
process for each source, all started together, then one link; the library
exports ``extern "C"`` functions that Python calls through ``ctypes``. The
hash in the file name covers the sources, the shared ``csrc/*.cuh`` headers
and the flags, so a library is rebuilt exactly when one of them changes.
Nothing is built at import time: the first call of a kernel's wrapper on a
CUDA tensor builds and loads ``kernels()``, the one library of every kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# the port's one kernel library and its sources
LIBRARY = "tuber_kernels"
SOURCES = ("stem.cu", "stem_stats.cu", "depthwise.cu", "stage.cu")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# seconds that nvcc took, for each library built by this process
BUILD_SECONDS: dict[str, float] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def load_library(name: str, sources: list[str],
                 verbose: bool = False) -> ctypes.CDLL:
    """Build ``lib<name>`` from ``csrc/<sources>`` unless the build for these
    sources exists, and load it. ``verbose`` prints nvcc's resource report
    (registers, shared memory, spills) when it builds."""
    with _lock:
        if name in _libs:
            return _libs[name]
        paths = [CSRC / s for s in sources]
        digest = hashlib.sha256()
        # the shared headers count too: a source may include any of them
        for p in paths + sorted(CSRC.glob("*.cuh")):
            digest.update(p.name.encode() + b"\0" + p.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in paths]
            ptxas = ("-Xptxas", "-v") if verbose else ()
            cmds = [[nvcc_path(), *NVCC_FLAGS, *ptxas, "-c", "-o", str(o),
                     str(p)] for p, o in zip(paths, objs)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for cmd in cmds]
            outputs = [(cmd, proc.communicate()[0], proc.returncode)
                       for cmd, proc in zip(cmds, procs)]
            link = [nvcc_path(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                    *map(str, objs)]
            if all(code == 0 for _, _, code in outputs):
                res = subprocess.run(link, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                outputs.append((link, res.stdout, res.returncode))
            for o in objs:
                o.unlink(missing_ok=True)
            for cmd, text, code in outputs:
                if code != 0:
                    raise RuntimeError(f"nvcc failed with code {code}: "
                                       f"{' '.join(cmd)}\n{text}")
            BUILD_SECONDS[name] = time.perf_counter() - t0
            if verbose:
                print("".join(text for _, text, _ in outputs), end="",
                      flush=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib


def kernels(verbose: bool = False) -> ctypes.CDLL:
    """The library of every kernel of the port, built at first use."""
    return load_library(LIBRARY, list(SOURCES), verbose=verbose)
