"""ctypes bindings for the native clip decoder (native/clipdec.cpp).

Auto-builds the shared library on first use if a toolchain is available;
falls back cleanly to the PIL path when not (``is_available()``). The
build runs in a directory of its own and the library is renamed into
place, so that processes building at once (the test workers of one run)
never load a half-written file. ctypes foreign calls release the GIL, so
the thread-pool DataLoader parallelizes decodes across cores.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from tubelet_transformer_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libclipdec.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH):
            try:
                _build()
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.tuber_jpeg_dims.restype = ctypes.c_int
        lib.tuber_decode_jpeg.restype = ctypes.c_int
        lib.tuber_decode_to_canvas.restype = ctypes.c_int
        _lib = lib
        return _lib


def _build() -> None:
    """native/build.sh on copies of its sources in a directory of its own
    under native/, then the library renamed into place (atomic)."""
    work = tempfile.mkdtemp(prefix=".build-", dir=_NATIVE_DIR)
    try:
        for name in ("build.sh", "clipdec.cpp"):
            shutil.copy(os.path.join(_NATIVE_DIR, name), work)
        subprocess.run(["sh", os.path.join(work, "build.sh")], check=True,
                       capture_output=True)
        os.replace(os.path.join(work, "libclipdec.so"), _LIB_PATH)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def is_available() -> bool:
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native clip decoder unavailable (no toolchain / build failed); "
            "check is_available() and use the PIL path")
    return lib


def jpeg_dims(data: bytes) -> Tuple[int, int]:
    """(width, height) of a JPEG buffer."""
    lib = _lib_or_raise()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.tuber_jpeg_dims(data, ctypes.c_ulong(len(data)),
                             ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError("corrupt JPEG")
    return w.value, h.value


def decode_jpeg(data: bytes, target_w: int, target_h: int) -> np.ndarray:
    """Decode + resize to (target_h, target_w, 3) uint8 RGB."""
    lib = _lib_or_raise()
    out = np.empty((target_h, target_w, 3), np.uint8)
    rc = lib.tuber_decode_jpeg(
        data, ctypes.c_ulong(len(data)), ctypes.c_int(target_w),
        ctypes.c_int(target_h), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError("corrupt JPEG")
    return out


_MEAN = np.ascontiguousarray(IMAGENET_MEAN, np.float32)
_STD = np.ascontiguousarray(IMAGENET_STD, np.float32)


def decode_to_canvas(data: bytes, valid_w: int, valid_h: int,
                     canvas: np.ndarray) -> None:
    """Fused decode -> resize -> normalize into a (Hc, Wc, 3) float32 canvas
    (top-left placement; caller zeroes the canvas)."""
    lib = _lib_or_raise()
    ch, cw = canvas.shape[:2]
    # the C side writes valid_h rows of valid_w*3 floats at canvas stride
    # with NO bounds checks — validate the invariants the pure-Python
    # pad_to_canvas enforces, or a bad call heap-corrupts a loader worker
    if valid_w > cw or valid_h > ch or valid_w <= 0 or valid_h <= 0:
        raise ValueError(f"valid ({valid_h}, {valid_w}) exceeds canvas "
                         f"({ch}, {cw})")
    if canvas.dtype != np.float32 or not canvas.flags["C_CONTIGUOUS"] \
            or canvas.shape[2:] != (3,):
        raise ValueError("canvas must be a C-contiguous float32 "
                         "(H, W, 3) array")
    rc = lib.tuber_decode_to_canvas(
        data, ctypes.c_ulong(len(data)), ctypes.c_int(valid_w),
        ctypes.c_int(valid_h), ctypes.c_int(cw), ctypes.c_int(ch),
        _MEAN.ctypes.data_as(ctypes.c_void_p),
        _STD.ctypes.data_as(ctypes.c_void_p),
        canvas.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError("corrupt JPEG")
