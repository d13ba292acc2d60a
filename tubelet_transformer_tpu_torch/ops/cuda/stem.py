"""The fused irCSN stem: conv 3x7x7 / (1,2,2) + folded BN + ReLU + 1x3x3 /
(1,2,2) max-pool, channels-last in and out.

``stem_forward`` launches the hand-written kernel of ``csrc/stem.cu`` on a
CUDA tensor and takes ``stem_reference``, the plain PyTorch version, on a CPU
tensor. It replaces ``stem_forward`` of
``tubelet_transformer_tpu/ops/pallas/stem.py`` (its kernels ``_deinterleave``
and ``_stem_matmul(pool=True)``) and keeps that function's layouts:
x (B,T,H,W,3), w (3,7,7,3,64) as (kt, kh, kw, c_in, c_out), scale and bias
(64,), output (B,T,Hp,Wp,64).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tubelet_transformer_tpu_torch.ops.cuda.build import load_library

# kernel launches made by stem_forward in this process
LAUNCHES = 0

W_SHAPE = (3, 7, 7, 3, 64)
_ENTRY = {torch.bfloat16: "tuber_stem_pool_bf16",
          torch.float32: "tuber_stem_pool_f32"}


def library(verbose: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the stem kernel library."""
    lib = load_library("tuber_stem", ["stem.cu"], verbose=verbose)
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            # x, w, scale, bias, out; batch, frames, H, W; stream
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def pooled_hw(h: int, w: int) -> tuple[int, int]:
    """Output height and width of the stem for an (h, w) input."""
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (hc - 1) // 2 + 1, (wc - 1) // 2 + 1


def stem_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the conv in x's dtype, then affine, ReLU and
    max-pool in float32, and the result in x's dtype."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).to(x.dtype),
                 stride=(1, 2, 2), padding=(1, 3, 3))
    y = y.float() * scale.float()[:, None, None, None] \
        + bias.float()[:, None, None, None]
    y = F.max_pool3d(F.relu(y), (1, 3, 3), (1, 2, 2), (0, 1, 1))
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def check_inputs(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> None:
    """Raise ValueError unless the kernel takes these tensors as they are."""
    if x.dim() != 5 or x.shape[-1] != 3:
        raise ValueError(f"x must be (B,T,H,W,3), got {tuple(x.shape)}")
    if x.dtype not in _ENTRY:
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if tuple(w.shape) != W_SHAPE or w.dtype != x.dtype:
        raise ValueError(f"w must be {W_SHAPE} in {x.dtype}, got "
                         f"{tuple(w.shape)} in {w.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (64,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be (64,) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.shape[0] * x.shape[1] > 65535:
        raise ValueError(f"B*T must be <= 65535, got {x.shape[0] * x.shape[1]}")


def stem_forward(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """The fused stem: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. Raises for any other device or an input the kernel
    does not take."""
    global LAUNCHES
    if x.device.type == "cpu":
        return stem_reference(x, w, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"stem_forward runs on CPU or CUDA, not {x.device}")
    check_inputs(x, w, scale, bias)
    b, t, h, wd, _ = x.shape
    hp, wp = pooled_hw(h, wd)
    out = torch.empty((b, t, hp, wp, 64), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = getattr(library(), _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), b, t, h, wd,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem kernel launch failed with cudaError {err}")
    LAUNCHES += 1
    return out
