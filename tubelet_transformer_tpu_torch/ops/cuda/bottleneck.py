"""One stride-1 identity ir-bottleneck of irCSN in one call, inference:
conv1x1 + affine + ReLU -> depthwise 3x3x3 + affine + ReLU -> conv1x1 +
affine -> + x -> ReLU, the kernels of ``csrc/bottleneck.cu``.

Replaces ``bottleneck_fused`` (its kernel ``_bottleneck_pallas``) of
``tubelet_transformer_tpu/ops/pallas/bottleneck.py``, with the same
arguments: x (B,T,H,W,Ci) channels-last, w1 (Ci,Cm), wd (3,3,3,Cm), w4
(Cm,Ci), and the folded BN affines a1, b1, a3, b3 (Cm,) and a4, b4 (Ci,).
The kernel takes the weights in bf16 and the affines in float32, as the
JAX function casts them, and returns x's dtype.

``bottleneck_fused`` launches the kernel on a CUDA tensor and takes the
plain PyTorch version (``bottleneck_reference``) on a CPU tensor. Its
gradient goes through the plain version, as the JAX package's custom VJP
goes through ``bottleneck_xla``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from tubelet_transformer_tpu_torch.ops.cuda import build
from tubelet_transformer_tpu_torch.ops.cuda.depthwise import (
    depthwise_reference, plain_vjp)

# kernel launches (one per call, its two kernels together), and calls of
# bottleneck_fused on any device, in this process
LAUNCHES = 0
CALLS = 0

_ENTRY = {torch.bfloat16: "tuber_bottleneck_bf16",
          torch.float32: "tuber_bottleneck_f32"}


def library(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library (``build.kernels``), with the bottleneck kernel's
    argument types set."""
    lib = build.kernels(verbose)
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            # x, w1, wd, w4, a1, b1, a3, b3, a4, b4, mid, out;
            # batch, frames, H, W, Ci, Cm; stream
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def bottleneck_supported(x_shape: Sequence[int], cm: int, stride: int,
                         tstride: int, has_downsample: bool) -> bool:
    """The JAX predicate's conditions, without its backend test: stride-1
    identity blocks, C_mid >= 128, frames of at least 1024 pixels."""
    _, _, h, w, _ = x_shape
    return (stride == 1 and tstride == 1 and not has_downsample
            and cm >= 128 and h * w >= 1024)


def bottleneck_reference(x, w1, wd, w4, a1, b1, a3, b3, a4, b4):
    """Plain PyTorch version of ``bottleneck_xla``: every step in x's
    dtype, the weights and affines cast to it."""
    dt = x.dtype
    m = F.relu(x @ w1.to(dt) * a1.to(dt) + b1.to(dt))
    m = depthwise_reference(m, wd.to(dt))
    m = F.relu(m * a3.to(dt) + b3.to(dt))
    y = m @ w4.to(dt) * a4.to(dt) + b4.to(dt)
    return F.relu(y + x)


def check_inputs(x, w1, wd, w4, a1, b1, a3, b3, a4, b4) -> None:
    """Raise ValueError unless the kernel takes these tensors as they are:
    x bf16 or float32, weights bf16, affines float32, all contiguous on
    x's device, C_mid a multiple of 64, Ci of 128."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B,T,H,W,Ci), got {tuple(x.shape)}")
    if x.dtype not in _ENTRY:
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    ci, cm = x.shape[-1], w1.shape[-1]
    if cm % 64 or ci % 128:
        raise ValueError(f"C_mid must be a multiple of 64 and Ci of 128, "
                         f"got {cm} and {ci}")
    want = {"w1": ((ci, cm), torch.bfloat16),
            "wd": ((3, 3, 3, cm), torch.bfloat16),
            "w4": ((cm, ci), torch.bfloat16),
            "a1": ((cm,), torch.float32), "b1": ((cm,), torch.float32),
            "a3": ((cm,), torch.float32), "b3": ((cm,), torch.float32),
            "a4": ((ci,), torch.float32), "b4": ((ci,), torch.float32)}
    tensors = dict(zip(want, (w1, wd, w4, a1, b1, a3, b3, a4, b4)))
    for name, (shape, dtype) in want.items():
        t = tensors[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    # 16-byte vector loads of x and w1, WMMA tiles of w4 in place
    align = {"x": 16, "w1": 16, "w4": 32}
    for name, t in {"x": x, **tensors}.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % align.get(name, 4):
            raise ValueError(f"{name} must be contiguous and "
                             f"{align.get(name, 4)}-byte aligned")
    b, t = x.shape[:2]
    if b > 65535 or t > 65535:
        raise ValueError(f"B and T must be <= 65535, got {tuple(x.shape)}")


def _launch(x, w1, wd, w4, a1, b1, a3, b3, a4, b4) -> torch.Tensor:
    global LAUNCHES
    check_inputs(x, w1, wd, w4, a1, b1, a3, b3, a4, b4)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    b, t, h, w, ci = x.shape
    cm = w1.shape[1]
    mid = torch.empty((b, t, h, w, cm), dtype=torch.bfloat16,
                      device=x.device)
    fn = getattr(library(), _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(*(p.data_ptr() for p in (x, w1, wd, w4, a1, b1, a3, b3, a4,
                                          b4, mid, out)),
                 b, t, h, w, ci, cm,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bottleneck kernel launch failed with cudaError "
                           f"{err}")
    LAUNCHES += 1
    return out


class _Bottleneck(torch.autograd.Function):
    """The kernel forward, and the backward through the plain version."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _launch(*args)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(bottleneck_reference, ctx.saved_tensors,
                         ctx.needs_input_grad, grad)


def bottleneck_fused(x, w1, wd, w4, a1, b1, a3, b3, a4, b4) -> torch.Tensor:
    """The fused stride-1 identity ir-bottleneck: the CUDA kernels for a
    CUDA tensor, with the weights cast to bf16 and the affines to float32
    (differentiable through the plain version), the plain version for a
    CPU tensor. Raises for any other device or an input the kernel does not
    take."""
    global CALLS
    CALLS += 1
    if x.device.type == "cpu":
        return bottleneck_reference(x, w1, wd, w4, a1, b1, a3, b3, a4, b4)
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_fused runs on CPU or CUDA, not "
                         f"{x.device}")
    args = (x, *(p.to(torch.bfloat16).contiguous() for p in (w1, wd, w4)),
            *(p.float().contiguous() for p in (a1, b1, a3, b3, a4, b4)))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Bottleneck.apply(*args)
    return _launch(*args)
