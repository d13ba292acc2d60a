"""One stride-1 identity ir-bottleneck of irCSN in one call, inference:
conv1x1 + affine + ReLU -> depthwise 3x3x3 + affine + ReLU -> conv1x1 +
affine -> + x -> ReLU: the stage chain's kernel (``csrc/stage.cu``) with
K = 1, launched through ``stage.run``. At K = 1 the chain reads x and
writes out with no intermediate rounding: mid and the depthwise output in
bf16, out rounded once to x's type, the function of the TPU kernel.

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

from typing import Sequence

import torch
import torch.nn.functional as F

from tubelet_transformer_tpu_torch.ops.cuda.depthwise import (
    depthwise_reference, plain_vjp)

# kernel launches (one per call), apart from the chain's own count, and
# calls of bottleneck_fused on any device, in this process
LAUNCHES = 0
CALLS = 0

DTYPES = (torch.bfloat16, torch.float32)


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


_NAMES = ("x", "w1", "wd", "w4", "a1", "b1", "a3", "b3", "a4", "b4")
# the kernel's types of (w1, wd, w4, a1, b1, a3, b3, a4, b4)
_DTYPES = (torch.bfloat16,) * 3 + (torch.float32,) * 6


def check_inputs(x, *params) -> None:
    """Raise ValueError unless the kernel takes these tensors as they are:
    x (B,T,H,W,Ci) and ``params`` = (w1, wd, w4, a1, b1, a3, b3, a4, b4); x
    bf16 or float32, weights bf16, affines float32, all contiguous on x's
    device and 16-byte aligned (the kernel copies every operand in 16-byte
    pieces), C_mid a multiple of 64, Ci of 128, work counts of 32 bits.
    Kept lean: it runs on every launch of a host-bound path."""
    if x.dim() != 5 or len(params) != 9:
        raise ValueError(f"want x (B,T,H,W,Ci) and 9 parameters, got "
                         f"{tuple(x.shape)} and {len(params)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    b, t, h, w, ci = x.shape
    cm = params[0].shape[-1]
    if cm % 64 or ci % 128:
        raise ValueError(f"C_mid must be a multiple of 64 and Ci of 128, "
                         f"got {cm} and {ci}")
    dev = x.device
    wants = ((x, x.shape, x.dtype), *zip(params, (
        (ci, cm), (3, 3, 3, cm), (cm, ci), (cm,), (cm,), (cm,), (cm,), (ci,),
        (ci,)), _DTYPES))
    for i, (p, shape, dtype) in enumerate(wants):
        if p.shape != shape or p.dtype != dtype:
            raise ValueError(f"{_NAMES[i]} must be {shape} {dtype}, got "
                             f"{tuple(p.shape)} {p.dtype}")
        if p.device != dev:
            raise ValueError(f"{_NAMES[i]} is on {p.device}, x on {dev}")
        if not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError(f"{_NAMES[i]} must be contiguous and 16-byte "
                             f"aligned")
    row_tiles = -(-(b * t * h * w) // 64)
    items = b * t * -(-h // 8) * -(-w // 8) * (cm // 64)
    if max(row_tiles * cm // 64, row_tiles * ci // 128, items) >= 2 ** 31:
        raise ValueError(f"x {tuple(x.shape)} needs 2^31 or more tiles")


def kernel_args(x, *params) -> tuple:
    """x and ``params`` as the kernels take them: the weights (w1, wd, w4)
    in bf16 and the affines in float32, contiguous; a tensor already so is
    passed on with no aten call."""
    return (x, *((p if p.dtype == dt else p.to(dt)).contiguous()
                 for p, dt in zip(params, _DTYPES)))


def _launch(x, *params) -> torch.Tensor:
    global LAUNCHES
    # stage imports this module at load time, so it is imported here
    from tubelet_transformer_tpu_torch.ops.cuda import stage

    check_inputs(x, *params)
    # one block's tensors are the memory of stacks with K = 1
    out = stage.run(x, params, 1)
    LAUNCHES += out.numel() > 0
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
    """The fused stride-1 identity ir-bottleneck: the CUDA kernel for a
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
    args = kernel_args(x, w1, wd, w4, a1, b1, a3, b3, a4, b4)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Bottleneck.apply(*args)
    return _launch(*args)
