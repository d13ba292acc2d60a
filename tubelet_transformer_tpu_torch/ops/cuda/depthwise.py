"""Depthwise 3x3x3 conv, stride 1, zero padding 1, channels-last: the
kernel of ``csrc/depthwise.cu``.

Replaces ``_dw_pallas`` (the bare conv) and ``_dw_pallas_v2`` (with the
fused ``relu(y * scale + bias)`` epilogue) of
``tubelet_transformer_tpu/ops/pallas/depthwise.py``, and its dispatch
``depthwise_conv3x3x3`` (stride 1 and C < 128, without the TPU test).
Layouts are the JAX functions': x (B,T,H,W,C), w (3,3,3,C), scale and bias
(C,) float32.

``depthwise_conv3x3x3`` launches the kernel on a CUDA tensor and takes the
plain PyTorch version (``depthwise_reference``) on a CPU tensor. Its
gradient goes through the plain version, as the JAX package's custom VJP
goes through XLA's conv (depthwise.py:133-142 there).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from tubelet_transformer_tpu_torch.ops.cuda import build

# kernel launches, and calls of depthwise_conv3x3x3 on any device, in this
# process
LAUNCHES = 0
CALLS = 0

_ENTRY = {torch.bfloat16: "tuber_depthwise_bf16",
          torch.float32: "tuber_depthwise_f32"}
# channels in one 16-byte vector of the kernel, and in one block's slice
_VEC = {torch.bfloat16: 8, torch.float32: 4}
_SLICE = {torch.bfloat16: 32, torch.float32: 16}
# output frames of one block
_RUN = 8
# the bound entry point of each type, once the library is loaded
_FNS: dict = {}


def library(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library (``build.kernels``), with the depthwise kernel's
    argument types set."""
    lib = build.kernels(verbose)
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            # x, w, scale, bias, out; batch, frames, H, W, C, relu; stream
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def depthwise_supported(shape: Sequence[int], stride: Sequence[int]) -> bool:
    """The JAX dispatch's conditions: stride 1 and C < 128."""
    return tuple(stride) == (1, 1, 1) and shape[-1] < 128


def depthwise_reference(x: torch.Tensor, w: torch.Tensor,
                        scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv3d(groups=C)`` on a channels-first
    copy in x's dtype (cuDNN's grouped conv is ~29x slower on the
    channels-last view, ``models/csn.py``), then ``y * scale + bias`` (when
    given) and the ReLU (when asked) in float32; the result in x's dtype,
    channels-last."""
    c = x.shape[-1]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).contiguous(),
                 w.permute(3, 0, 1, 2).unsqueeze(1).to(x.dtype), padding=1,
                 groups=c).permute(0, 2, 3, 4, 1)
    if scale is not None:
        y = y.float() * scale.float() + bias.float()
    if relu:
        y = F.relu(y)
    return y.to(x.dtype).contiguous()


def plain_vjp(fn: Callable, inputs: Sequence[Optional[torch.Tensor]],
              needs: Sequence[bool], grad: torch.Tensor, **kwargs) -> tuple:
    """Gradients of ``fn(*inputs, **kwargs)`` for ``grad``, with autograd
    through ``fn``: one per input, None where ``needs`` is false or the
    input is None. The backward of the port's kernels."""
    inputs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(inputs, needs)]
    wanted = [t for t in inputs if t is not None and t.requires_grad]
    if not wanted:
        return (None,) * len(inputs)
    with torch.enable_grad():
        out = fn(*inputs, **kwargs)
    grads = iter(torch.autograd.grad(out, wanted, grad))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in inputs)


def check_inputs(x: torch.Tensor, w: torch.Tensor,
                 scale: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor]) -> None:
    """Raise ValueError unless the kernel takes these tensors as they are.
    Every call of the kernel runs it, so it reads each property once."""
    shape, dtype, device = x.shape, x.dtype, x.device
    if len(shape) != 5:
        raise ValueError(f"x must be (B,T,H,W,C), got {tuple(shape)}")
    vec = _VEC.get(dtype)
    if vec is None:
        raise ValueError(f"x must be bfloat16 or float32, got {dtype}")
    b, t, _, _, c = shape
    if c % vec:
        raise ValueError(f"C must be a multiple of {vec} for {dtype}, got "
                         f"{c}")
    if w.shape != (3, 3, 3, c) or w.dtype != dtype:
        raise ValueError(f"w must be (3,3,3,{c}) in {dtype}, got "
                         f"{tuple(w.shape)} in {w.dtype}")
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias come together")
    tensors = (("x", x), ("w", w))
    if scale is not None:
        tensors += (("scale", scale), ("bias", bias))
        for name, a in tensors[2:]:
            if a.shape != (c,) or a.dtype != torch.float32:
                raise ValueError(f"{name} must be ({c},) float32, got "
                                 f"{tuple(a.shape)} {a.dtype}")
    for name, a in tensors:
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, x on {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (vector loads)")
    slice_c = _SLICE[dtype]
    if b > 65535 or -(-t // _RUN) * -(-c // slice_c) > 65535:
        raise ValueError(f"B must be <= 65535 and ceil(T/{_RUN})*ceil(C/"
                         f"{slice_c}) too, got {tuple(shape)}")


def _launch(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
            bias: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    global LAUNCHES
    check_inputs(x, w, scale, bias)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    b, t, h, wd, c = x.shape
    fn = _FNS.get(x.dtype)
    if fn is None:
        fn = _FNS[x.dtype] = getattr(library(), _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 b, t, h, wd, c, int(relu),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"depthwise kernel launch failed with cudaError "
                           f"{err}")
    LAUNCHES += 1
    return out


class _Depthwise(torch.autograd.Function):
    """The kernel forward, and the backward through the plain version."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, relu):
        ctx.relu = relu
        ctx.save_for_backward(x, w, scale, bias)
        return _launch(x, w, scale, bias, relu)

    @staticmethod
    def backward(ctx, grad):
        return (*plain_vjp(depthwise_reference, ctx.saved_tensors,
                           ctx.needs_input_grad[:4], grad, relu=ctx.relu),
                None)


def depthwise_conv3x3x3(x: torch.Tensor, w: torch.Tensor,
                        scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        relu: bool = False) -> torch.Tensor:
    """Depthwise 3x3x3, stride 1, zero padding 1, optionally with
    ``relu(y * scale + bias)``: the CUDA kernel for a CUDA tensor
    (differentiable through the plain version), the plain version for a CPU
    tensor. Raises for any other device or an input the kernel does not
    take."""
    global CALLS
    CALLS += 1
    if x.device.type == "cpu":
        return depthwise_reference(x, w, scale, bias, relu)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv3x3x3 runs on CPU or CUDA, not "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, scale, bias)):
        return _Depthwise.apply(x, w, scale, bias, relu)
    return _launch(x, w, scale, bias, relu)
