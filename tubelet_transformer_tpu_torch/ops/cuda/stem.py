"""The irCSN stem's two hand-written kernels, channels-last in:

* ``stem_forward``: conv 3x7x7 / (1,2,2) + per-channel affine (folded BN, or
  the batch affine in training) + ReLU + 1x3x3 / (1,2,2) max-pool, the
  kernel of ``csrc/stem.cu``. Replaces ``stem_forward`` / ``stem_from_xd`` of
  ``tubelet_transformer_tpu/ops/pallas/stem.py`` (its kernels
  ``_deinterleave`` and ``_stem_matmul(pool=True)``).
* ``stem_batch_stats``: the per-channel mean and biased variance of the bare
  conv, the kernel of ``csrc/stem_stats.cu`` (bf16 on the tensor cores).
  Replaces ``stem_batch_stats`` (its kernel ``_stem_stats_matmul``), phase
  1 of the frozen-stem train path.
* ``stem_conv_bn_relu``: the conv + affine (+ ReLU) without the pool,
  channels-mid out, the second kernel of ``csrc/stem.cu``. Replaces
  ``stem_conv_bn_relu`` (its kernel ``_stem_matmul(pool=False)``); no model
  path calls it, in the JAX package or here.

Each wrapper launches its kernel on a CUDA tensor and takes its plain
PyTorch version (``stem_reference``, ``stem_batch_stats_reference``,
``stem_conv_reference``) on a CPU tensor. Layouts are the JAX functions':
x (B,T,H,W,3), w (3,7,7,3,64) as (kt, kh, kw, c_in, c_out), scale and bias
(64,), pooled output (B,T,Hp,Wp,64), unpooled output (B,T,64,Hc,Wc).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tubelet_transformer_tpu_torch.ops.cuda import build
from tubelet_transformer_tpu_torch.ops.cuda.depthwise import plain_vjp

# kernel launches made by stem_forward, stem_batch_stats and
# stem_conv_bn_relu in this process
LAUNCHES = 0
STATS_LAUNCHES = 0
CONV_LAUNCHES = 0

W_SHAPE = (3, 7, 7, 3, 64)
_ENTRY = {torch.bfloat16: "tuber_stem_pool_bf16",
          torch.float32: "tuber_stem_pool_f32"}
_STATS_ENTRY = {torch.bfloat16: "tuber_stem_stats_bf16",
                torch.float32: "tuber_stem_stats_f32"}
_CONV_ENTRY = {torch.bfloat16: "tuber_stem_conv_bf16",
               torch.float32: "tuber_stem_conv_f32"}


def library(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library (``build.kernels``), with the stem kernels'
    argument types set."""
    lib = build.kernels(verbose)
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            # x, w, scale, bias, out; batch, frames, H, W; stream
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    for entry in _CONV_ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            # x, w, scale, bias, out; batch, frames, H, W, relu; stream
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    if lib.tuber_stem_stats_partials.argtypes is None:
        # batch, frames, H, W, is_f32
        lib.tuber_stem_stats_partials.argtypes = [ctypes.c_int] * 5
        lib.tuber_stem_stats_partials.restype = ctypes.c_int
    for entry in _STATS_ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            # x, w, partial, stats; batch, frames, H, W; stream
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def pooled_hw(h: int, w: int) -> tuple[int, int]:
    """Output height and width of the stem for an (h, w) input."""
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (hc - 1) // 2 + 1, (wc - 1) // 2 + 1


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The bare stem conv in x's dtype, channels-first (B,64,T,Hc,Wc)."""
    return F.conv3d(x.permute(0, 4, 1, 2, 3),
                    w.permute(4, 3, 0, 1, 2).to(x.dtype),
                    stride=(1, 2, 2), padding=(1, 3, 3))


def stem_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the conv in x's dtype, then affine, ReLU and
    max-pool in float32, and the result in x's dtype."""
    y = _conv(x, w).float() * scale.float()[:, None, None, None] \
        + bias.float()[:, None, None, None]
    y = F.max_pool3d(F.relu(y), (1, 3, 3), (1, 2, 2), (0, 1, 1))
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def stem_conv_reference(x: torch.Tensor, w: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor,
                        relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``_stem_xla(pool=False)``: the conv in x's
    dtype, then affine (and ReLU) in float32, and the result in x's dtype,
    channels-mid (B,T,64,Hc,Wc)."""
    y = _conv(x, w).float() * scale.float()[:, None, None, None] \
        + bias.float()[:, None, None, None]
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 1, 3, 4).to(x.dtype).contiguous()


def stem_batch_stats_reference(x: torch.Tensor, w: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the conv in x's dtype, then the float32 (for
    a float64 x, float64) mean and biased variance per channel,
    E[y^2] - E[y]^2 as the JAX function takes it."""
    y = _conv(x, w)
    y = y.to(torch.promote_types(y.dtype, torch.float32))
    dims = (0, 2, 3, 4)
    mean = y.mean(dims)
    return mean, y.square().mean(dims) - mean.square()


def check_inputs(x: torch.Tensor, w: torch.Tensor,
                 *affine: torch.Tensor) -> None:
    """Raise ValueError unless the kernels take these tensors as they are;
    ``affine`` is the pooled kernel's (scale, bias)."""
    if x.dim() != 5 or x.shape[-1] != 3:
        raise ValueError(f"x must be (B,T,H,W,3), got {tuple(x.shape)}")
    if x.dtype not in _ENTRY:
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if tuple(w.shape) != W_SHAPE or w.dtype != x.dtype:
        raise ValueError(f"w must be {W_SHAPE} in {x.dtype}, got "
                         f"{tuple(w.shape)} in {w.dtype}")
    for name, t in zip(("scale", "bias"), affine):
        if tuple(t.shape) != (64,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be (64,) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in zip(("x", "w", "scale", "bias"), (x, w, *affine)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w.data_ptr() % 16:
        raise ValueError("w must be 16-byte aligned (the tensor-core "
                         "kernels copy it in 16-byte pieces)")
    if x.shape[0] * x.shape[1] > 65535:
        raise ValueError(f"B*T must be <= 65535, got {x.shape[0] * x.shape[1]}")


def _check_device(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA, not {x.device}")


def _launch_pool(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
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


class _PooledStem(torch.autograd.Function):
    """The pooled kernel forward, and the backward through the plain
    version, as the JAX package's ``custom_vjp`` does (stem.py:604-625)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias):
        ctx.save_for_backward(x, w, scale, bias)
        return _launch_pool(x, w, scale, bias)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(stem_reference, ctx.saved_tensors,
                         ctx.needs_input_grad, grad)


def stem_forward(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """The fused stem: the CUDA kernel for a CUDA tensor (differentiable
    through the plain version), the plain version for a CPU tensor. Raises
    for any other device or an input the kernel does not take."""
    if x.device.type == "cpu":
        return stem_reference(x, w, scale, bias)
    _check_device(x, "stem_forward")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, scale, bias)):
        return _PooledStem.apply(x, w, scale, bias)
    return _launch_pool(x, w, scale, bias)


def _launch_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, relu: bool) -> torch.Tensor:
    global CONV_LAUNCHES
    check_inputs(x, w, scale, bias)
    b, t, h, wd, _ = x.shape
    out = torch.empty((b, t, 64, (h - 1) // 2 + 1, (wd - 1) // 2 + 1),
                      dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = getattr(library(), _CONV_ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), b, t, h, wd, int(relu),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem conv kernel launch failed with cudaError "
                           f"{err}")
    CONV_LAUNCHES += 1
    return out


class _ConvStem(torch.autograd.Function):
    """The unpooled kernel forward, and the backward through the plain
    version, as the JAX package's ``custom_vjp`` does (stem.py:579-601)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, relu):
        ctx.relu = relu
        ctx.save_for_backward(x, w, scale, bias)
        return _launch_conv(x, w, scale, bias, relu)

    @staticmethod
    def backward(ctx, grad):
        return (*plain_vjp(stem_conv_reference, ctx.saved_tensors,
                           ctx.needs_input_grad[:4], grad, relu=ctx.relu),
                None)


def stem_conv_bn_relu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """The stem conv + affine (+ ReLU), no pool, channels-mid
    (B,T,64,Hc,Wc) in x's dtype: the CUDA kernel for a CUDA tensor
    (differentiable through the plain version), the plain version for a CPU
    tensor. Raises for any other device or an input the kernel does not
    take."""
    if x.device.type == "cpu":
        return stem_conv_reference(x, w, scale, bias, relu)
    _check_device(x, "stem_conv_bn_relu")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, scale, bias)):
        return _ConvStem.apply(x, w, scale, bias, relu)
    return _launch_conv(x, w, scale, bias, relu)


def stem_batch_stats(x: torch.Tensor, w: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Float32 (mean, biased var) per channel of the bare stem conv: the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor. Not
    differentiable (the JAX package stops gradients at both its inputs).
    Raises for any other device or an input the kernel does not take."""
    global STATS_LAUNCHES
    if x.device.type == "cpu":
        return stem_batch_stats_reference(x, w)
    _check_device(x, "stem_batch_stats")
    check_inputs(x, w)
    b, t, h, wd, _ = x.shape
    lib = library()
    stats = torch.empty((2, 64), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        n = lib.tuber_stem_stats_partials(b, t, h, wd,
                                          int(x.dtype == torch.float32))
        if n < 0:
            raise RuntimeError(f"stem stats kernel cannot launch here: "
                               f"cudaError {-n}")
        partial = torch.empty(n, dtype=torch.float32, device=x.device)
        err = getattr(lib, _STATS_ENTRY[x.dtype])(
            x.data_ptr(), w.data_ptr(), partial.data_ptr(), stats.data_ptr(),
            b, t, h, wd, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem stats kernel launch failed with "
                           f"cudaError {err}")
    STATS_LAUNCHES += 1
    return stats[0], stats[1]
