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
  channels-mid out, the unpooled kernels of ``csrc/stem.cu`` (bf16 on the
  tensor cores, on the statistics kernel's 16x16 tiles). Replaces
  ``stem_conv_bn_relu`` (its kernel ``_stem_matmul(pool=False)``); no model
  path calls it, in the JAX package or here.

Each wrapper launches its kernel on a CUDA tensor and takes its plain
PyTorch version (``stem_reference``, ``stem_batch_stats_reference``,
``stem_conv_reference``) on a CPU tensor. Layouts are the JAX functions':
x (B,T,H,W,3), w (3,7,7,3,64) as (kt, kh, kw, c_in, c_out), scale and bias
(64,), pooled output (B,T,Hp,Wp,64), unpooled output (B,T,64,Hc,Wc).

Spatial parallelism (``MESH.SPATIAL``): ``stem_forward`` and
``stem_batch_stats`` (and their plain versions) take a ``RowWindow``, a
model peer's band of the clip's rows. x is then a slab of the clip (the
peer's rows and the halo rows its neighbours sent), and the call returns
the global output rows the window names: the pooled rows, or the
statistics of the conv rows, that the peer owns. The zero padding stays at
the clip's border. Without a window, x is the whole clip.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from tubelet_transformer_tpu_torch.ops.cuda import build
from tubelet_transformer_tpu_torch.ops.cuda.depthwise import plain_vjp
from tubelet_transformer_tpu_torch.parallel.mesh import strided_row

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
# the bound entry points, once the library is loaded
_FNS: dict = {}


# input rows above and below a peer's own rows that its pooled rows
# (stem_forward) and its conv rows (stem_batch_stats) read when its band
# starts and ends on a multiple of 4: a pooled row p reads input rows
# 4p - 5 .. 4p + 5, a conv row c rows 2c - 3 .. 2c + 3
POOL_HALO = (5, 2)
STATS_HALO = (3, 2)
# (step, reach): an output row o of the pooled or the conv rows reads
# input rows step * o - reach .. step * o + reach
_POOLED, _CONV = (4, 5), (2, 3)


@dataclass(frozen=True)
class RowWindow:
    """A model peer's band of a clip of ``height`` input rows: x holds the
    clip's global input rows ``row0`` .. ``row0`` + its own rows - 1, and
    the call computes the global output rows ``out0`` .. ``out0`` +
    ``out_rows`` - 1 (pooled rows of ``stem_forward``, conv rows whose
    statistics ``stem_batch_stats`` takes)."""

    row0: int
    height: int
    out0: int
    out_rows: int


def peer_window(first: int, count: int, height: int, pooled: bool,
                top: Optional[int] = None) -> RowWindow:
    """The window of the peer that owns input rows ``first`` .. ``first``
    + ``count`` - 1 of a clip of ``height`` rows (MESH.SPATIAL), x being
    those rows and ``top`` rows above them (by default ``POOL_HALO``'s
    with ``pooled``, else ``STATS_HALO``'s), cut at the clip's border, and
    the rows below that its output reads. Its output rows are its pooled
    rows (``pooled``) or its conv rows: those whose centre input row, 4 or
    2 times their index, is its own (``parallel.mesh.Bands``); none for a
    band that holds no such row."""
    step = (_POOLED if pooled else _CONV)[0]
    if top is None:
        top = (POOL_HALO if pooled else STATS_HALO)[0]
    o0 = strided_row(first, step)
    return RowWindow(max(0, first - top), height, o0,
                     strided_row(first + count, step) - o0)


def stem_halo(bands) -> tuple[int, int]:
    """(top, bottom): the most input rows above and below its band of
    ``bands`` (``parallel.mesh.Bands`` of the clip) that any peer's
    pooled rows and conv rows read; every peer exchanges that many."""
    (pt, pb), (ct, cb) = bands.halo(*_POOLED), bands.halo(*_CONV)
    return max(pt, ct), max(pb, cb)


def stem_window(x: torch.Tensor, window: Optional[RowWindow], pooled: bool
                ) -> RowWindow:
    """``window``, or the whole clip's for None; raises ValueError unless x
    holds every input row that its output rows read."""
    h = x.shape[2]
    hc = (h - 1) // 2 + 1 if window is None else (window.height - 1) // 2 + 1
    if window is None:
        return RowWindow(0, h, 0, (hc - 1) // 2 + 1 if pooled else hc)
    height, o0, o1 = window.height, window.out0, window.out0 + window.out_rows
    if pooled:
        need, n_out = (4 * o0 - 5, 4 * o1 + 2), (hc - 1) // 2 + 1
    else:
        need, n_out = (2 * o0 - 3, 2 * o1 + 2), hc
    need = (max(0, need[0]), min(height, need[1]))
    if not (0 <= o0 < o1 <= n_out and window.row0 <= need[0]
            and window.row0 + h >= need[1]):
        raise ValueError(f"{window}: x's rows {window.row0}.."
                         f"{window.row0 + h - 1} do not hold input rows "
                         f"{need[0]}..{need[1] - 1}, or the output rows lie "
                         f"outside 0..{n_out - 1}")
    return window


def library(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library (``build.kernels``), with the stem kernels'
    argument types set."""
    lib = build.kernels(verbose)
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            # x, w, scale, bias, out; batch, frames, H, W, row0, rows, out0,
            # out_rows; stream
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
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
        # batch, frames, out_rows, W, is_f32
        lib.tuber_stem_stats_partials.argtypes = [ctypes.c_int] * 5
        lib.tuber_stem_stats_partials.restype = ctypes.c_int
    for entry in _STATS_ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            # x, w, partial, stats; batch, frames, H, W, row0, rows, out0,
            # out_rows; stream
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _bound(entry: str):
    """The library's function ``entry``, its argument types set."""
    fn = _FNS.get(entry)
    if fn is None:
        fn = _FNS[entry] = getattr(library(), entry)
    return fn


def pooled_hw(h: int, w: int) -> tuple[int, int]:
    """Output height and width of the stem for an (h, w) input."""
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (hc - 1) // 2 + 1, (wc - 1) // 2 + 1


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The bare stem conv in x's dtype, channels-first (B,64,T,Hc,Wc)."""
    return F.conv3d(x.permute(0, 4, 1, 2, 3),
                    w.permute(4, 3, 0, 1, 2).to(x.dtype),
                    stride=(1, 2, 2), padding=(1, 3, 3))


def pool_conv_rows(window: RowWindow) -> tuple[int, int]:
    """The global conv rows [c0, c1) that the window's pooled rows read
    (rows 2p - 1 .. 2p + 1 of pooled row p, cut at the clip's border)."""
    hc = (window.height - 1) // 2 + 1
    return (max(0, 2 * window.out0 - 1),
            min(hc, 2 * (window.out0 + window.out_rows)))


def conv_window(x: torch.Tensor, w_conv: torch.Tensor, row0: int,
                height: int, c0: int, c1: int) -> torch.Tensor:
    """The bare stem conv's global rows [c0, c1) in x's dtype,
    channels-first (B,64,T,c1-c0,Wc), from x (B,T,rows,W,3) holding the
    clip's global input rows from ``row0`` on; ``w_conv`` is torch's
    (64,3,3,7,7). Zero padding only outside the clip's rows [0,
    ``height``): the rows 2 c0 - 3 .. 2 c1 + 1 it reads, cut to the clip,
    then padded back."""
    lo, hi = 2 * c0 - 3, 2 * c1 + 2
    a, b = max(0, lo), min(height, hi)
    xs = x[:, :, a - row0:b - row0].permute(0, 4, 1, 2, 3)
    xs = F.pad(xs, (0, 0, a - lo, hi - b))
    return F.conv3d(xs, w_conv.to(x.dtype), stride=(1, 2, 2),
                    padding=(1, 0, 3))


def pool_window(y: torch.Tensor, window: RowWindow, c0: int, c1: int
                ) -> torch.Tensor:
    """The 1x3x3 / (1,2,2) max-pool of the window's pooled rows from the
    channels-first conv rows [c0, c1) (``pool_conv_rows``): -inf padding
    where a pool window reaches past the clip's border."""
    top = c0 - (2 * window.out0 - 1)
    bottom = 2 * (window.out0 + window.out_rows) - c1
    y = F.pad(y, (0, 0, top, bottom), value=float("-inf"))
    return F.max_pool3d(y, (1, 3, 3), (1, 2, 2), (0, 0, 1))


def stem_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, window: Optional[RowWindow] = None
                   ) -> torch.Tensor:
    """Plain PyTorch version: the conv in x's dtype, then affine, ReLU and
    max-pool in float32, and the result in x's dtype; with ``window``,
    those of its pooled rows from its slab."""
    scale = scale.float()[:, None, None, None]
    bias = bias.float()[:, None, None, None]
    if window is None:
        y = _conv(x, w).float() * scale + bias
        y = F.max_pool3d(F.relu(y), (1, 3, 3), (1, 2, 2), (0, 1, 1))
    else:
        stem_window(x, window, pooled=True)
        c0, c1 = pool_conv_rows(window)
        y = conv_window(x, w.permute(4, 3, 0, 1, 2), window.row0,
                        window.height, c0, c1).float() * scale + bias
        y = pool_window(F.relu(y), window, c0, c1)
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


def stem_batch_stats_reference(x: torch.Tensor, w: torch.Tensor,
                               window: Optional[RowWindow] = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the conv in x's dtype, then the float32 (for
    a float64 x, float64) mean and biased variance per channel,
    E[y^2] - E[y]^2 as the JAX function takes it; with ``window``, over
    its conv rows alone."""
    if window is None:
        y = _conv(x, w)
    else:
        stem_window(x, window, pooled=False)
        y = conv_window(x, w.permute(4, 3, 0, 1, 2), window.row0,
                        window.height, window.out0,
                        window.out0 + window.out_rows)
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
                 bias: torch.Tensor, window: Optional[RowWindow] = None
                 ) -> torch.Tensor:
    global LAUNCHES
    check_inputs(x, w, scale, bias)
    win = stem_window(x, window, pooled=True)
    b, t, h, wd, _ = x.shape
    wp = pooled_hw(h, wd)[1]
    out = torch.empty((b, t, win.out_rows, wp, 64), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    fn = _bound(_ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), b, t, win.height, wd,
                 win.row0, h, win.out0, win.out_rows,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem kernel launch failed with cudaError {err}")
    LAUNCHES += 1
    return out


class _PooledStem(torch.autograd.Function):
    """The pooled kernel forward, and the backward through the plain
    version, as the JAX package's ``custom_vjp`` does (stem.py:604-625)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, window):
        ctx.window = window
        ctx.save_for_backward(x, w, scale, bias)
        return _launch_pool(x, w, scale, bias, window)

    @staticmethod
    def backward(ctx, grad):
        return (*plain_vjp(stem_reference, ctx.saved_tensors,
                           ctx.needs_input_grad[:4], grad,
                           window=ctx.window), None)


def stem_forward(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, window: Optional[RowWindow] = None
                 ) -> torch.Tensor:
    """The fused stem: the CUDA kernel for a CUDA tensor (differentiable
    through the plain version), the plain version for a CPU tensor; with
    ``window``, the window's pooled rows from its slab. Raises for any
    other device or an input the kernel does not take."""
    if x.device.type == "cpu":
        return stem_reference(x, w, scale, bias, window)
    _check_device(x, "stem_forward")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, scale, bias)):
        return _PooledStem.apply(x, w, scale, bias, window)
    return _launch_pool(x, w, scale, bias, window)


def _launch_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, relu: bool) -> torch.Tensor:
    global CONV_LAUNCHES
    check_inputs(x, w, scale, bias)
    b, t, h, wd, _ = x.shape
    out = torch.empty((b, t, 64, (h - 1) // 2 + 1, (wd - 1) // 2 + 1),
                      dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _bound(_CONV_ENTRY[x.dtype])
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


def stem_batch_stats(x: torch.Tensor, w: torch.Tensor,
                     window: Optional[RowWindow] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Float32 (mean, biased var) per channel of the bare stem conv (with
    ``window``, of its conv rows from its slab): the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor. Not differentiable
    (the JAX package stops gradients at both its inputs). Raises for any
    other device or an input the kernel does not take."""
    global STATS_LAUNCHES
    if x.device.type == "cpu":
        return stem_batch_stats_reference(x, w, window)
    _check_device(x, "stem_batch_stats")
    check_inputs(x, w)
    win = stem_window(x, window, pooled=False)
    b, t, h, wd, _ = x.shape
    stats = torch.empty((2, 64), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        n = _bound("tuber_stem_stats_partials")(
            b, t, win.out_rows, wd, int(x.dtype == torch.float32))
        if n < 0:
            raise RuntimeError(f"stem stats kernel cannot launch here: "
                               f"cudaError {-n}")
        partial = torch.empty(n, dtype=torch.float32, device=x.device)
        err = _bound(_STATS_ENTRY[x.dtype])(
            x.data_ptr(), w.data_ptr(), partial.data_ptr(), stats.data_ptr(),
            b, t, win.height, wd, win.row0, h, win.out0, win.out_rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem stats kernel launch failed with "
                           f"cudaError {err}")
    STATS_LAUNCHES += 1
    return stats[0], stats[1]
