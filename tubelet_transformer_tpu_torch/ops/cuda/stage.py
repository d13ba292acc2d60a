"""K consecutive stride-1 identity ir-bottlenecks of an irCSN stage in one
call, inference: the kernel of ``csrc/stage.cu``.

Replaces ``bottleneck_chain`` (its kernel ``_chain_pallas``) of
``tubelet_transformer_tpu/ops/pallas/stage.py``, with the same arguments:
x (B,T,H,W,Ci) channels-last and the weights of the K blocks stacked on a
leading axis, w1 (K,Ci,Cm), wd (K,3,3,3,Cm), w4 (K,Cm,Ci), and the folded BN
affines a1, b1, a3, b3 (K,Cm) and a4, b4 (K,Ci). The kernel takes the
weights in bf16 and the affines in float32, as the JAX function casts them,
and returns x's dtype; it rounds every block's output but the last to bf16,
as the TPU kernel keeps them.

``bottleneck_chain`` launches the kernel on a CUDA tensor and takes the
plain PyTorch version (``chain_reference``) on a CPU tensor. Its gradient
goes through the plain version, as the JAX package's custom VJP goes through
``chain_xla``. ``run`` is the kernel's launch without the checks and the
count, which ``bottleneck.bottleneck_fused`` also takes for one block
(K = 1) after its own checks.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from tubelet_transformer_tpu_torch.ops.cuda import build
from tubelet_transformer_tpu_torch.ops.cuda.bottleneck import (
    bottleneck_reference, check_inputs as check_block_inputs, kernel_args)
from tubelet_transformer_tpu_torch.ops.cuda.depthwise import (
    depthwise_reference, plain_vjp)

# kernel launches (one per chain), and calls of bottleneck_chain on any
# device, in this process
LAUNCHES = 0
CALLS = 0

_ENTRY = {torch.bfloat16: "tuber_chain_bf16",
          torch.float32: "tuber_chain_f32"}


_LIB: ctypes.CDLL | None = None


def library(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library (``build.kernels``), with the chain kernel's
    argument types set."""
    global _LIB
    if _LIB is None:
        lib = build.kernels(verbose)
        for entry in _ENTRY.values():
            fn = getattr(lib, entry)
            # x, w1, wd, w4, a1, b1, a3, b3, a4, b4, mid, mdw, out;
            # batch, frames, H, W, Ci, Cm, K; stream
            fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.tuber_chain_blocks.argtypes = [ctypes.c_int]
        lib.tuber_chain_blocks.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def chain_supported(x_shape: Sequence[int], cm: int) -> bool:
    """The JAX predicate's conditions, without its backend test: C_mid >=
    128, T >= 2, frames of at least 256 pixels and at most 2 MiB in bf16."""
    _, t, h, w, ci = x_shape
    hw = h * w
    return (cm >= 128 and t >= 2 and hw >= 256
            and hw * ci * 2 <= 2 * 1024 * 1024)


def max_chain(hw: int, ci: int, cm: int) -> int:
    """The most blocks one chain may take. The JAX package sizes K from the
    TPU kernel's VMEM rings, which grow with K. This kernel keeps one output
    and two bf16 scratch buffers whatever K is (phase C updates the output
    in place),
    and reads each block's weights from device memory in its turn, so no
    on-chip resource grows with K: a chain takes a stage's whole identity
    tail. The only limit left is the kernel's 32-bit K argument."""
    del hw, ci, cm
    return 2 ** 31 - 1


def chain_reference(x: torch.Tensor, stacked: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
    """Plain PyTorch version of ``chain_xla``: ``bottleneck_reference`` of
    each block in turn, every step in x's dtype."""
    for i in range(stacked[0].shape[0]):
        x = bottleneck_reference(x, *(s[i] for s in stacked))
    return x


def chain_reference_rounded(x: torch.Tensor, stacked: Sequence[torch.Tensor],
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """The plain version in ``dtype`` (float32 or float64) that rounds to
    bf16 where the kernel does: conv1's input, mid, the depthwise output,
    and every block's output but the last. Against it the kernel differs by
    summation order and the roundings that order flips."""
    def r(t):
        return t.to(torch.bfloat16).to(dtype)

    y = x.to(dtype)
    k = stacked[0].shape[0]
    for i in range(k):
        w1, wd, w4, a1, b1, a3, b3, a4, b4 = (s[i].to(dtype) for s in stacked)
        m = r(F.relu(r(y) @ w1 * a1 + b1))
        m = r(F.relu(depthwise_reference(m, wd) * a3 + b3))
        y = F.relu(m @ w4 * a4 + b4 + y)
        if i + 1 < k:
            y = r(y)
    return y


def check_inputs(x, w1, wd, w4, a1, b1, a3, b3, a4, b4) -> None:
    """Raise ValueError unless the kernel takes these tensors as they are:
    each block's slice as ``bottleneck.check_inputs`` wants it (x bf16 or
    float32, weights bf16, affines float32, all contiguous on x's device,
    C_mid a multiple of 64, Ci of 128), the same K >= 1 on every stack."""
    stacked = (w1, wd, w4, a1, b1, a3, b3, a4, b4)
    if any(s.dim() < 2 for s in stacked):
        raise ValueError("the stacked weights need a leading K axis")
    k = w1.shape[0]
    if k < 1 or any(s.shape[0] != k for s in stacked):
        raise ValueError(f"every stack must hold the same K >= 1 blocks, got "
                         f"{[tuple(s.shape) for s in stacked]}")
    if any(not s.is_contiguous() for s in stacked):
        raise ValueError("the stacked weights must be contiguous")
    # block 0's slices stand for every block's: block k's lie k slices
    # further, and every slice's size is a multiple of 16 bytes
    check_block_inputs(x, *(s[0] for s in stacked))


def run(x, params, k: int) -> torch.Tensor:
    """The kernel on inputs that ``check_inputs`` passed, counted nowhere:
    ``params`` the nine stacks of K blocks, or for K = 1 the nine tensors
    of one block, the same memory without the leading axis."""
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    b, t, h, w, ci = x.shape
    cm = params[0].shape[-1]
    # mid and mdw, one after the other
    scratch = torch.empty((2, b, t, h, w, cm), dtype=torch.bfloat16,
                          device=x.device)
    mid = scratch.data_ptr()
    with torch.cuda.device(x.device):
        err = getattr(library(), _ENTRY[x.dtype])(
            x.data_ptr(), *(p.data_ptr() for p in params), mid,
            mid + scratch.nbytes // 2, out.data_ptr(), b, t, h, w, ci, cm, k,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chain kernel launch failed with cudaError {err}")
    return out


def _launch(x, *stacked) -> torch.Tensor:
    global LAUNCHES
    check_inputs(x, *stacked)
    out = run(x, stacked, stacked[0].shape[0])
    LAUNCHES += out.numel() > 0
    return out


def grid_blocks(x: torch.Tensor) -> int:
    """Blocks of the cooperative grid that the kernel launches for x (a CUDA
    tensor): the resident blocks of every SM, whatever the shape."""
    with torch.cuda.device(x.device):
        n = library().tuber_chain_blocks(int(x.dtype == torch.float32))
    if n <= 0:
        raise RuntimeError(f"the chain kernel cannot launch here: cudaError "
                           f"{-n}")
    return n


def phase_tiles(x_shape: Sequence[int], cm: int) -> dict[str, int]:
    """Work items of each of the kernel's three phases for one block of the
    chain (``csrc/stage.cu:work``): conv1's 64x64 GEMM tiles, the
    depthwise's (b, t, 8x8 pixels, 64 channels) items, conv4's 64x128 GEMM
    tiles."""
    b, t, h, w, ci = x_shape
    row_tiles = -(-(b * t * h * w) // 64)
    return {"conv1": row_tiles * (cm // 64),
            "depthwise": b * t * -(-h // 8) * -(-w // 8) * (cm // 64),
            "conv4": row_tiles * (ci // 128)}


def _chain_plain(x, *stacked):
    return chain_reference(x, stacked)


class _Chain(torch.autograd.Function):
    """The kernel forward, and the backward through the plain version."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _launch(*args)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(_chain_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, grad)


def bottleneck_chain(x, w1, wd, w4, a1, b1, a3, b3, a4, b4) -> torch.Tensor:
    """K chained stride-1 identity ir-bottlenecks: the CUDA kernel for a
    CUDA tensor, with the weights cast to bf16 and the affines to float32
    (differentiable through the plain version), the plain version for a CPU
    tensor. Raises for any other device or an input the kernel does not
    take."""
    global CALLS
    CALLS += 1
    if x.device.type == "cpu":
        return chain_reference(x, (w1, wd, w4, a1, b1, a3, b3, a4, b4))
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_chain runs on CPU or CUDA, not "
                         f"{x.device}")
    args = kernel_args(x, w1, wd, w4, a1, b1, a3, b3, a4, b4)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Chain.apply(*args)
    return _launch(*args)
