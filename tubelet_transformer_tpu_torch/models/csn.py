"""irCSN-50/152 backbone, channels-last (B, T, H, W, C).

Port of ``tubelet_transformer_tpu/models/csn.py``. Module names follow the
reference's key scheme (``conv1``, ``bn1``, ``layer{s}.{b}.conv3``,
``down_sample.{0,1}``) and parameters keep torch's conv layouts, so
``train.torch_convert`` state dicts load with ``strict=True``.

* BatchNorm is ``x * mul + shift`` with the reference's epsilon of 1e-3: in
  eval mode from the running statistics, in train mode from the batch's
  mean and biased variance ``E[x^2] - E[x]^2`` from float32 sums, whose EMA
  (flax momentum 0.9) updates the running statistics, as the JAX package's
  ``_FoldableBN`` does. The projection shortcut's BN (``ShortcutBN``) is
  flax's ``nn.BatchNorm``, as there. The statistics stay float32 when the
  rest of the model runs in bfloat16.
* Pointwise 1x1x1 convs are channel matmuls on the channels-last tensor.
* The depthwise 3x3x3 conv is ``F.conv3d(groups=C)`` on a channels-first
  copy, as the JAX package leaves it to XLA by default. With
  ``MODEL.PALLAS_KERNELS`` (``use_pallas``) a stride-1 conv of fewer than
  128 channels (layer1) takes the hand-written kernel
  (``ops/cuda/depthwise.py``), in eval and in training.
* With ``MODEL.FUSED_BLOCKS`` (``fused_blocks``) a stride-1 identity block
  whose frames hold >= 1024 pixels and whose C_mid >= 128 (layer2 at 256
  px) runs in eval as one fused call (``ops/cuda/bottleneck.py``) with its
  BNs folded (``CSNBottleneck.fused_params``).
* With ``MODEL.FUSED_STAGES`` (``fused_stages``), in eval, the identity
  tail of every stage whose shape passes ``chain_supported`` (layers 2-4 of
  CSN-152 at 256 px) runs as ``bottleneck_chain`` calls of at most
  ``max_chain`` blocks each (``ops/cuda/stage.py``), its block 0 as a
  module: the dispatch of the JAX package's ``CSN._stage_fwd``. The stacked
  weights and folded affines are made once per change of the tail's
  parameters and BN statistics (``CSN.chain_params``).
* Weights are cast to the input's dtype at use, so a model whose parameters
  are float32 (the train build) computes in the dtype of its input.
* ``stop_grad_stage`` (``train.optimizer.stop_grad_stage``) freezes the stem
  and the stages before that boundary in training: they run without
  autograd, their BN still in train mode.
* ``frozen_chunk`` (``TRAIN.FROZEN_CHUNK``): in training, with a frozen
  prefix and a batch that is a multiple of the chunk (and larger), the
  prefix runs chunk by chunk over the batch axis, each chunk normalised by
  its own batch statistics and every BN of the prefix taking one EMA
  update per chunk, in chunk order (csn.py:284-329 of the JAX package).
* ``remat`` (``TRAIN.REMAT_BACKBONE``): in training, every bottleneck that
  has gradients runs under ``torch.utils.checkpoint`` and recomputes its
  activations in the backward, as the JAX package's ``nn.remat``
  (csn.py:392-396 there). The recompute leaves the BN running statistics
  alone, so they take one update per step, as in JAX.
* The stem takes the fused CUDA kernels (``ops/cuda/stem.py``) when
  ``stem_kernel`` is on: in eval mode the pooled kernel with the folded BN
  on a CUDA tensor; in training with a frozen stem the two-phase path
  (batch statistics kernel, then the pooled kernel with the batch affine)
  on any device, the wrappers taking their plain versions on the CPU.
  Otherwise the plain conv + BN + ReLU + max-pool.
* Data parallelism (``set_rank_mean``): every train-mode BN, the frozen
  stem's kernel statistics included, normalises by the global batch's
  statistics, the mean over ranks of each rank's float32 (E[x], E[x^2]).
* Spatial parallelism (``set_spatial``, ``MESH.SPATIAL``): the trunk takes
  this model peer's band of the clip's rows (``Mesh.own_rows``: equal
  bands, MESH.MODEL dividing the clip's rows as JAX's ``device_put``
  requires) and returns its band of the output. Every resolution has its
  bands (``spatial_rows``, ``parallel.mesh.Bands``): an output row of a
  conv or pool of stride s belongs to the peer that owns the input row at
  its stride, s times its index, so a deep band may be short, odd where
  its stage's conv strides by 2, or empty. The stem runs on a slab of its
  rows and the rows above and below that its conv and pooled rows read
  (``stem_halo``; the kernels on a ``RowWindow``); each depthwise conv
  takes the rows past its band that its output rows read (at most one on
  each side; at stride 2 one above only where its first output row's
  centre is its first row), the clip's border zero-padded, and keeps its
  own output rows; a strided shortcut reads the rows of its band at its
  stride; in eval a fused block takes 1 row each side and a chain of k
  blocks k rows, their output cropped, and a chain is cut to at most the
  shortest non-empty band's rows. Every other op is row by row. Each BN's
  batch statistics are those of the peer's own rows, averaged over the
  data x model ranks weighted by their pixels (``rank_mean``). A peer
  whose band is empty runs every op on zero rows, its collectives
  included, so that every peer makes the same exchanges forward and
  backward. The kernels' dispatch predicates read the clip's full
  height, as one process does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tubelet_transformer_tpu_torch.ops.cuda.bottleneck import (
    bottleneck_fused, bottleneck_supported)
from tubelet_transformer_tpu_torch.ops.cuda.depthwise import (
    depthwise_conv3x3x3, depthwise_supported)
from tubelet_transformer_tpu_torch.ops.cuda.stage import (
    bottleneck_chain, chain_supported, max_chain)
from tubelet_transformer_tpu_torch.ops.cuda.stem import (
    conv_window, peer_window, pool_conv_rows, pool_window,
    stem_batch_stats, stem_forward, stem_halo, stem_window)
from tubelet_transformer_tpu_torch.parallel.mesh import Bands

BN_EPS = 1e-3
BN_MOMENTUM = 0.1   # torch convention; flax momentum 0.9

BLOCK_NUMS = {
    "CSN-152": (3, 8, 36, 3),
    "CSN-50": (3, 4, 6, 3),
    # one block per stage, for tests; not a reference variant
    "CSN-TINY": (1, 1, 1, 1),
}


# the mean over data-parallel ranks of a stacked batch statistic, given
# the number of pixels it is over
RankMean = Callable[[torch.Tensor, int], torch.Tensor]

# set on the thread that recomputes a checkpointed block in the backward
_RECOMPUTE = threading.local()


@contextlib.contextmanager
def _recomputing():
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = False


def _remat_contexts():
    """``checkpoint``'s context_fn: nothing around the forward; around the
    recompute, the flag that keeps the BN running statistics still."""
    return contextlib.nullcontext(), _recomputing()


def stage_stride(s: int, last_stride: bool) -> int:
    """The H (and W) stride of stage ``s`` (0-based): its block 0's."""
    return 1 if s == 0 or (s == 3 and not last_stride) else 2


def spatial_rows(height: int, block_nums: Sequence[int], last_stride: bool,
                 model: int) -> list:
    """Every model peer's band (``parallel.mesh.Bands``, (first, count)
    global rows) at each resolution of the trunk when a clip of ``height``
    rows splits over ``model`` peers (MESH.SPATIAL): the stem's input, its
    conv rows, its pooled rows (layer1's input), then each stage's output.
    Raises ValueError, naming MESH.SPATIAL, the rows and MESH.MODEL, where
    the clip's rows do not split into equal bands: the one split the JAX
    package refuses too."""
    if height % model:
        raise ValueError(
            f"MESH.SPATIAL: the stem's input of {height} rows does not split "
            f"over MESH.MODEL {model} into equal bands")
    rows = [Bands.split(height, model)]
    rows += [rows[0].strided(2), rows[0].strided(2).strided(2)]
    for s, blocks in enumerate(block_nums):
        rows.append(rows[-1].strided(stage_stride(s, last_stride))
                    if blocks else rows[-1])
    return rows


def _no_rows(x: torch.Tensor, t: int, w: int, scale: torch.Tensor
             ) -> torch.Tensor:
    """An empty band's output: x's (B,T,H,W,C) zero rows at strides ``t``
    and ``w`` of T and W, times ``scale`` ((C') on the channels), so that
    it lies on the autograd graph of x and of ``scale``'s weight, whose
    backward (and the collectives behind it) then runs on this peer as on
    the others."""
    return x[:, ::t, :0, ::w, :1] * cast(scale, x)


def channels_first(x: torch.Tensor) -> torch.Tensor:
    """(B,T,H,W,C) -> (B,C,T,H,W) view."""
    return x.permute(0, 4, 1, 2, 3)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def cast(t: Optional[torch.Tensor], x: torch.Tensor
         ) -> Optional[torch.Tensor]:
    """``t`` in x's dtype; no op (and no aten call) when it already is."""
    return t if t is None or t.dtype == x.dtype else t.to(x.dtype)


def batch_stats(x: torch.Tensor, rank_mean: Optional[RankMean] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance over every axis but the last, as the JAX
    package takes them (csn.py:100-103): ``E[x]`` and ``E[x^2] - E[x]^2``
    from float32 (for a float64 x, float64) sums, not clamped; the gradient
    flows through both. A float32 or float64 x is squared and reduced as
    it is, in the JAX order of operations. A bf16 or float16 x is read once
    by each reduction, which accumulates in float32 without a float32 copy
    of x: ``E[x^2]`` is the float32 sum of squares of
    ``torch.linalg.vector_norm``, squared back, within 2 float32 ulps of
    the sum itself and far inside the error of the sum's order.

    ``rank_mean`` (data or spatial parallelism:
    ``parallel.mesh.Mesh.batch_mean``) takes the mean over ranks of the
    stacked (E[x], E[x^2]), given the number of pixels they are over,
    before the variance is formed, so that every rank normalises by the
    global batch's statistics, as the JAX step on a sharded batch does. An
    empty x (a peer's empty band) gives zero sums over no pixels."""
    dims = tuple(range(x.dim() - 1))
    acc = torch.promote_types(x.dtype, torch.float32)
    n = x.numel() // x.shape[-1]
    if not n:
        mean = msq = x.sum(dims, dtype=acc)
    elif x.dtype == acc:
        mean = x.mean(dims)
        msq = x.square().mean(dims)
    else:
        mean = x.sum(dims, dtype=acc) / n
        msq = torch.linalg.vector_norm(x, 2, dims, dtype=acc).square() / n
    if rank_mean is not None:
        mean, msq = rank_mean(torch.stack([mean, msq]), n).unbind()
    return mean, msq - mean.square()


class FoldableBN(nn.BatchNorm3d):
    """BatchNorm over the last axis as ``x * mul + shift`` (the JAX
    package's ``_FoldableBN``)."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        # data parallelism: the mean over ranks of the batch statistics
        # (CSN.set_rank_mean); None on one device
        self.rank_mean: Optional[RankMean] = None

    def folded(self):
        """float32 (mul, shift) with the running statistics folded in."""
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return mul, self.bias - self.running_mean * mul

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """The EMA of the running statistics (flax momentum 0.9); none in
        the backward's recompute of a checkpointed block."""
        if getattr(_RECOMPUTE, "active", False):
            return
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)

    def batch_affine(self, mean: torch.Tensor, var: torch.Tensor):
        """float32 (mul, shift) from batch statistics (mean, biased var);
        updates the running statistics with them, as the train-mode
        forward does (csn.py:86-96 of the JAX package)."""
        self.update_running(mean, var)
        mul = self.weight * torch.rsqrt(var + self.eps)
        return mul, self.bias - mean * mul

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mul, shift = self.batch_affine(*batch_stats(x, self.rank_mean))
        else:
            mul, shift = self.folded()
        return torch.addcmul(shift.to(x.dtype), x, mul.to(x.dtype))


class ShortcutBN(FoldableBN):
    """The projection shortcut's BN, flax's ``nn.BatchNorm`` in the JAX
    package (csn.py:211-213): in training the fast variance clamped at 0
    (``use_fast_variance``); in both modes ``(x - mean) * (weight *
    rsqrt(var + eps)) + bias`` in float32, rounded once to x's dtype. No
    kernel folds it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = batch_stats(x, self.rank_mean)
            var = var.clamp_min(0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + self.eps)
        return ((x - mean) * mul + self.bias).to(x.dtype)


class PointwiseConv(nn.Conv3d):
    """1x1x1 conv (optionally strided) as a matmul over the channel axis."""

    def __init__(self, in_features: int, features: int, stride=(1, 1, 1),
                 bias: bool = False):
        super().__init__(in_features, features, 1, stride=stride, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        st, sh, sw = self.stride
        if (st, sh, sw) != (1, 1, 1):
            x = x[:, ::st, ::sh, ::sw]
        return F.linear(x, cast(self.weight, x).flatten(1),
                        cast(self.bias, x))


class DepthwiseConv3d(nn.Conv3d):
    """Depthwise 3x3x3 conv, zero padding 1, on a channels-last tensor.

    With ``use_pallas``, where ``depthwise_supported`` (stride 1, C < 128)
    the conv goes through ``depthwise_conv3x3x3``: the kernel on a CUDA
    tensor, its plain version on the CPU. Otherwise it runs on a
    channels-first copy: cuDNN's grouped 3-D conv on the channels_last_3d
    view of the tensor takes ~29x longer than on a contiguous channels-first
    tensor, the two copies included (121 ms against 4.2 ms over CSN-152's
    50 depthwise convs, bf16, on an NVIDIA H100 80GB HBM3 at a 700 W power
    limit)."""

    # MESH.SPATIAL: the mesh whose model peers split the rows (set_spatial)
    spatial = None

    def __init__(self, features: int, stride=(1, 1, 1),
                 use_pallas: bool = False):
        super().__init__(features, features, 3, stride=stride, padding=1,
                         groups=features, bias=False)
        self.use_pallas = use_pallas

    def kernel_weight(self) -> torch.Tensor:
        """The weight as (3,3,3,C), the JAX layout."""
        c = self.out_channels
        return self.weight.reshape(c, 27).t().reshape(3, 3, 3, c)

    def forward(self, x: torch.Tensor, bands: Optional[Bands] = None
                ) -> torch.Tensor:
        """x's conv; with the rows split, x is this peer's band of
        ``bands`` (equal bands of its rows by default)."""
        if self.spatial is not None:
            return self._forward_rows(x, self.spatial, bands)
        if self.use_pallas and depthwise_supported(x.shape, self.stride):
            return depthwise_conv3x3x3(
                x.contiguous(), cast(self.kernel_weight(), x).contiguous())
        y = self._conv_forward(channels_first(x).contiguous(),
                               cast(self.weight, x), None)
        return channels_last(y).contiguous()

    def _forward_rows(self, x: torch.Tensor, mesh,
                      bands: Optional[Bands]) -> torch.Tensor:
        """This peer's output rows from its input rows x: the rows past its
        band that they read (``Bands.halo``, from whichever peers own
        them), the clip's border padded with zero rows, then the conv with
        no padding along H over the rows its output reads."""
        if bands is None:
            bands = Bands.split(x.shape[2] * mesh.model, mesh.model)
        s = self.stride[1]
        top, bottom = bands.halo(s, 1)
        a, h = bands.rows[mesh.model_index]
        oa, oh = bands.strided(s).rows[mesh.model_index]
        x = mesh.halo_exchange(x, top, bottom, bands)
        x = F.pad(x, (0, 0, 0, 0, top - min(top, a),
                      bottom - min(bottom, bands.height - a - h)))
        if not oh:
            return _no_rows(x, self.stride[0], self.stride[2],
                            self.weight[:, 0, 0, 0, 0])
        # x now spans global rows a - top ..; the output reads
        # s * oa - 1 .. s * (oa + oh - 1) + 1
        lo = s * oa - 1 - (a - top)
        x = x[:, :, lo:lo + s * (oh - 1) + 3]
        if self.use_pallas and depthwise_supported(x.shape, self.stride):
            y = depthwise_conv3x3x3(
                x.contiguous(), cast(self.kernel_weight(), x).contiguous())
            return y[:, :, 1:-1].contiguous()
        y = F.conv3d(channels_first(x).contiguous(), cast(self.weight, x),
                     None, self.stride, (1, 0, 1), groups=self.groups)
        return channels_last(y).contiguous()


def full_shape(x: torch.Tensor, bands: Optional[Bands]) -> tuple:
    """x's shape with the clip's full height when x is a peer's band of
    ``bands`` (None: x's own): what a kernel's dispatch predicate reads,
    as in one process."""
    b, t, h, w, c = x.shape
    return (b, t, h if bands is None else bands.height, w, c)


def halo_run(x: torch.Tensor, mesh, k: int, fn: Callable, bands: Bands
             ) -> torch.Tensor:
    """``fn`` (a row-local op with k stacked depthwise convs, zero-padded
    at its input's edge) on this peer's rows x, its band of ``bands``, and
    the k rows on each side of it, cropped back to this peer's rows: the
    rows within k of a slab edge that is not the clip's border read past
    it, and go. An empty band exchanges its rows and computes nothing."""
    a, h = bands.rows[mesh.model_index]
    slab = mesh.halo_exchange(x, k, k, bands)
    if not h:
        return x
    top = min(k, a)
    return fn(slab.contiguous())[:, :, top:top + h]


class CSNBottleneck(nn.Module):
    """ir-bottleneck: 1x1x1 -> depthwise 3x3x3 -> 1x1x1, each + BN (+ReLU),
    with a projection shortcut on the first block of a stage; in eval with
    ``fused_blocks``, one fused call where ``bottleneck_supported``."""

    # MESH.SPATIAL: the mesh whose model peers split the rows (set_spatial)
    spatial = None

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 temporal_stride: int = 1, has_downsample: bool = False,
                 use_pallas: bool = False, fused_blocks: bool = False):
        super().__init__()
        st = (temporal_stride, stride, stride)
        self.planes, self.stride, self.temporal_stride = (planes, stride,
                                                          temporal_stride)
        self.fused_blocks = fused_blocks
        self.conv1 = PointwiseConv(in_planes, planes)
        self.bn1 = FoldableBN(planes)
        self.conv3 = DepthwiseConv3d(planes, stride=st, use_pallas=use_pallas)
        self.bn3 = FoldableBN(planes)
        self.conv4 = PointwiseConv(planes, planes * 4)
        self.bn4 = FoldableBN(planes * 4)
        self.down_sample = (nn.Sequential(
            PointwiseConv(in_planes, planes * 4, stride=st),
            ShortcutBN(planes * 4)) if has_downsample else None)

    def fused_tensors(self) -> tuple:
        """The parameters and BN statistics that ``fused_params`` reads."""
        return (self.conv1.weight, self.conv3.weight, self.conv4.weight,
                *(t for bn in (self.bn1, self.bn3, self.bn4) for t in (
                    bn.weight, bn.bias, bn.running_mean, bn.running_var)))

    def fused_params(self):
        """(w1, wd, w4, a1, b1, a3, b3, a4, b4): the weights in the JAX
        layouts (Ci,Cm), (3,3,3,Cm), (Cm,Ci) and the float32 BN affines
        folded from the running statistics (csn.py:215-223 of the JAX
        package)."""
        a1, b1 = self.bn1.folded()
        a3, b3 = self.bn3.folded()
        a4, b4 = self.bn4.folded()
        return (self.conv1.weight.flatten(1).t(),
                self.conv3.kernel_weight(),
                self.conv4.weight.flatten(1).t(), a1, b1, a3, b3, a4, b4)

    def forward(self, x: torch.Tensor, bands: Optional[Bands] = None
                ) -> torch.Tensor:
        """The block on x; with the rows split, x is this peer's band of
        ``bands``."""
        mesh = self.spatial
        if (self.fused_blocks and not self.training and bottleneck_supported(
                full_shape(x, bands), self.planes, self.stride,
                self.temporal_stride, self.down_sample is not None)):
            if mesh is None:
                return bottleneck_fused(x, *self.fused_params())
            return halo_run(x, mesh, 1, lambda t: bottleneck_fused(
                t, *self.fused_params()), bands)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn3(self.conv3(out, bands)))
        out = self.bn4(self.conv4(out))
        if self.down_sample is None:
            residual = x
        else:
            # the shortcut reads the input rows at its stride: with the
            # rows split, from this peer's first such row on
            skip = 0 if mesh is None else (-bands.rows[mesh.model_index][0]
                                           % self.stride)
            residual = self.down_sample(x[:, :, skip:])
        return F.relu(out + residual)


class CSN(nn.Module):
    """irCSN trunk: (B,T,H,W,3) -> (B,T/8,H/16 or H/32,W/..,2048).

    ``last_stride=False`` keeps stage 4 at spatial stride 1.
    ``stop_grad_stage``: -1 trains everything; s >= 0 freezes the stem and
    stages 1..s in training (5: the whole trunk). ``use_pallas`` and
    ``fused_blocks`` reach every block (``MODEL.PALLAS_KERNELS``,
    ``MODEL.FUSED_BLOCKS``); ``fused_stages`` (``MODEL.FUSED_STAGES``) runs
    the stages' identity tails as chains in eval. ``frozen_chunk`` and
    ``remat`` act in training only (``TRAIN.FROZEN_CHUNK``,
    ``TRAIN.REMAT_BACKBONE``)."""

    # MESH.SPATIAL: the mesh whose model peers split the rows (set_spatial)
    spatial = None

    def __init__(self, block_nums: Sequence[int] = (3, 8, 36, 3),
                 last_stride: bool = True, stem_kernel: bool = True,
                 stop_grad_stage: int = -1, use_pallas: bool = False,
                 fused_blocks: bool = False, fused_stages: bool = False,
                 frozen_chunk: int = 0, remat: bool = False):
        super().__init__()
        self.block_nums = tuple(block_nums)
        self.last_stride = last_stride
        self.stem_kernel = stem_kernel
        self.stop_grad_stage = stop_grad_stage
        self.fused_stages = fused_stages
        self.frozen_chunk, self.remat = frozen_chunk, remat
        self.conv1 = nn.Conv3d(3, 64, (3, 7, 7), stride=(1, 2, 2),
                               padding=(1, 3, 3), bias=False)
        self.bn1 = FoldableBN(64)
        in_planes = 64
        for s, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 self.block_nums)):
            if s == 0:
                stride, tstride = 1, 1
            elif s == 3:
                stride, tstride = (2 if last_stride else 1), 2
            else:
                stride, tstride = 2, 2
            self.add_module(f"layer{s + 1}", nn.Sequential(*(
                CSNBottleneck(in_planes if b == 0 else planes * 4, planes,
                              stride if b == 0 else 1,
                              tstride if b == 0 else 1, has_downsample=b == 0,
                              use_pallas=use_pallas,
                              fused_blocks=fused_blocks)
                for b in range(blocks))))
            if blocks:
                in_planes = planes * 4
        self._kernel_w = None
        self._kernel_w_key = None
        # stage index -> (key, the stacked parameters of each chain)
        self._chains: dict = {}

    def set_rank_mean(self, rank_mean: Optional[RankMean]) -> None:
        """Every train-mode BN of the trunk, the stem's included, takes its
        batch statistics' mean over data-parallel ranks with ``rank_mean``
        (``batch_stats``); None for one device."""
        for m in self.modules():
            if isinstance(m, FoldableBN):
                m.rank_mean = rank_mean

    def set_spatial(self, mesh) -> None:
        """The trunk, its depthwise convs and its blocks on this peer's
        rows of ``mesh``'s split (MESH.SPATIAL), their halo exchanges over
        its model group; None for the whole clip."""
        for m in self.modules():
            if isinstance(m, (CSN, CSNBottleneck, DepthwiseConv3d)):
                m.spatial = mesh

    def kernel_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The stem weight in the kernels' (3,7,7,3,64) layout and ``dtype``,
        made once per change of ``conv1.weight`` (load, cast, move or
        optimizer step), not per call."""
        w = self.conv1.weight
        key = (w.data_ptr(), w._version, w.dtype, w.device, dtype)
        if key != self._kernel_w_key:
            self._kernel_w = w.detach().permute(2, 3, 4, 1, 0).to(
                dtype).contiguous()
            self._kernel_w_key = key
        return self._kernel_w

    def chain_params(self, s: int, kmax: int) -> list:
        """The stacked (w1, wd, w4, a1, b1, a3, b3, a4, b4) of each chain
        of stage ``s``'s identity tail, in chains of at most ``kmax`` blocks.
        Without autograd they are made once per change of the tail's
        parameters and BN statistics (load, cast, move, optimizer step or
        train-mode update: each tensor's storage, version, dtype and
        device), not per call; with gradients enabled, anew and
        differentiable."""
        tail = list(getattr(self, f"layer{s + 1}"))[1:]

        def build():
            return [[torch.stack(p) for p in zip(
                *(blk.fused_params() for blk in tail[i:i + kmax]))]
                for i in range(0, len(tail), kmax)]

        if torch.is_grad_enabled():
            return build()
        key = (kmax, *((t.data_ptr(), t._version, t.dtype, t.device)
                       for blk in tail for t in blk.fused_tensors()))
        cached = self._chains.get(s)
        if cached is None or cached[0] != key:
            cached = self._chains[s] = (key, build())
        return cached[1]

    def row_bands(self, height: int) -> Optional[list]:
        """``spatial_rows`` of a clip of ``height`` rows over this trunk's
        model peers with the rows split, else None."""
        if self.spatial is None:
            return None
        return spatial_rows(height, self.block_nums, self.last_stride,
                            self.spatial.model)

    def stage(self, s: int, x: torch.Tensor,
              bands: Optional[Bands] = None) -> torch.Tensor:
        """Stage ``s`` (0-based): in eval with ``fused_stages``, block 0 as a
        module and the identity tail as chains where ``chain_supported``
        (csn.py:410-426 of the JAX package); otherwise block by block. With
        the rows split, x is this peer's band of ``bands``."""
        layer = getattr(self, f"layer{s + 1}")
        tail = (None if bands is None
                else bands.strided(stage_stride(s, self.last_stride)))
        if self.remat and self.training and torch.is_grad_enabled():
            for i, block in enumerate(layer):
                x = torch.utils.checkpoint.checkpoint(
                    block, x, tail if i else bands, use_reentrant=False,
                    context_fn=_remat_contexts)
            return x

        def blocks(x: torch.Tensor, start: int = 0) -> torch.Tensor:
            for i in range(start, len(layer)):
                x = layer[i](x, tail if i else bands)
            return x

        if not (self.fused_stages and not self.training and len(layer) > 1):
            return blocks(x)
        x = layer[0](x, bands)
        planes = layer[0].planes
        if not chain_supported(full_shape(x, tail), planes):
            return blocks(x, 1)
        kmax = max_chain(x.shape[2] * x.shape[3], planes * 4, planes)
        if self.spatial is not None:
            # a chain of k blocks reads k rows on each side, which every
            # peer exchanges alike: at most the shortest non-empty band's
            kmax = min(kmax, min(h for _, h in tail.rows if h))
        for stacked in self.chain_params(s, kmax):
            if self.spatial is None:
                x = bottleneck_chain(x, *stacked)
            else:
                x = halo_run(x, self.spatial, stacked[0].shape[0],
                             lambda t: bottleneck_chain(t, *stacked), tail)
        return x

    def stem(self, x: torch.Tensor, bands: Optional[Bands] = None
             ) -> torch.Tensor:
        """conv1, bn1, ReLU and the max-pool on the whole clip x, or with
        the rows split (MESH.SPATIAL) on this peer's band x of ``bands``:
        then on the slab of its rows and the halo its conv and pooled rows
        read (``stem_halo``), returning its pooled rows, the batch
        statistics (the kernel's, or the plain BN's) over its own conv rows
        alone, averaged over the ranks. The whole clip is the window of all
        its rows, the kernels' default."""
        mesh = self.spatial
        if mesh is None:
            slab, win = x, stem_window(x, None, pooled=True)
            stats_win = stem_window(x, None, pooled=False)
            pool_win: tuple = ()
            stats_arg: tuple = ()
        else:
            first, count = bands.rows[mesh.model_index]
            top, bottom = stem_halo(bands)
            slab = mesh.halo_exchange(x, top, bottom, bands).contiguous()
            win, stats_win = (peer_window(first, count, bands.height, pooled,
                                          top) for pooled in (True, False))
            pool_win, stats_arg = (win,), (stats_win,)
        if self.stem_kernel and not self.training and x.is_cuda:
            if not win.out_rows:
                return _no_rows(slab, 1, 4, self.conv1.weight[:, 0, 0, 0, 0])
            mul, shift = self.bn1.folded()
            return stem_forward(slab, self.kernel_weight(x.dtype), mul, shift,
                                *pool_win)
        if self.stem_kernel and self.training and self.stop_grad_stage >= 0:
            # frozen stem in training (csn.py:339-370 of the JAX package):
            # phase 1 the batch statistics of the bare conv, phase 2 the
            # pooled kernel with the batch affine; nothing differentiates
            w = self.kernel_weight(x.dtype)
            slab = slab.detach()
            n = x.shape[0] * x.shape[1] * stats_win.out_rows * (
                (x.shape[3] - 1) // 2 + 1)
            if n:
                mean, var = stem_batch_stats(slab, w, *stats_arg)
            else:
                mean = var = torch.zeros(64, device=x.device)
            if self.bn1.rank_mean is not None:
                # the global statistics from each rank's: E[y^2] rebuilt as
                # var + mean^2 in float32 is the kernel's own float32
                # E[y^2] exactly where var <= mean^2 (the kernel's
                # subtraction was exact there) and within an ulp elsewhere
                mean, msq = self.bn1.rank_mean(
                    torch.stack([mean, var + mean.square()]), n).unbind()
                var = msq - mean.square()
            mul, shift = self.bn1.batch_affine(mean, var)
            if not win.out_rows:
                return _no_rows(slab, 1, 4, self.conv1.weight[:, 0, 0, 0, 0])
            return stem_forward(slab, w, mul.detach(), shift.detach(),
                                *pool_win)
        # the conv rows that the pooled rows read and that this peer's
        # statistics are over
        c0, c1 = pool_conv_rows(win)
        s0, s1 = stats_win.out0, stats_win.out0 + stats_win.out_rows
        if self.training and s1 > s0:
            c0, c1 = min(c0, s0), max(c1, s1)
        if c1 <= c0:
            y = channels_first(_no_rows(slab, 1, 2,
                                        self.conv1.weight[:, 0, 0, 0, 0]))
        else:
            y = conv_window(slab, cast(self.conv1.weight, x), win.row0,
                            win.height, c0, c1)
        y = channels_last(y)
        if self.training:
            own = y[:, :, max(0, s0 - c0):max(0, s1 - c0)]
            mul, shift = self.bn1.batch_affine(
                *batch_stats(own, self.bn1.rank_mean))
        else:
            mul, shift = self.bn1.folded()
        y = F.relu(torch.addcmul(shift.to(y.dtype), y, mul.to(y.dtype)))
        if not win.out_rows:
            return y[:, :, :0, ::2]
        p0, p1 = pool_conv_rows(win)
        y = channels_first(y[:, :, p0 - c0:p1 - c0])
        return channels_last(pool_window(y, win, p0, p1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bands = (self.row_bands(x.shape[2] * self.spatial.model)
                 if self.spatial is not None else [None] * 7)
        frozen = self.stop_grad_stage if self.training else -1
        b, ck, start = x.shape[0], self.frozen_chunk, 0
        if frozen >= 0 and 0 < ck < b and b % ck == 0:
            # the frozen prefix chunk by chunk, in batch order, as the JAX
            # package's scan over x.reshape(b // ck, ck, ...)
            start = min(frozen, len(self.block_nums))
            with torch.no_grad():
                chunks = []
                for xc in x.split(ck):
                    xc = self.stem(xc, bands[0])
                    for s in range(start):
                        xc = self.stage(s, xc, bands[2 + s])
                    chunks.append(xc)
                x = torch.cat(chunks)
        else:
            # the frozen prefix (stem + stages 1..frozen) runs without
            # autograd: the JAX package's stop_gradient at that boundary
            # (csn.py:375-378, 427-428)
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and frozen < 0):
                x = self.stem(x, bands[0])
        for s in range(start, len(self.block_nums)):
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and s + 1 > frozen):
                x = self.stage(s, x, bands[2 + s])
        return x


def build_csn(backbone_name: str, last_stride: bool,
              stem_kernel: bool = True, stop_grad_stage: int = -1,
              use_pallas: bool = False, fused_blocks: bool = False,
              fused_stages: bool = False, frozen_chunk: int = 0,
              remat: bool = False) -> CSN:
    if backbone_name not in BLOCK_NUMS:
        raise ValueError(f"unknown backbone {backbone_name!r}; "
                         f"supported: {sorted(BLOCK_NUMS)}")
    return CSN(BLOCK_NUMS[backbone_name], last_stride, stem_kernel,
               stop_grad_stage, use_pallas, fused_blocks, fused_stages,
               frozen_chunk, remat)
