"""irCSN-50/152 backbone, channels-last (B, T, H, W, C).

Port of ``tubelet_transformer_tpu/models/csn.py``. Module names follow the
reference's key scheme (``conv1``, ``bn1``, ``layer{s}.{b}.conv3``,
``down_sample.{0,1}``) and parameters keep torch's conv layouts, so
``train.torch_convert`` state dicts load with ``strict=True``.

* BatchNorm is ``x * mul + shift`` with the reference's epsilon of 1e-3: in
  eval mode from the running statistics, in train mode from the batch's
  mean and biased variance (f32), whose EMA (flax momentum 0.9) updates the
  running statistics, as the JAX package's BN does. The statistics stay
  float32 when the rest of the model runs in bfloat16.
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
* The stem takes the fused CUDA kernels (``ops/cuda/stem.py``) when
  ``stem_kernel`` is on: in eval mode the pooled kernel with the folded BN
  on a CUDA tensor; in training with a frozen stem the two-phase path
  (batch statistics kernel, then the pooled kernel with the batch affine)
  on any device, the wrappers taking their plain versions on the CPU.
  Otherwise the plain conv + BN + ReLU + max-pool.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tubelet_transformer_tpu_torch.ops.cuda.bottleneck import (
    bottleneck_fused, bottleneck_supported)
from tubelet_transformer_tpu_torch.ops.cuda.depthwise import (
    depthwise_conv3x3x3, depthwise_supported)
from tubelet_transformer_tpu_torch.ops.cuda.stage import (
    bottleneck_chain, chain_supported, max_chain)
from tubelet_transformer_tpu_torch.ops.cuda.stem import (
    stem_batch_stats, stem_forward)

BN_EPS = 1e-3
BN_MOMENTUM = 0.1   # torch convention; flax momentum 0.9

BLOCK_NUMS = {
    "CSN-152": (3, 8, 36, 3),
    "CSN-50": (3, 4, 6, 3),
    # one block per stage, for tests; not a reference variant
    "CSN-TINY": (1, 1, 1, 1),
}


def channels_first(x: torch.Tensor) -> torch.Tensor:
    """(B,T,H,W,C) -> (B,C,T,H,W) view."""
    return x.permute(0, 4, 1, 2, 3)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def cast(t: Optional[torch.Tensor], x: torch.Tensor
         ) -> Optional[torch.Tensor]:
    """``t`` in x's dtype; no op (and no aten call) when it already is."""
    return t if t is None or t.dtype == x.dtype else t.to(x.dtype)


class FoldableBN(nn.BatchNorm3d):
    """BatchNorm over the last axis as ``x * mul + shift``."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def folded(self):
        """float32 (mul, shift) with the running statistics folded in."""
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return mul, self.bias - self.running_mean * mul

    def batch_affine(self, mean: torch.Tensor, var: torch.Tensor):
        """float32 (mul, shift) from batch statistics (mean, biased var);
        updates the running statistics with them, as the train-mode
        forward does (csn.py:86-96 of the JAX package)."""
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
        mul = self.weight * torch.rsqrt(var + self.eps)
        return mul, self.bias - mean * mul

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            # mean and biased variance over every axis but the channels, in
            # float32 (or wider); the gradient flows through both
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            var, mean = torch.var_mean(xf, dim=tuple(range(x.dim() - 1)),
                                       correction=0)
            mul, shift = self.batch_affine(mean, var)
        else:
            mul, shift = self.folded()
        return torch.addcmul(shift.to(x.dtype), x, mul.to(x.dtype))


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

    def __init__(self, features: int, stride=(1, 1, 1),
                 use_pallas: bool = False):
        super().__init__(features, features, 3, stride=stride, padding=1,
                         groups=features, bias=False)
        self.use_pallas = use_pallas

    def kernel_weight(self) -> torch.Tensor:
        """The weight as (3,3,3,C), the JAX layout."""
        c = self.out_channels
        return self.weight.reshape(c, 27).t().reshape(3, 3, 3, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_pallas and depthwise_supported(x.shape, self.stride):
            return depthwise_conv3x3x3(
                x.contiguous(), cast(self.kernel_weight(), x).contiguous())
        y = self._conv_forward(channels_first(x).contiguous(),
                               cast(self.weight, x), None)
        return channels_last(y).contiguous()


class CSNBottleneck(nn.Module):
    """ir-bottleneck: 1x1x1 -> depthwise 3x3x3 -> 1x1x1, each + BN (+ReLU),
    with a projection shortcut on the first block of a stage; in eval with
    ``fused_blocks``, one fused call where ``bottleneck_supported``."""

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
            FoldableBN(planes * 4)) if has_downsample else None)

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.fused_blocks and not self.training and bottleneck_supported(
                x.shape, self.planes, self.stride, self.temporal_stride,
                self.down_sample is not None)):
            return bottleneck_fused(x, *self.fused_params())
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn3(self.conv3(out)))
        out = self.bn4(self.conv4(out))
        residual = x if self.down_sample is None else self.down_sample(x)
        return F.relu(out + residual)


class CSN(nn.Module):
    """irCSN trunk: (B,T,H,W,3) -> (B,T/8,H/16 or H/32,W/..,2048).

    ``last_stride=False`` keeps stage 4 at spatial stride 1.
    ``stop_grad_stage``: -1 trains everything; s >= 0 freezes the stem and
    stages 1..s in training (5: the whole trunk). ``use_pallas`` and
    ``fused_blocks`` reach every block (``MODEL.PALLAS_KERNELS``,
    ``MODEL.FUSED_BLOCKS``); ``fused_stages`` (``MODEL.FUSED_STAGES``) runs
    the stages' identity tails as chains in eval."""

    def __init__(self, block_nums: Sequence[int] = (3, 8, 36, 3),
                 last_stride: bool = True, stem_kernel: bool = True,
                 stop_grad_stage: int = -1, use_pallas: bool = False,
                 fused_blocks: bool = False, fused_stages: bool = False):
        super().__init__()
        self.block_nums = tuple(block_nums)
        self.stem_kernel = stem_kernel
        self.stop_grad_stage = stop_grad_stage
        self.fused_stages = fused_stages
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

    def stage(self, s: int, x: torch.Tensor) -> torch.Tensor:
        """Stage ``s`` (0-based): in eval with ``fused_stages``, block 0 as a
        module and the identity tail as chains where ``chain_supported``
        (csn.py:410-426 of the JAX package); otherwise block by block."""
        layer = getattr(self, f"layer{s + 1}")
        if not (self.fused_stages and not self.training and len(layer) > 1):
            return layer(x)
        x = layer[0](x)
        planes = layer[0].planes
        if not chain_supported(x.shape, planes):
            return layer[1:](x)
        kmax = max_chain(x.shape[2] * x.shape[3], planes * 4, planes)
        for stacked in self.chain_params(s, kmax):
            x = bottleneck_chain(x, *stacked)
        return x

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem_kernel and not self.training and x.is_cuda:
            mul, shift = self.bn1.folded()
            return stem_forward(x, self.kernel_weight(x.dtype), mul, shift)
        if self.stem_kernel and self.training and self.stop_grad_stage >= 0:
            # frozen stem in training (csn.py:339-370 of the JAX package):
            # phase 1 the batch statistics of the bare conv, phase 2 the
            # pooled kernel with the batch affine; nothing differentiates
            w = self.kernel_weight(x.dtype)
            x = x.detach()
            mean, var = stem_batch_stats(x, w)
            mul, shift = self.bn1.batch_affine(mean, var)
            return stem_forward(x, w, mul.detach(), shift.detach())
        x = channels_last(self.conv1._conv_forward(
            channels_first(x), cast(self.conv1.weight, x), None))
        x = F.relu(self.bn1(x))
        return channels_last(F.max_pool3d(channels_first(x), (1, 3, 3),
                                          (1, 2, 2), (0, 1, 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        frozen = self.stop_grad_stage if self.training else -1
        # the frozen prefix (stem + stages 1..frozen) runs without autograd:
        # the JAX package's stop_gradient at that boundary (csn.py:375-378,
        # 427-428)
        with torch.set_grad_enabled(torch.is_grad_enabled() and frozen < 0):
            x = self.stem(x)
        for s in range(len(self.block_nums)):
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and s + 1 > frozen):
                x = self.stage(s, x)
        return x


def build_csn(backbone_name: str, last_stride: bool,
              stem_kernel: bool = True, stop_grad_stage: int = -1,
              use_pallas: bool = False, fused_blocks: bool = False,
              fused_stages: bool = False) -> CSN:
    if backbone_name not in BLOCK_NUMS:
        raise ValueError(f"unknown backbone {backbone_name!r}; "
                         f"supported: {sorted(BLOCK_NUMS)}")
    return CSN(BLOCK_NUMS[backbone_name], last_stride, stem_kernel,
               stop_grad_stage, use_pallas, fused_blocks, fused_stages)
