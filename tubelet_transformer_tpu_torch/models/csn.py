"""irCSN-50/152 backbone, eval mode, channels-last (B, T, H, W, C).

Port of ``tubelet_transformer_tpu/models/csn.py``. Module names follow the
reference's key scheme (``conv1``, ``bn1``, ``layer{s}.{b}.conv3``,
``down_sample.{0,1}``) and parameters keep torch's conv layouts, so
``train.torch_convert`` state dicts load with ``strict=True``.

* BatchNorm runs folded, ``x * mul + shift`` from the running statistics,
  with the reference's epsilon of 1e-3; its statistics stay float32 when
  the rest of the model runs in bfloat16.
* Pointwise 1x1x1 convs are channel matmuls on the channels-last tensor.
* The depthwise 3x3x3 conv is ``F.conv3d(groups=C)`` on a channels-first
  copy, as the JAX package leaves it to XLA by default.
* The stem takes the fused CUDA kernel (``ops/cuda/stem.py``) on a CUDA
  tensor when ``stem_kernel`` is on, and the plain conv + BN + ReLU +
  max-pool otherwise.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tubelet_transformer_tpu_torch.ops.cuda.stem import stem_forward

BN_EPS = 1e-3

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


class FoldableBN(nn.BatchNorm3d):
    """BatchNorm over the last axis in its folded inference form."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS)

    def folded(self):
        """float32 (mul, shift) with the running statistics folded in."""
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return mul, self.bias - self.running_mean * mul

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
        return F.linear(x, self.weight.flatten(1), self.bias)


class DepthwiseConv3d(nn.Conv3d):
    """Depthwise 3x3x3 conv, zero padding 1, on a channels-last tensor.

    The conv runs on a channels-first copy: cuDNN's grouped 3-D conv on
    the channels_last_3d view of the tensor takes ~29x longer than on a
    contiguous channels-first tensor, the two copies included (121 ms
    against 4.2 ms over CSN-152's 50 depthwise convs, bf16, on an NVIDIA
    H100 80GB HBM3 at a 700 W power limit)."""

    def __init__(self, features: int, stride=(1, 1, 1)):
        super().__init__(features, features, 3, stride=stride, padding=1,
                         groups=features, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(channels_first(x).contiguous())
        return channels_last(y).contiguous()


class CSNBottleneck(nn.Module):
    """ir-bottleneck: 1x1x1 -> depthwise 3x3x3 -> 1x1x1, each + BN (+ReLU),
    with a projection shortcut on the first block of a stage."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 temporal_stride: int = 1, has_downsample: bool = False):
        super().__init__()
        st = (temporal_stride, stride, stride)
        self.conv1 = PointwiseConv(in_planes, planes)
        self.bn1 = FoldableBN(planes)
        self.conv3 = DepthwiseConv3d(planes, stride=st)
        self.bn3 = FoldableBN(planes)
        self.conv4 = PointwiseConv(planes, planes * 4)
        self.bn4 = FoldableBN(planes * 4)
        self.down_sample = (nn.Sequential(
            PointwiseConv(in_planes, planes * 4, stride=st),
            FoldableBN(planes * 4)) if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn3(self.conv3(out)))
        out = self.bn4(self.conv4(out))
        residual = x if self.down_sample is None else self.down_sample(x)
        return F.relu(out + residual)


class CSN(nn.Module):
    """irCSN trunk: (B,T,H,W,3) -> (B,T/8,H/16 or H/32,W/..,2048).

    ``last_stride=False`` keeps stage 4 at spatial stride 1."""

    def __init__(self, block_nums: Sequence[int] = (3, 8, 36, 3),
                 last_stride: bool = True, stem_kernel: bool = True):
        super().__init__()
        self.block_nums = tuple(block_nums)
        self.stem_kernel = stem_kernel
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
                              tstride if b == 0 else 1, has_downsample=b == 0)
                for b in range(blocks))))
            if blocks:
                in_planes = planes * 4
        self._kernel_w = None
        self._kernel_w_key = None

    def kernel_weight(self) -> torch.Tensor:
        """The stem weight in the kernel's (3,7,7,3,64) layout, permuted once
        per change of ``conv1.weight`` (load, cast or move), not per call."""
        w = self.conv1.weight
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if key != self._kernel_w_key:
            self._kernel_w = w.detach().permute(2, 3, 4, 1, 0).contiguous()
            self._kernel_w_key = key
        return self._kernel_w

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem_kernel and x.is_cuda:
            mul, shift = self.bn1.folded()
            return stem_forward(x, self.kernel_weight(), mul, shift)
        x = channels_last(self.conv1(channels_first(x)))
        x = F.relu(self.bn1(x))
        return channels_last(F.max_pool3d(channels_first(x), (1, 3, 3),
                                          (1, 2, 2), (0, 1, 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for s in range(len(self.block_nums)):
            x = getattr(self, f"layer{s + 1}")(x)
        return x


def build_csn(backbone_name: str, last_stride: bool,
              stem_kernel: bool = True) -> CSN:
    if backbone_name not in BLOCK_NUMS:
        raise ValueError(f"unknown backbone {backbone_name!r}; "
                         f"supported: {sorted(BLOCK_NUMS)}")
    return CSN(BLOCK_NUMS[backbone_name], last_stride, stem_kernel)
