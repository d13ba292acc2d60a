"""Calls of the wrapper of each kernel that a model path runs, at a shape
that path gives it, bf16, random inputs from seed 0, for the A/B tool
(``tools/ab.py --calls``).

Each function takes no argument and returns ``{name: call}``; the calls
import the port from wherever ``tubelet_transformer_tpu_torch`` is found,
so the A/B tool, which loads this file by path, runs the same calls against
either tree. Shapes are the flagship's (CSN-152, 256 px, one clip; the
train step's two clips for the statistics kernel).
"""

from __future__ import annotations

import numpy as np
import torch


def _dev(rng, shape, scale=1.0, mean=0.0, dtype=torch.bfloat16):
    a = rng.normal(mean, scale, shape).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def _block(rng, x_shape, cm, k=None):
    """x and the nine weights of one block, or of ``k`` stacked blocks."""
    ci = x_shape[-1]
    lead = () if k is None else (k,)
    f32 = torch.float32
    return (_dev(rng, x_shape),
            _dev(rng, (*lead, ci, cm), ci ** -.5),
            _dev(rng, (*lead, 3, 3, 3, cm), .2),
            _dev(rng, (*lead, cm, ci), cm ** -.5),
            *(_dev(rng, (*lead, c), .1, m, f32) for c, m in (
                (cm, 1.), (cm, 0.), (cm, 1.), (cm, 0.), (ci, .2), (ci, 0.))))


def stem_pool() -> dict:
    """The pooled stem, one streaming keyframe: (1,32,256,256,3)."""
    from tubelet_transformer_tpu_torch.ops.cuda import stem

    rng = np.random.default_rng(0)
    x = _dev(rng, (1, 32, 256, 256, 3))
    w = _dev(rng, stem.W_SHAPE, .05)
    scale = _dev(rng, 64, .3, 1., torch.float32)
    bias = _dev(rng, 64, 1., 0., torch.float32)
    return {"stem_pool": lambda: stem.stem_forward(x, w, scale, bias)}


def stem_conv() -> dict:
    """The unpooled stem with the ReLU, which no model path runs, at the
    streaming shape: (1,32,256,256,3)."""
    from tubelet_transformer_tpu_torch.ops.cuda import stem

    rng = np.random.default_rng(0)
    x = _dev(rng, (1, 32, 256, 256, 3))
    w = _dev(rng, stem.W_SHAPE, .05)
    scale = _dev(rng, 64, .3, 1., torch.float32)
    bias = _dev(rng, 64, 1., 0., torch.float32)
    return {"stem_conv": lambda: stem.stem_conv_bn_relu(x, w, scale, bias,
                                                        True)}


def stem_stats() -> dict:
    """The stem statistics, one train step: (2,32,256,256,3)."""
    from tubelet_transformer_tpu_torch.ops.cuda import stem

    rng = np.random.default_rng(0)
    x = _dev(rng, (2, 32, 256, 256, 3))
    w = _dev(rng, stem.W_SHAPE, .05)
    return {"stem_stats": lambda: stem.stem_batch_stats(x, w)}


def depthwise() -> dict:
    """layer1's depthwise: (1,32,64,64,64)."""
    from tubelet_transformer_tpu_torch.ops.cuda import depthwise as D

    rng = np.random.default_rng(0)
    x = _dev(rng, (1, 32, 64, 64, 64))
    w = _dev(rng, (3, 3, 3, 64), .2)
    return {"depthwise": lambda: D.depthwise_conv3x3x3(x, w)}


def depthwise_affine() -> dict:
    """layer1's depthwise with the affine + ReLU epilogue of
    ``_dw_pallas_v2``: (1,32,64,64,64)."""
    from tubelet_transformer_tpu_torch.ops.cuda import depthwise as D

    rng = np.random.default_rng(0)
    x = _dev(rng, (1, 32, 64, 64, 64))
    w = _dev(rng, (3, 3, 3, 64), .2)
    scale = _dev(rng, 64, .3, 1., torch.float32)
    bias = _dev(rng, 64, .5, 0., torch.float32)
    return {"depthwise_affine": lambda: D.depthwise_conv3x3x3(
        x, w, scale, bias, relu=True)}


def bottleneck() -> dict:
    """One fused layer2 block: (1,16,32,32,512), C_mid 128."""
    from tubelet_transformer_tpu_torch.ops.cuda import bottleneck as B

    args = _block(np.random.default_rng(0), (1, 16, 32, 32, 512), 128)
    return {"bottleneck": lambda: B.bottleneck_fused(*args)}


def stage_chain() -> dict:
    """layer3's identity tail as one chain: (1,8,16,16,1024), C_mid 256,
    K 35."""
    from tubelet_transformer_tpu_torch.ops.cuda import stage as S

    args = _block(np.random.default_rng(0), (1, 8, 16, 16, 1024), 256, 35)
    return {"stage_chain": lambda: S.bottleneck_chain(*args)}

