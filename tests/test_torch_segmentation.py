"""The PyTorch port's segmentation heads and mask losses
(models/segmentation.py) against the JAX package's, float32 on the CPU.

The JAX modules' weights (their init, with random biases and GroupNorm
affines) cross over through ``convert.load_mh_attention_map`` /
``convert.load_mask_head`` with ``strict=True``. The port is NCHW, the JAX
package NHWC. The resizes are held both up and down: torch's bilinear
(half-pixel centres, no antialias) against ``jax.image.resize(method=
"linear", antialias=False)``. JAX is imported inside a fixture, so that the
CUDA cases also run where JAX is not installed:
  python -m pytest tests/test_torch_segmentation.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
from torch_fixtures import cuda, one_torch_thread  # noqa: F401

from tubelet_transformer_tpu_torch import convert
from tubelet_transformer_tpu_torch.models import segmentation as seg

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (pred h, w) -> (target H, W): up by 2, up by a ragged factor, down by a
# ragged factor
RESIZES = {"up2": ((8, 12), (16, 24)), "up_ragged": ((5, 7), (13, 18)),
           "down_ragged": ((16, 24), (6, 10))}
# MaskHeadSmallConv: the context dim, heads, queries, the memory's H x W
# and the three FPN levels' sizes, coarse to fine
CD, NH, FPN_DIMS = 128, 8, (48, 24, 16)
FPN_SIZES = {"pow2": ((4, 6), ((8, 12), (16, 24), (32, 48))),
             "ragged": ((4, 6), ((5, 7), (9, 13), (17, 25)))}


@pytest.fixture
def jseg():
    pytest.importorskip("jax")
    from tubelet_transformer_tpu.models import segmentation as js

    return js


def _randomize(params, rng):
    """Random biases and GroupNorm affines in a flax params tree (the
    inits are zero biases and identity norms)."""
    for k, p in params.items():
        if isinstance(p, dict):
            _randomize(p, rng)
        elif k == "bias":
            params[k] = rng.normal(0, 0.1, p.shape).astype(np.float32)
        elif k == "scale":
            params[k] = rng.uniform(0.5, 1.5, p.shape).astype(np.float32)


def _init(module, rng, *args):
    import jax

    params = jax.device_get(module.init(jax.random.PRNGKey(0), *args))[
        "params"]
    params = jax.tree.map(np.array, params)
    _randomize(params, rng)
    return params


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _mask_inputs(rng, hw, sizes):
    live, pad = 4, 2
    pred = rng.normal(0, 1.5, (live + pad, *hw)).astype(np.float32)
    tgt = (rng.uniform(size=(live + pad, *sizes)) > 0.5).astype(np.float32)
    valid = np.array([True] * live + [False] * pad)
    return pred, tgt, valid, float(live)


@pytest.mark.parametrize("resize", sorted(RESIZES))
def test_losses_match_jax(jseg, resize):
    """dice_loss, sigmoid_focal_loss (padded rows masked) and loss_masks
    (which resizes the predictions to the targets' size): float32,
    summation order only, so rtol 1e-5."""
    hw, sizes = RESIZES[resize]
    pred, tgt, valid, n = _mask_inputs(np.random.default_rng(0), hw, sizes)
    want = jseg.loss_masks(pred, tgt, valid, n)
    got = seg.loss_masks(_t(pred), _t(tgt), _t(valid), n)
    assert set(got) == set(want) == {"loss_mask", "loss_dice"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    # the two losses alone, on targets at the predictions' size
    tgt_hw = (np.random.default_rng(1).uniform(size=pred.shape) > 0.5
              ).astype(np.float32)
    for name in ("dice_loss", "sigmoid_focal_loss"):
        for v in (None, valid):
            w = getattr(jseg, name)(pred, tgt_hw, n, valid=v)
            g = getattr(seg, name)(_t(pred), _t(tgt_hw), n,
                                   valid=None if v is None else _t(v))
            np.testing.assert_allclose(g.item(), float(w), rtol=1e-5,
                                       err_msg=name)
    # a padded row adds nothing
    pred2 = pred.copy()
    pred2[~valid] = 50.0
    again = seg.loss_masks(_t(pred2), _t(tgt), _t(valid), n)
    for k in want:
        assert again[k].item() == got[k].item(), k


@pytest.mark.parametrize("resize", sorted(RESIZES))
def test_postprocess_masks_matches_jax(jseg, resize):
    """Equal booleans wherever the upsampled probability is not within 1e-4
    of the 0.5 threshold (where float32 rounding may flip it)."""
    import jax
    import jax.numpy as jnp

    hw, size = RESIZES[resize]
    pred = np.random.default_rng(2).normal(0, 1.5, (2, 3, *hw)).astype(
        np.float32)
    want = np.asarray(jseg.postprocess_masks(pred, size))
    prob = np.asarray(jax.nn.sigmoid(jax.image.resize(
        jnp.asarray(pred), (2, 3, *size), method="linear", antialias=False)))
    got = seg.postprocess_masks(_t(pred), size).numpy()
    assert got.shape == want.shape == (2, 3, *size) and got.dtype == bool
    away = np.abs(prob - 0.5) > 1e-4
    assert away.mean() > 0.99
    np.testing.assert_array_equal(got[away], want[away])


@pytest.mark.parametrize("masked", [False, True])
def test_mh_attention_map_matches_jax(jseg, masked):
    """The maps, softmaxed over (heads, H, W) jointly, with and without a
    padding mask: atol 1e-6."""
    e, nh, b, q, h, w = 64, 4, 2, 5, 6, 9
    rng = np.random.default_rng(3)
    qx = rng.normal(0, 1, (b, q, e)).astype(np.float32)
    kx = rng.normal(0, 1, (b, h, w, e)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((b, h, w), bool)
        mask[1, :, 6:] = True
    jmod = jseg.MHAttentionMap(e, e, nh)
    params = _init(jmod, rng, qx, kx, mask)
    want = np.asarray(jmod.apply({"params": params}, qx, kx, mask))
    mod = convert.load_mh_attention_map(seg.MHAttentionMap(e, e, nh), params)
    got = mod(_t(qx), _t(kx.transpose(0, 3, 1, 2)),
              None if mask is None else _t(mask)).detach().numpy()
    assert got.shape == (b, q, nh, h, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the softmax runs over (heads, H, W) jointly
    np.testing.assert_allclose(got.sum(axis=(2, 3, 4)), 1.0, rtol=1e-5)
    if masked:
        assert not got[1, :, :, :, 6:].any()


def _mask_head_inputs(rng, sizes, b=2, q=3):
    (h, w), fpn_hw = sizes
    x = rng.normal(0, 1, (b, h, w, CD)).astype(np.float32)
    bbox_mask = rng.uniform(0, 1, (b, q, NH, h, w)).astype(np.float32)
    fpns = [rng.normal(0, 1, (b, *hw, c)).astype(np.float32)
            for hw, c in zip(fpn_hw, FPN_DIMS)]
    return x, bbox_mask, fpns


@pytest.mark.parametrize("sizes", sorted(FPN_SIZES))
def test_mask_head_matches_jax(jseg, sizes):
    """The FPN mask head (the memory repeated per query, the nearest
    upsample at each level, GroupNorm(8)): within 1e-4 of max|JAX|."""
    rng = np.random.default_rng(4)
    x, bbox_mask, fpns = _mask_head_inputs(rng, FPN_SIZES[sizes])
    jmod = jseg.MaskHeadSmallConv(CD + NH, FPN_DIMS, CD)
    params = _init(jmod, rng, x, bbox_mask, fpns)
    want = np.asarray(jmod.apply({"params": params}, x, bbox_mask, fpns))
    mod = convert.load_mask_head(
        seg.MaskHeadSmallConv(CD + NH, FPN_DIMS, CD), params)
    got = mod(_t(x.transpose(0, 3, 1, 2)), _t(bbox_mask),
              [_t(f.transpose(0, 3, 1, 2)) for f in fpns]).detach().numpy()
    assert got.shape == (6, 1, *FPN_SIZES[sizes][1][-1])
    np.testing.assert_allclose(got[:, 0], want[..., 0], rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_group_norm_matches_flax_at_large_mean():
    """GroupNorm(8) against flax's ``nn.GroupNorm`` where |mean| >> std:
    inputs at 4096 with offsets in steps of 2^-8, where one float32 ulp of
    E[x^2] is 2 and the variances are O(1). Each group reduces two elements
    (C = 16, 1x1 maps), so both frameworks add in the same order; torch's
    own two-pass ``F.group_norm`` parts from both."""
    pytest.importorskip("jax")
    import flax.linen as nn

    rng = np.random.default_rng(5)
    step = np.float32(2.0 ** -8)
    d = np.round(rng.normal(size=(3, 16)) * np.geomspace(0.05, 8.0, 16)
                 / step) * step
    x = (np.float32(4096.0) + d).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    want = np.asarray(nn.GroupNorm(num_groups=8, epsilon=seg.GN_EPS).apply(
        {"params": {"scale": weight, "bias": bias}}, x[:, None, None, :]))
    gn = seg.GroupNorm(8, 16, eps=seg.GN_EPS)
    with torch.no_grad():
        gn.weight.copy_(_t(weight))
        gn.bias.copy_(_t(bias))
        got = gn(_t(x[:, :, None, None])).numpy()[:, :, 0, 0]
        two_pass = torch.nn.functional.group_norm(
            _t(x[:, :, None, None]), 8, _t(weight), _t(bias),
            seg.GN_EPS).numpy()[:, :, 0, 0]
    err = np.abs(got - want[:, 0, 0]).max()
    assert err <= 1e-5 * np.abs(want).max(), err
    assert np.abs(two_pass - want[:, 0, 0]).max() > 100 * max(err, 1e-7)


@pytest.mark.cuda
def test_heads_and_losses_on_cuda_match_cpu(cuda):
    """The heads, the losses and postprocess on the card against the CPU,
    float32 with TF32 off: summation order only."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(6)
    x, bbox_mask, fpns = _mask_head_inputs(rng, FPN_SIZES["ragged"])
    qx = rng.normal(0, 1, (2, 3, CD)).astype(np.float32)
    mask = np.zeros((2, 4, 6), bool)
    mask[1, :, 4:] = True
    pred, tgt, valid, n = _mask_inputs(rng, (8, 12), (16, 24))
    attn = seg.MHAttentionMap(CD, CD, NH)
    head = seg.MaskHeadSmallConv(CD + NH, FPN_DIMS, CD)
    for i, m in enumerate((attn, head)):
        seg.init_weights(m, torch.Generator().manual_seed(i))
    outs = {}
    for dev in ("cpu", cuda):
        with torch.no_grad():
            maps = attn.to(dev)(_t(qx, dev), _t(x.transpose(0, 3, 1, 2), dev),
                                _t(mask, dev))
            logits = head.to(dev)(_t(x.transpose(0, 3, 1, 2), dev), maps,
                                  [_t(f.transpose(0, 3, 1, 2), dev)
                                   for f in fpns])
            losses = seg.loss_masks(_t(pred, dev), _t(tgt, dev),
                                    _t(valid, dev), n)
        outs[str(dev)] = (maps.cpu(), logits.cpu(),
                          torch.stack(list(losses.values())).cpu())
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
