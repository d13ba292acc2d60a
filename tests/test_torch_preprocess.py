"""The PyTorch port's on-device preprocessing (data/device_preprocess.py)
against the JAX package's: the cv2-convention HSV conversions, the jitter
with fixed shifts (the JAX function's random draws replaced by the same
numbers), the draw's range, and normalisation with the pad mask. float32
on the CPU; inputs are [0, 255] pixel values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tubelet_transformer_tpu.data import device_preprocess as J
from tubelet_transformer_tpu_torch.data import device_preprocess as P


def _clips(shape=(3, 2, 6, 7, 3), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape).astype(np.uint8)
    x[0, 0, 0, :3] = [[0, 0, 0], [255, 255, 255], [80, 80, 80]]   # grays
    x[0, 0, 1, :3] = [[255, 0, 0], [0, 255, 0], [0, 0, 255]]      # primaries
    return x


def test_hsv_conversions_match_jax():
    """Both directions and the round trip; float32 op order only, so 1e-3
    on values in [0, 255]."""
    x = _clips().astype(np.float32)
    want = np.asarray(J.rgb_to_hsv_cv(jnp.asarray(x)))
    got = P.rgb_to_hsv_cv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    hsv = want.copy()
    np.testing.assert_allclose(
        P.hsv_cv_to_rgb(torch.from_numpy(hsv)).numpy(),
        np.asarray(J.hsv_cv_to_rgb(jnp.asarray(hsv))), atol=1e-3)
    np.testing.assert_allclose(
        P.hsv_cv_to_rgb(P.rgb_to_hsv_cv(torch.from_numpy(x))).numpy(), x,
        atol=1e-3)


def test_jitter_with_fixed_shifts_matches_jax(monkeypatch):
    """The per-clip shifts (hue wraps at 180, saturation and value clip)
    with the same numbers on both sides: the JAX function's three
    ``jax.random.randint`` draws return them in the order it draws."""
    x = _clips().astype(np.float32)
    shifts = [np.array([-10, 3, 10]), np.array([26, -26, 0]),
              np.array([-5, 26, -26])]          # hue, sat, val per clip
    draws = iter(shifts)
    monkeypatch.setattr(J.jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(
                            next(draws)).reshape(shape))
    want = np.asarray(J.hsv_jitter(jnp.asarray(x), jax.random.PRNGKey(0)))
    got = P.hsv_shift(torch.from_numpy(x), *(torch.from_numpy(s).float()
                                             for s in shifts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_jitter_draws_one_shift_per_clip_within_bounds():
    x = torch.full((64, 1, 2, 2, 3), 128.0)
    x[..., 0] = 200.0                           # a saturated colour
    g = torch.Generator().manual_seed(0)
    out = P.hsv_jitter(x, g)
    hsv, base = P.rgb_to_hsv_cv(out), P.rgb_to_hsv_cv(x)
    # one shift per clip: every pixel of a clip moved alike
    assert torch.allclose(hsv, hsv[:, :1, :1, :1].expand_as(hsv), atol=1e-3)
    d = (hsv - base)[:, 0, 0, 0]
    dh = torch.remainder(d[:, 0] + 90.0, 180.0) - 90.0
    assert dh.abs().max() <= 10 + 1e-3 and d[:, 1:].abs().max() <= 26 + 1e-3
    assert len(torch.unique(dh.round())) > 5    # the draws vary
    torch.testing.assert_close(P.hsv_jitter(x, torch.Generator().manual_seed(
        0)), out)                               # and replay from the seed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalise_and_pad_mask_match_jax(dtype):
    """uint8 -> ImageNet-normalised, the padded canvas zeroed after
    normalising; a float input passes through, cast."""
    x = _clips()
    pad = np.zeros(x.shape[:1] + x.shape[2:4], bool)
    pad[:, 4:] = True
    want = np.asarray(J.device_preprocess(jnp.asarray(x),
                                          pad_mask=jnp.asarray(pad)))
    got = P.device_preprocess(torch.from_numpy(x), dtype=dtype,
                              pad_mask=torch.from_numpy(pad))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-5 if dtype == torch.float32 else 2e-2)
    assert not got[:, :, 4:].any()
    xf = torch.randn(1, 2, 3, 3, 3)
    assert P.device_preprocess(xf, jitter=True).equal(xf)
