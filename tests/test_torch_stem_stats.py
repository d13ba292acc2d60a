"""The PyTorch port's stem statistics kernel (csrc/stem_stats.cu, wrapper
``stem_batch_stats`` in tubelet_transformer_tpu_torch/ops/cuda/stem.py)
against the JAX package's ``stem_batch_stats`` (ops/pallas/stem.py).

JAX is imported inside fixtures, so that the CUDA tests also run where JAX
is not installed:
  python -m pytest tests/test_torch_stem_stats.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_stem import _inputs, _torch, cuda, interpret, jax_stem  # noqa: F401

from tubelet_transformer_tpu_torch.ops.cuda import stem

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _structured_inputs(shape, seed=1):
    """x on an offset that changes with the clip and the frame and over
    bands of 24 rows and of 40 columns, and w with a positive mean, so that
    every channel's |mean| is 2-4x its std: a kernel that skips or repeats
    part of the conv output moves the statistics past the limits below."""
    b, t, h, w, _ = shape
    rng = np.random.default_rng(seed)
    bt = np.arange(b)[:, None] + np.arange(t)[None, :]
    offset = (1.0 + 0.5 * (bt % 3)[:, :, None, None, None]
              + 0.5 * ((np.arange(h) // 24) % 2)[:, None, None]
              - 0.25 * ((np.arange(w) // 40) % 3)[:, None])
    x = offset + 0.5 * rng.normal(size=shape)
    w = rng.normal(size=stem.W_SHAPE) * 0.05 + 0.01
    return x.astype(np.float32), w.astype(np.float32)


def _stats_want(jax_stem, x, w):
    """Mean and biased variance of the JAX composite's bare conv."""
    one, zero = np.ones(64, np.float32), np.zeros(64, np.float32)
    y = np.asarray(jax_stem._stem_xla(x, w, one, zero, relu=False),
                   np.float64)                        # (B,T,64,Hc,Wc)
    return y.mean((0, 1, 3, 4)), y.var((0, 1, 3, 4))


@pytest.mark.parametrize("shape", [(2, 3, 37, 45, 3), (1, 4, 32, 48, 3)])
def test_plain_stats_match_jax_xla(jax_stem, shape):
    """stem_batch_stats_reference and the CPU stem_batch_stats against the
    statistics of the JAX composite's conv output, float32: summation order
    only, so 1e-5 on statistics of magnitude ~1."""
    x, w, _, _ = _inputs(shape)
    want_mean, want_var = _stats_want(jax_stem, x, w)
    launches = stem.STATS_LAUNCHES
    for fn in (stem.stem_batch_stats_reference, stem.stem_batch_stats):
        mean, var = fn(*_torch(x, w))
        assert mean.dtype == var.dtype == torch.float32
        np.testing.assert_allclose(mean.numpy(), want_mean, atol=1e-5)
        np.testing.assert_allclose(var.numpy(), want_var, rtol=1e-5)
    assert stem.STATS_LAUNCHES == launches   # a CPU tensor launches nothing


@pytest.mark.parametrize("width", [256, 224])
def test_plain_stats_match_pallas_kernel(interpret, width):
    """Against the TPU stats kernel itself (K1 + `_stem_stats_matmul`,
    interpret mode) at W' = 128 and at W' = 112, where the TPU kernel masks
    its ghost lanes. It rounds x and w to bf16 before its f32 accumulation,
    so the tolerances of tests/test_pallas_stem.py: 1e-3 on the mean, 5e-3
    on the variance."""
    x, w, _, _ = _inputs((1, 2, 32, width, 3), seed=5)
    want_mean, want_var = interpret.stem_batch_stats(
        interpret.stem_prep(x), x.shape, w)
    mean, var = stem.stem_batch_stats_reference(*_torch(x, w))
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), atol=1e-3)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_var), atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((2, 32, 256, 256, 3), torch.bfloat16),
    ((2, 32, 224, 224, 3), torch.bfloat16),
    ((2, 32, 224, 400, 3), torch.bfloat16),
    ((2, 32, 250, 230, 3), torch.bfloat16),
    ((2, 3, 37, 45, 3), torch.float32),
])
def test_stats_kernel_matches_plain_on_cuda(cuda, shape, dtype):
    """The stats kernel against stem_batch_stats_reference on the card, on
    structured inputs (the train steps' batches of 2 at 256 px, 224 px and
    the JHMDB canvas 224x400, and a ragged shape). bf16 (the tensor-core
    kernel): the plain version
    rounds the conv output to bf16 before it reduces, the kernel reduces
    the f32 accumulator; a float64 emulation of that rounding on these
    inputs gives 0.08 (mean) and 0.30 (var) of the limits, 2^-12 of the
    largest std on the mean and 2^-12 relative on the variance, while one
    skipped conv column moves them by ~100x. That rounding noise shrinks as
    1/sqrt(conv pixels), so the ragged bf16 case keeps the train shape's
    ~1e6 pixels: at 250x230 the 16x16 tiles leave 13 conv rows and 3
    columns to mask. float32 (TF32 off): summation order only. Repeated
    runs give the same bits."""
    torch.backends.cudnn.allow_tf32 = False
    x, w = _structured_inputs(shape)
    x, w = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    launches = stem.STATS_LAUNCHES
    mean, var = stem.stem_batch_stats(x, w)
    again = stem.stem_batch_stats(x, w)
    torch.cuda.synchronize()
    assert stem.STATS_LAUNCHES == launches + 2
    assert torch.equal(mean, again[0]) and torch.equal(var, again[1])
    want_mean, want_var = stem.stem_batch_stats_reference(x, w)
    bf16 = dtype == torch.bfloat16
    mean_tol = (2.0 ** -12 if bf16 else 1e-6) * want_var.sqrt().max().item()
    assert (mean - want_mean).abs().max().item() <= mean_tol
    assert ((var - want_var).abs() / want_var).max().item() <= (
        2.0 ** -12 if bf16 else 1e-5)
