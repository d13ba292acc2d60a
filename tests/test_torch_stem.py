"""The PyTorch port's fused stem (tubelet_transformer_tpu_torch/ops/cuda/
stem.py) against the JAX package's stem (ops/pallas/stem.py).

JAX is imported inside fixtures, not at the top, so that the CUDA test also
runs where JAX is not installed:
  python -m pytest tests/test_torch_stem.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from tubelet_transformer_tpu_torch.ops.cuda import stem


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=stem.W_SHAPE) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    return x, w, scale, bias


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture
def jax_stem():
    pytest.importorskip("jax")
    from tubelet_transformer_tpu.ops.pallas import stem as S

    return S


@pytest.fixture
def interpret(jax_stem):
    """Pallas kernels in interpret mode, as tests/test_pallas_stem.py runs
    them on the CPU."""
    jax_stem._DEBUG["interpret"] = True
    yield jax_stem
    jax_stem._DEBUG["interpret"] = False


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1, 4, 32, 48, 3), (2, 3, 37, 45, 3)])
def test_plain_stem_matches_jax_xla(jax_stem, shape):
    """stem_reference and the CPU stem_forward against the JAX composite
    ``_stem_xla(pool=True)``, float32: only summation order differs, so
    1e-5 on outputs of magnitude ~1."""
    x, w, scale, bias = _inputs(shape)
    want = np.asarray(jax_stem._stem_xla(x, w, scale, bias, relu=True,
                                         pool=True))
    launches = stem.LAUNCHES
    for fn in (stem.stem_reference, stem.stem_forward):
        got = fn(*_torch(x, w, scale, bias))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert stem.LAUNCHES == launches      # a CPU tensor launches nothing


def test_plain_stem_matches_pallas_kernel(interpret):
    """Against the TPU kernel itself (K1 _deinterleave + K2 _stem_matmul,
    interpret mode) at the smallest shape it takes. The kernel rounds its
    input and its scale-folded weights to bf16, so the tolerance is the
    bf16 one of tests/test_pallas_stem.py (the random BN scale amplifies
    rounding)."""
    x, w, scale, bias = _inputs((1, 2, 32, 128, 3))
    want = np.asarray(interpret.stem_forward(x, w, scale, bias), np.float32)
    got = stem.stem_reference(*_torch(x, w, scale, bias))
    assert got.shape == want.shape == (1, 2, 8, 32, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=6e-2)


@pytest.mark.parametrize("bad", ["rank", "channels", "dtype", "w_shape",
                                 "w_dtype", "scale_dtype", "strided"])
def test_check_inputs_rejects(bad):
    x, w, scale, bias = _torch(*_inputs((1, 2, 16, 16, 3)))
    if bad == "rank":
        x = x[0]
    elif bad == "channels":
        x = torch.zeros(1, 2, 16, 16, 4)
    elif bad == "dtype":
        x, w = x.half(), w.half()
    elif bad == "w_shape":
        w = w.permute(4, 3, 0, 1, 2).contiguous()
    elif bad == "w_dtype":
        w = w.to(torch.bfloat16)
    elif bad == "scale_dtype":
        scale = scale.double()
    elif bad == "strided":
        x = torch.zeros(1, 2, 16, 32, 3)[:, :, :, ::2]
    with pytest.raises(ValueError):
        stem.check_inputs(x, w, scale, bias)
    stem.check_inputs(*_torch(*_inputs((1, 2, 16, 16, 3))))


def test_pooled_hw_matches_reference():
    for h, w in [(256, 256), (224, 224), (37, 45), (1, 2)]:
        x, wt, scale, bias = _torch(*_inputs((1, 1, h, w, 3)))
        assert stem.stem_reference(x, wt, scale, bias).shape[2:4] == \
            stem.pooled_hw(h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((1, 32, 256, 256, 3), torch.bfloat16),
    ((1, 32, 224, 224, 3), torch.bfloat16),
    ((2, 3, 37, 45, 3), torch.float32),
])
def test_kernel_matches_plain_on_cuda(cuda, shape, dtype):
    """The CUDA kernel against stem_reference on the card. bf16: the plain
    version rounds its conv output to bf16 before the f32 epilogue, the
    kernel rounds once, so 2^-6 of the output range. float32 (TF32 off):
    summation order only."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, scale, bias = _inputs(shape)
    x, w = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    scale, bias = (torch.from_numpy(a).to(cuda) for a in (scale, bias))
    launches = stem.LAUNCHES
    got = stem.stem_forward(x, w, scale, bias)
    torch.cuda.synchronize()
    assert stem.LAUNCHES == launches + 1
    want = stem.stem_reference(x, w, scale, bias)
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    span = want.float().abs().max().item()
    assert err <= (2.0 ** -6 if dtype == torch.bfloat16 else 1e-5) * span


@pytest.mark.cuda
def test_pooled_kernel_gradient_on_cuda(cuda):
    """stem_forward on tensors that need gradients runs the kernel forward
    and the plain version's backward (the JAX package's custom VJP);
    float32 with TF32 off: the gradients equal the plain version's up to
    summation order."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, scale, bias = (torch.from_numpy(a).to(cuda)
                         for a in _inputs((1, 4, 32, 48, 3)))
    grads = []
    for fn in (stem.stem_forward, stem.stem_reference):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xg, wg, scale, bias).square().sum().backward()
        grads.append((xg.grad, wg.grad))
    for got, want in zip(*grads):
        assert (got - want).norm() <= 1e-5 * want.norm()
