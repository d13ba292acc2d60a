"""The PyTorch port's fused stem (tubelet_transformer_tpu_torch/ops/cuda/
stem.py) against the JAX package's stem (ops/pallas/stem.py).

JAX is imported inside fixtures, not at the top, so that the CUDA test also
runs where JAX is not installed:
  python -m pytest tests/test_torch_stem.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
from torch_fixtures import cuda  # noqa: F401

from tubelet_transformer_tpu_torch.ops.cuda import stem


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=stem.W_SHAPE) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    return x, w, scale, bias


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 values, kept in float32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


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


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(1, 4, 32, 48, 3), (2, 3, 37, 45, 3)])
def test_plain_conv_matches_jax_xla(jax_stem, shape, relu):
    """stem_conv_reference and the CPU stem_conv_bn_relu against the JAX
    composite ``_stem_xla(pool=False)``, float32, in its channels-mid
    (B,T,64,Hc,Wc) layout: summation order only, so 1e-5."""
    x, w, scale, bias = _inputs(shape)
    want = np.asarray(jax_stem._stem_xla(x, w, scale, bias, relu=relu))
    b, t, h, wd, _ = shape
    assert want.shape == (b, t, 64, (h + 1) // 2, (wd + 1) // 2)
    launches = stem.CONV_LAUNCHES
    for got in (stem.stem_conv_reference(*_torch(x, w, scale, bias), relu),
                stem.stem_conv_bn_relu(*_torch(x, w, scale, bias), relu)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert stem.CONV_LAUNCHES == launches   # a CPU tensor launches nothing


@pytest.mark.parametrize("relu", [True, False])
def test_plain_conv_matches_pallas_kernel(interpret, relu):
    """The CPU stem_conv_bn_relu against the TPU kernel (K1 + K2 with
    pool=False, interpret mode) at the smallest shape it takes (W/2 = 128),
    with the unit affine of tests/test_pallas_stem.py:109. On bf16-rounded
    x and w, the kernel differs by the rounding of its sum to bf16: 5e-3 of
    max|ref|, the limit of tests/test_pallas_stem.py:112."""
    x, w, _, _ = _inputs((1, 2, 32, 256, 3))
    x, w = _bf16(x), _bf16(w)
    scale, bias = np.ones(64, np.float32), np.zeros(64, np.float32)
    want = np.asarray(interpret.stem_conv_bn_relu(x, w, scale, bias, relu),
                      np.float32)
    got = stem.stem_conv_bn_relu(*_torch(x, w, scale, bias), relu).numpy()
    assert got.shape == want.shape == (1, 2, 64, 16, 128)
    assert np.abs(got - want).max() < 5e-3 * np.abs(want).max()


def test_conv_backward_is_plain_vjp(jax_stem):
    """The unpooled stem's autograd Function backward (plain_vjp through
    stem_conv_reference) against the VJP of ``_stem_xla(pool=False)``, the
    JAX custom VJP's backward, float32."""
    import jax

    x, w, scale, bias = _inputs((1, 2, 16, 20, 3))
    g = np.random.default_rng(3).normal(size=(1, 2, 64, 8, 10)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda *a: jax_stem._stem_xla(*a, relu=True),
                     x, w, scale, bias)
    want = vjp(g)
    got = stem.plain_vjp(stem.stem_conv_reference,
                         _torch(x, w, scale, bias), (True,) * 4,
                         torch.from_numpy(g), relu=True)
    for gw, ww in zip(got, want):
        ww = np.asarray(ww)
        assert np.abs(gw.numpy() - ww).max() <= 1e-4 * np.abs(ww).max()


def test_pooled_hw_matches_reference():
    for h, w in [(256, 256), (224, 224), (37, 45), (1, 2)]:
        x, wt, scale, bias = _torch(*_inputs((1, 1, h, w, 3)))
        assert stem.stem_reference(x, wt, scale, bias).shape[2:4] == \
            stem.pooled_hw(h, w)


def test_round_then_pool_equals_pool_then_round():
    """The identity the bf16 pooled kernel relies on: rounding each value to
    bf16 and then max-pooling (1x3x3 / (1,2,2) / pad (0,1,1), as
    stem_reference pools) equals max-pooling in float32 and rounding once,
    on values that bf16 does not represent, values it does, ties halfway
    between two bf16 values, negatives, zeros and a NaN."""
    import torch.nn.functional as F

    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 64, 3, 17, 19)).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = _bf16(flat[::7])                       # representable
    # halfway between two bf16 values: the low 16 bits of the float32 0x8000
    flat[1::11] = (_bf16(flat[1::11]).view(np.uint32) | 0x8000).view(
        np.float32)
    flat[2::13] = 0.0
    flat[3::17] = -np.abs(flat[3::17])
    flat[100] = np.nan
    t = torch.from_numpy(x)

    def pool(v):
        return F.max_pool3d(v, (1, 3, 3), (1, 2, 2), (0, 1, 1))

    first = pool(t.to(torch.bfloat16).float())
    last = pool(t).to(torch.bfloat16).float()
    assert torch.isnan(first).any()
    torch.testing.assert_close(first, last, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((1, 32, 256, 256, 3), torch.bfloat16),
    ((1, 32, 224, 224, 3), torch.bfloat16),
    ((1, 32, 224, 400, 3), torch.bfloat16),
    ((2, 32, 224, 400, 3), torch.bfloat16),
    ((2, 3, 37, 45, 3), torch.bfloat16),
    ((2, 3, 37, 45, 3), torch.float32),
])
def test_kernel_matches_plain_on_cuda(cuda, shape, dtype):
    """The CUDA kernel against stem_reference on the card, and a repeat
    launch bit for bit. bf16 (the tensor-core kernel; the JHMDB canvas
    224x400 in eval and in the train step's batch of 2; the ragged shape
    checks its edge masking): the plain version rounds its conv output to
    bf16 before the f32 epilogue, the kernel rounds once, so 2^-6 of the
    output range. float32 (TF32 off): summation order only."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, scale, bias = _inputs(shape)
    x, w = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    scale, bias = (torch.from_numpy(a).to(cuda) for a in (scale, bias))
    launches = stem.LAUNCHES
    got = stem.stem_forward(x, w, scale, bias)
    again = stem.stem_forward(x, w, scale, bias)
    torch.cuda.synchronize()
    assert stem.LAUNCHES == launches + 2 and torch.equal(got, again)
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,relu", [
    ((1, 32, 256, 256, 3), torch.bfloat16, True),
    ((1, 32, 224, 224, 3), torch.bfloat16, False),
    ((2, 3, 37, 45, 3), torch.bfloat16, True),
    ((1, 3, 50, 80, 3), torch.bfloat16, False),
    ((2, 3, 37, 45, 3), torch.float32, True),
])
def test_conv_kernel_matches_plain_on_cuda(cuda, shape, dtype, relu):
    """The unpooled CUDA kernel against stem_conv_reference on the card, in
    the channels-mid layout. bf16 (the tensor-core kernel; at 37x45 its
    16x16 tiles' ragged edge and rows of 23 px, at 50x80 rows of 40 px that
    end mid-tile): the plain version rounds its conv output to bf16 before
    the f32 affine, the kernel rounds once, so 2^-6 of the output range;
    float32 (TF32 off): summation order only."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, scale, bias = _inputs(shape)
    x, w = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    scale, bias = (torch.from_numpy(a).to(cuda) for a in (scale, bias))
    launches = stem.CONV_LAUNCHES
    got = stem.stem_conv_bn_relu(x, w, scale, bias, relu)
    torch.cuda.synchronize()
    assert stem.CONV_LAUNCHES == launches + 1
    want = stem.stem_conv_reference(x, w, scale, bias, relu)
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    span = want.float().abs().max().item()
    assert err <= (2.0 ** -6 if dtype == torch.bfloat16 else 1e-5) * span


def _pool_channels_mid(y: torch.Tensor) -> torch.Tensor:
    """1x3x3 / (1,2,2) / pad (0,1,1) max-pool of a (B,T,64,Hc,Wc) tensor,
    channels-last out (B,T,Hp,Wp,64), as stem_forward lays it out."""
    import torch.nn.functional as F

    b, t = y.shape[:2]
    p = F.max_pool2d(y.flatten(0, 1), 3, 2, 1)
    return p.unflatten(0, (b, t)).permute(0, 1, 3, 4, 2).contiguous()


@pytest.mark.parametrize("shape", [(1, 4, 32, 48, 3), (2, 3, 37, 45, 3)])
def test_pooled_conv_reference_is_stem_reference(shape):
    """The partner check's pool, on the CPU: the unpooled plain version with
    the ReLU, max-pooled by _pool_channels_mid, is the pooled plain version,
    float32, bit for bit."""
    args = _torch(*_inputs(shape))
    torch.testing.assert_close(
        _pool_channels_mid(stem.stem_conv_reference(*args, relu=True)),
        stem.stem_reference(*args), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 32, 256, 256, 3),
                                   (1, 32, 224, 224, 3)])
def test_conv_kernel_pools_to_pooled_kernel_on_cuda(cuda, shape):
    """The unpooled bf16 kernel with the ReLU, max-pooled, equals the pooled
    kernel bit for bit: one GEMM body, k order and epilogue, and rounding
    is monotone (test_round_then_pool_equals_pool_then_round)."""
    x, w, scale, bias = _inputs(shape, seed=4)
    x, w = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (x, w))
    scale, bias = (torch.from_numpy(a).to(cuda) for a in (scale, bias))
    pooled = stem.stem_forward(x, w, scale, bias)
    conv = stem.stem_conv_bn_relu(x, w, scale, bias, True)
    torch.cuda.synchronize()
    assert torch.equal(_pool_channels_mid(conv), pooled)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((1, 32, 256, 256, 3),
                                          torch.bfloat16),
                                         ((2, 3, 37, 45, 3), torch.float32)])
def test_conv_kernel_repeat_is_bit_equal_on_cuda(cuda, shape, dtype):
    """Each conv output is summed in one fixed order: a repeat launch gives
    the same bits."""
    x, w, scale, bias = _inputs(shape, seed=5)
    x, w = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    scale, bias = (torch.from_numpy(a).to(cuda) for a in (scale, bias))
    got = stem.stem_conv_bn_relu(x, w, scale, bias, False)
    again = stem.stem_conv_bn_relu(x, w, scale, bias, False)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
