"""The PyTorch port's depthwise 3x3x3 conv (tubelet_transformer_tpu_torch/
ops/cuda/depthwise.py) against the JAX package's (ops/pallas/depthwise.py).

``_dw_pallas`` and ``_dw_pallas_v2`` have no interpret switch, so on the CPU
the port's plain version is held to ``_dw_lax``, the composite that the JAX
package's own CPU test holds (tests/test_pallas_depthwise.py). JAX is
imported inside a fixture, so that the CUDA tests also run where JAX is not
installed:
  python -m pytest tests/test_torch_depthwise.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
from torch_fixtures import cuda  # noqa: F401

from tubelet_transformer_tpu_torch.ops.cuda import depthwise as D

RAGGED = (2, 5, 7, 9, 64)
# Shapes that the kernel's blocks (16x16 pixels, 32 bf16 or 16 float
# channels, runs of 8 frames) do not divide: T not a multiple of the run,
# H and W not multiples of the tile, C = 8 and C = 72 (a partial channel
# slice), and two clips of five frames, where the frame window resets at
# each clip's edges.
KERNEL_RAGGED = [(1, 11, 16, 16, 64), (1, 8, 20, 37, 64),
                 (1, 9, 18, 17, 8), (1, 9, 18, 17, 72), (2, 5, 16, 16, 64)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(0, 0.2, (3, 3, 3, c)).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.normal(0, 0.5, c).astype(np.float32))


@pytest.fixture
def jax_dw():
    pytest.importorskip("jax")
    from tubelet_transformer_tpu.ops.pallas import depthwise as JD

    return JD


@pytest.mark.parametrize("shape", [RAGGED, (2, 5, 7, 9, 8), *KERNEL_RAGGED])
def test_plain_matches_jax_lax(jax_dw, shape):
    """depthwise_reference and the CPU wrapper against ``_dw_lax``, float32:
    summation order only, so 1e-5; a CPU tensor launches nothing."""
    x, w, _, _ = _inputs(shape)
    want = np.asarray(jax_dw._dw_lax(x, w))
    launches, calls = D.LAUNCHES, D.CALLS
    for fn in (D.depthwise_reference, D.depthwise_conv3x3x3):
        got = fn(torch.from_numpy(x), torch.from_numpy(w))
        assert got.shape == want.shape and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (D.LAUNCHES, D.CALLS) == (launches, calls + 1)


def test_epilogue_matches_jax(jax_dw):
    """The epilogue variant (``_dw_pallas_v2`` with scale, bias and ReLU)
    against relu(_dw_lax(x, w) * scale + bias) in jnp, float32."""
    import jax.numpy as jnp

    x, w, scale, bias = _inputs(RAGGED, seed=1)
    want = np.asarray(jnp.maximum(jax_dw._dw_lax(x, w) * scale + bias, 0.0))
    got = D.depthwise_conv3x3x3(*map(torch.from_numpy, (x, w, scale, bias)),
                                relu=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got >= 0).all() and (got == 0).any()


def test_backward_matches_jax_bwd(jax_dw):
    """The autograd Function's backward (plain_vjp through the plain
    version) against the JAX custom VJP's ``_bwd``, at the tolerances of
    tests/test_pallas_depthwise.py."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 6, 6, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    g = rng.normal(size=(2, 4, 6, 6, 8)).astype(np.float32)
    dx_want, dw_want = jax_dw._bwd((x, w), g)
    dx, dw, dscale, dbias = D.plain_vjp(
        D.depthwise_reference,
        (torch.from_numpy(x), torch.from_numpy(w), None, None),
        (True, True, False, False), torch.from_numpy(g))
    assert dscale is None and dbias is None
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_want), rtol=1e-5,
                               atol=1e-4)


def test_dispatch_predicate():
    """Only stride 1 and C < 128, as ``depthwise_conv3x3x3`` of the JAX
    package dispatches on the TPU; CSN-152's layer1 (C = 64) qualifies,
    its strided first blocks and layers 2-4 (C >= 128) do not."""
    assert D.depthwise_supported((1, 32, 64, 64, 64), (1, 1, 1))
    assert D.depthwise_supported((1, 4, 5, 5, 8), [1, 1, 1])
    assert not D.depthwise_supported((1, 32, 64, 64, 64), (2, 2, 2))
    assert not D.depthwise_supported((1, 32, 64, 64, 64), (1, 2, 2))
    assert not D.depthwise_supported((1, 16, 32, 32, 128), (1, 1, 1))
    assert not D.depthwise_supported((1, 8, 16, 16, 256), (1, 1, 1))


@pytest.mark.parametrize("bad", ["rank", "dtype", "channels", "w_shape",
                                 "w_dtype", "scale_only", "scale_dtype",
                                 "strided"])
def test_check_inputs_rejects(bad):
    x, w, scale, bias = map(torch.from_numpy, _inputs((1, 2, 4, 4, 16)))
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x, w = x.half(), w.half()
    elif bad == "channels":
        x, w = x[..., :6].contiguous(), w[..., :6].contiguous()
    elif bad == "w_shape":
        w = w.reshape(27, 16)
    elif bad == "w_dtype":
        w = w.to(torch.bfloat16)
    elif bad == "scale_only":
        bias = None
    elif bad == "scale_dtype":
        scale = scale.double()
    elif bad == "strided":
        x = torch.zeros(1, 2, 4, 8, 16)[:, :, :, ::2]
    with pytest.raises(ValueError):
        D.check_inputs(x, w, scale, bias)
    D.check_inputs(*map(torch.from_numpy, _inputs((1, 2, 4, 4, 16))))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,epilogue", [
    ((1, 32, 64, 64, 64), torch.bfloat16, False),
    ((1, 32, 64, 64, 64), torch.bfloat16, True),
    (RAGGED, torch.bfloat16, True),
    (RAGGED, torch.float32, False),
    ((2, 5, 7, 9, 8), torch.float32, True),
    *((s, torch.bfloat16, True) for s in KERNEL_RAGGED),
    *((s, torch.float32, False) for s in KERNEL_RAGGED),
])
def test_kernel_matches_plain_on_cuda(cuda, shape, dtype, epilogue):
    """The CUDA kernel against depthwise_reference on the card. bf16: each
    rounds once, the sums in another order: 4 bf16 ulps (2^-6) of the
    output's maximum. float32 (TF32 off): summation order only."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, scale, bias = (torch.from_numpy(a).to(cuda)
                         for a in _inputs(shape))
    x, w = x.to(dtype), w.to(dtype)
    if not epilogue:
        scale = bias = None
    launches = D.LAUNCHES
    got = D.depthwise_conv3x3x3(x, w, scale, bias, relu=epilogue)
    torch.cuda.synchronize()
    assert D.LAUNCHES == launches + 1
    want = D.depthwise_reference(x, w, scale, bias, relu=epilogue)
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    span = want.float().abs().max().item()
    assert err <= (2.0 ** -6 if dtype == torch.bfloat16 else 1e-5) * span


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,epilogue", [
    ((1, 32, 64, 64, 64), torch.bfloat16, True),
    ((2, 5, 16, 16, 64), torch.bfloat16, False),
    ((1, 9, 18, 17, 72), torch.float32, True),
])
def test_kernel_repeat_is_bit_equal_on_cuda(cuda, shape, dtype, epilogue):
    """Each output's 27 taps are summed in one fixed order: a repeat launch
    gives the same bits."""
    x, w, scale, bias = (torch.from_numpy(a).to(cuda)
                         for a in _inputs(shape, seed=3))
    x, w = x.to(dtype), w.to(dtype)
    if not epilogue:
        scale = bias = None
    got = D.depthwise_conv3x3x3(x, w, scale, bias, relu=epilogue)
    again = D.depthwise_conv3x3x3(x, w, scale, bias, relu=epilogue)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_kernel_gradient_on_cuda(cuda):
    """The wrapper on tensors that need gradients runs the kernel forward
    and the plain version's backward; float32, TF32 off: the gradients
    equal the plain version's up to summation order."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, scale, bias = (torch.from_numpy(a).to(cuda)
                         for a in _inputs(RAGGED))
    grads = []
    for fn in (D.depthwise_conv3x3x3, D.depthwise_reference):
        xg, wg, sg = (t.clone().requires_grad_() for t in (x, w, scale))
        fn(xg, wg, sg, bias, relu=True).square().sum().backward()
        grads.append((xg.grad, wg.grad, sg.grad))
    for got, want in zip(*grads):
        assert (got - want).norm() <= 1e-5 * want.norm()
