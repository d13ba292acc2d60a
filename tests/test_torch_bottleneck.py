"""The PyTorch port's fused ir-bottleneck (tubelet_transformer_tpu_torch/
ops/cuda/bottleneck.py) against the JAX package's (ops/pallas/
bottleneck.py): its composite ``bottleneck_xla`` and its Pallas kernel in
interpret mode, as tests/test_pallas_bottleneck.py runs it on the CPU.

JAX is imported inside fixtures, so that the CUDA tests also run where JAX
is not installed:
  python -m pytest tests/test_torch_bottleneck.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
from torch_fixtures import cuda  # noqa: F401

from tubelet_transformer_tpu_torch.ops.cuda import bottleneck as B


def _args(b=2, t=5, h=8, w=8, ci=512, cm=128, seed=0):
    """The arguments of tests/test_pallas_bottleneck.py:_args, as numpy."""
    rng = np.random.default_rng(seed)

    def mk(*s, scale=1.0):
        return rng.normal(0, scale, s).astype(np.float32)

    x = mk(b, t, h, w, ci)
    return (x, mk(ci, cm, scale=.05), mk(3, 3, 3, cm, scale=.2),
            mk(cm, ci, scale=.05), mk(cm, scale=.3) + 1, mk(cm, scale=.3),
            mk(cm, scale=.3) + 1, mk(cm, scale=.3),
            mk(ci, scale=.3) + 1, mk(ci, scale=.3))


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 values, kept in float32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.fixture
def jax_bn():
    pytest.importorskip("jax")
    from tubelet_transformer_tpu.ops.pallas import bottleneck as JB

    return JB


@pytest.fixture
def interpret(jax_bn):
    """The Pallas kernel in interpret mode, as the JAX package's test runs
    it on the CPU."""
    jax_bn._INTERPRET["on"] = True
    yield jax_bn
    jax_bn._INTERPRET["on"] = False


@pytest.mark.parametrize("shape", [(2, 5, 8, 8), (1, 3, 5, 7)])
def test_plain_matches_jax_xla(jax_bn, shape):
    """bottleneck_reference and the CPU wrapper against ``bottleneck_xla``,
    float32: summation order only, so 1e-5 of max|ref|."""
    args = _args(*shape)
    want = np.asarray(jax_bn.bottleneck_xla(*args))
    scale = np.abs(want).max()
    launches, calls = B.LAUNCHES, B.CALLS
    for fn in (B.bottleneck_reference, B.bottleneck_fused):
        got = fn(*map(torch.from_numpy, args))
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    assert (B.LAUNCHES, B.CALLS) == (launches, calls + 1)


@pytest.mark.parametrize("b,t", [(2, 5), (3, 4)])
def test_plain_matches_pallas_kernel(interpret, b, t):
    """The plain version on bf16-rounded operands (x, w1, wd, w4) against
    the Pallas kernel in interpret mode, which takes its products in bf16
    and rounds its mid activations to bf16: 5e-3 of max|ref|, the limit of
    tests/test_pallas_bottleneck.py, in every batch row (at b=3 the kernel's
    mid ring resets between rows)."""
    args = list(_args(b, t))
    for i in range(4):
        args[i] = _bf16(args[i])
    want = np.asarray(interpret.bottleneck_fused(*args), np.float32)
    got = B.bottleneck_reference(*map(torch.from_numpy, args)).numpy()
    scale = np.abs(want).max()
    for bi in range(b):
        assert np.abs(got[bi] - want[bi]).max() < 5e-3 * scale, bi


def test_backward_is_plain_vjp(jax_bn):
    """The autograd Function's backward (plain_vjp through the plain
    version) against the VJP of ``bottleneck_xla``, the JAX custom VJP's
    backward, float32."""
    import jax

    args = _args(b=1, t=3, h=4, w=4)
    g = np.random.default_rng(5).normal(size=args[0].shape).astype(
        np.float32)
    _, vjp = jax.vjp(jax_bn.bottleneck_xla, *args)
    want = vjp(g)
    got = B.plain_vjp(B.bottleneck_reference, list(map(torch.from_numpy,
                                                       args)),
                      (True,) * 10, torch.from_numpy(g))
    for gw, ww in zip(got, want):
        ww = np.asarray(ww)
        assert np.abs(gw.numpy() - ww).max() <= 1e-4 * np.abs(ww).max()


def _flagship_blocks(img: int, bs: int):
    """(name, x_shape, cm, stride, tstride, has_downsample) of every block
    of CSN-152 (LAST_STRIDE false) for a (bs, 32, img, img, 3) clip."""
    t, h = 32, img // 4
    out, in_planes = [], 64
    for s, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                             (3, 8, 36, 3))):
        stride, tstride = (1, 1) if s == 0 else ((1 if s == 3 else 2), 2)
        for b in range(blocks):
            st, tst = (stride, tstride) if b == 0 else (1, 1)
            c_in = in_planes if b == 0 else planes * 4
            out.append((f"layer{s + 1}.{b}", (bs, t, h, h, c_in), planes, st,
                        tst, b == 0))
            if b == 0:
                t, h = -(-t // tst), -(-h // st)
        in_planes = planes * 4
    return out


@pytest.mark.parametrize("img", [256, 224])
@pytest.mark.parametrize("bs", [1, 8])
def test_dispatch_predicate_matches_jax(jax_bn, monkeypatch, img, bs):
    """On the flagship's blocks, the port's predicate equals the JAX one
    with its backend reading "tpu": layer2 blocks 1-7 at 256 px, none at
    224 px."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    fused = []
    for name, shape, cm, st, tst, down in _flagship_blocks(img, bs):
        ours = B.bottleneck_supported(shape, cm, st, tst, down)
        assert ours == jax_bn.bottleneck_supported(shape, cm, st, tst, down)
        if ours:
            fused.append(name)
    assert fused == ([f"layer2.{b}" for b in range(1, 8)] if img == 256
                     else [])


@pytest.mark.parametrize("bad", ["rank", "dtype", "cm", "w_dtype",
                                 "affine_dtype", "strided", "misaligned"])
def test_check_inputs_rejects(bad):
    args = [torch.from_numpy(a).clone() for a in _args(1, 2, 4, 4)]
    for i in (1, 2, 3):
        args[i] = args[i].to(torch.bfloat16)
    good = list(args)
    if bad == "rank":
        args[0] = args[0][0]
    elif bad == "dtype":
        args[0] = args[0].half()
    elif bad == "cm":
        args[1] = args[1][:, :96].contiguous()
    elif bad == "w_dtype":
        args[3] = args[3].float()
    elif bad == "affine_dtype":
        args[4] = args[4].to(torch.bfloat16)
    elif bad == "misaligned":
        # the kernel copies every operand in 16-byte pieces
        args[4] = torch.zeros(args[4].numel() + 1)[1:]
    else:
        args[0] = torch.zeros(1, 2, 4, 8, 512)[:, :, :, ::2]
    with pytest.raises(ValueError):
        B.check_inputs(*args)
    B.check_inputs(*good)


# shapes bottleneck_supported admits that the stage chain's predicate does
# not: one frame, and frames past its 2 MiB cap (448 px: 56x56x512)
_SUPPORTED_ONLY = [(1, 1, 32, 32), (2, 1, 32, 32), (1, 4, 56, 56)]


@pytest.mark.parametrize("shape", _SUPPORTED_ONLY)
def test_check_inputs_takes_every_supported_shape(shape):
    """check_inputs (and the stage chain's, through which the kernel
    launches with K = 1) accepts the shapes bottleneck_supported admits
    beyond chain_supported."""
    from tubelet_transformer_tpu_torch.ops.cuda import stage as S

    args = [torch.from_numpy(a) for a in _args(*shape)]
    for i in (1, 2, 3):
        args[i] = args[i].to(torch.bfloat16)
    assert B.bottleneck_supported(args[0].shape, 128, 1, 1, False)
    assert not S.chain_supported(args[0].shape, 128)
    B.check_inputs(*args)
    S.check_inputs(args[0], *(a.unsqueeze(0) for a in args[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((1, 16, 32, 32), torch.bfloat16),
    ((2, 5, 32, 32), torch.bfloat16),
    ((2, 3, 13, 21), torch.bfloat16),
    ((1, 4, 13, 21), torch.float32),
    *((s, torch.bfloat16) for s in _SUPPORTED_ONLY),
])
def test_kernel_matches_plain_on_cuda(cuda, shape, dtype):
    """The CUDA kernel against the plain version in float32 on the same
    bf16 operands (x rounded to bf16 too). The kernel rounds mid and mdw to
    bf16, as the Pallas kernel does: 5e-3 of max|ref|, the JAX test's limit,
    in every batch row (the per-clip reset at t = 0 and t = T-1), at T = 1
    and at 56x56 frames too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = [torch.from_numpy(a).to(cuda) for a in _args(*shape)]
    for i in range(4):
        args[i] = args[i].to(torch.bfloat16)
    launches = B.LAUNCHES
    got = B.bottleneck_fused(args[0].to(dtype), *args[1:])
    torch.cuda.synchronize()
    assert B.LAUNCHES == launches + 1 and got.dtype == dtype
    want = B.bottleneck_reference(*(a.float() for a in args))
    scale = want.abs().max()
    for bi in range(shape[0]):
        assert (got[bi].float() - want[bi]).abs().max() < 5e-3 * scale, bi


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((1, 16, 32, 32), torch.bfloat16),
    ((2, 5, 32, 32), torch.bfloat16),
    ((1, 1, 32, 32), torch.bfloat16),
    ((1, 4, 13, 21), torch.float32),
])
def test_kernel_equals_one_block_chain_on_cuda(cuda, shape, dtype):
    """bottleneck_fused is the stage chain's kernel with K = 1: bit-equal to
    bottleneck_chain on the stacked weights, and counted apart from the
    chain's launches."""
    from tubelet_transformer_tpu_torch.ops.cuda import stage as S

    args = [torch.from_numpy(a).to(cuda) for a in _args(*shape)]
    for i in range(4):
        args[i] = args[i].to(torch.bfloat16)
    args[0] = args[0].to(dtype)
    launches, chains = B.LAUNCHES, S.LAUNCHES
    got = B.bottleneck_fused(*args)
    assert (B.LAUNCHES, S.LAUNCHES) == (launches + 1, chains)
    stacked = [a.unsqueeze(0) for a in args[1:]]
    chain = S.bottleneck_chain(args[0], *stacked)
    torch.cuda.synchronize()
    assert S.LAUNCHES == chains + 1 and torch.equal(got, chain)


@pytest.mark.cuda
def test_kernel_gradient_on_cuda(cuda):
    """bottleneck_fused on tensors that need gradients runs the kernels
    forward and the plain version's backward: for a loss linear in the
    output (so the forwards' bf16 differences do not reach the cotangent),
    the gradients equal the plain version's on the same bf16 operands up to
    summation order, in float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = [torch.from_numpy(a).to(cuda) for a in _args(1, 3, 8, 8)]
    g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        1)).to(cuda)
    grads = []
    for fn in (B.bottleneck_fused, B.bottleneck_reference):
        x, w1 = (a.clone().requires_grad_() for a in args[:2])
        w1b = w1.to(torch.bfloat16)
        rest = [a.to(torch.bfloat16) for a in args[2:4]] + args[4:]
        if fn is B.bottleneck_reference:
            w1b, rest = w1b.float(), [a.float() for a in rest]
        (fn(x, w1b, *rest) * g).sum().backward()
        grads.append((x.grad, w1.grad))
    for got, want in zip(*grads):
        assert (got - want).norm() <= 1e-4 * want.norm()
