"""The PyTorch port's stage chain (tubelet_transformer_tpu_torch/ops/cuda/
stage.py) against the JAX package's (ops/pallas/stage.py): its composite
``chain_xla``, its Pallas kernel in interpret mode, as
tests/test_pallas_stage.py runs it on the CPU, its gradient and its dispatch
predicate.

JAX is imported inside fixtures, so that the CUDA tests also run where JAX
is not installed:
  python -m pytest tests/test_torch_stage.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
from torch_fixtures import cuda  # noqa: F401

from tubelet_transformer_tpu_torch.ops.cuda import stage as S


def _args(k=3, b=2, t=5, h=8, w=8, ci=32, cm=16, seed=0):
    """The arguments of tests/test_pallas_stage.py:_args, as numpy."""
    rng = np.random.default_rng(seed)

    def mk(*s, scale=1.0):
        return rng.normal(0, scale, s).astype(np.float32)

    x = mk(b, t, h, w, ci)
    return (x, mk(k, ci, cm, scale=.1), mk(k, 3, 3, 3, cm, scale=.2),
            mk(k, cm, ci, scale=.1),
            mk(k, cm, scale=.3) + 1, mk(k, cm, scale=.3),
            mk(k, cm, scale=.3) + 1, mk(k, cm, scale=.3),
            mk(k, ci, scale=.3) + 1, mk(k, ci, scale=.3))


def _stream_args(k, b, t, h, w, ci, cm, seed=0):
    """Stacked arguments at the kernel's widths whose residual stream stays
    O(1) over many blocks (the scales of chip_smoke.py's chain check):
    conv weights at 1/sqrt(fan-in), conv4's affine near 0.2."""
    rng = np.random.default_rng(seed)

    def mk(*s, scale=1.0, mean=0.0):
        return rng.normal(mean, scale, s).astype(np.float32)

    return (mk(b, t, h, w, ci), mk(k, ci, cm, scale=ci ** -.5),
            mk(k, 3, 3, 3, cm, scale=.2), mk(k, cm, ci, scale=cm ** -.5),
            mk(k, cm, scale=.1, mean=1.), mk(k, cm, scale=.3),
            mk(k, cm, scale=.1, mean=1.), mk(k, cm, scale=.3),
            mk(k, ci, scale=.05, mean=.2), mk(k, ci, scale=.1))


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 values, kept in float32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.fixture
def jax_stage():
    pytest.importorskip("jax")
    from tubelet_transformer_tpu.ops.pallas import stage as JS

    return JS


@pytest.fixture
def interpret(jax_stage):
    """The Pallas kernel in interpret mode, as the JAX package's test runs
    it on the CPU."""
    jax_stage._INTERPRET["on"] = True
    yield jax_stage
    jax_stage._INTERPRET["on"] = False


@pytest.mark.parametrize("k", [1, 3])
def test_plain_matches_jax_xla(jax_stage, k):
    """chain_reference and the CPU wrapper against ``chain_xla``, float32:
    summation order only, so 1e-5 of max|ref|; the CPU call counts, and
    launches nothing."""
    args = _args(k=k)
    want = np.asarray(jax_stage.chain_xla(args[0], args[1:]))
    scale = np.abs(want).max()
    launches, calls = S.LAUNCHES, S.CALLS
    tensors = list(map(torch.from_numpy, args))
    for got in (S.chain_reference(tensors[0], tensors[1:]),
                S.bottleneck_chain(*tensors)):
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    assert (S.LAUNCHES, S.CALLS) == (launches, calls + 1)


@pytest.mark.parametrize("k,b,t", [(1, 2, 5), (2, 2, 5), (3, 2, 5),
                                   (2, 3, 4)])
def test_cpu_chain_matches_pallas_kernel(interpret, k, b, t):
    """bottleneck_chain on the CPU (the plain version) on bf16-rounded
    operands against the Pallas kernel in interpret mode, which takes its
    products in bf16 and keeps mid and every block's output but the last in
    bf16: 5e-3 of max|ref|, the limit of tests/test_pallas_stage.py, in every
    batch row (at b=3 the kernel's rings reset between rows)."""
    args = list(_args(k=k, b=b, t=t))
    for i in range(4):
        args[i] = _bf16(args[i])
    want = np.asarray(interpret.bottleneck_chain(*args), np.float32)
    got = S.bottleneck_chain(*map(torch.from_numpy, args)).numpy()
    scale = np.abs(want).max()
    for bi in range(b):
        assert np.abs(got[bi] - want[bi]).max() < 5e-3 * scale, bi


def test_gradient_matches_jax_float64(jax_stage):
    """The gradient of a loss through the port's bottleneck_chain (on the
    CPU, autograd through the plain version) and through the autograd
    Function's backward (plain_vjp of the plain version) against jax.grad of
    ``chain_xla``, the JAX custom VJP's backward, both in float64:
    summation order only."""
    import jax

    args = [a.astype(np.float64) for a in _args(k=2, b=1, t=3, h=4, w=4)]
    g = np.random.default_rng(5).normal(size=args[0].shape)
    with jax.enable_x64(True):
        _, vjp = jax.vjp(lambda x, *s: jax_stage.chain_xla(x, s), *args)
        want = [np.asarray(v) for v in vjp(g)]
    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    (S.bottleneck_chain(*tensors) * torch.from_numpy(g)).sum().backward()
    via_fn = S.plain_vjp(S._chain_plain, [torch.from_numpy(a) for a in args],
                         (True,) * 10, torch.from_numpy(g))
    for t, f, w in zip(tensors, via_fn, want):
        scale = np.abs(w).max()
        assert np.abs(t.grad.numpy() - w).max() <= 1e-10 * scale
        assert np.abs(f.numpy() - w).max() <= 1e-10 * scale


def _flagship_tails(img: int, t: int = 32):
    """(name, x shape after block 0, C_mid) of each stage of CSN-152
    (LAST_STRIDE false) for a (1, t, img, img, 3) clip."""
    out, h = [], img // 4
    for s, planes in enumerate((64, 128, 256, 512)):
        if s:
            t, h = -(-t // 2), (h if s == 3 else -(-h // 2))
        out.append((f"layer{s + 1}", (1, t, h, h, planes * 4), planes))
    return out


@pytest.mark.parametrize("shape,cm,want", [
    *((s, c, n != "layer1") for n, s, c in _flagship_tails(256)),
    ((1, 1, 32, 32, 512), 128, False),          # T = 1
    ((1, 16, 32, 32, 256), 64, False),          # C_mid 64
    ((1, 8, 32, 48, 1024), 256, False),         # a 3 MiB frame
    ((1, 8, 12, 12, 1024), 256, False),         # 144-pixel frames
    ((1, 16, 28, 28, 512), 128, True),          # layer2 at 224 px
])
def test_chain_supported_matches_jax(jax_stage, monkeypatch, shape, cm, want):
    """The port's predicate equals the JAX one with its backend reading
    "tpu": the flagship's tails of layers 2-4 chain at 256 px, layer1 and
    the shapes outside the domain do not."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert S.chain_supported(shape, cm) == want
    assert jax_stage.chain_supported(shape, cm) == want


def test_max_chain_takes_whole_tails():
    """A chain takes a stage's whole identity tail at every flagship shape:
    3 chains per forward of CSN-152 (7, 35 and 2 blocks)."""
    tails = dict(zip(("layer2", "layer3", "layer4"), (7, 35, 2)))
    for name, (_, _, h, w, ci), cm in _flagship_tails(256)[1:]:
        assert S.max_chain(h * w, ci, cm) >= tails[name]


@pytest.mark.parametrize("bad", ["rank", "dtype", "cm", "k_mismatch",
                                 "w_dtype", "affine_dtype", "strided",
                                 "no_k"])
def test_check_inputs_rejects(bad):
    args = [torch.from_numpy(a).clone()
            for a in _stream_args(2, 1, 2, 4, 4, 512, 128)]
    for i in (1, 2, 3):
        args[i] = args[i].to(torch.bfloat16)
    good = list(args)
    if bad == "rank":
        args[0] = args[0][0]
    elif bad == "dtype":
        args[0] = args[0].half()
    elif bad == "cm":
        args[1] = args[1][:, :, :96].contiguous()
    elif bad == "k_mismatch":
        args[4] = args[4][:1].contiguous()
    elif bad == "w_dtype":
        args[3] = args[3].float()
    elif bad == "affine_dtype":
        args[4] = args[4].to(torch.bfloat16)
    elif bad == "strided":
        args[2] = torch.zeros(2, 3, 3, 3, 256, dtype=torch.bfloat16)[..., ::2]
    else:
        args[5] = args[5][0]
    with pytest.raises(ValueError):
        S.check_inputs(*args)
    S.check_inputs(*good)


def _stream_on(device, k, shape, cm, dtype):
    args = [torch.from_numpy(a).to(device)
            for a in _stream_args(k, *shape, cm=cm)]
    for i in range(4):
        args[i] = args[i].to(torch.bfloat16)
    args[0] = args[0].to(dtype)
    return args


def test_rounded_chain_equals_one_block_chains():
    """``chain_reference_rounded`` over K blocks, in float64, equals K calls
    of it with one block each and bf16 rounding between them: the identity
    behind the kernel's bit-for-bit check against K launches of itself with
    K = 1 (the kernel rounds where this plain version does)."""
    args = [torch.from_numpy(a).double()
            for a in _stream_args(4, 1, 3, 4, 4, 128, 64)]
    for i in range(4):
        args[i] = args[i].to(torch.bfloat16).double()
    whole = S.chain_reference_rounded(args[0], args[1:], torch.float64)
    y = args[0]
    for i in range(4):
        y = S.chain_reference_rounded(y, [a[i:i + 1] for a in args[1:]],
                                      torch.float64)
        if i < 3:
            y = y.to(torch.bfloat16).double()
    assert torch.equal(whole, y)


def _one_block_launches(args, k):
    """The chain of ``args`` as k launches of the kernel with K = 1, each
    output but the last rounded to bf16 (in the input's dtype)."""
    y = args[0]
    for i in range(k):
        y = S.bottleneck_chain(y, *(a[i:i + 1] for a in args[1:]))
        if i + 1 < k:
            y = y.to(torch.bfloat16).to(args[0].dtype)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("cm,shape,dtype", [
    (128, (2, 5, 16, 16, 512), torch.bfloat16),
    (256, (1, 4, 16, 16, 1024), torch.bfloat16),
    (512, (1, 3, 8, 8, 2048), torch.bfloat16),
    (128, (1, 4, 13, 21, 512), torch.float32),
])
def test_kernel_matches_blocks_and_plain_on_cuda(cuda, cm, shape, dtype):
    """The chain kernel with K = 3: bit-equal to three launches of itself
    with K = 1 and the same bf16 roundings between them (the same tile
    bodies and summation order: a difference is a race or a missing
    barrier), and against the plain version that rounds where the kernel
    does, in float32 with TF32 off, 5e-3 of max|ref| in every clip."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = _stream_on(cuda, 3, shape, cm, dtype)
    launches = S.LAUNCHES
    got = S.bottleneck_chain(*args)
    torch.cuda.synchronize()
    assert S.LAUNCHES == launches + 1 and got.dtype == dtype
    assert torch.equal(got, _one_block_launches(args, 3))
    want = S.chain_reference_rounded(args[0], args[1:])
    scale = want.abs().max()
    for bi in range(shape[0]):
        assert (got[bi].float() - want[bi]).abs().max() < 5e-3 * scale, bi


@pytest.mark.cuda
@pytest.mark.parametrize("cm,shape", [(128, (1, 4, 32, 32, 512)),
                                      (512, (1, 4, 16, 16, 2048))])
def test_kernel_repeat_launch_bit_equal_on_cuda(cuda, cm, shape):
    """Two launches of the chain on the same input give the same bits: no
    atomics, every tile summed in a fixed order whatever the grid."""
    args = _stream_on(cuda, 2, shape, cm, torch.bfloat16)
    first = S.bottleneck_chain(*args)
    again = S.bottleneck_chain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(first.float()).all()
    assert torch.equal(first, again)


def test_phase_tiles_cover_the_card_at_flagship_tails():
    """Every phase of the kernel has at least 128 work items for one block
    at each of the flagship's chained tails (layers 2-4 at 256 px)."""
    for name, shape, cm in _flagship_tails(256)[1:]:
        tiles = S.phase_tiles(shape, cm)
        assert min(tiles.values()) >= 128, (name, tiles)


@pytest.mark.cuda
def test_kernel_gradient_on_cuda(cuda):
    """bottleneck_chain on tensors that need gradients runs the kernel
    forward and the plain version's backward: for a loss linear in the
    output, the gradients equal the plain version's on the same operands up
    to summation order, float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = _stream_on(cuda, 2, (1, 3, 8, 8, 512), 128, torch.float32)
    g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        1)).to(cuda)
    grads = []
    for fn in (S.bottleneck_chain, S._chain_plain):
        x, w1 = (a.clone().requires_grad_() for a in args[:2])
        rest = args[2:] if fn is S.bottleneck_chain else [
            a.float() for a in args[2:]]
        w1b = w1 if fn is S.bottleneck_chain else w1.float()
        (fn(x, w1b, *rest) * g).sum().backward()
        grads.append((x.grad, w1.grad))
    for got, want in zip(*grads):
        assert (got.float() - want.float()).norm() <= 1e-4 * want.norm()
