"""Train-mode BatchNorm of the PyTorch port (tubelet_transformer_tpu_torch/
models/csn.py) against the JAX package's: ``FoldableBN`` against
``_FoldableBN`` (models/csn.py), whose variance is ``E[x^2] - E[x]^2`` in
float32 with no clamp, and the projection shortcut's ``ShortcutBN`` against
flax's ``nn.BatchNorm`` (the JAX package's ``downsample_bn``), whose fast
variance is the same formula clamped at 0 and whose output is
``(x - mean) * (scale * rsqrt(var + eps)) + bias`` in float32.

The two variance formulas part from the two-pass one where |mean| >> std:
the inputs sit at 4096 with offsets of a few units, where one float32 ulp
of E[x^2] (2^24) is 2 and the variance is O(1). Each channel reduces two
elements, so both frameworks add in the same order.
"""

import numpy as np
import pytest
import torch

from tubelet_transformer_tpu_torch.models import csn as C

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def jax_bn():
    jax = pytest.importorskip("jax")
    import flax.linen as nn
    from tubelet_transformer_tpu.models import csn as JC

    def run(kind, x, scale, bias, train=True, momentum=JC.BN_MOMENTUM,
            stats=None):
        """(output, updated mean, updated var) of the JAX module, as jax
        arrays (traceable in x)."""
        c = x.shape[-1]
        mean, var = stats if stats is not None else (
            np.zeros(c, np.float32), np.ones(c, np.float32))
        variables = {"params": {"scale": scale, "bias": bias},
                     "batch_stats": {"mean": mean, "var": var}}
        if kind == "foldable":
            mod = JC._FoldableBN(c, momentum=momentum)
            y, upd = mod.apply(variables, x, train=train,
                               mutable=["batch_stats"])
        else:
            mod = nn.BatchNorm(momentum=momentum, epsilon=JC.BN_EPS,
                               dtype=jax.numpy.float32,
                               param_dtype=jax.numpy.float32)
            y, upd = mod.apply(variables, x, use_running_average=not train,
                               mutable=["batch_stats"])
        return y, upd["batch_stats"]["mean"], upd["batch_stats"]["var"]

    return run


def _fast_var32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """E[x^2] - E[x]^2 over the pair (a, b), in float32 as both packages
    take it."""
    f = np.float32
    mean = (a + b) / f(2)
    return (a * a + b * b) / f(2) - mean * mean


def _large_mean_inputs(c=64, seed=0):
    """x (1, 2, 1, 1, c) float32 at 4096 + offsets in steps of 2^-8: the
    channels' stds run from ~0 to ~8, and channel 0 is a pair whose float32
    fast variance is negative (searched for with _fast_var32). Also the
    BN's weight and bias."""
    rng = np.random.default_rng(seed)
    step = np.float32(2.0 ** -8)
    spread = np.geomspace(0.05, 8.0, c)
    d = np.round(rng.normal(size=(2, c)) * spread / step) * step
    x = (np.float32(4096.0) + d).astype(np.float32)
    base = np.float32(4096.0) + np.arange(400, dtype=np.float32) * step
    neg = np.nonzero(_fast_var32(base, base + step) < 0)[0]
    assert neg.size, "no pair with a negative fast variance"
    x[0, 0], x[1, 0] = base[neg[0]], base[neg[0]] + step
    weight = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    return x.reshape(1, 2, 1, 1, c), weight, bias


def _port_bn(cls, weight, bias, train=True, momentum=C.BN_MOMENTUM):
    bn = cls(weight.shape[0])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.momentum = momentum
    return bn.train(train)


def _batch_var(cls, x, weight, bias):
    """The batch variance the port's module computes: with torch momentum
    1 the running variance becomes it exactly."""
    bn = _port_bn(cls, weight, bias, momentum=1.0)
    with torch.no_grad():
        bn(torch.from_numpy(x))
    return bn.running_var.numpy()


def _assert_output_close(got, want, x, mul):
    """Equal to float32 rounding of x * mul, the largest term: the two
    packages associate the affine's products differently."""
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    atol = 8 * EPS32 * np.abs(x * mul).max(axis=(0, 1, 2, 3))
    assert (np.abs(got - want) <= atol)[ok].all()


@pytest.mark.parametrize("kind,cls", [("foldable", C.FoldableBN),
                                      ("shortcut", C.ShortcutBN)])
def test_train_bn_matches_jax_at_large_mean(jax_bn, kind, cls):
    """Train mode, |mean| >> std: the batch variance equals the JAX
    module's bit for bit, where torch.var_mean differs by more than 10% of
    the variance; ``_FoldableBN`` keeps channel 0's negative variance (its
    output there is NaN in both), flax and ShortcutBN clamp it to 0. The
    output and the running statistics equal JAX's to float32 rounding."""
    x, weight, bias = _large_mean_inputs()
    want_var = np.asarray(jax_bn(kind, x, weight, bias, momentum=0.0)[2])
    got_var = _batch_var(cls, x, weight, bias)
    np.testing.assert_array_equal(got_var, want_var)
    if kind == "foldable":
        assert want_var[0] < 0
    else:
        assert want_var[0] == 0 and _fast_var32(*x[0, :, 0, 0, :1]) < 0
    two_pass = torch.var_mean(torch.from_numpy(x), dim=(0, 1, 2, 3),
                              correction=0)[0].numpy()
    apart = np.abs(two_pass - want_var) > 0.1 * two_pass
    assert apart.sum() >= x.shape[-1] // 4

    want_y, want_mean, want_run = map(np.asarray,
                                      jax_bn(kind, x, weight, bias))
    bn = _port_bn(cls, weight, bias)
    with torch.no_grad():
        got_y = bn(torch.from_numpy(x)).numpy()
    mul = weight / np.sqrt(np.maximum(want_var, 0) + C.BN_EPS)
    _assert_output_close(got_y, want_y, x, mul)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_mean,
                               rtol=4 * EPS32)
    np.testing.assert_allclose(bn.running_var.numpy(), want_run,
                               rtol=4 * EPS32, atol=4 * EPS32)


def _largest_ratio_bf16(c=64, seed=5):
    """x (1, 4, 1, 1, c) bf16 values (as float32) at |mean| / std up to
    ~509, the most that bf16 holds: channel j's four values lie on the bf16
    grid just below 2^e (e 8 or 12, grid step u = 2^(e-8)), at b + k u
    with integer k in [0, kmax], b = 2^e - (kmax + 1) u; kmax = 1 gives
    two neighbouring values, std u / 2. Every square, sum and difference
    of the JAX formula is exact in float32 here."""
    rng = np.random.default_rng(seed)
    x = np.empty((4, c), np.float32)
    for j in range(c):
        e = (8, 12)[j % 2]
        u = 2.0 ** (e - 8)
        kmax = (1, 2, 4, 16, 64)[(j // 2) % 5]
        k = rng.integers(0, kmax + 1, 4)
        k[:2] = 0, kmax
        x[:, j] = 2.0 ** e - (kmax + 1) * u + k * u
    assert np.array_equal(torch.from_numpy(x).bfloat16().float().numpy(), x)
    return x.reshape(1, 4, 1, 1, c)


@pytest.mark.parametrize("kind,cls", [("foldable", C.FoldableBN),
                                      ("shortcut", C.ShortcutBN)])
def test_train_bn_matches_jax_at_large_mean_bf16(jax_bn, kind, cls):
    """The bf16 case of the test above: the same bf16 x into the JAX module
    (float32 statistics of the bf16 values) and into the port, whose
    ``batch_stats`` reads a bf16 x by a float32 sum and a float32 vector
    norm. The mean is equal bit for bit. E[x^2] is the norm squared: its
    square root and its square, the division by n and the subtraction each
    round within 2^-24 of E[x^2], so the variance is within 3 * eps32 *
    E[x^2] of JAX's (exact here). At |mean| / std ~ 509 that bound is
    ~12% of the variance; the JAX formula's own float32 error over a real
    batch's sum (10^5 and more elements a channel) is larger. A bf16
    square (x * x before the sum) misses by ~10^4 eps32 * E[x^2]."""
    import jax.numpy as jnp

    x = _largest_ratio_bf16()
    c = x.shape[-1]
    rng = np.random.default_rng(6)
    weight = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    _, want_mean, want_var = map(np.asarray, jax_bn(
        kind, jnp.asarray(x, jnp.bfloat16), weight, bias, momentum=0.0))
    xt = torch.from_numpy(x).bfloat16()
    mean, var = C.batch_stats(xt)
    bn = _port_bn(cls, weight, bias, momentum=1.0)
    with torch.no_grad():
        bn(xt)
    np.testing.assert_array_equal(mean.numpy(), want_mean)
    np.testing.assert_array_equal(bn.running_mean.numpy(), want_mean)
    np.testing.assert_array_equal(bn.running_var.numpy(),
                                  var.clamp_min(0).numpy() if kind ==
                                  "shortcut" else var.numpy())
    msq = want_var.astype(np.float64) + want_mean.astype(np.float64) ** 2
    ratio = np.abs(want_mean) / np.sqrt(want_var)
    assert ratio.max() > 500
    assert (np.abs(var.numpy() - want_var) <= 3 * EPS32 * msq).all()


def test_shortcut_bn_eval_matches_flax(jax_bn):
    """Eval mode: flax's normalisation from the running statistics,
    (x - mean) * (scale * rsqrt(var + eps)) + bias in float32, at the same
    large-mean inputs and running statistics near them."""
    x, weight, bias = _large_mean_inputs(seed=1)
    rng = np.random.default_rng(2)
    c = x.shape[-1]
    stats = ((4096 + rng.normal(size=c)).astype(np.float32),
             rng.uniform(0.5, 4.0, c).astype(np.float32))
    want = np.asarray(jax_bn("shortcut", x, weight, bias, train=False,
                             stats=stats)[0])
    bn = _port_bn(C.ShortcutBN, weight, bias, train=False)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(stats[0]))
        bn.running_var.copy_(torch.from_numpy(stats[1]))
        got = bn(torch.from_numpy(x)).numpy()
    mul = weight / np.sqrt(stats[1] + C.BN_EPS)
    _assert_output_close(got, want, x - stats[0], mul)


@pytest.mark.parametrize("kind,cls", [("foldable", C.FoldableBN),
                                      ("shortcut", C.ShortcutBN)])
def test_train_bn_gradient_matches_jax(jax_bn, kind, cls):
    """The gradient of a loss linear in the train-mode output, through both
    batch statistics, against jax.grad of the same loss, float32, at
    |mean| ~ std: 1e-4 relative to the largest gradient."""
    import jax

    rng = np.random.default_rng(3)
    x = (1.0 + 2.0 * rng.normal(size=(2, 3, 4, 4, 8))).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda v: (jax_bn(kind, v, weight, bias)[0] * g).sum())(x))
    bn = _port_bn(cls, weight, bias)
    xt = torch.from_numpy(x).requires_grad_()
    (bn(xt) * torch.from_numpy(g)).sum().backward()
    got = xt.grad.numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_precision_batch_stats(dtype):
    """A half-precision x: float32 statistics from reductions that read x
    in its own type, equal to the float32 formula on x's values up to
    summation order and the vector norm's square root (1e-6 of E[x^2]);
    bf16 squares would be off by ~2^-9. The gradient reaches x."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((3.0 + rng.normal(size=(2, 4, 4, 4, 16)))
                         .astype(np.float32)).to(dtype).requires_grad_()
    mean, var = C.batch_stats(x)
    want_mean, want_var = C.batch_stats(x.detach().float())
    msq = (want_var + want_mean.square()).detach()
    assert mean.dtype == var.dtype == torch.float32
    assert ((mean - want_mean).abs() <= 1e-6 * msq.sqrt()).all()
    assert ((var - want_var).abs() <= 1e-6 * msq).all()
    var.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_csn_takes_shortcut_bn_for_projections():
    """Every projection shortcut of the backbone normalises with
    ShortcutBN (the JAX package's ``downsample_bn``, flax's BatchNorm) and
    every other BN with FoldableBN (``_FoldableBN``), under the reference's
    state-dict keys."""
    model = C.build_csn("CSN-TINY", last_stride=False)
    shortcut = {n for n, m in model.named_modules()
                if isinstance(m, C.ShortcutBN)}
    assert shortcut == {f"layer{s}.0.down_sample.1" for s in range(1, 5)}
    keys = model.state_dict().keys()
    for name in shortcut:
        assert {f"{name}.{k}" for k in ("weight", "bias", "running_mean",
                                        "running_var")} <= keys
