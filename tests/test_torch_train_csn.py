"""The PyTorch port's irCSN in train mode against the JAX CSN: the output,
the BN running mean AND variance after one train forward (the JAX package
updates them with the biased batch variance, flax momentum 0.9), the
gradients of the trained stages and the freeze boundaries of
``stop_grad_stage``. CSN-TINY, float32 on the CPU, with random BN
parameters and running statistics; the port's frozen stem takes the
two-phase path (statistics, then the pooled stem with the batch affine)
through the plain versions, the JAX CSN its plain train-mode BN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_csn import csn_state, randomize_bn

from tubelet_transformer_tpu.models.csn import build_csn as jbuild_csn
from tubelet_transformer_tpu_torch.models import csn as tcsn
from tubelet_transformer_tpu_torch.ops.cuda import stem


def _pair(last_stride, stop_grad_stage, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32)
    jcsn = jbuild_csn("CSN-TINY", last_stride,
                      stop_grad_stage=stop_grad_stage)
    variables = jax.device_get(jax.jit(jcsn.init)(jax.random.PRNGKey(0), x))
    params, stats = variables["params"], variables["batch_stats"]
    randomize_bn(params, stats, rng)
    model = tcsn.build_csn("CSN-TINY", last_stride,
                           stop_grad_stage=stop_grad_stage)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v))
         for k, v in csn_state(params, stats, model.block_nums).items()},
        strict=True)
    return jcsn, params, stats, model.train(), x


@pytest.mark.parametrize("last_stride,stop_grad_stage",
                         [(False, 2), (True, -1)])
def test_train_forward_and_running_stats_match_jax(last_stride,
                                                   stop_grad_stage):
    jcsn, params, stats, model, x = _pair(last_stride, stop_grad_stage)
    want, new_vars = jax.jit(lambda v, x: jcsn.apply(
        v, x, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, x)
    launches = stem.STATS_LAUNCHES, stem.LAUNCHES
    got = model(torch.from_numpy(x))
    assert (stem.STATS_LAUNCHES, stem.LAUNCHES) == launches   # CPU: plain
    # float32 through 13 convs and batch statistics: summation order only
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4 * np.abs(want).max())
    want_sd = csn_state(params, jax.device_get(new_vars["batch_stats"]),
                        model.block_nums)
    got_sd = model.state_dict()
    names = [k for k in want_sd if k.endswith(("running_mean",
                                               "running_var"))]
    assert len(names) == 2 * 17      # stem + 4 blocks x (3 + downsample)
    for k in names:
        # float32 batch reductions in another order
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_gradients_and_freeze_boundaries_match_jax():
    """stop_grad_stage=2 (TUNE_POINT 4): the stem and layer1-2 get no
    gradient (JAX: zero), layer3-4 the JAX gradient of the same loss, a
    fixed random projection of the output (sum(y^2) would put the output
    gradient in the span that train-mode BN's backward projects out).
    Float64 on both sides: in float32 the JAX package's own CPU backward
    into layer3 drifts ~7e-3 from its float64 one, while the port's float32
    stays within 1e-5 of float64. JAX's BN statistics stay float32, so
    1e-4."""
    jcsn, params, stats, model, x = _pair(False, 2, seed=1)
    proj = np.random.default_rng(2).normal(size=(2, 1, 4, 4, 2048))
    with jax.enable_x64(True):
        jcsn = jbuild_csn("CSN-TINY", False, stop_grad_stage=2,
                          dtype=jnp.float64)
        p64, s64 = (jax.tree.map(lambda a: np.asarray(a, np.float64), t)
                    for t in (params, stats))

        def loss(p):
            y, _ = jcsn.apply({"params": p, "batch_stats": s64},
                              x.astype(np.float64), train=True,
                              mutable=["batch_stats"])
            return jnp.sum(y * proj)

        jgrads = csn_state(jax.device_get(jax.jit(jax.grad(loss))(p64)),
                           s64, model.block_nums)
    model = model.double()
    (model(torch.from_numpy(x).double()) * torch.from_numpy(proj)
     ).sum().backward()
    for name, p in model.named_parameters():
        frozen = name.startswith(("conv1.", "bn1.", "layer1.", "layer2."))
        assert (p.grad is None) == frozen, name
        if frozen:
            assert not jgrads[name].any(), name
        else:
            got, want = p.grad.numpy(), jgrads[name]
            assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(
                want), name


def test_frozen_stem_takes_two_phase_path(monkeypatch):
    """With a frozen stem in training the stem runs batch statistics, the
    batch affine (which updates bn1's running statistics) and the pooled
    stem, each once; in eval mode on the CPU, the plain stem only."""
    model = tcsn.build_csn("CSN-TINY", False, stop_grad_stage=2)
    calls = []
    for name in ("stem_batch_stats", "stem_forward"):
        fn = getattr(tcsn, name)
        monkeypatch.setattr(tcsn, name,
                            lambda *a, _f=fn, _n=name: calls.append(_n)
                            or _f(*a))
    x = torch.randn(1, 4, 32, 32, 3, generator=torch.Generator()
                    .manual_seed(0))
    before = model.bn1.running_var.clone()
    model.train()(x)
    assert calls == ["stem_batch_stats", "stem_forward"]
    assert not torch.equal(model.bn1.running_var, before)
    calls.clear()
    with torch.no_grad():
        model.eval()(x)
    assert calls == []
