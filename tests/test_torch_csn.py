"""The PyTorch port's irCSN backbone (eval mode) against the JAX CSN, with
random non-trivial BatchNorm parameters and running statistics so that the
folding (epsilon 1e-3) is exercised. CSN-TINY, float32 on the CPU."""

import jax
import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401

from tubelet_transformer_tpu.models.csn import build_csn as jbuild_csn
from tubelet_transformer_tpu.train import torch_convert as tc
from tubelet_transformer_tpu_torch.models import csn as tcsn

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def randomize_bn(params, stats, rng):
    """Random scale/bias and running mean/var for every BN of a flax tree
    (any dict holding both 'scale' and 'bias' with a stats twin)."""
    for k, p in params.items():
        if isinstance(p, dict) and "scale" in p and k in stats:
            n = p["scale"].shape[0]
            p["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            p["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
            stats[k] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
        elif isinstance(p, dict) and isinstance(stats.get(k), dict):
            randomize_bn(p, stats[k], rng)


def csn_state(params, stats, block_nums):
    """Flax CSN variables -> the port's CSN state dict (torch layouts)."""
    sd = {"conv1.weight": tc._inv_conv3d(params["conv1"]["kernel"])}
    tc._put_bn(sd, "bn1", params["bn1"], stats["bn1"])
    for s, blocks in enumerate(block_nums):
        for b in range(blocks):
            p, st = params[f"layer{s + 1}_{b}"], stats[f"layer{s + 1}_{b}"]
            rp = f"layer{s + 1}.{b}"
            for conv in ("conv1", "conv3", "conv4"):
                sd[f"{rp}.{conv}.weight"] = tc._inv_conv3d(
                    p[conv]["kernel"])
                bn = "bn" + conv[-1]
                tc._put_bn(sd, f"{rp}.{bn}", p[bn], st[bn])
            if b == 0:
                sd[f"{rp}.down_sample.0.weight"] = tc._inv_conv3d(
                    p["downsample_conv"]["kernel"])
                tc._put_bn(sd, f"{rp}.down_sample.1", p["downsample_bn"],
                           st["downsample_bn"])
    return sd


@pytest.mark.parametrize("last_stride", [False, True])
def test_csn_tiny_matches_jax(last_stride):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 8, 64, 64, 3)).astype(np.float32)
    jcsn = jbuild_csn("CSN-TINY", last_stride)
    variables = jax.device_get(jax.jit(jcsn.init)(jax.random.PRNGKey(0), x))
    params, stats = variables["params"], variables["batch_stats"]
    randomize_bn(params, stats, rng)
    want = np.asarray(jax.jit(jcsn.apply)(
        {"params": params, "batch_stats": stats}, x))

    model = tcsn.build_csn("CSN-TINY", last_stride)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v))
         for k, v in csn_state(params, stats, model.block_nums).items()},
        strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (
        1, 1, 2 if last_stride else 4, 2 if last_stride else 4, 2048)
    # float32 through 13 convs: summation order only
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_folded_bn_matches_running_stats_formula():
    bn = tcsn.FoldableBN(6)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(6, generator=g))
        bn.running_var.copy_(torch.rand(6, generator=g) + 0.5)
    x = torch.randn(2, 3, 4, 6, generator=g)
    want = (x - bn.running_mean) / torch.sqrt(bn.running_var + 1e-3) \
        * bn.weight + bn.bias
    torch.testing.assert_close(bn.eval()(x), want, rtol=1e-5, atol=1e-5)


def test_unknown_backbone_raises():
    with pytest.raises(ValueError):
        tcsn.build_csn("CSN-7", False)
