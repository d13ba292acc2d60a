"""The slice as a whole: TubeR with ``MODEL.PALLAS_KERNELS``,
``MODEL.FUSED_BLOCKS`` and ``MODEL.FUSED_STAGES`` on, the port against the
JAX package, float32 in eval on the CPU.

CSN-50 at 256 px and T=8, so that two stages chain: layer2 (T 4, 32x32,
C_mid 128; its 3-block identity tail) and layer3 (T 2, 16x16, C_mid 256; 5
blocks); layer4 (T 1) does not. On the CPU the port's dispatch calls the
plain versions: 3 depthwise calls (layer1), 2 chains, and no fused
bottleneck (the chains take layer2's identity blocks). Off the TPU the JAX
model takes its composite at every place.
"""

import jax
import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_csn import randomize_bn
from test_torch_kernel_path import _kernel_cfg
from test_torch_tuber import HEADS, small_cfg

from tubelet_transformer_tpu.models.tuber import build_model as jbuild_model
from tubelet_transformer_tpu_torch.convert import load_jax_variables
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.ops.cuda import (bottleneck, depthwise,
                                                    stage)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_stage_path_matches_jax():
    cfg = _kernel_cfg(small_cfg("avg"))
    cfg.data.temp_len = cfg.model.temp_len = 8
    cfg.model.fused_stages = True
    rng = np.random.default_rng(0)
    clip = rng.normal(size=(1, 8, 256, 256, 3)).astype(np.float32)
    pad = np.zeros((1, 256, 256), bool)
    pad[:, 200:, :] = True

    jmodel = jbuild_model(cfg)
    variables = jax.device_get(jax.jit(
        lambda k, x: jmodel.init(k, x, train=False))(
            jax.random.PRNGKey(0), clip))
    randomize_bn(variables["params"], variables["batch_stats"], rng)
    want = jax.jit(lambda v, x, p: jmodel.apply(v, x, p, train=False))(
        variables, clip, pad)

    model = load_jax_variables(build_model(cfg), variables["params"],
                               variables["batch_stats"])
    calls = depthwise.CALLS, bottleneck.CALLS, stage.CALLS
    with torch.inference_mode():
        got = model(torch.from_numpy(clip), torch.from_numpy(pad))
    assert (depthwise.CALLS - calls[0], bottleneck.CALLS - calls[1],
            stage.CALLS - calls[2]) == (3, 0, 2)
    for k in HEADS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        # float32: summation order only (the tolerance of the
        # test_torch_tuber.py forward test)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_chain_params_made_once_per_change():
    """The stacked weights of a stage's chains are made once and reused
    until a parameter or BN statistic of its tail changes (here an in-place
    update of one running mean, as a train-mode forward or a load makes)."""
    cfg = _kernel_cfg(small_cfg("avg"))
    cfg.model.fused_stages = True
    body = build_model(cfg).backbone.body
    with torch.no_grad():
        first = body.chain_params(1, 2)
        assert [len(c) for c in first] == [9, 9]
        assert [c[0].shape[0] for c in first] == [2, 1]
        assert body.chain_params(1, 2) is first
        body.layer2[3].bn3.running_mean.add_(1.0)
        again = body.chain_params(1, 2)
    assert again is not first
    a3, b3 = body.layer2[3].bn3.folded()
    assert torch.equal(again[1][6][0], b3)
    assert not torch.equal(first[1][6][0], b3)
    # with gradients enabled the stacks are made anew and differentiable
    assert body.chain_params(1, 2)[0][0].requires_grad
