"""The slice as a whole: TubeR with ``MODEL.PALLAS_KERNELS`` and
``MODEL.FUSED_BLOCKS`` on, the port against the JAX package, float32 in
eval on the CPU; and that ``MODEL.FUSED_STAGES`` builds
(tests/test_torch_stage_path.py holds that path against the JAX package).

CSN-50 (its layer2 has three identity blocks; CSN-TINY's has none) at
256 px and T=4, so that layer2's frames hold 32x32 = 1024 pixels and the
port's model takes its fused dispatch, which on the CPU calls the plain
versions: 3 depthwise calls (layer1) and 3 fused-bottleneck calls (layer2
blocks 1-3). Off the TPU the JAX model takes its composite at both places.
"""

import jax
import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_csn import randomize_bn
from test_torch_tuber import HEADS, small_cfg

from tubelet_transformer_tpu.models.tuber import build_model as jbuild_model
from tubelet_transformer_tpu_torch.convert import load_jax_variables
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.ops.cuda import (bottleneck,
                                                    depthwise, stage)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _kernel_cfg(cfg):
    cfg.data.img_size = 256
    cfg.data.temp_len = cfg.model.temp_len = 4
    cfg.model.backbone_name = "CSN-50"
    cfg.model.enc_layers = cfg.model.dec_layers = 1
    cfg.model.pallas_kernels = True
    cfg.model.fused_blocks = True
    return cfg


def test_kernel_path_matches_jax():
    cfg = _kernel_cfg(small_cfg("avg"))
    rng = np.random.default_rng(0)
    clip = rng.normal(size=(1, 4, 256, 256, 3)).astype(np.float32)
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
    calls = depthwise.CALLS, bottleneck.CALLS
    with torch.inference_mode():
        got = model(torch.from_numpy(clip), torch.from_numpy(pad))
    assert (depthwise.CALLS - calls[0], bottleneck.CALLS - calls[1]) == (3, 3)
    for k in HEADS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        # float32: summation order only (the tolerance of the
        # test_torch_tuber.py forward test)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_build_model_accepts_fused_stages():
    """MODEL.FUSED_STAGES builds and dispatches: CSN-50 at 128 px and T=4
    chains layer2's identity tail (T 2, 16x16), one chain call on the CPU
    (its plain version), and the outputs equal those of the same weights
    block by block."""
    cfg = small_cfg()
    cfg.data.img_size = 128
    cfg.data.temp_len = cfg.model.temp_len = 4
    cfg.model.backbone_name = "CSN-50"
    cfg.model.fused_stages = True
    model = build_model(cfg)
    assert model.backbone.body.fused_stages
    clip = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 4, 128, 128, 3)).astype(np.float32))
    calls = stage.CALLS
    with torch.inference_mode():
        got = model(clip)
        model.backbone.body.fused_stages = False
        want = model(clip)
    assert stage.CALLS == calls + 1
    for k in HEADS:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)
