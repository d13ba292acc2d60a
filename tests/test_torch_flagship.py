"""The flagship-size gate: the PyTorch TubeR against the JAX TubeR at the
flagship configuration's full size (configuration/tuber_csn152_ava22.yaml:
CSN-152, 256 px, T = 32, 6+6 layers, d 256, 15 queries, 80 classes, the
decode pooling), on one clip, in float32 on the CPU. The JAX model's
initial variables (BN statistics randomised) cross over through
``convert.load_jax_variables`` with ``strict=True``. The JAX side runs
with MODEL.STEM_KERNEL off, so that no Pallas kernel runs interpreted at
this size; on the CPU the port's stem is its plain version either way.

Slow tier: two float32 forwards of CSN-152 on the CPU, at the full size
and at half the frame size and clip length (full depth and width, an
eighth of the activations). Run with ``-s`` to see each head's largest
error against its limit."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_csn import randomize_bn

from tubelet_transformer_tpu.config import load_config
from tubelet_transformer_tpu.models.tuber import build_model as jbuild_model
from tubelet_transformer_tpu_torch.convert import load_jax_variables
from tubelet_transformer_tpu_torch.models.tuber import build_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FLAGSHIP = (Path(__file__).resolve().parents[1] / "configuration"
            / "tuber_csn152_ava22.yaml")


def flagship_cfg():
    cfg = load_config(str(FLAGSHIP))
    cfg.model.compute_dtype = "float32"
    cfg.model.stem_kernel = False
    cfg.model.pretrained = cfg.model.load_detr = False   # random weights
    return cfg


def assert_tuber_matches_jax(cfg, seed=0):
    """One clip of the configured size, with a padded bottom band, through
    both models. float32 through 50 bottlenecks and 12 transformer layers:
    every head within 1e-3 of its largest magnitude (at least 1)."""
    rng = np.random.default_rng(seed)
    img, t = cfg.data.img_size, cfg.data.temp_len
    clip = rng.normal(size=(1, t, img, img, 3)).astype(np.float32)
    pad = np.zeros((1, img, img), bool)
    pad[:, img * 13 // 16:, :] = True
    jmodel = jbuild_model(cfg)
    variables = jax.device_get(jax.jit(
        lambda k, x: jmodel.init(k, x, train=False))(
            jax.random.PRNGKey(seed), clip))
    randomize_bn(variables["params"], variables["batch_stats"], rng)
    want = jax.device_get(jax.jit(
        lambda v, x, p: jmodel.apply(v, x, p, train=False))(
            {k: variables[k] for k in ("params", "batch_stats")}, clip, pad))
    model = load_jax_variables(build_model(cfg), variables["params"],
                               variables["batch_stats"])
    with torch.inference_mode():
        got = model(torch.from_numpy(clip), torch.from_numpy(pad))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape and np.isfinite(w).all(), k
        atol = 1e-3 * max(1.0, np.abs(w).max())
        err = np.abs(got[k].numpy() - w)
        print(f"{k}: largest error {err.max():.3g}, its share of the "
              f"limit at worst {(err / (atol + 1e-3 * np.abs(w))).max():.3g}")
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-3, atol=atol,
                                   err_msg=k)


@pytest.mark.slow
@pytest.mark.parametrize("img,t", [(256, 32), (128, 16)],
                         ids=["full", "half_input"])
def test_flagship_matches_jax(img, t):
    cfg = flagship_cfg()
    cfg.data.img_size, cfg.data.temp_len = img, t
    assert_tuber_matches_jax(cfg)
