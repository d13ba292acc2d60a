"""The PyTorch TubeR with MoE encoder FFNs (MODEL.MOE_EXPERTS) or pre-norm
layers (MODEL.NORMALIZE_BEFORE), and with both under each temporal pooling
strategy and in JHMDB mode, against the JAX TubeR: the whole forward,
the JAX variables (BN statistics randomised) carried over by
``convert.load_jax_variables`` with ``strict=True``; and the MoE model in
the serving pool against a single detector. Float32 on the CPU."""

import jax
import numpy as np
import pytest
import torch
from test_torch_csn import randomize_bn
from test_torch_moe import _option_cfg
from test_torch_pool import GEOMETRY, _drive
from test_torch_serving import _assert_same, _frames
from test_torch_serving import small_cfg as serving_cfg
from test_torch_tuber import small_cfg
from torch_fixtures import one_torch_thread  # noqa: F401

from tubelet_transformer_tpu.models.tuber import build_model as jbuild_model
from tubelet_transformer_tpu_torch.convert import load_jax_variables
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.serving import (StreamingDetector,
                                                   StreamingDetectorPool)


def _assert_matches_jax(cfg, clip, pad, rng):
    """The port's eval forward of ``cfg`` against the JAX TubeR's, the JAX
    variables (BN statistics randomised from ``rng``) carried over; with
    MoE the mean of the layers' load-balance losses against the JAX
    model's sown ones."""
    jmodel = jbuild_model(cfg)
    variables = jax.device_get(jax.jit(
        lambda k, x: jmodel.init(k, x, train=False))(
            jax.random.PRNGKey(0), clip))
    randomize_bn(variables["params"], variables["batch_stats"], rng)
    variables = {k: variables[k] for k in ("params", "batch_stats")}
    want, state = jax.jit(lambda v, x, p: jmodel.apply(
        v, x, p, train=False, mutable=["moe"]))(variables, clip, pad)

    model = load_jax_variables(build_model(cfg), variables["params"],
                               variables["batch_stats"])
    with torch.inference_mode():
        got = model(torch.from_numpy(clip), torch.from_numpy(pad))
    moe = cfg.model.moe_experts > 0
    assert set(got) == set(want) | ({"moe_aux"} if moe else set())
    assert hasattr(model.transformer.encoder.layers[0], "linear1") != moe
    assert (model.transformer.encoder.norm is not None) == (
        cfg.model.normalize_before)
    for k in want:
        # float32: summation order only, through ~20 layers
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    if moe:
        leaves = jax.tree.leaves(state["moe"])
        assert len(leaves) == cfg.model.enc_layers
        np.testing.assert_allclose(float(got["moe_aux"]),
                                   float(sum(leaves) / len(leaves)),
                                   rtol=1e-5)


def _padded_clip(shape, pad_from: int):
    """A random clip of ``shape``, its pad mask (rows from ``pad_from``
    padded) and the generator that drew the clip."""
    rng = np.random.default_rng(0)
    clip = rng.normal(size=shape).astype(np.float32)
    pad = np.zeros((shape[0], *shape[2:4]), bool)
    pad[:, pad_from:, :] = True
    return clip, pad, rng


@pytest.mark.parametrize("option", ["moe", "pre_norm"])
def test_tuber_option_matches_jax(option):
    """The whole TubeR forward, eval mode, with padded tokens (which take
    no expert capacity)."""
    cfg = _option_cfg(option, small_cfg("avg"))
    cfg.model.enc_layers = 2
    _assert_matches_jax(cfg, *_padded_clip((1, 8, 64, 64, 3), 40))


@pytest.mark.parametrize("mode", ["avg", "max", "decode", "middle", "jhmdb"])
def test_moe_with_pre_norm_matches_jax(mode, one_torch_thread):
    """MoE encoder FFNs (4 experts, top 2) and pre-norm together, under
    each temporal pooling strategy (16 frames: two to pool) and in JHMDB
    mode (Q x T tubelet queries, the visibility head), with padded
    tokens."""
    if mode == "jhmdb":
        from test_torch_jhmdb import T
        from test_torch_jhmdb import small_cfg as jhmdb_cfg

        cfg, shape = jhmdb_cfg(), (2, T, 32, 64, 3)
    else:
        cfg, shape = small_cfg(mode), (1, 16, 64, 64, 3)
        cfg.model.temp_len = cfg.data.temp_len = 16
    cfg = _option_cfg("moe", _option_cfg("pre_norm", cfg))
    cfg.model.enc_layers = 2
    _assert_matches_jax(cfg, *_padded_clip(shape, 3 * shape[2] // 4))


def test_moe_pool_bucket_matches_single_detector():
    """Expert capacity is per batch row: an MoE stream served in a padded
    bucket of the pool equals the same stream served alone (the tolerances
    of test_torch_serving.py)."""
    cfg = _option_cfg("moe", serving_cfg())
    model = build_model(cfg, seed=3)
    kw = dict(fps=8.0, detect_every=8, actor_threshold=-1.0, device="cpu")
    single = StreamingDetector(cfg, model, **kw)
    pool = StreamingDetectorPool(cfg, model, max_batch=4, **kw)
    frames = {sid: _frames(32, h, w, seed=i)
              for i, (sid, (h, w)) in enumerate(GEOMETRY.items())}
    got = [r["c"] for r in _drive(pool, frames, 32) if "c" in r]
    # c is served after its 20th frame: the window of its frames 4-19
    want = [r for f in frames["c"][4:20] if (r := single.push_frame(f))]
    assert len(got) == len(want) == 1
    assert got[0].frame_index == want[0].frame_index + 4
    want[0].frame_index, want[0].time_s = got[0].frame_index, got[0].time_s
    _assert_same(got[0], want[0])
