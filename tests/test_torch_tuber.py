"""The whole PyTorch TubeR against the JAX TubeR: the JAX model's initial
variables (BatchNorm statistics randomised) cross over through
``convert.load_jax_variables`` with ``strict=True``, the same clip and pad
mask go through both. CSN-TINY, 64 px, T=8, d=64, 4 heads, 1+2 layers,
float32 on the CPU."""

import jax
import numpy as np
import pytest
import torch
from test_torch_csn import randomize_bn

from tubelet_transformer_tpu.config import Config
from tubelet_transformer_tpu.models.tuber import build_model as jbuild_model
from tubelet_transformer_tpu_torch.convert import load_jax_variables
from tubelet_transformer_tpu_torch.models.tuber import build_model

HEADS = ("pred_logits", "pred_boxes", "pred_logits_b")


def small_cfg(strategy="decode"):
    cfg = Config()
    cfg.data.dataset_name = "ava"
    cfg.data.num_classes = 5
    cfg.data.img_size = 64
    cfg.data.temp_len = 8
    cfg.model.backbone_name = "CSN-TINY"
    cfg.model.query_num = 5
    cfg.model.temp_len = 8
    cfg.model.enc_layers = 1
    cfg.model.dec_layers = 2
    cfg.model.d_model = 64
    cfg.model.nhead = 4
    cfg.model.dim_feedforward = 64
    cfg.model.compute_dtype = "float32"
    cfg.model.temporal_ds_strategy = strategy
    return cfg


@pytest.mark.parametrize("strategy", ["decode", "avg"])
def test_tuber_matches_jax(strategy):
    cfg = small_cfg(strategy)
    cfg.model.temp_len = cfg.data.temp_len = 16   # T' = 2 frames to pool
    rng = np.random.default_rng(0)
    clip = rng.normal(size=(1, 16, 64, 64, 3)).astype(np.float32)
    pad = np.zeros((1, 64, 64), bool)
    pad[:, 40:, :] = True
    pad[:, :, 56:] = True

    jmodel = jbuild_model(cfg)
    variables = jax.device_get(jax.jit(
        lambda k, x: jmodel.init(k, x, train=False))(
            jax.random.PRNGKey(0), clip))
    randomize_bn(variables["params"], variables["batch_stats"], rng)
    want = jax.jit(lambda v, x, p: jmodel.apply(v, x, p, train=False))(
        variables, clip, pad)

    model = load_jax_variables(build_model(cfg), variables["params"],
                               variables["batch_stats"])
    with torch.inference_mode():
        got = model(torch.from_numpy(clip), torch.from_numpy(pad))
    assert set(want) == set(got)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        # float32: summation order only, through ~20 layers
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("strategy", ["max", "middle"])
def test_temporal_pool(strategy):
    """The parameter-free strategies, against their definition
    (tuber.py:_temporal_pool of the JAX package)."""
    model = build_model(small_cfg(strategy))
    xs = torch.randn(2, 4, 3, 3, 8, generator=torch.Generator().manual_seed(0))
    want = xs.amax(1, keepdim=True) if strategy == "max" else xs[:, 2:3]
    torch.testing.assert_close(model._temporal_pool(xs), want)


def test_return_features_and_eval_only():
    """The eval build is in eval mode and returns the query features on
    request; the train build is in train mode, keeps float32 parameters and
    computes in the compute dtype (bf16 here), with finite outputs and
    gradients that stop at the frozen stages."""
    model = build_model(small_cfg("avg"), seed=3)
    assert not model.training
    clip = torch.zeros(1, 8, 64, 64, 3)
    with torch.inference_mode():
        out = model(clip, return_features=True)
    assert out["lfb_features"].shape == (1, 5, 64)
    assert out["pred_boxes"].dtype == torch.float32
    cfg = small_cfg("avg")
    cfg.model.compute_dtype = "bfloat16"
    cfg.model.pretrained = True                  # tune_point 4: layer1-2
    train = build_model(cfg, seed=3, train=True)
    assert train.training and train.dtype == torch.bfloat16
    assert train.query_embed.weight.dtype == torch.float32
    out = train(clip)
    assert all(torch.isfinite(v).all() for v in out.values())
    out["pred_logits"].sum().backward()
    body = train.backbone.body
    assert body.layer3[0].conv1.weight.grad is not None
    assert body.layer2[0].conv1.weight.grad is None


def test_build_model_is_seeded_and_casts():
    a, b = build_model(small_cfg(), seed=1), build_model(small_cfg(), seed=1)
    for (k, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), k
    cfg = small_cfg()
    cfg.model.compute_dtype = "bfloat16"
    m = build_model(cfg)
    assert m.dtype == torch.bfloat16
    assert m.backbone.body.bn1.running_var.dtype == torch.float32


@pytest.mark.parametrize("knob", ["pipe"])
def test_build_model_refuses_unported(knob):
    cfg = small_cfg()
    cfg.mesh.pipe = 2
    with pytest.raises(NotImplementedError):
        build_model(cfg)
