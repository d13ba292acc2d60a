"""TRAIN.ACCUM_STEPS in the PyTorch port's train step against the JAX
package's ``engine.make_train_step`` with the same accumulation (the case
of tests/test_engine.py's manual microbatching), with
TRAIN.REMAT_BACKBONE on a full-backprop model (tests/test_engine.py's
test_remat_backbone_same_grads) and MoE encoder FFNs (4 experts, top 2)
with their ``loss_moe_aux``: one step at batch 4 in two microbatches of 2,
from the same variables (BN statistics randomised), dropout off, float
clips: the total, every loss term, the gradient norm, the updated
parameters (the stem's and the expert stacks among them) and the BN
statistics, which follow the microbatches in order. One JAX step carries
the three options: the JAX compile is this file's cost. Then, on the port
alone, the step against two half-batch passes run by hand, its refusals
and its NaN guard. CSN-TINY with the avg temporal pooling (the decode
pooling's 2048-wide decoder is held to JAX by test_torch_train_step.py),
float32 on the CPU."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_csn import randomize_bn
from test_torch_train_step import _cfg, _port_model

from tubelet_transformer_tpu.models.tuber import build_model as jbuild_model
from tubelet_transformer_tpu.train import engine as jengine
from tubelet_transformer_tpu_torch.convert import (
    tuber_torch_state_from_params)
from tubelet_transformer_tpu_torch.models.layers import Dropout
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.train import engine
from tubelet_transformer_tpu_torch.train.optimizer import param_label


def step_cfg():
    """test_torch_train_step.py's config with the avg temporal pooling."""
    cfg = _cfg()
    cfg.model.temporal_ds_strategy = "avg"
    return cfg


def port_state(cfg, params, stats):
    """The JAX variables in the port's (the reference's) key scheme."""
    return tuber_torch_state_from_params(
        params, stats, block_nums=(1, 1, 1, 1),
        enc_layers=cfg.model.enc_layers, dec_layers=cfg.model.dec_layers,
        temporal_ds_strategy=cfg.model.temporal_ds_strategy,
        single_frame=True, ddp_prefix=False)


def batch4(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b, m = 4, cfg.data.max_boxes
    c, img = cfg.data.num_classes, cfg.data.img_size
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (b, m, 2)),
                            rng.uniform(0.1, 0.3, (b, m, 2))], -1)
    return {"clips": rng.normal(size=(b, cfg.data.temp_len, img, img, 3)
                                ).astype(np.float32),
            "pad_mask": np.zeros((b, img, img), bool),
            "boxes": boxes.astype(np.float32),
            "labels": (rng.uniform(size=(b, m, c)) < 0.3).astype(np.float32),
            "valid": np.arange(m)[None] < np.array([[3], [2], [1], [4]]),
            "sizes": np.full((b, 2), img, np.float32)}


def jax_step(cfg, batch):
    """The JAX package's train step from randomised BN statistics, every
    flax Dropout off: (params, stats, metrics, (params, stats) after)."""
    call = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        jmodel = jbuild_model(cfg)
        state, tx, _ = jengine.create_train_state(
            cfg, jmodel, jax.random.PRNGKey(0), batch, steps_per_epoch=10)
        params = jax.device_get(state.params)
        stats = jax.device_get(state.batch_stats)
        randomize_bn(params, stats, np.random.default_rng(1))
        state = state.replace(params=params, batch_stats=stats)
        new_state, metrics = jengine.make_train_step(cfg, jmodel, tx)(
            state, batch, jax.random.PRNGKey(1),
            jnp.float32(cfg.loss.dice_cof))
        after = jax.device_get((new_state.params, new_state.batch_stats))
    finally:
        fnn.Dropout.__call__ = call
    return params, stats, jax.device_get(metrics), after


def assert_step_matches(cfg, model, before, got, want, want_sd):
    """The port's step (metrics ``got``, ``model`` after it, its state
    ``before``) against the JAX step's metrics ``want`` and state after
    ``want_sd`` (the reference key scheme), at the tolerances of
    test_torch_train_step.py's test_train_step_matches_jax."""
    assert set(want) == set(got)
    for k in want:
        # float32 through the whole model and the matched losses; the
        # gradient norm also carries the JAX CPU backward's drift
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-2 if k == "grad_norm" else 1e-4,
                                   atol=1e-5, err_msg=k)
    after = model.state_dict()
    lr = {"main": cfg.train.lr, "backbone": cfg.train.lr_backbone}
    for name, p in model.named_parameters():
        label = param_label(name, cfg)
        old = before[name].numpy()
        moved = after[name].numpy() - old
        want_moved = want_sd[name] - old
        if label == "frozen":
            assert not moved.any() and not want_moved.any(), name
            continue
        # the first Adam step moves a weight by lr * g / (|g| + 1e-8): the
        # two agree wherever the gradient is not near zero, and differ by
        # <= 2 lr where its sign is float32 noise
        diff = np.abs(moved - want_moved)
        assert diff.max() <= 2.2 * lr[label], name
        off = diff > 1e-3 * lr[label] + 2 * np.spacing(np.abs(old))
        assert np.abs(p.grad.numpy()[off]).max(initial=0) < 1e-5, name
    for name in want_sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(after[name].numpy(), want_sd[name],
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def options_cfg():
    """step_cfg with ACCUM_STEPS 2, REMAT_BACKBONE on a full-backprop
    model (pretrained off: stop_grad_stage -1) and MoE encoder FFNs."""
    cfg = step_cfg()
    cfg.train.accum_steps = 2
    cfg.train.remat_backbone = True
    cfg.model.pretrained = False
    cfg.model.moe_experts, cfg.model.moe_top_k = 4, 2
    return cfg


def accum_cfg():
    """step_cfg with ACCUM_STEPS 2 alone (TUNE_POINT 4), for the port's
    own checks."""
    cfg = step_cfg()
    cfg.train.accum_steps = 2
    return cfg


def port_only_model(cfg):
    """The port's train build from its own seed, dropout off."""
    model = build_model(cfg, train=True, seed=0)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


@pytest.fixture(scope="module")
def jax_options_step():
    cfg = options_cfg()
    batch = batch4(cfg)
    return (cfg, batch, *jax_step(cfg, batch))


def test_accum_step_matches_jax(jax_options_step):
    cfg, batch, params, stats, want, (jparams, jstats) = jax_options_step
    assert "loss_moe_aux" in want
    model = _port_model(cfg, params, stats)
    body = model.backbone.body
    assert body.remat and body.stop_grad_stage == -1
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = engine.create_train_state(cfg, model, steps_per_epoch=10)
    got = engine.make_train_step(cfg, state)(
        engine.device_batch(batch, torch.device("cpu")), cfg.loss.dice_cof)
    assert state.step == state.updates == 1 and got["finite"] == 1.0
    assert_step_matches(cfg, model, before, got, want,
                        port_state(cfg, jparams, jstats))
    # full backprop: the stem trains; the expert stacks move
    assert body.conv1.weight.grad is not None
    moved = model.transformer.encoder.layers[0].moe_ffn.expert_w1 - before[
        "transformer.encoder.layers.0.moe_ffn.expert_w1"]
    assert moved.abs().max() > 0


def test_accum_is_two_half_batch_passes():
    """On the port, one accumulated step equals two half-batch forwards
    and backwards run by hand, BN statistics threaded through: the total
    (the mean of the halves) and the running statistics bit for bit, the
    gradients (the mean of the halves', clipped) to the rounding of the
    clip's scale."""
    cfg = accum_cfg()
    batch = batch4(cfg)
    cpu = torch.device("cpu")
    model = port_only_model(cfg)
    state = engine.create_train_state(cfg, model, steps_per_epoch=10)
    got = engine.make_train_step(cfg, state)(
        engine.device_batch(batch, cpu), cfg.loss.dice_cof)

    ref = port_only_model(cfg)
    engine.create_train_state(cfg, ref, steps_per_epoch=10)   # freezes
    totals = []
    for rows in (slice(0, 2), slice(2, 4)):
        half = engine.device_batch({k: v[rows] for k, v in batch.items()},
                                   cpu)
        out = ref(half["clips"], half["pad_mask"])
        total = engine.weighted_total(
            cfg, engine.compute_losses(cfg, out, engine._targets_from_batch(
                cfg, half)), cfg.loss.dice_cof)
        total.backward()
        totals.append(total.detach())
    assert torch.equal(got["total_loss"], (totals[0] + totals[1]) * 0.5)
    trained = dict(model.named_parameters())
    for name, p in ref.named_parameters():
        if p.grad is not None:
            # the port's step clips the averaged gradients in place
            g = p.grad * 0.5 * min(1.0, cfg.loss.clips_max_norm / float(
                got["grad_norm"]))
            torch.testing.assert_close(trained[name].grad, g, rtol=1e-6,
                                       atol=0, msg=name)
    for (name, a), b in zip(model.named_buffers(), ref.buffers()):
        if name.endswith(("running_mean", "running_var")):
            assert torch.equal(a, b), name


def test_accum_refuses_indivisible_batch():
    cfg = accum_cfg()
    step = engine.make_train_step(cfg, engine.create_train_state(
        cfg, port_only_model(cfg), steps_per_epoch=10))
    three = {k: v[:3] for k, v in batch4(cfg).items()}
    with pytest.raises(ValueError, match="ACCUM_STEPS"):
        step(engine.device_batch(three, torch.device("cpu")),
             cfg.loss.dice_cof)


def test_accum_nan_guard_restores_the_first_microbatch_state():
    """A non-finite second microbatch: the step is skipped whole, and the
    BN statistics are those before the first microbatch, though it was
    finite and updated them."""
    cfg = accum_cfg()
    batch = batch4(cfg)
    model = port_only_model(cfg)
    state = engine.create_train_state(cfg, model, steps_per_epoch=10)
    kept = {k: v.clone() for k, v in model.state_dict().items()}
    bad = dict(batch, clips=batch["clips"].copy())
    bad["clips"][3] = np.nan
    metrics = engine.make_train_step(cfg, state)(
        engine.device_batch(bad, torch.device("cpu")), cfg.loss.dice_cof)
    assert metrics["finite"] == 0.0 and (state.step, state.updates) == (1, 0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, kept[k]), k
