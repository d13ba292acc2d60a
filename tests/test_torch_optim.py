"""The PyTorch port's optimizer and schedules (train/optimizer.py,
train/schedule.py) against the JAX package's optax chain: parameter
labels, two AdamW steps with the main/backbone groups, the frozen mask and
the global-norm clip, and the schedules at their milestone edges."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tubelet_transformer_tpu.config import Config
from tubelet_transformer_tpu.train import optimizer as jopt
from tubelet_transformer_tpu.train import schedule as jsched
from tubelet_transformer_tpu_torch.train import optimizer as topt
from tubelet_transformer_tpu_torch.train import schedule as tsched

# port name -> JAX path of the same parameter, and its label for TUNE_POINT 4
NAMES = {
    "backbone.body.conv1.weight": ("backbone/conv1/kernel", "frozen"),
    "backbone.body.layer2.0.bn1.bias": ("backbone/layer2_0/bn1/bias",
                                        "frozen"),
    "backbone.body.layer3.0.conv1.weight": ("backbone/layer3_0/conv1/kernel",
                                            "backbone"),
    "backbone.body.layer4.1.bn3.weight": ("backbone/layer4_1/bn3/scale",
                                          "backbone"),
    "backbone.query_pool.weight": ("pool_query", "main"),
    "class_fc.weight": ("class_fc/kernel", "main"),
    "transformer.decoder.norm.bias": ("transformer/decoder_norm/bias",
                                      "main"),
}


def _cfg(**train):
    cfg = Config()
    cfg.model.pretrained = True
    cfg.model.tune_point = 4
    cfg.train.lr, cfg.train.lr_backbone = 1e-3, 1e-4
    cfg.train.w_decay = 0.05
    cfg.loss.clips_max_norm = 0.1
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def test_labels_match_jax():
    for lr_backbone, tune_point in ((1e-5, 4), (1e-5, 1), (0.0, 4)):
        cfg = _cfg(lr_backbone=lr_backbone)
        cfg.model.tune_point = tune_point
        jl = jopt.param_labels(_nest({j: 0 for j, _ in NAMES.values()}), cfg)
        for name, (jpath, _) in NAMES.items():
            node = jl
            for k in jpath.split("/"):
                node = node[k]
            assert topt.param_label(name, cfg) == node, (name, cfg.train)
    for name, (_, label) in NAMES.items():
        assert topt.param_label(name, _cfg()) == label
    assert topt.stop_grad_stage(_cfg()) == jopt.stop_grad_stage(_cfg()) == 2


class _Named(nn.Module):
    """Parameters under the port's names (dots kept as nested modules)."""

    def __init__(self, values):
        super().__init__()
        self.names = list(values)
        for i, v in enumerate(values.values()):
            self.register_parameter(f"p{i}", nn.Parameter(torch.tensor(v)))

    def named_parameters(self, *args, **kwargs):
        return zip(self.names, (getattr(self, f"p{i}")
                                for i in range(len(self.names))))


def test_two_adamw_steps_match_optax():
    """Groups at LR and LR_BACKBONE, decoupled weight decay on every
    parameter, frozen parameters untouched, the clip (gradients far above
    0.1) before Adam, and the step schedule's milestone between the two
    steps (steps_per_epoch 1, milestone 1). float32: 1e-6 relative."""
    cfg = _cfg(lr_milestone=[1], step=0.5)
    rng = np.random.default_rng(0)
    values = {n: rng.normal(size=(3, 4)).astype(np.float32) for n in NAMES}
    grads = [{n: rng.normal(size=(3, 4)).astype(np.float32) * 10
              for n in NAMES} for _ in range(2)]

    jparams = _nest({j: jnp.asarray(values[n]) for n, (j, _) in
                     NAMES.items()})
    tx, _ = jopt.build_optimizer(cfg, jparams, steps_per_epoch=1)
    opt_state = tx.init(jparams)
    for g in grads:
        jg = _nest({j: jnp.asarray(g[n]) for n, (j, _) in NAMES.items()})
        updates, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    model = _Named(values)
    opt = topt.build_optimizer(cfg, model)
    sched = tsched.build_schedule(cfg, steps_per_epoch=1)
    params = dict(model.named_parameters())
    trainable = topt.trainable_params(opt)
    for step, g in enumerate(grads):
        for n, p in params.items():
            p.grad = (torch.from_numpy(g[n].copy()) if p.requires_grad
                      else None)
        norm = topt.clip_by_global_norm(trainable, cfg.loss.clips_max_norm)
        want_norm = np.sqrt(sum((g[n] ** 2).sum() for n in NAMES
                                if NAMES[n][1] != "frozen"))
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-6)
        topt.set_learning_rate(opt, sched(step))
        opt.step()
    for n, (jpath, label) in NAMES.items():
        node = jparams
        for k in jpath.split("/"):
            node = node[k]
        got = params[n].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(node), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
        assert (label == "frozen") == np.array_equal(got, values[n]), n


@pytest.mark.parametrize("policy", ["step", "cosine", "linear"])
def test_schedules_match_jax_at_edges(policy):
    cfg = _cfg(lr_policy=policy, epoch_num=6, lr_milestone=[2, 4],
               step=0.1, use_warmup=True, warmup_epochs=1,
               warmup_start_lr=1e-5, min_lr=1e-6)
    spe = 5
    jfn = jsched.build_schedule(cfg, spe)
    tfn = tsched.build_schedule(cfg, spe)
    # warm-up edge, milestones and their neighbours, the horizon and past it
    # the JAX schedules evaluate in float32: its rounding of terms of the
    # size of LR (1e-3 * 2^-24) bounds the absolute difference
    for step in (0, 1, 4, 5, 6, 9, 10, 11, 19, 20, 21, 29, 30, 31, 45):
        np.testing.assert_allclose(tfn(step), float(jfn(step)), rtol=1e-6,
                                   atol=1e-10, err_msg=f"{policy} {step}")
