"""TRAIN.REMAT_BACKBONE in the PyTorch port: each trainable bottleneck runs
under ``torch.utils.checkpoint`` and recomputes its activations in the
backward. One full-backprop train step with remat against the same step
without, on the port: the gradients, the parameters after the step and the
BN running statistics bit for bit (the recompute must not update the
statistics a second time), and the depthwise wrapper reached twice per
trainable layer1 block with MODEL.PALLAS_KERNELS. The remat step against
the JAX package's remat step is test_torch_accum.py's
test_accum_step_matches_jax, which runs it. CSN-TINY with the avg temporal
pooling, float32 on the CPU."""

import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_accum import port_only_model, step_cfg
from test_torch_train_step import _batch

from tubelet_transformer_tpu_torch.models import csn
from tubelet_transformer_tpu_torch.ops.cuda import depthwise
from tubelet_transformer_tpu_torch.train import engine

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _remat_cfg(remat):
    cfg = step_cfg()
    cfg.model.pretrained = False            # stop_grad_stage -1
    cfg.train.remat_backbone = remat
    cfg.model.pallas_kernels = True
    return cfg


def _port_step(cfg, batch):
    model = port_only_model(cfg)
    state = engine.create_train_state(cfg, model, steps_per_epoch=10)
    calls = depthwise.CALLS
    got = engine.make_train_step(cfg, state)(
        engine.device_batch(batch, torch.device("cpu")), cfg.loss.dice_cof)
    return model, got, depthwise.CALLS - calls


def test_remat_step_is_the_plain_step():
    """MODEL.PALLAS_KERNELS on, so that layer1's depthwise goes through the
    kernel's wrapper (its plain version on the CPU) and is counted."""
    batch = _batch(step_cfg())
    (plain, m_plain, calls_plain), (remat, m_remat, calls_remat) = (
        _port_step(_remat_cfg(remat), batch) for remat in (False, True))
    assert all(isinstance(b, torch.nn.Sequential) for b in (
        remat.backbone.body.layer1, plain.backbone.body.layer1))
    for k in m_plain:
        assert torch.equal(m_plain[k], m_remat[k]), k
    named = dict(remat.named_parameters())
    for name, p in plain.named_parameters():
        assert torch.equal(p, named[name]), name
        assert (p.grad is None) == (named[name].grad is None), name
        if p.grad is not None:
            assert torch.equal(p.grad, named[name].grad), name
    buffers = dict(remat.named_buffers())
    for name, b in plain.named_buffers():
        assert torch.equal(b, buffers[name]), name
    # layer1's one block: once in the forward, once more in the recompute
    assert (calls_plain, calls_remat) == (1, 2)


def test_recompute_leaves_running_stats_alone():
    """The flag the recompute sets keeps FoldableBN and ShortcutBN from a
    second EMA update, and is cleared after it."""
    bn, short = csn.FoldableBN(4), csn.ShortcutBN(4)
    mean, var = torch.full((4,), 2.0), torch.full((4,), 3.0)
    with csn._recomputing():
        bn.update_running(mean, var)
        short.train()(torch.ones(2, 4) * 5.0)
    assert torch.equal(bn.running_mean, torch.zeros(4))
    assert torch.equal(short.running_mean, torch.zeros(4))
    bn.update_running(mean, var)
    assert torch.equal(bn.running_mean, torch.full((4,), 0.2))
