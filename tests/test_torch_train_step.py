"""One whole train step of the PyTorch port (train/engine.py) against the
JAX package's ``engine.make_train_step``, from the same initial variables
(BN statistics randomised) and batch, with dropout off on both sides and
float clips (no jitter): the loss dict, the gradient norm, the parameters
after the step for each optimizer group, and the BN running statistics.
Then the NaN guard, and ``run_training`` end to end with a resume.
CSN-TINY, TUNE_POINT 4 (stem + layer1-2 frozen), float32 on the CPU."""

import glob
import json
import signal

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_csn import randomize_bn
from test_torch_tuber import small_cfg

from tubelet_transformer_tpu.models.tuber import build_model as jbuild_model
from tubelet_transformer_tpu.train import engine as jengine
from tubelet_transformer_tpu.train.torch_convert import (
    tuber_torch_state_from_params)
from tubelet_transformer_tpu_torch.cli import runner
from tubelet_transformer_tpu_torch.convert import load_jax_variables
from tubelet_transformer_tpu_torch.models.layers import Dropout
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.train import checkpoint as ckpt_lib
from tubelet_transformer_tpu_torch.train import engine
from tubelet_transformer_tpu_torch.train.optimizer import param_label


def _cfg():
    cfg = small_cfg("decode")
    cfg.data.max_boxes = 4
    cfg.model.pretrained = True              # TUNE_POINT 4: stop_grad 2
    cfg.model.dropout = 0.0
    cfg.train.lr, cfg.train.lr_backbone = 1e-4, 1e-5
    return cfg


def _batch(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    m, c, img = cfg.data.max_boxes, cfg.data.num_classes, cfg.data.img_size
    valid = np.arange(m)[None] < np.array([[3], [2]])[:b]
    labels = (rng.uniform(size=(b, m, c)) < 0.3).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (b, m, 2)),
                            rng.uniform(0.1, 0.3, (b, m, 2))], -1)
    return {"clips": rng.normal(size=(b, cfg.data.temp_len, img, img, 3)
                                ).astype(np.float32),
            "pad_mask": np.zeros((b, img, img), bool),
            "boxes": boxes.astype(np.float32), "labels": labels,
            "valid": valid, "sizes": np.full((b, 2), img, np.float32)}


def _port_model(cfg, params, stats):
    model = load_jax_variables(build_model(cfg, train=True), params, stats)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0                        # the class branch's fixed rates
    return model


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step's inputs and results, with every flax Dropout off (the
    JAX TubeR fixes the class branch's rates at 0.1 and 0.5)."""
    cfg = _cfg()
    batch = _batch(cfg)
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
    return cfg, batch, params, stats, jax.device_get(metrics), after


def _sd(cfg, params, stats):
    return tuber_torch_state_from_params(
        params, stats, block_nums=(1, 1, 1, 1),
        enc_layers=cfg.model.enc_layers, dec_layers=cfg.model.dec_layers,
        temporal_ds_strategy="decode", single_frame=True, ddp_prefix=False)


def test_train_step_matches_jax(jax_step):
    cfg, batch, params, stats, want, (jparams, jstats) = jax_step
    model = _port_model(cfg, params, stats)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = engine.create_train_state(cfg, model, steps_per_epoch=10)
    got = engine.make_train_step(cfg, state)(
        engine.device_batch(batch, torch.device("cpu")), cfg.loss.dice_cof)
    assert state.step == state.updates == 1 and got["finite"] == 1.0
    assert set(want) == set(got)
    for k in want:
        # float32 through the whole model and the matched losses; the
        # gradient norm also carries the JAX CPU backward's drift into
        # layer3 (see test_torch_train_csn.py)
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-2 if k == "grad_norm" else 1e-4,
                                   atol=1e-5, err_msg=k)
    want_sd = _sd(cfg, jparams, jstats)
    after = model.state_dict()
    lr = {"main": cfg.train.lr, "backbone": cfg.train.lr_backbone}
    moved_groups = set()
    for name, p in model.named_parameters():
        label = param_label(name, cfg)
        old = before[name].numpy()
        moved = after[name].numpy() - old
        want_moved = want_sd[name] - old
        if label == "frozen":
            assert not moved.any() and not want_moved.any(), name
            continue
        if moved.any():
            moved_groups.add(label)
        # The first Adam step moves each weight by lr * g / (|g| + 1e-8):
        # the two agree to float32 (1e-3 lr, and the weight's own rounding)
        # wherever the clipped gradient is not near zero. Near zero (below
        # a quarter of the gradients' rms of ~4e-5) a sum carries its
        # largest relative rounding, and its sign or its ratio to the 1e-8
        # epsilon can differ between the frameworks, more so in layer3-4,
        # where the JAX package's float32 CPU backward drifts
        # (test_torch_train_csn.py); there the updates differ by <= 2 lr.
        diff = np.abs(moved - want_moved)
        assert diff.max() <= 2.2 * lr[label], name
        off = diff > 1e-3 * lr[label] + 2 * np.spacing(np.abs(old))
        assert np.abs(p.grad.numpy()[off]).max(initial=0) < 1e-5, name
    assert moved_groups == {"main", "backbone"}
    for name in want_sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(after[name].numpy(), want_sd[name],
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_nan_guard_skips_the_whole_update(jax_step):
    """A poisoned batch after a good step: the loss is not finite, and the
    parameters, the Adam moments and the BN statistics stay as they were;
    the step count moves, the update count does not."""
    cfg, batch, params, stats, _, _ = jax_step
    model = _port_model(cfg, params, stats)
    state = engine.create_train_state(cfg, model, steps_per_epoch=10)
    step = engine.make_train_step(cfg, state)
    cpu = torch.device("cpu")
    step(engine.device_batch(batch, cpu), cfg.loss.dice_cof)
    kept = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [{k: v.clone() for k, v in s.items()}
               for s in state.optimizer.state.values()]
    bad = dict(batch, clips=np.full_like(batch["clips"], np.nan))
    metrics = step(engine.device_batch(bad, cpu), cfg.loss.dice_cof)
    assert metrics["finite"] == 0.0 and not torch.isfinite(
        metrics["total_loss"])
    assert (state.step, state.updates) == (2, 1)
    for k, v in model.state_dict().items():
        assert torch.equal(v, kept[k]), k
    for s, m in zip(state.optimizer.state.values(), moments):
        for k in m:
            assert torch.equal(s[k], m[k]), k


def test_run_training_writes_checkpoint_logs_and_resumes(tmp_path):
    """The runner on the synthetic set: a checkpoint per epoch, train and
    val metrics in metrics.jsonl, and MODEL.LOAD resuming from the newest
    checkpoint of the experiment to train the next epoch."""
    cfg = _cfg()
    cfg.model.temporal_ds_strategy = "avg"
    cfg.data.dataset_name = "synthetic"
    cfg.data.synthetic_size = 4
    cfg.data.img_size = 32
    cfg.data.num_workers = 2
    cfg.train.batch_size = 2
    cfg.train.epoch_num = 1
    cfg.val.freq = 1
    cfg.log.base_path = str(tmp_path)
    cfg.log.display_freq = 1
    first = runner.run_training(cfg, device="cpu")
    assert set(first["val"]) >= {"mAP", "person_AP", "loss_ce"}
    ckpts = glob.glob(str(tmp_path / "*" / "checkpoints" / "ckpt_epoch_0"))
    assert len(ckpts) == 1
    logs = glob.glob(str(tmp_path / "*" / "tb_log" / "metrics.jsonl"))
    tags = {json.loads(line)["tag"] for line in open(logs[0])}
    assert {"train/total_loss", "val/val_mAP_epoch"} <= tags

    cfg.model.load = True
    cfg.train.epoch_num = 2
    second = runner.run_training(cfg, device="cpu")
    resumed = glob.glob(str(tmp_path / "*" / "checkpoints" / "ckpt_epoch_1"))
    assert len(resumed) == 1 and second["dirs"]["ckpt"] in resumed[0]
    assert ckpt_lib.latest_checkpoint(second["dirs"]["ckpt"]) == resumed[0]
    payload = torch.load(resumed[0], weights_only=True)
    assert payload["epoch"] == 1 and payload["step"] == 4   # 2 + 2 steps
    assert not glob.glob(second["dirs"]["ckpt"] + "/ckpt_epoch_0")


def test_sigterm_checkpoints_and_stops(tmp_path, monkeypatch):
    """SIGTERM during an epoch: the epoch finishes, a checkpoint is
    written, the run stops before validating and the next epoch, and the
    previous signal handler is back afterwards."""
    cfg = _cfg()
    cfg.model.temporal_ds_strategy = "avg"
    cfg.data.dataset_name = "synthetic"
    cfg.data.synthetic_size = 2
    cfg.data.img_size = 32
    cfg.data.num_workers = 1
    cfg.train.batch_size = 2
    cfg.train.epoch_num = 3
    cfg.val.freq = 1
    cfg.log.base_path = str(tmp_path)
    make = engine.make_train_step

    def make_then_signal(cfg_, state, **kw):
        step = make(cfg_, state, **kw)

        def signalled(batch, weight):
            signal.raise_signal(signal.SIGTERM)
            return step(batch, weight)

        return signalled

    monkeypatch.setattr(engine, "make_train_step", make_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    result = runner.run_training(cfg, device="cpu")
    assert result["val"] == {}
    assert [p.rsplit("_", 1)[1] for p in glob.glob(
        result["dirs"]["ckpt"] + "/ckpt_epoch_*")] == ["0"]
    assert signal.getsignal(signal.SIGTERM) is before
