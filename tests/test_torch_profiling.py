"""LOG.PROFILE_STEPS in the PyTorch port: ``run_training`` traces steps
1..N of epoch 0 with ``profiling.trace`` (torch.profiler) and writes a
Chrome trace under ``<log dir>/profile``, as the JAX package's loop does
with ``jax.profiler``; a profiler that fails to start warns and the steps
run untraced. On the CPU."""

import glob
import json

import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_train_step import _cfg

from tubelet_transformer_tpu_torch import profiling
from tubelet_transformer_tpu_torch.cli import runner

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_run_training_writes_a_trace(tmp_path, capsys):
    cfg = _cfg()
    cfg.model.temporal_ds_strategy = "avg"
    cfg.data.dataset_name = "synthetic"
    cfg.data.synthetic_size = 4
    cfg.data.img_size = 32
    cfg.data.num_workers = 1
    cfg.train.batch_size = 2
    cfg.train.epoch_num = 1
    cfg.val.freq = 5                       # no validation
    cfg.log.base_path = str(tmp_path)
    cfg.log.profile_steps = 1
    runner.run_training(cfg, device="cpu")
    traces = glob.glob(str(tmp_path / "*" / "tb_log" / "profile" /
                           "trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    # one train step traced (step 1 of 2): its CSN convolutions are there
    names = {e.get("name") for e in events}
    assert any(n and "conv" in n for n in names)
    assert "warning" not in capsys.readouterr().out


def test_trace_that_fails_to_start_warns_and_runs(tmp_path, capsys,
                                                  monkeypatch):
    def refuse(self):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    ran = []
    with profiling.trace(str(tmp_path / "p")):
        ran.append(torch.ones(2).sum())
    assert ran and "profiler busy" in capsys.readouterr().out
    assert not (tmp_path / "p").exists()
    with profiling.trace(str(tmp_path / "q"), enabled=False):
        ran.append(1)
    assert len(ran) == 2 and not (tmp_path / "q").exists()
