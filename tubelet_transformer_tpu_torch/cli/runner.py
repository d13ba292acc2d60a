"""The training runner behind ``cli/train_ava``.

Port of ``tubelet_transformer_tpu/cli/runner.py`` for one device: loaders
from ``data/loader.py`` and the datasets, the train build of the
model with its optimizer, resume from the newest checkpoint
(``MODEL.LOAD`` without ``PRETRAINED_PATH``), the epoch loop with
checkpoints and validation, and SIGTERM/SIGINT handling: a signal asks for a
checkpoint at the next epoch boundary and a clean exit.
"""

from __future__ import annotations

import os
import signal
import time

import torch

from tubelet_transformer_tpu_torch.data.loader import DataLoader
from tubelet_transformer_tpu_torch.utils import MetricsWriter, build_log_dir
from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.train import checkpoint as ckpt_lib
from tubelet_transformer_tpu_torch.train import engine
from tubelet_transformer_tpu_torch.train import loop as loop_lib


def build_dataset(cfg: Config, split: str):
    name = cfg.data.dataset_name
    if name == "ava":
        if cfg.data.packed_path:
            from tubelet_transformer_tpu_torch.data.packed import PackedAVADataset

            return PackedAVADataset(cfg, split)
        from tubelet_transformer_tpu_torch.data.ava import AVADataset

        return AVADataset(cfg, split)
    if name == "synthetic":
        from tubelet_transformer_tpu_torch.data.synthetic import SyntheticAVADataset

        return SyntheticAVADataset(cfg, size=cfg.data.synthetic_size)
    if name in ("jhmdb", "ucf"):
        raise NotImplementedError(f"DATA.DATASET_NAME {name} is not ported "
                                  "yet")
    raise ValueError(f"unknown dataset {name!r}")


def make_loaders(cfg: Config):
    """(train_loader, val_loader) for one device: BATCH_SIZE per step; the
    val tail is wrap-padded to full batches (the evaluators dedupe)."""
    train_loader = DataLoader(build_dataset(cfg, "train"),
                              cfg.train.batch_size, shuffle=True,
                              seed=cfg.train.seed,
                              num_workers=cfg.data.num_workers)
    val_loader = DataLoader(build_dataset(cfg, "val"), cfg.val.batch_size,
                            shuffle=False, num_workers=cfg.data.num_workers,
                            drop_last=True, pad_to_batch=True)
    return train_loader, val_loader


def init_state(cfg: Config, steps_per_epoch: int, device: torch.device,
               seed: int = 0) -> engine.TrainState:
    """The train build of the model (random weights from ``seed``, then any
    configured pretrained weights), its optimizer and schedule."""
    model = build_model(cfg, device=device, seed=seed, train=True)
    ckpt_lib.load_pretrained(cfg, model)
    return engine.create_train_state(cfg, model, steps_per_epoch)


def check_supported(cfg: Config) -> None:
    unsupported = {
        "CONFIG.TWO_STREAM": cfg.two_stream,
        "CONFIG.USE_LOCATION": cfg.use_location,
        "CONFIG.USE_LFB": cfg.use_lfb,
        "LOG.PROFILE_STEPS": cfg.log.profile_steps > 0,
    }
    for name, asked in unsupported.items():
        if asked:
            raise NotImplementedError(f"{name} is not ported yet")
    engine.check_supported(cfg)


def run_training(cfg: Config, device: torch.device | str = "cuda",
                 seed: int = 0) -> dict:
    """Train for TRAIN.EPOCH_NUM epochs on ``device`` with random initial
    weights from ``seed``; returns the last validation result (empty when
    no epoch validated) and the run's directories."""
    check_supported(cfg)
    preempted = {"flag": False}

    def request_stop(signum, frame):
        preempted["flag"] = True
        # os.write: a print() interrupted mid-write would raise instead
        os.write(2, (f"signal {signum}: will checkpoint and stop at the "
                     "next epoch boundary\n").encode())

    previous = {s: signal.signal(s, request_stop)
                for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return _run_training_body(cfg, torch.device(device), seed, preempted)
    finally:
        for s, h in previous.items():
            signal.signal(s, h)


def _run_training_body(cfg: Config, device: torch.device, seed: int,
                       preempted: dict) -> dict:
    dirs = build_log_dir(cfg)
    writer = MetricsWriter(dirs["tb"], enabled=True)
    train_loader, val_loader = make_loaders(cfg)
    steps_per_epoch = len(train_loader)
    state = init_state(cfg, steps_per_epoch, device, seed)

    start_epoch = cfg.train.start_epoch
    if cfg.model.load and not cfg.model.pretrained_path:
        latest = ckpt_lib.latest_checkpoint_any_run(
            cfg.log.base_path, cfg.log.save_dir, exp_name=cfg.log.exp_name)
        if latest:
            state, start_epoch, _ = ckpt_lib.load_checkpoint(latest, state)
            start_epoch += 1
            print(f"resumed from {latest} at epoch {start_epoch}")

    train_step = engine.make_train_step(cfg, state)
    eval_step = engine.make_eval_step(cfg, state.model)
    print(f"Start training on {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}), "
          f"{steps_per_epoch} steps/epoch", flush=True)
    result: dict = {"dirs": dirs, "val": {}}
    t0 = time.time()
    try:
        for epoch in range(start_epoch, cfg.train.epoch_num):
            loop_lib.train_one_epoch(cfg, train_step, state, train_loader,
                                     epoch, writer)
            stop = preempted["flag"]
            if (stop or epoch % cfg.log.save_freq == 0
                    or epoch == cfg.train.epoch_num - 1):
                path = ckpt_lib.save_checkpoint(dirs["ckpt"], state, epoch,
                                                keep=cfg.log.keep_ckpts)
                print(f"checkpoint {path}", flush=True)
            if stop:
                print(f"preempted: checkpointed epoch {epoch}, exiting")
                break
            if epoch % cfg.val.freq == 0 or epoch == cfg.train.epoch_num - 1:
                result["val"] = loop_lib.validate_ava(
                    cfg, eval_step, state.model, val_loader, epoch, writer)
    finally:
        writer.close()
    print(f"Training time {time.time() - t0:.0f}s")
    return result
