"""The train and eval runners behind the CLIs (``train_ava``,
``eval_ava``, ``train_jhmdb``, ``eval_jhmdb``).

Port of ``tubelet_transformer_tpu/cli/runner.py``: loaders from
``data/loader.py`` and the datasets (AVA, JHMDB/UCF24, packed or not, and
the synthetic AVA set), the train build of the model with its pretrained
weights and optimizer, resume from the newest checkpoint (``MODEL.LOAD``
without ``PRETRAINED_PATH``), the epoch loop with checkpoints and
validation (AVA or JHMDB/UCF24 by ``DATA.DATASET_NAME``), SIGTERM/SIGINT
handling (a signal asks for a checkpoint at the next epoch boundary and a
clean exit), and the eval run of a checkpoint (``MODEL.LOAD`` with
``PRETRAINED_PATH``). With ``CONFIG.USE_LFB`` every sample carries its
keyframe's long-term memory window from the bank at ``LFB.BANK_PATH``;
``run_generate_lfb`` writes such a bank from a checkpoint (the
``generate_lfb`` CLI), under torchrun too.

Data parallelism (``MESH.DATA``): launched by torchrun, one process per
rank, the train and eval runs shard both splits over the ranks
(``BATCH_SIZE`` per rank, as the JAX package's per-chip batch), share rank
0's run stamp and resume path, write the config, metrics and checkpoints
from rank 0 alone, and stop at an epoch boundary when any rank was
signalled. With ``MESH.MODEL`` the model peers of a data shard read the
same shard (the loaders shard over ``MESH.DATA`` by data index) and split
the model between them (``parallel/sharding_rules.py``); with
``MESH.SPATIAL`` beside it the train and eval runs split the clip's rows
over them through the trunk too (``train/engine.py``), and
``generate_lfb``, as the JAX package's, ignores it. With ``MESH.PIPE``
the pipe peers of a data shard read the same shard too and hold the
transformer encoder's layers as GPipe stages (``parallel/pipeline.py``) in
the train and eval runs and ``generate_lfb``, as the JAX runner builds its
mesh with 'pipe'.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time

import torch

from tubelet_transformer_tpu_torch.data.loader import DataLoader
from tubelet_transformer_tpu_torch.utils import MetricsWriter, build_log_dir
from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.train import checkpoint as ckpt_lib
from tubelet_transformer_tpu_torch.train import engine
from tubelet_transformer_tpu_torch.train import loop as loop_lib


def build_dataset(cfg: Config, split: str):
    """The dataset of DATA.DATASET_NAME for ``split``, with the long-term
    memory attached under USE_LFB."""
    return _maybe_attach_lfb(cfg, _base_dataset(cfg, split))


def _maybe_attach_lfb(cfg: Config, ds):
    """USE_LFB: ship a long-term memory window with every sample, as the
    reference's collate variants do; without a bank the flag would train
    and evaluate with no long-term context, so that raises."""
    if not cfg.use_lfb or cfg.model.generate_lfb:
        return ds
    if not cfg.lfb.bank_path:
        raise ValueError(
            "USE_LFB needs LFB.BANK_PATH (an .npz feature bank; produce one "
            "with `python -m tubelet_transformer_tpu_torch.cli.generate_lfb`)")
    from tubelet_transformer_tpu_torch.eval.lfb import (BankAttachDataset,
                                                        FeatureBank)

    return BankAttachDataset(ds, FeatureBank.load(cfg.lfb.bank_path),
                             half_window=cfg.lfb.half_window)


def _base_dataset(cfg: Config, split: str):
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
        if cfg.data.packed_path:
            from tubelet_transformer_tpu_torch.data.packed import (
                PackedJHMDBDataset)

            return PackedJHMDBDataset(cfg, split)
        from tubelet_transformer_tpu_torch.data.jhmdb import JHMDBDataset

        return JHMDBDataset(cfg, split)
    raise ValueError(f"unknown dataset {name!r}")


def make_loaders(cfg: Config, val_only: bool = False):
    """(train_loader, val_loader) of this process's data shard (MESH.MODEL
    and MESH.PIPE peers read the same one): BATCH_SIZE per step and shard;
    each split padded to a multiple of the shards, and the val tail
    wrap-padded to full batches (the evaluators dedupe). ``val_only`` builds no train set
    (None in its place)."""
    rank, world = mesh_lib.data_shard(cfg.mesh.model * cfg.mesh.pipe)
    train_loader = None
    if not val_only:
        train_loader = DataLoader(build_dataset(cfg, "train"),
                                  cfg.train.batch_size, shuffle=True,
                                  seed=cfg.train.seed, rank=rank, world=world,
                                  num_workers=cfg.data.num_workers)
    val_loader = DataLoader(build_dataset(cfg, "val"), cfg.val.batch_size,
                            shuffle=False, rank=rank, world=world,
                            num_workers=cfg.data.num_workers,
                            drop_last=True, pad_to_batch=True)
    return train_loader, val_loader


def init_state(cfg: Config, steps_per_epoch: int, device: torch.device,
               seed: int = 0, mesh: mesh_lib.Mesh = mesh_lib.Mesh()
               ) -> engine.TrainState:
    """The train build of the model (random weights from ``seed``, then any
    configured pretrained weights, split over ``mesh``'s 'model' axis), its
    optimizer (ZeRO-1 over ``mesh`` with MESH.ZERO1) and schedule."""
    model = build_model(cfg, device=device, seed=seed, train=True,
                        pretrained=True, mesh=mesh)
    return engine.create_train_state(cfg, model, steps_per_epoch, mesh)


def _mesh(cfg: Config) -> mesh_lib.Mesh:
    """The mesh of MESH.* over the processes, MESH.DATA resolved to its
    size (what MESH.MODEL leaves of the world when -1) so that the model's
    and the step's checks see it, and MESH.SPATIAL's split of the clip's
    rows."""
    mesh = mesh_lib.create_mesh(cfg.mesh.data, cfg.mesh.model, cfg.mesh.pipe,
                                cfg.mesh.spatial)
    cfg.mesh.data = mesh.data
    return mesh


def _validate(cfg: Config, eval_step, model, val_loader, epoch: int,
              writer) -> dict:
    validate = (loop_lib.validate_ava if engine.is_ava_mode(cfg)
                else loop_lib.validate_ucf)
    return validate(cfg, eval_step, model, val_loader, epoch, writer)


def check_supported(cfg: Config) -> None:
    unsupported = {
        "CONFIG.TWO_STREAM": cfg.two_stream,
        "CONFIG.USE_LOCATION": cfg.use_location,
    }
    for name, asked in unsupported.items():
        if asked:
            raise NotImplementedError(f"{name} is not ported yet")
    engine.check_supported(cfg)


def run_training(cfg: Config, device: torch.device | str = "cuda",
                 seed: int = 0) -> dict:
    """Train for TRAIN.EPOCH_NUM epochs on ``device`` with random initial
    weights from ``seed``; returns the last validation result (empty when
    no epoch validated; the losses alone on a rank other than 0) and the
    run's directories. Under data parallelism every rank calls it, after
    ``parallel.mesh.init_distributed``."""
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
    mesh = _mesh(cfg)
    is_main = mesh_lib.is_main_process()
    # one run directory for every rank: rank 0's stamp
    stamp = mesh_lib.broadcast_string(time.strftime("%Y%m%d_%H%M%S"))
    dirs = build_log_dir(cfg, stamp=stamp, write_config=is_main)
    writer = MetricsWriter(dirs["tb"], enabled=True) if is_main else None
    train_loader, val_loader = make_loaders(cfg)
    steps_per_epoch = len(train_loader)
    state = init_state(cfg, steps_per_epoch, device, seed, mesh)

    start_epoch = cfg.train.start_epoch
    if cfg.model.load and not cfg.model.pretrained_path:
        # rank 0's choice: listings on a shared file system can disagree
        latest = mesh_lib.broadcast_string(
            (ckpt_lib.latest_checkpoint_any_run(
                cfg.log.base_path, cfg.log.save_dir,
                exp_name=cfg.log.exp_name) or "") if is_main else "")
        if latest:
            state, start_epoch, _ = ckpt_lib.load_checkpoint(latest, state)
            start_epoch += 1
            print(f"resumed from {latest} at epoch {start_epoch}")

    train_step = engine.make_train_step(cfg, state, mesh=mesh)
    eval_step = engine.make_eval_step(cfg, state.model, mesh=mesh)
    print(f"Start training on {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}), "
          f"rank {mesh.rank}: data shard {mesh.data_index} of "
          f"{mesh.data}, model peer {mesh.model_index} of {mesh.model}, "
          f"pipe stage {mesh.pipe_index} of {mesh.pipe}"
          f"{' (the clip rows split)' if mesh.spatial else ''}, "
          f"{steps_per_epoch} steps/epoch", flush=True)
    result: dict = {"dirs": dirs, "val": {}}
    t0 = time.time()
    try:
        for epoch in range(start_epoch, cfg.train.epoch_num):
            loop_lib.train_one_epoch(cfg, train_step, state, train_loader,
                                     epoch, writer)
            # the decision of this boundary, taken once on every rank: a
            # signal after it stops the run at the next boundary
            stop = mesh_lib.any_process(preempted["flag"])
            if (stop or epoch % cfg.log.save_freq == 0
                    or epoch == cfg.train.epoch_num - 1):
                path = ckpt_lib.save_checkpoint(dirs["ckpt"], state, epoch,
                                                keep=cfg.log.keep_ckpts)
                print(f"checkpoint {path}", flush=True)
            if stop:
                print(f"preempted: checkpointed epoch {epoch}, exiting")
                break
            if epoch % cfg.val.freq == 0 or epoch == cfg.train.epoch_num - 1:
                result["val"] = _validate(cfg, eval_step, state.model,
                                          val_loader, epoch, writer)
    finally:
        if writer:
            writer.close()
    print(f"Training time {time.time() - t0:.0f}s")
    return result


def run_eval(cfg: Config, device: torch.device | str = "cuda",
             seed: int = 0) -> dict:
    """Validate the checkpoint of MODEL.LOAD with PRETRAINED_PATH on the val
    split with the eval build of the model; returns the validation result
    (the losses alone on a rank other than 0) and the model."""
    check_supported(cfg)
    if not (cfg.model.load and cfg.model.pretrained_path):
        raise ValueError("eval requires MODEL.LOAD with PRETRAINED_PATH")
    device = torch.device(device)
    mesh = _mesh(cfg)
    _, val_loader = make_loaders(cfg, val_only=True)
    model = build_model(cfg, device=device, seed=seed, pretrained=True,
                        mesh=mesh)
    eval_step = engine.make_eval_step(cfg, model, mesh=mesh)
    return {"val": _validate(cfg, eval_step, model, val_loader, epoch=0,
                             writer=None), "model": model}


def run_generate_lfb(cfg: Config, out_path: str = "lfb_bank.npz",
                     device: torch.device | str = "cuda", seed: int = 0
                     ) -> str:
    """The long-term feature bank of the val split, from the checkpoint of
    MODEL.LOAD with PRETRAINED_PATH in ``generate_lfb`` mode, saved to
    ``out_path``; a slot is valid where its actor probability exceeds 0.8,
    as in the JAX package. Under torchrun each process runs its data shard
    with the model split over MESH.MODEL, every process fills the full
    bank, rank 0 writes it and the others wait at a barrier. Returns the
    path. MESH.SPATIAL is ignored, as the JAX package ignores it there."""
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh,
                                                            spatial=False))
    check_supported(cfg)
    if not (cfg.model.load and cfg.model.pretrained_path):
        # a bank from random weights poisons every later USE_LFB run
        raise ValueError(
            "generate_lfb requires MODEL.LOAD with PRETRAINED_PATH "
            "(a feature bank needs trained weights)")
    from tubelet_transformer_tpu_torch.eval.lfb import generate_bank

    cfg.model.generate_lfb = True
    mesh = _mesh(cfg)
    _, val_loader = make_loaders(cfg, val_only=True)
    model = build_model(cfg, device=torch.device(device), seed=seed,
                        pretrained=True, mesh=mesh)
    bank = generate_bank(cfg, model, val_loader,
                         mesh=mesh if mesh_lib.process_count() > 1 else None)
    if mesh_lib.is_main_process():
        bank.save(out_path)
        print(f"saved feature bank ({len(bank)} keyframes) to {out_path}",
              flush=True)
    mesh_lib.barrier()
    return out_path


def main(mode: str, default_dataset: str) -> None:
    """The CLIs' entry: ``mode`` "train", "eval" or "generate-lfb";
    ``default_dataset`` is DATA.DATASET_NAME when no config file is given.
    Flags: the JAX CLI's ``--config-file``, plus ``--device`` (by default
    ``cuda:<LOCAL_RANK>``), ``--seed`` (of the random initial weights),
    ``--dist-backend`` (the process group's backend under torchrun: what
    the JAX CLI passes to ``jax.distributed.initialize``), and for
    "generate-lfb" ``--out`` (the bank's path; the JAX CLI always writes
    ``lfb_bank.npz``)."""
    import argparse

    from tubelet_transformer_tpu_torch.config import load_config

    parser = argparse.ArgumentParser(
        description=f"TubeR {default_dataset} {mode} (PyTorch)")
    parser.add_argument("--config-file", default=None,
                        help="path to a YAML config (reference format OK)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:<LOCAL_RANK>); "
                             "'cpu' only when asked for")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random initial weights")
    parser.add_argument("--dist-backend", default=None,
                        help="process group backend under torchrun "
                             "(default: cuda:nccl,cpu:gloo on the card, "
                             "gloo on the CPU)")
    if mode == "generate-lfb":
        parser.add_argument("--out", default="lfb_bank.npz",
                            help="where the feature bank is written")
    args = parser.parse_args()
    device = (torch.device(args.device) if args.device
              else mesh_lib.default_device())
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    cfg = load_config(args.config_file)
    if not args.config_file:
        cfg.data.dataset_name = default_dataset
    mesh_lib.init_distributed(device, args.dist_backend)
    try:
        if mode == "train":
            run_training(cfg, device=device, seed=args.seed)
        elif mode == "generate-lfb":
            run_generate_lfb(cfg, args.out, device=device, seed=args.seed)
        else:
            cfg.eval_only = True
            run_eval(cfg, device=device, seed=args.seed)
    finally:
        mesh_lib.shutdown()
