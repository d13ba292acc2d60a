"""Per-axis multi-rank dry-run micro-steps: the port's counterpart of
``tubelet_transformer_tpu/parallel/dryrun_steps.py``.

Each proof is ONE tiny train step exercising ONE parallelism axis over
the ranks of a torchrun launch:

  dp_tp  - the whole world as ('data', 'model'): MODEL 2 when the world
           is 4 or more and even, else every rank a data shard (the
           gradient all-reduce, and the tensor-parallel attention and FFN
           over 'model');
  sp     - 2 ranks of spatial parallelism: the clip's H axis over 'model'
           through the CSN trunk, with the halo exchanges;
  ep     - 2 ranks of expert parallelism: the MoE expert stacks over
           'model';
  pp     - 2 ranks of pipeline parallelism: the encoder as GPipe stages
           over 'pipe' (parallel/pipeline.py);
  zero1  - 2 ranks of ZeRO-1: the AdamW moments over 'data', the loss
           equal to the replicated-optimizer run's.

Each builds the JAX package's ``_tiny_cfg`` (CSN-TINY, a 2+1-layer
transformer of width 32, 32 px clips of 8 frames, one synthetic sample a
data shard, at least two), runs one step on the global batch of the
synthetic set (each rank its data shard's rows) and asserts a finite loss
and one step taken.

Usage (the axes whose world is the launch's with ``--axis all``; sp, ep,
pp and zero1 take 2 ranks, dp_tp any number):

  python -m torch.distributed.run --nproc_per_node 2 \\
      -m tubelet_transformer_tpu_torch.parallel.dryrun_steps \\
      --axis all --devices 2 --device cpu
"""

from __future__ import annotations

import numpy as np

AXES = ("dp_tp", "sp", "ep", "pp", "zero1")
# the ranks each axis's proof takes (dp_tp: the launch's)
AXIS_WORLD = {"sp": 2, "ep": 2, "pp": 2, "zero1": 2}


def _tiny_cfg(n_data: int):
    """Smallest config that exercises every sharded code path: CSN-TINY
    backbone, 2+1 transformer, one sample per data shard."""
    from tubelet_transformer_tpu_torch.config import Config

    cfg = Config()
    cfg.data.dataset_name = "synthetic"
    cfg.data.num_classes = 6
    cfg.data.max_boxes = 4
    cfg.data.img_size = 32
    cfg.data.temp_len = 8
    cfg.model.backbone_name = "CSN-TINY"
    cfg.model.query_num = 5
    cfg.model.temp_len = 8
    cfg.model.enc_layers = 2
    cfg.model.dec_layers = 1
    cfg.model.d_model = 32
    cfg.model.nhead = 2
    cfg.model.dim_feedforward = 32
    cfg.model.compute_dtype = "float32"
    cfg.model.temporal_ds_strategy = "decode"
    cfg.train.batch_size = max(2, n_data)
    return cfg


def _one_step(cfg, mesh, device, zero1: bool = False) -> float:
    """Build the model and state on ``mesh``, run one train step on this
    rank's data shard of the global batch (``cfg.train.batch_size``
    samples), and return the global loss."""
    import torch

    from tubelet_transformer_tpu_torch.data.loader import collate
    from tubelet_transformer_tpu_torch.data.synthetic import (
        SyntheticAVADataset)
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import engine

    n = cfg.train.batch_size
    ds = SyntheticAVADataset(cfg, size=n)
    rng = np.random.default_rng(0)
    batch = collate([ds.get(i, rng) for i in range(n)])
    b = n // mesh.data
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    cfg.mesh.zero1 = zero1
    model = build_model(cfg, device=device, train=True, mesh=mesh)
    state = engine.create_train_state(cfg, model, steps_per_epoch=10,
                                      mesh=mesh)
    step = engine.make_train_step(cfg, state, mesh=mesh)
    metrics = step(engine.device_batch(
        {k: v[rows] for k, v in batch.items() if k in engine.DEVICE_KEYS},
        torch.device(device)), cfg.loss.dice_cof)
    total = float(metrics["total_loss"])
    assert np.isfinite(total), f"non-finite dryrun loss: {total}"
    assert state.step == 1
    return total


def run_axis(axis: str, n_devices: int, device="cpu") -> str:
    """Run one parallelism-axis proof over the launch's ``n_devices``
    ranks; returns a one-line summary."""
    from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib

    need = AXIS_WORLD.get(axis, n_devices)
    if axis not in AXES:
        raise ValueError(f"unknown axis {axis!r} (choose from {AXES})")
    if mesh_lib.process_count() != n_devices or n_devices != need:
        raise ValueError(f"axis {axis} takes {need} ranks; the launch has "
                         f"{mesh_lib.process_count()} (--devices "
                         f"{n_devices})")
    if axis == "dp_tp":
        n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
        n_data = n_devices // n_model
        cfg = _tiny_cfg(n_data)
        cfg.mesh.data, cfg.mesh.model = n_data, n_model
        loss = _one_step(cfg, mesh_lib.create_mesh(n_data, n_model), device)
        return f"dp_tp: mesh {n_data}x{n_model} ok, loss={loss:.4f}"
    if axis == "sp":
        cfg = _tiny_cfg(1)
        cfg.mesh.model, cfg.mesh.spatial = 2, True
        loss = _one_step(cfg, mesh_lib.create_mesh(1, 2, spatial=True),
                         device)
        return f"sp: mesh 1x2 spatial ok, loss={loss:.4f}"
    if axis == "ep":
        cfg = _tiny_cfg(1)
        cfg.model.moe_experts, cfg.mesh.model = 2, 2
        loss = _one_step(cfg, mesh_lib.create_mesh(1, 2), device)
        return f"ep: mesh 1x2 moe ok, loss={loss:.4f}"
    if axis == "pp":
        cfg = _tiny_cfg(1)
        cfg.mesh.pipe, cfg.mesh.pipe_microbatches = 2, 2
        loss = _one_step(cfg, mesh_lib.create_mesh(1, 1, 2), device)
        return f"pp: mesh 1x1x2 ok, loss={loss:.4f}"
    cfg = _tiny_cfg(2)
    cfg.mesh.data = 2
    mesh = mesh_lib.create_mesh(2, 1)
    loss_z = _one_step(cfg, mesh, device, zero1=True)
    loss_r = _one_step(cfg, mesh, device, zero1=False)
    assert loss_z == loss_r, f"zero1 loss {loss_z} != replicated {loss_r}"
    return f"zero1: mesh 2x1 ok, loss={loss_z:.4f} (== replicated)"


def axes_for(axis: str, n_devices: int) -> list:
    """The axes of ``--axis`` (one, or "all": every axis whose proof takes
    ``n_devices`` ranks)."""
    if axis != "all":
        return [axis]
    return [a for a in AXES if AXIS_WORLD.get(a, n_devices) == n_devices]


def main(argv=None) -> None:
    import argparse

    import torch

    from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--axis", required=True, choices=AXES + ("all",))
    parser.add_argument("--devices", type=int, required=True,
                        help="the launch's ranks (torchrun's "
                             "--nproc_per_node)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:<LOCAL_RANK>); "
                             "'cpu' for the CPU dry run over gloo")
    parser.add_argument("--dist-backend", default=None)
    args = parser.parse_args(argv)
    device = (torch.device(args.device) if args.device
              else mesh_lib.default_device())
    torch.manual_seed(0)
    mesh_lib.init_distributed(device, args.dist_backend)
    try:
        for axis in axes_for(args.axis, args.devices):
            line = run_axis(axis, args.devices, device)
            if mesh_lib.is_main_process():
                print(line, flush=True)
    finally:
        mesh_lib.shutdown()


if __name__ == "__main__":
    main()
