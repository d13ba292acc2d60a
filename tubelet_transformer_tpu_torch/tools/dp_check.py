"""One data-parallel train step held against the single-process step on the
same global batch from the same state, and against a control that
normalises each rank by its own shard.

Run under torchrun, one process per rank (two ranks on one card over gloo,
which carries ``all_reduce`` of CUDA tensors; NCCL needs a card per rank):

  python -m torch.distributed.run --nproc_per_node 2 \\
      -m tubelet_transformer_tpu_torch.tools.dp_check \\
      --config-file configuration/tuber_csn152_ava22.yaml \\
      --device cuda:0 --dist-backend gloo --deterministic \\
      --out build/dp_check.pt

Every rank builds the train model from ``--seed`` with every dropout off
and takes its shard (rows rank*b .. rank*b + b - 1) of a global batch of
world x TRAIN.BATCH_SIZE float clips made from ``--batch-seed`` (float
clips: no HSV jitter, whose draws differ by rank). From the same initial
state it runs three steps:

* ``dp``: the train step with this rank's ``Mesh``;
* ``control``: the same step with ``LocalMesh``, each rank's own BN
  statistics and loss normalisers and the ranks' losses and gradients
  averaged, as a DDP port of the single-device step would have it;
* ``single`` (rank 0 alone): the one-process step on the whole batch (in
  ``microbatch_major`` order, which with ACCUM_STEPS gives it the DP
  step's microbatches).

For each it records the loss dict, the gradient norm, the clipped
gradients, the state after the step, the stem's statistics as the BN
affine received them, the stem kernels' launches and the all-reduces
during the step. ``readings`` compares ``dp`` and ``control`` with
``single``. Rank 0 writes the readings, the metrics, the launches and the
all-reduce counts to ``--out``. With ``--timed-steps`` N every rank then
times N more steps and the gradient all-reduce alone.

In bf16 the flagship model at random init parts from itself by as much as
the control does in the gradients once the batch is split otherwise (the
cause is not isolated: the kernels picked for 2 and for 4 clips round
otherwise, and a matching near a tie can flip): ``--float32`` (float32
compute, TF32 off) is the setting where every reading tells the DP step
from the control.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.models.layers import Dropout
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.ops.cuda import stem as stem_ops
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.train import engine
from tubelet_transformer_tpu_torch.train.optimizer import trainable_params


class LocalMesh(mesh_lib.Mesh):
    """The control: BN statistics and loss normalisers of the rank's own
    shard, the ranks' losses and gradients averaged."""

    def batch_mean(self, t):
        return t

    def count_sum(self, t):
        return t

    def share_sum(self, t):
        return mesh_lib.all_reduce_sum(t) / self.data


def global_batch(cfg: Config, n: int, seed: int,
                 boxless_from: Optional[int] = None) -> Dict[str, np.ndarray]:
    """``n`` samples of float clips and random targets for ``cfg``'s mode
    (AVA multi-hot labels, or JHMDB/UCF class ids with the key frame's
    position and visibility); the rows from ``boxless_from`` on hold no
    box."""
    rng = np.random.default_rng(seed)
    m, c, s = cfg.data.max_boxes, cfg.data.num_classes, cfg.data.img_size
    t = cfg.data.temp_len
    n_valid = rng.integers(1, m + 1, n)
    if boxless_from is not None:
        n_valid[boxless_from:] = 0
    valid = np.arange(m)[None] < n_valid[:, None]
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (n, m, 2)),
                            rng.uniform(0.1, 0.3, (n, m, 2))], -1)
    batch = {"clips": rng.normal(size=(n, t, s, s, 3)).astype(np.float32),
             "pad_mask": np.zeros((n, s, s), bool),
             "boxes": boxes.astype(np.float32), "valid": valid,
             "sizes": np.full((n, 2), s, np.float32)}
    if engine.is_ava_mode(cfg):
        batch["labels"] = (rng.uniform(size=(n, m, c)) < 0.3).astype(
            np.float32)
    else:
        batch["labels"] = rng.integers(0, c, (n, m)).astype(np.int32)
        batch["vis"] = (n_valid > 0).astype(np.int32)
        batch["key_pos"] = rng.integers(0, t, n).astype(np.int32)
    return batch


def microbatch_major(batch: dict, world: int, accum: int) -> dict:
    """The global batch (rank-major: rank r's shard is rows r*b ..) in the
    order whose consecutive microbatches of b*world/accum rows are the
    ranks' local microbatches: microbatch i = every rank's local slice i,
    as the DP step with ACCUM_STEPS takes them."""
    n = len(next(iter(batch.values())))
    b, mb = n // world, n // world // accum
    order = [r * b + i * mb + j for i in range(accum)
             for r in range(world) for j in range(mb)]
    return {k: v[order] for k, v in batch.items()}


def _stem_launches() -> tuple[int, int]:
    return stem_ops.STATS_LAUNCHES, stem_ops.LAUNCHES


def one_step(cfg: Config, model, initial: dict, batch: dict,
             mesh: mesh_lib.Mesh) -> dict:
    """One train step of ``model`` from ``initial`` (its state dict, a
    fresh optimizer) on ``batch`` (numpy) with ``mesh``: the metrics, the
    clipped gradients, the state after, the stem statistics the BN affine
    received, the stem kernels' launches (statistics, pooled) and the
    step's all-reduces."""
    model.load_state_dict(initial)
    state = engine.create_train_state(cfg, model, steps_per_epoch=10)
    step = engine.make_train_step(cfg, state, mesh=mesh)
    device = next(model.parameters()).device
    db = engine.device_batch(batch, device)
    bn1 = model.backbone.body.bn1
    stats: list = []

    def recording(mean, var):
        stats.append((mean.detach().clone(), var.detach().clone()))
        return type(bn1).batch_affine(bn1, mean, var)

    all_reduce, reduces = torch.distributed.all_reduce, [0]

    def counting(*a, **k):
        reduces[0] += 1
        return all_reduce(*a, **k)

    bn1.batch_affine = recording
    torch.distributed.all_reduce = counting
    before = _stem_launches()
    try:
        metrics = step(db, cfg.loss.dice_cof)
    finally:
        del bn1.batch_affine
        torch.distributed.all_reduce = all_reduce
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    after = _stem_launches()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
            "state": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()},
            "stem_stats": [(m.cpu(), v.cpu()) for m, v in stats],
            "launches": {"stem_stats": after[0] - before[0],
                         "stem_pool": after[1] - before[1]},
            "all_reduces": reduces[0]}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def readings(run: dict, single: dict, initial: dict) -> dict:
    """``run`` against ``single``: the largest relative difference of a
    loss-dict entry, of the gradient norm, of the stem's mean and variance,
    and the relative L2 differences of all gradients together and of the
    running statistics' updates."""
    keys = [k for k in single["metrics"] if k not in ("finite", "grad_norm")]
    names = sorted(single["grads"])
    stat_keys = [k for k in initial if k.endswith(("running_mean",
                                                   "running_var"))]

    def cat(d, ks):
        return torch.cat([d[k].reshape(-1).double() for k in ks])

    (m1, v1), (m2, v2) = run["stem_stats"][0], single["stem_stats"][0]
    return {
        "loss_rel": max(abs(run["metrics"][k] - single["metrics"][k])
                        / max(abs(single["metrics"][k]), 1e-12)
                        for k in keys),
        "grad_norm_rel": abs(run["metrics"]["grad_norm"]
                             - single["metrics"]["grad_norm"])
        / single["metrics"]["grad_norm"],
        "grads_rel": _rel(cat(run["grads"], names),
                          cat(single["grads"], names)),
        "running_update_rel": _rel(
            cat(run["state"], stat_keys) - cat(initial, stat_keys),
            cat(single["state"], stat_keys) - cat(initial, stat_keys)),
        "stem_mean_rel": _rel(m1, m2), "stem_var_rel": _rel(v1, v2),
    }


def _timed(device: torch.device, fn) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t) * 1e3


def timings(cfg: Config, model, batch: dict, mesh: mesh_lib.Mesh,
            steps: int) -> dict:
    """``steps`` more steps of this rank (each ended by a sync) from the
    model's state, then the gradient all-reduce alone, five times: ms."""
    device = next(model.parameters()).device
    state = engine.create_train_state(cfg, model, steps_per_epoch=10)
    step = engine.make_train_step(cfg, state, mesh=mesh)
    db = engine.device_batch(batch, device)
    step_ms = [_timed(device, lambda: step(db, cfg.loss.dice_cof))
               for _ in range(steps)]
    params = trainable_params(state.optimizer)
    reduce_ms = [_timed(device, lambda: engine.sync_gradients(params, mesh))
                 for _ in range(5)]
    n = sum(p.grad.numel() for p in params if p.grad is not None)
    return {"step_ms": step_ms, "grad_all_reduce_ms": reduce_ms,
            "grad_mb": n * 4 / 1e6}


def run(cfg: Config, device: torch.device, seed: int = 0,
        batch_seed: int = 1, initial: Optional[dict] = None,
        timed_steps: int = 0, batch: Optional[dict] = None
        ) -> Optional[dict]:
    """The three steps on this rank (in a joined process group); on rank 0
    the recorded runs, the readings and every rank's timings, None on the
    others. ``initial``: the model's state dict (else random weights from
    ``seed``); ``batch``: the global batch (else ``global_batch``)."""
    mesh = mesh_lib.create_mesh(cfg.mesh.data, cfg.mesh.model, cfg.mesh.pipe)
    cfg.mesh.data = mesh.data
    model = build_model(cfg, device=device, seed=seed, train=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    if initial is None:
        initial = {k: v.detach().cpu().clone()
                   for k, v in model.state_dict().items()}
    b = cfg.train.batch_size
    if batch is None:
        batch = global_batch(cfg, b * mesh.data, batch_seed)
    shard = {k: v[mesh.rank * b:(mesh.rank + 1) * b] for k, v in batch.items()}
    out = {"dp": one_step(cfg, model, initial, shard, mesh),
           "control": one_step(cfg, model, initial, shard,
                               LocalMesh(mesh.data, mesh.rank))}
    times = {}
    if timed_steps:
        times = timings(cfg, model, shard, mesh, timed_steps)
        print(f"dp_check rank {mesh.rank}: step ms "
              f"{[round(t, 2) for t in times['step_ms']]}, gradient "
              f"all-reduce ms "
              f"{[round(t, 2) for t in times['grad_all_reduce_ms']]} "
              f"({times['grad_mb']:.1f} MB in one buffer)", flush=True)
    every = mesh_lib.gather_global_tree(
        {k: np.asarray([v]) for k, v in times.items()
         if k != "grad_mb"}) if times else {}
    if mesh.rank:
        return None
    out["single"] = one_step(cfg, model, initial, microbatch_major(
        batch, mesh.data, max(1, cfg.train.accum_steps)), mesh_lib.Mesh())
    out["readings"] = {k: readings(out[k], out["single"], initial)
                       for k in ("dp", "control")}
    out["timings"] = {k: v.tolist() for k, v in every.items()}
    out["world"] = mesh.data
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:<LOCAL_RANK>)")
    p.add_argument("--dist-backend", default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random initial weights")
    p.add_argument("--batch-seed", type=int, default=1)
    p.add_argument("--deterministic", action="store_true",
                   help="torch.use_deterministic_algorithms(True)")
    p.add_argument("--float32", action="store_true",
                   help="MODEL.COMPUTE_DTYPE float32, TF32 off")
    p.add_argument("--timed-steps", type=int, default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    if args.deterministic:
        # cuBLAS reads this when its first handle is made
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    from tubelet_transformer_tpu_torch.config import load_config

    device = (torch.device(args.device) if args.device
              else mesh_lib.default_device())
    cfg = load_config(args.config_file)
    if args.float32:
        cfg.model.compute_dtype = "float32"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh_lib.init_distributed(device, args.dist_backend)
    try:
        out = run(cfg, device, args.seed, args.batch_seed,
                  timed_steps=args.timed_steps)
        if out is not None:
            out = {**{k: out[k] for k in ("readings", "timings", "world")},
                   **{k: {n: out[k][n]
                          for n in ("metrics", "launches", "all_reduces")}
                      for k in ("dp", "control", "single")}}
            torch.save(out, args.out)
            print(f"dp_check: readings {out['readings']}", flush=True)
    finally:
        mesh_lib.shutdown()


if __name__ == "__main__":
    main()
