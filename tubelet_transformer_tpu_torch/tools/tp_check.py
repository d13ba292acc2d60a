"""One tensor-parallel train step (``MESH.MODEL``) held against the
single-process step on the same global batch from the same state, and
against a control whose "g" sums again in its backward.

Run under torchrun, one process per rank (ranks on one card over gloo,
which carries ``all_reduce`` and ``all_gather_into_tensor`` of CUDA
tensors; NCCL needs a card per rank):

  python -m torch.distributed.run --nproc_per_node 2 \\
      -m tubelet_transformer_tpu_torch.tools.tp_check \\
      --config-file configuration/tuber_csn152_ava22.yaml --model 2 \\
      --device cuda:0 --dist-backend gloo --deterministic \\
      --dtypes float32,bfloat16 --moe --out build/tp_check.pt

The mesh is ``--data`` x ``--model`` (the config's MESH.DATA and
MESH.MODEL by default; ranks = data x model). Every rank builds the train
model from ``--seed`` with every dropout off, split over the 'model' axis
(``build_model(..., mesh=mesh)``), and takes its data shard (rows d*b ..
d*b + b - 1 for data index d) of a global batch of MESH.DATA x
TRAIN.BATCH_SIZE float clips made from ``--batch-seed``. From one
state it runs:

* ``tp``: the train step on the mesh;
* ``control``: the same step with "g" (``Mesh.reduce_from_model``) in
  ``parallel.mesh._AllReduceSum``'s form, whose backward sums the
  gradient over the model peers again: each split region then passes on
  ``model`` times its gradient. Its forward, and so its losses and batch
  statistics, are the step's own: the gradient readings tell it apart;
* ``peers``: two steps, after each a digest of every replicated parameter
  and every buffer of each rank, which must equal its model peers';
* ``single`` (rank 0 alone): the one-process step of the full model on
  the whole batch.

For the two first it records what ``dp_check.one_step`` records (the
gradients and the state after gathered to the one-process layout), and
``readings`` compares each with ``single``: ``dp_check.readings`` and
``update_rel``, the relative L2 difference of the parameters' updates.
Every rank's stem-kernel launches in the step are gathered. With
``--timed-steps`` N every rank then times N more steps and, replayed at
the sizes one step makes them, the all-reduces of its model group.

``--dtypes`` runs the check once per compute dtype (float32 with TF32
off; ``--timed-steps`` times the first), ``--moe`` once more with
``MODEL.MOE_EXPERTS 4`` and ``MOE_TOP_K 2`` (expert parallelism: 2 experts
a peer at MODEL 2), in float32 when it is among the dtypes.

``--zero1`` (with ``--data`` above 1): each case also runs
``dp_check.zero1_check`` on the mesh, from the same state and on the same
shard: two steps of the DATA x MODEL step, of the same step with
``MESH.ZERO1`` (the moments of the replicated parameters sharded over the
data group, the split ones the model peer's slices) and of the ZeRO-1
control without the all-gather; on every rank whether the model's and the
optimizer's state dicts equal the DATA x MODEL step's bit for bit after
each step, and this rank's moment bytes from the tensors beside the
figure from the shapes.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import os
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.models.layers import Dropout
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.parallel import sharding_rules
from tubelet_transformer_tpu_torch.tools import dp_check
from tubelet_transformer_tpu_torch.train import engine


class SumAgainMesh(mesh_lib.Mesh):
    """The control: "g" whose backward sums over the model peers again,
    as ``_AllReduceSum`` does for a data share of the loss."""

    def reduce_from_model(self, t):
        return (t if self.model == 1
                else mesh_lib.all_reduce_sum(t, self.model_group))


def _no_dropout(model) -> None:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


def _rebind(model, mesh: mesh_lib.Mesh) -> None:
    """Every split module of ``model`` (and the model) on ``mesh``."""
    for m in model.modules():
        if getattr(m, "tp", None) is not None:
            m.tp = mesh


def replicated_digest(model) -> str:
    """SHA-256 of the bytes of every replicated parameter and every buffer
    of ``model``, in order."""
    h = hashlib.sha256()
    split = sharding_rules.split_params(model)
    for k, v in model.state_dict().items():
        if k not in split:
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
    return h.hexdigest()


def peer_check(cfg: Config, model, initial: dict, batch: dict,
               mesh: mesh_lib.Mesh, steps: int = 2) -> list:
    """``steps`` train steps from ``initial``; after each, whether every
    rank's replicated parameters and buffers equal those of its model
    peers bit for bit (the same on every rank)."""
    sharding_rules.load_full_state(model, initial)
    state = engine.create_train_state(cfg, model, steps_per_epoch=10,
                                      mesh=mesh)
    step = engine.make_train_step(cfg, state, mesh=mesh)
    db = engine.device_batch(batch, next(model.parameters()).device)
    digests = []
    for _ in range(steps):
        step(db, cfg.loss.dice_cof)
        digests.append(replicated_digest(model))
    every = mesh_lib.all_gather_objects(digests)
    lead = [r - r % mesh.model for r in range(len(every))]
    return [all(every[r][s] == every[lead[r]][s] for r in range(len(every)))
            for s in range(steps)]


def model_reduces(cfg: Config, model, batch: dict, mesh: mesh_lib.Mesh
                  ) -> list:
    """(numel, dtype) of each all-reduce over the model group in one
    train step of ``model`` from its state."""
    state = engine.create_train_state(cfg, model, steps_per_epoch=10,
                                      mesh=mesh)
    step = engine.make_train_step(cfg, state, mesh=mesh)
    db = engine.device_batch(batch, next(model.parameters()).device)
    group, all_reduce, seen = mesh.model_group, dist.all_reduce, []

    def recording(t, *a, **k):
        if k.get("group") is group:
            seen.append((t.numel(), t.dtype))
        return all_reduce(t, *a, **k)

    dist.all_reduce = recording
    try:
        step(db, cfg.loss.dice_cof)
    finally:
        dist.all_reduce = all_reduce
    return seen


def timings(cfg: Config, model, batch: dict, mesh: mesh_lib.Mesh,
            steps: int) -> dict:
    """``steps`` more steps of this rank (each ended by a sync) from the
    model's state, then the model group's all-reduces of one step replayed
    at their sizes, five times: ms, with the count and the MB."""
    device = next(model.parameters()).device
    sizes = model_reduces(cfg, model, batch, mesh)
    state = engine.create_train_state(cfg, model, steps_per_epoch=10,
                                      mesh=mesh)
    step = engine.make_train_step(cfg, state, mesh=mesh)
    db = engine.device_batch(batch, device)
    step_ms = [dp_check._timed(device, lambda: step(db, cfg.loss.dice_cof))
               for _ in range(steps)]
    bufs = [torch.zeros(n, dtype=dt, device=device) for n, dt in sizes]

    def replay():
        for t in bufs:
            dist.all_reduce(t, group=mesh.model_group)

    reduce_ms = [dp_check._timed(device, replay) for _ in range(5)]
    return {"step_ms": step_ms, "model_all_reduce_ms": reduce_ms,
            "model_all_reduces": len(sizes),
            "model_all_reduce_mb": sum(t.numel() * t.element_size()
                                       for t in bufs) / 1e6}


def tp_readings(run: dict, single: dict, initial: dict) -> dict:
    """``dp_check.readings`` and ``update_rel``: the relative L2 difference
    of the updates of the parameters that have gradients."""
    names = sorted(single["grads"])

    def moved(r):
        return torch.cat([(r["state"][k].double() - initial[k].double())
                          .reshape(-1) for k in names])

    return {**dp_check.readings(run, single, initial),
            "update_rel": dp_check._rel(moved(run), moved(single))}


def run(cfg: Config, device: torch.device, seed: int = 0,
        batch_seed: int = 1, initial: Optional[dict] = None,
        batch: Optional[dict] = None, timed_steps: int = 0,
        zero1: bool = False) -> Optional[dict]:
    """The check on this rank (in a joined process group); on rank 0 the
    recorded runs, the readings, the peers' equality, every rank's
    launches and timings, None on the others. ``initial``: the one-process
    state dict (else random weights from ``seed``); ``batch``: the global
    batch (else ``dp_check.global_batch``); ``zero1`` (at MESH.DATA > 1):
    also ``dp_check.zero1_check``, every rank's result under "zero1"."""
    mesh = mesh_lib.create_mesh(cfg.mesh.data, cfg.mesh.model, cfg.mesh.pipe)
    if mesh.model == 1:
        raise ValueError("MESH.MODEL 1: no 'model' axis to check (--model)")
    cfg.mesh.data = mesh.data
    model = build_model(cfg, device=device, seed=seed, train=True, mesh=mesh)
    dp_check.log_time("tp_check: the split model built")
    _no_dropout(model)
    if initial is None:
        initial = {k: v.detach().cpu().clone() for k, v in
                   sharding_rules.gather_state(model).items()}
    b = cfg.train.batch_size
    if batch is None:
        batch = dp_check.global_batch(cfg, b * mesh.data, batch_seed)
    d = mesh.data_index
    shard = {k: v[d * b:(d + 1) * b] for k, v in batch.items()}
    out = {"tp": dp_check.one_step(cfg, model, initial, shard, mesh)}
    control = SumAgainMesh(mesh.data, mesh.rank, mesh.model)
    _rebind(model, control)
    out["control"] = dp_check.one_step(cfg, model, initial, shard, control)
    _rebind(model, mesh)
    dp_check.log_time("tp_check: the TP step and its control")
    peers = peer_check(cfg, model, initial, shard, mesh)
    dp_check.log_time("tp_check: the peers' two steps")
    if zero1 and mesh.data > 1:
        z = dp_check.zero1_check(cfg, model, initial, shard, mesh)
        print(f"tp_check rank {mesh.rank}: ZeRO-1 x MODEL moment bytes "
              f"{z['zero1_moment_bytes']} (from the shapes "
              f"{z['zero1_predicted_bytes']}) against "
              f"{z['data_moment_bytes']} in the DATA x MODEL step (from the "
              f"shapes {z['data_predicted_bytes']}); bit-equal to the DATA x "
              f"MODEL step after each step: ZeRO-1 {z['zero1_equal']}, "
              f"control {z['control_equal']}", flush=True)
        out["zero1"] = mesh_lib.all_gather_objects(z)
        dp_check.log_time("tp_check: the ZeRO-1 check")
    times = timings(cfg, model, shard, mesh, timed_steps) \
        if timed_steps else {}
    if times:
        print(f"tp_check rank {mesh.rank}: step ms "
              f"{[round(t, 2) for t in times['step_ms']]}, the model "
              f"group's {times['model_all_reduces']} all-reduces of a step "
              f"({times['model_all_reduce_mb']:.2f} MB) ms "
              f"{[round(t, 2) for t in times['model_all_reduce_ms']]}",
              flush=True)
    every = mesh_lib.all_gather_objects({
        "launches": out["tp"]["launches"], "timings": times})
    if mesh.rank:
        return None
    del model
    full = build_model(cfg, device=device, seed=seed, train=True)
    _no_dropout(full)
    out["single"] = dp_check.one_step(
        cfg, full, initial, dp_check.microbatch_major(
            batch, mesh.data, max(1, cfg.train.accum_steps)),
        mesh_lib.Mesh())
    dp_check.log_time("tp_check: the one-process step")
    out["readings"] = {k: tp_readings(out[k], out["single"], initial)
                       for k in ("tp", "control")}
    out["peers_equal"] = peers
    out["launches"] = [e["launches"] for e in every]
    out["timings"] = [e["timings"] for e in every]
    out["mesh"] = (mesh.data, mesh.model)
    out["split"] = [k for k, s in sharding_rules.param_shardings(
        full, mesh).items() if s]
    return out


def summary(out: dict) -> dict:
    """What the smoke reads of ``run``'s result: no tensors."""
    return {**{k: out[k] for k in ("readings", "peers_equal", "launches",
                                   "timings", "mesh", "zero1") if k in out},
            "n_split": len(out["split"]),
            **{k: {n: out[k][n] for n in ("metrics", "all_reduces")}
               for k in ("tp", "control", "single")}}


def main(argv: Optional[list] = None, keep_group: bool = False) -> None:
    """The command line (``argv``, else ``sys.argv``); with
    ``keep_group`` the process group stays joined for the next tool of
    the launch (``tools/mesh_checks.py``)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--data", type=int, default=None,
                   help="MESH.DATA (default: the config's)")
    p.add_argument("--model", type=int, default=None,
                   help="MESH.MODEL (default: the config's)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:<LOCAL_RANK>)")
    p.add_argument("--dist-backend", default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random initial weights")
    p.add_argument("--batch-seed", type=int, default=1)
    p.add_argument("--deterministic", action="store_true",
                   help="torch.use_deterministic_algorithms(True)")
    p.add_argument("--dtypes", default="float32",
                   help="compute dtypes to check, comma-separated "
                        "(float32 with TF32 off)")
    p.add_argument("--moe", action="store_true",
                   help="also the check with MoE encoder FFNs (float32 "
                        "when among --dtypes)")
    p.add_argument("--timed-steps", type=int, default=0)
    p.add_argument("--zero1", action="store_true",
                   help="also ZeRO-1 against the DATA x MODEL step (at "
                        "--data > 1)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.deterministic:
        # cuBLAS reads this when its first handle is made
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    from tubelet_transformer_tpu_torch.config import load_config

    device = (torch.device(args.device) if args.device
              else mesh_lib.default_device())
    cfg = load_config(args.config_file)
    if args.data is not None:
        cfg.mesh.data = args.data
    if args.model is not None:
        cfg.mesh.model = args.model
    dtypes = args.dtypes.split(",")
    if "float32" in dtypes:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cases: Dict[str, Config] = {}
    for dt in dtypes:
        cases[dt] = copy.deepcopy(cfg)
        cases[dt].model.compute_dtype = dt
    if args.moe:
        moe = cases["moe"] = copy.deepcopy(
            cases["float32" if "float32" in dtypes else dtypes[0]])
        for k, v in dp_check.MOE.items():
            setattr(moe.model, k, v)
    dp_check.log_time("tp_check: imports")
    mesh_lib.init_distributed(device, args.dist_backend)
    dp_check.log_time("tp_check: the process group joined")
    try:
        result = {}
        for name, c in cases.items():
            t0 = time.perf_counter()
            out = run(c, device, args.seed, args.batch_seed,
                      timed_steps=args.timed_steps if name == dtypes[0]
                      else 0, zero1=args.zero1)
            if out is not None:
                result[name] = summary(out)
                result[name]["wall_s"] = time.perf_counter() - t0
                print(f"tp_check {name}: readings {out['readings']}; model "
                      f"peers bit-equal after each step "
                      f"{out['peers_equal']}; launches per rank "
                      f"{out['launches']}", flush=True)
            del out
        if mesh_lib.is_main_process():
            torch.save(result, args.out)
    finally:
        if not keep_group:
            mesh_lib.shutdown()


if __name__ == "__main__":
    main()
