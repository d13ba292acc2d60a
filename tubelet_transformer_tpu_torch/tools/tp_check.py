"""One tensor-parallel train step (``MESH.MODEL``), or one pipelined
step (``MESH.PIPE``), held against the single-process step on the same
global batch from the same state, and against controls that break one
hand-off each.

Run under torchrun, one process per rank (ranks on one card over gloo,
which carries ``all_reduce`` and ``all_gather_into_tensor`` of CUDA
tensors; NCCL needs a card per rank):

  python -m torch.distributed.run --nproc_per_node 2 \\
      -m tubelet_transformer_tpu_torch.tools.tp_check \\
      --config-file configuration/tuber_csn152_ava22.yaml --model 2 \\
      --device cuda:0 --dist-backend gloo --deterministic \\
      --dtypes float32,bfloat16 --moe --out build/tp_check.pt

The mesh is ``--data`` x ``--model`` x ``--pipe`` (the config's
MESH.DATA, MESH.MODEL and MESH.PIPE by default; ranks = their product).
Every rank builds the train model from ``--seed`` with every dropout off,
split over the 'model' axis and holding its pipe stage's encoder layers
(``build_model(..., mesh=mesh)``), and takes its data shard (rows d*b ..
d*b + b - 1 for data index d) of a global batch of MESH.DATA x
TRAIN.BATCH_SIZE float clips made from ``--batch-seed``. From one
state it runs:

* ``tp``: the train step on the mesh;
* ``control``: the same step with "g" (``Mesh.reduce_from_model``) in
  ``parallel.mesh._AllReduceSum``'s form, whose backward sums the
  gradient over the model peers again: each split region then passes on
  ``model`` times its gradient. Its forward, and so its losses and batch
  statistics, are the step's own: the gradient readings tell it apart.
  Where an attention splits by rows (the axis not dividing its heads)
  ``gather_again`` does the same to its "gather"
  (``Mesh.gather_from_model``); each runs where its hand-off does;
* ``peers``: after the step and after one more from its state, a digest
  of every replicated parameter and every buffer of each rank, which must
  equal its model peers' (``peers_agree``, also after each control);
* ``single`` (the reporter alone, ``reporter``: rank 0, or under PIPE
  the last stage of data shard 0): the one-process step of the full
  model on the whole batch.

Every rank also reports the bytes of its ``in_proj_weight`` slices,
beside one process's (a third each at MODEL 3, whatever the heads).

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

``--spatial`` (MESH.SPATIAL): the step on the mesh splits the clip's rows
over the model peers through the trunk, and its two controls take the
place of "g"'s: ``zero_halo``, every halo row a zero row (no exchange),
and ``no_trunk_sum``, the trunk's gradients left as each peer's share
over its rows. On the card each rank also reports its peak device memory
above the start of a spatial step (``tp``) and of the
MODEL-only step (the same model on the whole clip). With
``--eval-stages`` each rank then runs the eval step of the eval build
with MODEL.PALLAS_KERNELS and FUSED_STAGES (the stage path) on its data
shard, under the mesh and under the zero-halo control, with the stem,
depthwise and chain launches of each, and the reporter the one-process
eval step on the whole batch: the largest differences of scores, actor
probabilities and boxes (over the clip's side) of its rows.

``--pipe`` P (MESH.PIPE; beside ``--spatial`` too, with both axes'
controls): the encoder's
layers run as P GPipe stages of MESH.PIPE_MICROBATCHES microbatches, and
the controls are ``zero_carry``, every stage-to-stage carry zeroed (the
later stages see zeros, and the losses part), and ``no_input_sum``, the
encoder input's gradient left as each stage's own, not summed over the
pipe group (the stages after the first get no gradient through the
encoder into the backbone). The reporter is the last stage: the
replicated parameters' gradients there are the ones the input's sum
reaches last. Every rank also reports the bytes of its encoder
parameters and of their AdamW moments from the tensors (beside one
process's), with ``--timed-steps`` the GPipe bubble (P - 1) / (M + P - 1)
beside its step ms, and with ``--eval-stages`` the stage path's eval
forward under the mesh.

``--floors``: the rank after the reporter (``floor_rank``) runs
``floors`` meanwhile and hands them to the reporter, which reads them as
the one-process step's own spread beside which every reading stands: the
one-process step on the batch's samples in the other order (the same
sums rounded in another order), and for bf16 the one-process step in
float32.

``--zero1`` (with ``--data`` above 1): each case also runs
``dp_check.zero1_check`` on the mesh, from the same state and on the same
shard: two steps of the DATA x MODEL step, of the same step with
``MESH.ZERO1`` (the moments of the replicated parameters sharded over the
data group, the split ones the model peer's slices, a pipe stage's
encoder layers' its own) and of the ZeRO-1 control without the
all-gather; on every rank whether the model's and the optimizer's state
dicts equal the DATA x MODEL (or DATA x PIPE) step's bit for bit after
each step, and this rank's moment bytes from the tensors beside the
figure from the shapes.

The readings sum in float64 on the check's device.
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
import torch.nn.functional as F

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


class GatherAgainMesh(mesh_lib.Mesh):
    """The control of an attention split by rows (its heads not divided by
    the axis): "gather" whose backward sums the gathered gradient over the
    model peers again before it keeps this peer's columns, so that each
    peer's block of the projection passes on ``model`` times its
    gradient."""

    def gather_from_model(self, t, widths):
        return self.copy_to_model(super().gather_from_model(t, widths))


class ZeroHaloMesh(mesh_lib.Mesh):
    """The spatial control: zero rows in place of the neighbours' halo
    rows, nothing exchanged."""

    def halo_exchange(self, x, top, bottom, bands):
        if not self.spatial:
            return x
        a, h = bands.rows[self.model_index]
        return F.pad(x, (0, 0, 0, 0, min(top, a),
                         min(bottom, bands.height - a - h)))


class NoTrunkSumMesh(mesh_lib.Mesh):
    """The spatial control: the trunk's gradients left as each peer's
    share over its own rows, not summed over the model group."""

    def trunk_sum(self, grads):
        return None


class ZeroCarryMesh(mesh_lib.Mesh):
    """The pipeline's control: every stage-to-stage carry zeroed, nothing
    handed on."""

    def pipe_carry(self, x):
        return torch.zeros_like(x)


class NoInputSumMesh(mesh_lib.Mesh):
    """The pipeline's control: the encoder's inputs without "f", their
    gradients each stage's own."""

    def copy_to_pipe(self, t):
        return t


# the controls of a check, by the axis it holds (``axis``)
CONTROLS = {"model": {"control": SumAgainMesh,
                      "gather_again": GatherAgainMesh},
            "spatial": {"zero_halo": ZeroHaloMesh,
                        "no_trunk_sum": NoTrunkSumMesh},
            "pipe": {"zero_carry": ZeroCarryMesh,
                     "no_input_sum": NoInputSumMesh}}


def axes(mesh: mesh_lib.Mesh) -> tuple:
    """The axes that the check on ``mesh`` holds: the split rows and the
    pipe where it has them, else the 'model' axis."""
    held = (("spatial",) if mesh.spatial else ()) + (
        ("pipe",) if mesh.pipe > 1 else ())
    return held or ("model",)


def controls(mesh: mesh_lib.Mesh, model) -> dict:
    """The controls of the check of ``model`` on ``mesh``, by name, each on
    a mesh of its class in the same place; on the 'model' axis those of
    the hand-offs that ``model``'s split runs: "g" where a row-parallel
    weight splits, "gather" where an attention splits by rows."""
    split = sharding_rules.split_params(model)
    runs = {"control": any(k.endswith(("out_proj.weight", "linear2.weight",
                                       "expert_w1")) for k in split),
            "gather_again": any(s.groups == 1 and k.endswith(
                "in_proj_weight") for k, s in split.items())}
    return {k: c(mesh.data, mesh.rank, mesh.model, mesh.spatial, mesh.pipe)
            for a in axes(mesh) for k, c in CONTROLS[a].items()
            if runs.get(k, True)}


def reporter(mesh: mesh_lib.Mesh) -> int:
    """The rank that runs the one-process step and reads the check: the
    last pipe stage of data shard 0 (rank 0 without a 'pipe' axis)."""
    return mesh.pipe - 1


def one_process(cfg: Config) -> Config:
    """``cfg`` for the one-process model: no 'model' or 'pipe' axis."""
    c = copy.deepcopy(cfg)
    c.mesh.data = c.mesh.model = c.mesh.pipe = 1
    c.mesh.zero1 = False
    return c


def _no_dropout(model) -> None:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


def _rebind(model, mesh: mesh_lib.Mesh) -> None:
    """Every split module of ``model`` (and the model) on ``mesh``, the
    split of the clip's rows where the model has one, and its pipelined
    encoder where it has one."""
    for m in model.modules():
        if getattr(m, "tp", None) is not None:
            m.tp = mesh
    if getattr(model, "spatial", None) is not None:
        model.set_spatial(mesh)
    if model.transformer.pipe is not None:
        model.transformer.pipe = mesh


def replicated_digest(model) -> str:
    """SHA-256 of the bytes of every replicated parameter and every buffer
    of ``model``, in order (a pipe stage's encoder layers left out)."""
    h = hashlib.sha256()
    split = sharding_rules.split_params(model)
    staged = model.transformer.pipe is not None
    for k, v in model.state_dict().items():
        if k not in split and not (staged and sharding_rules.stage_held(k)):
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
    return h.hexdigest()


def peers_agree(model, mesh: mesh_lib.Mesh) -> bool:
    """Whether every rank's replicated parameters and buffers equal those
    of the other ranks of its data shard (its model and pipe peers) bit
    for bit now (the same on every rank)."""
    every = mesh_lib.all_gather_objects(replicated_digest(model))
    n = mesh.model * mesh.pipe
    return all(d == every[r - r % n] for r, d in enumerate(every))


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
    model's state: ms; with a 'model' axis then the model group's
    all-reduces of one step replayed at their sizes, five times: ms, with
    the count and the MB; with a 'pipe' axis the GPipe bubble
    (P - 1) / (M + P - 1)."""
    device = next(model.parameters()).device
    sizes = model_reduces(cfg, model, batch, mesh) if mesh.model > 1 else ()
    state = engine.create_train_state(cfg, model, steps_per_epoch=10,
                                      mesh=mesh)
    step = engine.make_train_step(cfg, state, mesh=mesh)
    db = engine.device_batch(batch, device)
    out = {"step_ms": [dp_check._timed(device, lambda: step(
        db, cfg.loss.dice_cof)) for _ in range(steps)]}
    if sizes:
        bufs = [torch.zeros(n, dtype=dt, device=device) for n, dt in sizes]

        def replay():
            for t in bufs:
                dist.all_reduce(t, group=mesh.model_group)

        out.update(model_all_reduce_ms=[dp_check._timed(device, replay)
                                        for _ in range(5)],
                   model_all_reduces=len(sizes),
                   model_all_reduce_mb=sum(t.numel() * t.element_size()
                                           for t in bufs) / 1e6)
    if mesh.pipe > 1:
        m = cfg.mesh.pipe_microbatches
        out["bubble"] = (mesh.pipe - 1) / (m + mesh.pipe - 1)
    return out


def encoder_bytes(model, optimizer=None) -> dict:
    """The bytes of ``model``'s encoder layers (this stage's) and of their
    AdamW moments in ``optimizer``, read from the tensors."""
    params = {id(p): p for k, p in model.named_parameters()
              if sharding_rules.stage_held(k)}
    out = {"params": sum(p.numel() * p.element_size()
                         for p in params.values())}
    if optimizer is not None:
        opt = getattr(optimizer, "inner", optimizer)
        out["moments"] = sum(
            v.numel() * v.element_size() for p, st in opt.state.items()
            if id(p) in params for k, v in st.items()
            if k in ("exp_avg", "exp_avg_sq"))
    return out


def in_proj_bytes(model) -> int:
    """The bytes of ``model``'s packed attention projections
    (``in_proj_weight``, this peer's slices where split), read from the
    tensors."""
    return sum(p.numel() * p.element_size() for k, p in
               model.named_parameters() if k.endswith("in_proj_weight"))


def model_only_peak(cfg: Config, model, initial: dict, batch: dict,
                    mesh: mesh_lib.Mesh) -> Optional[int]:
    """On the card, this rank's peak device memory (bytes) above the start
    of one train step from ``initial`` on ``mesh`` with the rows whole (the
    MODEL-only step: the model's split of the rows lifted for it); None on
    the CPU."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        return None
    whole = mesh_lib.Mesh(mesh.data, mesh.rank, mesh.model, pipe=mesh.pipe)
    model.set_spatial(None)
    try:
        sharding_rules.load_full_state(model, initial)
        state = engine.create_train_state(cfg, model, steps_per_epoch=10,
                                          mesh=whole)
        step = engine.make_train_step(cfg, state, mesh=whole)
        db = engine.device_batch(batch, device)
        return dp_check.peak_above_start(
            device, lambda: step(db, cfg.loss.dice_cof))
    finally:
        model.set_spatial(mesh)


def eval_launches() -> dict:
    """The launches so far of the kernels of the stage path's eval
    forward: the pooled stem, the depthwise and the stage chain."""
    from tubelet_transformer_tpu_torch.ops.cuda import depthwise, stage, stem

    return {"stem_pool": stem.LAUNCHES, "depthwise": depthwise.LAUNCHES,
            "chain": stage.LAUNCHES}


@torch.inference_mode()
def eval_forward(model, batch: dict, mesh: mesh_lib.Mesh) -> dict:
    """The eval forward of ``model`` on ``batch`` (on its device), as the
    eval step runs it (the whole clip preprocessed, this peer's rows
    kept): its class and actor probabilities and its boxes, on the
    CPU."""
    clips = engine.keep_rows(engine.device_preprocess(
        batch["clips"], dtype=model.dtype, pad_mask=batch["pad_mask"]), mesh)
    out = model(clips, batch["pad_mask"])
    return {"scores": out["pred_logits"].float().sigmoid().cpu(),
            "actor_prob": out["pred_logits_b"].float().softmax(-1).cpu(),
            "boxes": out["pred_boxes"].float().cpu()}


def eval_check(cfg: Config, device: torch.device, seed: int, batch: dict,
               mesh: mesh_lib.Mesh) -> dict:
    """The stage path's eval forward (MODEL.PALLAS_KERNELS and
    FUSED_STAGES on ``cfg``'s eval build) on this rank's data shard of
    ``batch``, under ``mesh`` ("mesh") and, with the rows split, under its
    zero-halo control: each one's outputs and kernel launches; on the
    reporter (of data shard 0) also the one-process forward of the full
    model on the whole batch and the largest absolute difference of each
    output of its rows from it."""
    c = copy.deepcopy(cfg)
    c.model.pallas_kernels = c.model.fused_stages = True
    b = c.train.batch_size
    d = mesh.data_index
    db = engine.device_batch({k: v[d * b:(d + 1) * b] for k, v in
                              batch.items()}, device)
    model = build_model(c, device=device, seed=seed, mesh=mesh)
    runs = {"mesh": mesh}
    if mesh.spatial:
        runs["zero_halo"] = ZeroHaloMesh(mesh.data, mesh.rank, mesh.model,
                                         mesh.spatial, mesh.pipe)
    out = {}
    for name, m in runs.items():
        _rebind(model, m)
        before = eval_launches()
        got = eval_forward(model, db, m)
        after = eval_launches()
        out[name] = {"outputs": got,
                     "launches": {k: after[k] - before[k] for k in after}}
    del model
    if mesh.rank != reporter(mesh):
        return out
    full = build_model(one_process(c), device=device, seed=seed)
    want = eval_forward(full, engine.device_batch(batch, device),
                        mesh_lib.Mesh())
    out["differences"] = {
        k: {n: float((out[k]["outputs"][n] - want[n][:b]).abs().max())
            for n in want} for k in runs}
    return out


def tp_readings(run: dict, single: dict, initial: dict,
                device: Optional[torch.device] = None,
                ref: Optional[dp_check.Reference] = None) -> dict:
    """``dp_check.readings``, ``update_rel``: the relative L2 difference of
    the updates of the parameters that have gradients, and
    ``trunk_grads_rel``: that of the trunk's gradients alone (those that
    MESH.SPATIAL sums over the model group), where it has some; summed in
    float64 on ``device``; ``ref``: the ``dp_check.Reference`` of
    ``single`` and ``initial`` that the check's readings share."""
    names = sorted(single["grads"])
    trunk = [k for k in names if sharding_rules.spatial_partial(k)]
    ref = ref or dp_check.Reference(single, initial, device)
    start = ref.flat("initial", names)
    return {**dp_check.readings(run, single, initial, device, ref),
            "update_rel": dp_check._rel(
                dp_check.flat(run["state"], names, device) - start,
                ref.flat("state", names) - start),
            **({"trunk_grads_rel": dp_check._rel(
                dp_check.flat(run["grads"], trunk, device),
                ref.flat("grads", trunk))} if trunk else {})}


def floor_rank(mesh: mesh_lib.Mesh) -> int:
    """The rank that runs ``floors`` while the reporter runs the
    one-process step: the one after it."""
    return (reporter(mesh) + 1) % (mesh.data * mesh.model * mesh.pipe)


def floors(cfg: Config, device: torch.device, seed: int, initial: dict,
           batch: dict, mesh: mesh_lib.Mesh) -> dict:
    """The one-process runs that show its own spread, beside which the
    readings of a step on the mesh stand (``tp_readings`` against the
    one-process step): ``reversed``, the one-process step on the batch's
    samples in the other order (the same sums, rounded in another order),
    and for a bf16 ``cfg`` ``float32``, the one-process step in float32
    (TF32 off)."""
    accum = max(1, cfg.train.accum_steps)

    def one(c: Config, b: dict) -> dict:
        model = build_model(c, device=device, seed=seed, train=True)
        _no_dropout(model)
        return dp_check.one_step(c, model, initial, dp_check.microbatch_major(
            b, mesh.data, accum), mesh_lib.Mesh())

    runs = {"reversed": one(cfg, {k: v[::-1].copy()
                                  for k, v in batch.items()})}
    if cfg.model.compute_dtype == "bfloat16":
        c = copy.deepcopy(cfg)
        c.model.compute_dtype = "float32"
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            runs["float32"] = one(c, batch)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
    return runs


def run(cfg: Config, device: torch.device, seed: int = 0,
        batch_seed: int = 1, initial: Optional[dict] = None,
        batch: Optional[dict] = None, timed_steps: int = 0,
        zero1: bool = False, eval_stages: bool = False,
        with_floors: bool = False) -> Optional[dict]:
    """The check on this rank (in a joined process group); on the
    reporter the recorded runs (its own), the readings, the peers'
    equality, every rank's launches and timings, None on the others.
    ``initial``: the one-process state dict (else random weights from
    ``seed``); ``batch``: the global batch (else
    ``dp_check.global_batch``, its clips on the loaders' canvas,
    ``engine.clip_canvas``); ``zero1`` (at MESH.DATA > 1): also
    ``dp_check.zero1_check``, every rank's result under "zero1". With
    MESH.SPATIAL in ``cfg`` the rows split (``controls``) and every rank's
    peak memory of a spatial step (``tp``) and of the
    MODEL-only step (``model_only_peak``) goes under "memory"; with
    MESH.PIPE every rank's ``encoder_bytes`` under "encoder_bytes";
    ``eval_stages`` (with SPATIAL or PIPE): every rank's ``eval_check``
    under "eval"; ``with_floors``: ``floors`` under "floors"."""
    mesh = mesh_lib.create_mesh(cfg.mesh.data, cfg.mesh.model, cfg.mesh.pipe,
                                cfg.mesh.spatial)
    if mesh.model == 1 and mesh.pipe == 1:
        raise ValueError("MESH.MODEL and MESH.PIPE 1: no 'model' or 'pipe' "
                         "axis to check (--model, --pipe)")
    cfg.mesh.data = mesh.data
    single_cfg = one_process(cfg)
    model = build_model(cfg, device=device, seed=seed, train=True, mesh=mesh)
    dp_check.log_time("tp_check: the split model built")
    _no_dropout(model)
    if initial is None:
        initial = {k: v.detach().cpu().clone() for k, v in
                   sharding_rules.gather_state(model).items()}
    b = cfg.train.batch_size
    if batch is None:
        batch = dp_check.global_batch(cfg, b * mesh.data, batch_seed,
                                      hw=engine.clip_canvas(cfg))
    d = mesh.data_index
    shard = {k: v[d * b:(d + 1) * b] for k, v in batch.items()}
    keep = mesh.rank == reporter(mesh)
    peak: list = []
    peers: list = []
    mine = {"in_proj_bytes": in_proj_bytes(model)}

    def second(step, state):
        # the peers after the step, then after one more from its state
        peers.append(peers_agree(model, mesh))
        step()
        peers.append(peers_agree(model, mesh))
        if mesh.pipe > 1:
            mine["encoder_bytes"] = encoder_bytes(model, state.optimizer)

    out = {"tp": dp_check.one_step(cfg, model, initial, shard, mesh,
                                   keep=keep, peak=peak, then=second)}
    agree = {"tp": peers[0]}
    mine["launches"] = out["tp"]["launches"]
    dp_check.log_time("tp_check: the step and the peers' second step")
    checks = controls(mesh, model)
    for name, control in checks.items():
        _rebind(model, control)
        out[name] = dp_check.one_step(cfg, model, initial, shard, control,
                                      keep=keep)
        agree[name] = peers_agree(model, mesh)
    _rebind(model, mesh)
    dp_check.log_time(f"tp_check: the controls {list(checks)}")
    if mesh.spatial:
        mine["memory"] = {"spatial": peak[0], "model_only": model_only_peak(
            cfg, model, initial, shard, mesh)}
    if zero1 and mesh.data > 1:
        z = dp_check.zero1_check(cfg, model, initial, shard, mesh)
        print(f"tp_check rank {mesh.rank}: ZeRO-1 moment bytes "
              f"{z['zero1_moment_bytes']} (from the shapes "
              f"{z['zero1_predicted_bytes']}) against "
              f"{z['data_moment_bytes']} in the step without it (from the "
              f"shapes {z['data_predicted_bytes']}); bit-equal to that step "
              f"after each step: ZeRO-1 {z['zero1_equal']}, control "
              f"{z['control_equal']}", flush=True)
        out["zero1"] = mesh_lib.all_gather_objects(z)
        dp_check.log_time("tp_check: the ZeRO-1 check")
    mine["timings"] = {}
    if timed_steps:
        mine["timings"] = timings(cfg, model, shard, mesh, timed_steps)
        print(f"tp_check rank {mesh.rank}: timings {mine['timings']}",
              flush=True)
    del model
    ev = {}
    if eval_stages and (mesh.spatial or mesh.pipe > 1):
        ev = eval_check(cfg, device, seed, batch, mesh)
        mine["eval"] = {n: v["launches"] for n, v in ev.items()
                        if n != "differences"}
        dp_check.log_time("tp_check: the stage path's eval step")
    every = mesh_lib.all_gather_objects(mine)
    if with_floors and mesh.rank == floor_rank(mesh):
        dist.send_object_list([floors(single_cfg, device, seed, initial,
                                      batch, mesh)], reporter(mesh))
        dp_check.log_time("tp_check: the one-process step's floors",
                          any_rank=True)
    if mesh.rank != reporter(mesh):
        return None
    out.update(peers_equal=peers, peers_agree=agree,
               mesh=(mesh.data, mesh.model, mesh.pipe), spatial=mesh.spatial,
               controls=list(checks),
               **{k: [e[k] for e in every] for k in mine})
    if ev:
        out["eval"] = {"differences": ev["differences"],
                       "launches": out["eval"]}
    full = build_model(single_cfg, device=device, seed=seed, train=True)
    _no_dropout(full)
    out["single"] = dp_check.one_step(
        single_cfg, full, initial, dp_check.microbatch_major(
            batch, mesh.data, max(1, cfg.train.accum_steps)),
        mesh_lib.Mesh())
    dp_check.log_time("tp_check: the one-process step", any_rank=True)
    ref = dp_check.Reference(out["single"], initial, device)
    out["readings"] = {k: tp_readings(out[k], out["single"], initial,
                                      device, ref) for k in ("tp", *checks)}
    dp_check.log_time("tp_check: the readings", any_rank=True)
    out["one_process_in_proj_bytes"] = in_proj_bytes(full)
    if mesh.pipe > 1:
        one = encoder_bytes(full)["params"]
        out["one_process_encoder_bytes"] = {"params": one,
                                            "moments": 2 * one}
    if with_floors:
        runs = [None]
        dist.recv_object_list(runs, floor_rank(mesh))
        out["floors"] = {k: tp_readings(r, out["single"], initial, device,
                                        ref)
                         for k, r in runs[0].items()}
        dp_check.log_time("tp_check: the floors' readings", any_rank=True)
    out["split"] = [k for k, s in sharding_rules.param_shardings(
        full, mesh).items() if s]
    return out


def summary(out: dict) -> dict:
    """What the smoke reads of ``run``'s result: no tensors."""
    return {**{k: out[k] for k in ("readings", "peers_equal", "peers_agree",
                                   "launches", "timings", "mesh", "zero1",
                                   "spatial", "controls", "memory", "eval",
                                   "floors", "encoder_bytes",
                                   "one_process_encoder_bytes",
                                   "in_proj_bytes",
                                   "one_process_in_proj_bytes")
               if k in out},
            "n_split": len(out["split"]),
            **{k: {n: out[k][n] for n in ("metrics", "all_reduces")}
               for k in ("tp", *out["controls"], "single")}}


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
    p.add_argument("--pipe", type=int, default=None,
                   help="MESH.PIPE (default: the config's)")
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
                   help="also ZeRO-1 against the step on the mesh (at "
                        "--data > 1)")
    p.add_argument("--spatial", action="store_true",
                   help="MESH.SPATIAL: the model peers split the clip's "
                        "rows (its controls, each rank's peak memory)")
    p.add_argument("--eval-stages", action="store_true",
                   help="with --spatial or --pipe, also the stage path's "
                        "eval step against one process")
    p.add_argument("--floors", action="store_true",
                   help="also the one-process step's own spread: on the "
                        "batch reversed, and for bf16 in float32")
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
    for name in ("data", "model", "pipe"):
        if getattr(args, name) is not None:
            setattr(cfg.mesh, name, getattr(args, name))
    cfg.mesh.spatial = cfg.mesh.spatial or args.spatial
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
                      else 0, zero1=args.zero1,
                      eval_stages=args.eval_stages and name == dtypes[0],
                      with_floors=args.floors)
            if out is not None:
                result[name] = summary(out)
                result[name]["wall_s"] = time.perf_counter() - t0
                print(f"tp_check {name}: readings {out['readings']}; peers "
                      f"bit-equal after each step {out['peers_equal']}; "
                      f"launches per rank {out['launches']}; peak memory "
                      f"per rank {out.get('memory')}; encoder bytes per "
                      f"rank {out.get('encoder_bytes')} (one process "
                      f"{out.get('one_process_encoder_bytes')}); eval "
                      f"{out.get('eval')}; floors {out.get('floors')}",
                      flush=True)
            del out
        if result:
            torch.save(result, args.out)
            dp_check.log_time("tp_check: the result written", any_rank=True)
    finally:
        if not keep_group:
            mesh_lib.shutdown()


if __name__ == "__main__":
    main()
