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

More checks join the same launch:

* ``--zero1``: two consecutive steps from one state of the DATA-only DP
  step, of the ZeRO-1 DP step (``MESH.ZERO1``, ``parallel/zero.py``) and
  of a control that leaves out ZeRO-1's all-gather (each rank keeps stale
  copies of the slices it does not own); after each step every rank holds
  the state dict and the (gathered) optimizer state dict of each run
  against the DATA-only run's, bit for bit, and reports the bytes of its
  moments from the tensors beside the figure from the shapes, and with
  ``--timed-steps`` the ZeRO-1 step's ms and the all-gather's ms and MB;
* ``--moe``: the three steps again with ``MODEL.MOE_EXPERTS 4`` and
  ``MOE_TOP_K 2`` (the load-balance loss read as ``loss_moe_aux``);
* ``--classifier``: the classifier's DP step (``train/classify.py``,
  CSN-152, 400 classes, 2 float32 clips of 32 x 224 x 224 a rank)
  against the one-process step on the 4, with ``LocalMesh`` as the
  control: the loss, the gradients and the running statistics.

In bf16 the flagship model at random init parts from itself by as much as
the control does in the gradients once the batch is split otherwise (the
cause is not isolated: the kernels picked for 2 and for 4 clips round
otherwise, and a matching near a tie can flip): ``--float32`` (float32
compute, TF32 off) is the setting where every reading tells the DP step
from the control.
"""

from __future__ import annotations

import argparse
import copy
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
from tubelet_transformer_tpu_torch.parallel import sharding_rules, zero
from tubelet_transformer_tpu_torch.train import engine
from tubelet_transformer_tpu_torch.train.optimizer import trainable_params

# the MoE of --moe, as the smoke's MoE phase runs it
MOE = {"moe_experts": 4, "moe_top_k": 2}
# the classifier of --classifier: phase 18's CSN-152 at 32 x 224 x 224
CLASSIFIER = {"backbone": "CSN-152", "classes": 400, "clip": (32, 224, 224)}


class LocalMesh(mesh_lib.Mesh):
    """The control: BN statistics and loss normalisers of the rank's own
    shard, the ranks' losses and gradients averaged."""

    def batch_mean(self, t, count=1):
        return t

    def count_sum(self, t):
        return t

    def share_sum(self, t):
        return mesh_lib.all_reduce_sum(t) / self.data


def global_batch(cfg: Config, n: int, seed: int,
                 boxless_from: Optional[int] = None,
                 hw: Optional[tuple] = None) -> Dict[str, np.ndarray]:
    """``n`` samples of float clips and random targets for ``cfg``'s mode
    (AVA multi-hot labels, or JHMDB/UCF class ids with the key frame's
    position and visibility); the rows from ``boxless_from`` on hold no
    box. The clips are IMG_SIZE square, or ``hw`` (H, W)."""
    rng = np.random.default_rng(seed)
    m, c, s = cfg.data.max_boxes, cfg.data.num_classes, cfg.data.img_size
    h, w = hw or (s, s)
    t = cfg.data.temp_len
    n_valid = rng.integers(1, m + 1, n)
    if boxless_from is not None:
        n_valid[boxless_from:] = 0
    valid = np.arange(m)[None] < n_valid[:, None]
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (n, m, 2)),
                            rng.uniform(0.1, 0.3, (n, m, 2))], -1)
    batch = {"clips": rng.normal(size=(n, t, h, w, 3)).astype(np.float32),
             "pad_mask": np.zeros((n, h, w), bool),
             "boxes": boxes.astype(np.float32), "valid": valid,
             "sizes": np.tile(np.float32([h, w]), (n, 1))}
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


def peak_above_start(device: torch.device, fn) -> Optional[int]:
    """``fn()``; on the card, the peak device memory (bytes) above what was
    allocated when it started; None on the CPU."""
    if device.type != "cuda":
        fn()
        return None
    torch.cuda.synchronize(device)
    start = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - start


def one_step(cfg: Config, model, initial: dict, batch: dict,
             mesh: mesh_lib.Mesh, keep: bool = True,
             peak: Optional[list] = None, then=None) -> dict:
    """One train step of ``model`` from ``initial`` (its one-process state
    dict, a fresh optimizer) on ``batch`` (numpy) with ``mesh``: the
    metrics, the clipped gradients, the state after (both gathered to the
    one-process layout when the model is split over a 'model' axis; on
    the host, and with ``keep`` False left out, the gathers still run),
    the stem statistics the BN affine received, the stem kernels' launches
    (statistics, pooled) and the step's all-reduces. ``peak``: a list that
    gets the step's ``peak_above_start``; ``then``: called, once the
    record is taken, with a function that runs one more step from the
    state after this one, and that state."""
    sharding_rules.load_full_state(model, initial)
    state = engine.create_train_state(cfg, model, steps_per_epoch=10,
                                      mesh=mesh)
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
    got: dict = {}
    try:
        bytes_ = peak_above_start(device, lambda: got.update(
            metrics=step(db, cfg.loss.dice_cof)))
    finally:
        del bn1.batch_affine
        torch.distributed.all_reduce = all_reduce
    if peak is not None:
        peak.append(bytes_)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    after = _stem_launches()
    grads = sharding_rules.gather_tensors(model, {
        n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    full = sharding_rules.gather_state(model)
    out = {"metrics": {k: float(v) for k, v in got["metrics"].items()},
           "grads": {n: g.detach().cpu().clone() for n, g in grads.items()}
           if keep else {},
           "state": {k: v.detach().cpu().clone() for k, v in full.items()}
           if keep else {},
           "stem_stats": [(m.cpu(), v.cpu()) for m, v in stats],
           "launches": {"stem_stats": after[0] - before[0],
                        "stem_pool": after[1] - before[1]},
           "all_reduces": reduces[0]}
    del grads, full
    if then is not None:
        then(lambda: step(db, cfg.loss.dice_cof), state)
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _moved(d: dict, keys, device: Optional[torch.device]) -> torch.Tensor:
    """The tensors of ``d`` under ``keys``, in order, as one vector of
    their dtype on ``device``: one copy from the host."""
    return torch.cat([d[k].reshape(-1).to(device) for k in keys])


def flat(d: dict, keys, device: Optional[torch.device] = None
         ) -> torch.Tensor:
    """The tensors of ``d`` under ``keys``, in order, flattened into one
    float64 vector on ``device`` (the CPU by default), widened there: on
    the card a reading of the flagship's ~86M parameters takes a fraction
    of a second, on the host several."""
    return _moved(d, keys, device).double()


class Reference:
    """What every reading of a check compares with: the one-process run
    ``single`` and the ``initial`` state dict, each vector that a reading
    takes of them moved to ``device`` once and kept in its dtype."""

    def __init__(self, single: dict, initial: dict,
                 device: Optional[torch.device] = None):
        self.single, self.initial, self.device = single, initial, device
        self._kept: dict = {}

    def flat(self, which: str, keys) -> torch.Tensor:
        """``flat`` of the one-process run's "grads" or "state", or of
        "initial", under ``keys``."""
        key = (which, tuple(keys))
        if key not in self._kept:
            d = self.initial if which == "initial" else self.single[which]
            self._kept[key] = _moved(d, keys, self.device)
        return self._kept[key].double()


def readings(run: dict, single: dict, initial: dict,
             device: Optional[torch.device] = None,
             ref: Optional[Reference] = None) -> dict:
    """``run`` against ``single``: the largest relative difference of a
    loss-dict entry (and of ``loss_moe_aux`` alone with MoE), of the
    gradient norm, of the stem's mean and variance,
    and the relative L2 differences of all gradients together and of the
    running statistics' updates, summed in float64 on ``device``;
    ``ref``: the ``Reference`` of ``single`` and ``initial`` that the
    check's readings share."""
    keys = [k for k in single["metrics"] if k not in ("finite", "grad_norm")]
    names = sorted(single["grads"])
    stat_keys = [k for k in initial if k.endswith(("running_mean",
                                                   "running_var"))]
    ref = ref or Reference(single, initial, device)

    def cat(d, ks):
        return flat(d, ks, device)

    def rel(k):
        return (abs(run["metrics"][k] - single["metrics"][k])
                / max(abs(single["metrics"][k]), 1e-12))

    (m1, v1), (m2, v2) = run["stem_stats"][0], single["stem_stats"][0]
    # with MoE, the load-balance loss apart from the rest
    moe = ({"moe_aux_rel": rel("loss_moe_aux")}
           if "loss_moe_aux" in single["metrics"] else {})
    return {
        **moe,
        "loss_rel": max(rel(k) for k in keys),
        "grad_norm_rel": rel("grad_norm"),
        "grads_rel": _rel(cat(run["grads"], names),
                          ref.flat("grads", names)),
        "running_update_rel": _rel(
            cat(run["state"], stat_keys) - ref.flat("initial", stat_keys),
            ref.flat("state", stat_keys) - ref.flat("initial", stat_keys)),
        "stem_mean_rel": _rel(m1, m2), "stem_var_rel": _rel(v1, v2),
    }


def since_start() -> float:
    """Seconds since this process started (Linux's /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except OSError:
        return 0.0
    return up - start / os.sysconf("SC_CLK_TCK")


def log_time(what: str, any_rank: bool = False) -> None:
    """Rank 0's "[time]" line: ``what`` at this many seconds since the
    process started (imports, the process group, each build and check);
    with ``any_rank`` this rank's, named (a step that one rank runs)."""
    env = mesh_lib.launch_env()
    rank = env[0] if env else 0
    if rank == 0 or any_rank:
        who = f" (rank {rank})" if rank else ""
        print(f"[time] {what}{who}: {since_start():.1f} s since the process "
              "started", flush=True)


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
    state = engine.create_train_state(cfg, model, steps_per_epoch=10,
                                      mesh=mesh)
    step = engine.make_train_step(cfg, state, mesh=mesh)
    db = engine.device_batch(batch, device)
    step_ms = [_timed(device, lambda: step(db, cfg.loss.dice_cof))
               for _ in range(steps)]
    params = trainable_params(state.optimizer)
    reduce_ms = [_timed(device, lambda: engine.sync_gradients(params, mesh))
                 for _ in range(5)]
    n = sum(p.grad.numel() for p in params if p.grad is not None)
    out = {"step_ms": step_ms, "grad_all_reduce_ms": reduce_ms,
           "grad_mb": n * 4 / 1e6}
    opt = state.optimizer
    if isinstance(opt, zero.ZeroAdamW):
        out["all_gather_ms"] = [_timed(device, opt.all_gather_params)
                                for _ in range(5)]
        # what one rank sends and what every rank receives
        sent = sum(leaf.numel() * leaf.element_size()
                   for _, _, leaf in opt.slots)
        out["all_gather_mb"] = (sent / 1e6, sent * mesh.data / 1e6)
    return out


def skip_all_gather(optimizer: zero.ZeroAdamW) -> None:
    """The ZeRO-1 control: the step leaves out the all-gather, so that each
    rank keeps stale copies of the slices other ranks own."""
    optimizer.all_gather_params = lambda: None


def _snapshot(state) -> tuple[dict, dict]:
    """(the model's state dict, the optimizer's state dict), cloned on
    their device; the optimizer's is a collective under ZeRO-1."""
    sd = state.optimizer.state_dict()
    return ({k: v.detach().clone() for k, v in state.model.state_dict()
             .items()},
            {i: {k: v.clone() for k, v in st.items()}
             for i, st in sd["state"].items()})


def _same(a: tuple, b: tuple) -> bool:
    """Both snapshots bit for bit: every entry, of the same keys."""
    (ma, oa), (mb, ob) = a, b
    return (ma.keys() == mb.keys() and oa.keys() == ob.keys()
            and all(torch.equal(ma[k], mb[k]) for k in ma)
            and all(oa[i].keys() == ob[i].keys()
                    and all(torch.equal(oa[i][k], ob[i][k]) for k in oa[i])
                    for i in oa))


def zero1_check(cfg: Config, model, initial: dict, batch: dict,
                mesh: mesh_lib.Mesh, timed_steps: int = 0) -> dict:
    """Two steps from ``initial`` (the one-process state dict) of the
    DATA-only DP step, the ZeRO-1 DP step and the control without the
    all-gather, on this rank's ``batch``: per run, whether the model's and
    the optimizer's state dicts equal the DATA-only run's bit for bit after
    each step, the stem kernels' launches in each step, and this rank's
    moment bytes from the tensors and from the shapes; with
    ``timed_steps`` the ZeRO-1 timings. With a model split over a 'model'
    axis (``tools/tp_check.py --zero1``) the DATA-only run is the DATA x
    MODEL step and each rank compares its own slices."""
    device = next(model.parameters()).device
    db = engine.device_batch(batch, device)
    runs, out = {}, {}
    for name in ("data", "zero1", "control"):
        c = copy.deepcopy(cfg)
        c.mesh.zero1 = name != "data"
        sharding_rules.load_full_state(model, initial)
        state = engine.create_train_state(c, model, steps_per_epoch=10,
                                          mesh=mesh)
        if name == "control":
            skip_all_gather(state.optimizer)
        step = engine.make_train_step(c, state, mesh=mesh)
        snaps, launches = [], []
        for _ in range(2):
            before = _stem_launches()
            step(db, c.loss.dice_cof)
            after = _stem_launches()
            launches.append({"stem_stats": after[0] - before[0],
                             "stem_pool": after[1] - before[1]})
            snaps.append(_snapshot(state))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out[f"{name}_launches"] = launches
        if name == "data":
            runs[name] = snaps
        else:
            out[f"{name}_equal"] = [_same(a, b) for a, b in
                                    zip(snaps, runs["data"])]
        params = trainable_params(state.optimizer)
        out[f"{name}_moment_bytes"] = zero.moment_bytes(state.optimizer)
        out[f"{name}_predicted_bytes"] = zero.predicted_moment_bytes(
            params, mesh.data if c.mesh.zero1 else 1)
        del state, step, snaps
    del runs
    if timed_steps:
        c = copy.deepcopy(cfg)
        c.mesh.zero1 = True
        sharding_rules.load_full_state(model, initial)
        out["timings"] = timings(c, model, batch, mesh, timed_steps)
    return out


def classifier_check(device: torch.device, mesh: mesh_lib.Mesh,
                     seed: int = 0, batch_seed: int = 1) -> Optional[dict]:
    """The classifier's DP step (this rank's 2 clips of the global 4), its
    ``LocalMesh`` control and, on rank 0, the one-process step on the 4,
    from one state (random weights from ``seed``): on rank 0 the readings
    of each against the one process (the loss, all gradients, the running
    statistics' updates, relative), and of a repeat of the one-process
    step ("repeat", the noise floor), None on the others."""
    from tubelet_transformer_tpu_torch.train import classify

    b = 2
    n = b * mesh.data
    rng = np.random.default_rng(batch_seed)
    clips = rng.normal(size=(n, *CLASSIFIER["clip"], 3)).astype(np.float32)
    labels = rng.integers(0, CLASSIFIER["classes"], n)
    model = classify.build_classifier(CLASSIFIER["backbone"],
                                      CLASSIFIER["classes"], seed=seed,
                                      device=device)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def one(rows: slice, m: mesh_lib.Mesh) -> dict:
        model.load_state_dict(initial)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        step = classify.make_classification_train_step(
            classify.create_classifier_state(model, opt), mesh=m)
        loss = step(torch.from_numpy(clips[rows]).to(device),
                    torch.from_numpy(labels[rows]).to(device))
        return {"loss": float(loss),
                "grads": torch.cat([p.grad.reshape(-1).double().cpu()
                                    for p in model.parameters()]),
                "stats": {k: v.detach().double().cpu() for k, v in
                          model.state_dict().items()
                          if k.endswith(("running_mean", "running_var"))}}

    # the trunk's 1x3x3 max-pool (stem_kernel=False) has no deterministic
    # CUDA backward: under --deterministic it runs with a warning instead
    strict = (torch.are_deterministic_algorithms_enabled()
              and not torch.is_deterministic_algorithms_warn_only_enabled())
    if strict:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        shard = slice(mesh.rank * b, (mesh.rank + 1) * b)
        got = {"dp": one(shard, mesh),
               "control": one(shard, LocalMesh(mesh.data, mesh.rank))}
        model.trunk.set_rank_mean(None)
        if mesh.rank:
            return None
        want = one(slice(0, n), mesh_lib.Mesh())
        # the noise floor: the one-process step again, from the same state
        got["repeat"] = one(slice(0, n), mesh_lib.Mesh())
    finally:
        if strict:
            torch.use_deterministic_algorithms(True)
    stat_keys = sorted(want["stats"])

    def moved(run):
        return torch.cat([(run["stats"][k] - initial[k].double().cpu())
                          .reshape(-1) for k in stat_keys])

    return {k: {"loss_rel": abs(r["loss"] - want["loss"]) / abs(want["loss"]),
                "grads_rel": _rel(r["grads"], want["grads"]),
                "running_update_rel": _rel(moved(r), moved(want))}
            for k, r in got.items()}


def run(cfg: Config, device: torch.device, seed: int = 0,
        batch_seed: int = 1, initial: Optional[dict] = None,
        timed_steps: int = 0, batch: Optional[dict] = None,
        zero1: bool = False) -> Optional[dict]:
    """The three steps on this rank (in a joined process group); on rank 0
    the recorded runs, the readings and every rank's timings, None on the
    others. ``initial``: the model's state dict (else random weights from
    ``seed``); ``batch``: the global batch (else ``global_batch``);
    ``zero1``: also ``zero1_check``, every rank's result under "zero1"."""
    if cfg.mesh.model > 1:
        raise ValueError("MESH.MODEL > 1: tools/tp_check.py checks the "
                         "'model' axis")
    mesh = mesh_lib.create_mesh(cfg.mesh.data, cfg.mesh.model, cfg.mesh.pipe)
    cfg.mesh.data = mesh.data
    model = build_model(cfg, device=device, seed=seed, train=True)
    log_time("dp_check: the model built")
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
    log_time("dp_check: the DP step and its control")
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
    if times:
        log_time("dp_check: the timed steps")
    if zero1:
        z = zero1_check(cfg, model, initial, shard, mesh, timed_steps)
        log_time("dp_check: the ZeRO-1 check")
        if timed_steps:
            t = z["timings"]
            print(f"dp_check rank {mesh.rank}: ZeRO-1 step ms "
                  f"{[round(v, 2) for v in t['step_ms']]}, all-gather ms "
                  f"{[round(v, 2) for v in t['all_gather_ms']]} "
                  f"({t['all_gather_mb'][0]:.1f} MB sent, "
                  f"{t['all_gather_mb'][1]:.1f} MB gathered)", flush=True)
        print(f"dp_check rank {mesh.rank}: moment bytes DATA-only "
              f"{z['data_moment_bytes']} (from the shapes "
              f"{z['data_predicted_bytes']}), ZeRO-1 "
              f"{z['zero1_moment_bytes']} (from the shapes "
              f"{z['zero1_predicted_bytes']}); bit-equal to DATA-only "
              f"after each step: ZeRO-1 {z['zero1_equal']}, control "
              f"{z['control_equal']}", flush=True)
        out["zero1"] = mesh_lib.all_gather_objects(z)
    if mesh.rank:
        return None
    out["single"] = one_step(cfg, model, initial, microbatch_major(
        batch, mesh.data, max(1, cfg.train.accum_steps)), mesh_lib.Mesh())
    log_time("dp_check: the one-process step")
    ref = Reference(out["single"], initial, device)
    out["readings"] = {k: readings(out[k], out["single"], initial, device,
                                   ref) for k in ("dp", "control")}
    out["timings"] = {k: v.tolist() for k, v in every.items()}
    out["world"] = mesh.data
    return out


def main(argv: Optional[list] = None, keep_group: bool = False) -> None:
    """The command line (``argv``, else ``sys.argv``); with
    ``keep_group`` the process group stays joined for the next tool of
    the launch (``tools/mesh_checks.py``)."""
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
    p.add_argument("--zero1", action="store_true",
                   help="also ZeRO-1 against the DATA-only step")
    p.add_argument("--moe", action="store_true",
                   help="also the three steps with MoE encoder FFNs")
    p.add_argument("--classifier", action="store_true",
                   help="also the classifier's DP step")
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
    if args.float32:
        cfg.model.compute_dtype = "float32"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    log_time("dp_check: imports")
    mesh_lib.init_distributed(device, args.dist_backend)
    log_time("dp_check: the process group joined")

    def summary(out: dict) -> dict:
        return {**{k: out[k] for k in ("readings", "timings", "world")
                   if k in out},
                **{k: {n: out[k][n]
                       for n in ("metrics", "launches", "all_reduces")}
                   for k in ("dp", "control", "single")},
                **({"zero1": out["zero1"]} if "zero1" in out else {})}

    try:
        out = run(cfg, device, args.seed, args.batch_seed,
                  timed_steps=args.timed_steps, zero1=args.zero1)
        result = summary(out) if out is not None else {}
        if args.moe:
            moe_cfg = copy.deepcopy(cfg)
            for k, v in MOE.items():
                setattr(moe_cfg.model, k, v)
            out = run(moe_cfg, device, args.seed, args.batch_seed)
            if out is not None:
                result["moe"] = summary(out)
        if args.classifier:
            out = classifier_check(device, mesh_lib.create_mesh(),
                                   args.seed, args.batch_seed)
            log_time("dp_check: the classifier check")
            if out is not None:
                result["classifier"] = out
        if mesh_lib.is_main_process():
            torch.save(result, args.out)
            print(f"dp_check: readings {result['readings']}", flush=True)
            for k in ("moe", "classifier"):
                if k in result:
                    print(f"dp_check: {k} readings "
                          f"{result[k].get('readings', result[k])}",
                          flush=True)
    finally:
        if not keep_group:
            mesh_lib.shutdown()


if __name__ == "__main__":
    main()
