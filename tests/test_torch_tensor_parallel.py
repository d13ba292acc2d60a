"""Tensor parallelism (MESH.MODEL) of the PyTorch port over
torch.distributed: the transformer's heads and FFN columns and the MoE
experts split over the model peers, ranks on the CPU over gloo, each a
process started from this file (``python
tests/test_torch_tensor_parallel.py worker <job>``, torchrun's environment
set by hand, as tests/test_torch_data_parallel.py starts them).
CSN-TINY at tests/test_engine.py's transformer widths (d 64, 4 heads, FFN
64, 2+2 layers; the class branch and the decode pooling at 8 heads),
float32, dropout off, TUNE_POINT 4, BN statistics randomised, 2 clips a
data shard.

* One TP step (``tools/tp_check.py``) against the JAX package's
  ``engine.make_train_step`` after ``shard_train_state`` on a
  ``create_mesh(data=1, model=2)`` mesh of conftest's host devices, on the
  same global batch from the same variables, with
  ``test_torch_train_step.py``'s tolerances: in AVA mode (decode pooling:
  the pool_decoder at d 2048 splits too), in JHMDB mode, with MoE (4
  experts, top 2: 2 a peer, the layout of JAX's
  ``test_moe.py::test_expert_parallel_sharding_parity``), and on a
  ``data=2, model=2`` mesh (4 ranks). Each also against the port's own
  one-process step on the whole batch to SELF_TOL, its control ("g" whose
  backward sums again) missing; the model peers' replicated parameters
  bit-equal after two steps; the split parameters the set JAX's
  ``param_shardings`` splits, crossed over through ``convert.py``.
* Attention heads that MESH.MODEL does not divide, the packed projection
  split by rows as JAX splits it: a 3-head model of width 48 on MODEL 2
  (beside the 2-rank cases), and the 4-head model on MODEL 3 (3 ranks,
  JAX on 3 host devices: q, k and v a peer each), each against JAX's
  step and one process's, its controls ("g" and "gather" summing again)
  missing, the peers bit-equal, each rank's in_proj a 1/MODEL share; the
  eval step under MODEL 3 against one process's.
* The eval forward with long-term context (USE_LFB: ``lfb_attn`` split)
  equals one process's.
* ``run_training`` under MODEL 2 writes from rank 0 alone; ``run_eval``
  under MODEL 2, and under DATA 2 x MODEL 2 (4 ranks), equals the
  one-process validation, detection for detection, each keyframe gathered
  once; the TP checkpoint resumes in one
  process, and a one-process checkpoint resumes under TP, where the next
  step (dropout on) equals the one-process step's.
* ZeRO-1 beside the 'model' axis (MESH.ZERO1 on DATA 2 x MODEL 2): two
  steps against JAX's ZeRO-1 step after ``shard_train_state(zero1=True)``
  on the same mesh (losses, parameters, the gathered moments against
  ``mu``/``nu``), bit for bit against the port's DATA x MODEL step on
  every rank with the control without the all-gather missing, each
  rank's moment bytes JAX device 0's; its checkpoint resumes in one
  process, a DATA x MODEL file and a one-process file under it.
* generate_lfb under MODEL 2 and under DATA 2 x MODEL 2: every rank fills
  the one-process bank, rank 0 alone writes it.
* The 'model' axis' refusals: a step whose model is not split over the
  mesh, the serving CLI under MESH.MODEL in one process (mesh serving
  runs under torchrun, test_torch_mesh_serving.py), generate_lfb with a
  'pipe' axis.

The JAX steps run in processes of their own, as
tests/test_torch_data_parallel.py runs them, and the checks against them
on the ranks' rank 0. Every subprocess runs under a timeout of at most
300 s and is killed when it runs out; the temporary files go when the
module's tests end.
"""

import copy
import glob
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401

from test_torch_data_parallel import (
    SELF_TOL, Deferred, _ava_cfg, _jax_init_task, _kill, _load, _missed,
    _run_cfg, _save, _start, _ucf_cfg, _wait, run_jax_job, run_job)
from test_torch_zero1 import (
    _jax_zero1_task, _zero1_against_jax, _zero1_task,
    check_resume_in_one_process)
from tubelet_transformer_tpu_torch.cli import runner
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.parallel import sharding_rules
from tubelet_transformer_tpu_torch.tools import dp_check, tp_check
from tubelet_transformer_tpu_torch.train import checkpoint as ckpt_lib
from tubelet_transformer_tpu_torch.train import engine
from tubelet_transformer_tpu_torch.train.optimizer import param_label

# the parameters' updates of the TP step against one process: AdamW's
# first update is lr * g / (|g| + eps), so a gradient within a few eps of
# zero turns float32 rounding of g into an O(lr) change of its update;
# the four cases read 2.3e-6-1.3e-5 on the CPU, the control 0.66-1.07
UPDATE_TOL = 1e-4
CASES = ("ava", "ucf", "moe", "data_model")
UNEVEN_CASES = ("heads3", "model3")


# ---------------------------------------------------------------- worker

def _step_task(cfg, initial_path, batch, want_path):
    """tools/tp_check.run on this rank from the JAX case's initial
    variables (``initial_path``); on rank 0 what the tests read: the
    metrics and all-reduce counts of the TP step and its controls, their
    checks against JAX's step (``want_path``, run here once JAX has
    written it) with JAX's metrics, the one-process metrics, the readings,
    the peers' equality, the split names, the launches and the bytes of
    each rank's in_proj slices."""
    initial = _load(initial_path)["initial"]
    out = tp_check.run(cfg, torch.device("cpu"), initial=initial,
                       batch=batch)
    if out is None:
        return None
    names = ("tp", *out["controls"])
    return {**{k: out[k] for k in ("readings", "peers_equal", "peers_agree",
                                   "split", "launches", "controls",
                                   "in_proj_bytes",
                                   "one_process_in_proj_bytes")},
            **{k: {n: out[k][n] for n in ("metrics", "all_reduces")}
               for k in names},
            "single": {"metrics": out["single"]["metrics"]},
            "missed": Deferred(want_path, _missed, cfg, initial,
                               {k: out[k] for k in names}),
            "jax_metrics": Deferred(want_path, lambda want: want[0])}


def _eval_forward_task(cfg, initial_path, batch):
    """The eval step of the eval build split over the case's mesh, from
    the JAX case's initial variables, on the whole batch; on rank 0 the
    largest absolute difference of each of its detection outputs from one
    process's eval step."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    initial = _load(initial_path)["initial"]
    c = copy.deepcopy(cfg)
    c.val.compute_losses = False
    mesh = runner._mesh(c)
    model = build_model(c, mesh=mesh)
    sharding_rules.load_full_state(model, initial)
    db = engine.device_batch(batch, torch.device("cpu"))
    got = engine.make_eval_step(c, model, mesh=mesh)(db)
    if mesh.rank:
        return None
    one = tp_check.one_process(c)
    full = build_model(one)
    full.load_state_dict(initial)
    want = engine.make_eval_step(one, full)(db)
    return {k: float((got[k] - want[k]).abs().max())
            for k in ("scores", "binary", "boxes")}


def _train_task(cfg):
    out = runner.run_training(cfg, device="cpu")
    return {"val": out["val"], "dirs": out["dirs"]}


def _eval_task(cfg, dump_dir, path=None):
    """run_eval under MESH.MODEL of the checkpoint at ``path`` (by default
    the newest under LOG.BASE_PATH, rank 0's choice), then validate_ava of
    its model with a detection dump, counting the rows each gather hands
    rank 0."""
    from tubelet_transformer_tpu_torch.train import loop

    cfg.model.load = True
    cfg.model.pretrained_path = path or mesh_lib.broadcast_string(
        ckpt_lib.latest_checkpoint_any_run(cfg.log.base_path))
    gather, rows = mesh_lib.gather_global_tree, []

    def counting(tree, model=1):
        g = gather(tree, model)
        rows.append(len(g["key_idx"]))
        return g

    mesh_lib.gather_global_tree = counting
    try:
        out = runner.run_eval(cfg, device="cpu")
        mesh = mesh_lib.create_mesh(cfg.mesh.data, cfg.mesh.model)
        _, loader = runner.make_loaders(cfg, val_only=True)
        loop.validate_ava(cfg, engine.make_eval_step(cfg, out["model"],
                                                     mesh=mesh),
                          out["model"], loader, epoch=0, dump_dir=dump_dir)
    finally:
        mesh_lib.gather_global_tree = gather
    return {"val": out["val"], "cfg": cfg, "rows": rows}


def _resume_task(cfg, path, batch, no_dropout=False):
    """A one-process checkpoint into the TP train state (with MESH.ZERO1
    beside it too): whether the gathered model and optimizer state equal
    the file's bit for bit, and the metrics of one more step on
    ``batch``, the global batch (this rank's data shard of it), every
    dropout off with ``no_dropout``."""
    mesh = runner._mesh(cfg)
    b = len(next(iter(batch.values()))) // mesh.data
    batch = {k: v[mesh.data_index * b:(mesh.data_index + 1) * b]
             for k, v in batch.items()}
    state = runner.init_state(cfg, 4, torch.device("cpu"), mesh=mesh)
    if no_dropout:
        tp_check._no_dropout(state.model)
    ckpt_lib.load_checkpoint(path, state)
    want = torch.load(path, weights_only=True)
    model = sharding_rules.gather_state(state.model)
    opt = sharding_rules.gather_optimizer_state(state.model, state.optimizer)
    same = (model.keys() == want["model"].keys()
            and all(torch.equal(model[k], want["model"][k]) for k in model)
            and opt["state"].keys() == want["optimizer"]["state"].keys()
            and all(torch.equal(v, want["optimizer"]["state"][i][k])
                    for i, st in opt["state"].items()
                    for k, v in st.items()))
    step = engine.make_train_step(cfg, state, mesh=mesh)
    metrics = step(engine.device_batch(batch, torch.device("cpu")), 1.0)
    return {"same": same, "metrics": {k: float(v) for k, v in
                                      metrics.items()}}


def _lfb_forward_task(cfg, seed):
    """The eval forward with long-term context (USE_LFB: ``lfb_attn``
    split too) under MESH.MODEL against one process's, on the same clips
    and memory (one row partly padded): the largest difference of each
    output, and whether ``lfb_attn`` was split."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    mesh = runner._mesh(cfg)
    model, full = build_model(cfg, mesh=mesh), build_model(cfg)
    rng = np.random.default_rng(seed)
    s, t, e = cfg.data.img_size, cfg.data.temp_len, cfg.model.d_model
    clips = torch.from_numpy(rng.normal(size=(2, t, s, s, 3)).astype(
        np.float32))
    memory = torch.from_numpy(rng.normal(size=(2, 6, e)).astype(np.float32))
    mask = torch.zeros((2, 6), dtype=torch.bool)
    mask[1, 3:] = True
    with torch.no_grad():
        got, want = (m(clips, return_features=True, lfb_features=memory,
                       lfb_mask=mask) for m in (model, full))
    return {"split": model.lfb_attn.tp is mesh,
            "diff": {k: float((got[k] - want[k]).abs().max())
                     for k in want}}


def _bank_task(cfg, out):
    """``run_generate_lfb`` of the checkpoint of MODEL.LOAD: this rank's
    bank (``_recorded_bank``) and how often it saved one."""
    return _recorded_bank(lambda: runner.run_generate_lfb(cfg, out,
                                                          device="cpu"))


def _recorded_bank(run):
    """``run()``, recording the bank that ``generate_bank`` returns, the
    actor probabilities of the slots that ``FeatureBank.add`` keeps, and
    the number of ``FeatureBank.save`` calls: {"feats", "valid", "probs"}
    by key, and "saves"."""
    from tubelet_transformer_tpu_torch.eval import lfb

    banks, probs, saves = [], {}, [0]
    generate, add, save = lfb.generate_bank, lfb.FeatureBank.add, \
        lfb.FeatureBank.save

    def generating(*a, **k):
        banks.append(generate(*a, **k))
        return banks[-1]

    def adding(self, key, features, actor_prob, threshold=0.8):
        probs[key] = np.sort(np.asarray(actor_prob))[::-1][:self.slots]
        return add(self, key, features, actor_prob, threshold)

    def saving(self, path):
        saves[0] += 1
        return save(self, path)

    lfb.generate_bank, lfb.FeatureBank.add = generating, adding
    lfb.FeatureBank.save = saving
    try:
        run()
    finally:
        lfb.generate_bank, lfb.FeatureBank.add = generate, add
        lfb.FeatureBank.save = save
    bank, = banks
    return {"feats": dict(bank._bank), "valid": dict(bank._valid),
            "probs": probs, "saves": saves[0]}


def _zero1_model_task(**kw):
    """``_zero1_task`` on the DATA 2 x MODEL 2 mesh, its steps checked
    by ``_zero1_against_jax_mesh``."""
    out = _zero1_task(**kw)
    if isinstance(out.get("jax"), Deferred):
        out["jax"].fn = _zero1_against_jax_mesh
    return out


def _zero1_against_jax_mesh(want, cfg, initial, steps):
    """The recorded ZeRO-1 x MODEL steps against JAX's ZeRO-1 steps on the
    data-2 x model-2 mesh (``_zero1_against_jax``), with the parameters
    whose mu JAX makes twice the port's set apart: each one's norm ratio
    of JAX's first-step mu to the port's ("parted", those of the moment
    errors whose ratio is 2 within 1e-3), their moment errors left out;
    and each parameter's largest difference from JAX's after the second
    step, in its group's learning rate ("second_update_lr")."""
    out = _zero1_against_jax(want, cfg, initial, steps)
    first = want["steps"][0]["mu"]
    parted = {}
    for name in out["steps"][0]["moment_errors"]:
        ratio = float(np.linalg.norm(first[name])
                      / np.linalg.norm(steps[0]["moments"][name][0].numpy()))
        if abs(ratio - 2.0) <= 1e-3:
            parted[name] = ratio
    for st in out["steps"]:
        st["moment_errors"] = {n: e for n, e in st["moment_errors"].items()
                               if n not in parted}
    lr = {"main": cfg.train.lr, "backbone": cfg.train.lr_backbone}
    second = want["steps"][1]["state"]
    out["second_update_lr"] = {
        n: float(np.abs(steps[1]["state"][n].numpy() - second[n]).max()
                 / lr[param_label(n, cfg)]) for n in steps[1]["grads"]}
    return {**out, "parted": parted}


TASKS = {"step": _step_task, "train": _train_task, "eval": _eval_task,
         "resume": _resume_task, "lfb": _lfb_forward_task,
         "bank": _bank_task, "zero1": _zero1_model_task,
         "eval_forward": _eval_forward_task}


def worker(job_path):
    run_job(job_path, TASKS)


def _jax_tp_init_task(memo, out, cfg, batch):
    """``_jax_init_task``; returns the names JAX splits (``_jax_split_names``)."""
    _jax_init_task(memo, out, cfg, batch)
    return _jax_split_names(cfg, memo[out][2])


def _jax_tp_step_task(memo, out, init, cfg, batch):
    """``_jax_tp_step`` from the variables of the ``init`` task, saved to
    <out>.want."""
    _save(_jax_tp_step(cfg, *memo[init][:3], batch), f"{out}.want")


JAX_TASKS = {"init": _jax_tp_init_task, "step": _jax_tp_step_task,
             "zero1": _jax_zero1_task}


def jax_worker(job_path):
    run_jax_job(job_path, JAX_TASKS)


# ---------------------------------------------------------------- parent

def _tp(cfg, data=1, model=2):
    """``cfg`` at tests/test_engine.py's transformer depth, on a
    data x ``model`` mesh."""
    cfg.model.enc_layers = cfg.model.dec_layers = 2
    cfg.mesh.data, cfg.mesh.model = data, model
    return cfg


def _avg_ava():
    cfg = _ava_cfg()
    cfg.model.temporal_ds_strategy = "avg"
    return cfg


def _cases():
    """The TP cases (``CASES``), then the attentions whose heads the
    'model' axis does not divide (``UNEVEN_CASES``): ``heads3``, the
    encoder and decoder at 3 heads of width 48 (the position table's 8
    divides it) on MODEL 2, every packed projection and ``out_proj`` of
    theirs split by rows and columns (the class branch's 8 heads by head);
    ``model3``, the 4-head model on MODEL 3, every packed projection cut
    into q | k | v and every ``out_proj`` and FFN (64 wide) replicated."""
    moe = _avg_ava()
    moe.model.moe_experts, moe.model.moe_top_k = 4, 2
    heads3 = _avg_ava()
    heads3.model.d_model, heads3.model.nhead = 48, 3
    return {"ava": _tp(_ava_cfg()), "ucf": _tp(_ucf_cfg()), "moe": _tp(moe),
            "data_model": _tp(_avg_ava(), data=2), "heads3": _tp(heads3),
            "model3": _tp(_avg_ava(), model=3)}


def _port_sd(cfg, params, stats):
    from tubelet_transformer_tpu_torch.convert import (
        tuber_torch_state_from_params)

    m = cfg.model
    return tuber_torch_state_from_params(
        params, stats, block_nums=(1, 1, 1, 1), enc_layers=m.enc_layers,
        dec_layers=m.dec_layers, temporal_ds_strategy=m.temporal_ds_strategy,
        single_frame=m.single_frame, ddp_prefix=False)


def _jax_mesh(cfg):
    import jax

    from tubelet_transformer_tpu.parallel import mesh as jmesh

    n = cfg.mesh.data * cfg.mesh.model
    return jmesh.create_mesh(data=cfg.mesh.data, model=cfg.mesh.model,
                             devices=jax.devices()[:n])


def _jax_tp_step(cfg, jmodel, tx, state, batch):
    """JAX's train step after ``shard_train_state`` on the case's
    ('data', 'model') mesh: (metrics, the port's state dict of the
    variables after it)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from tubelet_transformer_tpu.parallel import mesh as jmesh
    from tubelet_transformer_tpu.parallel.sharding_rules import (
        shard_train_state)
    from tubelet_transformer_tpu.train import engine as jengine

    mesh = _jax_mesh(cfg)
    call = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        new_state, metrics = jengine.make_train_step(cfg, jmodel, tx)(
            shard_train_state(jax.device_get(state), mesh),
            jmesh.shard_batch(batch, mesh), jax.random.PRNGKey(1),
            jnp.float32(cfg.loss.dice_cof))
        metrics, (params, stats) = jax.device_get(
            (metrics, (new_state.params, new_state.batch_stats)))
    finally:
        fnn.Dropout.__call__ = call
    return ({k: float(v) for k, v in metrics.items()},
            _port_sd(cfg, params, stats))


def _jax_split_names(cfg, state):
    """The port's names of the parameters that JAX's ``param_shardings``
    splits over 'model' on the case's mesh: a tree of ones where it splits
    and zeros elsewhere, crossed over through ``convert.py``."""
    import jax
    from jax.sharding import PartitionSpec as P

    from tubelet_transformer_tpu.parallel.sharding_rules import (
        param_shardings)

    params = jax.device_get(state.params)
    flags = jax.tree.map(
        lambda x, s: np.full(np.shape(x), float(s.spec != P()), np.float32),
        params, param_shardings(params, _jax_mesh(cfg)))
    sd = _port_sd(cfg, flags, jax.tree.map(
        np.zeros_like, jax.device_get(state.batch_stats)))
    mixed = [k for k, v in sd.items() if 0 < np.mean(v) < 1]
    assert not mixed, mixed
    return {k for k, v in sd.items() if np.size(v) and np.all(v == 1)}


def _one_process_checkpoint(tmp):
    """A checkpoint of one process after one step of ``_run_cfg``, and
    the batch of the step that follows a resume."""
    cfg = _run_cfg(tmp / "one")
    cfg.mesh.model = 1
    state = runner.init_state(cfg, 4, torch.device("cpu"))
    step = engine.make_train_step(cfg, state)
    step(engine.device_batch(dp_check.global_batch(cfg, 1, seed=8),
                             torch.device("cpu")), 1.0)
    path = ckpt_lib.save_checkpoint(str(tmp / "one_ckpt"), state, epoch=0)
    return path, dp_check.global_batch(cfg, 1, seed=9)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every multi-process run of this file, started at once: a JAX process
    a case, which writes the case's initial variables first and then
    JAX's step on the case's ('data', 'model') mesh (DATA 2 x MODEL 2's
    process ZeRO-1 beside it too); then
    the train, eval, resume, USE_LFB and generate_lfb runs of 2
    ranks under MODEL 2; the TP step of each 2-rank case on 2 more ranks;
    and on 4 ranks of DATA 2 x MODEL 2 the eval, generate_lfb and
    ZeRO-1 resume runs of a one-process checkpoint, then the case's TP
    step and ZeRO-1 beside it. A step starts as soon as its initial
    variables are written, and is checked against JAX's once that is
    written. The temporary files go when the module's tests end."""
    tmp = tmp_path_factory.mktemp("tp")
    cases = _cases()
    batches = {k: dp_check.global_batch(c, 2 * c.mesh.data, seed=3)
               for k, c in cases.items()}
    # JHMDB: every box slot filled (test_torch_data_parallel.py: the JAX
    # matcher's float32 solve beside PAD_COST cannot order costs as close
    # as this random init's)
    batches["ucf"]["valid"][:] = True
    batches["ucf"]["vis"][:] = 1
    batch3 = dp_check.global_batch(cases["data_model"], 4, seed=4)
    job = {"ava": "jax_a", "ucf": "jax_d", "moe": "jax_b",
           "data_model": "jax_c", "heads3": "jax_f", "model3": "jax_e"}

    def out(case, what, step=""):
        return str(tmp / f"{job[case]}.out.{case}{step}.{what}")

    jax_jobs = {}
    for case, name in job.items():
        jax_jobs.setdefault(name, {})[case] = (
            "init", {"cfg": cases[case], "batch": batches[case]})
    for case, name in job.items():
        jax_jobs[name][f"{case}_step"] = ("step", {
            "init": str(tmp / f"{name}.out.{case}"), "cfg": cases[case],
            "batch": batches[case]})
    jax_jobs["jax_c"]["zero1_step"] = ("zero1", {
        "init": str(tmp / "jax_c.out.data_model"),
        "cfg": cases["data_model"], "batch": batches["data_model"],
        "model": 2})
    launched = []
    try:
        for name, tasks in jax_jobs.items():
            launched.append(_start(tmp, tasks, name, world=1, mode="jax",
                                   script=__file__))
    except BaseException:
        for procs, _ in launched:
            _kill(procs)
        raise
    one_ckpt, resume_batch = _one_process_checkpoint(tmp)

    def run_cfg(data=1):
        cfg = _run_cfg(tmp / "runs")
        cfg.mesh.data, cfg.mesh.model = data, 2
        return cfg

    def bank_cfg(data=1):
        cfg = run_cfg(data)
        cfg.model.load, cfg.model.pretrained_path = True, one_ckpt
        return cfg

    lfb_cfg = run_cfg()
    lfb_cfg.use_lfb = True
    zero1_cfg = run_cfg(data=2)
    zero1_cfg.mesh.zero1 = True

    def step(case):
        return ("step", {"cfg": cases[case],
                         "initial_path": out(case, "init"),
                         "batch": batches[case],
                         "want_path": out(case, "want", "_step"),
                         "after": [out(case, "init")]})

    for d in ("bank_tp", "bank_dm"):
        (tmp / d).mkdir()
    try:
        launched.append(_start(tmp, {
            "train": ("train", {"cfg": run_cfg()}),
            "eval": ("eval", {"cfg": run_cfg(),
                              "dump_dir": str(tmp / "dump_tp")}),
            "resume": ("resume", {"cfg": run_cfg(), "path": one_ckpt,
                                  "batch": resume_batch}),
            "lfb": ("lfb", {"cfg": lfb_cfg, "seed": 10}),
            "bank": ("bank", {"cfg": bank_cfg(),
                              "out": str(tmp / "bank_tp" / "bank.npz")})},
            "runs", script=__file__))
        launched.append(_start(tmp, {k: step(k) for k in ("ava", "ucf",
                                                          "moe", "heads3")},
                               "steps", script=__file__))
        launched.append(_start(tmp, {
            "eval": ("eval", {"cfg": run_cfg(data=2),
                              "dump_dir": str(tmp / "dump_dm"),
                              "path": one_ckpt}),
            "bank": ("bank", {"cfg": bank_cfg(data=2),
                              "out": str(tmp / "bank_dm" / "bank.npz")}),
            "resume": ("resume", {"cfg": zero1_cfg, "path": one_ckpt,
                                  "batch": dp_check.global_batch(
                                      zero1_cfg, 2, seed=9),
                                  "no_dropout": True}),
            "data_model": step("data_model"),
            "zero1": ("zero1", {
                "cfg": cases["data_model"],
                "initial_path": out("data_model", "init"),
                "batch": batches["data_model"], "batch3": batch3,
                "ckpt_dir": str(tmp / "zero1_ckpt"),
                "want_path": str(tmp / "jax_c.out.zero1_step.want"),
                "after": [out("data_model", "init")]})},
            "dm", world=4, script=__file__))
        launched.append(_start(tmp, {
            "model3": step("model3"),
            "eval_forward": ("eval_forward", {
                "cfg": cases["model3"], "batch": batches["model3"],
                "initial_path": out("model3", "init"),
                "after": [out("model3", "init")]})},
            "m3", world=3, script=__file__))
    except BaseException:
        for procs, _ in launched:
            _kill(procs)
        raise
    splits = {}
    for jax_job in launched[:len(jax_jobs)]:
        splits.update(_wait(*jax_job)[0][0])
    n = len(jax_jobs)
    runs, logs = _wait(*launched[n])
    steps = _wait(*launched[n + 1])[0][0]
    dm = _wait(*launched[n + 2])[0]
    m3 = _wait(*launched[n + 3])[0][0]
    yield {"cases": cases,
           "jax_split": {k: splits[k] for k in cases},
           "got": {**steps, "data_model": dm[0]["data_model"],
                   "model3": m3["model3"]},
           "eval3": m3["eval_forward"],
           "runs": runs, "logs": logs, "dm": dm, "tmp": tmp,
           "one_ckpt": one_ckpt, "resume_batch": resume_batch,
           "zero1_cfg": zero1_cfg, "batch3": batch3,
           "ckpt": glob.glob(str(tmp / "runs" / "*" / "checkpoints" /
                                 "ckpt_*"))}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("case", CASES)
def test_tp_step_matches_jax_mesh_step(tp_runs, case):
    """The TP step against JAX's step on the same ('data', 'model') mesh,
    with test_torch_train_step.py's tolerances (``_check_against_jax``,
    run where both steps' states are, on rank 0 of the ranks' job); the
    control misses them."""
    got = tp_runs["got"][case]
    assert got["tp"]["metrics"]["finite"] == 1.0
    if case == "moe":
        assert "loss_moe_aux" in got["jax_metrics"]
    assert got["missed"]["tp"] == []
    assert got["missed"]["control"] != []


@pytest.mark.parametrize("case", CASES)
def test_tp_step_matches_one_process(tp_runs, case):
    """The TP step against the port's one-process step on the whole batch:
    every reading within SELF_TOL, the updates within UPDATE_TOL. The
    control's forward is the step's own, so its losses and statistics
    agree; its gradients, their norm and the updates miss by far. It makes
    one all-reduce more per "g", one per split module."""
    got = tp_runs["got"][case]
    tp, control = got["readings"]["tp"], got["readings"]["control"]
    for k, v in tp.items():
        assert v <= (UPDATE_TOL if k == "update_rel" else SELF_TOL), (k, v)
    for k in ("grad_norm_rel", "grads_rel", "update_rel"):
        assert control[k] > 100 * UPDATE_TOL, (k, control[k])
    assert control["loss_rel"] == tp["loss_rel"]
    n_g = sum(k.endswith(("in_proj_weight", "linear1.weight", "expert_w1"))
              for k in got["split"])
    assert got["control"]["all_reduces"] - got["tp"]["all_reduces"] == n_g


@pytest.mark.parametrize("case", CASES)
def test_model_peers_keep_replicated_parameters_equal(tp_runs, case):
    """After each of two TP steps, every rank's replicated parameters and
    buffers equal its model peers' bit for bit."""
    assert tp_runs["got"][case]["peers_equal"] == [True, True]


@pytest.mark.parametrize("case", ["ava", "ucf", "moe", *UNEVEN_CASES])
def test_split_parameters_are_jax_param_shardings(tp_runs, case):
    """The port splits exactly the parameters JAX's ``param_shardings``
    splits over 'model' (its names crossed over through ``convert.py``):
    every attention's in_proj and out_proj (the decode pooling's, the
    class branch's and the cross-attention's included), every FFN's
    linear1 and linear2, the MoE stacks; nothing else, and no bias but the
    experts'."""
    got = set(tp_runs["got"][case]["split"])
    assert got == tp_runs["jax_split"][case]
    assert not any(k.endswith("bias") and "expert_" not in k for k in got)
    if case == "ava":
        assert {"backbone.pool_decoder.layers.0.linear1.weight",
                "cross_attn.in_proj_weight"} <= got
    if case == "moe":
        assert sum("expert_" in k for k in got) == 4 * 2
    if case == "model3":
        assert got and all(k.endswith("in_proj_weight") for k in got)


@pytest.mark.parametrize("case", UNEVEN_CASES)
def test_uneven_heads_step_matches_jax_mesh_step(tp_runs, case):
    """Where MESH.MODEL does not divide an attention's heads (3 heads on
    MODEL 2; 4 and 8 heads on MODEL 3, ``_cases``), the TP step against
    JAX's step on the same ('data', 'model') mesh, which splits by
    divisibility alone, with test_torch_train_step.py's tolerances
    (``_check_against_jax``); every control misses them."""
    got = tp_runs["got"][case]
    assert got["tp"]["metrics"]["finite"] == 1.0
    assert got["missed"]["tp"] == [], got["missed"]["tp"]
    for name in got["controls"]:
        assert got["missed"][name] != [], name


@pytest.mark.parametrize("case", UNEVEN_CASES)
def test_uneven_heads_step_matches_one_process(tp_runs, case):
    """The same steps against the port's one-process step on the whole
    batch: every reading within SELF_TOL (the BN running statistics
    among them), the updates within UPDATE_TOL. The controls run where
    their hand-off does: "g" summing again where an ``out_proj`` or FFN
    splits (MODEL 2), "gather" summing again where an attention splits by
    rows (both cases); each keeps the step's forward and misses in the
    gradients and updates."""
    got = tp_runs["got"][case]
    assert got["controls"] == {"heads3": ["control", "gather_again"],
                               "model3": ["gather_again"]}[case]
    readings = got["readings"]
    for k, v in readings["tp"].items():
        assert v <= (UPDATE_TOL if k == "update_rel" else SELF_TOL), (k, v)
    for name in got["controls"]:
        assert readings[name]["loss_rel"] == readings["tp"]["loss_rel"]
        for k in ("grad_norm_rel", "grads_rel", "update_rel"):
            assert readings[name][k] > 100 * UPDATE_TOL, (name, k, readings)


@pytest.mark.parametrize("case", UNEVEN_CASES)
def test_uneven_heads_peers_agree_and_hold_their_share(tp_runs, case):
    """After each of two steps every rank's replicated parameters and
    buffers equal its model peers' bit for bit (the attention over all
    heads is the same on every peer), and so they do after the step of
    each control; each rank's in_proj slices hold 1/MODEL of one
    process's bytes."""
    got = tp_runs["got"][case]
    model = tp_runs["cases"][case].mesh.model
    assert got["peers_equal"] == [True, True]
    assert all(got["peers_agree"].values()), got["peers_agree"]
    assert len(got["in_proj_bytes"]) == model
    for b in got["in_proj_bytes"]:
        assert b * model == got["one_process_in_proj_bytes"]


def test_uneven_heads_eval_matches_one_process(tp_runs):
    """The eval step of the 4-head model under MODEL 3 (q, k and v of every
    attention on their own peer, gathered) against one process's on the
    same variables and clips: scores, actor probabilities and boxes
    within 1e-5."""
    for k, v in tp_runs["eval3"].items():
        assert v <= 1e-5, (k, v)


def test_split_layout_round_trip():
    """``Split(0, 3)`` gives peer i the q, k and v rows of heads
    i*h/n .. (i+1)*h/n - 1; ``assemble`` rebuilds the full tensor from the
    peers' parts."""
    e, h, n = 16, 4, 2
    w = torch.arange(3 * e * 3, dtype=torch.float32).reshape(3 * e, 3)
    split = sharding_rules.Split(0, 3)
    parts = [sharding_rules.local_slice(w, split, n, i) for i in range(n)]
    d = e // h
    for i, part in enumerate(parts):
        heads = range(i * h // n, (i + 1) * h // n)
        rows = [j * e + hd * d + r for j in range(3) for hd in heads
                for r in range(d)]
        assert torch.equal(part, w[rows])
    assert torch.equal(sharding_rules.assemble(parts, split), w)
    col = sharding_rules.Split(1)
    parts = [sharding_rules.local_slice(w.T, col, 3, i) for i in range(3)]
    assert torch.equal(sharding_rules.assemble(parts, col), w.T)


def test_run_training_under_tp_writes_from_rank_zero(tp_runs):
    """MESH.MODEL 2 over 2 ranks: one data shard, so every step takes the
    whole split (6 steps of 1 clip); one run directory with config.json,
    one checkpoint and the metrics from rank 0 alone."""
    r0, r1 = (run["train"] for run in tp_runs["runs"])
    assert r0["dirs"] == r1["dirs"]
    runs = glob.glob(str(tp_runs["tmp"] / "runs" / "*"))
    assert len(runs) == 1 and Path(runs[0], "config.json").is_file()
    assert len(tp_runs["ckpt"]) == 1
    lines = Path(r0["dirs"]["tb"], "metrics.jsonl").read_text().splitlines()
    tags = [json.loads(line)["tag"] for line in lines]
    assert tags.count("train/total_loss") == 6
    assert "val/val_mAP_epoch" in tags
    assert {"mAP", "person_AP"} <= set(r0["val"])
    assert set(r1["val"]) == {"loss_ce", "loss_ce_b", "loss_bbox",
                              "loss_giou"}
    assert "Epoch:" in tp_runs["logs"][0] and "Epoch:" not in \
        tp_runs["logs"][1]
    assert "model peer 1 of 2" in tp_runs["logs"][1]


def _check_eval_against_one_process(tp_runs, got, name):
    """``got`` (an ``_eval_task`` result on rank 0) against one process on
    the same checkpoint: the same mAP and person AP, and the same
    detection dump (dump_<name> against dump_one_<name>)."""
    from tubelet_transformer_tpu_torch.train import loop

    cfg = got["cfg"]
    cfg.mesh.data, cfg.mesh.model = -1, 1
    want = runner.run_eval(cfg, device="cpu")
    _, loader = runner.make_loaders(cfg, val_only=True)
    loop.validate_ava(cfg, engine.make_eval_step(cfg, want["model"]),
                      want["model"], loader, epoch=0,
                      dump_dir=str(tp_runs["tmp"] / f"dump_one_{name}"))
    for k in ("mAP", "person_AP"):
        assert abs(got["val"][k] - want["val"][k]) <= 1e-6, k

    def rows(path):
        out = []
        for line in Path(path, "0.txt").read_text().splitlines():
            key, vals = line.split(" ", 1)
            out.append((key, np.asarray(vals.strip("[]").split(", "),
                                        np.float64)))
        return sorted(out, key=lambda r: (r[0], tuple(r[1])))

    a = rows(tp_runs["tmp"] / f"dump_{name}")
    b = rows(tp_runs["tmp"] / f"dump_one_{name}")
    assert len(a) == len(b) == 6 * cfg.model.query_num
    for (ka, va), (kb, vb) in zip(a, b):
        assert ka == kb
        np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-6)


def test_run_eval_under_tp_matches_one_process(tp_runs, one_torch_thread):
    """run_eval under MESH.MODEL 2 against one process on the same
    checkpoint: the same mAP and person AP, the same detection dump, and
    each keyframe gathered once (not once per model peer)."""
    got = tp_runs["runs"][0]["eval"]
    # two validations of 6 keyframes, one row a gather
    assert got["rows"] == [1] * 12
    _check_eval_against_one_process(tp_runs, got, "tp")


def test_run_eval_under_data_and_model_matches_one_process(
        tp_runs, one_torch_thread):
    """run_eval under MESH.DATA 2 x MESH.MODEL 2 (4 ranks) of a
    one-process checkpoint against one process on it: the loaders shard
    over the 2 data shards, each gather hands rank 0 DATA x VAL.BATCH_SIZE
    rows (each shard once, from its model index 0), and the validation
    equals one process's, detection for detection."""
    got = tp_runs["dm"][0]["eval"]
    cfg = got["cfg"]
    assert (cfg.mesh.data, cfg.mesh.model) == (2, 2)
    # two validations of 3 keyframes a shard
    assert got["rows"] == [2 * cfg.val.batch_size] * 6
    _check_eval_against_one_process(tp_runs, got, "dm")


def test_lfb_forward_under_tp_matches_one_process(tp_runs):
    """USE_LFB's ``lfb_attn`` splits like every attention, and the eval
    forward with a long-term memory (one row partly padded) under MESH.MODEL
    2 equals one process's, every output, on both peers."""
    for run in tp_runs["runs"]:
        got = run["lfb"]
        assert got["split"]
        assert {"pred_logits", "pred_boxes", "lfb_features"} <= set(
            got["diff"])
        for k, v in got["diff"].items():
            assert v <= 1e-5, (k, v)


def test_tp_checkpoint_resumes_in_one_process(tp_runs, one_torch_thread):
    """The TP run's checkpoint has the one-process layout (every model
    entry and every AdamW moment at its full shape) and resumes in one
    process for one finite step."""
    cfg = tp_runs["runs"][0]["eval"]["cfg"]
    cfg.mesh.data, cfg.mesh.model = -1, 1
    cfg.model.load, cfg.model.pretrained_path = False, ""
    state = runner.init_state(cfg, 4, torch.device("cpu"))
    sd = torch.load(tp_runs["ckpt"][0], weights_only=True)
    want = state.model.state_dict()
    assert sd["model"].keys() == want.keys()
    assert all(sd["model"][k].shape == v.shape for k, v in want.items())
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    assert sorted(sd["optimizer"]["state"]) == list(range(len(params)))
    for i, p in enumerate(params):
        for k in sharding_rules.MOMENTS:
            assert sd["optimizer"]["state"][i][k].shape == p.shape
    state, epoch, _ = ckpt_lib.load_checkpoint(tp_runs["ckpt"][0], state)
    assert epoch == 0 and state.step == 6
    metrics = engine.make_train_step(cfg, state)(engine.device_batch(
        tp_runs["resume_batch"], torch.device("cpu")), 1.0)
    assert float(metrics["finite"]) == 1.0


def test_one_process_checkpoint_resumes_under_tp(tp_runs, one_torch_thread):
    """A one-process checkpoint loads under MESH.MODEL 2: the gathered
    parameters and AdamW moments equal the file's bit for bit, and the
    next step (dropout on: every peer draws the one-process masks) equals
    the one-process step's from the same file."""
    got = [run["resume"] for run in tp_runs["runs"]]
    assert got[0]["same"] and got[1]["same"]
    cfg = _run_cfg(tp_runs["tmp"] / "one")
    state = runner.init_state(cfg, 4, torch.device("cpu"))
    ckpt_lib.load_checkpoint(tp_runs["one_ckpt"], state)
    want = engine.make_train_step(cfg, state)(engine.device_batch(
        tp_runs["resume_batch"], torch.device("cpu")), 1.0)
    for k in ("total_loss", "loss_ce", "loss_bbox", "grad_norm"):
        for g in got:
            assert abs(g["metrics"][k] - float(want[k])) <= SELF_TOL * abs(
                float(want[k])), (k, g["metrics"][k], float(want[k]))


def _zero1_checks(tp_runs):
    """Every rank's ``dp_check.zero1_check`` of ZeRO-1 beside MESH.MODEL."""
    dm = tp_runs["dm"]
    return [dm[0]["zero1"]["check"]] + [r["zero1"] for r in dm[1:]]


@pytest.mark.parametrize("step", [0, 1])
def test_zero1_with_model_matches_jax_zero1_mesh_step(tp_runs, step):
    """Each of two ZeRO-1 steps on DATA 2 x MODEL 2 (4 ranks) against JAX's
    ZeRO-1 step after ``shard_train_state(zero1=True)`` on a data-2 x
    model-2 mesh with ``state_shardings(..., zero1=True)`` pinned: the
    metrics, every parameter and every running statistic at
    test_torch_train_step.py's tolerances (each update from the state
    before this step), and the gathered moments (the replicated
    parameters' over the data group, the split ones' over the model
    group) against ``mu`` and ``nu`` through ``convert.py``, as
    tests/test_torch_zero1.py holds the DATA-only ZeRO-1 step; run where
    both steps' states are, on rank 0 of the ranks' job. Two things set
    apart, each with its reading: the moments of the two parameters whose
    gradient JAX's mesh step counts twice (the next test), and the second
    step's parameters, held within 2.2 lr of JAX's (_check_against_jax's
    own bound): the batch split parts layers 3-4's gradients by ~0.8%
    (their train-mode BNs amplify the rounding of the statistics'
    reduction; the moments hold at 1e-2), and where a second Adam
    update's m cancels that moves it by up to 1.3 lr (measured), past the
    1e-3 lr that holds the first step, as test_torch_train_step.py holds
    one step."""
    z = tp_runs["dm"][0]["zero1"]
    got = z["jax"]["steps"][step]
    assert z["finite"][step] == 1.0
    missed = got["missed"]
    if step:
        assert max(z["jax"]["second_update_lr"].values()) <= 2.2
        missed = [m for m in missed if not m.startswith("update of ")]
    assert missed == []
    assert got["names"] == got["want_names"]
    assert got["moment_errors"] == {}


def test_jax_mesh_step_counts_the_strided_depthwise_gradients_twice(
        tp_runs):
    """JAX's step on the data-2 x model-2 mesh gives the two strided
    depthwise convs (layer3.0 and layer4.0 ``conv3``) twice their
    gradient, and so twice the port's first mu, and no other parameter;
    the port's ZeRO-1 x MODEL step is bit-equal to its DATA x MODEL step,
    which equals its one process (``test_tp_step_matches_one_process``).
    (JAX's own steps on a data-1 x model-2, a data-2 x model-1 and a
    one-device mesh agree with the port there: a fault of the reference's
    partitioning of that conv's weight gradient, which the first step's
    sign-only Adam update hides from ``_check_against_jax``.)"""
    assert tp_runs["dm"][0]["zero1"]["jax"]["parted"].keys() == {
        "backbone.body.layer3.0.conv3.weight",
        "backbone.body.layer4.0.conv3.weight"}


def test_zero1_with_model_bit_equal_to_data_model_and_control_misses(
        tp_runs):
    """On each of the 4 ranks, after each of two steps: the ZeRO-1 x MODEL
    run's model and optimizer state dicts (the moments gathered over the
    data group, this peer's slices of the split ones) equal the DATA x
    MODEL run's bit for bit; the control without the all-gather
    differs."""
    checks = _zero1_checks(tp_runs)
    assert len(checks) == 4
    for check in checks:
        assert check["zero1_equal"] == [True, True]
        assert check["control_equal"] == [False, False]


def test_zero1_with_model_moment_bytes_are_jax_per_device_share(tp_runs):
    """Each rank's moment bytes (from its tensors) are JAX device 0's
    bytes of mu and nu over the trainable leaves and the figure from the
    shapes: half of each replicated parameter's two moments that the data
    axis shards, all of this peer's slice of each split one; so between
    half and all of the DATA x MODEL step's bytes."""
    jax_bytes = tp_runs["dm"][0]["zero1"]["jax"]["bytes"]
    for check in _zero1_checks(tp_runs):
        assert check["zero1_moment_bytes"] == jax_bytes
        assert check["zero1_moment_bytes"] == check["zero1_predicted_bytes"]
        assert check["data_moment_bytes"] == check["data_predicted_bytes"]
        assert check["control_moment_bytes"] == check["zero1_moment_bytes"]
        assert check["data_moment_bytes"] / 2 < check[
            "zero1_moment_bytes"] < check["data_moment_bytes"]


def test_zero1_with_model_checkpoint_resumes_in_one_process(
        tp_runs, one_torch_thread):
    """The checkpoint the 4 ranks wrote under ZeRO-1 x MODEL after two
    steps is one file in the one-process layout, and one process without
    ZeRO-1 loads it into the 4-rank run's state bit for bit; its step on
    the global batch against the 4-rank run's third step, with
    tests/test_torch_zero1.py's bounds (``check_resume_in_one_process``)."""
    check_resume_in_one_process(tp_runs["cases"]["data_model"],
                                tp_runs["dm"][0]["zero1"], tp_runs["batch3"])


def test_zero1_with_model_resumes_from_a_file_saved_without_it(tp_runs):
    """The DATA x MODEL run's file, loaded by a fresh ZeRO-1 x MODEL state
    of 4 ranks, gives the uninterrupted ZeRO-1 x MODEL run's third step
    bit for bit (compared on rank 0 of the ranks' job)."""
    assert tp_runs["dm"][0]["zero1"]["resumed_equal"] == {
        "metrics": True, "state": True, "moments": True}


def test_one_process_checkpoint_resumes_under_zero1_with_model(
        tp_runs, one_torch_thread):
    """A one-process checkpoint loads under MESH.ZERO1 with DATA 2 x
    MODEL 2: on every rank the model and AdamW state gathered over the
    data and model groups equal the file's bit for bit, and the next step
    (every dropout off: the data shards draw other masks than one
    process) on the global batch of 2 equals the one-process step's from
    the same file within SELF_TOL."""
    got = [r["resume"] for r in tp_runs["dm"]]
    assert all(g["same"] for g in got)
    cfg = copy.deepcopy(tp_runs["zero1_cfg"])
    cfg.mesh.data, cfg.mesh.model, cfg.mesh.zero1 = 1, 1, False
    state = runner.init_state(cfg, 4, torch.device("cpu"))
    tp_check._no_dropout(state.model)
    ckpt_lib.load_checkpoint(tp_runs["one_ckpt"], state)
    want = engine.make_train_step(cfg, state)(engine.device_batch(
        dp_check.global_batch(cfg, 2, seed=9), torch.device("cpu")), 1.0)
    for k in ("total_loss", "loss_ce", "loss_bbox", "grad_norm"):
        for g in got:
            assert abs(g["metrics"][k] - float(want[k])) <= SELF_TOL * abs(
                float(want[k])), (k, g["metrics"][k], float(want[k]))


@pytest.mark.parametrize("mesh", ["tp", "dm"])
def test_generate_lfb_over_the_mesh_matches_one_process(
        tp_runs, mesh, one_torch_thread):
    """generate_lfb of a one-process checkpoint under MESH.MODEL 2 (2
    ranks, "tp") and under DATA 2 x MODEL 2 (4 ranks, "dm") against one
    process on it: every rank's bank holds every keyframe of the
    one-process bank, each slot's features and actor probability within
    SELF_TOL, its validity the same except where a probability lies
    within SELF_TOL of the 0.8 gate; rank 0 alone saved, and its file
    holds its bank."""
    from tubelet_transformer_tpu_torch.eval.lfb import FeatureBank

    got = [r["bank"] for r in tp_runs["runs" if mesh == "tp" else "dm"]]
    cfg = _run_cfg(tp_runs["tmp"] / "one")
    cfg.model.load, cfg.model.pretrained_path = True, tp_runs["one_ckpt"]
    want = _recorded_bank(lambda: runner.run_generate_lfb(
        cfg, str(tp_runs["tmp"] / f"bank_one_{mesh}.npz"), device="cpu"))
    assert len(want["feats"]) == 6
    for rank, g in enumerate(got):
        assert g["saves"] == (rank == 0), rank
        assert g["feats"].keys() == want["feats"].keys()
        for key, w in want["feats"].items():
            scale = max(1.0, float(np.abs(w).max()))
            assert np.abs(g["feats"][key] - w).max() <= SELF_TOL * scale
            p = want["probs"][key]
            assert np.abs(g["probs"][key] - p).max() <= SELF_TOL, key
            far = np.abs(p - 0.8) > SELF_TOL
            assert np.array_equal(g["valid"][key][:len(p)][far],
                                  want["valid"][key][:len(p)][far]), key
    folder = tp_runs["tmp"] / f"bank_{mesh}"
    assert sorted(os.listdir(folder)) == ["bank.npz"]
    saved = FeatureBank.load(str(folder / "bank.npz"))
    assert saved._bank.keys() == got[0]["feats"].keys()
    for key, feats in got[0]["feats"].items():
        assert np.array_equal(saved._bank[key], feats)
        assert np.array_equal(saved._valid[key], got[0]["valid"][key])


def test_model_axis_refusals(tmp_path):
    """A train or eval step whose model is not split over the mesh's
    'model' axis raises ValueError naming MESH.MODEL; the serving CLI
    under MESH.MODEL in one process raises ValueError naming MESH.DATA x
    MODEL (the mesh has more peers than processes); generate_lfb
    under MESH.MODEL gets past its checks to the mesh (which one process
    cannot hold), and so it does with a 'pipe' axis beside it
    (tests/test_torch_data_parallel.py holds the other refusals)."""
    from test_torch_tuber import small_cfg

    from tubelet_transformer_tpu_torch.cli import serve
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    cfg = small_cfg()
    model = build_model(cfg, train=True)
    state = engine.create_train_state(cfg, model, 4)
    mesh = mesh_lib.Mesh(1, 0, 2)
    with pytest.raises(ValueError, match="MESH.MODEL 2"):
        engine.make_train_step(cfg, state, mesh=mesh)
    with pytest.raises(ValueError, match="MESH.MODEL 2"):
        engine.make_eval_step(cfg, model, mesh=mesh)
    cfg.mesh.model = 2
    cfg.model.load, cfg.model.pretrained_path = True, "unused.pth"
    with pytest.raises(ValueError, match="MESH.DATA x MODEL"):
        runner.run_generate_lfb(cfg, str(tmp_path / "bank.npz"),
                                device="cpu")
    cfg.mesh.pipe = 2
    with pytest.raises(ValueError, match="MESH.DATA x MODEL x PIPE"):
        runner.run_generate_lfb(cfg, str(tmp_path / "bank.npz"),
                                device="cpu")
    path = tmp_path / "mesh_serving.yaml"
    path.write_text("MESH:\n  MODEL: 2\n")
    argv = sys.argv
    sys.argv = ["serve", "--config-file", str(path), "--device", "cpu"]
    try:
        with pytest.raises(ValueError, match="MESH.DATA x MODEL"):
            serve.main()
    finally:
        sys.argv = argv


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
elif __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    jax_worker(sys.argv[2])
