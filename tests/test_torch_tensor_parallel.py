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
* The eval forward with long-term context (USE_LFB: ``lfb_attn`` split)
  equals one process's.
* ``run_training`` under MODEL 2 writes from rank 0 alone; ``run_eval``
  under MODEL 2, and under DATA 2 x MODEL 2 (4 ranks), equals the
  one-process validation, detection for detection, each keyframe gathered
  once; the TP checkpoint resumes in one
  process, and a one-process checkpoint resumes under TP, where the next
  step (dropout on) equals the one-process step's.
* The 'model' axis' refusals: a step whose model is not split over the
  mesh, the serving CLI and generate_lfb under MESH.MODEL.

Every subprocess runs under a timeout of at most 300 s and is killed when
it runs out.
"""

import glob
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401

from test_torch_data_parallel import (
    SELF_TOL, TIMEOUT, _ava_cfg, _check_against_jax, _jax_init, _kill,
    _run_cfg, _start, _ucf_cfg, _wait)
from tubelet_transformer_tpu_torch.cli import runner
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.parallel import sharding_rules
from tubelet_transformer_tpu_torch.tools import dp_check, tp_check
from tubelet_transformer_tpu_torch.train import checkpoint as ckpt_lib
from tubelet_transformer_tpu_torch.train import engine

# the parameters' updates of the TP step against one process: AdamW's
# first update is lr * g / (|g| + eps), so a gradient within a few eps of
# zero turns float32 rounding of g into an O(lr) change of its update;
# the four cases read 2.3e-6-1.3e-5 on the CPU, the control 0.66-1.07
UPDATE_TOL = 1e-4
CASES = ("ava", "ucf", "moe", "data_model")


# ---------------------------------------------------------------- worker

def _step_task(cfg, initial, batch):
    """tools/tp_check.run on this rank; on rank 0 what the tests read: the
    TP and control records (metrics, gathered gradients and state), the
    one-process metrics, the readings, the peers' equality, the split
    names and the all-reduce counts."""
    out = tp_check.run(cfg, torch.device("cpu"), initial=initial,
                       batch=batch)
    if out is None:
        return None
    return {**{k: out[k] for k in ("tp", "control", "readings",
                                   "peers_equal", "split", "launches")},
            "single": {"metrics": out["single"]["metrics"]}}


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


def _resume_task(cfg, path, batch):
    """A one-process checkpoint into the TP train state: whether the
    gathered model and optimizer state equal the file's bit for bit, and
    the metrics of one more step on ``batch``."""
    mesh = runner._mesh(cfg)
    state = runner.init_state(cfg, 4, torch.device("cpu"), mesh=mesh)
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


TASKS = {"step": _step_task, "train": _train_task, "eval": _eval_task,
         "resume": _resume_task, "lfb": _lfb_forward_task}


def worker(job_path):
    """Run the job's tasks in order on this rank; each rank writes its
    results to <out>.<rank>."""
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    mesh_lib.init_distributed("cpu", "gloo")
    try:
        results = {name: TASKS[kind](**kw) for name, (kind, kw)
                   in job["tasks"].items()}
        torch.save(results, f"{job['out']}.{mesh_lib.process_index()}")
    finally:
        mesh_lib.shutdown()


def jax_worker(job_path):
    """For each of the job's cases the initial variables (``_jax_init``)
    and the names JAX splits, written at once to <out>.<case> for the
    parent, which starts the port's ranks on them; then JAX's step on the
    case's ('data', 'model') mesh from those variables, every case's
    written to <out>.0."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    job = torch.load(job_path, weights_only=False)
    out, inits = {}, {}
    for name, (cfg, batch) in job["tasks"].items():
        inits[name] = _jax_init(cfg, batch)
        path = f"{job['out']}.{name}"
        torch.save({"initial": inits[name][3],
                    "split": _jax_split_names(cfg, inits[name][2])},
                   f"{path}.tmp")
        os.replace(f"{path}.tmp", path)
    for name, (cfg, batch) in job["tasks"].items():
        out[name] = _jax_tp_step(cfg, *inits[name][:3], batch)
    torch.save(out, f"{job['out']}.0")


# ---------------------------------------------------------------- parent

def _tp(cfg, data=1):
    """``cfg`` at tests/test_engine.py's transformer depth, on a
    data x 2 mesh."""
    cfg.model.enc_layers = cfg.model.dec_layers = 2
    cfg.mesh.data, cfg.mesh.model = data, 2
    return cfg


def _cases():
    moe = _ava_cfg()
    moe.model.temporal_ds_strategy = "avg"
    moe.model.moe_experts, moe.model.moe_top_k = 4, 2
    data_model = _ava_cfg()
    data_model.model.temporal_ds_strategy = "avg"
    return {"ava": _tp(_ava_cfg()), "ucf": _tp(_ucf_cfg()), "moe": _tp(moe),
            "data_model": _tp(data_model, data=2)}


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
    """Every multi-process run of this file: the JAX cases in two
    processes of their own, the train, eval and resume run of 2 ranks and
    the DATA 2 x MODEL 2 eval run of 4, started first; the port's ranks of
    each step case, launched as soon as its JAX process has written the
    case's initial variables."""
    tmp = tmp_path_factory.mktemp("tp")
    cases = _cases()
    batches = {k: dp_check.global_batch(c, 2 * c.mesh.data, seed=3)
               for k, c in cases.items()}
    # JHMDB: every box slot filled (test_torch_data_parallel.py: the JAX
    # matcher's float32 solve beside PAD_COST cannot order costs as close
    # as this random init's)
    batches["ucf"]["valid"][:] = True
    batches["ucf"]["vis"][:] = 1
    one_ckpt, resume_batch = _one_process_checkpoint(tmp)

    def run_cfg():
        cfg = _run_cfg(tmp / "runs")
        cfg.mesh.model = 2
        return cfg

    lfb_cfg = run_cfg()
    lfb_cfg.use_lfb = True

    launched = [_start(tmp, {
        "train": ("train", {"cfg": run_cfg()}),
        "eval": ("eval", {"cfg": run_cfg(),
                          "dump_dir": str(tmp / "dump_tp")}),
        "resume": ("resume", {"cfg": run_cfg(), "path": one_ckpt,
                              "batch": resume_batch}),
        "lfb": ("lfb", {"cfg": lfb_cfg, "seed": 10})}, "runs",
        script=__file__)]
    dm_cfg = run_cfg()
    dm_cfg.mesh.data = 2
    launched.append(_start(tmp, {"eval": ("eval", {
        "cfg": dm_cfg, "dump_dir": str(tmp / "dump_dm"),
        "path": one_ckpt})}, "runs_dm", world=4, script=__file__))
    inits, steps = {}, {}
    try:
        jax_jobs = [_start(tmp, {k: (cases[k], batches[k]) for k in ks},
                           name, world=1, mode="jax", script=__file__)
                    for name, ks in (("jax_a", ("ava", "ucf")),
                                     ("jax_b", ("moe", "data_model")))]
        launched += jax_jobs
        deadline = time.time() + TIMEOUT
        while len(steps) < len(cases):
            for k, cfg in cases.items():
                path = tmp / f"jax_{'a' if k in ('ava', 'ucf') else 'b'}" \
                    f".out.{k}"
                if k in steps or not path.exists():
                    continue
                inits[k] = torch.load(path, weights_only=False)
                steps[k] = _start(tmp, {k: ("step", {
                    "cfg": cfg, "initial": inits[k]["initial"],
                    "batch": batches[k]})}, f"step_{k}",
                    world=cfg.mesh.data * cfg.mesh.model, script=__file__)
                launched.append(steps[k])
            if len(steps) < len(cases):
                dead = [p.returncode for procs, _ in jax_jobs
                        for p, _ in procs if p.poll() not in (None, 0)]
                assert not dead and time.time() < deadline, \
                    f"JAX processes exited {dead} or timed out"
                time.sleep(0.5)
    except BaseException:
        for procs, _ in launched:
            _kill(procs)
        raise
    runs, logs = _wait(*launched[0])
    dm_eval = _wait(*launched[1])[0][0]["eval"]
    want = {**_wait(*jax_jobs[0])[0][0], **_wait(*jax_jobs[1])[0][0]}
    got = {k: _wait(*steps[k])[0][0][k] for k in cases}
    return {"cases": cases,
            "initial": {k: v["initial"] for k, v in inits.items()},
            "jax_split": {k: v["split"] for k, v in inits.items()},
            "want": want, "got": got,
            "runs": runs, "logs": logs, "dm_eval": dm_eval, "tmp": tmp,
            "one_ckpt": one_ckpt,
            "resume_batch": resume_batch,
            "ckpt": glob.glob(str(tmp / "runs" / "*" / "checkpoints" /
                                  "ckpt_*"))}


@pytest.mark.parametrize("case", CASES)
def test_tp_step_matches_jax_mesh_step(tp_runs, case):
    """The TP step against JAX's step on the same ('data', 'model') mesh,
    with test_torch_train_step.py's tolerances; the control misses them."""
    cfg = tp_runs["cases"][case]
    initial = tp_runs["initial"][case]
    got, want = tp_runs["got"][case], tp_runs["want"][case]
    assert got["tp"]["metrics"]["finite"] == 1.0
    if case == "moe":
        assert "loss_moe_aux" in want[0]
    assert _check_against_jax(cfg, initial, got["tp"], want) == []
    assert _check_against_jax(cfg, initial, got["control"], want) != []


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


@pytest.mark.parametrize("case", ["ava", "ucf", "moe"])
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
    got = tp_runs["dm_eval"]
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


def test_model_axis_refusals(tmp_path):
    """A train or eval step whose model is not split over the mesh's
    'model' axis raises ValueError naming MESH.MODEL; the serving CLI and
    generate_lfb under MESH.MODEL raise NotImplementedError naming it
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
    with pytest.raises(NotImplementedError, match="MESH.MODEL"):
        runner.run_generate_lfb(cfg, str(tmp_path / "bank.npz"),
                                device="cpu")
    path = tmp_path / "mesh_serving.yaml"
    path.write_text("MESH:\n  MODEL: 2\n")
    argv = sys.argv
    sys.argv = ["serve", "--config-file", str(path), "--device", "cpu"]
    try:
        with pytest.raises(NotImplementedError, match="MESH.MODEL"):
            serve.main()
    finally:
        sys.argv = argv


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
elif __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    jax_worker(sys.argv[2])
