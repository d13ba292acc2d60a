"""Data parallelism (MESH.DATA) of the PyTorch port over torch.distributed,
two ranks on the CPU over gloo, each a process started from this file
(``python tests/test_torch_data_parallel.py worker <job>``, torchrun's
environment set by hand).

* One DP step of 2 ranks x 2 clips against the JAX package's
  ``engine.make_train_step`` on a ``create_mesh(data=2)`` mesh of conftest's
  host devices, on the same global batch of 4 from the same variables (BN
  statistics randomised; CSN-TINY, TUNE_POINT 4, dropout off, float
  clips), with ``test_torch_train_step.py``'s tolerances: in AVA mode, in
  JHMDB mode with a rank whose clips hold no box, and with ACCUM_STEPS 2
  (JAX's microbatch i is global rows 2i, 2i+1; the port's is each rank's
  local row i, so JAX gets the global batch in microbatch-major order,
  rows 0, 2, 1, 3 of the ranks' concatenation). Each also against the
  port's own single-process step on the whole batch (``tools/dp_check.py``)
  to a tighter bound, and a control (each rank's own BN statistics and
  loss normalisers, the ranks' losses and gradients averaged) that must
  miss the bounds.
* The HSV jitter of two ranks differs for the same clip; rank 0 draws what
  one process draws.
* ``run_training`` and ``run_eval`` over 2 ranks: rank 0 alone writes the
  config, the metrics and the checkpoint; the validation equals the
  one-process validation of the same checkpoint, detection for detection.
* The refusals: ZERO1 beside MODEL > 1, PIPE > 1, SPATIAL, a MODEL that
  does not divide a split attention's heads, mesh serving, INFER_CHUNK x
  DATA, FROZEN_CHUNK x DATA, DATA x MODEL != world.
* Slow tier: SIGTERM to one rank stops both at the epoch boundary, and
  the relaunch resumes both from rank 0's choice.

Every subprocess runs under a timeout of at most 300 s and is killed when
it runs out.
"""

import glob
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401

from tubelet_transformer_tpu_torch.cli import runner
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.tools import dp_check
from tubelet_transformer_tpu_torch.train import engine
from tubelet_transformer_tpu_torch.train.optimizer import param_label

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
# the port's DP step against its own one-process step on the whole batch,
# float32 on the CPU: the two sum the same terms in other orders (the BN
# moments per rank, then over ranks; the gradients per rank, then over
# ranks), so they part at float32 rounding, ~1e-6 of each quantity
SELF_TOL = 2e-5


# ---------------------------------------------------------------- worker

def _jitter_task(cfg, seed):
    """One DP step on a uint8 clip that both ranks hold, with the clips
    the HSV jitter gave each rank; on rank 0 also one single-process step
    on it: (rank 0's, rank 1's, one process's) jittered clips."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    model = build_model(cfg, train=True)
    rng = np.random.default_rng(seed)
    batch = dp_check.global_batch(cfg, cfg.train.batch_size, seed)
    batch["clips"] = rng.integers(0, 256, batch["clips"].shape, np.uint8)
    seen = []
    pre = engine.device_preprocess

    def recording(*a, **k):
        seen.append(pre(*a, **k).detach().clone())
        return seen[-1]

    engine.device_preprocess = recording
    try:
        mesh = mesh_lib.create_mesh()
        for m in (mesh, mesh_lib.Mesh()) if mesh.rank == 0 else (mesh,):
            state = engine.create_train_state(cfg, model, steps_per_epoch=4)
            engine.make_train_step(cfg, state, mesh=m)(
                engine.device_batch(batch, torch.device("cpu")), 1.0)
            if m is mesh:
                ranks = mesh_lib.all_gather_host(seen[0].numpy())
    finally:
        engine.device_preprocess = pre
    return (*ranks, seen[1].numpy()) if mesh.rank == 0 else None


def _train_task(cfg):
    out = runner.run_training(cfg, device="cpu")
    return {"val": out["val"], "dirs": out["dirs"]}


def _eval_task(cfg, dump_dir):
    """run_eval of the newest checkpoint under LOG.BASE_PATH (rank 0's
    choice), then validate_ava of its model with a detection dump."""
    from tubelet_transformer_tpu_torch.train import checkpoint as ckpt_lib
    from tubelet_transformer_tpu_torch.train import loop

    cfg.model.load = True
    cfg.model.pretrained_path = mesh_lib.broadcast_string(
        ckpt_lib.latest_checkpoint_any_run(cfg.log.base_path))
    out = runner.run_eval(cfg, device="cpu")
    _, loader = runner.make_loaders(cfg, val_only=True)
    mesh = mesh_lib.create_mesh(cfg.mesh.data)
    loop.validate_ava(cfg, engine.make_eval_step(cfg, out["model"],
                                                 mesh=mesh),
                      out["model"], loader, epoch=0, dump_dir=dump_dir)
    return {"val": out["val"], "cfg": cfg}


def _step_task(cfg, initial, batch):
    return dp_check.run(cfg, torch.device("cpu"), initial=initial,
                        batch=batch)


TASKS = {"step": _step_task, "jitter": _jitter_task, "train": _train_task,
         "eval": _eval_task}


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


# ---------------------------------------------------------------- parent

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_worker(job_path):
    """JAX's step on a data-2 mesh for the job's case, from the initial
    variables ``_jax_init`` makes for ``init_cfg`` (the parent makes the
    same for the port), written to <out>.0: a process of its own, so that
    its compile overlaps the parent's."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    job = torch.load(job_path, weights_only=False)
    (kind, kw), = job["tasks"].values()
    init = _jax_init(kw["init_cfg"], kw["batch"])
    torch.save(_jax_mesh_step(kw["cfg"], *init[:3], kw["step_batch"]),
               f"{job['out']}.0")


def _start(tmp, tasks, name, world=2, mode="worker", script=__file__):
    """Start ``world`` processes of ``mode`` of ``script`` (this file by
    default) on ``tasks``: the ranks of a worker job, or the process of a
    JAX job; returns (procs, out prefix)."""
    job, out = tmp / f"{name}.job", tmp / f"{name}.out"
    torch.save({"tasks": tasks, "out": str(out)}, job)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   [str(ROOT), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")])}
        log = open(tmp / f"{name}.{rank}.log", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, script, mode, str(job)], cwd=ROOT,
            env=env, stdout=log, stderr=subprocess.STDOUT, text=True), log))
    return procs, out


def _kill(procs):
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


def _wait(procs, out, timeout=TIMEOUT):
    """Wait for every rank (killing them all when ``timeout`` runs out);
    raises unless each exited 0. Returns (results per rank, logs)."""
    deadline = time.time() + timeout
    logs = []
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        _kill(procs)
    for p, log in procs:
        log.seek(0)
        logs.append(log.read())
        log.close()
    for rank, ((p, _), text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n" \
                                  f"{text[-4000:]}"
    results = [torch.load(f"{out}.{r}", weights_only=False)
               for r in range(len(procs))]
    return results, logs


def _ava_cfg(accum=1):
    from test_torch_tuber import small_cfg

    cfg = small_cfg("decode")
    cfg.data.max_boxes = 4
    cfg.model.pretrained = True               # TUNE_POINT 4: stop_grad 2
    cfg.model.dropout = 0.0
    cfg.train.lr, cfg.train.lr_backbone = 1e-4, 1e-5
    cfg.train.batch_size = 2                  # per rank
    cfg.train.accum_steps = accum
    return cfg


def _ucf_cfg():
    from test_torch_jhmdb import small_cfg

    cfg = small_cfg()
    cfg.model.pretrained = True
    cfg.model.dropout = 0.0
    cfg.train.lr, cfg.train.lr_backbone = 1e-4, 1e-5
    return cfg


def _jax_init(cfg, batch):
    """The JAX model, its optimizer and its initial variables (BN
    statistics randomised), and the port's state dict of the same."""
    import flax.linen as fnn
    import jax
    from test_torch_csn import randomize_bn

    from tubelet_transformer_tpu.models.tuber import build_model as jbuild
    from tubelet_transformer_tpu.train import engine as jengine
    from tubelet_transformer_tpu_torch.convert import load_jax_variables
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    call = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        jmodel = jbuild(cfg)
        state, tx, _ = jengine.create_train_state(
            cfg, jmodel, jax.random.PRNGKey(0), batch, steps_per_epoch=10)
    finally:
        fnn.Dropout.__call__ = call
    params = jax.device_get(state.params)
    stats = jax.device_get(state.batch_stats)
    randomize_bn(params, stats, np.random.default_rng(1))
    state = state.replace(params=params, batch_stats=stats)
    sd = load_jax_variables(build_model(cfg, train=True), params,
                            stats).state_dict()
    return jmodel, tx, state, {k: v.clone() for k, v in sd.items()}


def _jax_mesh_step(cfg, jmodel, tx, state, batch):
    """JAX's train step on a data-2 mesh: (metrics, the port's state dict
    of the variables after it)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from tubelet_transformer_tpu.parallel import mesh as jmesh
    from tubelet_transformer_tpu.train import engine as jengine
    # the port's copy of the JAX package's conversion, which also names
    # the MoE encoder FFNs
    from tubelet_transformer_tpu_torch.convert import (
        tuber_torch_state_from_params)

    mesh = jmesh.create_mesh(data=2, devices=jax.devices()[:2])
    call = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        new_state, metrics = jengine.make_train_step(cfg, jmodel, tx)(
            # a copy: the step donates its state, which a later case reuses
            jax.device_put(jax.device_get(state), jmesh.replicated(mesh)),
            jmesh.shard_batch(batch, mesh), jax.random.PRNGKey(1),
            jnp.float32(cfg.loss.dice_cof))
        metrics, (params, stats) = jax.device_get(
            (metrics, (new_state.params, new_state.batch_stats)))
    finally:
        fnn.Dropout.__call__ = call
    m = cfg.model
    sd = tuber_torch_state_from_params(
        params, stats, block_nums=(1, 1, 1, 1), enc_layers=m.enc_layers,
        dec_layers=m.dec_layers, temporal_ds_strategy=m.temporal_ds_strategy,
        single_frame=m.single_frame, ddp_prefix=False)
    return {k: float(v) for k, v in metrics.items()}, sd


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Every multi-process run of the fast tier, in two launches of two
    ranks that run while the JAX steps compute: the jitter draws, the train
    run and the eval of its checkpoint, started first; and per case (ava,
    ucf, accum) the port's recorded runs (``dp_check.run``), beside JAX's
    metrics and state after, and the initial state."""
    tmp = tmp_path_factory.mktemp("dp")
    runs = _start(tmp, {
        "jitter": ("jitter", {"cfg": _ava_cfg(), "seed": 5}),
        "train": ("train", {"cfg": _run_cfg(tmp / "runs")}),
        "eval": ("eval", {"cfg": _run_cfg(tmp / "runs"),
                          "dump_dir": str(tmp / "dump_dp")})}, "runs")
    cases = {"ava": (_ava_cfg(), None), "ucf": (_ucf_cfg(), 2),
             "accum": (_ava_cfg(accum=2), None)}
    batches = {k: dp_check.global_batch(cfg, 4, seed=3, boxless_from=nb)
               for k, (cfg, nb) in cases.items()}
    # JHMDB: rank 0's clips fill every box slot. With padded target
    # columns the JAX matcher solves in float32 beside PAD_COST 1e6 (ulp
    # 0.0625) and cannot tell apart costs as close as this random init's
    # queries give (it took a query 0.045 dearer than the optimum for a
    # clip with one box, one process alike): the reference's _solve_rect
    # next to PAD_COST, which test_torch_criterion.py states
    batches["ucf"]["valid"][:2] = True
    batches["ucf"]["vis"][:2] = 1
    # JAX's ACCUM_STEPS step, from AVA's initial variables, in a process
    # of its own; its global batch in microbatch-major order: rows 0, 2,
    # 1, 3 of the ranks' concatenation
    accum = _start(tmp, {"accum": ("jax", {
        "cfg": cases["accum"][0], "init_cfg": cases["ava"][0],
        "batch": batches["ava"],
        "step_batch": dp_check.microbatch_major(batches["accum"], 2, 2)})},
        "accum_jax", world=1, mode="jax")
    steps = None
    try:
        inits = {k: _jax_init(cases[k][0], batches[k])
                 for k in ("ava", "ucf")}
        inits["accum"] = inits["ava"]
        steps = _start(tmp, {k: ("step", {
            "cfg": cases[k][0], "initial": inits[k][3],
            "batch": batches[k]}) for k in cases}, "steps")
        want = {k: _jax_mesh_step(cases[k][0], *inits[k][:3], batches[k])
                for k in ("ava", "ucf")}
    except BaseException:
        for launched in (runs, accum, steps):
            if launched:
                _kill(launched[0])
        raise
    bns = _bn_counts(cases["ava"][0])
    results, logs = _wait(*runs)
    got, _ = _wait(*steps)
    want["accum"] = _wait(*accum)[0][0]
    return {"cases": cases, "inits": inits, "want": want, "got": got[0],
            "bns": bns,
            "runs": results, "logs": logs, "tmp": tmp,
            "ckpt": glob.glob(str(tmp / "runs" / "*" / "checkpoints" /
                                  "ckpt_*"))}


def _bn_counts(cfg):
    """The train build's BNs, and how many of them train (CSN-TINY at
    TUNE_POINT 4, in every case)."""
    from tubelet_transformer_tpu_torch.models.csn import FoldableBN
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    model = build_model(cfg, train=True)
    engine.create_train_state(cfg, model, 4)       # freezes the prefix
    bns = [m for m in model.modules() if isinstance(m, FoldableBN)]
    return len(bns), sum(m.weight.requires_grad for m in bns)


def _run_cfg(base):
    from test_torch_tuber import small_cfg

    cfg = small_cfg("avg")
    cfg.model.pretrained = True
    cfg.data.dataset_name = "synthetic"
    cfg.data.synthetic_size = 6          # 3 per rank: a padded shard
    cfg.data.img_size = 32
    cfg.data.num_workers = 1
    cfg.train.batch_size = 1
    cfg.val.batch_size = 1
    cfg.train.epoch_num = 1
    cfg.val.freq = 1
    cfg.log.base_path = str(base)
    cfg.log.display_freq = 1
    return cfg


def _check_against_jax(cfg, initial, run, want):
    """test_torch_train_step.py's checks of one step against JAX's: the
    loss dict, the gradient norm, each parameter's update, the running
    statistics. Returns the list of what missed (empty: all held)."""
    metrics, want_sd = want
    missed = []
    got = run["metrics"]
    if set(got) != set(metrics):
        return [f"keys {sorted(set(got) ^ set(metrics))}"]
    for k in metrics:
        rtol = 1e-2 if k == "grad_norm" else 1e-4
        if not np.isclose(got[k], metrics[k], rtol=rtol, atol=1e-5):
            missed.append(f"{k}: {got[k]} vs {metrics[k]}")
    lr = {"main": cfg.train.lr, "backbone": cfg.train.lr_backbone}
    for name, g in run["grads"].items():
        label = param_label(name, cfg)
        old = initial[name].numpy()
        moved = run["state"][name].numpy() - old
        diff = np.abs(moved - (want_sd[name] - old))
        off = diff > 1e-3 * lr[label] + 2 * np.spacing(np.abs(old))
        if diff.max() > 2.2 * lr[label] or np.abs(
                g.numpy()[off]).max(initial=0) >= 1e-5:
            missed.append(f"update of {name}")
    for name in want_sd:
        if name.endswith(("running_mean", "running_var")) and not np.allclose(
                run["state"][name].numpy(), want_sd[name], rtol=1e-4,
                atol=1e-5):
            missed.append(name)
    return missed


@pytest.mark.parametrize("case", ["ava", "ucf", "accum"])
def test_dp_step_matches_jax_mesh_step(dp_runs, case):
    """The DP step of 2 ranks against JAX's step on a data-2 mesh, with
    test_torch_train_step.py's tolerances; the control misses them."""
    cfg = dp_runs["cases"][case][0]
    initial = dp_runs["inits"][case][3]
    got, want = dp_runs["got"][case], dp_runs["want"][case]
    dp = got["dp"]
    assert dp["metrics"]["finite"] == 1.0
    assert _check_against_jax(cfg, initial, dp, want) == []
    assert _check_against_jax(cfg, initial, got["control"], want) != []


@pytest.mark.parametrize("case", ["ava", "ucf", "accum"])
def test_dp_step_matches_one_process(dp_runs, case):
    """The DP step against the port's one-process step on the whole batch
    (SELF_TOL on every reading, the stem's statistics from the train-path
    statistics included); the control misses it by far."""
    got = dp_runs["got"][case]
    dp, control = got["readings"]["dp"], got["readings"]["control"]
    for k, v in dp.items():
        assert v <= SELF_TOL, (k, v)
    assert max(control.values()) > 100 * SELF_TOL, control
    assert control["stem_var_rel"] > SELF_TOL
    assert control["loss_rel"] > SELF_TOL
    if case == "ucf":
        # the boxless rank: the box losses are the global batch's
        assert got["dp"]["metrics"]["loss_bbox"] > 0
    # the all-reduces of a step: per microbatch each train-mode BN in the
    # forward, each trainable one in the backward and the criterion's 4
    # normalisers; then one of the flat gradients and one of the losses
    n_bn, n_trainable = dp_runs["bns"]
    accum = dp_runs["cases"][case][0].train.accum_steps
    assert got["dp"]["all_reduces"] == accum * (n_bn + n_trainable + 4) + 2
    assert got["control"]["all_reduces"] == 2


def test_jitter_draws_differ_by_rank(dp_runs):
    r0, r1, one = dp_runs["runs"][0]["jitter"]
    assert r0.shape == r1.shape and not np.allclose(r0, r1)
    np.testing.assert_array_equal(r0, one)


def test_run_training_writes_from_rank_zero(dp_runs):
    """One run directory, written by rank 0 alone: config.json, the
    metrics with train/total_loss and val/val_mAP_epoch, the checkpoint;
    rank 1 returns the losses alone."""
    r0, r1 = (run["train"] for run in dp_runs["runs"])
    assert r0["dirs"] == r1["dirs"]
    runs = glob.glob(str(dp_runs["tmp"] / "runs" / "*"))
    assert len(runs) == 1 and Path(runs[0], "config.json").is_file()
    assert len(dp_runs["ckpt"]) == 1
    lines = Path(r0["dirs"]["tb"], "metrics.jsonl").read_text().splitlines()
    tags = [json.loads(line)["tag"] for line in lines]
    assert {"train/total_loss", "val/val_mAP_epoch"} <= set(tags)
    # 6 samples, 3 per rank: 3 steps, each logged once
    assert tags.count("train/total_loss") == 3
    assert {"mAP", "person_AP"} <= set(r0["val"])
    assert set(r1["val"]) == {"loss_ce", "loss_ce_b", "loss_bbox",
                              "loss_giou"}
    assert "Epoch:" in dp_runs["logs"][0] and "Epoch:" not in \
        dp_runs["logs"][1]


def test_run_eval_matches_one_process(dp_runs, one_torch_thread):
    """run_eval over two ranks against one process on the same checkpoint:
    the same mAP and person AP, and the same detection dump."""
    from tubelet_transformer_tpu_torch.train import loop

    cfg = dp_runs["runs"][0]["eval"]["cfg"]
    cfg.mesh.data = -1
    want = runner.run_eval(cfg, device="cpu")
    _, loader = runner.make_loaders(cfg, val_only=True)
    loop.validate_ava(cfg, engine.make_eval_step(cfg, want["model"]),
                      want["model"], loader, epoch=0,
                      dump_dir=str(dp_runs["tmp"] / "dump_one"))
    got = dp_runs["runs"][0]["eval"]["val"]
    for k in ("mAP", "person_AP"):
        assert abs(got[k] - want["val"][k]) <= 1e-6, k

    def rows(path):
        out = []
        for line in Path(path, "0.txt").read_text().splitlines():
            key, vals = line.split(" ", 1)
            out.append((key, np.asarray(vals.strip("[]").split(", "),
                                        np.float64)))
        return sorted(out, key=lambda r: (r[0], tuple(r[1])))

    a, b = rows(dp_runs["tmp"] / "dump_dp"), rows(dp_runs["tmp"] / "dump_one")
    assert len(a) == len(b) == 6 * cfg.model.query_num
    for (ka, va), (kb, vb) in zip(a, b):
        assert ka == kb
        np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-6)


def test_refusals_name_their_option(tmp_path):
    """What the 'data' and 'model' axes do not cover raises, naming the
    option."""
    from test_torch_tuber import small_cfg

    from tubelet_transformer_tpu_torch.cli import serve_http
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.parallel import sharding_rules

    # MESH.ZERO1 runs on the 'data' axis (test_torch_zero1.py) and
    # MESH.MODEL alone on the 'model' axis (test_torch_tensor_parallel.py);
    # the two together are refused, naming both
    cfg = small_cfg()
    cfg.mesh.model = 2
    runner.check_supported(cfg)
    for attrs, name in ((dict(zero1=True, model=2),
                         "MESH.ZERO1 with MESH.MODEL"),
                        (dict(pipe=2), "MESH.PIPE"),
                        (dict(spatial=True), "MESH.SPATIAL")):
        cfg = small_cfg()
        for attr, value in attrs.items():
            setattr(cfg.mesh, attr, value)
        with pytest.raises(NotImplementedError, match=name):
            runner.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="MESH.PIPE"):
        mesh_lib.create_mesh(-1, 1, 2)
    # one process cannot hold two model peers
    with pytest.raises(ValueError, match="MESH.DATA x MODEL"):
        mesh_lib.create_mesh(-1, 2, 1)
    # a 'model' axis that does not divide a split attention's heads
    with pytest.raises(ValueError, match="MESH.MODEL 3"):
        sharding_rules.param_shardings(build_model(small_cfg(), train=True),
                                       mesh_lib.Mesh(1, 0, 3))
    # mesh serving
    path = tmp_path / "mesh_serving.yaml"
    path.write_text("MESH:\n  MODEL: 2\n")
    argv = sys.argv
    sys.argv = ["serve_http", "--config-file", str(path), "--device", "cpu"]
    try:
        with pytest.raises(NotImplementedError, match="MESH.MODEL"):
            serve_http.main()
    finally:
        sys.argv = argv
    # MoE runs with MESH.DATA > 1 (test_torch_zero1.py); INFER_CHUNK does
    # not, on any mesh
    cfg = small_cfg()
    cfg.model.moe_experts, cfg.model.moe_top_k = 4, 2
    state = engine.create_train_state(cfg, build_model(cfg, train=True), 4)
    cfg.model.infer_chunk = 2
    with pytest.raises(NotImplementedError, match="MODEL.INFER_CHUNK"):
        engine.make_train_step(cfg, state, mesh=mesh_lib.Mesh(data=2))
    cfg = small_cfg()
    cfg.train.frozen_chunk, cfg.mesh.data = 1, 2
    with pytest.raises(ValueError, match="TRAIN.FROZEN_CHUNK"):
        build_model(cfg, train=True)
    # one process, MESH.DATA 2
    with pytest.raises(ValueError, match="MESH.DATA"):
        mesh_lib.create_mesh(2)
    cfg = small_cfg()
    cfg.mesh.data = 2
    with pytest.raises(ValueError, match="MESH.DATA"):
        runner.run_training(cfg, device="cpu")


def test_one_process_mesh_is_the_identity():
    """Without torchrun's environment nothing is joined: one rank, and
    every collective returns its input."""
    mesh = mesh_lib.create_mesh()
    assert (mesh.data, mesh.rank) == (1, 0)
    t = torch.arange(3.0)
    assert mesh.batch_mean(t) is t and mesh.share_sum(t) is t
    assert mesh_lib.broadcast_string("x") == "x"
    assert mesh_lib.any_process(True) and not mesh_lib.any_process(False)
    g = mesh_lib.gather_global_tree({"a": np.ones((2, 3))})
    assert g["a"].shape == (2, 3)
    assert mesh_lib.gather_global(np.ones(2)).shape == (2,)
    assert mesh_lib.all_gather_host(np.ones(2)).shape == (2,)


def test_stem_statistics_rebuild_is_exact():
    """The frozen stem's E[y^2], rebuilt from the statistics' (mean, var)
    as var + mean^2 in float32, is their float32 E[y^2] exactly where var
    <= mean^2 and within an ulp elsewhere (the DP path reduces E[y^2])."""
    from tubelet_transformer_tpu_torch.ops.cuda import stem

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(2.0, 1.0, (1, 3, 16, 16, 3)).astype(
        np.float32))
    w = torch.from_numpy(rng.normal(0, 0.05, stem.W_SHAPE).astype(
        np.float32))
    mean, var = stem.stem_batch_stats(x, w)
    y = stem._conv(x, w)
    msq = y.square().mean((0, 2, 3, 4))
    rebuilt = var + mean.square()
    exact = var <= mean.square()
    assert exact.any() and (~exact).any()
    assert torch.equal(rebuilt[exact], msq[exact])
    ulp = torch.from_numpy(np.spacing(msq.numpy()))
    assert ((rebuilt - msq).abs() <= ulp).all()


@pytest.mark.slow
def test_sigterm_to_one_rank_stops_both_and_resumes(tmp_path):
    """SIGTERM to rank 1 alone: both ranks checkpoint the same epoch and
    stop; the relaunch with MODEL.LOAD resumes both from rank 0's choice,
    at the next epoch."""
    cfg = _run_cfg(tmp_path / "runs")
    cfg.train.epoch_num = 200
    cfg.val.freq = 1000
    procs, out = _start(tmp_path, {"train": ("train", {"cfg": cfg})},
                        "long")
    deadline = time.time() + TIMEOUT
    while time.time() < deadline and not glob.glob(
            str(tmp_path / "runs" / "*" / "checkpoints" / "ckpt_epoch_*")):
        if any(p.poll() is not None for p, _ in procs):
            break
        time.sleep(0.5)
    procs[1][0].send_signal(signal.SIGTERM)
    _, logs = _wait(procs, out)
    stopped = [re.search(r"preempted: checkpointed epoch (\d+)", t)
               for t in logs]
    assert all(stopped), logs[0][-2000:]
    assert stopped[0].group(1) == stopped[1].group(1)
    epoch = int(stopped[0].group(1))
    assert epoch < 199

    cfg.model.load = True
    cfg.train.epoch_num = epoch + 2
    procs, out = _start(tmp_path, {"train": ("train", {"cfg": cfg})},
                        "resume")
    _, logs = _wait(procs, out)
    resumed = [re.search(r"resumed from (\S+) at epoch (\d+)", t).groups()
               for t in logs]
    assert resumed[0] == resumed[1]
    assert int(resumed[0][1]) == epoch + 1


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
elif __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    jax_worker(sys.argv[2])
