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
* The refusals: SPATIAL where MODEL does not divide the clip's rows,
  mesh serving in one process (the mesh needs its processes), INFER_CHUNK
  x DATA, FROZEN_CHUNK x DATA, DATA x MODEL != world; ZERO1 beside MODEL
  and SPATIAL beside PIPE pass the check, and a MODEL that does not
  divide an attention's heads splits its projection by rows.
* Slow tier: SIGTERM to one rank stops both at the epoch boundary, and
  the relaunch resumes both from rank 0's choice.

The JAX steps run in processes of their own (at ``JAX_XLA_FLAGS``), each
writing a case's initial variables before its step, so that the port's
ranks start on them at once; the checks against JAX's step run on the
ranks' rank 0, which hands back the readings, not the states. Every
subprocess runs under a timeout of at most 300 s and is killed when it
runs out; the temporary files go when the module's tests end.
"""

import contextlib
import glob
import json
import os
import re
import shutil
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
# the JAX processes compile without LLVM's expensive passes: a step's
# compile then takes about 30% less CPU time, and its results are the
# default compile's bit for bit (the initial variables, the metrics and
# the state after a step, checked on the AVA and JHMDB TP cases)
JAX_XLA_FLAGS = "--xla_llvm_disable_expensive_passes=true"


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


def _step_task(cfg, initial_path, batch, want_path):
    """``dp_check.run`` from the JAX case's initial variables (the port's
    state dict, which its JAX process wrote to ``initial_path``); on rank
    0 the metrics, the all-reduce counts and the readings, and the checks
    of the DP and control steps against JAX's step (``want_path``), run
    here once JAX has written it, with JAX's metrics."""
    initial = _load(initial_path)["initial"]
    out = dp_check.run(cfg, torch.device("cpu"), initial=initial,
                       batch=batch)
    if out is None:
        return None
    return {"missed": Deferred(want_path, _missed, cfg, initial,
                               {k: out[k] for k in ("dp", "control")}),
            "jax_metrics": Deferred(want_path, lambda want: want[0]),
            "readings": out["readings"],
            **{k: {n: out[k][n] for n in ("metrics", "all_reduces")}
               for k in ("dp", "control")}}


TASKS = {"step": _step_task, "jitter": _jitter_task, "train": _train_task,
         "eval": _eval_task}


def _load(path):
    return torch.load(path, weights_only=False)


def _save(obj, path):
    """``torch.save`` under a temporary name, then renamed: a process that
    polls for ``path`` never reads a partial file."""
    torch.save(obj, f"{path}.tmp")
    os.replace(f"{path}.tmp", path)


def _failed(path) -> None:
    """Raise when a JAX process of ``path``'s directory failed (it leaves
    <out>.failed with its traceback)."""
    for marker in glob.glob(os.path.join(os.path.dirname(path), "*.failed")):
        raise RuntimeError(f"{marker}:\n{Path(marker).read_text()[-3000:]}")


def _ready(paths, timeout=TIMEOUT) -> None:
    """Wait until every one of ``paths`` exists; raises when a JAX process
    failed or ``timeout`` runs out."""
    deadline = time.time() + timeout
    while not all(os.path.exists(p) for p in paths):
        for p in paths:
            _failed(p)
        if time.time() > deadline:
            raise TimeoutError(f"waited {timeout} s for {paths}")
        time.sleep(0.2)


class Deferred:
    """A check that needs another process's output: ``fn(want, *args)``
    with ``want`` the object saved at ``path``, run once the job's tasks
    are done, so that waiting for it holds up no task."""

    def __init__(self, path, fn, *args):
        self.path, self.fn, self.args = path, fn, args

    def resolve(self):
        _ready([self.path])
        return self.fn(_load(self.path), *self.args)


def _missed(want, cfg, initial, runs):
    """``_check_against_jax`` of each of ``runs`` against JAX's step."""
    return {k: _check_against_jax(cfg, initial, run, want)
            for k, run in runs.items()}


@contextlib.contextmanager
def _timed(name):
    """Print the wall and CPU seconds of a task to the process's log."""
    wall, cpu = time.perf_counter(), time.process_time()
    yield
    print(f"task {name}: {time.perf_counter() - wall:.1f} s, CPU "
          f"{time.process_time() - cpu:.1f} s", flush=True)


def run_job(job_path, tasks):
    """Run the job's tasks on this rank, each from ``tasks`` by its kind;
    each rank writes its results to <out>.<rank>. A task whose arguments
    name files under "after" (another process's output) waits for them:
    the ranks take the tasks in the order rank 0 finds them ready. The
    ``Deferred`` checks in the results run last."""
    torch.set_num_threads(1)
    job = _load(job_path)
    mesh_lib.init_distributed("cpu", "gloo")
    try:
        pending, results = dict(job["tasks"]), {}
        while pending:
            name = _next_ready(pending) if mesh_lib.is_main_process() else ""
            name = mesh_lib.broadcast_string(name)
            kind, kw = pending.pop(name)
            with _timed(name):
                results[name] = tasks[kind](**{k: v for k, v in kw.items()
                                               if k != "after"})
        for r in results.values():
            for k, v in (r.items() if isinstance(r, dict) else ()):
                if isinstance(v, Deferred):
                    r[k] = v.resolve()
        torch.save(results, f"{job['out']}.{mesh_lib.process_index()}")
    finally:
        mesh_lib.shutdown()


def _next_ready(pending, timeout=TIMEOUT) -> str:
    """The first of the ``pending`` tasks whose "after" files all exist,
    once one does."""
    deadline = time.time() + timeout
    while True:
        for name, (_, kw) in pending.items():
            after = kw.get("after", ())
            if all(os.path.exists(p) for p in after):
                return name
            _failed(after[0])
        if time.time() > deadline:
            raise TimeoutError(f"waited {timeout} s for {list(pending)}")
        time.sleep(0.2)


def worker(job_path):
    run_job(job_path, TASKS)


def run_jax_job(job_path, tasks):
    """Run the job's JAX tasks in order in this process, with one dict
    that they share (the initial variables of each case, made once); each
    saves what the port's ranks wait for under <out>.<name>.*, and the
    summaries they return go to <out>.0. A failure leaves <out>.failed
    with its traceback, which ends the ranks' waits."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    job = _load(job_path)
    try:
        memo, summary = {}, {}
        for name, (kind, kw) in job["tasks"].items():
            with _timed(name):
                summary[name] = tasks[kind](memo, f"{job['out']}.{name}",
                                            **kw)
        torch.save(summary, f"{job['out']}.0")
    except BaseException:
        import traceback

        Path(f"{job['out']}.failed").write_text(traceback.format_exc())
        raise


# the ports handed to this process's jobs: jobs started at once could be
# given the same free port before the first of them binds it
_PORTS: set = set()


def _free_port():
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in _PORTS:
            _PORTS.add(port)
            return port


def _jax_init_task(memo, out, cfg, batch):
    """JAX's initial variables for ``cfg`` (``_jax_init``), kept for the
    process's later tasks; the port's state dict of them saved to
    <out>.init at once, for the port's ranks."""
    memo[out] = _jax_init(cfg, batch)
    _save({"initial": memo[out][3]}, f"{out}.init")


def _jax_step_task(memo, out, init, cfg, batch):
    """JAX's step on a data-2 mesh from the variables of the ``init``
    task (its <out>), saved to <out>.want."""
    _save(_jax_mesh_step(cfg, *memo[init][:3], batch), f"{out}.want")


JAX_TASKS = {"init": _jax_init_task, "step": _jax_step_task}


def jax_worker(job_path):
    run_jax_job(job_path, JAX_TASKS)


def _start(tmp, tasks, name, world=2, mode="worker", script=__file__):
    """Start ``world`` processes of ``mode`` of ``script`` (this file by
    default) on ``tasks``: the ranks of a worker job, or the process of a
    JAX job (at ``JAX_XLA_FLAGS``); returns (procs, out prefix)."""
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
        if mode == "jax":
            env["XLA_FLAGS"] = " ".join([env.get("XLA_FLAGS", ""),
                                         JAX_XLA_FLAGS]).strip()
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
    """Every multi-process run of the fast tier, started at once: a JAX
    process a case, which writes the case's initial variables first and
    then JAX's data-2 mesh step (accum from AVA's variables); and two
    ranks that run each case's
    ``dp_check.run`` as soon as its initial variables are written (and
    check it against JAX's step once that is written), and the jitter
    draws, the train run and the eval of its checkpoint while none is.
    The temporary files go when the module's tests end."""
    tmp = tmp_path_factory.mktemp("dp")
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
    # JAX's ACCUM_STEPS step from AVA's initial variables, its global
    # batch in microbatch-major order: rows 0, 2, 1, 3 of the ranks'
    # concatenation
    # one JAX process a case, each making the case's initial variables
    # (accum's from AVA's config: ava's) and then its step, so that no
    # process holds two steps' compiles (under a whole run's load they
    # came near the 300 s timeout)
    init_cfg = {"ava": "ava", "ucf": "ucf", "accum": "ava"}
    step_batch = {**batches,
                  "accum": dp_check.microbatch_major(batches["accum"], 2, 2)}
    jax_tasks = {f"jax_{k}": {
        "init": ("init", {"cfg": cases[init_cfg[k]][0],
                          "batch": batches[init_cfg[k]]}),
        "step": ("step", {"init": str(tmp / f"jax_{k}.out.init"),
                          "cfg": cases[k][0], "batch": step_batch[k]})}
        for k in cases}
    init = {k: f"jax_{k}.out.init" for k in cases}
    want = {k: f"jax_{k}.out.step" for k in cases}
    launched = []
    try:
        for name, tasks in jax_tasks.items():
            launched.append(_start(tmp, tasks, name, world=1, mode="jax"))
        # each step as soon as its initial variables are written; the
        # train and eval runs while none is
        launched.append(_start(tmp, {
            **{k: ("step", {
                "cfg": cases[k][0],
                "initial_path": str(tmp / f"{init[k]}.init"),
                "batch": batches[k], "want_path": str(tmp / f"{want[k]}.want"),
                "after": [str(tmp / f"{init[k]}.init")]}) for k in cases},
            "jitter": ("jitter", {"cfg": _ava_cfg(), "seed": 5}),
            "train": ("train", {"cfg": _run_cfg(tmp / "runs")}),
            "eval": ("eval", {"cfg": _run_cfg(tmp / "runs"),
                              "dump_dir": str(tmp / "dump_dp")})}, "ranks"))
        bns = _bn_counts(cases["ava"][0])
    except BaseException:
        for procs, _ in launched:
            _kill(procs)
        raise
    for job in launched[:3]:
        _wait(*job)
    results, logs = _wait(*launched[3])
    yield {"cases": cases, "got": results[0], "bns": bns,
           "runs": results, "logs": logs, "tmp": tmp,
           "ckpt": glob.glob(str(tmp / "runs" / "*" / "checkpoints" /
                                 "ckpt_*"))}
    shutil.rmtree(tmp, ignore_errors=True)


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
    test_torch_train_step.py's tolerances (``_check_against_jax``, run
    where both steps' states are, on rank 0 of the ranks' job); the
    control misses them."""
    got = dp_runs["got"][case]
    assert got["dp"]["metrics"]["finite"] == 1.0
    # _check_against_jax of each run, on the worker's rank 0 (_step_task)
    assert got["missed"]["dp"] == []
    assert got["missed"]["control"] != []


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

    # MESH.ZERO1 runs on the 'data' axis (test_torch_zero1.py), MESH.MODEL
    # on the 'model' axis, and the two together
    # (test_torch_tensor_parallel.py), SPATIAL beside MODEL
    # (test_torch_spatial.py; a no-op at MODEL 1), and a 'pipe' axis
    # beside them (test_torch_pipeline.py); SPATIAL beside a 'pipe' axis
    # runs too (test_torch_pipeline.py), and SPATIAL over a MODEL that
    # does not split the clip's rows is refused, naming the option, as
    # JAX's device_put refuses such a clip
    for attrs in (dict(model=2), dict(zero1=True, model=2, data=2),
                  dict(spatial=True), dict(spatial=True, model=2, data=2),
                  dict(zero1=True, model=2, pipe=2), dict(pipe=2)):
        cfg = small_cfg()
        for attr, value in attrs.items():
            setattr(cfg.mesh, attr, value)
        runner.check_supported(cfg)
    cfg = small_cfg()
    cfg.mesh.spatial, cfg.mesh.model, cfg.mesh.pipe = True, 2, 2
    runner.check_supported(cfg)
    cfg = small_cfg()
    cfg.mesh.spatial, cfg.mesh.model = True, 3
    with pytest.raises(ValueError, match="MESH.SPATIAL"):
        runner.check_supported(cfg)
    # one process cannot hold two pipe stages
    with pytest.raises(ValueError, match="MESH.DATA x MODEL x PIPE"):
        mesh_lib.create_mesh(-1, 1, 2)
    # one process cannot hold two model peers
    with pytest.raises(ValueError, match="MESH.DATA x MODEL"):
        mesh_lib.create_mesh(-1, 2, 1)
    # a 'model' axis that does not divide an attention's heads splits its
    # packed projection in contiguous row blocks where it divides 3E, as
    # JAX's param_shardings does: at MODEL 3 and d 64 every in_proj, and
    # no out_proj (64 rows) nor FFN (64 columns)
    specs = sharding_rules.param_shardings(
        build_model(small_cfg(), train=True), mesh_lib.Mesh(1, 0, 3))
    split = {k: v for k, v in specs.items() if v}
    assert split and all(k.endswith("in_proj_weight") for k in split)
    assert set(split.values()) == {sharding_rules.Split(0)}
    # mesh serving runs under torchrun (test_torch_mesh_serving.py): one
    # process cannot hold its model peers
    path = tmp_path / "mesh_serving.yaml"
    path.write_text("MESH:\n  MODEL: 2\n")
    argv = sys.argv
    sys.argv = ["serve_http", "--config-file", str(path), "--device", "cpu"]
    try:
        with pytest.raises(ValueError, match="MESH.DATA x MODEL"):
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
