"""Pipeline parallelism (MESH.PIPE) of the PyTorch port over
torch.distributed: the transformer encoder's layers as GPipe stages over
a 'pipe' axis, with the stage-to-stage carry, the encoder output's sum
over the pipe group and the encoder input's gradient sum written by hand
(``parallel/mesh.py``, ``parallel/pipeline.py``). Ranks on the CPU over
gloo, each a process started from this file (``python
tests/test_torch_pipeline.py worker <job>``, torchrun's environment set
by hand, as tests/test_torch_spatial.py starts them). CSN-TINY with a
2+1-layer transformer of width 64 (PIPE 2 takes an even encoder), avg
temporal pooling, float32, dropout off, TUNE_POINT 4.

* ``pipeline_apply`` against the JAX package's on the (data, model, pipe)
  layouts (1, 1, 2), (2, 1, 2) and (1, 2, 2): 4 encoder layers of width
  32, the output and the gradients of the layers and of the input for one
  random linear loss, float32, within 2e-5.
* The PIPE train step (``tools/tp_check.py``) on PIPE 2 and on DATA 2 x
  PIPE 2 against the JAX package's ``make_train_step`` after
  ``shard_train_state`` on the same mesh of conftest's host devices, from
  the same variables (BN statistics randomised; JAX's ``encoder_stack``
  crossed over through ``convert.py``) and batch, with
  ``test_torch_train_step.py``'s tolerances, and against the port's
  one-process step to SELF_TOL (updates to UPDATE_TOL); both controls (the
  carry zeroed; the encoder input's gradient not summed over the pipe
  group) miss; the replicated parameters of every rank of a data shard
  bit-equal after two steps; ZeRO-1 on DATA 2 x PIPE 2 bit-equal to the
  DATA x PIPE step, the encoder layers' moments the stage's.
* MESH.SPATIAL beside MESH.PIPE: the step on (data, model, pipe) = (1, 2,
  2), the clip's rows over each stage's model peers, against JAX's step
  on the same mesh after ``shard_batch(..., spatial=True)`` and against
  one process (the BN running statistics among the readings: averaged
  over one stage's data x model ranks), its four controls missing; the
  stage path's eval forward under it against one process's;
  ``run_training`` under it writes the one-process checkpoint.
* ``run_training`` under PIPE 2 writes from rank 0 alone, its checkpoint
  in the one-process layout, which resumes under PIPE 2 bit for bit;
  ``run_eval`` and ``generate_lfb`` under PIPE 2 equal one process's,
  detection for detection and slot for slot.
* Dropout in the pipelined encoder differs across data shards on
  identical samples, and is the same on the pipe peers and on a repeat.
* The dry run (``parallel/dryrun_steps.py``): its five axes in one
  2-rank launch, zero1's loss equal to the replicated run's, and dp_tp
  on 4 ranks (DATA 2 x MODEL 2).
* On one process: a JAX ``encoder_stack`` tree into the port bit for bit,
  the stack/unstack round trip against JAX's, and the refusals (layers
  that PIPE does not divide, a batch that the microbatches do not, MoE x
  PIPE, SPATIAL x PIPE over a MODEL that does not divide the clip's rows,
  a full resume across a PIPE change).

The JAX runs are three processes of their own (pipeline_apply; the PIPE
steps; the SPATIAL x PIPE step), each of which writes its inputs and
initial variables first; the checks against them run on the ranks' rank 0. Every
subprocess runs under a timeout of at most 300 s and is killed when it
runs out; the temporary files go when the module's tests end.
"""

import copy
import glob
import shutil
import sys

import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401

from test_torch_data_parallel import (
    SELF_TOL, Deferred, _ava_cfg, _kill, _load, _missed, _run_cfg, _save,
    _start, _wait, run_jax_job, run_job)
from test_torch_tensor_parallel import (
    UPDATE_TOL, _check_eval_against_one_process, _port_sd)
from tubelet_transformer_tpu_torch.cli import runner
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.tools import dp_check, tp_check
from tubelet_transformer_tpu_torch.train import checkpoint as ckpt_lib
from tubelet_transformer_tpu_torch.train import engine

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# pipeline_apply: the (data, model, pipe) layout and the microbatches
APPLY = {"pipe2": ((1, 1, 2), 2), "data2": ((2, 1, 2), 2),
         "model2": ((1, 2, 2), 4)}
D, NHEAD, FF, B, S, LAYERS = 32, 4, 64, 4, 6, 4
STEP_CASES = ("pipe", "data_pipe")
# MESH.SPATIAL beside MESH.PIPE: (data, model, pipe) = (1, 2, 2), the
# clip's rows over the model peers of each pipe stage
SPATIAL_PIPE = "spatial_pipe"


# ---------------------------------------------------------------- worker

def _port_layer(tree):
    """The port's EncoderLayer holding a flax EncoderLayer's params."""
    from tubelet_transformer_tpu_torch.convert import _put_encoder_layer
    from tubelet_transformer_tpu_torch.models.layers import EncoderLayer

    sd = {}
    _put_encoder_layer(sd, "l", tree)
    layer = EncoderLayer(D, NHEAD, FF)
    layer.load_state_dict({k[2:]: torch.from_numpy(np.asarray(v))
                           for k, v in sd.items()})
    return layer


def _apply_task(case, want_path):
    """The port's ``pipeline_apply`` on this rank's data shard and stage
    with the JAX process's layers and inputs; on rank 0 the largest
    differences from JAX's of the output, the input's gradient and every
    layer's gradient (summed over the data shards)."""
    from tubelet_transformer_tpu_torch.convert import _put_encoder_layer
    from tubelet_transformer_tpu_torch.parallel.pipeline import (
        pipeline_apply)

    want = _load(want_path)
    (d, m, p), microbatches = APPLY[case]
    mesh = mesh_lib.create_mesh(d, m, p)
    x, mask, pos, g = (torch.from_numpy(a) for a in want["inputs"])
    b = B // d
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    per = LAYERS // p
    first = mesh.pipe_index * per
    layers = [_port_layer(want["layers"][first + i]) for i in range(per)]
    xs = x[rows].clone().requires_grad_()
    y = pipeline_apply(
        lambda i, yy, aux, mb: layers[i](yy, key_padding_mask=aux["mask"],
                                         pos=aux["pos"]),
        per, xs, {"mask": mask[rows], "pos": pos[rows]}, mesh, microbatches)
    (y * g[rows]).sum().backward()
    grads = {f"{first + i}.{k}": mesh.share_sum(t.grad)
             for i, layer in enumerate(layers)
             for k, t in layer.named_parameters()}
    every = mesh_lib.all_gather_objects({
        "y": y.detach().numpy(), "grad_x": xs.grad.numpy(),
        "grads": {k: v.numpy() for k, v in grads.items()}})
    if mesh.rank:
        return None
    n = m * p
    shards = [every[k * n] for k in range(d)]
    jax_grads = {}
    for i, tree in enumerate(want["want"][case]["grad_layers"]):
        sd = {}
        _put_encoder_layer(sd, str(i), tree)
        jax_grads.update(sd)
    port_grads = {k: v for e in every for k, v in e["grads"].items()}
    w = want["want"][case]
    return {"y": float(np.abs(np.concatenate([s["y"] for s in shards])
                              - w["y"]).max()),
            "grad_x": float(np.abs(np.concatenate(
                [s["grad_x"] for s in shards]) - w["grad_x"]).max()),
            "grads": max(float(np.abs(port_grads[k] - v).max())
                         for k, v in jax_grads.items()),
            "n_grads": (len(port_grads), len(jax_grads))}


def _step_task(cfg, batch, initial_path, want_path, zero1=False,
               eval_stages=False):
    """tools/tp_check.run from the JAX case's initial variables; on the
    reporter (the last stage of data shard 0) the readings, the peers'
    equality, the metrics, every rank's encoder bytes, the ZeRO-1 check,
    with ``eval_stages`` the stage path's eval forward against one
    process's (tp_check's ``eval_check``), and the checks of its state
    against JAX's step (``want_path``), run here once JAX has written
    it."""
    initial = _load(initial_path)["initial"]
    out = tp_check.run(cfg, torch.device("cpu"), initial=initial,
                       batch=batch, zero1=zero1, eval_stages=eval_stages)
    if out is None:
        return None
    names = ("tp", *out["controls"])
    return {**{k: out[k] for k in ("readings", "peers_equal", "peers_agree",
                                   "controls", "mesh", "encoder_bytes",
                                   "one_process_encoder_bytes", "launches")},
            "zero1": out.get("zero1"),
            "eval_stages": out.get("eval"),
            "metrics": {k: out[k]["metrics"] for k in names},
            "single": out["single"]["metrics"],
            "missed": Deferred(want_path, _missed, cfg, initial,
                               {k: out[k] for k in names}),
            "jax_metrics": Deferred(want_path, lambda w: w[0])}


def _train_task(cfg):
    out = runner.run_training(cfg, device="cpu")
    return {"val": out["val"], "dirs": out["dirs"]}


def _eval_task(cfg, dump_dir):
    """run_eval under PIPE of the newest checkpoint under LOG.BASE_PATH
    (rank 0's choice), then validate_ava of its model with a detection
    dump."""
    from tubelet_transformer_tpu_torch.train import loop

    cfg.model.load = True
    cfg.model.pretrained_path = mesh_lib.broadcast_string(
        ckpt_lib.latest_checkpoint_any_run(cfg.log.base_path))
    out = runner.run_eval(cfg, device="cpu")
    mesh = runner._mesh(cfg)
    _, loader = runner.make_loaders(cfg, val_only=True)
    loop.validate_ava(cfg, engine.make_eval_step(cfg, out["model"],
                                                 mesh=mesh),
                      out["model"], loader, epoch=0, dump_dir=dump_dir)
    return {"val": out["val"], "cfg": cfg, "stages": len(
        out["model"].transformer.stage_layers())}


def _resume_task(cfg, batch):
    """The newest checkpoint under LOG.BASE_PATH (the PIPE 2 run's, rank
    0's choice) resumed under PIPE 2: test_torch_tensor_parallel's
    ``_resume_task`` (the gathered state against the file's, bit for
    bit, then one more step)."""
    from test_torch_tensor_parallel import _resume_task as resume

    path = mesh_lib.broadcast_string(
        ckpt_lib.latest_checkpoint_any_run(cfg.log.base_path))
    return resume(cfg, path, batch, no_dropout=True)


def _bank_task(cfg, out):
    """generate_lfb under PIPE of the newest checkpoint: the bank rank 0
    writes."""
    cfg.model.load = True
    cfg.model.pretrained_path = mesh_lib.broadcast_string(
        ckpt_lib.latest_checkpoint_any_run(cfg.log.base_path))
    runner.run_generate_lfb(cfg, out, device="cpu")
    return {"cfg": cfg, "path": out}


def _dropout_task(seed):
    """The pipelined encoder of a 4-layer transformer (dropout 0.5) in
    training on DATA 2 x PIPE 2, on the same samples on both data shards,
    its generator seeded as the train step seeds it: on rank 0 every
    rank's output and a repeat of rank 0's."""
    from tubelet_transformer_tpu_torch.models.layers import Dropout
    from tubelet_transformer_tpu_torch.models.transformer import Transformer
    from tubelet_transformer_tpu_torch.models.tuber import init_weights

    mesh = mesh_lib.create_mesh(2, 1, 2)
    tr = Transformer(D, NHEAD, LAYERS, 1, FF, dropout=0.5)
    init_weights(tr, torch.Generator().manual_seed(0))
    tr.set_pipeline(mesh, 2)
    tr.train()
    generator = torch.Generator()
    for m in tr.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    tr.set_dropout_generator(generator)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, S, D)).astype(np.float32))
    pos = torch.from_numpy(rng.normal(size=(2, S, D)).astype(np.float32))
    outs = []
    for _ in range(2):
        generator.manual_seed(engine.step_seed(0, 0, mesh.data_index))
        outs.append(tr._pipelined_encoder(x, None, pos).detach().numpy())
    every = mesh_lib.all_gather_objects(outs[0])
    return {"ranks": every, "repeat": outs[1]} if mesh.rank == 0 else None


def _dryrun_task(axes):
    """``dryrun_steps.run_axis`` of each of ``axes`` over this launch's
    ranks: their summary lines."""
    from tubelet_transformer_tpu_torch.parallel import dryrun_steps

    return [dryrun_steps.run_axis(a, mesh_lib.process_count(), "cpu")
            for a in axes]


TASKS = {"apply": _apply_task, "step": _step_task, "train": _train_task,
         "eval": _eval_task, "resume": _resume_task, "bank": _bank_task,
         "dropout": _dropout_task, "dryrun": _dryrun_task}


def worker(job_path):
    run_job(job_path, TASKS)


def _no_jax_dropout():
    """flax's Dropout as the identity, for the duration of a block."""
    import contextlib

    import flax.linen as fnn

    @contextlib.contextmanager
    def off():
        call = fnn.Dropout.__call__
        fnn.Dropout.__call__ = lambda self, x, *a, **k: x
        try:
            yield
        finally:
            fnn.Dropout.__call__ = call

    return off()


def _jax_mesh(cfg):
    import jax

    from tubelet_transformer_tpu.parallel import mesh as jmesh

    n = cfg.mesh.data * cfg.mesh.model * cfg.mesh.pipe
    return jmesh.create_mesh(data=cfg.mesh.data, model=cfg.mesh.model,
                             pipe=cfg.mesh.pipe, devices=jax.devices()[:n])


def _jax_apply_task(memo, out, seed):
    """JAX's ``pipeline_apply`` of LAYERS EncoderLayers on each APPLY
    layout: the inputs, the layers' params and, per layout, the output and
    the gradients of one random linear loss, saved to <out>.want."""
    import jax

    from tubelet_transformer_tpu.models.layers import EncoderLayer
    from tubelet_transformer_tpu.parallel import mesh as jmesh
    from tubelet_transformer_tpu.parallel.pipeline import (
        pipeline_apply, stack_layer_params, unstack_layer_params)

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    mask = rng.uniform(size=(B, S)) < 0.2
    pos = rng.normal(size=(B, S, D)).astype(np.float32)
    g = rng.normal(size=(B, S, D)).astype(np.float32)
    layer = EncoderLayer(D, NHEAD, FF, dropout=0.0)
    trees = [jax.device_get(layer.init({"params": k}, x, mask, pos)[
        "params"]) for k in jax.random.split(jax.random.PRNGKey(0), LAYERS)]
    stacked = stack_layer_params(trees)

    def layer_fn(p, xx, aux, r):
        return layer.apply({"params": p}, xx, aux["mask"], aux["pos"], True)

    want = {}
    for case, ((d, m, p), microbatches) in APPLY.items():
        mesh = jmesh.create_mesh(d, m, p, devices=jax.devices()[:d * m * p])

        def loss(st, xx, mesh=mesh, microbatches=microbatches):
            y = pipeline_apply(layer_fn, st, xx, {"mask": mask, "pos": pos},
                               mesh, microbatches)
            return (y * g).sum(), y

        (_, y), (g_st, g_x) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(stacked, x)
        want[case] = jax.device_get({
            "y": y, "grad_x": g_x,
            "grad_layers": unstack_layer_params(g_st, LAYERS)})
    _save({"inputs": (x, mask, pos, g), "layers": trees, "want": want},
          f"{out}.want")


def _jax_init_task(memo, out, cfg, batch):
    """The JAX PIPE model's initial variables on ``cfg``'s mesh (BN
    statistics randomised: the encoder layers stacked in
    ``encoder_stack``), kept for the later steps; the port's one-process
    state dict of them and the stacked trees saved to <out>.init."""
    import jax
    from test_torch_csn import randomize_bn

    from tubelet_transformer_tpu.models.tuber import build_model as jbuild
    from tubelet_transformer_tpu.train import engine as jengine
    from tubelet_transformer_tpu_torch.convert import load_jax_variables
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    with _no_jax_dropout():
        state, tx, _ = jengine.create_train_state(
            cfg, jbuild(cfg, mesh=_jax_mesh(cfg)), jax.random.PRNGKey(0),
            batch, steps_per_epoch=10)
    params = jax.device_get(state.params)
    stats = jax.device_get(state.batch_stats)
    randomize_bn(params, stats, np.random.default_rng(1))
    state = state.replace(params=params, batch_stats=stats)
    sd = load_jax_variables(build_model(tp_check.one_process(cfg),
                                        train=True), params,
                            stats).state_dict()
    memo[out] = (tx, state)
    _save({"initial": {k: v.clone() for k, v in sd.items()},
           "params": params, "stats": stats}, f"{out}.init")


def _jax_step_task(memo, out, init, cfg, batch):
    """JAX's train step after ``shard_train_state`` on the case's
    ('data', 'model', 'pipe') mesh from the ``init`` task's variables, the
    clips' H axis over 'model' with MESH.SPATIAL (``shard_batch(...,
    spatial=True)``):
    (metrics, the port's state dict of the variables after it), saved to
    <out>.want."""
    import jax
    import jax.numpy as jnp

    from tubelet_transformer_tpu.models.tuber import build_model as jbuild
    from tubelet_transformer_tpu.parallel import mesh as jmesh
    from tubelet_transformer_tpu.parallel.sharding_rules import (
        shard_train_state)
    from tubelet_transformer_tpu.train import engine as jengine

    tx, state = memo[init]
    mesh = _jax_mesh(cfg)
    with _no_jax_dropout():
        new_state, metrics = jengine.make_train_step(
            cfg, jbuild(cfg, mesh=mesh), tx)(
            shard_train_state(jax.device_get(state), mesh),
            jmesh.shard_batch(batch, mesh, spatial=cfg.mesh.spatial),
            jax.random.PRNGKey(1), jnp.float32(cfg.loss.dice_cof))
        metrics, (params, stats) = jax.device_get(
            (metrics, (new_state.params, new_state.batch_stats)))
    _save(({k: float(v) for k, v in metrics.items()},
           _port_sd(cfg, params, stats)), f"{out}.want")


JAX_TASKS = {"apply": _jax_apply_task, "init": _jax_init_task,
             "step": _jax_step_task}


def jax_worker(job_path):
    run_jax_job(job_path, JAX_TASKS)


# ---------------------------------------------------------------- parent

def _pp(cfg, data=1):
    """``cfg`` with a 2+1-layer transformer on a data x 1 x 2 mesh, two
    microbatches."""
    cfg.model.enc_layers, cfg.model.dec_layers = 2, 1
    cfg.model.temporal_ds_strategy = "avg"
    cfg.mesh.data, cfg.mesh.pipe, cfg.mesh.pipe_microbatches = data, 2, 2
    return cfg


def _run_pp_cfg(base):
    """``_run_cfg`` under PIPE 2: a 2+1-layer transformer, batches of 2
    clips (one a microbatch), 6 clips."""
    cfg = _pp(_run_cfg(base))
    cfg.train.batch_size = cfg.val.batch_size = 2
    return cfg


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """Every multi-process run of this file, started at once: three JAX
    processes (pipeline_apply on each layout; the PIPE model's initial
    variables, then its step on the 1 x 1 x 2 and 2 x 1 x 2 meshes; the
    same variables, then the step with the rows split on 1 x 2 x 2); 2
    ranks of PIPE 2 that train, evaluate and generate a bank, run the dry
    run's five axes, then pipeline_apply and the PIPE step as soon as
    JAX's inputs are written; 4 ranks that run the dry run's dp_tp, the
    dropout draws, pipeline_apply on (2, 1, 2) and (1, 2, 2), the DATA 2 x
    PIPE 2 step with ZeRO-1 beside it, the SPATIAL x PIPE step and a
    train run under it. The temporary files go when the module's tests
    end."""
    tmp = tmp_path_factory.mktemp("pp")
    spatial = _pp(_ava_cfg())
    spatial.mesh.model, spatial.mesh.spatial = 2, True
    cases = {"pipe": _pp(_ava_cfg()), "data_pipe": _pp(_ava_cfg(), data=2),
             SPATIAL_PIPE: spatial}
    batches = {k: dp_check.global_batch(c, 2 * c.mesh.data, seed=3)
               for k, c in cases.items()}
    # pipeline_apply, the PIPE steps and the SPATIAL x PIPE step (from the
    # same variables) in three JAX processes, so that none nears its
    # timeout under the whole tier's load
    job = {**{k: "jax" for k in STEP_CASES}, SPATIAL_PIPE: "jax_sp"}
    jax_tasks = {"jax_apply": {"apply": ("apply", {"seed": 2})},
                 "jax": {}, "jax_sp": {}}
    for name in job.values():
        jax_tasks[name]["init"] = ("init", {"cfg": cases["pipe"],
                                            "batch": batches["pipe"]})
    for k, name in job.items():
        jax_tasks[name][f"{k}_step"] = ("step", {
            "init": str(tmp / f"{name}.out.init"), "cfg": cases[k],
            "batch": batches[k]})

    def apply(case):
        want = str(tmp / "jax_apply.out.apply.want")
        return ("apply", {"case": case, "want_path": want, "after": [want]})

    def step(case):
        init = str(tmp / f"{job[case]}.out.init.init")
        return ("step", {"cfg": cases[case], "batch": batches[case],
                         "initial_path": init,
                         "want_path": str(tmp / f"{job[case]}.out.{case}"
                                                "_step.want"),
                         "zero1": case == "data_pipe",
                         "eval_stages": case == SPATIAL_PIPE,
                         "after": [init]})

    run_cfg = _run_pp_cfg(tmp / "runs")
    sp_run_cfg = _run_pp_cfg(tmp / "sp_runs")
    sp_run_cfg.mesh.model, sp_run_cfg.mesh.spatial = 2, True
    launched = []
    try:
        for name, tasks in jax_tasks.items():
            launched.append(_start(tmp, tasks, name, world=1, mode="jax",
                                   script=__file__))
        launched.append(_start(tmp, {
            "train": ("train", {"cfg": run_cfg}),
            "eval": ("eval", {"cfg": copy.deepcopy(run_cfg),
                              "dump_dir": str(tmp / "dump_pp")}),
            "resume": ("resume", {"cfg": copy.deepcopy(run_cfg),
                                  "batch": dp_check.global_batch(
                                      run_cfg, 2, seed=9)}),
            "bank": ("bank", {"cfg": copy.deepcopy(run_cfg),
                              "out": str(tmp / "bank_pp.npz")}),
            "dryrun": ("dryrun", {"axes": ("dp_tp", "sp", "ep", "pp",
                                           "zero1")}),
            "pipe2": apply("pipe2"), "pipe": step("pipe")},
            "ranks", script=__file__))
        launched.append(_start(tmp, {
            "dryrun": ("dryrun", {"axes": ("dp_tp",)}),
            "dropout": ("dropout", {"seed": 4}),
            "data2": apply("data2"), "model2": apply("model2"),
            "data_pipe": step("data_pipe"),
            SPATIAL_PIPE: step(SPATIAL_PIPE),
            "train": ("train", {"cfg": sp_run_cfg})}, "four", world=4,
            script=__file__))
    except BaseException:
        for procs, _ in launched:
            _kill(procs)
        raise
    for jax_job in launched[:len(jax_tasks)]:
        _wait(*jax_job)
    n = len(jax_tasks)
    runs, logs = _wait(*launched[n])
    four = _wait(*launched[n + 1])[0]
    # the steps' readings are on their reporter, the last stage of data
    # shard 0: rank 1
    got = {**runs[0], **four[0], "pipe": runs[1]["pipe"],
           "data_pipe": four[1]["data_pipe"],
           SPATIAL_PIPE: four[1][SPATIAL_PIPE]}
    yield {"cases": cases, "got": got, "runs": runs, "four": four,
           "logs": logs, "tmp": tmp,
           "init": _load(str(tmp / "jax.out.init.init")),
           "sp_ckpt": glob.glob(str(tmp / "sp_runs" / "*" / "checkpoints" /
                                    "ckpt_*")),
           "sp_run_cfg": sp_run_cfg,
           "ckpt": glob.glob(str(tmp / "runs" / "*" / "checkpoints" /
                                 "ckpt_*"))}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("case", list(APPLY))
def test_pipeline_apply_matches_jax(pp_runs, case):
    """The port's pipeline_apply on each (data, model, pipe) layout against
    JAX's on the same layers and inputs: the output, the input's gradient
    and every layer's gradient (summed over the data shards) within 2e-5,
    every layer's gradient there."""
    got = pp_runs["got"][case]
    assert got["n_grads"][0] == got["n_grads"][1] == 12 * LAYERS
    for k in ("y", "grad_x", "grads"):
        assert got[k] <= 2e-5, (k, got)


@pytest.mark.parametrize("case", STEP_CASES)
def test_pipe_step_matches_jax_mesh_step(pp_runs, case):
    """The PIPE step against JAX's step on the same ('data', 'model',
    'pipe') mesh, with test_torch_train_step.py's tolerances
    (``_check_against_jax`` of the last stage's state, run on that rank,
    the reporter); the zero-carry control misses them. (The control
    without the input's gradient sum is held to the one-process step's
    tighter tolerances, where it misses: the next test.)"""
    got = pp_runs["got"][case]
    assert got["mesh"] == (pp_runs["cases"][case].mesh.data, 1, 2)
    assert got["metrics"]["tp"]["finite"] == 1.0
    assert got["missed"]["tp"] == [], got["missed"]["tp"]
    assert got["missed"]["zero_carry"] != []


@pytest.mark.parametrize("case", STEP_CASES)
def test_pipe_step_matches_one_process(pp_runs, case):
    """The PIPE step, read on the last stage, against the port's
    one-process step on the whole batch: every reading within SELF_TOL,
    the updates within UPDATE_TOL. The zero-carry control misses in its
    losses and gradients; the control without the input's gradient sum
    has the step's forward and misses in the gradients and updates of
    the replicated parameters that the encoder's input reaches."""
    got = pp_runs["got"][case]
    assert got["controls"] == ["zero_carry", "no_input_sum"]
    readings = got["readings"]
    for k, v in readings["tp"].items():
        assert v <= (UPDATE_TOL if k == "update_rel" else SELF_TOL), (k, v)
    for k in ("loss_rel", "grads_rel", "update_rel"):
        assert readings["zero_carry"][k] > 100 * SELF_TOL, (k, readings)
    no_sum = readings["no_input_sum"]
    assert no_sum["loss_rel"] == readings["tp"]["loss_rel"]
    assert no_sum["grads_rel"] > 100 * SELF_TOL, no_sum
    assert no_sum["update_rel"] > 100 * UPDATE_TOL, no_sum


@pytest.mark.parametrize("case", STEP_CASES)
def test_pipe_peers_keep_replicated_parameters_equal(pp_runs, case):
    """After each of two PIPE steps every rank's replicated parameters and
    buffers equal those of the other ranks of its data shard bit for bit;
    so they do after the zero-carry control's step, and not after the
    control's whose later stages miss the encoder input's gradient."""
    got = pp_runs["got"][case]
    assert got["peers_equal"] == [True, True]
    assert got["peers_agree"] == {"tp": True, "zero_carry": True,
                                  "no_input_sum": False}


def test_spatial_pipe_step_matches_jax_mesh_step(pp_runs):
    """MESH.SPATIAL beside MESH.PIPE: the step on (data, model, pipe) = (1,
    2, 2), the clip's rows over each stage's model peers, against JAX's
    step on the same mesh after ``shard_batch(..., spatial=True)``, with
    test_torch_train_step.py's tolerances; the zero-halo and zero-carry
    controls miss them (those that leave a gradient unsummed are held to
    one process's tighter tolerances: the next test)."""
    got = pp_runs["got"][SPATIAL_PIPE]
    assert got["mesh"] == (1, 2, 2)
    assert got["metrics"]["tp"]["finite"] == 1.0
    assert got["missed"]["tp"] == [], got["missed"]["tp"]
    for name in ("zero_halo", "zero_carry"):
        assert got["missed"][name] != [], name


def test_spatial_pipe_step_matches_one_process(pp_runs):
    """The SPATIAL x PIPE step against the port's one-process step on the
    whole batch: every reading within SELF_TOL, the updates within
    UPDATE_TOL. Among them the BN running statistics: every pipe stage
    runs the trunk on the same rows, and ``Mesh.batch_mean`` averages over
    the data x model ranks of one stage (over the world every pixel would
    count twice). The four controls, SPATIAL's and PIPE's, each miss."""
    got = pp_runs["got"][SPATIAL_PIPE]
    assert got["controls"] == ["zero_halo", "no_trunk_sum", "zero_carry",
                               "no_input_sum"]
    readings = got["readings"]
    for k, v in readings["tp"].items():
        assert v <= (UPDATE_TOL if k == "update_rel" else SELF_TOL), (k, v)
    for name in ("zero_halo", "zero_carry"):
        for k in ("loss_rel", "grads_rel", "update_rel"):
            assert readings[name][k] > 100 * SELF_TOL, (name, k, readings)
    for name in ("no_trunk_sum", "no_input_sum"):
        assert readings[name]["loss_rel"] == readings["tp"]["loss_rel"]
        assert readings[name]["grads_rel"] > 100 * SELF_TOL, (name, readings)
    assert got["peers_equal"] == [True, True]


def test_spatial_pipe_stage_path_eval_matches_one_process(pp_runs):
    """The stage path's eval forward (MODEL.PALLAS_KERNELS and
    FUSED_STAGES; their plain versions here) under SPATIAL x PIPE, the
    clip's rows over each stage's model peers and the encoder as two
    stages, against the one-process forward on the whole batch on the last
    stage of data shard 0: scores, actor probabilities and boxes within
    1e-5; its zero-halo control parts from it by more than 1e-3. Every
    rank ran the stem, depthwise and chain launches of both forwards."""
    got = pp_runs["got"][SPATIAL_PIPE]["eval_stages"]
    diff = got["differences"]
    assert max(diff["mesh"].values()) <= 1e-5, diff
    assert max(diff["zero_halo"].values()) > 1e-3, diff
    assert len(got["launches"]) == 4
    assert all(set(e) == {"mesh", "zero_halo"} for e in got["launches"])


def test_run_training_under_spatial_pipe_writes_the_one_process_file(
        pp_runs):
    """run_training under SPATIAL x PIPE (4 ranks, DATA 1 x MODEL 2 x PIPE
    2): one checkpoint, from rank 0, holding the one-process layout (every
    parameter and buffer under its one-process name and shape, the encoder
    layers of both stages among them) with its PIPE recorded."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    assert len(pp_runs["sp_ckpt"]) == 1
    payload = torch.load(pp_runs["sp_ckpt"][0], weights_only=True)
    assert payload["pipe"] == 2
    cfg = tp_check.one_process(pp_runs["sp_run_cfg"])
    want = build_model(cfg, train=True).state_dict()
    got = payload["model"]
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
    assert pp_runs["four"][0]["train"]["dirs"] == \
        pp_runs["four"][3]["train"]["dirs"]


@pytest.mark.parametrize("case", STEP_CASES)
def test_each_stage_holds_half_the_encoder(pp_runs, case):
    """Every rank's encoder parameters and AdamW moments, from the
    tensors, are half one process's: its stage's layer of two."""
    got = pp_runs["got"][case]
    one = got["one_process_encoder_bytes"]
    for rank in got["encoder_bytes"]:
        assert 2 * rank["params"] == one["params"]
        assert 2 * rank["moments"] == one["moments"]


def test_zero1_with_pipe_bit_equal_to_data_pipe(pp_runs):
    """ZeRO-1 on DATA 2 x PIPE 2: after each of two steps every rank's
    model and optimizer state equal the DATA x PIPE step's bit for bit;
    the control without the all-gather does not; each rank's moments are
    the figure from the shapes (the encoder layers' whole, the replicated
    parameters' halved), less than the DATA x PIPE step's."""
    for z in pp_runs["got"]["data_pipe"]["zero1"]:
        assert z["zero1_equal"] == [True, True]
        assert z["control_equal"] == [False, False]
        assert z["zero1_moment_bytes"] == z["zero1_predicted_bytes"]
        assert z["data_moment_bytes"] == z["data_predicted_bytes"]
        assert z["zero1_moment_bytes"] < z["data_moment_bytes"]


def test_run_training_under_pipe_writes_the_one_process_layout(pp_runs):
    """MESH.PIPE 2 over 2 ranks: one run directory, one checkpoint written
    by rank 0, whose model and optimizer state are the one-process
    layout (every encoder layer, every parameter's moments) and which
    records PIPE 2; the train log from rank 0 alone."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    r0, r1 = (run["train"] for run in pp_runs["runs"])
    assert r0["dirs"] == r1["dirs"]
    assert len(pp_runs["ckpt"]) == 1
    payload = torch.load(pp_runs["ckpt"][0], weights_only=True)
    cfg = tp_check.one_process(_run_pp_cfg(pp_runs["tmp"]))
    state = engine.create_train_state(cfg, build_model(cfg, train=True), 3)
    assert payload["pipe"] == 2
    assert payload["model"].keys() == state.model.state_dict().keys()
    n = sum(len(g["params"]) for g in state.optimizer.param_groups)
    opt = payload["optimizer"]
    assert sorted(opt["state"]) == list(range(n))
    state.optimizer.load_state_dict(opt)
    assert "Epoch:" in pp_runs["logs"][0] and "Epoch:" not in \
        pp_runs["logs"][1]
    assert "pipe stage 1 of 2" in pp_runs["logs"][1]


def test_pipe_checkpoint_resumes_under_pipe(pp_runs):
    """The PIPE 2 run's checkpoint resumed under PIPE 2 (each stage its
    layers and their moments): the state gathered back to the
    one-process layout equals the file's bit for bit, and one more step
    is finite."""
    got = pp_runs["runs"][0]["resume"]
    assert got["same"]
    assert got["metrics"]["finite"] == 1.0


def test_run_eval_under_pipe_matches_one_process(pp_runs):
    """run_eval under MESH.PIPE 2 (each stage its encoder layer, batches
    of two clips in two microbatches) against one process on the same
    checkpoint: the same mAP and person AP, the same detection dump."""
    got = pp_runs["runs"][0]["eval"]
    assert got["stages"] == 1
    got["cfg"].mesh.pipe = 1
    _check_eval_against_one_process(pp_runs, got, "pp")


def test_generate_lfb_under_pipe_matches_one_process(pp_runs):
    """generate_lfb under MESH.PIPE 2 against one process on the same
    checkpoint: the same keyframes, slots and validity, features within
    1e-5."""
    from tubelet_transformer_tpu_torch.eval.lfb import FeatureBank

    got = pp_runs["runs"][0]["bank"]
    cfg = got["cfg"]
    cfg.mesh.data, cfg.mesh.pipe = -1, 1
    want_path = str(pp_runs["tmp"] / "bank_one.npz")
    runner.run_generate_lfb(cfg, want_path, device="cpu")
    a, b = FeatureBank.load(got["path"]), FeatureBank.load(want_path)
    assert len(a) == len(b) == 6
    for key in b._bank:
        np.testing.assert_allclose(a._bank[key], b._bank[key],
                                   rtol=1e-5, atol=1e-5)
        assert np.array_equal(a._valid[key], b._valid[key])


def test_pipeline_dropout_decorrelated_across_data_shards(pp_runs):
    """With dropout 0.5 in the pipelined encoder, identical samples on the
    two data shards draw different masks (the step's seed holds the data
    index, each (layer, microbatch) its own); the two pipe stages of a
    shard hold the same output, and a repeat from the same seed draws the
    same."""
    got = pp_runs["got"]["dropout"]
    ranks = got["ranks"]
    assert np.array_equal(ranks[0], ranks[1])
    assert np.array_equal(ranks[2], ranks[3])
    assert np.abs(ranks[0] - ranks[2]).max() > 1e-3
    assert np.array_equal(got["repeat"], ranks[0])


def test_dryrun_axes_run_on_gloo(pp_runs):
    """The dry run's five axes in one 2-rank launch (dp_tp on DATA 2), each
    one step with a finite loss, zero1's loss equal to the replicated
    run's; dp_tp in a 4-rank launch on DATA 2 x MODEL 2."""
    lines = pp_runs["got"]["dryrun"]
    assert [line.split(":")[0] for line in pp_runs["runs"][0]["dryrun"]] == [
        "dp_tp", "sp", "ep", "pp", "zero1"]
    assert pp_runs["runs"][0]["dryrun"][0].startswith("dp_tp: mesh 2x1 ok")
    assert "(== replicated)" in pp_runs["runs"][0]["dryrun"][-1]
    assert lines[0].startswith("dp_tp: mesh 2x2 ok")


def test_encoder_stack_crosses_over_bit_for_bit(pp_runs):
    """The JAX PIPE model's variables (encoder layers stacked in
    ``encoder_stack``) into the port bit for bit: the same state dict as
    JAX's own unstacking gives; the port's stack/unstack equal JAX's and
    round-trip."""
    import jax

    from tubelet_transformer_tpu.parallel import pipeline as jpipeline
    from tubelet_transformer_tpu_torch.parallel import pipeline

    init = pp_runs["init"]
    cfg = pp_runs["cases"]["pipe"]
    params, stats = init["params"], init["stats"]
    tr = params["transformer"]
    assert "encoder_stack" in tr and "encoder_layer_0" not in tr
    flat = jpipeline.unstack_encoder_params(dict(tr), 2)
    want = _port_sd(cfg, {**params, "transformer": jax.device_get(flat)},
                    stats)
    got = _port_sd(cfg, params, stats)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert all(torch.equal(init["initial"][k], torch.as_tensor(want[k]))
               for k in want)
    mine = pipeline.unstack_encoder_params(tr, 2)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(flat)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    back = pipeline.stack_encoder_params(mine, 2)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(dict(tr))):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_pipe_refusals(tmp_path):
    """What the 'pipe' axis refuses raises, naming it as the JAX package
    does: encoder layers that MESH.PIPE does not divide, a shard's batch
    that the microbatches do not, MoE inside the pipelined encoder, a
    PIPE model without its mesh, SPATIAL beside PIPE over a MODEL that
    does not divide the clip's rows (SPATIAL beside PIPE runs), and a
    full resume across a PIPE change either way; a weight-only load
    converts; serving a PIPE config runs the sequential encoder."""
    from test_torch_tuber import small_cfg

    from tubelet_transformer_tpu_torch.models.tuber import build_model

    mesh = mesh_lib.Mesh(pipe=2)
    cfg = small_cfg("avg")
    cfg.mesh.pipe = 2
    with pytest.raises(ValueError, match="1 layers not divisible by 2 "
                                         "pipeline stages"):
        build_model(cfg, mesh=mesh)
    with pytest.raises(ValueError, match="MESH.PIPE 2 requires"):
        build_model(cfg)
    cfg.model.enc_layers = 2
    model = build_model(cfg, mesh=mesh)
    with pytest.raises(ValueError, match="batch 3 not divisible by "
                                         "microbatches 2 x data axis 1"):
        model(torch.zeros(3, 8, 64, 64, 3))
    moe = copy.deepcopy(cfg)
    moe.model.moe_experts = 4
    with pytest.raises(NotImplementedError, match="MoE inside the "
                                                  "pipelined encoder"):
        build_model(moe, mesh=mesh)
    # SPATIAL beside PIPE runs (the 4-rank step above): the set-up takes
    # it, and refuses a clip whose rows MODEL does not divide
    spatial = copy.deepcopy(cfg)
    spatial.mesh.model, spatial.mesh.spatial = 2, True
    runner.check_supported(spatial)
    spatial.mesh.model = 3
    with pytest.raises(ValueError, match="MESH.SPATIAL: the stem's input "
                                         "of 64 rows .* MESH.MODEL 3"):
        runner.check_supported(spatial)
    # a one-process checkpoint into a PIPE state, and back
    one = tp_check.one_process(cfg)
    state = engine.create_train_state(one, build_model(one, train=True), 4)
    path = ckpt_lib.save_checkpoint(str(tmp_path), state, epoch=0)
    pp_state = engine.create_train_state(
        cfg, build_model(cfg, train=True, mesh=mesh), 4, mesh)
    with pytest.raises(ValueError, match="MESH.PIPE"):
        ckpt_lib.load_checkpoint(path, pp_state)
    payload = torch.load(path, weights_only=True)
    payload["pipe"] = 2
    torch.save(payload, tmp_path / "piped")
    with pytest.raises(ValueError, match="written under MESH.PIPE 2"):
        ckpt_lib.load_checkpoint(str(tmp_path / "piped"), state)
    cfg.model.load, cfg.model.pretrained_path = True, str(tmp_path / "piped")
    loaded = build_model(cfg, mesh=mesh, pretrained=True)
    want = state.model.state_dict()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want[k]), k
    # serving keeps the sequential encoder, as JAX's detector does
    from tubelet_transformer_tpu_torch.serving import StreamingDetector

    det = StreamingDetector(cfg, device="cpu")
    assert det.model.transformer.pipe is None
    assert len(det.model.transformer.stage_layers()) == 2


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
elif __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    jax_worker(sys.argv[2])
