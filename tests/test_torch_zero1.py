"""The rest of the 'data' axis of the PyTorch port over torch.distributed:
ZeRO-1 (MESH.ZERO1, ``parallel/zero.py``), MoE with MESH.DATA > 1 (the
global load-balance loss) and the classifier's data-parallel step. Two
ranks on the CPU over gloo, each a process started from this file
(``python tests/test_torch_zero1.py worker <job>``, torchrun's environment
set by hand, as tests/test_torch_data_parallel.py starts them); CSN-TINY
at TUNE_POINT 4, dropout off, float clips, 2 clips a rank.

* ZeRO-1: two DP steps with the moments sharded over the 2 ranks against
  the JAX package's ``make_train_step`` on a ``create_mesh(data=2)`` mesh
  with ``shard_train_state(..., zero1=True)`` and the output layout pinned
  (``state_shardings``, as tests/test_engine.py builds them), on the same
  global batch from the same variables, after each step: the losses, the
  parameters and the full gathered moments against JAX's ``mu``/``nu``
  (crossed over through ``convert.tuber_torch_state_from_params``, which
  the moment trees fit, as they mirror the parameters). Against the
  port's own DATA-only step: bit for bit, and a control without the
  all-gather misses. Each rank's moment bytes are JAX's per-device bytes
  of ``mu``/``nu`` over the trainable leaves, and the figure from the
  shapes.
* The checkpoint: a ZeRO-1 file of 2 ranks resumes in one process
  without ZeRO-1, and a file saved without ZeRO-1 resumes the 2-rank
  ZeRO-1 run.
* MoE (4 experts, top 2) with 2 ranks against JAX's step on a data-2 mesh,
  ``loss_moe_aux`` among the readings, also with ACCUM_STEPS 2 in
  microbatch-major order; the control of local counts and normalisers
  misses.
* The classifier's DP step against JAX's ``make_classification_train_step``
  on clips sharded over a data-2 mesh; the control of local BN statistics
  misses.
* MESH.ZERO1 in one process is a no-op.

The temporal pooling is avg throughout (test_torch_data_parallel.py runs
the decode pooling's DP step), which keeps the records small. The JAX
steps run in processes of their own, as test_torch_data_parallel.py runs
them, and the checks against them on the ranks' rank 0. Every
subprocess runs under a timeout of at most 300 s and is killed when it
runs out; the temporary files go when the module's tests end.
"""

import copy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401

from test_torch_data_parallel import (
    SELF_TOL, Deferred, _ava_cfg, _check_against_jax, _jax_init_task,
    _jax_step_task, _kill, _load, _save, _start, _step_task, _wait,
    run_jax_job, run_job)
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.parallel import sharding_rules, zero
from tubelet_transformer_tpu_torch.tools import dp_check
from tubelet_transformer_tpu_torch.train import engine
from tubelet_transformer_tpu_torch.train.optimizer import (
    param_label, trainable_params)

# the classifier's optimizer: optax.adamw(1e-3)'s settings, stated
LR, WD, N_CLASSES = 1e-3, 1e-4, 5
# the gradients (and the moments they build) of one process against 2
# ranks on the same global batch, from the state two updates in: the
# loss terms, the gradient norm and the running statistics part at
# float32 rounding (<= 6e-7, within SELF_TOL), everything outside the CSN
# trunk too (<= 3.3e-6 per parameter), but layers 3-4's gradients part by
# ~2e-3 of their own (8.9e-5 of all gradients together), growing with the
# distance their convs moved from the initial state (1.2e-6 there). The
# 2-rank step from the same state in memory reads the same, so the split
# makes it, not the checkpoint: a train-mode BN's backward keeps only the
# part of its output gradient off the span of (1, x_hat), which cancels
# most of it, so rounding in per-rank against whole-batch statistics is
# amplified
SPLIT_TOL = 1e-3


# ---------------------------------------------------------------- worker

def _no_dropout(model):
    from tubelet_transformer_tpu_torch.models.layers import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def _shard(batch, d, b):
    """Data shard ``d``'s ``b`` rows of the global batch."""
    return {k: v[d * b:(d + 1) * b] for k, v in batch.items()}


def named_moments(state):
    """{parameter name: (exp_avg, exp_avg_sq)} of the optimizer's state
    dict in the one-process layout (a collective under ZeRO-1 and under
    MESH.MODEL), on the CPU."""
    sd = sharding_rules.gather_optimizer_state(state.model, state.optimizer)
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: tuple(sd["state"][i][k].cpu().clone()
                                for k in zero.MOMENTS)
            for i, p in enumerate(trainable_params(state.optimizer))
            if i in sd["state"]}


def _record(state, metrics):
    """A step's metrics, the state dict, the gradients (summed and clipped)
    and the named moments after it, in the one-process layout (a
    collective under ZeRO-1 and under MESH.MODEL)."""
    model = state.model
    grads = sharding_rules.gather_tensors(model, {
        n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.detach().cpu().clone() for k, v in
                      sharding_rules.gather_state(model).items()},
            "grads": {n: g.detach().cpu().clone() for n, g in grads.items()},
            "moments": named_moments(state)}


def _zero1_task(cfg, initial_path, batch, batch3, ckpt_dir, want_path):
    """On every rank: ``dp_check.zero1_check`` (ZeRO-1 and its control
    against the DATA-only step, bit for bit; the moment bytes). The
    ZeRO-1 run's two steps, each recorded, its checkpoint, and a third
    step on ``batch3``; then a DATA-only run of two steps saved without
    ZeRO-1 and resumed by a fresh ZeRO-1 state for the same third step.
    Rank 0 returns the checks of the two steps against JAX's ZeRO-1 steps
    (``want_path``, run once JAX has written them), the second step's
    state and moments, the third step's record, whether the resumed third
    step equals it, and the checkpoints' paths."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import checkpoint as ckpt_lib

    initial = _load(initial_path)["initial"]
    mesh = mesh_lib.create_mesh(cfg.mesh.data, cfg.mesh.model)
    b = cfg.train.batch_size
    d = mesh.data_index
    model = _no_dropout(build_model(cfg, train=True, mesh=mesh))
    out = {"check": dp_check.zero1_check(cfg, model, initial,
                                         _shard(batch, d, b), mesh)}
    db, db3 = (engine.device_batch(_shard(x, d, b), torch.device("cpu"))
               for x in (batch, batch3))
    zcfg = copy.deepcopy(cfg)
    zcfg.mesh.zero1 = True
    paths = {}
    for name, c in (("zero1", zcfg), ("data", cfg)):
        sharding_rules.load_full_state(model, initial)
        state = engine.create_train_state(c, model, 10, mesh)
        step = engine.make_train_step(c, state, mesh)
        records = [_record(state, step(db, c.loss.dice_cof))
                   for _ in range(2)]
        paths[name] = ckpt_lib.save_checkpoint(str(Path(ckpt_dir, name)),
                                               state, epoch=0)
        if name == "zero1":
            steps = records
            third = _record(state, step(db3, c.loss.dice_cof))
    # the file saved without ZeRO-1, into a fresh ZeRO-1 state
    sharding_rules.load_full_state(model, initial)
    state = engine.create_train_state(zcfg, model, 10, mesh)
    ckpt_lib.load_checkpoint(paths["data"], state)
    step = engine.make_train_step(zcfg, state, mesh)
    resumed = _record(state, step(db3, zcfg.loss.dice_cof))
    if mesh.rank:
        return out["check"]
    return {**out, "paths": paths,
            "jax": Deferred(want_path, _zero1_against_jax, cfg, initial,
                            steps),
            "finite": [r["metrics"]["finite"] for r in steps],
            "step2": {k: steps[1][k] for k in ("state", "moments")},
            "third": third,
            "resumed_equal": {
                "metrics": resumed["metrics"] == third["metrics"],
                "state": all(torch.equal(resumed["state"][k],
                                         third["state"][k])
                             for k in third["state"]),
                "moments": all(torch.equal(x, y) for n in third["moments"]
                               for x, y in zip(resumed["moments"][n],
                                               third["moments"][n]))}}


def _zero1_against_jax(want, cfg, initial, steps):
    """Each recorded ZeRO-1 step against JAX's (``want``: its steps and
    device 0's moment bytes): ``_check_against_jax`` from the state before
    the step, the names of the moments against the trainable parameters
    JAX's state names, and ``_assert_moments_close`` of every moment
    (what it raises, by name); with JAX's bytes."""
    out = []
    for i, (got, w) in enumerate(zip(steps, want["steps"])):
        before = initial if i == 0 else steps[i - 1]["state"]
        state = w["state"]
        errors = {}
        for name, (m, v) in got["moments"].items():
            try:
                assert m.shape == w["mu"][name].shape, name
                _assert_moments_close(name, m.numpy(), v.numpy(),
                                      w["mu"][name], w["nu"][name], i + 1)
            except AssertionError as e:
                errors[name] = str(e)[:2000]
        out.append({
            "missed": _check_against_jax(cfg, before, got,
                                         (w["metrics"], state)),
            "names": set(got["moments"]),
            "want_names": {n for n in w["state"]
                           if param_label(n, cfg) != "frozen"
                           and not n.endswith(("running_mean", "running_var",
                                               "num_batches_tracked"))},
            "moment_errors": errors})
    return {"steps": out, "bytes": want["bytes"]}


def _classifier_task(initial_path, clips, labels):
    """The classifier's DP step on this rank's rows, and the control with
    ``LocalMesh`` (each rank's own BN statistics and row count, the ranks'
    losses and gradients averaged): on rank 0 each one's loss and state
    dict after the step, and the DP step's gradients."""
    from tubelet_transformer_tpu_torch.train import classify

    state_dict = _load(initial_path)["initial"]
    mesh = mesh_lib.create_mesh()
    b = len(clips) // mesh.data
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    model = classify.VideoClassifier("CSN-TINY", N_CLASSES)
    out = {}
    for name, m in (("dp", mesh),
                    ("control", dp_check.LocalMesh(mesh.data, mesh.rank))):
        model.load_state_dict(state_dict)
        opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=WD)
        step = classify.make_classification_train_step(
            classify.create_classifier_state(model, opt), mesh=m)
        loss = step(torch.from_numpy(clips[rows]),
                    torch.from_numpy(labels[rows]))
        out[name] = {"loss": float(loss),
                     "state": {k: v.detach().clone() for k, v in
                               model.state_dict().items()},
                     "grads": {n: p.grad.clone()
                               for n, p in model.named_parameters()}}
    return out if mesh.rank == 0 else None


TASKS = {"zero1": _zero1_task, "step": _step_task,
         "classifier": _classifier_task}


def worker(job_path):
    run_job(job_path, TASKS)


def _jax_zero1_task(memo, out, init, cfg, batch, model=1):
    """``_jax_zero1_steps`` on a data-2 x ``model`` mesh from the
    variables of the ``init`` task, saved to <out>.want with device 0's
    moment bytes."""
    steps, nbytes = _jax_zero1_steps(cfg, *memo[init][:3], batch,
                                     model=model)
    _save({"steps": steps, "bytes": nbytes}, f"{out}.want")


def _jax_classifier_init_task(memo, out, clips):
    """The JAX classifier's variables (``_classifier_init``), kept; the
    port's state dict of them saved to <out>.init and returned."""
    memo[out] = _classifier_init(clips)
    _save({"initial": memo[out][2]}, f"{out}.init")
    return memo[out][2]


def _jax_classifier_step_task(memo, out, init, clips, labels):
    params, stats, _ = memo[init]
    return _jax_classifier_step(params, stats, clips, labels)


JAX_TASKS = {"init": _jax_init_task, "step": _jax_step_task,
             "zero1": _jax_zero1_task, "cls_init": _jax_classifier_init_task,
             "cls_step": _jax_classifier_step_task}


def jax_worker(job_path):
    run_jax_job(job_path, JAX_TASKS)


# ---------------------------------------------------------------- parent

def _adam_state(opt_state):
    """The ``optax.ScaleByAdamState`` (``mu``, ``nu``) in a chain's
    state."""
    import jax
    import optax

    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1, found
    return found[0]


def _port_sd(cfg, params, stats):
    from tubelet_transformer_tpu_torch.convert import (
        tuber_torch_state_from_params)

    m = cfg.model
    return tuber_torch_state_from_params(
        params, stats, block_nums=(1, 1, 1, 1), enc_layers=m.enc_layers,
        dec_layers=m.dec_layers, temporal_ds_strategy=m.temporal_ds_strategy,
        single_frame=m.single_frame, ddp_prefix=False)


def _jax_zero1_steps(cfg, jmodel, tx, state, batch, steps=2, model=1):
    """JAX's ZeRO-1 train step on a data-2 x ``model`` mesh, ``steps``
    times on ``batch``: per step the metrics, the port's state dict of the
    variables and of ``mu`` and ``nu``; and device 0's bytes of ``mu`` and
    ``nu`` over the trainable leaves."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from tubelet_transformer_tpu.parallel import mesh as jmesh
    from tubelet_transformer_tpu.parallel.sharding_rules import (
        shard_train_state, state_shardings)
    from tubelet_transformer_tpu.train import engine as jengine
    from tubelet_transformer_tpu.train.optimizer import param_labels

    mesh = jmesh.create_mesh(data=2, model=model,
                             devices=jax.devices()[:2 * model])
    state = shard_train_state(jax.device_get(state), mesh, zero1=True)
    adam = _adam_state(state.opt_state)
    labels = jax.tree_util.tree_leaves(param_labels(state.params, cfg))
    dev0 = jax.devices()[0]
    nbytes = sum(sh.data.nbytes for tree in (adam.mu, adam.nu)
                 for leaf, label in zip(jax.tree_util.tree_leaves(tree),
                                        labels) if label != "frozen"
                 for sh in leaf.addressable_shards if sh.device == dev0)
    step = jengine.make_train_step(
        cfg, jmodel, tx,
        state_out_shardings=state_shardings(state, mesh, zero1=True))
    db = jmesh.shard_batch(batch, mesh)
    call = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    out = []
    try:
        for _ in range(steps):
            state, metrics = step(state, db, jax.random.PRNGKey(1),
                                  jnp.float32(cfg.loss.dice_cof))
            metrics, params, stats, adam = jax.device_get(
                (metrics, state.params, state.batch_stats,
                 _adam_state(state.opt_state)))
            out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                        "state": _port_sd(cfg, params, stats),
                        "mu": _port_sd(cfg, adam.mu, stats),
                        "nu": _port_sd(cfg, adam.nu, stats)})
    finally:
        fnn.Dropout.__call__ = call
    return out, nbytes


def _classifier_init(x):
    """The JAX classifier's variables (BN randomised) and the port's state
    dict of them."""
    import jax
    from test_torch_csn import randomize_bn

    from tubelet_transformer_tpu.train import classify as jclassify
    from tubelet_transformer_tpu_torch import convert
    from tubelet_transformer_tpu_torch.train import classify

    jmodel = jclassify.VideoClassifier(backbone_name="CSN-TINY",
                                       num_classes=N_CLASSES)
    variables = jax.device_get(jax.jit(
        lambda r: jmodel.init({"params": r}, x, train=False))(
            jax.random.PRNGKey(2)))
    params = jax.tree.map(np.array, variables["params"])
    stats = jax.tree.map(np.array, variables["batch_stats"])
    randomize_bn(params, stats, np.random.default_rng(2))
    model = convert.load_classifier(
        classify.VideoClassifier("CSN-TINY", N_CLASSES), params, stats)
    return params, stats, {k: v.clone() for k, v in
                           model.state_dict().items()}


def _jax_classifier_step(params, stats, clips, labels):
    """JAX's classification step with ``optax.adamw(LR)`` on clips sharded
    over a data-2 mesh: (loss, the port's state dict after)."""
    import jax
    import jax.numpy as jnp
    import optax

    from tubelet_transformer_tpu.parallel import mesh as jmesh
    from tubelet_transformer_tpu.train import classify as jclassify
    from tubelet_transformer_tpu_torch import convert

    jmodel = jclassify.VideoClassifier(backbone_name="CSN-TINY",
                                       num_classes=N_CLASSES)
    tx = optax.adamw(LR)
    assert WD == 1e-4          # optax.adamw's default weight decay
    mesh = jmesh.create_mesh(data=2, devices=jax.devices()[:2])
    state = jax.device_put(jclassify.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params)), jmesh.replicated(mesh))
    b = jmesh.shard_batch({"clips": clips, "labels": labels}, mesh)
    new, loss = jclassify.make_classification_train_step(jmodel, tx)(
        state, b["clips"], b["labels"])
    new = jax.device_get(new)
    return float(loss), convert.classifier_state(
        new.params, new.batch_stats, (1, 1, 1, 1))


def _avg_cfg(accum=1):
    """tests/test_torch_data_parallel.py's AVA config with the avg temporal
    pooling: 5.8 M parameters, not the decode pooling's 47.7 M, which
    test_torch_data_parallel.py runs (every record here is a state dict
    and its moments, written to disk)."""
    cfg = _ava_cfg(accum)
    cfg.model.temporal_ds_strategy = "avg"
    return cfg


def _moe_cfg(accum=1):
    cfg = _avg_cfg(accum)
    cfg.model.moe_experts, cfg.model.moe_top_k = 4, 2
    return cfg


@pytest.fixture(scope="module")
def z_runs(tmp_path_factory):
    """Every multi-process run of this file, started at once: three JAX
    processes, which write each case's initial variables first (ZeRO-1's,
    MoE's and the classifier's, one a process) and then JAX's data-2 mesh
    steps; and two ranks that run each case as soon as its
    initial variables are written, and check it against JAX's steps once
    those are written. The temporary files go when the module's tests
    end."""
    tmp = tmp_path_factory.mktemp("zero1")
    zcfg, mcfg, macc = _avg_cfg(), _moe_cfg(), _moe_cfg(accum=2)
    batch, batch3 = (dp_check.global_batch(zcfg, 4, seed=s) for s in (3, 4))
    mbatch = dp_check.global_batch(mcfg, 4, seed=5)
    rng = np.random.default_rng(6)
    clips = rng.normal(size=(4, 8, 32, 32, 3)).astype(np.float32)
    clips += np.arange(4, dtype=np.float32)[:, None, None, None, None]
    labels = np.array([1, 3, 0, 4], np.int32)

    def out(job, task, what):
        return str(tmp / f"{job}.out.{task}.{what}")

    jax_jobs = {
        "z_jax_a": {
            "zero1": ("init", {"cfg": zcfg, "batch": batch}),
            "zero1_steps": ("zero1", {"init": str(tmp / "z_jax_a.out.zero1"),
                                      "cfg": zcfg, "batch": batch})},
        "z_jax_b": {
            "moe": ("init", {"cfg": mcfg, "batch": mbatch}),
            "moe_step": ("step", {"init": str(tmp / "z_jax_b.out.moe"),
                                  "cfg": mcfg, "batch": mbatch}),
            "moe_accum_step": ("step", {
                "init": str(tmp / "z_jax_b.out.moe"), "cfg": macc,
                "batch": dp_check.microbatch_major(mbatch, 2, 2)})},
        "z_jax_c": {
            "cls": ("cls_init", {"clips": clips}),
            "cls_step": ("cls_step", {"init": str(tmp / "z_jax_c.out.cls"),
                                      "clips": clips, "labels": labels})}}
    ranks = {
        "zero1": ("zero1", {
            "cfg": zcfg, "initial_path": out("z_jax_a", "zero1", "init"),
            "batch": batch, "batch3": batch3, "ckpt_dir": str(tmp / "ckpt"),
            "want_path": out("z_jax_a", "zero1_steps", "want"),
            "after": [out("z_jax_a", "zero1", "init")]}),
        **{k: ("step", {
            "cfg": c, "initial_path": out("z_jax_b", "moe", "init"),
            "batch": mbatch, "want_path": out("z_jax_b", f"{k}_step", "want"),
            "after": [out("z_jax_b", "moe", "init")]})
           for k, c in (("moe", mcfg), ("moe_accum", macc))},
        "classifier": ("classifier", {
            "initial_path": out("z_jax_c", "cls", "init"), "clips": clips,
            "labels": labels, "after": [out("z_jax_c", "cls", "init")]})}
    launched = []
    try:
        for name, tasks in jax_jobs.items():
            launched.append(_start(tmp, tasks, name, world=1, mode="jax",
                                   script=__file__))
        launched.append(_start(tmp, ranks, "z", script=__file__))
    except BaseException:
        for procs, _ in launched:
            _kill(procs)
        raise
    _wait(*launched[0])
    _wait(*launched[1])
    jax_c = _wait(*launched[2])[0][0]
    got, _ = _wait(*launched[3])
    yield {"zcfg": zcfg, "batch3": batch3,
           "zero1": got[0]["zero1"], "checks": [got[0]["zero1"]["check"],
                                                got[1]["zero1"]],
           "mcfg": {"moe": mcfg, "moe_accum": macc}, "moe": got[0],
           "cls_init": jax_c["cls"], "want_cls": jax_c["cls_step"]}
    shutil.rmtree(tmp, ignore_errors=True)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("step", [0, 1])
def test_zero1_matches_jax_zero1_mesh_step(z_runs, step):
    """Each of two ZeRO-1 DP steps against JAX's ZeRO-1 step on a data-2
    mesh: the metrics, every parameter and every running statistic at
    test_torch_train_step.py's tolerances (each update measured from the
    state before this step), and the gathered moments against ``mu`` and
    ``nu``: ``_zero1_against_jax``, run where both steps' states are, on
    rank 0 of the ranks' job."""
    z = z_runs["zero1"]
    got = z["jax"]["steps"][step]
    assert z["finite"][step] == 1.0
    assert got["missed"] == []
    assert got["names"] == got["want_names"]
    assert got["moment_errors"] == {}


def _assert_moments_close(name, m, v, mu, nu, t):
    """The port's exp_avg and exp_avg_sq after step ``t`` against JAX's mu
    and nu. mu is a sum of clipped gradients weighted (1 - b1) b1^k, nu of
    their squares: they carry the gradients' agreement, which
    test_torch_train_step.py holds through the gradient norm (rtol 1e-2)
    and the updates, whose float32 agreement it waives where a gradient is
    below 1e-5 (sign and rounding there are the frameworks' own). So each
    moment is held at rtol 1e-2 (2e-2 for the squares) plus that floor
    carried through the moment's weights."""
    w1, w2 = 1 - 0.9 ** t, 1 - 0.999 ** t
    np.testing.assert_allclose(m, mu, rtol=1e-2, atol=1e-5 * w1,
                               err_msg=f"exp_avg {name}")
    np.testing.assert_allclose(v, nu, rtol=2e-2, atol=1e-10 * w2,
                               err_msg=f"exp_avg_sq {name}")


def test_zero1_bit_equal_to_data_only_and_control_misses(z_runs):
    """On each rank, after each of two steps: the ZeRO-1 run's model and
    (gathered) optimizer state dicts equal the DATA-only run's bit for
    bit; the control without the all-gather differs."""
    for check in z_runs["checks"]:
        assert check["zero1_equal"] == [True, True]
        assert check["control_equal"] == [False, False]


def test_zero1_moment_bytes_are_jax_per_device_share(z_runs):
    """Each rank's moment bytes (read from its tensors) are JAX's per-device
    bytes of mu and nu over the trainable leaves (JAX's chain also keeps
    moments of the frozen parameters, which the port's optimizer has none
    of: they are left out), and exactly the figure from the shapes: half
    of each sharded parameter's two moments plus all of each unsharded
    one's. At data 2 that is a little over half the DATA-only bytes."""
    for check in z_runs["checks"]:
        assert check["zero1_moment_bytes"] == z_runs["zero1"]["jax"]["bytes"]
        assert check["zero1_moment_bytes"] == check["zero1_predicted_bytes"]
        assert check["data_moment_bytes"] == check["data_predicted_bytes"]
        assert check["control_moment_bytes"] == check["zero1_moment_bytes"]
        half = check["data_moment_bytes"] / 2
        assert half < check["zero1_moment_bytes"] < 0.51 * \
            check["data_moment_bytes"]


def test_zero1_checkpoint_resumes_in_one_process(z_runs, one_torch_thread):
    """The checkpoint the 2 ranks wrote under ZeRO-1 after two steps holds
    AdamW's own layout, and one process without ZeRO-1 loads it into
    exactly the 2-rank run's state: the model and the gathered moments,
    bit for bit. Its step on the global batch against the 2-rank run's
    third step: every loss term, the gradient norm and the running
    statistics' updates within SELF_TOL (two ranks and one process split
    the batch otherwise, as in tests/test_torch_data_parallel.py); the
    gradients and the moments within SPLIT_TOL, and the parameters'
    updates within 10 SPLIT_TOL: the third Adam update m/(sqrt(v) + eps)
    amplifies the gradients' parting where m is small against sqrt(v)
    (measured 8.9e-5, 5.5e-5 and 7.9e-7 for the gradients and the two
    moments, 8.2e-4 for the updates)."""
    check_resume_in_one_process(z_runs["zcfg"], z_runs["zero1"],
                                z_runs["batch3"])


def check_resume_in_one_process(cfg, z, batch3):
    """``_zero1_task``'s ZeRO-1 checkpoint (``z``, its rank 0's result)
    into one process without ZeRO-1, and the step on the global
    ``batch3`` after it, against the multi-rank run's, as
    ``test_zero1_checkpoint_resumes_in_one_process`` states."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.train import checkpoint as ckpt_lib

    cfg = copy.deepcopy(cfg)
    cfg.mesh.data, cfg.mesh.model, cfg.mesh.zero1 = 1, 1, False
    payload = torch.load(z["paths"]["zero1"], weights_only=True)
    plain = torch.optim.AdamW(
        [{"params": [torch.zeros(1)]}]).state_dict()["param_groups"][0]
    assert set(payload["optimizer"]["param_groups"][0]) == set(plain) | {
        "name", "lr_scale"}
    model = _no_dropout(build_model(cfg, train=True))
    state = engine.create_train_state(cfg, model, steps_per_epoch=10)
    ckpt_lib.load_checkpoint(z["paths"]["zero1"], state)
    assert not isinstance(state.optimizer, zero.ZeroAdamW)
    assert state.step == state.updates == 2
    before = {k: v.clone() for k, v in model.state_dict().items()}
    two_before = z["step2"]
    assert all(torch.equal(before[k], two_before["state"][k])
               for k in two_before["state"])
    loaded = named_moments(state)
    assert loaded.keys() == two_before["moments"].keys()
    assert all(torch.equal(x, y) for n in loaded
               for x, y in zip(loaded[n], two_before["moments"][n]))

    metrics = engine.make_train_step(cfg, state)(engine.device_batch(
        batch3, torch.device("cpu")), cfg.loss.dice_cof)
    one, two = _record(state, metrics), z["third"]
    for k, v in two["metrics"].items():
        assert abs(one["metrics"][k] - v) <= SELF_TOL * abs(v), k
    stats = [k for k in before if k.endswith(("running_mean",
                                              "running_var"))]
    assert _rel(*[np.concatenate([(r["state"][k] - before[k]).numpy().ravel()
                                  for k in stats]) for r in (one, two)]
                ) <= SELF_TOL
    names = sorted(two["moments"])
    assert names == sorted(one["moments"]) == sorted(two["grads"])
    for read, tol in ((lambda r, n: r["grads"][n], SPLIT_TOL),
                      (lambda r, n: r["moments"][n][0], SPLIT_TOL),
                      (lambda r, n: r["moments"][n][1], SPLIT_TOL),
                      (lambda r, n: r["state"][n] - before[n],
                       10 * SPLIT_TOL)):
        assert _rel(*[np.concatenate([read(r, n).numpy().ravel()
                                      for n in names])
                      for r in (one, two)]) <= tol


def test_zero1_resumes_from_a_file_saved_without_it(z_runs):
    """The DATA-only run's file (AdamW's state dict of the full moments),
    loaded by a fresh ZeRO-1 state of 2 ranks, gives the uninterrupted
    ZeRO-1 run's third step bit for bit: the two runs' first two steps are
    bit-equal, and the load keeps each rank's slices exactly."""
    # compared on rank 0 of the ranks' job (_zero1_task)
    assert z_runs["zero1"]["resumed_equal"] == {
        "metrics": True, "state": True, "moments": True}


@pytest.mark.parametrize("case", ["moe", "moe_accum"])
def test_moe_dp_step_matches_jax_mesh_step(z_runs, case):
    """MoE (4 experts, top 2) with 2 ranks against JAX's step on a data-2
    mesh, at test_torch_train_step.py's tolerances, ``loss_moe_aux`` among
    the metrics (with ACCUM_STEPS 2, JAX takes the global batch in
    microbatch-major order); the control (each rank's own counts and
    normalisers, the ranks' losses and gradients averaged) misses, its
    load-balance loss too. Against the port's one process on the whole
    batch, every reading within SELF_TOL."""
    got = z_runs["moe"][case]
    metrics = got["jax_metrics"]
    assert "loss_moe_aux" in metrics
    # _check_against_jax of each run, on the ranks' rank 0 (_step_task)
    assert got["missed"]["dp"] == []
    assert got["missed"]["control"] != []
    aux = got["control"]["metrics"]["loss_moe_aux"]
    assert not np.isclose(aux, metrics["loss_moe_aux"], rtol=1e-4,
                          atol=1e-5), (aux, metrics["loss_moe_aux"])
    for k, v in got["readings"]["dp"].items():
        assert v <= SELF_TOL, (k, v)
    assert got["readings"]["control"]["moe_aux_rel"] > 100 * SELF_TOL


def test_classifier_dp_step_matches_jax_mesh_step(z_runs):
    """The classifier's DP step (2 ranks x 2 clips) against JAX's
    ``make_classification_train_step`` on the 4 clips sharded over a
    data-2 mesh, float32: the loss and every running statistic within
    rtol 1e-4 (atol 1e-5), as test_torch_train_step.py holds them; the
    first AdamW step's updates as tests/test_torch_classify.py holds
    them (within 2.2 lr, and to 1e-3 lr at all but under a tenth of the
    weights), where the gradient is near zero by chip_smoke.py's float32
    rule of the same step (phase_classify: below 0.05 of its tensor's rms;
    test_torch_classify.py's 1e-3 is for float64). The control with each
    rank's own BN statistics misses the loss and the statistics."""
    jloss, want = z_runs["want_cls"]
    init = z_runs["cls_init"]
    got = z_runs["moe"]["classifier"]
    dp = got["dp"]
    assert set(dp["state"]) == set(want)
    assert np.isclose(dp["loss"], jloss, rtol=1e-4, atol=1e-5)
    missed = []
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        got_k, old = dp["state"][k].numpy(), init[k].numpy()
        if k not in dp["grads"]:
            if not np.allclose(got_k, want[k], rtol=1e-4, atol=1e-5):
                missed.append(k)
            continue
        diff = np.abs((got_k - old) - (want[k] - old))
        g = dp["grads"][k].numpy()
        off = diff > 1e-3 * LR
        rms = np.sqrt(np.mean(g ** 2))
        if (diff.max() > 2.2 * LR or off.mean() >= 0.1
                or np.abs(g[off]).max(initial=0) > 0.05 * rms):
            missed.append(k)
    assert missed == []
    control = got["control"]
    assert not np.isclose(control["loss"], jloss, rtol=1e-4, atol=1e-5)
    assert not all(np.allclose(control["state"][k].numpy(), want[k],
                               rtol=1e-4, atol=1e-5)
                   for k in want if k.endswith("running_var"))


def test_zero1_in_one_process_is_a_no_op(one_torch_thread):
    """MESH.ZERO1 without a 'data' axis (one process) builds AdamW itself,
    as JAX's ``n_data > 1`` test makes it, and the step equals the one
    without it bit for bit; a ZeRO-1 state on a mesh of another size is
    refused."""
    from test_torch_tuber import small_cfg

    from tubelet_transformer_tpu_torch.models.tuber import build_model

    cfg = small_cfg("avg")
    cfg.model.pretrained, cfg.model.dropout = True, 0.0
    cfg.train.batch_size = 2
    batch = engine.device_batch(dp_check.global_batch(cfg, 2, seed=7),
                                torch.device("cpu"))
    runs = []
    for zero1 in (False, True):
        c = copy.deepcopy(cfg)
        c.mesh.zero1 = zero1
        model = build_model(c, train=True, seed=3)
        state = engine.create_train_state(c, model, steps_per_epoch=10)
        assert type(state.optimizer) is torch.optim.AdamW
        metrics = engine.make_train_step(c, state)(batch, c.loss.dice_cof)
        runs.append(({k: float(v) for k, v in metrics.items()},
                     model.state_dict(), state.optimizer.state_dict()))
    # the same AdamW under MESH.ZERO1 on a 'data' axis of 2
    with pytest.raises(ValueError, match="MESH.ZERO1"):
        engine.make_train_step(c, state, mesh=mesh_lib.Mesh(data=2))
    (m0, s0, o0), (m1, s1, o1) = runs
    assert m0 == m1
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert all(torch.equal(o0["state"][i][k], o1["state"][i][k])
               for i in o0["state"] for k in o0["state"][i])


def test_shard_axis_rule():
    """The largest axis that n divides, the lower one on a tie (JAX's
    ``sorted(..., key=-size)`` is stable); none at n 1, for a scalar, or
    when no axis divides."""
    assert zero.shard_axis((3, 3, 3, 64, 128), 2) == 4
    assert zero.shard_axis((64, 64), 2) == 0
    assert zero.shard_axis((7, 6), 2) == 1
    assert zero.shard_axis((7, 5), 2) is None
    assert zero.shard_axis((), 2) is None
    assert zero.shard_axis((64,), 1) is None
    assert zero.shard_axis((12, 8), 4) == 0
    assert zero.shard_axis((6, 8), 4) == 1


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
elif __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    jax_worker(sys.argv[2])
