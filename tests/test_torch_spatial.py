"""Spatial parallelism (MESH.SPATIAL beside MESH.MODEL) of the PyTorch port
over torch.distributed: each model peer runs the CSN trunk on its band of
the clip's rows, with the halo exchanges, the all-rank BN statistics, the
trunk's gradient sum over the model group and the gather after the trunk
written by hand. Ranks on the CPU over gloo, each a process started from
this file (``python tests/test_torch_spatial.py worker <job>``, torchrun's
environment set by hand, as tests/test_torch_tensor_parallel.py starts
them). CSN-TINY with a 1+2-layer transformer of width 64, float32,
dropout off, TUNE_POINT 4.

* The spatial train step (``tools/tp_check.py`` with MESH.SPATIAL) on
  MODEL 2 and on DATA 2 x MODEL 2 (4 ranks), AVA at 64 px (every stage two
  rows or more a peer), against the JAX package's ``make_train_step`` after
  ``shard_batch(..., spatial=True)`` and ``shard_train_state`` on the same
  mesh of conftest's host devices, from the same variables (BN statistics
  randomised) and batch, with ``test_torch_train_step.py``'s tolerances;
  the eval step of the same variables under MODEL 2 against JAX's eval
  step on the spatial mesh.
* Uneven bands (``Bands``: an output row belongs to the peer that owns
  the input row at its stride): the spatial step at 48 px on MODEL 2
  (layer3's strided conv on 3 rows a peer) and at 72 px on MODEL 4 with a
  strided layer4 (4 ranks: pooled bands of 5, 4, 5 and 4 rows, layer4's
  output 1, 1, 0 and 1: one peer's band empty), each against JAX's step
  on the same mesh and against one process, and its stage path's eval
  forward against one process's.
* Those steps and a JHMDB-mode step (32 px: one row a peer at layers 3-4)
  with TRAIN.FROZEN_CHUNK 1 against the port's one-process
  step on the whole batch to SELF_TOL (updates to UPDATE_TOL); both
  controls (zero halo rows, the trunk's gradients not summed over the
  model group) miss; the model peers' replicated parameters bit-equal
  after two steps.
* ``run_training`` under SPATIAL writes from rank 0 alone; ``run_eval``
  under SPATIAL equals the one-process validation, detection for
  detection.
* The halo exchange: a depthwise conv on each peer's rows against the
  unsplit conv (outputs, the input's and the weight's gradients through
  autograd, float64) at stride 1, at stride 2 (the slab's parity) and at
  one row a peer.
* On one process: the windowed plain stems against the whole clip's rows
  (72 px over 4 peers among them), a chain of blocks and a fused block on
  slabs of a known clip (uneven bands among them), SPATIAL at MODEL 1 a
  no-op, and the refusal of a clip whose rows MODEL does not divide.

The JAX steps and the eval run in two processes of their own (the
uneven cases' steps in the second), each of which writes its initial
variables first, on which the port's steps of its cases start; the
checks against them run on the ranks' rank 0. Every subprocess runs under a timeout of at most 300 s and is
killed when it runs out; the temporary files go when the module's tests
end.
"""

import copy
import glob
import json
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
from test_torch_tensor_parallel import (
    UPDATE_TOL, _check_eval_against_one_process, _jax_mesh, _port_sd)
from tubelet_transformer_tpu_torch.cli import runner
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.tools import dp_check, tp_check
from tubelet_transformer_tpu_torch.train import checkpoint as ckpt_lib
from tubelet_transformer_tpu_torch.train import engine

STEP_CASES = ("ava", "data_model", "ucf", "odd48", "uneven72")
JAX_CASES = ("ava", "data_model", "odd48", "uneven72")
# the uneven bands, with the stage path's eval forward: 48 px at MODEL 2
# (layer3's strided conv on 3 rows a peer, then 2 and 1), 72 px at MODEL 4
# with a strided layer4 (5, 4, 5 and 4 pooled rows, layer4's output 1, 1,
# 0 and 1 rows)
UNEVEN_CASES = ("odd48", "uneven72")
# the halo cases: (clip rows, the conv's stride along T, H and W)
HALO_CASES = {"stride1": (8, 1), "stride2": (8, 2), "one_row": (2, 1),
              "stride2_one_row": (4, 2)}
EVAL_KEYS = ("scores", "binary", "boxes")


# ---------------------------------------------------------------- worker

def _step_task(cfg, batch, initial_path=None, want_path=None,
               eval_path=None, eval_stages=False):
    """tools/tp_check.run of the spatial step on this rank, from the JAX
    case's initial variables where it has one (else the seed's); on rank 0
    the readings, the peers' equality, the metrics of the step, its
    controls and the one-process step, with ``eval_stages`` the stage
    path's eval forward against one process's (tp_check's
    ``eval_check``), and with JAX's output the checks against its step
    (``want_path``) and the eval step of the same variables against its
    eval step (``eval_path``), run here once JAX has written them."""
    initial = _load(initial_path)["initial"] if initial_path else None
    outputs = _eval_outputs(cfg, initial, batch) if eval_path else None
    out = tp_check.run(cfg, torch.device("cpu"), initial=initial,
                       batch=batch, eval_stages=eval_stages)
    if out is None:
        return None
    names = ("tp", *out["controls"])
    res = {"readings": out["readings"], "peers_equal": out["peers_equal"],
           "peers_agree": out["peers_agree"],
           "controls": out["controls"], "spatial": out["spatial"],
           "eval_stages": out.get("eval", {}).get("differences"),
           "metrics": {k: out[k]["metrics"] for k in (*names, "single")}}
    if want_path:
        res["missed"] = Deferred(want_path, lambda w, *a: _missed(
            w["step"], *a), cfg, initial, {k: out[k] for k in names})
        res["jax_metrics"] = Deferred(want_path, lambda w: w["step"][0])
        res["parted"] = Deferred(want_path, _parted, out["tp"]["grads"])
    if eval_path:
        res["eval"] = Deferred(eval_path, _eval_differences, outputs)
    return res


def _eval_outputs(cfg, initial, batch):
    """The spatial eval step of the eval build, loaded with ``initial``,
    on this rank's data shard of ``batch``: its detections."""
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.parallel import sharding_rules

    c = copy.deepcopy(cfg)
    c.val.compute_losses = False
    mesh = mesh_lib.create_mesh(c.mesh.data, c.mesh.model, 1, c.mesh.spatial)
    model = build_model(c, mesh=mesh)
    sharding_rules.load_full_state(model, initial)
    b = len(batch["clips"]) // mesh.data
    d = mesh.data_index
    got = engine.make_eval_step(c, model, mesh=mesh)(engine.device_batch(
        {k: v[d * b:(d + 1) * b] for k, v in batch.items()},
        torch.device("cpu")))
    return {k: got[k].float().numpy() for k in EVAL_KEYS}


def _parted(want, grads):
    """Each parameter whose first Adam moment in JAX's step is not 0.1
    (1 - b1) times the port's clipped gradient: the ratio of their norms,
    where it is more than 1% from 1."""
    out = {}
    for name, g in grads.items():
        ratio = float(np.linalg.norm(want["mu"][name])
                      / (0.1 * np.linalg.norm(g.numpy())))
        if abs(ratio - 1.0) > 1e-2:
            out[name] = ratio
    return out


def _eval_differences(want, got):
    """The largest absolute difference of each detection output of rank
    0's rows from JAX's eval step."""
    n = len(got["scores"])
    return {k: float(np.abs(got[k] - want[k][:n]).max()) for k in EVAL_KEYS}


def _halo_task(seed):
    """Each HALO_CASES depthwise conv (float64, 5 channels, 2 clips of 4
    frames) on this peer's rows against the unsplit conv on the whole
    clip: the largest differences of the peer's output rows, of the
    input's gradient rows and of the weight's gradient (summed over the
    peers) for the gradient of one random linear loss."""
    from tubelet_transformer_tpu_torch.models.csn import DepthwiseConv3d

    mesh = mesh_lib.create_mesh(1, mesh_lib.process_count(), spatial=True)
    rng = np.random.default_rng(seed)
    out = {}
    for name, (h, stride) in HALO_CASES.items():
        x = torch.from_numpy(rng.normal(size=(2, 4, h, 6, 5)))
        conv = DepthwiseConv3d(5, stride=(stride,) * 3).double()
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(rng.normal(
                size=conv.weight.shape)))
        whole = x.clone().requires_grad_()
        want = conv(whole)
        g = torch.from_numpy(rng.normal(size=want.shape))
        (want * g).sum().backward()
        want_w, conv.weight.grad = conv.weight.grad, None
        first, count = mesh.own_rows(h)
        o0, on = mesh.own_rows(want.shape[2])
        conv.spatial = mesh
        part = x[:, :, first:first + count].clone().requires_grad_()
        got = conv(part)
        (got * g[:, :, o0:o0 + on]).sum().backward()
        grad_w = mesh_lib.all_reduce_sum(conv.weight.grad)
        out[name] = {
            "rows": (count, got.shape[2]),
            "output": float((got - want[:, :, o0:o0 + on]).abs().max()),
            "grad_x": float((part.grad - whole.grad[:, :, first:first
                                                    + count]).abs().max()),
            "grad_w": float((grad_w - want_w).abs().max())}
    return out


def _train_task(cfg):
    out = runner.run_training(cfg, device="cpu")
    return {"val": out["val"], "dirs": out["dirs"]}


def _eval_task(cfg, dump_dir):
    """run_eval under SPATIAL of the newest checkpoint under LOG.BASE_PATH
    (rank 0's choice), then validate_ava of its model on the spatial mesh
    with a detection dump."""
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
    return {"val": out["val"], "cfg": cfg, "split": mesh.spatial}


TASKS = {"step": _step_task, "halo": _halo_task, "train": _train_task,
         "eval": _eval_task}


def worker(job_path):
    run_job(job_path, TASKS)


def _jax_spatial_step(cfg, jmodel, tx, state, batch):
    """JAX's train step after ``shard_train_state`` on the case's
    ('data', 'model') mesh, the clips' H axis over 'model'
    (``shard_batch(..., spatial=True)``): {"step": (metrics, the port's
    state dict of the variables after it), "mu": the port's state dict of
    Adam's first moment after it}."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from test_torch_zero1 import _adam_state

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
            jmesh.shard_batch(batch, mesh, spatial=True),
            jax.random.PRNGKey(1), jnp.float32(cfg.loss.dice_cof))
        metrics, (params, stats), adam = jax.device_get(
            (metrics, (new_state.params, new_state.batch_stats),
             _adam_state(new_state.opt_state)))
    finally:
        fnn.Dropout.__call__ = call
    return {"step": ({k: float(v) for k, v in metrics.items()},
                     _port_sd(cfg, params, stats)),
            "mu": _port_sd(cfg, adam.mu, stats)}


def _jax_step_task(memo, out, init, cfg, batch):
    """``_jax_spatial_step`` of the case's model (a strided layer4 has the
    same variables) from the variables of the ``init`` task, saved to
    <out>.want."""
    from tubelet_transformer_tpu.models.tuber import build_model as jbuild

    _, tx, state = memo[init][:3]
    _save(_jax_spatial_step(cfg, jbuild(cfg), tx, state, batch),
          f"{out}.want")


def _jax_eval_task(memo, out, init, cfg, batch):
    """JAX's eval step (no losses) of the ``init`` task's variables on the
    case's spatial mesh: its detections, saved to <out>.want."""
    import jax

    from tubelet_transformer_tpu.parallel import mesh as jmesh
    from tubelet_transformer_tpu.train import engine as jengine

    c = copy.deepcopy(cfg)
    c.val.compute_losses = False
    mesh = _jax_mesh(c)
    jmodel, _, state = memo[init][:3]
    got = jengine.make_eval_step(c, jmodel, mesh)(
        jax.device_get(state), jmesh.shard_batch(batch, mesh, spatial=True))
    _save({k: np.asarray(jax.device_get(got[k]), np.float32)
           for k in EVAL_KEYS}, f"{out}.want")


JAX_TASKS = {"init": _jax_init_task, "step": _jax_step_task,
             "eval": _jax_eval_task}


def jax_worker(job_path):
    run_jax_job(job_path, JAX_TASKS)


# ---------------------------------------------------------------- parent

def _spatial(cfg, data=1):
    """``cfg``, its clip's rows split over a data x 2 mesh."""
    cfg.mesh.data, cfg.mesh.model, cfg.mesh.spatial = data, 2, True
    return cfg


def _avg_cfg():
    """The AVA case with avg temporal pooling (the decode pooling's split
    is test_torch_tensor_parallel.py's, and its JAX compile the costlier)."""
    cfg = _ava_cfg()
    cfg.model.temporal_ds_strategy = "avg"
    return cfg


def _cases():
    ucf = _spatial(_ucf_cfg())
    ucf.train.frozen_chunk = 1
    odd = _spatial(_avg_cfg())
    odd.data.img_size = 48
    uneven = _spatial(_avg_cfg())
    uneven.data.img_size, uneven.mesh.model = 72, 4
    uneven.model.last_stride = True
    return {"ava": _spatial(_avg_cfg()),
            "data_model": _spatial(_avg_cfg(), data=2), "ucf": ucf,
            "odd48": odd, "uneven72": uneven}


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """Every multi-process run of this file, started at once: a JAX
    process, which writes the AVA case's initial variables first (the
    data_model case starts from them too), then runs JAX's spatial step on
    the data-1 x model-2 and the data-2 x model-2 meshes and its eval step
    on the first; a second, which writes the same variables and then runs
    JAX's step of each uneven case (UNEVEN_CASES); 2 ranks under MODEL 2
    that run the AVA step as soon as its variables are written (and check
    it once JAX's step is), and meanwhile the JHMDB step (FROZEN_CHUNK 1),
    the halo cases, the train run and the eval of its checkpoint; 4 ranks
    of DATA 2 x MODEL 2 for the data_model step. The temporary files go
    when the module's tests end."""
    tmp = tmp_path_factory.mktemp("sp")
    cases = _cases()
    batches = {k: dp_check.global_batch(c, 2 * c.mesh.data, seed=3)
               for k, c in cases.items()}
    # JHMDB: every box slot filled (test_torch_data_parallel.py: the JAX
    # matcher's float32 solve beside PAD_COST)
    batches["ucf"]["valid"][:] = True
    batches["ucf"]["vis"][:] = 1
    # the JAX job of each case: the uneven cases' steps in a second
    # process, so that neither nears its timeout
    job = {k: "jax_uneven" if k in UNEVEN_CASES else "jax"
           for k in JAX_CASES}
    jax_tasks = {name: {"init": ("init", {"cfg": cases["ava"],
                                          "batch": batches["ava"]})}
                 for name in ("jax", "jax_uneven")}
    for k, name in job.items():
        jax_tasks[name][f"{k}_step"] = ("step", {
            "init": str(tmp / f"{name}.out.init"), "cfg": cases[k],
            "batch": batches[k]})
    jax_tasks["jax"]["eval"] = ("eval", {"init": str(tmp / "jax.out.init"),
                                         "cfg": cases["ava"],
                                         "batch": batches["ava"]})

    def step(case):
        kw = {"cfg": cases[case], "batch": batches[case]}
        if case in JAX_CASES:
            init = str(tmp / f"{job[case]}.out.init.init")
            kw.update(initial_path=init, after=[init],
                      want_path=str(tmp / f"{job[case]}.out.{case}"
                                          "_step.want"))
        if case == "ava":
            kw["eval_path"] = str(tmp / "jax.out.eval.want")
        kw["eval_stages"] = case in UNEVEN_CASES
        return ("step", kw)

    run_cfg = _run_cfg(tmp / "runs")
    run_cfg.mesh.model, run_cfg.mesh.spatial = 2, True
    launched = []
    try:
        for name, tasks in jax_tasks.items():
            launched.append(_start(tmp, tasks, name, world=1, mode="jax",
                                   script=__file__))
        launched.append(_start(tmp, {
            "ucf": step("ucf"),
            "halo": ("halo", {"seed": 5}),
            "train": ("train", {"cfg": run_cfg}),
            "eval": ("eval", {"cfg": copy.deepcopy(run_cfg),
                              "dump_dir": str(tmp / "dump_sp")}),
            "ava": step("ava"), "odd48": step("odd48")}, "ranks",
            script=__file__))
        launched.append(_start(tmp, {"data_model": step("data_model"),
                                     "uneven72": step("uneven72")},
                               "dm", world=4, script=__file__))
    except BaseException:
        for procs, _ in launched:
            _kill(procs)
        raise
    _wait(*launched[0])
    _wait(*launched[1])
    runs, logs = _wait(*launched[2])
    dm = _wait(*launched[3])[0][0]
    yield {"cases": cases, "got": {**runs[0], **dm}, "runs": runs,
           "logs": logs, "tmp": tmp,
           "ckpt": glob.glob(str(tmp / "runs" / "*" / "checkpoints" /
                                 "ckpt_*"))}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("case", JAX_CASES)
def test_spatial_step_matches_jax_mesh_step(sp_runs, case):
    """The spatial step against JAX's step on the same ('data', 'model')
    mesh with the clips' H axis over 'model', with
    test_torch_train_step.py's tolerances (``_check_against_jax``, run
    where both steps' states are, on rank 0 of the ranks' job); the
    zero-halo control misses them. (The control without the trunk's
    gradient sum moves no update past them where no gradient changes
    sign: Adam's first update is lr * sign(g). The one-process test
    below reads it in the trunk's gradients.)"""
    got = sp_runs["got"][case]
    assert got["spatial"] and got["metrics"]["tp"]["finite"] == 1.0
    assert got["missed"]["tp"] == []
    assert got["missed"]["zero_halo"] != []


def test_spatial_eval_step_matches_jax(sp_runs):
    """The spatial eval step under MODEL 2 against JAX's eval step on the
    spatial mesh, from the same variables and clips: scores and actor
    probabilities within 1e-4, boxes within 1e-3 px at 64 px."""
    diff = sp_runs["got"]["ava"]["eval"]
    assert diff["scores"] <= 1e-4 and diff["binary"] <= 1e-4, diff
    assert diff["boxes"] <= 1e-3, diff


@pytest.mark.parametrize("case", JAX_CASES)
def test_jax_spatial_mesh_step_gradients_are_the_ports(sp_runs, case):
    """JAX's spatial step on the data-1 x model-2 and the data-2 x model-2
    meshes takes every gradient the port's spatial step takes (which
    equals one process's, the next test): each parameter's first Adam
    moment is 0.1 of the port's clipped gradient within 1%. Its step on a
    data-2 x model-2 mesh without the H split counts the two strided
    depthwise convs' gradients twice (ROADMAP.md C3,
    test_torch_tensor_parallel.py); with the split it does not."""
    assert sp_runs["got"][case]["parted"] == {}


@pytest.mark.parametrize("case", STEP_CASES)
def test_spatial_step_matches_one_process(sp_runs, case):
    """The spatial step against the port's one-process step on the whole
    batch: every reading within SELF_TOL, the updates within UPDATE_TOL.
    The zero-halo control misses in its losses, its statistics and its
    gradients; the control without the trunk's gradient sum has the
    step's forward (its losses and statistics agree) and misses in its
    gradients and updates."""
    got = sp_runs["got"][case]
    assert got["controls"] == ["zero_halo", "no_trunk_sum"]
    readings = got["readings"]
    for k, v in readings["tp"].items():
        assert v <= (UPDATE_TOL if k == "update_rel" else SELF_TOL), (k, v)
    for k in ("loss_rel", "grads_rel", "stem_mean_rel", "update_rel"):
        assert readings["zero_halo"][k] > 100 * SELF_TOL, (k, readings)
    no_sum = readings["no_trunk_sum"]
    assert no_sum["loss_rel"] == readings["tp"]["loss_rel"]
    assert no_sum["stem_mean_rel"] == readings["tp"]["stem_mean_rel"]
    for k in ("grad_norm_rel", "grads_rel"):
        assert no_sum[k] > SELF_TOL, (k, no_sum)
    assert no_sum["update_rel"] > 100 * UPDATE_TOL, no_sum
    # each peer's share of the trunk's gradients, not their sum
    assert readings["tp"]["trunk_grads_rel"] <= SELF_TOL
    assert no_sum["trunk_grads_rel"] > 0.1, no_sum


@pytest.mark.parametrize("case", STEP_CASES)
def test_spatial_model_peers_keep_replicated_parameters_equal(sp_runs, case):
    """After each of two spatial steps, every rank's replicated parameters
    (the trunk's among them, once its gradients are summed) and buffers
    equal its model peers' bit for bit; so they do after the step of the
    zero-halo control, and not after the control's whose peers keep their
    shares of the trunk's gradients."""
    got = sp_runs["got"][case]
    assert got["peers_equal"] == [True, True]
    assert got["peers_agree"] == {"tp": True, "zero_halo": True,
                                  "no_trunk_sum": False}


@pytest.mark.parametrize("case", UNEVEN_CASES)
def test_uneven_bands_stage_path_eval_matches_one_process(sp_runs, case):
    """The stage path's eval forward (MODEL.PALLAS_KERNELS and
    FUSED_STAGES; their plain versions here) on uneven bands against the
    one-process forward on the whole batch: scores, actor probabilities
    and boxes within 1e-5; its zero-halo control parts from it by more
    than 1e-3."""
    got = sp_runs["got"][case]["eval_stages"]
    assert max(got["mesh"].values()) <= 1e-5, got
    assert max(got["zero_halo"].values()) > 1e-3, got


@pytest.mark.parametrize("case", list(HALO_CASES))
def test_halo_exchange_matches_the_unsplit_conv(sp_runs, case):
    """A depthwise conv on each peer's rows, its halo exchanged, against
    the unsplit conv in float64 on both peers: the output rows, the
    input's gradient (each halo row's sent back to its owner) and the
    weight's gradient summed over the peers, within 1e-12."""
    for run in sp_runs["runs"]:
        got = run["halo"][case]
        h, stride = HALO_CASES[case]
        assert got["rows"] == (h // 2, h // 2 // stride), got
        for k in ("output", "grad_x", "grad_w"):
            assert got[k] <= 1e-12, (k, got)


def test_run_training_under_spatial_writes_from_rank_zero(sp_runs):
    """MESH.MODEL 2 with SPATIAL over 2 ranks: one run directory with
    config.json, one checkpoint and the metrics from rank 0 alone."""
    r0, r1 = (run["train"] for run in sp_runs["runs"])
    assert r0["dirs"] == r1["dirs"]
    runs = glob.glob(str(sp_runs["tmp"] / "runs" / "*"))
    assert len(runs) == 1 and Path(runs[0], "config.json").is_file()
    assert len(sp_runs["ckpt"]) == 1
    lines = Path(r0["dirs"]["tb"], "metrics.jsonl").read_text().splitlines()
    tags = [json.loads(line)["tag"] for line in lines]
    assert tags.count("train/total_loss") == 6
    assert "val/val_mAP_epoch" in tags
    assert "Epoch:" in sp_runs["logs"][0] and "Epoch:" not in \
        sp_runs["logs"][1]


def test_run_eval_under_spatial_matches_one_process(sp_runs,
                                                    one_torch_thread):
    """run_eval under MESH.MODEL 2 with SPATIAL against one process on the
    same checkpoint: the same mAP and person AP and the same detection
    dump."""
    got = sp_runs["runs"][0]["eval"]
    assert got["split"]
    _check_eval_against_one_process(sp_runs, got, "sp")


def _slice_mesh(full: torch.Tensor, index: int, model: int):
    """Peer ``index`` of ``model`` peers that split the rows of ``full``,
    a clip whose every row is known: its halo rows cut from ``full`` (no
    process group)."""

    class SliceMesh(mesh_lib.Mesh):
        def halo_exchange(self, x, top, bottom, bands=None):
            h = x.shape[2]
            a = self.model_index * h if bands is None else \
                bands.rows[self.model_index][0]
            return full[:, :, max(0, a - top):a + h + bottom]

    return SliceMesh(1, index, model, True)


# the uneven bands of the slab cases: layer3's output of JHMDB's 224 px
# at MODEL 4 (56 rows a peer at the stem), at 1/4 scale
UNEVEN_BANDS = mesh_lib.Bands.split(56, 4).strided(4)


@pytest.mark.parametrize("model", [2, 4, "uneven"])
def test_chain_and_fused_block_on_slabs_match_the_whole_clip(model):
    """``csn.halo_run`` of the stage chain's plain version (K = 3 blocks:
    3 rows of each neighbour) and of the fused block's (K = 1) on each
    peer's rows of a known clip, cropped back, against the same function
    on the whole clip, in float64; a chain longer than its halo parts
    from it. ``uneven``: the 4 peers' bands of 4, 3, 4 and 3 rows
    (``UNEVEN_BANDS``), K = 3 the shortest band."""
    from tubelet_transformer_tpu_torch.models.csn import halo_run
    from tubelet_transformer_tpu_torch.ops.cuda.bottleneck import (
        bottleneck_reference)
    from tubelet_transformer_tpu_torch.ops.cuda.stage import chain_reference

    rng = np.random.default_rng(0)
    bands = (UNEVEN_BANDS if model == "uneven"
             else mesh_lib.Bands.split(4 * model, model))
    assert bands.rows == ((0, 4), (4, 3), (7, 4), (11, 3)) or \
        model != "uneven"
    ci, cm, k, h = 16, 8, 3, bands.height

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape) * scale)

    x = t(1, 3, h, 5, ci)
    stacked = [t(k, ci, cm, scale=0.3), t(k, 3, 3, 3, cm, scale=0.3),
               t(k, cm, ci, scale=0.3), t(k, cm), t(k, cm), t(k, cm),
               t(k, cm), t(k, ci), t(k, ci)]
    fns = {"chain": lambda z: chain_reference(z, stacked),
           "block": lambda z: bottleneck_reference(
               z, *(s[0] for s in stacked))}
    n = len(bands.rows)
    for name, (fn, rows) in {"chain": (fns["chain"], k),
                             "block": (fns["block"], 1),
                             "short": (fns["chain"], 1)}.items():
        want = fn(x)
        parts = []
        for i, (a, c) in enumerate(bands.rows):
            parts.append(halo_run(x[:, :, a:a + c], _slice_mesh(x, i, n),
                                  rows, fn, bands))
        err = float((torch.cat(parts, 2) - want).abs().max())
        if name == "short":
            assert err > 1e-3, err
        else:
            assert err <= 1e-12, (name, err)


@pytest.mark.parametrize("kind", ["pooled", "stats"])
def test_windowed_stem_references_match_the_whole_clip(kind):
    """``stem_reference`` and ``stem_batch_stats_reference`` on each of 2
    and 4 peers' windows of a 64-row clip (its rows and the halo of
    POOL_HALO or STATS_HALO), and of 4 peers' of a 72-row clip, whose
    18-row bands own 5, 4, 5 and 4 pooled rows and 9 conv rows each (the
    halo ``stem_halo``'s), against the whole clip's: the pooled rows bit
    for bit, and the peers' (mean, E[y^2]) averaged, weighted by their
    conv rows, within 1e-6 of the whole clip's statistics; a window whose
    slab lacks a halo row is refused."""
    from tubelet_transformer_tpu_torch.ops.cuda import stem

    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(0, 0.1, stem.W_SHAPE).astype(
        np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 2, 64).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    pooled = kind == "pooled"
    for height, model in ((64, 2), (64, 4), (72, 4)):
        x = torch.from_numpy(rng.normal(1.0, 1.0, (2, 3, height, 20, 3))
                             .astype(np.float32))
        bands = mesh_lib.Bands.split(height, model)
        top, below = ((stem.POOL_HALO if pooled else stem.STATS_HALO)
                      if height == 64 else stem.stem_halo(bands))
        outs = []
        for first, rows in bands.rows:
            win = stem.peer_window(first, rows, height, pooled, top)
            slab = x[:, :, win.row0:min(height, first + rows + below)]
            outs.append(stem.stem_reference(slab, w, scale, bias, win)
                        if pooled else (win.out_rows,
                                        *stem.stem_batch_stats_reference(
                                            slab, w, win)))
        if pooled:
            if height == 72:
                assert [o.shape[2] for o in outs] == [5, 4, 5, 4]
            assert torch.equal(torch.cat(outs, 2),
                               stem.stem_reference(x, w, scale, bias))
        else:
            n = torch.tensor([float(c) for c, _, _ in outs])[:, None]
            mean = (torch.stack([m for _, m, _ in outs]) * n).sum(0) / n.sum()
            msq = (torch.stack([v + m.square() for _, m, v in outs])
                   * n).sum(0) / n.sum()
            want_mean, want_var = stem.stem_batch_stats_reference(x, w)
            assert (mean - want_mean).abs().max() <= 1e-6
            assert (msq - mean.square() - want_var).abs().max() <= 1e-6 * (
                want_var.abs().max())
    x = x[:, :, :64]
    rows = 16
    below = (stem.POOL_HALO if pooled else stem.STATS_HALO)[1]
    win = stem.peer_window(rows, rows, 64, pooled)
    fn = stem.stem_reference if pooled else stem.stem_batch_stats_reference
    with pytest.raises(ValueError, match="do not hold input rows"):
        fn(x[:, :, win.row0:2 * rows + below - 1], w,
           *((scale, bias) if pooled else ()), window=win)


def test_spatial_with_model_one_is_a_noop(one_torch_thread):
    """MESH.SPATIAL at MESH.MODEL 1 changes nothing, as in JAX: the mesh
    does not split the rows, the model keeps them whole, and a train step
    equals the step without SPATIAL bit for bit."""
    from test_torch_tuber import small_cfg

    from tubelet_transformer_tpu_torch.models.tuber import build_model

    mesh = mesh_lib.create_mesh(-1, 1, 1, spatial=True)
    assert not mesh.spatial
    assert mesh.own_rows(64) == (0, 64)
    metrics = []
    for spatial in (False, True):
        cfg = small_cfg("avg")
        cfg.model.pretrained, cfg.model.dropout = True, 0.0
        cfg.mesh.spatial = spatial
        runner.check_supported(cfg)
        model = build_model(cfg, train=True, mesh=mesh)
        assert model.spatial is None
        state = engine.create_train_state(cfg, model, 4)
        step = engine.make_train_step(cfg, state, mesh=mesh)
        out = step(engine.device_batch(dp_check.global_batch(cfg, 2, seed=2),
                                       torch.device("cpu")), 1.0)
        metrics.append({k: float(v) for k, v in out.items()})
    assert metrics[0] == metrics[1]


def test_uneven_split_is_refused_naming_its_stage():
    """Only the split that the JAX package refuses is refused: MESH.MODEL
    not dividing the clip's rows, as JAX's ``device_put`` of a clip whose
    H axis does not divide over 'model' raises. The set-up then raises
    ValueError naming MESH.SPATIAL, the rows and MESH.MODEL: 64 px rows
    over MODEL 3. Every uneven band below the stem is taken: JHMDB's 224
    px at MODEL 4 (layer3's strided conv on 7 rows a peer, then bands of
    4, 3, 4 and 3 rows), 64 px at MODEL 2, the flagship's 256 px at MODEL
    2, 4 and 8; generate_lfb ignores SPATIAL."""
    from test_torch_jhmdb import small_cfg as jhmdb_cfg
    from test_torch_tuber import small_cfg

    from tubelet_transformer_tpu_torch.models.csn import spatial_rows

    cfg = jhmdb_cfg()
    cfg.data.img_size, cfg.model.backbone_name = 224, "CSN-152"
    cfg.mesh.model, cfg.mesh.spatial = 4, True
    runner.check_supported(cfg)
    bands = spatial_rows(224, (3, 8, 36, 3), cfg.model.last_stride, 4)
    assert [b.rows for b in bands[4:]] == [
        ((0, 7), (7, 7), (14, 7), (21, 7)),
        ((0, 4), (4, 3), (7, 4), (11, 3)),
        ((0, 4), (4, 3), (7, 4), (11, 3))]
    cfg = small_cfg()
    cfg.mesh.model, cfg.mesh.spatial = 3, True
    with pytest.raises(ValueError, match="MESH.SPATIAL: the stem's input of "
                                         "64 rows does not split over "
                                         "MESH.MODEL 3"):
        runner.check_supported(cfg)
    cfg.mesh.model = 2
    runner.check_supported(cfg)
    for model in (2, 4, 8):
        assert spatial_rows(256, (3, 8, 36, 3), False, model)[-1].rows == \
            tuple((i * 16 // model, 16 // model) for i in range(model))
    # generate_lfb gets past its checks to the mesh, which one process
    # cannot hold
    cfg.mesh.model = 3
    cfg.model.load, cfg.model.pretrained_path = True, "unused.pth"
    with pytest.raises(ValueError, match="MESH.DATA x MODEL"):
        runner.run_generate_lfb(cfg, "unused.npz", device="cpu")


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
elif __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    jax_worker(sys.argv[2])

