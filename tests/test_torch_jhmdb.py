"""The JHMDB/UCF24 path of the PyTorch port against the JAX package's, on
the same numpy-seeded inputs: the datasets (ACT-detector pickle and PNG
frames, and its per-video pack) bit for bit; TubeR in JHMDB mode (Q*T
tubelet queries, the clip-level visibility head from the mean of the
un-pooled features, C+1 classes); the softmax postprocess, the key-frame
query gather, the matcher (by cost) and the criterion; one whole train step
in float64; validation's frame and video mAP with the same weights; and the
runner's JHMDB train and eval through the CLIs' entry. CSN-TINY, 32 px
clips on a 32x64 canvas (the JHMDB canvas's aspect), T=4, Q=3, float32 on
the CPU unless stated."""

import dataclasses
import glob

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_csn import randomize_bn

from tubelet_transformer_tpu.config import Config as JConfig
from tubelet_transformer_tpu.data import jhmdb as jjhmdb
from tubelet_transformer_tpu.data import packed as jpacked
from tubelet_transformer_tpu.models.tuber import build_model as jbuild_model
from tubelet_transformer_tpu.ops import matcher as jm
from tubelet_transformer_tpu.train import criterion as jc
from tubelet_transformer_tpu.train import engine as jengine
from tubelet_transformer_tpu.train import loop as jloop
from tubelet_transformer_tpu.train import postprocess as jpost
from tubelet_transformer_tpu.train.torch_convert import (
    tuber_torch_state_from_params)
from tubelet_transformer_tpu_torch.cli import eval_jhmdb, runner, train_jhmdb
from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.convert import load_jax_variables
from tubelet_transformer_tpu_torch.data import jhmdb, packed
from tubelet_transformer_tpu_torch.data.loader import DataLoader
from tubelet_transformer_tpu_torch.models.layers import Dropout
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.tools import fixtures
from tubelet_transformer_tpu_torch.train import criterion as tcrit
from tubelet_transformer_tpu_torch.train import engine, loop, postprocess

Q, T, C = 3, 4, 5          # queries per frame, frames, classes


def small_cfg(module=None, root=None):
    cfg = (module or Config)()
    cfg.data.dataset_name = "jhmdb"
    cfg.data.num_classes = C
    cfg.data.img_size = 32
    cfg.data.img_reshape_size = 36
    cfg.data.temp_len = T
    cfg.data.max_boxes = 4
    cfg.data.num_workers = 2
    cfg.model.backbone_name = "CSN-TINY"
    cfg.model.query_num = Q
    cfg.model.temp_len = T
    cfg.model.enc_layers = 1
    cfg.model.dec_layers = 2
    cfg.model.d_model = 64
    cfg.model.nhead = 4
    cfg.model.dim_feedforward = 64
    cfg.model.compute_dtype = "float32"
    cfg.model.temporal_ds_strategy = "avg"
    cfg.train.batch_size = 2
    cfg.val.batch_size = 2
    if root is not None:
        cfg.data.anno_path = str(root)
        cfg.data.data_path = str(root / "rgb-images")
        cfg.log.base_path = str(root / "runs")
    return cfg


@pytest.fixture(scope="module")
def jhmdb_root(tmp_path_factory):
    """Two train and two test videos of 10 random 32x40 frames, one tube
    each."""
    root = tmp_path_factory.mktemp("jhmdb")
    fixtures.write_jhmdb_set(str(root), ["a/v0", "b/v1"], ["c/v2", "d/v3"],
                             10, num_classes=C, hw=(32, 40), seed=0)
    return root


def _assert_samples_equal(ours, theirs):
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(np.asarray(ours[k]),
                                      np.asarray(theirs[k]), err_msg=k)


@pytest.mark.parametrize("split", ["train", "val"])
def test_jhmdb_dataset_matches_jax(jhmdb_root, split):
    ours = jhmdb.JHMDBDataset(small_cfg(root=jhmdb_root), split)
    theirs = jjhmdb.JHMDBDataset(small_cfg(JConfig, jhmdb_root), split)
    assert ours.samples == theirs.samples and len(ours) == 20
    for i in range(len(ours)):
        _assert_samples_equal(ours.get(i, np.random.default_rng(i)),
                              theirs.get(i, np.random.default_rng(i)))


@pytest.mark.parametrize("split", ["train", "val"])
def test_packed_jhmdb_matches_jax(jhmdb_root, tmp_path, split):
    """The port's pack and the JAX package's: the same shard bytes and
    index; samples read from the port's pack equal the JAX reader's on its
    own pack and the unpacked dataset's."""
    dirs = {}
    for name, mod, cfg_mod in (("ours", packed, Config),
                               ("theirs", jpacked, JConfig)):
        dirs[name] = mod.pack_jhmdb(small_cfg(cfg_mod, jhmdb_root), split,
                                    str(tmp_path / name), progress_every=0)
    for path in sorted(glob.glob(str(tmp_path / "ours" / "*"))):
        other = tmp_path / "theirs" / path.rsplit("/", 1)[1]
        if path.endswith(".npz"):
            a, b = np.load(path), np.load(other)
            assert a.files == b.files
            for f in a.files:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        else:
            assert open(path, "rb").read() == open(other, "rb").read()
    ours = packed.PackedJHMDBDataset(small_cfg(root=jhmdb_root), split,
                                     dirs["ours"])
    theirs = jpacked.PackedJHMDBDataset(small_cfg(JConfig, jhmdb_root),
                                        split, dirs["theirs"])
    plain = jhmdb.JHMDBDataset(small_cfg(root=jhmdb_root), split)
    for i in range(len(ours)):
        a = ours.get(i, np.random.default_rng(i))
        _assert_samples_equal(a, theirs.get(i, np.random.default_rng(i)))
        _assert_samples_equal(a, plain.get(i, np.random.default_rng(i)))


def _jax_model_and_vars(cfg, clip, seed=0):
    jmodel = jbuild_model(cfg)
    variables = jax.device_get(jax.jit(
        lambda k, x: jmodel.init(k, x, train=False))(
            jax.random.PRNGKey(seed), clip))
    randomize_bn(variables["params"], variables["batch_stats"],
                 np.random.default_rng(seed + 1))
    return jmodel, variables


def test_jhmdb_tuber_matches_jax():
    """The JHMDB-mode forward on a 32x64 canvas with padding in both axes:
    every output, float32 through ~20 layers (summation order only)."""
    cfg = small_cfg(JConfig)
    rng = np.random.default_rng(0)
    clip = rng.normal(size=(2, T, 32, 64, 3)).astype(np.float32)
    pad = np.zeros((2, 32, 64), bool)
    pad[0, :, 40:] = True
    pad[1, 24:, :] = True
    jmodel, variables = _jax_model_and_vars(cfg, clip)
    want = jax.jit(lambda v, x, p: jmodel.apply(v, x, p, train=False))(
        variables, clip, pad)
    model = load_jax_variables(build_model(small_cfg()),
                               variables["params"], variables["batch_stats"])
    assert model.query_embed.weight.shape == (Q * T, 64)
    assert model.class_embed_b.weight.shape == (2, 2048)
    assert model.class_fc.weight.shape == (C + 1, 64)
    with torch.inference_mode():
        got = model(torch.from_numpy(clip), torch.from_numpy(pad))
    assert set(got) == set(want)
    assert got["pred_logits_b"].shape == (2, 2)
    assert got["aux_logits_b"].shape == (2, 2, 2)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_postprocess_softmax_matches_jax():
    rng = np.random.default_rng(1)
    out = {"pred_logits": rng.normal(0, 3, (2, Q * T, C + 1)),
           "pred_boxes": rng.uniform(0.1, 0.9, (2, Q * T, 4)),
           "pred_logits_b": rng.normal(0, 2, (2, 2))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    sizes = np.array([[224, 298], [224, 400]], np.float32)
    want = jpost.postprocess_softmax({k: jnp.asarray(v)
                                      for k, v in out.items()}, sizes)
    got = postprocess.postprocess_softmax(
        {k: torch.from_numpy(v) for k, v in out.items()},
        torch.from_numpy(sizes))
    assert got[2].shape == (2, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)


def test_gather_key_frame_queries():
    """Rows key_pos*Q .. key_pos*Q+Q-1 of each sample, for every key
    position, equal to the JAX gather and to the rows themselves."""
    b = T
    x = np.arange(b * Q * T * 2, dtype=np.float32).reshape(b, Q * T, 2)
    key_pos = np.arange(T, dtype=np.int32)[::-1].copy()
    got = tcrit.gather_key_frame_queries(torch.from_numpy(x),
                                         torch.from_numpy(key_pos), Q)
    want = jc.gather_key_frame_queries(jnp.asarray(x), jnp.asarray(key_pos),
                                       Q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i, kp in enumerate(key_pos):
        np.testing.assert_array_equal(got[i].numpy(),
                                      x[i, kp * Q:(kp + 1) * Q])


def _ucf_targets(rng, b, m, n_valid):
    valid = np.arange(m)[None] < np.asarray(n_valid)[:, None]
    cxcy = rng.uniform(0.2, 0.8, (b, m, 2))
    wh = rng.uniform(0.05, 0.4, (b, m, 2))
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    labels = rng.integers(0, C, (b, m)).astype(np.int32)
    vis = (np.asarray(n_valid) > 0).astype(np.int32)
    key_pos = rng.integers(0, T, b).astype(np.int32)
    return boxes, labels, valid, vis, key_pos


def _matched_cost(cost, tfq):
    q = np.arange(cost.shape[1])
    return np.array([cost[i, q[t >= 0], t[t >= 0]].sum()
                     for i, t in enumerate(tfq)])


def test_match_ucf_costs_equal_jax():
    """Softmax class costs with ties (two queries of equal logits and
    boxes) and padded target columns, one sample without targets: the
    assignments are compared by cost (the JAX solver and scipy may take
    different optima on ties), the port's never above the JAX one's."""
    rng = np.random.default_rng(2)
    b, q, m = 4, 5, 4
    n_valid = [3, 1, 0, 4]
    boxes, labels, valid, vis, key_pos = _ucf_targets(rng, b, m, n_valid)
    logits = rng.normal(size=(b, q, C + 1)).astype(np.float32)
    pred = np.concatenate([rng.uniform(0.2, 0.8, (b, q, 2)),
                           rng.uniform(0.05, 0.4, (b, q, 2))],
                          -1).astype(np.float32)
    logits[:, 1], pred[:, 1] = logits[:, 0], pred[:, 0]        # ties
    kw = dict(cost_class=1.0, cost_bbox=5.0, cost_giou=2.0)
    jt = jc.TargetsUCF(*map(jnp.asarray, (boxes, labels, valid, vis,
                                           key_pos)))
    jtfq, _ = jc.match_ucf(jnp.asarray(pred), jnp.asarray(logits), jt, **kw)
    tt = tcrit.TargetsUCF(*map(torch.from_numpy, (boxes, labels, valid, vis,
                                                  key_pos)))
    tfq, _ = tcrit.match_ucf(torch.from_numpy(pred),
                             torch.from_numpy(logits), tt, **kw)
    prob = torch.from_numpy(logits).softmax(-1).numpy()
    cls_cost = -np.take_along_axis(
        prob, np.repeat(labels[:, None, :], q, 1), -1)
    cost = np.asarray(jm.compute_cost_matrix(
        jnp.asarray(pred), jnp.asarray(cls_cost), jnp.asarray(boxes),
        jnp.asarray(valid), 1.0, 5.0, 2.0))
    got, want = _matched_cost(cost, tfq.numpy()), _matched_cost(
        cost, np.asarray(jtfq))
    assert (got <= want + 1e-5).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert [(t >= 0).sum() for t in tfq.numpy()] == [min(q, n)
                                                     for n in n_valid]


@pytest.mark.parametrize("aux_loss,n_valid", [(True, [3, 1]), (False, [2, 4]),
                                              (True, [0, 0])])
def test_criterion_ucf_matches_jax(aux_loss, n_valid):
    """Every entry of the loss dict on random outputs of 3 layers, batch 2,
    Q*T tubelet queries; the last case has no box in the batch (the box
    losses are 0). Continuous random costs: the assignment is unique.
    float32: 1e-5."""
    rng = np.random.default_rng(3)
    lay_n, b, m = 3, 2, 4
    outputs = {"aux_logits": rng.normal(size=(lay_n, b, Q * T, C + 1)),
               "aux_boxes": np.concatenate(
                   [rng.uniform(0.2, 0.8, (lay_n, b, Q * T, 2)),
                    rng.uniform(0.05, 0.4, (lay_n, b, Q * T, 2))], -1),
               "aux_logits_b": rng.normal(size=(lay_n, b, 2))}
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    for k in ("logits", "boxes", "logits_b"):
        outputs[f"pred_{k}"] = outputs[f"aux_{k}"][-1]
    targets = _ucf_targets(rng, b, m, n_valid)
    kw = dict(cost_class=1.0, cost_bbox=5.0, cost_giou=2.0, eos_coef=0.1,
              num_classes=C, num_queries=Q, aux_loss=aux_loss)
    want = jc.criterion_ucf({k: jnp.asarray(v) for k, v in outputs.items()},
                            jc.TargetsUCF(*map(jnp.asarray, targets)), **kw)
    got = tcrit.criterion_ucf(
        {k: torch.from_numpy(v) for k, v in outputs.items()},
        tcrit.TargetsUCF(*map(torch.from_numpy, targets)), **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    if not sum(n_valid):
        assert got["loss_bbox"].item() == got["loss_giou"].item() == 0.0


def _train_batch(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    boxes, labels, valid, vis, key_pos = _ucf_targets(
        rng, b, cfg.data.max_boxes, [3, 1][:b])
    pad = np.zeros((b, 32, 64), bool)
    pad[:, :, 48:] = True
    return {"clips": rng.normal(size=(b, T, 32, 64, 3)).astype(np.float32),
            "pad_mask": pad, "boxes": boxes, "labels": labels,
            "valid": valid, "vis": vis, "key_pos": key_pos,
            "sizes": np.full((b, 2), [32, 48], np.float32)}


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def test_jhmdb_train_step_matches_jax_float64():
    """One whole JHMDB train step (TUNE_POINT 4: stem and layer1-2 frozen,
    their BN in train mode) against ``engine.make_train_step`` of the JAX
    package, float64 on both sides (the JAX float32 CPU backward drifts,
    see test_torch_train_csn.py), dropout off, float clips: the loss dict,
    the gradient norm, the parameters after the step and the BN running
    statistics. Both sides keep parts in float32: the attention softmax of
    the JAX layers, the outputs the losses read (both), and the BN
    statistics of the port's sums; so 1e-5 relative on the losses and the
    BN statistics, and 1e-3 of the learning rate on each parameter's
    update (2% where the gradient is near Adam's epsilon)."""
    cfg = small_cfg(JConfig)
    cfg.model.pretrained = True               # TUNE_POINT 4: stop_grad 2
    cfg.model.dropout = 0.0
    batch = _train_batch(cfg)
    call = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        with jax.enable_x64(True):
            jmodel = jbuild_model(cfg).clone(dtype=jnp.float64)
            state, tx, _ = jengine.create_train_state(
                cfg, jmodel, jax.random.PRNGKey(0), batch,
                steps_per_epoch=10)
            params = jax.device_get(state.params)
            stats = jax.device_get(state.batch_stats)
            randomize_bn(params, stats, np.random.default_rng(1))
            p64 = _f64(params)
            state = state.replace(params=p64, batch_stats=_f64(stats),
                                  opt_state=tx.init(p64))
            new_state, want = jengine.make_train_step(cfg, jmodel, tx)(
                state, {k: (v.astype(np.float64) if v.dtype == np.float32
                            else v) for k, v in batch.items()},
                jax.random.PRNGKey(1), jnp.float64(cfg.loss.dice_cof))
            want = jax.device_get(want)
            jparams, jstats = jax.device_get((new_state.params,
                                              new_state.batch_stats))
    finally:
        fnn.Dropout.__call__ = call

    tcfg = small_cfg()
    tcfg.model.pretrained = True
    tcfg.model.dropout = 0.0
    model = load_jax_variables(build_model(tcfg, train=True), params, stats)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model = model.double()
    model.dtype = torch.float64
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = engine.create_train_state(tcfg, model, steps_per_epoch=10)
    db = engine.device_batch({k: (v.astype(np.float64)
                                  if v.dtype == np.float32 else v)
                              for k, v in batch.items()},
                             torch.device("cpu"))
    got = engine.make_train_step(tcfg, state)(db, tcfg.loss.dice_cof)
    assert got["finite"] == 1.0 and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want_sd = tuber_torch_state_from_params(
        jparams, jstats, block_nums=(1, 1, 1, 1), enc_layers=1,
        dec_layers=2, temporal_ds_strategy="avg", single_frame=True,
        ddp_prefix=False)
    after = model.state_dict()
    lr = {"main": cfg.train.lr, "backbone": cfg.train.lr_backbone}
    from tubelet_transformer_tpu_torch.train.optimizer import param_label

    params_t = dict(model.named_parameters())
    for name in params_t:
        label = param_label(name, tcfg)
        moved = (after[name] - before[name]).numpy()
        want_moved = want_sd[name].astype(np.float64) - before[name].numpy()
        if label == "frozen":
            assert not moved.any(), name
            continue
        # want_sd is float32: its own rounding is within 2 ulp of the
        # weight. Where the clipped gradient is within 2x of Adam's 1e-8
        # epsilon, lr * g / (|g| + eps) turns the ~1e-7 relative error of
        # the float32 parts in g into up to 1% of lr (seen: 0.0098).
        g = params_t[name].grad.numpy()
        diff = np.abs(moved - want_moved)
        tol = 1e-3 * lr[label] + 2 * np.spacing(
            np.abs(before[name].numpy()).astype(np.float32))
        near_eps = np.abs(g) < 2e-8
        assert (diff[~near_eps] <= tol[~near_eps]).all(), name
        assert (diff[near_eps] <= 0.02 * lr[label]).all(), name
    for name in want_sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(after[name].numpy(), want_sd[name],
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def _val_loader(cfg_mod, root):
    cfg = small_cfg(cfg_mod, root)
    ds = (jhmdb if cfg_mod is Config else jjhmdb).JHMDBDataset(cfg, "val")
    return cfg, ds


def test_validate_ucf_matches_jax(jhmdb_root):
    """Frame mAP and video mAP of one set of weights (the class head biased
    to the test videos' first class, the box head near their tubes, so that
    neither is 0) through the port's validate_ucf and the
    JAX package's, float32: within 1e-6."""
    cfg, ds = _val_loader(JConfig, jhmdb_root)
    clip = np.zeros((1, T, 32, 64, 3), np.float32)
    jmodel, variables = _jax_model_and_vars(cfg, clip, seed=3)
    p = variables["params"]
    p["class_fc"]["kernel"] = p["class_fc"]["kernel"] * 0.1
    p["class_fc"]["bias"] = np.array([0.0, 0, 3, 1, 0, -3], np.float32)
    p["bbox_embed"]["layers_2"]["kernel"] = (
        p["bbox_embed"]["layers_2"]["kernel"] * 0.05)
    box = np.array([0.35, 0.72, 0.3, 0.5])
    p["bbox_embed"]["layers_2"]["bias"] = np.log(box / (1 - box)).astype(
        np.float32)
    from tubelet_transformer_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.create_mesh(1, 1, 1, devices=jax.devices()[:1])
    jstate = jengine.TrainState(step=jnp.zeros((), jnp.int32),
                                params=variables["params"],
                                batch_stats=variables["batch_stats"],
                                opt_state=None)
    from tubelet_transformer_tpu.data.loader import DataLoader as JLoader

    jl = JLoader(ds, cfg.val.batch_size, shuffle=False, drop_last=True,
                 pad_to_batch=True, num_workers=2)
    want = jloop.validate_ucf(cfg, jengine.make_eval_step(cfg, jmodel),
                              jstate, jl, mesh, epoch=0)

    tcfg, tds = _val_loader(Config, jhmdb_root)
    model = load_jax_variables(build_model(tcfg), variables["params"],
                               variables["batch_stats"])
    tl = DataLoader(tds, tcfg.val.batch_size, shuffle=False, drop_last=True,
                    pad_to_batch=True, num_workers=2)
    got = loop.validate_ucf(tcfg, engine.make_eval_step(tcfg, model), model,
                            tl, epoch=0)
    assert set(got) == set(want) >= {"mAP", "video_mAP@0.2",
                                     "video_mAP@0.5"}
    assert want["mAP"] > 0 and want["video_mAP@0.2"] > 0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k


def test_jhmdb_cli_train_then_eval(jhmdb_root, tmp_path, monkeypatch):
    """``train_jhmdb`` and ``eval_jhmdb`` through the CLIs' entry on the
    CPU: a checkpoint, frame and video mAP in metrics.jsonl; then the eval
    of that checkpoint, whose weights it serves bit for bit."""
    import json
    import sys

    import yaml

    cfg = small_cfg(root=jhmdb_root)
    cfg.log.base_path = str(tmp_path / "runs")
    cfg.train.epoch_num = 1
    cfg.log.display_freq = 5
    tree = {"CONFIG": {
        sec.upper(): {k.upper(): v for k, v in dataclasses.asdict(
            getattr(cfg, sec)).items()
            if not isinstance(v, (list, tuple, dict))}
        for sec in ("data", "model", "train", "val", "log")}}
    path = tmp_path / "jhmdb.yaml"
    path.write_text(yaml.safe_dump(tree))
    monkeypatch.setattr(sys, "argv", ["train_jhmdb", "--config-file",
                                      str(path), "--device", "cpu"])
    train_jhmdb.main()
    ckpt = glob.glob(str(tmp_path / "runs" / "*" / "checkpoints" /
                         "ckpt_epoch_0"))
    logs = glob.glob(str(tmp_path / "runs" / "*" / "tb_log" /
                         "metrics.jsonl"))
    assert len(ckpt) == len(logs) == 1
    tags = {json.loads(x)["tag"] for x in open(logs[0])}
    assert {"val/val_mAP_epoch", "val/video_mAP@0.2",
            "val/video_mAP@0.5"} <= tags

    tree["CONFIG"]["MODEL"].update(LOAD=True, PRETRAINED_PATH=ckpt[0])
    path.write_text(yaml.safe_dump(tree))
    runs = []
    run_eval = runner.run_eval
    monkeypatch.setattr(runner, "run_eval",
                        lambda *a, **k: runs.append(run_eval(*a, **k)))
    monkeypatch.setattr(sys, "argv", ["eval_jhmdb", "--config-file",
                                      str(path), "--device", "cpu"])
    eval_jhmdb.main()
    assert {"mAP", "video_mAP@0.2"} <= set(runs[0]["val"])
    saved = torch.load(ckpt[0], weights_only=True)["model"]
    for k, v in runs[0]["model"].state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_serving_jhmdb_matches_jax():
    """A JHMDB config serves through postprocess_softmax: at threshold 0
    every one of the Q*T tubelet queries is a detection, the clip-level
    visibility its actor probability; the keyframes, boxes, C+1 scores and
    that probability equal the JAX detector's with the same weights
    (float32: 1e-4 relative, 1e-3 px on the boxes)."""
    from tubelet_transformer_tpu.serving import StreamingDetector as JDet
    from tubelet_transformer_tpu_torch.serving import StreamingDetector

    cfg, jcfg = small_cfg(), small_cfg(JConfig)
    for c in (cfg, jcfg):
        c.data.frame_rate = 1
    jdet = JDet(jcfg, fps=4.0, detect_every=4, actor_threshold=0.0)
    model = load_jax_variables(build_model(cfg), jdet.variables["params"],
                               jdet.variables["batch_stats"])
    det = StreamingDetector(cfg, model, fps=4.0, detect_every=4,
                            actor_threshold=0.0, device="cpu")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
              for _ in range(12)]
    want = [r for f in frames if (r := jdet.push_frame(f)) is not None]
    got = [r for f in frames if (r := det.push_frame(f)) is not None]
    assert [r.frame_index for r in got] == [r.frame_index for r in want]
    assert got
    for g, w in zip(got, want):
        assert len(g.detections) == len(w.detections) == Q * T
        assert len({d.actor_prob for d in g.detections}) == 1
        for d, e in zip(g.detections, w.detections):
            assert d.scores.shape == (C + 1,)
            np.testing.assert_allclose(d.box, e.box, rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(d.scores, e.scores, rtol=1e-4,
                                       atol=1e-5)
            assert abs(d.actor_prob - e.actor_prob) < 1e-5
