"""TubeR's long-term context in the PyTorch port against the JAX package,
on the same numpy-seeded inputs: the LFB-mode TubeR (memories that are
valid, partly padded and fully padded in one batch) and the
``generate_lfb`` mode, the feature bank's ``.npz`` read by the other side,
``BankAttachDataset``, ``generate_bank``, one whole USE_LFB train step in
float64, the LFB parameters' optimizer group, and the runner's refusals
and its generate-lfb -> USE_LFB train -> USE_LFB eval sequence on the CPU.
CSN-TINY, 64 px, T=8, d=64, 1+2 layers, float32 unless stated."""

import glob

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_csn import randomize_bn
from test_torch_tuber import small_cfg

from tubelet_transformer_tpu.cli import runner as jrunner
from tubelet_transformer_tpu.data.loader import DataLoader as JDataLoader
from tubelet_transformer_tpu.data.synthetic import (
    SyntheticAVADataset as JSynthetic)
from tubelet_transformer_tpu.eval import lfb as jlfb
from tubelet_transformer_tpu.models.tuber import build_model as jbuild_model
from tubelet_transformer_tpu.train import engine as jengine
from tubelet_transformer_tpu.train.optimizer import param_labels
from tubelet_transformer_tpu_torch import convert
from tubelet_transformer_tpu_torch.cli import generate_lfb, runner
from tubelet_transformer_tpu_torch.convert import load_jax_variables
from tubelet_transformer_tpu_torch.data.device_preprocess import (
    device_preprocess)
from tubelet_transformer_tpu_torch.data.loader import DataLoader
from tubelet_transformer_tpu_torch.data.synthetic import SyntheticAVADataset
from tubelet_transformer_tpu_torch.eval import lfb
from tubelet_transformer_tpu_torch.models.layers import Dropout
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.train import engine
from tubelet_transformer_tpu_torch.train.optimizer import (
    build_optimizer, param_label)

L_MEM = 6
LFB_MODULES = ("lfb_proj", "lfb_attn", "lfb_norm")


def lfb_cfg(use_lfb=True, generate=False):
    cfg = small_cfg("avg")
    cfg.use_lfb = use_lfb
    cfg.model.generate_lfb = generate
    return cfg


def _memory(rng, b=3):
    """Memories of ``b`` clips: row 0 valid, row 1 partly padded, row 2
    (and beyond) fully padded."""
    feats = rng.normal(size=(b, L_MEM, 64)).astype(np.float32)
    mask = np.ones((b, L_MEM), bool)
    mask[0] = False
    mask[1:2, :L_MEM // 2] = False
    return feats, mask


def _jax_model(cfg, clip, feats, mask, seed=0):
    jmodel = jbuild_model(cfg)
    kw = {} if feats is None else dict(lfb_features=feats, lfb_mask=mask)
    variables = jax.device_get(jax.jit(
        lambda k, x: jmodel.init(k, x, train=False, **kw))(
            jax.random.PRNGKey(seed), clip))
    randomize_bn(variables["params"], variables["batch_stats"],
                 np.random.default_rng(seed + 1))
    return jmodel, variables


def _port(cfg, variables, train=False):
    return load_jax_variables(build_model(cfg, train=train),
                              variables["params"], variables["batch_stats"])


def _assert_outputs(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        # float32: summation order only, through ~20 layers
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_lfb_tuber_matches_jax():
    """The LFB-mode forward with memories valid, partly padded and fully
    padded in one batch: every output within 1e-4 of the JAX model's; the
    fully padded row is the forward of its clip with any other fully padded
    memory (the memory adds nothing: the mask-safe residual); the boxes do
    not depend on the memory."""
    cfg = lfb_cfg()
    rng = np.random.default_rng(0)
    clip = rng.normal(size=(3, 8, 64, 64, 3)).astype(np.float32)
    pad = np.zeros((3, 64, 64), bool)
    pad[1, 40:] = True
    feats, mask = _memory(rng)
    jmodel, variables = _jax_model(cfg, clip, feats, mask)
    want = jax.jit(lambda v, x, p, f, m: jmodel.apply(
        v, x, p, train=False, lfb_features=f, lfb_mask=m,
        return_features=True))(variables, clip, pad, feats, mask)
    model = _port(cfg, variables)
    assert all(hasattr(model, m) for m in LFB_MODULES)
    t = torch.from_numpy
    with torch.inference_mode():
        got = model(t(clip), t(pad), return_features=True,
                    lfb_features=t(feats), lfb_mask=t(mask))
        other = model(t(clip[2:]), t(pad[2:]), return_features=True,
                      lfb_features=t(rng.normal(size=(1, 4, 64)).astype(
                          np.float32)), lfb_mask=torch.ones(1, 4,
                                                            dtype=torch.bool))
        open_ = model(t(clip), t(pad), return_features=True,
                      lfb_features=t(feats),
                      lfb_mask=torch.zeros(3, L_MEM, dtype=torch.bool))
    _assert_outputs(got, want)
    for k in got:
        row = got[k][:, 2:] if k.startswith("aux_") else got[k][2:]
        torch.testing.assert_close(row, other[k], rtol=0, atol=1e-6)
    assert torch.isfinite(got["pred_logits"]).all()
    assert (got["pred_logits"][1] - open_["pred_logits"][1]).abs().max() > 1e-4
    torch.testing.assert_close(got["pred_boxes"], open_["pred_boxes"])


def test_generate_lfb_mode_matches_jax():
    """MODEL.GENERATE_LFB: the final layer's query features, actorness
    logits and boxes, and nothing else, as the JAX model returns them."""
    cfg = lfb_cfg(use_lfb=False, generate=True)
    rng = np.random.default_rng(1)
    clip = rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32)
    pad = np.zeros((2, 64, 64), bool)
    pad[0, :, 48:] = True
    jmodel, variables = _jax_model(cfg, clip, None, None, seed=2)
    want = jax.jit(lambda v, x, p: jmodel.apply(v, x, p, train=False))(
        variables, clip, pad)
    assert set(want) == {"lfb_features", "pred_logits_b", "pred_boxes"}
    with torch.inference_mode():
        got = _port(cfg, variables)(torch.from_numpy(clip),
                                    torch.from_numpy(pad))
    _assert_outputs(got, want)


def _fill(bank, rng, keys, q=5):
    for key in keys:
        bank.add(key, rng.normal(size=(q, bank.feat_dim)).astype(np.float32),
                 rng.uniform(size=q), threshold=0.5)


def test_bank_npz_round_trips_between_packages(tmp_path):
    """A bank saved by either side loads in the other with the same keys,
    and every window of the loaded banks equals the JAX window."""
    keys = ["vidA,0901", "vidA,0902", "vidA,0904", "vidB,0903"]
    ours, theirs = lfb.FeatureBank(8, 3), jlfb.FeatureBank(8, 3)
    _fill(ours, np.random.default_rng(3), keys)
    _fill(theirs, np.random.default_rng(3), keys)
    ours.save(str(tmp_path / "ours.npz"))
    theirs.save(str(tmp_path / "theirs.npz"))
    loaded = [jlfb.FeatureBank.load(str(tmp_path / "ours.npz")),
              lfb.FeatureBank.load(str(tmp_path / "theirs.npz")),
              lfb.FeatureBank.load(str(tmp_path / "ours.npz"))]
    for bank in loaded:
        assert len(bank) == 4 and (bank.feat_dim, bank.slots) == (8, 3)
    for vid, sec, hw in [("vidA", 903, 2), ("vidA", 900, 1), ("vidB", 902, 3),
                         ("vidC", 903, 2)]:
        want = theirs.window(vid, sec, hw)
        for bank in loaded:
            for g, w in zip(bank.window(vid, sec, hw), want):
                np.testing.assert_array_equal(g, w)


def test_bank_attach_follows_resampled_index():
    """The memory window follows the keyframe the base dataset returned
    (its key_idx), not the index asked for, as the JAX wrapper's does."""
    class Resampling:
        keys = ["vidA,0900", "vidB,0900"]

        def __len__(self):
            return 2

        def get(self, index, rng):
            return {"key_idx": np.int32(1)}

    banks = []
    for module in (lfb, jlfb):
        bank = module.FeatureBank(feat_dim=4, slots_per_frame=1)
        bank.add("vidB,0901", np.full((1, 4), 3.0, np.float32),
                 np.array([0.99]))
        banks.append(module.BankAttachDataset(Resampling(), bank,
                                              half_window=1))
    got, want = (b.get(0, None) for b in banks)
    assert not got["lfb_mask"][1:].any()
    for k in ("lfb_features", "lfb_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    assert banks[0].keys == Resampling.keys
    with pytest.raises(ValueError, match="keys"):
        lfb.BankAttachDataset(object(), banks[0].bank)


def _loader(loader_cls, dataset_cls, cfg):
    ds = dataset_cls(cfg, size=4)
    ds.keys = [f"vid0,{900 + i:04d}" for i in range(4)]   # AVA-style keys
    return loader_cls(ds, batch_size=2, shuffle=False, num_workers=1)


def test_generate_bank_matches_jax():
    """generate_bank over the same samples and weights: the same keys,
    features within 1e-4, and the same validity wherever the actor
    probability is more than 1e-4 from the threshold (the median one)."""
    cfg = lfb_cfg(use_lfb=False, generate=True)
    cfg.data.dataset_name = "synthetic"
    cfg.data.max_boxes = 4
    jloader = _loader(JDataLoader, JSynthetic, cfg)
    loader = _loader(DataLoader, SyntheticAVADataset, cfg)
    clip = np.zeros((1, 8, 64, 64, 3), np.float32)
    jmodel, variables = _jax_model(cfg, clip, None, None, seed=4)
    model = _port(cfg, variables)
    probs = []
    for batch in loader:
        with torch.inference_mode():
            out = model(device_preprocess(torch.from_numpy(batch["clips"])))
        probs.append(out["pred_logits_b"].softmax(-1)[..., 1].numpy())
    probs = np.concatenate(probs)                          # (4, Q)
    threshold = float(np.median(probs))
    want = jlfb.generate_bank(cfg, jmodel, variables, jloader, mesh=None,
                              threshold=threshold)
    got = lfb.generate_bank(cfg, model, loader, threshold=threshold)
    assert list(got._bank) == list(want._bank) == loader.dataset.keys
    n_valid = 0
    for i, key in enumerate(want._bank):
        np.testing.assert_allclose(got._bank[key], want._bank[key],
                                   rtol=1e-4, atol=1e-4, err_msg=key)
        top = np.sort(probs[i])[::-1][:got.slots]
        far = np.abs(top - threshold) > 1e-4
        np.testing.assert_array_equal(got._valid[key][far],
                                      want._valid[key][far], err_msg=key)
        n_valid += got._valid[key].sum()
    assert 0 < n_valid < 4 * got.slots


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _f64_batch(batch):
    return {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
            for k, v in batch.items()}


def _train_batch(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    m, c, img = cfg.data.max_boxes, cfg.data.num_classes, cfg.data.img_size
    valid = np.arange(m)[None] < np.array([[3], [2]])[:b]
    labels = (rng.uniform(size=(b, m, c)) < 0.3).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (b, m, 2)),
                            rng.uniform(0.1, 0.3, (b, m, 2))], -1)
    feats, mask = _memory(rng, b=b)
    mask[1] = True                   # the second clip's memory fully padded
    return {"clips": rng.normal(size=(b, cfg.data.temp_len, img, img, 3)
                                ).astype(np.float32),
            "pad_mask": np.zeros((b, img, img), bool),
            "boxes": boxes.astype(np.float32), "labels": labels,
            "valid": valid, "sizes": np.full((b, 2), img, np.float32),
            "lfb_features": feats, "lfb_mask": mask}


def test_lfb_train_step_matches_jax_float64():
    """One whole USE_LFB train step (TUNE_POINT 4) with a memory attached
    (one clip's valid, the other's fully padded) against
    ``engine.make_train_step`` of the JAX package, float64 on both sides,
    dropout off: the loss dict and the gradient norm within 1e-5, each
    parameter's update, the LFB modules' included, within 1e-3 of the
    learning rate, and 2% of it where the gradient is within 10x of Adam's
    epsilon, as test_torch_jhmdb.py holds the JHMDB step."""
    cfg = lfb_cfg()
    cfg.data.max_boxes = 4
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
                state, _f64_batch(batch), jax.random.PRNGKey(1),
                jnp.float64(cfg.loss.dice_cof))
            want = jax.device_get(want)
            jparams, jstats = jax.device_get((new_state.params,
                                              new_state.batch_stats))
    finally:
        fnn.Dropout.__call__ = call
    assert set(LFB_MODULES) <= set(params)

    model = _port(cfg, {"params": params, "batch_stats": stats}, train=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model = model.double()
    model.dtype = torch.float64
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = engine.create_train_state(cfg, model, steps_per_epoch=10)
    got = engine.make_train_step(cfg, state)(
        engine.device_batch(_f64_batch(batch), torch.device("cpu")),
        cfg.loss.dice_cof)
    assert got["finite"] == 1.0 and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want_sd = convert.tuber_torch_state_from_params(
        jparams, jstats, block_nums=(1, 1, 1, 1), enc_layers=1,
        dec_layers=2, temporal_ds_strategy="avg", single_frame=True,
        ddp_prefix=False)
    after = model.state_dict()
    lr = {"main": cfg.train.lr, "backbone": cfg.train.lr_backbone}
    lfb_moved = 0
    for name, p in model.named_parameters():
        label = param_label(name, cfg)
        moved = (after[name] - before[name]).numpy()
        want_moved = want_sd[name].astype(np.float64) - before[name].numpy()
        if label == "frozen":
            assert not moved.any(), name
            continue
        lfb_moved += name.startswith(LFB_MODULES) and bool(moved.any())
        g = p.grad.numpy()
        diff = np.abs(moved - want_moved)
        tol = 1e-3 * lr[label] + 2 * np.spacing(
            np.abs(before[name].numpy()).astype(np.float32))
        # lr * g / (|g| + eps) passes a relative error d of g on as
        # lr * d * eps / (|g| + eps): near eps, the float32 parts of both
        # sides (the attention softmax, the loss inputs) show; seen: 2
        # weights of class_proj at |g| = 2.5e-8 off by 1.5e-3 lr
        near_eps = np.abs(g) < 1e-7
        assert (diff[~near_eps] <= tol[~near_eps]).all(), name
        assert (diff[near_eps] <= 0.02 * lr[label]).all(), name
    assert lfb_moved == len([n for n, _ in model.named_parameters()
                             if n.startswith(LFB_MODULES)])
    for name in want_sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(after[name].numpy(), want_sd[name],
                                       rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("pretrained", [False, True])
def test_lfb_parameters_in_the_main_group(pretrained):
    """The LFB parameters are 'main' as JAX's ``param_labels`` labels them,
    whatever the freezing, and sit in the optimizer's main group."""
    cfg = lfb_cfg()
    cfg.model.pretrained = pretrained
    rng = np.random.default_rng(5)
    clip = rng.normal(size=(1, 8, 64, 64, 3)).astype(np.float32)
    feats, mask = _memory(rng, b=1)
    _, variables = _jax_model(cfg, clip, feats, mask)
    labels = param_labels(variables["params"], cfg)
    want = set(jax.tree.leaves({m: labels[m] for m in LFB_MODULES}))
    model = build_model(cfg, train=True)
    names = [n for n, _ in model.named_parameters()
             if n.startswith(LFB_MODULES)]
    assert len(names) == 8 and want == {"main"}
    assert {param_label(n, cfg) for n in names} == want
    group = {id(p) for g in build_optimizer(cfg, model).param_groups
             if g["name"] == "main" for p in g["params"]}
    assert all(id(p) in group for n, p in model.named_parameters()
               if n.startswith(LFB_MODULES))


def test_generate_lfb_requires_load_as_jax():
    for run, cfg in ((runner.run_generate_lfb, lfb_cfg(use_lfb=False)),
                     (jrunner.run_generate_lfb, lfb_cfg(use_lfb=False))):
        with pytest.raises(ValueError, match="MODEL.LOAD"):
            run(cfg)


def test_use_lfb_without_bank_path_raises_as_jax():
    cfg = lfb_cfg()
    cfg.data.dataset_name = "synthetic"
    for build in (runner.build_dataset, jrunner.build_dataset):
        with pytest.raises(ValueError, match="LFB.BANK_PATH"):
            build(cfg, "val")


def test_generate_lfb_then_train_and_eval_with_lfb(tmp_path, monkeypatch):
    """On the CPU: the generate_lfb CLI over a checkpoint writes a bank with
    one key per val keyframe; a USE_LFB train run over it takes its steps
    with the memory attached (finite losses, the LFB weights moved and
    saved), and run_eval of its checkpoint reads them back."""
    cfg = small_cfg("avg")
    cfg.data.dataset_name = "synthetic"
    cfg.data.synthetic_size = 4
    cfg.data.img_size = 32
    cfg.data.max_boxes = 4
    cfg.data.num_workers = 1
    cfg.train.batch_size = cfg.val.batch_size = 2
    cfg.train.epoch_num = 1
    cfg.log.base_path = str(tmp_path / "runs")
    cfg.log.display_freq = 1
    ckpt = tmp_path / "seed.pth"
    torch.save({"model": build_model(cfg, seed=5).state_dict()}, ckpt)

    gen = tmp_path / "gen.yaml"
    gen.write_text(
        "CONFIG:\n  DATA:\n    DATASET_NAME: synthetic\n"
        "    SYNTHETIC_SIZE: 4\n    IMG_SIZE: 32\n    NUM_CLASSES: 5\n"
        "    TEMP_LEN: 8\n    NUM_WORKERS: 1\n"
        "  MODEL:\n    BACKBONE_NAME: CSN-TINY\n    QUERY_NUM: 5\n"
        "    TEMP_LEN: 8\n    ENC_LAYERS: 1\n    DEC_LAYERS: 2\n"
        "    D_MODEL: 64\n    NHEAD: 4\n    DIM_FEEDFORWARD: 64\n"
        "    COMPUTE_DTYPE: float32\n    TEMPORAL_DS_STRATEGY: avg\n"
        f"    LOAD: true\n    PRETRAINED_PATH: {ckpt}\n"
        "  VAL:\n    BATCH_SIZE: 2\n")
    bank_path = tmp_path / "bank.npz"
    monkeypatch.setattr("sys.argv", [
        "generate_lfb", "--config-file", str(gen), "--out", str(bank_path),
        "--device", "cpu"])
    generate_lfb.main()
    bank = lfb.FeatureBank.load(str(bank_path))
    assert sorted(bank._bank) == [f"synth,{900 + i:04d}" for i in range(4)]
    assert (bank.feat_dim, bank.slots) == (64, 5)
    # random weights: their actor probabilities mean nothing, so every
    # slot is admitted and the memory trains lfb_attn
    for k, v in bank._valid.items():
        bank._valid[k] = np.ones_like(v)
    bank.save(str(bank_path))

    cfg.use_lfb = True
    cfg.lfb.bank_path = str(bank_path)
    cfg.lfb.half_window = 1
    steps = []
    make = engine.make_train_step

    def recording(cfg_, state, **kw):
        step = make(cfg_, state, **kw)

        def run(batch, weight):
            assert batch["lfb_features"].shape == (2, 2 * 5, 64)
            steps.append(step(batch, weight))
            return steps[-1]
        return run

    monkeypatch.setattr(engine, "make_train_step", recording)
    result = runner.run_training(cfg, device="cpu", seed=5)
    assert len(steps) == 2 and all(float(s["finite"]) == 1.0 for s in steps)
    assert np.isfinite(result["val"]["mAP"])
    saved = glob.glob(str(tmp_path / "runs" / "*" / "checkpoints" /
                          "ckpt_epoch_0"))[0]
    trained = torch.load(saved, weights_only=True)["model"]
    start = build_model(cfg, seed=5, train=True).state_dict()
    assert all(not torch.equal(trained[k], start[k]) for k in trained
               if k.startswith(LFB_MODULES))

    cfg.model.load, cfg.model.pretrained_path = True, saved
    evaluated = runner.run_eval(cfg, device="cpu")
    assert np.isfinite(evaluated["val"]["mAP"])
    for k, v in evaluated["model"].state_dict().items():
        if k.startswith(LFB_MODULES):
            torch.testing.assert_close(v, trained[k], rtol=0, atol=0)
