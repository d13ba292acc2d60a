"""Weights in: the port's loaders of the released formats
(train/checkpoint.py, convert.py) against the JAX package's, on files
written from random port weights in the released layouts
(tools/fixtures.py): the Caffe2 CSN ``.mat`` backbone, the COCO DETR
``detr.pth`` seed and a TubeR ``.pth`` with and without the DDP ``module.``
prefix. The JAX loaders run on the same starting weights (the port's state
converted to JAX variables by ``tuber_params_from_torch_state``); after each
load the port's state must equal ``tuber_torch_state_from_params`` of the
JAX-loaded variables bit for bit. Then the eval runner (``run_eval``)
against the JAX one from one ``.pth`` on the synthetic set, its refusal
without ``MODEL.LOAD``, the detection dump, and the serving CLI with
``MODEL.LOAD``. CSN-TINY (CSN-50 for the ``.mat``, the smallest topology
with Caffe2 block numbers), float32 on the CPU."""

import json
import sys

import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401
import yaml
from test_torch_tuber import small_cfg

from tubelet_transformer_tpu.cli import runner as jrunner
from tubelet_transformer_tpu.train import checkpoint as jckpt
from tubelet_transformer_tpu.train import torch_convert as tc
from tubelet_transformer_tpu_torch import convert
from tubelet_transformer_tpu_torch.cli import runner
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.tools import fixtures
from tubelet_transformer_tpu_torch.train import checkpoint as ckpt_lib

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfg(backbone="CSN-TINY"):
    cfg = small_cfg("avg")
    cfg.model.backbone_name = backbone
    return cfg


def _kw(cfg, model):
    return dict(block_nums=model.backbone.body.block_nums,
                enc_layers=cfg.model.enc_layers,
                dec_layers=cfg.model.dec_layers,
                temporal_ds_strategy=cfg.model.temporal_ds_strategy,
                single_frame=cfg.model.single_frame)


def _jax_variables(cfg, model):
    """The port model's weights as JAX variables (the JAX package's own
    import of a reference-named state dict)."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = tc.tuber_params_from_torch_state(sd, **_kw(cfg, model))
    return {"params": params, "batch_stats": stats}


def _assert_state_is(model, want):
    """``model``'s state equals ``want`` (numpy, reference names) bit for
    bit, every tensor but BN's num_batches_tracked."""
    got = model.state_dict()
    names = [k for k in got if not k.endswith("num_batches_tracked")]
    assert set(names) <= set(want)
    for k in names:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def _assert_port_equals_jax(cfg, model, jvars):
    _assert_state_is(model, tc.tuber_torch_state_from_params(
        jvars["params"], jvars["batch_stats"], ddp_prefix=False,
        **_kw(cfg, model)))


def _pair(cfg, seed=0):
    model = build_model(cfg, seed=seed, train=True)
    return model, _jax_variables(cfg, model)


def test_mat_blocks_match_jax():
    assert convert.MAT_START_COUNT == tc.MAT_START_COUNT


def test_backbone_mat_matches_jax(tmp_path):
    """CSN-50's .mat into a seed-0 build: the backbone becomes the seed-1
    model's, the rest stays; parameters only, no forward."""
    cfg = _cfg("CSN-50")
    src = build_model(cfg, seed=1, train=True).state_dict()
    path = fixtures.write_csn_mat(str(tmp_path / "csn50.mat"), src,
                                  (3, 4, 6, 3))
    model, jvars = _pair(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jvars = jckpt.load_backbone_mat(cfg, jvars, path)
    ckpt_lib.load_backbone_mat(cfg, model, path)
    _assert_port_equals_jax(cfg, model, jvars)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        want = src[k] if k.startswith("backbone.body.") else before[k]
        assert torch.equal(v, want), k


@pytest.mark.parametrize("rows", [100, 3])
def test_detr_seed_matches_jax(tmp_path, rows):
    """A DETR file of 100 query rows seeds the first 5; one of 3 rows
    leaves the 5 query rows as they are. The DETR ResNet entries and its 2-D
    input_proj are skipped."""
    cfg = _cfg()
    src = build_model(cfg, seed=1, train=True).state_dict()
    path = fixtures.write_detr_pth(str(tmp_path / "detr.pth"), src,
                                   n_queries=rows)
    model, jvars = _pair(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jvars = jckpt.seed_from_detr(cfg, jvars, path)
    ckpt_lib.seed_from_detr(cfg, model, path)
    _assert_port_equals_jax(cfg, model, jvars)
    q = torch.load(path, weights_only=False)["model"]["query_embed.weight"]
    got = model.state_dict()
    assert torch.equal(got["query_embed.weight"],
                       q[:5] if rows >= 5 else before["query_embed.weight"])
    for k, v in got.items():
        if k.startswith(("transformer.", "bbox_embed.")):
            assert torch.equal(v, src[k]), k
        elif k != "query_embed.weight":
            assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("ddp_prefix", [True, False])
def test_tuber_pth_matches_jax(tmp_path, ddp_prefix):
    cfg = _cfg()
    src = build_model(cfg, seed=1, train=True).state_dict()
    path = fixtures.write_tuber_pth(str(tmp_path / "tuber.pth"), src,
                                    ddp_prefix=ddp_prefix)
    model, jvars = _pair(cfg)
    jvars = jckpt.load_tuber_pth(cfg, jvars, path)
    ckpt_lib.load_tuber_pth(cfg, model, path)
    _assert_port_equals_jax(cfg, model, jvars)
    _assert_state_is(model, {k: v.numpy() for k, v in src.items()})


def test_shape_mismatch_raises_as_jax(tmp_path):
    cfg = _cfg()
    other = _cfg()
    other.data.num_classes = 7
    path = fixtures.write_tuber_pth(
        str(tmp_path / "tuber.pth"),
        build_model(other, seed=1, train=True).state_dict())
    model, jvars = _pair(cfg)
    with pytest.raises(ValueError, match="shape mismatch"):
        jckpt.load_tuber_pth(cfg, jvars, path)
    with pytest.raises(ValueError, match="shape mismatch at class_fc"):
        ckpt_lib.load_tuber_pth(cfg, model, path)


@pytest.mark.parametrize("load", [False, True])
def test_load_pretrained_order_matches_jax(tmp_path, load):
    """PRETRAINED (.mat), then LOAD_DETR, then LOAD with PRETRAINED_PATH,
    each from another seed: the later files win where they overlap."""
    cfg = _cfg("CSN-50")
    srcs = [build_model(cfg, seed=s, train=True).state_dict()
            for s in (1, 2, 3)]
    cfg.model.pretrained = True
    cfg.model.pretrain_backbone_dir = fixtures.write_csn_mat(
        str(tmp_path / "b.mat"), srcs[0], (3, 4, 6, 3))
    cfg.model.load_detr = True
    cfg.model.pretrain_transformer_dir = fixtures.write_detr_pth(
        str(tmp_path / "detr.pth"), srcs[1])
    cfg.model.load = load
    cfg.model.pretrained_path = fixtures.write_tuber_pth(
        str(tmp_path / "t.pth"), srcs[2])
    model, jvars = _pair(cfg)
    jvars = jckpt.load_pretrained(cfg, jvars)
    assert ckpt_lib.load_pretrained(cfg, model) is model
    _assert_port_equals_jax(cfg, model, jvars)
    if load:
        _assert_state_is(model, {k: v.numpy() for k, v in srcs[2].items()})


def test_orbax_directory_is_refused(tmp_path):
    cfg = _cfg()
    cfg.model.load, cfg.model.pretrained_path = True, str(tmp_path)
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt_lib.load_pretrained(cfg, build_model(cfg))


def _synthetic_cfg(cfg, tmp_path):
    cfg.data.dataset_name = "synthetic"
    cfg.data.synthetic_size = 6
    cfg.data.img_size = 32
    cfg.data.num_workers = 2
    cfg.val.batch_size = 2
    cfg.log.base_path = str(tmp_path / "runs")
    return cfg


def test_eval_requires_load_as_jax(tmp_path):
    cfg = _synthetic_cfg(_cfg(), tmp_path)
    errors = []
    for run in (jrunner.run_eval, lambda c: runner.run_eval(c, "cpu")):
        with pytest.raises(ValueError) as err:
            run(cfg)
        errors.append(str(err.value))
    assert errors[0] == errors[1] == ("eval requires MODEL.LOAD with "
                                      "PRETRAINED_PATH")


def test_run_eval_matches_jax(tmp_path):
    """One TubeR .pth (BN statistics randomised) evaluated by both runners
    on the synthetic set: the frame mAP and the person AP, float32, within
    1e-6 (the evaluators see the same scores to ~1e-6, which reorders no
    detection). The checkpoint's actor head is biased so that every query
    clears the 0.8 gate by a wide margin: a query near the gate would flip
    under float32 summation order (ROADMAP C2) and move the frame mAP by a
    whole detection; and its box head puts every query near the left one of
    DATA.SYNTHETIC_EASY's two boxes, so that the APs are not 0. The mean
    eval losses are not compared: they follow the matching, and the JAX
    solver, whose float32 potentials sit next to PAD_COST, misses the
    optimum here by less than the 0.06 of its rounding (ROADMAP C3;
    tests/test_torch_criterion.py compares the losses where the assignment
    is unique)."""
    from test_torch_csn import randomize_bn

    cfg = _synthetic_cfg(_cfg(), tmp_path)
    cfg.data.synthetic_easy = True
    model, jvars = _pair(cfg, seed=1)
    randomize_bn(jvars["params"], jvars["batch_stats"],
                 np.random.default_rng(2))
    sd = tc.tuber_torch_state_from_params(
        jvars["params"], jvars["batch_stats"], ddp_prefix=True,
        **_kw(cfg, model))
    sd["module.class_embed_b.bias"] = np.array([0.0, 6.0, 0.0], np.float32)
    sd["module.bbox_embed.layers.2.weight"] *= 0.1
    box = np.array([0.3, 0.5, 0.4, 0.4])
    sd["module.bbox_embed.layers.2.bias"] = np.log(box / (1 - box)).astype(
        np.float32)
    path = str(tmp_path / "tuber.pth")
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}}, path)
    cfg.model.load, cfg.model.pretrained_path = True, path
    want = jrunner.run_eval(cfg)
    got = runner.run_eval(cfg, device="cpu")
    _assert_state_is(got["model"], {k[7:]: v for k, v in sd.items()})
    got = got["val"]
    assert 0.0 < want["mAP"] and 0.0 < want["person_AP"]
    for k in ("mAP", "person_AP"):
        assert abs(got[k] - want[k]) <= 1e-6, k


def test_validate_ava_dump_dir(tmp_path):
    """``dump_dir``: one row per query of each keyframe (the wrap-padded
    repeats once), the detections the evaluator was given."""
    from tubelet_transformer_tpu_torch.eval.ava_eval import _parse_txt
    from tubelet_transformer_tpu_torch.train import engine, loop

    cfg = _synthetic_cfg(_cfg(), tmp_path)
    cfg.data.synthetic_size = 5                 # a wrap-padded tail
    model = build_model(cfg, seed=1)
    _, val_loader = runner.make_loaders(cfg, val_only=True)
    out = loop.validate_ava(cfg, engine.make_eval_step(cfg, model), model,
                            val_loader, 0, dump_dir=str(tmp_path / "dump"))
    assert "mAP" in out
    rows = (tmp_path / "dump" / "0.txt").read_text().splitlines()
    assert len(rows) == 5 * cfg.model.query_num
    parsed = list(_parse_txt([str(tmp_path / "dump" / "0.txt")], set()))
    assert len({key for key, _ in parsed}) == 5
    # box, the class scores and P(actor)
    assert {len(v) for _, v in parsed} == {4 + cfg.data.num_classes + 1}


def test_serve_cli_loads_checkpoint(tmp_path, monkeypatch, capsys):
    """``cli/serve`` with MODEL.LOAD and PRETRAINED_PATH (a port
    ckpt_epoch_N) serves those weights: its model equals the checkpoint's
    bit for bit, and keyframes are served."""
    from tubelet_transformer_tpu_torch import serving
    from tubelet_transformer_tpu_torch.cli import serve

    cfg = _cfg()
    src = build_model(cfg, seed=4, train=True)
    path = tmp_path / "ckpt_epoch_0"
    torch.save({"model": src.state_dict(), "epoch": 0}, path)
    tree = {"CONFIG": {
        "DATA": {"NUM_CLASSES": 5, "IMG_SIZE": 64, "TEMP_LEN": 8,
                 "FRAME_RATE": 1},
        "MODEL": {"BACKBONE_NAME": "CSN-TINY", "QUERY_NUM": 5,
                  "TEMP_LEN": 8, "ENC_LAYERS": 1, "DEC_LAYERS": 2,
                  "D_MODEL": 64, "NHEAD": 4, "DIM_FEEDFORWARD": 64,
                  "COMPUTE_DTYPE": "float32",
                  "TEMPORAL_DS_STRATEGY": "avg", "LOAD": True,
                  "PRETRAINED_PATH": str(path)}}}
    cfg_path = tmp_path / "serve.yaml"
    cfg_path.write_text(yaml.safe_dump(tree))
    made = []
    cls = serving.StreamingDetector
    monkeypatch.setattr(serving, "StreamingDetector",
                        lambda *a, **k: made.append(cls(*a, **k)) or made[-1])
    monkeypatch.setattr(sys, "argv", [
        "serve", "--config-file", str(cfg_path), "--num-frames", "12",
        "--fps", "4", "--device", "cpu"])
    serve.main()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [d["keyframe"] for d in lines if "keyframe" in d]
    _assert_state_is(made[0].model, {k: v.numpy() for k, v in
                                     src.state_dict().items()})
