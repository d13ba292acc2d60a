"""The port's own copies of the JAX package's jax-free modules against the
originals: the configuration schema and its YAML mapping, the synthetic set
and the loader, the AVA frame-mAP evaluator, and the export of flax
variables to the reference's state dict."""

import dataclasses
import glob
from pathlib import Path

import jax
import numpy as np
import pytest

from tubelet_transformer_tpu import config as jconfig
from tubelet_transformer_tpu.data import loader as jloader
from tubelet_transformer_tpu.data import synthetic as jsynthetic
from tubelet_transformer_tpu.eval import ava_eval as java_eval
from tubelet_transformer_tpu.models.tuber import build_model as jbuild_model
from tubelet_transformer_tpu.train import torch_convert
from tubelet_transformer_tpu_torch import config, convert
from tubelet_transformer_tpu_torch.data import loader, synthetic
from tubelet_transformer_tpu_torch.eval import ava_eval

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(ROOT / "configuration" / "*.yaml")))


def test_every_configuration_is_covered():
    assert len(CONFIGS) >= 4


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).stem)
def test_load_config_matches_jax(path):
    ours, theirs = config.load_config(path), jconfig.load_config(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.num_queries_total, ours.temporal_feat_len) == (
        theirs.num_queries_total, theirs.temporal_feat_len)


def _small(cfg_module):
    cfg = cfg_module.Config()
    cfg.data.dataset_name = "synthetic"
    cfg.data.img_size = 32
    cfg.data.temp_len = cfg.model.temp_len = 4
    cfg.data.num_classes = 5
    return cfg


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_items_and_batches_match_jax(seed):
    sets = [mod.SyntheticAVADataset(_small(cfg), size=6)
            for mod, cfg in ((synthetic, config), (jsynthetic, jconfig))]
    for i in range(len(sets[0])):
        ours, theirs = (s.get(i, np.random.default_rng(seed + i))
                        for s in sets)
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(np.asarray(ours[k]),
                                          np.asarray(theirs[k]), err_msg=k)
    batches = [list(mod.DataLoader(s, 2, shuffle=True, seed=seed,
                                   num_workers=2))
               for mod, s in ((loader, sets[0]), (jloader, sets[1]))]
    assert len(batches[0]) == len(batches[1]) == 3
    for ours, theirs in zip(*batches):
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(np.asarray(ours[k]),
                                          np.asarray(theirs[k]), err_msg=k)


def test_ava_frame_map_matches_jax():
    rng = np.random.default_rng(3)
    evals = [mod.AVADetectionEvaluator(class_num=6)
             for mod in (ava_eval, java_eval)]
    for i in range(12):
        key = f"vid{i // 4},{900 + i:04d}"
        n_gt, n_det = rng.integers(1, 4), 5
        xy = rng.uniform(0, 200, (n_gt, 2))
        gt = np.concatenate([xy, xy + rng.uniform(20, 80, (n_gt, 2))], 1)
        labels = (rng.uniform(size=(n_gt, 6)) < 0.4).astype(np.float32)
        det = np.concatenate([gt, gt[:1] + 30.0])[:n_det]
        det = det + rng.normal(0, 6, det.shape)
        scores = rng.uniform(size=(det.shape[0], 6)).astype(np.float32)
        for ev in evals:
            ev.add_ground_truth(key, gt, labels)
            ev.add_detections(key, det, scores)
    (ours, ours_res), (theirs, theirs_res) = (ev.evaluate() for ev in evals)
    assert 0.0 < ours[0] < 1.0
    assert ours == theirs and ours_res == theirs_res


def test_torch_state_matches_jax_export():
    cfg = jconfig.Config()
    cfg.data.num_classes = 5
    cfg.model.backbone_name = "CSN-TINY"
    cfg.model.query_num = 5
    cfg.model.enc_layers, cfg.model.dec_layers = 1, 2
    cfg.model.d_model, cfg.model.nhead, cfg.model.dim_feedforward = 64, 4, 64
    cfg.model.compute_dtype = "float32"
    clip = np.zeros((1, 8, 64, 64, 3), np.float32)
    jmodel = jbuild_model(cfg)
    variables = jax.device_get(jax.jit(
        lambda k, x: jmodel.init(k, x, train=False))(
            jax.random.PRNGKey(0), clip))
    kw = dict(block_nums=(1, 1, 1, 1), enc_layers=1, dec_layers=2)
    ours = convert.tuber_torch_state_from_params(
        variables["params"], variables["batch_stats"], **kw)
    theirs = torch_convert.tuber_torch_state_from_params(
        variables["params"], variables["batch_stats"], **kw)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]),
                                      err_msg=k)
