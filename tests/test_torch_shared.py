"""The port's own copies of the JAX package's jax-free modules against the
originals: the configuration schema and its YAML mapping, the synthetic set
and the loader, the AVA frame-mAP evaluator, the export of flax variables to
the reference's state dict, and the JHMDB/UCF24 copies (``data/jhmdb.py``,
``eval/{np_box,ucf_eval,video_map}.py``) and the serving client
(``client.py``): their source equal to the originals' but for the
package's name, the box operations, and the UCF frame-mAP and video-mAP
evaluators on the same detections; the HTTP server's frame decoder, and the
long-term feature bank and its dataset wrapper on the same inputs."""

import dataclasses
import glob
from pathlib import Path

import jax
import numpy as np
import pytest

from tubelet_transformer_tpu import config as jconfig
from tubelet_transformer_tpu import serving_http as jserving_http
from tubelet_transformer_tpu.data import loader as jloader
from tubelet_transformer_tpu.data import synthetic as jsynthetic
from tubelet_transformer_tpu.eval import ava_eval as java_eval
from tubelet_transformer_tpu.eval import lfb as jlfb
from tubelet_transformer_tpu.eval import np_box as jnp_box
from tubelet_transformer_tpu.eval import ucf_eval as jucf_eval
from tubelet_transformer_tpu.eval import video_map as jvideo_map
from tubelet_transformer_tpu.models.tuber import build_model as jbuild_model
from tubelet_transformer_tpu.train import torch_convert
from tubelet_transformer_tpu_torch import config, convert, serving_http
from tubelet_transformer_tpu_torch.data import loader, synthetic
from tubelet_transformer_tpu_torch.eval import (ava_eval, lfb, np_box,
                                                ucf_eval, video_map)

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


@pytest.mark.parametrize("module", ["data/jhmdb.py", "eval/np_box.py",
                                    "eval/ucf_eval.py",
                                    "eval/video_map.py", "client.py",
                                    "plots.py"])
def test_copy_is_the_original(module):
    """The copy's source is the original's with the package renamed."""
    ours = (ROOT / "tubelet_transformer_tpu_torch" / module).read_text()
    theirs = (ROOT / "tubelet_transformer_tpu" / module).read_text()
    assert ours == theirs.replace("tubelet_transformer_tpu.",
                                  "tubelet_transformer_tpu_torch.")


def _encoded(frame, fmt):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["raw", "JPEG", "PNG"])
def test_decode_frame_matches_jax(fmt):
    frame = np.random.default_rng(8).integers(0, 256, (24, 40, 3),
                                              dtype=np.uint8)
    if fmt == "raw":
        args = (frame.tobytes(), "application/octet-stream", "24x40x3")
    else:
        args = (_encoded(frame, fmt), f"image/{fmt.lower()}", None)
    ours = serving_http._decode_frame(*args)
    np.testing.assert_array_equal(ours, jserving_http._decode_frame(*args))
    assert ours.shape == (24, 40, 3) and ours.dtype == np.uint8
    if fmt != "JPEG":
        np.testing.assert_array_equal(ours, frame)


def test_feature_bank_and_attach_match_jax():
    """The same adds (more queries than slots, probabilities on both sides
    of the threshold) give the same windows, and the wrapped synthetic set
    the same samples with their memories."""
    cfg = jconfig.Config()
    cfg.data.num_classes, cfg.data.img_size, cfg.data.temp_len = 5, 32, 4
    banks = (lfb.FeatureBank(6, 2), jlfb.FeatureBank(6, 2))
    for bank in banks:
        rng = np.random.default_rng(9)
        for s in (899, 900, 902, 903):
            bank.add(f"synth,{s:04d}",
                     rng.normal(size=(4, 6)).astype(np.float32),
                     rng.uniform(size=4), threshold=0.5)
    for sec, hw in ((901, 1), (900, 2), (905, 1)):
        for got, want in zip(banks[0].window("synth", sec, hw),
                             banks[1].window("synth", sec, hw)):
            np.testing.assert_array_equal(got, want)
    ours = lfb.BankAttachDataset(synthetic.SyntheticAVADataset(cfg, size=4),
                                 banks[0], half_window=1)
    theirs = jlfb.BankAttachDataset(
        jsynthetic.SyntheticAVADataset(cfg, size=4), banks[1], half_window=1)
    for i in range(4):
        got = ours.get(i, np.random.default_rng(i))
        want = theirs.get(i, np.random.default_rng(i))
        assert set(got) == set(want) >= {"lfb_features", "lfb_mask"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _boxes(rng, n):
    yx = rng.uniform(0, 80, (n, 2))
    return np.concatenate([yx, yx + rng.uniform(5, 40, (n, 2))], 1)


def test_np_box_matches_jax():
    rng = np.random.default_rng(5)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    scores = rng.uniform(size=7)
    window = np.array([10.0, 10.0, 70.0, 70.0])
    masks = (rng.uniform(size=(3, 8, 8)) < 0.4).astype(np.uint8)
    calls = {"area": (a,), "intersection": (a, b), "iou": (a, b),
             "ioa": (a, b), "non_max_suppression": (a, scores, 5, 0.3, 0.1),
             "clip_to_window": (a, window),
             "prune_outside_window": (a, window),
             "change_coordinate_frame": (a, window),
             "mask_iou": (masks, masks[:2]), "mask_ioa": (masks, masks[:2])}
    for name, args in calls.items():
        ours, theirs = (getattr(mod, name)(*args)
                        for mod in (np_box, jnp_box))
        for x, y in zip(*((o,) if not isinstance(o, tuple) else o
                          for o in (ours, theirs))):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_ucf_frame_map_matches_jax():
    rng = np.random.default_rng(6)
    evals = [mod.UCFDetectionEvaluator(class_num=4, iou_thresholds=(0.5,
                                                                    0.75))
             for mod in (ucf_eval, jucf_eval)]
    for i in range(10):
        key = f"v{i // 5}-{i}"
        gt = _boxes(rng, 2)
        onehot = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 2)]
        det = np.concatenate([gt, _boxes(rng, 3)]) + rng.normal(0, 3,
                                                                 (5, 4))
        scores = rng.dirichlet(np.ones(5), 5).astype(np.float32)
        for ev in evals:
            ev.add_ground_truth(key, gt, onehot)
            ev.add_detections(key, det, scores)
    (ours, ours_res), (theirs, theirs_res) = (ev.evaluate() for ev in evals)
    assert 0.0 < ours[0] < 1.0
    assert ours == theirs and ours_res == theirs_res


def test_video_map_matches_jax():
    rng = np.random.default_rng(7)
    evals = [mod.VideoMAPEvaluator(3, (0.2, 0.5))
             for mod in (video_map, jvideo_map)]
    for v in range(3):
        frames = np.arange(12)
        tube = _boxes(rng, 1) + np.cumsum(rng.normal(0, 1, (12, 4)), 0)
        for ev in evals:
            ev.add_gt_tube(f"v{v}", v % 3, frames, tube)
        for f in frames:
            det = np.concatenate([tube[f:f + 1] + rng.normal(0, 2, (1, 4)),
                                  _boxes(rng, 1)])
            cls = np.array([v % 3, int(rng.integers(0, 3))])
            sc = rng.uniform(0.3, 1.0, 2)
            for ev in evals:
                ev.add_frame_detections(f"v{v}", int(f), det, cls, sc)
    ours, theirs = (ev.evaluate() for ev in evals)
    assert ours == theirs and 0.0 < ours[0.5] <= 1.0
