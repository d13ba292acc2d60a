"""The PyTorch StreamingDetector against the JAX one: the same frames, the
same weights (the JAX detector's seeded variables, carried over with
``strict=True``), float32 on the CPU. Keyframe indices must be equal; scores
and boxes agree to float32 rounding through the model."""

import json

import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401

from tubelet_transformer_tpu.config import Config
from tubelet_transformer_tpu.serving import StreamingDetector as JDetector
from tubelet_transformer_tpu_torch.cli import serve as cli_serve
from tubelet_transformer_tpu_torch.convert import load_jax_variables
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.serving import StreamingDetector

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def small_cfg():
    cfg = Config()
    cfg.data.dataset_name = "ava"
    cfg.data.num_classes = 5
    cfg.data.img_size = 32
    cfg.data.temp_len = 8
    cfg.data.frame_rate = 2
    cfg.model.backbone_name = "CSN-TINY"
    cfg.model.query_num = 5
    cfg.model.temp_len = 8
    cfg.model.enc_layers = 1
    cfg.model.dec_layers = 2
    cfg.model.d_model = 64
    cfg.model.nhead = 4
    cfg.model.dim_feedforward = 64
    cfg.model.compute_dtype = "float32"
    cfg.model.temporal_ds_strategy = "avg"
    return cfg


def _frames(n, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def _assert_same(got, want):
    assert got.frame_index == want.frame_index
    assert got.time_s == want.time_s
    assert len(got.detections) == len(want.detections)
    for d, e in zip(got.detections, want.detections):
        # boxes are in source pixels (0..64); the rest in [0, 1]
        np.testing.assert_allclose(d.box, e.box, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(d.scores, e.scores, rtol=1e-4, atol=1e-5)
        assert abs(d.actor_prob - e.actor_prob) < 1e-5


def test_streaming_matches_jax():
    # actor_threshold -1 admits every query, so every output is compared
    jdet = JDetector(small_cfg(), fps=8.0, detect_every=8,
                     actor_threshold=-1.0)
    model = load_jax_variables(build_model(small_cfg()),
                               jdet.variables["params"],
                               jdet.variables["batch_stats"])
    det = StreamingDetector(small_cfg(), model, fps=8.0, detect_every=8,
                            actor_threshold=-1.0, device="cpu")
    frames = _frames(40)
    want = [r for f in frames if (r := jdet.push_frame(f))]
    got = [r for f in frames if (r := det.push_frame(f))]
    # the window fills at frame 16 (T=8 at stride 2), then one every 8
    assert [r.frame_index for r in got] == [8, 16, 24, 32]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same(g, w)
    # a mid-stream resolution change restarts the window; flush pads it
    for f in _frames(5, h=40, w=30, seed=1):
        assert det.push_frame(f) is None
        assert jdet.push_frame(f) is None
    _assert_same(det.flush(), jdet.flush())


def test_default_threshold_filters_detections():
    det = StreamingDetector(small_cfg(), fps=8.0, device="cpu", rng_seed=2)
    results = [r for f in _frames(24) if (r := det.push_frame(f))]
    assert len(results) == 2
    for r in results:
        assert all(d.actor_prob > 0.8 for d in r.detections)
        assert r.latency_ms > 0


@pytest.mark.parametrize("knob", ["infer_chunk"])
def test_unported_serving_options_raise(knob):
    cfg = small_cfg()
    cfg.model.infer_chunk = 2
    with pytest.raises(NotImplementedError):
        StreamingDetector(cfg, device="cpu")


def test_serving_mesh_needs_its_processes():
    """A mesh of 2 model peers in one process is refused, naming MESH.DATA
    x MODEL (mesh serving runs under torchrun: test_torch_mesh_serving.py);
    a mesh of one process is no mesh."""
    from tubelet_transformer_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="MESH.DATA x MODEL"):
        StreamingDetector(small_cfg(), device="cpu", mesh=Mesh(1, 0, 2))
    det = StreamingDetector(small_cfg(), device="cpu", mesh=Mesh())
    assert det.mesh is None and getattr(det.model, "tp", None) is None
    det.stop_followers()                            # a no-op


def _write_cfg(tmp_path):
    cfg = small_cfg()
    tree = {"CONFIG": {
        "DATA": {k.upper(): getattr(cfg.data, k) for k in (
            "num_classes", "img_size", "temp_len", "frame_rate")},
        "MODEL": {k.upper(): getattr(cfg.model, k) for k in (
            "backbone_name", "query_num", "temp_len", "enc_layers",
            "dec_layers", "d_model", "nhead", "dim_feedforward",
            "compute_dtype", "temporal_ds_strategy")}}}
    path = tmp_path / "small.yaml"
    path.write_text(json.dumps(tree))      # JSON is YAML
    return str(path)


def test_cli_serve_prints_keyframes(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--config-file", _write_cfg(tmp_path), "--num-frames", "24",
        "--fps", "8", "--device", "cpu"])
    cli_serve.main()
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [d["keyframe"] for d in lines[:-1]] == [8, 16]
    assert lines[-1]["summary"]["keyframes"] == 2


def test_cli_serve_refuses_missing_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["serve", "--config-file",
                                     _write_cfg(tmp_path)])
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_serve.main()
