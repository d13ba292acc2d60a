"""The PyTorch port's small ops against the JAX package's: box ops, the 3-D
position embedding, the pad-mask resize, device preprocessing and the
postprocess. float32 on the CPU; tolerances are float32 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401

from tubelet_transformer_tpu.data import device_preprocess as jdp
from tubelet_transformer_tpu.models import tuber as jtuber
from tubelet_transformer_tpu.ops import box_ops as jbox
from tubelet_transformer_tpu.ops import position_encoding as jpos
from tubelet_transformer_tpu.train import postprocess as jpost
from tubelet_transformer_tpu_torch.data import device_preprocess as tdp
from tubelet_transformer_tpu_torch.models import tuber as ttuber
from tubelet_transformer_tpu_torch.ops import box_ops as tbox
from tubelet_transformer_tpu_torch.ops import position_encoding as tpos
from tubelet_transformer_tpu_torch.train import postprocess as tpost

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _boxes(rng, n):
    """Random valid xyxy boxes in [0, 1]."""
    lo = rng.uniform(0, 0.6, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (n, 2))],
                          axis=1).astype(np.float32)


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("fn", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh",
                                "box_area"])
def test_box_unary_ops(fn, rng):
    b = _boxes(rng, 12).reshape(3, 4, 4)
    _close(getattr(tbox, fn)(torch.from_numpy(b)), getattr(jbox, fn)(b))


@pytest.mark.parametrize("fn", ["box_iou", "generalized_box_iou",
                                "elementwise_giou"])
def test_box_pair_ops(fn, rng):
    a, b = _boxes(rng, 7), _boxes(rng, 7)
    got = getattr(tbox, fn)(torch.from_numpy(a), torch.from_numpy(b))
    want = getattr(jbox, fn)(a, b)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _close(g, w)


@pytest.mark.parametrize("max_outputs,iou,score", [(10, 0.5, -np.inf),
                                                   (3, 0.3, 0.2)])
def test_nms_padded(max_outputs, iou, score, rng):
    boxes = _boxes(rng, 10)
    boxes[5] = boxes[2] + 0.01           # a near-duplicate to suppress
    scores = rng.uniform(0, 1, 10).astype(np.float32)
    valid = np.ones(10, bool)
    valid[8] = False
    got = tbox.nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(valid), max_outputs, iou, score)
    want = jbox.nms_padded(boxes, scores, valid, max_outputs, iou, score)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d_model", [64, 256])
def test_position_embedding_sine_3d(d_model, rng):
    """Padding-aware positions: the bottom rows and right columns padded."""
    not_mask = np.ones((2, 3, 5, 6), bool)
    not_mask[0, :, 4:] = False
    not_mask[1, :, :, 5:] = False
    got = tpos.position_embedding_sine_3d(torch.from_numpy(not_mask),
                                          d_model)
    want = jpos.position_embedding_sine_3d(not_mask, d_model)
    assert got.shape == (2, 3, 5, 6, d_model)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("hw,out", [((64, 64), (4, 4)), ((37, 50), (7, 3)),
                                    ((5, 5), (16, 16))])
def test_nearest_resize_mask(hw, out, rng):
    mask = rng.uniform(size=(2,) + hw) > 0.5
    got = ttuber.nearest_resize_mask(torch.from_numpy(mask), *out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jtuber.nearest_resize_mask(mask, *out)))


def test_device_preprocess(rng):
    clips = rng.integers(0, 256, (2, 3, 8, 10, 3), dtype=np.uint8)
    pad = np.zeros((2, 8, 10), bool)
    pad[0, 6:] = True
    pad[1, :, 7:] = True
    got = tdp.device_preprocess(torch.from_numpy(clips),
                                pad_mask=torch.from_numpy(pad))
    want = jdp.device_preprocess(clips, pad_mask=pad)
    _close(got, want, 1e-6)
    assert (got[0, :, 6:] == 0).all()
    x = rng.normal(size=(1, 2, 4, 4, 3)).astype(np.float32)
    assert tdp.device_preprocess(torch.from_numpy(x),
                                 torch.bfloat16).dtype == torch.bfloat16


def _outputs(rng, b=2, q=5, c=7):
    return {"pred_logits": rng.normal(size=(b, q, c)).astype(np.float32),
            "pred_boxes": rng.uniform(0.2, 0.8, (b, q, 4)).astype(np.float32),
            "pred_logits_b": (2 * rng.normal(size=(b, q, 3))).astype(
                np.float32)}


@pytest.mark.parametrize("gate", [0.8, 0.3, -1.0])
def test_postprocess_ava(gate, rng):
    out = _outputs(rng)
    sizes = np.array([[240, 320], [256, 256]], np.float32)
    got = tpost.postprocess_ava(
        {k: torch.from_numpy(v) for k, v in out.items()},
        torch.from_numpy(sizes), binary_gate=gate)
    want = jpost.postprocess_ava(out, jnp.asarray(sizes), binary_gate=gate)
    for g, w in zip(got, want):
        _close(g, w)


def test_postprocess_softmax(rng):
    out = _outputs(rng)
    sizes = np.array([[240, 320], [256, 256]], np.float32)
    got = tpost.postprocess_softmax(
        {k: torch.from_numpy(v) for k, v in out.items()},
        torch.from_numpy(sizes))
    for g, w in zip(got, jpost.postprocess_softmax(out, jnp.asarray(sizes))):
        _close(g, w)
