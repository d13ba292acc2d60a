"""Which config options the PyTorch port runs on one device: the train
and model options of the JAX package that it runs (TRAIN.ACCUM_STEPS,
TRAIN.FROZEN_CHUNK, TRAIN.REMAT_BACKBONE, LOG.PROFILE_STEPS,
MODEL.MOE_EXPERTS, MODEL.NORMALIZE_BEFORE) pass every check and reach the
model, as do MESH.ZERO1 (beside MESH.MODEL too), MoE with MESH.DATA > 1
(the 'data' axis), MESH.SPATIAL beside MESH.MODEL and MESH.PIPE (with
MESH.DATA or MESH.ZERO1 beside them too, and at rows whose bands come out
uneven below the stem), and what it leaves out still raises: MESH.SPATIAL
where MESH.MODEL does not divide the clip's rows (ValueError, beside
MESH.DATA, MESH.PIPE or MESH.ZERO1 too), as JAX's device_put refuses such
a clip, MODEL.INFER_CHUNK, and CONFIG.TWO_STREAM and CONFIG.USE_LOCATION,
which the JAX package refuses too."""

import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_tuber import small_cfg

from tubelet_transformer_tpu_torch.cli import runner
from tubelet_transformer_tpu_torch.models.tuber import build_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_ported_options_reach_the_model():
    cfg = small_cfg()
    cfg.train.accum_steps = 2
    cfg.train.frozen_chunk = 1
    cfg.train.remat_backbone = True
    cfg.log.profile_steps = 2
    cfg.model.moe_experts, cfg.model.moe_top_k = 4, 2
    cfg.model.moe_capacity_factor = 2.0
    cfg.model.normalize_before = True
    cfg.model.compute_dtype = "bfloat16"
    cfg.mesh.zero1 = True
    runner.check_supported(cfg)
    moe_dp = small_cfg()
    moe_dp.model.moe_experts, moe_dp.mesh.data = 4, 2
    runner.check_supported(moe_dp)
    zero1_model = small_cfg()
    zero1_model.mesh.zero1, zero1_model.mesh.model = True, 2
    runner.check_supported(zero1_model)
    # the clip's 64 rows split over 2 model peers at every stage; 48 rows
    # leave layer3's strided conv 3 rows a peer (uneven bands); the rows
    # split beside a 'pipe' axis, with MESH.DATA or MESH.ZERO1 too
    for edit in ({}, {"img_size": 48}, {"pipe": 2, "data": 2},
                 {"pipe": 2, "zero1": True}):
        spatial = small_cfg()
        spatial.mesh.model, spatial.mesh.spatial = 2, True
        for k, v in edit.items():
            setattr(spatial.data if k == "img_size" else spatial.mesh, k, v)
        runner.check_supported(spatial)
    for train in (False, True):
        model = build_model(cfg, train=train)
        body = model.backbone.body
        assert (body.frozen_chunk, body.remat) == (1, True)
        layer = model.transformer.encoder.layers[0]
        assert layer.normalize_before and model.transformer.decoder.layers[
            0].normalize_before
        moe = layer.moe_ffn
        assert (moe.num_experts, moe.top_k, moe.capacity_factor) == (
            4, 2, 2.0)
        # the eval build casts to the compute dtype, the router aside
        assert moe.router.weight.dtype == torch.float32
        assert moe.expert_w1.dtype == (torch.float32 if train
                                       else torch.bfloat16)


REFUSED = {
    # MESH.DATA runs (MoE too), and a 'pipe' axis and the clip's rows split
    # over MESH.MODEL beside it, but not where MODEL does not divide the
    # rows
    "mesh_data": (lambda c: (setattr(c.mesh, "data", 2),
                             setattr(c.mesh, "pipe", 2),
                             setattr(c.mesh, "model", 3),
                             setattr(c.mesh, "spatial", True)),
                  ValueError),
    # MESH.MODEL runs (tensor parallelism, test_torch_tensor_parallel.py),
    # and the clip's H axis over it (SPATIAL, test_torch_spatial.py) where
    # it divides the rows: 80 rows over 3 peers are refused
    "mesh_model": (lambda c: (setattr(c.mesh, "model", 3),
                              setattr(c.mesh, "spatial", True),
                              setattr(c.data, "img_size", 80)),
                   ValueError),
    # MESH.ZERO1 runs on the 'data' axis and beside 'model' and 'pipe'
    # axes, the rows split beside them too, where MODEL divides them
    "mesh_zero1": (lambda c: (setattr(c.mesh, "zero1", True),
                              setattr(c.mesh, "model", 3),
                              setattr(c.mesh, "pipe", 2),
                              setattr(c.mesh, "spatial", True)),
                   ValueError),
    # SPATIAL whose clip of 64 rows does not split over 3 model peers
    "mesh_spatial": (lambda c: (setattr(c.mesh, "spatial", True),
                                setattr(c.mesh, "model", 3)),
                     ValueError),
    "infer_chunk": (lambda c: setattr(c.model, "infer_chunk", 2),
                    NotImplementedError),
    "two_stream": (lambda c: setattr(c, "two_stream", True),
                   NotImplementedError),
    "use_location": (lambda c: setattr(c, "use_location", True),
                     NotImplementedError),
}


@pytest.mark.parametrize("knob", REFUSED)
def test_left_out_options_still_raise(knob):
    cfg = small_cfg()
    edit, refusal = REFUSED[knob]
    edit(cfg)
    with pytest.raises(refusal):
        runner.check_supported(cfg)


def test_frozen_chunk_refuses_data_parallel():
    """As the JAX package's build_model: chunking splits the batch axis
    that data parallelism shards."""
    cfg = small_cfg()
    cfg.train.frozen_chunk, cfg.mesh.data = 1, 2
    with pytest.raises(ValueError, match="FROZEN_CHUNK"):
        build_model(cfg, train=True)
