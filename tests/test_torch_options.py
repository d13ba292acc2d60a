"""Which config options the PyTorch port runs on one device: the train
and model options of the JAX package that it runs (TRAIN.ACCUM_STEPS,
TRAIN.FROZEN_CHUNK, TRAIN.REMAT_BACKBONE, LOG.PROFILE_STEPS,
MODEL.MOE_EXPERTS, MODEL.NORMALIZE_BEFORE) pass every check and reach the
model, and the options it leaves out still raise: the mesh options but
MESH.DATA (which runs MoE with MESH.DATA > 1 refused), MODEL.INFER_CHUNK,
and CONFIG.TWO_STREAM and CONFIG.USE_LOCATION, which the JAX package
refuses too."""

import pytest
import torch
from test_torch_tuber import small_cfg

from tubelet_transformer_tpu_torch.cli import runner
from tubelet_transformer_tpu_torch.models.tuber import build_model


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
    runner.check_supported(cfg)
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
    "mesh_data": lambda c: (setattr(c.mesh, "data", 2),
                            setattr(c.model, "moe_experts", 4)),
    "mesh_model": lambda c: setattr(c.mesh, "model", 2),
    "mesh_zero1": lambda c: setattr(c.mesh, "zero1", True),
    "mesh_spatial": lambda c: setattr(c.mesh, "spatial", True),
    "infer_chunk": lambda c: setattr(c.model, "infer_chunk", 2),
    "two_stream": lambda c: setattr(c, "two_stream", True),
    "use_location": lambda c: setattr(c, "use_location", True),
}


@pytest.mark.parametrize("knob", REFUSED)
def test_left_out_options_still_raise(knob):
    cfg = small_cfg()
    REFUSED[knob](cfg)
    with pytest.raises(NotImplementedError):
        runner.check_supported(cfg)


def test_frozen_chunk_refuses_data_parallel():
    """As the JAX package's build_model: chunking splits the batch axis
    that data parallelism shards."""
    cfg = small_cfg()
    cfg.train.frozen_chunk, cfg.mesh.data = 1, 2
    with pytest.raises(ValueError, match="FROZEN_CHUNK"):
        build_model(cfg, train=True)
