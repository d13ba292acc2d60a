"""Weight bridge: the JAX package's TubeR variables into the port's TubeR."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tubelet_transformer_tpu.train.torch_convert import (
    tuber_torch_state_from_params)
from tubelet_transformer_tpu_torch.models.tuber import TubeR


def load_jax_variables(model: TubeR, params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> TubeR:
    """Load flax ``params`` / ``batch_stats`` trees (numpy arrays) into
    ``model`` through the reference key scheme. ``strict=True``: every
    weight of the model must cross over, and nothing else."""
    sd = tuber_torch_state_from_params(
        params, batch_stats, block_nums=model.backbone.body.block_nums,
        enc_layers=model.enc_layers, dec_layers=model.dec_layers,
        temporal_ds_strategy=model.temporal_ds_strategy,
        single_frame=model.single_frame, ddp_prefix=False)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()},
        strict=True)
    return model
