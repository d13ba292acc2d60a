"""Weight bridge: the JAX package's TubeR variables into the port's TubeR.

``tuber_torch_state_from_params`` and its ``_inv_*`` / ``_put_*`` helpers
are the port's copy of the export half of
``tubelet_transformer_tpu/train/torch_convert.py``: flax (params,
batch_stats) trees of numpy arrays to the reference's module-named state
dict. Layouts: a flax Dense kernel (in, out) becomes a torch Linear weight
(out, in); a flax Conv kernel (t, h, w, in/g, out) a torch Conv3d weight
(out, in/g, t, h, w); flax BatchNorm {scale, bias} + {mean, var} torch's
{weight, bias, running_mean, running_var}.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from tubelet_transformer_tpu_torch.models.tuber import TubeR


def _inv_linear(k) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(k, np.float32).T)


def _inv_conv3d(k) -> np.ndarray:
    return np.ascontiguousarray(
        np.transpose(np.asarray(k, np.float32), (4, 3, 0, 1, 2)))


def _put_dense(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _inv_linear(p["kernel"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)


def _put_ln(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"], np.float32)
    out[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)


def _put_bn(out: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"], np.float32)
    out[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)
    out[f"{prefix}.running_mean"] = np.asarray(s["mean"], np.float32)
    out[f"{prefix}.running_var"] = np.asarray(s["var"], np.float32)
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _put_mha(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.in_proj_weight"] = _inv_linear(p["in_proj"])
    out[f"{prefix}.in_proj_bias"] = np.asarray(p["in_proj_bias"], np.float32)
    _put_dense(out, f"{prefix}.out_proj", p["out_proj"])


def _put_encoder_layer(out: Dict, prefix: str, p: Mapping) -> None:
    _put_mha(out, f"{prefix}.self_attn", p["self_attn"])
    _put_dense(out, f"{prefix}.linear1", p["linear1"])
    _put_dense(out, f"{prefix}.linear2", p["linear2"])
    _put_ln(out, f"{prefix}.norm1", p["norm1"])
    _put_ln(out, f"{prefix}.norm2", p["norm2"])


def _put_decoder_layer(out: Dict, prefix: str, p: Mapping) -> None:
    _put_encoder_layer(out, prefix, p)
    _put_mha(out, f"{prefix}.multihead_attn", p["multihead_attn"])
    _put_ln(out, f"{prefix}.norm3", p["norm3"])


def tuber_torch_state_from_params(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any], *,
    block_nums, enc_layers: int = 6, dec_layers: int = 6,
    temporal_ds_strategy: str = "decode", single_frame: bool = True,
    ddp_prefix: bool = True,
) -> Dict[str, np.ndarray]:
    """Our (params, batch_stats) -> reference module-named state dict.

    ``ddp_prefix`` adds the ``module.`` prefix the released checkpoints
    carry (saved from DDP-wrapped models, model_utils.py:20-25).
    """
    sd: Dict[str, np.ndarray] = {}

    bb_p, bb_s = params["backbone"], batch_stats["backbone"]
    sd["backbone.body.conv1.weight"] = _inv_conv3d(bb_p["conv1"]["kernel"])
    _put_bn(sd, "backbone.body.bn1", bb_p["bn1"], bb_s["bn1"])
    for s, blocks in enumerate(tuple(block_nums)):
        for b in range(blocks):
            name = f"layer{s + 1}_{b}"
            rp = f"backbone.body.layer{s + 1}.{b}"
            blk_p, blk_s = bb_p[name], bb_s[name]
            for conv in ("conv1", "conv3", "conv4"):
                bn = "bn" + conv[-1]
                sd[f"{rp}.{conv}.weight"] = _inv_conv3d(
                    blk_p[conv]["kernel"])
                _put_bn(sd, f"{rp}.{bn}", blk_p[bn], blk_s[bn])
            if b == 0:
                sd[f"{rp}.down_sample.0.weight"] = _inv_conv3d(
                    blk_p["downsample_conv"]["kernel"])
                _put_bn(sd, f"{rp}.down_sample.1",
                        blk_p["downsample_bn"], blk_s["downsample_bn"])

    sd["query_embed.weight"] = np.asarray(params["query_embed"], np.float32)
    for ours, theirs in (("input_proj", "input_proj"),
                         ("class_proj", "class_proj")):
        # Dense kernel (I, O) -> 1x1x1 Conv3d weight (O, I, 1, 1, 1)
        sd[f"{theirs}.weight"] = _inv_linear(
            params[ours]["kernel"])[:, :, None, None, None]
        sd[f"{theirs}.bias"] = np.asarray(params[ours]["bias"], np.float32)

    tr = params["transformer"]
    for i in range(enc_layers):
        _put_encoder_layer(sd, f"transformer.encoder.layers.{i}",
                           tr[f"encoder_layer_{i}"])
    for i in range(dec_layers):
        _put_decoder_layer(sd, f"transformer.decoder.layers.{i}",
                           tr[f"decoder_layer_{i}"])
    _put_ln(sd, "transformer.decoder.norm", tr["decoder_norm"])

    fe = params["encoder"]
    _put_mha(sd, "encoder.layers.0.self_attn_t", fe["self_attn_t"])
    _put_mha(sd, "encoder.layers.0.self_attn_s", fe["self_attn_s"])
    _put_ln(sd, "encoder.layers.0.norm1_t", fe["norm1_t"])
    _put_ln(sd, "encoder.layers.0.norm1_s", fe["norm1_s"])
    _put_ln(sd, "encoder.layers.0.norm2", fe["norm2"])
    _put_dense(sd, "encoder.layers.0.linear1", fe["linear1"])
    _put_dense(sd, "encoder.layers.0.linear2", fe["linear2"])

    _put_mha(sd, "cross_attn", params["cross_attn"])
    _put_dense(sd, "class_embed_b", params["class_embed_b"])
    _put_dense(sd, "class_fc", params["class_fc"])
    for i in range(3):
        _put_dense(sd, f"bbox_embed.layers.{i}",
                   params["bbox_embed"][f"layers_{i}"])

    if single_frame and temporal_ds_strategy == "decode":
        sd["backbone.query_pool.weight"] = np.asarray(
            params["pool_query"], np.float32)
        lp = params["pool_decoder"]
        _put_mha(sd, "backbone.pool_decoder.layers.0.self_attn",
                 lp["self_attn"])
        _put_mha(sd, "backbone.pool_decoder.layers.0.multihead_attn",
                 lp["multihead_attn"])
        _put_dense(sd, "backbone.pool_decoder.layers.0.linear1",
                   lp["linear1"])
        _put_dense(sd, "backbone.pool_decoder.layers.0.linear2",
                   lp["linear2"])
        _put_ln(sd, "backbone.pool_decoder.layers.0.norm1", lp["norm1"])
        _put_ln(sd, "backbone.pool_decoder.layers.0.norm2", lp["norm2"])
        _put_ln(sd, "backbone.pool_decoder.layers.0.norm3", lp["norm3"])
        _put_ln(sd, "backbone.pool_decoder.norm", params["pool_norm"])

    if ddp_prefix:
        sd = {f"module.{k}": v for k, v in sd.items()}
    return sd


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
