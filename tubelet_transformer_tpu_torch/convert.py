"""Weight bridge: foreign checkpoints and the JAX package's variables into
the port's TubeR.

The import half is the port's copy of the reading side of
``tubelet_transformer_tpu/train/torch_convert.py``, mapped straight onto the
reference's module names, which the port's modules carry:
``csn_state_from_mat`` (its ``csn_params_from_mat``: the Caffe2 CSN
``.mat`` export), ``strip_module_prefix`` and ``load_torch_checkpoint``. A
Caffe2 conv blob is (O, I/g, T, H, W), the layout of a torch Conv3d weight,
so it is copied as it is; a BN's ``_riv`` blob is its running variance.

``tuber_torch_state_from_params`` and its ``_inv_*`` / ``_put_*`` helpers
are the port's copy of the export half of
``tubelet_transformer_tpu/train/torch_convert.py``: flax (params,
batch_stats) trees of numpy arrays to the reference's module-named state
dict. Layouts: a flax Dense kernel (in, out) becomes a torch Linear weight
(out, in); a flax Conv kernel (t, h, w, in/g, out) a torch Conv3d weight
(out, in/g, t, h, w); flax BatchNorm {scale, bias} + {mean, var} torch's
{weight, bias, running_mean, running_var}. The long-term context's
``lfb_proj``, ``lfb_attn`` and ``lfb_norm``, which the reference lacks (the
JAX package's ``cli/export_torch.py`` refuses them), cross over under the
port's module names when the params hold them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from tubelet_transformer_tpu_torch.models.tuber import TubeR

# Per-stage starting block index in the flat Caffe2 numbering
# (ir_CSN_152.py:269 / ir_CSN_50.py:272 of the reference).
MAT_START_COUNT = {
    (3, 8, 36, 3): (0, 3, 11, 47),   # CSN-152
    (3, 4, 6, 3): (0, 3, 7, 13),     # CSN-50
}


def csn_state_from_mat(path: str, block_nums,
                       prefix: str = "backbone.body.") -> Dict[str, np.ndarray]:
    """A Caffe2 CSN ``.mat`` export -> the CSN's state dict under
    ``prefix``, in the reference's names (``conv1.weight``,
    ``layer{s}.{b}.conv{1,3,4}.weight``, ``bn*.running_var``,
    ``down_sample.{0,1}``...)."""
    import scipy.io as sio

    w = sio.loadmat(path)
    start = MAT_START_COUNT[tuple(block_nums)]
    sd: Dict[str, np.ndarray] = {}

    def put_bn(ours: str, name: str) -> None:
        for field, blob in (("weight", "_s"), ("bias", "_b"),
                            ("running_mean", "_rm"), ("running_var", "_riv")):
            sd[f"{prefix}{ours}.{field}"] = np.asarray(
                w[name + blob]).reshape(-1)

    sd[f"{prefix}conv1.weight"] = np.asarray(w["conv1_w"])
    put_bn("bn1", "conv1_spatbn_relu")
    for s, blocks in enumerate(tuple(block_nums)):
        for b in range(blocks):
            count, rp = start[s] + b, f"layer{s + 1}.{b}"
            for i in ("1", "3", "4"):
                sd[f"{prefix}{rp}.conv{i}.weight"] = np.asarray(
                    w[f"comp_{count}_conv_{i}_w"])
                put_bn(f"{rp}.bn{i}", f"comp_{count}_spatbn_{i}")
            if b == 0:
                sd[f"{prefix}{rp}.down_sample.0.weight"] = np.asarray(
                    w[f"shortcut_projection_{count}_w"])
                put_bn(f"{rp}.down_sample.1",
                       f"shortcut_projection_{count}_spatbn")
    return sd


def strip_module_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove the DDP ``module.`` prefix (model_utils.py:20-25)."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` checkpoint's state dict on the CPU (``ckpt["model"]``
    when there is one). Released files pickle more than tensors (DETR's
    argparse namespace), so this reads them in full, as the JAX loader
    does: load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: torch.as_tensor(v) for k, v in sd.items()}


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

    if "lfb_proj" in params:
        _put_dense(sd, "lfb_proj", params["lfb_proj"])
        _put_mha(sd, "lfb_attn", params["lfb_attn"])
        _put_ln(sd, "lfb_norm", params["lfb_norm"])

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
