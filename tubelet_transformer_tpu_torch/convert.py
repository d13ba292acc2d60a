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
port's module names when the params hold them; so do an MoE encoder layer's
``moe_ffn`` (the router's kernel transposed, the expert stacks as they are)
and the pre-norm transformer's ``encoder_norm`` (as ``encoder.norm``).

The same layouts carry the JAX package's segmentation heads
(``mh_attention_map_state``, ``mask_head_state``: a flax Conv kernel
(kh, kw, in, out) becomes a torch Conv2d weight (out, in, kh, kw), a
GroupNorm's {scale, bias} its {weight, bias}) and its ``VideoClassifier``
(``classifier_state``: the CSN trunk and the ``head``) into the port's
modules; the ``load_*`` functions load with ``strict=True``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from tubelet_transformer_tpu_torch.models.tuber import TubeR
from tubelet_transformer_tpu_torch.parallel.pipeline import (
    unstack_encoder_params)

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


def _put_moe(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.router.weight"] = _inv_linear(p["router"]["kernel"])
    for name in ("expert_w1", "expert_b1", "expert_w2", "expert_b2"):
        out[f"{prefix}.{name}"] = np.asarray(p[name], np.float32)


def _put_encoder_layer(out: Dict, prefix: str, p: Mapping) -> None:
    _put_mha(out, f"{prefix}.self_attn", p["self_attn"])
    if "moe_ffn" in p:
        _put_moe(out, f"{prefix}.moe_ffn", p["moe_ffn"])
    else:
        _put_dense(out, f"{prefix}.linear1", p["linear1"])
        _put_dense(out, f"{prefix}.linear2", p["linear2"])
    _put_ln(out, f"{prefix}.norm1", p["norm1"])
    _put_ln(out, f"{prefix}.norm2", p["norm2"])


def _put_decoder_layer(out: Dict, prefix: str, p: Mapping) -> None:
    _put_encoder_layer(out, prefix, p)
    _put_mha(out, f"{prefix}.multihead_attn", p["multihead_attn"])
    _put_ln(out, f"{prefix}.norm3", p["norm3"])


def _put_csn(out: Dict, prefix: str, bb_p: Mapping, bb_s: Mapping,
             block_nums) -> None:
    """A flax CSN's (params, batch_stats) under ``prefix`` in the
    reference's names."""
    out[f"{prefix}.conv1.weight"] = _inv_conv3d(bb_p["conv1"]["kernel"])
    _put_bn(out, f"{prefix}.bn1", bb_p["bn1"], bb_s["bn1"])
    for s, blocks in enumerate(tuple(block_nums)):
        for b in range(blocks):
            name = f"layer{s + 1}_{b}"
            rp = f"{prefix}.layer{s + 1}.{b}"
            blk_p, blk_s = bb_p[name], bb_s[name]
            for conv in ("conv1", "conv3", "conv4"):
                bn = "bn" + conv[-1]
                out[f"{rp}.{conv}.weight"] = _inv_conv3d(
                    blk_p[conv]["kernel"])
                _put_bn(out, f"{rp}.{bn}", blk_p[bn], blk_s[bn])
            if b == 0:
                out[f"{rp}.down_sample.0.weight"] = _inv_conv3d(
                    blk_p["downsample_conv"]["kernel"])
                _put_bn(out, f"{rp}.down_sample.1",
                        blk_p["downsample_bn"], blk_s["downsample_bn"])


def tuber_torch_state_from_params(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any], *,
    block_nums, enc_layers: int = 6, dec_layers: int = 6,
    temporal_ds_strategy: str = "decode", single_frame: bool = True,
    ddp_prefix: bool = True,
) -> Dict[str, np.ndarray]:
    """Our (params, batch_stats) -> reference module-named state dict.

    ``ddp_prefix`` adds the ``module.`` prefix the released checkpoints
    carry (saved from DDP-wrapped models, model_utils.py:20-25). The
    transformer's encoder layers may be a MESH.PIPE model's
    ``encoder_stack`` (every leaf with a leading layer axis of
    ``enc_layers``), which crosses over as the sequential layers.
    """
    sd: Dict[str, np.ndarray] = {}
    _put_csn(sd, "backbone.body", params["backbone"],
             batch_stats["backbone"], block_nums)

    sd["query_embed.weight"] = np.asarray(params["query_embed"], np.float32)
    for ours, theirs in (("input_proj", "input_proj"),
                         ("class_proj", "class_proj")):
        # Dense kernel (I, O) -> 1x1x1 Conv3d weight (O, I, 1, 1, 1)
        sd[f"{theirs}.weight"] = _inv_linear(
            params[ours]["kernel"])[:, :, None, None, None]
        sd[f"{theirs}.bias"] = np.asarray(params[ours]["bias"], np.float32)

    tr = params["transformer"]
    if "encoder_stack" in tr:
        # a MESH.PIPE model's stacked encoder layers (leading layer axis)
        tr = unstack_encoder_params(tr, enc_layers)
    for i in range(enc_layers):
        _put_encoder_layer(sd, f"transformer.encoder.layers.{i}",
                           tr[f"encoder_layer_{i}"])
    for i in range(dec_layers):
        _put_decoder_layer(sd, f"transformer.decoder.layers.{i}",
                           tr[f"decoder_layer_{i}"])
    _put_ln(sd, "transformer.decoder.norm", tr["decoder_norm"])
    if "encoder_norm" in tr:
        _put_ln(sd, "transformer.encoder.norm", tr["encoder_norm"])

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


def _load_strict(module: torch.nn.Module, sd: Mapping[str, Any]):
    """``sd`` (numpy arrays) into ``module`` with ``strict=True``: every
    weight of the module must cross over, and nothing else."""
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()},
        strict=True)
    return module


def load_jax_variables(model: TubeR, params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> TubeR:
    """Load flax ``params`` / ``batch_stats`` trees (numpy arrays) into
    ``model`` through the reference key scheme, ``strict=True``."""
    return _load_strict(model, tuber_torch_state_from_params(
        params, batch_stats, block_nums=model.backbone.body.block_nums,
        enc_layers=model.enc_layers, dec_layers=model.dec_layers,
        temporal_ds_strategy=model.temporal_ds_strategy,
        single_frame=model.single_frame, ddp_prefix=False))


def _inv_conv2d(k) -> np.ndarray:
    """flax Conv kernel (kh, kw, in, out) -> torch Conv2d (out, in, kh, kw)."""
    return np.ascontiguousarray(
        np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1)))


def mh_attention_map_state(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX ``MHAttentionMap``'s params -> the port's state dict (the
    inverse of the JAX package's ``mh_attention_map_params``)."""
    sd: Dict[str, np.ndarray] = {}
    for name in ("q_linear", "k_linear"):
        _put_dense(sd, name, params[name])
    return sd


def mask_head_state(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX ``MaskHeadSmallConv``'s params -> the port's state dict
    (the inverse of ``mask_head_params``): each conv's kernel to (out, in,
    kh, kw), each GroupNorm's {scale, bias} to {weight, bias}."""
    sd: Dict[str, np.ndarray] = {}
    convs = [f"lay{i}" for i in range(1, 6)] + [
        f"adapter{i}" for i in range(1, 4)] + ["out_lay"]
    for name in convs:
        sd[f"{name}.weight"] = _inv_conv2d(params[name]["kernel"])
        sd[f"{name}.bias"] = np.asarray(params[name]["bias"], np.float32)
    for i in range(1, 6):
        _put_ln(sd, f"gn{i}", params[f"gn{i}"])
    return sd


def classifier_state(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                     block_nums) -> Dict[str, Any]:
    """The JAX ``VideoClassifier``'s variables -> the port's state dict:
    the trunk (flax's auto-named ``CSN_0``) under ``trunk.`` and the
    linear ``head``."""
    sd: Dict[str, np.ndarray] = {}
    _put_csn(sd, "trunk", params["CSN_0"], batch_stats["CSN_0"], block_nums)
    _put_dense(sd, "head", params["head"])
    return sd


def load_mh_attention_map(module: torch.nn.Module,
                          params: Mapping[str, Any]) -> torch.nn.Module:
    return _load_strict(module, mh_attention_map_state(params))


def load_mask_head(module: torch.nn.Module,
                   params: Mapping[str, Any]) -> torch.nn.Module:
    return _load_strict(module, mask_head_state(params))


def load_classifier(model: torch.nn.Module, params: Mapping[str, Any],
                    batch_stats: Mapping[str, Any]) -> torch.nn.Module:
    return _load_strict(model, classifier_state(
        params, batch_stats, model.trunk.block_nums))


def export_tuber_pth(path: str, model: torch.nn.Module,
                     ddp_prefix: bool = True) -> str:
    """Write ``model``'s parameters and statistics as a reference-format
    ``.pth`` (``{"model": state_dict}``, float32 on the CPU; with
    ``ddp_prefix`` each name under ``module.``, as the released checkpoints
    carry it), loadable by the reference's ``load_model``: the counterpart
    of the JAX package's ``export_tuber_pth``. The port's module names are
    the reference's, so this is the model's own state dict."""
    prefix = "module." if ddp_prefix else ""
    sd = {f"{prefix}{k}": v.detach().to(
        "cpu", torch.float32 if v.is_floating_point() else v.dtype).clone()
        for k, v in model.state_dict().items()}
    torch.save({"model": sd}, path)
    return path
