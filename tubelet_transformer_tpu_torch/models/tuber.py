"""TubeR: tubelet-query DETR for spatio-temporal action detection.

Port of ``tubelet_transformer_tpu/models/tuber.py``: irCSN backbone ->
temporal pooling (avg / max / learned decode / middle) -> DETR
encoder-decoder over the (t, H', W') tokens -> per-layer box, actorness and
class heads, the classes read out by a cross-attention over the un-pooled
features through a one-layer factorised space/time encoder.

Two dataset modes, as in the JAX model. AVA: Q queries, a per-query 3-way
actorness head and C sigmoid classes. JHMDB/UCF24 (``dataset_mode``
"jhmdb" or "ucf"): Q x T tubelet queries (T = ``temporal_length``, the
key frame's Q at rows key_pos*Q .. key_pos*Q + Q - 1), a clip-level 2-way
visibility head read from the mean of the un-pooled backbone features over
(T', H', W') (padded positions included, as in JAX) and broadcast over the
decoder layers, and C + 1 softmax classes.

Long-term context (``use_lfb``, ``CONFIG.USE_LFB``), as the JAX model adds
it (tuber.py:160-171, 276-299 there): the class branch's query states,
folded over the decoder layers, cross-attend (``lfb_attn``, 8 heads) over
the projected memory (``lfb_proj``) of ``lfb_features`` (B, L_mem, E) with
``lfb_mask`` (B, L_mem), True = pad, and the result is added back and
normed (``lfb_norm``). A fully padded memory adds nothing: the port's
additive mask makes such a row's attention uniform over the padding, so it
is zeroed, as JAX's ``jnp.where(any_valid, ltc, 0)`` does.
``generate_lfb`` (``MODEL.GENERATE_LFB``) returns only what the feature
bank keeps: the final layer's query features, actorness logits and boxes.

The transformer may be pre-norm (``normalize_before``,
``MODEL.NORMALIZE_BEFORE``) and its encoder FFNs Mixtures of Experts
(``moe_experts``, ``MODEL.MOE_EXPERTS``); the forward then returns the
mean of the MoE layers' load-balance losses as ``moe_aux``, which the
train step weighs by ``LOSS_COFS.MOE_AUX_COF``.

In training, dropout sits where the JAX model puts it: the transformer at
``MODEL.DROPOUT``, the pooling decoder, the class-branch encoder and its
cross-attention at 0.1, and the class head at 0.5 (tuber.py:133-155 there).

Submodules are named after the reference's key scheme, which
``train.torch_convert.tuber_torch_state_from_params`` emits; ``convert.py``
loads the JAX package's variables through it with ``strict=True``. The
reference has no long-term context and no MoE, so the three LFB modules and
each encoder layer's ``moe_ffn`` carry the port's own names.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.models.csn import (
    FoldableBN, PointwiseConv, build_csn)
from tubelet_transformer_tpu_torch.models.layers import (
    MLP, Dropout, FactorizedSTEncoderLayer, LayerStack, Linear,
    LSTRDecoderLayer, MultiHeadAttention, layer_norm)
from tubelet_transformer_tpu_torch.models.moe import (
    MoEFFN, Router, expert_init_)
from tubelet_transformer_tpu_torch.models.transformer import Transformer
from tubelet_transformer_tpu_torch.ops.position_encoding import (
    position_embedding_sine_3d)
from tubelet_transformer_tpu_torch.train.optimizer import stop_grad_stage

POOL_DIM = 2048     # CSN output channels, the width of the pooling decoder
STRATEGIES = ("avg", "max", "decode", "middle")
DATASET_MODES = ("ava", "jhmdb", "ucf")


def nearest_resize_mask(x: torch.Tensor, out_h: int, out_w: int
                        ) -> torch.Tensor:
    """Nearest resize of axes (1, 2): out[i] = in[floor(i * H / out_h)], as
    ``F.interpolate(mode='nearest')`` and the JAX version, in float32."""
    h, w = x.shape[1], x.shape[2]
    dev = x.device
    rows = torch.floor(torch.arange(out_h, dtype=torch.float32, device=dev)
                       * (h / out_h)).long()
    cols = torch.floor(torch.arange(out_w, dtype=torch.float32, device=dev)
                       * (w / out_w)).long()
    return x[:, rows][:, :, cols]


class Backbone(nn.Module):
    """The CSN trunk (``body``) and, for the learned temporal pooling, its
    query (``query_pool``) and LSTR decoder (``pool_decoder``)."""

    def __init__(self, body: nn.Module, decode: bool):
        super().__init__()
        self.body = body
        if decode:
            self.query_pool = nn.Embedding(1, POOL_DIM)
            self.pool_decoder = LayerStack(
                [LSTRDecoderLayer(POOL_DIM, 8, 2048, dropout=0.1)],
                norm=layer_norm(POOL_DIM))


class TubeR(nn.Module):
    """Clips (B,T,H,W,3) normalised RGB + pad mask (B,H,W) -> detections.
    ``tp``: the mesh whose 'model' axis the model is split over
    (``parallel.sharding_rules.shard_model``), else None. ``spatial``
    (MESH.SPATIAL, ``set_spatial``): the mesh whose model peers split the
    clip's rows through the trunk, else None; the forward then takes this
    peer's rows of the clips (``Mesh.own_rows``) and the whole pad mask,
    and gathers the trunk's output rows before the temporal pool."""

    tp = None
    spatial = None

    def __init__(self, num_classes: int = 80, num_queries: int = 15,
                 hidden_dim: int = 256, nhead: int = 8, enc_layers: int = 6,
                 dec_layers: int = 6, dim_feedforward: int = 2048,
                 backbone_name: str = "CSN-152", last_stride: bool = False,
                 single_frame: bool = True,
                 temporal_ds_strategy: str = "decode",
                 stem_kernel: bool = True, dropout: float = 0.1,
                 stop_grad_stage: int = -1,
                 compute_dtype: torch.dtype = torch.float32,
                 pallas_kernels: bool = False, fused_blocks: bool = False,
                 fused_stages: bool = False, dataset_mode: str = "ava",
                 temporal_length: int = 32, use_lfb: bool = False,
                 generate_lfb: bool = False, frozen_chunk: int = 0,
                 remat_backbone: bool = False,
                 normalize_before: bool = False, moe_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25):
        super().__init__()
        if temporal_ds_strategy not in STRATEGIES:
            raise ValueError(f"unknown temporal_ds_strategy "
                             f"{temporal_ds_strategy!r}")
        if dataset_mode not in DATASET_MODES:
            raise ValueError(f"unknown dataset_mode {dataset_mode!r}")
        self.is_ava = dataset_mode == "ava"
        self.hidden_dim = hidden_dim
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        self.single_frame = single_frame
        self.temporal_ds_strategy = temporal_ds_strategy
        # the dtype the model computes in; its parameters may be float32
        self.dtype = compute_dtype
        self.backbone = Backbone(
            build_csn(backbone_name, last_stride, stem_kernel,
                      stop_grad_stage, pallas_kernels, fused_blocks,
                      fused_stages, frozen_chunk, remat_backbone),
            decode=single_frame and temporal_ds_strategy == "decode")
        self.transformer = Transformer(hidden_dim, nhead, enc_layers,
                                       dec_layers, dim_feedforward, dropout,
                                       normalize_before, moe_experts,
                                       moe_top_k, moe_capacity_factor)
        self.query_embed = nn.Embedding(
            num_queries if self.is_ava else num_queries * temporal_length,
            hidden_dim)
        self.input_proj = PointwiseConv(POOL_DIM, hidden_dim, bias=True)
        self.class_proj = PointwiseConv(POOL_DIM, hidden_dim, bias=True)
        self.encoder = LayerStack(
            [FactorizedSTEncoderLayer(hidden_dim, 8, 2048, dropout=0.1)])
        self.cross_attn = MultiHeadAttention(hidden_dim, 8, dropout=0.1)
        self.class_embed_b = (Linear(hidden_dim, 3) if self.is_ava
                              else Linear(POOL_DIM, 2))
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)
        self.head_dropout = Dropout(0.5)
        self.class_fc = Linear(hidden_dim, num_classes + (not self.is_ava))
        self.use_lfb, self.generate_lfb = use_lfb, generate_lfb
        if use_lfb:
            self.lfb_proj = Linear(hidden_dim, hidden_dim)
            self.lfb_attn = MultiHeadAttention(hidden_dim, 8, dropout)
            self.lfb_norm = layer_norm(hidden_dim)

    def set_spatial(self, mesh) -> None:
        """Split the clip's rows over ``mesh``'s model peers through the
        trunk (None: the whole clip on every peer)."""
        self.spatial = mesh
        self.backbone.body.set_spatial(mesh)

    def set_dropout_generator(self, generator: Optional[torch.Generator]
                              ) -> None:
        """Every dropout of the model draws its masks from ``generator``
        (under a pipeline, the stage's encoder layers from masks seeded
        from it: ``Transformer.set_dropout_generator``)."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator
        self.transformer.set_dropout_generator(generator)

    def _temporal_pool(self, xs: torch.Tensor) -> torch.Tensor:
        """(B,T',H',W',C) -> (B,1,H',W',C) when single_frame."""
        if not self.single_frame:
            return xs
        b, t, h, w, c = xs.shape
        strategy = self.temporal_ds_strategy
        if strategy == "avg":
            return xs.mean(dim=1, keepdim=True)
        if strategy == "max":
            return xs.amax(dim=1, keepdim=True)
        if strategy == "decode":
            # one query cross-attends over time at each spatial location
            mem = xs.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
            tgt = self.backbone.query_pool.weight.to(mem.dtype)[None].expand(
                b * h * w, 1, c)
            dec = self.backbone.pool_decoder
            out = dec.norm(dec.layers[0](tgt, mem))
            return out.reshape(b, h, w, 1, c).permute(0, 3, 1, 2, 4)
        return xs[:, t // 2: t // 2 + 1]

    def _fuse_lfb(self, q_class: torch.Tensor, lfb_features: torch.Tensor,
                  lfb_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Residual cross-attention of the (L,B,Q,E) query states over the
        memory; a fully padded memory row adds nothing."""
        lay_n, b, nq, e = q_class.shape
        mem = self.lfb_proj(lfb_features.to(q_class.dtype))   # (B,L_mem,E)
        l_mem = mem.shape[1]
        mem_rep = mem[None].expand(lay_n, -1, -1, -1).reshape(
            lay_n * b, l_mem, e)
        if lfb_mask is None:
            lfb_mask = torch.zeros((b, l_mem), dtype=torch.bool,
                                   device=mem.device)
        mask_rep = lfb_mask[None].expand(lay_n, -1, -1).reshape(
            lay_n * b, l_mem)
        qc = q_class.reshape(lay_n * b, nq, e)
        ltc = self.lfb_attn(qc, mem_rep, mem_rep, key_padding_mask=mask_rep)
        any_valid = (~mask_rep).any(dim=-1)[:, None, None]
        qc = self.lfb_norm(qc + torch.where(any_valid, ltc, 0.0))
        return qc.reshape(lay_n, b, nq, e)

    def forward(self, clips: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                return_features: bool = False,
                lfb_features: Optional[torch.Tensor] = None,
                lfb_mask: Optional[torch.Tensor] = None,
                moe_reduce=None) -> dict:
        """clips (B,T,H,W,3), pad_mask (B,H,W) True = pad; with
        ``use_lfb``, the memory ``lfb_features`` (B,L_mem,E) and
        ``lfb_mask`` (B,L_mem) True = pad. ``moe_reduce`` sums the MoE
        load-balance counts over ranks (``Mesh.count_sum``; None: this
        batch alone), so that ``moe_aux`` is this rank's share."""
        b, _, h_in, w_in, _ = clips.shape
        if self.spatial is not None:
            h_in *= self.spatial.model
        if clips.dtype != self.dtype:
            clips = clips.to(self.dtype)
        if pad_mask is None:
            pad_mask = torch.zeros((b, h_in, w_in), dtype=torch.bool,
                                   device=clips.device)
        e = self.hidden_dim

        xt = self.backbone.body(clips)                   # (B,T',H',W',2048)
        if self.spatial is not None:
            xt = self.spatial.gather_height(
                xt, self.backbone.body.row_bands(h_in)[-1])
        xs = self._temporal_pool(xt)                     # (B,t,H',W',2048)
        _, t, h, w, _ = xs.shape

        feat_mask = nearest_resize_mask(pad_mask, h, w)
        feat_mask_t = feat_mask[:, None].expand(b, t, h, w)
        pos = position_embedding_sine_3d(~feat_mask_t, e, dtype=xs.dtype)
        src = self.input_proj(xs)
        moe_aux: list = []
        hs = self.transformer(src.reshape(b, t * h * w, e),
                              feat_mask_t.reshape(b, t * h * w),
                              self.query_embed.weight,
                              pos.reshape(b, t * h * w, e),
                              moe_aux, moe_reduce)           # (L,B,Q,E)
        lay_n, _, nq, _ = hs.shape
        if self.is_ava:
            outputs_class_b = self.class_embed_b(hs)      # (L,B,Q,3)
        else:
            cb = self.class_embed_b(xt.mean(dim=(1, 2, 3)))   # (B, 2)
            outputs_class_b = cb[None].expand(lay_n, -1, -1)

        # class branch over the un-pooled features
        tc = xt.shape[1]
        enc = self.encoder.layers[0](
            self.class_proj(xt).reshape(b, tc, h * w, e))
        enc_rep = enc.reshape(b, tc * h * w, e)[None].expand(
            lay_n, -1, -1, -1).reshape(lay_n * b, tc * h * w, e)
        q_class = self.cross_attn(hs.reshape(lay_n * b, nq, e), enc_rep,
                                  enc_rep).reshape(lay_n, b, nq, e)
        if self.use_lfb and lfb_features is not None:
            q_class = self._fuse_lfb(q_class, lfb_features, lfb_mask)
        q_class = self.head_dropout(q_class)

        outputs_coord = torch.sigmoid(self.bbox_embed(hs).float())
        if self.generate_lfb:
            # what the feature bank keeps: the final layer's query states
            # after the context cross-attention, and their actorness
            return {"lfb_features": q_class[-1].float(),
                    "pred_logits_b": outputs_class_b[-1].float(),
                    "pred_boxes": outputs_coord[-1]}
        outputs_class = self.class_fc(q_class)            # (L,B,Q,C)
        out = {
            "pred_logits": outputs_class[-1].float(),
            "pred_boxes": outputs_coord[-1],
            "pred_logits_b": outputs_class_b[-1].float(),
            "aux_logits": outputs_class.float(),
            "aux_boxes": outputs_coord,
            "aux_logits_b": outputs_class_b.float(),
        }
        if return_features:
            out["lfb_features"] = q_class[-1].float()
        if moe_aux:
            # the mean over the MoE layers, as the JAX train step takes it
            out["moe_aux"] = sum(moe_aux) / len(moe_aux)
        return out


def _lecun_normal_(t: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    # flax lecun_normal: truncated normal at 2 std, rescaled to unit variance
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn like the JAX package's initialisers: LeCun
    normal for convs, plain dense layers and MoE routers, Xavier uniform
    for attention, transformer FFNs and expert stacks, N(0, 1) query
    embeddings, identity norms and BN."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv3d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, MoEFFN):
            expert_init_(m.expert_w1, generator)
            expert_init_(m.expert_w2, generator)
            m.expert_b1.zero_()
            m.expert_b2.zero_()
        elif isinstance(m, (nn.LayerNorm, FoldableBN)):
            m.reset_parameters()
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            nn.init.xavier_uniform_(m.in_proj_weight, generator=generator)
            nn.init.xavier_uniform_(m.out_proj.weight, generator=generator)
            m.in_proj_bias.zero_()
        for ffn in ("linear1", "linear2"):
            if isinstance(getattr(m, ffn, None), nn.Linear):
                nn.init.xavier_uniform_(getattr(m, ffn).weight,
                                        generator=generator)


def dataset_mode(cfg: Config) -> str:
    """"ava" for every dataset but the tubelet ones (JHMDB, UCF24)."""
    name = cfg.data.dataset_name
    return name if name in ("jhmdb", "ucf") else "ava"


def build_model(cfg: Config, device: torch.device | str = "cpu",
                seed: int = 0, train: bool = False,
                pretrained: bool = False, mesh=None) -> TubeR:
    """TubeR for ``cfg`` on ``device``, with random weights from ``seed``
    (drawn on the CPU, so equal on every device); it computes in
    ``MODEL.COMPUTE_DTYPE``. The eval build (``train=False``) is in eval mode
    with its parameters cast once to the compute dtype. The train build is in
    train mode with float32 parameters, cast to the compute dtype at use as
    the JAX package keeps them. BatchNorm statistics stay float32. With
    ``pretrained``, the weight files the config names
    (``train.checkpoint.load_pretrained``) replace the random weights, in
    float32, before the eval build's cast (which leaves the BN statistics
    and the MoE routers float32). With a ``mesh`` (``parallel.mesh.Mesh``)
    whose 'model' axis has more than one peer, the full model is then
    split over it (``parallel.sharding_rules.shard_model``): the weight
    files load unchanged; with ``mesh.spatial`` beside it (MESH.SPATIAL)
    the model peers also split the clip's rows (``TubeR.set_spatial``).
    With MESH.PIPE > 1 the ``mesh`` (its 'pipe' axis of that size) is
    required, as the JAX package requires it, and the model keeps this
    pipe stage's encoder layers (``Transformer.set_pipeline``), which stay
    whole under a 'model' axis."""
    m = cfg.model
    if cfg.mesh.pipe > 1 and (mesh is None or mesh.pipe != cfg.mesh.pipe):
        raise ValueError(f"MESH.PIPE {cfg.mesh.pipe} requires "
                         "build_model(cfg, mesh=...) with its 'pipe' axis, "
                         "so the encoder can run as stages over it")
    if cfg.train.frozen_chunk and cfg.mesh.data > 1:
        raise ValueError("TRAIN.FROZEN_CHUNK is a single-device option; "
                         "disable it when MESH.DATA > 1")
    dtype = torch.bfloat16 if m.compute_dtype == "bfloat16" else torch.float32
    model = TubeR(num_classes=cfg.data.num_classes, num_queries=m.query_num,
                  hidden_dim=m.d_model, nhead=m.nhead,
                  enc_layers=m.enc_layers, dec_layers=m.dec_layers,
                  dim_feedforward=m.dim_feedforward,
                  backbone_name=m.backbone_name, last_stride=m.last_stride,
                  single_frame=m.single_frame,
                  temporal_ds_strategy=m.temporal_ds_strategy,
                  stem_kernel=m.stem_kernel, dropout=m.dropout,
                  stop_grad_stage=stop_grad_stage(cfg), compute_dtype=dtype,
                  pallas_kernels=m.pallas_kernels,
                  fused_blocks=m.fused_blocks,
                  fused_stages=m.fused_stages,
                  dataset_mode=dataset_mode(cfg), temporal_length=m.temp_len,
                  use_lfb=cfg.use_lfb, generate_lfb=m.generate_lfb,
                  frozen_chunk=cfg.train.frozen_chunk,
                  remat_backbone=cfg.train.remat_backbone,
                  normalize_before=m.normalize_before,
                  moe_experts=m.moe_experts, moe_top_k=m.moe_top_k,
                  moe_capacity_factor=m.moe_capacity_factor)
    init_weights(model, torch.Generator().manual_seed(seed))
    if pretrained:
        from tubelet_transformer_tpu_torch.train.checkpoint import (
            load_pretrained)

        load_pretrained(cfg, model)
    if train:
        model = model.to(device).train()
    else:
        # one cast here, not one per use: the serving path is host-bound
        for mod in model.modules():
            if not isinstance(mod, (FoldableBN, Router)):
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(dtype)
        model = model.to(device).eval()
    if mesh is not None and mesh.pipe > 1:
        model.transformer.set_pipeline(mesh, cfg.mesh.pipe_microbatches)
    if mesh is not None and mesh.model > 1:
        from tubelet_transformer_tpu_torch.parallel.sharding_rules import (
            shard_model)

        shard_model(model, mesh)
    if mesh is not None and mesh.spatial:
        model.set_spatial(mesh)
    return model
