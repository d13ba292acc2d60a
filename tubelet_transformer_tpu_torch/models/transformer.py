"""DETR-style encoder-decoder over spatio-temporal tokens, batch-first.

Port of ``tubelet_transformer_tpu/models/transformer.py`` (the sequential
encoder): the decoder returns the normed state after every layer, stacked
as (L, B, Q, E). With ``normalize_before`` the layers are pre-norm and the
encoder's output is normed (``encoder.norm``, the JAX ``encoder_norm``);
the decoder's norm is there in both cases. With ``moe_experts > 0`` every
encoder layer's FFN is a Mixture of Experts.

Pipeline parallelism (``MESH.PIPE``, ``set_pipeline``): the module keeps
only this pipe stage's L/P consecutive encoder layers, each under its
global name (``encoder.layers.{i}``; the other stages' slots hold a
``StageSlot`` without parameters), and the encoder runs them as a GPipe
schedule over the mesh's 'pipe' axis (``parallel/pipeline.py``); the
pre-norm encoder's final norm, the decoder and everything else run alike
on every stage, as JAX's ``_pipelined_encoder`` has it. In training each
(global layer, microbatch) draws its dropout masks from a generator of
its own, seeded from the model's generator's seed (which the train step
sets from the step and the data index), the layer and the microbatch: the
masks differ across data shards and are equal on the model peers, as the
JAX package folds its key.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tubelet_transformer_tpu_torch.models.layers import (
    DecoderLayer, Dropout, EncoderLayer, LayerStack, layer_norm)
from tubelet_transformer_tpu_torch.parallel.pipeline import pipeline_apply


class StageSlot(nn.Module):
    """The place of an encoder layer that another pipe stage holds."""


def dropout_seed(seed: int, layer: int, microbatch: int) -> int:
    """The seed of (global layer, microbatch)'s dropout masks from the
    step's ``seed``: distinct (layer, microbatch) pairs give distinct low
    32 bits (the CPU generator keeps those alone), by an odd multiplier."""
    return (seed * 1_000_003 + (layer * 4099 + microbatch + 1)
            * 2_246_822_519) % 2 ** 63


class Transformer(nn.Module):

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.0,
                 normalize_before: bool = False, moe_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25):
        super().__init__()
        self.encoder = LayerStack(
            (EncoderLayer(d_model, nhead, dim_feedforward, dropout,
                          normalize_before, moe_experts, moe_top_k,
                          moe_capacity_factor)
             for _ in range(num_encoder_layers)),
            norm=layer_norm(d_model) if normalize_before else None)
        self.decoder = LayerStack(
            (DecoderLayer(d_model, nhead, dim_feedforward, dropout,
                          normalize_before)
             for _ in range(num_decoder_layers)), norm=layer_norm(d_model))
        # MESH.PIPE: the mesh, the microbatch count and this stage's
        # first layer (set_pipeline)
        self.pipe = None
        self.microbatches = 1
        self.first_layer = 0
        self._seed_source: Optional[torch.Generator] = None
        self._pipe_generator: Optional[torch.Generator] = None

    def set_pipeline(self, mesh, microbatches: int) -> None:
        """Keep this pipe stage's encoder layers (``mesh.pipe_index``'s
        L/P), each parameter marked ``pipe_stage``, and run the encoder
        as stages over ``mesh``'s 'pipe' axis with ``microbatches``
        microbatches. ValueError when P does not divide L, and
        NotImplementedError for MoE encoder FFNs, as in the JAX
        package."""
        layers = self.encoder.layers
        n_layers, n = len(layers), mesh.pipe
        if n_layers % n:
            raise ValueError(f"{n_layers} layers not divisible by {n} "
                             "pipeline stages")
        if any(getattr(layer, "moe_ffn", None) is not None
               for layer in layers):
            raise NotImplementedError(
                "MoE inside the pipelined encoder is not supported; use "
                "MESH.PIPE=1 with MODEL.MOE_EXPERTS, or dense FFN with PP")
        per = n_layers // n
        self.first_layer = mesh.pipe_index * per
        for i in range(n_layers):
            if self.first_layer <= i < self.first_layer + per:
                for p in layers[i].parameters():
                    p.pipe_stage = True
            else:
                layers[i] = StageSlot()
        self.pipe, self.microbatches = mesh, microbatches

    def stage_layers(self) -> list:
        """This pipe stage's encoder layers (every layer without a
        pipeline)."""
        return [m for m in self.encoder.layers
                if not isinstance(m, StageSlot)]

    def set_dropout_generator(self, generator: Optional[torch.Generator]
                              ) -> None:
        """Under a pipeline, this stage's encoder layers draw their masks
        from a generator of their own, reseeded for every (global layer,
        microbatch) from ``generator``'s seed (``dropout_seed``); the
        rest of the model draws from ``generator`` itself
        (``TubeR.set_dropout_generator``)."""
        self._seed_source = generator
        self._pipe_generator = None
        if self.pipe is None or generator is None:
            return
        self._pipe_generator = torch.Generator(device=generator.device)
        for layer in self.stage_layers():
            for m in layer.modules():
                if isinstance(m, Dropout):
                    m.generator = self._pipe_generator

    def _pipelined_encoder(self, src: torch.Tensor,
                           mask: Optional[torch.Tensor],
                           pos_embed: torch.Tensor) -> torch.Tensor:
        layers = self.stage_layers()
        seed = (self._seed_source.initial_seed()
                if self.training and self._pipe_generator is not None
                else None)
        if mask is None:
            mask = torch.zeros(src.shape[:2], dtype=torch.bool,
                               device=src.device)

        def layer_fn(i, y, aux, mb):
            if seed is not None:
                self._pipe_generator.manual_seed(
                    dropout_seed(seed, self.first_layer + i, mb))
            return layers[i](y, key_padding_mask=aux["mask"], pos=aux["pos"])

        return pipeline_apply(layer_fn, len(layers), src,
                              {"mask": mask, "pos": pos_embed}, self.pipe,
                              self.microbatches)

    def forward(self, src: torch.Tensor, mask: Optional[torch.Tensor],
                query_embed: torch.Tensor, pos_embed: torch.Tensor,
                moe_aux: Optional[list] = None,
                moe_reduce=None) -> torch.Tensor:
        """src/pos_embed (B,S,E), mask (B,S) True = pad, query_embed (Q,E)
        -> (L,B,Q,E). Each MoE encoder layer appends its load-balance loss
        to ``moe_aux`` when one is given, its counts summed by
        ``moe_reduce`` (``MoEFFN.forward``'s ``reduce``)."""
        if self.pipe is not None:
            memory = self._pipelined_encoder(src, mask, pos_embed)
        else:
            memory = src
            for layer in self.encoder.layers:
                memory = layer(memory, key_padding_mask=mask, pos=pos_embed,
                               moe_aux=moe_aux, moe_reduce=moe_reduce)
        if self.encoder.norm is not None:
            memory = self.encoder.norm(memory)
        b = src.shape[0]
        query_pos = query_embed.to(src.dtype)[None].expand(b, -1, -1)
        out = torch.zeros_like(query_pos)
        intermediate = []
        for layer in self.decoder.layers:
            out = layer(out, memory, memory_key_padding_mask=mask,
                        pos=pos_embed, query_pos=query_pos)
            intermediate.append(self.decoder.norm(out))
        return torch.stack(intermediate)
