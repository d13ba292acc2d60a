"""GPipe pipeline parallelism over the transformer encoder's layers
(``MESH.PIPE``): the port's counterpart of
``tubelet_transformer_tpu/parallel/pipeline.py``.

The encoder's L layers are split into P = ``mesh.pipe`` stages of L/P
consecutive layers, each held by one pipe peer (``Transformer.
set_pipeline``); everything outside the encoder runs alike on every pipe
peer. The batch is cut into M microbatches, in order, and the loop runs
M + P - 1 ticks: at tick t stage p runs microbatch t - p through its
layers. The JAX package's schedule is kept as it is:

* every stage computes on every tick; on a tick where its microbatch
  index is out of range it runs on its clipped microbatch (or the zeros
  it got), and its output is masked to zeros;
* stage 0 reads its microbatch of the input, the other stages the carry
  that the stage before them handed on at the tick before
  (``Mesh.pipe_carry``, JAX's ``ppermute``);
* the last stage writes its valid outputs into the output, which is
  masked to zeros on the other stages and summed over the pipe group
  (``Mesh.reduce_from_pipe``, "g"), so every stage gets the last stage's
  rows;
* the input enters through ``Mesh.copy_to_pipe`` ("f"): its gradient is
  stage 0's, summed over the pipe group.

Every selection is ``torch.where`` on a flag tensor, never a Python
branch on the stage, so that every stage builds the same autograd graph:
the same collectives in the same order forward and backward, the idle
ticks' included. The bubble is (P - 1) / (M + P - 1) of the ticks.

``stack_encoder_params`` / ``unstack_encoder_params`` convert the JAX
package's parameter trees (nested dicts of numpy arrays) between the
sequential ``encoder_layer_{i}`` and the stacked ``encoder_stack``
layouts, for the weight bridge (``convert.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch


def _tree_map(fn, *trees):
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_encoder_params(tr_params: Mapping, n_layers: int) -> dict:
    """A JAX transformer parameter tree with its ``encoder_layer_{i}``
    subtrees folded into ``encoder_stack``, each leaf stacked on a new
    leading layer axis."""
    out = {k: v for k, v in tr_params.items()
           if not k.startswith("encoder_layer_")}
    out["encoder_stack"] = _tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[tr_params[f"encoder_layer_{i}"] for i in range(n_layers)])
    return out


def unstack_encoder_params(tr_params: Mapping, n_layers: int) -> dict:
    """The inverse of ``stack_encoder_params``."""
    out = {k: v for k, v in tr_params.items() if k != "encoder_stack"}
    for i in range(n_layers):
        out[f"encoder_layer_{i}"] = _tree_map(
            lambda a: np.asarray(a)[i], tr_params["encoder_stack"])
    return out


def pipeline_apply(layer_fn: Callable[[int, torch.Tensor, Dict[str,
                                       torch.Tensor], int], torch.Tensor],
                   layers_per_stage: int, x: torch.Tensor,
                   aux: Dict[str, torch.Tensor], mesh, microbatches: int
                   ) -> torch.Tensor:
    """Run this stage's layers as a GPipe pipeline over ``mesh``'s 'pipe'
    axis.

    ``layer_fn(i, y, aux_mb, mb)`` applies this stage's local layer ``i``
    to ``y``, microbatch ``mb`` of ``x`` with ``aux_mb`` its rows of each
    ``aux`` tensor (the padding mask, the position embedding). ``x``
    (B, ...) is this data shard's batch; B must divide by
    ``microbatches``, or ValueError names the global batch as the JAX
    package does. Returns the sequential layer loop's output on every
    stage, in ``x``'s order."""
    n, stage, m = mesh.pipe, mesh.pipe_index, microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b * mesh.data} not divisible by "
                         f"microbatches {m} x data axis {mesh.data}")
    x = mesh.copy_to_pipe(x)
    aux = {k: mesh.copy_to_pipe(v) if v.requires_grad else v
           for k, v in aux.items()}
    xs = x.reshape(m, b // m, *x.shape[1:])
    aux_mb = {k: v.reshape(m, b // m, *v.shape[1:]) for k, v in aux.items()}
    ticks = m + n - 1
    # (first stage, valid, valid on the last stage) of every tick, in one
    # copy to the device
    flags = torch.tensor([(stage == 0, 0 <= t - stage < m,
                           0 <= t - stage < m and stage == n - 1)
                          for t in range(ticks)], device=x.device)
    last = torch.tensor(stage == n - 1, device=x.device)
    out = [torch.zeros_like(xs[0])] * m
    carry = torch.zeros_like(xs[0])
    for t in range(ticks):
        mbc = min(max(t - stage, 0), m - 1)
        y = torch.where(flags[t, 0], xs[mbc], carry)
        a_t = {k: v[mbc] for k, v in aux_mb.items()}
        for i in range(layers_per_stage):
            y = layer_fn(i, y, a_t, mbc)
        y = torch.where(flags[t, 1], y, 0.0)
        out[mbc] = torch.where(flags[t, 2], y, out[mbc])
        if t < ticks - 1:
            carry = mesh.pipe_carry(y)
    return mesh.reduce_from_pipe(
        torch.where(last, torch.cat(out), 0.0)).reshape(x.shape)
