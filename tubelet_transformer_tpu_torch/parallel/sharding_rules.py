"""The 'model' axis (``MESH.MODEL``): which parameters split over the model
peers, and the collectives that move between the split and the full
layout.

The port's counterpart of ``tubelet_transformer_tpu/parallel/
sharding_rules.py:param_shardings``, which names the same parameters and
leaves the rest to GSPMD:

* column-parallel: each attention's packed q/k/v projection
  (``in_proj_weight``, (3E, E)) and each FFN's ``linear1`` split their
  output rows over 'model';
* row-parallel: each attention's ``out_proj`` and each FFN's ``linear2``
  split their input columns;
* expert parallelism: the MoE stacks ``expert_w1``, ``expert_b1``,
  ``expert_w2``, ``expert_b2`` split their expert axis;
* everything else is replicated, the router and every other bias
  included.

Where ``model`` divides an attention's heads the port splits it by head:
each peer holds the q, k and v rows of its ``nhead / model`` heads, so
that it attends over them alone (``Split(0, 3)``: the 3E rows taken as
three blocks, each cut in ``model``). GSPMD's cut of the packed 3E axis
does not fall on head boundaries, but the sums are the same. Where it
does not divide the heads, the port takes JAX's rule by divisibility
alone: ``in_proj_weight`` in ``model`` contiguous row blocks where it
divides 3E (``Split(0)``: q, k and v themselves at 3 peers), and
``out_proj`` by columns where it divides E; the peers then gather the
whole q, k and v and attend over every head
(``MultiHeadAttention._forward_rows``). An FFN whose width ``model`` does
not divide stays replicated, as in JAX, and so does an MoE whose experts
it does not divide.

``shard_model`` replaces each split parameter in place by this peer's
slice, after the full model is built from the seed or from weight files,
and hands the mesh to the modules that run the collectives
(``MultiHeadAttention``, the FFN layers and ``MoEFFN``, whose ``tp`` it
sets). ``gather_state`` and ``gather_optimizer_state`` rebuild the
one-process layout from the peers' slices (collectives of the model group);
``load_full_state`` and ``shard_optimizer_state`` take that layout and
keep this peer's slices, so a checkpoint is the same file at any
``MESH.MODEL``.

The 'pipe' axis (``MESH.PIPE``): each pipe stage holds its L/P encoder
layers (``transformer.encoder.layers.{i}``, ``stage_held``) under their
global names, and JAX's rule that the stacked encoder shards over 'pipe'
comes before the TP rules, so under MESH.PIPE x MESH.MODEL the encoder
layers stay whole on their stage. The same functions gather the stages'
layers (and their AdamW moments) over the pipe group after the model
group, into the one-process names and order, and keep this stage's
layers on the way in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn

from tubelet_transformer_tpu_torch.models.layers import MultiHeadAttention
from tubelet_transformer_tpu_torch.models.moe import MoEFFN
from tubelet_transformer_tpu_torch.parallel.mesh import Mesh
from tubelet_transformer_tpu_torch.parallel.zero import all_gather_flat

EXPERT_STACKS = ("expert_w1", "expert_b1", "expert_w2", "expert_b2")
MOMENTS = ("exp_avg", "exp_avg_sq")


@dataclass(frozen=True)
class Split:
    """A parameter split over the model peers along ``dim``, taken as
    ``groups`` equal blocks that are each cut in ``model`` parts (3 for
    the packed q/k/v rows, 1 otherwise): peer i holds part i of every
    block."""

    dim: int
    groups: int = 1


def local_slice(t: torch.Tensor, split: Split, n: int, i: int
                ) -> torch.Tensor:
    """Peer ``i``'s part of ``t`` among ``n`` peers."""
    blocks = t.chunk(split.groups, split.dim)
    return torch.cat([b.chunk(n, split.dim)[i] for b in blocks], split.dim)


def assemble(parts: List[torch.Tensor], split: Split) -> torch.Tensor:
    """The full tensor from every peer's part, in peer order."""
    blocks = [p.chunk(split.groups, split.dim) for p in parts]
    return torch.cat([b[g] for g in range(split.groups) for b in blocks],
                     split.dim)


def _is_ffn(m: nn.Module) -> bool:
    return all(isinstance(getattr(m, k, None), nn.Linear)
               for k in ("linear1", "linear2"))


def param_shardings(model: nn.Module, mesh: Mesh
                    ) -> Dict[str, Optional[Split]]:
    """Every parameter name of the full ``model`` -> its ``Split`` over
    ``mesh``'s 'model' axis, or None (replicated; the encoder layers too
    when ``mesh`` has a 'pipe' axis). JAX's rules: an attention's packed
    projection splits where the axis divides 3E (by head where it divides
    the heads, else in contiguous row blocks) and its ``out_proj`` where
    it divides E."""
    n = mesh.model
    out: Dict[str, Optional[Split]] = {k: None for k, _ in
                                       model.named_parameters()}
    if n == 1:
        return out
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if mesh.pipe > 1 and stage_held(pre):
            continue
        if isinstance(m, MultiHeadAttention):
            e = m.in_proj_weight.shape[1]
            if m.num_heads % n == 0:
                out[pre + "in_proj_weight"] = Split(0, 3)
                out[pre + "out_proj.weight"] = Split(1)
            elif (3 * e) % n == 0:
                out[pre + "in_proj_weight"] = Split(0)
                if e % n == 0:
                    out[pre + "out_proj.weight"] = Split(1)
        elif isinstance(m, MoEFFN):
            if m.num_experts % n == 0:
                for k in EXPERT_STACKS:
                    out[pre + k] = Split(0)
        elif _is_ffn(m) and m.linear1.out_features % n == 0:
            out[pre + "linear1.weight"] = Split(0)
            out[pre + "linear2.weight"] = Split(1)
    return out


# the encoder's layers: with MESH.PIPE each stage holds L/P of them
STAGE = "transformer.encoder.layers."


def stage_held(name: str) -> bool:
    """Whether parameter (or module) ``name`` belongs to an encoder layer,
    which under MESH.PIPE one pipe stage holds."""
    return name.startswith(STAGE)


def _layer_and_rest(name: str) -> tuple[int, str]:
    i, rest = name[len(STAGE):].split(".", 1)
    return int(i), rest


def _pipeline(model: nn.Module):
    """The model's transformer when its encoder runs as pipe stages
    (``Transformer.set_pipeline``), else None."""
    tr = getattr(model, "transformer", None)
    return tr if getattr(tr, "pipe", None) is not None else None


def _full_names(tr, names: List[str]) -> List[str]:
    """``names`` (this stage's order) with the block of this stage's
    encoder entries replaced by every stage's, layer by layer: the
    one-process names in the one-process order."""
    held = [k for k in names if stage_held(k)]
    if not held:
        return list(names)
    per = len(tr.stage_layers())
    start = names.index(held[0])
    if names[start:start + len(held)] != held:
        raise ValueError("the encoder's entries are not contiguous")
    rests = [r for i, r in map(_layer_and_rest, held) if i == tr.first_layer]
    block = [f"{STAGE}{g}.{r}" for g in range(per * tr.pipe.pipe)
             for r in rests]
    return names[:start] + block + names[start + len(held):]


def gather_stages(model: nn.Module, tensors: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """``tensors`` keyed by name with every pipe stage's encoder entries
    in place of this stage's, in the one-process order: one
    ``all_gather_into_tensor`` over the pipe group per dtype when the
    model runs its encoder as stages (every stage holds the same layer
    structure), else ``tensors`` itself."""
    tr = _pipeline(model)
    names = [k for k in tensors if stage_held(k)]
    if tr is None or not names:
        return tensors
    mesh, per = tr.pipe, len(tr.stage_layers())
    parts = [tensors[k].detach() for k in names]
    got: Dict[str, torch.Tensor] = {}
    for dtype in dict.fromkeys(p.dtype for p in parts):
        idx = [j for j, p in enumerate(parts) if p.dtype == dtype]
        flat = torch.cat([parts[j].reshape(-1) for j in idx])
        segs = all_gather_flat(flat, mesh.pipe, mesh.pipe_group).split(
            [parts[j].numel() for j in idx], dim=1)
        for j, seg in zip(idx, segs):
            i, rest = _layer_and_rest(names[j])
            for q in range(mesh.pipe):
                got[f"{STAGE}{i - tr.first_layer + q * per}.{rest}"] = (
                    seg[q].view(parts[j].shape))
    return {k: tensors[k] if k in tensors and not stage_held(k) else got[k]
            for k in _full_names(tr, list(tensors))}


# the CSN trunk's parameters: with the clip's rows split over the model
# peers (MESH.SPATIAL), each peer's gradient of one is its rows' share
TRUNK = "backbone.body."


def spatial_partial(name: str) -> bool:
    """Whether, with the clip's rows split over the model peers
    (MESH.SPATIAL), a peer's gradient of parameter ``name`` is a partial
    sum over its own rows, to be summed over the model group
    (``Mesh.trunk_sum``): the trunk's parameters. Every other gradient is
    whole on each peer already: a replicated parameter's because "f" has
    summed the peers' partial gradients where it enters a split region
    (summing again would count it ``model`` times), a split one's because
    it is the peer's own slice. After the sum the trunk's gradients are
    replicated like any other replicated parameter's, which the clip's
    norm and ZeRO-1 take them for."""
    return name.startswith(TRUNK)


def split_params(model: nn.Module) -> Dict[str, Split]:
    """The split parameters of a sharded model, by name."""
    return {k: p.tp_split for k, p in model.named_parameters()
            if getattr(p, "tp_split", None) is not None}


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace, in place, each parameter that ``param_shardings`` splits
    by this peer's slice (a new ``nn.Parameter`` in the same place, so the
    parameters keep their order; ``tp_split`` marks it), and set ``tp`` to
    ``mesh`` on the modules that own one and on ``model``. A no-op when
    nothing splits."""
    specs = {k: s for k, s in param_shardings(model, mesh).items() if s}
    if not specs:
        return model
    n, i = mesh.model, mesh.model_index
    for name, split in specs.items():
        owner_name, _, pname = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        old = getattr(owner, pname)
        p = nn.Parameter(local_slice(old.detach(), split, n, i).clone(),
                         requires_grad=old.requires_grad)
        p.tp_split = split
        setattr(owner, pname, p)
        # the module that runs the collectives: the attention, the MoE,
        # or the layer that holds the FFN's linear1 and linear2
        if pname == "weight":
            owner = model.get_submodule(owner_name.rpartition(".")[0])
        owner.tp = mesh
    model.tp = mesh
    return model


def _gather_flat(parts: List[torch.Tensor], splits: List[Split],
                 mesh: Mesh) -> List[torch.Tensor]:
    """The full tensors of ``parts`` (this peer's slices) from every model
    peer's, one ``all_gather_into_tensor`` over the model group per
    dtype."""
    full: List[Optional[torch.Tensor]] = [None] * len(parts)
    for dtype in dict.fromkeys(p.dtype for p in parts):
        idx = [j for j, p in enumerate(parts) if p.dtype == dtype]
        flat = torch.cat([parts[j].reshape(-1) for j in idx])
        segs = all_gather_flat(flat, mesh.model, mesh.model_group).split(
            [parts[j].numel() for j in idx], dim=1)
        for j, seg in zip(idx, segs):
            full[j] = assemble([s.view(parts[j].shape) for s in seg],
                               splits[j])
    return full


def gather_tensors(model: nn.Module, tensors: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """``tensors`` keyed by parameter name (the parameters, their
    gradients), each split one gathered to its full shape (a collective of
    the model group when ``model`` is sharded), then every pipe stage's
    encoder layers (``gather_stages``): ``tensors`` itself on one
    process."""
    mesh = getattr(model, "tp", None)
    specs = split_params(model)
    names = [k for k in tensors if k in specs]
    if mesh is not None and names:
        full = _gather_flat([tensors[k].detach() for k in names],
                            [specs[k] for k in names], mesh)
        tensors = {**tensors, **dict(zip(names, full))}
    return gather_stages(model, tensors)


def gather_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The one-process ``state_dict`` of a model sharded by
    ``shard_model`` (a collective of the model group; the state dict
    itself when it is not sharded)."""
    return gather_tensors(model, model.state_dict())


def load_full_state(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """A one-process state dict into ``model``, this peer's slice of each
    split parameter and this pipe stage's encoder layers
    (``load_state_dict``, strict)."""
    if _pipeline(model) is not None:
        own = model.state_dict().keys()
        sd = {k: v for k, v in sd.items() if not stage_held(k) or k in own}
    mesh = getattr(model, "tp", None)
    if mesh is not None:
        specs = split_params(model)
        sd = {k: (local_slice(v, specs[k], mesh.model, mesh.model_index)
                  if k in specs else v) for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)


def _optimizer_splits(model: nn.Module, optimizer) -> Dict[int, Split]:
    """The state-dict index of each split parameter of ``optimizer`` (its
    parameters in group order) -> its split."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: p.tp_split for i, p in enumerate(params)
            if getattr(p, "tp_split", None) is not None}


def _optimizer_names(model: nn.Module, optimizer) -> List[List[str]]:
    """The parameter names of each of ``optimizer``'s groups."""
    name_of = {id(p): k for k, p in model.named_parameters()}
    return [[name_of[id(p)] for p in g["params"]]
            for g in optimizer.param_groups]


def _gather_stage_states(model: nn.Module, optimizer, sd: dict) -> dict:
    """``sd`` (this stage's state dict of ``optimizer``) with every pipe
    stage's encoder layers and their AdamW moments, indexed in the
    one-process order (a collective of the pipe group); ``sd`` itself
    without a pipeline."""
    tr = _pipeline(model)
    if tr is None:
        return sd
    groups = _optimizer_names(model, optimizer)
    local = [k for g in groups for k in g]
    full_groups = [_full_names(tr, g) for g in groups]
    index = {k: i for i, k in enumerate(k for g in full_groups for k in g)}
    held = {local[i]: st for i, st in sd["state"].items()
            if stage_held(local[i])}
    moments = gather_stages(model, {f"{k}{m}": st[m] for k, st in
                                    held.items() for m in MOMENTS})
    state = {index[local[i]]: st for i, st in sd["state"].items()
             if not stage_held(local[i])}
    if held:
        # every stage takes its steps together: one stage's step counts
        # are every stage's
        other = next(iter(held.values()))
        for k in index:
            if stage_held(k):
                state[index[k]] = {**other, **{m: moments[f"{k}{m}"]
                                               for m in MOMENTS}}
    return {"state": dict(sorted(state.items())),
            "param_groups": [{**g, "params": [index[k] for k in fg]}
                             for g, fg in zip(sd["param_groups"],
                                              full_groups)]}


def _keep_stage_states(model: nn.Module, optimizer, sd: dict) -> dict:
    """A one-process optimizer state dict indexed for this pipe stage's
    parameters, the other stages' encoder layers left out; ``sd`` itself
    without a pipeline."""
    tr = _pipeline(model)
    if tr is None:
        return sd
    groups = _optimizer_names(model, optimizer)
    index = {k: i for i, k in enumerate(k for g in groups for k in g)}
    full = [k for g in groups for k in _full_names(tr, g)]
    return {"state": {index[full[int(i)]]: st for i, st in sd["state"].items()
                      if full[int(i)] in index},
            "param_groups": [{**g, "params": [index[k] for k in lg]}
                             for g, lg in zip(sd["param_groups"], groups)]}


def gather_optimizer_state(model: nn.Module, optimizer) -> dict:
    """``optimizer.state_dict()`` with the AdamW moments of the split
    parameters gathered to their full shapes, then every pipe stage's
    encoder layers': the one-process layout (collectives of the model and
    the pipe group when ``model`` is sharded or pipelined)."""
    sd = optimizer.state_dict()
    mesh = getattr(model, "tp", None)
    splits = _optimizer_splits(model, optimizer)
    held = [i for i in sorted(splits) if i in sd["state"]]
    if mesh is None or not held:
        return _gather_stage_states(model, optimizer, sd)
    full = iter(_gather_flat([sd["state"][i][k] for i in held
                              for k in MOMENTS],
                             [splits[i] for i in held for _ in MOMENTS],
                             mesh))
    state = dict(sd["state"])
    for i in held:
        state[i] = {**state[i], **{k: next(full) for k in MOMENTS}}
    return _gather_stage_states(model, optimizer, {**sd, "state": state})


def shard_optimizer_state(model: nn.Module, optimizer, sd: dict) -> dict:
    """A one-process optimizer state dict with this pipe stage's
    parameters alone and this peer's slices of the split parameters'
    moments, for ``optimizer.load_state_dict``."""
    sd = _keep_stage_states(model, optimizer, sd)
    mesh = getattr(model, "tp", None)
    if mesh is None:
        return sd
    splits = _optimizer_splits(model, optimizer)
    state = {}
    for i, st in sd["state"].items():
        split = splits.get(int(i))
        state[i] = st if split is None else {
            k: (local_slice(v, split, mesh.model, mesh.model_index).clone()
                if k in MOMENTS else v) for k, v in st.items()}
    return {**sd, "state": state}
