"""ZeRO stage 1 (``MESH.ZERO1``): the AdamW moments sharded over 'data'.

The port's counterpart of the ``zero1`` branch of
``tubelet_transformer_tpu/parallel/sharding_rules.py:state_shardings``
(no JAX module carries this name). There the gradients arrive replicated,
after the data all-reduce; each of the n 'data' shards owns 1/n of the
``mu``/``nu`` of every replicated parameter, along the largest axis that n
divides (the lower axis on a tie), and updates it shard-locally; a
parameter with no such axis keeps replicated moments, and a parameter
split over 'model' (``MESH.MODEL``) or held by one 'pipe' stage
(``MESH.PIPE``: the encoder's layers) keeps its moments in the
parameter's layout; one all-gather returns the updated parameters to
every rank.

``ZeroAdamW`` does the same by hand: a ``torch.optim.AdamW`` with the
groups and hyperparameters of ``train/optimizer.py:build_optimizer`` runs
over leaf tensors that hold this rank's slices (``narrow(axis, d * k,
k)`` for data index d) of the sharded parameters, and over the unsharded
parameters themselves (those split over 'model' among them), which every
rank of a data group updates alike. ``step`` copies the slices of
the parameters as they are (so that a load between steps holds) and of
the summed, clipped gradients into the leaves and their ``.grad``, steps, packs
every owned slice into one flat buffer and makes ONE
``all_gather_into_tensor`` over the data group (the ranks of this model
and pipe index, the whole world without those axes; NCCL, or gloo, which
carries it for CUDA tensors), then unpacks the data shards' slices into
the parameters. The inner AdamW is fused, so that a step skips on a flag
on the device (``train/optimizer.py:skip_unless``): the slices then stay
as they were, and the all-gather returns every parameter unchanged.

The axis sizes of a port tensor are a permutation of its JAX leaf's
(torch's (out, in) against flax's (in, out), and so on), so the same
parameters shard and each rank holds the same bytes of moments as a JAX
device; the JAX chain also keeps moments of frozen parameters, which the
port's optimizer has none of.

``state_dict`` is a collective: it gathers the full moments into exactly
the layout of ``torch.optim.AdamW.state_dict()`` over the full parameters,
and ``load_state_dict`` takes that layout and keeps this rank's slices, so
a checkpoint is the same file with ZeRO-1 or without, and resumes at any
world size with ZeRO-1 on or off. Under ``MESH.MODEL`` the moments of
the split parameters stay the peer's slices here:
``parallel/sharding_rules.py:gather_optimizer_state`` gathers them over
the model group after this ``state_dict``, and ``shard_optimizer_state``
cuts them before this ``load_state_dict``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from tubelet_transformer_tpu_torch.parallel.mesh import Mesh

MOMENTS = ("exp_avg", "exp_avg_sq")


def shard_axis(shape: Sequence[int], n: int) -> Optional[int]:
    """The axis of a parameter of ``shape`` whose moments shard over ``n``
    ranks: the largest that ``n`` divides, the lower on a tie; None when
    ``n`` is 1, for a 0-d tensor, or when no axis divides."""
    if n <= 1:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % n == 0:
            return i
    return None


def data_axis(p: torch.Tensor, n: int) -> Optional[int]:
    """The axis of parameter ``p`` whose moments shard over ``n`` data
    shards: ``shard_axis`` of its shape, or None for a parameter split over
    'model' (``tp_split``) or held by one pipe stage (``pipe_stage``, an
    encoder layer under MESH.PIPE), whose moments keep the parameter's
    layout."""
    if (getattr(p, "tp_split", None) is not None
            or getattr(p, "pipe_stage", False)):
        return None
    return shard_axis(p.shape, n)


def predicted_moment_bytes(params: Iterable[torch.Tensor], n: int) -> int:
    """The bytes of one rank's two moments over ``params`` (this model
    peer's slices of the split ones) from their shapes: 1/n of each
    sharded parameter's, all of an unsharded one's."""
    total = 0
    for p in params:
        share = n if data_axis(p, n) is not None else 1
        total += 2 * p.numel() // share * p.element_size()
    return total


def moment_bytes(optimizer) -> int:
    """The bytes of this rank's AdamW moments, read from the tensors."""
    opt = getattr(optimizer, "inner", optimizer)
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for k, v in st.items() if k in MOMENTS)


def all_gather_flat(flat: torch.Tensor, n: int,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> torch.Tensor:
    """(n, len) of every rank's 1-d ``flat``, in rank order: one
    ``all_gather_into_tensor`` over ``group`` (of ``n`` ranks; the default
    group when None)."""
    out = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view(n, -1)


class ZeroAdamW:
    """AdamW over ``groups`` (``torch.optim.AdamW``'s group dicts) with the
    moments sharded over ``mesh``'s 'data' axis. ``param_groups`` holds the
    full parameters (this model peer's slices of the split ones) and the
    hyperparameters, as AdamW's does: the clip and the gradient all-reduce
    read the parameters there, the schedule writes each group's ``lr``."""

    def __init__(self, groups: List[dict], mesh: Mesh, **defaults):
        self.mesh = mesh
        n, d = mesh.data, mesh.data_index
        # (parameter, axis, this rank's slice) of every sharded parameter
        self.slots: list = []
        inner_groups = []
        for g in groups:
            leaves = []
            for p in g["params"]:
                axis = data_axis(p, n)
                if axis is None:
                    leaves.append(p)
                    continue
                k = p.shape[axis] // n
                leaf = p.detach().narrow(axis, d * k, k).clone()
                self.slots.append((p, axis, leaf))
                leaves.append(leaf)
            inner_groups.append({**g, "params": leaves})
        self.inner = torch.optim.AdamW(inner_groups, fused=True, **defaults)
        self.param_groups = [{**gi, "params": list(g["params"])}
                             for g, gi in zip(groups, self.inner.param_groups)]
        # the state dict's index of each sharded parameter -> its slot
        sharded = {id(s[2]): s for s in self.slots}
        leaves = [leaf for gi in self.inner.param_groups
                  for leaf in gi["params"]]
        self._slot_of = {i: sharded[id(leaf)] for i, leaf in enumerate(leaves)
                         if id(leaf) in sharded}

    def _sync_groups(self) -> None:
        """The hyperparameters of ``param_groups`` (the schedule's ``lr``)
        into the inner optimizer's groups."""
        for go, gi in zip(self.param_groups, self.inner.param_groups):
            gi.update({k: v for k, v in go.items() if k != "params"})

    def zero_grad(self, set_to_none: bool = True) -> None:
        for g in self.param_groups:
            for p in g["params"]:
                if p.grad is None:
                    continue
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.zero_()
        for _, _, leaf in self.slots:
            leaf.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """AdamW on this rank's slices (and the unsharded parameters), then
        one all-gather of the updated slices into every parameter."""
        self._sync_groups()
        for p, axis, leaf in self.slots:
            # the slice of the parameter as it is now (a checkpoint's load
            # writes the parameters), and of its gradient
            k = leaf.shape[axis]
            d = self.mesh.data_index
            leaf.copy_(p.narrow(axis, d * k, k))
            leaf.grad = None if p.grad is None else p.grad.narrow(
                axis, d * k, k).clone(
                    memory_format=torch.contiguous_format)
        self.inner.step()
        self.all_gather_params()

    def _gather(self, parts: List[torch.Tensor], slots: list
                ) -> List[torch.Tensor]:
        """The full tensors of ``parts`` (this rank's slices of ``slots``'
        parameters) from every data shard's, in one all-gather over the
        data group."""
        if not parts:
            return []
        n = self.mesh.data
        flat = torch.cat([t.reshape(-1) for t in parts])
        segs = all_gather_flat(flat, n, self.mesh.data_group).split([t.numel() for t in parts],
                                              dim=1)
        return [seg.reshape(n, *t.shape).movedim(0, axis).reshape(p.shape)
                for seg, t, (p, axis, _) in zip(segs, parts, slots)]

    @torch.no_grad()
    def all_gather_params(self) -> None:
        """Every rank's updated slices into the parameters."""
        full = self._gather([leaf for _, _, leaf in self.slots], self.slots)
        for (p, _, _), t in zip(self.slots, full):
            p.copy_(t)

    def state_dict(self) -> dict:
        """A collective: ``torch.optim.AdamW.state_dict()``'s layout over
        the full parameters, every moment gathered from the ranks."""
        self._sync_groups()
        sd = self.inner.state_dict()
        held = [i for i in sorted(self._slot_of) if i in sd["state"]]
        parts = [sd["state"][i][k] for i in held for k in MOMENTS]
        slots = [self._slot_of[i] for i in held for _ in MOMENTS]
        full = iter(self._gather(parts, slots))
        state = dict(sd["state"])
        for i in held:
            state[i] = {**state[i], **{k: next(full) for k in MOMENTS}}
        return {**sd, "state": state}

    def load_state_dict(self, sd: dict) -> None:
        """``torch.optim.AdamW.state_dict()``'s layout over the full
        parameters (this class's or AdamW's): this rank keeps its slices."""
        state = {}
        for i, st in sd["state"].items():
            slot = self._slot_of.get(int(i))
            if slot is not None:
                _, axis, leaf = slot
                k = leaf.shape[axis]
                d = self.mesh.data_index
                st = {key: (v.narrow(axis, d * k, k).clone()
                            if key in MOMENTS else v)
                      for key, v in st.items()}
            state[i] = st
        self.inner.load_state_dict({**sd, "state": state})
        for go, gi in zip(self.param_groups, self.inner.param_groups):
            go.update({k: v for k, v in gi.items() if k != "params"})
