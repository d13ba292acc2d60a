"""Data, tensor and pipeline parallelism over ``torch.distributed``: the
port's counterpart of ``tubelet_transformer_tpu/parallel/mesh.py`` for
``MESH.DATA``, ``MESH.MODEL`` and ``MESH.PIPE``.

One process per rank, launched by ``python -m torch.distributed.run``
(torchrun), each with one device. Under GSPMD the JAX step on a batch
sharded over 'data' is the single-device step on the global batch; the
port gets there by hand:

* every train-mode BN statistic is the mean over ranks of each rank's
  float32 (mean, E[x^2]), taken before ``E[x^2] - E[x]^2`` and
  differentiated through the reduction (``Mesh.batch_mean``);
* each rank computes its additive share of the global loss, every
  normaliser (box counts, sums of class weights, element counts) summed
  over ranks before it divides (``Mesh.count_sum``);
* the gradients of the shares are summed over ranks
  (``Mesh.share_sum``), which gives the gradient of the global loss on
  every rank, so that clipping, the NaN guard and AdamW see the same
  values everywhere.

Shards are equal in size: the loaders pad each split to a multiple of the
number of shards.

The 'model' axis (``MESH.MODEL``, ``parallel/sharding_rules.py``): the
ranks are laid out as JAX's ``devices.reshape(data, model, pipe)``, so
global rank = (data index * model + model index) * pipe + pipe index, and
the model and pipe peers of a data shard are adjacent ranks. The model
peers hold the same data shard and split the
transformer's attention heads, FFN columns and MoE experts between them;
GSPMD's collectives are written here by hand as Megatron's two operators,
``Mesh.copy_to_model`` ("f": identity forward, the gradient summed over
the model peers) at the entry of a split region and
``Mesh.reduce_from_model`` ("g": the partial outputs summed forward,
identity backward) at its exit.
The three reductions above then run over the *data group* (the ranks of
one model and pipe index): over the world they would count each shard
``model * pipe`` times. ``create_mesh`` makes the data, model and pipe
groups (every rank makes every group, in one order) and keeps them for
the process.

The 'pipe' axis (``MESH.PIPE``, ``parallel/pipeline.py``): the pipe peers
of a (data, model) index hold the same data shard and run everything but
the transformer encoder alike; each holds L/P consecutive encoder layers,
and the encoder runs as a GPipe schedule over them. Its three hand-offs
are written here: ``Mesh.pipe_carry`` (JAX's ``ppermute`` to the next
stage: each stage's carry goes to the stage after it, and backward each
carry's gradient to the stage before), ``Mesh.reduce_from_pipe`` (the
last stage's rows, all-reduced forward over the pipe group, identity
backward: "g") and ``Mesh.copy_to_pipe`` (the encoder's inputs: identity
forward, their gradients summed over the pipe group backward: "f").

Spatial parallelism (``MESH.SPATIAL`` beside ``MESH.MODEL``, ``Mesh.spatial``):
the model peers of a data shard split the clip's H axis instead of running
the whole CSN trunk each. The clip's rows split into equal bands
(``own_rows``; MESH.MODEL must divide them, as JAX's ``device_put``
requires); after a conv or pool of stride s an output row belongs to the
peer that owns the input row at its stride (``Bands``), so a deeper band
may be short, uneven in parity, or empty. What GSPMD inserts for the JAX
package's H-sharded clips is written here by hand:

* ``Mesh.halo_exchange`` before each conv that reads its neighbours' rows:
  the rows above and below this peer's band, from whichever peers own
  them (a short or empty neighbour's too), nothing past the clip's
  border; backward, each halo row's gradient goes back to its owner and
  is added there;
* ``Mesh.batch_mean`` over the data x model ranks of this pipe stage:
  each rank's (E[x], E[x^2]) weighted by its own pixel count, since the
  bands need not be equal;
* ``Mesh.gather_height`` after the trunk: the full feature map on every
  peer, from which the tensor-parallel transformer runs as under
  ``MESH.MODEL``; backward, this peer's rows of the gradient;
* the trunk's parameter gradients, each peer's partial sum over its rows,
  summed over the model group (``trunk_sum``; the parameters are those of
  ``sharding_rules.spatial_partial``).

Each is an exchange over the model group by ``all_gather_into_tensor``,
which gloo and NCCL both carry for CUDA tensors (gloo's point-to-point
``send``/``recv`` takes CPU tensors alone).

Device tensors travel over the default process group (NCCL, or gloo, which
carries ``all_reduce``, ``broadcast`` and ``all_gather_into_tensor`` of
CUDA tensors); host data (eval detections, the stop flag, the run stamp,
the resume path) over a CPU gloo group that ``init_distributed`` creates
beside it. Like torch's default group, that group is process-wide state,
held here until ``shutdown``. Without torchrun's environment nothing is
initialised and every function below is the single-process identity.

Mesh serving (``serving.py``): rank 0 leads and every other rank follows.
Each step the leader sends a header of ints and a list of numpy arrays
(``broadcast_batch``), every rank runs its rows, and the rows of each data
shard come back to rank 0 (``gather_rows``). The CPU gloo group carries
the header and the arrays: the batch is host data on the leader (the
streams' frame windows), each rank uploads its own rows to its device,
and no device copy is made on the leader for ranks that may sit on other
cards. A follower waits for a step on the default group's store
(``receive_batch``), not inside a collective, so a server without traffic
for longer than the groups' TIMEOUT keeps its followers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

# the backend when none is named: NCCL for CUDA tensors and gloo for CPU
# tensors on the card, gloo on the CPU
DEFAULT_BACKEND = {"cuda": "cuda:nccl,cpu:gloo", "cpu": "gloo"}
TIMEOUT = timedelta(minutes=10)

# the CPU gloo group of this process, once init_distributed has run
_HOST_GROUP: Optional[dist.ProcessGroup] = None
# the data, model and pipe groups that create_mesh made, by their ranks
_GROUPS: dict = {}


def launch_env() -> Optional[tuple[int, int, int]]:
    """(rank, world size, local rank) from torchrun's environment, or None
    when the process was not launched by it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def default_device() -> torch.device:
    """``cuda:<LOCAL_RANK>`` (``cuda:0`` without torchrun)."""
    env = launch_env()
    return torch.device("cuda", env[2] if env else 0)


def init_distributed(device: torch.device | str,
                     backend: Optional[str] = None) -> None:
    """Join torchrun's process group with ``backend`` (``DEFAULT_BACKEND``
    for ``device``'s type when None), create the CPU gloo group for host
    data, and check both with one ``all_reduce`` each: a backend that
    cannot run here fails now, not at the first step. A no-op without
    torchrun's environment, and once this process has joined (several
    tools run in one launch, ``tools/mesh_checks.py``). Prints the
    backend, world size, rank and device of this process."""
    global _HOST_GROUP
    env = launch_env()
    if env is None or dist.is_initialized():
        return
    rank, world, _ = env
    device = torch.device(device)
    backend = backend or DEFAULT_BACKEND[device.type]
    if device.type == "cuda":
        if device.index is None or device.index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank}: device {device} does not exist "
                             f"({torch.cuda.device_count()} CUDA devices)")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    _HOST_GROUP = dist.new_group(backend="gloo", timeout=TIMEOUT)
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    host = torch.ones(1)
    dist.all_reduce(host, group=_HOST_GROUP)
    if probe.item() != world or host.item() != world:
        raise RuntimeError(f"rank {rank}: the probe all_reduce gave "
                           f"{probe.item()} and {host.item()}, not {world}")
    # one write, so that the ranks' lines do not interleave in a shared log
    print(f"distributed: backend {backend}, world {world}, rank {rank}, "
          f"device {device}\n", end="", flush=True)


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _HOST_GROUP, _serve_steps
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None
    _GROUPS.clear()
    _serve_steps = 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def data_shard(peers: int = 1) -> tuple[int, int]:
    """(this process's data shard, the number of data shards) when each
    shard is held by ``peers`` adjacent ranks (MESH.MODEL x MESH.PIPE:
    global rank = ``data_index * peers + ...``, ``Mesh``'s layout): the
    one place the loaders and validation's gather read the layout from."""
    return process_index() // peers, process_count() // peers


def _all_gather(t: torch.Tensor, n: int,
                group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """(n, *t.shape): every model peer's ``t`` in peer order, in one
    ``all_gather_into_tensor`` over ``group``."""
    t = t.contiguous()
    out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out.view(-1), t.view(-1), group=group)
    return out


def strided_row(row: int, stride: int) -> int:
    """The first output row at or after input row ``row`` of a conv or
    pool of ``stride``: ceil(row / stride)."""
    return -(-row // stride)


@dataclass(frozen=True)
class Bands:
    """Every model peer's rows of an H axis of ``height`` rows under
    MESH.SPATIAL: ``rows[i]`` = (first, count) of peer i, contiguous and in
    peer order. The clip splits into equal bands (``split``). After a conv
    or pool of stride s, output row o reads input rows centred on s * o,
    and belongs to the peer that owns that row (``strided``): a peer's
    output rows are then ceil(first / s) .. ceil((first + count) / s) - 1,
    so that a 3-row window reads at most one row past its peer's band on
    each side, and a band may come out short, of either parity, or
    empty."""

    height: int
    rows: tuple

    @staticmethod
    def split(height: int, n: int) -> "Bands":
        if height % n:
            raise ValueError(f"{height} rows do not split over MESH.MODEL "
                             f"{n}")
        h = height // n
        return Bands(height, tuple((i * h, h) for i in range(n)))

    def strided(self, stride: int) -> "Bands":
        if stride == 1:
            return self
        return Bands(strided_row(self.height, stride), tuple(
            (strided_row(a, stride),
             strided_row(a + c, stride) - strided_row(a, stride))
            for a, c in self.rows))

    def halo(self, step: int, reach: int) -> tuple:
        """(top, bottom): the most rows above and below its band that any
        peer's output rows of stride ``step`` read, output row o reading
        rows step * o - reach .. step * o + reach (the clip's padding rows
        among them); every peer exchanges that many."""
        top = bottom = 0
        for (a, h), (oa, oh) in zip(self.rows, self.strided(step).rows):
            if oh:
                top = max(top, a - (step * oa - reach))
                bottom = max(bottom,
                             step * (oa + oh - 1) + reach + 1 - (a + h))
        return top, bottom

    def owner(self, row: int) -> int:
        """The peer whose band holds global row ``row``."""
        return next(i for i, (a, c) in enumerate(self.rows)
                    if a <= row < a + c)


def _edge_rows(x: torch.Tensor, first: int, last: int) -> torch.Tensor:
    """x's first ``first`` rows and last ``last`` rows along H, each block
    zero-padded to its size where x is shorter (the first at its end, the
    last at its start)."""
    h = x.shape[2]
    top = F.pad(x[:, :, :first], (0, 0, 0, 0, 0, first - min(first, h)))
    bottom = F.pad(x[:, :, max(0, h - last):],
                   (0, 0, 0, 0, last - min(last, h), 0))
    return torch.cat([top, bottom], 2)


class _HaloExchange(torch.autograd.Function):
    """The H rows of a channels-last (B,T,h,W,C) tensor, this peer's band
    of ``bands``, with the ``top`` rows above it before them and the
    ``bottom`` rows below it after them, none past the clip's border: each
    peer sends its first ``bottom`` and last ``top`` rows to all, in one
    all-gather, and takes each halo row from its owner (a row within
    ``top`` of this band lies within its owner's last ``top`` rows, however
    short the bands between). Backward, each peer sends the gradients of
    its halo rows to all in one all-gather, and each owner adds those of
    its rows to its own."""

    @staticmethod
    def forward(ctx, x, top, bottom, index, bands, group):
        ctx.args = (top, bottom, index, bands, group)
        n, height = len(bands.rows), bands.height
        a, h = bands.rows[index]
        parts = _all_gather(_edge_rows(x, bottom, top), n, group)
        rows = []
        for r in range(max(0, a - top), a):
            j = bands.owner(r)
            p = bottom + top - (sum(bands.rows[j]) - r)
            rows.append(parts[j][:, :, p:p + 1])
        rows.append(x)
        for r in range(a + h, min(height, a + h + bottom)):
            j = bands.owner(r)
            p = r - bands.rows[j][0]
            rows.append(parts[j][:, :, p:p + 1])
        return torch.cat(rows, 2)

    @staticmethod
    def backward(ctx, grad):
        top, bottom, index, bands, group = ctx.args
        a, h = bands.rows[index]
        e = a + h
        t = a - max(0, a - top)
        b = min(bands.height, e + bottom) - e
        back = grad.new_zeros((*grad.shape[:2], top + bottom,
                               *grad.shape[3:]))
        back[:, :, top - t:top] = grad[:, :, :t]
        back[:, :, top:top + b] = grad[:, :, t + h:]
        parts = _all_gather(back, len(bands.rows), group)
        gx = grad[:, :, t:t + h].clone(memory_format=torch.contiguous_format)
        for q, (aq, hq) in enumerate(bands.rows):
            if q == index:
                continue
            # q's rows above its band, then its rows below, where they
            # are this peer's
            for lo, hi, p0 in ((max(a, aq - top), min(e, aq), aq - top),
                               (max(a, aq + hq), min(e, aq + hq + bottom),
                                aq + hq - top)):
                if lo < hi:
                    gx[:, :, lo - a:hi - a] += parts[q][:, :, lo - p0:hi - p0]
        return gx, None, None, None, None, None


class _GatherHeight(torch.autograd.Function):
    """The model peers' (B,T,h,W,C) row bands of ``bands``, concatenated
    along H in peer order: one all-gather of the bands padded to the
    longest, each then cut to its own rows. Backward, this peer's band of
    the gradient alone. That is the whole gradient only because the
    gradient that reaches the gathered tensor is the same on every peer:
    every peer computes the same loss from it, and where it enters a split
    region "f" (``_CopyToModel``) has summed the peers' partial gradients.
    Summing over the peers here would count it ``model`` times."""

    @staticmethod
    def forward(ctx, x, index, bands, group):
        ctx.band = bands.rows[index]
        most = max(c for _, c in bands.rows)
        parts = _all_gather(F.pad(x, (0, 0, 0, 0, 0, most - x.shape[2])),
                            len(bands.rows), group)
        return torch.cat([parts[j][:, :, :c]
                          for j, (_, c) in enumerate(bands.rows)], 2)

    @staticmethod
    def backward(ctx, grad):
        a, h = ctx.band
        return grad[:, :, a:a + h].contiguous(), None, None, None


class _GatherFromModel(torch.autograd.Function):
    """The model peers' last-axis column blocks of ``widths`` (this peer's
    ``t``, padded to the widest for the one all-gather), concatenated in
    peer order; backward, this peer's columns of the gradient (every peer
    computes the same loss from the gathered tensor)."""

    @staticmethod
    def forward(ctx, t, index, widths, group):
        ctx.cols = (sum(widths[:index]), widths[index])
        parts = _all_gather(F.pad(t, (0, max(widths) - t.shape[-1])),
                            len(widths), group)
        return torch.cat([parts[j][..., :w] for j, w in enumerate(widths)],
                         -1)

    @staticmethod
    def backward(ctx, grad):
        a, w = ctx.cols
        return grad[..., a:a + w].contiguous(), None, None, None


class _ScatterToModel(torch.autograd.Function):
    """This peer's block of the last axis of a replicated tensor, cut in
    ``n`` equal blocks; backward, the peers' gradients of their blocks
    all-gathered into the whole tensor's (each peer's block enters its own
    slice of a split region, so the gradient of block j is on peer j
    alone)."""

    @staticmethod
    def forward(ctx, t, index, n, group):
        ctx.args = (n, group)
        w = t.shape[-1] // n
        return t[..., index * w:(index + 1) * w].contiguous()

    @staticmethod
    def backward(ctx, grad):
        n, group = ctx.args
        parts = _all_gather(grad, n, group)
        return torch.cat(parts.unbind(), -1), None, None, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks of a device tensor; the gradient of each
    rank's input is the sum over the ranks of the gradients of the outputs,
    since every rank's output feeds that rank's share of the loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Sum over ``group``'s ranks (the world by default) of a device
    tensor, differentiable (a new tensor; ``t`` itself when no process
    group is joined)."""
    return _AllReduceSum.apply(t, group) if dist.is_initialized() else t


class _CopyToModel(torch.autograd.Function):
    """Megatron's "f": the identity forward; backward, the sum over the
    model peers of their gradients, each a partial one from its own split
    of the region the tensor enters."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's "g": the sum over the model peers of their partial
    outputs; backward, the identity, since every peer computes the whole
    loss from the sum (``_AllReduceSum``'s backward would count each
    gradient ``model`` times)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _PipeCarry(torch.autograd.Function):
    """JAX's ``ppermute`` to the next stage: each stage's tensor to the
    stage after it, in one all-gather over the pipe group; stage 0 gets
    zeros (no stage before it). Backward, each stage's gradient goes back
    to the stage before it in one all-gather (the last stage's input gets
    zeros). Every stage runs both, on every tick."""

    @staticmethod
    def forward(ctx, x, index, n, group):
        ctx.args = (index, n, group)
        parts = _all_gather(x, n, group)
        return parts[index - 1] if index > 0 else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, grad):
        index, n, group = ctx.args
        parts = _all_gather(grad, n, group)
        return (parts[index + 1] if index < n - 1
                else torch.zeros_like(grad)), None, None, None


def _group(ranks: tuple) -> Optional[dist.ProcessGroup]:
    """The group of ``ranks`` that ``create_mesh`` made; None (the default
    group) for the whole world."""
    if len(ranks) == process_count():
        return None
    if ranks not in _GROUPS:
        raise RuntimeError(f"no process group of ranks {ranks}: build the "
                           "mesh with create_mesh")
    return _GROUPS[ranks]


@dataclass(frozen=True)
class Mesh:
    """The ('data', 'model', 'pipe') axes: ``data`` shards of equal size,
    each held by ``model`` x ``pipe`` peers; this process is global
    ``rank`` = ``(data_index * model + model_index) * pipe + pipe_index``.
    With ``data`` 1 every data reduction is the identity, with ``model`` 1
    every model operator, with ``pipe`` 1 every pipe hand-off. The first
    three methods are the three roles a reduction over the data group
    plays in the train step, the next two Megatron's operators over the
    model group, then spatial parallelism's (``spatial``: the model peers
    split the clip's rows through the trunk), then the pipeline's."""

    data: int = 1
    rank: int = 0
    model: int = 1
    # MESH.SPATIAL: the model peers split the clip's rows through the
    # trunk; a no-op at one model peer, where it reads False
    spatial: bool = False
    # MESH.PIPE: the encoder's layers as stages over the pipe peers
    pipe: int = 1

    def __post_init__(self):
        if self.model == 1:
            object.__setattr__(self, "spatial", False)

    @property
    def data_index(self) -> int:
        return self.rank // (self.model * self.pipe)

    @property
    def model_index(self) -> int:
        return self.rank // self.pipe % self.model

    @property
    def pipe_index(self) -> int:
        return self.rank % self.pipe

    def _rank(self, d: int, m: int, p: int) -> int:
        return (d * self.model + m) * self.pipe + p

    @property
    def data_group(self) -> Optional[dist.ProcessGroup]:
        """The ranks of this model and pipe index, one per data shard."""
        m, p = self.model_index, self.pipe_index
        return _group(tuple(self._rank(d, m, p) for d in range(self.data)))

    @property
    def model_group(self) -> Optional[dist.ProcessGroup]:
        """The model peers of this data shard and pipe stage."""
        d, p = self.data_index, self.pipe_index
        return _group(tuple(self._rank(d, m, p) for m in range(self.model)))

    @property
    def pipe_group(self) -> Optional[dist.ProcessGroup]:
        """The pipe stages of this data shard and model index."""
        d, m = self.data_index, self.model_index
        return _group(tuple(self._rank(d, m, p) for p in range(self.pipe)))

    @property
    def spatial_group(self) -> Optional[dist.ProcessGroup]:
        """The data x model ranks of this pipe stage: the ranks that hold
        a piece of the global batch's pixels each when the rows split."""
        p = self.pipe_index
        return _group(tuple(self._rank(d, m, p) for d in range(self.data)
                            for m in range(self.model)))

    def batch_mean(self, t: torch.Tensor, count: int = 1) -> torch.Tensor:
        """Mean over the data shards of a batch statistic (BN's mean and
        E[x^2]); with the rows split, over the data x model ranks of this
        pipe stage (every stage runs the trunk on the same shard: over the
        world each pixel would count ``pipe`` times), each rank's ``t``
        weighted by its ``count`` of pixels, since the bands need not be
        equal (an empty band's weighs nothing)."""
        if self.spatial:
            w = all_reduce_sum(torch.cat([t.reshape(-1) * count,
                                          t.new_full((1,), count)]),
                               self.spatial_group)
            return (w[:-1] / w[-1]).view_as(t)
        return (t if self.data == 1
                else all_reduce_sum(t, self.data_group) / self.data)

    def count_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the data shards of a loss normaliser."""
        return t if self.data == 1 else all_reduce_sum(t, self.data_group)

    def share_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the data shards of their shares of the loss, or of
        their gradients: the global value."""
        return t if self.data == 1 else all_reduce_sum(t, self.data_group)

    def copy_to_model(self, t: torch.Tensor) -> torch.Tensor:
        """A replicated tensor entering a split region ("f")."""
        return (t if self.model == 1
                else _CopyToModel.apply(t, self.model_group))

    def reduce_from_model(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of the model peers' partial outputs leaving a split
        region ("g")."""
        return (t if self.model == 1
                else _ReduceFromModel.apply(t, self.model_group))

    def gather_from_model(self, t: torch.Tensor, widths: Sequence[int]
                          ) -> torch.Tensor:
        """The model peers' last-axis blocks, of ``widths`` in peer order
        (this peer's is ``t``), as one tensor on every peer ("gather":
        backward, this peer's block of the gradient)."""
        return _GatherFromModel.apply(t, self.model_index, tuple(widths),
                                      self.model_group)

    def scatter_to_model(self, t: torch.Tensor) -> torch.Tensor:
        """This peer's block of the last axis of a replicated ``t``, cut in
        ``model`` equal blocks ("scatter": backward, the peers' gradients
        of their blocks all-gathered)."""
        return _ScatterToModel.apply(t, self.model_index, self.model,
                                     self.model_group)

    def own_rows(self, height: int) -> tuple[int, int]:
        """(first, count): this peer's rows of the clip's ``height`` with
        the rows split (all of them otherwise); ValueError unless they
        split evenly."""
        if not self.spatial:
            return 0, height
        return Bands.split(height, self.model).rows[self.model_index]

    def halo_exchange(self, x: torch.Tensor, top: int, bottom: int,
                      bands: Bands) -> torch.Tensor:
        """Channels-last (B,T,h,W,C) x, this peer's band of ``bands``, with
        the ``top`` rows above it before them and the ``bottom`` rows below
        after them, from whichever peers own them, none past the clip's
        border (differentiable; x itself with the rows not split). Every
        peer passes the same ``top`` and ``bottom``."""
        if not self.spatial or top == bottom == 0:
            return x
        return _HaloExchange.apply(x, top, bottom, self.model_index, bands,
                                   self.model_group)

    def gather_height(self, x: torch.Tensor, bands: Bands) -> torch.Tensor:
        """The model peers' (B,T,h,W,C) bands of ``bands`` as the full
        (B,T,height,W,C) tensor (differentiable; x itself with the rows
        not split)."""
        if not self.spatial:
            return x
        return _GatherHeight.apply(x, self.model_index, bands,
                                   self.model_group)

    def trunk_sum(self, grads: List[torch.Tensor]) -> None:
        """Sum, in place, the model peers' partial gradients of the
        trunk's parameters (each peer's over its own rows), in one
        all-reduce of the model group; nothing with the rows not split."""
        if not self.spatial or not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.model_group)
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in grads]), grads)])

    def pipe_carry(self, x: torch.Tensor) -> torch.Tensor:
        """The stage before this one's ``x`` (zeros on stage 0): JAX's
        ``ppermute`` to the next stage, differentiable; every stage calls
        it on every tick."""
        return _PipeCarry.apply(x, self.pipe_index, self.pipe,
                                self.pipe_group)

    def copy_to_pipe(self, t: torch.Tensor) -> torch.Tensor:
        """An input of the pipelined encoder ("f"): the identity forward;
        backward, its gradient summed over the pipe stages (stage 0's,
        the others' zero)."""
        return (t if self.pipe == 1
                else _CopyToModel.apply(t, self.pipe_group))

    def reduce_from_pipe(self, t: torch.Tensor) -> torch.Tensor:
        """The pipelined encoder's output ("g"): the sum over the stages
        of ``t`` (the last stage's rows, zeros on the others), identity
        backward."""
        return (t if self.pipe == 1
                else _ReduceFromModel.apply(t, self.pipe_group))


def _make_groups(data: int, model: int, pipe: int,
                 spatial: bool = False) -> None:
    """Every data group, then every model group, then every pipe group of
    a data x model x pipe mesh that has more than one rank and is not the
    world, then with ``spatial`` the data x model ranks of each pipe
    stage (``Mesh.spatial_group``), made once per process; every rank
    makes them all, in one order, as ``dist.new_group`` requires."""
    world = data * model * pipe
    axes = ((data, lambda i, j, k: (k * model + i) * pipe + j, model, pipe),
            (model, lambda i, j, k: (i * model + k) * pipe + j, data, pipe),
            (pipe, lambda i, j, k: (i * model + j) * pipe + k, data, model))
    groups = [tuple(rank(i, j, k) for k in range(size))
              for size, rank, n_i, n_j in axes
              if size not in (1, world)
              for i in range(n_i) for j in range(n_j)]
    if spatial and model > 1 and pipe > 1:
        groups += [tuple((d * model + m) * pipe + p for d in range(data)
                         for m in range(model)) for p in range(pipe)]
    for ranks in groups:
        if ranks not in _GROUPS:
            _GROUPS[ranks] = dist.new_group(list(ranks), timeout=TIMEOUT)


def create_mesh(data: int = -1, model: int = 1, pipe: int = 1,
                spatial: bool = False) -> Mesh:
    """The mesh of ``MESH.DATA`` x ``MESH.MODEL`` x ``MESH.PIPE`` over the
    processes: ``data`` -1 takes what ``model`` and ``pipe`` leave. Raises
    ValueError when the product is not the number of processes, as the
    JAX package does. Makes the groups of every axis that is neither one
    rank nor the world (a collective call: every rank makes the same
    mesh). ``spatial`` (MESH.SPATIAL): the model peers split the clip's
    rows; a no-op at ``model`` 1, as in JAX."""
    n = process_count()
    if data == -1:
        data = n // (model * pipe)
    if data < 1 or model < 1 or pipe < 1 or data * model * pipe != n:
        raise ValueError(f"mesh {data}x{model}x{pipe} (MESH.DATA x MODEL x "
                         f"PIPE) != {n} processes")
    _make_groups(data, model, pipe, spatial)
    return Mesh(data=data, rank=process_index(), model=model,
                spatial=spatial, pipe=pipe)


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier(group=_HOST_GROUP)


def all_gather_objects(obj) -> list:
    """Every process's picklable ``obj``, in rank order (``[obj]`` without
    a process group)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=_HOST_GROUP)
    return out


def all_gather_host(x) -> np.ndarray:
    """A per-process numpy array of the same shape on every process,
    stacked on a new leading axis in rank order; ``x`` itself without a
    process group."""
    if not dist.is_initialized():
        return x
    return np.stack(all_gather_objects(np.asarray(x)))


def gather_global_tree(tree: dict, peers: int = 1) -> dict:
    """Each data shard's dict of numpy arrays (or CPU-copyable tensors),
    every array concatenated over the shards on its leading axis in shard
    order: the global batch, in ONE host collective. With ``peers`` ranks
    a shard (MESH.MODEL x MESH.PIPE), which hold the same shard, each
    shard is taken once, from its first rank (``data_shard``'s layout)."""
    local = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
             for k, v in tree.items()}
    if not dist.is_initialized():
        return local
    parts = all_gather_objects(local)
    parts = [parts[d * peers] for d in range(data_shard(peers)[1])]
    return {k: np.concatenate([p[k] for p in parts]) for k in local}


def gather_global(x) -> np.ndarray:
    """``gather_global_tree`` of one array."""
    return gather_global_tree({"x": x})["x"]


def broadcast_string(s: str) -> str:
    """Rank 0's string on every process: one run directory, one resume
    checkpoint (independent directory listings on a shared file system can
    disagree, and ranks that resume different epochs deadlock)."""
    if not dist.is_initialized():
        return s
    box = [s]
    dist.broadcast_object_list(box, src=0, group=_HOST_GROUP)
    return box[0]


def any_process(flag: bool) -> bool:
    """True on every process when ``flag`` is true on any: the stop
    decision at an epoch boundary."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


# -- mesh serving: the leader's batch out, each data shard's rows back ------

# a follower's wait for the next step, renewed for as long as it idles
SERVE_POLL = timedelta(hours=1)
_SERVE_WORDS = 64                     # int64 words of a step's header
_SERVE_DTYPES = (np.dtype(np.uint8), np.dtype(np.bool_),
                 np.dtype(np.float32))
# the steps this process has sent or read: like the host group,
# process-wide state of the process group, zeroed by shutdown
_serve_steps = 0


def _serve_key(step: int) -> str:
    return f"tuber_serve/{step}"


def _rows(a: np.ndarray, mesh: Mesh, rank: int) -> np.ndarray:
    """The rows of ``rank``'s data shard of ``a`` (equal blocks of its
    leading axis, one a shard)."""
    b = a.shape[0] // mesh.data
    d = rank // (mesh.model * mesh.pipe)
    return a[d * b:(d + 1) * b]


def _as_bytes(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a``'s memory; bool as uint8."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.uint8) if a.dtype == np.bool_ else a)


def _move(a: Optional[np.ndarray], shape: tuple, dtype: np.dtype,
          mesh: Mesh, split: bool) -> np.ndarray:
    """One array from the leader (``a``, None on a follower) to every rank
    over the host group: the whole array by broadcast, or with ``split``
    each data shard's rows by scatter. Returns this rank's part."""
    if not split:
        out = np.empty(shape, dtype) if a is None else np.ascontiguousarray(a)
        dist.broadcast(_as_bytes(out), src=0, group=_HOST_GROUP)
        return out
    out = np.empty((shape[0] // mesh.data, *shape[1:]), dtype)
    parts = (None if a is None else [_as_bytes(_rows(a, mesh, r))
                                     for r in range(process_count())])
    dist.scatter(_as_bytes(out), parts, src=0, group=_HOST_GROUP)
    return out


def broadcast_batch(header: Sequence[int], arrays: Sequence[np.ndarray],
                    mesh: Mesh, split: bool = False) -> List[np.ndarray]:
    """Rank 0, the leader: one step to every rank. The step is announced
    on the store, then ``header`` (small ints the caller reads back from
    ``receive_batch``) and the arrays' dtypes and shapes go out in one
    broadcast, then the arrays (uint8, bool or float32): whole to every
    rank, or with ``split`` (their leading axis divisible by
    ``mesh.data``) each data shard's rows alone to its ranks. Returns
    rank 0's part of each array."""
    global _serve_steps
    words = [len(header), *header, int(split), len(arrays)]
    for a in arrays:
        words += [_SERVE_DTYPES.index(a.dtype), a.ndim, *a.shape]
    if len(words) > _SERVE_WORDS:
        raise ValueError(f"a serving header of {len(words)} words: "
                         f"{_SERVE_WORDS} at most")
    _serve_steps += 1
    dist.distributed_c10d._get_default_store().set(
        _serve_key(_serve_steps), "1")
    head = torch.zeros(_SERVE_WORDS, dtype=torch.int64)
    head[:len(words)] = torch.tensor(words)
    dist.broadcast(head, src=0, group=_HOST_GROUP)
    return [_move(a, a.shape, a.dtype, mesh, split) for a in arrays]


def receive_batch(mesh: Mesh) -> tuple[List[int], List[np.ndarray], bool]:
    """A follower: the next step of ``broadcast_batch``, as (its header,
    this rank's part of each array, whether the arrays were split over the
    data shards). The wait for it is a wait on the default group's store,
    renewed every SERVE_POLL for as long as the leader idles: inside a
    collective it would end at the groups' TIMEOUT. The last follower to
    see a step removes its key."""
    global _serve_steps
    _serve_steps += 1
    key = _serve_key(_serve_steps)
    store = dist.distributed_c10d._get_default_store()
    while True:
        try:
            store.wait([key], SERVE_POLL)
            break
        except dist.DistStoreError:     # timed out, not lost: wait on
            continue
    if store.add(f"{key}/seen", 1) == process_count() - 1:
        store.delete_key(key)
        store.delete_key(f"{key}/seen")
    head = torch.empty(_SERVE_WORDS, dtype=torch.int64)
    dist.broadcast(head, src=0, group=_HOST_GROUP)
    words = head.tolist()
    n = words[0]
    header, split, count = words[1:1 + n], bool(words[1 + n]), words[2 + n]
    pos, arrays = 3 + n, []
    for _ in range(count):
        dtype, ndim = _SERVE_DTYPES[words[pos]], words[pos + 1]
        shape = tuple(words[pos + 2:pos + 2 + ndim])
        pos += 2 + ndim
        arrays.append(_move(None, shape, dtype, mesh, split))
    return header, arrays, split


def gather_rows(arrays: Sequence[np.ndarray], mesh: Mesh
                ) -> Optional[List[np.ndarray]]:
    """After a split step: each data shard's float32 ``arrays`` (their
    rows of the step's batch) to rank 0, from the shard's model index 0
    over the data group of that index, in ONE gather. Rank 0 gets each
    array concatenated over the shards on its leading axis, in shard
    order; the other ranks get None."""
    if mesh.model_index != 0:
        return None
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a, np.float32).reshape(-1) for a in arrays]))
    parts = ([torch.empty_like(flat) for _ in range(mesh.data)]
             if mesh.rank == 0 else None)
    dist.gather(flat, parts, dst=0, group=mesh.data_group)
    if parts is None:
        return None
    out, pos = [], 0
    for a in arrays:
        out.append(np.concatenate([p[pos:pos + a.size].numpy().reshape(
            a.shape) for p in parts]))
        pos += a.size
    return out
