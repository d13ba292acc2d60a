"""Data parallelism over ``torch.distributed``: the port's counterpart of
``tubelet_transformer_tpu/parallel/mesh.py`` for ``MESH.DATA``.

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
world size.

Device tensors travel over the default process group (NCCL, or gloo, which
carries ``all_reduce`` and ``broadcast`` of CUDA tensors); host data (eval
detections, the stop flag, the run stamp, the resume path) over a CPU gloo
group that ``init_distributed`` creates beside it. Like torch's default
group, that group is process-wide state, held here until ``shutdown``.
Without torchrun's environment nothing is initialised and every function
below is the single-process identity.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# the backend when none is named: NCCL for CUDA tensors and gloo for CPU
# tensors on the card, gloo on the CPU
DEFAULT_BACKEND = {"cuda": "cuda:nccl,cpu:gloo", "cpu": "gloo"}
TIMEOUT = timedelta(minutes=10)

# the CPU gloo group of this process, once init_distributed has run
_HOST_GROUP: Optional[dist.ProcessGroup] = None


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
    torchrun's environment. Prints the backend, world size, rank and device
    of this process."""
    global _HOST_GROUP
    env = launch_env()
    if env is None:
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
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks of a device tensor; the gradient of each rank's input
    is the sum over ranks of the gradients of the outputs, since every
    rank's output feeds that rank's share of the loss."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over ranks of a device tensor, differentiable (a new tensor;
    ``t`` itself when no process group is joined)."""
    return _AllReduceSum.apply(t) if dist.is_initialized() else t


@dataclass(frozen=True)
class Mesh:
    """The 'data' axis: ``data`` ranks of equal shards, this process being
    ``rank``. With ``data`` 1 every reduction is the identity. The three
    methods are the three roles a reduction plays in the train step."""

    data: int = 1
    rank: int = 0

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean over ranks of a batch statistic (BN's mean and E[x^2])."""
        return t if self.data == 1 else all_reduce_sum(t) / self.data

    def count_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over ranks of a loss normaliser."""
        return t if self.data == 1 else all_reduce_sum(t)

    def share_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over ranks of the ranks' shares of the loss, or of their
        gradients: the global value."""
        return t if self.data == 1 else all_reduce_sum(t)


def create_mesh(data: int = -1, model: int = 1, pipe: int = 1) -> Mesh:
    """The mesh of ``MESH.DATA`` x ``MESH.MODEL`` x ``MESH.PIPE`` over the
    processes: ``data`` -1 takes them all. Raises NotImplementedError for a
    'model' or 'pipe' axis (not ported) and ValueError when the product is
    not the number of processes, as the JAX package does."""
    if model > 1:
        raise NotImplementedError("MESH.MODEL > 1 is not ported yet")
    if pipe > 1:
        raise NotImplementedError("MESH.PIPE > 1 is not ported yet")
    n = process_count()
    if data == -1:
        data = n // (model * pipe)
    if data * model * pipe != n:
        raise ValueError(f"mesh {data}x{model}x{pipe} (MESH.DATA x MODEL x "
                         f"PIPE) != {n} processes")
    return Mesh(data=data, rank=process_index())


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier(group=_HOST_GROUP)


def _all_gather_objects(obj) -> list:
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=_HOST_GROUP)
    return out


def all_gather_host(x) -> np.ndarray:
    """A per-process numpy array of the same shape on every process,
    stacked on a new leading axis in rank order; ``x`` itself without a
    process group."""
    if not dist.is_initialized():
        return x
    return np.stack(_all_gather_objects(np.asarray(x)))


def gather_global_tree(tree: dict) -> dict:
    """Each rank's dict of numpy arrays (or CPU-copyable tensors), every
    array concatenated over ranks on its leading axis in rank order: the
    global batch, in ONE host collective."""
    local = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
             for k, v in tree.items()}
    if not dist.is_initialized():
        return local
    parts = _all_gather_objects(local)
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

