"""Optimal assignment of the set matcher: the kernel of ``csrc/assign.cu``.

The counterpart of ``_solve_rect`` and ``solve_assignment`` of
``tubelet_transformer_tpu/ops/matcher.py``, the JAX package's on-device
solver (shortest augmenting paths with potentials), with the port's own
semantics: each problem's valid submatrix is solved exactly, as scipy's
``linear_sum_assignment`` solves it, in float64 potentials, transposed
when it has fewer valid columns than rows; non-finite costs become
+-``PAD_COST`` (NaN: +``PAD_COST``), so that a diverged step still gets a
valid assignment and then skips.

``assign(cost, valid)`` launches the kernel on a CUDA tensor, where no
part of the solve touches the host, and takes the plain PyTorch version
(``assign_reference``) on a CPU tensor. The plain version runs the same
algorithm batched over the problems with masks, as JAX's ``vmap`` does,
with the same arithmetic and tie rule (the lowest column), so the two
agree bit for bit; its loops end on conditions read on the host.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tubelet_transformer_tpu_torch.ops.cuda import build

# kernel launches in this process
LAUNCHES = 0

PAD_COST = 1.0e6
# the kernel's one thread per column
MAX_COLUMNS = 1024
_FN = None


def _kernel():
    """The kernel's entry point, its argument types set, once the library
    is loaded (``build.kernels``)."""
    global _FN
    if _FN is None:
        fn = build.kernels().tuber_assign
        # cost, valid, tgt_for_query, query_for_tgt; n, q, m; stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def sanitize(cost: torch.Tensor) -> torch.Tensor:
    """float32 costs with NaN at +PAD_COST and +-inf at +-PAD_COST."""
    return torch.nan_to_num(cost.float(), nan=PAD_COST, posinf=PAD_COST,
                            neginf=-PAD_COST)


def assign_reference(cost: torch.Tensor, valid: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on the inputs' device: cost
    (N, Q, M), valid (N, M) bool -> (tgt_for_query (N, Q), query_for_tgt
    (N, M)) int64, -1 where unmatched. Each problem's R rows (the queries,
    or its nv valid targets when nv < Q) get one of its C >= R columns;
    the rows are solved one after the other, every problem at once."""
    n, q, m = cost.shape
    dev = cost.device
    k = max(q, m, 1)
    valid = valid.bool()
    nv = valid.sum(1)
    flip = nv < q
    rows_n = torch.where(flip, nv, q)
    cols_n = torch.where(flip, q, nv)
    # the valid targets first, in order (a stable sort), padded to k
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    vcol = F.pad(order, (0, k - m))
    # solve-space matrix (N, k, k): row r, column c of each problem
    a = torch.zeros((n, k, k), dtype=torch.float64, device=dev)
    a[:, :q, :m] = sanitize(cost).gather(
        2, order[:, None, :].expand(n, q, m)).double()
    a = torch.where(flip[:, None, None], a.transpose(1, 2), a)

    cols = torch.arange(k + 1, device=dev)
    real = (cols >= 1) & (cols[None] <= cols_n[:, None])        # (N, k+1)
    u = torch.zeros((n, k + 1), dtype=torch.float64, device=dev)
    v = torch.zeros((n, k + 1), dtype=torch.float64, device=dev)
    p = torch.zeros((n, k + 1), dtype=torch.long, device=dev)
    way = torch.zeros((n, k + 1), dtype=torch.long, device=dev)

    def at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return x.gather(1, idx[:, None])[:, 0]

    for i in range(1, int(rows_n.max()) + 1 if n else 1):
        act = rows_n >= i
        p[:, 0] = torch.where(act, i, p[:, 0])
        minv = torch.full((n, k + 1), float("inf"), dtype=torch.float64,
                          device=dev)
        used = torch.zeros((n, k + 1), dtype=torch.bool, device=dev)
        j0 = torch.zeros(n, dtype=torch.long, device=dev)
        run = act.clone()
        # Dijkstra from row i: each pass marks one more column used and
        # stops at a free one, so within C + 1 passes
        for _ in range(k + 1):
            if not bool(run.any()):
                break
            used = used | ((cols[None] == j0[:, None]) & run[:, None])
            i0 = at(p, j0)
            ui0 = at(u, i0)
            row = a.gather(1, (i0 - 1).clamp(min=0)[:, None, None].expand(
                n, 1, k))[:, 0]
            cur = F.pad(row, (1, 0)) - ui0[:, None] - v
            free = real & ~used
            better = free & run[:, None] & (cur < minv)
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0[:, None], way)
            masked = torch.where(free, minv, float("inf"))
            j1 = masked.argmin(1)
            delta = torch.where(run, at(masked, j1), 0.0)
            hit = used & run[:, None]
            u.scatter_add_(1, torch.where(hit, p, 0),
                           torch.where(hit, delta[:, None], 0.0))
            v = torch.where(hit, v - delta[:, None], v)
            minv = torch.where(free & run[:, None], minv - delta[:, None],
                               minv)
            j0 = torch.where(run, j1, j0)
            run = run & (at(p, j0) != 0)
        # augment back to column 0: each used column once, C + 1 steps
        j0 = torch.where(act, j0, 0)
        for _ in range(k + 1):
            go = j0 != 0
            if not bool(go.any()):
                break
            j1 = at(way, j0)
            p = p.scatter(1, j0[:, None],
                          torch.where(go, at(p, j1), at(p, j0))[:, None])
            j0 = torch.where(go, j1, 0)

    # column c (0-indexed) holds solve row r; map both to (query, target)
    r = p[:, 1:] - 1                                              # (N, k)
    c = cols[None, :k].expand(n, k)
    has = r >= 0
    rr = r.clamp(min=0)
    query = torch.where(flip[:, None], c, rr)
    target = torch.where(flip[:, None], vcol.gather(1, rr), vcol[:, :k])
    tfq = torch.full((n, q + 1), -1, dtype=torch.long, device=dev)
    qft = torch.full((n, m + 1), -1, dtype=torch.long, device=dev)
    tfq.scatter_(1, torch.where(has, query, q), torch.where(has, target, -1))
    qft.scatter_(1, torch.where(has, target, m), torch.where(has, query, -1))
    return tfq[:, :q].contiguous(), qft[:, :m].contiguous()


def check_inputs(cost: torch.Tensor, valid: torch.Tensor) -> None:
    """Raise ValueError unless the kernel takes these tensors as they
    are."""
    if cost.dim() != 3 or cost.dtype != torch.float32:
        raise ValueError(f"cost must be (N, Q, M) float32, got "
                         f"{tuple(cost.shape)} {cost.dtype}")
    n, q, m = cost.shape
    if valid.shape != (n, m) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be ({n}, {m}) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if valid.device != cost.device:
        raise ValueError(f"valid is on {valid.device}, cost on {cost.device}")
    if not (cost.is_contiguous() and valid.is_contiguous()):
        raise ValueError("cost and valid must be contiguous")
    if max(q, m) > MAX_COLUMNS:
        raise ValueError(f"Q and M must be at most {MAX_COLUMNS} (one thread "
                         f"per column), got Q {q}, M {m}")


def _launch(cost: torch.Tensor, valid: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    check_inputs(cost, valid)
    n, q, m = cost.shape
    tfq = torch.empty((n, q), dtype=torch.long, device=cost.device)
    qft = torch.empty((n, m), dtype=torch.long, device=cost.device)
    if n == 0:
        return tfq, qft
    with torch.cuda.device(cost.device):
        err = _kernel()(cost.data_ptr(), valid.data_ptr(), tfq.data_ptr(),
                        qft.data_ptr(), n, q, m,
                        torch.cuda.current_stream(cost.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"assignment kernel launch failed with cudaError "
                           f"{err}")
    LAUNCHES += 1
    return tfq, qft


def assign(cost: torch.Tensor, valid: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(tgt_for_query (N, Q), query_for_tgt (N, M)) int64 of the least-cost
    assignment of each problem of cost (N, Q, M) over its valid (N, M)
    targets, -1 where unmatched: the CUDA kernel for a CUDA tensor (cost
    float32, both contiguous), the plain version for a CPU tensor. Raises
    for any other device or an input the kernel does not take."""
    if cost.device.type == "cpu":
        return assign_reference(cost, valid)
    if cost.device.type != "cuda":
        raise ValueError(f"assign runs on CPU or CUDA, not {cost.device}")
    return _launch(cost, valid)
