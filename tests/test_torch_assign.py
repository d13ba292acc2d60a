"""The PyTorch port's assignment solver (ops/cuda/assign.py; the kernel of
csrc/assign.cu and its plain version) against scipy's optimum (the JAX
package's ``hungarian_scipy_oracle``) and the JAX package's on-device
solver (``ops/matcher.py:match``), at the train path's shapes: the AVA
flagship's (12, 15, 32) and JHMDB's (12, 10, 8) (6 decoder layers x batch
2), and the eval step's loss calls at batch 1, (6, 15, 32) and (6, 10, 8).
Assignments are compared by cost: on ties the solvers may pick different
optima. Then the train step reads nothing on the host: an AVA and a JHMDB
step at test size with the host reads of a tensor patched to raise, the
plain solver's loop conditions alone allowed them.

JAX and scipy are imported inside fixtures, so that the CUDA tests also
run where JAX is not installed:
  python -m pytest tests/test_torch_assign.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401
from torch_fixtures import cuda  # noqa: F401

from tubelet_transformer_tpu_torch.ops import matcher as tm
from tubelet_transformer_tpu_torch.ops.cuda import assign as A

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPES = {"ava_train": (12, 15, 32), "jhmdb_train": (12, 10, 8),
          "ava_eval": (6, 15, 32), "jhmdb_eval": (6, 10, 8)}
KINDS = ("random", "tied", "nonfinite")


@pytest.fixture
def jm():
    pytest.importorskip("jax")
    from tubelet_transformer_tpu.ops import matcher

    return matcher


def problems(shape, kind, seed=0):
    """cost (N, Q, M) float32 and valid (N, M): the valid counts 0, 1, a
    part, Q (when M allows) and M among the problems, the rest random;
    ``tied`` costs are small integers; ``nonfinite`` puts a NaN row, a +inf
    and a -inf row and a NaN entry into some problems."""
    n, q, m = shape
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, m + 1, n)
    counts[:5] = [0, 1, m // 2, min(q, m), m]
    valid = np.zeros((n, m), bool)
    for i, k in enumerate(counts):
        valid[i, rng.permutation(m)[:k]] = True
    if kind == "tied":
        cost = rng.integers(0, 3, (n, q, m)).astype(np.float32)
    else:
        cost = rng.normal(size=(n, q, m)).astype(np.float32)
    if kind == "nonfinite":
        cost[1, 0] = np.nan
        cost[2, q - 1] = np.inf
        cost[3, 1] = -np.inf
        cost[4, 0, 0] = np.nan
    return cost, valid


def sanitized(cost):
    return np.nan_to_num(cost, nan=A.PAD_COST, posinf=A.PAD_COST,
                         neginf=-A.PAD_COST).astype(np.float64)


def matched_cost(cost, tfq):
    """float64 total cost of the (query, target) pairs of tgt_for_query."""
    return np.array([cost[i, np.flatnonzero(t >= 0), t[t >= 0]].sum()
                     for i, t in enumerate(tfq)])


def check_conventions(tfq, qft, valid):
    """-1 for the unmatched; min(Q, valid) pairs, each on a valid target;
    each output the inverse of the other."""
    q = tfq.shape[1]
    for i in range(tfq.shape[0]):
        n = min(q, int(valid[i].sum()))
        rows = np.flatnonzero(tfq[i] >= 0)
        cols = np.flatnonzero(qft[i] >= 0)
        assert len(rows) == len(cols) == n, i
        assert (tfq[i] >= -1).all() and (qft[i] >= -1).all()
        assert valid[i, tfq[i, rows]].all()
        assert (qft[i, tfq[i, rows]] == rows).all()
        assert (tfq[i, qft[i, cols]] == cols).all()
        assert (qft[i, ~valid[i]] == -1).all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_plain_version_is_scipys_optimum(jm, shape, kind):
    """The plain version's total on each problem's valid submatrix equals
    scipy's optimum (non-finite costs at +-PAD_COST, as the port's host
    solve set them), with the -1 conventions; on continuous costs the pairs
    are scipy's too (the optimum is unique)."""
    cost, valid = problems(shape, kind)
    tfq, qft = (t.numpy() for t in A.assign_reference(
        torch.from_numpy(cost), torch.from_numpy(valid)))
    check_conventions(tfq, qft, valid)
    host = sanitized(cost)
    n_valid = valid.sum(1)
    for i, (r, c) in enumerate(jm.hungarian_scipy_oracle(
            np.stack([np.concatenate([h[:, v], h[:, ~v]], 1)
                      for h, v in zip(host, valid)]), n_valid)):
        cols = np.flatnonzero(valid[i])
        want = host[i][r, cols[c]].sum()
        got = matched_cost(host[i:i + 1], tfq[i:i + 1])[0]
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9,
                                   err_msg=str(i))
        if kind == "random":
            assert set(zip(r, cols[c])) == set(
                (qq, t) for qq, t in enumerate(tfq[i]) if t >= 0), i


@pytest.mark.parametrize("kind", ("random", "tied"))
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_jax_cost_never_below_the_port(jm, shape, kind):
    """JAX's solver on the same costs with the invalid columns at PAD_COST
    (what ``compute_cost_matrix`` gives it): the same number of pairs, each
    output the other's inverse, and a total never below the port's (JAX's
    float32 potentials beside PAD_COST can miss the optimum)."""
    import jax.numpy as jnp

    cost, valid = problems(shape, kind, seed=1)
    padded = np.where(valid[:, None], cost, jm.PAD_COST).astype(np.float32)
    tfq, qft = (t.numpy() for t in tm.match(torch.from_numpy(padded),
                                            torch.from_numpy(valid)))
    jtfq, jqft = (np.asarray(a).astype(np.int64) for a in jm.match(
        jnp.asarray(padded), jnp.asarray(valid)))
    check_conventions(tfq, qft, valid)
    check_conventions(jtfq, jqft, valid)
    host = padded.astype(np.float64)
    assert (matched_cost(host, tfq)
            <= matched_cost(host, jtfq) + 1e-9).all()


def test_cpu_tensor_takes_the_plain_version():
    """``assign`` and ``match`` on CPU tensors: the plain version's result,
    int64 on the CPU, and no launch."""
    cost, valid = problems(SHAPES["ava_train"], "random")
    launches = A.LAUNCHES
    want = A.assign_reference(torch.from_numpy(cost), torch.from_numpy(valid))
    for got in (A.assign(torch.from_numpy(cost), torch.from_numpy(valid)),
                tm.match(torch.from_numpy(cost), torch.from_numpy(valid))):
        for g, w in zip(got, want):
            assert g.dtype == torch.int64 and g.device.type == "cpu"
            assert torch.equal(g, w)
    assert A.LAUNCHES == launches


@pytest.mark.parametrize("shape", [(3, 1, 5), (3, 5, 1), (2, 4, 4),
                                   (2, 0, 3), (2, 3, 0)])
def test_degenerate_shapes(shape):
    """One query or one target slot, a square problem, no queries, no
    target slots: scipy's pair count, the conventions, finite totals."""
    cost, valid = problems((max(shape[0], 5),) + shape[1:], "random")
    tfq, qft = (t.numpy() for t in A.assign_reference(
        torch.from_numpy(cost), torch.from_numpy(valid)))
    assert tfq.shape == cost.shape[:2] and qft.shape == valid.shape
    check_conventions(tfq, qft, valid)


def _host_reads_raise(monkeypatch):
    """Patch every host read of a tensor to raise, but inside
    ``assign_reference``, whose loop conditions read CPU tensors (the
    kernel's do not)."""
    names = ("item", "__bool__", "__float__", "__int__", "tolist", "numpy",
             "cpu")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(name):
        def raiser(*args, **kwargs):
            raise AssertionError(f"the train step read a tensor on the "
                                 f"host: Tensor.{name}")
        return raiser

    def patch():
        for n in names:
            monkeypatch.setattr(torch.Tensor, n, refuse(n))

    plain = A.assign_reference

    def lifted(*args, **kwargs):
        for n, fn in saved.items():
            monkeypatch.setattr(torch.Tensor, n, fn)
        try:
            return plain(*args, **kwargs)
        finally:
            patch()

    monkeypatch.setattr(A, "assign_reference", lifted)
    patch()
    return saved


def _guarded_steps(monkeypatch, cfg, model, batches):
    """Train steps of ``model`` on ``batches`` with the host reads
    patched; the metrics, then the patches lifted."""
    from tubelet_transformer_tpu_torch.train import engine

    cpu = torch.device("cpu")
    state = engine.create_train_state(cfg, model, steps_per_epoch=10)
    step = engine.make_train_step(cfg, state)
    device = [engine.device_batch(b, cpu) for b in batches]
    with monkeypatch.context() as mp:
        _host_reads_raise(mp)
        out = [step(b, cfg.loss.dice_cof) for b in device]
    return state, out


def test_ava_train_step_reads_nothing_on_the_host(monkeypatch):
    """An AVA train step at test size (test_torch_train_step.py's config),
    then a non-finite one, with no host read of a tensor outside the plain
    solver: the first updates, the second skips (the update count stays
    1), every metric a 0-dim tensor."""
    from test_torch_train_step import _batch, _cfg

    from tubelet_transformer_tpu_torch.models.tuber import build_model

    cfg = _cfg()
    batch = _batch(cfg)
    bad = dict(batch, clips=np.full_like(batch["clips"], np.nan))
    state, (good, skipped) = _guarded_steps(
        monkeypatch, cfg, build_model(cfg, train=True), [batch, bad])
    assert float(good["finite"]) == 1.0 and float(skipped["finite"]) == 0.0
    assert state.step == 2 and int(state.updates) == 1
    assert all(v.dim() == 0 for v in good.values())


def test_jhmdb_train_step_reads_nothing_on_the_host(monkeypatch):
    """The same for a JHMDB train step at test size (test_torch_jhmdb.py's
    config and batch: Q < 4 target slots, one sample with one box)."""
    from test_torch_jhmdb import _train_batch, small_cfg

    from tubelet_transformer_tpu_torch.models.tuber import build_model

    cfg = small_cfg()
    cfg.model.pretrained = True
    state, (good,) = _guarded_steps(
        monkeypatch, cfg, build_model(cfg, train=True), [_train_batch(cfg)])
    assert float(good["finite"]) == 1.0 and int(state.updates) == 1
    assert np.isfinite(float(good["total_loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_kernel_matches_plain_version(cuda, shape, kind):
    """The kernel against the plain version on the card and on the CPU,
    bit for bit (the same float64 arithmetic and tie rule), and a repeat
    launch bit-equal; one launch each."""
    cost, valid = problems(shape, kind)
    c, v = torch.from_numpy(cost).to(cuda), torch.from_numpy(valid).to(cuda)
    launches = A.LAUNCHES
    got, again = A.assign(c, v), A.assign(c, v)
    torch.cuda.synchronize()
    assert A.LAUNCHES == launches + 2
    for want in (A.assign_reference(c, v), A.assign_reference(
            torch.from_numpy(cost), torch.from_numpy(valid))):
        for g, a, w in zip(got, again, want):
            assert torch.equal(g.cpu(), w.cpu())
            assert torch.equal(g, a)


@pytest.mark.cuda
def test_kernel_makes_no_host_sync(cuda):
    """Under sync debug mode "error" the kernel runs through; the plain
    version, whose loops read the device, raises (the control)."""
    cost, valid = problems(SHAPES["ava_train"], "random")
    c, v = torch.from_numpy(cost).to(cuda), torch.from_numpy(valid).to(cuda)
    tm.match(c, v)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tm.match(c, v)
        with pytest.raises(RuntimeError, match="synchroniz"):
            A.assign_reference(c, v)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_wrapper_refusals(cuda):
    """float64 costs, int valid, a non-contiguous cost, a mismatched or
    misplaced valid, and more than 1024 columns are refused."""
    cost = torch.zeros((2, 4, 6), device=cuda)
    valid = torch.ones((2, 6), dtype=torch.bool, device=cuda)
    bad = [(cost.double(), valid), (cost, valid.int()),
           (cost.transpose(1, 2).contiguous().transpose(1, 2), valid),
           (cost, valid[:, :5]), (cost, valid.cpu()),
           (torch.zeros((1, 4, 1025), device=cuda),
            torch.ones((1, 1025), dtype=torch.bool, device=cuda))]
    for c, v in bad:
        with pytest.raises(ValueError):
            A.assign(c, v)
