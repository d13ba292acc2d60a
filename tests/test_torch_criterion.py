"""The PyTorch port's matcher and AVA criterion (ops/matcher.py,
train/criterion.py) against the JAX package's, on the same random outputs
and padded targets. Assignments are compared by their COST: the JAX
Jonker-Volgenant solver and scipy may pick different optima on ties.
float32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401

from tubelet_transformer_tpu.config import Config
from tubelet_transformer_tpu.ops import matcher as jm
from tubelet_transformer_tpu.train import criterion as jc
from tubelet_transformer_tpu_torch.ops import matcher as tm
from tubelet_transformer_tpu_torch.train import criterion as tcrit

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _boxes(rng, *shape):
    cxcy = rng.uniform(0.2, 0.8, shape + (2,))
    wh = rng.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([cxcy, wh], -1).astype(np.float32)


def _targets(rng, b, m, c, n_valid):
    valid = np.arange(m)[None] < np.asarray(n_valid)[:, None]
    labels = (rng.uniform(size=(b, m, c)) < 0.3).astype(np.float32)
    labels[..., 0] = 1.0
    return _boxes(rng, b, m), labels, valid


def _matched_cost(cost, tfq):
    """Total cost of the (query, target) pairs of tgt_for_query."""
    q = np.arange(cost.shape[1])
    return np.array([cost[i, q[t >= 0], t[t >= 0]].sum()
                     for i, t in enumerate(tfq)])


@pytest.mark.parametrize("q,m", [(5, 8), (6, 3)])
def test_match_costs_equal_jax_and_scipy(q, m):
    """Random costs with PAD_COST columns, including a sample without
    targets and, for q > m, the transposed problem: the scipy oracle's
    matched cost on the valid submatrix, never more than the JAX solver's,
    and consistent -1 conventions. (The JAX solver runs its potentials in
    float32 next to PAD_COST = 1e6, whose ulp is 0.06: where a query must
    take a padded column it can miss the optimum by that much, and does on
    one sample here.)"""
    rng = np.random.default_rng(q * 10 + m)
    b = 4
    n_valid = [m, m // 2, 0, 1]
    valid = np.arange(m)[None] < np.asarray(n_valid)[:, None]
    cost = np.where(valid[:, None], rng.normal(size=(b, q, m)),
                    jm.PAD_COST).astype(np.float32)
    tfq, qft = (t.numpy() for t in tm.match(torch.from_numpy(cost),
                                            torch.from_numpy(valid)))
    jtfq, jqft = (np.asarray(a) for a in jm.match(jnp.asarray(cost),
                                                  jnp.asarray(valid)))
    oracle = np.array([cost[i][r, c].sum() for i, (r, c) in enumerate(
        jm.hungarian_scipy_oracle(cost, n_valid))])
    np.testing.assert_allclose(_matched_cost(cost, tfq), oracle, rtol=1e-5)
    assert (_matched_cost(cost, tfq)
            <= _matched_cost(cost, jtfq) + 1e-5).all()
    for i in range(b):
        n = min(q, n_valid[i])
        assert (tfq[i] >= 0).sum() == (jtfq[i] >= 0).sum() == n
        assert (qft[i] >= 0).sum() == (jqft[i] >= 0).sum() == n
        for qq, t in enumerate(tfq[i]):
            if t >= 0:
                assert valid[i, t] and qft[i, t] == qq


def test_cost_matrix_matches_jax():
    rng = np.random.default_rng(1)
    pred, tgt = _boxes(rng, 2, 5), _boxes(rng, 2, 4)
    cls = rng.normal(size=(2, 5, 4)).astype(np.float32)
    valid = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], bool)
    want = np.asarray(jm.compute_cost_matrix(
        jnp.asarray(pred), jnp.asarray(cls), jnp.asarray(tgt),
        jnp.asarray(valid), 12.0, 5.0, 2.0))
    got = tm.compute_cost_matrix(*map(torch.from_numpy,
                                      (pred, cls, tgt, valid)),
                                 12.0, 5.0, 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_loss_primitives_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 4, (3, 5, 7)).astype(np.float32)
    t = (rng.uniform(size=(3, 5, 7)) < 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tcrit._stable_bce_from_logits(*map(torch.from_numpy,
                                           (logits, t))).numpy(),
        np.asarray(jc._stable_bce_from_logits(logits, t)), rtol=1e-6,
        atol=1e-6)
    idx = rng.integers(0, 7, (3, 5))
    w = rng.uniform(0.1, 1, 7).astype(np.float32)
    np.testing.assert_allclose(
        tcrit._weighted_ce(torch.from_numpy(logits), torch.from_numpy(idx),
                           torch.from_numpy(w)).item(),
        float(jc._weighted_ce(logits, idx, w)), rtol=1e-6)


@pytest.mark.parametrize("aux_loss,evaluation",
                         [(True, False), (False, False), (True, True)])
def test_criterion_ava_matches_jax(aux_loss, evaluation):
    """Every entry of the loss dict (aux layers included) on random outputs
    of 3 decoder layers, batch 2, 6 queries, 5 classes, 4 target slots;
    continuous random costs, so the assignment is unique. float32: 1e-5."""
    rng = np.random.default_rng(3)
    lay_n, b, q, c, m = 3, 2, 6, 5, 4
    outputs = {"aux_logits": rng.normal(size=(lay_n, b, q, c)),
               "aux_boxes": _boxes(rng, lay_n, b, q),
               "aux_logits_b": rng.normal(size=(lay_n, b, q, 3))}
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    for k in ("logits", "boxes", "logits_b"):
        outputs[f"pred_{k}"] = outputs[f"aux_{k}"][-1]
    boxes, labels, valid = _targets(rng, b, m, c, [3, 1])
    kw = dict(cost_class=12.0, cost_bbox=5.0, cost_giou=2.0, weight=10.0,
              eos_coef=0.1, aux_loss=aux_loss, evaluation=evaluation)
    want = jc.criterion_ava({k: jnp.asarray(v) for k, v in outputs.items()},
                            jc.TargetsAVA(jnp.asarray(boxes),
                                          jnp.asarray(labels),
                                          jnp.asarray(valid)), **kw)
    got = tcrit.criterion_ava(
        {k: torch.from_numpy(v) for k, v in outputs.items()},
        tcrit.TargetsAVA(*map(torch.from_numpy, (boxes, labels, valid))),
        **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("epoch", [0, 1001])
def test_weight_dict_matches_jax(epoch):
    """The weight dict, and the epoch loop's last-layer loss_ce weight
    (swapped after LOSS.WEIGHT_CHANGE), as the JAX loop passes it."""
    from tubelet_transformer_tpu_torch.train.loop import loss_ce_weight

    cfg = Config()
    cfg.model.dec_layers = 3
    assert tcrit.build_weight_dict(cfg, epoch) == jc.build_weight_dict(
        cfg, epoch)
    assert loss_ce_weight(cfg, epoch) == (
        cfg.loss.loss_change_cof if epoch > cfg.loss.weight_change
        else cfg.loss.dice_cof)
