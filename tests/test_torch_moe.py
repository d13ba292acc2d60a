"""The MoE encoder FFN (MODEL.MOE_EXPERTS) of the PyTorch port against the
JAX package: the MoE layer alone at top-1 and top-2, with capacity drops
and padded tokens (the cases of tests/test_moe.py); and the rows of a
batch independent. The MoE TubeR's train step with its ``loss_moe_aux``
against JAX is test_torch_accum.py's test_accum_step_matches_jax; its
forward, test_torch_model_options.py's. Float32 on the CPU."""

import jax
import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_tuber import small_cfg

from tubelet_transformer_tpu.models.moe import MoEFFN as JMoEFFN
from tubelet_transformer_tpu_torch.convert import _put_moe
from tubelet_transformer_tpu_torch.models.moe import MoEFFN
from tubelet_transformer_tpu_torch.models.tuber import build_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, S, D, F = 2, 16, 8, 32
HEADS = ("pred_logits", "pred_boxes", "pred_logits_b")

# name -> (experts, top_k, capacity factor, zero router, pad the first half)
MOE_CASES = {
    "top1": (4, 1, 1.25, False, False),
    "top2": (4, 2, 1.25, False, False),
    # zero router: uniform probabilities, every token to expert 0 (the
    # first index wins the tie); capacity 1: only token 0 of a row served
    "capacity_drop": (4, 1, 1e-6, True, False),
    # capacity S/2 = the real tokens of a row, all served
    "padded": (2, 1, 1.0, True, True),
    "top2_padded": (4, 2, 1.0, False, True),
}


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_ffn_matches_jax(case):
    e, k, cf, zero_router, padded = MOE_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    pad = (np.broadcast_to(np.arange(S) < S // 2, (B, S)).copy() if padded
           else None)
    jmod = JMoEFFN(D, F, num_experts=e, top_k=k, capacity_factor=cf)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(1), x)["params"])
    if zero_router:
        params["router"] = {"kernel": np.zeros((D, e), np.float32)}
    want, state = jmod.apply({"params": params}, x, True, pad,
                             mutable=["moe"])
    want_aux = float(jax.tree.leaves(state["moe"])[0])

    mod = MoEFFN(D, F, e, k, cf)
    sd = {}
    _put_moe(sd, "m", params)
    mod.load_state_dict({n[2:]: torch.from_numpy(np.array(v))
                         for n, v in sd.items()}, strict=True)
    with torch.inference_mode():
        got, aux = mod.eval()(torch.from_numpy(x), None if pad is None
                              else torch.from_numpy(pad))
    got = got.numpy()
    # float32 einsums in another order; the routing (argmax, cumsum
    # positions, capacity) must agree exactly, or whole tokens differ
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-6)
    if case == "capacity_drop":
        assert np.abs(got[:, 0]).max() > 0 and not got[:, 1:].any()
    if padded:
        assert not got[:, :S // 2].any()
    if case == "padded":
        assert (np.abs(got[:, S // 2:]).max(axis=-1) > 0).all()
    if zero_router:     # uniform probabilities: E * sum f_e / E = 1
        np.testing.assert_allclose(float(aux), 1.0, rtol=1e-6)


def _option_cfg(option, cfg):
    """``cfg`` with MoE encoder FFNs (4 experts, top 2) or pre-norm."""
    if option == "moe":
        cfg.model.moe_experts, cfg.model.moe_top_k = 4, 2
    else:
        cfg.model.normalize_before = True
    return cfg


def test_moe_rows_independent():
    """Expert capacity is per batch row: a row's outputs are bit-equal
    whatever the other row holds."""
    cfg = _option_cfg("moe", small_cfg("avg"))
    model = build_model(cfg, seed=2)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 64, 64, 3, generator=g)
    other = x.clone()
    other[1] = torch.randn(8, 64, 64, 3, generator=g)
    with torch.inference_mode():
        a, b = model(x), model(other)
    for k in HEADS:
        assert torch.equal(a[k][0], b[k][0]), k
        assert not torch.equal(a[k][1], b[k][1]), k
