"""Each transformer layer of the PyTorch port against its JAX twin, with the
JAX module's initial weights carried over through train/torch_convert's
key scheme (``strict=True``). float32 on the CPU: summation order and
LayerNorm rounding only, so 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tubelet_transformer_tpu.models import layers as jl
from tubelet_transformer_tpu.models.transformer import Transformer as JTr
from tubelet_transformer_tpu.train import torch_convert as tc
from tubelet_transformer_tpu_torch.models import layers as tl
from tubelet_transformer_tpu_torch.models.transformer import Transformer

E, H, FF = 32, 4, 48


def _mha(out, prefix, p):
    tc._put_mha(out, prefix, p)


def _mlp(out, prefix, p):
    for i in range(len(p)):
        tc._put_dense(out, f"{prefix}.layers.{i}", p[f"layers_{i}"])


def _factorized(out, prefix, p):
    for name in ("self_attn_t", "self_attn_s"):
        tc._put_mha(out, f"{prefix}.{name}", p[name])
    for name in ("norm1_t", "norm1_s", "norm2"):
        tc._put_ln(out, f"{prefix}.{name}", p[name])
    for name in ("linear1", "linear2"):
        tc._put_dense(out, f"{prefix}.{name}", p[name])


def _lstr(out, prefix, p):
    for name in ("self_attn", "multihead_attn"):
        tc._put_mha(out, f"{prefix}.{name}", p[name])
    for name in ("norm1", "norm2", "norm3"):
        tc._put_ln(out, f"{prefix}.{name}", p[name])
    for name in ("linear1", "linear2"):
        tc._put_dense(out, f"{prefix}.{name}", p[name])


def _transformer(out, prefix, p):
    n_enc = sum(k.startswith("encoder_layer_") for k in p)
    n_dec = sum(k.startswith("decoder_layer_") for k in p)
    for i in range(n_enc):
        tc._put_encoder_layer(out, f"{prefix}.encoder.layers.{i}",
                              p[f"encoder_layer_{i}"])
    for i in range(n_dec):
        tc._put_decoder_layer(out, f"{prefix}.decoder.layers.{i}",
                              p[f"decoder_layer_{i}"])
    tc._put_ln(out, f"{prefix}.decoder.norm", p["decoder_norm"])


def _arrays(seed=0):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)

    mask = np.zeros((2, 9), bool)
    mask[0, 6:] = True
    mask[1, :] = True                    # a fully padded key row
    return a, mask


def _case(name):
    """(jax module, jax args, torch module, torch args, state writer)."""
    a, mask = _arrays()
    x, y, m = a(2, 5, E), a(2, 5, E), a(2, 9, E)
    if name.startswith("mha"):
        if name == "mha_qkv":
            args = (x, x, x)
        elif name == "mha_qk":
            args = (x, x, y)
        elif name == "mha_kv":
            args = (x, m, m)
        else:
            args = (x, m, a(2, 9, E))
        kpm = mask if name == "mha_mask" else None
        jx = {id(v): jnp.asarray(v) for v in args}
        tx = {id(v): torch.from_numpy(v) for v in args}
        return (jl.MultiHeadAttention(E, H),
                tuple(jx[id(v)] for v in args) + (kpm,),
                tl.MultiHeadAttention(E, H),
                tuple(tx[id(v)] for v in args) + (
                    None if kpm is None else torch.from_numpy(kpm),), _mha)
    if name == "mlp":
        return (jl.MLP(FF, 4, 3), (x,), tl.MLP(E, FF, 4, 3),
                (torch.from_numpy(x),), _mlp)
    if name == "encoder":
        pos = a(2, 9, E)
        return (jl.EncoderLayer(E, H, FF), (m, mask, pos),
                tl.EncoderLayer(E, H, FF),
                tuple(map(torch.from_numpy, (m, mask, pos))),
                tc._put_encoder_layer)
    if name == "decoder":
        pos, qpos = a(2, 9, E), a(2, 5, E)
        return (jl.DecoderLayer(E, H, FF), (x, m, mask, pos, qpos),
                tl.DecoderLayer(E, H, FF),
                tuple(map(torch.from_numpy, (x, m, mask, pos, qpos))),
                tc._put_decoder_layer)
    if name == "factorized":
        src = a(2, 3, 6, E)
        return (jl.FactorizedSTEncoderLayer(E, H, FF), (src,),
                tl.FactorizedSTEncoderLayer(E, H, FF),
                (torch.from_numpy(src),), _factorized)
    if name == "lstr":
        return (jl.LSTRDecoderLayer(E, H, FF), (a(6, 1, E), a(6, 4, E)),
                tl.LSTRDecoderLayer(E, H, FF), None, _lstr)
    if name == "transformer":
        q, pos = a(5, E), a(2, 9, E)
        mask_t = mask.copy()
        mask_t[1, :4] = False            # the decoder needs some memory
        return (JTr(E, H, 2, 3, FF), (m, mask_t, q, pos),
                Transformer(E, H, 2, 3, FF),
                tuple(map(torch.from_numpy, (m, mask_t, q, pos))),
                _transformer)
    raise KeyError(name)


CASES = ["mha_qkv", "mha_qk", "mha_kv", "mha_separate", "mha_mask", "mlp",
         "encoder", "decoder", "factorized", "lstr",
         "transformer"]


@pytest.mark.parametrize("name", CASES)
def test_layer_matches_jax(name):
    jmod, jargs, tmod, targs, put = _case(name)
    if targs is None:
        targs = tuple(torch.from_numpy(np.asarray(v)) for v in jargs)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), *jargs)
                            ["params"])
    want = np.asarray(jmod.apply({"params": params}, *jargs))
    sd = {}
    put(sd, "m", params)
    tmod.load_state_dict(
        {k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()},
        strict=True)
    with torch.inference_mode():
        got = tmod.eval()(*targs).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_fully_masked_row_stays_finite_and_uniform():
    """A key row with every key padded attends uniformly (the finite mask
    value), as in the JAX layer, instead of producing NaN."""
    a, _ = _arrays(1)
    q, k = torch.from_numpy(a(1, 3, E)), torch.from_numpy(a(1, 4, E))
    attn = tl.MultiHeadAttention(E, H).eval()
    with torch.inference_mode():
        masked = attn(q, k, k, torch.ones(1, 4, dtype=torch.bool))
        mean_v = attn.out_proj(torch.nn.functional.linear(
            k, attn.in_proj_weight[2 * E:], attn.in_proj_bias[2 * E:]).mean(
                1, keepdim=True)).expand_as(masked)
    assert torch.isfinite(masked).all()
    torch.testing.assert_close(masked, mean_v, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["mha_qkv", "mha_mask", "encoder",
                                  "decoder", "factorized"])
def test_train_mode_invariants(name):
    """The train-mode invariants of the JAX layers (tests/test_layers.py):
    at dropout 0 train mode equals eval mode (float32: the train-time
    compute-dtype scores are float32 here); with dropout the output
    changes, and the same generator seed replays the same masks."""
    _, _, tmod, targs, _ = _case(name)
    for m in tmod.modules():
        if isinstance(m, tl.MultiHeadAttention):    # torch.empty otherwise
            torch.nn.init.normal_(m.in_proj_weight, std=0.2)
    with torch.no_grad():
        want = tmod.eval()(*targs)
        torch.testing.assert_close(tmod.train()(*targs), want, rtol=1e-6,
                                   atol=1e-6)
        for m in tmod.modules():
            if isinstance(m, tl.Dropout):
                m.p = 0.3
                m.generator = torch.Generator().manual_seed(0)
        first = tmod(*targs)
        for m in tmod.modules():
            if isinstance(m, tl.Dropout):
                m.generator.manual_seed(0)
        again = tmod(*targs)
    assert not torch.allclose(first, want)
    torch.testing.assert_close(first, again, rtol=0, atol=0)
