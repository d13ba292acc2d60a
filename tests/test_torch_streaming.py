"""The PyTorch port's streaming KV-cache attention (ops/streaming.py) and
1-D positional table (ops/position_encoding.py:positional_encoding_1d)
against the JAX package's, float32 on the CPU.

The port's functions take the port's ``MultiHeadAttention`` (torch's
``in_proj_weight`` (3E, E) layout); the JAX functions take the flax dict
that the JAX package's own importer (``torch_convert.mha_params``) makes
from that module's state dict, so the q/k/v split order and the transpose
are under test too. The window positions are the 1-D table. JAX is
imported inside a fixture, so that the CUDA case also runs where JAX is
not installed:
  python -m pytest tests/test_torch_streaming.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
from torch_fixtures import cuda, one_torch_thread  # noqa: F401

from tubelet_transformer_tpu_torch.models.layers import MultiHeadAttention
from tubelet_transformer_tpu_torch.ops import streaming
from tubelet_transformer_tpu_torch.ops.position_encoding import (
    positional_encoding_1d)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

E, H, B, Q, W = 64, 4, 2, 3, 6
STEPS = 4
# float32, summation order only
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def jax_mods():
    pytest.importorskip("jax")
    from tubelet_transformer_tpu.ops import position_encoding as jpe
    from tubelet_transformer_tpu.ops import streaming as js
    from tubelet_transformer_tpu.train import torch_convert as tc

    return jpe, js, tc


def _setup(seed=0):
    """The attention module (random weights and biases from ``seed``, at
    LeCun's scale 1/sqrt(E)), the queries, the window's content, its
    positions (the 1-D table) and the tokens that enter it, all numpy
    float32."""
    rng = np.random.default_rng(seed)
    attn = MultiHeadAttention(E, H).eval()
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.from_numpy(
                rng.normal(0, E ** -0.5, p.shape).astype(np.float32)))
    q = rng.normal(0, 1, (B, Q, E)).astype(np.float32)
    mem = rng.normal(0, 1, (B, W, E)).astype(np.float32)
    pos = np.broadcast_to(positional_encoding_1d(W, E).numpy(),
                          (B, W, E)).copy()
    toks = rng.normal(0, 1, (STEPS, B, 1, E)).astype(np.float32)
    return attn, q, mem, pos, toks


def _jax_params(tc, attn):
    return tc.mha_params({f"x.{k}": v.numpy() for k, v in
                          attn.state_dict().items()}, "x")


def _t(a, device="cpu"):
    return torch.from_numpy(np.asarray(a)).to(device)


@pytest.mark.parametrize("length,d_model", [(16, 64), (32, 256), (8, 2048)])
def test_positional_encoding_1d_matches_jax(jax_mods, length, d_model):
    jpe = jax_mods[0]
    want = np.asarray(jpe.positional_encoding_1d(length, d_model))
    got = positional_encoding_1d(length, d_model)
    assert got.shape == (length, d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # even channels sin, odd channels cos: position 0 is (0, 1, 0, 1, ...)
    np.testing.assert_array_equal(got[0, 0::2].numpy(), 0.0)
    np.testing.assert_array_equal(got[0, 1::2].numpy(), 1.0)


def test_first_pass_matches_jax_and_module(jax_mods):
    """streaming_init + streaming_attend against the JAX functions, and
    against the module's own forward on the same window (keys and values
    both carry the positions)."""
    _, js, tc = jax_mods
    attn, q, mem, pos, _ = _setup()
    params = _jax_params(tc, attn)
    want_state = js.streaming_init(params, H, q, mem, pos)
    want = np.asarray(js.streaming_attend(params, H, want_state))
    with torch.no_grad():
        state = streaming.streaming_init(attn, _t(q), _t(mem), _t(pos))
        got = streaming.streaming_attend(attn, state)
        kv = _t(mem + pos)
        module = attn(_t(q), kv, kv)
    for name, g, w in zip(streaming.StreamingState._fields, state,
                          want_state):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), module.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_rolling_step_matches_jax_and_recompute(jax_mods):
    """Each of 4 rolling steps against the JAX step from the JAX state, and
    against a full recompute of the rolled window (streaming_init +
    streaming_attend)."""
    _, js, tc = jax_mods
    attn, q, mem, pos, toks = _setup(1)
    params = _jax_params(tc, attn)
    jstate = js.streaming_init(params, H, q, mem, pos)
    window = mem.copy()
    with torch.no_grad():
        state = streaming.streaming_init(attn, _t(q), _t(mem), _t(pos))
        for t in range(STEPS):
            jout, jstate = js.streaming_step(params, H, jstate, toks[t])
            out, state = streaming.streaming_step(attn, state, _t(toks[t]))
            window = np.concatenate([window[:, 1:], toks[t]], axis=1)
            fresh = streaming.streaming_attend(attn, streaming.streaming_init(
                attn, _t(q), _t(window), _t(pos)))
            np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {t} against JAX")
            np.testing.assert_allclose(out.numpy(), fresh.numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {t} against recompute")
            np.testing.assert_allclose(state.k.numpy(), np.asarray(jstate.k),
                                       rtol=RTOL, atol=ATOL)
    # the positional keys never move
    first = streaming.streaming_init(attn, _t(q), _t(mem), _t(pos))
    np.testing.assert_array_equal(state.k_pos.numpy(),
                                  first.k_pos.detach().numpy())


@pytest.mark.cuda
def test_streaming_on_cuda_matches_cpu(cuda):
    """The same steps on the card against the CPU, float32 with TF32 off:
    summation order only."""
    torch.backends.cuda.matmul.allow_tf32 = False
    attn, q, mem, pos, toks = _setup(2)
    outs = {}
    for dev in ("cpu", cuda):
        a = attn.to(dev)
        with torch.no_grad():
            state = streaming.streaming_init(a, _t(q, dev), _t(mem, dev),
                                             _t(pos, dev))
            outs[str(dev)] = [streaming.streaming_attend(a, state).cpu()]
            for t in range(STEPS):
                out, state = streaming.streaming_step(a, state,
                                                      _t(toks[t], dev))
                outs[str(dev)].append(out.cpu())
        assert positional_encoding_1d(W, E, device=dev).device.type == \
            torch.device(dev).type
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
