"""TRAIN.FROZEN_CHUNK in the PyTorch port's CSN: in training, the frozen
prefix (the stem and stages 1..stop_grad_stage) runs chunk by chunk over
the batch, each chunk normalised by its own batch statistics, every BN of
the prefix taking one EMA update per chunk in chunk order. Against the JAX
CSN with ``frozen_chunk`` (the cases of tests/test_csn.py): the output and
the running statistics at batch 4 in chunks of 2, the whole trunk frozen or
only stem + layer1-2; the partial-freeze gradients in float64; then, on the
port, the chunked prefix against the unchunked model run on each chunk in
turn, bit for bit, and the two-phase stem once per chunk. CSN-TINY on the
CPU; the port's frozen stem takes its plain versions here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_csn import csn_state, randomize_bn

from tubelet_transformer_tpu.models.csn import build_csn as jbuild_csn
from tubelet_transformer_tpu_torch.models import csn as tcsn


@functools.lru_cache(maxsize=None)
def _init():
    """The JAX CSN-TINY's init, compiled once for the file: its variables
    do not depend on stop_grad_stage or frozen_chunk."""
    return jax.jit(jbuild_csn("CSN-TINY", False).init)


def _pair(seed=0, b=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 8, 64, 64, 3)).astype(np.float32)
    variables = jax.device_get(_init()(jax.random.PRNGKey(0), x[:1]))
    params, stats = variables["params"], variables["batch_stats"]
    randomize_bn(params, stats, rng)
    return x, params, stats


def _port(params, stats, stop_grad_stage, frozen_chunk):
    model = tcsn.build_csn("CSN-TINY", False, stop_grad_stage=stop_grad_stage,
                           frozen_chunk=frozen_chunk)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v))
         for k, v in csn_state(params, stats, model.block_nums).items()},
        strict=True)
    return model.train()


def _stats(model):
    return {n: b.clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("stop_grad_stage", [5, 2])
def test_frozen_chunk_matches_jax(stop_grad_stage):
    x, params, stats = _pair()
    jcsn = jbuild_csn("CSN-TINY", False, stop_grad_stage=stop_grad_stage,
                      frozen_chunk=2)
    want, new_vars = jax.jit(lambda v, x: jcsn.apply(
        v, x, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, x)
    model = _port(params, stats, stop_grad_stage, 2)
    got = model(torch.from_numpy(x))
    # float32 through 13 convs and batch statistics: summation order only
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4 * np.abs(want).max())
    want_sd = csn_state(params, jax.device_get(new_vars["batch_stats"]),
                        model.block_nums)
    got_sd = _stats(model)
    assert len(got_sd) == 2 * 17
    for k, v in got_sd.items():
        np.testing.assert_allclose(v.numpy(), want_sd[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_frozen_chunk_partial_freeze_grads_match_jax():
    """stop_grad_stage 1: the chunked prefix is stem + layer1, layer2-4
    run on the whole batch. The prefix gets no gradient (JAX: zero); the
    rest gets, bit for bit, the gradient of layer2-4 run by hand on the
    prefix's per-chunk outputs, and the JAX gradient of the same loss (a
    random projection of the output), float64 on both sides. The JAX
    model computes every train-mode BN's statistics, and their backward,
    in float32 even so (csn.py:_FoldableBN casts to float32): at batch 4
    that moves its gradients by up to 3.6e-3 of a tensor's norm without
    chunking and 8.3e-3 with it for these inputs, so 2e-2; a prefix run
    on the whole batch instead of in chunks moves them by up to 0.58."""
    x, params, stats = _pair(seed=1)
    proj = np.random.default_rng(2).normal(size=(4, 1, 4, 4, 2048))
    with jax.enable_x64(True):
        jcsn = jbuild_csn("CSN-TINY", False, stop_grad_stage=1,
                          frozen_chunk=2, dtype=jnp.float64)
        p64, s64 = (jax.tree.map(lambda a: np.asarray(a, np.float64), t)
                    for t in (params, stats))

        def loss(p):
            y, _ = jcsn.apply({"params": p, "batch_stats": s64},
                              x.astype(np.float64), train=True,
                              mutable=["batch_stats"])
            return jnp.sum(y * proj)

        jgrads = csn_state(jax.device_get(jax.jit(jax.grad(loss))(p64)),
                           s64, (1, 1, 1, 1))
    xt, pt = torch.from_numpy(x).double(), torch.from_numpy(proj)
    model = _port(params, stats, 1, 2).double()
    (model(xt) * pt).sum().backward()
    ref = _port(params, stats, 1, 0).double()
    with torch.no_grad():
        y = torch.cat([ref.stage(0, ref.stem(xc)) for xc in xt.split(2)])
    for s in (1, 2, 3):
        y = ref.stage(s, y)
    (y * pt).sum().backward()
    hand = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        frozen = name.startswith(("conv1.", "bn1.", "layer1."))
        assert (p.grad is None) == frozen, name
        if frozen:
            assert not jgrads[name].any(), name
        else:
            assert torch.equal(p.grad, hand[name].grad), name
            got, want = p.grad.numpy(), jgrads[name]
            assert np.abs(want).max() > 0, name
            assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(
                want), name


@pytest.mark.parametrize("b", [4, 3])
def test_chunks_are_the_unchunked_model_in_turn(b):
    """The whole trunk frozen, chunks of 2: the chunked output is the
    unchunked model's on rows 0-1, then on rows 2-3 (batch order kept),
    and the running statistics those after both, bit for bit. A batch
    that is not a multiple of the chunk runs whole."""
    x, params, stats = _pair(b=b)
    chunked = _port(params, stats, 5, 2)
    plain = _port(params, stats, 5, 0)
    xt = torch.from_numpy(x)
    got = chunked(xt)
    want = (torch.cat([plain(xt[:2]), plain(xt[2:])]) if b == 4
            else plain(xt))
    assert torch.equal(got, want)
    want_stats = _stats(plain)
    for k, v in _stats(chunked).items():
        assert torch.equal(v, want_stats[k]), k


def test_two_phase_stem_runs_once_per_chunk(monkeypatch):
    x, params, stats = _pair(b=2)
    model = _port(params, stats, 2, 1)
    calls = []
    for name in ("stem_batch_stats", "stem_forward"):
        fn = getattr(tcsn, name)
        monkeypatch.setattr(tcsn, name,
                            lambda *a, _f=fn, _n=name: calls.append(
                                (_n, a[0].shape[0])) or _f(*a))
    model(torch.from_numpy(x))
    assert calls == [("stem_batch_stats", 1), ("stem_forward", 1)] * 2
