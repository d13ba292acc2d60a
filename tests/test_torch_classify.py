"""The PyTorch port's classification trainer (train/classify.py) against
the JAX package's, on the CPU at CSN-TINY size.

The JAX ``VideoClassifier``'s variables (BN affines and running statistics
randomised) cross over through ``convert.load_classifier`` with
``strict=True``. The optimizer is stated on both sides: ``optax.adamw``'s
defaults (weight decay 1e-4, eps 1e-8) are not ``torch.optim.AdamW``'s
(weight decay 1e-2). JAX is imported inside a fixture, so that the CUDA
case also runs where JAX is not installed:
  python -m pytest tests/test_torch_classify.py -m cuda --noconftest
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from torch_fixtures import cuda, one_torch_thread  # noqa: F401

from tubelet_transformer_tpu_torch import convert
from tubelet_transformer_tpu_torch.train import classify
from tubelet_transformer_tpu_torch.utils import MetricsWriter

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LR, WD, EPS = 1e-3, 1e-4, 1e-8     # optax.adamw(1e-3)'s defaults
N_CLASSES = 5


@pytest.fixture
def jax_mods():
    jax = pytest.importorskip("jax")
    import optax
    from test_torch_csn import randomize_bn

    from tubelet_transformer_tpu.train import classify as jclassify
    from tubelet_transformer_tpu.utils import MetricsWriter as JWriter

    return jax, optax, jclassify, JWriter, randomize_bn


def _adamw(model):
    return torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                             eps=EPS, weight_decay=WD)


def _data(rng, n_batches=6, bs=4, t=4, hw=16):
    """Two linearly separable 'video' classes (mean-shifted noise), as in
    tests/test_classify.py."""
    batches = []
    for _ in range(n_batches):
        labels = rng.integers(0, 2, size=(bs,))
        clips = rng.normal(0, 1, (bs, t, hw, hw, 3)).astype(np.float32)
        clips += labels[:, None, None, None, None].astype(np.float32) * 1.5
        batches.append({"clips": clips, "labels": labels.astype(np.int32)})
    return batches


def _pair(jax_mods, x, seed=0):
    """The JAX classifier's variables (random BN) and the port's model
    holding them."""
    jax, _, jclassify, _, randomize_bn = jax_mods
    jmodel = jclassify.VideoClassifier(backbone_name="CSN-TINY",
                                       num_classes=N_CLASSES)
    variables = jax.device_get(jax.jit(
        lambda r: jmodel.init({"params": r}, x, train=False))(
            jax.random.PRNGKey(seed)))
    params = jax.tree.map(np.array, variables["params"])
    stats = jax.tree.map(np.array, variables["batch_stats"])
    randomize_bn(params, stats, np.random.default_rng(seed))
    model = convert.load_classifier(
        classify.VideoClassifier("CSN-TINY", N_CLASSES), params, stats)
    return params, stats, model


def test_forward_matches_jax(jax_mods):
    """Eval-mode logits of one forward: float32, within 1e-5."""
    jax, _, jclassify, _, _ = jax_mods
    x = np.random.default_rng(0).normal(size=(2, 8, 32, 32, 3)).astype(
        np.float32)
    params, stats, model = _pair(jax_mods, x)
    jmodel = jclassify.VideoClassifier(backbone_name="CSN-TINY",
                                       num_classes=N_CLASSES)
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                   x, train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, N_CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def test_train_step_matches_jax_float64(jax_mods):
    """One train step (train-mode BN, mean softmax cross-entropy, AdamW)
    against ``make_classification_train_step``, both sides float64, as
    tests/test_torch_train_csn.py runs them. The JAX CSN takes its
    train-mode BN statistics in float32 even in a float64 model (ROADMAP
    C3), which bounds the agreement: the loss and every running statistic
    within 1e-5 relative (measured 3.5e-6 and 2.7e-6; a port made to take
    float32 statistics too, in its own summation order, lands at 9.5e-6).
    The first AdamW step moves each weight by lr * g / (|g| + 1e-8): the
    updates agree to 1e-3 lr wherever the gradient is not near zero; where
    it is (below 1e-3 of the tensor's rms gradient: the structurally zero
    gradients of BN biases ahead of a train-mode BN, and the smallest
    entries) its sign or its ratio to the epsilon may flip under that noise,
    and the updates differ by at most 2.2 lr."""
    jax, optax, jclassify, _, _ = jax_mods
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 32, 32, 3)).astype(np.float32)
    labels = np.array([1, 3], np.int32)
    params, stats, model = _pair(jax_mods, x, seed=1)
    with jax.enable_x64(True):
        jmodel = jclassify.VideoClassifier(backbone_name="CSN-TINY",
                                           num_classes=N_CLASSES,
                                           dtype=jnp.float64)
        tx = optax.adamw(LR)
        p64, s64 = (jax.tree.map(lambda a: np.asarray(a, np.float64), t)
                    for t in (params, stats))
        state = jclassify.TrainState(step=jnp.zeros((), jnp.int32),
                                     params=p64, batch_stats=s64,
                                     opt_state=tx.init(p64))
        new, jloss = jclassify.make_classification_train_step(jmodel, tx)(
            state, x.astype(np.float64), labels)
        want = convert.classifier_state(jax.device_get(new.params),
                                        jax.device_get(new.batch_stats),
                                        model.trunk.block_nums)
        jloss = float(jloss)
    model = model.double()
    before = {k: v.clone().numpy() for k, v in model.state_dict().items()}
    tstate = classify.create_classifier_state(model, _adamw(model))
    loss = classify.make_classification_train_step(tstate)(
        torch.from_numpy(x).double(), torch.from_numpy(labels))
    assert tstate.step == 1
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    got = model.state_dict()
    assert set(got) == set(want)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        if k not in grads:          # a running statistic
            assert _rel(got[k].numpy(), want[k]) <= 1e-5, k
            continue
        diff = np.abs((got[k].numpy() - before[k]) - (want[k] - before[k]))
        assert diff.max() <= 2.2 * LR, k
        off = diff > 1e-3 * LR
        rms = np.sqrt(np.mean(grads[k] ** 2))
        assert np.abs(grads[k][off]).max(initial=0) <= 1e-3 * rms, k
        assert off.mean() < 0.1, k


def test_train_classification_logs_like_jax(jax_mods, tmp_path):
    """``train_classification``'s print blocks and its metrics (tags, steps
    and batch sizes) equal the JAX loop's over two epochs of 5 batches with
    display_freq 2; the port reads the loss on display steps only. The
    loops are compared, not the models: the JAX loop drives a step that
    returns a constant loss (the steps themselves are compared in
    test_train_step_matches_jax_float64)."""
    jax, _, jclassify, JWriter, _ = jax_mods
    batches = _data(np.random.default_rng(2), n_batches=5, bs=2)
    model = classify.build_classifier("CSN-TINY", N_CLASSES, seed=2)
    tstate = classify.create_classifier_state(model, _adamw(model))
    real_step = classify.make_classification_train_step(tstate)
    fetched = []

    def counting(clips, labels):
        loss = real_step(clips, labels)
        fetched.append(loss)
        return loss

    logs = {}
    for side, (loop, st, step, writer_cls) in {
            "jax": (jclassify.train_classification, None,
                    lambda st, clips, labels: (st, jax.numpy.float32(1.0)),
                    JWriter),
            "port": (classify.train_classification, tstate, counting,
                     MetricsWriter)}.items():
        writer = writer_cls(str(tmp_path / side), enabled=True)
        out = io.StringIO()
        base_iter = 0
        with contextlib.redirect_stdout(out):
            for epoch in range(2):
                base_iter, st = loop(base_iter, st, step, batches, epoch,
                                     display_freq=2, lr_fn=lambda it: LR,
                                     writer=writer)
        writer.close()
        recs = [json.loads(line) for line in
                open(tmp_path / side / "metrics.jsonl")]
        logs[side] = (base_iter, out.getvalue().splitlines(),
                      [(r["tag"], r["step"]) for r in recs],
                      [r["value"] for r in recs
                       if r["tag"] == "train_batch_size_iteration"])
    jit_, jlines, jtags, jbs = logs["jax"]
    pit, plines, ptags, pbs = logs["port"]
    assert pit == jit_ == 10
    assert ptags == jtags and pbs == jbs
    assert len(ptags) == 3 * 6          # 3 display steps per epoch, x2
    # the same print blocks, line for line, but for the measured values
    assert [line.split(":")[0] for line in plines] == [
        line.split(":")[0] for line in jlines]
    assert [line for line in plines if line.startswith(("Epoch", "lr"))] == [
        line for line in jlines if line.startswith(("Epoch", "lr"))]
    assert len(fetched) == 10 and tstate.step == 10


def test_classifier_learns():
    """The port learns the two separable classes of tests/test_classify.py
    (4 epochs of 6 batches of 4, AdamW at 1e-3): accuracy >= 0.75 on the
    first batch in eval mode."""
    batches = _data(np.random.default_rng(0))
    model = classify.build_classifier("CSN-TINY", 2, seed=0)
    state = classify.create_classifier_state(model, _adamw(model))
    step = classify.make_classification_train_step(state)
    base_iter = 0
    with contextlib.redirect_stdout(io.StringIO()):
        for epoch in range(4):
            base_iter, state = classify.train_classification(
                base_iter, state, step, batches, epoch, display_freq=3)
    assert base_iter == 4 * len(batches)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(batches[0]["clips"]))
    acc = (logits.argmax(-1).numpy() == batches[0]["labels"]).mean()
    assert acc >= 0.75, f"classifier failed to learn: acc={acc}"


@pytest.mark.cuda
def test_step_on_cuda_matches_cpu(cuda):
    """One train step, CSN-TINY, float32 with TF32 off, on the card against
    the CPU: the train-mode logits and the step's loss within summation
    order (1e-4 of their largest magnitude); the first AdamW step moves a
    weight by lr * g / (|g| + eps), so the updates agree to 1e-3 lr except
    where the gradient is near zero (below 5% of its tensor's rms; 0.8% at
    most on an NVIDIA H100), whose sign the summation order may flip, at
    no more than 0.1% of the weights, and there by at most 2.2 lr."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = np.random.default_rng(3).normal(size=(2, 8, 32, 32, 3)).astype(
        np.float32)
    labels = np.array([0, 1])
    outs = {}
    for dev in ("cpu", cuda):
        model = classify.build_classifier("CSN-TINY", N_CLASSES, seed=3,
                                          device=dev)
        before = [p.detach().cpu().clone() for p in model.parameters()]
        state = classify.create_classifier_state(model, _adamw(model))
        with torch.no_grad():
            logits = model(torch.from_numpy(x).to(dev)).cpu()
        loss = classify.make_classification_train_step(state)(
            torch.from_numpy(x).to(dev), torch.from_numpy(labels).to(dev))
        outs[str(dev)] = (loss.cpu(), logits, [
            (p.detach().cpu() - b, p.grad.cpu())
            for p, b in zip(model.parameters(), before)])
    for got, want in zip(outs[str(cuda)][:2], outs["cpu"][:2]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())
    n_off = n_all = 0
    for (dg, _), (dw, g) in zip(outs[str(cuda)][2], outs["cpu"][2]):
        diff = (dg - dw).abs()
        assert diff.max() <= 2.2 * LR
        off = diff > 1e-3 * LR
        n_off, n_all = n_off + int(off.sum()), n_all + off.numel()
        if off.any():
            assert g[off].abs().max() <= 0.05 * g.square().mean().sqrt()
    assert n_off <= 1e-3 * n_all
