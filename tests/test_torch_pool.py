"""The PyTorch StreamingDetectorPool and the long-term memory of the
streaming detectors against the JAX package's, on the same frames and
weights (the JAX detector's seeded variables, carried over with
``strict=True``), float32 on the CPU; then the port's own counterparts of
the JAX pool's scenarios (tests/test_serving.py): deadlines, priority
classes, close_stream, a failed forward, concurrent pushes and steps, and
the refused options. Frame indices and memory sizes must be equal; scores
and boxes agree to float32 rounding through the model (the tolerances of
test_torch_serving.py)."""

import sys
import threading
import time

import pytest
from test_torch_serving import _assert_same, _frames, small_cfg

from tubelet_transformer_tpu.serving import StreamingDetector as JDetector
from tubelet_transformer_tpu.serving import StreamingDetectorPool as JPool
from tubelet_transformer_tpu_torch.convert import load_jax_variables
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.serving import (
    StreamingDetector, StreamingDetectorPool, buckets)
from torch_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# streams of three geometries, starting at ticks 0, 8 and 12: with steps
# only at the ticks of STEP_AT the pool runs bucket 1 (a), bucket 2 (a, b)
# and bucket 4 padded (a, b, c)
GEOMETRY = {"a": (48, 64), "b": (32, 48), "c": (40, 30)}
START = {"a": 0, "b": 8, "c": 12}
STEP_AT = (15, 23, 31)


def _jax_and_port(cfg, **kw):
    jdet = JDetector(cfg, fps=8.0, **kw)
    model = load_jax_variables(build_model(cfg), jdet.variables["params"],
                               jdet.variables["batch_stats"])
    return jdet, model


def _drive(pool, frames, ticks):
    """Push every started stream's frame at each tick; step at STEP_AT."""
    results = []
    for tick in range(ticks):
        for sid, start in START.items():
            if tick >= start:
                pool.push_frame(sid, frames[sid][tick - start])
        if tick in STEP_AT:
            results.append(pool.step())
    return results


def test_pool_matches_jax_pool():
    """Three streams of different geometries through buckets 1, 2 and a
    padded 4: the same streams fire at each step with the same keyframes,
    and every detection agrees with the JAX pool's (infer_chunk=0: one
    forward per bucket, as the port runs it)."""
    cfg = small_cfg()
    kw = dict(detect_every=8, actor_threshold=-1.0)
    jdet, model = _jax_and_port(cfg, **kw)
    jpool = JPool(cfg, jdet.variables, fps=8.0, max_batch=4, infer_chunk=0,
                  **kw)
    pool = StreamingDetectorPool(cfg, model, fps=8.0, max_batch=4,
                                 device="cpu", instrument=True, **kw)
    frames = {sid: _frames(32, h, w, seed=i)
              for i, (sid, (h, w)) in enumerate(GEOMETRY.items())}
    want = _drive(jpool, frames, 32)
    got = _drive(pool, frames, 32)
    assert [sorted(r) for r in got] == [["a"], ["a", "b"], ["a", "b", "c"]]
    assert [sorted(r) for r in want] == [sorted(r) for r in got]
    for g, w in zip(got, want):
        for sid in w:
            _assert_same(g[sid], w[sid])
            assert g[sid].memory_size == w[sid].memory_size == 0
            assert g[sid].deadline_met is None and g[sid].waited_ms >= 0
    assert [t["bucket"] for t in pool.last_timing] == [4]
    assert pool.last_timing[0]["streams"] == 3


def test_pool_bucket_matches_single_detector():
    """A stream served in a padded bucket equals the same stream served
    alone: the spare rows (zero clips) do not reach the stream's row."""
    cfg = small_cfg()
    model = build_model(cfg, seed=3)
    single = StreamingDetector(cfg, model, fps=8.0, detect_every=8,
                               actor_threshold=-1.0, device="cpu")
    pool = StreamingDetectorPool(cfg, model, fps=8.0, detect_every=8,
                                 actor_threshold=-1.0, max_batch=4,
                                 device="cpu")
    frames = {sid: _frames(32, h, w, seed=i)
              for i, (sid, (h, w)) in enumerate(GEOMETRY.items())}
    got = [r["c"] for r in _drive(pool, frames, 32) if "c" in r]
    # c is served after its 20th frame: the window of its frames 4-19
    want = [r for f in frames["c"][4:20] if (r := single.push_frame(f))]
    assert len(got) == len(want) == 1
    assert got[0].frame_index == want[0].frame_index + 4
    want[0].frame_index, want[0].time_s = got[0].frame_index, got[0].time_s
    _assert_same(got[0], want[0])


def test_lfb_memory_matches_jax():
    """USE_LFB, 3 keyframes x 2 slots: the single detector and a pool of two
    streams against the JAX ones: every detection and the memory_size
    sequence (0, then growing by at most the slots a keyframe, capped at
    6); the memory's first keyframe is fully padded."""
    cfg = small_cfg()
    cfg.use_lfb = True
    kw = dict(detect_every=4, memory_keyframes=3, memory_slots=2,
              actor_threshold=-1.0)
    jdet, model = _jax_and_port(cfg, **kw)
    det = StreamingDetector(cfg, model, fps=8.0, device="cpu", **kw)
    frames = _frames(40, seed=5)
    want = [r for f in frames if (r := jdet.push_frame(f))]
    got = [r for f in frames if (r := det.push_frame(f))]
    # the window fills at frame 16, then one keyframe every 4: 7
    assert [r.memory_size for r in got] == [0, 2, 4, 6, 6, 6, 6]
    assert [r.memory_size for r in want] == [r.memory_size for r in got]
    for g, w in zip(got, want):
        _assert_same(g, w)
    det.reset()
    assert det.push_frame(frames[0]) is None and not det.memory.feats

    jpool = JPool(cfg, jdet.variables, fps=8.0, max_batch=2, infer_chunk=0,
                  **kw)
    pool = StreamingDetectorPool(cfg, model, fps=8.0, max_batch=2,
                                 device="cpu", **kw)
    other = _frames(40, h=32, w=48, seed=6)
    served = []
    for p in (pool, jpool):
        served.append({"x": [], "y": []})
        for fx, fy in zip(frames, other):
            p.push_frame("x", fx)
            p.push_frame("y", fy)
            for sid, r in p.step().items():
                served[-1][sid].append(r)
    ours, theirs = served
    for sid in ("x", "y"):
        sizes = [r.memory_size for r in ours[sid]]
        assert sizes == [0, 2, 4, 6, 6, 6, 6], sid
        assert sizes == [r.memory_size for r in theirs[sid]]
        for g, w in zip(ours[sid], theirs[sid]):
            _assert_same(g, w)
    for g, w in zip(ours["x"], got):
        _assert_same(g, w)


@pytest.fixture(scope="module")
def model():
    return build_model(small_cfg(), seed=4)


def _pool(model, **kw):
    kw = {"fps": 8.0, "detect_every": 8, "max_batch": 2, "device": "cpu",
          **kw}
    return StreamingDetectorPool(small_cfg(), model, **kw)


def test_pool_deadline_scheduling(model):
    """Deadline-monotonic admission when more streams are due than one step
    serves: the least slack first, best effort last; the results report
    waited_ms and deadline_met."""
    pool = _pool(model)
    pool.set_deadline("tight", 120_000.0)
    pool.set_deadline("loose", 600_000.0)
    for f in _frames(16, seed=3):
        for sid in ("easy", "tight", "loose"):
            pool.push_frame(sid, f)
    assert pool._due() == ["tight", "loose", "easy"]
    out = pool.step(max_chunks=1)
    assert set(out) == {"tight", "loose"}
    assert out["tight"].deadline_met is True and out["tight"].waited_ms >= 0
    out = pool.step(max_chunks=1)
    assert set(out) == {"easy"} and out["easy"].deadline_met is None
    assert pool._due() == []


def test_pool_priority_classes_override_deadlines(model):
    pool = _pool(model)
    pool.set_deadline("tight0", 1_000.0)
    pool.set_priority("vip", 1)
    pool.set_priority("vip_loose", 1)
    pool.set_deadline("vip_loose", 60_000.0)
    for f in _frames(16, seed=4):
        for sid in ("tight0", "vip", "vip_loose"):
            pool.push_frame(sid, f)
    assert pool._due() == ["vip_loose", "vip", "tight0"]
    assert set(pool.step(max_chunks=1)) == {"vip_loose", "vip"}
    assert set(pool.step(max_chunks=1)) == {"tight0"}
    assert pool._due() == []


def test_pool_close_stream_releases_state(model):
    pool = _pool(model)
    for f in _frames(4):
        pool.push_frame("a", f)
        pool.push_frame("b", f)
    assert set(pool._streams) == {"a", "b"}
    pool.close_stream("a")
    assert set(pool._streams) == {"b"}
    pool.close_stream("missing")


def test_pool_close_mid_forward_drops_result(model, monkeypatch):
    """A stream closed while its batch is on the device gets no result; the
    other stream of the batch does."""
    pool = _pool(model)
    for f in _frames(16):
        pool.push_frame("a", f)
        pool.push_frame("b", f)
    core = pool._tpl._detect_core

    def closing(*args):
        pool.close_stream("a")
        return core(*args)

    monkeypatch.setattr(pool._tpl, "_detect_core", closing)
    assert set(pool.step()) == {"b"}


def test_pool_failed_forward_keeps_streams_due(model, monkeypatch):
    """A device error mid-step does not consume the cadence: the retried
    step serves the same keyframe."""
    pool = _pool(model)
    for f in _frames(16):
        pool.push_frame("a", f)
    assert pool._due() == ["a"]

    def boom(*args):
        raise RuntimeError("transient device error")

    monkeypatch.setattr(pool._tpl, "_detect_core", boom)
    with pytest.raises(RuntimeError):
        pool.step()
    assert pool._due() == ["a"]
    monkeypatch.undo()
    out = pool.step()
    assert out["a"].frame_index == 8 and pool._due() == []


def test_pool_concurrent_push_and_step(model):
    """Receiver threads pushing and closing streams while this thread steps,
    with a short switch interval: no error, no torn state, results flow,
    and every thread ends."""
    pool = _pool(model, max_batch=4)
    stop = threading.Event()
    errors = []

    def feeder(sid, seed):
        frames = _frames(8, seed=seed)
        i = 0
        try:
            while not stop.is_set():
                pool.push_frame(sid, frames[i % 8])
                i += 1
                if sid == "churn" and i % 40 == 0:
                    pool.close_stream(sid)
                time.sleep(0.001)
        except Exception as exc:  # pragma: no cover - the assertion target
            errors.append(exc)

    threads = [threading.Thread(target=feeder, args=(sid, k))
               for k, sid in enumerate(["a", "b", "c", "churn"])]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    n_results = 0
    try:
        for th in threads:
            th.start()
        deadline = time.time() + 60.0
        while n_results < 6 and time.time() < deadline:
            out = pool.step()
            n_results += len(out)
            if not out:
                time.sleep(0.002)
    finally:
        stop.set()
        sys.setswitchinterval(interval)
        for th in threads:
            th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert n_results >= 6


def test_warmup_runs_every_bucket(model, monkeypatch):
    pool = _pool(model, max_batch=6)
    seen = []
    core = pool._tpl._detect_core

    def recording(clips, *args):
        seen.append(clips.shape[0])
        return core(clips, *args)

    monkeypatch.setattr(pool._tpl, "_detect_core", recording)
    pool.warmup()
    assert seen == buckets(6) == [1, 2, 4, 6]
    assert buckets(8) == [1, 2, 4, 8]


def test_pool_mesh_needs_its_processes(model):
    """A pool over a mesh of 2 data shards in one process is refused,
    naming MESH.DATA x MODEL (mesh serving runs under torchrun:
    test_torch_mesh_serving.py)."""
    from tubelet_transformer_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="MESH.DATA x MODEL"):
        StreamingDetectorPool(small_cfg(), model, device="cpu",
                              mesh=Mesh(data=2))


@pytest.mark.parametrize("knob", ["infer_chunk", "cfg_infer_chunk"])
def test_pool_refuses_unported_options(model, knob):
    cfg = small_cfg()
    kw = {}
    if knob == "infer_chunk":
        kw["infer_chunk"] = 2
    else:
        cfg.model.infer_chunk = 2
    with pytest.raises(NotImplementedError):
        StreamingDetectorPool(cfg, model, device="cpu", **kw)
