"""The PyTorch HTTP front-end (serving_http.DetectionServer) on the CPU: the
port's counterparts of the JAX package's tests/test_serving_http.py (health
and stats, the stream lifecycle, raw and JPEG ingestion, long-poll
delivery, bad requests, the Python client, concurrent streams sharing
batches), a USE_LFB server's memory sequence, a failed step that keeps
serving, the wire format against the JAX package's, and the CLI's
refusals. Every request and long-poll has its own timeout; the servers
listen on 127.0.0.1 and stop in their fixture's finalizer."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_serving import small_cfg

from tubelet_transformer_tpu import serving_http as jserving_http
from tubelet_transformer_tpu.serving import Detection as JDetection
from tubelet_transformer_tpu.serving import KeyframeResult as JResult
from tubelet_transformer_tpu_torch import serving_http
from tubelet_transformer_tpu_torch.cli import serve_http as cli_serve_http
from tubelet_transformer_tpu_torch.client import DetectionClient, ServingError
from tubelet_transformer_tpu_torch.serving import Detection, KeyframeResult
from tubelet_transformer_tpu_torch.serving_http import DetectionServer

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HTTP_TIMEOUT_S = 60       # every request's socket timeout
POLL_S = 30               # every long-poll's server-side wait


def _req(method, url, body=None, headers=None, timeout=HTTP_TIMEOUT_S):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _poll(base, sid, extra=""):
    return _req("GET", f"{base}/v1/streams/{sid}/results?timeout_s={POLL_S}"
                f"{extra}", timeout=POLL_S + HTTP_TIMEOUT_S)


def _serve(request, cfg, **kw):
    # admit everything so random weights still emit detections; a tight
    # cadence so a handful of frames fires a keyframe
    srv = DetectionServer(cfg, host="127.0.0.1", port=0, max_batch=4,
                          detect_every=4, fps=8.0, actor_threshold=-1.0,
                          device="cpu", **kw)
    request.addfinalizer(srv.stop)
    srv.start()
    return srv


@pytest.fixture(scope="module")
def server(request):
    return _serve(request, small_cfg())


def _base(server):
    return f"http://127.0.0.1:{server.port}"


def _frame(h=48, w=64, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, 3), dtype=np.uint8)


def _push_raw(base, sid, frame):
    h, w, _ = frame.shape
    return _req("POST", f"{base}/v1/streams/{sid}/frames",
                body=frame.tobytes(),
                headers={"Content-Type": "application/octet-stream",
                         "X-Frame-Shape": f"{h}x{w}x3"})


def test_health_and_stats(server):
    base = _base(server)
    code, health = _req("GET", f"{base}/healthz")
    assert code == 200
    assert health == {"status": "ok", "backend": "cpu", "device": "cpu",
                      "devices": 1}
    code, stats = _req("GET", f"{base}/v1/stats")
    assert code == 200 and stats["max_batch"] == 4
    assert {"streams", "keyframes_served", "step_latency_ms_p50",
            "step_latency_ms_p95", "uptime_s"} <= set(stats)


def test_stream_lifecycle_and_detections(server):
    base = _base(server)
    code, r = _req("POST", f"{base}/v1/streams",
                   body=json.dumps({"deadline_ms": 60_000}).encode())
    assert code == 201
    sid = r["stream_id"]
    # window = T(8) * stride(2) = 16 frames; detect_every=4
    frame = _frame()
    for _ in range(16):
        code, r = _push_raw(base, sid, frame)
        assert code == 200
    assert r["frames"] == 16
    code, res = _poll(base, sid)
    assert code == 200 and len(res["results"]) >= 1
    kf = res["results"][0]
    assert kf["frame_index"] == 8 and kf["deadline_met"] is True
    assert kf["memory_size"] == 0
    assert len(kf["detections"]) == 5, "threshold -1 admits every query"
    det = kf["detections"][0]
    assert len(det["box"]) == 4 and len(det["top_actions"]) == 5
    # boxes in SOURCE pixels (the 64x48 frame, not the 32 px canvas)
    assert all(0 <= det["box"][i] <= 64 for i in (0, 2))

    for _ in range(4):
        _push_raw(base, sid, frame)
    code, res = _poll(base, sid, "&full_scores=1")
    assert code == 200 and res["results"]
    assert len(res["results"][0]["detections"][0]["scores"]) == 5

    code, r = _req("DELETE", f"{base}/v1/streams/{sid}")
    assert code == 200 and r == {"closed": sid}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _push_raw(base, sid, frame)
    assert ei.value.code == 404


def test_jpeg_ingestion(server):
    from PIL import Image

    base = _base(server)
    _, r = _req("POST", f"{base}/v1/streams", body=b"{}")
    sid = r["stream_id"]
    buf = io.BytesIO()
    Image.fromarray(_frame()).save(buf, format="JPEG")
    for _ in range(16):
        code, _ = _req("POST", f"{base}/v1/streams/{sid}/frames",
                       body=buf.getvalue(),
                       headers={"Content-Type": "image/jpeg"})
        assert code == 200
    code, res = _poll(base, sid)
    assert code == 200 and len(res["results"]) >= 1
    _req("DELETE", f"{base}/v1/streams/{sid}")


@pytest.mark.parametrize("method,path,body,headers,want", [
    ("GET", "/nope", None, None, 404),
    ("POST", "/v1/streams/sZZ/frames", b"x", None, 404),
    ("GET", "/v1/streams/sZZ/results", None, None, 404),
    ("DELETE", "/v1/streams/sZZ", None, None, 404),
    ("POST", "/v1/streams", b"{not json", None, 400),
])
def test_bad_routes(server, method, path, body, headers, want):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(method, f"{_base(server)}{path}", body=body, headers=headers)
    assert ei.value.code == want


@pytest.mark.parametrize("body,headers", [
    (b"abc", {"Content-Type": "application/octet-stream",
              "X-Frame-Shape": "48x64x3"}),               # byte count
    (b"abc", {"Content-Type": "application/octet-stream"}),  # no shape
    (b"\0" * 12, {"Content-Type": "application/octet-stream",
                  "X-Frame-Shape": "2x2x3x1"}),           # not HxWx3
    (b"not an image", {"Content-Type": "image/jpeg"}),
])
def test_bad_frames_are_400(server, body, headers):
    base = _base(server)
    _, r = _req("POST", f"{base}/v1/streams", body=b"")
    sid = r["stream_id"]
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req("POST", f"{base}/v1/streams/{sid}/frames", body=body,
                 headers=headers)
        assert ei.value.code == 400
    finally:
        _req("DELETE", f"{base}/v1/streams/{sid}")


def test_python_client_round_trip(server):
    """DetectionClient speaks the wire API end to end: open, raw push, JPEG
    push, long-poll results, full_scores, close (idempotent)."""
    from PIL import Image

    client = DetectionClient(_base(server), timeout_s=HTTP_TIMEOUT_S)
    assert client.health()["status"] == "ok"
    assert client.stats()["max_batch"] == 4
    with client.open_stream(deadline_ms=60_000) as stream:
        frame = _frame(seed=7)
        for _ in range(16):
            stream.push(frame)
        results = stream.results(timeout_s=POLL_S)
        assert results and results[0]["deadline_met"] is True
        det = results[0]["detections"][0]
        assert len(det["box"]) == 4 and len(det["top_actions"]) == 5
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG")
        for _ in range(4):
            stream.push_jpeg(buf.getvalue())
        results = stream.results(timeout_s=POLL_S, full_scores=True)
        assert results and len(results[0]["detections"][0]["scores"]) == 5
        with pytest.raises(ValueError):
            stream.push(np.zeros((4, 4), np.uint8))
    stream.close()                                  # second close: no-op
    with pytest.raises(ServingError) as ei:
        stream.push(_frame())
    assert ei.value.code == 404


def test_concurrent_streams_share_batches(server):
    """Three clients feed concurrently; with the scheduler held until every
    feeder is done, all three streams are detected in one forward, and each
    gets its keyframe."""
    base = _base(server)
    sids = [_req("POST", f"{base}/v1/streams", body=b"")[1]["stream_id"]
            for _ in range(3)]
    errs, sizes = [], []
    fed = threading.Event()
    step = server.pool.step

    def held_step(*a, **k):
        if not fed.is_set():
            return {}
        out = step(*a, **k)
        sizes.append(len(out)) if out else None
        return out

    server.pool.step = held_step
    go = threading.Barrier(3)

    def feed(sid, seed):
        try:
            f = _frame(seed=seed)
            go.wait(timeout=HTTP_TIMEOUT_S)
            for _ in range(20):
                _push_raw(base, sid, f)
        except Exception as e:  # pragma: no cover - the assertion target
            errs.append(e)

    threads = [threading.Thread(target=feed, args=(sid, i))
               for i, sid in enumerate(sids)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errs, errs
        fed.set()
        for sid in sids:
            code, res = _poll(base, sid)
            assert code == 200, sid
            assert [r["frame_index"] for r in res["results"]] == [12], sid
            _req("DELETE", f"{base}/v1/streams/{sid}")
    finally:
        server.pool.step = step
    assert sizes[0] == 3


def test_lfb_server_memory_sequence(request):
    """A USE_LFB server, 3 keyframes x 2 slots: every keyframe of a stream
    arrives, its memory_size 0 first, then growing by the slots a
    keyframe up to 6."""
    cfg = small_cfg()
    cfg.use_lfb = True
    srv = _serve(request, cfg, memory_keyframes=3, memory_slots=2)
    client = DetectionClient(_base(srv), timeout_s=HTTP_TIMEOUT_S)
    got = []
    with client.open_stream() as stream:
        for i in range(32):
            stream.push(_frame(seed=i))
            if i >= 15 and (i - 15) % 4 == 0:    # a keyframe is due
                got += stream.results(timeout_s=POLL_S)
    assert [r["frame_index"] for r in got] == [8, 12, 16, 20, 24]
    assert [r["memory_size"] for r in got] == [0, 2, 4, 6, 6]
    assert srv.stats()["keyframes_served"] == 5


def test_failed_step_is_printed_and_serving_goes_on(request, capsys):
    """A forward that raises once: the scheduler prints the failure and
    serves the stream's keyframe at its next step."""
    srv = _serve(request, small_cfg())
    core = srv.pool._tpl._detect_core
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient device error")
        return core(*args)

    srv.pool._tpl._detect_core = flaky
    client = DetectionClient(_base(srv), timeout_s=HTTP_TIMEOUT_S)
    with client.open_stream() as stream:
        for _ in range(16):
            stream.push(_frame())
        results = stream.results(timeout_s=POLL_S)
    assert [r["frame_index"] for r in results] == [8]
    assert "scheduler: step failed: RuntimeError: transient device error" \
        in capsys.readouterr().out


def test_result_to_json_matches_jax():
    """One keyframe result through the port's and the JAX package's wire
    formats: the same bytes, in the top-k and full-scores forms."""
    rng = np.random.default_rng(2)
    dets = [(rng.uniform(0, 300, 4).astype(np.float32), float(p),
             rng.uniform(size=7).astype(np.float32))
            for p in rng.uniform(size=3)]
    kw = dict(frame_index=120, time_s=4.0, latency_ms=12.3456,
              memory_size=6, waited_ms=1.23456, deadline_met=True)
    ours = KeyframeResult(detections=[Detection(*d) for d in dets], **kw)
    theirs = JResult(detections=[JDetection(*d) for d in dets], **kw)
    for opts in ({}, {"top_k": 3}, {"full_scores": True}):
        assert (json.dumps(serving_http.result_to_json(ours, **opts))
                == json.dumps(jserving_http.result_to_json(theirs, **opts)))


def test_cli_refuses_missing_cuda_and_mesh(tmp_path, monkeypatch):
    path = tmp_path / "cfg.yaml"
    path.write_text("CONFIG:\n  MESH:\n    MODEL: 2\n")
    monkeypatch.setattr("sys.argv", ["serve_http", "--config-file",
                                     str(path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_serve_http.main()
    monkeypatch.setattr("sys.argv", ["serve_http", "--config-file",
                                     str(path), "--device", "cpu"])
    # mesh serving runs under torchrun (test_torch_mesh_serving.py): in one
    # process the mesh of MESH.MODEL 2 does not fit
    with pytest.raises(ValueError, match="MESH.DATA x MODEL"):
        cli_serve_http.main()
