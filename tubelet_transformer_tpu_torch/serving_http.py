"""HTTP serving front-end for the multi-stream detector pool.

Port of ``tubelet_transformer_tpu/serving_http.py``: the same API, threads
and wire format in front of the port's ``serving.StreamingDetectorPool``,
stdlib only (``http.server``). ``result_to_json`` and ``_decode_frame`` are
the port's copies of the JAX package's.

Architecture:

  * HTTP handler threads ingest frames (``POST .../frames``) straight into
    the thread-safe pool (``push_frame`` holds the pool lock only for the
    host-side resize/canvas, never the device);
  * ONE scheduler daemon thread drives ``pool.step()`` (and the warmup
    before it) — all due streams are detected in a single padded batched
    forward per bucket, so concurrent HTTP clients share the card instead
    of serializing on it; a failed warmup or step is printed
    (``scheduler: warmup failed`` / ``scheduler: step failed``) and the
    server keeps serving, the failed step's streams still due; under a
    mesh the failure ends the process instead (exit code 1): the other
    ranks wait inside a collective that this rank will not enter, and its
    closed connections end their wait, so that every rank exits non-zero
    and none retries out of step with the others;
  * results are fanned out to bounded per-stream queues that clients drain
    with (long-)polling ``GET .../results``.

API (JSON unless noted):
  POST   /v1/streams                      {"deadline_ms": 250?} -> {"stream_id"}
  POST   /v1/streams/<id>/frames          body = JPEG/PNG bytes, or raw RGB
                                          (application/octet-stream +
                                           X-Frame-Shape: HxWx3)
  GET    /v1/streams/<id>/results[?timeout_s=N][&full_scores=1]
  DELETE /v1/streams/<id>
  GET    /v1/stats
  GET    /healthz                         {"status", "backend" ("cuda" or
                                           "cpu"), "device", "devices"}

Under a mesh (``mesh``, ``serving.py``'s module docstring) the server
lives on rank 0, whose scheduler thread is the one caller of the forward;
the other ranks run ``serving.follow``, and ``stop()`` releases them.

Run it: ``python -m tubelet_transformer_tpu_torch.cli.serve_http
--config-file configuration/tuber_csn152_ava22.yaml --port 8000``.
"""

from __future__ import annotations

import io
import json
import os
import re
import threading
import time
import traceback
from collections import deque
from typing import Dict, Optional

import numpy as np

import torch

from tubelet_transformer_tpu_torch.config import Config
from tubelet_transformer_tpu_torch.models.tuber import TubeR
from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.serving import (KeyframeResult,
                                                   StreamingDetectorPool)

_RESULT_QUEUE_MAX = 64          # unpolled results kept per stream
_STREAM_RE = re.compile(r"^/v1/streams/([A-Za-z0-9_.-]+)(/frames|/results)?$")


def result_to_json(res: KeyframeResult, top_k: int = 5,
                   full_scores: bool = False) -> dict:
    """Wire format for one keyframe result (small by default: top-k action
    scores per detection; ``full_scores`` ships the whole class vector)."""
    dets = []
    for d in res.detections:
        scores = np.asarray(d.scores, np.float32)
        rec = {
            "box": [round(float(v), 2) for v in np.asarray(d.box)],
            "actor_prob": round(float(d.actor_prob), 4),
        }
        if full_scores:
            rec["scores"] = [round(float(s), 4) for s in scores]
        else:
            order = np.argsort(-scores)[:top_k]
            rec["top_actions"] = [[int(c), round(float(scores[c]), 4)]
                                  for c in order]
        dets.append(rec)
    return {
        "frame_index": int(res.frame_index),
        "time_s": round(float(res.time_s), 3),
        "latency_ms": round(float(res.latency_ms), 2),
        "waited_ms": round(float(res.waited_ms), 2),
        "deadline_met": res.deadline_met,
        "memory_size": int(res.memory_size),
        "detections": dets,
    }


class _StreamState:
    __slots__ = ("queue", "cond", "frames_in", "results_out", "dropped",
                 "closed")

    def __init__(self):
        self.queue: deque = deque(maxlen=_RESULT_QUEUE_MAX)
        self.cond = threading.Condition()
        self.frames_in = 0
        self.results_out = 0
        self.dropped = 0
        self.closed = False  # set under cond; lets long-pollers exit
        # without touching the server lock (cond is always taken AFTER the
        # server lock, never the reverse — see _results)


class DetectionServer:
    """Owns the pool, the scheduler thread, and the HTTP server.

    ``serve_forever()`` blocks; ``start()``/``stop()`` run it on background
    threads (used by the tests and embedders). The constructor builds the
    pool and its model (``model``, or random weights from ``rng_seed`` on
    ``device``) and runs nothing on the device; ``start()``/
    ``serve_forever()`` run every batch bucket once on the scheduler thread
    first (``warmup=False`` leaves that to the first live detection, which
    then pays for the kernel build and the library handles against its
    deadline). ``memory_keyframes`` / ``memory_slots`` size each stream's
    long-term memory under ``CONFIG.USE_LFB``.
    """

    def __init__(self, cfg: Config, model: Optional[TubeR] = None, *,
                 host: str = "0.0.0.0", port: int = 8000, max_batch: int = 8,
                 detect_every: Optional[int] = None, fps: float = 30.0,
                 actor_threshold: float = 0.8,
                 poll_interval_s: float = 0.002, mesh=None,
                 warmup: bool = True, memory_keyframes: int = 10,
                 memory_slots: int = 5, device: torch.device | str = "cuda",
                 rng_seed: int = 0):
        if mesh is not None and not mesh_lib.is_main_process():
            raise ValueError("DetectionServer runs on rank 0; the other "
                             "ranks call serving.follow")
        self._warmup = warmup
        self.pool = StreamingDetectorPool(
            cfg, model, max_batch=max_batch, detect_every=detect_every,
            fps=fps, actor_threshold=actor_threshold, mesh=mesh,
            memory_keyframes=memory_keyframes, memory_slots=memory_slots,
            device=device, rng_seed=rng_seed)
        self._poll_interval = poll_interval_s
        self._lock = threading.Lock()       # guards _streams / counters
        self._streams: Dict[str, _StreamState] = {}
        self._next_id = 0
        self._stop = threading.Event()
        self._ready = threading.Event()     # set once warmup completes
        self._sched_thread: Optional[threading.Thread] = None
        self._http_thread: Optional[threading.Thread] = None
        self._started_at = time.time()
        self._step_lat_ms: deque = deque(maxlen=512)
        self._keyframes_served = 0

        from http.server import ThreadingHTTPServer

        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]   # resolved if port=0

    # -- lifecycle ---------------------------------------------------------

    def start(self, wait_ready: bool = True) -> None:
        """Start HTTP + scheduler threads. HTTP answers immediately
        (``/healthz`` reports ``warming`` until every bucket has run once);
        ``wait_ready`` blocks until warmup finishes so the first request
        after return pays for no first run."""
        self._sched_thread = threading.Thread(
            target=self._scheduler_loop, name="tuber-scheduler", daemon=True)
        self._sched_thread.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="tuber-http", daemon=True)
        self._http_thread.start()
        if wait_ready:
            self._ready.wait()

    def serve_forever(self) -> None:
        self._sched_thread = threading.Thread(
            target=self._scheduler_loop, name="tuber-scheduler", daemon=True)
        self._sched_thread.start()
        try:
            self.httpd.serve_forever()
        finally:
            self.stop()

    def stop(self) -> None:
        """Stop serving; under a mesh, once the scheduler's last step has
        ended, release the followers."""
        self._stop.set()
        self._ready.set()           # unblock any start(wait_ready=True)
        self.httpd.shutdown()
        self.httpd.server_close()
        mesh = self.pool._tpl.mesh
        if self._sched_thread is not None:
            # under a mesh, a step's collectives end at the groups' TIMEOUT
            self._sched_thread.join(timeout=None if mesh else 30)
        self.pool.stop_followers()

    def _failed(self, what: str, e: Exception) -> None:
        """Print a failed warmup or step; under a mesh, end the process."""
        print(f"scheduler: {what} failed: {type(e).__name__}: {e}\n"
              f"{traceback.format_exc()}", flush=True)
        if self.pool._tpl.mesh is not None:
            os._exit(1)

    # -- scheduler ---------------------------------------------------------

    def _scheduler_loop(self) -> None:
        """The single thread that talks to the device: batches all due
        streams per tick. Handler threads never run the forward. Warmup
        runs here first — it is device work, and this thread owns the
        device — so HTTP comes up instantly while the buckets run."""
        if self._warmup and not self._stop.is_set():
            try:
                self.pool.warmup()
            except Exception as e:  # the first live step builds instead
                self._failed("warmup", e)
        self._ready.set()
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                results = self.pool.step()
            except Exception as e:  # keep serving; streams stay due
                self._failed("step", e)
                self._stop.wait(0.1)
                continue
            if results:
                self._step_lat_ms.append(
                    (time.perf_counter() - t0) * 1e3)
                with self._lock:
                    for sid, res in results.items():
                        st = self._streams.get(sid)
                        if st is None:
                            continue
                        self._keyframes_served += 1
                        with st.cond:
                            if len(st.queue) == st.queue.maxlen:
                                st.dropped += 1
                            st.queue.append(res)
                            st.results_out += 1
                            st.cond.notify_all()
            else:
                self._stop.wait(self._poll_interval)

    # -- stream registry (called from handler threads) ----------------------

    def create_stream(self, deadline_ms: Optional[float] = None) -> str:
        with self._lock:
            sid = f"s{self._next_id}"
            self._next_id += 1
            self._streams[sid] = _StreamState()
        if deadline_ms is not None:
            self.pool.set_deadline(sid, float(deadline_ms))
        return sid

    def get_stream(self, sid: str) -> Optional[_StreamState]:
        with self._lock:
            return self._streams.get(sid)

    def close_stream(self, sid: str) -> bool:
        with self._lock:
            st = self._streams.pop(sid, None)
        if st is None:
            return False
        # closed is set BEFORE the pool drop: a racing frame push either
        # sees closed (and removes its own pool resurrection) or pushed
        # before this pool.close_stream, which then removes it — both
        # orders leave the pool clean
        with st.cond:
            st.closed = True
            st.cond.notify_all()    # wake long-pollers; they see 404 next
        self.pool.close_stream(sid)
        return True

    def stats(self) -> dict:
        lat = sorted(self._step_lat_ms)

        def pct(p):
            return (round(lat[min(len(lat) - 1, int(p * len(lat)))], 2)
                    if lat else None)

        with self._lock:
            n_streams = len(self._streams)
            frames = sum(s.frames_in for s in self._streams.values())
        return {
            "streams": n_streams,
            "keyframes_served": self._keyframes_served,
            "frames_ingested_live_streams": frames,
            "step_latency_ms_p50": pct(0.50),
            "step_latency_ms_p95": pct(0.95),
            "uptime_s": round(time.time() - self._started_at, 1),
            "max_batch": self.pool.max_batch,
        }


def _decode_frame(body: bytes, content_type: str,
                  shape_header: Optional[str]) -> np.ndarray:
    """Body -> (H, W, 3) uint8 RGB. Raw path avoids the JPEG round-trip for
    co-located producers; image path accepts anything PIL reads."""
    if content_type.startswith("application/octet-stream"):
        if not shape_header:
            raise ValueError("raw frames need X-Frame-Shape: HxWx3")
        dims = [int(x) for x in shape_header.lower().split("x")]
        if len(dims) != 3 or dims[2] != 3:
            raise ValueError(f"bad X-Frame-Shape {shape_header!r}")
        expect = dims[0] * dims[1] * dims[2]
        if len(body) != expect:
            raise ValueError(
                f"raw frame is {len(body)} bytes, shape needs {expect}")
        return np.frombuffer(body, np.uint8).reshape(dims)
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def _make_handler(server: "DetectionServer"):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # -- helpers --------------------------------------------------------

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str) -> None:
            self._json(code, {"error": msg})

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n else b""

        def _query(self) -> dict:
            from urllib.parse import parse_qs, urlparse

            return {k: v[-1] for k, v in
                    parse_qs(urlparse(self.path).query).items()}

        @property
        def _route(self) -> str:
            from urllib.parse import urlparse

            return urlparse(self.path).path

        def log_message(self, fmt, *args):  # quiet: one line per frame is noise
            pass

        # -- methods --------------------------------------------------------

        def do_GET(self):
            path = self._route
            if path == "/healthz":
                dev = server.pool._tpl.device
                cuda = dev.type == "cuda"
                return self._json(200, {
                    "status": ("ok" if server._ready.is_set()
                               else "warming"),
                    "backend": dev.type,
                    "device": (torch.cuda.get_device_name(dev) if cuda
                               else "cpu"),
                    "devices": torch.cuda.device_count() if cuda else 1,
                })
            if path == "/v1/stats":
                return self._json(200, server.stats())
            m = _STREAM_RE.match(path)
            if m and m.group(2) == "/results":
                return self._results(m.group(1))
            return self._error(404, f"no route {path}")

        def do_POST(self):
            path = self._route
            if path == "/v1/streams":
                body = self._body()
                try:
                    opts = json.loads(body) if body else {}
                except json.JSONDecodeError as e:
                    return self._error(400, f"bad JSON: {e}")
                sid = server.create_stream(opts.get("deadline_ms"))
                return self._json(201, {"stream_id": sid})
            m = _STREAM_RE.match(path)
            if m and m.group(2) == "/frames":
                return self._frames(m.group(1))
            return self._error(404, f"no route {path}")

        def do_DELETE(self):
            m = _STREAM_RE.match(self._route)
            if m and m.group(2) is None:
                if server.close_stream(m.group(1)):
                    return self._json(200, {"closed": m.group(1)})
                return self._error(404, "unknown stream")
            return self._error(404, f"no route {self._route}")

        # -- endpoint bodies --------------------------------------------------

        def _frames(self, sid: str):
            st = server.get_stream(sid)
            if st is None:
                return self._error(404, "unknown stream (POST /v1/streams)")
            try:
                frame = _decode_frame(
                    self._body(), self.headers.get("Content-Type", ""),
                    self.headers.get("X-Frame-Shape"))
            except Exception as e:
                return self._error(400, str(e))
            server.pool.push_frame(sid, frame)
            with st.cond:
                if st.closed:
                    # DELETE raced this push: the pool auto-creates streams
                    # on push_frame, so drop the resurrected entry or its
                    # frame canvases would leak unboundedly
                    server.pool.close_stream(sid)
                    return self._error(404, "stream closed")
                st.frames_in += 1
            return self._json(200, {"frames": st.frames_in})

        def _results(self, sid: str):
            st = server.get_stream(sid)
            if st is None:
                return self._error(404, "unknown stream")
            q = self._query()
            timeout_s = float(q.get("timeout_s", 0))
            full = q.get("full_scores") in ("1", "true")
            deadline = time.perf_counter() + timeout_s
            out = []
            with st.cond:
                while True:
                    while st.queue:
                        out.append(result_to_json(
                            st.queue.popleft(), full_scores=full))
                    if out or timeout_s <= 0:
                        break
                    remain = deadline - time.perf_counter()
                    if remain <= 0:
                        break
                    st.cond.wait(remain)
                    if st.closed:               # closed while we waited
                        return self._error(404, "stream closed")
                dropped = st.dropped
            return self._json(200, {"stream_id": sid, "results": out,
                                    "dropped": dropped})

    return Handler
