"""Python client for the HTTP detection service (serving_http).

stdlib-only (urllib), mirroring the wire API one-to-one so producers can
stream frames from anywhere with no framework dependency:

    from tubelet_transformer_tpu_torch.client import DetectionClient

    client = DetectionClient("http://tpu-host:8000")
    with client.open_stream(deadline_ms=250) as stream:
        for frame in camera:                  # (H, W, 3) uint8 RGB
            stream.push(frame)                # raw, no JPEG round-trip
            for kf in stream.results():       # drained, non-blocking
                print(kf["time_s"], kf["detections"])

``stream.push(frame)`` ships raw RGB bytes (fastest, lossless);
``stream.push_jpeg(data)`` forwards already-encoded images untouched.
``stream.results(timeout_s=N)`` long-polls the server.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request
from typing import List, Optional

import numpy as np


class ServingError(RuntimeError):
    """Server returned an error status; ``.code`` is the HTTP status."""

    def __init__(self, code: int, message: str):
        super().__init__(f"HTTP {code}: {message}")
        self.code = code


class DetectionClient:
    def __init__(self, base_url: str, timeout_s: float = 120.0):
        self.base = base_url.rstrip("/")
        self.timeout_s = timeout_s

    # -- plumbing -----------------------------------------------------------

    def _call(self, method: str, path: str, body: Optional[bytes] = None,
              headers: Optional[dict] = None,
              timeout_s: Optional[float] = None) -> dict:
        req = urllib.request.Request(self.base + path, data=body,
                                     method=method, headers=headers or {})
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout_s or self.timeout_s) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", "")
            except Exception:
                msg = e.reason
            raise ServingError(e.code, msg) from None

    # -- API ----------------------------------------------------------------

    def health(self) -> dict:
        return self._call("GET", "/healthz")

    def stats(self) -> dict:
        return self._call("GET", "/v1/stats")

    def open_stream(self, deadline_ms: Optional[float] = None) -> "Stream":
        body = json.dumps(
            {} if deadline_ms is None else {"deadline_ms": deadline_ms}
        ).encode()
        sid = self._call("POST", "/v1/streams", body)["stream_id"]
        return Stream(self, sid)


class Stream:
    """One open stream; context manager closes it server-side."""

    def __init__(self, client: DetectionClient, stream_id: str):
        self.client = client
        self.stream_id = stream_id
        self._closed = False

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def push(self, frame: np.ndarray) -> None:
        """Send one (H, W, 3) uint8 RGB frame as raw bytes."""
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) RGB, got {frame.shape}")
        h, w, _ = frame.shape
        self.client._call(
            "POST", f"/v1/streams/{self.stream_id}/frames",
            body=frame.tobytes(),
            headers={"Content-Type": "application/octet-stream",
                     "X-Frame-Shape": f"{h}x{w}x3"})

    def push_jpeg(self, data: bytes,
                  content_type: str = "image/jpeg") -> None:
        """Send one already-encoded image (JPEG/PNG) untouched."""
        self.client._call(
            "POST", f"/v1/streams/{self.stream_id}/frames",
            body=data, headers={"Content-Type": content_type})

    def results(self, timeout_s: float = 0,
                full_scores: bool = False) -> List[dict]:
        """Drain queued keyframe results; ``timeout_s`` long-polls until at
        least one arrives (or the timeout passes). Each result is the wire
        dict (frame_index, time_s, detections[{box, actor_prob,
        top_actions|scores}], latency_ms, waited_ms, deadline_met)."""
        q = {"timeout_s": timeout_s}
        if full_scores:
            q["full_scores"] = 1
        path = (f"/v1/streams/{self.stream_id}/results?"
                + urllib.parse.urlencode(q))
        # the HTTP read deadline must outlive the server-side long-poll
        return self.client._call(
            "GET", path, timeout_s=timeout_s + self.client.timeout_s
        )["results"]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.client._call(
                "DELETE", f"/v1/streams/{self.stream_id}")
        except ServingError as e:
            if e.code != 404:       # already gone server-side is fine
                raise
