"""Mesh serving (``MESH.MODEL``, with ``MESH.DATA`` beside it) held
against the one-process pool on the same frames, and against a control
whose model peers leave out "g".

Run under torchrun, one process per rank (ranks on one card over gloo):

  python -m torch.distributed.run --nproc_per_node 2 \\
      -m tubelet_transformer_tpu_torch.tools.serve_check \\
      --config-file build/chip_smoke_stages.yaml --model 2 \\
      --device cuda:0 --dist-backend gloo --out build/serve_check.pt

The mesh is ``--data`` x ``--model`` (the config's MESH.DATA and
MESH.MODEL by default). Every rank builds the eval model from ``--seed``,
split over the 'model' axis. 15 streams of noise frames, each at a
brightness of its own, push one frame a tick; they start so that the pool
(max_batch 8, one keyframe per 8 frames, actor threshold -1, the memory
off) runs one forward of each of buckets 8, 4, 2 and 1. In order:

* ``reference`` (rank 0, before the mesh forms a forward): the
  one-process pool of the full model on the frames, each forward's batch
  and outputs kept, and a one-process detector on each HTTP stream;
* ``pool``: rank 0's pool over the mesh (its warmup first), the others
  following (``serving.follow``); each forward's outputs against the
  reference's on the same batch: scores, actor probabilities and boxes
  over the canvas, the largest absolute difference over the streams'
  rows, by bucket;
* ``control``: the same batches again with every rank's model on a mesh
  whose "g" is the identity, each peer's partial sums in place of their
  sum: its readings must miss whatever bound holds the pool's;
* ``http``: rank 0's ``DetectionServer`` over the mesh, a client thread
  of rank 0's process pushing HTTP_STREAMS streams to it (up to each of
  two keyframes, whose results it waits for), their results against the
  one-process detector's (boxes over the source's longer side);
* ``send``: the batch of each bucket sent SEND_REPEATS times whole to
  every rank and, where MESH.DATA divides it, as each data shard's rows
  alone (``parallel.mesh.broadcast_batch``), each until every rank has
  it (a barrier after the send), in ms.

On every rank, each forward's rows, the launches of the pooled stem, the
depthwise and the stage chain in it, and a digest of its outputs (the
model peers' must be equal); each follower's count of forwards. Rank 0
writes it all to ``--out``, with the pool's per-bucket times (the send,
the rows' forward, the gather: ``broadcast_ms``, ``exec_fetch_ms``,
``gather_ms``).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
from tubelet_transformer_tpu_torch.serving import (StreamingDetector,
                                                   StreamingDetectorPool,
                                                   follow)
from tubelet_transformer_tpu_torch.tools import dp_check
from tubelet_transformer_tpu_torch.tools.tp_check import _rebind, eval_launches

MAX_BATCH = 8
# the streams' start ticks: 8 start at 0, 4 at 2, 2 at 4 and 1 at 6, so
# that one step a tick runs buckets 8, 4, 2 and 1 in turn
STARTS = (0,) * 8 + (2,) * 4 + (4,) * 2 + (6,)
GEOMETRY = (240, 320)
FRAMES_PER_STREAM = 16
HTTP_STREAMS = 3
SEND_REPEATS = 5
KW = dict(fps=8.0, detect_every=8, actor_threshold=-1.0)


class NoReduceMesh(mesh_lib.Mesh):
    """The control: "g" left out, each peer's partial sums passed on."""

    def reduce_from_model(self, t):
        return t


def stream_frames(i: int) -> list:
    """Stream ``i``'s frames: noise in [12 i, 12 i + 64)."""
    rng = np.random.default_rng(200 + i)
    return [rng.integers(12 * i, 12 * i + 64, (*GEOMETRY, 3), dtype=np.uint8)
            for _ in range(FRAMES_PER_STREAM)]


def _digest(outs) -> str:
    return hashlib.sha256(b"".join(np.ascontiguousarray(o).tobytes()
                                   for o in outs)).hexdigest()


def record_forwards(phase: list, forwards: list):
    """Every forward of this process recorded in ``forwards`` under
    ``phase[0]``: its rows, the kernels' launches in it and a digest of
    its outputs. Returns the undo."""
    forward = StreamingDetector._forward

    def recording(self, clip_u8, *rest):
        before = eval_launches()
        outs = forward(self, clip_u8, *rest)
        after = eval_launches()
        forwards.append({"phase": phase[0], "rows": len(clip_u8),
                         "launches": {k: after[k] - before[k]
                                      for k in after},
                         "digest": _digest(outs)})
        return outs

    StreamingDetector._forward = recording

    def undo():
        StreamingDetector._forward = forward
    return undo


def _keep_batches(det: StreamingDetector, sink: list) -> None:
    """Keep each batch ``det._detect_core`` runs and its outputs."""
    core = det._detect_core

    def keeping(*batch):
        outs = core(*batch)
        sink.append(([np.array(a) for a in batch], outs))
        return outs

    det._detect_core = keeping


def drive(pool: StreamingDetectorPool, ticks: int) -> list:
    """Each started stream pushes its frame a tick, then one step; the
    steps' timings."""
    frames = [stream_frames(i) for i in range(len(STARTS))]
    timing = []
    for tick in range(ticks):
        for i, start in enumerate(STARTS):
            if tick >= start:
                pool.push_frame(i, frames[i][(tick - start)
                                             % FRAMES_PER_STREAM])
        pool.step()
        timing += pool.last_timing
    return timing


def differences(got: list, want: list, size: int) -> dict:
    """The largest absolute difference of scores, actor probabilities and
    boxes (over ``size``) between two forwards' outputs."""
    return {"scores": float(np.abs(got[0] - want[0]).max()),
            "boxes": float(np.abs(got[1] - want[1]).max()) / size,
            "actor_prob": float(np.abs(got[2] - want[2]).max())}


def by_bucket(runs: list, refs: list, streams: list, size: int) -> dict:
    """``differences`` of each forward of ``runs`` (batch, outputs) from
    the same forward of ``refs`` on its ``streams`` rows, by bucket."""
    return {len(b[0]): differences([o[:n] for o in outs[:3]],
                                   [o[:n] for o in want[:3]], size)
            for (b, outs), (_, want), n in zip(runs, refs, streams)}


def http_client(port: int, window: int, out: list, errors: list) -> None:
    """HTTP_STREAMS streams pushed in turn up to each of two keyframes,
    each keyframe's results waited for before the next frames."""
    from tubelet_transformer_tpu_torch.client import DetectionClient

    try:
        client = DetectionClient(f"http://127.0.0.1:{port}", timeout_s=300)
        streams = [client.open_stream() for _ in range(HTTP_STREAMS)]
        frames = [stream_frames(i) for i in range(HTTP_STREAMS)]
        out += [[] for _ in streams]
        for lo, hi in ((0, window), (window, window + 8)):
            for n in range(lo, hi):
                for s, f in zip(streams, frames):
                    s.push(f[n % FRAMES_PER_STREAM])
            for s, got in zip(streams, out):
                n = len(got)
                deadline = time.time() + 300
                while len(got) == n and time.time() < deadline:
                    got += s.results(timeout_s=60, full_scores=True)
        for s in streams:
            s.close()
    except Exception as e:  # the check reads it
        errors.append(repr(e))


def http_differences(got: list, alone: list, side: float) -> dict:
    """Each HTTP stream's wire results against its one-process detector's
    keyframes: the same frame indices and detection counts, and the
    largest absolute differences."""
    diff = {"scores": 0.0, "boxes": 0.0, "actor_prob": 0.0}
    same = True
    for results, want in zip(got, alone):
        same &= [r["frame_index"] for r in results] == [
            r.frame_index for r in want]
        for r, w in zip(results, want):
            same &= len(r["detections"]) == len(w.detections)
            for d, e in zip(r["detections"], w.detections):
                diff["scores"] = max(diff["scores"], float(np.abs(
                    np.array(d["scores"]) - e.scores).max()))
                diff["boxes"] = max(diff["boxes"], float(np.abs(
                    np.array(d["box"]) - e.box).max()) / side)
                diff["actor_prob"] = max(diff["actor_prob"],
                                         abs(d["actor_prob"] - e.actor_prob))
    return {**diff, "same_keyframes": bool(same)}


def send_times(cfg, mesh: mesh_lib.Mesh) -> dict:
    """Rank 0: each bucket's clips and masks sent SEND_REPEATS times whole,
    and as each data shard's rows where MESH.DATA divides the bucket, in
    turn, each until every rank has them: the ms of each (None on the
    other ranks, which receive until the stop header)."""
    if not mesh_lib.is_main_process():
        while mesh_lib.receive_batch(mesh)[0][0]:
            mesh_lib.barrier()
        return None
    s, t = cfg.data.img_size, cfg.data.temp_len
    out = {}
    for b in (1, 2, 4, MAX_BATCH):
        arrays = [np.zeros((b, t, s, s, 3), np.uint8),
                  np.zeros((b, s, s), bool)]
        modes = [False] + ([True] if mesh.data > 1 and b % mesh.data == 0
                           else [])
        out[b] = {("rows" if m else "bucket"): [] for m in modes}
        for _ in range(SEND_REPEATS):
            for m in modes:
                t0 = time.perf_counter()
                mesh_lib.broadcast_batch([1, b], arrays, mesh, m)
                mesh_lib.barrier()
                out[b]["rows" if m else "bucket"].append(
                    (time.perf_counter() - t0) * 1e3)
        out[b]["mb"] = sum(a.nbytes for a in arrays) / 1e6
    mesh_lib.broadcast_batch([0], [], mesh)
    return out


def run(cfg, device: torch.device, seed: int = 0) -> Optional[dict]:
    """The check on this rank (module docstring); rank 0's result."""
    phase, forwards = ["reference"], []
    undo = record_forwards(phase, forwards)
    try:
        return _run(cfg, device, seed, phase, forwards)
    finally:
        undo()


def _run(cfg, device: torch.device, seed: int, phase: list,
         forwards: list) -> Optional[dict]:
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.serving_http import DetectionServer

    t0 = time.perf_counter()
    mesh = mesh_lib.create_mesh(cfg.mesh.data, cfg.mesh.model)
    lead = mesh_lib.is_main_process()
    window = cfg.data.temp_len * max(1, cfg.data.frame_rate)
    ticks = window + max(STARTS)
    size = cfg.data.img_size
    out: dict = {"mesh": (mesh.data, mesh.model)}
    kw = dict(KW, device=device)
    refs: list = []
    alone: list = []
    if lead:
        full = build_model(cfg, device=device, seed=seed)
        ref = StreamingDetectorPool(cfg, full, max_batch=MAX_BATCH, **kw)
        _keep_batches(ref._tpl, refs)
        drive(ref, ticks)
        for i in range(HTTP_STREAMS):
            det = StreamingDetector(cfg, full, **kw)
            alone.append([r for n in range(window + 8) if (r := det.push_frame(
                stream_frames(i)[n % FRAMES_PER_STREAM])) is not None])
        del full, ref, det
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dp_check.log_time("serve_check: the one-process reference")
    model = build_model(cfg, device=device, seed=seed, mesh=mesh)
    det = StreamingDetector(cfg, model, mesh=mesh, **kw)
    phase[0] = "pool"
    runs: list = []
    if lead:
        pool = StreamingDetectorPool(cfg, model, mesh=mesh,
                                     max_batch=MAX_BATCH, instrument=True,
                                     **kw)
        pool.warmup()
        _keep_batches(pool._tpl, runs)
        timing = drive(pool, ticks)
        pool.stop_followers()
        streams = [t["streams"] for t in timing]
        out["timing"] = timing
        out["pool"] = by_bucket(runs, refs, streams, size)
        dp_check.log_time("serve_check: the pool over the mesh")
    followed = [] if lead else [follow(det)]

    phase[0] = "control"
    _rebind(model, NoReduceMesh(mesh.data, mesh.rank, mesh.model))
    if lead:
        control = StreamingDetector(cfg, model, mesh=mesh, **kw)
        with torch.inference_mode():
            outs = [control._detect_core(*b) for b, _ in runs]
        control.stop_followers()
        out["control"] = by_bucket(
            [(b, o) for (b, _), o in zip(runs, outs)], refs, streams, size)
    else:
        followed.append(follow(det))
    _rebind(model, mesh)

    phase[0] = "http"
    if lead:
        srv = DetectionServer(cfg, model, host="127.0.0.1", port=0,
                              max_batch=MAX_BATCH, mesh=mesh, **KW)
        srv.start()
        got, errors = [], []
        client = threading.Thread(target=http_client,
                                  args=(srv.port, window, got, errors))
        client.start()
        client.join()
        srv.stop()
        out["http"] = http_differences(got, alone, max(GEOMETRY))
        out["http_errors"] = errors
        out["http_keyframes"] = [len(r) for r in got]
        dp_check.log_time("serve_check: the HTTP server over the mesh")
    else:
        followed.append(follow(det))

    phase[0] = "send"
    out["send_ms"] = send_times(cfg, mesh)
    every = mesh_lib.all_gather_objects(
        {"forwards": [f for f in forwards if f["phase"] != "reference"],
         "followed": followed})
    if not lead:
        return None
    out["forwards"] = [e["forwards"] for e in every]
    out["followed"] = [e["followed"] for e in every]
    out["reference_forwards"] = [f for f in forwards
                                 if f["phase"] == "reference"]
    # the control's peers pass on partial sums of their own
    digests = [[f["digest"] for f in e["forwards"] if f["phase"] != "control"]
               for e in every]
    out["peers_equal"] = all(digests[r] == digests[r - r % mesh.model]
                             for r in range(len(every)))
    out["wall_s"] = time.perf_counter() - t0
    return out


def main(argv: Optional[list] = None, keep_group: bool = False) -> None:
    """The command line (``argv``, else ``sys.argv``); with
    ``keep_group`` the process group stays joined for the next tool of
    the launch (``tools/mesh_checks.py``)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--data", type=int, default=None,
                   help="MESH.DATA (default: the config's)")
    p.add_argument("--model", type=int, default=None,
                   help="MESH.MODEL (default: the config's)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:<LOCAL_RANK>)")
    p.add_argument("--dist-backend", default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--deterministic", action="store_true",
                   help="torch.use_deterministic_algorithms(True)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    from tubelet_transformer_tpu_torch.config import load_config

    device = (torch.device(args.device) if args.device
              else mesh_lib.default_device())
    cfg = load_config(args.config_file)
    if args.data is not None:
        cfg.mesh.data = args.data
    if args.model is not None:
        cfg.mesh.model = args.model
    mesh_lib.init_distributed(device, args.dist_backend)
    dp_check.log_time("serve_check: the process group joined")
    try:
        result = run(cfg, device, args.seed)
        if result is not None:
            torch.save(result, args.out)
            print(f"serve_check: pool {result['pool']}; control "
                  f"{result['control']}; http {result['http']}; model "
                  f"peers bit-equal {result['peers_equal']}; followed "
                  f"{result['followed']}", flush=True)
    finally:
        if not keep_group:
            mesh_lib.shutdown()


if __name__ == "__main__":
    main()
