"""Mesh serving (MESH.MODEL, with MESH.DATA beside it) of the PyTorch port:
rank 0 leads every rank's forwards, the other ranks follow
(``serving.follow``). Ranks on the CPU over gloo, each a process started
from this file (``python tests/test_torch_mesh_serving.py worker <job>``,
torchrun's environment set by hand, as
tests/test_torch_data_parallel.py starts them). CSN-TINY at
tests/test_serving.py's ``_cfg`` widths, float32, with the long-term
memory on (3 keyframes x 2 slots) and an actor threshold of -1, so that
every query is a detection and a memory slot.

* The StreamingDetector (one stream, bucket 1) and the
  StreamingDetectorPool (six streams: buckets 4 padded, 2 and 1) under
  MESH.MODEL 2 (2 ranks), DATA 2 x MODEL 2 (4 ranks: buckets 4 and 2
  split over 'data', bucket 1 whole on each data group) and MESH.MODEL 3
  (3 ranks: the attentions' heads undivided, q, k and v a peer) against
  the JAX package's detector and pool on ``create_mesh(1, 2)``,
  ``create_mesh(2, 2)`` and ``create_mesh(1, 3)`` of conftest's host
  devices, from the same
  variables (crossed over by ``convert.py``) on the same frames, with
  tests/test_serving.py's tolerances (boxes 1e-3, scores 1e-4, the
  keyframes, memory sizes and detection counts equal); and against the
  port's one-process detector and pool to float32 rounding (SELF_TOL).
  The model peers' outputs are bit-equal in every forward, and each
  follower ran as many forwards as rank 0 led, warmup included.
* The HTTP server on 127.0.0.1 under MODEL 2: a client's results equal
  the one-process server's, and ``stop()`` ends the follower. Then the
  ``serve`` CLI on a YAML with MESH.MODEL 2 on the same ranks: rank 0's
  lines equal the one-process CLI's, and rank 1 prints nothing; and the
  ``serve_http`` CLI: a client's results equal a one-process server's,
  and Ctrl-C (SIGINT) ends it and its follower.
* With the groups' TIMEOUT cut to a few seconds: a leader idle past it
  still serves the next push; then a step that raises on rank 0 ends
  both ranks with a non-zero exit, neither hanging.

One JAX process runs the three meshes (at ``JAX_XLA_FLAGS``) and writes the
variables first, on which the port's ranks start at once. Every
subprocess runs under a timeout of at most 300 s and is killed when it
runs out; the temporary files go when the module's tests end.
"""

import contextlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401

from test_torch_data_parallel import (
    SELF_TOL, TIMEOUT, _kill, _load, _ready, _save, _start, _wait)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# MODEL 3 divides none of the attentions' 4 heads: each packed projection
# is cut into its q, k and v rows, one a peer, the rest replicated
MESHES = {"model2": (1, 2), "data2_model2": (2, 2), "model3": (1, 3)}
KW = dict(fps=8.0, detect_every=8, actor_threshold=-1.0,
          memory_keyframes=3, memory_slots=2)
SINGLE = dict(n=24, seed=3)        # two keyframes, at frames 16 and 24
# the pool's streams: (start tick, source geometry); with a step every tick
# the pool runs a, b, c in bucket 4 (padded) at ticks 15 and 23, d, e in
# bucket 2 at 19 and 27, f alone in bucket 1 at 21
POOL_STREAMS = {"a": (0, (48, 64)), "b": (0, (32, 48)), "c": (0, (40, 30)),
                "d": (4, (48, 64)), "e": (4, (32, 48)), "f": (6, (40, 30))}
POOL_TICKS = 28
MAX_BATCH = 4
# the idle and failure launch: the groups' TIMEOUT, and the leader's idle
FAULT_TIMEOUT_S = 4.0
IDLE_S = 2 * FAULT_TIMEOUT_S


def small_cfg(use_lfb=True):
    """tests/test_serving.py's ``_cfg`` on the port's Config."""
    from tubelet_transformer_tpu_torch.config import Config

    cfg = Config()
    cfg.data.dataset_name = "ava"
    cfg.data.num_classes = 5
    cfg.data.img_size = 32
    cfg.data.temp_len = 8
    cfg.data.frame_rate = 2
    cfg.model.backbone_name = "CSN-TINY"
    cfg.model.query_num = 5
    cfg.model.temp_len = 8
    cfg.model.enc_layers = 1
    cfg.model.dec_layers = 2
    cfg.model.d_model = 64
    cfg.model.nhead = 4
    cfg.model.dim_feedforward = 64
    cfg.model.compute_dtype = "float32"
    cfg.model.temporal_ds_strategy = "avg"
    cfg.use_lfb = use_lfb
    return cfg


def _frames(n, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def _pool_frames():
    return {sid: _frames(POOL_TICKS, h, w, seed=10 + i)
            for i, (sid, (_, (h, w))) in enumerate(POOL_STREAMS.items())}


def _record(res):
    """A KeyframeResult (the JAX package's or the port's) as plain data."""
    return {"frame_index": res.frame_index, "memory_size": res.memory_size,
            "boxes": np.array([d.box for d in res.detections]),
            "scores": np.array([d.scores for d in res.detections]),
            "actor_prob": np.array([d.actor_prob for d in res.detections])}


def run_single(det):
    return [_record(r) for f in _frames(SINGLE["n"], seed=SINGLE["seed"])
            if (r := det.push_frame(f)) is not None]


def run_pool(pool):
    """Every started stream pushes its frame each tick, then one step:
    each stream's records."""
    frames, out = _pool_frames(), {sid: [] for sid in POOL_STREAMS}
    for tick in range(POOL_TICKS):
        for sid, (start, _) in POOL_STREAMS.items():
            if tick >= start:
                pool.push_frame(sid, frames[sid][tick - start])
        for sid, res in pool.step().items():
            out[sid].append(_record(res))
    return out


# ---------------------------------------------------------------- JAX

def jax_worker(job_path):
    """The JAX detector and pool on each mesh (MESHES): the variables to
    <out>.vars first, then the records to <out>.0."""
    import jax
    from test_serving import _cfg

    from tubelet_transformer_tpu.parallel import mesh as jmesh
    from tubelet_transformer_tpu.serving import (StreamingDetector,
                                                 StreamingDetectorPool)

    jax.config.update("jax_platforms", "cpu")
    job = _load(job_path)
    try:
        cfg = _cfg(use_lfb=True)
        base = StreamingDetector(cfg, **KW)
        variables = jax.device_get(base.variables)
        _save({k: variables[k] for k in ("params", "batch_stats")},
              f"{job['out']}.vars")
        out = {}
        for name, (data, model) in MESHES.items():
            mesh = jmesh.create_mesh(data, model,
                                     devices=jax.devices()[:data * model])
            det = StreamingDetector(cfg, base.variables, mesh=mesh, **KW)
            pool = StreamingDetectorPool(cfg, base.variables, mesh=mesh,
                                         max_batch=MAX_BATCH, infer_chunk=0,
                                         **KW)
            out[name] = {"single": run_single(det), "pool": run_pool(pool)}
        _save(out, f"{job['out']}.0")
    except BaseException:
        import traceback

        Path(f"{job['out']}.failed").write_text(traceback.format_exc())
        raise


# ---------------------------------------------------------------- worker

def _port_model(vars_path):
    from tubelet_transformer_tpu_torch.convert import load_jax_variables
    from tubelet_transformer_tpu_torch.models.tuber import build_model

    v = _load(vars_path)
    return load_jax_variables(build_model(small_cfg()), v["params"],
                              v["batch_stats"])


def _client_run(port):
    """``tools/serve_check``'s HTTP client: its streams pushed up to each of
    two keyframes (frames 16 and 24), each keyframe's results (full
    scores) waited for; each stream's results."""
    from tubelet_transformer_tpu_torch.tools import serve_check

    out, errors = [], []
    serve_check.http_client(port, 16, out, errors)
    assert not errors, errors
    return out


def _server(cfg, model, mesh, **kw):
    from tubelet_transformer_tpu_torch.serving_http import DetectionServer

    return DetectionServer(cfg, model, host="127.0.0.1", port=0,
                           max_batch=MAX_BATCH, device="cpu", mesh=mesh,
                           **{**KW, **kw})


# the serving CLIs' random weights: seed 7's actor probabilities pass the
# serve CLI's gate of 0.8 on its synthetic frames
CLI_SEED = 7
HTTP_CLI_ARGS = ["--max-batch", "4", "--fps", "8", "--detect-every", "8",
                 "--actor-threshold", "-1"]


@contextlib.contextmanager
def _cli(argv):
    """``argv`` as the command line, the process group kept past the CLI's
    own ``shutdown`` (the job's next CLI and the worker's results need
    it), and what the CLI prints captured: yields the buffer."""
    from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib

    saved, shutdown, buf = sys.argv, mesh_lib.shutdown, io.StringIO()
    sys.argv = argv
    mesh_lib.shutdown = lambda: None
    try:
        with contextlib.redirect_stdout(buf):
            yield buf
    finally:
        sys.argv, mesh_lib.shutdown = saved, shutdown


def run_cli(yaml_path):
    """The ``serve`` CLI on ``yaml_path`` (the synthetic frames), on the
    CPU: what it printed."""
    from tubelet_transformer_tpu_torch.cli import serve

    with _cli(["serve", "--config-file", str(yaml_path), "--device", "cpu",
               "--num-frames", "24", "--fps", "8", "--detect-every", "8",
               "--seed", str(CLI_SEED)]) as buf:
        serve.main()
    return buf.getvalue()


def run_http_cli(yaml_path):
    """The ``serve_http`` CLI on ``yaml_path`` on 127.0.0.1 (a port of its
    choice), on the CPU: on rank 0, a client thread reads the port from
    its "serving on" line, runs ``_client_run`` and ends the CLI as Ctrl-C
    would (SIGINT); the other ranks follow. Returns what it printed and
    the client's results."""
    from tubelet_transformer_tpu_torch.cli import serve_http
    from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib

    got, errors = [], []
    with _cli(["serve_http", "--config-file", str(yaml_path), "--device",
               "cpu", "--host", "127.0.0.1", "--port", "0", "--seed",
               str(CLI_SEED), *HTTP_CLI_ARGS]) as buf:
        def client():
            try:
                deadline = time.time() + 120
                while (m := re.search(r"serving on http://127.0.0.1:(\d+)",
                                      buf.getvalue())) is None:
                    assert time.time() < deadline, "no serving line"
                    time.sleep(0.05)
                got.extend(_client_run(int(m.group(1))))
            except Exception as e:  # the test reads it
                errors.append(repr(e))
            finally:
                os.kill(os.getpid(), signal.SIGINT)

        thread = threading.Thread(target=client)
        if mesh_lib.is_main_process():
            thread.start()
        serve_http.main()
        if mesh_lib.is_main_process():
            thread.join(timeout=120)
    assert not errors, errors
    return buf.getvalue(), got


def _mesh_task(vars_path, mesh_shape, http, cli_yaml=None):
    """The detector, then the pool, then with ``http`` the HTTP server,
    each led by rank 0 and followed by the others: rank 0's records and
    the pool's timings; every rank's forwards and follow counts. Then
    with ``cli_yaml`` the ``serve`` and ``serve_http`` CLIs on it: what
    each rank printed, and rank 0's client results."""
    from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
    from tubelet_transformer_tpu_torch.serving import (StreamingDetector,
                                                       StreamingDetectorPool,
                                                       follow)
    from tubelet_transformer_tpu_torch.tools import serve_check

    cfg = small_cfg()
    mesh = mesh_lib.create_mesh(*mesh_shape)
    _ready([vars_path])
    model = _port_model(vars_path)
    forwards, out = [], {"followed": []}
    serve_check.record_forwards(["mesh"], forwards)
    det = StreamingDetector(cfg, model, mesh=mesh, device="cpu", **KW)
    out["split"] = getattr(model, "tp", None) is mesh
    lead = mesh_lib.is_main_process()
    if lead:
        out["single"] = run_single(det)
        det.stop_followers()
        pool = StreamingDetectorPool(cfg, model, mesh=mesh, device="cpu",
                                     max_batch=MAX_BATCH, instrument=True,
                                     **KW)
        pool.warmup()
        out["pool"] = run_pool(pool)
        pool.stop_followers()
        out["pool_timing"] = pool.last_timing
        if http:
            srv = _server(cfg, model, mesh)
            srv.start()
            try:
                out["http"] = _client_run(srv.port)
            finally:
                srv.stop()
    else:
        for _ in range(3 if http else 2):
            out["followed"].append(follow(det))
    out["forwards"] = forwards
    if cli_yaml is not None:
        out["cli"] = run_cli(cli_yaml)
        out["http_cli"] = run_http_cli(cli_yaml)
    return out


def _fault_task(out_prefix):
    """Rank 0: a server that idles past the groups' TIMEOUT, then serves a
    stream's keyframe (written to <out>.idle), then a server whose first
    step raises on rank 0. The other rank follows both."""
    from tubelet_transformer_tpu_torch.client import DetectionClient
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib
    from tubelet_transformer_tpu_torch.serving import (StreamingDetector,
                                                       follow)

    cfg = small_cfg(use_lfb=False)
    mesh = mesh_lib.create_mesh(1, 2)
    model = build_model(cfg, mesh=mesh)
    if not mesh_lib.is_main_process():
        det = StreamingDetector(cfg, model, mesh=mesh, device="cpu", **KW)
        _save({"followed": follow(det)}, f"{out_prefix}.followed")
        follow(det)                       # ends when rank 0 dies
        return {}
    srv = _server(cfg, model, mesh)
    srv.start()
    time.sleep(IDLE_S)
    client = DetectionClient(f"http://127.0.0.1:{srv.port}", timeout_s=60)
    with client.open_stream() as stream:
        for f in _frames(16, seed=5):
            stream.push(f)
        got = stream.results(timeout_s=60)
    srv.stop()
    _save({"results": got}, f"{out_prefix}.idle")
    srv = _server(cfg, model, mesh, warmup=False)

    def failing(*a, **k):
        raise RuntimeError("a forward that fails on rank 0")

    srv.pool._tpl._forward = failing
    srv.start()
    client = DetectionClient(f"http://127.0.0.1:{srv.port}", timeout_s=60)
    with client.open_stream() as stream:
        for f in _frames(16, seed=5):
            stream.push(f)
        stream.results(timeout_s=60)     # the scheduler ends the process
    time.sleep(60)
    return {}


def worker(job_path):
    """One rank of a job: {"kind": "mesh" or "fault", ...}; the results
    to <out>.<rank>. A fault job first meets its peers at a file barrier,
    then joins the group at FAULT_TIMEOUT_S."""
    from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    job = _load(job_path)
    task = job["tasks"]
    rank = int(os.environ["RANK"])
    if task["kind"] == "fault":
        Path(f"{job['out']}.up.{rank}").touch()
        _ready([f"{job['out']}.up.{r}" for r in range(2)])
        mesh_lib.TIMEOUT = timedelta(seconds=FAULT_TIMEOUT_S)
    mesh_lib.init_distributed("cpu", "gloo")
    try:
        if task["kind"] == "mesh":
            result = _mesh_task(task["vars"], task["mesh"], task["http"],
                                task.get("cli"))
        else:
            result = _fault_task(job["out"])
        _save(result, f"{job['out']}.{rank}")
    finally:
        mesh_lib.shutdown()


# ---------------------------------------------------------------- parent

def _mesh_cfg(name):
    cfg = small_cfg()
    cfg.mesh.data, cfg.mesh.model = MESHES[name]
    return cfg


def _wait_failing(procs, timeout=TIMEOUT):
    """Wait for every rank (killing them all when ``timeout`` runs out):
    (exit codes, whether every rank ended by itself, the logs)."""
    deadline = time.time() + timeout
    ended = True
    for p, _ in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            ended = False
    _kill(procs)
    logs = []
    for _, log in procs:
        log.seek(0)
        logs.append(log.read())
        log.close()
    return [p.returncode for p, _ in procs], ended, logs


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every process of this file, started at once: the JAX process, the
    2-rank MODEL 2 job (detector, pool, HTTP), the 4-rank DATA 2 x
    MODEL 2 job (detector, pool), the 3-rank MODEL 3 job (detector, pool)
    and the 2-rank idle and failure job;
    then the port's one-process detector, pool and server on the JAX
    variables, here. The temporary files go when the module's tests end."""
    tmp = tmp_path_factory.mktemp("mesh_serving")
    for name, model in (("cli_one", 1), ("cli_mesh", 2)):
        (tmp / f"{name}.yaml").write_text(_cli_yaml(model))
    jax_out = tmp / "jax.out"
    vars_path = f"{jax_out}.vars"
    launched = []
    try:
        launched.append(_start(tmp, {}, "jax", world=1, mode="jax",
                               script=__file__))
        for name, (data, model) in MESHES.items():
            launched.append(_start(tmp, {"kind": "mesh", "vars": vars_path,
                                         "mesh": (data, model),
                                         "http": name == "model2",
                                         "cli": (tmp / "cli_mesh.yaml"
                                                 if name == "model2"
                                                 else None)},
                                   name, world=data * model,
                                   script=__file__))
        fault = _start(tmp, {"kind": "fault"}, "fault", world=2,
                       script=__file__)
        launched.append(fault)
        _ready([vars_path])
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = _one_process(vars_path)
            one["cli"] = run_cli(tmp / "cli_one.yaml")
            one["http_cli"] = _one_process_http_cli(tmp / "cli_one.yaml")
        finally:
            torch.set_num_threads(n)
        jax_procs, jax_prefix = launched[0]
        jax_res, _ = _wait(jax_procs, jax_prefix)
        runs = {"jax": jax_res[0], "one": one, "tmp": tmp}
        for (procs, out), name in zip(launched[1:1 + len(MESHES)], MESHES):
            runs[name], _ = _wait(procs, out)
        rcs, ended, logs = _wait_failing(fault[0])
        runs["fault"] = {"rcs": rcs, "ended": ended, "logs": logs,
                         "out": fault[1]}
        yield runs
    finally:
        for procs, _ in launched:
            _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def _one_process_http_cli(yaml_path):
    """What the serve_http CLI serves in one process, as a DetectionServer
    of its settings here: the client's results."""
    from tubelet_transformer_tpu_torch.config import load_config
    from tubelet_transformer_tpu_torch.models.tuber import build_model
    from tubelet_transformer_tpu_torch.serving_http import DetectionServer

    cfg = load_config(str(yaml_path))
    opts = dict(zip(HTTP_CLI_ARGS[::2], map(float, HTTP_CLI_ARGS[1::2])))
    srv = DetectionServer(cfg, build_model(cfg, seed=CLI_SEED),
                          host="127.0.0.1", port=0, device="cpu",
                          max_batch=int(opts["--max-batch"]),
                          fps=opts["--fps"],
                          detect_every=int(opts["--detect-every"]),
                          actor_threshold=opts["--actor-threshold"])
    srv.start()
    try:
        return _client_run(srv.port)
    finally:
        srv.stop()


def _cli_yaml(model):
    """small_cfg's data and model sections as a YAML, on MESH.MODEL
    ``model``, the memory off."""
    cfg = small_cfg()
    lines = ["CONFIG:", "  DATA:"]
    lines += [f"    {k.upper()}: {getattr(cfg.data, k)}" for k in (
        "dataset_name", "num_classes", "img_size", "temp_len", "frame_rate")]
    lines += ["  MODEL:"]
    lines += [f"    {k.upper()}: {getattr(cfg.model, k)}" for k in (
        "backbone_name", "query_num", "temp_len", "enc_layers",
        "dec_layers", "d_model", "nhead", "dim_feedforward",
        "compute_dtype", "temporal_ds_strategy")]
    lines += ["  MESH:", f"    MODEL: {model}"]
    return "\n".join(lines) + "\n"


def _one_process(vars_path):
    """The port's one-process detector, pool and server on the JAX
    variables."""
    from tubelet_transformer_tpu_torch.serving import (StreamingDetector,
                                                       StreamingDetectorPool)

    cfg = small_cfg()
    model = _port_model(vars_path)
    out = {"single": run_single(StreamingDetector(cfg, model, device="cpu",
                                                  **KW)),
           "pool": run_pool(StreamingDetectorPool(
               cfg, model, device="cpu", max_batch=MAX_BATCH, **KW))}
    srv = _server(cfg, model, None)
    srv.start()
    try:
        out["http"] = _client_run(srv.port)
    finally:
        srv.stop()
    return out


def _assert_close(got, want, box_atol, atol):
    """Two runs' records: the same keyframes, memory sizes and detection
    counts; boxes (source pixels) within ``box_atol``, scores and actor
    probabilities within ``atol``."""
    assert [r["frame_index"] for r in got] == [r["frame_index"]
                                               for r in want]
    assert got and got[0]["memory_size"] == 0
    for g, w in zip(got, want):
        assert g["memory_size"] == w["memory_size"]
        assert g["boxes"].shape == w["boxes"].shape == (5, 4)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0,
                                   atol=box_atol)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(g["actor_prob"], w["actor_prob"], rtol=0,
                                   atol=atol)


def _held(got, want, box_atol, atol):
    _assert_close(got["single"], want["single"], box_atol, atol)
    assert [r["memory_size"] for r in got["single"]] == [0, 2]
    assert got["pool"].keys() == want["pool"].keys()
    for sid in POOL_STREAMS:
        _assert_close(got["pool"][sid], want["pool"][sid], box_atol, atol)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_serving_matches_jax_mesh(mesh_runs, mesh):
    """Rank 0's detector and pool records against the JAX detector's and
    pool's on the same mesh, at tests/test_serving.py's tolerances."""
    _held(mesh_runs[mesh][0], mesh_runs["jax"][mesh], 1e-3, 1e-4)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_serving_matches_one_process(mesh_runs, mesh):
    """The same records against the port's one-process detector and pool:
    float32 rounding apart (boxes in pixels of a 64-pixel side)."""
    _held(mesh_runs[mesh][0], mesh_runs["one"], 64 * SELF_TOL, SELF_TOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_ranks_run_every_forward_and_peers_agree(mesh_runs, mesh):
    """Every rank held the split model and ran rank 0's forwards: the
    detector's 2, the pool's warmup of buckets 1, 2 and 4 and its 5
    forwards (with DATA 2, buckets 4 and 2 as rows of 2 and 1 a shard,
    bucket 1 whole); each follower's ``follow`` counted them and returned;
    the model peers' outputs are bit-equal in every forward."""
    data, model = MESHES[mesh]
    runs = mesh_runs[mesh]
    whole = [1, 1, 1, 2, 4, 4, 2, 1, 4, 2]
    rows = [b // data if b % data == 0 else b for b in whole]
    for rank, r in enumerate(runs):
        assert r["split"], rank
        assert [f["rows"] for f in r["forwards"][:len(rows)]] == rows, rank
        if rank:
            assert r["followed"][:2] == [2, 8], rank
    for d in range(data):
        peers = [[f["digest"] for f in runs[d * model + m]["forwards"]]
                 for m in range(model)]
        assert all(p == peers[0] for p in peers), d
    timing = runs[0]["pool_timing"]
    assert [t["bucket"] for t in timing] == [2]
    assert all(t[k] >= 0 for t in timing for k in ("broadcast_ms",
                                                   "gather_ms"))


def test_http_under_model_matches_one_process_server(mesh_runs):
    """A client of rank 0's server under MODEL 2 gets the one-process
    server's results (each value within float32 rounding and one unit of
    the wire's rounding: 0.01 px boxes on a 320-pixel side, 1e-4
    scores), and ``stop()`` ends the follower, which followed the server's
    warmup and forwards."""
    _same_wire_results(mesh_runs["model2"][0]["http"],
                       mesh_runs["one"]["http"], [0, 2])
    follower = mesh_runs["model2"][1]
    # the server's warmup (buckets 1, 2, 4), then its forwards
    assert follower["followed"][2] >= 3 + 2


def _same_wire_results(got, want, memory_sizes):
    """Two clients' results of ``_client_run``: the same keyframes and
    memory sizes, each value within float32 rounding and one unit of the
    wire's rounding."""
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert [r["frame_index"] for r in g] == [r["frame_index"]
                                                 for r in w] == [8, 16]
        assert [r["memory_size"] for r in g] == [r["memory_size"]
                                                 for r in w] == memory_sizes
        for rg, rw in zip(g, w):
            assert len(rg["detections"]) == len(rw["detections"]) == 5
            for dg, dw in zip(rg["detections"], rw["detections"]):
                np.testing.assert_allclose(dg["box"], dw["box"], rtol=0,
                                           atol=0.01 + 320 * SELF_TOL)
                np.testing.assert_allclose(dg["scores"], dw["scores"],
                                           rtol=0, atol=1e-4 + SELF_TOL)
                assert abs(dg["actor_prob"] - dw["actor_prob"]) \
                    <= 1e-4 + SELF_TOL


def test_serve_http_cli_under_model_serves_from_rank_zero(mesh_runs):
    """The ``serve_http`` CLI on a YAML with MESH.MODEL 2, on the MODEL 2
    job's ranks: rank 0 serves (its one line), a client's results equal
    those of a one-process server of the CLI's settings, Ctrl-C ends it
    and its follower, which prints nothing."""
    printed, got = mesh_runs["model2"][0]["http_cli"]
    assert re.fullmatch(r"serving on http://127\.0\.0\.1:\d+ \(device="
                        r"cpu, max_batch=4\)\n", printed), printed
    assert mesh_runs["model2"][1]["http_cli"] == ("", [])
    _same_wire_results(got, mesh_runs["one"]["http_cli"], [0, 0])


def test_serve_cli_under_model_prints_from_rank_zero(mesh_runs):
    """The ``serve`` CLI on a YAML with MESH.MODEL 2, on the MODEL 2 job's
    ranks: rank 0's keyframe lines are the one-process CLI's (each value
    within float32 rounding and one unit of the line's rounding), then
    its summary line; rank 1 follows and prints nothing."""
    got = [json.loads(x) for x in mesh_runs["model2"][0]["cli"].splitlines()]
    want = [json.loads(x) for x in mesh_runs["one"]["cli"].splitlines()]
    assert mesh_runs["model2"][1]["cli"] == ""
    assert len(got) == len(want) == 3
    assert got[-1]["summary"]["keyframes"] == want[-1]["summary"][
        "keyframes"] == 2
    for g, w in zip(got[:2], want[:2]):
        assert (g["keyframe"], g["time_s"], g["memory_tokens"]) == (
            w["keyframe"], w["time_s"], w["memory_tokens"])
        assert len(g["detections"]) == len(w["detections"]) == 5
        for dg, dw in zip(g["detections"], w["detections"]):
            np.testing.assert_allclose(dg["box"], dw["box"], rtol=0,
                                       atol=0.1 + 64 * SELF_TOL)
            assert abs(dg["actor"] - dw["actor"]) <= 1e-3 + SELF_TOL
            np.testing.assert_allclose(dg["top_actions"], dw["top_actions"],
                                       rtol=0, atol=1e-3 + SELF_TOL)


def test_idle_leader_past_timeout_still_serves(mesh_runs):
    """With the groups' TIMEOUT at FAULT_TIMEOUT_S, a server idle for
    twice as long after its warmup serves the next stream's keyframe; the
    follower was still there to follow it, and returned on stop()."""
    out = mesh_runs["fault"]["out"]
    idle = _load(f"{out}.idle")["results"]
    assert [r["frame_index"] for r in idle] == [8]
    assert len(idle[0]["detections"]) == 5
    # the warmup's 3 buckets and the keyframe's forward
    assert _load(f"{out}.followed")["followed"] == 4


def test_failed_step_ends_every_rank(mesh_runs):
    """A step that raises on rank 0 under the mesh: rank 0 prints it and
    exits 1, the follower exits non-zero, and neither hangs."""
    fault = mesh_runs["fault"]
    assert fault["ended"], fault["logs"]
    assert fault["rcs"][0] == 1, fault["logs"][0][-3000:]
    assert fault["rcs"][1] not in (0, None), fault["logs"][1][-3000:]
    assert ("scheduler: step failed: RuntimeError: a forward that fails "
            "on rank 0") in fault["logs"][0]


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
elif __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    jax_worker(sys.argv[2])
