"""The PyTorch port imports no JAX: every module of the package, its
serving loop, its trainer and its CLIs load in a fresh interpreter that
then holds no jax, flax, optax or orbax module."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import tubelet_transformer_tpu_torch as port

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix="tubelet_transformer_tpu_torch."))
    assert {"tubelet_transformer_tpu_torch.serving",
            "tubelet_transformer_tpu_torch.cli.serve",
            "tubelet_transformer_tpu_torch.cli.train_ava",
            "tubelet_transformer_tpu_torch.train.engine"} <= set(modules)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
