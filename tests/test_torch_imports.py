"""The PyTorch port imports no JAX and nothing of the JAX package: every
module of the package, its serving loop, its trainer and its CLIs load in a
fresh interpreter that then holds no jax, flax, optax or orbax module and
no ``tubelet_transformer_tpu`` module; and no import statement of the port
or of ``chip_smoke.py``, at any depth of the code, names the JAX
package. The train path loads without scipy."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import tubelet_transformer_tpu_torch as port
from torch_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
JAX_PACKAGE = "tubelet_transformer_tpu"


def test_port_imports_no_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix="tubelet_transformer_tpu_torch."))
    assert {"tubelet_transformer_tpu_torch.serving",
            "tubelet_transformer_tpu_torch.cli.serve",
            "tubelet_transformer_tpu_torch.cli.train_ava",
            "tubelet_transformer_tpu_torch.train.engine",
            "tubelet_transformer_tpu_torch.data.packed",
            "tubelet_transformer_tpu_torch.eval.ava_eval",
            "tubelet_transformer_tpu_torch.cli.eval_ava",
            "tubelet_transformer_tpu_torch.cli.train_jhmdb",
            "tubelet_transformer_tpu_torch.cli.eval_jhmdb",
            "tubelet_transformer_tpu_torch.data.jhmdb",
            "tubelet_transformer_tpu_torch.eval.np_box",
            "tubelet_transformer_tpu_torch.eval.ucf_eval",
            "tubelet_transformer_tpu_torch.eval.video_map",
            "tubelet_transformer_tpu_torch.tools.fixtures",
            "tubelet_transformer_tpu_torch.serving_http",
            "tubelet_transformer_tpu_torch.client",
            "tubelet_transformer_tpu_torch.eval.lfb",
            "tubelet_transformer_tpu_torch.cli.serve_http",
            "tubelet_transformer_tpu_torch.cli.generate_lfb",
            "tubelet_transformer_tpu_torch.models.moe",
            "tubelet_transformer_tpu_torch.profiling",
            "tubelet_transformer_tpu_torch.models.segmentation",
            "tubelet_transformer_tpu_torch.train.classify",
            "tubelet_transformer_tpu_torch.ops.streaming",
            "tubelet_transformer_tpu_torch.plots",
            "tubelet_transformer_tpu_torch.cli.export_torch",
            "tubelet_transformer_tpu_torch.cli.pack_data",
            "tubelet_transformer_tpu_torch.parallel",
            "tubelet_transformer_tpu_torch.parallel.mesh",
            "tubelet_transformer_tpu_torch.parallel.zero",
            "tubelet_transformer_tpu_torch.tools.dp_check",
            "tubelet_transformer_tpu_torch.tools.tp_check",
            "tubelet_transformer_tpu_torch.tools.mesh_checks",
            "tubelet_transformer_tpu_torch.ops.cuda.assign"} <= set(modules)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"('jax', 'flax', 'optax', 'orbax', {JAX_PACKAGE!r}))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_train_path_imports_no_scipy():
    """The train CLIs, the step and the matcher load without scipy: the
    assignment is solved by the port's own kernel and plain version."""
    code = ("import sys\n"
            "import tubelet_transformer_tpu_torch.cli.train_ava\n"
            "import tubelet_transformer_tpu_torch.cli.train_jhmdb\n"
            "import tubelet_transformer_tpu_torch.train.engine\n"
            "import tubelet_transformer_tpu_torch.ops.matcher\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == "
            "'scipy')\n"
            "assert not bad, bad[:5]\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported(path: Path):
    """Every module name that an import statement of ``path`` names."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*(ROOT / "tubelet_transformer_tpu_torch").rglob("*.py"),
     ROOT / "chip_smoke.py"]), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_names_the_jax_package(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in (JAX_PACKAGE, "jax", "flax", "optax",
                                  "orbax")]
    assert not bad, bad
