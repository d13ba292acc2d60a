"""The port's entry points of this slice on the CPU: the ``export_torch``
CLI against the JAX package's ``export_tuber_pth`` (the same keys and
bit-equal tensors for the same weights, with and without the ``module.``
prefix, for each temporal pooling strategy, from a reference ``.pth`` and
from the port's own ``ckpt_epoch_N``) and its refusals; the ``pack_data``
CLI against ``pack_jhmdb``; the PR-curve panel that ``validate_ava`` draws
beside its dump; and each new CLI's ``--help`` without JAX. CSN-TINY,
float32."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from test_torch_csn import randomize_bn
from torch_fixtures import one_torch_thread  # noqa: F401

from tubelet_transformer_tpu.config import load_config as jload_config
from tubelet_transformer_tpu.models.tuber import build_model as jbuild_model
from tubelet_transformer_tpu.train import torch_convert as tc
from tubelet_transformer_tpu_torch import convert
from tubelet_transformer_tpu_torch.cli import export_torch, pack_data, runner
from tubelet_transformer_tpu_torch.config import load_config
from tubelet_transformer_tpu_torch.data import packed
from tubelet_transformer_tpu_torch.models.tuber import build_model
from tubelet_transformer_tpu_torch.tools import fixtures

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = ("avg", "max", "decode", "middle")


def _tree(strategy="avg", **model):
    return {"CONFIG": {
        "DATA": {"NUM_CLASSES": 5, "IMG_SIZE": 64, "TEMP_LEN": 8},
        "MODEL": {"BACKBONE_NAME": "CSN-TINY", "QUERY_NUM": 5,
                  "TEMP_LEN": 8, "ENC_LAYERS": 1, "DEC_LAYERS": 2,
                  "D_MODEL": 64, "NHEAD": 4, "DIM_FEEDFORWARD": 64,
                  "COMPUTE_DTYPE": "float32",
                  "TEMPORAL_DS_STRATEGY": strategy, "LOAD": True, **model}}}


def _write(path: Path, tree) -> Path:
    path.write_text(yaml.safe_dump(tree))
    return path


def _export(monkeypatch, cfg_path, out, *flags) -> dict:
    monkeypatch.setattr(sys, "argv", [
        "export_torch", "--config-file", str(cfg_path), "--out", str(out),
        "--device", "cpu", *flags])
    export_torch.main()
    return torch.load(out, map_location="cpu", weights_only=True)["model"]


def _assert_same_file(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _jax_variables(cfg_path: Path, seed: int):
    """JAX variables of the YAML's model (random port weights from ``seed``
    through the JAX package's own import, BN affines and statistics
    randomised), and its JAX config."""
    jcfg = jload_config(str(cfg_path))
    model = build_model(load_config(str(cfg_path)), seed=seed, train=True)
    params, stats = tc.tuber_params_from_torch_state(
        {k: v.numpy() for k, v in model.state_dict().items()},
        block_nums=model.backbone.body.block_nums, enc_layers=1,
        dec_layers=2, temporal_ds_strategy=jcfg.model.temporal_ds_strategy)
    randomize_bn(params, stats, np.random.default_rng(seed))
    return jcfg, params, stats


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_export_matches_jax(tmp_path, monkeypatch, strategy):
    """The port's export of a JAX export (loaded as a reference .pth) is
    that file, bit for bit, with and without ``--no-ddp-prefix``; and the
    port's export of its own ckpt_epoch_N holding the same weights too."""
    cfg_path = _write(tmp_path / "a.yaml", _tree(strategy))
    jcfg, params, stats = _jax_variables(cfg_path, STRATEGIES.index(strategy))
    for prefix in (True, False):
        ref = tmp_path / f"jax_{prefix}.pth"
        tc.export_tuber_pth(str(ref), params, stats, jcfg, ddp_prefix=prefix)
        want = torch.load(ref, map_location="cpu", weights_only=True)["model"]
        assert all(k.startswith("module.") == prefix for k in want)
        tree = _tree(strategy, PRETRAINED_PATH=str(ref))
        got = _export(monkeypatch, _write(tmp_path / "b.yaml", tree),
                      tmp_path / f"port_{prefix}.pth",
                      *(() if prefix else ("--no-ddp-prefix",)))
        _assert_same_file(got, want)

    # from the port's own checkpoint of the same weights
    model = convert.load_jax_variables(
        build_model(load_config(str(cfg_path)), train=True), params, stats)
    ckpt = tmp_path / "ckpt_epoch_0"
    torch.save({"model": model.state_dict(), "epoch": 0}, ckpt)
    tree = _tree(strategy, PRETRAINED_PATH=str(ckpt))
    got = _export(monkeypatch, _write(tmp_path / "c.yaml", tree),
                  tmp_path / "port_ckpt.pth")
    _assert_same_file(got, torch.load(tmp_path / "jax_True.pth",
                                      map_location="cpu",
                                      weights_only=True)["model"])


def test_jax_export_drops_the_prenorm_encoder_norm():
    """A pre-norm TubeR's JAX params hold ``transformer.encoder_norm``
    (models/transformer.py:117 there), and the JAX package's export writes
    no key for it: the reason the port's export refuses pre-norm."""
    jcfg = jload_config(None, {"MODEL": _tree()["CONFIG"]["MODEL"]
                               | {"NORMALIZE_BEFORE": True},
                               "DATA": _tree()["CONFIG"]["DATA"]})
    jmodel = jbuild_model(jcfg)
    variables = jax.device_get(jax.jit(
        lambda k, x: jmodel.init(k, x, train=False))(
            jax.random.PRNGKey(0), np.zeros((1, 8, 64, 64, 3), np.float32)))
    assert "encoder_norm" in variables["params"]["transformer"]
    sd = tc.tuber_torch_state_from_params(
        variables["params"], variables["batch_stats"],
        block_nums=(1, 1, 1, 1), enc_layers=1, dec_layers=2,
        temporal_ds_strategy="avg")
    assert not [k for k in sd if "encoder.norm" in k]
    port = build_model(load_config(None, {"MODEL": {
        **_tree()["CONFIG"]["MODEL"], "NORMALIZE_BEFORE": True}, "DATA":
        _tree()["CONFIG"]["DATA"]}))
    assert "transformer.encoder.norm.weight" in port.state_dict()


@pytest.mark.parametrize("option,message", [
    ({"MODEL": {"MOE_EXPERTS": 4}}, "MODEL.MOE_EXPERTS"),
    ({"USE_LFB": True}, "USE_LFB"),
    ({"MODEL": {"NORMALIZE_BEFORE": True}}, "MODEL.NORMALIZE_BEFORE"),
    ({"MODEL": {"LOAD": False}}, "MODEL.LOAD with PRETRAINED_PATH")])
def test_export_refusals(tmp_path, monkeypatch, option, message):
    """MoE and USE_LFB refused with the JAX CLI's reasons, pre-norm with
    the JAX export's omission, and no checkpoint as the JAX CLI refuses
    it; nothing is written."""
    tree = _tree(PRETRAINED_PATH=str(tmp_path / "missing.pth"))
    tree["CONFIG"]["MODEL"].update(option.get("MODEL", {}))
    tree["CONFIG"].update({k: v for k, v in option.items() if k != "MODEL"})
    out = tmp_path / "out.pth"
    with pytest.raises((NotImplementedError, ValueError), match=message):
        _export(monkeypatch, _write(tmp_path / "r.yaml", tree), out)
    assert not out.exists()


@pytest.mark.parametrize("module", ["export_torch", "pack_data"])
def test_cli_help_runs_without_jax(module):
    code = ("import runpy, sys\n"
            f"sys.argv = ['{module}', '--help']\n"
            "try:\n"
            f"    runpy.run_module('tubelet_transformer_tpu_torch.cli.{module}',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
            "'flax', 'optax', 'tubelet_transformer_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--config-file" in res.stdout


def _jhmdb_yaml(tmp_path: Path) -> Path:
    root = tmp_path / "jhmdb"
    fixtures.write_jhmdb_set(str(root), ["a/v0", "b/v1"], ["c/v2", "d/v3"],
                             6, num_classes=5, hw=(32, 40), seed=0)
    return _write(tmp_path / "jhmdb.yaml", {"CONFIG": {
        "DATA": {"DATASET_NAME": "jhmdb", "NUM_CLASSES": 5, "IMG_SIZE": 32,
                 "IMG_RESHAPE_SIZE": 36, "TEMP_LEN": 4,
                 "ANNO_PATH": str(root),
                 "DATA_PATH": str(root / "rgb-images")}}})


def test_pack_data_cli_matches_pack_jhmdb(tmp_path, monkeypatch, capsys):
    """The CLI's shards and index equal ``pack_jhmdb``'s, file for file and
    byte for byte, and a packed val split reads back the unpacked samples;
    ``--num-parts`` > 1 is refused for JHMDB, as in JAX."""
    cfg_path = _jhmdb_yaml(tmp_path)
    cfg = load_config(str(cfg_path))
    want = Path(packed.pack_jhmdb(cfg, "val", str(tmp_path / "want")))
    monkeypatch.setattr(sys, "argv", [
        "pack_data", "--config-file", str(cfg_path), "--split", "val",
        "--out", str(tmp_path / "got"), "--workers", "2"])
    pack_data.main()
    assert "packed val split to" in capsys.readouterr().out
    got = tmp_path / "got"
    names = sorted(p.name for p in want.iterdir())
    assert names and sorted(p.name for p in got.iterdir()) == names
    for n in names:
        assert (got / n).read_bytes() == (want / n).read_bytes(), n
    cfg.data.packed_path = str(got)
    ours = runner.build_dataset(cfg, "val")
    cfg.data.packed_path = ""
    plain = runner.build_dataset(cfg, "val")
    for i in (0, len(plain) - 1):
        a = ours.get(i, np.random.default_rng(i))
        b = plain.get(i, np.random.default_rng(i))
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
    monkeypatch.setattr(sys, "argv", [
        "pack_data", "--config-file", str(cfg_path), "--out",
        str(tmp_path / "parts"), "--num-parts", "2"])
    with pytest.raises(SystemExit, match="AVA packs only"):
        pack_data.main()


@pytest.mark.parametrize("matplotlib", [True, False])
def test_validate_ava_draws_pr_plot(tmp_path, monkeypatch, capsys,
                                    matplotlib):
    """``validate_ava`` with a dump directory writes ``pr_epoch_0.png``
    beside ``0.txt``; without matplotlib it prints the skip line and the
    validation goes on, as in the JAX package."""
    from tubelet_transformer_tpu_torch.train import engine, loop

    cfg = load_config(None, _tree()["CONFIG"])
    cfg.model.load = False
    cfg.data.dataset_name = "synthetic"
    cfg.data.synthetic_size = 4
    cfg.data.img_size = 32
    cfg.data.num_workers = 0
    cfg.val.batch_size = 2
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    model = build_model(cfg, seed=1)
    _, val_loader = runner.make_loaders(cfg, val_only=True)
    dump = tmp_path / "dump"
    out = loop.validate_ava(cfg, engine.make_eval_step(cfg, model), model,
                            val_loader, 0, dump_dir=str(dump))
    printed = capsys.readouterr().out
    assert "mAP" in out and (dump / "0.txt").exists()
    png = dump / "pr_epoch_0.png"
    if matplotlib:
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert "PR plot skipped" not in printed
    else:
        assert not png.exists() and "PR plot skipped" in printed
