"""The port as a package: it stands apart from the JAX package, its entry
points default to the card and refuse to fall back to the CPU, and its
launcher runs end to end on the CPU when asked to."""
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (FLConfig, SSLConfig, TrainConfig,
                                      load_arch, reduced)
from repro_torch.federated import driver
from repro_torch.launch import train

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
# a few threads: the suite runs several workers side by side
ENV = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
       "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}


def _run(args, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=timeout)


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_sources_import_neither_jax_nor_reference():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|"
                         r"from\s+(jax|repro)(\.|\s))", re.M)
    files = list((SRC / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_entry_points_refuse_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(load_arch("vit-tiny"), num_layers=1, d_model=32,
                  num_heads=2, num_kv_heads=2, d_ff=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.run_fedssl(cfg, SSLConfig(), FLConfig(rounds=1),
                          TrainConfig(batch_size=2),
                          images=np.zeros((4, 32, 32, 3), np.float32),
                          client_indices=[np.arange(4)])


def test_cli_runs_to_linear_eval_on_cpu():
    out = _run(["-m", "repro_torch.launch.train", "--mode", "vit",
                "--device", "cpu", "--rounds", "2", "--clients", "2",
                "--batch", "8", "--samples", "64", "--layers", "2",
                "--d-model", "32"])
    assert out.returncode == 0, out.stderr
    assert "round 2/2 stage 2" in out.stdout
    assert "linear evaluation accuracy" in out.stdout


@pytest.mark.parametrize("extra", [["--codec", "int8"],
                                   ["--codec", "topk:0.2",
                                    "--transport-kernels", "pallas"]])
def test_cli_codecs_run_to_linear_eval_on_cpu(extra):
    out = _run(["-m", "repro_torch.launch.train", "--mode", "vit",
                "--device", "cpu", "--rounds", "2", "--clients", "2",
                "--batch", "8", "--samples", "64", "--layers", "2",
                "--d-model", "32", *extra])
    assert out.returncode == 0, out.stderr
    assert "round 2/2 stage 2" in out.stdout
    assert f"({extra[1]}: " in out.stdout       # the compression ratio
    assert "linear evaluation accuracy" in out.stdout


def test_cli_runs_lm_mode_on_cpu():
    out = _run(["-m", "repro_torch.launch.train", "--mode", "lm",
                "--arch", "zamba2-2.7b", "--device", "cpu", "--rounds", "2",
                "--clients", "2", "--batch", "2", "--samples", "8",
                "--seq-len", "32", "--codec", "int8"])
    assert out.returncode == 0, out.stderr
    assert "round 2/2 stage 2" in out.stdout
    assert "final loss" in out.stdout and "(int8: " in out.stdout


def test_cli_runs_vmap_engine_to_linear_eval_on_cpu():
    out = _run(["-m", "repro_torch.launch.train", "--mode", "vit",
                "--engine", "vmap", "--device", "cpu", "--rounds", "2",
                "--clients", "2", "--batch", "8", "--samples", "64",
                "--layers", "2", "--d-model", "32"])
    assert out.returncode == 0, out.stderr
    assert "round 2/2 stage 2" in out.stdout
    assert "linear evaluation accuracy" in out.stdout


def test_cli_vmap_engine_refuses_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--engine", "vmap", "--rounds", "2", "--layers", "2"])


def test_cli_rejects_unknown_codec(capsys):
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", "--codec", "int4"])
    assert e.value.code == 2 and "unknown codec" in capsys.readouterr().err


NOT_PORTED_CASES = [["--secure-agg"], ["--fleet", "uniform"],
                    ["--mode", "lm", "--engine", "vmap"],
                    ["--measure-resources"],
                    ["--mode", "lm", "--arch", "internlm2-1.8b"],
                    ["--round-policy", "deadline"], ["--dp-clip", "1.0"],
                    ["--dp-noise-multiplier", "1.1"],
                    ["--dp-epsilon-budget", "8.0"]]


@pytest.mark.parametrize("flag", NOT_PORTED_CASES)
def test_cli_rejects_features_not_ported(flag, capsys):
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", *flag])
    assert e.value.code == 2
    assert "not ported to repro_torch yet" in capsys.readouterr().err


def test_every_refused_flag_has_a_case():
    flags = {f[0] for f in NOT_PORTED_CASES}
    for name in train.NOT_PORTED:
        assert "--" + name.replace("_", "-") in flags, name


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    out = _run([str(ROOT / "chip_smoke.py")])
    assert out.returncode != 0 and '"ok"' not in out.stdout
    if torch.cuda.is_available():
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        out = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
        assert out.returncode != 0 and '"ok"' not in out.stdout
