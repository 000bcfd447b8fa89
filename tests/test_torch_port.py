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
        "new = ['repro_torch.models.layers.moe', "
        "'repro_torch.models.layers.mla']\n"
        "assert all(m in sys.modules for m in new), new\n"
        "print('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_sources_import_neither_jax_nor_reference():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|"
                         r"from\s+(jax|repro)(\.|\s))", re.M)
    files = list((SRC / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for new in ("models/layers/moe.py", "models/layers/mla.py",
                "configs/deepseek-v2-236b.py",
                "configs/llama4-maverick-400b-a17b.py"):
        assert SRC / "repro_torch" / new in files, new
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_library_layers_do_not_import_the_launcher():
    """The launcher sits on top of the library: no module of its lower
    layers imports ``repro_torch.launch``."""
    pattern = re.compile(r"^\s*(import\s+repro_torch\.launch\b|"
                         r"from\s+repro_torch\.launch\b|"
                         r"from\s+repro_torch\s+import\s+launch\b)", re.M)
    files = [f for layer in ("federated", "core", "models", "kernels",
                             "optim", "data")
             for f in (SRC / "repro_torch" / layer).rglob("*.py")]
    assert SRC / "repro_torch" / "federated" / "driver.py" in files
    assert [f.relative_to(SRC) for f in files
            if pattern.search(f.read_text())] == []


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


# --mode lm on an arch that is no LM: the paper's ViT backbone (no
# vocabulary), and a name that is no arch at all
NOT_PORTED_CASES = [["--mode", "lm", "--arch", a] for a in (
    "vit-tiny", "no-such-arch")]


@pytest.mark.parametrize("flag", NOT_PORTED_CASES)
def test_cli_rejects_features_not_ported(flag, capsys):
    """Every LM arch of the JAX package runs under ``--mode lm`` (the MoE
    and MLA families, refused until they were ported, among them; the
    encoder-decoder has its own refusal); anything else exits 2 and names
    the archs it takes."""
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", *flag])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"--arch {flag[-1]}: not an LM architecture of repro_torch" in err
    for arch in ("llama4-maverick-400b-a17b", "deepseek-v2-236b",
                 "internlm2-1.8b", "zamba2-2.7b", "xlstm-125m"):
        assert arch in err


def test_cli_refuses_the_encoder_decoder_and_says_why(capsys):
    """seamless-m4t-medium: the reference's launcher runs it as a
    decoder-only dense LM (sequential) or fails (vmap); the port's sends
    the encoder-decoder to ``launch.steps``."""
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", "--mode", "lm", "--arch",
                    "seamless-m4t-medium"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "decoder-only dense LM" in err and "KeyError: 'frontend'" in err
    assert "repro_torch.launch.steps" in err


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_cli_runs_xlstm_lm_mode_on_cpu(engine):
    out = _run(["-m", "repro_torch.launch.train", "--mode", "lm",
                "--arch", "xlstm-125m", "--device", "cpu", "--rounds", "2",
                "--clients", "2", "--batch", "2", "--samples", "8",
                "--seq-len", "32", "--engine", engine])
    assert out.returncode == 0, out.stderr
    assert "round 2/2 stage 2" in out.stdout and "final loss" in out.stdout


INVALID_PRIVACY = [
    ["--dp-noise-multiplier", "1.1"],                 # noise without clip
    ["--dp-clip", "-1"],
    ["--dp-clip", "1.0", "--dp-noise-multiplier", "-0.5"],
    ["--dp-clip", "1.0", "--dp-delta", "0"],
    ["--dp-clip", "1.0", "--dp-delta", "1"],
    ["--dp-clip", "inf", "--dp-noise-multiplier", "1.1"],
    ["--secure-agg", "--dp-delta", "2"]]


@pytest.mark.parametrize("flags", INVALID_PRIVACY)
def test_cli_rejects_invalid_privacy(flags, capsys, monkeypatch):
    """Exit 2 with the message the reference's launcher gives for the
    same flags."""
    from repro.launch import train as ref_train

    monkeypatch.setattr(sys, "argv", ["train", *flags])
    with pytest.raises(SystemExit) as e:
        ref_train.main()
    assert e.value.code == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert "error: " in want
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", *flags])
    assert e.value.code == 2
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]


@pytest.mark.parametrize("mode", [
    ["--mode", "vit", "--rounds", "2", "--clients", "2", "--batch", "8",
     "--samples", "64", "--layers", "2", "--d-model", "32"],
    ["--mode", "lm", "--arch", "zamba2-2.7b", "--rounds", "2",
     "--clients", "2", "--batch", "2", "--samples", "8", "--seq-len",
     "32"]])
def test_cli_runs_dp_and_secure_agg_on_cpu(mode):
    out = _run(["-m", "repro_torch.launch.train", "--device", "cpu", *mode,
                "--dp-clip", "1.0", "--dp-noise-multiplier", "1.1",
                "--dp-delta", "1e-5", "--secure-agg"])
    assert out.returncode == 0, out.stderr
    assert "round 2/2 stage 2" in out.stdout and " eps " in out.stdout
    assert re.search(r"^privacy: eps [0-9.]+ at delta 1e-05 after 2 rounds",
                     out.stdout, re.M), out.stdout


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    out = _run([str(ROOT / "chip_smoke.py")])
    assert out.returncode != 0 and '"ok"' not in out.stdout
    if torch.cuda.is_available():
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        out = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
        assert out.returncode != 0 and '"ok"' not in out.stdout
