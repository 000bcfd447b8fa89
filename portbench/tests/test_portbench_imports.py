"""No module of the benchmark imports JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` is not ``repro``), and the
plain reference imports nothing of the program."""
import ast
import subprocess
import sys

import pytest

from portbench.tests.tiny import ROOT

PKG = ROOT / "portbench"
FILES = sorted(PKG.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    """Statically, and in a fresh interpreter once every reference module
    is imported."""
    for path in (PKG / "reference").glob("*.py"):
        assert all(m.split(".")[0] != "repro_torch" for m in _imports(path))
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.vit, portbench.reference.lm; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    """``repro_torch`` is not ``repro``; ``repro.x`` and ``jax`` are."""
    import types
    from portbench.run import forbidden_modules
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    for m in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "repro_torch_x", types.ModuleType("x"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert forbidden_modules() == ["jax", "repro"]


def test_harness_loads_no_jax():
    """The harness and both drivers, with the program they drive."""
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import portbench.run, portbench.drivers.fedssl_vit, "
            "portbench.drivers.fedssl_lm, repro_torch.federated.driver; "
            "print(portbench.run.forbidden_modules())"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
