"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` and loaded through ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries are named by a hash
of their source, the headers beside it (``csrc/*.cuh``) and the flags, and
kept in ``_build/`` beside this file (listed in ``.gitignore``), so a
process builds a source at most once and a changed source or header is
rebuilt. ``build_all`` starts one ``nvcc`` per missing source,
all at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
SOURCES = ("pack", "rmsnorm", "flash_attention", "wire_codecs", "infonce",
           "ssd_scan", "rope")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    if home and pathlib.Path(home, "bin", "nvcc").exists():
        return str(pathlib.Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` is built: named by a hash of the source,
    every header in ``csrc/`` and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library of ``names`` in parallel. Returns the
    wall seconds spent per name (0.0 for one already built). Raises with
    the compiler's output if any build fails. ``ptxas`` register and
    shared-memory reports go to ``_build/<lib>.log``."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp,
                       target)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_bytes(out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{out.decode(errors='replace')}")
            continue
        os.replace(tmp, target)     # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use;
    ``declare(lib)`` sets its functions' ``argtypes``/``restype`` once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            declare(lib)
            _libs[name] = lib
        return lib


def check(code: int, error_string, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
